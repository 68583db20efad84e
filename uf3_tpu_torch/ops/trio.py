"""
3-body forces of the unary UF3 potential: the fused per-atom pair-lane
pass (``trio_partials``: a CUDA kernel on the card, its plain torch twin
on the CPU), the reverse-slot assembly of neighbor forces, the 3-body
virial from the same slot partials, the shared-gather 2+3-body
evaluation and the short-range r-RESPA force on the 3-body rows.

Counterpart of ``_trio_block_compute``, its triangle-lane twin
``_trio_block_compute_tri``, ``trio_forces_unrolled`` /
``trio_forces_pallas``, ``_assemble_forces``, ``_trio_virial6``,
``pair_trio_forces_shared`` and ``trio_short_forces``
(``uf3_tpu/ops/pallas_trio.py``).
"""

import ctypes

import torch

from uf3_tpu_torch.ops import _build
from uf3_tpu_torch.ops.fragments import PEAK_FLOPS
from uf3_tpu_torch.ops.gather import PEAK_BYTES
from uf3_tpu_torch.ops.neighbors import (ListCache, NeighborList,
                                         cached_displacements, list_cache)
from uf3_tpu_torch.ops.pair import pair_row_forces, pair_short_forces
from uf3_tpu_torch.ops.potential import VOIGT_AB, TrioBundle, UF3Potential
from uf3_tpu_torch.ops.splines import _dense_basis, _leg_interval


def trio_partials_torch(d, valid, grid, trio: TrioBundle,
                        with_energy: bool = True, center_weight=None,
                        triangle: bool = False):
    """Plain torch twin of the trio kernel, line for line after
    ``_trio_block_compute``: from displacements ``d`` (N, K, 3) and slot
    mask ``valid`` (N, K) to per-atom energy (N,), center force (N, 3)
    and the slot partials ``part`` (N, K, 5) = (S1 = w_m, S3', V3').
    Pair lane (m, n) takes its third leg d[n] - d[m], H from row m and
    the first-leg basis from row n.  ``center_weight`` (N,) scales each
    center row's outputs after the computation, as
    ``trio_forces_unrolled`` does.  ``triangle`` runs the triangle
    lanes of a grid symmetric in its first two legs
    (``_trio_partials_tri_torch``)."""
    if triangle:
        out = _trio_partials_tri_torch(d, valid, grid, trio, with_energy)
        return _weighted(out, center_weight)
    n_atoms, k = d.shape[0], d.shape[1]
    dtype = d.dtype
    w_lo, w_hi, c_lo, c_hi = trio.window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    comps = d.unbind(-1)
    valid_f = valid.to(dtype)
    r2 = comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2]
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    a_mat, da_mat = _dense_basis(r, valid_f, trio.spec_l,
                                 lo=w_lo, hi=w_hi)      # (N, K, Ww)
    # neighbor-neighbor legs on the pair lanes p = m*K + n: d[n] - d[m]
    r_mn2 = torch.zeros((n_atoms, k * k), dtype=dtype, device=d.device)
    for dc in comps:
        diff_c = (dc[:, None, :] - dc[:, :, None]).reshape(n_atoms, k * k)
        r_mn2 = r_mn2 + diff_c * diff_c
    r_mn = torch.sqrt(torch.where(r_mn2 > 0, r_mn2, torch.ones_like(r_mn2)))
    pair_pre = valid_f.repeat(1, k) * valid_f.repeat_interleave(k, 1)
    pair_valid = pair_pre * (r_mn2 > 1e-10).to(dtype)
    c_p, dc_p = _dense_basis(r_mn, pair_valid, trio.spec_n,
                             lo=c_lo, hi=c_hi, transposed=True)
    c_p = c_p.reshape(n_atoms, cw, k, k)                 # [a, c, m, n]
    dc_p = dc_p.reshape(n_atoms, cw, k, k)
    g_flat = grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi].reshape(ww, ww * cw)
    # H = A @ G as explicit mul-adds in the working type (no TF32)
    h = sum(a_mat[..., l:l + 1] * g_flat[l] for l in range(ww))
    h1 = sum(da_mat[..., l:l + 1] * g_flat[l] for l in range(ww))
    value = torch.zeros((n_atoms, k, k), dtype=dtype, device=d.device)
    t1 = torch.zeros_like(value)
    t3 = torch.zeros_like(value)
    for b_idx, c_list in trio.active_bc:
        db = torch.zeros_like(value)
        d1b = torch.zeros_like(value)
        d3b = torch.zeros_like(value)
        for c_idx in c_list:
            col = (b_idx - w_lo) * cw + (c_idx - c_lo)
            h_bc = h[:, :, col, None]                    # m-role
            h1_bc = h1[:, :, col, None]
            if with_energy:
                db = db + c_p[:, c_idx - c_lo] * h_bc
            d1b = d1b + c_p[:, c_idx - c_lo] * h1_bc
            d3b = d3b + dc_p[:, c_idx - c_lo] * h_bc
        b_col = a_mat[:, None, :, b_idx - w_lo]          # n-role
        if with_energy:
            value = value + b_col * db
        t1 = t1 + b_col * d1b
        t3 = t3 + b_col * d3b
    energy = 0.5 * torch.sum(value, dim=(1, 2))
    w_m = torch.sum(t1, dim=2)                           # (N, K)
    wr = w_m / r
    f_center = torch.stack([torch.sum(wr * dc, dim=1) for dc in comps], -1)
    g3p = t3 / r_mn.reshape(n_atoms, k, k)
    s3 = torch.sum(g3p, dim=2)
    v3 = [torch.sum(g3p * dc[:, None, :], dim=2) for dc in comps]
    part = torch.stack([w_m, s3] + v3, dim=-1)
    return _weighted((energy, f_center, part), center_weight)


def _weighted(out, center_weight):
    """(energy, f_center, part) with each center row scaled by its
    weight, where one is given."""
    if center_weight is None:
        return out
    energy, f_center, part = out
    w = center_weight.to(energy.dtype)
    return energy * w, f_center * w[:, None], part * w[:, None, None]


def _trio_partials_tri_torch(d, valid, grid, trio: TrioBundle,
                             with_energy: bool = True):
    """The triangle-lane twin, after ``_trio_block_compute_tri``, for a
    grid symmetric in its first two legs (G[l, b, c] = G[b, l, c]): the
    lanes are the unordered slot pairs m < n, each with a second leg
    chain t2 = sum da_n[b] c[c] H_m[b, c] that goes to slot n's w, while
    t1 goes to slot m's; g3 = t3 / r_mn goes to s3 of both slots, g3 d[n]
    to v3[m] and g3 d[m] to v3[n]; energy is the plain sum over lanes.
    The outputs mean what the full lanes' do."""
    n_atoms, k = d.shape[0], d.shape[1]
    dtype = d.dtype
    w_lo, w_hi, c_lo, c_hi = trio.window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    m_idx, n_idx = torch.triu_indices(k, k, 1, device=d.device)
    comps = d.unbind(-1)
    valid_f = valid.to(dtype)
    r2 = comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2]
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    a_mat, da_mat = _dense_basis(r, valid_f, trio.spec_l,
                                 lo=w_lo, hi=w_hi)      # (N, K, Ww)
    dm = [dc[:, m_idx] for dc in comps]                  # (N, lanes)
    dn = [dc[:, n_idx] for dc in comps]
    r_mn2 = sum((b - a) * (b - a) for a, b in zip(dm, dn))
    r_mn = torch.sqrt(torch.where(r_mn2 > 0, r_mn2, torch.ones_like(r_mn2)))
    pair_valid = (valid_f[:, m_idx] * valid_f[:, n_idx]
                  * (r_mn2 > 1e-10).to(dtype))
    c_p, dc_p = _dense_basis(r_mn, pair_valid, trio.spec_n,
                             lo=c_lo, hi=c_hi, transposed=True)
    g_flat = grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi].reshape(ww, ww * cw)
    h = sum(a_mat[..., l:l + 1] * g_flat[l] for l in range(ww))
    h1 = sum(da_mat[..., l:l + 1] * g_flat[l] for l in range(ww))
    value = torch.zeros_like(r_mn)
    t1 = torch.zeros_like(r_mn)
    t2 = torch.zeros_like(r_mn)
    t3 = torch.zeros_like(r_mn)
    for b_idx, c_list in trio.active_bc:
        db = torch.zeros_like(r_mn)
        d1b = torch.zeros_like(r_mn)
        d3b = torch.zeros_like(r_mn)
        for c_idx in c_list:
            col = (b_idx - w_lo) * cw + (c_idx - c_lo)
            h_bc = h[:, m_idx, col]                      # m-role
            cp = c_p[:, c_idx - c_lo]
            db = db + cp * h_bc
            d1b = d1b + cp * h1[:, m_idx, col]
            d3b = d3b + dc_p[:, c_idx - c_lo] * h_bc
        b_val = a_mat[:, n_idx, b_idx - w_lo]            # n-role
        if with_energy:
            value = value + b_val * db
        t1 = t1 + b_val * d1b
        t2 = t2 + da_mat[:, n_idx, b_idx - w_lo] * db
        t3 = t3 + b_val * d3b
    energy = torch.sum(value, dim=1)  # unordered pairs: no 1/2

    def to_m(t):  # lane terms summed onto slot m
        return _triangle(t, m_idx, n_idx, k).sum(2)

    def to_n(t):  # and onto slot n
        return _triangle(t, m_idx, n_idx, k).sum(1)

    w_m = to_m(t1) + to_n(t2)
    wr = w_m / r
    f_center = torch.stack([torch.sum(wr * dc, dim=1) for dc in comps], -1)
    g3 = t3 / r_mn
    s3 = to_m(g3) + to_n(g3)
    v3 = [to_m(g3 * dn[c]) + to_n(g3 * dm[c]) for c in range(3)]
    return energy, f_center, torch.stack([w_m, s3] + v3, dim=-1)


def _triangle(t, m_idx, n_idx, k):
    """(N, lanes) lane terms -> (N, K, K), lane (m, n) at [m, n]."""
    out = torch.zeros((t.shape[0], k, k), dtype=t.dtype, device=t.device)
    out[:, m_idx, n_idx] = t
    return out


MAX_SLOTS = 32  # the trio kernel runs one warp per atom


def _leg_args(trio: TrioBundle):
    """The kernel's leg arguments: (u0, 1/h, t_min, t_max) of the first
    legs then of the third leg as doubles, (kind, n_int) of each as
    ints."""
    specs = (trio.spec_l, trio.spec_n)
    legs = (ctypes.c_double * 8)(*[x for s in specs
                                   for x in (s.u0, 1.0 / s.h, s.t_min,
                                             s.t_max)])
    ints = (ctypes.c_int * 4)(*[x for s in specs for x in (s.kind, s.n_int)])
    return legs, ints


def trio_partials(potential: UF3Potential, d, valid,
                  with_energy: bool = True, center_weight=None,
                  triangle: bool = False):
    """Energy (N,), center force (N, 3) and slot partials (N, K, 5) of
    the trio term; ``valid`` is the (N, K) slot mask (0 or 1) and
    ``center_weight`` (N,), where given, each center row's weight (0
    skips the row).  ``triangle`` takes the triangle lanes, which a grid
    symmetric in its first two legs requires; below K = 2 it falls back
    to full lanes, as ``trio_forces_unrolled`` does.  A CUDA tensor runs
    the hand-written kernel (``csrc/trio.cu``) or raises; a CPU tensor
    runs the torch twin.  ``trio_partials.launches`` counts kernel
    launches."""
    trio = potential.trio
    if triangle and not trio.symmetric:
        raise ValueError("the triangle lanes need a grid symmetric in its "
                         "first two legs")
    triangle = bool(triangle) and d.shape[1] >= 2
    if d.device.type == "cpu":
        return trio_partials_torch(d, valid, potential.grid, trio,
                                   with_energy, center_weight, triangle)
    if d.device.type != "cuda":
        raise ValueError(f"no trio kernel for device {d.device}")
    n_atoms, k = d.shape[0], d.shape[1]
    dtype = potential.grid_window.dtype
    if d.shape[2:] != (3,) or tuple(valid.shape) != (n_atoms, k):
        raise ValueError(f"bad shapes d {tuple(d.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if k > MAX_SLOTS:
        raise ValueError(f"capacity {k}: the trio kernel takes K <= "
                         f"{MAX_SLOTS} slots (one warp per atom)")
    if dtype not in (torch.float32, torch.float64) or d.dtype != dtype \
            or valid.dtype != dtype:
        raise TypeError(f"trio kernel takes float32 or float64 matching "
                        f"the potential ({dtype}); got d {d.dtype}, "
                        f"valid {valid.dtype}")
    if center_weight is not None:
        if tuple(center_weight.shape) != (n_atoms,) \
                or center_weight.dtype != dtype:
            raise TypeError(f"center_weight must be ({n_atoms},) {dtype}; "
                            f"got {tuple(center_weight.shape)} "
                            f"{center_weight.dtype}")
        center_weight = center_weight.contiguous()
    for t in (potential.grid_window, potential.leg_tables, valid) + (
            () if center_weight is None else (center_weight,)):
        if t.device != d.device:
            raise ValueError("trio kernel operands on different devices")
    for spec in (trio.spec_l, trio.spec_n):
        if spec.cardinal:
            raise ValueError("trio kernel legs take closed-form knots "
                             "in the clamped basis")
    d = d.contiguous()
    valid = valid.contiguous()
    w_lo, w_hi, c_lo, c_hi = trio.window
    energy = torch.empty(n_atoms, dtype=dtype, device=d.device)
    f_center = torch.empty((n_atoms, 3), dtype=dtype, device=d.device)
    part = torch.empty((n_atoms, k, 5), dtype=dtype, device=d.device)
    legs, ints = _leg_args(trio)
    lib = _build.library()
    fn = lib.uf3_trio_partials_f32 if dtype == torch.float32 \
        else lib.uf3_trio_partials_f64
    err = _build.on_stream(
        d.device, fn, d.data_ptr(), valid.data_ptr(),
        None if center_weight is None else center_weight.data_ptr(),
        potential.grid_window.data_ptr(), potential.leg_tables.data_ptr(),
        energy.data_ptr(), f_center.data_ptr(), part.data_ptr(), n_atoms, k,
        legs, ints, w_lo, w_hi - w_lo, c_lo, c_hi - c_lo,
        int(bool(with_energy)), int(triangle))
    _check(err, k, trio)
    trio_partials.launches += 1
    return energy, f_center, part


trio_partials.launches = 0


def _check(err: int, k: int, trio: TrioBundle):
    w_lo, w_hi, c_lo, c_hi = trio.window
    _check_window(err, k, f"{w_hi - w_lo} x {w_hi - w_lo} x {c_hi - c_lo}")


def _check_window(err: int, k: int, shape: str):
    if err == -1:
        raise ValueError(f"trio kernel: one warp's shared memory for K={k} "
                         f"and a {shape} grid window exceeds the 227 KB a "
                         "block may hold")
    if err != 0:
        raise RuntimeError(f"trio kernel launch failed: CUDA error {err}")


def trio_occupancy(potential: UF3Potential, k: int,
                   with_energy: bool = False, triangle: bool = False,
                   n_atoms: int = 0) -> dict:
    """The launch plan of the trio kernel for this potential, its dtype,
    K slots and lane layout, from the CUDA runtime: atoms (warps) per
    block, shared bytes per block, resident blocks and warps per SM,
    registers and local (spill) bytes per thread, the card's SMs, and
    the persistent grid the kernel launches for ``n_atoms`` atoms (at
    most the resident blocks of every SM; 0 for no atoms)."""
    trio = potential.trio
    w_lo, w_hi, c_lo, c_hi = trio.window
    _, ints = _leg_args(trio)
    out = (ctypes.c_int * 7)()
    err = _build.library().uf3_trio_occupancy(
        int(potential.grid_window.dtype == torch.float64), n_atoms, k, ints,
        w_hi - w_lo, c_hi - c_lo, int(bool(with_energy)), int(triangle),
        out)
    _check(err, k, trio)
    return dict(atoms_per_block=out[0], smem_bytes=out[1],
                blocks_per_sm=out[2], warps_per_sm=out[2] * out[0],
                registers=out[3], local_bytes=out[4], sms=out[5],
                grid=out[6])


def trio_bound(pot: UF3Potential, d, valid, with_energy: bool,
               peak=PEAK_FLOPS[torch.float32], extra_bytes: int = 0,
               triangle: bool = False):
    """The least time the card needs for one trio_partials call on
    these rows: the flop the kernel's algorithm does for this data (an
    FMA is 2) over the ``peak`` rate (float32 by default), against each
    input read once and
    each output written once, plus ``extra_bytes`` moved beside these
    rows, over the memory rate.  ``triangle`` counts the triangle lanes:
    the live unordered lanes m < n, each with its t2 chain, and the
    slots' sums over their live partners.  Returns (ms, "operations" or
    "bytes", flop, bytes)."""
    trio_b = pot.trio
    w_lo, w_hi, c_lo, c_hi = trio_b.window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    d = d.double()
    ok = valid != 0                                      # (N, K)
    r = torch.sqrt(torch.sum(d * d, -1).clamp_min(1e-300))
    idx = _leg_interval(trio_b.spec_l, r)                # first tap
    taps = torch.arange(4, device=d.device)
    b_live = (((idx[..., None] + taps) >= w_lo)
              & ((idx[..., None] + taps) < w_hi)).sum(-1)  # (N, K)
    diff = d[:, None, :, :] - d[:, :, None, :]            # [a, m, n]
    r_mn2 = torch.sum(diff * diff, -1)
    r_mn = torch.sqrt(r_mn2.clamp_min(1e-300))
    eye = torch.eye(d.shape[1], dtype=torch.bool, device=d.device)
    lane = (ok[:, :, None] & ok[:, None, :] & ~eye & (r_mn2 > 1e-10)
            & (r_mn >= trio_b.spec_n.t_min) & (r_mn <= trio_b.spec_n.t_max))
    cidx = _leg_interval(trio_b.spec_n, r_mn)
    c_live = (((cidx[..., None] + taps) >= c_lo)
              & ((cidx[..., None] + taps) < c_hi)).sum(-1)  # (N, K, K)
    b_lane = b_live[:, None, :].expand_as(cidx)           # row n's taps
    energy = int(with_energy)
    if triangle:
        # per live lane m < n: 55 for the third leg as below, 1 for g3,
        # 3 FMAs per (b, c) term (the value chain always feeds t2), 3
        # (+1) per b; per live ordered pair, 8 for the slot's sums
        upper = torch.triu(torch.ones_like(eye), diagonal=1)
        per_lane = (55 + 1 + energy + 6 * b_lane * c_live
                    + 2 * (3 + energy) * b_lane)
        pairs = ok[:, :, None] & ok[:, None, :] & ~eye
        lane_flop = (float(torch.sum(per_lane * (lane & upper)))
                     + 8.0 * float(pairs.sum()))
    else:
        term = 6 if with_energy else 4    # 2 or 3 FMAs per (b, c) term
        # per live lane: 55 for d[n] - d[m], |.|, the interval and 4
        # values + 4 derivatives by Horner; 9 (+1) for the sums over n;
        # then the (b, c) terms and the b-level FMAs
        per_lane = (55 + 9 + energy
                    + term * b_lane * c_live + term * b_lane)
        lane_flop = float(torch.sum(per_lane * lane))
    n_rows = int(ok.sum())
    flop = (lane_flop
            + n_rows * (52 + 4)                    # row bases, fc
            + 4.0 * ww * cw * float(torch.sum(b_live * ok)))  # H, H1
    size = pot.grid_window.element_size()
    n_atoms, k = d.shape[:2]
    n_bytes = size * (n_atoms * k * 4 + pot.grid_window.numel()
                      + pot.leg_tables.numel() + n_atoms * (4 + 5 * k)) \
        + extra_bytes
    t_flop, t_bytes = flop / peak, n_bytes / PEAK_BYTES
    return (1e3 * max(t_flop, t_bytes),
            "operations" if t_flop >= t_bytes else "bytes", flop, n_bytes)


def assemble_forces(energy, f_center, part, d, rev_flat, mask):
    """Neighbor-term assembly: the partials each neighbor's row emitted
    for this atom, gathered through ``rev_flat`` = idx * K + rev (no
    scatter), give s1 d/r + s3 d + v3 per slot.  Returns (energy,
    forces (N, 3))."""
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    rows = part.reshape(-1, part.shape[-1])[rev_flat]   # (N, K, 5)
    contrib = (rows[..., 0:1] * (d / r[..., None])
               + rows[..., 1:2] * d + rows[..., 2:5])
    contrib = torch.where(mask[..., None], contrib,
                          torch.zeros_like(contrib))
    return energy, f_center + torch.sum(contrib, dim=1)


def trio_virial6(part, d, valid):
    """The 3-body Voigt virial (6,) from the slot partials ``part``
    (N, K, 5) = (w_m, S3'_m, V3'_m) of the trio kernel or its twin, the
    rows ``d`` (N, K, 3) and the slot mask ``valid`` (N, K).

    Counterpart of ``_trio_virial6``: its leg term sum (w_m / r_m) d d
    plus its third-leg term 1/2 sum_mn g_mn (d_n - d_m)(d_n - d_m),
    g = t3 / r_mn, equal sum_m d_m,a (w_m d_m,b / r_m + S3'_m d_m,b -
    V3'_m,b) when g_mn = g_nm: on every grid symmetric under exchange of
    the first two legs (every decompressed model grid), which
    ``_trio_virial6`` relies on too.  Each center's own rows, no
    reverse gather."""
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    u = (part[..., 0:1] / r[..., None] + part[..., 1:2]) * d \
        - part[..., 2:5]
    u = torch.where(valid[..., None] != 0, u, torch.zeros_like(u))
    return torch.stack([torch.sum(d[..., a] * u[..., b])
                        for a, b in VOIGT_AB])


def trio_forces(potential: UF3Potential, positions, cell,
                nbr3: NeighborList, with_energy: bool = True,
                cache3: ListCache = None, d=None,
                with_virial: bool = False, center_weight=None,
                triangle: bool = False):
    """3-body per-atom energy (N,) and forces (N, 3) on the 3-body
    list, and with ``with_virial`` the Voigt virial (6,) from the same
    partials; ``d`` (N, K3, 3) reuses an existing displacement gather.
    ``center_weight`` (N,) scales each center row's energy, center force
    and emitted partials before the assembly (the halo path's owner
    weight), so the virial from those partials is weighted too.
    ``triangle`` takes the kernel's triangle lanes."""
    if cache3 is None:
        cache3 = list_cache(nbr3, cell, positions.dtype)
    if d is None:
        d = cached_displacements(positions, nbr3, cache3)
    energy, f_center, part = trio_partials(potential, d, cache3.valid,
                                           with_energy, center_weight,
                                           triangle)
    out = assemble_forces(energy, f_center, part, d, cache3.rev_flat,
                          nbr3.mask)
    if with_virial:
        return out + (trio_virial6(part, d, cache3.valid),)
    return out


def pair_trio_forces_shared(potential: UF3Potential, positions, cell,
                            nbr2: NeighborList, nbr3: NeighborList,
                            with_energy: bool = True,
                            cache2: ListCache = None,
                            cache3: ListCache = None,
                            with_virial: bool = False,
                            triangle: bool = False):
    """Full 2+3-body energy and forces from one (N, K2) displacement
    gather: the 3-body rows are selected from the pair rows through the
    filtered list's parent slots ``nbr3.sel``.  ``with_energy=False``
    skips the energy sums (zeros come back); ``triangle`` takes the
    kernel's triangle lanes.  Returns (e2, e3_atoms (N,), forces (N, 3),
    Voigt virial (6,) or None)."""
    if cache2 is None:
        cache2 = list_cache(nbr2, cell, positions.dtype)
    spec = potential.pair_spec
    d2 = cached_displacements(positions, nbr2, cache2)
    out2 = pair_row_forces(potential.pair_coefficients, d2, cache2.valid,
                           spec, spec.n_basis, with_energy,
                           with_virial=with_virial)
    d3 = torch.gather(d2, 1, nbr3.sel[:, :, None].expand(-1, -1, 3))
    out3 = trio_forces(potential, positions, cell, nbr3, with_energy,
                       cache3=cache3, d=d3, with_virial=with_virial,
                       triangle=triangle)
    virial = out2[2] + out3[2] if with_virial else None
    return out2[0], out3[0], out2[1] + out3[1], virial


def trio_short_forces(potential: UF3Potential, positions, cell,
                      nbr3: NeighborList, n_basis_pair: int,
                      with_energy: bool = True, r_lo: float = 0.0,
                      r_hi: float = 0.0, cache3: ListCache = None,
                      triangle: bool = False):
    """The 2-level r-RESPA inner force: the switched short-range pair
    force S(r) V(r) (its first ``n_basis_pair`` basis functions) and the
    3-body force (``triangle``: on the kernel's triangle lanes), both on
    one (N, K3) gather of the 3-body rows.  Returns (e_short2, e3_atoms
    (N,), forces (N, 3))."""
    if cache3 is None:
        cache3 = list_cache(nbr3, cell, positions.dtype)
    e2, f2, d3 = pair_short_forces(
        potential.pair_coefficients, positions, cell, nbr3,
        spec_pair=potential.pair_spec, n_basis_pair=n_basis_pair,
        with_energy=with_energy, r_lo=r_lo, r_hi=r_hi, cache3=cache3)
    e3, f3 = trio_forces(potential, positions, cell, nbr3, with_energy,
                         cache3=cache3, d=d3, triangle=triangle)
    return e2, e3, f2 + f3
