"""
The fused multi-species route of a 2+3-body model whose knots all have
a closed form: the 3-body pass over every ordered trio type (s_c, s_m,
s_n) in one launch of a CUDA kernel (``trio_multi_partials_all``,
``csrc/trio_multi.cu``), its partials summed over the types before one
reverse-slot assembly; the pair term as one chain per pair type on one
(N, K2) gather.

Counterpart of ``TrioTypeDesc``, ``TrioMulti``, ``build_trio_multi``,
``_trio_block_compute_multi``, ``trio_forces_multi``,
``build_pair_multi`` and ``pair_forces_multi``
(``uf3_tpu/ops/pallas_trio.py``).  The reference runs its trio part as
XLA, all types in one block body; here it is one kernel launch on the
card, fed by the per-type metadata ``pack_trio_multi`` packs once at
construction, and on the CPU its plain version
``trio_multi_partials_all_torch`` (``trio_multi_partials_torch`` per
type, summed).  The pair part is plain torch (``pair_row_forces`` per
pair type), as the reference's is XLA.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from uf3_tpu_torch import io
from uf3_tpu_torch.ops import _build
from uf3_tpu_torch.ops.neighbors import (ListCache, NeighborList,
                                         cached_displacements)
from uf3_tpu_torch.ops.pair import pair_row_forces
from uf3_tpu_torch.ops.potential import type_sparsity
from uf3_tpu_torch.ops.splines import (LINEAR, LegSpec, _dense_basis,
                                       cardinal_coefficients, horner_table,
                                       leg_spec_from_knots)
from uf3_tpu_torch.ops.trio import (MAX_SLOTS, _check_window,
                                    assemble_forces, trio_virial6)


class TrioTypeDesc(NamedTuple):
    """One ordered trio type of the fused multi-species pass: the
    first leg's spec (row m, H), the second leg's (row n, its basis),
    the third leg's, the species of the center and of rows m and n, the
    live window (l_lo, l_hi, b_lo, b_hi, c_lo, c_hi) of its grid and
    the live (b, (c, ...)) blocks."""
    spec_l1: LegSpec
    spec_l2: LegSpec
    spec_n: LegSpec
    s_c: int
    s_m: int
    s_n: int
    window: Tuple
    active_bc: Tuple


class TrioMulti(NamedTuple):
    """The host side of the fused multi-species 3-body term: the
    ordered types and their dense (L, M, NC) float64 grids."""
    descs: Tuple
    grids: Tuple


class PairMulti(NamedTuple):
    """The host side of the multi-pair-type 2-body term: per pair type
    its closed-form spec (cardinal for uniform linear knots) and
    coefficients, and the (S, S) pair-type table."""
    specs: Tuple
    coefficients: Tuple
    pair_type: np.ndarray


def build_trio_multi(config, coefficients) -> Optional[TrioMulti]:
    """Per ordered trio type the leg specs, window and dense grid; a
    type (c, m, n) with m != n also runs as (c, n, m) on the transposed
    grid, so that each ordered pair lane meets its type.  None for
    degree 2 or where any leg's knots have no closed form."""
    if config.degree <= 2:
        return None
    element_list = list(config.element_list)
    solutions = io.arrange_coefficients(coefficients, config)
    descs, grids = [], []
    for trio in config.interactions_map[3]:
        s_c, s_m, s_n = (element_list.index(el) for el in trio)
        grid = np.asarray(config.decompress_3B(solutions[trio], trio),
                          dtype=np.float64)
        seqs = [np.asarray(s, dtype=np.float64)
                for s in config.knots_map[trio]]
        variants = [((s_c, s_m, s_n), grid, seqs)]
        if s_m != s_n:
            variants.append(((s_c, s_n, s_m), grid.transpose(1, 0, 2),
                             [seqs[1], seqs[0], seqs[2]]))
        for (c, m, n), g, sq in variants:
            found = [leg_spec_from_knots(s, exact=True) for s in sq]
            if not all(ok for ok, _ in found):
                return None
            active_bc, window = type_sparsity(g)
            descs.append(TrioTypeDesc(
                spec_l1=found[0][1], spec_l2=found[1][1],
                spec_n=found[2][1], s_c=c, s_m=m, s_n=n, window=window,
                active_bc=active_bc))
            grids.append(np.ascontiguousarray(g))
    return TrioMulti(descs=tuple(descs), grids=tuple(grids))


def build_pair_multi(config, coefficients) -> Optional[PairMulti]:
    """Per pair type the closed-form spec and coefficients, re-expressed
    over cardinal B-splines where the knots are uniform and linear; None
    where any pair's knots have no closed form."""
    element_list = list(config.element_list)
    n_species = len(element_list)
    sizes, offsets = config.get_interaction_partitions()
    pair_type = np.zeros((n_species, n_species), dtype=np.int64)
    specs, coeffs = [], []
    for p_idx, pair in enumerate(config.interactions_map[2]):
        ok, spec = leg_spec_from_knots(config.knots_map[pair], exact=True)
        if not ok:
            return None
        s_a, s_b = element_list.index(pair[0]), element_list.index(pair[1])
        pair_type[s_a, s_b] = pair_type[s_b, s_a] = p_idx
        c = np.asarray(coefficients[offsets[pair]:offsets[pair]
                                    + sizes[pair]], dtype=np.float64)
        if spec.kind == LINEAR:
            uc = cardinal_coefficients(config.knots_map[pair], c)
            if uc is not None:
                spec, c = spec._replace(cardinal=True), uc
        specs.append(spec)
        coeffs.append(c)
    return PairMulti(specs=tuple(specs), coefficients=tuple(coeffs),
                     pair_type=pair_type)


def mirrored(descs, grids) -> bool:
    """Whether the types pair up so that the partials summed over types
    are symmetric in the pair lanes (g_mn = g_nm), which
    ``trio_virial6`` needs: each type (c, m, n) with m != n has its
    mirror (c, n, m) on the transposed grid with the legs swapped, and
    each type with m == n a grid symmetric in its first two legs."""
    index = {(d.s_c, d.s_m, d.s_n): i for i, d in enumerate(descs)}
    for desc, grid in zip(descs, grids):
        j = index.get((desc.s_c, desc.s_n, desc.s_m))
        if j is None or descs[j].spec_l1 != desc.spec_l2 \
                or descs[j].spec_l2 != desc.spec_l1 \
                or not np.array_equal(grids[j], grid.transpose(1, 0, 2)):
            return False
    return True


# ints per ordered type in the packed metadata after type_of, and reals
# (csrc/trio_multi.cu kRec, kReal)
PACK_RECORD, PACK_REALS = 16, 12


class TrioMultiPack(NamedTuple):
    """The multi-species trio kernel's metadata, packed once: ``ints``
    (int32) the (S, S, S) ``type_of`` table (the index of the ordered
    type (s_c, s_m, s_n) in ``descs``, -1 where the model has none),
    then per type ``PACK_RECORD`` ints: (kind, n_int, table offset) of
    its first, second and third legs, its window (l_lo, Lw, b_lo, Bw,
    c_lo, Cw) and the offset of its grid window in ``grids``; ``reals``
    (float64) per type ``PACK_REALS``: (u0, 1/h, t_min, t_max) of the
    three legs; ``tables`` each distinct leg's (n_int, 20) Horner rows
    once, end to end; ``grids`` each type's (Lw, Bw, Cw) live grid window,
    end to end.  Each array is zero-padded to a multiple of 4 elements
    (16-byte bulk copies).  ``max_cols`` is the widest Bw * Cw."""
    ints: np.ndarray
    reals: np.ndarray
    tables: np.ndarray
    grids: np.ndarray
    n_species: int
    max_cols: int


def _pad4(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros((-len(x)) % 4, dtype=x.dtype)])


def pack_trio_multi(descs, grids, n_species: int) -> TrioMultiPack:
    """Pack the ordered types ``descs`` (``TrioTypeDesc``) and their dense
    grids over ``n_species`` species for the multi-species trio kernel
    (see ``TrioMultiPack``).  Raises on a species id outside
    [0, n_species), an ordered type given twice, and a leg without a
    closed form in the clamped basis."""
    s = n_species
    type_of = np.full((s, s, s), -1, dtype=np.int32)
    records = np.zeros((len(descs), PACK_RECORD), dtype=np.int32)
    reals = np.zeros((len(descs), PACK_REALS))
    tables, table_at, windows = [], {}, []
    n_tab = n_grid = 0
    for t, (desc, grid) in enumerate(zip(descs, grids)):
        key = (desc.s_c, desc.s_m, desc.s_n)
        if not all(0 <= x < s for x in key):
            raise ValueError(f"trio type {key}: species outside [0, {s})")
        if type_of[key] != -1:
            raise ValueError(f"trio type {key} given twice")
        type_of[key] = t
        for j, spec in enumerate((desc.spec_l1, desc.spec_l2, desc.spec_n)):
            if spec.cardinal:
                raise ValueError("trio kernel legs take closed-form knots "
                                 "in the clamped basis")
            if spec not in table_at:
                table_at[spec] = n_tab
                tables.append(horner_table(spec).ravel())
                n_tab += tables[-1].size
            records[t, 3 * j:3 * j + 3] = (spec.kind, spec.n_int,
                                           table_at[spec])
            reals[t, 4 * j:4 * j + 4] = (spec.u0, 1.0 / spec.h, spec.t_min,
                                         spec.t_max)
        l_lo, l_hi, b_lo, b_hi, c_lo, c_hi = desc.window
        windows.append(np.asarray(grid, dtype=np.float64)[
            l_lo:l_hi, b_lo:b_hi, c_lo:c_hi].ravel())
        records[t, 9:] = (l_lo, l_hi - l_lo, b_lo, b_hi - b_lo, c_lo,
                          c_hi - c_lo, n_grid)
        n_grid += windows[-1].size
    max_cols = max(((d.window[3] - d.window[2]) * (d.window[5] - d.window[4])
                    for d in descs), default=1)
    return TrioMultiPack(
        ints=_pad4(np.concatenate([type_of.ravel(), records.ravel()])),
        reals=_pad4(reals.ravel()),
        tables=_pad4(np.concatenate(tables) if tables else np.zeros(0)),
        grids=_pad4(np.concatenate(windows) if windows else np.zeros(0)),
        n_species=s, max_cols=int(max_cols))


# -- the pair term --------------------------------------------------------------
def pair_forces_multi(coefficients, specs, d, cache2: ListCache,
                      with_energy: bool = True, with_virial: bool = False):
    """Pair energy and forces (and with ``with_virial`` the Voigt virial
    (6,)) from one gather's rows ``d`` (N, K2, 3): one gated chain per
    pair type, the cached pair-type ids ``cache2.ptype`` choosing each
    slot's type (no gate with a single type).  ``coefficients`` holds
    one tensor per type."""
    out = None
    for p, spec in enumerate(specs):
        valid = cache2.valid if len(specs) == 1 \
            else cache2.valid * (cache2.ptype == p).to(d.dtype)
        part = pair_row_forces(coefficients[p], d, valid, spec,
                               spec.n_basis, with_energy,
                               with_virial=with_virial)
        out = part if out is None else tuple(a + b
                                             for a, b in zip(out, part))
    return out


# -- the 3-body term ------------------------------------------------------------
def _gated_basis(r, gate, spec: LegSpec, lo: int, hi: int,
                 transposed: bool = False, shared: dict = None):
    """``_dense_basis(r, gate, ...)``; with a dict ``shared`` the ungated
    basis of these r is computed once per (spec, window) and the gate
    multiplied in after, which gives the same numbers: the gate is 0 or
    1 and scales every tap of a lane alike."""
    if shared is None:
        return _dense_basis(r, gate, spec, lo, hi, transposed)
    key = (spec, lo, hi, transposed)
    if key not in shared:
        shared[key] = _dense_basis(r, torch.ones_like(r), spec, lo, hi,
                                   transposed)
    g = gate[:, None, :] if transposed else gate[..., None]
    return tuple(m * g for m in shared[key])


def trio_multi_partials_torch(d, valid, s_slot, s_center, grid,
                              desc: TrioTypeDesc, with_energy: bool = True,
                              shared: dict = None):
    """Plain torch version of one ordered type's pass, line for line
    after ``_trio_block_compute_multi``: from rows ``d`` (N, K, 3), the
    slot mask ``valid`` (N, K), the slots' and centers' species
    ``s_slot`` (N, K) and ``s_center`` (N,) and the type's dense grid
    to energy (N,), center force (N, 3) and slot partials (N, K, 5) =
    (S1 = w_m, S3', V3') under the type's gates.  Row m owns H where its
    slot is valid, of species s_m and the center of species s_c; row n
    gives the second-leg basis where its slot is valid and of species
    s_n.  Summed over a mirrored set of types, the partials are those of
    the whole 3-body term.  ``shared`` (a dict, empty at the first type)
    lets the types of one call share their ungated leg bases."""
    n_atoms, k = d.shape[0], d.shape[1]
    dtype = d.dtype
    l_lo, l_hi, b_lo, b_hi, c_lo, c_hi = desc.window
    lw, bw, cw = l_hi - l_lo, b_hi - b_lo, c_hi - c_lo
    comps = d.unbind(-1)
    valid_f = valid.to(dtype)
    c_gate = (s_center == desc.s_c).to(dtype)
    m_ok = valid_f * (s_slot == desc.s_m).to(dtype) * c_gate[:, None]
    n_ok = valid_f * (s_slot == desc.s_n).to(dtype)
    r2 = comps[0] * comps[0] + comps[1] * comps[1] + comps[2] * comps[2]
    r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    a_mat, da_mat = _gated_basis(r, m_ok, desc.spec_l1, l_lo, l_hi,
                                 shared=shared)
    b_src, _ = _gated_basis(r, n_ok, desc.spec_l2, b_lo, b_hi,
                            shared=shared)
    # neighbor-neighbor legs on the pair lanes p = m*K + n: d[n] - d[m]
    r_mn2 = torch.zeros((n_atoms, k * k), dtype=dtype, device=d.device)
    for dc in comps:
        diff_c = (dc[:, None, :] - dc[:, :, None]).reshape(n_atoms, k * k)
        r_mn2 = r_mn2 + diff_c * diff_c
    r_mn = torch.sqrt(torch.where(r_mn2 > 0, r_mn2, torch.ones_like(r_mn2)))
    pair_valid = (n_ok.repeat(1, k) * m_ok.repeat_interleave(k, 1)
                  * (r_mn2 > 1e-10).to(dtype))
    c_p, dc_p = _gated_basis(r_mn, pair_valid, desc.spec_n, c_lo, c_hi,
                             transposed=True, shared=shared)
    c_p = c_p.reshape(n_atoms, cw, k, k)                 # [a, c, m, n]
    dc_p = dc_p.reshape(n_atoms, cw, k, k)
    g_flat = grid[l_lo:l_hi, b_lo:b_hi, c_lo:c_hi].reshape(lw, bw * cw)
    # H = A @ G as explicit mul-adds in the working type (no TF32)
    h = sum(a_mat[..., l:l + 1] * g_flat[l] for l in range(lw))
    h1 = sum(da_mat[..., l:l + 1] * g_flat[l] for l in range(lw))
    value = torch.zeros((n_atoms, k, k), dtype=dtype, device=d.device)
    t1 = torch.zeros_like(value)
    t3 = torch.zeros_like(value)
    for b_idx, c_list in desc.active_bc:
        db = torch.zeros_like(value)
        d1b = torch.zeros_like(value)
        d3b = torch.zeros_like(value)
        for c_idx in c_list:
            col = (b_idx - b_lo) * cw + (c_idx - c_lo)
            h_bc = h[:, :, col, None]                    # m-role
            h1_bc = h1[:, :, col, None]
            if with_energy:
                db = db + c_p[:, c_idx - c_lo] * h_bc
            d1b = d1b + c_p[:, c_idx - c_lo] * h1_bc
            d3b = d3b + dc_p[:, c_idx - c_lo] * h_bc
        b_col = b_src[:, None, :, b_idx - b_lo]          # n-role
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
    return energy, f_center, torch.stack([w_m, s3] + v3, dim=-1)


def trio_multi_partials_all_torch(potential, d, valid, s_slot, s_center,
                                  with_energy: bool = True):
    """Plain torch version of the multi-species pass over every ordered
    type of ``potential``'s trio: ``trio_multi_partials_torch`` per
    type, summed (the types share their ungated leg bases).  Fresh
    (energy (N,), center force (N, 3), partials (N, K, 5))."""
    n_atoms, k = d.shape[0], d.shape[1]
    out = (d.new_zeros(n_atoms), d.new_zeros((n_atoms, 3)),
           d.new_zeros((n_atoms, k, 5)))
    shared = {}
    for desc, tables in zip(potential.trio_multi.descs,
                            potential.trio_types):
        x = trio_multi_partials_torch(d, valid, s_slot, s_center,
                                      tables.grid, desc, with_energy,
                                      shared)
        out = tuple(a + b for a, b in zip(out, x))
    return out


def trio_multi_partials_all(potential, d, valid, s_slot, s_center,
                            with_energy: bool = True):
    """Energy (N,), center force (N, 3) and slot partials (N, K, 5) of
    ``potential``'s multi-species trio, summed over every ordered type,
    from rows ``d`` (N, K, 3), the slot mask ``valid`` (N, K) and the
    int64 species ids of the slots ``s_slot`` (N, K) and centers
    ``s_center`` (N,).  A CUDA tensor runs one launch of the kernel
    (``launch_trio_multi``) or raises; a CPU tensor runs
    ``trio_multi_partials_all_torch``.  ``trio_multi_partials_all.launches``
    counts kernel launches."""
    if d.device.type == "cpu":
        return trio_multi_partials_all_torch(potential, d, valid, s_slot,
                                             s_center, with_energy)
    return launch_trio_multi(potential, d, valid, s_slot, s_center,
                             with_energy)


trio_multi_partials_all.launches = 0


def launch_trio_multi(potential, d, valid, s_slot, s_center,
                      with_energy: bool = True):
    """One launch of the multi-species trio kernel
    (``csrc/trio_multi.cu``) on CUDA tensors, as
    ``trio_multi_partials_all``.  Raises
    on any other device, on operands it does not take, and when one
    warp's shared memory for K and the widest type window exceeds
    227 KB."""
    if d.device.type != "cuda":
        raise ValueError(f"no trio kernel for device {d.device}")
    pack = potential.trio_packed
    n_species, max_cols = potential.trio_multi_plan
    n_atoms, k = d.shape[0], d.shape[1]
    dtype = pack.reals.dtype
    if d.shape[2:] != (3,) or tuple(valid.shape) != (n_atoms, k) \
            or tuple(s_slot.shape) != (n_atoms, k) \
            or tuple(s_center.shape) != (n_atoms,):
        raise ValueError(f"bad shapes d {tuple(d.shape)}, valid "
                         f"{tuple(valid.shape)}, s_slot "
                         f"{tuple(s_slot.shape)}, s_center "
                         f"{tuple(s_center.shape)}")
    if k > MAX_SLOTS:
        raise ValueError(f"capacity {k}: the trio kernel takes K <= "
                         f"{MAX_SLOTS} slots (one warp per atom)")
    if dtype not in (torch.float32, torch.float64) or d.dtype != dtype \
            or valid.dtype != dtype:
        raise TypeError(f"trio kernel takes float32 or float64 matching "
                        f"the potential ({dtype}); got d {d.dtype}, valid "
                        f"{valid.dtype}")
    if s_slot.dtype != torch.int64 or s_center.dtype != torch.int64:
        raise TypeError("trio kernel species ids are int64")
    buffers = (pack.ints, pack.reals, pack.tables, pack.grids)
    for t in (valid, s_slot, s_center) + buffers:
        if t.device != d.device:
            raise ValueError("trio kernel operands on different devices")
    if any(b.data_ptr() % 16 for b in buffers):
        raise ValueError("the packed trio metadata must be 16-byte aligned "
                         "(bulk copies)")
    d, valid = d.contiguous(), valid.contiguous()
    s_slot, s_center = s_slot.contiguous(), s_center.contiguous()
    energy = torch.empty(n_atoms, dtype=dtype, device=d.device)
    f_center = torch.empty((n_atoms, 3), dtype=dtype, device=d.device)
    part = torch.empty((n_atoms, k, 5), dtype=dtype, device=d.device)
    lib = _build.library()
    fn = lib.uf3_trio_multi_f32 if dtype == torch.float32 \
        else lib.uf3_trio_multi_f64
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(d.data_ptr(), valid.data_ptr(), s_slot.data_ptr(),
                 s_center.data_ptr(), *(b.data_ptr() for b in buffers),
                 energy.data_ptr(), f_center.data_ptr(), part.data_ptr(),
                 n_atoms, k, n_species, max_cols,
                 *(b.numel() for b in buffers), int(bool(with_energy)),
                 stream)
    _check_window(err, k, f"{max_cols}-column")
    trio_multi_partials_all.launches += 1
    return energy, f_center, part


def trio_multi_occupancy(potential, k: int, is_f64: bool,
                         with_energy: bool = False,
                         n_atoms: int = 0) -> dict:
    """The launch plan of the multi-species trio kernel for this
    potential's packed types, K slots and float64 or float32, from the
    CUDA runtime: atoms (warps) per block, shared bytes per block,
    resident blocks and warps per SM, registers and local (spill) bytes
    per thread, whether the tables and the grids sit in shared memory,
    and the blocks a launch over ``n_atoms`` atoms takes."""
    pack = potential.trio_packed
    n_species, max_cols = potential.trio_multi_plan
    out = (ctypes.c_int * 9)()
    err = _build.library().uf3_trio_multi_occupancy(
        int(is_f64), n_atoms, k, n_species, max_cols,
        *(b.numel() for b in (pack.ints, pack.reals, pack.tables,
                               pack.grids)),
        int(bool(with_energy)), out)
    _check_window(err, k, f"{max_cols}-column")
    return dict(atoms_per_block=out[0], smem_bytes=out[1],
                blocks_per_sm=out[2], warps_per_sm=out[2] * out[0],
                registers=out[3], local_bytes=out[4],
                tables_staged=bool(out[5]), grids_staged=bool(out[6]),
                blocks=out[7], sms=out[8])


def trio_forces_multi(potential, species, positions, nbr3: NeighborList,
                      cache3: ListCache, with_energy: bool = True,
                      with_virial: bool = False, d=None):
    """3-body per-atom energy (N,) and forces (N, 3) of the multi-species
    trio on the 3-body list (``cache3`` with its species columns): one
    pass over every ordered type (one kernel launch on the card), one
    reverse-slot assembly; with ``with_virial`` also the Voigt virial
    (6,) from the summed partials, whose pair lanes are symmetric over a
    mirrored set of types (``mirrored``).  ``d`` reuses a gather."""
    if with_virial and not potential.trio_multi_mirrored:
        raise ValueError("the multi-species 3-body virial needs each trio "
                         "type's mirror (c, n, m) on the transposed grid")
    if d is None:
        d = cached_displacements(positions, nbr3, cache3)
    energy, f_center, part = trio_multi_partials_all(
        potential, d, cache3.valid, cache3.s_slot, species, with_energy)
    result = assemble_forces(energy, f_center, part, d, cache3.rev_flat,
                             nbr3.mask)
    if with_virial:
        return result + (trio_virial6(part, d, cache3.valid),)
    return result
