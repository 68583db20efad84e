"""
Halo-exchange (slab domain decomposition) MD on a ``ShardMesh``.

Counterpart of ``uf3_tpu/parallel/halo.py``: each shard owns the atoms
whose fractional coordinate along the slab axis falls in its interval
and holds read-only halo copies of its two neighbors' atoms within
``r_cut + skin`` of its faces.  Per MD step two ``ppermute``s refresh
the halo positions and two ship back the trio force partials that owned
centers left on halo copies (the pair rows are row-local and need no
return trip); the energy and the virial are ``psum``s and the skin
check a ``pmax``.  Every local atom, owned or halo, has a full neighbor
row, so the reverse-slot assembly works unchanged; a row whose center
is a halo copy has center weight 0, so its triangles and pairs count
once, in the shard that owns the center (the trio kernel skips such
rows outright).  The collectives carry O(halo) elements, not O(N):
``ShardMesh.traffic`` records them.

Where a rank holds several shards, the rows of all of them go through
one pair pass and one trio launch, their indices offset per shard.
"""

from typing import NamedTuple

import numpy as np
import torch

from uf3_tpu_torch.forcefield.md import _resolve_device
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops.pair import (pair_row_forces, pair_short_forces,
                                    pair_tail_forces)
from uf3_tpu_torch.ops.splines import basis_window_hi
from uf3_tpu_torch.ops.trio import trio_forces


class SlabDecomposition(NamedTuple):
    """Per-shard state stacked on a leading shard axis, identical
    shapes across shards: (S, ...) for the whole mesh, or this rank's
    (n_local, ...) after ``shard``."""
    x_own: torch.Tensor        # (S, C_own, 3) owned positions (padded)
    own_mask: torch.Tensor     # (S, C_own) live owned slots
    own_gid: torch.Tensor      # (S, C_own) global atom id (-1 pad)
    masses: torch.Tensor       # (S, C_own, 1)
    # my halo_left block holds copies of the LEFT neighbor's send_right
    # rows, in the same slot order
    send_left: torch.Tensor    # (S, C_halo) owned slots sent to s-1
    send_right: torch.Tensor   # (S, C_halo) owned slots sent to s+1
    send_left_mask: torch.Tensor   # (S, C_halo)
    send_right_mask: torch.Tensor  # (S, C_halo)
    shift_left: torch.Tensor   # (S, 3) wrap shift applied to halo_left
    shift_right: torch.Tensor  # (S, 3) wrap shift applied to halo_right
    # local neighbor lists over [owned; halo_left; halo_right]
    idx2: torch.Tensor         # (S, L, K2)
    shift2: torch.Tensor       # (S, L, K2, 3)
    mask2: torch.Tensor        # (S, L, K2)
    idx3: torch.Tensor         # (S, L, K3)
    shift3: torch.Tensor       # (S, L, K3, 3)
    mask3: torch.Tensor        # (S, L, K3)
    rev3: torch.Tensor         # (S, L, K3)
    center_w: torch.Tensor     # (S, L) 1 for live owned rows else 0

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "SlabDecomposition":
        """A decomposition from numpy arrays under these field names (an
        object with them as attributes, as ``uf3_tpu``'s
        ``SlabDecomposition``, or a mapping): indices as int64, masks as
        bool, the rest as float64, on ``device`` (default: the card)."""
        device = _resolve_device(device)
        get = arrays.__getitem__ if isinstance(arrays, dict) \
            else lambda name: getattr(arrays, name)
        return cls(**{name: _as_tensor(get(name), device)
                      for name in cls._fields})

    @property
    def c_own(self) -> int:
        return self.x_own.shape[1]

    @property
    def c_halo(self) -> int:
        return self.send_left.shape[1]


def _as_tensor(array, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``: int64 indices, bool
    masks, float64 otherwise."""
    a = np.asarray(array)
    if a.dtype.kind == "b":
        return torch.as_tensor(a, dtype=torch.bool, device=device)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), device=device)


def _slab_width(cell: np.ndarray, axis: int) -> float:
    """Cartesian thickness of the full cell along lattice vector
    ``axis`` (volume over the area spanned by the other two)."""
    a, b = [cell[i] for i in range(3) if i != axis]
    area = np.linalg.norm(np.cross(a, b))
    return abs(np.linalg.det(cell)) / area


def decompose(positions: np.ndarray, cell: np.ndarray, n_shards: int,
              r_cut_2b: float, r_cut_3b: float, skin: float,
              capacity_2b: int, capacity_3b: int, masses=None,
              axis: int = None, pad: float = 1.15,
              device=None) -> SlabDecomposition:
    """Slab decomposition and per-shard local neighbor lists, with the
    reference's arithmetic: owners, send windows in global-id order, the
    1.15 capacity pad, padding parked 1e6 A along the slab axis, wrap
    shifts.  The local lists are built on ``device`` (default: the card)
    in float64 by the O(N^2) builder, not periodic along the slab axis,
    the 3-body list filtered from the 2-body list (with reverse slots).

    Requires the slab thickness per shard to cover the halo width
    (``r_cut_2b + skin``) so only adjacent shards exchange, and the two
    in-plane cell vectors to support the minimum-image convention at
    the 2-body cutoff."""
    device = _resolve_device(device)
    positions = np.asarray(positions, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    n_atoms = positions.shape[0]
    if axis is None:
        axis = int(np.argmax([_slab_width(cell, a) for a in range(3)]))
    r_halo = r_cut_2b + skin
    width = _slab_width(cell, axis) / n_shards
    if width < r_halo:
        raise ValueError(
            f"slab width {width:.2f} A < halo width {r_halo:.2f} A "
            f"along axis {axis}: use fewer shards or a larger cell")
    frac = positions @ np.linalg.inv(cell)
    frac -= np.floor(frac)                    # wrap into [0, 1)
    x_wrapped = frac @ cell
    owner = np.minimum((frac[:, axis] * n_shards).astype(np.int64),
                       n_shards - 1)
    f_halo = r_halo / _slab_width(cell, axis)
    if masses is None:
        masses = np.ones(n_atoms)
    masses = np.asarray(masses, dtype=np.float64)

    own_lists = [np.where(owner == s)[0] for s in range(n_shards)]
    c_own = int(np.ceil(max(len(o) for o in own_lists) * pad)) + 1
    # send_right of shard s: owned atoms within f_halo of the upper
    # boundary (they become shard s+1's halo_left); global-id order on
    # both sides keeps sender slots and receiver slots aligned
    send_r_gids = [o[frac[o, axis] > (s + 1) / n_shards - f_halo]
                   for s, o in enumerate(own_lists)]
    send_l_gids = [o[frac[o, axis] < s / n_shards + f_halo]
                   for s, o in enumerate(own_lists)]
    c_halo = int(np.ceil(max(
        max((len(g) for g in send_r_gids), default=1),
        max((len(g) for g in send_l_gids), default=1)) * pad)) + 1

    S = n_shards
    L = c_own + 2 * c_halo
    dec = dict(
        x_own=np.zeros((S, c_own, 3)),
        own_mask=np.zeros((S, c_own), dtype=bool),
        own_gid=np.full((S, c_own), -1, dtype=np.int64),
        masses=np.ones((S, c_own, 1)),
        send_left=np.zeros((S, c_halo), dtype=np.int64),
        send_right=np.zeros((S, c_halo), dtype=np.int64),
        send_left_mask=np.zeros((S, c_halo), dtype=bool),
        send_right_mask=np.zeros((S, c_halo), dtype=bool),
        shift_left=np.zeros((S, 3)),
        shift_right=np.zeros((S, 3)),
        center_w=np.zeros((S, L)),
    )
    lists = {name: [] for name in ("idx2", "shift2", "mask2", "idx3",
                                   "shift3", "mask3", "rev3")}
    pbc_local = [True, True, True]
    pbc_local[axis] = False
    cell_t = torch.as_tensor(cell, device=device)
    sentinel = np.zeros(3)
    sentinel[axis] = 1e6
    for s in range(S):
        own = own_lists[s]
        n_own = len(own)
        dec["x_own"][s, :n_own] = x_wrapped[own]
        # park padding far away along the non-periodic axis so the
        # local neighbor search cannot select it
        dec["x_own"][s, n_own:] = sentinel + cell[axis] * (s + 2)
        dec["own_mask"][s, :n_own] = True
        dec["own_gid"][s, :n_own] = own
        dec["masses"][s, :n_own, 0] = masses[own]
        slot_of = {g: i for i, g in enumerate(own)}
        for name, gids in (("send_left", send_l_gids[s]),
                           ("send_right", send_r_gids[s])):
            dec[name][s, :len(gids)] = [slot_of[g] for g in gids]
            dec[name + "_mask"][s, :len(gids)] = True
        # wrap shifts: halo_left of shard 0 comes from shard S-1 across
        # the periodic boundary (and vice versa at the top)
        if s == 0:
            dec["shift_left"][s] = -cell[axis]
        if s == S - 1:
            dec["shift_right"][s] = cell[axis]
        left, right = (s - 1) % S, (s + 1) % S
        halo_l = np.full((c_halo, 3), sentinel + cell[axis] * (s + 4))
        gl = send_r_gids[left]
        halo_l[:len(gl)] = x_wrapped[gl] + dec["shift_left"][s]
        halo_r = np.full((c_halo, 3), sentinel + cell[axis] * (s + 6))
        gr = send_l_gids[right]
        halo_r[:len(gr)] = x_wrapped[gr] + dec["shift_right"][s]
        x_local = torch.as_tensor(
            np.concatenate([dec["x_own"][s], halo_l, halo_r]),
            device=device)
        nbr2 = nb.build_neighbor_list(x_local, cell_t, tuple(pbc_local),
                                      r_cut_2b + skin, capacity_2b)
        if bool(nbr2.overflow):
            raise ValueError("local 2-body capacity overflow in slab "
                             f"{s}; raise capacity_2b")
        nbr3 = nb.filter_neighbor_list(nbr2, x_local, cell_t,
                                       r_cut_3b + skin, capacity_3b)
        if bool(nbr3.overflow):
            raise ValueError("local 3-body capacity overflow in slab "
                             f"{s}; raise capacity_3b")
        for tag, nbr in (("2", nbr2), ("3", nbr3)):
            lists["idx" + tag].append(nbr.idx)
            lists["shift" + tag].append(nbr.shift)
            lists["mask" + tag].append(nbr.mask)
        lists["rev3"].append(nbr3.rev)
        dec["center_w"][s, :n_own] = 1.0
    return SlabDecomposition(
        **{name: _as_tensor(a, device) for name, a in dec.items()},
        **{name: torch.stack(ts) for name, ts in lists.items()})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_positions(dec: SlabDecomposition, x_own, n_atoms: int
                     ) -> np.ndarray:
    """The global (N, 3) array from the per-shard owned blocks of the
    whole mesh (host side, for rebuilds and analysis)."""
    x_own = _np(x_own)
    own_gid, own_mask = _np(dec.own_gid), _np(dec.own_mask)
    out = np.zeros((n_atoms, 3))
    for s in range(own_gid.shape[0]):
        live = own_mask[s]
        out[own_gid[s, live]] = x_own[s, live]
    return out


def scatter_velocities(dec: SlabDecomposition, velocities) -> np.ndarray:
    """Global (N, 3) velocities -> per-shard (S, C_own, 3) blocks."""
    own_gid, own_mask = _np(dec.own_gid), _np(dec.own_mask)
    velocities = _np(velocities)
    v = np.zeros(tuple(dec.x_own.shape))
    for s in range(own_gid.shape[0]):
        live = own_mask[s]
        v[s, live] = velocities[own_gid[s, live]]
    return v


class LocalRows(NamedTuple):
    """A rank's local rows flattened over its shards (indices offset by
    shard * L): what one pair pass and one trio launch take."""
    nbr2: nb.NeighborList
    cache2: nb.ListCache
    nbr3: nb.NeighborList
    cache3: nb.ListCache
    weight: torch.Tensor      # (n_local * L,) center weights
    send_r: torch.Tensor      # (n_local * C_halo,) flat owned slots
    send_l: torch.Tensor
    send_r_mask: torch.Tensor
    send_l_mask: torch.Tensor


def local_rows(dec: SlabDecomposition, cell, dtype) -> LocalRows:
    """The flat local rows of a rank's shards ``dec``, their list caches
    in ``dtype`` for ``cell``, center weights and flat send slots."""
    n_local, n_rows = dec.center_w.shape
    offs = torch.arange(n_local, device=dec.idx2.device)
    rows = n_local * n_rows

    def flat(idx, shift, mask):
        idx = (idx + offs[:, None, None] * n_rows).reshape(rows, -1)
        return idx, shift.reshape(rows, -1, 3), mask.reshape(rows, -1)

    idx2, shift2, mask2 = flat(dec.idx2, dec.shift2, dec.mask2)
    idx3, shift3, mask3 = flat(dec.idx3, dec.shift3, dec.mask3)
    k3 = idx3.shape[1]
    rev3 = dec.rev3.reshape(rows, k3)
    cache2 = nb.ListCache(sd=nb.cell_transform(shift2.to(dtype), cell),
                          valid=mask2.to(dtype), rev_flat=None)
    nbr2 = nb.NeighborList(idx=idx2, shift=shift2, mask=mask2, rev=None,
                           overflow=None, reference_positions=None)
    nbr3 = nb.NeighborList(idx=idx3, shift=shift3, mask=mask3, rev=rev3,
                           overflow=None, reference_positions=None)
    cache3 = nb.ListCache(sd=nb.cell_transform(shift3.to(dtype), cell),
                          valid=mask3.to(dtype), rev_flat=idx3 * k3 + rev3)
    slot = offs[:, None] * dec.c_own
    return LocalRows(nbr2=nbr2, cache2=cache2, nbr3=nbr3, cache3=cache3,
                     weight=dec.center_w.reshape(rows).to(dtype),
                     send_r=(dec.send_right + slot).reshape(-1),
                     send_l=(dec.send_left + slot).reshape(-1),
                     send_r_mask=dec.send_right_mask.reshape(-1, 1),
                     send_l_mask=dec.send_left_mask.reshape(-1, 1))


def local_positions(mesh, dec: SlabDecomposition, rows: LocalRows,
                    x_own) -> torch.Tensor:
    """The local [owned; halo_left; halo_right] positions of a rank's
    shards, (n_local * L, 3), from their owned positions (n_local,
    C_own, 3): two ``ppermute``s.  My halo_left holds my LEFT
    neighbor's send_right rows, so every shard packs send_right and
    sends it to the right."""
    flat = x_own.reshape(-1, 3)
    n_local = x_own.shape[0]
    halo_l, halo_r = mesh.ppermutes([
        (flat[rows.send_r].reshape(n_local, -1, 3), 1),
        (flat[rows.send_l].reshape(n_local, -1, 3), -1)])
    return torch.cat([x_own, halo_l + dec.shift_left[:, None, :],
                      halo_r + dec.shift_right[:, None, :]],
                     dim=1).reshape(-1, 3)


def halo_md_step_factory(system, mesh, n_steps: int = 1,
                         with_virial: bool = False, n_respa: int = 1,
                         respa_mid: int = 1):
    """Halo-exchange MD on ``mesh`` for the fused unary 2+3-body model:
    returns ``(chunk, shard)``.  ``shard(tree)`` gives this rank's
    shards of a whole-mesh ``SlabDecomposition`` (or of any (S, ...)
    array) on the system's device, floats in its dtype.
    ``chunk(dec, x_own, v, dt)`` advances ``n_steps`` of velocity-Verlet
    NVE and returns ``(x_own, v, f_own, energy, stale)``, with
    ``with_virial`` ``(x_own, v, f_own, energy, virial, stale)``: the
    global Voigt virial (owner-weighted per-center terms, psummed).
    ``stale`` (bool, replicated) is set once any owned atom has moved
    past half the skin since the decomposition: re-``decompose`` from the
    gathered positions before trusting further chunks.

    Per step: 2 ``ppermute``s of (C_halo, 3) positions out and 2 of
    (C_halo, 3) trio force partials back; the energy is one scalar
    psum.  ``n_respa`` / ``respa_mid`` split the force as the
    single-device engine's 3-level r-RESPA: the 2-body tail on the
    (L, K2) rows every ``n_respa`` steps, the 3-body force (the only
    level with the reverse exchange) every ``respa_mid`` steps, the
    switched short pair on the (L, K3) rows every step; the halo
    positions refresh every step.  The trio kernel takes its triangle
    lanes on a grid symmetric in its first two legs."""
    n_respa = int(n_respa)
    respa_mid = int(respa_mid)
    if respa_mid > 1 and n_respa <= 1:
        raise ValueError("respa_mid > 1 requires n_respa > 1")
    pot = system.potential
    if pot.trio is None or pot.pair_spec is None or system._multi_route() \
            or system.separate_3b:
        raise ValueError("halo MD requires the fused unary fast path "
                         "(2+3-body single-species model, 3-body cutoff "
                         "within the 2-body cutoff)")
    if n_respa > 1:
        if n_steps % n_respa:
            raise ValueError("n_steps must be a multiple of n_respa")
        if n_respa % respa_mid:
            raise ValueError("n_respa must be a multiple of respa_mid")
        if system.respa_switch is not None:
            r_lo, r_hi = system.respa_switch
        else:
            r_hi = float(system.r_cut_3b)
            r_lo = r_hi - 0.5
        n_short = basis_window_hi(pot.pair_spec, r_hi)
    dtype, device = system.dtype, system.device
    spec = pot.pair_spec
    coef = pot.pair_coefficients
    cell = system.cell
    # the triangle lanes on every symmetric grid, as the reference's
    # halo path runs them
    triangle = pot.trio.symmetric
    half_skin2 = (0.5 * float(system.skin)) ** 2

    def send_back(f, dec, rows):
        """Owned forces (n_local, C_own, 3) from the local forces
        (n_local * L, 3): the partials on my halo copies go back to the
        shards that own those atoms."""
        n_local, c_own, c_halo = dec.x_own.shape[0], dec.c_own, dec.c_halo
        f = f.reshape(n_local, -1, 3)
        back_l, back_r = mesh.ppermutes([
            (f[:, c_own:c_own + c_halo], -1),   # to my halo_left's owner
            (f[:, c_own + c_halo:], 1)])
        # back_l arrives at the LEFT neighbor: forces on ITS send_right
        # rows; back_r on its right neighbor's send_left rows
        f_own = f[:, :c_own].reshape(-1, 3).clone()
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        f_own.index_add_(0, rows.send_r, torch.where(
            rows.send_r_mask, back_l.reshape(-1, 3), zero))
        f_own.index_add_(0, rows.send_l, torch.where(
            rows.send_l_mask, back_r.reshape(-1, 3), zero))
        return f_own.reshape(n_local, c_own, 3)

    def local_forces(x_local, dec, rows, with_energy=False,
                     virial=False):
        d2 = nb.cached_displacements(x_local, rows.nbr2, rows.cache2)
        out2 = pair_row_forces(coef, d2, rows.cache2.valid, spec,
                               spec.n_basis, with_energy,
                               with_virial=virial,
                               center_weight=rows.weight)
        d3 = nb.cached_displacements(x_local, rows.nbr3, rows.cache3)
        out3 = trio_forces(pot, x_local, cell, rows.nbr3, with_energy,
                           cache3=rows.cache3, d=d3, with_virial=virial,
                           center_weight=rows.weight, triangle=triangle)
        f_own = send_back(out2[1] + out3[1], dec, rows)
        if not with_energy:
            return f_own, None, None
        energy = mesh.psum((out2[0] + torch.sum(out3[0]))[None])
        v6 = mesh.psum((out2[2] + out3[2])[None]) if virial else None
        return f_own, energy, v6

    def own_rows(f, dec):
        """The owned rows (n_local, C_own, 3) of local row forces."""
        return f.reshape(dec.x_own.shape[0], -1, 3)[:, :dec.c_own]

    def trio_with_exchange(x_local, d3, dec, rows):
        """The 3-body force and the reverse exchange of the partials on
        halo copies (the one r-RESPA level that sends forces back)."""
        _, f3 = trio_forces(pot, x_local, cell, rows.nbr3, False,
                            cache3=rows.cache3, d=d3,
                            center_weight=rows.weight, triangle=triangle)
        return send_back(f3, dec, rows)

    def chunk(dec: SlabDecomposition, x_own, v, dt):
        dt = float(dt)
        rows = local_rows(dec, cell, dtype)
        m = dec.masses
        x_local = local_positions(mesh, dec, rows, x_own)
        if n_respa > 1:
            def short_forces(x_local):
                """The switched short pair on the (L, K3) rows
                (row-local) and the rows' displacements, which the trio
                level reuses."""
                _, f, d3 = pair_short_forces(
                    coef, x_local, cell, rows.nbr3, spec, n_short, False,
                    r_lo, r_hi, cache3=rows.cache3,
                    center_weight=rows.weight)
                return own_rows(f, dec), d3

            def tail_forces(x_local):
                """The pair tail on the (L, K2) rows (row-local)."""
                _, f = pair_tail_forces(
                    coef, x_local, cell, rows.nbr2, spec, spec.n_basis,
                    False, r_lo, r_hi, cache2=rows.cache2,
                    center_weight=rows.weight)
                return own_rows(f, dec)

            f_ps, d3 = short_forces(x_local)
            f_mid = trio_with_exchange(x_local, d3, dec, rows)
            f_tail = tail_forces(x_local)
            dt_mid, dt_out = dt * respa_mid, dt * n_respa
            for _ in range(n_steps // n_respa):
                v = v + 0.5 * dt_out * f_tail / m
                for _ in range(n_respa // respa_mid):
                    v = v + 0.5 * dt_mid * f_mid / m
                    for _ in range(respa_mid):
                        v = v + 0.5 * dt * f_ps / m
                        x_own = x_own + dt * v
                        x_local = local_positions(mesh, dec, rows, x_own)
                        f_ps, d3 = short_forces(x_local)
                        v = v + 0.5 * dt * f_ps / m
                    # the last inner step's rows feed the trio level
                    f_mid = trio_with_exchange(x_local, d3, dec, rows)
                    v = v + 0.5 * dt_mid * f_mid / m
                f_tail = tail_forces(x_local)
                v = v + 0.5 * dt_out * f_tail / m
            f = f_ps + f_mid + f_tail
        else:
            f, _, _ = local_forces(x_local, dec, rows)
            for _ in range(n_steps):
                v = v + 0.5 * dt * f / m
                x_own = x_own + dt * v
                f, _, _ = local_forces(
                    local_positions(mesh, dec, rows, x_own), dec, rows)
                v = v + 0.5 * dt * f / m
        _, energy, virial = local_forces(
            local_positions(mesh, dec, rows, x_own), dec, rows,
            with_energy=True, virial=with_virial)
        energy = energy + system._e1()
        # skin check against the decomposition-time positions: past
        # half the skin the fixed lists and send windows can miss pairs
        disp2 = torch.sum((x_own - dec.x_own) ** 2, dim=-1)
        disp2 = torch.where(dec.own_mask, disp2, torch.zeros_like(disp2))
        stale = mesh.pmax(torch.amax(disp2, dim=1)) > half_skin2
        if with_virial:
            return x_own, v, f, energy, virial, stale
        return x_own, v, f, energy, stale

    def shard(tree):
        """This rank's shards of ``tree`` (a whole-mesh decomposition or
        (S, ...) array) on the system's device, floats in its dtype."""
        def one(leaf):
            t = leaf if isinstance(leaf, torch.Tensor) \
                else torch.as_tensor(np.asarray(leaf))
            t = mesh.local(t).to(device)
            return t.to(dtype) if t.is_floating_point() else t
        if isinstance(tree, SlabDecomposition):
            return SlabDecomposition(*[one(leaf) for leaf in tree])
        return one(tree)

    return chunk, shard
