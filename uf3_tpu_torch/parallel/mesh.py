"""
Shards on ``torch.distributed``: a 1-D mesh of S shards spread over the
W ranks of a process group, and the data-parallel fit and the
replicated-positions MD chunk on it.

Counterpart of ``uf3_tpu/parallel/mesh.py`` (``make_mesh``,
``sharded_gram``, ``fit_sharded``, ``fit_from_file_sharded``,
``sharded_md_step_factory``), where ``jax.shard_map`` runs one program
per device of a mesh.  Here each rank holds S / W consecutive shards
stacked on a leading axis (the ``(S, ...)`` layout sliced to the
rank's own shards), and ``ShardMesh`` gives the collectives
``shard_map`` programs use: ``ppermute`` along the shard ring, ``psum``
/ ``pmax`` and ``all_gather``.  One rank may hold several shards: that
is how one card runs a 4-shard decomposition (NCCL holds one rank per
GPU), as the JAX package runs it on virtual CPU devices; it adds no
physics.  ``ShardMesh.traffic`` counts the elements every collective
moves per shard, by operation, where the reference audits its compiled
HLO.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from uf3_tpu_torch.forcefield.md import _resolve_device
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops.pair import pair_row_forces
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.regression import least_squares as ls

OPS = ("ppermute", "psum", "pmax", "all_gather")


class ShardMesh:
    """S shards over the ranks of ``group`` (one process when None).

    ``n_local`` = S / W shards per rank, global ids ``first`` ..
    ``first + n_local - 1``.  CUDA tensors need a NCCL group and CPU
    tensors a gloo group.  ``device`` is the group's device (the current
    card under NCCL, the CPU under gloo) or, without a group, the device
    asked for (None: the tensors' own).  ``traffic[op]`` lists, per
    call, the elements one shard puts into the collective;
    ``sent_bytes[op]`` sums the bytes this rank's shards put in."""

    def __init__(self, n_shards: int, group=None, device=None):
        self.group = group
        if group is None:
            self.world, self.rank, self.backend = 1, 0, None
            self.device = None if device is None else torch.device(device)
        else:
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group)).lower()
            if self.backend == "nccl":
                own = torch.device("cuda", torch.cuda.current_device())
            elif self.backend == "gloo":
                own = torch.device("cpu")
            else:
                raise ValueError(f"no shard mesh on a {self.backend} group: "
                                 "CUDA tensors take NCCL, CPU tensors gloo")
            if device is not None and torch.device(device).type != own.type:
                raise ValueError(f"a {self.backend} group runs on "
                                 f"{own.type}, not {device}")
            self.device = own
        if n_shards < 1 or n_shards % self.world:
            raise ValueError(f"{n_shards} shards do not spread evenly over "
                             f"{self.world} ranks")
        self.n_shards = int(n_shards)
        self.n_local = self.n_shards // self.world
        self.first = self.rank * self.n_local
        self.reset_traffic()

    def __repr__(self):
        return (f"ShardMesh({self.n_shards} shards, {self.world} ranks, "
                f"rank {self.rank}, {self.backend or 'one process'})")

    def reset_traffic(self):
        self.traffic = {op: [] for op in OPS}
        self.sent_bytes = {op: 0 for op in OPS}

    def local(self, x):
        """This rank's shards of a global (S, ...) array or tensor."""
        return x[self.first:self.first + self.n_local]

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None or self.group is dist.group.WORLD \
            else dist.get_global_rank(self.group, rank)

    def _record(self, op: str, block: torch.Tensor, blocks: int):
        self.traffic[op].append(int(block.numel()))
        self.sent_bytes[op] += int(block.numel()) * block.element_size() \
            * blocks

    def _check(self, x: torch.Tensor):
        if self.group is None:
            return
        if x.device.type != ("cuda" if self.backend == "nccl" else "cpu"):
            raise ValueError(f"a {x.device.type} tensor on a {self.backend} "
                             "group: CUDA tensors take NCCL, CPU tensors "
                             "gloo")

    # -- collectives -------------------------------------------------------
    def ppermute(self, x, shift: int):
        """Shard s's block of ``x`` (n_local, ...) goes to shard s +
        ``shift`` (+1 or -1) around the ring: returns, per local shard,
        the block of shard s - ``shift``."""
        return self.ppermutes([(x, shift)])[0]

    def ppermutes(self, pairs):
        """Several ``ppermute`` calls in one batch of point-to-point
        messages, each with its own tag, so that two messages to one
        peer (W = 2) cannot cross.  Where the neighbor rank is this rank
        the block is a local copy."""
        outs, ops = [], []
        for tag, (x, shift) in enumerate(pairs):
            if shift not in (1, -1):
                raise ValueError(f"shift {shift}: the ring takes +1 or -1")
            self._check(x)
            x = x.contiguous()
            self._record("ppermute", x[0], self.n_local)
            if self.world == 1:
                outs.append(torch.roll(x, shift, dims=0))
                continue
            out = torch.empty_like(x)
            if shift == 1:
                out[1:] = x[:-1]
                send, recv = x[-1], out[0]
            else:
                out[:-1] = x[1:]
                send, recv = x[0], out[-1]
            to = self._global_rank((self.rank + shift) % self.world)
            frm = self._global_rank((self.rank - shift) % self.world)
            ops.append(dist.P2POp(dist.isend, send, to, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, recv, frm, self.group, tag))
            outs.append(out)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return outs

    def _reduce(self, op: str, local, reduce_op, blocks: int):
        self._check(local)
        self._record(op, local, blocks)
        if self.group is not None:
            local = local.contiguous()
            dist.all_reduce(local, op=reduce_op, group=self.group)
        return local

    def psum(self, x):
        """Sum over every shard of ``x`` (n, ...): this rank's values
        (n = n_local), or their sum (n = 1), summed over the ranks.
        Replicated result (...)."""
        return self._reduce("psum", torch.sum(x, dim=0), dist.ReduceOp.SUM,
                            x.shape[0])

    def pmax(self, x):
        """Maximum over every shard of ``x`` (n, ...), as ``psum``."""
        return self._reduce("pmax", torch.amax(x, dim=0), dist.ReduceOp.MAX,
                            x.shape[0])

    def all_gather(self, x):
        """Every shard's block of ``x`` (n_local, ...): (S, ...) on
        every rank."""
        self._check(x)
        x = x.contiguous()
        self._record("all_gather", x[0], self.n_local)
        if self.group is None or self.world == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


def make_mesh(n_shards: int = None, group=None, device=None) -> ShardMesh:
    """A ``ShardMesh`` of ``n_shards`` (default: one per rank) over
    ``group``, a ``torch.distributed`` process group, or within one
    process when ``group`` is None."""
    if n_shards is None:
        n_shards = 1 if group is None else dist.get_world_size(group)
    return ShardMesh(n_shards, group, device)


# ---------------------------------------------------------------------------
# the fit: the Gram matrix over row shards
# ---------------------------------------------------------------------------
def _pad_rows(array, multiple):
    n = array.shape[0]
    pad = (-n) % multiple
    if pad:
        array = np.concatenate(
            [array, np.zeros((pad,) + array.shape[1:], array.dtype)])
    return array


def sharded_gram(x, y, mesh: ShardMesh, device=None):
    """Gram matrix (X^T X) and ordinate (X^T y) with the rows spread
    over the mesh's shards: zero rows pad them to a multiple of S (they
    add nothing), each shard forms its products in float64 on
    ``device`` (default: the mesh's, else the card), then a ``psum``.
    Returns float64 tensors (F, F) and (F,)."""
    device = torch.device(device) if device is not None else (
        mesh.device if mesh.device is not None else _resolve_device(None))
    x = _pad_rows(ls._host(x).astype(np.float64), mesh.n_shards)
    y = _pad_rows(ls._host(y).astype(np.float64), mesh.n_shards)
    rows = x.shape[0] // mesh.n_shards
    span = slice(mesh.first * rows, (mesh.first + mesh.n_local) * rows)
    x_s = torch.as_tensor(x[span], device=device).reshape(
        mesh.n_local, rows, x.shape[1])
    y_s = torch.as_tensor(y[span], device=device).reshape(
        mesh.n_local, rows, 1)
    x_t = x_s.transpose(1, 2)
    return mesh.psum(x_t @ x_s), mesh.psum(x_t @ y_s)[:, 0]


def _mesh_for(model, mesh):
    if mesh is None:
        return make_mesh(device=model.device)
    return mesh


def fit_sharded(model, x_e, y_e, x_f=None, y_f=None, weight: float = 0.5,
                mesh: ShardMesh = None) -> None:
    """Mesh-parallel twin of ``WeightedLinearModel.fit``: frozen columns
    eliminated on the host, the Gram matrices over the mesh's row shards
    (on the mesh's device, else the model's), the energy/force weights
    and the solve on the host in float64."""
    mesh = _mesh_for(model, mesh)
    device = mesh.device if mesh.device is not None else model.device
    x_e, y_e = ls.freeze_columns(ls._host(x_e), ls._host(y_e), model.mask,
                                 model.frozen_c, model.col_idx)
    gram_e, ord_e = sharded_gram(x_e, y_e, mesh, device)
    if x_f is not None and len(x_f):
        x_f, y_f = ls.freeze_columns(ls._host(x_f), ls._host(y_f),
                                     model.mask, model.frozen_c,
                                     model.col_idx)
        energy_weight, force_weight = ls.calc_E_F_weights(
            len(y_e), len(y_f), np.std(y_e), np.std(y_f))
        gram_f, ord_f = sharded_gram(x_f, y_f, mesh, device)
        gram, ordinate = model.combine_weighted_gram(
            ls._host(gram_e), ls._host(gram_f), ls._host(ord_e),
            ls._host(ord_f), energy_weight, force_weight, weight)
    else:
        gram, ordinate = gram_e, ord_e
    model.fit_with_gram(gram, ordinate)


def fit_from_file_sharded(model, filename: str, subset, weight: float = 0.5,
                          mesh: ShardMesh = None,
                          sample_weights: dict = None,
                          energy_key: str = "energy",
                          drop_columns=None) -> None:
    """Mesh-parallel twin of ``WeightedLinearModel.fit_from_file``
    (``least_squares.fit_tables``: the features file read one table at
    a time, the rows selected as ``fit_from_file`` selects them): each
    table's frozen columns eliminated on the host and its Gram matrices
    over the mesh's row shards, summed; the energy/force weights from
    the streamed targets' variances and the solve on the host in
    float64."""
    mesh = _mesh_for(model, mesh)
    device = mesh.device if mesh.device is not None else model.device

    def table_gram(rows, e_var, f_var):
        x_e, y_e, x_f, y_f = rows
        x_e, y_e = ls.freeze_columns(x_e, y_e, model.mask, model.frozen_c,
                                     model.col_idx)
        x_f, y_f = ls.freeze_columns(x_f, y_f, model.mask, model.frozen_c,
                                     model.col_idx)
        e_var.update(y_e)
        f_var.update(y_f)
        gram_e, ord_e = sharded_gram(x_e, y_e, mesh, device)
        gram_f, ord_f = sharded_gram(x_f, y_f, mesh, device)
        return [ls._host(g) for g in (gram_e, gram_f, ord_e, ord_f)]

    ls.fit_tables(model, filename, subset, table_gram, weight,
                  sample_weights, energy_key, drop_columns)


# ---------------------------------------------------------------------------
# MD with replicated positions and sharded rows
# ---------------------------------------------------------------------------
class ShardedRows(NamedTuple):
    """A neighbor list with its rows spread over the mesh: the whole
    list (every rank holds the replicated positions and assembles every
    force) and this rank's rows, ``n_local`` shards of R = ceil(N / S)
    rows each; rows past N pad the last shards (center 0, no slot)."""
    nbr: nb.NeighborList
    rows: torch.Tensor   # (n_local * R,) center atom of each local row
    live: torch.Tensor   # (n_local * R,) bool: a real row


def sharded_md_step_factory(system, mesh: ShardMesh, n_steps: int = 1):
    """Multi-shard MD with replicated positions and the per-atom rows
    sharded: each shard evaluates the pair rows and the trio partials
    of its own rows (one trio launch for all of a rank's shards), one
    ``all_gather`` of the partials with the row forces (center + pair)
    and the 3-body energies lets every shard assemble the whole force,
    and every shard integrates the same velocity-Verlet NVE.

    Returns (chunk, shard_atoms): ``shard_atoms(nbr)`` gives a list's
    ``ShardedRows``; ``chunk(positions, velocities, forces, nbr2, nbr3,
    dt)`` advances ``n_steps`` and returns (positions, velocities,
    forces, energy), replicated.  Runs the fused unary 2+3-body model
    (the trio kernel's path)."""
    pot = system.potential
    if pot.trio is None or pot.pair_spec is None or system._multi_route():
        raise ValueError("the sharded MD chunk runs the fused unary "
                         "2+3-body model (closed-form knots, one species)")
    spec = pot.pair_spec
    m = system.masses[:, None]
    cell = system.cell
    n_atoms = m.shape[0]
    per = -(-n_atoms // mesh.n_shards)

    def shard_atoms(nbr: nb.NeighborList) -> ShardedRows:
        ids = torch.arange(mesh.first * per, (mesh.first + mesh.n_local)
                           * per, device=nbr.idx.device)
        live = ids < n_atoms
        return ShardedRows(nbr=nbr, rows=torch.where(live, ids, 0),
                           live=live)

    def forces(x, s2: ShardedRows, s3: ShardedRows, cache2, cache3,
               with_energy):
        rows2, rows3 = s2.rows, s3.rows
        d2 = x[s2.nbr.idx[rows2]] + cache2.sd[rows2] - x[rows2][:, None]
        valid2 = cache2.valid[rows2] * s2.live[:, None].to(x.dtype)
        e2, f2 = pair_row_forces(pot.pair_coefficients, d2, valid2, spec,
                                 spec.n_basis, with_energy)
        d3 = nb.cached_displacements(x, s3.nbr, cache3)
        valid3 = cache3.valid[rows3] * s3.live[:, None].to(x.dtype)
        e3, fc, part = trio.trio_partials(pot, d3[rows3], valid3,
                                          with_energy)
        k3 = part.shape[1]
        payload = torch.cat([part.reshape(-1, 5 * k3), fc + f2, e3[:, None]],
                            dim=1)
        gathered = mesh.all_gather(payload.reshape(mesh.n_local, per, -1))
        gathered = gathered.reshape(mesh.n_shards * per, -1)[:n_atoms]
        part_g = gathered[:, :5 * k3].reshape(n_atoms, k3, 5)
        e3_g, f = trio.assemble_forces(
            gathered[:, -1], gathered[:, 5 * k3:-1], part_g, d3,
            cache3.rev_flat, s3.nbr.mask)
        energy = None
        if with_energy:
            energy = system._e1() + mesh.psum(e2[None]) + torch.sum(e3_g)
        return f, energy

    def chunk(positions, velocities, forces_in, nbr2: ShardedRows,
              nbr3: ShardedRows, dt):
        dt = float(dt)
        cache2 = nb.list_cache(nbr2.nbr, cell, system.dtype)
        cache3 = nb.list_cache(nbr3.nbr, cell, system.dtype)
        x, v, f = positions, velocities, forces_in
        for _ in range(n_steps):
            v = v + 0.5 * dt * f / m
            x = x + dt * v
            f, _ = forces(x, nbr2, nbr3, cache2, cache3, False)
            v = v + 0.5 * dt * f / m
        f, energy = forces(x, nbr2, nbr3, cache2, cache3, True)
        return x, v, f, energy

    return chunk, shard_atoms
