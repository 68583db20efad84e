"""
The port's shard mesh across processes: gloo ranks, each started with
``python -c`` on ``_rank_main`` below, run the halo NVE chunk, the
r-RESPA halo chunk with the virial, the replicated-positions chunk and
``sharded_gram`` on a 4-shard mesh, and each result is held within
1e-12 to the same run in one process (W = 1).  W = 4 gives one shard
per rank; W = 2 gives two per rank, so that each permute sends two
tagged messages to the one peer.  At W = 1 on a gloo group a permute to
oneself is a copy and sends nothing.

The ranks meet through a file store under the test's temporary
directory (no TCP port to collide with the other test workers), each
rank waits at most ``JOIN_TIMEOUT`` seconds, and this file imports no
jax: a rank imports torch, numpy and the port only.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.parallel import halo, mesh

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
N_SHARDS = 4
CAPS = dict(capacity_2b=64, capacity_3b=16)
DT = 1.0 * units.fs
JOIN_TIMEOUT = 120  # seconds a rank may take before the test fails
TOL = 1e-12


def _system(reps, seed, **kw):
    geom = bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(0.05, seed=seed)
    return geom, MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                          **CAPS, **kw)


def _outputs(m: mesh.ShardMesh) -> dict:
    """Every result of the four runs on mesh ``m``: this rank's shards
    of the halo state, the replicated values whole."""
    out = {}
    geom, system = _system((4, 4, 8), 3, n_respa=3, respa_mid=3,
                           rebuild_every=6)
    n = len(geom)
    dec = halo.decompose(geom.get_positions(), geom.get_cell(), N_SHARDS,
                         r_cut_2b=system.r_cut_2b,
                         r_cut_3b=system.r_cut_3b, skin=system.skin,
                         masses=system.masses.numpy(), device="cpu", **CAPS)
    v0 = np.random.RandomState(11).normal(scale=5e-4, size=(n, 3))
    for name, kw in (("nve", dict(n_steps=5)),
                     ("respa", dict(n_steps=6, n_respa=3, respa_mid=3,
                                    with_virial=True))):
        chunk, shard = halo.halo_md_step_factory(system, m, **kw)
        d = shard(dec)
        res = chunk(d, d.x_own, shard(halo.scatter_velocities(dec, v0)), DT)
        for key, value in zip(("x", "v", "f", "energy"), res):
            out[f"{name}_{key}"] = value.numpy()
        if name == "respa":
            out["respa_virial"] = res[4].numpy()
        out[f"{name}_stale"] = np.asarray(bool(res[-1]))
    geom, system = _system(4, 6)
    state = system.init_state(temperature=120.0, seed=1)
    chunk, shard_atoms = mesh.sharded_md_step_factory(system, m, n_steps=5)
    res = chunk(state.positions, state.velocities, state.forces,
                shard_atoms(state.nbr2), shard_atoms(state.nbr3), DT)
    for key, value in zip(("x", "v", "f", "energy"), res):
        out[f"replicated_{key}"] = value.numpy()
    rng = np.random.RandomState(0)
    x, y = rng.rand(103, 17), rng.rand(103)
    gram, ordinate = mesh.sharded_gram(x, y, m)
    out["gram"], out["ordinate"] = gram.numpy(), ordinate.numpy()
    return out


def _rank_main(rank: int, world: int, store: str, out_path: str):
    """One gloo rank: every run of ``_outputs`` on a mesh of
    ``N_SHARDS`` shards over ``world`` ranks, saved to ``out_path``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = _outputs(mesh.make_mesh(N_SHARDS, group=dist.group.WORLD))
        out["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def in_process():
    return _outputs(mesh.make_mesh(N_SHARDS, device="cpu"))


def _spawn(world: int, tmp_path) -> list:
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_distributed as t; "
            "t._rank_main({{}}, {}, {!r}, {{!r}})").format(
                os.path.join(REPO, "tests"), REPO, world, store)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               code.format(r, outs[r])], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
    return [dict(np.load(path)) for path in outs]


@pytest.mark.parametrize("world", [4, 2], ids=["W4_S4", "W2_S4"])
def test_gloo_ranks_match_one_process(world, in_process, tmp_path):
    ranks = _spawn(world, tmp_path)
    for out in ranks:
        assert not out["jax_imported"]
    for key, ref in in_process.items():
        if key.split("_")[0] in ("nve", "respa") \
                and key.split("_")[1] in ("x", "v", "f"):
            # this rank's shards, in rank order: the whole mesh
            got = np.concatenate([out[key] for out in ranks])
        else:
            got = ranks[0][key]
            for out in ranks[1:]:
                assert np.array_equal(out[key], got), key
        assert got.shape == ref.shape, key
        assert np.allclose(got, ref, atol=TOL, rtol=0), key
    assert not in_process["nve_stale"] and not in_process["respa_stale"]


def test_permute_to_oneself_is_a_copy(tmp_path, monkeypatch):
    """W = 1 on a gloo group: a permute rolls the local shards and posts
    no message; the reductions still run through the group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        m = mesh.make_mesh(N_SHARDS, group=dist.group.WORLD)
        assert (m.world, m.n_local, m.backend) == (1, N_SHARDS, "gloo")

        def no_message(*args, **kwargs):
            raise AssertionError("a permute to oneself sent a message")

        monkeypatch.setattr(dist, "batch_isend_irecv", no_message)
        monkeypatch.setattr(dist, "isend", no_message)
        x = torch.arange(N_SHARDS * 6, dtype=torch.float64).reshape(
            N_SHARDS, 2, 3)
        right, left = m.ppermutes([(x, 1), (x, -1)])
        assert torch.equal(right, torch.roll(x, 1, 0))
        assert torch.equal(left, torch.roll(x, -1, 0))
        assert right.data_ptr() != x.data_ptr()
        assert m.traffic["ppermute"] == [6, 6]
        assert float(m.psum(x[:, 0, 0])) == float(x[:, 0, 0].sum())
        assert float(m.pmax(x[:, 1, 2])) == float(x[:, 1, 2].max())
        with pytest.raises(ValueError, match="NCCL"):
            m.psum(torch.zeros((1, 1), device="meta"))
    finally:
        dist.destroy_process_group()
