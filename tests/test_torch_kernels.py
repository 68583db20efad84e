"""
The trio CUDA kernel (uf3_tpu_torch/csrc/trio.cu) against its plain
torch twin, on the 3-body rows of a rattled 1,024-atom bcc W box, with
the bench grid and random non-symmetric grids (one with the bench
model's zero pattern, one dense): 1e-10 in float64 (summation order
only), 2e-4 eV/A in float32 against the float64 twin.

The ``cuda`` tests skip without a GPU.  This file imports no jax, so it
also runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import UF3Potential, grid_sparsity

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks_data", "model_2and3.json")


@pytest.fixture(scope="module")
def rows():
    """(potential, 3-body rows d, valid, list cache, 3-body list), f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, rebuild_every=12,
                      skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                      n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5))
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, cache, state.nbr3


def _with_grid(pot: UF3Potential, grid: np.ndarray) -> UF3Potential:
    """A new float64 CPU module of ``pot`` with ``grid``."""
    active_bc, window, symmetric = grid_sparsity(grid)
    bundle = pot.trio._replace(grid=grid, active_bc=active_bc,
                               window=window, symmetric=symmetric)
    return UF3Potential(pot.pair_spec, pot.pair_coefficients.numpy(),
                        bundle, pot.offsets_1b.numpy(),
                        pot.z_to_species.numpy(), pot.r_cut_2b,
                        pot.r_cut_3b)


def _grid(pot: UF3Potential, kind: str) -> UF3Potential:
    grid = pot.trio.grid
    if kind != "bench":
        grid = np.random.RandomState(17).normal(0.0, 0.05, grid.shape)
        if kind == "random_sparse":
            grid = grid * (pot.trio.grid != 0.0)
    out = _with_grid(pot, grid)
    assert out.trio.symmetric == (kind == "bench")
    return out


def _err(a, b) -> float:
    return float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())))


def test_cpu_tensors_take_the_twin(rows):
    pot, d, valid, _, _ = rows
    launches = trio.trio_partials.launches
    out = trio.trio_partials(pot, d, valid)
    ref = trio.trio_partials_torch(d, valid, pot.grid, pot.trio)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert trio.trio_partials.launches == launches
    with pytest.raises(ValueError, match="no trio kernel"):
        trio.trio_partials(pot, d.to("meta"), valid.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the trio kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["bench", "random_sparse", "random_dense"])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 2e-4)])
def test_trio_kernel_matches_twin(rows, cuda_device, grid, dtype, tol):
    pot64, d, valid, cache, nbr = rows
    pot64 = _grid(pot64, grid)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    launches = trio.trio_partials.launches
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy)
        torch.cuda.synchronize()
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy)
        for a, b in zip(kernel, twin):
            assert a.shape == b.shape
            assert _err(a, b) <= tol
        f_k = trio.assemble_forces(*kernel, dk, rev, mask)[1]
        f_t = trio.assemble_forces(*twin, d, cache.rev_flat, nbr.mask)[1]
        assert _err(f_k, f_t) <= tol
        assert float(torch.abs(f_t).max()) > 1e-2
    assert trio.trio_partials.launches == launches + 2


@pytest.mark.cuda
def test_trio_kernel_rejects_bad_operands(rows, cuda_device):
    pot64, d, valid, _, _ = rows
    pot = _grid(pot64, "bench").to(device=cuda_device, dtype=torch.float32)
    dk, vk = d.to(cuda_device), valid.to(cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        trio.trio_partials(pot, dk, vk)  # float64 rows, float32 grid
    wide = torch.zeros((4, 33, 3), device=cuda_device)
    with pytest.raises(ValueError, match="at most 1024"):
        trio.trio_partials(pot, wide, torch.zeros((4, 33),
                                                  device=cuda_device))
