"""
The trio CUDA kernel (uf3_tpu_torch/csrc/trio.cu) against its plain
torch twin, on the 3-body rows of a rattled 1,024-atom bcc W box, with
the bench grid and random non-symmetric grids (one with the bench
model's zero pattern, one dense), the unary test model's wider window,
K = 8 and 32 slots, a ragged atom count, sparse and non-prefix slot
masks and non-linear knot kinds: 1e-10 in float64 (summation order
only), 2e-4 eV/A in float32 against the float64 twin.  The 3-body virial
from the kernel's partials, on the bench lists (16 slots) and the
melting protocol's (20 slots): 1e-9 relative in float64, 1e-5 eV/A^3
per stress component in float32.

The species-gated instance of the kernel (one ordered trio type of a
multi-species model per launch) against its plain version
``trio_multi_partials_torch``, per type and summed over the types, on
the random Ne/Xe 2+3-body model at K = 16 and 32 slots: the same
tolerances; and a type window too wide for shared memory raises.

The ``cuda`` tests skip without a GPU.  This file imports no jax, so it
also runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import copy
import os

import numpy as np
import pytest
import torch

from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import multi
from uf3_tpu_torch.ops import neighbors as nb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import UF3Potential, grid_sparsity
from uf3_tpu_torch.ops.splines import leg_spec_from_knots
from uf3_tpu_torch.representation import knots as kn

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
UNARY = os.path.join(REPO, "tests", "data", "model_unary.json")
TOLS = [(torch.float64, 1e-10), (torch.float32, 2e-4)]


@pytest.fixture(scope="module")
def rows():
    """(potential, 3-body rows d, valid, list cache, 3-body list), f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, rebuild_every=12,
                      skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                      n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5),
                      device="cpu")
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, cache, state.nbr3


def _with_grid(pot: UF3Potential, grid: np.ndarray,
               **specs) -> UF3Potential:
    """A new float64 CPU module of ``pot`` with ``grid`` (and the leg
    specs ``spec_l`` / ``spec_n`` where given)."""
    active_bc, window, symmetric = grid_sparsity(grid)
    bundle = pot.trio._replace(grid=grid, active_bc=active_bc,
                               window=window, symmetric=symmetric, **specs)
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


@pytest.fixture(scope="module")
def rows_one_tier():
    """(potential, d, valid) of the 3-body rows of the engine's default
    one-tier list (23 slots) on the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu")
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid


def test_one_tier_default_list_has_23_slots(rows_one_tier):
    _, d, valid = rows_one_tier
    assert d.shape[1] == 23
    assert int(valid.sum(1).max()) <= 23 and int(valid.sum(1).min()) >= 12


# the melting protocol's engine settings (benchmarks/melting_run.py:105)
PROTOCOL = dict(rebuild_every=16, skin=0.6, skin_2b=1.2, capacity_2b=88,
                capacity_3b=20)


@pytest.fixture(scope="module")
def rows_protocol():
    """(potential, d, valid, volume) of the 3-body rows of the melting
    protocol's list (20 slots) on the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                      **PROTOCOL)
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, geom.get_volume()


def test_protocol_list_has_20_slots(rows_protocol):
    _, d, valid, _ = rows_protocol
    assert d.shape[1] == 20
    assert int(valid.sum(1).max()) <= 20 and int(valid.sum(1).min()) >= 12


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
    with pytest.raises(ValueError, match="K <= 32"):
        trio.trio_partials(pot, wide, torch.zeros((4, 33),
                                                  device=cuda_device))


def _matches_twin(pot64: UF3Potential, d, valid, device, dtype, tol):
    """Kernel partials on ``device`` in ``dtype`` against the float64
    twin, with and without energy."""
    pot = _with_grid(pot64, pot64.trio.grid).to(device=device, dtype=dtype)
    dk, vk = d.to(device, dtype), valid.to(device, dtype)
    for with_energy in (True, False):
        kernel = trio.trio_partials(pot, dk, vk, with_energy)
        torch.cuda.synchronize()
        twin = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                        with_energy)
        for a, b in zip(kernel, twin):
            assert a.shape == b.shape
            assert _err(a, b) <= tol
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_slot_counts(rows, cuda_device, k, dtype, tol):
    pot64, d, valid, _, _ = rows
    if k < d.shape[1]:
        d, valid = d[:, :k].contiguous(), valid[:, :k].contiguous()
    else:  # 16 more live slots: the rows' first 16, stretched by 10 %
        d = torch.cat([d, 1.1 * d[:, :k - d.shape[1]]], 1)
        valid = torch.cat([valid, valid[:, :k - valid.shape[1]]], 1)
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert float(torch.abs(twin[2]).max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_ragged_atom_count(rows, cuda_device, dtype, tol):
    pot64, d, valid, _, _ = rows
    n = 1021  # not a multiple of the kernel's atoms per block
    _matches_twin(pot64, d[:n], valid[:n], cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_sparse_masks(rows, cuda_device, dtype, tol):
    pot64, d, valid, _, _ = rows
    valid = valid.clone()
    valid[0] = 0                           # no valid slot
    valid[1] = 0
    valid[1, 5] = 1                        # one
    valid[2] = 0
    valid[2, [3, 11]] = 1                  # two, not a prefix
    rng = np.random.RandomState(5)
    valid[3:] *= torch.as_tensor(rng.rand(valid.shape[0] - 3,
                                          valid.shape[1]) > 0.3)
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert float(torch.abs(twin[2][:2]).max()) == 0.0  # no pair lane


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_unary_model_window(rows, cuda_device, dtype, tol):
    _, d, valid, _, _ = rows
    pot64 = UF3Potential.from_json(UNARY)
    w_lo, w_hi, c_lo, c_hi = pot64.trio.window
    assert (w_hi - w_lo, c_hi - c_lo) == (5, 12)
    _matches_twin(pot64, d, valid, cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["lammps", "geometric", "inverse"])
def test_trio_kernel_nonlinear_leg_kinds(rows, cuda_device, strategy):
    pot64, d, valid, _, _ = rows
    spacer = kn.get_knot_spacer(strategy)
    spec_l = leg_spec_from_knots(spacer(1.5, 3.5, 6))[1]
    spec_n = leg_spec_from_knots(spacer(1.5, 7.0, 12))[1]
    assert spec_l.n_basis == pot64.trio.l_basis
    assert spec_n.n_basis == pot64.trio.n_basis
    pot64 = _with_grid(pot64, pot64.trio.grid, spec_l=spec_l,
                       spec_n=spec_n)
    for dtype, tol in TOLS:
        _matches_twin(pot64, d, valid, cuda_device, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_one_tier_23_slots(rows_one_tier, cuda_device, dtype,
                                       tol):
    pot64, d, valid = rows_one_tier
    launches = trio.trio_partials.launches
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    assert trio.trio_partials.launches == launches + 2
    assert float(torch.abs(twin[2]).max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kw, n_steps", [({}, 1),
                                         (dict(n_respa=2, rebuild_every=2),
                                          2)],
                         ids=["plain_verlet_step", "respa2_outer_step"])
def test_md_step_on_the_card_matches_cpu(cuda_device, kw, n_steps):
    """One plain velocity-Verlet step (the minimum-image builder, the
    shared gather) and one 2-level outer step of two inner steps
    (trio_short_forces, the pair tail) on the 128-atom cell: the card
    against the CPU from the same inputs, float64."""
    geom = bulk("W", "bcc", a=3.1652) * 4
    geom.rattle(0.05, seed=3)
    v0 = np.random.RandomState(0).normal(0.0, 4e-3, (len(geom), 3))
    out = []
    for device in ("cpu", cuda_device):
        system = MDSystem(MODEL, geom, dtype=torch.float64, device=device,
                          **kw)
        launches = trio.trio_partials.launches
        state = system.run(system.init_state(velocities=v0),
                           n_steps=n_steps, dt_fs=2.0)
        if device != "cpu":
            assert trio.trio_partials.launches > launches
        out.append(state)
    cpu, card = out
    for name in ("positions", "velocities", "forces", "energy"):
        assert _err(getattr(cpu, name), getattr(card, name)) <= 1e-10
    assert float(torch.abs(cpu.forces).max()) > 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 20])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trio_virial_from_kernel_partials(rows, rows_protocol, cuda_device,
                                          k, dtype):
    """The 3-body virial from the kernel's slot partials against the
    twin's (``trio_virial6``, bench grid): 1e-9 relative in float64;
    in float32 each Voigt stress component within 1e-5 eV/A^3 of the
    float64 twin's."""
    if k == 16:
        pot64, d, valid, _, _ = rows
        volume = (8 * 3.1652) ** 3
    else:
        pot64, d, valid, volume = rows_protocol
    assert d.shape[1] == k
    _, _, part = trio.trio_partials_torch(d, valid, pot64.grid, pot64.trio,
                                          False)
    v_twin = trio.trio_virial6(part, d, valid)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    launches = trio.trio_partials.launches
    _, _, part_k = trio.trio_partials(pot, dk, vk, False)
    v_kernel = trio.trio_virial6(part_k, dk, vk).double().cpu()
    assert trio.trio_partials.launches == launches + 1
    assert float(torch.abs(v_twin).max()) > 1.0
    if dtype == torch.float64:
        assert _err(v_kernel, v_twin) <= 1e-9 * float(
            torch.abs(v_twin).max())
    else:
        assert _err(v_kernel / volume, v_twin / volume) <= 1e-5


def long_trio_model():
    """A unary W model whose 3-body cutoff (4 A) passes its 2-body
    cutoff (3 A): the engine builds its 3-body list on its own and runs
    the trio kernel on it (the separate route)."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(
        ChemicalSystem(["W"], degree=3), r_min_map={("W", "W"): 1.5},
        r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [4.0, 4.0, 8.0]},
        resolution_map={("W", "W"): 8, ("W", "W", "W"): [6, 6, 12]})
    return io.FittedModel(basis, np.random.RandomState(0).normal(
        scale=0.05, size=sum(basis.partition_sizes)))


@pytest.fixture(scope="module")
def rows_separate():
    """(potential, d, valid, list cache, 3-body list) of the separately
    built 32-slot 3-body list of the same box, f64."""
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=11)
    system = MDSystem(long_trio_model(), geom, dtype=torch.float64,
                      device="cpu", capacity_3b=32)
    state = system.init_state()
    cache = nb.list_cache(state.nbr3, system.cell, torch.float64)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return system.potential, d, cache.valid, cache, state.nbr3


def test_separate_list_has_32_slots_and_reverse_slots(rows_separate):
    _, d, valid, _, nbr = rows_separate
    assert d.shape[1] == 32 and nbr.sel is None
    assert int(valid.sum(1).max()) <= 32 and int(valid.sum(1).min()) >= 14
    idx, rev, mask = nbr.idx.numpy(), nbr.rev.numpy(), nbr.mask.numpy()
    a, s = np.nonzero(mask)
    assert np.array_equal(idx[idx[a, s], rev[a, s]], a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_trio_kernel_on_a_separately_built_list(rows_separate, cuda_device,
                                                dtype, tol):
    """The KMAX = 32 instance on a list that did not come from the
    filter, its reverse slots from the builder: partials and assembled
    forces against the twin's."""
    pot64, d, valid, cache, nbr = rows_separate
    twin = _matches_twin(pot64, d, valid, cuda_device, dtype, tol)
    pot = _with_grid(pot64, pot64.trio.grid).to(device=cuda_device,
                                                dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    out = trio.trio_partials(pot, dk, vk, False)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    f_kernel = trio.assemble_forces(*out, dk, rev, mask)[1]
    f_twin = trio.assemble_forces(*twin, d, cache.rev_flat, nbr.mask)[1]
    assert _err(f_kernel, f_twin) <= tol
    assert float(torch.abs(f_twin).max()) > 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["separate_3body", "model_2", "binary"])
def test_factorized_and_separate_steps_on_the_card_match_cpu(cuda_device,
                                                             model):
    """Two plain velocity-Verlet steps on the card against the CPU,
    float64: the separate route (trio kernel) of the model whose 3-body
    cutoff passes its 2-body cutoff, and the factorized path of the
    2-body W and the binary Ne/Xe model files."""
    if model == "binary":
        from uf3_tpu_torch.data.atoms import Atoms
        base = bulk("Ne", "fcc", a=5.4) * 3
        numbers = base.get_atomic_numbers()
        numbers[np.random.RandomState(3).rand(len(numbers)) > 0.5] = 54
        geom = Atoms(numbers, base.get_positions(), base.get_cell(),
                     pbc=True)
        source = os.path.join(REPO, "tests", "data", "model_binary.json")
    else:
        geom = bulk("W", "bcc", a=3.1652) * 4
        source = long_trio_model() if model == "separate_3body" \
            else os.path.join(REPO, "benchmarks_data", "model_2.json")
    geom.rattle(0.05, seed=3)
    v0 = np.random.RandomState(0).normal(0.0, 4e-3, (len(geom), 3))
    out = []
    for device in ("cpu", cuda_device):
        system = MDSystem(source, geom, dtype=torch.float64, device=device,
                          capacity_3b=32)
        launches = trio.trio_partials.launches
        state = system.run(system.init_state(velocities=v0), n_steps=2,
                           dt_fs=2.0)
        if device != "cpu":
            assert (trio.trio_partials.launches > launches) \
                == (model == "separate_3body")
        out.append(state)
    cpu, card = out
    for name in ("positions", "velocities", "forces", "energy"):
        assert _err(getattr(cpu, name), getattr(card, name)) <= 1e-10
    assert float(torch.abs(cpu.forces).max()) > 1e-2


# -- the species-gated instance (the fused multi-species route) ---------------
def binary23_model():
    """Ne/Xe 2+3-body, r 1.0-5.0 A, resolution 8, coefficients from
    RandomState(11) at scale 0.05 (the model of the JAX package's
    test_multi_fused_matches_factorized)."""
    from uf3_tpu_torch import io
    from uf3_tpu_torch.data.composition import ChemicalSystem
    from uf3_tpu_torch.representation.basis import BSplineBasis
    basis = BSplineBasis(ChemicalSystem(["Ne", "Xe"], degree=3),
                         r_min_map=1.0, r_max_map=5.0, resolution_map=8)
    return io.FittedModel(basis, np.random.RandomState(11).normal(
        scale=0.05, size=sum(basis.partition_sizes)))


@pytest.fixture(scope="module", params=[16, 32], ids=["K16", "K32"])
def rows_multi(request):
    """(potential, d, valid, s_slot, species, list cache, 3-body list)
    of the 3-body rows of fcc Ne/Xe (half Xe by a seeded draw, 256 or
    500 atoms, rattled 0.08 A) on the multi-species route, f64: a = 5.8
    A keeps 12-16 neighbors in 16 slots, a = 5.4 A 18 in 32."""
    from uf3_tpu_torch.data.atoms import Atoms
    k = request.param
    a, reps = (5.8, 4) if k == 16 else (5.4, 5)
    base = bulk("Ne", "fcc", a=a) * reps
    numbers = base.get_atomic_numbers()
    numbers[np.random.RandomState(3).rand(len(numbers)) > 0.5] = 54
    geom = Atoms(numbers, base.get_positions(), base.get_cell(), pbc=True)
    geom.rattle(0.08, seed=1)
    system = MDSystem(binary23_model(), geom, dtype=torch.float64,
                      device="cpu", capacity_3b=k)
    state = system.init_state()
    assert not system.overflowed(state)
    _, cache = system.list_caches(state.nbr2, state.nbr3, system.cell)
    d = nb.cached_displacements(state.positions, state.nbr3, cache)
    return (system.potential, d, cache.valid, cache.s_slot, system.species,
            cache, state.nbr3)


def test_multi_rows_cover_both_instances(rows_multi):
    """K = 16 and 32 (the two KMAX instances); each type's center
    species is absent from some rows, and each type has live rows."""
    pot, d, valid, s_slot, species, _, _ = rows_multi
    assert d.shape[1] in (16, 32)
    assert len(pot.trio_multi.descs) == 8 and pot.trio_multi_mirrored
    for desc in pot.trio_multi.descs:
        rows = species == desc.s_c
        assert 0 < int(rows.sum()) < len(species)
        assert bool(((s_slot == desc.s_m) & (valid != 0))[rows].any())


def test_cpu_tensors_take_the_gated_twin(rows_multi):
    """On the CPU the multi-species pass is the plain version, and the
    kernel's wrapper raises rather than fall back."""
    pot, d, valid, s_slot, species, _, _ = rows_multi
    launches = trio.trio_partials_gated.launches
    out = multi.trio_multi_partials(pot, 0, d, valid, s_slot, species)
    ref = multi.trio_multi_partials_torch(d, valid, s_slot, species,
                                          pot.trio_types[0].grid,
                                          pot.trio_multi.descs[0])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert trio.trio_partials_gated.launches == launches
    t0 = pot.trio_types[0]
    with pytest.raises(ValueError, match="no trio kernel"):
        trio.trio_partials_gated(t0.grid_window, t0.leg_tables,
                                 pot.trio_multi.descs[0], d, valid, s_slot,
                                 species, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", TOLS)
def test_gated_kernel_matches_twin(rows_multi, cuda_device, dtype, tol):
    """Per ordered type (energy, center force, partials) and summed
    over the 8 types (with the assembled forces): the kernel against
    trio_multi_partials_torch, with and without energy."""
    pot64, d, valid, s_slot, species, cache, nbr = rows_multi
    pot = copy.deepcopy(pot64).to(device=cuda_device, dtype=dtype)
    dk, vk = d.to(cuda_device, dtype), valid.to(cuda_device, dtype)
    sk, ck = s_slot.to(cuda_device), species.to(cuda_device)
    rev, mask = cache.rev_flat.to(cuda_device), nbr.mask.to(cuda_device)
    descs = pot64.trio_multi.descs
    launches = trio.trio_partials_gated.launches
    for with_energy in (True, False):
        total_k = total_t = None
        for t, desc in enumerate(descs):
            kernel = multi.trio_multi_partials(pot, t, dk, vk, sk, ck,
                                               with_energy)
            torch.cuda.synchronize()
            twin = multi.trio_multi_partials_torch(
                d, valid, s_slot, species, pot64.trio_types[t].grid, desc,
                with_energy)
            for a, b in zip(kernel, twin):
                assert a.shape == b.shape
                assert _err(a, b) <= tol
            total_k = kernel if total_k is None \
                else [a + b for a, b in zip(total_k, kernel)]
            total_t = twin if total_t is None \
                else [a + b for a, b in zip(total_t, twin)]
        f_k = trio.assemble_forces(*total_k, dk, rev, mask)[1]
        f_t = trio.assemble_forces(*total_t, d, cache.rev_flat, nbr.mask)[1]
        assert _err(f_k, f_t) <= tol
        assert float(torch.abs(f_t).max()) > 1e-2
        if dtype == torch.float64:
            v_k = trio.trio_virial6(total_k[2], dk, vk).cpu()
            v_t = trio.trio_virial6(total_t[2], d, valid)
            assert _err(v_k, v_t) <= 1e-9 * float(torch.abs(v_t).max())
    assert trio.trio_partials_gated.launches == launches + 2 * len(descs)


@pytest.mark.cuda
def test_gated_kernel_accumulates_and_rejects_bad_operands(rows_multi,
                                                           cuda_device):
    """The instance adds into its outputs (two launches of one type give
    twice one launch's partials); float64 rows with a float32 table,
    int32 species ids and a window too wide for shared memory raise."""
    pot64, d, valid, s_slot, species, _, _ = rows_multi
    pot = copy.deepcopy(pot64).to(device=cuda_device)
    dk, vk = d.to(cuda_device), valid.to(cuda_device)
    sk, ck = s_slot.to(cuda_device), species.to(cuda_device)
    once = multi.trio_multi_partials(pot, 1, dk, vk, sk, ck)
    twice = multi.trio_multi_partials(pot, 1, dk, vk, sk, ck)
    multi.trio_multi_partials(pot, 1, dk, vk, sk, ck, out=twice)
    torch.cuda.synchronize()
    for a, b in zip(once, twice):
        assert _err(2.0 * a, b) <= 1e-12 * max(1.0, float(a.abs().max()))
    t1, desc = pot.trio_types[1], pot64.trio_multi.descs[1]
    with pytest.raises(TypeError, match="float32 or float64"):
        trio.trio_partials_gated(t1.grid_window.float(), t1.leg_tables, desc,
                                 dk, vk, sk, ck, once)
    with pytest.raises(TypeError, match="int64"):
        trio.trio_partials_gated(t1.grid_window, t1.leg_tables, desc, dk, vk,
                                 sk.int(), ck, once)
    spec = leg_spec_from_knots(kn.generate_uniform_knots(0.5, 6.0, 40))[1]
    wide = desc._replace(spec_l1=spec, spec_l2=spec, spec_n=spec,
                         window=(0, 43, 0, 43, 0, 43))
    with pytest.raises(ValueError, match="exceeds the 227 KB"):
        trio.trio_gated_occupancy(wide, d.shape[1], True)
    with pytest.raises(ValueError, match="exceeds the 227 KB"):
        trio.trio_partials_gated(
            torch.zeros((43, 43, 43), dtype=torch.float64,
                        device=cuda_device),
            torch.zeros((120, 20), dtype=torch.float64, device=cuda_device),
            wide, dk, vk, sk, ck, once)
