"""The plain reference against finite differences of its own energy, on
a 2-body and a 2+3-body model at 128 atoms, and against the program in
float64 (a second witness); the TF32 control stays well away from the
float64 reference."""

import numpy as np
import pytest
import torch

from mdbench import harness, reference

CONFIGS = ["uf3-W-2b", "uf3-W-2b3b"]


def rattled(seed=5, reps=(4, 4, 4), amount=0.08):
    spec = dict(structure="bcc", a=3.1652, Z=74, reps=list(reps))
    numbers, x, cell = harness.lattice(spec)
    x = x + np.random.RandomState(seed).normal(scale=amount, size=x.shape)
    return (numbers, torch.tensor(x, dtype=torch.float64),
            torch.tensor(cell, dtype=torch.float64))


@pytest.mark.parametrize("name", CONFIGS)
def test_forces_are_minus_the_energy_gradient(name):
    model = reference.load(harness.config_path(name))
    _, x, cell = rattled()
    _, forces, _ = reference.energy_forces(model, x, cell)
    h = 1e-5
    for atom, axis in [(0, 0), (17, 1), (63, 2), (100, 0), (127, 2)]:
        xp, xm = x.clone(), x.clone()
        xp[atom, axis] += h
        xm[atom, axis] -= h
        ep = reference.energy_forces(model, xp, cell)[0]
        em = reference.energy_forces(model, xm, cell)[0]
        assert -(ep - em) / (2 * h) == pytest.approx(
            float(forces[atom, axis]), abs=2e-7)


@pytest.mark.parametrize("name", CONFIGS)
def test_virial_is_the_strain_derivative(name):
    """W_aa = dE / d(strain_aa) under a strain of positions and cell
    (the search takes orthorhombic cells: diagonal strains only)."""
    model = reference.load(harness.config_path(name))
    _, x, cell = rattled(seed=6)
    _, _, virial = reference.energy_forces(model, x, cell, virial=True)
    h = 1e-6
    for a in range(3):
        strain = torch.eye(3, dtype=torch.float64)
        strain[a, a] += h
        ep = reference.energy_forces(model, x @ strain, cell @ strain)[0]
        strain[a, a] -= 2 * h
        em = reference.energy_forces(model, x @ strain, cell @ strain)[0]
        assert (ep - em) / (2 * h) == pytest.approx(float(virial[a, a]),
                                                    rel=1e-6, abs=1e-6)
    assert torch.allclose(virial, virial.T, atol=1e-9)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_program_in_float64(name):
    from uf3_tpu_torch.data.atoms import Atoms
    from uf3_tpu_torch.forcefield.md import MDSystem
    numbers, x, cell = rattled(seed=7)
    system = MDSystem(harness.config_path(name),
                      Atoms(numbers, x.numpy(), cell.numpy()),
                      dtype=torch.float64, device="cpu")
    state = system.init_state()
    e, f, v = system.energy_forces(state.positions, state.nbr2, state.nbr3,
                                   with_virial=True)
    model = reference.load(harness.config_path(name))
    er, fr, vr = reference.energy_forces(model, state.positions, state.cell,
                                         virial=True)
    assert abs(float(e) - er) < 1e-9 * abs(er)
    assert float(torch.max(torch.abs(f - fr))) < 1e-10
    assert float(torch.max(torch.abs(v - vr))) < 1e-8


def test_cell_list_finds_every_pair():
    """The cell list (bins 5.5 A wide in a 22 A box) against all pairs
    over the 27 nearest images, in numpy."""
    _, x, cell = rattled(seed=8, reps=(7, 7, 7), amount=0.2)
    x = x + 3.0        # some atoms outside the primary cell
    i, j, s = reference.neighbor_pairs(x, cell, 5.5)
    got = set(zip(i.tolist(), j.tolist(), map(tuple, s.tolist())))
    xn, box = x.numpy(), np.diag(cell.numpy())
    want = set()
    for img in np.ndindex(3, 3, 3):
        shift = np.asarray(img) - 1
        d = xn[None, :, :] + shift * box - xn[:, None, :]
        r = np.linalg.norm(d, axis=-1)
        for a, b in zip(*np.nonzero(r < 5.5)):
            if a != b or shift.any():
                want.add((int(a), int(b), tuple(int(v) for v in shift)))
    assert got == want


def test_small_cells_search_all_images():
    """A box under three cutoffs wide takes the all-pairs search: a
    128-atom cell against the cell list of the same crystal doubled."""
    _, x, cell = rattled(seed=10)
    n = len(x)
    i, j, s = reference.neighbor_pairs(x, cell, 5.5)
    counts = torch.bincount(i, minlength=n)
    big = torch.cat([x + torch.tensor(o, dtype=x.dtype) * torch.diagonal(
        cell) for o in np.ndindex(2, 2, 2)])
    ib, _, _ = reference.neighbor_pairs(big, cell * 2, 5.5)
    assert torch.equal(torch.bincount(ib, minlength=8 * n)[:n], counts)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 3.0,
                      -1.0 - 2 ** -11 - 2 ** -13], dtype=torch.float32)
    y = reference.tf32(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0,
                          -1.0 - 2 ** -10]


@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_far_from_the_float64_reference(name):
    model = reference.load(harness.config_path(name))
    _, x, cell = rattled(seed=9)
    e, f, _ = reference.energy_forces(model, x, cell)
    e32, f32, _ = reference.energy_forces(model, x.float(), cell,
                                          precision="tf32")
    assert float(torch.max(torch.abs(f32.double() - f))) > 1e-3
    assert abs(e32 - e) / len(x) > 3e-6
