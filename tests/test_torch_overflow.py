"""
Twins of the JAX engine's overflow, r-RESPA validation, force-split and
NVE drift tests (tests/test_device_potential.py) on the port's engine
alone, float64 on the CPU.

Overflow: each launch's flag is queued on its way to the host and read
once it has arrived (``run(sync=False)``).  On the CPU a flag has always
arrived, so the tests that need one still in flight, as a busy card
would leave it, hold the queue's readiness check at False.
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import Atoms
from uf3_tpu.forcefield.calculator import UFCalculator
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield import md
from uf3_tpu_torch.forcefield.md import MDSystem

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")


def _w(reps, rattle=None, seed=0):
    geom = bulk("W", "bcc", a=3.1652) * reps
    if rattle:
        geom.rattle(rattle, seed=seed)
    return geom


def _overflowing_state(**kw):
    """A system and a state whose next rebuild overflows: positions
    squeezed 0.78x about their center after init (the JAX tests'
    _overflowing_state)."""
    kw = dict(dict(rebuild_every=1, skin=0.4), **kw)
    port = MDSystem(MODEL, _w(3), dtype=torch.float64, device="cpu", **kw)
    state = port.init_state(temperature=10.0, seed=3)
    center = torch.mean(state.positions, dim=0)
    return port, state._replace(
        positions=center + 0.78 * (state.positions - center))


@pytest.fixture
def in_flight(monkeypatch):
    """Every queued flag reads as not arrived yet."""
    monkeypatch.setattr(md, "_flag_ready", lambda entry: False)


# -- overflow ---------------------------------------------------------------
def test_run_raises_on_overflow():
    """The default synchronous run reads every flag it queued before it
    returns: the call that overflowed raises."""
    port, state = _overflowing_state()
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        port.run(state, n_steps=2, dt_fs=0.1)


def test_run_async_raises_at_next_call(in_flight):
    """sync=False returns with its flags in flight; the next call reads
    them and raises.  ``check_every`` bounds the flags in flight: with
    2, the second launch's poll waits for the first flag."""
    port, state = _overflowing_state()
    out = port.run(state, n_steps=2, dt_fs=0.1, sync=False)
    assert len(port._pending_overflow) == 2
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        port.run(out, n_steps=2, dt_fs=0.1)
    assert not port._pending_overflow
    port, state = _overflowing_state()
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        port.run(state, n_steps=2, dt_fs=0.1, sync=False, check_every=2)


def test_run_async_on_the_cpu_raises_in_the_same_call():
    """Without a card every flag has arrived at the first poll: an
    asynchronous run raises at the latest from the next call, here from
    its own."""
    port, state = _overflowing_state()
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        port.run(state, n_steps=2, dt_fs=0.1, sync=False)


def test_overflowed_is_synchronous(in_flight, recwarn):
    port, state = _overflowing_state()
    out = port.run(state, n_steps=2, dt_fs=0.1, sync=False,
                   on_overflow="warn", check_every=10**6)
    assert not recwarn.list   # no flag read yet
    assert not bool(port._overflow_flag(out))  # reset per launch
    assert port.overflowed(out)
    assert not port._pending_overflow


def test_run_warn_on_overflow():
    port, state = _overflowing_state()
    with pytest.warns(UserWarning, match="capacity exceeded"):
        out = port.run(state, n_steps=2, dt_fs=0.1, on_overflow="warn")
    assert torch.isfinite(out.positions).all()


def test_regrow_consumes_pending_async_flags(in_flight):
    """Flags an asynchronous call left in flight grow the capacities of
    a regrow run, instead of raising."""
    port, state = _overflowing_state()
    out = port.run(state, n_steps=2, dt_fs=0.1, sync=False,
                   on_overflow="warn", check_every=10**6)
    cap0 = port.capacity_2b
    out2 = port.run(out, n_steps=2, dt_fs=0.1, on_overflow="regrow")
    assert port.capacity_2b > cap0
    assert not port.overflowed(out2)


def test_launch_chunks_overflow_sticky(in_flight):
    """An overflow in an early cycle of a launch of four survives the
    launch's later rebuilds and reaches the queue."""
    port, state = _overflowing_state(rebuild_every=2, n_respa=2)
    out = port.run(state, n_steps=8, dt_fs=0.1, launch_chunks=4,
                   sync=False, on_overflow="warn", check_every=10**6)
    assert len(port._pending_overflow) == 1
    assert port.overflowed(out)


# -- r-RESPA validation and force split -------------------------------------
def test_respa3l_validation():
    geom = _w(2)
    with pytest.raises(ValueError, match="multiple of respa_mid"):
        MDSystem(MODEL, geom, device="cpu", n_respa=4, respa_mid=3)
    with pytest.raises(ValueError, match="requires n_respa"):
        MDSystem(MODEL, geom, device="cpu", n_respa=1, respa_mid=2)


def test_inverted_respa_switch_rejected():
    for switch in ((3.5, 3.5), (3.5, 3.0)):
        with pytest.raises(ValueError, match="r_lo < r_hi"):
            MDSystem(MODEL, _w(3), device="cpu", n_respa=2,
                     respa_switch=switch)


def test_respa_coarser_than_rebuild_rejected():
    with pytest.raises(ValueError, match="rebuild_every"):
        MDSystem(MODEL, _w(3), device="cpu", n_respa=4, rebuild_every=2)


def test_respa3l_force_split_exact():
    """Switched short pair + 3-body + pair tail = the full force."""
    port = MDSystem(MODEL, _w(3, 0.04, 13), dtype=torch.float64,
                    device="cpu", n_respa=4, respa_mid=2)
    state = port.init_state()
    f_ps, f_mid, f_tail = port._respa_split_forces_3l(state)
    _, forces, _ = port.energy_forces(state.positions, state.nbr2,
                                      state.nbr3)
    assert torch.max(torch.abs(f_ps + f_mid + f_tail - forces)) < 1e-9
    assert torch.max(torch.abs(f_mid)) > 1e-2


def test_two_tier_skin_forces_stay_exact():
    """Two-tier skins (2-body 1.8 A, 3-body 0.6 A, a refilter every 4
    steps) along a hot NVE trajectory: the forces stay within 5e-9 eV/A
    and the energy within 1e-9 relative of the host oracle at the final
    positions (the fused route's bound, tests/test_torch_models.py), and
    the drift below 2e-4 eV/atom."""
    geom = _w(3)
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    rebuild_every=4, skin=0.6, skin_2b=1.8)
    assert port.two_tier and port._images_2b is not None
    state = port.init_state(temperature=900.0, seed=5)
    e0 = float(state.energy) + port.kinetic_energy(state)
    for _ in range(12):
        state = port.run(state, n_steps=5, dt_fs=2.0)
    assert not port.overflowed(state)
    snapshot = Atoms(numbers=geom.numbers,
                     positions=state.positions.numpy(), cell=geom.cell,
                     pbc=True)
    calc = UFCalculator(ls.WeightedLinearModel.from_json(MODEL))
    assert np.abs(state.forces.numpy() - calc.get_forces(snapshot)).max() \
        < 5e-9
    energy = calc.get_potential_energy(snapshot)
    assert abs(float(state.energy) - energy) < 1e-9 * abs(energy)
    e1 = float(state.energy) + port.kinetic_energy(state)
    assert abs(e1 - e0) / len(geom) < 2e-4


# -- NVE drift -----------------------------------------------------------------
@pytest.mark.parametrize("reps, kw, n_steps, bound", [
    (4, dict(rebuild_every=10), 100, 1e-4),
    (3, dict(rebuild_every=12, n_respa=3), 120, 2e-4),
    (3, dict(rebuild_every=12, n_respa=4, respa_mid=2), 120, 2e-4)],
    ids=["plain", "respa", "respa3l"])
def test_nve_drift(reps, kw, n_steps, bound):
    """Twins of test_nve_energy_conservation, test_respa_nve_drift and
    test_respa3l_nve_drift at their thresholds: 1 fs steps from 600 K."""
    geom = _w(reps)
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu", **kw)
    state = port.init_state(temperature=600.0, seed=1)
    e0 = float(state.energy) + port.kinetic_energy(state)
    state = port.run(state, n_steps=n_steps, dt_fs=1.0)
    e1 = float(state.energy) + port.kinetic_energy(state)
    if "n_respa" not in kw:
        assert not bool(state.stale)
    assert abs(e1 - e0) / len(geom) < bound
