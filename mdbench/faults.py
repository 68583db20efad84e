"""
Faults planted underneath the program, to show that the check that
decides ``correct`` catches them: the CPU tests plant each at a tiny
size, ``calibrate.py --faults`` at the cell's own size on the card.

``hook(name, patches, workload)`` returns the ``program_hook`` that
``harness.drive`` calls with the built system.  ``patches`` sets
attributes and takes them back (pytest's ``monkeypatch``, or
``Patches`` here): a fault may replace the system's methods or the
force functions of the program's MD module.

- ``unchanged_step``: every step returns its state unchanged;
- ``half_left_out``: every force function returns half the atoms'
  forces as zero and their energies as the mean of the rest;
- ``answer_altered``: one force component altered where every force
  function produces it, by four times the cell's force limit;
- ``pair_dropped``: one pair left out of every 2-body list built;
- ``no_energy_altered``: the same alteration, in the instances that
  skip the energy only: those the window's steps run;
- ``half_kick_dropped``: the second velocity half-kick of each force
  taken back before the thermostat (plain Verlet: the step's; r-RESPA:
  the inner pair, mid trio and outer tail forces' alike).
"""

import inspect

import torch

FORCE_FUNCTIONS = ("compute_energy_forces", "pair_trio_forces_shared",
                   "pair_short_forces", "trio_forces", "pair_tail_forces",
                   "trio_short_forces")
NAMES = ("unchanged_step", "half_left_out", "answer_altered",
         "pair_dropped", "no_energy_altered", "half_kick_dropped")


class Patches:
    """``setattr`` that ``undo`` takes back, in the reverse order."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def _md():
    from uf3_tpu_torch.forcefield import md
    return md


def _with_energy(fn, args, kw) -> bool:
    """Whether this call of ``fn`` computes the energy (a function
    without the switch always does)."""
    signature = inspect.signature(fn)
    if "with_energy" not in signature.parameters:
        return True
    bound = signature.bind(*args, **kw)
    bound.apply_defaults()
    return bool(bound.arguments["with_energy"])


def _edit_outputs(fn, change, only_without_energy=False):
    """``fn`` with ``change`` applied to every tensor it returns (or,
    with ``only_without_energy``, only where it skips the energy)."""
    def broken(*args, **kw):
        out = fn(*args, **kw)
        if only_without_energy and _with_energy(fn, args, kw):
            return out
        return tuple(change(t) if torch.is_tensor(t) else t for t in out)
    return broken


def _half_left_out(t):
    if t.dim() == 0:
        return t
    n = t.shape[0]
    if t.dim() == 2 and t.shape[1] == 3 and n > 3:
        t = t.clone()
        t[n // 2:] = 0.0
    elif t.dim() == 1 and n > 3:
        t = t.clone()
        t[n // 2:] = torch.mean(t[:n // 2])
    return t


def _altered(amount):
    def change(t):
        if t.dim() == 2 and t.shape[1] == 3 and t.shape[0] > 3:
            t = t.clone()
            t[5, 1] += amount
        return t
    return change


def _break_force_functions(patches, change, only_without_energy=False):
    md = _md()
    for name in FORCE_FUNCTIONS:
        patches.setattr(md, name, _edit_outputs(
            getattr(md, name), change, only_without_energy))


def hook(name: str, patches, workload: dict):
    """The ``program_hook`` that plants fault ``name``."""
    amount = 4.0 * workload["limits"]["force_max_err_eV_A"]

    def plant(system):
        if name == "unchanged_step":
            patches.setattr(system, "_verlet_step", (
                lambda state, dt, thermostat, with_energy, cache2, cache3,
                scr=None, temperature=0.0, scale=None: (state, scale)))
            patches.setattr(system, "_respa_cycle_3l",
                            lambda state, *args, **kw: state)
            patches.setattr(system, "_respa_cycle",
                            lambda state, *args, **kw: state)
        elif name == "half_left_out":
            _break_force_functions(patches, _half_left_out)
        elif name == "answer_altered":
            _break_force_functions(patches, _altered(amount))
        elif name == "pair_dropped":
            build = system.build_lists

            def dropped(positions, cell=None):
                nbr2, nbr3 = build(positions, cell)
                mask = nbr2.mask.clone()
                mask[0, torch.nonzero(mask[0])[0]] = False
                return nbr2._replace(mask=mask), nbr3
            patches.setattr(system, "build_lists", dropped)
        elif name == "no_energy_altered":
            _break_force_functions(patches, _altered(amount), True)
            patches.setattr(system, "energy_forces", _edit_outputs(
                system.energy_forces, _altered(amount), True))
        elif name == "half_kick_dropped":
            _drop_half_kick(system, patches)
        else:
            raise ValueError(f"no fault {name!r}")
    return plant


def _drop_half_kick(system, patches):
    """Keep the forces of each evaluation that a half-kick follows (the
    Verlet step's ``energy_forces``; r-RESPA's inner pair, mid trio and
    outer tail forces of the steps, each with its own time step) and
    take those half-kicks back from the velocities that next reach the
    thermostat."""
    md = _md()
    pending = {}

    def keeping(fn, key, factor, always=False):
        def kept(*args, **kw):
            out = fn(*args, **kw)
            if always or not _with_energy(fn, args, kw):
                pending[key] = (out[1], factor)
            return out
        return kept
    patches.setattr(system, "energy_forces",
                    keeping(system.energy_forces, "step", 1, always=True))
    for name, factor in (("pair_short_forces", 1),
                         ("trio_forces", system.respa_mid),
                         ("pair_tail_forces", system.n_respa)):
        patches.setattr(md, name, keeping(getattr(md, name), name, factor))
    make = system._thermostat_fn
    inv_m = 1.0 / system.masses[:, None]

    def thermostat_fn(thermostat, dt, *args, **kw):
        step = make(thermostat, dt, *args, **kw)

        def without_half_kicks(v, generator, xi):
            for f, factor in pending.values():
                v = v - 0.5 * dt * factor * f * inv_m
            pending.clear()
            return step(v, generator, xi)
        return without_half_kicks
    patches.setattr(system, "_thermostat_fn", thermostat_fn)
