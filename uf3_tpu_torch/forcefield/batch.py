"""
Batched convenience drivers: evaluate or relax many configurations with
one calculator, surviving per-entry failures; MD checkpoints; and the
extended-xyz trajectory writer of ``MDSystem.run`` / ``npt_run``.

Counterpart of ``uf3_tpu/forcefield/batch.py``.  A checkpoint keeps the
JAX package's npz keys for the arrays (``positions``, ``velocities``,
``forces``, ``energy``, ``xi``, ``cell``) and stores the torch
generator's state under ``key`` and "torch:<device type>" under
``key_impl``, where the JAX package stores its PRNG key and the key's
implementation.
"""

from typing import List, Tuple

import numpy as np
import torch

from uf3_tpu_torch.data import io
from uf3_tpu_torch.data.atoms import Atoms


def batched_energy_and_forces(geometries: List[Atoms],
                              calc) -> Tuple[List[float], List]:
    """Energies and forces for a list of configurations."""
    energies = []
    forces = []
    for geom in geometries:
        energies.append(calc.get_potential_energy(geom))
        forces.append(calc.get_forces(geom))
    return energies, forces


def batch_relax(geometries: List[Atoms],
                calc,
                fmax: float = 0.05,
                max_steps: int = 300,
                names: List[str] = None):
    """
    Relax a batch of configurations; entries that fail are skipped and
    the batch continues (cf. reference lammps.py:183-188).
    """
    relaxed = []
    energies = []
    forces = []
    kept_names = []
    for i, geom in enumerate(geometries):
        try:
            out = calc.relax_fmax(geom, fmax=fmax, steps=max_steps)
            relaxed.append(out)
            energies.append(calc.get_potential_energy(out))
            forces.append(calc.get_forces(out))
            if names is not None:
                kept_names.append(names[i])
        except (ValueError, FloatingPointError, RuntimeError):
            continue
    if names is not None:
        return relaxed, energies, forces, kept_names
    return relaxed, energies, forces


TORCH_KEY = "torch:"  # key_impl prefix of a torch generator's state


def save_md_checkpoint(filename: str, state, system=None) -> None:
    """Write an MD state checkpoint (positions, velocities, forces,
    energy, the noise generator's state, thermostat momentum, cell) as a
    compressed npz."""
    def host(t):
        return t.detach().cpu().numpy()
    np.savez_compressed(
        filename,
        positions=host(state.positions),
        velocities=host(state.velocities),
        forces=host(state.forces),
        energy=host(state.energy),
        key=state.generator.get_state().numpy(),
        key_impl=np.asarray(TORCH_KEY + state.generator.device.type),
        xi=host(state.xi),
        cell=host(state.cell))


def load_md_checkpoint(filename: str, system, seed: int = None):
    """Restore an MDState for ``system`` from a checkpoint: its arrays
    as stored, the lists rebuilt from the stored positions and no
    r-RESPA split forces (the next launch computes them).

    The noise generator continues from its stored state when the
    checkpoint was written by this package on the system's device type.
    A checkpoint of the JAX package (``uf3_tpu.forcefield.batch``)
    stores a JAX PRNG key, which no torch generator can continue, and
    one written on another device type stores another generator's
    state: loading either needs ``seed``, which seeds a new generator
    (the noise then differs from the run that wrote it)."""
    from uf3_tpu_torch.forcefield.md import MDState
    data = np.load(filename)
    key_impl = str(data["key_impl"]) if "key_impl" in data else ""
    generator = torch.Generator(device=system.device)
    if key_impl == TORCH_KEY + system.device.type:
        generator.set_state(torch.from_numpy(data["key"]))
    elif seed is not None:
        generator.manual_seed(seed)
    else:
        raise ValueError(
            f"the checkpoint's noise stream ({key_impl or 'a raw JAX key'}) "
            f"cannot continue as a torch generator on "
            f"{system.device.type}: pass seed= to start a new one")

    def tensor(name):
        return torch.as_tensor(data[name], dtype=system.dtype,
                               device=system.device)
    positions = tensor("positions")
    cell = tensor("cell")
    nbr2, nbr3 = system.build_lists(positions, cell)
    return MDState(positions=positions, velocities=tensor("velocities"),
                   forces=tensor("forces"), energy=tensor("energy"),
                   nbr2=nbr2, nbr3=nbr3, generator=generator,
                   xi=tensor("xi"),
                   stale=torch.zeros((), dtype=torch.bool,
                                     device=system.device),
                   cell=cell)


class TrajectoryWriter:
    """
    Extended-xyz trajectory writer for ``MDSystem.run`` / ``npt_run``
    (``callback=TrajectoryWriter(...)``), the counterpart of the LAMMPS
    ``dump`` command in the reference's MD workflow.

    Writes one frame per fired callback (one per launch: every
    ``rebuild_every`` steps with ``launch_chunks=1``) or per ``every``
    MD steps if given.  Frames carry the cell, per-atom positions and
    forces, the potential energy, and the step count in the comment
    line.
    """

    def __init__(self, filename: str, system, every: int = None,
                 append: bool = False):
        self.filename = filename
        self.system = system
        self.every = every
        self._next = 0 if every else None
        if not append:
            open(filename, "w").close()
        self.frames_written = 0

    def __call__(self, state, steps_done: int) -> None:
        if self.every is not None:
            if steps_done < self._next:
                return
            self._next = steps_done + self.every
        geom = Atoms(
            self.system.atomic_numbers,
            state.positions.detach().double().cpu().numpy(),
            cell=state.cell.detach().double().cpu().numpy(),
            pbc=True)
        f = state.forces.detach().double().cpu().numpy()
        geom.arrays["fx"], geom.arrays["fy"], geom.arrays["fz"] = \
            f[:, 0], f[:, 1], f[:, 2]
        geom.info["energy"] = float(state.energy)
        geom.info["step"] = int(steps_done)
        io.write_xyz(self.filename, [geom], append=True)
        self.frames_written += 1
