"""
Structure relaxation: FIRE minimizer (host) over atomic positions, with
optional cell relaxation via scaled strain coordinates.

Copy of ``uf3_tpu/forcefield/optimize.py`` (the reference's stand-in
for ASE's BFGSLineSearch, uf3/forcefield/calculator.py:406-436): the
loop runs on the host, each force call on the calculator's device.
"""

import numpy as np

from uf3_tpu_torch.data.atoms import Atoms


def fire_minimize(geom: Atoms,
                  calc,
                  fmax: float = 0.05,
                  max_steps: int = 500,
                  dt_start: float = 0.1,
                  dt_max: float = 1.0,
                  n_min: int = 5,
                  f_inc: float = 1.1,
                  f_dec: float = 0.5,
                  alpha_start: float = 0.1,
                  f_alpha: float = 0.99,
                  verbose: bool = False) -> Atoms:
    """FIRE (Fast Inertial Relaxation Engine) position minimization."""
    geom = geom.copy()
    geom.calc = calc
    velocity = np.zeros((len(geom), 3))
    dt = dt_start
    alpha = alpha_start
    steps_since_negative = 0
    for step in range(max_steps):
        forces = calc.get_forces(geom)
        f_norm = np.max(np.linalg.norm(forces, axis=1))
        if verbose:
            print(f"FIRE step {step}: fmax = {f_norm:.5f}")
        if f_norm < fmax:
            break
        power = np.vdot(forces, velocity)
        if power > 0:
            v_norm = np.linalg.norm(velocity)
            f_unit = forces / max(np.linalg.norm(forces), 1e-30)
            velocity = (1 - alpha) * velocity + alpha * v_norm * f_unit
            steps_since_negative += 1
            if steps_since_negative > n_min:
                dt = min(dt * f_inc, dt_max)
                alpha *= f_alpha
        else:
            velocity[:] = 0.0
            dt *= f_dec
            alpha = alpha_start
            steps_since_negative = 0
        velocity = velocity + dt * forces
        geom.set_positions(geom.get_positions() + dt * velocity)
    return geom


def relax_with_cell(geom: Atoms,
                    calc,
                    fmax: float = 0.05,
                    smax: float = 1e-3,
                    max_steps: int = 200,
                    strain_step: float = 0.2) -> Atoms:
    """Alternate FIRE position relaxation with steepest-descent cell
    relaxation against the stress tensor."""
    geom = geom.copy()
    nsteps = 0
    for _ in range(max_steps):
        nsteps += 1
        geom = fire_minimize(geom, calc, fmax=fmax, max_steps=100)
        stress = calc.get_stress(geom)
        if np.max(np.abs(stress)) < smax:
            break
        full = np.array([[stress[0], stress[5], stress[4]],
                         [stress[5], stress[1], stress[3]],
                         [stress[4], stress[3], stress[2]]])
        strain = np.eye(3) - strain_step * full
        geom.set_cell(geom.get_cell() @ strain.T, scale_atoms=True)
    geom.info["relax_nsteps"] = nsteps
    return geom
