"""
Phonon spectra via the finite-displacement (frozen-phonon) method.

Standalone equivalent of the reference's phonopy wrapper
(uf3/forcefield/properties/phonon.py:25-167): build a supercell,
displace the symmetry-irreducible (atom, direction) set, collect
forces, assemble the force-constant matrix, and diagonalize the
dynamical matrix along a high-symmetry q-path.  Where the reference
gets displacement reduction from phonopy and band paths from seekpath,
this module derives both itself: space-group operations from
uf3_tpu_torch.data.symmetry, and standard Setyawan-Curtarolo paths for
the common lattices (cubic conventional, primitive fcc/bcc, hexagonal).

Copy of ``uf3_tpu/forcefield/properties/phonon.py``: the displaced
supercells' forces come from the calculator it is given (the port's
``UFCalculator`` on the card); matplotlib is imported only to plot.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from uf3_tpu_torch.data.atoms import Atoms
from uf3_tpu_torch.data import symmetry as sym


def _solve_rows(dirs: np.ndarray, responses: np.ndarray) -> np.ndarray:
    """phi rows for one atom from displacement directions (K, 3) and
    response matrices (K, n_total, 3): least-squares solve of
    dirs @ phi_flat = responses (exact when rank(dirs) == 3)."""
    k, n_total, _ = responses.shape
    flat = responses.reshape(k, -1)
    phi_flat, *_ = np.linalg.lstsq(dirs, flat, rcond=None)
    return phi_flat.reshape(3, n_total, 3)


def force_constants(atoms: Atoms,
                    calc,
                    n_super: int = 3,
                    disp: float = 0.01,
                    symmetry: bool = True,
                    tol: float = 1e-5) -> Tuple[np.ndarray, Atoms]:
    """
    Second-order force constants Phi[i, a, j, b] within an n_super^3
    supercell by +/- central differences.

    With ``symmetry=True`` only the irreducible (atom, direction) pairs
    are displaced (e.g. one displacement for a monatomic cubic crystal
    instead of 3 * n_prim); the remaining rows are reconstructed from
    the space-group operations.  ``symmetry=False`` is the brute-force
    oracle: every primitive atom along every cartesian axis.
    """
    supercell = atoms.repeat(n_super)
    n_prim = len(atoms)
    n_total = len(supercell)

    def response(i: int, direction: np.ndarray) -> np.ndarray:
        plus = supercell.copy()
        plus.positions[i] += disp * direction
        minus = supercell.copy()
        minus.positions[i] -= disp * direction
        f_plus = calc.get_forces(plus)
        f_minus = calc.get_forces(minus)
        return -(f_plus - f_minus) / (2 * disp)

    if not symmetry:
        phi = np.zeros((n_prim, 3, n_total, 3))
        eye = np.eye(3)
        for i in range(n_prim):
            for a in range(3):
                phi[i, a] = response(i, eye[a])
        return phi, supercell

    ops = sym.find_symmetry_ops(supercell, tol=tol)

    # orbit representatives restricted to the primitive cell (repeat()
    # puts image (0,0,0) first, so primitive atoms are indices
    # 0..n_prim-1 of the supercell)
    assigned = np.full(n_prim, -1, dtype=np.int64)
    reps: List[int] = []
    for i in range(n_prim):
        if assigned[i] >= 0:
            continue
        reps.append(i)
        for op in ops:
            j = int(op.permutation[i])
            if j < n_prim and assigned[j] < 0:
                assigned[j] = i

    def transform_response(resp: np.ndarray, op: sym.SymmetryOp
                           ) -> np.ndarray:
        out = np.empty_like(resp)
        out[op.permutation] = resp @ op.cartesian.T
        return out

    # measure irreducible directions per representative, closing each
    # measurement under the site symmetry group before deciding whether
    # another cartesian direction is still needed
    measured: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for r in reps:
        site_ops = sym.site_symmetry(ops, r)
        entries: List[Tuple[np.ndarray, np.ndarray]] = []
        span = np.zeros((0, 3))
        for a in range(3):
            if np.linalg.matrix_rank(span, tol=1e-8) == 3:
                break
            cand = np.eye(3)[a]
            if span.shape[0]:
                # skip directions already in the generated span
                proj, *_ = np.linalg.lstsq(span.T, cand, rcond=None)
                if np.linalg.norm(span.T @ proj - cand) < 1e-8:
                    continue
            resp = response(r, cand)
            for op in site_ops:
                entries.append((op.cartesian @ cand,
                                transform_response(resp, op)))
                span = np.concatenate(
                    [span, (op.cartesian @ cand)[None]], axis=0)
        if np.linalg.matrix_rank(span, tol=1e-8) < 3:
            raise RuntimeError(
                "site-symmetry closure failed to span R^3")
        measured[r] = entries

    phi = np.zeros((n_prim, 3, n_total, 3))
    for i in range(n_prim):
        r = assigned[i] if assigned[i] >= 0 else i
        mapping = [op for op in ops if op.permutation[r] == i]
        dirs = []
        resps = []
        for op in mapping[:4]:
            for u, resp in measured[r]:
                dirs.append(op.cartesian @ u)
                resps.append(transform_response(resp, op))
        phi[i] = _solve_rows(np.asarray(dirs), np.asarray(resps))
    return phi, supercell


def dynamical_matrix(q: np.ndarray,
                     phi: np.ndarray,
                     atoms: Atoms,
                     supercell: Atoms) -> np.ndarray:
    """Mass-weighted Fourier transform of the force constants at q
    (fractional coordinates of the primitive reciprocal cell)."""
    n_prim = len(atoms)
    masses = atoms.get_masses()
    prim_cell = atoms.get_cell()
    recip = 2 * np.pi * np.linalg.inv(prim_cell).T
    q_cart = q @ recip
    # map supercell atoms to primitive index + lattice vector
    offsets = supercell.get_positions() - np.tile(
        atoms.get_positions(), (len(supercell) // n_prim, 1))
    prim_index = np.tile(np.arange(n_prim), len(supercell) // n_prim)
    dyn = np.zeros((3 * n_prim, 3 * n_prim), dtype=complex)
    phases = np.exp(1j * offsets @ q_cart)
    for i in range(n_prim):
        for j_sup in range(len(supercell)):
            j = prim_index[j_sup]
            weight = phases[j_sup] / np.sqrt(masses[i] * masses[j])
            dyn[3 * i:3 * i + 3, 3 * j:3 * j + 3] += \
                phi[i, :, j_sup, :] * weight
    return 0.5 * (dyn + dyn.conj().T)


# high-symmetry points in fractional coordinates of the cell actually
# used (conventional cubic / primitive fcc / primitive bcc / hexagonal),
# after Setyawan & Curtarolo, Comput. Mater. Sci. 49, 299 (2010)
CUBIC_PATH = {
    "G": np.array([0.0, 0.0, 0.0]),
    "H": np.array([0.5, -0.5, 0.5]),
    "N": np.array([0.0, 0.0, 0.5]),
    "P": np.array([0.25, 0.25, 0.25]),
    "X": np.array([0.0, 0.5, 0.0]),
    "M": np.array([0.5, 0.5, 0.0]),
    "R": np.array([0.5, 0.5, 0.5]),
}
FCC_PATH = {
    "G": np.array([0.0, 0.0, 0.0]),
    "X": np.array([0.5, 0.0, 0.5]),
    "W": np.array([0.5, 0.25, 0.75]),
    "K": np.array([0.375, 0.375, 0.75]),
    "L": np.array([0.5, 0.5, 0.5]),
    "U": np.array([0.625, 0.25, 0.625]),
}
BCC_PATH = {
    "G": np.array([0.0, 0.0, 0.0]),
    "H": np.array([0.5, -0.5, 0.5]),
    "N": np.array([0.0, 0.0, 0.5]),
    "P": np.array([0.25, 0.25, 0.25]),
}
HEX_PATH = {
    "G": np.array([0.0, 0.0, 0.0]),
    "M": np.array([0.5, 0.0, 0.0]),
    "K": np.array([1.0 / 3.0, 1.0 / 3.0, 0.0]),
    "A": np.array([0.0, 0.0, 0.5]),
    "L": np.array([0.5, 0.0, 0.5]),
    "H": np.array([1.0 / 3.0, 1.0 / 3.0, 0.5]),
}

DEFAULT_PATHS = {
    "cubic": ("G", "H", "N", "G", "P"),
    "fcc": ("G", "X", "W", "K", "G", "L"),
    "bcc": ("G", "H", "N", "G", "P", "H"),
    "hex": ("G", "M", "K", "G", "A"),
}


def detect_lattice(atoms: Atoms, tol: float = 1e-4) -> str:
    """Classify the cell: 'cubic' (conventional), primitive 'fcc'/
    'bcc', 'hex', else 'unknown'."""
    cell = np.asarray(atoms.get_cell())
    lengths = np.linalg.norm(cell, axis=1)
    unit = cell / lengths[:, None]
    cosines = np.array([unit[1] @ unit[2], unit[0] @ unit[2],
                        unit[0] @ unit[1]])
    eq_len = np.ptp(lengths) < tol * lengths[0]
    if eq_len and np.all(np.abs(cosines) < tol):
        return "cubic"
    if eq_len and np.all(np.abs(cosines - 0.5) < tol):
        return "fcc"
    if eq_len and np.all(np.abs(cosines + 1.0 / 3.0) < tol):
        return "bcc"
    if (abs(lengths[0] - lengths[1]) < tol * lengths[0]
            and abs(cosines[2] + 0.5) < tol
            and np.all(np.abs(cosines[:2]) < tol)):
        return "hex"
    return "unknown"


def standard_path(atoms: Atoms):
    """(points, labels) for the detected lattice type."""
    lattice = detect_lattice(atoms)
    if lattice == "cubic":
        return CUBIC_PATH, DEFAULT_PATHS["cubic"]
    if lattice == "fcc":
        return FCC_PATH, DEFAULT_PATHS["fcc"]
    if lattice == "bcc":
        return BCC_PATH, DEFAULT_PATHS["bcc"]
    if lattice == "hex":
        return HEX_PATH, DEFAULT_PATHS["hex"]
    raise ValueError("Unrecognized lattice; pass `path` and `points` "
                     "explicitly.")


def compute_phonon_data(atoms: Atoms,
                        calc,
                        n_super: int = 3,
                        disp: float = 0.01,
                        path: Optional[List[str]] = None,
                        points: Optional[Dict] = None,
                        n_points: int = 20,
                        symmetry: bool = True) -> Dict:
    """
    Phonon band structure along a high-symmetry path.

    ``path``/``points`` default to the standard path for the detected
    lattice (conventional cubic, primitive fcc/bcc, hexagonal).
    Returns dict with 'distances' (1/Angstrom, cartesian), 'frequencies'
    (THz), and 'labels'.
    """
    if path is None or points is None:
        auto_points, auto_path = standard_path(atoms)
        path = list(path) if path is not None else list(auto_path)
        points = points if points is not None else auto_points
    phi, supercell = force_constants(atoms, calc, n_super=n_super,
                                     disp=disp, symmetry=symmetry)
    # acoustic sum rule: each row block balances its self term
    n_prim = len(atoms)
    for i in range(n_prim):
        for a in range(3):
            for b in range(3):
                total = np.sum(phi[i, a, :, b])
                phi[i, a, i, b] -= total
    recip = 2 * np.pi * np.linalg.inv(np.asarray(atoms.get_cell())).T
    qs = []
    distances = []
    labels = []
    total_distance = 0.0
    for seg in range(len(path) - 1):
        q0 = points[path[seg]]
        q1 = points[path[seg + 1]]
        seg_len = np.linalg.norm((q1 - q0) @ recip)
        labels.append((total_distance, path[seg]))
        for t in np.linspace(0, 1, n_points, endpoint=(
                seg == len(path) - 2)):
            q = q0 + t * (q1 - q0)
            qs.append(q)
            distances.append(total_distance + t * seg_len)
        total_distance += seg_len
    labels.append((total_distance, path[-1]))
    frequencies = []
    # internal frequency unit -> THz: sqrt(eV / (amu A^2)) / (2 pi)
    conv = np.sqrt(1.602176634e-19 / 1.66053906660e-27) * 1e10 \
        / (2 * np.pi) / 1e12
    for q in qs:
        dyn = dynamical_matrix(np.asarray(q), phi, atoms, supercell)
        eigenvalues = np.linalg.eigvalsh(dyn)
        freq = np.sign(eigenvalues) * np.sqrt(np.abs(eigenvalues)) * conv
        frequencies.append(freq)
    return dict(distances=np.array(distances),
                frequencies=np.array(frequencies),
                labels=labels,
                force_constants=phi)


def plot_phonon_spectrum(data: Dict, ax=None):
    """Plot the band structure returned by compute_phonon_data."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(data["distances"], data["frequencies"], color="C0", lw=1)
    for x, label in data["labels"]:
        ax.axvline(x, color="gray", lw=0.5)
    ax.set_xticks([x for x, _ in data["labels"]])
    ax.set_xticklabels([label for _, label in data["labels"]])
    ax.set_ylabel("Frequency (THz)")
    return ax
