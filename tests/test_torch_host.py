"""
The port's own copies of the host modules (uf3_tpu_torch/data,
forcefield/units.py, representation/, util/json_io.py) against the JAX
package's originals, and the port's import and device rules:

- every model JSON the tests name loads to the same knots, partitions,
  flat coefficients and 3-body grids (exact: the same numpy code);
- elements, units, knot spacers and de Boor values are equal, and so
  are the Szudzik species hashes (twins of ``tests/test_composition.py``'s
  hash tests), the interaction hashes and the composition counts;
- ``bulk`` supercells, rattled with the same seed, give the same
  positions and cell;
- no file of the port, nor ``chip_smoke.py``, imports ``uf3_tpu``;
- ``MDSystem`` runs on the card unless asked for the CPU.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from uf3_tpu.data import atoms as j_atoms
from uf3_tpu.data import composition as j_comp
from uf3_tpu.data import elements as j_el
from uf3_tpu.forcefield import units as j_units
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation import basis as j_basis
from uf3_tpu.representation import knots as j_knots
from uf3_tpu.representation import splines as j_splines
from uf3_tpu.util import json_io as j_json
from uf3_tpu_torch import io
from uf3_tpu_torch.data import atoms as t_atoms
from uf3_tpu_torch.data import composition as t_comp
from uf3_tpu_torch.data import elements as t_el
from uf3_tpu_torch.forcefield import md as t_md
from uf3_tpu_torch.forcefield import units as t_units
from uf3_tpu_torch.representation import knots as t_knots
from uf3_tpu_torch.representation import splines as t_splines

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = [os.path.join(REPO, "benchmarks_data", "model_2and3.json"),
          os.path.join(REPO, "tests", "data", "model_unary.json"),
          os.path.join(REPO, "tests", "data", "model_binary.json")]
STRATEGIES = ("linear", "lammps", "geometric", "inverse")


def _equal_maps(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, list):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                assert np.array_equal(x, y), key
        else:
            assert np.array_equal(va, vb), key


@pytest.mark.parametrize("path", MODELS, ids=os.path.basename)
def test_model_loading_matches_uf3_tpu(path):
    ours = io.load_model(path)
    config = ours.bspline_config
    ref = j_basis.BSplineBasis.from_dict(j_json.load_interaction_map(path))
    assert config.element_list == ref.element_list
    assert config.interactions_map == ref.interactions_map
    _equal_maps(config.knots_map, ref.knots_map)
    assert config.symmetry == ref.symmetry
    assert config.partition_sizes == ref.partition_sizes
    assert config.r_cut == ref.r_cut
    assert config.get_interaction_partitions() \
        == ref.get_interaction_partitions()
    model = ls.WeightedLinearModel.from_json(path)
    assert np.array_equal(ours.coefficients, model.coefficients)
    solutions = io.arrange_coefficients(ours.coefficients, config)
    trios = config.interactions_map.get(3, [])
    assert len(trios) == (1 if config.degree == 3 else 0)
    for trio in trios:
        assert np.array_equal(config.template_mask[trio],
                              ref.template_mask[trio])
        grid = config.decompress_3B(solutions[trio], trio)
        assert np.array_equal(grid, ref.decompress_3B(solutions[trio], trio))
        assert np.array_equal(config.compress_3B(grid, trio, fitting=False),
                              ref.compress_3B(grid, trio, fitting=False))
        assert np.abs(grid).max() > 0


def test_elements_and_units_match_uf3_tpu():
    assert t_el.atomic_numbers == j_el.atomic_numbers
    assert t_el.element_order_key == j_el.element_order_key
    assert np.array_equal(t_el.atomic_masses, j_el.atomic_masses)
    for name in ("fs", "ps", "kB", "GPa", "bar"):
        assert getattr(t_units, name) == getattr(j_units, name), name


@pytest.mark.parametrize("elements, degree", [(["W"], 3), (["Xe", "Ne"], 2),
                                              (["Xe", "Ne", "W"], 3)])
def test_chemical_system_matches_uf3_tpu(elements, degree):
    ours = t_comp.ChemicalSystem(elements, degree)
    ref = j_comp.ChemicalSystem(elements, degree)
    assert ours.element_list == ref.element_list
    assert ours.interactions_map == ref.interactions_map
    assert ours.interactions == ref.interactions
    assert t_comp.sort_interaction_symbols(("W", "Xe", "Ne")) \
        == j_comp.sort_interaction_symbols(("W", "Xe", "Ne"))


def test_szudzik_roundtrip():
    """Twin of ``tests/test_composition.py``'s: the hashes of sorted
    species rows unpack to the rows, and equal ``uf3_tpu``'s."""
    rng = np.random.RandomState(0)
    arr = rng.randint(1, 110, size=(50, 3))
    arr[:, 1:] = np.sort(arr[:, 1:], axis=1)
    hashes = t_comp.get_szudzik_hash(arr)
    assert np.array_equal(hashes, j_comp.get_szudzik_hash(arr))
    assert np.all(t_comp.unpack_szudzik_hash(hashes, 3) == arr)
    assert np.array_equal(t_comp.szudzik_unpair(hashes),
                          j_comp.szudzik_unpair(hashes))


def test_szudzik_pair_formula():
    assert t_comp.szudzik_pair(np.array([[3, 2]]))[0] == 11
    assert t_comp.szudzik_pair(np.array([[2, 3]]))[0] == 14
    assert t_comp.szudzik_pair(np.array([[5, 5]]))[0] == 35


@pytest.mark.parametrize("elements, degree", [(["W"], 3), (["Xe", "Ne"], 2),
                                              (["Xe", "Ne", "W"], 3)])
def test_interaction_hashes_and_composition_match_uf3_tpu(elements, degree):
    ours = t_comp.ChemicalSystem(elements, degree)
    ref = j_comp.ChemicalSystem(elements, degree)
    assert ours.numbers == ref.numbers
    assert ours.interaction_hashes.keys() == ref.interaction_hashes.keys()
    for key in ref.interaction_hashes:
        assert np.array_equal(ours.interaction_hashes[key],
                              ref.interaction_hashes[key])
    geom = t_atoms.bulk("W", "bcc", a=3.1652) * 2
    geom.numbers[::3] = 54
    geom.numbers[1::5] = 10
    assert np.array_equal(ours.get_composition_tuple(geom),
                          ref.get_composition_tuple(geom))
    assert t_el.symbols_to_numbers(["Ne", 54, "W"]) \
        == j_el.symbols_to_numbers(["Ne", 54, "W"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_knots_and_deboor_match_uf3_tpu(strategy):
    seq_t = t_knots.get_knot_spacer(strategy)(1.5, 5.5, 9)
    seq_j = j_knots.get_knot_spacer(strategy)(1.5, 5.5, 9)
    assert np.array_equal(seq_t, seq_j)
    r = np.concatenate([np.random.RandomState(3).uniform(1.5, 5.5, 301),
                        seq_j])
    for nu in (0, 1, 2):
        vt, it = t_splines.deboor_values(r, seq_t, nu=nu)
        vj, ij = j_splines.deboor_values(r, seq_j, nu=nu)
        assert np.array_equal(it, ij)
        assert np.array_equal(vt, vj)


@pytest.mark.parametrize("structure", ["bcc", "fcc", "sc", "diamond"])
def test_bulk_and_rattle_match_uf3_tpu(structure):
    ours = t_atoms.bulk("W", structure, a=3.1652) * (8, 8, 8)
    ref = j_atoms.bulk("W", structure, a=3.1652) * (8, 8, 8)
    ours.rattle(0.05, seed=11)
    ref.rattle(0.05, seed=11)
    assert len(ours) == len(ref)
    assert np.array_equal(ours.get_positions(), ref.get_positions())
    assert np.array_equal(ours.get_cell(), ref.get_cell())
    assert np.array_equal(ours.get_atomic_numbers(),
                          ref.get_atomic_numbers())
    assert np.array_equal(ours.get_pbc(), ref.get_pbc())
    assert ours.get_volume() == ref.get_volume()


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _import_sites(path, module):
    """The enclosing function's name (None at module level) of each
    import of ``module`` in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)
    sites = []

    def visit(node, function):
        for child in ast.iter_child_nodes(node):
            names = [alias.name for alias in child.names] \
                if isinstance(child, ast.Import) else \
                [child.module or ""] if isinstance(child, ast.ImportFrom) \
                else []
            if any(name.split(".")[0] == module for name in names):
                sites.append(function)
            visit(child, child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else function)

    visit(tree, None)
    return sites


def test_port_sources_import_nothing_of_uf3_tpu():
    files = glob.glob(os.path.join(REPO, "uf3_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    # the calculator and what runs on it are scanned too, and the
    # gather kernels' wrapper and the measurement scripts
    scanned = {os.path.relpath(path, REPO) for path in files}
    assert {os.path.join("uf3_tpu_torch", *name.split("/")) for name in (
        "data/io.py", "data/symmetry.py", "forcefield/calculator.py",
        "forcefield/optimize.py", "forcefield/batch.py",
        "forcefield/lammps.py", "forcefield/properties/elastic.py",
        "forcefield/properties/phonon.py", "ops/featurize.py",
        "regression/least_squares.py", "regression/regularize.py",
        "util/user_config.py", "util/subsample.py", "data/geometry.py",
        "representation/featurize_np.py",
        "representation/process.py", "parallel/__init__.py",
        "parallel/mesh.py", "parallel/halo.py", "data/analyze.py",
        "regression/optimize.py", "forcefield/ase_adapter.py",
        "util/tracing.py", "util/plotting.py", "util/plotting3d.py",
        "util/hdf5.py", "util/parallel.py",
        "ops/gather.py", "benchmarks/__init__.py", "benchmarks/common.py",
        "benchmarks/step_anatomy.py", "benchmarks/probe_gather.py",
        "benchmarks/probe_stale.py", "benchmarks/probe_stale_error.py",
        "benchmarks/validate_final.py", "benchmarks/validate_respa.py",
        "benchmarks/validate_respa_mid.py", "benchmarks/anatomy_3l.py",
        "benchmarks/probe_rebuild2.py", "benchmarks/md_scaling.py",
        "benchmarks/featurize_throughput.py",
        "benchmarks/fit_wallclock.py", "benchmarks/melting_run.py",
        "native/__init__.py", "examples/__init__.py",
        "examples/melting_point.py", "examples/tungsten_fit.py",
        "examples/nexe_pair_fit.py", "examples/multichip_demo.py")} \
        <= scanned
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] != "uf3_tpu", (path, name)
            # neither jax nor pandas nor PyYAML nor h5py nor PyTables is
            # on the GPU hosts
            assert name.split(".")[0] not in ("jax", "pandas", "yaml",
                                              "h5py", "tables"), (path, name)
        # the lammps module (on neither GPU host) only where the lammps
        # backend runs, as the reference imports it
        sites = _import_sites(path, "lammps")
        assert sites == (["_get_lammps"] if path.endswith(os.path.join(
            "forcefield", "lammps.py")) else []), (path, sites)


def test_port_sources_open_no_path_under_uf3_tpu():
    """No path the port's code or ``chip_smoke.py`` builds or opens
    (``os.path.join``, ``open``, ``glob``, ``np.load``, ``ctypes.CDLL``
    ...) passes through the JAX package's directory: the native library,
    the model files and the kernels' sources are the port's own."""
    files = glob.glob(os.path.join(REPO, "uf3_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    readers = {"join", "open", "glob", "load", "loadtxt", "CDLL", "Path",
               "isfile", "exists", "listdir", "walk", "identify_paths",
               "read_xyz", "load_model", "from_json"}
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) \
                else getattr(func, "id", None)
            if name not in readers:
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for leaf in ast.walk(arg):
                    if isinstance(leaf, ast.Constant) \
                            and isinstance(leaf.value, str):
                        head = leaf.value.replace(os.sep, "/").lstrip("/")
                        assert head.split("/")[0] != "uf3_tpu", \
                            (path, node.lineno, leaf.value)


def test_mdsystem_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = t_atoms.bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_md.MDSystem(MODELS[0], geom, dtype=torch.float64, rebuild_every=12,
                      skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                      n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5))
    assert t_md._resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert t_md._resolve_device(None) == torch.device("cuda", 0)
