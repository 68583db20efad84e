"""
The port's model loader and weights converter
(uf3_tpu_torch/io.py, ops/potential.py) against the JAX package's
WeightedLinearModel.from_json + build_pair_fast / build_trio_pallas /
build_potential: the float64 buffers must be bitwise equal, but for
what follows from the leg specs, which the port builds on the file's
own knots (ROADMAP.md section 3).  Also checks that the port imports
neither jax nor pandas.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.ops import spline_jax as sj
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch import io
from uf3_tpu_torch.ops.potential import UF3Potential
from uf3_tpu_torch.ops.splines import horner_table

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bundle():
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    return (model, pt.build_trio_pallas(model, dtype=jnp.float64),
            pt.build_pair_fast(model, dtype=jnp.float64), params)


def _buffers(pot):
    return {k: v.numpy() for k, v in pot.named_buffers()}


def test_loader_matches_weighted_linear_model(jax_bundle):
    model = jax_bundle[0]
    ours = io.load_model(MODEL)
    assert np.array_equal(ours.coefficients, model.coefficients)
    assert ours.bspline_config.partition_sizes \
        == model.bspline_config.partition_sizes
    sol_j = ls.arrange_coefficients(model.coefficients,
                                    model.bspline_config)
    sol_t = io.arrange_coefficients(ours.coefficients,
                                    ours.bspline_config)
    assert sol_j.keys() == sol_t.keys()
    for key in sol_j:
        assert np.array_equal(sol_j[key], sol_t[key])


def same_spline(knots, clamped, cardinal, tol=1e-14) -> bool:
    """Whether ``cardinal`` taps over uniform cardinal B-splines make the
    clamped spline of ``clamped`` on ``knots``: each interval's cubic
    within ``tol`` of the largest coefficient of any piece."""
    beta = sj.basis_monomial_table(knots)
    poly = np.stack([clamped[i:i + 4] @ beta[i] for i in range(len(beta))])
    recon = np.stack([cardinal[i:i + 4] @ pt.CARDINAL_M
                      for i in range(len(beta))])
    return np.abs(recon - poly).max() <= tol * np.abs(poly).max()


def _as_jax_spec(spec, ref):
    """The port's leg spec with the JAX package's spacing and no knots:
    the port takes the mean knot gap and carries the file's knots, where
    the JAX package takes the first gap (ROADMAP.md section 3)."""
    assert abs(spec.h - ref.h) <= 1e-10
    return tuple(spec._replace(h=ref.h, knots=None))


def test_from_json_matches_jax_builders(jax_bundle):
    model, trio, pair, params = jax_bundle
    pot = UF3Potential.from_json(MODEL)
    buf = _buffers(pot)
    knots = model.bspline_config.knots_map
    pair_knots = knots[model.bspline_config.interactions_map[2][0]]
    assert _as_jax_spec(pot.pair_spec, pair[0]) == tuple(pair[0])
    assert pot.pair_spec.knots == tuple(pair_knots[3:-3])
    # the cardinal coefficients: the file's own between the three at
    # each end, which are matched on their end interval alone
    # (ops/splines.cardinal_coefficients); the spline they make is the
    # file's, piece by piece, to 1e-14 of its largest term (the JAX
    # package's forward recursion carries its rounding along the leg:
    # 2.8e-12 here)
    sizes, offsets = model.bspline_config.get_interaction_partitions()
    pair_name = model.bspline_config.interactions_map[2][0]
    clamped = model.coefficients[offsets[pair_name]:offsets[pair_name]
                                 + sizes[pair_name]]
    assert np.array_equal(buf["pair_coefficients"][3:-3], clamped[3:-3])
    assert same_spline(pair_knots, clamped, buf["pair_coefficients"])
    assert np.array_equal(buf["grid"], np.asarray(trio.grid))
    assert np.array_equal(buf["offsets_1b"], np.asarray(params.offsets_1b))
    assert np.array_equal(buf["z_to_species"],
                          np.asarray(params.z_to_species))
    for field in ("l_basis", "n_basis", "active_bc", "window",
                  "symmetric"):
        assert getattr(pot.trio, field) == getattr(trio, field), field
    assert _as_jax_spec(pot.trio.spec_l, trio.spec_l) == tuple(trio.spec_l)
    assert _as_jax_spec(pot.trio.spec_n, trio.spec_n) == tuple(trio.spec_n)
    assert pot.r_cut_2b == float(params.r_cut_2b)
    assert pot.r_cut_3b == float(params.r_cut_3b)
    # the bench model's static sparsity: 27 live (b, c) blocks in a
    # 3 x 9 window, and the Horner rows of the 6 + 12 leg intervals
    assert pot.trio.window == (3, 6, 3, 12)
    assert sum(len(cs) for _, cs in pot.trio.active_bc) == 27
    assert buf["leg_tables"].shape == (6 + 12, 20)
    w_lo, w_hi, c_lo, c_hi = pot.trio.window
    assert np.array_equal(buf["grid_window"],
                          buf["grid"][w_lo:w_hi, w_lo:w_hi, c_lo:c_hi])


def test_from_jax_arrays_matches_from_json(jax_bundle):
    _, trio, pair, params = jax_bundle
    as_np = trio._replace(grid=np.asarray(trio.grid))
    conv = UF3Potential.from_jax_arrays(
        as_np, (pair[0], np.asarray(pair[1])),
        np.asarray(params.offsets_1b), np.asarray(params.z_to_species),
        float(params.r_cut_2b), float(params.r_cut_3b))
    ref = UF3Potential.from_json(MODEL)
    # the converter takes the fused pieces alone; from_json also holds
    # the factorized tables (tests/test_torch_factorized.py)
    assert conv.factorized is None and ref.factorized is not None
    a = _buffers(conv)
    b = {k: v for k, v in _buffers(ref).items()
         if not k.startswith("factorized.")}
    assert a.keys() == b.keys()
    # each side's pair coefficients and Horner tables come from its own
    # leg specs: the converter keeps the JAX package's (first knot gap,
    # JAX's cardinal recursion), from_json the file's knots
    # (ROADMAP.md section 3); every other buffer is the same
    assert np.array_equal(a["pair_coefficients"], np.asarray(pair[1]))
    assert np.array_equal(a["leg_tables"], np.concatenate(
        [horner_table(conv.trio.spec_l), horner_table(conv.trio.spec_n)]))
    assert np.array_equal(b["leg_tables"], np.concatenate(
        [horner_table(ref.trio.spec_l), horner_table(ref.trio.spec_n)]))
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        if key not in ("pair_coefficients", "leg_tables"):
            assert np.array_equal(a[key], b[key]), key
    assert conv.trio._replace(grid=None, spec_l=None, spec_n=None) \
        == ref.trio._replace(grid=None, spec_l=None, spec_n=None)
    for mine, theirs in ((ref.pair_spec, conv.pair_spec),
                         (ref.trio.spec_l, conv.trio.spec_l),
                         (ref.trio.spec_n, conv.trio.spec_n)):
        assert _as_jax_spec(mine, theirs) == tuple(theirs)
    # float32 buffers round the same float64 sources
    f32 = UF3Potential.from_json(MODEL, dtype=torch.float32)
    assert np.array_equal(f32.grid.numpy(), b["grid"].astype(np.float32))


def test_port_imports_no_jax_or_pandas():
    """A fresh process that imports every module of the port and runs
    its MD set-up holds no jax, no pandas and nothing of uf3_tpu."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import uf3_tpu_torch\n"
        "for mod in pkgutil.walk_packages(uf3_tpu_torch.__path__,\n"
        "                                 'uf3_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "from uf3_tpu_torch.data.atoms import bulk\n"
        "from uf3_tpu_torch.forcefield.md import MDSystem\n"
        "geom = bulk('W', 'bcc', a=3.1652) * (8, 8, 8)\n"
        "s = MDSystem('benchmarks_data/model_2and3.json', geom,\n"
        "             dtype=torch.float64, rebuild_every=12, skin=0.5,\n"
        "             skin_2b=1.2, capacity_2b=72, capacity_3b=16,\n"
        "             n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5),\n"
        "             device='cpu')\n"
        "s.init_state(temperature=300.0, seed=0)\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('uf3_tpu_torch.')]))\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'pandas', 'uf3_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_port, foreign = out.stdout.strip().splitlines()[-2:]
    assert int(n_port) >= 17  # every module of the port was imported
    assert foreign == "[]"
