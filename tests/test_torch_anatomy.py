"""
The step anatomy's prefix functions (uf3_tpu_torch/benchmarks/
step_anatomy.py) against the JAX package in float64 on a rattled
128-atom bcc W box, on the same positions and lists: P1's switched
short-range pair force against ``pallas_trio.pair_short_forces`` and
P3's force evaluation (the trio pass and its reverse-slot assembly)
against ``pallas_trio.trio_forces_unrolled``, within 1e-10 eV/A (the
same closed forms on the same leg specs, the port's potential built
through the weights converter, summed in another order).  Then both
measurement scripts run at tiny sizes on the CPU and write their JSON,
with the device keys null (a CPU run measures no device time).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.benchmarks import gather_host, probe_gather, step_anatomy
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

TOL = 1e-10
PREFIXES = ("scan_null", "p0_gather_comps", "p1_plus_pair_chain",
            "p2_plus_trio_map", "p3_force_eval", "p4_full_inner_step",
            "langevin_only")


def converted(model) -> UF3Potential:
    """The port's potential through the weights converter from the JAX
    package's own pair and trio bundles (as tests/test_torch_forces.py),
    so that both packages run the same leg specs."""
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    trio = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        trio._replace(grid=np.asarray(trio.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))


@pytest.fixture(scope="module")
def setup():
    model = ls.WeightedLinearModel.from_json(step_anatomy.MODEL)
    geom = bulk("W", "bcc", a=3.1652) * (4, 4, 4)
    geom.rattle(0.05, seed=11)
    system = MDSystem(converted(model), geom, dtype=torch.float64,
                      device="cpu", **step_anatomy.SYSTEM)
    state = system.init_state(temperature=step_anatomy.TEMPERATURE, seed=0)
    parts = step_anatomy.StepParts.from_system(system, state)
    nbr3 = state.nbr3
    assert not bool(nbr3.mask.all())   # self-padded slots in the rows
    jnbr3 = jnb.NeighborList(
        idx=jnp.asarray(nbr3.idx.numpy()), shift=jnp.asarray(
            nbr3.shift.numpy()), mask=jnp.asarray(nbr3.mask.numpy()),
        rev=jnp.asarray(nbr3.rev.numpy()), overflow=jnp.asarray(False),
        reference_positions=jnp.asarray(nbr3.reference_positions.numpy()))
    return dict(model=model, system=system, state=state, parts=parts,
                jnbr3=jnbr3, pos=jnp.asarray(state.positions.numpy()),
                cell=jnp.asarray(state.cell.numpy()))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol, np.max(np.abs(a - b))


def test_p1_pair_chain_matches_pair_short_forces(setup):
    s = setup
    parts = s["parts"]
    spec, coeff = pt.build_pair_fast(s["model"], dtype=jnp.float64)
    n_short = pt.basis_window_hi(spec, parts.r_hi)
    assert n_short == parts.n_basis_short
    _, fj, _ = pt.pair_short_forces(
        coeff, s["pos"], s["cell"], s["jnbr3"], spec_pair=spec,
        n_basis_pair=n_short, with_energy=False, r_lo=parts.r_lo,
        r_hi=parts.r_hi)
    d, _ = step_anatomy.gather_comps(parts, s["state"].positions)
    ft = step_anatomy.pair_short(parts, d)
    _close(fj, ft)
    assert float(torch.abs(ft).max()) > 1e-2


def test_p3_force_eval_matches_trio_forces_unrolled(setup):
    s = setup
    parts, jn = s["parts"], s["jnbr3"]
    tb = pt.build_trio_pallas(s["model"], dtype=jnp.float64)
    _, fj = pt.trio_forces_unrolled(
        tb.grid, s["pos"], s["cell"], jn.idx, jn.shift, jn.mask, jn.rev,
        spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
        n_basis=tb.n_basis, block_atoms=64, with_energy=False,
        active_bc=tb.active_bc, window=tb.window)
    d, _ = step_anatomy.gather_comps(parts, s["state"].positions)
    ft = step_anatomy.force_eval(parts, d)
    _close(fj, ft)
    assert float(torch.abs(ft).max()) > 1e-2


def test_bodies_chain_and_draw_from_the_state_generator(setup):
    """Every prefix body maps the positions to finite positions of the
    same shape; the Langevin bodies advance the state's own generator
    (each call draws) and the others leave it alone."""
    s = setup
    parts = s["parts"]
    x = s["state"].positions
    for name, fn in step_anatomy.bodies(parts).items():
        before = parts.generator.get_state()
        y = fn(x)
        assert y.shape == x.shape and bool(torch.isfinite(y).all()), name
        drew = not torch.equal(before, parts.generator.get_state())
        assert drew == (name in ("p4_full_inner_step", "langevin_only")), \
            name


def test_step_anatomy_main_writes_its_artifact(tmp_path):
    artifact, parts = step_anatomy.main(device="cpu", reps=(3, 3, 3),
                                        warm_steps=6, scan_len=2,
                                        out_dir=str(tmp_path), commit="test")
    path = tmp_path / "anatomy_test.json"
    assert json.loads(path.read_text()) == artifact
    assert artifact["platform"] == "cpu" and artifact["card"] is None
    assert (artifact["n_atoms"], artifact["k3"]) == (54, 16)
    ms, host = artifact["ms"], artifact["host_ms"]
    for name in PREFIXES + ("fma_chain_ms",):
        assert ms[name] is None and host[name] > 0, name
    # the row gather of the positions (every row reached) and the
    # reverse-slot gather of the (54, 16, 5) slot partials (the 32-byte
    # sectors of the slots the list reaches back to)
    idx, rev = parts.nbr3.idx.numpy(), parts.nbr3.rev.numpy()
    slots = ((idx * 16 + rev)[..., None] * 5 + np.arange(5)) * 8 // 32
    for label, table, w, n_idx in (
            ("gather", 8 * 54 * 3, 3, 54 * 16),
            ("rev_gather", 32 * len(np.unique(slots)), 5, 2 * 54 * 16)):
        rec = ms[f"kernel_{label}"]
        assert rec["correct"] and rec["bound_by"] == "bytes", label
        assert rec["ms"] is None and rec["ns_per_row"] is None, label
        assert rec["bytes"] == table + 8 * (n_idx + 54 * 16 * w), label
        for name in ("library", "plain"):
            assert ms[f"{name}_{label}_ms"] is None, label
        for name in ("kernel", "library", "plain"):
            assert host[f"{name}_{label}_ms"] > 0, label
    assert parts.nbr3.idx.shape == (54, 16)


def test_probe_gather_main_writes_its_artifact(tmp_path):
    artifact = probe_gather.main(device="cpu", max_rows=24,
                                 out_dir=str(tmp_path), commit="test")
    assert json.loads((tmp_path / "probe_gather.json").read_text()) \
        == artifact
    cases = artifact["cases"]
    assert list(cases) == [case.name for case in probe_gather.CASES]
    assert {name.split(".")[0] for name in cases} == {
        "probe_dynamic_gather", "probe_dg2", "probe_dg3",
        "probe_gather2", "probe_wg", "proto_dyngather",
        "proto_pallas_gather", "probe_mosaic", "engine"}
    engine = {f"engine.positions_k{k}" for k in (16, 72, 78, 88)}
    assert engine | {"engine.partials_k16"} <= set(cases)
    for name, record in cases.items():
        assert record["correct"] and record["bound_by"] == "bytes", name
        assert record["kernel_ms"] is None and record["reached"] is None
        assert record["past_floor_ms"] is None
        assert record["kernel_cold_ms"] is None
        assert record["cold_copies"] is None
        if name in engine:
            # the small bcc W cell's float32 positions through its own
            # int64 list, its index capped
            assert record["values"] == [128, 3], name
            assert max(record["index"]) <= 24, name
            assert (record["dtype"], record["index_dtype"]) == (
                "float32", "int64")
            assert record["instance"]["kernel"] == "rows_w3"
        elif name == "engine.partials_k16":
            # (N, K, 5) float32 slot partials back through the small
            # cell's 3-body list and its reverse slots (int64), capped
            assert record["kind"] == "rev"
            assert record["values"] == [128, 16, 5]
            assert record["index"] == [24, 16]
            assert (record["dtype"], record["index_dtype"]) == (
                "float32", "int64")
            assert record["instance"]["kernel"] == "rev_any"
        else:
            assert max(record["values"] + record["index"]) <= 24, name
            assert record["index_dtype"] == "int32"
    assert {r["kind"] for r in cases.values()} == {"rows", "lanes", "rev"}
    assert artifact["node_floor_ms"] is None
    assert set(artifact["host_us"]) == {"128 x 16", "128 x 78"}
    assert all(us > 0 for costs in artifact["host_us"].values()
               for us in costs.values())
    # a case's bytes: the indices read once, the output written once, and
    # the table's sectors the indices reach (here every row, one sector)
    rec = cases["proto_pallas_gather.kernel"]
    n_idx, w = int(np.prod(rec["index"])), rec["values"][1]
    assert rec["bytes"] == 4 * (int(np.prod(rec["values"])) + n_idx
                                + n_idx * w)


def test_scripts_require_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (step_anatomy.main, probe_gather.main):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            main()


def test_gather_host_pairs_the_wrappers(tmp_path):
    """``gather_host`` loads another checkout's ``ops/gather.py`` under a
    name of its own, on that checkout's own ``_build.py`` (here this
    checkout's, whose plain versions on CPU tensors then agree with the
    package's), and summarizes the rounds: each call's median, and the
    quartiles of this wrapper less the other's, round by round; timing
    needs a card."""
    from uf3_tpu_torch.ops import _build, gather
    other = gather_host.load_gather(gather_host.ROOT)
    assert other is not gather and other._build is not _build
    assert other._build.LIBRARY == _build.LIBRARY
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(40, 3))
    idx = torch.as_tensor(rng.randint(0, 40, size=(40, 7)))
    assert torch.equal(other.gather_rows(x, idx), gather.gather_rows(x, idx))
    times = {"rows this": [3.0, 5.0, 4.0, 10.0],
             "rows other": [2.0, 2.0, 3.0, 4.0],
             "rows library": [1.0, 1.0, 2.0, 1.0]}
    summary = gather_host.summarize(times)
    assert summary["median_us"] == {"rows this": 4.5, "rows other": 2.5,
                                    "rows library": 1.0}
    assert summary["this_less_other_us"]["rows"] == dict(
        q1=1.0, median=2.0, q3=3.75)
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            gather_host.measure(gather_host.ROOT, rounds=1)
