"""
Parity of the torch spline primitives (uf3_tpu_torch/ops/splines.py)
with the JAX ones (uf3_tpu/ops/pallas_trio.py) in float64, on inputs
made with numpy: 1e-10 absolute (both evaluate the same closed forms;
only the order of a few float operations may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import spline_jax as sj
from uf3_tpu.representation import knots as kn
from uf3_tpu_torch.ops import splines as ts

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

TOL = 1e-10
STRATEGIES = ("linear", "lammps", "geometric", "inverse")


def _seq(strategy, lo=1.5, hi=5.5, n_int=9):
    return kn.get_knot_spacer(strategy)(lo, hi, n_int)


def _specs(strategy, exact=False):
    """The knots, and the port's spec as each package's LegSpec.  The
    port's spec is the JAX package's but for its spacing, the mean gap
    where the JAX package takes the first (ROADMAP.md section 3), so the
    primitives are compared on the port's spec."""
    seq = _seq(strategy)
    ok_j, spec_j = pt.leg_spec_from_knots(seq, exact=exact)
    ok_t, spec_t = ts.leg_spec_from_knots(seq, exact=exact)
    assert ok_j and ok_t
    fwd = {"linear": lambda x: x, "lammps": np.square, "geometric": np.log,
           "inverse": lambda x: 1.0 / x}[strategy]
    u = fwd(seq[3:-3])
    assert spec_t.h == (u[-1] - u[0]) / spec_t.n_int
    # linear knots are rounded to 1e-10: the first gap is off by <= 1e-10
    assert abs(spec_t.h - spec_j.h) <= 1e-10
    assert tuple(spec_j._replace(h=spec_t.h)) == tuple(spec_t)
    return seq, pt.LegSpec(*spec_t), spec_t


def _radii(seed, n=401, lo=1.0, hi=6.0):
    # spans below, inside and above the knot range, plus the knots
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(lo, hi, n), _seq("linear")])


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    assert np.allclose(a, b, atol=tol, rtol=0), np.abs(a - b).max()


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("exact", [False, True])
def test_leg_spec_and_deboor(strategy, exact):
    seq, spec_j, spec_t = _specs(strategy, exact)
    r = _radii(1)
    idx_j = pt._leg_interval(spec_j, jnp.asarray(r))
    idx_t = ts._leg_interval(spec_t, torch.as_tensor(r))
    assert np.array_equal(np.asarray(idx_j), idx_t.numpy())
    k = np.arange(-2, spec_j.n_int + 3).clip(0, spec_j.n_int)
    _close(pt._knot_value(spec_j, jnp.asarray(k)),
           ts._knot_value(spec_t, torch.as_tensor(k), torch.float64))
    _close(pt._transform(spec_j, jnp.asarray(r)),
           ts._transform(spec_t, torch.as_tensor(r)))
    vj, dj = pt._deboor4(jnp.asarray(r), idx_j, spec_j)
    vt, dt = ts._deboor4(torch.as_tensor(r), idx_t, spec_t)
    for a, b in zip(vj + dj, vt + dt):
        _close(a, b)


@pytest.mark.parametrize("strategy", ["linear", "inverse"])
@pytest.mark.parametrize("transposed", [False, True])
def test_dense_basis(strategy, transposed):
    _, spec_j, spec_t = _specs(strategy)
    rng = np.random.RandomState(2)
    r = rng.uniform(1.0, 6.0, (5, 16))
    valid = (rng.rand(5, 16) > 0.2).astype(np.float64)
    for lo, hi in ((0, None), (3, 9)):
        mj = pt._dense_basis(jnp.asarray(r), jnp.asarray(valid), spec_j,
                             lo=lo, hi=hi, transposed=transposed)
        mt = ts._dense_basis(torch.as_tensor(r), torch.as_tensor(valid),
                             spec_t, lo=lo, hi=hi, transposed=transposed)
        for a, b in zip(mj, mt):
            _close(a, b)


def test_cardinal_roundtrip_and_blends():
    # a random clamped spline on uniform knots equals its cardinal
    # re-expression everywhere on the domain, derivatives included
    rng = np.random.RandomState(7)
    n_int, lo, hi = 12, 1.0, 5.5
    pts = np.linspace(lo, hi, n_int + 1)
    seq = np.concatenate([[lo] * 3, pts, [hi] * 3])
    coef = rng.randn(n_int + 3)
    uc = ts.cardinal_coefficients(seq, coef)
    _close(pt.cardinal_coefficients(seq, coef), uc)
    _close(sj.basis_monomial_table(seq), ts.basis_monomial_table(seq))
    ok, spec = ts.leg_spec_from_knots(seq)
    spec_c = spec._replace(cardinal=True)
    r = torch.as_tensor(np.linspace(lo + 1e-9, hi - 1e-9, 507))
    idx = ts._leg_interval(spec, r)
    vals, ders = ts._deboor4(r, idx, spec)
    c = torch.as_tensor(coef)
    v_ref = sum(vals[t] * c[idx + t] for t in range(4))
    d_ref = sum(ders[t] * c[idx + t] for t in range(4))
    cvals, cders, cidx = ts._cardinal4(r, spec_c)
    u = torch.as_tensor(uc)
    _close(v_ref, sum(cvals[t] * u[cidx + t] for t in range(4)))
    _close(d_ref, sum(cders[t] * u[cidx + t] for t in range(4)), 1e-9)
    # the torch blends equal the JAX blends
    jv, jd, jidx = pt._cardinal4(jnp.asarray(r.numpy()),
                                 pt.LegSpec(*spec_c))
    assert np.array_equal(np.asarray(jidx), cidx.numpy())
    for a, b in zip(jv + jd, cvals + cders):
        _close(a, b)
    # non-uniform knots have no cardinal form
    pts = np.array([1.0, 2.0, 3.5, 4.0, 5.5])
    seq = np.concatenate([[1.0] * 3, pts, [5.5] * 3])
    assert ts.cardinal_coefficients(seq, np.ones(7)) is None


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_basis_window_hi(strategy):
    _, spec_j, spec_t = _specs(strategy)
    for r_hi in (2.0, 3.5, 5.4):
        assert ts.basis_window_hi(spec_t, r_hi) \
            == pt.basis_window_hi(spec_j, r_hi)


def test_switch_poly():
    r = _radii(3)
    sj_, dsj = pt._switch_poly(jnp.asarray(r), 2.5, 3.5)
    st, dst = ts._switch_poly(torch.as_tensor(r), 2.5, 3.5)
    _close(sj_, st)
    _close(dsj, dst)


def _horner_dense(r, valid, spec, table):
    """The trio kernel's basis arithmetic in plain torch: the interval
    lookup floor((transform(r) - u0) * (1 / h)) clamped, Horner on that
    interval's row of ``table`` (ops/splines.horner_table's layout), the
    inclusive range gate; scattered into dense (..., n_basis) values and
    derivatives."""
    idx = torch.clamp(torch.floor((ts._transform(spec, r) - spec.u0)
                                  * (1.0 / spec.h)), 0, spec.n_int - 1)
    idx = idx.to(torch.int64)
    row = torch.as_tensor(table)[idx]                   # (..., 20)
    u = (r - row[..., 0]) * row[..., 1]
    u4 = u[..., None]
    beta = row[..., 4:20].unflatten(-1, (4, 4))         # [tap, power]
    val = ((beta[..., 3] * u4 + beta[..., 2]) * u4
           + beta[..., 1]) * u4 + beta[..., 0]
    der = (((3.0 * beta[..., 3]) * u4 + 2.0 * beta[..., 2]) * u4
           + beta[..., 1]) * row[..., 1:2]
    gate = valid * (r >= spec.t_min) * (r <= spec.t_max)
    dense = torch.zeros(r.shape + (spec.n_basis,), dtype=r.dtype)
    dense_d = torch.zeros_like(dense)
    taps = idx[..., None] + torch.arange(4)
    dense.scatter_(-1, taps, val * gate[..., None])
    dense_d.scatter_(-1, taps, der * gate[..., None])
    return dense, dense_d


def _hand_spec(kind, lo=1.5, hi=5.5, n_int=9):
    """A closed-form LegSpec of kind 1-3 written out by hand."""
    fwd = {ts.LAMMPS: np.square, ts.GEOMETRIC: np.log,
           ts.INVERSE: lambda x: 1.0 / x}[kind]
    u_lo, u_hi = fwd(lo), fwd(hi)
    return ts.LegSpec(kind, float(u_lo), float((u_hi - u_lo) / n_int),
                      n_int, lo, hi, n_int + 3)


@pytest.mark.parametrize("kind", [ts.LINEAR, ts.LAMMPS, ts.GEOMETRIC,
                                  ts.INVERSE])
def test_horner_tables_match_dense_basis(kind):
    """The per-leg tables the trio kernel evaluates equal the twin's de
    Boor bases in float64 to 1e-12, at random r across [t_min, t_max],
    at every knot, at both clamped ends and outside the range."""
    if kind == ts.LINEAR:  # the bench model's third leg
        spec = ts.leg_spec_from_knots(kn.get_knot_spacer("linear")(
            1.5, 7.0, 12))[1]
    else:
        spec = _hand_spec(kind)
    assert spec.kind == kind
    table = ts.horner_table(spec)
    assert table.shape == (spec.n_int, ts.HORNER_WIDTH)
    knots = ts.horner_table(spec)[:, 0]
    rng = np.random.RandomState(kind)
    r = torch.as_tensor(np.concatenate([
        rng.uniform(spec.t_min, spec.t_max, 997), knots,
        [spec.t_min, spec.t_max, spec.t_min - 0.1, spec.t_max + 0.1]]))
    valid = torch.as_tensor((rng.rand(r.shape[0]) > 0.1).astype(np.float64))
    dense, dense_d = _horner_dense(r, valid, spec, table)
    ref, ref_d = ts._dense_basis(r, valid, spec)
    assert float(torch.abs(dense - ref).max()) <= 1e-12
    assert float(torch.abs(dense_d - ref_d).max()) <= 1e-12
    assert float(torch.abs(ref[-4:-2]).max()) > 0.5   # clamped ends
    assert float(torch.abs(dense[-2:]).max()) == 0.0  # outside the range
