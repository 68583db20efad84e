"""
The plain versions of the fragment kernels (uf3_tpu_torch/ops/
fragments.py; the kernels of csrc/fragments.cu are held to them in
tests/test_torch_kernels.py) against the TPU probes' own Pallas bodies,
run through ``pl.pallas_call(..., interpret=True)`` with the probes'
VMEM specs on the same seeded numpy inputs.  Each body is copied verbatim
from ``benchmarks/probe_mosaic.py`` or ``benchmarks/probe_gather2.py``
(cited by line): the scripts cannot be imported (they re-exec at import,
``probe_mosaic.py:19-24``, and build their kernels inside ``main``).
The bodies that close over the probe's module constants BA, K and LANES
(``probe_mosaic.py:35-36``) get them from the test's shape: BA = 32, K =
16, and K = 8 for the sums and the maps.

Tolerances:
- relayout (pure copies), the one-hots and ``k_multi``: exact.
- the r-chain: 2 ulp of |out|.
- the K x K sums, the product and the grid-scalar sum (a sum of nine
  products): 1e-6 (float32; 2e-15 in float64) of the sum of the terms'
  magnitudes, because XLA's reduce and dot fix no order and XLA's CPU
  backend contracts ``acc + g x`` into fused multiply-adds.
- the cardinal chain: 2 ulp of |out| and of the cubic term, plus the
  cubic's slope times 2 ulp of t.  XLA's CPU backend computes t = 2.5 x +
  4 as one fused multiply-add where the plain version (and the card's
  kernel, bit for bit) rounds the product first; where t lands next to
  an interval boundary the two ts differ by an ulp of 4 and u = t - i
  carries that difference at full size.

Edge inputs beside the probes' draws: one-hot indices -1, 9, 11, 12 and
the int32 extremes (the port counts 0 outside [0, 12), where the probe's
own check, "all ones", holds only for its draws in [0, 9)); values 0, -0,
+-1, +-1e-20 (float64), +-inf, NaN, +-1e30 and the cardinal's interval
edges.  XLA compiles the 2-D one-hot's ``(idx == w) * x`` as a select
(an infinite x adds nothing where idx != w, where 0 * inf would give
NaN); the port does the same.  XLA's CPU backend flushes subnormals to
zero (as the TPU does), where the port keeps them (the card's kernels
are built without fast math), and its fused multiply-adds never round
an overflowing product to infinity: on subnormal inputs or
intermediates (x = 1e-40, 1e-45, and +-1e-20 in float32, whose square
is) and on products past the largest float the plain versions are held
instead to numpy's evaluation of the probe's expression, operation by
operation in the probe's order: exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from uf3_tpu_torch.benchmarks import probe_mosaic
from uf3_tpu_torch.ops import fragments

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

BA = 32
DTYPES = [np.float32, np.float64]
SUM_TOL = {np.float32: 1e-6, np.float64: 2e-15}


def pallas(kernel, inputs, out_shape):
    """``try_kernel``'s call (``probe_mosaic.py:42-48``; the calls of
    ``probe_gather2.py`` and ``k_multi``'s (``:198-203``) are the same),
    in interpret mode; a list of out shapes gives a list of outputs."""
    many = isinstance(out_shape, list)
    shapes = [jax.ShapeDtypeStruct(*s)
              for s in (out_shape if many else [out_shape])]
    specs = [pl.BlockSpec(memory_space=pltpu.VMEM) for _ in shapes]
    call = pl.pallas_call(
        kernel,
        out_shape=tuple(shapes) if many else shapes[0],
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in inputs],
        out_specs=tuple(specs) if many else specs[0],
        interpret=True,
    )
    out = jax.jit(call)(*[jnp.asarray(a) for a in inputs])
    return [np.asarray(o) for o in out] if many else np.asarray(out)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _np(out):
    if isinstance(out, tuple):
        return [o.numpy() for o in out]
    return out.numpy()


def _same(body, ours):
    """Equal shapes, dtypes and values (NaN where the other has NaN)."""
    for a, b in zip(*(x if isinstance(x, list) else [x]
                      for x in (body, ours))):
        assert a.shape == b.shape and a.dtype == b.dtype, (
            a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _close(body, ours, tol):
    """NaN and infinities in the same places, the rest within ``tol``
    (elementwise)."""
    assert body.shape == ours.shape and body.dtype == ours.dtype
    finite = np.isfinite(ours)
    np.testing.assert_array_equal(np.isfinite(body), finite)
    np.testing.assert_array_equal(body[~finite], ours[~finite])
    with np.errstate(invalid="ignore"):
        err = np.abs(body.astype(np.float64) - ours.astype(np.float64))
    bad = finite & ~(err <= np.broadcast_to(tol, err.shape))
    assert not bad.any(), (body[bad][:5], ours[bad][:5], err[bad][:5])


def _ulp(a, dtype):
    return np.spacing(np.abs(a).astype(dtype)).astype(np.float64)


# -- relayout: the copies ---------------------------------------------------
def tile_lanes(rng, K, dtype):
    LANES = K * K
    x = rng.randn(BA, K).astype(dtype)
    # probe_mosaic.py:67-72 (#1)
    kernel = (lambda x_ref, o_ref: o_ref.__setitem__(
        slice(None), jnp.tile(x_ref[:], (1, K))))
    return (pallas(kernel, [x], ((BA, LANES), dtype)),
            fragments.relayout_torch(_t(x), "tile", reps=K))


def repeat_lanes(rng, K, dtype):
    LANES = K * K
    x = rng.randn(BA, K).astype(dtype)
    # probe_mosaic.py:75-80 (#2; crashed Mosaic)
    kernel = (lambda x_ref, o_ref: o_ref.__setitem__(
        slice(None), jnp.repeat(x_ref[:], K, axis=-1)))
    return (pallas(kernel, [x], ((BA, LANES), dtype)),
            fragments.relayout_torch(_t(x), "repeat", reps=K))


def pltpu_repeat(rng, K, dtype):
    LANES = K * K
    x = rng.randn(BA, K).astype(dtype)
    # probe_mosaic.py:83-88 (#3): pltpu.repeat tiles
    kernel = (lambda x_ref, o_ref: o_ref.__setitem__(
        slice(None), pltpu.repeat(x_ref[:], K, axis=1)))
    return (pallas(kernel, [x], ((BA, LANES), dtype)),
            fragments.relayout_torch(_t(x), "tile", reps=K))


def reshape_4d_index(rng, K, dtype):
    LANES = K * K
    h_flat = rng.randn(BA * K, 27).astype(dtype)

    # probe_mosaic.py:134-137 (#7; crashed Mosaic)
    def k_reshape4d(h_ref, o_ref):
        h4 = h_ref[:].reshape(BA, K, 3, 9)
        o_ref[:] = jnp.tile(h4[:, :, 1, :].reshape(BA, K * 9),
                            (1, 2))[:, :LANES]

    return (pallas(k_reshape4d, [h_flat], ((BA, LANES), dtype)),
            fragments.relayout_torch(_t(h_flat), "select", k=K, lanes=LANES))


def p2_reshape(rng, K, dtype):
    x_np = rng.randn(128, 128).astype(dtype)

    # probe_gather2.py:118-119
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:].reshape(1024, 16)

    return (pallas(kernel, [x_np], ((1024, 16), dtype)),
            fragments.relayout_torch(_t(x_np), "reshape", shape=(1024, 16)))


def p3_transpose(rng, K, dtype):
    x_np = rng.randn(16, 128).astype(dtype)

    # probe_gather2.py:136-137
    def kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:].T

    return (pallas(kernel, [x_np], ((128, 16), dtype)),
            fragments.relayout_torch(_t(x_np), "transpose"))


def p5_repeat_tile(rng, K, dtype):
    x_np = rng.randn(256, 16).astype(dtype)

    # probe_gather2.py:153-156: two outputs, pltpu.repeat (which tiles)
    # and jnp.tile
    def kernel(x_ref, o_rep_ref, o_tile_ref):
        x = x_ref[:]
        o_rep_ref[:] = pltpu.repeat(x, 16, axis=1)
        o_tile_ref[:] = jnp.tile(x, (1, 16))

    return (pallas(kernel, [x_np], [((256, 256), dtype)] * 2),
            list(fragments.relayout_torch(_t(x_np), "tile", reps=16,
                                          pair=True)))


def p5b_jnp_repeat(rng, K, dtype):
    x_np = rng.randn(256, 16).astype(dtype)

    # probe_gather2.py:180-181
    def kernel(x_ref, o_ref):
        o_ref[:] = jnp.repeat(x_ref[:], 16, axis=1)

    return (pallas(kernel, [x_np], ((256, 256), dtype)),
            fragments.relayout_torch(_t(x_np), "repeat", reps=16))


RELAYOUT = [tile_lanes, repeat_lanes, pltpu_repeat, reshape_4d_index,
            p2_reshape, p3_transpose, p5_repeat_tile, p5b_jnp_repeat]


@pytest.mark.parametrize("case", RELAYOUT, ids=lambda f: f.__name__)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_relayout_matches_pallas(case, dtype):
    """The index maps copy what the Pallas bodies copy, bit for bit."""
    body, ours = case(np.random.RandomState(7), 16, dtype)
    _same(body, [o.numpy() for o in ours] if isinstance(ours, list)
          else ours.numpy())


def test_pltpu_repeat_tiles():
    """``pltpu.repeat`` tiles in interpret mode, as probe_gather2.py's p5
    records (``:170-175``): #2 and #3 of probe_mosaic.py differ exactly
    there, so each is held to its body, not to its name."""
    body, _ = pltpu_repeat(np.random.RandomState(7), 16, np.float32)
    rep, _ = repeat_lanes(np.random.RandomState(7), 16, np.float32)
    tile, _ = tile_lanes(np.random.RandomState(7), 16, np.float32)
    np.testing.assert_array_equal(body, tile)
    assert not np.array_equal(body, rep)


# -- lane_contract: the sums and the product ----------------------------------
def matmul_tiny_k3(rng, K, dtype):
    m_small = rng.randn(3, 27).astype(dtype)
    a3 = rng.randn(BA * K, 3).astype(dtype)
    # probe_mosaic.py:120-125 (#6)
    kernel = (lambda x_ref, w_ref, o_ref: o_ref.__setitem__(
        slice(None), jnp.dot(x_ref[:], w_ref[:],
                             preferred_element_type=jnp.float32)))
    return (pallas(kernel, [a3, m_small], ((BA * K, 27), dtype)),
            fragments.lane_contract_torch(_t(a3), "matmul", _t(m_small)),
            fragments.lane_contract_torch(_t(np.abs(a3)), "matmul",
                                          _t(np.abs(m_small))))


def reshape_kk_reduce(rng, K, dtype):
    a256 = rng.randn(BA, K * K).astype(dtype)

    # probe_mosaic.py:143-144 (#8; crashed Mosaic)
    def k_reduce_kk(x_ref, o_ref):
        o_ref[:] = jnp.sum(x_ref[:].reshape(BA, K, K), axis=2)

    return (pallas(k_reduce_kk, [a256], ((BA, K), dtype)),
            fragments.lane_contract_torch(_t(a256), "sum_axis2"),
            fragments.lane_contract_torch(_t(np.abs(a256)), "sum_axis2"))


def reshape_kk_reduce_ax1(rng, K, dtype):
    a256 = rng.randn(BA, K * K).astype(dtype)

    # probe_mosaic.py:152-153 (#9; crashed Mosaic)
    def k_reduce_kk1(x_ref, o_ref):
        o_ref[:] = jnp.sum(x_ref[:].reshape(BA, K, K), axis=1)

    return (pallas(k_reduce_kk1, [a256], ((BA, K), dtype)),
            fragments.lane_contract_torch(_t(a256), "sum_axis1"),
            fragments.lane_contract_torch(_t(np.abs(a256)), "sum_axis1"))


CONTRACT = [(reshape_kk_reduce, k, d) for k in (16, 8) for d in DTYPES] + [
    (reshape_kk_reduce_ax1, k, d) for k in (16, 8) for d in DTYPES] + [
    (matmul_tiny_k3, k, np.float32) for k in (16, 8)]


@pytest.mark.parametrize("case, K, dtype", CONTRACT, ids=lambda v: getattr(
    v, "__name__", str(v)))
def test_lane_contract_matches_pallas(case, K, dtype):
    """The loops over t against XLA's reduce and dot: within 1e-6
    (float32) of the sum of the terms' magnitudes."""
    body, ours, scale = case(np.random.RandomState(11), K, dtype)
    _close(body, ours.numpy(), SUM_TOL[dtype] * scale.numpy())


def test_lane_contract_sums_in_order():
    """The plain sums add the terms in t order: on terms whose sum
    depends on the order (1, 1e8, -1e8 in float32) the result is the
    left fold's."""
    x = np.zeros((1, 16), np.float32)
    x[0, :3] = [1.0, 1e8, -1e8]
    out = fragments.lane_contract_torch(_t(x), "sum_axis2")
    assert out[0, 0].item() == 0.0          # (1 + 1e8) - 1e8 in float32
    out = fragments.lane_contract_torch(_t(x.reshape(4, 4).T.reshape(1, 16)),
                                        "sum_axis1")
    assert out[0, 0].item() == 0.0


# -- lane_map: the one-hots and the chains ------------------------------------
def onehot_3d_middle(idx):
    BA, LANES = idx.shape

    # probe_mosaic.py:95-99 (#4)
    def k_onehot3d(i_ref, o_ref):
        ext = (jax.lax.broadcasted_iota(
            jnp.int32, (BA, 12, LANES), 1)
            == i_ref[:][:, None, :]).astype(jnp.float32)
        o_ref[:] = jnp.sum(ext, axis=1)

    return (pallas(k_onehot3d, [idx], ((BA, LANES), jnp.float32)),
            fragments.lane_map_torch("onehot_count", idx=_t(idx)).numpy())


def onehot_2d_unrolled(idx, x):
    BA, LANES = x.shape

    # probe_mosaic.py:107-112 (#5)
    def k_onehot2d(i_ref, x_ref, o_ref):
        acc = jnp.zeros((BA, LANES), jnp.float32)
        for w in range(9):
            oh = (i_ref[:] == w).astype(jnp.float32)
            acc = acc + oh * x_ref[:] * float(w + 1)
        o_ref[:] = acc

    return (pallas(k_onehot2d, [idx, x], ((BA, LANES), x.dtype)),
            fragments.lane_map_torch("onehot_sum", _t(x), idx=_t(idx)).numpy())


def cardinal_interval(x):
    BA, LANES = x.shape

    # probe_mosaic.py:161-166 (#10)
    def k_cardinal(x_ref, o_ref):
        t = x_ref[:] * 2.5 + 4.0
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, 8)
        u = t - i.astype(jnp.float32)
        o_ref[:] = u * u * (3.0 - 2.0 * u) + i.astype(jnp.float32)

    return (pallas(k_cardinal, [x], ((BA, LANES), x.dtype)),
            fragments.lane_map_torch("cardinal", _t(x)).numpy())


def multi_output(x):
    BA, LANES = x.shape

    # probe_mosaic.py:196-198 (#13, call :200)
    def k_multi(x_ref, o1_ref, o2_ref):
        o1_ref[:] = x_ref[:] * 2.0
        o2_ref[:] = x_ref[:] + 1.0

    return (pallas(k_multi, [x], [((BA, LANES), x.dtype)] * 2),
            _np(fragments.lane_map_torch("multi", _t(x))))


def grid3_scalar_index(x, grid3):
    BA, LANES = x.shape

    # probe_mosaic.py:214-219 (#14)
    def k_grid3(g_ref, x_ref, o_ref):
        acc = jnp.zeros((BA, LANES), jnp.float32)
        for b in range(3):
            for c in range(3):
                acc = acc + g_ref[b, b, c] * x_ref[:]
        o_ref[:] = acc

    return (pallas(k_grid3, [grid3, x], ((BA, LANES), x.dtype)),
            fragments.lane_map_torch("grid3", _t(x), grid=_t(grid3)).numpy())


def sqrt_where_div(x):
    BA, LANES = x.shape

    # probe_mosaic.py:225-229 (#15)
    def k_rchain(x_ref, o_ref):
        r2 = x_ref[:] * x_ref[:]
        r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
        o_ref[:] = x_ref[:] / r

    return (pallas(k_rchain, [x], ((BA, LANES), x.dtype)),
            fragments.lane_map_torch("rchain", _t(x)).numpy())


def _grid(dtype):
    return np.random.RandomState(3).randn(9, 9, 15).astype(dtype)


def _cardinal_tol(x, dtype):
    """2 ulp of |out| and of the cubic term c(u) = u u (3 - 2u), plus what
    an error d of 2 ulp of t (the fused multiply-add's t against the
    rounded product's) makes of the cubic: |c'(u)| d + |c''(u)| d^2 / 2,
    c' = 6u(1 - u), c'' = 6 - 12u (the second-order term rules where u
    is next to 0)."""
    with np.errstate(invalid="ignore", over="ignore"):
        x = x.astype(dtype)
        t = x * dtype(2.5) + dtype(4.0)
        i = np.clip(np.floor(t), 0, 8)
        u = t - i
        cubic = u * u * (dtype(3.0) - dtype(2.0) * u)
        u64 = u.astype(np.float64)
        d = 2 * _ulp(np.maximum(np.abs(t), np.abs(x * dtype(2.5))), dtype)
        return (2 * (_ulp(cubic + i, dtype) + _ulp(cubic, dtype))
                + np.abs(6 * u64 * (1 - u64)) * d
                + np.abs(6 - 12 * u64) * d * d / 2)


def _check_map(op, x=None, idx=None, dtype=np.float32):
    """The op's plain version against its Pallas body, at the op's
    tolerance."""
    if op == "onehot_count":
        _same(*onehot_3d_middle(idx))
    elif op == "onehot_sum":
        _same(*onehot_2d_unrolled(idx, x))
    elif op == "multi":
        _same(*multi_output(x))
    elif op == "rchain":
        body, ours = sqrt_where_div(x)
        _close(body, ours, 2 * _ulp(ours, dtype))
    elif op == "grid3":
        grid = _grid(dtype)
        body, ours = grid3_scalar_index(x, grid)
        scale = np.abs(x) * sum(abs(grid[b, b, c]) for b in range(3)
                                for c in range(3))
        _close(body, ours, SUM_TOL[dtype] * scale)
    else:
        body, ours = cardinal_interval(x)
        _close(body, ours, _cardinal_tol(x, dtype))


OPS = list(fragments.LANE_MAP_OPS)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("K", [16, 8])
def test_lane_map_matches_pallas(op, K):
    """Each chain on the probe's draws (normal values, indices in [0,
    9)), float32."""
    rng = np.random.RandomState(13 + K)
    idx = rng.randint(0, 9, size=(BA, K * K)).astype(np.int32)
    x = rng.randn(BA, K * K).astype(np.float32)
    _check_map(op, x, idx)


@pytest.mark.parametrize("op", [op for op in OPS if op != "onehot_count"])
def test_lane_map_matches_pallas_f64(op):
    rng = np.random.RandomState(17)
    idx = rng.randint(0, 9, size=(BA, 256)).astype(np.int32)
    x = rng.randn(BA, 256)
    _check_map(op, x, idx, np.float64)


EDGE_VALUES = [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e30, -1e30,
               -1.6, 1.6, 2.0, -2.0, 0.4]
EDGE_INDICES = [-1, 9, 11, 12, 0, 8, 2 ** 31 - 1, -2 ** 31]


def _place(rng, a, values):
    """``a`` with ``values`` at random places, each at least once."""
    flat = a.reshape(-1)
    places = rng.permutation(flat.size)[:4 * len(values)]
    flat[places] = np.resize(np.asarray(values, a.dtype), places.size)
    return a


# the one-hots in float64 only on the probe's draws: the count takes no
# values, and the 2-D one-hot's body in float64 is another program (its
# one-hot stays float32 and is converted, and XLA then keeps 0 * inf)
MAP_EDGES = [(op, d) for op in OPS for d in DTYPES
             if not (op.startswith("onehot") and d == np.float64)]


@pytest.mark.parametrize("op, dtype", MAP_EDGES, ids=lambda v: getattr(
    v, "__name__", str(v)))
def test_lane_map_edges(op, dtype):
    """Indices outside the probe's [0, 9) (the 3-D one-hot counts 0
    outside [0, 12); the 2-D one-hot adds nothing outside [0, 9)) and
    zeros, infinities, NaN, huge values and the cardinal's interval
    edges: the r-chain's where branch at x = 0; +-1e-20 in float64."""
    rng = np.random.RandomState(19)
    values = EDGE_VALUES + ([1e-20, -1e-20] if dtype == np.float64 else [])
    x = _place(rng, rng.randn(BA, 64).astype(dtype), values)
    idx = _place(rng, rng.randint(0, 9, size=(BA, 64)).astype(np.int32),
                 EDGE_INDICES)
    _check_map(op, x, idx, dtype)
    if op == "onehot_count":
        ours = fragments.lane_map_torch("onehot_count", idx=_t(idx)).numpy()
        np.testing.assert_array_equal(ours, ((idx >= 0) & (idx < 12))
                                      .astype(np.float32))


def _numpy_chain(op, x, idx, grid):
    """The probe's expression in numpy, operation by operation in its
    order (numpy keeps subnormals)."""
    dtype = x.dtype.type
    if op == "onehot_sum":
        acc = np.zeros_like(x)
        for w in range(9):
            acc = acc + np.where(idx == w, x, dtype(0)) * dtype(w + 1)
        return acc
    if op == "cardinal":
        t = x * dtype(2.5) + dtype(4.0)
        i = np.clip(np.floor(t), 0, 8)
        u = t - i
        return u * u * (dtype(3.0) - dtype(2.0) * u) + i
    if op == "grid3":
        acc = np.zeros_like(x)
        for b in range(3):
            for c in range(3):
                acc = acc + grid[b, b, c] * x
        return acc
    if op == "rchain":
        r2 = x * x
        return x / np.sqrt(np.where(r2 > 0, r2, dtype(1.0)))
    return [x * dtype(2.0), x + dtype(1.0)]


# subnormal inputs, or inputs whose square is subnormal or underflows
# (the r-chain's where branch), and values whose products overflow
IEEE_EDGES = {
    np.float32: [1e-40, -1e-40, 1e-45, 1e-20, -1e-20, 3e-39, 1.1754944e-38,
                 np.finfo(np.float32).max, -np.finfo(np.float32).max, 1e38],
    np.float64: [1e-310, -1e-310, 5e-324, 1e-160, -1e-160, 1e-200,
                 np.finfo(np.float64).max, -np.finfo(np.float64).max]}


@pytest.mark.parametrize("op", [op for op in OPS if op != "onehot_count"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_lane_map_ieee_edges(op, dtype):
    """Where XLA's CPU backend departs from rounding each operation once:
    it flushes subnormal inputs and results to zero (as the TPU does) and
    fuses ``acc + g x`` into one multiply-add, in which a product past
    the largest float never rounds to infinity.  There the plain version
    equals numpy's evaluation of the probe's expression, operation by
    operation in its order, exactly (subnormals kept, each product
    rounded): the arithmetic of the card's kernels."""
    rng = np.random.RandomState(23)
    x = _place(rng, rng.randn(4, 64).astype(dtype), IEEE_EDGES[dtype])
    idx = rng.randint(0, 9, size=x.shape).astype(np.int32)
    grid = _grid(dtype)
    assert (np.abs(x) < np.finfo(dtype).tiny).any()
    ours = fragments.lane_map_torch(
        op, _t(x), idx=_t(idx) if op == "onehot_sum" else None,
        grid=_t(grid) if op == "grid3" else None)
    with np.errstate(invalid="ignore", over="ignore"):
        _same(_numpy_chain(op, x, idx, grid), _np(ours))


# -- the wrappers on the CPU, and the measurement script ----------------------
def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    rng = np.random.RandomState(29)
    x16, x256 = _t(rng.randn(8, 16)), _t(rng.randn(8, 256))
    idx = _t(rng.randint(-1, 13, size=(8, 256)).astype(np.int32))
    counts = [fn.launches for fn in fragments.KERNELS.values()]
    assert torch.equal(fragments.relayout(x16, "repeat", reps=16),
                       fragments.relayout_torch(x16, "repeat", reps=16))
    assert torch.equal(fragments.lane_contract(x256, "sum_axis1"),
                       fragments.lane_contract_torch(x256, "sum_axis1"))
    for a, b in zip(fragments.lane_map("multi", x256),
                    fragments.lane_map_torch("multi", x256)):
        assert torch.equal(a, b)
    out = fragments.lane_map("onehot_count", idx=idx, dtype=torch.float64)
    assert out.dtype == torch.float64
    assert torch.equal(out, fragments.lane_map_torch(
        "onehot_count", idx=idx, dtype=torch.float64))
    assert counts == [fn.launches for fn in fragments.KERNELS.values()]


def test_wrappers_reject_bad_operands():
    """A wrong dtype, a shape the mode does not take or a missing operand
    raises before any launch, on any device."""
    x = torch.zeros((8, 16))
    with pytest.raises(TypeError, match="float32 or float64"):
        fragments.relayout(x.half(), "tile", reps=2)
    with pytest.raises(ValueError, match="2-D"):
        fragments.relayout(x[None], "transpose")
    with pytest.raises(ValueError, match="no mode"):
        fragments.relayout(x, "rotate")
    with pytest.raises(ValueError, match="select takes"):
        fragments.relayout(torch.zeros((15, 27)), "select", k=16, lanes=256)
    with pytest.raises(ValueError, match="K\\*K"):
        fragments.lane_contract(torch.zeros((8, 15)), "sum_axis2")
    with pytest.raises(ValueError, match="matmul takes"):
        fragments.lane_contract(x, "matmul", torch.zeros((3, 27)))
    with pytest.raises(TypeError, match="operands of"):
        fragments.lane_contract(torch.zeros((8, 3)), "matmul",
                                torch.zeros((3, 27), dtype=torch.float64))
    with pytest.raises(ValueError, match="takes \\['x', 'grid'\\]"):
        fragments.lane_map("grid3", x)
    with pytest.raises(TypeError, match="int32 indices"):
        fragments.lane_map("onehot_sum", x, idx=x.long())
    with pytest.raises(TypeError, match="float32 or float64"):
        fragments.lane_map("cardinal", x.long())


def test_probe_mosaic_main_on_the_cpu(tmp_path):
    """The measurement script at a cap of 64 rows on the CPU: every case
    at both sizes, every one correct (the script raises otherwise), the
    device times null, the bounds from the shapes."""
    art = probe_mosaic.main(device="cpu", max_rows=64, out_dir=str(tmp_path),
                            commit="test")
    assert (tmp_path / "probe_mosaic.json").exists()
    assert set(art["cases"]) == {c.name for c in probe_mosaic.CASES}
    assert len(art["cases"]) == 17
    for name, sizes in art["cases"].items():
        assert set(sizes) == {"probe", "full"}
        for rec in sizes.values():
            assert rec["correct"] and rec["max_abs_err"] == 0.0, name
            assert rec["kernel_ms"] is None and rec["reached"] is None
            assert rec["bound_ms"] > 0 and rec["bound_by"] == "bytes"
    rec = art["cases"]["probe_mosaic.matmul_tiny_k3"]["probe"]
    assert rec["inputs"] == [[1024, 3], [3, 27]]
    assert rec["flops"] == 2 * 3 * 1024 * 27
    # (64 x 16 in, 64 x 256 out) float32, read and written once
    rec = art["cases"]["probe_gather2.p5b_jnp_repeat"]["full"]
    assert rec["bytes"] == 4 * (64 * 16 + 64 * 256)
