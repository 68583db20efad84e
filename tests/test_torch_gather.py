"""
The plain versions of the neighbor-gather kernels (uf3_tpu_torch/
ops/gather.py; the kernels of csrc/gather.cu are held to them in
tests/test_torch_kernels.py) against the JAX side on the same numpy
inputs, made from a seed: the XLA ops the TPU probes' Pallas kernels
lower (``jnp.take_along_axis`` on the CPU), ``uf3_tpu``'s own row gather
``pallas_trio.gather_rows_blocks`` on the flats of ``blockify_columns``
(the engine's neighbor gather and its packed reverse-slot assembly),
and the numpy expressions the probes check against (``x[idx]``,
``np.take_along_axis``).  A gather copies values, so the tolerance is
0: every comparison is exact.

Row gathers cover tables of 1 to 8 columns, int32 and int64 indices,
float32 and float64, self-padded slots (a padded slot points at its own
row, as the neighbor lists pad) and the transposed (K, N) index of
``probe_dg2.py``.  The reverse-slot gather is held to the rows that the
port's assembly gathers (``ops/trio.py``'s ``part.reshape(-1, 5)
[rev_flat]``) on a real 3-body list with padded slots.

The wrappers' choice of kernel instance, ``gather.gather_plan``, is a
plain function of shapes, element sizes and alignments, tested here for
each branch; the position gather through a list of the port's builder
is held to ``positions[nbr.idx]`` bit for bit, and the port's
``cached_displacements`` on it to the JAX engine's ``displacements``
within 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.ops import gather
from uf3_tpu_torch.ops import neighbors as nb

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]
INDEX_DTYPES = [(np.int32, torch.int32), (np.int64, torch.int64)]


def _padded_index(rng, n_rows, shape, n_pad):
    """Uniform indices over ``n_rows`` rows; in each row of ``shape``
    (N, K) the last ``n_pad`` slots point at the row itself, as a
    self-padded neighbor list's do."""
    idx = rng.randint(0, n_rows, size=shape)
    if n_pad:
        idx[:, -n_pad:] = (np.arange(shape[0]) % n_rows)[:, None]
    return idx


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("n, k, w, n_pad", [
    (64, 16, 3, 0),      # positions at the 3-body list's width
    (53, 16, 3, 5),      # ragged, with self-padded slots
    (40, 72, 8, 20),     # proto_pallas_gather's (N, 8) table, 72 slots
    (128, 16, 1, 4),     # a broadcast column (the probes' W = 1)
    (17, 23, 5, 7),      # the port's packed partials, one-tier width
])
@pytest.mark.parametrize("np_dtype, dtype", DTYPES)
@pytest.mark.parametrize("np_index, index_dtype", INDEX_DTYPES)
def test_gather_rows_matches_jax(n, k, w, n_pad, np_dtype, dtype, np_index,
                                 index_dtype):
    rng = np.random.RandomState(n * 131 + k)
    table = rng.randn(n, w).astype(np_dtype)
    idx = _padded_index(rng, n, (n, k), n_pad).astype(np_index)
    ours = gather.gather_rows_torch(_t(table), _t(idx, index_dtype))
    _same(table[idx], ours)
    _same(ours, gather.gather_rows(_t(table), _t(idx, index_dtype)))
    # uf3_tpu's engine gather: blocked flat takes of the (K, N) columns
    jidx = jnp.asarray(idx)
    _same(pt.gather_rows_blocks(jnp.asarray(table),
                                pt.blockify_columns(jidx.T), n), ours)
    # the transposed (K, N) index of probe_dg2.py
    ours_t = gather.gather_rows_torch(_t(table), _t(idx.T, index_dtype))
    _same(table[idx.T], ours_t)
    # the probes' form of a component: a column broadcast across the
    # slots, then take_along_axis along the rows (axis 0), or along the
    # lanes (axis 1) in the transposed layout
    col = jnp.asarray(table[:, -1:])
    _same(jnp.take_along_axis(jnp.broadcast_to(col, (n, k)), jidx, axis=0),
          ours[..., -1])
    _same(jnp.take_along_axis(jnp.broadcast_to(col.reshape(1, n), (k, n)),
                              jidx.T, axis=1), ours_t[..., -1])


@pytest.mark.parametrize("a, width, b", [
    (64, 16, 16),     # probe_dynamic_gather.py's kernel1, probe_mosaic's #11
    (32, 128, 16),    # probe_gather2.py's p4: a wide table, 16 lanes
    (9, 1280, 16),    # probe_wg.py's widest table
    (16, 256, 256),   # probe_mosaic's #12
])
@pytest.mark.parametrize("np_dtype, dtype", DTYPES)
@pytest.mark.parametrize("np_index, index_dtype", INDEX_DTYPES)
def test_gather_lanes_matches_jax(a, width, b, np_dtype, dtype, np_index,
                                  index_dtype):
    rng = np.random.RandomState(a * 7 + width)
    t = rng.randn(a, width).astype(np_dtype)
    li = rng.randint(0, width, size=(a, b)).astype(np_index)
    ours = gather.gather_lanes_torch(_t(t), _t(li, index_dtype))
    _same(np.take_along_axis(t, li, axis=1), ours)
    _same(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(li), axis=1),
          ours)
    _same(ours, gather.gather_lanes(_t(t), _t(li, index_dtype)))


@pytest.mark.parametrize("n, k, w, n_pad", [
    (64, 16, 5, 0),      # the port's packed partials (s1, s3', v3')
    (41, 16, 8, 6),      # uf3_tpu's 8-wide packed rows, padded slots
    (128, 16, 1, 3),     # probe_dg2.py's kernel_c (one value per slot)
])
@pytest.mark.parametrize("np_dtype, dtype", DTYPES)
@pytest.mark.parametrize("np_index, index_dtype", INDEX_DTYPES)
def test_rev_gather_matches_jax(n, k, w, n_pad, np_dtype, dtype, np_index,
                                index_dtype):
    rng = np.random.RandomState(n * 3 + w)
    part = rng.randn(n, k, w).astype(np_dtype)
    idx = _padded_index(rng, n, (n, k), n_pad).astype(np_index)
    rev = rng.randint(0, k, size=(n, k)).astype(np_index)
    if n_pad:
        rev[:, -n_pad:] = 0     # a padded slot's reverse slot is 0
    ours = gather.rev_gather_torch(_t(part), _t(idx, index_dtype),
                                   _t(rev, index_dtype))
    _same(part[idx, rev], ours)
    _same(ours, gather.rev_gather(_t(part), _t(idx, index_dtype),
                                  _t(rev, index_dtype)))
    # uf3_tpu's assembly gather: packed rows through idx * K + rev
    rev_flat = jnp.asarray(idx.astype(np.int64) * k + rev)
    _same(pt.gather_rows_blocks(jnp.asarray(part.reshape(-1, w)),
                                pt.blockify_columns(rev_flat.T), n), ours)
    # probe_dg2.py's kernel_c on the (K, N) slot-major layout
    if w == 1:
        p_t = part[..., 0].T                       # P[m, j]
        _same(p_t[rev.T, idx.T], gather.rev_gather_torch(
            _t(part), _t(idx.T, index_dtype), _t(rev.T, index_dtype))[..., 0])


@pytest.mark.parametrize("r, c, m", [(8, 128, 8), (8, 128, 256),
                                     (96, 16, 96)])
@pytest.mark.parametrize("np_index, index_dtype", INDEX_DTYPES)
def test_column_gather_is_rev_gather(r, c, m, np_index, index_dtype):
    """take_along_axis(axis=0) of a materialized (R, C) table
    (probe_dg3.py's table cases, probe_gather2.py's p6, probe_wg.py's
    P2) is the reverse-slot gather with the column as the slot."""
    rng = np.random.RandomState(r + c + m)
    t = rng.randn(r, c).astype(np.float32)
    idx = rng.randint(0, r, size=(m, c)).astype(np_index)
    cols = np.broadcast_to(np.arange(c), (m, c)).astype(np_index)
    ours = gather.rev_gather_torch(_t(t[..., None]), _t(idx, index_dtype),
                                   _t(cols, index_dtype))[..., 0]
    _same(np.take_along_axis(t, idx, axis=0), ours)
    _same(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(idx), axis=0),
          ours)


def test_rev_gather_is_the_assembly_gather():
    """On a real 3-body list with self-padded slots: the rows
    ``ops/trio.py``'s assembly gathers (``part.reshape(-1, 5)[rev_flat]``)
    and the JAX engine's packed-row gather of ``_assemble_forces``."""
    geom = bulk("W", "bcc", a=3.1652) * (3, 3, 3)
    geom.rattle(0.1, seed=3)
    pos = torch.as_tensor(geom.get_positions())
    cell = torch.as_tensor(np.asarray(geom.get_cell()))
    nbr2 = nb.build_neighbor_list_images(pos, cell, (True,) * 3, 5.5, 72)
    nbr3 = nb.filter_neighbor_list(nbr2, pos, cell, 4.0, 20)
    assert not bool(nbr3.mask.all()) and not bool(nbr3.overflow)
    n, k = nbr3.idx.shape
    cache = nb.list_cache(nbr3, cell, torch.float64)
    part = torch.as_tensor(np.random.RandomState(4).randn(n, k, 5))
    ours = gather.rev_gather_torch(part, nbr3.idx, nbr3.rev)
    _same(part.reshape(-1, 5)[cache.rev_flat], ours)
    _same(pt.gather_rows_blocks(
        jnp.asarray(part.reshape(-1, 5).numpy()),
        pt.blockify_columns(jnp.asarray(cache.rev_flat.numpy()).T), n), ours)
    _same(ours, gather.rev_gather(part, nbr3.idx.int(), nbr3.rev.int()))


def test_wrappers_check_shapes_and_count_bytes():
    """Bad operand shapes raise on every device; a CPU call launches
    nothing; the bound counts the indices read once, the output written
    once and, of the table, the 32-byte sectors the indices reach (at
    most the whole table)."""
    t = torch.zeros((6, 4))
    idx = torch.zeros((6, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\(R, W\) table"):
        gather.gather_rows(t[None], idx)
    with pytest.raises(ValueError, match=r"\(A, T\) and \(A, B\)"):
        gather.gather_lanes(t, idx[:5])
    with pytest.raises(ValueError, match="one shape"):
        gather.rev_gather(t[..., None], idx, idx[:, :2])
    with pytest.raises(TypeError, match="differ"):
        gather.rev_gather(t[..., None], idx, idx.int())
    launches = (gather.gather_rows.launches, gather.gather_lanes.launches,
                gather.rev_gather.launches)
    out = gather.gather_rows(t, idx)
    gather.gather_lanes(t, idx)
    gather.rev_gather(t[..., None], idx, idx)
    assert launches == (gather.gather_rows.launches,
                        gather.gather_lanes.launches,
                        gather.rev_gather.launches)
    # every index row 0: one sector of the (6, 4) float32 table
    assert gather.gather_bytes("rows", out, t, idx) == 32 + 6 * 3 * 8 + (
        6 * 3 * 4 * 4)
    ms, bound_by, n_bytes = gather.gather_bound("rows", out, t, idx)
    assert bound_by == "bytes" and n_bytes == 464
    assert ms == pytest.approx(1e3 * 464 / 3.35e12)
    # every row reached: the whole table
    every = torch.arange(6)
    assert gather.gather_bytes("rows", gather.gather_rows(t, every), t,
                               every) == 96 + 6 * 8 + 6 * 4 * 4
    # a table smaller than a sector counts its own bytes
    assert gather.gather_bytes("rows", torch.zeros(2, 3), torch.zeros(1, 3),
                               idx[0, :2]) == 12 + 16 + 24
    # a lane gather from a wide table: lanes 0 and 1 of row 0 (bytes
    # 0-7, sector 0), 63 and 40 of row 1 (bytes 508 and 416, sectors 15
    # and 13)
    wide = torch.zeros((2, 64))
    li = torch.tensor([[0, 1], [63, 40]])
    assert gather.gather_bytes("lanes", gather.gather_lanes(wide, li), wide,
                               li) == 3 * 32 + 4 * 8 + 4 * 4
    # a reverse-slot gather of one float64 row of 5: elements 35-39,
    # bytes 280-319, sectors 8 and 9
    part = torch.zeros((4, 2, 5), dtype=torch.float64)
    one, rev = torch.tensor([[3]]), torch.tensor([[1]])
    assert gather.gather_bytes("rev", gather.rev_gather(part, one, rev),
                               part, one, rev) == 2 * 32 + 8 + 8 + 5 * 8


@pytest.mark.parametrize("w, elem, kernel", [
    (1, 4, "rows_w1"), (3, 4, "rows_w3"), (4, 4, "rows_w4"),
    (8, 4, "rows_w8"), (1, 8, "rows_w2"), (3, 8, "rows_w6"),
    (4, 8, "rows_w8"), (8, 8, "rows_w16"), (5, 4, "rows_any"),
    (128, 4, "rows_wide"), (5, 8, "rows_any")])
@pytest.mark.parametrize("index_bytes", [4, 8])
def test_gather_plan_rows_by_width(w, elem, kernel, index_bytes):
    """The row gather's instance by the row's width in 32-bit words (an
    instance for 1, 2, 3, 4, 6, 8 and 16 words, rows_any for the others
    below 32, rows_wide from 32 on), 32-bit offsets at MD sizes, the
    table's alignment passed through."""
    plan = gather.gather_plan("rows", (9826, w), (9826, 72), elem,
                              index_bytes, 8)
    assert plan.kernel == kernel and not plan.wide
    assert plan.code == {"rows_any": 0, "rows_wide": gather.WIDE_WORDS}.get(
        kernel, w * elem // 4)
    assert plan.values_align == 8


def test_gather_plan_rows_one_instance_at_every_size():
    """The row instance depends on the width and offsets only, not on the
    count of entries: the step's 3-body list, the bench's pair list, the
    melting protocol's 31,104 x 88 list and 2^20 + 1 entries take the
    same W = 3 instance (a warp copies two groups of 32 entries at every
    size); rows_wide starts at 32 words, float32 or float64; and the plan
    is cached (one lookup a call)."""
    plan = gather.gather_plan
    plans = {plan("rows", (n, 3), shape, 4, 8) for n, shape in (
        (9826, (9826, 16)), (9826, (9826, 72)), (31104, (31104, 88)),
        (10, (2 ** 20 + 1,)))}
    assert plans == {gather.GatherPlan("rows_w3", 3, False, 16)}
    assert plan("rows", (10, 31), (7,), 4, 4).kernel == "rows_any"
    assert plan("rows", (10, 32), (7,), 4, 4).kernel == "rows_wide"
    assert plan("rows", (10, 16), (7,), 8, 4).kernel == "rows_wide"
    assert plan("rows", (10, 15), (7,), 8, 4).kernel == "rows_any"
    hits = gather._plan.cache_info().hits
    assert plan("rows", (9826, 3), (9826, 72), 4, 8) is plan(
        "rows", (9826, 3), (9826, 72), 4, 8)
    assert gather._plan.cache_info().hits >= hits + 2


@pytest.mark.parametrize("width, kernel", [
    (1, "lanes_shuffle"), (16, "lanes_shuffle"), (32, "lanes_shuffle"),
    (33, "lanes_direct"), (128, "lanes_direct"), (1280, "lanes_direct")])
@pytest.mark.parametrize("elem", [4, 8])
def test_gather_plan_lanes_by_table_width(width, kernel, elem):
    """The lane gather takes the warp-shuffle instance up to 32 lanes and
    one thread per output above; the shuffle's code is log2 of its lane
    group (T rounded up to a power of two), one thread per output's -1."""
    plan = gather.gather_plan("lanes", (9856, width), (9856, 16), elem, 4)
    assert plan.kernel == kernel and not plan.wide
    assert plan.code == {1: 0, 16: 4, 32: 5}.get(width, -1)
    assert gather.gather_plan("lanes", (10, 5), (10, 7), elem,
                              8).code == 3


def test_gather_plan_wide_offsets():
    """64-bit offsets only where an operand passes 2^31 - 1 words: the
    table (float64 counting twice), the output or the index; the lane
    gather then leaves the shuffle instance."""
    rows = gather.gather_plan
    assert not rows("rows", (2 ** 27, 8), (10,), 4, 8).wide
    assert rows("rows", (2 ** 28, 8), (10,), 4, 8).wide
    assert rows("rows", (2 ** 27, 8), (10,), 8, 8).wide
    assert rows("rows", (2 ** 27, 15), (10,), 4, 8).wide is False
    assert rows("rows", (2 ** 27, 16), (10,), 4, 8, 16).wide
    assert rows("rows", (100, 3), (2 ** 30,), 4, 8).wide
    assert rows("rows", (100, 1), (2 ** 31 - 1,), 4, 8).wide is False
    lanes = rows("lanes", (2 ** 26, 32), (2 ** 26, 32), 4, 4)
    assert lanes.wide and lanes.kernel == "lanes_direct"
    assert rows("lanes", (2 ** 25, 32), (2 ** 25, 32), 8, 4).wide
    with pytest.raises(ValueError, match="no instances"):
        rows("rev", (10, 3), (10,), 4, 4)
    with pytest.raises(ValueError, match="sizes 4 or 8"):
        rows("rows", (10, 3), (10,), 2, 4)


def test_gather_plan_reads_alignment_and_row_stride():
    """``rows_plan`` reads the alignment off the table's pointer and row
    width in bytes: a view one element past an aligned start, rows of 3
    float32 words (12 bytes: word loads), and a view that is not
    contiguous (the wrapper copies it to a new allocation, so only the
    row width counts)."""
    assert [gather.alignment(b) for b in (0, 48, 24, 12, 6)] == [
        16, 16, 8, 4, 1]
    assert gather.alignment(32, 12) == 4
    for dtype, elem in ((torch.float32, 4), (torch.float64, 8)):
        base = torch.zeros(4 * 100 + 1, dtype=dtype)
        assert base.data_ptr() % 16 == 0
        idx = torch.zeros(65, dtype=torch.int64)
        plan = gather.rows_plan(base[:400].view(100, 4), idx)
        assert (plan.kernel, plan.values_align) == (
            f"rows_w{4 * elem // 4}", 16)
        plan = gather.rows_plan(base[1:].view(100, 4), idx[1:])
        assert plan.values_align == elem
        plan = gather.rows_plan(base[:300].view(100, 3), idx)
        assert plan.values_align == gather.alignment(3 * elem)
        wide = base[:400].view(100, 4)
        assert not wide[:, :3].is_contiguous()
        plan = gather.rows_plan(wide[:, :3], idx)
        assert plan.code == 3 * elem // 4
        assert plan.values_align == gather.alignment(3 * elem)
        plan = gather.rows_plan(wide[:, 1:].t(), idx)
        assert plan.kernel == "rows_wide"
        assert plan.values_align == gather.alignment(100 * elem)


def test_position_gather_on_the_port_lists():
    """The engine's position gather through the lists the port's builder
    makes on bcc W (the bench's two-tier lists, the defaults' one-tier
    list): ``gather_rows_torch(positions, nbr.idx)`` equals
    ``positions[nbr.idx]`` bit for bit, as does the wrapper (the plain
    version on the CPU), in float32 and float64; the plan is the W = 3
    row instance with 32-bit offsets."""
    from uf3_tpu_torch.benchmarks import probe_gather
    for name in ("engine.positions_k16", "engine.positions_k72",
                 "engine.positions_k78"):
        x, nbr = probe_gather.engine_state(name, "cpu", small=True)
        assert not bool(nbr.mask.all())     # padded slots gather too
        for dtype in (torch.float32, torch.float64):
            xd = x.to(dtype)
            ref = xd[nbr.idx]
            _same(ref, gather.gather_rows_torch(xd, nbr.idx))
            _same(ref, gather.gather_rows(xd, nbr.idx))
            plan = gather.rows_plan(xd, nbr.idx)
            assert plan.kernel == f"rows_w{3 * xd.element_size() // 4}"
            assert not plan.wide


def test_cached_displacements_match_jax_displacements():
    """The port's ``cached_displacements`` (``positions[nbr.idx]`` plus
    the list's shift product, ``ops/neighbors.py:72-74``) against the
    JAX engine's ``displacements`` (``uf3_tpu/ops/neighbors.py:42``) on
    the same numpy positions, cell, list and shifts, float64, within
    1e-12 A: the list from the port's builder on a rattled bcc W cell
    whose images cross the periodic boundary."""
    geom = bulk("W", "bcc", a=3.1652) * (4, 4, 4)
    geom.rattle(0.05, seed=7)
    pos = torch.as_tensor(geom.get_positions())
    cell = torch.as_tensor(np.asarray(geom.get_cell()))
    nbr = nb.build_neighbor_list_images(pos, cell, (True,) * 3, 5.5, 72)
    assert not bool(nbr.overflow) and bool((nbr.shift != 0).any())
    cache = nb.list_cache(nbr, cell, torch.float64)
    ours = nb.cached_displacements(pos, nbr, cache)
    _same(pos[nbr.idx], gather.gather_rows_torch(pos, nbr.idx))
    ref = np.asarray(jnb.displacements(
        jnp.asarray(pos.numpy()), jnp.asarray(cell.numpy()),
        jnp.asarray(nbr.idx.numpy()), jnp.asarray(nbr.shift.numpy())))
    assert ref.dtype == np.float64
    assert np.max(np.abs(ref - ours.numpy())) <= 1e-12
