"""
The plain reference of a unary UF3 potential: 2-body and 3-body cubic
B-splines and a 1-body offset, read from the model JSON as published,
on its own neighbour search.

    E = N e1 + sum over ordered pairs (i, j), r_ij < r2, of
        sum_l c_l B_l(r_ij)   (UF3 counts a pair once from each end)
      + sum over centres i and unordered pairs {j, k} of its neighbours
        of sum_lmn G_lmn B_l(r_ij) B_m(r_ik) C_n(r_jk),

with G symmetrised in its first two legs and every basis function zero
outside its knots.  Basis functions come from the Cox-de Boor recursion
on the knots as the file gives them; forces are minus the gradient of
the energy and the virial W_ab = sum over displacements d_a dE/dd_b the
derivative of the energy under a strain of positions and cell, both by
autograd; all in blocks so that 250,000 atoms fit.  float64 by default.

``precision="tf32"`` is the control: the same sums in float32 with
every operand of the spline products (displacements, distances, basis
values, coefficients) rounded to TF32's 10-bit mantissa, as a TF32
matrix product rounds its inputs and accumulates in float32.

The neighbour search takes an orthorhombic periodic cell: a cell list
of bins at least one cutoff wide where each axis holds three, else all
pairs over the images that reach the cutoff.  It imports nothing of
jax, uf3_tpu or uf3_tpu_torch.
"""

import json
from typing import NamedTuple, Optional

import torch


class Model(NamedTuple):
    element: str
    e1: float                    # 1-body offset, eV
    c2: torch.Tensor             # (n2,) pair coefficients
    t2: torch.Tensor             # (n2 + 4,) pair knots
    r2: float                    # 2-body cutoff (last knot)
    g3: Optional[torch.Tensor]   # (L, L, M) 3-body grid, or None
    t3: Optional[tuple]          # knots of the legs ij, ik, jk
    r3: float                    # the first two legs' cutoff (0: none)


def load(path_or_dict) -> Model:
    """A unary UF3 model from its JSON file (or the decoded dict)."""
    m = path_or_dict
    if not isinstance(m, dict):
        with open(m) as f:
            m = json.load(f)
    elements = m["element_list"]
    if len(elements) != 1:
        raise NotImplementedError("this reference evaluates unary models")
    el = elements[0]
    f64 = torch.float64
    knots, coef = m["knots"], m["coefficients"]
    pair = f"{el}-{el}"
    t2 = torch.tensor(knots[pair], dtype=f64)
    c2 = torch.tensor(coef[pair], dtype=f64)
    if len(t2) != len(c2) + 4:
        raise ValueError("pair knots and coefficients disagree")
    g3 = t3 = None
    r3 = 0.0
    trio = f"{el}-{el}-{el}"
    if int(m.get("degree", 2)) > 2 and trio in coef:
        g3 = torch.tensor(coef[trio], dtype=f64)
        g3 = 0.5 * (g3 + g3.transpose(0, 1))
        t3 = tuple(torch.tensor(k, dtype=f64) for k in knots[trio])
        if tuple(g3.shape) != tuple(len(t) - 4 for t in t3):
            raise ValueError("3-body knots and grid disagree")
        r3 = float(min(t3[0][-1], t3[1][-1]))
    offset = coef.get(el, 0.0)
    return Model(el, float(offset), c2, t2, float(t2[-1]), g3, t3, r3)


# -- precision ------------------------------------------------------------
def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, nearest, ties
    away from zero) in the forward pass; the gradient passes through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return x + (rounded - x.detach())


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.dtype = torch.float64 if name == "f64" else torch.float32
        self.q = (lambda x: x) if name == "f64" else tf32


# -- B-splines ------------------------------------------------------------
def basis4(r: torch.Tensor, t: torch.Tensor):
    """(first, values): the index of the first of the 4 cubic basis
    functions that can be non-zero at ``r`` and their values (..., 4),
    by the Cox-de Boor recursion on knots ``t``; zero outside
    [t[3], t[-4]]."""
    n = len(t) - 4
    t = t.to(device=r.device, dtype=r.dtype)
    mu = torch.searchsorted(t, r.detach().contiguous(), right=True) - 1
    mu = torch.clamp(mu, 3, n - 1)
    inside = ((r >= t[3]) & (r <= t[n])).to(r.dtype)
    values = [torch.ones_like(r)]
    for j in range(1, 4):
        left = [None] + [r - t[mu + 1 - i] for i in range(1, j + 1)]
        right = [None] + [t[mu + i] - r for i in range(1, j + 1)]
        saved = torch.zeros_like(r)
        new = []
        for k in range(j):
            temp = values[k] / (right[k + 1] + left[j - k])
            new.append(saved + right[k + 1] * temp)
            saved = left[j - k] * temp
        new.append(saved)
        values = new
    return mu - 3, torch.stack(values, -1) * inside[..., None]


# -- neighbours -----------------------------------------------------------
def _box(cell: torch.Tensor) -> torch.Tensor:
    cell = cell.detach().double().cpu()
    if torch.any(cell - torch.diag(torch.diagonal(cell)) != 0):
        raise NotImplementedError("the reference's search takes an "
                                  "orthorhombic cell")
    return torch.diagonal(cell).clone()


def neighbor_pairs(positions: torch.Tensor, cell: torch.Tensor,
                   r_cut: float, block: int = 16384):
    """Every ordered pair (i, j, s) with |x_j + s L - x_i| < r_cut, s an
    integer image (i == j only for s != 0), in float64, sorted by i.
    Returns (i, j, s) as int64 tensors on the positions' device."""
    dev = positions.device
    x = positions.detach().double()
    box = _box(cell).to(dev)
    n = x.shape[0]
    wraps = torch.floor(x / box)
    xw = x - wraps * box
    wraps = wraps.to(torch.int64)
    nc = torch.floor(box / r_cut).to(torch.int64).cpu()
    out = []
    if bool(torch.all(nc >= 3)):
        ncl = [int(v) for v in nc]
        width = box / nc.to(dev)
        c3 = torch.minimum(torch.floor(xw / width).to(torch.int64),
                           nc.to(dev) - 1)
        lin = (c3[:, 0] * ncl[1] + c3[:, 1]) * ncl[2] + c3[:, 2]
        n_cells = ncl[0] * ncl[1] * ncl[2]
        order = torch.argsort(lin)
        counts = torch.bincount(lin, minlength=n_cells)
        start = torch.cumsum(counts, 0) - counts
        width_max = int(counts.max())
        rank = torch.arange(n, device=dev) - start[lin[order]]
        table = torch.full((n_cells, width_max), -1, dtype=torch.int64,
                           device=dev)
        table[lin[order], rank] = order
        offsets = torch.tensor([(a, b, c) for a in (-1, 0, 1)
                                for b in (-1, 0, 1) for c in (-1, 0, 1)],
                               device=dev)
        ncd = nc.to(dev)
        for lo in range(0, n, block):
            ii = torch.arange(lo, min(n, lo + block), device=dev)
            cc = c3[ii][:, None, :] + offsets                 # (B, 27, 3)
            img = torch.div(cc, ncd, rounding_mode="floor")
            cc = cc - img * ncd
            cl = (cc[..., 0] * ncl[1] + cc[..., 1]) * ncl[2] + cc[..., 2]
            jj = table[cl]                                    # (B, 27, W)
            ss = img[:, :, None, :].expand(-1, -1, width_max, -1)
            jj = jj.reshape(len(ii), -1)
            ss = ss.reshape(len(ii), -1, 3)
            ok = jj >= 0
            jc = torch.where(ok, jj, 0)
            d = xw[jc] + ss * box - xw[ii][:, None, :]
            r2 = torch.sum(d * d, -1)
            keep = ok & (r2 < r_cut * r_cut) & ~(
                (jj == ii[:, None]) & torch.all(ss == 0, -1))
            a, b = torch.nonzero(keep, as_tuple=True)
            out.append((ii[a], jj[a, b], ss[a, b]))
    else:
        reach = torch.ceil(r_cut / box).to(torch.int64).tolist()
        images = torch.tensor(
            [(a, b, c) for a in range(-reach[0], reach[0] + 1)
             for b in range(-reach[1], reach[1] + 1)
             for c in range(-reach[2], reach[2] + 1)], device=dev)
        step = max(1, (1 << 22) // (len(images) * n))
        for lo in range(0, n, step):
            ii = torch.arange(lo, min(n, lo + step), device=dev)
            d = (xw[None, None, :, :] + (images * box)[None, :, None, :]
                 - xw[ii][:, None, None, :])                 # (B, I, N, 3)
            r2 = torch.sum(d * d, -1)
            same = (torch.arange(n, device=dev)[None, None, :]
                    == ii[:, None, None]) & torch.all(
                images == 0, -1)[None, :, None]
            a, b, c = torch.nonzero((r2 < r_cut * r_cut) & ~same,
                                    as_tuple=True)
            out.append((ii[a], c, images[b]))
    i = torch.cat([o[0] for o in out])
    j = torch.cat([o[1] for o in out])
    s = torch.cat([o[2] for o in out])
    order = torch.argsort(i * n + j, stable=True)
    i, j, s = i[order], j[order], s[order]
    # images relative to the positions as given, not as wrapped
    s = s + wraps[i] - wraps[j]
    return i, j, s


# -- energy, forces, virial ------------------------------------------------
def energy_forces(model: Model, positions: torch.Tensor,
                  cell: torch.Tensor, precision: str = "f64",
                  virial: bool = False, pairs=None,
                  pair_block: int = 1 << 22, trio_block: int = 1 << 21):
    """(energy, forces (N, 3), virial (3, 3) or None) at ``positions``
    in ``cell`` in the given precision, on the positions' device.
    ``pairs``, the ordered pairs within the 2-body cutoff
    (``neighbor_pairs``), is searched for where not given."""
    p = Precision(precision)
    dev = positions.device
    n = positions.shape[0]
    if pairs is None:
        pairs = neighbor_pairs(positions, cell, model.r2)
    i2, j2, s2 = pairs
    x = positions.detach().to(p.dtype).clone().requires_grad_(True)
    box = _box(cell).to(device=dev, dtype=p.dtype)
    eps = torch.zeros((3, 3), dtype=p.dtype, device=dev,
                      requires_grad=virial)
    strain = torch.eye(3, dtype=p.dtype, device=dev) + eps
    c2 = p.q(model.c2.to(device=dev, dtype=p.dtype))

    def disp(i, j, s):
        d = x[j] - x[i] + s.to(p.dtype) * box
        return p.q(d @ strain if virial else d)

    def norm(d):
        return p.q(torch.sqrt(torch.sum(d * d, -1)))

    total = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, len(i2), pair_block):
        sl = slice(lo, lo + pair_block)
        r = norm(disp(i2[sl], j2[sl], s2[sl]))
        first, vals = basis4(r, model.t2)
        vals = p.q(vals)
        e = torch.sum(c2[first[:, None] + torch.arange(
            4, device=dev)] * vals)
        e.backward()
        total = total + e.detach().double()
    if model.g3 is not None:
        r_all = torch.sqrt(torch.sum((x.detach()[j2] - x.detach()[i2]
                                      + s2.to(p.dtype) * box) ** 2, -1))
        near = r_all < model.r3
        i3, j3, s3 = i2[near], j2[near], s2[near]
        total = total + _trio_energy(model, p, x, box, strain, virial,
                                     i3, j3, s3, n, trio_block)
    energy = float(total) + n * model.e1
    forces = -x.grad.double()
    vir = eps.grad.double() if virial else None
    return energy, forces, vir


def _trio_energy(model, p, x, box, strain, virial, i3, j3, s3, n,
                 trio_block):
    """The 3-body sum over centres' unordered neighbour pairs, each
    block's gradient accumulated into ``x.grad`` (and the strain's)."""
    dev = x.device
    counts = torch.bincount(i3, minlength=n)
    kmax = int(counts.max()) if len(counts) else 0
    if kmax < 2:
        return torch.zeros((), dtype=torch.float64, device=dev)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(i3), device=dev) - start[i3]
    table = torch.full((n, kmax), -1, dtype=torch.int64, device=dev)
    table[i3, slot] = torch.arange(len(i3), device=dev)
    a_idx, b_idx = torch.triu_indices(kmax, kmax, 1, device=dev)
    g3 = p.q(model.g3.to(device=dev, dtype=p.dtype))
    L, M, C = g3.shape
    g_flat = g3.reshape(-1)
    taps = torch.arange(4, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    centers = max(1, trio_block // len(a_idx))
    for lo in range(0, n, centers):
        rows = table[lo:lo + centers]
        pa, pb = rows[:, a_idx], rows[:, b_idx]
        keep = (pa >= 0) & (pb >= 0)
        pa, pb = pa[keep], pb[keep]
        if len(pa) == 0:
            continue
        ci = i3[pa]
        dij = x[j3[pa]] - x[ci] + s3[pa].to(p.dtype) * box
        dik = x[j3[pb]] - x[ci] + s3[pb].to(p.dtype) * box
        if virial:
            dij, dik = dij @ strain, dik @ strain
        dij, dik = p.q(dij), p.q(dik)
        djk = p.q(dik - dij)
        rij = p.q(torch.sqrt(torch.sum(dij * dij, -1)))
        rik = p.q(torch.sqrt(torch.sum(dik * dik, -1)))
        rjk = p.q(torch.sqrt(torch.sum(djk * djk, -1)))
        fl, bl = basis4(rij, model.t3[0])
        fm, bm = basis4(rik, model.t3[1])
        fn, bn = basis4(rjk, model.t3[2])
        bl, bm, bn = p.q(bl), p.q(bm), p.q(bn)
        il = (fl[:, None] + taps).clamp(0, L - 1)
        im = (fm[:, None] + taps).clamp(0, M - 1)
        in_ = (fn[:, None] + taps).clamp(0, C - 1)
        flat = ((il[:, :, None, None] * M + im[:, None, :, None]) * C
                + in_[:, None, None, :])                   # (T, 4, 4, 4)
        g = g_flat[flat]
        e = torch.einsum("ta,tb,tc,tabc->", bl, bm, bn, g)
        e.backward()
        total = total + e.detach().double()
    return total

