"""
Closed-form cubic B-spline primitives: numpy builders for the leg specs
and coefficient re-expressions, and torch functions for the 4-tap basis
evaluations the force modules run on device.

Counterpart of the spline half of ``uf3_tpu/ops/pallas_trio.py``
(LegSpec .. _dense_basis, basis_window_hi, _switch_poly); every knot
strategy (linear / lammps r^2 / geometric / inverse) is uniform in a
transformed coordinate, so the interval lookup is a floor and the
8-knot de Boor window is an analytic clip expression.
"""

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from uf3_tpu_torch.representation import splines as sp

LINEAR, LAMMPS, GEOMETRIC, INVERSE = 0, 1, 2, 3


class LegSpec(NamedTuple):
    """Static closed-form description of one leg's knot sequence."""
    kind: int        # transform id
    u0: float        # first knot in transformed coordinate
    h: float         # uniform spacing in transformed coordinate
    n_int: int       # number of intervals (= resolution)
    t_min: float     # r-space lower bound (inclusive mask)
    t_max: float     # r-space upper bound (inclusive mask)
    n_basis: int     # number of basis functions (n_int + 3)
    knots: Tuple[float, ...] = None  # exact interior points (optional)
    cardinal: bool = False  # coefficients re-expressed over uniform
    #   cardinal B-splines (LINEAR knots only)


# uniform cardinal cubic B-spline blending: w_tap(f) = sum_p M[tap,p] f^p
# on the local coordinate f in [0, 1) of an interval
CARDINAL_M = np.array([[1.0, -3.0, 3.0, -1.0],
                       [4.0, 0.0, -6.0, 3.0],
                       [1.0, 3.0, 3.0, -3.0],
                       [0.0, 0.0, 0.0, 1.0]]) / 6.0


def basis_monomial_table(knot_sequence: np.ndarray) -> np.ndarray:
    """beta[i, tap, p]: monomial coefficient of u^p for basis function
    B_{i + tap} on knot interval i, in the local coordinate
    u = (r - t_{i+3}) / (t_{i+4} - t_{i+3}); zero-width intervals get
    zero rows."""
    knot_sequence = np.asarray(knot_sequence, dtype=np.float64)
    n_intervals = len(knot_sequence) - 7
    beta = np.zeros((n_intervals, 4, 4))
    # sample at 4 points and invert the Vandermonde (exact for cubics)
    u_samples = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    vander_inv = np.linalg.inv(np.vander(u_samples, 4, increasing=True))
    for i in range(n_intervals):
        t_lo = knot_sequence[i + 3]
        t_hi = knot_sequence[i + 4]
        if t_hi <= t_lo:
            continue
        r_samples = t_lo + u_samples * (t_hi - t_lo)
        values, _ = sp.deboor_values(r_samples, knot_sequence,
                                     idx=np.full(4, i, dtype=np.int64))
        beta[i] = (vander_inv @ values).T  # (tap, power)
    return beta


HORNER_WIDTH = 20  # entries per interval row of ``horner_table``


def horner_table(spec: LegSpec) -> np.ndarray:
    """(n_int, 20) per-interval cubic coefficients of the 4 non-zero
    basis functions of a closed-form leg, for evaluation by Horner
    without division.  Row i, in groups of 4 (one vector load each):
    [t_i, 1 / (t_{i+1} - t_i), 0, 0], then beta[tap, 0:4] for taps
    0..3, where B_{i + tap}(r) = sum_p beta[tap, p] u^p on
    u = (r - t_i) / (t_{i+1} - t_i), so that d/dr B_{i + tap}(r) =
    sum_p p beta[tap, p] u^(p-1) / (t_{i+1} - t_i)."""
    pts = _knot_value(spec, torch.arange(spec.n_int + 1),
                      torch.float64).numpy()
    seq = np.concatenate([[pts[0]] * 3, pts, [pts[-1]] * 3])
    beta = basis_monomial_table(seq)                   # (n_int, tap, p)
    inv_w = 1.0 / np.diff(pts)
    table = np.zeros((spec.n_int, HORNER_WIDTH))
    table[:, 0] = pts[:-1]
    table[:, 1] = inv_w
    table[:, 4:20] = beta.reshape(spec.n_int, 16)
    return table


def cardinal_coefficients(knot_sequence, coefficients):
    """Re-express a clamped cubic spline with uniform interior knots
    over uniform cardinal B-splines (same basis count).  Exact: any C^2
    piecewise cubic on uniform breakpoints lies in the cardinal span.
    The clamped basis functions 3 .. n-4 are cardinal ones already and
    keep their coefficients; the three at each end span what the three
    cardinal ones there span on the domain, and are matched on the end
    interval alone, so no rounding travels along the leg.  Returns the
    (n_int + 3,) vector, or None for non-uniform knots or fewer than 4
    intervals."""
    seq = np.asarray(knot_sequence, dtype=np.float64)
    gaps = np.diff(seq[3:-3])
    if len(gaps) < 4 or not np.allclose(gaps, gaps[0], rtol=1e-8,
                                        atol=1e-10):
        return None
    coefficients = np.asarray(coefficients, dtype=np.float64)
    beta = basis_monomial_table(seq)          # (n_int, tap, power)
    uc = coefficients.copy()
    # first interval: taps 0-2 (clamped) against cardinal taps 0-2;
    # last interval: taps 1-3 against cardinal taps 1-3
    for sl, taps, row in ((slice(0, 3), slice(0, 3), 0),
                          (slice(-3, None), slice(1, 4), -1)):
        poly = coefficients[sl] @ beta[row, taps]
        uc[sl] = np.linalg.lstsq(CARDINAL_M[taps].T, poly, rcond=None)[0]
    n_int = beta.shape[0]
    poly = np.stack([coefficients[i:i + 4] @ beta[i]
                     for i in range(n_int)])  # (n_int, power)
    recon = np.stack([uc[i:i + 4] @ CARDINAL_M for i in range(n_int)])
    scale = max(1.0, np.abs(poly).max())
    if np.abs(recon - poly).max() > 1e-8 * scale:
        return None
    return uc


def leg_spec_from_knots(seq: np.ndarray,
                        exact: bool = False) -> Tuple[bool, LegSpec]:
    """Detect the generating strategy of a clamped knot sequence.
    Returns (ok, spec); ok=False means no closed form applies.  The
    spacing is the mean gap (u_last - u0) / n_int, which finds each
    interval to within the knots' rounding; with ``exact`` the spec
    carries the sequence's own knots, which the basis then evaluates on
    (``_knot_value``, ``horner_table``)."""
    seq = np.asarray(seq, dtype=np.float64)
    pts = seq[3:-3]
    n_int = len(pts) - 1
    for kind, fwd in ((LINEAR, lambda x: x), (LAMMPS, np.square),
                      (GEOMETRIC, np.log),
                      (INVERSE, lambda x: 1.0 / x)):
        if kind in (GEOMETRIC, INVERSE) and pts[0] <= 0:
            continue
        u = fwd(pts)
        gaps = np.diff(u)
        if np.allclose(gaps, gaps[0], rtol=1e-6, atol=1e-9):
            return True, LegSpec(
                kind, float(u[0]), float((u[-1] - u[0]) / n_int), n_int,
                float(seq[0]), float(seq[-1]), n_int + 3,
                tuple(float(p) for p in pts) if exact else None)
    return False, None


def basis_window_hi(spec: LegSpec, r_hi: float) -> int:
    """Number of pair basis functions with support below ``r_hi``: the
    switched short-range force S(r) V(r) vanishes for r >= r_hi, so
    the coefficient selection can stop at interval(r_hi) + 4."""
    if spec.kind == LINEAR:
        u = r_hi
    elif spec.kind == LAMMPS:
        u = r_hi * r_hi
    elif spec.kind == GEOMETRIC:
        u = np.log(r_hi)
    else:
        u = 1.0 / r_hi
    idx = int(np.clip(np.floor((u - spec.u0) / spec.h), 0,
                      spec.n_int - 1))
    return min(spec.n_basis, idx + 4)


def _cardinal4(r, spec: LegSpec):
    """Values and d/dr of the 4 active cardinal basis functions plus
    the interval index (LINEAR knots only)."""
    inv_h = 1.0 / spec.h
    tt = (r - spec.u0) * inv_h
    idx = torch.clamp(torch.floor(tt).to(torch.int64), 0, spec.n_int - 1)
    f = tt - idx.to(r.dtype)
    f2 = f * f
    f3 = f2 * f
    sixth = 1.0 / 6.0
    values = [(1.0 - 3.0 * f + 3.0 * f2 - f3) * sixth,
              (4.0 - 6.0 * f2 + 3.0 * f3) * sixth,
              (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) * sixth,
              f3 * sixth]
    half_h = 0.5 * inv_h
    derivs = [-(1.0 - 2.0 * f + f2) * half_h,
              (3.0 * f2 - 4.0 * f) * half_h,
              (1.0 + 2.0 * f - 3.0 * f2) * half_h,
              f2 * half_h]
    return values, derivs, idx


@functools.lru_cache(maxsize=256)
def _knot_table(knots: Tuple[float, ...], dtype, device) -> torch.Tensor:
    return torch.tensor(knots, dtype=dtype, device=device)


def _knot_value(spec: LegSpec, k, dtype):
    """r-space knot value for (clipped) uniform index k: the spec's own
    knots where it carries them, else u0 + k h transformed back."""
    if spec.knots is not None:
        return _knot_table(spec.knots, dtype, k.device)[k]
    u = spec.u0 + k.to(dtype) * spec.h
    if spec.kind == LINEAR:
        return u
    if spec.kind == LAMMPS:
        return torch.sqrt(torch.clamp(u, min=0.0))
    if spec.kind == GEOMETRIC:
        return torch.exp(u)
    return 1.0 / u


def _transform(spec: LegSpec, r):
    if spec.kind == LINEAR:
        return r
    if spec.kind == LAMMPS:
        return r * r
    if spec.kind == GEOMETRIC:
        return torch.log(r)
    return 1.0 / r


def _leg_interval(spec: LegSpec, r):
    """Interval index (= first non-zero basis index), clipped; monotone
    in r for decreasing transforms too (h is then negative)."""
    u = _transform(spec, r)
    raw = torch.floor((u - spec.u0) / spec.h).to(torch.int64)
    return torch.clamp(raw, 0, spec.n_int - 1)


def _safe_div(num, den):
    """num / den, and 0 where den == 0 (the clamped ends)."""
    return torch.where(den != 0, num / den, 0.0)


def _deboor4(r, idx, spec: LegSpec):
    """Values and first derivatives of the 4 non-zero cubic basis
    functions from the analytic knot window t[idx .. idx+7] with
    clamped-end clipping (zero denominators give zero terms)."""
    tk = [_knot_value(spec, torch.clamp(idx + j - 3, 0, spec.n_int),
                      r.dtype) for j in range(8)]
    return _deboor_taps(r, tk)


def _deboor_taps(r, tk):
    """The Cox-de Boor recursion on the 8-knot window ``tk`` (a list of
    tensors shaped like r): values and first derivatives of the 4
    non-zero cubic basis functions, as two lists of 4."""
    zero = torch.zeros_like(r)
    b = [zero, zero, zero, torch.ones_like(r)]
    for k in range(1, 3):  # degrees 1, 2
        new = [zero, zero, zero, zero]
        for p in range(3 - k, 4):
            term = _safe_div(r - tk[p], tk[p + k] - tk[p]) * b[p]
            if p + 1 <= 3:
                term = term + _safe_div(tk[p + k + 1] - r,
                                        tk[p + k + 1] - tk[p + 1]) \
                    * b[p + 1]
            new[p] = term
        b = new
    values = [zero, zero, zero, zero]
    derivs = [zero, zero, zero, zero]
    for p in range(0, 4):
        term = _safe_div(r - tk[p], tk[p + 3] - tk[p]) * b[p]
        dterm = 3.0 * _safe_div(b[p], tk[p + 3] - tk[p])
        if p + 1 <= 3:
            term = term + _safe_div(tk[p + 4] - r,
                                    tk[p + 4] - tk[p + 1]) * b[p + 1]
            dterm = dterm - 3.0 * _safe_div(b[p + 1],
                                            tk[p + 4] - tk[p + 1])
        values[p] = term
        derivs[p] = dterm
    return values, derivs


def _dense_basis(r, valid, spec: LegSpec, lo: int = 0, hi: int = None,
                 transposed: bool = False):
    """Dense basis and derivative matrices over the basis-index window
    [lo, hi): (..., hi - lo), or (..., hi - lo, P) for r of shape
    (..., P) with ``transposed``.  Lanes outside the inclusive range
    t_min <= r <= t_max, or with ``valid`` 0, are zero."""
    if hi is None:
        hi = spec.n_basis
    if spec.cardinal:
        values, derivs, idx = _cardinal4(r, spec)
    else:
        idx = _leg_interval(spec, r)
        values, derivs = _deboor4(r, idx, spec)
    in_range_f = (valid.to(r.dtype) * (r >= spec.t_min).to(r.dtype)
                  * (r <= spec.t_max).to(r.dtype))
    # basis w takes tap w - idx of the 4 active ones, or the zero in
    # slot 4 when that lies outside [0, 4)
    w = torch.arange(lo, hi, device=r.device)
    if transposed:
        tap = w.view(-1, 1) - idx.unsqueeze(-2)          # (..., W, P)
    else:
        tap = w - idx.unsqueeze(-1)                      # (..., W)
    tap = torch.where((tap >= 0) & (tap < 4), tap, 4).unsqueeze(-1)
    zero = torch.zeros_like(r)
    mats = []
    for cols in (values, derivs):
        taps = torch.stack([c * in_range_f for c in cols] + [zero], -1)
        taps = taps.unsqueeze(-3 if transposed else -2)
        mats.append(torch.gather(taps.expand(tap.shape[:-1] + (5,)), -1,
                                 tap).squeeze(-1))
    return mats[0], mats[1]


def _switch_poly(r, r_lo: float, r_hi: float):
    """C^2 quintic smoothstep partition S(r): 1 below r_lo, 0 above
    r_hi.  Returns (S, dS/dr)."""
    width = r_hi - r_lo
    u = torch.clamp((r - r_lo) / width, 0.0, 1.0)
    u2 = u * u
    u3 = u2 * u
    s = 1.0 - (10.0 * u3 - 15.0 * u3 * u + 6.0 * u3 * u2)
    ds = -(30.0 * u2 - 60.0 * u3 + 30.0 * u2 * u2) / width
    return s, ds
