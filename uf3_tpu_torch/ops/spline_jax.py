"""
Cubic B-splines on general knot sequences: the 4-tap basis evaluation
in torch, the host (numpy, float64) builders of the per-interval
polynomial tables, and their evaluation in torch.

Counterpart of ``uf3_tpu/ops/spline_jax.py`` (``find_interval``,
``deboor_values_jax`` as ``deboor_values``, ``build_pair_tables``,
``build_trio_tables``, ``ppoly_interval``, ``horner_cubic``,
``eval_pair_tables``, ``tricubic_eval``), under the reference's module
name.  ``deboor_values`` runs the recursion of the closed-form legs
(``splines._deboor_taps``) on a knot window gathered from the sequence;
``tricubic_eval`` contracts with explicit products and sums, so no
float32 matmul on the card can round through TF32.
"""

from typing import Tuple

import numpy as np
import torch

from uf3_tpu_torch.ops.splines import _deboor_taps, basis_monomial_table


def find_interval(r, knot_sequence, n_splines: int):
    """First non-zero basis index (clipped): searchsorted over the
    sequence, as the reference."""
    idx = torch.searchsorted(knot_sequence, r.contiguous(), side="left") - 4
    return torch.clamp(idx, 0, n_splines - 4)


def deboor_taps(r, knot_sequence, idx=None):
    """Values and first derivatives of the 4 non-zero cubic basis
    functions at r, any batch shape, each (..., 4), and the first
    basis index idx: [..., t] belongs to B_{idx+t}."""
    t = torch.as_tensor(knot_sequence, dtype=r.dtype, device=r.device)
    if idx is None:
        idx = find_interval(r, t, t.shape[0] - 4)
    window = t[idx[..., None] + torch.arange(8, device=r.device)]
    values, derivs = _deboor_taps(r, list(window.unbind(-1)))
    return torch.stack(values, dim=-1), torch.stack(derivs, dim=-1), idx


def deboor_values(r, knot_sequence, idx=None, nu: int = 0):
    """Values (``nu`` = 0) or first derivatives (``nu`` = 1) of the 4
    non-zero cubic basis functions at r, any batch shape.  Returns
    (values (..., 4), idx) with values[..., t] = B_{idx+t}^(nu)(r)."""
    if nu not in (0, 1):
        raise ValueError(f"nu={nu}: deboor_values gives nu = 0 or 1")
    values, derivs, idx = deboor_taps(r, knot_sequence, idx)
    return derivs if nu else values, idx


# -- host tables (float64, numpy) ----------------------------------------------
def build_pair_tables(knot_sequence: np.ndarray, coefficients: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-interval cubics of a fitted pair spline: poly_e (I, 4) the
    energy in u = (r - t_lo) / h, poly_f (I, 4) dV/dr (degree 2, padded)
    and breaks (I, 2) [t_lo, 1/h]."""
    knot_sequence = np.asarray(knot_sequence, dtype=np.float64)
    coefficients = np.asarray(coefficients, dtype=np.float64)
    beta = basis_monomial_table(knot_sequence)
    n_intervals = beta.shape[0]
    poly_e = np.zeros((n_intervals, 4))
    poly_f = np.zeros((n_intervals, 4))
    breaks = np.zeros((n_intervals, 2))
    for i in range(n_intervals):
        p = coefficients[i:i + 4] @ beta[i]
        poly_e[i] = p
        t_lo, t_hi = knot_sequence[i + 3], knot_sequence[i + 4]
        h = t_hi - t_lo
        inv_h = 1.0 / h if h > 0 else 0.0
        poly_f[i, :3] = np.array([p[1], 2 * p[2], 3 * p[3]]) * inv_h
        breaks[i] = [t_lo, inv_h]
    return poly_e, poly_f, breaks


def build_trio_tables(knot_sequences, grid: np.ndarray):
    """Per-cell tricubics of a decompressed 3-body grid: poly (nl, nm,
    nn, 64), entry p*16 + q*4 + r multiplying u^p v^q w^r, and the
    three legs' (I, 2) [t_lo, 1/h] breaks."""
    grid = np.asarray(grid, dtype=np.float64)
    betas, breaks = [], []
    for seq in knot_sequences:
        seq = np.asarray(seq, dtype=np.float64)
        beta = basis_monomial_table(seq)
        betas.append(beta)
        br = np.zeros((beta.shape[0], 2))
        for i in range(beta.shape[0]):
            t_lo, t_hi = seq[i + 3], seq[i + 4]
            br[i] = [t_lo, 1.0 / (t_hi - t_lo) if t_hi > t_lo else 0.0]
        breaks.append(br)
    nl, nm, nn = (b.shape[0] for b in betas)
    windows = np.lib.stride_tricks.sliding_window_view(grid, (4, 4, 4))
    poly = np.einsum("ijkabc,iap,jbq,kcr->ijkpqr",
                     windows[:nl, :nm, :nn], betas[0], betas[1], betas[2])
    return poly.reshape(nl, nm, nn, 64), tuple(breaks)


# -- table evaluation ------------------------------------------------------------
def ppoly_interval(r, knots_interior, n_intervals: int):
    """Interval index among the break points t_3 .. t_{n_splines},
    clipped."""
    idx = torch.searchsorted(knots_interior, r.contiguous(),
                             side="left") - 1
    return torch.clamp(idx, 0, n_intervals - 1)


def horner_cubic(p, u):
    """p (..., 4) monomial coefficients, evaluated at u."""
    return ((p[..., 3] * u + p[..., 2]) * u + p[..., 1]) * u + p[..., 0]


def eval_pair_tables(r, poly_e, poly_f, breaks, knots_interior):
    """Energy and dV/dr at distances r: one row gather and Horner."""
    idx = ppoly_interval(r, knots_interior, poly_e.shape[0])
    u = (r - breaks[idx, 0]) * breaks[idx, 1]
    return horner_cubic(poly_e[idx], u), horner_cubic(poly_f[idx], u)


def _powers(x):
    """(1, x, x^2, x^3) and their derivatives, stacked on a last axis."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    return (torch.stack([one, x, x * x, x * x * x], dim=-1),
            torch.stack([zero, one, 2.0 * x, 3.0 * x * x], dim=-1))


def tricubic_eval(poly_cell, u, v, w):
    """Tricubics poly_cell (..., 64) at local coordinates u, v, w:
    value, d/du, d/dv, d/dw (each (...,); the 1/h of each leg is the
    caller's)."""
    p = poly_cell.reshape(poly_cell.shape[:-1] + (4, 4, 4))
    wp, dwp = _powers(w)
    vp, dvp = _powers(v)
    up, dup = _powers(u)
    s = torch.sum(p * wp[..., None, None, :], dim=-1)       # (..., p, q)
    s_dw = torch.sum(p * dwp[..., None, None, :], dim=-1)
    q = torch.sum(s * vp[..., None, :], dim=-1)              # (..., p)
    q_dv = torch.sum(s * dvp[..., None, :], dim=-1)
    q_dw = torch.sum(s_dw * vp[..., None, :], dim=-1)
    return (torch.sum(q * up, dim=-1), torch.sum(q * dup, dim=-1),
            torch.sum(q_dv * up, dim=-1), torch.sum(q_dw * up, dim=-1))
