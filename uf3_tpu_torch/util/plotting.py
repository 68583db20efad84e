"""
Visualization utilities: fitted pair-potential curves, knot/coefficient
diagnostics, RDF histograms, density scatter, and 3-body grid slices.

Copy of ``uf3_tpu/util/plotting.py`` on this package's splines and
models.  matplotlib is imported where a plot is drawn, never at import:
the GPU hosts may not carry it.
"""

from typing import Dict

import numpy as np

from uf3_tpu_torch.representation import splines as sp


def _axis(ax=None):
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    return ax


def visualize_splines(coefficients: np.ndarray,
                      knot_sequence: np.ndarray,
                      ax=None,
                      n_samples: int = 400,
                      show_components: bool = True,
                      **kwargs):
    """Plot a fitted pair potential and its per-basis components."""
    ax = _axis(ax)
    r = np.linspace(knot_sequence[0], knot_sequence[-1] - 1e-9,
                    n_samples)
    total = sp.evaluate_spline(r, knot_sequence, coefficients)
    if show_components:
        for i in range(len(coefficients)):
            one = np.zeros_like(coefficients)
            one[i] = coefficients[i]
            ax.plot(r, sp.evaluate_spline(r, knot_sequence, one),
                    lw=0.5, alpha=0.5)
    ax.plot(r, total, color="black", lw=2, **kwargs)
    ax.set_xlabel(r"r ($\mathrm{\AA}$)")
    ax.set_ylabel("energy (eV)")
    return ax


def plot_pair_potential(model, pair=None, ax=None, **kwargs):
    """Plot one fitted pair interaction of a WeightedLinearModel."""
    config = model.bspline_config
    pair = pair or config.interactions_map[2][0]
    sizes, offsets = config.get_interaction_partitions()
    coefficients = model.coefficients[offsets[pair]:offsets[pair]
                                      + sizes[pair]]
    ax = visualize_splines(coefficients, config.knots_map[pair], ax=ax,
                           **kwargs)
    ax.set_title("-".join(pair))
    return ax


def plot_rdf(histogram: Dict, bin_edges: np.ndarray, ax=None):
    """Plot per-interaction RDF histograms from analyze.summarize_
    distances."""
    ax = _axis(ax)
    centers = 0.5 * (bin_edges[:-1] + bin_edges[1:])
    for pair, values in histogram.items():
        ax.plot(centers, values, label="-".join(pair))
    ax.set_xlabel(r"r ($\mathrm{\AA}$)")
    ax.set_ylabel("g(r)")
    ax.legend()
    return ax


def density_scatter(x, y, ax=None, bins: int = 100, **kwargs):
    """Scatter colored by local point density (parity-plot helper)."""
    ax = _axis(ax)
    x = np.asarray(x)
    y = np.asarray(y)
    histogram, x_edges, y_edges = np.histogram2d(x, y, bins=bins)
    xi = np.clip(np.digitize(x, x_edges[1:-1]), 0, bins - 1)
    yi = np.clip(np.digitize(y, y_edges[1:-1]), 0, bins - 1)
    density = histogram[xi, yi]
    order = np.argsort(density)
    ax.scatter(x[order], y[order], c=density[order], s=4, **kwargs)
    lo, hi = min(x.min(), y.min()), max(x.max(), y.max())
    ax.plot([lo, hi], [lo, hi], color="gray", lw=0.5)
    return ax


class ThreeBodyPlotter:
    """Angular / planar slices through a 3-body coefficient grid."""

    def __init__(self, model, trio=None):
        from uf3_tpu_torch.io import arrange_coefficients
        self.config = model.bspline_config
        self.trio = trio or self.config.interactions_map[3][0]
        solutions = arrange_coefficients(model.coefficients, self.config)
        self.grid = self.config.decompress_3B(solutions[self.trio],
                                              self.trio)
        self.knots = [np.asarray(s) for s in
                      self.config.knots_map[self.trio]]

    def evaluate(self, r_ij, r_ik, r_jk) -> np.ndarray:
        """Evaluate the 3-body energy surface at leg distances."""
        r_ij = np.atleast_1d(np.asarray(r_ij, dtype=float))
        r_ik = np.atleast_1d(np.asarray(r_ik, dtype=float))
        r_jk = np.atleast_1d(np.asarray(r_jk, dtype=float))
        out = np.zeros(np.broadcast(r_ij, r_ik, r_jk).shape)
        r_ij, r_ik, r_jk = np.broadcast_arrays(r_ij, r_ik, r_jk)
        values = []
        for dim, r in enumerate((r_ij, r_ik, r_jk)):
            v, i = sp.deboor_values(r.ravel(), self.knots[dim])
            values.append((v, i))
        flat = out.ravel()
        for a in range(4):
            for b in range(4):
                for c in range(4):
                    flat += (values[0][0][:, a] * values[1][0][:, b]
                             * values[2][0][:, c]
                             * self.grid[values[0][1] + a,
                                         values[1][1] + b,
                                         values[2][1] + c])
        return flat.reshape(out.shape)

    def plot_slice(self, r_jk: float = None, ax=None, n: int = 80,
                   **kwargs):
        """Contour slice of the surface at fixed j-k distance."""
        ax = _axis(ax)
        if r_jk is None:
            r_jk = 0.5 * (self.knots[2][0] + self.knots[2][-1])
        r1 = np.linspace(self.knots[0][0], self.knots[0][-1] - 1e-9, n)
        r2 = np.linspace(self.knots[1][0], self.knots[1][-1] - 1e-9, n)
        grid1, grid2 = np.meshgrid(r1, r2, indexing="ij")
        values = self.evaluate(grid1.ravel(), grid2.ravel(),
                               np.full(n * n, r_jk)).reshape(n, n)
        contour = ax.contourf(grid1, grid2, values, levels=30, **kwargs)
        ax.set_xlabel(r"$r_{ij}$ ($\mathrm{\AA}$)")
        ax.set_ylabel(r"$r_{ik}$ ($\mathrm{\AA}$)")
        ax.set_title(f"{'-'.join(self.trio)} at $r_{{jk}}$ = "
                     f"{r_jk:.2f}")
        return ax, contour

    def plot_slices(self, r_jk_values=None, n_panels: int = 5,
                    n: int = 60, fig=None, cmap: str = "RdBu_r",
                    symmetric_scale: bool = True):
        """Multi-panel grid of (r_ij, r_ik) energy slices over a
        sweep of the third-leg distance -- parity with the
        reference's panel-grid 3B visualization
        (uf3/util/plot_slices_3b.py:11), rebuilt on the analytic
        tensor-product evaluation (no ndsplines).

        One shared symmetric color normalization across panels plus a
        single colorbar, so panels are visually comparable.  Returns
        (fig, axes)."""
        import matplotlib.pyplot as plt
        from matplotlib import colors as mcolors
        if r_jk_values is None:
            lo, hi = self.knots[2][0], self.knots[2][-1]
            pad = 0.08 * (hi - lo)
            r_jk_values = np.linspace(lo + pad, hi - pad, n_panels)
        r_jk_values = np.asarray(r_jk_values, dtype=float)
        n_panels = len(r_jk_values)
        r1 = np.linspace(self.knots[0][0],
                         self.knots[0][-1] - 1e-9, n)
        r2 = np.linspace(self.knots[1][0],
                         self.knots[1][-1] - 1e-9, n)
        g1, g2 = np.meshgrid(r1, r2, indexing="ij")
        panels = [self.evaluate(g1.ravel(), g2.ravel(),
                                np.full(n * n, rjk)).reshape(n, n)
                  for rjk in r_jk_values]
        vmax = max(1e-12, max(np.abs(p).max() for p in panels))
        norm = mcolors.Normalize(vmin=-vmax, vmax=vmax) \
            if symmetric_scale else None
        if fig is None:
            fig, axes = plt.subplots(
                1, n_panels, figsize=(2.6 * n_panels, 2.8),
                sharey=True, constrained_layout=True)
        else:
            axes = fig.subplots(1, n_panels, sharey=True)
        axes = np.atleast_1d(axes)
        mappable = None
        for ax, rjk, vals in zip(axes, r_jk_values, panels):
            mappable = ax.pcolormesh(g1, g2, vals, cmap=cmap,
                                     norm=norm, shading="auto")
            ax.set_title(f"$r_{{jk}}$ = {rjk:.2f}", fontsize=9)
            ax.set_xlabel(r"$r_{ij}$ ($\mathrm{\AA}$)")
            ax.set_aspect("equal")
        axes[0].set_ylabel(r"$r_{ik}$ ($\mathrm{\AA}$)")
        fig.colorbar(mappable, ax=list(axes), shrink=0.85,
                     label="energy (eV)")
        fig.suptitle("-".join(self.trio), fontsize=10)
        return fig, axes

    def plot_angular_slice(self, r: float, ax=None, n: int = 100,
                           **kwargs):
        """Energy vs bond angle at equal leg lengths r_ij = r_ik = r."""
        ax = _axis(ax)
        theta = np.linspace(0.05, np.pi - 0.05, n)
        r_jk = 2 * r * np.sin(theta / 2)
        inside = (r_jk >= self.knots[2][0]) & (r_jk <= self.knots[2][-1])
        values = np.full(n, np.nan)
        values[inside] = self.evaluate(
            np.full(inside.sum(), r), np.full(inside.sum(), r),
            r_jk[inside])
        ax.plot(np.degrees(theta), values, **kwargs)
        ax.set_xlabel("angle (degrees)")
        ax.set_ylabel("energy (eV)")
        return ax
