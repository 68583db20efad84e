"""
3-body potential volume visualization.

Covers the reference's plotly-based viewer (uf3/util/plotting3d.py:7-216
``ThreeBodyPlotter`` with isosurface/volume traces) and its perceptual
colormap module (uf3/util/cubehelix.py) without the plotly dependency:

* :func:`cubehelix` implements D. Green's cubehelix colour scheme
  (Bull. Astr. Soc. India 39, 289 (2011)) from the published formula --
  a parameterized generator rather than a fixed lookup table -- with a
  ``perceptual_rainbow``-style preset.
* :func:`marching_tetrahedra` extracts isosurface triangle meshes from
  a scalar volume (6-tetrahedra cube decomposition; no scikit-image).
* :class:`ThreeBodyVolumePlotter` samples the trio spline field on a
  (r_ij, r_ik, r_jk) or (r_ij, r_ik, theta) grid -- like the
  reference's ``sample_uniformly`` with its triangle-inequality mask --
  and renders matplotlib 3D isosurfaces / alpha volumes.

Copy of ``uf3_tpu/util/plotting3d.py``; matplotlib is imported where a
plot is drawn, never at import.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from uf3_tpu_torch.util.plotting import ThreeBodyPlotter


# -- cubehelix ---------------------------------------------------------------
def cubehelix(n: int = 256,
              start: float = 0.5,
              rotations: float = -1.5,
              hue: float = 1.2,
              gamma: float = 1.0,
              light_range: Tuple[float, float] = (0.0, 1.0),
              reverse: bool = False) -> np.ndarray:
    """(n, 3) RGB array following Green's cubehelix: intensity ramps
    monotonically while the colour rotates around the diagonal, so the
    map stays perceptually ordered in greyscale reproduction."""
    lam = np.linspace(light_range[0], light_range[1], n)
    lgam = lam ** gamma
    phi = 2 * np.pi * (start / 3.0 + rotations * lam)
    amp = hue * lgam * (1 - lgam) / 2.0
    cos_phi = np.cos(phi)
    sin_phi = np.sin(phi)
    r = lgam + amp * (-0.14861 * cos_phi + 1.78277 * sin_phi)
    g = lgam + amp * (-0.29227 * cos_phi - 0.90649 * sin_phi)
    b = lgam + amp * (1.97294 * cos_phi)
    rgb = np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)
    if reverse:
        rgb = rgb[::-1]
    return rgb


def cubehelix_cmap(name: str = "uf3_cubehelix", **kwargs):
    """Matplotlib ListedColormap from :func:`cubehelix`."""
    from matplotlib.colors import ListedColormap
    return ListedColormap(cubehelix(**kwargs), name=name)


def perceptual_rainbow_cmap():
    """Cubehelix parameterization spanning violet -> green -> amber,
    ordered in lightness -- the role cubehelix.py's fixed table plays
    in the reference."""
    return cubehelix_cmap(name="uf3_perceptual_rainbow", start=0.2,
                          rotations=-0.85, hue=1.4, gamma=0.9,
                          light_range=(0.12, 0.95))


# -- isosurface extraction ---------------------------------------------------
# cube corners indexed by (x, y, z) bits; 6 tetrahedra sharing the 0-7
# diagonal tile the cube
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
_TETS = [(0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
         (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7)]


def _tet_case_table():
    """case bitmask (which of the 4 tet vertices exceed the level) ->
    triangle list, each triangle = 3 edges = 3 (a, b) vertex pairs."""
    table = {}
    for mask in range(16):
        inside = [v for v in range(4) if mask >> v & 1]
        outside = [v for v in range(4) if not mask >> v & 1]
        if len(inside) == 0 or len(inside) == 4:
            table[mask] = []
        elif len(inside) == 1:
            a = inside[0]
            table[mask] = [[(a, outside[0]), (a, outside[1]),
                            (a, outside[2])]]
        elif len(inside) == 3:
            a = outside[0]
            table[mask] = [[(a, inside[0]), (a, inside[1]),
                            (a, inside[2])]]
        else:
            a, b = inside
            c, d = outside
            # quad (a,c)-(a,d)-(b,d)-(b,c) split into two triangles
            table[mask] = [[(a, c), (a, d), (b, d)],
                           [(a, c), (b, d), (b, c)]]
    return table


_TET_TABLE = _tet_case_table()


def marching_tetrahedra(values: np.ndarray,
                        level: float,
                        coords: Optional[Sequence[np.ndarray]] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """
    Triangle mesh of the isosurface ``values == level``.

    Args:
        values: (nx, ny, nz) scalar field.
        level: iso value.
        coords: optional (x, y, z) 1D axis coordinate arrays; defaults
            to grid indices.

    Returns:
        vertices: (n_vertices, 3) float array.
        triangles: (n_triangles, 3) int index array into vertices.
    """
    values = np.asarray(values, dtype=np.float64)
    nx, ny, nz = values.shape
    if coords is None:
        coords = (np.arange(nx, dtype=float),
                  np.arange(ny, dtype=float),
                  np.arange(nz, dtype=float))
    xi, yi, zi = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([xi.ravel(), yi.ravel(), zi.ravel()], axis=1)
    corner_idx = base[:, None, :] + _CORNERS[None, :, :]  # (C, 8, 3)
    corner_vals = values[corner_idx[..., 0], corner_idx[..., 1],
                         corner_idx[..., 2]]               # (C, 8)
    all_tris: List[np.ndarray] = []
    for tet in _TETS:
        tv = corner_vals[:, tet]                           # (C, 4)
        tp = corner_idx[:, tet, :]                         # (C, 4, 3)
        case = ((tv > level) << np.arange(4)).sum(axis=1)
        for mask in range(1, 15):
            tris = _TET_TABLE[mask]
            if not tris:
                continue
            sel = np.where(case == mask)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                pts = []
                for (a, b) in tri:
                    va, vb = tv[sel, a], tv[sel, b]
                    t = (level - va) / np.where(
                        vb - va == 0, 1.0, vb - va)
                    pa = tp[sel, a, :].astype(float)
                    pb = tp[sel, b, :].astype(float)
                    pts.append(pa + t[:, None] * (pb - pa))
                all_tris.append(np.stack(pts, axis=1))  # (n, 3, 3)
    if not all_tris:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=int)
    tri_pts = np.concatenate(all_tris, axis=0)
    # map fractional grid indices to axis coordinates
    for dim, axis_coords in enumerate(coords):
        axis_coords = np.asarray(axis_coords, dtype=float)
        frac = tri_pts[..., dim]
        i0 = np.clip(frac.astype(int), 0, len(axis_coords) - 2)
        t = frac - i0
        tri_pts[..., dim] = (axis_coords[i0]
                             + t * (axis_coords[i0 + 1]
                                    - axis_coords[i0]))
    vertices = tri_pts.reshape(-1, 3)
    triangles = np.arange(len(vertices)).reshape(-1, 3)
    return vertices, triangles


# -- volume plotter ----------------------------------------------------------
class ThreeBodyVolumePlotter(ThreeBodyPlotter):
    """Volume/isosurface rendering of a trio potential field."""

    def sample_uniformly(self, n_samples: int = 40,
                         theta: bool = False):
        """Sample the field on a regular grid.  With ``theta=True``
        the third axis is the ij-ik angle in [0, pi] and points whose
        implied r_jk leaves the knot span are masked to zero, matching
        the reference viewer's convention
        (uf3/util/plotting3d.py:27-60)."""
        if isinstance(n_samples, int):
            n_samples = [n_samples] * 3
        ax1 = np.linspace(self.knots[0][0], self.knots[0][-1] - 1e-9,
                          n_samples[0])
        ax2 = np.linspace(self.knots[1][0], self.knots[1][-1] - 1e-9,
                          n_samples[1])
        if theta:
            ax3 = np.linspace(1e-3, np.pi - 1e-3, n_samples[2])
            g1, g2, g_theta = np.meshgrid(ax1, ax2, ax3, indexing="ij")
            g3 = np.sqrt(g1 ** 2 + g2 ** 2
                         - 2 * g1 * g2 * np.cos(g_theta))
            mask = ((g3 < self.knots[2][0])
                    | (g3 > self.knots[2][-1] - 1e-9))
            g3 = np.clip(g3, self.knots[2][0],
                         self.knots[2][-1] - 1e-9)
        else:
            ax3 = np.linspace(self.knots[2][0],
                              self.knots[2][-1] - 1e-9, n_samples[2])
            g1, g2, g3 = np.meshgrid(ax1, ax2, ax3, indexing="ij")
            mask = None
        values = self.evaluate(g1.ravel(), g2.ravel(),
                               g3.ravel()).reshape(g1.shape)
        if mask is not None:
            values[mask] = 0.0
        self.axes = (ax1, ax2, ax3)
        self.values = values
        self.theta = theta
        return values

    def plot_isosurface(self, level: float = None, ax=None,
                        n_samples: int = 40, theta: bool = False,
                        color=None, alpha: float = 0.55):
        """Render one isosurface of the trio field."""
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
        if getattr(self, "values", None) is None or \
                getattr(self, "theta", None) != theta:
            self.sample_uniformly(n_samples, theta=theta)
        if level is None:
            level = 0.5 * np.abs(self.values).max()
        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        vertices, triangles = marching_tetrahedra(
            self.values, level, coords=self.axes)
        if len(triangles):
            if color is None:
                cmap = perceptual_rainbow_cmap()
                vmin = self.values.min()
                vmax = self.values.max()
                color = cmap((level - vmin)
                             / max(vmax - vmin, 1e-30))
            mesh = Poly3DCollection(vertices[triangles],
                                    alpha=alpha, linewidths=0)
            mesh.set_facecolor(color)
            ax.add_collection3d(mesh)
        ax.set_xlim(self.axes[0][0], self.axes[0][-1])
        ax.set_ylim(self.axes[1][0], self.axes[1][-1])
        ax.set_zlim(self.axes[2][0], self.axes[2][-1])
        ax.set_xlabel(r"$r_{ij}$ ($\mathrm{\AA}$)")
        ax.set_ylabel(r"$r_{ik}$ ($\mathrm{\AA}$)")
        ax.set_zlabel(r"$\theta$" if theta
                      else r"$r_{jk}$ ($\mathrm{\AA}$)")
        ax.set_title("-".join(self.trio))
        return ax

    def plot_volume(self, ax=None, n_samples: int = 24,
                    theta: bool = False, percentile: float = 70.0,
                    **kwargs):
        """Alpha-weighted scatter of the strongest |V| voxels (the
        matplotlib stand-in for the reference's plotly volume
        trace)."""
        import matplotlib.pyplot as plt
        self.sample_uniformly(n_samples, theta=theta)
        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        g1, g2, g3 = np.meshgrid(*self.axes, indexing="ij")
        magnitude = np.abs(self.values)
        cut = np.percentile(magnitude[magnitude > 0], percentile) \
            if np.any(magnitude > 0) else 0.0
        keep = magnitude >= cut
        vmax = magnitude.max() or 1.0
        cmap = perceptual_rainbow_cmap()
        vrange = self.values.max() - self.values.min()
        colors = cmap((self.values[keep] - self.values.min())
                      / max(vrange, 1e-30))
        colors[:, 3] = 0.1 + 0.9 * magnitude[keep] / vmax
        ax.scatter(g1[keep], g2[keep], g3[keep], c=colors,
                   marker="s", **kwargs)
        ax.set_xlabel(r"$r_{ij}$ ($\mathrm{\AA}$)")
        ax.set_ylabel(r"$r_{ik}$ ($\mathrm{\AA}$)")
        ax.set_zlabel(r"$\theta$" if theta
                      else r"$r_{jk}$ ($\mathrm{\AA}$)")
        return ax
