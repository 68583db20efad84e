"""
Radial-cutoff optimization by feature-column dropping: featurize once at
a large cutoff with uniform knots, then fit many smaller-cutoff models by
dropping the columns whose basis functions extend past the new cutoff
(exact for uniform knot spacing).

Copy of ``uf3_tpu/regression/optimize.py`` (host numpy) on this
package's ``BSplineBasis``.
"""

from typing import Dict, List

import numpy as np

from uf3_tpu_torch.representation.basis import BSplineBasis


def get_bspline_config(chemical_system,
                       rmin_2b: float,
                       rmin_3b: float,
                       rmax_2b: float,
                       rmax_3b: float,
                       knot_spacing_2b: float,
                       knot_spacing_3b: float,
                       leading_trim: int,
                       trailing_trim: int) -> BSplineBasis:
    """Basis config with commensurate uniform knots, suitable both for
    the big-cutoff feature file and for reduced-cutoff fits."""
    def _commensurate(span, spacing):
        remainder = span % spacing
        return np.isclose(remainder, 0) or np.isclose(remainder, spacing)

    if not _commensurate(rmax_2b - rmin_2b, knot_spacing_2b):
        raise ValueError("rmax_2b - rmin_2b is not an integer number of "
                         "knot_spacing_2b intervals")
    if not _commensurate(rmax_3b - rmin_3b, knot_spacing_3b):
        raise ValueError("rmax_3b - rmin_3b is not an integer number of "
                         "knot_spacing_3b intervals")
    if leading_trim != 0:
        raise ValueError("Only tested for leading_trim=0")
    if trailing_trim != 3:
        raise ValueError("Only tested for trailing_trim=3")
    rmax_3b_double = rmax_3b * 2
    if not _commensurate(rmax_3b_double - rmin_3b, knot_spacing_3b):
        raise ValueError("2 * rmax_3b - rmin_3b is not an integer number "
                         "of knot_spacing_3b intervals")
    reso_2b = round((rmax_2b - rmin_2b) / knot_spacing_2b)
    reso_3b = round((rmax_3b - rmin_3b) / knot_spacing_3b)
    reso_3b_double = round((rmax_3b_double - rmin_3b) / knot_spacing_3b)
    pairs = chemical_system.interactions_map[2]
    trios = chemical_system.interactions_map[3]
    return BSplineBasis(
        chemical_system,
        r_min_map={**{p: rmin_2b for p in pairs},
                   **{t: [rmin_3b] * 3 for t in trios}},
        r_max_map={**{p: rmax_2b for p in pairs},
                   **{t: [rmax_3b, rmax_3b, rmax_3b_double]
                      for t in trios}},
        resolution_map={**{p: reso_2b for p in pairs},
                        **{t: [reso_3b, reso_3b, reso_3b_double]
                           for t in trios}},
        leading_trim=leading_trim,
        trailing_trim=trailing_trim)


def get_lower_cutoffs(config: BSplineBasis) -> Dict[str, np.ndarray]:
    """Cutoffs obtainable by dropping feature columns."""
    pair = config.interactions_map[2][0]
    trio = config.interactions_map[3][0]
    lower_2b = np.asarray(config.knots_map[pair])[4:-3]
    lower_3b = np.asarray(config.knots_map[trio][0])[4:-3]
    for value in lower_2b:
        if value not in np.asarray(config.knots_map[pair]):
            raise ValueError("Internal check failed: 2B")
    for value in lower_3b:
        for leg in (0, 1):
            if value not in np.asarray(config.knots_map[trio][leg]):
                raise ValueError(f"Internal check failed: 3B leg {leg}")
    return {"lower_rmax_2b": lower_2b, "lower_rmax_3b": lower_3b}


def get_columns_to_drop_2b(config: BSplineBasis,
                           modify_2b_cutoff: float,
                           knot_spacing_2b: float) -> List[str]:
    """Column names to drop for a reduced 2-body cutoff."""
    if config.leading_trim[2] != 0 or config.trailing_trim[2] != 3:
        raise ValueError("Only tested for trims (0, 3)")
    column_names = config.get_column_names()
    sizes, offsets = config.get_interaction_partitions()
    drop = []
    for pair in config.interactions_map[2]:
        knots = np.asarray(config.knots_map[pair])
        if modify_2b_cutoff not in knots:
            raise ValueError(f"{modify_2b_cutoff} is not a knot of {pair}")
        n_drop = round((knots[-4] - modify_2b_cutoff) / knot_spacing_2b)
        start = 1 + offsets[pair]
        end = start + sizes[pair]
        drop.extend(column_names[end - n_drop - 3:end - 3])
    return drop


def get_columns_to_drop_3b(config: BSplineBasis,
                           modify_3b_cutoff: float,
                           knot_spacing_3b: float) -> List[str]:
    """Column names to drop for a reduced 3-body (center-leg) cutoff.
    Column selection goes through the compressed template grid."""
    if config.leading_trim[3] != 0 or config.trailing_trim[3] != 3:
        raise ValueError("Only tested for trims (0, 3)")
    column_names = config.get_column_names()
    sizes, offsets = config.get_interaction_partitions()
    drop = []
    for trio in config.interactions_map[3]:
        l_seq, m_seq, n_seq = [np.asarray(s) for s in
                               config.knots_map[trio]]
        for leg, seq in ((0, l_seq), (1, m_seq)):
            if modify_3b_cutoff not in seq:
                raise ValueError(
                    f"{modify_3b_cutoff} is not a knot of leg {leg} of "
                    f"{trio}")
        n_drop = round((l_seq[-4] - modify_3b_cutoff) / knot_spacing_3b)
        n_drop_double = int(n_drop * 2)
        start = 1 + offsets[trio]
        end = start + sizes[trio]
        shape = (len(l_seq) - 4, len(m_seq) - 4, len(n_seq) - 4)
        name_grid = np.full(shape, "", dtype=object)
        name_grid.flat[config.template_mask[trio]] = \
            column_names[start:end]
        # delete the 3 trailing-trim planes' predecessors along each axis
        name_grid = np.delete(
            name_grid, np.s_[shape[2] - 3 - n_drop_double:shape[2] - 3],
            axis=2)
        name_grid = np.delete(
            name_grid, np.s_[shape[1] - 3 - n_drop:shape[1] - 3], axis=1)
        name_grid = np.delete(
            name_grid, np.s_[shape[0] - 3 - n_drop:shape[0] - 3], axis=0)
        keep = set(name_grid[name_grid != ""].tolist())
        drop.extend(name for name in column_names[start:end]
                    if name not in keep)
    return drop
