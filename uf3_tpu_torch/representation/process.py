"""
BasisFeaturizer without pandas: energy and force feature vectors of a
configuration on the host (1-body composition, 2-body, compressed
3-body; numpy, float64), the feature table of a dataset, and the
fitting arrays of a dataset.

Counterpart of ``uf3_tpu/representation/process.py``: ``__init__`` with
``fit_forces`` and ``prefix`` (and ``from_config``), the passthrough
properties,
``featurize_energy_2B`` / ``force_2B`` / ``energy_3B`` / ``force_3B``,
``evaluate_configuration`` and ``evaluate``, which returns a
``FeatureTable`` (the reference's DataFrame: rows indexed by
(configuration key, kind), the "y" column and the feature columns, in
the reference's order and names), and ``evaluate_parallel``, the same
table from a process pool (``util/parallel.py``).  ``featurize_dataset`` returns (x_e,
y_e, x_f, y_f) in ``dataframe_to_tuples`` order.  The HDF5 feature
store keeps the reference's names and layout (``batched_to_hdf``,
``save_feature_db``, ``load_feature_db``, ``analyze_hdf_tables``,
``dataframe_batch_loader``): each table is one group of ``values``
(float64, chunked, deflated), ``row_names``, ``row_kinds`` and
``columns``, read and written by ``util/hdf5.py`` where the reference
calls h5py, which the GPU hosts do not carry.  This is the route for
bases whose knots have no closed form; the device featurizer
(``ops/featurize.py``) takes every other basis.
"""

import os
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from uf3_tpu_torch.data import geometry as geo
from uf3_tpu_torch.representation import featurize_np as fnp
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import hdf5


def flatten_by_interactions(vector_map: Dict, pair_tuples: List) -> np.ndarray:
    return np.concatenate([vector_map[pair] for pair in pair_tuples], axis=-1)


class BasisFeaturizer:
    """Generate energy/force features from configurations."""

    def __init__(self, bspline_config: BSplineBasis,
                 fit_forces: bool = True, prefix: str = "x"):
        self.bspline_config = bspline_config
        self.fit_forces = fit_forces
        self.prefix = prefix
        self.columns = bspline_config.get_column_names()

    # -- passthrough properties --------------------------------------------
    @property
    def chemical_system(self):
        return self.bspline_config.chemical_system

    @property
    def degree(self):
        return self.chemical_system.degree

    @property
    def element_list(self):
        return self.chemical_system.element_list

    @property
    def interactions_map(self):
        return self.chemical_system.interactions_map

    @property
    def r_cut(self):
        return self.bspline_config.r_cut

    @property
    def knots_map(self):
        return self.bspline_config.knots_map

    @property
    def interaction_hashes(self):
        return self.chemical_system.interaction_hashes

    @property
    def leading_trim(self):
        return self.bspline_config.leading_trim

    @property
    def trailing_trim(self):
        return self.bspline_config.trailing_trim

    @property
    def supercell_cutoff(self) -> float:
        """Depth of the ghost supercell: the basis's ``r_cut``, and for
        3-body terms twice the longest center leg, which holds both
        neighbors of every ghost center within a leg of the cell."""
        r_cut = float(self.r_cut)
        if self.degree > 2:
            legs = [float(seq[-1]) for trio in self.interactions_map[3]
                    for seq in self.knots_map[trio][:2]]
            r_cut = max(r_cut, 2.0 * max(legs))
        return r_cut

    @staticmethod
    def from_config(bspline_config, config):
        keys = ["prefix", "fit_forces"]
        config = {k: v for k, v in config.items() if k in keys}
        return BasisFeaturizer(bspline_config, **config)

    def __repr__(self):
        return "\n".join(["BasisFeaturizer:",
                          f"    Fit forces: {self.fit_forces}",
                          f"    Column prefix: {self.prefix}",
                          repr(self.bspline_config)])

    # -- per-configuration featurization ------------------------------------
    def featurize_energy_2B(self, geom, supercell=None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        pair_tuples = self.interactions_map[2]
        distances_map = fnp.distances_by_interaction(
            geom, pair_tuples, self.bspline_config.r_min_map,
            self.bspline_config.r_max_map, supercell=supercell)
        feature_map = {
            pair: fnp.energy_features_2b(distances_map[pair],
                                         self.knots_map[pair],
                                         self.leading_trim[2],
                                         self.trailing_trim[2])
            for pair in pair_tuples}
        return flatten_by_interactions(feature_map, pair_tuples)

    def featurize_force_2B(self, geom, supercell=None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        pair_tuples = self.interactions_map[2]
        dist_map, deriv_map = fnp.derivatives_by_interaction(
            geom, pair_tuples, self.r_cut,
            self.bspline_config.r_min_map, self.bspline_config.r_max_map,
            supercell)
        feature_map = {}
        for pair in pair_tuples:
            i_idx, j_idx, unit = deriv_map[pair]
            feature_map[pair] = fnp.force_features_2b(
                dist_map[pair], i_idx, j_idx, unit, len(geom),
                self.knots_map[pair],
                self.leading_trim[2], self.trailing_trim[2])
        return flatten_by_interactions(feature_map, pair_tuples)

    def featurize_energy_3B(self, geom, supercell=None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        trio_list = self.interactions_map[3]
        knot_sets = [self.knots_map[trio] for trio in trio_list]
        grids = fnp.energy_grids_3b(geom, knot_sets,
                                    self.interaction_hashes[3],
                                    supercell=supercell,
                                    n_lead=self.leading_trim[3],
                                    n_trail=self.trailing_trim[3])
        vectors = [self.bspline_config.compress_3B(grids[i], trio)
                   for i, trio in enumerate(trio_list)]
        return np.concatenate(vectors)

    def featurize_force_3B(self, geom, supercell=None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        trio_list = self.interactions_map[3]
        knot_sets = [self.knots_map[trio] for trio in trio_list]
        grids = fnp.force_grids_3b(geom, knot_sets,
                                   self.interaction_hashes[3],
                                   supercell=supercell,
                                   n_lead=self.leading_trim[3],
                                   n_trail=self.trailing_trim[3])
        return np.concatenate(
            [self.bspline_config.compress_3B_batch(grids[i], trio)
             for i, trio in enumerate(trio_list)], axis=-1)

    def _supercell(self, geom):
        if np.any(geom.get_pbc()):
            return geo.get_supercell(geom, r_cut=self.supercell_cutoff)
        return geom

    def featurize_configuration(self, geom, with_forces: bool = True):
        """(energy feature vector without the target column, force
        features (N, 3, n_feats) or None without ``with_forces``)."""
        supercell = self._supercell(geom)
        vector = np.concatenate([
            self.chemical_system.get_composition_tuple(geom),
            self.featurize_energy_2B(geom, supercell)])
        if self.degree > 2:
            vector = np.concatenate(
                [vector, self.featurize_energy_3B(geom, supercell)])
        if not with_forces:
            return vector, None
        vectors = np.concatenate([
            np.zeros((len(geom), 3, len(self.element_list))),
            self.featurize_force_2B(geom, supercell)], axis=2)
        if self.degree > 2:
            vectors = np.concatenate(
                [vectors, self.featurize_force_3B(geom, supercell)], axis=2)
        return vector, vectors

    def evaluate_configuration(self, geom, name: str = None,
                               energy: float = None, forces=None,
                               energy_key: str = "energy") -> Dict:
        """One energy row and/or 3N force rows of features for a
        configuration, keyed as the reference keys them; ``forces`` as
        [fx, fy, fz]."""
        invalid = set(geom.get_chemical_symbols()) - set(self.element_list)
        if invalid:
            warnings.warn(f"Invalid elements: {', '.join(sorted(invalid))}",
                          RuntimeWarning)
            return {}
        if energy is None and forces is None:
            return {}
        vector, vectors = self.featurize_configuration(
            geom, with_forces=forces is not None)
        eval_map = {}
        if energy is not None:
            key = (name, energy_key) if name is not None else energy_key
            eval_map[key] = np.insert(vector, 0, energy)
        if forces is not None:
            for c, component in enumerate(["fx", "fy", "fz"]):
                for a in range(len(geom)):
                    row = np.insert(vectors[a, c, :], 0, forces[c][a])
                    tag = f"{component}_{a}"
                    key = (name, tag) if name is not None else tag
                    eval_map[key] = row
        return eval_map

    # -- datasets -------------------------------------------------------------
    def evaluate(self, df_data, atoms_key: str = "geometry",
                 energy_key: str = "energy") -> "FeatureTable":
        """The feature table of every configuration of a ``Dataset``
        (``data.io``): an energy row per configuration where the dataset
        has the ``energy_key`` column, 3 N force rows where it has fx,
        fy, fz, a configuration's components are all there and
        ``fit_forces`` is on; the reference's row order and names."""
        eval_map = {}
        has_energy = energy_key in df_data
        has_forces = all(k in df_data for k in ("fx", "fy", "fz"))
        for i, name in enumerate(df_data.keys):
            energy = df_data[energy_key][i] if has_energy else None
            forces = None
            if has_forces and self.fit_forces:
                forces = [df_data[c][i] for c in ("fx", "fy", "fz")]
                if any(f is None for f in forces) or np.any(np.isnan(
                        np.concatenate([np.atleast_1d(np.asarray(
                            f, dtype=float)) for f in forces]))):
                    forces = None
            eval_map.update(self.evaluate_configuration(
                df_data[atoms_key][i], name, energy, forces, energy_key))
        values = np.array(list(eval_map.values()), dtype=np.float64)
        return FeatureTable(list(eval_map), list(self.columns),
                            values.reshape(len(eval_map), len(self.columns)))

    def evaluate_parallel(self, df_data, client=None, n_jobs=1, **kwargs):
        """``evaluate`` spread over an executor (``client``, a
        concurrent.futures-style pool such as ``util.parallel``'s
        ``get_executor``): ``df_data`` split into ``n_jobs`` batches, one
        task each, the tables merged and put back in ``df_data``'s key
        order, so that the table equals ``evaluate``'s.  Without a
        client, or with ``n_jobs`` below 2, ``evaluate`` itself.
        ``kwargs``: ``evaluate``'s (``progress`` is dropped)."""
        kwargs.pop("progress", None)
        if client is None or n_jobs < 2:
            return self.evaluate(df_data, **kwargs)
        from uf3_tpu_torch.util import parallel as par
        batches = par.split_dataframe(df_data, n_jobs)
        futures = par.batch_submit(self.evaluate, batches, client, **kwargs)
        table = par.gather_and_merge(futures, client=client)
        present = set(table.names)
        return table.select([key for key in df_data.keys if key in present])

    def batched_to_hdf(self, filename: str, df_data, batch_size: int = 50,
                       table_template: str = "features_{}", progress=None,
                       **kwargs) -> None:
        """Restartable featurization into the HDF5 store ``filename``:
        the reference's batches and table names (``table_batches``),
        each batch featurized by ``evaluate`` (``kwargs``: its
        ``atoms_key`` and ``energy_key``) and written as one table
        before the next starts; tables the file holds are skipped.
        ``progress`` is accepted and unused, as in the reference's
        serial path."""
        existing = existing_tables(filename)
        for table_name, positions in table_batches(len(df_data), batch_size,
                                                   table_template):
            if table_name not in existing:
                save_feature_db(self.evaluate(df_data.take(positions),
                                              **kwargs),
                                filename, table_name=table_name)

    def featurize_dataset(self, geometries: Sequence, energies: Sequence,
                          forces: Sequence = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """Fitting arrays (x_e, y_e, x_f, y_f) of a dataset in
        ``dataframe_to_tuples`` order: per-atom energy rows, one per
        configuration, then the force rows fx_0..fx_{N-1}, fy..., fz... of
        each configuration that has forces (``forces`` None, or an entry
        None, gives none; so does ``fit_forces`` False)."""
        x_e, y_e, x_f, y_f = [], [], [], []
        for i, geom in enumerate(geometries):
            check_elements(geom, self.element_list, i)
            force = None if forces is None or not self.fit_forces \
                else forces[i]
            vector, vectors = self.featurize_configuration(
                geom, with_forces=force is not None)
            n_atoms = len(geom)
            x_e.append(vector / n_atoms)
            y_e.append(energies[i] / n_atoms)
            if force is not None:
                x_f.append(vectors.transpose(1, 0, 2).reshape(
                    3 * n_atoms, -1))
                y_f.append(np.asarray(force, dtype=np.float64).T.reshape(-1))
        n_columns = len(self.columns) - 1
        return (np.stack(x_e), np.array(y_e, dtype=np.float64),
                np.concatenate(x_f) if x_f else np.zeros((0, n_columns)),
                np.concatenate(y_f) if y_f else np.zeros(0))


class FeatureTable:
    """Feature rows of a dataset as the reference's DataFrame holds them:
    ``index`` the (configuration key, kind) of each row (kind: the
    energy key, or "fx_<atom>", "fy_<atom>", "fz_<atom>"), ``columns``
    the column names ("y", then the features), ``values`` the
    (rows, columns) float64 array."""

    def __init__(self, index: List[Tuple], columns: List[str],
                 values: np.ndarray):
        self.index = list(index)
        self.columns = list(columns)
        self.values = np.asarray(values, dtype=np.float64)

    def __len__(self) -> int:
        return len(self.index)

    @property
    def names(self) -> List:
        """The configuration key of each row."""
        return [name for name, _ in self.index]

    @property
    def kinds(self) -> List[str]:
        return [kind for _, kind in self.index]

    def to_numpy(self, dtype=np.float64) -> np.ndarray:
        return self.values.astype(dtype)

    def drop(self, columns) -> "FeatureTable":
        """The table without the named ``columns`` (KeyError for a name
        it lacks), as ``df.drop(columns=...)``."""
        dropped = set(columns)
        missing = sorted(dropped - set(self.columns))
        if missing:
            raise KeyError(f"{missing} not found in the features' columns")
        keep = [i for i, c in enumerate(self.columns) if c not in dropped]
        return FeatureTable(self.index, [self.columns[i] for i in keep],
                            self.values[:, keep])

    def select(self, keys) -> "FeatureTable":
        """The rows of the configurations ``keys``, configuration by
        configuration in the order of ``keys``, as ``df.loc[keys]``."""
        rows: Dict = {}
        for i, name in enumerate(self.names):
            rows.setdefault(name, []).append(i)
        picked = [i for key in keys for i in rows[key]]
        return FeatureTable([self.index[i] for i in picked], self.columns,
                            self.values[np.asarray(picked, dtype=np.int64)])


def check_elements(geom, element_list, index: int) -> None:
    """Raise for a configuration holding elements outside the basis."""
    invalid = set(geom.get_chemical_symbols()) - set(element_list)
    if invalid:
        raise ValueError(f"configuration {index} holds elements outside "
                         f"the basis: {', '.join(sorted(invalid))}")


# ---------------------------------------------------------------------------
# HDF5 feature store (the reference's h5py layout, through util/hdf5.py)
# ---------------------------------------------------------------------------
def table_batches(n_configs: int, batch_size: int = 50,
                  table_template: str = "features_{}"):
    """(table name, configuration positions) of each table
    ``batched_to_hdf`` writes: ``np.array_split`` into one batch more
    than ``batch_size`` fits past the first, names zero-padded to at
    least three digits, as the reference splits and names them."""
    positions = np.arange(n_configs)
    batches = np.array_split(positions, np.maximum(
        1, len(positions[batch_size::batch_size]) + 1))
    width = max(int(np.ceil(np.log10(len(batches)) + 0.1)), 3)
    return [(table_template.format(str(j).rjust(width, "0")), batch)
            for j, batch in enumerate(batches)]


def existing_tables(filename: str) -> List[str]:
    """The tables ``filename`` holds (with the reference's
    ``RuntimeWarning``), none where it does not exist."""
    if not os.path.isfile(filename):
        return []
    _, _, names, _ = analyze_hdf_tables(filename)
    warnings.warn(f"File already exists: contains {len(names)} chunks.",
                  RuntimeWarning)
    return names


def save_feature_db(table: FeatureTable, filename: str,
                    table_name: str = "features") -> None:
    """Add one feature table to ``filename`` (created where missing),
    replacing a table of that name: ``values`` and the row index and
    column names as strings."""
    with hdf5.File(filename, "a") as f:
        f.write_group(table_name, {
            "values": np.asarray(table.values, dtype=np.float64),
            "row_names": [str(name) for name in table.names],
            "row_kinds": [str(kind) for kind in table.kinds],
            "columns": [str(c) for c in table.columns]})


def load_feature_db(filename: str,
                    table_name: str = "features") -> FeatureTable:
    with hdf5.File(filename) as f:
        values = f.read(f"{table_name}/values")
        names, kinds, columns = (f.read(f"{table_name}/{member}") for member
                                 in ("row_names", "row_kinds", "columns"))
    return FeatureTable(list(zip(names, kinds)), columns, values)


def analyze_hdf_tables(filename: str) -> Tuple[int, int, List, Dict]:
    """(number of tables, rows in all, sorted names, rows per name)."""
    with hdf5.File(filename) as f:
        lengths = {name: f.shape(f"{name}/values")[0] for name in f.keys()}
    return (len(lengths), int(sum(lengths.values())), sorted(lengths),
            lengths)


def dataframe_batch_loader(filename: str, table_names: List[str]):
    for table_name in table_names:
        yield load_feature_db(filename, table_name)
