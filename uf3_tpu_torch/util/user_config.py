"""
Settings of the ``featurize``, ``fit`` and ``predict`` commands, with
type-checked defaults, and the handler factory that builds the
DataCoordinator / ChemicalSystem / BSplineBasis / Featurizer /
WeightedLinearModel objects from one settings dictionary.

Counterpart of the part of ``uf3_tpu/util/user_config.py`` those
commands read (``read_config``, ``generate_handlers`` for ``data``,
``elements``, ``degree``, ``basis``, ``features``, ``model``,
``learning``).  Settings are written as JSON, which is a subset of the
YAML ``uf3_tpu`` reads, so one file serves both packages; the GPU hosts
carry no YAML parser.  The
basis's ``r_min`` / ``r_max`` / ``resolution`` may also be maps keyed
as in the model files ("W-W", "W-W-W"), and its ``knots_map`` (knot
sequences of any spacing) one too, which only this package reads.  The
defaults are those of ``uf3_tpu/default_options.yaml`` that these
commands read, the features file ``features.h5`` among them (the HDF5
store, through ``util/hdf5.py``); an ``.npz`` path works too.
"""

import copy
import json
import os
import re
from typing import Dict

import numpy as np

from uf3_tpu_torch.data import composition, elements, io
from uf3_tpu_torch.ops import featurize
from uf3_tpu_torch.regression import least_squares
from uf3_tpu_torch.representation import basis
from uf3_tpu_torch.util import json_io

def get_element_tuple(string: str):
    """The element symbols in ``string`` (e.g. "W-W" or "NeXe"), sorted
    by atomic number."""
    element_tuple = re.compile("[A-Z][a-z]?").findall(string)
    return tuple(sorted(element_tuple,
                        key=lambda el: elements.atomic_numbers[el]))


DEFAULT_SETTINGS = {
    "elements": None,
    "degree": 2,
    "data": {
        "max_per_file": -1,
        "min_diff": 0.0,
        "vasp_pressure": False,
        "sources": {"path": "./data", "pattern": "*"},
        "keys": {"atoms_key": "geometry", "energy_key": "energy",
                 "force_key": "forces", "size_key": "size"},
    },
    "basis": {
        "r_min": None,
        "r_max": None,
        "resolution": None,
        "fit_offsets": True,
        "trailing_trim": 3,
        "knot_strategy": "linear",
        "knots_map": None,
    },
    "features": {"features_path": "features.h5", "fit_forces": True,
                 "column_prefix": "x"},
    "model": {"model_path": "model.json"},
    "learning": {
        "features_path": "features.h5",
        "weight": 0.5,
        "regularizer": {
            "ridge_1b": 1.0e-16,
            "ridge_2b": 0.0,
            "ridge_3b": 1.0e-10,
            "curvature_2b": 1.0e-16,
            "curvature_3b": 1.0e-16,
        },
    },
}


def type_check(value, reference):
    """Coerce a user-supplied ``value`` toward the type of the packaged
    default ``reference``.  Scalars cast when the cast is meaningful,
    sequences normalize to lists, and dicts recurse through
    consistency_check; anything else passes through untouched so unknown
    shapes fail later with a clear error at the consuming handler."""
    if isinstance(reference, bool):
        return bool(value)
    if isinstance(reference, (int, float, np.floating)) \
            and isinstance(value, (int, float, np.floating, str)):
        return type(reference)(value)
    if isinstance(reference, (list, tuple)) \
            and isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(reference, dict):
        return consistency_check(value, reference)
    return value


def consistency_check(settings: Dict, reference: Dict) -> Dict:
    """Merge ``settings`` over the ``reference`` defaults: unknown keys
    drop, missing keys fill from the defaults, shared keys coerce."""
    return {key: type_check(settings[key], default)
            if key in settings else default
            for key, default in reference.items()}


def read_config(settings_filename: str) -> Dict:
    """Load JSON settings; file entries override the packaged defaults
    only when the value types are compatible."""
    with open(settings_filename) as f:
        text = f.read()
    try:
        settings = json.loads(text)
    except json.JSONDecodeError as err:
        raise ValueError(f"{settings_filename}: settings must be written as "
                         f"JSON (a subset of YAML that uf3_tpu reads too): "
                         f"{err}") from None
    defaults = copy.deepcopy(DEFAULT_SETTINGS)
    for key in settings:
        if key in defaults:
            settings[key] = type_check(settings[key], defaults[key])
    return settings


def _build_data(settings, handlers, device):
    return io.DataCoordinator.from_config(settings["data"]["keys"])


def _build_chemical_system(settings, handlers, device):
    if not settings["elements"]:
        return None
    return composition.ChemicalSystem(element_list=settings["elements"],
                                      degree=settings["degree"])


def _build_basis(settings, handlers, device):
    block = {**settings["basis"], **handlers["chemical_system"].as_dict()}
    for key in ("r_min", "r_max", "resolution", "knots_map"):
        # per-interaction maps keyed as in the model files ("W-W-W")
        if isinstance(block.get(key), dict):
            block[key] = json_io.decode_interaction_map(block[key])
    return basis.BSplineBasis.from_dict(block)


def _build_features(settings, handlers, device):
    block = settings["features"]
    return featurize.Featurizer(handlers["basis"],
                                fit_forces=block.get("fit_forces", True),
                                prefix=block.get("column_prefix", "x"),
                                device=device)


def _build_model(settings, handlers, device):
    model_path = settings["model"].get("model_path", "")
    if not os.path.isfile(model_path):
        return None
    model = least_squares.WeightedLinearModel(handlers["basis"],
                                              device=device)
    model.load(filename=model_path)
    return model


def _build_learning(settings, handlers, device):
    # the settings spell the penalties out ("curvature_2b"); the model
    # kwargs use the short forms ("c_2b", "ridge" -> "r").
    reg = {k.replace("curvature", "c").replace("ridge", "r"): v
           for k, v in settings["learning"]["regularizer"].items()}
    return least_squares.WeightedLinearModel(handlers["basis"],
                                             device=device, **reg)


# handler name -> (settings keys required, handlers required, builder).
# Order matters: later builders consume earlier handlers.
_HANDLER_RECIPES = (
    ("data", ("data",), (), _build_data),
    ("chemical_system", ("elements", "degree"), (), _build_chemical_system),
    ("basis", ("basis",), ("chemical_system",), _build_basis),
    ("features", ("features",), ("basis",), _build_features),
    ("model", ("model",), ("basis",), _build_model),
    ("learning", ("learning",), ("basis",), _build_learning),
)


def generate_handlers(settings: Dict, device=None) -> Dict:
    """Build pipeline objects from a settings dictionary: the data
    coordinator (``data``, of the ``data.keys``), the chemical system,
    the basis, the featurizer (``features``: a ``featurize.Featurizer``,
    which picks the device or host route the basis allows, with the
    settings' ``fit_forces`` and ``column_prefix``), a model
    loaded from ``model.model_path`` when that file exists (``model``)
    and the model to fit (``learning``), both on ``device``.  Each
    handler is attempted only when its settings sections and upstream
    handlers exist; malformed sections are skipped, not fatal."""
    handlers: Dict = {}
    for name, needs_settings, needs_handlers, build in _HANDLER_RECIPES:
        if not all(k in settings for k in needs_settings):
            continue
        if not all(h in handlers for h in needs_handlers):
            continue
        try:
            built = build(settings, handlers, device)
        except (KeyError, ValueError):
            continue
        if built is not None:
            handlers[name] = built
    return handlers
