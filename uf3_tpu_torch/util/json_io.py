"""
Reading interaction-keyed model files: dash-joined string keys
("W-W-W") become tuples, (nested) lists become numpy arrays.

Trimmed copy of the reader half of ``uf3_tpu/util/json_io.py``.
"""

import json

import numpy as np


def decode_interaction_map(formatted_map: dict) -> dict:
    decoded = {}
    for key, value in formatted_map.items():
        if isinstance(value, list):
            if value and isinstance(value[0], list):
                value = [np.array(row) for row in value]
            else:
                value = np.array(value)
        elif isinstance(value, dict):
            value = decode_interaction_map(value)
        if "-" in key:
            parts = key.split("-")
            try:
                parts = [int(p) for p in parts]
            except ValueError:
                pass
            key = tuple(parts)
        decoded[key] = value
    return decoded


def load_interaction_map(filename: str) -> dict:
    with open(filename, "r") as f:
        formatted_map = json.load(f)
    return decode_interaction_map(formatted_map)
