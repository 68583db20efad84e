"""
Reading and writing interaction-keyed model files: dash-joined string
keys ("W-W-W") become tuples, (nested) lists become numpy arrays, and
back; floats are written with 17 significant digits and leaf vectors on
one line, so a file written here loads in ``uf3_tpu`` and the reference
UF3, and theirs here.

Copy of ``uf3_tpu/util/json_io.py``.
"""

import json
from typing import Union

import numpy as np


def encode_interaction_map(interaction_map: dict) -> dict:
    encoded = {}
    for key, value in interaction_map.items():
        if isinstance(value, list) and value \
                and isinstance(value[0], np.ndarray):
            value = [entry.tolist() for entry in value]
        if isinstance(value, np.ndarray):
            value = value.tolist()
        elif isinstance(value, dict):
            value = encode_interaction_map(value)
        elif isinstance(value, (np.floating,)):
            value = float(value)
        elif isinstance(value, (np.integer,)):
            value = int(value)
        if isinstance(key, tuple):
            key = "-".join(str(item) for item in key)
        encoded[key] = value
    return encoded


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


def dump_interaction_map(interaction_map: dict,
                         indent: int = 4,
                         filename: str = None,
                         write: bool = False) -> Union[str, None]:
    text = json.dumps(encode_interaction_map(interaction_map),
                      indent=indent, cls=CompactJSONEncoder)
    if write:
        with open(filename, "w") as f:
            f.write(text)
        return None
    return text


def load_interaction_map(filename: str) -> dict:
    with open(filename, "r") as f:
        formatted_map = json.load(f)
    return decode_interaction_map(formatted_map)


class CompactJSONEncoder(json.JSONEncoder):
    """JSON encoder that keeps primitive-only containers on one line and
    prints floats with 17 significant digits."""

    CONTAINER_TYPES = (list, tuple, dict)
    INDENTATION_CHAR = " "

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.indentation_level = 0

    def encode(self, o):
        if isinstance(o, (list, tuple)):
            if self._primitives_only(o):
                return "[" + ", ".join(self.encode(el) for el in o) + "]"
            self.indentation_level += 1
            body = [self.indent_str + self.encode(el) for el in o]
            self.indentation_level -= 1
            return "[\n" + ",\n".join(body) + "\n" + self.indent_str + "]"
        if isinstance(o, dict):
            if not o:
                return "{}"
            if self._primitives_only(o):
                return ("{ " + ", ".join(
                    f"{self.encode(k)}: {self.encode(v)}"
                    for k, v in o.items()) + " }")
            self.indentation_level += 1
            body = [self.indent_str + f"{json.dumps(k)}: {self.encode(v)}"
                    for k, v in o.items()]
            self.indentation_level -= 1
            return "{\n" + ",\n".join(body) + "\n" + self.indent_str + "}"
        if isinstance(o, float):
            return format(o, ".17g")
        if isinstance(o, str):
            return f'"{o.replace(chr(10), chr(92) + "n")}"'
        return json.dumps(o)

    def _primitives_only(self, o):
        if isinstance(o, (list, tuple)):
            return not any(isinstance(el, self.CONTAINER_TYPES) for el in o)
        return not any(isinstance(el, self.CONTAINER_TYPES)
                       for el in o.values())

    @property
    def indent_str(self) -> str:
        return self.INDENTATION_CHAR * (self.indentation_level * self.indent)
