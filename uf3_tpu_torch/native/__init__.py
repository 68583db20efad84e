"""
The native host runtime (``uf3_native.cpp``, loaded through ``ctypes``):
an extended-xyz tokenizer for large training sets and an O(N) host cell
list.

The library is built with ``g++ -O3 -shared -fPIC`` at first use (never
at import) into the package's ``build/`` directory, and built again when
the source is newer than it.  A build or load that fails raises
``RuntimeError`` with the compiler's command and its output: nothing
goes quietly back to Python.

- ``parse_extxyz_fast(filename)``: the configurations of an extended-xyz
  file, as ``data.io.read_xyz`` reads them.  The native side finds the
  frames and reads the atom lines; the comment lines are parsed by
  ``data.io``'s own parsers, and each frame's columns are placed by its
  own ``Properties``.  So a frame without force columns has no forces, a
  position column is read where ``Properties`` puts it, and an unknown
  species raises ``KeyError``.  A frame whose ``Properties`` holds a
  string column besides the species, or lacks the species or the
  positions, is read by ``data.io.read_xyz_python`` from its own text.
- ``cell_list_neighbors(positions, cell, pbc, r_cut, capacity)``: (idx
  (N, capacity), shift (N, capacity, 3) in cell vectors of the wrapped
  positions, mask (N, capacity), the largest neighbor count).
- ``available()``: whether the library builds and loads here; no
  reader uses it to fall back to Python quietly.
"""

import ctypes
import errno
import os
import subprocess
import tempfile
from io import StringIO
from typing import List, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "uf3_native.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
LIBRARY = os.path.join(BUILD, "libuf3native.so")
# the error codes of the C entries (uf3_native.cpp)
_IO_ERROR, _UNKNOWN_SPECIES, _FORMAT_ERROR = 1, 2, 3
_ERR_LEN = 1024

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_lib = None


class _XyzIndex(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_char)),
                ("size", _I64),
                ("n_frames", _I64)] + [
        (name, ctypes.POINTER(_I64))
        for name in ("n_atoms", "comment_start", "comment_end",
                     "body_start", "body_end", "line")]


def build() -> str:
    """Compile ``uf3_native.cpp`` into ``LIBRARY`` (through a file of its
    own, then renamed, so that processes building at once do not read a
    half-written library); raise with the command and its output if the
    compiler fails."""
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SOURCE]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: "
                           f"{exc}") from exc
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed (exit {out.returncode}): "
                           f"{' '.join(cmd)}\n{out.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load() -> ctypes.CDLL:
    """The library, built first where it is missing or older than its
    source."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.isfile(LIBRARY) \
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
        build()
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as exc:
        raise RuntimeError(f"native library {LIBRARY} did not load: "
                           f"{exc}") from exc
    lib.uf3_xyz_index.restype = ctypes.c_int
    lib.uf3_xyz_index.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(_XyzIndex)),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, _I64]
    lib.uf3_xyz_tokenize.restype = ctypes.c_int
    lib.uf3_xyz_tokenize.argtypes = [
        ctypes.POINTER(_XyzIndex), _P, _I64, _P, _P, ctypes.c_char_p, _P, _P,
        ctypes.c_char_p, _I64]
    lib.uf3_xyz_free.argtypes = [ctypes.POINTER(_XyzIndex)]
    lib.uf3_xyz_free.restype = None
    lib.cell_list_neighbors.restype = _I64
    lib.cell_list_neighbors.argtypes = [
        _P, _I64, _P, _P, ctypes.c_double, _I64, _P, _P, _P]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (``load`` raises where
    it does not).  A query for callers: the readers choose the native
    path by a file's layout, and raise where it fails."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _raise(code: int, err, filename: str, os_errno: int = 0):
    message = err.value.decode(errors="replace")
    if code == _IO_ERROR:
        raise OSError(os_errno or errno.EIO, message, filename)
    if code == _UNKNOWN_SPECIES:
        raise KeyError(message)
    raise ValueError(f"{filename}: {message}")


def _layout(props) -> Tuple[int, int, bool]:
    """(the species' token column, the columns declared, whether the
    tokenizer takes the frame: a one-column species, a three-column
    position and no other string column)."""
    col, species = 0, -1
    others_numeric, has_pos = True, False
    for name, kind, width in props:
        if name == "species" and kind == "S" and width == 1:
            species = col
        elif name == "pos":
            has_pos = kind == "R" and width == 3
        elif kind == "S":
            others_numeric = False
        col += width
    return species, col, species >= 0 and has_pos and others_numeric


def parse_extxyz_fast(filename: str) -> List:
    """The configurations of the extended-xyz file ``filename``, equal to
    ``data.io.read_xyz(filename)``'s."""
    from uf3_tpu_torch.data import elements
    from uf3_tpu_torch.data import io as data_io
    lib = load()
    err = ctypes.create_string_buffer(_ERR_LEN)
    os_errno = ctypes.c_int(0)
    handle = ctypes.POINTER(_XyzIndex)()
    code = lib.uf3_xyz_index(os.fsencode(filename), ctypes.byref(handle),
                             ctypes.byref(os_errno), err, _ERR_LEN)
    if code:
        _raise(code, err, filename, os_errno.value)
    try:
        index = handle.contents
        n_frames = index.n_frames
        base = ctypes.cast(index.data, ctypes.c_void_p).value

        def field(name):
            return np.ctypeslib.as_array(getattr(index, name),
                                         (max(n_frames, 1),))[:n_frames]

        n_atoms, c0, c1, b0, b1 = (field(k).copy() for k in (
            "n_atoms", "comment_start", "comment_end", "body_start",
            "body_end"))

        def text(start, end):
            return ctypes.string_at(base + int(start),
                                    int(end - start)).decode()

        comments, layouts = [], []
        for f in range(n_frames):
            comment_line = text(c0[f], c1[f])
            comment = data_io._parse_xyz_comment(comment_line)
            props = data_io._parse_properties(
                comment.get("Properties", data_io.DEFAULT_PROPERTIES))
            comments.append((comment_line, comment, props))
            layouts.append(_layout(props))
        native = np.array([f for f in range(n_frames) if layouts[f][2]],
                          dtype=np.int64)
        species_col = np.array([layouts[f][0] for f in native],
                               dtype=np.int32)
        n_cols = np.array([layouts[f][1] for f in native], dtype=np.int32)
        n_native = n_atoms[native] if len(native) else np.zeros(0, np.int64)
        numbers = np.zeros(max(int(n_native.sum()), 1), dtype=np.int64)
        values = np.zeros(max(int((n_native * (n_cols - 1)).sum()), 1),
                          dtype=np.float64)
        symbols = " ".join(sorted(elements.atomic_numbers,
                                  key=elements.atomic_numbers.get))
        code = lib.uf3_xyz_tokenize(
            handle, native.ctypes.data, len(native), species_col.ctypes.data,
            n_cols.ctypes.data, symbols.encode(), numbers.ctypes.data,
            values.ctypes.data, err, _ERR_LEN)
        if code:
            _raise(code, err, filename)
        geometries = []
        k = atom = value = 0
        for f in range(n_frames):
            comment_line, comment, props = comments[f]
            if not layouts[f][2]:
                # a layout the tokenizer does not take: the frame's own
                # text through the Python reader
                geometries.extend(data_io.read_xyz_python(StringIO(
                    f"{n_atoms[f]}\n{comment_line}\n" + text(b0[f], b1[f]))))
                continue
            n, cols = int(n_atoms[f]), int(n_cols[k])
            block = values[value:value + n * (cols - 1)].reshape(n, cols - 1)
            columns = {}
            col = 0
            for name, kind, width in props:
                if name != "species":
                    columns[name] = (kind, width, block[:, col:col + width])
                    col += width
            geometries.append(data_io._frame(
                comment, numbers[atom:atom + n], columns))
            atom += n
            value += n * (cols - 1)
            k += 1
        return geometries
    finally:
        lib.uf3_xyz_free(handle)


def cell_list_neighbors(positions: np.ndarray, cell: np.ndarray, pbc,
                        r_cut: float, capacity: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """O(N) host neighbor list: (idx (N, capacity) int32, shift (N,
    capacity, 3), mask (N, capacity) bool, the largest neighbor count,
    which may exceed ``capacity``)."""
    lib = load()
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc_arr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(pbc, dtype=bool), (3,)).astype(np.uint8))
    if positions.ndim != 2 or positions.shape[1] != 3 \
            or cell.shape != (3, 3) or capacity < 1 or not r_cut > 0:
        raise ValueError(f"cell_list_neighbors takes (N, 3) positions, a "
                         f"(3, 3) cell, r_cut > 0 and capacity >= 1; got "
                         f"{positions.shape}, {cell.shape}, {r_cut}, "
                         f"{capacity}")
    n = len(positions)
    idx = np.zeros((n, capacity), dtype=np.int32)
    shift = np.zeros((n, capacity, 3), dtype=np.float64)
    mask = np.zeros((n, capacity), dtype=np.uint8)
    max_count = lib.cell_list_neighbors(
        positions.ctypes.data, n, cell.ctypes.data, pbc_arr.ctypes.data,
        float(r_cut), capacity, idx.ctypes.data, shift.ctypes.data,
        mask.ctypes.data)
    return idx, shift, mask.astype(bool), int(max_count)
