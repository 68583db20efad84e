"""
Build and load the package's CUDA kernels: ``nvcc`` compiles every
``csrc/*.cu`` for sm_90a into one shared library with a plain C
interface under ``build/`` (at first use, not at import), loaded with
``ctypes``.  Pointers and the stream pass as ``c_void_p``; each C entry
returns ``cudaGetLastError()`` after its launch.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD, "libuf3_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# uf3_trio_partials_{f32,f64}(d, valid, cweight, gwin, tables, energy,
#   fc, part, n_atoms, K, legs, ints, w_lo, ww, c_lo, cw, with_energy,
#   triangle, stream) (cweight: the center weights, or null; triangle:
#   1 for the triangle lanes);
# uf3_trio_occupancy(is_f64, K, ints, ww, cw, with_energy, triangle, out)
_SIGNATURES = {
    name: [_P] * 8 + [_I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    for name in ("uf3_trio_partials_f32", "uf3_trio_partials_f64")}
_SIGNATURES["uf3_trio_occupancy"] = [_I, _I, _P, _I, _I, _I, _I, _P]
# uf3_trio_multi_{f32,f64}(d, valid, s_slot, s_center, ints, reals,
#   tables, grids, energy, fc, part, n_atoms, K, n_species, max_cols,
#   n_ints, n_reals, n_tables, n_grids, with_energy, stream);
# uf3_trio_multi_occupancy(is_f64, n_atoms, K, n_species, max_cols,
#   n_ints, n_reals, n_tables, n_grids, with_energy, out)
for _name in ("uf3_trio_multi_f32", "uf3_trio_multi_f64"):
    _SIGNATURES[_name] = [_P] * 11 + [_I] * 9 + [_P]
_SIGNATURES["uf3_trio_multi_occupancy"] = [_I] * 10 + [_P]
# uf3_gather_rows(table, idx, out, n_entries, w, elem_bytes, index_bytes,
#   stream); uf3_gather_lanes(t, li, out, n_rows, b, width, elem_bytes,
#   index_bytes, stream); uf3_rev_gather(part, idx, rev, out, n_entries,
#   w, kp, elem_bytes, index_bytes, stream)
_L = ctypes.c_longlong
_SIGNATURES["uf3_gather_rows"] = [_P] * 3 + [_L] + [_I] * 3 + [_P]
_SIGNATURES["uf3_gather_lanes"] = [_P] * 3 + [_L] + [_I] * 4 + [_P]
_SIGNATURES["uf3_rev_gather"] = [_P] * 4 + [_L] + [_I] * 4 + [_P]

_loaded = {}  # the library handle once loaded in this process


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build(force: bool = False) -> dict:
    """Compile the kernels unless the library is newer than every
    source and header.  Returns {"seconds", "log", "built"}; raises with
    the compiler's output on failure."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    inputs = sources + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (not force and os.path.isfile(LIBRARY)
            and os.path.getmtime(LIBRARY)
            >= max(os.path.getmtime(s) for s in inputs)):
        return {"seconds": 0.0, "log": "", "built": False}
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp] + sources
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return {"seconds": seconds, "log": proc.stdout + proc.stderr,
            "built": True}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    if "lib" not in _loaded:
        build()
        lib = ctypes.CDLL(LIBRARY)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]
