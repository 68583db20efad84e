"""
Build and load the package's CUDA kernels: ``nvcc`` compiles every
``csrc/*.cu`` for sm_90a (one compiler process per source, all started
together) and links the objects into one shared library with a plain C
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# uf3_trio_partials_{f32,f64}(d, valid, cweight, gwin, tables, energy,
#   fc, part, n_atoms, K, legs, ints, w_lo, ww, c_lo, cw, with_energy,
#   triangle, stream) (cweight: the center weights, or null; triangle:
#   1 for the triangle lanes);
# uf3_trio_occupancy(is_f64, n_atoms, K, ints, ww, cw, with_energy,
#   triangle, out)
_SIGNATURES = {
    name: [_P] * 8 + [_I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    for name in ("uf3_trio_partials_f32", "uf3_trio_partials_f64")}
_SIGNATURES["uf3_trio_occupancy"] = [_I, _I, _I, _P, _I, _I, _I, _I, _P]
# uf3_trio_multi_{f32,f64}(d, valid, s_slot, s_center, ints, reals,
#   tables, grids, energy, fc, part, n_atoms, K, n_species, max_cols,
#   n_ints, n_reals, n_tables, n_grids, with_energy, stream);
# uf3_trio_multi_occupancy(is_f64, n_atoms, K, n_species, max_cols,
#   n_ints, n_reals, n_tables, n_grids, with_energy, out)
for _name in ("uf3_trio_multi_f32", "uf3_trio_multi_f64"):
    _SIGNATURES[_name] = [_P] * 11 + [_I] * 9 + [_P]
_SIGNATURES["uf3_trio_multi_occupancy"] = [_I] * 10 + [_P]
# uf3_gather_rows(table, idx, out, n_entries, w, elem_bytes, index_bytes,
#   code, wide, table_align, stream); uf3_gather_lanes(t, li, out,
#   n_rows, b, width, elem_bytes, index_bytes, lanes, wide, stream);
#   uf3_rev_gather(part, idx, rev, out, n_entries, w, kp, elem_bytes,
#   index_bytes, code, wide, part_align, stream);
#   uf3_gather_occupancy(kind, code, wide,
#   elem_bytes, index_bytes, out)
_L = ctypes.c_longlong
_SIGNATURES["uf3_gather_rows"] = [_P] * 3 + [_L] + [_I] * 6 + [_P]
_SIGNATURES["uf3_gather_lanes"] = [_P] * 3 + [_L, _I, _L] + [_I] * 4 + [_P]
_SIGNATURES["uf3_gather_occupancy"] = [_I] * 5 + [_P]
_SIGNATURES["uf3_rev_gather"] = [_P] * 4 + [_L] + [_I] * 7 + [_P]
# uf3_relayout(x, out, out2, n, max_offset, mode, in_cols, out_cols, k, w,
#   offset, elem_bytes, stream); uf3_lane_contract(x, w, out, n,
#   max_offset, cols_out, terms, in_cols, sj, st, is_f64, stream);
#   uf3_lane_map(op, x, idx, grid, out, out2, n, n_classes, g_s0, g_s1,
#   is_f64, stream)
_SIGNATURES["uf3_relayout"] = [_P] * 3 + [_L, _L, _I, _L, _L] + [_I] * 4 \
    + [_P]
_SIGNATURES["uf3_lane_contract"] = [_P] * 3 + [_L] * 3 + [_I] + [_L] * 3 \
    + [_I, _P]
_SIGNATURES["uf3_lane_map"] = [_I] + [_P] * 5 + [_L] + [_I] * 4 + [_P]
# uf3_relayout_occupancy(mode, elem_bytes, out)
_SIGNATURES["uf3_relayout_occupancy"] = [_I, _I, _P]
# uf3_lane_contract_occupancy: uf3_lane_contract's arguments, the plan last
_SIGNATURES["uf3_lane_contract_occupancy"] = \
    _SIGNATURES["uf3_lane_contract"][:-1] + [_P]

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


def build(force: bool = False, csrc: str = None,
          library: str = None) -> dict:
    """Compile the kernels of ``csrc`` (the package's by default) into
    ``library`` (``LIBRARY``) unless the library is newer than every
    source and header.  Returns {"seconds", "log", "built"}; raises with
    the compiler's output on failure."""
    csrc, library = csrc or CSRC, library or LIBRARY
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    inputs = sources + glob.glob(os.path.join(csrc, "*.cuh"))
    if (not force and os.path.isfile(library)
            and os.path.getmtime(library)
            >= max(os.path.getmtime(s) for s in inputs)):
        return {"seconds": 0.0, "log": "", "built": False}
    out_dir = os.path.dirname(library)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    objects = [os.path.join(out_dir,
                            f"{os.path.basename(src)}.{os.getpid()}.o")
               for src in sources]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    compiles = []
    try:
        for src, obj in zip(sources, objects):
            cmd = [nvcc] + COMPILE_FLAGS + ["-o", obj, src]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, proc in compiles:
            out = proc.communicate(timeout=900)[0]
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp] + objects
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for _, running in compiles:
            if running.poll() is None:
                running.kill()
                running.wait()
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, library)
    return {"seconds": seconds, "log": "".join(log) + proc.stdout
            + proc.stderr, "built": True}


def launch(name: str, fn, *args):
    """Call the C entry ``fn`` and raise if it returns a CUDA error (or
    -1 for arguments it does not take)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def load(path: str) -> ctypes.CDLL:
    """The library at ``path`` (this package's or a build of a copy of
    its sources) with the argument types of every C entry it has."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    if "lib" not in _loaded:
        build()
        _loaded["lib"] = load(LIBRARY)
    return _loaded["lib"]
