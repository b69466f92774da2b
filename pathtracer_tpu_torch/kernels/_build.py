"""Build and load the port's CUDA kernels.

`library()` compiles every `csrc/*.cu` file with `nvcc` for `sm_90a` (one
`nvcc` process per source, all started together), links the objects into
one shared library with a plain C interface, at first use, and loads it
with `ctypes`. The build lands in `kernels/_build/<hash of the sources>/`,
so a changed source rebuilds and an unchanged one is loaded as it is.
Nothing here runs at import time.

`--fmad=false` keeps nvcc from contracting `a*b - c*d` into FMAs: the
watertight triangle's edge functions must round like the plain twin's
separate multiplies and subtracts, or shared-edge hits change prim ids.
IEEE division and sqrt stay on (no `--use_fast_math`): the sweep and the
GGX D depend on them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "--resource-usage"]

_LIB = None
BUILD_INFO: dict = {}


def _sources():
    names = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, f) for f in names]


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build():
    """Compile the kernels (if the sources changed) -> path of the library."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libpt_kernels.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in srcs if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(p)[:-3] + ".o")
            for p in cus]
    t0 = time.perf_counter()
    procs = [(p, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, p],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p, o in zip(cus, objs)]
    logs, failed = [], []
    for p, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(p)} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(p))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs], capture_output=True, text=True)
        logs.append(f"== link (rc {link.returncode})\n"
                    + link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    secs = time.perf_counter() - t0
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join([nvcc, *NVCC_FLAGS]) + "\n" + log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(path=lib_path, seconds=secs, cached=False, log=log)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (rays, n, sweep, p_rows, resident_rows, out, stream)
    "dense_sweep_closest": [_P, _I, _P, _I, _I, _P, _P],
    # (rays, live | null, n, sweep, p_rows, resident_rows, out, stream)
    "dense_sweep_any": [_P, _P, _I, _P, _I, _I, _P, _P],
    # (which: 0 closest, 1 any; p_rows; resident_rows; regs*, local_bytes*,
    #  static_bytes*, dynamic_bytes*, blocks_per_sm*)
    "dense_sweep_attrs": [_I, _I, _I, _P, _P, _P, _P, _P],
    # (u, nu, state, out, n, sweep, p_rows, prim, p_pad, mat, light, spec,
    #  spec_rows, args*, stream)
    "fused_round_launch": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P,
                           _I, _P, _P],
    # (u, state, ef, mf, k2, n, sweep, p_rows, resident_rows, prim, p_pad,
    #  mat, light, spec, args*, stream)
    "shade_sweep_launch": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P,
                           _P, _P, _P, _P],
    # (u, state, k2, out, n, sweep, p_rows, resident_rows, args*, stream)
    "finalize_sweep_launch": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _P],
    # (src, row0, alive_row, sweep, p_rows, resident_rows, out, n, stream)
    "sweep_closest_rows_launch": [_P, _I, _I, _P, _I, _I, _P, _I, _P],
    # (u, state, tp, ef, tf, mf, k2, n, prim, p_pad, mat, light, spec,
    #  args*, stream)
    "shade_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                     _P],
    # (src, row0, tmax_row, live_row | -1, sweep, p_rows, resident_rows,
    #  out, n, stream)
    "sweep_any_rows_launch": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P],
    # (u, state, k2, blk, out, n, args*, stream)
    "finalize_launch": [_P, _P, _P, _P, _P, _I, _P, _P],
    # (u, state, q, film, n, sweep, p_rows, resident_rows, prim,
    #  p_pad, mat, spec, args*, stream)
    "lt_shade_launch": [_P, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                        _P],
    # (u, usp, state, q, out, film, n, sweep, p_rows, resident_rows,
    #  light, spec, lcdf, args*, stream)
    "lt_finalize_spawn_launch": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P,
                                 _P, _P, _P, _P],
    # (u, state, q, feed, out, film, n, sweep, p_rows, resident_rows,
    #  args*, stream)
    "lt_finalize_launch": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P],
    # (c_lanes, regs*, local_bytes*, static_shared_bytes*, blocks_per_sm*);
    # (which: 0 K12, 1 K34, 2 K2, 3 K1, 4 K4, 5 K3; + 8 for the medium
    # instantiation of K12, K34, K2, K4; c_lanes, regs*, local_bytes*);
    # (which: 0 K12-LT, 1 K34-LT v2, 2 K34-LT v1; camera samples; regs*,
    #  local_bytes*)
    "fused_round_attrs": [_I, _P, _P, _P, _P],
    "two_prog_attrs": [_I, _I, _P, _P],
    # (which: 0 K12, 1 K34, 2 K2, 3 K1, 5 K3; + 8 medium; c_lanes; p_rows;
    #  resident_rows; static_bytes*, dynamic_bytes*, blocks_per_sm*)
    "walk_shared_bytes": [_I, _I, _I, _I, _P, _P, _P],
    "lt_round_attrs": [_I, _I, _P, _P],
    # (which as lt_round_attrs's; camera samples; p_rows; resident_rows;
    #  static_bytes*, dynamic_bytes*, blocks_per_sm*)
    "lt_round_shared_bytes": [_I, _I, _I, _I, _P, _P, _P],
    # (state, tp, n, uvtab, uv_stride, mat2tex, meta, pairs, n_pairs, res,
    #  lam_lo, lam_span, res_m1, uu_hi, c_lanes, tf_rows, tf, stream)
    "tex_feed_launch": [_P, _P, _I, _P, _I, _P, _P, _P, _L, _I, _F, _F, _F,
                        _F, _I, _I, _P, _P],
    # (regs*, local_bytes*)
    "tex_feed_attrs": [_P, _P],
    "round_args_size": [],
    "lt_args_size": [],
    "pt_error_string": [_I],
}


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "pt_error_string" else _I
        _LIB = lib
    return _LIB


def error_string(rc: int) -> str:
    return library().pt_error_string(rc).decode()
