"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``refraction_tpu_torch/_build/`` under a
name that carries a hash of the sources and flags, so an edit rebuilds
and an unchanged tree reuses the file. A missing ``nvcc`` or a failed
compile raises with the compiler's output; nothing falls back.

``-fmad=false`` keeps multiply-adds unfused, so Möller–Trumbore and the
shading round like numpy float32 and closest-hit winners match the
reference's.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
_DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes. Every entry returns a cudaError_t.
SIGNATURES = {
    # tri, norm, supers, clusters, subs, origins, dirs, cull, n, tmin,
    # tmax, n_supers, n_clusters, cluster_size, sub_tris, t_out, idx_out,
    # n_out, stream
    "rt_closest_hit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F,
                       _I, _I, _I, _I, _P, _P, _P, _P],
    # env, env_h, env_w, dirs, weight, n, out, stream
    "rt_env": [_P, _I, _I, _P, _P, _I, _P, _P],
    # variant, env, env4, env_h, env_w, dirs, weight, n, out, stream
    "rt_env_variant": [_I, _P, _P, _I, _I, _P, _P, _I, _P, _P],
    # scalars, tri, norm, supers, clusters, subs, env, out, width, height,
    # spp, inv_spp, max_refract, max_reflect, n_supers, n_clusters,
    # cluster_size, sub_tris, env_h, env_w, stream
    "rt_frame": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                 _I, _I, _I, _I, _I, _I, _P],
    # tmin, tmax, ior, r0, tri, norm, supers, clusters, subs, env, state,
    # w, rad, next, variant, n_supers, n_clusters, cluster_size, sub_tris,
    # env_h, env_w, stream
    "rt_round": [_F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _P],
    # tmin, tmax, ior, r0, tri, norm, supers, clusters, subs, env, state,
    # slot, count, cap, width, n_pix, rad, slab, mask, pixel_rays, next,
    # next_slot, next_count, next_cap, variant, n_supers, n_clusters,
    # cluster_size, sub_tris, env_h, env_w, max_blocks, stream
    "rt_round_queue": [_F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _P],
    # slab, mask, n_pix, rad, stream
    "rt_fold_round": [_P, _P, _I, _P, _P],
    # tri, o, d, cull, r, v, t_out, i_out, stream
    "rt_mt_visits": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # wmat, rhs, cull, r, v, t_out, i_out, stream
    "rt_woop_visits": [_P, _P, _P, _I, _I, _P, _P, _P],
    # wmat, rhs, cull, r, v, passes, t_out, i_out, stream
    "rt_woop_visits_tc": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    # variant, n_iter, sm, x, out, stream
    "rt_stall": [_I, _I, _P, _P, _P, _P],
    # ept, variant, n_iter, sm, x, out, stream
    "rt_stall_form": [_I, _I, _I, _P, _P, _P, _P],
}


class BuildInfo:
    """What the last build did: the library path, the seconds it took
    (0.0 when a built library was reused) and nvcc's output."""

    path = ""
    seconds = 0.0
    log = ""


_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location. Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(_DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        f"{_DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built")


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = cu + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, deps


def build() -> str:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists;
    returns its path."""
    nvcc = find_nvcc()
    cu, deps = _sources()
    h = hashlib.sha256()
    for p in deps:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"librt_kernels_{h.hexdigest()[:16]}.so")
    BuildInfo.path = out
    if os.path.exists(out):
        BuildInfo.seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, c] for o, c in zip(objs, cu)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            logs.append(proc.communicate(timeout=600)[0])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}"
                    f"\n{logs[-1]}")
        link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False, timeout=600)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(link)}\n{logs[-1]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "".join(logs)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes`` declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
