"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``refraction_tpu_torch/_build/`` (or the
directory `build` is given) under a name that carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
file. A missing ``nvcc`` or a failed compile raises with the compiler's
output; nothing falls back. `launch` calls an entry point on the device
of the wrapper's tensors.

``-fmad=false`` keeps multiply-adds unfused, so Möller–Trumbore and the
shading round like numpy float32 and closest-hit winners match the
reference's.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

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
    # tri, norm, roots, supers, clusters, subs, origins, dirs, cull, n,
    # tmin, tmax, n_roots, n_supers, n_clusters, cluster_size, sub_tris,
    # t_out, idx_out, n_out, stream
    "rt_closest_hit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F,
                       _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # env, env_h, env_w, dirs, weight, n, out, stream
    "rt_env": [_P, _I, _I, _P, _P, _I, _P, _P],
    # variant, env, env4, env_h, env_w, dirs, weight, n, out, stream
    "rt_env_variant": [_I, _P, _P, _I, _I, _P, _P, _I, _P, _P],
    # tri, norm, supers, clusters, subs, inst_boxes, inst_roots,
    # inst_xform, inst_info, n_inst, n_inst_roots, sub_tris, origins, dirs,
    # cull, n, tmin, tmax, t_out, idx_out, n_out, stream
    "rt_instance_hit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                        _P, _P, _I, _F, _F, _P, _P, _P, _P],
    # scalars, tri, norm, supers, clusters, subs, env, out, width, height,
    # spp, inv_spp, max_refract, max_reflect, n_supers, n_clusters,
    # cluster_size, sub_tris, env_h, env_w, roots, n_roots, inst_boxes,
    # inst_roots, inst_xform, inst_info, n_inst, n_inst_roots, stream
    "rt_frame": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I,
                 _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P],
    # walk (0 flat, 1 supers, 2 roots, 3 instances), int[4] out (no stream)
    "rt_frame_occupancy": [_I, _P],
    # the rt_frame arguments up to env_w, then tile_stride, tile_base,
    # n_local, n_tiles_real, roots, n_roots, stream
    "rt_frame_tiles": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I,
                       _P],
    # tmin, tmax, ior, r0, tri, norm, roots, supers, clusters, subs, env,
    # state, w, rad, next, variant, n_roots, n_supers, n_clusters,
    # cluster_size, sub_tris, env_h, env_w, stream
    "rt_round": [_F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                 _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # tmin, tmax, ior, r0, tri, norm, roots, supers, clusters, subs, env,
    # state, slot, count, cap, width, n_pix, rad, slab, mask, pixel_rays,
    # next, next_slot, next_count, next_cap, variant, n_roots, n_supers,
    # n_clusters, cluster_size, sub_tris, env_h, env_w, max_blocks, stream
    "rt_round_queue": [_F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P],
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


class BuildInfo(NamedTuple):
    """What one build did: the library's path, the seconds nvcc and the
    link took (0.0 when the hashed library already existed: ``cached``)
    and nvcc's output."""

    path: str
    seconds: float
    log: str
    cached: bool


_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOADED: BuildInfo | None = None  # the build of _LIB


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


def build(build_dir: str = BUILD_DIR) -> BuildInfo:
    """Compile ``csrc/*.cu`` into the hashed library in ``build_dir``
    unless it is there already. Loads nothing: `library` loads the one
    in ``BUILD_DIR``."""
    nvcc = find_nvcc()
    cu, deps = _sources()
    h = hashlib.sha256()
    for p in deps:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(build_dir, f"librt_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return BuildInfo(out, 0.0, "", True)
    os.makedirs(build_dir, exist_ok=True)
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
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return BuildInfo(out, seconds, "".join(logs), False)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes`` declared."""
    global _LIB, _LOADED
    with _LOCK:
        if _LIB is None:
            info = build()
            lib = ctypes.CDLL(info.path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _LIB, _LOADED = lib, info
        return _LIB


def loaded_build() -> BuildInfo:
    """The build of the library `library` loaded (built and loaded here
    on first use)."""
    library()
    return _LOADED


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def on_device(device: torch.device):
    """A context that makes ``device`` the thread's current CUDA device:
    the runtime launches on the current device, so a stream of ``cuda:1``
    launched from a thread whose current device is ``cuda:0`` fails.
    Where ``device`` is current already it enters nothing, so a launch on
    one device pays no switch."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device``, on ``device`` (`on_device`). Raises if the entry point
    returns an error."""
    with on_device(device):
        err = getattr(library(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
