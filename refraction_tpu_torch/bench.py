"""Headline benchmark of the port: the frame kernel at the reference's cells.

    python -m refraction_tpu_torch.bench                  # one CUDA card, nvcc
    RRT_BENCH_SMALL=1 python -m refraction_tpu_torch.bench --device cpu

The PyTorch/CUDA port of the repository's root ``bench.py``, which times
only the JAX package and stays as it is: the same cells, regimes and
printing contract, and a correctness gate in every run. Settings, read as
the root ``bench.py`` reads them:

- ``RRT_BENCH_SMALL``: the headline at 256x128 with only its own extras
  (``device_ms``, ``live_rays``, ``batched``); every other cell gets a
  ``<cell>_note``.
- ``RRT_BENCH_BUDGET_S`` (default 1800): wall seconds. An extra that the
  budget left cannot cover (each has a floor) is skipped with a
  ``<cell>_note``.
- ``RRT_ASSET_DIR`` (default `config.DEFAULT_ASSET_DIR`): where
  ``monkey.obj``, ``shell.obj``, ``ott.obj`` and ``envmap.png`` are looked
  up. A missing mesh or map is replaced by a procedural stand-in, and the
  cell's ``<cell>_scene`` says which; nothing is downloaded.
- ``--device`` (default ``cuda``): ``cuda`` needs a card and ``nvcc`` and
  raises without them; ``cpu`` renders every frame through the frame
  kernel's plain version (the eager integrator) on the host clock.

Cells (mesh, else its stand-in; shape; refraction/reflection caps; spp):

- headline: ``monkey.obj``, else ``make_icosphere(3, 1.2)`` (1,280 tris);
  1920x1080; 4/2; 1;
- ref_demo: ``shell.obj``, else the same stand-in; 1024x768; 5/2; 1;
- ott: ``ott.obj``, else ``make_icosphere(5, 1.2)`` (20,480 tris);
  1920x1080; 5/2; 1;
- config5: the ott cell at spp 4; spp4: the headline at spp 4;
- build80k: ``make_icosphere(6, 1.2)`` (81,920 tris, clusters of 256, a
  64x128 map); 1920x1080; 4/2; 1.

A missing ``envmap.png`` becomes ``make_gradient_envmap(1024, 2048)``.
Scenes are built as `scene.load_scene` builds them (`auto_cluster_size`)
and uploaded with `scene.scene_from_jax`.

The gate: before a cell is timed, its first frame (`fused_radiance` at
angle 0.01) is held against the plain version over the same camera rays,
the eager integrator over the brute force, on every ``GATE_STRIDE``-th
pixel: RMSE < 1e-4 and at most 1e-4 of the pixels with a channel off by
more than 1e-3 (``gate`` in the JSON, per cell). The plain version never
runs inside a timed window. A cell whose gate fails prints no speed key.

The headline's regimes (the camera orbits at the root bench's angles):

- ``build_s``: nvcc of this process's kernel library (0.0 with
  ``build_cached`` where the hashed library already existed);
  ``first_frame_s``: its load, the first launch and the sync;
- ``frame_latency_ms``: the best of 6 frames, each synced on its checksum;
- ``loop_frame_ms``: 10 frames two deep: each frame's checksum is copied
  into a pinned host slot right behind it and an event recorded; the host
  waits for the previous frame's event only once the next frame is
  enqueued;
- ``device_ms``: the card's time of one `fused_radiance` launch
  (`timing.device_ms`), the least of 4 angles (ott and config5: the
  median);
- ``batched_frame_ms``: 4 bursts of 32 launches back to back, each
  burst's scalars uploaded at once from pinned memory, one checksum a
  burst, read while the next burst runs;
- ``value`` (FPS) and ``frame_ms``: the fastest of the latency, loop and
  batched regimes; ``mrays_dense`` (`render.rays_per_frame`) and
  ``mrays_live`` (``live_rays_per_frame``, `render.count_live_rays` at
  angle 0.01: the real pixels and every sample) per ``frame_ms``;
- ``launches``: per timed regime, the frames it timed and the
  `fused_radiance` launches counted from 0 just before it to just after.

The whole cumulative JSON object is printed as one line after the
headline and again after each extra, so the last line of stdout is always
a whole result. An extra that raises gets a ``<cell>_error``. The exit
code is 0 when every gate passed and no extra raised, else 1, after the
last line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from refraction_tpu_torch import config
from refraction_tpu_torch.camera import orbit_camera, pixel_rays
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.integrator import render_pixels
from refraction_tpu_torch.io.objmesh import parse_obj
from refraction_tpu_torch.io.primitives import make_gradient_envmap, make_icosphere
from refraction_tpu_torch.io.texture import load_texture
from refraction_tpu_torch.kernels import _build
from refraction_tpu_torch.kernels.envmap import env_contribution_plain
from refraction_tpu_torch.kernels.framekernel import build_scalars, fused_radiance
from refraction_tpu_torch.ops.backends import torch_intersect
from refraction_tpu_torch.render import (
    count_live_rays,
    make_renderer,
    rays_per_frame,
    sample_offsets,
)
from refraction_tpu_torch.scene import auto_cluster_size, build_scene, scene_from_jax
from refraction_tpu_torch.timing import card_line, device_ms, require_device

FULL_SIZE = (1920, 1080)
SMALL_SIZE = (256, 128)  # RRT_BENCH_SMALL
LATENCY_FRAMES, LOOP_FRAMES = 6, 10
BURSTS, BATCH = 4, 32
# The gate's bars (chip_smoke.py's): RMSE, and the share of pixels with a
# channel off by more than PIX_TOL. The stride keeps all six gates to
# about 30 s on an H100 (the brute force takes ~0.4 ns per lane and
# triangle there); 101 is prime, so the sampled pixels fall in every
# column over the rows.
IMG_RMSE, PIX_TOL, PIX_SHARE = 1e-4, 1e-3, 1e-4
GATE_STRIDE = 101
STAND_IN_ENV = (1024, 2048)
STAND_INS = {"monkey.obj": (3, 1.2), "shell.obj": (3, 1.2),
             "ott.obj": (5, 1.2)}  # make_icosphere arguments
# Each extra's budget floor, seconds (the root bench.py's).
FLOORS = {"device_ms": 30, "live_rays": 60, "batched": 120, "ref_demo": 180,
          "ott": 240, "config5": 240, "spp4": 120, "build80k": 120}
MRAYS_NOTE = ("live = rays alive entering a bounce round, over the real "
              "pixels and every sample (render.count_live_rays); dense = "
              "wavefront slot-rounds (render.rays_per_frame: 15 a pixel and "
              "sample at 4/2 bounces)")


class GateFailed(RuntimeError):
    """A cell's first frame disagrees with its plain version."""


def asset_dir() -> str:
    return os.environ.get("RRT_ASSET_DIR", config.DEFAULT_ASSET_DIR)


def load_cell(mesh_name: str, device: torch.device):
    """(scene on ``device``, label): ``mesh_name`` and ``envmap.png`` from
    the asset dir, each replaced by its stand-in where the file is
    missing, built at `auto_cluster_size`. The label names the files or
    stand-ins, the triangle count and the cluster size."""
    path = os.path.join(asset_dir(), mesh_name)
    if os.path.isfile(path):
        mesh, mesh_label = parse_obj(path), path
    else:
        subdiv, radius = STAND_INS[mesh_name]
        mesh = make_icosphere(subdiv, radius)
        mesh_label = f"stand-in make_icosphere({subdiv}, {radius})"
    env_path = os.path.join(asset_dir(), "envmap.png")
    if os.path.isfile(env_path):
        env, env_label = load_texture(env_path), env_path
    else:
        env = make_gradient_envmap(*STAND_IN_ENV)
        env_label = "stand-in make_gradient_envmap({}, {})".format(
            *STAND_IN_ENV)
    host, meta = build_scene(mesh, env, auto_cluster_size(mesh.num_tris))
    label = {"mesh": mesh_label, "stand_in": mesh_label != path,
             "tris": meta.num_real_tris, "envmap": env_label,
             "cluster_size": meta.cluster_size}
    return scene_from_jax(host, device), label


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_frame(scene, cfg: RenderConfig, device: torch.device):
    """The cell's first frame: one `fused_radiance` at angle 0.01."""
    return fused_radiance(scene, build_scalars(
        orbit_camera(0.01, cfg), cfg, sample_offsets(cfg.spp), device), cfg)


def gate(img: torch.Tensor, scene, cfg: RenderConfig, stride: int) -> dict:
    """``img`` (`first_frame`) against the plain version on every
    ``stride``-th pixel: per sample, the pixels' rays (`camera.pixel_rays`)
    through the eager integrator over the brute force, averaged as the
    frame kernel averages. ``ok`` also needs the whole frame finite."""
    device = img.device
    idx = torch.arange(0, cfg.width * cfg.height, stride, device=device)
    gx = (idx % cfg.width).to(torch.float32)
    gy = (idx // cfg.width).to(torch.float32)
    frame = orbit_camera(0.01, cfg)
    acc = None
    for off in sample_offsets(cfg.spp):
        o, d = pixel_rays(frame, gx, gy, cfg.width, cfg.height, jitter=off)
        rad = render_pixels(scene, o, d, cfg, torch_intersect,
                            env_contribution_plain)
        acc = rad if acc is None else acc + rad
    plain = acc * float(np.float32(1.0 / cfg.spp))
    diff = (img.reshape(-1, 3)[idx] - plain).abs().double()
    rmse = float(torch.sqrt(torch.mean(diff ** 2)))
    share = float((diff.amax(dim=1) > PIX_TOL).double().mean())
    ok = (bool(torch.isfinite(img).all()) and rmse < IMG_RMSE
          and share <= PIX_SHARE)
    return {"rmse": rmse, "share_off": share, "pixels": int(idx.numel()),
            "stride": stride, "ok": ok}


def check_gate(result: dict, cell: str, img, scene, cfg) -> None:
    """Gate ``img`` into ``result["gate"][cell]``; raises GateFailed."""
    g = result["gate"][cell] = gate(img, scene, cfg, GATE_STRIDE)
    if not g["ok"]:
        raise GateFailed(f"{cell}: the first frame disagrees with the plain "
                         f"version: {g}")


def counted(result: dict, regime: str, frames: int, fn):
    """``fn()``, with the frame kernel's launch count set to 0 just before
    and read into ``result["launches"][regime]`` just after."""
    fused_radiance.launches = 0
    out = fn()
    result["launches"][regime] = {"frames": frames,
                                  "fused_radiance": fused_radiance.launches}
    return out


def pipelined(items, device: torch.device) -> float:
    """Seconds per item, two deep: ``items`` are callables that enqueue
    work and return its on-device checksum. Each checksum is copied into a
    pinned host slot right behind its work and an event recorded; the host
    waits for item k-1's event, and reads its checksum, once item k is
    enqueued. Raises on a non-finite checksum."""
    cuda = device.type == "cuda"
    host = torch.zeros(len(items), pin_memory=cuda)
    events, sums = [], []
    t0 = time.perf_counter()
    for k, item in enumerate(items):
        host[k].copy_(item(), non_blocking=cuda)
        if cuda:
            events.append(torch.cuda.Event())
            events[-1].record()
        if k:
            if cuda:
                events[k - 1].synchronize()
            sums.append(float(host[k - 1]))
    if cuda:
        events[-1].synchronize()
    sums.append(float(host[-1]))
    dt = (time.perf_counter() - t0) / len(items)
    if not all(np.isfinite(sums)):
        raise RuntimeError(f"non-finite frame checksums: {sums}")
    return dt


def latency_s(render, scene, cfg: RenderConfig) -> float:
    """The best of LATENCY_FRAMES frames, each synced on its checksum."""
    times = []
    for k in range(LATENCY_FRAMES):
        t0 = time.perf_counter()
        img = render(scene, orbit_camera(0.02 + 0.013 * k, cfg))
        float(img[0, 0].sum())
        times.append(time.perf_counter() - t0)
    return min(times)


def loop_s(render, scene, cfg: RenderConfig, device, frames: int) -> float:
    """Seconds per frame of ``frames`` orbit frames two deep (`pipelined`)."""
    return pipelined([
        lambda k=k: render(scene, orbit_camera(0.1 + 0.013 * k, cfg))[0, 0]
        .sum() for k in range(frames)], device)


def batched_s(scene, cfg: RenderConfig, device: torch.device) -> float:
    """Seconds per frame over BURSTS bursts of BATCH `fused_radiance`
    launches: a burst's scalar vectors go up in one copy (from pinned
    memory on CUDA, so it waits for no earlier burst), its frames' first
    pixels into one buffer, their sum is the burst's checksum
    (`pipelined`)."""
    offsets = sample_offsets(cfg.spp)
    cuda = device.type == "cuda"

    def burst(k):
        a0 = 0.5 + 0.1 * k
        scal = torch.stack([build_scalars(orbit_camera(a0 + 0.013 * b, cfg),
                                          cfg, offsets, "cpu")
                            for b in range(BATCH)])
        if cuda:
            scal = scal.pin_memory().to(device, non_blocking=True)
        firsts = torch.empty(BATCH, 3, device=device)
        for b in range(BATCH):
            firsts[b] = fused_radiance(scene, scal[b], cfg)[0, 0]
        return firsts.sum()

    return pipelined([lambda k=k: burst(k) for k in range(BURSTS)],
                     device) / BATCH


def kernel_ms(scene, cfg: RenderConfig, device: torch.device, n: int = 4,
              agg=min) -> float:
    """``agg`` over n angles (0.3 + 0.017 k) of the card's time of one
    `fused_radiance` launch (`timing.device_ms`; the host clock on the
    CPU); the scalars are uploaded before."""
    offsets = sample_offsets(cfg.spp)
    scals = [build_scalars(orbit_camera(0.3 + 0.017 * k, cfg), cfg, offsets,
                           device) for k in range(n)]
    return agg([device_ms(lambda s=s: fused_radiance(scene, s, cfg), device)
                for s in scals])


def headline_config(small: bool) -> RenderConfig:
    """The headline cell: FULL_SIZE (SMALL_SIZE with RRT_BENCH_SMALL), 4/2
    bounces, spp 1."""
    width, height = SMALL_SIZE if small else FULL_SIZE
    return RenderConfig(width=width, height=height, max_refract_depth=4)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    cuda = device.type == "cuda"
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("RRT_BENCH_BUDGET_S", "1800"))
    small = bool(os.environ.get("RRT_BENCH_SMALL"))
    cfg = headline_config(small)

    t0 = time.perf_counter()
    scene, label = load_cell("monkey.obj", device)
    scene_s = time.perf_counter() - t0
    name = label["mesh"] if label["stand_in"] else "monkey.obj"
    dense = rays_per_frame(cfg)
    result = {
        "metric": (f"FPS, {name} {cfg.width}x{cfg.height} 4-bounce "
                   "refraction, "
                   + ("RRT_BENCH_SMALL smoke" if small else "1 GPU")),
        "unit": "FPS", "tris": label["tris"], "headline_scene": label,
        "backend": "cuda", "device": (torch.cuda.get_device_name(device)
                                      if cuda else "cpu"),
        "card": card_line(device), "dense_rays_per_frame": dense,
        "mrays_note": MRAYS_NOTE, "scene_s": scene_s, "gate": {},
        "launches": {}}
    failed = []

    def emit():
        print(json.dumps(result), flush=True)

    render = make_renderer(cfg, "cuda", device)
    t0 = time.perf_counter()
    img = first_frame(scene, cfg, device)
    sync(device)
    first_s = time.perf_counter() - t0
    if cuda:
        built = _build.loaded_build()
        result.update(build_s=built.seconds, build_cached=built.cached,
                      library=built.path,
                      first_frame_s=first_s - built.seconds)
    else:
        result.update(build_s=None, build_cached=None, library=None,
                      first_frame_s=first_s)
    try:
        check_gate(result, "headline", img, scene, cfg)
    except GateFailed as e:
        print(f"bench: {e}", file=sys.stderr)
        emit()
        return 1

    lat = counted(result, "latency", LATENCY_FRAMES,
                  lambda: latency_s(render, scene, cfg))
    loop = counted(result, "loop", LOOP_FRAMES,
                   lambda: loop_s(render, scene, cfg, device, LOOP_FRAMES))
    result.update(frame_latency_ms=lat * 1e3, loop_frame_ms=loop * 1e3)
    live = None
    dt = None

    def set_frame_s(new_dt):
        """The headline's frame time: the fastest regime so far."""
        nonlocal dt
        dt = new_dt if dt is None else min(dt, new_dt)
        result.update(value=1.0 / dt, frame_ms=dt * 1e3,
                      mrays_dense=dense / dt / 1e6)
        if live is not None:
            result["mrays_live"] = live / dt / 1e6

    set_frame_s(min(lat, loop))
    emit()  # the headline is safe whatever happens below

    def extra(cell, fn):
        """Run one extra unless the budget left is below its floor; an
        exception becomes ``<cell>_error`` and a non-zero exit. Prints the
        cumulative line either way."""
        left = budget_s - (time.perf_counter() - t_start)
        if left < FLOORS[cell]:
            result[f"{cell}_note"] = (
                f"skipped (RRT_BENCH_BUDGET_S: {left:.0f} s left < "
                f"{FLOORS[cell]} s floor)")
        else:
            try:
                fn()
            except Exception as e:  # reported in the line and the exit code
                traceback.print_exc()
                result[f"{cell}_error"] = repr(e)
                failed.append(cell)
        emit()

    def x_device_ms():
        result["device_ms"] = counted(result, "device_ms", 4,
                                      lambda: kernel_ms(scene, cfg, device))

    def x_live_rays():
        nonlocal live
        live = count_live_rays(scene, cfg, orbit_camera(0.01, cfg), device)
        result["live_rays_per_frame"] = live
        set_frame_s(dt)

    def x_batched():
        b = counted(result, "batched", BURSTS * BATCH,
                    lambda: batched_s(scene, cfg, device))
        result["batched_frame_ms"] = b * 1e3
        set_frame_s(b)

    extra("device_ms", x_device_ms)
    extra("live_rays", x_live_rays)
    extra("batched", x_batched)

    if small:
        for cell in ("ref_demo", "ott", "config5", "spp4", "build80k"):
            result[f"{cell}_note"] = "skipped (RRT_BENCH_SMALL)"
        emit()
        return 1 if failed else 0

    def x_ref_demo():
        sc, lab = load_cell("shell.obj", device)
        result["ref_demo_scene"] = lab
        c = RenderConfig(width=1024, height=768)  # the reference's 5/2
        check_gate(result, "ref_demo", first_frame(sc, c, device), sc, c)
        ms = counted(result, "ref_demo_device_ms", 4,
                     lambda: kernel_ms(sc, c, device))
        result.update(ref_demo_device_ms=ms, ref_demo_fps_device=1e3 / ms,
                      ref_demo_note="shell.obj (or its stand-in) 1024x768 "
                      "5/2 bounces, the reference's demo configuration")

    ott = []  # (scene, cfg), for config5

    def x_ott():
        sc, lab = load_cell("ott.obj", device)
        result["ott_scene"] = lab
        c = RenderConfig(width=1920, height=1080, max_refract_depth=5)
        check_gate(result, "ott", first_frame(sc, c, device), sc, c)
        ott.append((sc, c))
        ms = counted(result, "ott_device_ms", 6, lambda: kernel_ms(
            sc, c, device, n=6, agg=statistics.median))
        result.update(ott_device_ms=ms, ott_fps_device=1e3 / ms,
                      ott_note="ott.obj (or its stand-in) 1920x1080 5/2 "
                      "bounces, the reference's largest asset")

    def x_config5():
        if not ott:
            raise RuntimeError("the ott scene is unavailable (ott failed)")
        sc, c = ott[0]
        c = c.replace(spp=4)
        result["config5_scene"] = result["ott_scene"]
        check_gate(result, "config5", first_frame(sc, c, device), sc, c)
        ms = counted(result, "config5_device_ms", 4, lambda: kernel_ms(
            sc, c, device, agg=statistics.median))
        result.update(config5_device_ms=ms, config5_fps_device=1e3 / ms,
                      config5_note="BASELINE config 5: ott.obj (or its "
                      "stand-in) 1920x1080 5/2 bounces spp 4")

    def x_spp4():
        c = cfg.replace(spp=4)
        result["spp4_scene"] = label
        check_gate(result, "spp4", first_frame(scene, c, device), scene, c)
        r4 = make_renderer(c, "cuda", device)
        n4 = 6
        dt4 = counted(result, "spp4_loop", n4,
                      lambda: loop_s(r4, scene, c, device, n4))
        live4 = count_live_rays(scene, c, orbit_camera(0.01, c), device)
        result.update(spp4_frame_ms=dt4 * 1e3, spp4_live_rays_per_frame=live4,
                      spp4_mrays_live=live4 / dt4 / 1e6)
        if live is not None:  # live rays a second, both two deep
            result["spp4_rays_vs_spp1"] = (live4 / dt4) / (live / loop)

    def x_build80k():
        if not cuda:
            raise RuntimeError("build80k builds the CUDA kernels: --device "
                               "cuda only")
        host, meta = build_scene(make_icosphere(6, 1.2),
                                 make_gradient_envmap(64, 128), 256)
        result["build80k_scene"] = {
            "mesh": "make_icosphere(6, 1.2)", "stand_in": False,
            "tris": meta.num_real_tris, "envmap": "make_gradient_envmap(64, "
            "128)", "cluster_size": meta.cluster_size}
        sc = scene_from_jax(host, device)
        c = RenderConfig(width=1920, height=1080, max_refract_depth=4)
        build_dir = tempfile.mkdtemp(prefix="rt_build_cold_")
        try:
            cold = _build.build(build_dir)
        finally:
            shutil.rmtree(build_dir, ignore_errors=True)

        def first():
            t0 = time.perf_counter()
            img = first_frame(sc, c, device)
            sync(device)
            return img, time.perf_counter() - t0

        img, first80k = counted(result, "build80k_first_frame", 1, first)
        check_gate(result, "build80k", img, sc, c)
        result.update(build_cold_s=cold.seconds, build80k_library=cold.path,
                      build80k_cached=cold.cached, first_frame80k_s=first80k,
                      compile80k_tris=meta.num_real_tris)

    for cell, fn in (("ref_demo", x_ref_demo), ("ott", x_ott),
                     ("config5", x_config5), ("spp4", x_spp4),
                     ("build80k", x_build80k)):
        extra(cell, fn)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
