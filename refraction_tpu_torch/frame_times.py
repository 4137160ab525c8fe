"""Frame-kernel device time and the CLI loop's per-step breakdown, on CUDA.

    python -m refraction_tpu_torch.frame_times --scene X.obj --envmap X.hdr \\
        --width 1024 --height 768 --bounces 5 [--spp 4] [--label NAME]

prints one JSON line for the package it imports:

- ``kernel_ms``: mean ms per `fused_radiance` launch over 20 back-to-back
  launches (CUDA events), for each of 5 rounds after a warm-up, and their
  median;
- ``wavefront_ms``: the same for `integrator.render_pixels_mega` (the
  per-round wavefront, no stats) on the frame's primary rays: mean ms per
  call over 20 back-to-back calls, for each of 5 rounds, and their median.
  Where the host takes longer to enqueue a frame than the card to run it,
  this is the host's time;
- ``wavefront_device_ms``: the card's time per `render_pixels_mega` call
  (`timing.device_ms`: each call queued behind a spin kernel, so the card
  never waits for the host), mean over 20 calls, for each of 5 rounds, and
  their median;
- ``loop``: medians over 30 frames of the CLI loop (after 3 warm-up
  frames) of each step — ``orbit_camera`` and ``build_scalars`` on the host
  clock; the frame kernel, and ``to_u8`` with its copy to the host, on CUDA
  events; the loop frame (host clock, camera to the copy) — the loop
  frame's p10 and p90, and the device idle share, 1 - (kernel + copy) /
  loop frame. The PNG write is timed apart (median of 5 writes of the last
  frame), since the CLI's per-frame write would leave the card idle for
  tens of ms between frames;
- ``cli``: the CLI's own loop as the imported package runs it
  (``run.main`` over 34 frames of the orbit, one PNG per frame): the
  median, p10 and p90 of the 30 host-clock gaps between consecutive
  per-frame log lines after the first 3: the loop's frame period,
  ``with_png`` as the CLI runs and ``without_png`` with ``run.write_png``
  replaced by a no-op;
- the card line (nvidia-smi name and power limit).

The frame kernel alone on one cell, in place of that breakdown:

    python -m refraction_tpu_torch.frame_times --cell large [--tiles]

- ``--cell NAME`` takes one of the procedural cells of `CELLS` (the
  stand-ins chip_smoke.py and bench.py render: demo, demo_spp4, large,
  headline, ott, config5, spp4) instead of ``--scene`` and the shape
  flags, and times `fused_radiance` (``rt_frame``): ROUNDS rounds, each
  the card's mean ms over LAUNCHES launches behind a spin kernel
  (`timing.card_ms`); the times, their median, its share of the frame's
  bound (`bounds.frame_bound` over `render.frame_traversal_work`), the
  image's sha256 and the kernel's occupancy
  (`framekernel.frame_occupancy`);
- ``--tiles`` launches the pixel-DP entry (`frame_tiles`) once for each
  32x32 tile of the frame alone (``n_local`` 1; the card's time,
  `timing.device_ms`; the 8 slowest take the best of 5) and prints the
  slowest tile, its id and the median tile.

It uses only the package's long-standing entry points (``scene.load_scene``,
``scene.build_scene``, ``scene.scene_from_jax``,
``kernels.framekernel.build_scalars`` / ``fused_radiance`` /
``frame_tiles``, ``camera.generate_rays``,
``integrator.render_pixels_mega``, ``render.frame_traversal_work``,
``bounds.frame_bound``, ``run.to_u8`` / ``write_png`` / ``main`` and its
per-frame log line; with ``--cell``, ``kernels.framekernel.walk_of`` and
``frame_occupancy(walk, device)``) and the measurement helpers of ``timing.py``, so the
same two files, copied beside another checkout of the package, time that
checkout's kernels: comparisons run both in one call, in turns.
``--device cuda`` only: there is no CPU path.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from refraction_tpu_torch import RenderConfig, bounds, run
from refraction_tpu_torch.camera import generate_rays, orbit_camera
from refraction_tpu_torch.integrator import render_pixels_mega
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap, make_icosphere)
from refraction_tpu_torch.kernels import framekernel
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars, frame_tiles, fused_radiance, tile_grid)
from refraction_tpu_torch.render import frame_traversal_work, sample_offsets
from refraction_tpu_torch.run import build_config, to_u8, write_png
from refraction_tpu_torch.scene import (
    auto_cluster_size, build_scene, load_scene, scene_from_jax)
from refraction_tpu_torch.timing import (
    card_line, card_ms, device_ms, require_device)

ROUNDS, LAUNCHES = 5, 20
WARM_FRAMES, FRAMES = 3, 30
SHAPE_FLAGS = ("--scene", "--envmap", "--width", "--height", "--bounces",
               "--spp")
# --cell: make_icosphere(subdiv, 1.2) at auto_cluster_size, a 1024x2048
# gradient map; (subdiv, width, height, refraction cap, spp), the
# reflection cap RenderConfig's 2. demo, demo_spp4 and large are
# chip_smoke.py's phase 5 cells (there loaded from OBJ files); headline,
# ott, config5 and spp4 the bench's stand-ins.
CELLS = {"demo": (3, 1024, 768, 5, 1), "demo_spp4": (3, 1024, 768, 5, 4),
         "large": (6, 1920, 1080, 4, 1), "headline": (3, 1920, 1080, 4, 1),
         "ott": (5, 1920, 1080, 5, 1), "config5": (5, 1920, 1080, 5, 4),
         "spp4": (3, 1920, 1080, 4, 4)}
SLOW_TILES, SLOW_REPEATS = 8, 5


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def back_to_back_ms(fn) -> list[float]:
    """Mean ms per call of ``fn`` in each of ROUNDS rounds of LAUNCHES
    back-to-back calls (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(ROUNDS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(LAUNCHES):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / LAUNCHES)
    return out


def loop_breakdown(scene, cfg, device, png_dir: str) -> dict:
    """Per-step medians of the CLI's frame loop (run.main without logging)."""
    offsets = sample_offsets(cfg.spp)
    rows = []
    angle = 0.01
    for i in range(WARM_FRAMES + FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        frame = orbit_camera(angle, cfg)
        t1 = time.perf_counter()
        scalars = build_scalars(frame, cfg, offsets, device)
        t2 = time.perf_counter()
        ev[0].record()
        img = fused_radiance(scene, scalars, cfg)
        ev[1].record()
        u8 = to_u8(img).cpu().numpy()
        ev[2].record()
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        if i >= WARM_FRAMES:
            k, c = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
            loop = (t3 - t0) * 1e3
            rows.append({"orbit_camera": (t1 - t0) * 1e3,
                         "scalar_upload": (t2 - t1) * 1e3,
                         "frame_kernel": k, "u8_copy": c, "loop_frame": loop,
                         "idle": 1.0 - (k + c) / loop})
        angle += cfg.orbit_speed
    out = {key: statistics.median(r[key] for r in rows) for key in rows[0]}
    loops = [r["loop_frame"] for r in rows]
    out.update(loop_p10=_pct(loops, 10), loop_p90=_pct(loops, 90))
    writes = []
    for _ in range(5):
        t0 = time.perf_counter()
        write_png(os.path.join(png_dir, "frame.png"), u8)
        writes.append((time.perf_counter() - t0) * 1e3)
    out["png_write"] = statistics.median(writes)
    return out


def cli_loop(args, png_dir: str, write: bool) -> dict:
    """Frame period of ``run.main`` at the shape of ``args`` over
    WARM_FRAMES + FRAMES frames (one PNG each; with ``write`` False,
    ``run.write_png`` is a no-op): median, p10 and p90 of the gaps between
    consecutive per-frame log lines after the first WARM_FRAMES, in ms."""
    stamps = []

    class Stamp(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith('{"frame"'):
                stamps.append(record.created)

    argv = ["--frames", str(WARM_FRAMES + FRAMES + 1), "--out",
            os.path.join(png_dir, "frame.png"), "--device", "cuda"]
    for flag in SHAPE_FLAGS:
        value = getattr(args, flag[2:])
        if value is not None:
            argv += [flag, str(value)]
    handler, real_write = Stamp(), run.write_png
    logger = logging.getLogger("refraction_tpu")
    logger.addHandler(handler)
    if not write:
        run.write_png = lambda path, img: None
    try:
        if run.main(argv) != 0:
            raise RuntimeError(f"run.main({argv}) failed")
    finally:
        run.write_png = real_write
        logger.removeHandler(handler)
    gaps = (np.diff(np.asarray(stamps)) * 1e3)[WARM_FRAMES:]
    return {"median": float(np.median(gaps)), "p10": _pct(gaps, 10),
            "p90": _pct(gaps, 90), "frames": len(stamps)}


def cell_scene(name: str, device) -> tuple:
    """The scene and config of the procedural cell ``name`` (`CELLS`)."""
    subdiv, width, height, bounces, spp = CELLS[name]
    mesh = make_icosphere(subdiv, 1.2)
    host = build_scene(mesh, make_gradient_envmap(1024, 2048),
                       auto_cluster_size(mesh.num_tris))[0]
    cfg = RenderConfig(width=width, height=height,
                       max_refract_depth=bounces, spp=spp)
    return scene_from_jax(host, device), cfg


def time_kernel(scene, cfg, scalars, device) -> dict:
    """The frame kernel's card ms in ROUNDS rounds, their median, its share
    of the frame's bound, the image's sha256 and the kernel's occupancy
    (see the module docstring)."""
    img = fused_radiance(scene, scalars, cfg)
    torch.cuda.synchronize(device)
    ms = [card_ms(lambda: fused_radiance(scene, scalars, cfg), LAUNCHES,
                  device) for _ in range(ROUNDS)]
    b = bounds.frame_bound(scene, cfg, frame_traversal_work(
        scene, cfg, orbit_camera(0.01, cfg), device))
    walk = framekernel.walk_of(scene)
    median = statistics.median(ms)
    out = {"ms": ms, "median_ms": median,
           "share_of_bound": b["bound_ms"] / median,
           "sha256": hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest(),
           "occupancy": framekernel.frame_occupancy(walk, device)}
    return {"kernel": out, "walk": walk,
            "bound": {k: b[k] for k in ("bound_ms", "bound_by", "ops",
                                        "bytes", "work")}}


def tile_times(scene, cfg, scalars, device) -> dict:
    """One-tile launches of the pixel-DP entry `frame_tiles` over the
    frame's tiles: the slowest (its id) and the median, the card's ms."""
    n_tiles = tile_grid(cfg)[1]

    def one_tile(t):
        return device_ms(lambda: frame_tiles(scene, scalars, cfg, n_tiles, t,
                                             1, n_tiles), device)

    one_tile(0)
    one = {t: one_tile(t) for t in range(n_tiles)}
    for t in sorted(one, key=one.get)[-SLOW_TILES:]:
        one[t] = min(one[t], *(one_tile(t) for _ in range(SLOW_REPEATS - 1)))
    slow = max(one, key=one.get)
    return {"tiles": n_tiles, "slowest_ms": one[slow], "slowest_tile": slow,
            "median_ms": float(np.median(list(one.values())))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for flag in ("--scene", "--envmap"):
        p.add_argument(flag)
    for flag in ("--width", "--height", "--bounces", "--spp"):
        p.add_argument(flag, type=int)
    p.add_argument("--cell", choices=sorted(CELLS),
                   help="time the frame kernel alone on a procedural cell")
    p.add_argument("--tiles", action="store_true",
                   help="one-tile launches: the slowest and median tile")
    p.add_argument("--label", default="", help="name printed with the result")
    args = p.parse_args(argv)
    device = require_device("cuda")
    if args.cell:
        scene, cfg = cell_scene(args.cell, device)
    else:
        cfg = build_config(args)
        scene = scene_from_jax(load_scene(cfg)[0], device)
    scalars = build_scalars(orbit_camera(0.01, cfg), cfg,
                            sample_offsets(cfg.spp), device)
    if args.cell or args.tiles:
        res = {"label": args.label, "cell": args.cell,
               "shape": [cfg.width, cfg.height, cfg.max_refract_depth,
                         cfg.max_reflect_depth, cfg.spp],
               "tris": scene.num_tris, "clusters": scene.num_clusters}
        if args.cell:
            res.update(time_kernel(scene, cfg, scalars, device))
        if args.tiles:
            res["one_tile"] = tile_times(scene, cfg, scalars, device)
        res["card"] = card_line(device)
        print(json.dumps(res), flush=True)
        return 0
    ms = back_to_back_ms(lambda: fused_radiance(scene, scalars, cfg))
    o, d = generate_rays(orbit_camera(0.01, cfg), cfg.width, cfg.height,
                         device)
    wave = back_to_back_ms(lambda: render_pixels_mega(scene, o, d, cfg))
    wave_dev = [statistics.mean(
        device_ms(lambda: render_pixels_mega(scene, o, d, cfg), device)
        for _ in range(LAUNCHES)) for _ in range(ROUNDS)]
    with tempfile.TemporaryDirectory() as tmp:
        loop = loop_breakdown(scene, cfg, device, tmp)
        cli = {"with_png": cli_loop(args, tmp, True),
               "without_png": cli_loop(args, tmp, False)}
    print(json.dumps({"label": args.label,
                      "shape": [cfg.width, cfg.height, cfg.max_refract_depth,
                                cfg.spp],
                      "kernel_ms": ms, "kernel_ms_median": statistics.median(ms),
                      "wavefront_ms": wave,
                      "wavefront_ms_median": statistics.median(wave),
                      "wavefront_device_ms": wave_dev,
                      "wavefront_device_ms_median": statistics.median(
                          wave_dev),
                      "loop": loop, "cli": cli,
                      "card": card_line(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
