#!/usr/bin/env python3
"""GPU smoke test of refraction_tpu_torch: builds the CUDA kernels, holds
each against its plain PyTorch version on the card, then drives the main
paths on procedural scenes at the reference demo's scale and at the
large-scene scale: the frame path (``python -m refraction_tpu_torch.run``)
and the per-round wavefront (``integrator.render_pixels_mega``,
``render.count_live_rays``, ``python -m refraction_tpu_torch.profile_rounds``).

    python3 chip_smoke.py        # needs one CUDA GPU and nvcc

Phases (any failure raises; nothing is caught):
  0. card name and power limit (nvidia-smi), torch and CUDA versions;
  1. build csrc/*.cu with nvcc;
  2. closest-hit kernel vs the brute force, 2^16 seeded rays, both culls:
     winners equal on every ray, on icospheres of each walk (flat, supers,
     and roots: 20,480 triangles at clusters of 8, 3 roots) and on scenes
     with equal-t triangle pairs (a cluster of copies of triangles from all
     over the mesh, appended at the end of the table, whose box is entered
     first: the lower index must still win), the roots walk among them;
  3. env kernel vs the gather on a 1024x2048 map: 2^16 directions (80% of
     the weights > 0), then the demo frame's round widths, 786,432 and
     3,145,728 directions with 10% of the weights > 0, and an odd count
     (times: the card's, the launches queued behind a spin kernel);
  4. frame kernel vs the eager integrator at 256x192 (five cases), on
     the 81,920-triangle scene at 160x90, and on two nested glass shells
     that take the roots walk: 25,600 triangles at clusters of 8 (100
     supers under 4 roots) and the benchmark's 1,638,400-triangle shell
     at its own cluster size and caps (64x36), each with the traversal
     walk it took (flat: at most 32 clusters; supers; roots);
  5. the CLI with ``--backend cuda`` on the demo configuration (1024x768,
     5/2 bounces, 8 orbit frames, 1,280 triangles) and on the large scene
     (1920x1080, 4 bounces, 4 frames, 81,920 triangles); the frame kernel
     must be launched exactly once per frame, and every file the pipelined
     loop wrote (PNG and .npy) must equal a frame-by-frame render, byte for
     byte; ``--profile`` on the demo scene, whose trace must name the
     frame kernel's CUDA symbol; then the ptxas lines (registers, stack,
     spills) of every frame kernel and the full-frame kernel's occupancy
     (resident warps per SM), the device time of the frame kernel at
     demo, demo spp 4 and large, and each one's bound (bounds.py: the
     traversal work of the frame's rays);
  6. the round kernel in both layouts on 2^16 lanes (with subnormal
     weights), per variant: the static layout vs its plain version, on
     the demo sphere and on a scene of the roots walk; the
     compacted layout (a shuffled queue of the live lanes) vs its plain
     version after sorting by slot (child slot sets, counts within the
     capacity) and bit for bit vs the static kernel at each slot, then on
     an empty queue and on two misses per pixel, a subnormal and a normal
     radiance, in either queue order, and on three and four misses per
     pixel in four queue orders, twice each (sums bit-equal to the static
     layout's and to the plain version's); the fold kernel vs its plain
     version; the wavefront path (compacted) at the demo
     configuration and at the large scene, with every launch count set to
     0 just before each and read just after: the compacted round kernel
     must be launched once per bounce round (6 and 5 times), the fold
     kernel once per round of more than one lane per pixel (5 and 4), and
     nothing else; each is held against the static-layout wavefront
     (integrator.static_wavefront; stats exact, image bit for bit), the frame
     kernel and the eager integrator (the plain wavefront; the whole demo
     frame, every 64th pixel of the large one), rays_traced against the
     eager count; count_live_rays must equal rays_traced; the demo frame
     runs under torch.cuda.set_sync_debug_mode("error"), with and without
     stats; both wavefronts' times against the bound of the frame's ray
     tree (bounds.round_bound); then profile_rounds on both (every queue
     count within its static width), and the live rays per frame and live
     Mrays/s (live rays / frame-kernel ms);
  7. the traversal instruments: the MT and Woop sub-visit kernels equal
     their plain versions exactly at V = 64 and 70 (which wraps the
     64-sub table) on the tool's inputs with the tool's all-ones cull and
     a +-1 mix, and meet the tool's MT-vs-Woop check at V = 512; the
     tensor-core Woop kernel, one TF32 pass and 3xTF32, agrees with its
     plain version at V = 8, 70 and 512 (kernels/mtbench.py tc_agreement:
     t to rtol 2e-4 where the winner is the same, the winner the same on
     all but 1% of the rays), with its parity against MT; the six
     stall variants equal their plain version exactly at n_iter 64 and
     70, on the tool's all-ones carry and on one whose elements differ;
     then the CLIs ``mxu_mt_bench`` and ``stallbench`` at the
     tools' default sizes (ns/visit; ns/iter of each stall variant at
     N = 200,000 beside its bound, bounds.stall_bound: the larger of the
     throughput floor and the dependent chain's latency floor), with their
     launches counted;
  8. the modular path (``make_renderer(..., use_mega=False)``: the eager
     integrator over the closest-hit and env kernels) at 256x192 on the
     demo scene, one launch of each per bounce level, held against its
     plain version (the brute force on the card) and the frame kernel,
     and timed at the demo shape; then the CLI flags on CUDA, each run
     with every count set to 0 just before and read just after:
     ``--backend torch`` at 64x48 (no kernel launch; the PNG equal to the
     eager render's), ``--instances`` (three instances, one of
     mask 0; 1024x768, 5/2 bounces, 4 frames, each through the frame
     kernel's instance walk, ``walks["instances"]``; a 256x192 frame of
     the instance walk held against the eager integrator over the
     closest-hit and env kernels, which render the scene's bake; then
     the benchmark's rtiow_glass scene, 484 instances under 16 instance
     roots, at 96x54 against the eager integrator over the two levels
     through the walk's twin, and ``instance_hit`` equal to the twin on
     its camera rays),
     ``--accumulate`` 4 frames then ``--resume`` 2 (equal to the mean of
     the 6 single frames to 1e-6), ``--heatmap`` at the demo shape (one
     round-kernel launch per bounce round; counts sum to count_live_rays
     and equal the eager integrator's pixel_rays on every 64th pixel) and
     ``--serve 0 --frames 3`` in a thread (one GET of /frame over
     127.0.0.1 returns a PNG of the frame's size);
  9. the sharded renderers (parallel/sharding.py) with the one card's
     device repeated in the device list, so every shard's launch, gather
     and reassembly runs on the card: the fused pixel-DP over 2, 3 and 4
     shards at the demo and large cells, each image bit-equal to the
     single frame-kernel launch's with exactly k ``frame_tiles`` launches
     and no other (counts set to 0 just before, read just after), its
     frame time (back to back, and the card's) beside the single
     launch's, and one-tile launches (every tile of the demo; two of the
     large frame); ``frame_tiles`` vs its plain version at 256x192 on
     shards 0 and 1 of 3 and on the 4 shards of the demo frame (the
     kernels line's error); the wavefront pixel-DP (2 shards) bit-equal
     to one shard;
     sample-SP on a 2x2 grid at spp 4 (RMSE < 1e-6); tri-TP over 2 shards
     (winners equal to the brute force on 2^14 rays); the LBVH oracle
     (build times at 1,280 and 81,920 tris, 2^16 rays against the brute
     force, a 256x192 frame through its backend against the frame
     kernel); ``--devices 2`` on one card exits 2 naming it, ``--devices
     1`` renders with one frame-kernel launch;
 10. multi-process rendering (``python -m
     refraction_tpu_torch.parallel.distributed --device cuda``): two
     ranks on the one card, joined over gloo through a free localhost
     port, on the demo scene at 1024x768, 5/2 bounces. Frame sharding, 8
     orbit frames: both ranks report the same global counts and
     checksum, the sum of their locals and, to rel 1e-6, the sum of the
     frame means of one process's ``make_renderer(cfg, "cuda", cuda:0)``
     over the same angles; every PNG lands in one rank's directory; each
     rank launched the frame kernel once per frame of its share. Pixel-DP
     of one frame (``--fused-dp``): both ranks report the same sha256 as
     ``rt_frame``'s image here and ``matches_single_device``, each with
     one ``frame_tiles`` launch and one ``fused_radiance`` (its check). A
     rank that exits non-zero or hangs fails the run; each rank's wall
     time and its split (group start, scene upload, frames, collectives)
     are logged. Two ranks time-share one card: the times are the cost of
     processes and gloo, not scaling;
 11. the port's benchmark (``python -m refraction_tpu_torch.bench``) in a
     process of its own, in full mode with a budget for every extra: it
     must exit 0 within BENCH_TIMEOUT; its last line must hold every key
     of BENCH_KEYS and no ``*_error``, a passed gate for each of its six
     cells, in each timed regime as many frame-kernel launches as frames,
     and build80k's cold build in a directory other than ``_build/``.

The line before the last is a JSON object with each kernel's launches in
its main-path phase (5 for the frame kernel, 9 for its pixel-DP
entry ``frame_tiles``, 6 for the round kernel in
both layouts: ``round_queue`` and ``round_fold`` on the wavefront path,
``round`` on the static-layout wavefronts held against it; the modular
path of 8 for the closest-hit and env kernels, the CLIs of 7 for the
instruments), its error against the plain version, both times and its
bound (bounds.py; ``library_ms`` is null: no single PyTorch call computes
any of these functions; the stall entry's bound is the sum of the six
variants' bounds, whose latency floor is a count of dependent operations
and so reported on the operations side; phase 10's launches are made in
the ranks' processes, checked from their JSON lines and not added here;
its seconds are under ``distributed_s``; phase 11's bench line is under
``bench``, its launches made in its own process); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

# Tolerances (stated once, used by every phase; the instrument kernels and
# the accumulation are held exactly / to 1e-6 where they are checked):
HIT_AGREE = 0.9999      # share of lanes with equal liveness (round kernel)
T_RTOL = 1e-5           # relative t error where idx agrees
ENV_AGREE = 0.9999      # share of directions with an equal texel
IMG_RMSE = 1e-4         # frame RMSE against the plain version
PIX_TOL = 1e-3          # a pixel "differs" if any channel is off by more
PIX_SHARE = 1e-4        # ... and at most this share of pixels may differ
CHILD_ATOL = 1e-5       # round children where liveness agrees
# Compacted vs static-layout wavefront: both sum a pixel's misses in slot
# order, so the images are held bit for bit (no tolerance).
LARGE_STRIDE = 64       # plain version on every 64th pixel of the large frame
# Phase 10: the frame-sharded checksum against one process's sum of the
# same frames' means (the same kernel on the same card; float32 stats sum).
DIST_FRAMES = 8
DIST_RTOL = 1e-6
DIST_TIMEOUT = 240      # seconds for a pair of ranks
BENCH_TIMEOUT = 600     # seconds for phase 11's bench run
# Phase 11: the cells the bench gates, the regimes it counts launches in,
# and the keys its last line must hold.
BENCH_CELLS = ("headline", "ref_demo", "ott", "config5", "spp4", "build80k")
BENCH_REGIMES = ("latency", "loop", "device_ms", "batched",
                 "ref_demo_device_ms", "ott_device_ms", "config5_device_ms",
                 "spp4_loop", "build80k_first_frame")
BENCH_KEYS = (
    "metric", "value", "unit", "frame_ms", "frame_latency_ms",
    "loop_frame_ms", "batched_frame_ms", "device_ms", "mrays_dense",
    "mrays_live", "mrays_note", "dense_rays_per_frame", "live_rays_per_frame",
    "tris", "backend", "device", "card", "library", "build_s", "build_cached",
    "first_frame_s", "scene_s", "gate", "launches", "headline_scene",
    "ref_demo_device_ms", "ref_demo_fps_device", "ref_demo_note",
    "ref_demo_scene", "ott_device_ms", "ott_fps_device", "ott_note",
    "ott_scene", "config5_device_ms", "config5_fps_device", "config5_note",
    "config5_scene", "spp4_frame_ms", "spp4_live_rays_per_frame",
    "spp4_mrays_live", "spp4_rays_vs_spp1", "spp4_scene", "build_cold_s",
    "build80k_library", "build80k_cached", "first_frame80k_s",
    "compile80k_tris", "build80k_scene")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def image_diff(np, a, b) -> dict:
    a = a.detach().cpu().numpy().astype(np.float64)
    b = b.detach().cpu().numpy().astype(np.float64)
    d = np.abs(a - b)
    return {"rmse": float(np.sqrt(np.mean(d ** 2))),
            "max_abs_err": float(d.max()),
            "share_over": float((d.max(axis=-1) > PIX_TOL).mean())}


def check_image(tag: str, diff: dict) -> None:
    log(f"  {tag}: rmse {diff['rmse']:.3e} max_abs {diff['max_abs_err']:.3e} "
        f"share>{PIX_TOL:g} {diff['share_over']:.2e}")
    if not (diff["rmse"] < IMG_RMSE and diff["share_over"] <= PIX_SHARE):
        raise AssertionError(f"{tag}: images disagree: {diff}")


def serve_one_frame(drive, frames: int, argv) -> "np.ndarray":
    """Run ``drive(argv)`` (a ``--serve`` CLI run of ``frames`` frames) in a
    thread; frame 0 is published before its log line, whose handler holds
    the render loop until this thread has fetched ``/frame`` over
    127.0.0.1. Returns the decoded (H, W, 3) uint8 PNG."""
    import re
    import threading
    import urllib.request

    from refraction_tpu_torch.io.png import decode_png_bytes

    port, outcome, png = [], [], []
    published, fetched = threading.Event(), threading.Event()

    class Hold(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            m = re.match(r"live viewer at http://0\.0\.0\.0:(\d+)/", msg)
            if m:
                port.append(int(m.group(1)))
            elif msg.startswith('{"frame": 0,'):
                published.set()
                fetched.wait(300)

    def work():
        try:
            outcome.append(drive(argv, {"fused_radiance": frames}))
        except BaseException as e:  # handed to the main thread below
            outcome.append(e)
        finally:
            published.set()

    hold = Hold()
    logger = logging.getLogger("refraction_tpu")
    logger.addHandler(hold)
    worker = threading.Thread(target=work, daemon=True)
    try:
        worker.start()
        published.wait(600)
        if port and not outcome:
            with urllib.request.urlopen(f"http://127.0.0.1:{port[0]}/frame",
                                        timeout=60) as r:
                if r.headers["Content-Type"] != "image/png":
                    raise AssertionError(f"/frame: {r.headers}")
                png.append(r.read())
    finally:
        fetched.set()
        worker.join(600)
        logger.removeHandler(hold)
    if worker.is_alive():
        raise AssertionError("the --serve run did not end")
    if isinstance(outcome[0], BaseException):
        raise outcome[0]
    if not png:
        raise AssertionError("no frame was fetched from the viewer")
    return decode_png_bytes(png[0])


def run_ranks(workdir: str, args, out: str | None = None) -> list[dict]:
    """Two ranks of ``python -m refraction_tpu_torch.parallel.distributed
    --device cuda`` with ``args`` (rank r writes its PNGs to ``out`` + r),
    joined through a free localhost port; stdout and stderr go to files in
    ``workdir``. A rank that exits non-zero, or a pair still running after
    DIST_TIMEOUT, fails the run, and no rank is left running. Returns per
    rank its JSON line (``stats``), its ``timings`` log lines merged and
    its wall seconds from the start of both."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(workdir, exist_ok=True)
    root = os.path.dirname(os.path.abspath(__file__))
    logs = [(os.path.join(workdir, f"rank{r}.out"),
             os.path.join(workdir, f"rank{r}.err")) for r in range(2)]
    procs, wall = [], [None, None]
    t0 = time.perf_counter()
    try:
        for r, (out_path, err_path) in enumerate(logs):
            argv = [sys.executable, "-m",
                    "refraction_tpu_torch.parallel.distributed",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(r),
                    "--device", "cuda", *args]
            if out:
                argv += ["--out", f"{out}{r}"]
            with open(out_path, "w") as fo, open(err_path, "w") as fe:
                procs.append(subprocess.Popen(argv, cwd=root, stdout=fo,
                                              stderr=fe))
        while None in wall:
            for r, p in enumerate(procs):
                if wall[r] is None and p.poll() is not None:
                    wall[r] = time.perf_counter() - t0
                    if p.returncode != 0:
                        with open(logs[r][1]) as f:
                            err = f.read()[-3000:]
                        raise AssertionError(f"rank {r} exited "
                                             f"{p.returncode}:\n{err}")
            if time.perf_counter() - t0 > DIST_TIMEOUT:
                raise AssertionError(f"ranks still running after "
                                     f"{DIST_TIMEOUT} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (out_path, err_path) in enumerate(logs):
        with open(out_path) as f:
            stats = json.loads(f.read().strip().splitlines()[-1])
        timings = {}
        with open(err_path) as f:
            for line in f:
                m = re.search(r"timings (\{.*\})", line)
                if m:
                    timings.update(json.loads(m.group(1)))
        timings.pop("rank", None)
        results.append({"stats": stats, "timings": timings,
                        "wall_s": wall[r]})
    return results


def run_bench(workdir: str) -> tuple[dict, float]:
    """``python -m refraction_tpu_torch.bench`` in full mode with a budget
    for every extra (RRT_BENCH_BUDGET_S 1800), stdout and stderr to files
    in ``workdir``. A run that exits non-zero or outlasts BENCH_TIMEOUT
    (it is then killed) fails the smoke. Returns its last line, parsed,
    and its wall seconds."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, RRT_BENCH_BUDGET_S="1800")
    env.pop("RRT_BENCH_SMALL", None)
    out_path = os.path.join(workdir, "bench.out")
    err_path = os.path.join(workdir, "bench.err")
    t0 = time.perf_counter()
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        proc = subprocess.run(
            [sys.executable, "-m", "refraction_tpu_torch.bench"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=fo, stderr=fe, timeout=BENCH_TIMEOUT, check=False)
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        lines = f.read().splitlines()
    if proc.returncode != 0 or not lines:
        with open(err_path) as f:
            err = f.read()[-3000:]
        raise AssertionError(f"bench exited {proc.returncode}:\n{err}\n"
                             f"{lines[-1] if lines else '(no output)'}")
    return json.loads(lines[-1]), wall


def bench_faults(res: dict, card: str, kind: str, build_dir: str) -> dict:
    """What is wrong with the bench's last line ``res``, by check (every
    value empty or False when nothing is): keys missing from BENCH_KEYS,
    ``*_error`` fields, cells whose gate did not pass, regimes whose
    frame-kernel launches differ from their frames, a build80k library
    that was cached or lies in ``build_dir`` (where the bench's own must
    lie), a device or card line other than this card's, and times that
    are not positive (``build_s`` is 0.0 for a library already built)."""
    gates = res.get("gate", {})
    counts = res.get("launches", {})
    built_in = {k: os.path.dirname(res.get(k) or "")
                for k in ("library", "build80k_library")}
    return {
        "missing keys": [k for k in BENCH_KEYS if k not in res],
        "errors": {k: v for k, v in res.items() if k.endswith("_error")},
        "gates not ok": [c for c in BENCH_CELLS
                         if not gates.get(c, {}).get("ok")],
        "launches != frames": {
            r: counts.get(r) for r in BENCH_REGIMES
            if not counts.get(r)
            or counts[r]["fused_radiance"] != counts[r]["frames"]},
        "build80k not a cold build elsewhere": (
            built_in["build80k_library"] in ("", build_dir)
            or built_in["library"] != build_dir
            or res.get("build80k_cached") is not False),
        "device or card": res.get("device") != kind or res.get("card") != card,
        "non-positive times": [
            k for k in BENCH_KEYS if k.endswith(("_ms", "_s", "value"))
            and k != "build_s" and k in res
            and not (isinstance(res[k], (int, float)) and res[k] > 0)]}


def check_rtiow_glass(dev, counters) -> None:
    """The instance walk at the benchmark's deployment: rtiow_glass's 484
    instances (rtbench/configs/rtiow_glass.json, its meshes and placements
    as the file lists them) under 16 instance roots, over two shared
    BLASes of the supers walk. With every count set to 0 just before:
    frames of the frame kernel (``walks["instances"]``) at 96x54 and the
    configuration's render block, held against the eager integrator over
    the two levels through the walk's eager twin, ``instance_hit_plain``,
    on the card's tensors (no kernel), and the walk on a batch of the
    same camera rays (``instance_hit``) equal to the twin on every ray."""
    import numpy as np
    import torch

    from refraction_tpu_torch import RenderConfig
    from refraction_tpu_torch.camera import generate_rays, orbit_camera
    from refraction_tpu_torch.integrator import render_image
    from refraction_tpu_torch.io.primitives import (
        make_gradient_envmap, make_icosphere)
    from refraction_tpu_torch.kernels.envmap import env_contribution_plain
    from refraction_tpu_torch.kernels.framekernel import (
        build_scalars, fused_radiance, walk_levels)
    from refraction_tpu_torch.kernels.intersect import (
        cull_code, instance_hit, instance_hit_plain)
    from refraction_tpu_torch.render import sample_offsets
    from refraction_tpu_torch.scene import (
        Instance, build_instanced_scene, instance_transform, scene_from_jax)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rtbench", "configs", "rtiow_glass.json")
    with open(path) as f:
        config = json.load(f)
    spec = config["scene"]
    meshes = {}
    for name, m in spec["meshes"].items():
        if m["kind"] != "icosphere":
            raise AssertionError(f"rtiow_glass mesh {name}: {m}")
        meshes[name] = make_icosphere(m["subdiv"], m["radius"])
    insts = [Instance(meshes[e["mesh"]],
                      instance_transform(e["translate"], e["scale"],
                                         e["rotate_y_deg"]),
                      mask=e.get("mask", 1)) for e in spec["instances"]]
    host, meta = build_instanced_scene(insts, make_gradient_envmap())
    ts = scene_from_jax(host, dev)
    lv = walk_levels(ts)
    if (lv["walk"], lv["instances"], lv["instance_roots"]) != (
            "instances", 484, 16) or meta.num_real_tris != spec["tris"]:
        raise AssertionError(f"rtiow_glass scene: {lv}, "
                             f"{meta.num_real_tris} tris")
    fields = set(RenderConfig.__dataclass_fields__)
    cfg = RenderConfig(**{k: v for k, v in config["render"].items()
                          if k in fields}).replace(width=96, height=54)

    def twin_intersect(scene, o, d, want_front, alive, tmin, tmax):
        t, key, normal = instance_hit_plain(scene, o, d,
                                            cull_code(want_front, alive),
                                            tmin, tmax)
        return key >= 0, t, key, normal

    offsets = sample_offsets(cfg.spp)
    angles = (0.2, 3.3)
    for k in counters + (instance_hit,):
        k.launches = 0
    for name in fused_radiance.walks:
        fused_radiance.walks[name] = 0
    for angle in angles:
        frame = orbit_camera(angle, cfg)
        img_k = fused_radiance(ts, build_scalars(frame, cfg, offsets, dev),
                               cfg)
        img_e = render_image(ts, frame, cfg, offsets, dev, twin_intersect,
                             env_contribution_plain)
        check_image(f"rtiow_glass 96x54 angle {angle}: frame kernel "
                    "(instance walk) vs eager integrator over the twin",
                    image_diff(np, img_k, img_e))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters + (instance_hit,)}
    if (fused_radiance.walks["instances"] != len(angles)
            or sum(launches.values()) != len(angles)
            or ts._baked is not None):
        raise AssertionError(f"rtiow_glass: walks {fused_radiance.walks}, "
                             f"launches {launches}, bake built "
                             f"{ts._baked is not None}")
    rays = [generate_rays(orbit_camera(a, cfg), cfg.width, cfg.height, dev)
            for a in angles]
    o = torch.cat([r[0] for r in rays]).contiguous()
    d = torch.cat([r[1] for r in rays]).contiguous()
    hits = 0
    for c in (1.0, -1.0):
        cull = torch.full((o.shape[0],), c, device=dev)
        got = instance_hit(ts, o, d, cull, cfg.primary_tmin,
                           cfg.primary_tmax)
        want = instance_hit_plain(ts, o, d, cull, cfg.primary_tmin,
                                  cfg.primary_tmax)
        hit = want[1] >= 0
        if not (torch.equal(got[1], want[1])
                and torch.equal(got[0][hit], want[0][hit])
                and torch.isinf(got[0][~hit]).all()
                and torch.equal(got[2], want[2])):
            raise AssertionError("rtiow_glass: instance_hit differs from "
                                 "its twin on the camera rays")
        hits += int(hit.sum())
    log(f"  rtiow_glass: {lv['instances']} instances under "
        f"{lv['instance_roots']} instance roots, {meta.num_real_tris} placed "
        f"tris; {len(angles)} frames at 96x54 through the instance walk; "
        f"instance_hit equal to its twin on {o.shape[0]} camera rays x 2 "
        f"culls ({hits} hits); launches {launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("phase 0: nvidia-smi --query-gpu=name,power.limit:")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    import numpy as np

    from refraction_tpu_torch import RenderConfig, bounds
    from refraction_tpu_torch.bvh.clusters import build_clusters
    from refraction_tpu_torch.camera import orbit_camera
    from refraction_tpu_torch.fixtures import (
        multi_miss_lanes, paired_miss_lanes, write_obj, write_scene)
    from refraction_tpu_torch.io.primitives import (
        make_cube, make_gradient_envmap, make_icosphere)
    from refraction_tpu_torch.kernels import _build
    from refraction_tpu_torch.kernels.envmap import (
        env_contribution, env_contribution_plain)
    from refraction_tpu_torch.kernels.framekernel import (
        WALKS, build_scalars, frame_occupancy, frame_tiles,
        frame_tiles_plain, fused_radiance, fused_radiance_plain, tile_grid,
        walk_of)
    from refraction_tpu_torch.kernels.intersect import (
        closest_hit, closest_hit_plain)
    from refraction_tpu_torch.kernels.megakernel import (
        LaneQueue, empty_queue, fold_round_sums, fold_round_sums_plain,
        mega_round, mega_round_plain, mega_round_queue,
        mega_round_queue_plain, slot_order_sum)
    from refraction_tpu_torch.camera import generate_rays
    from refraction_tpu_torch.integrator import (
        render_image, render_pixels, render_pixels_mega, static_wavefront,
        static_widths)
    from refraction_tpu_torch.ops.backends import get_backend, torch_intersect
    from refraction_tpu_torch.bvh.lbvh import (
        lbvh_from_scene, lbvh_intersect, make_lbvh_backend)
    from refraction_tpu_torch.parallel.sharding import (
        assemble_tiles, make_fused_sharded_renderer,
        make_sample_sharded_renderer, make_sharded_renderer,
        make_trisharded_intersect)
    from refraction_tpu_torch.render import (
        count_live_rays, frame_traversal_work, sample_offsets)
    from refraction_tpu_torch import profile_rounds
    from refraction_tpu_torch.io.objmesh import MeshData
    from refraction_tpu_torch.scene import (
        Scene, auto_cluster_size, build_scene, load_instanced, load_scene,
        merge_meshes, scene_from_jax)
    from refraction_tpu_torch import run as cli
    from refraction_tpu_torch import mxu_mt_bench, stallbench
    from refraction_tpu_torch.kernels.mtbench import (
        TC_MISMATCH_SHARE, TC_T_RTOL, make_inputs, mt_args, mt_visits,
        mt_visits_plain, tc_agreement, woop_args, woop_visits,
        woop_visits_plain, woop_visits_tc, woop_visits_tc3,
        woop_visits_tc_plain)
    from refraction_tpu_torch.kernels.stallbench import (
        VARIANTS as STALL_VARIANTS, mixed_carry, stall_iters,
        stall_iters_plain)
    from refraction_tpu_torch.render import make_renderer, render_heatmap
    from refraction_tpu_torch.io.png import load_png
    from refraction_tpu_torch.timing import card_ms, device_ms, time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    results = {}

    # --- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = _build.loaded_build()
    log(f"phase 1: built {os.path.basename(built.path)} in "
        f"{built.seconds:.1f} s nvcc "
        f"({time.perf_counter() - t0:.1f} s with load)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    def device_scene(mesh, env, cluster_size=None):
        cs = cluster_size or auto_cluster_size(mesh.num_tris)
        return scene_from_jax(build_scene(mesh, env, cs)[0], dev)

    def nested_shell(outer, inner):
        """A glass shell: icosphere ``outer`` (radius 1.2) around an
        inward-wound icosphere ``inner`` (radius 0.9), as the benchmark's
        shell_hp mesh (8 and 7) is built."""
        a, b = make_icosphere(outer, 1.2), make_icosphere(inner, 0.9)
        flip = [0, 2, 1]
        return merge_meshes([a, MeshData(b.positions[:, flip],
                                         -b.normals[:, flip],
                                         b.uvs[:, flip])])

    def roots_scene(sc):
        """``sc``, which has to take the roots walk."""
        if walk_of(sc) != "roots":
            raise AssertionError(f"walk {walk_of(sc)}, want roots")
        return sc

    def equal_t_scene(mesh, env, cs):
        """The built scene plus one last cluster of copies of cs of its
        triangles, drawn from the whole mesh (rows copied bit for bit):
        every copy has an equal-t twin of lower index, and the copies' box
        spans the mesh, so a near-to-far walk enters it first. Returns the
        device scene and the twins' indices."""
        base = build_scene(mesh, env, cs)[0]
        pick = np.random.default_rng(9).permutation(base.num_tris)[:cs]
        rows = {k: np.concatenate([getattr(base, k), getattr(base, k)[pick]])
                for k in ("tri_a", "tri_e1", "tri_e2", "tri_packed",
                          "tri_norm_packed", "tri_mask")}
        a = rows["tri_a"][-cs:]
        corners = np.stack([a, a + rows["tri_e1"][-cs:],
                            a + rows["tri_e2"][-cs:]], axis=1)
        pad = np.float32(1e-5)  # a box a little larger only opens more
        boxes = [np.concatenate([lo - pad, hi + pad], axis=1)
                 for lo, hi in (build_clusters(corners, cs),
                                build_clusters(corners, 8))]
        host = Scene(**rows, envmap=base.envmap,
                     cluster_bounds=np.concatenate([base.cluster_bounds,
                                                    boxes[0]]),
                     sub_bounds=np.concatenate([base.sub_bounds, boxes[1]]))
        return scene_from_jax(host, dev), pick

    # --- phase 2: closest hit -------------------------------------------
    log("phase 2: closest-hit kernel vs brute force")
    rng = np.random.default_rng(2)
    n = 2 ** 16
    o_np = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d_np = rng.normal(size=(n, 3)).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    o = torch.from_numpy(o_np).to(dev)
    d = torch.from_numpy(d_np).to(dev)
    env_small = make_gradient_envmap(64, 128)
    ico4, ico5 = make_icosphere(4), make_icosphere(5)
    ch_times = None
    cases = [(name, device_scene(mesh, env_small, cs), None)
             for name, mesh, cs in (("icosphere4", ico4, None),
                                    ("icosphere4 cs8", ico4, 8),
                                    ("cube2", make_cube(2.0), None),
                                    ("icosphere5 cs8", ico5, 8))]
    cases += [(f"icosphere4 cs{cs} + equal-t copies",
               *equal_t_scene(ico4, env_small, cs)) for cs in (1024, 128, 8)]
    cases += [("icosphere5 cs8 + equal-t copies",
               *equal_t_scene(ico5, env_small, 8))]
    roots_sc = roots_scene(cases[3][1])
    roots_scene(cases[-1][1])
    for name, sc, twins in cases:
        for cull_v in (1.0, -1.0):
            cull = torch.full((n,), cull_v, dtype=torch.float32, device=dev)
            tk, ik, nk = closest_hit(sc, o, d, cull, 1e-4, 100.0)
            tp, ip, np_ = closest_hit_plain(sc, o, d, cull, 1e-4, 100.0)
            torch.cuda.synchronize()
            same = (ik == ip)
            agree = float(same.float().mean())
            hit = same & (ik >= 0)
            t_err = float(((tk - tp).abs() / tp.abs().clamp_min(1e-30))[hit]
                          .max()) if bool(hit.any()) else 0.0
            n_err = float((nk - np_).abs()[hit].max()) if bool(hit.any()) else 0.0
            msg = (f"  {name} ({sc.num_clusters} clusters, walk "
                   f"{walk_of(sc)}) cull {cull_v:+.0f}: winners equal on "
                   f"{agree:.6f} of rays, hits {int((ip >= 0).sum())}, t rel "
                   f"err {t_err:.2e}, normal abs err {n_err:.2e}")
            if twins is not None:
                msg += (f"; winners with an equal-t copy "
                        f"{int(np.isin(ip.cpu().numpy(), twins).sum())}")
            log(msg)
            if agree != 1.0 or t_err > T_RTOL:
                raise AssertionError(f"closest_hit {name} cull {cull_v}")
            if name == "icosphere4" and cull_v > 0:
                t_hit = torch.where(ip >= 0, tp, torch.full_like(tp, 100.0))
                ch_times = (
                    cuda_ms(torch, lambda: closest_hit(
                        sc, o, d, cull, 1e-4, 100.0), 20),
                    cuda_ms(torch, lambda: closest_hit_plain(
                        sc, o, d, cull, 1e-4, 100.0), 3),
                    t_err, n_err,
                    bounds.closest_hit_bound(sc, o, d, cull, 1e-4, t_hit))
    results["closest_hit"] = ch_times
    log(f"  time at 2^16 rays x 5120 tris: kernel {ch_times[0]:.3f} ms, "
        f"plain {ch_times[1]:.3f} ms")

    # --- phase 3: env ---------------------------------------------------
    log("phase 3: env kernel vs gather")
    env_big = make_gradient_envmap(1024, 2048)
    sc_env = device_scene(make_cube(2.0), env_big, 8)
    de = torch.from_numpy(d_np).to(dev)
    w_np = np.where(rng.random(n) < 0.8, rng.random(n), 0.0).astype(np.float32)
    w = torch.from_numpy(w_np).to(dev)
    ek = env_contribution(sc_env, de, w)
    ep = env_contribution_plain(sc_env, de, w)
    torch.cuda.synchronize()
    env_agree = float((ek == ep).all(dim=1).float().mean())
    env_err = float((ek - ep).abs().max())
    log(f"  texel agree {env_agree:.6f} (max abs err {env_err:.3e})")
    if env_agree < ENV_AGREE:
        raise AssertionError("env kernel disagrees with the gather")
    eb = bounds.env_bound(sc_env, n, int((w > 0).sum()))
    results["env"] = (
        card_ms(lambda: env_contribution(sc_env, de, w), 20, dev),
        card_ms(lambda: env_contribution_plain(sc_env, de, w), 20, dev),
        env_err, eb)
    log(f"  time at 2^16 rays ({int((w > 0).sum())} of weight > 0): kernel "
        f"{results['env'][0]:.4f} ms, plain {results['env'][1]:.4f} ms, "
        f"bound {eb['bound_ms']:.4f} ms by {eb['bound_by']} ({eb['bytes']} "
        f"bytes) [{card}]")
    # The widths the eager "cuda" backend gives the kernel at the demo: a
    # round's static width, about a tenth of the weights > 0; and an odd
    # count.
    for n_w in (786_432, 3_145_728, 100_003):
        dw = rng.normal(size=(n_w, 3)).astype(np.float32)
        dw /= np.linalg.norm(dw, axis=1, keepdims=True)
        dw = torch.from_numpy(dw).to(dev)
        ww = torch.from_numpy(np.where(
            rng.random(n_w) < 0.1, rng.random(n_w), 0.0).astype(np.float32)
        ).to(dev)
        ekw = env_contribution(sc_env, dw, ww)
        epw = env_contribution_plain(sc_env, dw, ww)
        torch.cuda.synchronize()
        agree_w = float((ekw == epw).all(dim=1).float().mean())
        ebw = bounds.env_bound(sc_env, n_w, int((ww > 0).sum()))
        k_ms = card_ms(lambda: env_contribution(sc_env, dw, ww), 20, dev)
        p_ms = card_ms(lambda: env_contribution_plain(sc_env, dw, ww), 5,
                       dev)
        log(f"  {n_w} rays ({int((ww > 0).sum())} of weight > 0): texel "
            f"agree {agree_w:.6f}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms,"
            f" bound {ebw['bound_ms']:.4f} ms by {ebw['bound_by']} "
            f"({ebw['bound_ms'] / k_ms:.1%} of it) [{card}]")
        if agree_w < ENV_AGREE or bool((ekw[ww == 0] != 0).any()):
            raise AssertionError(f"env kernel disagrees at {n_w} rays")
        env_err = max(env_err, float((ekw - epw).abs().max()))
    results["env"] = (*results["env"][:2], env_err, eb)

    # --- phase 4: frame kernel vs eager integrator ----------------------
    log("phase 4: frame kernel vs eager integrator")

    env_mid = make_gradient_envmap(256, 512)
    sphere = device_scene(make_icosphere(3, 1.2), env_mid)
    cube = device_scene(make_cube(2.0), env_mid)
    base = RenderConfig(width=256, height=192)
    cases = [("sphere default", sphere, base, 0.85),
             ("sphere spp4", sphere, base.replace(spp=4), 0.85),
             ("cube", cube, base, 0.3),
             ("sphere caps(1,0)", sphere,
              base.replace(max_refract_depth=1, max_reflect_depth=0), 0.5),
             ("sphere 250x190", sphere, base.replace(width=250, height=190),
              0.6),
             ("icosphere6 81920 tris 160x90", device_scene(
                 make_icosphere(6, 1.2), env_mid),
              RenderConfig(width=160, height=90, max_refract_depth=4), 0.2),
             ("nested shell 25600 tris cs8 128x96", roots_scene(
                 device_scene(nested_shell(5, 4), env_mid, 8)),
              RenderConfig(width=128, height=96), 0.35),
             ("nested shell 1638400 tris 64x36", roots_scene(
                 device_scene(nested_shell(8, 7), env_mid)),
              RenderConfig(width=64, height=36), 2.2)]
    for tag, sc, cfg, angle in cases:
        scal = build_scalars(orbit_camera(angle, cfg), cfg,
                             sample_offsets(cfg.spp), dev)
        img_k = fused_radiance(sc, scal, cfg)
        img_p = fused_radiance_plain(sc, scal, cfg)
        torch.cuda.synchronize()
        if tuple(img_k.shape) != (cfg.height, cfg.width, 3):
            raise AssertionError(f"{tag}: shape {tuple(img_k.shape)}")
        check_image(f"{tag} (walk {walk_of(sc)})", image_diff(np, img_k, img_p))

    # --- phase 5: the main path through the CLI -------------------------
    log("phase 5: main path (python -m refraction_tpu_torch.run)")
    tmp = tempfile.mkdtemp(prefix="rt_smoke_")
    frame_lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith('{"frame"'):
                frame_lines.append(json.loads(msg))

    cap = Capture()
    logging.getLogger("refraction_tpu").addHandler(cap)
    runs = [("demo", make_icosphere(3, 1.2), 1024, 768, 5, 8),
            ("large", make_icosphere(6, 1.2), 1920, 1080, 4, 4)]
    paths = {}
    for tag, mesh, *_ in runs:
        paths[tag] = write_scene(tmp, tag, mesh, make_gradient_envmap(1024, 2048))
    launches = {"frame": 0, "closest_hit": 0, "env": 0}
    per_frame = {}
    try:
        fused_radiance.launches = 0
        closest_hit.launches = 0
        env_contribution.launches = 0
        for tag, mesh, wd, ht, bounces, frames in runs:
            before = fused_radiance.launches
            del frame_lines[:]
            out = os.path.join(tmp, tag, "frame.png")
            rc = cli.main(["--scene", paths[tag][0], "--envmap", paths[tag][1],
                           "--width", str(wd), "--height", str(ht),
                           "--bounces", str(bounces), "--spp", "1",
                           "--frames", str(frames), "--out", out, "--raw",
                           "--backend", "cuda", "--device", "cuda"])
            torch.cuda.synchronize()
            got = fused_radiance.launches - before
            if rc != 0 or got != frames:
                raise AssertionError(f"{tag}: rc {rc}, frame kernel launched "
                                     f"{got} times for {frames} frames")
            for i in range(frames):
                raw = np.load(os.path.join(tmp, tag, f"frame_{i:04d}.npy"))
                if raw.shape != (ht, wd, 3) or not np.isfinite(raw).all():
                    raise AssertionError(f"{tag} frame {i}: shape {raw.shape}"
                                         " or non-finite values")
                if float(raw.std()) == 0.0:
                    raise AssertionError(f"{tag} frame {i}: constant image")
            ms = [f["stream_ms"] for f in frame_lines]
            per_frame[tag] = ms
            log(f"  {tag} {wd}x{ht} {mesh.num_tris} tris, {bounces} bounces: "
                f"{frames} frames, frame-kernel launches {got}; stream ms per "
                f"frame {[round(m, 3) for m in ms]} [{card}]")
        launches = {"frame": fused_radiance.launches,
                    "closest_hit": closest_hit.launches,
                    "env": env_contribution.launches}
    finally:
        logging.getLogger("refraction_tpu").removeHandler(cap)
    log(f"  launches during phase 5: {launches}")

    # Kernel vs plain at the demo shape, on the demo scene the CLI loaded.
    cfg = RenderConfig(width=1024, height=768, max_refract_depth=5,
                       scene_path=paths["demo"][0],
                       envmap_path=paths["demo"][1])
    demo = scene_from_jax(load_scene(cfg)[0], dev)
    scal = build_scalars(orbit_camera(0.01, cfg), cfg, sample_offsets(1), dev)
    img_k = fused_radiance(demo, scal, cfg)
    img_p = fused_radiance_plain(demo, scal, cfg)
    torch.cuda.synchronize()
    diff = image_diff(np, img_k, img_p)
    check_image("demo 1024x768 kernel vs plain", diff)
    frame_err = diff["max_abs_err"]
    kernel_lines = built.log.splitlines()
    for i, line in enumerate(kernel_lines):
        m = re.search(r"_Z\d+(rt_frame(?:_tiles)?_kernel)ILi(\d+)EEv", line)
        if "Compiling entry function" in line and m:
            walk = WALKS[int(m.group(2))]
            log(f"  ptxas -v, {m.group(1)} ({walk} walk): "
                + " | ".join(x.strip() for x in kernel_lines[i + 2:i + 4]))
    occupancy = {}
    for walk in WALKS:
        occ = frame_occupancy(walk, dev)
        occupancy[walk] = occ
        log(f"  occupancy, frame kernel ({walk} walk): "
            f"{occ['blocks_per_sm']} blocks of "
            f"{occ['threads_per_block']} = {occ['warps_per_sm']} warps "
            f"per SM, {occ['registers']} registers, {occ['local_bytes']}"
            f" B local a thread [{card}]")
    plain_ms = cuda_ms(torch, lambda: fused_radiance_plain(demo, scal, cfg), 1)
    cfg_l = RenderConfig(width=1920, height=1080, max_refract_depth=4,
                         scene_path=paths["large"][0],
                         envmap_path=paths["large"][1])
    large = scene_from_jax(load_scene(cfg_l)[0], dev)
    cfg_4 = cfg.replace(spp=4)
    # Every file the pipelined loop wrote equals a frame-by-frame render:
    # the .npy bit for bit, the PNG byte for byte (written again here from
    # the frame's to_u8).
    ref_png = os.path.join(tmp, "ref.png")
    for (tag, *_, frames), sc, c in zip(runs, (demo, large), (cfg, cfg_l)):
        angle = 0.01
        for i in range(frames):
            img = fused_radiance(sc, build_scalars(
                orbit_camera(angle, c), c, sample_offsets(1), dev), c)
            stem = os.path.join(tmp, tag, f"frame_{i:04d}")
            cli.write_png(ref_png, cli.to_u8(img).cpu().numpy())
            with open(stem + ".png", "rb") as f, open(ref_png, "rb") as g:
                same_png = f.read() == g.read()
            if not (same_png and np.array_equal(np.load(stem + ".npy"),
                                                img.cpu().numpy())):
                raise AssertionError(f"{tag} frame {i}: the loop's files "
                                     "differ from a frame-by-frame render")
            angle += c.orbit_speed
        log(f"  {tag}: the pipelined loop's {frames} PNG and .npy files equal "
            "a frame-by-frame render's, byte for byte")
    # --profile: one warm frame, one profiled frame, then the loop's one.
    prof_dir = os.path.join(tmp, "profile")
    before = fused_radiance.launches
    rc = cli.main(["--scene", paths["demo"][0], "--envmap", paths["demo"][1],
                   "--width", "1024", "--height", "768", "--bounces", "5",
                   "--frames", "1", "--out", os.path.join(prof_dir, "f.png"),
                   "--profile", prof_dir, "--backend", "cuda",
                   "--device", "cuda"])
    torch.cuda.synchronize()
    got = fused_radiance.launches - before
    with open(os.path.join(prof_dir, "frame_trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    on_card = [e for e in trace if e.get("cat") == "kernel"]
    frame_ev = [e for e in on_card if "rt_frame_kernel" in e.get("name", "")]
    log(f"  --profile: rc {rc}, frame-kernel launches {got}; {len(trace)} "
        f"trace events, {len(on_card)} on the card: "
        f"{sorted({e['name'][:60] for e in on_card})}; frame kernel "
        f"{[round(e.get('dur', 0) / 1e3, 4) for e in frame_ev]} ms [{card}]")
    if rc != 0 or got != 3 or not frame_ev:
        raise AssertionError("--profile: the trace does not name the frame "
                             "kernel")
    frame_rows = {}  # cell -> kernel ms, bound, work levels
    for tag, sc, c in (("demo", demo, cfg), ("demo spp 4", demo, cfg_4),
                       ("large", large, cfg_l)):
        cam = orbit_camera(0.01, c)
        sc_c = build_scalars(cam, c, sample_offsets(c.spp), dev)
        runs_ms = [cuda_ms(torch, lambda: fused_radiance(sc, sc_c, c), 10)
                   for _ in range(2)]
        ms = sum(runs_ms) / len(runs_ms)
        levels = frame_traversal_work(sc, c, cam, dev)
        b = bounds.frame_bound(sc, c, levels)
        frame_rows[tag] = {"ms": ms, "runs_ms": runs_ms, "bound": b,
                           "levels": levels}
        log(f"  {tag} {c.width}x{c.height} {c.max_refract_depth}/"
            f"{c.max_reflect_depth} bounces spp {c.spp}, walk {walk_of(sc)}: "
            f"rt_frame {runs_ms[0]:.4f}, {runs_ms[1]:.4f} ms "
            f"({b['bound_ms'] / ms:.1%} of the bound); bound "
            f"{b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({b['ops']} FP32 ops, {b['bytes']} bytes; "
            f"{b['work']['rays']} rays) [{card}]")
    log(f"  demo plain (eager integrator, same shape) {plain_ms:.1f} ms")
    frame_ms, large_ms = frame_rows["demo"]["ms"], frame_rows["large"]["ms"]
    if launches["frame"] != sum(r[-1] for r in runs):
        raise AssertionError(f"frame kernel launches {launches['frame']}")

    # --- phase 6: per-round wavefront -----------------------------------
    log("phase 6: round kernel vs plain; wavefront path (render_pixels_mega)")
    counters = (fused_radiance, closest_hit, env_contribution, mega_round,
                mega_round_queue, fold_round_sums)
    n = 2 ** 16
    lanes = np.stack([*rng.uniform(-3, 3, (3, n)), *d_np.T,
                      rng.choice([1.0, -1.0, 0.0], n), rng.random(n)])
    lanes[7, ::8] = 1.4e-45  # subnormal: w * R underflows to 0
    state = torch.from_numpy(lanes.astype(np.float32)).to(dev)
    subnormal = state[7] < 1e-40
    limits = (1e-3, 1000.0, 1.3, RenderConfig().fresnel_r0)
    variant_err = 0.0
    # The demo sphere (flat walk) and phase 2's 20,480-triangle sphere at
    # clusters of 8 (roots walk), each in every variant.
    round_cases = [(sname, rsc, *v)
                   for sname, rsc in (("sphere", sphere),
                                      ("icosphere5 cs8, roots", roots_sc))
                   for v in (("full", True, True), ("norefl", False, True),
                             ("missonly", False, False))]
    for sname, rsc, vname, want_reflect, want_children in round_cases:
        got = mega_round(rsc, state, limits, want_reflect, want_children)
        ref = mega_round_plain(rsc, state, limits, want_reflect,
                               want_children)
        torch.cuda.synchronize()
        rad_d = (got.radiance - ref.radiance).abs()
        rad_off = float((rad_d.amax(dim=1) > PIX_TOL).double().mean())
        msg = f"  {sname} {vname}: radiance share>{PIX_TOL:g} {rad_off:.2e}"
        ok = rad_off <= 1 - HIT_AGREE
        err = float(rad_d.max())
        if want_children:
            alive_k = got.children[6] != 0
            alive_p = ref.children[6] != 0
            agree = float((alive_k == alive_p).double().mean())
            same = alive_k == alive_p
            kid_err = float((got.children - ref.children)[:, same].abs().max())
            err = max(err, kid_err)
            msg += (f", child liveness agree {agree:.6f} of "
                    f"{int(alive_p.sum())} live, child max abs err {kid_err:.2e}")
            ok = ok and agree >= HIT_AGREE and kid_err <= CHILD_ATOL
            if want_reflect:
                hit = alive_p[n:]
                under = hit & subnormal
                ok = ok and bool((got.children[6, n:][hit] == state[6][hit]).all())
                ok = ok and bool((got.children[7, n:][under] == 0).all())
                msg += f", {int(under.sum())} live reflections of weight 0"
        variant_err = max(variant_err, err)
        log(msg)
        if not ok:
            raise AssertionError(
                f"round kernel {sname} {vname} disagrees with plain")

    # The compacted round kernel on the live lanes of the same state, as a
    # queue in shuffled order, one pixel per slot: against its plain
    # version (after sorting by slot) and, bit for bit, against the static
    # kernel's results at each slot; then an empty queue.
    live_idx = torch.nonzero(state[6] != 0).squeeze(1)
    live_idx = live_idx[torch.randperm(
        live_idx.numel(), generator=torch.Generator().manual_seed(5)).to(dev)]
    n_live = int(live_idx.numel())

    def queue(cap, width, lanes=None, slots=None):
        st, sl = empty_queue(cap, dev)
        if lanes is not None:
            st[:, :lanes.shape[1]] = lanes
            sl[:slots.numel()] = slots
        count = torch.tensor([0 if lanes is None else lanes.shape[1]],
                             dtype=torch.int32, device=dev)
        return LaneQueue(st, sl, count, width)

    def by_slot(q):
        c = int(q.count)
        slots, order = torch.sort(q.slot[:c].long())
        return slots, q.state[:, :c][:, order]

    queue_err = 0.0
    for sname, rsc, vname, want_reflect, want_children in round_cases:
        w_out = n * (2 if want_reflect else 1)
        outs, rads, pix = [], [], []
        for fn in (mega_round_queue, mega_round_queue_plain):
            q_in = queue(n, n, state[:, live_idx], live_idx.to(torch.int32))
            outs.append(queue(w_out, w_out) if want_children else None)
            rads.append(torch.zeros(n, 3, dtype=torch.float32, device=dev))
            pix.append(torch.zeros(n, dtype=torch.int32, device=dev))
            fn(rsc, q_in, limits, want_reflect, want_children, rads[-1],
               pix[-1], outs[-1])
        static = mega_round(rsc, state, limits, want_reflect,
                            want_children)
        torch.cuda.synchronize()
        rad_d = (rads[0] - rads[1]).abs()
        rad_off = float((rad_d.amax(dim=1) > PIX_TOL).double().mean())
        err = float(rad_d.max())
        exact = bool(torch.equal(rads[0], static.radiance))
        ok = (rad_off <= 1 - HIT_AGREE and exact
              and torch.equal(pix[0], pix[1])
              and int(pix[0].sum()) == n_live)
        msg = (f"  compacted {sname} {vname}: {n_live} queued, radiance share>"
               f"{PIX_TOL:g} {rad_off:.2e}, equal to the static kernel's "
               f"{exact}")
        if want_children:
            count = int(outs[0].count)
            sk, ck = by_slot(outs[0])
            sp, cp = by_slot(outs[1])
            common = torch.from_numpy(np.intersect1d(
                sk.cpu().numpy(), sp.cpu().numpy())).to(dev)
            only = sk.numel() + sp.numel() - 2 * common.numel()
            kid_err = float((ck[:, torch.searchsorted(sk, common)]
                             - cp[:, torch.searchsorted(sp, common)])
                            .abs().max())
            err = max(err, kid_err)
            # The static kernel's children at the queued slots, bit for bit,
            # and no live static child left out.
            alive_s = static.children[6] != 0
            exact_kids = (torch.equal(sk, torch.nonzero(alive_s).squeeze(1))
                          and torch.equal(ck, static.children[:, sk]))
            msg += (f"; children {count} (capacity {w_out}), slots in one "
                    f"version only {only}, child max abs err {kid_err:.2e}, "
                    f"equal to the static kernel's {exact_kids}")
            ok = (ok and count <= w_out and only <= (1 - HIT_AGREE) * n
                  and kid_err <= CHILD_ATOL and exact_kids)
            if want_reflect:
                refl = sk >= n
                under = refl & subnormal[(sk - n).clamp(0, n - 1)]
                ok = ok and int(under.sum()) > 0 and bool(
                    (ck[7][under] == 0).all())
                msg += f", {int(under.sum())} queued reflections of weight 0"
        queue_err = max(queue_err, err)
        log(msg)
        if not ok:
            raise AssertionError(
                f"compacted round kernel {sname} {vname} disagrees")
        # An empty queue: one launch that adds and appends nothing.
        rad0 = torch.zeros(n, 3, dtype=torch.float32, device=dev)
        pix0 = torch.zeros(n, dtype=torch.int32, device=dev)
        out0 = queue(w_out, w_out) if want_children else None
        mega_round_queue(rsc, queue(n, n), limits, want_reflect,
                         want_children, rad0, pix0, out0)
        torch.cuda.synchronize()
        if (bool(rad0.any()) or bool(pix0.any())
                or (out0 is not None and int(out0.count) != 0)):
            raise AssertionError(f"compacted {vname}: empty queue emitted")
    log("  compacted kernel on an empty queue (count 0): nothing added, "
        "nothing appended, for every variant")
    # Two misses per pixel, a subnormal and a small normal radiance, in
    # either queue order: each pixel's sum equals the static layout's, the
    # subnormal kept (a float atomic add would flush it from the sum).
    p = 1 << 15
    pair = torch.from_numpy(paired_miss_lanes(p, seed=6)).to(dev)
    static = mega_round(sphere, pair, limits, False, False).radiance
    want = slot_order_sum(static, p)
    shows = int((want != static[p:]).any(dim=1).sum())
    for order in (torch.arange(2 * p, device=dev),
                  torch.arange(2 * p, device=dev).roll(p)):
        rad_pair = torch.zeros(p, 3, dtype=torch.float32, device=dev)
        mega_round_queue(sphere, queue(2 * p, 2 * p, pair[:, order],
                                       order.to(torch.int32)),
                         limits, False, False, rad_pair)
        if shows == 0 or not torch.equal(rad_pair, want):
            raise AssertionError("compacted kernel: a pixel's subnormal and "
                                 "normal misses sum differently")
    log(f"  compacted kernel, a subnormal and a normal miss at each of {p} "
        f"pixels, either queue order: sums equal the static layout's "
        f"({shows} pixels where the subnormal changes the sum)")

    # Three and four misses per pixel (subnormal, small and ordinary
    # radiance mixed: the float32 sum depends on the order), in four queue
    # orders, twice each: the kernel's sums equal the static layout's and
    # the plain version's bit for bit, on top of a radiance already there.
    p = 1 << 14
    for k in (3, 4):
        multi = torch.from_numpy(multi_miss_lanes(p, k, seed=8)).to(dev)
        static = mega_round(sphere, multi, limits, False, False).radiance
        want = slot_order_sum(static, p)
        back = slot_order_sum(static.reshape(k, p, 3).flip(0).reshape(-1, 3),
                              p)
        shows = int((back != want).any(dim=1).sum())
        m = k * p
        before = torch.rand(p, 3, generator=torch.Generator().manual_seed(k)
                            ).to(dev)
        orders = {"slot": torch.arange(m), "reversed": torch.arange(m).flip(0),
                  "rolled": torch.arange(m).roll(m // 3),
                  "shuffled": torch.randperm(
                      m, generator=torch.Generator().manual_seed(10 + k))}
        for oname, order in orders.items():
            order = order.to(dev)
            for fn in (mega_round_queue, mega_round_queue,
                       mega_round_queue_plain):
                rad_m = before.clone()
                fn(sphere, queue(m, m, multi[:, order], order.to(torch.int32)),
                   limits, False, False, rad_m)
                if shows == 0 or not torch.equal(rad_m, before + want):
                    raise AssertionError(
                        f"compacted round, {k} misses per pixel, queue order "
                        f"{oname}, {fn.__name__}: sums differ from the static "
                        "layout's")
        log(f"  compacted kernel (twice) and plain, {k} misses at each of {p} "
            f"pixels, queue orders {', '.join(orders)}: sums equal the static "
            f"layout's bit for bit ({shows} pixels where the reverse order "
            "sums differently)")
    # The fold kernel against its plain version on a random slab: rows the
    # mask does not name hold NaN and must not be read.
    fold_err, fold_n, fold_j = 0.0, 786_432, 4
    g = torch.Generator().manual_seed(11)
    fl = (torch.rand(fold_j * fold_n, 3, generator=g)
          * 10.0 ** torch.randint(-8, 1, (fold_j * fold_n, 1), generator=g)
          ).to(dev)
    fbits = (torch.rand(fold_j, fold_n, generator=g) < 0.1).to(dev)
    fmask = (fbits.to(torch.int32) << torch.arange(
        fold_j, dtype=torch.int32, device=dev)[:, None]).sum(
            dim=0, dtype=torch.int32)
    fslab = torch.where(fbits.reshape(-1, 1), fl,
                        torch.full_like(fl, float("nan")))
    fbefore = torch.rand(fold_n, 3, generator=g).to(dev)
    folded = []
    for fn in (fold_round_sums, fold_round_sums_plain):
        rad_f, msk = fbefore.clone(), fmask.clone()
        fn(fslab, msk, rad_f)
        torch.cuda.synchronize()
        if bool(msk.any()):
            raise AssertionError(f"{fn.__name__} left mask bits set")
        folded.append(rad_f)
    fold_err = float((folded[0] - folded[1]).abs().max())
    if not torch.equal(folded[0], folded[1]):
        raise AssertionError(f"fold kernel differs from plain: {fold_err}")

    def fold_time(fn, windows):
        """Mean ms of one fold on the card: a window per fold behind a
        spin kernel, the mask restored before the window opens."""
        msk = fmask.clone()
        ms = [device_ms(lambda: fn(fslab, msk, fbefore), dev,
                        setup=lambda: msk.copy_(fmask))
              for _ in range(windows + 1)]
        return sum(ms[1:]) / windows

    fold_ms = (fold_time(fold_round_sums, 20),
               fold_time(fold_round_sums_plain, 5))
    named, touched = int(fbits.sum()), int(fbits.any(dim=0).sum())
    fold_bound = bounds.fold_bound(fold_n, named, touched)
    log(f"  fold kernel vs plain, {fold_n} pixels x {fold_j} slots, {named} "
        f"rows named at {touched} pixels: equal True; kernel "
        f"{fold_ms[0]:.4f} ms, plain {fold_ms[1]:.4f} ms (one fold per "
        f"timed window, the mask restored outside it), bound "
        f"{fold_bound['bound_ms']:.4f} ms by {fold_bound['bound_by']} "
        f"[{card}]")

    round_launches = {"mega_round": 0, "mega_round_queue": 0,
                      "fold_round_sums": 0}
    wave = {}
    eager = get_backend("torch")  # the eager integrator: the plain wavefront
    for tag, sc, c in (("demo", demo, cfg), ("large", large, cfg_l)):
        frame = orbit_camera(0.01, c)
        npx = c.width * c.height
        rounds = c.max_refract_depth + 1
        o, d = generate_rays(frame, c.width, c.height, dev)
        for k in counters:
            k.launches = 0
        img, st = render_pixels_mega(sc, o, d, c, collect_stats=True)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in counters}
        folds = sum(wd > npx for wd in static_widths(c, npx))
        if got != {"fused_radiance": 0, "closest_hit": 0,
                   "env_contribution": 0, "mega_round": 0,
                   "mega_round_queue": rounds, "fold_round_sums": folds}:
            raise AssertionError(f"{tag}: launches {got}, want {rounds} "
                                 f"compacted round-kernel launches, {folds} "
                                 "fold launches and no other")
        round_launches["mega_round_queue"] += got["mega_round_queue"]
        round_launches["fold_round_sums"] += got["fold_round_sums"]
        rays = int(st["rays_traced"])
        if (tuple(img.shape) != (npx, 3) or not bool(torch.isfinite(img).all())
                or float(img.std()) == 0.0):
            raise AssertionError(f"{tag}: bad wavefront image")
        # The static-layout wavefront, counted on its own.
        for k in counters:
            k.launches = 0
        img_s, st_s = static_wavefront(sc, o, d, c, collect_stats=True)
        torch.cuda.synchronize()
        round_launches["mega_round"] += mega_round.launches
        if (mega_round.launches != rounds or mega_round_queue.launches != 0
                or fold_round_sums.launches != 0):
            raise AssertionError(f"{tag}: static wavefront launches "
                                 f"{mega_round.launches}")
        d_s = (img - img_s).abs()
        bit_equal = float((d_s == 0).all(dim=1).double().mean())
        wave_rmse = float(torch.sqrt(torch.mean(d_s.double() ** 2)))
        log(f"  {tag} compacted vs static-layout wavefront: rays_traced {rays}"
            f" vs {int(st_s['rays_traced'])}, pixel_rays equal "
            f"{bool(torch.equal(st['pixel_rays'], st_s['pixel_rays']))}, "
            f"slot_rounds {st['slot_rounds']}; image rmse {wave_rmse:.3e} "
            f"max abs {float(d_s.max()):.3e}, bit-equal pixels {bit_equal:.6f}"
            f" ({int((d_s != 0).any(dim=1).sum())} of {npx} differ)")
        if (rays != int(st_s["rays_traced"])
                or not torch.equal(st["pixel_rays"], st_s["pixel_rays"])
                or st["slot_rounds"] != sum(static_widths(c, npx))
                or not torch.equal(img, img_s)
                or not torch.equal(render_pixels_mega(sc, o, d, c), img)):
            raise AssertionError(f"{tag}: compacted and static wavefronts "
                                 "disagree")
        img = img.reshape(c.height, c.width, 3)
        scal = build_scalars(frame, c, sample_offsets(1), dev)
        check_image(f"{tag} wavefront vs frame kernel",
                    image_diff(np, img, fused_radiance(sc, scal, c)))
        stride = 1 if tag == "demo" else LARGE_STRIDE
        idx = torch.arange(0, npx, stride, device=dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        img_p, st_p = render_pixels(sc, o[idx], d[idx], c, eager.intersect,
                                    eager.env_contribution, collect_stats=True)
        e1.record()
        torch.cuda.synchronize()
        wave_plain_ms = e0.elapsed_time(e1)
        diff = image_diff(np, img.reshape(-1, 3)[idx], img_p)
        check_image(f"{tag} wavefront vs eager (every {stride}th pixel)", diff)
        rays_sub = rays if stride == 1 else int(render_pixels_mega(
            sc, o[idx], d[idx], c, collect_stats=True)[1]["rays_traced"])
        if rays_sub != int(st_p["rays_traced"]):
            raise AssertionError(f"{tag}: rays_traced {rays_sub} vs eager "
                                 f"{int(st_p['rays_traced'])}")
        if stride == 1 and not torch.equal(st["pixel_rays"],
                                           st_p["pixel_rays"]):
            raise AssertionError(f"{tag}: pixel_rays differ from the eager")
        live = count_live_rays(sc, c, frame, dev)
        if live != rays:
            raise AssertionError(f"{tag}: count_live_rays {live} vs {rays}")
        if tag == "demo":
            # No round may wait for the host: any synchronizing call raises.
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                render_pixels_mega(sc, o, d, c)
                render_pixels_mega(sc, o, d, c, collect_stats=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            log("  demo render_pixels_mega under set_sync_debug_mode('error'),"
                " collect_stats False and True: no host sync")
        wave_ms = cuda_ms(torch, lambda: render_pixels_mega(sc, o, d, c), 20)
        static_ms = cuda_ms(
            torch, lambda: static_wavefront(sc, o, d, c), 20)
        frame_k_ms = cuda_ms(torch, lambda: fused_radiance(sc, scal, c), 10)
        levels = frame_rows[tag]["levels"]
        rb = bounds.round_bound(sc, c, levels)
        wave[tag] = {"rays_traced": rays, "slot_rounds": st["slot_rounds"],
                     "wavefront_ms": wave_ms, "static_wavefront_ms": static_ms,
                     "frame_kernel_ms": frame_k_ms,
                     "plain_ms": wave_plain_ms,
                     "plain_pixels": int(idx.numel()),
                     "max_abs_err": max(diff["max_abs_err"],
                                        float(d_s.max())),
                     "bit_equal_share": bit_equal, "bound": rb,
                     "mrays_live": rays / frame_k_ms / 1e3}
        log(f"  {tag}: rays_traced {rays} (eager {int(st_p['rays_traced'])} "
            f"on {idx.numel()} pixels), slot_rounds {st['slot_rounds']}; "
            f"wavefront {wave_ms:.4f} ms (static layout {static_ms:.4f} ms), "
            f"frame kernel {frame_k_ms:.4f} ms, eager {wave_plain_ms:.1f} ms "
            f"on {idx.numel()} pixels [{card}]")
        log(f"  {tag}: wavefront bound {rb['bound_ms']:.4f} ms by "
            f"{rb['bound_by']} ({rb['bytes']} bytes, {rb['ops']} FP32 ops), "
            f"{rb['bound_ms'] / wave_ms:.1%} of it; the static layout's "
            f"bytes {rb['static_bytes']} ({rb['static_bound_ms']:.4f} ms) "
            f"[{card}]")
        log(f"  {tag}: live rays per frame {live} [{card}]")
        log(f"  {tag}: live Mrays/s {rays / frame_k_ms / 1e3:.1f} (live rays / "
            f"frame-kernel ms) [{card}]")
    log(f"  round-kernel launches on the wavefront path: compacted "
        f"{round_launches['mega_round_queue']} (fold "
        f"{round_launches['fold_round_sums']}); static layout "
        f"{round_launches['mega_round']}")
    for tag, (_, _, wd, ht, bounces, _) in zip(("demo", "large"), runs):
        c = cfg if tag == "demo" else cfg_l
        sc = demo if tag == "demo" else large
        rows = profile_rounds.profile_rounds(sc, c, orbit_camera(0.01, c), dev)
        if any(r["live"] > r["lanes"] for r in rows):
            raise AssertionError(f"{tag}: a queue count past its static "
                                 f"width: {rows}")
        rc = profile_rounds.main([
            "--scene", paths[tag][0], "--envmap", paths[tag][1],
            "--width", str(wd), "--height", str(ht), "--bounces", str(bounces),
            "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"profile_rounds {tag}: rc {rc}")
    # --- phase 7: the traversal instruments ------------------------------
    log("phase 7: instrument kernels (mtbench, stallbench) vs plain; their CLIs")
    instruments = (mt_visits, woop_visits, woop_visits_tc, woop_visits_tc3,
                   stall_iters)
    for k in instruments:
        k.launches = 0
    made = {k.__name__: 0 for k in instruments}
    inp = make_inputs(0)
    mix = np.random.default_rng(7).choice(np.float32([-1.0, 1.0]), 1024)
    mt_err = {"mt_visits": 0.0, "woop_visits": 0.0, "woop_visits_tc": 0.0,
              "woop_visits_tc3": 0.0}
    tc_exact = {"woop_visits_tc": [], "woop_visits_tc3": []}
    for cname, cull in (("tool's +1", None), ("+-1 mix", mix)):
        args = {"mt_visits": mt_args(inp, dev, cull),
                "woop_visits": woop_args(inp, dev, cull)}
        for v in (64, 70):
            for fn, plain in ((mt_visits, mt_visits_plain),
                              (woop_visits, woop_visits_plain)):
                tk, ik = fn(*args[fn.__name__], v)
                made[fn.__name__] += 1
                tp, ip = plain(*args[fn.__name__], v)
                torch.cuda.synchronize()
                err = float((tk - tp).abs().max())
                mt_err[fn.__name__] = max(mt_err[fn.__name__], err)
                exact = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
                log(f"  {fn.__name__} cull {cname} V={v}: equal to plain "
                    f"{exact} (t max abs err {err:.3e}), hits "
                    f"{float((tk < 1e29).float().mean()):.4f}")
                if not exact:
                    raise AssertionError(f"{fn.__name__} V={v} differs")
        # The tensor-core Woop kernel against its plain version: the mma
        # adds its products in an order of its own, so to a tolerance.
        for fn, passes in ((woop_visits_tc, 1), (woop_visits_tc3, 3)):
            for v in (8, 70, mxu_mt_bench.DEFAULT_V):
                got = fn(*args["woop_visits"], v)
                made[fn.__name__] += 1
                ref = woop_visits_tc_plain(*args["woop_visits"], v, passes)
                torch.cuda.synchronize()
                agree = tc_agreement(got, ref)
                both = (got[0] < 1e29) & (ref[0] < 1e29) & (got[1] == ref[1])
                mt_err[fn.__name__] = max(
                    mt_err[fn.__name__],
                    float((got[0] - ref[0]).abs()[both].max()))
                tc_exact[fn.__name__].append(agree["exact"])
                log(f"  {fn.__name__} cull {cname} V={v}: vs plain, rays "
                    f"equal exactly {agree['exact']:.4f}, same winner "
                    f"{agree['same_i']:.4f} (bar {1 - TC_MISMATCH_SHARE:g}), "
                    f"t rel err {agree['t_rel']:.2e} (bar {TC_T_RTOL:g})")
                if not agree["ok"]:
                    raise AssertionError(f"{fn.__name__} V={v}: {agree}")
        mt_out = mt_visits(*args["mt_visits"], mxu_mt_bench.DEFAULT_V)
        made["mt_visits"] += 1
        for fn in (woop_visits, woop_visits_tc, woop_visits_tc3):
            par = mxu_mt_bench.parity(
                mt_out, fn(*args["woop_visits"], mxu_mt_bench.DEFAULT_V))
            made[fn.__name__] += 1
            log(f"  MT vs {fn.__name__} kernel, cull {cname}, "
                f"V={mxu_mt_bench.DEFAULT_V}: {par}")
            # One TF32 pass is not held to the tool's bar: its error is
            # the finding (PERF.md).
            if fn is not woop_visits_tc and not (
                    par["hits_mt"] == par["hits_woop"] > 0
                    and par["i_match"] >= 0.999 and par["t_match"] == 1.0):
                raise AssertionError(f"MT and {fn.__name__} disagree")
    sm = torch.arange(1024, dtype=torch.float32, device=dev)
    x1 = torch.ones(8, 128, dtype=torch.float32, device=dev)
    # The tool's all-ones carry, and one whose elements differ: only there
    # does an OR over part of the block, or a misplaced output, show.
    carries = {"ones": x1, "mixed": torch.from_numpy(mixed_carry(0)).to(dev)}
    stall_err = 0.0
    for variant in STALL_VARIANTS:
        for n_iter in (64, 70):
            for cname, x in carries.items():
                got = stall_iters(variant, n_iter, sm, x)
                made["stall_iters"] += 1
                ref = stall_iters_plain(variant, n_iter, sm, x)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                stall_err = max(stall_err, err)
                if not torch.equal(got, ref):
                    raise AssertionError(f"stall {variant} n_iter {n_iter} "
                                         f"carry {cname}: max abs err {err}")
    log(f"  stall_iters equal to plain for {', '.join(STALL_VARIANTS)} at "
        f"n_iter 64 and 70, carries {' and '.join(carries)} (max abs err "
        f"{stall_err:.3e})")
    got = {k.__name__: k.launches for k in instruments}
    if got != made:
        raise AssertionError(f"phase 7 checks: launches {got}, made {made}")
    # Kernel and plain times at the same shapes.
    mt_a, woop_a = mt_args(inp, dev), woop_args(inp, dev)
    vt = mxu_mt_bench.DEFAULT_V
    mt_t = {"mt_visits": (cuda_ms(torch, lambda: mt_visits(*mt_a, vt), 20),
                          cuda_ms(torch, lambda: mt_visits_plain(*mt_a, vt), 1)),
            "woop_visits": (
                cuda_ms(torch, lambda: woop_visits(*woop_a, vt), 20),
                cuda_ms(torch, lambda: woop_visits_plain(*woop_a, vt), 1)),
            "woop_visits_tc": (
                cuda_ms(torch, lambda: woop_visits_tc(*woop_a, vt), 20),
                cuda_ms(torch, lambda: woop_visits_tc_plain(
                    *woop_a, vt, 1), 1)),
            "woop_visits_tc3": (
                cuda_ms(torch, lambda: woop_visits_tc3(*woop_a, vt), 20),
                cuda_ms(torch, lambda: woop_visits_tc_plain(
                    *woop_a, vt, 3), 1))}
    stall_t = [sum(cuda_ms(torch, lambda v=v: fn(v, 64, sm, x1), reps)
                   for v in STALL_VARIANTS)
               for fn, reps in ((stall_iters, 20), (stall_iters_plain, 1))]
    sm_clock = bounds.max_sm_clock_hz(dev)
    log(f"  max SM clock {sm_clock / 1e6:.0f} MHz (nvidia-smi clocks.max.sm):"
        " the stall bounds' latency floor at 4 cycles per dependent FP32 "
        "operation")
    log(f"  V={vt}: MT kernel {mt_t['mt_visits'][0]:.4f} ms, plain "
        f"{mt_t['mt_visits'][1]:.1f} ms; Woop kernel "
        f"{mt_t['woop_visits'][0]:.4f} ms, plain {mt_t['woop_visits'][1]:.1f} "
        f"ms; Woop on tensor cores, TF32 {mt_t['woop_visits_tc'][0]:.4f} ms, "
        f"plain {mt_t['woop_visits_tc'][1]:.1f} ms, 3xTF32 "
        f"{mt_t['woop_visits_tc3'][0]:.4f} ms, plain "
        f"{mt_t['woop_visits_tc3'][1]:.1f} ms; the six stall variants at n_iter 64: kernels {stall_t[0]:.4f} "
        f"ms, plain {stall_t[1]:.1f} ms [{card}]")
    for k in instruments:
        k.launches = 0
    stall_out = io.StringIO()
    if mxu_mt_bench.main([]) != 0:
        raise AssertionError("mxu_mt_bench failed")
    with contextlib.redirect_stdout(stall_out):
        rc = stallbench.main([])
    instr_launches = {k.__name__: k.launches for k in instruments}
    print(stall_out.getvalue(), end="", flush=True)
    stall_ns = {}
    for line in stall_out.getvalue().splitlines()[1:]:
        m = re.fullmatch(r" *(\w+): +([\d.]+) ns/iter  \(bound ([\d.]+) "
                         r"ns/iter by (\w+)\)", line)
        if m:
            stall_ns[m.group(1)] = {"ns_per_iter": float(m.group(2)),
                                    "bound_ns_per_iter": float(m.group(3)),
                                    "bound_by": m.group(4)}
    if rc != 0 or list(stall_ns) != list(STALL_VARIANTS):
        raise AssertionError(f"stallbench: rc {rc}, lines {stall_ns}")
    per_kernel = mxu_mt_bench.launches_per_kernel(mxu_mt_bench.DEFAULT_REPS)
    want = {"mt_visits": per_kernel, "woop_visits": per_kernel,
            "woop_visits_tc": per_kernel, "woop_visits_tc3": per_kernel,
            "stall_iters": len(STALL_VARIANTS) * (1 + stallbench.REPS)}
    log(f"  launches during the CLIs: {instr_launches}")
    if instr_launches != want:
        raise AssertionError(f"CLI launches {instr_launches}, want {want}")

    # --- phase 8: the CLI flags on CUDA ---------------------------------
    log("phase 8: the modular path; CLI flags (--backend torch, --instances, "
        "--accumulate/--resume, --heatmap, --serve)")
    def drive(argv, want_launches):
        """Run the CLI with every count set to 0 just before; the counts
        just after must equal ``want_launches`` (kernels not named: 0)."""
        for k in counters:
            k.launches = 0
        rc = cli.main(argv)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in counters}
        want = {k.__name__: want_launches.get(k.__name__, 0)
                for k in counters}
        if rc != 0 or got != want:
            raise AssertionError(f"{argv}: rc {rc}, launches {got}, want "
                                 f"{want}")
        return got

    # The modular path: the eager integrator over the closest-hit and env
    # kernels, one launch of each per bounce level.
    cfg_m = cfg.replace(width=256, height=192)
    frame_m = orbit_camera(0.01, cfg_m)
    modular = make_renderer(cfg_m, "cuda", dev, use_mega=False)
    for k in counters:
        k.launches = 0
    img_m = modular(demo, frame_m)
    torch.cuda.synchronize()
    modular_launches = {k.__name__: k.launches for k in counters}
    levels_m = cfg_m.max_refract_depth + 1
    if modular_launches != {"fused_radiance": 0, "closest_hit": levels_m,
                            "env_contribution": levels_m, "mega_round": 0,
                            "mega_round_queue": 0, "fold_round_sums": 0}:
        raise AssertionError(f"modular path launches {modular_launches}")
    if (tuple(img_m.shape) != (192, 256, 3)
            or not bool(torch.isfinite(img_m).all())):
        raise AssertionError("modular path: bad image")
    modular_diff = image_diff(np, img_m, make_renderer(cfg_m, "torch", dev)(
        demo, frame_m))
    check_image("modular path 256x192 vs plain (brute force on the card)",
                modular_diff)
    check_image("modular path 256x192 vs frame kernel", image_diff(
        np, img_m, make_renderer(cfg_m, "cuda", dev)(demo, frame_m)))
    modular_demo = make_renderer(cfg, "cuda", dev, use_mega=False)
    frame_d = orbit_camera(0.01, cfg)
    modular_ms = [cuda_ms(torch, lambda: modular_demo(demo, frame_d), 1)
                  for _ in range(3)]
    log(f"  modular path: launches {modular_launches}; demo 1024x768 5/2 "
        f"frame {[round(m, 3) for m in modular_ms]} ms (three single "
        f"frames, host included) [{card}]")
    # --backend torch on CUDA: the eager brute force, no kernel launch.
    torch_png = os.path.join(tmp, "torch", "frame.png")
    drive(["--scene", paths["demo"][0], "--envmap", paths["demo"][1],
           "--width", "64", "--height", "48", "--bounces", "5", "--frames",
           "1", "--backend", "torch", "--out", torch_png, "--device", "cuda"],
          {})
    cfg_t = cfg.replace(width=64, height=48)
    want_t = cli.to_u8(make_renderer(cfg_t, "torch", dev)(
        demo, orbit_camera(0.01, cfg_t))).cpu().numpy()
    if not np.array_equal(load_png(torch_png), want_t):
        raise AssertionError("--backend torch: the PNG differs from the "
                             "eager render")
    log("  --backend torch --device cuda at 64x48: no kernel launch, the PNG "
        "equal to the eager render's")

    env_path = paths["demo"][1]
    # --instances: three instances, the third with mask 0 (dropped).
    inst_dir = os.path.join(tmp, "instances")
    os.makedirs(inst_dir)
    ball, box = (os.path.join(inst_dir, f) for f in ("ball.obj", "box.obj"))
    write_obj(ball, make_icosphere(3, 0.9))
    write_obj(box, make_cube(1.2))
    spec = os.path.join(inst_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump([{"obj": ball, "translate": [-1.1, 0.0, 0.0]},
                   {"obj": box, "translate": [1.2, 0.0, 0.0],
                    "rotate_y_deg": 30.0},
                   {"obj": box, "translate": [0.0, 1.6, 0.0], "mask": 0}], f)
    walked = fused_radiance.walks["instances"]
    drive(["--instances", spec, "--envmap", env_path, "--width", "1024",
           "--height", "768", "--bounces", "5", "--frames", "4", "--out",
           os.path.join(inst_dir, "frame.png"), "--raw", "--device", "cuda"],
          {"fused_radiance": 4})
    for i in range(4):
        raw = np.load(os.path.join(inst_dir, f"frame_{i:04d}.npy"))
        if (raw.shape != (768, 1024, 3) or not np.isfinite(raw).all()
                or float(raw.std()) == 0.0):
            raise AssertionError(f"instanced frame {i}: bad image")
    cfg_i = RenderConfig(width=256, height=192, max_refract_depth=5,
                         envmap_path=env_path)
    inst_np, inst_meta = load_instanced(spec, cfg_i)
    want_tris = make_icosphere(3, 0.9).num_tris + 12
    if inst_meta.num_real_tris != want_tris:
        raise AssertionError(f"instanced tris {inst_meta.num_real_tris}, "
                             f"want {want_tris} (mask-0 instance dropped)")
    inst = scene_from_jax(inst_np, dev)
    frame_i = orbit_camera(0.3, cfg_i)
    img_k = fused_radiance(inst, build_scalars(frame_i, cfg_i,
                                               sample_offsets(1), dev), cfg_i)
    if fused_radiance.walks["instances"] != walked + 5:
        raise AssertionError("--instances: the frame kernel did not take "
                             "the instance walk on every frame")
    o, d = generate_rays(frame_i, 256, 192, dev)
    cuda_be = get_backend("cuda")
    for k in counters:
        k.launches = 0
    img_e = render_pixels(inst.baked(), o, d, cfg_i, cuda_be.intersect,
                          cuda_be.env_contribution)
    torch.cuda.synchronize()
    eager_launches = {k.__name__: k.launches for k in counters}
    rounds = cfg_i.max_refract_depth + 1
    if eager_launches != {"fused_radiance": 0, "closest_hit": rounds,
                          "env_contribution": rounds, "mega_round": 0,
                          "mega_round_queue": 0, "fold_round_sums": 0}:
        raise AssertionError(f"eager instanced render: {eager_launches}")
    inst_diff = image_diff(np, img_k, img_e.reshape(192, 256, 3))
    check_image("instanced 256x192 frame kernel (instance walk) vs eager "
                "integrator over the bake (cuda backend)", inst_diff)
    log(f"  --instances: {inst_meta.num_real_tris} tris from 2 of 3 "
        f"instances, 4 frames at 1024x768; eager launches {eager_launches}")
    check_rtiow_glass(dev, counters)

    # --accumulate, then --resume: 4 + 2 frames of the demo orbit.
    acc_dir = os.path.join(tmp, "acc")
    base_args = ["--scene", paths["demo"][0], "--envmap", env_path,
                 "--width", "1024", "--height", "768", "--bounces", "5",
                 "--accumulate", "--raw", "--device", "cuda"]
    angles = [0.01]
    for _ in range(5):
        angles.append(angles[-1] + cfg.orbit_speed)
    drive(base_args + ["--frames", "4", "--out",
                       os.path.join(acc_dir, "a.png")], {"fused_radiance": 4})
    drive(base_args + ["--frames", "2", "--angle", repr(angles[4]),
                       "--resume", os.path.join(acc_dir, "a_state.npz"),
                       "--out", os.path.join(acc_dir, "b.png")],
          {"fused_radiance": 2})
    state = np.load(os.path.join(acc_dir, "b_state.npz"))
    singles = np.mean([fused_radiance(demo, build_scalars(
        orbit_camera(a, cfg), cfg, sample_offsets(1), dev), cfg).cpu().numpy()
        for a in angles], axis=0, dtype=np.float64)
    acc_err = float(np.abs(np.load(os.path.join(acc_dir, "b.npy"))
                           - singles).max())
    log(f"  --accumulate 4 + --resume 2: count {int(state['count'])}, image "
        f"vs the mean of 6 single frames max abs err {acc_err:.3e}")
    if int(state["count"]) != 6 or acc_err > 1e-6:
        raise AssertionError("accumulation disagrees")

    # --heatmap at the demo shape: one round-kernel launch per bounce round.
    heat_png = os.path.join(tmp, "heat.png")
    drive(["--scene", paths["demo"][0], "--envmap", env_path, "--width",
           "1024", "--height", "768", "--bounces", "5", "--heatmap", heat_png,
           "--device", "cuda"],
          {"mega_round_queue": cfg.max_refract_depth + 1,
           "fold_round_sums": sum(
               wd > 1024 * 768 for wd in static_widths(cfg, 1024 * 768))})
    frame = orbit_camera(0.01, cfg)
    counts = render_heatmap(demo, cfg, frame, dev)
    live = count_live_rays(demo, cfg, frame, dev)
    o, d = generate_rays(frame, 1024, 768, dev)
    idx = torch.arange(0, 1024 * 768, LARGE_STRIDE, device=dev)
    _, st_p = render_pixels(demo, o[idx], d[idx], cfg, eager.intersect,
                            eager.env_contribution, collect_stats=True)
    strided_equal = bool(np.array_equal(
        counts.reshape(-1)[idx.cpu().numpy()], st_p["pixel_rays"].cpu().numpy()))
    log(f"  --heatmap: counts sum {int(counts.sum())} (count_live_rays "
        f"{live}), max {int(counts.max())} rays/pixel; equal to the eager "
        f"integrator's pixel_rays on every {LARGE_STRIDE}th pixel: "
        f"{strided_equal}")
    if (int(counts.sum()) != live or not strided_equal
            or load_png(heat_png).shape != (768, 1024, 3)):
        raise AssertionError("heatmap disagrees")

    # --serve 0 --frames 3 in a thread; one GET of /frame over loopback.
    served = serve_one_frame(drive, 3, [
        "--scene", paths["demo"][0], "--envmap", env_path, "--width", "256",
        "--height", "192", "--bounces", "5", "--frames", "3", "--serve", "0",
        "--out", os.path.join(tmp, "live", "frame.png"), "--device", "cuda"])
    if served.shape != (192, 256, 3):
        raise AssertionError(f"served frame shape {served.shape}")
    log(f"  --serve: GET /frame over 127.0.0.1 returned a PNG of shape "
        f"{served.shape}")

    # --- phase 9: multi-device rendering on one card; the LBVH oracle ----
    log("phase 9: sharded renderers on [cuda:0] * k (pixel-DP, sample-SP, "
        "tri-TP); the LBVH oracle; --devices")
    tile_counters = counters + (frame_tiles,)

    def zero_counts():
        for k in tile_counters:
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k.__name__: k.launches for k in tile_counters}

    def only(**want):
        return {k.__name__: want.get(k.__name__, 0) for k in tile_counters}

    pixel_dp = {}  # cell -> {"single": ..., k: ...}
    dp_launches = 0
    for tag, sc, c in (("demo", demo, cfg), ("large", large, cfg_l)):
        frame = orbit_camera(0.01, c)
        scal = build_scalars(frame, c, sample_offsets(1), dev)
        single = fused_radiance(sc, scal, c)
        n_tiles = tile_grid(c)[1]
        cell = {"single": {
            "ms": cuda_ms(torch, lambda: fused_radiance(sc, scal, c), 10),
            "card_ms": card_ms(lambda: fused_radiance(sc, scal, c), 10, dev),
            "tiles": n_tiles, "blocks": n_tiles * 8}}
        for k in (2, 3, 4):
            render = make_fused_sharded_renderer(c, [dev] * k)
            zero_counts()
            img = render(sc, frame)
            got = read_counts()
            if got != only(frame_tiles=k) or not torch.equal(img, single):
                raise AssertionError(
                    f"{tag} pixel-DP over {k} shards: launches {got}, "
                    f"bit-equal {torch.equal(img, single)}")
            dp_launches += got["frame_tiles"]
            n_local = -(-n_tiles // k)

            parts = [frame_tiles(sc, scal, c, k, b, n_local, n_tiles)
                     for b in range(k)]

            def shards(k=k, n_local=n_local):
                for b in range(k):
                    frame_tiles(sc, scal, c, k, b, n_local, n_tiles)

            # The card's times: the k launches, and the reassembly (both
            # behind a spin kernel); the frame back to back, host included
            # (its scalar upload from pageable memory waits for the card,
            # so a spin kernel cannot hide the host there).
            cell[k] = {"ms": cuda_ms(torch, lambda: render(sc, frame), 10),
                       "tiles_card_ms": card_ms(shards, 10, dev),
                       "assemble_card_ms": card_ms(
                           lambda: assemble_tiles(parts, c, dev), 10, dev),
                       "n_local": n_local, "blocks_per_launch": n_local * 8}
            r = cell[k]
            log(f"  {tag} {c.width}x{c.height} pixel-DP over {k} shards: "
                f"bit-equal to the single launch, frame_tiles launches {k}, "
                f"{n_local} tiles ({n_local * 8} blocks) a launch; card: the "
                f"{k} launches {r['tiles_card_ms']:.4f} ms + reassembly "
                f"{r['assemble_card_ms']:.4f} ms vs the single launch "
                f"{cell['single']['card_ms']:.4f} ms; frame back to back "
                f"(host included) {r['ms']:.4f} ms vs {cell['single']['ms']:.4f}"
                f" ms [{card}]")
        # One-tile launches: a launch cannot end before its slowest block.
        tiles_x = tile_grid(c)[0]
        ids = (range(n_tiles) if tag == "demo" else
               (0, (n_tiles // tiles_x // 2) * tiles_x + tiles_x // 2))

        def one_tile(t):
            return device_ms(lambda: frame_tiles(sc, scal, c, n_tiles, t, 1,
                                                 n_tiles), dev)

        one = {t: one_tile(t) for t in ids}
        # One window can be noisy: the 8 slowest tiles take the best of 5.
        for t in sorted(one, key=one.get)[-8:]:
            one[t] = min(one[t], *(one_tile(t) for _ in range(4)))
        slow = max(one, key=one.get)
        cell["one_tile_ms"] = {"max": one[slow], "max_tile": slow,
                               "median": float(np.median(list(one.values()))),
                               "tile_0": one[0]}
        log(f"  {tag}: one-tile launches over {len(one)} tiles (the 8 "
            f"slowest best of 5): slowest "
            f"{one[slow]:.4f} ms (tile {slow}), median "
            f"{cell['one_tile_ms']['median']:.4f} ms, tile 0 {one[0]:.4f} ms "
            f"(the card's time) [{card}]")
        pixel_dp[tag] = cell

    # frame_tiles against its plain version: shards 0 and 1 of 3 at 256x192,
    # then the 4 shards of the demo frame, which the kernels line reports
    # (its error and its times come from the same inputs).
    cfg_s = cfg.replace(width=256, height=192)
    frame_s = orbit_camera(0.01, cfg_s)
    scal_s = build_scalars(frame_s, cfg_s, sample_offsets(1), dev)
    n_ts = tile_grid(cfg_s)[1]
    for b in (0, 1):
        check_image(f"frame_tiles shard {b} of 3, 256x192, vs plain",
                    image_diff(np, frame_tiles(demo, scal_s, cfg_s, 3, b, 16,
                                               n_ts),
                               frame_tiles_plain(demo, scal_s, cfg_s, 3, b, 16,
                                                 n_ts)))
    n_td = tile_grid(cfg)[1]
    n_ld = -(-n_td // 4)
    scal_d = build_scalars(orbit_camera(0.01, cfg), cfg, sample_offsets(1),
                           dev)
    plain_d = []
    tiles_plain_ms = time_ms(lambda: plain_d.extend(
        frame_tiles_plain(demo, scal_d, cfg, 4, b, n_ld, n_td)
        for b in range(4)), dev)
    tiles_err = 0.0
    for b, want in enumerate(plain_d):
        got = frame_tiles(demo, scal_d, cfg, 4, b, n_ld, n_td)
        diff = image_diff(np, got, want)
        check_image(f"frame_tiles shard {b} of 4, demo 1024x768, vs plain",
                    diff)
        tiles_err = max(tiles_err, diff["max_abs_err"])
    log(f"  frame_tiles plain, the 4 shards of the demo frame: "
        f"{tiles_plain_ms:.1f} ms; max abs err of the kernel's shards "
        f"{tiles_err:.3e}")

    # Wavefront pixel-DP on the "cuda" backend, 2 shards, at the demo.
    frame_d = orbit_camera(0.01, cfg)
    o, d = generate_rays(frame_d, cfg.width, cfg.height, dev)
    one = render_pixels_mega(demo, o, d, cfg).reshape(cfg.height, cfg.width,
                                                      3)
    wave2 = make_sharded_renderer(cfg, [dev] * 2, "cuda")
    zero_counts()
    two = wave2(demo, frame_d)
    got = read_counts()
    rounds = cfg.max_refract_depth + 1
    folds = sum(wd > 512 * 768 for wd in static_widths(cfg, 512 * 768))
    if got != only(mega_round_queue=2 * rounds, fold_round_sums=2 * folds):
        raise AssertionError(f"wavefront pixel-DP launches {got}")
    d_w = (two - one).abs()
    wave1 = make_sharded_renderer(cfg, [dev], "cuda")
    log(f"  demo wavefront pixel-DP over 2 shards: launches {got}; bit-equal "
        f"pixels {float((d_w == 0).all(dim=-1).double().mean()):.6f}; back "
        f"to back, host included: 2 shards "
        f"{cuda_ms(torch, lambda: wave2(demo, frame_d), 10):.4f} ms, 1 shard "
        f"{cuda_ms(torch, lambda: wave1(demo, frame_d), 10):.4f} ms (both "
        f"make the frame's rays), render_pixels_mega on given rays "
        f"{cuda_ms(torch, lambda: render_pixels_mega(demo, o, d, cfg), 10):.4f}"
        f" ms [{card}]")
    if not torch.equal(two, one):
        raise AssertionError("wavefront pixel-DP differs from one shard")

    # Sample-SP: a 2x2 (samples, pixels) grid at spp 4 against one device.
    cfg_4 = cfg.replace(spp=4)
    single4 = make_sharded_renderer(cfg_4, [dev], "cuda")(demo, frame_d)
    ssp = make_sample_sharded_renderer(cfg_4, [[dev, dev], [dev, dev]],
                                       "cuda")(demo, frame_d)
    ssp_rmse = float(torch.sqrt(torch.mean((ssp - single4).double() ** 2)))
    log(f"  demo sample-SP 2x2 at spp 4 vs one device: rmse {ssp_rmse:.3e} "
        f"(bar 1e-6), bit-equal {torch.equal(ssp, single4)}")
    if ssp_rmse >= 1e-6:
        raise AssertionError("sample-SP disagrees")

    # Tri-TP: 2 shards of the demo scene's triangles, 2^14 rays.
    rng_t = np.random.default_rng(14)
    o_t = torch.from_numpy(rng_t.uniform(-3, 3, (2 ** 14, 3)).astype(
        np.float32)).to(dev)
    d_t = torch.from_numpy(rng_t.normal(size=(2 ** 14, 3)).astype(
        np.float32)).to(dev)
    d_t = d_t / torch.linalg.norm(d_t, dim=1, keepdim=True)
    wf_t = torch.from_numpy(rng_t.random(2 ** 14) < 0.5).to(dev)
    al_t = torch.ones_like(wf_t)
    ref_t = torch_intersect(demo, o_t, d_t, wf_t, al_t, 1e-4, 100.0)
    tri_t = make_trisharded_intersect([dev] * 2)(demo, o_t, d_t, wf_t, al_t,
                                                 1e-4, 100.0)
    h_t = ref_t[0]
    same = (torch.equal(tri_t[0], h_t) and torch.equal(tri_t[2][h_t],
                                                       ref_t[2][h_t])
            and torch.equal(tri_t[1][h_t], ref_t[1][h_t]))
    log(f"  tri-TP over 2 shards, 2^14 rays x {demo.num_tris} tris: hits "
        f"{int(h_t.sum())}, winners and t equal to the brute force {same}")
    if not same:
        raise AssertionError("tri-TP disagrees with the brute force")

    # The LBVH oracle: build times, 2^16 rays, a 256x192 frame.
    lbvh_ms = {}
    for tag, sc in (("demo", demo), ("large", large)):
        lbvh_from_scene(sc)
        lbvh_ms[f"build_{tag}"] = min(time_ms(lambda: lbvh_from_scene(sc), dev)
                                      for _ in range(3))
    bvh = lbvh_from_scene(demo)
    wf_l = torch.from_numpy(np.random.default_rng(16).random(
        o_np.shape[0]) < 0.5).to(dev)
    o_l, d_l = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    ref_l = torch_intersect(demo, o_l, d_l, wf_l, torch.ones_like(wf_l), 1e-4,
                            100.0)
    lb = lbvh_intersect(bvh, o_l, d_l, wf_l, 1e-4, 100.0)
    lbvh_ms["intersect_2^16"] = time_ms(
        lambda: lbvh_intersect(bvh, o_l, d_l, wf_l, 1e-4, 100.0), dev)
    h_l = ref_l[0]
    t_err = float((lb[1] - ref_l[1])[h_l].abs().max())
    i_agree = float((lb[2] == ref_l[2])[h_l].double().mean())
    log(f"  LBVH: build {lbvh_ms['build_demo']:.2f} ms at {demo.num_tris} "
        f"tris, {lbvh_ms['build_large']:.2f} ms at {large.num_tris}; "
        f"lbvh_intersect 2^16 rays {lbvh_ms['intersect_2^16']:.1f} ms: hits "
        f"equal {torch.equal(lb[0], h_l)}, t max abs err {t_err:.2e} (bar "
        f"1e-5), winners equal on {i_agree:.6f} of hits (bar 0.999) [{card}]")
    if not torch.equal(lb[0], h_l) or t_err > 1e-5 or i_agree < 0.999:
        raise AssertionError("lbvh_intersect disagrees with the brute force")
    lbvh_be = make_lbvh_backend(demo)
    img_l = render_image(demo, frame_s, cfg_s, sample_offsets(1), dev,
                         lbvh_be, env_contribution_plain)
    lbvh_ms["frame_256x192"] = time_ms(lambda: render_image(
        demo, frame_s, cfg_s, sample_offsets(1), dev, lbvh_be,
        env_contribution_plain), dev)
    check_image("LBVH backend 256x192 vs frame kernel", image_diff(
        np, img_l, fused_radiance(demo, scal_s, cfg_s)))
    log(f"  LBVH backend frame 256x192 5/2: {lbvh_ms['frame_256x192']:.1f} ms "
        f"[{card}]")

    # --devices: two asked of one card is a usage error; one renders.
    err = io.StringIO()
    dev_args = ["--scene", paths["demo"][0], "--envmap", env_path, "--width",
                "1024", "--height", "768", "--bounces", "5", "--frames", "1",
                "--out", os.path.join(tmp, "devices", "f.png"), "--device",
                "cuda"]
    with contextlib.redirect_stderr(err):
        try:
            rc = cli.main(dev_args + ["--devices", "2"])
        except SystemExit as e:
            rc = e.code
    log(f"  --devices 2 on {torch.cuda.device_count()} card(s): exit {rc}, "
        f"{err.getvalue().strip().splitlines()[-1]!r}")
    if rc != 2 or "visible: cuda:0" not in err.getvalue():
        raise AssertionError("--devices 2 on one card must exit 2")
    frame_tiles.launches = 0
    drive(dev_args + ["--devices", "1"], {"fused_radiance": 1})
    if frame_tiles.launches:
        raise AssertionError("--devices 1 launched frame_tiles")
    log("  --devices 1: one frame-kernel launch, as without the flag")

    # --- phase 10: multi-process rendering on the one card ---------------
    log("phase 10: python -m refraction_tpu_torch.parallel.distributed, two "
        "ranks on cuda:0 over gloo (frame sharding, then pixel-DP)")
    cfg_m = RenderConfig(width=1024, height=768, cluster_size=128,
                         scene_path=paths["demo"][0],
                         envmap_path=paths["demo"][1])
    if demo.cluster_size != 128:
        raise AssertionError(f"demo scene: clusters of {demo.cluster_size}")
    render_m = make_renderer(cfg_m, "cuda", dev)
    angles = [0.01 + 0.01 * k for k in range(DIST_FRAMES)]
    ref_sum = sum(float(render_m(demo, orbit_camera(a, cfg_m)).cpu().numpy()
                        .mean()) for a in angles)
    ref_sha = hashlib.sha256(render_m(demo, orbit_camera(0.35, cfg_m)).cpu()
                             .numpy().tobytes()).hexdigest()
    out_m = os.path.join(tmp, "distributed")
    frames_m = run_ranks(os.path.join(tmp, "ranks_frames"), [
        "--scene", paths["demo"][0], "--envmap", paths["demo"][1],
        "--width", "1024", "--height", "768", "--frames", str(DIST_FRAMES)],
        out_m)
    s0, s1 = (r["stats"] for r in frames_m)
    names = sorted(n for r in range(2) if os.path.isdir(f"{out_m}{r}")
                   for n in os.listdir(f"{out_m}{r}"))
    global_sum = s0["checksum_global"]
    frames_ok = (
        s0["frames_rendered_global"] == s1["frames_rendered_global"]
        == DIST_FRAMES
        and s0["frames_rendered_local"] + s1["frames_rendered_local"]
        == DIST_FRAMES
        and global_sum == s1["checksum_global"]
        and abs(global_sum - (s0["checksum_local"] + s1["checksum_local"]))
        <= DIST_RTOL * abs(global_sum)
        and abs(global_sum - ref_sum) <= DIST_RTOL * abs(ref_sum)
        and names == [f"frame_{k:04d}.png" for k in range(DIST_FRAMES)]
        and all(r["stats"]["launches"] == {
            "fused_radiance": r["stats"]["frames_rendered_local"],
            "frame_tiles": 0} for r in frames_m))
    log(f"  frame sharding, {DIST_FRAMES} demo frames 1024x768 5/2 over 2 "
        f"ranks: global checksum {global_sum!r} on both, locals "
        f"{s0['checksum_local']!r} + {s1['checksum_local']!r}; one process's "
        f"make_renderer(cfg, 'cuda', cuda:0) over the same angles "
        f"{ref_sum!r} (rel {abs(global_sum - ref_sum) / ref_sum:.2e}, bar "
        f"{DIST_RTOL:g}); PNGs {len(names)}; launches "
        f"{[r['stats']['launches'] for r in frames_m]}")
    dp_m = run_ranks(os.path.join(tmp, "ranks_dp"), [
        "--scene", paths["demo"][0], "--envmap", paths["demo"][1],
        "--width", "1024", "--height", "768", "--fused-dp"])
    d0, d1 = (r["stats"] for r in dp_m)
    dp_ok = (d0["devices_global"] == d1["devices_global"] == 2
             and d0["sha256"] == d1["sha256"] == ref_sha
             and d0["matches_single_device"] and d1["matches_single_device"]
             and all(r["stats"]["launches"] == {"fused_radiance": 1,
                                                "frame_tiles": 1}
                     for r in dp_m))
    log(f"  pixel-DP, one demo frame over 2 ranks: sha256 {d0['sha256'][:16]}"
        f" / {d1['sha256'][:16]}, rt_frame's here {ref_sha[:16]}; "
        f"matches_single_device {d0['matches_single_device']}, "
        f"{d1['matches_single_device']}; launches "
        f"{[r['stats']['launches'] for r in dp_m]}")
    for tag, runs_m in (("frames", frames_m), ("pixel-DP", dp_m)):
        for r, run_m in enumerate(runs_m):
            log(f"  {tag} rank {r} on {run_m['stats']['device']}: process "
                f"wall {run_m['wall_s']:.3f} s; {run_m['timings']} [{card}]")
    if not (frames_ok and dp_ok):
        raise AssertionError(f"phase 10: frame sharding ok {frames_ok}, "
                             f"pixel-DP ok {dp_ok}")
    distributed_m = {mode: [{"wall_s": r["wall_s"], **r["timings"]}
                            for r in runs_m]
                     for mode, runs_m in (("frames", frames_m),
                                          ("fused_dp", dp_m))}

    # --- phase 11: the port's benchmark ----------------------------------
    log("phase 11: python -m refraction_tpu_torch.bench (every cell, "
        "RRT_BENCH_BUDGET_S 1800)")
    bench_res, bench_s = run_bench(os.path.join(tmp, "bench"))
    gates = bench_res.get("gate", {})
    counts = bench_res.get("launches", {})
    bench_bad = bench_faults(bench_res, card, torch.cuda.get_device_name(0),
                             _build.BUILD_DIR)
    for cell in BENCH_CELLS:
        g = gates.get(cell, {})
        log(f"  gate {cell}: rmse {g.get('rmse', float('nan')):.3e}, share "
            f"off {g.get('share_off', float('nan')):.2e} on "
            f"{g.get('pixels')} pixels (every {g.get('stride')}th), ok "
            f"{g.get('ok')}; scene {bench_res.get(cell + '_scene')}")
    log(f"  headline {bench_res.get('metric')}: frame "
        f"{bench_res.get('frame_ms')} ms (latency {bench_res.get('frame_latency_ms')}, loop "
        f"{bench_res.get('loop_frame_ms')}, batched "
        f"{bench_res.get('batched_frame_ms')}), device "
        f"{bench_res.get('device_ms')} ms, live Mrays/s "
        f"{bench_res.get('mrays_live')} [{card}]")
    log(f"  cells, device ms: ref_demo {bench_res.get('ref_demo_device_ms')},"
        f" ott {bench_res.get('ott_device_ms')}, config5 "
        f"{bench_res.get('config5_device_ms')}; spp4 frame "
        f"{bench_res.get('spp4_frame_ms')} ms; build "
        f"{bench_res.get('build_s')} s (cached {bench_res.get('build_cached')}), cold build "
        f"{bench_res.get('build_cold_s')} s in "
        f"{os.path.dirname(bench_res.get('build80k_library') or '')},"
        f" first 80k frame "
        f"{bench_res.get('first_frame80k_s')} s [{card}]")
    log(f"  launches per regime {counts}; bench wall {bench_s:.1f} s")
    if any(bench_bad.values()):
        raise AssertionError(f"phase 11: {bench_bad}")
    shutil.rmtree(tmp, ignore_errors=True)

    mt_r, vt_words = int(mt_a[3].numel()), {"mt": inp.tri_flat.size,
                                             "woop": inp.W.size}
    tree = wave["demo"]["bound"]
    bnd = {"frame": frame_rows["demo"]["bound"],
           "round": bounds.bound(tree["ops"], tree["static_bytes"]),
           "round_queue": tree,
           "closest_hit": results["closest_hit"][4], "env": results["env"][3],
           "mt_vpu": bounds.mtbench_bound("mt", mt_r, vt, vt_words["mt"]),
           "mt_woop": bounds.mtbench_bound("woop", mt_r, vt,
                                           vt_words["woop"]),
           "mt_woop_tc": bounds.mtbench_bound("woop_tc", mt_r, vt,
                                              vt_words["woop"]),
           "mt_woop_tc3": bounds.mtbench_bound("woop_tc3", mt_r, vt,
                                               vt_words["woop"]),
           "round_fold": fold_bound,
           "frame_tiles": frame_rows["demo"]["bound"],
           "stall": {"bound_ms": sum(bounds.stall_bound(
               v, 64, sm_clock)["bound_ms"] for v in STALL_VARIANTS),
                     "bound_by": "operations"}}
    kern = [{"name": "frame", "entry": "rt_frame", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/frame.cu",
             "replaces": "refraction_tpu/kernels/framekernel.py:106",
             "launches": launches["frame"], "max_abs_err": frame_err,
             "ms": frame_ms, "plain_ms": plain_ms,
             "timed": "demo 1024x768 5/2 vs the eager integrator; the mean "
                      "of two runs of 10 launches"},
            {"name": "frame_tiles", "entry": "rt_frame_tiles",
             "route": "cuda",
             "source": "refraction_tpu_torch/csrc/frame.cu",
             "replaces": "refraction_tpu/kernels/framekernel.py:106",
             "launches": dp_launches, "max_abs_err": tiles_err,
             "ms": pixel_dp["demo"][4]["tiles_card_ms"],
             "plain_ms": tiles_plain_ms,
             "timed": "the 4 launches of a 4-shard demo frame (1024x768 "
                      "5/2), the card's time behind a spin kernel, vs "
                      "frame_tiles_plain on the same 4 shards; bound: the "
                      "frame kernel's for the same pixels; launches from "
                      "phase 9's pixel-DP frames (2, 3 and 4 shards, demo "
                      "and large); max_abs_err: the largest over the same 4 "
                      "shards"},
            {"name": "round", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/round.cu",
             "replaces": "refraction_tpu/kernels/megakernel.py:43",
             "launches": round_launches["mega_round"],
             "max_abs_err": variant_err,
             "ms": wave["demo"]["static_wavefront_ms"],
             "plain_ms": wave["demo"]["plain_ms"],
             "tree_bound_ms": tree["bound_ms"],
             "timed": "the static-layout wavefront (6 launches) vs the "
                      "eager integrator, demo 1024x768 5/2; bound: the "
                      "static layout's bytes; launches from phase 6's "
                      "static-layout wavefronts"},
            {"name": "round_queue", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/round.cu",
             "replaces": "refraction_tpu/kernels/megakernel.py:43",
             "launches": round_launches["mega_round_queue"],
             "max_abs_err": max(wave["demo"]["max_abs_err"], queue_err),
             "ms": wave["demo"]["wavefront_ms"],
             "plain_ms": wave["demo"]["plain_ms"],
             "timed": "render_pixels_mega (6 round and 5 fold launches) vs "
                      "the eager integrator, demo 1024x768 5/2; bound: the "
                      "live ray tree (bounds.round_bound)"},
            {"name": "round_fold", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/round.cu",
             "replaces": "refraction_tpu/kernels/megakernel.py:43",
             "launches": round_launches["fold_round_sums"],
             "max_abs_err": fold_err,
             "ms": fold_ms[0], "plain_ms": fold_ms[1],
             "timed": f"{fold_n} pixels x {fold_j} slots, a tenth of the "
                      "rows named, vs fold_round_sums_plain; the mean of "
                      "one-fold windows, the mask restored outside them"},
            {"name": "closest_hit", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/closest_hit.cu",
             "replaces": "refraction_tpu/kernels/intersect_pallas.py:140",
             "launches": modular_launches["closest_hit"],
             "max_abs_err": results["closest_hit"][3],
             "max_rel_t_err": results["closest_hit"][2],
             "ms": results["closest_hit"][0],
             "plain_ms": results["closest_hit"][1],
             "timed": "2^16 rays x 5,120 tris vs the brute force; launches "
                      "from the modular path of phase 8 (256x192)"},
            {"name": "env", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/env.cu",
             "replaces": "refraction_tpu/kernels/envmap_pallas.py:130",
             "launches": modular_launches["env_contribution"],
             "max_abs_err": results["env"][2],
             "ms": results["env"][0], "plain_ms": results["env"][1],
             "timed": "2^16 rays, 1024x2048 map vs the gather; the card's "
                      "time behind a spin kernel (the wrapper takes the "
                      "host longer to enqueue than the kernel runs)"},
            {"name": "mt_vpu", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/mtbench.cu",
             "replaces": "tools/mxu_mt_bench.py:44",
             "launches": instr_launches["mt_visits"],
             "max_abs_err": mt_err["mt_visits"],
             "ms": mt_t["mt_visits"][0], "plain_ms": mt_t["mt_visits"][1],
             "timed": f"V={vt} sub visits x 1,024 rays"},
            {"name": "mt_woop", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/mtbench.cu",
             "replaces": "tools/mxu_mt_bench.py:96",
             "launches": instr_launches["woop_visits"],
             "max_abs_err": mt_err["woop_visits"],
             "ms": mt_t["woop_visits"][0], "plain_ms": mt_t["woop_visits"][1],
             "timed": f"V={vt} sub visits x 1,024 rays"},
            {"name": "mt_woop_tc", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/mtbench.cu",
             "replaces": "tools/mxu_mt_bench.py:96",
             "launches": instr_launches["woop_visits_tc"],
             "max_abs_err": mt_err["woop_visits_tc"],
             "exact_share": min(tc_exact["woop_visits_tc"]),
             "ms": mt_t["woop_visits_tc"][0],
             "plain_ms": mt_t["woop_visits_tc"][1],
             "timed": f"V={vt} sub visits x 1,024 rays, one TF32 pass; "
                      "max_abs_err: t against the plain version where the "
                      "winner is the same"},
            {"name": "mt_woop_tc3", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/mtbench.cu",
             "replaces": "tools/mxu_mt_bench.py:96",
             "launches": instr_launches["woop_visits_tc3"],
             "max_abs_err": mt_err["woop_visits_tc3"],
             "exact_share": min(tc_exact["woop_visits_tc3"]),
             "ms": mt_t["woop_visits_tc3"][0],
             "plain_ms": mt_t["woop_visits_tc3"][1],
             "timed": f"V={vt} sub visits x 1,024 rays, 3xTF32 (three mma "
                      "passes; the bound counts the product once)"},
            {"name": "stall", "route": "cuda",
             "source": "refraction_tpu_torch/csrc/stallbench.cu",
             "replaces": "tools/stallbench.py:49",
             "launches": instr_launches["stall_iters"],
             "max_abs_err": stall_err,
             "ms": stall_t[0], "plain_ms": stall_t[1],
             "ns_per_iter": stall_ns,
             "timed": "the six variants at n_iter 64, summed; bound: the "
                      "sum of their bounds, each the larger of the "
                      "throughput floor and the chain's latency floor "
                      "(operations: dependent ones); ns_per_iter: the "
                      "stallbench CLI at N = 200,000"}]
    for k in kern:
        # No single PyTorch call computes any of these functions (the Woop
        # kernel's 48x8 product alone would be one torch.matmul).
        k.update(bound_ms=bnd[k["name"]]["bound_ms"],
                 bound_by=bnd[k["name"]]["bound_by"], library_ms=None)
    frame_cells = {tag: {"ms": r["ms"], "runs_ms": r["runs_ms"],
                         "bound_ms": r["bound"]["bound_ms"],
                         "bound_by": r["bound"]["bound_by"],
                         "work": r["bound"]["work"]}
                   for tag, r in frame_rows.items()}
    print(json.dumps({"kernels": kern, "frame_stream_ms": per_frame,
                      "modular_ms": modular_ms,
                      "frame_ms_large": large_ms, "frame_cells": frame_cells,
                      "frame_occupancy": occupancy,
                      "wavefront": wave, "pixel_dp": pixel_dp,
                      "lbvh_ms": lbvh_ms, "distributed_s": distributed_m,
                      "bench": bench_res, "bench_s": bench_s,
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
