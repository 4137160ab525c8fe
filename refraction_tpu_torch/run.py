"""Command-line frame loop: port of `python -m refraction_tpu.run` for one
frame, an orbit, a progressive accumulation, a heatmap or a live view, on
a torch device.

With ``--backend cuda`` (the default on ``--device cuda``) each frame is
one frame-kernel launch; on ``--device cpu`` the plain versions render
the same image.
There is no fallback: ``--device cuda`` without CUDA is an error.

- ``--backend {auto,torch,cuda}`` picks the renderer
  (`render.make_renderer`): ``cuda`` the frame kernel, ``torch`` the eager
  integrator over the brute force, ``auto`` (the default) ``cuda`` on a
  CUDA device and ``torch`` on the CPU. The JAX CLI's names are
  ``auto/xla/pallas``; ``cfg.backend`` keeps those and is not read.
- ``--baseline N`` starts from the staged BASELINE.json config N
  (`config.baseline_config`); the other flags override it.
- ``--profile DIR`` runs one warm iteration of the frame loop, then one
  under ``torch.profiler`` (host activity, and the card's on CUDA): the
  pose, the render call, the copies to the host and the wait for them,
  and with ``--accumulate`` the fold, each in its ``rt.*`` span
  (`tracing`). It is written to ``DIR/frame_trace.json`` as a Chrome
  trace; then the loop runs as usual. On CUDA a trace without device
  activity raises instead of being written.
- ``--instances SPEC.json`` renders N placed meshes (TLAS with N
  instances over one BLAS a distinct mesh, `scene.load_instanced`);
  mask-0 instances are dropped at build. The frame kernel walks the two
  levels (``walk=instances``) and serves the reference's constant 0xff
  ray mask; the copies are baked into one mesh only for the paths that
  walk one (``--backend torch``, ``--heatmap``, ``--devices``).
- ``--accumulate`` averages the frames into one image and saves the
  float64 state to ``PREFIX_state.npz``; ``--resume STATE.npz`` continues
  it (the state is the JAX package's format, in both directions).
- ``--heatmap PATH.png`` renders one per-pixel live-ray-count map through
  the per-round wavefront and exits.
- ``--serve PORT`` publishes every frame to an HTTP viewer (port 0 picks
  a free port, which is logged); ``--frames 0`` orbits until SIGINT.
- ``--devices N`` (N > 1) shards each frame over the first N CUDA cards
  of this process (`parallel.sharding`): backend ``cuda`` through the
  frame kernel's pixel-DP entry (`make_fused_sharded_renderer`, one
  launch per card), backend ``torch`` through the wavefront
  (`make_sharded_renderer`). The image is gathered on the first card.
  Fewer visible cards is an error (exit code 2) that names them; with
  ``--device cpu`` the N shards run on the CPU, which is how the tests
  drive the flag.

The loop is pipelined, as the JAX CLI's: right behind each frame it
queues the frame's u8 display image to the host into one of two pinned
buffers and records an event; it enqueues the next frame, and only then
waits for that event and writes, publishes or accumulates the frame
while the card renders the next one (`HostCopies`). The float radiance
stays on the card: ``--accumulate`` folds it there, and ``--raw`` copies
it to the host when it writes it. The files are those of a
frame-by-frame render.

Examples:
  python -m refraction_tpu_torch.run --scene shell.obj --frames 8 \\
      --out /tmp/orbit/frame.png
  python -m refraction_tpu_torch.run --scene my.obj --envmap env.hdr \\
      --width 64 --height 48 --device cpu --out /tmp/frame.png
  python -m refraction_tpu_torch.run --scene my.obj --frames 16 \\
      --accumulate --spp 4 --out /tmp/acc.png
  python -m refraction_tpu_torch.run --scene my.obj --serve 8000 --frames 0
  python -m refraction_tpu_torch.run --baseline 3 --frames 1
  python -m refraction_tpu_torch.run --scene my.obj --devices 2 --frames 8
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import (
    DEFAULT_ASSET_DIR,
    RenderConfig,
    baseline_config,
)
from refraction_tpu_torch.io.mtl import ior_for_scene
from refraction_tpu_torch.io.png import write_png
from refraction_tpu_torch.kernels.framekernel import walk_levels
from refraction_tpu_torch.parallel.sharding import (
    make_fused_sharded_renderer,
    make_mesh,
    make_sharded_renderer,
)
from refraction_tpu_torch.render import (
    Accumulator,
    heatmap_to_rgb,
    make_renderer,
    render_heatmap,
    resolve_backend,
)
from refraction_tpu_torch.scene import load_instanced, load_scene, scene_from_jax
from refraction_tpu_torch.timing import require_device
from refraction_tpu_torch.tracing import span
from refraction_tpu_torch.utils.stats import FrameStats, log, setup_logging
from refraction_tpu_torch.viewer import FrameServer


def to_u8(img: torch.Tensor, linear: bool = False) -> torch.Tensor:
    """Display transform on the image's device: clamp, gamma 2.2 unless
    ``linear`` (the reference's clamp-only UNORM present), then u8 — a
    quarter of the float image's bytes cross to the host."""
    with span("rt.to_u8"):
        disp = torch.clamp(img, 0.0, 1.0)
        if not linear:
            disp = disp ** float(np.float32(1.0 / 2.2))
        return (disp * 255.0 + 0.5).to(torch.uint8)


class HostCopies:
    """A frame's u8 display image to the host, queued behind it on the
    card; its float radiance stays on the card.

    `enqueue` queues, on the current stream right behind the frame, its u8
    display image (`to_u8`) into one of two pinned host buffers, the slots
    taken in turns, then records an event; it returns the host array
    (valid once the event has completed), the radiance (the frame's own
    device tensor, which `render.Accumulator.add` folds on the card) and
    the event. The loop enqueues the next frame before it waits for that
    event, so the card renders frame N while the host writes frame N - 1.
    A slot is written again two frames later, after the loop has drained
    its frame. On the CPU both are host arrays, made at once, and there
    is no event."""

    def __init__(self, device: torch.device, u8: bool, radiance: bool,
                 linear: bool):
        self.device, self.u8, self.radiance = device, u8, radiance
        self.linear = linear
        self._slots: list[torch.Tensor | None] = [None, None]
        self._next = 0

    def enqueue(self, img: torch.Tensor):
        """(u8 (H, W, 3) host array or None, radiance (H, W, 3) or None,
        event or None) of ``img``."""
        u8 = to_u8(img, self.linear) if self.u8 else None
        radiance = img if self.radiance else None
        if self.device.type != "cuda":
            return (None if u8 is None else u8.numpy(),
                    None if radiance is None else radiance.numpy(), None)
        slot = self._next
        self._next ^= 1
        if u8 is not None:
            if self._slots[slot] is None:
                self._slots[slot] = torch.empty(u8.shape, dtype=u8.dtype,
                                                pin_memory=True)
            self._slots[slot].copy_(u8, non_blocking=True)
            u8 = self._slots[slot].numpy()
        done = torch.cuda.Event()
        done.record()
        return u8, radiance, done


def profile_frame(renderer, scene, cfg: RenderConfig, angle: float,
                  copies: HostCopies, device: torch.device, out_dir: str,
                  acc: Accumulator | None = None) -> str:
    """One warm iteration of the frame loop, then one under
    ``torch.profiler`` (host activity, and the card's on CUDA), exported
    as a Chrome trace to ``out_dir/frame_trace.json``; returns its path.
    An iteration is the loop's: the pose at ``angle``, the render call,
    ``copies.enqueue`` and the wait for its event, then, given ``acc``,
    the fold of the radiance into it; the trace holds the frame path's
    `tracing` spans (``rt.*``). On CUDA a trace that recorded no device
    activity raises rather than being written: a host-only trace would
    not show the frame's kernels."""
    from torch.profiler import ProfilerActivity, profile

    def iteration():
        img = renderer(scene, orbit_camera(angle, cfg))
        _, radiance, done = copies.enqueue(img)
        if done is not None:
            done.synchronize()
        if acc is not None:
            acc.add(radiance)

    cuda = device.type == "cuda"
    iteration()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        iteration()
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("--profile: torch.profiler recorded no device "
                           "activity on this card; no trace written")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "frame_trace.json")
    prof.export_chrome_trace(path)
    return path


def build_config(args) -> RenderConfig:
    baseline = getattr(args, "baseline", None)
    cfg = baseline_config(baseline) if baseline else RenderConfig()
    overrides = {}
    if args.scene:
        path = args.scene
        if not os.path.exists(path):
            path = os.path.join(DEFAULT_ASSET_DIR, args.scene)
        overrides["scene_path"] = path
    if args.envmap:
        overrides["envmap_path"] = args.envmap
    for key, field in (("width", "width"), ("height", "height"),
                       ("bounces", "max_refract_depth"), ("spp", "spp"),
                       ("ior", "ior"), ("aspect", "aspect")):
        if getattr(args, key, None) is not None:
            overrides[field] = getattr(args, key)
    return cfg.replace(**overrides)


def mtl_ior_source(args, cfg: RenderConfig) -> str:
    """The OBJ whose ``.mtl`` Ni ``--mtl-ior`` reads: the scene's, or with
    ``--instances`` the first instance's (paths resolve as in
    `load_instanced`: as given, else beside ``cfg.scene_path``)."""
    if not args.instances:
        return cfg.scene_path
    with open(args.instances) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        spec = spec["instances"]
    if not spec:
        return cfg.scene_path
    path = spec[0]["obj"]
    if not os.path.exists(path):
        path = os.path.join(os.path.dirname(cfg.scene_path), spec[0]["obj"])
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", help="OBJ path (or name under the asset dir)")
    p.add_argument("--envmap", help="HDR/PNG environment map path")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--bounces", type=int, help="max refraction depth (ref: 5)")
    p.add_argument("--spp", type=int, help="supersamples per pixel")
    p.add_argument("--ior", type=float, help="index of refraction (ref: 1.3)")
    p.add_argument("--aspect", type=float,
                   help="camera aspect override (default: width/height;"
                        " the reference's literal 1.333 at 1024x768)")
    p.add_argument("--mtl-ior", action="store_true",
                   help="take the IOR from the scene's .mtl Ni (with"
                        " --instances: the first instance's)")
    p.add_argument("--instances", metavar="SPEC.json",
                   help="render N placed copies of meshes: JSON list of"
                        " {obj, translate, scale, rotate_y_deg, mask} or"
                        " {obj, transform: 3x4}")
    p.add_argument("--backend", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="renderer: cuda = the frame kernel, torch = the"
                        " eager integrator over the brute force, auto ="
                        " cuda on a CUDA device, torch on the CPU")
    p.add_argument("--baseline", type=int, choices=[1, 2, 3, 4, 5],
                   help="start from a BASELINE.json staged config")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace of one iteration of"
                        " the frame loop (after a warm one) to"
                        " DIR/frame_trace.json")
    p.add_argument("--frames", type=int, default=1,
                   help="frames to render; 0 = endless orbit, ended by"
                        " SIGINT (with --serve)")
    p.add_argument("--angle", type=float, default=0.01,
                   help="initial orbit angle (ref: 0.01)")
    p.add_argument("--out", default="frame.png",
                   help="output PNG path; with --frames>1 a prefix, frames "
                        "go to PREFIX_0000.png, ...")
    p.add_argument("--accumulate", action="store_true",
                   help="average all frames into one image (progressive"
                        " mode); the state goes to PREFIX_state.npz")
    p.add_argument("--resume", metavar="STATE.npz",
                   help="continue an --accumulate render from its state")
    p.add_argument("--heatmap", metavar="PATH.png",
                   help="render ONE per-pixel live-ray-count heatmap to"
                        " PATH.png and exit (per-round wavefront path)")
    p.add_argument("--serve", type=int, metavar="PORT",
                   help="serve the orbit live over HTTP at"
                        " http://HOST:PORT/ while frames render (0: a free"
                        " port, logged)")
    p.add_argument("--raw", action="store_true",
                   help="also save linear radiance .npy")
    p.add_argument("--linear", action="store_true",
                   help="display transform = clamp only (no gamma)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard each frame over N devices of the --device"
                        " type (pixel data parallelism; 0 or 1 = one"
                        " device): the first N CUDA cards, or N shards on"
                        " the CPU")
    args = p.parse_args(argv)
    if args.resume and not args.accumulate:
        p.error("--resume continues an --accumulate render: add --accumulate")
    args.mesh = None
    if args.devices > 1:
        try:
            args.mesh = make_mesh(args.devices, torch.device(args.device).type)
        except ValueError as e:
            p.error(f"--devices {args.devices}: {e}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    if args.mesh:
        device = args.mesh[0]  # the scene's device and the image's
    setup_logging()
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cfg = build_config(args)
    if args.mtl_ior:
        src = mtl_ior_source(args, cfg)
        cfg = cfg.replace(ior=ior_for_scene(src, cfg.ior))
        log.info("IOR from MTL (%s): %.4g", src, cfg.ior)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    backend = resolve_backend(args.backend, device)
    log.info("scene=%s envmap=%s %dx%d bounces=%d spp=%d backend=%s "
             "device=%s (%s)", args.instances or cfg.scene_path,
             cfg.envmap_path, cfg.width, cfg.height, cfg.max_refract_depth,
             cfg.spp, backend, device, name)

    if args.instances:
        scene_np, meta = load_instanced(args.instances, cfg)
    else:
        scene_np, meta = load_scene(cfg)
    scene = scene_from_jax(scene_np, device)
    lv = walk_levels(scene)
    top = (f"{lv['instances']} instances under {lv['instance_roots']} "
           "instance roots, their BLASes " if "instances" in lv else "")
    log.info("tris=%d (padded %d), envmap=%s, walk=%s: %s%d roots, %d "
             "supers, %d clusters, %d subs a cluster", meta.num_real_tris,
             meta.num_padded_tris, scene_np.envmap.shape, lv["walk"], top,
             lv["roots"], lv["supers"], lv["clusters"],
             lv["subs_per_cluster"])

    if args.heatmap:
        counts = render_heatmap(scene.baked(), cfg,
                                orbit_camera(args.angle, cfg), device)
        write_png(args.heatmap, heatmap_to_rgb(counts))
        log.info("heatmap: max %d rays/pixel, mean %.2f -> %s",
                 int(counts.max()), float(counts.mean()), args.heatmap)
        return 0

    if args.mesh:
        scene = scene.baked()  # pixel-DP walks one mesh
        if backend == "cuda":
            renderer = make_fused_sharded_renderer(cfg, args.mesh)
        else:
            renderer = make_sharded_renderer(cfg, args.mesh, backend)
        log.info("pixel-DP over %d devices (%s)", len(args.mesh),
                 "fused kernel" if backend == "cuda" else "wavefront")
    else:
        renderer = make_renderer(cfg, backend, device)
    acc = None
    if args.resume:  # parse_args has required --accumulate beside it
        acc = Accumulator.load(args.resume)
        if acc.sum.shape[:2] != (cfg.height, cfg.width):
            raise ValueError(f"--resume {args.resume}: state is "
                             f"{acc.sum.shape[:2]}, frames are "
                             f"{(cfg.height, cfg.width)}")
    elif args.accumulate:
        acc = Accumulator(cfg.height, cfg.width)
    serve = None
    if args.serve is not None:
        serve = FrameServer(port=args.serve)
        log.info("live viewer at http://0.0.0.0:%d/", serve.port)

    base, ext = os.path.splitext(args.out)
    ext = ext or ".png"
    # Per-frame files, unless the frames are accumulated or an orbit is
    # only viewed live (--raw still writes them).
    files = acc is None and (serve is None or args.frames == 1 or args.raw)
    copies = HostCopies(device, u8=acc is None or serve is not None,
                        radiance=acc is not None or (files and args.raw),
                        linear=args.linear)
    if args.profile:
        # The profiled iteration folds into an accumulator of its own.
        path = profile_frame(
            renderer, scene, cfg, args.angle, copies, device, args.profile,
            None if acc is None else Accumulator(cfg.height, cfg.width))
        log.info("profiler trace written to %s", path)
    stats = FrameStats()
    timed = device.type == "cuda"

    def drain(entry) -> None:
        """Wait for a frame's copies; accumulate, publish, log and write
        it. ``ms`` in its line is the host time since the previous frame
        was drained, its files written (the loop's frame period, as the
        JAX CLI times it); ``stream_ms`` the CUDA events around its render
        call (the scalar upload and the frame kernel on the stream)."""
        i, u8, radiance, done, ev0, ev1 = entry
        if done is not None:
            done.synchronize()
        if acc is not None:
            acc.add(radiance)
        stats.stop()
        if serve is not None:  # published before its log line
            serve.publish(u8, {"frame": i, "fps": round(stats.fps, 2)})
        log.info("%s", json.dumps({
            "frame": i, "ms": stats.times[-1] * 1e3,
            "stream_ms": ev0.elapsed_time(ev1) if timed else None,
            "fps": stats.fps}))
        if files:
            path = (f"{base}{ext}" if args.frames == 1
                    else f"{base}_{i:04d}{ext}")
            write_png(path, u8)
            if args.raw:  # a host array on the CPU, the card's tensor
                np.save(os.path.splitext(path)[0] + ".npy",
                        torch.as_tensor(radiance).cpu().numpy())
        stats.start()

    angle = args.angle
    pending = None  # the frame enqueued last, not yet drained
    interrupted = False
    frame_iter = range(args.frames) if args.frames else itertools.count()
    stats.start()
    try:
        try:
            for i in frame_iter:
                ev0 = ev1 = None
                if timed:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                img = renderer(scene, orbit_camera(angle, cfg))
                if timed:
                    ev1.record()
                prev, pending = pending, (i, *copies.enqueue(img), ev0, ev1)
                if prev is not None:  # frame i renders meanwhile
                    drain(prev)
                angle += cfg.orbit_speed  # RefractionDemo.cpp:567
        except KeyboardInterrupt:
            interrupted = True
        if pending is not None:
            prev, pending = pending, None
            drain(prev)
    finally:
        if serve is not None:
            serve.close()
    if interrupted:
        log.info("interrupted after %d frames", stats.frames)

    if acc is not None:
        log.info("accumulated %d frames (%d folded on the card)", acc.count,
                 acc.card_folds)
        acc.save(f"{base}_state.npz")
        final = acc.image
        write_png(f"{base}{ext}",
                  to_u8(torch.from_numpy(final), args.linear).numpy())
        if args.raw:
            np.save(f"{base}.npy", final)
    log.info("done: %d frames, %.2f fps avg -> %s", stats.frames, stats.fps,
             args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
