"""Command-line frame loop: port of `python -m refraction_tpu.run` for one
frame, an orbit, a progressive accumulation, a heatmap or a live view, on
a torch device.

Each frame is one frame-kernel launch (``--device cuda``); on
``--device cpu`` the kernel's plain version renders the same image.
There is no fallback: ``--device cuda`` without CUDA is an error.

- ``--instances SPEC.json`` renders N placed meshes (TLAS with N
  instances, `scene.load_instanced`); mask-0 instances are
  dropped at build, and the frame kernel serves the reference's constant
  0xff ray mask.
- ``--accumulate`` averages the frames into one image and saves the
  float64 state to ``PREFIX_state.npz``; ``--resume STATE.npz`` continues
  it (the state is the JAX package's format, in both directions).
- ``--heatmap PATH.png`` renders one per-pixel live-ray-count map through
  the per-round wavefront and exits.
- ``--serve PORT`` publishes every frame to an HTTP viewer (port 0 picks
  a free port, which is logged); ``--frames 0`` orbits until SIGINT.

Not ported: ``--devices``, ``--profile``, ``--baseline``, ``--backend``.

Examples:
  python -m refraction_tpu_torch.run --scene shell.obj --frames 8 \\
      --out /tmp/orbit/frame.png
  python -m refraction_tpu_torch.run --scene my.obj --envmap env.hdr \\
      --width 64 --height 48 --device cpu --out /tmp/frame.png
  python -m refraction_tpu_torch.run --scene my.obj --frames 16 \\
      --accumulate --spp 4 --out /tmp/acc.png
  python -m refraction_tpu_torch.run --scene my.obj --serve 8000 --frames 0
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import DEFAULT_ASSET_DIR, RenderConfig
from refraction_tpu_torch.io.mtl import ior_for_scene
from refraction_tpu_torch.io.png import write_png
from refraction_tpu_torch.render import (
    Accumulator,
    heatmap_to_rgb,
    make_renderer,
    render_heatmap,
)
from refraction_tpu_torch.scene import load_instanced, load_scene, scene_from_jax
from refraction_tpu_torch.timing import require_device
from refraction_tpu_torch.utils.stats import FrameStats, log, setup_logging
from refraction_tpu_torch.viewer import FrameServer


def to_u8(img: torch.Tensor, linear: bool = False) -> torch.Tensor:
    """Display transform on the image's device: clamp, gamma 2.2 unless
    ``linear`` (the reference's clamp-only UNORM present), then u8 — a
    quarter of the float image's bytes cross to the host."""
    disp = torch.clamp(img, 0.0, 1.0)
    if not linear:
        disp = disp ** float(np.float32(1.0 / 2.2))
    return (disp * 255.0 + 0.5).to(torch.uint8)


def build_config(args) -> RenderConfig:
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
    return RenderConfig().replace(**overrides)


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
    args = p.parse_args(argv)
    if args.resume and not args.accumulate:
        p.error("--resume continues an --accumulate render: add --accumulate")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
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
    log.info("scene=%s envmap=%s %dx%d bounces=%d spp=%d device=%s (%s)",
             args.instances or cfg.scene_path, cfg.envmap_path, cfg.width,
             cfg.height, cfg.max_refract_depth, cfg.spp, device, name)

    if args.instances:
        scene_np, meta = load_instanced(args.instances, cfg)
    else:
        scene_np, meta = load_scene(cfg)
    log.info("tris=%d (padded %d), clusters=%d, envmap=%s",
             meta.num_real_tris, meta.num_padded_tris,
             scene_np.num_clusters, scene_np.envmap.shape)
    scene = scene_from_jax(scene_np, device)

    if args.heatmap:
        counts = render_heatmap(scene, cfg, orbit_camera(args.angle, cfg),
                                device)
        write_png(args.heatmap, heatmap_to_rgb(counts))
        log.info("heatmap: max %d rays/pixel, mean %.2f -> %s",
                 int(counts.max()), float(counts.mean()), args.heatmap)
        return 0

    renderer = make_renderer(cfg, "cuda", device)
    acc = None
    if args.accumulate:
        acc = (Accumulator.load(args.resume) if args.resume
               else Accumulator(cfg.height, cfg.width))
        if acc.sum.shape[:2] != (cfg.height, cfg.width):
            raise ValueError(f"--resume {args.resume}: state is "
                             f"{acc.sum.shape[:2]}, frames are "
                             f"{(cfg.height, cfg.width)}")
    serve = None
    if args.serve is not None:
        serve = FrameServer(port=args.serve)
        log.info("live viewer at http://0.0.0.0:%d/", serve.port)

    base, ext = os.path.splitext(args.out)
    ext = ext or ".png"
    stats = FrameStats()
    angle = args.angle
    timed = device.type == "cuda"
    frame_iter = range(args.frames) if args.frames else itertools.count()
    try:
        for i in frame_iter:
            stats.start()
            if timed:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            img = renderer(scene, orbit_camera(angle, cfg))
            if timed:
                ev1.record()
            # Each branch's copy to the host waits for the frame.
            u8 = None
            if acc is None or serve is not None:
                u8 = to_u8(img, args.linear).cpu().numpy()
            if acc is not None:
                acc.add(img.cpu().numpy())
            # The frame kernel counts no rays: no live ray rate is logged.
            stats.stop()
            if serve is not None:  # published before its log line
                serve.publish(u8, {"frame": i, "fps": round(stats.fps, 2)})
            # stream_ms: CUDA events around the render call, so it spans
            # the scalar upload and the frame kernel on the stream.
            log.info("%s", json.dumps({
                "frame": i, "ms": stats.times[-1] * 1e3,
                "stream_ms": ev0.elapsed_time(ev1) if timed else None,
                "fps": stats.fps}))
            # Per-frame files, unless the frames are accumulated or an
            # orbit is only viewed live (--raw still writes them).
            if acc is None and (serve is None or args.frames == 1
                                or args.raw):
                path = (f"{base}{ext}" if args.frames == 1
                        else f"{base}_{i:04d}{ext}")
                write_png(path, u8)
                if args.raw:
                    np.save(os.path.splitext(path)[0] + ".npy",
                            img.cpu().numpy())
            angle += cfg.orbit_speed  # RefractionDemo.cpp:567
    except KeyboardInterrupt:
        log.info("interrupted after %d frames", stats.frames)
    finally:
        if serve is not None:
            serve.close()

    if acc is not None:
        log.info("accumulated %d frames", acc.count)
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
