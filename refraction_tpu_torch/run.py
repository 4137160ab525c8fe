"""Command-line frame loop: port of `python -m refraction_tpu.run` for one
frame or an orbit, on a torch device.

Each frame is one frame-kernel launch (``--device cuda``); on
``--device cpu`` the kernel's plain version renders the same image.
There is no fallback: ``--device cuda`` without CUDA is an error.

Examples:
  python -m refraction_tpu_torch.run --scene shell.obj --frames 8 \\
      --out /tmp/orbit/frame.png
  python -m refraction_tpu_torch.run --scene my.obj --envmap env.hdr \\
      --width 64 --height 48 --device cpu --out /tmp/frame.png
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from refraction_tpu.config import DEFAULT_ASSET_DIR, RenderConfig
from refraction_tpu.io.png import write_png
from refraction_tpu.utils.stats import FrameStats, log, setup_logging
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.render import make_renderer
from refraction_tpu_torch.scene import load_scene, scene_from_jax


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
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--angle", type=float, default=0.01,
                   help="initial orbit angle (ref: 0.01)")
    p.add_argument("--out", default="frame.png",
                   help="output PNG path; with --frames>1 a prefix, frames "
                        "go to PREFIX_0000.png, ...")
    p.add_argument("--raw", action="store_true",
                   help="also save linear radiance .npy")
    p.add_argument("--linear", action="store_true",
                   help="display transform = clamp only (no gamma)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    setup_logging()
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cfg = build_config(args)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log.info("scene=%s envmap=%s %dx%d bounces=%d spp=%d device=%s (%s)",
             cfg.scene_path, cfg.envmap_path, cfg.width, cfg.height,
             cfg.max_refract_depth, cfg.spp, device, name)

    scene_np, meta = load_scene(cfg)
    log.info("tris=%d (padded %d), clusters=%d, envmap=%s",
             meta.num_real_tris, meta.num_padded_tris,
             scene_np.num_clusters, scene_np.envmap.shape)
    scene = scene_from_jax(scene_np, device)
    renderer = make_renderer(cfg, "cuda", device)

    base, ext = os.path.splitext(args.out)
    ext = ext or ".png"
    stats = FrameStats()
    angle = args.angle
    timed = device.type == "cuda"
    for i in range(args.frames):
        stats.start()
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        img = renderer(scene, orbit_camera(angle, cfg))
        if timed:
            ev1.record()
        u8 = to_u8(img, args.linear).cpu().numpy()  # waits for the frame
        # The frame kernel counts no rays: no live ray rate is logged.
        stats.stop()
        # stream_ms: CUDA events around the render call, so it spans the
        # scalar upload and the frame kernel on the stream.
        log.info("%s", json.dumps({
            "frame": i, "ms": stats.times[-1] * 1e3,
            "stream_ms": ev0.elapsed_time(ev1) if timed else None,
            "fps": stats.fps}))
        path = f"{base}{ext}" if args.frames == 1 else f"{base}_{i:04d}{ext}"
        write_png(path, u8)
        if args.raw:
            np.save(os.path.splitext(path)[0] + ".npy", img.cpu().numpy())
        angle += cfg.orbit_speed  # RefractionDemo.cpp:567
    log.info("done: %d frames, %.2f fps avg -> %s", stats.frames, stats.fps,
             args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
