"""Per-round profile of the wavefront path: port of ``tools/profile_rounds.py``.

For one frame of `integrator.render_pixels_mega` (spp 1, orbit angle
0.01) it prints one line per bounce round: the round's static lane width
(N, 2N, 4N, ...), its live lanes (the count of its compacted queue), and
the minimum of 5 timings of the round's `mega_round_queue` call after one
warm-up call. On ``--device cuda`` the timings are the card's time
(`timing.device_ms`: CUDA events around the call, queued behind a spin
kernel so that the host's launch overhead is not counted; the next
queue's count is zeroed before each call, outside the timed window, so a
round's time is its launches alone: the round kernel and, from the first
round of more than one lane per pixel on, the fold kernel); on ``--device cpu`` they are
wall-clock time over the plain version. The last line sums the rounds;
the live lanes sum to the frame's ``rays_traced``.

    python -m refraction_tpu_torch.profile_rounds --scene my.obj \\
        --envmap env.hdr --width 1920 --height 1080 --bounces 4
    python -m refraction_tpu_torch.profile_rounds --scene my.obj \\
        --envmap env.hdr --width 32 --height 16 --device cpu

``--device cuda`` without CUDA is an error.
"""

from __future__ import annotations

import argparse

import torch

from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.camera import CameraFrame, generate_rays, orbit_camera
from refraction_tpu_torch.integrator import wavefront_rounds
from refraction_tpu_torch.run import build_config
from refraction_tpu_torch.scene import load_scene, scene_from_jax
from refraction_tpu_torch.timing import device_ms, require_device

REPS = 5


def profile_rounds(scene, cfg: RenderConfig, frame: CameraFrame,
                   device: torch.device) -> list[dict]:
    """One dict per bounce round of `wavefront_rounds`: ``round``,
    ``lanes``, ``live`` and ``ms`` (the minimum of REPS timed calls after
    one warm-up)."""
    o, d = generate_rays(frame, cfg.width, cfg.height, device)
    radiance = torch.zeros(o.shape[0], 3, dtype=torch.float32, device=device)
    rows = []
    for count, (queue, out, run) in enumerate(wavefront_rounds(scene, o, d,
                                                               cfg)):
        live = int(queue.count)

        def call():
            run(radiance)

        def reset():  # each call appends the round's children anew
            if out is not None:
                out.count.zero_()

        device_ms(call, device, reset)  # warm-up
        ms = min(device_ms(call, device, reset) for _ in range(REPS))
        rows.append({"round": count, "lanes": queue.width, "live": live,
                     "ms": ms})
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", help="OBJ path (or name under the asset dir)")
    p.add_argument("--envmap", help="HDR/PNG environment map path")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--bounces", type=int, help="max refraction depth (ref: 5)")
    p.add_argument("--device", default="cuda",
                   help="torch device to profile on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    cfg = build_config(args)
    scene_np, meta = load_scene(cfg)
    scene = scene_from_jax(scene_np, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu, plain version, wall clock")
    print(f"profile_rounds: {cfg.width}x{cfg.height} bounces "
          f"{cfg.max_refract_depth}/{cfg.max_reflect_depth}, "
          f"{meta.num_real_tris} tris, device {device} ({name})", flush=True)
    rows = profile_rounds(scene, cfg, orbit_camera(0.01, cfg), device)
    for r in rows:
        print(f"round {r['round']}: lanes {r['lanes']} live {r['live']} "
              f"ms {r['ms']!r}", flush=True)
    print(f"total: lanes {sum(r['lanes'] for r in rows)} live "
          f"{sum(r['live'] for r in rows)} ms {sum(r['ms'] for r in rows)!r}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
