"""Env-kernel times at the widths the eager ``cuda`` backend gives it, and
that backend's frame time, on CUDA.

    python -m refraction_tpu_torch.env_times [--scene X.obj --envmap X.hdr \\
        --width 1024 --height 768 --bounces 5] [--variants] [--label NAME]

prints one JSON line:

- ``env_ms``: per case, the median and the least of 5 rounds of the
  card's mean ms per `kernels.envmap.env_contribution` launch over 20
  launches queued behind a spin kernel (`timing.card_ms`: the wrapper
  takes the host longer to enqueue than the card to run the smaller
  cases, so back-to-back timing would read the host), beside the case's
  bound (`bounds.env_bound`) and the count of rays with weight > 0.
  Cases: 65,536 rays with 80% of the weights > 0 (the shape
  chip_smoke.py has timed since the first port), and the demo frame's
  round widths 786,432 and 3,145,728 with 10% > 0, as the eager
  integrator's rounds have them. Directions are uniform on the sphere,
  the map is the scene's (1024x2048 by default);
- with ``--variants``, per case also ``variants``: the same times for the
  three other forms of the kernel that csrc/env_variants.cu keeps as an
  instrument (a 16-byte texel, four rays a thread, staged stores), each
  first held bit for bit against the kernel's output, the rounds taken in
  turns with the kernel's;
- ``eager_frame_ms``: with ``--scene``, the median and least of 5 timings
  (CUDA events; the frame's ~10 ms outlast the spin, so host included) of
  one frame of the eager integrator over the ``cuda`` backend
  (`integrator.render_image` with `ops.backends.get_backend("cuda")`: one
  closest-hit and one env launch per bounce round), and the launches it
  made;
- the card line (nvidia-smi name and power limit).

``--device cuda`` only: there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from refraction_tpu_torch import bounds
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.integrator import render_image
from refraction_tpu_torch.io.primitives import make_cube, make_gradient_envmap
from refraction_tpu_torch.kernels._build import check, library
from refraction_tpu_torch.kernels.envmap import env_contribution
from refraction_tpu_torch.kernels.intersect import closest_hit
from refraction_tpu_torch.ops.backends import get_backend
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.run import build_config
from refraction_tpu_torch.scene import build_scene, load_scene, scene_from_jax
from refraction_tpu_torch.timing import card_line, card_ms, require_device

ROUNDS, LAUNCHES = 5, 20
# (rays, share of weights > 0)
CASES = ((1 << 16, 0.8), (786_432, 0.1), (3_145_728, 0.1))


def env_inputs(n: int, live_share: float, device, seed: int = 0):
    """(dirs (n, 3) uniform on the sphere, weight (n,) with about
    ``live_share`` of the entries in (0, 1) and the rest 0)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = np.where(rng.random(n) < live_share, rng.random(n), 0.0)
    return (torch.from_numpy(d).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device))


VARIANTS = {"texel16": 1, "rays4": 2, "staged": 3}  # csrc/env_variants.cu


def env_variant(variant: int, scene, env4, dirs, weight):
    """One launch of form ``variant`` of csrc/env_variants.cu: (N, 3).
    ``env4`` is the scene's map as contiguous float32 (H, W, 4)."""
    n = dirs.shape[0]
    out = torch.empty(n, 3, dtype=torch.float32, device=dirs.device)
    env = scene.envmap
    check(library().rt_env_variant(
        variant, env.data_ptr(), env4.data_ptr(), env.shape[0], env.shape[1],
        dirs.data_ptr(), weight.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dirs.device).cuda_stream),
        "rt_env_variant")
    return out


def summary(ms: list[float]) -> dict:
    return {"ms": ms, "ms_median": statistics.median(ms), "ms_min": min(ms)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    for flag in ("--scene", "--envmap"):
        p.add_argument(flag)
    for flag in ("--width", "--height", "--bounces", "--spp"):
        p.add_argument(flag, type=int)
    p.add_argument("--variants", action="store_true",
                   help="also time the forms of csrc/env_variants.cu")
    p.add_argument("--label", default="", help="name printed with the result")
    args = p.parse_args(argv)
    device = require_device("cuda")
    out = {"label": args.label, "env_ms": [], "eager_frame_ms": None}
    if args.scene:
        cfg = build_config(args)
        scene = scene_from_jax(load_scene(cfg)[0], device)
    else:
        scene = scene_from_jax(build_scene(
            make_cube(2.0), make_gradient_envmap(1024, 2048), 8)[0], device)
    env = scene.envmap
    env4 = torch.cat([env, torch.zeros_like(env[..., :1])], dim=2).contiguous()
    for n, share in CASES:
        d, w = env_inputs(n, share, device)
        forms = {"kernel": lambda: env_contribution(scene, d, w)}
        if args.variants:
            want = env_contribution(scene, d, w)
            for name, v in VARIANTS.items():
                forms[name] = (lambda v=v: env_variant(v, scene, env4, d, w))
                if not torch.equal(forms[name](), want):
                    raise AssertionError(
                        f"env variant {name} differs from the kernel at "
                        f"{n} rays")
        ms = {name: [] for name in forms}
        for _ in range(ROUNDS):
            for name, fn in forms.items():
                ms[name].append(card_ms(fn, LAUNCHES, device))
        live = int((w > 0).sum())
        case = {"rays": n, "live": live, **summary(ms.pop("kernel")),
                "bound_ms": bounds.env_bound(scene, n, live)["bound_ms"]}
        if args.variants:
            case["variants"] = {name: summary(v) for name, v in ms.items()}
        out["env_ms"].append(case)
    if args.scene:
        backend = get_backend("cuda")
        frame = orbit_camera(0.01, cfg)

        def eager():
            return render_image(scene, frame, cfg, sample_offsets(cfg.spp),
                                device, backend.intersect,
                                backend.env_contribution)

        before = (closest_hit.launches, env_contribution.launches)
        eager()
        made = (closest_hit.launches - before[0],
                env_contribution.launches - before[1])
        out["eager_frame_ms"] = {
            "shape": [cfg.width, cfg.height, cfg.max_refract_depth, cfg.spp],
            **summary([card_ms(eager, 1, device) for _ in range(ROUNDS)]),
            "closest_hit_launches": made[0], "env_launches": made[1]}
    out["card"] = card_line(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
