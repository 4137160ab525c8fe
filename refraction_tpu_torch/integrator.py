"""Eager wavefront integrator: port of `refraction_tpu.integrator.render_pixels`.

The reference's bounded per-pixel ray tree flattened level by level, with
static widths: the front at count k is ``N * 2^min(k, max_reflect)`` wide.
A refraction child overwrites its parent's slot (weight * (1 - R), side
flipped, dead on TIR); a reflection child is appended at ``slot + width``
(weight * R, same side) on every hit, TIR included, while
``count < max_reflect``. Misses add weight * env; hits at the depth cap add
black. Slot ``i`` always belongs to pixel ``i % N``.

This is the plain version of the CUDA frame kernel
(kernels/framekernel.py), which runs the same tree depth-first per pixel.

`render_pixels_mega` is the per-round wavefront (port of
`refraction_tpu.integrator.render_pixels_mega`): the same tree, one
round-kernel launch per bounce round (kernels/megakernel.py), carrying
only live lanes from one round to the next. Each queued lane keeps its
slot in the static layout above, so its pixel, the stats and the
per-pixel sums are the static layout's. `static_wavefront` runs the same
rounds in the static layout, as the reference it is held against.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.camera import CameraFrame, generate_rays
from refraction_tpu_torch.kernels.megakernel import (
    STATE_ROWS,
    LaneQueue,
    QueueRound,
    empty_queue,
    mega_round,
    slot_order_sum,
)
from refraction_tpu_torch.ops.intersect import interpolate_normal, recompute_uv
from refraction_tpu_torch.ops.shade import (
    dot3,
    f32,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)


def _shade_hits(scene, o, d, outside, t, tri_idx, cfg: RenderConfig,
                knorm=None):
    """ClosestHit math (RayTracing.hlsl:79-123) for a batch of rays.

    Returns (hit_point, n_prime, fresnel_R, refract_ok, refract_dir); only
    meaningful where the caller's hit mask is True. ``knorm`` is the
    backend's interpolated normal, if it gives one."""
    if knorm is None:
        u, v = recompute_uv(o, d, scene.tri_a, scene.tri_e1, scene.tri_e2,
                            tri_idx)
        knorm = interpolate_normal(scene.tri_norm_packed, tri_idx, u, v)
    nsh = normalize(knorm)
    nprime = torch.where(outside[:, None], nsh, -nsh)
    hit_p = o + t[:, None] * d
    r = fresnel_r(dot3(d, nprime), cfg.fresnel_r0)
    eta = torch.where(outside, torch.full_like(t, f32(1.0 / cfg.ior)),
                      torch.full_like(t, f32(cfg.ior)))
    ok, refr = refract_dir(d, nprime, eta)
    return hit_p, nprime, r, ok, refr


def render_pixels(scene, origins: torch.Tensor, dirs: torch.Tensor,
                  cfg: RenderConfig, intersect_fn: Callable,
                  env_fn: Callable, collect_stats: bool = False,
                  ray_mask: torch.Tensor | None = None):
    """Trace N primary rays to completion; returns (N, 3) linear radiance.

    ``env_fn(scene, dirs, weight) -> (W, 3)`` is the weighted miss
    contribution (weight already zero on non-miss lanes). With
    ``collect_stats`` returns (radiance, {'rays_traced': int64 scalar
    tensor, 'slot_rounds': int, 'pixel_rays': (N,) int32}): live lanes
    entering each trace round, dense slots, and the per-pixel live
    ray-tree size.

    ``ray_mask`` ((N,) int): per-ray DXR InstanceInclusionMask (TraceRay's
    mask, RayTracing.hlsl:60; the reference passes 0xff). Children inherit
    their parent's mask, as every recursive TraceRay re-passes it. It
    needs a mask-capable ``intersect_fn`` (the ``torch`` backend); the
    ``cuda`` backend raises on it.
    """
    n = origins.shape[0]
    dev = origins.device
    f32t = torch.float32
    safe_dir = torch.tensor([0.0, 1.0, 0.0], dtype=f32t, device=dev)

    o = origins.to(f32t)
    d = dirs.to(f32t)
    weight = torch.ones(n, dtype=f32t, device=dev)
    outside = torch.ones(n, dtype=torch.bool, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    radiance = torch.zeros(n, 3, dtype=f32t, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    pixel_rays = torch.zeros(n, dtype=torch.int32, device=dev)
    mask_pool = None if ray_mask is None else ray_mask.to(torch.int32)
    slot_rounds = 0
    zero = torch.zeros((), dtype=f32t, device=dev)

    for count in range(cfg.max_refract_depth + 1):
        if collect_stats:
            rays_traced = rays_traced + alive.sum()
            pixel_rays = pixel_rays + alive.reshape(-1, n).sum(
                dim=0, dtype=torch.int32)
            slot_rounds += int(o.shape[0])
        tmin = cfg.primary_tmin if count == 0 else cfg.secondary_tmin
        tmax = cfg.primary_tmax if count == 0 else cfg.secondary_tmax

        if mask_pool is None:
            res = intersect_fn(scene, o, d, outside, alive, tmin, tmax)
        else:
            res = intersect_fn(scene, o, d, outside, alive, tmin, tmax,
                               ray_mask=mask_pool)
        hit, t, tri_idx, knorm = res
        hit = hit & alive

        miss_weight = torch.where(alive & ~hit, weight, zero)
        radiance = radiance + env_fn(scene, d, miss_weight).reshape(
            -1, n, 3).sum(dim=0)

        if count == cfg.max_refract_depth:
            break  # hits at the cap contribute black (RayTracing.hlsl:82)

        hit_p, nprime, r, refr_ok, refr = _shade_hits(
            scene, o, d, outside, t, tri_idx, cfg, knorm=knorm)
        safe_o = torch.where(hit[:, None], hit_p, o)

        refr_alive = hit & refr_ok
        new_d = torch.where(refr_alive[:, None], refr, safe_dir)
        new_weight = torch.where(refr_alive, weight * (1.0 - r), zero)
        new_outside = torch.where(hit, ~outside, outside)

        if count < cfg.max_reflect_depth:
            refl = normalize(reflect_dir(d, nprime))
            refl_d = torch.where(hit[:, None], refl, safe_dir)
            refl_weight = torch.where(hit, weight * r, zero)
            o = torch.cat([safe_o, safe_o])
            d = torch.cat([new_d, refl_d])
            weight = torch.cat([new_weight, refl_weight])
            outside = torch.cat([new_outside, outside])
            alive = torch.cat([refr_alive, hit])
            if mask_pool is not None:
                mask_pool = torch.cat([mask_pool, mask_pool])
        else:
            o, d = safe_o, new_d
            weight, outside, alive = new_weight, new_outside, refr_alive

    if collect_stats:
        return radiance, {"rays_traced": rays_traced,
                          "slot_rounds": slot_rounds,
                          "pixel_rays": pixel_rays}
    return radiance


def render_image(scene, frame: CameraFrame, cfg: RenderConfig,
                 offsets: np.ndarray, device: torch.device | str,
                 intersect_fn: Callable, env_fn: Callable) -> torch.Tensor:
    """(H, W, 3) image: for each (x, y) jitter pair of ``offsets`` (spp, 2),
    the primary rays through `render_pixels`; averaged over samples."""
    acc = None
    for off in offsets:
        o, d = generate_rays(frame, cfg.width, cfg.height, device, jitter=off)
        rad = render_pixels(scene, o, d, cfg, intersect_fn, env_fn)
        acc = rad if acc is None else acc + rad
    inv_spp = float(np.float32(1.0 / len(offsets)))
    return (acc * inv_spp).reshape(cfg.height, cfg.width, 3)


def initial_state(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(8, N) float32 lane state of N primary rays: outside, weight 1."""
    state = torch.empty(STATE_ROWS, origins.shape[0], dtype=torch.float32,
                        device=origins.device)
    state[0:3] = origins.t()
    state[3:6] = dirs.t()
    state[6:8] = 1.0
    return state


def round_params(cfg: RenderConfig, count: int):
    """(limits, want_reflect, want_children) of bounce round ``count``:
    primary or secondary ray interval, and which children it emits."""
    primary = count == 0
    limits = (cfg.primary_tmin if primary else cfg.secondary_tmin,
              cfg.primary_tmax if primary else cfg.secondary_tmax,
              cfg.ior, cfg.fresnel_r0)
    want_children = count < cfg.max_refract_depth
    want_reflect = want_children and count < cfg.max_reflect_depth
    return limits, want_reflect, want_children


def static_widths(cfg: RenderConfig, n: int) -> list[int]:
    """The static lane width of each bounce round: N, doubled after each
    round that emits reflection children."""
    widths = [n]
    for count in range(cfg.max_refract_depth):
        widths.append(widths[-1] * (2 if round_params(cfg, count)[1] else 1))
    return widths


def wavefront_rounds(scene, origins: torch.Tensor, dirs: torch.Tensor,
                     cfg: RenderConfig):
    """The bounce-round schedule of `render_pixels_mega`: yields, per round,
    ``(queue, out, run)``: the round's `LaneQueue` of live lanes (round 0:
    all N primaries, slot i = i), the next round's queue (None after the
    last round) with its count 0, and ``run(radiance, pixel_rays=None)``,
    which runs the round (`mega_round_queue`, through one `QueueRound` for
    the frame) on ``queue``, appending the live children to ``out``.

    The consumer calls ``run`` once before it asks for the next round. A
    consumer that calls it again (`profile_rounds`) zeroes ``out.count``
    before each further call, or the children are appended twice. Two
    ping-pong buffers of the largest static width hold the queues; each
    queue's count is one int32 of a device array, read by no host code
    here."""
    n = origins.shape[0]
    dev = origins.device
    widths = static_widths(cfg, n)
    counts = torch.zeros(len(widths), dtype=torch.int32, device=dev)
    counts[:1].fill_(n)  # a fill kernel; item assignment would sync
    bufs = [empty_queue(max(widths), dev) for _ in range(min(2, len(widths)))]
    state, slot = bufs[0]
    state[0:3, :n] = origins.t()
    state[3:6, :n] = dirs.t()
    state[6:8, :n] = 1.0
    torch.arange(n, out=slot[:n])
    round_fn = QueueRound(scene, dev)
    for count, width in enumerate(widths):
        limits, want_reflect, want_children = round_params(cfg, count)
        queue = LaneQueue(*bufs[count % 2], counts[count:count + 1], width)
        out = (LaneQueue(*bufs[(count + 1) % 2],
                         counts[count + 1:count + 2], widths[count + 1])
               if want_children else None)

        def run(radiance, pixel_rays=None, queue=queue, out=out,
                limits=limits, want_reflect=want_reflect,
                want_children=want_children):
            round_fn(queue, limits, want_reflect, want_children, radiance,
                     pixel_rays, out)

        yield queue, out, run
        if not want_children:
            return  # hits at the cap contribute black (RayTracing.hlsl:82)


def render_pixels_mega(scene, origins: torch.Tensor, dirs: torch.Tensor,
                       cfg: RenderConfig, collect_stats: bool = False):
    """Trace N primary rays to completion, one compacted round
    (`mega_round_queue`) per bounce round (`wavefront_rounds`); returns
    (N, 3) linear radiance.

    On CUDA tensors each round is one round-kernel launch and nothing
    waits for the host; on CPU tensors the rounds take their plain
    version. N may be any positive count. Each round adds its per-pixel
    sum (a pixel's misses in slot order) to the one running (N, 3)
    radiance, ``radiance + round sum`` round after round, as the static
    layout associates them: the image equals `static_wavefront`'s bit for
    bit and is the same on every run. With ``collect_stats`` returns (radiance,
    {'rays_traced': int64 scalar tensor, 'slot_rounds': int, 'pixel_rays':
    (N,) int32}): the queue counts summed on the device (the live lanes
    entering each round), the static widths of every round, and the
    queued lanes per pixel.
    """
    n = origins.shape[0]
    dev = origins.device
    radiance = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    pixel_rays = (torch.zeros(n, dtype=torch.int32, device=dev)
                  if collect_stats else None)
    counts = []
    for queue, _, run in wavefront_rounds(scene, origins, dirs, cfg):
        run(radiance, pixel_rays)
        counts.append(queue.count)
    if collect_stats:
        return radiance, {
            "rays_traced": torch.cat(counts).sum(dtype=torch.int64),
            "slot_rounds": sum(static_widths(cfg, n)),
            "pixel_rays": pixel_rays}
    return radiance


def static_wavefront(scene, origins: torch.Tensor, dirs: torch.Tensor,
                     cfg: RenderConfig, collect_stats: bool = False):
    """The wavefront in the static layout, the reference `render_pixels_mega`
    is held against (the JAX `render_pixels_mega`'s layout): every round's
    whole (8, W) state through `mega_round`, dead lanes included, and its
    radiance summed over each pixel's lanes in slot order
    (`slot_order_sum`). Returns what
    `render_pixels_mega` returns, the stats counted from the states: live
    lanes per round and per pixel, and the state widths."""
    n = origins.shape[0]
    dev = origins.device
    state = initial_state(origins, dirs)
    radiance = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    pixel_rays = torch.zeros(n, dtype=torch.int32, device=dev)
    slot_rounds = 0
    for count in range(cfg.max_refract_depth + 1):
        limits, want_reflect, want_children = round_params(cfg, count)
        if collect_stats:
            live = state[6] != 0
            rays = rays + live.sum()
            pixel_rays = pixel_rays + live.reshape(-1, n).sum(
                dim=0, dtype=torch.int32)
            slot_rounds += state.shape[1]
        res = mega_round(scene, state, limits, want_reflect, want_children)
        radiance = radiance + slot_order_sum(res.radiance, n)
        state = res.children
    if collect_stats:
        return radiance, {"rays_traced": rays, "slot_rounds": slot_rounds,
                          "pixel_rays": pixel_rays}
    return radiance
