"""Round kernel wrapper (``csrc/round.cu``): port of
`refraction_tpu.kernels.megakernel` ``mega_round``.

One wavefront bounce round over an (8, W) float32 lane state, rows
``ox oy oz dx dy dz cull wgt`` (cull = +1 outside, -1 inside, 0 dead):
closest hit, the weighted env radiance of live misses, and the
ClosestHit shading that emits the children. Three variants, as the JAX
kernel's three bodies:

- ``want_children and want_reflect``: refraction and reflection children,
  next state (8, 2W) with the refraction child of lane i at i and its
  reflection child at W + i (the JAX integrator's concatenation);
- ``want_children`` only: the refraction child, next state (8, W);
- neither: radiance only (the depth-cap round, where hits add black).

A refraction child is alive where its parent hit and did not totally
internally reflect; a reflection child on every hit. Dead children have
cull 0, weight 0 and direction (0, 1, 0); their origin is the hit point,
or the parent's origin where it did not hit.

``mega_round`` launches the kernel for CUDA tensors and takes the plain
version, ``mega_round_plain``, for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from refraction_tpu_torch.kernels._build import check, library
from refraction_tpu_torch.kernels.envmap import check_envmap, env_contribution_plain
from refraction_tpu_torch.kernels.intersect import check_scene_tables, closest_hit_plain
from refraction_tpu_torch.ops.shade import (
    dot3,
    f32,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)

STATE_ROWS = 8  # ox oy oz dx dy dz cull wgt
# Variant codes of rt_round (RtRoundVariant in round.cu).
_FULL, _CHILDREN, _RADIANCE = 0, 1, 2


class RoundOut(NamedTuple):
    """What one round produces."""

    radiance: torch.Tensor          # (W, 3) weighted env radiance of misses
    children: torch.Tensor | None   # (8, 2W) | (8, W) next state, or None


def _check_state(state: torch.Tensor) -> None:
    if (state.dim() != 2 or state.shape[0] != STATE_ROWS
            or state.dtype != torch.float32 or not state.is_contiguous()):
        raise ValueError(
            f"state: want contiguous float32 ({STATE_ROWS}, W), got "
            f"{state.dtype} {tuple(state.shape)}")


def _limits(limits: Sequence[float]) -> tuple[float, float, float, float]:
    if len(limits) != 4:
        raise ValueError(f"limits: want (tmin, tmax, ior, fresnel_r0), got "
                         f"{limits!r}")
    return tuple(f32(x) for x in limits)


def mega_round_plain(scene, state: torch.Tensor, limits: Sequence[float],
                     want_reflect: bool, want_children: bool) -> RoundOut:
    """The round in plain PyTorch: brute-force closest hit, gather env and
    the shading ops of ops/shade.py, in the kernel's float32 order."""
    _check_state(state)
    tmin, tmax, ior, r0 = _limits(limits)
    dev = state.device
    o, d = state[0:3].t(), state[3:6].t()
    cull, wgt = state[6], state[7]
    t, idx, normal = closest_hit_plain(scene, o, d, cull, tmin, tmax)
    hit = idx >= 0  # False on dead lanes
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    radiance = env_contribution_plain(
        scene, d, torch.where((cull != 0) & ~hit, wgt, zero))
    if not want_children:
        return RoundOut(radiance, None)

    outside = cull > 0
    n = normalize(normal)
    nprime = torch.where(outside[:, None], n, -n)
    r = fresnel_r(dot3(d, nprime), r0)
    # eta = 1/ior in float32 from the float32 ior, as the kernel computes
    # it; a device-tensor divide, since CUDA divides by a Python scalar as
    # a multiply by its reciprocal.
    ior_t = torch.tensor(ior, dtype=torch.float32, device=dev)
    eta = torch.where(outside, torch.ones_like(ior_t) / ior_t, ior_t)
    ok, refr = refract_dir(d, nprime, eta)
    safe_dir = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    safe_o = torch.where(hit[:, None], o + t[:, None] * d, o)
    refr_alive = hit & ok
    rows = [safe_o.t(),
            torch.where(refr_alive[:, None], refr, safe_dir).t(),
            torch.where(refr_alive, -cull, zero)[None],
            torch.where(refr_alive, wgt * (1.0 - r), zero)[None]]
    children = torch.cat(rows)
    if want_reflect:
        refl = normalize(reflect_dir(d, nprime))
        rows = [safe_o.t(),
                torch.where(hit[:, None], refl, safe_dir).t(),
                torch.where(hit, cull, zero)[None],
                torch.where(hit, wgt * r, zero)[None]]
        children = torch.cat([children, torch.cat(rows)], dim=1)
    return RoundOut(radiance, children.contiguous())


def mega_round(scene, state: torch.Tensor, limits: Sequence[float],
               want_reflect: bool, want_children: bool) -> RoundOut:
    """One bounce round of the (8, W) lane ``state`` (see the module doc).

    ``limits`` = (tmin, tmax, ior, fresnel_r0), rounded to float32 and
    passed to the kernel by value. On CUDA: one launch on the current
    stream, no host sync.
    """
    _check_state(state)
    if state.device.type == "cpu":
        return mega_round_plain(scene, state, limits, want_reflect,
                                want_children)
    if state.device.type != "cuda":
        raise ValueError(f"mega_round: unsupported device {state.device}")
    tmin, tmax, ior, r0 = _limits(limits)
    dev = state.device
    check_scene_tables(scene, dev)
    check_envmap(scene, dev)
    w = state.shape[1]
    variant = (_RADIANCE if not want_children
               else _FULL if want_reflect else _CHILDREN)
    rad = torch.empty(w, 3, dtype=torch.float32, device=dev)
    children = None
    if variant != _RADIANCE:
        children = torch.empty(STATE_ROWS, 2 * w if variant == _FULL else w,
                               dtype=torch.float32, device=dev)
    if w == 0:
        return RoundOut(rad, children)
    env = scene.envmap
    err = library().rt_round(
        tmin, tmax, ior, r0, scene.tri_packed.data_ptr(),
        scene.tri_norm_packed.data_ptr(), scene.super_bounds.data_ptr(),
        scene.cluster_bounds.data_ptr(), scene.sub_bounds.data_ptr(),
        env.data_ptr(), state.data_ptr(), w, rad.data_ptr(),
        None if children is None else children.data_ptr(), variant,
        scene.num_supers, scene.num_clusters, scene.cluster_size,
        scene.sub_tris,
        env.shape[0], env.shape[1],
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "rt_round")
    mega_round.launches += 1
    return RoundOut(rad, children)


mega_round.launches = 0
