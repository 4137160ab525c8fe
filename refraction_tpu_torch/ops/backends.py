"""Intersection + env backends for the eager integrator: port of
`refraction_tpu/ops/backends.py`.

Both follow the IntersectFn contract of integrator.py:
  (scene, origins, dirs, want_front, alive, tmin, tmax, ray_mask=None)
      -> (hit, t, tri_idx, normal | None)

- ``torch``: the brute force of ops/intersect.py plus a gather env
  contribution. Runs on any device; the plain reference. It serves
  per-ray DXR inclusion masks (``ray_mask``) against ``scene.tri_mask``.
- ``cuda``: the thin closest-hit and env kernels (kernels/intersect.py,
  kernels/envmap.py). On CPU tensors their wrappers take their plain
  versions. The kernels serve the reference's constant 0xff mask only, as
  the Pallas backends do, and raise on a ``ray_mask``.

`instance_intersect` is no backend of its own: the intersect of a
two-level scene (`scene.InstancedTorchScene`) through the frame kernel's
instance walk, which the eager integrator renders unbaked (with the
``cuda`` backend's env), to hold the frame kernel's instance walk to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from refraction_tpu_torch.kernels.envmap import (
    env_contribution,
    env_contribution_plain,
)
from refraction_tpu_torch.kernels.intersect import (
    closest_hit,
    cull_code,
    instance_hit,
)
from refraction_tpu_torch.ops.intersect import intersect_closest


def torch_intersect(scene, origins, dirs, want_front, alive, tmin, tmax,
                    ray_mask=None):
    """Brute-force closest hit. ``alive`` is unused (dense evaluation; the
    integrator masks).

    ``ray_mask`` ((N,) int32): DXR's per-TraceRay InstanceInclusionMask;
    triangle j is testable by ray i iff ``scene.tri_mask[j] & ray_mask[i]
    != 0``. A mask on a scene without ``tri_mask`` raises ValueError (the
    JAX ``xla_intersect`` ignores the mask there)."""
    del alive
    tri_mask = None
    if ray_mask is not None:
        if scene.tri_mask is None:
            raise ValueError("ray_mask given but scene.tri_mask is None: "
                             "the scene has no instance masks to test")
        tri_mask = scene.tri_mask
    hit, t, idx = intersect_closest(origins, dirs, scene.tri_a, scene.tri_e1,
                                    scene.tri_e2, tmin, tmax, want_front,
                                    tri_mask, ray_mask)
    return hit, t, idx, None


def cuda_intersect(scene, origins, dirs, want_front, alive, tmin, tmax,
                   ray_mask=None):
    """Closest hit through the CUDA traversal kernel; returns the winner's
    unnormalized interpolated normal too. Per-ray masks raise ValueError:
    the kernel serves the constant 0xff mask."""
    if ray_mask is not None:
        raise ValueError("cuda_intersect serves the constant 0xff mask only; "
                         "per-ray masks need the 'torch' backend")
    t, idx, normal = closest_hit(scene, origins.contiguous(),
                                 dirs.contiguous(),
                                 cull_code(want_front, alive), tmin, tmax)
    return idx >= 0, t, idx, normal


def instance_intersect(scene, origins, dirs, want_front, alive, tmin, tmax,
                       ray_mask=None):
    """Closest hit in a two-level scene through the instance walk
    (`instance_hit`; on CPU tensors its eager twin): the winner's key in
    place of a triangle index, and its normal in world space. Per-ray
    masks raise ValueError, as `cuda_intersect`'s do."""
    if ray_mask is not None:
        raise ValueError("instance_intersect serves the constant 0xff mask "
                         "only")
    t, key, normal = instance_hit(scene, origins.contiguous(),
                                  dirs.contiguous(),
                                  cull_code(want_front, alive), tmin, tmax)
    return key >= 0, t, key, normal



def cuda_env_contribution(scene, dirs, weight):
    return env_contribution(scene, dirs.contiguous(), weight.contiguous())


class Backend(NamedTuple):
    """An intersect + env-shading implementation pair."""

    name: str
    intersect: Callable
    env_contribution: Callable


def get_backend(name: str) -> Backend:
    """Resolve ``"torch"`` | ``"cuda"`` to a Backend."""
    if name == "torch":
        return Backend("torch", torch_intersect, env_contribution_plain)
    if name == "cuda":
        return Backend("cuda", cuda_intersect, cuda_env_contribution)
    raise ValueError(f"unknown backend: {name!r} (use 'torch' or 'cuda')")
