"""Intersection + env backends for the eager integrator: port of
`refraction_tpu/ops/backends.py`.

Both follow the IntersectFn contract of integrator.py:
  (scene, origins, dirs, want_front, alive, tmin, tmax)
      -> (hit, t, tri_idx, normal | None)

- ``torch``: the brute force of ops/intersect.py plus a gather env
  contribution. Runs on any device; the plain reference.
- ``cuda``: the thin closest-hit and env kernels (kernels/intersect.py,
  kernels/envmap.py). On CPU tensors their wrappers take their plain
  versions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from refraction_tpu_torch.kernels.envmap import (
    env_contribution,
    env_contribution_plain,
)
from refraction_tpu_torch.kernels.intersect import closest_hit, cull_code
from refraction_tpu_torch.ops.intersect import intersect_closest


def torch_intersect(scene, origins, dirs, want_front, alive, tmin, tmax):
    """Brute-force closest hit. ``alive`` is unused (dense evaluation; the
    integrator masks)."""
    del alive
    hit, t, idx = intersect_closest(origins, dirs, scene.tri_a, scene.tri_e1,
                                    scene.tri_e2, tmin, tmax, want_front)
    return hit, t, idx, None


def cuda_intersect(scene, origins, dirs, want_front, alive, tmin, tmax):
    """Closest hit through the CUDA traversal kernel; returns the winner's
    unnormalized interpolated normal too."""
    t, idx, normal = closest_hit(scene, origins.contiguous(),
                                 dirs.contiguous(),
                                 cull_code(want_front, alive), tmin, tmax)
    return idx >= 0, t, idx, normal


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
