"""Env kernel wrapper (``csrc/env.cu`` around ``csrc/envmap.cuh``): port of
`refraction_tpu.kernels.envmap_pallas` ``pallas_env_contribution`` /
``_env_call``.

``env_contribution`` launches the kernel for CUDA tensors and takes the
plain version, ``env_contribution_plain`` (a gather), for CPU tensors.
"""

from __future__ import annotations

import torch

from refraction_tpu_torch.kernels._build import launch
from refraction_tpu_torch.ops.shade import envmap_color


def check_envmap(scene, device: torch.device) -> None:
    """The kernels read the map as contiguous float32 (H, W, 3) on
    ``device``."""
    env = scene.envmap
    if (env.device != device or env.dtype != torch.float32 or env.dim() != 3
            or env.shape[2] != 3 or not env.is_contiguous()):
        raise ValueError(
            f"scene.envmap: want contiguous float32 (H, W, 3) on {device}, "
            f"got {env.dtype} {tuple(env.shape)} on {env.device}")


def env_contribution_plain(scene, dirs, weight):
    """Weighted miss contribution ``where(weight > 0, weight * env, 0)``."""
    env = envmap_color(dirs, scene.envmap)
    return torch.where(weight[:, None] > 0, weight[:, None] * env,
                       torch.zeros_like(env))


def env_contribution(scene, dirs, weight):
    """weight[i] * envmap(dirs[i]) where weight[i] > 0, else 0: (N, 3).

    ``dirs`` (N, 3) and ``weight`` (N,) float32 contiguous tensors.
    """
    n = dirs.shape[0]
    for name, x, shape in (("dirs", dirs, (n, 3)), ("weight", weight, (n,))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != dirs.device or not x.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous float32 {shape} on {dirs.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dirs.device.type == "cpu":
        return env_contribution_plain(scene, dirs, weight)
    if dirs.device.type != "cuda":
        raise ValueError(f"env_contribution: unsupported device {dirs.device}")
    check_envmap(scene, dirs.device)
    env = scene.envmap
    out = torch.empty(n, 3, dtype=torch.float32, device=dirs.device)
    if n == 0:
        return out
    launch("rt_env", dirs.device, env.data_ptr(), env.shape[0],
           env.shape[1], dirs.data_ptr(), weight.data_ptr(), n,
           out.data_ptr())
    env_contribution.launches += 1
    return out


env_contribution.launches = 0
