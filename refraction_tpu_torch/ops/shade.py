"""Shading math in PyTorch: port of `refraction_tpu/ops/shade.py`.

Each function reproduces the HLSL of the reference as the JAX/numpy
version does (RayTracing.hlsl):

- ``reflect_dir``  <- ReflectRay (hlsl:66-68)
- ``refract_dir``  <- RefractRay (hlsl:70-76): returns a TIR mask and the
  normalized direction.
- ``fresnel_r``    <- the reference's nonstandard Schlick
  ``R0 (1 - R0) (1 - d.n)^5`` (hlsl:92-93), not textbook Schlick.
- ``envmap_color`` <- Miss (hlsl:127-137): equirect texel-index fetch with
  pi = 3.14159, true atan2/acos, truncation toward zero, then a clamp to
  the edge texel.

All math is float32. Dot products are written out as ``x0*y0 + x1*y1 +
x2*y2`` so that they round in the same order as numpy's 3-element sums.
"""

from __future__ import annotations

import numpy as np
import torch

from refraction_tpu_torch.config import REF_PI_ENVMAP


def f32(x: float) -> float:
    """A Python float holding exactly the float32 value of ``x``."""
    return float(np.float32(x))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(dot3(v, v))[..., None]


def reflect_dir(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """ReflectRay: I - 2 dot(N, I) N."""
    return i - (2.0 * dot3(n, i))[..., None] * n


def refract_dir(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """RefractRay. Returns (ok, unit direction); where ``ok`` is False
    (total internal reflection) the direction is garbage. ``eta`` is
    per-ray, shaped (...,)."""
    cosi = dot3(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    ok = k >= 0.0
    k_safe = torch.where(ok, k, torch.zeros_like(k))
    r = eta[..., None] * i - (eta * cosi + torch.sqrt(k_safe))[..., None] * n
    denom = torch.sqrt(dot3(r, r))
    r = r / torch.where(denom > 0, denom, torch.ones_like(denom))[..., None]
    return ok, r


def fresnel_r(dot_d_n: torch.Tensor, r0: float) -> torch.Tensor:
    """Nonstandard Schlick; ``dot_d_n`` = dot(D, N'), ``r0`` a float32
    value."""
    base = 1.0 - dot_d_n
    scale = f32(np.float32(r0) * (np.float32(1.0) - np.float32(r0)))
    return scale * (base * base) * (base * base) * base


def envmap_texel(dirs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Flat texel index ``iy * W + ix`` of each direction (hlsl:133-134)."""
    # pi is a device tensor: CUDA divides a tensor by a Python scalar as a
    # multiply by its reciprocal, which is not the IEEE quotient.
    pi = torch.tensor(REF_PI_ENVMAP, dtype=torch.float32, device=dirs.device)
    theta = float(width) * (torch.atan2(dirs[..., 0], dirs[..., 2]) / pi + 1.0) / 2.0
    phi = float(height) * (torch.acos(torch.clamp(dirs[..., 1], -1.0, 1.0)) / pi)
    ix = torch.clamp(theta.to(torch.int32), 0, width - 1)
    iy = torch.clamp(phi.to(torch.int32), 0, height - 1)
    return iy.to(torch.int64) * width + ix.to(torch.int64)


def envmap_color(dirs: torch.Tensor, envmap: torch.Tensor) -> torch.Tensor:
    """Miss shader: the (..., 3) texel each direction looks up."""
    h, w = envmap.shape[0], envmap.shape[1]
    return envmap.reshape(-1, 3)[envmap_texel(dirs, h, w)]
