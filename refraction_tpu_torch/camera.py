"""Primary ray generation in PyTorch: port of
`refraction_tpu.camera.generate_rays` (RayTracing.hlsl:27-40).

The camera matrices stay numpy: ``orbit_camera`` and ``CameraFrame`` are
imported from the JAX package, which builds them without JAX (including
the reference's literal aspect 1.333 at exactly 1024x768).
"""

from __future__ import annotations

import numpy as np
import torch

from refraction_tpu.camera import CameraFrame, orbit_camera  # noqa: F401


def generate_rays(frame: CameraFrame, width: int, height: int,
                  device: torch.device | str,
                  jitter: np.ndarray | None = None):
    """Per-pixel primary rays, flattened row-major (y major), N = W*H.

    Returns (origins (N, 3), dirs (N, 3)) float32 on ``device``.
    ``jitter``: optional (N, 2) or (2,) sub-pixel offsets in [0, 1)
    replacing the 0.5 pixel centre. As in the reference: the DirectX y
    flip applies, only ``proj_inv`` columns 0, 1 and 3 are used
    (R = proj_inv @ [sx, sy, 0, 1]) and there is no divide by w.
    """
    f32 = torch.float32
    gy, gx = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    if jitter is None:
        ox = oy = 0.5
    else:
        j = torch.as_tensor(np.asarray(jitter, np.float32), device=device)
        ox, oy = j[..., 0], j[..., 1]
    # Divisors are device tensors: CUDA divides a tensor by a Python scalar
    # as a multiply by its reciprocal, which is not the IEEE quotient.
    w_t = torch.tensor(float(width), dtype=f32, device=device)
    h_t = torch.tensor(float(height), dtype=f32, device=device)
    sx = (gx + ox) / w_t * 2.0 - 1.0
    sy = -((gy + oy) / h_t * 2.0 - 1.0)

    p = [[float(v) for v in row] for row in np.asarray(frame.proj_inv, np.float32)]
    rx = p[0][0] * sx + p[0][1] * sy + p[0][3]
    ry = p[1][0] * sx + p[1][1] * sy + p[1][3]
    rz = p[2][0] * sx + p[2][1] * sy + p[2][3]
    inv_len = 1.0 / torch.sqrt(rx * rx + ry * ry + rz * rz)
    dirs = torch.stack([rx * inv_len, ry * inv_len, rz * inv_len], dim=-1)
    origin = torch.as_tensor(np.asarray(frame.origin, np.float32), device=device)
    return origin.expand_as(dirs), dirs
