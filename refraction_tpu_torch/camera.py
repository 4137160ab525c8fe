"""Camera: the reference's matrix chain (numpy) and primary ray generation
(PyTorch). Copy of `refraction_tpu.camera` (perspective_fov_lh,
translation, look_at_lh, CameraFrame, orbit_camera) plus the port of its
``generate_rays``.

Reproduces RefractionDemo.cpp:559-567 + RayTracing.hlsl:27-40 including the
quirks that must be kept for pixel parity:

- ``proj * world * view`` composition order (RefractionDemo.cpp:563) —
  DirectXMath ``operator*`` is a plain row-major matrix product, so the
  composite is ``A = proj @ world @ view`` of the row-major arrays.
- The C++ uploads ``XMMATRIX`` memory directly (copy_to_buffer,
  RefractionDemo.cpp:566) with no transpose, while HLSL's default cbuffer
  packing is **column-major**; combined with HLSL ``mul(rowvec, M)``
  (RayTracing.hlsl:35) the net effect is a standard column-vector transform
  by the row-major inverse:  ``R = inv(A) @ [sx, sy, 0, 1]``.
- ``dir = normalize(R.xyz)`` with **no w-divide** (RayTracing.hlsl:39).
- The LookAt eye sits on a *unit* circle at angle ``-theta`` while the ray
  origin is the camera location on a radius-5 circle at ``+theta``
  (RefractionDemo.cpp:560-562) — reproduced.
- fov uses pi ~= 3.1415 (RefractionDemo.cpp:559), and the aspect is the
  reference's literal 1.333 at exactly 1024x768 (config.RenderConfig).

The matrix builders follow DirectXMath row-major layouts exactly
(XMMatrixPerspectiveFovLH / XMMatrixTranslationFromVector / XMMatrixLookAtLH).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from refraction_tpu_torch.config import RenderConfig


def perspective_fov_lh(fov_y: float, aspect: float, zn: float, zf: float) -> np.ndarray:
    """XMMatrixPerspectiveFovLH, row-major memory layout."""
    h = np.cos(fov_y / 2) / np.sin(fov_y / 2)
    w = h / aspect
    rng = zf / (zf - zn)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = rng
    m[2, 3] = 1.0
    m[3, 2] = -rng * zn
    return m


def translation(v: np.ndarray) -> np.ndarray:
    """XMMatrixTranslationFromVector (xyz used, w ignored)."""
    m = np.eye(4, dtype=np.float64)
    m[3, :3] = v[:3]
    return m


def look_at_lh(eye: np.ndarray, at: np.ndarray, up: np.ndarray) -> np.ndarray:
    """XMMatrixLookAtLH, row-major memory layout."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(at, np.float64) - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.zeros((4, 4), np.float64)
    m[0, :3] = [x[0], y[0], z[0]]
    m[1, :3] = [x[1], y[1], z[1]]
    m[2, :3] = [x[2], y[2], z[2]]
    m[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    m[3, 3] = 1.0
    return m


@dataclasses.dataclass(frozen=True)
class CameraFrame:
    """Per-frame camera state: ray origin + unprojection matrix."""

    origin: np.ndarray    # (3,) float32 — camera_loc.xyz
    proj_inv: np.ndarray  # (4, 4) float32 — inv(proj @ world @ view)


def orbit_camera(angle: float, cfg: RenderConfig) -> CameraFrame:
    """The reference's orbiting camera at a given angle (RefractionDemo.cpp:559-565)."""
    proj = perspective_fov_lh(cfg.fov_y_rad, cfg.resolved_aspect, cfg.z_near, cfg.z_far)
    camera_loc = np.array(
        [cfg.orbit_radius * np.cos(angle), 0.0, cfg.orbit_radius * np.sin(angle), 1.0]
    )
    world = translation(camera_loc)
    view = look_at_lh(
        np.array([np.cos(-angle), 0.0, np.sin(-angle)]),
        np.zeros(3),
        np.array([0.0, 1.0, 0.0]),
    )
    a = proj @ world @ view
    return CameraFrame(
        origin=camera_loc[:3].astype(np.float32),
        proj_inv=np.linalg.inv(a).astype(np.float32),
    )


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
    return pixel_rays(frame, gx.reshape(-1), gy.reshape(-1), width, height,
                      jitter)


def pixel_rays(frame: CameraFrame, gx: torch.Tensor, gy: torch.Tensor,
               width: int, height: int, jitter: np.ndarray | None = None):
    """`generate_rays` for the pixels at float32 columns ``gx`` and rows
    ``gy`` (N,) of a ``width`` x ``height`` image, on their device: each
    ray is the one `generate_rays` gives its pixel, bit for bit."""
    f32 = torch.float32
    device = gx.device
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
