"""Frame kernel wrapper (``csrc/frame.cu``): port of
`refraction_tpu.kernels.framekernel` ``frame_call`` / ``fused_radiance`` /
``build_scalars``.

``fused_radiance(scene, scalars, cfg)`` renders one (H, W, 3) frame in ONE
kernel launch for CUDA tensors; for CPU tensors it takes the plain version,
``fused_radiance_plain``, which is the eager wavefront integrator
(integrator.render_pixels over the brute-force backend) fed the same rays.

The TPU path's front-to-back cluster permutation (``front_to_back_scene``)
becomes a per-ray near-to-far walk inside the kernel over the scene's
super and cluster boxes (csrc/traverse_f2b.cuh), so winner indices need
no remapping. The kernel has two instances, chosen at launch from the
scene: `walk_of` names the one a scene takes. A launch that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from refraction_tpu_torch.camera import CameraFrame
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.integrator import render_image
from refraction_tpu_torch.kernels._build import check, library
from refraction_tpu_torch.kernels.envmap import (
    check_envmap,
    env_contribution_plain,
)
from refraction_tpu_torch.kernels.intersect import check_scene_tables
from refraction_tpu_torch.ops.backends import torch_intersect

# Scalar vector layout (as refraction_tpu/kernels/framekernel.py:96-103):
# [0:9] proj_inv rows 0..2 of columns (0, 1, 3) | [9:12] camera origin |
# [12:16] tmin/tmax primary, tmin/tmax secondary | [16] ior | [17] r0 |
# [18:18+2*spp] per-sample jitter (x, y).
N_BASE_SCALARS = 18
# Pending-ray stack slots per thread; must equal RT_MAX_STACK in frame.cu.
MAX_STACK = 8


def build_scalars(frame: CameraFrame, cfg: RenderConfig, offsets: np.ndarray,
                  device: torch.device | str) -> torch.Tensor:
    """Pack the per-frame scalar vector, float32 on ``device``.
    ``offsets`` is the (spp, 2) jitter table of render.sample_offsets."""
    p = np.asarray(frame.proj_inv, np.float32)
    vals = [p[0, 0], p[0, 1], p[0, 3],
            p[1, 0], p[1, 1], p[1, 3],
            p[2, 0], p[2, 1], p[2, 3],
            frame.origin[0], frame.origin[1], frame.origin[2],
            cfg.primary_tmin, cfg.primary_tmax,
            cfg.secondary_tmin, cfg.secondary_tmax,
            cfg.ior, cfg.fresnel_r0]
    for k in range(offsets.shape[0]):
        vals += [float(offsets[k, 0]), float(offsets[k, 1])]
    return torch.from_numpy(np.asarray(vals, np.float32)).to(device)


def _frame_from_scalars(sc: np.ndarray) -> CameraFrame:
    p = np.zeros((4, 4), np.float32)
    for row in range(3):
        p[row, [0, 1, 3]] = sc[3 * row:3 * row + 3]
    return CameraFrame(origin=sc[9:12].copy(), proj_inv=p)


def fused_radiance_plain(scene, scalars: torch.Tensor,
                         cfg: RenderConfig) -> torch.Tensor:
    """The frame kernel's plain version: per sample, the same primary rays
    through the eager wavefront integrator; averaged over samples."""
    sc = scalars.detach().cpu().numpy()
    offsets = sc[N_BASE_SCALARS:N_BASE_SCALARS + 2 * cfg.spp].reshape(-1, 2)
    return render_image(scene, _frame_from_scalars(sc), cfg, offsets,
                        scalars.device, torch_intersect, env_contribution_plain)


def _check_frame_args(scene, scalars, cfg):
    dev = scalars.device
    want = N_BASE_SCALARS + 2 * cfg.spp
    if (scalars.dtype != torch.float32 or tuple(scalars.shape) != (want,)
            or not scalars.is_contiguous()):
        raise ValueError(f"scalars: want contiguous float32 ({want},), got "
                         f"{scalars.dtype} {tuple(scalars.shape)}")
    depth = min(cfg.max_reflect_depth, cfg.max_refract_depth)
    if depth + 1 > MAX_STACK or cfg.max_refract_depth < 0 or depth < 0:
        raise ValueError(
            f"bounce caps ({cfg.max_refract_depth}, {cfg.max_reflect_depth}) "
            f"need a stack of {depth + 1} rays; the kernel holds {MAX_STACK}")
    if cfg.width < 1 or cfg.height < 1 or cfg.spp < 1:
        raise ValueError(f"bad frame shape {cfg.width}x{cfg.height}, "
                         f"spp {cfg.spp}")
    check_scene_tables(scene, dev)
    check_envmap(scene, dev)


def walk_of(scene) -> str:
    """The traversal instance the CUDA kernels take for ``scene``:
    ``"supers"`` (super boxes, walked near to far) or ``"flat"`` (at most
    32 clusters, in table order); traverse_f2b.cuh RtWalk."""
    return "supers" if scene.num_supers > 0 else "flat"


def fused_radiance(scene, scalars: torch.Tensor,
                   cfg: RenderConfig) -> torch.Tensor:
    """(scene, scalar vector, cfg) -> (H, W, 3) float32 linear radiance.

    On CUDA: one launch of the frame kernel on the current stream, which
    writes the image directly. The bounce caps, ray intervals, ior and r0
    are runtime values; the latter come from ``scalars``.
    """
    if scalars.device.type == "cpu":
        return fused_radiance_plain(scene, scalars, cfg)
    if scalars.device.type != "cuda":
        raise ValueError(f"fused_radiance: unsupported device {scalars.device}")
    _check_frame_args(scene, scalars, cfg)
    out = torch.empty(cfg.height, cfg.width, 3, dtype=torch.float32,
                      device=scalars.device)
    err = library().rt_frame(
        scalars.data_ptr(), scene.tri_packed.data_ptr(),
        scene.tri_norm_packed.data_ptr(), scene.super_bounds.data_ptr(),
        scene.cluster_bounds.data_ptr(), scene.sub_bounds.data_ptr(),
        scene.envmap.data_ptr(), out.data_ptr(), cfg.width, cfg.height,
        cfg.spp, float(np.float32(1.0 / cfg.spp)), cfg.max_refract_depth,
        cfg.max_reflect_depth, scene.num_supers, scene.num_clusters,
        scene.cluster_size, scene.sub_tris, scene.envmap.shape[0],
        scene.envmap.shape[1],
        torch.cuda.current_stream(scalars.device).cuda_stream)
    check(err, "rt_frame")
    fused_radiance.launches += 1
    return out


fused_radiance.launches = 0
