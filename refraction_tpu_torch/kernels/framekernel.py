"""Frame kernel wrapper (``csrc/frame.cu``): port of
`refraction_tpu.kernels.framekernel` ``frame_call`` / ``fused_radiance`` /
``build_scalars``.

``fused_radiance(scene, scalars, cfg)`` renders one (H, W, 3) frame in ONE
kernel launch for CUDA tensors; for CPU tensors it takes the plain version,
``fused_radiance_plain``, which is the eager wavefront integrator
(integrator.render_pixels over the brute-force backend) fed the same rays.

``frame_tiles(scene, scalars, cfg, tile_stride, tile_base, n_local,
n_tiles_real)`` is the pixel-DP entry (the JAX ``frame_call`` with
``tile_stride`` > 1): one launch renders a shard's ``n_local`` 32x32 tiles
of the padded tile grid, global ids ``j * tile_stride + tile_base``, into
an (n_local, 32, 32, 3) buffer; ids >= ``n_tiles_real`` and pixels outside
the image are zero. Its plain version is ``frame_tiles_plain``.

The TPU path's front-to-back cluster permutation (``front_to_back_scene``)
becomes a per-ray near-to-far walk inside the kernel over the scene's
root, super and cluster boxes, so winner indices need no remapping. The
kernel has three instances, chosen at launch from the scene: `walk_of`
names the one a scene takes, `walk_levels` its box levels, and each
full-frame wrapper counts its launches per instance beside ``launches``
(``fused_radiance.walks["roots"]``). A launch that fails raises.

Both entries run one thread per pixel over csrc/traverse_f2b.cuh's walk.
`frame_occupancy` reads the full-frame kernel's resident blocks and
registers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from refraction_tpu_torch.camera import CameraFrame, pixel_rays
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.integrator import render_image, render_pixels
from refraction_tpu_torch.kernels._build import (
    check, launch, library, on_device)
from refraction_tpu_torch.kernels.envmap import (
    check_envmap,
    env_contribution_plain,
)
from refraction_tpu_torch.kernels.intersect import check_scene_tables
from refraction_tpu_torch.ops.backends import torch_intersect
from refraction_tpu_torch.tracing import span

# Scalar vector layout (as refraction_tpu/kernels/framekernel.py:96-103):
# [0:9] proj_inv rows 0..2 of columns (0, 1, 3) | [9:12] camera origin |
# [12:16] tmin/tmax primary, tmin/tmax secondary | [16] ior | [17] r0 |
# [18:18+2*spp] per-sample jitter (x, y).
N_BASE_SCALARS = 18
# Pending-ray stack slots per thread; must equal RT_MAX_STACK in frame.cu.
MAX_STACK = 8
# Tile edge of the pixel-DP entry; must equal RT_TILE in frame.cu.
TILE = 32
# traverse_f2b.cuh RtWalk: the instances' names, by their enum value.
WALKS = ("flat", "supers", "roots")


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
    host = torch.from_numpy(np.asarray(vals, np.float32))
    with span("rt.upload"):
        return host.to(device)


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
    ``"roots"`` (root boxes over runs of 32 supers, walked near to far
    above them: 33-1,024 supers), ``"supers"`` (super boxes and no roots,
    near to far) or ``"flat"`` (at most 32 clusters, in table order);
    traverse_f2b.cuh RtWalk."""
    if scene.num_roots > 0:
        return "roots"
    return "supers" if scene.num_supers > 0 else "flat"


def walk_levels(scene) -> dict:
    """The levels ``scene``'s walk goes through: its instance (`walk_of`),
    root boxes and super boxes (0 where the walk has no such level),
    clusters and subs a cluster."""
    return {"walk": walk_of(scene), "roots": scene.num_roots,
            "supers": scene.num_supers, "clusters": scene.num_clusters,
            "subs_per_cluster": scene.cluster_size // scene.sub_tris}


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
        raise ValueError("fused_radiance: unsupported device "
                         f"{scalars.device}")
    with span("rt.launch"):
        _check_frame_args(scene, scalars, cfg)
        out = torch.empty(cfg.height, cfg.width, 3, dtype=torch.float32,
                          device=scalars.device)
        launch("rt_frame", scalars.device,
               *_frame_args(scene, scalars, cfg, out), *_root_args(scene))
    fused_radiance.launches += 1
    fused_radiance.walks[walk_of(scene)] += 1
    return out


fused_radiance.launches = 0
fused_radiance.walks = dict.fromkeys(WALKS, 0)


def frame_occupancy(walk: str, device: torch.device) -> dict:
    """Resident blocks and warps per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local memory a thread of the full-frame kernel in the ``walk``
    instance (one of `WALKS`) on ``device`` (CUDA)."""
    out = (ctypes.c_int * 4)()
    with on_device(device):
        err = library().rt_frame_occupancy(WALKS.index(walk), out)
    check(err, "rt_frame_occupancy")
    blocks, regs, local, threads = out
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "registers": regs, "local_bytes": local,
            "threads_per_block": threads}


def _frame_args(scene, scalars, cfg, out) -> tuple:
    """rt_frame's and rt_frame_tiles' first arguments."""
    return (scalars.data_ptr(), scene.tri_packed.data_ptr(),
            scene.tri_norm_packed.data_ptr(), scene.super_bounds.data_ptr(),
            scene.cluster_bounds.data_ptr(), scene.sub_bounds.data_ptr(),
            scene.envmap.data_ptr(), out.data_ptr(), cfg.width, cfg.height,
            cfg.spp, float(np.float32(1.0 / cfg.spp)), cfg.max_refract_depth,
            cfg.max_reflect_depth, scene.num_supers, scene.num_clusters,
            scene.cluster_size, scene.sub_tris, scene.envmap.shape[0],
            scene.envmap.shape[1])


def _root_args(scene) -> tuple:
    """rt_frame's and rt_frame_tiles' last arguments before the stream."""
    return scene.root_bounds.data_ptr(), scene.num_roots


def tile_grid(cfg: RenderConfig) -> tuple[int, int]:
    """(tiles_x, n_tiles): the image's 32x32 tile grid, padded to whole
    tiles, in row-major tile order."""
    tiles_x = -(-cfg.width // TILE)
    return tiles_x, tiles_x * -(-cfg.height // TILE)


def _check_tiles(cfg, tile_stride, tile_base, n_local, n_tiles_real):
    n_tiles = tile_grid(cfg)[1]
    if not (0 <= tile_base < tile_stride and n_local >= 1
            and 0 <= n_tiles_real <= n_tiles):
        raise ValueError(
            f"frame_tiles: stride {tile_stride}, base {tile_base}, "
            f"{n_local} tiles, {n_tiles_real} real: want 0 <= base < stride, "
            f"n_local >= 1 and n_tiles_real <= {n_tiles}, the tile count of "
            f"{cfg.width}x{cfg.height}")


def frame_tiles_plain(scene, scalars: torch.Tensor, cfg: RenderConfig,
                      tile_stride: int, tile_base: int, n_local: int,
                      n_tiles_real: int) -> torch.Tensor:
    """The pixel-DP entry's plain version: per sample, the primary rays of
    the shard's pixels (`camera.pixel_rays` with the sample's jitter)
    through the eager integrator, as `fused_radiance_plain` runs the whole
    frame; averaged over samples; scattered into the (n_local, 32, 32, 3)
    shard buffer, zero at gated tiles and pixels outside the image."""
    _check_tiles(cfg, tile_stride, tile_base, n_local, n_tiles_real)
    dev = scalars.device
    tiles_x = tile_grid(cfg)[0]
    tile = (torch.arange(n_local, device=dev) * tile_stride
            + tile_base)[:, None, None]
    ly = torch.arange(TILE, device=dev)[None, :, None]
    lx = torch.arange(TILE, device=dev)[None, None, :]
    px = (tile % tiles_x) * TILE + lx
    py = (tile // tiles_x) * TILE + ly
    keep = ((tile < n_tiles_real) & (px < cfg.width)
            & (py < cfg.height)).reshape(-1)
    at = torch.nonzero(keep).squeeze(1)
    out = torch.zeros(n_local * TILE * TILE, 3, dtype=torch.float32,
                      device=dev)
    if at.numel() == 0:  # only gated tiles and pixels outside the image
        return out.reshape(n_local, TILE, TILE, 3)
    gx = px.expand(n_local, TILE, TILE).reshape(-1)[at].to(torch.float32)
    gy = py.expand(n_local, TILE, TILE).reshape(-1)[at].to(torch.float32)
    sc = scalars.detach().cpu().numpy()
    frame = _frame_from_scalars(sc)
    offsets = sc[N_BASE_SCALARS:N_BASE_SCALARS + 2 * cfg.spp].reshape(-1, 2)
    acc = None
    for off in offsets:
        o, d = pixel_rays(frame, gx, gy, cfg.width, cfg.height, jitter=off)
        rad = render_pixels(scene, o, d, cfg, torch_intersect,
                            env_contribution_plain)
        acc = rad if acc is None else acc + rad
    out[at] = acc * float(np.float32(1.0 / cfg.spp))
    return out.reshape(n_local, TILE, TILE, 3)


def frame_tiles(scene, scalars: torch.Tensor, cfg: RenderConfig,
                tile_stride: int, tile_base: int, n_local: int,
                n_tiles_real: int) -> torch.Tensor:
    """A shard of the frame: its ``n_local`` 32x32 tiles, global ids ``j *
    tile_stride + tile_base`` of the padded tile grid (`tile_grid`), as an
    (n_local, 32, 32, 3) float32 buffer; tiles with ids >= ``n_tiles_real``
    and pixels outside the image are zero. Each pixel is `fused_radiance`'s
    bit for bit.

    On CUDA: one launch of the frame kernel's pixel-DP entry on the
    current stream of the tensors' device."""
    if scalars.device.type == "cpu":
        return frame_tiles_plain(scene, scalars, cfg, tile_stride, tile_base,
                                 n_local, n_tiles_real)
    if scalars.device.type != "cuda":
        raise ValueError(f"frame_tiles: unsupported device {scalars.device}")
    with span("rt.launch"):
        _check_frame_args(scene, scalars, cfg)
        _check_tiles(cfg, tile_stride, tile_base, n_local, n_tiles_real)
        out = torch.empty(n_local, TILE, TILE, 3, dtype=torch.float32,
                          device=scalars.device)
        launch("rt_frame_tiles", scalars.device,
               *_frame_args(scene, scalars, cfg, out), tile_stride,
               tile_base, n_local, n_tiles_real, *_root_args(scene))
    frame_tiles.launches += 1
    return out


frame_tiles.launches = 0
