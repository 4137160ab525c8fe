"""Frame rendering: camera -> frame kernel (or eager integrator) -> image.

Port of `refraction_tpu.render` (make_renderer, render_frame,
rays_per_frame, sample_offsets, render_heatmap, heatmap_to_rgb,
Accumulator). Three paths:

- ``"cuda"``: the fused path, one frame-kernel launch per frame
  (kernels/framekernel.fused_radiance). On CPU tensors its wrapper takes
  the plain version.
- ``"cuda"`` with ``use_mega=False``: the modular path, the eager
  integrator over the closest-hit and env kernels (`get_backend("cuda")`:
  one launch of each per bounce level and sample); on CPU tensors their
  plain versions.
- ``"torch"``: the eager wavefront integrator over the brute-force
  backend, on any device.

``"auto"`` is ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU, as
the JAX package's ``auto`` picks by platform. It picks by the device the
caller names; it is no fallback for a missing card. The JAX renderer's
TPU machinery is not ported: the image tiling (``tile_order``, the
padding to whole tiles) and the VMEM budget that sends a large envmap to
the wavefront (``_mega_ok``). A pixel's radiance does not depend on the
order of the rays, so neither changes an image.

Only the scalar vector (camera, limits, jitter) crosses to the device per
frame; the result is the (H, W, 3) float32 image on the scene's device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.camera import CameraFrame, generate_rays, orbit_camera
from refraction_tpu_torch.integrator import (
    render_image,
    render_pixels,
    render_pixels_mega,
)
from refraction_tpu_torch.kernels.framekernel import build_scalars, fused_radiance
from refraction_tpu_torch.kernels.intersect import cull_code
from refraction_tpu_torch.ops.backends import get_backend, instance_intersect
from refraction_tpu_torch.ops.intersect import traversal_work
from refraction_tpu_torch.scene import TorchScene
from refraction_tpu_torch.tracing import span


def sample_offsets(spp: int) -> np.ndarray:
    """Deterministic stratified sub-pixel offsets, (spp, 2) in [0, 1).

    A copy of `refraction_tpu.render.sample_offsets` (that module imports
    JAX). spp=1 gives the reference's pixel centres; square spp a k x k
    grid; otherwise the first spp cells of the next square grid,
    recentred so the mean sample sits at the pixel centre.
    """
    if spp == 1:
        return np.array([[0.5, 0.5]], np.float32)
    k = math.ceil(math.sqrt(spp))
    cells = [((i + 0.5) / k, (j + 0.5) / k) for j in range(k) for i in range(k)]
    off = np.asarray(cells[:spp], np.float32)
    if k * k != spp:
        off = off + (np.float32(0.5) - off.mean(axis=0, dtype=np.float32))
    return off


def resolve_backend(backend: str, device: torch.device | str) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` otherwise;
    ``"cuda"`` and ``"torch"`` as given; anything else raises."""
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend: {backend!r} (use 'auto', 'cuda' "
                         "or 'torch')")
    return backend


def make_renderer(cfg: RenderConfig, backend: str = "cuda",
                  device: torch.device | str = "cuda",
                  use_mega: bool | None = None,
                  ) -> Callable[[TorchScene, CameraFrame], torch.Tensor]:
    """Build a (scene, frame) -> (H, W, 3) renderer for ``cfg``.

    ``backend`` is ``"cuda"``, ``"torch"`` or ``"auto"`` (see the module
    doc); ``cfg.backend``, the JAX package's name, is not read.
    ``use_mega`` picks the ``"cuda"`` backend's path: None or True the
    fused frame kernel, False the modular kernels under the eager
    integrator; the ``"torch"`` backend has only its eager path and
    refuses True. ``device`` is where the scalars and rays are made and
    must hold the scene.

    Only the fused path on a CUDA device walks a two-level scene
    (`scene.InstancedTorchScene`); every other path renders its bake
    (``scene.baked()``, the scene itself for a single mesh), the fused
    path's plain version on the CPU too.
    """
    device = torch.device(device)
    backend = resolve_backend(backend, device)
    offsets = sample_offsets(cfg.spp)
    if backend == "cuda" and use_mega is not False:
        def render(scene: TorchScene, frame: CameraFrame) -> torch.Tensor:
            return fused_radiance(
                scene, build_scalars(frame, cfg, offsets, device), cfg)
        return render
    if backend == "torch" and use_mega:
        raise ValueError("use_mega=True: the fused frame kernel is the "
                         "'cuda' backend's path")
    be = get_backend(backend)

    def render_eager(scene: TorchScene, frame: CameraFrame) -> torch.Tensor:
        return render_image(scene.baked(), frame, cfg, offsets, device,
                            be.intersect, be.env_contribution)

    return render_eager


def render_frame(scene: TorchScene, cfg: RenderConfig, angle: float = 0.01,
                 frame: CameraFrame | None = None, backend: str = "cuda",
                 ) -> torch.Tensor:
    """One-shot render on the scene's device."""
    if frame is None:
        frame = orbit_camera(angle, cfg)
    return make_renderer(cfg, backend, scene.device)(scene, frame)


def rays_per_frame(cfg: RenderConfig) -> int:
    """Upper bound on traced rays per frame: the sum of the wavefront's
    slot widths (dense slots, not live rays)."""
    n = cfg.width * cfg.height * cfg.spp
    total = 0
    w = 1
    for count in range(cfg.max_refract_depth + 1):
        total += w
        if count < cfg.max_reflect_depth:
            w *= 2
    return n * total


def count_live_rays(scene: TorchScene, cfg: RenderConfig, frame: CameraFrame,
                    device: torch.device | str) -> int:
    """Live rays traced for one frame: the lanes alive entering each bounce
    round of `render_pixels_mega`, for every sample's own jittered
    primaries (`sample_offsets`), over the real pixels only.

    Port of ``bench.py::count_live_rays``, which pads the image to whole
    32x32 tiles with edge-duplicated rays (and counts them) and multiplies
    the spp=1 count by spp; this count does neither. One host sync, at the
    end."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    for off in sample_offsets(cfg.spp):
        o, d = generate_rays(frame, cfg.width, cfg.height, device, jitter=off)
        _, stats = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
        total = total + stats["rays_traced"]
    return int(total)


def frame_traversal_work(scene: TorchScene, cfg: RenderConfig,
                         frame: CameraFrame, device: torch.device | str,
                         ) -> list[dict]:
    """The traversal work of one frame, per bounce level: a list of dicts
    of summed `ops.intersect.traversal_work` counts (``root_tests``,
    ``super_tests``, ``cluster_tests``, ``sub_tests``, ``mt_tests``),
    ``rays`` (live rays) and ``misses`` (live rays that hit nothing), over
    every sample's rays.

    The rays, their intervals and their closest hits come from the eager
    integrator (`integrator.render_pixels`) over the closest-hit kernel on
    CUDA (``cuda`` backend), the brute force on the CPU; the depth-cap
    level counts a closest hit too. Shading is not counted. A two-level
    scene's rays and hits are its instance walk's
    (`ops.backends.instance_intersect`), and the work is counted under that
    walk, with the instance level's counts."""
    be = get_backend("cuda" if torch.device(device).type == "cuda" else "torch")
    intersect = instance_intersect if scene.num_instances else be.intersect
    per_sample: list[list[dict]] = []  # [sample][level] -> summed counts

    def recording(scene_, o, d, want_front, alive, tmin, tmax):
        res = intersect(scene_, o, d, want_front, alive, tmin, tmax)
        hit, t = res[0] & alive, res[1]
        t_hit = torch.where(hit, t, torch.full_like(t, tmax))
        work = traversal_work(scene_, o, d, tmin, t_hit,
                              cull_code(want_front, alive))
        sums = {key: int(v.sum()) for key, v in work.items()}
        sums["rays"] = int(alive.sum())
        sums["misses"] = int((alive & ~hit).sum())
        per_sample[-1].append(sums)
        return res

    for off in sample_offsets(cfg.spp):
        per_sample.append([])
        o, d = generate_rays(frame, cfg.width, cfg.height, device, jitter=off)
        render_pixels(scene, o, d, cfg, recording, be.env_contribution)
    levels = [{key: sum(s[k][key] for s in per_sample) for key in lv}
              for k, lv in enumerate(per_sample[0])]
    return levels


def render_heatmap(scene: TorchScene, cfg: RenderConfig, frame: CameraFrame,
                   device: torch.device | str) -> np.ndarray:
    """Per-pixel live-ray count, (H, W) int32: every live lane entering a
    bounce round of the pixel's ray tree, summed over the spp samples
    (1 = the primary missed straight to the envmap). Port of
    `refraction_tpu.render.render_heatmap`, through `render_pixels_mega`:
    on CUDA one round-kernel launch per bounce round and sample, the
    counts summed on the device; one host copy at the end."""
    counts = torch.zeros(cfg.width * cfg.height, dtype=torch.int32,
                         device=device)
    for off in sample_offsets(cfg.spp):
        o, d = generate_rays(frame, cfg.width, cfg.height, device, jitter=off)
        _, stats = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
        counts = counts + stats["pixel_rays"]
    return counts.reshape(cfg.height, cfg.width).cpu().numpy()


def heatmap_to_rgb(counts: np.ndarray) -> np.ndarray:
    """Map (H, W) ray counts to a (H, W, 3) float32 image: black (0) ->
    deep blue (1 ray) -> orange -> white (max). A copy of
    `refraction_tpu.render.heatmap_to_rgb` (that module imports JAX)."""
    c = counts.astype(np.float64)
    t = np.where(c > 0, c / max(float(c.max()), 1.0), 0.0)
    stops = np.array([
        [0.00, 0.0, 0.0, 0.0],
        [0.01, 0.05, 0.05, 0.35],
        [0.40, 0.60, 0.20, 0.10],
        [0.75, 0.95, 0.60, 0.15],
        [1.00, 1.0, 1.0, 1.0],
    ])
    rgb = np.stack([
        np.interp(t, stops[:, 0], stops[:, k + 1]) for k in range(3)
    ], axis=-1)
    return rgb.astype(np.float32)


class Accumulator:
    """Progressive accumulation state, saved and resumed as ``.npz``.

    The state of `refraction_tpu.render.Accumulator` (that module imports
    JAX): a float64 sum and a frame count, in the same ``sum`` / ``count``
    file format, so a state saved by either package resumes in the other.

    The sum lives where the frames are. `add` folds a numpy array or a
    CPU tensor on the host, as the JAX package does; it folds a tensor on
    a card on that card, into a float64 tensor there, with no copy of the
    frame. ``card_folds`` counts the frames folded on a card. Reading
    `sum` returns the host array, bringing a card's sum over first (one
    synchronising copy); the next fold on the card takes it back up. Each
    add is exact (float32 widens to float64 without rounding) and rounds
    as IEEE float64 addition does on either side, so the sum's bits do not
    depend on where the frames were folded."""

    def __init__(self, height: int, width: int):
        self._shape = (height, width, 3)
        # None (all zeros), a host float64 array, or a float64 tensor on
        # the card the last frame came from.
        self._sum: np.ndarray | torch.Tensor | None = None
        self.count = 0
        self.card_folds = 0

    @property
    def sum(self) -> np.ndarray:
        """The (H, W, 3) float64 sum on the host."""
        if self._sum is None:
            self._sum = np.zeros(self._shape, np.float64)
        elif isinstance(self._sum, torch.Tensor):
            with span("rt.fold.fetch"):
                self._sum = self._sum.cpu().numpy()
        return self._sum

    @sum.setter
    def sum(self, value: np.ndarray) -> None:
        self._sum = np.asarray(value, np.float64)

    def add(self, img: np.ndarray | torch.Tensor) -> None:
        if isinstance(img, torch.Tensor) and img.device.type != "cpu":
            with span("rt.fold.card"):
                if self._sum is None:
                    self._sum = torch.zeros(self._shape, dtype=torch.float64,
                                            device=img.device)
                else:  # a host sum goes up once; a card's sum stays put
                    self._sum = torch.as_tensor(self._sum, device=img.device)
                # float32 + float64 widens inside the add: no temporary.
                self._sum.add_(img)
            self.card_folds += 1
        else:
            with span("rt.fold.widen"):
                wide = np.asarray(img, np.float64)
            with span("rt.fold.add"):
                self.sum += wide
        self.count += 1

    @property
    def image(self) -> np.ndarray:
        return (self.sum / max(self.count, 1)).astype(np.float32)

    def save(self, path: str) -> None:
        np.savez(path, sum=self.sum, count=self.count)

    @classmethod
    def load(cls, path: str) -> "Accumulator":
        z = np.load(path)
        acc = cls(z["sum"].shape[0], z["sum"].shape[1])
        acc.sum = z["sum"]
        acc.count = int(z["count"])
        return acc
