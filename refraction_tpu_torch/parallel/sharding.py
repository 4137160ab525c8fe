"""Multi-device rendering from one process: port of
`refraction_tpu.parallel.sharding`.

The JAX module is single-controller: one process drives a ``Mesh`` of
its local devices through ``shard_map``, and its collectives are an
``all_gather``, a ``psum`` and the assembly of a replicated output. The
port is the same: one process drives a list of local ``torch.device``s
(`make_mesh`), launches every shard's work on its device, then gathers
the shards' results on the first device, in shard order. Rendering over
several processes (``torch.distributed``, one rank per process) is
`parallel.distributed`, which reuses `replicate_scene` and
`assemble_tiles` from here.

- **Pixel data parallelism of the frame kernel**
  (`make_fused_sharded_renderer`): shard d of S renders global 32x32
  tiles d, d+S, d+2S, ... of the padded tile grid in one launch of the
  frame kernel's pixel-DP entry (`kernels.framekernel.frame_tiles`), and
  the tiles are reassembled in global order. The JAX renderer's fallback
  to the wavefront for an envmap past the TPU's VMEM budget is not
  ported: the CUDA kernel reads the map from global memory at any size.
- **Pixel data parallelism of the wavefront** (`make_sharded_renderer`):
  each shard traces a slice of the frame's primary rays, assigned in
  units round-robin (`_unit_interleave`).
- **Sample parallelism** (`make_sample_sharded_renderer`): a 2-D grid of
  devices (`make_mesh2d`), samples over rows and pixels over columns.
- **Triangle sharding** (`make_trisharded_intersect`): every device
  intersects every ray against its contiguous slice of the triangles;
  the nearest hit wins, ties to the lowest global index.

The scene is copied once to each distinct device and the copies are kept
while the same scene object is passed. Every renderer returns its image
on the first device. Nothing falls back to the CPU or to a plain version
when a device or a kernel is missing: a failed launch raises. On CPU
devices (``make_mesh(n, "cpu")``: n shards on the one CPU, as the JAX
tests' virtual CPU mesh) every shard takes the plain versions.
"""

from __future__ import annotations

import torch

from refraction_tpu_torch.camera import CameraFrame, generate_rays
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.integrator import render_pixels, render_pixels_mega
from refraction_tpu_torch.kernels.framekernel import (
    TILE,
    build_scalars,
    frame_tiles,
    tile_grid,
)
from refraction_tpu_torch.ops.backends import get_backend
from refraction_tpu_torch.ops.intersect import intersect_closest
from refraction_tpu_torch.render import resolve_backend, sample_offsets
from refraction_tpu_torch.scene import TorchScene

# Rays per work unit: whole 1,024-ray blocks (the JAX megakernel's tile)
# on the "cuda" backend's wavefront, 8 otherwise (sharding.py:127).
MEGA_UNIT, UNIT = 1024, 8
_NO_HIT = 3e38


def make_mesh(n: int, device: str = "cuda") -> list[torch.device]:
    """The first ``n`` CUDA devices, or on ``"cpu"`` ``n`` shards of the
    one CPU device. Raises ValueError naming the visible devices where
    fewer than ``n`` are visible."""
    kind = torch.device(device).type
    if n < 1:
        raise ValueError(f"make_mesh: want at least one device, got {n}")
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"make_mesh: unsupported device type {kind!r}")
    count = torch.cuda.device_count()
    if count < n:
        seen = ", ".join(f"cuda:{i}" for i in range(count)) or "none"
        raise ValueError(f"{n} devices asked for, {count} CUDA device(s) "
                         f"visible: {seen}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh2d(n: int, sample_devs: int = 2,
                device: str = "cuda") -> list[list[torch.device]]:
    """A (samples, pixels) grid of ``make_mesh(n, device)``: ``sample_devs``
    rows of ``n / sample_devs`` devices. Raises on an uneven split."""
    if sample_devs < 1 or n % sample_devs:
        raise ValueError(f"{n} devices do not split into "
                         f"samples={sample_devs}")
    devs = make_mesh(n, device)
    per = n // sample_devs
    return [devs[s * per:(s + 1) * per] for s in range(sample_devs)]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def replicate_scene(scene: TorchScene, device) -> TorchScene:
    """A copy of ``scene``'s tables on ``device`` (the scene itself if it
    lies there)."""
    if scene.device == device:
        return scene
    return TorchScene._make(x.to(device) if isinstance(x, torch.Tensor)
                            else x for x in scene)


def _replicator(devices: list[torch.device]):
    """scene -> {device: copy} over the distinct ``devices``; the copies
    are kept for the next call with the same scene object."""
    held: dict = {}

    def replicas(scene: TorchScene) -> dict:
        if held.get("scene") is not scene:
            held["scene"] = scene
            held["copies"] = {dev: replicate_scene(scene, dev)
                              for dev in dict.fromkeys(devices)}
        return held["copies"]

    return replicas


def _unit_interleave(n_pad: int, unit: int, ndev: int):
    """(scatter, gather) for round-robin load balancing (sharding.py:56-88):
    unit u of ``unit`` rays lands at slot ``(u % ndev) * units_per_dev + u
    // ndev``, so device d's contiguous shard holds units d, d + ndev, d +
    2 ndev, ...: a uniform slice of the frame instead of one band.
    ``scatter`` maps ray order to that order along ``axis`` (default 0),
    ``gather`` inverts it; both are a reshape and a transpose. ndev <= 1
    gives identities."""
    if ndev <= 1:
        def ident(x, axis=0):
            return x
        return ident, ident
    upd = n_pad // unit // ndev

    def _block_swap(x, a, b, axis):
        lead, trail = x.shape[:axis], x.shape[axis + 1:]
        x = x.reshape(*lead, a, b, unit, *trail).transpose(axis, axis + 1)
        return x.reshape(*lead, n_pad, *trail)

    def scatter(x, axis=0):
        return _block_swap(x, upd, ndev, axis)

    def gather(x, axis=0):
        return _block_swap(x, ndev, upd, axis)

    return scatter, gather


def _tracer(cfg: RenderConfig, backend: str, device: torch.device):
    """(trace(scene, o, d) -> (N, 3) radiance, rays per unit): the
    ``"cuda"`` backend's wavefront (`render_pixels_mega`), else the eager
    integrator over the backend."""
    backend = resolve_backend(backend, device)
    if backend == "cuda":
        return (lambda scene, o, d: render_pixels_mega(scene, o, d, cfg),
                MEGA_UNIT)
    be = get_backend(backend)
    return (lambda scene, o, d: render_pixels(scene, o, d, cfg, be.intersect,
                                              be.env_contribution), UNIT)


def _padded_rays(frame: CameraFrame, cfg: RenderConfig, jitter, n_pad: int,
                 device: torch.device):
    """The frame's primary rays for one sample, padded to ``n_pad`` with
    rays from the origin along +y (sharding.py:162-167)."""
    o, d = generate_rays(frame, cfg.width, cfg.height, device, jitter=jitter)
    pad = n_pad - o.shape[0]
    return (torch.cat([o, o.new_zeros(pad, 3)]),
            torch.cat([d, d.new_tensor([0.0, 1.0, 0.0]).expand(pad, 3)]))


def _mean(acc: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(n_pad, 3) ray-order sums -> the (H, W, 3) mean over spp. The divide
    is by a device tensor: CUDA divides by a Python scalar as a multiply
    by its reciprocal."""
    n = cfg.width * cfg.height
    spp = torch.tensor(float(cfg.spp), dtype=torch.float32, device=acc.device)
    return (acc[:n] / spp).reshape(cfg.height, cfg.width, 3)


def make_sharded_renderer(cfg: RenderConfig, devices,
                          backend: str = "torch", interleave: bool = True):
    """(scene, frame) -> (H, W, 3) on ``devices[0]``: the wavefront with
    the frame's primary rays sharded over ``devices`` (sharding.py:91-183),
    `make_sample_sharded_renderer` with one row of devices.

    Per sample, the rays are padded to a whole number of units per device
    (1,024 on the ``"cuda"`` backend's wavefront, 8 otherwise), assigned
    in units round-robin (``interleave``) or as contiguous bands, and
    device k traces its slice: `render_pixels_mega` on ``"cuda"``, else
    `render_pixels` over the backend. Each device adds its slice to its
    running sum, ``acc = acc + shard``, sample after sample; the sums are
    gathered on ``devices[0]`` in shard order, the interleave is undone and
    the sum divided by spp. A pixel's radiance does not depend on the
    other rays of its shard, so the image is the same for any number of
    devices."""
    return make_sample_sharded_renderer(cfg, [list(devices)], backend,
                                        interleave)


def make_fused_sharded_renderer(cfg: RenderConfig, devices):
    """(scene, frame) -> (H, W, 3) on ``devices[0]``: pixel-DP of the frame
    kernel (sharding.py:186-292). Per frame the scalar vector is built
    once; shard k of S makes one `frame_tiles` launch on its device,
    stride S and base k, over the tile grid padded to a multiple of S
    (pad tiles are gated off and stay zero); the shards' tiles are
    gathered on ``devices[0]``, put in global tile order (shard k's local
    tile j is global tile j * S + k), untiled and cropped. Each pixel is
    the single launch's (`fused_radiance`) bit for bit."""
    devices = [_device(d) for d in devices]
    ndev, out_dev = len(devices), devices[0]
    n_tiles = tile_grid(cfg)[1]
    n_local = -(-n_tiles // ndev)
    offsets = sample_offsets(cfg.spp)
    replicas = _replicator(devices)

    def render(scene: TorchScene, frame: CameraFrame) -> torch.Tensor:
        scenes = replicas(scene)
        scalars = build_scalars(frame, cfg, offsets, out_dev)
        scal = {dev: scalars.to(dev) for dev in scenes}
        parts = [frame_tiles(scenes[dev], scal[dev], cfg, ndev, k, n_local,
                             n_tiles)
                 for k, dev in enumerate(devices)]
        return assemble_tiles(parts, cfg, out_dev)

    return render


def assemble_tiles(parts: list[torch.Tensor], cfg: RenderConfig,
                   device) -> torch.Tensor:
    """The (H, W, 3) image on ``device`` from S shards' (n_local, 32, 32, 3)
    tile buffers (`frame_tiles`, stride S, shard k's base k): gathered in
    global tile order (shard k's local tile j is global tile j * S + k),
    the pad tiles dropped, untiled and cropped (sharding.py:259-269)."""
    tiles_x, n_tiles = tile_grid(cfg)
    tiles_y = n_tiles // tiles_x
    tiles = torch.stack([p.to(device) for p in parts], dim=1)
    tiles = tiles.reshape(-1, TILE, TILE, 3)[:n_tiles]
    img = tiles.reshape(tiles_y, tiles_x, TILE, TILE, 3).permute(
        0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, 3)
    return img[:cfg.height, :cfg.width].contiguous()


def make_sample_sharded_renderer(cfg: RenderConfig, devices2d,
                                 backend: str = "torch",
                                 interleave: bool = True):
    """(scene, frame) -> (H, W, 3) on ``devices2d[0][0]`` over a (samples,
    pixels) grid of devices (`make_mesh2d`; sharding.py:308-398).

    Device (s, p) traces samples ``s * spp / S`` to ``(s + 1) * spp / S``
    of pixel shard p (the shards as `make_sharded_renderer` cuts them),
    summing them as ``acc = acc + sample``; the S partial sums of a pixel
    shard are added on the output device in ascending s (the JAX
    ``psum``), and the total divided by spp. One sample's rays are made at
    a time. Raises ValueError when spp is not a multiple of S."""
    grid = [[_device(d) for d in row] for row in devices2d]
    sdev, pdev = len(grid), len(grid[0])
    if any(len(row) != pdev for row in grid):
        raise ValueError("devices2d: every row needs the same length")
    if cfg.spp % sdev:
        raise ValueError(f"spp={cfg.spp} must be a multiple of the samples "
                         f"axis ({sdev})")
    out_dev = grid[0][0]
    trace, unit = _tracer(cfg, backend, out_dev)
    offsets = sample_offsets(cfg.spp)
    spp_local = cfg.spp // sdev
    n_pad = _round_up(cfg.width * cfg.height, pdev * unit)
    per = n_pad // pdev
    scatter, gather = _unit_interleave(n_pad, unit,
                                       pdev if interleave else 1)
    replicas = _replicator([dev for row in grid for dev in row])

    def render(scene: TorchScene, frame: CameraFrame) -> torch.Tensor:
        scenes = replicas(scene)
        partial = {(s, p): torch.zeros(per, 3, dtype=torch.float32,
                                       device=dev)
                   for s, row in enumerate(grid) for p, dev in enumerate(row)}
        for s, row in enumerate(grid):
            for off in offsets[s * spp_local:(s + 1) * spp_local]:
                o, d = (scatter(x) for x in _padded_rays(frame, cfg, off,
                                                          n_pad, out_dev))
                for p, dev in enumerate(row):
                    partial[s, p] = partial[s, p] + trace(
                        scenes[dev], o[p * per:(p + 1) * per].to(dev),
                        d[p * per:(p + 1) * per].to(dev))
        cols = []
        for p in range(pdev):
            total = partial[0, p].to(out_dev)
            for s in range(1, sdev):
                total = total + partial[s, p].to(out_dev)
            cols.append(total)
        return _mean(gather(torch.cat(cols)), cfg)

    return render


def make_trisharded_intersect(devices):
    """An IntersectFn (ops/backends.py) with the *triangles* sharded over
    ``devices`` (sharding.py:401-449): device k holds the contiguous
    slice ``[k T/S, (k+1) T/S)`` and intersects every ray against it with
    the brute force (`intersect_closest`); the candidates (t, or 3e38 on a
    miss, and the global index) are gathered on the rays' device and the
    first minimum over the shards wins: shards are contiguous and
    ascending, so equal t goes to the lowest global index, as the single
    device's brute force breaks ties. Raises ValueError when the triangle
    count does not divide evenly; per-ray masks raise too (the shards
    serve the constant 0xff mask)."""
    devices = [_device(d) for d in devices]
    ndev = len(devices)
    held: dict = {}

    def shards(scene):
        if held.get("scene") is not scene:
            t = scene.num_tris
            if t % ndev:
                raise ValueError(f"{t} triangles do not split evenly over "
                                 f"{ndev} devices")
            per = t // ndev
            held["scene"], held["per"] = scene, per
            held["tris"] = [tuple(x[k * per:(k + 1) * per].to(dev)
                                  for x in (scene.tri_a, scene.tri_e1,
                                            scene.tri_e2))
                            for k, dev in enumerate(devices)]
        return held["tris"], held["per"]

    def intersect(scene, origins, dirs, want_front, alive, tmin, tmax,
                  ray_mask=None):
        del alive
        if ray_mask is not None:
            raise ValueError("the triangle-sharded intersect serves the "
                             "constant 0xff mask only")
        tris, per = shards(scene)
        here = origins.device
        cand = []
        for k, (dev, (a, e1, e2)) in enumerate(zip(devices, tris)):
            hit, t, idx = intersect_closest(origins.to(dev), dirs.to(dev), a,
                                            e1, e2, tmin, tmax,
                                            want_front.to(dev))
            cand.append((torch.where(hit, t, _NO_HIT), idx + k * per))
        ts = torch.stack([t.to(here) for t, _ in cand])
        gs = torch.stack([g.to(here) for _, g in cand])
        best = torch.argmin(ts, dim=0, keepdim=True)  # the first minimum
        t_best = ts.gather(0, best)[0]
        return t_best < 1e37, t_best, gs.gather(0, best)[0], None

    return intersect
