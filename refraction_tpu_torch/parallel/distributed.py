"""Multi-process rendering over ``torch.distributed``: port of
`refraction_tpu.parallel.distributed`.

Two modes, as in the JAX module, one process per rank:

- **Frame sharding** (`render_frames_distributed`): rank p renders frames
  p, p + P, p + 2P, ... of an orbit with the one-device renderer
  (`render.make_renderer(cfg, "auto", device)`: on the card one launch of
  the frame kernel a frame, on the CPU the eager integrator) and writes
  its own PNGs; the only collective is the sum of a 2-float stats vector.
- **Pixel-DP of the frame kernel** (`render_fused_dp_distributed`): every
  local device of every rank renders a round-robin slice of one frame's
  32x32 tiles (`kernels.framekernel.frame_tiles`), the shards are gathered
  on every rank and reassembled (`parallel.sharding.assemble_tiles`), and
  the image is held bit for bit against a one-device render.

Both collectives ride gloo over CPU tensors, whatever the device: the
traffic is small (the stats vector; one frame's tiles, once), and NCCL
refuses two ranks on one card, which is where a one-card machine puts
them. The kernels still run on the card: `process_device` gives rank r
``cuda:(r % device_count)``, so the ranks share a one-card machine's card
and spread over the cards of a host. There is no fallback: a rank that finds
no CUDA raises, a failed kernel build or launch raises, and a peer that
does not arrive raises after ``GROUP_TIMEOUT``.

Usage (one command per process; ``--coordinator`` is rank 0's address,
where it listens for the others):

    python -m refraction_tpu_torch.parallel.distributed \\
        --coordinator 127.0.0.1:9876 --num-processes 2 --process-id {0,1} \\
        --frames 32 --out render_out [--scene path/to.obj ...] [--fused-dp]

Each rank prints one JSON line: ``process_id``, the mode's stats (the JAX
module's keys), ``device`` and its kernel ``launches``; the split of its
wall time goes to stderr as a ``timings`` log line.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.png import write_png
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    frame_tiles,
    fused_radiance,
    tile_grid,
)
from refraction_tpu_torch.parallel.sharding import (
    assemble_tiles,
    replicate_scene,
)
from refraction_tpu_torch.render import make_renderer, sample_offsets
from refraction_tpu_torch.scene import load_scene, scene_from_jax
from refraction_tpu_torch.utils.stats import log, setup_logging

# How long a rank waits for its peers (the group's start and every
# collective) before it raises.
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Join the gloo process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator_address`` (``host:port``). Raises ValueError
    on a ``process_id`` outside ``[0, num_processes)``."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=GROUP_TIMEOUT)


def process_device(device: str, process_id: int) -> torch.device:
    """The device rank ``process_id`` renders on, from a device type: the
    CPU for ``"cpu"``; for ``"cuda"`` card ``process_id %
    torch.cuda.device_count()``, so the ranks of a one-card machine share
    ``cuda:0``. Raises RuntimeError when CUDA is asked for and none is
    visible, and ValueError on a negative ``process_id``, a device index
    or another device type."""
    if process_id < 0:
        raise ValueError(f"process_id {process_id} is negative")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda") or dev.index is not None:
        raise ValueError(f"want the device type 'cpu' or 'cuda', got "
                         f"{device!r}")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def frames_for_process(n_frames: int, process_id: int,
                       num_processes: int) -> list[int]:
    """Round-robin frame partition: adjacent frames land on different
    hosts so every host's work tracks the orbit's cost variation."""
    return list(range(process_id, n_frames, num_processes))


def _global_stats_psum(local: Sequence[float]) -> np.ndarray:
    """Sum a small per-process float32 stats vector over every rank (one
    gloo ``all_reduce`` of a CPU tensor); every rank gets the total."""
    total = torch.tensor(np.asarray(local, np.float32))
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy()


def to_png_u8(img: np.ndarray) -> np.ndarray:
    """The JAX module's display transform for its frame PNGs: gamma 2.2,
    round half up, clip. Not `run.to_u8`, which clamps before the gamma."""
    return np.clip(img ** (1 / 2.2) * 255.0 + 0.5, 0, 255).astype(np.uint8)


class _Laps:
    """Wall-clock seconds of consecutive steps, logged as one line."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def log(self, rank: int) -> None:
        log.info("timings %s", json.dumps({"rank": rank, **self.seconds}))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_frames_distributed(cfg: RenderConfig, n_frames: int,
                              out_dir: str | None, process_id: int,
                              num_processes: int, angle0: float = 0.01,
                              dangle: float = 0.01, scene=None,
                              device: str = "cuda") -> dict:
    """Render this process's share of an ``n_frames`` orbit animation.

    Every process calls this with the same arguments after
    `init_distributed`. ``scene`` is a host scene (`scene.Scene`; loaded
    from ``cfg`` when None), uploaded once to `process_device`. Each frame
    is copied to the host, checked finite, added to the checksum as its
    numpy mean and, with ``out_dir``, written as ``frame_{k:04d}.png``
    (`to_png_u8`). Returns the GLOBAL run stats, identical on every rank."""
    dev = process_device(device, process_id)
    laps = _Laps()
    if scene is None:
        scene, _ = load_scene(cfg)
    laps.lap("load_s")
    scene = scene_from_jax(scene, dev)
    _sync(dev)
    laps.lap("upload_s")
    render = make_renderer(cfg, "auto", dev)

    mine = frames_for_process(n_frames, process_id, num_processes)
    checksum = 0.0
    for k in mine:
        img = render(scene, orbit_camera(angle0 + dangle * k, cfg))
        img = img.cpu().numpy()
        if not np.isfinite(img).all():
            raise RuntimeError(f"non-finite radiance in frame {k}")
        checksum += float(img.mean())
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            write_png(os.path.join(out_dir, f"frame_{k:04d}.png"),
                      to_png_u8(img))
    laps.lap("frames_s")

    total = _global_stats_psum([float(len(mine)), checksum])
    laps.lap("reduce_s")
    laps.log(process_id)
    return {
        "frames_rendered_global": int(round(float(total[0]))),
        "frames_rendered_local": len(mine),
        "checksum_global": float(total[1]),
        "checksum_local": checksum,
    }


def render_fused_dp_distributed(cfg: RenderConfig, angle: float, scene=None,
                                device: str = "cuda", devices=None) -> dict:
    """Render ONE frame with the frame kernel's pixel-DP over every local
    device of every process (the multi-process form of ``run.py --devices
    N``), and hold it against a one-device render of the same frame.

    ``devices`` are this process's devices (default: its
    `process_device`); every rank must pass as many, L, or every rank
    raises ValueError. With W ranks there are S = W * L shards; local
    device j of rank r renders shard r * L + j: one `frame_tiles` launch
    of tile stride S and base r * L + j. Each shard's (n_local, 32, 32, 3)
    buffer is copied to the host (one device-to-host copy per shard), a
    gloo ``all_gather`` gives every rank all S shards in shard order, and
    `assemble_tiles` makes the (H, W, 3) image on the CPU.

    ``scene`` is a host scene (loaded from ``cfg`` when None), uploaded to
    the first local device and copied to the others. Returns the image's
    ``sha256`` (of its float32 bytes), its ``mean``, ``devices_global`` =
    S, and ``matches_single_device``: bit-equality with
    ``make_renderer(cfg, "cuda", devices[0])`` (the frame kernel's single
    launch; on the CPU its plain version)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is None:
        devices = [process_device(device, rank)]
    devices = [torch.device(d) for d in devices]
    laps = _Laps()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(devices)]))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"local device counts differ across processes: "
                         f"{counts} (rank {rank} has {len(devices)})")
    n_loc = len(devices)
    n_shards = world * n_loc
    laps.lap("count_gather_s")

    if scene is None:
        scene, _ = load_scene(cfg)
    laps.lap("load_s")
    first = scene_from_jax(scene, devices[0])
    scenes = {dev: replicate_scene(first, dev)
              for dev in dict.fromkeys(devices)}
    for dev in scenes:
        _sync(dev)
    laps.lap("upload_s")

    frame = orbit_camera(angle, cfg)
    scalars = build_scalars(frame, cfg, sample_offsets(cfg.spp), devices[0])
    n_tiles = tile_grid(cfg)[1]
    n_local = -(-n_tiles // n_shards)
    parts = [frame_tiles(scenes[dev], scalars.to(dev), cfg, n_shards,
                         rank * n_loc + j, n_local, n_tiles)
             for j, dev in enumerate(devices)]
    local = torch.stack([p.cpu() for p in parts])
    laps.lap("tiles_s")

    gathered = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(gathered, local)
    laps.lap("gather_s")
    img = assemble_tiles([s for g in gathered for s in g.unbind(0)], cfg,
                         "cpu").numpy()
    laps.lap("assemble_s")

    ref = make_renderer(cfg, "cuda", devices[0])(scenes[devices[0]], frame)
    same = bool(np.array_equal(img, ref.cpu().numpy()))
    laps.lap("single_device_s")
    laps.log(rank)
    return {
        "devices_global": n_shards,
        "sha256": hashlib.sha256(img.tobytes()).hexdigest(),
        "matches_single_device": same,
        "mean": float(img.mean()),
    }


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-process offline orbit render (one invocation "
        "per process; see module docstring)")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's coordinator service")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--scene", default=None,
                    help="OBJ path; default: procedural icosphere")
    ap.add_argument("--envmap", default=None)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--out", default=None, help="PNG output directory")
    ap.add_argument("--fused-dp", action="store_true",
                    help="instead of frame sharding, pixel-DP ONE frame's "
                         "fused kernel over every process's devices and "
                         "assert bit-parity with a single-device render")
    ap.add_argument("--device", default="cuda",
                    help="device type to render on (default: cuda; rank r "
                         "takes cuda:(r % cards))")
    args = ap.parse_args(argv)

    dev = process_device(args.device, args.process_id)
    setup_logging()
    t0 = time.perf_counter()
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    log.info("timings %s", json.dumps({"rank": args.process_id,
                                       "group_s": time.perf_counter() - t0}))
    try:
        cfg = RenderConfig(width=args.width, height=args.height,
                           backend="auto", cluster_size=32)
        scene = None
        if args.scene:
            cfg = cfg.replace(scene_path=args.scene, cluster_size=128)
            if args.envmap:
                cfg = cfg.replace(envmap_path=args.envmap)
        else:
            from refraction_tpu_torch.io.primitives import (
                make_gradient_envmap, make_icosphere)
            from refraction_tpu_torch.scene import build_scene

            scene, _ = build_scene(make_icosphere(subdiv=2, radius=1.2),
                                   make_gradient_envmap(64, 128),
                                   cluster_size=32)

        if args.fused_dp:
            stats = render_fused_dp_distributed(cfg, angle=0.35, scene=scene,
                                                device=args.device)
        else:
            stats = render_frames_distributed(
                cfg, args.frames, args.out, args.process_id,
                args.num_processes, scene=scene, device=args.device)
        _sync(dev)
        launches = {"fused_radiance": fused_radiance.launches,
                    "frame_tiles": frame_tiles.launches}
        print(json.dumps({"process_id": args.process_id, **stats,
                          "device": str(dev), "launches": launches}),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
