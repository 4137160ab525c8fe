"""Roofline bounds of the port's kernels: the least time the card could take
for the work of one call, the larger of its bytes over the memory rate and
its operations over the peak rate of their type (FP32 outside the tensor
cores; the tensor-core instrument's product over the TF32 peak, a pipe
that runs beside the FP32 one, so the two times do not add).

Bytes count each input read once and each output written once. Operations
count what these inputs need (`ops.intersect.traversal_work` for the
traversal kernels: the box and triangle tests of the rays each call
traces, whatever the visit order), with the per-test FP32 operation counts
stated beside each constant. Shading is not counted, so the traversal
kernels' bounds are lower bounds of a lower bound. Peaks are the H100 SXM
data sheet's at its 700 W limit: 3.35 TB/s of HBM, 67 TFLOP/s FP32 outside
the tensor cores (a fused multiply-add counted as two operations; the
library is built with -fmad=false, so every counted operation is one
instruction, and the instruction-issue floor is twice the operations
time). The stall instrument's bound also has a latency floor
(`stall_bound`): one block on one SM runs dependent chains, so their
length times the FP32 latency can exceed both.

    python -m refraction_tpu_torch.bounds --scene X.obj --envmap X.hdr \\
        --width 1920 --height 1080 --bounces 4 [--spp 4] [--device cuda] \\
        [--instances SPEC.json]

prints one JSON line: the frame kernel's bound at that shape, the
traversal work per bounce level and, at spp 1, the bound of the
wavefront's round-kernel launches for the frame (``round``). With
``--instances`` the scene is the two-level scene of `run.py`'s flag, the
work is that of the frame kernel's instance walk (instance roots and
boxes, a transform a box overlapped, then each BLAS), and the wavefront,
which walks the bake, is not bound (``round`` is None).

These counts are the port's own yardstick of its walks, for developers:
they move with the tables and the walk. The benchmark's roofline
(`rtbench/roofline.py`) is a fixed lower bound that no walk change moves.
"""

from __future__ import annotations

import argparse
import json
import subprocess

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.kernels.framekernel import walk_levels
from refraction_tpu_torch.ops.intersect import (
    BOX_TEST_OPS,
    MT_TEST_OPS,
    XFORM_OPS,
    traversal_work,
)
from refraction_tpu_torch.render import frame_traversal_work
from refraction_tpu_torch.run import build_config
from refraction_tpu_torch.scene import (
    load_instanced,
    load_scene,
    scene_from_jax,
)
from refraction_tpu_torch.timing import card_line, require_device

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores, same data sheet
# FP32 operations per ray of the env lookup (envmap.cuh rt_env_texel and
# the weighting): 2 divides, 4 multiplies, 2 adds, 2 clamps of 2, the
# atan2f and acosf counted as one each, 3 weight multiplies.
ENV_RAY_OPS = 17
# Per 8-triangle sub visit of the instruments (csrc/mtbench.cu): MT 53 per
# triangle (the traversal's 52 plus the det * cull multiply); Woop the
# 48 x 8 product (8 multiplies and 7 adds per row) plus 13 per triangle.
MT_VISIT_OPS = 8 * 53
WOOP_EPILOGUE_OPS = 8 * 13
WOOP_VISIT_OPS = 48 * 15 + WOOP_EPILOGUE_OPS
# The tensor-core Woop forms do the 48 x 8 product as tensor-core
# multiply-adds (two operations each) and the same epilogue in FP32. The
# function needs the product once: 3xTF32's three passes are how that
# kernel reaches FP32 accuracy, not work the bound may count.
WOOP_TC_PRODUCT_OPS = 48 * 8 * 2
WOOP_TC_KINDS = ("woop_tc", "woop_tc3")
# Per carry element and iteration of the six stall variants
# (csrc/stallbench.cu): vecops 128, tree 4, extract 3, while2 8 (the word
# 0x2D | (i & 1) has four set bits: four pops, a multiply and an add
# each), loads72 144, subplane 36.
STALL_ITER_OPS = {"vecops": 128, "tree": 4, "extract": 3, "while2": 8,
                  "loads72": 144, "subplane": 36}
# The dependent FP32 operations on one carry element's chain from one
# iteration to the next, the cross-thread reduction and the int/float
# conversions not counted (so the floor stays a lower bound): vecops 64
# multiplies and adds; tree acc + i, the word's scaling, the add; extract
# acc + i and the add; while2 four pops of a multiply and an add; loads72
# the 72 adds (the loads' scaling is off the chain); subplane acc * 0.001,
# + i, the compare, the word's scaling, the add.
STALL_CHAIN_OPS = {"vecops": 128, "tree": 3, "extract": 2, "while2": 8,
                   "loads72": 72, "subplane": 5}
# Cycles from one dependent FP32 add or multiply to the next on Hopper:
# 4, as measured by Luo et al., "Benchmarking and Dissecting the Nvidia
# Hopper GPU Architecture" (2024). The vecops reading tests the figure.
FP32_LATENCY_CYCLES = 4
STATE_ROW_BYTES = 8 * 4  # one lane of the round kernel's (8, W) state
QUEUE_LANE_BYTES = STATE_ROW_BYTES + 4  # a queued lane: state and slot id
RADIANCE_BYTES = 3 * 4  # one lane's miss radiance
SECTOR_BYTES = 32  # the least a scattered load moves from memory


def bound(ops: float, nbytes: float, tensor_ops: float = 0) -> dict:
    """{'ops', 'bytes', 'ops_ms', 'bytes_ms', 'bound_ms', 'bound_by'} of
    ``ops`` FP32 operations, ``nbytes`` bytes and, beside them,
    ``tensor_ops`` TF32 tensor-core operations. The FP32 and tensor pipes
    run side by side across warps, so ``ops_ms`` is the larger of their
    two times and ``bound_ms`` the largest of the three."""
    ops_ms = max(ops / FP32_OPS_PER_S, tensor_ops / TF32_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": int(ops + tensor_ops), "bytes": int(nbytes),
            "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def traversal_ops(work: dict) -> int:
    """FP32 operations of summed traversal_work counts (a two-level
    scene's instance boxes and ray transforms too)."""
    boxes = (work["root_tests"] + work["super_tests"] + work["cluster_tests"]
             + work["sub_tests"] + work.get("instance_root_tests", 0)
             + work.get("instance_tests", 0))
    return (BOX_TEST_OPS * boxes + MT_TEST_OPS * work["mt_tests"]
            + XFORM_OPS * work.get("transforms", 0))


def table_bytes(scene) -> int:
    """Bytes of the traversal's tables (triangles, normals, boxes; of a
    two-level scene each BLAS's once and the instance tables)."""
    tables = (scene.tri_packed, scene.tri_norm_packed, scene.cluster_bounds,
              scene.sub_bounds, scene.super_bounds, scene.root_bounds,
              scene.inst_bounds, scene.inst_roots, scene.inst_xform,
              scene.inst_info)
    return sum(int(t.numel()) * t.element_size() for t in tables
               if t is not None)


def env_bytes(scene) -> int:
    return int(scene.envmap.numel()) * 4


def _summed(levels: list[dict]) -> dict:
    return {k: sum(lv[k] for lv in levels) for k in levels[0]}


def frame_bound(scene, cfg: RenderConfig, levels: list[dict]) -> dict:
    """Bound of one frame-kernel launch: the traversal work of the frame's
    rays (``levels`` from render.frame_traversal_work); bytes are the
    scalars, the tables, the map and the (H, W, 3) image."""
    nbytes = ((18 + 2 * cfg.spp) * 4 + table_bytes(scene) + env_bytes(scene)
              + cfg.width * cfg.height * 3 * 4)
    out = bound(traversal_ops(_summed(levels)), nbytes)
    out["work"] = _summed(levels)
    return out


def round_map_bytes(scene, misses: int) -> int:
    """Map bytes one round must read for ``misses`` env lookups: a sector
    per lookup, at most the whole map."""
    return min(env_bytes(scene), misses * SECTOR_BYTES)


def round_bound(scene, cfg: RenderConfig, levels: list[dict]) -> dict:
    """Bound of the wavefront's round-kernel launches for one frame (spp 1):
    the work of the frame's ray tree (``levels`` from
    render.frame_traversal_work). Per bounce level k with L_k live lanes
    (``levels[k]["rays"]``): their state and slot ids read, their radiance
    written, and their live children, the next level's L_(k+1) lanes,
    written with their slot ids; the tables; the map texels of the level's
    misses (`round_map_bytes`); the traversal work of the live lanes.

    ``static_bytes`` (with ``static_bound_ms``) is what the static layout
    moves, for the record: every lane of the widths N, 2N, 4N, ... reads
    its state and writes its radiance and both children, dead or alive,
    beside the same tables and texels."""
    rays = [lv["rays"] for lv in levels] + [0]
    per_round = [table_bytes(scene) + round_map_bytes(scene, lv["misses"])
                 for lv in levels]
    nbytes = sum(live * (QUEUE_LANE_BYTES + RADIANCE_BYTES)
                 + rays[k + 1] * QUEUE_LANE_BYTES + per_round[k]
                 for k, live in enumerate(rays[:-1]))
    ops = traversal_ops(_summed(levels))
    out = bound(ops, nbytes)
    n = cfg.width * cfg.height
    width, static = n, 0
    for count in range(cfg.max_refract_depth + 1):
        children = count < cfg.max_refract_depth
        out_w = (2 * width if children and count < cfg.max_reflect_depth
                 else width if children else 0)
        static += (width * (STATE_ROW_BYTES + RADIANCE_BYTES)
                   + out_w * STATE_ROW_BYTES + per_round[count])
        width = out_w
    out.update(static_bytes=static,
               static_bound_ms=bound(ops, static)["bound_ms"])
    return out


def fold_bound(n_pix: int, named: int, touched: int) -> dict:
    """Bound of one fold launch (`kernels.megakernel.fold_round_sums`)
    over ``n_pix`` pixels whose masks name ``named`` slab rows in all, at
    ``touched`` pixels: every mask read; per named row 12 bytes in; per
    touched pixel its mask cleared and its radiance read and written; one
    add per row and channel and one per touched pixel and channel."""
    return bound(3 * (named + touched),
                 4 * n_pix + RADIANCE_BYTES * named
                 + (4 + 2 * RADIANCE_BYTES) * touched)


def closest_hit_bound(scene, o, d, cull, tmin: float, t_hit) -> dict:
    """Bound of one closest-hit launch: the rays' traversal work on
    [tmin, t_hit]; bytes are the rays and cull in, (t, idx, normal) out,
    and the tables."""
    n = o.shape[0]
    work = {k: int(v.sum()) for k, v in
            traversal_work(scene, o, d, tmin, t_hit, cull).items()}
    out = bound(traversal_ops(work),
                n * (24 + 4) + n * (4 + 4 + 12) + table_bytes(scene))
    out["work"] = work
    return out


def env_bound(scene, n: int, live: int) -> dict:
    """Bound of one env launch over n rays, ``live`` of them with weight
    > 0: a live ray's direction and weight in, its radiance out and a
    sector of the map per lookup, at most the map (`round_map_bytes`); a
    ray of weight 0 costs its weight in and 12 bytes of zeros out."""
    nbytes = (live * (12 + 4 + RADIANCE_BYTES) + round_map_bytes(scene, live)
              + (n - live) * (4 + RADIANCE_BYTES))
    return bound(live * ENV_RAY_OPS, nbytes)


def mtbench_bound(kind: str, r: int, v: int, table_words: int) -> dict:
    """Bound of one instrument launch: v sub visits for each of r rays.
    ``kind``: ``mt``, ``woop`` (the product on CUDA cores), ``woop_tc`` or
    ``woop_tc3`` (the product on the tensor cores, TF32 or 3xTF32: the
    same bound, the product counted once)."""
    ray_words = 7 if kind == "mt" else 9  # o, d, cull or rhs(8), cull
    nbytes = 4 * (table_words + r * ray_words + 2 * r)
    if kind in WOOP_TC_KINDS:
        return bound(WOOP_EPILOGUE_OPS * r * v, nbytes,
                     WOOP_TC_PRODUCT_OPS * r * v)
    ops = {"mt": MT_VISIT_OPS, "woop": WOOP_VISIT_OPS}[kind] * r * v
    return bound(ops, nbytes)


def stall_bound(variant: str, n_iter: int, clock_hz: float,
                elems: int = 1024) -> dict:
    """Bound of one stall launch of ``variant`` at n_iter iterations: the
    larger of the throughput floor (`bound`: the carry and the 1,024-word
    table in, the carry out; the variant's operations over the whole
    card's FP32 rate) and the latency floor ``latency_ms``: n_iter times
    the variant's dependent chain (STALL_CHAIN_OPS) times the FP32
    latency in cycles, over ``clock_hz``, the card's maximum SM clock
    (`max_sm_clock_hz`). Every element's chain runs in turn through the
    iterations, and no two iterations of a chain overlap, so no schedule
    beats it. ``bound_by`` is ``latency`` where that floor wins."""
    out = bound(STALL_ITER_OPS[variant] * elems * n_iter, 4 * 3 * elems)
    lat_ms = (n_iter * STALL_CHAIN_OPS[variant] * FP32_LATENCY_CYCLES
              / clock_hz * 1e3)
    out["latency_ms"] = lat_ms
    if lat_ms > out["bound_ms"]:
        out.update(bound_ms=lat_ms, bound_by="latency")
    return out


def max_sm_clock_hz(device) -> float:
    """The card's maximum SM clock in Hz, as ``nvidia-smi
    --query-gpu=clocks.max.sm`` reports it (e.g. ``1980 MHz``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[device.index or 0]
    value, unit = line.split()
    if unit != "MHz":
        raise ValueError(f"clocks.max.sm: want MHz, got {line!r}")
    return float(value) * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for flag in ("--scene", "--envmap"):
        p.add_argument(flag)
    for flag in ("--width", "--height", "--bounces", "--spp"):
        p.add_argument(flag, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--instances", metavar="SPEC.json")
    args = p.parse_args(argv)
    device = require_device(args.device)
    cfg = build_config(args)
    if args.instances:
        scene_np, meta = load_instanced(args.instances, cfg)
    else:
        scene_np, meta = load_scene(cfg)
    scene = scene_from_jax(scene_np, device)
    levels = frame_traversal_work(scene, cfg, orbit_camera(0.01, cfg), device)
    out = frame_bound(scene, cfg, levels)
    out.update(round=round_bound(scene, cfg, levels)
               if cfg.spp == 1 and not args.instances else None,
               levels=levels, tris=meta.num_real_tris, **walk_levels(scene),
               shape=[cfg.width, cfg.height, cfg.max_refract_depth, cfg.spp],
               card=card_line(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
