"""The frame kernel's roofline: a lower bound on the card's time for a frame.

The work is counted here, from the benchmark's own reference, and never
from the program's tables, so that any kernel or acceleration structure is
held to the same yardstick and a change to either cannot make the count
stale:

- Rays: the live rays of the frame's ray trees (every ray traced, the
  primaries and the children, rays at the bounce cap included), counted by
  `rtbench.reference` on a fixed grid of about `GRID_PIXELS` pixels at the
  cell's pose and scaled to the frame, with the rays that hit and those
  that miss.
- Operations: a ray that hits is charged the least a balanced binary BVH
  over N triangles needs to reach its answer, 2 * ceil(log2 N) box tests
  and one Moller-Trumbore test; a ray that misses one box test, the root's,
  and the env lookup. Shading is not charged. So the count is a lower
  bound, labelled as such.
- Bytes: the triangles' corners and normals read once and the (H, W, 3)
  float32 image written once. The env map's texels are not charged:
  misses of neighbouring pixels and nearby directions read the same
  texels, and the whole map fits in the card's L2, so no count of them
  per miss is a lower bound.
- A scene of placed instances: each named mesh's triangles are charged
  their bytes once, however many visible instances place it, and each
  visible instance its 3x4 float32 transform (48 B), the least a walk
  over shared meshes must read. Operations stay those of the N placed
  triangles: since ceil(log2 I) + ceil(log2 T) >= ceil(log2 IT),
  2 ceil(log2 N) box tests bound a two-level walk over I instances of T
  triangles as well as a walk over the baked scene, so the count does
  not depend on how the program builds it.

Per-test operation counts and the peaks are frozen copies of the numbers
in refraction_tpu_torch/ops/intersect.py (``BOX_TEST_OPS`` 25: 6
subtracts, 6 multiplies, 6 min/max, 3 max and 3 min, 1 compare;
``MT_TEST_OPS`` 52) and refraction_tpu_torch/bounds.py (``ENV_RAY_OPS``
17; 67 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s of HBM, the
NVIDIA H100 SXM data sheet at its 700 W limit).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference import tracer

BOX_TEST_OPS = 25
MT_TEST_OPS = 52
ENV_RAY_OPS = 17
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
GRID_PIXELS = 16384


def grid_pixels(width: int, height: int) -> np.ndarray:
    """Flat ids of a regular grid of about `GRID_PIXELS` pixels, each at
    the centre of its cell."""
    step = max(1, round(math.sqrt(width * height / GRID_PIXELS)))
    xs = np.arange(step // 2, width, step)
    ys = np.arange(step // 2, height, step)
    return (ys[:, None] * width + xs[None, :]).reshape(-1)


def ray_counts(sc: tracer.Scene, render: dict, angle: float) -> dict:
    """Rays, hits and misses of one frame at ``angle``, scaled from the
    grid to every pixel and sample."""
    ids = grid_pixels(render["width"], render["height"])
    _, st = tracer.render_views(sc, render, [angle],
                                torch.as_tensor(ids)[None])
    scale = render["width"] * render["height"] / len(ids)
    return {k: v * scale for k, v in st.items()}


def bound(counts: dict, num_tris: int, render: dict,
          instanced: tuple[int, int] | None = None) -> dict:
    """The frame's operations, bytes and the bound in ms they give, for
    ``num_tris`` triangles in the world; ``instanced``, for a scene of
    placed instances, is (unique triangles, visible instances)."""
    depth = math.ceil(math.log2(max(num_tris, 2)))
    ops = (counts["hits"] * (2 * depth * BOX_TEST_OPS + MT_TEST_OPS)
           + counts["misses"] * (BOX_TEST_OPS + ENV_RAY_OPS))
    if instanced is None:
        read = num_tris * 2 * 9 * 4
    else:
        unique, visible = instanced
        read = unique * 2 * 9 * 4 + visible * 12 * 4
    nbytes = read + render["width"] * render["height"] * 3 * 4
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            **counts}
