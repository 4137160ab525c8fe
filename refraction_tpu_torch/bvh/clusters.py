"""Triangle clusters: the TPU-native acceleration structure (level 1 of 2).

Instead of a pointer-chasing BVH (which maps badly onto dense vector
hardware), triangles are Morton-sorted and chopped into equal-size clusters
with precomputed AABBs. The intersection kernels test a whole block of rays
against a cluster AABB with dense vector ops and skip the cluster's
triangles when no ray in the block can hit it — data-dependent *work
skipping* with fully static shapes, the TPU answer to DXR's hardware BVH
traversal (SURVEY.md 1, "what the reference gets for free from DXR").

The port's copy of `refraction_tpu.bvh.clusters`; the CUDA traversal
(csrc/traverse_f2b.cuh) reads the same boxes.
"""

from __future__ import annotations

import numpy as np


def build_clusters(tri_pos: np.ndarray, cluster_size: int):
    """Compute AABBs of contiguous clusters of ``cluster_size`` triangles.

    ``tri_pos`` must already be Morton-ordered and padded to a multiple of
    ``cluster_size`` with degenerate (point) triangles. Degenerate padding
    collapses to a point inside the last real cluster's bounds (padding
    repeats the last real triangle's first vertex), so AABBs stay tight.

    Returns (cluster_lo, cluster_hi): each (C, 3) float32.
    """
    t = tri_pos.shape[0]
    assert t % cluster_size == 0, (t, cluster_size)
    c = t // cluster_size
    grouped = tri_pos.reshape(c, cluster_size * 3, 3)
    lo = grouped.min(axis=1).astype(np.float32)
    hi = grouped.max(axis=1).astype(np.float32)
    return lo, hi


def ray_aabb_hit_np(origin, inv_dir, t0, t1, lo, hi):
    """Slab test (numpy oracle for the kernel's cluster test).

    origin/inv_dir: (..., 3); lo/hi: (3,) or broadcastable. Handles
    inv_dir = +/-inf (axis-parallel rays) the standard way: min/max of the
    two slab distances per axis, NaN-safe via min/max ordering.
    """
    ta = (lo - origin) * inv_dir
    tb = (hi - origin) * inv_dir
    tmin = np.minimum(ta, tb)
    tmax = np.maximum(ta, tb)
    enter = np.maximum(tmin.max(axis=-1), t0)
    leave = np.minimum(tmax.min(axis=-1), t1)
    return enter <= leave
