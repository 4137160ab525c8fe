"""Morton (Z-order) codes for spatially coherent triangle ordering.

The reference gets spatial coherence for free from DXR's BLAS build
(`BuildRaytracingAccelerationStructure`, RefractionDemo.cpp:321); our
TPU-native equivalent sorts triangles along a 30-bit 3D Morton curve so that
contiguous *clusters* of triangles are spatially compact — the basis of both
the cluster-AABB culling kernel (kernels/) and the LBVH (bvh/lbvh.py).

The port's copy of the numpy part of `refraction_tpu.bvh.morton` (the
scene is built once, on the host), and torch counterparts of its jnp
helpers for the on-device LBVH build (bvh/lbvh.py): `expand_bits_torch`
and `morton3d_torch`.
"""

from __future__ import annotations

import numpy as np
import torch


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(points: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points inside the AABB [lo, hi]."""
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((points - lo) / extent, 0.0, 0.9999999)
    q = (q * 1024.0).astype(np.uint32)
    x = _expand_bits_np(q[..., 0])
    y = _expand_bits_np(q[..., 1])
    z = _expand_bits_np(q[..., 2])
    return (x << np.uint32(2)) | (y << np.uint32(1)) | z


def morton_order(tri_pos: np.ndarray) -> np.ndarray:
    """Stable Morton ordering of triangles by centroid. tri_pos: (T,3,3)."""
    if tri_pos.shape[0] == 0:
        return np.zeros(0, np.int64)
    centroids = tri_pos.mean(axis=1)
    lo = tri_pos.reshape(-1, 3).min(axis=0)
    hi = tri_pos.reshape(-1, 3).max(axis=0)
    codes = morton3d(centroids, lo, hi)
    return np.argsort(codes, kind="stable")


def _hilbert_keys(q: np.ndarray, bits: int = 10) -> np.ndarray:
    """30-bit Hilbert-curve keys for quantized coords q (T, 3) uint32.

    Skilling's AxesToTranspose (J. Skilling, "Programming the Hilbert
    curve", AIP Conf. Proc. 707, 2004), vectorized over all points; the
    transpose-format output interleaves into a single sortable key with
    the same bit layout as the Morton key. The Hilbert curve has no
    diagonal jumps, so equal-size clusters cut from it are spatially
    tighter than Morton's — same build cost, better AABBs.
    """
    X = [q[..., 0].astype(np.uint32), q[..., 1].astype(np.uint32),
         q[..., 2].astype(np.uint32)]
    n = 3
    M = np.uint32(1 << (bits - 1))
    # Inverse undo excess work.
    Q = M
    while Q > 1:
        P = np.uint32(Q - 1)
        for i in range(n):
            cond = (X[i] & Q) != 0
            X[0] = np.where(cond, X[0] ^ P, X[0])          # invert
            t = np.where(cond, np.uint32(0), (X[0] ^ X[i]) & P)
            X[0] = X[0] ^ t                                 # exchange
            X[i] = X[i] ^ t
        Q = np.uint32(Q >> 1)
    # Gray encode.
    for i in range(1, n):
        X[i] = X[i] ^ X[i - 1]
    t = np.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = np.where((X[n - 1] & Q) != 0, t ^ np.uint32(Q - 1), t)
        Q = np.uint32(Q >> 1)
    for i in range(n):
        X[i] = X[i] ^ t
    return ((_expand_bits_np(X[0]) << np.uint32(2))
            | (_expand_bits_np(X[1]) << np.uint32(1))
            | _expand_bits_np(X[2]))


def hilbert_order(tri_pos: np.ndarray) -> np.ndarray:
    """Stable Hilbert ordering of triangles by centroid. tri_pos: (T,3,3).

    Drop-in alternative to morton_order (RRT_CURVE=hilbert selects it in
    scene.build_scene); any triangle order is behaviorally valid — only
    cluster AABB tightness (i.e. traversal speed) changes.
    """
    if tri_pos.shape[0] == 0:
        return np.zeros(0, np.int64)
    centroids = tri_pos.mean(axis=1)
    lo = tri_pos.reshape(-1, 3).min(axis=0)
    hi = tri_pos.reshape(-1, 3).max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / extent, 0.0, 0.9999999)
    q = (q * 1024.0).astype(np.uint32)
    return np.argsort(_hilbert_keys(q), kind="stable")


def _split_rec(idx: np.ndarray, cent: np.ndarray, leaf: int,
               out: np.ndarray, pos: list) -> None:
    """Recursive longest-axis median split into leaves of ``leaf`` tris,
    written to ``out`` in tree order. Left children take full leaves
    (ceil-half of the leaf count), so every aligned ``leaf``-sized window
    of the output is one subtree."""
    if idx.size <= leaf:
        out[pos[0]:pos[0] + idx.size] = idx
        pos[0] += idx.size
        return
    leaves = -(-idx.size // leaf)
    c = cent[idx]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    k = min(((leaves + 1) // 2) * leaf, idx.size)
    part = np.argsort(c[:, axis], kind="stable")
    _split_rec(idx[part[:k]], cent, leaf, out, pos)
    _split_rec(idx[part[k:]], cent, leaf, out, pos)


def median_split_order(tri_pos: np.ndarray,
                       levels: tuple[int, ...]) -> np.ndarray:
    """Cascaded recursive median-split ordering (RRT_CURVE=median; see
    scene.build_scene for the default and knob values).

    ``levels`` is a descending list of window sizes mirroring the
    traversal hierarchy — (super_tris, cluster_size, sub_tris). Each
    stage re-splits every aligned window of the previous level along its
    longest centroid axis down to the next leaf size, so supers,
    clusters AND subclusters are all kd-style tree nodes of their own
    split. Unlike curve cuts (Morton/Hilbert), split axes adapt to the
    actual extent: measured cluster/subcluster AABB surface area vs
    Hilbert is -14%/-29% on ott.obj, -34%/-37% on monkey.obj, -26%/-27%
    on shell.obj, -48%/-47% on the 81,920-tri icosphere (whose super
    level NEEDS its own cascade stage: splitting straight to clusters
    measured super SA +25% vs Hilbert; the super stage turns that into
    -26%)."""
    T = tri_pos.shape[0]
    if T == 0:
        return np.zeros(0, np.int64)
    cent = tri_pos.mean(axis=1).astype(np.float64)
    order = np.arange(T)
    window = T
    for leaf in levels:
        out = np.empty(T, np.int64)
        pos = [0]
        for s in range(0, T, window):
            _split_rec(order[s:s + window], cent, leaf, out, pos)
        order = out
        window = leaf
    return order


def expand_bits_torch(v: torch.Tensor) -> torch.Tensor:
    """`_expand_bits_np` on a tensor of values below 1024: torch has no full
    uint32 arithmetic, so the products run in int64 (below 2^42 for such
    inputs, no overflow) and each ``&`` with a mask below 2^32 keeps what
    uint32 wraparound would. Returns int64."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d_torch(points: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """`morton3d` on the points' device: 30-bit codes as int64. The float32
    steps are the jnp version's; ``(q * 1024).to(int64)`` truncates toward
    zero, as ``astype(uint32)`` does for values that are not negative."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((points - lo) / extent, 0.0, 0.9999999)
    q = (q * 1024.0).to(torch.int64)
    x = expand_bits_torch(q[..., 0])
    y = expand_bits_torch(q[..., 1])
    z = expand_bits_torch(q[..., 2])
    return (x << 2) | (y << 1) | z
