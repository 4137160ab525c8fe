"""LBVH over Morton order, with closest-hit traversal: port of
`refraction_tpu.bvh.lbvh`.

The tree is a complete binary tree over the Morton-sorted triangles (a
segment tree): leaves are the sorted triangles padded to a power of two
with inverted boxes and zero-edge triangles, node k's children are 2k+1
and 2k+2, and the hierarchy is two (2L-1, 3) box tables built by
bottom-up min/max passes. `build_lbvh` runs on the device of its inputs.

`lbvh_intersect` is a traversal *oracle*: a second implementation of
closest hit, structurally independent of the cluster traversal of the
CUDA kernels (csrc/traverse_f2b.cuh) and of the brute force
(ops/intersect.py), for property tests; it is no production path and has
no kernel. The JAX version is ``vmap`` over a per-ray ``while_loop``,
which XLA runs as one loop stepping every ray in lock step until every
stack is empty; here the same loop is written with tensors: an (N, depth
+ 2) stack and an (N,) stack pointer, and in each iteration every ray
whose stack is not empty pops one node. The per-ray visit order is the
JAX loop's (right child pushed, then left), so equal-t ties go to the
lowest *sorted* index, as in the JAX version (a documented deviation from
the brute force's lowest original index; measure-zero for real geometry).

Note on the padding: the slab test is symmetric in lo and hi, so an
inverted box [3e38, -3e38] is entered like the whole space; the padding
leaves are never hit because their triangles have det == 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refraction_tpu_torch.bvh.morton import morton3d_torch
from refraction_tpu_torch.ops.intersect import _cross, _safe_inv, _slab
from refraction_tpu_torch.ops.shade import dot3, f32


class LBVH(NamedTuple):
    node_lo: torch.Tensor   # (2L-1, 3) node AABB minima, heap order
    node_hi: torch.Tensor   # (2L-1, 3) node AABB maxima
    tri_a: torch.Tensor     # (L, 3) sorted (+padded) triangle data
    tri_e1: torch.Tensor    # (L, 3)
    tri_e2: torch.Tensor    # (L, 3)
    order: torch.Tensor     # (L,) int32: sorted index -> original triangle

    @property
    def num_leaves(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def depth(self) -> int:
        return int(self.num_leaves).bit_length() - 1


_INF = 3.0e38


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def build_lbvh(tri_a: torch.Tensor, tri_e1: torch.Tensor,
               tri_e2: torch.Tensor) -> LBVH:
    """Build on the device of ``tri_a``: Morton codes of the box centres
    (`morton3d_torch`), a stable argsort, padding to a power of two, then
    log2(L) min/max passes into heap order (root at 0)."""
    t = tri_a.shape[0]
    v1 = tri_a + tri_e1
    v2 = tri_a + tri_e2
    lo = torch.minimum(torch.minimum(tri_a, v1), v2)
    hi = torch.maximum(torch.maximum(tri_a, v1), v2)
    centroid = (lo + hi) * 0.5
    codes = morton3d_torch(centroid, lo.amin(dim=0), hi.amax(dim=0))
    order = torch.argsort(codes, stable=True)

    pad = _next_pow2(max(t, 1)) - t
    lo_s, hi_s = lo[order], hi[order]
    a_s, e1_s, e2_s = tri_a[order], tri_e1[order], tri_e2[order]
    order = order.to(torch.int32)
    if pad:
        # Empty leaves: inverted boxes and zero-edge (never hit) triangles.
        def tail(value, like):
            return torch.cat([like, torch.full((pad, *like.shape[1:]), value,
                                               dtype=like.dtype,
                                               device=like.device)])

        lo_s, hi_s = tail(_INF, lo_s), tail(-_INF, hi_s)
        a_s, e1_s, e2_s = tail(0.0, a_s), tail(0.0, e1_s), tail(0.0, e2_s)
        order = tail(0, order)

    # Bottom-up union passes: level d has 2^d nodes.
    levels_lo, levels_hi = [lo_s], [hi_s]
    while levels_lo[0].shape[0] > 1:
        levels_lo.insert(0, levels_lo[0].reshape(-1, 2, 3).amin(dim=1))
        levels_hi.insert(0, levels_hi[0].reshape(-1, 2, 3).amax(dim=1))
    return LBVH(torch.cat(levels_lo), torch.cat(levels_hi), a_s, e1_s, e2_s,
                order)


def lbvh_from_scene(scene) -> LBVH:
    """`build_lbvh` over a `TorchScene`'s triangles, on its device."""
    return build_lbvh(scene.tri_a, scene.tri_e1, scene.tri_e2)


def _tri_test(o, d, a, e1, e2, tmin, tmax, want_front):
    """Möller–Trumbore on paired rows (lbvh.py:126-138): the plain divide
    by det, with det 0 replaced by 1."""
    pvec = _cross(d, e2)
    det = dot3(e1, pvec)
    accept = torch.where(want_front, det > 0, det < 0)
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = o - a
    u = dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    ok = (accept & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t >= tmin) & (t <= tmax))
    return ok, t


def lbvh_intersect(bvh: LBVH, origins: torch.Tensor, dirs: torch.Tensor,
                   want_front: torch.Tensor, tmin: float, tmax: float):
    """Batched closest hit: (hit (N,) bool, t (N,) float32, original
    triangle index (N,) int32). Where ``hit`` is False, ``t`` is 3e38 and
    the index is ``order[0]``. ``tmin``/``tmax`` are rounded to float32.

    One iteration pops the top node of every ray whose stack is not empty:
    its box is tested on [tmin, min(tmax, best t)]; a leaf that is entered
    runs the triangle test and keeps a strictly smaller t; an inner node
    that is entered pushes its right child, then its left."""
    n, dev = origins.shape[0], origins.device
    tmin_t = torch.tensor(f32(tmin), dtype=torch.float32, device=dev)
    tmax_t = torch.tensor(f32(tmax), dtype=torch.float32, device=dev)
    boxes = torch.cat([bvh.node_lo, bvh.node_hi], dim=1)
    first_leaf = bvh.num_leaves - 1
    inv_d = _safe_inv(dirs)
    stack = torch.zeros(n, bvh.depth + 2, dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # the root is pushed
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int64, device=dev)
    ray = torch.arange(n, device=dev)  # the rays whose stack is not empty
    while ray.numel():
        # Every step is written over the whole active set (a masked update
        # where the JAX loop branches), so the only host read of the
        # iteration is the size of the next active set.
        top = sp[ray] - 1
        node = stack[ray, top]
        entered = _slab(boxes[node], origins[ray], inv_d[ray],
                        tmin_t.expand(ray.shape),
                        torch.minimum(tmax_t, best_t[ray]))
        inner = entered & (node < first_leaf)
        leaf = entered & (node >= first_leaf)
        stack[ray, top] = torch.where(inner, 2 * node + 2, node)
        stack[ray, top + 1] = torch.where(inner, 2 * node + 1,
                                          stack[ray, top + 1])
        sp[ray] = top + 2 * inner

        li = torch.clamp_min(node - first_leaf, 0)
        ok, t = _tri_test(origins[ray], dirs[ray], bvh.tri_a[li],
                          bvh.tri_e1[li], bvh.tri_e2[li], tmin_t, tmax_t,
                          want_front[ray])
        cur = best_t[ray]
        upd = leaf & ok & (t < cur)
        best_t[ray] = torch.where(upd, t, cur)
        best_i[ray] = torch.where(upd, li, best_i[ray])
        ray = ray[sp[ray] > 0]
    return best_t < 1e37, best_t, bvh.order[best_i]


def make_lbvh_backend(scene):
    """An IntersectFn (the eager integrator's contract, ops/backends.py)
    over an LBVH built once from ``scene``: ``(hit & alive, t, idx,
    None)``. Only live rays are traversed; the others return a miss. Per-
    ray masks raise ValueError: the tree serves the constant 0xff mask.
    On CUDA tensors it runs as torch operations on the card."""
    bvh = lbvh_from_scene(scene)

    def intersect(scene_, origins, dirs, want_front, alive, tmin, tmax,
                  ray_mask=None):
        del scene_
        if ray_mask is not None:
            raise ValueError("the LBVH backend serves the constant 0xff mask "
                             "only; per-ray masks need the 'torch' backend")
        n, dev = origins.shape[0], origins.device
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
        idx = bvh.order[torch.zeros(n, dtype=torch.int64, device=dev)]
        live = torch.nonzero(alive).squeeze(1)
        res = lbvh_intersect(bvh, origins[live], dirs[live],
                             want_front[live], tmin, tmax)
        for out, part in zip((hit, t, idx), res):
            out[live] = part
        return hit, t, idx, None

    return intersect
