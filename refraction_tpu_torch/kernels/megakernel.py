"""Round kernel wrapper (``csrc/round.cu``): port of
`refraction_tpu.kernels.megakernel` ``mega_round``.

One wavefront bounce round over an (8, W) float32 lane state, rows
``ox oy oz dx dy dz cull wgt`` (cull = +1 outside, -1 inside, 0 dead):
closest hit, the weighted env radiance of live misses, and the
ClosestHit shading that emits the children. Three variants, as the JAX
kernel's three bodies:

- ``want_children and want_reflect``: refraction and reflection children,
  next state (8, 2W) with the refraction child of lane i at i and its
  reflection child at W + i (the JAX integrator's concatenation);
- ``want_children`` only: the refraction child, next state (8, W);
- neither: radiance only (the depth-cap round, where hits add black).

A refraction child is alive where its parent hit and did not totally
internally reflect; a reflection child on every hit. Dead children have
cull 0, weight 0 and direction (0, 1, 0); their origin is the hit point,
or the parent's origin where it did not hit.

``mega_round`` launches the kernel for CUDA tensors and takes the plain
version, ``mega_round_plain``, for CPU tensors.

``mega_round_queue`` is the same round over a compacted queue of live
lanes (`LaneQueue`), the wavefront's layout: each queued lane carries its
slot id, its index in the static layout above (pixel = slot % N). The
round's miss radiance is added to an (N, 3) running radiance as the
static layout's per-pixel sum, a pixel's lanes in slot order whatever the
queue order (`slot_order_sum`), and only its live children are appended
to the next queue, the refraction child with slot s and the reflection
child with s + W (W = the round's static width). On CUDA the kernel reads
the live count on the device, so no round waits for the host; where a
round can put several lanes on a pixel (W > N) the lanes store their
radiance in a scratch slab and a second small kernel, `fold_round_sums`,
adds each pixel's entries in slot order. ``mega_round_queue_plain`` and
``fold_round_sums_plain`` are the plain versions, taken for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from refraction_tpu_torch.kernels._build import check, launch, library, on_device
from refraction_tpu_torch.kernels.envmap import check_envmap, env_contribution_plain
from refraction_tpu_torch.kernels.intersect import check_scene_tables, closest_hit_plain
from refraction_tpu_torch.ops.shade import (
    dot3,
    f32,
    fresnel_r,
    normalize,
    reflect_dir,
    refract_dir,
)

STATE_ROWS = 8  # ox oy oz dx dy dz cull wgt
# Variant codes of rt_round (RtRoundVariant in round.cu).
_FULL, _CHILDREN, _RADIANCE = 0, 1, 2
# Grid cap of the compacted round, in 128-thread blocks per SM (PERF.md
# PR 5: faster than an uncapped or an occupancy-sized grid).
BLOCKS_PER_SM = 32
# The most lanes of one pixel in a compacted round: one bit each of the
# int32 mask that names their slab rows to the fold kernel.
MASK_BITS = 32


class RoundOut(NamedTuple):
    """What one round produces."""

    radiance: torch.Tensor          # (W, 3) weighted env radiance of misses
    children: torch.Tensor | None   # (8, 2W) | (8, W) next state, or None


class LaneQueue(NamedTuple):
    """The input or output of one compacted round: lanes ``[0, count)`` of
    ``state`` and ``slot`` are queued, in no fixed order. Their slots are
    distinct and below ``width``, as the wavefront makes them; the CUDA
    kernel relies on it (no two lanes write one radiance entry)."""

    state: torch.Tensor   # (8, cap) float32 lane state, row length cap
    slot: torch.Tensor    # (cap,) int32: each lane's index in the static layout
    count: torch.Tensor   # (1,) int32 on the lanes' device: lanes queued
    width: int            # the round's static width W (<= cap)


def empty_queue(cap: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Uninitialized (state (8, cap), slot (cap,)) buffers of a queue."""
    return (torch.empty(STATE_ROWS, cap, dtype=torch.float32, device=device),
            torch.empty(cap, dtype=torch.int32, device=device))


def _check_state(state: torch.Tensor) -> None:
    if (state.dim() != 2 or state.shape[0] != STATE_ROWS
            or state.dtype != torch.float32 or not state.is_contiguous()):
        raise ValueError(
            f"state: want contiguous float32 ({STATE_ROWS}, W), got "
            f"{state.dtype} {tuple(state.shape)}")


def _limits(limits: Sequence[float]) -> tuple[float, float, float, float]:
    if len(limits) != 4:
        raise ValueError(f"limits: want (tmin, tmax, ior, fresnel_r0), got "
                         f"{limits!r}")
    return tuple(f32(x) for x in limits)


def slot_order_sum(radiance: torch.Tensor, n: int) -> torch.Tensor:
    """(N, 3) per-pixel sums of a static round's (W, 3) lane radiance, W a
    multiple of N: ``((0 + r[p]) + r[N + p]) + r[2N + p] ...``, a pixel's
    lanes in ascending slot. The one order every wavefront of the package
    sums in (``Tensor.sum`` leaves the order to the device)."""
    lanes = radiance.reshape(-1, n, 3)
    total = torch.zeros_like(lanes[0])
    for j in range(lanes.shape[0]):
        total = total + lanes[j]
    return total


def mega_round_plain(scene, state: torch.Tensor, limits: Sequence[float],
                     want_reflect: bool, want_children: bool) -> RoundOut:
    """The round in plain PyTorch: brute-force closest hit, gather env and
    the shading ops of ops/shade.py, in the kernel's float32 order."""
    _check_state(state)
    tmin, tmax, ior, r0 = _limits(limits)
    dev = state.device
    o, d = state[0:3].t(), state[3:6].t()
    cull, wgt = state[6], state[7]
    t, idx, normal = closest_hit_plain(scene, o, d, cull, tmin, tmax)
    hit = idx >= 0  # False on dead lanes
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    radiance = env_contribution_plain(
        scene, d, torch.where((cull != 0) & ~hit, wgt, zero))
    if not want_children:
        return RoundOut(radiance, None)

    outside = cull > 0
    n = normalize(normal)
    nprime = torch.where(outside[:, None], n, -n)
    r = fresnel_r(dot3(d, nprime), r0)
    # eta = 1/ior in float32 from the float32 ior, as the kernel computes
    # it; a device-tensor divide, since CUDA divides by a Python scalar as
    # a multiply by its reciprocal.
    ior_t = torch.tensor(ior, dtype=torch.float32, device=dev)
    eta = torch.where(outside, torch.ones_like(ior_t) / ior_t, ior_t)
    ok, refr = refract_dir(d, nprime, eta)
    safe_dir = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    safe_o = torch.where(hit[:, None], o + t[:, None] * d, o)
    refr_alive = hit & ok
    rows = [safe_o.t(),
            torch.where(refr_alive[:, None], refr, safe_dir).t(),
            torch.where(refr_alive, -cull, zero)[None],
            torch.where(refr_alive, wgt * (1.0 - r), zero)[None]]
    children = torch.cat(rows)
    if want_reflect:
        refl = normalize(reflect_dir(d, nprime))
        rows = [safe_o.t(),
                torch.where(hit[:, None], refl, safe_dir).t(),
                torch.where(hit, cull, zero)[None],
                torch.where(hit, wgt * r, zero)[None]]
        children = torch.cat([children, torch.cat(rows)], dim=1)
    return RoundOut(radiance, children.contiguous())


def mega_round(scene, state: torch.Tensor, limits: Sequence[float],
               want_reflect: bool, want_children: bool) -> RoundOut:
    """One bounce round of the (8, W) lane ``state`` (see the module doc).

    ``limits`` = (tmin, tmax, ior, fresnel_r0), rounded to float32 and
    passed to the kernel by value. On CUDA: one launch on the current
    stream, no host sync.
    """
    _check_state(state)
    if state.device.type == "cpu":
        return mega_round_plain(scene, state, limits, want_reflect,
                                want_children)
    if state.device.type != "cuda":
        raise ValueError(f"mega_round: unsupported device {state.device}")
    tmin, tmax, ior, r0 = _limits(limits)
    dev = state.device
    check_scene_tables(scene, dev)
    check_envmap(scene, dev)
    w = state.shape[1]
    variant = (_RADIANCE if not want_children
               else _FULL if want_reflect else _CHILDREN)
    rad = torch.empty(w, 3, dtype=torch.float32, device=dev)
    children = None
    if variant != _RADIANCE:
        children = torch.empty(STATE_ROWS, 2 * w if variant == _FULL else w,
                               dtype=torch.float32, device=dev)
    if w == 0:
        return RoundOut(rad, children)
    env = scene.envmap
    launch("rt_round", dev, tmin, tmax, ior, r0, scene.tri_packed.data_ptr(),
           scene.tri_norm_packed.data_ptr(), scene.super_bounds.data_ptr(),
           scene.cluster_bounds.data_ptr(), scene.sub_bounds.data_ptr(),
           env.data_ptr(), state.data_ptr(), w, rad.data_ptr(),
           None if children is None else children.data_ptr(), variant,
           scene.num_supers, scene.num_clusters, scene.cluster_size,
           scene.sub_tris, env.shape[0], env.shape[1])
    mega_round.launches += 1
    return RoundOut(rad, children)


mega_round.launches = 0


def _check_queue(name: str, q: LaneQueue, device: torch.device) -> None:
    cap = q.state.shape[1] if q.state.dim() == 2 else -1
    if (q.state.dim() != 2 or q.state.shape[0] != STATE_ROWS
            or q.state.dtype != torch.float32 or not q.state.is_contiguous()
            or q.slot.shape != (cap,) or q.slot.dtype != torch.int32
            or not q.slot.is_contiguous() or q.count.shape != (1,)
            or q.count.dtype != torch.int32 or not 0 <= q.width <= cap
            or {q.state.device, q.slot.device, q.count.device} != {device}):
        raise ValueError(
            f"{name}: want contiguous float32 ({STATE_ROWS}, cap) state, "
            f"int32 (cap,) slot, int32 (1,) count on {device} and width <= "
            f"cap, got {q.state.dtype} {tuple(q.state.shape)}, "
            f"{q.slot.dtype} {tuple(q.slot.shape)}, {q.count.dtype} "
            f"{tuple(q.count.shape)}, width {q.width}")


def _check_queue_round(queue, want_reflect, want_children, radiance,
                       pixel_rays, out) -> None:
    dev = queue.state.device
    _check_queue("queue", queue, dev)
    n = radiance.shape[0] if radiance.dim() == 2 else 0
    if (radiance.shape != (n, 3) or n < 1 or radiance.dtype != torch.float32
            or not radiance.is_contiguous() or radiance.device != dev):
        raise ValueError(f"radiance: want contiguous float32 (N, 3), N >= 1, "
                         f"on {dev}, got {radiance.dtype} "
                         f"{tuple(radiance.shape)} on {radiance.device}")
    if pixel_rays is not None and (
            pixel_rays.shape != (n,) or pixel_rays.dtype != torch.int32
            or not pixel_rays.is_contiguous() or pixel_rays.device != dev):
        raise ValueError(f"pixel_rays: want contiguous int32 ({n},) on {dev}")
    if not want_children:
        if out is not None:
            raise ValueError("out: a radiance-only round emits no children")
        return
    if out is None:
        raise ValueError("out: a round with children needs the next queue")
    _check_queue("out", out, dev)
    want = queue.width * (2 if want_reflect else 1)
    if out.width != want:
        raise ValueError(f"out.width: want {want} (the next round's static "
                         f"width), got {out.width}")


def mega_round_queue_plain(scene, queue: LaneQueue, limits: Sequence[float],
                           want_reflect: bool, want_children: bool,
                           radiance: torch.Tensor,
                           pixel_rays: torch.Tensor | None = None,
                           out: LaneQueue | None = None) -> None:
    """The compacted round in plain PyTorch: the queued lanes in slot
    order through `mega_round_plain`; the round's radiance summed per
    pixel over its lanes in ascending slot (`slot_order_sum` of the static
    layout, whose other lanes add +0.0) and that sum added to
    ``radiance``; counts added at their pixels; the live children
    (``torch.nonzero``) written to ``out`` in slot order. Reads the count
    on the host."""
    _check_queue_round(queue, want_reflect, want_children, radiance,
                       pixel_rays, out)
    c = int(queue.count)
    n = radiance.shape[0]
    slot, order = torch.sort(queue.slot[:c], stable=True)
    res = mega_round_plain(scene, queue.state[:, :c][:, order].contiguous(),
                           limits, want_reflect, want_children)
    pix = (slot % n).long()
    total = torch.zeros_like(radiance)
    for j in range(-(-queue.width // n)):
        at = torch.nonzero(slot // n == j).squeeze(1)  # distinct pixels
        total[pix[at]] = total[pix[at]] + res.radiance[at]
    radiance += total
    if pixel_rays is not None:
        pixel_rays.index_add_(0, pix, torch.ones_like(slot))
    if not want_children:
        return
    kid_slot = torch.cat([slot, slot + queue.width]) if want_reflect else slot
    keep = torch.nonzero(res.children[6] != 0).squeeze(1)
    k = int(keep.numel())
    if k > out.state.shape[1]:
        raise ValueError(f"out: {k} live children past its capacity "
                         f"{out.state.shape[1]}")
    out.state[:, :k] = res.children[:, keep]
    out.slot[:k] = kid_slot[keep]
    out.count.fill_(k)


def _check_fold(slab, mask, radiance) -> None:
    n = mask.shape[0] if mask.dim() == 1 else -1
    dev = radiance.device
    rows = slab.shape[0] if slab.dim() == 2 else -1
    if (n < 1 or mask.dtype != torch.int32 or radiance.shape != (n, 3)
            or slab.shape != (rows, 3) or rows % n or rows > MASK_BITS * n
            or {slab.dtype, radiance.dtype} != {torch.float32}
            or {slab.device, mask.device} != {dev}
            or not (slab.is_contiguous() and mask.is_contiguous()
                    and radiance.is_contiguous())):
        raise ValueError(
            f"fold_round_sums: want contiguous float32 slab (J * N, 3), J <= "
            f"{MASK_BITS}, int32 mask (N,) and float32 radiance (N, 3) on one "
            f"device, got {slab.dtype} {tuple(slab.shape)}, {mask.dtype} "
            f"{tuple(mask.shape)}, {radiance.dtype} {tuple(radiance.shape)}")


def fold_round_sums_plain(slab: torch.Tensor, mask: torch.Tensor,
                          radiance: torch.Tensor) -> None:
    """`fold_round_sums` in plain PyTorch: slab rows whose bit is unset
    count as +0.0, then `slot_order_sum`."""
    _check_fold(slab, mask, radiance)
    n = mask.shape[0]
    bits = torch.arange(slab.shape[0] // n, dtype=torch.int32,
                        device=mask.device)[:, None]
    named = ((mask[None] >> bits) & 1).bool().reshape(-1, 1)
    radiance += slot_order_sum(torch.where(named, slab, 0.0), n)
    mask.zero_()


def fold_round_sums(slab: torch.Tensor, mask: torch.Tensor,
                    radiance: torch.Tensor) -> None:
    """Adds to ``radiance`` (N, 3), per pixel p, the sum of the ``slab``
    (J * N, 3) rows j * N + p whose bit j is set in ``mask`` (N,) int32,
    added to +0.0 in ascending j, and clears ``mask``: the second half of
    a compacted round of more than one lane per pixel (csrc/round.cu).
    Rows whose bit is unset are never read and may be uninitialized. On
    CUDA: one launch on the current stream, no host sync."""
    _check_fold(slab, mask, radiance)
    if radiance.device.type == "cpu":
        fold_round_sums_plain(slab, mask, radiance)
        return
    if radiance.device.type != "cuda":
        raise ValueError(f"fold_round_sums: unsupported device "
                         f"{radiance.device}")
    launch("rt_fold_round", radiance.device, slab.data_ptr(),
           mask.data_ptr(), mask.shape[0], radiance.data_ptr())
    fold_round_sums.launches += 1


fold_round_sums.launches = 0


class QueueRound:
    """`mega_round_queue` bound to one scene on one device, with the
    scene's tables and map checked and their pointers and the grid cap
    (BLOCKS_PER_SM per SM) taken once: the wavefront makes one per frame
    and calls it per round, so a round costs the host one ctypes call, or
    two where it has several lanes per pixel (the round, then the fold).
    It keeps the slab and the mask of those rounds, made at the first one
    and reused by the later ones (the fold leaves the mask cleared). The
    rounds run on the stream that was current when it was made. On the CPU
    it takes the plain version."""

    def __init__(self, scene, device):
        self.scene, self.device = scene, torch.device(device)
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"mega_round_queue: unsupported device {device}")
        check_scene_tables(scene, self.device)
        check_envmap(scene, self.device)
        env = scene.envmap
        self._launch = library().rt_round_queue
        self._launch_fold = library().rt_fold_round
        self._tables = tuple(x.data_ptr() for x in (
            scene.tri_packed, scene.tri_norm_packed, scene.super_bounds,
            scene.cluster_bounds, scene.sub_bounds, env))
        sms = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        self._stream = torch.cuda.current_stream(self.device).cuda_stream
        self._sizes = (scene.num_supers, scene.num_clusters,
                       scene.cluster_size, scene.sub_tris, env.shape[0],
                       env.shape[1], BLOCKS_PER_SM * sms, self._stream)
        self._slab = self._mask = None

    def _scratch(self, width: int, n: int):
        """(slab, mask) for a round of ``width`` lanes on ``n`` pixels."""
        if width > MASK_BITS * n:
            raise ValueError(f"queue.width {width}: more than {MASK_BITS} "
                             f"lanes per pixel ({n} pixels)")
        rows = -(-width // n) * n
        if self._slab is None or self._slab.shape[0] < rows:
            self._slab = torch.empty(rows, 3, dtype=torch.float32,
                                     device=self.device)
        if self._mask is None or self._mask.shape[0] != n:
            self._mask = torch.zeros(n, dtype=torch.int32, device=self.device)
        return self._slab, self._mask

    def __call__(self, queue: LaneQueue, limits: Sequence[float],
                 want_reflect: bool, want_children: bool,
                 radiance: torch.Tensor,
                 pixel_rays: torch.Tensor | None = None,
                 out: LaneQueue | None = None) -> None:
        """One round, as `mega_round_queue`, on buffers the caller has
        checked (`mega_round_queue` checks them; the wavefront makes its
        own)."""
        if self.device.type == "cpu":
            mega_round_queue_plain(self.scene, queue, limits, want_reflect,
                                   want_children, radiance, pixel_rays, out)
            return
        n = radiance.shape[0]
        slab, mask = ((None, None) if queue.width <= n
                      else self._scratch(queue.width, n))
        with on_device(self.device):
            err = self._launch(
                *_limits(limits), *self._tables, queue.state.data_ptr(),
                queue.slot.data_ptr(), queue.count.data_ptr(),
                queue.state.shape[1], queue.width, n, radiance.data_ptr(),
                None if slab is None else slab.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if pixel_rays is None else pixel_rays.data_ptr(),
                None if out is None else out.state.data_ptr(),
                None if out is None else out.slot.data_ptr(),
                None if out is None else out.count.data_ptr(),
                0 if out is None else out.state.shape[1],
                _RADIANCE if not want_children
                else _FULL if want_reflect else _CHILDREN, *self._sizes)
            check(err, "rt_round_queue")
            mega_round_queue.launches += 1
            if slab is not None:
                check(self._launch_fold(slab.data_ptr(), mask.data_ptr(), n,
                                        radiance.data_ptr(), self._stream),
                      "rt_fold_round")
                fold_round_sums.launches += 1


def mega_round_queue(scene, queue: LaneQueue, limits: Sequence[float],
                     want_reflect: bool, want_children: bool,
                     radiance: torch.Tensor,
                     pixel_rays: torch.Tensor | None = None,
                     out: LaneQueue | None = None) -> None:
    """One bounce round of the compacted ``queue`` (see the module doc).

    Adds the round's miss radiance to ``radiance`` (N, 3): per pixel the
    radiance of its queued lanes (pixel = slot % N) summed in ascending
    slot, as the static layout sums them, then that sum added to the
    pixel; with ``pixel_rays`` (N,) int32 adds one per queued lane; with
    ``want_children`` appends the live children to ``out``, whose count
    the caller sets (normally to 0) and whose width is the next round's
    static width. ``limits`` as for `mega_round`. On CUDA:
    one round-kernel launch on the current stream, also for an empty
    queue, a `fold_round_sums` launch after it where ``queue.width`` > N,
    and no host sync; the order of the appended lanes is not fixed, the
    radiance is the same on every run.
    """
    _check_queue_round(queue, want_reflect, want_children, radiance,
                       pixel_rays, out)
    QueueRound(scene, queue.state.device)(queue, limits, want_reflect,
                                          want_children, radiance,
                                          pixel_rays, out)


mega_round_queue.launches = 0
