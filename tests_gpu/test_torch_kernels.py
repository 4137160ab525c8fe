"""CUDA kernels of refraction_tpu_torch vs their plain versions on the card,
and the frame kernel vs the NumPy oracle.

Tolerances: the kernels are built with -fmad=false, so traversal winners
and shading round like the plain float32 versions; images may still differ
in a few pixels where float noise flips a texel or a total-internal-
reflection test, so image bars are RMSE and a share of pixels. The
instrument kernels (mtbench, stallbench) run the plain versions' float32
operations in the same order, so they are compared exactly; the
tensor-core Woop kernel, whose mma adds its products in an order the
hardware does not specify, is held to kernels/mtbench.py ``tc_agreement``.
The compacted round sums a pixel's misses in slot order, so it and the
wavefront are compared with the static layout bit for bit.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from oracle.numpy_tracer import render_oracle
from refraction_tpu_torch import RenderConfig
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.io.primitives import (
    make_cube, make_gradient_envmap, make_icosphere)
from refraction_tpu_torch.fixtures import (
    multi_miss_lanes, paired_miss_lanes, two_balls)
from refraction_tpu_torch.integrator import (
    initial_state, render_pixels, render_pixels_mega, static_wavefront)
from refraction_tpu_torch.camera import generate_rays
from refraction_tpu_torch.kernels.envmap import (
    env_contribution, env_contribution_plain)
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars, fused_radiance, fused_radiance_plain)
from refraction_tpu_torch.kernels.intersect import (
    closest_hit, closest_hit_plain)
from refraction_tpu_torch.kernels.megakernel import (
    LaneQueue, empty_queue, fold_round_sums, fold_round_sums_plain,
    mega_round, mega_round_plain, mega_round_queue, mega_round_queue_plain,
    slot_order_sum)
from refraction_tpu_torch.kernels.mtbench import (
    make_inputs, mt_args, mt_visits, mt_visits_plain, tc_agreement,
    woop_args, woop_visits, woop_visits_plain, woop_visits_tc,
    woop_visits_tc3, woop_visits_tc_plain)
from refraction_tpu_torch.kernels.stallbench import (
    VARIANTS, mixed_carry, stall_iters, stall_iters_plain)
from refraction_tpu_torch.ops.backends import get_backend
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.scene import build_scene, scene_from_jax

pytestmark = pytest.mark.cuda

AGREE = 0.9999               # share of rays with equal winner / texel
IMG_RMSE, PIX_TOL, PIX_SHARE = 1e-4, 1e-3, 1e-3


def _scenes():
    return {"cube": build_scene(make_cube(2.0), make_gradient_envmap(), 8)[0],
            "sphere": build_scene(make_icosphere(3, 1.2),
                                  make_gradient_envmap(), 128)[0]}


def _rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cull = rng.choice(np.float32([-1.0, 0.0, 1.0]), n).astype(np.float32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(cull).to(dev))


def _img_ok(a, b):
    d = (a - b).abs()
    rmse = float(torch.sqrt(torch.mean(d.double() ** 2)))
    share = float((d.amax(dim=-1) > PIX_TOL).double().mean())
    return rmse < IMG_RMSE and share <= PIX_SHARE, (rmse, share)


@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_closest_hit_kernel_matches_plain(cuda, name):
    scene = scene_from_jax(_scenes()[name], cuda)
    o, d, cull = _rays(20000, 1, cuda)
    before = closest_hit.launches
    t_k, i_k, n_k = closest_hit(scene, o, d, cull, 1e-4, 100.0)
    assert closest_hit.launches == before + 1
    t_p, i_p, n_p = closest_hit_plain(scene, o, d, cull, 1e-4, 100.0)
    torch.cuda.synchronize()
    assert float((i_k == i_p).double().mean()) >= AGREE
    assert not bool((i_k[cull == 0] >= 0).any())
    both = (i_k == i_p) & (i_p >= 0)
    assert int(both.sum()) > 500
    torch.testing.assert_close(t_k[both], t_p[both], rtol=1e-6, atol=0)
    torch.testing.assert_close(n_k[both], n_p[both], rtol=1e-6, atol=1e-7)


def test_env_kernel_matches_plain(cuda):
    scene = scene_from_jax(
        build_scene(make_cube(2.0), make_gradient_envmap(512, 1024), 8)[0],
        cuda)
    _, d, _ = _rays(50000, 2, cuda)
    w = torch.rand(50000, generator=torch.Generator().manual_seed(3)).to(cuda)
    w[::3] = 0.0
    before = env_contribution.launches
    got = env_contribution(scene, d, w)
    assert env_contribution.launches == before + 1
    ref = env_contribution_plain(scene, d, w)
    assert float((got == ref).all(dim=1).double().mean()) >= AGREE
    assert bool((got[w == 0] == 0).all())


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_frame_kernel_matches_plain(cuda, name, spp):
    scene = scene_from_jax(_scenes()[name], cuda)
    cfg = RenderConfig(width=96, height=70, spp=spp)
    scal = build_scalars(orbit_camera(0.4, cfg), cfg, sample_offsets(spp), cuda)
    before = fused_radiance.launches
    img_k = fused_radiance(scene, scal, cfg)
    assert fused_radiance.launches == before + 1
    assert img_k.shape == (70, 96, 3)
    ok, why = _img_ok(img_k, fused_radiance_plain(scene, scal, cfg))
    assert ok, why


def test_frame_kernel_at_large_scene(cuda):
    """81,920 triangles: the size the TPU path had to stream."""
    mesh = make_icosphere(6, 1.2)
    scene = scene_from_jax(build_scene(mesh, make_gradient_envmap(), 512)[0],
                           cuda)
    cfg = RenderConfig(width=48, height=32, max_refract_depth=4)
    scal = build_scalars(orbit_camera(0.2, cfg), cfg, sample_offsets(1), cuda)
    ok, why = _img_ok(fused_radiance(scene, scal, cfg),
                      fused_radiance_plain(scene, scal, cfg))
    assert ok, why


@pytest.mark.parametrize("case", ["caps10", "ragged250x190"])
def test_frame_kernel_matches_plain_at_the_edges(cuda, case):
    """The sphere where test_frame_kernel_matches_plain does not reach:
    caps (1, 0) end every tree with an any-hit ray; a ragged 250x190
    frame has partial 16x8 blocks."""
    (w, h), (refract, reflect), angle = {
        "caps10": ((96, 70), (1, 0), 0.5),
        "ragged250x190": ((250, 190), (5, 2), 0.6)}[case]
    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=w, height=h, max_refract_depth=refract,
                       max_reflect_depth=reflect)
    scal = build_scalars(orbit_camera(angle, cfg), cfg, sample_offsets(1),
                         cuda)
    before = fused_radiance.launches
    img_k = fused_radiance(scene, scal, cfg)
    assert fused_radiance.launches == before + 1
    assert img_k.shape == (h, w, 3)
    assert float(img_k.std()) > 0
    ok, why = _img_ok(img_k, fused_radiance_plain(scene, scal, cfg))
    assert ok, why


def test_frame_kernel_matches_oracle(cuda):
    # The oracle reads the JAX package's Scene (it needs tri_norm); its
    # uploaded leaves equal the port's build bit for bit.
    from refraction_tpu.scene import build_scene as jax_build_scene

    sc = jax_build_scene(make_icosphere(3, 1.2), make_gradient_envmap(), 128)[0]
    cfg = RenderConfig(width=64, height=48)
    frame = orbit_camera(0.85, cfg)
    img = fused_radiance(scene_from_jax(sc, cuda),
                         build_scalars(frame, cfg, sample_offsets(1), cuda), cfg)
    ref = torch.from_numpy(render_oracle(sc, cfg, frame=frame)).to(cuda)
    ok, why = _img_ok(img, ref)
    assert ok, why


def test_cuda_backend_integrator_matches_torch_backend(cuda):
    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=64, height=48)
    o, d = generate_rays(orbit_camera(0.85, cfg), 64, 48, cuda)
    out = {}
    for name in ("cuda", "torch"):
        be = get_backend(name)
        out[name] = render_pixels(scene, o, d, cfg, be.intersect,
                                  be.env_contribution)
    ok, why = _img_ok(out["cuda"].reshape(48, 64, 3),
                      out["torch"].reshape(48, 64, 3))
    assert ok, why


def test_wrappers_reject_mixed_devices(cuda):
    scene = scene_from_jax(_scenes()["cube"], "cpu")
    o, d, cull = _rays(16, 4, cuda)
    with pytest.raises(ValueError, match="scene"):
        closest_hit(scene, o, d, cull, 1e-4, 100.0)
    cfg = RenderConfig(width=8, height=8, max_reflect_depth=8,
                       max_refract_depth=9)
    scal = build_scalars(orbit_camera(0.1, cfg), cfg, sample_offsets(1), cuda)
    with pytest.raises(ValueError, match="stack"):
        fused_radiance(scene_from_jax(_scenes()["cube"], cuda), scal, cfg)


@pytest.mark.parametrize("variant", ["full", "norefl", "missonly"])
@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_round_kernel_matches_plain(cuda, name, variant):
    want_reflect, want_children = {"full": (True, True),
                                   "norefl": (False, True),
                                   "missonly": (False, False)}[variant]
    scene = scene_from_jax(_scenes()[name], cuda)
    n = 20000
    o, d, cull = _rays(n, 5, cuda)
    state = initial_state(o, d)
    state[6] = cull
    w = torch.rand(n, generator=torch.Generator().manual_seed(6)).to(cuda)
    w[::7] = 1.4e-45  # subnormal: the reflection weight underflows to 0
    state[7] = w
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    before = mega_round.launches
    got = mega_round(scene, state, limits, want_reflect, want_children)
    assert mega_round.launches == before + 1
    ref = mega_round_plain(scene, state, limits, want_reflect, want_children)
    torch.cuda.synchronize()
    rad_off = (got.radiance - ref.radiance).abs().amax(dim=1) > PIX_TOL
    assert float(rad_off.double().mean()) <= 1 - AGREE
    assert not bool(got.radiance[cull == 0].any())
    if not want_children:
        assert got.children is None
        return
    assert got.children.shape == ref.children.shape
    alive_k, alive_p = got.children[6] != 0, ref.children[6] != 0
    assert float((alive_k == alive_p).double().mean()) >= AGREE
    if want_reflect:  # alive on every hit, whatever the weight
        hit = alive_p[n:]
        assert bool((got.children[6, n:][hit] == state[6][hit]).all())
        assert bool((got.children[7, n:][hit & (w < 1e-40)] == 0).all())
    same = alive_k == alive_p
    torch.testing.assert_close(got.children[:, same], ref.children[:, same],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_wavefront_matches_frame_kernel(cuda, name):
    scene = scene_from_jax(_scenes()[name], cuda)
    cfg = RenderConfig(width=96, height=70)
    frame = orbit_camera(0.4, cfg)
    o, d = generate_rays(frame, 96, 70, cuda)
    before = mega_round_queue.launches, mega_round.launches
    img, st = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
    assert (mega_round_queue.launches, mega_round.launches) == (
        before[0] + cfg.max_refract_depth + 1, before[1])
    frame_img = fused_radiance(
        scene, build_scalars(frame, cfg, sample_offsets(1), cuda), cfg)
    ok, why = _img_ok(img.reshape(70, 96, 3), frame_img)
    assert ok, why
    be = get_backend("torch")  # the eager integrator: the plain wavefront
    img_p, st_p = render_pixels(scene, o, d, cfg, be.intersect,
                                be.env_contribution, collect_stats=True)
    ok, why = _img_ok(img.reshape(70, 96, 3), img_p.reshape(70, 96, 3))
    assert ok, why
    assert int(st["rays_traced"]) == int(st_p["rays_traced"])
    assert st["slot_rounds"] == st_p["slot_rounds"]


@pytest.mark.parametrize("v", [64, 70])
@pytest.mark.parametrize("cull", ["ones", "mix"])
def test_mtbench_kernels_equal_plain(cuda, cull, v):
    """V = 70 wraps the 64-sub table; the mix has both cull signs."""
    inp = make_inputs(0)
    c = (None if cull == "ones" else
         np.random.default_rng(7).choice(np.float32([-1.0, 1.0]), 1024))
    for fn, plain, args in ((mt_visits, mt_visits_plain, mt_args(inp, cuda, c)),
                            (woop_visits, woop_visits_plain,
                             woop_args(inp, cuda, c))):
        before = fn.launches
        t, i = fn(*args, v)
        assert fn.launches == before + 1
        t_p, i_p = plain(*args, v)
        torch.cuda.synchronize()
        assert bool((t < 1e29).float().mean() > 0.9)
        assert torch.equal(t, t_p) and torch.equal(i, i_p)


@pytest.mark.parametrize("carry", ["ones", "mixed"])
@pytest.mark.parametrize("n_iter", [64, 70])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_kernel_equals_plain(cuda, variant, n_iter, carry):
    """On the tool's all-ones carry and on one whose elements differ (only
    there does a partial or misplaced block OR change the output)."""
    sm = torch.arange(1024, dtype=torch.float32, device=cuda)
    x = (torch.ones(8, 128, dtype=torch.float32, device=cuda)
         if carry == "ones" else torch.from_numpy(mixed_carry(0)).to(cuda))
    before = stall_iters.launches
    got = stall_iters(variant, n_iter, sm, x)
    assert stall_iters.launches == before + 1
    ref = stall_iters_plain(variant, n_iter, sm, x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _queue(cap, width, dev, lanes=None, slots=None):
    st, sl = empty_queue(cap, dev)
    count = 0 if lanes is None else lanes.shape[1]
    if count:
        st[:, :count] = lanes
        sl[:count] = slots
    return LaneQueue(st, sl, torch.tensor([count], dtype=torch.int32,
                                          device=dev), width)


@pytest.mark.parametrize("variant", ["full", "norefl", "missonly"])
@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_round_queue_kernel_matches_plain_and_static(cuda, name, variant):
    """The compacted kernel on a shuffled queue of the live lanes: against
    its plain version after sorting by slot, and bit for bit against the
    static kernel at each slot (one pixel per slot); then an empty queue."""
    want_reflect, want_children = {"full": (True, True),
                                   "norefl": (False, True),
                                   "missonly": (False, False)}[variant]
    scene = scene_from_jax(_scenes()[name], cuda)
    n = 20000
    o, d, cull = _rays(n, 5, cuda)
    state = initial_state(o, d)
    state[6] = cull
    w = torch.rand(n, generator=torch.Generator().manual_seed(6)).to(cuda)
    w[::7] = 1.4e-45
    state[7] = w
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    live = torch.nonzero(cull != 0).squeeze(1)
    live = live[torch.randperm(live.numel(),
                               generator=torch.Generator().manual_seed(7)
                               ).to(cuda)]
    w_out = n * (2 if want_reflect else 1)
    res = []
    for fn in (mega_round_queue, mega_round_queue_plain):
        out = _queue(w_out, w_out, cuda) if want_children else None
        rad = torch.zeros(n, 3, device=cuda)
        pix = torch.zeros(n, dtype=torch.int32, device=cuda)
        before = mega_round_queue.launches
        fn(scene, _queue(n, n, cuda, state[:, live], live.to(torch.int32)),
           limits, want_reflect, want_children, rad, pix, out)
        assert mega_round_queue.launches == before + (fn is mega_round_queue)
        res.append((rad, pix, out))
    static = mega_round(scene, state, limits, want_reflect, want_children)
    torch.cuda.synchronize()
    (rad_k, pix_k, out_k), (rad_p, pix_p, out_p) = res
    assert torch.equal(rad_k, static.radiance)
    off = (rad_k - rad_p).abs().amax(dim=1) > PIX_TOL
    assert float(off.double().mean()) <= 1 - AGREE
    assert torch.equal(pix_k, pix_p)
    assert torch.equal(pix_k, (cull != 0).to(torch.int32))
    if want_children:
        c = int(out_k.count)
        assert c <= w_out
        slots, order = torch.sort(out_k.slot[:c].long())
        kids = out_k.state[:, :c][:, order]
        alive = static.children[6] != 0
        assert torch.equal(slots, torch.nonzero(alive).squeeze(1))
        assert torch.equal(kids, static.children[:, slots])
        cp = int(out_p.count)
        only = set(slots.tolist()) ^ set(out_p.slot[:cp].tolist())
        assert len(only) <= (1 - AGREE) * n
        if want_reflect:  # weight-0 reflection children are queued
            under = (slots >= n) & (w[(slots - n).clamp(0, n - 1)] < 1e-40)
            assert int(under.sum()) > 0
            assert bool((kids[7][under] == 0).all())
    # An empty queue: one launch, nothing added or appended.
    out = _queue(w_out, w_out, cuda) if want_children else None
    rad = torch.zeros(n, 3, device=cuda)
    mega_round_queue(scene, _queue(n, n, cuda), limits, want_reflect,
                     want_children, rad, None, out)
    torch.cuda.synchronize()
    assert not bool(rad.any())
    assert out is None or int(out.count) == 0


@pytest.mark.parametrize("first", ["subnormal", "normal"])
def test_round_queue_kernel_keeps_a_subnormal_miss_beside_a_normal_one(
        cuda, first):
    """Two misses per pixel, a subnormal and a small normal radiance, the
    one or the other queued first: each pixel's sum equals the static
    layout's bit for bit, the subnormal kept (a float atomic add flushes a
    subnormal already in the sum)."""
    scene = scene_from_jax(_scenes()["sphere"], cuda)
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    p = 1 << 14
    state = torch.from_numpy(paired_miss_lanes(p, seed=4)).to(cuda)
    static = mega_round(scene, state, limits, False, False).radiance
    want = slot_order_sum(static, p)
    assert bool((want != static[p:]).any())  # the subnormals count
    order = torch.arange(2 * p, device=cuda)
    if first == "normal":
        order = order.roll(p)
    rad = torch.zeros(p, 3, device=cuda)
    mega_round_queue(scene, _queue(2 * p, 2 * p, cuda, state[:, order],
                                   order.to(torch.int32)),
                     limits, False, False, rad)
    torch.cuda.synchronize()
    assert torch.equal(rad, want)


@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_compacted_wavefront_equals_static_wavefront(cuda, name):
    """Stats exactly and the image bit for bit (both layouts sum a
    pixel's misses in slot order)."""
    scene = scene_from_jax(_scenes()[name], cuda)
    cfg = RenderConfig(width=250, height=190)
    o, d = generate_rays(orbit_camera(0.6, cfg), 250, 190, cuda)
    n = o.shape[0]
    img, st = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
    before = mega_round.launches
    ref, st_s = static_wavefront(scene, o, d, cfg, collect_stats=True)
    assert mega_round.launches == before + cfg.max_refract_depth + 1
    assert int(st["rays_traced"]) == int(st_s["rays_traced"]) > n
    assert torch.equal(st["pixel_rays"], st_s["pixel_rays"])
    assert st["slot_rounds"] == st_s["slot_rounds"]
    assert torch.equal(img, ref)


def test_wavefront_does_not_sync_the_host(cuda):
    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=96, height=70)
    o, d = generate_rays(orbit_camera(0.4, cfg), 96, 70, cuda)
    render_pixels_mega(scene, o, d, cfg)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        render_pixels_mega(scene, o, d, cfg)
        render_pixels_mega(scene, o, d, cfg, collect_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("order", ["slot", "reversed", "rolled", "shuffled"])
@pytest.mark.parametrize("k", [3, 4])
def test_round_queue_kernel_sums_three_and_four_misses_in_slot_order(
        cuda, k, order):
    """Three and four misses of every pixel in one round (subnormal, small
    and ordinary radiance mixed), in several queue orders, twice each: the
    kernel's sums equal the static layout's and the plain version's bit
    for bit, on top of a radiance already there; the round is one round
    launch and one fold launch."""
    scene = scene_from_jax(_scenes()["sphere"], cuda)
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    p = 1 << 13
    state = torch.from_numpy(multi_miss_lanes(p, k, seed=31)).to(cuda)
    static = mega_round(scene, state, limits, False, False).radiance
    want = slot_order_sum(static, p)
    backwards = slot_order_sum(static.reshape(k, p, 3).flip(0).reshape(-1, 3),
                               p)
    assert float((backwards != want).any(dim=1).float().mean()) > 0.1
    m = k * p
    idx = {"slot": torch.arange(m), "reversed": torch.arange(m).flip(0),
           "rolled": torch.arange(m).roll(m // 3),
           "shuffled": torch.randperm(
               m, generator=torch.Generator().manual_seed(32))}[order].to(cuda)
    before = torch.rand(p, 3, generator=torch.Generator().manual_seed(33)
                        ).to(cuda)
    for fn in (mega_round_queue, mega_round_queue, mega_round_queue_plain):
        rad = before.clone()
        counts = (mega_round_queue.launches, fold_round_sums.launches)
        fn(scene, _queue(m, m, cuda, state[:, idx], idx.to(torch.int32)),
           limits, False, False, rad)
        torch.cuda.synchronize()
        made = int(fn is mega_round_queue)
        assert (mega_round_queue.launches, fold_round_sums.launches) == (
            counts[0] + made, counts[1] + made)
        assert torch.equal(rad, before + want)


@pytest.mark.parametrize("j", [2, 4, 8])
def test_fold_kernel_equals_plain(cuda, j):
    """The fold kernel against its plain version: only the rows the mask
    names are read (NaN elsewhere), the mask comes back cleared."""
    n = 50001
    g = torch.Generator().manual_seed(j)
    lanes = (torch.rand(j * n, 3, generator=g)
             * 10.0 ** torch.randint(-8, 1, (j * n, 1), generator=g)).to(cuda)
    bits = torch.randint(0, 2, (j, n), generator=g, dtype=torch.int32).to(cuda)
    mask = (bits << torch.arange(j, dtype=torch.int32, device=cuda)[:, None]
            ).sum(dim=0, dtype=torch.int32)
    slab = torch.where(bits.bool().reshape(-1, 1), lanes,
                       torch.full_like(lanes, float("nan")))
    before = torch.rand(n, 3, generator=g).to(cuda)
    out = []
    for fn in (fold_round_sums, fold_round_sums_plain):
        rad, msk = before.clone(), mask.clone()
        launches = fold_round_sums.launches
        fn(slab, msk, rad)
        torch.cuda.synchronize()
        assert fold_round_sums.launches == launches + (fn is fold_round_sums)
        assert not bool(msk.any())
        out.append(rad)
    assert torch.equal(out[0], out[1])
    assert bool(torch.isfinite(out[0]).all())


def test_compacted_wavefront_with_three_misses_of_a_pixel(cuda):
    """Two balls, three reflections: pixels with three misses in a round.
    The image equals the static layout's bit for bit, twice in a row."""
    scene = scene_from_jax(build_scene(two_balls(3), make_gradient_envmap(),
                                       128)[0], cuda)
    cfg = RenderConfig(width=320, height=240, max_refract_depth=5,
                       max_reflect_depth=3)
    o, d = generate_rays(orbit_camera(1.2, cfg), 320, 240, cuda)
    n = o.shape[0]
    state, most = initial_state(o, d), 0
    for count in range(cfg.max_refract_depth + 1):
        primary = count == 0
        res = mega_round(scene, state,
                         (cfg.primary_tmin if primary else cfg.secondary_tmin,
                          cfg.primary_tmax if primary else cfg.secondary_tmax,
                          cfg.ior, cfg.fresnel_r0),
                         count < 3, count < 5)
        misses = (res.radiance != 0).any(dim=1).reshape(-1, n).sum(dim=0)
        most = max(most, int(misses.max()))
        state = res.children
    assert most >= 3
    ref, st_s = static_wavefront(scene, o, d, cfg, collect_stats=True)
    for _ in range(2):
        img, st = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
        assert torch.equal(img, ref)
        assert torch.equal(st["pixel_rays"], st_s["pixel_rays"])


@pytest.mark.parametrize("v", [8, 70, 512])
@pytest.mark.parametrize("cull", ["ones", "mix"])
def test_woop_tc_kernels_agree_with_plain(cuda, cull, v):
    """The tensor-core Woop kernel, one TF32 pass and 3xTF32, against its
    plain version by `tc_agreement` (t to TC_T_RTOL where the winner is the
    same, the winner the same on all but TC_MISMATCH_SHARE of the rays);
    each call is one launch of its own wrapper."""
    inp = make_inputs(0)
    c = (None if cull == "ones" else
         np.random.default_rng(7).choice(np.float32([-1.0, 1.0]), 1024))
    args = woop_args(inp, cuda, c)
    for fn, passes in ((woop_visits_tc, 1), (woop_visits_tc3, 3)):
        before = (woop_visits_tc.launches, woop_visits_tc3.launches)
        got = fn(*args, v)
        after = (woop_visits_tc.launches, woop_visits_tc3.launches)
        assert after == (before[0] + (passes == 1), before[1] + (passes == 3))
        ref = woop_visits_tc_plain(*args, v, passes)
        torch.cuda.synchronize()
        agree = tc_agreement(got, ref)
        assert agree["ok"], (passes, agree)
        assert bool((got[0] < 1e29).float().mean() > 0.9)
    # 3xTF32 against the exact Woop kernel: the same winner nearly always.
    exact = woop_visits(*args, v)
    assert float((fn(*args, v)[1] == exact[1]).float().mean()) >= 0.995


def test_woop_tc_kernel_on_a_ragged_ray_count(cuda):
    """R = 1,000 is not a multiple of a warp's 32 rays or a tile's 8: the
    rays past the end are fed as zeros and not written."""
    inp = make_inputs(0)
    w, rhs, cull = woop_args(inp, cuda)
    rhs, cull = rhs[:, :1000].contiguous(), cull[:1000].contiguous()
    for fn, passes in ((woop_visits_tc, 1), (woop_visits_tc3, 3)):
        agree = tc_agreement(fn(w, rhs, cull, 64),
                             woop_visits_tc_plain(w, rhs, cull, 64, passes))
        assert agree["ok"], (passes, agree)


def test_env_kernel_at_odd_counts_and_offsets(cuda):
    """Small and odd counts, mostly dead weights, NaN and negative
    weights (zero out), and inputs that start at any offset."""
    scene = scene_from_jax(
        build_scene(make_cube(2.0), make_gradient_envmap(512, 1024), 8)[0],
        cuda)
    g = torch.Generator().manual_seed(9)
    for n in (1, 3, 4, 5, 1023, 50002):
        _, d, _ = _rays(n, n, cuda)
        w = torch.rand(n, generator=g)
        w[torch.rand(n, generator=g) < 0.9] = 0.0
        w[::11] = -1.0
        w[5::13] = float("nan")
        w = w.to(cuda)
        got = env_contribution(scene, d, w)
        ref = env_contribution_plain(scene, d, w)
        assert float((got == ref).all(dim=1).double().mean()) >= AGREE
        assert bool((got[~(w > 0)] == 0).all())
    _, d, _ = _rays(9, 1, cuda)
    w = torch.ones(9, device=cuda)
    got = env_contribution(scene, d[1:], w[1:])  # views at odd offsets
    assert torch.equal(got, env_contribution_plain(scene, d[1:], w[1:]))


def test_env_variants_equal_the_env_kernel(cuda):
    """The three forms kept as an instrument (csrc/env_variants.cu; timed
    by env_times --variants) equal the env kernel bit for bit at counts
    around their tails, and the forms that move 16-byte words refuse a
    pointer off a 16-byte boundary."""
    from refraction_tpu_torch.env_times import VARIANTS, env_inputs, env_variant

    scene = scene_from_jax(
        build_scene(make_cube(2.0), make_gradient_envmap(512, 1024), 8)[0],
        cuda)
    env = scene.envmap
    env4 = torch.cat([env, torch.zeros_like(env[..., :1])], dim=2).contiguous()
    for n in (1, 3, 4, 255, 256, 257, 1023, 50002):
        d, w = env_inputs(n, 0.3, cuda, seed=n)
        want = env_contribution(scene, d, w)
        for name, v in VARIANTS.items():
            assert torch.equal(env_variant(v, scene, env4, d, w), want), (
                name, n)
    d, w = env_inputs(9, 1.0, cuda)
    with pytest.raises(RuntimeError, match="rt_env_variant"):
        env_variant(VARIANTS["rays4"], scene, env4, d[1:], w[1:])
    with pytest.raises(RuntimeError, match="rt_env_variant"):
        env_variant(7, scene, env4, d, w)


@pytest.mark.parametrize("carry", ["ones", "mixed"])
@pytest.mark.parametrize("n_iter", [64, 70])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_block_shapes_equal_plain(cuda, variant, n_iter, carry):
    """Both block shapes of rt_stall_form (1,024 x 1 and 256 x 4; the
    kernel is one, the other the form measured and not kept) equal the
    plain version bit for bit; an unknown shape is refused."""
    from refraction_tpu_torch.kernels.stallbench import FORMS, stall_form

    sm = torch.arange(1024, dtype=torch.float32, device=cuda)
    x = (torch.ones(8, 128, dtype=torch.float32, device=cuda)
         if carry == "ones" else torch.from_numpy(mixed_carry(0)).to(cuda))
    ref = stall_iters_plain(variant, n_iter, sm, x)
    for name, ept in FORMS.items():
        assert torch.equal(stall_form(ept, variant, n_iter, sm, x), ref), name
    with pytest.raises(RuntimeError, match="rt_stall_form"):
        stall_form(2, variant, n_iter, sm, x)


@pytest.mark.parametrize("spp", [1, 4])
@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_modular_path_matches_plain_and_fused(cuda, name, spp):
    """make_renderer(..., use_mega=False) on the card: one closest-hit and
    one env launch per bounce level and sample, the image against the
    eager brute force on the card (its plain version) and against the
    fused frame kernel."""
    from refraction_tpu_torch.render import make_renderer

    scene = scene_from_jax(_scenes()[name], cuda)
    cfg = RenderConfig(width=64, height=48, spp=spp)
    frame = orbit_camera(0.85, cfg)
    before = (closest_hit.launches, env_contribution.launches,
              fused_radiance.launches)
    img = make_renderer(cfg, "cuda", cuda, use_mega=False)(scene, frame)
    torch.cuda.synchronize()
    levels = (cfg.max_refract_depth + 1) * spp
    assert (closest_hit.launches - before[0], env_contribution.launches
            - before[1], fused_radiance.launches - before[2]) == (
                levels, levels, 0)
    for ref in (make_renderer(cfg, "torch", cuda)(scene, frame),
                make_renderer(cfg, "cuda", cuda)(scene, frame)):
        ok, why = _img_ok(img, ref)
        assert ok, why
    auto = make_renderer(cfg, "auto", cuda)(scene, frame)
    assert torch.equal(auto, make_renderer(cfg, "cuda", cuda)(scene, frame))


# ---- the frame kernel's pixel-DP entry and the sharded renderers ---------

def test_frame_tiles_kernel_matches_plain(cuda):
    """Shard 1 of 4 over the 6 tiles of 96x64 (padded to 8): global tiles
    1 and 5, and the gated pad tiles of shard 3 (tiles 3 and 7)."""
    from refraction_tpu_torch.kernels.framekernel import (
        frame_tiles, frame_tiles_plain)

    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=96, height=64, spp=2)
    scal = build_scalars(orbit_camera(0.4, cfg), cfg, sample_offsets(2), cuda)
    before = frame_tiles.launches
    got = frame_tiles(scene, scal, cfg, 4, 1, 2, 6)
    assert frame_tiles.launches == before + 1
    assert got.shape == (2, 32, 32, 3)
    ok, why = _img_ok(got, frame_tiles_plain(scene, scal, cfg, 4, 1, 2, 6))
    assert ok, why
    img = fused_radiance(scene, scal, cfg)
    assert torch.equal(got[0], img[:32, 32:64])
    assert torch.equal(got[1], img[32:64, 64:96])
    gated = frame_tiles(scene, scal, cfg, 4, 3, 2, 6)  # tiles 3 and 7
    assert torch.equal(gated[0], img[32:64, :32])
    assert not bool(gated[1].any())


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("name", ["cube", "sphere"])
def test_fused_pixel_dp_on_one_card_equals_the_frame_kernel(cuda, name, ndev):
    """The device list [cuda:0] * k: every shard's launch, gather and
    reassembly on the one card, the image the single launch's bit for
    bit; k frame_tiles launches and no fused_radiance launch."""
    from refraction_tpu_torch.kernels.framekernel import frame_tiles
    from refraction_tpu_torch.parallel.sharding import (
        make_fused_sharded_renderer)

    scene = scene_from_jax(_scenes()[name], cuda)
    cfg = RenderConfig(width=200, height=120)
    frame = orbit_camera(0.4, cfg)
    single = fused_radiance(scene, build_scalars(frame, cfg,
                                                 sample_offsets(1), cuda), cfg)
    render = make_fused_sharded_renderer(cfg, [cuda] * ndev)
    before = (frame_tiles.launches, fused_radiance.launches)
    img = render(scene, frame)
    torch.cuda.synchronize()
    assert (frame_tiles.launches - before[0],
            fused_radiance.launches - before[1]) == (ndev, 0)
    assert torch.equal(img, single)


def test_wavefront_and_tri_sharding_on_one_card(cuda):
    from refraction_tpu_torch.parallel.sharding import (
        make_sharded_renderer, make_trisharded_intersect)

    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=96, height=64)
    frame = orbit_camera(0.4, cfg)
    o, d = generate_rays(frame, 96, 64, cuda)
    one = render_pixels_mega(scene, o, d, cfg).reshape(64, 96, 3)
    two = make_sharded_renderer(cfg, [cuda] * 2, "cuda")(scene, frame)
    assert torch.equal(two, one)
    o, d, cull = _rays(4096, 8, cuda)
    wf, alive = cull > 0, cull != 0
    be = get_backend("torch")
    ref = be.intersect(scene, o, d, wf, alive, 1e-4, 100.0)
    got = make_trisharded_intersect([cuda] * 2)(scene, o, d, wf, alive,
                                                1e-4, 100.0)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[2][ref[0]], ref[2][ref[0]])
    assert torch.equal(got[1][ref[0]], ref[1][ref[0]])


def test_lbvh_on_the_card_matches_the_brute_force(cuda):
    from refraction_tpu_torch.bvh.lbvh import lbvh_from_scene, lbvh_intersect

    scene = scene_from_jax(_scenes()["sphere"], cuda)
    o, d, cull = _rays(8192, 9, cuda)
    wf = cull > 0
    ref = get_backend("torch").intersect(scene, o, d, wf, torch.ones_like(wf),
                                         1e-4, 100.0)
    hit, t, idx = lbvh_intersect(lbvh_from_scene(scene), o, d, wf, 1e-4,
                                 100.0)
    assert torch.equal(hit, ref[0]) and bool(hit.any())
    assert float((t - ref[1])[hit].abs().max()) <= 1e-5
    assert float((idx == ref[2])[hit].double().mean()) >= 0.999


@pytest.mark.two_cards
def test_two_card_pixel_dp_and_tri_tp_equal_one_card(two_cards):
    """cuda:0 and cuda:1: the fused and wavefront pixel-DP images and the
    triangle-sharded winners equal one card's bit for bit. The thread's
    current device stays cuda:0 throughout, so every launch on cuda:1
    must enter its tensors' device (kernels/_build.launch)."""
    from refraction_tpu_torch.kernels.framekernel import frame_tiles
    from refraction_tpu_torch.parallel.sharding import (
        make_fused_sharded_renderer, make_sharded_renderer,
        make_trisharded_intersect)

    dev0, dev1 = two_cards
    torch.cuda.set_device(dev0)
    scene = scene_from_jax(_scenes()["sphere"], dev0)
    cfg = RenderConfig(width=200, height=120)
    frame = orbit_camera(0.4, cfg)
    single = fused_radiance(scene, build_scalars(frame, cfg,
                                                 sample_offsets(1), dev0), cfg)
    before = frame_tiles.launches
    img = make_fused_sharded_renderer(cfg, [dev0, dev1])(scene, frame)
    torch.cuda.synchronize(dev1)
    assert frame_tiles.launches == before + 2
    assert img.device == dev0 and torch.equal(img, single)
    o, d = generate_rays(frame, 200, 120, dev0)
    one = render_pixels_mega(scene, o, d, cfg).reshape(120, 200, 3)
    two = make_sharded_renderer(cfg, [dev0, dev1], "cuda")(scene, frame)
    assert torch.equal(two, one)
    o, d, cull = _rays(4096, 8, dev0)
    wf, alive = cull > 0, cull != 0
    ref = make_trisharded_intersect([dev0])(scene, o, d, wf, alive, 1e-4,
                                            100.0)
    got = make_trisharded_intersect([dev0, dev1])(scene, o, d, wf, alive,
                                                  1e-4, 100.0)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)


def _two_rank_fused_dp(width, height):
    """Two ranks of ``python -m refraction_tpu_torch.parallel.distributed
    --fused-dp --device cuda`` on the CLI's default scene, joined over
    gloo through a free localhost port; their JSON lines in rank order.
    Both are killed if either outlives the timeout."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "refraction_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(rank), "--device", "cuda", "--fused-dp",
         "--width", str(width), "--height", str(height)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _rt_frame_sha(width, height, dev):
    """sha256 of the frame kernel's single-launch image of the CLI's
    default scene and --fused-dp angle (0.35), on ``dev``."""
    scene = scene_from_jax(build_scene(make_icosphere(2, 1.2),
                                       make_gradient_envmap(64, 128), 32)[0],
                           dev)
    cfg = RenderConfig(width=width, height=height, cluster_size=32)
    img = fused_radiance(scene, build_scalars(orbit_camera(0.35, cfg), cfg,
                                              sample_offsets(1), dev), cfg)
    return hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()


def test_two_process_fused_dp_equals_rt_frame(cuda):
    """Two ranks on cuda:0 (rank r takes cuda:(r % cards)): 48 tiles, 24
    a rank; both images are rt_frame's bit for bit."""
    s0, s1 = _two_rank_fused_dp(256, 192)
    count = torch.cuda.device_count()
    assert [s0["device"], s1["device"]] == [f"cuda:{r % count}"
                                            for r in range(2)]
    assert s0["devices_global"] == s1["devices_global"] == 2
    assert s0["sha256"] == s1["sha256"] == _rt_frame_sha(256, 192, cuda)
    assert s0["matches_single_device"] and s1["matches_single_device"]
    for s in (s0, s1):
        assert s["launches"] == {"fused_radiance": 1, "frame_tiles": 1}


@pytest.mark.two_cards
def test_two_process_fused_dp_on_two_cards(two_cards):
    """Rank 0 on cuda:0, rank 1 on cuda:1: the gathered image is rt_frame's
    on cuda:0, bit for bit."""
    s0, s1 = _two_rank_fused_dp(256, 192)
    assert [s0["device"], s1["device"]] == ["cuda:0", "cuda:1"]
    assert s0["sha256"] == s1["sha256"] == _rt_frame_sha(256, 192,
                                                         two_cards[0])
    assert s0["matches_single_device"] and s1["matches_single_device"]


def test_frame_kernel_launches_record_one_launch_span_each(cuda):
    """Under torch.profiler each launch of rt_frame and rt_frame_tiles sits
    in one host span ``rt.launch`` (`tracing`), and no ``rt.*`` span has a
    copy on the device's timeline."""
    from refraction_tpu_torch.kernels.framekernel import frame_tiles

    scene = scene_from_jax(_scenes()["sphere"], cuda)
    cfg = RenderConfig(width=96, height=70)
    scal = build_scalars(orbit_camera(0.4, cfg), cfg, sample_offsets(1), cuda)
    fused_radiance(scene, scal, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fused_radiance(scene, scal, cfg)
        frame_tiles(scene, scal, cfg, 2, 1, 4, 9)
        torch.cuda.synchronize()
    spans = [e for e in prof.events() if e.name.startswith("rt.")]
    assert [e.name for e in spans] == ["rt.launch", "rt.launch"]
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in spans)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "rt_frame" in e.name]
    assert len(kernels) == 2, kernels
