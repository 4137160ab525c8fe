"""The compacted wavefront of refraction_tpu_torch (kernels/megakernel.py
``mega_round_queue`` and integrator.render_pixels_mega) vs the static-layout
round and wavefront, the NumPy oracle and the JAX wavefront's stats.

On CPU tensors ``mega_round_queue`` takes its plain version, which runs
the queued lanes through ``mega_round_plain`` in slot order, so every
queued lane's results equal the static round's at its slot bit for bit.
Both layouts sum a round's misses per pixel in slot order
(``slot_order_sum``; the CUDA kernels through a slab and a fold kernel,
kernels/megakernel.py ``fold_round_sums``), whatever the queue order and
however many of a pixel's lanes miss, so the wavefront images are equal
bit for bit; the image tolerance below (RMSE 1e-7, max abs 1e-6) stays
beside the bit-equal share that the wavefront test checks and prints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction_tpu.camera import generate_rays as np_generate_rays
from refraction_tpu.camera import orbit_camera
from refraction_tpu.config import RenderConfig
from refraction_tpu.integrator import render_pixels as jax_render_pixels
from refraction_tpu.ops.backends import xla_env_contribution, xla_intersect
from refraction_tpu_torch.fixtures import (
    multi_miss_lanes,
    paired_miss_lanes,
    two_balls,
)
from refraction_tpu_torch.integrator import (
    initial_state,
    render_pixels_mega,
    round_params,
    static_wavefront,
    static_widths,
    wavefront_rounds,
)
from refraction_tpu_torch.kernels.megakernel import (
    LaneQueue,
    empty_queue,
    fold_round_sums,
    mega_round,
    mega_round_plain,
    mega_round_queue,
    slot_order_sum,
)
from refraction_tpu_torch.io.primitives import make_gradient_envmap
from refraction_tpu_torch.scene import build_scene, scene_from_jax

torch.set_num_threads(1)

IMG_RMSE, IMG_MAX = 1e-7, 1e-6     # compacted vs static wavefront
RMSE_BAR, MAX_BAR = 1e-4, 1e-3     # tests/test_golden.py
BIT_EQUAL_SHARE = 1.0              # pixels bit-equal to the static image
LIMITS = (1e-3, 1000.0, 1.3, 0.00826446)
VARIANTS = {"full": (True, True), "norefl": (False, True),
            "missonly": (False, False)}


def _lanes(n, seed):
    """(8, n) static lane state around the r=1.2 icosphere: outside lanes
    aimed at it from a shell, inside lanes from within it, dead lanes, and
    every 5th weight the least subnormal (its w * R underflows to 0)."""
    rng = np.random.default_rng(seed)
    cull = rng.choice(np.float32([1.0, -1.0, 0.0]), n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = u * rng.uniform(2.5, 4.0, (n, 1))
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    inside = cull < 0
    o[inside] = rng.uniform(-0.6, 0.6, (int(inside.sum()), 3))
    d[inside] = rng.normal(size=(int(inside.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wgt = rng.uniform(0.0, 1.0, n)
    wgt[::5] = 1.4e-45
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, d.T, cull[None], wgt[None]]), np.float32))


def _queue_of(state, seed, cap=None):
    """The live lanes of a static state as a queue in shuffled order."""
    w = state.shape[1]
    live = torch.nonzero(state[6] != 0).squeeze(1)
    live = live[torch.from_numpy(
        np.random.default_rng(seed).permutation(live.numel()))]
    st, slot = empty_queue(cap or w, "cpu")
    st[:, :live.numel()] = state[:, live]
    slot[:live.numel()] = live.to(torch.int32)
    count = torch.tensor([live.numel()], dtype=torch.int32)
    return LaneQueue(st, slot, count, w)


def _next_queue(queue, want_reflect, cap=None):
    width = queue.width * (2 if want_reflect else 1)
    return LaneQueue(*empty_queue(cap or width, "cpu"),
                     torch.zeros(1, dtype=torch.int32), width)


def _rays(cfg, angle):
    o, d = np_generate_rays(orbit_camera(angle, cfg), cfg.width, cfg.height,
                            xp=np)
    return (torch.from_numpy(np.array(o, np.float32)),
            torch.from_numpy(np.array(d, np.float32)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_queue_round_equals_static_round_at_each_slot(sphere_scene,
                                                            variant):
    """Every queued lane's radiance and live children equal the static
    round's at its slot, bit for bit; no live static child is missing and
    the children come out in slot order."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    want_reflect, want_children = VARIANTS[variant]
    w = 4000
    state = _lanes(w, seed=11)
    ref = mega_round_plain(ts, state, LIMITS, want_reflect, want_children)
    queue = _queue_of(state, seed=12)
    out = _next_queue(queue, want_reflect) if want_children else None
    radiance = torch.zeros(w, 3)  # N = W: one lane per pixel
    pixel_rays = torch.zeros(w, dtype=torch.int32)
    before = mega_round_queue.launches
    mega_round_queue(ts, queue, LIMITS, want_reflect, want_children,
                     radiance, pixel_rays, out)
    assert mega_round_queue.launches == before  # CPU: the plain version
    live = state[6] != 0
    assert torch.equal(radiance, ref.radiance)
    assert torch.equal(pixel_rays, live.to(torch.int32))
    if not want_children:
        return
    alive = ref.children[6] != 0
    c = int(out.count)
    assert c == int(alive.sum()) > 0
    slots = out.slot[:c].long()
    assert bool((slots[1:] > slots[:-1]).all())
    assert torch.equal(slots, torch.nonzero(alive).squeeze(1))
    assert torch.equal(out.state[:, :c], ref.children[:, slots])
    if want_reflect:  # a weight-0 reflection child is still queued
        under = (state[7] < 1e-40) & alive[w:]
        assert int(under.sum()) > 0
        assert bool((out.state[7, :c][slots >= w] == 0).any())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_queue_round_sums_pixels_as_the_static_layout(sphere_scene,
                                                            variant):
    """N = W / 4: four slots per pixel. The per-pixel sums of a round
    equal the static layout's sum over the pixel's lanes (bit for bit)
    and its live-lane counts."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    want_reflect, want_children = VARIANTS[variant]
    w, n = 4000, 1000
    state = _lanes(w, seed=13)
    ref = mega_round_plain(ts, state, LIMITS, want_reflect, want_children)
    queue = _queue_of(state, seed=14, cap=w + 37)  # row length != width
    out = (_next_queue(queue, want_reflect, cap=2 * w + 5)
           if want_children else None)
    radiance = torch.zeros(n, 3)
    pixel_rays = torch.zeros(n, dtype=torch.int32)
    mega_round_queue(ts, queue, LIMITS, want_reflect, want_children,
                     radiance, pixel_rays, out)
    assert torch.equal(radiance, ref.radiance.reshape(-1, n, 3).sum(dim=0))
    assert torch.equal(pixel_rays, (state[6] != 0).reshape(-1, n).sum(
        dim=0, dtype=torch.int32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_empty_queue_round(sphere_scene, variant):
    """A round with no live lane (count 0) adds nothing and emits an empty
    queue."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    want_reflect, want_children = VARIANTS[variant]
    queue = LaneQueue(*empty_queue(300, "cpu"),
                      torch.zeros(1, dtype=torch.int32), 300)
    out = _next_queue(queue, want_reflect) if want_children else None
    radiance = torch.full((100, 3), 0.5)
    pixel_rays = torch.ones(100, dtype=torch.int32)
    mega_round_queue(ts, queue, LIMITS, want_reflect, want_children,
                     radiance, pixel_rays, out)
    assert bool((radiance == 0.5).all()) and bool((pixel_rays == 1).all())
    if out is not None:
        assert int(out.count) == 0


@pytest.mark.parametrize("scene_name,angle,caps,shape", [
    ("sphere_scene", 0.85, (5, 2), (48, 36)),
    ("sphere_scene", 0.85, (2, 1), (48, 36)),
    ("sphere_scene", 0.4, (3, 3), (40, 25)),   # N = 1000, not a multiple of 128
    ("cube_scene", 0.3, (5, 2), (48, 36)),
    ("cube_scene", 0.3, (1, 0), (48, 36)),
    ("sphere_scene", 0.85, (5, 2), (1, 1)),    # N = 1
], ids=["sphere-5-2", "sphere-2-1", "sphere-3-3-n1000", "cube-5-2",
        "cube-1-0", "sphere-n1"])
def test_wavefront_equals_static_wavefront(scene_name, angle, caps, shape,
                                           request, capsys):
    ts = scene_from_jax(request.getfixturevalue(scene_name)[0], "cpu")
    cfg = RenderConfig(width=shape[0], height=shape[1],
                       max_refract_depth=caps[0], max_reflect_depth=caps[1])
    o, d = _rays(cfg, angle)
    if shape == (1, 1):  # the one ray aimed at the sphere's centre
        d = -o / torch.linalg.norm(o, dim=1, keepdim=True)
    img, st = render_pixels_mega(ts, o, d, cfg, collect_stats=True)
    ref, st_s = static_wavefront(ts, o, d, cfg, collect_stats=True)
    assert int(st["rays_traced"]) == int(st_s["rays_traced"])
    assert st["rays_traced"].dtype == torch.int64
    assert torch.equal(st["pixel_rays"], st_s["pixel_rays"])
    assert st["slot_rounds"] == st_s["slot_rounds"] == sum(
        static_widths(cfg, o.shape[0]))
    assert int(st_s["rays_traced"]) > o.shape[0]  # some rays bounced
    a, b = img.numpy(), ref.numpy()
    assert rmse(a, b) < IMG_RMSE
    assert np.abs(a - b).max() < IMG_MAX
    same = float((a == b).all(axis=1).mean())
    with capsys.disabled():
        print(f"\n  {request.node.callspec.id}: bit-equal pixels {same:.6f}")
    assert same >= BIT_EQUAL_SHARE and torch.equal(img, ref)
    # The image without stats is the same image.
    assert torch.equal(render_pixels_mega(ts, o, d, cfg), img)


@pytest.mark.parametrize("caps", [(5, 2), (2, 1), (3, 0)],
                         ids=["caps5-2", "caps2-1", "caps3-0"])
@pytest.mark.parametrize("name,angle", [("cube_scene", 0.3),
                                        ("sphere_scene", 0.85)])
def test_wavefront_meets_golden_bar_and_jax_stats(name, angle, caps, request):
    """Against the oracle at tests/test_golden.py's bar, and the JAX
    wavefront's rays_traced, slot_rounds and per-pixel counts exactly."""
    scene = request.getfixturevalue(name)[0]
    cfg = RenderConfig(width=40, height=24, max_refract_depth=caps[0],
                       max_reflect_depth=caps[1], backend="xla")
    o, d = _rays(cfg, angle)
    img, st = render_pixels_mega(scene_from_jax(scene, "cpu"), o, d, cfg,
                                 collect_stats=True)
    ref = render_oracle(scene, cfg, frame=orbit_camera(angle, cfg))
    img = img.numpy().reshape(24, 40, 3)
    assert rmse(img, ref) < RMSE_BAR
    assert np.abs(img - ref).max() < MAX_BAR
    fn = jax.jit(lambda sc, o_, d_: jax_render_pixels(
        sc, o_, d_, cfg, xla_intersect, xla_env_contribution,
        collect_stats=True))
    _, st_j = fn(jax.tree.map(jnp.asarray, scene), jnp.asarray(o.numpy()),
                 jnp.asarray(d.numpy()))
    assert int(st["rays_traced"]) == int(st_j["rays_traced"])
    assert st["slot_rounds"] == st_j["slot_rounds"]
    np.testing.assert_array_equal(st["pixel_rays"].numpy(),
                                  np.asarray(st_j["pixel_rays"]))


def test_queue_counts_are_the_static_live_lanes_per_round(sphere_scene):
    """Each round's queue holds exactly the static layout's live lanes,
    slot for slot; a call appends to an empty next queue, and a repeated
    call after the next count is zeroed gives the same next queue
    (profile_rounds times each round that way)."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    cfg = RenderConfig(width=32, height=20)
    o, d = _rays(cfg, 0.85)
    n = o.shape[0]
    state = initial_state(o, d)
    radiance = torch.zeros(n, 3)
    widths = []
    for count, (queue, out, run) in enumerate(wavefront_rounds(ts, o, d,
                                                               cfg)):
        widths.append(queue.width)
        assert queue.width == state.shape[1]
        c = int(queue.count)
        live = torch.nonzero(state[6] != 0).squeeze(1)
        order = torch.argsort(queue.slot[:c].long())
        assert torch.equal(queue.slot[:c].long()[order], live)
        assert torch.equal(queue.state[:, :c][:, order], state[:, live])
        limits, want_reflect, want_children = round_params(cfg, count)
        assert (out is None) == (not want_children)
        if out is not None:
            assert int(out.count) == 0
        run(radiance)
        if out is not None:
            first = int(out.count)
            out.count.zero_()
        run(radiance)
        if want_children:
            assert int(out.count) == first
            state = mega_round(ts, state, limits, want_reflect,
                               want_children).children
    assert widths == static_widths(cfg, n) == [n, 2 * n, 4 * n, 4 * n, 4 * n,
                                               4 * n]


def test_mega_round_queue_checks_its_inputs(cube_scene):
    ts = scene_from_jax(cube_scene[0], "cpu")
    q = LaneQueue(*empty_queue(8, "cpu"), torch.zeros(1, dtype=torch.int32), 8)
    rad = torch.zeros(8, 3)
    out = _next_queue(q, True)
    mega_round_queue(ts, q, LIMITS, True, True, rad, None, out)  # accepted
    with pytest.raises(ValueError, match="out.width"):
        mega_round_queue(ts, q, LIMITS, False, True, rad, None, out)
    with pytest.raises(ValueError, match="needs the next queue"):
        mega_round_queue(ts, q, LIMITS, True, True, rad)
    with pytest.raises(ValueError, match="no children"):
        mega_round_queue(ts, q, LIMITS, False, False, rad, None, out)
    with pytest.raises(ValueError, match="queue"):
        mega_round_queue(ts, q._replace(width=9), LIMITS, False, False, rad)
    with pytest.raises(ValueError, match="queue"):
        mega_round_queue(ts, q._replace(slot=q.slot.long()), LIMITS, False,
                         False, rad)
    with pytest.raises(ValueError, match="radiance"):
        mega_round_queue(ts, q, LIMITS, False, False, torch.zeros(0, 3))
    with pytest.raises(ValueError, match="pixel_rays"):
        mega_round_queue(ts, q, LIMITS, False, False, rad,
                         torch.zeros(7, dtype=torch.int32))
    meta = LaneQueue(*(x.to("meta") for x in q[:3]), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        mega_round_queue(ts, meta, LIMITS, False, False, rad.to("meta"))


def test_round_bound_counts_the_live_ray_tree(sphere_scene):
    """bounds.round_bound counts each level's live lanes (state and slot
    in, radiance out), the next level's lanes as the children written, the
    tables per round, and per round a 32 B sector of the map for each miss
    (at most the map); the static layout's bytes, kept beside it, count
    every lane of the static widths."""
    from refraction_tpu_torch import bounds
    from refraction_tpu_torch.render import frame_traversal_work

    ts = scene_from_jax(sphere_scene[0], "cpu")
    cfg = RenderConfig(width=24, height=16)
    levels = frame_traversal_work(ts, cfg, orbit_camera(0.85, cfg), "cpu")
    rays = [lv["rays"] for lv in levels]
    misses = [lv["misses"] for lv in levels]
    assert len(rays) == cfg.max_refract_depth + 1 and rays[1] > 0
    assert 0 < misses[0] < rays[0] and misses[-1] <= rays[-1]
    # Here every level's misses need fewer bytes than the whole map.
    assert 32 * max(misses) < bounds.env_bytes(ts)
    per_round = [bounds.table_bytes(ts) + 32 * m for m in misses]
    want = sum(r * (36 + 12) + nxt * 36 + t
               for r, nxt, t in zip(rays, rays[1:] + [0], per_round))
    b = bounds.round_bound(ts, cfg, levels)
    assert b["bytes"] == want
    assert b["ops"] == bounds.traversal_ops(
        {k: sum(lv[k] for lv in levels) for k in levels[0]})
    widths = static_widths(cfg, cfg.width * cfg.height)
    outs = widths[1:] + [0]
    assert b["static_bytes"] == sum(w * (32 + 12) + o * 32 + t
                                    for w, o, t in zip(widths, outs,
                                                       per_round))
    assert b["static_bytes"] > b["bytes"]
    assert b["static_bound_ms"] >= b["bound_ms"]
    # A round of more misses than the map has sectors reads the map once.
    big = bounds.env_bytes(ts) // 32 + 1
    assert bounds.round_map_bytes(ts, big) == bounds.env_bytes(ts)
    assert bounds.round_map_bytes(ts, 0) == 0


@pytest.mark.parametrize("first", ["subnormal", "normal"])
def test_queue_round_keeps_a_subnormal_miss_beside_a_normal_one(sphere_scene,
                                                                first):
    """Two misses per pixel, a subnormal and a small normal radiance, in
    either queue order: each pixel's sum equals the static layout's sum
    over its two lanes bit for bit, the subnormal included."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    p = 500
    state = torch.from_numpy(paired_miss_lanes(p, seed=3))
    static = mega_round_plain(ts, state, LIMITS, False, False).radiance
    want = static.reshape(2, p, 3).sum(dim=0)
    assert bool((static[:p] != 0).any())
    assert bool((static[:p].abs() < torch.finfo(torch.float32).tiny).all())
    assert bool((want != static[p:]).any())  # the subnormals count
    order = torch.arange(2 * p)
    if first == "normal":
        order = order.roll(p)
    queue = LaneQueue(state[:, order].contiguous(), order.to(torch.int32),
                      torch.tensor([2 * p], dtype=torch.int32), 2 * p)
    radiance = torch.zeros(p, 3)
    mega_round_queue(ts, queue, LIMITS, False, False, radiance)
    assert torch.equal(radiance, want)


def test_device_ms_runs_setup_outside_the_timed_call():
    from refraction_tpu_torch.timing import device_ms

    calls = []
    ms = device_ms(lambda: calls.append("fn"), torch.device("cpu"),
                   lambda: calls.append("setup"))
    assert calls == ["setup", "fn"] and ms >= 0.0


QUEUE_ORDERS = ("slot", "reversed", "rolled", "shuffled")


def _queue_order(name, m, seed=0):
    order = torch.arange(m)
    if name == "reversed":
        return order.flip(0)
    if name == "rolled":
        return order.roll(m // 3)
    if name == "shuffled":
        return torch.from_numpy(np.random.default_rng(seed).permutation(m))
    return order


@pytest.mark.parametrize("order", QUEUE_ORDERS)
@pytest.mark.parametrize("k", [3, 4])
def test_queue_round_sums_three_and_four_misses_in_slot_order(sphere_scene,
                                                              k, order):
    """Three and four misses of each pixel in one round, subnormal, small
    and ordinary radiance mixed so that the float32 sum depends on the
    order at over a tenth of the pixels: in every queue order the round's per-pixel sum
    equals the static layout's, bit for bit, on top of a radiance already
    there."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    p = 400
    state = torch.from_numpy(multi_miss_lanes(p, k, seed=21))
    static = mega_round_plain(ts, state, LIMITS, False, False).radiance
    want = slot_order_sum(static, p)
    lanes = static.reshape(k, p, 3)
    assert torch.equal(want, lanes.sum(dim=0))  # torch's order on the CPU
    backwards = slot_order_sum(lanes.flip(0).reshape(-1, 3), p)
    assert float((backwards != want).any(dim=1).float().mean()) > 0.1
    tiny = torch.finfo(torch.float32).tiny
    assert bool(((static != 0) & (static.abs() < tiny)).any())
    idx = _queue_order(order, k * p, seed=22)
    queue = LaneQueue(state[:, idx].contiguous(), idx.to(torch.int32),
                      torch.tensor([k * p], dtype=torch.int32), k * p)
    before = torch.from_numpy(
        np.random.default_rng(23).uniform(0, 1, (p, 3)).astype(np.float32))
    radiance = before.clone()
    mega_round_queue(ts, queue, LIMITS, False, False, radiance)
    assert torch.equal(radiance, before + want)


@pytest.mark.parametrize("j", [1, 2, 4, 8])
def test_slot_order_sum_and_fold_round_sums(j):
    """`slot_order_sum` adds a pixel's lanes in ascending slot from +0.0;
    `fold_round_sums` adds
    only the slab rows the mask names, never reads the others (NaN
    there), adds onto the radiance and clears the mask; a pixel with no
    bit keeps its radiance, and a sum of -0.0 rows is +0.0 as the static
    layout's."""
    n = 257
    rng = np.random.default_rng(j)
    lanes = torch.from_numpy(
        (rng.uniform(0.5, 1.0, (j * n, 3))
         * 10.0 ** rng.integers(-8, 1, (j * n, 1))).astype(np.float32))
    want = slot_order_sum(lanes, n)
    acc = torch.zeros(n, 3)
    for q in range(j):
        acc = acc + lanes[q * n:(q + 1) * n]
    assert torch.equal(want, acc)
    if j <= 4:  # torch's own order on the CPU up to four rows, not at eight
        assert torch.equal(want, lanes.reshape(j, n, 3).sum(dim=0))
    bits = torch.from_numpy(rng.integers(0, 2, (j, n)).astype(np.int32))
    bits[:, 0] = 0  # a pixel with no miss
    bits[:, 1] = 0  # pixel 1: slot 0 only, a -0.0 row
    bits[0, 1] = 1
    mask = (bits << torch.arange(j, dtype=torch.int32)[:, None]).sum(
        dim=0, dtype=torch.int32)
    named = bits.bool().reshape(-1, 1)
    slab = torch.where(named, lanes, torch.full_like(lanes, float("nan")))
    slab[1] = -0.0
    before = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    before[1] = 0.0
    radiance = before.clone()
    launches = fold_round_sums.launches
    fold_round_sums(slab, mask, radiance)
    assert fold_round_sums.launches == launches  # CPU: the plain version
    zeroed = torch.where(named, lanes, torch.zeros_like(lanes))
    zeroed[1] = -0.0
    assert torch.equal(radiance, before + slot_order_sum(zeroed, n))
    assert torch.equal(radiance[0], before[0])
    assert not bool(torch.signbit(radiance[1]).any())
    assert not bool(mask.any())
    with pytest.raises(ValueError, match="fold_round_sums"):
        fold_round_sums(slab[:-1], mask, radiance)
    with pytest.raises(ValueError, match="fold_round_sums"):
        fold_round_sums(slab, mask.long(), radiance)


def test_wavefront_with_three_misses_of_a_pixel_in_a_round():
    """Two balls seen from the side, three reflections: some pixels have
    three lanes that miss in one round. The compacted wavefront's image
    equals the static layout's bit for bit, twice over, and the stats are
    equal."""
    ts = scene_from_jax(build_scene(two_balls(2), make_gradient_envmap(32, 64),
                                    32)[0], "cpu")
    cfg = RenderConfig(width=48, height=36, max_refract_depth=5,
                       max_reflect_depth=3)
    o, d = _rays(cfg, 1.2)
    n = o.shape[0]
    state, most = initial_state(o, d), 0
    for count in range(cfg.max_refract_depth + 1):
        res = mega_round(ts, state, *round_params(cfg, count))
        misses = (res.radiance != 0).any(dim=1).reshape(-1, n).sum(dim=0)
        most = max(most, int(misses.max()))
        state = res.children
    assert most >= 3
    ref, st_s = static_wavefront(ts, o, d, cfg, collect_stats=True)
    for _ in range(2):
        img, st = render_pixels_mega(ts, o, d, cfg, collect_stats=True)
        assert torch.equal(img, ref)
        assert torch.equal(st["pixel_rays"], st_s["pixel_rays"])
        assert int(st["rays_traced"]) == int(st_s["rays_traced"])
