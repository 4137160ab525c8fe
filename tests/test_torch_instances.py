"""Two-level scenes (``--instances``, rtbench's ``scene`` configurations):
`scene.build_instanced_scene` keeps one BLAS a distinct mesh under a
table of instances, and the frame kernel walks instance boxes over them
(csrc/traverse_f2b.cuh RT_WALK_INSTANCES). On the CPU:

- the walk's eager twin (`kernels.intersect.instance_hit_plain`, the
  kernel's per-ray arithmetic) against a brute force over a float64 bake
  of the same instances: rotations, a scale of three values, a mirror, an
  explicit 3x4, a masked instance, touching and overlapping boxes, rays
  that leave one instance and hit another, instances that tie on every
  hit (the lowest instance wins), and a BLAS of more than 1,024 clusters;
- the bake, which every path that walks one mesh renders, bit for bit the
  single-mesh scene that the JAX package's `build_instanced_scene` builds;
- `walk_of` / `walk_levels` and the fused path's launch on (fake) CUDA
  tensors: the instance tables, ``walks["instances"]``, no bake;
- each other path (the CPU frame, the modular path, the wavefront,
  pixel-DP, multi-process, the LBVH oracle, ``run.main``) renders the bake;
- the port's count of the walk (`ops.intersect.traversal_work`).
"""

import contextlib
import logging

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from refraction_tpu.io import primitives as jax_prim
from refraction_tpu.scene import Instance as JaxInstance
from refraction_tpu.scene import build_instanced_scene as jax_build_instanced
from refraction_tpu_torch import run
from refraction_tpu_torch.bvh.lbvh import make_lbvh_backend
from refraction_tpu_torch.camera import generate_rays, orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.fixtures import write_obj
from refraction_tpu_torch.integrator import (
    render_pixels,
    render_pixels_mega,
)
from refraction_tpu_torch.io import primitives as prim
from refraction_tpu_torch.io.hdr import write_hdr
from refraction_tpu_torch.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels import _build, framekernel
from refraction_tpu_torch.kernels.envmap import env_contribution_plain
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    fused_radiance,
    fused_radiance_plain,
    walk_levels,
    walk_of,
)
from refraction_tpu_torch.kernels.intersect import (
    instance_hit,
    instance_hit_plain,
)
from refraction_tpu_torch.ops.backends import instance_intersect
from refraction_tpu_torch.ops.intersect import traversal_work
from refraction_tpu_torch.parallel import distributed
from refraction_tpu_torch.parallel.sharding import (
    make_fused_sharded_renderer,
    make_mesh,
    make_sharded_renderer,
)
from refraction_tpu_torch.render import (
    frame_traversal_work,
    make_renderer,
    sample_offsets,
)
from refraction_tpu_torch.scene import (
    UPLOADED,
    Instance,
    InstancedTorchScene,
    build_instanced_scene,
    instance_transform,
    scene_from_jax,
)

torch.set_num_threads(1)

ENV = make_gradient_envmap(16, 32)
BALL = make_icosphere(2, 0.8)
CUBE = make_cube(1.0)
MIRROR = np.array([[-0.9, 0.0, 0.0, 0.2], [0.0, 1.0, 0.0, 1.4],
                   [0.0, 0.0, 0.7, -0.3]], np.float32)
SHEAR = np.array([[0.5, 0.1, 0.0, 0.0], [0.0, 0.433, -0.25, -1.3],
                  [0.05, 0.25, 0.433, 0.4]], np.float32)


def _placed(kind):
    """(instances, expected facts) of each case."""
    if kind == "rotation_scale_mirror_explicit":
        return [Instance(BALL, instance_transform((-1.0, 0.0, 0.0), 1.0,
                                                  30.0)),
                Instance(CUBE, instance_transform((1.1, 0.0, 0.0),
                                                  [1.0, 0.5, 2.0], 20.0)),
                Instance(BALL, MIRROR),
                Instance(CUBE, SHEAR, mask=3)]
    if kind == "masked":
        return [Instance(BALL, instance_transform((-0.9, 0.0, 0.0))),
                Instance(CUBE, instance_transform((0.0, 0.0, 0.0), 3.0),
                         mask=0),
                Instance(BALL, instance_transform((0.9, 0.0, 0.0)))]
    if kind == "touching":
        return [Instance(BALL, instance_transform((-0.8, 0.0, 0.0))),
                Instance(BALL, instance_transform((0.8, 0.0, 0.0))),
                Instance(CUBE, instance_transform((1.5, 0.7, 0.3), 0.5,
                                                  17.0))]
    if kind == "ties":
        twin = instance_transform((0.3, -0.2, 0.1), 0.9, 12.0)
        return [Instance(BALL, twin), Instance(BALL, twin.copy()),
                Instance(CUBE, instance_transform((-1.6, 0.0, 0.0), 0.5))]
    raise KeyError(kind)


CASES = ["rotation_scale_mirror_explicit", "masked", "touching", "ties"]


def _world64(host):
    """The float64 bake: each visible instance's BLAS table (in table
    order) through its object-to-world 3x4, instance after instance in
    spec order, so that a triangle's index here is its key."""
    a, e1, e2, n = [], [], [], []
    for b, m in zip(host.inst_blas, host.object_to_world):
        blas = host.blas[b]
        lin, t = m[:, :3].astype(np.float64), m[:, 3].astype(np.float64)
        pa = blas.tri_a.astype(np.float64)
        pb, pc = pa + blas.tri_e1, pa + blas.tri_e2
        wa, wb, wc = (p @ lin.T + t for p in (pa, pb, pc))
        a.append(wa)
        e1.append(wb - wa)
        e2.append(wc - wa)
        n.append(np.linalg.inv(lin).T)
    return (torch.tensor(np.concatenate(a)), torch.tensor(np.concatenate(e1)),
            torch.tensor(np.concatenate(e2)))


def _brute64(world, o, d, cull, tmin, tmax):
    """Closest hit in float64 over every world triangle: (t, key), ties to
    the lowest key; faces accepted by the world determinant's sign."""
    a, e1, e2 = world
    o, d = o.double()[:, None], d.double()[:, None]
    p = torch.cross(d.expand(-1, a.shape[0], -1), e2[None].expand(
        o.shape[0], -1, -1), dim=2)
    det = (e1[None] * p).sum(-1)
    tv = o - a[None]
    q = torch.cross(tv, e1[None].expand_as(tv), dim=2)
    u = (tv * p).sum(-1) / det
    v = (d * q).sum(-1) / det
    t = (e2[None] * q).sum(-1) / det
    face = torch.where(cull[:, None] > 0, det > 0, det < 0)
    ok = (face & (cull[:, None] != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t >= tmin) & (t <= tmax))
    t = torch.where(ok, t, torch.full_like(t, np.inf))
    best, key = torch.min(t, dim=1)
    return best, torch.where(torch.isfinite(best), key, -1)


def _rays(host, n=1500, seed=3):
    """Random rays through the scene and rays leaving each instance's box
    from inside it."""
    g = np.random.default_rng(seed)
    lo, hi = host.inst_bounds[:, :3], host.inst_bounds[:, 3:]
    span_lo, span_hi = lo.min(axis=0) - 1.0, hi.max(axis=0) + 1.0
    o = [g.uniform(span_lo, span_hi, (n, 3))]
    for k in range(len(lo)):
        o.append(g.uniform(lo[k], hi[k], (n // 4, 3)))
    o = np.concatenate(o)
    d = g.normal(size=o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("kind", CASES)
def test_instance_walk_twin_matches_a_float64_bake(kind):
    """The twin's (hit, instance, triangle) against the float64 brute
    force, on rays through the scene and rays from inside each box, both
    culls, two intervals: hit and winner alike on all but rays that graze
    an edge within float32 rounding, t to 1e-5 of the distance; every tie
    of coincident instances goes to the lower one; some rays leave one
    instance and hit another."""
    insts = _placed(kind)
    host, meta = build_instanced_scene(insts, ENV, cluster_size=32)
    ts = scene_from_jax(host, "cpu")
    world = _world64(host)
    o, d = _rays(host)
    inside = _owner_box(o, host)
    crossed = 0
    for c in (1.0, -1.0):
        cull = torch.full((o.shape[0],), c)
        for tmin, tmax in ((1e-4, 100.0), (1e-3, 1000.0)):
            t, key, normal = instance_hit_plain(ts, o, d, cull, tmin, tmax)
            t64, key64 = _brute64(world, o, d, cull, tmin, tmax)
            hit, hit64 = key >= 0, key64 >= 0
            assert int(hit.sum()) > 50
            assert int((hit != hit64).sum()) <= 2
            both = hit & hit64
            assert int((key[both] != key64[both]).sum()) <= 2
            same = both & (key.long() == key64)
            rel = (t[same].double() - t64[same]).abs() / t64[same].clamp_min(1)
            assert float(rel.max()) < 1e-5
            inst, tri = ts.owners(key)
            assert torch.equal(inst[~hit], torch.full_like(inst[~hit], -1))
            assert (normal[hit].norm(dim=1) > 0).all()
            if kind == "ties":
                assert int((inst == 1).sum()) == 0
                assert int((inst == 0).sum()) > 20
            crossed += int(((inside >= 0) & hit & (inst != inside)).sum())
    assert crossed > 0, "no ray left one instance and hit another"
    visible = [i for i in insts if i.mask & 0xFF]
    assert host.num_instances == len(visible)
    assert meta.num_real_tris == sum(i.mesh.num_tris for i in visible)


def _owner_box(o, host):
    """Spec index of the one instance box holding each origin, -1 where
    none or several do."""
    p = o.numpy()[:, None, :]
    lo, hi = host.inst_bounds[None, :, :3], host.inst_bounds[None, :, 3:]
    inside = ((p >= lo) & (p <= hi)).all(axis=2)
    return torch.tensor(np.where(inside.sum(axis=1) == 1,
                                 inside.argmax(axis=1), -1))


def test_masked_instance_is_left_out_of_both_levels():
    host, _ = build_instanced_scene(_placed("masked"), ENV)
    shown = _placed("masked")
    shown[1] = Instance(CUBE, shown[1].transform, mask=1)
    host_shown, _ = build_instanced_scene(shown, ENV)
    assert host.num_instances == 2 and len(host.blas) == 1
    assert host_shown.num_instances == 3 and len(host_shown.blas) == 2
    o, d = _rays(host_shown)
    cull = torch.ones(o.shape[0])
    hidden = instance_hit_plain(scene_from_jax(host, "cpu"), o, d, cull,
                                1e-4, 100.0)[1]
    shows = instance_hit_plain(scene_from_jax(host_shown, "cpu"), o, d, cull,
                               1e-4, 100.0)[1]
    assert not torch.equal(hidden >= 0, shows >= 0)


def test_a_blas_of_more_than_1024_clusters_walks_its_supers_in_groups():
    """A 20,480-tri mesh at clusters of 8 has 2,560 clusters under 80
    supers: the instance walk takes it too (its supers in groups of 32),
    and its twin meets the float64 bake there."""
    mesh = make_icosphere(5, 1.2)
    insts = [Instance(mesh, instance_transform((-1.3, 0.0, 0.0), 1.0, 10.0)),
             Instance(mesh, instance_transform((1.3, 0.2, 0.0), 0.8, 50.0))]
    host, _ = build_instanced_scene(insts, ENV, cluster_size=8)
    ts = scene_from_jax(host, "cpu")
    lv = walk_levels(ts)
    assert lv["walk"] == "instances" and lv["clusters"] == 2560
    assert lv["supers"] == 80 and lv["instances"] == 2
    o, d = _rays(host, n=150)
    cull = torch.ones(o.shape[0])
    t, key, _ = instance_hit_plain(ts, o, d, cull, 1e-4, 100.0)
    t64, key64 = _brute64(_world64(host), o, d, cull, 1e-4, 100.0)
    assert int(((key >= 0) != (key64 >= 0)).sum()) <= 1
    assert int((key.long() != key64).sum()) <= 2 and int((key >= 0).sum()) > 30


@pytest.mark.parametrize("cs", [None, 8])
def test_bake_is_the_single_mesh_scene_bit_for_bit(cs):
    """`InstancedScene.baked` equals, leaf for leaf, the single-mesh scene
    the JAX package's `build_instanced_scene` builds of the same instances
    (the port's own build before it kept two levels), and the meta is
    that scene's."""
    specs = [(lambda p: p.make_icosphere(2, 0.8), (-1.0, 0.0, 0.0), 1.0, 30.0,
              1),
             (lambda p: p.make_cube(1.0), (1.1, 0.0, 0.0), [1.0, 0.5, 2.0],
              20.0, 3),
             (lambda p: p.make_cube(1.0), (0.0, 1.4, 0.0), 1.0, 0.0, 0),
             (lambda p: p.make_icosphere(2, 0.8), (0.2, -1.2, 0.4), 0.7,
              -45.0, 1)]
    ours = [Instance(m(prim), instance_transform(t, s, r), mask=k)
            for m, t, s, r, k in specs]
    theirs = [JaxInstance(m(jax_prim), instance_transform(t, s, r), mask=k)
              for m, t, s, r, k in specs]
    host, meta = build_instanced_scene(ours, ENV, cs)
    ref, ref_meta = jax_build_instanced(theirs, ENV, cs)
    baked = host.baked()
    for name in UPLOADED:
        a, b = getattr(baked, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (meta.num_real_tris, meta.num_padded_tris, meta.cluster_size) == (
        ref_meta.num_real_tris, ref_meta.num_padded_tris,
        ref_meta.cluster_size)
    assert host.baked() is baked  # built once


def test_walk_of_and_walk_levels():
    """Forty instances of two meshes: the instance walk, two instance
    roots, and the BLASes' levels summed."""
    insts = [Instance(BALL if k % 2 else CUBE,
                      instance_transform((k % 8 - 4.0, 0.0, k // 8), 0.4,
                                         9.0 * k)) for k in range(40)]
    ts = scene_from_jax(build_instanced_scene(insts, ENV)[0], "cpu")
    lv = walk_levels(ts)
    assert walk_of(ts) == "instances"
    assert lv == {"walk": "instances", "roots": 0, "supers": 2,
                  "clusters": 2, "subs_per_cluster": 128, "instances": 40,
                  "instance_roots": 2}
    assert ts.inst_roots.shape == (2, 6) and ts.num_instances == 40
    # Each root bounds its run of 32 instance boxes (table order).
    for q, (lo, hi) in enumerate(((0, 32), (32, 40))):
        box = ts.inst_bounds[lo:hi]
        assert torch.equal(ts.inst_roots[q, :3], box[:, :3].amin(dim=0))
        assert torch.equal(ts.inst_roots[q, 3:], box[:, 3:].amax(dim=0))
    plain = scene_from_jax(build_instanced_scene(insts, ENV)[0].baked(),
                           "cpu")
    assert walk_of(plain) != "instances"
    assert "instances" not in walk_levels(plain)


class _FakeCard:
    """The CUDA runtime's current device and the kernel library, faked:
    each entry point records its name and arguments."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def device(self, dev):
        yield

    def library(self):
        calls = self.calls

        class Lib:
            def __getattr__(self, name):
                def entry(*args):
                    calls.append((name, args))
                    return 0
                return entry
        return Lib()


@pytest.mark.filterwarnings("ignore:Accessing the data pointer")
def test_fused_path_launches_the_instance_walk(monkeypatch):
    """`fused_radiance` on (fake) CUDA tensors of a two-level scene: one
    ``rt_frame`` launch with the instance tables and counts, counted under
    ``walks["instances"]``; the tables are checked once, and no bake is
    built."""
    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setattr(_build, "library", card.library)
    host, _ = build_instanced_scene(_placed("touching"), ENV)
    cfg = RenderConfig(width=24, height=16, max_refract_depth=3)
    checks = []
    real_check = framekernel._check_instance_tables
    monkeypatch.setattr(framekernel, "_check_instance_tables",
                        lambda *a: checks.append(1) or real_check(*a))
    dev = torch.device("cuda", 0)
    before = dict(fused_radiance.walks)
    with FakeTensorMode(allow_non_fake_inputs=True):
        ts = InstancedTorchScene(host, dev)
        scal = build_scalars(orbit_camera(0.3, cfg), cfg, sample_offsets(1),
                             "cpu").to(dev)
        for _ in range(2):
            fused_radiance(ts, scal, cfg)
    assert [name for name, _ in card.calls] == ["rt_frame", "rt_frame"]
    args = card.calls[0][1]
    assert len(args) == len(_build.SIGNATURES["rt_frame"])  # stream last
    n_roots, n_inst, n_inst_roots = args[-8], args[-3], args[-2]
    assert (n_roots, n_inst, n_inst_roots) == (0, 3, 0)
    assert args[14:18] == (0, 0, 0, 8)  # no single-mesh counts; sub_tris
    assert fused_radiance.walks["instances"] == before["instances"] + 2
    assert len(checks) == 1 and ts._baked is None


def _frame_setup():
    host, _ = build_instanced_scene(_placed("rotation_scale_mirror_explicit"),
                                    ENV, cluster_size=32)
    cfg = RenderConfig(width=20, height=14, max_refract_depth=3)
    return host, scene_from_jax(host, "cpu"), cfg


def test_every_other_path_renders_the_bake():
    """The CPU frame, the torch backend and the modular path, given the
    two-level scene, render its bake (`make_renderer` decides); pixel-DP
    (fused and wavefront), the LBVH oracle and the wavefront walk one mesh
    and are handed the bake by their callers (`frame_tiles` refuses the
    two levels); the eager integrator over the twin stays within the
    golden bar of the bake's frame."""
    host, ts, cfg = _frame_setup()
    bake = ts.baked()
    assert ts.baked() is bake and bake.baked() is bake
    frame = orbit_camera(0.5, cfg)
    scal = build_scalars(frame, cfg, sample_offsets(1), "cpu")
    want = fused_radiance_plain(bake, scal, cfg)
    assert want.abs().sum() > 0
    got = {
        "fused_cpu": fused_radiance_plain(ts, scal, cfg),
        "fused_renderer_cpu": make_renderer(cfg, "cuda", "cpu")(ts, frame),
        "torch": make_renderer(cfg, "torch", "cpu")(ts, frame),
        "modular": make_renderer(cfg, "cuda", "cpu", use_mega=False)(ts,
                                                                     frame),
        "pixel_dp": make_fused_sharded_renderer(cfg, make_mesh(2, "cpu"))(
            bake, frame),
        "wavefront_dp": make_sharded_renderer(cfg, make_mesh(2, "cpu"),
                                              "torch")(bake, frame),
    }
    for name, img in got.items():
        assert torch.equal(img, want), name
    with pytest.raises(ValueError, match="bake"):
        framekernel.frame_tiles(ts, scal, cfg, 1, 0, 1, 1)
    o, d = generate_rays(frame, cfg.width, cfg.height, "cpu")
    flat = render_pixels(bake, o, d, cfg, make_lbvh_backend(bake),
                         env_contribution_plain)
    assert torch.equal(flat, want.reshape(-1, 3))
    assert torch.equal(render_pixels_mega(bake, o, d, cfg), flat)
    walked = render_pixels(ts, o, d, cfg, instance_intersect,
                           env_contribution_plain)
    diff = (walked - want.reshape(-1, 3)).double()
    assert float(diff.pow(2).mean().sqrt()) < 1e-4
    assert float(diff.abs().max()) < 1e-3


def test_eager_integrator_hands_the_intersect_the_scene_it_is_given():
    """`render_pixels` passes the scene it is given to the intersect at
    every level (no bake of its own); `instance_intersect` serves the
    constant mask only."""
    host, ts, cfg = _frame_setup()
    o, d = generate_rays(orbit_camera(0.5, cfg), cfg.width, cfg.height,
                         "cpu")
    seen = []

    def spy(scene_, o, d, want_front, alive, tmin, tmax):
        seen.append(scene_)
        return instance_intersect(scene_, o, d, want_front, alive, tmin,
                                  tmax)

    render_pixels(ts, o, d, cfg, spy, env_contribution_plain)
    assert len(seen) == cfg.max_refract_depth + 1
    assert all(x is ts for x in seen) and ts._baked is None
    with pytest.raises(ValueError, match="0xff"):
        instance_intersect(ts, o, d, torch.ones(o.shape[0], dtype=bool),
                           torch.ones(o.shape[0], dtype=bool), 1e-4, 10.0,
                           ray_mask=torch.ones(o.shape[0], dtype=torch.int32))


def test_multi_process_renders_the_bake(tmp_path):
    """`parallel.distributed` in a group of one: frame sharding and
    pixel-DP over two CPU shards take a two-level host scene and render
    its bake (pixel-DP bit-equal to one device's frame)."""
    host, ts, cfg = _frame_setup()
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    try:
        dp = distributed.render_fused_dp_distributed(
            cfg, 0.5, host, device="cpu", devices=make_mesh(2, "cpu"))
        frames = distributed.render_frames_distributed(
            cfg, 2, None, 0, 1, angle0=0.5, scene=host, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    assert dp["matches_single_device"] and dp["devices_global"] == 2
    bake = ts.baked()
    want = sum(float(fused_radiance_plain(bake, build_scalars(
        orbit_camera(0.5 + 0.01 * k, cfg), cfg, sample_offsets(1), "cpu"),
        cfg).mean()) for k in range(2))
    assert frames["frames_rendered_global"] == 2
    assert abs(frames["checksum_global"] - want) < 1e-6


def _spec_files(tmp_path):
    """(spec, envmap) files of three instances, the third of mask 0."""
    ball, box = str(tmp_path / "ball.obj"), str(tmp_path / "box.obj")
    write_obj(ball, BALL)
    write_obj(box, CUBE)
    hdr = str(tmp_path / "env.hdr")
    write_hdr(hdr, make_gradient_envmap(16, 32))
    spec = tmp_path / "spec.json"
    spec.write_text(
        '[{"obj": "%s", "translate": [-1, 0, 0]}, {"obj": "%s", '
        '"translate": [1, 0, 0], "scale": 0.7}, {"obj": "%s", "translate": '
        '[0, 1, 0], "mask": 0}]' % (ball, box, box))
    return str(spec), hdr


def test_run_main_logs_the_instance_walk(tmp_path, caplog):
    spec, hdr = _spec_files(tmp_path)
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(["--instances", spec, "--envmap", hdr,
                         "--width", "16", "--height", "12", "--device", "cpu",
                         "--out", str(tmp_path / "f.png")]) == 0
    assert ("walk=instances: 2 instances under 0 instance roots, their "
            "BLASes 0 roots, 2 supers") in caplog.text


def test_run_main_hands_the_bake_to_the_paths_that_walk_one_mesh(tmp_path):
    """``--devices 2`` (pixel-DP over the wavefront) and ``--heatmap``
    render an ``--instances`` scene through its bake: the pixel-DP frame
    equals the one-device frame, and the heatmap is written."""
    from refraction_tpu_torch.io.png import load_png

    spec, hdr = _spec_files(tmp_path)
    common = ["--instances", spec, "--envmap", hdr, "--width", "16",
              "--height", "12", "--device", "cpu"]
    one, two = str(tmp_path / "one.png"), str(tmp_path / "two.png")
    assert run.main(common + ["--out", one]) == 0
    assert run.main(common + ["--devices", "2", "--out", two]) == 0
    assert np.array_equal(load_png(one), load_png(two))
    heat = str(tmp_path / "heat.png")
    assert run.main(common + ["--heatmap", heat, "--out",
                              str(tmp_path / "h.png")]) == 0
    assert load_png(heat).shape[:2] == (12, 16)


def test_instance_hit_refuses_other_devices_and_checks_rays():
    host, ts, _ = _frame_setup()
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="dirs"):
        instance_hit(ts, o, torch.zeros(4, 2), torch.ones(4), 1e-4, 10.0)
    t, key, normal = instance_hit(ts, o, torch.tensor([[0.0, 0.0, 1.0]] * 4),
                                  torch.zeros(4), 1e-4, 10.0)
    assert (key == -1).all() and torch.isinf(t).all() and not normal.any()


def test_traversal_work_counts_the_instance_level():
    """The port's count of the instance walk: every instance box (no roots
    at three instances), a transform a box the ray meets on [tmin, t_hit],
    and below each such instance its BLAS's clusters, subs and triangles
    as the flat count of that BLAS gives them for the moved ray."""
    host, ts, _ = _frame_setup()
    o, d = _rays(host, n=200)
    cull = torch.ones(o.shape[0])
    t, key, _ = instance_hit_plain(ts, o, d, cull, 1e-4, 100.0)
    t_hit = torch.where(key >= 0, t, torch.full_like(t, 100.0))
    work = traversal_work(ts, o, d, 1e-4, t_hit, cull)
    assert (work["instance_tests"] == ts.num_instances).all()
    assert (work["instance_root_tests"] == 0).all()
    want = {k: torch.zeros(o.shape[0], dtype=torch.int64)
            for k in ("transforms", "super_tests", "cluster_tests",
                      "sub_tests", "mt_tests")}
    for j in range(ts.num_instances):
        from refraction_tpu_torch.ops.intersect import (
            _object_rays,
            _safe_inv,
            _slab,
        )
        box = ts.inst_bounds[j].expand(o.shape[0], 6)
        tmin = torch.full((o.shape[0],), np.float32(1e-4))
        meet = _slab(box, o, _safe_inv(d), tmin, t_hit)
        want["transforms"] += meet
        rows = torch.nonzero(meet).squeeze(1)
        idx = torch.full((rows.numel(),), j)
        lo, inv, _, _ = _object_rays(ts, idx, o[rows], d[rows], tmin[rows],
                                     t_hit[rows])
        # The BLAS alone, with the one super box the instance walk gives
        # a BLAS of at most 32 clusters.
        _, _, _, sup, n_sup = ts.inst_info_host[j, :5]
        blas = scene_from_jax(host.blas[host.inst_blas[host.inst_order[j]]],
                              "cpu")._replace(
            super_bounds=ts.super_bounds[sup:sup + n_sup])
        sub = traversal_work(blas, lo, 1.0 / inv, 1e-4, t_hit[rows],
                             torch.ones(rows.numel()))
        for k in ("super_tests", "cluster_tests", "sub_tests", "mt_tests"):
            want[k].index_add_(0, rows, sub[k])
    for k, v in want.items():
        assert torch.equal(work[k], v), k
    assert int(work["mt_tests"].sum()) > 0


def test_frame_traversal_work_walks_the_two_levels():
    """The yardstick's frame count over a two-level scene takes its rays
    and hits from the instance walk (no bake is built) and counts the
    instance level at every bounce."""
    host, ts, cfg = _frame_setup()
    levels = frame_traversal_work(ts, cfg, orbit_camera(0.5, cfg), "cpu")
    assert ts._baked is None
    assert len(levels) == cfg.max_refract_depth + 1
    assert levels[0]["rays"] == cfg.width * cfg.height
    assert levels[0]["instance_tests"] == cfg.width * cfg.height * 4
    assert all(lv["transforms"] <= lv["instance_tests"] for lv in levels)
    assert levels[0]["misses"] < levels[0]["rays"]
