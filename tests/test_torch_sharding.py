"""refraction_tpu_torch.parallel.sharding on CPU shards: tests/test_sharding.py
case by case, with ``make_mesh(n, "cpu")`` (n shards on the one CPU, as
the JAX tests' virtual CPU mesh) in place of the 8-device CPU mesh.

A pixel's radiance does not depend on the other rays of its shard, so the
pixel-DP renderers are held bit for bit across shard counts, and the
fused one against the frame kernel's plain version; the one-shard
wavefront is held against the JAX `make_renderer` (xla) under the golden
bar of tests/test_golden.py (RMSE < 1e-4, max abs < 1e-3). Sample
parallelism adds the partial sums in another order: RMSE < 1e-6, as
tests/test_sharding.py:87. Triangle sharding: hits and winners equal to
the brute force, t to rtol 1e-6 (tests/test_sharding.py:95-120).

The last tests hold every kernel wrapper on a shard's path to its
tensors' device: on fake CUDA tensors of ``cuda:1`` (FakeTensorMode), a
mock library records the device that is current when each entry point is
called, while the thread's own current device is ``cuda:0``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import rmse
from refraction_tpu.config import RenderConfig as JaxRenderConfig
from refraction_tpu.render import make_renderer as jax_make_renderer
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels import _build, envmap
from refraction_tpu_torch.kernels import intersect as kintersect
from refraction_tpu_torch.kernels import megakernel
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    frame_tiles,
    frame_tiles_plain,
    fused_radiance,
    fused_radiance_plain,
)
from refraction_tpu_torch.ops.backends import torch_intersect
from refraction_tpu_torch.parallel import sharding
from refraction_tpu_torch.parallel.sharding import (
    make_fused_sharded_renderer,
    make_mesh,
    make_mesh2d,
    make_sample_sharded_renderer,
    make_sharded_renderer,
    make_trisharded_intersect,
)
from refraction_tpu_torch.render import make_renderer, sample_offsets
from refraction_tpu_torch.scene import build_scene, scene_from_jax

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3  # tests/test_golden.py


@pytest.fixture(scope="module")
def sphere(sphere_scene):
    return scene_from_jax(sphere_scene[0], "cpu")


@pytest.fixture(scope="module")
def cube(cube_scene):
    return scene_from_jax(cube_scene[0], "cpu")


@pytest.fixture(scope="module")
def one_shard(sphere):
    """The one-shard wavefront at 40x24 per backend, rendered once."""
    cfg = RenderConfig(width=40, height=24)
    frame = orbit_camera(0.6, cfg)
    return cfg, frame, {
        be: make_sharded_renderer(cfg, make_mesh(1, "cpu"), be)(sphere, frame)
        for be in ("torch", "cuda")}


def test_make_mesh_on_the_cpu():
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    grid = make_mesh2d(8, 2, "cpu")
    assert [len(row) for row in grid] == [4, 4]
    with pytest.raises(ValueError, match="samples=3"):
        make_mesh2d(8, 3, "cpu")


def test_make_mesh_raises_with_too_few_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"1 CUDA device\(s\) visible: cuda:0"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="visible: none"):
        make_mesh(2, "cuda")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_wavefront_pixel_dp_is_bit_equal_across_shards(sphere, one_shard,
                                                       backend, ndev):
    """"cuda" on CPU tensors: the compacted wavefront's plain version in
    units of 1,024 rays; "torch": the eager integrator in units of 8."""
    cfg, frame, ref = one_shard
    got = make_sharded_renderer(cfg, make_mesh(ndev, "cpu"), backend)(
        sphere, frame)
    assert got.shape == (24, 40, 3)
    assert torch.equal(got, ref[backend])


def test_one_shard_wavefront_matches_jax_make_renderer(sphere_scene,
                                                       one_shard):
    cfg, frame, ref = one_shard
    jcfg = JaxRenderConfig(width=40, height=24, backend="xla")
    want = np.asarray(jax_make_renderer(jcfg)(
        sphere_scene[0], frame))
    for img in ref.values():
        assert rmse(img.numpy(), want) < RMSE_BAR
        assert np.abs(img.numpy() - want).max() < MAX_BAR


def test_interleaved_sharding_equals_contiguous(sphere, one_shard):
    cfg, frame, _ = one_shard
    mesh = make_mesh(8, "cpu")
    inter = make_sharded_renderer(cfg, mesh, interleave=True)(sphere, frame)
    bands = make_sharded_renderer(cfg, mesh, interleave=False)(sphere, frame)
    assert torch.equal(inter, bands)


def test_unit_interleave_round_robin():
    scatter, gather = sharding._unit_interleave(24, 2, 3)
    x = torch.arange(24)
    # Units (pairs) 0..11; device d holds units d, d+3, d+6, d+9.
    assert scatter(x)[:8].tolist() == [0, 1, 6, 7, 12, 13, 18, 19]
    assert torch.equal(gather(scatter(x)), x)
    y = torch.arange(48).reshape(2, 24)
    assert torch.equal(scatter(y, axis=1)[1], scatter(y[1]))


def test_pixel_dp_supersampling(cube):
    cfg = RenderConfig(width=32, height=16, spp=4)
    frame = orbit_camera(0.3, cfg)
    single = make_renderer(cfg, "torch", "cpu")(cube, frame)
    sharded = make_sharded_renderer(cfg, make_mesh(8, "cpu"))(cube, frame)
    assert rmse(single.numpy(), sharded.numpy()) < 1e-7


@pytest.mark.parametrize("sample_devs", [2, 4])
def test_sample_sharded_matches_single(cube, sample_devs):
    cfg = RenderConfig(width=32, height=16, spp=4)
    frame = orbit_camera(0.3, cfg)
    single = make_renderer(cfg, "torch", "cpu")(cube, frame)
    grid = make_mesh2d(8, sample_devs, "cpu")
    assert (len(grid), len(grid[0])) == (sample_devs, 8 // sample_devs)
    out = make_sample_sharded_renderer(cfg, grid)(cube, frame)
    assert out.shape == (16, 32, 3)
    assert rmse(single.numpy(), out.numpy()) < 1e-6


def test_sample_sharded_rejects_uneven_spp():
    with pytest.raises(ValueError, match="spp=3"):
        make_sample_sharded_renderer(RenderConfig(spp=3),
                                     make_mesh2d(8, 2, "cpu"))


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(rng.random(n) < 0.5))


def test_trisharded_intersect_matches_brute_force(sphere):
    assert sphere.num_tris % 8 == 0
    o, d, wf = _random_rays(512, 7)
    alive = torch.ones(512, dtype=torch.bool)
    h1, t1, i1, _ = torch_intersect(sphere, o, d, wf, alive, 1e-4, 100.0)
    tri = make_trisharded_intersect(make_mesh(8, "cpu"))
    h2, t2, i2, n2 = tri(sphere, o, d, wf, alive, 1e-4, 100.0)
    assert n2 is None and bool(h1.any())
    assert torch.equal(h1, h2)
    assert torch.equal(i1[h1], i2[h1])
    np.testing.assert_allclose(t2[h1].numpy(), t1[h1].numpy(), rtol=1e-6)


def test_trisharded_ties_go_to_the_lowest_global_index(sphere):
    """The last shard's triangles are copies of the first shard's: every
    ray through one of them has an equal-t twin seven shards up. The
    lower global index must win, as in the brute force."""
    per = sphere.num_tris // 8
    rows = {k: getattr(sphere, k).clone() for k in ("tri_a", "tri_e1",
                                                    "tri_e2")}
    for x in rows.values():
        x[-per:] = x[:per]
    scene = sphere._replace(**rows)
    # Rays from random origins at the centroids of the first shard's tris.
    o, _, wf = _random_rays(2048, 11)
    pick = torch.from_numpy(np.random.default_rng(12).integers(0, per, 2048))
    aim = (rows["tri_a"] + (rows["tri_e1"] + rows["tri_e2"]) / 3.0)[pick]
    d = (aim - o) / torch.linalg.norm(aim - o, dim=1, keepdim=True)
    alive = torch.ones(2048, dtype=torch.bool)
    h1, t1, i1, _ = torch_intersect(scene, o, d, wf, alive, 1e-4, 100.0)
    tri = make_trisharded_intersect(make_mesh(8, "cpu"))
    h2, t2, i2, _ = tri(scene, o, d, wf, alive, 1e-4, 100.0)
    twins = h1 & (i1 < per)
    assert int(twins.sum()) > 200
    assert torch.equal(h1, h2) and torch.equal(i1[h1], i2[h1])
    assert torch.equal(t1[h1], t2[h1])


def test_trisharded_refuses_an_uneven_split(cube):
    tri = make_trisharded_intersect(make_mesh(3, "cpu"))
    o, d, wf = _random_rays(4, 0)
    with pytest.raises(ValueError, match="do not split evenly"):
        tri(cube, o, d, wf, torch.ones(4, dtype=torch.bool), 1e-4, 100.0)


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("w,h", [(128, 64), (96, 64)])
def test_fused_pixel_dp_equals_the_frame_kernels_plain_version(cube, w, h,
                                                               ndev):
    """128x64: 8 tiles, even over 1, 2 and 8 shards; 96x64: 6 tiles, 8
    shards leave two gated pad tiles (and 3 shards none)."""
    cfg = RenderConfig(width=w, height=h)
    frame = orbit_camera(0.3, cfg)
    single = fused_radiance_plain(
        cube, build_scalars(frame, cfg, sample_offsets(1), "cpu"), cfg)
    got = make_fused_sharded_renderer(cfg, make_mesh(ndev, "cpu"))(cube,
                                                                   frame)
    assert got.shape == (h, w, 3) and got.is_contiguous()
    assert torch.equal(got, single)


def test_fused_pixel_dp_on_the_large_scene():
    """81,920 triangles (tests/test_sharding.py:145-175) at depth 2 on a
    40x2 strip through the middle of a 4:3 frame: 2 tiles over 3 shards,
    one gated."""
    scene = scene_from_jax(build_scene(make_icosphere(6, 1.2),
                                       make_gradient_envmap(64, 128),
                                       512)[0], "cpu")
    cfg = RenderConfig(width=40, height=2, aspect=1.333, max_refract_depth=2)
    frame = orbit_camera(0.3, cfg)
    single = fused_radiance_plain(
        scene, build_scalars(frame, cfg, sample_offsets(1), "cpu"), cfg)
    got = make_fused_sharded_renderer(cfg, make_mesh(3, "cpu"))(scene, frame)
    assert float(single.std()) > 0
    assert torch.equal(got, single)


def test_frame_tiles_plain_gates_pad_tiles_and_outside_pixels(cube):
    cfg = RenderConfig(width=40, height=40, spp=2)  # 2x2 tiles, ragged
    frame = orbit_camera(0.3, cfg)
    scal = build_scalars(frame, cfg, sample_offsets(2), "cpu")
    img = fused_radiance_plain(cube, scal, cfg)
    # Shard 1 of 3 over 4 tiles padded to 6: global tiles 1 and 4 (pad).
    got = frame_tiles(cube, scal, cfg, 3, 1, 2, 4)
    assert got.shape == (2, 32, 32, 3)
    assert torch.equal(got[0, :, :8], img[:32, 32:40])
    assert not got[0, :, 8:].any() and not got[1].any()
    # A shard of gated tiles only.
    assert not frame_tiles_plain(cube, scal, cfg, 8, 5, 1, 4).any()
    with pytest.raises(ValueError, match="base"):
        frame_tiles(cube, scal, cfg, 2, 2, 1, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        frame_tiles(cube, scal.to("meta"), cfg, 2, 1, 2, 4)


# ---- every wrapper on a shard's path launches on its tensors' device ---

class _Current:
    """A stand-in for the thread's current CUDA device and its streams."""

    def __init__(self):
        self.index = 0
        self.calls = []

    @contextlib.contextmanager
    def device(self, dev):
        before, self.index = self.index, torch.device(dev).index
        try:
            yield
        finally:
            self.index = before

    def current_stream(self, dev=None):
        return type("Stream", (), {"cuda_stream": 0})()

    def library(self):
        current = self

        class Lib:
            def __getattr__(self, name):
                def entry(*args):
                    current.calls.append((name, current.index))
                    return 0
                return entry
        return Lib()


@pytest.fixture
def on_cuda1(monkeypatch):
    """Fake CUDA tensors on cuda:1, with the thread's current device 0 and
    the library mocked: returns the recorder and a cuda:1 copy of a
    scene."""
    cur = _Current()
    monkeypatch.setattr(torch.cuda, "device", cur.device)
    monkeypatch.setattr(torch.cuda, "current_stream", cur.current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: cur.index)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: type("Props", (), {"multi_processor_count": 132})())
    for mod in (_build, megakernel):
        monkeypatch.setattr(mod, "library", cur.library)
    scene = scene_from_jax(build_scene(make_cube(2.0), make_gradient_envmap(
        8, 16), 8)[0], "cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield cur, sharding.replicate_scene(scene, torch.device("cuda", 1))


@pytest.mark.filterwarnings("ignore:Accessing the data pointer")
def test_wrappers_launch_on_their_tensors_device(on_cuda1):
    """Each wrapper on a shard's path, called with cuda:1 tensors while the
    thread's current device is cuda:0: every entry point runs with cuda:1
    current, and the thread's device is cuda:0 again after each. (Fake
    tensors take no strided copies on a CPU-only build, so the inputs are
    made whole here.)"""
    cur, scene = on_cuda1
    dev = torch.device("cuda", 1)
    assert scene.device == dev
    cfg = RenderConfig(width=40, height=24, max_refract_depth=3)
    scal = build_scalars(orbit_camera(0.3, cfg), cfg, sample_offsets(1),
                         "cpu").to(dev)
    fused_radiance(scene, scal, cfg)
    frame_tiles(scene, scal, cfg, 2, 1, 1, 2)
    n = 16
    o, d, w = (torch.ones(n, 3, device=dev), torch.ones(n, 3, device=dev),
               torch.ones(n, device=dev))
    kintersect.closest_hit(scene, o, d, w, 1e-4, 100.0)
    envmap.env_contribution(scene, d, w)
    limits = (1e-3, 1e3, 1.3, 0.04)
    megakernel.mega_round(scene, torch.ones(8, n, device=dev), limits, True,
                          True)
    megakernel.fold_round_sums(torch.zeros(2 * n, 3, device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev),
                               torch.zeros(n, 3, device=dev))
    # A round of two lanes per pixel: the round kernel, then the fold.
    queue = megakernel.LaneQueue(
        *megakernel.empty_queue(2 * n, dev),
        torch.ones(1, dtype=torch.int32, device=dev), 2 * n)
    out = megakernel.LaneQueue(
        *megakernel.empty_queue(4 * n, dev),
        torch.zeros(1, dtype=torch.int32, device=dev), 4 * n)
    megakernel.mega_round_queue(scene, queue, limits, True, True,
                                torch.zeros(n, 3, device=dev), None, out)
    assert [name for name, _ in cur.calls] == [
        "rt_frame", "rt_frame_tiles", "rt_closest_hit", "rt_env", "rt_round",
        "rt_fold_round", "rt_round_queue", "rt_fold_round"]
    assert {index for _, index in cur.calls} == {1}
    assert cur.index == 0
