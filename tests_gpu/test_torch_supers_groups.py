"""The frame kernel's grouped top level: scenes of more than 32 super
boxes (over 1,024 clusters), whose supers ``rt_frame`` walks in groups of
32, one group after another (csrc/traverse_f2b.cuh, RT_WALK_SUPERS).

A 25,600-triangle nested shell built at clusters of 8 has the top level
of the benchmark's ``shell_hp`` deployment (3,200 clusters, 100 supers in
four groups) at a size the plain version renders in a moment; the
deployment's own 1,638,400-triangle scene is held against the
benchmark's plain reference (rtbench/reference/tracer.py) at a small
image. config5's 20,480-triangle sphere, built at `auto_cluster_size`,
takes the supers walk with a single group. Each launch is counted under
its walk instance."""

import pytest
import torch

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.io.objmesh import MeshData
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    fused_radiance,
    fused_radiance_plain,
    walk_levels,
)
from refraction_tpu_torch.render import make_renderer, sample_offsets
from refraction_tpu_torch.run import to_u8
from refraction_tpu_torch.scene import (
    auto_cluster_size,
    build_scene,
    scene_from_jax,
)
from rtbench import check, harness, inputs, spec
from rtbench.reference import tracer
from test_torch_kernels import _img_ok

pytestmark = pytest.mark.cuda

SHELL_HP = spec._load_json(spec.config_path("shell_hp"), "shell_hp")
CONFIG5 = spec._load_json(spec.config_path("config5"), "config5")
U8_LIMITS = spec._load_json(spec.limits_path("shell_hp", "u8"),
                            "shell_hp.u8")["limits"]


def _counts():
    return fused_radiance.launches, dict(fused_radiance.walks)


def _took_supers(before, launches: int) -> None:
    """``launches`` launches since ``before``, each of the supers walk."""
    n, walks = before
    assert fused_radiance.launches - n == launches
    assert fused_radiance.walks["supers"] - walks["supers"] == launches
    assert fused_radiance.walks["flat"] == walks["flat"]


def test_grouped_top_level_matches_plain(cuda):
    mesh = MeshData(*inputs.nested_shell(5, 1.2, 4, 0.9))
    assert mesh.num_tris == 25600
    scene = scene_from_jax(build_scene(mesh, make_gradient_envmap(), 8)[0],
                           cuda)
    assert walk_levels(scene) == {"walk": "supers", "supers": 100,
                                  "groups": 4, "clusters": 3200,
                                  "subs_per_cluster": 1}
    cfg = harness.render_config({**SHELL_HP["render"], "width": 64,
                                 "height": 48})
    assert (cfg.max_refract_depth, cfg.max_reflect_depth) == (5, 2)
    for angle in (0.35, 2.2):
        scal = build_scalars(orbit_camera(angle, cfg), cfg, sample_offsets(1),
                             cuda)
        before = _counts()
        img = fused_radiance(scene, scal, cfg)
        _took_supers(before, 1)
        assert float(img.std()) > 0
        ok, why = _img_ok(img, fused_radiance_plain(scene, scal, cfg))
        assert ok, (angle, why)


def test_config5_mesh_walks_supers_and_matches_plain(cuda):
    """config5's sphere at `auto_cluster_size` (128): 160 clusters of 16
    subs under 5 super boxes, which ``rt_frame`` walks near to far; at
    config5's caps and spp the image matches the plain version."""
    mesh = make_icosphere(5, 1.2)
    assert mesh.num_tris == CONFIG5["mesh"]["tris"] == 20480
    host, _ = build_scene(mesh, make_gradient_envmap(),
                          auto_cluster_size(mesh.num_tris))
    scene = scene_from_jax(host, cuda)
    assert walk_levels(scene) == {"walk": "supers", "supers": 5,
                                  "groups": 1, "clusters": 160,
                                  "subs_per_cluster": 16}
    cfg = harness.render_config({**CONFIG5["render"], "width": 64,
                                 "height": 48})
    assert (cfg.spp, cfg.max_refract_depth, cfg.max_reflect_depth) == (4, 5, 2)
    for angle in (0.35, 2.2):
        scal = build_scalars(orbit_camera(angle, cfg), cfg,
                             sample_offsets(cfg.spp), cuda)
        before = _counts()
        img = fused_radiance(scene, scal, cfg)
        _took_supers(before, 1)
        assert float(img.std()) > 0
        ok, why = _img_ok(img, fused_radiance_plain(scene, scal, cfg))
        assert ok, (angle, why)


def test_shell_hp_scene_matches_the_reference(cuda):
    """The deployment's scene, as the benchmark builds it, through
    `make_renderer`'s frame path and the display transform at 48x32,
    against the plain reference's 8-bit image within the cell's limits."""
    render = {**SHELL_HP["render"], "width": 48, "height": 32}
    pos, nrm, uv = inputs.make_mesh(SHELL_HP["mesh"])
    assert pos.shape[0] == SHELL_HP["mesh"]["tris"]
    env = inputs.make_env(2 ** 31 + 77, 1024, 2048, cuda)
    host, _ = build_scene(MeshData(pos, nrm, uv), env.cpu().numpy(),
                          auto_cluster_size(pos.shape[0]))
    scene = scene_from_jax(host, cuda)
    assert walk_levels(scene) == {"walk": "supers", "supers": 100,
                                  "groups": 4, "clusters": 3200,
                                  "subs_per_cluster": 64}
    cfg = harness.render_config(render)
    renderer = make_renderer(cfg, "cuda", cuda)
    angles = [0.9, 4.1]
    before = _counts()
    got = torch.stack([to_u8(renderer(scene, orbit_camera(a, cfg)))
                       for a in angles]).reshape(len(angles), -1, 3)
    _took_supers(before, len(angles))
    sc = tracer.Scene(pos, nrm, env, cuda)
    ids = torch.arange(48 * 32, device=cuda)[None].expand(len(angles), -1)
    want = check.reference_u8(sc, render, angles, ids)
    numbers = check.u8_numbers(got.cpu(), want)
    ok, lines = check.verdict(numbers, U8_LIMITS)
    assert ok, lines
