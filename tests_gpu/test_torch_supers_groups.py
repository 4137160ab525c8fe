"""The frame kernel's top levels: scenes of more than 32 super boxes (over
1,024 clusters) get root boxes over runs of 32 supers, which ``rt_frame``
walks near to far above the supers (csrc/traverse_f2b.cuh,
RT_WALK_ROOTS), up to 32 roots; larger scenes (more than 32,768 clusters)
keep no roots and walk their supers in groups of 32, one after another.

A 25,600-triangle nested shell built at clusters of 8 has the top levels
of the benchmark's ``shell_hp`` deployment (3,200 clusters, 100 supers
under 4 roots) at a size the plain version renders in a moment; a
409,600-triangle one at clusters of 8 has 1,600 supers, so no roots and
50 groups of supers; the deployment's own 1,638,400-triangle scene is held against the
benchmark's plain reference (rtbench/reference/tracer.py) at a small
image. config5's 20,480-triangle sphere, built at `auto_cluster_size`,
takes the supers walk (5 supers, no roots). Each launch is counted under
its walk instance. The closest-hit and round kernels take the same
instances, held against the brute force; and the flat and supers
instances of the frame kernels keep the instructions they had before
there were roots (their SASS, recorded below)."""

import hashlib
import os
import re
import subprocess

import pytest
import torch

from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.integrator import initial_state
from refraction_tpu_torch.io.objmesh import MeshData
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels import _build
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    fused_radiance,
    fused_radiance_plain,
    walk_levels,
)
from refraction_tpu_torch.kernels.intersect import (
    closest_hit,
    closest_hit_plain,
)
from refraction_tpu_torch.kernels.megakernel import mega_round, mega_round_plain
from refraction_tpu_torch.render import make_renderer, sample_offsets
from refraction_tpu_torch.run import to_u8
from refraction_tpu_torch.scene import (
    auto_cluster_size,
    build_scene,
    scene_from_jax,
)
from rtbench import check, harness, inputs, spec
from rtbench.reference import tracer
from test_torch_kernels import AGREE, PIX_TOL, _img_ok, _rays

pytestmark = pytest.mark.cuda

SHELL_HP = spec._load_json(spec.config_path("shell_hp"), "shell_hp")
CONFIG5 = spec._load_json(spec.config_path("config5"), "config5")
U8_LIMITS = spec._load_json(spec.limits_path("shell_hp", "u8"),
                            "shell_hp.u8")["limits"]


def _counts():
    return fused_radiance.launches, dict(fused_radiance.walks)


def _took(before, launches: int, walk: str) -> None:
    """``launches`` launches since ``before``, each of walk ``walk``."""
    n, walks = before
    assert fused_radiance.launches - n == launches
    for w, count in fused_radiance.walks.items():
        assert count - walks[w] == (launches if w == walk else 0), w


def _shell_scene(outer: int, inner: int, cuda):
    """The nested shell of icospheres ``outer`` and ``inner`` at clusters
    of 8, on the card."""
    mesh = MeshData(*inputs.nested_shell(outer, 1.2, inner, 0.9))
    return scene_from_jax(build_scene(mesh, make_gradient_envmap(), 8)[0],
                          cuda)


def _frames_match_plain(scene, cuda, size, angles, walk="roots") -> None:
    """Frames at shell_hp's caps, one launch of ``walk`` each, equal the
    plain version's within the image bars."""
    cfg = harness.render_config({**SHELL_HP["render"], "width": size[0],
                                 "height": size[1]})
    assert (cfg.max_refract_depth, cfg.max_reflect_depth) == (5, 2)
    for angle in angles:
        scal = build_scalars(orbit_camera(angle, cfg), cfg, sample_offsets(1),
                             cuda)
        before = _counts()
        img = fused_radiance(scene, scal, cfg)
        _took(before, 1, walk)
        assert float(img.std()) > 0
        ok, why = _img_ok(img, fused_radiance_plain(scene, scal, cfg))
        assert ok, (angle, why)


def test_grouped_top_level_matches_plain(cuda):
    """shell_hp's top levels at 25,600 triangles: 100 supers under 4
    roots."""
    scene = _shell_scene(5, 4, cuda)
    assert scene.num_tris == 25600
    assert walk_levels(scene) == {"walk": "roots", "roots": 4, "supers": 100,
                                  "clusters": 3200, "subs_per_cluster": 1}
    _frames_match_plain(scene, cuda, (64, 48), (0.35, 2.2))


def test_roots_in_groups_match_plain(cuda):
    """Past 32 roots' worth (51,200 clusters, 1,600 supers) the scene
    keeps no roots: its supers are walked in 50 groups of 32, one after
    the other, over the root stage's table order."""
    scene = _shell_scene(7, 6, cuda)
    assert walk_levels(scene) == {"walk": "supers", "roots": 0,
                                  "supers": 1600, "clusters": 51200,
                                  "subs_per_cluster": 1}
    _frames_match_plain(scene, cuda, (48, 32), (0.35,), "supers")


def test_config5_mesh_walks_supers_and_matches_plain(cuda):
    """config5's sphere at `auto_cluster_size` (128): 160 clusters of 16
    subs under 5 super boxes, which ``rt_frame`` walks near to far; at
    config5's caps and spp the image matches the plain version."""
    mesh = make_icosphere(5, 1.2)
    assert mesh.num_tris == CONFIG5["mesh"]["tris"] == 20480
    host, _ = build_scene(mesh, make_gradient_envmap(),
                          auto_cluster_size(mesh.num_tris))
    scene = scene_from_jax(host, cuda)
    assert walk_levels(scene) == {"walk": "supers", "roots": 0, "supers": 5,
                                  "clusters": 160, "subs_per_cluster": 16}
    cfg = harness.render_config({**CONFIG5["render"], "width": 64,
                                 "height": 48})
    assert (cfg.spp, cfg.max_refract_depth, cfg.max_reflect_depth) == (4, 5, 2)
    for angle in (0.35, 2.2):
        scal = build_scalars(orbit_camera(angle, cfg), cfg,
                             sample_offsets(cfg.spp), cuda)
        before = _counts()
        img = fused_radiance(scene, scal, cfg)
        _took(before, 1, "supers")
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
    assert walk_levels(scene) == {"walk": "roots", "roots": 4, "supers": 100,
                                  "clusters": 3200, "subs_per_cluster": 64}
    cfg = harness.render_config(render)
    renderer = make_renderer(cfg, "cuda", cuda)
    angles = [0.9, 4.1]
    before = _counts()
    got = torch.stack([to_u8(renderer(scene, orbit_camera(a, cfg)))
                       for a in angles]).reshape(len(angles), -1, 3)
    _took(before, len(angles), "roots")
    sc = tracer.Scene(pos, nrm, env, cuda)
    ids = torch.arange(48 * 32, device=cuda)[None].expand(len(angles), -1)
    want = check.reference_u8(sc, render, angles, ids)
    numbers = check.u8_numbers(got.cpu(), want)
    ok, lines = check.verdict(numbers, U8_LIMITS)
    assert ok, lines


def _walk_scene(walk: str, cuda):
    """A sphere at clusters of 8 that takes ``walk``: 1,280 triangles
    (160 clusters, 5 supers) or 20,480 (2,560 clusters, 80 supers, 3
    roots)."""
    subdiv = {"supers": 3, "roots": 5}[walk]
    scene = scene_from_jax(build_scene(make_icosphere(subdiv, 1.2),
                                       make_gradient_envmap(), 8)[0], cuda)
    assert walk_levels(scene)["walk"] == walk
    return scene


@pytest.mark.parametrize("walk", ["supers", "roots"])
def test_closest_hit_kernel_on_each_walk_equals_the_brute_force(cuda, walk):
    scene = _walk_scene(walk, cuda)
    o, d, cull = _rays(20000, 11, cuda)
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


@pytest.mark.parametrize("walk", ["supers", "roots"])
def test_round_kernel_on_each_walk_equals_the_brute_force(cuda, walk):
    """The full round (radiance and both children), as
    test_torch_kernels.py holds it on flat scenes."""
    scene = _walk_scene(walk, cuda)
    n = 20000
    o, d, cull = _rays(n, 12, cuda)
    state = initial_state(o, d)
    state[6] = cull
    state[7] = torch.rand(n, generator=torch.Generator().manual_seed(3)).to(
        cuda)
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    got = mega_round(scene, state, limits, True, True)
    ref = mega_round_plain(scene, state, limits, True, True)
    torch.cuda.synchronize()
    off = (got.radiance - ref.radiance).abs().amax(dim=1) > PIX_TOL
    assert float(off.double().mean()) <= 1 - AGREE
    alive_k, alive_p = got.children[6] != 0, ref.children[6] != 0
    assert float((alive_k == alive_p).double().mean()) >= AGREE
    assert int(alive_p.sum()) > 500
    same = alive_k == alive_p
    torch.testing.assert_close(got.children[:, same], ref.children[:, same],
                               rtol=1e-5, atol=1e-6)


# sha256 of each kernel's SASS (`cuobjdump -sass` of frame.cu built alone
# with _build.NVCC_FLAGS; per instruction line, the /*addr*/ prefix and the
# encoding comments stripped) as the frame kernels were before the root
# level, and the nvcc release they were recorded with (NVIDIA H100 machine).
SASS_NVCC = "12.9"
SASS_BEFORE_ROOTS = {
    "rt_frame_kernel<0>":
        "6b22612764ce6a61301fb0f83d541e849497b4c78c9ba526e7a3b9680577ac88",
    "rt_frame_kernel<1>":
        "3cc9c8009ca217dc98a0f8fae5c0cd2466d95259bd8b0f2c5f2da8851af3c87d",
    "rt_frame_tiles_kernel<0>":
        "164738e401b87526b802d8d5744153228187c4ab2eec3940d9069eb1756e6c5e",
    "rt_frame_tiles_kernel<1>":
        "ddb047b03d009d674cb0176f1f70164c76a4c01ea7c17ad893343431bf499097",
}


def kernel_sass(obj: str) -> dict:
    """{mangled kernel name: its instruction lines} of an object file."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        if name is None:
            continue
        s = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        s = re.sub(r"/\* 0x[0-9a-f]{16} \*/", "", s).strip()
        if s and not s.startswith(".") and s != ";":
            funcs[name].append(s)
    return funcs


def test_flat_and_supers_frame_kernels_keep_their_instructions(cuda, tmp_path):
    """The flat and supers instances run the instructions they had before
    the roots instance was added. A change to the flat or supers walk
    made on purpose changes these hashes too: it records its own in
    SASS_BEFORE_ROOTS, with the nvcc release, in the same change."""
    nvcc = _build.find_nvcc()
    release = re.search(r"release (\S+),", subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True).stdout).group(1)
    if release != SASS_NVCC:
        pytest.skip(f"SASS recorded with nvcc {SASS_NVCC}, this is {release}")
    obj = str(tmp_path / "frame.o")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                    os.path.join(_build.CSRC, "frame.cu")], check=True,
                   capture_output=True)
    funcs = kernel_sass(obj)
    for label, want in SASS_BEFORE_ROOTS.items():
        kernel, walk = re.fullmatch(r"(\w+)<(\d)>", label).groups()
        mangled = f"_Z{len(kernel)}{kernel}ILi{walk}EEv"
        body = next(v for n, v in funcs.items() if n.startswith(mangled))
        assert hashlib.sha256("\n".join(body).encode()).hexdigest() == want, \
            label
    # The roots instance is there besides them.
    assert any(n.startswith("_Z15rt_frame_kernelILi2EEv") for n in funcs)
