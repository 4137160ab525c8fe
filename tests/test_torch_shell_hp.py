"""The ``shell_hp`` deployment (rtbench/configs/shell_hp.json): a
1,638,400-triangle nested glass shell at 1920x1080.

On the CPU, without building its scene: the configuration's mesh has the
triangle count its two icospheres give, and at `scene.auto_cluster_size`
its tables have 3,200 clusters and 100 super boxes, more than 32, under 4
root boxes, so the frame kernel walks roots (`framekernel.walk_levels`).
The port's CPU path renders the configuration's ``render`` block on a
tiny nested shell as the benchmark's plain reference does, and
`run.main`'s scene log line names the walk and its levels (also for
config5's 20,480-triangle sphere, which takes the supers walk at its
size)."""

import json
import logging

import numpy as np
import pytest
import torch

from refraction_tpu_torch import run
from refraction_tpu_torch.bvh.morton import median_split_order
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.io.objmesh import MeshData
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.io.texture import load_texture
from refraction_tpu_torch.kernels.framekernel import walk_levels
from refraction_tpu_torch.kernels.intersect import check_scene_tables
from refraction_tpu_torch.render import make_renderer
from refraction_tpu_torch.scene import (
    SUB_TRIS,
    TorchScene,
    auto_cluster_size,
    box_levels,
    build_scene,
    scene_from_jax,
)
from rtbench import harness, inputs, spec
from rtbench.reference import tracer

CONFIG = spec._load_json(spec.config_path("shell_hp"), "shell_hp")
# rtbench's tiny nested shell (rtbench/tests/conftest.py TINY_MESH): 80
# outward triangles around 20 inward-wound ones.
TINY_SHELL = {"kind": "nested_shell", "outer_subdiv": 1, "outer_radius": 1.2,
              "inner_subdiv": 0, "inner_radius": 0.9}


def _tables(num_tris: int, cluster_size: int) -> TorchScene:
    """A scene of ``num_tris`` triangles at ``cluster_size`` with tables of
    the shapes `scene_from_jax` gives and no contents (nothing is built or
    written: `torch.empty`)."""
    clusters = num_tris // cluster_size
    e = lambda *shape: torch.empty(*shape, dtype=torch.float32)  # noqa: E731
    supers, roots = box_levels(np.zeros((clusters, 6), np.float32))
    return TorchScene(
        tri_a=e(num_tris, 3), tri_e1=e(num_tris, 3), tri_e2=e(num_tris, 3),
        tri_packed=e(num_tris, 9), tri_norm_packed=e(num_tris, 9),
        cluster_bounds=e(clusters, 6), sub_bounds=e(num_tris // SUB_TRIS, 6),
        envmap=e(4, 8, 3), tri_mask=None,
        super_bounds=torch.from_numpy(supers),
        root_bounds=torch.from_numpy(roots),
        sub_tris=SUB_TRIS)


def test_shell_hp_takes_the_grouped_supers_walk():
    mesh = CONFIG["mesh"]
    outer, inner = mesh["outer_subdiv"], mesh["inner_subdiv"]
    assert mesh["tris"] == 20 * 4 ** outer + 20 * 4 ** inner == 1638400
    # The generator gives 20 * 4^k triangles a sphere, outer first.
    small = inputs.nested_shell(2, 1.2, 1, 0.9)[0]
    assert small.shape == (20 * 4 ** 2 + 20 * 4 ** 1, 3, 3)
    cs = auto_cluster_size(mesh["tris"])
    assert cs == 512 and mesh["tris"] % cs == 0
    scene = _tables(mesh["tris"], cs)
    check_scene_tables(scene, torch.device("cpu"))  # the boxes' shape rule
    assert walk_levels(scene) == {"walk": "roots", "roots": 4, "supers": 100,
                                  "clusters": 3200, "subs_per_cluster": 64}
    assert scene.num_supers > 32  # so a level of roots above them
    assert CONFIG["reduced"] == ["mesh"]
    bench = spec.load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == "shell_hp.orbit")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "shell_hp", "orbit", 1)


def test_nested_shell_at_clusters_of_8_has_shell_hps_top_levels():
    """The GPU tier's stand-in for shell_hp's top levels: the 25,600-tri
    nested shell at clusters of 8 has 3,200 clusters, 100 supers and 4
    roots, walked as roots; each root's box holds its triangles, and its
    triangles are one node of the build's root-stage split."""
    pos, nrm, uv = inputs.nested_shell(5, 1.2, 4, 0.9)
    host, _ = build_scene(MeshData(pos, nrm, uv), make_gradient_envmap(16, 32),
                          8)
    scene = scene_from_jax(host, "cpu")
    check_scene_tables(scene, torch.device("cpu"))
    assert walk_levels(scene) == {"walk": "roots", "roots": 4, "supers": 100,
                                  "clusters": 3200, "subs_per_cluster": 1}
    window = 32 * 32 * 8
    nodes = median_split_order(pos, (window,))
    for q in range(4):  # the last root holds 4 supers
        run = slice(q * window, (q + 1) * window)
        node = pos[nodes[run]].reshape(-1, 3)
        np.testing.assert_array_equal(
            scene.root_bounds[q].numpy(),
            np.concatenate([node.min(0), node.max(0)]))
        tri = pos[nodes[run]]
        want = np.concatenate([tri[:, 0], tri[:, 1] - tri[:, 0],
                               tri[:, 2] - tri[:, 0]], 1)
        got = np.ascontiguousarray(host.tri_packed[run])
        assert (np.sort(got.view("V36").ravel())
                == np.sort(want.view("V36").ravel())).all(), q


@pytest.mark.parametrize("angles", [[0.3, 2.9], [4.7]])
def test_cpu_path_matches_the_reference_at_shell_hp_render(angles):
    """`make_renderer(rcfg, "torch", "cpu")` with shell_hp's ``render``
    block at 20x14 on the tiny nested shell, against the benchmark's plain
    reference (brute force over every triangle) to 1e-6."""
    render = json.loads(json.dumps(CONFIG["render"]))
    render.update(width=20, height=14)
    mesh = inputs.make_mesh(TINY_SHELL)
    env = inputs.make_env(2 ** 31 + 17, 32, 64, torch.device("cpu"))
    host, _ = build_scene(MeshData(*mesh), env.numpy(),
                          auto_cluster_size(mesh[0].shape[0]))
    scene = scene_from_jax(host, "cpu")
    rcfg = harness.render_config(render)
    assert (rcfg.width, rcfg.height, rcfg.spp, rcfg.max_refract_depth,
            rcfg.max_reflect_depth) == (20, 14, 1, 5, 2)
    assert rcfg.resolved_aspect == 20 / 14
    port = make_renderer(rcfg, "torch", "cpu")
    sc = tracer.Scene(mesh[0], mesh[1], env, "cpu")
    ids = torch.arange(20 * 14)[None].expand(len(angles), -1)
    ref, stats = tracer.render_views(sc, render, angles, ids)
    assert stats["hits"] > 0 and stats["misses"] > 0
    for k, a in enumerate(angles):
        img = port(scene, orbit_camera(a, rcfg)).reshape(-1, 3).double()
        assert float((img - ref[k]).abs().max()) < 1e-6


def _scene_line(caplog) -> str:
    lines = [m for m in caplog.messages if m.startswith("tris=")]
    assert len(lines) == 1, caplog.messages
    return lines[0]


def test_cli_logs_the_walk_and_its_levels(tmp_path, caplog, monkeypatch):
    """The flat walk on a small ball; the roots walk when the scene is
    built at clusters of 8 (20,480 triangles: 2,560 clusters, 80 supers
    under 3 roots)."""
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(16, 32))
    argv = ["--scene", obj, "--envmap", hdr, "--width", "8", "--height", "6",
            "--device", "cpu", "--out", str(tmp_path / "f.png")]
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(argv) == 0
    assert _scene_line(caplog) == (
        "tris=320 (padded 1024), envmap=(16, 32, 3), walk=flat: 0 roots, 0 "
        "supers, 1 clusters, 128 subs a cluster")

    def fine_scene(cfg):
        return build_scene(make_icosphere(5, 1.2),
                           load_texture(cfg.envmap_path), 8)

    monkeypatch.setattr(run, "load_scene", fine_scene)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(argv) == 0
    assert _scene_line(caplog) == (
        "tris=20480 (padded 20480), envmap=(16, 32, 3), walk=roots: 3 "
        "roots, 80 supers, 2560 clusters, 1 subs a cluster")


def test_cli_logs_the_supers_walk_of_config5s_sphere(tmp_path, caplog):
    """config5's 20,480-triangle sphere as `load_scene` builds it (at
    `auto_cluster_size`, 128 from 1,101 to 32,768 triangles): the supers
    walk, 5 supers and no roots over 160 clusters of 16 subs."""
    obj, hdr = write_scene(str(tmp_path), "ott", make_icosphere(5, 1.2),
                           make_gradient_envmap(16, 32))
    argv = ["--scene", obj, "--envmap", hdr, "--width", "6", "--height", "4",
            "--device", "cpu", "--out", str(tmp_path / "f.png")]
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(argv) == 0
    assert _scene_line(caplog) == (
        "tris=20480 (padded 20480), envmap=(16, 32, 3), walk=supers: 0 "
        "roots, 5 supers, 160 clusters, 16 subs a cluster")
