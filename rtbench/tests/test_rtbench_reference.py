"""The plain reference (rtbench/reference) agrees with the port's own
CPU path, `make_renderer(cfg, "torch", "cpu")`, on both configurations'
scene kinds at a tiny size, the nested shell included."""

import copy

import numpy as np
import pytest
import torch

from rtbench import harness, inputs, spec
from rtbench.reference import tracer
from rtbench.tests.conftest import TINY_MESH


@pytest.mark.parametrize("config", ["ref_demo", "config5"])
def test_reference_matches_the_port_on_the_cpu(config):
    from refraction_tpu_torch.camera import orbit_camera
    from refraction_tpu_torch.io.objmesh import MeshData
    from refraction_tpu_torch.render import make_renderer
    from refraction_tpu_torch.scene import (
        auto_cluster_size, build_scene, scene_from_jax)

    cfg = copy.deepcopy(spec._load_json(spec.config_path(config), config))
    render = cfg["render"]
    render.update(width=20, height=14)
    mesh = inputs.make_mesh(TINY_MESH[cfg["mesh"]["kind"]])
    env = inputs.make_env(2 ** 31 + 5, 32, 64, torch.device("cpu"))
    host, _ = build_scene(MeshData(*mesh), env.numpy(),
                          auto_cluster_size(mesh[0].shape[0]))
    scene = scene_from_jax(host, "cpu")
    rcfg = harness.render_config(render)
    port = make_renderer(rcfg, "torch", "cpu")
    sc = tracer.Scene(mesh[0], mesh[1], env, "cpu")
    angles = [0.3, 2.9]
    ids = torch.arange(20 * 14)[None].expand(2, -1)
    ref, stats = tracer.render_views(sc, render, angles, ids)
    assert stats["hits"] > 0 and stats["misses"] > 0
    for k, a in enumerate(angles):
        img = port(scene, orbit_camera(a, rcfg)).reshape(-1, 3).double()
        assert float((img - ref[k]).abs().max()) < 1e-6


def test_inner_wall_is_reached_from_the_glass():
    """In the nested shell some rays meet the inner wall: the ray trees
    are larger than the outer sphere's alone."""
    render = copy.deepcopy(spec._load_json(spec.config_path("ref_demo"),
                                           "x")["render"])
    render.update(width=16, height=12)
    env = inputs.make_env(1, 16, 32, torch.device("cpu"))
    ids = torch.arange(16 * 12)[None]
    counts = []
    for spec_ in (TINY_MESH["nested_shell"], TINY_MESH["icosphere"]):
        mesh = inputs.make_mesh(spec_)
        _, st = tracer.render_views(tracer.Scene(mesh[0], mesh[1], env, "cpu"),
                                    render, [0.0], ids)
        counts.append(st["hits"])
    assert counts[0] > counts[1]


def test_inputs_follow_the_seed():
    cpu = torch.device("cpu")
    a, b = inputs.make_env(7, 16, 32, cpu), inputs.make_env(7, 16, 32, cpu)
    assert torch.equal(a, b)
    assert not torch.equal(a, inputs.make_env(8, 16, 32, cpu))
    assert float(a.min()) >= 0.1 and float(a.max()) <= 1.6
    big = 2 ** 31 + 12345
    assert inputs.start_angle(big) == inputs.start_angle(big)
    assert 0 <= inputs.start_angle(big) < 2 * np.pi
    pos, nrm, _ = inputs.make_mesh({"kind": "nested_shell",
                                    "outer_subdiv": 3, "outer_radius": 1.2,
                                    "inner_subdiv": 2, "inner_radius": 0.9})
    assert pos.shape == (1600, 3, 3)
    # The inner wall's normals face its centre, its winding agrees.
    inner_p, inner_n = pos[1280:], nrm[1280:]
    geo = np.cross(inner_p[:, 1] - inner_p[:, 0],
                   inner_p[:, 2] - inner_p[:, 0])
    assert (np.sum(geo * inner_p.mean(axis=1), axis=1) < 0).all()
    assert (np.sum(inner_n[:, 0] * inner_p[:, 0], axis=1) < 0).all()
