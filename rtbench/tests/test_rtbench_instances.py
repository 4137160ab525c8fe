"""A configuration's ``scene`` of placed instances: the program builds it
with the port's `build_instanced_scene`, the reference bakes it with its
own code (`inputs.bake_instances`) and culls by instance boxes, and the
configurations with one ``mesh`` keep their path."""

import copy
import time

import numpy as np
import pytest
import torch

from rtbench import check, harness, inputs, roofline, spec
from rtbench.reference import tracer
from rtbench.tests.conftest import TINY_MESH

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
ANGLES = [0.3, 2.9]

# Four instances of the two tiny mesh kinds, close enough that refracted
# and reflected rays leave one and enter another: a rotation, a scale of
# three values, an explicit 3x4 transform and a mask-0 instance that would
# enclose all the others.
SCENE = {
    "kind": "instances",
    "meshes": {"shell": TINY_MESH["nested_shell"],
               "ball": TINY_MESH["icosphere"]},
    "instances": [
        {"mesh": "shell", "translate": [-0.75, 0.0, 0.1], "scale": 0.65,
         "rotate_y_deg": 30.0},
        {"mesh": "ball", "translate": [0.75, 0.1, -0.1],
         "scale": [0.6, 0.8, 0.5], "rotate_y_deg": -40.0, "mask": 3},
        {"mesh": "shell", "transform": [[0.5, 0.0, 0.0, 0.0],
                                        [0.0, 0.433, -0.25, 0.85],
                                        [0.0, 0.25, 0.433, 0.0]]},
        {"mesh": "ball", "translate": [0.0, 0.0, 0.0], "scale": 2.2,
         "mask": 0},
    ],
}


def _render():
    cfg = spec._load_json(spec.config_path("ref_demo"), "ref_demo")
    render = copy.deepcopy(cfg["render"])
    render.update(width=20, height=14)
    return render


def _config(scene):
    cfg = copy.deepcopy(spec._load_json(spec.config_path("ref_demo"),
                                        "ref_demo"))
    del cfg["mesh"]
    cfg["scene"] = scene
    cfg["render"] = _render()
    cfg["env"] = {"height": 32, "width": 64}
    return cfg


def _port_images(prog, render):
    from refraction_tpu_torch.camera import orbit_camera
    from refraction_tpu_torch.render import make_renderer

    rcfg = harness.render_config(render)
    port = make_renderer(rcfg, "torch", "cpu")
    return [port(prog.scene, orbit_camera(a, rcfg)).reshape(-1, 3).double()
            for a in ANGLES]


def _reference_images(sc, render):
    ids = torch.arange(render["width"] * render["height"])[None].expand(
        len(ANGLES), -1)
    return tracer.render_views(sc, render, ANGLES, ids)


def _with_mask(scene, k, mask):
    out = copy.deepcopy(scene)
    out["instances"][k]["mask"] = mask
    return out


def test_instanced_reference_matches_the_port_on_the_cpu(monkeypatch):
    """(a) The port's scene from `build_instanced_scene` against the
    reference's own bake, culled by instance boxes, at 20x14 and two
    angles; some child ray leaves one instance and hits another."""
    cfg = _config(SCENE)
    prog = harness.Program(cfg, SEED, CPU)
    sc, _ = harness.reference_scenes(prog.mesh, prog.placed, prog.env, CPU,
                                     False)
    assert sc.parts is not None and len(sc.parts) == 3
    _, _, ranges, boxes = inputs.bake_instances(*prog.placed)

    crossed = []
    real = tracer.closest_hit

    def spy(scene, o, d, outside, tmin, tmax):
        out = real(scene, o, d, outside, tmin, tmax)
        if scene is sc and tmin == cfg["render"]["secondary_tmin"]:
            hit, idx = out[0], out[4]
            src = _instance_of(o, boxes)
            dst = np.searchsorted(ranges[:, 1], idx.numpy(), side="right")
            crossed.append(int(((src != dst) & (src >= 0)
                                & hit.numpy()).sum()))
        return out

    monkeypatch.setattr(tracer, "closest_hit", spy)
    ref, stats = _reference_images(sc, cfg["render"])
    assert stats["hits"] > 0 and stats["misses"] > 0
    assert sum(crossed) > 0, "no ray tree crossed from one instance to another"
    for k, img in enumerate(_port_images(prog, cfg["render"])):
        # Both sides bake in float32 from the same matrices (the port's
        # float32 product, the reference's float64 one rounded once); the
        # images agree to float32 rounding of the radiance.
        assert float((img - ref[k]).abs().max()) < 1e-6


def _instance_of(points, boxes):
    """Index of the one box (unpadded, with a small margin) holding each
    point, -1 where none or several do."""
    p = points.numpy()[:, None, :]
    lo, hi = boxes[None, :, 0] - 1e-4, boxes[None, :, 1] + 1e-4
    inside = ((p >= lo) & (p <= hi)).all(axis=2)
    one = inside.sum(axis=1) == 1
    return np.where(one, inside.argmax(axis=1), -1)


def _touching_scene():
    """Three instances whose boxes touch or overlap: two spheres touching
    at the origin, a third overlapping the second's box."""
    return {"kind": "instances",
            "meshes": {"ball": TINY_MESH["icosphere"],
                       "shell": TINY_MESH["nested_shell"]},
            "instances": [
                {"mesh": "ball", "translate": [-1.2, 0.0, 0.0]},
                {"mesh": "ball", "translate": [1.2, 0.0, 0.0]},
                {"mesh": "shell", "translate": [1.9, 0.9, 0.3],
                 "scale": 0.5, "rotate_y_deg": 17.0}]}


def _coincident_scene():
    """Two instances placed alike, whose every hit ties at the same t, and
    a third beside them: the lower global index has to win each tie."""
    ball = {"mesh": "ball", "translate": [0.3, -0.2, 0.1], "scale": 0.9,
            "rotate_y_deg": 12.0}
    return {"kind": "instances", "meshes": {"ball": TINY_MESH["icosphere"]},
            "instances": [ball, dict(ball),
                          {"mesh": "ball", "translate": [-1.5, 0.0, 0.0],
                           "scale": 0.5}]}


def _probe_rays(boxes, gen):
    """Rays of every kind the cull must keep: random ones through the
    scene, rays lying in a box's face planes (grazing it), rays through
    its corners and edges, and rays starting on a box face, inside a box
    and at the touching point."""
    lo, hi = boxes[:, 0].astype(np.float64), boxes[:, 1].astype(np.float64)
    o, d = [], []
    n = 256
    o.append(gen.uniform(-6, 6, (n, 3)))
    d.append(gen.normal(size=(n, 3)))
    o.append(gen.uniform(-0.5, 0.5, (n, 3)))
    d.append(gen.normal(size=(n, 3)))
    for b in range(len(boxes)):
        for axis in range(3):
            for face in (lo[b, axis], hi[b, axis]):
                # In the face plane: the direction has no component along
                # the axis.
                oo = gen.uniform(lo[b] - 1, hi[b] + 1, (32, 3))
                oo[:, axis] = face
                dd = gen.normal(size=(32, 3))
                dd[:, axis] = 0.0
                o.append(oo)
                d.append(dd)
                # From the face plane outwards and inwards.
                oo = gen.uniform(lo[b], hi[b], (16, 3))
                oo[:, axis] = face
                o.append(oo)
                d.append(gen.normal(size=(16, 3)))
        corners = np.stack(np.meshgrid(*zip(lo[b], hi[b]),
                                       indexing="ij"), -1).reshape(-1, 3)
        src = gen.uniform(-6, 6, (len(corners), 3))
        o.append(src)
        d.append(corners - src)
        mids = (corners[:, None] + corners[None]).reshape(-1, 3) / 2
        src = gen.uniform(-6, 6, (len(mids), 3))
        o.append(src)
        d.append(mids - src)
    o.append(np.zeros((16, 3)))
    d.append(gen.normal(size=(16, 3)))
    o = torch.as_tensor(np.concatenate(o), dtype=torch.float32)
    d = torch.as_tensor(np.concatenate(d), dtype=torch.float64)
    d = (d / d.norm(dim=1, keepdim=True)).float()
    return o, d


SCENES = {"touching": _touching_scene, "coincident": _coincident_scene,
          "tiny": lambda: SCENE}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_culled_closest_hit_equals_the_brute_force(scene):
    """(b) The culled `closest_hit` returns the unculled brute force's
    hit, t, u, v and triangle bit for bit, on rays grazing box faces and
    through corners and edges, among instances whose boxes touch, and
    where two instances tie on every hit."""
    spec_ = SCENES[scene]()
    pos, nrm, ranges, boxes = inputs.bake_instances(
        *inputs.make_instances(spec_))
    env = inputs.make_env(SEED, 16, 32, CPU)
    culled = tracer.Scene(pos, nrm, env, CPU, instances=(ranges, boxes))
    brute = tracer.Scene(pos, nrm, env, CPU)
    o, d = _probe_rays(boxes, np.random.default_rng(7))
    hits = 0
    for outside in (True, False):
        flags = torch.full((o.shape[0],), outside)
        for tmin, tmax in ((1e-4, 100.0), (1e-3, 1000.0), (0.5, 2.0)):
            a = tracer.closest_hit(culled, o, d, flags, tmin, tmax)
            b = tracer.closest_hit(brute, o, d, flags, tmin, tmax)
            hit = b[0]
            assert torch.equal(a[0], hit)
            assert torch.equal(a[1], b[1])
            assert torch.equal(a[4], b[4])
            assert torch.equal(a[2][hit], b[2][hit])
            assert torch.equal(a[3][hit], b[3][hit])
            hits += int(hit.sum())
    assert hits > 100
    # Whole ray trees, children started on the surfaces included.
    render = _render()
    ids = torch.arange(render["width"] * render["height"])[None].expand(
        len(ANGLES), -1)
    rc, sc_ = tracer.render_views(culled, render, ANGLES, ids)
    rb, sb = tracer.render_views(brute, render, ANGLES, ids)
    assert torch.equal(rc, rb) and sc_ == sb and sb["hits"] > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_control_cull_equals_its_brute_force(scene):
    """The control (the reference in bfloat16) culls with boxes padded for
    bfloat16's rounding and renders as its unculled self."""
    pos, nrm, ranges, boxes = inputs.bake_instances(
        *inputs.make_instances(SCENES[scene]()))
    env = inputs.make_env(SEED, 16, 32, CPU)
    bf = torch.bfloat16
    culled = tracer.Scene(pos, nrm, env, CPU, bf, instances=(ranges, boxes))
    brute = tracer.Scene(pos, nrm, env, CPU, bf)
    render = _render()
    ids = torch.arange(render["width"] * render["height"])[None].expand(
        len(ANGLES), -1)
    rc, sc_ = tracer.render_views(culled, render, ANGLES, ids)
    rb, sb = tracer.render_views(brute, render, ANGLES, ids)
    assert torch.equal(rc, rb) and sc_ == sb and sb["hits"] > 0


def test_control_fails_the_limits_of_an_instanced_cell(tiny):
    """On a scene of instances, as on a mesh, the program passes the
    cell's limits and the control fails them (rtbench.control)."""
    from rtbench import control

    cell = _instanced_cell(True)
    seeds = [2 ** 31 + 11, 12]
    rows, _ = control.readings(cell, seeds, set(seeds), 0.2, CPU,
                               lambda m: None)
    for row in rows:
        assert check.verdict(row["program"], cell.limits)[0], row
        assert not check.verdict(row["control"], cell.limits)[0], row


def test_segment_meets_its_box():
    """The slab test: a segment meets a box it crosses, grazes along a
    face or starts in, and not one it stops short of or runs beside."""
    lo = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    hi = torch.tensor([[1.0, 1.0, 1.0]], dtype=torch.float64)
    o = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 0.0, 0.5], [0.5, 0.5, 0.5],
                      [-1.0, 0.5, 0.5], [-1.0, 1.5, 0.5], [2.0, 1.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                      [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    got = tracer.segment_meets(o, d, 0.0, 10.0, lo, hi)[:, 0].tolist()
    assert got == [True, True, True, True, False, True]
    assert not bool(tracer.segment_meets(o[:1], d[:1], 0.0, 0.5, lo, hi))


def test_masked_instance_is_absent_on_both_sides():
    """(c) A mask-0 instance (and one whose mask has no bit in 0xFF) is
    dropped by the program and by the reference: both render as if it
    were not listed, and it would change the image if it were shown."""
    render = _render()
    dropped = copy.deepcopy(SCENE)
    dropped["instances"] = SCENE["instances"][:3]
    high = _with_mask(SCENE, 3, 0x100)
    shown = _with_mask(SCENE, 3, 1)
    images = {}
    for name, scene in (("masked", SCENE), ("high", high),
                        ("dropped", dropped), ("shown", shown)):
        prog = harness.Program(_config(scene), SEED, CPU)
        sc, _ = harness.reference_scenes(prog.mesh, prog.placed, prog.env,
                                         CPU, False)
        images[name] = (prog.num_tris, sc.num_tris, prog.visible,
                        _port_images(prog, render),
                        _reference_images(sc, render)[0])
    per_mesh = {k: inputs.make_mesh(v)[0].shape[0]
                for k, v in SCENE["meshes"].items()}
    visible = sum(per_mesh[i["mesh"]] for i in SCENE["instances"][:3])
    for name in ("masked", "high", "dropped"):
        n_prog, n_ref, n_vis, port, ref = images[name]
        assert n_prog == n_ref == visible and n_vis == 3
        for a, b in zip(port, images["dropped"][3]):
            assert torch.equal(a, b)
        assert torch.equal(ref, images["dropped"][4])
    assert images["shown"][0] == visible + per_mesh["ball"]
    assert not torch.equal(images["shown"][4], images["dropped"][4])


@pytest.mark.parametrize("config", ["ref_demo", "config5", "shell_hp"])
def test_mesh_configurations_keep_their_scene(config):
    """(d) A configuration's ``mesh`` takes today's path: the program's
    scene equals, leaf for leaf and bit for bit, `build_scene` of its mesh
    at `auto_cluster_size`, and the reference has no instances."""
    from refraction_tpu_torch.io.objmesh import MeshData
    from refraction_tpu_torch.scene import (
        auto_cluster_size, build_scene, scene_from_jax)

    cfg = spec._load_json(spec.config_path(config), config)
    prog = harness.Program(cfg, SEED, CPU)
    mesh = inputs.make_mesh(cfg["mesh"])
    env = inputs.make_env(SEED, cfg["env"]["height"], cfg["env"]["width"],
                          CPU)
    host, _ = build_scene(MeshData(*mesh), env.numpy(),
                          auto_cluster_size(mesh[0].shape[0]))
    want = scene_from_jax(host, CPU)
    assert prog.placed is None and prog.visible == 1
    assert prog.num_tris == mesh[0].shape[0]
    for name, leaf in want._asdict().items():
        got = getattr(prog.scene, name)
        if isinstance(leaf, torch.Tensor):
            assert got.dtype == leaf.dtype and torch.equal(got, leaf), name
        else:
            assert got == leaf, name
    sc, ctl = harness.reference_scenes(prog.mesh, prog.placed, prog.env, CPU,
                                       True)
    assert sc.parts is None and ctl.parts is None
    assert sc.num_tris == mesh[0].shape[0]
    assert ctl.dtype == torch.bfloat16


def _bound_at_the_parent(counts, num_tris, render):
    """`roofline.bound` as it was before instanced scenes, frozen."""
    import math

    depth = math.ceil(math.log2(max(num_tris, 2)))
    ops = (counts["hits"] * (2 * depth * 25 + 52)
           + counts["misses"] * (25 + 17))
    nbytes = num_tris * 2 * 9 * 4 + render["width"] * render["height"] * 3 * 4
    ops_ms = ops / 67e12 * 1e3
    bytes_ms = nbytes / 3.35e12 * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            **counts}


@pytest.mark.parametrize("num_tris", [1, 1600, 20480, 1638400])
def test_roofline_of_a_mesh_is_unchanged(num_tris):
    """(d) Without ``instanced`` the bound's dict is the parent's."""
    render = {"width": 1920, "height": 1080}
    counts = {"rays": 5.5e6, "hits": 3.1e6, "misses": 2.4e6}
    assert roofline.bound(counts, num_tris, render) == _bound_at_the_parent(
        counts, num_tris, render)


def test_roofline_of_instances_by_hand():
    """An instanced scene: bytes of each named mesh once and 48 B a
    visible instance; operations over the placed triangles."""
    render = {"width": 10, "height": 10}
    counts = {"rays": 30.0, "hits": 10.0, "misses": 20.0}
    b = roofline.bound(counts, 64 * 1000, render, instanced=(1000, 64))
    depth = 16  # ceil(log2 64,000)
    assert b["ops"] == 10 * (2 * depth * 25 + 52) + 20 * (25 + 17)
    assert b["bytes"] == 1000 * 72 + 64 * 48 + 10 * 10 * 12
    meshes, placed = inputs.make_instances(SCENE)
    unique = sum(inputs.make_mesh(m)[0].shape[0]
                 for m in SCENE["meshes"].values())
    # The mask-0 ball is not counted; the other ball places the mesh.
    assert inputs.visible_counts(meshes, placed) == (unique, 3)
    only_shells = _with_mask(SCENE, 1, 0)
    assert inputs.visible_counts(*inputs.make_instances(only_shells)) == (
        inputs.make_mesh(SCENE["meshes"]["shell"])[0].shape[0], 2)


def test_instances_are_made_once_and_composed_by_the_convention():
    """`make_instances` makes each named mesh once and composes scale,
    then a rotation about +Y, then a translation, as the port's
    `instance_transform`; the program shares one `MeshData` a mesh."""
    from refraction_tpu_torch.scene import instance_transform

    meshes, placed = inputs.make_instances(SCENE)
    assert sorted(meshes) == ["ball", "shell"]
    assert [p[0] for p in placed] == ["shell", "ball", "shell", "ball"]
    assert [p[2] for p in placed] == [1, 3, 1, 0]
    for ent, (_, m, _) in zip(SCENE["instances"], placed):
        assert m.dtype == np.float32 and m.shape == (3, 4)
        if "transform" in ent:
            assert np.array_equal(m, np.asarray(ent["transform"], np.float32))
            continue
        want = instance_transform(ent["translate"], ent.get("scale", 1.0),
                                  ent.get("rotate_y_deg", 0.0))
        assert np.array_equal(m, want)
    # Scale first: a point on +X scaled by 2, turned 90 deg about +Y
    # (to -Z), then moved.
    m = inputs.instance_transform([1.0, 2.0, 3.0], 2.0, 90.0)
    p = m[:, :3] @ np.array([1.0, 0.0, 0.0], np.float32) + m[:, 3]
    assert np.allclose(p, [1.0, 2.0, 1.0], atol=1e-6)

    shared = {}
    from refraction_tpu_torch import scene as port_scene

    real = port_scene.build_instanced_scene

    def spy(instances, envmap, cluster_size=None):
        shared["meshes"] = [i.mesh for i in instances]
        shared["cluster_size"] = cluster_size
        return real(instances, envmap, cluster_size)

    try:
        port_scene.build_instanced_scene = spy
        harness.Program(_config(SCENE), SEED, CPU)
    finally:
        port_scene.build_instanced_scene = real
    ms = shared["meshes"]
    assert ms[0] is ms[2] and ms[1] is ms[3] and ms[0] is not ms[1]
    assert shared["cluster_size"] is None


def test_bake_follows_the_instances():
    """The reference's bake: positions by the affine map, normals by the
    inverse transpose without renormalising, mask-0 left out, one
    contiguous range a visible instance, boxes of its corners."""
    meshes, placed = inputs.make_instances(SCENE)
    pos, nrm, ranges, boxes = inputs.bake_instances(meshes, placed)
    start = 0
    for k, (name, m, mask) in enumerate(p for p in placed if p[2] & 0xFF):
        src_p, src_n, _ = meshes[name]
        lo, hi = ranges[k]
        assert lo == start and hi - lo == src_p.shape[0]
        start = hi
        lin = m[:, :3].astype(np.float64)
        assert np.allclose(pos[lo:hi], src_p @ lin.T + m[:, 3], atol=1e-6)
        # Normals stay perpendicular to the baked surface's tangents.
        tangent = (pos[lo:hi, 1] - pos[lo:hi, 0]).astype(np.float64)
        before = np.abs(np.sum((src_p[:, 1] - src_p[:, 0])
                               * src_n[:, 0], axis=1))
        after = np.abs(np.sum(tangent * nrm[lo:hi, 0], axis=1))
        np.testing.assert_allclose(after, before, atol=1e-5)
        assert np.array_equal(boxes[k, 0], pos[lo:hi].min(axis=(0, 1)))
        assert np.array_equal(boxes[k, 1], pos[lo:hi].max(axis=(0, 1)))
    assert start == pos.shape[0] == nrm.shape[0] and len(ranges) == 3
    # Scaled normals keep their length change: nothing renormalises them.
    lens = np.linalg.norm(nrm[ranges[1][0]:ranges[1][1]], axis=-1)
    assert not np.allclose(lens, 1.0, atol=1e-3)


def _bad(**change):
    out = copy.deepcopy(SCENE)
    for key, value in change.items():
        if key == "instance":
            out["instances"][0] = value
        else:
            out[key] = value
    return out


@pytest.mark.parametrize("bad, match", [
    (_bad(kind="tlas"), "unknown scene kind"),
    (_bad(meshes={}), "at least one mesh"),
    (_bad(instances=[]), "at least one instance"),
    (_bad(instance={"mesh": "nosuch"}), "unknown mesh 'nosuch'"),
    (_bad(instance={"mesh": "shell", "scale": 0.0}), "singular"),
    (_bad(instance={"mesh": "shell", "scale": [1.0, 1e-9, 1.0]}),
     "singular"),
    (_bad(instance={"mesh": "shell", "transform": [[1, 0, 0, 0],
                                                   [0, 1, 0, 0],
                                                   [1, 1, 0, 0]]}),
     "singular"),
    (_bad(instance={"mesh": "shell", "transform": [[1, 0, 0], [0, 1, 0],
                                                   [0, 0, 1]]}), "3x4"),
    (_bad(instance={"mesh": "shell", "transform": [[1, 0, 0, 0]] * 3,
                    "scale": 2.0}), "both"),
    (_bad(instance={"mesh": "shell", "rotate_x_deg": 5.0}), "unknown keys"),
    (_bad(instances=[{"mesh": "shell", "mask": 0},
                     {"mesh": "ball", "mask": 256}]), "masked out"),
    (_bad(meshes={"shell": {"kind": "torus"}, "ball": TINY_MESH["icosphere"]}),
     "unknown mesh kind"),
])
def test_bad_scene_specs_fail_loudly(bad, match):
    """(e) Each malformed ``scene`` fails at load, and the harness's
    program refuses it before building anything."""
    with pytest.raises(ValueError, match=match):
        inputs.make_instances(bad)
    with pytest.raises(ValueError, match=match):
        harness.Program(_config(bad), SEED, CPU)


def _instanced_cell(tiny: bool) -> spec.Cell:
    """ref_demo.orbit's traffic, metrics and limits on a scene of placed
    instances: at a test size on the CPU, or four nested shells of 1,600
    tris at 256x192 on a card."""
    base = spec.load_cell("ref_demo.orbit")
    cfg = copy.deepcopy(base.config)
    del cfg["mesh"]
    if tiny:
        cfg["scene"] = copy.deepcopy(SCENE)
        cfg["render"].update(width=12, height=8)
        cfg["env"] = {"height": 16, "width": 32}
        traffic = {**base.traffic, "warmup_frames": 2}
    else:
        shell = {k: v for k, v in spec._load_json(
            spec.config_path("ref_demo"), "x")["mesh"].items() if k != "tris"}
        cfg["scene"] = {
            "kind": "instances", "meshes": {"shell": shell},
            "instances": [{"mesh": "shell", "translate": [x, y, 0.0],
                           "scale": 0.55, "rotate_y_deg": 25.0 * k}
                          for k, (x, y) in enumerate(
                              [(-0.7, -0.7), (0.7, -0.7), (-0.7, 0.7),
                               (0.7, 0.7)])]}
        cfg["render"].update(width=256, height=192)
        traffic = base.traffic
    base.config, base.traffic = cfg, traffic
    base.name = "instances.orbit"
    return base


def test_instanced_cell_runs_through_the_harness(tiny):
    """``harness.run`` on an instanced cell at a test size: its log names
    the walk and the counts, its check is correct, and a frame altered
    where it is produced is not."""
    from refraction_tpu_torch import render

    lines = []
    res = harness.run(_instanced_cell(True), SEED, 0.2, True, CPU,
                      time.perf_counter(), log=lines.append)
    assert res.correct, res.lines
    scene_lines = [line for line in lines if line.startswith("scene: walk=")]
    assert len(scene_lines) == 1
    assert scene_lines[0].endswith("; 280 tris, 3 visible instances")
    real = render.fused_radiance
    try:
        render.fused_radiance = lambda *a: real(*a) * 0.98
        bad = harness.run(_instanced_cell(True), SEED, 0.2, False, CPU,
                          time.perf_counter(), log=lambda m: None)
    finally:
        render.fused_radiance = real
    assert not bad.correct, bad.lines


def test_scene_line_of_a_mesh_configuration():
    cfg = copy.deepcopy(spec._load_json(spec.config_path("ref_demo"), "x"))
    prog = harness.Program(cfg, SEED, CPU)
    assert prog.scene_line() == (
        "scene: walk=flat: 0 roots, 0 supers, 13 clusters, 16 subs a "
        "cluster; 1600 tris, 1 visible instances")


@pytest.mark.cuda
def test_instanced_cell_on_the_card(cuda):
    """(f) ``harness.run`` on the card: an in-memory cell of four placed
    nested shells (6,400 tris) at 256x192 reads ``correct`` true."""
    lines = []
    res = harness.run(_instanced_cell(False), SEED, 1.0, False, cuda,
                      time.perf_counter(), log=lines.append)
    assert res.correct, res.lines
    assert res.failed == 0 and res.attempted >= harness.MIN_FRAMES
    assert any(line.endswith("6400 tris, 4 visible instances")
               for line in lines), lines
    assert check.verdict(res.numbers, res.limits)[0]
