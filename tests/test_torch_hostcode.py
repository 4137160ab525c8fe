"""The port's copies of the JAX package's host code, held against the
originals on the same seeded inputs, exactly: config, camera matrices,
OBJ/MTL/HDR/PNG IO, the procedural fixtures, the triangle orderings, the
scene build (bit for bit on every uploaded leaf) and the viewer."""

import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import refraction_tpu.bvh.clusters as jax_clusters
import refraction_tpu.bvh.morton as jax_morton
import refraction_tpu.camera as jax_camera
import refraction_tpu.config as jax_config
import refraction_tpu.io.hdr as jax_hdr
import refraction_tpu.io.mtl as jax_mtl
import refraction_tpu.io.objmesh as jax_obj
import refraction_tpu.io.png as jax_png
import refraction_tpu.io.primitives as jax_prim
import refraction_tpu.io.texture as jax_texture
import refraction_tpu.scene as jax_scene
import refraction_tpu.utils.stats as jax_stats
import refraction_tpu.viewer as jax_viewer
import refraction_tpu_torch.bvh.clusters as clusters
import refraction_tpu_torch.bvh.morton as morton
import refraction_tpu_torch.camera as camera
import refraction_tpu_torch.config as config
import refraction_tpu_torch.io.hdr as hdr
import refraction_tpu_torch.io.mtl as mtl
import refraction_tpu_torch.io.objmesh as objmesh
import refraction_tpu_torch.io.png as png
import refraction_tpu_torch.io.primitives as prim
import refraction_tpu_torch.io.texture as texture
import refraction_tpu_torch.scene as scene
import refraction_tpu_torch.utils.stats as stats
import refraction_tpu_torch.viewer as viewer
from refraction_tpu_torch.fixtures import write_obj

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq_tree(a, b):
    """Equal, bit for bit, field by field (dataclasses, tuples, arrays)."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq_tree(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---- config -------------------------------------------------------------

def test_render_config_defaults_equal():
    ours = dataclasses.asdict(config.RenderConfig())
    ref = dataclasses.asdict(jax_config.RenderConfig())
    # Asset paths depend on where each package looks without RRT_ASSET_DIR;
    # test_render_config_equal_under_rrt_asset_dir holds them equal.
    for k in ("scene_path", "envmap_path"):
        assert os.path.basename(ours.pop(k)) == os.path.basename(ref.pop(k))
    assert ours == ref
    assert config.REF_PI_CAMERA == jax_config.REF_PI_CAMERA
    assert config.REF_PI_ENVMAP == jax_config.REF_PI_ENVMAP
    assert (dataclasses.asdict(config.reference_config())
            == dataclasses.asdict(config.RenderConfig()))


def test_render_config_equal_under_rrt_asset_dir(tmp_path):
    script = (
        "import dataclasses, json\n"
        "import refraction_tpu.config as a, refraction_tpu_torch.config as b\n"
        "print(json.dumps([dataclasses.asdict(a.RenderConfig()),"
        " dataclasses.asdict(b.RenderConfig()),"
        " a.DEFAULT_ASSET_DIR, b.DEFAULT_ASSET_DIR]))\n")
    env = dict(os.environ, PYTHONPATH=REPO, RRT_ASSET_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    ref, ours, ref_dir, our_dir = json.loads(out)
    assert ours == ref and our_dir == ref_dir == str(tmp_path)


@pytest.mark.parametrize("shape", [(1024, 768), (1920, 1080), (64, 48)])
def test_render_config_properties_equal(shape):
    kw = dict(width=shape[0], height=shape[1], spp=4, fov_y_deg=40.0)
    ours, ref = config.RenderConfig(**kw), jax_config.RenderConfig(**kw)
    for prop in ("resolved_aspect", "fov_y_rad", "fresnel_r0"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert (dataclasses.asdict(ours.replace(ior=1.45))
            == dataclasses.asdict(ref.replace(ior=1.45)))


# ---- camera -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1024, 768), (1920, 1080)])
def test_orbit_camera_equal_at_five_angles(shape):
    kw = dict(width=shape[0], height=shape[1])
    ours, ref = config.RenderConfig(**kw), jax_config.RenderConfig(**kw)
    for angle in (0.0, 0.01, 0.3, 1.7, -2.5):
        a, b = camera.orbit_camera(angle, ours), jax_camera.orbit_camera(angle, ref)
        _eq_tree((a.origin, a.proj_inv), (b.origin, b.proj_inv))
        assert a.proj_inv.dtype == np.float32


def test_camera_matrix_builders_equal():
    rng = np.random.default_rng(3)
    for _ in range(5):
        fov, aspect = rng.uniform(0.3, 1.5), rng.uniform(0.5, 2.0)
        _eq_tree(camera.perspective_fov_lh(fov, aspect, 1.0, 125.0),
                 jax_camera.perspective_fov_lh(fov, aspect, 1.0, 125.0))
        v = rng.normal(size=4)
        _eq_tree(camera.translation(v), jax_camera.translation(v))
        eye, at = rng.normal(size=3), rng.normal(size=3)
        up = np.array([0.0, 1.0, 0.0])
        _eq_tree(camera.look_at_lh(eye, at, up), jax_camera.look_at_lh(eye, at, up))


# ---- OBJ / MTL ----------------------------------------------------------

_OBJ = """# a small OBJ with the reference loader's corner cases
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 0.5 0.5 1.25e-1
v 1.5abc 0 0
vt 0 0
vt 1 0
vn 0 0 1
vn 0 1 0
f 1/1/1 2/2/1 3/1/2
f 1/1/1 2/2/1 4/2/2 3/1/1
f 1//1 2//1 3//1
f 1/1/1 2/2/1 9/1/1
f 2/2/2 4/1/1 3/2/2
"""

_MTL = """newmtl glass
Ns 96.0
Ni 1.45
Kd 0.8 0.8 0.8
map_Kd missing.png
newmtl other
Ni 2.0
"""


def test_parse_obj_and_mtl_equal(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(_OBJ)
    (tmp_path / "m.mtl").write_text(_MTL)
    ours = objmesh.parse_obj(str(path))
    for ref in (jax_obj.parse_obj(str(path), allow_native=False),
                jax_obj.parse_obj(str(path)), jax_obj.parse_obj_text(_OBJ)):
        _eq_tree((ours.positions, ours.normals, ours.uvs),
                 (ref.positions, ref.normals, ref.uvs))
    assert ours.num_tris == 3 and ours.num_verts == 9
    _eq_tree(ours.flat_vertices(), ref.flat_vertices())
    assert mtl.parse_mtl(str(tmp_path / "m.mtl")) == jax_mtl.parse_mtl(
        str(tmp_path / "m.mtl"))
    assert (mtl.ior_for_scene(str(path), 1.3)
            == jax_mtl.ior_for_scene(str(path), 1.3) == 1.45)
    assert (mtl.ior_for_scene(str(tmp_path / "none.obj"), 1.3)
            == jax_mtl.ior_for_scene(str(tmp_path / "none.obj"), 1.3) == 1.3)


def test_written_obj_parses_equal(tmp_path):
    path = str(tmp_path / "ico.obj")
    write_obj(path, prim.make_icosphere(2, 1.2))
    a, b = objmesh.parse_obj(path), jax_obj.parse_obj(path)
    _eq_tree((a.positions, a.normals, a.uvs), (b.positions, b.normals, b.uvs))


# ---- HDR / PNG / texture ------------------------------------------------

def _hdr_image(seed=4, h=9, w=13):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 2] = [1e-35, 2.0, 0.5]
    return img


def test_hdr_round_trips_equal(tmp_path):
    img = _hdr_image()
    _eq_tree(hdr.float_to_rgbe(img), jax_hdr.float_to_rgbe(img))
    rgbe = hdr.float_to_rgbe(img)
    _eq_tree(hdr.rgbe_to_float(rgbe), jax_hdr.rgbe_to_float(rgbe))
    ours, ref = tmp_path / "a.hdr", tmp_path / "b.hdr"
    hdr.write_hdr(str(ours), img)
    jax_hdr.write_hdr(str(ref), img)
    assert ours.read_bytes() == ref.read_bytes()
    back = hdr.load_hdr(str(ours))
    _eq_tree(back, jax_hdr.load_hdr(str(ours), allow_native=False))
    _eq_tree(back, jax_hdr.load_hdr(str(ours)))
    _eq_tree(hdr.decode_hdr_bytes(ours.read_bytes()),
             jax_hdr.decode_hdr_bytes(ours.read_bytes()))


def _rle_hdr_bytes(w=16, h=3):
    """New-style RLE scanlines: a run then literals per component."""
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            out += bytes([128 + w // 2, 100 + c + y])
            out += bytes([w - w // 2]) + bytes(range(w - w // 2))
    return bytes(out)


def test_hdr_rle_decode_equal():
    data = _rle_hdr_bytes()
    _eq_tree(hdr.decode_hdr_bytes(data), jax_hdr.decode_hdr_bytes(data))


@pytest.mark.parametrize("kind", ["u8 rgb", "float rgb", "u8 rgba", "u8 gray"])
def test_png_round_trips_equal(tmp_path, kind):
    rng = np.random.default_rng(5)
    if kind == "float rgb":
        img = rng.uniform(-0.2, 1.2, (7, 11, 3)).astype(np.float32)
    else:
        c = {"u8 rgb": 3, "u8 rgba": 4, "u8 gray": 1}[kind]
        img = rng.integers(0, 256, (7, 11, c), dtype=np.uint8)
        if c == 1:
            img = img[..., 0]
    a, b = io.BytesIO(), io.BytesIO()
    png.encode_png(a, img)
    jax_png.encode_png(b, img)
    assert a.getvalue() == b.getvalue()
    _eq_tree(png.decode_png_bytes(a.getvalue()),
             jax_png.decode_png_bytes(a.getvalue()))
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    _eq_tree(png.load_png(path), jax_png.load_png(path, allow_native=False))
    _eq_tree(png.load_png(path), jax_png.load_png(path))
    dec = png.load_png(path)
    if dec.ndim == 3:
        _eq_tree(png.png_to_float_rgb(dec), jax_png.png_to_float_rgb(dec))


@pytest.mark.parametrize("ext", [".hdr", ".png"])
def test_load_texture_equal(tmp_path, ext):
    path = str(tmp_path / f"env{ext}")
    if ext == ".hdr":
        hdr.write_hdr(path, _hdr_image())
    else:
        png.write_png(path, _hdr_image() / 4.0)
    _eq_tree(texture.load_texture(path), jax_texture.load_texture(path))
    # The extension fallback (.hdr asked, .png present and vice versa).
    other = path[:-4] + (".png" if ext == ".hdr" else ".hdr")
    _eq_tree(texture.load_texture(other), jax_texture.load_texture(other))


# ---- procedural fixtures and orderings ------------------------------------

def test_primitives_equal():
    for sub in range(4):
        a, b = prim.make_icosphere(sub, 1.2), jax_prim.make_icosphere(sub, 1.2)
        _eq_tree((a.positions, a.normals, a.uvs), (b.positions, b.normals, b.uvs))
    for smooth in (False, True):
        a, b = prim.make_cube(2.0, smooth), jax_prim.make_cube(2.0, smooth)
        _eq_tree((a.positions, a.normals, a.uvs), (b.positions, b.normals, b.uvs))
    _eq_tree(prim.make_gradient_envmap(64, 128), jax_prim.make_gradient_envmap(64, 128))
    _eq_tree(prim.make_checker_envmap(32, 64, 4), jax_prim.make_checker_envmap(32, 64, 4))


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, 1, 3)) * np.array([3.0, 1.0, 0.5])
    return (c + 0.1 * rng.normal(size=(n, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_orderings_and_clusters_equal(n):
    tris = _soup(n, n)
    _eq_tree(morton.morton_order(tris), jax_morton.morton_order(tris))
    _eq_tree(morton.hilbert_order(tris), jax_morton.hilbert_order(tris))
    levels = (256, 32, 8)
    _eq_tree(morton.median_split_order(tris, levels),
             jax_morton.median_split_order(tris, levels))
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    _eq_tree(morton.morton3d(tris.mean(1), lo, hi),
             jax_morton.morton3d(tris.mean(1), lo, hi))
    pad = (-n) % 8
    padded = np.concatenate([tris, np.repeat(tris[-1:, :1], 3, 1).repeat(pad, 0)
                             if pad else tris[:0]])
    _eq_tree(clusters.build_clusters(padded, 8),
             jax_clusters.build_clusters(padded, 8))
    rng = np.random.default_rng(n + 1)
    o, inv = rng.normal(size=(16, 3)), 1.0 / rng.normal(size=(16, 3))
    _eq_tree(clusters.ray_aabb_hit_np(o, inv, 0.0, 10.0, lo, hi),
             jax_clusters.ray_aabb_hit_np(o, inv, 0.0, 10.0, lo, hi))


def test_morton_order_empty_equal():
    empty = np.zeros((0, 3, 3), np.float32)
    for fn in ("morton_order", "hilbert_order"):
        _eq_tree(getattr(morton, fn)(empty), getattr(jax_morton, fn)(empty))


# ---- scene build ------------------------------------------------------------

def _check_scene(ours, ref):
    (s, m), (rs, rm) = ours, ref
    for name in scene.UPLOADED:
        a, b = getattr(s, name), np.asarray(getattr(rs, name))
        assert a.dtype == b.dtype, name
        _eq_tree(a, b)
    assert s.num_clusters == rs.num_clusters and s.num_tris == rs.num_tris
    _eq_tree(m, rm)


@pytest.mark.parametrize("mesh", ["icosphere2", "icosphere3", "cube"])
@pytest.mark.parametrize("cs", [None, 8, 32])
def test_build_scene_leaves_equal(mesh, cs):
    m = {"icosphere2": lambda p: p.make_icosphere(2, 1.2),
         "icosphere3": lambda p: p.make_icosphere(3, 1.2),
         "cube": lambda p: p.make_cube(2.0)}[mesh]
    env = prim.make_gradient_envmap(16, 32)
    size = cs or scene.auto_cluster_size(m(prim).num_tris)
    _check_scene(scene.build_scene(m(prim), env, size),
                 jax_scene.build_scene(m(jax_prim), env, size))


@pytest.mark.parametrize(
    "n", [0, 12, 1100, 1101, 1280, 8192, 32769, 81920])
def test_auto_cluster_size_equal(n):
    """Outside 8,193-32,768 triangles both packages build the same tables."""
    assert scene.auto_cluster_size(n) == jax_scene.auto_cluster_size(n)


@pytest.mark.parametrize("n", [8193, 10240, 12877, 20480, 25600, 32768])
def test_auto_cluster_size_band_walks_supers(n):
    """From 8,193 to 32,768 triangles the port sizes clusters for the
    H100's walk, not the JAX package's TPU sweep: more than
    ``SUPER_CLUSTERS`` clusters (the tables get super boxes, so the frame
    kernel walks near to far), each of 16 subs."""
    size = scene.auto_cluster_size(n)
    assert size == 128
    assert -(-n // size) > scene.SUPER_CLUSTERS
    assert size // scene.SUB_TRIS == 16


def test_load_scene_equal(tmp_path):
    obj = str(tmp_path / "ball.obj")
    write_obj(obj, prim.make_icosphere(3, 1.2))
    env = str(tmp_path / "env.hdr")
    hdr.write_hdr(env, prim.make_gradient_envmap(32, 64))
    kw = dict(scene_path=obj, envmap_path=env)
    _check_scene(scene.load_scene(config.RenderConfig(**kw)),
                 jax_scene.load_scene(jax_config.RenderConfig(**kw)))


def test_load_instanced_equal(tmp_path):
    ball, box = str(tmp_path / "ball.obj"), str(tmp_path / "box.obj")
    write_obj(ball, prim.make_icosphere(2, 0.9))
    write_obj(box, prim.make_cube(1.2))
    env = str(tmp_path / "env.hdr")
    hdr.write_hdr(env, prim.make_gradient_envmap(32, 64))
    spec = str(tmp_path / "spec.json")
    with open(spec, "w") as f:
        json.dump({"instances": [
            {"obj": ball, "translate": [-1.1, 0.0, 0.0], "mask": 3},
            {"obj": "box.obj", "translate": [1.2, 0.0, 0.0],
             "rotate_y_deg": 30.0, "scale": [1.0, 0.5, 2.0]},
            {"obj": box, "transform": [[1, 0, 0, 0], [0, 1, 0, 1.6],
                                       [0, 0, 1, 0]], "mask": 0}]}, f)
    kw = dict(envmap_path=env, scene_path=str(tmp_path / "scene.obj"))
    ours = scene.load_instanced(spec, config.RenderConfig(**kw))
    _check_scene(ours, jax_scene.load_instanced(spec, jax_config.RenderConfig(**kw)))
    assert ours[1].num_real_tris == prim.make_icosphere(2, 0.9).num_tris + 12
    assert set(np.unique(ours[0].tri_mask)) == {0, 1, 3}
    _eq_tree(scene.instance_transform((1.0, 2.0, 3.0), 1.5, 20.0),
             jax_scene.instance_transform((1.0, 2.0, 3.0), 1.5, 20.0))


def _boxes(n, seed):
    """``n`` random (lo | hi) boxes."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([lo, lo + rng.uniform(0, 1, (n, 3))], 1).astype(
        np.float32)


def test_super_bounds_cover_their_clusters():
    for boxes in scene.box_levels(np.zeros((32, 6), np.float32)):
        assert boxes.shape == (0, 6)
    cb = _boxes(70, 6)
    sb, rb = scene.box_levels(cb)
    assert sb.shape == (3, 6) and sb.dtype == np.float32
    assert rb.shape == (0, 6)
    for s in range(3):
        part = cb[32 * s:32 * s + 32]
        _eq_tree(sb[s], np.concatenate([part[:, :3].min(0), part[:, 3:].max(0)]))


def test_uploader_takes_either_package_scene():
    mesh_env = (prim.make_icosphere(3, 1.2), prim.make_gradient_envmap(16, 32))
    ours = scene.scene_from_jax(scene.build_scene(*mesh_env, 8)[0], "cpu")
    ref = scene.scene_from_jax(jax_scene.build_scene(*mesh_env, 8)[0], "cpu")
    for name in (*scene.UPLOADED, "super_bounds", "root_bounds"):
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name
    assert ours.num_supers == 160 // 32 and ours.sub_tris == ref.sub_tris == 8
    assert ours.num_roots == 0


# ---- the root stage: the port's alone past 1,024 clusters ---------------

def _rows(pos):
    """Triangles as sorted rows of [A | e1 | e2], to compare as sets."""
    rows = np.concatenate([pos[:, 0], pos[:, 1] - pos[:, 0],
                           pos[:, 2] - pos[:, 0]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def test_root_bounds_cover_their_supers():
    """3,200 clusters: 100 supers under 4 roots, each root the box of its
    run of 32 supers."""
    sb, rb = scene.box_levels(_boxes(3200, 7))
    assert sb.shape == (100, 6)
    assert rb.shape == (4, 6) and rb.dtype == np.float32
    for q in range(4):
        part = sb[32 * q:32 * q + 32]
        _eq_tree(rb[q], np.concatenate([part[:, :3].min(0),
                                        part[:, 3:].max(0)]))


def test_root_stage_makes_each_run_of_32_supers_a_node_of_the_split():
    """20,480 triangles at clusters of 8: 2,560 clusters, 80 supers, 3
    roots. Each aligned run of 32 supers holds the triangles of one node
    of the root stage's split, which the three-stage order of the JAX
    package does not; the table is a permutation of the mesh."""
    mesh = prim.make_icosphere(5, 1.2)
    host, meta = scene.build_scene(mesh, prim.make_gradient_envmap(16, 32), 8)
    ts = scene.scene_from_jax(host, "cpu")
    assert (ts.num_roots, ts.num_supers, ts.num_clusters) == (3, 80, 2560)
    assert meta.num_padded_tris == mesh.num_tris
    packed = host.tri_packed
    np.testing.assert_array_equal(
        packed[np.lexsort(packed.T[::-1])], _rows(mesh.positions))
    window = scene.SUPER_CLUSTERS ** 2 * 8
    nodes = morton.median_split_order(mesh.positions, (window,))
    three = morton.median_split_order(mesh.positions, (32 * 8, 8, 8))
    apart = 0
    for q in range(ts.num_roots):
        run = slice(q * window, (q + 1) * window)
        got = packed[run][np.lexsort(packed[run].T[::-1])]
        np.testing.assert_array_equal(got, _rows(mesh.positions[nodes[run]]))
        apart += not np.array_equal(got, _rows(mesh.positions[three[run]]))
    assert apart == ts.num_roots
    # The uploaded root boxes are those of their runs of supers.
    _eq_tree(ts.root_bounds.numpy(),
             scene.box_levels(host.cluster_bounds)[1])
    for q in range(ts.num_roots):
        part = ts.super_bounds.numpy()[32 * q:32 * q + 32]
        _eq_tree(ts.root_bounds.numpy()[q],
                 np.concatenate([part[:, :3].min(0), part[:, 3:].max(0)]))


@pytest.mark.parametrize("clusters,roots,supers", [
    (32, 0, 0), (33, 0, 2), (1024, 0, 32), (1025, 2, 33), (3200, 4, 100),
    (32768, 32, 1024), (32769, 0, 1025), (51200, 0, 1600)])
def test_level_sizes_keep_roots_to_one_group_of_32(clusters, roots, supers):
    """Supers past 32 clusters, roots past 32 supers, and no roots past 32
    of them (more than 32,768 clusters), where the supers walk takes its
    supers in groups; `box_levels` and `check_scene_tables` follow."""
    assert scene.level_sizes(clusters) == (roots, supers)
    sb, rb = scene.box_levels(np.zeros((clusters, 6), np.float32))
    assert (rb.shape[0], sb.shape[0]) == (roots, supers)


@pytest.mark.parametrize("n,stages", [(8192, 3), (8193, 4)])
def test_root_stage_starts_past_1024_clusters(n, stages):
    """The first 8,192 (1,024 clusters of 8) and 8,193 triangles of a
    sphere: the order is the three-stage split, bit-equal to the JAX
    package's build, up to 1,024 clusters and the four-stage one past
    it."""
    full = prim.make_icosphere(5, 1.2)
    mesh = objmesh.MeshData(full.positions[:n], full.normals[:n],
                            full.uvs[:n])
    env = prim.make_gradient_envmap(16, 32)
    host, _ = scene.build_scene(mesh, env, 8)
    levels = (32 * 32 * 8, 32 * 8, 8, 8)[4 - stages:]
    order = morton.median_split_order(mesh.positions, levels)
    np.testing.assert_array_equal(host.tri_a[:n], mesh.positions[order, 0])
    jax_host = jax_scene.build_scene(
        jax_obj.MeshData(mesh.positions, mesh.normals, mesh.uvs), env, 8)[0]
    assert np.array_equal(host.tri_packed,
                          np.asarray(jax_host.tri_packed)) == (stages == 3)
    ts = scene.scene_from_jax(host, "cpu")
    assert ts.num_roots == (2 if stages == 4 else 0)


# ---- stats and viewer ---------------------------------------------------

def test_stats_logger_is_shared_and_frame_stats_agree():
    assert stats.log is jax_stats.log
    a, b = stats.FrameStats(window=3), jax_stats.FrameStats(window=3)
    for fs in (a, b):
        fs.times, fs.frames = [0.01, 0.02], 2
    assert a.fps == b.fps


def test_viewer_publishes_the_same_png():
    frame = np.random.default_rng(8).integers(0, 256, (6, 9, 3), np.uint8)
    servers = [viewer.FrameServer(port=0, host="127.0.0.1"),
               jax_viewer.FrameServer(port=0, host="127.0.0.1")]
    try:
        for s in servers:
            s.publish(frame, {"frame": 0})
        (a, ia), (b, ib) = (s.latest() for s in servers)
        assert a == b and ia == ib == 0
        assert servers[0].wait_frame(-1, timeout=1.0) == (a, 0)
    finally:
        for s in servers:
            s.close()
