"""The scene: built on the host in numpy, then uploaded to a torch device.

The port's copy of the host half of `refraction_tpu.scene` (``Scene``,
``SceneMeta``, ``build_scene``, ``auto_cluster_size``, ``load_scene``,
``Instance``, ``merge_meshes``, ``build_instanced_scene``,
``instance_transform``, ``load_instanced``) and the port of its
``scene_to_device`` (`scene_from_jax`).

The reference's GPU resource zoo — vertex / index upload buffers
(Mesh.cpp:55-94), the BLAS/TLAS acceleration structures
(RefractionDemo.cpp:272-361) and SRV descriptor tables
(RefractionDemo.cpp:466-511) — collapses into dense arrays:

- triangles are sorted by a cascaded median split over the traversal
  hierarchy at build time (the BLAS-build equivalent) and padded with
  degenerate triangles to a multiple of the cluster size;
- per-cluster and per-sub (``SUB_TRIS`` triangles) boxes are the
  acceleration structure; scenes of more than ``SUPER_CLUSTERS`` clusters
  get a third, coarser level of super boxes, and scenes of 33-1,024
  supers a fourth, of root boxes over runs of 32 supers (`box_levels`);
- Möller–Trumbore inputs (A, e1, e2) are precomputed once.

The host ``Scene`` holds exactly the leaves the port uploads (``UPLOADED``).
The JAX package's TPU-only layouts (``env_packed``, ``env_codes`` /
``env_lut``, ``tri_norm_vmem``, the padded ``cluster_records``) are not
built, and its build knobs (``RRT_CURVE``, ``RRT_ORDER_FROM``,
``RRT_SUBTRIS``, ``RRT_SUPER_SIZE``) are fixed at their defaults: median
order, table order, 8 triangles per sub, 32 clusters per super. With those
defaults both packages build the same leaves bit for bit
(tests/test_torch_hostcode.py) for every scene of at most
``SUPER_CLUSTERS ** 2`` clusters; past that the port's split gets a root
stage, which the JAX package does not have.

`scene_from_jax` is the one uploader: it takes the port's host scene or a
JAX-built one (numpy or JAX leaves) and copies the leaves bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from refraction_tpu_torch.bvh.clusters import build_clusters
from refraction_tpu_torch.bvh.morton import median_split_order
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.objmesh import MeshData, parse_obj
from refraction_tpu_torch.io.texture import load_texture
from refraction_tpu_torch.tracing import span

# Triangles per sub box, the traversal's finest box level.
SUB_TRIS = 8
# Clusters per super box, the coarse third level; scenes of at most this
# many clusters have none.
SUPER_CLUSTERS = 32

# Leaves uploaded by scene_from_jax, all float32 except tri_mask (int32).
UPLOADED = ("tri_a", "tri_e1", "tri_e2", "tri_packed", "tri_norm_packed",
            "cluster_bounds", "sub_bounds", "envmap", "tri_mask")


class Scene(NamedTuple):
    """Host scene (numpy), in table order."""

    tri_a: np.ndarray            # (T, 3) first vertex
    tri_e1: np.ndarray           # (T, 3) B - A
    tri_e2: np.ndarray           # (T, 3) C - A
    tri_packed: np.ndarray       # (T, 9) [A | e1 | e2]
    tri_norm_packed: np.ndarray  # (T, 9) [nA | nB-nA | nC-nA]
    cluster_bounds: np.ndarray   # (C, 6) [lo | hi]
    sub_bounds: np.ndarray       # (T/SUB_TRIS, 6) [lo | hi]
    envmap: np.ndarray           # (H, W, 3) float32 equirect environment
    tri_mask: np.ndarray         # (T,) int32 instance mask (pad tris 0)

    @property
    def num_tris(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_bounds.shape[0])


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static facts about a built scene."""

    num_real_tris: int
    num_padded_tris: int
    cluster_size: int
    scene_path: str = ""
    envmap_path: str = ""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_scene(mesh: MeshData, envmap: np.ndarray, cluster_size: int = 32,
                tri_mask: np.ndarray | None = None,
                ) -> tuple[Scene, SceneMeta]:
    """Spatially sort, pad, and precompute intersection inputs.

    ``tri_mask`` (num_tris,) int: per-triangle DXR InstanceMask bytes
    (build_instanced_scene bakes per-instance masks here; default all 1,
    the reference's instance mask); pad triangles get mask 0."""
    if cluster_size % SUB_TRIS or cluster_size < SUB_TRIS:
        raise ValueError(f"cluster_size={cluster_size} must be a multiple of "
                         f"SUB_TRIS={SUB_TRIS}")
    t_real = mesh.num_tris
    # Cascaded median split over (super, cluster, sub) windows, so that
    # supers, clusters and subs are each kd-style nodes of their own split
    # (the JAX package's default RRT_CURVE=median). Past SUPER_CLUSTERS**2
    # clusters a root stage comes first, so that each aligned run of 32
    # supers (a root box, `box_levels`) is a node of the split too.
    levels = (SUPER_CLUSTERS * cluster_size, cluster_size, SUB_TRIS)
    if -(-t_real // cluster_size) > SUPER_CLUSTERS ** 2:
        levels = (SUPER_CLUSTERS * levels[0], *levels)
    order = median_split_order(mesh.positions, levels)
    pos = mesh.positions[order]
    norm = mesh.normals[order]
    if tri_mask is None:
        tri_mask = np.ones(t_real, np.int32)
    mask = np.asarray(tri_mask, np.int32)[order]

    t_pad = max(_round_up(max(t_real, 1), cluster_size), cluster_size)
    if t_pad > t_real:
        # Degenerate padding: repeat the last real triangle's first vertex as
        # all three corners -> zero-area, never intersected (det == 0), and
        # a point inside the final cluster so its box stays tight.
        pad_pt = pos[-1, 0] if t_real > 0 else np.zeros(3, np.float32)
        pad_pos = np.broadcast_to(pad_pt, (t_pad - t_real, 3, 3)).copy()
        pad_norm = np.broadcast_to(
            np.array([0, 1, 0], np.float32), (t_pad - t_real, 3, 3)).copy()
        pos = np.concatenate([pos, pad_pos])
        norm = np.concatenate([norm, pad_norm])
        mask = np.concatenate([mask, np.zeros(t_pad - t_real, np.int32)])

    lo, hi = build_clusters(pos, cluster_size)
    sub_lo, sub_hi = build_clusters(pos, SUB_TRIS)
    tri_a = np.ascontiguousarray(pos[:, 0])
    tri_e1 = np.ascontiguousarray(pos[:, 1] - pos[:, 0])
    tri_e2 = np.ascontiguousarray(pos[:, 2] - pos[:, 0])
    scene = Scene(
        tri_a=tri_a,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_packed=np.ascontiguousarray(
            np.concatenate([tri_a, tri_e1, tri_e2], axis=1)),
        tri_norm_packed=np.ascontiguousarray(np.concatenate(
            [norm[:, 0], norm[:, 1] - norm[:, 0], norm[:, 2] - norm[:, 0]],
            axis=1)),
        cluster_bounds=np.ascontiguousarray(np.concatenate([lo, hi], axis=1)),
        sub_bounds=np.ascontiguousarray(
            np.concatenate([sub_lo, sub_hi], axis=1)),
        envmap=np.ascontiguousarray(envmap, dtype=np.float32),
        tri_mask=np.ascontiguousarray(mask),
    )
    meta = SceneMeta(num_real_tris=t_real, num_padded_tris=t_pad,
                     cluster_size=cluster_size)
    return scene, meta


def auto_cluster_size(num_tris: int) -> int:
    """Cluster size per scene from its triangle count: 1,024 up to 1,100
    triangles, 128 up to 32,768, 512 past that.

    Up to 8,192 and past 32,768 triangles these are the JAX package's
    values (chosen there by sweeps on a TPU), so both packages build the
    same tables. From 8,193 to 32,768 the JAX package takes 1,024: at most
    32 clusters of 128 subs, which the H100's frame kernel walks flat,
    testing every cluster box and then every sub box of a cluster crossed
    in table order. At 128 every count of that band has 65-256 clusters
    of 16 subs, so the tables get super boxes and the kernel walks
    supers, clusters and subs near to far; the card's sweep put 128 ahead
    of 256, 512 and 1,024 there (PERF.md §6)."""
    if num_tris <= 1100:
        return 1024
    if num_tris <= 32768:
        return 128
    return 512


def load_scene(cfg: RenderConfig) -> tuple[Scene, SceneMeta]:
    """Load scene + envmap from cfg paths (the `initialize` asset ingest,
    RefractionDemo.cpp:527,537-538)."""
    mesh = parse_obj(cfg.scene_path)
    envmap = load_texture(cfg.envmap_path)
    cs = cfg.cluster_size or auto_cluster_size(mesh.num_tris)
    scene, meta = build_scene(mesh, envmap, cs)
    meta = dataclasses.replace(
        meta, scene_path=cfg.scene_path, envmap_path=cfg.envmap_path)
    return scene, meta


@dataclasses.dataclass(frozen=True)
class Instance:
    """One TLAS instance — the D3D12_RAYTRACING_INSTANCE_DESC equivalent
    (RefractionDemo.cpp:325-335: 3x4 row-major object->world ``Transform``,
    ``InstanceMask``). The reference builds exactly one instance with the
    identity transform and mask 1; N instances are *baked* into world
    space at scene build. An instance is visible to a ray iff ``mask &
    InstanceInclusionMask != 0`` (RayTracing.hlsl:60,106,121); masks are
    baked per triangle (``Scene.tri_mask``) and mask-0 instances are dropped
    at build."""

    mesh: MeshData
    transform: np.ndarray | None = None  # (3, 4) row-major; None = identity
    mask: int = 1


def _transform_mesh(mesh: MeshData, transform: np.ndarray) -> MeshData:
    """Bake a 3x4 object->world transform: positions affinely, shading
    normals by the inverse-transpose of the linear part (correct under
    non-uniform scale; the shader re-normalizes after barycentric lerp,
    RayTracing.hlsl:83-86, so lengths don't matter)."""
    m = np.asarray(transform, np.float32)
    if m.shape != (3, 4):
        raise ValueError(f"instance transform must be (3, 4), got {m.shape}")
    lin, t = m[:, :3], m[:, 3]
    _check_transform(lin)
    nrm_m = np.linalg.inv(lin).T.astype(np.float32)
    return MeshData(
        positions=(mesh.positions @ lin.T + t).astype(np.float32),
        normals=(mesh.normals @ nrm_m.T).astype(np.float32),
        uvs=mesh.uvs,
    )


def merge_meshes(meshes: list[MeshData]) -> MeshData:
    if not meshes:
        raise ValueError("no meshes to merge")
    return MeshData(
        positions=np.concatenate([m.positions for m in meshes]),
        normals=np.concatenate([m.normals for m in meshes]),
        uvs=np.concatenate([m.uvs for m in meshes]),
    )


# Tiles of a two-level scene's instance tables (csrc/traverse_f2b.cuh
# RT_INST_XFORM, RT_INST_INFO): per instance, float32 [world->object 3x4 |
# normal 3x3], and int32 [tri, cluster, sub, super offsets of its BLAS in
# the concatenated tables | n_supers | n_clusters | subs a cluster | key
# base | 1 where the transform mirrors].
INST_XFORM = 21
INST_INFO = 9
# Relative pad of a world instance box: sqrt of float32's epsilon times
# the box's largest coordinate or extent, so the box holds every point the
# object-space walk can hit in it, through the ray's transform's rounding.
_INST_PAD = float(np.sqrt(np.finfo(np.float32).eps))


def _check_transform(lin: np.ndarray) -> None:
    if abs(float(np.linalg.det(lin))) < 1e-12:
        raise ValueError("instance transform is singular")


def _bake(instances, envmap: np.ndarray, cluster_size: int | None) -> Scene:
    """The single-mesh scene of ``instances`` (all visible): each baked
    into world space (`_transform_mesh`), merged, masks per triangle, and
    split as one mesh by `build_scene`."""
    baked = [
        i.mesh if i.transform is None else _transform_mesh(i.mesh, i.transform)
        for i in instances
    ]
    merged = merge_meshes(baked)
    tri_mask = np.concatenate([
        np.full(i.mesh.num_tris, np.int32(i.mask & 0xFF)) for i in instances
    ]).astype(np.int32)
    cs = cluster_size or auto_cluster_size(merged.num_tris)
    return build_scene(merged, envmap, cs, tri_mask=tri_mask)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class InstancedScene:
    """Host two-level scene (numpy): the TLAS of instances over shared
    BLASes (RefractionDemo.cpp:272-361 builds one of each).

    ``blas`` holds one `build_scene` table set per distinct `MeshData`
    (by identity, in first use order), each at its own
    `auto_cluster_size` (or the ``cluster_size`` given to
    `build_instanced_scene`). The per-instance arrays list the visible
    instances in spec order; ``inst_order`` is the instance table's order
    (a median split of their boxes, so each aligned run of 32 is a node
    that a root box bounds). `baked` gives the single-mesh scene of the
    same instances, as `build_instanced_scene` built it before it kept two
    levels, for the paths that walk one mesh."""

    blas: tuple                  # (Scene, ...) in first use order
    inst_blas: np.ndarray        # (I,) int32 each instance's BLAS
    object_to_world: np.ndarray  # (I, 3, 4) float32
    world_to_object: np.ndarray  # (I, 3, 4) float32
    normal_matrix: np.ndarray    # (I, 3, 3) float32 inverse-transpose
    inst_bounds: np.ndarray      # (I, 6) padded world boxes [lo | hi]
    inst_mask: np.ndarray        # (I,) int32 InstanceMask & 0xFF
    inst_order: np.ndarray       # (I,) int64 spec index of table slot j
    envmap: np.ndarray           # (H, W, 3) float32
    instances: tuple             # the visible Instances, for the bake
    bake_cluster_size: int | None = None

    @property
    def num_instances(self) -> int:
        return int(self.inst_blas.shape[0])

    @functools.cached_property
    def _baked(self) -> Scene:
        return _bake(self.instances, self.envmap, self.bake_cluster_size)

    def baked(self) -> Scene:
        """The single-mesh scene of the visible instances (built at the
        first call): bit for bit what `build_instanced_scene` returned
        while it baked every instance."""
        return self._baked


def _blas_points(blas: Scene) -> np.ndarray:
    """(P, 3) float64: the distinct corners of a BLAS's triangles, as its
    table holds them (A, A + e1, A + e2)."""
    a = blas.tri_a.astype(np.float64)
    pts = np.concatenate([a, a + blas.tri_e1, a + blas.tri_e2])
    return np.unique(pts, axis=0)


def build_instanced_scene(instances: list[Instance], envmap: np.ndarray,
                          cluster_size: int | None = None,
                          ) -> tuple[InstancedScene, SceneMeta]:
    """Build the two-level scene of N instances: one BLAS a distinct mesh,
    and over them the visible instances' transforms, world boxes and
    table order (`InstancedScene`). Mask-0 instances are dropped. The
    meta is the baked scene's (placed triangles, padded to the bake's
    cluster size ``cluster_size or auto_cluster_size(placed)``)."""
    with span("rt.scene.instances"):
        visible = [i for i in instances if i.mask & 0xFF]
        if not visible:
            raise ValueError("all instances are masked out "
                             "(mask & 0xff == 0)")
        index: dict[int, int] = {}
        blas = []
        for i in visible:
            if id(i.mesh) not in index:
                index[id(i.mesh)] = len(blas)
                cs = cluster_size or auto_cluster_size(i.mesh.num_tris)
                blas.append(build_scene(i.mesh, envmap, cs)[0])
        corners = [_blas_points(b) for b in blas]
        o2w, w2o, nrm, boxes = [], [], [], []
        for i in visible:
            m = (np.eye(3, 4, dtype=np.float32) if i.transform is None
                 else np.asarray(i.transform, np.float32))
            if m.shape != (3, 4):
                raise ValueError(
                    f"instance transform must be (3, 4), got {m.shape}")
            lin, t = m[:, :3], m[:, 3]
            _check_transform(lin)
            inv = np.linalg.inv(lin.astype(np.float64))
            o2w.append(m)
            w2o.append(np.concatenate([inv, -inv @ t[:, None]], axis=1))
            # As _transform_mesh computes the bake's normal matrix.
            nrm.append(np.linalg.inv(lin).T.astype(np.float32))
            p = corners[index[id(i.mesh)]] @ lin.T.astype(np.float64) + t
            lo, hi = p.min(axis=0), p.max(axis=0)
            pad = _INST_PAD * max(float(np.abs(p).max()),
                                  float((hi - lo).max()), 1e-30)
            boxes.append(np.concatenate([
                np.nextafter((lo - pad).astype(np.float32), -np.inf),
                np.nextafter((hi + pad).astype(np.float32), np.inf)]))
        bounds = np.stack(boxes).astype(np.float32)
        n = len(visible)
        levels = (SUPER_CLUSTERS,)
        if n > SUPER_CLUSTERS ** 2:
            levels = (SUPER_CLUSTERS ** 2, SUPER_CLUSTERS)
        order = median_split_order(bounds.reshape(n, 2, 3), levels)
        host = InstancedScene(
            blas=tuple(blas),
            inst_blas=np.array([index[id(i.mesh)] for i in visible],
                               np.int32),
            object_to_world=np.stack(o2w),
            world_to_object=np.stack(w2o).astype(np.float32),
            normal_matrix=np.stack(nrm),
            inst_bounds=bounds,
            inst_mask=np.array([i.mask & 0xFF for i in visible], np.int32),
            inst_order=np.asarray(order, np.int64),
            envmap=np.ascontiguousarray(envmap, dtype=np.float32),
            instances=tuple(visible),
            bake_cluster_size=cluster_size)
        placed = sum(i.mesh.num_tris for i in visible)
        cs = cluster_size or auto_cluster_size(placed)
        meta = SceneMeta(num_real_tris=placed,
                         num_padded_tris=max(_round_up(max(placed, 1), cs),
                                             cs),
                         cluster_size=cs)
    return host, meta


def instance_transform(translate=(0.0, 0.0, 0.0), scale=1.0,
                       rotate_y_deg=0.0) -> np.ndarray:
    """Convenience 3x4 composer (scale, then rotate about +Y, then
    translate) for CLI/instance specs."""
    s = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    c, sn = np.cos(np.radians(rotate_y_deg)), np.sin(np.radians(rotate_y_deg))
    rot = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]], np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * s[None, :]
    m[:, 3] = np.asarray(translate, np.float32)
    return m


def load_instanced(spec_path: str, cfg: RenderConfig,
                   ) -> tuple[InstancedScene, SceneMeta]:
    """Load an instanced scene from a JSON spec (the CLI ``--instances``
    format): a list (or {"instances": [...]}) of entries
    ``{"obj": path, "translate": [x,y,z], "scale": s | [sx,sy,sz],
    "rotate_y_deg": deg, "mask": m}`` — or an explicit
    ``"transform": 3x4`` row-major matrix instead of the convenience
    fields. OBJ paths resolve like ``--scene``: as given, else under the
    asset dir of ``cfg.scene_path``."""
    with open(spec_path) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        spec = spec["instances"]
    if not isinstance(spec, list) or not spec:
        raise ValueError(f"{spec_path}: expected a non-empty instance list")
    asset_dir = os.path.dirname(cfg.scene_path)
    meshes: dict[str, MeshData] = {}
    instances = []
    for ent in spec:
        path = ent["obj"]
        if not os.path.exists(path):
            path = os.path.join(asset_dir, ent["obj"])
        if path not in meshes:
            meshes[path] = parse_obj(path)
        if "transform" in ent:
            m = np.asarray(ent["transform"], np.float32)
        else:
            m = instance_transform(
                translate=ent.get("translate", (0.0, 0.0, 0.0)),
                scale=ent.get("scale", 1.0),
                rotate_y_deg=ent.get("rotate_y_deg", 0.0))
        instances.append(
            Instance(meshes[path], m, mask=int(ent.get("mask", 1))))
    envmap = load_texture(cfg.envmap_path)
    scene, meta = build_instanced_scene(instances, envmap, cfg.cluster_size)
    meta = dataclasses.replace(
        meta, scene_path=spec_path, envmap_path=cfg.envmap_path)
    return scene, meta


def box_runs(n: int) -> int:
    """Boxes over consecutive runs of SUPER_CLUSTERS of ``n`` boxes one
    level down (the last run may be shorter): none for at most one run,
    where one box would bound everything."""
    return -(-n // SUPER_CLUSTERS) if n > SUPER_CLUSTERS else 0


def level_sizes(num_clusters: int) -> tuple[int, int]:
    """(roots, supers): the box levels over ``num_clusters`` clusters.
    Supers bound runs of SUPER_CLUSTERS clusters, roots runs of
    SUPER_CLUSTERS supers. Past SUPER_CLUSTERS roots (more than 32,768
    clusters) there are none: the roots walk picks its roots in one
    near-to-far group, and such scenes walk their supers in groups of 32."""
    supers = box_runs(num_clusters)
    roots = box_runs(supers)
    return (roots if roots <= SUPER_CLUSTERS else 0), supers


def _run_bounds(boxes: np.ndarray, n: int) -> np.ndarray:
    """(n, 6) [lo | hi] boxes of the first ``n`` runs of SUPER_CLUSTERS
    of ``boxes``."""
    starts = np.arange(n) * SUPER_CLUSTERS
    lo = np.minimum.reduceat(boxes[:, :3], starts, axis=0)
    hi = np.maximum.reduceat(boxes[:, 3:], starts, axis=0)
    return np.ascontiguousarray(
        np.concatenate([lo, hi], axis=1).reshape(n, 6), np.float32)


def box_levels(cluster_bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(supers, roots): (S, 6) and (R, 6) [lo | hi] boxes over the cluster
    boxes, in the sizes `level_sizes` gives. The median-split build makes
    each run of clusters, and past SUPER_CLUSTERS**2 clusters each run of
    supers, a spatial node of its own."""
    cb = np.asarray(cluster_bounds, np.float32)
    n_roots, n_supers = level_sizes(cb.shape[0])
    supers = _run_bounds(cb, n_supers)
    return supers, _run_bounds(supers, n_roots)


class TorchScene(NamedTuple):
    """Scene tables on one device, in the host scene's table order."""

    tri_a: torch.Tensor            # (T, 3) first vertex
    tri_e1: torch.Tensor           # (T, 3) B - A
    tri_e2: torch.Tensor           # (T, 3) C - A
    tri_packed: torch.Tensor       # (T, 9) [A | e1 | e2]
    tri_norm_packed: torch.Tensor  # (T, 9) [nA | nB-nA | nC-nA]
    cluster_bounds: torch.Tensor   # (C, 6) [lo | hi]; cluster c = tris [c*cs, (c+1)*cs)
    sub_bounds: torch.Tensor       # (T/sub_tris, 6) [lo | hi]
    envmap: torch.Tensor           # (H, W, 3) equirect map
    tri_mask: torch.Tensor | None  # (T,) int32 instance mask (pad tris 0)
    super_bounds: torch.Tensor     # (S, 6) [lo | hi]; super s = clusters [s*32, (s+1)*32)
    root_bounds: torch.Tensor      # (R, 6) [lo | hi]; root q = supers [q*32, (q+1)*32)
    sub_tris: int                  # triangles per sub box

    @property
    def num_tris(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_bounds.shape[0])

    @property
    def num_supers(self) -> int:
        return int(self.super_bounds.shape[0])

    @property
    def num_roots(self) -> int:
        return int(self.root_bounds.shape[0])

    @property
    def cluster_size(self) -> int:
        return self.num_tris // self.num_clusters

    @property
    def device(self) -> torch.device:
        return self.tri_a.device

    # The instance level rt_frame takes (`InstancedTorchScene`): none.
    inst_bounds = inst_roots = inst_xform = inst_info = None
    num_instances = num_inst_roots = 0

    def baked(self) -> TorchScene:
        """The single-mesh scene that the paths which walk one mesh
        render: this one (`InstancedTorchScene.baked` the bake of a
        two-level scene)."""
        return self


class InstancedTorchScene:
    """A two-level scene on one device: every BLAS's tables, concatenated
    BLAS after BLAS, and the instance tables in table order, which the
    frame kernel's instance walk reads (csrc/traverse_f2b.cuh
    RT_WALK_INSTANCES). Each BLAS has at least one super box (one over
    all its clusters where `level_sizes` gives none), since the walk takes
    RT_WALK_SUPERS below an instance.

    The BLAS tables carry `TorchScene`'s names, and its single-mesh
    counts are 0: rt_frame takes the instance walk where it is given
    instances and no supers or roots of the scene's own, and the walk reads
    each BLAS's counts from ``inst_info``.

    `baked` uploads the host scene's single-mesh bake at its first call
    (and keeps it), for the paths that walk one mesh; the instance walk
    never calls it."""

    sub_tris = SUB_TRIS
    num_roots = num_supers = num_clusters = cluster_size = 0

    def __init__(self, host: InstancedScene, device):
        put = functools.partial(torch.tensor, device=device)
        blas = host.blas
        supers = [box_levels(b.cluster_bounds)[0] for b in blas]
        supers = [s if s.shape[0] else _run_bounds(b.cluster_bounds, 1)
                  for s, b in zip(supers, blas)]
        counts = np.array([[b.num_tris, b.num_clusters,
                            b.sub_bounds.shape[0], s.shape[0]]
                           for b, s in zip(blas, supers)], np.int64)
        offsets = np.cumsum(counts, axis=0) - counts  # tri, cluster, sub, super
        self.tri_packed = put(np.concatenate([b.tri_packed for b in blas]))
        self.tri_norm_packed = put(np.concatenate([b.tri_norm_packed
                                                   for b in blas]))
        self.cluster_bounds = put(np.concatenate([b.cluster_bounds
                                                  for b in blas]))
        self.sub_bounds = put(np.concatenate([b.sub_bounds for b in blas]))
        self.super_bounds = put(np.concatenate(supers))
        self.root_bounds = put(np.zeros((0, 6), np.float32))
        # (supers, clusters, subs a cluster, tris) of each BLAS.
        self.blas_levels = tuple(
            (int(c[3]), int(c[1]), int(c[2] // c[1]), int(c[0]))
            for c in counts)
        order = host.inst_order
        which = host.inst_blas[order]
        # Key base of each instance (spec order): its first triangle's
        # index in the BLAS tables laid out instance after instance, so
        # that (instance, triangle) pairs order as keys.
        sizes = counts[host.inst_blas, 0]
        self.key_bases = np.cumsum(sizes) - sizes
        if self.key_bases[-1] + sizes[-1] > np.iinfo(np.int32).max:
            raise ValueError("the placed triangles overflow the int32 keys")
        flip = np.linalg.det(host.object_to_world[:, :, :3]
                             .astype(np.float64)) < 0
        info = np.concatenate([
            offsets[which], counts[which][:, 3:4], counts[which][:, 1:2],
            (counts[which][:, 2] // counts[which][:, 1])[:, None],
            self.key_bases[order][:, None], flip[order][:, None]], axis=1)
        # The host copy, for the launch checks and the plain versions.
        self.inst_info_host = info.astype(np.int64)
        self.inst_info = put(info.astype(np.int32))
        self.inst_xform = put(np.concatenate([
            host.world_to_object.reshape(-1, 12),
            host.normal_matrix.reshape(-1, 9)], axis=1)[order])
        self.inst_bounds = put(host.inst_bounds[order])
        n_roots = box_runs(host.num_instances)
        self.inst_roots = put(_run_bounds(host.inst_bounds[order], n_roots))
        self.envmap = put(np.asarray(host.envmap, np.float32))
        self.host = host
        self.checked: set = set()  # devices the launch checks passed on
        self._baked: TorchScene | None = None

    @property
    def num_instances(self) -> int:
        return int(self.inst_bounds.shape[0])

    @property
    def num_inst_roots(self) -> int:
        return int(self.inst_roots.shape[0])

    def owners(self, keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(instance in spec order, triangle in its BLAS's table) of each
        winner's key (the instance walk's idx; -1 on a miss gives -1,
        -1)."""
        base = torch.as_tensor(self.key_bases, device=keys.device)
        k = keys.to(torch.int64)
        inst = torch.searchsorted(base, k, right=True) - 1
        tri = k - base[inst.clamp_min(0)]
        miss = k < 0
        return inst.masked_fill(miss, -1), tri.masked_fill(miss, -1)

    @property
    def device(self) -> torch.device:
        return self.envmap.device

    def baked(self) -> TorchScene:
        """The host scene's bake on this device (uploaded once)."""
        if self._baked is None:
            self._baked = scene_from_jax(self.host.baked(), self.device)
        return self._baked


def scene_from_jax(scene, device: torch.device | str):
    """Upload a host scene — the port's `Scene` or a
    `refraction_tpu.scene.Scene` with numpy or JAX leaves — to ``device``.
    Values are copied bit for bit; a scene built by hand without
    ``tri_mask`` keeps None there. The super and root boxes are built
    here, on the host, from ``cluster_bounds``. A two-level
    `InstancedScene` gives its `InstancedTorchScene`."""
    if isinstance(scene, InstancedScene):
        return InstancedTorchScene(scene, device)

    def put(name, dtype):
        leaf = getattr(scene, name)
        if leaf is None and name == "tri_mask":
            return None
        # torch.tensor copies: JAX hands out read-only host buffers.
        return torch.tensor(np.asarray(leaf, dtype), device=device)

    leaves = {name: put(name, np.int32 if name == "tri_mask" else np.float32)
              for name in UPLOADED}
    supers, roots = box_levels(scene.cluster_bounds)
    n_tris = leaves["tri_a"].shape[0]
    return TorchScene(**leaves,
                      super_bounds=torch.from_numpy(supers).to(device),
                      root_bounds=torch.from_numpy(roots).to(device),
                      sub_tris=n_tris // max(leaves["sub_bounds"].shape[0], 1))
