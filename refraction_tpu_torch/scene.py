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
    if abs(float(np.linalg.det(lin))) < 1e-12:
        raise ValueError("instance transform is singular")
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


def build_instanced_scene(instances: list[Instance], envmap: np.ndarray,
                          cluster_size: int | None = None,
                          ) -> tuple[Scene, SceneMeta]:
    """Build one scene from N instances: the baked world-space triangles
    of all visible instances are merged and sorted together, so traversal
    is exactly the single-mesh path."""
    visible = [i for i in instances if i.mask & 0xFF]
    if not visible:
        raise ValueError("all instances are masked out (mask & 0xff == 0)")
    baked = [
        i.mesh if i.transform is None else _transform_mesh(i.mesh, i.transform)
        for i in visible
    ]
    merged = merge_meshes(baked)
    tri_mask = np.concatenate([
        np.full(i.mesh.num_tris, np.int32(i.mask & 0xFF)) for i in visible
    ]).astype(np.int32)
    cs = cluster_size or auto_cluster_size(merged.num_tris)
    return build_scene(merged, envmap, cs, tri_mask=tri_mask)


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


def load_instanced(spec_path: str, cfg: RenderConfig) -> tuple[Scene, SceneMeta]:
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


def scene_from_jax(scene, device: torch.device | str) -> TorchScene:
    """Upload a host scene — the port's `Scene` or a
    `refraction_tpu.scene.Scene` with numpy or JAX leaves — to ``device``.
    Values are copied bit for bit; a scene built by hand without
    ``tri_mask`` keeps None there. The super and root boxes are built
    here, on the host, from ``cluster_bounds``."""

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
