"""The benchmark's inputs, made from ``--seed`` by frozen generators.

The same mesh, map and start angle go to the program and to the plain
reference. These generators are copies, frozen here so that a change to
the program cannot move the yardstick:

- `make_icosphere`: copied from refraction_tpu_torch/io/primitives.py
  (`make_icosphere`, itself a copy of refraction_tpu/io/primitives.py);
- `nested_shell`: the ``ref_demo`` stand-in for the upstream's
  shell.obj, an outer icosphere and an inward-wound inner one;
- `make_env`: a seeded, textured equirect map (the upstream's
  envMap.hdr is not in the repository);
- `start_angle`: the orbit's first angle;
- `make_instances`: a configuration's ``scene`` of placed instances, in
  the port's ``--instances`` format with each OBJ path replaced by a
  named mesh of `make_mesh`; `instance_transform` composes its matrices
  (a copy of refraction_tpu_torch/scene.py's convention: scale, then a
  rotation about +Y, then a translation);
- `bake_instances`: the reference's own bake of those instances into
  world space.

Neither the seed nor the map changes the cost of a frame much, so the
cells stay comparable across seeds.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Purposes of the seeded numpy streams, so that each draw is independent.
STREAM_ANGLE, STREAM_PIXELS, STREAM_FRAMES = 1, 2, 3
# Octaves of the env map's value noise: (rows, columns, amplitude) of the
# random grid that is upsampled bilinearly to the map's size. The finest
# grid puts a new value every 4 texels of a 1024x2048 map, so misses that
# land on neighbouring texels read different values.
ENV_OCTAVES = ((4, 8, 0.6), (16, 32, 0.35), (64, 128, 0.25), (256, 512, 0.2))


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def start_angle(seed: int) -> float:
    """The orbit's first angle, uniform in [0, 2 pi)."""
    return float(rng(seed, STREAM_ANGLE).uniform(0.0, 2.0 * math.pi))


def make_icosphere(subdiv: int, radius: float):
    """Subdivided icosahedron, CCW outward, smooth (spherical) normals:
    (positions (T, 3, 3), normals (T, 3, 3), uvs (T, 3, 2)) float32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        tris = v[faces]
        mid = np.concatenate([
            (tris[:, 0] + tris[:, 1]) / 2,
            (tris[:, 1] + tris[:, 2]) / 2,
            (tris[:, 2] + tris[:, 0]) / 2,
        ])
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        f = faces.shape[0]
        base = v.shape[0]
        m01 = base + np.arange(f)
        m12 = base + f + np.arange(f)
        m20 = base + 2 * f + np.arange(f)
        v = np.concatenate([v, mid])
        faces = np.concatenate([
            np.stack([faces[:, 0], m01, m20], 1),
            np.stack([faces[:, 1], m12, m01], 1),
            np.stack([faces[:, 2], m20, m12], 1),
            np.stack([m01, m12, m20], 1),
        ])
    pos = (v[faces] * radius).astype(np.float32)
    norm = v[faces].astype(np.float32)
    uv = np.stack([
        (np.arctan2(v[faces][..., 0], v[faces][..., 2]) / np.pi + 1) / 2,
        np.arccos(np.clip(v[faces][..., 1], -1, 1)) / np.pi,
    ], axis=-1).astype(np.float32)
    return pos, norm, uv


def inward(mesh):
    """``mesh`` wound the other way round with its normals reversed: the
    inner wall of a solid shell, whose outside faces the hollow."""
    pos, norm, uv = mesh
    flip = [0, 2, 1]
    return (np.ascontiguousarray(pos[:, flip]),
            np.ascontiguousarray(-norm[:, flip]),
            np.ascontiguousarray(uv[:, flip]))


def nested_shell(outer_subdiv: int, outer_radius: float, inner_subdiv: int,
                 inner_radius: float):
    """A glass shell: an outward icosphere around an inward-wound one, so
    that a ray inside the glass meets the inner wall from its back."""
    outer = make_icosphere(outer_subdiv, outer_radius)
    inner = inward(make_icosphere(inner_subdiv, inner_radius))
    return tuple(np.concatenate([a, b]) for a, b in zip(outer, inner))


def make_mesh(spec: dict):
    """The mesh a configuration's ``mesh`` entry names:
    ``{"kind": "icosphere", "subdiv", "radius"}`` or
    ``{"kind": "nested_shell", "outer_subdiv", "outer_radius",
    "inner_subdiv", "inner_radius"}``."""
    kind = spec["kind"]
    if kind == "icosphere":
        return make_icosphere(spec["subdiv"], spec["radius"])
    if kind == "nested_shell":
        return nested_shell(spec["outer_subdiv"], spec["outer_radius"],
                            spec["inner_subdiv"], spec["inner_radius"])
    raise ValueError(f"unknown mesh kind {kind!r}")


def make_env(seed: int, height: int, width: int,
             device: torch.device) -> torch.Tensor:
    """(height, width, 3) float32 equirect map on ``device`` from ``seed``:
    value noise over four octaves, in [0.1, 1.6] (over 1 where the display
    clamps), made by a generator on ``device`` in one call an octave."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    env = torch.full((1, 3, height, width), 0.1, dtype=torch.float32,
                     device=device)
    for rows, cols, amp in ENV_OCTAVES:
        grid = torch.rand((1, 3, min(rows, height), min(cols, width)),
                          generator=gen, device=device, dtype=torch.float32)
        env += amp * F.interpolate(grid, size=(height, width),
                                   mode="bilinear", align_corners=False)
    return env[0].permute(1, 2, 0).contiguous()


def instance_transform(translate=(0.0, 0.0, 0.0), scale=1.0,
                       rotate_y_deg=0.0) -> np.ndarray:
    """(3, 4) float32 row-major object-to-world matrix: scale (a number or
    three), then a rotation about +Y, then a translation."""
    s = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    c, sn = np.cos(np.radians(rotate_y_deg)), np.sin(np.radians(rotate_y_deg))
    rot = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]], np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * s[None, :]
    m[:, 3] = np.asarray(translate, np.float32)
    return m


INSTANCE_KEYS = {"mesh", "translate", "scale", "rotate_y_deg", "transform",
                 "mask"}
PLACEMENT_KEYS = {"translate", "scale", "rotate_y_deg"}


def make_instances(spec: dict):
    """The meshes and instances a configuration's ``scene`` entry names:
    ``{"kind": "instances", "meshes": {name: make_mesh spec},
    "instances": [{"mesh": name, "translate": [x, y, z], "scale": s or
    [sx, sy, sz], "rotate_y_deg": d, "mask": m}, ...]}``, where an entry
    may give ``"transform"`` (3x4, row-major) in place of the placement
    fields. Returns ({name: (positions, normals, uvs)}, [(name, (3, 4)
    float32 matrix, mask)]), each named mesh made once. Raises on an
    unknown kind, mesh name or key, a transform that is not 3x4 or is
    singular in float32, and a scene whose every instance is masked out
    (mask & 0xFF == 0), which no ray could see."""
    if spec.get("kind") != "instances":
        raise ValueError(f"unknown scene kind {spec.get('kind')!r}")
    named = spec.get("meshes")
    if not isinstance(named, dict) or not named:
        raise ValueError("scene: 'meshes' must name at least one mesh")
    entries = spec.get("instances")
    if not isinstance(entries, list) or not entries:
        raise ValueError("scene: 'instances' must list at least one instance")
    placed = []
    for k, ent in enumerate(entries):
        extra = set(ent) - INSTANCE_KEYS
        if extra:
            raise ValueError(f"instance {k}: unknown keys {sorted(extra)}")
        if ent.get("mesh") not in named:
            raise ValueError(f"instance {k}: unknown mesh {ent.get('mesh')!r} "
                             f"(have {', '.join(sorted(named))})")
        if "transform" in ent:
            if set(ent) & PLACEMENT_KEYS:
                raise ValueError(f"instance {k}: 'transform' and "
                                 f"{sorted(set(ent) & PLACEMENT_KEYS)} both")
            m = np.asarray(ent["transform"], np.float32)
        else:
            m = instance_transform(ent.get("translate", (0.0, 0.0, 0.0)),
                                   ent.get("scale", 1.0),
                                   ent.get("rotate_y_deg", 0.0))
        if m.shape != (3, 4) or not np.isfinite(m).all():
            raise ValueError(f"instance {k}: transform must be 3x4 and "
                             f"finite, got {m.shape}")
        sv = np.linalg.svd(m[:, :3].astype(np.float64), compute_uv=False)
        if not sv[-1] > sv[0] * np.finfo(np.float32).eps * 16:
            raise ValueError(f"instance {k}: transform is singular "
                             f"(singular values {sv.tolist()})")
        placed.append((ent["mesh"], m, int(ent.get("mask", 1))))
    if not any(mask & 0xFF for _, _, mask in placed):
        raise ValueError("scene: every instance is masked out "
                         "(mask & 0xff == 0)")
    return {name: make_mesh(s) for name, s in named.items()}, placed


def bake_instances(meshes: dict, instances: list):
    """The reference's world-space scene of `make_instances`' output:
    (positions (T, 3, 3), normals (T, 3, 3)) float32, (I, 2) int64 ranges
    of global triangle indices and (I, 2, 3) float32 world boxes, one a
    visible instance, in the order listed. Masked-out instances (mask &
    0xFF == 0; the rays' InstanceInclusionMask is 0xFF, RayTracing.hlsl:
    60,106,121) are left out. Positions go through the affine map and
    normals through the inverse transpose of its linear part, in float64
    before the cast; normals are not renormalised (the shader normalises
    after the lerp, hlsl:83-86)."""
    pos, nrm, ranges, boxes = [], [], [], []
    start = 0
    for name, m, mask in instances:
        if not mask & 0xFF:
            continue
        lin = m[:, :3].astype(np.float64)
        p = (meshes[name][0].astype(np.float64) @ lin.T
             + m[:, 3].astype(np.float64)).astype(np.float32)
        n = (meshes[name][1].astype(np.float64)
             @ np.linalg.inv(lin)).astype(np.float32)
        pos.append(p)
        nrm.append(n)
        ranges.append((start, start + p.shape[0]))
        boxes.append((p.min(axis=(0, 1)), p.max(axis=(0, 1))))
        start += p.shape[0]
    return (np.concatenate(pos), np.concatenate(nrm),
            np.asarray(ranges, np.int64), np.asarray(boxes, np.float32))


def visible_counts(meshes: dict, instances: list) -> tuple[int, int]:
    """(unique triangles, visible instances) of a scene of instances: the
    triangles of each named mesh that a visible instance places, counted
    once, and the instances with mask & 0xFF != 0."""
    shown = [name for name, _, mask in instances if mask & 0xFF]
    return (sum(meshes[name][0].shape[0] for name in set(shown)),
            len(shown))
