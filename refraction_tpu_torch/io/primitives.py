"""Procedural test fixtures: meshes and environment maps.

The reference ships binary OBJ/PNG assets we deliberately do not copy; tests
use these generators (geometry chosen to exercise the same code paths:
closed watertight dielectrics with outward CCW winding and smooth or faceted
vertex normals, like the Blender-exported fixtures in SURVEY.md 2.3).

The port's copy of `refraction_tpu.io.primitives`, pure Python as the original
(the JAX package's optional C++ accelerator, `io/native.py`, is not
copied into the port).
"""

from __future__ import annotations

import numpy as np

from refraction_tpu_torch.io.objmesh import MeshData


def make_cube(size: float = 1.0, smooth: bool = False) -> MeshData:
    """Axis-aligned cube centered at origin, 12 triangles, CCW outward."""
    s = size / 2.0
    # 8 corners.
    corners = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        np.float32,
    )
    # Each face as two CCW triangles viewed from outside (right-handed
    # cross(B-A, C-A) points outward).
    quads = [
        ([4, 6, 7, 5], [1, 0, 0]),   # +x
        ([0, 1, 3, 2], [-1, 0, 0]),  # -x
        ([2, 3, 7, 6], [0, 1, 0]),   # +y
        ([0, 4, 5, 1], [0, -1, 0]),  # -y
        ([1, 5, 7, 3], [0, 0, 1]),   # +z
        ([0, 2, 6, 4], [0, 0, -1]),  # -z
    ]
    pos, norm, uv = [], [], []
    quv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for idxs, n in quads:
        p = corners[idxs]
        for tri in ((0, 1, 2), (0, 2, 3)):
            tp = p[list(tri)]
            pos.append(tp)
            if smooth:
                norm.append(tp / np.linalg.norm(tp, axis=-1, keepdims=True))
            else:
                norm.append(np.tile(np.asarray(n, np.float32), (3, 1)))
            uv.append(quv[list(tri)])
    return MeshData(
        np.asarray(pos, np.float32),
        np.asarray(norm, np.float32),
        np.asarray(uv, np.float32),
    )


def make_icosphere(subdiv: int = 2, radius: float = 1.0) -> MeshData:
    """Subdivided icosahedron with smooth (spherical) vertex normals."""
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
        tris = v[faces]  # (F, 3, 3)
        mid = np.concatenate(
            [
                (tris[:, 0] + tris[:, 1]) / 2,
                (tris[:, 1] + tris[:, 2]) / 2,
                (tris[:, 2] + tris[:, 0]) / 2,
            ]
        )
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        f = faces.shape[0]
        base = v.shape[0]
        m01 = base + np.arange(f)
        m12 = base + f + np.arange(f)
        m20 = base + 2 * f + np.arange(f)
        v = np.concatenate([v, mid])
        faces = np.concatenate(
            [
                np.stack([faces[:, 0], m01, m20], 1),
                np.stack([faces[:, 1], m12, m01], 1),
                np.stack([faces[:, 2], m20, m12], 1),
                np.stack([m01, m12, m20], 1),
            ]
        )
    pos = (v[faces] * radius).astype(np.float32)
    norm = v[faces].astype(np.float32)  # unit sphere normal == position
    # Equirect-style UVs (unused by shading; present for layout parity).
    uv = np.stack(
        [
            (np.arctan2(v[faces][..., 0], v[faces][..., 2]) / np.pi + 1) / 2,
            np.arccos(np.clip(v[faces][..., 1], -1, 1)) / np.pi,
        ],
        axis=-1,
    ).astype(np.float32)
    return MeshData(pos, norm, uv)


def make_gradient_envmap(height: int = 64, width: int = 128) -> np.ndarray:
    """Smooth directional gradient envmap: every texel distinct, so lookup
    coordinate bugs change the image."""
    y, x = np.mgrid[0:height, 0:width]
    r = 0.2 + 0.8 * x / max(width - 1, 1)
    g = 0.2 + 0.8 * y / max(height - 1, 1)
    b = 0.5 + 0.5 * np.sin(x / 7.0) * np.cos(y / 5.0)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def make_checker_envmap(height: int = 64, width: int = 128, cell: int = 8) -> np.ndarray:
    y, x = np.mgrid[0:height, 0:width]
    c = ((x // cell + y // cell) % 2).astype(np.float32)
    return np.stack([c, 1.0 - c, np.full_like(c, 0.25)], axis=-1)
