"""Procedural scenes on disk, for driving the CLI without the reference assets.

Meshes and env maps come from `io.primitives` (numpy, e.g.
``make_icosphere``, ``make_gradient_envmap``); this
module writes them in the formats the CLI reads: a Wavefront OBJ with
``v``/``vt``/``vn``/``f v/vt/vn`` lines (the reference's parser needs all
three indices per corner) and a Radiance ``.hdr``. `paired_miss_lanes`
is a round-kernel state for checking how a pixel's misses are summed.
"""

from __future__ import annotations

import os

import numpy as np

from refraction_tpu_torch.io.hdr import write_hdr
from refraction_tpu_torch.io.objmesh import MeshData


def write_obj(path: str, mesh: MeshData) -> None:
    """Write ``mesh`` as an OBJ whose corners share vertex and normal lines
    where they are equal. Floats are written with 9 significant digits, so
    they read back bit for bit as float32."""
    corners = np.concatenate([mesh.positions.reshape(-1, 3),
                              mesh.normals.reshape(-1, 3)], axis=1)
    uniq, inv = np.unique(corners.astype(np.float32), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1, 3) + 1
    lines = [f"v {a:.9g} {b:.9g} {c:.9g}" for a, b, c in uniq[:, :3]]
    lines.append("vt 0 0")
    lines += [f"vn {a:.9g} {b:.9g} {c:.9g}" for a, b, c in uniq[:, 3:]]
    lines += [f"f {i}/1/{i} {j}/1/{j} {k}/1/{k}" for i, j, k in inv]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def paired_miss_lanes(p: int, seed: int = 0) -> np.ndarray:
    """(8, 2p) float32 round-kernel lane state (``ox oy oz dx dy dz cull
    wgt``) of 2p live rays that miss every mesh within radius 5 of the
    origin: from (0, 0, 6), outward in directions jittered about +z. With
    pixel = slot % p, lanes i and p + i are two misses of pixel i: the
    first p weigh 1e-39, so their radiance is subnormal, the last p 2e-37,
    a small normal radiance beside which the subnormal still counts."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.uniform(-1.0, 1.0, (2, 2 * p)),
                        np.ones((1, 2 * p))])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.zeros((3, 2 * p))
    o[2] = 6.0
    wgt = np.repeat([1e-39, 2e-37], p)
    return np.ascontiguousarray(np.concatenate(
        [o, d, np.ones((1, 2 * p)), wgt[None]]), np.float32)


def write_scene(directory: str, name: str, mesh: MeshData,
                envmap: np.ndarray) -> tuple[str, str]:
    """Write ``name.obj`` and ``name.hdr`` into ``directory``; returns
    their paths."""
    os.makedirs(directory, exist_ok=True)
    obj = os.path.join(directory, f"{name}.obj")
    hdr = os.path.join(directory, f"{name}.hdr")
    write_obj(obj, mesh)
    write_hdr(hdr, envmap)
    return obj, hdr
