"""Procedural scenes on disk, for driving the CLI without the reference assets.

Meshes and env maps come from `io.primitives` (numpy, e.g.
``make_icosphere``, ``make_gradient_envmap``); this
module writes them in the formats the CLI reads: a Wavefront OBJ with
``v``/``vt``/``vn``/``f v/vt/vn`` lines (the reference's parser needs all
three indices per corner) and a Radiance ``.hdr``.
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
