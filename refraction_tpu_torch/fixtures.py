"""Procedural scenes on disk, for driving the CLI without the reference assets.

Meshes and env maps come from `io.primitives` (numpy, e.g.
``make_icosphere``, ``make_gradient_envmap``); this
module writes them in the formats the CLI reads: a Wavefront OBJ with
``v``/``vt``/``vn``/``f v/vt/vn`` lines (the reference's parser needs all
three indices per corner) and a Radiance ``.hdr``. `paired_miss_lanes`
and `multi_miss_lanes` are round-kernel states for checking how a pixel's
misses are summed; `two_balls` is a mesh whose ray trees put three
misses of a pixel into one bounce round.
"""

from __future__ import annotations

import os

import numpy as np

from refraction_tpu_torch.io.hdr import write_hdr
from refraction_tpu_torch.io.objmesh import MeshData
from refraction_tpu_torch.io.primitives import make_icosphere


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


def _miss_lanes(rng, m: int, wgt: np.ndarray) -> np.ndarray:
    """(8, m) lane state of m live rays of weights ``wgt`` that miss every
    mesh within radius 5 of the origin: from (0, 0, 6), outward in
    directions jittered about +z."""
    d = np.concatenate([rng.uniform(-1.0, 1.0, (2, m)), np.ones((1, m))])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = np.zeros((3, m))
    o[2] = 6.0
    return np.ascontiguousarray(np.concatenate(
        [o, d, np.ones((1, m)), wgt[None]]), np.float32)


def paired_miss_lanes(p: int, seed: int = 0) -> np.ndarray:
    """(8, 2p) float32 round-kernel lane state (``ox oy oz dx dy dz cull
    wgt``) of 2p live rays that miss (`_miss_lanes`). With pixel = slot % p,
    lanes i and p + i are two misses of pixel i: the first p weigh 1e-39,
    so their radiance is subnormal, the last p 2e-37, a small normal
    radiance beside which the subnormal still counts."""
    return _miss_lanes(np.random.default_rng(seed), 2 * p,
                       np.repeat([1e-39, 2e-37], p))


def multi_miss_lanes(p: int, k: int, seed: int = 0) -> np.ndarray:
    """(8, k*p) lane state of k*p live rays that miss (`_miss_lanes`):
    lanes i, p + i, ..., (k-1)p + i are k misses of pixel i = slot % p.
    Each lane's weight is drawn from three kinds: 1e-39 (a subnormal
    radiance), 2e-37 to 4e-37 (a small normal one) and, three times in
    five, 0.5 to 1. With three or more such terms the float32 sum of a
    pixel depends on the order of the additions at over a tenth of the
    pixels."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 1, 2, 2, 2], k * p)
    scale = rng.uniform(0.5, 1.0, k * p)
    wgt = np.choose(kind, [np.full(k * p, 1e-39), 4e-37 * scale, scale])
    return _miss_lanes(rng, k * p, wgt)


def two_balls(subdivisions: int = 2) -> MeshData:
    """Two icospheres of radius 0.8 side by side on the x axis (centres
    +-0.9): rays reflected off one ball hit the other, so with three
    reflections allowed some pixels, seen from the side (orbit angle 1.2),
    have three lanes that miss in one bounce round."""
    ball = make_icosphere(subdivisions, 0.8)
    shift = np.float32([0.9, 0.0, 0.0])
    return MeshData(
        positions=np.concatenate([ball.positions - shift,
                                  ball.positions + shift]),
        normals=np.concatenate([ball.normals, ball.normals]),
        uvs=np.concatenate([ball.uvs, ball.uvs]))


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
