"""Wavefront OBJ parsing with the reference loader's exact semantics.

Reproduces `Mesh::load` (reference Mesh.cpp:6-37):

- only four line forms are recognized, via the same match rules as the
  reference's sscanf calls:
    ``v x y z`` / ``vt u v`` / ``vn x y z`` /
    ``f a/b/c d/e/f g/h/i`` (slash-separated v/vt/vn triplets)
- face lines must carry all three of v/vt/vn; faces with more than three
  corners match the first three conversions (sscanf stops after 9 ints and
  ignores the tail), so quads import as their first triangle — reproduced.
- indices are 1-based; negative / relative indices are not supported
  (reference does `a[i] - 1` unconditionally, Mesh.cpp:28-30).
- no vertex deduplication: each face emits three fresh vertices and
  ``indices == arange(3 * n_tris)`` (Mesh.cpp:31-32).

Output is struct-of-arrays NumPy, the natural TPU layout: per-triangle
``(T, 3, 3)`` corner positions/normals and ``(T, 3, 2)`` uvs.

The port's copy of `refraction_tpu.io.objmesh`: the pure-Python path only.
The JAX package's optional C++ accelerator (`io/native.py`, `native/`)
is not copied; it gives the same results, only faster.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# Numeric-token contract of the JAX package's C++ fast path, matching the reference's sscanf conversions: a token is consumed
# IN FULL or the line is skipped (sscanf's next directive fails on the
# leftover), so "1.5abc" or "1e" never half-parse; Python-only literal
# extensions (digit-group underscores "1_0", non-ASCII digits, hex
# floats "0x1p3") are rejected because strtol/strtof (and %d/%f) stop
# at them. Ints are [+-]?digits (strtol base 10, full consume) modulo
# leading C-locale whitespace — only \v/\f can survive tokenization.
_INT_RE = re.compile(r"[\v\f]*[+-]?[0-9]+$")
_HEX_RE = re.compile(r"[\v\f]*[+-]?0[xX]")

# Lines split on \n ONLY and tokens on space/tab/CR/NL ONLY — C's
# getline/strtok semantics; Python's splitlines()/split() additionally
# break on \v, \f, \x85, U+2028… which C treats as token bytes.
_TOKEN_SPLIT = re.compile(r"[ \t\r\n]+")


def _parse_float_token(tok: str):
    """Float token under the shared contract; None if malformed."""
    if not tok.isascii() or "_" in tok or _HEX_RE.match(tok):
        return None
    try:
        return float(tok)  # accepts inf/infinity/nan like strtof
    except ValueError:
        return None


@dataclasses.dataclass
class MeshData:
    """Triangle soup in SoA layout (float32)."""

    positions: np.ndarray  # (T, 3, 3) corner positions
    normals: np.ndarray    # (T, 3, 3) per-corner shading normals
    uvs: np.ndarray        # (T, 3, 2) per-corner texture coords

    @property
    def num_tris(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_verts(self) -> int:
        # Reference emits 3 fresh vertices per face (Mesh.cpp:26-33).
        return 3 * self.num_tris

    def flat_vertices(self) -> np.ndarray:
        """(3T, 8) packed [pos, norm, uv] rows — the reference's Vertex
        struct layout (Mesh.hpp:5-12)."""
        t = self.num_tris
        out = np.empty((3 * t, 8), np.float32)
        out[:, 0:3] = self.positions.reshape(-1, 3)
        out[:, 3:6] = self.normals.reshape(-1, 3)
        out[:, 6:8] = self.uvs.reshape(-1, 2)
        return out


def _parse_face_token(tok: str):
    """Parse one ``v/vt/vn`` corner token; None if not the full triplet."""
    parts = tok.split("/")
    if len(parts) != 3 or not all(_INT_RE.match(p) for p in parts):
        return None
    return int(parts[0]), int(parts[1]), int(parts[2])


def parse_obj(path: str) -> MeshData:
    """Parse an OBJ file into a triangle soup."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    return parse_obj_text(text)


def parse_obj_text(text: str) -> MeshData:
    locs: list[tuple] = []
    uvs: list[tuple] = []
    norms: list[tuple] = []
    tri_pos: list = []
    tri_norm: list = []
    tri_uv: list = []

    for line in text.split("\n"):
        # C line readers stop at an embedded NUL (the reference tokenizes
        # C strings); drop anything after one so both paths see the line
        # identically.
        nul = line.find("\x00")
        if nul >= 0:
            line = line[:nul]
        parts = [p for p in _TOKEN_SPLIT.split(line) if p]
        if not parts:
            continue
        tag = parts[0]
        # sscanf("v %f %f %f") needs exactly 3 floats after the tag; extra
        # tokens are ignored (sscanf stops reading), fewer is a non-match.
        if tag == "v" and len(parts) >= 4:
            vals = [_parse_float_token(t) for t in parts[1:4]]
            if None not in vals:
                locs.append(tuple(vals))
        elif tag == "vt" and len(parts) >= 3:
            vals = [_parse_float_token(t) for t in parts[1:3]]
            if None not in vals:
                uvs.append(tuple(vals))
        elif tag == "vn" and len(parts) >= 4:
            vals = [_parse_float_token(t) for t in parts[1:4]]
            if None not in vals:
                norms.append(tuple(vals))
        elif tag == "f" and len(parts) >= 4:
            corners = [_parse_face_token(t) for t in parts[1:4]]
            if any(c is None for c in corners):
                continue  # sscanf yields != 9 ints -> line skipped
            p, n, u = [], [], []
            ok = True
            for (vi, ti, ni) in corners:
                # 1-based indexing, no bounds checking in the reference;
                # we check and skip malformed faces instead of crashing.
                if not (1 <= vi <= len(locs) and 1 <= ti <= len(uvs)
                        and 1 <= ni <= len(norms)):
                    ok = False
                    break
                p.append(locs[vi - 1])
                u.append(uvs[ti - 1])
                n.append(norms[ni - 1])
            if ok:
                tri_pos.append(p)
                tri_uv.append(u)
                tri_norm.append(n)

    if not tri_pos:
        return MeshData(
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 3, 2), np.float32),
        )
    return MeshData(
        np.asarray(tri_pos, np.float32),
        np.asarray(tri_norm, np.float32),
        np.asarray(tri_uv, np.float32),
    )
