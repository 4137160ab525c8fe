"""Wavefront MTL parsing.

The reference ships ``ott.mtl`` (Ni=1.45, map_Kd -> a nonexistent PNG) but
its loader ignores materials entirely — Mesh.cpp:14-35 parses only
v/vt/vn/f lines and the IOR is hard-coded to 1.3 in the shader
(RayTracing.hlsl:95). For behavioral parity the renderer does the same by
default; this parser exists so the *capability* isn't lost: the CLI's
``--mtl-ior`` flag reads Ni from the scene's .mtl and uses it as the
dielectric IOR.

The port's copy of `refraction_tpu.io.mtl`, pure Python as the original
(the JAX package's optional C++ accelerator, `io/native.py`, is not
copied into the port).
"""

from __future__ import annotations

import os


def parse_mtl(path: str) -> dict[str, dict]:
    """Parse newmtl blocks into {name: {key: value}} dicts.

    Numeric single-value keys (Ns, Ni, d, illum) parse to float; color
    keys (Ka/Kd/Ks/Ke) to 3-float tuples; map_* keys stay strings.
    """
    materials: dict[str, dict] = {}
    cur: dict | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl" and len(parts) >= 2:
                cur = {}
                materials[parts[1]] = cur
            elif cur is None:
                continue
            elif key in ("Ns", "Ni", "d", "illum") and len(parts) >= 2:
                try:
                    cur[key] = float(parts[1])
                except ValueError:
                    pass
            elif key in ("Ka", "Kd", "Ks", "Ke") and len(parts) >= 4:
                try:
                    cur[key] = (float(parts[1]), float(parts[2]),
                                float(parts[3]))
                except ValueError:
                    pass
            elif key.startswith("map_") and len(parts) >= 2:
                cur[key] = parts[-1]
    return materials


def ior_for_scene(obj_path: str, default: float) -> float:
    """Ni of the first material in the OBJ's sibling .mtl, else default."""
    mtl_path = os.path.splitext(obj_path)[0] + ".mtl"
    if not os.path.exists(mtl_path):
        return default
    try:
        mats = parse_mtl(mtl_path)
    except OSError:
        return default
    for mat in mats.values():
        if "Ni" in mat:
            return float(mat["Ni"])
    return default
