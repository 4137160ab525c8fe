"""Float texture loading — equivalent of `load_texture` (RefractionDemo.cpp:108-140).

The reference calls ``stbi_loadf(filename, &x, &y, &n, 3)``: whatever the
file format, the result is a (H, W, 3) float32 array; HDR files decode
linearly, LDR files get the stb gamma-2.2 lift. The demo requests
``../envMap.hdr`` but the repository only ships ``envmap.png``
(SURVEY.md 2.3) — we accept both and fall back PNG <-> HDR by extension.

The port's copy of `refraction_tpu.io.texture`: the pure-Python path only.
The JAX package's optional C++ accelerator (`io/native.py`, `native/`)
is not copied; it gives the same results, only faster.
"""

from __future__ import annotations

import os

import numpy as np

from refraction_tpu_torch.io.hdr import load_hdr
from refraction_tpu_torch.io.png import load_png, png_to_float_rgb


def load_texture(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) float32, stbi_loadf-style."""
    candidates = [path]
    stem, ext = os.path.splitext(path)
    if ext.lower() == ".hdr":
        candidates.append(stem + ".png")
    elif ext.lower() == ".png":
        candidates.append(stem + ".hdr")

    def resolve(p: str) -> str | None:
        if os.path.exists(p):
            return p
        # Case-insensitive fallback: the reference requests '../envMap.hdr'
        # while the shipped asset is 'envmap.png' (RefractionDemo.cpp:527 vs
        # SURVEY.md 2.3) — Windows filesystems are case-insensitive.
        d = os.path.dirname(p) or "."
        if os.path.isdir(d):
            want = os.path.basename(p).lower()
            for name in os.listdir(d):
                if name.lower() == want:
                    return os.path.join(d, name)
        return None

    for p in candidates:
        r = resolve(p)
        if r is not None:
            path = r
            break
    else:
        raise FileNotFoundError(f"texture not found: {candidates}")

    if path.lower().endswith(".hdr"):
        return load_hdr(path)
    img = load_png(path)
    return png_to_float_rgb(img)
