"""Radiance RGBE (.hdr) decoding — the stb_image-capability the reference
relies on (`stbi_loadf`, RefractionDemo.cpp:111).

Pure NumPy implementation of the Radiance picture format:

- ASCII header up to a blank line, then a resolution line (only the standard
  ``-Y H +X W`` orientation is supported),
- new-style RLE scanlines (marker ``2 2 hi lo``) with per-component runs,
- flat RGBE and old-style RLE (``1 1 1 shift`` repeat codes) fallbacks.

Pixel conversion matches stb_image's `stbi__hdr_convert` exactly:
``rgb = mantissa * 2^(exp - 136)`` with exponent byte 0 mapping to black
(stb uses ``ldexp(1, e - (128+8))`` as the shared scale).

The port's copy of `refraction_tpu.io.hdr`: the pure-Python path only.
The JAX package's optional C++ accelerator (`io/native.py`, `native/`)
is not copied; it gives the same results, only faster.
"""

from __future__ import annotations

import re

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Decode a Radiance .hdr file to a (H, W, 3) float32 array."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_hdr_bytes(data)


def decode_hdr_bytes(data: bytes) -> np.ndarray:
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file (missing #? signature)")

    # Header: lines until an empty line; then the resolution line.
    pos = 0
    fmt_ok = False
    while True:
        eol = data.find(b"\n", pos)
        if eol < 0:
            raise ValueError("truncated .hdr header")
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() in (b"FORMAT=32-bit_rle_rgbe", b"FORMAT=32-bit_rle_xyze")
        if line == b"" or line == b"\r":
            break
    if not fmt_ok:
        # Many writers omit or reorder; be permissive like stb (it requires
        # the 32-bit_rle_rgbe token — we only warn by accepting).
        pass
    eol = data.find(b"\n", pos)
    if eol < 0:
        raise ValueError("truncated .hdr header (no resolution line)")
    res = data[pos:eol]
    pos = eol + 1
    # sscanf("-Y %d +X %d") semantics, shared with the JAX package's native decoder:
    # literals anchored at the line start, whitespace elastic (including
    # absent), trailing bytes ignored.
    m = re.match(rb"-Y\s*([+-]?[0-9]+)\s*\+X\s*([+-]?[0-9]+)", res)
    if not m:
        raise ValueError(f"unsupported .hdr orientation: {res!r}")
    height, width = int(m.group(1)), int(m.group(2))
    # Reject nonsense dimensions before allocating (stb-style cap); the
    # native decoder applies the same limits — without them a hostile
    # header can demand a multi-exabyte (or, in C, integer-overflowed)
    # allocation.
    if height <= 0 or width <= 0 or height * width > (1 << 28):
        raise ValueError(f"unreasonable .hdr dimensions {height}x{width}")

    rgbe = np.empty((height, width, 4), np.uint8)
    raw = np.frombuffer(data, np.uint8)

    y = 0
    while y < height:
        if pos + 4 > len(data):
            raise ValueError("truncated .hdr data")
        b0, b1, b2, b3 = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
        if b0 == 2 and b1 == 2 and ((b2 << 8) | b3) == width and width >= 8 and width < 32768:
            pos += 4
            # New-style RLE: 4 component planes, run-length coded.
            for c in range(4):
                x = 0
                while x < width:
                    if pos >= len(data):
                        raise ValueError("truncated .hdr RLE data")
                    count = data[pos]
                    if count > 128:  # run
                        if pos + 1 >= len(data):
                            raise ValueError("truncated .hdr RLE run")
                        val = data[pos + 1]
                        n = count - 128
                        if x + n > width:
                            raise ValueError("corrupt .hdr RLE scanline")
                        rgbe[y, x:x + n, c] = val
                        pos += 2
                    else:  # literal
                        n = count
                        if pos + 1 + n > len(data) or x + n > width:
                            raise ValueError("corrupt .hdr RLE scanline")
                        rgbe[y, x:x + n, c] = raw[pos + 1:pos + 1 + n]
                        pos += 1 + n
                    x += n
                if x != width:
                    raise ValueError("corrupt .hdr RLE scanline")
            y += 1
        else:
            # Flat / old-style: read scanlines pixel by pixel, honoring
            # (1,1,1,shift) repeat codes.
            x = 0
            # Matches the JAX package's native decoder (io_native.cpp): a repeat code
            # with no preceding pixel replicates zeros, and a run past the
            # scanline end is a hard error (numpy slicing would silently
            # truncate it otherwise).
            prev = np.zeros(4, np.uint8)
            shift = 0
            while y < height:
                while x < width:
                    if pos + 4 > len(data):
                        raise ValueError("truncated .hdr data")
                    px = raw[pos:pos + 4]
                    pos += 4
                    if px[0] == 1 and px[1] == 1 and px[2] == 1:
                        n = int(px[3]) << shift
                        if x + n > width:
                            raise ValueError(
                                ".hdr old-style RLE run exceeds scanline")
                        rgbe[y, x:x + n] = prev
                        x += n
                        shift += 8
                    else:
                        prev = px
                        rgbe[y, x] = px
                        x += 1
                        shift = 0
                x = 0
                y += 1
            break

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """stbi__hdr_convert: rgb = m * 2^(e-136); e == 0 -> (0,0,0)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.ldexp(np.float32(1.0), e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[e == 0] = 0.0
    return out


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """Inverse transform (for writing .hdr test fixtures / outputs)."""
    rgb = np.asarray(rgb, np.float32)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    m, e = np.frexp(maxc[nz])
    scale = m * 256.0 / maxc[nz]
    out[nz, 0] = np.clip(rgb[nz, 0] * scale, 0, 255).astype(np.uint8)
    out[nz, 1] = np.clip(rgb[nz, 1] * scale, 0, 255).astype(np.uint8)
    out[nz, 2] = np.clip(rgb[nz, 2] * scale, 0, 255).astype(np.uint8)
    out[nz, 3] = (e + 128).astype(np.uint8)
    return out


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a flat (non-RLE) Radiance .hdr file."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    rgbe = float_to_rgbe(rgb)
    # Flat format requires that no pixel run accidentally matches the RLE
    # scanline marker; widths < 8 or >= 32768 are always read flat, and the
    # (2,2,hi,lo) marker only triggers when hi<<8|lo == width. Radiance's own
    # tools avoid it the same way; collisions are practically impossible for
    # real images and we accept them for fixture writing.
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
