"""PNG decode/encode in pure Python + zlib.

Decode covers the capability the reference gets from stb_image for
``envmap.png``: 8/16-bit depth, grayscale / RGB / palette / alpha variants,
all five scanline filters, non-interlaced. Encode writes 8-bit RGB(A)
(used by the CLI to save rendered frames — the reference shows frames in a
window instead, RefractionDemo.cpp:609).

The port's copy of `refraction_tpu.io.png`: the pure-Python path only.
The JAX package's optional C++ accelerator (`io/native.py`, `native/`)
is not copied; it gives the same results, only faster.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"

# Channels per pixel for PNG color types 0,2,3,4,6.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def load_png(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W, C) uint8 or uint16."""
    with open(path, "rb") as f:
        return decode_png_bytes(f.read())


def decode_png_bytes(data: bytes) -> np.ndarray:
    """Decode to (H, W, C) uint8 or uint16 (C in {1,2,3,4})."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    ihdr = None
    idat = []
    palette = None
    trns = None
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if len(chunk) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise ValueError("corrupt PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = chunk
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG missing IHDR")
    w, h, depth, color, comp, filt, interlace = ihdr
    # Dimension sanity before allocating scanline buffers (a corrupt
    # IHDR can otherwise demand a multi-gigabyte array).
    if w == 0 or h == 0 or w * h > (1 << 28):
        raise ValueError(f"unreasonable PNG dimensions {w}x{h}")
    if comp != 0 or filt != 0:
        raise ValueError("unsupported PNG compression/filter method")
    if interlace != 0:
        raise ValueError("interlaced PNG not supported")
    if depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    nch = _CHANNELS.get(color)
    if nch is None:
        raise ValueError(f"unsupported PNG color type {color}")

    raw = zlib.decompress(b"".join(idat))
    bits_pp = depth * nch
    bytes_pp = max(1, bits_pp // 8)
    stride = (w * bits_pp + 7) // 8

    # Undo scanline filters.
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    src = np.frombuffer(raw, np.uint8)
    if src.size < h * (stride + 1):
        raise ValueError("truncated PNG data")
    for y in range(h):
        ftype = src[y * (stride + 1)]
        line = src[y * (stride + 1) + 1:(y + 1) * (stride + 1)].copy()
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(bytes_pp, stride):
                line[i] = (int(line[i]) + int(line[i - bytes_pp])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                a = int(line[i - bytes_pp]) if i >= bytes_pp else 0
                line[i] = (int(line[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - bytes_pp]) if i >= bytes_pp else 0
                b = int(prev[i])
                c = int(prev[i - bytes_pp]) if i >= bytes_pp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = out[y]

    # Unpack to (H, W, C).
    if depth == 16:
        img = out.reshape(h, stride).view(">u2").astype(np.uint16).reshape(h, w, nch)
    elif depth == 8:
        img = out.reshape(h, w, nch)
    else:
        # Sub-byte depths: unpack bits, group per pixel.
        bits = np.unpackbits(out, axis=1)[:, : w * bits_pp]
        vals = bits.reshape(h, w, nch, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
        img = (vals * weights).sum(axis=-1).astype(np.uint8)
        if color != 3:  # scale to full 8-bit range for grayscale
            img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)

    if color == 3:
        if palette is None:
            raise ValueError("palette PNG missing PLTE")
        idx = img[..., 0]
        img = palette[idx]
        if trns is not None:
            # tRNS alpha is indexed by the PALETTE index (PNG spec 11.3.2),
            # not by the expanded red value.
            alpha = np.full(256, 255, np.uint8)
            t = np.frombuffer(trns, np.uint8)
            alpha[: t.size] = t
            img = np.dstack([img, alpha[idx]])
    return img


def png_to_float_rgb(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """LDR -> HDR exactly as stbi_loadf with 3 requested channels:
    normalize, apply `pow(x, gamma)` (stbi__ldr_to_hdr, gamma 2.2, scale 1),
    replicate grayscale, drop alpha (stb converts N channels to 3)."""
    maxv = np.float32(65535.0 if img.dtype == np.uint16 else 255.0)
    f = img.astype(np.float32) / maxv
    c = f.shape[-1]
    if c == 1:
        rgb = np.repeat(f, 3, axis=-1)
    elif c == 2:
        rgb = np.repeat(f[..., :1], 3, axis=-1)
    elif c == 3:
        rgb = f
    else:
        rgb = f[..., :3]
    return np.power(rgb, np.float32(gamma), dtype=np.float32)


def encode_png(fileobj, img: np.ndarray, level: int = 6) -> None:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 (float in [0,1]
    accepted) into a binary file object."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 0  # filter: None
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    fileobj.write(_SIG)
    fileobj.write(
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
    fileobj.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
    fileobj.write(chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W), (H, W, 3) or (H, W, 4) uint8 (float in [0,1] accepted)."""
    with open(path, "wb") as f:
        encode_png(f, img)
