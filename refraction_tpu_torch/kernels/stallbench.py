"""Traversal-primitive instrument kernel (``csrc/stallbench.cu``): port of
``tools/stallbench.py::_kernel`` (49).

`stall_iters` runs ``n_iter`` iterations of one variant's body over an
(8, 128) float32 carry with the loop index ``i``, reading the (1024,)
float32 table ``sm``:

- ``vecops``: 64 chained ``v * 1.0000001 + i``;
- ``tree``: ``bits = int(acc + i) & 15``, their OR over all 1,024
  elements, ``acc + float(word) * 1e-9``;
- ``extract``: the same OR, ``acc + (1e-9 if word else 0)``;
- ``while2``: a while loop over the word ``0x2D | (i & 1)``, two
  lowest-set-bit pops per trip, each ``acc * 1.0000001 + bit``;
- ``loads72``: ``acc + sm[(i & 63) * 9 + k % 9] * 1e-9`` for k < 72;
- ``subplane``: 32 compares ``acc * 0.001 + i > sm[(i & 63) * 6 + b % 6]``
  OR-ed into bit ``b % 31``, the OR over all elements, then
  ``acc + float(word) * 1e-9``.

On CUDA one block of 256 threads holds the carry, four elements a thread
(csrc/stallbench.cu; the block OR takes one barrier an iteration); on CPU
tensors the wrapper takes `stall_iters_plain`, the same loop in the
kernel's float32 order, equal to it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from refraction_tpu_torch.kernels._build import check, library

# Variant codes of rt_stall (RtStallVariant in stallbench.cu), in the
# tool's order.
VARIANTS = ("vecops", "tree", "extract", "while2", "loads72", "subplane")
PLANE = (8, 128)
TABLE = 1024
WHILE_WORD = 0x2D
_MUL = float(np.float32(1.0000001))
_MILLI = float(np.float32(0.001))
_NANO = np.float32(1e-9)
_BITS = 31  # the words use bits 0..30
# Block shapes of rt_stall_form: name -> elements per thread.
FORMS = {"1024x1": 1, "256x4": 4}


def _check(variant: str, n_iter: int, sm: torch.Tensor, x: torch.Tensor):
    if variant not in VARIANTS:
        raise ValueError(f"variant: want one of {VARIANTS}, got {variant!r}")
    if n_iter < 0:
        raise ValueError(f"n_iter: want >= 0, got {n_iter}")
    for name, t, shape in (("sm", sm, (TABLE,)), ("x", x, PLANE)):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous float32 {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def mixed_carry(seed: int = 0) -> np.ndarray:
    """A seeded (8, 128) float32 carry whose elements differ, for checks.

    The tool's carry, all ones, stays equal in every element, and at 1.0
    the ``word * 1e-9`` of ``tree`` and ``subplane`` is below half an ulp:
    an OR over part of the block, or an output written out of order, would
    give the same result. Here most elements lie in [0, 1e-3), where that
    term moves them, and six are in the thousands: they set bits of
    ``int(acc + i) & 15`` and pass ``subplane`` compares that the small ones
    do not, so the OR over the whole block differs from any warp's."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1e-3, TABLE).astype(np.float32)
    big = rng.choice(TABLE, 6, replace=False)
    x[big] = (rng.integers(1, 16, 6) * 1000 + rng.integers(0, 16, 6)).astype(
        np.float32)
    return x.reshape(PLANE)


def _or_all(bits: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """OR of every element of the int32 ``bits`` (values < 2^31), as a 0-d
    int64 tensor on their device: per bit, whether any element sets it."""
    any_set = ((bits[:, None] >> shifts) & 1).amax(dim=0).to(torch.int64)
    return (any_set << shifts.to(torch.int64)).sum()


def stall_iters_plain(variant: str, n_iter: int, sm: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """`stall_iters` in plain PyTorch, one Python iteration per loop
    iteration, in the kernel's float32 order."""
    _check(variant, n_iter, sm, x)
    dev = x.device
    table = sm.cpu().numpy()
    scaled = table * _NANO  # float32 products sm[k] * 1e-9, as the kernel's
    nano = torch.tensor(_NANO, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    shifts = torch.arange(_BITS, dtype=torch.int32, device=dev)
    acc = x.reshape(-1).clone()
    for i in range(n_iter):
        fi = float(i)
        if variant == "vecops":
            for _ in range(64):
                acc = acc * _MUL + fi
        elif variant in ("tree", "extract"):
            word = _or_all((acc + fi).to(torch.int32) & 15, shifts)
            if variant == "tree":
                acc = acc + word.to(torch.float32) * nano
            else:
                acc = acc + torch.where(word != 0, nano, zero)
        elif variant == "while2":
            w = WHILE_WORD | (i & 1)
            while w:
                iso = w & -w
                acc = acc * _MUL + float(iso)
                w ^= iso
                iso2 = w & -w
                acc = acc * _MUL + float(iso2)
                w ^= iso2
        elif variant == "loads72":
            base = (i & 63) * 9
            for k in range(72):
                acc = acc + float(scaled[base + k % 9])
        else:  # subplane
            base = (i & 63) * 6
            m = acc * _MILLI + fi
            bits = torch.zeros(acc.shape, dtype=torch.int32, device=dev)
            for b in range(32):
                hit = (m > float(table[base + b % 6])).to(torch.int32)
                bits = bits | (hit << (b % _BITS))
            acc = acc + _or_all(bits, shifts).to(torch.float32) * nano
    return acc.reshape(PLANE)


def stall_iters(variant: str, n_iter: int, sm: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The (8, 128) carry after ``n_iter`` iterations of ``variant`` (see
    the module doc), starting from ``x``. On CUDA: one launch of one
    256-thread block, no host sync."""
    _check(variant, n_iter, sm, x)
    if x.device.type == "cpu":
        return stall_iters_plain(variant, n_iter, sm, x)
    if x.device.type != "cuda":
        raise ValueError(f"stall_iters: unsupported device {x.device}")
    out = torch.empty_like(x)
    err = library().rt_stall(
        VARIANTS.index(variant), n_iter, sm.data_ptr(), x.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "rt_stall")
    stall_iters.launches += 1
    return out


stall_iters.launches = 0


def stall_form(ept: int, variant: str, n_iter: int, sm: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """The instrument: one launch of `stall_iters`' function in the block
    shape of ``ept`` elements per thread (a value of ``FORMS``; rt_stall
    runs one of the two), CUDA tensors only. No launch is counted: no
    render path runs it."""
    _check(variant, n_iter, sm, x)
    if x.device.type != "cuda":
        raise ValueError(f"stall_form: CUDA tensors only, got {x.device}")
    out = torch.empty_like(x)
    check(library().rt_stall_form(
        ept, VARIANTS.index(variant), n_iter, sm.data_ptr(), x.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream),
        "rt_stall_form")
    return out
