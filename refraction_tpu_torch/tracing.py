"""Spans inside the frame path, on the profiler's clock.

``with span("rt.upload"): ...`` records a span named ``rt.upload`` when
a `torch.profiler` session records, so it lies on the same timeline as
the card's kernels and copies in that session's events and Chrome trace;
with no session recording it does nothing. There is no switch of its
own: rtbench's ``--trace 1`` run and ``python -m refraction_tpu_torch.run
--profile DIR`` see the spans because they run a profiler.

The spans of the port, each where its work happens (no other code opens
one; no name starts with ``rt_frame``, the frame kernel's prefix):

- ``rt.pose``: `camera.orbit_camera` (the numpy projection, look-at and
  4x4 inverse);
- ``rt.upload``: the scalar vector's host-to-device copy in
  `kernels.framekernel.build_scalars` (from pageable memory, so it waits
  for the stream);
- ``rt.launch``: the CUDA branch of the frame kernel's wrappers (argument
  checks, the output's allocation, the launch);
- ``rt.to_u8``: `run.to_u8` (enqueueing the display transform);
- ``rt.fold.widen`` and ``rt.fold.add``: `render.Accumulator.add` of a
  host frame (the float64 copy of the frame, then the add into the sum);
- ``rt.fold.card``: `render.Accumulator.add` of a frame on a card
  (enqueueing the add into the card's float64 sum; the first fold there
  also allocates the sum, or uploads a resumed one);
- ``rt.fold.fetch``: reading `render.Accumulator.sum` while it lives on a
  card (one synchronising copy of the sum to the host).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

# One shared context for every span while no profiler records: the off
# path costs an attribute read and allocates nothing.
_OFF = contextlib.nullcontext()
# The profiler's light span (a few us a span against ~15 for
# record_function); older torch lacks it.
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str):
    """A context manager that records the span ``name`` while a
    `torch.profiler` session records, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if _FAST is None:
        return torch.profiler.record_function(name)
    return _FAST(name)
