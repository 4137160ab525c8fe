"""What the per-layer readers (``rtbench/metrics/<name>.py``) share.

Each reader is ``read(ctx) -> float | None``; ``ctx`` holds ``trace``
(the traced slice, `rtbench.trace.Trace`, or None) and ``roofline``
(`rtbench.roofline.bound` of the cell's frame at the traced pose, or
None). A reader that finds nothing to read returns None, and the metric
is left out of the line; a share is never read as 0 for want of a
reading.
"""

from __future__ import annotations

from rtbench.trace import op_name


def host_steps_ms(ctx: dict, spans: tuple[str, ...], need: str | None = None):
    """Mean host ms a traced frame spends in ``spans``, summed; None
    without a trace, or where no span ``need`` was recorded."""
    tr = ctx.get("trace")
    if tr is None or tr.frames == 0:
        return None
    if need is not None and not any(h[0] == need for h in tr.host):
        return None
    return sum(tr.span_us(s) for s in spans) / tr.frames / 1e3


def kernel_ms(ctx: dict, prefix: str):
    """Mean device ms of one launch of the kernels whose name starts with
    ``prefix``, over the whole launches in the slice; None without one."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    times = [e - s for name, s, e in tr.device
             if op_name(name).startswith(prefix)
             and s >= tr.start_us and e <= tr.end_us]
    if not times:
        return None
    return sum(times) / len(times) / 1e3


def roofline_pct(ctx: dict, prefix: str):
    """The bound's share of the mean launch time, in %."""
    ms = kernel_ms(ctx, prefix)
    bnd = ctx.get("roofline")
    if ms is None or bnd is None or ms <= 0:
        return None
    return bnd["bound_ms"] / ms * 100.0


def idle_pct(ctx: dict):
    """The share of the slice in which no device operation ran, in %;
    None where the slice holds none."""
    tr = ctx.get("trace")
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return (1.0 - tr.busy_us() / tr.window_us) * 100.0
