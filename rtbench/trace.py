"""The traced slice of a window, reduced from `torch.profiler`'s events.

The harness wraps each call into the program in a ``record_function`` span
named ``rtbench.<step>`` and each loop iteration in ``rtbench.frame``. From
the profiler's events this module keeps two lists of (name, start us, end
us): the host's ``rtbench.*`` spans, and the device's operations (kernels,
copies, sets; the device-side copies of the user spans are left out). The
slice runs from the first ``rtbench.frame`` span's start to the last one's
end; every device reading is clipped to it.
"""

from __future__ import annotations

import dataclasses
import re

FRAME_SPAN = "rtbench.frame"
SPAN_PREFIX = "rtbench."


def op_name(name: str) -> str:
    """A device operation's name without ``void``, template arguments or
    parameters; copies and sets keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


@dataclasses.dataclass
class Trace:
    host: list      # (name, start_us, end_us) of rtbench.* spans
    device: list    # (name, start_us, end_us) of device operations
    start_us: float
    end_us: float

    @property
    def frames(self) -> int:
        return sum(1 for h in self.host if h[0] == FRAME_SPAN)

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def clipped(self):
        """Device operations clipped to the slice, empty ones dropped."""
        out = []
        for name, s, e in self.device:
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e > s:
                out.append((name, s, e))
        return out

    def busy(self) -> list[tuple[float, float]]:
        """The union of the clipped device intervals, in order."""
        merged: list[list[float]] = []
        for _, s, e in sorted(self.clipped(), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def span_us(self, name: str) -> float:
        return sum(e - s for n, s, e in self.host if n == name)

    def device_ops(self, top: int = 10) -> list:
        """[[op name, seconds]] of the operations that took the most device
        time in the slice, summed by name."""
        tot: dict[str, float] = {}
        for name, s, e in self.clipped():
            key = op_name(name)
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])
                ][:top]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host span, seconds]]: the device's idle time in the slice,
        split by the ``rtbench.*`` step span (pose, render, ...) the host
        was in meanwhile, ``rtbench.frame`` for idle time between steps."""
        edges = [self.start_us]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.end_us)
        gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2])
                if g1 > g0]
        steps = sorted((h for h in self.host if h[0] != FRAME_SPAN),
                       key=lambda h: h[1])
        tot: dict[str, float] = {}
        k = 0
        for g0, g1 in gaps:
            covered = 0.0
            while k < len(steps) and steps[k][2] <= g0:
                k += 1
            j = k
            while j < len(steps) and steps[j][1] < g1:
                name, s, e = steps[j]
                part = min(e, g1) - max(s, g0)
                if part > 0:
                    tot[name] = tot.get(name, 0.0) + part * 1e-6
                    covered += part
                j += 1
            rest = (g1 - g0) - covered
            if rest > 0:
                tot[FRAME_SPAN] = tot.get(FRAME_SPAN, 0.0) + rest * 1e-6
        return [[k_, v] for k_, v in sorted(tot.items(), key=lambda x: -x[1])
                ][:top]


def from_events(events) -> Trace | None:
    """The `Trace` of a profiler's ``events()``, or None where the slice
    holds no ``rtbench.frame`` span."""
    from torch.autograd import DeviceType

    host, device = [], []
    for ev in events:
        name = ev.name
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        is_device = ev.device_type == DeviceType.CUDA
        if name.startswith(SPAN_PREFIX):
            if not is_device:
                host.append((name, s, e))
            continue
        if is_device and not getattr(ev, "is_user_annotation", False):
            device.append((name, s, e))
    frames = [h for h in host if h[0] == FRAME_SPAN]
    if not frames:
        return None
    return Trace(host, device, min(h[1] for h in frames),
                 max(h[2] for h in frames))
