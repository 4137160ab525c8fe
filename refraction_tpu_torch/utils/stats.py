"""Frame statistics & structured logging.

The reference has no observability at all (SURVEY.md 5 — a single
OutputDebugStringA on shader-compile failure); this is the from-scratch
equivalent: rolling FPS / Mrays/s counters for the render loop and a
structured per-frame stats line.

The port's copy of `refraction_tpu.utils.stats`. The logger keeps the
name ``refraction_tpu``, so a handler on it sees the lines of either
package's CLI.
"""

from __future__ import annotations

import json
import logging
import time

log = logging.getLogger("refraction_tpu")


def setup_logging(level: int = logging.INFO) -> None:
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        log.addHandler(h)
    log.setLevel(level)


class FrameStats:
    """Rolling window of frame times + ray counts."""

    def __init__(self, window: int = 30):
        self.window = window
        self.times: list[float] = []
        self.rays: list[int] = []
        self._t0: float | None = None
        self.frames = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, rays_traced: int = 0) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.rays.append(rays_traced)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.rays.pop(0)
        self.frames += 1
        return dt

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times)
        return (sum(self.rays) / t / 1e6) if t else 0.0

    def line(self) -> str:
        return json.dumps(
            {
                "frame": self.frames,
                "fps": round(self.fps, 2),
                "mrays_s": round(self.mrays_per_s, 1),
                "last_ms": round(self.times[-1] * 1e3, 1) if self.times else None,
            }
        )
