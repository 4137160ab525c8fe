"""Frame statistics & structured logging.

The reference has no observability at all (SURVEY.md 5 — a single
OutputDebugStringA on shader-compile failure); this is the from-scratch
equivalent: a rolling FPS counter for the render loop and the shared
logger of its per-frame lines.

The port's copy of `refraction_tpu.utils.stats`, without its ray
counter: the frame kernel counts no rays, so nothing would feed it. The
logger keeps the name ``refraction_tpu``, so a handler on it sees the
lines of either package's CLI.
"""

from __future__ import annotations

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
    """Rolling window of frame times."""

    def __init__(self, window: int = 30):
        self.window = window
        self.times: list[float] = []
        self._t0: float | None = None
        self.frames = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        self.frames += 1
        return dt

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)
