"""Timing and card identity for the port's measurement tools.

Every number a tool prints names the device it ran on: on CUDA the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
(a card may be set below its maximum power and then runs slower); on the
CPU it says that the plain versions ran under the host clock.
"""

from __future__ import annotations

import subprocess
import time

import torch

# Cycles of the spin kernel that device_ms queues ahead of the timed call:
# ~2 ms at the H100's boost clock, more than the host takes to enqueue
# one wavefront frame (~1 ms).
SPIN_CYCLES = 4_000_000


def time_ms(fn, device: torch.device) -> float:
    """ms of one call of ``fn``: CUDA events around it on a CUDA device,
    the host clock otherwise."""
    if device.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize(device)
        return ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def device_ms(fn, device: torch.device, setup=None) -> float:
    """ms the card spends on one call of ``fn``: on CUDA the call is
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts its
    enqueue, so the CUDA events around it time the device's work without
    the host's launch overhead between its kernels; the host clock on the
    CPU. ``setup()``, if given, runs just before the timed window, outside
    it."""
    if device.type != "cuda":
        if setup is not None:
            setup()
        return time_ms(fn, device)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    if setup is not None:
        setup()
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize(device)
    return ev0.elapsed_time(ev1)


def card_ms(fn, reps: int, device: torch.device) -> float:
    """The card's mean ms per call of ``fn`` over ``reps`` calls queued
    behind one spin kernel (`device_ms`), after one warm-up call: for
    kernels that run shorter than their wrapper takes to enqueue."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def calls():
        for _ in range(reps):
            fn()

    return device_ms(calls, device) / reps


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or a
    note that the device is the CPU."""
    if device.type != "cuda":
        return "cpu (plain versions, host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[device.index or 0]


def require_device(name: str) -> torch.device:
    """``torch.device(name)``; raises if it is CUDA and CUDA is absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device
