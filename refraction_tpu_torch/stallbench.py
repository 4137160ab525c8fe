"""Traversal-primitive instrument: ns per iteration of each structural
primitive, port of ``tools/stallbench.py``.

For each variant of kernels/stallbench.py (vecops, tree, extract, while2,
loads72, subplane) it runs N iterations over the (8, 128) carry
(``sm = arange(1024)``, ``x = ones``) once to warm up, then 5 times, and
prints the best time over N as ``<variant>: ... ns/iter`` after a first
line naming the card:

    python -m refraction_tpu_torch.stallbench [N]          # N = 200,000
    python -m refraction_tpu_torch.stallbench 32 --device cpu
    python -m refraction_tpu_torch.stallbench --variants   # CUDA only

On ``--device cuda`` the times are CUDA events around each launch, and
each line ends with the variant's bound at N in ns per iteration and its
side, ``(bound ... ns/iter by latency)``: `bounds.stall_bound`, the
larger of the card's throughput floor and the dependent chain's latency
floor at the card's maximum SM clock (nvidia-smi). On ``--device cpu``
the plain version runs under the host clock and no bound is printed (it
is the card's). ``--device cuda`` without CUDA is an error. Each variant
is launched ``1 + REPS`` times.

``--variants`` adds, after each variant's line, ``<variant> kernel: ...
ns/iter`` and one such line per block shape that csrc/stallbench.cu's
``rt_stall_form`` builds (``1024x1``: 1,024 threads of one element,
``256x4``: 256 threads of four), each shape first held bit for bit
against the kernel, then all timed in turns (best of 5 each). The kernel
is one of the two shapes, so the other is the form measured and not
kept.
"""

from __future__ import annotations

import argparse

import torch

from refraction_tpu_torch import bounds
from refraction_tpu_torch.kernels.stallbench import (
    FORMS,
    PLANE,
    TABLE,
    VARIANTS,
    stall_form,
    stall_iters,
)
from refraction_tpu_torch.timing import card_line, require_device, time_ms

DEFAULT_N = 200_000
REPS = 5


def _inputs(device: torch.device):
    return (torch.arange(TABLE, dtype=torch.float32, device=device),
            torch.ones(PLANE, dtype=torch.float32, device=device))


def ns_per_iter(variant: str, n_iter: int, device: torch.device,
                reps: int = REPS) -> float:
    """Best of ``reps`` timed runs of ``n_iter`` iterations, after one
    warm-up run, in ns per iteration."""
    sm, x = _inputs(device)
    stall_iters(variant, n_iter, sm, x)
    best = min(time_ms(lambda: stall_iters(variant, n_iter, sm, x), device)
               for _ in range(reps))
    return best * 1e6 / n_iter


def forms_ns_per_iter(variant: str, n_iter: int, device: torch.device,
                      reps: int = REPS) -> dict:
    """{shape: ns per iteration} of each ``FORMS`` shape on CUDA, each
    first held bit for bit against the kernel's carry after ``n_iter``
    iterations, then timed in turns with the kernel (best of ``reps``)."""
    sm, x = _inputs(device)
    want = stall_iters(variant, n_iter, sm, x)
    runs = {"kernel": lambda: stall_iters(variant, n_iter, sm, x)}
    for name, ept in FORMS.items():
        runs[name] = (lambda ept=ept: stall_form(ept, variant, n_iter, sm, x))
        if not torch.equal(runs[name](), want):
            raise AssertionError(f"stall form {name} differs from the kernel "
                                 f"on {variant}")
    best = {name: float("inf") for name in runs}
    for _ in range(reps):
        for name, fn in runs.items():
            best[name] = min(best[name], time_ms(fn, device))
    return {name: ms * 1e6 / n_iter for name, ms in best.items()}


def bound_note(variant: str, n_iter: int, clock_hz: float) -> str:
    """``(bound X ns/iter by SIDE)`` of `bounds.stall_bound` at n_iter."""
    b = bounds.stall_bound(variant, n_iter, clock_hz)
    return (f"(bound {b['bound_ms'] * 1e6 / n_iter:.1f} ns/iter by "
            f"{b['bound_by']})")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("N", nargs="?", type=int, default=DEFAULT_N,
                   help=f"iterations per run (default {DEFAULT_N:,})")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--variants", action="store_true",
                   help="also time each block shape of rt_stall_form (CUDA)")
    args = p.parse_args(argv)
    if args.variants and torch.device(args.device).type != "cuda":
        p.error("--variants times the CUDA block shapes: use --device cuda")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    print(card_line(device), flush=True)
    clock = bounds.max_sm_clock_hz(device) if device.type == "cuda" else None
    for variant in VARIANTS:
        ns = ns_per_iter(variant, args.N, device)
        line = f"{variant:>9}: {ns:8.1f} ns/iter"
        if clock is not None:
            line += f"  {bound_note(variant, args.N, clock)}"
        print(line, flush=True)
        if args.variants:
            for name, f_ns in forms_ns_per_iter(variant, args.N,
                                                device).items():
                print(f"{variant:>9} {name}: {f_ns:8.1f} ns/iter", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
