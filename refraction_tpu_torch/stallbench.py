"""Traversal-primitive instrument: ns per iteration of each structural
primitive, port of ``tools/stallbench.py``.

For each variant of kernels/stallbench.py (vecops, tree, extract, while2,
loads72, subplane) it runs N iterations over the (8, 128) carry
(``sm = arange(1024)``, ``x = ones``) once to warm up, then 5 times, and
prints the best time over N as ``<variant>: ... ns/iter`` after a first
line naming the card:

    python -m refraction_tpu_torch.stallbench [N]          # N = 200,000
    python -m refraction_tpu_torch.stallbench 32 --device cpu

On ``--device cuda`` the times are CUDA events around each launch; on
``--device cpu`` the plain version runs under the host clock.
``--device cuda`` without CUDA is an error. Each variant is launched
``1 + REPS`` times.
"""

from __future__ import annotations

import argparse

import torch

from refraction_tpu_torch.kernels.stallbench import (
    PLANE,
    TABLE,
    VARIANTS,
    stall_iters,
)
from refraction_tpu_torch.timing import card_line, require_device, time_ms

DEFAULT_N = 200_000
REPS = 5


def ns_per_iter(variant: str, n_iter: int, device: torch.device,
                reps: int = REPS) -> float:
    """Best of ``reps`` timed runs of ``n_iter`` iterations, after one
    warm-up run, in ns per iteration."""
    sm = torch.arange(TABLE, dtype=torch.float32, device=device)
    x = torch.ones(PLANE, dtype=torch.float32, device=device)
    stall_iters(variant, n_iter, sm, x)
    best = min(time_ms(lambda: stall_iters(variant, n_iter, sm, x), device)
               for _ in range(reps))
    return best * 1e6 / n_iter


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("N", nargs="?", type=int, default=DEFAULT_N,
                   help=f"iterations per run (default {DEFAULT_N:,})")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    print(card_line(device), flush=True)
    for variant in VARIANTS:
        ns = ns_per_iter(variant, args.N, device)
        print(f"{variant:>9}: {ns:8.1f} ns/iter", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
