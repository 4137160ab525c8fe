"""Sub-visit instrument: Möller–Trumbore vs Woop on one 8-triangle sub
visit, port of ``tools/mxu_mt_bench.py``.

Four kernels (kernels/mtbench.py) run V and then 4V sub visits over the
tool's 1,024 rays (`make_inputs(0)`): ``mt`` (Möller–Trumbore), ``woop``
(the Woop product on CUDA cores), ``woop_tc`` and ``woop_tc3`` (the
product on the tensor cores, in one TF32 pass or as 3xTF32). The first
line is the card; then one parity line per Woop form against ``mt`` (hit
share of each kernel, share of the MT hits whose t agree to rtol 1e-3 and
whose winner index is equal), and per kernel the per-visit cost as the slope between V and 4V of the median call time
over ``reps`` calls, which removes the per-call launch cost:

    python -m refraction_tpu_torch.mxu_mt_bench [V] [reps]      # 512 50
    python -m refraction_tpu_torch.mxu_mt_bench 8 2 --device cpu

On ``--device cuda`` the times are CUDA events around each launch; on
``--device cpu`` the plain versions run under the host clock.
``--device cuda`` without CUDA is an error. Each kernel is launched
``2 + 2 * reps`` times (`launches_per_kernel`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from refraction_tpu_torch.kernels.mtbench import (
    make_inputs,
    mt_args,
    mt_visits,
    woop_args,
    woop_visits,
    woop_visits_tc,
    woop_visits_tc3,
)
from refraction_tpu_torch.timing import card_line, require_device, time_ms

DEFAULT_V = 512
DEFAULT_REPS = 50
HIT_T = 1e29  # t below this is a hit (misses end at 1e30)


def launches_per_kernel(reps: int) -> int:
    """Kernel launches `main` makes per kernel: one call at V and one at
    4V before the parity line, then ``reps`` timed calls at each."""
    return 2 + 2 * reps


def parity(mt_out, woop_out) -> dict:
    """The tool's parity figures: hit shares, and over the MT hits the
    share with t equal to rtol 1e-3 and the share with equal index."""
    vt, vi = (x.cpu().numpy() for x in mt_out)
    wt, wi = (x.cpu().numpy() for x in woop_out)
    hit = vt < HIT_T
    return {"hits_mt": float(hit.mean()), "hits_woop": float((wt < HIT_T).mean()),
            "t_match": float(np.isclose(vt[hit], wt[hit], rtol=1e-3).mean()),
            "i_match": float((vi[hit] == wi[hit]).mean())}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("V", nargs="?", type=int, default=DEFAULT_V,
                   help=f"sub visits of the first size (default {DEFAULT_V})")
    p.add_argument("reps", nargs="?", type=int, default=DEFAULT_REPS,
                   help=f"timed calls per size (default {DEFAULT_REPS})")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    print(card_line(device), flush=True)
    v, v2 = args.V, args.V * 4
    inp = make_inputs(0)
    woop_a = woop_args(inp, device)
    kernels = (("mt", mt_visits, mt_args(inp, device)),
               ("woop", woop_visits, woop_a),
               ("woop_tc", woop_visits_tc, woop_a),
               ("woop_tc3", woop_visits_tc3, woop_a))
    outs = [fn(*a, v) for _, fn, a in kernels]
    for _, fn, a in kernels:
        fn(*a, v2)
    for (name, _, _), out in zip(kernels[1:], outs[1:]):
        p = parity(outs[0], out)
        print(f"hits mt={p['hits_mt']:.3f} {name}={p['hits_woop']:.3f} "
              f"t match={p['t_match']:.4f} i match={p['i_match']:.4f}",
              flush=True)

    def med_ms(fn, a, visits):
        ts = sorted(time_ms(lambda: fn(*a, visits), device)
                    for _ in range(args.reps))
        return ts[len(ts) // 2]

    for name, fn, a in kernels:
        m1, m2 = med_ms(fn, a, v), med_ms(fn, a, v2)
        print(f"{name}: slope {(m2 - m1) * 1e6 / (v2 - v):8.1f} ns/visit  "
              f"(V={v}: {m1:.3f} ms, V={v2}: {m2:.3f} ms)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
