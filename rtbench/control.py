"""The readings that the limits of ``correct`` are set from.

    python3 -m rtbench.control --workload config5.orbit --seconds 3 \\
        --seeds 11 12 13 ... --control-seeds 11 12 13

For each seed, one run of the cell as `rtbench.run` makes it (the same
set-up, traffic and check, a shorter window) gives the program's numbers;
for each control seed the same run also gives the control's: the reference
computed in bfloat16, one step below the float32 the configuration states,
put in the program's place at the same frames and pixels. One JSON line a
seed, then a summary: the largest reading of the program and the smallest
of the control, number by number. The limits in
``rtbench/limits/<config>.<check>.json`` lie between the two (PERF.md).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seeds, control_seeds, seconds: float, device, log):
    """(one dict a seed, summary) of the program's and control's numbers."""
    from rtbench import harness

    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = harness.run(cell, seed, seconds, False, device, t0, log=log,
                          control=seed in control_seeds)
        rows.append({"seed": seed, "program": res.numbers,
                     "control": res.control_numbers,
                     "frames": res.attempted})
    program = {k: max(r["program"][k] for r in rows)
               for k in rows[0]["program"]}
    ctl = [r["control"] for r in rows if r["control"] is not None]
    control = {k: min(c[k] for c in ctl) for k in ctl[0]} if ctl else {}
    return rows, {"program_max": program, "control_min": control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    from rtbench.spec import load_cell

    if not torch.cuda.is_available():
        print("rtbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = load_cell(args.workload, with_limits=False)
    rows, summary = readings(cell, args.seeds, set(args.control_seeds),
                             args.seconds, device,
                             lambda m: print(m, file=sys.stderr, flush=True))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell.name, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
