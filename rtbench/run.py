"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench.run --workload ref_demo.orbit --seed 7 --seconds 10 --trace 0

Needs a CUDA card (as many as the cell's ``chips``) and ``nvcc``: without
them it exits 2 and prints no result. The program's kernel library is
built at first use into ``refraction_tpu_torch/_build/`` inside the
checkout; this module points the other caches a CUDA process may keep
(Triton's, PyTorch's extensions', CUDA's PTX JIT cache) at
``.rtbench_cache/`` inside the checkout, before torch is imported.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames enqueued in the window), ``failed`` (of them, frames
never delivered), ``metrics`` (with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones), ``device``, ``card``
(nvidia-smi's name and power limit), with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit. The same
numbers are the last lines on standard error. A run that prints its line
exits 0, correct or not.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from rtbench.spec import REPO  # noqa: E402

CACHE = os.path.join(REPO, ".rtbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True,
                   help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    from rtbench.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    import refraction_tpu_torch  # noqa: F401  the system under test

    if not torch.cuda.is_available():
        log("rtbench: no CUDA card: the benchmark measures the port on one")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"rtbench: {cell.name} needs {cell.chips} CUDA cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    from rtbench import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START, log=log)
    print(json.dumps(result.line()), flush=True)
    for line in result.lines:
        log(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
