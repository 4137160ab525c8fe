"""The command: without a card it exits non-zero and prints no result; on
a card (``cuda``) a short run of each cell prints its line, correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rtbench import spec

CMD = [sys.executable, "-m", "rtbench.run", "--seed", str(2 ** 31 + 3),
       "--seconds", "2"]


def _run(workload, trace, cwd=spec.REPO, env=None):
    return subprocess.run(CMD + ["--workload", workload, "--trace",
                                 str(trace)], cwd=cwd, capture_output=True,
                          text=True, timeout=600, env=env)


def test_without_a_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = _run("ref_demo.orbit", 0, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and rtbench/."""
    shutil.copy(spec.BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run("ref_demo.orbit", 0, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "refraction_tpu_torch" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_bench()["workloads"]])
def test_cell_on_the_card(cuda, workload, trace):
    proc = _run(workload, trace)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    cell = spec.load_cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["breakdown"]["device_ops"]
