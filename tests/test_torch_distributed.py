"""refraction_tpu_torch.parallel.distributed on the CPU: the two-process
runs of tests/test_distributed.py over gloo (frame sharding, pixel-DP
of the frame kernel), each held against the JAX package, and the module's
pieces in one process.

Each rank is a real process (``python -m ...`` or a small ``python -c``
script) with one CPU thread; the ranks find each other through a free
localhost port. The global checksum can agree on both ranks only if the
stats sum crossed the process boundary. Tolerances: the frame checksum
against the JAX package's frames, absolute 1e-4 per frame (the golden
bar, tests/test_golden.py: RMSE < 1e-4); the global sum against the two
locals, relative 1e-6 (one float32 add); pixel-DP images bit for bit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from refraction_tpu.camera import orbit_camera as jax_orbit_camera
from refraction_tpu.config import RenderConfig as JaxRenderConfig
from refraction_tpu.parallel.distributed import (
    frames_for_process as jax_frames_for_process,
)
from refraction_tpu.render import make_renderer as jax_make_renderer
from refraction_tpu_torch.parallel import distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4
FRAME_W, FRAME_H = 32, 24
CHECKSUM_ATOL = 1e-4  # per frame

# Rank script for render_fused_dp_distributed with devices=make_mesh(L,
# "cpu"): argv L, rank, port. It records every frame_tiles launch (stride,
# base, n_local) and prints the stats and the launches as one JSON line.
RANK_SCRIPT = r"""
import json, sys
import torch
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap, make_icosphere)
from refraction_tpu_torch.parallel import distributed
from refraction_tpu_torch.parallel.sharding import make_mesh
from refraction_tpu_torch.scene import build_scene

n_dev, rank, port = (int(a) for a in sys.argv[1:4])
calls = []
launch = distributed.frame_tiles

def recorded(scene, scal, cfg, stride, base, n_local, n_tiles):
    calls.append([stride, base, n_local])
    return launch(scene, scal, cfg, stride, base, n_local, n_tiles)

distributed.frame_tiles = recorded
scene = build_scene(make_icosphere(subdiv=2, radius=1.2),
                    make_gradient_envmap(64, 128), cluster_size=32)[0]
cfg = RenderConfig(width=64, height=48, cluster_size=32)
distributed.init_distributed(f"127.0.0.1:{port}", 2, rank)
try:
    stats = distributed.render_fused_dp_distributed(
        cfg, 0.35, scene, device="cpu", devices=make_mesh(n_dev, "cpu"))
    print(json.dumps({**stats, "calls": calls}), flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argv_of, timeout=300):
    """Start rank 0 and rank 1 (``argv_of(rank, port)``), wait for both;
    on a timeout kill both and raise. Returns [(returncode, stdout,
    stderr)] in rank order."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, *argv_of(rank, port)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _cli(*extra):
    def argv_of(rank, port):
        return ["-m", "refraction_tpu_torch.parallel.distributed",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(rank), "--device", "cpu", *extra]
    return argv_of


def _last_json(results):
    outs = []
    for rc, out, err in results:
        assert rc == 0, f"rank failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.fixture(scope="module")
def frame_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frames")

    def argv_of(rank, port):
        return _cli("--frames", str(N_FRAMES), "--width", str(FRAME_W),
                    "--height", str(FRAME_H),
                    "--out", str(tmp / f"out{rank}"))(rank, port)

    return tmp, _last_json(_run_ranks(argv_of))


@pytest.fixture(scope="module")
def fused_dp_run():
    return _last_json(_run_ranks(_cli("--fused-dp", "--width", "64",
                                      "--height", "48")))


def test_two_process_frame_sharding(frame_run):
    """tests/test_distributed.py::test_two_process_frame_sharding's
    assertions."""
    tmp, (s0, s1) = frame_run
    assert s0["frames_rendered_local"] + s1["frames_rendered_local"] \
        == N_FRAMES
    assert s0["frames_rendered_global"] == N_FRAMES
    assert s1["frames_rendered_global"] == N_FRAMES
    assert s0["checksum_global"] == pytest.approx(s1["checksum_global"])
    assert s0["checksum_global"] == pytest.approx(
        s0["checksum_local"] + s1["checksum_local"], rel=1e-6)
    assert s0["checksum_global"] > 0
    got = sorted(p.name for d in (tmp / "out0", tmp / "out1")
                 if d.exists() for p in d.iterdir())
    assert got == [f"frame_{k:04d}.png" for k in range(N_FRAMES)]
    # On the CPU, "auto" is the eager integrator: no kernel launch.
    assert s0["device"] == s1["device"] == "cpu"
    assert s0["launches"] == {"fused_radiance": 0, "frame_tiles": 0}


def test_frame_checksum_matches_the_jax_package(frame_run, sphere_scene):
    """The CLI's default scene is tests/conftest.py's sphere_scene (an
    icosphere(2, 1.2), a 64x128 gradient map, clusters of 32): the JAX
    renderer (xla) over the same orbit angles, frame means summed."""
    _, (s0, _) = frame_run
    cfg = JaxRenderConfig(width=FRAME_W, height=FRAME_H, backend="xla",
                          cluster_size=32)
    render = jax_make_renderer(cfg)
    want = sum(float(np.asarray(render(
        sphere_scene[0], jax_orbit_camera(0.01 + 0.01 * k, cfg))).mean())
        for k in range(N_FRAMES))
    assert abs(s0["checksum_global"] - want) < CHECKSUM_ATOL * N_FRAMES


def test_two_process_fused_dp(fused_dp_run):
    """tests/test_distributed.py::test_two_process_fused_dp's assertions:
    4 tiles, 2 per rank."""
    s0, s1 = fused_dp_run
    assert s0["devices_global"] == s1["devices_global"] == 2
    assert s0["sha256"] == s1["sha256"]
    assert s0["mean"] > 0
    assert s0["matches_single_device"] and s1["matches_single_device"]


def test_fused_dp_over_two_cpu_shards_a_rank():
    """devices=make_mesh(2, "cpu") on each rank: S = 4, rank r's local
    device j renders shard 2r + j, one tile each; the image is the
    one-device render's bit for bit on both ranks."""
    argv_of = (lambda rank, port: ["-c", RANK_SCRIPT, "2", str(rank),
                                   str(port)])
    s0, s1 = _last_json(_run_ranks(argv_of))
    assert s0["devices_global"] == s1["devices_global"] == 4
    assert s0["calls"] == [[4, 0, 1], [4, 1, 1]]
    assert s1["calls"] == [[4, 2, 1], [4, 3, 1]]
    assert s0["sha256"] == s1["sha256"]
    assert s0["matches_single_device"] and s1["matches_single_device"]


def test_unequal_local_device_counts_raise_on_every_rank():
    """Rank 0 passes one CPU device, rank 1 two: both raise after the one
    gather of the counts, before any launch."""
    argv_of = (lambda rank, port: ["-c", RANK_SCRIPT, str(rank + 1),
                                   str(rank), str(port)])
    for rc, out, err in _run_ranks(argv_of):
        assert rc != 0 and out == ""
        assert "ValueError: local device counts differ across processes: " \
               "[1, 2]" in err


@pytest.mark.parametrize("procs", [1, 2, 3, 4, 5])
def test_frames_for_process_equals_the_jax_partition(procs):
    for n_frames in range(10):
        for pid in range(procs):
            assert distributed.frames_for_process(n_frames, pid, procs) \
                == jax_frames_for_process(n_frames, pid, procs)


def test_png_tone_map_equals_the_jax_formula():
    """Below 0 (NaN after the power: both cast it the same way), inside
    [0, 1] and above 1."""
    rng = np.random.default_rng(10)
    img = rng.uniform(-0.5, 2.0, (16, 16, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, -0.0]
    with np.errstate(invalid="ignore"):
        want = np.clip(img ** (1 / 2.2) * 255.0 + 0.5, 0, 255
                       ).astype(np.uint8)
        got = distributed.to_png_u8(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_process_device_rule(monkeypatch):
    assert distributed.process_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="negative"):
        distributed.process_device("cpu", -1)
    for bad in ("meta", "cuda:1"):
        with pytest.raises(ValueError, match="device type"):
            distributed.process_device(bad, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [distributed.process_device("cuda", r) for r in range(4)] == [
        torch.device("cuda", i) for i in (0, 1, 0, 1)]


def test_process_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.process_device("cuda", 0)


def test_cli_without_cuda_raises_before_joining(monkeypatch):
    """A rank that finds no CUDA raises before it waits for its peers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed, "init_distributed",
                        lambda *a: pytest.fail("joined the group"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed._main(["--coordinator", "127.0.0.1:1",
                           "--num-processes", "2", "--process-id", "0"])


@pytest.mark.parametrize("pid", [-1, 2])
def test_init_distributed_rejects_a_process_id_outside_the_group(pid):
    with pytest.raises(ValueError, match="outside"):
        distributed.init_distributed("127.0.0.1:1", 2, pid)
    assert not torch.distributed.is_initialized()


def test_global_stats_psum_on_one_rank(tmp_path):
    """A group of one (file store): the sum is the input, float32, as the
    JAX psum returns it."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    try:
        got = distributed._global_stats_psum([2.0, 0.1])
    finally:
        torch.distributed.destroy_process_group()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.float32([2.0, 0.1]))
