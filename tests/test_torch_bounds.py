"""bounds.py of refraction_tpu_torch against the definitions it states: a
bound is the largest of the bytes' time, the FP32 operations' time and
the tensor-core operations' time; the env kernel's bytes count a sector
per live lookup; the fold kernel's count what its masks name. And
kernels.envmap.check_envmap, which guards the map the kernels read.
"""

import pytest
import torch

from refraction_tpu_torch import bounds
from refraction_tpu_torch.io.primitives import make_cube, make_gradient_envmap
from refraction_tpu_torch.kernels.envmap import (
    check_envmap,
    env_contribution,
    env_contribution_plain,
)
from refraction_tpu_torch.scene import build_scene, scene_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")


def small_scene(h: int, w: int):
    return scene_from_jax(
        build_scene(make_cube(2.0), make_gradient_envmap(h, w), 8)[0], "cpu")


@pytest.mark.parametrize("ops,nbytes,tensor_ops,side,want_ms", [
    (67e9, 3.35e6, 0, "operations", 1.0),       # FP32 1 ms, bytes 0.001
    (67e6, 3.35e9, 495e6, "bytes", 1.0),        # bytes 1 ms
    (67e6, 3.35e6, 495e9, "operations", 1.0),   # tensor cores 1 ms
    (67e9, 3.35e6, 495e9, "operations", 1.0),   # both pipes 1 ms: not 2
], ids=["fp32", "bytes", "tensor", "pipes-do-not-add"])
def test_bound_is_the_largest_of_three_times(ops, nbytes, tensor_ops, side,
                                             want_ms):
    b = bounds.bound(ops, nbytes, tensor_ops)
    assert b["bound_by"] == side
    assert b["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])
    assert b["ops"] == int(ops + tensor_ops) and b["bytes"] == int(nbytes)


@pytest.mark.parametrize("n,live", [(65536, 52000), (786432, 78000),
                                    (3145728, 310000), (100, 0)])
def test_env_bound_counts_a_sector_per_live_lookup(n, live):
    """A live ray: 16 bytes in, 12 out and a 32-byte sector of the map, at
    most the map; a ray of weight 0: its 4-byte weight in, 12 bytes out;
    17 operations per live ray."""
    ts = small_scene(256, 512)
    map_bytes = 256 * 512 * 3 * 4
    assert bounds.env_bytes(ts) == map_bytes
    b = bounds.env_bound(ts, n, live)
    assert b["bytes"] == (live * 28 + min(map_bytes, 32 * live)
                          + (n - live) * 16)
    assert b["ops"] == 17 * live
    assert b["bound_ms"] == pytest.approx(
        max(b["bytes"] / 3.35e12, b["ops"] / 67e12) * 1e3)
    # Far below the whole map read once, which the bound used to charge.
    if 32 * live < map_bytes:
        assert b["bytes"] < n * 28 + map_bytes


@pytest.mark.parametrize("n_pix,named,touched", [
    (786_432, 314_801, 270_000), (16, 0, 0), (1000, 4000, 1000)],
    ids=["a-tenth-named", "empty-round", "every-slot"])
def test_fold_bound_counts_what_the_masks_name(n_pix, named, touched):
    """Every mask read (4 bytes); a named slab row 12 bytes in; a touched
    pixel's mask cleared (4) and its radiance read and written (24); three
    adds per row and three per touched pixel."""
    b = bounds.fold_bound(n_pix, named, touched)
    assert b["bytes"] == 4 * n_pix + 12 * named + 28 * touched
    assert b["ops"] == 3 * (named + touched)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


def test_check_envmap_wants_the_float32_map():
    ts = small_scene(8, 16)
    check_envmap(ts, CPU)
    for bad in (ts.envmap.double(), ts.envmap[:, :, :2], ts.envmap[:, ::2],
                ts.envmap.reshape(-1, 3)):
        with pytest.raises(ValueError, match=r"scene\.envmap:"):
            check_envmap(ts._replace(envmap=bad), CPU)
    with pytest.raises(ValueError, match=r"scene\.envmap:"):
        check_envmap(ts, torch.device("meta"))
    # On CPU tensors the wrapper takes the gather.
    d = torch.nn.functional.normalize(torch.randn(
        10, 3, generator=torch.Generator().manual_seed(0)), dim=1)
    w = torch.rand(10, generator=torch.Generator().manual_seed(1))
    before = env_contribution.launches
    assert torch.equal(env_contribution(ts, d, w),
                       env_contribution_plain(ts, d, w))
    assert env_contribution.launches == before


@pytest.mark.parametrize("variant,chain", [
    ("vecops", 128), ("tree", 3), ("extract", 2), ("while2", 8),
    ("loads72", 72), ("subplane", 5)])
def test_stall_bound_latency_floor_on_a_fixed_clock(variant, chain):
    """At 1.98 GHz and N = 200,000 every variant's dependent chain outlasts
    its throughput floor: the bound is n_iter x chain x 4 cycles / clock,
    by latency (vecops: 128 x 4 / 1.98 GHz ~ 258.6 ns/iter, ~51.7 ms)."""
    clock, n = 1.98e9, 200_000
    b = bounds.stall_bound(variant, n, clock)
    assert bounds.STALL_CHAIN_OPS[variant] == chain
    want = n * chain * bounds.FP32_LATENCY_CYCLES / clock * 1e3
    assert b["latency_ms"] == pytest.approx(want, rel=1e-12)
    assert b["bound_by"] == "latency" and b["bound_ms"] == b["latency_ms"]
    assert b["ops_ms"] < b["latency_ms"]
    assert b["ops"] == bounds.STALL_ITER_OPS[variant] * 1024 * n
    assert b["bytes"] == 3 * 4 * 1024
    if variant == "vecops":
        assert b["bound_ms"] == pytest.approx(51.7, rel=1e-3)
        assert b["bound_ms"] * 1e6 / n == pytest.approx(258.6, rel=1e-3)


def test_stall_bound_keeps_the_larger_floor():
    """On a clock fast enough that the chain's latency is below the
    card's throughput floor, the throughput floor stays, by operations."""
    b = bounds.stall_bound("vecops", 64, 1e15)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == b["ops_ms"] > b["latency_ms"]


def test_max_sm_clock_reads_nvidia_smi(monkeypatch):
    class Done:
        stdout = "1980 MHz\n1755 MHz\n"

    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return Done()

    monkeypatch.setattr(bounds.subprocess, "run", fake_run)
    assert bounds.max_sm_clock_hz(torch.device("cuda", 0)) == 1.98e9
    assert bounds.max_sm_clock_hz(torch.device("cuda", 1)) == 1.755e9
    assert seen[0][1] == "--query-gpu=clocks.max.sm"
    Done.stdout = "[N/A]\n"
    with pytest.raises(ValueError):
        bounds.max_sm_clock_hz(torch.device("cuda", 0))
