"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run
(`harness.run`) on the CPU at a tiny size, with the cell's real limits,
after planting one fault in the program: a frame that returns its first
state unchanged, half of the batch left out (half the samples, the mean
taken over the rest; at one sample, half the rows), or an answer altered
where it is produced. A sound run of the same cell is correct. The cells
run on one card, so there is no exchange between cards to leave out."""

import time

import pytest
import torch

from rtbench import harness

CELLS = ["ref_demo.orbit", "config5.orbit", "config5.accumulate",
         "ref_demo.sync"]
SEED = 2 ** 31 + 77


def _run(tiny, name):
    return harness.run(tiny(name), SEED, 0.2, False,
                       torch.device("cpu"), time.perf_counter(),
                       log=lambda m: None)


def _stale(fn):
    first = {}

    def render(scene, scalars, cfg):
        if "img" not in first:
            first["img"] = fn(scene, scalars, cfg)
        return first["img"].clone()
    return render


def _half(fn):
    from refraction_tpu_torch.kernels.framekernel import N_BASE_SCALARS

    def render(scene, scalars, cfg):
        if cfg.spp > 1:
            half = cfg.spp // 2
            return fn(scene, scalars[:N_BASE_SCALARS + 2 * half],
                      cfg.replace(spp=half))
        img = fn(scene, scalars, cfg)
        img[1::2] = img[0::2][:img[1::2].shape[0]]
        return img
    return render


def _altered(fn):
    def render(scene, scalars, cfg):
        return fn(scene, scalars, cfg) * 0.98
    return render


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    res = _run(tiny, name)
    assert res.correct, res.lines
    assert res.failed == 0 and res.attempted >= harness.MIN_FRAMES


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_frame_path_is_not_correct(tiny, name, fault, monkeypatch):
    from refraction_tpu_torch import render

    monkeypatch.setattr(render, "fused_radiance", fault(render.fused_radiance))
    res = _run(tiny, name)
    assert not res.correct, res.lines


def test_accumulator_left_unchanged_is_not_correct(tiny, monkeypatch):
    from refraction_tpu_torch.render import Accumulator

    monkeypatch.setattr(Accumulator, "add", lambda self, img: None)
    res = _run(tiny, "config5.accumulate")
    assert not res.correct, res.lines
    assert any("acc_count_gap" in line and "FAIL" in line
               for line in res.lines)


def test_stale_host_copy_is_not_correct(tiny, monkeypatch):
    """The display copy delivered from a slot that is never refreshed."""
    from refraction_tpu_torch import run

    real = run.HostCopies.enqueue
    kept = {}

    def enqueue(self, img):
        out = real(self, img)
        kept.setdefault("u8", out[0].copy())
        return (kept["u8"], *out[1:])

    monkeypatch.setattr(run.HostCopies, "enqueue", enqueue)
    res = _run(tiny, "ref_demo.orbit")
    assert not res.correct, res.lines
