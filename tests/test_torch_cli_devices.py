"""``python -m refraction_tpu_torch.run --devices N`` on the CPU: N shards of
each frame on the one CPU device (`parallel.sharding.make_mesh(n, "cpu")`)
write the PNG that one device writes, byte for byte, on both backends;
too few CUDA cards is a usage error (exit code 2) that names them."""

import logging

import pytest
import torch

from refraction_tpu.utils.stats import log as rt_log
from refraction_tpu_torch import run
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ball(tmp_path_factory):
    d = tmp_path_factory.mktemp("ball")
    return write_scene(str(d), "ball", make_icosphere(1, 1.2),
                       make_gradient_envmap(32, 64))


def _render(ball, out, backend, devices, caplog):
    obj, hdr = ball
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=rt_log.name):
        assert run.main(["--scene", obj, "--envmap", hdr, "--width", "40",
                         "--height", "12", "--bounces", "2", "--frames", "2",
                         "--backend", backend, "--devices", str(devices),
                         "--out", str(out), "--device", "cpu"]) == 0
    return [m for m in caplog.messages if m.startswith("pixel-DP")]


@pytest.mark.parametrize("backend,path", [("cuda", "fused kernel"),
                                          ("torch", "wavefront")])
def test_devices_on_the_cpu_write_the_one_device_files(ball, tmp_path,
                                                       caplog, backend, path):
    assert _render(ball, tmp_path / "one" / "f.png", backend, 1, caplog) == []
    want = [(tmp_path / "one" / f"f_{i:04d}.png").read_bytes()
            for i in range(2)]
    for n in (2, 3):
        lines = _render(ball, tmp_path / str(n) / "f.png", backend, n,
                        caplog)
        assert lines == [f"pixel-DP over {n} devices ({path})"]
        got = [(tmp_path / str(n) / f"f_{i:04d}.png").read_bytes()
               for i in range(2)]
        assert got == want


def test_too_few_cuda_cards_is_a_usage_error(ball, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    obj, hdr = ball
    with pytest.raises(SystemExit) as exc:
        run.main(["--scene", obj, "--envmap", hdr, "--devices", "2",
                  "--device", "cuda", "--out", str(tmp_path / "x.png")])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--devices 2" in err and "visible: cuda:0" in err
    assert not (tmp_path / "x.png").exists()
