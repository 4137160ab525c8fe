"""refraction_tpu_torch as a package: no JAX, exact scene upload, and no
silent fallback when the CUDA toolchain or card is missing."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refraction_tpu.io.objmesh import parse_obj
from refraction_tpu.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu.scene import build_scene
from refraction_tpu_torch import run
from refraction_tpu_torch.fixtures import write_obj
from refraction_tpu_torch.kernels import _build
from refraction_tpu_torch.kernels.intersect import closest_hit
from refraction_tpu_torch.scene import UPLOADED, scene_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SCRIPT = """
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import refraction_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(refraction_tpu_torch.__path__,
                                              "refraction_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from refraction_tpu_torch import RenderConfig
from refraction_tpu_torch.fixtures import make_cube, make_gradient_envmap
from refraction_tpu_torch.render import render_frame
from refraction_tpu_torch.scene import build_scene, scene_from_jax
scene = scene_from_jax(build_scene(make_cube(2.0), make_gradient_envmap(),
                                   8)[0], "cpu")
img = render_frame(scene, RenderConfig(width=16, height=16), angle=0.3)
assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
# The modules of the instrument path and the CLI flags, driven once.
new = {"refraction_tpu_torch.kernels.mtbench",
       "refraction_tpu_torch.kernels.stallbench",
       "refraction_tpu_torch.mxu_mt_bench", "refraction_tpu_torch.stallbench",
       "refraction_tpu_torch.timing"}
assert new <= set(mods), new - set(mods)
from refraction_tpu_torch.kernels.mtbench import make_inputs, mt_args, mt_visits
from refraction_tpu_torch.kernels.stallbench import stall_iters
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.render import Accumulator, render_heatmap
t, i = mt_visits(*mt_args(make_inputs(0), "cpu"), 2)
out = stall_iters("subplane", 2, torch.arange(1024.0), torch.ones(8, 128))
cfg = RenderConfig(width=8, height=6)
heat = render_heatmap(scene, cfg, orbit_camera(0.3, cfg), "cpu")
assert heat.shape == (6, 8) and heat.min() >= 1
Accumulator(6, 8).add(img.numpy()[:6, :8])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(mods), "modules")
"""


def test_package_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 22  # every module was imported


@pytest.mark.parametrize("as_jax", [False, True])
def test_scene_from_jax_is_exact(as_jax):
    scene, _ = build_scene(make_cube(2.0), make_gradient_envmap(), 8)
    src = scene
    if as_jax:
        src = jax.tree.map(jnp.asarray, scene)
    ts = scene_from_jax(src, "cpu")
    for name in UPLOADED:
        ref = np.asarray(getattr(scene, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == (np.int32 if name == "tri_mask" else np.float32)
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert ts.cluster_size * ts.num_clusters == ts.num_tris


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_cli_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--device", "cuda", "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_wrapper_checks_its_inputs():
    scene = scene_from_jax(
        build_scene(make_cube(2.0), make_gradient_envmap(), 8)[0], "cpu")
    o = torch.zeros(4, 3)
    d = torch.zeros(3, 4).t()  # right shape, not contiguous
    with pytest.raises(ValueError, match="dirs"):
        closest_hit(scene, o, d, torch.ones(4), 1e-4, 100.0)
    with pytest.raises(ValueError, match="cull"):
        closest_hit(scene, o, o, torch.ones(4, dtype=torch.float64),
                    1e-4, 100.0)


@pytest.mark.parametrize("mesh", [make_cube(2.0), make_icosphere(2, 1.2)],
                         ids=["cube", "icosphere"])
def test_write_obj_round_trips(tmp_path, mesh):
    path = str(tmp_path / "m.obj")
    write_obj(path, mesh)
    back = parse_obj(path, allow_native=False)
    np.testing.assert_array_equal(back.positions, mesh.positions)
    np.testing.assert_array_equal(back.normals, mesh.normals)
