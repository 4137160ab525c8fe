"""refraction_tpu_torch as a package: no JAX and nothing of the JAX
package, exact scene upload, and no silent fallback when the CUDA
toolchain or card is missing."""

import ast
import glob
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

# Every Python file of the port, and the chip smoke script.
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "refraction_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
# Top-level names the port may not import: JAX, the JAX package, the oracle.
FORBIDDEN = ("jax", "jaxlib", "refraction_tpu", "oracle")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_jax_or_the_jax_package(path):
    """An AST scan: no ``import`` or ``from`` of jax, jaxlib,
    refraction_tpu (or refraction_tpu.*) or oracle, at any depth (function
    bodies included)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and _forbidden(node.module or "")):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


_NOTHING_OF_JAX_SCRIPT = """
import importlib, pkgutil, sys
import refraction_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(refraction_tpu_torch.__path__,
                                              "refraction_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
need = {"run", "bench", "viewer", "profile_rounds", "mxu_mt_bench",
        "stallbench", "config", "camera", "scene", "io.objmesh",
        "io.texture", "io.hdr", "io.png", "io.mtl", "io.primitives",
        "bvh.morton", "bvh.clusters", "bvh.lbvh", "parallel.sharding",
        "utils.stats"}
missing = {"refraction_tpu_torch." + m for m in need} - set(mods)
assert not missing, missing
# The CLI on the CPU at a tiny size, from files the port writes itself.
import tempfile
from refraction_tpu_torch import run
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.io.primitives import make_gradient_envmap, make_icosphere
tmp = tempfile.mkdtemp()
obj, hdr = write_scene(tmp, "ball", make_icosphere(1, 1.2),
                       make_gradient_envmap(16, 32))
assert run.main(["--scene", obj, "--envmap", hdr, "--width", "8",
                 "--height", "6", "--device", "cpu",
                 "--out", tmp + "/f.png"]) == 0
bad = sorted(m for m in sys.modules
             if m in ("jax", "refraction_tpu", "oracle")
             or m.startswith("refraction_tpu."))
assert not bad, bad
print(len(mods), "modules")
"""


def test_package_imports_nothing_of_the_jax_package():
    """A fresh process imports the package and every submodule and runs
    the CLI on the CPU; no key of sys.modules is then jax, refraction_tpu,
    refraction_tpu.* or oracle."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NOTHING_OF_JAX_SCRIPT],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 36

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
from refraction_tpu_torch.io.primitives import make_cube, make_gradient_envmap
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


def test_frame_times_needs_cuda(monkeypatch):
    """The timing tool has no CPU path: without CUDA it raises before it
    loads anything."""
    from refraction_tpu_torch import frame_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frame_times.main(["--scene", "missing.obj"])


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
