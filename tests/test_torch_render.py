"""The refraction_tpu_torch slice as a whole: make_renderer vs the JAX
renderer (xla backend) and the NumPy oracle, and the CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction_tpu.config import RenderConfig
from refraction_tpu.io.png import load_png
from refraction_tpu.io.primitives import make_gradient_envmap, make_icosphere
from refraction_tpu.kernels.framekernel import fits_smem
from refraction_tpu.render import render_frame as jax_render_frame
from refraction_tpu.scene import auto_cluster_size, build_scene
from refraction_tpu_torch import run
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.render import make_renderer, rays_per_frame
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3  # tests/test_golden.py


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("size", [(48, 36), (40, 30)])
def test_make_renderer_matches_jax_and_oracle(sphere_scene, size, backend):
    """Both backends on CPU tensors: "torch" is the eager integrator,
    "cuda" the frame kernel's wrapper, which takes its plain version."""
    scene, _ = sphere_scene
    w, h = size
    cfg = RenderConfig(width=w, height=h, backend="xla")
    frame = orbit_camera(0.85, cfg)
    img = make_renderer(cfg, backend, "cpu")(scene_from_jax(scene, "cpu"),
                                             frame)
    assert img.shape == (h, w, 3) and img.device.type == "cpu"
    img = img.numpy()
    ref_j = np.asarray(jax_render_frame(jax.tree.map(jnp.asarray, scene), cfg,
                                        frame=frame))
    ref_o = render_oracle(scene, cfg, frame=frame)
    for ref in (ref_j, ref_o):
        assert rmse(img, ref) < RMSE_BAR
        assert np.abs(img - ref).max() < MAX_BAR


def test_scene_past_tpu_scalar_memory_budget():
    """The 81,920-triangle icosphere, whose tables exceed the TPU's 1 MB
    scalar-memory budget (the JAX path streams it): the port's frame path
    has one code path at every size; its CPU version matches the oracle."""
    mesh = make_icosphere(6, 1.2)
    scene, _ = build_scene(mesh, make_gradient_envmap(32, 64),
                           auto_cluster_size(mesh.num_tris))
    assert not fits_smem(scene)
    cfg = RenderConfig(width=12, height=9, max_refract_depth=4)
    frame = orbit_camera(0.3, cfg)
    img = make_renderer(cfg, "cuda", "cpu")(scene_from_jax(scene, "cpu"),
                                            frame).numpy()
    ref = render_oracle(scene, cfg, frame=frame)
    assert rmse(img, ref) < RMSE_BAR
    assert np.abs(img - ref).max() < MAX_BAR


def test_rays_per_frame_bound():
    # widths 1, 2, 4, 4, 4, 4 -> 19 rays per pixel at the default caps
    assert rays_per_frame(RenderConfig(width=10, height=10)) == 100 * 19


def test_cli_renders_png_on_cpu(tmp_path):
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(32, 64))
    out = tmp_path / "f.png"
    rc = run.main(["--scene", obj, "--envmap", hdr, "--width", "32",
                   "--height", "24", "--bounces", "3", "--frames", "1",
                   "--out", str(out), "--raw", "--device", "cpu"])
    assert rc == 0
    img = load_png(str(out))
    assert img.shape == (24, 32, 3)
    assert img.max() > img.min()
    raw = np.load(tmp_path / "f.npy")
    assert raw.shape == (24, 32, 3) and np.isfinite(raw).all()
    # The u8 display transform of the raw radiance is what was written.
    np.testing.assert_array_equal(
        run.to_u8(torch.from_numpy(raw)).numpy(), img)
