"""refraction_tpu_torch frame module (kernels/framekernel.py) vs the JAX
fused frame kernel.

On CPU tensors ``fused_radiance`` takes its plain version (the eager
integrator fed the kernel's rays); the JAX side is the Pallas frame kernel
in interpret mode. Flip budget (PARITY.md §4): the Pallas kernel uses
polynomial atan2/acos and a front-to-back cluster order, so a few pixels
may pick a neighbouring texel or an equal-t winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from refraction_tpu.camera import orbit_camera
from refraction_tpu.config import RenderConfig
from refraction_tpu.kernels.framekernel import build_scalars as jax_build_scalars
from refraction_tpu.kernels.framekernel import render_frame_fused
from refraction_tpu.render import sample_offsets
from refraction_tpu_torch.kernels.framekernel import build_scalars, fused_radiance
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

RMSE_BAR = 1e-4
FLIP_TOL, MAX_FLIPS = 1e-3, 8


def test_fused_radiance_matches_pallas_frame_kernel(sphere_scene):
    scene, _ = sphere_scene
    cfg = RenderConfig(width=32, height=32)
    frame = orbit_camera(0.85, cfg)
    ref = np.asarray(render_frame_fused(
        jax.tree.map(jnp.asarray, scene), frame, cfg, interpret=True))
    got = fused_radiance(scene_from_jax(scene, "cpu"),
                         build_scalars(frame, cfg, sample_offsets(1), "cpu"),
                         cfg).numpy()
    assert got.shape == ref.shape == (32, 32, 3)
    assert ref.max() > 0
    assert rmse(got, ref) < RMSE_BAR
    flips = (np.abs(got - ref).max(axis=-1) > FLIP_TOL).sum()
    assert flips <= MAX_FLIPS, flips


@pytest.mark.parametrize("spp", [1, 4, 5])
def test_build_scalars_matches_jax(spp):
    cfg = RenderConfig(width=64, height=48, spp=spp, ior=1.45)
    frame = orbit_camera(0.3, cfg)
    offs = sample_offsets(spp)
    got = build_scalars(frame, cfg, offs, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_build_scalars(frame, cfg, offs)))
