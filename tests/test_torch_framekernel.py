"""refraction_tpu_torch frame module (kernels/framekernel.py) vs the JAX
fused frame kernel.

On CPU tensors ``fused_radiance`` takes its plain version (the eager
integrator fed the kernel's rays); the JAX side is the Pallas frame kernel
in interpret mode. Flip budget (PARITY.md §4): the Pallas kernel uses
polynomial atan2/acos and a front-to-back cluster order, so a few pixels
may pick a neighbouring texel or an equal-t winner.

The wrappers' input checks, which a CUDA launch runs first, are held here
on CPU tensors, and the wrapper's constants and entries against
csrc/frame.cu.
"""

import os
import re

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
from refraction_tpu_torch import RenderConfig as TorchRenderConfig
from refraction_tpu_torch.camera import orbit_camera as torch_orbit_camera
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap, make_icosphere)
from refraction_tpu_torch.kernels import _build, framekernel
from refraction_tpu_torch.kernels.framekernel import (
    MAX_STACK, TILE, build_scalars, frame_tiles, fused_radiance)
from refraction_tpu_torch.scene import build_scene, scene_from_jax

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


def _small_scene():
    return scene_from_jax(build_scene(make_icosphere(1, 1.2),
                                      make_gradient_envmap(16, 32), 8)[0],
                          "cpu")


def _scalars(cfg):
    return build_scalars(torch_orbit_camera(0.3, cfg), cfg,
                         sample_offsets(cfg.spp), "cpu")


_GOOD = TorchRenderConfig(width=40, height=8)
# case -> (scene edit, scalars, cfg, message the refusal names; None: pass)
_FRAME_ARG_CASES = {
    "well_formed": (None, lambda: _scalars(_GOOD), _GOOD, None),
    "float64_scalars": (None, lambda: _scalars(_GOOD).double(), _GOOD,
                        "scalars"),
    "spp2_scalars_under_spp1": (
        None, lambda: _scalars(_GOOD.replace(spp=2)), _GOOD, "scalars"),
    "strided_scalars": (
        None, lambda: torch.zeros(2 * _scalars(_GOOD).numel())[::2], _GOOD,
        "scalars"),
    "caps_8_8_over_the_stack": (
        None, lambda: _scalars(_GOOD),
        _GOOD.replace(max_refract_depth=8, max_reflect_depth=8),
        "stack of 9"),
    "negative_refract_cap": (
        None, lambda: _scalars(_GOOD), _GOOD.replace(max_refract_depth=-1),
        "bounce caps"),
    "width_0": (None, lambda: _scalars(_GOOD), _GOOD.replace(width=0),
                "frame shape"),
    "float64_tri_packed": (
        lambda sc: sc._replace(tri_packed=sc.tri_packed.double()),
        lambda: _scalars(_GOOD), _GOOD, "tri_packed"),
}


@pytest.mark.parametrize("case", list(_FRAME_ARG_CASES))
def test_frame_args_are_checked(case):
    """_check_frame_args, which every launch of rt_frame and rt_frame_tiles
    runs first: well-formed arguments pass, and each malformed one is
    refused with a ValueError naming it."""
    edit, scalars, cfg, match = _FRAME_ARG_CASES[case]
    scene = _small_scene()
    if edit is not None:
        scene = edit(scene)
    if match is None:
        framekernel._check_frame_args(scene, scalars(), cfg)
    else:
        with pytest.raises(ValueError, match=match):
            framekernel._check_frame_args(scene, scalars(), cfg)


@pytest.mark.parametrize("stride,base,n_local,n_real", [
    (2, 1, 0, 2),    # no tile to render
    (2, 1, 1, 3),    # more real tiles than the 40x8 frame's 2
    (2, -1, 1, 2),   # a negative base
], ids=["n_local_0", "n_tiles_real_over_the_grid", "negative_base"])
def test_frame_tiles_refuses_a_bad_shard(stride, base, n_local, n_real):
    scene = _small_scene()
    with pytest.raises(ValueError, match="frame_tiles"):
        frame_tiles(scene, _scalars(_GOOD), _GOOD, stride, base, n_local,
                    n_real)


def test_constants_and_entries_match_the_cuda_source():
    """MAX_STACK and TILE are frame.cu's RT_MAX_STACK and RT_TILE; every
    frame entry the wrappers call is declared with as many arguments as
    _build.SIGNATURES gives it (the root tables' two after the entry's
    own, then for rt_frame a two-level scene's six instance tables and
    counts, before the stream), and frame.cu declares no other entry."""
    src = open(os.path.join(_build.CSRC, "frame.cu")).read()
    defs = dict(re.findall(r"#define (RT_\w+) (\d+)", src))
    assert (int(defs["RT_MAX_STACK"]), int(defs["RT_TILE"])) == (MAX_STACK,
                                                                 TILE)
    params = re.search(r"#define RT_FRAME_PARAMS(.*?)\n#define", src,
                       re.S).group(1)
    n_frame = params.count(",") + 1
    roots = re.search(r"#define RT_ROOT_PARAMS (.*)\n", src).group(1)
    assert roots.count(",") + 1 == 2
    inst = re.search(r"#define RT_INST_PARAMS(.*?)\n#define", src,
                     re.S).group(1)
    assert inst.count(",") + 1 == 6
    _P, _I = _build._P, _build._I
    for entry, extra, tail in (
            ("rt_frame", 1 + 6, r"RT_ROOT_PARAMS, RT_INST_PARAMS,\s*"),
            ("rt_frame_tiles", 5, r"RT_ROOT_PARAMS, ")):
        assert re.search(rf'extern "C" int {entry}\(RT_FRAME_PARAMS,'
                         rf'[^)]*{tail}void\* stream\)', src), entry
        assert len(_build.SIGNATURES[entry]) == n_frame + 2 + extra, entry
    assert _build.SIGNATURES["rt_frame_tiles"][-3:-1] == [_P, _I]
    assert _build.SIGNATURES["rt_frame"][-9:-1] == [_P, _I, _P, _P, _P, _P,
                                                    _I, _I]
    assert re.search(r'extern "C" int rt_frame_occupancy\(int walk, int\* '
                     r'out\)', src)
    assert len(_build.SIGNATURES["rt_frame_occupancy"]) == 2
    assert sorted(re.findall(r'extern "C" int (\w+)\(', src)) == [
        "rt_frame", "rt_frame_occupancy", "rt_frame_tiles"]
