"""Accumulation on the card: `render.Accumulator` folding the renderer's
CUDA frames into a float64 sum on the card, against the same frames'
host copies folded on the host, bit for bit; and `run.HostCopies`, which
hands the radiance over on the card and the u8 image on the host."""

import numpy as np
import pytest
import torch

from refraction_tpu_torch import RenderConfig
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.render import Accumulator, make_renderer
from refraction_tpu_torch.run import HostCopies, to_u8
from refraction_tpu_torch.scene import build_scene, scene_from_jax

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=80, height=60, spp=4)
ANGLES = [0.01 + 0.37 * k for k in range(6)]


def _frames(dev) -> list[torch.Tensor]:
    """The frame kernel's (H, W, 3) float32 frames at ``ANGLES``."""
    scene = scene_from_jax(build_scene(make_icosphere(3, 1.2),
                                       make_gradient_envmap(), 128)[0], dev)
    render = make_renderer(CFG, "cuda", dev)
    return [render(scene, orbit_camera(a, CFG)) for a in ANGLES]


def _bits(a: np.ndarray) -> np.ndarray:
    assert a.dtype == np.float64
    return a.view(np.uint64)


def test_card_fold_equals_host_fold_bit_for_bit(cuda):
    frames = _frames(cuda)
    card, host = Accumulator(CFG.height, CFG.width), Accumulator(
        CFG.height, CFG.width)
    for img in frames[:4]:
        card.add(img)
        host.add(img.cpu().numpy())
    assert isinstance(card._sum, torch.Tensor) and card._sum.is_cuda
    got = card.sum  # brought to the host
    assert isinstance(got, np.ndarray) and got.shape == (CFG.height,
                                                         CFG.width, 3)
    np.testing.assert_array_equal(_bits(got), _bits(host.sum))
    # Folding on after a read takes the host sum back up.
    for img in frames[4:]:
        card.add(img)
        host.add(img.cpu().numpy())
    np.testing.assert_array_equal(_bits(card.sum), _bits(host.sum))
    assert card.count == host.count == len(frames)
    assert (card.card_folds, host.card_folds) == (len(frames), 0)
    np.testing.assert_array_equal(card.image, host.image)


def test_saved_state_resumes_on_the_card_as_on_the_host(cuda, tmp_path):
    frames = _frames(cuda)
    first = Accumulator(CFG.height, CFG.width)
    for img in frames[:3]:
        first.add(img)
    path = str(tmp_path / "state.npz")
    first.save(path)
    card, host = Accumulator.load(path), Accumulator.load(path)
    for img in frames[3:]:
        card.add(img)
        host.add(img.cpu().numpy())
    want = Accumulator(CFG.height, CFG.width)
    for img in frames:
        want.add(img.cpu().numpy())
    np.testing.assert_array_equal(_bits(card.sum), _bits(host.sum))
    np.testing.assert_array_equal(_bits(card.sum), _bits(want.sum))
    assert card.count == host.count == len(frames)
    assert card.card_folds == len(frames) - 3


def test_host_copies_leave_the_radiance_on_the_card(cuda):
    img, = _frames(cuda)[:1]
    u8, rad, done = HostCopies(cuda, u8=False, radiance=True,
                               linear=False).enqueue(img)
    assert u8 is None and isinstance(done, torch.cuda.Event)
    done.synchronize()
    assert isinstance(rad, torch.Tensor) and rad.is_cuda
    assert torch.equal(rad, img)


def test_host_copies_bring_the_u8_image_to_pinned_slots_in_turns(cuda):
    frames = _frames(cuda)[:3]
    copies = HostCopies(cuda, u8=True, radiance=False, linear=False)
    out = [copies.enqueue(img) for img in frames]
    # Slots 0, 1, 0: the third frame's copy goes to the first's buffer.
    ptr = [u8.__array_interface__["data"][0] for u8, _, _ in out]
    assert ptr[0] == ptr[2] != ptr[1]
    for k in (1, 2):
        u8, rad, done = out[k]
        done.synchronize()
        assert rad is None and isinstance(u8, np.ndarray)
        assert u8.dtype == np.uint8 and u8.shape == (CFG.height, CFG.width,
                                                     3)
        np.testing.assert_array_equal(u8, to_u8(frames[k]).cpu().numpy())
