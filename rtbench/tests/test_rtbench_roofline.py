"""rtbench/roofline.py: the hand-computed count on a tiny scene."""

import math

import torch

from rtbench import roofline
from rtbench.reference import tracer


def _one_triangle_scene():
    # One triangle facing the camera at angle 0 (on +x, looking at the
    # origin), large enough to cover the centre pixel.
    pos = torch.tensor([[[0.0, -2.0, -2.0], [0.0, 2.0, 0.0],
                         [0.0, -2.0, 2.0]]])
    nrm = torch.tensor([[[1.0, 0.0, 0.0]] * 3])
    env = torch.full((4, 8, 3), 0.5)
    return tracer.Scene(pos.numpy(), nrm.numpy(), env, "cpu")


def test_bound_by_hand():
    render = {"width": 10, "height": 10}
    counts = {"rays": 30.0, "hits": 10.0, "misses": 20.0}
    b = roofline.bound(counts, 1000, render)
    depth = 10  # ceil(log2 1000)
    ops = 10 * (2 * depth * 25 + 52) + 20 * (25 + 17)
    nbytes = 1000 * 72 + 10 * 10 * 12  # no texel bytes
    assert b["ops"] == ops
    assert b["bytes"] == nbytes
    assert math.isclose(b["bound_ms"],
                        max(ops / 67e12, nbytes / 3.35e12) * 1e3)
    assert b["bound_by"] == "bytes"


def test_grid_and_counts():
    ids = roofline.grid_pixels(256, 128)
    step = round(math.sqrt(256 * 128 / roofline.GRID_PIXELS))
    assert len(ids) == len(range(step // 2, 256, step)) * len(
        range(step // 2, 128, step))
    render = {"width": 5, "height": 5, "spp": 1, "max_refract_depth": 5,
              "max_reflect_depth": 2, "fov_y_deg": 52.0, "pi_camera": 3.1415,
              "aspect": None, "z_near": 1.0, "z_far": 125.0,
              "orbit_radius": 5.0, "ior": 1.3, "fresnel_r0_base": 0.2 / 2.2,
              "primary_tmin": 1e-4, "primary_tmax": 100.0,
              "secondary_tmin": 1e-3, "secondary_tmax": 1000.0}
    c = roofline.ray_counts(_one_triangle_scene(), render, 0.0)
    # The one triangle faces the camera: each primary that hits it spawns
    # a refraction and a reflection child, which leave the open scene
    # (the refracted ray is inside and meets no back face).
    assert c["hits"] > 0
    assert c["rays"] == 25 + 2 * c["hits"]
    assert c["misses"] == c["rays"] - c["hits"]
