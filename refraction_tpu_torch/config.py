"""Render configuration: the port's copy of `refraction_tpu.config`.

The reference (`bottledspace/refraction-raytracing-dxr`) hard-codes every
parameter; this dataclass lifts each one into a field whose *default equals the
reference value*, with the source cited:

- window / dispatch size 1024x768   (WinMain.cpp:41,44; RefractionDemo.cpp:589-590)
- vertical FOV 52 deg, using pi ~= 3.1415 (RefractionDemo.cpp:559)
- aspect 1.333, near 1.0, far 125.0 (RefractionDemo.cpp:559)
- orbit radius 5, orbit speed 0.01 rad/frame (RefractionDemo.cpp:560,567)
- index of refraction 1.3           (RayTracing.hlsl:95)
- Fresnel R0 = (0.2/2.2)^2          (RayTracing.hlsl:92)
- refraction bounce cap 5           (RayTracing.hlsl:82)
- reflection split cap 2            (RayTracing.hlsl:110)
- primary ray  TMin 1e-4, TMax 100  (RayTracing.hlsl:52-53)
- secondary ray TMin 1e-3, TMax 1000 (RayTracing.hlsl:99-100,114-115)
- scene '../shell.obj', envmap '../envMap.hdr' (RefractionDemo.cpp:537,527)

Same fields, defaults and ``RRT_ASSET_DIR`` read as the JAX package's
module (tests/test_torch_hostcode.py holds them equal); without
``RRT_ASSET_DIR`` the assets are looked up in the working directory. ``backend``,
``cluster_size`` and ``num_devices`` are kept so that a configuration
reads the same in both packages; the port renders on the device its
callers name. ``baseline_config`` copies the five staged BASELINE.json
presets (``--baseline N``).
"""

from __future__ import annotations

import dataclasses
import os

# pi as written in the reference camera code (RefractionDemo.cpp:559).
REF_PI_CAMERA = 3.1415
# pi as written in the reference miss shader (RayTracing.hlsl:133-134).
REF_PI_ENVMAP = 3.14159

# Directory holding the reference assets (OBJ meshes / envmap). The assets are
# data fixtures, not code; they are read in place rather than copied.
DEFAULT_ASSET_DIR = os.environ.get("RRT_ASSET_DIR", ".")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of the renderer; defaults reproduce the reference demo."""

    # Image / dispatch grid.
    width: int = 1024
    height: int = 768

    # Camera (RefractionDemo.cpp:559-565). ``aspect=None`` derives the
    # aspect from width/height EXCEPT at the reference's exact 1024x768,
    # which keeps the literal 1.333 the reference hard-codes (not 4/3) for
    # pixel parity. Non-4:3 renders (e.g. 1920x1080) thus get square
    # pixels instead of a ~33% horizontal stretch.
    fov_y_deg: float = 52.0
    aspect: float | None = None
    z_near: float = 1.0
    z_far: float = 125.0
    orbit_radius: float = 5.0
    orbit_speed: float = 0.01

    # Dielectric material (RayTracing.hlsl:92-95).
    ior: float = 1.3
    fresnel_r0_base: float = 0.2 / 2.2  # R0 = base^2

    # Bounce policy (RayTracing.hlsl:82,110).
    max_refract_depth: int = 5   # hits at count >= this contribute black
    max_reflect_depth: int = 2   # reflection splits only while count < this

    # Ray interval policy (RayTracing.hlsl:52-53, 99-100).
    primary_tmin: float = 1e-4
    primary_tmax: float = 100.0
    secondary_tmin: float = 1e-3
    secondary_tmax: float = 1000.0

    # Supersampling: samples per pixel accumulated with per-sample
    # jitter. 1 == reference behavior (pixel centers).
    spp: int = 1

    # Assets.
    scene_path: str = os.path.join(DEFAULT_ASSET_DIR, "shell.obj")
    envmap_path: str = os.path.join(DEFAULT_ASSET_DIR, "envmap.png")

    # The JAX package's backend name ('auto', 'xla', 'pallas'), kept so the
    # two configs stay equal. The port's renderer never reads it: it reads
    # its own argument (render.make_renderer's ``backend``, the CLI's
    # ``--backend`` with the port's names 'auto', 'torch', 'cuda').
    backend: str = "auto"

    # Triangles per spatially sorted cluster; a multiple of 8. None =
    # per scene from the triangle count (scene.auto_cluster_size).
    cluster_size: int | None = None

    # Devices to shard the image over in the JAX package; the port renders
    # on one device.
    num_devices: int = 1

    @property
    def resolved_aspect(self) -> float:
        if self.aspect is not None:
            return self.aspect
        if (self.width, self.height) == (1024, 768):
            return 1.333  # the reference's literal (RefractionDemo.cpp:559)
        return self.width / self.height

    @property
    def fov_y_rad(self) -> float:
        # Reference computes `52.0f / 180.0 * 3.1415` (RefractionDemo.cpp:559).
        return self.fov_y_deg / 180.0 * REF_PI_CAMERA

    @property
    def fresnel_r0(self) -> float:
        return self.fresnel_r0_base * self.fresnel_r0_base

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def reference_config() -> RenderConfig:
    """The exact demo configuration of the reference."""
    return RenderConfig()


def baseline_config(n: int) -> RenderConfig:
    """The staged BASELINE.json configs (1-5)."""
    a = DEFAULT_ASSET_DIR
    if n == 1:
        return RenderConfig(width=512, height=512, max_refract_depth=1,
                            scene_path=os.path.join(a, "cube.obj"))
    if n == 2:
        return RenderConfig(width=512, height=512, max_refract_depth=2,
                            scene_path=os.path.join(a, "sphere.obj"))
    if n == 3:
        return RenderConfig(width=1024, height=1024, max_refract_depth=4,
                            scene_path=os.path.join(a, "monkey.obj"))
    if n == 4:
        return RenderConfig(width=1920, height=1080,
                            scene_path=os.path.join(a, "shell.obj"))
    if n == 5:
        return RenderConfig(width=1920, height=1080, spp=4,
                            scene_path=os.path.join(a, "ott.obj"))
    raise ValueError(f"unknown baseline config {n}")
