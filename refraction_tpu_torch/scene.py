"""The scene on a torch device: port of `refraction_tpu.scene.scene_to_device`.

Scene building (OBJ/texture ingest, spatial sort, padding, box tables)
stays `refraction_tpu.scene.build_scene` / `load_scene` /
`load_instanced` (the ``--instances`` spec: N placed meshes baked to
world space, mask-0 instances dropped), which are numpy. `scene_from_jax`
carries the built scene across: it uploads the leaves the GPU path reads
and skips the TPU-only layouts (``env_packed``, ``env_codes``/``env_lut``,
``tri_norm_vmem``, ``cluster_records``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from refraction_tpu.scene import (  # noqa: F401  (re-exported builders)
    SUB_TRIS,
    auto_cluster_size,
    build_scene,
    load_instanced,
    load_scene,
)

# Leaves uploaded by scene_from_jax, all float32 except tri_mask (int32).
UPLOADED = ("tri_a", "tri_e1", "tri_e2", "tri_packed", "tri_norm_packed",
            "cluster_bounds", "sub_bounds", "envmap", "tri_mask")


class TorchScene(NamedTuple):
    """Scene tables on one device, in the JAX scene's table order."""

    tri_a: torch.Tensor            # (T, 3) first vertex
    tri_e1: torch.Tensor           # (T, 3) B - A
    tri_e2: torch.Tensor           # (T, 3) C - A
    tri_packed: torch.Tensor       # (T, 9) [A | e1 | e2]
    tri_norm_packed: torch.Tensor  # (T, 9) [nA | nB-nA | nC-nA]
    cluster_bounds: torch.Tensor   # (C, 6) [lo | hi]; cluster c = tris [c*cs, (c+1)*cs)
    sub_bounds: torch.Tensor       # (T/sub_tris, 6) [lo | hi]
    envmap: torch.Tensor           # (H, W, 3) equirect map
    tri_mask: torch.Tensor | None  # (T,) int32 instance mask (pad tris 0)
    sub_tris: int                  # triangles per sub box

    @property
    def num_tris(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_bounds.shape[0])

    @property
    def cluster_size(self) -> int:
        return self.num_tris // self.num_clusters

    @property
    def device(self) -> torch.device:
        return self.tri_a.device


def scene_from_jax(scene, device: torch.device | str) -> TorchScene:
    """Upload a `refraction_tpu.scene.Scene` (numpy or JAX leaves) to
    ``device``. Values are copied bit for bit; a scene built by hand
    without ``tri_mask`` keeps None there."""

    def put(name, dtype):
        leaf = getattr(scene, name)
        if leaf is None and name == "tri_mask":
            return None
        # torch.tensor copies: JAX hands out read-only host buffers.
        return torch.tensor(np.asarray(leaf, dtype), device=device)

    leaves = {name: put(name, np.int32 if name == "tri_mask" else np.float32)
              for name in UPLOADED}
    return TorchScene(**leaves, sub_tris=SUB_TRIS)
