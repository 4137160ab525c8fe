"""refraction_tpu_torch: the renderer of `refraction_tpu` in PyTorch + CUDA.

A second package beside the JAX one, standing alone: it imports neither
``jax`` nor anything of `refraction_tpu`. The host code (config, camera
matrices, scene building, asset IO, the viewer, the stats logger) is the
port's own copy under the JAX package's module names; everything that
touched JAX or Pallas is ported: plain PyTorch functions on tensors, and
hand-written CUDA kernels for Hopper (``csrc/``) behind wrappers in
``kernels/``. Every function takes an explicit ``device``; nothing picks
one implicitly.
"""

__version__ = "0.1.0"

from refraction_tpu_torch.config import RenderConfig  # noqa: F401
