"""refraction_tpu_torch: the renderer of `refraction_tpu` in PyTorch + CUDA.

A second package beside the JAX one. Host code with no JAX in it (config,
camera matrices, scene building, asset IO) is imported from
`refraction_tpu`; everything that touched JAX or Pallas is ported here:
plain PyTorch functions on tensors, and hand-written CUDA kernels for
Hopper (``csrc/``) behind wrappers in ``kernels/``. Every function takes
an explicit ``device``; nothing picks one implicitly.

Importing this package never imports ``jax``.
"""

__version__ = "0.1.0"

from refraction_tpu.config import RenderConfig  # noqa: F401
