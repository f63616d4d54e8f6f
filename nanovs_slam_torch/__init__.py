"""nanovs_slam_torch — the PyTorch/CUDA port of nanovs_slam_tpu for NVIDIA
Hopper (H100).

Module names follow the JAX package so that each counterpart is easy to
find. Inside, modules use PyTorch idiom (``nn.Module``s in NCHW, explicit
devices and ``torch.Generator``s); public functions keep the JAX layouts
(NHWC in and out). Every Pallas kernel on the ported path has a CUDA C++
counterpart for ``sm_90a`` under ``csrc/``, bound in ``kernels/``; a wrapper
launches its kernel for a CUDA tensor and runs its plain PyTorch twin for a
CPU tensor.

This package imports neither ``jax`` nor ``nanovs_slam_tpu``.
"""

__version__ = "0.1.0"

from . import configs  # noqa: F401
