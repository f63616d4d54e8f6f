"""Hand-written CUDA kernels for Hopper, their wrappers and plain twins.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute (a bfloat16 instance's in ``launches_bf16``);
for CPU tensors it runs the plain PyTorch twin of the same module. The
library is built from ``csrc/`` at first launch. ``netvlad`` is
differentiable: its backward is the ``netvlad_backward`` kernel; the other
wrappers refuse autograd. ``int8_conv3x3`` is the conv block of int8
serving (``quant.int8_execution``).
"""

from .int8conv import int8_conv3x3, int8_conv3x3_plain  # noqa: F401
from .lightglue import (lightglue_transformer,  # noqa: F401
                        lightglue_transformer_plain, split_weights,
                        split_weights_plain)
from .netvlad import (netvlad, netvlad_backward,  # noqa: F401
                      netvlad_backward_plain, netvlad_plain,
                      netvlad_residuals)
from .postprocess import fused_postprocess, postprocess_plain  # noqa: F401
from .stem import fused_stem_pair_pool, stem_plain  # noqa: F401

KERNELS = (fused_postprocess, fused_stem_pair_pool, netvlad,
           netvlad_backward, lightglue_transformer, split_weights,
           int8_conv3x3)
# the wrappers that have bfloat16 instances too
BF16_KERNELS = (fused_postprocess, fused_stem_pair_pool, netvlad,
                netvlad_backward, int8_conv3x3)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
    for k in BF16_KERNELS:
        k.launches_bf16 = 0
