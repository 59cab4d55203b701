"""Counterparts of ``dcnn_tpu/ops/pallas/``: the 3×3 implicit-GEMM convs
and the fused scale/bias/ReLU. The JAX package writes them as Pallas TPU
kernels; here they are CUDA kernels written by hand for Hopper
(``ops/csrc/conv3x3_tc.cu``, ``ops/csrc/fused.cu``), with the JAX public
signatures and a plain PyTorch version beside each kernel that CPU tensors
take."""

from .conv import (
    conv3x3_s1, conv3x3_s1_bnrelu_in, conv3x3_s1_pairs, fuse_pair_weights,
)
from .fused import fused_scale_bias_relu

__all__ = ["conv3x3_s1", "conv3x3_s1_bnrelu_in", "conv3x3_s1_pairs",
           "fuse_pair_weights", "fused_scale_bias_relu"]
