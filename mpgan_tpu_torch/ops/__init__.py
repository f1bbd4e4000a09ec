"""Tensor ops: MLP, spectral norm, masking, dense message passing and its CUDA kernels."""
