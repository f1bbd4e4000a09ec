"""Tensor ops: MLP, spectral norm, masking, augmentation, message passing and its CUDA kernels."""
