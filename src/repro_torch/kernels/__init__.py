"""Attention and selective-scan kernels for Hopper (CUDA C++ under
``csrc/``, built with ``nvcc`` and bound with ``ctypes``), their plain
PyTorch versions, and the plain references (``ref``)."""
from repro_torch.kernels import decode_attention, flash_attention, mamba_scan, ops, ref

__all__ = ["decode_attention", "flash_attention", "mamba_scan", "ops", "ref"]
