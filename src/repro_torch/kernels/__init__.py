"""Attention and selective-scan kernels for Hopper (CUDA C++ under
``csrc/``, built with ``nvcc`` and bound with ``ctypes``), their plain
PyTorch versions, the plain references (``ref``) and the plain-torch
flash semantics of the ``chunked`` backend (``flash_xla``)."""
from repro_torch.kernels import (decode_attention, flash_attention, flash_xla,
                                 mamba_scan, ops, ref)

__all__ = ["decode_attention", "flash_attention", "flash_xla", "mamba_scan",
           "ops", "ref"]
