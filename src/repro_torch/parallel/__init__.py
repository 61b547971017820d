"""Distributed-training substrate: int8 gradient compression (the sharding
rules and collectives come with the parallel slice)."""
from repro_torch.parallel.compression import (compress_roundtrip,
                                              dequantize_int8,
                                              make_grad_compression,
                                              quantize_int8)

__all__ = ["compress_roundtrip", "dequantize_int8", "make_grad_compression",
           "quantize_int8"]
