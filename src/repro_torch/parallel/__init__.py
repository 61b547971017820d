"""Distributed substrate: logical-axis sharding over a ``DeviceMesh``
(``sharding``), int8 gradient compression, and the roofline constants."""
from repro_torch.parallel.compression import (compress_roundtrip,
                                              dequantize_int8,
                                              make_grad_compression,
                                              quantize_int8)

__all__ = ["compress_roundtrip", "dequantize_int8", "make_grad_compression",
           "quantize_int8"]
