"""Distributed pieces of the port: the error-feedback int8 compressed
all-reduce (``compress.py``).  The reference's sharding and XLA tooling
(``auto_shard``, ``hlo``, ``roofline``) are not ported yet (ROADMAP.md
§1)."""
from repro_torch.distributed.compress import (BLOCK, compressed_psum,
                                              compressed_psum_tree,
                                              dequantize, quantize)

__all__ = ["BLOCK", "quantize", "dequantize", "compressed_psum",
           "compressed_psum_tree"]
