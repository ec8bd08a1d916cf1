"""Distributed pieces of the port: the error-feedback int8 compressed
all-reduce (``compress.py``), the greedy sharding rules
(``auto_shard.py``), the activation anchors (``act_sharding.py``), the
per-device cost analyser (``cost.py``, the counterpart of the
reference's ``hlo.py``) and the H100 roofline (``roofline.py``)."""
from repro_torch.distributed.auto_shard import (Spec, auto_spec,
                                                batch_seq_spec, placements,
                                                shard_tree, sharded_bytes,
                                                tree_specs)
from repro_torch.distributed.compress import (BLOCK, compressed_psum,
                                              compressed_psum_tree,
                                              dequantize, quantize)
from repro_torch.distributed.cost import analyze
from repro_torch.distributed.roofline import HW, roofline_terms

__all__ = ["BLOCK", "quantize", "dequantize", "compressed_psum",
           "compressed_psum_tree", "Spec", "auto_spec", "batch_seq_spec",
           "placements", "shard_tree", "sharded_bytes", "tree_specs",
           "analyze", "HW", "roofline_terms"]
