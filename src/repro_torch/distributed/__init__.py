"""Distributed pieces of the port: the error-feedback int8 compressed
all-reduce (``compress.py``), the greedy sharding rules
(``auto_shard.py``), the activation anchors (``act_sharding.py``), the
per-device cost analyser (``cost.py``, the counterpart of the
reference's ``hlo.py``), the tracker of live storage bytes
(``memory.py``) and the H100 roofline (``roofline.py``).

The names below load their module at first use: every model module
imports ``act_sharding``, and a serving path should not pay for
``torch.distributed``, the flop counter or the sharding rules.
"""
import importlib

_NAMES = {
    "compress": ("BLOCK", "quantize", "dequantize", "compressed_psum",
                 "compressed_psum_tree"),
    "auto_shard": ("Spec", "auto_spec", "batch_seq_spec", "placements",
                   "shard_tree", "sharded_bytes", "tree_specs"),
    "cost": ("analyze",),
    "roofline": ("HW", "roofline_terms"),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = list(_HOME)


def __getattr__(name: str):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.distributed' has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
