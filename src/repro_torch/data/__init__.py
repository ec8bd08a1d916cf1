"""The port's token pipeline (its own copy of the reference's ``data``)."""
from repro_torch.data.pipeline import (DataConfig, TokenPipeline,
                                       make_batch_fn, synthetic_corpus)

__all__ = ["DataConfig", "TokenPipeline", "make_batch_fn",
           "synthetic_corpus"]
