"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0 family]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49_155,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=False,
)
