"""granite-8b [dense] — llama-arch, code model. [arXiv:2405.04324]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49_152,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=False,
)
