"""phi3-medium-14b [dense] — RoPE, SwiGLU, GQA. [arXiv:2404.14219]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100_352,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=False,
    rope_theta=10_000.0,
)
