"""command-r-plus-104b [dense] — GQA, no-bias, parallel block, tied
embeddings (Cohere style). [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256_000,
    act="swiglu", norm="layernorm", use_bias=False, tie_embeddings=True,
    parallel_block=True, rope_theta=75_000.0,
)
