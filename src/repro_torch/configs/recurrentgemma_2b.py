"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern (R,R,A);
26 layers = 8x(R,R,A) + 2xR tail.  Deviation (as in the reference): RG-LRU
gates are dense rather than block-diagonal. [arXiv:2402.19427]"""
from repro_torch.models.common import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000, d_rnn=2560, conv_width=4, window=2048,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    act="geglu", norm="rmsnorm", use_bias=False, tie_embeddings=True,
    scale_embed=True, logit_softcap=30.0,
)
