"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed experts top-6 +
2 shared, first layer dense.  The assignment line lists both "64e" and "160
routed"; 64 matches V2-*Lite* (160 is full V2).
[arXiv:2405.04434]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102_400,
    moe=True, n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    first_dense_layers=1, dense_d_ff=10944,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=False,
)
