"""granite-moe-3b-a800m [moe] — 40 experts top-8 (assignment also says "32
experts", which belongs to 1b-a400m; 40 matches 3b-a800m).
[hf:ibm-granite/granite-3.0 moe family]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    moe=True, n_experts=40, n_shared_experts=0, top_k=8, d_ff_expert=512,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=True,
)
