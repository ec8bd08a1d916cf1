"""llava-next-34b [vlm] — the anyres tiling frontend is a STUB: the caller
provides precomputed patch embeddings (B, 2304, d), prefixed to the token
stream; the backbone is the Yi-34B-style decoder. [hf:llava-hf/llava-v1.6]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64_000, n_img_tokens=2304,
    act="swiglu", norm="rmsnorm", use_bias=False, tie_embeddings=False,
    rope_theta=5_000_000.0,
)
