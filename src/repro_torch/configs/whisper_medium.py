"""whisper-medium [audio] — enc-dec; conv frontend is a STUB: the caller
provides precomputed frame embeddings (B, 1536, d).  Deviations: frames
padded 1500->1536 for clean sharding; sinusoidal decoder positions (the
32k decode cell exceeds whisper's learned 448-position table).
[arXiv:2212.04356]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, encoder_layers=24, encoder_seq=1536,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51_865,
    act="gelu", norm="layernorm", use_bias=True, tie_embeddings=True,
    pos_kind="sincos",
)
