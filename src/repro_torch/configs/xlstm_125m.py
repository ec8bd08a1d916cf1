"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (pattern m,m,m,s), d_ff=0 (block-
internal projections).  Deviations, as in the reference: sLSTM omits its
causal conv; sLSTM blocks carry a 4/3-pf FFN per the xLSTM paper.
[arXiv:2405.04517]"""
from repro_torch.models.common import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304, d_rnn=1536, conv_width=4,
    block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
    act="gelu", norm="layernorm", use_bias=False, tie_embeddings=True,
    pos_kind="none",
)
