"""xlstm-350m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  Alternating
(mlstm, slstm) pattern; blocks carry their own up/down projections
(d_ff=0: no separate FFN).  Constant-size recurrent state ->
sub-quadratic -> runs long_500k."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    mlp="none",
    norm="layernorm",
    use_rope=False,
)
