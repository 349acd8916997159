"""command-r-35b [dense]: GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified].  40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    mlp="swiglu",
    norm="layernorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    remat=True,
)
