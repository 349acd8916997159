"""whisper-small [audio]: enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].  12L d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865.

The conv/mel frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed frame embeddings (B, S, d_model) to the encoder.
Decode shapes lower the decoder ``serve_step`` (self-KV cache +
cross-attention over encoder output)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    use_rope=False,  # learned positions
    qkv_bias=True,
    encdec=True,
    enc_layers=12,
    max_seq=32768,  # learned-pos table must cover the decode_32k cell
)
