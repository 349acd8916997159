"""PaliGemma-style VLM, the counterpart of ``repro/models/vlm.py``: the
gemma decoder (:class:`DecoderLM`) with the reference's STUB SigLIP
frontend: the caller supplies precomputed patch embeddings ``(B,
n_img_tokens, d_model)``, which are put before the text embeddings and
attended bidirectionally (the prefix block of the causal mask,
``prefix_len = n_img_tokens``)."""
from __future__ import annotations

from .transformer import DecoderLM


class VLM(DecoderLM):
    """``forward(tokens, img_embed=...)``: see :class:`DecoderLM`."""

    def stub_frontend_shape(self, batch: int):
        return (batch, self.cfg.n_img_tokens, self.cfg.d_model)
