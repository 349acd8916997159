"""Config -> model dispatch, the counterpart of ``repro/models/zoo.py``."""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.dispatch import resolve_device
from .encdec import EncDecLM
from .transformer import DecoderLM
from .vlm import VLM


def build_model(cfg, *, device=None, generator: Optional[torch.Generator] = None):
    """The model for ``cfg`` with its parameters drawn on ``device`` (the
    card unless the caller names another; no card and no device raises)
    from ``generator``, a ``torch.Generator`` on that device (seed 0 when
    None).  On ``device="meta"`` the parameters have shapes and no values
    (the dry run's and the spec checks' model)."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    cls = EncDecLM if cfg.encdec else VLM if cfg.n_img_tokens else DecoderLM
    return cls(cfg, device=device, generator=generator)
