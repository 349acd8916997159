"""Serving of the LM substrate, the counterpart of ``repro/train``'s
``serve`` module (training, the optimizer, losses and data come with the
training slice)."""
from .serve import greedy_generate, make_prefill_fn, make_serve_step  # noqa: F401
