"""Training and serving of the LM substrate, the counterpart of
``repro/train``: the optimizers, losses, the seeded data pipeline, the
train step and driver, and serving."""
from .optimizer import AdamW, SGDM, cosine_schedule, global_norm  # noqa: F401
from .losses import next_token_xent, total_loss  # noqa: F401
from .data import DataConfig, host_batch, batch_iterator  # noqa: F401
from .train_loop import make_train_step, make_loss_fn, fit  # noqa: F401
from .serve import greedy_generate, make_prefill_fn, make_serve_step  # noqa: F401
