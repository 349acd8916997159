"""The simulator's per-step noise: the CUDA kernel ``csrc/noise.cu`` and
its plain versions.

Not a counterpart of a TPU kernel: the reference draws its noise as jnp
outside Pallas, ``sigma * jax.random.normal(fold_in(PRNGKey(seed), t),
(n,))`` (``repro/snn/simulator.py:409-415``), and adds a partition's ids of
it to the delivered ring slot.  Both versions here compute it from counters
alone: the step key from ``(seed, t)``, each id's raw bits from the key and
the id (Threefry-2x32-20), the uniform and the normal from the bits.  The
bits and uniforms equal jax's bit for bit; the normals use the port's own
log1p and differ from XLA's by up to 4.8e-7 (``tests/test_torch_noise.py``).
The kernel and the plain versions run the same correctly rounded
operations in the same order, so the noise of a net is the same on the card
and on the CPU.  No generator state lives on the host: the kernel derives
the step key itself.

One kernel, two entry points: :func:`noise_add_cuda` draws a partition's
own ids and adds them to its ring slot, and the bias, in one launch
(``ops.step_noise_add``, what the engines run); :func:`noise_cuda` is the
same launch at the ids ``0..n-1`` over ``-0.0``, the whole ``(n,)`` vector
of a step (``ops.step_noise``).  Each launches the kernel for CUDA operands
and raises for any other; the ops take the plain versions
(``ref.step_noise_ref``, ``ref.step_noise_add_ref``) only for the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import step_noise_add_ref as noise_add_plain
from .ref import step_noise_ref as noise_plain

COUNTER = _build.LaunchCounter("noise_add")

__all__ = ["COUNTER", "noise_add_cuda", "noise_add_plain", "noise_cuda", "noise_plain"]


def check_operands(seed: int, t, n: int) -> None:
    """Raise on operands the noise does not take: a negative step or width.
    The seed and the step enter as ``mod 2^32``, as in the reference.  A
    step given as a tensor (a simulator's carry) stays on its device and is
    not checked here: reading it would stall the host."""
    if int(n) < 0 or (not torch.is_tensor(t) and int(t) < 0):
        raise ValueError(f"noise of step t={t} over n={n} ids: both must be >= 0")


def noise_cuda(seed: int, t: int, n: int, sigma: float, *, device) -> torch.Tensor:
    """The ``(n,)`` f32 noise of step ``t`` on the card ``device``: one
    launch of the kernel at the ids ``0..n-1`` added to ``-0.0``, which
    leaves every value, signed zeros too, as it is."""
    check_operands(seed, t, n)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"noise_cuda: expected a CUDA device, got {device}")
    x = torch.full((int(n),), -0.0, dtype=torch.float32, device=device)
    ids = torch.arange(int(n), dtype=torch.int64, device=device)
    return noise_add_cuda(x, ids, seed, t, sigma)


def noise_add_cuda(x: torch.Tensor, ids: torch.Tensor, seed: int, t, sigma: float,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: ``(x + sigma * normal(seed, t, ids)) [+ bias]`` as a
    new ``(n,)`` f32 tensor on ``x``'s card.  ``x`` (f32) and ``ids`` (int64)
    are contiguous ``(n,)`` CUDA tensors; ``bias`` is an ``(n,)`` f32 tensor
    of any stride (a column of ``vtx_state``) on the same card, or None.
    ``t`` is an int or the simulator's 0-d int64 step tensor on the card,
    which the kernel reads when it runs (so a captured launch serves every
    step)."""
    _build.require("x", x, torch.float32, 1)
    _build.require("ids", ids, torch.int64, 1, x.device)
    n = x.shape[0]
    check_operands(seed, t, n)
    if ids.shape[0] != n:
        raise ValueError(f"ids {tuple(ids.shape)} for x {tuple(x.shape)}")
    if bias is not None:
        if bias.device != x.device or bias.dtype != torch.float32 or bias.dim() != 1:
            raise ValueError(f"bias: expected a 1-D f32 tensor on {x.device}, got "
                             f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
        if bias.shape[0] != n:
            raise ValueError(f"bias {tuple(bias.shape)} for x {tuple(x.shape)}")
    out = torch.empty_like(x)
    if n == 0:
        return out
    t_dev = _build.step_tensor(t, x.device)
    stream, index = _build.launch_args(x)
    rc = _build.library().repro_noise_add(
        x.data_ptr(), ids.data_ptr(), None if bias is None else bias.data_ptr(),
        0 if bias is None else bias.stride(0), out.data_ptr(), n,
        int(seed) & 0xFFFFFFFF, t_dev.data_ptr(), float(sigma), stream, index,
    )
    _build.check(rc, "noise_add")
    COUNTER.launches += 1
    return out
