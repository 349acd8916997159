"""The simulator's per-step noise: the CUDA kernel ``csrc/noise.cu`` and its
plain version.

Not a counterpart of a TPU kernel: the reference draws its noise as jnp
outside Pallas, ``sigma * jax.random.normal(fold_in(PRNGKey(seed), t),
(n,))`` (``repro/snn/simulator.py:409-415``).  Both versions here compute it
from counters alone: the step key from ``(seed, t)``, each id's raw bits
from the key and the id (Threefry-2x32-20), the uniform and the normal from
the bits.  The bits and uniforms equal jax's bit for bit; the normals use
the port's own log1p and differ from XLA's by up to 4.8e-7
(``tests/test_torch_noise.py``).  The kernel and the plain version run the
same correctly rounded operations in the same order, so the noise of a net
is the same on the card and on the CPU.  No generator state lives on the
host: the kernel derives the step key itself.

:func:`noise_cuda` launches the kernel for a CUDA device and raises for any
other; ``ops.step_noise`` takes :func:`noise_plain` (``ref.step_noise_ref``)
only for the CPU.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import step_noise_ref as noise_plain

COUNTER = _build.LaunchCounter("noise")

__all__ = ["COUNTER", "noise_cuda", "noise_plain"]


def check_operands(seed: int, t: int, n: int) -> None:
    """Raise on operands the noise does not take: a negative step or width.
    The seed and the step enter as ``mod 2^32``, as in the reference."""
    if int(n) < 0 or int(t) < 0:
        raise ValueError(f"noise of step t={t} over n={n} ids: both must be >= 0")


def noise_cuda(seed: int, t: int, n: int, sigma: float, *, device) -> torch.Tensor:
    """Launch the kernel: the ``(n,)`` f32 noise of step ``t`` on the card
    ``device``."""
    check_operands(seed, t, n)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"noise_cuda: expected a CUDA device, got {device}")
    out = torch.empty(int(n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    stream, index = _build.launch_args(out)
    rc = _build.library().repro_noise(
        out.data_ptr(), int(n), int(seed) & 0xFFFFFFFF, int(t) & 0xFFFFFFFF, float(sigma),
        stream, index,
    )
    _build.check(rc, "noise")
    COUNTER.launches += 1
    return out
