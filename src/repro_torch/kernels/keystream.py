"""Builder keystream: the CUDA kernel ``csrc/keystream.cu`` and its plain
version.

Counterpart of ``repro/kernels/keystream.py:keystream_pallas``.  Both
compute ``builder/crng.py:word_matrix``: a ``(len(rows), n_words)`` matrix
whose column ``j`` holds word ``j0 + j`` of the Threefry-2x32-20 stream keyed
by ``(seed, stream)`` at counter ``rows[r]``.  The words are returned as the
bit patterns of a contiguous int32 tensor (:func:`as_uint32` views them as
numpy uint32), because torch's ``uint32`` lacks the arithmetic the plain
version needs.

:func:`keystream_cuda` launches the kernel on CUDA tensors and raises on any
other; ``ops.builder_keystream`` takes :func:`keystream_plain` only for CPU
tensors.  The plain version computes in int64 and masks every add and left
shift to 32 bits, so its right shifts are logical.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import threefry2x32_ref

COUNTER = _build.LaunchCounter("keystream")

__all__ = ["COUNTER", "as_uint32", "check_operands", "keystream_cuda", "keystream_plain"]

_M32 = 0xFFFFFFFF


def check_operands(seed, stream, rows: torch.Tensor, j0, n_words) -> None:
    """Raise on operands the keystream does not take: keys, counters and word
    indices are 32-bit unsigned."""
    for name, x in (("seed", seed), ("stream", stream), ("j0", j0)):
        if not 0 <= int(x) <= _M32:
            raise ValueError(f"{name}={x} is outside [0, 2^32)")
    if not 0 <= int(n_words) < 2**31:
        raise ValueError(f"n_words={n_words} is outside [0, 2^31)")
    if int(j0) + int(n_words) > 2**32:
        raise ValueError(f"words j0={j0} + n_words={n_words} pass 2^32")
    if rows.dtype not in (torch.int32, torch.int64) or rows.dim() != 1:
        raise TypeError(f"rows: expected a 1-D int32 or int64 tensor, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.numel():
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()  # one device sync
        if lo < 0 or hi > _M32:
            raise ValueError(f"rows: counters must lie in [0, 2^32), got [{lo}, {hi}]")


def as_uint32(words: torch.Tensor) -> np.ndarray:
    """The words of an int32 keystream tensor as host numpy uint32."""
    return words.cpu().numpy().view(np.uint32)


def keystream_plain(seed, stream, rows: torch.Tensor, j0, n_words) -> torch.Tensor:
    """The plain torch version on ``rows``' device: ``(len(rows), n_words)``
    int32 bit patterns.  Like the kernel it runs the cipher once per pair of
    words, and takes both halves."""
    check_operands(seed, stream, rows, j0, n_words)
    j0, n_words = int(j0), int(n_words)
    R = rows.shape[0]
    if R == 0 or n_words == 0:
        return torch.empty((R, n_words), dtype=torch.int32, device=rows.device)
    p0 = j0 >> 1
    pairs = torch.arange(p0, ((j0 + n_words - 1) >> 1) + 1, dtype=torch.int64,
                         device=rows.device)
    x0, x1 = threefry2x32_ref(int(seed), int(stream), rows.to(torch.int64)[:, None],
                             pairs[None, :])
    words = torch.stack((x0, x1), dim=2).reshape(R, -1)  # words 2*p0, 2*p0+1, ...
    words = words[:, j0 - 2 * p0: j0 - 2 * p0 + n_words]
    # uint32 bit patterns as int32 (values >= 2^31 wrap to negative)
    return (words - ((words >> 31) << 32)).to(torch.int32).contiguous()


def keystream_cuda(seed, stream, rows: torch.Tensor, j0, n_words) -> torch.Tensor:
    """Launch the kernel: ``(len(rows), n_words)`` int32 bit patterns on
    ``rows``' card.  ``rows`` is a contiguous int64 CUDA tensor; checking its
    range costs one device synchronisation.  An empty call returns an empty
    matrix without a launch."""
    check_operands(seed, stream, rows, j0, n_words)
    return _launch(seed, stream, rows, j0, n_words)


def _launch(seed, stream, rows: torch.Tensor, j0, n_words) -> torch.Tensor:
    """The launch of :func:`keystream_cuda` after its layout checks, without
    the synchronising range check of ``rows`` (what a kernel timing skips)."""
    _build.require("rows", rows, torch.int64, 1)
    R, n_words = rows.shape[0], int(n_words)
    out = torch.empty((R, n_words), dtype=torch.int32, device=rows.device)
    if R == 0 or n_words == 0:
        return out
    stream_handle, device = _build.launch_args(rows)
    rc = _build.library().repro_keystream(
        rows.data_ptr(), out.data_ptr(), R, n_words, int(seed), int(stream), int(j0),
        stream_handle, device,
    )
    _build.check(rc, "keystream")
    COUNTER.launches += 1
    return out
