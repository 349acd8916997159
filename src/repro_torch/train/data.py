"""Deterministic synthetic data pipeline, host-sharded; the counterpart of
``repro/train/data.py``.

Every host computes only its shard of the global batch from ``(seed, step,
host_id)``: no coordination, no files, the same tokens across restarts.
The tokens equal the reference's bit for bit: the key is jax's
``fold_in(fold_in(PRNGKey(seed), step), host_id)``, and ``split``,
``random_bits`` and ``randint`` follow jax 0.9.0 under the partitionable
Threefry (``jax_threefry_partitionable``, its default), on the port's
cipher (``kernels/ref.py:threefry2x32_ref``).  An affine-sequence task
(``t_{i+1} = (a * t_i + b) mod V`` per sequence) gives the loss curve a
learnable structure.  Tokens are int32 CPU tensors; the caller moves them
to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from ..kernels.ref import step_key_ref, threefry2x32_ref

_M32 = 0xFFFFFFFF
Key = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    task: str = "affine"  # affine | uniform
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the cipher of the counter pair ``(0, data)``."""
    one = torch.ones((), dtype=torch.int64)
    x0, x1 = threefry2x32_ref(key[0], key[1], 0 * one, (int(data) & _M32) * one)
    return int(x0), int(x1)


def _counters(n: int):
    """The flat index of each of ``n`` elements as jax's ``iota_2x32_shape``
    gives it: the high and the low 32 bits."""
    i = torch.arange(n, dtype=torch.int64)
    return i >> 32, i & _M32


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split``: key ``i`` is the cipher of the counter ``i``."""
    x0, x1 = threefry2x32_ref(key[0], key[1], *_counters(num))
    return tuple((int(a), int(b)) for a, b in zip(x0.tolist(), x1.tolist()))


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64: ``x0 ^ x1`` of the
    cipher at each flat index."""
    x0, x1 = threefry2x32_ref(key[0], key[1], *_counters(n))
    return x0 ^ x1


def randint(key: Key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for
    ``minval < maxval`` in int32's range: two words from the two halves of a
    split, folded with the span's multiplier ``2^32 mod span`` in uint32
    arithmetic (every product and sum wraps at 2^32, as the reference's
    does)."""
    n = 1
    for d in shape:
        n *= d
    k1, k2 = split(key)
    higher, lower = random_bits(k1, n), random_bits(k2, n)
    span = (maxval - minval) & _M32
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (((higher % span) * multiplier) & _M32) + lower % span
    offset = (offset & _M32) % span
    return (minval + offset).to(torch.int32).reshape(shape)


def host_batch(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """This host's shard of the global batch for ``step``: ``tokens``, a
    ``(global_batch // n_hosts, seq_len)`` int32 CPU tensor."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split over "
                         f"{cfg.n_hosts} hosts")
    b_local = cfg.global_batch // cfg.n_hosts
    key = fold_in(step_key_ref(cfg.seed, step), cfg.host_id)
    V = cfg.vocab_size
    if cfg.task == "uniform":
        return dict(tokens=randint(key, (b_local, cfg.seq_len), 0, V))
    k1, k2, k3 = split(key, 3)
    a = randint(k1, (b_local,), 1, 8).long()
    b = randint(k2, (b_local,), 0, 16).long()
    t = randint(k3, (b_local,), 0, V).long()
    seq = [t]
    for _ in range(cfg.seq_len - 1):
        t = (a * t + b) % V
        seq.append(t)
    return dict(tokens=torch.stack(seq, dim=1).to(torch.int32))


def batch_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield step, host_batch(cfg, step)
        step += 1
