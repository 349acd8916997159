"""The roofline terms of a step and the counter that feeds them; the
counterpart of ``repro/analysis/hlo.py``'s ``roofline_terms`` and
``dominant_term``.

The reference reads its FLOPs and collective bytes from the post-SPMD HLO
text.  The port lowers to no HLO, so it counts them while the step runs
(on meta tensors in a dry run, so nothing is allocated).
:class:`StepCounter` is a dispatch mode that, as ``CommDebugMode`` does,
declines every op on DTensors, so DTensor runs it and the mode sees what
DTensor runs on this rank: the local ops on the local shards and the
collectives of each redistribution.  On those it

  * counts the FLOPs of every op in ``torch.utils.flop_counter``'s
    registry (the formulas ``FlopCounterMode`` uses: matmuls, convolutions,
    attention) at the local shapes: this rank's FLOPs, replicated work
    included;
  * counts each ``torch.distributed`` functional collective by kind and
    charges it its operand's bytes, as the reference charges each HLO
    collective;
  * sums the bytes each op that is not a view reads and writes: the eager,
    unfused traffic, which the memory term reads (the reference's HLO
    bytes are after XLA's fusion, so this one is larger).

The peaks are those of NVIDIA's H100 data sheet (SXM part, dense, at the
full 700 W power limit): a card set to a lower limit reaches less.
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
F32_PEAK_FLOPS = 67e12  # f32 outside the tensor cores (the SNN's gathers)
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # NVLink bytes/s each way (900 GB/s both ways)
PEAKS = ("NVIDIA H100 80GB HBM3 (SXM) data sheet at its 700 W power limit, not measured: "
         "989 TFLOP/s dense bf16 (67 f32), 3.35 TB/s HBM, 450 GB/s NVLink each way")

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes: float, peak_flops: float = PEAK_FLOPS) -> Dict[str, float]:
    """The three roofline terms in seconds (per-device inputs)."""
    return dict(compute_s=flops_per_device / peak_flops,
                memory_s=bytes_per_device / HBM_BW,
                collective_s=collective_bytes / LINK_BW)


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepCounter(TorchDispatchMode):
    """Per-device FLOPs and collectives of the ops run inside it (see the
    module's docstring): ``flops``, ``collective_counts`` and
    ``collective_bytes`` by kind."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0.0
        self.op_bytes = 0
        self.collective_counts: Dict[str, int] = collections.Counter()
        self.collective_bytes: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if not func.is_view:
            self.op_bytes += sum(_nbytes(t) for t in _flat((args, kwargs, out)))
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        elif func.namespace == "_c10d_functional" and packet.__name__ in COLLECTIVES:
            kind = COLLECTIVES[packet.__name__]
            self.collective_counts[kind] += 1
            self.collective_bytes[kind] += sum(_nbytes(t) for t in _flat(args[0]))
        return out

    @property
    def total_collective_bytes(self) -> int:
        return int(sum(self.collective_bytes.values()))


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
