"""The paper's own workload: Potjans–Diesmann cortical microcircuit under
dCSR (77K neurons / ~0.3B synapses at scale=1.0 — the 12 GB serialization
example; scale=2.0 in neurons ~= the 49 GB example)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    name: str = "snn-microcircuit"
    scale: float = 1.0
    k_partitions: int = 256  # the reference's production partition count
    dt_ms: float = 0.1
    steps: int = 1000
    partitioner: str = "rcb"  # block | hash | voxel | rcb
    exchange: str = "dense"  # dense | index (compressed spike exchange)
    seed: int = 0


CONFIG = SNNConfig()
