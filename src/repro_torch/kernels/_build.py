"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` with a plain C interface; the objects are linked into one
shared library that is loaded with :mod:`ctypes`.  Nothing includes
PyTorch's headers, so a build takes seconds.  The library lands in
``kernels/_build/`` (listed in ``.gitignore``) under a name derived from a
hash of the sources and flags, so a later call in the same checkout loads
it without building.  Building happens on first use, never at import: the
package imports on machines without ``nvcc`` or a card.

Every failure raises: a missing ``nvcc``, a compile error, and a non-zero
``cudaError_t`` from any launch (:func:`check`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# --fmad=false: no multiply-add is contracted unless the source asks for one
# (row_dot's explicit __fmaf_rn); the LIF arithmetic must round each op as
# the plain torch version does.  -Xptxas -v prints registers, shared memory
# and spills per kernel into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass
class LaunchCounter:
    """Kernel launches made through one wrapper since the last reset; the
    wrapper adds one where it launches its kernel and nowhere else.  A
    captured CUDA graph holds the launches its capture counted, and each
    replay adds them (``snn/simulator.py:ChunkGraphs``): the counts are
    launches that ran on the card.  Every counter is listed in
    :data:`COUNTERS`."""

    name: str
    launches: int = 0

    def __post_init__(self):
        COUNTERS.append(self)


COUNTERS: List[LaunchCounter] = []


def launch_counts() -> List[int]:
    """Every counter's launches, in :data:`COUNTERS` order."""
    return [c.launches for c in COUNTERS]


def set_launch_counts(counts: List[int]) -> None:
    for c, n in zip(COUNTERS, counts):
        c.launches = n


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of this build (0.0 when loaded from cache)
    log: str  # nvcc's output per source, with the -Xptxas -v lines
    cached: bool


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of repro_torch build from source on first use"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the shared library, or find it built."""
    target = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if target.exists():
        return BuildInfo(target, 0.0, "", True)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    logs, objs, failed = [], [], []
    try:
        for src, obj, proc in procs:
            out, err = proc.communicate()
            logs.append(f"== {src.name}\n{out}{err}")
            objs.append(obj)
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = BUILD_DIR / f"{target.name}.{tag}.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    finally:
        for _, obj, proc in procs:
            if proc.poll() is None:  # an earlier failure left it running
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    os.replace(tmp, target)  # atomic: concurrent builders never see a torn .so
    return BuildInfo(
        target, time.perf_counter() - t0, "\n".join(logs), False
    )


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_int64
_SIGNATURES = {
    "repro_lif_step": [_P] * 6 + [_I] + [_F] * 7 + [_P, _I],
    "repro_spike_gather": [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 4 + [_P, _I],
    "repro_segment_gather": (
        [_P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P, _I] + [_P] * 8 + [_I]
    ),
    "repro_segment_gather_max_buckets": [],
    "repro_fused_step": (
        [_P] * 6 + [_I, _I, _I] + [_P] * 2 + [_I] + [_P] * 4 + [_I, _I] + [_F] * 7 + [_P, _I]
    ),
    "repro_fused_step_max_buckets": [],
    "repro_stdp_update": [_P] * 8 + [_I] * 4 + [_F] * 4 + [_P, _I],
    "repro_stdp_update_step": [_P, _I] + [_P] * 4 + [_I] + [_P] * 4 + [_F] * 4 + [_P, _I],
    "repro_stdp_update_step_max_buckets": [],
    "repro_fused_plastic_step": (
        [_P] * 10 + [_I] * 3 + [_P] * 8 + [_I, _P] + [_F] * 13 + [_P, _I]
    ),
    "repro_fused_plastic_step_max_buckets": [],
    "repro_event_step": (
        [_P, _I, _P, _P, _P, _I, _P, _P, _I, _P] + [_I] * 5 + [_P] * 2 + [_I] + [_P] * 4
        + [_I, _I, _P, _I]
    ),
    "repro_event_step_max_buckets": [],
    "repro_pre_exchange": [_P] * 10 + [_I] + [_F] * 9 + [_P, _I],
    "repro_post_exchange": (
        [_P, _I] + [_P] * 4 + [_I] * 3 + [_P] * 2 + [_I] + [_P] * 2 + [_I, _I, _P, _I]
    ),
    "repro_post_exchange_max_buckets": [],
    "repro_post_exchange_plastic": (
        [_P] * 3 + [_I] * 2 + [_P] * 6 + [_I] * 4 + [_P] * 5 + [_F] * 4 + [_P, _I]
    ),
    "repro_post_exchange_plastic_max_buckets": [],
    "repro_keystream": [_P, _P, _L, _I, _U, _U, _U, _P, _I],
    "repro_noise_add": [_P, _P, _P, _L, _P, _L, _U, _P, _F, _P, _I],
    "repro_step_front": (
        [_P, _I, _P, _I, _P, _P, _P, _I] + [_P] * 4 + [_I] + [_F] * 7 + [_U, _P]
        + [_F] * 3 + [_I, _I, _P, _I]
    ),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in a process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def step_tensor(t, device: torch.device) -> torch.Tensor:
    """The step ``t`` as the kernels read it: a 0-d int64 tensor on
    ``device``.  A tensor there is taken as it is (a simulator's carry, read
    on the card when the launch runs); an int is copied there, outside any
    captured chunk."""
    if torch.is_tensor(t):
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != device:
            raise ValueError(f"t: expected a 0-d int64 tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        return t
    if int(t) < 0:
        raise ValueError(f"step t={t}: must be >= 0")
    return torch.tensor(int(t), dtype=torch.int64, device=device)


def launch_args(t: torch.Tensor):
    """(stream handle, device index) for a launch on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream, t.device.index


def require(
    name: str,
    t: torch.Tensor,
    dtype: torch.dtype,
    ndim: int,
    device: Optional[torch.device] = None,
) -> None:
    """Validate a kernel operand before its pointer crosses into C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# the weight panels a gather kernel takes (spike_gather.cu, fused_step.cu,
# event_step.cu, post_exchange.cu), and stdp_update.cu's weights
GATHER_WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def require_weights(name: str, w: torch.Tensor, device, dtype=None) -> int:
    """Validate a 2-D weight panel of a gather or of ``stdp_update``: f32 or
    bf16 (``dtype``, when given, the type every panel of the launch
    shares); returns the kernel's ``w_bf16`` flag."""
    require_panel(name, w, dtype or w.dtype, device, GATHER_WEIGHT_DTYPES)
    return int(w.dtype == torch.bfloat16)


def require_panel(name: str, t: torch.Tensor, dtype, device, allowed=None) -> None:
    """Validate a 2-D panel of a launch: of ``dtype``, the type its launch's
    panels of this kind share, which must be one of ``allowed`` (f32 when
    None)."""
    allowed = allowed or (torch.float32,)
    if t.dtype not in allowed:
        raise TypeError(f"{name}: expected {' or '.join(map(str, allowed))}, got {t.dtype}")
    require(name, t, dtype, 2, device)


def require_plastic_f32(what: str, weights: Sequence[torch.Tensor]) -> None:
    """The fused plastic kernels take f32 weights only: the reference's
    Pallas kernels raise on bf16 weights (their f32 updates do not store
    into a bf16 panel), and its oracles return f32."""
    for i, w in enumerate(weights):
        if w.dtype != torch.float32:
            raise TypeError(
                f"{what}: weights[{i}] is {w.dtype}; the plastic fused kernels take f32 "
                "weights only, as the reference's Pallas kernels do (they raise on bf16 "
                "weights). ops.stdp_update takes bf16 weights"
            )


def plastic_weights_out(weights: Sequence[torch.Tensor], weights_out) -> List[torch.Tensor]:
    """The tensors a plastic kernel updates in place: ``weights_out`` (the
    same shapes and type as ``weights``), holding ``weights``' values
    (copied in unless it is ``weights`` itself), or new copies of
    ``weights`` when None."""
    if weights_out is None:
        return [w.clone() for w in weights]
    if len(weights_out) != len(weights):
        raise ValueError(f"{len(weights_out)} weights_out panels for {len(weights)} buckets")
    for i, (o, w) in enumerate(zip(weights_out, weights)):
        require_panel(f"weights_out[{i}]", o, w.dtype, w.device)
        if o.shape != w.shape:
            raise ValueError(f"weights_out[{i}] {tuple(o.shape)} for a panel {tuple(w.shape)}")
        if o is not w:
            o.copy_(w)
    return list(weights_out)


def check_row_len(row_len, nd: int, R: int, device) -> None:
    """Validate per-bucket row lengths: ``nd`` ``(R,)`` int32 tensors on
    ``device``, or None."""
    if row_len is None:
        return
    if len(row_len) != nd:
        raise ValueError(f"{len(row_len)} row_len tensors for {nd} buckets")
    for i, rl in enumerate(row_len):
        require(f"row_len[{i}]", rl, torch.int32, 1, device)
        if rl.shape[0] != R:
            raise ValueError(f"row_len[{i}] {tuple(rl.shape)} for {R} rows")
