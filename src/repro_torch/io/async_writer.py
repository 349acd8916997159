"""Background checkpoint writer (a copy of the reference's
``repro/io/async_writer.py``).

The caller snapshots state to host buffers (a device-to-host copy and
host copies), enqueues a write job, and keeps computing while the previous
snapshot flushes to disk.  The worker touches only what the job holds:
host arrays, never a tensor.

One daemon worker drains the queue strictly in submission order, so a
``wait=True`` save routed through ``submit`` + :meth:`wait` can never land
*before* an earlier queued step (the ordering bug an inline write next to
a live queue had).  Jobs that fail with an ``OSError`` (flaky disk, NFS
hiccup) are retried in place with exponential backoff before the error
counts; job exceptions never kill the worker — after the retries they are
wrapped in :class:`WriteJobError` naming the job (step / partition /
path, from the ``context=`` passed to :meth:`submit` plus whatever the
exception itself carries), chained to the original traceback, and
re-raised on the caller's thread by :meth:`check` / :meth:`wait` /
:meth:`close` — the "surfaced on the next checkpoint boundary" contract.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class WriteJobError(OSError):
    """A background write that failed even after the writer's retries.

    Subclasses ``OSError`` so historical ``except OSError`` handling
    keeps working; ``step`` / ``part_id`` / ``path`` name the failed job
    and ``__cause__`` chains the original exception + traceback."""

    def __init__(self, msg: str, *, step: Optional[int] = None,
                 part_id: Optional[int] = None,
                 path: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.part_id = part_id
        self.path = path


class AsyncWriter:
    """Single background worker executing submitted jobs in FIFO order.

    ``max_pending`` bounds the queue: when the writer falls behind by that
    many jobs, ``submit`` blocks until the worker catches up —
    backpressure instead of unbounded snapshot accumulation in host
    memory (each queued checkpoint job holds a full state copy).  The
    default (0) is unbounded."""

    # appended by the worker thread, drained by the caller's check()
    _guarded_by_ = {"_err": "_err_lock"}

    def __init__(self, name: str = "async-ckpt-writer",
                 max_pending: int = 0, retries: int = 2,
                 retry_backoff_s: float = 0.05):
        """``retries`` re-runs a job that raised an ``OSError`` that many
        extra times (exponential backoff starting at ``retry_backoff_s``)
        before the failure poisons the queue — checkpoint jobs stage
        through tmp dirs, so a re-run is idempotent."""
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: List[BaseException] = []
        self._err_lock = threading.Lock()
        self._closed = False
        self.retries = max(int(retries), 0)
        self.retry_backoff_s = retry_backoff_s
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=self._drain, daemon=True, name=name
        )
        self._worker.start()

    # ------------------------------------------------------------- submit
    def submit(self, fn: Callable, *args: Any,
               context: Optional[Dict[str, Any]] = None,
               **kwargs: Any) -> None:
        """Enqueue ``fn(*args, **kwargs)`` for the background worker;
        blocks when ``max_pending`` jobs are already waiting.  The
        arguments must be safe to use after return (host copies, not
        live mutable state).  ``context`` (e.g. ``dict(step=1200,
        path=...)``) labels any eventual failure of this job — see
        :class:`WriteJobError`."""
        if self._closed:
            raise RuntimeError("AsyncWriter is closed")
        self._q.put((fn, args, kwargs, context))

    def _wrap(self, e: BaseException,
              context: Optional[Dict[str, Any]]) -> WriteJobError:
        ctx = dict(context or {})
        step = ctx.get("step")
        part = getattr(e, "part_id", None)
        if part is None:
            part = ctx.get("part_id")
        path = getattr(e, "filename", None) or ctx.get("path")
        bits = []
        if step is not None:
            bits.append(f"step {step}")
        if part is not None:
            bits.append(f"partition {part}")
        if path:
            bits.append(f"path {path!r}")
        where = ", ".join(bits) or "no job context"
        err = WriteJobError(
            f"background checkpoint write failed ({where}): {e}",
            step=step, part_id=part, path=path,
        )
        err.__cause__ = e  # keep the original traceback in the chain
        return err

    def _drain(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                self._run_job(job)
            finally:
                # drop the job BEFORE blocking on the next get(): a
                # queued bound method (e.g. Session._write_and_mark)
                # must not keep its owner alive while the worker idles,
                # or the owner's weakref finalizer can never fire
                job = None
                self._q.task_done()

    def _run_job(self, job) -> None:
        fn, args, kwargs, context = job
        attempts = self.retries + 1
        for attempt in range(attempts):
            if attempt:
                time.sleep(
                    self.retry_backoff_s * (2 ** (attempt - 1))
                )
            try:
                fn(*args, **kwargs)
                return
            except OSError as e:  # transient disk: retry in place
                if attempt + 1 >= attempts:
                    with self._err_lock:
                        self._err.append(self._wrap(e, context))
            except BaseException as e:  # not retryable
                with self._err_lock:
                    self._err.append(self._wrap(e, context))
                return

    # ------------------------------------------------------------ surface
    def check(self) -> None:
        """Re-raise the oldest pending background error (non-blocking);
        no-op when every completed job succeeded."""
        with self._err_lock:
            err = self._err.pop(0) if self._err else None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Block until every queued job has run, then surface errors."""
        self._q.join()
        self.check()

    @property
    def pending(self) -> int:
        """Jobs submitted but not yet finished (approximate)."""
        return self._q.unfinished_tasks

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the worker.  ``drain=True`` (default) waits up to
        ``timeout`` seconds for queued jobs to finish (the worker
        processes the FIFO queue, then the stop sentinel) and re-raises
        any background error; if a write is still stuck after the timeout
        (e.g. stalled storage) a ``RuntimeWarning`` is emitted and close
        returns — shutdown stays bounded, the daemon worker keeps
        flushing until interpreter exit.  ``drain=False`` lets queued
        jobs run without blocking on their completion (it may still wait
        briefly for a queue slot to enqueue the stop sentinel)."""
        if self._worker is None:
            return
        self._closed = True
        worker, self._worker = self._worker, None
        try:
            # a full queue normally frees a slot as the worker drains, so
            # wait up to the timeout for the sentinel even when
            # drain=False (the Session-finalizer path) — giving up early
            # would leak the worker this call exists to reclaim.  Only a
            # write stuck past the timeout (dead storage) leaves the
            # daemon running, with a warning.
            self._q.put(None, timeout=timeout)
        except queue.Full:
            import warnings

            warnings.warn(
                f"AsyncWriter.close: queue still full after {timeout}s "
                "(stuck background write?); worker left running as a "
                "daemon",
                RuntimeWarning,
                stacklevel=2,
            )
        if drain:
            worker.join(timeout=timeout)
            if worker.is_alive():
                import warnings

                warnings.warn(
                    f"AsyncWriter.close: background writes still in "
                    f"flight after {timeout}s; continuing shutdown "
                    "without them (daemon worker keeps flushing)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self.check()
