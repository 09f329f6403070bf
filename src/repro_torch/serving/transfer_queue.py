"""Async transfer job queue: ordered execution, batched payload movement,
bounded retry with backoff, and fail-closed worker-death handling.

The connector no longer moves bytes inline on the engine thread.  Each
store/load becomes a ``TransferJob`` enqueued on a single background worker,
which (a) preserves the total event order the analyzer checks — jobs execute
strictly FIFO and the engine joins a job before emitting the claim-lifecycle
event that must follow it — and (b) batches every multi-block job's payload
movement through one ``kv_block_copy`` kernel gather instead of per-block
copies (kernels/kv_block_copy.gather_payloads).

Fault handling (chaos.py triggers):

  - **Transient faults** (``TransientTransferFault`` raised by a job fn)
    are retried HERE with exponential backoff, up to
    ``RetryPolicy.max_attempts`` attempts per faulting site.  Job fns are
    written to be resumable: they track per-block progress, so a re-run
    continues at the faulted block instead of redoing finished ones.  The
    fn stops raising once its own attempt budget is spent (escalating the
    block to a permanent, claim-scoped failure), so the loop always
    terminates; ``max_total_attempts`` is a backstop, not the contract.
  - **Worker death** (``WorkerKilled``) poisons the current job (error set,
    event signalled), drains every queued job with the same error so no
    waiter is ever stranded (the old code deadlocked here), and exits the
    thread; the next ``submit`` starts a fresh worker.  Waiters see
    ``TransferWorkerDied`` and turn it into the ordered fail-closed path.

The queue is deliberately small: determinism is a correctness property here
(witness paths are ordered sequences), so the only concurrency is
engine-thread vs worker-thread with explicit joins at lifecycle boundaries.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.serving.chaos import (
    TransferWorkerDied,
    TransientTransferFault,
    WorkerKilled,
)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for transient transfer faults.

    ``max_attempts`` counts attempts per faulting block site (1 initial +
    retries); the backoff sleeps the WORKER thread, never the engine thread.
    """

    max_attempts: int = 4
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0
    backoff_cap_s: float = 0.05

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return min(
            self.backoff_base_s * self.backoff_factor ** max(0, attempt - 1),
            self.backoff_cap_s,
        )


DEFAULT_RETRY_POLICY = RetryPolicy()


@dataclass
class TransferJob:
    """Handle for an enqueued transfer; ``wait()`` joins its completion."""

    job_id: int
    kind: str  # "store" | "load" | "spill"
    fn: Callable[[], None] = field(repr=False, default=None)
    policy: RetryPolicy = DEFAULT_RETRY_POLICY
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    error: Optional[BaseException] = None
    attempts: int = 0  # transient re-runs performed by the worker

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)
        if self.error is not None:
            raise self.error

    @property
    def finished(self) -> bool:
        return self._done.is_set()


class TransferQueue:
    """FIFO background worker executing transfer jobs in submission order."""

    # backstop against a job fn that raises transient faults forever; fns
    # bound their own per-block attempts well below this
    max_total_attempts: int = 256

    def __init__(self, metrics=None) -> None:
        self._q: "queue.Queue[Optional[TransferJob]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.executed_jobs = 0
        self.worker_deaths = 0
        self.retries_performed = 0
        # optional registry mirror (serving/metrics.MetricsRegistry): the
        # plain int counters above stay the test/bench surface; these make
        # the same quantities visible on the exported exposition
        self._m_jobs = self._m_deaths = self._m_retries = None
        if metrics is not None:
            self._m_jobs = metrics.counter(
                "transfer_jobs_executed_total", "Transfer jobs run by the queue worker"
            )
            self._m_deaths = metrics.counter(
                "transfer_worker_deaths_total", "Transfer worker threads killed mid-job"
            )
            self._m_retries = metrics.counter(
                "transfer_queue_retries_total",
                "Transient job re-runs performed by the queue (backoff retries)",
            )

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="kv-transfer-worker", daemon=True
                )
                self._worker.start()

    def _execute(self, job: TransferJob) -> Optional[WorkerKilled]:
        """Run one job to a terminal state; returns the kill if the worker
        must die (the job is already poisoned)."""
        while True:
            try:
                job.fn()
                return None
            except TransientTransferFault as e:
                job.attempts += 1
                if job.attempts >= self.max_total_attempts:
                    job.error = e  # runaway-retry backstop
                    return None
                self.retries_performed += 1
                if self._m_retries is not None:
                    self._m_retries.inc()
                time.sleep(job.policy.delay_s(job.attempts))
                continue  # resumable fn: continues at the faulted block
            except WorkerKilled as e:
                # poison THIS job; the caller drains the rest and exits
                job.error = TransferWorkerDied(e.reason, e.block_id, e.direction)
                return e
            except BaseException as e:  # propagate to the joining engine thread
                job.error = e
                return None

    def _drain_dead(self, kill: WorkerKilled) -> None:
        """Error out every queued job so no waiter is ever stranded."""
        while True:
            try:
                job = self._q.get_nowait()
            except queue.Empty:  # lint: allow[fail-closed-except] drain termination: Empty means every stranded waiter has been poisoned
                return
            if job is not None:
                job.error = TransferWorkerDied(
                    f"queued behind worker death: {kill.reason}"
                )
                job._done.set()
            self._q.task_done()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            kill = self._execute(job)
            self.executed_jobs += 1
            if self._m_jobs is not None:
                self._m_jobs.inc()
            job._done.set()
            self._q.task_done()
            if kill is not None:
                self.worker_deaths += 1
                if self._m_deaths is not None:
                    self._m_deaths.inc()
                self._drain_dead(kill)
                return  # the thread dies; submit() restarts a fresh one

    def submit(self, job: TransferJob) -> TransferJob:
        self._ensure_worker()
        self._q.put(job)
        return job

    def flush(self) -> None:
        """Join all currently queued jobs."""
        self._q.join()

    def shutdown(self) -> None:
        """Stop the worker thread (idempotent); part of engine teardown."""
        with self._lock:
            worker = self._worker
            self._worker = None
        if worker is not None and worker.is_alive():
            self._q.put(None)
            worker.join(timeout=5.0)
