"""Background job queue for the serving layer (the port's copy of the JAX
package's ``serve/jobs.py``).

The reference web app runs training and improvement cycles *inside Flask
request handlers* and streams progress over SocketIO
(`MMT_website/Runfolder/app.py:634-793,1270-1272`) — a design weakness
SURVEY.md §3.5 flags. Here long-running work is enqueued onto worker
threads; each job carries a thread-safe console log that HTTP clients can
poll or stream (Server-Sent Events), and results are retained in memory
until the job is dropped.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


@dataclass
class Job:
    job_id: str
    kind: str
    status: str = PENDING
    created: float = field(default_factory=time.time)
    started: Optional[float] = None
    finished: Optional[float] = None
    result: Any = None
    error: str = ""
    _log: list[str] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _cond: threading.Condition = None  # type: ignore[assignment]
    _cancel: threading.Event = field(default_factory=threading.Event)

    def __post_init__(self):
        self._cond = threading.Condition(self._lock)

    # -- console -----------------------------------------------------------
    def log(self, message: str) -> None:
        """Append a console line (the print_to_console equivalent)."""
        with self._cond:
            self._log.append(message)
            self._cond.notify_all()

    def log_lines(self, since: int = 0) -> tuple[list[str], int]:
        with self._lock:
            lines = self._log[since:]
            return lines, len(self._log)

    def wait_lines(self, since: int, timeout: float = 10.0) -> tuple[list[str], int, bool]:
        """Block until new lines appear past `since` or the job ends.
        Returns (lines, new_cursor, finished)."""
        deadline = time.time() + timeout
        with self._cond:
            while len(self._log) <= since and self.status in (PENDING, RUNNING):
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            lines = self._log[since:]
            return lines, len(self._log), self.status not in (PENDING, RUNNING)

    # -- cancellation ------------------------------------------------------
    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def to_dict(self, include_result: bool = False) -> dict:
        d = {
            "job_id": self.job_id,
            "kind": self.kind,
            "status": self.status,
            "created": self.created,
            "started": self.started,
            "finished": self.finished,
            "error": self.error,
            "log_length": len(self._log),
        }
        if include_result:
            d["result"] = self.result
        return d


class QueueFullError(RuntimeError):
    """submit() refused: every retained job is still pending/running."""


class JobQueue:
    """FIFO job queue served by a pool of worker threads.

    Device work is single-streamed through the queue by default (workers=1)
    so the one GPU is never contended; raise `workers` for host-only job
    mixes.
    """

    def __init__(self, workers: int = 1, max_jobs: int = 256):
        self._jobs: dict[str, Job] = {}
        self._order: list[str] = []
        self._pending: list[tuple[str, Callable[[Job], Any]]] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._max_jobs = max_jobs
        self._shutdown = False
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"mmt-job-{i}")
            for i in range(workers)
        ]
        for w in self._workers:
            w.start()

    def submit(self, kind: str, fn: Callable[[Job], Any]) -> Job:
        """Enqueue fn(job) -> result. The callable receives the Job for
        logging/cancellation checks."""
        job = Job(job_id=uuid.uuid4().hex[:12], kind=kind)
        with self._wake:
            while len(self._order) >= self._max_jobs:
                # drop oldest finished job; if every retained job is still
                # pending/running, refuse rather than grow without bound
                for jid in list(self._order):
                    if self._jobs[jid].status in (DONE, FAILED, CANCELLED):
                        self._order.remove(jid)
                        del self._jobs[jid]
                        break
                else:
                    raise QueueFullError(
                        f"job queue full ({self._max_jobs} unfinished jobs)"
                    )
            self._jobs[job.job_id] = job
            self._order.append(job.job_id)
            self._pending.append((job.job_id, fn))
            self._wake.notify()
        return job

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def list_jobs(self) -> list[dict]:
        with self._lock:
            return [self._jobs[j].to_dict() for j in self._order]

    def shutdown(self) -> None:
        with self._wake:
            self._shutdown = True
            self._wake.notify_all()

    def _worker_loop(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._shutdown:
                    self._wake.wait()
                if self._shutdown:
                    return
                job_id, fn = self._pending.pop(0)
                job = self._jobs[job_id]
            if job.cancelled:
                with job._cond:
                    job.status = CANCELLED
                    job.finished = time.time()
                    job._cond.notify_all()
                continue
            with job._cond:
                job.status = RUNNING
                job.started = time.time()
            try:
                result = fn(job)
                with job._cond:
                    job.result = result
                    job.status = CANCELLED if job.cancelled else DONE
            except Exception:
                err = traceback.format_exc(limit=20)
                with job._cond:
                    job.error = err
                    job.status = FAILED
                job.log("ERROR: " + err.splitlines()[-1])
            finally:
                with job._cond:
                    job.finished = time.time()
                    job._cond.notify_all()
