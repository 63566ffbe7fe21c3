"""Typed failure surface of the exec runtime (the backpressure contract).

The port's copy of the JAX package's ``exec/errors.py``.

Spark's accelerated executor communicates overload through typed,
retryable conditions rather than stalls (task rejection → resubmission;
SURVEY §1's many-tasks-one-device shape).  The serving layer does the
same: a full queue and a missed deadline are DISTINCT, catchable types so
a closed-loop client can tell "back off and resend" from "this request is
dead" — and tests can assert the exact condition.
"""

from __future__ import annotations


class ExecError(RuntimeError):
    """Base of every exec-runtime failure."""


class ExecQueueFull(ExecError):
    """Backpressure: the bounded request queue is at depth; resubmit later.

    Raised by ``QueryScheduler.submit`` — never silently dropped work."""

    def __init__(self, depth: int):
        self.depth = depth
        super().__init__(
            f"exec queue full (depth {depth}) — backpressure: retry later "
            "or raise SRJT_EXEC_QUEUE_DEPTH")


class ExecDeadlineExceeded(ExecError):
    """The request's deadline passed while queued, deferred, or admitted."""

    def __init__(self, name: str, stage: str, waited_s: float):
        self.query = name
        self.stage = stage            # "queue" | "admission"
        self.waited_s = waited_s
        super().__init__(
            f"deadline exceeded for {name!r} in {stage} after "
            f"{waited_s:.3f}s")


class ExecShutdown(ExecError):
    """The scheduler is shut down; the request was not (or will not be)
    executed."""
