"""Unified retry/deadline policy: one backoff, one budget, typed errors.

Before this module every layer invented its own failure handling:
``cluster/transport.rpc`` was a single shot with a fixed timeout,
``cluster/remote`` hard-coded 30s, and nothing connected a request's
remaining time to the timeouts of the RPCs issued on its behalf — a
query could sit in retry loops long after its client gave up.

Two primitives fix that:

- **Deadline propagation.** The REST/gRPC edge opens ``deadline(budget)``
  once per request; the absolute expiry rides a contextvar through the
  query batcher, shard fan-out, replication, and every transport call
  (``tracing.propagate`` carries it onto pool threads). Layers derive
  per-attempt timeouts from ``remaining()`` — an RPC can never be given
  more time than its request has left, and ``DeadlineExceeded`` is a
  typed error the API edges map to 504/DEADLINE_EXCEEDED instead of a
  generic 500.

- **RetryPolicy.** Capped exponential backoff with FULL jitter
  (sleep ~ U(0, min(cap, base*mult^attempt)) — the AWS-analysis shape
  that decorrelates retry storms), a retriable-vs-terminal classifier,
  and deadline awareness: a retry whose backoff would outlive the
  budget raises ``DeadlineExceeded`` immediately rather than sleeping
  into a guaranteed timeout.
"""

from __future__ import annotations

import contextvars
import random
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

#: absolute expiry (time.monotonic seconds) of the current request's
#: budget; None = no deadline set (background/admin work)
_deadline_var: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "weaviate_tpu_deadline", default=None)


class DeadlineExceeded(TimeoutError):
    """The request's time budget ran out (typed: REST maps it to 504
    with code DEADLINE_EXCEEDED, gRPC to StatusCode.DEADLINE_EXCEEDED —
    never a generic 500)."""

    def __init__(self, layer: str = "", message: str = ""):
        super().__init__(message
                         or f"deadline exceeded{' in ' + layer if layer else ''}")
        self.layer = layer


class OverloadedError(RuntimeError):
    """Typed retriable overload (bounded queue full, admission refused).
    Carries the backoff hint REST surfaces as a ``Retry-After`` header
    on its 503."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@contextmanager
def deadline(budget_s: float | None):
    """Scope a time budget. Nested budgets only ever SHRINK the window —
    an inner layer granting itself more time than its caller has left
    would defeat propagation. ``None``/non-positive = no-op."""
    if budget_s is None or budget_s <= 0:
        yield
        return
    expiry = time.monotonic() + budget_s
    outer = _deadline_var.get()
    if outer is not None:
        expiry = min(expiry, outer)
    token = _deadline_var.set(expiry)
    try:
        yield
    finally:
        _deadline_var.reset(token)


def current_deadline() -> float | None:
    """Absolute monotonic expiry, for handing across threads
    (``tracing.propagate`` captures this)."""
    return _deadline_var.get()


def set_deadline(expiry: float | None):
    """Install an absolute expiry captured elsewhere; returns the reset
    token. Worker-thread plumbing only — request code uses
    ``deadline()``."""
    return _deadline_var.set(expiry)


def reset_deadline(token) -> None:
    _deadline_var.reset(token)


def remaining() -> float | None:
    """Seconds left in the budget (may be <= 0), None when no deadline
    is set."""
    expiry = _deadline_var.get()
    if expiry is None:
        return None
    return expiry - time.monotonic()


def check(layer: str = "") -> None:
    """Raise ``DeadlineExceeded`` if the budget is spent. Call before
    starting work that is pointless to begin with no time left."""
    rem = remaining()
    if rem is not None and rem <= 0:
        _count_deadline(layer)
        raise DeadlineExceeded(layer)


def budget_timeout(default_s: float, layer: str = "") -> float:
    """Per-attempt timeout derived from the budget: ``min(default,
    remaining)``. Raises ``DeadlineExceeded`` when nothing is left —
    issuing an IO with a zero timeout just converts the typed error
    into a confusing transport one."""
    rem = remaining()
    if rem is None:
        return default_s
    if rem <= 0:
        _count_deadline(layer)
        raise DeadlineExceeded(layer)
    return min(default_s, rem)


def _count_deadline(layer: str) -> None:
    try:
        from weaviate_tpu_torch.runtime.metrics import deadline_exceeded_total

        deadline_exceeded_total.labels(layer or "unknown").inc()
    except Exception:  # pragma: no cover
        pass


# -- classification -----------------------------------------------------------

#: HTTP-ish statuses worth another attempt: transport-level failure (0),
#: throttling, and gateway-class upstream trouble. A 4xx or a handler
#: 500 means the peer is alive and deterministic — retrying replays the
#: same failure.
RETRIABLE_STATUSES = frozenset({0, 429, 502, 503, 504})


def default_retriable(exc: BaseException) -> bool:
    """The repo-wide retriable-vs-terminal line. Circuit-open is
    TERMINAL here: the breaker already knows the peer is down, and
    burning backoff against it is exactly the budget leak breakers
    exist to stop — callers fail over to another replica instead."""
    from weaviate_tpu_torch.cluster.transport import CircuitOpenError, RpcError

    if isinstance(exc, (DeadlineExceeded, CircuitOpenError)):
        return False
    if isinstance(exc, OverloadedError):
        return True
    if isinstance(exc, RpcError):
        # a per-attempt TIMEOUT already burned its full time ceiling —
        # retrying burns another. Fast transport failures (refused,
        # reset, half-dead HTTP) stay retriable; slow death is the
        # failover layers' job.
        if exc.timed_out:
            return False
        return exc.status in RETRIABLE_STATUSES
    return False


@dataclass
class RetryPolicy:
    """Capped exponential backoff with full jitter, deadline-capped.

    ``call(fn, *args, **kwargs)`` runs ``fn`` up to ``max_attempts``
    times. Terminal errors re-raise immediately; retriable ones back
    off ``U(0, min(cap, base * mult^attempt))`` seconds (an
    ``OverloadedError``'s ``retry_after_s`` floors the draw). A backoff
    that cannot fit in the remaining budget raises ``DeadlineExceeded``
    with the last error chained — the caller learns BOTH that time ran
    out and why the attempts failed."""

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    multiplier: float = 2.0
    retriable: object = staticmethod(default_retriable)
    #: seeded stream for reproducible chaos runs; None = module random
    rng: random.Random | None = field(default=None, repr=False)
    op: str = "rpc"

    def backoff_s(self, attempt: int) -> float:
        """Jittered sleep before attempt ``attempt+1`` (0-based)."""
        ceiling = min(self.cap_s, self.base_s * (self.multiplier ** attempt))
        draw = (self.rng or random).random()
        return draw * ceiling

    def call(self, fn, *args, **kwargs):
        last: BaseException | None = None
        for attempt in range(self.max_attempts):
            check(self.op)
            try:
                result = fn(*args, **kwargs)
                if attempt:
                    _count_retry(self.op, "recovered")
                return result
            except BaseException as e:
                if not self.retriable(e) \
                        or attempt == self.max_attempts - 1:
                    if attempt:
                        _count_retry(self.op, "exhausted")
                    raise
                last = e
                sleep = self.backoff_s(attempt)
                if isinstance(e, OverloadedError):
                    sleep = max(sleep, e.retry_after_s)
                rem = remaining()
                if rem is not None and sleep >= rem:
                    # the budget cannot absorb another attempt: surface
                    # the TYPED timeout (chained to the real failure)
                    # instead of sleeping into a guaranteed miss
                    _count_retry(self.op, "deadline")
                    _count_deadline(self.op)
                    raise DeadlineExceeded(
                        self.op,
                        f"deadline exhausted after {attempt + 1} "
                        f"attempt(s) of {self.op}: {e}") from e
                _count_retry(self.op, "retried")
                time.sleep(sleep)
        raise last  # pragma: no cover — loop always returns or raises


def _count_retry(op: str, outcome: str) -> None:
    try:
        from weaviate_tpu_torch.runtime.metrics import retries_total

        retries_total.labels(op, outcome).inc()
    except Exception:  # pragma: no cover
        pass
