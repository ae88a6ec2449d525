"""Device circuit breaker with a background healer thread.

Before this layer, every query against a wedged chip burned a full
`query_deadline_s` plus a reprobe before discovering what the previous
query already knew. The breaker makes that knowledge shared state:

- **closed**: normal serving. Terminal dispatch failures (retries
  exhausted) and deadline hits count consecutively; any success resets
  the count.
- **open**: `failure_threshold` consecutive failures trip it. check()
  fails fast with BreakerOpen (carrying the cooldown remaining as
  Retry-After) — the engine routes fallback-capable queries to the
  interpreter (degraded-but-correct, path="fallback_breaker") and
  legibly refuses the rest. No query touches the device.
- **half_open**: after `cooldown_s` the healer thread (spawned on trip,
  daemon) probes the device via the runner's existing reprobe round
  trip. Probe success closes the breaker; failure re-opens it for
  another cooldown. Queries never race the probe — healing is the
  healer's job, so an open breaker costs callers microseconds, not
  trial-query deadlines.

State is exported as `tpu_olap_breaker_state` (0=closed, 1=half_open,
2=open) plus a `tpu_olap_breaker_transitions_total{state=...}` counter.
`failure_threshold <= 0` disables the breaker entirely.
"""

from __future__ import annotations

import threading
import time

from tpu_olap_torch.obs.metrics import BREAKER_STATE_VALUES as STATE_VALUES
from tpu_olap_torch.resilience.errors import BreakerOpen

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"


class CircuitBreaker:
    def __init__(self, failure_threshold: int, cooldown_s: float,
                 probe=None, metrics=None, events=None):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = max(0.05, float(cooldown_s))
        self.probe = probe          # () -> bool; set by the runner
        self._events = events       # obs.events.EventLog (optional)
        self._pending_events: list = []  # emitted outside self._lock
        self._emit_lock = threading.Lock()  # flushers, in pop order
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._healer = None
        self._wake = threading.Event()  # close() cancels a healer wait
        self.failures_total = 0
        self.trips_total = 0
        self._m_state = self._m_trans = None
        if metrics is not None:
            self._m_state = metrics.gauge(
                "breaker_state",
                "Device circuit breaker (0=closed,1=half_open,2=open).")
            self._m_trans = metrics.counter(
                "breaker_transitions_total",
                "Breaker state transitions.", ("state",))
            self._m_state.set(0)

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    @property
    def state(self) -> str:
        return self._state

    def _set_state(self, state: str):
        # caller holds self._lock
        if state == self._state:
            return
        prev, self._state = self._state, state
        if self._m_state is not None:
            self._m_state.set(STATE_VALUES[state])
        if self._m_trans is not None:
            self._m_trans.inc(state=state)
        if self._events is not None:
            # queued, not emitted: emit may write to the JSONL file
            # sink, and a hung sink must not stall every dispatch's
            # record_success/record_failure behind our lock — callers
            # flush after releasing it (_flush_events)
            self._pending_events.append(
                {"state": state, "previous": prev,
                 "consecutive_failures": self._consecutive})

    def _flush_events(self):
        """Emit transitions queued by _set_state, OUTSIDE self._lock."""
        # unlocked empty probe: the common path (no transition) must not
        # pay a second lock round-trip per dispatch. A racing append is
        # never lost — the appending mutator flushes after its own
        # mutation.
        if self._events is None or not self._pending_events:
            return
        # _emit_lock serializes pop+emit across concurrent flushers, so
        # the log's transition order always matches the state machine's
        # (emit only enqueues to the async sink — never file I/O here)
        with self._emit_lock:
            with self._lock:
                pending, self._pending_events = self._pending_events, []
            for p in pending:
                self._events.emit("breaker", **p)

    # ------------------------------------------------------------ events

    def check(self):
        """Fail fast while open. Call before any device work."""
        if not self.enabled or self._state != OPEN:
            return
        with self._lock:
            if self._state != OPEN:
                return
            remaining = max(
                0.0,
                self.cooldown_s - (time.monotonic() - self._opened_at))
            raise BreakerOpen(
                f"device circuit breaker open "
                f"({self._consecutive} consecutive failures; healer "
                f"probes in {remaining:.2f}s)",
                retry_after_s=remaining or self.cooldown_s)

    def record_success(self):
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._set_state(CLOSED)
        self._flush_events()

    def record_failure(self, kind: str = "failure"):
        """A terminal device failure (retries exhausted, deadline hit,
        or probe failure) — NOT per-attempt errors the retry layer
        already absorbed."""
        if not self.enabled:
            return
        with self._lock:
            self.failures_total += 1
            self._consecutive += 1
            if self._state != OPEN and \
                    self._consecutive >= self.failure_threshold:
                self._trip_locked()
        self._flush_events()

    def _trip_locked(self):
        self.trips_total += 1
        self._opened_at = time.monotonic()
        self._set_state(OPEN)
        # _healer goes back to None ONLY under this lock with the state
        # CLOSED (healer retirement), so either it is None here — spawn
        # — or a live healer will re-check the state before retiring and
        # keep healing. Without that invariant a re-trip racing a
        # retiring healer could leave the breaker open with nobody
        # scheduled to close it.
        if self._healer is None:
            self._healer = threading.Thread(
                target=self._heal_loop, daemon=True,
                name="tpu-olap-breaker-healer")
            self._healer.start()

    def close(self):
        """Force-close (admin surface / tests). Cancels a waiting
        healer."""
        with self._lock:
            self._consecutive = 0
            self._set_state(CLOSED)
        self._flush_events()
        self._wake.set()

    # ------------------------------------------------------------ healer

    def _heal_loop(self):
        """Background healer: sleep out the cooldown, half-open, probe;
        success closes, failure re-opens for another cooldown. Retires
        (sets _healer back to None, under the lock) only once the
        breaker is CLOSED — a re-trip mid-probe (a query slipped through
        during half-open and failed) keeps this same thread healing
        instead of stranding the breaker open with no healer."""
        while True:
            # cleared HERE (the loop owns the event): a stale set() from
            # an earlier close() that raced a re-trip must not turn the
            # cooldown wait into a busy probe loop. A close() landing
            # between clear and wait re-sets it, so cancellation is
            # never lost — the wait returns and the state check retires.
            self._wake.clear()
            self._wake.wait(self.cooldown_s)
            with self._lock:
                if self._state == CLOSED:
                    self._healer = None
                    return
                if self._state == OPEN:
                    self._set_state(HALF_OPEN)
            self._flush_events()
            ok = False
            try:
                ok = bool(self.probe()) if self.probe is not None \
                    else True
            except Exception:  # noqa: BLE001 — a failed probe is data
                ok = False
            healed = False
            with self._lock:
                if self._state == HALF_OPEN:
                    if ok:
                        self._consecutive = 0
                        self._set_state(CLOSED)
                        self._healer = None
                        healed = True
                    else:
                        self._opened_at = time.monotonic()
                        self._set_state(OPEN)
                # OPEN here = re-tripped mid-probe; CLOSED = someone
                # closed us externally — either way the loop top decides
            self._flush_events()
            if healed:
                return
