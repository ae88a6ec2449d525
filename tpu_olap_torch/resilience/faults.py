"""Generalized fault injection (EngineConfig.fault_injector).

The injector signature is unchanged — ``callable(stage, attempt)`` that
may raise — but the call sites now cover every failure point the
resilience layer must survive, not just the device dispatch:

    dispatch       executor.runner._dispatch (per retry attempt)
    host-transfer  device buffers -> numpy materialization
    reprobe        the post-wedge / healer device probe
    ingest         Engine.register_table's segment build
    batch-leg      per-leg finalize of a fused shared-scan dispatch
    append         Engine.append before any state change (crash before
                   the WAL write: the batch is fully absent)
    wal-write      just before the WAL frame write (crash before
                   durability: the batch was never acknowledged)
    wal-replay     per replayed record during crash recovery (a crash
                   mid-recovery leaves the table cleanly base-only;
                   re-registration replays again)
    compact        the background compactor before the sealed-set swap
                   (a crashed compaction leaves the delta intact)
    spill-write    segments/store.py before any chunk file is written
                   (a crashed spill leaves at most orphan chunks; the
                   manifest — and therefore recovery — is unchanged)
    manifest-swap  before the checkpoint manifest's atomic rename (the
                   spilled chunks exist but the previous manifest stays
                   authoritative; the WAL is not truncated)
    store-load     Engine.register_table before the store's recovery
                   ladder runs (a crash mid-recovery aborts the
                   registration; a retry loads the store again)
    wal-truncate   after the manifest swap, before the WAL rewrite (the
                   log keeps pre-checkpoint frames; replay filters them
                   by the manifest watermark)
    stage-plan     executor.stages boundary entering the plan stage of
    stage-enqueue  a query's stage graph (and likewise for enqueue /
    stage-transfer transfer / finalize / assemble / background) — fired
    stage-finalize by StageScheduler.stage before the pool slot is
    stage-assemble taken, so a fault here is a failure BETWEEN stages:
    stage-background  after the previous stage committed its work, before
                   the next one starts (docs/EXECUTION.md)

Backwards compatibility: a plain callable (no ``stages`` attribute)
fires ONLY at the classic ``dispatch`` site, exactly as before — every
pre-existing test and tool keeps its behavior. An injector that wants
the generalized sites declares them:

    class Chaos:
        stages = None            # None = every site
        # or stages = {"dispatch", "host-transfer"}
        def __call__(self, stage, attempt): ...

or uses the FaultInjector helper below.
"""

from __future__ import annotations

LEGACY_STAGES = ("dispatch",)

ALL_STAGES = ("dispatch", "host-transfer", "reprobe", "ingest",
              "batch-leg", "append", "wal-write", "wal-replay",
              "compact", "spill-write", "manifest-swap", "store-load",
              "wal-truncate", "stage-plan", "stage-enqueue",
              "stage-transfer", "stage-finalize", "stage-assemble",
              "stage-background")


def maybe_inject(config, stage: str, attempt: int = 0) -> None:
    """Fire the configured fault injector at `stage` if it opted in.
    Injectors without a `stages` attribute are legacy dispatch-only."""
    inj = getattr(config, "fault_injector", None)
    if inj is None:
        return
    stages = getattr(inj, "stages", LEGACY_STAGES)
    if stages is not None and stage not in stages:
        return
    inj(stage, attempt)


class FaultInjector:
    """Deterministic seeded chaos injector for tests and bench runs:
    raises RuntimeError at each opted-in site with probability `rate`
    (or on an explicit schedule via `fail_calls`). `stages=None` opts
    into every site.

    `latency_s` > 0 turns a hit into a SLEEP instead of a raise — the
    slow-device/slow-link chaos mode: the query still
    succeeds, just late, which is exactly the drift the regression
    sentinel (obs.sentinel) must catch and attribute to the injected
    stage. A hit with `latency_s` at 0 keeps the classic raise."""

    def __init__(self, seed: int = 0, rate: float = 0.0, stages=None,
                 fail_calls=(), latency_s: float = 0.0):
        import random
        self.rng = random.Random(seed)
        self.rate = float(rate)
        self.stages = stages
        self.fail_calls = set(fail_calls)
        self.latency_s = float(latency_s)
        self.calls = 0
        self.faults = 0
        self.by_stage: dict[str, int] = {}

    def __call__(self, stage: str, attempt: int):
        self.calls += 1
        hit = self.calls in self.fail_calls or (
            self.rate > 0 and self.rng.random() < self.rate)
        if hit:
            self.faults += 1
            self.by_stage[stage] = self.by_stage.get(stage, 0) + 1
            if self.latency_s > 0:
                import time
                time.sleep(self.latency_s)
                return
            raise RuntimeError(
                f"injected fault #{self.faults} at {stage} "
                f"(call {self.calls}, attempt {attempt})")
