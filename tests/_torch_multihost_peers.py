"""Two gloo ranks of the port's multi-host mesh in the cases where one
rank goes wrong, which tpu_olap_torch.bench.multihost's `run` (it fails
on any rank's error) cannot stage. `spawn(scenarios, tables, workdir)`
starts each scenario's ranks with this module's `peer_rank` and returns
each rank's outcomes, one per statement: {"frame", "metrics", "s"} for an answer,
{"error", "msg", "s"} for a raise, `s` the seconds the statement took.

- "retry": rank 1's second statement fails before its collective
  (an injected dispatch fault, degrade_shards_on_retry on): it retries
  at the global D. Its third fails after its collective: it raises, its
  peer answers. The fourth runs on both.
- "exit", "exit-deadline": rank 1 exits after the first statement,
  without closing anything; rank 0 runs the second (with
  query_deadline_s at DEADLINE_S in "exit-deadline").
- "late": query_deadline_s at LATE_DEADLINE_S; rank 1 sleeps LATE_S
  before the second statement; both meet at a barrier, then run the
  third.

Imports no JAX: the ranks import this module.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta
from pathlib import Path

from tpu_olap_torch.bench import multihost

WORLD, LOCAL = 2, 2
GROUP_TIMEOUT_S = 20
DEADLINE_S = 5.0
LATE_DEADLINE_S = 1.0
LATE_S = 2.5
SCENARIOS = ("retry", "exit", "exit-deadline", "late")
STATEMENTS = [
    "SELECT brand, sum(qty) AS s, count(*) AS n FROM f GROUP BY brand "
    "ORDER BY brand",
    "SELECT region, min(price) AS mn, max(qty) AS mx, sum(price) AS p "
    "FROM f GROUP BY region ORDER BY region",
    "SELECT year(ts) AS yr, count(*) AS n, sum(qty) AS s FROM f "
    "GROUP BY year(ts) ORDER BY yr",
    "SELECT brand, region, sum(qty) AS s FROM f GROUP BY brand, region "
    "ORDER BY brand, region",
]


def _run(eng, sql) -> dict:
    t = time.perf_counter()
    try:
        frame = eng.sql(sql)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return {"error": type(e).__name__, "msg": str(e),
                "s": time.perf_counter() - t}
    return {"frame": frame, "metrics": dict(eng.runner.last_metrics),
            "s": time.perf_counter() - t}


def _fail_after_the_collective_once():
    """Make this process's next gather_partials raise once its
    all_gather is done."""
    from tpu_olap_torch.executor import collective
    real = collective.gather_partials

    def gather_then_fail(*a, **kw):
        collective.gather_partials = real
        real(*a, **kw)
        raise RuntimeError("injected fault after the collective")
    collective.gather_partials = gather_then_fail


def peer_rank(rank, scenario, tables, workdir):
    import torch.distributed as dist
    from tpu_olap_torch.resilience.faults import FaultInjector
    dist.init_process_group(
        "gloo", init_method=f"file://{Path(workdir) / 'store'}", rank=rank,
        world_size=WORLD, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    config = {"degrade_shards_on_retry": True, "dispatch_retries": 1}
    if scenario == "exit-deadline":
        config["query_deadline_s"] = DEADLINE_S
    if scenario == "late":
        config["query_deadline_s"] = LATE_DEADLINE_S
    if scenario == "retry" and rank == 1:
        # the second dispatch of this rank: statement 2's first attempt
        config["fault_injector"] = FaultInjector(stages=("dispatch",),
                                                 fail_calls={2})
    eng = multihost.file_engine(WORLD * LOCAL, "cpu", tables, **config)
    out = [_run(eng, STATEMENTS[0])]
    if scenario.startswith("exit"):
        if rank == 1:
            os._exit(0)   # dies mid-run: no goodbye to the group
        out.append(_run(eng, STATEMENTS[1]))
    elif scenario == "retry":
        out.append(_run(eng, STATEMENTS[1]))
        if rank == 1:
            _fail_after_the_collective_once()
        out.append(_run(eng, STATEMENTS[2]))
        out.append(_run(eng, STATEMENTS[3]))
    elif scenario == "late":
        if rank == 1:
            time.sleep(LATE_S)
        out.append(_run(eng, STATEMENTS[1]))
        dist.barrier()
        out.append(_run(eng, STATEMENTS[2]))
    path = Path(workdir) / f"rank{rank}.pkl"
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump({"rank": rank, "outcomes": out,
                     "num_shards": eng.runner.mesh.size}, f)
    os.replace(path.with_suffix(".tmp"), path)
    # a group whose peer died cannot be torn down politely
    os._exit(0)


def spawn(scenarios, tables, workdir, timeout_s: float = 90.0) -> dict:
    """Run the scenarios side by side, each in its own folder of
    `workdir`: {scenario: {rank: record}} of the ranks that wrote one."""
    import torch.multiprocessing as mp
    ctxs = {}
    for sc in scenarios:
        (Path(workdir) / sc).mkdir(parents=True, exist_ok=True)
        ctxs[sc] = mp.start_processes(
            peer_rank, args=(sc, str(tables), str(Path(workdir) / sc)),
            nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        for sc, ctx in ctxs.items():
            while not ctx.join(timeout=max(0.1,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{sc}: ranks not done in "
                                       f"{timeout_s} s")
    finally:
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
    out = {}
    for sc in scenarios:
        out[sc] = {}
        for r in range(WORLD):
            path = Path(workdir) / sc / f"rank{r}.pkl"
            if path.exists():
                with open(path, "rb") as f:
                    out[sc][r] = pickle.load(f)
    return out
