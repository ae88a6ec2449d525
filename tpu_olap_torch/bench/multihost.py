"""The multi-host mesh with real processes: the counterpart of the JAX
package's `tools/multihost_check.py`.

`run` spawns `world` ranks (torch.multiprocessing, start method
"spawn"). Each opens the default process group as a user would
(`torch.distributed.init_process_group` with a `file://` store in
`workdir`, so that runs in parallel never share a port), builds its
engine with `num_shards` = world x `devices_per_rank` through `build`,
and runs the same statements in the same order: a first run, then
`repeats` timed runs. Each rank writes its frames, its metrics and its
counters (kernel launches, collectives and their bytes, the p50 of the
timed runs) to `workdir`; the parent reads them back, one record per
rank, and raises if a rank failed or the run outlived `timeout_s`.
Nothing here or in a rank imports JAX.

A statement is (label, sql) or (label, sql, config): `sql` a string, or
a list of strings run as one `sql_batch`; `config` is a dict of
EngineConfig fields set for that statement only. `build(num_shards,
device)` returns the rank's Engine with its tables registered; it must
pickle (a module-level function, or a functools.partial of one, such as
`file_engine` over the tables `write_tables` put in a file).

Usage (two ranks of two logical devices each, over gloo, on the CPU):

    tables = workdir / "tables.pkl"
    write_tables(tables, [("f", frame, {"time_column": "ts"})])
    ranks = run(2, 2, "gloo", "cpu",
                functools.partial(file_engine, path=str(tables)),
                [("total", "SELECT count(*) AS n FROM f")], workdir)
"""

from __future__ import annotations

import os
import pickle
import statistics
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch


def write_tables(path, tables: list):
    """Pickle [(name, data, register_table keywords)] for `file_engine`:
    `data` a frame, or None with the keywords holding `segments`."""
    with open(path, "wb") as f:
        pickle.dump(tables, f, protocol=pickle.HIGHEST_PROTOCOL)


def file_engine(num_shards: int, device: str, path: str, **config):
    """An Engine on `device` with `num_shards` over the tables of
    `write_tables`' file, `config` on top of EngineConfig's defaults
    (`fallback_on_device_failure` off unless given: a failure on the
    device path must fail the run, not be answered by the pandas
    interpreter)."""
    from tpu_olap_torch import Engine
    config.setdefault("fallback_on_device_failure", False)
    eng = Engine(device=device, num_shards=num_shards, **config)
    with open(path, "rb") as f:
        tables = pickle.load(f)
    for name, data, kw in tables:
        eng.register_table(name, data, **kw)
    return eng


def counters() -> dict:
    """The process's kernel launch and collective counters."""
    from tpu_olap_torch.executor import collective
    from tpu_olap_torch.kernels import fused_reduce as fr
    from tpu_olap_torch.kernels import row_mask as rm
    return {"b1": fr.launches, "seg": fr.seg_launches,
            "multi": fr.multi_launches, "mask": rm.launches,
            "collectives": collective.collectives,
            "collective_bytes": collective.collective_bytes}


def _statements(statements) -> list:
    return [(s[0], s[1], dict(s[2]) if len(s) > 2 else {})
            for s in statements]


def _run_statement(eng, sql, device: str):
    out = eng.sql_batch(list(sql)) if isinstance(sql, list) else eng.sql(sql)
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def _batch_reasons(eng, sqls) -> list:
    """batch.fusable's answer for each statement of a batch."""
    from tpu_olap_torch.executor.batch import fusable
    out = []
    for q in sqls:
        p = eng.planner.plan(q)
        plan = eng.runner._lower_cached(p.query, p.entry.segments)
        out.append(fusable(plan, eng.runner.mesh))
    return out


def _rank(rank, world, devices_per_rank, backend, device, build,
          statements, workdir, repeats, timeout_s):
    import torch.distributed as dist
    from tpu_olap_torch.executor import sharding as sh
    if device == "cuda":
        from tpu_olap_torch.utils.platform import force_virtual_devices
        force_virtual_devices(devices_per_rank)
        torch.cuda.set_device(sh.rank_mesh(
            rank, world, world * devices_per_rank, "cuda").devices[0])
    dist.init_process_group(
        backend, init_method=f"file://{Path(workdir) / 'store'}",
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    eng = None
    try:
        t = time.perf_counter()
        eng = build(world * devices_per_rank, device)
        mesh = eng.runner.mesh
        rec = {"rank": rank, "world": world, "backend": backend,
               "build_s": time.perf_counter() - t,
               "is_multihost": sh.is_multihost(mesh),
               "mesh": {"rank": mesh.rank, "world": mesh.world,
                        "size": mesh.size,
                        "devices": [str(d) for d in mesh.devices],
                        "local_ids": list(mesh.local_ids)},
               "frames": {}, "metrics": {}, "counts": {}, "first_ms": {},
               "p50_ms": {}, "batch_reasons": {}}
        for label, sql, cfg in _statements(statements):
            old = {k: getattr(eng.config, k) for k in cfg}
            for k, v in cfg.items():
                setattr(eng.config, k, v)
            try:
                before, seen = counters(), eng.runner.last_metrics
                t = time.perf_counter()
                rec["frames"][label] = _run_statement(eng, sql, device)
                rec["first_ms"][label] = (time.perf_counter() - t) * 1000
                after = counters()
                rec["counts"][label] = {k: after[k] - before[k]
                                        for k in after}
                m = eng.runner.last_metrics   # sys tables record none
                rec["metrics"][label] = None if m is seen else dict(m)
                if isinstance(sql, list):
                    rec["batch_reasons"][label] = _batch_reasons(eng, sql)
                ts = []
                for _ in range(repeats):
                    t = time.perf_counter()
                    _run_statement(eng, sql, device)
                    ts.append((time.perf_counter() - t) * 1000)
                if ts:
                    rec["p50_ms"][label] = statistics.median(ts)
            finally:
                for k, v in old.items():
                    setattr(eng.config, k, v)
        rec["totals"] = counters()
        # JAX, jaxlib or the JAX package (the port's top name differs)
        rec["imports_jax"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                     "tpu_olap")
                                 for m in sys.modules)
        path = Path(workdir) / f"rank{rank}.pkl"
        with open(path.with_suffix(".tmp"), "wb") as f:
            pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path.with_suffix(".tmp"), path)
        # no rank leaves while a peer may still wait on it
        dist.barrier()
    finally:
        if eng is not None:
            eng.close()
        dist.destroy_process_group()


def run(world: int, devices_per_rank: int, backend: str, device: str,
        build, statements, workdir, repeats: int = 3,
        timeout_s: float = 300.0) -> list:
    """Spawn the ranks, wait for them, and return their records in rank
    order (see the module docstring). Raises when a rank raised or
    exited nonzero (torch.multiprocessing's ProcessRaisedException /
    ProcessExitedException) or when the ranks are not done within
    `timeout_s` (TimeoutError, after the ranks are killed); the process
    group's own timeout is `timeout_s` too."""
    import torch.multiprocessing as mp
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in [workdir / "store", *workdir.glob("rank*.pkl")]:
        stale.unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank, args=(world, devices_per_rank, backend, device, build,
                     list(statements), str(workdir), repeats, timeout_s),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"the {world} ranks were not done within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
