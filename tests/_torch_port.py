"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: hand a JAX-ingested table to the port as plain numpy objects."""

from tpu_olap_torch.segments.carry import carry_table


def export_segments(t) -> dict:
    """A JAX-package TableSegments as the plain objects carry_table takes."""
    return dict(
        name=t.name,
        schema={c: ct.value for c, ct in t.schema.items()},
        dictionaries={c: list(d.values) for c, d in t.dictionaries.items()},
        segments=[{
            "columns": dict(s.columns),
            "null_masks": dict(s.null_masks),
            "meta": {"segment_id": s.meta.segment_id,
                     "n_valid": s.meta.n_valid,
                     "time_min": s.meta.time_min,
                     "time_max": s.meta.time_max,
                     "column_min": dict(s.meta.column_min),
                     "column_max": dict(s.meta.column_max)},
        } for s in t.segments],
        block_rows=t.block_rows, time_partition=t.time_partition)


def carry_into(engine, jax_engine, name, star_schema=None):
    """Register the JAX engine's ingested table `name` in the port engine,
    carried across (same blocks, codes, dictionaries and manifest)."""
    seg = carry_table(**export_segments(
        jax_engine.catalog.get(name).segments))
    entry = jax_engine.catalog.get(name)
    engine.register_table(name, None, time_column=entry.time_column,
                          star_schema=star_schema, segments=seg)
    return seg


def sql_literals(module, starts=("SELECT",), skip=()) -> list:
    """(test name, string) of every string literal that starts with one
    of `starts` inside the test functions of `module`, in source order —
    the SQL a JAX-package test file runs, read from that file itself
    rather than copied. Tests whose names hold a `skip` word are left
    out."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) \
                or not fn.name.startswith("test_") \
                or any(w in fn.name for w in skip):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Constant) and isinstance(node.value, str)\
                    and node.value.lstrip().startswith(starts):
                out.append((fn.name, node.value))
    return out


def cpu_engine(**kw):
    """The port's Engine on the CPU, with `fallback_on_device_failure` off
    unless the test sets it: a failure on the port's own device path then
    fails the test, instead of being answered by the pandas interpreter
    (which gives the JAX package's answer as well)."""
    from tpu_olap_torch import Engine
    kw.setdefault("fallback_on_device_failure", False)
    return Engine(device="cpu", **kw)
