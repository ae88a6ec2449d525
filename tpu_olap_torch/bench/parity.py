"""Result-parity harness: device path vs pandas fallback on the same SQL.

The direct analog of the reference's live-Druid parity tests (SURVEY.md §5:
druid-path results vs fallback-path results on identical data) and of the
"result parity" metric (BASELINE.json:2). The tests also hold the port
against the JAX package with the same frame comparison. Tolerance rules
per query class (SURVEY.md §8.4 #2): exact for integers/strings/row sets,
relative float tolerance for float accumulations (summation order differs
between device reductions and pandas), and a wide relative band for
HLL/theta approximate count-distinct columns.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from tpu_olap_torch.planner.fallback import execute_fallback


class ParityError(AssertionError):
    pass


def _f64(s: pd.Series) -> np.ndarray:
    """float64 view with any NA flavor (np.nan, pd.NA, None) -> NaN."""
    if pd.api.types.is_extension_array_dtype(s.dtype):
        return s.to_numpy(dtype=np.float64, na_value=np.nan)
    if s.dtype == object:
        return np.asarray([np.nan if pd.isna(v) else float(v) for v in s],
                          dtype=np.float64)
    return s.to_numpy(dtype=np.float64)


def pure_config(config):
    """The oracle-side config: derived-table bodies stay on the pandas
    interpreter so the fallback is an INDEPENDENT execution — never a
    re-run of the device path it is checking."""
    import dataclasses
    if not getattr(config, "fallback_derived_on_device", False):
        return config
    return dataclasses.replace(config, fallback_derived_on_device=False)


def run_both(engine, sql: str):
    """Execute `sql` on the accelerated path AND the fallback interpreter.
    Returns (device_df, fallback_df, plan). Raises if the planner did not
    rewrite (use engine.sql alone for fallback-only shapes)."""
    device = engine.sql(sql)
    plan = engine.last_plan
    if not plan.rewritten:
        raise ParityError(
            f"query did not stay on the device path: {plan.fallback_reason}")
    fb = execute_fallback(plan.stmt, engine.catalog,
                          pure_config(engine.config))
    return device, fb, plan


def assert_frame_parity(a: pd.DataFrame, b: pd.DataFrame,
                        float_rtol: float = 1e-9, float_atol: float = 1e-6,
                        approx_cols: tuple = (), approx_rtol: float = 0.12,
                        ordered: bool = False, label: str = ""):
    """Compare two result frames column-wise. When `ordered` is False the
    frames are canonically re-sorted by every exact column first (ORDER BY
    ties may legally differ between paths)."""
    tag = f"[{label}] " if label else ""
    if list(a.columns) != list(b.columns):
        raise ParityError(f"{tag}column sets differ: "
                          f"{list(a.columns)} vs {list(b.columns)}")
    if len(a) != len(b):
        raise ParityError(f"{tag}row counts differ: {len(a)} vs {len(b)}")
    if len(a) == 0:
        return
    a = a.reset_index(drop=True)
    b = b.reset_index(drop=True)

    def is_float(s):
        return pd.api.types.is_float_dtype(s)

    if not ordered:
        keys = [c for c in a.columns
                if not is_float(a[c]) and c not in approx_cols]
        quantized = not keys
        if quantized:
            # all-float frame: sort by scale-relative quantized keys so
            # path-dependent summation jitter (well inside float_rtol)
            # cannot flip the canonical order and misalign rows
            keys = list(a.columns)

        def canon(df):
            sk = df[keys]
            if quantized:
                scale = sk.abs().max().replace(0, 1.0)
                sk = (sk / scale).round(7)
            idx = sk.sort_values(keys, kind="stable").index
            return df.loc[idx].reset_index(drop=True)

        a, b = canon(a), canon(b)

    for c in a.columns:
        av, bv = a[c], b[c]
        if c in approx_cols:
            x = av.to_numpy(dtype=np.float64)
            y = bv.to_numpy(dtype=np.float64)
            bad = ~np.isclose(x, y, rtol=approx_rtol, atol=2.0)
            if bad.any():
                i = int(np.argmax(bad))
                raise ParityError(
                    f"{tag}approx column {c!r} out of band at row {i}: "
                    f"{x[i]} vs {y[i]} (rtol={approx_rtol})")
            continue
        if is_float(av) or is_float(bv):
            x = _f64(av)
            y = _f64(bv)
            both_nan = np.isnan(x) & np.isnan(y)
            bad = ~(np.isclose(x, y, rtol=float_rtol, atol=float_atol)
                    | both_nan)
            if bad.any():
                i = int(np.argmax(bad))
                raise ParityError(
                    f"{tag}float column {c!r} mismatch at row {i}: "
                    f"{x[i]} vs {y[i]}")
            continue
        if pd.api.types.is_datetime64_any_dtype(av) or \
                pd.api.types.is_datetime64_any_dtype(bv):
            if not (pd.to_datetime(av).reset_index(drop=True)
                    .equals(pd.to_datetime(bv).reset_index(drop=True))):
                raise ParityError(f"{tag}datetime column {c!r} mismatch")
            continue
        # NOT Series.where(cond, None): pandas treats other=None as "use
        # the default fill" (NaN), so nulls would survive and nan != nan
        xa = [None if pd.isna(v) else v for v in av]
        xb = [None if pd.isna(v) else v for v in bv]
        for i, (va, vb) in enumerate(zip(xa, xb)):
            if va != vb:
                raise ParityError(
                    f"{tag}column {c!r} mismatch at row {i}: "
                    f"{va!r} vs {vb!r}")


def check_query(engine, sql: str, approx_cols: tuple = (),
                ordered: bool = False, label: str = "", **tol):
    """run_both + assert_frame_parity in one call; returns the device frame."""
    device, fb, _ = run_both(engine, sql)
    assert_frame_parity(device, fb, approx_cols=approx_cols,
                        ordered=ordered, label=label, **tol)
    return device
