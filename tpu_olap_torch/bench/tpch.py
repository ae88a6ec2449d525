"""TPC-H query shapes over a denormalized orderLineItemPartSupplier
fact (`olps`) — the reference's test backbone (SURVEY.md §5: a TPC-H
denormalized fact registered once plain and once accelerated, each query
asserting WHICH path serves it and that results agree).

`olps_frame` is the column recipe of the JAX package's TPC-H test suite
(tests/test_tpch.py `_olps`), and `QUERIES` holds that suite's 25
statements: all 22 query shapes (two each for Q5 and Q7) plus a monthly
timeseries. Each statement carries the path the planner gives it:
True where it is rewritten onto the device path (Q11 and Q18 after their
uncorrelated subqueries run and inline), False where the pandas fallback
interpreter serves it (correlated subqueries, derived tables and CTEs;
their inner aggregates still run on the device).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from tpu_olap_torch.catalog.star import StarDimension, StarSchema

NATIONS = {
    "FRANCE": "EUROPE", "GERMANY": "EUROPE", "RUSSIA": "EUROPE",
    "BRAZIL": "AMERICA", "CANADA": "AMERICA", "PERU": "AMERICA",
    "CHINA": "ASIA", "INDIA": "ASIA", "JAPAN": "ASIA",
}
# TPC-H SF1's lineitem row count
SF1_ROWS = 6_001_215


def olps_frame(n: int = 12_000, seed: int = 29) -> pd.DataFrame:
    """orderLineItemPartSupplier: one flat frame, TPC-H column names."""
    rng = np.random.default_rng(seed)
    nations = np.array(list(NATIONS))
    df = pd.DataFrame({
        "o_orderdate": pd.to_datetime("1995-01-01")
        + pd.to_timedelta(rng.integers(0, 730, n), unit="D"),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
        "l_extendedprice": rng.integers(900, 105_000, n).astype(np.int64),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),  # percent
        "l_returnflag": rng.choice(["A", "N", "R"], n),
        "l_linestatus": rng.choice(["F", "O"], n),
        "l_shipmode": rng.choice(["AIR", "RAIL", "SHIP", "TRUCK"], n),
        "p_brand": rng.choice([f"Brand#{i}" for i in range(10, 55)], n),
        "p_type": rng.choice(
            [f"{a} {b}" for a in ("ECONOMY", "STANDARD", "PROMO")
             for b in ("BRASS", "COPPER", "STEEL")], n),
        "p_size": rng.integers(1, 51, n).astype(np.int64),
        "s_nation": rng.choice(nations, n),
        "c_nation": rng.choice(nations, n),
        "c_mktsegment": rng.choice(
            ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
             "MACHINERY"], n),
        "o_orderpriority": rng.choice(
            ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-LOW", "5-NOT"], n),
    })
    df["s_region"] = df.s_nation.map(NATIONS)
    df["c_region"] = df.c_nation.map(NATIONS)
    return df


def nation_dim() -> pd.DataFrame:
    return pd.DataFrame({"n_name": list(NATIONS),
                         "n_region": list(NATIONS.values())})


def star_schema() -> StarSchema:
    """The fact's two nation dimensions, reached through declared FDs."""
    return StarSchema(fact="olps", dimensions=tuple(
        StarDimension(f"{side}_nat", fact_key=f"{side}_nation",
                      dim_key="n_name",
                      column_map={"n_name": f"{side}_nation",
                                  "n_region": f"{side}_region"})
        for side in ("s", "c")))


def write_olps_parquet(out_dir: str, n: int = SF1_ROWS, seed: int = 0,
                       files: int = 4,
                       row_group_rows: int = 1 << 18) -> list:
    """`olps_frame(n, seed)` as a multi-file parquet dataset, several row
    groups per file. Returns the paths in row order."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    df = olps_frame(n, seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    bounds = np.linspace(0, n, files + 1).astype(int)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        path = os.path.join(out_dir, f"olps-{i:03d}.parquet")
        pq.write_table(pa.Table.from_pandas(df.iloc[lo:hi],
                                            preserve_index=False),
                       path, row_group_size=row_group_rows)
        paths.append(path)
    return paths


def register_olps(engine, data, **kw):
    """Register the fact (a frame or parquet paths; accelerated,
    star-declared) and its two plain nation tables."""
    engine.register_table("olps", data, time_column="o_orderdate",
                          star_schema=star_schema(), **kw)
    for name in ("s_nat", "c_nat"):
        engine.register_table(name, nation_dim(), accelerate=False)


# name -> (rewritten onto the device path, SQL)
QUERIES = {
    "q1": (True, """
        SELECT l_returnflag, l_linestatus,
        sum(l_quantity) AS sum_qty,
        sum(l_extendedprice) AS sum_base,
        sum(l_extendedprice * (100 - l_discount)) AS sum_disc,
        avg(l_quantity) AS avg_qty,
        count(*) AS count_order
        FROM olps
        WHERE o_orderdate < '1996-09-01'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
        """),
    "q3": (True, """
        SELECT o_orderpriority,
        sum(l_extendedprice * (100 - l_discount)) AS revenue
        FROM olps
        WHERE c_mktsegment = 'BUILDING'
        AND o_orderdate < '1995-06-30'
        GROUP BY o_orderpriority
        ORDER BY revenue DESC LIMIT 10
        """),
    "q5": (True, """
        SELECT s_nation, sum(l_extendedprice) AS revenue
        FROM olps JOIN s_nat ON s_nation = n_name
        WHERE n_region = 'ASIA'
        AND o_orderdate >= '1995-01-01' AND o_orderdate < '1996-01-01'
        GROUP BY s_nation ORDER BY revenue DESC
        """),
    "q5b": (True, """
        SELECT s_nation, sum(l_extendedprice) AS revenue
        FROM olps WHERE c_nation = s_nation
        GROUP BY s_nation ORDER BY s_nation
        """),
    "q7": (True, """
        SELECT s_nation, c_nation, sum(l_extendedprice) AS volume
        FROM olps
        WHERE c_nation <> s_nation AND s_region = 'EUROPE'
        GROUP BY s_nation, c_nation ORDER BY volume DESC LIMIT 8
        """),
    "q7b": (True, """
        SELECT sum(l_extendedprice) AS volume FROM olps
        WHERE (s_nation = 'FRANCE' AND c_nation = 'GERMANY')
        OR (s_nation = 'GERMANY' AND c_nation = 'FRANCE')
        """),
    "q4": (False, """
        SELECT o_orderpriority, count(*) AS n FROM olps o
        WHERE EXISTS (SELECT 1 FROM olps l WHERE l.p_brand = o.p_brand
        AND l.l_quantity > 49 AND l.p_size > 46)
        GROUP BY o_orderpriority ORDER BY o_orderpriority
        """),
    "q6": (True, """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM olps
        WHERE o_orderdate >= '1995-01-01' AND o_orderdate < '1996-01-01'
        AND l_discount BETWEEN 3 AND 5 AND l_quantity < 24
        """),
    "q8": (True, """
        SELECT year(o_orderdate) AS y,
        sum(CASE WHEN s_nation = 'BRAZIL'
        THEN l_extendedprice ELSE 0 END)
        / sum(l_extendedprice) AS share
        FROM olps WHERE c_region = 'AMERICA'
        GROUP BY year(o_orderdate) ORDER BY y
        """),
    "q9": (True, """
        SELECT s_nation, year(o_orderdate) AS y,
        sum(l_extendedprice * (10 - l_discount)
        - l_quantity * p_size) AS profit
        FROM olps GROUP BY s_nation, year(o_orderdate)
        ORDER BY s_nation, y
        """),
    "q10": (True, """
        SELECT c_nation, sum(l_extendedprice * l_discount) AS rev
        FROM olps WHERE l_returnflag = 'R'
        AND o_orderdate >= '1995-04-01' AND o_orderdate < '1995-07-01'
        GROUP BY c_nation ORDER BY rev DESC LIMIT 20
        """),
    "q11": (True, """
        SELECT p_brand, sum(l_extendedprice) AS val
        FROM olps GROUP BY p_brand
        HAVING sum(l_extendedprice) >
        (SELECT sum(l_extendedprice) * 0.024 FROM olps)
        ORDER BY val DESC
        """),
    "q13": (False, """
        SELECT cnt, count(*) AS dist FROM (
        SELECT p_brand, count(*) AS cnt FROM olps GROUP BY p_brand) b
        GROUP BY cnt ORDER BY dist DESC, cnt DESC LIMIT 10
        """),
    "q15": (False, """
        WITH rev AS (SELECT s_nation, sum(l_extendedprice) AS total
        FROM olps GROUP BY s_nation)
        SELECT s_nation, total FROM rev
        WHERE total = (SELECT max(total) FROM rev)
        """),
    "q18": (True, """
        SELECT p_brand, sum(l_quantity) AS q FROM olps
        WHERE p_brand IN (SELECT p_brand FROM olps GROUP BY p_brand
        HAVING sum(l_quantity) > 7000)
        GROUP BY p_brand ORDER BY q DESC
        """),
    "q12": (True, """
        SELECT l_shipmode,
        sum(CASE WHEN o_orderpriority = '1-URGENT'
        THEN 1 ELSE 0 END) AS high_line_count,
        count(*) AS n
        FROM olps
        WHERE l_shipmode IN ('SHIP', 'RAIL')
        GROUP BY l_shipmode ORDER BY l_shipmode
        """),
    "q14": (True, """
        SELECT sum(l_extendedprice) FILTER (WHERE p_type LIKE 'PROMO%')
        AS promo,
        sum(l_extendedprice) AS total
        FROM olps
        WHERE o_orderdate >= '1995-09-01'
        AND o_orderdate < '1995-10-01'
        """),
    "q16": (True, """
        SELECT p_brand, approx_count_distinct(s_nation) AS supplier_cnt
        FROM olps
        WHERE NOT (p_type LIKE 'ECONOMY%') AND p_size IN (1, 4, 9, 14)
        GROUP BY p_brand ORDER BY p_brand
        """),
    "q19": (True, """
        SELECT sum(l_extendedprice * (100 - l_discount)) AS revenue
        FROM olps
        WHERE (p_brand = 'Brand#12' AND l_quantity BETWEEN 1 AND 11)
        OR (p_brand = 'Brand#23' AND l_quantity BETWEEN 10 AND 20)
        OR (p_brand = 'Brand#34' AND l_quantity BETWEEN 20 AND 30)
        """),
    "q22": (False, """
        WITH nation_rev AS (
        SELECT c_nation, sum(l_extendedprice) AS rev, count(*) AS n
        FROM olps GROUP BY c_nation)
        SELECT c_nation, rev FROM nation_rev
        WHERE rev > (SELECT avg(rev) FROM nation_rev)
        ORDER BY c_nation
        """),
    "q17": (False, """
        SELECT sum(l_extendedprice) AS rev FROM olps WHERE l_quantity < (SELECT 0.2 * avg(o2.l_quantity) FROM olps o2 WHERE o2.p_brand = olps.p_brand)
        """),
    "q21": (False, """
        SELECT count(*) AS n FROM olps WHERE EXISTS (SELECT 1 FROM olps o2 WHERE o2.p_brand = olps.p_brand AND o2.l_shipmode = 'AIR' AND o2.l_quantity > 45) AND NOT EXISTS (SELECT 1 FROM olps o3 WHERE o3.p_brand = olps.p_brand AND o3.l_discount = 10 AND o3.p_size > 48)
        """),
    "q2": (False, """
        SELECT count(*) AS n FROM olps WHERE l_extendedprice = (SELECT min(o2.l_extendedprice) FROM olps o2 WHERE o2.p_brand = olps.p_brand AND o2.s_region = olps.s_region)
        """),
    "q20": (True, """
        SELECT count(*) AS n FROM olps WHERE p_brand IN (SELECT o2.p_brand FROM olps o2 WHERE o2.l_quantity >  (SELECT 0.5 * avg(o3.l_quantity) FROM olps o3   WHERE o3.p_brand = o2.p_brand))
        """),
    "monthly": (True, """
        SELECT date_trunc('month', o_orderdate) AS m,
        sum(l_extendedprice) AS rev
        FROM olps
        WHERE o_orderdate >= '1995-01-01' AND o_orderdate < '1995-07-01'
        GROUP BY date_trunc('month', o_orderdate) ORDER BY m
        """),
}


def scaled_subqueries(extended_by_brand, quantity_by_brand) -> dict:
    """Q11 and Q18 with their subqueries' literals set from the data so
    that each outer query keeps about half the brands at any row count.
    The suite's literals were set for its 12,000 rows: at 6,001,215
    uniform rows Q11's 2.4% share keeps no brand and Q18's 7,000 keeps
    every brand. The arguments are each brand's sum(l_extendedprice) and
    sum(l_quantity); each threshold lies between the two middle brands."""
    ext = np.sort(np.asarray(extended_by_brand, dtype=np.float64))
    qty = np.sort(np.asarray(quantity_by_brand, dtype=np.int64))
    mid = len(ext) // 2
    share = float((ext[mid - 1] + ext[mid]) / 2 / ext.sum())
    bound = int(qty[mid - 1] + qty[mid]) // 2
    q11 = QUERIES["q11"][1].replace("* 0.024", f"* {share!r}")
    q18 = QUERIES["q18"][1].replace("> 7000", f"> {bound}")
    assert q11 != QUERIES["q11"][1] and q18 != QUERIES["q18"][1]
    return {"q11 scaled": (True, q11), "q18 scaled": (True, q18)}


# ROLLUP over the fact in the shape of the JAX package's
# tests/test_sql_margins.py::test_rollup: a union of three device legs
ROLLUP = """
    SELECT l_returnflag, l_linestatus, sum(l_quantity) AS s FROM olps
    GROUP BY ROLLUP(l_returnflag, l_linestatus)
    ORDER BY l_returnflag, l_linestatus
    """
