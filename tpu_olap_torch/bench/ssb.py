"""Star-Schema Benchmark (O'Neil et al.): generator + the 13 queries.

The reference is validated on a TPC-H-flavored denormalized star
(SURVEY.md §5: `orderLineItemPartSupplier` registered once as the plain
source DF and once as the druid-backed relation, plus the individual star
tables); SSB is the standardized form of that same workload and the
the north-star metric (BASELINE.json:2: SSB SF100 Q1.1–Q4.3 < 500 ms
p50). This module plays the role of the reference's test fixture AND its
benchmark harness data: `generate_tables` builds the four dimension tables
+ the lineorder fact at a row count of choice (SF1 ≈ 6M lineorder rows),
`denormalize` produces the wide fact (the "Druid datasource"), and
`register_ssb` wires both into an Engine with the declared star schema so
join queries collapse (SURVEY.md §4.3).

All monetary columns are int64 so SUM parity between the device path and
the pandas fallback is exact (SURVEY.md §8.4 #2: float summation order is
the parity hazard — integers dodge it wherever the benchmark allows).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from tpu_olap_torch.catalog.star import (FunctionalDependency, StarDimension,
                                         StarSchema)

# TPC-H / SSB region -> nations mapping (5 × 5)
_REGION_NATIONS = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
_NATIONS = [n for ns in _REGION_NATIONS.values() for n in ns]
_REGION_OF = {n: r for r, ns in _REGION_NATIONS.items() for n in ns}
# SSB: city = first 9 chars of nation (space-padded) + digit 0-9
_CITIES = [f"{n[:9]:<9}{i}" for n in _NATIONS for i in range(10)]
_CITY_NATION = {c: n for n in _NATIONS for c in
                [f"{n[:9]:<9}{i}" for i in range(10)]}

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]


def _city_probs() -> np.ndarray:
    """City sampling weights. Q3.3/Q3.4 filter on the specific cities
    'UNITED KI1'/'UNITED KI5'; at sub-SF1 row counts a uniform 1/250 city
    distribution leaves them empty, so those two cities carry extra mass
    (the fixture's job is query coverage, not dbgen distribution
    fidelity)."""
    p = np.ones(len(_CITIES))
    for i, c in enumerate(_CITIES):
        if c in ("UNITED KI1", "UNITED KI5"):
            p[i] = len(_CITIES) * 0.06  # ~6% each
    return p / p.sum()


def _date_table() -> pd.DataFrame:
    """SSB `date` dimension: one row per day, 1992-01-01 .. 1998-12-31."""
    days = pd.date_range("1992-01-01", "1998-12-31", freq="D")
    month_abbr = days.strftime("%b")
    return pd.DataFrame({
        "d_datekey": (days.year * 10000 + days.month * 100
                      + days.day).astype(np.int64),
        "d_date": days.strftime("%B %d, %Y"),
        "d_dayofweek": days.day_name(),
        "d_month": [_MONTHS[m - 1] for m in days.month],
        "d_year": days.year.astype(np.int64),
        "d_yearmonthnum": (days.year * 100 + days.month).astype(np.int64),
        "d_yearmonth": month_abbr + days.year.astype(str),
        "d_daynuminweek": days.dayofweek.astype(np.int64) + 1,
        "d_daynuminmonth": days.day.astype(np.int64),
        "d_daynuminyear": days.dayofyear.astype(np.int64),
        "d_monthnuminyear": days.month.astype(np.int64),
        "d_weeknuminyear": ((days.dayofyear - 1) // 7 + 1).astype(np.int64),
    })


def generate_tables(lineorder_rows: int = 60_000, seed: int = 0,
                    customers: int | None = None,
                    suppliers: int | None = None,
                    parts: int | None = None) -> dict:
    """Build the 5 SSB tables. Default table sizes scale with the fact the
    way SF does (SF1: 6M lineorder, 30k customers, 2k suppliers, 200k
    parts)."""
    rng = np.random.default_rng(seed)
    n = lineorder_rows
    n_cust = customers or max(200, n // 200)
    n_supp = suppliers or max(150, n // 3000)
    n_part = parts or max(500, n // 30)
    dims = _gen_dimensions(rng, n_cust, n_supp, n_part)
    dims["lineorder"] = _gen_lineorder(
        rng, n, n_cust, n_supp, n_part,
        dims["date"]["d_datekey"].to_numpy(), start_key=1)
    return dims


def _gen_dimensions(rng, n_cust: int, n_supp: int, n_part: int) -> dict:
    date = _date_table()

    city_p = _city_probs()
    ci = rng.choice(len(_CITIES), n_cust, p=city_p)
    c_city = np.asarray(_CITIES, object)[ci]
    customer = pd.DataFrame({
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": [f"Customer#{i:09d}" for i in range(1, n_cust + 1)],
        "c_city": c_city,
        "c_nation": [_CITY_NATION[c] for c in c_city],
        "c_region": [_REGION_OF[_CITY_NATION[c]] for c in c_city],
        "c_mktsegment": rng.choice(_SEGMENTS, n_cust),
    })

    si = rng.choice(len(_CITIES), n_supp, p=city_p)
    s_city = np.asarray(_CITIES, object)[si]
    supplier = pd.DataFrame({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": [f"Supplier#{i:09d}" for i in range(1, n_supp + 1)],
        "s_city": s_city,
        "s_nation": [_CITY_NATION[c] for c in s_city],
        "s_region": [_REGION_OF[_CITY_NATION[c]] for c in s_city],
    })

    a = rng.integers(1, 6, n_part)        # mfgr digit
    b = rng.integers(1, 6, n_part)        # category digit
    c = rng.integers(1, 41, n_part)       # brand number (1..40, unpadded)
    part = pd.DataFrame({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_mfgr": [f"MFGR#{x}" for x in a],
        "p_category": [f"MFGR#{x}{y}" for x, y in zip(a, b)],
        "p_brand1": [f"MFGR#{x}{y}{z}" for x, y, z in zip(a, b, c)],
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
    })

    return {"date": date, "customer": customer,
            "supplier": supplier, "part": part}


def _gen_lineorder(rng, n: int, n_cust: int, n_supp: int, n_part: int,
                   datekeys: np.ndarray, start_key: int) -> pd.DataFrame:
    quantity = rng.integers(1, 51, n).astype(np.int64)
    discount = rng.integers(0, 11, n).astype(np.int64)
    extendedprice = rng.integers(90_000, 10_000_000, n).astype(np.int64)
    return pd.DataFrame({
        "lo_orderkey": np.arange(start_key, start_key + n, dtype=np.int64),
        "lo_custkey": rng.integers(1, n_cust + 1, n).astype(np.int64),
        "lo_partkey": rng.integers(1, n_part + 1, n).astype(np.int64),
        "lo_suppkey": rng.integers(1, n_supp + 1, n).astype(np.int64),
        "lo_orderdate": datekeys[rng.integers(0, len(datekeys), n)],
        "lo_quantity": quantity,
        "lo_discount": discount,
        "lo_extendedprice": extendedprice,
        "lo_revenue": extendedprice * (100 - discount) // 100,
        "lo_supplycost": rng.integers(50_000, 6_000_000, n).astype(np.int64),
        "lo_tax": rng.integers(0, 9, n).astype(np.int64),
        "lo_shipmode": rng.choice(
            ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"], n),
    })


# writer processes of write_ssb_parquet at most: each holds one chunk of
# chunk_rows denormalized rows in host memory
MAX_WRITERS = 8


def write_ssb_parquet(out_dir: str, lineorder_rows: int, seed: int = 0,
                      chunk_rows: int = 2_000_000,
                      row_group_rows: int = 1 << 18) -> tuple[list, dict]:
    """Generate the denormalized SSB fact as a multi-file parquet dataset
    in bounded-memory chunks (the SF10/SF100 generation path — a whole
    SF10 denormalized frame would not be polite to host RAM, and the
    row-group structure is what ingest_parquet_stream streams over).
    Chunks are written by up to MAX_WRITERS spawned processes, no more
    than the host's cores or the chunks (each regenerates the dimension
    tables once); each chunk has its own seed, so the files are those
    one process writes.

    Returns (fact parquet paths, dimension tables dict)."""
    import os

    n = lineorder_rows
    n_chunks = -(-n // chunk_rows)
    os.makedirs(out_dir, exist_ok=True)
    args = (out_dir, n, seed, chunk_rows, row_group_rows)
    workers = min(MAX_WRITERS, os.cpu_count() or 1, n_chunks)
    if workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(workers,
                                 mp_context=mp.get_context("spawn")) as ex:
            futures = [ex.submit(_write_chunks, *args,
                                 range(w, n_chunks, workers))
                       for w in range(workers)]
            paths = sorted(p for f in futures for p in f.result())
    else:
        paths = _write_chunks(*args, range(n_chunks))
    dims = _gen_dimensions(np.random.default_rng(seed), *_dimension_sizes(n))
    return paths, dims


def _dimension_sizes(n: int) -> tuple:
    """(customers, suppliers, parts) of a write_ssb_parquet dataset."""
    return max(200, n // 200), max(150, n // 3000), max(500, n // 30)


def _write_chunks(out_dir, n, seed, chunk_rows, row_group_rows, chunk_ids):
    """Write the fact chunks `chunk_ids` of a write_ssb_parquet dataset;
    returns their paths."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    n_cust, n_supp, n_part = _dimension_sizes(n)
    dims = _gen_dimensions(np.random.default_rng(seed), n_cust, n_supp,
                           n_part)
    datekeys = dims["date"]["d_datekey"].to_numpy()
    paths = []
    for chunk_idx in chunk_ids:
        start = 1 + chunk_idx * chunk_rows
        m = min(chunk_rows, n - start + 1)
        crng = np.random.default_rng((seed, 7919, chunk_idx))
        fact = _gen_lineorder(crng, m, n_cust, n_supp, n_part, datekeys,
                              start_key=start)
        chunk = denormalize({"lineorder": fact, **dims})
        path = os.path.join(out_dir, f"lineorder-{chunk_idx:05d}.parquet")
        pq.write_table(pa.Table.from_pandas(chunk, preserve_index=False),
                       path, row_group_size=row_group_rows)
        paths.append(path)
    return paths


def register_ssb_parquet(engine, paths, dims: dict,
                         block_rows: int | None = None):
    """Register a write_ssb_parquet dataset: the fact streams row-group
    batches into segments; dimension tables stay fallback-only."""
    kw = {"block_rows": block_rows} if block_rows else {}
    engine.register_table("lineorder", list(paths), time_column=TIME_COL,
                          star_schema=star_schema(), **kw)
    for t in ("date", "customer", "supplier", "part"):
        engine.register_table(t, dims[t], accelerate=False)


# dimension attributes carried onto the denormalized fact ("the Druid
# datasource" — the reference denormalizes the star the same way, §1)
_DENORM_COLS = {
    "date": ("lo_orderdate", "d_datekey",
             ["d_year", "d_yearmonthnum", "d_yearmonth", "d_weeknuminyear",
              "d_month", "d_monthnuminyear"]),
    "customer": ("lo_custkey", "c_custkey",
                 ["c_city", "c_nation", "c_region", "c_mktsegment"]),
    "supplier": ("lo_suppkey", "s_suppkey",
                 ["s_city", "s_nation", "s_region"]),
    "part": ("lo_partkey", "p_partkey",
             ["p_mfgr", "p_category", "p_brand1"]),
}

TIME_COL = "lo_orderdate_ts"


def denormalize(tables: dict) -> pd.DataFrame:
    df = tables["lineorder"]
    for t, (fk, pk, cols) in _DENORM_COLS.items():
        df = df.merge(tables[t][[pk] + cols], left_on=fk, right_on=pk,
                      how="left").drop(columns=[pk])
    df[TIME_COL] = pd.to_datetime(df["lo_orderdate"].astype(str),
                                  format="%Y%m%d")
    return df


def star_schema() -> StarSchema:
    return StarSchema(
        fact="lineorder",
        dimensions=tuple(
            StarDimension(t, fk, pk)
            for t, (fk, pk, _) in _DENORM_COLS.items()),
        functional_dependencies=(
            FunctionalDependency("c_city", "c_nation"),
            FunctionalDependency("c_nation", "c_region"),
            FunctionalDependency("s_city", "s_nation"),
            FunctionalDependency("s_nation", "s_region"),
            FunctionalDependency("p_brand1", "p_category"),
            FunctionalDependency("p_category", "p_mfgr"),
            FunctionalDependency("d_datekey", "d_year"),
        ))


def register_ssb(engine, tables: dict | None = None,
                 lineorder_rows: int = 60_000, seed: int = 0,
                 block_rows: int | None = None):
    """Register the denormalized fact (accelerated, star-declared) plus the
    four dimension tables (fallback-only) — the reference's double
    registration of its test fixture (SURVEY.md §5)."""
    tables = tables or generate_tables(lineorder_rows, seed)
    denorm = denormalize(tables)
    kw = {"block_rows": block_rows} if block_rows else {}
    engine.register_table("lineorder", denorm, time_column=TIME_COL,
                          star_schema=star_schema(), **kw)
    for t in ("date", "customer", "supplier", "part"):
        engine.register_table(t, tables[t], accelerate=False)
    return tables, denorm


# --------------------------------------------------------------------------
# The 13 SSB queries (O'Neil et al. 2009), in the engine's SQL dialect.
# Join order/conditions follow the published text; filters reference the
# dimension attributes, which the planner renames onto the denormalized
# fact after star-join collapse (SURVEY.md §4.3).

QUERIES = {
    "q1.1": """
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder JOIN date ON lo_orderdate = d_datekey
        WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3
          AND lo_quantity < 25
    """,
    "q1.2": """
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder JOIN date ON lo_orderdate = d_datekey
        WHERE d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6
          AND lo_quantity BETWEEN 26 AND 35
    """,
    "q1.3": """
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder JOIN date ON lo_orderdate = d_datekey
        WHERE d_weeknuminyear = 6 AND d_year = 1994
          AND lo_discount BETWEEN 5 AND 7
          AND lo_quantity BETWEEN 26 AND 35
    """,
    "q2.1": """
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN part ON lo_partkey = p_partkey
          JOIN supplier ON lo_suppkey = s_suppkey
        WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA'
        GROUP BY d_year, p_brand1
        ORDER BY d_year, p_brand1
    """,
    "q2.2": """
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN part ON lo_partkey = p_partkey
          JOIN supplier ON lo_suppkey = s_suppkey
        WHERE p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228'
          AND s_region = 'ASIA'
        GROUP BY d_year, p_brand1
        ORDER BY d_year, p_brand1
    """,
    "q2.3": """
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN part ON lo_partkey = p_partkey
          JOIN supplier ON lo_suppkey = s_suppkey
        WHERE p_brand1 = 'MFGR#2239' AND s_region = 'EUROPE'
        GROUP BY d_year, p_brand1
        ORDER BY d_year, p_brand1
    """,
    "q3.1": """
        SELECT c_nation, s_nation, d_year, sum(lo_revenue) AS revenue
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN date ON lo_orderdate = d_datekey
        WHERE c_region = 'ASIA' AND s_region = 'ASIA'
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_nation, s_nation, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3.2": """
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN date ON lo_orderdate = d_datekey
        WHERE c_nation = 'UNITED STATES' AND s_nation = 'UNITED STATES'
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3.3": """
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN date ON lo_orderdate = d_datekey
        WHERE (c_city = 'UNITED KI1' OR c_city = 'UNITED KI5')
          AND (s_city = 'UNITED KI1' OR s_city = 'UNITED KI5')
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3.4": """
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN date ON lo_orderdate = d_datekey
        WHERE (c_city = 'UNITED KI1' OR c_city = 'UNITED KI5')
          AND (s_city = 'UNITED KI1' OR s_city = 'UNITED KI5')
          AND d_yearmonth = 'Dec1997'
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q4.1": """
        SELECT d_year, c_nation, sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN part ON lo_partkey = p_partkey
        WHERE c_region = 'AMERICA' AND s_region = 'AMERICA'
          AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
        GROUP BY d_year, c_nation
        ORDER BY d_year, c_nation
    """,
    "q4.2": """
        SELECT d_year, s_nation, p_category,
               sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN part ON lo_partkey = p_partkey
        WHERE c_region = 'AMERICA' AND s_region = 'AMERICA'
          AND (d_year = 1997 OR d_year = 1998)
          AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
        GROUP BY d_year, s_nation, p_category
        ORDER BY d_year, s_nation, p_category
    """,
    "q4.3": """
        SELECT d_year, s_city, p_brand1,
               sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN part ON lo_partkey = p_partkey
        WHERE c_region = 'AMERICA' AND s_nation = 'UNITED STATES'
          AND (d_year = 1997 OR d_year = 1998)
          AND p_category = 'MFGR#14'
        GROUP BY d_year, s_city, p_brand1
        ORDER BY d_year, s_city, p_brand1
    """,
}

# Each query with other literals of the same kinds (years, ranges,
# regions, nations, cities, brands): what a dashboard sends when a user
# moves a filter. Each literal names a value present in the generated
# tables at every scale (a value absent from a dimension changes the
# group space, and so the plan). The plans share their row programs'
# structure with QUERIES, so they share one compiled kernel each.
_OTHER_LITERALS = {
    "q1.1": (("1993", "1994"), ("BETWEEN 1 AND 3", "BETWEEN 2 AND 4"),
             ("< 25", "< 30")),
    "q1.2": (("199401", "199502"), ("BETWEEN 4 AND 6", "BETWEEN 3 AND 5"),
             ("BETWEEN 26 AND 35", "BETWEEN 21 AND 30")),
    "q1.3": (("= 6 ", "= 7 "), ("1994", "1995"),
             ("BETWEEN 5 AND 7", "BETWEEN 4 AND 6"),
             ("BETWEEN 26 AND 35", "BETWEEN 25 AND 34")),
    "q2.1": (("MFGR#12", "MFGR#13"), ("AMERICA", "ASIA")),
    "q2.2": (("MFGR#2221", "MFGR#2231"), ("MFGR#2228", "MFGR#2238"),
             ("ASIA", "EUROPE")),
    "q2.3": (("MFGR#2239", "MFGR#2240"), ("EUROPE", "ASIA")),
    "q3.1": (("ASIA", "AMERICA"), ("1992", "1993"), ("1997", "1996")),
    "q3.2": (("UNITED STATES", "CHINA"), ("1992", "1993"),
             ("1997", "1996")),
    "q3.3": (("UNITED KI1", "UNITED KI4"), ("UNITED KI5", "UNITED KI8"),
             ("1992", "1993"), ("1997", "1996")),
    "q3.4": (("UNITED KI1", "UNITED KI4"), ("UNITED KI5", "UNITED KI8"),
             ("Dec1997", "Nov1996")),
    "q4.1": (("AMERICA", "EUROPE"), ("'MFGR#1'", "'MFGR#3'"),
             ("'MFGR#2'", "'MFGR#4'")),
    "q4.2": (("AMERICA", "EUROPE"), ("1997", "1995"), ("1998", "1996"),
             ("'MFGR#1'", "'MFGR#3'"), ("'MFGR#2'", "'MFGR#4'")),
    "q4.3": (("AMERICA", "ASIA"), ("UNITED STATES", "CHINA"),
             ("1997", "1995"), ("1998", "1996"), ("MFGR#14", "MFGR#23")),
}


def _with_literals(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{old!r} is not in the query")
        text = text.replace(old, new)
    return text


QUERIES_OTHER_LITERALS = {name: _with_literals(QUERIES[name], subs)
                          for name, subs in _OTHER_LITERALS.items()}


# --------------------------------------------------------------------------
# Distinct counts and a wide drill-down over the same star: the dense HLL
# and theta paths (finalized on the device and packed), a theta set
# operation over raw tables (unpacked), and a GROUP BY whose group space
# (year x customer city x supplier city x brand, about 20 M) is past the
# dense budget (the sort-based sparse path).

DISTINCT_QUERIES = {
    # monthly active customers per supplier nation: HLL, dense, packed
    "x1": """
        SELECT d_yearmonth, s_nation, count(DISTINCT lo_custkey) AS customers,
               sum(lo_revenue) AS revenue
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN supplier ON lo_suppkey = s_suppkey
        GROUP BY d_yearmonth, s_nation
        ORDER BY d_yearmonth, s_nation
    """,
    # distinct parts per customer region and year: theta, dense, packed
    "x2": """
        SELECT c_region, d_year, theta_sketch(lo_partkey) AS parts
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN date ON lo_orderdate = d_datekey
        GROUP BY c_region, d_year
        ORDER BY c_region, d_year
    """,
    # customers of 1997 still buying in 1998: a theta intersection over
    # the raw tables, unpacked
    "x3": """
        SELECT c_region, theta_sketch_estimate(theta_sketch_intersect(
                 theta_sketch(lo_custkey) FILTER (WHERE d_year = 1997),
                 theta_sketch(lo_custkey) FILTER (WHERE d_year = 1998)))
                 AS retained
        FROM lineorder
          JOIN customer ON lo_custkey = c_custkey
          JOIN date ON lo_orderdate = d_datekey
        GROUP BY c_region
        ORDER BY c_region
    """,
    # the four-dimension drill-down: sparse group-by
    "x4": """
        SELECT d_year, c_city, s_city, p_brand1, sum(lo_revenue) AS revenue,
               count(*) AS orders
        FROM lineorder
          JOIN date ON lo_orderdate = d_datekey
          JOIN customer ON lo_custkey = c_custkey
          JOIN supplier ON lo_suppkey = s_suppkey
          JOIN part ON lo_partkey = p_partkey
        WHERE c_region = 'AMERICA' AND s_region = 'AMERICA'
        GROUP BY d_year, c_city, s_city, p_brand1
        ORDER BY revenue DESC
        LIMIT 100
    """,
}
