"""SSB data for examples and the chip smoke test.

`lineorder`: a copy of `ssb_schema` and `make_columns` from the repository's
`bench.py`, with the seed as an argument: the same generator, the same
columns, the same value ranges.

The dimension tables the join queries read, generated from a seed:
`supplier` (20,000 rows: SSB SF10's SF x 2,000, and exactly `lo_suppkey`'s
key space), `customer` (500,000 rows: `lo_custkey`'s key space, so every
lineorder row finds its customer; SF10 would have 300,000) and `region`
(the 5 names of `lo_region`). Nations, cities and market segments follow
the SSB specification: 5 nations per region, a city is the nation's first 9
characters and a digit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .schema import DataType, Schema, date_time, dimension, metric

HIGH_CARD_SUPPKEYS = 20_000
VERY_HIGH_CARD_KEYS = 500_000
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
NATIONS = (   # 5 per region, in REGIONS order
    "ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE",
    "ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES",
    "CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM",
    "FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM",
    "EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA")
MKTSEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")

# the queries of bench.py: SSB Q1.1, and a dictionary GROUP BY in the Q2.x style
QUERY = ("SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder "
         "WHERE lo_orderdate BETWEEN 19930101 AND 19931231 "
         "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25 LIMIT 10")

GROUP_QUERY = ("SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
               "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25 "
               "GROUP BY lo_region ORDER BY lo_region LIMIT 10")

# bench.py's star-tree query: its filter and group key are split dimensions of
# the star-tree [lo_region, lo_discount] with SUM__lo_revenue
STAR_QUERY = ("SELECT lo_region, SUM(lo_revenue) FROM lineorder "
              "WHERE lo_discount BETWEEN 1 AND 3 "
              "GROUP BY lo_region ORDER BY lo_region LIMIT 10")

# a SUM over a raw integer column stored frame-of-reference (lo_quantity built
# with no dictionary: uint8 deltas, base 1)
FOR_QUERY = ("SELECT SUM(lo_quantity), COUNT(*) FROM lineorder "
             "WHERE lo_orderdate BETWEEN 19930101 AND 19931231 "
             "AND lo_discount BETWEEN 1 AND 3")


# star joins in the SSB Q2/Q3 style and an IN-subquery, over the lineorder
# columns above. join_customer's build filter takes two market segments, not
# one: one segment builds ~100,000 rows (~2.8 MB by the exchange's estimate),
# under the 4 MiB broadcast limit; two (~5.6 MB) take the partitioned exchange.
JOIN_QUERIES = {
    "join_supplier": (
        "SELECT s.s_nation, SUM(l.lo_revenue), COUNT(*) FROM lineorder l "
        "JOIN supplier s ON l.lo_suppkey = s.s_suppkey "
        "WHERE s.s_region = 'AMERICA' AND l.lo_discount BETWEEN 1 AND 3 "
        "GROUP BY s.s_nation ORDER BY s.s_nation LIMIT 25"),
    "join_customer": (
        "SELECT c.c_nation, SUM(l.lo_revenue) FROM lineorder l "
        "JOIN customer c ON l.lo_custkey = c.c_custkey "
        "WHERE c.c_mktsegment IN ('BUILDING', 'MACHINERY') "
        "AND l.lo_orderdate BETWEEN 19930101 AND 19931231 "
        "GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 25"),
    "join_region": (
        "SELECT r.r_regionkey, COUNT(*), SUM(l.lo_revenue) FROM lineorder l "
        "JOIN region r ON l.lo_region = r.r_name "
        "WHERE l.lo_orderdate BETWEEN 19930101 AND 19931231 AND l.lo_quantity < 25 "
        "GROUP BY r.r_regionkey ORDER BY r.r_regionkey"),
    "semi_in": (
        "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_suppkey IN "
        "(SELECT s_suppkey FROM supplier WHERE s_nation = 'JAPAN') AND lo_quantity < 25"),
}


def ssb_schema() -> Schema:
    return Schema("lineorder", [
        dimension("lo_region", DataType.STRING),
        dimension("lo_suppkey", DataType.INT),
        dimension("lo_custkey", DataType.INT),
        date_time("lo_orderdate", DataType.INT),
        metric("lo_quantity", DataType.INT),
        metric("lo_extendedprice", DataType.DOUBLE),
        metric("lo_discount", DataType.INT),
        metric("lo_revenue", DataType.DOUBLE),
    ])


def make_columns(n: int, seed: int = 20260729) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    region_ids = rng.integers(0, 5, n)
    return {
        "lo_region": np.array(REGIONS, dtype=object)[region_ids],
        "lo_suppkey": rng.integers(0, HIGH_CARD_SUPPKEYS, n).astype(np.int32),
        "lo_custkey": rng.integers(0, VERY_HIGH_CARD_KEYS, n).astype(np.int32),
        "lo_orderdate": (19920101 + rng.integers(0, 7, n) * 10000
                         + rng.integers(1, 13, n) * 100
                         + rng.integers(1, 29, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_extendedprice": np.round(rng.uniform(1.0, 10_000.0, n), 2).astype(np.float64),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": np.round(rng.uniform(1.0, 60_000.0, n), 2).astype(np.float64),
    }


def supplier_schema() -> Schema:
    return Schema("supplier", [
        dimension("s_suppkey", DataType.INT),
        dimension("s_region", DataType.STRING),
        dimension("s_nation", DataType.STRING),
        dimension("s_city", DataType.STRING),
    ])


def customer_schema() -> Schema:
    return Schema("customer", [
        dimension("c_custkey", DataType.INT),
        dimension("c_region", DataType.STRING),
        dimension("c_nation", DataType.STRING),
        dimension("c_mktsegment", DataType.STRING),
    ])


def region_schema() -> Schema:
    return Schema("region", [dimension("r_regionkey", DataType.INT),
                             dimension("r_name", DataType.STRING)])


def _places(rng: np.random.Generator, n: int):
    """(region, nation, city) object columns of n random rows."""
    nation_ids = rng.integers(0, len(NATIONS), n)
    nations = np.array(NATIONS, dtype=object)
    cities = np.array([f"{nation[:9]:<9}{d}" for nation in NATIONS for d in range(10)],
                      dtype=object)
    return (np.array(REGIONS, dtype=object)[nation_ids // 5], nations[nation_ids],
            cities[nation_ids * 10 + rng.integers(0, 10, n)])


def make_supplier(n: int = HIGH_CARD_SUPPKEYS, seed: int = 20260729) -> Dict[str, np.ndarray]:
    region, nation, city = _places(np.random.default_rng([seed, 1]), n)
    return {"s_suppkey": np.arange(n, dtype=np.int32), "s_region": region,
            "s_nation": nation, "s_city": city}


def make_customer(n: int = VERY_HIGH_CARD_KEYS, seed: int = 20260729) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([seed, 2])
    region, nation, _ = _places(rng, n)
    return {"c_custkey": np.arange(n, dtype=np.int32), "c_region": region,
            "c_nation": nation,
            "c_mktsegment": np.array(MKTSEGMENTS, dtype=object)[rng.integers(0, 5, n)]}


def make_region() -> Dict[str, np.ndarray]:
    return {"r_regionkey": np.arange(len(REGIONS), dtype=np.int32),
            "r_name": np.array(REGIONS, dtype=object)}
