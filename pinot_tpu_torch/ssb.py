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

`search_schema` / `make_search_columns`: lineorder with the columns Apache
Pinot's search indexes serve, shaped after its documentation's examples: a
JSON payload like the githubEvents quickstart's (`lo_payload`), a free-text
comment (`lo_comment`), SSB's customer name (`lo_custname`, the FST index's
REGEXP_LIKE target) and a point (`lo_lng`, `lo_lat`, the geo index's pair).

`upsert_schema` and the three keyed streams (`make_upsert_events`,
`make_partial_events`, `make_dedup_events`): lineorder as a stream of order
events with a primary key, after Apache Pinot's "Stream ingestion with
Upsert" and "Stream ingestion with Dedup" pages: `lo_orderkey` (INT, the
primary key), `lo_ts` (LONG, the event time in epoch ms, the FULL table's
`comparisonColumn`) and `lo_tax` (INT 0-8, kept raw). A FULL or PARTIAL
stream draws each event's key zipf(1.2) over a random permutation of the
keys, and `lo_ts` rises with the event index except for late events (2% of
the FULL stream's), which carry a time below their key's previous event; a
dedup stream re-sends an earlier key in 25% of its events, with a free-text
`lo_comment` (`make_comments`).

`mv_schema` / `make_mv_columns`: lineorder with Apache Pinot's multi-value
dimensions (a schema field with `singleValueField: false`), shaped after its
documentation's examples: a tag list (`lo_tags`, STRING, 0-4 of 20 tags drawn
zipf(1.2); an empty row is stored as the one-value null) and a code list
(`lo_codes`, INT, 1-6 of 1,000 codes drawn zipf(1.1)), beside a unique
`lo_orderkey`. `make_mv_csr` gives the same rows as CSR arrays (every row's
values concatenated, and the row offsets), from which a numpy oracle reads.

`write_lineorder_file`: lineorder rows as a CSV, JSON-lines, Avro, Thrift or
Protobuf file, the inputs of a batch ingestion job (Apache Pinot's "Batch
Ingestion" `recordReaderSpec` formats), with the reader's schema sidecar.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .schema import DataType, FieldRole, FieldSpec, Schema, date_time, dimension, metric

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


# -- the search table -------------------------------------------------------

# the githubEvents quickstart's event types
EVENT_TYPES = ("PushEvent", "PullRequestEvent", "IssuesEvent", "IssueCommentEvent",
               "WatchEvent", "ForkEvent", "CreateEvent", "DeleteEvent", "ReleaseEvent",
               "PublicEvent", "MemberEvent", "GollumEvent")
SEARCH_USERS = 100_000          # actor.login values
SEARCH_ORGS = 1_000             # actor.org values
SEARCH_ORG_MISSING = 0.10       # share of payloads without actor.org
SEARCH_TAGS = 20                # tags[*]: 0-4 of t0..t19
SEARCH_VOCABULARY = 10_000      # lo_comment's words, drawn zipf(1.2)
SEARCH_ZIPF = 1.2
SEARCH_WORDS = (4, 16)          # words per comment, inclusive
SEARCH_CENTERS = 500            # point clusters
SEARCH_SPREAD_M = 20_000.0      # a cluster's standard deviation
SEARCH_NULL_POINTS = 0.001      # share of rows whose lo_lng and lo_lat are null
_SYLLABLES = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]


def search_word(i: int) -> str:
    """The vocabulary's i-th word (rank i + 1 of the zipf draw): 2 or 3
    syllables, lowercase letters only."""
    n = len(_SYLLABLES)
    parts = [_SYLLABLES[(i // n ** k) % n] for k in range(3 if i >= n * n else 2)]
    return "".join(reversed(parts))


def search_schema() -> Schema:
    return Schema("lineorder", ssb_schema().fields + [
        dimension("lo_payload", DataType.JSON),
        dimension("lo_comment", DataType.STRING),
        dimension("lo_custname", DataType.STRING),
        metric("lo_lng", DataType.DOUBLE),
        metric("lo_lat", DataType.DOUBLE),
    ])


def _joined(pieces: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """One string per row from a flat array of string pieces, row i being
    pieces[ends[i-1]:ends[i]] concatenated (no piece holds a newline)."""
    tail = np.zeros(len(pieces), dtype=bool)
    tail[ends - 1] = True
    text = "".join(np.where(tail, pieces + "\n", pieces).tolist())
    return np.array(text.split("\n")[:-1], dtype=object)


def make_comments(rng: np.random.Generator, n: int) -> np.ndarray:
    """n free-text comments: SEARCH_WORDS words each, drawn zipf(SEARCH_ZIPF)
    from the SEARCH_VOCABULARY words of `search_word`, space-separated."""
    counts = rng.integers(SEARCH_WORDS[0], SEARCH_WORDS[1] + 1, n)
    words = (rng.zipf(SEARCH_ZIPF, int(counts.sum())) - 1) % SEARCH_VOCABULARY
    vocab = np.array([search_word(i) for i in range(SEARCH_VOCABULARY)], dtype=object)
    ends = np.cumsum(counts)
    pieces = vocab[words]
    pieces[np.setdiff1d(np.arange(len(words)), ends - 1)] += " "
    return _joined(pieces, ends)


def make_search_columns(n: int, seed: int = 20260729) -> Dict[str, np.ndarray]:
    """`make_columns(n, seed)` plus the search columns, from the same seed.
    `lo_payload` is JSON text as `json.dumps` writes it; `lo_lng` / `lo_lat`
    are object arrays with None for a null point."""
    cols = make_columns(n, seed)
    rng = np.random.default_rng(seed + 1)

    def ints(k, size):
        return np.array([str(i) for i in range(k)], dtype=object)[rng.integers(0, k, size)]

    n_tags = rng.integers(0, 5, n)
    tags = ('"t' + ints(SEARCH_TAGS, (n, 4)) + '"').tolist()
    tag_lists = np.array(["[" + ", ".join(row[:k]) + "]" for row, k in zip(tags, n_tags.tolist())],
                         dtype=object)
    org = np.where(rng.random(n) >= SEARCH_ORG_MISSING,
                   '", "org": "org' + ints(SEARCH_ORGS, n) + '"}', '"}')
    payload = ('{"type": "' + np.array(EVENT_TYPES, dtype=object)[
        rng.integers(0, len(EVENT_TYPES), n)] + '", "actor": {"login": "user'
        + ints(SEARCH_USERS, n) + org + ', "tags": ' + tag_lists + ', "qty": '
        + ints(101, n) + "}")
    comment = make_comments(rng, n)
    centers = np.stack([rng.uniform(-180.0, 180.0, SEARCH_CENTERS),
                        rng.uniform(-60.0, 70.0, SEARCH_CENTERS)], axis=1)
    which = rng.integers(0, SEARCH_CENTERS, n)
    lat = np.clip(centers[which, 1] + rng.normal(0.0, SEARCH_SPREAD_M / 111_320.0, n),
                  -89.0, 89.0)
    dlng = rng.normal(0.0, SEARCH_SPREAD_M / 111_320.0, n) / np.cos(np.radians(lat))
    lng = (centers[which, 0] + dlng + 180.0) % 360.0 - 180.0
    null = rng.random(n) < SEARCH_NULL_POINTS
    lng_o, lat_o = lng.astype(object), lat.astype(object)
    lng_o[null] = None
    lat_o[null] = None
    cols.update(lo_payload=payload, lo_comment=comment,
                lo_custname=np.array([f"Customer#{k:09d}" for k in range(VERY_HIGH_CARD_KEYS)],
                                     dtype=object)[cols["lo_custkey"]],
                lo_lng=lng_o, lo_lat=lat_o)
    return cols


# the search queries over `search_schema`'s table: (id, sql); the distance
# query takes the center and the radius in metres as {lng}, {lat}, {r}
SEARCH_TERM = search_word(50)                      # ~1.6% of comments
SEARCH_PHRASE = f"{search_word(1)} {search_word(2)}"
SEARCH_PREFIX = "bo"
SEARCH_REGEX = "ke[dk]u"
SEARCH_TEXT = f'{SEARCH_TERM} OR "{SEARCH_PHRASE}"'
SEARCH_CUSTNAME_REGEX = "00123.5"                  # requires the literal "00123"
SEARCH_QUERIES = {
    "json_type": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                 "WHERE JSON_MATCH(lo_payload, '\"$.type\"=''PushEvent''')",
    "json_array_range": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                        "WHERE JSON_MATCH(lo_payload, '\"$.tags[*]\"=''t3'' AND \"$.qty\" > 40')",
    "json_presence": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                     "WHERE JSON_MATCH(lo_payload, '\"$.actor.org\" IS NOT NULL')",
    "text_or": "SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
               f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_TEXT}') "
               "GROUP BY lo_region ORDER BY lo_region",
    "text_prefix": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                   f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_PREFIX}*')",
    "text_regex": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                  f"WHERE TEXT_MATCH(lo_comment, '/{SEARCH_REGEX}/')",
    "text_not": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_TEXT}') = 0",
    "text_mixed": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                  f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_TERM}') AND lo_discount = 2",
    "text_select": "SELECT lo_custkey, lo_revenue FROM lineorder "
                   f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_TERM}') "
                   "ORDER BY lo_revenue DESC LIMIT 10",
    "regexp_fst": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                  f"WHERE REGEXP_LIKE(lo_custname, '{SEARCH_CUSTNAME_REGEX}')",
    "geo_distance": "SELECT COUNT(*) FROM lineorder WHERE ST_DISTANCE(ST_POINT(lo_lng, "
                    "lo_lat, 1), ST_POINT({lng}, {lat}, 1)) < {r}",
}


MV_TAGS = 20            # lo_tags: t0..t19, t0 the most frequent
MV_TAG_COUNTS = (0, 4)  # values a row, inclusive
MV_TAG_ZIPF = 1.2
MV_CODES = 1_000        # lo_codes: 1..1000, 1 the most frequent
MV_CODE_COUNTS = (1, 6)
MV_CODE_ZIPF = 1.1
MV_QUERIES = {
    "tags_eq": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_tags = 't3'",
    "codes_band_tags_in": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                          "WHERE lo_codes BETWEEN 100 AND 180 AND lo_tags IN ('t1', 't7')",
    "not_eq": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE NOT lo_tags = 't0'",
    "neq": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_tags != 't0'",
    "mixed": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
             "WHERE lo_discount = 2 AND lo_tags = 't3'",
    "q1_1": QUERY,
    "group_tags": "SELECT lo_tags, COUNT(*), SUM(lo_revenue) FROM lineorder "
                  "GROUP BY lo_tags ORDER BY lo_tags LIMIT 30",
    "mv_aggs": "SELECT COUNTMV(lo_codes), SUMMV(lo_codes), MINMV(lo_codes), MAXMV(lo_codes), "
               "AVGMV(lo_codes), DISTINCTCOUNTMV(lo_codes), DISTINCTCOUNTHLLMV(lo_codes), "
               "PERCENTILE50MV(lo_codes) FROM lineorder",
    "selection": "SELECT lo_orderkey, lo_tags FROM lineorder WHERE lo_codes = 7 "
                 "ORDER BY lo_orderkey LIMIT 10",
    "arraylength": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                   "WHERE ARRAYLENGTH(lo_tags) >= 2",
}


def mv_schema() -> Schema:
    mv = dict(role=FieldRole.DIMENSION, single_value=False)
    return Schema("lineorder", list(ssb_schema().fields) + [
        dimension("lo_orderkey", DataType.INT),
        FieldSpec("lo_tags", DataType.STRING, **mv),
        FieldSpec("lo_codes", DataType.INT, **mv)])


def _zipf_csr(rng: np.random.Generator, n: int, counts, card: int, s: float):
    """(values 1..card drawn with P(k) proportional to k^-s, int64 row offsets)
    of n rows of `counts` (inclusive) values each, drawn uniformly."""
    per_row = rng.integers(counts[0], counts[1] + 1, n)
    p = 1.0 / np.arange(1, card + 1) ** s
    values = rng.choice(card, int(per_row.sum()), p=p / p.sum()) + 1
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(per_row, out=offsets[1:])
    return values, offsets


def make_mv_csr(n: int, seed: int = 20260729) -> Dict[str, tuple]:
    """The multi-value columns of `make_mv_columns` as CSR: (values, offsets)
    per column; a tag as its number k (the string f"t{k}"), an empty tag row
    holding no value."""
    rng = np.random.default_rng([seed, 7])
    tags, tag_off = _zipf_csr(rng, n, MV_TAG_COUNTS, MV_TAGS, MV_TAG_ZIPF)
    codes, code_off = _zipf_csr(rng, n, MV_CODE_COUNTS, MV_CODES, MV_CODE_ZIPF)
    return {"lo_tags": (tags - 1, tag_off), "lo_codes": (codes.astype(np.int32), code_off)}


def csr_rows(values: np.ndarray, offsets: np.ndarray) -> list:
    """CSR as one Python list of values per row (the writer's input form)."""
    flat = values.tolist()
    return [flat[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def make_mv_columns(n: int, seed: int = 20260729) -> Dict[str, object]:
    """`make_columns` with a unique `lo_orderkey` (1..n) and the multi-value
    `lo_tags` and `lo_codes` as per-row lists."""
    cols: Dict[str, object] = dict(make_columns(n, seed))
    cols["lo_orderkey"] = np.arange(1, n + 1, dtype=np.int32)
    csr = make_mv_csr(n, seed)
    tags, tag_off = csr["lo_tags"]
    names = np.array([f"t{k}" for k in range(MV_TAGS)], dtype=object)
    cols["lo_tags"] = csr_rows(names[tags], tag_off)
    cols["lo_codes"] = csr_rows(*csr["lo_codes"])
    return cols


UPSERT_KEY_ZIPF = 1.2
UPSERT_LATE = 0.02            # share of FULL events older than their key's previous event
UPSERT_RESEND = 0.25          # share of dedup events that re-send an earlier key
UPSERT_TS0 = 1_700_000_000_000    # lo_ts of event 0 (epoch ms); +1,000 per event
UPSERT_QUERIES = {
    "count": "SELECT COUNT(*) FROM lineorder",
    "q1_1": QUERY,
    "group": GROUP_QUERY,
    "for_sum": "SELECT SUM(lo_tax), COUNT(*) FROM lineorder "
               "WHERE lo_discount BETWEEN 1 AND 3",
    "bitmap_group": "SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
                    "WHERE lo_discount = 2 GROUP BY lo_region ORDER BY lo_region",
    "region_asia": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_region = 'ASIA'",
    "top_revenue": "SELECT lo_orderkey, lo_revenue FROM lineorder "
                   "ORDER BY lo_revenue DESC LIMIT 10",
    "partial_sums": "SELECT COUNT(*), SUM(lo_quantity), SUM(lo_revenue), MAX(lo_revenue), "
                    "SUM(lo_discount), MIN(lo_orderdate), MAX(lo_orderdate) FROM lineorder",
    "text": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
            f"WHERE TEXT_MATCH(lo_comment, '{SEARCH_TERM}')",
}


def upsert_schema(comment: bool = False) -> Schema:
    """lineorder as keyed order events; with `comment`, the dedup table's
    free-text `lo_comment` too."""
    fields = list(ssb_schema().fields) + [dimension("lo_orderkey", DataType.INT),
                                          date_time("lo_ts", DataType.LONG),
                                          metric("lo_tax", DataType.INT)]
    if comment:
        fields.append(dimension("lo_comment", DataType.STRING))
    return Schema("lineorder", fields, primary_key_columns=["lo_orderkey"])


def _event_columns(n: int, seed: int, keys: np.ndarray) -> Dict[str, np.ndarray]:
    cols = make_columns(n, seed)
    rng = np.random.default_rng([seed, 12])
    cols["lo_orderkey"] = keys.astype(np.int32)
    cols["lo_ts"] = UPSERT_TS0 + 1000 * np.arange(n, dtype=np.int64)
    cols["lo_tax"] = rng.integers(0, 9, n).astype(np.int32)
    return cols


def make_upsert_events(n: int, keys: int, seed: int = 20260729,
                       late: float = UPSERT_LATE) -> Dict[str, np.ndarray]:
    """n events over `keys` primary keys (1..keys): each event's key drawn
    with P(rank k) proportional to k^-UPSERT_KEY_ZIPF over a random
    permutation of the keys. `lo_ts` rises by 1,000 a event; a `late` share
    of the events that follow an earlier event of their key carry a time
    1-999 ms below that previous event's."""
    rng = np.random.default_rng([seed, 11])
    p = 1.0 / np.arange(1, keys + 1) ** UPSERT_KEY_ZIPF
    key = rng.permutation(keys)[rng.choice(keys, n, p=p / p.sum())] + 1
    cols = _event_columns(n, seed, key)
    order = np.argsort(key, kind="stable")
    prev = np.full(n, -1, dtype=np.int64)
    same = key[order[1:]] == key[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    is_late = (prev >= 0) & (rng.random(n) < late)
    ts = cols["lo_ts"]
    ts[is_late] = ts[prev[is_late]] - rng.integers(1, 1000, int(is_late.sum()))
    return cols


def make_partial_events(n: int, keys: int, seed: int = 20260729) -> Dict[str, np.ndarray]:
    """The PARTIAL stream: `make_upsert_events` without late events (the
    stream offset orders a key's rows)."""
    return make_upsert_events(n, keys, seed, late=0.0)


def make_dedup_events(n: int, seed: int = 20260729,
                      resend: float = UPSERT_RESEND) -> Dict[str, np.ndarray]:
    """n events of which a `resend` share re-send a key drawn uniformly from
    the keys of the new events before them (event 0 is new); a new event's
    key is its rank among the new events (1, 2, ...). Every event carries its
    own column values and an `lo_comment`."""
    rng = np.random.default_rng([seed, 13])
    is_resend = rng.random(n) < resend
    is_resend[0] = False
    new_so_far = np.cumsum(~is_resend)
    key = np.where(is_resend, 1 + (rng.random(n) * new_so_far).astype(np.int64), new_so_far)
    cols = _event_columns(n, seed, key)
    cols["lo_comment"] = make_comments(rng, n)
    return cols


def make_update_events(keys: np.ndarray, after_ts: int, seed: int = 20260729
                       ) -> Dict[str, np.ndarray]:
    """One event for each key of `keys`, in order, with fresh column values
    and `lo_ts` rising by 1,000 a event from `after_ts` + 1,000: updates no
    comparison rejects."""
    cols = _event_columns(len(keys), seed, np.asarray(keys))
    cols["lo_ts"] = after_ts + 1000 * np.arange(1, len(keys) + 1, dtype=np.int64)
    return cols


def json_messages(cols: Dict[str, np.ndarray], schema: Schema) -> list:
    """One JSON row message a row, with the schema's columns."""
    import json
    names = [f.name for f in schema.fields]
    lists = [cols[c].tolist() for c in names]
    return [json.dumps(dict(zip(names, row))) for row in zip(*lists)]


# -- lineorder as files: the batch ingestion formats ---------------------------

# lineorder's record in each format that carries a schema; the Protobuf one is
# `tests/torch_data/lineorder.proto` (message ssb.LineOrder), compiled there
# into `lineorder.desc`
LINEORDER_AVRO_SCHEMA = {
    "type": "record", "name": "LineOrder", "namespace": "ssb", "fields": [
        {"name": "lo_region", "type": "string"}, {"name": "lo_suppkey", "type": "int"},
        {"name": "lo_custkey", "type": "int"}, {"name": "lo_orderdate", "type": "int"},
        {"name": "lo_quantity", "type": "int"}, {"name": "lo_extendedprice", "type": "double"},
        {"name": "lo_discount", "type": "int"}, {"name": "lo_revenue", "type": "double"}]}
LINEORDER_THRIFT_IDL = """struct LineOrder {
  1: required string lo_region;
  2: required i32 lo_suppkey;
  3: required i32 lo_custkey;
  4: required i32 lo_orderdate;
  5: required i32 lo_quantity;
  6: required double lo_extendedprice;
  7: required i32 lo_discount;
  8: required double lo_revenue;
}
"""
LINEORDER_FORMATS = ("csv", "json", "avro", "thrift", "pb")


def lineorder_rows(cols: Dict[str, np.ndarray]) -> list:
    """One dict of Python values a row, with lineorder's columns."""
    names = [f.name for f in ssb_schema().fields]
    return [dict(zip(names, row)) for row in zip(*[cols[c].tolist() for c in names])]


def write_lineorder_file(fmt: str, cols: Dict[str, np.ndarray], path: str,
                         descriptor_set: bytes = b"") -> str:
    """Write lineorder rows as one `fmt` file (`LINEORDER_FORMATS`) with this
    package's writers, and the sidecar its reader takes: `<path>.thrift` (the
    IDL) or `<path>.desc` (`descriptor_set`, a FileDescriptorSet holding
    ssb.LineOrder). A CSV file has a header row; Avro is a deflate container.
    Returns `path`."""
    if fmt == "csv":
        import csv
        names = [f.name for f in ssb_schema().fields]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(names)
            w.writerows(zip(*[cols[c].tolist() for c in names]))
    elif fmt == "json":
        with open(path, "w") as f:
            f.writelines(m + "\n" for m in json_messages(cols, ssb_schema()))
    elif fmt == "avro":
        from .ingest.avro import AvroFileWriter
        with AvroFileWriter(path, LINEORDER_AVRO_SCHEMA, codec="deflate") as w:
            for row in lineorder_rows(cols):
                w.append(row)
    elif fmt == "thrift":
        from .ingest.thriftfmt import ThriftIDL, write_structs
        idl = ThriftIDL(LINEORDER_THRIFT_IDL)
        write_structs(path, idl, idl.struct("LineOrder"), lineorder_rows(cols))
        with open(path + ".thrift", "w") as f:
            f.write(LINEORDER_THRIFT_IDL)
    elif fmt == "pb":
        from .ingest.proto import DescriptorPool, write_delimited
        pool = DescriptorPool(descriptor_set)
        write_delimited(path, pool, pool.message("ssb.LineOrder"), lineorder_rows(cols))
        with open(path + ".desc", "wb") as f:
            f.write(descriptor_set)
    else:
        raise ValueError(f"no lineorder writer for format {fmt!r}")
    return path
