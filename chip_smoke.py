#!/usr/bin/env python3
"""Chip smoke test: pinot_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py [--seed 20260729] [--rows 16777216] [--trace]

Phases, each printing its own lines; any failed check raises and the script
exits non-zero:

1. device  — the card's name and `nvidia-smi` name/power limit;
2. build   — compiles the CUDA kernels from `pinot_tpu_torch/csrc/` (nvcc, one
   process a source, started together) and logs each kernel instance's
   registers, shared memory and spills (ptxas; a bitmap_filter or grouped_agg
   kernel with a stack frame or a spill fails) and grouped_agg's atomic
   instructions by kernel (`cuobjdump -sass`);
3. kernels — each kernel against its plain PyTorch version on the card at the
   main paths' shapes (one segment of each table, and the whole stacked table
   the set executor scans in one launch: rel 1e-5 on sums, equal counts),
   timed with CUDA events with the L2 cache flushed before every timed run, and
   under torch.profiler: `kernel_ms` is the kernel alone, and
   `device_ops_per_call` the ops one eager call puts on the card, which must be
   the design's one launch. The flush overwrites a 256 MiB buffer, so the
   inputs come from HBM, behind dirty lines as on the path, whose operand
   product writes its row just before the scan;
4. path    — SSB lineorder generated from --seed, built with the package's writer
   (its segments side by side on the smoke's worker processes: the same files),
   loaded, and queried through `execute_query` on the card: Q1.1, the dictionary
   GROUP BY, and a SUM over a frame-of-reference column. Each answer is held
   against a numpy float64 oracle (rel 1e-5, abs 0.05), and the kernels' launch
   counters must show that Q1.1 and the FOR query ran through the kernels, once
   per segment;
5. serve   — the same table through the stacked segment-set executor
   (`parallel.MeshQueryExecutor`) and the serving pipeline
   (`cluster.DeviceQueryPipeline`): Q1.1, the GROUP BY and a COUNT over one id
   band, each held against the oracle with its warm median, min and max over
   20 runs (a stacked Q1.1 or COUNT must be one `masked_sums` launch for the
   whole table); `execute_many` over 64 copies of Q1.1 (rows/s); then 32
   client threads x 12 queries through the pipeline, twice: cycling the three
   (the mix of bench.py's e2e_device_bench), and cycling 32 literals of the
   COUNT (which stack). Every answer is held against the oracle; each run
   prints QPS, p50 latency and the pipeline's stats (its scan launches must
   equal the kernel's launch counter). Under --trace, the stacked Q1.1's
   device busy ms, idle share and top device ops;
6. select  — selections and ORDER BY ... LIMIT over the same table, through
   `execute_query` and the set executor: three device top-k queries (a double
   key under an id band, match-all ascending, and an integer key with ~690
   matching ties a value, more than the 265 candidates), a LIMIT without ORDER
   BY, an ORDER BY on a key wider than 2^24 (the exact path) and a GROUP BY
   over 500,000 keys trimmed to its top 10. Each answer is held against a
   numpy oracle that orders ties by row; each prints its warm times (5 runs;
   none for the per-segment GROUP BY over 500,000 keys: its cold run, over
   the table's first segment), phases,
   top-k launches (one per segment, none for the others) and `topkExact`. Then
   32 client threads x 12 queries cycling the three top-k queries through the
   pipeline (one stacked top-k launch per distinct query of a drain), and a
   `select_case` line: the stacked top-k of the first query over the whole
   table, its candidates held against numpy for the three top-k queries,
   timed with L2 flushed, against the bound of the bytes it reads. Under
   --trace, each query's device busy ms and idle share (not the per-segment
   GROUP BY, whose runs take tens of seconds);
7. join    — the dimension tables (`supplier`, `customer`, `region`, from
   --seed) built with the package's writer, and the four star-join and
   IN-subquery queries of `ssb.JOIN_QUERIES` through
   `multistage.execute_multistage` over them and the same lineorder table.
   Each answer is held against a numpy float64 oracle; each query must run
   the device build and probe (`joinBuildMs` and `joinProbeMs` present,
   `joinServedHostTier` absent) in its intended regime, by the join
   programs' launch counters, and the four together must cover both regimes
   and both exchanges. Each prints its cold and warm times, host phases,
   `joinStrategy`, launches, joined rows and `joinSkewPct` (under --trace,
   device busy ms and idle share). Then a `join_case` line per program and
   shape: the four device programs alone at bench.py's join shapes (a
   1,048,576-row probe against 1,000, 100,000 and 2,000,000 unique build keys,
   and a zipf-1.5 probe at 100,000), each output equal to numpy's, timed with
   L2 flushed against the bound of the bytes it moves. A partitioned exchange
   that finds every bucket hot (skew 100%) fails the phase;
8. realtime — one committed segment's worth of new lineorder rows (the
   table's rows / 8, from --seed + 1) produced as PCB1 blocks of 16,384 rows
   into a `MemoryStream`, and pumped, 16 blocks a step, into a consuming
   segment that stages its chunks on the card and flushes at that size.
   After every step, Q1.1, the GROUP BY and two `lo_region = 'ASIA'` sums
   (a raw f32 row through `masked_sums`, a raw integer column in FOR form
   through `masked_sums_fused`) run over the consuming view through
   `execute_query`, and Q1.1, the GROUP BY and the f32 sum over the table
   plus the view through the set executor (the merged-dictionary view). Every
   answer is held against numpy over exactly the rows the pump acknowledged
   (rel 1e-5, abs 0.05; counts exactly), each query's launches against its
   route; a `realtime_step` line gives the pump's ms and rows/s, the staging
   ms, the view's attach ms, each query's cold ms and warm median (5 runs)
   with phases (the mixed set's first query after growth pays the merged
   view in `compile` and the restack in `prepare`), the staged device bytes
   and the launches. Then the segment is committed (`build_immutable`),
   loaded, and queried as the ninth segment (`realtime_commit`), and a
   `realtime_case` line per kernel runs the view's scan against its plain
   version (`ms` with L2 flushed against its bound). Under --trace, the
   last step's f32 sum is traced over the view and over the mixed set;
9. expr    — the expression library and the host path over the same table.
   Six device function families (arithmetic, CASE, comparisons and logic,
   math, trig, datetime on lo_orderdate read as epoch ms) through
   `eval_device` on the card against `eval_host` in float64/int64 over the
   same 32-bit values (integers and booleans exactly, f32 at rel 1e-5, trig
   and exp with abs 1e-6 too): an `expr_device` line each with rows, max
   error and the call's ms. Then device-routed queries (a SUM(CASE ...) under
   an id band, which must launch `masked_sums` once per segment and once over
   the set; a filter of device math; a GROUP BY of AVG(power()) and
   MAX(abs())), each per segment and over the set against numpy (rel 1e-5,
   abs 0.05) with plan kind `device`, 5 warm runs: `expr_query` lines.
   Host-routed queries (a GROUP BY on an expression, string functions in the
   filter and the GROUP BY, a selection and a join whose leaf filters need
   the host mask), with plan kind `host` (or a selection's host-mask reason)
   and no kernel launch, against numpy at rel 1e-9, their cold run alone,
   over the table's first 2 segments (4,194,304 rows) but the join:
   `expr_host_query` lines. Last, 2,097,152 rows pumped into a consuming
   segment without staging: Q1.1 and the GROUP BY over its view (host plans)
   and over the table plus the view (the merged view): `expr_consuming`;
10. aggs   — the aggregation library over the same table. Device-routed
   families (the `distinct` output: DISTINCTCOUNT and COUNT(DISTINCT) under
   Q1.1's filter, DISTINCTCOUNTHLL(lo_custkey), the theta sketch, the
   t-digest p95; the power sums: VAR_POP, STDDEV_SAMP, SKEWNESS, KURTOSIS of
   lo_discount; DISTINCTCOUNT and VAR_SAMP by lo_region), per segment and
   over the set, plan kind `device`, 5 warm runs: exact answers equal numpy,
   moments at rel 1e-5 (skewness abs 1e-4), each sketch (HLL, theta,
   t-digest) equal to the same path run with `device="cpu"` and within its
   own error of numpy's exact value (5%; one lo_discount step).
   Host-routed ones (KURTOSIS(lo_quantity) past the f32 power-sum budget,
   PERCENTILE, MODE, DISTINCTCOUNT(lo_custkey) by lo_region past the grouped
   presence cap, COVAR_POP), plan kind `host`, their cold run alone over the
   table's first 2 segments, rel 1e-9. IDSET
   (a host plan) feeding an IN_ID_SET filter (a device LUT leaf); a join with
   DISTINCTCOUNT in its final aggregation; 2,097,152 rows pumped into a
   staged consuming segment: DISTINCTCOUNT over its view and beside the
   table; 32 clients x 12 queries cycling the device queries through the
   pipeline, each answer equal to the set executor's. None of these plans
   reaches a scan kernel (the phase checks every count is 0): `aggs_query`,
   `aggs_consuming` and `serve_pipeline` lines; then `aggs_case` lines, the
   presence and power-sum ops alone at one segment's and the stacked
   table's shapes and masks (CUDA events, L2 flushed) against their bytes
   bound, with `torch.bincount`'s time beside each; lo_suppkey's presence
   under Q1.1 and the power sums also as `group_case` lines (graph replay,
   held to the plain version's outputs).

11. index  — the filter indexes and star-trees: lineorder from --seed again,
   built in the worker pool (beside phases 5–10) with the port's writer with both of bench.py's star-trees
   ([lo_region, lo_discount] and [lo_orderdate, lo_discount], SUM__lo_revenue,
   on one table where bench.py builds two), inverted indexes on lo_region,
   lo_discount and lo_quantity, a range index on lo_orderdate, lo_custkey
   raw with a bloom filter and lo_revenue raw. Per segment, over the set and through the
   pipeline, each against numpy (counts exactly, rel 1e-5, abs 0.05): the
   STAR_QUERY (a star plan on every segment; beside it the same query over
   phase 4's table), the high-cardinality tree's GROUP BY lo_orderdate (the
   stacked device star path over the set), an all-bitmap filter (one
   `bitmap_filter` launch per segment, one for the set), a mixed one,
   IN_ID_SET over the raw lo_custkey (a doc-set leaf), the in-range key absent
   from the most segments (pruned there by their bloom filters), a key past
   the maximum (every plan pruned, no launch), a selection whose host mask
   reads the inverted postings, and IS NULL / IS NOT NULL over a 2,097,152-row
   segment (seed + 4) with 1% of lo_revenue null: `index_query` lines with
   warm times (5 runs), phases and launches. Then `bitmap_case` lines (the
   kernel against its plain version in its three modes, one segment and the
   stacked set, L2 flushed, against the bound of the words it reads) and
   `crossover` lines (bitmap leaves against LUT and interval leaves at
   lo_quantity selectivities 1/50 to 49/50, in an all-bitmap tree and in a
   mixed one, end to end and the row mask alone; the set's per-segment star
   loop against the stacked device star path).
12. search — the search indexes and chunk-compressed raw columns: lineorder
   from --seed + 5 (524,288 rows in 4 aligned segments) with `ssb`'s
   search columns (a githubEvents-like JSON payload, a zipf comment, SSB's
   customer name, a clustered point with 0.1% nulls), built with a JSON index
   on lo_payload, a text index on lo_comment, an FST index on lo_custname, a
   geo index on (lo_lng, lo_lat) at 0.1 degree, an inverted index on
   lo_discount and its four raw columns zlib-compressed (`search_build`
   lines: each index's build seconds and bytes, compressed against raw
   bytes); and a copy without the search indexes and without compression.
   These builds (and phase 4's FOR table rebuilt with zlib, and the
   consuming rows) run in 4 worker processes the smoke starts after phase 4's build.
   `ssb.SEARCH_QUERIES` (JSON_MATCH on a path, an array with a range and a
   presence test; TEXT_MATCH as a term or a phrase by lo_region, a prefix, a
   regex, `= 0`, beside `lo_discount = 2` (a bitmap leaf: one
   `bitmap_filter` launch a pass) and under an ORDER BY ... LIMIT 10;
   REGEXP_LIKE through the FST index, its LUT equal to the copy's; the
   distance predicate at 1, 10 and 100 km, its cell candidates a superset of
   the matches) per segment, over the set and through the pipeline on both
   tables: every answer against numpy (Python json and re, f64 haversine;
   counts exactly, sums rel 1e-5, abs 0.05; a distance within 10 m of the
   radius may fall either way in f32) and the table's against the copy's,
   every checked cold run held to its exact launches (`search_query` lines,
   5 warm runs on the indexed table, whose warm runs must decompress no
   chunk). Q1.1 over the compressed table launches `masked_sums` as the
   copy does, and the FOR query over phase 4's FOR table rebuilt with zlib
   `masked_sums_fused` once per segment as phase 4's table does. Last,
   262,144 rows pumped as JSON rows into a staged consuming segment: the
   JSON and the TEXT query over its view and beside the table (the GROUP BY
   takes the set's per-segment pre-bail): `search_consuming`.
13. mv    — multi-value columns: lineorder from --seed + 7 (4,194,304 rows in 4
   aligned segments) with a STRING multi-value lo_tags (0-4 of 20 tags,
   zipf 1.2), an INT multi-value lo_codes (1-6 of 1,000 codes, zipf 1.1) and
   a unique lo_orderkey (`ssb.make_mv_columns`), inverted indexes on lo_tags
   and lo_discount and a bloom filter on lo_codes, built in a worker process
   the smoke starts after phase 4's build. `ssb.MV_QUERIES` (any-value filters,
   NOT and !=, a mixed tree whose lo_discount = 2 is a bitmap leaf, Q1.1,
   GROUP BY lo_tags (the host explode), the *MV aggregations, a selection
   with multi-value cells, ARRAYLENGTH) per segment, over the set and through
   the pipeline (the host-routed ones per segment and over the set), each
   against numpy over the CSR arrays (a row matches if any value does, NOT
   negates the row; counts exactly, sums rel 1e-5, abs 0.05, the HLL within
   5%) and held to its exact launches (`masked_sums` only for Q1.1,
   `bitmap_filter` only for the mixed tree): `mv_query` lines with 5 warm
   runs on the device routes. Then 262,144 JSON rows (seed + 8) pumped into
   a staged consuming segment, queried alone and beside the table (every
   route per segment): `mv_consuming`. Last, `mv_case` lines: the any-value
   mask alone (torch) by graph replay against its bytes bound.
14. upsert — upsert and dedup, after Apache Pinot's "Stream ingestion with
   Upsert" and "Stream ingestion with Dedup" pages: `ssb.upsert_schema`
   (lineorder with lo_orderkey the primary key, lo_ts the event time, lo_tax
   raw; inverted indexes on lo_region and lo_discount), each stream's JSON
   rows (made in worker processes the smoke starts after phase 4's build) pumped
   through the consumer's per-row lane into MutableSegments that commit at
   their flush thresholds (`build_immutable`, `load_segment`, the next
   consumer). A FULL table (1,048,576 events over 262,144 keys drawn
   zipf(1.2), comparisonColumn lo_ts, 2% late events: 3 committed segments
   and a consuming one of 262,144 rows), a PARTIAL one (262,144 events over
   65,536 keys; INCREMENT, MAX, OVERWRITE, IGNORE; one commit) and a dedup
   one (262,144 events, 25% re-sent; a text index on lo_comment; one
   commit): `upsert_ingest` lines (rows/s, the add_record share, commit
   seconds). `ssb.UPSERT_QUERIES` through `execute_query(..., upsert=)`
   (committed segments on the card under their valid-doc masks, the
   consuming one on the host) against numpy over the live rows (an event is
   live when it is its key's last accepted one: lo_ts at least the running
   maximum; PARTIAL rows replayed in Python), each checked cold run held to
   its exact launches (`masked_sums` one a committed segment for COUNT(*),
   Q1.1 and lo_region = 'ASIA', `masked_sums_fused` for the FOR sum,
   `bitmap_filter` for the GROUP BY under lo_discount = 2, none on a
   consuming segment), 5 warm runs with phases: `upsert_query`. The
   realtime postings of lo_region = 'ASIA' against the forward ids and
   TEXT_MATCH over the dedup table's consuming segment; then 65,536 updates
   to committed keys, the band's staging after the version change and Q1.1
   again, which must change and match numpy (`upsert_update`); last,
   `upsert_case` lines: both scans with the valid band on one committed
   segment against their plain versions and the same scan without the band.

15. batch  — batch ingestion and the query surface a user meets first,
   after Apache Pinot's "Batch Ingestion", "Gapfill Function For Time-Series
   Dataset", "Lookup UDF Join" and "Explain Plan" pages: lineorder from
   --seed + 12 written by the port's writers in the worker pool (1,048,576
   rows as 4 CSV files of 262,144, cut from 2,097,152 for the cluster phase;
   the first 262,144 rows once each as an
   Avro container with deflate, a Thrift binary file with its IDL sidecar, a
   length-delimited Protobuf file read through the committed
   `tests/torch_data/lineorder.desc`, and JSON lines). `run_batch_ingestion`
   (`segment_rows` 262,144, aligned dictionaries, lo_custkey raw, a local
   controller that copies and loads each pushed segment) turns the CSV files
   into 4 segments, `ingest_file_to_segments` each other file into one (the
   Protobuf table with phase 4's FOR layout): `batch_readers` (each reader's
   rows/s, from the seconds the ingestion records inside its readers: for
   CSV, both passes of the runner) and `batch_ingest` lines (the runner's
   stats pass, write pass and pushes apart, as the runner records them).
   Then, each against a numpy oracle (rel 1e-5, abs 0.05; counts exactly;
   host routes rel 1e-9) and held to its exact launches, with 5 warm runs
   on the device routes: Q1.1 per segment (one `masked_sums` a segment) and
   over the 4 as one stacked set (one launch; the set must stack), over
   each format's table (all four equal) and the FOR sum over the Protobuf
   one (`masked_sums_fused`);
   EXPLAIN PLAN FOR Q1.1 and the GROUP BY (the rows the plan kinds give, no
   launch) and EXPLAIN ANALYZE of Q1.1 (one `masked_sums` a segment, the
   root's Rows the answer's row count); a GAPFILL by (day, region) over
   February 1992 under `lo_discount = 2 AND lo_quantity < 3`, per segment
   and over the set (two `bitmap_filter` masks a pass), against a Python
   oracle of the fill rules with gap rows present; LOOKUP of c_nation from
   the 500,000-row customer table and from its first half (misses in a None
   group; host plans, no launch), cold runs only; and `preprocess_segment`
   over copies of the 4 segments adding an inverted index on lo_region, a
   range index on lo_quantity and a bloom filter on lo_custkey: their
   answers equal the copies' before, their launches those of the table built
   with the indexes from the start (in the worker pool), and an in-range
   lo_custkey no row holds is pruned by the new bloom filters only:
   `batch_query` and `batch_preprocess` lines.
16. groupby — the GROUP BY ladder (`engine/grouped.py`, `csrc/grouped_agg.cu`)
   over phase 4's table: GROUP_QUERY (9 cells: the thread rung, a copy of
   the cells a thread), GROUP BY lo_orderdate with COUNT, SUM, MIN and MAX
   (4,097 cells: one copy a block), GROUP BY lo_suppkey with VAR_POP (20,481
   cells: a copy a cluster of 2 blocks), GROUP BY lo_custkey with SUM (503,809 cells: the global rung; per
   segment its cold run alone, over the first 2 segments), DISTINCTCOUNT(lo_discount) by lo_region (the
   grouped count-only form, 144 cells: a copy a warp) and under Q1.1's
   filter (the scalar one, 16 cells), each
   per segment and over the set against numpy (rel 1e-5, abs 0.05; counts
   exactly), every checked cold run held to its exact launches (one
   grouped_agg a GROUP BY pass, one more a distinct output), 5 warm runs:
   `groupby_query` lines. The lo_custkey GROUP BY as two server partials of
   4 segments, through `prepare_partial` and through the pipeline: each a
   `DensePartial`, merged and reduced equal to the oracle and the set's
   answer, with the dense decode's ms beside the state-dict decode's of the
   same outputs: `groupby_partial`. Then `group_case` lines: the kernel
   against its plain version at each rung at the set's shapes (GROUP_QUERY
   per segment too; counts, int sums, min and max exactly, f32 sums within
   one ulp), `ms` (graph replay, L2 flushed), `call_ms`, `plain_ms`,
   `library_ms` (`torch.bincount` and `scatter_reduce_`) and the bytes
   bound; last GROUP_QUERY per segment under the profiler (`groupby_trace`:
   device busy ms, idle share, one `grouped_agg_kernel` a pass and no other
   grouped kernel, no `index_add_`, `bincount` or `scatter_reduce_` kernel).
17. cluster — the cluster roles in one process (`pinot_tpu_torch.cluster`):
   a Catalog, a Controller, a Broker and two ServerNodes, each with a
   DeviceQueryPipeline of its own on the card; phase 4's 8 segments uploaded
   as built to an OFFLINE table with replication 2 (pushed 8 at once, as a
   batch job pushes; gzip tars in the deep store, unpacked and loaded by both
   servers): `cluster_data`. Through `broker.handle_query`: Q1.1, GROUP_QUERY,
   the COUNT, topk_desc and GROUP BY lo_custkey over 500,000 keys (one dense
   partial a server, each checked dense, merged at the broker with no
   `materialize_dense` call), a cold run and 5 warm runs each (lo_custkey
   1),
   every run held to the oracle, to the launches its route implies (one
   `masked_sums` or `grouped_agg` a server the route gives segments, one
   stacked top-k a server) and to no partial result, no retry and 8 segments
   queried: `cluster_query` (with the route); the same SQL on the direct
   set path (`MeshQueryExecutor` over the 8 segments), a cold run and 5
   warm runs: `cluster_set_path`; the broker's reduce phase split into the
   merge and `reduce_to_result` in every warm run (`cluster_query`), and
   lo_custkey's last `reduce_to_result` run again under cProfile:
   `cluster_reduce_profile`; EXPLAIN (no launch) and EXPLAIN
   ANALYZE of Q1.1: `cluster_explain`; 32 clients x 12 queries of the e2e mix
   through the broker (its 8 scatter threads), QPS and p50/p95 beside phase
   5's: `cluster_pipeline`;
   server_1 marked dead, Q1.1 and GROUP_QUERY answered exactly by server_0
   over all 8 segments in one launch: `cluster_failover`; then the cluster
   restarted as a QuickCluster of its default per-segment servers (the
   catalog restored from a snapshot, the segments loaded from the servers'
   local disks, the FOR table uploaded) answering Q1.1 (one `masked_sums` a
   segment) and the FOR sum (one `masked_sums_fused` a segment):
   `cluster_per_segment`. Before the failover, phase 7's supplier table
   uploaded, and `join_supplier` and `semi_in` through `broker.handle_query`
   on the funnel path (the servers are in-process handles: the leaf scans
   scatter to them, the partitions join on the broker's device), a cold and
   CLUSTER_JOIN_WARM_RUNS warm runs each, held to phase 7's oracles (rel
   1e-9) and launches (JOIN_BITMAP): `cluster_join`.
18. realtime_cluster — a REALTIME table consumed through the cluster roles
   past its flush threshold: a Catalog, Controller and Broker and two
   ServerNodes on the card, each with a DeviceQueryPipeline for committed
   segments and reporting to the controller's LLC segment manager; lineorder
   from --seed + 13 on a MemoryStream topic of 2 partitions (PCB1 blocks of
   65,536 rows, consuming segments staged on the card, flush threshold
   524,288 rows), 1,310,720 rows a partition in 5 rounds of 4 blocks: each
   round pumps and completes every consumer (each partition commits twice,
   one COMMIT and one KEEP or DISCARD a segment, at the JAX package's
   offsets), then sends COUNT(*), Q1.1, GROUP_QUERY and the two `lo_region =
   'ASIA'` sums through `broker.handle_query`, each held to the numpy oracle of
   the rows consumed, to the launches its dispatches imply (one set launch a
   server given committed segments, one a consuming view with rows) and to
   `numConsumingSegmentsQueried` and `minConsumingFreshnessTimeMs`:
   `realtime_cluster_round` (pump s, rows/s, staleness); the commits:
   `realtime_cluster_commits` (each one's seconds to ONLINE on both
   replicas); 5 warm runs of Q1.1 and GROUP_QUERY, then the same on the table
   made hybrid by an OFFLINE half (2 segments of the rows up to the median
   date), held to "offline rows up to the boundary plus consumed rows after
   it": `realtime_cluster_hybrid`, `realtime_cluster_latency`; the retired
   consumers hold no device bytes, and the card's resident bytes (allocated
   past the live staging and the GROUP BY workspaces, with the committed
   blocks and the pipelines' caches dropped) grow by no more than
   RT_CLUSTER_MEMORY_SLACK from one point to the next or from the first
   (before each round that commits, after the last commit, after the hybrid
   queries): `realtime_cluster_memory_point` a point, naming what holds the
   device tensors that are new since the first at the last point (or where
   the slack is passed), and `realtime_cluster_memory`. The phase's
   controller leads through a `ControllerFailover` over the phase's deep
   store (lease TTL RT_FAILOVER_TTL_S, renewed each round), so every catalog
   event checkpoints the catalog; at the phase's end it renews once more and
   stops, and a standby Controller with an empty Catalog over the same deep
   store polls until it takes the lease: its restored snapshot equals the
   leader's (schemas, table configs, every segment's metadata and end
   offsets, ideal state, properties), the old leader's heartbeat fails, and
   the standby's ingestion verdict over the same servers equals the
   leader's: `realtime_cluster_failover` (checkpoints, their bytes and ms,
   the takeover's ms, the leadership events journaled).
19. process_cluster — the roles as OS processes joined over HTTP: a
   `ProcessCluster` of a controller process, two server processes that each
   own the card through a DeviceQueryPipeline (`server.device.enabled`), and
   a broker process (children started by `subprocess`, after the kernels are
   built; none is a fork of this process). Phase 4's 8 segments pushed over
   HTTP from 8 threads to an OFFLINE table with replication 2, timed until
   the broker answers every row: `process_cluster_data`. Through the broker's
   HTTP endpoint, `cluster_queries` and EXPLAIN ANALYZE of Q1.1, a cold and 5
   warm runs each (lo_custkey 1), held to the oracle, to the launches the server processes'
   `/debug` report (one `masked_sums` or `grouped_agg` a server that
   answered; topk_desc one stacked top-k a server, from the pipelines'
   stats) and to a whole answer, beside phase 17's numbers:
   `process_cluster_query`, `process_cluster_explain`; server_0's lo_custkey
   partial fetched over the wire, in array form: `process_cluster_dense`; the
   e2e mix (32 clients x 12 queries) through the broker on the mux transport,
   then through a second broker process started with
   `broker.mux.enabled=false`, QPS, p50, p95 and each server's `meanBatch`:
   `process_cluster_pipeline`; each process's device memory:
   `process_cluster_memory`; server_1 SIGKILLed, Q1.1 and GROUP_QUERY exact
   from server_0 (the first through the retry round, the next with server_1
   out of routing): `process_cluster_failover`. Every child is stopped when
   the phase ends, whatever its outcome. Before the memory line, the
   multistage data plane (the `shuffle` path): phase 7's supplier, customer
   and region pushed into the running cluster; the four `ssb.JOIN_QUERIES`
   through the HTTP broker on the mailbox shuffle (the leaves partition on
   the server processes and stream into the stage workers' mailboxes), a
   cold and 2 warm runs each, `mailboxShuffle` true, with the join strategy,
   the workers' join stats and the phases: `process_cluster_join`;
   `join_supplier` once more with OPTION(useMailboxShuffle=false), its
   partitions on the servers' POST /stage: `process_cluster_join_funnel`;
   GROUP BY lo_custkey (500,000 keys) and GROUP BY lo_suppkey VAR_POP with
   OPTION(distributedGroupBy=true), a cold run each and a warm one of
   lo_suppkey's, beside the scatter/gather answer's time:
   `process_cluster_distributed_group_by`.
   Each answer on its oracle (joins rel 1e-9, lo_custkey as
   `custkey_rows_match`), each run's launches (from the servers' /debug) on
   JOIN_BITMAP or one `grouped_agg` a leaf server, and the broker's
   `pinot_broker_p2p_fallbacks` and `pinot_broker_stage_dispatch_failures`
   at 0: `process_cluster_shuffle`. After the memory line, each server
   process's memory ledger read over its `GET /debug/memory` and the
   controller process's memory check (`POST /memoryCheck`, then `GET
   /tables/lineorder_OFFLINE/memoryStatus`): every server's capacity the
   card's own, the table's bytes on both, HEALTHY, the verdict's bytes the
   servers' sum: `process_cluster_memory_plane`. Then, before the
   failover, realtime tables over the processes (`process_realtime`): a
   kafkalite `LogBrokerServer` in this process (its log on the work disk),
   phase 18's stream (2 partitions of PCB1 blocks, `--seed + 13`) into a
   REALTIME `lineorder_rt` table (replication 2, consuming segments staged on
   the card, flush threshold 524,288 rows) that the server processes consume
   on their own loops and commit over HTTP; each of the 5 rounds produced
   through `LogBrokerClient`, a bounded wait until both replicas consumed it
   and the HTTP broker counts it (`staleness_s`), its commits ONLINE on both
   replicas, then phase 18's 5 queries through the HTTP broker on their
   oracles, each run's launches read from the servers' /debug and held to the
   servers' pipeline partials and the consuming views that hold rows:
   `process_realtime_round`; round 3 with the deep store down: its commits
   under `peer://`, server_1 restarted without its copies of the table loads
   every committed segment from server_0 (the deep store's after their
   download retries), answers a partial over them from its pipeline, and one
   validation round heals the segments once the deep store is back:
   `process_realtime_peer`; the committed offsets, each commit's seconds from
   produce to ONLINE on both replicas, the consume rate and the consumers'
   lanes: `process_realtime_commits`; warm runs, then the OFFLINE half pushed
   over HTTP and Q1.1 and GROUP_QUERY on the hybrid table:
   `process_realtime_hybrid`, `process_realtime_latency`; each server's
   device memory before and after the commits: `process_realtime_memory`.
   Then, with that table still consuming, the other stream brokers and the
   ingestion health plane (`process_streams`): a `PulsarLiteBroker` in this
   process feeds a REALTIME `lineorder_pulsar` table (stream type "pulsar")
   phase 18's blocks for 3 rounds (each partition commits once); the table
   is paused before round 3, whose blocks are produced behind the pause:
   `ingestionStatus` DEGRADED with the paused reason and each consuming
   segment's offset lag the blocks produced since, then HEALTHY at lag 0 once
   resumed and consumed (`process_streams_pause`); a `KinesisStub` with keys
   (SigV4 on every request) feeds a REALTIME `lineorder_kinesis` table on 2
   shards 3 rounds of 65,536 JSON lineorder records (`--seed + 15`,
   PutRecords of at most 500; each shard commits at least once). After each
   round of either: a bounded wait until both replicas consumed it, the HTTP
   broker counts it (`staleness_s`) and its commits are ONLINE, then phase
   18's five queries on their oracles with launches exact
   (`process_streams_round`), and every realtime table's `ingestionStatus`
   and each server's `/debug/consuming`, HEALTHY outside the pause
   (`process_streams_ingestion`); `process_streams_summary`.
20. memory — the device-memory plane (`utils/memledger.py`,
   `cluster/tiering.py`): the memory ledger reset and the allocator's bytes
   taken as the baseline; one server over phase 17's catalog, deep store and
   data directory serves phase 4's table and the FOR table with
   `server.hbm.capacity.bytes` set so that its target holds 2 of the 8
   predicted blocks (the table four times its budget): `memory_data`. Q1.1,
   GROUP_QUERY, the COUNT and the FOR sum through the broker, 2 passes, on
   the per-segment route, then on a server on the serving pipeline: each
   answer on its oracle, each run's launches exact (one a segment the gate
   admitted; on the pipeline one a query with an admitted segment, equal to
   its own scan count; none for the host tier), the ledger at or under the
   capacity after every query, printed with the allocator's bytes over the
   baseline and the transient peak: `memory_query`; each route's admissions,
   rejections, evictions, host-tier segments, ledger watermark and
   allocator peak (`rejections + evictions > 0`), every segment unloaded
   back to a ledger of 0: `memory_route`. The cap lifted: the card's own
   capacity, no segment on the host tier, the ledger reconciled against the
   allocator with the bytes a walk of the server's blocks finds beside it:
   `memory_lifted`; a retention round under
   `controller.retention.cold.demote` demotes one segment, the next Q1.1
   loads it from the deep store (its ms): `memory_cold`; every segment
   unloaded: the ledger exactly 0, the allocator's bytes over the baseline:
   `memory_unload`.

It prints a `seconds` line (each phase's wall seconds and the total), a
`{"kernels": [...]}` line (with the kernels' launches per path, each path's
count summed over its checked runs: the counts set to 0 just before a run,
read just after and held to the run's expected count; the pipeline traffic
adds its scan launches, held to the pipeline's own count. The join phase
launches neither scan kernel: its leaf filters are the plain mask and its
device programs are torch code; the realtime phase must launch both; the
expr phase's device queries `masked_sums`, its host queries none; the aggs
phase no scan; `bitmap_filter` where a plain-body filter or a selection's
device mask reads bitmap leaves, one launch per mask; the search phase all
three; the mv phase `masked_sums` and `bitmap_filter`; the upsert phase all
three, the scans with the valid band; the batch phase all three, none
under EXPLAIN or LOOKUP; `grouped_agg` on every device GROUP BY pass and
every grouped or scalar distinct and scalar power-sum pass of every phase,
the pipeline traffic's logged only, as `bitmap_filter`'s; the
realtime_cluster phase and the process_realtime and process_streams paths
`masked_sums`, `masked_sums_fused` and `grouped_agg`; the shuffle path `bitmap_filter` and
`grouped_agg`; the memory phase `masked_sums`, `masked_sums_fused` and
`grouped_agg`), the memory phase's numbers,
the nvidia-smi line, and as its last line
`{"ok": true, "device": {...}}`. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import gc
import itertools
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SUM_RTOL = 1e-5
ORACLE_RTOL, ORACLE_ATOL = 1e-5, 0.05   # the reference's device tolerance
# the join answers: both the port and the oracle sum joined rows on the host
# in float64, so a lost or doubled joined row must fail (the CPU tests' REL)
JOIN_RTOL, JOIN_ATOL = 1e-9, 0.0
TIMED_RUNS = 25
SEGMENTS = 8                                  # bench.py's table: 8 segments
FOR_ROWS, FOR_SEGMENTS = 4 * 1024 * 1024, 2   # the FOR query's table
QUERY_RUNS = 20                               # warm runs per query
SERVE_COUNT_QUERY = "SELECT COUNT(*) FROM lineorder WHERE lo_quantity < 10 LIMIT 5"
MANY_COPIES = 64                              # queries in one execute_many
SERVE_CLIENTS, SERVE_QUERIES_PER_CLIENT = 32, 12   # bench.py's e2e_device_bench
L2_FLUSH_BYTES = 256 << 20   # written before each timed run: > the H100's 50 MB L2
SELECT_QUERIES = [
    # (id, sql, top-k launches per segment, answered by the exact path, the
    # filter's bitmap_filter launches per mask: 1 where the device mask reads
    # bitmap leaves (planner.select_bitmap_leaves), one all-bitmap tree; the
    # grouped_agg launches a pass: 1 for the GROUP BY)
    ("topk_desc", "SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity >= 10 "
     "ORDER BY lo_revenue DESC LIMIT 7", 1, False, 0, 0),
    ("topk_all", "SELECT lo_suppkey, lo_extendedprice FROM lineorder "
     "ORDER BY lo_extendedprice LIMIT 12", 1, False, 0, 0),
    ("topk_ties", "SELECT lo_custkey, lo_orderdate, lo_revenue FROM lineorder "
     "WHERE lo_quantity >= 10 ORDER BY lo_suppkey LIMIT 9", 1, False, 0, 0),
    ("select_limit", "SELECT lo_region, lo_revenue FROM lineorder WHERE lo_quantity < 3 "
     "LIMIT 10", 0, False, 1, 0),
    ("order_exact", "SELECT lo_custkey, lo_orderdate FROM lineorder WHERE lo_quantity = 1 "
     "AND lo_discount = 0 ORDER BY lo_orderdate DESC LIMIT 5", 0, True, 1, 0),
    ("group_trim", "SELECT lo_custkey, SUM(lo_revenue) FROM lineorder GROUP BY lo_custkey "
     "ORDER BY SUM(lo_revenue) DESC LIMIT 10", 0, None, 0, 1),
]
JOIN_WARM_RUNS = 2     # cut from 3 to leave room for the index phase
REALTIME_BLOCK_ROWS = 16_384   # bench.py's _ingest_topic_blocks block
REALTIME_STEP_BLOCKS = 16      # blocks one pump step takes: 262,144 rows
REALTIME_WARM_RUNS = 5
REALTIME_F32_QUERY = ("SELECT SUM(lo_revenue), COUNT(*) FROM lineorder "
                      "WHERE lo_region = 'ASIA'")
REALTIME_CUSTKEY_QUERY = ("SELECT SUM(lo_revenue), COUNT(*) FROM lineorder "
                          "WHERE lo_custkey < 250000")
REALTIME_FOR_QUERY = ("SELECT SUM(lo_quantity), COUNT(*) FROM lineorder "
                      "WHERE lo_region = 'ASIA'")
# query: (device regime, exchange) each must run in
JOIN_EXPECT = {"join_supplier": ("scatter", "broadcast"),
               "join_customer": ("scatter", "partitioned"),
               "join_region": ("sort", "broadcast"),
               "semi_in": ("scatter", "broadcast")}
# query: (bitmap_filter launches of one run per lineorder segment, and over
# the dimension table's one segment): a leaf whose filter reads bitmap leaves
# masks each of its segments once (here only the supplier leaves' s_region =
# 'AMERICA' and s_nation = 'JAPAN'; lineorder's leaves are denser than the cap)
JOIN_BITMAP = {"join_supplier": (0, 1), "join_customer": (0, 0), "join_region": (0, 0),
               "semi_in": (0, 1)}
JOIN_PROBE_ROWS = 1 << 20                         # bench.py's join_bench shapes
JOIN_BUILD_KEYS = (1000, 100_000, 2_000_000)
JOIN_ZIPF_KEYS, JOIN_ZIPF_S = 100_000, 1.5
# the select phase's warm runs, cut from QUERY_RUNS to leave room for the join
# phase; the per-segment GROUP BY over 500,000 keys decodes every segment's
# ~490,000 groups in Python (17-19 s a run): its cold run alone
SELECT_RUNS = 5     # cut from 10 to leave room for the index phase
GROUP_TRIM_PER_SEGMENT_RUNS = 0
# the per-segment group_trim (500,000 state lists decoded a segment: 17-37 s
# over the 8, 22 s over 2) reads the table's first segment, to keep the smoke
# inside its time; its set run reads all 8
GROUP_TRIM_PER_SEGMENT_SEGMENTS = 1
LIBRARY_NOTE = ("library_ms is null: no single PyTorch call computes a masked "
                "multi-sum with its count")
KERNEL_SYMBOL = "masked_sums_kernel"
BITMAP_SYMBOL = "bitmap_filter_kernel"
DEVICE_OPS_PER_CALL = 1   # the design: one launch, no torch op after it
PROFILED_CALLS = 10
PROFILER_MARGIN_S = 0.005   # idle time at each edge of a profiled window
TRACED_RUNS = 10            # warm runs of a query in one --trace window
_OPERAND = {"f": "float", "h": "uint8", "t": "uint16"}   # Itanium codes


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def segment_rows(rows: int, segments: int) -> int:
    """Rows of the first segment `build_aligned_segments` cuts from `rows`: the
    `n` the executor hands the scan kernels for that table."""
    return int(np.linspace(0, rows, segments + 1, dtype=np.int64)[1])


def stacked_rows(rows: int, segments: int) -> int:
    """Rows of the set executor's stacked block for that table: one slot per
    segment, each padded to the largest segment's padded size."""
    from pinot_tpu_torch.engine.datablock import padded_rows
    sizes = np.diff(np.linspace(0, rows, segments + 1, dtype=np.int64))
    return segments * padded_rows(int(sizes.max()))


def time_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS) -> float:
    """Median of `runs` timings of `fn()` with CUDA events, after two warm-up
    calls. Before each timed run `flush` is overwritten outside the events, so
    the inputs come from HBM, as each segment's columns do on the path. For an
    eager call this includes the host's launch overhead when the host is slower
    than the device."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, flush: torch.Tensor, runs: int = TIMED_RUNS) -> float:
    """Device time of `fn`'s launched work: `fn` captured once into a CUDA graph,
    and the graph's replays timed with CUDA events (median of `runs`). Replay
    launches the whole captured sequence at once, so host overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream before capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush, runs)


def _profiled(step, calls: int) -> tuple:
    """The card's ops of `calls` runs of `step()` under torch.profiler, as
    (name, start us, end us), and the host wall seconds of those runs. One
    warm-up cycle runs first, so that the counted cycle starts with the
    profiler's device tracing already running, and each cycle idles
    PROFILER_MARGIN_S at both edges, so that no op lies on the window's
    boundary. The profiler's own step annotations are not ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    ops = []

    def ready(prof):
        ops.extend((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and not e.name.startswith("ProfilerStep"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(PROFILER_MARGIN_S)
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILER_MARGIN_S)
            prof.step()
    return ops, wall


def profile_call(fn, flush: torch.Tensor, calls: int = PROFILED_CALLS) -> tuple:
    """(device ops per call, kernel ms) from torch.profiler: `calls` eager calls
    back to back give every op a call puts on the card; a second window, with
    L2 flushed before each call, gives the median time of the kernel alone with
    its inputs in HBM. Raises unless one call is the design's count of ops."""

    def flushed():
        flush.zero_()
        fn()

    ops, _ = _profiled(fn, calls)
    if len(ops) != DEVICE_OPS_PER_CALL * calls:
        raise AssertionError(f"one call puts {len(ops) / calls} ops on the card, "
                             f"expected {DEVICE_OPS_PER_CALL}: "
                             f"{sorted({name for name, _, _ in ops})}")
    times = [end - start for name, start, end in _profiled(flushed, calls)[0]
             if KERNEL_SYMBOL in name]
    if len(times) != calls:
        raise AssertionError(f"the profiler saw {len(times)} {KERNEL_SYMBOL} launches "
                             f"for {calls} calls")
    return len(ops) / calls, statistics.median(times) / 1e3


def kernel_usage(log: str) -> dict:
    """ptxas's registers, shared memory and spills per kernel instance."""
    from pinot_tpu_torch.engine import cuda_lib
    named = {}
    for mangled, use in cuda_lib.ptxas_usage(log).items():
        at = mangled.find(KERNEL_SYMBOL + "I")
        if at >= 0:
            code = mangled[at + len(KERNEL_SYMBOL) + 1]
            named[f"{KERNEL_SYMBOL}<{_OPERAND.get(code, code)}>"] = use
    if not named:
        raise AssertionError(f"no {KERNEL_SYMBOL} instance in the ptxas log:\n{log}")
    return named


def bitmap_usage(log: str) -> dict:
    """ptxas's registers, shared memory and spills per bitmap_filter kernel
    instance; raises on a stack frame or a spill (the filter's stack lives in
    shared memory)."""
    from pinot_tpu_torch.engine import cuda_lib
    usage = {name: use for name, use in cuda_lib.ptxas_usage(log).items()
             if BITMAP_SYMBOL in name}
    if not usage:
        raise AssertionError(f"no {BITMAP_SYMBOL} instance in the ptxas log:\n{log}")
    for name, use in usage.items():
        if any(use.get(k, 0) for k in ("stack_bytes", "spill_store_bytes", "spill_load_bytes")):
            raise AssertionError(f"{name} has a stack frame or spills: {use}")
    return usage


GROUPED_KERNELS = 6   # grouped_agg_kernel per rung (5), the second launch's finalize


def grouped_usage(log: str) -> dict:
    """ptxas's registers, shared memory and spills per grouped_agg kernel
    (one per rung, the second launch's finalize); raises on a stack frame or a
    spill (a kernel parameter indexed at run time may be copied to local
    memory)."""
    from pinot_tpu_torch.engine import cuda_lib
    usage = {name: use for name, use in cuda_lib.ptxas_usage(log).items()
             if "grouped_" in name}
    if len(usage) != GROUPED_KERNELS:
        raise AssertionError(f"{len(usage)} grouped_agg kernels in the ptxas log:\n{log}")
    for name, use in usage.items():
        if any(use.get(k, 0) for k in ("stack_bytes", "spill_store_bytes", "spill_load_bytes")):
            raise AssertionError(f"{name} has a stack frame or spills: {use}")
    return usage


def grouped_sass() -> dict:
    """The atomic instructions of each grouped_agg kernel, by opcode, from
    `cuobjdump -sass` of the built library: none in shared memory on the
    thread rung (plain read-modify-writes); native 32-bit shared atomics and
    64-bit compare-and-swap loops (ATOMS.CAST.SPIN) on the warp and block
    rungs; generic atomics (ATOM) into distributed shared memory on the
    cluster rung; global atomics into the accumulators on every rung (REDG
    on the global rung's rows)."""
    import re
    from pinot_tpu_torch.engine import cuda_lib
    tool = os.path.join(os.path.dirname(cuda_lib.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", cuda_lib.library_path("grouped_agg")],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    atomics, func = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            atomics[func] = {}
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", line)
        if m and func:
            atomics[func][m.group(1)] = atomics[func].get(m.group(1), 0) + 1
    return atomics


# -- phase 3: kernels against their plain versions ----------------------------

def kernel_cases(n: int, n_for: int, n_stacked: int, gen: torch.Generator):
    """The main paths' shapes: one SSB segment of n rows with Q1.1's three id
    bands (lo_orderdate in 1993, lo_discount 1..3, lo_quantity < 25), one
    segment of the FOR table (n_for rows) with that query's two, over dict ids
    with SSB's cardinalities, and the whole stacked table (n_stacked rows),
    which the set executor scans in one launch for Q1.1 (three bands, one
    sum) and for the COUNT query (one band, no sum)."""
    from pinot_tpu_torch.engine import scan

    def ids(card, rows=n):
        return torch.randint(0, card, (rows,), generator=gen, dtype=torch.int32).cuda()

    od, disc, qty = ids(2352), ids(11), ids(50)
    price = (torch.rand(n, generator=gen, dtype=torch.float64) * 9999 + 1).float().cuda()
    row = price * disc.float()       # Q1.1's operand: lo_extendedprice * lo_discount
    revenue = (torch.rand(n, generator=gen) * 60000).cuda()
    fod, fdisc = ids(2352, n_for), ids(11, n_for)
    d8 = torch.randint(0, 50, (n_for,), generator=gen,
                       dtype=torch.int32).to(torch.uint8).cuda()
    d16 = torch.randint(0, 60000, (n_for,), generator=gen,
                        dtype=torch.int32).to(torch.uint16).cuda()
    q11 = [(336, 671), (1, 3), (0, 23)]
    lo, hi = scan.INT32_MIN, scan.INT32_MAX
    r, rf = n - n // 8 - 3, n_for - n_for // 8 - 3   # ragged: no multiple of a block
    wide_cols = (od, disc, qty, ids(7), ids(25), ids(50), ids(250), ids(1000))
    wide_bands = q11 + [(0, 5), (3, 20), (0, 40), (10, 240), (0, 900)]
    wide_rows = [row, revenue] + [(torch.rand(n, generator=gen) * 100).cuda()
                                  for _ in range(6)]
    sod, sdisc, sqty = ids(2352, n_stacked), ids(11, n_stacked), ids(50, n_stacked)
    srow = ((torch.rand(n_stacked, generator=gen, dtype=torch.float64) * 9999 + 1).float()
            .cuda() * sdisc.float())
    return [
        # (case, kernel name, args, main-path shape?)
        ("q11_1sum", "masked_sums", ((od, disc, qty), q11, [row]), True),
        ("q11_stacked", "masked_sums", ((sod, sdisc, sqty), q11, [srow]), True),
        # the set path's COUNT (lo_quantity < 10): one band, no sum, 4 B/row
        ("count_stacked", "masked_sums", ((sqty,), [(0, 8)], []), True),
        ("q11_2sums", "masked_sums", ((od, disc, qty), q11, [row, revenue]), False),
        ("ragged_n", "masked_sums",
         ((od[:r], disc[:r], qty[:r]), q11, [row[:r]]), False),
        ("empty_mask", "masked_sums", ((od, disc, qty), [(1, 0)] * 3, [row]), False),
        ("one_sided", "masked_sums", ((od, disc, qty), [(lo, 671), (1, hi), (lo, 23)],
                                      [row]), False),
        ("c8_k8", "masked_sums", (wide_cols, wide_bands, wide_rows), False),
        ("for_u8", "masked_sums_fused", ((fod, fdisc), q11[:2], [(1.0, d8)]), True),
        ("for_u16", "masked_sums_fused", ((fod, fdisc), q11[:2], [(-5.0, d16)]), False),
        ("for_u8_ragged", "masked_sums_fused",
         ((fod[:rf], fdisc[:rf]), q11[:2], [(1.0, d8[:rf])]), False),
    ]


def roofline(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over the f32 rate."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bound(name: str, args) -> tuple:
    """(bound_ms, bound_by): each input read once and each output written once
    over the memory rate, against ~2 compares + 1 AND per band and a multiply and
    add per sum and per row (plus the FOR decode add) over the f32 rate."""
    cols, bands, rows = args
    operands = [d for _, d in rows] if name == "masked_sums_fused" else list(rows)
    n = int((list(cols) + operands)[0].shape[0])
    nbytes = sum(t.numel() * t.element_size() for t in list(cols) + operands)
    nbytes += 4 * len(operands) + 8
    ops_per_row = 3 * len(cols) + 2 * len(operands) + 1
    if name == "masked_sums_fused":
        ops_per_row += 2 * len(operands)
    return roofline(nbytes, n * ops_per_row)


def check_kernels(n: int, n_for: int, n_stacked: int, seed: int):
    from pinot_tpu_torch.engine import scan
    fns = {"masked_sums": (scan.masked_sums, scan.masked_sums_plain),
           "masked_sums_fused": (scan.masked_sums_fused, scan.masked_sums_fused_plain)}
    gen = torch.Generator().manual_seed(seed)
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    results = {}
    for case, name, args, main in kernel_cases(n, n_for, n_stacked, gen):
        kernel, plain = fns[name]
        ks, kc = kernel(*args)
        ps, pc = plain(*args)
        torch.cuda.synchronize()
        ks, ps = ks.double().cpu(), ps.double().cpu()
        kc, pc = int(kc), int(pc)
        abs_err = float((ks - ps).abs().max()) if ks.numel() else 0.0
        rel_err = float(((ks - ps).abs() / ps.abs().clamp_min(1e-30)).max()) \
            if ks.numel() else 0.0
        rel_err = 0.0 if abs_err == 0.0 else rel_err
        if kc != pc or rel_err > SUM_RTOL:
            raise AssertionError(f"{case}: kernel {ks.tolist()} count {kc} vs plain "
                                 f"{ps.tolist()} count {pc} (rel {rel_err:.3g})")
        # device time (graph replay) is the kernel's; the eager call's time adds
        # the wrapper's host overhead, which is what one query pays per segment
        ms = graph_ms(lambda: kernel(*args), flush)
        plain_ms = graph_ms(lambda: plain(*args), flush)
        call_ms = time_ms(lambda: kernel(*args), flush)
        plain_call_ms = time_ms(lambda: plain(*args), flush)
        ops_per_call, kernel_ms = profile_call(lambda: kernel(*args), flush)
        bms, by = bound(name, args)
        log("kernel_case", case=case, kernel=name, rows=int(args[0][0].shape[0]),
            count=kc, max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms, kernel_ms=kernel_ms,
            device_ops_per_call=ops_per_call, call_ms=call_ms,
            plain_call_ms=plain_call_ms, bound_ms=bms, bound_by=by,
            pct_of_bound=100.0 * bms / ms)
        agg = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                        "cases": {}})
        agg["max_abs_err"] = max(agg["max_abs_err"], abs_err)
        agg["max_rel_err"] = max(agg["max_rel_err"], rel_err)
        if main:
            # the first main case (one segment) gives the kernel's headline
            # numbers, as in earlier runs; every main case is kept under "cases"
            numbers = dict(rows=int(args[0][0].shape[0]), ms=ms, plain_ms=plain_ms,
                           kernel_ms=kernel_ms, call_ms=call_ms,
                           plain_call_ms=plain_call_ms, bound_ms=bms, bound_by=by)
            agg["cases"][case] = numbers
            if "case" not in agg:
                agg.update(case=case, **{k: v for k, v in numbers.items() if k != "rows"})
    return results


# -- phase 4: the path -------------------------------------------------------------

def q11_mask(c):
    return ((c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
            & (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25))


def oracle_q11(c):
    m = q11_mask(c)
    return [[float((c["lo_extendedprice"][m] * c["lo_discount"][m]).sum())]]


def oracle_group(c):
    from pinot_tpu_torch.ssb import REGIONS
    m = ((c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & (c["lo_quantity"] < 25))
    rows = []
    for region in sorted(REGIONS):
        g = m & (c["lo_region"] == region)
        if g.any():
            rows.append([region, float(c["lo_revenue"][g].sum()), int(g.sum())])
    return rows[:10]


def oracle_for(c):
    m = ((c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
         & (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3))
    return [[float(c["lo_quantity"][m].astype(np.float64).sum()), int(m.sum())]]


def rows_match(got, want, rtol=ORACLE_RTOL, atol=ORACLE_ATOL) -> bool:
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                if not math.isclose(float(x), y, rel_tol=rtol, abs_tol=atol):
                    return False
            elif x != y:
                return False
    return True


def run_path(args, work: str, pool=None):
    """Phase 4; `pool` (a process pool) builds the table's segments side by
    side."""
    from pinot_tpu_torch import execute_query, load_segment
    from pinot_tpu_torch.segment.writer import (SegmentGeneratorConfig,
                                                build_aligned_segments)
    from pinot_tpu_torch.ssb import (FOR_QUERY, GROUP_QUERY, QUERY, make_columns,
                                     ssb_schema)

    t0 = time.perf_counter()
    cols = make_columns(args.rows, args.seed)
    gen_s = time.perf_counter() - t0
    schema = ssb_schema()
    t0 = time.perf_counter()
    paths = build_aligned_segments(schema, cols, os.path.join(work, "main"), "lineorder",
                                   SEGMENTS, executor=pool)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = [load_segment(p) for p in paths]
    load_s = time.perf_counter() - t0
    for_rows = min(FOR_ROWS, args.rows)
    for_cols = {k: v[:for_rows] for k, v in cols.items()}
    t0 = time.perf_counter()
    for_paths = build_aligned_segments(
        schema, for_cols, os.path.join(work, "for"), "lineorder", FOR_SEGMENTS,
        SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"]), executor=pool)
    for_build_s = time.perf_counter() - t0
    for_table = [load_segment(p) for p in for_paths]
    log("data", rows=args.rows, segments=SEGMENTS, seed=args.seed,
        generate_s=gen_s, build_s=build_s, load_s=load_s, for_rows=for_rows,
        for_segments=FOR_SEGMENTS, for_build_s=for_build_s,
        build_workers=pool._max_workers if pool is not None else 1)

    queries = [
        ("q1_1", QUERY, table, cols, oracle_q11, counts_of(masked_sums=len(table))),
        ("group_by", GROUP_QUERY, table, cols, oracle_group,
         counts_of(grouped_agg=len(table))),
        ("for_sum", FOR_QUERY, for_table, for_cols, oracle_for,
         counts_of(masked_sums_fused=len(for_table))),
    ]
    launches = counts_of()
    for name, sql, segs, c, oracle, want_launches in queries:
        rows = sum(s.num_docs for s in segs)
        # the path: counts set to 0 just before, read just after
        reset_launch_counts()
        t0 = time.perf_counter()
        result = execute_query(segs, sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != want_launches:
            raise AssertionError(f"{name}: kernel launches {counts}, expected {want_launches}")
        for k, v in counts.items():
            launches[k] += v
        want = oracle(c)
        if not rows_match(result.rows, want):
            raise AssertionError(f"{name}: got {result.rows}, oracle {want}")
        times, phases = [], []
        for _ in range(QUERY_RUNS):
            t0 = time.perf_counter()
            res = execute_query(segs, sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            phases.append(res.stats["phaseTimesMs"])
        med = statistics.median(times)
        fields = dict(query=name, rows=rows, segments=len(segs), answer=result.rows,
                      oracle=want, launches=counts, cold_s=cold_s,
                      warm_median_ms=med * 1e3, warm_min_ms=min(times) * 1e3,
                      warm_max_ms=max(times) * 1e3, warm_runs=len(times),
                      rows_per_s=rows / med,
                      phase_median_ms={k: statistics.median(p[k] for p in phases)
                                       for k in phases[0]})
        if args.trace:
            fields["trace"] = trace_query(lambda: execute_query(segs, sql))
        log("query", **fields)
    return launches, table, cols, for_table


# -- phase 5: serve --------------------------------------------------------------

def oracle_count(c):
    return [[int((c["lo_quantity"] < 10).sum())]]


def warm_times(fn, runs: int = QUERY_RUNS) -> tuple:
    """Host-clock times of `runs` calls of `fn`, each ending in a synchronize,
    and the calls' results."""
    times, results = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        results.append(fn())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"warm_median_ms": statistics.median(times) * 1e3,
            "warm_min_ms": min(times) * 1e3, "warm_max_ms": max(times) * 1e3,
            "warm_runs": runs, "median_s": statistics.median(times)}, results


def launch_counts() -> dict:
    """Each kernel's launch count (its wrapper adds one where it launches)."""
    from pinot_tpu_torch.engine import bitmap, grouped, scan
    return {"masked_sums": scan.masked_sums.launches,
            "masked_sums_fused": scan.masked_sums_fused.launches,
            "bitmap_filter": bitmap.bitmap_filter.launches,
            "grouped_agg": grouped.grouped_agg.launches}


def reset_launch_counts() -> None:
    from pinot_tpu_torch.engine import bitmap, grouped, scan
    scan.reset_launch_counts()
    bitmap.reset_launch_counts()
    grouped.reset_launch_counts()


def counts_of(masked_sums: int = 0, masked_sums_fused: int = 0, bitmap_filter: int = 0,
              grouped_agg: int = 0) -> dict:
    """The launches a checked run must make, by kernel. `grouped_agg`: one a
    device GROUP BY pass (its count and every sum, power sum, min and max),
    one more a grouped or scalar `distinct` output, one a scalar body pass's
    power sums."""
    return {"masked_sums": masked_sums, "masked_sums_fused": masked_sums_fused,
            "bitmap_filter": bitmap_filter, "grouped_agg": grouped_agg}


def run_serve(args, table, cols) -> dict:
    """The stacked set executor and the serving pipeline over the path's table.
    Returns the kernels' launches in the runs that were checked."""
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY

    rows = sum(s.num_docs for s in table)
    mx = MeshQueryExecutor()
    launches = counts_of()

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    queries = [("q1_1", QUERY, oracle_q11, counts_of(masked_sums=1)),
               ("group_by", GROUP_QUERY, oracle_group, counts_of(grouped_agg=1)),
               ("count_quantity", SERVE_COUNT_QUERY, oracle_count, counts_of(masked_sums=1))]
    for name, sql, oracle, want_launches in queries:
        reset_launch_counts()
        t0 = time.perf_counter()
        result = mx.execute(table, sql)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != want_launches:
            raise AssertionError(f"serve {name}: kernel launches {counts}, "
                                 f"expected {want_launches} for the whole set")
        add(counts)
        want = oracle(cols)
        if not rows_match(result.rows, want):
            raise AssertionError(f"serve {name}: got {result.rows}, oracle {want}")
        warm, results = warm_times(lambda: mx.execute(table, sql))
        phases = [r.stats["phaseTimesMs"] for r in results]
        fields = dict(query=name, rows=rows, segments=len(table), answer=result.rows,
                      oracle=want, launches=counts, cold_s=cold_s,
                      rows_per_s=rows / warm.pop("median_s"), **warm,
                      phase_median_ms={k: statistics.median(p[k] for p in phases)
                                       for k in phases[0]})
        if args.trace and name == "q1_1":
            fields["trace"] = trace_query(lambda: mx.execute(table, sql))
        log("serve_query", **fields)
    _, block = next(iter(mx._set_blocks.values()))
    log("serve_block", s_pad=block.s_pad, rows_per_slot=block.rows,
        pad_waste_pct=block.pad_waste_pct, stacked_columns=sorted(map(list, block._cache)))

    # execute_many: every copy dispatched, then one fetch
    want = oracle_q11(cols)
    reset_launch_counts()
    results = mx.execute_many(table, [QUERY] * MANY_COPIES)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != counts_of(masked_sums=MANY_COPIES):
        raise AssertionError(f"execute_many: {counts} launches for {MANY_COPIES} queries")
    add(counts)
    bad = [r.rows for r in results if not rows_match(r.rows, want)]
    if bad:
        raise AssertionError(f"execute_many: {len(bad)} answers off the oracle: {bad[:3]}")
    warm, _ = warm_times(lambda: mx.execute_many(table, [QUERY] * MANY_COPIES), runs=5)
    med = warm.pop("median_s")
    log("serve_many", copies=MANY_COPIES, launches=counts, queries_per_s=MANY_COPIES / med,
        rows_per_s=MANY_COPIES * rows / med, **warm)

    # the pipeline: client threads cycling the three queries, as e2e_device_bench
    # does; then the COUNT with a literal per client and query, which stacks
    quantity_counts = np.cumsum(np.bincount(cols["lo_quantity"], minlength=52))
    mixes = {
        "e2e_mix": [(QUERY, oracle_q11(cols)), (GROUP_QUERY, oracle_group(cols)),
                    (SERVE_COUNT_QUERY, oracle_count(cols))],
        "literals": [(f"SELECT COUNT(*) FROM lineorder WHERE lo_quantity < {q}",
                      [[int(quantity_counts[q - 1])]]) for q in range(2, 2 + SERVE_CLIENTS)],
    }
    for mix, queries in mixes.items():
        counts = serve_pipeline(mx, table, mix, queries)
        add(counts)
    return launches


#: each pipeline mix's QPS and latency, which the cluster phase prints beside its own
SERVE_MIX_NUMBERS: dict = {}


def serve_pipeline(mx, table, mix: str, queries, rtol=ORACLE_RTOL, atol=ORACLE_ATOL) -> dict:
    """SERVE_CLIENTS threads, each sending SERVE_QUERIES_PER_CLIENT queries
    through one DeviceQueryPipeline, client c's query i being queries[(c + i) %
    len(queries)], every answer held against its oracle rows (floats at
    `rtol`, `atol`). Logs QPS, the latency p50/p95, the pipeline's stats and
    every kernel's launches; returns the scan kernels' launches, which are held
    to the pipeline's own count (bitmap_filter's and grouped_agg's are logged
    only: copies of a query deduplicated in one drain share one pass, so no
    count per query holds)."""
    import threading

    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result

    ctxs = [compile_query(sql, table[0].schema) for sql, _ in queries]
    aggs = [[make_agg(f) for f in ctx.aggregations] for ctx in ctxs]

    def answer(pipeline, q):
        partial = pipeline.execute_partial(ctxs[q], table)
        merged = merge_segment_results([partial], aggs[q])
        return reduce_to_result(ctxs[q], merged, aggs[q], list(ctxs[q].group_by)).rows

    solo_pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        solo = []
        for qi in range(9):
            t0 = time.perf_counter()
            answer(solo_pipeline, qi % len(queries))
            solo.append(time.perf_counter() - t0)
    finally:
        solo_pipeline.stop()

    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    lat, failures = [], []
    lock = threading.Lock()

    def client(ci: int) -> None:
        mine, wrong = [], []
        for qi in range(SERVE_QUERIES_PER_CLIENT):
            q = (ci + qi) % len(queries)
            t0 = time.perf_counter()
            try:
                got = answer(pipeline, q)
            except Exception as e:   # recorded, and the phase fails below
                wrong.append(f"{queries[q][0][:48]}: {e!r}")
                continue
            mine.append(time.perf_counter() - t0)
            if not rows_match(got, queries[q][1], rtol, atol):
                wrong.append(f"{queries[q][0][:48]}: {got} vs {queries[q][1]}")
        with lock:
            lat.extend(mine)
            failures.extend(wrong)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
    reset_launch_counts()
    kernels.reset_topk_launches()
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        stats = pipeline.stats()
    finally:
        pipeline.stop()
    counts = launch_counts()
    topk_launches = kernels.topk_launches()
    n_queries = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"pipeline {mix}: clients still running after 600 s")
    if failures:
        raise AssertionError(f"pipeline {mix}: {len(failures)} bad answers: {failures[:3]}")
    if len(lat) != n_queries or stats["errors"] or stats["timeouts"]:
        raise AssertionError(f"pipeline {mix}: {len(lat)} of {n_queries} answered, {stats}")
    if counts["masked_sums"] != stats["scanLaunches"]:
        raise AssertionError(f"pipeline {mix} reports {stats['scanLaunches']} scan "
                             f"launches, the kernel counted {counts['masked_sums']}")
    if topk_launches != stats["topkLaunches"] or stats["topkExact"]:
        raise AssertionError(f"pipeline {mix}: {topk_launches} top-k launches counted, "
                             f"stats {stats['topkLaunches']}, {stats['topkExact']} exact")
    lat.sort()
    SERVE_MIX_NUMBERS[mix] = dict(qps=n_queries / wall, p50_ms=statistics.median(lat) * 1e3,
                                  p95_ms=lat[int(0.95 * (len(lat) - 1))] * 1e3)
    log("serve_pipeline", mix=mix, distinct_queries=len(queries), clients=SERVE_CLIENTS,
        queries=n_queries, wall_s=wall, **SERVE_MIX_NUMBERS[mix],
        solo_p50_ms=statistics.median(solo) * 1e3, launches=counts,
        topk_launches=topk_launches, stats=stats)
    return {k: v for k, v in counts.items() if k not in ("bitmap_filter", "grouped_agg")}


# -- phase 6: select ----------------------------------------------------------------

def oracle_rows(c, mask, select, key=None, desc=False, limit=10):
    """The first `limit` matching rows by `key` (ties by row index), as lists
    of the `select` columns' values; without a key, in row order."""
    idx = np.flatnonzero(mask)
    if key is not None:
        s = c[key][idx].astype(np.float64)
        s = -s if desc else s
        if len(s) > limit:   # keep every row that ties the limit-th key
            keep = s <= np.partition(s, limit - 1)[limit - 1]
            idx, s = idx[keep], s[keep]
        idx = idx[np.argsort(s, kind="stable")]
    return [[c[col][i] if c[col].dtype == object else c[col][i].item() for col in select]
            for i in idx[:limit]]


def oracle_group_trim(c):
    sums = np.bincount(c["lo_custkey"], weights=c["lo_revenue"])
    keys = np.flatnonzero(np.bincount(c["lo_custkey"]))
    top = keys[np.argsort(-sums[keys], kind="stable")[:10]]
    return [[int(k), float(sums[k])] for k in top]


def select_oracles(c) -> dict:
    everything = np.ones(len(c["lo_quantity"]), dtype=bool)
    return {
        "topk_desc": oracle_rows(c, c["lo_quantity"] >= 10, ["lo_custkey", "lo_revenue"],
                                 "lo_revenue", True, 7),
        "topk_all": oracle_rows(c, everything, ["lo_suppkey", "lo_extendedprice"],
                                "lo_extendedprice", False, 12),
        "topk_ties": oracle_rows(c, c["lo_quantity"] >= 10,
                                 ["lo_custkey", "lo_orderdate", "lo_revenue"],
                                 "lo_suppkey", False, 9),
        "select_limit": oracle_rows(c, c["lo_quantity"] < 3, ["lo_region", "lo_revenue"]),
        "order_exact": oracle_rows(c, (c["lo_quantity"] == 1) & (c["lo_discount"] == 0),
                                   ["lo_custkey", "lo_orderdate"], "lo_orderdate", True, 5),
        "group_trim": oracle_group_trim(c),
    }


def run_select(args, table, cols) -> dict:
    """Selections and top-k over the path's table: both entry points, the
    pipeline's `topk` mix, and the stacked top-k timed alone. Returns the
    kernels' launches in the checked runs: no scan; a bitmap_filter launch for
    each mask that reads bitmap leaves (each segment's, or the stacked top-k's
    one over the set); a grouped_agg launch for each pass of the GROUP BY."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.parallel import MeshQueryExecutor

    rows = sum(s.num_docs for s in table)
    mx = MeshQueryExecutor()
    t0 = time.perf_counter()
    oracles = select_oracles(cols)
    log("select_oracle", seconds=time.perf_counter() - t0)
    launches = counts_of()
    trim_table = table[:GROUP_TRIM_PER_SEGMENT_SEGMENTS]
    trim_want = oracle_group_trim({k: v[:sum(s.num_docs for s in trim_table)]
                                   for k, v in cols.items()})
    for qid, sql, topk_per_segment, exact, bitmap_per_mask, grouped_per_pass in SELECT_QUERIES:
        for path, segs in (("per_segment", trim_table if qid == "group_trim" else table),
                           ("set", table)):
            want = trim_want if (qid, path) == ("group_trim", "per_segment") else oracles[qid]
            run = ((lambda sql=sql, segs=segs: execute_query(segs, sql)) if path == "per_segment"
                   else (lambda sql=sql: mx.execute(table, sql)))
            masks = len(segs) if path == "per_segment" or not topk_per_segment else 1
            passes = len(segs) if path == "per_segment" else 1
            expect = counts_of(bitmap_filter=bitmap_per_mask * masks,
                               grouped_agg=grouped_per_pass * passes)
            # the path: counts set to 0 just before, read just after
            reset_launch_counts()
            kernels.reset_topk_launches()
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            topk_launches, scans = kernels.topk_launches(), launch_counts()
            if not rows_match(result.rows, want):
                raise AssertionError(f"select {qid} ({path}): got {result.rows}, "
                                     f"oracle {want}")
            if topk_launches != topk_per_segment * len(table) or scans != expect:
                raise AssertionError(f"select {qid} ({path}): {topk_launches} top-k "
                                     f"launches, kernel launches {scans}, expected {expect}")
            for k, v in scans.items():
                launches[k] += v
            if result.stats.get("topkExact") != exact:
                raise AssertionError(f"select {qid} ({path}): topkExact "
                                     f"{result.stats.get('topkExact')}, expected {exact}")
            runs = (GROUP_TRIM_PER_SEGMENT_RUNS
                    if (qid, path) == ("group_trim", "per_segment") else SELECT_RUNS)
            warm, results = warm_times(run, runs=runs) if runs else ({}, [result])
            bad = [r.rows for r in results if not rows_match(r.rows, want)]
            if bad:
                raise AssertionError(f"select {qid} ({path}): warm answers {bad[:2]}")
            phases = [r.stats["phaseTimesMs"] for r in results]
            warm.pop("median_s", None)
            fields = dict(query=qid, path=path, rows=sum(s.num_docs for s in segs),
                          segments=len(segs),
                          answer=result.rows, topk_launches=topk_launches, launches=scans,
                          topk_exact=result.stats.get("topkExact"), cold_s=cold_s, **warm,
                          phase_median_ms={k: statistics.median(p[k] for p in phases)
                                           for k in phases[0]})
            if args.trace and runs == SELECT_RUNS:
                fields["trace"] = trace_query(run)
            log("select_query", **fields)

    # the pipeline: client threads cycling the three top-k queries
    topk_queries = [(sql, oracles[qid]) for qid, sql, *_ in SELECT_QUERIES
                    if qid.startswith("topk_")]
    serve_pipeline(mx, table, "topk", topk_queries)
    select_case(mx, table, cols)
    return launches


def select_case(mx, table, cols) -> None:
    """The stacked top-k of each top-k query over the whole table: its
    candidates against numpy's stable order, then the first query's program
    timed (L2 flushed, CUDA events), profiled, and held against its bound."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.query.context import compile_query

    prepared = {}
    for qid, sql, *_ in SELECT_QUERIES:
        if not qid.startswith("topk_"):
            continue
        p = prepared[qid] = mx.prepare_partial(compile_query(sql, table[0].schema), table)
        if p.kind != "topk":
            raise AssertionError(f"select_case {qid}: prepared {p.kind}, not topk")
        order_expr, desc, kk = p.topk
        outs = kernels.topk(p.spec, p.inputs, order_expr, desc, kk)
        got = outs["idx"].cpu().numpy()
        # numpy's stable order of the same f32 scores over the block's mask
        mask = kernels.filter_mask(p.spec, p.inputs).cpu().numpy()
        v = p.inputs.vals[order_expr.name].cpu().numpy().astype(np.float32)
        score = np.where(mask, v if desc else -v, -np.inf).astype(np.float32)
        want = np.argsort(-score.astype(np.float64), kind="stable")[:kk]
        if not np.array_equal(got, want):
            raise AssertionError(f"select_case {qid}: the card's candidates differ from "
                                 f"numpy's stable order at {np.flatnonzero(got != want)[:5]}")
    qid = "topk_desc"
    p = prepared[qid]
    kk = p.topk[2]
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def call():
        return kernels.topk(p.spec, p.inputs, *p.topk)

    ms = time_ms(call, flush)
    ops, wall = _profiled(call, PROFILED_CALLS)
    busy_ms = sum(b - a for _, a, b in ops) / 1e3 / PROFILED_CALLS
    by_name = {}
    for name, a, b in ops:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3 / PROFILED_CALLS
    n = p.inputs.valid.numel()
    read = [*p.inputs.ids.values(), p.inputs.vals[p.topk[0].name], p.inputs.valid]
    nbytes = sum(t.numel() * t.element_size() for t in read) + kk * (8 + 1) + 8
    # per row: two band compares and their AND, the valid AND, isnan, its
    # complement and AND, the sign and the select: ~9 f32-rate operations
    bound_ms, bound_by = roofline(nbytes, n * 9)
    log("select_case", query=qid, program="kernels.topk (plain torch: filter_mask, "
        "torch.where, torch.topk over tie-broken int64 keys)",
        replaces="pinot_tpu/engine/kernels.py:1123 (topk_kernel)", rows=n, candidates=kk,
        ms=ms, device_busy_ms=busy_ms, device_ops_per_call=len(ops) / PROFILED_CALLS,
        profiled_wall_ms=wall * 1e3 / PROFILED_CALLS,
        launches_per_query={"per_segment": len(table), "stacked": 1},
        bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
        pct_of_bound=100.0 * bound_ms / ms,
        pct_of_bound_device_busy=100.0 * bound_ms / busy_ms if busy_ms else None,
        top_device_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))


# -- phase 7: join -------------------------------------------------------------------

def join_oracles(c, supplier, customer) -> dict:
    """numpy float64 answers of `ssb.JOIN_QUERIES` over the generated columns.
    Each dimension table's key is its row number, so a join is a gather."""
    from pinot_tpu_torch.ssb import REGIONS
    rev = c["lo_revenue"]

    def codes(values):
        names = sorted(set(values.tolist()))
        lookup = {v: i for i, v in enumerate(names)}
        return np.array([lookup[v] for v in values], dtype=np.int64), names

    def grouped(keys, sel, names, with_count):
        sums = np.bincount(keys[sel], weights=rev[sel], minlength=len(names))
        counts = np.bincount(keys[sel], minlength=len(names))
        return [[name, float(sums[i])] + ([int(counts[i])] if with_count else [])
                for i, name in enumerate(names) if counts[i]][:25]

    sk, ck = c["lo_suppkey"].astype(np.int64), c["lo_custkey"].astype(np.int64)
    year_1993 = (c["lo_orderdate"] >= 19930101) & (c["lo_orderdate"] <= 19931231)
    out = {}

    s_nation, s_names = codes(supplier["s_nation"])
    sel = ((c["lo_discount"] >= 1) & (c["lo_discount"] <= 3)
           & (supplier["s_region"] == "AMERICA")[sk])
    out["join_supplier"] = grouped(s_nation[sk], sel, s_names, True)

    c_nation, c_names = codes(customer["c_nation"])
    wanted = np.isin(customer["c_mktsegment"], ["BUILDING", "MACHINERY"])
    inside = ck < len(wanted)
    sel = year_1993 & inside
    sel[sel] = wanted[ck[sel]]
    out["join_customer"] = grouped(np.where(inside, c_nation[np.minimum(ck, len(wanted) - 1)],
                                            0), sel, c_names, False)

    sel = np.flatnonzero(year_1993 & (c["lo_quantity"] < 25))
    rows = []
    for key, name in enumerate(REGIONS):
        g = sel[c["lo_region"][sel] == name]
        if len(g):
            rows.append([key, len(g), float(rev[g].sum())])
    out["join_region"] = rows

    sel = (c["lo_quantity"] < 25) & (supplier["s_nation"] == "JAPAN")[sk]
    out["semi_in"] = [[int(sel.sum()), float(rev[sel].sum())]]
    return out


def join_tables(args, table, work) -> tuple:
    """The dimension tables built as segments with the package's writer, with
    the lineorder table: (tables, schemas, dimension columns)."""
    from pinot_tpu_torch import segments_from_columns
    from pinot_tpu_torch import ssb

    t0 = time.perf_counter()
    dims = {"supplier": (ssb.supplier_schema(), ssb.make_supplier(seed=args.seed)),
            "customer": (ssb.customer_schema(), ssb.make_customer(seed=args.seed)),
            "region": (ssb.region_schema(), ssb.make_region())}
    tables, schemas = {"lineorder": table}, {"lineorder": table[0].schema}
    for name, (schema, cols) in dims.items():
        tables[name] = segments_from_columns(schema, cols, os.path.join(work, name), 1)
        schemas[name] = schema
    log("join_data", seconds=time.perf_counter() - t0,
        rows={k: sum(s.num_docs for s in v) for k, v in tables.items()})
    return tables, schemas, {k: v[1] for k, v in dims.items()}


# phase 7's dimension tables and oracles, which phases 17 and 19 push into
# their clusters (built once, on first use)
JOIN_DATA: dict = {}


def join_data(args, table, cols, work) -> dict:
    """{"tables", "schemas", "dims", "oracles"}: `join_tables` and
    `join_oracles`, once."""
    if not JOIN_DATA:
        tables, schemas, dims = join_tables(args, table, work)
        t0 = time.perf_counter()
        JOIN_DATA.update(tables=tables, schemas=schemas, dims=dims,
                         oracles=join_oracles(cols, dims["supplier"], dims["customer"]))
        log("join_oracle", seconds=time.perf_counter() - t0)
    return JOIN_DATA


def regime_of(launches: dict, joins: int) -> str:
    """The regime a query's `joins` partitioned join stages ran: "scatter" or
    "sort" when every partition's build and probe took it on the device (one
    launch of each program per partition and stage), else "mixed" or "none"
    (a partition under the rows floor joins on the host and launches none)."""
    from pinot_tpu_torch.multistage.runtime import DEFAULT_PARTITIONS

    want = DEFAULT_PARTITIONS * joins
    scatter = launches["scatter_build"] + launches["scatter_probe"]
    sort = launches["sort_build"] + launches["sorted_probe"]
    if launches["scatter_build"] == launches["scatter_probe"] == want and not sort:
        return "scatter"
    if launches["sort_build"] == launches["sorted_probe"] == want and not scatter:
        return "sort"
    return "mixed" if scatter or sort else "none"


def run_join(args, table, cols, work) -> dict:
    """The join queries through execute_multistage on the card, then the device
    programs alone (`join_case`). Returns the kernels' launches in the checked
    join runs: no scan, and JOIN_BITMAP's bitmap_filter launches."""
    from pinot_tpu_torch.engine import join_kernels as jk
    from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
    from pinot_tpu_torch.ssb import JOIN_QUERIES

    jd = join_data(args, table, cols, work)
    tables, schemas, oracles = jd["tables"], jd["schemas"], jd["oracles"]
    scan_fn = make_segment_scan(tables)
    rows = sum(s.num_docs for s in table)
    seen = set()
    checked_launches = counts_of()
    for qid, sql in JOIN_QUERIES.items():
        def run(sql=sql):
            return execute_multistage(sql, scan_fn, schemas.get)
        # the path: counts set to 0 just before, read just after
        reset_launch_counts()
        jk.reset_launch_counts()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches, scans = jk.launch_counts(), launch_counts()
        per_segment, dimension = JOIN_BITMAP[qid]
        want_scans = counts_of(bitmap_filter=per_segment * len(table) + dimension)
        if scans != want_scans:
            raise AssertionError(f"join {qid}: kernel launches {scans}, expected {want_scans}")
        for k, v in scans.items():
            checked_launches[k] += v
        if not rows_match(result.rows, oracles[qid], JOIN_RTOL, JOIN_ATOL):
            raise AssertionError(f"join {qid}: got {result.rows}, oracle {oracles[qid]}")
        stats = result.stats
        strategy = stats.get("joinStrategy", "")
        regime = regime_of(launches, len(strategy.split(",")))
        if "joinBuildMs" not in stats or "joinProbeMs" not in stats \
                or "joinServedHostTier" in stats:
            raise AssertionError(f"join {qid} did not run the device build and probe: {stats}")
        if (regime, strategy) != JOIN_EXPECT[qid]:
            raise AssertionError(f"join {qid}: regime {regime} ({launches}), exchange "
                                 f"{strategy}; expected {JOIN_EXPECT[qid]}")
        seen.update((regime, strategy))
        warm, results = warm_times(run, runs=JOIN_WARM_RUNS)
        bad = [r.rows for r in results
               if not rows_match(r.rows, oracles[qid], JOIN_RTOL, JOIN_ATOL)]
        if bad:
            raise AssertionError(f"join {qid}: warm answers {bad[:2]}")
        warm.pop("median_s")
        phases = [dict(r.stats["phaseTimesMs"], build=r.stats["joinBuildMs"],
                       probe=r.stats["joinProbeMs"]) for r in results]
        # a partitioned exchange whose every probe bucket is hot (skew 100%)
        # salts every probe row and copies the whole build side to each
        # partition: no row would move by its hash
        if strategy == "partitioned" and stats.get("joinSkewPct", 0) >= 100:
            raise AssertionError(f"join {qid}: the partitioned exchange found every "
                                 f"bucket hot (joinSkewPct {stats['joinSkewPct']})")
        fields = dict(query=qid, lineorder_rows=rows, answer=result.rows,
                      join_strategy=strategy, regime=regime, launches=launches,
                      kernel_launches=scans,
                      exchange=strategy,
                      joined_rows=stats["numDocsScanned"],
                      join_skew_pct=stats.get("joinSkewPct"),
                      join_shuffle_bytes=stats.get("joinShuffleBytes"),
                      cold_s=cold_s, cold_build_ms=stats["joinBuildMs"],
                      cold_probe_ms=stats["joinProbeMs"], **warm,
                      # build and probe: joinBuildMs and joinProbeMs, host wall
                      # summed over the partitions (inside `join`)
                      phase_median_ms={k: statistics.median(p[k] for p in phases)
                                       for k in phases[0]})
        if args.trace:
            fields["trace"] = trace_query(run, runs=JOIN_WARM_RUNS)
        log("join_query", **fields)
    if not {"scatter", "sort", "broadcast", "partitioned"} <= seen:
        raise AssertionError(f"the join queries covered only {sorted(seen)}")
    join_cases(args.seed)
    return checked_launches


def _zipf_keys(rng, n: int, card: int, s) -> np.ndarray:
    """bench.py's `_zipf_probe`: keys in [0, card), uniform when `s` is None,
    else drawn from a zipf(s) rank distribution."""
    if s is None:
        return rng.integers(0, card, n).astype(np.int64)
    p = np.arange(1, card + 1, dtype=np.float64) ** (-float(s))
    p /= p.sum()
    return rng.choice(card, size=n, p=p).astype(np.int64)


def join_cases(seed: int) -> None:
    """The four device programs alone at bench.py's join shapes, on the card:
    each output against numpy (exactly), each timed with L2 flushed against
    the bound of the bytes it must move (inputs read once, outputs written
    once) and of its compares at the f32 rate, and profiled: the device busy
    ms and ops of one call."""
    from pinot_tpu_torch.engine import join_kernels as jk
    from pinot_tpu_torch.multistage.runtime import stable_hash_codes

    rng = np.random.default_rng([seed, 17])
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda")
    shapes = [(card, None) for card in JOIN_BUILD_KEYS] + [(JOIN_ZIPF_KEYS, JOIN_ZIPF_S)]
    for card, zipf in shapes:
        m, n = card, JOIN_PROBE_ROWS
        lk = _zipf_keys(rng, n, card, zipf)
        bcodes = jk.fold_codes32(stable_hash_codes({"k": np.arange(card)}, ["k"]))
        pcodes = jk.fold_codes32(stable_hash_codes({"k": lk}, ["k"]))
        shape = dict(build_keys=m, probe_rows=n, probe="zipf-1.5" if zipf else "uniform")

        # sort-merge: numpy's stable order of the same order-preserving int32 codes
        b_dev, p_dev = jk.device_codes(bcodes, dev), jk.device_codes(pcodes, dev)
        srt, order = jk.sort_build_program(b_dev)
        lo, cnt, hist = jk.sorted_probe_program(srt, p_dev)
        b_np = bcodes.astype(np.int64)
        want_order = np.argsort(b_np, kind="stable")
        s_np = b_np[want_order]
        p_np = pcodes.astype(np.int64)
        want_lo = np.searchsorted(s_np, p_np, "left")
        want_cnt = np.searchsorted(s_np, p_np, "right") - want_lo
        want_hist = np.bincount(p_np & 255, minlength=256)
        checks = {"order": (order, want_order), "lo": (lo, want_lo), "cnt": (cnt, want_cnt),
                  "hist": (hist, want_hist)}
        skew = {"sort": jk.skew_pct_from_hist(hist.cpu().numpy())}
        cases = [("sort_build", lambda: jk.sort_build_program(b_dev),
                  *roofline(m * (4 + 4 + 8), m * max(1.0, math.log2(m)))),
                 ("sorted_probe", lambda: jk.sorted_probe_program(srt, p_dev),
                  *roofline(n * (4 + 8 + 8) + m * 4 + 256 * 8, 2 * n * math.log2(m) + n))]

        if card <= jk.SCATTER_TABLE_CAP:
            bslots = np.arange(card, dtype=np.int32)
            pslots = lk.astype(np.int32)
            bs_dev = torch.from_numpy(bslots).to(dev)
            ps_dev = torch.from_numpy(pslots).to(dev)
            table, max_count = jk.scatter_build_program(bs_dev, card)
            cand, shist = jk.scatter_probe_program(table, ps_dev)
            want_table = np.full(card, -1, dtype=np.int64)
            want_table[bslots] = np.arange(card)
            checks.update({"max_count": (max_count.reshape(1), np.ones(1)),
                           "table": (table, want_table), "cand": (cand, want_table[pslots]),
                           "scatter_hist": (shist, np.bincount(pslots & 255, minlength=256))})
            skew["scatter"] = jk.skew_pct_from_hist(shist.cpu().numpy())
            cases += [("scatter_build", lambda: jk.scatter_build_program(bs_dev, card),
                       *roofline(m * 4 + card * 4 + 4, 2 * m)),
                      ("scatter_probe", lambda: jk.scatter_probe_program(table, ps_dev),
                       *roofline(n * 4 + card * 4 + n * 4 + 256 * 8, 4 * n))]
        torch.cuda.synchronize()
        for name, (got, want) in checks.items():
            got = got.cpu().numpy().astype(np.int64)
            if not np.array_equal(got, want.astype(np.int64)):
                raise AssertionError(f"join_case {shape}: {name} differs from numpy at "
                                     f"{np.flatnonzero(got != want)[:5]}")
        if zipf and not all(v > 0 for v in skew.values()):
            raise AssertionError(f"join_case {shape}: joinSkewPct {skew} on the zipf probe")
        for program, fn, bound_ms, bound_by in cases:
            ms = time_ms(fn, flush)
            ops, _ = _profiled(fn, PROFILED_CALLS)
            log("join_case", program=program, **shape, ms=ms,
                device_busy_ms=sum(b - a for _, a, b in ops) / 1e3 / PROFILED_CALLS,
                device_ops_per_call=len(ops) / PROFILED_CALLS, bound_ms=bound_ms,
                bound_by=bound_by, pct_of_bound=100.0 * bound_ms / ms,
                skew_pct=skew["scatter" if program.startswith("scatter") else "sort"],
                outputs_equal_numpy=sorted(checks))


# -- phase 8: realtime ---------------------------------------------------------------

def oracle_region_sum(c, col: str, region: str = "ASIA"):
    m = c["lo_region"] == region
    return [[float(c[col][m].astype(np.float64).sum()), int(m.sum())]]


def oracle_custkey(c):
    m = c["lo_custkey"] < 250000
    return [[float(c["lo_revenue"][m].sum()), int(m.sum())]]


def add_rows(a, b):
    """One query's oracle answers over two disjoint row sets, added: grouped
    rows (a string key, then sums and counts) key by key, scalar rows cell by
    cell."""
    if any(isinstance(r[0], str) for r in a + b):
        groups = {}
        for r in a + b:
            g = groups.setdefault(r[0], [r[0]] + [0] * (len(r) - 1))
            for j in range(1, len(r)):
                g[j] += r[j]
        return [groups[k] for k in sorted(groups)][:10]
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(a, b)]


def realtime_queries():
    """(id, sql, numpy oracle, kernel launches of one run over a view, over
    the mixed set). On the consuming view lo_orderdate, lo_discount and
    lo_quantity are raw, so Q1.1 and the GROUP BY compare values and run the
    body (the GROUP BY one grouped_agg launch); the two `lo_region = 'ASIA'` sums take the scans: a raw f32
    row through `masked_sums`, a raw integer column in FOR form through
    `masked_sums_fused`. Over the mixed set every member is decoded on the
    host, so the f32 sum is one `masked_sums` launch in global-id space and
    the FOR sum is not run there."""
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY
    return [
        ("q1_1", QUERY, oracle_q11, counts_of(), counts_of()),
        ("group_by", GROUP_QUERY, oracle_group, counts_of(grouped_agg=1),
         counts_of(grouped_agg=1)),
        ("scan_f32", REALTIME_F32_QUERY, lambda c: oracle_region_sum(c, "lo_revenue"),
         counts_of(masked_sums=1), counts_of(masked_sums=1)),
        ("scan_for", REALTIME_FOR_QUERY, lambda c: oracle_region_sum(c, "lo_quantity"),
         counts_of(masked_sums_fused=1), None),
    ]


def run_realtime(args, table, cols, work) -> tuple:
    """A consuming segment fed from a PCB1 block stream, queried after every
    pump step on the card, alone and beside the table; then committed and
    queried as the ninth immutable segment. Returns the kernels' launches in
    the checked runs and each kernel's `realtime_case` numbers."""
    from pinot_tpu_torch import execute_query, load_segment
    from pinot_tpu_torch.engine import datablock
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.parallel import MeshQueryExecutor, aligned_dictionaries
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.ssb import QUERY, make_columns, ssb_schema
    from pinot_tpu_torch.table import StreamConfig, TableConfig

    n_rt = segment_rows(args.rows, SEGMENTS)   # one committed segment of the table
    schema = ssb_schema()
    t0 = time.perf_counter()
    rt = make_columns(n_rt, args.seed + 1)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = [encode_columnar_block(schema, {c: v[lo:lo + REALTIME_BLOCK_ROWS]
                                             for c, v in rt.items()})
              for lo in range(0, n_rt, REALTIME_BLOCK_ROWS)]
    encode_s = time.perf_counter() - t0
    MemoryStream.reset_all()
    stream = MemoryStream.create("lineorder_rt", 1)
    for blob in blocks:
        stream.produce(blob, partition=0)
    cfg = TableConfig("lineorder", stream=StreamConfig(
        topic="lineorder_rt", decoder="columnar",
        properties={"realtime.ingest.device.staging": "true"}, flush_threshold_rows=n_rt))
    consumer = RealtimePartitionConsumer("lineorder__0__0__20261017T0000Z", cfg, schema, 0,
                                         work)
    store = consumer.mutable
    staging_s = [0.0]
    stage_chunk = store._stage_chunk

    def timed_stage(*a):   # the staging copies, timed apart inside each pump
        t = time.perf_counter()
        stage_chunk(*a)
        staging_s[0] += time.perf_counter() - t
    store._stage_chunk = timed_stage
    log("realtime_data", rows=n_rt, seed=args.seed + 1, blocks=len(blocks),
        block_rows=REALTIME_BLOCK_ROWS, step_blocks=REALTIME_STEP_BLOCKS,
        block_bytes=sum(len(b) for b in blocks), flush_threshold_rows=n_rt,
        generate_s=gen_s, encode_s=encode_s)

    queries = realtime_queries()
    table_want = {qid: oracle(cols) for qid, _, oracle, _, mixed in queries if mixed}
    mx = MeshQueryExecutor()
    launches = counts_of()

    def checked(label, run, want, want_launches):
        """One cold run with the counts set to 0 just before and read just
        after, held against the oracle; then REALTIME_WARM_RUNS warm runs."""
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if counts != want_launches:
            raise AssertionError(f"{label}: kernel launches {counts}, expected {want_launches}")
        for k, v in counts.items():
            launches[k] += v
        if not rows_match(res.rows, want):
            raise AssertionError(f"{label}: got {res.rows}, oracle {want}")
        warm, results = warm_times(run, runs=REALTIME_WARM_RUNS)
        bad = [r.rows for r in results if not rows_match(r.rows, want)]
        if bad:
            raise AssertionError(f"{label}: warm answers {bad[:2]}, oracle {want}")
        warm.pop("median_s")
        return dict(answer=res.rows, cold_ms=cold_ms, **warm, launches=counts,
                    phase_ms=res.stats["phaseTimesMs"],
                    warm_phase_median_ms={k: statistics.median(r.stats["phaseTimesMs"][k]
                                                               for r in results)
                                          for k in res.stats["phaseTimesMs"]})

    acked, step = 0, 0
    while not consumer.end_criteria_reached():
        staging_s[0] = 0.0
        t0 = time.perf_counter()
        got = consumer.pump(max_messages=REALTIME_STEP_BLOCKS)
        torch.cuda.synchronize()
        pump_s = time.perf_counter() - t0
        if got == 0:
            raise AssertionError(f"the pump indexed nothing at {acked} of {n_rt} rows")
        acked += got
        part = {c: v[:acked] for c, v in rt.items()}
        t0 = time.perf_counter()
        view = consumer.query_segment()
        torch.cuda.synchronize()
        attach_ms = (time.perf_counter() - t0) * 1e3
        if view.num_docs != acked or store.num_docs != acked:
            raise AssertionError(f"the view holds {view.num_docs} rows, the store "
                                 f"{store.num_docs}; the pump acknowledged {acked}")
        fields = {"view": {}, "mixed": {}}
        for qid, sql, oracle, on_view, on_mixed in queries:
            want = oracle(part)
            fields["view"][qid] = checked(f"realtime view {qid} at {acked} rows",
                                          lambda sql=sql: execute_query([view], sql),
                                          want, on_view)
            if on_mixed is not None:
                members = table + [view]
                fields["mixed"][qid] = checked(
                    f"realtime mixed {qid} at {acked} rows",
                    lambda sql=sql: mx.execute(members, sql),
                    add_rows(table_want[qid], want), on_mixed)
        _, merged = mx._plan_for_set(compile_query(REALTIME_F32_QUERY, schema),
                                     table + [view])
        if merged is None:
            raise AssertionError("the mixed set did not take the merged view")
        if args.trace and consumer.end_criteria_reached():
            fields["view"]["scan_f32"]["trace"] = trace_query(
                lambda: execute_query([view], REALTIME_F32_QUERY))
            fields["mixed"]["scan_f32"]["trace"] = trace_query(
                lambda: mx.execute(table + [view], REALTIME_F32_QUERY))
        staged = [t for chunks in store._dev_chunks.values() if chunks for t in chunks]
        blk = view._device_blocks[datablock.device_key(store.device)]
        log("realtime_step", step=step, rows=acked, pumped_rows=got, pump_ms=pump_s * 1e3,
            rows_per_s=got / pump_s, staging_ms=staging_s[0] * 1e3, attach_ms=attach_ms,
            staged_device_bytes=sum(t.numel() * t.element_size() for t in staged),
            view_block_bytes=sum(t.numel() * t.element_size() for t in blk._raw.values()),
            staged_columns=sorted(blk._raw), unstaged_columns=sorted(
                c for c, chunks in store._dev_chunks.items() if chunks is None),
            **fields)
        step += 1

    # commit: the consuming segment written and loaded as the ninth segment
    t0 = time.perf_counter()
    committed = load_segment(consumer.build_immutable())
    build_s = time.perf_counter() - t0
    nine = table + [committed]
    # Q1.1's filtered columns hold every value in each segment, so their
    # dictionaries agree and the nine stay aligned for it (one scan over the
    # stacked set); lo_custkey's do not (its 500,000 keys are not all in one
    # segment): that query takes the merged view, and its id band the scan
    # where lo_custkey is dictionary-encoded in all nine (a compare on the
    # decoded values, the plain body, where one of them holds it raw)
    custkey_dicts = all(s.column("lo_custkey").has_dictionary for s in nine)
    for qid, sql, oracle in (
            ("q1_1", QUERY, oracle_q11),
            ("custkey", REALTIME_CUSTKEY_QUERY, oracle_custkey)):
        want = add_rows(oracle(cols), oracle(rt))
        _, merged = mx._plan_for_set(compile_query(sql, schema), nine)
        want_merged = qid == "custkey" and not aligned_dictionaries(nine, ["lo_custkey"])
        if (merged is not None) != want_merged:
            raise AssertionError(f"realtime committed {qid}: merged view {merged}, "
                                 f"expected one: {want_merged}")
        line = checked(f"realtime committed {qid}", lambda sql=sql: mx.execute(nine, sql),
                       want, counts_of(masked_sums=int(qid == "q1_1" or custkey_dicts)))
        log("realtime_commit", query=qid, rows=committed.num_docs, build_s=build_s,
            segments=len(nine), merged_view=merged is not None, oracle=want, **line)
    cases = realtime_cases(view)
    store.release_device()
    return launches, cases


def scan_case(name: str, args, flush: torch.Tensor) -> dict:
    """One scan kernel on `args` against its plain version (sums at rel 1e-5,
    counts equal), timed with L2 flushed (graph replay and eager call),
    against the bound of the bytes it reads. Raises on a disagreement."""
    from pinot_tpu_torch.engine import scan

    kernel, plain = {"masked_sums": (scan.masked_sums, scan.masked_sums_plain),
                     "masked_sums_fused": (scan.masked_sums_fused,
                                           scan.masked_sums_fused_plain)}[name]
    ks, kc = kernel(*args)
    ps, pc = plain(*args)
    torch.cuda.synchronize()
    ks, ps = ks.double().cpu(), ps.double().cpu()
    abs_err = float((ks - ps).abs().max())
    rel_err = 0.0 if abs_err == 0.0 else float(((ks - ps).abs() / ps.abs()).max())
    if int(kc) != int(pc) or rel_err > SUM_RTOL:
        raise AssertionError(f"{name}: kernel {ks.tolist()} count {int(kc)} "
                             f"vs plain {ps.tolist()} count {int(pc)}")
    bms, by = bound(name, args)
    numbers = dict(rows=int(args[0][0].shape[0]), count=int(kc), max_abs_err=abs_err,
                   max_rel_err=rel_err, ms=graph_ms(lambda: kernel(*args), flush),
                   plain_ms=graph_ms(lambda: plain(*args), flush),
                   call_ms=time_ms(lambda: kernel(*args), flush),
                   plain_call_ms=time_ms(lambda: plain(*args), flush),
                   bound_ms=bms, bound_by=by, library_ms=None)
    numbers["pct_of_bound"] = 100.0 * bms / numbers["ms"]
    return numbers


def realtime_cases(view) -> dict:
    """Each scan kernel over the consuming view's block at its full size,
    against its plain version (`scan_case`)."""
    from pinot_tpu_torch.engine import datablock

    block = datablock.block_for(view, torch.device("cuda"))
    n = view.num_docs
    asia = view.column("lo_region").dictionary.index_of("ASIA")
    ids = [block.ids("lo_region")[:n]]
    base, deltas = block.for_form("lo_quantity")
    cases = {"masked_sums": (ids, [(asia, asia)], [block.raw("lo_revenue")[:n]]),
             "masked_sums_fused": (ids, [(asia, asia)], [(float(base), deltas[:n])])}
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for name, args in cases.items():
        numbers = scan_case(name, args, flush)
        log("realtime_case", kernel=name, shape="consuming view, lo_region = 'ASIA'",
            **numbers)
        out[name] = numbers
    return out


# -- phase 9: expr ---------------------------------------------------------------------

# device function families: each expression is evaluated with eval_device on the
# card and eval_host in float64/int64 over the same (32-bit) column values
EXPR_FAMILIES = [
    ("arithmetic", ["lo_quantity * lo_discount + lo_orderdate % 97 - lo_quantity",
                    "lo_extendedprice * lo_discount + lo_revenue / 7"]),
    ("case", ["CASE WHEN lo_discount BETWEEN 1 AND 3 THEN lo_extendedprice * lo_discount "
              "WHEN lo_quantity > 40 THEN lo_revenue ELSE 0 END",
              "CASE WHEN lo_quantity < 10 THEN 1 WHEN lo_quantity < 30 THEN 2 ELSE 3 END"]),
    ("compare_logic", ["(lo_quantity < 25 AND lo_discount IN (1, 3, 5)) "
                       "OR NOT lo_extendedprice > 5000.5",
                       "lo_orderdate BETWEEN 19930101 AND 19931231 "
                       "AND lo_discount NOT IN (0, 10)",
                       "lo_revenue >= lo_extendedprice"]),
    ("math", ["sqrt(lo_revenue) + ln(lo_quantity) * power(lo_discount, 2) "
              "+ floor(lo_extendedprice / 100) + abs(lo_discount - 5)",
              "sign(lo_discount - 5) * greatest(lo_quantity, lo_discount) "
              "+ least(lo_quantity, 20) + ceil(lo_quantity / 7)"]),
    ("trig", ["sin(lo_discount / 10) + cos(lo_quantity) * atan2(lo_revenue, lo_extendedprice) "
              "+ tanh(lo_quantity / 50.0)",
              "exp(lo_discount / 10) - radians(lo_quantity) + sinh(lo_discount / 20)"]),
    # lo_orderdate read as epoch milliseconds: an int32 column, within the
    # planner's guard (x 100 stays below 2^31)
    ("datetime", ["hour(lo_orderdate) * 10000000 + minute(lo_orderdate) * 100000 "
                  "+ second(lo_orderdate) * 1000 + millisecond(lo_orderdate)",
                  "toepochseconds(lo_orderdate * 100) + dayofmonth(lo_orderdate * 100) * 7 "
                  "+ week(lo_orderdate * 100) + dayofweek(lo_orderdate * 100) "
                  "+ toepochhoursbucket(lo_orderdate * 100, 6)"]),
]
EXPR_RTOL = 1e-5                       # f32 results against the f64 oracle
EXPR_TRIG_ATOL = 1e-6                  # trig and exp: rel 1e-5 with abs 1e-6
EXPR_DEVICE_RUNS = 5
EXPR_QUERY_RUNS = 5    # warm runs of a device-routed query (cut from 10 for the search phase)
EXPR_HOST_RUNS = 0                     # warm runs of a host-routed query (its cold run
                                       # alone: seconds a run, host-bound)
EXPR_HOST_SEGMENTS = 2                 # the host-routed queries' segments of the table (cut
                                       # from 8 for the cluster phase: 4,194,304 rows)
EXPR_CONSUMING_ROWS = 2_097_152        # rows pumped into the consumer without staging
EXPR_CASE_SUM = ("SELECT SUM(CASE WHEN lo_discount BETWEEN 1 AND 3 THEN lo_extendedprice "
                 "* lo_discount ELSE 0 END), COUNT(*) FROM lineorder WHERE lo_quantity < 25")
EXPR_MATH_FILTER = ("SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                    "WHERE floor(lo_extendedprice / 100) > 50 AND mod(lo_orderdate, 100) = 15")
EXPR_GROUP_MATH = ("SELECT lo_region, AVG(power(lo_discount, 2)), "
                   "MAX(abs(lo_revenue - lo_extendedprice)) FROM lineorder "
                   "GROUP BY lo_region ORDER BY lo_region")
EXPR_GROUP_EXPR = ("SELECT lo_orderdate / 10000, COUNT(*), SUM(lo_revenue) FROM lineorder "
                   "GROUP BY lo_orderdate / 10000 ORDER BY 1 LIMIT 100")
EXPR_STRING = ("SELECT substr(lo_region, 0, 2), COUNT(*), SUM(lo_quantity) FROM lineorder "
               "WHERE length(lo_region) > 4 GROUP BY substr(lo_region, 0, 2) ORDER BY 1")
EXPR_HOST_SELECT = ("SELECT lo_region, lo_revenue FROM lineorder WHERE length(lo_region) = 4 "
                    "AND lo_quantity < 3 ORDER BY lo_revenue DESC LIMIT 10")
EXPR_HOST_JOIN = ("SELECT s.s_nation, SUM(l.lo_revenue), COUNT(*) FROM lineorder l "
                  "JOIN supplier s ON l.lo_suppkey = s.s_suppkey "
                  "WHERE strpos(s.s_city, 'A') = 0 AND l.lo_discount BETWEEN 1 AND 3 "
                  "GROUP BY s.s_nation ORDER BY s.s_nation LIMIT 25")


def oracle_case_sum(c):
    m = c["lo_quantity"] < 25
    d = c["lo_discount"]
    v = np.where((d >= 1) & (d <= 3), c["lo_extendedprice"] * d, 0.0)
    return [[float(v[m].sum()), int(m.sum())]]


def oracle_math_filter(c):
    m = (np.floor(c["lo_extendedprice"] / 100) > 50) & (c["lo_orderdate"] % 100 == 15)
    return [[int(m.sum()), float(c["lo_revenue"][m].sum())]]


def oracle_group_math(c):
    from pinot_tpu_torch.ssb import REGIONS
    d2 = c["lo_discount"].astype(np.float64) ** 2
    gap = np.abs(c["lo_revenue"] - c["lo_extendedprice"])
    return [[r, float(d2[g].mean()), float(gap[g].max())]
            for r in sorted(REGIONS) for g in [c["lo_region"] == r] if g.any()]


def oracle_group_expr(c):
    keys, inv = np.unique(c["lo_orderdate"] / 10000, return_inverse=True)
    counts = np.bincount(inv)
    sums = np.bincount(inv, weights=c["lo_revenue"])
    return [[float(keys[i]), int(counts[i]), float(sums[i])] for i in range(min(100, len(keys)))]


def oracle_string(c):
    from pinot_tpu_torch.ssb import REGIONS
    rows = {}
    for r in REGIONS:
        g = c["lo_region"] == r
        if len(r) > 4 and g.any():
            row = rows.setdefault(r[:2], [r[:2], 0, 0.0])
            row[1] += int(g.sum())
            row[2] += float(c["lo_quantity"][g].astype(np.float64).sum())
    return [rows[k] for k in sorted(rows)]


def oracle_host_select(c):
    from pinot_tpu_torch.ssb import REGIONS
    mask = c["lo_quantity"] < 3
    mask &= np.logical_or.reduce([c["lo_region"] == r for r in REGIONS if len(r) == 4])
    return oracle_rows(c, mask, ["lo_region", "lo_revenue"], "lo_revenue", True, 10)


def oracle_host_join(c, supplier):
    starts = np.array([city.find("A") == 0 for city in supplier["s_city"]])
    nation = np.asarray(supplier["s_nation"], dtype=object)
    sk = c["lo_suppkey"].astype(np.int64)
    sel = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3) & starts[sk]
    names = sorted(set(nation[starts].tolist()))
    lookup = {n: i for i, n in enumerate(names)}
    keys = np.array([lookup.get(n, 0) for n in nation], dtype=np.int64)[sk]
    sums = np.bincount(keys[sel], weights=c["lo_revenue"][sel], minlength=len(names))
    counts = np.bincount(keys[sel], minlength=len(names))
    return [[n, float(sums[i]), int(counts[i])] for i, n in enumerate(names) if counts[i]][:25]


def expr_device_families(cols) -> dict:
    """Each family's expressions through eval_device on the card and eval_host
    on the host over the same 32-bit column values; one `expr_device` line
    each, with each expression's call ms (host clock around the call and a
    synchronize, median of EXPR_DEVICE_RUNS). `max_rel_err` is taken over
    every row, those the absolute tolerance admits too (trig rows near 0).
    Returns {family: max relative error}."""
    from pinot_tpu_torch.engine.datablock import _narrow
    from pinot_tpu_torch.engine.expr import eval_device, eval_host
    from pinot_tpu_torch.sql.parser import Parser

    numeric = [c for c, v in cols.items() if v.dtype != object]
    dev32 = {c: _narrow(cols[c]) for c in numeric}
    host = {c: v.astype(np.float64 if v.dtype.kind == "f" else np.int64)
            for c, v in dev32.items()}
    dev = {c: torch.from_numpy(v).cuda() for c, v in dev32.items()}
    torch.cuda.synchronize()
    out = {}
    for family, exprs in EXPR_FAMILIES:
        atol = EXPR_TRIG_ATOL if family == "trig" else 0.0
        max_abs = max_rel = 0.0
        ms, dtypes = [], []
        for sql in exprs:
            e = Parser(sql).expression()
            got = eval_device(e, dev)
            torch.cuda.synchronize()
            if got.device != dev[numeric[0]].device or got.numel() != len(host[numeric[0]]):
                raise AssertionError(f"expr_device {family}: {sql} gave {got.shape} "
                                     f"on {got.device}")
            times = []
            for _ in range(EXPR_DEVICE_RUNS):
                t0 = time.perf_counter()
                eval_device(e, dev)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms.append(statistics.median(times))
            want = np.asarray(eval_host(e, host))
            g = got.cpu().numpy()
            dtypes.append(str(g.dtype))
            if g.dtype.kind in "biu":
                bad = int((g.astype(np.int64) != want.astype(np.int64)).sum())
                if bad:
                    raise AssertionError(f"expr_device {family}: {sql}: {bad} rows differ")
                continue
            err = np.abs(g.astype(np.float64) - want)
            rel = err / np.maximum(np.abs(want), np.finfo(np.float64).tiny)
            over = err > EXPR_RTOL * np.abs(want) + atol
            if over.any():
                i = int(np.argmax(over))
                raise AssertionError(f"expr_device {family}: {sql}: {int(over.sum())} rows "
                                     f"past rel {EXPR_RTOL} abs {atol}; row {i}: "
                                     f"{g[i]} vs {want[i]}")
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float(np.where(err > 0, rel, 0).max()))
        log("expr_device", family=family, expressions=exprs, rows=len(host[numeric[0]]),
            dtypes=dtypes, max_abs_err=max_abs, max_rel_err=max_rel, rtol=EXPR_RTOL,
            atol=atol, call_ms_median=ms, runs=EXPR_DEVICE_RUNS)
        out[family] = max_rel
    del dev
    torch.cuda.empty_cache()
    return out


def expr_case(seg, device: torch.device) -> dict:
    """`masked_sums` over one segment with the CASE sum's work: its id band
    (lo_quantity < 25) and the operand row `eval_device` builds from the CASE
    expression, against its plain version (`scan_case`)."""
    from pinot_tpu_torch.engine import datablock
    from pinot_tpu_torch.engine.expr import eval_device
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import plan_segment

    plan = plan_segment(compile_query(EXPR_CASE_SUM, seg.schema), seg)
    [leaf] = plan.filter_prog.leaves
    block = datablock.block_for(seg, device)
    n = seg.num_docs
    env = {c: block.values(c)[:n] for c in ("lo_discount", "lo_extendedprice")}
    row = eval_device(plan.aggs[0].arg, env).to(torch.float32).contiguous()
    args = ([block.ids(leaf.col)[:n]], [tuple(leaf.intervals[0])], [row])
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    numbers = scan_case("masked_sums", args, flush)
    log("expr_case", kernel="masked_sums",
        shape="one segment, lo_quantity < 25 band + the CASE operand row", **numbers)
    return numbers


def run_expr(args, table, cols, work) -> tuple:
    """Device expressions against the host evaluator; device- and host-routed
    queries per segment and over the set; a consuming segment without
    staging, alone and beside the table. Returns the scan kernels' launches of
    the checked runs by path, "expr" (device-routed queries and the mixed
    set) and "host" (host-routed queries: none expected), and the
    `expr_case` numbers."""
    from pinot_tpu_torch import execute_query, segments_from_columns, ssb
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.table import StreamConfig, TableConfig

    expr_device_families(cols)
    schema = table[0].schema
    rows = sum(s.num_docs for s in table)
    mx = MeshQueryExecutor()
    launches = {"expr": counts_of(), "host": counts_of()}
    none = counts_of()

    def checked(path, label, run, want, want_launches, runs, rtol=ORACLE_RTOL,
                atol=ORACLE_ATOL, trace=False):
        """One cold run with the counts set to 0 just before and read just
        after (the top-k launches too: a host route launches none), held
        against the oracle; then `runs` warm runs."""
        reset_launch_counts()
        kernels.reset_topk_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        topk = kernels.topk_launches()
        if counts != want_launches or (path == "host" and topk):
            raise AssertionError(f"{label}: kernel launches {counts}, top-k {topk}, "
                                 f"expected {want_launches}")
        for k, v in counts.items():
            launches[path][k] += v
        if not rows_match(res.rows, want, rtol, atol):
            raise AssertionError(f"{label}: got {res.rows[:12]}, oracle {want[:12]}")
        fields = dict(answer=res.rows[:12], answer_rows=len(res.rows), cold_ms=cold_ms,
                      launches=counts, topk_launches=topk,
                      cold_phase_ms=res.stats.get("phaseTimesMs"))
        if runs:
            warm, results = warm_times(run, runs=runs)
            bad = [r.rows[:4] for r in results if not rows_match(r.rows, want, rtol, atol)]
            if bad:
                raise AssertionError(f"{label}: warm answers {bad[:2]}, oracle {want[:4]}")
            warm.pop("median_s")
            fields.update(warm)
            fields["warm_phase_median_ms"] = {
                k: statistics.median(r.stats["phaseTimesMs"][k] for r in results)
                for k in res.stats["phaseTimesMs"]}
        if trace and args.trace:
            fields["trace"] = trace_query(run)
        return fields

    def kinds(sql, segs):
        ctx = compile_query(sql, schema)
        plans = [plan_segment(ctx, s) for s in segs]
        return sorted({p.kind for p in plans}), sorted({p.fallback_reason for p in plans})

    # device-routed queries: per segment and over the set
    device_queries = [
        ("case_sum", EXPR_CASE_SUM, oracle_case_sum, counts_of(masked_sums=len(table)),
         counts_of(masked_sums=1)),
        ("math_filter", EXPR_MATH_FILTER, oracle_math_filter, none, none),
        ("group_math", EXPR_GROUP_MATH, oracle_group_math,
         counts_of(grouped_agg=len(table)), counts_of(grouped_agg=1)),
    ]
    for qid, sql, oracle, seg_launches, set_launches in device_queries:
        want = oracle(cols)
        seg_kinds, _ = kinds(sql, table)
        set_plan, _ = mx._plan_for_set(compile_query(sql, schema), table)
        if seg_kinds != ["device"] or set_plan.kind != "device":
            raise AssertionError(f"expr {qid}: plans {seg_kinds} per segment, "
                                 f"{set_plan.kind} over the set; expected device")
        for path, run, want_launches in (
                ("per_segment", lambda sql=sql: execute_query(table, sql), seg_launches),
                ("set", lambda sql=sql: mx.execute(table, sql), set_launches)):
            line = checked("expr", f"expr {qid} {path}", run, want, want_launches,
                           EXPR_QUERY_RUNS, trace=True)
            log("expr_query", query=qid, path=path, plan_kind="device", rows=rows,
                segments=len(table), oracle=want[:12], **line)
    case = expr_case(table[0], mx.device)

    # host-routed queries
    sup_cols = ssb.make_supplier(seed=args.seed)
    supplier = segments_from_columns(ssb.supplier_schema(), sup_cols,
                                     os.path.join(work, "expr_supplier"), 1)
    tables = {"lineorder": table, "supplier": supplier}
    schemas = {"lineorder": schema, "supplier": ssb.supplier_schema()}
    scan_fn = make_segment_scan(tables)
    # the host-routed queries read the table's first EXPR_HOST_SEGMENTS segments
    host_table = table[:EXPR_HOST_SEGMENTS]
    host_rows = sum(s.num_docs for s in host_table)
    host_cols = {k: v[:host_rows] for k, v in cols.items()}
    host_queries = [
        ("group_expr", EXPR_GROUP_EXPR, oracle_group_expr(host_cols), "host"),
        ("string_fns", EXPR_STRING, oracle_string(host_cols), "host"),
        ("host_mask_select", EXPR_HOST_SELECT, oracle_host_select(host_cols), "selection"),
    ]
    for qid, sql, want, kind in host_queries:
        seg_kinds, reasons = kinds(sql, host_table)
        if seg_kinds != [kind] or "" in reasons:
            raise AssertionError(f"expr host {qid}: plans {seg_kinds}, reasons {reasons}")
        for path, run, runs in (
                ("per_segment", lambda sql=sql: execute_query(host_table, sql), EXPR_HOST_RUNS),
                ("set", lambda sql=sql: mx.execute(host_table, sql), 0)):
            line = checked("host", f"expr host {qid} {path}", run, want, none, runs,
                           JOIN_RTOL, JOIN_ATOL)
            log("expr_host_query", query=qid, path=path, plan_kind=kind,
                fallback_reason=reasons[0], rows=host_rows, segments=len(host_table), **line)
    sup_ctx = compile_query("SELECT s_nation FROM supplier WHERE strpos(s_city, 'A') = 0",
                            schemas["supplier"])
    reason = plan_segment(sup_ctx, supplier[0]).fallback_reason
    if not reason:
        raise AssertionError("expr host join: the supplier leaf took the device mask")
    line = checked("host", "expr host join", lambda: execute_multistage(
        EXPR_HOST_JOIN, scan_fn, schemas.get), oracle_host_join(cols, sup_cols), none,
        EXPR_HOST_RUNS, JOIN_RTOL, JOIN_ATOL)
    log("expr_host_query", query="host_mask_join", path="multistage", plan_kind="selection",
        fallback_reason=reason, rows=rows, **line)

    # a consuming segment without staging: host plans alone, the merged view
    # beside the table
    n_rt = EXPR_CONSUMING_ROWS
    rt = ssb.make_columns(n_rt, args.seed + 2)
    MemoryStream.reset_all()
    stream = MemoryStream.create("lineorder_expr", 1)
    for lo in range(0, n_rt, REALTIME_BLOCK_ROWS):
        stream.produce(encode_columnar_block(schema, {c: v[lo:lo + REALTIME_BLOCK_ROWS]
                                                      for c, v in rt.items()}), partition=0)
    cfg = TableConfig("lineorder", stream=StreamConfig(topic="lineorder_expr",
                                                       decoder="columnar"))
    consumer = RealtimePartitionConsumer("lineorder__0__1__20261017T0000Z", cfg, schema, 0,
                                         work)
    t0 = time.perf_counter()
    got = consumer.pump(max_messages=n_rt // REALTIME_BLOCK_ROWS + 1)
    pump_s = time.perf_counter() - t0
    view = consumer.query_segment()
    if got != n_rt or view.num_docs != n_rt or not view.is_mutable:
        raise AssertionError(f"expr consuming: pumped {got}, view {view.num_docs} rows, "
                             f"mutable {view.is_mutable}")
    log("expr_consuming_data", rows=n_rt, seed=args.seed + 2, pump_ms=pump_s * 1e3,
        rows_per_s=n_rt / pump_s, device_staging=False)
    for qid, sql, oracle in (("q1_1", ssb.QUERY, oracle_q11),
                             ("group_by", ssb.GROUP_QUERY, oracle_group)):
        seg_kinds, reasons = kinds(sql, [view])
        if seg_kinds != ["host"]:
            raise AssertionError(f"expr consuming {qid}: view plan {seg_kinds} {reasons}")
        line = checked("host", f"expr consuming {qid} view", lambda sql=sql: execute_query(
            [view], sql), oracle(rt), none, EXPR_HOST_RUNS)
        log("expr_consuming", query=qid, path="view", plan_kind="host",
            fallback_reason=reasons[0], rows=n_rt, **line)
        members = table + [view]
        _, merged = mx._plan_for_set(compile_query(sql, schema), members)
        if merged is None:
            raise AssertionError(f"expr consuming {qid}: the mixed set took no merged view")
        # on the merged view the consuming member's numeric columns have no
        # dictionary, so these filters compare values: the body (the GROUP BY
        # one grouped_agg launch)
        line = checked("expr", f"expr consuming {qid} mixed", lambda: mx.execute(members, sql),
                       add_rows(oracle(cols), oracle(rt)),
                       counts_of(grouped_agg=int(qid == "group_by")), EXPR_HOST_RUNS)
        log("expr_consuming", query=qid, path="mixed_set", plan_kind="device",
            rows=rows + n_rt, segments=len(members), merged_view=True, **line)
    return launches, case


# -- phase 10: aggs --------------------------------------------------------------------

AGGS_DEVICE_RUNS = 5   # warm runs of a device-routed query (cut from 10 for the search phase)
AGGS_HOST_RUNS = 0             # warm runs of a host-routed one (seconds a run: its
                               # cold run alone)
AGGS_CONSUMING_ROWS = 2_097_152
AGGS_SKEW_ATOL = 1e-4          # skewness lies near 0: rel 1e-5 or abs 1e-4
AGGS_SKETCH_REL = 0.05         # HLL (p = 12) and theta (k = 4096) against the exact count
AGGS_TDIGEST_ABS = 1.0         # the p95 t-digest within one lo_discount step
Q11_WHERE = ("lo_orderdate BETWEEN 19930101 AND 19931231 AND lo_discount BETWEEN 1 AND 3 "
             "AND lo_quantity < 25")
AGGS_DEVICE = {
    "distinctcount": ("SELECT DISTINCTCOUNT(lo_suppkey), COUNT(DISTINCT lo_discount) "
                      f"FROM lineorder WHERE {Q11_WHERE}"),
    "hll": "SELECT DISTINCTCOUNTHLL(lo_custkey) FROM lineorder",
    "theta": "SELECT DISTINCTCOUNTTHETASKETCH(lo_suppkey) FROM lineorder WHERE lo_quantity < 25",
    "tdigest": "SELECT PERCENTILETDIGEST(lo_discount, 95) FROM lineorder WHERE lo_quantity < 25",
    "moments": ("SELECT VAR_POP(lo_discount), STDDEV_SAMP(lo_discount), SKEWNESS(lo_discount), "
                "KURTOSIS(lo_discount) FROM lineorder WHERE lo_quantity < 25"),
    "group_distinct": ("SELECT lo_region, DISTINCTCOUNT(lo_suppkey), VAR_SAMP(lo_discount) "
                       "FROM lineorder GROUP BY lo_region ORDER BY lo_region"),
}
AGGS_SKETCHES = ("hll", "theta", "tdigest")
# grouped_agg launches a pass of each AGGS_DEVICE query: one a `distinct`
# output, one for a scalar plan's power sums, one a GROUP BY's other outputs
AGGS_GROUPED = {"distinctcount": 2, "hll": 1, "theta": 1, "tdigest": 1, "moments": 1,
                "group_distinct": 2}
AGGS_HOST = {
    "kurtosis_quantity": "SELECT KURTOSIS(lo_quantity) FROM lineorder",
    "percentile": "SELECT PERCENTILE(lo_revenue, 99) FROM lineorder",
    "mode": "SELECT MODE(lo_quantity) FROM lineorder",
    "group_custkey": ("SELECT lo_region, DISTINCTCOUNT(lo_custkey) FROM lineorder "
                      "GROUP BY lo_region ORDER BY lo_region"),
    "covar": "SELECT COVAR_POP(lo_revenue, lo_extendedprice) FROM lineorder",
}
#: the host-routed queries read the table's first 2 segments, to keep the
#: smoke inside its time (DISTINCTCOUNT(lo_custkey) by region took 17 s over 8)
AGGS_HOST_SEGMENTS = 2
AGGS_IDSET = ("SELECT IDSET(lo_suppkey) FROM lineorder "
              "WHERE lo_quantity = 7 AND lo_discount = 3 AND lo_region = 'ASIA'")
AGGS_IN_ID_SET = ("SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
                  "WHERE IN_ID_SET(lo_suppkey, '{}') = 1 AND lo_quantity > 40 "
                  "GROUP BY lo_region ORDER BY lo_region")
AGGS_JOIN = ("SELECT s.s_nation, DISTINCTCOUNT(l.lo_custkey), COUNT(*) FROM lineorder l "
             "JOIN supplier s ON l.lo_suppkey = s.s_suppkey "
             "WHERE s.s_region = 'AMERICA' AND l.lo_discount BETWEEN 1 AND 3 "
             "GROUP BY s.s_nation ORDER BY s.s_nation LIMIT 25")
AGGS_CONSUMING = {
    # the view's lo_region is a dictionary column: the device presence, alone
    # and on the merged view beside the table
    "view_region": ("SELECT DISTINCTCOUNT(lo_region), COUNT(*) FROM lineorder "
                    "WHERE lo_quantity < 25"),
    # the view's lo_suppkey is raw: the view plans on the host, the table's
    # segments on the device
    "mixed_suppkey": ("SELECT DISTINCTCOUNT(lo_suppkey), DISTINCTCOUNT(lo_region) "
                      "FROM lineorder WHERE lo_quantity < 25"),
}


def cells_match(got, want, rtol: float, atols=()) -> bool:
    """Rows equal: non-floats exactly, floats at `rtol` or column j's abs
    tolerance `atols[j]` (0 where not given)."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for j, (x, y) in enumerate(zip(rg, rw)):
            if isinstance(y, float):
                atol = atols[j] if j < len(atols) else 0.0
                if x is None or not math.isclose(float(x), y, rel_tol=rtol, abs_tol=atol):
                    return False
            elif x != y:
                return False
    return True


def aggs_oracles(c) -> dict:
    """qid -> (oracle rows, check(rows)) in numpy float64 over the table's rows:
    exact answers equal, moments at rel 1e-5 (skewness also abs 1e-4), host
    floats at rel 1e-9, sketches within their own error of the exact value."""
    from pinot_tpu_torch.ssb import REGIONS
    m25 = c["lo_quantity"] < 25
    d = c["lo_discount"][m25].astype(np.float64)
    z = (d - d.mean()) / d.std()
    q = c["lo_quantity"].astype(np.float64)
    zq = (q - q.mean()) / q.std()
    rev, ext = c["lo_revenue"], c["lo_extendedprice"]
    m = q11_mask(c)
    exact_custkeys = len(np.unique(c["lo_custkey"]))
    exact_suppkeys = len(np.unique(c["lo_suppkey"][m25]))
    p95 = float(np.percentile(d, 95))
    region = {r: c["lo_region"] == r for r in sorted(REGIONS)}
    out = {
        "distinctcount": [[len(np.unique(c["lo_suppkey"][m])),
                           len(np.unique(c["lo_discount"][m]))]],
        "hll": [[exact_custkeys]], "theta": [[exact_suppkeys]], "tdigest": [[p95]],
        "moments": [[float(d.var()), float(d.std(ddof=1)), float((z ** 3).mean()),
                     float((z ** 4).mean() - 3.0)]],
        "group_distinct": [[r, len(np.unique(c["lo_suppkey"][g])),
                            float(c["lo_discount"][g].astype(np.float64).var(ddof=1))]
                           for r, g in region.items()],
        "kurtosis_quantity": [[float((zq ** 4).mean() - 3.0)]],
        "percentile": [[float(np.percentile(rev, 99))]],
        "mode": [[float(np.argmax(np.bincount(c["lo_quantity"])))]],
        "group_custkey": [[r, len(np.unique(c["lo_custkey"][g]))] for r, g in region.items()],
        "covar": [[float(np.mean((rev - rev.mean()) * (ext - ext.mean())))]],
    }

    def near(want, rel):
        return lambda rows: len(rows) == 1 and abs(rows[0][0] - want) <= rel * want

    checks = {
        "hll": near(exact_custkeys, AGGS_SKETCH_REL),
        "theta": near(exact_suppkeys, AGGS_SKETCH_REL),
        "tdigest": lambda rows: len(rows) == 1 and abs(rows[0][0] - p95) <= AGGS_TDIGEST_ABS,
        "moments": lambda rows: cells_match(rows, out["moments"], ORACLE_RTOL,
                                            (0.0, 0.0, AGGS_SKEW_ATOL)),
        "group_distinct": lambda rows: cells_match(rows, out["group_distinct"], ORACLE_RTOL),
    }
    return {qid: (want, checks.get(qid, lambda rows, want=want: cells_match(
        rows, want, JOIN_RTOL))) for qid, want in out.items()}


def run_aggs(args, table, cols, work) -> tuple:
    """The aggregation library over the table: device-routed families (the
    `distinct` output and the power sums) per segment and over the set, each
    sketch equal to the same run on the CPU; host-routed ones; IDSET feeding
    IN_ID_SET; a join's final DISTINCTCOUNT; a staged consuming view alone and
    beside the table; a pipeline mix; then `aggs_case` lines. Returns the
    kernels' launches of the checked runs (no scan: no plan here reaches it;
    bitmap_filter where a filter reads bitmap leaves) and the `aggs_case`
    numbers."""
    from pinot_tpu_torch import execute_query, segments_from_columns, ssb
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.multistage import execute_multistage, make_segment_scan
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.idset import IdSet
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.table import StreamConfig, TableConfig

    schema = table[0].schema
    rows = sum(s.num_docs for s in table)
    t0 = time.perf_counter()
    oracles = aggs_oracles(cols)
    log("aggs_data", rows=rows, segments=len(table), oracle_s=time.perf_counter() - t0)
    mx, cpu_mx = MeshQueryExecutor(), MeshQueryExecutor(device="cpu")
    launches = counts_of()

    def checked(label, run, check, runs, trace=False, bitmap=0, grouped=0):
        """One cold run with the counts set to 0 just before and read just
        after (none of these plans launches a scan or a top-k; `bitmap`
        bitmap_filter and `grouped` grouped_agg launches), held by `check`;
        then `runs` warm runs, each held too."""
        reset_launch_counts()
        kernels.reset_topk_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts, topk = launch_counts(), kernels.topk_launches()
        for k, v in counts.items():
            launches[k] += v
        if counts != counts_of(bitmap_filter=bitmap, grouped_agg=grouped) or topk:
            raise AssertionError(f"{label}: kernel launches {counts}, top-k {topk}; expected "
                                 f"{counts_of(bitmap_filter=bitmap, grouped_agg=grouped)}: "
                                 "the aggregation library reaches no scan")
        if not check(res.rows):
            raise AssertionError(f"{label}: got {res.rows[:12]}")
        fields = dict(answer=res.rows[:12], answer_rows=len(res.rows), cold_ms=cold_ms,
                      launches=counts, cold_phase_ms=res.stats.get("phaseTimesMs"))
        if runs:
            warm, results = warm_times(run, runs=runs)
            bad = [r.rows[:4] for r in results if not check(r.rows)]
            if bad:
                raise AssertionError(f"{label}: warm answers {bad[:2]}")
            warm.pop("median_s")
            fields.update(warm)
            phases = [r.stats["phaseTimesMs"] for r in results if "phaseTimesMs" in r.stats]
            if phases:
                fields["warm_phase_median_ms"] = {
                    k: statistics.median(p[k] for p in phases) for k in phases[0]}
        if trace and args.trace:
            fields["trace"] = trace_query(run)
        return fields, res.rows

    def kinds(sql, segs):
        ctx = compile_query(sql, schema)
        plans = [plan_segment(ctx, s) for s in segs]
        return [p.kind for p in plans], sorted({p.fallback_reason for p in plans})

    # device routes: per segment and over the set; a sketch's answer equals
    # the same path's on the CPU (the same states from the same segments)
    set_answers = {}
    for qid, sql in AGGS_DEVICE.items():
        want, check = oracles[qid]
        seg_kinds, _ = kinds(sql, table)
        set_plan, _ = mx._plan_for_set(compile_query(sql, schema), table)
        if set(seg_kinds) != {"device"} or set_plan.kind != "device":
            raise AssertionError(f"aggs {qid}: plans {seg_kinds} per segment, "
                                 f"{set_plan.kind} over the set; expected device")
        for path, run, cpu_run, passes in (
                ("per_segment", lambda sql=sql: execute_query(table, sql),
                 lambda sql=sql: execute_query(table, sql, device="cpu"), len(table)),
                ("set", lambda sql=sql: mx.execute(table, sql),
                 lambda sql=sql: cpu_mx.execute(table, sql), 1)):
            line, got = checked(f"aggs {qid} {path}", run, check, AGGS_DEVICE_RUNS, trace=True,
                                grouped=AGGS_GROUPED[qid] * passes)
            if qid in AGGS_SKETCHES:
                t0 = time.perf_counter()
                on_cpu = cpu_run().rows
                line["cpu_ms"] = (time.perf_counter() - t0) * 1e3
                if got != on_cpu:
                    raise AssertionError(f"aggs {qid} {path}: {got} on the card, {on_cpu} "
                                         "on the CPU")
                line["equals_cpu"] = True
            if path == "set":
                set_answers[qid] = got
            log("aggs_query", query=qid, path=path, plan_kind="device", rows=rows,
                segments=len(table), oracle=want, **line)

    # host routes: per segment (the set executor hands a host plan to the same
    # per-segment executor: its plan is checked, not run again)
    host_table = table[:AGGS_HOST_SEGMENTS]
    host_rows = sum(s.num_docs for s in host_table)
    host_oracles = aggs_oracles({k: v[:host_rows] for k, v in cols.items()})
    for qid, sql in AGGS_HOST.items():
        want, check = host_oracles[qid]
        seg_kinds, reasons = kinds(sql, host_table)
        set_plan, _ = mx._plan_for_set(compile_query(sql, schema), host_table)
        if set(seg_kinds) != {"host"} or "" in reasons or set_plan.kind != "host":
            raise AssertionError(f"aggs host {qid}: plans {seg_kinds} {reasons}, set "
                                 f"{set_plan.kind}")
        line, _ = checked(f"aggs host {qid}", lambda sql=sql: execute_query(host_table, sql),
                          check, AGGS_HOST_RUNS)
        log("aggs_query", query=qid, path="per_segment", plan_kind="host",
            fallback_reason=reasons[0], set_plan_kind=set_plan.kind, rows=host_rows,
            segments=len(host_table), oracle=want, **line)

    # IDSET (a host plan) feeding IN_ID_SET (a device LUT leaf)
    idset_rows = (cols["lo_quantity"] == 7) & (cols["lo_discount"] == 3) & (
        cols["lo_region"] == "ASIA")
    want_ids = np.unique(cols["lo_suppkey"][idset_rows])
    line, got = checked("aggs idset", lambda: execute_query(table, AGGS_IDSET), lambda rows: (
        np.array_equal(IdSet.deserialize(rows[0][0]).values, want_ids)), AGGS_HOST_RUNS)
    line["answer"] = f"IdSet of {len(want_ids)} values, {len(got[0][0])} base64 chars"
    log("aggs_query", query="idset", path="per_segment", plan_kind=kinds(AGGS_IDSET, table)[0][0],
        rows=rows, **line)
    in_sql = AGGS_IN_ID_SET.format(got[0][0])
    m = np.isin(cols["lo_suppkey"], want_ids) & (cols["lo_quantity"] > 40)
    want = [[r, int((m & (cols["lo_region"] == r)).sum()),
             float(cols["lo_revenue"][m & (cols["lo_region"] == r)].sum())]
            for r in sorted(set(cols["lo_region"][m]))]
    seg_kinds, _ = kinds(in_sql, table)
    if set(seg_kinds) != {"device"}:
        raise AssertionError(f"aggs in_id_set: plans {seg_kinds}")
    # lo_quantity > 40 is a bitmap leaf beside the id-set LUT: one launch a
    # mask; the GROUP BY one grouped_agg launch a pass
    for path, run, passes in (("per_segment", lambda: execute_query(table, in_sql), len(table)),
                              ("set", lambda: mx.execute(table, in_sql), 1)):
        line, _ = checked(f"aggs in_id_set {path}", run, lambda rows: rows_match(rows, want),
                          AGGS_DEVICE_RUNS, bitmap=passes, grouped=passes)
        log("aggs_query", query="in_id_set", path=path, plan_kind="device", rows=rows,
            id_set_values=len(want_ids), oracle=want, **line)

    # a join's final aggregation
    sup = ssb.make_supplier(seed=args.seed)
    supplier = segments_from_columns(ssb.supplier_schema(), sup,
                                     os.path.join(work, "aggs_supplier"), 1)
    schemas = {"lineorder": schema, "supplier": ssb.supplier_schema()}
    scan_fn = make_segment_scan({"lineorder": table, "supplier": supplier})
    nation = np.asarray(sup["s_nation"])[cols["lo_suppkey"]]
    jm = (np.asarray(sup["s_region"])[cols["lo_suppkey"]] == "AMERICA") & (
        cols["lo_discount"] >= 1) & (cols["lo_discount"] <= 3)
    want = [[n, len(np.unique(cols["lo_custkey"][jm & (nation == n)])),
             int((jm & (nation == n)).sum())] for n in sorted(set(nation[jm]))]
    # the supplier leaf's s_region = 'AMERICA': one all-bitmap mask
    line, _ = checked("aggs join", lambda: execute_multistage(AGGS_JOIN, scan_fn, schemas.get),
                      lambda rows: rows == want, AGGS_HOST_RUNS, bitmap=1)
    log("aggs_query", query="join_distinctcount", path="multistage", rows=rows, oracle=want,
        **line)

    # a staged consuming view: alone, and beside the table
    n_rt = AGGS_CONSUMING_ROWS
    rt = ssb.make_columns(n_rt, args.seed + 3)
    MemoryStream.reset_all()
    stream = MemoryStream.create("lineorder_aggs", 1)
    for lo in range(0, n_rt, REALTIME_BLOCK_ROWS):
        stream.produce(encode_columnar_block(schema, {c: v[lo:lo + REALTIME_BLOCK_ROWS]
                                                      for c, v in rt.items()}), partition=0)
    cfg = TableConfig("lineorder", stream=StreamConfig(
        topic="lineorder_aggs", decoder="columnar",
        properties={"realtime.ingest.device.staging": "true"}, flush_threshold_rows=n_rt))
    consumer = RealtimePartitionConsumer("lineorder__0__2__20261017T0000Z", cfg, schema, 0,
                                         work)
    t0 = time.perf_counter()
    pumped = consumer.pump(max_messages=n_rt // REALTIME_BLOCK_ROWS + 1)
    pump_ms = (time.perf_counter() - t0) * 1e3
    view = consumer.query_segment()
    if pumped != n_rt or view.num_docs != n_rt or view.is_mutable:
        raise AssertionError(f"aggs consuming: pumped {pumped}, view {view.num_docs} rows, "
                             f"mutable {view.is_mutable}")
    both = {c: np.concatenate([cols[c], rt[c]]) for c in cols}
    members = table + [view]

    def consuming_oracle(qid, c):
        m = c["lo_quantity"] < 25
        if qid == "view_region":
            return [[len(np.unique(c["lo_region"][m])), int(m.sum())]]
        return [[len(np.unique(c["lo_suppkey"][m])), len(np.unique(c["lo_region"][m]))]]

    # (query, path, its members, their rows, the plan kinds per member, over
    # the set: the set plan's kind, planned on the merged view, and the
    # grouped_agg launches: one a distinct output of a device pass, the host
    # set plan's table segments each running theirs)
    consuming_runs = [
        ("view_region", "view", [view], rt, ["device"], None, 1),
        ("view_region", "mixed_set", members, both, ["device"] * len(members),
         ("device", True), 1),
        ("mixed_suppkey", "mixed_set", members, both, ["device"] * len(table) + ["host"],
         ("host", False), 2 * len(table))]
    for qid, path, segs, c, want_kinds, want_set, grouped in consuming_runs:
        sql, want = AGGS_CONSUMING[qid], consuming_oracle(qid, c)
        seg_kinds = kinds(sql, segs)[0]
        set_plan = None
        if want_set is not None:
            plan, merged = mx._plan_for_set(compile_query(sql, schema), segs)
            set_plan = (plan.kind, merged is not None)
        if (seg_kinds, set_plan) != (want_kinds, want_set):
            raise AssertionError(f"aggs consuming {qid} {path}: plans {seg_kinds}, set "
                                 f"plan and merged view {set_plan}")
        run = (lambda sql=sql: execute_query(segs, sql)) if path == "view" else \
            (lambda sql=sql: mx.execute(segs, sql))
        line, _ = checked(f"aggs consuming {qid} {path}", run,
                          lambda rows, want=want: rows == want, AGGS_DEVICE_RUNS,
                          grouped=grouped)
        log("aggs_consuming", query=qid, path=path, member_plan_kinds=sorted(set(seg_kinds)),
            set_plan_kind_merged_view=set_plan, rows=sum(s.num_docs for s in segs),
            pump_ms=pump_ms, oracle=want, **line)

    # the pipeline: client threads cycling the device queries; every answer
    # equal to the set executor's
    counts = serve_pipeline(mx, table, "aggs", [(AGGS_DEVICE[q], set_answers[q])
                                                for q in AGGS_DEVICE], rtol=0.0, atol=0.0)
    for k, v in counts.items():
        launches[k] += v
    return launches, aggs_cases(table, mx)


def aggs_cases(table, mx) -> dict:
    """The `distinct` op and the power sums alone (both `grouped_agg` calls
    since PR 15), at the main path's shapes (one segment; the stacked table)
    and masks (every row: the HLL query's; Q1.1's filter from the path's own
    `filter_mask`: the DISTINCTCOUNT query's), timed with CUDA events and L2
    flushed, against the bound of their bytes: each input read once (the
    int32 ids or values, the bool mask) and each output written once (int32
    counts; three f32 sums). `library_ms`: `torch.bincount` of the same
    masked ids (the power sums: of the masked key, one call for the count
    and one, with f64 weights, a power), calls that compute the same
    outputs; `extra_bin_ms`: the same counts with the masked rows sent to
    one extra bin (`index_add_` of ones). `ms` is an eager call, except for
    lo_suppkey's presence under Q1.1 and the power sums, the calls
    `group_case` times: there `ms` and `plain_ms` are graph replays, each
    output held to the plain version's, `call_ms` the eager call, and the
    bound `group_case`'s (the ids of the rows the mask keeps)."""
    from pinot_tpu_torch.engine.datablock import block_for, lut_size
    from pinot_tpu_torch.engine.grouped import grouped_agg
    from pinot_tpu_torch.engine.kernels import distinct_counts, filter_mask
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.executor import ServerQueryExecutor, kernel_spec
    from pinot_tpu_torch.query.planner import build_device_geometry, plan_segment

    dev = mx.device
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    seg = table[0]
    ctx = compile_query(AGGS_DEVICE["distinctcount"], seg.schema)
    plan = plan_segment(ctx, seg, peers=table[1:])
    build_device_geometry(plan)
    spec = kernel_spec(plan)
    block, stacked = block_for(seg, dev), mx._block_for(table)
    seg_inputs = ServerQueryExecutor(dev)._kernel_inputs(plan, spec, block)
    shapes = {"one segment": (block.ids, block.values, block.valid,
                              filter_mask(spec, seg_inputs)),
              "stacked set": (lambda c: stacked.ids(c).view(-1),
                              lambda c: stacked.decoded(c).view(-1), stacked.valid.view(-1),
                              filter_mask(spec, mx._set_inputs(plan, spec, stacked, ctx)))}
    sizes = {c: lut_size(seg.column(c).cardinality)
             for c in ("lo_custkey", "lo_suppkey", "lo_discount")}
    out = {}
    for shape, (ids_of, values_of, valid, q11) in shapes.items():
        n = valid.numel()
        region = ids_of("lo_region")
        key = torch.where(valid, region.long(), 8)
        disc = values_of("lo_discount")

        def presence(col, mask, timed=False):
            ids, size = ids_of(col), sizes[col]

            def extra_bin():
                rows = torch.where(mask, ids.long(), size)
                return torch.zeros(size + 1, dtype=torch.int32, device=dev).index_add_(
                    0, rows, torch.ones_like(rows, dtype=torch.int32))
            return (lambda: distinct_counts(mask, ids, size),
                    lambda: torch.bincount(torch.where(mask, ids.long(), size),
                                           minlength=size + 1),
                    extra_bin, 5 * n + 4 * size, n,
                    ([ids], [1], mask, [], [], size) if timed else None)

        def power_sums():
            return grouped_agg([], [], valid, [disc] * 3, ["sum2", "sum3", "sum4"], 1)

        supp, size = ids_of("lo_suppkey"), sizes["lo_suppkey"]
        power_args = ([], [], valid, [disc] * 3, ["sum2", "sum3", "sum4"], 1)
        cases = {
            "presence lo_custkey, every row": presence("lo_custkey", valid),
            "presence lo_suppkey, Q1.1 filter": presence("lo_suppkey", q11, timed=True),
            "presence lo_discount, Q1.1 filter": presence("lo_discount", q11),
            "grouped lo_suppkey by lo_region": (
                lambda: distinct_counts(valid, supp, size, [region], [1], 9),
                lambda: torch.bincount(key * size + supp.long(), minlength=9 * size),
                None, 9 * n + 4 * 9 * size, 2 * n, None),
            "power sums 2-4 lo_discount": (power_sums, group_library(*power_args), None,
                                           5 * n + 4 + 3 * 4, 10 * n, power_args),
        }
        for op, (fn, library, extra_bin, nbytes, ops, timed) in cases.items():
            fn()
            torch.cuda.synchronize()
            bms, by = roofline(nbytes, ops)
            if timed is not None:
                numbers = {k: v for k, v in group_case(f"{op}, {shape}", *timed, flush).items()
                           if k in ("rung", "max_abs_err", "ms", "plain_ms", "call_ms",
                                    "bound_ms", "bound_by")}
                numbers.update(rows=n, library_ms=time_ms(library, flush))
                bms = numbers["bound_ms"]
            else:
                numbers = dict(rows=n, ms=time_ms(fn, flush), bound_ms=bms, bound_by=by,
                               library_ms=time_ms(library, flush) if library else None)
            if extra_bin is not None:
                if not torch.equal(extra_bin()[:-1], fn()):
                    raise AssertionError(f"aggs_case {op}, {shape}: the forms disagree")
                numbers["extra_bin_ms"] = time_ms(extra_bin, flush)
            numbers["pct_of_bound"] = 100.0 * bms / numbers["ms"]
            log("aggs_case", op=op, shape=shape, **numbers)
            out[f"{op}, {shape}"] = numbers
    return out


# -- phase 11: index --------------------------------------------------------------

INDEX_RUNS = 5         # warm runs of each query and path (cut from 10 for the search phase)
INDEX_CROSSOVER_RUNS = 5        # warm runs of each crossover regime
INDEX_NULL_ROWS = 2_097_152     # the null table: one segment
INDEX_NULL_FRACTION = 0.01
INDEX_CONFIG = dict(inverted_index_columns=["lo_region", "lo_discount", "lo_quantity"],
                    range_index_columns=["lo_orderdate"], bloom_filter_columns=["lo_custkey"],
                    # lo_revenue raw too: at 16M rows the writer would give its ~6M
                    # values a dictionary, and the mixed tree needs a compare leaf
                    no_dictionary_columns=["lo_custkey", "lo_revenue"],
                    # bench.py's two star-tree tables, on one table here
                    star_tree_configs=[
                        {"dimensionsSplitOrder": ["lo_region", "lo_discount"],
                         "functionColumnPairs": ["SUM__lo_revenue"]},
                        {"dimensionsSplitOrder": ["lo_orderdate", "lo_discount"],
                         "functionColumnPairs": ["SUM__lo_revenue"]}])
INDEX_HC_QUERY = ("SELECT lo_orderdate, SUM(lo_revenue), COUNT(*), AVG(lo_revenue) "
                  "FROM lineorder WHERE lo_discount BETWEEN 1 AND 3 GROUP BY lo_orderdate "
                  "ORDER BY lo_orderdate LIMIT 10")
INDEX_BITMAP_QUERY = ("SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
                      "WHERE lo_discount = 2 AND lo_quantity IN (1, 7, 13) GROUP BY lo_region "
                      "ORDER BY lo_region")
INDEX_MIXED_QUERY = ("SELECT COUNT(*), SUM(lo_extendedprice) FROM lineorder "
                     "WHERE lo_discount = 2 AND lo_revenue > 30000")
INDEX_IDSET_QUERY = ("SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
                     "WHERE IN_ID_SET(lo_custkey, '{}') = 1 GROUP BY lo_region "
                     "ORDER BY lo_region")
INDEX_ABSENT_QUERY = "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = {}"
INDEX_HOST_MASK_SELECT = ("SELECT lo_custkey, lo_revenue FROM lineorder WHERE lo_quantity = 7 "
                          "AND lo_discount = 3 AND COALESCE(lo_revenue, 0) > 40000 "
                          "ORDER BY lo_custkey, lo_revenue LIMIT 20")
INDEX_NULL_QUERIES = {
    "is_null": "SELECT COUNT(*), SUM(lo_quantity) FROM lineorder WHERE lo_revenue IS NULL",
    "is_not_null": ("SELECT COUNT(*), SUM(lo_revenue) FROM lineorder "
                    "WHERE lo_revenue IS NOT NULL AND lo_discount < 4"),
}
# lo_quantity <= q: selectivity q / 50 (q = 50 would fold to match-all)
INDEX_CROSSOVER_QUANTITIES = (1, 5, 12, 25, 37, 49)
INDEX_CROSSOVER_TREES = {
    # an all-bitmap tree: one launch evaluates it in the word domain
    "all_bitmap": ("SELECT lo_region, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE "
                   "lo_discount = 2 AND lo_quantity BETWEEN 1 AND {q} GROUP BY lo_region "
                   "ORDER BY lo_region"),
    # a mixed tree: the bitmap leaf's row mask, then a value compare in torch
    "mixed": ("SELECT COUNT(*), SUM(lo_extendedprice) FROM lineorder WHERE "
              "lo_quantity BETWEEN 1 AND {q} AND lo_revenue > 30000"),
}
BITMAP_SOURCE = ("pinot_tpu_torch/csrc/bitmap_filter.cu", "pinot_tpu/engine/kernels.py:416")
BITMAP_LIBRARY_NOTE = ("library_ms is null: torch has no popcount and no bitwise-OR "
                       "reduction, so no single PyTorch call evaluates a filter tree over "
                       "packed words")


def index_oracles(c, idset_keys, pruned_key) -> dict:
    """numpy float64 answers of the index phase's queries over the table."""
    from pinot_tpu_torch.ssb import REGIONS

    def by_region(m, cells):
        return [[r] + cells(m & (c["lo_region"] == r)) for r in sorted(REGIONS)
                if (m & (c["lo_region"] == r)).any()]

    disc13 = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3)
    dates = np.unique(c["lo_orderdate"][disc13])[:10]
    hc = [[int(d), float(c["lo_revenue"][disc13 & (c["lo_orderdate"] == d)].sum()),
           int((disc13 & (c["lo_orderdate"] == d)).sum()),
           float(c["lo_revenue"][disc13 & (c["lo_orderdate"] == d)].mean())] for d in dates]
    bm = (c["lo_discount"] == 2) & np.isin(c["lo_quantity"], [1, 7, 13])
    mixed = (c["lo_discount"] == 2) & (c["lo_revenue"] > 30000)
    ids = np.isin(c["lo_custkey"], idset_keys)
    sel = (c["lo_quantity"] == 7) & (c["lo_discount"] == 3) & (c["lo_revenue"] > 40000)
    idx = np.nonzero(sel)[0]
    idx = idx[np.lexsort((c["lo_revenue"][idx], c["lo_custkey"][idx]))][:20]
    return {
        "star_query": by_region(disc13, lambda g: [float(c["lo_revenue"][g].sum())])[:10],
        "star_hc": hc,
        "all_bitmap": by_region(bm, lambda g: [float(c["lo_revenue"][g].sum()), int(g.sum())]),
        "mixed": [[int(mixed.sum()), float(c["lo_extendedprice"][mixed].sum())]],
        "in_id_set_raw": by_region(ids, lambda g: [int(g.sum()),
                                                   float(c["lo_revenue"][g].sum())]),
        "bloom_pruned": [[int((c["lo_custkey"] == pruned_key).sum()),
                          float(c["lo_revenue"][c["lo_custkey"] == pruned_key].sum())
                          if (c["lo_custkey"] == pruned_key).any() else None]],
        "host_mask_select": [[int(c["lo_custkey"][i]), float(c["lo_revenue"][i])] for i in idx],
    }


def null_oracles(c, null) -> dict:
    nn = ~null & (c["lo_discount"] < 4)
    return {"is_null": [[int(null.sum()), float(c["lo_quantity"][null].sum())]],
            "is_not_null": [[int(nn.sum()), float(c["lo_revenue"][nn].sum())]]}


def index_rows_match(got, want) -> bool:
    """rows_match, with a None cell (an empty SUM) held exactly."""
    if len(got) != len(want) or any(len(g) != len(w) for g, w in zip(got, want)):
        return False
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if y is None or x is None:
                if x is not y:
                    return False
            elif not rows_match([[x]], [[y]]):
                return False
    return True


def bitmap_cases(block, stacked) -> dict:
    """`bitmap_filter` against `bitmap_filter_plain` on the card, on the index
    table's words: the bitmap query's main-path shape (lo_discount = 2 AND
    lo_quantity IN (1, 7, 13), "mask" mode: one segment, and the stacked set
    in one launch), and one lo_discount leaf of k = 1, 3 and 11 selected rows in
    all three modes (one segment; k = 3 stacked too). Each output equal to the
    plain version's; `ms` and `plain_ms` device time (CUDA graph replay, L2
    flushed), `call_ms` an eager call, `floor_ms` a 4-byte `zero_()` timed
    the same way as `ms` (the fixed cost of one launch in a replay); the bound
    is the words read once (k + 1 rows of W words) and the output written once
    (W words, 32 W bytes, or 8) over the memory rate."""
    from pinot_tpu_torch.engine import bitmap
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=block.device)
    tiny = torch.zeros(1, dtype=torch.int32, device=block.device)
    shapes = {"one segment": (block.bitmap_words, block.valid_words),
              "stacked set": (stacked.bitmap_words, stacked.valid_words.view(-1))}
    cases = []
    for shape, (words_of, valid_words) in shapes.items():
        cases.append((f"bitmap_query, {shape}", [0, 1, bitmap.AND],
                      [bitmap.BitmapLeaf(words_of("lo_discount"), (2,)),
                       bitmap.BitmapLeaf(words_of("lo_quantity"), (0, 6, 12))],
                      valid_words, ("mask",), True))
        for k in ((1, 3, 11) if shape == "one segment" else (3,)):
            cases.append((f"lo_discount k={k}, {shape}", [0],
                          [bitmap.BitmapLeaf(words_of("lo_discount"), tuple(range(k)))],
                          valid_words, ("words", "mask", "count"), False))
    out = {}
    for case, program, leaves, valid_words, modes, main in cases:
        n_words = int(valid_words.numel())
        k = sum(len(leaf.rows) for leaf in leaves)
        for mode in modes:
            def kernel():
                return bitmap.bitmap_filter(program, leaves, valid_words, mode)

            def plain():
                return bitmap.bitmap_filter_plain(program, leaves, valid_words, mode)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bitmap_case {case}, {mode}: the kernel's output "
                                     "differs from the plain version's")
            written = {"words": 4 * n_words, "mask": 32 * n_words, "count": 8}[mode]
            bms, by = roofline(4 * (k + 1) * n_words + written, 0)
            numbers = dict(words=n_words, rows=32 * n_words, selected_rows=k,
                           equal=True, max_abs_err=0.0, ms=graph_ms(kernel, flush),
                           plain_ms=graph_ms(plain, flush), call_ms=time_ms(kernel, flush),
                           floor_ms=graph_ms(tiny.zero_, flush), bound_ms=bms, bound_by=by)
            numbers["pct_of_bound"] = 100.0 * bms / numbers["ms"]
            log("bitmap_case", case=case, mode=mode, main_path=main, **numbers)
            out[f"{case}, {mode}"] = numbers
    return out


def build_index_table(rows: int, seed: int, out: str) -> tuple:
    """In a worker process: phase 4's lineorder (the same rows, from the same
    seed) rebuilt with INDEX_CONFIG's indexes and trees. Returns (paths,
    build s)."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    cols = ssb.make_columns(rows, seed)
    t0 = time.perf_counter()
    paths = build_aligned_segments(ssb.ssb_schema(), cols, out, "lineorder", SEGMENTS,
                                   SegmentGeneratorConfig(**INDEX_CONFIG))
    return paths, time.perf_counter() - t0


def run_index(args, plain_table, cols, work, job=None) -> tuple:
    """Phase 11: lineorder from --seed rebuilt with the port's writer with both
    of bench.py's star-trees, inverted indexes on lo_region, lo_discount and
    lo_quantity, a range index on lo_orderdate, lo_custkey raw with a bloom
    filter and lo_revenue raw; its queries per segment, over the set and through the pipeline
    against numpy; IS NULL over a null table; the `bitmap_case` lines and the
    `crossover` lines. Returns (launches of the checked runs by kernel,
    launches by route, bitmap_case numbers)."""
    from pinot_tpu_torch import execute_query, load_segment, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.parallel import MeshQueryExecutor, combine
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.idset import IdSet
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.query.startree_exec import try_star_tree
    from pinot_tpu_torch.segment import SegmentBuilder
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments

    schema = ssb.ssb_schema()
    t0 = time.perf_counter()
    if job is None:
        paths = build_aligned_segments(schema, cols, os.path.join(work, "index"), "lineorder",
                                       SEGMENTS, SegmentGeneratorConfig(**INDEX_CONFIG))
        build_s = time.perf_counter() - t0
    else:   # built in the worker pool beside the earlier phases
        paths, build_s = job.result()
    waited_s = time.perf_counter() - t0
    table = [load_segment(p) for p in paths]
    records = [[t.num_records for t in s.star_trees] for s in table]
    # IN_ID_SET: the customers of one region's lo_quantity = 7 AND lo_discount = 3
    # rows. Bloom pruning: at 16M rows nearly every key of [0, 500,000) lies in
    # every segment, so no key inside min/max is absent from the whole table;
    # the in-range key absent from the most segments is pruned by their bloom
    # filters (min/max cannot decide it), and a key past the maximum is pruned
    # everywhere
    pick = (cols["lo_quantity"] == 7) & (cols["lo_discount"] == 3) & (cols["lo_region"] == "ASIA")
    idset_keys = np.unique(cols["lo_custkey"][pick])
    literal = IdSet.from_values(idset_keys).serialize()
    bounds = np.linspace(0, len(cols["lo_custkey"]), SEGMENTS + 1, dtype=np.int64)
    absent_in = np.zeros(ssb.VERY_HIGH_CARD_KEYS, dtype=np.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        present = np.zeros(ssb.VERY_HIGH_CARD_KEYS, dtype=bool)
        present[cols["lo_custkey"][lo:hi]] = True
        absent_in += ~present
    pruned_key = int(np.argmax(absent_in))
    absent_key = int(cols["lo_custkey"].max()) + 1
    oracles = index_oracles(cols, idset_keys, pruned_key)
    log("index_data", rows=sum(s.num_docs for s in table), segments=len(table),
        build_s=build_s, waited_for_worker_s=waited_s, star_records=records, idset_keys=int(len(idset_keys)),
        pruned_key=pruned_key, pruned_key_absent_in=int(absent_in[pruned_key]),
        absent_key=absent_key, index_types={c: table[0].column(c).index_types
                                            for c in table[0].column_names})

    t0 = time.perf_counter()
    null_cols = ssb.make_columns(INDEX_NULL_ROWS, args.seed + 4)
    null = np.zeros(INDEX_NULL_ROWS, dtype=bool)
    null[np.random.default_rng(args.seed + 4).choice(
        INDEX_NULL_ROWS, int(INDEX_NULL_ROWS * INDEX_NULL_FRACTION), replace=False)] = True
    stored = null_cols["lo_revenue"].astype(object)
    stored[null] = None
    null_table = [load_segment(SegmentBuilder(schema).build(
        dict(null_cols, lo_revenue=stored), os.path.join(work, "nulls"), "lineorder_0"))]
    log("index_null_data", rows=INDEX_NULL_ROWS, nulls=int(null.sum()),
        build_s=time.perf_counter() - t0)

    mx = MeshQueryExecutor()
    launches = counts_of()
    by_route = {}

    def served(segs, sql):
        ctx = compile_query(sql, segs[0].schema)
        pipeline = DeviceQueryPipeline(mesh_exec=mx)
        try:
            partial = pipeline.execute_partial(ctx, segs)
        finally:
            pipeline.stop()
        aggs = [make_agg(f) for f in ctx.aggregations]
        return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                                list(ctx.group_by))

    routes = {"per_segment": lambda segs, sql: execute_query(segs, sql),
              "set": lambda segs, sql: mx.execute(segs, sql),
              "pipeline": served}

    def checked(qid, sql, segs, want, bitmap_per_pass, grouped_per_pass=0):
        """Each route: one cold run with the counts set to 0 just before and
        read just after, held against the oracle and the expected launches (no
        scan; `bitmap_per_pass` bitmap_filter and `grouped_per_pass`
        grouped_agg launches for each segment's pass, or for the set's one
        pass); INDEX_RUNS warm runs on the per-segment and set routes."""
        for route, run in routes.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            result = run(segs, sql)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if not index_rows_match(result.rows, want):
                raise AssertionError(f"index {qid} ({route}): got {result.rows}, "
                                     f"oracle {want}")
            passes = len(segs) if route == "per_segment" else 1
            expect = counts_of(bitmap_filter=bitmap_per_pass * passes,
                               grouped_agg=grouped_per_pass * passes)
            if counts != expect:
                raise AssertionError(f"index {qid} ({route}): launches {counts}, expected "
                                     f"{expect}")
            for k, v in counts.items():
                launches[k] += v
                by_route.setdefault(route, {}).setdefault(k, 0)
                by_route[route][k] += v
            fields = dict(query=qid, route=route, rows=sum(s.num_docs for s in segs),
                          answer=result.rows[:10], oracle=want[:10], launches=counts,
                          cold_ms=cold_ms)
            if route != "pipeline":
                warm, results = warm_times(lambda: run(segs, sql), runs=INDEX_RUNS)
                warm.pop("median_s")
                phases = [r.stats["phaseTimesMs"] for r in results]
                fields.update(warm, phase_median_ms={
                    k: statistics.median(p[k] for p in phases) for k in phases[0]})
            log("index_query", **fields)

    # one bitmap_filter launch a pass where the filter reads bitmap leaves:
    # the all-bitmap tree, the mixed tree's one bitmap leaf (lo_discount
    # BETWEEN 1 AND 3 and lo_discount < 4 are denser than the cap); one
    # grouped_agg launch a pass of a GROUP BY (a star plan's slot query over
    # the record table, or the stacked record tables, included)
    # 1. STAR_QUERY from the small tree on every segment, beside phase 4's plain table
    ctx = compile_query(ssb.STAR_QUERY, schema)
    fits = [try_star_tree(ctx, s) for s in table]
    if any(p is None or p.tree.dims != ["lo_region", "lo_discount"] for p in fits):
        raise AssertionError("STAR_QUERY: not every segment's plan is a star plan on the "
                             "[lo_region, lo_discount] tree")
    checked("star_query", ssb.STAR_QUERY, table, oracles["star_query"], 0, 1)
    checked("star_query_plain_table", ssb.STAR_QUERY, plain_table, oracles["star_query"],
            0, 1)
    # 2. the high-cardinality tree: the stacked device star path over the set
    plan, _ = mx._plan_for_set(compile_query(INDEX_HC_QUERY, schema), table)
    if not isinstance(plan, combine.StarSetPlan):
        raise AssertionError(f"star_hc: the set plan is {type(plan).__name__}, not the "
                             "stacked device star path")
    checked("star_hc", INDEX_HC_QUERY, table, oracles["star_hc"], 0, 1)
    # 3. the all-bitmap tree; 4. a mixed tree
    checked("all_bitmap", INDEX_BITMAP_QUERY, table, oracles["all_bitmap"], 1, 1)
    checked("mixed", INDEX_MIXED_QUERY, table, oracles["mixed"], 1)
    # 5. IN_ID_SET over the raw column (a doc-set leaf); 6. bloom-pruned EQ
    checked("in_id_set_raw", INDEX_IDSET_QUERY.format(literal), table,
            oracles["in_id_set_raw"], 0, 1)
    pruned = INDEX_ABSENT_QUERY.format(pruned_key)
    ctx = compile_query(pruned, schema)
    kinds = [planner.plan_segment(ctx, s).kind for s in table]
    want = ["empty" if not s.column("lo_custkey").bloom_filter.might_contain(pruned_key)
            else "device" for s in table]
    if kinds != want or "empty" not in kinds:
        raise AssertionError(f"bloom_pruned: plans {kinds}, expected {want}")
    log("index_bloom_pruned", key=pruned_key, plans=kinds)
    checked("bloom_pruned", pruned, table, oracles["bloom_pruned"], 0)
    absent = INDEX_ABSENT_QUERY.format(absent_key)
    ctx = compile_query(absent, schema)
    kinds = [planner.plan_segment(ctx, s).kind for s in table]
    if kinds != ["empty"] * len(table):
        raise AssertionError(f"absent_key: plans {kinds}, expected every segment empty")
    checked("absent_key", absent, table, [[0, None]], 0)
    # 7. a selection whose host mask reads the inverted postings
    ctx = compile_query(INDEX_HOST_MASK_SELECT, schema)
    plan = planner.plan_segment(ctx, table[0])
    postings = [leaf.col for leaf in plan.filter_prog.leaves
                if hasattr(leaf, "lut") and table[0].column(leaf.col).inverted_index
                .match_count_for_ids(np.flatnonzero(leaf.lut)) * 8 <= table[0].num_docs]
    if not plan.fallback_reason or postings != ["lo_quantity", "lo_discount"]:
        raise AssertionError(f"host_mask_select: reason {plan.fallback_reason!r}, "
                             f"postings leaves {postings}")
    log("index_host_mask", reason=plan.fallback_reason, postings_leaves=postings)
    checked("host_mask_select", INDEX_HOST_MASK_SELECT, table, oracles["host_mask_select"], 0)
    # 8. IS NULL / IS NOT NULL over the null table
    for qid, sql in INDEX_NULL_QUERIES.items():
        checked(qid, sql, null_table, null_oracles(null_cols, null)[qid], 0)

    # the kernel against its plain version at the path's shapes
    cases = bitmap_cases(block_for(table[0], mx.device), mx._block_for(table))

    # crossovers: bitmap leaves against LUT/interval leaves, and the set's
    # per-segment star loop against the stacked device star path
    def regime_ms(run, runs=INDEX_CROSSOVER_RUNS):
        run()
        torch.cuda.synchronize()
        warm, results = warm_times(run, runs=runs)
        return warm["warm_median_ms"], results[0].rows

    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.query.executor import ServerQueryExecutor
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=mx.device)
    seg0, block0 = table[0], block_for(table[0], mx.device)
    saved_cap = planner.BITMAP_SEL_CAP
    try:
        for (tree, shape), q in itertools.product(INDEX_CROSSOVER_TREES.items(),
                                                  INDEX_CROSSOVER_QUANTITIES):
            sql = shape.format(q=q)
            numbers, answers = {}, []
            for regime, cap in (("bitmap", 1.0), ("lut", 0.0)):
                planner.BITMAP_SEL_CAP = cap
                for route in ("per_segment", "set"):
                    ms, rows = regime_ms(lambda: routes[route](table, sql))
                    numbers[f"{regime}_{route}_ms"] = ms
                    answers.append(rows)
                # the filter alone on one segment: the row mask from the bitmap
                # kernel, or from the id compares; an eager call (host
                # overhead included) and its device time (graph replay)
                plan = planner.plan_segment(compile_query(sql, schema), seg0)
                plan.bitmap_leaves = planner.select_bitmap_leaves(plan, seg0)
                spec = kernels.KernelSpec(plan.filter_prog, (), 1, (),
                                          bitmap_leaves=plan.bitmap_leaves)
                inputs = ServerQueryExecutor(mx.device)._kernel_inputs(plan, spec, block0)

                def mask(spec=spec, inputs=inputs):
                    return kernels.filter_mask(spec, inputs)
                numbers[f"{regime}_mask_ms"] = time_ms(mask, flush)
                numbers[f"{regime}_mask_device_ms"] = graph_ms(mask, flush)
                numbers[f"{regime}_leaves"] = len(plan.bitmap_leaves)
            if any(not index_rows_match(a, answers[0]) for a in answers):
                raise AssertionError(f"crossover {tree} lo_quantity <= {q}: the regimes "
                                     "disagree")
            log("crossover", kind="bitmap_vs_lut", tree=tree, query=sql, selectivity=q / 50,
                **numbers)
    finally:
        planner.BITMAP_SEL_CAP = saved_cap
    for qid, sql in (("star_query", ssb.STAR_QUERY), ("star_hc", INDEX_HC_QUERY)):
        # the set's two star regimes: the per-segment executor's loop over the
        # trees, and the stacked pass over the record tables
        numbers, answers = {}, []
        for regime, run in (("loop", lambda: mx._fallback.execute(table, sql)),
                            ("stacked", lambda: mx.execute(table, sql))):
            ms, rows = regime_ms(run)
            numbers[f"{regime}_ms"] = ms
            answers.append(rows)
        if not index_rows_match(answers[0], answers[1]):
            raise AssertionError(f"crossover {qid}: the star regimes disagree")
        log("crossover", kind="star_loop_vs_stacked", query=qid,
            records=sum(p.tree.num_records for p in
                        mx._star_fit_plans(compile_query(sql, schema), table)), **numbers)
    return launches, by_route, cases


# -- phase 12: search -------------------------------------------------------------

# 4 segments of 131,072 rows: the deployment's 2,097,152 halved twice, because
# the JSON and text builds are Python per document: the indexed table's build
# passes 90 s at 2,097,152 rows, and at 1,048,576 the phase put the smoke past
# its time limit (PERF.md)
SEARCH_ROWS = 524_288
SEARCH_SEGMENTS = 4
SEARCH_RUNS = 5                  # warm runs of each query on the indexed table
SEARCH_VIEW_ROWS = 262_144       # rows pumped into the consuming segment
SEARCH_RAW = ["lo_extendedprice", "lo_revenue", "lo_lng", "lo_lat"]
SEARCH_INDEXES = dict(json_index_columns=["lo_payload"], text_index_columns=["lo_comment"],
                      fst_index_columns=["lo_custname"], geo_index_pairs=["lo_lng,lo_lat"])
SEARCH_RADII_M = (1_000.0, 10_000.0, 100_000.0)
# a distance this close to the radius may compare either way in f32 (the
# device narrows the coordinates to f32: ~1.1 m at 180 degrees)
SEARCH_GEO_BAND_M = 10.0
SEARCH_SOURCE = ("Apache Pinot docs: JSON index, Text search support, FST index, "
                 "Geospatial (H3 index), Forward index (raw compressionCodec)")


def search_masks(c) -> dict:
    """The row masks of the search queries' filters, from Python's json over
    the payloads and re over the comments and names: no index code."""
    import re
    from pinot_tpu_torch import ssb
    n = len(c["lo_revenue"])
    docs = [json.loads(d) for d in c["lo_payload"]]

    def rows(pred):
        return np.fromiter(map(pred, docs), dtype=bool, count=n)

    def comment(word_rx):
        rx = re.compile(r"(?:^| )(?:%s)(?: |$)" % word_rx)
        return np.fromiter((rx.search(s) is not None for s in c["lo_comment"]),
                           dtype=bool, count=n)
    names, inverse = np.unique(c["lo_custname"].astype(str), return_inverse=True)
    name_rx = re.compile(ssb.SEARCH_CUSTNAME_REGEX)
    term = comment(re.escape(ssb.SEARCH_TERM))
    return {
        "json_type": rows(lambda d: d["type"] == "PushEvent"),
        "json_array_range": rows(lambda d: "t3" in d["tags"] and d["qty"] > 40),
        "json_presence": rows(lambda d: "org" in d["actor"]),
        "text_term": term,
        "text_or": term | comment(re.escape(ssb.SEARCH_PHRASE)),
        "text_prefix": comment(re.escape(ssb.SEARCH_PREFIX) + "[a-z0-9_]*"),
        "text_regex": comment(ssb.SEARCH_REGEX),
        "regexp_fst": np.array([name_rx.search(s) is not None for s in names])[inverse],
    }


def search_answers(c, m) -> dict:
    """numpy float64 answers of `ssb.SEARCH_QUERIES` (but the distance query)
    from the masks of `search_masks`."""
    from pinot_tpu_torch.ssb import REGIONS
    rev = c["lo_revenue"]

    def count_sum(mask):
        return [[int(mask.sum()), float(rev[mask].sum()) if mask.any() else None]]
    term = m["text_term"]
    top = np.nonzero(term)[0]
    top = top[np.argsort(-rev[top], kind="stable")][:10]
    out = {qid: count_sum(m[qid]) for qid in ("json_type", "json_array_range",
                                              "json_presence", "text_prefix",
                                              "text_regex", "regexp_fst")}
    out.update(
        text_or=[[r, int((m["text_or"] & (c["lo_region"] == r)).sum()),
                  float(rev[m["text_or"] & (c["lo_region"] == r)].sum())]
                 for r in sorted(REGIONS) if (m["text_or"] & (c["lo_region"] == r)).any()],
        text_not=count_sum(~m["text_or"]),
        text_mixed=count_sum(term & (c["lo_discount"] == 2)),
        text_select=[[int(c["lo_custkey"][i]), float(rev[i])] for i in top])
    return out


def stored_points(c, schema):
    """lo_lng, lo_lat as the table stores them: a null as the column's null value."""
    return [np.array([schema.field_spec(col).null_value if v is None else v for v in c[col]],
                     dtype=np.float64) for col in ("lo_lng", "lo_lat")]


def haversine_m(lng, lat, lng0, lat0):
    """Great-circle distance in metres, float64 (the mean Earth radius of the
    reference's ST_DISTANCE)."""
    p1, p2 = np.radians(lat), math.radians(lat0)
    a = (np.sin((p2 - p1) / 2) ** 2
         + np.cos(p1) * math.cos(p2) * np.sin(np.radians(lng0 - lng) / 2) ** 2)
    return 2 * 6371008.8 * np.arcsin(np.sqrt(np.minimum(a, 1.0)))


def build_search_table(rows: int, segments: int, seed: int, out: str) -> tuple:
    """In a worker process: the search table with its JSON, text, FST and geo
    indexes, an inverted index on lo_discount and its raw columns
    zlib-compressed, each index builder timed inside the writer. Returns
    (paths, generate s, build s, build s by index)."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment import writer
    from pinot_tpu_torch.segment.indexes import geo
    t0 = time.perf_counter()
    cols = ssb.make_search_columns(rows, seed)
    gen_s = time.perf_counter() - t0
    build_s = {}
    for module, name, kind in ((writer, "create_json_index", "json"),
                               (writer, "create_text_index", "text"),
                               (writer, "create_fst_index", "fst"),
                               (geo, "create_geo_index", "geo"),
                               (writer, "write_chunked", "compression")):
        def clocked(*a, _real=getattr(module, name), _kind=kind, **k):
            t = time.perf_counter()
            out = _real(*a, **k)
            build_s[_kind] = build_s.get(_kind, 0.0) + time.perf_counter() - t
            return out
        setattr(module, name, clocked)   # this worker's modules only
    t0 = time.perf_counter()
    paths = writer.build_aligned_segments(
        ssb.search_schema(), cols, out, "lineorder", segments, writer.SegmentGeneratorConfig(
            inverted_index_columns=["lo_discount"], no_dictionary_columns=SEARCH_RAW,
            raw_compression="zlib", **SEARCH_INDEXES))
    return paths, gen_s, time.perf_counter() - t0, build_s


def build_search_copy(rows: int, segments: int, seed: int, out: str) -> tuple:
    """In a worker process: the search table's copy without the search
    indexes and without compression, from the same seed, with the oracle's
    masks and the stored points over its rows. Returns (paths, build s,
    masks, oracle s, (lng, lat))."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    cols = ssb.make_search_columns(rows, seed)
    t0 = time.perf_counter()
    paths = build_aligned_segments(ssb.search_schema(), cols, out, "lineorder", segments,
                                   SegmentGeneratorConfig(inverted_index_columns=["lo_discount"],
                                                          no_dictionary_columns=SEARCH_RAW))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    masks = search_masks(cols)
    return (paths, build_s, masks, time.perf_counter() - t0,
            stored_points(cols, ssb.search_schema()))


def build_for_zlib(main_rows: int, for_rows: int, seed: int, out: str) -> tuple:
    """In a worker process: phase 4's FOR table (its first `for_rows` rows,
    lo_quantity raw) with its raw columns zlib-compressed. Returns (paths,
    build s)."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    cols = {k: v[:for_rows] for k, v in ssb.make_columns(main_rows, seed).items()}
    t0 = time.perf_counter()
    paths = build_aligned_segments(ssb.ssb_schema(), cols, out, "lineorder", FOR_SEGMENTS,
                                   SegmentGeneratorConfig(no_dictionary_columns=["lo_quantity"],
                                                          raw_compression="zlib"))
    return paths, time.perf_counter() - t0


def make_search_view_rows(rows: int, seed: int) -> tuple:
    """In a worker process: the consuming segment's rows as JSON row messages
    (the JSON lane: the block codec carries no JSON column) and the oracle's
    masks over them. Returns (messages, masks)."""
    from pinot_tpu_torch import ssb
    schema, cols = ssb.search_schema(), ssb.make_search_columns(rows, seed)
    names = [f.name for f in schema.fields]
    messages = [json.dumps(dict(zip(names, row)))
                for row in zip(*[cols[n].tolist() for n in names])]
    return messages, search_masks(cols)


def start_search_builds(pool, args, work) -> dict:
    """Submit phase 12's builds to `pool` (worker processes): the indexed
    search table, its copy with the oracle's masks, phase 4's FOR table with
    zlib, and the consuming rows. They are Python-bound; the smoke submits
    them when it starts, so that they run beside the earlier phases, and
    phase 12 waits for what is not done. Returns the futures by name."""
    return {
        "table": pool.submit(build_search_table, SEARCH_ROWS, SEARCH_SEGMENTS, args.seed + 5,
                             os.path.join(work, "search")),
        "copy": pool.submit(build_search_copy, SEARCH_ROWS, SEARCH_SEGMENTS, args.seed + 5,
                            os.path.join(work, "search_copy")),
        "for_zlib": pool.submit(build_for_zlib, args.rows, FOR_ROWS, args.seed,
                                os.path.join(work, "for_zlib")),
        "view": pool.submit(make_search_view_rows, SEARCH_VIEW_ROWS, args.seed + 6)}


def run_search(args, main_cols, for_table, work, jobs) -> tuple:
    """Phase 12: the search indexes. lineorder from --seed + 5 with a JSON
    payload, a comment, a customer name and a point, built with JSON, text,
    FST and geo indexes, an inverted index on lo_discount and its raw columns
    chunk-compressed with zlib; and a copy without the search indexes and
    without compression. Each query per segment, over the set and through the
    pipeline on both, against numpy and against each other, each checked run
    held to its exact launches; the distance predicate at three radii;
    REGEXP_LIKE's LUT from the FST index against the copy's; Q1.1 over the
    compressed table and the FOR query over phase 4's FOR table rebuilt with
    zlib; then 262,144 rows pumped into a staged consuming segment, queried
    alone and beside the table. The tables, the oracle's masks and the
    consuming rows come from `jobs` (`start_search_builds`). Returns
    (launches of the checked runs by kernel, launches by route)."""
    from pinot_tpu_torch import execute_query, load_segment, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query import predicate
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.segment import compression
    from pinot_tpu_torch.segment.indexes.fst import required_literals
    from pinot_tpu_torch.table import StreamConfig, TableConfig

    schema = ssb.search_schema()
    t0 = time.perf_counter()
    paths, gen_s, table_s, build_s = jobs["table"].result()
    copy_paths, copy_s, masks, oracle_s, (lng, lat) = jobs["copy"].result()
    for_paths, for_s = jobs["for_zlib"].result()
    waited_s = time.perf_counter() - t0
    table = [load_segment(p) for p in paths]
    copy = [load_segment(p) for p in copy_paths]
    for_zlib = [load_segment(p) for p in for_paths]
    cols = ssb.make_columns(SEARCH_ROWS, args.seed + 5)   # the search table's base columns

    def sizes(segs, suffix):
        return sum(os.path.getsize(os.path.join(s.path, "cols", f)) for s in segs
                   for f in os.listdir(os.path.join(s.path, "cols")) if f.endswith(suffix))
    compressed = {c: sizes(table, f"{c}.fwdc.bin") for c in SEARCH_RAW}
    raw_bytes = {c: sizes(copy, f"{c}.fwd.npy") for c in SEARCH_RAW}
    log("search_data", rows=SEARCH_ROWS, segments=SEARCH_SEGMENTS, seed=args.seed + 5,
        source=SEARCH_SOURCE, generate_s=gen_s,
        index_types={c: table[0].column(c).index_types for c in table[0].column_names
                     if table[0].column(c).index_types},
        geo_indexes=table[0].metadata.get("geoIndexes"))
    for kind, suffix in (("json", ".json.npz"), ("text", ".text.npz"), ("fst", ".fst.npz"),
                         ("geo", ".geo.npz")):
        log("search_build", index=kind, build_s=build_s.get(kind, 0.0),
            index_bytes=sizes(table, suffix))
    log("search_build", index="compression", codec="zlib", build_s=build_s["compression"],
        compressed_bytes=compressed, raw_bytes=raw_bytes,
        ratio={c: raw_bytes[c] / compressed[c] for c in SEARCH_RAW})
    log("search_build", index="all", table_build_s=table_s, copy_build_s=copy_s,
        for_table_zlib_build_s=for_s, waited_for_workers_s=waited_s,
        for_compressed_columns=[c for c in for_zlib[0].column_names
                                if for_zlib[0].column(c).meta.get("compression")])
    answers = search_answers(cols, masks)
    log("search_oracle", seconds=oracle_s, matches={k: int(v.sum()) for k, v in masks.items()})

    mx = MeshQueryExecutor()
    launches = counts_of()
    by_route = {}

    def served(segs, sql):
        ctx = compile_query(sql, segs[0].schema)
        pipeline = DeviceQueryPipeline(mesh_exec=mx)
        try:
            partial = pipeline.execute_partial(ctx, segs)
        finally:
            pipeline.stop()
        aggs = [make_agg(f) for f in ctx.aggregations]
        return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                                list(ctx.group_by))

    routes = {"per_segment": lambda segs, sql: execute_query(segs, sql),
              "set": lambda segs, sql: mx.execute(segs, sql),
              "pipeline": served}
    zlib_calls = [0]
    codec = compression.CODECS["zlib"]

    def counted_decompress(blob, _real=codec[1]):
        zlib_calls[0] += 1
        return _real(blob)
    compression.CODECS["zlib"] = (codec[0], counted_decompress)

    def checked(label, qid, sql, segs, want, per_pass, set_pass=None, runs=SEARCH_RUNS):
        """Each route: one cold run with the counts set to 0 just before and
        read just after, held against `want` and the expected launches
        (`per_pass` for each segment's pass, `set_pass` (default: the same)
        for the set's one pass); `runs` warm runs on the per-segment and set
        routes, which must decompress no chunk. Returns each route's rows."""
        plan = plan_segment(compile_query(sql, segs[0].schema), segs[0])
        got = {}
        for route, run in routes.items():
            reset_launch_counts()
            zlib_calls[0] = 0
            t0 = time.perf_counter()
            result = run(segs, sql)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if not (want(result.rows) if callable(want) else index_rows_match(result.rows, want)):
                raise AssertionError(f"search {qid} on the {label} ({route}): got "
                                     f"{result.rows}, oracle {want}")
            one = per_pass if route == "per_segment" else (set_pass or per_pass)
            passes = len(segs) if route == "per_segment" else 1
            expect = {k: v * passes for k, v in one.items()}
            if counts != expect:
                raise AssertionError(f"search {qid} on the {label} ({route}): launches "
                                     f"{counts}, expected {expect}")
            for k, v in counts.items():
                launches[k] += v
                by_route.setdefault(route, counts_of())[k] += v
            fields = dict(query=qid, table=label, route=route,
                          rows=sum(s.num_docs for s in segs), plan=plan.kind,
                          leaves=[type(leaf).__name__ for leaf in plan.filter_prog.leaves],
                          answer=result.rows[:10], launches=counts, cold_ms=cold_ms,
                          cold_decompress_calls=zlib_calls[0])
            if route != "pipeline" and runs:
                zlib_calls[0] = 0
                warm, results = warm_times(lambda: run(segs, sql), runs=runs)
                warm.pop("median_s")
                if zlib_calls[0]:
                    raise AssertionError(f"search {qid} ({route}): warm runs decompressed "
                                         f"{zlib_calls[0]} chunks")
                phases = [r.stats["phaseTimesMs"] for r in results]
                fields.update(warm, phase_median_ms={
                    k: statistics.median(p[k] for p in phases) for k in phases[0]})
            log("search_query", **fields)
            got[route] = result.rows
        return got

    def both(qid, sql, want, per_pass=None, set_pass=None):
        """The query on the indexed table (warm runs too) and on the copy
        (cold runs): equal answers, equal launches."""
        per_pass = per_pass or counts_of()
        ours = checked("table", qid, sql, table, want, per_pass, set_pass)
        theirs = checked("copy", qid, sql, copy, want, per_pass, set_pass, runs=0)
        for route in ours:
            if not index_rows_match(ours[route], theirs[route]):
                raise AssertionError(f"search {qid} ({route}): the table answers "
                                     f"{ours[route]}, the copy {theirs[route]}")

    try:
        # 1-2. JSON_MATCH; 3-5. TEXT_MATCH (the mixed tree's lo_discount = 2
        # leaf is a bitmap leaf: one bitmap_filter launch a pass; text_or's
        # GROUP BY one grouped_agg launch a pass)
        for qid, sql in ssb.SEARCH_QUERIES.items():
            if qid in ("regexp_fst", "geo_distance"):
                continue
            both(qid, sql, answers[qid], counts_of(bitmap_filter=int(qid == "text_mixed"),
                                                   grouped_agg=int(qid == "text_or")))
        # 6. REGEXP_LIKE through the FST index: the copy's LUT, fewer regex calls
        sql = ssb.SEARCH_QUERIES["regexp_fst"]
        luts = [plan_segment(compile_query(sql, schema), s[0]).filter_prog.leaves[0].lut
                for s in (table, copy)]
        if not np.array_equal(luts[0], luts[1]):
            raise AssertionError("regexp_fst: the FST index's LUT differs from the copy's")
        reader = table[0].column("lo_custname")
        lut_ms = {}
        for how, fst in (("fst", reader.fst_index), ("scan", None)):
            t0 = time.perf_counter()
            predicate.build_lut("regexp_like", [ssb.SEARCH_CUSTNAME_REGEX],
                                reader.dictionary, reader.cardinality, fst_index=fst)
            lut_ms[how] = (time.perf_counter() - t0) * 1e3
        cands = reader.fst_index.candidate_ids(ssb.SEARCH_CUSTNAME_REGEX)
        log("search_regex", pattern=ssb.SEARCH_CUSTNAME_REGEX,
            required_literals=required_literals(ssb.SEARCH_CUSTNAME_REGEX),
            dictionary=reader.cardinality, candidates=int(len(cands)),
            matches=int(luts[0].sum()), lut_ms=lut_ms)
        both("regexp_fst", sql, answers["regexp_fst"])
        # 7. the distance predicate: the geo cell candidates (a superset of the
        # exact matches) ANDed with the exact compare, and the compare alone
        null_lng = schema.field_spec("lo_lng").null_value
        i0 = int(np.flatnonzero(lng != null_lng)[0])   # the first stored point
        x, y = float(lng[i0]), float(lat[i0])
        dist = haversine_m(lng, lat, x, y)
        for r in SEARCH_RADII_M:
            sql = ssb.SEARCH_QUERIES["geo_distance"].format(lng=repr(x), lat=repr(y), r=r)
            lo, hi = (int((dist < r + d).sum()) for d in (-SEARCH_GEO_BAND_M, SEARCH_GEO_BAND_M))
            candidates, bounds = 0, [0]
            for s in table:
                bounds.append(bounds[-1] + s.num_docs)
                cand = s.geo_index("lo_lng", "lo_lat").candidate_mask(x, y, r, s.num_docs)
                if (dist[bounds[-2]:bounds[-1]] < r + SEARCH_GEO_BAND_M)[~cand].any():
                    raise AssertionError(f"geo r={r}: a match lies outside the candidates")
                candidates += int(cand.sum())
            got = {label: checked(label, f"geo_{r:g}m", sql, segs,
                                  lambda rows: len(rows) == 1 and lo <= rows[0][0] <= hi,
                                  counts_of(), runs=SEARCH_RUNS if label == "table" else 0)
                   for label, segs in (("table", table), ("copy", copy))}
            if got["table"] != got["copy"]:
                raise AssertionError(f"geo r={r}: the table counts {got['table']}, the copy "
                                     f"{got['copy']}")
            log("search_geo", radius_m=r, center=[x, y], candidates=candidates,
                exact=int((dist < r).sum()), band=[lo, hi], counts=got["table"])
        # 8. the compressed raw columns keep their scan routes: Q1.1 over the
        # search table, the FOR query over phase 4's FOR table rebuilt with zlib
        both("q1_1_compressed", ssb.QUERY, oracle_q11(cols), counts_of(masked_sums=1))
        for_cols = {k: v[:FOR_ROWS] for k, v in main_cols.items()}
        got = [checked(label, "for_sum", ssb.FOR_QUERY, segs, oracle_for(for_cols),
                       counts_of(masked_sums_fused=1), counts_of(masked_sums=1),
                       runs=SEARCH_RUNS if label == "for_zlib" else 0)
               for label, segs in (("for_zlib", for_zlib), ("for_table", for_table))]
        if any(not index_rows_match(got[0][route], got[1][route]) for route in got[0]):
            raise AssertionError(f"for_sum: the zlib table answers {got[0]}, phase 4's {got[1]}")
    finally:
        compression.CODECS["zlib"] = codec

    # 9. a staged consuming segment, alone and beside the table
    messages, rt_masks = jobs["view"].result()
    rt = ssb.make_columns(SEARCH_VIEW_ROWS, args.seed + 6)   # its base columns
    MemoryStream.reset_all()
    stream = MemoryStream.create("lineorder_search", 1)
    for msg in messages:
        stream.produce(msg, partition=0)
    consumer = RealtimePartitionConsumer(
        "lineorder__0__0__20261017T0000Z", TableConfig("lineorder", stream=StreamConfig(
            topic="lineorder_search", decoder="json",
            properties={"realtime.ingest.device.staging": "true"})), schema, 0, work)
    t0 = time.perf_counter()
    while consumer.mutable.num_docs < SEARCH_VIEW_ROWS:
        if not consumer.pump():
            raise AssertionError(f"the pump stopped at {consumer.mutable.num_docs} rows")
    pump_s = time.perf_counter() - t0
    view = consumer.query_segment()
    rt_answers = search_answers(rt, rt_masks)
    both_cols = {k: np.concatenate([cols[k], rt[k]]) for k in cols}
    both_answers = search_answers(both_cols, {k: np.concatenate([masks[k], rt_masks[k]])
                                             for k in masks})
    for qid in ("json_type", "text_or"):
        sql = ssb.SEARCH_QUERIES[qid]
        plan, merged = mx._plan_for_set(compile_query(sql, schema), table + [view])
        if qid == "text_or" and (plan, merged) != (None, None):
            raise AssertionError("text_or over the table and the view: the set did not take "
                                 "the per-segment pre-bail")
        # text_or's GROUP BY: one grouped_agg launch a pass; beside the table
        # the set and the pipeline take the per-segment pre-bail, a pass a member
        grouped = int(qid == "text_or")
        checked("view", qid, sql, [view], rt_answers[qid], counts_of(grouped_agg=grouped))
        checked("table_and_view", qid, sql, table + [view], both_answers[qid],
                counts_of(grouped_agg=grouped),
                counts_of(grouped_agg=grouped * (len(table) + 1)) if grouped else None)
        log("search_consuming", query=qid, view_rows=view.num_docs, pump_s=pump_s,
            set_plan="per-segment pre-bail" if plan is None else type(plan).__name__ + (
                " (merged view)" if merged is not None else " (stacked)"))
    consumer.mutable.release_device()
    return launches, by_route


# -- phase 13: mv ------------------------------------------------------------------------

MV_ROWS = 4_194_304              # cut from bench.py's 16,777,216 rows (PERF.md section 4)
MV_SEGMENTS = 4
MV_RUNS = 5                      # warm runs of each device-routed query and route
MV_VIEW_ROWS = 262_144           # rows pumped into the consuming segment
MV_CONFIG = dict(inverted_index_columns=["lo_tags", "lo_discount"],
                 bloom_filter_columns=["lo_codes"])
MV_SOURCE = ("Apache Pinot docs: Schema (multi-value dimension fields, singleValueField "
             "false), Filtering on multi-value columns, Aggregation functions (*MV)")
MV_HLL_REL = 0.05               # DISTINCTCOUNTHLLMV (p = 12) against the exact count
# the checked runs' launches by query, a pass: Q1.1 takes the scan, the mixed
# tree's lo_discount = 2 (1/11 of the rows) is a bitmap leaf, the rest none
MV_PASS_LAUNCHES = {"q1_1": dict(masked_sums=1), "mixed": dict(bitmap_filter=1)}
MV_HOST = ("group_tags", "mv_aggs", "arraylength")       # host-routed: per segment
MV_VIEW_QUERIES = ("tags_eq", "not_eq", "codes_band_tags_in", "mixed", "group_tags")


def build_mv_table(rows: int, segments: int, seed: int, out: str) -> tuple:
    """In a worker process: the multi-value lineorder table (`ssb.make_mv_columns`)
    in `segments` aligned segments with MV_CONFIG's indexes. Returns (paths,
    generate s, build s)."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    t0 = time.perf_counter()
    cols = ssb.make_mv_columns(rows, seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = build_aligned_segments(ssb.mv_schema(), cols, out, "lineorder", segments,
                                   SegmentGeneratorConfig(**MV_CONFIG))
    return paths, gen_s, time.perf_counter() - t0


def make_mv_view_rows(rows: int, seed: int) -> list:
    """In a worker process: the consuming segment's rows as JSON row messages
    (the block codec carries no multi-value column)."""
    from pinot_tpu_torch import ssb
    cols = ssb.make_mv_columns(rows, seed)
    names = [f.name for f in ssb.mv_schema().fields]
    lists = [cols[n] if isinstance(cols[n], list) else cols[n].tolist() for n in names]
    return [json.dumps(dict(zip(names, row))) for row in zip(*lists)]


def start_mv_builds(pool, args, work) -> dict:
    """Submit phase 13's table build and consuming rows to `pool`."""
    return {"table": pool.submit(build_mv_table, MV_ROWS, MV_SEGMENTS, args.seed + 7,
                                 os.path.join(work, "mv")),
            "view": pool.submit(make_mv_view_rows, MV_VIEW_ROWS, args.seed + 8)}


def csr_any(hits: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """bool per row of a CSR column: does any of its values hit? (a row
    without values: no)"""
    cs = np.zeros(len(hits) + 1, dtype=np.int64)
    np.cumsum(hits, out=cs[1:])
    return cs[offsets[1:]] > cs[offsets[:-1]]


def mv_oracles(c, csr) -> dict:
    """Every `ssb.MV_QUERIES` answer from numpy over the base columns and the
    multi-value columns' CSR arrays, with the JAX package's semantics: a row
    matches if any of its values does, NOT negates the row, an empty tag row
    holds the one value "null", a GROUP BY counts a row once per value."""
    from pinot_tpu_torch import ssb
    tags, tag_off = csr["lo_tags"]
    codes, code_off = csr["lo_codes"]
    tag_counts = np.diff(tag_off)
    rev = c["lo_revenue"]

    def count_sum(m):
        return [[int(m.sum()), float(rev[m].sum())]]
    has = {k: csr_any(tags == k, tag_off) for k in (0, 1, 3, 7)}
    out = {
        "tags_eq": count_sum(has[3]),
        "codes_band_tags_in": count_sum(csr_any((codes >= 100) & (codes <= 180), code_off)
                                        & (has[1] | has[7])),
        "not_eq": count_sum(~has[0]),
        "neq": count_sum(~has[0]),
        "mixed": count_sum((c["lo_discount"] == 2) & has[3]),
        "q1_1": oracle_q11(c),
        "arraylength": count_sum(np.maximum(tag_counts, 1) >= 2),
    }
    row_of_tag = np.repeat(np.arange(len(tag_counts)), tag_counts)
    groups = {f"t{k}": (int(n), float(w)) for k, (n, w) in enumerate(zip(
        np.bincount(tags, minlength=ssb.MV_TAGS),
        np.bincount(tags, weights=rev[row_of_tag], minlength=ssb.MV_TAGS))) if n}
    empty = tag_counts == 0
    if empty.any():
        groups["null"] = (int(empty.sum()), float(rev[empty].sum()))
    out["group_tags"] = [[k, n, w] for k, (n, w) in sorted(groups.items())][:30]
    flat = codes.astype(np.float64)
    out["mv_aggs"] = [[len(codes), float(flat.sum()), float(flat.min()), float(flat.max()),
                       float(flat.mean()), int(len(np.unique(codes))), None,
                       float(np.percentile(flat, 50))]]
    hit = np.flatnonzero(csr_any(codes == 7, code_off))[:10]
    out["selection"] = [[int(c["lo_orderkey"][i]),
                         [f"t{k}" for k in tags[tag_off[i]:tag_off[i + 1]]] or ["null"]]
                        for i in hit]
    return out


def mv_answer_ok(qid: str, got, want) -> bool:
    """`want` held exactly where it is a count, at the smoke's tolerances on
    sums; DISTINCTCOUNTHLLMV within MV_HLL_REL of the exact distinct count."""
    if qid != "mv_aggs":
        return rows_match(got, want)
    if len(got) != 1 or len(got[0]) != len(want[0]):
        return False
    hll, exact = got[0][6], want[0][5]
    return abs(hll - exact) <= MV_HLL_REL * exact and rows_match(
        [got[0][:6] + got[0][7:]], [want[0][:6] + want[0][7:]])


def mv_cases(table, mx) -> dict:
    """The any-value mask alone (torch: the JAX body's multi-value branch),
    by graph replay with L2 flushed, for one-interval leaves (`lo_tags =
    't3'`, `lo_codes BETWEEN 100 AND 180`) and a LUT gather (nine scattered
    tags), on one segment's block and the stacked set's, against the bound of
    its bytes: the [P, W] int32 ids read once and P bool rows written."""
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.executor import mask_spec
    from pinot_tpu_torch.query.planner import plan_segment
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=mx.device)
    out = {}
    for qid, col, where in (("tags_eq", "lo_tags", "lo_tags = 't3'"),
                            ("tags_in9", "lo_tags", "lo_tags IN ('t1', 't3', 't5', 't7', 't9', "
                                                    "'t11', 't13', 't15', 't17')"),
                            ("codes_band", "lo_codes", "lo_codes BETWEEN 100 AND 180")):
        sql = f"SELECT lo_orderkey FROM lineorder WHERE {where} LIMIT 10"
        plan = plan_segment(compile_query(sql, table[0].schema), table[0])
        spec = mask_spec(plan)
        block = block_for(table[0], mx.device)
        stacked = mx._block_for(table)
        inputs = {"one segment": mx._fallback._kernel_inputs(plan, spec, block),
                  "stacked set": mx._set_inputs(plan, spec, stacked, plan.ctx)}
        for shape, ins in inputs.items():
            ids = ins.ids[col]
            p, w = ids.shape
            mask = kernels.filter_mask(spec, ins)
            torch.cuda.synchronize()
            bound_ms, bound_by = roofline(p * w * 4 + p, p * w * 2)
            ms = graph_ms(lambda: kernels.filter_mask(spec, ins), flush)
            numbers = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                           rows=int(p), width=int(w), matches=int(mask.sum()),
                           leaf="interval" if plan.filter_prog.leaves[0].intervals else "lut")
            log("mv_case", query=qid, shape=shape, **numbers)
            out[f"{qid}, {shape}"] = numbers
    del flush
    torch.cuda.empty_cache()
    return out


def run_mv(args, work, jobs) -> tuple:
    """Phase 13: multi-value columns. lineorder from --seed + 7 (4,194,304
    rows in 4 aligned segments) with a STRING multi-value lo_tags, an INT
    multi-value lo_codes and a unique lo_orderkey, inverted indexes on lo_tags
    and lo_discount and a bloom filter on lo_codes, built in a worker the
    smoke starts first. `ssb.MV_QUERIES` per segment, over the set and through
    the pipeline (host-routed ones per segment and over the set), each against
    numpy over the CSR arrays, each checked cold run held to its exact
    launches; then 262,144 JSON rows (seed + 8) pumped into a staged
    consuming segment, queried alone and beside the table; then `mv_case`
    lines. Returns (launches of the checked runs by kernel, launches by
    route, the mask cases)."""
    from pinot_tpu_torch import execute_query, load_segment, ssb
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.table import StreamConfig, TableConfig

    schema = ssb.mv_schema()
    t0 = time.perf_counter()
    paths, gen_s, build_s = jobs["table"].result()
    waited_s = time.perf_counter() - t0
    table = [load_segment(p) for p in paths]
    t0 = time.perf_counter()
    cols = dict(ssb.make_columns(MV_ROWS, args.seed + 7))
    cols["lo_orderkey"] = np.arange(1, MV_ROWS + 1, dtype=np.int32)
    csr = ssb.make_mv_csr(MV_ROWS, args.seed + 7)
    answers = mv_oracles(cols, csr)
    oracle_s = time.perf_counter() - t0
    tags = table[0].column("lo_tags")
    log("mv_data", rows=MV_ROWS, segments=MV_SEGMENTS, seed=args.seed + 7, source=MV_SOURCE,
        generate_s=gen_s, build_s=build_s, waited_for_worker_s=waited_s, oracle_s=oracle_s,
        values={c: int(len(csr[c][0])) for c in csr},
        max_num_values={c: [s.column(c).max_num_values for s in table] for c in csr},
        cardinality={c: table[0].column(c).cardinality for c in csr},
        index_types={c: table[0].column(c).index_types for c in table[0].column_names
                     if table[0].column(c).index_types},
        id_matrix_bytes=sum(s.num_docs * max(s.column(c).max_num_values, 1) * 4
                            for s in table for c in csr),
        null_rows=int(tags.null_bitmap.sum()) if tags.null_bitmap is not None else 0)

    mx = MeshQueryExecutor()
    launches = counts_of()
    by_route = {}

    served_stats = {}

    def served(segs, sql):
        ctx = compile_query(sql, segs[0].schema)
        pipeline = DeviceQueryPipeline(mesh_exec=mx)
        try:
            partial = pipeline.execute_partial(ctx, segs)
            served_stats["last"] = pipeline.stats()
        finally:
            pipeline.stop()
        aggs = [make_agg(f) for f in ctx.aggregations]
        return reduce_to_result(ctx, merge_segment_results([partial], aggs), aggs,
                                list(ctx.group_by))

    all_routes = {"per_segment": lambda segs, sql: execute_query(segs, sql),
                  "set": lambda segs, sql: mx.execute(segs, sql),
                  "pipeline": served}

    def checked(label, qid, segs, want, per_pass, runs, routes=tuple(all_routes),
                passes=None):
        """Each route: one cold run with the counts set to 0 just before and
        read just after, held against `want` and `per_pass` launches a pass
        (a segment's pass on the per-segment route, the set's one pass on the
        others; `passes` overrides the passes of every route); then `runs`
        warm runs on the per-segment and set routes."""
        sql = ssb.MV_QUERIES[qid]
        plan = plan_segment(compile_query(sql, schema), segs[0])
        for route in routes:
            run = all_routes[route]
            reset_launch_counts()
            t0 = time.perf_counter()
            result = run(segs, sql)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if not mv_answer_ok(qid, result.rows, want):
                raise AssertionError(f"mv {qid} on the {label} ({route}): got "
                                     f"{result.rows[:10]}, oracle {want[:10]}")
            n = passes if passes is not None else (len(segs) if route == "per_segment" else 1)
            expect = counts_of(**{k: v * n for k, v in per_pass.items()})
            if counts != expect:
                raise AssertionError(f"mv {qid} on the {label} ({route}): launches {counts}, "
                                     f"expected {expect}")
            for k, v in counts.items():
                launches[k] += v
                by_route.setdefault(route, counts_of())[k] += v
            fields = dict(query=qid, table=label, route=route,
                          rows=sum(s.num_docs for s in segs), plan=plan.kind,
                          reason=plan.fallback_reason, answer=result.rows[:5],
                          launches=counts, cold_ms=cold_ms)
            if route == "pipeline":
                fields["pipeline_stage_ms"] = served_stats.pop("last", {}).get("stageMs")
            if route != "pipeline" and runs:
                warm, results = warm_times(lambda: run(segs, sql), runs=runs)
                warm.pop("median_s")
                stats = [r.stats.get("phaseTimesMs") for r in results]
                fields.update(warm, phase_median_ms={
                    k: statistics.median(p[k] for p in stats) for k in stats[0]}
                    if stats[0] else None)
            log("mv_query", **fields)

    for qid in ssb.MV_QUERIES:
        per_pass = MV_PASS_LAUNCHES.get(qid, {})
        if qid in MV_HOST:
            plan, _ = mx._plan_for_set(compile_query(ssb.MV_QUERIES[qid], schema), table)
            if plan is None or plan.kind != "host":
                raise AssertionError(f"mv {qid}: the set plans {plan and plan.kind}, not host")
            checked("table", qid, table, answers[qid], per_pass, 0, ("per_segment", "set"))
        else:
            checked("table", qid, table, answers[qid], per_pass, MV_RUNS)
    # an MV-filtered device plan over the aligned set stacks the [S, rows, W] ids
    plan, view = mx._plan_for_set(compile_query(ssb.MV_QUERIES["tags_eq"], schema), table)
    if plan is None or plan.kind != "device" or view is not None:
        raise AssertionError("mv tags_eq: the aligned set did not plan one stacked pass")

    # a staged consuming segment, alone and beside the table
    messages = jobs["view"].result()
    rt = dict(ssb.make_columns(MV_VIEW_ROWS, args.seed + 8))
    rt["lo_orderkey"] = np.arange(1, MV_VIEW_ROWS + 1, dtype=np.int32)
    rt_csr = ssb.make_mv_csr(MV_VIEW_ROWS, args.seed + 8)
    MemoryStream.reset_all()
    stream = MemoryStream.create("lineorder_mv", 1)
    for msg in messages:
        stream.produce(msg, partition=0)
    consumer = RealtimePartitionConsumer(
        "lineorder__0__0__20261101T0000Z", TableConfig("lineorder", stream=StreamConfig(
            topic="lineorder_mv", decoder="json",
            properties={"realtime.ingest.device.staging": "true"})), schema, 0, work)
    t0 = time.perf_counter()
    while consumer.mutable.num_docs < MV_VIEW_ROWS:
        if not consumer.pump():
            raise AssertionError(f"the pump stopped at {consumer.mutable.num_docs} rows")
    pump_s = time.perf_counter() - t0
    view = consumer.query_segment()
    rt_answers = mv_oracles(rt, rt_csr)
    both_cols = {k: np.concatenate([cols[k], rt[k]]) for k in ("lo_revenue", "lo_discount")}
    both_csr = {c: (np.concatenate([csr[c][0], rt_csr[c][0]]),
                    np.concatenate([csr[c][1], csr[c][1][-1] + rt_csr[c][1][1:]]))
                for c in csr}
    both_cols.update({k: np.concatenate([cols[k], rt[k]]) for k in cols if k not in both_cols})
    both_answers = mv_oracles(both_cols, both_csr)
    for qid in MV_VIEW_QUERIES:
        # the view's lo_discount is a raw column (no bitmap leaf); beside the
        # table every route answers per segment, the table's segments
        # launching as on the per-segment route (a host-routed query: that
        # route alone)
        table_pass = MV_PASS_LAUNCHES.get(qid, {})
        checked("view", qid, [view], rt_answers[qid], {}, 0, ("per_segment", "set"))
        checked("table_and_view", qid, table + [view], both_answers[qid], table_pass, 0,
                ("per_segment",) if qid in MV_HOST else tuple(all_routes), passes=len(table))
    log("mv_consuming", view_rows=view.num_docs, pump_s=pump_s,
        rows_per_s=view.num_docs / pump_s,
        max_num_values={c: view.column(c).max_num_values for c in csr})
    consumer.mutable.release_device()
    cases = mv_cases(table, mx)
    return launches, by_route, cases


# -- phase 14: upsert ------------------------------------------------------------------

UPSERT_EVENTS = 1_048_576        # FULL: events (PERF.md section 4; cut from 2,097,152
UPSERT_KEYS = 262_144            # events and 524,288 keys and flush rows for the cluster
UPSERT_FLUSH = 262_144           # phase); rows a segment commits at (3 committed, 1 consuming)
UPSERT_PARTIAL = (262_144, 65_536, 131_072)    # PARTIAL: events, keys, flush rows
UPSERT_DEDUP = (262_144, 131_072)              # dedup: events, flush rows
UPSERT_UPDATES = 65_536          # updates pumped after the queries, to committed keys
UPSERT_RUNS = 5                  # warm runs of each query
UPSERT_PUMP = 10_000             # messages a pump (the consumer's default)
UPSERT_CONFIG = dict(inverted_index_columns=["lo_region", "lo_discount"],
                     no_dictionary_columns=["lo_tax"])
UPSERT_STRATEGIES = {"lo_quantity": "INCREMENT", "lo_revenue": "MAX",
                     "lo_discount": "OVERWRITE", "lo_orderdate": "IGNORE"}
UPSERT_SOURCE = ("Apache Pinot docs: Stream ingestion with Upsert (upsertConfig mode FULL "
                 "and PARTIAL, primaryKeyColumns, comparisonColumn, partialUpsertStrategies), "
                 "Stream ingestion with Dedup (dedupEnabled)")
# the checked runs' launches a committed segment, by query (the consuming
# segment launches none): the scans carry the valid band, lo_discount = 2
# (1/11 of the rows) is a bitmap leaf, each GROUP BY one grouped_agg launch,
# the top-k no kernel; the dedup table has no mask, and its Q1.1 takes the
# scan without the band
UPSERT_LAUNCHES = {"count": dict(masked_sums=1), "q1_1": dict(masked_sums=1),
                   "group": dict(grouped_agg=1), "for_sum": dict(masked_sums_fused=1),
                   "bitmap_group": dict(bitmap_filter=1, grouped_agg=1),
                   "region_asia": dict(masked_sums=1)}
UPSERT_TABLE_QUERIES = {
    "full": ("count", "q1_1", "group", "for_sum", "bitmap_group", "region_asia", "top_revenue"),
    "partial": ("count", "q1_1", "partial_sums"),
    "dedup": ("q1_1", "text"),
}


def make_upsert_messages(kind: str, seed: int) -> list:
    """In a worker process: one table's stream as JSON row messages."""
    from pinot_tpu_torch import ssb
    return ssb.json_messages(upsert_events(kind, seed), ssb.upsert_schema(kind == "dedup"))


def upsert_events(kind: str, seed: int) -> dict:
    from pinot_tpu_torch import ssb
    if kind == "full":
        return ssb.make_upsert_events(UPSERT_EVENTS, UPSERT_KEYS, seed)
    if kind == "partial":
        return ssb.make_partial_events(UPSERT_PARTIAL[0], UPSERT_PARTIAL[1], seed)
    return ssb.make_dedup_events(UPSERT_DEDUP[0], seed)


def start_upsert_builds(pool, args) -> dict:
    """Submit phase 14's three streams' messages to `pool`."""
    return {kind: pool.submit(make_upsert_messages, kind, args.seed + 9 + i)
            for i, kind in enumerate(("full", "partial", "dedup"))}


def live_events(kind: str, c) -> np.ndarray:
    """numpy: the index of each key's live event, ascending. FULL: an event is
    accepted when its lo_ts is at least the running maximum of its key's
    earlier events (a stable sort by key, then np.maximum.accumulate), and
    the live event is the key's last accepted one; PARTIAL: the key's last
    event; dedup: its first."""
    key = np.asarray(c["lo_orderkey"], dtype=np.int64)
    n = len(key)
    order = np.argsort(key, kind="stable")
    k = key[order]
    first = np.ones(n, dtype=bool)
    first[1:] = k[1:] != k[:-1]
    last = np.ones(n, dtype=bool)
    last[:-1] = k[1:] != k[:-1]
    if kind == "dedup":
        return np.sort(order[first])
    if kind == "partial":
        return np.sort(order[last])
    ts = np.asarray(c["lo_ts"], dtype=np.int64)[order]
    shifted = (k << 42) + (ts - ts.min())          # one ascending run per key
    prev = np.empty(n, dtype=np.int64)
    prev[0] = -1
    prev[1:] = np.maximum.accumulate(shifted)[:-1]
    accepted = first | (shifted >= prev)
    acc_idx, acc_key = order[accepted], k[accepted]
    last_acc = np.ones(len(acc_idx), dtype=bool)
    last_acc[:-1] = acc_key[1:] != acc_key[:-1]
    return np.sort(acc_idx[last_acc])


def partial_rows(c) -> dict:
    """The PARTIAL table's live rows, replayed in plain Python: each key's
    row merged column by column (UPSERT_STRATEGIES, OVERWRITE for the rest)
    over its events in arrival order. Columns of the live rows, by key."""
    names = [k for k in c if k != "lo_orderkey"]
    cols = {k: c[k].tolist() for k in names}
    merged = {}
    for i, key in enumerate(c["lo_orderkey"].tolist()):
        prev = merged.get(key)
        if prev is None:
            merged[key] = {k: cols[k][i] for k in names}
            continue
        for k in names:
            new = cols[k][i]
            s = UPSERT_STRATEGIES.get(k, "OVERWRITE")
            prev[k] = (prev[k] + new if s == "INCREMENT" else max(prev[k], new) if s == "MAX"
                       else prev[k] if s == "IGNORE" else new)
    keys = sorted(merged)
    out = {k: np.array([merged[key][k] for key in keys],
                       dtype=object if k == "lo_region" else None) for k in names}
    out["lo_orderkey"] = np.array(keys)
    return out


def upsert_oracles(c) -> dict:
    """Every phase-14 query's answer from numpy over the live rows `c`."""
    import re
    from pinot_tpu_torch import ssb
    rev = c["lo_revenue"]
    n = len(rev)
    m = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3)
    asia = c["lo_region"] == "ASIA"
    d2 = c["lo_discount"] == 2
    top = np.argsort(-rev, kind="stable")[:10]
    out = {"count": [[n]], "q1_1": oracle_q11(c), "group": oracle_group(c),
           "for_sum": [[float(c["lo_tax"][m].astype(np.float64).sum()), int(m.sum())]],
           "bitmap_group": [[r, float(rev[d2 & (c["lo_region"] == r)].sum()),
                             int((d2 & (c["lo_region"] == r)).sum())]
                            for r in sorted(ssb.REGIONS) if (d2 & (c["lo_region"] == r)).any()],
           "region_asia": [[int(asia.sum()), float(rev[asia].sum())]],
           "top_revenue": [[int(c["lo_orderkey"][i]), float(rev[i])] for i in top],
           "partial_sums": [[n, float(c["lo_quantity"].astype(np.float64).sum()),
                             float(rev.sum()), float(rev.max()),
                             float(c["lo_discount"].astype(np.float64).sum()),
                             float(c["lo_orderdate"].min()), float(c["lo_orderdate"].max())]]}
    if "lo_comment" in c:
        rx = re.compile(r"(?:^| )%s(?: |$)" % re.escape(ssb.SEARCH_TERM))
        t = np.fromiter((rx.search(s) is not None for s in c["lo_comment"]), dtype=bool, count=n)
        out["text"] = [[int(t.sum()), float(rev[t].sum()) if t.any() else None]]
    return out


def consume_table(kind, schema, cfg, messages, work, up=None, dedup=None, partial=None):
    """Produce `messages` to a MemoryStream and pump them through the per-row
    lane, committing each segment at the flush threshold (`build_immutable`,
    `load_segment`, and a consumer with the next LLC name and start offset)
    while events remain. Returns (committed segments, the consuming
    consumer, pump s, add_record s, commit s each)."""
    from pinot_tpu_torch import load_segment
    from pinot_tpu_torch.ingest.realtime import RealtimePartitionConsumer
    from pinot_tpu_torch.ingest.stream import MemoryStream
    stream = MemoryStream.create(cfg.stream.topic, 1)
    for msg in messages:
        stream.produce(msg, partition=0)
    spent = [0.0]
    if up is not None:   # the time add_record takes, summed
        pm = up.partition(0)
        inner = pm.add_record

        def timed(*a):
            t = time.perf_counter()
            try:
                return inner(*a)
            finally:
                spent[0] += time.perf_counter() - t
        pm.add_record = timed
    flush = cfg.stream.flush_threshold_rows
    committed, commit_s = [], []

    def consumer(seq, offset):
        return RealtimePartitionConsumer(f"lineorder__0__{seq}__20261201T0000Z", cfg, schema,
                                         offset, work, upsert=up, dedup=dedup,
                                         partial_rows=partial)
    c = consumer(0, 0)
    pump_s = 0.0
    while c.offset < len(messages):
        t0 = time.perf_counter()
        c.pump(max_messages=min(UPSERT_PUMP, flush - c.mutable.num_docs))
        pump_s += time.perf_counter() - t0
        if c.last_decode_path != "row":
            raise AssertionError(f"{kind}: the pump took the {c.last_decode_path} lane")
        if c.end_criteria_reached() and c.offset < len(messages):
            t0 = time.perf_counter()
            committed.append(load_segment(c.build_immutable()))
            commit_s.append(time.perf_counter() - t0)
            c = consumer(len(committed), c.offset)
    if up is not None:
        del pm.add_record
    return committed, c, pump_s, spent[0], commit_s


def banded_cases(seg, up, schema) -> dict:
    """Each scan with the valid band on one committed segment (Q1.1's three
    bands and its f32 operand: 20 B/row; the FOR sum's lo_discount band and
    u8 deltas: 9 B/row) against its plain version, by graph replay with L2
    flushed, against its bound; beside it the same scan without the band."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.executor import ServerQueryExecutor, scan_route
    from pinot_tpu_torch.query.planner import plan_segment
    ex = ServerQueryExecutor()
    block = block_for(seg, ex.device)
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=ex.device)
    out = {}
    for qid in ("q1_1", "for_sum"):
        plan = plan_segment(compile_query(ssb.UPSERT_QUERIES[qid], schema), seg,
                            valid_docs=up.valid_mask(seg.name, seg.num_docs))
        route = scan_route(plan)
        cols, bands, operands = ex.scan_inputs(plan, route, block)
        for shape, args in (("banded", (cols, bands, operands)),
                            ("unbanded", (cols[:-1], bands[:-1], operands))):
            numbers = scan_case(route, args, flush)
            numbers["bytes_per_row"] = sum(t.element_size() for t in args[0]) + sum(
                (t if route == "masked_sums" else t[1]).element_size() for t in operands)
            log("upsert_case", kernel=route, query=qid, shape=shape, **numbers)
            out[f"{qid}, {shape}"] = numbers
    del flush
    torch.cuda.empty_cache()
    return out


def run_upsert(args, work, jobs) -> tuple:
    """Phase 14: upsert and dedup. Three tables after Apache Pinot's upsert
    and dedup pages (`ssb.upsert_schema`: lineorder with lo_orderkey the
    primary key, lo_ts the event time, lo_tax raw; inverted indexes on
    lo_region and lo_discount), their JSON rows through the consumer's
    per-row lane into MutableSegments, committed at their flush thresholds:
    a FULL table (1,048,576 events over 262,144 keys drawn zipf(1.2),
    comparisonColumn lo_ts with 2% late events; 3 committed segments and a
    consuming one of 262,144 rows), a PARTIAL one (262,144 events over 65,536
    keys, four strategies) and a dedup one (262,144 events, 25% re-sent, a
    text index on lo_comment). Each query through `execute_query(...,
    upsert=)` against numpy over the live rows, each checked cold run held
    to its exact launches (the scans carry the valid band on every committed
    segment), 5 warm runs; the realtime postings and TEXT_MATCH on the
    consuming segments; then 65,536 updates to committed keys and Q1.1 again;
    then `upsert_case` lines. Returns (launches by kernel, the banded cases)."""
    from pinot_tpu_torch import execute_query, ssb
    from pinot_tpu_torch.engine.datablock import block_for
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.query.executor import resolve_device
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.table import IndexingConfig, StreamConfig, TableConfig, UpsertConfig
    from pinot_tpu_torch.upsert import PartitionDedupMetadataManager, TableUpsertMetadataManager

    launches = counts_of()
    MemoryStream.reset_all()

    def checked(kind, qid, segs, up, want, n_committed, runs=UPSERT_RUNS, label="table"):
        sql = ssb.UPSERT_QUERIES[qid]
        reset_launch_counts()
        t0 = time.perf_counter()
        result = execute_query(segs, sql, upsert=up)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if not rows_match(result.rows, want):
            raise AssertionError(f"upsert {kind} {qid} ({label}): got {result.rows[:10]}, "
                                 f"oracle {want[:10]}")
        per_pass = UPSERT_LAUNCHES.get(qid, {})
        expect = counts_of(**{k: v * n_committed for k, v in per_pass.items()})
        if counts != expect:
            raise AssertionError(f"upsert {kind} {qid} ({label}): launches {counts}, "
                                 f"expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        fields = dict(table=kind, query=qid, segments=label, answer=result.rows[:3],
                      launches=counts, cold_ms=cold_ms)
        if runs:
            warm, results = warm_times(lambda: execute_query(segs, sql, upsert=up), runs=runs)
            warm.pop("median_s")
            stats = [r.stats["phaseTimesMs"] for r in results]
            fields.update(warm, phase_median_ms={k: statistics.median(p[k] for p in stats)
                                                 for k in stats[0]})
        log("upsert_query", **fields)
        return result

    tables, first = {}, {}
    for i, kind in enumerate(("full", "partial", "dedup")):
        seed = args.seed + 9 + i
        schema = ssb.upsert_schema(comment=kind == "dedup")
        flush = {"full": UPSERT_FLUSH, "partial": UPSERT_PARTIAL[2], "dedup": UPSERT_DEDUP[1]}
        idx = dict(UPSERT_CONFIG, text_index_columns=["lo_comment"] if kind == "dedup" else [])
        up_cfg = {"full": UpsertConfig("FULL", "lo_ts"),
                  "partial": UpsertConfig("PARTIAL", partial_strategies=UPSERT_STRATEGIES)}
        cfg = TableConfig("lineorder", stream=StreamConfig(
            topic=f"lineorder_{kind}", flush_threshold_rows=flush[kind]),
            indexing=IndexingConfig(**idx), upsert=up_cfg.get(kind), dedup_enabled=kind == "dedup")
        up = TableUpsertMetadataManager() if kind != "dedup" else None
        t0 = time.perf_counter()
        messages = jobs[kind].result()
        waited_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = upsert_events(kind, seed)
        live = live_events(kind, events)
        rows = partial_rows(events) if kind == "partial" else \
            {k: v[live] for k, v in events.items()}
        answers = upsert_oracles(rows)
        oracle_s = time.perf_counter() - t0
        committed, consumer, pump_s, add_s, commit_s = consume_table(
            kind, schema, cfg, messages, work, up=up,
            dedup=PartitionDedupMetadataManager() if kind == "dedup" else None,
            partial={} if kind == "partial" else None)
        del messages
        cons = consumer.query_segment()
        if not isinstance(cons, MutableSegment):
            raise AssertionError(f"{kind}: the consuming segment is a {type(cons).__name__}")
        segs = committed + [cons]
        log("upsert_ingest", table=kind, source=UPSERT_SOURCE, seed=seed,
            events=len(events["lo_ts"]), keys=int(len(np.unique(events["lo_orderkey"]))),
            live_rows=len(live), waited_for_worker_s=waited_s, oracle_s=oracle_s,
            pump_s=pump_s, rows_per_s=len(events["lo_ts"]) / pump_s, add_record_s=add_s,
            add_record_share=add_s / pump_s, commit_s=commit_s,
            segment_rows=[s.num_docs for s in segs],
            primary_keys=up.partition(0).num_primary_keys if up else None)
        if kind == "full":
            visible = np.concatenate([up.valid_mask(s.name, s.num_docs) for s in segs])
            if not np.array_equal(np.flatnonzero(visible), live):
                raise AssertionError("full: the valid-doc masks are not numpy's live rows")
        for qid in UPSERT_TABLE_QUERIES[kind]:
            first[kind, qid] = checked(kind, qid, segs, up, answers[qid], len(committed)).rows
        tables[kind] = (schema, committed, consumer, up, events, live, seed)

    # the consuming segments alone: host plans, no launch
    schema, committed, consumer, up, events, live, seed = tables["full"]
    cons = consumer.query_segment()
    lo = len(committed) * UPSERT_FLUSH
    cons_rows = {k: v[live[live >= lo]] for k, v in events.items()}
    cons_answers = upsert_oracles(cons_rows)
    for qid in ("q1_1", "region_asia"):
        checked("full", qid, [cons], up, cons_answers[qid], 0, label="consuming")
    reader = cons.column("lo_region")
    t0 = time.perf_counter()
    snap = reader.dict_snapshot()
    view = reader.inverted_view(snap)
    asia = snap[1].index_of("ASIA")
    docs = view.doc_ids_for_ids([asia])
    postings_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(docs, np.flatnonzero(np.asarray(snap[2]) == asia)):
        raise AssertionError("full: the realtime postings of lo_region = 'ASIA' disagree "
                             "with the forward ids")
    d_schema, d_committed, d_consumer, _, d_events, d_live, _ = tables["dedup"]
    d_lo = d_consumer.mutable.num_docs
    d_cons_rows = {k: v[d_live[-d_lo:]] for k, v in d_events.items()}
    checked("dedup", "text", [d_consumer.query_segment()], None,
            upsert_oracles(d_cons_rows)["text"], 0, label="consuming")
    log("upsert_postings", table="full", rows=cons.num_docs, asia_docs=len(docs),
        snapshot_and_postings_ms=postings_ms)

    # updates to keys that live in committed segments, then Q1.1 again
    rng = np.random.default_rng(seed + 100)
    keys = np.unique(events["lo_orderkey"][live[live < lo]])
    upd = ssb.make_update_events(rng.choice(keys, UPSERT_UPDATES), int(events["lo_ts"].max()),
                                 seed + 101)
    before = first["full", "q1_1"]
    stream = MemoryStream.get("lineorder_full")
    for msg in ssb.json_messages(upd, schema):
        stream.produce(msg, partition=0)
    t0 = time.perf_counter()
    while consumer.pump():
        pass
    update_pump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    consumer.mutable.column("lo_region").dict_snapshot()    # the re-sort after growth
    resort_ms = (time.perf_counter() - t0) * 1e3
    staging_ms = []
    for s in committed:     # the band of each segment whose version moved
        mask = up.valid_mask(s.name, s.num_docs)
        block = block_for(s, resolve_device())
        t0 = time.perf_counter()
        block.valid_band(mask)
        torch.cuda.synchronize()
        staging_ms.append((time.perf_counter() - t0) * 1e3)
    all_events = {k: np.concatenate([events[k], upd[k]]) for k in events}
    all_live = live_events("full", all_events)
    after_rows = {k: v[all_live] for k, v in all_events.items()}
    after = checked("full", "q1_1", committed + [consumer.query_segment()], up,
                    upsert_oracles(after_rows)["q1_1"], len(committed), label="after_update")
    if rows_match(after.rows, before):
        raise AssertionError(f"full: Q1.1 did not change after {UPSERT_UPDATES} updates")
    log("upsert_update", updates=UPSERT_UPDATES, pump_s=update_pump_s,
        rows_per_s=UPSERT_UPDATES / update_pump_s, resort_ms=resort_ms,
        band_staging_ms=staging_ms, before=before, after=after.rows,
        versions=[up.version(s.name) for s in committed])
    numbers = banded_cases(committed[0], up, schema)
    return launches, numbers


# -- phase 15: batch ingestion, EXPLAIN, GAPFILL, LOOKUP, preprocess ----------------

BATCH_ROWS = 1_048_576             # the CSV table: 4 files of 262,144 rows (cut from
BATCH_FILES = 4                    # 2,097,152 rows for the cluster phase)
BATCH_SEGMENT_ROWS = 262_144       # the job's segment_rows: one segment a file's worth
BATCH_FILE_ROWS = 262_144          # each single-file table: the generator's first rows
BATCH_FORMATS = ("avro", "thrift", "pb", "json")
BATCH_RUNS = 5                     # warm runs of each device-routed query
BATCH_HOST_RTOL = 1e-9
BATCH_TABLE = "lineorder_OFFLINE"
# the batch table keeps lo_custkey raw (a key the bloom filter prunes); the
# Protobuf table takes phase 4's FOR layout (lo_quantity raw)
BATCH_INDEXING = dict(no_dictionary_columns=["lo_custkey"])
BATCH_FOR_INDEXING = dict(no_dictionary_columns=["lo_quantity"])
BATCH_PRE_INDEXES = dict(inverted_index_columns=["lo_region"], range_index_columns=["lo_quantity"],
                         bloom_filter_columns=["lo_custkey"])
BATCH_DESC = os.path.join("tests", "torch_data", "lineorder.desc")
BATCH_SOURCE = ("Apache Pinot docs: Batch Ingestion (SegmentGenerationJobSpec, recordReaderSpec "
                "csv/json/avro/thrift/protobuf), Stream ingestion, Gapfill Function For "
                "Time-Series Dataset, Lookup UDF Join, Explain Plan")
BATCH_GAPFILL = ("SELECT GAPFILL(lo_orderdate, 19920202, 19920230, 1), lo_region, "
                 "FILL(SUM(lo_revenue), 'FILL_PREVIOUS_VALUE'), "
                 "FILL(COUNT(*), 'FILL_DEFAULT_VALUE', 0) FROM lineorder "
                 "WHERE lo_orderdate BETWEEN 19920202 AND 19920229 AND lo_discount = 2 "
                 "AND lo_quantity < 3 GROUP BY lo_orderdate, lo_region LIMIT 1000")
BATCH_LOOKUP = ("SELECT LOOKUP('{dim}', 'c_nation', 'c_custkey', lo_custkey), SUM(lo_revenue) "
                "FROM lineorder WHERE lo_discount = 2 AND lo_quantity < 10 "
                "GROUP BY LOOKUP('{dim}', 'c_nation', 'c_custkey', lo_custkey) LIMIT 100")
BATCH_PRE_QUERIES = {
    "q1_1": None,     # ssb.QUERY
    "group": None,    # ssb.GROUP_QUERY
    "region_band": ("SELECT lo_region, COUNT(*), SUM(lo_revenue) FROM lineorder "
                    "WHERE lo_region = 'ASIA' AND lo_quantity BETWEEN 5 AND 9 "
                    "GROUP BY lo_region"),
    "absent_key": "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_custkey = {key}",
}


def _batch_explain_rows(segments: int) -> dict:
    """The EXPLAIN rows of Q1.1 and GROUP_QUERY over `segments` segments that
    plan alike: each a device plan whose filter is dictionary-id bands."""
    seg = f"SEGMENT_PLAN(segments:{segments})"
    band = "FILTER_DICT_ID_INTERVALS(column={})"
    return {
        "q1_1": [["BROKER_REDUCE(limit:10)", 0, -1], ["COMBINE_AGGREGATE", 1, 0], [seg, 2, 1],
                 ["DEVICE_FUSED_AGGREGATE(aggregations:sum)", 3, 2], ["FILTER_AND", 4, 3],
                 [band.format("lo_orderdate"), 5, 4], [band.format("lo_discount"), 6, 4],
                 [band.format("lo_quantity"), 7, 4]],
        "group": [["BROKER_REDUCE(sort:[lo_region], limit:10)", 0, -1],
                  ["COMBINE_GROUP_BY", 1, 0], [seg, 2, 1],
                  ["DEVICE_FUSED_GROUP_BY(keys:lo_region; aggregations:sum, count; "
                   "denseKeys:5)", 3, 2], ["FILTER_AND", 4, 3],
                  [band.format("lo_discount"), 5, 4], [band.format("lo_quantity"), 6, 4]]}


def make_batch_file(fmt: str, seed: int, lo: int, hi: int, path: str, desc_path: str) -> tuple:
    """In a worker process: rows [lo, hi) of the batch generator as one `fmt`
    file with the port's writers (and the reader's sidecar). Returns (path,
    seconds)."""
    from pinot_tpu_torch import ssb
    t0 = time.perf_counter()
    cols = {k: v[lo:hi] for k, v in ssb.make_columns(BATCH_ROWS, seed).items()}
    desc = open(desc_path, "rb").read() if fmt == "pb" else b""
    ssb.write_lineorder_file(fmt, cols, path, descriptor_set=desc)
    return path, time.perf_counter() - t0


def build_batch_indexed(seed: int, out: str) -> tuple:
    """In a worker process: the batch table's rows built with the indexes that
    `preprocess_segment` adds, from the start (the preprocessed copies are
    held to its launches). Returns (paths, seconds)."""
    from pinot_tpu_torch import ssb
    from pinot_tpu_torch.segment.writer import SegmentGeneratorConfig, build_aligned_segments
    t0 = time.perf_counter()
    paths = build_aligned_segments(ssb.ssb_schema(), ssb.make_columns(BATCH_ROWS, seed), out,
                                   "lineorder", BATCH_FILES,
                                   SegmentGeneratorConfig(**BATCH_INDEXING, **BATCH_PRE_INDEXES))
    return paths, time.perf_counter() - t0


def start_batch_builds(pool, args, work) -> dict:
    """Submit phase 15's files to `pool` (the 4 CSV files of the batch table
    and the four single-file tables), and the batch table built with the
    preprocess indexes from the start."""
    seed = args.seed + 12
    out = os.path.join(work, "batch_files")
    os.makedirs(out, exist_ok=True)
    desc = os.path.join(os.path.dirname(os.path.abspath(__file__)), BATCH_DESC)
    per_file = BATCH_ROWS // BATCH_FILES
    jobs = {f"csv_{i}": pool.submit(make_batch_file, "csv", seed, i * per_file,
                                    (i + 1) * per_file, os.path.join(out, f"lineorder_{i}.csv"),
                                    desc) for i in range(BATCH_FILES)}
    for fmt in BATCH_FORMATS:
        jobs[fmt] = pool.submit(make_batch_file, fmt, seed, 0, BATCH_FILE_ROWS,
                                os.path.join(out, f"lineorder.{fmt}"), desc)
    jobs["indexed"] = pool.submit(build_batch_indexed, seed, os.path.join(work, "batch_built"))
    return jobs


class BatchController:
    """The controller `run_batch_ingestion` pushes to (the port ships none
    yet): the table's config and schema, and an upload that copies the
    segment directory it is handed (the runner then removes its own) and
    loads it."""

    class _Catalog:
        def __init__(self, cfg, schema):
            self.table_configs = {BATCH_TABLE: cfg}
            self.schemas = {cfg.name: schema}

    def __init__(self, cfg, schema, store: str):
        self.catalog = self._Catalog(cfg, schema)
        self.store = store
        self.segments = []
        os.makedirs(store, exist_ok=True)

    def upload_segment(self, table, seg_dir):
        from pinot_tpu_torch import load_segment
        dst = os.path.join(self.store, os.path.basename(seg_dir))
        shutil.copytree(seg_dir, dst)
        self.segments.append(load_segment(dst))
        return self.segments[-1]


def gapfill_oracle(c) -> tuple:
    """BATCH_GAPFILL by numpy and the reference's fill rules: the series in
    first-seen order are not asserted (the set path merges its groups in
    another order), so the rows come keyed by (day, region), with the
    number of cells rows filled."""
    m = ((c["lo_orderdate"] >= 19920202) & (c["lo_orderdate"] <= 19920229)
         & (c["lo_discount"] == 2) & (c["lo_quantity"] < 3))
    cells = {}
    for d, r, v in zip(c["lo_orderdate"][m].tolist(), c["lo_region"][m].tolist(),
                       c["lo_revenue"][m].tolist()):
        s, n = cells.get((d, r), (0.0, 0))
        cells[(d, r)] = (s + v, n + 1)
    out = {}
    for region in {r for _, r in cells}:
        prev = None
        for day in range(19920202, 19920230):
            if (day, region) in cells:
                prev, n = cells[(day, region)]
                out[(day, region)] = (prev, n)
            else:
                out[(day, region)] = (prev, 0)
    return out, len(cells), int(m.sum())


def gapfill_matches(rows, oracle) -> bool:
    if len(rows) != len(oracle) or len({(d, r) for d, r, _, _ in rows}) != len(rows):
        return False
    for d, r, s, n in rows:
        ws, wn = oracle.get((d, r), (None, -1))
        if n != wn or (s is None) != (ws is None):
            return False
        if s is not None and not math.isclose(s, ws, rel_tol=ORACLE_RTOL, abs_tol=ORACLE_ATOL):
            return False
    return True


def lookup_oracle(c, nation, keys: int) -> list:
    """BATCH_LOOKUP by numpy over a dimension table of customers [0, keys):
    revenue per nation, misses under None; sorted by nation, None last."""
    m = (c["lo_discount"] == 2) & (c["lo_quantity"] < 10)
    key = c["lo_custkey"][m]
    rev = c["lo_revenue"][m]
    out = []
    hit = key < keys
    for n in sorted(set(nation[key[hit]].tolist())):
        g = hit & (nation[np.minimum(key, keys - 1)] == n)
        out.append([n, float(rev[g].sum())])
    if (~hit).any():
        out.append([None, float(rev[~hit].sum())])
    return out


def _by_key(rows) -> list:
    return sorted(rows, key=lambda r: (r[0] is None, r[0] or ""))


def run_batch(args, work, jobs) -> tuple:
    """Phase 15: batch ingestion and the query surface a user meets first.
    See the module docstring. Returns (launches by kernel, numbers)."""
    from pinot_tpu_torch import execute_query, load_segment, ssb
    from pinot_tpu_torch.ingest import batch
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query import stats as qstats
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.lookup import REGISTRY, register_dim_table_from_segments
    from pinot_tpu_torch.query.planner import plan_segment
    from pinot_tpu_torch.segment.preprocess import preprocess_segment
    from pinot_tpu_torch.segment.writer import build_aligned_segments
    from pinot_tpu_torch.table import IndexingConfig, TableConfig

    seed = args.seed + 12
    schema = ssb.ssb_schema()
    launches = counts_of()
    numbers = {}
    mx = MeshQueryExecutor()

    def checked(label, run, want, expect, runs=BATCH_RUNS, match=None, **extra):
        reset_launch_counts()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        ok = match(result) if match is not None else rows_match(result.rows, want)
        if not ok:
            raise AssertionError(f"batch {label}: got {result.rows[:12]}, oracle {str(want)[:600]}")
        if counts != expect:
            raise AssertionError(f"batch {label}: launches {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        fields = dict(query=label, answer=result.rows[:4], launches=counts, cold_ms=cold_ms,
                      **extra)
        if runs:
            warm, results = warm_times(run, runs=runs)
            warm.pop("median_s")
            fields.update(warm)
            stats = [r.stats.get("phaseTimesMs") for r in results]
            if all(stats):
                fields["phase_median_ms"] = {k: statistics.median(p[k] for p in stats)
                                             for k in stats[0]}
        log("batch_query", **fields)
        return result

    # -- the files (written by the workers); the ingestion records its reads' seconds
    t0 = time.perf_counter()
    paths = {k: f.result() for k, f in jobs.items() if k != "indexed"}
    waited_s = time.perf_counter() - t0
    cols = ssb.make_columns(BATCH_ROWS, seed)
    first = {k: v[:BATCH_FILE_ROWS] for k, v in cols.items()}
    csvs = [paths[f"csv_{i}"][0] for i in range(BATCH_FILES)]

    # -- the streaming runner: 4 CSV files -> 4 aligned segments
    cfg = TableConfig("lineorder", indexing=IndexingConfig(**BATCH_INDEXING))
    ctl = BatchController(cfg, schema, os.path.join(work, "batch_store"))
    with qstats.collect_stats() as job_stats:
        t0 = time.perf_counter()
        pushed = batch.run_batch_ingestion(batch.BatchIngestionJobSpec(
            input_paths=csvs, table=BATCH_TABLE, segment_rows=BATCH_SEGMENT_ROWS,
            aligned_dictionaries=True), ctl, work_dir=os.path.join(work, "batch_job"))
        job_s = time.perf_counter() - t0
    job = job_stats.counters
    reads = {"csv": (job[qstats.BATCH_READ_MS] / 1e3, job[qstats.BATCH_ROWS_READ])}
    # -- one file, one segment: each format through the per-file unit
    tables, built_s = {}, {}
    for fmt in BATCH_FORMATS:
        fcfg = TableConfig("lineorder", indexing=IndexingConfig(
            **(BATCH_FOR_INDEXING if fmt == "pb" else {})))
        with qstats.collect_stats() as file_stats:
            t0 = time.perf_counter()
            dirs = batch.ingest_file_to_segments(
                schema, fcfg, paths[fmt][0], segment_rows=BATCH_FILE_ROWS, prefix=f"lo_{fmt}",
                build_dir=os.path.join(work, "batch_files_built"))
            built_s[fmt] = time.perf_counter() - t0
        reads[fmt] = (file_stats.counters[qstats.BATCH_READ_MS] / 1e3,
                      file_stats.counters[qstats.BATCH_ROWS_READ])
        tables[fmt] = [load_segment(p) for p in dirs]
    files = {"csv": csvs, **{fmt: [paths[fmt][0]] for fmt in BATCH_FORMATS}}
    written = {"csv": sum(paths[f"csv_{i}"][1] for i in range(BATCH_FILES)),
               **{fmt: paths[fmt][1] for fmt in BATCH_FORMATS}}
    readers = {fmt: dict(rows=n, read_s=s, rows_per_s=n / s,
                         bytes=sum(os.path.getsize(f) for f in files[fmt]),
                         write_s=written[fmt]) for fmt, (s, n) in reads.items()}
    log("batch_readers", source=BATCH_SOURCE, seed=seed, waited_for_workers_s=waited_s,
        readers=readers, csv_note="the CSV rows read: the runner's two passes")
    numbers["readers"] = readers
    table = ctl.segments
    if pushed != [f"lineorder_{i}" for i in range(BATCH_FILES)] or \
            [s.num_docs for s in table] != [BATCH_SEGMENT_ROWS] * BATCH_FILES:
        raise AssertionError(f"batch: pushed {pushed}, rows {[s.num_docs for s in table]}")
    hashes = {s.column("lo_orderdate").meta.get("dictHash") for s in table}
    ingest = dict(files=BATCH_FILES, rows=BATCH_ROWS, segments=len(table), job_s=job_s,
                  stats_pass_s=job[qstats.BATCH_STATS_PASS_MS] / 1e3,
                  write_pass_s=job[qstats.BATCH_WRITE_PASS_MS] / 1e3,
                  push_s=job[qstats.BATCH_PUSH_MS] / 1e3,
                  rows_per_s=BATCH_ROWS / job_s, aligned=len(hashes) == 1 and None not in hashes)
    log("batch_ingest", table="csv", **ingest)
    numbers["ingest"] = ingest

    for fmt in BATCH_FORMATS:
        if [t.num_docs for t in tables[fmt]] != [BATCH_FILE_ROWS]:
            raise AssertionError(f"batch {fmt}: segments {[t.num_docs for t in tables[fmt]]}")
        s = built_s[fmt]
        numbers[f"ingest_{fmt}"] = dict(seconds=s, rows_per_s=BATCH_FILE_ROWS / s)
        log("batch_ingest", table=fmt, rows=BATCH_FILE_ROWS, segments=1, seconds=s,
            rows_per_s=BATCH_FILE_ROWS / s, read_share=reads[fmt][0] / s)

    # -- Q1.1 per segment and stacked over the batch table
    n = len(table)
    q11 = oracle_q11(cols)
    checked("q1_1 per_segment", lambda: execute_query(table, ssb.QUERY), q11,
            counts_of(masked_sums=n), table="csv")
    plan, view = mx._plan_for_set(compile_query(ssb.QUERY, schema), table)
    if plan is None or plan.kind != "device" or view is not None:
        raise AssertionError("batch: the 4 segments do not stack as one aligned set")
    checked("q1_1 set", lambda: mx.execute(table, ssb.QUERY), q11,
            counts_of(masked_sums=1), table="csv")

    # -- each format's table: Q1.1 equal across formats and to the oracle; the FOR sum
    q11_first = oracle_q11(first)
    answers = {}
    for fmt in BATCH_FORMATS:
        expect = counts_of() if fmt == "pb" else counts_of(masked_sums=1)
        answers[fmt] = checked("q1_1", lambda t=tables[fmt]: execute_query(t, ssb.QUERY),
                               q11_first, expect, table=fmt).rows
    for fmt in BATCH_FORMATS[1:]:
        if not rows_match(answers[fmt], answers[BATCH_FORMATS[0]]):
            raise AssertionError(f"batch: Q1.1 over {fmt} {answers[fmt]} != "
                                 f"{BATCH_FORMATS[0]} {answers[BATCH_FORMATS[0]]}")
    checked("for_sum", lambda: execute_query(tables["pb"], ssb.FOR_QUERY), oracle_for(first),
            counts_of(masked_sums_fused=1), table="pb")

    # -- EXPLAIN (no launch) and EXPLAIN ANALYZE (Q1.1's launches)
    expected = _batch_explain_rows(n)
    q11_docs = int(q11_mask(cols).sum())
    for qid, sql in (("q1_1", ssb.QUERY), ("group", ssb.GROUP_QUERY)):
        checked(f"explain {qid}", lambda s=sql: execute_query(table, "EXPLAIN PLAN FOR " + s),
                expected[qid], counts_of(), runs=0, table="csv",
                match=lambda r, q=qid: r.rows == expected[q])

    def analyzed(r) -> bool:
        # the root's Rows is the answer's row count; COMBINE's, the segment
        # plans' and the device plans' the docs Q1.1's filter matched
        return ([row[:3] for row in r.rows] == expected["q1_1"] and r.rows[0][3] == 1
                and [row[3] for row in r.rows[1:4]] == [q11_docs] * 3 and all(
                    ms is not None for _, _, _, rows, ms in r.rows if rows is not None))
    res = checked("explain_analyze q1_1", lambda: execute_query(
        table, "EXPLAIN ANALYZE " + ssb.QUERY), None, counts_of(masked_sums=n),
        table="csv", match=analyzed)
    numbers["analyze_rows"] = res.rows

    # -- GAPFILL per segment and over the set (bitmap leaves lo_discount, lo_quantity)
    gap, filled, matched = gapfill_oracle(cols)
    if not 0 < filled < len(gap):
        raise AssertionError(f"batch GAPFILL: {filled} of {len(gap)} cells filled, no gap rows")
    for label, run, per in (("gapfill per_segment", lambda: execute_query(table, BATCH_GAPFILL),
                             n), ("gapfill set", lambda: mx.execute(table, BATCH_GAPFILL), 1)):
        checked(label, run, gap, counts_of(bitmap_filter=2 * per, grouped_agg=per), table="csv",
                match=lambda r: gapfill_matches(r.rows, gap), rows_matched=matched,
                cells_filled=filled, output_rows=len(gap), gap_rows=len(gap) - filled)

    # -- LOOKUP: the customer dimension table (host plans, no launch)
    customer = ssb.make_customer(ssb.VERY_HIGH_CARD_KEYS, seed)
    half = ssb.VERY_HIGH_CARD_KEYS // 2
    dim_segs = {}
    for name, rows in (("customer", ssb.VERY_HIGH_CARD_KEYS), ("customer_half", half)):
        dim_segs[name] = build_aligned_segments(
            ssb.customer_schema(), {k: v[:rows] for k, v in customer.items()},
            os.path.join(work, "batch_dim", name), name, 1)
        t0 = time.perf_counter()
        register_dim_table_from_segments(name, ["c_custkey"],
                                         [load_segment(p) for p in dim_segs[name]])
        reg_s = time.perf_counter() - t0
        sql = BATCH_LOOKUP.format(dim=name)
        plan = plan_segment(compile_query(sql, schema), table[0])
        if plan.kind != "host":
            raise AssertionError(f"batch LOOKUP: a {plan.kind} plan")
        want = lookup_oracle(cols, customer["c_nation"], rows)
        checked(f"lookup {name}", lambda s=sql: execute_query(table, s), want, counts_of(),
                runs=0, table="csv", dim_rows=rows, register_s=reg_s,
                fallback_reason=plan.fallback_reason,
                match=lambda r, w=want: rows_match(_by_key(r.rows), w, rtol=BATCH_HOST_RTOL))
    for name in dim_segs:
        REGISTRY.unregister(name)

    # -- preprocess: copies of the 4 segments gain the indexes in place
    keys = np.unique(cols["lo_custkey"])
    missing = np.setdiff1d(np.arange(keys[0], keys[-1] + 1), keys)
    if not len(missing):
        raise AssertionError("batch: every lo_custkey in range is present")
    absent = int(missing[len(missing) // 2])
    pre_sql = dict(BATCH_PRE_QUERIES, q1_1=ssb.QUERY, group=ssb.GROUP_QUERY,
                   absent_key=BATCH_PRE_QUERIES["absent_key"].format(key=absent))
    before = {qid: execute_query(table, sql).rows for qid, sql in pre_sql.items()}
    pre_cfg = IndexingConfig(**BATCH_INDEXING, **BATCH_PRE_INDEXES)
    t0 = time.perf_counter()
    copies, changes = [], []
    for s in table:
        dst = os.path.join(work, "batch_pre", s.name)
        shutil.copytree(s.path, dst)
        changes.append(preprocess_segment(dst, pre_cfg))
        copies.append(dst)
    pre_s = time.perf_counter() - t0
    want_changes = ["lo_custkey: added bloom index", "lo_quantity: added range index",
                    "lo_region: added inverted index"]
    if any(sorted(c) != want_changes for c in changes):
        raise AssertionError(f"batch preprocess: changes {changes}")
    pre = [load_segment(p) for p in copies]
    built_paths, built_s = jobs["indexed"].result()
    built = [load_segment(p) for p in built_paths]
    log("batch_preprocess", segments=len(copies), seconds=pre_s, changes=changes[0],
        built_with_the_indexes_s=built_s, absent_key=absent)
    def kinds(segs) -> list:
        return [plan_segment(compile_query(pre_sql["absent_key"], schema), s).kind
                for s in segs]
    if kinds(pre) != ["empty"] * n or "empty" in kinds(table):
        raise AssertionError(f"batch: the absent key's plans {kinds(pre)} after, "
                             f"{kinds(table)} before: the bloom filters must prune the "
                             "preprocessed segments, and nothing the segments before")
    for qid, sql in pre_sql.items():
        reset_launch_counts()
        execute_query(built, sql)
        torch.cuda.synchronize()
        expect = launch_counts()
        checked(f"preprocessed {qid}", lambda s=sql: execute_query(pre, s), before[qid], expect,
                table="csv_preprocessed")
    numbers["preprocess_s"] = pre_s
    return launches, numbers


# -- phase 16: groupby -----------------------------------------------------------------

GROUPBY_RUNS = 5                 # warm runs of each query and path
GROUPED_SYMBOL = "grouped_agg_kernel"
GROUPED_SOURCE = ("pinot_tpu_torch/csrc/grouped_agg.cu",
                  "pinot_tpu/engine/kernels.py:901 (the GROUP BY rungs, :901-947; "
                  "_grouped_chunk64 :605, _grouped_sorted :705, _grouped_partitioned :732, "
                  "_presence_2d :564)")
GROUPED_LIBRARY_NOTE = ("library_ms: torch.bincount of the same keys, the masked rows sent to "
                        "one extra bin, one call for the count and one, with f64 weights, for "
                        "each sum (the power rows made before the timing), and one "
                        "Tensor.scatter_reduce_ (amin / amax) into an identity-filled tensor for "
                        "each min or max")
# torch kernels that would show the plain body's index_add_, bincount or
# scatter_reduce_ on the card
GROUPBY_FORBIDDEN_OPS = ("indexFunc", "Histogram", "scatter_gather", "index_add", "bincount",
                         "scatter_reduce")
GROUPBY_ORDERDATE = ("SELECT lo_orderdate, COUNT(*), SUM(lo_revenue), MIN(lo_quantity), "
                     "MAX(lo_extendedprice) FROM lineorder GROUP BY lo_orderdate "
                     "ORDER BY lo_orderdate LIMIT 3000")
GROUPBY_SUPPKEY = ("SELECT lo_suppkey, VAR_POP(lo_discount) FROM lineorder "
                   "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 20000")
GROUPBY_CUSTKEY = ("SELECT lo_custkey, SUM(lo_revenue) FROM lineorder "
                   "GROUP BY lo_custkey ORDER BY lo_custkey LIMIT 500000")
GROUPBY_DISTINCT = ("SELECT lo_region, DISTINCTCOUNT(lo_discount) FROM lineorder "
                    "GROUP BY lo_region ORDER BY lo_region")
GROUPBY_Q11_DISTINCT = f"SELECT DISTINCTCOUNT(lo_discount) FROM lineorder WHERE {Q11_WHERE}"


#: lo_custkey's per-segment GROUP BY (500,000 state lists decoded a segment:
#: 18 s over the 8) reads the table's first 2 segments, to keep the smoke
#: inside its time; its set run reads all 8
GROUPBY_CUSTKEY_PER_SEGMENT_SEGMENTS = 2


def oracle_custkey_rows(c) -> list:
    """GROUPBY_CUSTKEY's rows: every key that holds rows, with its sum."""
    n, s = np.bincount(c["lo_custkey"]), np.bincount(c["lo_custkey"], c["lo_revenue"])
    keys = np.flatnonzero(n)
    return [[int(a), float(v)] for a, v in zip(keys, s[keys])][:500000]


def groupby_queries():
    """(id, sql, grouped_agg launches a pass, per-segment warm runs): one
    launch a GROUP BY pass, one more for a distinct output; lo_custkey's
    per-segment run decodes ~490,000 state lists a segment, so its cold run
    alone (as `group_trim`'s)."""
    from pinot_tpu_torch.ssb import GROUP_QUERY
    return [("region", GROUP_QUERY, 1, GROUPBY_RUNS),
            ("orderdate", GROUPBY_ORDERDATE, 1, GROUPBY_RUNS),
            ("suppkey_var", GROUPBY_SUPPKEY, 1, GROUPBY_RUNS),
            ("custkey", GROUPBY_CUSTKEY, 1, 0),
            ("region_distinct", GROUPBY_DISTINCT, 2, GROUPBY_RUNS),
            ("q11_distinct", GROUPBY_Q11_DISTINCT, 1, GROUPBY_RUNS)]


def groupby_oracles(c) -> dict:
    """numpy float64 answers of `groupby_queries`: groups from a stable sort
    or `np.bincount` over the key."""
    order = np.argsort(c["lo_orderdate"], kind="stable")
    od = c["lo_orderdate"][order]
    starts = np.flatnonzero(np.r_[True, od[1:] != od[:-1]])
    n = np.diff(np.r_[starts, len(od)])
    rev = np.add.reduceat(c["lo_revenue"][order], starts)
    qmin = np.minimum.reduceat(c["lo_quantity"][order], starts)
    pmax = np.maximum.reduceat(c["lo_extendedprice"][order], starts)
    out = {"region": oracle_group(c),
           "orderdate": [[int(od[s]), int(k), float(r), int(q), float(p)]
                         for s, k, r, q, p in zip(starts, n, rev, qmin, pmax)][:3000]}
    out["suppkey_var"] = oracle_suppkey_var(c)
    out["custkey"] = oracle_custkey_rows(c)
    from pinot_tpu_torch.ssb import REGIONS
    out["region_distinct"] = []
    for r in sorted(REGIONS):
        m = c["lo_region"] == r
        if m.any():
            out["region_distinct"].append([r, len(np.unique(c["lo_discount"][m]))])
    out["q11_distinct"] = [[len(np.unique(c["lo_discount"][q11_mask(c)]))]]
    return out


def run_groupby(args, table, cols) -> tuple:
    """Phase 16: the GROUP BY ladder over phase 4's table. Each query per
    segment and over the set (a cold run held to its exact launches, then
    warm runs), against numpy; lo_custkey's GROUP BY as two server partials
    (4 segments each) through `prepare_partial` and through the pipeline,
    each dense (`reduce.DensePartial`), merged and reduced equal to the
    oracle and to the set's answer; `group_case` lines (the kernel against
    its plain version at each rung); GROUP_QUERY per segment under the
    profiler. Returns (launches of the checked runs, group_case numbers)."""
    from pinot_tpu_torch import execute_query
    from pinot_tpu_torch.cluster import DeviceQueryPipeline
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.query.aggregates import make_agg
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.planner import build_device_geometry
    from pinot_tpu_torch.query.reduce import merge_segment_results, reduce_to_result
    from pinot_tpu_torch.ssb import GROUP_QUERY

    schema = table[0].schema
    rows = sum(s.num_docs for s in table)
    t0 = time.perf_counter()
    oracles = groupby_oracles(cols)
    log("groupby_data", rows=rows, segments=len(table), oracle_s=time.perf_counter() - t0)
    mx = MeshQueryExecutor()
    launches = counts_of()
    set_answers = {}

    def checked(label, run, want, expect, runs):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if counts != expect:
            raise AssertionError(f"groupby {label}: launches {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        if not rows_match(res.rows, want):
            bad = next(i for i, (g, w) in enumerate(zip(res.rows, want))
                       if not rows_match([g], [w])) if len(res.rows) == len(want) else None
            raise AssertionError(f"groupby {label}: {len(res.rows)} rows against "
                                 f"{len(want)}; first difference at {bad}")
        fields = dict(answer=res.rows[:5], answer_rows=len(res.rows), launches=counts,
                      cold_ms=cold_ms, cold_phase_ms=res.stats.get("phaseTimesMs"))
        if runs:
            warm, results = warm_times(run, runs=runs)
            if any(not rows_match(r.rows, want) for r in results):
                raise AssertionError(f"groupby {label}: a warm answer is off the oracle")
            warm.pop("median_s")
            fields.update(warm, warm_phase_median_ms={
                k: statistics.median(r.stats["phaseTimesMs"][k] for r in results)
                for k in res.stats["phaseTimesMs"]})
        return fields, res.rows

    custkey_table = table[:GROUPBY_CUSTKEY_PER_SEGMENT_SEGMENTS]
    custkey_want = oracle_custkey_rows({k: v[:sum(s.num_docs for s in custkey_table)]
                                        for k, v in cols.items()})
    for qid, sql, per_pass, seg_runs in groupby_queries():
        seg_table = custkey_table if qid == "custkey" else table
        for path, segs, run, passes, runs in (
                ("per_segment", seg_table,
                 lambda sql=sql, segs=seg_table: execute_query(segs, sql), len(seg_table),
                 seg_runs),
                ("set", table, lambda sql=sql: mx.execute(table, sql), 1, GROUPBY_RUNS)):
            want = custkey_want if (qid, path) == ("custkey", "per_segment") else oracles[qid]
            fields, got = checked(f"{qid} {path}", run, want,
                                  counts_of(grouped_agg=per_pass * passes), runs)
            if path == "set":
                set_answers[qid] = got
            log("groupby_query", query=qid, path=path, rows=sum(s.num_docs for s in segs),
                segments=len(segs), oracle=want[:5], **fields)

    # lo_custkey's GROUP BY as two server partials of 4 segments each
    ctx = compile_query(GROUPBY_CUSTKEY, schema)
    aggs = [make_agg(f) for f in ctx.aggregations]
    halves = [table[:len(table) // 2], table[len(table) // 2:]]
    parts, numbers = [], []
    for half in halves:
        reset_launch_counts()
        t0 = time.perf_counter()
        p = mx.prepare_partial(ctx, half)
        [(packed, finish, _)] = mx.dispatch_prepared([p])
        host = finish(mx.fetch([packed])[0])[0]
        t1 = time.perf_counter()
        part = p.decode(host)
        t2 = time.perf_counter()
        counts = launch_counts()
        if counts != counts_of(grouped_agg=1) or part.dense is None or part.groups:
            raise AssertionError(f"groupby partial: launches {counts}, dense "
                                 f"{part.dense is not None}, {len(part.groups)} state lists")
        for k, v in counts.items():
            launches[k] += v
        plan, _ = mx._plan_for_set(ctx, half)
        build_device_geometry(plan)
        t3 = time.perf_counter()
        as_dicts = mx._fallback._decode_group_partials(plan, host)
        t4 = time.perf_counter()
        numbers.append(dict(segments=len(half), keys=part.dense.num_keys_real,
                            occupied=int((part.dense.counts > 0).sum()),
                            dispatch_fetch_ms=(t1 - t0) * 1e3, dense_decode_ms=(t2 - t1) * 1e3,
                            state_dict_decode_ms=(t4 - t3) * 1e3,
                            state_dict_groups=len(as_dicts.groups)))
        parts.append(part)
    t0 = time.perf_counter()
    merged = merge_segment_results(parts, aggs)
    t1 = time.perf_counter()
    got = reduce_to_result(ctx, merged, aggs, list(ctx.group_by)).rows
    t2 = time.perf_counter()
    if merged.dense is None or not rows_match(got, oracles["custkey"]) \
            or not rows_match(got, set_answers["custkey"]):
        raise AssertionError("groupby partials: the merged dense partials differ from the "
                             "oracle or from the set's answer")
    pipeline = DeviceQueryPipeline(mesh_exec=mx)
    try:
        t3 = time.perf_counter()
        served = [pipeline.execute_partial(ctx, half) for half in halves]
        t4 = time.perf_counter()
    finally:
        pipeline.stop()
    if any(s.dense is None for s in served) or not rows_match(reduce_to_result(
            ctx, merge_segment_results(served, aggs), aggs, list(ctx.group_by)).rows, got):
        raise AssertionError("groupby partials: the pipeline's partials are not dense or "
                             "reduce to another answer")
    log("groupby_partial", query="custkey", partials=numbers, merge_ms=(t1 - t0) * 1e3,
        reduce_ms=(t2 - t1) * 1e3, pipeline_partials_ms=(t4 - t3) * 1e3, dense=True,
        equals_oracle=True, equals_set=True)

    cases = group_cases(group_inputs(table, mx))
    trace = trace_query(lambda: execute_query(table, GROUP_QUERY))
    # the profiler was seen to drop ops from a short window: the kernel's
    # events are logged beside the passes, and none at all fails
    bad = [name for name in trace["op_counts"] if any(w in name for w in GROUPBY_FORBIDDEN_OPS)]
    events = sum(n for name, n in trace["op_counts"].items() if GROUPED_SYMBOL in name)
    # GROUP_QUERY's pass is one kernel: no init or finalize kernel beside it
    others = {name: n for name, n in trace["op_counts"].items()
              if "grouped_" in name and GROUPED_SYMBOL not in name}
    if bad or not events or others:
        raise AssertionError(f"groupby trace: ops {bad} on the card, {events} "
                             f"{GROUPED_SYMBOL} events for {TRACED_RUNS * len(table)} passes, "
                             f"other grouped kernels {others}")
    log("groupby_trace", query="region", path="per_segment", grouped_agg_events=events,
        passes=TRACED_RUNS * len(table), **trace)
    return launches, cases


def group_inputs(table, mx) -> list:
    """`group_cases`' inputs at the set's shapes (the stacked table; GROUP_QUERY
    per segment too), one for each rung the path reaches: (case, group ids,
    strides, mask, value rows, ops, cells)."""
    from pinot_tpu_torch.engine.datablock import block_for, lut_size
    from pinot_tpu_torch.engine.kernels import filter_mask
    from pinot_tpu_torch.query.context import compile_query
    from pinot_tpu_torch.query.executor import ServerQueryExecutor, kernel_spec
    from pinot_tpu_torch.query.planner import build_device_geometry, plan_segment
    from pinot_tpu_torch.ssb import GROUP_QUERY

    dev = mx.device
    seg, stacked = table[0], mx._block_for(table)

    def plan_of(sql):
        ctx = compile_query(sql, seg.schema)
        plan = plan_segment(ctx, seg, peers=table[1:])
        build_device_geometry(plan)
        return ctx, plan

    ctx, plan = plan_of(GROUP_QUERY)
    spec = kernel_spec(plan)
    block = block_for(seg, dev)
    masks = {"one segment": filter_mask(spec, ServerQueryExecutor(dev)._kernel_inputs(
        plan, spec, block)), "stacked set": filter_mask(spec, mx._set_inputs(
            plan, spec, stacked, ctx))}
    _, q11_plan = plan_of(GROUPBY_Q11_DISTINCT)
    q11_spec = kernel_spec(q11_plan)
    q11_mask = filter_mask(q11_spec, mx._set_inputs(q11_plan, q11_spec, stacked,
                                                    compile_query(GROUPBY_Q11_DISTINCT,
                                                                  seg.schema)))
    ids = lambda c: stacked.ids(c).view(-1)           # noqa: E731
    vals = lambda c: stacked.decoded(c).view(-1)      # noqa: E731
    valid = stacked.valid.view(-1)
    cells = {sql: plan_of(sql)[1].num_keys_pad + 1
             for sql in (GROUP_QUERY, GROUPBY_ORDERDATE, GROUPBY_SUPPKEY, GROUPBY_CUSTKEY)}
    size = lut_size(seg.column("lo_discount").cardinality)
    rev = vals("lo_revenue")
    disc = vals("lo_discount")
    return [
        ("region, one segment", [block.ids("lo_region")], [1], masks["one segment"],
         [block.values("lo_revenue")], ["sum"], cells[GROUP_QUERY]),
        ("region, stacked set", [ids("lo_region")], [1], masks["stacked set"], [rev], ["sum"],
         cells[GROUP_QUERY]),
        ("orderdate, stacked set", [ids("lo_orderdate")], [1], valid,
         [rev, vals("lo_quantity"), vals("lo_extendedprice")], ["sum", "min", "max"],
         cells[GROUPBY_ORDERDATE]),
        ("suppkey var_pop, stacked set", [ids("lo_suppkey")], [1], valid, [disc, disc],
         ["isum", "sum2"], cells[GROUPBY_SUPPKEY]),
        ("custkey, stacked set", [ids("lo_custkey")], [1], valid, [rev], ["sum"],
         cells[GROUPBY_CUSTKEY]),
        ("region distinct, stacked set", [ids("lo_region"), ids("lo_discount")], [size, 1],
         valid, [], [], cells[GROUP_QUERY] * size),
        ("q11 distinct, stacked set", [ids("lo_discount")], [1], q11_mask, [], [], size),
    ]


def group_library(gids, strides, mask, vrows, ops, num_cells):
    """The library yardstick of a `grouped_agg` call (GROUPED_LIBRARY_NOTE):
    a function of no arguments, its inputs made beforehand."""
    from pinot_tpu_torch.engine import grouped
    key = sum(t.long() * s for t, s in zip(gids, strides)) if gids else \
        torch.zeros(mask.numel(), dtype=torch.int64, device=mask.device)
    masked_key = torch.where(mask, key, num_cells)
    weights = [r.double() if op in ("sum", "isum") else
               grouped.power_rows(r, grouped.POWERS[op])
               for r, op in zip(vrows, ops) if op not in ("min", "max")]
    extremes = [(r, op) for r, op in zip(vrows, ops) if op in ("min", "max")]

    def library():
        outs = [torch.bincount(masked_key, minlength=num_cells + 1)]
        outs += [torch.bincount(masked_key, weights=w, minlength=num_cells + 1)
                 for w in weights]
        for r, op in extremes:
            cells = torch.full((num_cells + 1,), grouped.identity(op, r.dtype), dtype=r.dtype,
                               device=r.device)
            outs.append(cells.scatter_reduce_(0, masked_key, r,
                                              reduce="amin" if op == "min" else "amax"))
        return outs
    return library


def group_case(case, gids, strides, mask, vrows, ops, num_cells, flush) -> dict:
    """`grouped_agg` against `grouped_agg_plain` on the card for one call:
    its count exactly, int64 sums, min and max exactly, f32 sums within rel
    2.5e-7 (one f32 ulp: the atomics add the f64 partials in an order of
    their own). `ms` and `plain_ms` device time (graph replay, L2 flushed),
    `call_ms` an eager call, `library_ms` (GROUPED_LIBRARY_NOTE); the bound
    is the inputs read once and the cells written once
    over the memory rate, against one f64 add a kept row and output: the
    mask whole, and the ids and values of the rows it keeps, which are all
    the function needs. One `group_case` line."""
    from pinot_tpu_torch.engine import grouped

    def kernel():
        return grouped.grouped_agg(gids, strides, mask, vrows, ops, num_cells)

    def plain():
        return grouped.grouped_agg_plain(gids, strides, mask, vrows, ops, num_cells)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    max_abs_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if i and ops[i - 1] in ("sum", "sum2", "sum3", "sum4"):
            g64, w64 = g.double(), w.double()
            err = (g64 - w64).abs()
            if bool((err > 2.5e-7 * w64.abs()).any()):
                raise AssertionError(f"group_case {case}: output {i} off the plain "
                                     f"version by {float(err.max())}")
            max_abs_err = max(max_abs_err, float(err.max()))
        elif not torch.equal(g, w):
            raise AssertionError(f"group_case {case}: output {i} differs from the plain "
                                 "version's")
    n = int(mask.numel())
    kept = int(got[0].sum())
    # the mask read whole; a kept row's ids and values (each row tensor once)
    read = n + kept * (4 * len(gids) + sum(t.element_size()
                                           for t in {id(t): t for t in vrows}.values()))
    written = num_cells * (4 + sum(g.element_size() for g in got[1:]))
    bms, by = roofline(read + written, kept * (len(ops) + 1))
    rung = grouped.rung_for(mask.device, vrows, ops, num_cells)[0]
    numbers = dict(rung=rung, rows=n, cells=num_cells, ops=list(ops), kept=kept,
                   max_abs_err=max_abs_err, ms=graph_ms(kernel, flush),
                   plain_ms=graph_ms(plain, flush), call_ms=time_ms(kernel, flush),
                   library_ms=time_ms(group_library(gids, strides, mask, vrows, ops,
                                                    num_cells), flush),
                   bound_ms=bms, bound_by=by)
    numbers["pct_of_bound"] = 100.0 * bms / numbers["ms"]
    log("group_case", case=case, **numbers)
    return numbers


def group_cases(cases) -> dict:
    """`group_case` of each (case, group ids, strides, mask, value rows, ops,
    cells) of `cases`, by case."""
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=cases[0][3].device)
    return {c[0]: group_case(*c, flush) for c in cases}


# -- phase 17: cluster ---------------------------------------------------------------

CLUSTER_RUNS = 5                 # warm runs of each query through the broker
# warm runs of the lo_custkey GROUP BY through a broker, whose run is the
# broker's 500,000-row reduce (3-5 s a run), to keep the smoke inside its time
CLUSTER_CUSTKEY_RUNS = 1
CLUSTER_SERVERS = 2
CLUSTER_REPLICATION = 2
# segments pushed at once: each upload packs a gzip tar, and zlib lets the
# threads compress side by side (one at a time took 18 s of the phase's 69)
CLUSTER_UPLOAD_THREADS = 8
CLUSTER_PROFILE_TOP = 12         # functions the reduce profile lists
# the in-process cluster's numbers by query (and "e2e_mix"), which the
# process_cluster phase prints beside its own
CLUSTER_NUMBERS: dict = {}
# the in-process cluster's work directory and its restarted catalog's snapshot,
# which the memory phase serves again from one server
CLUSTER_STATE: dict = {}
# the joins through the in-process broker (the funnel path): each leaf scan
# gathers its rows as tuples on a server, 3.5-5.9 s a run at 16M rows
CLUSTER_JOIN_QUERIES = ("join_supplier", "semi_in")
CLUSTER_JOIN_WARM_RUNS = 1


def oracle_custkey_group(c):
    """GROUPBY_CUSTKEY: every key that holds rows, ascending, with its sum."""
    counts = np.bincount(c["lo_custkey"])
    sums = np.bincount(c["lo_custkey"], weights=c["lo_revenue"])
    keys = np.flatnonzero(counts)[:500_000]
    return keys, sums[keys]


def custkey_rows_match(got, want) -> bool:
    """The lo_custkey GROUP BY's rows against its oracle, vectorized."""
    keys, sums = want
    if len(got) != len(keys):
        return False
    g = np.asarray(got, dtype=np.float64)
    return bool(np.array_equal(g[:, 0], keys)
                and np.allclose(g[:, 1], sums, rtol=ORACLE_RTOL, atol=ORACLE_ATOL))


def topk_oracle(c, mask, select, key, desc, limit):
    """A top-k through the broker: partials merge in the order servers
    answer, so rows that tie on the key may come in either order and a tie
    group the LIMIT cuts may give any of its rows. The check: its keys are
    the oracle's, and the rows are matching rows with those keys, none
    taken more often than the data holds it."""
    want = oracle_rows(c, mask, select, key, desc, limit)
    k = select.index(key)
    keys = [r[k] for r in want]
    idx = np.flatnonzero(mask & np.isin(c[key], keys))
    allowed = collections.Counter(tuple(c[col][i].item() for col in select) for i in idx)

    def ok(got):
        # the keys in order fix each tie group's size; the rows, as a
        # multiset, must be among the matching ones, so no row comes twice
        # unless the data holds it twice
        return [r[k] for r in got] == keys and not (
            collections.Counter(map(tuple, got)) - allowed)
    return ok


def cluster_queries(cols) -> list:
    """(id, sql, oracle check, launches a server the route gives segments)
    through the pipelined servers; topk_desc launches the stacked top-k, one
    a server, and none of the four kernels."""
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY
    q11, group, count = oracle_q11(cols), oracle_group(cols), oracle_count(cols)
    topk = topk_oracle(cols, cols["lo_quantity"] >= 10, ["lo_custkey", "lo_revenue"],
                       "lo_revenue", True, 7)
    custkey = oracle_custkey_group(cols)
    return [
        ("q1_1", QUERY, lambda rows: rows_match(rows, q11), counts_of(masked_sums=1)),
        ("group_by", GROUP_QUERY, lambda rows: rows_match(rows, group),
         counts_of(grouped_agg=1)),
        ("count_quantity", SERVE_COUNT_QUERY, lambda rows: rows_match(rows, count),
         counts_of(masked_sums=1)),
        ("topk_desc", SELECT_QUERIES[0][1], topk, counts_of()),
        ("custkey_group", GROUPBY_CUSTKEY, lambda rows: custkey_rows_match(rows, custkey),
         counts_of(grouped_agg=1)),
    ]


@contextlib.contextmanager
def dense_materializations():
    """Counts the `SegmentResult.materialize_dense` calls on an array-form
    partial while the block runs (the broker's dict fallback)."""
    from pinot_tpu_torch.query.reduce import SegmentResult
    orig = SegmentResult.materialize_dense
    calls = []

    def spy(self, *args, **kwargs):
        if self.dense is not None:
            calls.append(1)
        return orig(self, *args, **kwargs)
    SegmentResult.materialize_dense = spy
    try:
        yield calls
    finally:
        SegmentResult.materialize_dense = orig


def profile_top(fn, top: int = CLUSTER_PROFILE_TOP) -> tuple:
    """fn() under cProfile (which in Python 3.12 sees every thread: run it
    where the others wait): its result, and the `top` functions by own time
    and by cumulative time."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    try:
        out = fn()
    finally:
        prof.disable()
    stats = pstats.Stats(prof).stats

    def rows(col):
        best = sorted(stats.items(), key=lambda kv: -kv[1][col])[:top]
        return [{"fn": f"{os.path.basename(f)}:{line}:{name}", "calls": v[1],
                 "own_s": v[2], "cum_s": v[3]} for (f, line, name), v in best]
    return out, {"by_own": rows(2), "by_cum": rows(3)}


class RouteLog:
    """Records the broker's dispatches (server, segments) as they are made:
    the route each checked run's launches are derived from; and how many of
    the partials that came back were in array form (`DensePartial`)."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.calls = []
        self.dense = 0

    def wrap(self, sid, handle):
        def call(table, ctx, segments, tf=None):
            with self._lock:
                self.calls.append((sid, list(segments)))
            partial = handle(table, ctx, segments, tf)
            with self._lock:
                self.dense += partial.dense is not None
            return partial
        return call

    def take(self) -> dict:
        """server -> segments of the dispatches since the last take."""
        with self._lock:
            calls, self.calls, self.dense = self.calls, [], 0
        out = {}
        for sid, segs in calls:
            out.setdefault(sid, []).extend(segs)
        return {sid: sorted(segs) for sid, segs in out.items() if segs}


def join_launches(qid: str, segments: int) -> dict:
    """A join's launches: JOIN_BITMAP's bitmap_filter a lineorder segment and
    on the dimension table's one segment, nothing else."""
    per_segment, dimension = JOIN_BITMAP[qid]
    return counts_of(bitmap_filter=per_segment * segments + dimension)


def cluster_joins(args, broker, controller, table, cols, work, launches) -> None:
    """Phase 17's joins: phase 7's supplier table uploaded to the in-process
    cluster (replication 2), then CLUSTER_JOIN_QUERIES through
    `broker.handle_query`: the funnel path (the servers are in-process
    handles without HTTP endpoints), every run held to its oracle and its
    launches (`cluster_join`)."""
    from pinot_tpu_torch.ssb import JOIN_QUERIES
    from pinot_tpu_torch.table import TableConfig
    from pinot_tpu_torch.utils.metrics import get_registry

    jd = join_data(args, table, cols, work)
    controller.add_schema(jd["schemas"]["supplier"])
    controller.add_table(TableConfig("supplier", replication=CLUSTER_REPLICATION))
    for seg in jd["tables"]["supplier"]:
        controller.upload_segment("supplier_OFFLINE", seg.path)
    reg = get_registry()
    for qid in CLUSTER_JOIN_QUERIES:
        want = join_launches(qid, len(table))
        times, plane = [], reg.counter("pinot_broker_data_plane_bytes").value
        for _ in range(1 + CLUSTER_JOIN_WARM_RUNS):
            reset_launch_counts()
            t0 = time.perf_counter()
            res = broker.handle_query(JOIN_QUERIES[qid])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = launch_counts()
            if counts != want:
                raise AssertionError(f"cluster join {qid}: launches {counts}, expected {want}")
            for k, v in counts.items():
                launches[k] += v
            if not rows_match(res.rows, jd["oracles"][qid], JOIN_RTOL, JOIN_ATOL):
                raise AssertionError(f"cluster join {qid}: {res.rows}, oracle "
                                     f"{jd['oracles'][qid]}")
            if not res.stats.get("multistage") or res.stats.get("mailboxShuffle"):
                raise AssertionError(f"cluster join {qid}: not the funnel path: {res.stats}")
        log("cluster_join", query=qid, path="funnel", launches=counts, answer=res.rows[:3],
            cold_ms=times[0], warm_ms=times[1:], join_strategy=res.stats.get("joinStrategy"),
            phase_ms=res.stats.get("phaseTimesMs"),
            join_stats={k: v for k, v in res.stats.items() if k.startswith("join")},
            data_plane_bytes_a_run=(reg.counter("pinot_broker_data_plane_bytes").value
                                    - plane) / len(times),
            p2p_fallbacks=reg.counter("pinot_broker_p2p_fallbacks").value)
        CLUSTER_NUMBERS[f"funnel_{qid}"] = {"cold_ms": times[0], "warm_ms": times[1:]}


def run_cluster(args, table, cols, for_table, work) -> dict:
    """Phase 17: the cluster roles in one process. One Catalog, Controller and
    Broker and two ServerNodes, each with a DeviceQueryPipeline of its own on
    the card, as a server process wires them; an OFFLINE lineorder table with
    replication 2 takes phase 4's 8 segments (pushed as built from
    CLUSTER_UPLOAD_THREADS threads: a gzip tar to the deep store, each server
    unpacks and loads its assignment). Through `broker.handle_query`: Q1.1,
    GROUP_QUERY, the COUNT, topk_desc and the lo_custkey GROUP BY (one dense
    partial a server, merged at the broker without a state dict), each a
    cold run and CLUSTER_RUNS warm runs, beside the same SQL on the direct
    set path; lo_custkey's reduce under cProfile; EXPLAIN and EXPLAIN ANALYZE
    of Q1.1; the e2e mix (32 clients x 12 queries) through this broker
    beside phase 5's numbers; failover to server_0 alone; then the cluster restarted as a
    QuickCluster of its default per-segment servers (catalog restored from a
    snapshot, segments from local disk) answering Q1.1 and the FOR sum. Every answer is held to its
    oracle, every run's launches to those its printed route implies, and
    every query but the failover's to no partial result, no retry and 8
    segments queried. Returns the launches of the checked runs."""
    import threading
    from unittest import mock

    from pinot_tpu_torch import QuickCluster
    from pinot_tpu_torch.cluster import broker as broker_module
    from pinot_tpu_torch.cluster import (Broker, Catalog, Controller, DeviceQueryPipeline,
                                         ServerNode)
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.engine import kernels
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.schema import Schema
    from pinot_tpu_torch.ssb import FOR_QUERY, GROUP_QUERY, QUERY
    from pinot_tpu_torch.table import TableConfig

    root = os.path.join(work, "cluster")
    schema = table[0].schema
    rows = sum(s.num_docs for s in table)
    launches = counts_of()
    routes = RouteLog()

    def upload_all(controller, name, segs):
        with concurrent.futures.ThreadPoolExecutor(CLUSTER_UPLOAD_THREADS) as pool:
            return list(pool.map(lambda s: controller.upload_segment(name, s.path), segs))

    t0 = time.perf_counter()
    catalog = Catalog()
    store = LocalDeepStore(os.path.join(root, "deepstore"))
    controller = Controller("controller_0", catalog, store, os.path.join(root, "controller"))
    servers = [ServerNode(f"server_{i}", catalog, store, os.path.join(root, f"server_{i}"),
                          device_pipeline=DeviceQueryPipeline(MeshQueryExecutor()))
               for i in range(CLUSTER_SERVERS)]
    broker = Broker("broker_0", catalog)
    for s in servers:
        broker.register_server_handle(s.instance_id, routes.wrap(s.instance_id,
                                                                 s.execute_partial),
                                      explain_handle=s.explain_partial)
    controller.add_schema(schema)
    controller.add_table(TableConfig("lineorder", replication=CLUSTER_REPLICATION))
    name = "lineorder_OFFLINE"
    t_up = time.perf_counter()
    metas = upload_all(controller, name, table)
    upload_s = time.perf_counter() - t_up
    status = controller.table_status(name)
    if not status["converged"] or status["segments"] != len(table) or any(
            n != CLUSTER_REPLICATION for n in status["replicas_online"].values()):
        raise AssertionError(f"cluster: the table did not converge: {status}")
    log("cluster_data", rows=rows, segments=len(table), servers=CLUSTER_SERVERS,
        replication=CLUSTER_REPLICATION, wire_s=t_up - t0, upload_s=upload_s,
        deepstore_bytes=sum(m.size_bytes for m in metas),
        loaded={s.instance_id: len(s.segments_served(name)) for s in servers})

    def checked(label, sql, ok, per_server, servers_expected=None, strict=True):
        """One broker query: counts set to 0 just before, read just after and
        held to `per_server` times the servers its route gave segments; the
        answer to `ok`; the stats to a whole answer from every segment."""
        reset_launch_counts()
        kernels.reset_topk_launches()
        routes.take()
        t0 = time.perf_counter()
        with dense_materializations() as materialized:
            res = broker.handle_query(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dense = routes.dense
        route = routes.take()
        counts, topk = launch_counts(), kernels.topk_launches()
        if label.endswith("custkey_group") and dense != len(route):
            raise AssertionError(f"cluster {label}: {dense} of {len(route)} server partials "
                                 "in array form: the broker must merge them elementwise")
        if materialized:
            raise AssertionError(f"cluster {label}: the broker turned {len(materialized)} "
                                 "array-form partials into state dicts")
        want = {k: v * len(route) for k, v in per_server.items()}
        want_topk = len(route) if label.startswith("topk") else 0
        if counts != want or topk != want_topk:
            raise AssertionError(f"cluster {label}: launches {counts}, top-k {topk}, expected "
                                 f"{want} and {want_topk} for the route {route}")
        if servers_expected is not None and sorted(route) != servers_expected:
            raise AssertionError(f"cluster {label}: routed to {sorted(route)}")
        for k, v in counts.items():
            launches[k] += v
        if not ok(res.rows):
            raise AssertionError(f"cluster {label}: answer off the oracle: {res.rows[:5]}")
        st = res.stats
        if strict and (st["partialResult"] or st["numSegmentsRetried"]
                       or st["numSegmentsQueried"] != len(table)
                       or st["numServersResponded"] != st["numServersQueried"]):
            raise AssertionError(f"cluster {label}: stats {st}")
        return res, ms, route, counts

    # the broker's reduce phase split: the merge of the partials and the
    # reduce to rows, timed in every run; the last reduce's inputs kept
    split, reduce_inputs = {}, {}

    def timed(fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            split[fn.__name__] = (time.perf_counter() - t0) * 1e3
            if fn.__name__ == "reduce_to_result":
                split["inputs"] = args
            return out
        return call

    numbers = {}
    queries = cluster_queries(cols)
    for qid, sql, ok, per_server in queries:
        res, cold_ms, route, counts = checked(qid, sql, ok, per_server)
        times, phases = [], []
        with mock.patch.object(broker_module, "merge_segment_results",
                               timed(broker_module.merge_segment_results)), \
                mock.patch.object(broker_module, "reduce_to_result",
                                  timed(broker_module.reduce_to_result)):
            for _ in range(min(CLUSTER_RUNS, CLUSTER_CUSTKEY_RUNS)
                           if qid == "custkey_group" else CLUSTER_RUNS):
                r, ms, _, _ = checked(qid, sql, ok, per_server)
                times.append(ms)
                phases.append(dict(r.stats["phaseTimesMs"],
                                   merge=split["merge_segment_results"],
                                   reduce_to_result=split["reduce_to_result"]))
        reduce_inputs[qid] = split.pop("inputs")
        numbers[qid] = statistics.median(times)
        CLUSTER_NUMBERS[qid] = {"cold_ms": cold_ms, "warm_median_ms": numbers[qid]}
        log("cluster_query", query=qid, rows=rows, segments=len(table), route=route,
            launches=counts, answer=res.rows[:3], answer_rows=len(res.rows), cold_ms=cold_ms,
            warm_median_ms=statistics.median(times), warm_min_ms=min(times),
            warm_max_ms=max(times), warm_runs=len(times),
            phase_median_ms={k: statistics.median(p[k] for p in phases) for k in phases[0]},
            stats={k: res.stats[k] for k in ("numSegmentsQueried", "numSegmentsPruned",
                                              "numSegmentsMatched", "numServersQueried",
                                              "numServersResponded", "partialResult",
                                              "numSegmentsRetried", "numDocsScanned")})

    # the same SQL on the direct set path over the same 8 segments (no
    # broker, no server), held to the same oracles
    mx = MeshQueryExecutor()
    set_ms = {}
    for qid, sql, ok, _ in queries:
        times = []
        for _ in range(1 + CLUSTER_RUNS):
            t0 = time.perf_counter()
            res = mx.execute(table, sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not ok(res.rows):
                raise AssertionError(f"cluster set path {qid}: off the oracle: {res.rows[:5]}")
        set_ms[qid] = statistics.median(times[1:])
        log("cluster_set_path", query=qid, rows=rows, segments=len(table), cold_ms=times[0],
            warm_median_ms=set_ms[qid], warm_min_ms=min(times[1:]),
            warm_max_ms=max(times[1:]), warm_runs=CLUSTER_RUNS,
            broker_warm_median_ms=numbers[qid])

    # where the broker's lo_custkey reduce goes: its last warm run's
    # reduce_to_result again, alone under cProfile
    t0 = time.perf_counter()
    out, prof = profile_top(lambda: broker_module.reduce_to_result(
        *reduce_inputs["custkey_group"]))
    log("cluster_reduce_profile", query="custkey_group", rows=len(out.rows),
        profiled_ms=(time.perf_counter() - t0) * 1e3, **prof)
    # 500,000-row answers kept alive would tax the mix's collections
    del out, res, r, reduce_inputs

    # EXPLAIN launches nothing; EXPLAIN ANALYZE runs Q1.1 through the route
    res, ms, route, counts = checked("explain", "EXPLAIN PLAN FOR " + QUERY,
                                     lambda r: len(r) >= 3, counts_of(), strict=False)
    log("cluster_explain", query="q1_1", rows=res.rows, ms=ms)
    res, ms, route, counts = checked(
        "explain_analyze", "EXPLAIN ANALYZE " + QUERY,
        lambda r: len(r) >= 3 and r[0][3] == 1, counts_of(masked_sums=1))
    if not any(r[0].startswith("SEGMENT_PLAN") and r[3] == res.stats["numDocsScanned"]
               for r in res.rows):
        raise AssertionError(f"cluster explain_analyze: rows {res.rows}")
    log("cluster_explain", query="q1_1", analyze=True, rows=res.rows, route=route,
        launches=counts, ms=ms)

    # the e2e mix through the broker (its default 8 scatter threads),
    # beside phase 5's pipeline numbers
    mix = [(QUERY, oracle_q11(cols)), (GROUP_QUERY, oracle_group(cols)),
           (SERVE_COUNT_QUERY, oracle_count(cols))]

    def run_mix():
        before = [s.device_pipeline.stats()["scanLaunches"] for s in servers]
        lat, failures = [], []
        lock = threading.Lock()

        def client(ci):
            mine, wrong = [], []
            for qi in range(SERVE_QUERIES_PER_CLIENT):
                sql, want = mix[(ci + qi) % len(mix)]
                t0 = time.perf_counter()
                try:
                    res = broker.handle_query(sql)
                except Exception as e:   # recorded, and the phase fails below
                    wrong.append(f"{sql[:48]}: {e!r}")
                    continue
                mine.append(time.perf_counter() - t0)
                st = res.stats
                if not rows_match(res.rows, want) or st["partialResult"] \
                        or st["numSegmentsRetried"] or st["numSegmentsQueried"] != len(table):
                    wrong.append(f"{sql[:48]}: {res.rows} {st}")
            with lock:
                lat.extend(mine)
                failures.extend(wrong)

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
        reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        stats = [s.device_pipeline.stats() for s in servers]
        scans = sum(st["scanLaunches"] for st in stats) - sum(before)
        n_queries = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
        if any(t.is_alive() for t in threads) or failures or len(lat) != n_queries:
            raise AssertionError(f"cluster e2e_mix: {len(lat)} of {n_queries} answered, "
                                 f"{len(failures)} bad: {failures[:3]}")
        if counts["masked_sums"] != scans or any(st["errors"] or st["timeouts"]
                                                 for st in stats):
            raise AssertionError(f"cluster e2e_mix: {counts['masked_sums']} scans counted, "
                                 f"the pipelines report {scans}: {stats}")
        launches["masked_sums"] += counts["masked_sums"]
        lat.sort()
        CLUSTER_NUMBERS["e2e_mix"] = {"qps": n_queries / wall,
                                      "p50_ms": statistics.median(lat) * 1e3,
                                      "p95_ms": lat[int(0.95 * (len(lat) - 1))] * 1e3}
        log("cluster_pipeline", mix="e2e_mix", scatter_threads=8,
            clients=SERVE_CLIENTS, queries=n_queries, wall_s=wall, qps=n_queries / wall,
            p50_ms=statistics.median(lat) * 1e3, p95_ms=lat[int(0.95 * (len(lat) - 1))] * 1e3,
            launches=counts, serve_pipeline=SERVE_MIX_NUMBERS.get("e2e_mix"),
            pipelines={s.instance_id: {k: st[k] for k in ("batches", "dispatched", "meanBatch",
                                                            "scanLaunches", "dedupeHits",
                                                            "stackedLaunches")}
                       for s, st in zip(servers, stats)})
        return n_queries / wall

    mix_qps = run_mix()
    cluster_joins(args, broker, controller, table, cols, work, launches)
    routes.take()

    # failover: server_1 dead, server_0 answers every segment alone
    catalog.set_instance_alive("server_1", False)
    broker.routing.mark_server_unhealthy("server_1")
    for qid, sql, ok, per_server in queries[:2]:
        res, ms, route, counts = checked(f"failover_{qid}", sql, ok, per_server,
                                         servers_expected=["server_0"], strict=False)
        if route["server_0"] != sorted(s.name for s in table):
            raise AssertionError(f"cluster failover {qid}: route {route}")
        log("cluster_failover", query=qid, route=route, launches=counts, answer=res.rows[:3],
            ms=ms, stats={k: res.stats[k] for k in ("numSegmentsQueried", "partialResult",
                                                    "numServersQueried",
                                                    "numSegmentsRetried")})
    for s in servers:
        s.shutdown()

    # the cluster restarted as a QuickCluster of its default per-segment
    # servers (one launch a segment) over the same deep store and data
    # directories: its catalog restored from the roles' snapshot, as a
    # controller recovers, each server loading its assignment from its local
    # disk, as a restarted server does; the FOR table uploaded to it
    qc = QuickCluster(num_servers=CLUSTER_SERVERS, work_dir=root)
    t0 = time.perf_counter()
    qc.catalog.restore(catalog.snapshot())
    for s in qc.servers:
        s.reconcile(name)
    qc_restore_s = time.perf_counter() - t0
    for_schema = Schema("lineorder_for", list(schema.fields))
    qc.create_table(for_schema, TableConfig("lineorder_for"))
    for s in qc.servers:
        qc.broker.register_server_handle(s.instance_id, routes.wrap(s.instance_id,
                                                                    s.execute_partial),
                                         explain_handle=s.explain_partial)
    t0 = time.perf_counter()
    upload_all(qc.controller, "lineorder_for_OFFLINE", for_table)
    qc_upload_s = time.perf_counter() - t0
    for_cols = {k: v[:sum(s.num_docs for s in for_table)] for k, v in cols.items()}
    broker = qc.broker
    for qid, sql, oracle, kernel, segs in (
            ("q1_1", QUERY, oracle_q11(cols), "masked_sums", table),
            ("for_sum", FOR_QUERY.replace("FROM lineorder", "FROM lineorder_for"),
             oracle_for(for_cols), "masked_sums_fused", for_table)):
        reset_launch_counts()
        routes.take()
        t0 = time.perf_counter()
        res = broker.handle_query(sql)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        route = routes.take()
        counts = launch_counts()
        want = counts_of(**{kernel: sum(len(v) for v in route.values())})
        if counts != want or sum(len(v) for v in route.values()) != len(segs):
            raise AssertionError(f"cluster per_segment {qid}: launches {counts}, expected "
                                 f"{want} for the route {route}")
        if not rows_match(res.rows, oracle) or res.stats["partialResult"] \
                or res.stats["numSegmentsRetried"] or res.stats["numSegmentsQueried"] != len(segs):
            raise AssertionError(f"cluster per_segment {qid}: {res.rows} {res.stats}")
        for k, v in counts.items():
            launches[k] += v
        times = []
        for _ in range(CLUSTER_RUNS):
            t0 = time.perf_counter()
            r = broker.handle_query(sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not rows_match(r.rows, oracle):
                raise AssertionError(f"cluster per_segment {qid}: a warm answer {r.rows}")
        log("cluster_per_segment", query=qid, rows=sum(s.num_docs for s in segs),
            segments=len(segs), route=route, launches=counts, answer=res.rows,
            cold_ms=cold_ms, warm_median_ms=statistics.median(times),
            restore_s=qc_restore_s, for_upload_s=qc_upload_s)
    CLUSTER_STATE.update(root=root, snapshot=qc.catalog.snapshot())
    qc.shutdown()
    log("cluster_summary", broker_warm_median_ms=numbers, set_path_warm_median_ms=set_ms,
        broker_mix_qps=mix_qps,
        serve_pipeline=SERVE_MIX_NUMBERS.get("e2e_mix"))
    return launches


# -- phase 18: realtime_cluster --------------------------------------------------------

RT_CLUSTER_PARTITIONS = 2
RT_CLUSTER_PARTITION_ROWS = 1_310_720   # each partition commits twice, 262,144 rows left
RT_CLUSTER_FLUSH_ROWS = 524_288         # realtime.segment.flush.threshold.rows
RT_CLUSTER_BLOCK_ROWS = 65_536          # rows a PCB1 block message carries
RT_CLUSTER_ROUND_BLOCKS = 4             # blocks a partition gets a round: 262,144 rows
RT_CLUSTER_WARM_RUNS = 5
RT_CLUSTER_SEED = 13                    # --seed + 13: no other phase's data
# device bytes the phase's resident memory (past the live consumers' staging
# and the GROUP BY workspaces, the committed segments' blocks and the
# pipelines' caches dropped) may grow by between two of its points. On an
# NVIDIA H100 80GB HBM3 (700 W limit) the phase grew by at most 3,840 bytes
# (the small buffers of the pipelines' first launches); one leaked int32
# column of one 65,536-row block (256 KiB) exceeds the slack, one retired
# consumer's staging (24 MiB) exceeds it a hundredfold
RT_CLUSTER_MEMORY_SLACK = 128 << 10
RT_FAILOVER_TTL_S = 2.0                 # the leader's lease: a standby takes over 2 s after
RT_FAILOVER_POLL_S = 0.05               # its last renewal, polling at this interval


def device_bytes() -> int:
    """The card's allocated bytes, with the process's garbage collected and
    cuBLAS's workspaces dropped (a thread's first matmul on a stream makes
    one through the allocator)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of the distinct tensors in `obj` (a tensor, or dicts, tuples
    and lists of them)."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel())
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v, seen) for v in obj)
    return 0


def workspace_bytes(seen=None) -> int:
    """Device bytes of `grouped_agg`'s zeroed workspaces, one a stream that
    launched it (a pipeline's thread makes its own on its first GROUP BY)."""
    from pinot_tpu_torch.engine import grouped
    return tensor_bytes(list(grouped._workspaces.values()), seen)


# the objects that may keep a device tensor alive, named by their class
HOLDER_TYPES = frozenset(("SegmentBlock", "SegmentSetBlock", "MergedSegmentView", "ConsumingView",
                          "DeviceMutableSegment", "ImmutableSegment", "MeshQueryExecutor",
                          "ServerQueryExecutor", "DeviceQueryPipeline",
                          "RealtimePartitionConsumer"))


def running_frame_locals() -> dict:
    """id of each value a running frame holds -> "thread <name>: <function>
    (file:line)". `gc.get_referrers` does not see the locals of a frame that
    is executing, in this thread or another (a pipeline's dispatcher)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    own = (tensor_holder.__code__, new_tensor_holders.__code__,
           running_frame_locals.__code__)
    out = {}
    for ident, frame in sys._current_frames().items():
        while frame is not None:
            if frame.f_code not in own:
                label = (f"thread {names.get(ident, ident)}: {frame.f_code.co_name} "
                         f"({os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno})")
                for v in frame.f_locals.values():
                    out.setdefault(id(v), label)
            frame = frame.f_back
    return out


def tensor_holder(obj, skip: set, running: dict, calls: int = 48) -> str:
    """What keeps `obj` alive: a running frame (`running`, from
    `running_frame_locals`), a frame, a module or an object of a
    HOLDER_TYPES class, the first found among its referrers breadth first,
    within `calls` calls of `gc.get_referrers` (objects whose ids are in
    `skip` are passed over)."""
    own = (tensor_holder.__code__, new_tensor_holders.__code__)
    frontier, seen = [obj], set(skip) | {id(obj)}
    while frontier and calls > 0:
        nxt = []
        seen.update((id(frontier), id(nxt)))
        for o in frontier[:calls]:
            calls -= 1
            if id(o) in running:
                return running[id(o)]
            for r in gc.get_referrers(o):
                if id(r) in seen:
                    continue
                seen.add(id(r))
                if isinstance(r, type(sys._getframe())):
                    if r.f_code not in own:
                        return (f"frame {r.f_code.co_name} "
                                f"({os.path.basename(r.f_code.co_filename)}:{r.f_lineno})")
                    continue
                if isinstance(r, type(sys)):
                    return f"module {r.__name__}"
                kind = type(r).__name__
                if kind in HOLDER_TYPES:
                    name = getattr(r, "name", None) or getattr(
                        getattr(r, "segment", None), "name", None)
                    return f"{kind} {name}" if isinstance(name, str) else kind
                nxt.append(r)
        frontier = nxt
    return "not reached"


def device_tensor_keys() -> set:
    """(data pointer, elements) of each device tensor the interpreter holds."""
    return {(o.data_ptr(), o.numel()) for o in gc.get_objects()
            if isinstance(o, torch.Tensor) and o.device.type != "cpu"}


def new_tensor_holders(known: set, top: int = 8) -> dict:
    """The device tensors the interpreter holds whose keys are not in
    `known`: their count and bytes, and the bytes of the `top` largest by
    what holds them (`tensor_holder`, tried on each tensor that shares the
    storage: a view keeps its base alive from C++, where no referrer shows)."""
    found, seen, sharing = [], set(known), collections.defaultdict(list)
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.device.type != "cpu":
            sharing[o.untyped_storage().data_ptr()].append(o)
            key = (o.data_ptr(), o.numel())
            if key not in seen:
                seen.add(key)
                found.append(o)
    found.sort(key=lambda t: -t.numel() * t.element_size())
    by_holder = collections.Counter()
    running = running_frame_locals() if top else {}
    skip = {id(found), id(seen), id(sharing)} | {id(v) for v in sharing.values()}
    for i in range(min(top, len(found))):
        holder = "not reached"
        for t in sharing[found[i].untyped_storage().data_ptr()]:
            holder = tensor_holder(t, skip, running)
            if holder != "not reached":
                break
        by_holder[holder] += found[i].numel() * found[i].element_size()
    out = {"tensors": len(found), "bytes": sum(t.numel() * t.element_size() for t in found),
           "largest_by_holder": dict(by_holder.most_common())}
    found.clear()
    sharing.clear()
    return out


def staged_bytes(consumers, seen=None) -> int:
    """Device bytes the consumers hold: their staged chunks and their
    views' blocks (each tensor's key added to `seen`)."""
    seen, total = set() if seen is None else seen, 0
    for c in consumers:
        store = c.mutable
        total += tensor_bytes(list(store._dev_chunks.values()), seen)
        view = getattr(store, "_view", None)
        if view is not None:
            for blk in view._device_blocks.values():
                total += tensor_bytes(vars(blk), seen)
    return total


def llc_commit_offsets(partition_rows: int, block_rows: int, round_blocks: int,
                       flush_rows: int) -> list:
    """The (start, end) message offsets of the segments a partition commits
    when every round consumes `round_blocks` blocks and a segment commits at
    the end of the round its rows reach `flush_rows` (the JAX package's rule:
    the end offset is where the consumer stood when it reported)."""
    out, start, at, total = [], 0, 0, partition_rows // block_rows
    while at < total:
        at = min(at + round_blocks, total)
        if (at - start) * block_rows >= flush_rows:
            out.append((start, at))
            start = at
    return out


def realtime_cluster_queries():
    """(id, sql, oracle, launches on a server the route gives committed
    segments (its pipeline: one launch for the set), launches a consuming
    segment (the per-segment executor over its staged view)). Q1.1's
    filtered columns are raw on a view, so it runs the body there; its
    dictionary bands on the committed set take the scan; the two
    `lo_region = 'ASIA'` sums take `masked_sums` (raw f32 lo_revenue) and
    `masked_sums_fused` (lo_quantity in FOR form) on a view."""
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY
    return [
        ("count", "SELECT COUNT(*) FROM lineorder", lambda c: [[len(c["lo_quantity"])]],
         counts_of(), counts_of()),
        ("q1_1", QUERY, oracle_q11, counts_of(masked_sums=1), counts_of()),
        ("group_by", GROUP_QUERY, oracle_group, counts_of(grouped_agg=1),
         counts_of(grouped_agg=1)),
        ("scan_f32", REALTIME_F32_QUERY, lambda c: oracle_region_sum(c, "lo_revenue"),
         counts_of(masked_sums=1), counts_of(masked_sums=1)),
        ("scan_for", REALTIME_FOR_QUERY, lambda c: oracle_region_sum(c, "lo_quantity"),
         counts_of(masked_sums=1), counts_of(masked_sums_fused=1)),
    ]


def run_realtime_cluster(args, work) -> dict:
    """Phase 18: a REALTIME table consumed through the cluster roles past
    its flush threshold. A Catalog, Controller and Broker and two
    ServerNodes on the card, each with a DeviceQueryPipeline for committed
    segments and reporting to the controller's LLC segment manager; a
    REALTIME lineorder table with replication 2 on a MemoryStream topic of 2
    partitions (PCB1 blocks of RT_CLUSTER_BLOCK_ROWS, consuming segments
    staged on the card, `realtime.segment.flush.threshold.rows`
    RT_CLUSTER_FLUSH_ROWS), each partition fed RT_CLUSTER_PARTITION_ROWS rows
    in rounds of RT_CLUSTER_ROUND_BLOCKS blocks: each round pumps and
    completes every consumer, then sends the queries through the broker, each
    held to the numpy oracle of the rows consumed and to the launches its
    route implies. Then an OFFLINE half (2 segments of the stream's rows up
    to its median date) makes the table hybrid, queried under its logical
    name against "offline rows <= boundary plus consumed rows after it".
    Returns the launches of the checked runs."""
    from pinot_tpu_torch.cluster import (Broker, Catalog, Controller, DeviceQueryPipeline,
                                         ServerNode)
    from pinot_tpu_torch.cluster.catalog import ONLINE, STATUS_DONE, STATUS_IN_PROGRESS
    from pinot_tpu_torch.cluster.completion import parse_llc_name
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.cluster.leadership import ControllerFailover, LeaderElection
    from pinot_tpu_torch.ingest.stream import MemoryStream
    from pinot_tpu_torch.ingest.vectorized import encode_columnar_block
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    from pinot_tpu_torch.segment.writer import SegmentBuilder
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY, make_columns, ssb_schema
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType
    from pinot_tpu_torch.utils.events import get_journal

    root = os.path.join(work, "realtime_cluster")
    schema = ssb_schema()
    parts = RT_CLUSTER_PARTITIONS
    t0 = time.perf_counter()
    data = [make_columns(RT_CLUSTER_PARTITION_ROWS, args.seed + RT_CLUSTER_SEED + p)
            for p in range(parts)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = [[encode_columnar_block(schema, {c: v[lo:lo + RT_CLUSTER_BLOCK_ROWS]
                                              for c, v in cols.items()})
               for lo in range(0, RT_CLUSTER_PARTITION_ROWS, RT_CLUSTER_BLOCK_ROWS)]
              for cols in data]
    encode_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    catalog = Catalog()
    store = LocalDeepStore(os.path.join(root, "deepstore"))
    controller = Controller("controller_0", catalog, store, os.path.join(root, "controller"))
    # the controller leads: every catalog event from here on checkpoints the
    # catalog to the deep store
    journal_since = get_journal().events_since(0)["cursor"]
    failover = ControllerFailover(controller, LeaderElection(store, "controller_0",
                                                             lease_ttl_s=RT_FAILOVER_TTL_S))
    if not failover.lead():
        raise AssertionError("realtime_cluster: the controller did not take the free lease")
    servers = [ServerNode(f"server_{i}", catalog, store, os.path.join(root, f"server_{i}"),
                          device_pipeline=DeviceQueryPipeline(MeshQueryExecutor()),
                          completion=controller.llc)
               for i in range(CLUSTER_SERVERS)]
    for s in servers:
        controller.ingestion_pollers[s.instance_id] = s.ingestion_snapshot
    broker = Broker("broker_0", catalog)
    dispatches = []   # (table, server, segments) of each broker dispatch

    def wrap(sid, handle):
        def call(table, ctx, segments, tf=None):
            dispatches.append((table, sid, list(segments)))
            return handle(table, ctx, segments, tf)
        return call
    for s in servers:
        broker.register_server_handle(s.instance_id, wrap(s.instance_id, s.execute_partial))
    topic = "lineorder_rt_cluster"
    MemoryStream.reset_all()
    cfg = TableConfig("lineorder", table_type=TableType.REALTIME,
                      replication=CLUSTER_REPLICATION, time_column="lo_orderdate",
                      stream=StreamConfig(topic=topic, decoder="columnar",
                                          flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
                                          properties={"realtime.ingest.device.staging":
                                                      "true"}))
    name = cfg.table_name_with_type
    controller.add_schema(schema)
    MemoryStream.create(topic, parts)
    first = controller.add_realtime_table(cfg, parts)
    wire_s = time.perf_counter() - t0

    # the protocol's responses, and each commit from its start to ONLINE on
    # both replicas
    responses = collections.defaultdict(list)
    commit_t0, commit_s, online = {}, {}, collections.defaultdict(set)
    consumed_fn, start_fn = controller.llc.segment_consumed, controller.llc.segment_commit_start
    report_fn = catalog.report_state

    def consumed(segment, server, offset):
        resp = consumed_fn(segment, server, offset)
        responses[segment].append((server, resp["status"]))
        return resp

    def commit_start(segment, server):
        commit_t0[segment] = time.perf_counter()
        return start_fn(segment, server)

    def report(table, segment, server, state):
        report_fn(table, segment, server, state)
        if state == ONLINE and segment in commit_t0 and segment not in commit_s:
            online[segment].add(server)
            if len(online[segment]) == CLUSTER_REPLICATION:
                commit_s[segment] = time.perf_counter() - commit_t0[segment]
    controller.llc.segment_consumed = consumed
    controller.llc.segment_commit_start = commit_start
    catalog.report_state = report
    log("realtime_cluster_data", rows=parts * RT_CLUSTER_PARTITION_ROWS, partitions=parts,
        seed=args.seed + RT_CLUSTER_SEED, block_rows=RT_CLUSTER_BLOCK_ROWS,
        round_blocks=RT_CLUSTER_ROUND_BLOCKS, flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
        servers=CLUSTER_SERVERS, replication=CLUSTER_REPLICATION, consuming=first,
        generate_s=gen_s, encode_s=encode_s, wire_s=wire_s)

    launches = counts_of()
    queries = realtime_cluster_queries()

    def metas():
        with catalog._lock:
            return {t: dict(segs) for t, segs in catalog.segments.items()}

    server_by_id = {s.instance_id: s for s in servers}

    def expected_launches(on_committed, on_view):
        """The launches the last query's dispatches imply: one set's on each
        (table, server) given committed segments, one view's a consuming
        segment that holds rows."""
        m = metas()
        want = counts_of()
        for table, sid, segs in dispatches:
            consuming = [s for s in segs if m.get(table, {})[s].status == STATUS_IN_PROGRESS]
            rt = server_by_id[sid].realtime_manager(table)
            views = sum(rt.consumers[s].mutable.num_docs > 0 for s in consuming)
            for k in want:
                want[k] += on_view[k] * views + on_committed[k] * (len(consuming) < len(segs))
        return want

    def checked(label, sql, want_rows, on_committed, on_view):
        """One broker query: counts set to 0 just before, read just after,
        held to its dispatches; the answer to its oracle."""
        dispatches.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = broker.handle_query(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        want = expected_launches(on_committed, on_view)
        if counts != want:
            raise AssertionError(f"realtime_cluster {label}: launches {counts}, expected {want} "
                                 f"for the dispatches {dispatches}")
        if not rows_match(res.rows, want_rows):
            raise AssertionError(f"realtime_cluster {label}: {res.rows[:5]}, oracle "
                                 f"{want_rows[:5]}")
        if res.stats["partialResult"] or res.stats["numSegmentsRetried"]:
            raise AssertionError(f"realtime_cluster {label}: stats {res.stats}")
        for k, v in counts.items():
            launches[k] += v
        return res, ms, counts

    commits = llc_commit_offsets(RT_CLUSTER_PARTITION_ROWS, RT_CLUSTER_BLOCK_ROWS,
                                 RT_CLUSTER_ROUND_BLOCKS, RT_CLUSTER_FLUSH_ROWS)

    def llc_segment_start(at: int) -> int:
        """The start offset of the segment consuming once `at` blocks were
        sent (the end offset of the last commit at or before it)."""
        return max([end for _, end in commits if end <= at], default=0)

    managers = [s.realtime_manager(name) for s in servers]
    if any(m is None for m in managers):
        raise AssertionError("realtime_cluster: a server made no realtime manager")
    # device memory at each point the committed segments' blocks and the
    # pipelines' caches are dropped: before each round that commits, after
    # the last commit and after the hybrid queries. Past the live
    # consumers' staging and the GROUP BY workspaces it must not grow from
    # one point to the next by more than the slack; what is new since the
    # first point is named by its holders
    residues, known = [], set()

    def resident(point: str) -> None:
        for s in servers:
            for mgr in list(s.tables.values()):
                for seg in mgr.acquire():
                    seg.__dict__.pop("_device_blocks", None)
                    mgr.release([seg])
            mx = s.device_pipeline.mesh_exec
            for cache in (mx._set_blocks, mx._views, mx._const_cache):
                cache.clear()
        allocated = device_bytes()
        accounted = set()
        staged = staged_bytes([c for mg in managers for c in mg.consumers.values()], accounted)
        workspace = workspace_bytes(accounted)
        if not residues:
            known.update(device_tensor_keys())
        at = {"point": point, "allocated_bytes": allocated, "staged_bytes": staged,
              "workspace_bytes": workspace, "resident_bytes": allocated - staged - workspace}
        at["grew_bytes"] = at["resident_bytes"] - (residues[-1]["resident_bytes"]
                                                   if residues else at["resident_bytes"])
        at["new_tensors"] = new_tensor_holders(known | accounted, top=0)
        if max(at["grew_bytes"], at["resident_bytes"] - (residues or [at])[0]["resident_bytes"]) \
                > RT_CLUSTER_MEMORY_SLACK or point == "after the hybrid queries":
            at["new_tensors"] = new_tensor_holders(known | accounted)
        residues.append(at)
        log("realtime_cluster_memory_point", **at)

    sent = [0] * parts
    pump_s = pumped = 0.0
    rounds = -(-RT_CLUSTER_PARTITION_ROWS // (RT_CLUSTER_BLOCK_ROWS * RT_CLUSTER_ROUND_BLOCKS))
    commit_rounds = sorted({-(-end // RT_CLUSTER_ROUND_BLOCKS) - 1 for _, end in commits})
    seen = {}   # every consumer the managers held: id -> consumer
    for r in range(rounds):
        seen.update((id(c), c) for m in managers for c in m.consumers.values())
        if r in commit_rounds:
            resident(f"before round {r}'s commits")
        t_prod = time.perf_counter()
        for p in range(parts):
            batch = blocks[p][sent[p]:sent[p] + RT_CLUSTER_ROUND_BLOCKS]
            for blob in batch:
                MemoryStream.get(topic).produce(blob, partition=p)
            sent[p] += len(batch)
        round_pump = round_rows = 0.0
        t_round = time.perf_counter()
        for m in managers:
            t0 = time.perf_counter()
            round_rows += m.pump_all()
            torch.cuda.synchronize()
            round_pump += time.perf_counter() - t0
            m.complete_all()
        round_s = time.perf_counter() - t_round
        pump_s += round_pump
        pumped += round_rows
        consumed_cols = {k: np.concatenate([data[p][k][:sent[p] * RT_CLUSTER_BLOCK_ROWS]
                                            for p in range(parts)]) for k in data[0]}
        fields, staleness_s = {}, None
        # the freshness a consuming segment reports is the largest event
        # time it indexed, read from the table's time column (lo_orderdate,
        # yyyymmdd) as the JAX package reads it, else when it started (epoch
        # ms); the broker keeps the least
        fresh = min((int(data[p]["lo_orderdate"][lo:sent[p] * RT_CLUSTER_BLOCK_ROWS].max())
                     for p in range(parts)
                     for lo in [llc_segment_start(sent[p]) * RT_CLUSTER_BLOCK_ROWS]
                     if sent[p] > llc_segment_start(sent[p])), default=None)
        for qid, sql, oracle, on_committed, on_view in queries:
            res, ms, counts = checked(f"round {r} {qid}", sql, oracle(consumed_cols),
                                      on_committed, on_view)
            if staleness_s is None:
                staleness_s = time.perf_counter() - t_prod
            st = res.stats
            got_fresh = st.get("minConsumingFreshnessTimeMs")
            if st.get("numConsumingSegmentsQueried") != parts or (
                    got_fresh != fresh if fresh is not None
                    else not time.time() * 1000 - 3_600_000 < got_fresh <= time.time() * 1000):
                raise AssertionError(f"realtime_cluster round {r} {qid}: consuming stats "
                                     f"{st.get('numConsumingSegmentsQueried')}, "
                                     f"{st.get('minConsumingFreshnessTimeMs')} (want {parts}, "
                                     f"{fresh})")
            fields[qid] = {"ms": ms, "launches": counts, "answer": res.rows[:3],
                           "consuming_queried": res.stats.get("numConsumingSegmentsQueried"),
                           "min_freshness_ms": res.stats.get("minConsumingFreshnessTimeMs")}
        if not failover.heartbeat():
            raise AssertionError(f"realtime_cluster round {r}: the controller lost its lease")
        m = metas()[name]
        log("realtime_cluster_round", round=r, rows=int(sum(sent) * RT_CLUSTER_BLOCK_ROWS),
            pumped_rows=int(round_rows), pump_s=round_pump,
            consume_rows_per_s=round_rows / round_pump if round_pump else None,
            round_s=round_s, staleness_s=staleness_s,
            segments={s: {"status": x.status, "start": x.start_offset, "end": x.end_offset,
                          "docs": x.num_docs} for s, x in sorted(m.items())},
            live_staged_bytes=staged_bytes([c for mg in managers
                                            for c in mg.consumers.values()]),
            device_bytes=device_bytes(), queries=fields)

    # the protocol: each committed segment ONLINE on both replicas at the
    # JAX package's offsets, one COMMIT each, the other replica KEEP or DISCARD
    want_offsets = llc_commit_offsets(RT_CLUSTER_PARTITION_ROWS, RT_CLUSTER_BLOCK_ROWS,
                                      RT_CLUSTER_ROUND_BLOCKS, RT_CLUSTER_FLUSH_ROWS)
    m = metas()[name]
    with catalog._lock:
        ev = {s: dict(a) for s, a in catalog.external_view.get(name, {}).items()}
    committed = {s: x for s, x in m.items() if x.status == STATUS_DONE}
    for p in range(parts):
        got = sorted((x.sequence_number, int(x.start_offset), int(x.end_offset))
                     for x in committed.values() if x.partition_group == p)
        if [(a, b) for _, a, b in got] != want_offsets:
            raise AssertionError(f"realtime_cluster: partition {p} committed {got}, "
                                 f"expected offsets {want_offsets}")
    handoffs = [mg.handoffs for mg in managers]
    for seg, x in committed.items():
        commits = [sv for sv, st in responses[seg] if st == "COMMIT"]
        decisions = sorted(h.get(seg) for h in handoffs)
        if len(commits) != 1 or decisions[0] != "COMMIT" \
                or decisions[1] not in ("DISCARD", "KEEP") \
                or set(ev.get(seg, {}).values()) != {ONLINE} or len(ev[seg]) != 2 \
                or x.num_docs != (int(x.end_offset) - int(x.start_offset)) * RT_CLUSTER_BLOCK_ROWS:
            raise AssertionError(f"realtime_cluster: {seg} responses {responses[seg]}, handoffs "
                                 f"{decisions}, external view {ev.get(seg)}, docs {x.num_docs}")
    log("realtime_cluster_commits", committed=len(committed),
        commit_s={s: commit_s.get(s) for s in sorted(committed)},
        responses={s: responses[s] for s in sorted(committed)},
        handoffs={s: sorted(h.get(s) for h in handoffs) for s in sorted(committed)},
        offsets={s: (parse_llc_name(s)["partition"], x.start_offset, x.end_offset)
                 for s, x in sorted(committed.items())},
        consume_rows_per_s=pumped / pump_s, pumped_rows=int(pumped), pump_s=pump_s)

    # warm latency on the REALTIME table, then the OFFLINE half
    final = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    warm = {}

    def warm_runs(label, sql, want_rows, on_committed, on_view):
        times = []
        for _ in range(RT_CLUSTER_WARM_RUNS):
            _, ms, _ = checked(label, sql, want_rows, on_committed, on_view)
            times.append(ms)
        warm[label] = {"warm_median_ms": statistics.median(times), "warm_min_ms": min(times),
                       "warm_max_ms": max(times), "warm_runs": len(times)}

    query_by_id = {q[0]: q for q in queries}
    for qid in ("q1_1", "group_by"):
        _, sql, oracle, on_committed, on_view = query_by_id[qid]
        warm_runs(f"realtime {qid}", sql, oracle(final), on_committed, on_view)
    resident("after the last commit")

    t0 = time.perf_counter()
    dates = np.sort(final["lo_orderdate"])
    boundary_date = int(dates[len(dates) // 2])   # a date the stream holds
    low = final["lo_orderdate"] <= boundary_date
    offline = {k: v[low] for k, v in final.items()}
    n_off = int(low.sum())
    off_cfg = TableConfig("lineorder", replication=CLUSTER_REPLICATION,
                          time_column="lo_orderdate")
    controller.add_table(off_cfg)
    builder = SegmentBuilder(schema)
    for i, (lo, hi) in enumerate(((0, n_off // 2), (n_off // 2, n_off))):
        seg_dir = builder.build({k: v[lo:hi] for k, v in offline.items()},
                                os.path.join(root, "offline_build"), f"lineorder_offline_{i}")
        controller.upload_segment(off_cfg.table_name_with_type, seg_dir)
    offline_s = time.perf_counter() - t0
    boundary = int(offline["lo_orderdate"].max())
    high = final["lo_orderdate"] > boundary
    hybrid = {k: np.concatenate([offline[k], final[k][high]]) for k in final}
    hybrid_answers = {}
    for qid in ("q1_1", "group_by"):
        _, sql, oracle, on_committed, on_view = query_by_id[qid]
        res, ms, counts = checked(f"hybrid {qid}", sql, oracle(hybrid), on_committed, on_view)
        hybrid_answers[qid] = {"cold_ms": ms, "launches": counts, "answer": res.rows[:3],
                               "tables": sorted({t for t, _, _ in dispatches}),
                               "consuming_queried": res.stats.get(
                                   "numConsumingSegmentsQueried")}
        warm_runs(f"hybrid {qid}", sql, oracle(hybrid), on_committed, on_view)
    log("realtime_cluster_hybrid", boundary=boundary, offline_rows=n_off,
        realtime_rows_after_boundary=int(high.sum()), offline_build_upload_s=offline_s,
        queries=hybrid_answers)
    log("realtime_cluster_latency", **warm)

    # the retired consumers hold no device bytes, and the card's resident
    # bytes did not grow from one point to the next
    resident("after the hybrid queries")
    consumers = [c for mg in managers for c in mg.consumers.values()]
    live = {id(c) for c in consumers}
    retired = [c for k, c in seen.items() if k not in live]
    retired_bytes = staged_bytes(retired)
    log("realtime_cluster_memory", retired_consumers=len(retired),
        retired_staged_bytes=retired_bytes, slack_bytes=RT_CLUSTER_MEMORY_SLACK,
        resident_bytes=[at["resident_bytes"] for at in residues],
        grew_bytes=[at["grew_bytes"] for at in residues])
    if len(retired) != CLUSTER_REPLICATION * len(committed) or retired_bytes:
        raise AssertionError(f"realtime_cluster: {len(retired)} retired consumers hold "
                             f"{retired_bytes} device bytes")
    for at in residues:
        if max(at["grew_bytes"], at["resident_bytes"] - residues[0]["resident_bytes"]) \
                > RT_CLUSTER_MEMORY_SLACK:
            raise AssertionError(f"realtime_cluster: device memory grew {at['grew_bytes']} "
                                 f"bytes up to {at['point']} ({at['resident_bytes']} resident, "
                                 f"{residues[0]['resident_bytes']} at the first point), "
                                 f"past the live consumers' "
                                 f"staging and the GROUP BY workspaces, over the "
                                 f"{RT_CLUSTER_MEMORY_SLACK} slack: {at['new_tensors']}")
    if not (launches["masked_sums"] and launches["grouped_agg"]):
        raise AssertionError(f"realtime_cluster: launches {launches}")
    realtime_cluster_failover(root, store, controller, failover, servers, name,
                              journal_since)
    for s in servers:
        s.shutdown()
    MemoryStream.reset_all()
    log("realtime_cluster_summary", launches=launches, rounds=rounds,
        commits=len(committed), consume_rows_per_s=pumped / pump_s,
        commit_s_max=max(commit_s.values()) if commit_s else None)
    return launches, (data, blocks)


def realtime_cluster_failover(root, store, controller, failover, servers, name,
                              journal_since) -> None:
    """Phase 18's failover: the leader renews its lease once more and stops
    renewing; a standby Controller with an empty Catalog over
    the same deep store polls `try_takeover` until the lease expires and it
    restores the last checkpoint. Its snapshot must equal the leader's, the
    old leader's heartbeat must fail, and the standby's ingestion verdict
    over the same servers must equal the leader's."""
    from pinot_tpu_torch.cluster import Catalog, Controller
    from pinot_tpu_torch.cluster.leadership import ControllerFailover, LeaderElection
    from pinot_tpu_torch.utils.events import get_journal

    def verdict(st):
        return (st["ingestionState"], st["reasons"], st["paused"], st["numConsumingSegments"],
                st["maxOffsetLag"], sorted(
                    (sid, seg, x["currentOffset"], x["latestStreamOffset"], x["offsetLag"],
                     x["numDocs"], x["freshnessTimeMs"])
                    for sid, srv in st["servers"].items()
                    for seg, x in srv["segments"].items()))

    leader_status = controller.ingestion_status(name)
    leader_snap = json.loads(controller.catalog.snapshot())
    # its last renewal: the takeover is timed from here
    if not failover.heartbeat():
        raise AssertionError("realtime_cluster failover: the leader lost its lease early")
    lease = failover.election._read_lease()
    standby = Controller("controller_1", Catalog(), store, os.path.join(root, "controller_1"))
    standing = ControllerFailover(standby, LeaderElection(store, "controller_1",
                                                          lease_ttl_s=RT_FAILOVER_TTL_S))
    t0 = time.perf_counter()
    polls = 0
    while True:
        polls += 1
        t_try = time.perf_counter()
        if standing.try_takeover():
            takeover_ms = (time.perf_counter() - t_try) * 1e3
            break
        if time.perf_counter() - t0 > RT_FAILOVER_TTL_S + 30.0:
            raise AssertionError(f"realtime_cluster failover: no takeover of {lease}")
        time.sleep(RT_FAILOVER_POLL_S)
    detect_s = time.time() - (lease["deadline"] - RT_FAILOVER_TTL_S)
    standby_snap = json.loads(standby.catalog.snapshot())
    deposed = failover.heartbeat()
    for s in servers:
        standby.ingestion_pollers[s.instance_id] = s.ingestion_snapshot
    standby_status = standby.ingestion_status(name)
    done = {seg: (m["start_offset"], m["end_offset"], m["num_docs"])
            for seg, m in standby_snap["segments"].get(name, {}).items()
            if m["status"] == "DONE"}
    events = [(e["kind"], e["node"]) for e in get_journal().events_since(journal_since)["events"]
              if e["kind"].startswith("leader.")]
    fields = dict(checkpoints=failover.checkpoints, checkpoint_bytes=failover.checkpoint_bytes,
                  checkpoint_ms=failover.checkpoint_s * 1e3,
                  checkpoint_mean_bytes=failover.checkpoint_bytes / max(failover.checkpoints, 1),
                  lease_ttl_s=RT_FAILOVER_TTL_S, polls=polls, takeover_ms=takeover_ms,
                  renewal_to_takeover_s=detect_s, epochs=[failover.election.epoch,
                                                          standing.election.epoch],
                  snapshot_equal=standby_snap == leader_snap,
                  snapshot_keys={k: len(v) for k, v in standby_snap.items()},
                  committed=done, old_leader_heartbeat=deposed,
                  verdict=standby_status["ingestionState"],
                  max_offset_lag=standby_status["maxOffsetLag"], events=events)
    log("realtime_cluster_failover", **fields)
    if standby_snap != leader_snap or not done or any(e is None for _, e, _ in done.values()):
        raise AssertionError(f"realtime_cluster failover: the restored catalog differs from the "
                             f"leader's ({sorted(standby_snap)} / {sorted(leader_snap)})")
    if deposed or standing.election.epoch != failover.election.epoch + 1:
        raise AssertionError(f"realtime_cluster failover: the old leader kept its lease {fields}")
    if verdict(standby_status) != verdict(leader_status):
        raise AssertionError(f"realtime_cluster failover: the standby's verdict "
                             f"{verdict(standby_status)} differs from the leader's "
                             f"{verdict(leader_status)}")
    if events != [("leader.elected", "controller_0"), ("leader.elected", "controller_1"),
                  ("leader.lost", "controller_0")]:
        raise AssertionError(f"realtime_cluster failover: events {events}")


# -- phase 19: process_cluster ---------------------------------------------------------

PROC_CLUSTER_SERVERS = 2
PROC_CLUSTER_REPLICATION = 2
PROC_CLUSTER_RUNS = 5                  # warm runs of each query through the HTTP broker
PROC_CLUSTER_STARTUP_S = 300.0         # each child imports torch and reaches the card
PROC_CLUSTER_QUERYABLE_S = 300.0       # upload -> every segment answered, at most
#: the servers' device: the CPU rehearsal points it at "cpu"
PROC_CLUSTER_DEVICE = "cuda"
PROC_SHUFFLE_JOIN_WARM_RUNS = 2        # the mailbox shuffle's joins: a cold and 2 warm
# the distributed GROUP BYs' warm runs after their cold one: lo_custkey's
# 500,000 keys take none (20-26 s a run on the H100; its cold run is timed)
PROC_SHUFFLE_GROUP_WARM_RUNS = {"custkey_group": 0, "suppkey_var": 1}


class ServerProbe:
    """The server processes' /debug: their kernels' launches (set to 0 with
    POST /debug/launches/reset), pipeline stats and device memory."""

    def __init__(self, urls: dict):
        self.urls = urls

    def debug(self) -> dict:
        from pinot_tpu_torch.cluster.http_service import get_json
        return {sid: get_json(f"{u}/debug", timeout=60.0) for sid, u in self.urls.items()}

    def reset(self) -> None:
        from pinot_tpu_torch.cluster.http_service import post_json
        for u in self.urls.values():
            post_json(f"{u}/debug/launches/reset", {}, timeout=60.0)

    def launches(self, debug: dict = None) -> dict:
        """Each kernel's launches, summed over the servers that answer."""
        out = counts_of()
        for d in (debug or self.debug()).values():
            for k, v in d["kernelLaunches"].items():
                out[k] += v
        return out


def oracle_suppkey_var(c) -> list:
    """GROUPBY_SUPPKEY's rows: VAR_POP(lo_discount) of every lo_suppkey."""
    k, d = c["lo_suppkey"], c["lo_discount"].astype(np.float64)
    n, s1, s2 = np.bincount(k), np.bincount(k, d), np.bincount(k, d * d)
    keys = np.flatnonzero(n)
    var = s2[keys] / n[keys] - (s1[keys] / n[keys]) ** 2
    return [[int(a), float(v)] for a, v in zip(keys, var)][:20000]


def process_cluster_shuffle(args, pc, probe, table, cols, work, numbers) -> dict:
    """The multistage data plane over the server processes (the `shuffle`
    path): phase 7's dimension tables pushed, the four joins on the mailbox
    shuffle, join_supplier on the funnel path, the two distributed GROUP
    BYs beside their scatter/gather time. Each run's launches come from the
    servers' /debug; the broker's fallback counters must stay 0. Returns the
    checked runs' launches."""
    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.ssb import JOIN_QUERIES
    from pinot_tpu_torch.table import TableConfig

    jd = join_data(args, table, cols, work)
    launches = counts_of()
    t0 = time.perf_counter()
    for name in ("supplier", "customer", "region"):
        pc.controller.add_schema(jd["schemas"][name])
        pc.controller.add_table(TableConfig(name, replication=PROC_CLUSTER_REPLICATION))
        for seg in jd["tables"][name]:
            pc.controller.upload_segment(f"{name}_OFFLINE", seg.path)
    deadline = time.perf_counter() + PROC_CLUSTER_QUERYABLE_S
    for name in ("supplier", "customer", "region"):
        rows = sum(s.num_docs for s in jd["tables"][name])
        while True:
            try:
                res = pc.query(f"SELECT COUNT(*) FROM {name}")
                if res["resultTable"]["rows"] == [[rows]] and not res["partialResult"]:
                    break
            except Exception:   # the broker's mirror not caught up yet: poll
                pass
            if time.perf_counter() > deadline:
                raise AssertionError(f"process_cluster shuffle: {name} did not answer")
            time.sleep(0.05)
    log("process_cluster_shuffle_data", upload_to_queryable_s=time.perf_counter() - t0,
        rows={k: sum(s.num_docs for s in v) for k, v in jd["tables"].items()})

    def run(label, sql, ok, want_of, mailbox):
        """One query: the servers' counts set to 0 just before, read just after
        and held to `want_of(response)`; the answer to `ok`; the route to
        `mailbox` (the mailbox shuffle, or none)."""
        probe.reset()
        t0 = time.perf_counter()
        res = pc.broker.query(sql, timeout=600.0)
        ms = (time.perf_counter() - t0) * 1e3
        if "error" in res:
            raise AssertionError(f"process_cluster {label}: {res['error']}")
        counts, want = probe.launches(), want_of(res)
        if counts != want:
            raise AssertionError(f"process_cluster {label}: launches {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        if not ok(res["resultTable"]["rows"]):
            raise AssertionError(f"process_cluster {label}: off the oracle: "
                                 f"{res['resultTable']['rows'][:5]}")
        if bool(res.get("mailboxShuffle") or res.get("distributedGroupBy")) != mailbox:
            raise AssertionError(f"process_cluster {label}: route "
                                 f"{ {k: res.get(k) for k in ('mailboxShuffle', 'distributedGroupBy', 'multistage')} }")
        return res, ms

    join_keys = ("joinStrategy", "numStageWorkers", "joinBuildMs", "joinProbeMs",
                 "joinSkewPct", "joinShuffleBytes", "joinServedHostTier")
    for qid, sql in JOIN_QUERIES.items():
        want = join_launches(qid, len(table))
        oracle = jd["oracles"][qid]

        def ok(rows, oracle=oracle):
            return rows_match(rows, oracle, JOIN_RTOL, JOIN_ATOL)
        out = [run(qid, sql, ok, lambda r, want=want: want, True)
               for _ in range(1 + PROC_SHUFFLE_JOIN_WARM_RUNS)]
        res = out[0][0]
        log("process_cluster_join", query=qid, path="mailbox", launches=want,
            answer=res["resultTable"]["rows"][:3], cold_ms=out[0][1],
            warm_ms=[ms for _, ms in out[1:]], stats={k: res.get(k) for k in join_keys},
            phase_ms=[r.get("phaseTimesMs") for r, _ in out])
        numbers[f"join_{qid}"] = statistics.median(ms for _, ms in out[1:])
    qid = "join_supplier"
    res, ms = run("join_supplier funnel", JOIN_QUERIES[qid] + " OPTION(useMailboxShuffle=false)",
                  lambda rows: rows_match(rows, jd["oracles"][qid], JOIN_RTOL, JOIN_ATOL),
                  lambda r: join_launches(qid, len(table)), False)
    log("process_cluster_join_funnel", query=qid, path="funnel", ms=ms,
        answer=res["resultTable"]["rows"][:3], stats={k: res.get(k) for k in join_keys},
        phase_ms=res.get("phaseTimesMs"), mailbox_ms=numbers["join_join_supplier"])

    custkey, suppkey = oracle_custkey_group(cols), oracle_suppkey_var(cols)
    group_sql = (("custkey_group", GROUPBY_CUSTKEY, lambda rows: custkey_rows_match(rows, custkey)),
                 ("suppkey_var", GROUPBY_SUPPKEY, lambda rows: rows_match(rows, suppkey)))
    for qid, sql, ok in group_sql:
        out = [run(qid, sql + " OPTION(distributedGroupBy=true)", ok,
                   lambda r: counts_of(grouped_agg=len(r["leafGroups"])), True)
               for _ in range(1 + PROC_SHUFFLE_GROUP_WARM_RUNS[qid])]
        if qid not in numbers:   # the scatter/gather answer's time, beside it
            gather = [run(f"{qid} scatter", sql, ok,
                          lambda r: counts_of(grouped_agg=r["numServersResponded"]), False)[1]
                      for _ in range(1 + PROC_SHUFFLE_GROUP_WARM_RUNS[qid])]
            numbers[qid] = statistics.median(gather[1:])
        res = out[0][0]
        log("process_cluster_distributed_group_by", query=qid, cold_ms=out[0][1],
            warm_ms=[ms for _, ms in out[1:]], scatter_gather_warm_median_ms=numbers[qid],
            answer_rows=len(res["resultTable"]["rows"]), leaf_groups=res.get("leafGroups"),
            num_stage_workers=res.get("numStageWorkers"),
            device_routed=res.get("deviceRoutedShuffle", False),
            phase_ms=[r.get("phaseTimesMs") for r, _ in out],
            launches=counts_of(grouped_agg=len(res["leafGroups"])))
    metrics = get_json(f"{pc.broker_url}/debug", timeout=60.0)["brokerMetrics"]
    fallbacks = {k: metrics.get(k, 0) for k in ("pinot_broker_p2p_fallbacks",
                                                "pinot_broker_stage_dispatch_failures")}
    servers = {sid: {k: v for k, v in d["serverMetrics"].items()
                     if "mailbox" in k or "join_stages" in k}
               for sid, d in probe.debug().items()}
    log("process_cluster_shuffle", launches=launches, broker_counters=fallbacks,
        data_plane_bytes=metrics.get("pinot_broker_data_plane_bytes", 0), servers=servers)
    if any(fallbacks.values()):
        raise AssertionError(f"process_cluster shuffle: the broker fell back: {fallbacks}")
    return launches


PROC_RT_TABLE = "lineorder_rt"         # its own logical table beside phase 4's lineorder
PROC_RT_WAIT_S = 120.0                 # a round consumed, a commit ONLINE, at most
PROC_RT_WARM_RUNS = 3
PROC_RT_PEER_ROUND = 3                 # the round whose commits meet the deep store down
PROC_RT_POLL_S = 0.05


def rt_sql(sql: str, table: str = PROC_RT_TABLE) -> str:
    """Phase 18's SQL on a table of the process cluster (process_realtime's
    by default)."""
    return sql.replace("FROM lineorder", f"FROM {table}")


def rt_device_queries(debug: dict, table: str = PROC_RT_TABLE) -> int:
    """The partials the servers ran on their pipelines over the committed
    segments of the logical table (`pinot_server_device_queries`),
    process_realtime's by default."""
    return int(sum(v for d in debug.values() for k, v in d["serverMetrics"].items()
                   if k.startswith("pinot_server_device_queries") and f"table={table}_" in k))


def process_realtime(args, pc, probe, work, stream, cleanups=None) -> dict:
    """Phase 19's realtime sub-phase: phase 18's table and stream across the
    server processes. A kafkalite `LogBrokerServer` in this process (its log
    on the work disk), 2 partitions of phase 18's PCB1 blocks (`--seed + 13`);
    a REALTIME `lineorder_rt` table, replication 2, its consuming segments
    staged on the card, `realtime.segment.flush.threshold.rows`
    RT_CLUSTER_FLUSH_ROWS; the server processes consume it on their own loops
    and commit over HTTP. Each round: the round's blocks produced through
    `LogBrokerClient`, a bounded wait until both replicas consumed them and
    the HTTP broker's COUNT(*) counts them (staleness: produce to that
    answer), the commits ONLINE on both replicas, then phase 18's queries
    through the HTTP broker on their oracles, each run's launches read from
    the servers' /debug and held to the partials the servers ran on their
    pipelines (`pinot_server_device_queries`) and the consuming views that
    hold rows. Round PROC_RT_PEER_ROUND runs with the deep store down: its
    commits take `peer://`, server_1 restarts with its copies of the table
    gone and loads every committed segment from server_0 through
    /segmentData (the deep store's once its download retries run out), then
    the deep store comes back and one validation round heals the peer-scheme
    segments. After the rounds: warm runs; the OFFLINE half (2 segments of
    the rows up to the median date) pushed over HTTP, Q1.1 and GROUP_QUERY on
    the hybrid table. Returns the launches of the checked runs and the new
    URL of server_1. Where it passes and `cleanups` is a list, the tables and
    the broker stay up (later steps read their ingestion status) and the
    call that drops and stops them is appended to it."""
    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.cluster.remote import RemoteServerHandle
    from pinot_tpu_torch.ingest.kafkalite import LogBrokerClient, LogBrokerServer
    from pinot_tpu_torch.schema import Schema
    from pinot_tpu_torch.segment.writer import SegmentBuilder
    from pinot_tpu_torch.ssb import ssb_schema
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType

    data, blocks = stream
    parts = len(data)
    schema = Schema.from_json(dict(ssb_schema().to_json(), schemaName=PROC_RT_TABLE))
    launches = counts_of()
    deep = os.path.join(pc.work_dir, "deepstore")
    t0 = time.perf_counter()
    srv = LogBrokerServer(log_dir=os.path.join(work, "kafkalite"))
    client = LogBrokerClient(srv.bootstrap)
    name = off_name = None
    passed = False
    try:
        client.create_topic(PROC_RT_TABLE, parts)
        cfg = TableConfig(PROC_RT_TABLE, table_type=TableType.REALTIME,
                          replication=PROC_CLUSTER_REPLICATION, time_column="lo_orderdate",
                          stream=StreamConfig(stream_type="kafkalite", topic=PROC_RT_TABLE,
                                              decoder="columnar",
                                              flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
                                              properties={"bootstrap": srv.bootstrap,
                                                          "realtime.ingest.device.staging":
                                                          "true"}))
        name = cfg.table_name_with_type
        pc.controller.add_schema(schema)
        first = pc.controller.add_table(cfg, num_partitions=parts)["consumingSegments"]
        log("process_realtime_data", rows=parts * RT_CLUSTER_PARTITION_ROWS, partitions=parts,
            seed=args.seed + RT_CLUSTER_SEED, block_rows=RT_CLUSTER_BLOCK_ROWS,
            round_blocks=RT_CLUSTER_ROUND_BLOCKS, flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
            replication=PROC_CLUSTER_REPLICATION, consuming=first, bootstrap=srv.bootstrap,
            setup_s=time.perf_counter() - t0)
        queries = [(qid, rt_sql(sql), oracle, on_committed, on_view)
                   for qid, sql, oracle, on_committed, on_view in realtime_cluster_queries()]
        commits = llc_commit_offsets(RT_CLUSTER_PARTITION_ROWS, RT_CLUSTER_BLOCK_ROWS,
                                     RT_CLUSTER_ROUND_BLOCKS, RT_CLUSTER_FLUSH_ROWS)

        def segment_start(at: int) -> int:
            return max([end for _, end in commits if end <= at], default=0)

        def wait(label, ready):
            deadline = time.perf_counter() + PROC_RT_WAIT_S
            while True:
                try:
                    out = ready()
                except Exception:   # a mirror or a restarted server catching up: poll
                    out = None
                if out:
                    return out
                if time.perf_counter() > deadline:
                    raise AssertionError(f"process_realtime: {label} not within "
                                         f"{PROC_RT_WAIT_S} s")
                time.sleep(PROC_RT_POLL_S)

        def snapshot():
            return get_json(f"{pc.controller_url}/catalog/snapshot", timeout=60.0)

        def freshness():
            """The least freshness of the consuming segments: the largest
            event time (lo_orderdate) a segment holding rows indexed, None
            where none holds rows (each then reports when it started)."""
            return min((int(data[p]["lo_orderdate"][lo:sent[p] * RT_CLUSTER_BLOCK_ROWS].max())
                        for p in range(parts)
                        for lo in [segment_start(sent[p]) * RT_CLUSTER_BLOCK_ROWS]
                        if sent[p] > segment_start(sent[p])), default=None)

        def checked(label, sql, want_rows, on_committed, on_view, views, consuming):
            """One query over HTTP: the servers' counts set to 0 just before,
            read just after, held to on_committed a pipeline partial over the
            committed segments plus on_view a consuming view with rows; the
            answer to its oracle; the consuming stats to the stream's."""
            probe.reset()
            before = rt_device_queries(probe.debug())
            t_q = time.perf_counter()
            res = pc.broker.query(sql, timeout=600.0)
            ms = (time.perf_counter() - t_q) * 1e3
            debug = probe.debug()
            counts = probe.launches(debug)
            piped = rt_device_queries(debug) - before
            want = {k: on_committed[k] * piped + on_view[k] * views for k in counts}
            if counts != want:
                raise AssertionError(f"process_realtime {label}: launches {counts}, expected "
                                     f"{want} ({piped} pipeline partials, {views} views)")
            got = res["resultTable"]["rows"]
            if not rows_match(got, want_rows):
                raise AssertionError(f"process_realtime {label}: {got[:5]}, oracle "
                                     f"{want_rows[:5]}")
            fresh, got_fresh = freshness(), res.get("minConsumingFreshnessTimeMs")
            now_ms = time.time() * 1000
            if res["partialResult"] or res["numSegmentsRetried"] or \
                    res.get("numConsumingSegmentsQueried") != consuming or (
                        got_fresh != fresh if fresh is not None
                        else not now_ms - 3_600_000 < got_fresh <= now_ms):
                raise AssertionError(f"process_realtime {label}: stats (freshness {fresh}) "
                                     f"{ {k: v for k, v in res.items() if k != 'resultTable'} }")
            for k, v in counts.items():
                launches[k] += v
            return res, ms, counts

        sent = [0] * parts
        rounds = -(-RT_CLUSTER_PARTITION_ROWS // (RT_CLUSTER_BLOCK_ROWS * RT_CLUSTER_ROUND_BLOCKS))
        memory = {"before the commits": {s: d["deviceMemory"] for s, d in probe.debug().items()}}
        consume_rate, commit_online_s = [], {}
        lanes = set()
        peer_segments, peer = [], {}
        for r in range(rounds):
            if r == PROC_RT_PEER_ROUND:
                # the deep store down: its root a regular file
                os.rename(deep, deep + ".parked")
                with open(deep, "w") as f:
                    f.write("outage")
            t_prod = time.perf_counter()
            for p in range(parts):
                for blob in blocks[p][sent[p]:sent[p] + RT_CLUSTER_ROUND_BLOCKS]:
                    client.produce(PROC_RT_TABLE, blob, partition=p)
                sent[p] = min(sent[p] + RT_CLUSTER_ROUND_BLOCKS, len(blocks[p]))
            produce_s = time.perf_counter() - t_prod
            total = sum(sent) * RT_CLUSTER_BLOCK_ROWS
            # both replicas consumed the round: every consumer at its
            # partition's offset, and the broker counting every row
            def consumed():
                debug = probe.debug()
                offs = [c["offset"] for d in debug.values()
                        for c in d["consumers"].get(name, {}).values()
                        if c["state"] in ("INITIAL_CONSUMING", "CATCHING_UP", "HOLDING")]
                return len(offs) == parts * PROC_CLUSTER_REPLICATION and \
                    sorted(offs) == sorted(sent * PROC_CLUSTER_REPLICATION) and debug
            debug = wait(f"round {r} consumed", consumed)
            consumed_s = time.perf_counter() - t_prod
            consume_rate.append(PROC_CLUSTER_REPLICATION * RT_CLUSTER_ROUND_BLOCKS * parts
                                * RT_CLUSTER_BLOCK_ROWS / consumed_s)
            for d in debug.values():
                lanes.update(c["lastDecodePath"] for c in d["consumers"].get(name, {}).values()
                             if c["lastDecodePath"])
            wait(f"round {r} counted", lambda: pc.query(
                f"SELECT COUNT(*) FROM {PROC_RT_TABLE}")["resultTable"]["rows"] == [[total]])
            staleness_s = time.perf_counter() - t_prod
            # this round's commits, ONLINE on both replicas
            want_done = sum(end <= sent[0] for _, end in commits) * parts

            def online():
                snap = snapshot()
                done = {s: m for s, m in snap["segments"].get(name, {}).items()
                        if m["status"] == "DONE"}
                ev = snap["externalView"].get(name, {})
                if len(done) == want_done and all(
                        sorted(ev.get(s, {}).values()) == ["ONLINE"] * PROC_CLUSTER_REPLICATION
                        for s in done):
                    return (done,)
                return None
            (done,) = wait(f"round {r} commits online", online)
            for s in done:
                commit_online_s.setdefault(s, time.perf_counter() - t_prod)
            fields = {}
            if r == PROC_RT_PEER_ROUND:
                peer_segments = sorted(s for s, m in done.items()
                                       if m["download_path"].startswith("peer://"))
                if len(peer_segments) != parts or any(
                        done[s]["download_path"] != f"peer://{name}/{s}" for s in peer_segments):
                    raise AssertionError(f"process_realtime: the outage's commits "
                                         f"{ {s: m['download_path'] for s, m in done.items()} }")
                # server_1 restarted without its copies of the table: every
                # committed segment from its peer, the deep store still down
                t_r = time.perf_counter()
                shutil.rmtree(os.path.join(pc.work_dir, "server_1", name), ignore_errors=True)
                probe.urls["server_1"] = pc.restart_server("server_1")
                restart_s = time.perf_counter() - t_r   # its segments loaded at start
                served = get_json(f"{probe.urls['server_1']}/segments/{name}",
                                  timeout=60.0)["segments"]
                if sorted(served) != sorted(done):
                    raise AssertionError(f"process_realtime: the restarted replica serves "
                                         f"{served}, committed {sorted(done)}")
                wait("the restarted replica consuming", consumed)
                reloaded_s = time.perf_counter() - t_r
                # its committed copies answer from its pipeline, on the card:
                # one partial over every committed segment, sent to it alone
                _, sql, oracle, on_committed, _ = next(q for q in queries if q[0] == "scan_f32")
                committed_cols = {k: np.concatenate(
                    [data[p][k][:segment_start(sent[p]) * RT_CLUSTER_BLOCK_ROWS]
                     for p in range(parts)]) for k in data[0]}
                handle = RemoteServerHandle(probe.urls["server_1"], timeout_s=600.0)
                try:
                    probe.reset()
                    part = handle(name, sql, sorted(done))
                    part_counts = probe.launches()
                finally:
                    handle.close()
                if sorted(part.served) != sorted(done) or part_counts != on_committed or \
                        not rows_match([list(part.scalar)], oracle(committed_cols)):
                    raise AssertionError(f"process_realtime: the restarted replica's partial "
                                         f"{part.scalar} over {part.served}, launches "
                                         f"{part_counts}")
                for k, v in part_counts.items():
                    launches[k] += v
                metrics = get_json(f"{probe.urls['server_1']}/metrics", timeout=60.0)
                peer = {"restart_s": restart_s, "restart_to_online_s": reloaded_s,
                        "deepstore_download_quarantined": metrics.get(
                            "pinot_deepstore_download_quarantined", 0),
                        "deepstore_download_retries": metrics.get(
                            "pinot_deepstore_download_retries", 0)}
                if peer["deepstore_download_quarantined"] != want_done - parts:
                    raise AssertionError(f"process_realtime: the restarted replica's "
                                         f"downloads {peer}")
            views = sum(sent[p] > segment_start(sent[p]) for p in range(parts))
            consumed_cols = {k: np.concatenate([data[p][k][:sent[p] * RT_CLUSTER_BLOCK_ROWS]
                                                for p in range(parts)]) for k in data[0]}
            for qid, sql, oracle, on_committed, on_view in queries:
                res, ms, counts = checked(f"round {r} {qid}", sql, oracle(consumed_cols),
                                          on_committed, on_view, views, parts)
                fields[qid] = {"ms": ms, "launches": counts,
                               "answer": res["resultTable"]["rows"][:3],
                               "consuming_queried": res.get("numConsumingSegmentsQueried"),
                               "min_freshness_ms": res.get("minConsumingFreshnessTimeMs")}
            if r == PROC_RT_PEER_ROUND:
                os.remove(deep)
                os.rename(deep + ".parked", deep)
                debug = probe.debug()
                peer["staged_bytes_server_1"] = debug["server_1"]["deviceMemory"]["stagedBytes"]
                peer["server_1_partial"] = {"query": "scan_f32", "segments": len(done),
                                            "answer": list(part.scalar),
                                            "launches": part_counts}
                t_v = time.perf_counter()
                healed = pc.controller.validate()
                peer["validate_s"] = time.perf_counter() - t_v
                metas = snapshot()["segments"][name]
                peer["healed"] = healed["healed"]
                peer["paths"] = {s: metas[s]["download_path"] for s in peer_segments}
                if sorted(healed["healed"]) != peer_segments or any(
                        metas[s]["download_path"] != f"{name}/{s}.tar.gz"
                        or not os.path.exists(os.path.join(deep, name, f"{s}.tar.gz"))
                        for s in peer_segments):
                    raise AssertionError(f"process_realtime: the validation round healed "
                                         f"{healed}, paths {peer['paths']}")
                if PROC_CLUSTER_DEVICE == "cuda" and peer["staged_bytes_server_1"] <= 0:
                    raise AssertionError(f"process_realtime: the restarted replica staged "
                                         f"nothing on the card: {peer}")
                log("process_realtime_peer", segments=peer_segments, **peer)
            if r in (1, PROC_RT_PEER_ROUND):
                memory[f"after round {r}'s commits"] = {s: d["deviceMemory"]
                                                         for s, d in probe.debug().items()}
            log("process_realtime_round", round=r, rows=total, produce_s=produce_s,
                consumed_s=consumed_s, consume_rows_per_s=consume_rate[-1],
                staleness_s=staleness_s, committed=sorted(done), queries=fields)

        # the protocol: the JAX package's offsets, the segments' rows
        metas = snapshot()["segments"][name]
        committed = {s: m for s, m in metas.items() if m["status"] == "DONE"}
        for p in range(parts):
            got = sorted((m["sequence_number"], int(m["start_offset"]), int(m["end_offset"]),
                          m["num_docs"]) for m in committed.values()
                         if m["partition_group"] == p)
            want = [(i, a, b, (b - a) * RT_CLUSTER_BLOCK_ROWS) for i, (a, b) in enumerate(commits)]
            if got != want:
                raise AssertionError(f"process_realtime: partition {p} committed {got}, "
                                     f"expected {want}")
        debug = probe.debug()
        consumers = {s: d["consumers"].get(name, {}) for s, d in debug.items()}
        log("process_realtime_commits", committed=len(committed),
            produce_to_online_s={s: commit_online_s.get(s) for s in sorted(committed)},
            offsets={s: (m["partition_group"], m["start_offset"], m["end_offset"])
                     for s, m in sorted(committed.items())},
            consume_rows_per_s=consume_rate, lanes=sorted(lanes), consumers=consumers)
        if lanes != {"blocks"}:
            raise AssertionError(f"process_realtime: the consumers took the {lanes} lanes")

        final = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
        views = sum(sent[p] > segment_start(sent[p]) for p in range(parts))
        warm = {}

        def warm_runs(label, qid, cols, consuming):
            _, sql, oracle, on_committed, on_view = next(q for q in queries if q[0] == qid)
            want_rows = oracle(cols)
            times = [checked(label, sql, want_rows, on_committed, on_view, views,
                             consuming)[1] for _ in range(PROC_RT_WARM_RUNS)]
            warm[label] = {"warm_median_ms": statistics.median(times), "warm_min_ms": min(times),
                           "warm_max_ms": max(times), "warm_runs": len(times)}
        for qid, *_ in queries:
            warm_runs(f"realtime {qid}", qid, final, parts)
        memory["after the rounds"] = {s: d["deviceMemory"] for s, d in probe.debug().items()}

        # the OFFLINE half: the rows up to the median date, 2 segments over HTTP
        t_h = time.perf_counter()
        dates = np.sort(final["lo_orderdate"])
        low = final["lo_orderdate"] <= int(dates[len(dates) // 2])
        offline = {k: v[low] for k, v in final.items()}
        n_off = int(low.sum())
        off_cfg = TableConfig(PROC_RT_TABLE, replication=PROC_CLUSTER_REPLICATION,
                              time_column="lo_orderdate")
        off_name = off_cfg.table_name_with_type
        pc.controller.add_table(off_cfg)
        builder = SegmentBuilder(schema)
        for i, (lo, hi) in enumerate(((0, n_off // 2), (n_off // 2, n_off))):
            seg_dir = builder.build({k: v[lo:hi] for k, v in offline.items()},
                                    os.path.join(work, "process_realtime_offline"),
                                    f"{PROC_RT_TABLE}_offline_{i}")
            pc.controller.upload_segment(off_name, seg_dir)
        boundary = int(offline["lo_orderdate"].max())
        hybrid = {k: np.concatenate([offline[k], final[k][final["lo_orderdate"] > boundary]])
                  for k in final}
        n_hybrid = len(hybrid["lo_orderdate"])

        def hybrid_converged():
            status = pc.controller.table_status(off_name)
            return status["converged"] and pc.query(
                f"SELECT COUNT(*) FROM {PROC_RT_TABLE}")["resultTable"]["rows"] == [[n_hybrid]]
        wait("the hybrid table", hybrid_converged)
        offline_s = time.perf_counter() - t_h
        hybrid_answers = {}
        for qid in ("q1_1", "group_by"):
            _, sql, oracle, on_committed, on_view = next(q for q in queries if q[0] == qid)
            res, ms, counts = checked(f"hybrid {qid}", sql, oracle(hybrid), on_committed,
                                      on_view, views, parts)
            hybrid_answers[qid] = {"cold_ms": ms, "launches": counts,
                                   "answer": res["resultTable"]["rows"][:3]}
            warm_runs(f"hybrid {qid}", qid, hybrid, parts)
        log("process_realtime_hybrid", boundary=boundary, offline_rows=n_off,
            rows=n_hybrid, offline_build_upload_s=offline_s, queries=hybrid_answers)
        log("process_realtime_latency", **warm)
        log("process_realtime_memory", servers=memory)
        missing = [k for k in ("masked_sums", "masked_sums_fused", "grouped_agg")
                   if not launches[k]]
        if missing:
            raise AssertionError(f"process_realtime: no {missing} launched in the server "
                                 f"processes: {launches}")
        passed = True
    finally:
        if os.path.isfile(deep):   # the outage ended with an error: the deep store back
            os.remove(deep)
            os.rename(deep + ".parked", deep)

        def cleanup(tables=(name, off_name)):
            for t in tables:
                if t is not None:
                    try:
                        pc.controller.drop_table(t)
                    except Exception:   # the phase's own error is the one to report
                        pass
            client.close()
            srv.stop()
        if passed and cleanups is not None:
            cleanups.append(cleanup)
        else:
            cleanup()
    log("process_realtime_summary", launches=launches, seconds=time.perf_counter() - t0,
        consume_rows_per_s_median=statistics.median(consume_rate) if consume_rate else None,
        peer=peer)
    return launches


# -- phase 19's other stream brokers and the ingestion health plane ---------------------

PROC_STREAMS_ROUNDS = 3                # phase 18's first rounds: 786,432 rows a partition
PROC_STREAMS_PAUSE_ROUND = 2           # the Pulsar round produced behind a pause
PROC_PULSAR_TABLE = "lineorder_pulsar"
PROC_KINESIS_TABLE = "lineorder_kinesis"
PROC_KINESIS_SHARDS = 2
# 3 rounds of 65,536 JSON records, 196,608 in all: about 98 s of a two-shard
# stream at Kinesis's documented write limit of 1,000 records a second a shard
PROC_KINESIS_ROUND_ROWS = 65_536
PROC_KINESIS_FLUSH_ROWS = 65_536       # each shard commits at least once
PROC_KINESIS_SEED = 15                 # --seed + 15: no other phase's data
PROC_KINESIS_PUT_RECORDS = 500         # records a PutRecords call takes at most (AWS's limit)
PROC_KINESIS_KEYS = {"accessKey": "AKIDCHIPSMOKE", "secretKey": "chip-smoke/streams/key"}


def process_streams(args, pc, probe, stream, rt_tables) -> dict:
    """Phase 19's stream brokers and ingestion health, in the running
    cluster after `process_realtime`. A `PulsarLiteBroker` in this process:
    a REALTIME `lineorder_pulsar` table (stream type "pulsar", 2 partitions,
    replication 2, staged on the card, flush threshold RT_CLUSTER_FLUSH_ROWS)
    fed phase 18's PCB1 blocks (`--seed + 13`) for PROC_STREAMS_ROUNDS rounds
    of 4 blocks a partition: each partition commits once and keeps 262,144
    rows consuming. The table is paused before round PROC_STREAMS_PAUSE_ROUND
    + 1, whose blocks are produced behind the pause: its `ingestionStatus`
    must be DEGRADED with the paused reason and each consuming segment's
    `offsetLag` the blocks produced to its partition since; after the resume
    and the round consumed, HEALTHY at `maxOffsetLag` 0
    (`process_streams_pause`). A `KinesisStub` with keys (every request
    SigV4-signed and verified): a REALTIME `lineorder_kinesis` table on 2
    shards (stream type "kinesis", JSON, the keys in its stream properties,
    flush threshold PROC_KINESIS_FLUSH_ROWS) fed 3 rounds of 65,536 lineorder
    rows as JSON records (`--seed + 15`), PutRecords of at most 500, each
    row's partition key its lo_orderkey (its number in the stream). After
    each round of either table: a bounded wait until both replicas consumed
    it, the HTTP broker counts it (`staleness_s`) and its commits are ONLINE
    on both replicas; phase 18's five queries through the HTTP broker on
    their oracles, launches exact (`process_streams_round`); then every
    realtime table of the cluster (process_realtime's too): its
    `ingestionStatus` and each server's `/debug/consuming`, HEALTHY outside
    the pause (`process_streams_ingestion`). Returns the checked runs'
    launches."""
    import zlib

    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.ingest.kinesislite import KinesisClient, KinesisStub
    from pinot_tpu_torch.ingest.pulsarlite import PulsarLiteBroker, PulsarLiteProducer
    from pinot_tpu_torch.schema import Schema
    from pinot_tpu_torch.ssb import make_columns, ssb_schema
    from pinot_tpu_torch.table import StreamConfig, TableConfig, TableType

    data, blocks = stream
    parts = len(data)
    launches = counts_of()
    t_step = time.perf_counter()
    broker = PulsarLiteBroker()
    stub = KinesisStub(access_key=PROC_KINESIS_KEYS["accessKey"],
                       secret_key=PROC_KINESIS_KEYS["secretKey"])
    producers, made, summary = [], [], {}
    queries = realtime_cluster_queries()
    consuming_states = ("INITIAL_CONSUMING", "CATCHING_UP", "HOLDING")

    def wait(label, ready):
        deadline = time.perf_counter() + PROC_RT_WAIT_S
        while True:
            try:
                out = last = ready()
            except Exception as e:   # a mirror catching up: poll
                out, last = None, e
            if out:
                return out
            if time.perf_counter() > deadline:
                raise AssertionError(f"process_streams: {label} not within {PROC_RT_WAIT_S} s "
                                     f"(last: {last!r})")
            time.sleep(PROC_RT_POLL_S)

    def consuming_view(name):
        """server -> this table's consuming segments, from its /debug/consuming."""
        return {sid: (get_json(f"{url}/debug/consuming", timeout=60.0)["tables"].get(name)
                      or {}).get("segments", {})
                for sid, url in probe.urls.items()}

    def segments(name):
        snap = get_json(f"{pc.controller_url}/catalog/snapshot", timeout=60.0)
        return snap["segments"].get(name, {}), snap["externalView"].get(name, {})

    def consumed(t):
        """Every server consumes each partition at its produced offset."""
        view = consuming_view(t["name"])
        for segs in view.values():
            offs = sorted(x["currentOffset"] for x in segs.values()
                          if x["state"] in consuming_states)
            if offs != sorted(t["totals"]):
                return None
        return view

    def settled(t):
        """Consumed, every commit ONLINE on both replicas, none pending."""
        view = consumed(t)
        if view is None or any(x["numDocs"] >= t["flush"] for segs in view.values()
                               for x in segs.values()):
            return None
        metas, ev = segments(t["name"])
        done = {s: m for s, m in metas.items() if m["status"] == "DONE"}
        if any(sorted(ev.get(s, {}).values()) != ["ONLINE"] * PROC_CLUSTER_REPLICATION
               for s in done):
            return None
        return view, metas

    def checked(t, label, sql, want_rows, on_committed, on_view, views, fresh):
        """One query through the HTTP broker: the servers' counts set to 0
        just before, read just after, held to on_committed a pipeline
        partial over committed segments plus on_view a consuming view with
        rows; the answer to its oracle; the consuming stats to the stream's."""
        probe.reset()
        before = rt_device_queries(probe.debug(), t["logical"])
        t_q = time.perf_counter()
        res = pc.broker.query(sql, timeout=600.0)
        ms = (time.perf_counter() - t_q) * 1e3
        debug = probe.debug()
        counts = probe.launches(debug)
        piped = rt_device_queries(debug, t["logical"]) - before
        want = {k: on_committed[k] * piped + on_view[k] * views for k in counts}
        if counts != want:
            raise AssertionError(f"process_streams {label}: launches {counts}, expected {want} "
                                 f"({piped} pipeline partials, {views} views)")
        got = res["resultTable"]["rows"]
        if not rows_match(got, want_rows):
            raise AssertionError(f"process_streams {label}: {got[:5]}, oracle {want_rows[:5]}")
        got_fresh, now_ms = res.get("minConsumingFreshnessTimeMs"), time.time() * 1000
        if res["partialResult"] or res["numSegmentsRetried"] or \
                res.get("numConsumingSegmentsQueried") != parts or (
                    got_fresh != fresh if fresh is not None
                    else not now_ms - 3_600_000 < got_fresh <= now_ms):
            raise AssertionError(f"process_streams {label}: stats (freshness {fresh}) "
                                 f"{ {k: v for k, v in res.items() if k != 'resultTable'} }")
        for k, v in counts.items():
            launches[k] += v
        return {"ms": ms, "launches": counts, "answer": got[:3], "pipeline_partials": piped,
                "views": views, "min_freshness_ms": got_fresh}

    def ingestion(t, r, staleness_s, expect="HEALTHY"):
        """Every realtime table's verdict and each server's consuming
        segments; the verdict must be `expect` for `t`, HEALTHY elsewhere."""
        out = {}
        for name in rt_tables + [x["name"] for x in made]:
            t_i = time.perf_counter()
            st = pc.controller.ingestion_status(name)
            poll_ms = (time.perf_counter() - t_i) * 1e3
            want = expect if name == t["name"] else "HEALTHY"
            if st["ingestionState"] != want:
                raise AssertionError(f"process_streams round {r} ({t['name']}): {name} is "
                                     f"{st['ingestionState']} {st['reasons']}, want {want}")
            out[name] = {"verdict": st["ingestionState"], "reasons": st["reasons"],
                         "max_offset_lag": st["maxOffsetLag"],
                         "max_freshness_lag_ms": st["maxFreshnessLagMs"],
                         "total_rows_per_s": st["totalRowsPerSecond"],
                         "consuming": st["numConsumingSegments"], "poll_ms": poll_ms,
                         "servers": {sid: {seg: [x["currentOffset"], x["offsetLag"],
                                                 x["numDocs"], x["state"]]
                                           for seg, x in segs.items()}
                                     for sid, segs in consuming_view(name).items()}}
        log("process_streams_ingestion", table=t["name"], round=r, staleness_s=staleness_s,
            tables=out)
        return out[t["name"]]

    def queries_for(t, r, view_metas):
        """The five queries on the rows produced so far."""
        view, metas = view_metas
        consuming = {s: m for s, m in metas.items() if m["status"] == "IN_PROGRESS"}
        served = [{seg: x["numDocs"] for seg, x in segs.items()} for segs in view.values()]
        fresh, held = None, {}
        for seg, m in consuming.items():
            p, start = m["partition_group"], int(m["start_offset"])
            rows = t["rows"](p, start, t["totals"][p])
            n = len(rows["lo_orderdate"])
            held[seg] = n
            if n:
                top = int(rows["lo_orderdate"].max())
                fresh = top if fresh is None else min(fresh, top)
        if any(x != held for x in served):
            raise AssertionError(f"process_streams {t['name']} round {r}: the servers' "
                                 f"consuming segments hold {served}, the stream {held}")
        views = sum(n > 0 for n in held.values())
        cols = {k: np.concatenate([t["rows"](p, 0, t["totals"][p])[k] for p in range(parts)])
                for k in data[0]}
        return {qid: checked(t, f"{t['name']} round {r} {qid}", rt_sql(sql, t["logical"]),
                             oracle(cols), on_committed, on_view, views, fresh)
                for qid, sql, oracle, on_committed, on_view in queries}

    def lanes(t):
        return sorted({c["lastDecodePath"] for d in probe.debug().values()
                       for c in d["consumers"].get(t["name"], {}).values()
                       if c["lastDecodePath"]})

    def rounds(t, produce, pause_round=None):
        rates, stale = [], []
        for r in range(PROC_STREAMS_ROUNDS):
            pause = {}
            if r == pause_round:
                t_p = time.perf_counter()
                pc.controller.pause_consumption(t["name"])
                wait(f"{t['name']} paused", lambda: all(
                    len(segs) == parts and all(x["paused"] for x in segs.values())
                    for segs in consuming_view(t["name"]).values()))
                pause["pause_s"] = time.perf_counter() - t_p
            t_prod = time.perf_counter()
            before = list(t["totals"])
            produce(t, r)
            produce_s = time.perf_counter() - t_prod
            if r == pause_round:
                st = pc.controller.ingestion_status(t["name"])
                lags = {(sid, seg): x["offsetLag"] for sid, srv in st["servers"].items()
                        for seg, x in srv["segments"].items()}
                want_lag = {p: t["totals"][p] - before[p] for p in range(parts)}
                seg_part = {seg: x["partition"] for srv in st["servers"].values()
                            for seg, x in srv["segments"].items()}
                pause.update(verdict=st["ingestionState"], reasons=st["reasons"],
                             max_offset_lag=st["maxOffsetLag"],
                             offset_lags={f"{sid}/{seg}": v for (sid, seg), v in lags.items()},
                             produced_since_pause=want_lag)
                if st["ingestionState"] != "DEGRADED" or st["reasons"] != [
                        "consumption is paused"] or len(lags) != parts * PROC_CLUSTER_REPLICATION \
                        or any(v != want_lag[seg_part[seg]] for (_, seg), v in lags.items()):
                    raise AssertionError(f"process_streams pause: {pause}")
                t_prod = time.perf_counter()
                pc.controller.resume_consumption(t["name"])
            wait(f"{t['name']} round {r} consumed", lambda: consumed(t))
            consumed_s = time.perf_counter() - t_prod
            total = sum(t["totals"])
            wait(f"{t['name']} round {r} counted", lambda: pc.query(
                f"SELECT COUNT(*) FROM {t['logical']}")["resultTable"]["rows"] == [[total]]
                or pc.query(f"SELECT COUNT(*) FROM {t['logical']}")["resultTable"]["rows"])
            staleness_s = time.perf_counter() - t_prod
            view_metas = wait(f"{t['name']} round {r} settled", lambda: settled(t))
            settled_s = time.perf_counter() - t_prod
            rows_round = sum(t["totals"]) - sum(before)
            rates.append(PROC_CLUSTER_REPLICATION * rows_round * t["rows_per_offset"] / consumed_s)
            stale.append(staleness_s)
            fields = queries_for(t, r, view_metas)
            st = ingestion(t, r, staleness_s)
            done = sorted(s for s, m in view_metas[1].items() if m["status"] == "DONE")
            log("process_streams_round", table=t["name"], stream_type=t["type"], round=r,
                rows=total * t["rows_per_offset"], produce_s=produce_s, consumed_s=consumed_s,
                consume_rows_per_s=rates[-1], staleness_s=staleness_s,
                produce_to_settled_s=settled_s, committed=done, queries=fields,
                verdict=st["verdict"], max_offset_lag=st["max_offset_lag"],
                max_freshness_lag_ms=st["max_freshness_lag_ms"],
                total_rows_per_s=st["total_rows_per_s"])
            if r == pause_round:
                pause.update(resume_to_consumed_s=consumed_s, resume_to_counted_s=staleness_s,
                             healed=st["verdict"], healed_max_offset_lag=st["max_offset_lag"])
                if st["max_offset_lag"] != 0:
                    raise AssertionError(f"process_streams pause: after the resume {st}")
                log("process_streams_pause", table=t["name"], round=r, **pause)
        return rates, stale

    def make_table(t, cfg):
        pc.controller.add_schema(Schema.from_json(dict(ssb_schema().to_json(),
                                                       schemaName=t["logical"])))
        pc.controller.add_table(cfg, num_partitions=parts)
        made.append(t)

    try:
        # -- the Pulsar table: phase 18's blocks -------------------------------------
        t0 = time.perf_counter()
        pt = {"name": f"{PROC_PULSAR_TABLE}_REALTIME", "logical": PROC_PULSAR_TABLE,
              "type": "pulsar", "totals": [0] * parts, "flush": RT_CLUSTER_FLUSH_ROWS,
              "rows_per_offset": RT_CLUSTER_BLOCK_ROWS,
              "rows": lambda p, a, b: {k: v[a * RT_CLUSTER_BLOCK_ROWS:b * RT_CLUSTER_BLOCK_ROWS]
                                       for k, v in data[p].items()}}
        producers.extend(PulsarLiteProducer(broker.service_url, PROC_PULSAR_TABLE, p)
                         for p in range(parts))
        make_table(pt, TableConfig(
            PROC_PULSAR_TABLE, table_type=TableType.REALTIME,
            replication=PROC_CLUSTER_REPLICATION, time_column="lo_orderdate",
            stream=StreamConfig(stream_type="pulsar", topic=PROC_PULSAR_TABLE,
                                decoder="columnar", flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
                                properties={"serviceUrl": broker.service_url,
                                            "realtime.ingest.device.staging": "true"})))

        def produce_blocks(t, r):
            for p in range(parts):
                for blob in blocks[p][t["totals"][p]:t["totals"][p] + RT_CLUSTER_ROUND_BLOCKS]:
                    producers[p].send(blob)
                t["totals"][p] += RT_CLUSTER_ROUND_BLOCKS
        log("process_streams_data", table=pt["name"], stream_type="pulsar",
            service_url=broker.service_url, partitions=parts, seed=args.seed + RT_CLUSTER_SEED,
            rows=parts * PROC_STREAMS_ROUNDS * RT_CLUSTER_ROUND_BLOCKS * RT_CLUSTER_BLOCK_ROWS,
            block_rows=RT_CLUSTER_BLOCK_ROWS, flush_threshold_rows=RT_CLUSTER_FLUSH_ROWS,
            replication=PROC_CLUSTER_REPLICATION, setup_s=time.perf_counter() - t0)
        p_rates, p_stale = rounds(pt, produce_blocks, PROC_STREAMS_PAUSE_ROUND)
        metas, _ = segments(pt["name"])
        want = llc_commit_offsets(PROC_STREAMS_ROUNDS * RT_CLUSTER_ROUND_BLOCKS
                                  * RT_CLUSTER_BLOCK_ROWS, RT_CLUSTER_BLOCK_ROWS,
                                  RT_CLUSTER_ROUND_BLOCKS, RT_CLUSTER_FLUSH_ROWS)
        for p in range(parts):
            got = sorted((int(m["start_offset"]), int(m["end_offset"])) for m in metas.values()
                         if m["status"] == "DONE" and m["partition_group"] == p)
            if got != want:
                raise AssertionError(f"process_streams pulsar: partition {p} committed {got}, "
                                     f"expected {want}")
        summary["pulsar"] = {"consume_rows_per_s": p_rates, "staleness_s": p_stale,
                             "lanes": lanes(pt), "commits": len(want) * parts}
        if summary["pulsar"]["lanes"] != ["blocks"]:
            raise AssertionError(f"process_streams pulsar: lanes {summary['pulsar']['lanes']}")

        # -- the Kinesis table: JSON records, signed requests -------------------------
        t0 = time.perf_counter()
        n = PROC_STREAMS_ROUNDS * PROC_KINESIS_ROUND_ROWS
        kcols = make_columns(n, args.seed + PROC_KINESIS_SEED)
        names = list(kcols)
        records = [json.dumps(dict(zip(names, vals)))
                   for vals in zip(*(np.asarray(kcols[c]).tolist() for c in names))]
        keys = [str(i) for i in range(n)]   # lo_orderkey: the row's number in the stream
        shard = np.array([zlib.crc32(k.encode()) % PROC_KINESIS_SHARDS for k in keys])
        shard_rows = [np.flatnonzero(shard == p) for p in range(PROC_KINESIS_SHARDS)]
        client = KinesisClient(stub.url, access_key=PROC_KINESIS_KEYS["accessKey"],
                               secret_key=PROC_KINESIS_KEYS["secretKey"])
        client.create_stream(PROC_KINESIS_TABLE, PROC_KINESIS_SHARDS)
        kt = {"name": f"{PROC_KINESIS_TABLE}_REALTIME", "logical": PROC_KINESIS_TABLE,
              "type": "kinesis", "totals": [0] * PROC_KINESIS_SHARDS,
              "flush": PROC_KINESIS_FLUSH_ROWS, "rows_per_offset": 1,
              "rows": lambda p, a, b: {k: v[shard_rows[p][a:b]] for k, v in kcols.items()}}
        make_table(kt, TableConfig(
            PROC_KINESIS_TABLE, table_type=TableType.REALTIME,
            replication=PROC_CLUSTER_REPLICATION, time_column="lo_orderdate",
            stream=StreamConfig(stream_type="kinesis", topic=PROC_KINESIS_TABLE, decoder="json",
                                flush_threshold_rows=PROC_KINESIS_FLUSH_ROWS,
                                properties=dict(PROC_KINESIS_KEYS, endpoint=stub.url,
                                                **{"realtime.ingest.device.staging": "true"}))))
        put_calls = []

        def produce_records(t, r):
            lo, hi = r * PROC_KINESIS_ROUND_ROWS, (r + 1) * PROC_KINESIS_ROUND_ROWS
            for a in range(lo, hi, PROC_KINESIS_PUT_RECORDS):
                b = min(a + PROC_KINESIS_PUT_RECORDS, hi)
                out = client.put_records(PROC_KINESIS_TABLE, zip(keys[a:b], records[a:b]))
                put_calls.append(b - a)
                if out["FailedRecordCount"] or len(out["Records"]) != b - a:
                    raise AssertionError(f"process_streams kinesis: PutRecords {out}")
            for p in range(PROC_KINESIS_SHARDS):
                t["totals"][p] = int(np.searchsorted(shard_rows[p], hi))
        log("process_streams_data", table=kt["name"], stream_type="kinesis", endpoint=stub.url,
            shards=PROC_KINESIS_SHARDS, seed=args.seed + PROC_KINESIS_SEED, rows=n,
            round_rows=PROC_KINESIS_ROUND_ROWS, flush_threshold_rows=PROC_KINESIS_FLUSH_ROWS,
            shard_rows=[len(x) for x in shard_rows], signed=True,
            replication=PROC_CLUSTER_REPLICATION, setup_s=time.perf_counter() - t0)
        k_rates, k_stale = rounds(kt, produce_records)
        metas, _ = segments(kt["name"])
        commits = {p: sorted((int(m["start_offset"]), int(m["end_offset"]), m["num_docs"])
                             for m in metas.values()
                             if m["status"] == "DONE" and m["partition_group"] == p)
                   for p in range(PROC_KINESIS_SHARDS)}
        if any(not c or any(e - s != docs for s, e, docs in c) for c in commits.values()):
            raise AssertionError(f"process_streams kinesis: commits {commits}")
        summary["kinesis"] = {"consume_rows_per_s": k_rates, "staleness_s": k_stale,
                              "lanes": lanes(kt), "commits": commits,
                              "put_records_calls": len(put_calls),
                              "max_records_a_call": max(put_calls)}
        missing = [k for k in ("masked_sums", "masked_sums_fused", "grouped_agg")
                   if not launches[k]]
        if missing:
            raise AssertionError(f"process_streams: no {missing} launched: {launches}")
    finally:
        for t in made:
            try:
                pc.controller.drop_table(t["name"])
            except Exception:   # the step's own error is the one to report
                pass
        for prod in producers:
            prod.close()
        broker.stop()
        stub.stop()
    log("process_streams_summary", launches=launches, seconds=time.perf_counter() - t_step,
        **summary)
    return launches


def run_process_cluster(args, table, cols, work, rt_stream) -> tuple:
    """Phase 19: the roles as OS processes joined over HTTP. A ProcessCluster:
    a controller process, PROC_CLUSTER_SERVERS server processes each owning
    the card through a DeviceQueryPipeline (`server.device.enabled`) and a
    broker process; phase 4's 8 segments pushed over HTTP from
    CLUSTER_UPLOAD_THREADS threads to an OFFLINE table with replication 2,
    timed until the broker answers every row (`process_cluster_data`).
    Through the broker's HTTP endpoint: `cluster_queries` and EXPLAIN ANALYZE
    of Q1.1, a cold and PROC_CLUSTER_RUNS warm runs each, held to the oracle,
    to the launches the servers' /debug report (one a server queried; the
    stacked top-k one a server, from the pipelines' stats) and to a whole
    answer, beside the in-process cluster phase's numbers for the same SQL
    (`process_cluster_query`); server_0's lo_custkey partial fetched directly
    over the wire, checked dense; the e2e mix (SERVE_CLIENTS x
    SERVE_QUERIES_PER_CLIENT) through the broker on the mux transport, then
    through a second broker process started with `broker.mux.enabled=false`
    (`process_cluster_pipeline`); each process's device memory
    (`process_cluster_memory`); server_1 SIGKILLed, Q1.1 and GROUP_QUERY exact
    from server_0 (`process_cluster_failover`). Before the memory line, the
    multistage data plane (`process_cluster_shuffle`). Returns the launches
    of the checked runs and the mix, and those of the shuffle path's runs
    (read from the server processes)."""
    import threading

    from pinot_tpu_torch.cluster.http_service import get_json
    from pinot_tpu_torch.cluster.process import BrokerClient, ProcessCluster
    from pinot_tpu_torch.cluster.remote import RemoteServerHandle
    from pinot_tpu_torch.ssb import GROUP_QUERY, QUERY
    from pinot_tpu_torch.table import TableConfig

    schema = table[0].schema
    rows = sum(s.num_docs for s in table)
    name = "lineorder_OFFLINE"
    launches = counts_of()
    t0 = time.perf_counter()
    with ProcessCluster(num_servers=PROC_CLUSTER_SERVERS, device=PROC_CLUSTER_DEVICE,
                        work_dir=os.path.join(work, "process_cluster"),
                        server_config={"server.device.enabled": "true"},
                        startup_timeout_s=PROC_CLUSTER_STARTUP_S) as pc:
        startup_s = time.perf_counter() - t0
        sids = [f"server_{i}" for i in range(PROC_CLUSTER_SERVERS)]
        probe = ServerProbe({sid: pc.server_url(sid) for sid in sids})
        pc.controller.add_schema(schema)
        pc.controller.add_table(TableConfig("lineorder", replication=PROC_CLUSTER_REPLICATION))
        t_up = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(CLUSTER_UPLOAD_THREADS) as pool:
            pushed = list(pool.map(lambda s: pc.controller.upload_segment(name, s.path), table))
        upload_s = time.perf_counter() - t_up
        deadline = time.perf_counter() + PROC_CLUSTER_QUERYABLE_S
        while True:
            try:
                res = pc.query("SELECT COUNT(*) FROM lineorder")
                if res["resultTable"]["rows"] == [[rows]] and not res["partialResult"]:
                    break
            except Exception:   # the broker's mirror not caught up yet: poll
                pass
            if time.perf_counter() > deadline:
                raise AssertionError(f"process_cluster: the table did not answer its "
                                     f"{rows} rows within {PROC_CLUSTER_QUERYABLE_S} s")
            time.sleep(0.05)
        queryable_s = time.perf_counter() - t_up
        # every segment answered is not every replica loaded: wait for both
        while True:
            status = pc.controller.table_status(name)
            if status["converged"] and all(n == PROC_CLUSTER_REPLICATION
                                           for n in status["replicas_online"].values()):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"process_cluster: the table did not converge: {status}")
            time.sleep(0.05)
        converged_s = time.perf_counter() - t_up
        log("process_cluster_data", rows=rows, segments=len(table), servers=len(sids),
            replication=PROC_CLUSTER_REPLICATION, startup_s=startup_s, upload_s=upload_s,
            upload_to_queryable_s=queryable_s, upload_to_converged_s=converged_s,
            pushed=[p["segment"] for p in pushed], device=PROC_CLUSTER_DEVICE)

        def checked(label, sql, ok, per_server, broker=None, strict=True):
            """One query over HTTP: the servers' counts set to 0 just before,
            read just after and held to `per_server` times the servers that
            answered; the answer to `ok`; the stats to a whole answer."""
            probe.reset()
            before = {sid: d["pipeline"]["topkLaunches"] for sid, d in probe.debug().items()}
            t0 = time.perf_counter()
            res = (broker or pc.broker).query(sql, timeout=600.0)
            ms = (time.perf_counter() - t0) * 1e3
            debug = probe.debug()
            counts = probe.launches(debug)
            topk = sum(d["pipeline"]["topkLaunches"] - before[sid] for sid, d in debug.items())
            answered = res["numServersResponded"]
            want = {k: v * answered for k, v in per_server.items()}
            want_topk = answered if label.startswith("topk") else 0
            if counts != want or topk != want_topk:
                raise AssertionError(f"process_cluster {label}: launches {counts}, top-k "
                                     f"{topk}, expected {want} and {want_topk} for "
                                     f"{answered} servers answering")
            for k, v in counts.items():
                launches[k] += v
            got = res["resultTable"]["rows"]
            if not ok(got):
                raise AssertionError(f"process_cluster {label}: off the oracle: {got[:5]}")
            if strict and (res["partialResult"] or res["numSegmentsRetried"]
                           or res["numSegmentsQueried"] != len(table)
                           or res["numServersResponded"] != res["numServersQueried"]):
                raise AssertionError(f"process_cluster {label}: stats "
                                     f"{ {k: v for k, v in res.items() if k != 'resultTable'} }")
            return res, ms, counts

        stat_keys = ("numSegmentsQueried", "numServersQueried", "numServersResponded",
                     "partialResult", "numSegmentsRetried", "numDocsScanned",
                     "muxFrameQueueMs", "muxFlowControlMs")
        queries = cluster_queries(cols)
        numbers = {}
        for qid, sql, ok, per_server in queries:
            res, cold_ms, counts = checked(qid, sql, ok, per_server)
            runs = (min(PROC_CLUSTER_RUNS, CLUSTER_CUSTKEY_RUNS) if qid == "custkey_group"
                    else PROC_CLUSTER_RUNS)
            times = [checked(qid, sql, ok, per_server)[1] for _ in range(runs)]
            numbers[qid] = statistics.median(times)
            log("process_cluster_query", query=qid, rows=rows, segments=len(table),
                launches=counts, answer=res["resultTable"]["rows"][:3],
                answer_rows=len(res["resultTable"]["rows"]), cold_ms=cold_ms,
                warm_median_ms=numbers[qid], warm_min_ms=min(times), warm_max_ms=max(times),
                warm_runs=len(times), in_process=CLUSTER_NUMBERS.get(qid),
                broker_phase_ms=res.get("phaseTimesMs"),
                stats={k: res.get(k) for k in stat_keys})
        res = None
        # the 500,000-key partial of one server, fetched over the wire as the
        # broker's mux dispatch does: in array form
        segs0 = sorted(s.name for s in table)
        handle = RemoteServerHandle(probe.urls["server_0"], timeout_s=600.0)
        try:
            t_d = time.perf_counter()
            part = handle(name, GROUPBY_CUSTKEY, segs0)
            dense_ms = (time.perf_counter() - t_d) * 1e3
        finally:
            handle.close()
        if part.dense is None or int(part.dense.counts.sum()) != rows:
            raise AssertionError("process_cluster: server_0's lo_custkey partial did not "
                                 "cross the wire in array form over every row")
        log("process_cluster_dense", query="custkey_group", server="server_0",
            keys=part.dense.num_keys_real, ms=dense_ms,
            array_bytes=int(part.dense.counts.nbytes
                            + sum(v.nbytes for v in part.dense.outs.values())))
        del part

        res, ms, counts = checked("explain_analyze", "EXPLAIN ANALYZE " + QUERY,
                                  lambda r: len(r) >= 3 and r[0][3] == 1,
                                  counts_of(masked_sums=1))
        if not any(r[0].startswith("SEGMENT_PLAN") and r[3] == res["numDocsScanned"]
                   for r in res["resultTable"]["rows"]):
            raise AssertionError(f"process_cluster explain_analyze: {res['resultTable']}")
        log("process_cluster_explain", query="q1_1", analyze=True,
            rows=res["resultTable"]["rows"], launches=counts, ms=ms)

        mix = [(QUERY, oracle_q11(cols)), (GROUP_QUERY, oracle_group(cols)),
               (SERVE_COUNT_QUERY, oracle_count(cols))]

        def run_mix(transport: str, broker) -> dict:
            before = probe.debug()
            probe.reset()
            lat, failures = [], []
            lock = threading.Lock()

            def client(ci):
                mine, wrong = [], []
                for qi in range(SERVE_QUERIES_PER_CLIENT):
                    sql, want = mix[(ci + qi) % len(mix)]
                    t0 = time.perf_counter()
                    try:
                        r = broker.query(sql, timeout=600.0)
                    except Exception as e:   # recorded, and the phase fails below
                        wrong.append(f"{sql[:48]}: {e!r}")
                        continue
                    mine.append(time.perf_counter() - t0)
                    if not rows_match(r["resultTable"]["rows"], want) or r["partialResult"] \
                            or r["numSegmentsRetried"] or r["numSegmentsQueried"] != len(table):
                        wrong.append(f"{sql[:48]}: {r['resultTable']['rows']}")
                with lock:
                    lat.extend(mine)
                    failures.extend(wrong)

            threads = [threading.Thread(target=client, args=(ci,))
                       for ci in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            after = probe.debug()
            counts = probe.launches(after)
            stats = {sid: {k: after[sid]["pipeline"][k] - before[sid]["pipeline"][k]
                           for k in ("batches", "dispatched", "scanLaunches", "errors",
                                     "timeouts", "dedupeHits", "stackedLaunches")}
                     for sid in sids}
            scans = sum(st["scanLaunches"] for st in stats.values())
            n_queries = SERVE_CLIENTS * SERVE_QUERIES_PER_CLIENT
            if any(t.is_alive() for t in threads) or failures or len(lat) != n_queries:
                raise AssertionError(f"process_cluster {transport} mix: {len(lat)} of "
                                     f"{n_queries} answered, {len(failures)} bad: "
                                     f"{failures[:3]}")
            if counts["masked_sums"] != scans or any(st["errors"] or st["timeouts"]
                                                     for st in stats.values()):
                raise AssertionError(f"process_cluster {transport} mix: {counts} counted, "
                                     f"the pipelines report {stats}")
            launches["masked_sums"] += counts["masked_sums"]
            for st in stats.values():
                st["meanBatch"] = (round(st["dispatched"] / st["batches"], 2)
                                   if st["batches"] else 0.0)
            lat.sort()
            out = {"qps": n_queries / wall, "p50_ms": statistics.median(lat) * 1e3,
                   "p95_ms": lat[int(0.95 * (len(lat) - 1))] * 1e3}
            log("process_cluster_pipeline", mix="e2e_mix", transport=transport,
                clients=SERVE_CLIENTS, queries=n_queries, wall_s=wall, **out,
                launches=counts, servers=stats, in_process=CLUSTER_NUMBERS.get("e2e_mix"),
                serve_pipeline=SERVE_MIX_NUMBERS.get("e2e_mix"))
            return out

        mix_numbers = {"mux": run_mix("mux", pc.broker)}
        pc.controller.set_cluster_config("broker.mux.enabled", "false")
        t_b = time.perf_counter()
        legacy = pc.add_broker("broker_legacy")
        legacy_start_s = time.perf_counter() - t_b
        pc.controller.set_cluster_config("broker.mux.enabled", None)
        deadline = time.perf_counter() + 60.0
        while legacy.query("SELECT COUNT(*) FROM lineorder")["resultTable"]["rows"] != [[rows]]:
            if time.perf_counter() > deadline:
                raise AssertionError("process_cluster: the legacy broker did not answer")
            time.sleep(0.05)
        mix_numbers["legacy"] = run_mix("legacy", legacy)
        mix_numbers["legacy"]["broker_start_s"] = legacy_start_s
        shuffle_launches = process_cluster_shuffle(args, pc, probe, table, cols, work, numbers)

        debug = probe.debug()
        memory = {sid: d["deviceMemory"] for sid, d in debug.items()}
        log("process_cluster_memory", servers=memory,
            smoke_process_allocated=torch.cuda.memory_allocated()
            if PROC_CLUSTER_DEVICE == "cuda" else 0,
            brokers={b: get_json(f"{u}/debug", timeout=60.0)["brokerMetrics"].get(
                "pinot_broker_mux_dispatches", 0)
                for b, u in (("broker_0", pc.broker_url), ("broker_legacy", legacy.url))})

        # the memory plane between processes: each server process's own
        # ledger behind its /debug/memory, the controller process's verdict
        plane = {sid: get_json(f"{url}/debug/memory", timeout=60.0)
                 for sid, url in probe.urls.items()}
        verdicts = pc.controller.run_memory_check()
        status = pc.controller.memory_status(name)
        if any(p["capacityEstimated"] or not p["tables"].get(name) for p in plane.values()) \
                or verdicts.get(name) != "HEALTHY" or sorted(status["servers"]) != sorted(sids) \
                or status["residentBytes"] != sum(p["tables"][name] for p in plane.values()):
            raise AssertionError(f"process_cluster memory plane: {verdicts} {status} "
                                 f"{ {s: p['tables'] for s, p in plane.items()} }")
        log("process_cluster_memory_plane",
            servers={sid: {k: p[k] for k in ("totalBytes", "capacityBytes", "headroomPct",
                                              "transientPeakBytes", "kinds", "tiering")}
                     for sid, p in plane.items()},
            verdicts=verdicts, memory_status=status)

        # the kafkalite table stays up while the other stream brokers run:
        # their rounds read every realtime table's ingestion status
        cleanups = []
        try:
            realtime_launches = process_realtime(args, pc, probe, work, rt_stream, cleanups)
            streams_launches = process_streams(args, pc, probe, rt_stream,
                                               [f"{PROC_RT_TABLE}_REALTIME"])
        finally:
            for cleanup in cleanups:
                cleanup()

        # failover: server_1 killed; server_0 answers every segment
        pc.kill_server("server_1")
        del probe.urls["server_1"]
        t_f = time.perf_counter()
        for qid, sql, ok, per_server in queries[:2]:
            for attempt in ("first", "next"):
                res, ms, counts = checked(f"failover_{qid}", sql, ok, per_server, strict=False)
                if res.get("segmentsUnavailable") or res["numSegmentsQueried"] != len(table):
                    raise AssertionError(f"process_cluster failover {qid}: {res}")
                if attempt == "next" and (res["partialResult"] or res["numServersQueried"] != 1):
                    raise AssertionError(f"process_cluster failover {qid}: server_1 still "
                                         f"routed: { {k: res.get(k) for k in stat_keys} }")
                log("process_cluster_failover", query=qid, attempt=attempt, launches=counts,
                    answer=res["resultTable"]["rows"][:3], ms=ms,
                    stats={k: res.get(k) for k in stat_keys})
        failover_s = time.perf_counter() - t_f
    log("process_cluster_summary", startup_s=startup_s, upload_to_queryable_s=queryable_s,
        broker_warm_median_ms=numbers,
        in_process_warm_median_ms={k: v["warm_median_ms"] for k, v in CLUSTER_NUMBERS.items()
                                   if "warm_median_ms" in v},
        mix=mix_numbers, in_process_mix=CLUSTER_NUMBERS.get("e2e_mix"),
        failover_s=failover_s, memory=memory)
    return launches, shuffle_launches, realtime_launches, streams_launches


# -- phase 20: memory ------------------------------------------------------------------

MEMORY_TARGET_BLOCKS = 2     # predicted blocks the capped server's target holds
MEMORY_ROUNDS = 2            # passes of the four queries on each route


def memory_queries(cols, for_table) -> list:
    """(id, sql, table, oracle, the kernels it launches per segment and over a
    stacked set) of the memory phase: Q1.1, GROUP_QUERY and the COUNT over
    phase 4's table, the FOR sum over phase 17's lineorder_for (the stacked
    set scans its deltas widened: `masked_sums`)."""
    from pinot_tpu_torch.ssb import FOR_QUERY, GROUP_QUERY, QUERY
    for_cols = {k: v[:sum(s.num_docs for s in for_table)] for k, v in cols.items()}
    return [("q1_1", QUERY, "lineorder_OFFLINE", oracle_q11(cols),
             ("masked_sums", "masked_sums")),
            ("group_by", GROUP_QUERY, "lineorder_OFFLINE", oracle_group(cols),
             ("grouped_agg", "grouped_agg")),
            ("count_quantity", SERVE_COUNT_QUERY, "lineorder_OFFLINE", oracle_count(cols),
             ("masked_sums", "masked_sums")),
            ("for_sum", FOR_QUERY.replace("FROM lineorder", "FROM lineorder_for"),
             "lineorder_for_OFFLINE", oracle_for(for_cols),
             ("masked_sums_fused", "masked_sums"))]


def memory_server(label: str, pipeline: bool, capacity=None) -> tuple:
    """A controller, one server and a broker over phase 17's catalog (restored
    from its snapshot, every segment of both tables assigned to server_0),
    deep store and server_0's data directory: the segments load from that
    directory (the one FOR segment phase 17 held on server_1 from the deep
    store). The server runs the per-segment executor, or a DeviceQueryPipeline
    with `pipeline`; `capacity` sets `server.hbm.capacity.bytes`."""
    from pinot_tpu_torch.cluster import (Broker, Catalog, Controller, DeviceQueryPipeline,
                                         ServerNode)
    from pinot_tpu_torch.cluster.catalog import ONLINE
    from pinot_tpu_torch.cluster.deepstore import LocalDeepStore
    from pinot_tpu_torch.parallel import MeshQueryExecutor
    root = CLUSTER_STATE["root"]
    catalog = Catalog()
    catalog.restore(CLUSTER_STATE["snapshot"])
    for table in list(catalog.ideal_state):
        catalog.update_ideal_state(table, {seg: {"server_0": ONLINE}
                                           for seg in list(catalog.ideal_state[table])})
    if capacity is not None:
        catalog.put_property("clusterConfig/server.hbm.capacity.bytes", str(capacity))
    store = LocalDeepStore(os.path.join(root, "deepstore"))
    controller = Controller("controller_0", catalog, store, os.path.join(root, f"mem_{label}"))
    server = ServerNode("server_0", catalog, store, os.path.join(root, "server_0"),
                        device_pipeline=DeviceQueryPipeline(MeshQueryExecutor())
                        if pipeline else None)
    broker = Broker("broker_0", catalog)
    broker.register_server_handle("server_0", server.execute_partial)
    controller.memory_pollers["server_0"] = server.memory_snapshot
    return controller, server, broker


def unload_all(server) -> int:
    """Unload every segment of the server (no query holds one): the ledger's
    total afterwards."""
    from pinot_tpu_torch.utils.memledger import get_ledger
    for mgr in server.tables.values():
        for name in mgr.segment_names:
            mgr.remove_segment(name)
    server.shutdown()
    return get_ledger().resident_bytes()


def run_memory(args, table, cols, for_table) -> tuple:
    """Phase 20: the device-memory plane on the card. One server takes phase
    4's table and the FOR table with `server.hbm.capacity.bytes` set so that
    its target (capacity less the 10% headroom) holds MEMORY_TARGET_BLOCKS of
    the 8 predicted blocks: the table is four times the budget. The four
    queries through the broker, MEMORY_ROUNDS passes, on the per-segment route
    and then on a server on the serving pipeline: every answer on its oracle;
    the launches exact (per segment one a segment the gate admitted; on the
    pipeline one a query with an admitted segment, the pipeline's own scan
    count; none for the host tier); the ledger at or under capacity after
    every query, beside the allocator's bytes over the phase's baseline and
    the transient peak: `memory_query`; each route's rejections, evictions,
    host-tier segments and allocator peak: `memory_route`. Then with the cap
    lifted (the card's own capacity, printed), every segment admitted, the
    ledger reconciled against the allocator (`memory_lifted`); a retention
    round under `controller.retention.cold.demote` demotes one segment and
    the next Q1.1 loads it again (`memory_cold`); unloading every segment
    returns the ledger to 0 (`memory_unload`). Returns the launches and the
    numbers."""
    from pinot_tpu_torch.engine.datablock import predicted_block_bytes
    from pinot_tpu_torch.utils.memledger import get_ledger, reset_ledger
    from pinot_tpu_torch.cluster.services import server_device_memory

    queries = memory_queries(cols, for_table)
    segments = {"lineorder_OFFLINE": len(table), "lineorder_for_OFFLINE": len(for_table)}
    predicted = predicted_block_bytes(table[0])
    capacity = int(MEMORY_TARGET_BLOCKS * predicted / 0.9) + 2
    table_bytes = sum(predicted_block_bytes(s) for s in table)
    launches = counts_of()
    gc.collect()
    torch.cuda.synchronize()
    reset_ledger()
    baseline = torch.cuda.memory_allocated()
    log("memory_data", predicted_block_bytes=predicted, capacity_bytes=capacity,
        target_bytes=int(capacity * 0.9), table_predicted_bytes=table_bytes,
        table_over_target=table_bytes / int(capacity * 0.9), baseline_allocated=baseline)

    def checked(label, server, broker, qid, sql, table, want, kernels, pipeline) -> dict:
        pipe = server.device_pipeline
        kernel = kernels[pipeline]
        before = pipe.stats()["scanLaunches"] if pipe is not None else 0
        reset_launch_counts()
        t0 = time.perf_counter()
        res = broker.handle_query(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        st = res.stats
        host = st["segmentsServedHostTier"]
        admitted = segments[table] - host
        device = (1 if admitted else 0) if pipeline else admitted
        expected = counts_of(**{kernel: device})
        if pipe is not None and kernel != "grouped_agg":
            scans = pipe.stats()["scanLaunches"] - before
            if scans != device:
                raise AssertionError(f"memory {label} {qid}: the pipeline counts {scans} "
                                     f"scans, expected {device}")
        if counts != expected:
            raise AssertionError(f"memory {label} {qid}: launches {counts}, expected "
                                 f"{expected} for {admitted} admitted segments")
        if not rows_match(res.rows, want) or st["partialResult"] \
                or st["numSegmentsQueried"] != segments[table]:
            raise AssertionError(f"memory {label} {qid}: {res.rows[:3]} {st}")
        for k, v in counts.items():
            launches[k] += v
        snap = get_ledger().snapshot()
        return {"ms": ms, "host_tier": host, "admitted": admitted, "launches": counts,
                "promotions": st["tierPromotions"], "cold_loaded": st["segmentsColdLoaded"],
                "cold_load_ms": st["coldLoadMs"], "ledger_bytes": snap["totalBytes"],
                "allocated_over_baseline": torch.cuda.memory_allocated() - baseline,
                "transient_peak_bytes": snap["transientPeakBytes"],
                "answer": res.rows[:2]}

    numbers = {}
    for label, pipeline in (("per_segment", False), ("pipeline", True)):
        torch.cuda.reset_peak_memory_stats()
        controller, server, broker = memory_server(label, pipeline, capacity)
        host_total = 0
        for r in range(MEMORY_ROUNDS):
            for qid, sql, table, want, kernel in queries:
                q = checked(label, server, broker, qid, sql, table, want, kernel, pipeline)
                if q["ledger_bytes"] > capacity:
                    raise AssertionError(f"memory {label} {qid}: the ledger holds "
                                         f"{q['ledger_bytes']} bytes over the capacity "
                                         f"{capacity}")
                host_total += q["host_tier"]
                log("memory_query", route=label, round=r, query=qid, **q)
        tiering = server.tiering.snapshot()
        if tiering["rejections"] + tiering["evictions"] == 0:
            raise AssertionError(f"memory {label}: the gate never rejected nor evicted")
        verdict = controller.run_memory_check()
        numbers[label] = {
            "rejections": tiering["rejections"], "evictions": tiering["evictions"],
            "admissions": tiering["admissions"], "promotions": tiering["promotions"],
            "segments_served_host_tier": host_total,
            "ledger_watermark_bytes": get_ledger().snapshot()["watermarkBytes"],
            "allocated_peak_over_baseline": torch.cuda.max_memory_allocated() - baseline,
            "capacity_bytes": capacity, "verdicts": verdict}
        left = unload_all(server)
        if left:
            raise AssertionError(f"memory {label}: {left} ledger bytes after the unload")
        log("memory_route", route=label, **numbers[label])
        del controller, server, broker
        gc.collect()

    # the cap lifted: the card's own capacity, every segment admitted
    reset_ledger()
    controller, server, broker = memory_server("lifted", False)
    cap_bytes, estimated = get_ledger().capacity_bytes()
    if estimated:
        raise AssertionError("memory: the card's capacity probe came back estimated")
    lifted = {}
    for qid, sql, table, want, kernel in queries:
        lifted[qid] = checked("lifted", server, broker, qid, sql, table, want, kernel, False)
        if lifted[qid]["host_tier"]:
            raise AssertionError(f"memory lifted {qid}: {lifted[qid]['host_tier']} "
                                 "segments on the host tier under the card's capacity")
    torch.cuda.synchronize()
    walked = server_device_memory(server)
    rec = get_ledger().reconcile(baseline)
    numbers["lifted"] = {"capacity_bytes": cap_bytes, "capacity_estimated": estimated,
                         "reconcile": rec, "walked_staged_bytes": walked["stagedBytes"],
                         "unledgered_staged_bytes": walked["stagedBytes"] - rec["ledgerBytes"],
                         "queries": {q: v["ms"] for q, v in lifted.items()}}
    log("memory_lifted", **numbers["lifted"])

    # the cold tier: retention demotes one segment, the next Q1.1 loads it
    name = "lineorder_OFFLINE"
    catalog = server.catalog
    cfg = catalog.table_configs[name]
    cfg.retention_days, cfg.time_column = 1.0, "lo_orderdate"
    catalog.put_table_config(cfg)
    catalog.put_property("clusterConfig/controller.retention.cold.demote", "true")
    now_ms = int(time.time() * 1000)
    victim = sorted(catalog.segments[name])[0]
    for seg, meta in catalog.segments[name].items():
        # the victim's rows end two days back, past the 1-day retention
        meta.end_time_ms = now_ms - (2 * 86_400_000 if seg == victim else 0)
    acted = controller.run_retention(now_ms=now_ms)
    if acted != [f"cold:{name}/{victim}"] or victim in server.tables[name].segment_names \
            or get_ledger().resident_bytes(table=name, segment=victim):
        raise AssertionError(f"memory cold: retention acted {acted}")
    qid, sql, table, want, kernel = queries[0]
    cold = checked("cold", server, broker, qid, sql, table, want, kernel, False)
    if cold["cold_loaded"] != 1 or victim not in server.tables[name].segment_names:
        raise AssertionError(f"memory cold: {cold}")
    numbers["cold"] = {"demoted": victim, "cold_load_ms": cold["cold_load_ms"],
                       "query_ms": cold["ms"], "cold_loads": server.tiering.snapshot()["coldLoads"]}
    log("memory_cold", **numbers["cold"])
    left = unload_all(server)
    gc.collect()
    torch.cuda.synchronize()
    numbers["unload"] = {"ledger_bytes": left,
                         "allocated_over_baseline": torch.cuda.memory_allocated() - baseline}
    if left:
        raise AssertionError(f"memory: {left} ledger bytes after every segment unloaded")
    log("memory_unload", **numbers["unload"])
    return launches, numbers


def trace_query(fn, runs: int = TRACED_RUNS) -> dict:
    """`runs` warm runs under torch.profiler (`_profiled`), per run: wall ms,
    device-busy ms (the union of the card's kernel and copy intervals), the
    idle share, and the ops that took the most device time. The profiler was
    seen to drop ops from a window of one short run, so a trace covers several,
    and the count of scan kernel events it saw is given, to be held against
    the launches those runs made; `op_counts` counts every device op by name."""
    spans, wall_s = _profiled(fn, runs)
    wall_us = wall_s * 1e6 / runs
    busy_us, cur_start, cur_end = 0.0, None, None
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        if cur_end is None or a > cur_end:
            busy_us += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    busy_us += 0.0 if cur_end is None else cur_end - cur_start
    by_name, op_counts = {}, {}
    for name, a, b in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        op_counts[name[:80]] = op_counts.get(name[:80], 0) + 1
    busy_us /= runs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"runs": runs, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if spans else None,
            "device_events": len(spans),
            "scan_kernel_events": sum(KERNEL_SYMBOL in name for name, _, _ in spans),
            "top_device_ms": {k[:60]: v / 1e3 / runs for k, v in top},
            "op_counts": op_counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--rows", type=int, default=16 * 1024 * 1024)
    ap.add_argument("--trace", action="store_true",
                    help="also profile warm runs of each query (device idle share)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from pinot_tpu_torch.engine import cuda_lib

    started = time.perf_counter()
    seconds = {}

    def lap(phase: str, t0: float) -> None:
        seconds[phase] = time.perf_counter() - t0

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    # phase 2: build (one nvcc per source, started together)
    t0 = time.perf_counter()
    cuda_lib.build(["masked_sums", "bitmap_filter", "grouped_agg"])
    log("build", seconds=time.perf_counter() - t0,
        ptxas=kernel_usage(cuda_lib.build_log("masked_sums")),
        ptxas_bitmap_filter=bitmap_usage(cuda_lib.build_log("bitmap_filter")),
        ptxas_grouped_agg=grouped_usage(cuda_lib.build_log("grouped_agg")),
        sass_atomics_grouped_agg=grouped_sass())

    # phase 3: kernels against their plain versions, at the shapes of phases 4 and 5
    t0 = time.perf_counter()
    kstats = check_kernels(segment_rows(args.rows, SEGMENTS),
                           segment_rows(min(FOR_ROWS, args.rows), FOR_SEGMENTS),
                           stacked_rows(args.rows, SEGMENTS), args.seed)
    lap("kernels", t0)

    # phase 4: the path; phase 5: the set executor and the pipeline over its
    # table; phase 6: selections; phase 7: joins; phase 8: realtime; phase 9:
    # expressions and the host path; phase 10: the aggregation library; phase
    # 11: the filter indexes and star-trees; phase 12: the search indexes and
    # compressed raw columns; phase 13: multi-value columns; phase 14: upsert and
    # dedup; phase 15: batch ingestion and the query surface. Each phase returns every
    # kernel's launches in its checked runs: the counts set to 0 just before
    # a run and read just after, each held to the run's expected count.
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_data_", dir=cuda_lib.BUILD_DIR)
    # phases 12 and 13's tables, phase 14's streams and phase 15's files build
    # in worker processes beside the earlier phases
    build_pool = concurrent.futures.ProcessPoolExecutor(
        6, mp_context=multiprocessing.get_context("spawn"))   # one per build

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        lap(name, t0)
        return out

    try:
        path_launches, table, cols, for_table = phase("path", run_path, args, work,
                                                      build_pool)
        # the worker builds start once phase 4's table is built: beside it
        # they slowed its single-process build by up to 80%
        index_job = build_pool.submit(build_index_table, args.rows, args.seed,
                                      os.path.join(work, "index"))
        search_jobs = start_search_builds(build_pool, args, work)
        mv_jobs = start_mv_builds(build_pool, args, work)
        upsert_jobs = start_upsert_builds(build_pool, args)   # queued behind the builds
        batch_jobs = start_batch_builds(build_pool, args, work)
        serve_launches = phase("serve", run_serve, args, table, cols)
        select_launches = phase("select", run_select, args, table, cols)
        join_launches = phase("join", run_join, args, table, cols, work)
        realtime_launches, realtime_numbers = phase("realtime", run_realtime, args, table,
                                                    cols, work)
        missing = [k for k in ("masked_sums", "masked_sums_fused")
                   if realtime_launches[k] == 0]
        if missing:
            raise AssertionError(f"the realtime path launched no {missing}")
        expr_launches, expr_numbers = phase("expr", run_expr, args, table, cols, work)
        if expr_launches["host"]["masked_sums"] or expr_launches["host"]["masked_sums_fused"] \
                or not expr_launches["expr"]["masked_sums"]:
            raise AssertionError(f"expr phase launches {expr_launches}: the host path must "
                                 "launch no scan, the CASE sum masked_sums")
        aggs_launches, _ = phase("aggs", run_aggs, args, table, cols, work)
        if aggs_launches["masked_sums"] or aggs_launches["masked_sums_fused"]:
            raise AssertionError(f"aggs phase launches {aggs_launches}: the aggregation "
                                 "library reaches no scan")
        index_launches, index_by_route, bitmap_numbers = phase("index", run_index, args,
                                                                table, cols, work, index_job)
        if not index_launches["bitmap_filter"]:
            raise AssertionError("the index phase launched no bitmap_filter")
        search_launches, search_by_route = phase("search", run_search, args, cols, for_table,
                                                 work, search_jobs)
        if not all(search_launches.values()):
            raise AssertionError(f"the search phase launches {search_launches}: each kernel "
                                 "must run on its path")
        mv_launches, mv_by_route, mv_numbers = phase("mv", run_mv, args, work, mv_jobs)
        if not (mv_launches["masked_sums"] and mv_launches["bitmap_filter"]):
            raise AssertionError(f"the mv phase launches {mv_launches}: Q1.1 must take the "
                                 "scan and the mixed tree the bitmap filter")
        upsert_launches, upsert_numbers = phase("upsert", run_upsert, args, work, upsert_jobs)
        if not all(upsert_launches.values()):
            raise AssertionError(f"the upsert phase launches {upsert_launches}: each kernel "
                                 "must run on its path")
        batch_launches, batch_numbers = phase("batch", run_batch, args, work, batch_jobs)
        if not all(batch_launches.values()):
            raise AssertionError(f"the batch phase launches {batch_launches}: each kernel "
                                 "must run on its path")
        groupby_launches, group_numbers = phase("groupby", run_groupby, args, table, cols)
        cluster_launches = phase("cluster", run_cluster, args, table, cols, for_table, work)
        realtime_cluster_launches, rt_stream = phase("realtime_cluster", run_realtime_cluster,
                                                     args, work)
        (process_cluster_launches, shuffle_launches, process_realtime_launches,
         process_streams_launches) = phase("process_cluster", run_process_cluster, args, table,
                                           cols, work, rt_stream)
        del rt_stream
        missing = [k for k in ("masked_sums", "grouped_agg") if not process_cluster_launches[k]]
        missing += [f"{k} (shuffle)" for k in ("bitmap_filter", "grouped_agg")
                    if not shuffle_launches[k]]
        missing += [f"{k} ({path})"
                    for path, counts in (("process_realtime", process_realtime_launches),
                                         ("process_streams", process_streams_launches))
                    for k in ("masked_sums", "masked_sums_fused", "grouped_agg") if not counts[k]]
        if missing:
            raise AssertionError(f"the process_cluster phase launched no {missing} in its "
                                 "server processes")
        memory_launches, memory_numbers = phase("memory", run_memory, args, table, cols,
                                                for_table)
        missing = [k for k in ("masked_sums", "masked_sums_fused", "grouped_agg")
                   if not memory_launches[k]]
        if missing:
            raise AssertionError(f"the memory phase launched no {missing}")
    finally:
        build_pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(work, ignore_errors=True)

    sources = {"masked_sums": ("pinot_tpu_torch/csrc/masked_sums.cu",
                               "pinot_tpu/engine/pallas_scan.py:37"),
               "masked_sums_fused": ("pinot_tpu_torch/csrc/masked_sums.cu",
                                     "pinot_tpu/engine/pallas_scan.py:94")}
    kernels = []

    def launches_by_path(name):
        return {"per_segment": path_launches[name], "serve": serve_launches[name],
                "select": select_launches[name], "join": join_launches[name],
                "realtime": realtime_launches[name], "expr": expr_launches["expr"][name],
                "host": expr_launches["host"][name], "aggs": aggs_launches[name],
                "index": index_launches[name], "search": search_launches[name],
                "mv": mv_launches[name], "upsert": upsert_launches[name],
                "batch": batch_launches[name], "groupby": groupby_launches[name],
                "cluster": cluster_launches[name],
                "realtime_cluster": realtime_cluster_launches[name],
                "process_cluster": process_cluster_launches[name],
                "shuffle": shuffle_launches[name],
                "process_realtime": process_realtime_launches[name],
                "process_streams": process_streams_launches[name],
                "memory": memory_launches[name]}
    for name in ("masked_sums", "masked_sums_fused"):
        s = kstats[name]
        by_path = launches_by_path(name)
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": s["max_abs_err"], "max_rel_err": s["max_rel_err"],
                        "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": None,
                        "kernel_ms": s["kernel_ms"],
                        "call_ms": s["call_ms"], "plain_call_ms": s["plain_call_ms"],
                        "shape_case": s["case"],
                        "cases": dict(s["cases"], realtime_view=realtime_numbers[name],
                                      upsert_valid_band={
                                          k: v for k, v in upsert_numbers.items()
                                          if k.startswith("q1_1" if name == "masked_sums"
                                                          else "for_sum")},
                                      **({"expr_case_operand": expr_numbers}
                                         if name == "masked_sums" else {}))})
    head = bitmap_numbers["bitmap_query, one segment, mask"]
    by_path = launches_by_path("bitmap_filter")
    kernels.append({"name": "bitmap_filter", "route": "cuda", "source": BITMAP_SOURCE[0],
                    "replaces": BITMAP_SOURCE[1], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "launches_by_route_index": {r: c["bitmap_filter"]
                                                for r, c in index_by_route.items()},
                    "launches_by_route_search": {r: c["bitmap_filter"]
                                                 for r, c in search_by_route.items()},
                    "launches_by_route_mv": {r: c["bitmap_filter"]
                                             for r, c in mv_by_route.items()},
                    "max_abs_err": max(c["max_abs_err"] for c in bitmap_numbers.values()),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                    "library_ms": None, "library_note": BITMAP_LIBRARY_NOTE,
                    "call_ms": head["call_ms"],
                    "shape_case": "bitmap_query, one segment, mask", "cases": bitmap_numbers})
    head = group_numbers["region, one segment"]
    by_path = launches_by_path("grouped_agg")
    kernels.append({"name": "grouped_agg", "route": "cuda", "source": GROUPED_SOURCE[0],
                    "replaces": GROUPED_SOURCE[1], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": max(c["max_abs_err"] for c in group_numbers.values()),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"], "library_note": GROUPED_LIBRARY_NOTE,
                    "call_ms": head["call_ms"], "rung": head["rung"],
                    "shape_case": "region, one segment", "cases": group_numbers})
    log("seconds", total=time.perf_counter() - started, **seconds)
    print(json.dumps({"kernels": kernels, "note": LIBRARY_NOTE,
                      "mv_mask_cases": mv_numbers, "batch": batch_numbers,
                      "memory": memory_numbers}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
