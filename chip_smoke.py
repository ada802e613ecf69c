"""Chip smoke test of the PyTorch/CUDA port (pixie_tpu_torch) on one GPU.

    python3 chip_smoke.py [--rows N] [--profile]
    python3 chip_smoke.py --mesh-cards N      (N cards: the mesh paths only)
    python3 chip_smoke.py --ab-parent DIR     (config 10's widths, DIR's tree
                                               against this one, in turns)
    python3 chip_smoke.py --ab-parent DIR --ab-paths reservoir_latency,...
                                              (the named paths instead)

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. In order it:

1. prints the card (torch name; nvidia-smi name and power limit);
2. builds the hand kernels from pixie_tpu_torch/ops/kernels/*.cu (one nvcc
   per source, started together, cached in pixie_tpu_torch/_build/) and
   prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (2^21-row blocks; 16 groups, 4096 for the HLL kernels
   as config 3 runs them; H3 in each of its lanes (S = 16, 64 and 600, f32
   and f64 values, its global atomics counted; 2^23 + 5 rows into one
   cell) and H8 at sketches' blocks and
   pixie_tpu_torch/ops/tdigest_edges.py's edge digests (the groups on its exact
   branches counted), both timed beside an empty kernel on the same grid
   and with CTA 0's phases; H7, the t-digest's update without a sort, at ten
   edge blocks and at sketches' block, with its phases' device times and
   its device operations a block against the sorting update (H7a,
   torch.sort, H7b)
   (those two held at 16, 300 and 512 groups and timed at the windowed
   paths' 512 slots and at 16); H6 at config 5's 16 x 4 keys, endpoint_load's 34
   groups x 4098 content words and past its tables; H11 over every staged
   row kind in every lane, timed at flow_window's S = 1, config 10's S = 64
   f64 and the flows min/max's S = 4096 int32 narrowed; config 1's first
   block for H12 (with CTA 0's phases) and its index lane at config 8
   OUTER's unmatched rows as compact_unmatched_rows calls it (the call's
   time and device operations too), config 8's probe side for H13-H15, join8_oncall_agg's
   block for H16 as staged (uint8 keys and gids; with CTA 0's phases and the
   call's device operations; and a uint16 key column with an offset, the warp
   lane's 64 groups and K 2^20 over 2^16 groups, the same bits in two launches
   up to 64 groups), a block of the let table for H17's two programs: svc_let's
   predicate program and an f64 program; a full 2^23-row stream window for
   the codec's decodes H18 (4096 runs, every block dtype; and the codec's
   worst admitted int64 shape, about 2.3 rows a run) and H19 (nibble,
   uint8 and uint16 deltas into every integer dtype; and its edges: 3
   shards of 1, 7 and 1,000,001 rows, rows on and off its tile edges, sums
   that wrap); config 5's 16 x 4
   cells and the budget's 32 x 256 for H20 and H21; a block of the
   service_stats table for H22 (B = 1, 7, 16, 32 slots of one to three
   terms, op-6 lists of 2 and 1024 members) and H23 over rows as staged
   (the seven families' slot bits, 16 groups: the slot lane; B = 16 with
   narrowed, int64 and f64 rows: shared partials; 4096 groups: global
   atomics); a 2^21-row ring
   window for H24 (int32 codes and int64 narrowed, f64 to f32 with NaN
   payloads, +-0, +-inf, f32 subnormals and overflow, int-dictionary codes
   at C = 3, 256 and 65536, a raw cast), also against the host pack, and
   its shard-stride lane: a window of 1, 4 and 8 logical shards converted
   by one launch into its slice of a one-card staging, timed at 8) and at
   shapes that take its other memory path (edge cases for the join's kernels),
   under the contract PERF.md states (integers, hashes, min/max and the
   scan's compaction and the join exact; H7b's t-digest cluster cells under
   Fault-4, H7's and H8's weights bit for bit; H17 bit for bit but the f64 transcendentals, within 2 ulp; H18
   and H19 bit for bit; H20 and H21 exact; H22 bit for bit, H23's integers
   exact and its f64 sums within 1e-12 * sum |v|; H24 bit for bit; H29,
   the cross-shard merge, bit for bit at 2, 4 and 8 shards of 4096 groups
   in every lane, with NaN, -0.0/+0.0, int64 overflow and empty shards,
   timed at config 10's largest merge; H30-H32, the kernels of the TPU
   kernels no path calls, exactly: the count-min query over config 10's
   64 x 4 x 8192 state and 2^21 queries, hash_columns over 2^21 (int64,
   f64) rows and edge words, clz64 over its outputs), and
   times kernel, plain version and the
   one PyTorch library call that computes the same function, where there is
   one (median of 30 calls, CUDA events between calls queued behind a sleep
   kernel; for H17 the tree of torch ops it replaces), and the kernel again
   with the calls paced by the host;
4. checks the kernel path against the plain path end to end at 2^20 rows
   for the queries below, config 4 with a filter (any() through H11),
   every join type over both owner tables, the three join aggregates and
   Q1-Q4; flow_window and status_mix at one stream window and at four
   (2^18 rows each), twice each; and a group-by over http_events sorted by
   (service, status), whose gid lane and status column ship as RLE (H18),
   likewise, then driven like a main path (sorted_keys); and K16's batched
   fold, one batch of the seven soak families and one of three sketch
   thresholds called through ``_run_program_batched`` on both paths, each
   slot also against its query run alone on the card;
5. runs the port's main paths through
   Carnot(device_executor=DeviceExecutor(block_rows=2^21)), each with the
   launch counts and lanes zeroed just before it, one cold and three warm
   queries, each verified against numpy truths of the generated columns,
   and the counts read just after it (every kernel of the path must have
   launched). With the default flags every aggregate path's cold query
   stages through the stream (2^23-row windows: 8 for the 2^26- and
   64M-row tables, 4 for the let table; the stage_stream lane, checked)
   with the staging codec; the scan and the joins stage in one piece, with
   the codec:
   - px/service_stats (BASELINE config 2) over http_events (bench.py's
     generator: seed 42, 16 services, status mix {200: .85, 301/404/500:
     .05}, exponential(3e7) latency; 2^26 rows by default) with bench.py's
     verify() checks (counts exact, error_rate within 1e-9, p50/p99 within
     4% of a numpy truth histogram);
   - config 5, t-digest + count-min over the same table: count-min totals
     exact, max_est equal to the largest cell the true per-status counts
     give, t-digest p50/p99 within 4% of the truth histogram's; count_min
     takes the int-dictionary cell lane (H21; no hash kernel, no H6);
   - status_mix, approx_count_distinct and count_min of resp_status per
     service over the same table, both on the cell lane (H20, H21): kinds
     within 12% of 4 in every group, count-min totals exact;
   - shared_scan, bench.py config 6's query families over the same table:
     the serving soak's seven predicate families x two output-name variants
     (count and sum of latency by service) and a sketch group (quantiles
     and approx_count_distinct by service under three latency thresholds),
     each run serially first, then 16 closed-loop client threads, 4
     requests each, with shared scans, predicate batching and a 25 ms
     window: every result equal to its serial baseline (f64 sums within
     1e-12 * sum |v|) and to numpy's counts, a dispatch of width >= 2, no
     detached follower, H22 and H23 launched; it prints queries/s, p50/p99,
     dispatches per query and the batch-width histogram;
   - config 3, px/net_flow_graph over conn_flows (bench.py's generator: seed
     45, 64 pods each side, 4096 (src, dst) groups; 64,000,000 rows,
     bench.py's BENCH_SMALL_ROWS default): byte sums exact, distinct ports within 12% of the truth for
     every pair and 2.5% on average;
   - the per-pair min/max of px/net_flow_graph over the same conn_flows
     (H11): every min and max exact;
   - flow_window, px/net_flow_graph's time window (net_flow_graph.pxl:
     38-41, without its ctx filter) over the same conn_flows: time_ ships as
     nibble deltas (H19), then H11: time_min 0 and time_max 63,999,999,000
     exactly;
   - config 1, px/http_data over http_small (bench.py's generator: seed 44,
     status {200: .9, 404/500: .05}; 64,000,000 rows) through the device
     scan (H12): the first 1000 rows with resp_status >= 400 in row order,
     time_, service and latency / 1e6 bit-equal to numpy's;
   - config 5's sketches over the same http_small (sketches_small, the
     unringed baseline of sketches_ring), then bench.py's default build of
     http_small: a second table, http_small_ring, built with resident ingest
     on (2^21-row ring windows, depth 64): the ring must be valid with 30
     windows, 1,761,607,680 resident bytes, pinned, and memory_allocated
     must rise by them (build seconds printed against the unringed build);
     http_data_ring, config 1 over it: 30 resident hits, wire_bytes below a
     third of stage_bytes, no wire bytes on a warm query, H24 launched; a
     time-bounded count over it (0 hits, counts exact); sketches_ring, config
     5's sketches over it: 30 hits in 31 stream windows, latency converted
     as f32, resp_status as int-dictionary codes and the service codes
     narrowed on every hit, count-min cells equal to sketches_small's; then
     the ring is released (0 resident bytes, memory_allocated drops by
     them);
   - config 4, px/perf_flamegraph over stacks (seed 43, 4096 stacks;
     64,000,000 rows): any() on its host lane and the sums through H1;
     4096 rows, count sums exact, each stack_trace its identity string;
   - config 8, the equijoin of svc_owners (16 services, 4 teams) INNER to
     join_fact (bench.py's generator: seed 46, 16 services, exponential(3e7)
     latency; 4,000,000 rows, bench.py's default) through the sort-merge
     lane (torch.sort, H13, H14, H15): 4,000,000 rows, time_ and latency the
     fact columns bit for bit in row order, svc == service, owner ==
     team-{i % 4}; and the same fact table OUTER-joined to
     svc_owners_partial (14 services owned, 4 ghosts; H12 compacts the
     unmatched rows): the owned rows in row order, then the unowned ones
     with svc and owner "", then the 4 ghosts with time_ 0, service "" and
     latency 0.0; each query must count the join_sort_merge lane;
   - joins that feed an aggregation, over the same tables and svc_oncall
     (service i has i % 4 on-call rows with 1 + (i + j) % 5 seats):
     join8_team_agg, svc_owners INNER join_fact grouped by owner (count,
     sum, mean, min, max of latency), and join8_oncall_agg, join_fact INNER
     svc_oncall grouped by service (count and sum of latency, sum and max
     of seats), through the join-aggregate lane (H1, H2, H11 over the right
     side's join keys; H16 and H11 over the left side): counts, integer
     sums and min/max exact, f64 sums within 1e-12 * sum |terms| of numpy's,
     each query counting the join_agg lane; join8_left_agg, join_fact LEFT
     svc_owners_partial grouped by owner (count, mean, max of latency),
     through the sort-merge lane and the host AggNode on the card (H1, H2,
     H11): four teams and the unowned services' group, counts and maxima
     exact, means within a relative 1e-12;
   - service_stats.pxl's own functions over a let table (seed 47, 2^25 rows
     18 us apart: 16 services, 4096 request paths /api/v1/res-<r>/<id> plus
     /healthz and /readyz, 1024 clients plus '-', config 2's status mix,
     exponential(3e7) latency, lognormal body sizes), each through H17:
     Q1 svc_let (filters, contains(service, 'svc-1'), bin windows on the
     host key plan; H1-H4), Q2 http_code_histogram and Q3
     latency_histogram (counts exact, Q3's float bins bit-equal to numpy's),
     and Q4, per-endpoint load keyed by regex_replace of the path (the
     dictionary-LUT key) with approx_count_distinct and count_min over
     STRING columns (the arghash lane: H5, H6, H10), stddev,
     variance, a select sum, mean(log10) and a floor sum, against numpy
     truths (counts and integer sums exact, p50/p90/p99 within 4%, error
     rate within 1e-9, distinct clients within 12%, variance within
     4e-12 * sumsq / n), each query counting its fold lane;
   - the sharded fold (distributed/mesh.py; K18 as H29): config 5's
     t-digest (TREE merges through H8) and reservoir_latency (TREE merges
     through H26) over http_events on a 4-shard mesh of the card
     (``DeviceExecutor(mesh_config=d:4, devices=[cuda:0] * 4)``), held to
     verify_sketches and to the reservoirs' numpy truth for that geometry;
     and bench.py config 10's mesh-width sweep: 2^25 rows of
     tools/microbench_mesh.py's mesh_bench (seed 21, 64 services, status
     0-6, standard normal lat) and its query (count, sum, min, max,
     approx_count_distinct, count_min) at d:1 and over 8 logical shards of
     the card at hosts:1,d:8, hosts:2,d:4, hosts:4,d:2 and hosts:8,d:1:
     counts, min and max equal numpy's, sums within 1e-12 * sum |v| of
     math.fsum, every 8-shard width's integer, min/max, HLL and count-min
     outputs equal d:1's, H29 launched; each width's warm and cold
     seconds, K18's device milliseconds and share of a warm query, and
     H29's launches are printed;
   - the partitioned join (mesh_join): config 8's INNER and OUTER joins on
     hosts:2,d:4 and hosts:4,d:2 over 8 logical shards of the card, each
     query counting the join_partitioned lane (H13-H15, H12), held to the
     d:1 joins' truths and rows and to the replicated lane's rows on the
     same mesh; warm and cold seconds with the host's inverse reorder
     (join_reorder) are printed;
   - the recovery plane (mesh_chaos, bench.py config 12 at config 10's
     scale): 2^25 rows of mesh_bench (seed 23) in 8 stream windows on
     hosts:2,d:4 over 8 logical shards; cold folds with window checkpoints
     on and off, then one with mesh.host_loss armed after window 4: it
     resumes from window 4's checkpoint on d:8 and equals the unfaulted
     flat fold (and numpy); after an append the next fold runs on the full
     geometry again; recovery seconds, the refolded fraction and the
     checkpoints' cost are printed;
   - the sharded ring (ring_mesh_d8, ring_mesh_hosts2_d4): bench.py's
     default http_small at full width (64M rows: 30 ring windows of 2^21
     rows, 1,761,607,680 B over 4 columns), ringed by two executors over
     8 logical shards of the card (d:8 and hosts:2,d:4; each window 8
     shards of 2^18 rows, converted by one H24 launch a column a window);
     http_data and config 5's sketches over each, cold and warm, held to
     bench.py's truths, 30 hits a cold query, equal bit for bit to the
     same geometry with the ring off; then ring_mesh_chaos, a host lost
     mid-fold on the hosts:2,d:4 ring: the degraded rung serves no ring
     window and equals the unfaulted fold, the next query hits the ring
     on the full geometry;
   - the pre-join predicate pushdown (join8_pushdown,
     join8_outer_pushdown): config 8 with r.latency above its median and
     one owned service left out of l, in the device lane, held to numpy
     and to the host EquijoinNode's rows, then on hosts:2,d:4 in the
     partitioned lane;
   - the declined aggregation lanes (svc_windowed, sketches_windowed,
     svc_pem_split, sketches_pem_split): service_stats and config 5's
     sketches made windowed (the compiled plan's AggOp with windowed=True,
     run by execute_plan) over http_events' rows written in 2^17-row
     batches with eow on each 2^21-row window's last (32 windows, 512
     (window, service) slots: H3's global lane, the t-digest's wide lane
     H7a, torch.sort, H7b), each window's batch against that window's
     numpy truths and the key plan's share of the cold query printed; and
     the same queries split by the DistributedPlanner over two PEM Carnots
     (rows 0-2^25 and 2^25-2^26, each with its own DeviceExecutor) and a
     Kelvin, one BridgeRouter, each instance's fragments run by
     execute_plan(manage_router=False), every PEM's PARTIAL fold on the
     card (its executor offloads every query, the fold_partial lane twice
     a query), against the whole table's truths;
6. prints each path's cold breakdown (the stream's keys and wire_bytes /
   stage_bytes), warm times and launches, each phase's seconds, one JSON
   line of per-kernel results (H1-H32, H7 and the hash kernel; H30-H32 and
   the hash kernel with 0 launches: no path calls them; H7a and H7b timed
   at sketches_windowed's 512 slots), the nvidia-smi line,
   and as its last line
   {"ok": true, "device": {...}}.

With ``--mesh-cards N`` it runs only the mesh paths over N real cards
against the same geometry over N logical shards of card 0: config 10 at
d:N and hosts:2,d:N/2, config 8's joins and config 12 at hosts:2,d:N/2,
the http_small ring at d:N, and the PEM split with its two PEMs on cuda:0
and cuda:1. A path that means one card names it
(``CARD``, cuda:0): an executor that names no device spans every card.

Any failed check raises, and the script exits non-zero before the last
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 at
# 3.35 TB/s; 67 TFLOP/s for scalar (non-tensor-core) f32 work, used as the
# rate of the kernels' scalar adds, compares and logs.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

BLOCK_ROWS = 1 << 21
# The card a one-card path names: an executor that names no device spans
# every card (the flat mesh over all of them), so a path that means one
# card names it.
CARD = "cuda:0"
TIME_REPS, TIME_WARMUP = 30, 3  # calls per time_ms
WARM_QUERIES = 3
N_SERVICES = 16
H4_GROUPS = (N_SERVICES, 1024, 4096)  # the paths' H4 group counts (--log-shapes), and 4096
TRUTH_BINS = 4096
TRUTH_LO, TRUTH_HI = 1.0, 1e12
TRUTH_EDGES = np.logspace(math.log10(TRUTH_LO), math.log10(TRUTH_HI), TRUTH_BINS - 1)
REPLACES = {
    "segment_rows_sum_i64": "pixie_tpu/ops/segment.py:235",
    "segment_rows_sum_f64": "pixie_tpu/ops/segment.py:593",
    "log_histogram_update": "pixie_tpu/ops/histogram.py:59",
    "hist_quantiles": "pixie_tpu/ops/histogram.py:83",
    "hash32": "pixie_tpu/ops/hashing.py:106",
    "hll_update": "pixie_tpu/ops/hll.py:54",
    "countmin_update": "pixie_tpu/ops/countmin.py:58",
    "tdigest_pack": "pixie_tpu/ops/tdigest.py:56",
    "tdigest_cluster": "pixie_tpu/ops/tdigest.py:78",
    "tdigest_merge": "pixie_tpu/ops/tdigest.py:133",
    "tdigest_quantiles": "pixie_tpu/ops/tdigest.py:163",
    "hll_estimate": "pixie_tpu/ops/hll.py:118",
    "segment_minmax": "pixie_tpu/ops/segment.py:657",
    "scan_compact": "pixie_tpu/parallel/pipeline.py:4126",
    "join_probe": "pixie_tpu/ops/segment.py:524",
    "join_emit_pairs": "pixie_tpu/ops/segment.py:531",
    "join_gather": "pixie_tpu/parallel/pipeline.py:3318",
    "join_agg_fold": "pixie_tpu/parallel/pipeline.py:2664",
    "scalar_eval": "pixie_tpu/exec/expression_evaluator.py:219",
    "codec_rle_decode": "pixie_tpu/ops/codec.py:383",
    "codec_delta_decode": "pixie_tpu/ops/codec.py:398",
    "hll_cell_update": "pixie_tpu/ops/hll.py:82",
    "countmin_cell_update": "pixie_tpu/ops/countmin.py:82",
    "pred_slot_masks": "pixie_tpu/parallel/pipeline.py:5541",
    "batched_segment_sums": "pixie_tpu/parallel/pipeline.py:5598",
    "ring_convert": "pixie_tpu/ops/codec.py:479",
    "reservoir_priority": "pixie_tpu/ops/ml.py:37",
    "reservoir_topk": "pixie_tpu/ops/ml.py:47",
    "reservoir_topk_rows": "pixie_tpu/ops/ml.py:47",
    "kmeans_fit": "pixie_tpu/ops/ml.py:128",
    "encoder_forward": "pixie_tpu/ops/transformer.py:76",
    "merge_states": "pixie_tpu/parallel/pipeline.py:5605",
    "countmin_query": "pixie_tpu/ops/countmin.py:114",
    "hash_columns": "pixie_tpu/ops/hashing.py:48",
    "clz64": "pixie_tpu/ops/hashing.py:56",
    "tdigest_update": "pixie_tpu/ops/tdigest.py:56",
}
# The kernels no path of the port calls: H30-H32, whose TPU kernels no path
# of either package calls, and the hash kernel, whose hashing H5, H6, H20
# and H21 do in registers. Their launch count on the main paths is 0 by
# design; their kernel phases hold and time them. (H7a and H7b, the
# t-digest update of more than 254 groups, run on sketches_windowed's 512
# (window, service) slots.)
UNCALLED = ("hash32", "countmin_query", "hash_columns", "clz64")
SOURCES = {
    **{k: "pixie_tpu_torch/ops/kernels/hopper_kernels.cu" for k in list(REPLACES)[:4]},
    **{k: "pixie_tpu_torch/ops/kernels/sketch_kernels.cu" for k in list(REPLACES)[4:12]},
    "segment_minmax": "pixie_tpu_torch/ops/kernels/minmax_kernels.cu",
    "scan_compact": "pixie_tpu_torch/ops/kernels/scan_kernels.cu",
    **{k: "pixie_tpu_torch/ops/kernels/join_kernels.cu"
       for k in ("join_probe", "join_emit_pairs", "join_gather")},
    "join_agg_fold": "pixie_tpu_torch/ops/kernels/join_agg_kernels.cu",
    "scalar_eval": "pixie_tpu_torch/ops/kernels/scalar_kernels.cu",
    **{k: "pixie_tpu_torch/ops/kernels/codec_kernels.cu"
       for k in ("codec_rle_decode", "codec_delta_decode")},
    **{k: "pixie_tpu_torch/ops/kernels/cell_kernels.cu"
       for k in ("hll_cell_update", "countmin_cell_update")},
    **{k: "pixie_tpu_torch/ops/kernels/batch_kernels.cu"
       for k in ("pred_slot_masks", "batched_segment_sums")},
    "ring_convert": "pixie_tpu_torch/ops/kernels/convert_kernels.cu",
    **{k: "pixie_tpu_torch/ops/kernels/ml_kernels.cu"
       for k in ("reservoir_priority", "reservoir_topk", "reservoir_topk_rows", "kmeans_fit")},
    "encoder_forward": "pixie_tpu_torch/ops/kernels/transformer_kernels.cu",
    "merge_states": "pixie_tpu_torch/ops/kernels/merge_kernels.cu",
    "countmin_query": "pixie_tpu_torch/ops/kernels/sketch_kernels.cu",
    **{k: "pixie_tpu_torch/ops/kernels/hash_kernels.cu" for k in ("hash_columns", "clz64")},
    "tdigest_update": "pixie_tpu_torch/ops/kernels/tdigest_kernels.cu",
}
N_PODS = 64
FLOW_ROWS = 64_000_000  # conn_flows rows: bench.py's BENCH_SMALL_ROWS default
SMALL_ROWS = 64_000_000  # http_small and stacks rows: the same default
N_STACKS = 4096
JOIN_ROWS = 4_000_000  # join_fact rows: bench.py's BENCH_JOIN_ROWS default
SERVICES = [f"ns/svc-{i}" for i in range(N_SERVICES)]
UNOWNED = (3, 11)  # the services svc_owners_partial does not own
SCAN_LIMIT = 1000
FLOW_GROUPS = N_PODS * N_PODS
STATUSES = (200, 301, 404, 500)
F4_EPS = 1e-4  # the Fault-4 contract (PERF.md)
# The windowed paths: http_events cut into WINDOWS end-of-window windows, so
# the fold's (window, service) slots number WINDOWS x N_SERVICES. The cursor
# reads a table in batches of at most READ_ROWS rows (the table's
# DEFAULT_COMPACTED_ROWS), and every batch read from a written batch carries
# that batch's eow: the table is written in READ_ROWS-row batches, eow on
# each window's last.
WINDOWS = 32
WINDOW_SLOTS = WINDOWS * N_SERVICES
READ_ROWS = 1 << 17
QS = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99)
SERVICE_STATS = (
    "df = px.DataFrame(table='http_events')\n"
    "df.failure = df.resp_status >= 400\n"
    "stats = df.groupby(['service']).agg(\n"
    "    throughput=('time_', px.count),\n"
    "    error_rate=('failure', px.mean),\n"
    "    latency=('latency', px.quantiles),\n"
    ")\n"
    "px.display(stats, 'service_stats')\n"
)
# BASELINE config 5 (bench.py:701-707) and config 3 (bench.py:966-973).
SKETCHES = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.quantiles_tdigest),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'sketches')\n"
)
FLOWS = (
    "df = px.DataFrame(table='conn_flows')\n"
    "s = df.groupby(['src', 'dst']).agg(\n"
    "    bytes_sent=('bytes_sent', px.sum),\n"
    "    bytes_recv=('bytes_recv', px.sum),\n"
    "    ports=('remote_port', px.approx_count_distinct),\n"
    ")\n"
    "px.display(s, 'flows')\n"
)
# BASELINE config 1 (bench.py:856-863), config 4 (bench.py:769-776) and the
# per-pair aggregate of px/net_flow_graph (net_flow_graph.pxl:46-51) keyed by
# conn_flows' (src, dst) as config 3 keys it.
HTTP_DATA = (
    "df = px.DataFrame(table='http_small')\n"
    "df = df[df.resp_status >= 400]\n"
    "df.latency_ms = df.latency / 1000000.0\n"
    "df = df[['time_', 'service', 'latency_ms']]\n"
    f"df = df.head({SCAN_LIMIT})\n"
    "px.display(df, 'out')\n"
)
# The ring paths: bench.py's config 1 and config 5's sketches over the
# http_small table built with resident ingest on, as bench.py builds it by
# default (BENCH_RESIDENT=1, bench.py:790-846).
HTTP_DATA_RING = HTTP_DATA.replace("'http_small'", "'http_small_ring'")
SKETCHES_RING = SKETCHES.replace("'http_events'", "'http_small_ring'")
SKETCH_KERNELS = ("segment_rows_sum_i64", "countmin_cell_update", "tdigest_update",
                  "tdigest_merge", "tdigest_quantiles")
RING_WINDOWS = SMALL_ROWS // (1 << 21)  # 30 full 2^21-row windows of 64M rows
RING_BYTES = RING_WINDOWS * (1 << 21) * (8 + 4 + 8 + 8)  # time_, service, status, latency
BOUNDED_ROWS = 5_000_000  # the time-bounded query's rows
FLAMEGRAPH = (
    "df = px.DataFrame(table='stacks')\n"
    "s = df.groupby(['stack_trace_id']).agg(\n"
    "    stack_trace=('stack_trace', px.any),\n"
    "    count=('count', px.sum),\n"
    ")\n"
    "px.display(s, 'merged')\n"
)
# With a predicate, any() folds on the device (H11) instead of its host lane.
FLAMEGRAPH_FILTERED = FLAMEGRAPH.replace(
    "df = px.DataFrame(table='stacks')\n",
    "df = px.DataFrame(table='stacks')\ndf = df[df.count > 50]\n",
)
FLOW_SPAN = (
    "df = px.DataFrame(table='conn_flows')\n"
    "s = df.groupby(['src', 'dst']).agg(\n"
    "    bytes_sent_min=('bytes_sent', px.min),\n"
    "    bytes_sent_max=('bytes_sent', px.max),\n"
    "    bytes_recv_min=('bytes_recv', px.min),\n"
    "    bytes_recv_max=('bytes_recv', px.max),\n"
    ")\n"
    "px.display(s, 'flow_span')\n"
)
# The time window of px/net_flow_graph (net_flow_graph.pxl:38-41) over
# conn_flows, without the script's df.ctx['pod'] filter (metadata is not
# ported): time_ is monotone, so it ships as nibble deltas (H19), then H11.
FLOW_WINDOW = (
    "df = px.DataFrame(table='conn_flows')\n"
    "s = df.agg(time_min=('time_', px.min), time_max=('time_', px.max))\n"
    "px.display(s, 'window')\n"
)
# Status variety per service over http_events: resp_status (INT64, four
# values) stages as int-dictionary codes and both sketches fold per cell
# (H20, H21).
STATUS_MIX = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    kinds=('resp_status', px.approx_count_distinct),\n"
    "    freq=('resp_status', px.count_min),\n"
    ")\n"
    "px.display(s, 'status_mix')\n"
)
# A group-by over http_events sorted by (service, status): the host gid lane
# and the status column are run-heavy and ship as RLE (H18), the shape of
# the reference's tests/test_codec.py:806.
SORTED_KEYS = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service', 'resp_status']).agg(\n"
    "    n=('time_', px.count),\n"
    "    lat=('latency', px.sum),\n"
    "    lat_max=('latency', px.max),\n"
    "    st=('resp_status', px.sum),\n"
    ")\n"
    "px.display(s, 'sorted')\n"
)
SORTED_ROWS = 1 << 20


def soak_query(pred, names) -> str:
    """One query of the serving soak's compatible set (tools/soak_serving.py:
    56-83): count and sum(latency) by service under one predicate family."""
    filt = f"df = df[{pred}]\n" if pred else ""
    return ("df = px.DataFrame(table='http_events')\n" + filt
            + "st = df.groupby(['service']).agg(\n"
            f"    {names[0]}=('time_', px.count),\n"
            f"    {names[1]}=('latency', px.sum),\n"
            ")\npx.display(st, 'out')\n")


# The soak's seven predicate families (its join family left out), the first
# reading every column the others read, so its staging serves them all.
SOAK_PREDS = (
    ("df.resp_status == 200", lambda st, la: st == 200),
    ("df.resp_status == 404", lambda st, la: st == 404),
    ("df.resp_status == 500", lambda st, la: st == 500),
    ("df.resp_status != 200", lambda st, la: st != 200),
    ("df.latency > 20000000.0", lambda st, la: la > 2e7),
    ("df.resp_status in [200, 404]", lambda st, la: (st == 200) | (st == 404)),
    (None, lambda st, la: np.ones(st.shape, bool)),
)
SUM_GROUP = [(soak_query(p, names), fam) for p, fam in SOAK_PREDS
             for names in (("n", "total"), ("cnt", "s"))]
SKETCH_THRESHOLDS = (1e7, 2e7, 4e7)
SKETCH_GROUP = [
    "df = px.DataFrame(table='http_events')\n"
    f"df = df[df.latency > {thr!r}]\n"
    "st = df.groupby(['service']).agg(\n"
    "    q=('latency', px.quantiles),\n"
    "    u=('resp_status', px.approx_count_distinct),\n"
    ")\npx.display(st, 'out')\n"
    for thr in SKETCH_THRESHOLDS
]
SHARED_QUERIES = [q for q, _ in SUM_GROUP] + SKETCH_GROUP
SOAK_CLIENTS, SOAK_REQUESTS = 16, 4  # bench.py's BENCH_SOAK_REQUESTS
SOAK_WINDOW_MS = 25.0  # tools/soak_serving.py's SOAK_WINDOW_MS
JOIN_TIMEOUT_S = 600

# BASELINE config 8 (bench.py:1143-1149), and the same fact table OUTER-joined
# to svc_owners_partial (14 of the 16 services owned, 4 services the fact
# table never names).
JOIN8 = (
    "l = px.DataFrame(table='svc_owners')\n"
    "r = px.DataFrame(table='join_fact')\n"
    "j = l.merge(r, how='inner', left_on=['svc'],"
    " right_on=['service'], suffixes=['', '_r'])\n"
    "px.display(j, 'joined')\n"
)
JOIN8_OUTER = JOIN8.replace("svc_owners", "svc_owners_partial").replace(
    "how='inner'", "how='outer'")
# Joins that feed an aggregation, over the same tables. Per-team load (the
# dashboard a service owner opens): the join-aggregate lane, whose right pass
# reduces the 4M fact rows to per-service statistics.
JOIN8_TEAM_AGG = (
    "l = px.DataFrame(table='svc_owners')\n"
    "r = px.DataFrame(table='join_fact')\n"
    "j = l.merge(r, how='inner', left_on=['svc'], right_on=['service'], suffixes=['', '_r'])\n"
    "s = j.groupby(['owner']).agg(n=('latency', px.count), lat_total=('latency', px.sum),\n"
    "    lat_mean=('latency', px.mean), lat_min=('latency', px.min),\n"
    "    lat_max=('latency', px.max))\n"
    "px.display(s, 'out')\n"
)
# Per-service load weighted by on-call rows: the lane's left pass folds the 4M
# fact rows with weights 0-3 (H16).
JOIN8_ONCALL_AGG = (
    "l = px.DataFrame(table='join_fact')\n"
    "r = px.DataFrame(table='svc_oncall')\n"
    "j = l.merge(r, how='inner', left_on=['service'], right_on=['svc'], suffixes=['', '_r'])\n"
    "s = j.groupby(['service']).agg(n=('latency', px.count), lat_total=('latency', px.sum),\n"
    "    seats_total=('seats', px.sum), seats_max=('seats', px.max))\n"
    "px.display(s, 'out')\n"
)
# A LEFT join is not the lane's shape: the sort-merge lane builds the 4M
# joined rows and the host AggNode folds them on the card.
JOIN8_LEFT_AGG = (
    "l = px.DataFrame(table='join_fact')\n"
    "r = px.DataFrame(table='svc_owners_partial')\n"
    "j = l.merge(r, how='left', left_on=['service'], right_on=['svc'], suffixes=['', '_r'])\n"
    "s = j.groupby(['owner']).agg(n=('latency', px.count), lat_mean=('latency', px.mean),\n"
    "    lat_max=('latency', px.max))\n"
    "px.display(s, 'out')\n"
)
# service_stats.pxl's own functions (ROADMAP queue 1 item 1's path) over an
# http_events table with the columns they read: svc_let (Q1),
# http_code_histogram (Q2) and latency_histogram (Q3), df.ctx['service']
# read as the table's service column (metadata is ROADMAP queue 1 item 2);
# and Q4, per-endpoint load keyed by the request path with its IDs
# collapsed (the dictionary-LUT key lane), with the STRING sketches (the
# arghash lane), stddev, variance and three H17 arguments.
LET_ROWS = 1 << 25
LET_NOW = 1_700_000_000_000_000_000
LET_ROW_NS = 18_000  # 2^25 rows span ~604 s: ~61 windows of 10 s
N_RESOURCES, N_IDS, N_ADDRS = 32, 128, 1024
N_PATHS = N_RESOURCES * N_IDS  # then /healthz (2%) and /readyz (1%)
LET_SERVICES = [f"svc-{i}" for i in range(N_SERVICES)]
LET_FAMILY = (1,) + tuple(range(10, 16))  # contains(service, 'svc-1')
LET_WINDOW_NS = 10 * 1_000_000_000
LET_BIN_NS = 50 * 1_000_000
SERVICE_STATS_PXL = "pixie_tpu/scripts/px/service_stats/service_stats.pxl"
LET_CALLS = {
    "let": "px.display(svc_let('-15m', 'svc-1'), 'let')",
    "codes": "px.display(http_code_histogram('-15m', 'svc-1'), 'codes')",
    "lat_hist": "px.display(latency_histogram('-15m', 'svc-1'), 'lat_hist')",
}
ENDPOINT_LOAD = (
    "df = px.DataFrame(table='http_events', start_time='-15m')\n"
    "df.endpoint = px.regex_replace('/[0-9]+', df.req_path, '/{id}')\n"
    "df.err_bytes = px.select(df.resp_status >= 400, df.resp_body_size, 0)\n"
    "df.log_lat = px.log10(df.latency)\n"
    "df.lat_ms = px.floor(df.latency / 1000000.0)\n"
    "s = df.groupby('endpoint').agg(\n"
    "    n=('latency', px.count),\n"
    "    clients=('remote_addr', px.approx_count_distinct),\n"
    "    paths=('req_path', px.count_min),\n"
    "    sd=('latency', px.stddev),\n"
    "    var=('latency', px.variance),\n"
    "    err_bytes=('err_bytes', px.sum),\n"
    "    mlog=('log_lat', px.mean),\n"
    "    ms=('lat_ms', px.sum),\n"
    ")\n"
    "px.display(s, 'load')\n"
)


def let_queries() -> dict:
    """{output table: PxL} of Q1-Q4: the bundled script, unchanged except
    for the ctx read, with one call of its function appended."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), SERVICE_STATS_PXL)
    with open(path) as f:
        script = f.read().replace("df.ctx[k8s_object]", "df[k8s_object]")
    check("df[k8s_object]" in script, "service_stats.pxl: the ctx read was not found")
    out = {name: script + "\n" + call + "\n" for name, call in LET_CALLS.items()}
    out["load"] = ENDPOINT_LOAD
    return out


# The groups of JOIN8_LEFT_AGG in emission order: each team as its first
# matched svc_owners_partial row meets it, then the unowned services' rows
# (owner ""), as tests/test_torch_join_agg.py pins against the reference.
LEFT_AGG_OWNERS = ["team-0", "team-1", "team-3", "team-2", ""]


def partial_owners() -> list:
    """svc_owners_partial's services in row order: the 14 owned, with the
    four ghosts placed between them."""
    owned = [s for i, s in enumerate(SERVICES) if i not in UNOWNED]
    return owned[:2] + ["ghost-0"] + owned[2:6] + ["ghost-1"] + owned[6:] + ["ghost-2", "ghost-3"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIME_REPS, warmup: int = TIME_WARMUP,
            behind_sleep: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card over ``reps`` calls, from
    CUDA events recorded between consecutive calls. With ``behind_sleep`` a
    sleep kernel queued first keeps the device busy while the host enqueues
    every call, so each interval is the device's time for one call and not
    the host's launch overhead (a call that synchronises internally still
    pays its host time). Without it the host paces the calls, and each
    interval is the larger of the host's cost per call and the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    if behind_sleep:
        torch.cuda._sleep(50_000_000)  # ~25 ms at 1.98 GHz
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([events[i].elapsed_time(events[i + 1]) for i in range(reps)]))


def fresh(make, calls: int = 2 * (TIME_REPS + TIME_WARMUP)):
    """One new state from ``make()`` for each of ``record``'s ``calls`` timed
    calls of a kernel (made ahead, so no reset is timed); a further call
    raises IndexError."""
    pool = [make() for _ in range(calls)]
    return pool.pop


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_phases_us(probe: torch.Tensor, names: tuple, first: int, khz: int) -> dict:
    """Microseconds between a kernel probe's consecutive clock64 stamps
    (CTA 0's, from index ``first``), at the SM clock's rate ``khz``."""
    p = probe.cpu().tolist()
    return {nm: (p[first + k + 1] - p[first + k]) * 1e3 / khz for k, nm in enumerate(names)}


# ---------------------------------------------------------------- kernels
def record(fn, plain, library, bound_ms, bound_by, max_abs_err, shape) -> dict:
    return dict(
        max_abs_err=max_abs_err,
        ms=time_ms(fn),
        host_paced_ms=time_ms(fn, behind_sleep=False),
        plain_ms=time_ms(plain),
        library_ms=time_ms(library) if library is not None else None,
        bound_ms=bound_ms, bound_by=bound_by, shape=shape,
    )


def row_bins(kernels, histogram, values, log_gamma) -> torch.Tensor:
    """H3's bin of each value, read back by giving every value a group of
    its own (S = n; S <= 48 takes the shared-memory path, larger S the
    global one)."""
    n = values.shape[0]
    gids = torch.arange(n, dtype=torch.int32, device=values.device)
    spec = histogram.DEFAULT_SPEC
    state = kernels.log_histogram_update(
        values, gids, None, histogram.init(n, values.device), spec.min_value, log_gamma
    )
    check(bool(torch.all(state.sum(dim=1) == 1)), "H3 per-row state: one count per row")
    return state.argmax(dim=1)


def h1_cases(rng, n: int, dev) -> list:
    """(name, [(tensor or None, offset)], S) of H1's timed shapes."""
    big = lambda: torch.from_numpy(
        rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)).to(dev)
    sent = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)).to(dev)
    recv = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)).to(dev)
    return [
        ("service_stats count", [(None, 0)], N_SERVICES),
        ("service_stats mean count", [], N_SERVICES),
        ("int64 row", [(big(), 0)], N_SERVICES),
        ("flows", [(sent, 1 << 10), (recv, 3 << 20)], FLOW_GROUPS),
        ("cell lane", [], N_SERVICES * len(STATUSES)),
        ("S=32768", [(big(), 0), (big(), 0)], 32768),
    ]


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view one element into a larger buffer: its pointer
    misses every vector alignment above one element."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def h2_rows(rng, n: int, dev, skew: bool = False) -> list:
    """(tensor, offset, square) rows of every kind H2 reads: f64 (one with
    NaN and +-inf), bool, uint8, uint16, int32 with an offset near INT64_MAX
    (v + off wraps), int64; values and squares. With ``skew`` the tensors
    lie one element into a buffer (no vector loads)."""
    put = (lambda a: unaligned(torch.from_numpy(a).to(dev))) if skew else \
        (lambda a: torch.from_numpy(a).to(dev))
    f = rng.exponential(3e7, n)
    for x in (np.nan, np.inf, -np.inf):
        f[rng.random(n) < 1e-4] = x
    return [
        (put(rng.normal(0.0, 1e6, n)), 0, False),
        (put(rng.random(n) < 0.15), 0, False),
        (put(rng.integers(0, 256, n).astype(np.uint8)), 7, True),
        (put(rng.integers(0, 65536, n).astype(np.uint16)), -70_000, False),
        (put(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)), (1 << 63) - 5, False),
        (put(rng.integers(-(2**40), 2**40, n, dtype=np.int64)), 0, True),
        (put(f), 0, False),
        (put(f), 0, True),
    ]


def h2_plain_rows(segment, rows: list) -> list:
    return [segment.F64Row(segment.Narrow(t, off) if off else t, sq) for t, off, sq in rows]


def h2_check(segment, got, rows: list, g, m, S: int, what: str) -> float:
    """H2's contract against its plain version: each finite sum within
    1e-12 * sum |v| of the group (integer rows whose sums stay below 2^53
    exactly), NaN and +-inf where the plain version has them. Returns the
    largest |error| of a finite sum."""
    plain = h2_plain_rows(segment, rows)
    want = segment.segment_rows_sum_f64_plain(plain, g, S, m)
    check(got.shape == want.shape, f"H2 {what}: shape {tuple(got.shape)}")
    worst = 0.0
    for r, row in enumerate(plain):
        x = segment._f64_row_values(row)
        abs_sum = segment.segment_sum_f64_plain(
            torch.where(torch.isfinite(x), x, 0.0).abs(), g, m, S)
        gr, w = got[r], want[r]
        fin = torch.isfinite(w)
        err = (gr[fin] - w[fin]).abs()
        check(torch.equal(torch.isnan(gr), torch.isnan(w))
              and torch.equal(gr[torch.isinf(w)], w[torch.isinf(w)]),
              f"H2 {what} row {r}: non-finite sums differ")
        check(bool(torch.all(err <= 1e-12 * abs_sum[fin])),
              f"H2 {what} row {r}: beyond 1e-12 * sum|v|")
        if rows[r][0].dtype != torch.float64 and bool(torch.all(abs_sum < 2.0**53)) \
                and bool(torch.all(x == torch.round(x))):
            check(torch.equal(gr, w), f"H2 {what} row {r}: an integer row not exact")
        worst = max(worst, err.max().item() if err.numel() else 0.0)
    return worst


def h2_phase(kernels, segment, dev, rng, n: int, mask_np, records: dict) -> None:
    """H2 against its plain version: every row kind and both ops, R = 1 to 8
    rows a call, in each lane (S = 16 and 64 private cells or the warp
    lane by the rows, 4096 shared partials, 32768 global atomics), n - 3
    rows (off the 8-row vectors), rows aligned and one element into a
    buffer, masked and out-of-range gids, NaN and +-inf; the private and
    warp lanes twice, bit for bit. Timed at the main
    paths' shapes: one f64 row at S = 16 (the table's shape), endpoint_load's
    block (latency, its squares and log_lat at its fold's capacity 64, 34
    endpoints used), config 10's f64 sum at S = 64, and S = 4096 and 32768,
    beside index_add_ over the valid rows' values (squared beforehand)."""
    optin = kernels.smem_optin_bytes(dev)
    m_full = torch.from_numpy(mask_np).to(dev)
    worst = 0.0
    for skew in (False, True):
        nn = n - 3
        rows = h2_rows(rng, nn, dev, skew)
        m = unaligned(m_full[:nn]) if skew else m_full[:nn]
        for S in (16, 64, 4096, 32768):
            g = torch.from_numpy(rng.integers(-1, S + 1, nn).astype(np.int32)).to(dev)
            if skew:
                g = unaligned(g)
            for idx in ([0], [6, 7], [1, 2, 3], [0, 2, 4, 5], [0, 1, 2, 3, 4], list(range(7)),
                        list(range(8))):
                sub = [rows[i] for i in idx]
                lane = kernels.h2_lane(len(sub), S, optin)[0]
                what = f"S={S} rows {idx} lane={lane}{' unaligned' if skew else ''}"
                got = kernels.segment_rows_sum_f64(sub, g, m, S)
                worst = max(worst, h2_check(segment, got, sub, g, m, S, what))
                if lane in ("private", "warps"):
                    again = kernels.segment_rows_sum_f64(sub, g, m, S)
                    torch.cuda.synchronize()
                    check(bits_equal(got, again), f"H2 {what}: two runs differ")
            log(f"H2 segment_rows_sum_f64 S={S}{' unaligned' if skew else ''}: every row "
                f"kind and op, R = 1 to 8, within 1e-12 * sum|v| (integer rows exact), "
                f"non-finite as plain; the private and warp lanes bit for bit twice")
    log(f"H2 edges: largest |error| of a finite sum {worst:.3g} (rows up to 2^62 in "
        f"magnitude, squares to 2^80: each within 1e-12 * sum|v| of its group)")
    lat = torch.from_numpy(rng.exponential(3e7, n)).to(dev)
    log_lat = torch.log10(lat)
    cases = [
        ("f64 row", [(lat, 0, False)], 16, 16),
        ("endpoint_load", [(lat, 0, False), (lat, 0, True), (log_lat, 0, False)], 64, 34),
        ("config10 sum", [(lat, 0, False)], 64, 64),
        ("S=4096", [(lat, 0, False)], 4096, 4096),
        ("S=32768", [(lat, 0, False)], 32768, 32768),
    ]
    for name, rows, S, used in cases:
        g = torch.from_numpy(rng.integers(0, used, n).astype(np.int32)).to(dev)
        m = m_full
        got = kernels.segment_rows_sum_f64(rows, g, m, S)
        err = h2_check(segment, got, rows, g, m, S, name)
        plain = h2_plain_rows(segment, rows)
        ok = m & (g >= 0) & (g < S)
        idx = g[ok].long()
        vals = torch.stack([segment._f64_row_values(r)[ok] for r in plain])
        lib_out = torch.zeros((len(rows), S), dtype=torch.float64, device=dev)
        R = len(rows)
        cols = {t.data_ptr(): t for t, _, _ in rows}  # each column read once
        rec = record(
            lambda: kernels.segment_rows_sum_f64(rows, g, m, S),
            lambda: segment.segment_rows_sum_f64_plain(plain, g, S, m),
            lambda: lib_out.index_add_(1, idx, vals),
            *bound(sum(t.element_size() * n for t in cols.values()) + n * 4 + n + R * S * 8,
                   n * (R + sum(sq for *_, sq in rows))),
            err, f"{name}: rows {R} (squares {sum(sq for *_, sq in rows)}) n={n} "
            f"S={S} ({used} used) lane={kernels.h2_lane(R, S, optin)[0]}",
        )
        log(f"H2 segment_rows_sum_f64 {rec['shape']}: {rec['ms']:.5f} ms [bound "
            f"{rec['bound_ms']:.5f}; plain {rec['plain_ms']:.5f}; index_add_ "
            f"{rec['library_ms']:.5f}; host-paced {rec['host_paced_ms']:.5f}]")
        records.setdefault("segment_rows_sum_f64", dict(rec, by_shape={}))
        records["segment_rows_sum_f64"]["by_shape"][name] = {
            k: rec[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms", "host_paced_ms",
                                "shape")}


def kernel_phases(kernels, segment, histogram, dev) -> dict:
    """Every kernel against its plain version on the card; returns per-kernel
    records for the main-path shape (the first case of each kernel)."""
    rng = np.random.default_rng(0)
    n = BLOCK_ROWS
    mask_np = rng.random(n) < 0.97
    records: dict = {}

    def inputs(S):
        g = rng.integers(-1, S + 1, n).astype(np.int32)  # a few out of range
        return torch.from_numpy(g).to(dev), torch.from_numpy(mask_np).to(dev)

    # H1 at the main paths' shapes, each exact against its plain version
    # (the rows widened, then summed) and timed beside index_add_ over the
    # valid rows' widened values and count. service_stats: count's row is
    # the presence row (R = 1), mean's count has none (R = 0), S = 16 (the
    # register lane); R = 1 with an int64 row at S = 16 (the earlier table
    # shape); flows: bytes_sent and bytes_recv as staged, int32 with their
    # offsets, S = 4096 (the cluster lane); status_mix's cell-lane
    # histogram, S = 16 groups x 4 codes (R = 0); S = 32768 with two int64
    # rows. The first is the table's shape.
    for name, specs, S in h1_cases(rng, n, dev):
        g, m = inputs(S)
        got = kernels.segment_rows_sum_i64(specs, g, m, S)
        rows = [segment.PRESENCE if t is None else segment.Narrow(t, off) for t, off in specs]
        want = segment.fused_segment_sums_plain(rows, g, S, m)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H1 {name} differs from its plain version")
        value_rows = [t for t, _ in specs if t is not None]
        lane = kernels.h1_lane(len(value_rows), S, kernels.smem_optin_bytes(dev))
        ok = m & (g >= 0) & (g < S)
        idx = g[ok].long()
        lib_vals = torch.stack([segment.widen(r)[ok].long() if r is not None
                                else torch.ones_like(idx) for r in rows + [None]])
        lib_out = torch.zeros((len(rows) + 1, S), dtype=torch.int64, device=dev)
        nbytes = sum(t.element_size() * n for t in value_rows) + n * 4 + n + (len(rows) + 1) * S * 8
        rec = record(
            lambda: kernels.segment_rows_sum_i64(specs, g, m, S),
            lambda: segment.fused_segment_sums_plain(rows, g, S, m),
            lambda: lib_out.index_add_(1, idx, lib_vals),
            *bound(nbytes, (len(value_rows) + 1) * n), 0.0,
            f"{name}: rows {[str(t.dtype) if t is not None else 'presence' for t, _ in specs]} "
            f"n={n} S={S} lane={lane}",
        )
        log(f"H1 segment_rows_sum_i64 {rec['shape']}: exact; {rec['ms']:.5f} ms "
            f"[bound {rec['bound_ms']:.5f}; plain {rec['plain_ms']:.5f}; index_add_ "
            f"{rec['library_ms']:.5f}]")
        records.setdefault("segment_rows_sum_i64", dict(rec, by_shape={}))
        records["segment_rows_sum_i64"]["by_shape"][name] = {
            k: rec[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms", "shape")}

    h2_phase(kernels, segment, dev, rng, n, mask_np, records)

    # H3 in each lane (kernels.h3_lane: S = 16 and 64 the cluster lane, S =
    # 600 global atomics), 2^21 + 3 rows (off the
    # 8-row vectors), f32 values and f64 (as the shared scan's sketch group
    # hands them over, rounded in registers), masked rows and gids out of
    # range, under the Fault-1 contract: CUDA's logf and the plain version's
    # correctly rounded log may put a value lying within 2.5e-4 of a bin
    # edge one bin over; every other value lands in the same bin; totals
    # exact. Each lane's global atomics (the probe) are logged. Timed at
    # service_stats' shape (S = 16, f32, 2^21 rows: the table's shape) and
    # at S = 64 and 600, each beside an empty kernel on the same grid.
    spec = histogram.DEFAULT_SPEC
    log_gamma = math.log(spec.gamma)
    optin = kernels.smem_optin_bytes(dev)
    n3 = n + 3
    lat3 = rng.exponential(3e7, n3)
    x = np.log(np.maximum(lat3.astype(np.float32), spec.min_value) / spec.min_value) / log_gamma
    edge3 = torch.from_numpy(np.abs(x - np.round(x)) <= 2.5e-4).to(dev)
    m3 = torch.from_numpy(rng.random(n3) < 0.97).to(dev)
    h3_worst = 0
    for S in (N_SERVICES, 64, 600):
        g = torch.from_numpy(rng.integers(-1, S + 1, n3).astype(np.int32)).to(dev)
        lane = kernels.h3_lane(S, spec.nbins, optin)[0]
        for dtype in (torch.float32, torch.float64):
            vals = torch.from_numpy(lat3).to(dev).to(dtype)
            probe = torch.zeros(kernels.H3_PROBE, dtype=torch.int64, device=dev)
            got = kernels.log_histogram_update(vals, g, m3, histogram.init(S, dev),
                                               spec.min_value, log_gamma, probe=probe)
            want = histogram.update_plain(histogram.init(S, dev), g, vals, m3)
            off_edge = m3 & ~edge3
            got_off = kernels.log_histogram_update(vals, g, off_edge, histogram.init(S, dev),
                                                   spec.min_value, log_gamma)
            want_off = histogram.update_plain(histogram.init(S, dev), g, vals, off_edge)
            valid = m3 & (g >= 0) & (g < S)
            near = (edge3 & valid).sum().item()
            cell_err = (got - want).abs()
            torch.cuda.synchronize()
            what = f"H3 S={S} lane={lane} {dtype}"
            check(torch.equal(got_off, want_off), f"{what}: rows off bin edges differ")
            check(cell_err.sum().item() <= 2 * near, f"{what}: cell diffs beyond the contract")
            check(int(got.sum()) == int(want.sum()), f"{what}: total count differs")
            atomics = int(probe[0])
            check(atomics == int(valid.sum()) if lane == "global"
                  else 0 < atomics < int(valid.sum()) // 4, f"{what}: {atomics} global atomics")
            h3_worst = max(h3_worst, cell_err.max().item())
            log(f"{what}: exact off bin edges; {cell_err.sum().item()} cell diffs from "
                f"{near} rows at bin edges; {atomics} global atomics for {int(valid.sum())} "
                f"valid rows")
    # 2^23 + 5 rows into one cell in the cluster lane (S = 16 and 64): a CTA
    # counts up to 57,344 of them into one u16 count, over more than one
    # wave of clusters; the count exact.
    n1 = (1 << 23) + 5
    one = torch.full((n1,), 3e7, dtype=torch.float32, device=dev)
    for S in (N_SERVICES, 64):
        g1 = torch.full((n1,), S - 1, dtype=torch.int32, device=dev)
        got = kernels.log_histogram_update(one, g1, None, histogram.init(S, dev),
                                           spec.min_value, log_gamma)
        want = histogram.update_plain(histogram.init(S, dev), g1, one, None)
        check(torch.equal(got, want) and int(got.sum()) == n1,
              f"H3 S={S}: {n1} rows into one cell miscounted")
        log(f"H3 S={S}: {n1} rows into one cell exact over "
            f"{kernels.h3_geometry(dev, n1, S, spec.nbins)[0]} CTAs")
    del one, g1
    lat = torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)).to(dev)
    x = torch.log(lat.double() / spec.min_value) / log_gamma
    edge = (x - torch.round(x)).abs() <= 2.5e-4
    for S in (N_SERVICES, 64, 600):
        g, m = inputs(S)
        ok = m & (g >= 0) & (g < S)
        flat = g[ok].long() * spec.nbins + histogram.bin_index(lat[ok]).long()
        state = histogram.init(S, dev)
        probe = torch.zeros(kernels.H3_PROBE, dtype=torch.int64, device=dev)
        for _ in range(3):
            probe.zero_()
            kernels.log_histogram_update(lat, g, m, state, spec.min_value, log_gamma, probe=probe)
        torch.cuda.synchronize()
        grid, threads, smem = kernels.h3_geometry(dev, n, S, spec.nbins)
        rec = record(
            lambda: kernels.log_histogram_update(lat, g, m, state, spec.min_value, log_gamma),
            lambda: histogram.update_plain(state, g, lat, m),
            lambda: torch.bincount(flat, minlength=S * spec.nbins),
            *bound(n * 4 + n * 4 + n + 2 * S * spec.nbins * 8, 8 * n),
            h3_worst, f"values[{n}] state[{S},{spec.nbins}] "
            f"lane={kernels.h3_lane(S, spec.nbins, optin)[0]}",
        )
        rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, grid, threads, smem))
        rec["b_flush_atomics"] = int(probe[0])
        rec["b_phases_us"] = probe_phases_us(probe, ("zero", "rows", "flush"), 2,
                                             kernels.sm_clock_khz(dev))
        log(f"H3 log_histogram_update {rec['shape']}: {rec['ms']:.5f} ms [bound "
            f"{rec['bound_ms']:.5f}; floor {rec['floor_ms']:.5f}; plain {rec['plain_ms']:.5f}; "
            f"bincount {rec['library_ms']:.5f}]; CTA 0's phases us {json.dumps(rec['b_phases_us'])}; "
            f"{rec['b_flush_atomics']} global atomics")
        if S == N_SERVICES:
            records["log_histogram_update"] = dict(rec, by_lane={})
        else:
            records["log_histogram_update"]["by_lane"][f"S={S}"] = {
                k: rec[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms", "floor_ms",
                                    "b_flush_atomics", "b_phases_us", "shape")}
    # Each bin-edge row's own bin (global path) is the plain one or next to
    # it; values at and below min (bin 0), past max (the clip), +-inf and
    # NaN (shared path) land exactly where the plain version puts them.
    edge_vals = lat[edge]
    moved = (row_bins(kernels, histogram, edge_vals, log_gamma)
             - histogram.bin_index(edge_vals).long()).abs()
    f32 = np.finfo(np.float32)
    special = torch.tensor(
        [0.0, -5.0, f32.smallest_subnormal, 0.5, 1.0, np.nextafter(np.float32(1), np.float32(2)),
         2.0, 1e6, 1e13, 3e38, f32.max, np.inf, -np.inf, np.nan],
        dtype=torch.float32, device=dev,
    )
    special_bins = row_bins(kernels, histogram, special, log_gamma)
    torch.cuda.synchronize()
    check(bool(torch.all(moved <= 1)), "H3: a bin-edge row moved by more than one bin")
    check(torch.equal(special_bins, histogram.bin_index(special).long()),
          f"H3 special values: {special_bins.tolist()}")
    log(f"H3 per-row bins: {int((moved == 1).sum())} of {edge_vals.numel()} bin-edge "
        f"rows one bin over; special values {special_bins.tolist()} as plain")

    # H4 bit for bit with its plain version on the card (its values come
    # from the plain version's own midpoint table): at the paths' group
    # counts (H4_GROUPS, from --log-shapes) and 4096, then the edge groups
    # (empty, all in bin 0, one bin, one count in the last bin, counts near
    # 2^40, ones, a sparse row) at every width of HIST_NBINS, for 7 qs and 40.
    from pixie_tpu_torch.ops.quantile_edges import HIST_NBINS, QS_WIDE, hist_edge_state

    qs = QS
    qs_t = torch.tensor(qs, dtype=torch.float64, device=dev)
    mid = histogram.midpoint_table(spec, dev)
    Q = len(qs)
    for S in H4_GROUPS:
        state = torch.from_numpy(hist_edge_state(spec.nbins, S, seed=S)).to(dev)
        got = kernels.hist_quantiles(state, qs_t, mid)
        want = histogram.quantile_values_plain(state, qs)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H4 S={S}: {int((got != want).sum())} values differ")
        if S != N_SERVICES:
            continue
        rec = record(
            lambda: kernels.hist_quantiles(state, qs_t, mid),
            lambda: histogram.quantile_values_plain(state, qs),
            None,
            # the function's own bytes: the counts and the qs read once, the
            # output written once (the midpoint table is the kernel's design)
            *bound(S * spec.nbins * 8 + Q * 8 + S * Q * 8,
                   2 * S * spec.nbins * Q),
            (got - want).abs().max().item(), f"state[{S},{spec.nbins}] Q={Q}",
        )
        rec["floor_ms"] = time_ms(
            lambda: kernels.empty_launch(dev, *kernels.hist_quantiles_geometry(S)))
        records["hist_quantiles"] = rec
    for nbins in HIST_NBINS:
        espec = histogram.LogHistogramSpec(nbins=nbins)
        state = torch.from_numpy(hist_edge_state(nbins, N_SERVICES, seed=nbins)).to(dev)
        for eqs in (qs, QS_WIDE):
            got = kernels.hist_quantiles(
                state, torch.tensor(eqs, dtype=torch.float64, device=dev),
                histogram.midpoint_table(espec, dev))
            want = histogram.quantile_values_plain(state, eqs, espec)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"H4 edges nbins={nbins} Q={len(eqs)}: {int((got != want).sum())} values differ")
    rec = records["hist_quantiles"]
    log(f"H4 hist_quantiles: bit for bit at S {H4_GROUPS} and the edge groups at nbins "
        f"{list(HIST_NBINS)}, Q 7 and {len(QS_WIDE)}; {rec['shape']} {rec['ms']:.5f} ms "
        f"[bound {rec['bound_ms']:.5f}; floor {rec['floor_ms']:.5f}; plain {rec['plain_ms']:.5f}]")
    return records


SEQ_BLOCKS = 32  # a flows query's blocks: 64M rows in 2^21-row blocks


def hll_sequence(kernels, hll, dev, mask, reps: int = 5) -> float:
    """H5 over a flows query's sequence of SEQ_BLOCKS blocks (fresh ports
    and pairs each, uint16 with offset 1024, 4096 groups) into one state
    from zero, a 96 MB pass between launches evicting the L2 as the fold's
    elementwise passes between two H5 launches do: the final registers
    exact against the plain version; the median over ``reps`` sequences
    of H5's mean device time a launch (events around each launch, all
    queued behind a sleep kernel)."""
    rng = np.random.default_rng(11)
    G, n = FLOW_GROUPS, BLOCK_ROWS
    blocks = [(torch.from_numpy(rng.integers(0, 65535 - 1024, n).astype(np.uint16)).to(dev),
               torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev))
              for _ in range(SEQ_BLOCKS)]
    scrub = torch.zeros(24 << 20, dtype=torch.int32, device=dev)
    want, got = hll.init(G, dev), hll.init(G, dev)
    for p16, g in blocks:
        want = hll.update_plain(want, g, p16.long() + 1024, mask)
        kernels.hll_update(p16, g, mask, got, 1024)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "H5 flows sequence differs from the plain version")
    times = []
    for _ in range(reps):
        state = hll.init(G, dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        marks = []
        for p16, g in blocks:
            scrub.add_(1)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            kernels.hll_update(p16, g, mask, state, 1024)
            b.record()
            marks.append((a, b))
        torch.cuda.synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in marks) / SEQ_BLOCKS)
    ms = float(np.median(times))
    log(f"H5 hll_update flows sequence ({SEQ_BLOCKS} blocks, G={G}, lane="
        f"{kernels.hll_lane(G, hll.DEFAULT_PRECISION, kernels.smem_optin_bytes(dev))}, "
        f"the L2 evicted between launches): exact; {ms:.5f} ms a launch")
    return ms


def sketch_kernel_phases(dev) -> dict:
    """The sketch kernels against their plain versions on the card, at the
    main paths' shapes (2^21-row blocks; 16 groups, and 4096 for H5 and
    H10 as config 3 runs them); returns their records."""
    from pixie_tpu_torch.ops import countmin, hashing, hll, kernels, segment, tdigest

    M32 = hashing.M32
    rng = np.random.default_rng(1)
    n = BLOCK_ROWS
    records: dict = {}
    mask = torch.from_numpy(rng.random(n) < 0.97).to(dev)

    # The hash kernel, bit for bit: config 5's widened resp_status words
    # (seed 1, pair, as count-min runs it) and edge words.
    status = torch.from_numpy(
        np.array(STATUSES, np.int64)[rng.choice(4, n, p=[0.85, 0.05, 0.05, 0.05])]
    ).to(dev)
    edge_words = np.concatenate([
        np.array([0, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1024, 65534], np.int64),
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324], np.float64).view(np.int64),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 16, dtype=np.int64),
    ])
    words = torch.from_numpy(edge_words).to(dev)
    for seed in (0, 1):
        a, b = hashing.hash32_pair_plain(words, seed)
        pair = kernels.hash32(words, seed, pair=True).to(torch.int64) & M32
        one = kernels.hash32(words, seed, pair=False).to(torch.int64) & M32
        torch.cuda.synchronize()
        check(torch.equal(pair[0], a) and torch.equal(pair[1], b), f"hash32_pair seed {seed}")
        check(torch.equal(one[0], hashing.hash32_plain(words, seed)), f"hash32 seed {seed}")
    log(f"hash32: bit for bit on {words.numel()} edge and random words, seeds 0 and 1, "
        "single and pair")
    records["hash32"] = record(
        lambda: kernels.hash32(status, 1, pair=True),
        lambda: hashing.hash32_pair_plain(status, 1),
        None,
        *bound(n * 8 + 2 * n * 4, 2 * 24 * n), 0.0, f"words[{n}] pair seed 1",
    )

    # H5 on flows' remote_port as staged (uint16, offset 1024): G = 16
    # (shared registers) and 4096 (config 3) exact against the plain
    # version over the widened ports; timed at 4096 on zeroed registers, as
    # a query's first block finds them, and over a query's sequence of 32
    # blocks on filling registers (ms per launch); G = 16 timed too. Bytes:
    # the rows, and each register the block touches read and written once.
    ports = torch.from_numpy(rng.integers(1024, 65535, n)).to(dev)
    port16 = (ports - 1024).to(torch.uint16)
    m = 1 << hll.DEFAULT_PRECISION
    optin = kernels.smem_optin_bytes(dev)
    for G in (N_SERVICES, FLOW_GROUPS):
        g = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
        got = hll.update(hll.init(G, dev), g, segment.Narrow(port16, 1024), mask)
        want = hll.update_plain(hll.init(G, dev), g, ports, mask)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H5 G={G} registers differ from the plain version")
        lane = kernels.hll_lane(G, hll.DEFAULT_PRECISION, optin)
        log(f"H5 hll_update G={G} lane={lane}: registers exact")
        reg, rho = hll._reg_rho(ports, hll.DEFAULT_PRECISION)
        flat = (g.long() * m + reg.long())[mask]
        touched, rho_kept = torch.unique(flat).numel(), rho[mask]
        lib_state = torch.zeros(G * m, dtype=torch.int32, device=dev)
        zeroed, plain_state = fresh(lambda: hll.init(G, dev)), hll.init(G, dev)
        rec = record(
            lambda: kernels.hll_update(port16, g, mask, zeroed(), 1024),
            lambda: hll.update_plain(plain_state, g, ports, mask),
            lambda: lib_state.scatter_reduce_(0, flat, rho_kept, "amax"),
            *bound(n * 2 + n * 4 + n + 2 * touched * 4, 40 * n), 0.0,
            f"uint16 words[{n}] state[{G},{m}] zeroed, {touched} registers touched, lane={lane}",
        )
        log(f"H5 hll_update {rec['shape']}: {rec['ms']:.5f} ms [bound {rec['bound_ms']:.5f}; "
            f"plain {rec['plain_ms']:.5f}; scatter_reduce_ {rec['library_ms']:.5f}]")
        if G == FLOW_GROUPS:
            records["hll_update"] = rec
            regs, g4096 = got, g
    records["hll_update"]["sequence_ms"] = hll_sequence(kernels, hll, dev, mask)

    # H10 on config 3's 4096 groups of those registers, on status_mix's 16
    # groups, and with one register of group 0 outside [0, 33 - p] (its
    # group takes the f64 terms): the estimate within 1e-12 before rounding,
    # rounded equal unless within that of a .5; groups bit for bit counted.
    top = 33 - hll.DEFAULT_PRECISION
    odd = regs.clone()
    odd[0, 7] = top + 3
    rels = {}
    for name, st in (("flows", regs), ("status_mix", regs[:N_SERVICES].contiguous()),
                     ("out_of_range", odd)):
        est, rounded = kernels.hll_estimate(st, hll._alpha(m))
        want_est = hll.estimate_plain(st)
        rel = ((est - want_est).abs() / want_est.abs().clamp_min(1e-300)).max().item()
        half = ((want_est - torch.floor(want_est) - 0.5).abs() <= 1e-12 * want_est)
        same = int((est.view(torch.int64) == want_est.view(torch.int64)).sum())
        torch.cuda.synchronize()
        rels[name] = rel
        check(rel <= 1e-12, f"H10 {name}: relative error {rel}")
        check(bool(torch.all((rounded == torch.round(want_est).long()) | half)),
              f"H10 {name}: rounding")
        log(f"H10 hll_estimate {name} state[{st.shape[0]},{m}]: max rel err {rel:.3g}, "
            f"{same} of {st.shape[0]} estimates bit for bit, rounded estimates equal")
    records["hll_estimate"] = record(
        lambda: kernels.hll_estimate(regs, hll._alpha(m)),
        lambda: hll.estimate_plain(regs),
        None,
        *bound(G * m * 4 + G * 16, 3 * G * m), rels["flows"], f"state[{G},{m}]",
    )
    records["hll_estimate"]["floor_ms"] = time_ms(
        lambda: kernels.empty_launch(dev, *kernels.hll_estimate_geometry(G)))
    small = regs[:N_SERVICES].contiguous()
    records["hll_estimate"]["by_status_mix"] = {
        "ms": time_ms(lambda: kernels.hll_estimate(small, hll._alpha(m))),
        "floor_ms": time_ms(
            lambda: kernels.empty_launch(dev, *kernels.hll_estimate_geometry(N_SERVICES))),
        "bound_ms": bound(N_SERVICES * m * 4 + N_SERVICES * 16, 3 * N_SERVICES * m)[0],
    }

    # H6, which hashes its words itself, cells and totals exact: config 5's
    # 16 groups x resp_status (64 keys); endpoint_load's block (34 endpoint
    # groups, the 4098 request paths' content words as the let table draws
    # them, the query's all-true mask): the timed row; more distinct keys
    # than a CTA's table holds (2^21 random words: most rows take the cells
    # at once); and a narrowed column with its offset. Bytes: the words,
    # gids and mask once, the touched cells and the totals read and written
    # once; operations: the two hashes (24 each) and the depth updates.
    from pixie_tpu_torch.table.column import fnv1a64_batch

    def h6_case(G, words, g, m, off=None):
        cm, total = countmin.init(G, dev), torch.zeros(G, dtype=torch.int64, device=dev)
        kernels.countmin_update(words, g, m, cm, total, off)
        wide = words if off is None else segment.widen(segment.Narrow(words, off))
        want = countmin.update_plain(countmin.init(G, dev), g, wide, m)
        ok = (g >= 0) & (g < G) if m is None else m & (g >= 0) & (g < G)
        torch.cuda.synchronize()
        check(torch.equal(cm, want), f"H6 G={G} cells differ from the plain version")
        check(torch.equal(total, torch.bincount(g[ok].long(), minlength=G)), f"H6 G={G} totals")
        depth, width = cm.shape[1], cm.shape[2]
        flat4 = torch.cat([((g.long() * depth + d) * width + b.long())[ok]
                           for d, b in enumerate(countmin._buckets(wide, depth, width))])
        ones4 = torch.ones_like(flat4)
        touched = torch.unique(flat4).numel()
        lib_cm = torch.zeros(G * depth * width, dtype=torch.int64, device=dev)
        rec = record(
            lambda: kernels.countmin_update(words, g, m, cm, total, off),
            lambda: countmin.update_plain(cm, g, wide, m),
            lambda: lib_cm.index_add_(0, flat4, ones4),
            *bound(n * words.element_size() + n * 4 + n + 2 * touched * 8 + 2 * G * 8,
                   (48 + 2 * depth) * n), 0.0,
            f"words[{n}] {words.dtype} cm[{G},{depth},{width}], {touched} cells touched",
        )
        log(f"H6 countmin_update {rec['shape']}: cells and totals exact; {rec['ms']:.5f} ms "
            f"[bound {rec['bound_ms']:.5f}; plain {rec['plain_ms']:.5f}; index_add_ "
            f"{rec['library_ms']:.5f}]")
        return rec

    G = N_SERVICES
    g16 = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    config5 = h6_case(G, status, g16, mask)
    paths = let_dictionaries()["req_path"]
    path_words = torch.from_numpy(fnv1a64_batch(paths).view(np.int64)).to(dev)
    code = rng.integers(0, N_PATHS, n)
    u = rng.random(n)
    code[u < 0.02] = N_PATHS
    code[(u >= 0.02) & (u < 0.03)] = N_PATHS + 1
    endpoint = np.where(code < N_PATHS, code // N_IDS, N_RESOURCES + code - N_PATHS)
    records["countmin_update"] = h6_case(
        N_RESOURCES + 2, path_words[torch.from_numpy(code).to(dev)],
        torch.from_numpy(endpoint.astype(np.int32)).to(dev), torch.ones(n, dtype=torch.bool,
                                                                        device=dev))
    records["countmin_update"]["by_config5"] = {
        k: config5[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "shape")}
    distinct = torch.from_numpy(
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)).to(dev)
    overflow = h6_case(G, distinct, g16, mask)
    records["countmin_update"]["by_overflow"] = {
        k: overflow[k] for k in ("ms", "bound_ms", "shape")}
    narrow = h6_case(G, (status - 200).to(torch.uint16), g16, mask, 200)
    log(f"H6 over every table case: config 5 {config5['ms']:.5f} ms, overflow "
        f"{overflow['ms']:.5f} ms, narrowed uint16 {narrow['ms']:.5f} ms")

    # H7a + torch.sort: the sorted keys decode to the plain version's sorted
    # (group, value) rows bit for bit, packed (G = 16) and two-key (G = 300,
    # and the windowed paths' 512 slots: a block is one window's rows, so
    # its gids are that window's 16 of the 512).
    lat = torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)).to(dev)
    C = tdigest.DEFAULT_CAPACITY
    h7ab = {}
    for G in (N_SERVICES, 300, WINDOW_SLOTS):
        lo = 5 * N_SERVICES if G == WINDOW_SLOTS else 0
        span = N_SERVICES if G == WINDOW_SLOTS else G
        g = torch.from_numpy((lo + rng.integers(0, span, n)).astype(np.int32)).to(dev)
        keys, counts = kernels.tdigest_pack(lat, g, mask, G)
        ks = torch.sort(keys).values
        g_s, v_s = decode_keys(tdigest, ks, G)
        want_g, want_v = tdigest._sorted_rows(g, lat, mask, G)
        torch.cuda.synchronize()
        check(torch.equal(g_s, want_g), f"H7a G={G}: sorted groups")
        check(torch.equal(v_s.view(torch.int32), want_v.view(torch.int32)), f"H7a G={G}: values")
        check(torch.equal(counts.long(), torch.bincount(want_g, minlength=G + 1)), f"H7a G={G} counts")
        # H7b over the sorted keys, under the Fault-4 contract: group weights
        # exact; per group, the cells' weights move by at most two per row
        # whose f64 cluster coordinate lies within 1e-4 of an integer; value
        # sums of the other cells within 1e-12 (f64 sums in another order).
        sums = kernels.tdigest_cluster(ks, counts, G, C)
        want_sums = tdigest._cluster_sums_plain(want_g, want_v, G, C)
        near = near_edge_rows(tdigest, want_g, G, C)
        dw = (sums[0] - want_sums[0]).abs()
        same = dw == 0
        verr = ((sums[1] - want_sums[1]).abs() / want_sums[1].abs().clamp_min(1e-300))[same]
        torch.cuda.synchronize()
        check(torch.equal(sums[0].sum(dim=1), want_sums[0].sum(dim=1)), f"H7b G={G} weights")
        check(bool(torch.all(dw.sum(dim=1) <= 2 * near)), f"H7b G={G}: beyond Fault-4")
        check(verr.max().item() <= 1e-12, f"H7b G={G}: value sums {verr.max().item()}")
        log(f"H7a+sort+H7b G={G} ({'wide' if G > 254 else 'packed'} keys): sorted rows "
            f"exact; {int((~same).sum())} cells moved by {int(near.sum())} rows near a "
            f"cluster edge; value sums max rel err {verr.max().item():.3g}")
        if G == N_SERVICES:
            sums16 = sums
        if G == 300:
            continue
        # Keys are int32 packed up to 254 groups, int64 above.
        kb = keys.element_size()
        pack_rec = record(
            lambda g=g, G=G: kernels.tdigest_pack(lat, g, mask, G),
            lambda g=g, G=G: tdigest._sorted_rows(g, lat, mask, G),
            None,
            *bound(n * 4 + n * 4 + n + n * kb + (G + 1) * 4, 6 * n), 0.0,
            f"values[{n}] G={G}",
        )
        flat_cells, _ = tdigest._row_clusters(want_g, G, C)
        lib_sums = torch.zeros(G * C + 1, dtype=torch.float64, device=dev)
        v64 = want_v.double()
        cluster_rec = record(
            lambda ks=ks, counts=counts, G=G: kernels.tdigest_cluster(ks, counts, G, C),
            lambda want_g=want_g, want_v=want_v, G=G: tdigest._cluster_sums_plain(
                want_g, want_v, G, C),
            lambda lib_sums=lib_sums, flat_cells=flat_cells, v64=v64: lib_sums.index_add_(
                0, flat_cells, v64),
            *bound(n * kb + (G + 1) * 4 + 2 * G * C * 8, 60 * n), verr.max().item(),
            f"keys[{n}] G={G} C={C}",
        )
        # The update's sort between H7a and H7b, on the same keys.
        cluster_rec["sort_ms"] = time_ms(lambda keys=keys: torch.sort(keys))
        log(f"H7a tdigest_pack G={G}: {pack_rec['ms']:.5f} ms [bound {pack_rec['bound_ms']:.5f}; "
            f"plain {pack_rec['plain_ms']:.5f}]; H7b tdigest_cluster G={G}: "
            f"{cluster_rec['ms']:.5f} ms [bound {cluster_rec['bound_ms']:.5f}; plain "
            f"{cluster_rec['plain_ms']:.5f}; index_add_ {cluster_rec['library_ms']:.5f}]; the "
            f"update's torch.sort of its keys {cluster_rec['sort_ms']:.5f} ms")
        h7ab[G] = (pack_rec, cluster_rec)
    # The line's shape is the one the windowed paths send (512 slots, wide
    # keys); the packed 16-group shape rides beside it.
    for i, name in enumerate(("tdigest_pack", "tdigest_cluster")):
        records[name] = h7ab[WINDOW_SLOTS][i]
        records[name]["by_g16"] = {k: h7ab[N_SERVICES][i][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "shape")}
    h7b_edges(kernels, tdigest, dev, rng)
    records["tdigest_update"] = h7_phase(kernels, tdigest, dev, rng, mask)

    # H8: a digest of a few plain blocks merged with H7b's raw sums (the
    # table's shape, sketches' blocks), then ops/tdigest_edges.py's edge
    # digests (an empty a; a digest of three blocks and a block's sums
    # at 1, 16, 254 and 300 groups; a sparse group; equal means across the
    # halves; an inverted pair and clusters that drop back, each forcing its
    # exact branch in every group; NaN, +-inf, -0/+0 means; raw sums with
    # zero weights): weights bit for bit with the plain version on the card
    # (0 cells moved: H8 takes the plain version's cluster arithmetic),
    # means within 2C * 2^-24 * max|finite input mean| of the group; H9 on
    # the result. The probe counts the groups on each exact branch.
    from pixie_tpu_torch.ops.tdigest_edges import H8_CASES, h8_expected_branches, h8_inputs

    G = N_SERVICES
    a = tdigest.init(G, dev)
    for _ in range(3):
        a = tdigest.update_plain(
            a, torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev),
            torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)).to(dev), mask,
        )
    b16 = tdigest.batch_from_sums(sums16[0], sums16[1])
    probe = torch.zeros(kernels.TD_MERGE_PROBE, dtype=torch.int64, device=dev)
    got = kernels.tdigest_merge(a["means"], a["weights"], sums16[0], sums16[1], raw_b=True,
                                probe=probe)
    merr = h8_check(got, tdigest.merge_plain(a, b16), a, b16, C, "sketches' blocks")
    branches = {"sketches' blocks": probe[:2].tolist()}
    for case, Gc in H8_CASES:
        ea, eb, raw_b = h8_inputs(case, Gc, C)
        ea, eb = ({k: v.to(dev) for k, v in d.items()} for d in (ea, eb))
        eprobe = torch.zeros(kernels.TD_MERGE_PROBE, dtype=torch.int64, device=dev)
        b0, b1 = (eb["weights"], eb["means"]) if raw_b else (eb["means"], eb["weights"])
        egot = kernels.tdigest_merge(ea["means"], ea["weights"], b0, b1, raw_b=raw_b,
                                     probe=eprobe)
        bb = tdigest.batch_from_sums(eb["weights"], eb["means"]) if raw_b else eb
        merr = max(merr, h8_check(egot, tdigest.merge_plain(ea, bb), ea, bb, C, f"{case} G={Gc}"))
        name, expect = f"{case} G={Gc}", h8_expected_branches(case, Gc)
        branches[name] = eprobe[:2].tolist()
        check(expect is None or branches[name] == expect,
              f"H8 {name}: groups on the exact branches {branches[name]}")
    log(f"H8 tdigest_merge: weights bit for bit (0 cells moved) at sketches' blocks and "
        f"{len(H8_CASES)} edge digests; means max |err| {merr:.3g}; groups on the all-pairs "
        f"rank and the per-cluster walk: {json.dumps(branches)}")
    rec = record(
        lambda: kernels.tdigest_merge(a["means"], a["weights"], sums16[0], sums16[1], raw_b=True),
        lambda: tdigest.merge_plain(a, b16),
        None,
        # ops: a binary search of 2C centroids and one pass over them
        *bound(2 * G * C * 4 + 2 * G * C * 8 + 2 * G * C * 4,
               G * 2 * C * (math.log2(2 * C) + 1)),
        merr, f"state[{G},{C}] + sums[2,{G},{C}]",
    )
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, *kernels.tdigest_merge_geometry(G, C)))
    for _ in range(3):
        probe.zero_()
        kernels.tdigest_merge(a["means"], a["weights"], sums16[0], sums16[1], raw_b=True,
                              probe=probe)
    torch.cuda.synchronize()
    rec["b_phases_us"] = probe_phases_us(
        probe, ("load+classes", "rank", "scan", "clusters", "sums"), 2, kernels.sm_clock_khz(dev))
    rec["b_branch_groups"] = branches
    records["tdigest_merge"] = rec
    log(f"H8 tdigest_merge {rec['shape']}: {rec['ms']:.5f} ms [bound {rec['bound_ms']:.5f}; "
        f"floor {rec['floor_ms']:.5f}; plain {rec['plain_ms']:.5f}]; CTA 0's phases us "
        f"{json.dumps(rec['b_phases_us'])}")
    # H9 on the merged digest (every group's weights whole, totalling at
    # most 2^24: bit for bit with the plain version), then the edge digests
    # (empty, one centroid, empties between full ones, all weight in the
    # last, a total of 2^24; a total above 2^24, fractional weights and a
    # weight above 2^24 within td_inexact_tol) at every capacity of
    # TD_CAPACITIES, for 7 qs and 40.
    from pixie_tpu_torch.ops.quantile_edges import (
        QS_WIDE, TD_CAPACITIES, td_edge_state, td_inexact_tol,
    )

    qs_t = torch.tensor(QS, dtype=torch.float32, device=dev)
    qg = kernels.tdigest_quantiles(got["means"], got["weights"], qs_t)
    qw = tdigest.quantile_values_plain(got, QS)
    exact = tdigest.quantile_exact_groups(got["weights"])
    torch.cuda.synchronize()
    check(bool(exact.all()), "H9: a group of sketches' merged digest is outside the exact range")
    check(torch.equal(qg, qw), f"H9 G={G}: {int((qg != qw).sum())} values differ")
    inexact = {"groups": 0, "max_rel_err": 0.0, "max_err_over_tol": 0.0}
    for ec in TD_CAPACITIES:
        em, ew = (torch.from_numpy(a).to(dev) for a in td_edge_state(ec, G, seed=ec))
        est = {"means": em, "weights": ew}
        ex = tdigest.quantile_exact_groups(ew)
        for eqs in (QS, QS_WIDE):
            tol = td_inexact_tol(em[~ex], ew[~ex], eqs)
            eg = kernels.tdigest_quantiles(em, ew, torch.tensor(eqs, dtype=torch.float32,
                                                                device=dev))
            ewant = tdigest.quantile_values_plain(est, eqs)
            torch.cuda.synchronize()
            check(torch.equal(eg[ex], ewant[ex]),
                  f"H9 edges C={ec} Q={len(eqs)}: {int((eg[ex] != ewant[ex]).sum())} values differ")
            err = (eg[~ex] - ewant[~ex]).abs()
            check(bool(torch.all(err <= tol)), f"H9 edges C={ec} Q={len(eqs)}: beyond the bound")
            inexact["groups"] += int((~ex).sum())
            inexact["max_rel_err"] = max(inexact["max_rel_err"], float(
                (err / ewant[~ex].abs().clamp_min(1e-300)).max()))
            inexact["max_err_over_tol"] = max(  # a bound of 0 holds only an error of 0
                inexact["max_err_over_tol"], float((err / tol.clamp_min(1e-300)).max()))
    rec = record(
        lambda: kernels.tdigest_quantiles(got["means"], got["weights"], qs_t),
        lambda: tdigest.quantile_values_plain(got, QS),
        None,
        *bound(2 * G * C * 4 + len(QS) * 4 + G * len(QS) * 8, 6 * G * len(QS) * C),
        (qg - qw).abs().max().item(), f"state[{G},{C}] Q={len(QS)}",
    )
    rec["floor_ms"] = time_ms(
        lambda: kernels.empty_launch(dev, *kernels.tdigest_quantiles_geometry(G)))
    rec["b_inexact_edges"] = inexact
    records["tdigest_quantiles"] = rec
    log(f"H9 tdigest_quantiles: bit for bit on the merged digest and the exact edge groups at "
        f"C {list(TD_CAPACITIES)}, Q 7 and {len(QS_WIDE)}; the inexact ones {json.dumps(inexact)}; "
        f"{rec['shape']} {rec['ms']:.5f} ms [bound {rec['bound_ms']:.5f}; floor "
        f"{rec['floor_ms']:.5f}; plain {rec['plain_ms']:.5f}]")
    return records


# H7's edge blocks (tests/test_torch_kernels.py td_update_inputs draws the
# same): every value equal, two values, a group of one row, empty groups,
# masked rows and gids out of range, NaN, +-inf, +-0 and subnormals, G = 1,
# 16 and 254, exponential(3e7) latencies.
TD_UPDATE_CASES = (("exponential", 1), ("exponential", 16), ("exponential", 254),
                   ("all_equal", 16), ("two_values", 16), ("single_row", 16),
                   ("empty_groups", 16), ("masked", 16), ("specials", 16), ("specials", 254))
TD_SPECIALS = (math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-40, -1e-41, 1.4e-45, 5e-324)


def td_update_block(case: str, G: int, n: int, seed: int = 0):
    """(gids int32, f64 values, mask) of a block of H7's edge case."""
    rng = np.random.default_rng([seed, G, [c for c, _ in TD_UPDATE_CASES].index(case)])
    gids = rng.integers(0, G, n)
    mask = rng.random(n) < 0.9
    vals = rng.exponential(3e7, n)
    if case == "all_equal":
        vals[:] = 12345.678
    elif case == "two_values":
        vals = rng.choice(np.array([250.0, 7.5e7]), n)
    elif case == "single_row":
        gids[gids == 3] = 4
        gids[n // 2], mask[n // 2] = 3, True
    elif case == "empty_groups":
        gids[gids % 3 == 1] = 0
    elif case == "masked":
        gids = rng.integers(-2, G + 2, n)
        mask = rng.random(n) < 0.6
    elif case == "specials":
        k = n // 8
        vals[rng.choice(n, k, replace=False)] = rng.choice(np.array(TD_SPECIALS), k)
    return gids.astype(np.int32), vals, mask


def h7_check(kernels, tdigest, dev, g, v64, m, G: int, what: str,
             C: int = 256) -> float:
    """H7 over one block, its values as f64 and as f32, against the plain
    sums over the sorted rows: weights bit for bit, value sums within 1e-12
    * sum |v| (NaN and inf cells alike). Returns the largest |error| of a
    finite value sum."""
    v32 = v64.float()
    g_s, v_s = tdigest._sorted_rows(g, v32, m, G)
    want = tdigest._cluster_sums_plain(g_s, v_s, G, C)
    scale = tdigest._cluster_sums_plain(g_s, v_s.abs(), G, C)[1]
    worst = 0.0
    for v in (v64, v32):
        got = kernels.tdigest_update_sums(v, g, m, G, C)
        nan, fin = torch.isnan(want[1]), torch.isfinite(want[1])
        err = (got[1] - want[1]).abs()[fin]
        torch.cuda.synchronize()
        check(bits_equal(got[0], want[0]), f"H7 {what} {v.dtype}: weights differ from plain")
        check(torch.equal(torch.isnan(got[1]), nan)
              and torch.equal(got[1][~fin & ~nan], want[1][~fin & ~nan]),
              f"H7 {what} {v.dtype}: NaN or inf cells differ")
        check(bool(torch.all(err <= 1e-12 * scale[fin])), f"H7 {what} {v.dtype}: value sums")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def h8_check(got: dict, want: dict, a: dict, b: dict, C: int, what: str) -> float:
    """H8 against merge_plain on the card: weights bit for bit, means within
    2C * 2^-24 * max|finite input mean| of the group, NaN and inf alike.
    Returns the largest |error| of a finite mean."""
    inputs = torch.cat([a["means"], b["means"].float()], dim=1)
    scale = torch.where(torch.isfinite(inputs), inputs.abs(), 0.0).amax(dim=1, keepdim=True)
    gm, wm = got["means"], want["means"]
    fin = torch.isfinite(wm)
    err = (gm - wm).abs()[fin]
    torch.cuda.synchronize()
    check(bits_equal(got["weights"], want["weights"]), f"H8 {what}: weights differ from plain")
    check(torch.equal(torch.isnan(gm), torch.isnan(wm))
          and torch.equal(gm[torch.isinf(wm)], wm[torch.isinf(wm)]), f"H8 {what}: NaN or inf")
    check(bool(torch.all(err <= (2 * C * 2.0**-24 * scale).expand_as(wm)[fin])),
          f"H8 {what}: means beyond 2C * 2^-24 * max|mean|")
    return float(err.max()) if err.numel() else 0.0


def device_ops(fn) -> dict:
    """The device operations one call of ``fn`` runs (a warm call traced by
    torch.profiler): kernels, and memsets and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    other = [n for n in names if n.startswith(("Memset", "Memcpy"))]
    return {"kernels": len(names) - len(other), "memsets_copies": len(other)}


def h7_phase(kernels, tdigest, dev, rng, mask) -> dict:
    """H7, the sort-free t-digest update of up to 254 groups: bit-equal
    weights and value sums within 1e-12 * sum |v| at every edge block (2^16
    and 2^21 + 3 rows) and at sketches' block (2^21 rows, 16 groups, f64
    latency as the fold hands it over, the mask), timed there with its
    phases' device times, the whole update (H7 and H8) against the
    sorting one (H7a, torch.sort, H7b, H8) and each one's device operations."""
    worst = 0.0
    for case, G in TD_UPDATE_CASES:
        for n in (1 << 16, (1 << 21) + 3):
            gids, vals, m = td_update_block(case, G, n)
            worst = max(worst, h7_check(
                kernels, tdigest, dev, torch.from_numpy(gids).to(dev),
                torch.from_numpy(vals).to(dev), torch.from_numpy(m).to(dev), G,
                f"{case} G={G} n={n}"))
    log(f"H7 tdigest_update edges ({len(TD_UPDATE_CASES)} cases at 2^16 and 2^21 + 3 rows, "
        f"f64 and f32 values): weights bit for bit, value sums max |err| {worst:.3g}")
    n, G, C = BLOCK_ROWS, N_SERVICES, tdigest.DEFAULT_CAPACITY
    lat = torch.from_numpy(rng.exponential(3e7, n)).to(dev)
    g = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    err = h7_check(kernels, tdigest, dev, g, lat, mask, G, "sketches' block")
    worst = max(worst, err)
    rec = record(
        lambda: kernels.tdigest_update_sums(lat, g, mask, G, C),
        lambda: tdigest._cluster_sums_plain(*tdigest._sorted_rows(g, lat.float(), mask, G), G, C),
        None,
        # bytes: f64 values, gids and mask read once, the [2, G, C] sums
        # written once; operations: a key a row and a cluster a rank (~40)
        *bound(n * (8 + 4 + 1) + 2 * G * C * 8, 40 * n), worst,
        f"values f64[{n}] G={G} C={C}, mask; max |err| over the edge blocks too",
    )
    stamps = torch.zeros(kernels.TD_STAMPS, dtype=torch.int64, device=dev)
    for _ in range(3):
        kernels.tdigest_update_sums(lat, g, mask, G, C, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().tolist()
    names = ("pack+L1", "L1 flush", "L1 scan", "run starts", "L2 rows", "L2 bins", "L3 rows",
             "L3 bins", "runs", "other rows", "partials")
    rec["b_phases_us"] = {nm: (st[k + 1] - st[k]) / 1e3 for k, nm in enumerate(names)}
    rec["b_slots"] = {"level2": st[14], "level3": st[15]}
    state = tdigest.init(G, dev)

    def before():  # the sorting update: H7a, torch.sort, H7b, H8
        keys, counts = kernels.tdigest_pack(lat.to(torch.float32).contiguous(), g, mask, G)
        sums = kernels.tdigest_cluster(torch.sort(keys).values, counts, G, C)
        return kernels.tdigest_merge(state["means"], state["weights"], sums[0], sums[1], raw_b=True)

    def after():
        return tdigest.update(state, g, lat, mask)

    rec["block_ops_before"], rec["block_ops_after"] = device_ops(before), device_ops(after)
    rec["by_update_ms"] = {"before": time_ms(before), "after": time_ms(after)}
    log(f"H7 tdigest_update {rec['shape']}: {rec['ms']:.5f} ms [bound {rec['bound_ms']:.5f}; "
        f"plain {rec['plain_ms']:.5f}]; phases us {json.dumps(rec['b_phases_us'])}; slots "
        f"{rec['b_slots']}; the whole update {rec['by_update_ms']['after']:.5f} ms against "
        f"the sorting one's {rec['by_update_ms']['before']:.5f}; device operations a block "
        f"{rec['block_ops_after']} against {rec['block_ops_before']}")
    check(rec["block_ops_after"]["kernels"] + rec["block_ops_after"]["memsets_copies"]
          < rec["block_ops_before"]["kernels"] + rec["block_ops_before"]["memsets_copies"],
          "H7: no fewer device operations a block than H7a + torch.sort + H7b")
    return rec


def h7b_case(kernels, tdigest, dev, gids: np.ndarray, vals: np.ndarray, mask: np.ndarray,
             G: int, what: str, C: int = 256) -> None:
    """H7a, torch.sort and H7b over one block against the plain version
    under Fault-4: group weights exact, cells moved only by rows near a
    cluster edge, the other cells' value sums within 1e-12; and over the
    same keys less the first, a view one key in (no vector loads)."""
    g = torch.from_numpy(gids.astype(np.int32)).to(dev)
    v = torch.from_numpy(vals.astype(np.float32)).to(dev)
    m = torch.from_numpy(mask).to(dev)
    keys, counts = kernels.tdigest_pack(v, g, m, G)
    ks = torch.sort(keys).values
    g_s, v_s = tdigest._sorted_rows(g, v, m, G)
    for skip in (0, 1):
        c = counts.clone()
        if skip:
            c[int(g_s[0])] -= 1
        got = kernels.tdigest_cluster(ks[skip:], c, G, C)
        want = tdigest._cluster_sums_plain(g_s[skip:], v_s[skip:], G, C)
        dw = (got[0] - want[0]).abs()
        same = dw == 0
        verr = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-300))[same]
        torch.cuda.synchronize()
        check(torch.equal(got[0].sum(dim=1), want[0].sum(dim=1)), f"H7b {what}: group weights")
        check(bool(torch.all(dw.sum(dim=1) <= 2 * near_edge_rows(tdigest, g_s[skip:], G, C))),
              f"H7b {what}: beyond Fault-4")
        check(verr.numel() == 0 or verr.max().item() <= 1e-12, f"H7b {what}: value sums")


def h7b_edges(kernels, tdigest, dev, rng) -> None:
    """H7b's edges: an empty group, groups of 1 and 2 rows, every row
    masked, one group holding every row, n off the 16-byte vectors (a tail
    of 1 to 3 keys), runs of one cell across warp (128 keys) and CTA (4096
    keys) edges, G = 300 (wide keys) and G past the shared starts (scanned
    into scratch first)."""
    n, G = 1 << 20, N_SERVICES
    base = lambda: (rng.integers(0, G, n), rng.exponential(3e7, n), rng.random(n) < 0.9)
    g, v, m = base()
    g[g == 3] = 4
    h7b_case(kernels, tdigest, dev, g, v, m, G, "an empty group")
    g, v, m = base()
    g[g <= 1] = 2
    g[:3], m[:3] = [0, 1, 1], True
    h7b_case(kernels, tdigest, dev, g, v, m, G, "groups of 1 and 2 rows")
    g, v, _ = base()
    h7b_case(kernels, tdigest, dev, g, v, np.zeros(n, bool), G, "every row masked")
    _, v, m = base()
    h7b_case(kernels, tdigest, dev, np.full(n, 7), v, m, G, "one group")
    for tail in (1, 2, 3):
        g, v, m = (x[: n - tail] for x in base())
        h7b_case(kernels, tdigest, dev, g, v, m, G, f"n - {tail} keys")
    g, _, m = base()
    v = np.repeat(rng.exponential(3e7, n // 5000 + 1), 5000)[:n]  # runs of 5000 equal values
    h7b_case(kernels, tdigest, dev, g, v, m, G, "runs across warp and CTA edges")
    g, v, m = base()
    h7b_case(kernels, tdigest, dev, rng.integers(0, 300, n), v, m, 300, "G = 300, wide keys")
    big = kernels.TD_SHARED_STARTS + 100
    h7b_case(kernels, tdigest, dev, rng.integers(0, big, n), v, m, big,
             f"G = {big}, starts in scratch")
    log("H7b edges: an empty group, groups of 1 and 2 rows, every row masked, one group, "
        "n - 1..3 keys, runs across warp and CTA edges, G = 300 and "
        f"{big}, each also one key into its buffer: weights exact, Fault-4, value sums 1e-12")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN payloads and signs of zero included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def minmax_kernel_phase(dev) -> dict:
    """H11 against its plain version, bit for bit: min and max over int64
    and f64 at 16, 4096 and 2^20 groups, then a block of edge values; every
    row kind as staged (uint8, uint16, int32 with offsets at the ends of
    their ranges and near INT64_MIN/MAX, bool, int64, f64) in every lane
    (S = 1, 5, 32, 64, 4096, 2^20). Timed at the three shapes the paths
    give it, each call on a fresh identity state (a query's first block):
    flow_window's S = 1 int64 (H19's decoded time_), config 10's S = 64 f64
    (lat), and flows' S = 4096 int32 narrowed (bytes_sent, the row)."""
    from pixie_tpu_torch.ops import kernels, segment

    rng = np.random.default_rng(2)
    n = BLOCK_ROWS
    mask = torch.from_numpy(rng.random(n) < 0.97).to(dev)
    optin = kernels.smem_optin_bytes(dev)
    records: dict = {}
    for S in (N_SERVICES, FLOW_GROUPS, 1 << 20):
        g = torch.from_numpy(rng.integers(-1, S + 1, n).astype(np.int32)).to(dev)
        for dtype in (torch.int64, torch.float64):
            v = (torch.from_numpy(rng.integers(0, 1 << 20, n)) if dtype == torch.int64
                 else torch.from_numpy(rng.normal(0.0, 1e6, n))).to(dev)
            for is_min in (True, False):
                fill = segment._identity_for(dtype, is_min)
                got = kernels.segment_minmax(
                    v, g, mask, torch.full((S,), fill, dtype=dtype, device=dev), is_min)
                want = segment.segment_minmax_plain(
                    torch.full((S,), fill, dtype=dtype, device=dev), v, g, mask, is_min)
                torch.cuda.synchronize()
                check(bits_equal(got, want),
                      f"H11 S={S} {dtype} {'min' if is_min else 'max'} differs from plain")
        log(f"H11 segment_minmax S={S} lane={kernels.h11_lane(S, optin)}: int64 and f64, "
            "min and max, bit for bit")
    # Edge values into 8 groups: NaN of both signs, +-0.0 in one group (both
    # orders), +-inf, subnormals, int64 min and max, an all-masked group; then
    # a second launch into the same state, which holds NaN and +-0.0 by then.
    f64_edge = [
        (0, [1.0, np.nan, 3.0]), (1, [0.0, -0.0]), (2, [-0.0, 0.0]),
        (3, [-np.nan, 2.0]), (4, [np.inf, -np.inf]), (5, [5e-324, -5e-324]),
        (6, [7.0, 8.0]),  # masked below
    ]
    i64_edge = [
        (0, [np.iinfo(np.int64).min, 5]), (1, [np.iinfo(np.int64).max, -5]),
        (2, [0, -1]), (6, [7, 8]),  # masked below
    ]
    S = 8
    for dtype, edge in ((torch.float64, f64_edge), (torch.int64, i64_edge)):
        gl = np.concatenate([[gg] * len(vs) for gg, vs in edge]).astype(np.int32)
        vl = np.concatenate([np.array(vs, dtype=np.float64 if dtype == torch.float64
                                      else np.int64) for _, vs in edge])
        g = torch.from_numpy(gl).to(dev)
        v = torch.from_numpy(vl).to(dev)
        m = g != 6
        for is_min in (True, False):
            fill = segment._identity_for(dtype, is_min)
            got = torch.full((S,), fill, dtype=dtype, device=dev)
            want = got.clone()
            for _ in range(2):
                kernels.segment_minmax(v, g, m, got, is_min)
                segment.segment_minmax_plain(want, v, g, m, is_min)
            torch.cuda.synchronize()
            check(bits_equal(got, want), f"H11 edge block {dtype} min={is_min}: "
                  f"{got.tolist()} vs {want.tolist()}")
    log("H11 edge block (NaN of both signs, +-0.0 both orders, +-inf, subnormals, "
        "int64 min/max, an all-masked group, a second launch): bit for bit")
    # Every row kind as staged, in every lane: the staged values include both
    # ends of the type's range; a second launch into the same state.
    i64 = np.iinfo(np.int64)
    f = rng.normal(0.0, 1e6, n)
    f[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324]
    kinds = [
        (np.uint8, 255, int(i64.max) - 255), (np.uint8, 255, int(i64.min)),
        (np.uint16, 65535, int(i64.max) - 65535), (np.uint16, 65535, -(1 << 40)),
        (np.int32, 2**31 - 1, int(i64.max) - 2**31 + 1), (np.int32, 2**31 - 1, int(i64.min)),
        (np.int32, 2**31 - 1, 1 << 20),
    ]
    cols = []
    for dt, top, off in kinds:
        a = rng.integers(0, top + 1, n).astype(dt)
        a[:2] = [0, top]
        cols.append((torch.from_numpy(a).to(dev), off))
    cols += [(torch.from_numpy(rng.random(n) < 0.5).to(dev), 0),
             (torch.from_numpy(rng.integers(i64.min, i64.max, n, dtype=np.int64)).to(dev), 0),
             (torch.from_numpy(f).to(dev), 0)]
    lanes = set()
    for S in (1, 5, 32, 64, FLOW_GROUPS, 1 << 20):
        g = torch.from_numpy(rng.integers(-1, S + 1, n).astype(np.int32)).to(dev)
        g[:2] = 0
        lanes.add(kernels.h11_lane(S, optin)[0])
        for col, off in cols:
            f64 = col.dtype == torch.float64
            dtype = torch.float64 if f64 else torch.int64
            wide = col if f64 else segment.widen(segment.Narrow(col, off))
            for is_min in (True, False):
                fill = segment._identity_for(dtype, is_min)
                got = torch.full((S,), fill, dtype=dtype, device=dev)
                want = got.clone()
                for _ in range(2):
                    kernels.segment_minmax(col, g, mask, got, is_min, off)
                    segment.segment_minmax_plain(want, wide, g, mask, is_min)
                torch.cuda.synchronize()
                check(bits_equal(got, want),
                      f"H11 S={S} {col.dtype} offset {off} min={is_min} differs from plain")
    check(lanes == {"regs", "cluster", "global"}, f"H11 lanes {lanes}")
    log(f"H11 every row kind (uint8, uint16, int32 with offsets at INT64_MIN/MAX, bool, "
        f"int64, f64) at S = 1, 5, 32, 64, 4096, 2^20 (lanes {sorted(lanes)}): bit for bit")

    def timed(S, col, off, is_min, row_bytes, what):
        g = torch.from_numpy(rng.integers(0, S, n).astype(np.int32)).to(dev)
        f64 = col.dtype == torch.float64
        dtype = torch.float64 if f64 else torch.int64
        ident = segment._identity_for(dtype, is_min)
        states = fresh(lambda: torch.full((S,), ident, dtype=dtype, device=dev))
        plain_state = torch.full((S,), ident, dtype=dtype, device=dev)
        narrow = col if f64 or off is None else segment.Narrow(col, off)
        wide = segment.widen(narrow)
        idx, kept = g[mask].long(), wide[mask]
        lib_state = torch.full((S,), ident, dtype=dtype, device=dev)
        rec = record(
            lambda: kernels.segment_minmax(col, g, mask, states(), is_min, off or 0),
            lambda: segment.segment_minmax_plain(plain_state, segment.widen(narrow), g, mask,
                                                 is_min),
            lambda: lib_state.scatter_reduce_(0, idx, kept, "amin" if is_min else "amax",
                                              include_self=True),
            # values, gids and mask read once; the state read and written once
            *bound(n * row_bytes + n * 4 + n + 2 * S * 8, n), 0.0,
            f"{what}: values[{n}] {col.dtype} state[{S}] {'min' if is_min else 'max'}, "
            f"fresh identity state, lane {kernels.h11_lane(S, optin)[0]}",
        )
        log(f"H11 {rec['shape']}: {rec['ms']:.5f} ms [bound {rec['bound_ms']:.5f}; plain "
            f"{rec['plain_ms']:.5f}; scatter_reduce_ {rec['library_ms']:.5f}]")
        return rec

    bytes_sent = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev)
    records["segment_minmax"] = timed(FLOW_GROUPS, bytes_sent, 0, False, 4,
                                      "flow_span (int32 narrowed)")
    time_ = torch.arange(n, dtype=torch.int64, device=dev) * 1000
    lat = torch.from_numpy(rng.standard_normal(n)).to(dev)
    for key, args in (("by_s1_int64", (1, time_, None, False, 8, "flow_window (int64)")),
                      ("by_s64_f64", (MESH_SERVICES, lat, None, True, 8, "config 10 (f64)"))):
        rec = timed(*args)
        records["segment_minmax"][key] = {
            k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "shape")}
    return records


def scan_kernel_phase(dev) -> dict:
    """H12 against its plain version on 2^21-row blocks, bit for bit
    (written and every buffer): limit 0 and 1, a limit that ends inside a
    block, one past every survivor, a block with no survivor, and a last
    block mostly padding. Timed at config 1's first block: 10% of rows
    selected, time_ (int64), service codes (int32), latency_ms (f64), limit
    1000, a fresh zeroed counter each call, beside an empty kernel on its
    grid, with CTA 0's phases (``probe``)."""
    from pixie_tpu_torch.ops import kernels, scan

    rng = np.random.default_rng(3)
    n = BLOCK_ROWS

    def block(frac: float, valid: int = n):
        mask = torch.from_numpy((rng.random(n) < frac) & (np.arange(n) < valid)).to(dev)
        cols = [torch.from_numpy(rng.integers(0, 1 << 40, n)).to(dev),
                torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(dev),
                torch.from_numpy(rng.exponential(30.0, n)).to(dev)]
        return mask, cols

    blocks = [block(0.1), block(0.0), block(0.5, valid=1000)]  # empty, then mostly padding
    total = sum(int(m.sum()) for m, _ in blocks)
    first = int(blocks[0][0].sum())
    for limit in (0, 1, first + 300, total, total + 7):
        out = []
        for compact in (kernels.scan_compact, scan.compact_rows_plain):
            written = torch.zeros(1, dtype=torch.int32, device=dev)
            bufs = [torch.zeros(limit, dtype=c.dtype, device=dev) for c in blocks[0][1]]
            for mask, cols in blocks:
                compact(mask, cols, written, bufs, limit)
            out.append((written, bufs))
        torch.cuda.synchronize()
        (wk, bk), (wp, bp) = out
        check(int(wk[0]) == int(wp[0]) == min(limit, total), f"H12 limit={limit}: written")
        check(all(bits_equal(a, b) for a, b in zip(bk, bp)), f"H12 limit={limit}: buffers")
    log(f"H12 scan_compact: limits 0, 1, {first + 300} (inside the third block), {total} "
        f"and {total + 7} (every survivor) over blocks of {n} rows (10%, none, "
        "1000 valid rows at 50%): written and buffers bit for bit")
    mask, cols = blocks[0]
    sel = torch.nonzero(mask).flatten()
    span = int(sel[SCAN_LIMIT - 1]) + 1  # the rows the compaction must scan
    row_bytes = sum(c.element_size() for c in cols)
    counters = fresh(lambda: torch.zeros(1, dtype=torch.int32, device=dev))
    bufs = [torch.zeros(SCAN_LIMIT, dtype=c.dtype, device=dev) for c in cols]
    plain_w = torch.zeros(1, dtype=torch.int32, device=dev)
    records = {"scan_compact": record(
        lambda: kernels.scan_compact(mask, cols, counters(), bufs, SCAN_LIMIT),
        lambda: (plain_w.zero_(), scan.compact_rows_plain(mask, cols, plain_w, bufs, SCAN_LIMIT)),
        lambda: [c[mask] for c in cols],
        # what the function needs: the mask up to the last row written (one
        # test a row), the written rows read once and written once
        *bound(span + 2 * SCAN_LIMIT * row_bytes, span), 0.0,
        f"mask[{n}] 10% selected, 3 columns, limit {SCAN_LIMIT}, span {span} rows",
    )}
    rec = records["scan_compact"]
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.scan_compact_geometry(dev, n)))
    probe = torch.zeros(kernels.SCAN_PROBE, dtype=torch.int64, device=dev)
    kernels.scan_compact(mask, cols, torch.zeros(1, dtype=torch.int32, device=dev), bufs,
                         SCAN_LIMIT, probe=probe)
    rec["by_cta0_phases_us"] = probe_phases_us(
        probe, ("count", "wait", "copy", "pad"), 0, kernels.sm_clock_khz(dev))
    log(f"H12 at config 1's first block: {rec['ms']:.5f} ms, an empty kernel on its grid "
        f"{rec['floor_ms']:.5f}; CTA 0's phases (us) {json.dumps(rec['by_cta0_phases_us'])}")
    return records


def join_edge_keys(seed: int, nb: int, n_probe: int, K: int, pad_b: int, pad_p: int):
    """Sentinel-applied join keys: many-to-many (key 0 on a tenth of the build
    rows: a large fanout), id 1 on the probe side only (fanout 0), id K - 1
    on the build side only, padded rows keyed K (build) and K + 1 (probe)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, K, nb).astype(np.int32)
    lk[rng.random(nb) < 0.1] = 0
    lk[lk == 1] = 2
    rk = rng.integers(0, K, n_probe).astype(np.int32)
    rk[rk == K - 1] = 3
    lmask = np.arange(nb) < nb - pad_b
    rmask = np.arange(n_probe) < n_probe - pad_p
    return (np.where(lmask, lk, K).astype(np.int32), np.where(rmask, rk, K + 1).astype(np.int32),
            lmask, rmask)


def join_left_agg_keys(dev) -> tuple:
    """join8_left_agg's join keys as the sort-merge lane builds them
    (``_join_key_ids``, then ``_run_device_join``): join_fact's 4,000,000
    service codes as the build side and svc_owners_partial's 18 services as
    the probe side, densified by one GroupEncoder (left first: K 20), each
    side padded to its staged block geometry (2^21-row blocks: 4,194,304
    build rows; 256 probe rows) with keys K and K + 1. Returns (build keys,
    probe keys, K, M, cap_m), the keys int32 on ``dev``."""
    from pixie_tpu_torch.exec.group_encoder import GroupEncoder
    from pixie_tpu_torch.parallel.staging import _pow2_at_least, block_geometry

    left = join_fact(JOIN_ROWS)["svc_idx"].astype(np.int64)
    right = np.array([SERVICES.index(s) if s in SERVICES else N_SERVICES + int(s[6:])
                      for s in partial_owners()], dtype=np.int64)
    enc = GroupEncoder()
    kl, kr = enc.encode([left]), enc.encode([right])
    K = max(enc.num_groups, 1)
    M = int((np.bincount(kl, minlength=K) * np.bincount(kr, minlength=K)).sum())
    out = []
    for ids, pad in ((kl, K), (kr, K + 1)):
        b, nblk = block_geometry(len(ids), 1, BLOCK_ROWS)
        keys = np.full(b * nblk, pad, np.int32)
        keys[: len(ids)] = ids
        out.append(torch.from_numpy(keys).to(dev))
    return out[0], out[1], K, M, _pow2_at_least(max(M, 1))


def config8_join_keys(dev) -> tuple:
    """Config 8's standalone join as the sort-merge lane stages it: the 16
    services as the build side, padded to 256 rows with key K, and 4,000,000
    probe rows padded to 4,194,304 (2^21-row blocks) with key K + 1, one
    match each. Returns (build keys, probe keys, K, the probe side's f64
    latency column as numpy), the keys int32 on ``dev``."""
    rng = np.random.default_rng(46)
    n_real, n = JOIN_ROWS, 2 * BLOCK_ROWS
    svc_idx = rng.integers(0, N_SERVICES, n_real).astype(np.int32)
    latency = np.zeros(n)
    latency[:n_real] = rng.exponential(3e7, n_real)
    nb, K = 256, N_SERVICES
    lkey = torch.tensor(list(range(K)) + [K] * (nb - K), dtype=torch.int32, device=dev)
    rkey = np.full(n, K + 1, np.int32)
    rkey[:n_real] = svc_idx
    return lkey, torch.from_numpy(rkey).to(dev), K, latency


def join_kernel_phase(dev) -> dict:
    """H13, H14, H15 and H12's compaction of unmatched row indices against
    their plain versions on the card, bit for bit, on the slots below the
    match count: first edge cases (many-to-many keys, fanout 0 and a large
    fanout, padded rows, a cap exactly at the count; fanouts in the
    thousands between fanout-0 rows; one row of more than 2^20 pairs)
    through all four join types' sections, then config 8's shapes, where the
    kernels are timed: the 16-row build side padded to 256, 4,000,000 probe
    rows padded to 4,194,304 (2^21-row blocks), one match each, cap_m
    4,194,304 (H13 checked in its table lane, as local_sort_merge calls it,
    with its widest table, and in its search lane, and timed in the first and
    the last); H15 on the f64 latency column; H12 on the OUTER join's
    unmatched probe rows (the two services svc_owners_partial does not own);
    then H13, with a LEFT join's presence, and H14 at join8_left_agg's shape
    (``join_left_agg_keys``: 14 of 256 probe rows own about 250,000 pairs
    each)."""
    from pixie_tpu_torch.ops import kernels, scan, segment

    K = 40
    for seed, nb, n_probe, pad_b, pad_p in ((0, 256, 3001, 37, 5), (1, 7, 1, 0, 0),
                                            (2, 5000, 20000, 1000, 0), (24, 1 << 15, 12, 100, 2)):
        host = [torch.from_numpy(a) for a in join_edge_keys(seed, nb, n_probe, K, pad_b, pad_p)]
        card = [t.to(dev) for t in host]
        _, fanout, _ = segment.join_probe_plain(torch.sort(host[0], stable=True)[0], host[1])
        M = int(fanout.sum())
        for cap_r, cap_l in ((0, 0), (0, 64), (4096, 0), (4096, 1024)):  # INNER, LEFT, RIGHT, OUTER
            got = segment.local_sort_merge(*card, M, cap_r, cap_l, K)
            want = segment.local_sort_merge(*host, M, cap_r, cap_l, K)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                check((g is None) == (w is None) and (g is None or torch.equal(g.cpu(), w)),
                      f"join edge case {seed} caps {cap_r},{cap_l}: kernel path != plain")
            rng = np.random.default_rng(seed)
            col = torch.from_numpy(rng.integers(0, 256, nb).astype(np.uint8))
            for side in (0, 1):
                secs = ([(want[0], M), (None, cap_r), (want[4], cap_l)] if side == 0
                        else [(want[1], M), (want[3], cap_r), (None, cap_l)])
                g = kernels.join_gather(col.to(dev), [(i.to(dev) if i is not None else None, r)
                                                      for i, r in secs], 5, -1)
                w = segment.join_gather_plain(col, secs, 5, -1)
                check(torch.equal(g.cpu(), w), f"H15 edge case {seed} side {side}: differs")
    # One probe row of more than 2^20 pairs between rows of none and of a few.
    rng = np.random.default_rng(7)
    nb = (1 << 20) + 5000
    lk = np.where(rng.random(nb) < 0.998, 0, rng.integers(1, 4, nb)).astype(np.int32)
    host = [torch.from_numpy(lk), torch.tensor([2, 5, 0, 5, 3, 1, 0], dtype=torch.int32),
            torch.ones(nb, dtype=torch.bool), torch.ones(7, dtype=torch.bool)]
    _, fanout, _ = segment.join_probe_plain(torch.sort(host[0], stable=True)[0], host[1])
    M = int(fanout.sum())
    check(int(fanout.max()) > 1 << 20, "join edge case: no row above 2^20 pairs")
    for cap_m in (M, 1 << 20):  # the count, and a cap through the first heavy row
        got = segment.local_sort_merge(*[t.to(dev) for t in host], cap_m, 8, 16, 6)
        want = segment.local_sort_merge(*host, cap_m, 8, 16, 6)
        torch.cuda.synchronize()
        S = min(M, cap_m)
        check(torch.equal(got[0][:S].cpu(), want[0][:S]) and torch.equal(got[1][:S].cpu(),
                                                                        want[1][:S])
              and all(torch.equal(g.cpu(), w) for g, w in zip(got[2:], want[2:])),
              f"join edge case: a row of {int(fanout.max())} pairs, cap {cap_m}: kernel != plain")
    log("H13/H14/H12 (via local_sort_merge) and H15: edge cases (many-to-many, fanout 0, "
        "a large fanout, padded rows, cap at the count, fanouts in the thousands between "
        f"fanout-0 rows, one row of {int(fanout.max())} pairs with caps at and below the count), "
        "INNER/LEFT/RIGHT/OUTER, bit for bit")

    # Config 8's shapes.
    lkey, rkey, K, latency = config8_join_keys(dev)
    nb, n, n_real = lkey.shape[0], rkey.shape[0], JOIN_ROWS
    sk, order = torch.sort(lkey, stable=True)
    order = order.to(torch.int32)
    want = segment.join_probe_plain(sk, rkey, K + 2)
    # The table lane (local_sort_merge's call), its widest table (4,194,304
    # probe rows are enough), and the search lane (a key space above the
    # table, or none).
    for ks, lane in ((K + 2, "table"), (kernels.JOIN_TABLE_IDS, "table"),
                     (kernels.JOIN_TABLE_IDS + 1, "search"), (0, "search")):
        check(kernels.join_probe_geometry(n, ks)[3] == lane,
              f"H13 config 8, key space {ks}: not the {lane} lane")
        got = kernels.join_probe(sk, rkey, K + 2, ks)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"H13 config 8, key space {ks}: differs")
    lo, fanout, _ = want
    prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
    M = int(prefix[-1])
    check(M == n_real, f"config 8: {M} matches, expected {n_real}")
    cap = 1 << (M - 1).bit_length()
    wb, wp = segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap)
    gb, gp = kernels.join_emit_pairs(lo, fanout, prefix, order, cap)
    torch.cuda.synchronize()
    check(torch.equal(gb[:M], wb[:M]) and torch.equal(gp[:M], wp[:M]), "H14 config 8: differs")
    col = torch.from_numpy(latency).to(dev)
    secs = [(wp, cap), (None, 0), (None, 0)]
    g = kernels.join_gather(col, secs, None, 0)
    w = segment.join_gather_plain(col, secs, None, 0)
    torch.cuda.synchronize()
    check(bits_equal(g, w), "H15 config 8 latency: differs")
    log(f"H13/H14/H15 at config 8's shapes (build {nb} rows, probe {n} rows, cap_m {cap}): "
        "bit for bit")
    log2 = max(nb, 1).bit_length()
    # probe keys read, lo and fanout written; the build keys read where a
    # search reads them, at most once each; two binary searches of log2(nb)
    # + 1 compares a row
    probe_bound = bound(n * 12 + min(nb, 2 * log2 * n) * 4, 2 * log2 * n)
    records = {
        "join_probe": record(
            lambda: kernels.join_probe(sk, rkey, 0, K + 2),
            lambda: segment.join_probe_plain(sk, rkey),
            lambda: (torch.searchsorted(sk, rkey), torch.searchsorted(sk, rkey, right=True)),
            *probe_bound, 0.0, f"build keys[{nb}] probe keys[{n}] key space {K + 2} (table lane)",
        ),
        "join_emit_pairs": record(
            lambda: kernels.join_emit_pairs(lo, fanout, prefix, order, cap),
            lambda: segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap),
            None,  # repeat_interleave gives the probe rows, not the build rows
            # lo, fanout, prefix read, the build order read where a slot reads
            # it (at most min(nb, M) entries), M pairs written
            *bound(n * 12 + min(nb, M) * 4 + M * 8, M), 0.0,
            f"probe rows[{n}] M {M} cap {cap}",
        ),
        "join_gather": record(
            lambda: kernels.join_gather(col, secs, None, 0),
            lambda: segment.join_gather_plain(col, secs, None, 0),
            lambda: torch.index_select(col, 0, wp),
            # the index read, the column read once, the output written
            *bound(cap * 4 + n * 8 + cap * 8, 0), 0.0,
            f"f64 column[{n}] matched section[{cap}]",
        ),
    }
    rec = records["join_probe"]
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.join_probe_geometry(n, K + 2)[:3]))
    rec["by_search_lane"] = {
        "ms": time_ms(lambda: kernels.join_probe(sk, rkey)),
        "floor_ms": time_ms(lambda: kernels.empty_launch(
            dev, *kernels.join_probe_geometry(n, 0)[:3])),
        "bound_ms": probe_bound[0], "bound_by": probe_bound[1],
    }
    rec = records["join_emit_pairs"]
    geo = kernels.join_emit_pairs_geometry(n, nb, cap)
    rec["shape"] += f" ({geo[3]} lane)"
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, *geo[:3]))
    log(f"H13 config 8: table lane {records['join_probe']['ms']:.5f} ms (floor "
        f"{records['join_probe']['floor_ms']:.5f}), search lane "
        f"{records['join_probe']['by_search_lane']['ms']:.5f} (floor "
        f"{records['join_probe']['by_search_lane']['floor_ms']:.5f}); bound {probe_bound[0]:.5f}; "
        f"H14 {geo[3]} lane {rec['ms']:.5f} ms (floor {rec['floor_ms']:.5f}); "
        f"bound {rec['bound_ms']:.5f}")
    # H12 over the row indices of the OUTER join's unmatched probe rows.
    owned = [i for i in range(N_SERVICES) if i not in UNOWNED]
    lkey = torch.tensor(owned + list(range(K, K + 4)) + [K + 4] * (nb - 18),
                        dtype=torch.int32, device=dev)
    rkey = torch.where(rkey <= K, rkey, K + 5)
    _, fanout, _ = segment.join_probe(torch.sort(lkey, stable=True)[0], rkey)
    rmask = torch.arange(n, device=dev) < n_real
    unmatched = rmask & (fanout == 0)
    UR = int(unmatched.sum())
    cap_r = 1 << (UR - 1).bit_length()
    got = segment.compact_unmatched_rows(unmatched, cap_r)
    want = scan.compact_indices_plain(unmatched, cap_r)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "H12 unmatched-row compaction: differs")
    call = lambda: segment.compact_unmatched_rows(unmatched, cap_r)
    h12 = record(
        lambda: kernels.scan_compact_indices(unmatched, cap_r),
        lambda: scan.compact_indices_plain(unmatched, cap_r),
        lambda: torch.nonzero(unmatched),
        # the mask read once, the output (indices, then padding) written once
        *bound(n + 4 * cap_r, n), 0.0,
        f"mask[{n}] {UR} unmatched, cap_r {cap_r} (the index lane)",
    )
    h12["call_ms"] = time_ms(call)
    h12["call_device_ops"] = device_ops(call)
    h12["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.scan_compact_geometry(dev, n)))
    records["scan_compact_unmatched"] = h12
    log(f"H12 unmatched-row compaction at config 8 OUTER ({UR} of {n} probe rows, cap_r "
        f"{cap_r}, the index lane): bit for bit; ms {h12['ms']} plain_ms {h12['plain_ms']} "
        f"library_ms (nonzero) {h12['library_ms']} bound_ms {h12['bound_ms']} "
        f"({h12['bound_by']}) floor_ms {h12['floor_ms']}; compact_unmatched_rows "
        f"{h12['call_ms']} ms, device operations {h12['call_device_ops']}")
    # H14 (and H13, the lane's call) at join8_left_agg's shape.
    lkey, rkey, K, M, cap = join_left_agg_keys(dev)
    nb, n = lkey.shape[0], rkey.shape[0]
    sk, order = torch.sort(lkey, stable=True)
    order = order.to(torch.int32)
    # A LEFT join: local_sort_merge asks H13 for the presence of [0, K + 2).
    lo, fanout, present = kernels.join_probe(sk, rkey, K + 2, K + 2)
    want = segment.join_probe_plain(sk, rkey, K + 2)
    check(all(torch.equal(g, w) for g, w in zip((lo, fanout, present), want)),
          "H13 join8_left_agg: differs")
    prefix = torch.cumsum(fanout, 0, dtype=torch.int32)
    check(int(prefix[-1]) == M, f"join8_left_agg: {int(prefix[-1])} matches, expected {M}")
    gb, gp = kernels.join_emit_pairs(lo, fanout, prefix, order, cap)
    wb, wp = segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap)
    torch.cuda.synchronize()
    check(torch.equal(gb[:M], wb[:M]) and torch.equal(gp[:M], wp[:M]),
          "H14 join8_left_agg: differs")
    left = record(
        lambda: kernels.join_emit_pairs(lo, fanout, prefix, order, cap),
        lambda: segment.join_emit_pairs_plain(lo, fanout, prefix, order, cap), None,
        # lo, fanout, prefix read, the build order read where a slot reads it
        # (each owning probe row has its own key's run: min(nb, M) entries),
        # M pairs written
        *bound(n * 12 + min(nb, M) * 4 + M * 8, M), 0.0,
        f"build rows[{nb}] probe rows[{n}] K {K} M {M} cap {cap}, max fanout "
        f"{int(fanout.max())}",
    )
    geo = kernels.join_emit_pairs_geometry(n, nb, cap)
    left["shape"] += f" ({geo[3]} lane)"
    left["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, *geo[:3]))
    left["join_probe_ms"] = time_ms(lambda: kernels.join_probe(sk, rkey, K + 2, K + 2))
    left.pop("max_abs_err")
    records["join_emit_pairs"]["by_join8_left_agg"] = left
    log(f"H14 at join8_left_agg's shape ({left['shape']}): bit for bit; {left['ms']:.5f} ms "
        f"(floor {left['floor_ms']:.5f}) [bound {left['bound_ms']:.5f}; plain "
        f"{left['plain_ms']:.5f}]; H13 there, with presence, {left['join_probe_ms']:.5f} ms")
    return records


def join_agg_case(dev, seed: int, n: int, K: int, cap: int, jk, gids, mask, n_right, left, right,
                  jk_offset: int = 0):
    """H16 against its plain version on the card: the count row and the
    effective mask exact, every sum within 1e-12 * sum |terms| of its cell
    (H2's bound), and up to 64 groups the same bits in two launches.
    ``jk`` and ``gids`` as the fold stages them (``jk`` plus ``jk_offset``
    is the key). Returns (kernel acc, max abs difference of the sums)."""
    from pixie_tpu_torch.ops import kernels, segment

    rows = 1 + left.shape[0] + right.shape[0]
    got = torch.zeros((rows, cap), dtype=torch.float64, device=dev)
    again, want, mag = torch.zeros_like(got), torch.zeros_like(got), torch.zeros_like(got)
    eff_got = torch.empty(n, dtype=torch.bool, device=dev)
    eff_want = torch.empty_like(eff_got)
    key = segment.Narrow(jk, jk_offset)
    kernels.join_agg_fold(jk, gids, mask, n_right, left, right, got, eff_got, jk_offset=jk_offset)
    kernels.join_agg_fold(jk, gids, mask, n_right, left, right, again, jk_offset=jk_offset)
    segment.join_agg_fold_plain(key, gids, mask, n_right, left, right, want, eff_want)
    segment.join_agg_fold_plain(key, gids, mask, n_right, left.abs(), right.abs(), mag)
    torch.cuda.synchronize()
    what = f"H16 seed {seed} (K {K}, cap {cap})"
    check(torch.equal(eff_got, eff_want), f"{what}: effective mask differs")
    check(torch.equal(got[0], want[0]), f"{what}: count row differs")
    check(bool(torch.isfinite(got).all()), f"{what}: a non-finite sum")
    err = (got - want).abs()
    check(bool(torch.all(err <= 1e-12 * mag)), f"{what}: a sum outside 1e-12 * sum|terms|")
    if cap <= kernels.H2_WARP_MAX_S:
        check(torch.equal(got.view(torch.int64), again.view(torch.int64)),
              f"{what}: two launches gave different bits")
    return got, float(err.max())


def join_agg_kernel_phase(dev) -> dict:
    """H16 against its plain version on the card, ``jk`` and ``gids`` as the
    fold stages them: (a) join8_oncall_agg's block, 2^21 rows of join_fact
    keyed by service (K 16, 16 groups; keys and gids uint8), the f64
    latency weighted by the on-call rows of each service (0-3) and one
    gathered right sum (the seats), the private lane; (a2) the same rows
    with the keys as a uint16 column offset by 1000 over K 300, and over 64
    groups with two left sums (the warp lane); (b) K 2^20 keys (int32) and
    2^16 groups (uint16), weights 0-5 and a random mask, the global lane.
    Masked and zero-weight rows carry +-inf and NaN at (b). Timed at (a)
    beside an empty kernel on its grid, with CTA 0's phases, the call's
    device operations (the staged columns handed over against the widening,
    casts and stack the fold ran before) and the index_select + index_add_
    sequence of the reference's formula as the library yardstick."""
    from pixie_tpu_torch.ops import kernels, segment

    n = BLOCK_ROWS
    rng = np.random.default_rng(46)
    svc = rng.integers(0, N_SERVICES, n)
    seats = np.array([sum(1 + (i + j) % 5 for j in range(i % 4)) for i in range(N_SERVICES)])
    a = [torch.from_numpy(x).to(dev) for x in (
        svc.astype(np.uint8), svc.astype(np.uint8), np.ones(n, dtype=bool),
        np.arange(N_SERVICES) % 4.0, rng.exponential(3e7, (1, n)),
        seats[None, :].astype(np.float64),
    )]
    _, err_a = join_agg_case(dev, 46, n, N_SERVICES, N_SERVICES, *a)
    K2 = 300
    keys2 = rng.integers(0, K2, n)
    a2 = [torch.from_numpy(x).to(dev) for x in (
        (keys2 + 1000).astype(np.uint16), svc.astype(np.uint8), rng.random(n) < 0.9,
        rng.integers(0, 4, K2).astype(np.float64), rng.exponential(3e7, (1, n)),
        rng.exponential(3e7, (1, K2)),
    )]
    _, err_a2 = join_agg_case(dev, 48, n, K2, N_SERVICES, *a2, jk_offset=-1000)
    a3 = [a2[0], torch.from_numpy(rng.integers(0, 64, n).astype(np.uint8)).to(dev), a2[2],
          a2[3], torch.from_numpy(rng.exponential(3e7, (2, n))).to(dev), a2[5]]
    _, err_a3 = join_agg_case(dev, 49, n, K2, 64, *a3, jk_offset=-1000)
    K, cap = 1 << 20, 1 << 16
    jk = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    n_right = rng.integers(0, 6, K).astype(np.float64)
    left = rng.exponential(3e7, (1, n))
    dead = ~mask | (n_right[jk] == 0)
    left[0, dead] = rng.choice([np.inf, -np.inf, np.nan], int(dead.sum()))
    b = [torch.from_numpy(x).to(dev) for x in (
        jk, rng.integers(0, cap, n).astype(np.uint16), mask, n_right, left,
        rng.exponential(3e7, (1, K)),
    )]
    _, err_b = join_agg_case(dev, 47, n, K, cap, *b)
    log(f"H16 join_agg_fold: (a) K {N_SERVICES} cap {N_SERVICES} S_l 1 S_r 1 (uint8 keys and "
        f"gids), (a2) uint16 keys offset by 1000 over K {K2}, over 64 groups with S_l 2, and "
        f"(b) K {K} cap {cap}, {n} rows each: count rows and effective masks exact, sums "
        f"within 1e-12 * sum|terms| (max abs diff {err_a:.3g}, {err_a2:.3g}, {err_a3:.3g}, "
        f"{err_b:.3g}), the same bits in two launches up to 64 groups")

    def timed_case(ins, cap_):
        jk_, gids_, mask_, nr_, left_, right_ = ins
        acc = torch.zeros((1 + left_.shape[0] + right_.shape[0], cap_), dtype=torch.float64,
                          device=dev)
        eff = torch.empty(n, dtype=torch.bool, device=dev)
        jk64, g64 = jk_.long(), gids_.long()

        def library():
            w = torch.index_select(nr_, 0, jk64)
            wm = torch.where(mask_ & (w > 0), w, 0.0)
            acc[0].index_add_(0, g64, wm)
            acc[1].index_add_(0, g64, left_[0] * wm)
            acc[2].index_add_(0, g64, torch.where(wm > 0, torch.index_select(right_[0], 0, jk64),
                                                  0.0))

        K_ = nr_.shape[0]
        # the staged keys and gids, the mask and the left rows read once, the
        # effective mask written once, the statistics read once, the sums
        # read and written once
        nbytes = n * (jk_.element_size() + gids_.element_size() + 1 + 8 * left_.shape[0] + 1) \
            + 8 * K_ * (1 + right_.shape[0]) + 16 * acc.numel()
        ops = n * (1 + 2 * left_.shape[0] + right_.shape[0])
        rec = record(
            lambda: kernels.join_agg_fold(jk_, gids_, mask_, nr_, left_, right_, acc, eff),
            lambda: segment.join_agg_fold_plain(jk_, gids_, mask_, nr_, left_, right_, acc, eff),
            library, *bound(nbytes, ops), 0.0, "",
        )
        geo = kernels.join_agg_fold_geometry(dev, n, acc.shape[0], cap_, K_, right_.shape[0])
        rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, *geo[:3]))
        rec["lane"] = geo[3]
        return rec, acc, eff

    rec, acc, eff = timed_case(a, N_SERVICES)
    rec.update(max_abs_err=err_a, shape=f"rows[{n}] K {N_SERVICES} cap {N_SERVICES} S_l 1 S_r 1, "
               f"keys and gids uint8 ({rec['lane']} lane)")
    probe = torch.zeros(kernels.JOIN_AGG_PROBE, dtype=torch.int64, device=dev)
    kernels.join_agg_fold(*a[:6], acc, eff, probe=probe)
    rec["block_cta0_phases_us"] = probe_phases_us(probe, ("load", "fold", "combine"), 0,
                                                  kernels.sm_clock_khz(dev))
    jk8, g8, mask8, nr8, left8, right8 = a
    rows8 = list(left8)

    def widening_call():  # the fold's steps of a block before H16 read rows as staged
        j = (jk8.to(torch.int64) + 0).to(torch.int32)
        kernels.join_agg_fold(j, g8.to(torch.int32), mask8, nr8, torch.stack(rows8), right8,
                              acc, eff)

    rec["block_ops_before"] = device_ops(widening_call)
    rec["block_ops_after"] = device_ops(lambda: segment.join_agg_fold(
        segment.Narrow(jk8, 0), g8, mask8, nr8, rows8, right8, acc, eff))
    check(rec["block_ops_after"] == {"kernels": 1, "memsets_copies": 0},
          f"H16's call is not one device operation: {rec['block_ops_after']}")
    rec_b, _, _ = timed_case(b, cap)
    rec["by_case_b"] = {k: rec_b[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by", "floor_ms", "lane")}
    log(f"H16 at (a): {rec['ms']:.5f} ms (floor {rec['floor_ms']:.5f}, {rec['lane']} lane) "
        f"[bound {rec['bound_ms']:.5f}]; CTA 0's phases {rec['block_cta0_phases_us']} us; the "
        f"call's device operations {rec['block_ops_after']} (widening first: "
        f"{rec['block_ops_before']}); at (b) K {K} cap {cap}: {json.dumps(rec['by_case_b'])}")
    return {"join_agg_fold": rec}


def let_programs(dev, n: int):
    """H17's two programs of the kernel phase over one block of Q1-Q4's
    table staged as the main path stages it (codes and ints narrowed,
    H17 widening them on load): (a) Q1's predicate program (service != '',
    the health-check and unresolved-client filters, contains(service,
    'svc-1') through a bool LUT, all ANDed into the validity mask) with the
    failure output; (b) floor(latency / 1e6), log10(latency) and
    select(resp_status >= 400, resp_body_size, 0). Returns [(name, program,
    raw columns, offsets, aux, the trees, the evaluator)]."""
    from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
    from pixie_tpu_torch.parallel.staging import stage_columns
    from pixie_tpu_torch.plan.expressions import ColumnRef as C, Constant as K, FuncCall as Fn
    from pixie_tpu_torch.table.column import StringDictionary
    from pixie_tpu_torch.types import DataType as DT, Relation
    from pixie_tpu_torch.udf.builtins import register_all
    from pixie_tpu_torch.udf.registry import Registry

    reg = Registry()
    register_all(reg)
    ev = let_events(n)
    cols = {"service": ev["svc"], "req_path": ev["path"], "remote_addr": ev["addr"],
            "resp_status": ev["status"], "latency": ev["latency"], "resp_body_size": ev["body"]}
    staged = stage_columns(cols, n, dev, block_rows=n)
    raw = {c: t[0, 0] for c, t in staged.blocks.items()}
    raw["__valid__"] = staged.mask[0, 0]
    dicts = {}
    for c, values in let_dictionaries().items():
        dicts[c] = StringDictionary()
        dicts[c].encode(np.asarray(values, dtype=object))
    rel = Relation.of(("service", DT.STRING), ("req_path", DT.STRING), ("remote_addr", DT.STRING),
                      ("resp_status", DT.INT64), ("latency", DT.FLOAT64), ("resp_body_size", DT.INT64))
    s, i, f, b = (lambda v: K(v, DT.STRING)), (lambda v: K(v, DT.INT64)), \
        (lambda v: K(v, DT.FLOAT64)), (lambda v: K(v, DT.BOOLEAN))
    ne = lambda col, v: Fn("notEqual", (C(col), s(v)))
    preds = [
        ne("service", ""),
        Fn("logical_and", (Fn("logical_and", (Fn("logical_or", (ne("req_path", "/healthz"), b(False))),
                                              Fn("logical_or", (ne("req_path", "/readyz"), b(False))))),
                           Fn("logical_or", (ne("remote_addr", "-"), b(False))))),
        Fn("contains", (C("service"), s("svc-1"))),
    ]
    programs = {
        "a": ([("failure", Fn("greaterThanEqual", (C("resp_status"), i(400))))], preds),
        "b": ([("lat_ms", Fn("floor", (Fn("divide", (C("latency"), f(1e6))),))),
               ("log_lat", Fn("log10", (C("latency"),))),
               ("err_bytes", Fn("select", (Fn("greaterThanEqual", (C("resp_status"), i(400))),
                                           C("resp_body_size"), i(0))))], []),
    }
    out = []
    for name, (roots, pr) in programs.items():
        evr = ExpressionEvaluator(roots + [(f"pred{k}", p) for k, p in enumerate(pr)], rel, reg)
        aux = {}
        for _, e in evr.named_exprs:
            aux.update({k: torch.as_tensor(np.asarray(v), device=dev)
                        for k, v in evr.build_aux(e, dicts).items()})
        dtypes = {c.name: {DT.FLOAT64: torch.float64}.get(c.data_type, torch.int64) for c in rel}
        dtypes["__valid__"] = torch.bool
        prog = evr.compile_program([(k, e, None, None) for k, e in roots], dtypes, aux,
                                   mask=("__valid__", pr))
        out.append((name, prog, raw, staged.narrow_offsets, aux, roots, pr, evr))
    return out


H17_TILE_THREADS = 128  # scalar_kernels.cu kEvalThreads


def h17_tile(prog) -> int:
    """Rows of one H17 tile of ``prog``: kEvalThreads threads of R rows, R
    8 (4 with a long op), halved while the register file overflows 48 KB
    (scalar_kernels.cu)."""
    from pixie_tpu_torch.ops import scalar

    R = 4 if any(scalar.OPS[ins[0]] in scalar.LONG_OPS for ins in prog.code) else 8
    while R > 1 and max(prog.n_regs, 1) * R * H17_TILE_THREADS * 8 > 48 * 1024:
        R //= 2
    return R * H17_TILE_THREADS


def scalar_edge_programs(dev, n: int) -> list:
    """H17's edge programs over seeded columns of every kind on ``dev``:
    (i) comparisons, a select whose third operand comes from the register
    file, an int64 LUT gather and bool, int32 and int64 stores over bool,
    uint8, uint16, int32 and int64 columns; (ii) a tree that uses all 32
    registers over f32 and f64 columns, into an f64 output; (iii) ops run
    out of line (int64 modulo, f64 division and log10: 4 rows a thread). The uint16 and
    int64 columns sit one element into their buffers (unaligned). Returns
    [(program, env, aux)]."""
    from pixie_tpu_torch.exec.expression_evaluator import ExpressionEvaluator
    from pixie_tpu_torch.ops import scalar
    from pixie_tpu_torch.plan.expressions import ColumnRef as C, Constant as K, FuncCall as Fn
    from pixie_tpu_torch.types import DataType as DT, Relation
    from pixie_tpu_torch.udf.builtins import register_all
    from pixie_tpu_torch.udf.registry import Registry

    reg = Registry()
    register_all(reg)
    rng = np.random.default_rng(29)

    def unaligned(a: np.ndarray) -> torch.Tensor:
        buf = torch.empty(n + 1, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
        buf[1:] = torch.from_numpy(a).to(dev)
        return buf[1:]

    env = {
        "flag": torch.from_numpy(rng.random(n) < 0.5).to(dev),
        "u8": torch.from_numpy(rng.integers(0, 255, n).astype(np.uint8)).to(dev),
        "u16": unaligned(rng.integers(0, 65535, n).astype(np.uint16)),
        "code": torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(dev),
        "big": unaligned(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)),
        "f32": torch.from_numpy(rng.exponential(3e7, n).astype(np.float32)).to(dev),
        "x": torch.from_numpy(rng.uniform(-30, 30, n)).to(dev),
    }
    rel = Relation.of(("flag", DT.BOOLEAN), ("u8", DT.INT64), ("u16", DT.INT64),
                      ("code", DT.INT64), ("big", DT.INT64), ("f32", DT.FLOAT64),
                      ("x", DT.FLOAT64))
    i, f = (lambda v: K(v, DT.INT64)), (lambda v: K(v, DT.FLOAT64))
    edge = {
        "lt": Fn("lessThan", (C("big"), i(0))),
        "sel": Fn("select", (Fn("greaterThan", (C("u8"), i(100))), Fn("negate", (C("u16"),)),
                             C("big"))),
        "mix": Fn("logical_and", (C("flag"), Fn("notEqual", (C("code"), i(7))))),
        "code32": Fn("add", (C("code"), C("u8"))),
    }
    deep = C("x")
    for k in range(scalar.MAX_REGS - 1):  # every product live until the sums close
        deep = Fn("add", (Fn("multiply", (C("f32"), f(k + 0.5))), deep))
    long = {"mod": Fn("modulo", (C("big"), C("code"))),
            "q": Fn("divide", (C("x"), C("f32"))), "lg": Fn("log10", (C("f32"),))}
    dtypes = {k: v.dtype for k, v in env.items()}
    out = []
    for roots, extra in ((edge, [("g", C("code"), None, "lut_i64")]), ({"deep": deep}, []),
                         (long, [])):
        ev = ExpressionEvaluator(list(roots.items()), rel, reg)
        aux = {"lut_i64": torch.from_numpy(rng.integers(-(2**62), 2**62, 33)).to(dev)}
        rts = [(k, e, torch.int32 if k == "code32" else None, None) for k, e in roots.items()]
        out.append((ev.compile_program(rts + extra, dtypes, aux), env, aux))
    check(out[1][0].n_regs == scalar.MAX_REGS, "H17 edges: the deep program's 32 registers")
    return out


def scalar_edges(dev) -> list:
    """H17 bit for bit against its plain interpreter on ``scalar_edge_
    programs`` at 1 row, at a tile less and more one row (the ragged
    tail) for each program's register depth, and at 2^21 rows, with a
    frame-of-reference offset on every column (added to the ints only)."""
    from pixie_tpu_torch.ops import scalar

    tiles = {h17_tile(prog) for prog, _, _ in scalar_edge_programs(dev, 1)}
    sizes = sorted({1, BLOCK_ROWS} | {t + d for t in tiles for d in (-1, 1)})
    for n in sizes:
        for prog, env, aux in scalar_edge_programs(dev, n):
            offs = {c: 1000 + 7 * k for k, c in enumerate(env)}
            got = prog.run(env, aux, n, raw=env, offsets=offs)
            want = scalar.eval_plain(prog, [env[c] for c in prog.columns],
                                     [aux[k] for k in prog.luts], n,
                                     [offs[c] for c in prog.columns])
            torch.cuda.synchronize()
            for (name, _), w in zip(prog.outputs, want):
                if name == "lg":  # an f64 transcendental: within 2 ulp
                    same = (got[name] == w) | (torch.isnan(got[name]) & torch.isnan(w))
                    gap = (got[name].view(torch.int64) - w.view(torch.int64))[~same].abs()
                    check(gap.numel() == 0 or int(gap.max()) <= 2, f"H17 edge log10, {n} rows")
                    continue
                check(got[name].shape == (n,) and bits_equal(got[name], w),
                      f"H17 edge ({name}, {n} rows, {prog.n_regs} registers): not bit-equal")
    return sizes


def h17_instruction_ms(dev, raw: dict, offs: dict) -> float:
    """H17's cost of one interpreted instruction at 2^21 rows: two programs
    over the let table's uint8 service codes, 8 and 32 alternating
    instructions (!= 1, then AND with true) after one LOAD and before
    one bool STORE (each value read from the accumulator, no register file
    traffic), each held bit for bit against the plain interpreter; the
    difference of their times over 24."""
    from pixie_tpu_torch.ops import scalar

    op = scalar.OP
    times = []
    for k in (8, 32):
        code = [[op["LOAD"], 0, 0, 0, 0], [op["CONST"], 1, 0, 1, 0]]
        code += [[op["NE_I"] if i % 2 == 0 else op["AND"], 0, 0, 1, 0] for i in range(k)]
        code += [[op["STORE"], 0, 0, 0, 0]]
        prog = scalar.ScalarProgram(code=code, consts=[1], columns=["service"], luts=[],
                                    outputs=[("o", torch.bool)], n_regs=2)
        run = lambda: prog.run({"__valid__": raw["__valid__"]}, {}, BLOCK_ROWS, raw=raw, offsets=offs)
        want = scalar.eval_plain(prog, [raw["service"]], [], BLOCK_ROWS, [int(offs.get("service", 0))])
        check(bits_equal(run()["o"], want[0]), f"H17 {k}-instruction chain: not bit-equal")
        times.append(time_ms(run))
    return (times[1] - times[0]) / 24


def scalar_kernel_phase(dev) -> dict:
    """H17 against its plain interpreter on the card at 2^21 rows over the
    two programs of ``let_programs``: bool and int outputs bit for bit,
    floor and select too, log10 within 2 ulp (PERF.md's H17 contract).
    Timed: H17, the plain interpreter (the same instructions as torch ops)
    and the tree of torch ops it replaces (each narrowed column widened,
    then one torch call per node: device_eval). No one PyTorch call
    computes an expression tree, so library_ms is null; the torch tree's
    time stands beside it."""
    from pixie_tpu_torch.ops import kernels, scalar

    n = BLOCK_ROWS
    rec = {}
    for name, prog, raw, offs, aux, roots, preds, evr in let_programs(dev, n):
        cols = [raw[c] for c in prog.columns]
        offsets = [int(offs.get(c, 0)) for c in prog.columns]
        luts = [aux[k] for k in prog.luts]

        def h17():
            return prog.run({"__valid__": raw["__valid__"]}, aux, n, raw=raw, offsets=offs)

        def plain():
            return scalar.eval_plain(prog, cols, luts, n, offsets)

        def tree():
            env = {c: (t.to(torch.int64) + offs[c] if c in offs else t) for c, t in raw.items()}
            out = {}
            if preds:
                m = env["__valid__"]
                for p in preds:
                    m = m & evr.device_eval(p, env, aux)
                out["__mask__"] = m
            for k, e in roots:
                out[k] = torch.as_tensor(evr.device_eval(e, env, aux))
            return out

        before = kernels.LAUNCHES["scalar_eval"]
        got = h17()
        check(kernels.LAUNCHES["scalar_eval"] == before + 1, "H17 counts one launch a run")
        want = dict(zip([o for o, _ in prog.outputs], plain()))
        walk = tree()
        torch.cuda.synchronize()
        err, ulp = 0.0, 0
        for k, w in want.items():
            g = got[k]
            check(g.dtype == w.dtype, f"H17 ({name}) {k}: dtype")
            if k == "log_lat":
                same = (g == w) | (torch.isnan(g) & torch.isnan(w))
                gi, wi = g.view(torch.int64)[~same], w.view(torch.int64)[~same]
                ulp = int((gi - wi).abs().max()) if gi.numel() else 0
                check(ulp <= 2, f"H17 ({name}) log10: {ulp} ulp from the plain version")
                err = max(err, float((g - w).abs().max()))
            else:
                check(bits_equal(g, w), f"H17 ({name}) {k}: not bit-equal to the plain version")
            tw = walk[k].to(w.dtype)
            check(bits_equal(tw, w) or k == "log_lat", f"H17 ({name}) {k}: plain vs torch tree")
        if "__mask__" in want:
            kept = int(want["__mask__"].sum())
            check(0 < kept < n, f"H17 ({name}): mask keeps {kept} rows")
        in_bytes = sum(c.numel() * c.element_size() for c in cols)
        out_bytes = sum(t.numel() * t.element_size() for t in want.values())
        ops = n * sum(1 for ins in prog.code
                      if scalar.OPS[ins[0]] not in ("LOAD", "CONST", "STORE"))
        r = record(h17, plain, None, *bound(in_bytes + out_bytes, ops), err,
                   f"program ({name}): {len(prog.code)} instructions, {len(cols)} columns "
                   f"{[str(c.dtype).replace('torch.', '') for c in cols]}, {len(prog.outputs)} "
                   f"outputs, {n} rows")
        r["torch_tree_ms"] = time_ms(tree)
        r["library_ms_note"] = "none: an expression tree is several torch calls"
        r["log10_ulp"] = ulp
        log(f"H17 scalar_eval ({name}): {r['shape']}: {r['ms']:.4f} ms (host-paced "
            f"{r['host_paced_ms']:.4f}), plain {r['plain_ms']:.4f}, torch tree "
            f"{r['torch_tree_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']}, "
            f"{in_bytes + out_bytes} B); bit-equal but log10 ({ulp} ulp)")
        rec[name] = r
    per_ins = h17_instruction_ms(dev, raw, offs)  # the block the programs ran on
    log(f"H17 one interpreted instruction over {n} rows (8 against 32 compare/AND "
        f"instructions): {per_ins:.5f} ms")
    sizes = scalar_edges(dev)
    log(f"H17 edges: a select's third operand from the register file, bool/int32/int64 "
        f"stores, unaligned columns, offsets on every column, 32 registers, out-of-line ops; "
        f"bit-equal (log10 within 2 ulp) at {sizes} rows")
    main = dict(rec["a"], by_instruction_ms=per_ins)
    for k, v in rec["b"].items():
        main[f"b_{k}"] = v
    return {"scalar_eval": main}


def rle_payload(rng, d: int, L: int, runs: list, dtype, R: Optional[int] = None) -> dict:
    """An RLE payload as ``codec.encode_window`` lays it out: values (as
    bytes) [d, R * width] and int32 ends [d, R] of d shards of L rows, shard
    s in runs[s] runs of random lengths whose neighbours differ, padded to R
    runs (default the most runs) with ends L."""
    R = R or max(runs)
    w = np.dtype(dtype).itemsize
    values = np.zeros((d, R * w), np.uint8)
    ends = np.full((d, R), L, np.int32)
    for s, r in enumerate(runs):
        ends[s, : r - 1] = np.sort(rng.choice(np.arange(1, L), r - 1, replace=False))
        raw = rng.integers(0, 1 << 63, r, dtype=np.uint64)
        if w == 1:
            raw = np.cumsum(1 + rng.integers(0, 255, r)).astype(np.uint64) & 0xFF
        values[s, : r * w] = raw.view(np.uint8).reshape(r, 8)[:, :w].reshape(-1)
    return dict(values=values, ends=ends, L=L, dtype=np.dtype(dtype).name, runs=np.array(runs))


def rle_worst_payload(rng, d: int, L: int, dtype) -> dict:
    """The codec's worst admitted RLE shape for ``d`` shards of L rows of
    ``dtype``: the largest run cap ``codec.plan_codec_local`` still ships as
    RLE under the ``staging_codec_min_ratio`` flag (runs_cap * (w + 4) *
    ratio <= L * w: about L / 2.3 for 8-byte blocks, L / 8 for 1-byte ones),
    every shard holding cap - 2 runs (the plan's slack), planned and encoded
    by the codec itself (``rle_payload``'s keys)."""
    from pixie_tpu_torch.ops import codec
    from pixie_tpu_torch.utils import flags

    w = np.dtype(dtype).itemsize
    ratio = float(flags.staging_codec_min_ratio)
    c = int(L * w / (ratio * (w + 4)))
    step = 1 << max((c - 1).bit_length() - 3, 0)
    cap = (c // step) * step  # the largest bucket_cap value <= c
    p = rle_payload(rng, d, L, [cap - 2] * d, dtype)
    # Each shard opens on the value the one before it closes on: a change at
    # a shard's trailing edge would count as one more run at plan time.
    vals = p["values"].reshape(d, cap - 2, w)
    for s in range(1, d):
        vals[s, 0] = vals[s - 1, -1]
        while (vals[s, 1] == vals[s, 0]).all() or (vals[s, 1] == vals[s, 2]).all():
            vals[s, 1, 0] += 1
    flat = np.empty((d, L), dtype)
    rows = flat.view(np.uint8).reshape(d, L, w)
    for s in range(d):
        rows[s] = vals[s][np.searchsorted(p["ends"][s], np.arange(L), side="right")]
    flat = flat.reshape(-1)
    nblk, b = max(L // BLOCK_ROWS, 1), min(L, BLOCK_ROWS)
    plan = codec.plan_codec_local(flat, d, nblk, b, d * L, ratio)
    check(plan is not None and plan.kind == "rle" and plan.runs_cap == cap,
          f"worst RLE shape {d}x{L} {dtype}: the codec plans {plan}, not rle at {cap} runs")
    values, ends = codec.encode_window(flat, plan, d * L).arrays
    return dict(values=values.view(np.uint8).reshape(d, -1), ends=ends, L=L,
                dtype=np.dtype(dtype).name, runs=np.full(d, cap - 2))


def codec_kernel_phase(dev) -> dict:
    """H18 and H19 against their plain versions on the card, bit for bit, at
    a full stream window (2^23 rows): H18 with 4096 runs in every block
    dtype (NaN payloads and -0.0 among the values) and at the codec's worst
    admitted int64 shape (``rle_worst_payload``: about 2.3 rows a run), H19
    for each delta dtype (nibbles, uint8, uint16) into every integer block
    dtype, then H19's edges (``delta_edges``). Timed at each dtype, H18
    beside an empty kernel on its grid; the records are uint16 for H18 (the
    sorted path's status column) and nibbles into int64 for H19
    (flow_window's time_)."""
    from pixie_tpu_torch.ops import codec, kernels

    rng = np.random.default_rng(18)
    L, R = 1 << 23, 4096
    records: dict = {}
    ends = np.sort(rng.choice(np.arange(1, L), R - 1, replace=False)).astype(np.int32)
    ends = torch.from_numpy(np.append(ends, L).astype(np.int32)[None, :]).to(dev)
    by_dtype = {}
    for dtype in (torch.uint8, torch.uint16, torch.int32, torch.int64, torch.float32,
                  torch.float64):
        w = torch.empty(0, dtype=dtype).element_size()
        raw = rng.integers(0, 1 << 63, R, dtype=np.uint64)
        raw[:3] = [0x7FF80000DEADBEEF, 1 << 63, 0x7FC0DEAD]  # f64 NaN, -0.0, f32 NaN
        values = torch.from_numpy(raw.view(np.uint8).reshape(R, 8)[:, :w].copy()
                                  .reshape(1, R * w)).view(dtype).to(dev)
        out, out2 = (torch.empty((1, L), dtype=dtype, device=dev) for _ in range(2))
        kernels.codec_rle_decode(values, ends, out)
        codec.rle_decode_plain(values, ends, out2)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.uint8), out2.view(torch.uint8)),
              f"H18 {dtype}: differs from the plain version")
        rec = record(
            lambda: kernels.codec_rle_decode(values, ends, out),
            lambda: codec.rle_decode_plain(values, ends, out2),
            None,
            # the values and ends read once, the block written once; a
            # compare a row places it in its run
            *bound(R * (w + 4) + L * w, L + R), 0.0,
            f"values[1,{R}] {dtype} -> [1,{L}]",
        )
        by_dtype[str(dtype).split(".")[1]] = rec["ms"]
        if dtype == torch.uint16:
            records["codec_rle_decode"] = rec
    rec = records["codec_rle_decode"]
    rec["by_dtype_ms"] = by_dtype
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.codec_rle_decode_geometry(1, L, 2)))
    probe = torch.zeros(kernels.RLE_PROBE, dtype=torch.int64, device=dev)
    values = torch.from_numpy(rng.integers(0, 1 << 16, R).astype(np.uint16)[None]).to(dev)
    kernels.codec_rle_decode(values, ends, torch.empty((1, L), dtype=torch.uint16, device=dev),
                             probe=probe)
    rec["by_cta0_phases_us"] = probe_phases_us(
        probe, ("search", "stage", "expand"), 0, kernels.sm_clock_khz(dev))
    log(f"H18 codec_rle_decode: bit for bit in 6 dtypes at {L} rows, {R} runs; ms {by_dtype}; "
        f"an empty kernel on its grid (uint16) {rec['floor_ms']:.5f}; the first CTA's phases "
        f"(us) {json.dumps(rec['by_cta0_phases_us'])}")
    # The codec's worst admitted int64 shape: the most runs it still ships
    # as RLE (each about 2.3 rows).
    p = rle_worst_payload(rng, 1, L, np.int64)
    values = torch.from_numpy(p["values"]).to(dev).view(torch.int64)
    ends = torch.from_numpy(p["ends"]).to(dev)
    Rw, used = ends.shape[1], int(p["runs"][0])
    out, out2 = (torch.empty((1, L), dtype=torch.int64, device=dev) for _ in range(2))
    kernels.codec_rle_decode(values, ends, out)
    codec.rle_decode_plain(values, ends, out2)
    torch.cuda.synchronize()
    check(torch.equal(out.view(torch.uint8), out2.view(torch.uint8)),
          "H18 at the worst admitted int64 shape: differs from the plain version")
    worst = record(
        lambda: kernels.codec_rle_decode(values, ends, out),
        lambda: codec.rle_decode_plain(values, ends, out2),
        None, *bound(used * 12 + L * 8, L + used), 0.0,
        f"values[1,{Rw}] int64, {used} runs -> [1,{L}]",
    )
    worst["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.codec_rle_decode_geometry(1, L, 8)))
    rec["by_worst_int64"] = {k: worst[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms", "shape")}
    log(f"H18 at the codec's worst admitted int64 shape ({used} runs of {Rw} over {L} rows): "
        f"bit for bit; ms {worst['ms']:.5f} plain_ms {worst['plain_ms']:.5f} bound_ms "
        f"{worst['bound_ms']:.5f} ({worst['bound_by']}), floor {worst['floor_ms']:.5f}")

    by_delta = {}
    bases = torch.tensor([1 << 40], dtype=torch.int64, device=dev)
    rows = torch.tensor([L], dtype=torch.int32, device=dev)
    for kind in ("nib", torch.uint8, torch.uint16):
        nib = kind == "nib"
        if nib:
            deltas = torch.from_numpy(rng.integers(0, 256, (1, L // 2)).astype(np.uint8))
            width = 0.5
        else:
            np_dt = np.uint8 if kind == torch.uint8 else np.uint16
            deltas = torch.from_numpy(rng.integers(0, np.iinfo(np_dt).max, (1, L)).astype(np_dt))
            width = deltas.element_size()
        deltas = deltas.to(dev)
        off = -7
        for out_dtype in (torch.uint8, torch.uint16, torch.int32, torch.int64):
            out, out2 = (torch.empty((1, L), dtype=out_dtype, device=dev) for _ in range(2))
            kernels.codec_delta_decode(bases, deltas, rows, off, nib, out)
            codec.delta_decode_plain(bases, deltas, rows, off, nib, out2)
            torch.cuda.synchronize()
            check(torch.equal(out, out2), f"H19 {kind} -> {out_dtype}: differs from plain")
        d64 = torch.randint(0, 16, (L,), dtype=torch.int64, device=dev)
        rec = record(
            lambda: kernels.codec_delta_decode(bases, deltas, rows, off, nib, out),
            lambda: codec.delta_decode_plain(bases, deltas, rows, off, nib, out2),
            lambda: torch.cumsum(d64, dim=0),
            *bound(L * width + 12 + L * 8, 2 * L), 0.0,
            f"deltas {kind} [1,{L}] -> int64 [1,{L}]",
        )
        by_delta[str(kind).replace("torch.", "")] = rec["ms"]
        if nib:
            records["codec_delta_decode"] = rec
    delta_edges(dev, rng)
    # A fixed-cadence timestamp (flow_window's time_) decodes to itself.
    const = torch.zeros((1, L // 2), dtype=torch.uint8, device=dev)
    ts = torch.empty((1, L), dtype=torch.int64, device=dev)
    kernels.codec_delta_decode(torch.zeros(1, dtype=torch.int64, device=dev), const, rows,
                               1000, True, ts)
    check(torch.equal(ts[0], torch.arange(L, device=dev) * 1000), "H19: time_ ramp")
    records["codec_delta_decode"]["by_dtype_ms"] = by_delta
    log(f"H19 codec_delta_decode: bit for bit, 3 delta x 4 block dtypes at {L} rows and the "
        f"edges; ms into int64 {by_delta}")
    return records


def delta_edges(dev, rng) -> None:
    """H19 bit for bit against its plain version over 3 shards of L = 1, 7
    and 1,000,001 rows (odd: the nibble payload and the block of shards 1
    and 2 are not 16-byte aligned) and 3 tiles, rows on the 4096-row tile
    edges and one off them, offsets near +-2^40, bases near +-2^63 (the
    sums wrap), nibble and int16 deltas into int64 and uint8 blocks."""
    from pixie_tpu_torch.ops import codec, kernels

    tile = kernels.DELTA_TILE_ROWS
    bases = torch.tensor([2**63 - 5000, -(2**63) + 3, 12345], dtype=torch.int64, device=dev)
    cases = 0
    for L, rows in ((1, (1, 0, 1)), (7, (7, 6, 1)),
                    (1_000_001, (100 * tile, 100 * tile + 1, 100 * tile - 1)),
                    (1_000_001, (1_000_001, tile, tile - 1)),
                    (3 * tile, (3 * tile, 2 * tile, 2 * tile + 1))):
        rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
        for nib in (True, False):
            deltas = torch.from_numpy(
                rng.integers(0, 256, (3, (L + 1) // 2)).astype(np.uint8) if nib
                else rng.integers(-(1 << 15), 1 << 15, (3, L)).astype(np.int16)).to(dev)
            for off in ((1 << 40) - 5, -(1 << 40) + 3):
                for out_dtype in (torch.int64, torch.uint8):
                    got, want = (torch.empty((3, L), dtype=out_dtype, device=dev)
                                 for _ in range(2))
                    kernels.codec_delta_decode(bases, deltas, rows_t, off, nib, got)
                    codec.delta_decode_plain(bases, deltas, rows_t, off, nib, want)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"H19 L={L} rows={rows} nib={nib} off={off} -> {out_dtype}: differs")
                    cases += 1
    log(f"H19 edges: {cases} cases bit for bit (L 1, 7, 1,000,001, 3 tiles; rows on and "
        f"off the tile edges)")


def cell_kernel_phase(dev) -> dict:
    """H20 and H21 against their plain versions on the card, exactly, at
    config 5's shape (16 groups, 4 status codes) and the budget's edge (32
    groups, 256 codes), on zeroed states as a query's pass starts them.
    Records: the config 5 shape."""
    from pixie_tpu_torch.ops import countmin, hll, kernels

    rng = np.random.default_rng(20)
    records: dict = {}
    m = 1 << hll.DEFAULT_PRECISION
    for G, C in ((N_SERVICES, len(STATUSES)), (32, 256)):
        hist = torch.from_numpy(rng.integers(1, 1 << 22, (G, C))).to(dev)
        if C > len(STATUSES):
            hist[torch.from_numpy(rng.random((G, C)) < 0.3).to(dev)] = 0
            lut = np.unique(rng.integers(0, 1 << 40, C + 64))[:C]
        else:
            lut = np.array(STATUSES, np.int64)
        lut = torch.from_numpy(lut).to(dev)
        want = hll.cell_update_plain(hll.init(G, dev), hist, lut)
        got = kernels.hll_cell_update(hll.init(G, dev), hist, lut)
        cm, total = countmin.init(G, dev), torch.zeros(G, dtype=torch.int64, device=dev)
        kernels.countmin_cell_update(cm, total, hist, lut)
        want_cm = countmin.cell_update_plain(countmin.init(G, dev), hist, lut)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H20 G={G} C={C}: registers differ from plain")
        check(torch.equal(cm, want_cm) and torch.equal(total, hist.sum(dim=1)),
              f"H21 G={G} C={C}: cells or totals differ from plain")
        present = hist > 0
        reg, rho = hll._reg_rho(lut, hll.DEFAULT_PRECISION)
        gg = torch.arange(G, device=dev)[:, None].expand(G, C)
        flat = (gg * m + reg[None, :].long())[present]
        rho_p = rho[None, :].expand(G, C)[present]
        cells = int(present.sum())
        lib_state = torch.zeros(G * m, dtype=torch.int32, device=dev)
        zeroed, plain_state = fresh(lambda: hll.init(G, dev)), hll.init(G, dev)
        h20 = record(
            lambda: kernels.hll_cell_update(zeroed(), hist, lut),
            lambda: hll.cell_update_plain(plain_state, hist, lut),
            lambda: lib_state.scatter_reduce_(0, flat, rho_p, "amax"),
            *bound(G * C * 8 + C * 8 + 2 * cells * 4, 40 * G * C), 0.0,
            f"hist[{G},{C}] {cells} cells, state[{G},{m}] zeroed",
        )
        depth, width = cm.shape[1], cm.shape[2]
        buckets = countmin._buckets(lut, depth, width)
        flat4 = torch.cat([((gg * depth + d) * width + b[None, :].long())[present]
                           for d, b in enumerate(buckets)])
        counts4 = hist[present].repeat(depth)
        lib_cm = torch.zeros(G * depth * width, dtype=torch.int64, device=dev)
        cms = fresh(lambda: (countmin.init(G, dev), torch.zeros(G, dtype=torch.int64, device=dev)))
        h21 = record(
            lambda: kernels.countmin_cell_update(*cms(), hist, lut),
            lambda: countmin.cell_update_plain(cm, hist, lut),
            lambda: lib_cm.index_add_(0, flat4, counts4),
            *bound(G * C * 8 + C * 8 + 2 * depth * cells * 8 + 2 * G * 8, 40 * G * C),
            0.0, f"hist[{G},{C}] {cells} cells, cm[{G},{depth},{width}] zeroed",
        )
        log(f"H20 hll_cell_update, H21 countmin_cell_update G={G} C={C}: registers, cells and "
            f"totals exact; {h20['ms']:.4f} / {h21['ms']:.4f} ms")
        if G == N_SERVICES:
            records["hll_cell_update"], records["countmin_cell_update"] = h20, h21
        else:
            for name, rec in (("hll_cell_update", h20), ("countmin_cell_update", h21)):
                records[name]["by_shape_32x256"] = {k: rec[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")}
    return records


def ptxas_frame(kernel: str) -> Optional[tuple]:
    """(stack frame, spill stores, spill loads) bytes that ptxas reported
    for the kernel whose mangled name holds ``kernel``, or None when this
    process found the library built (no ptxas output)."""
    from pixie_tpu_torch.ops import kernels

    lines = kernels.BUILD_INFO.get("ptxas", "").splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line and i + 1 < len(lines):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", lines[i + 1])
            if m:
                return tuple(int(x) for x in m.groups())
    return None


def torch_tree(cols: dict, base: torch.Tensor, slot_terms: list):
    """The tree of torch ops H22 replaces: per slot, each term's compare
    (isin for op 6) ANDed into the block mask, shifted into its bit."""
    dev = base.device
    ops = [torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge]
    wide = {c: (t.to(torch.int64) + off if not t.dtype.is_floating_point else t)
            for c, (t, off) in cols.items()}
    lists = {id(t): torch.tensor(t[5], dtype=torch.int64, device=dev)
             for terms in slot_terms for t in terms if t[2] == 6}

    def run():
        bits = torch.zeros(base.shape[0], dtype=torch.int64, device=dev)
        for s, terms in enumerate(slot_terms):
            m = base
            for t in terms:
                v = wide[t[1]]
                if t[2] == 6:
                    m = m & torch.isin(v, lists[id(t)])
                else:
                    m = m & ops[t[2]](v, t[4] if t[0] == "f" else t[3])
            bits |= m.to(torch.int64) << s
        return bits

    return run


def batch_kernel_phase(dev) -> dict:
    """H22 and H23 against their plain versions on the card at a 2^21-row
    block of the service_stats table (16 groups; resp_status narrowed to
    uint16 at offset 200 as staging narrows it, f64 latency). H22 for B = 1,
    7 (the sum group's seven families: T = 1, an op-6 list of 2), 16 and 32
    (T = 2 and 3 with an op-6 list of 1024; ops/pred_edges.py), bit for bit
    with the columns aligned and one element into their buffers with a
    5-row tail, with its floor (an empty kernel on its grid) and ptxas's
    stack frame (0 bytes); H23 over rows as
    staged at the main path's shape (the 7 families' bits, no int row, one
    f64 row, 16 groups: the slot lane, the same bits twice), at B = 16 with
    two int rows (status narrowed, an int64 row) and two f64 rows (shared
    partials) and at B = 32 and 4096 groups (global atomics): integers
    exact, f64 sums within 1e-12 * sum |v|. Records: the main path's shapes
    (B = 7)."""
    from pixie_tpu_torch.ops import batched, kernels, pred_edges, segment

    rng = np.random.default_rng(24)
    n = BLOCK_ROWS
    status = np.array(STATUSES)[rng.choice(4, n, p=[0.85, 0.05, 0.05, 0.05])]
    latency = rng.exponential(3e7, n)
    cols = {
        "resp_status": (torch.from_numpy((status - 200).astype(np.uint16)).to(dev), 200),
        "latency": (torch.from_numpy(latency).to(dev), 0),
    }
    dtypes = {c: np.dtype(np.uint16 if c == "resp_status" else np.float64) for c in cols}
    base = torch.from_numpy(rng.random(n) < 0.97).to(dev)
    records: dict = {}
    bits7 = None
    for B in (7, 1, 16, 32):  # the main path's shape first: its record
        slot_terms = pred_edges.soak_terms() if B == 7 else pred_edges.wide_terms(B)
        table = batched.build_term_table(slot_terms, dtypes).to(dev)
        tcols = [cols[c][0] for c in table.columns]
        offs = [cols[c][1] for c in table.columns]
        got = batched.slot_masks(tcols, offs, base, table)
        want = batched.slot_masks_plain(tcols, offs, base, table)
        tree = torch_tree(cols, base, slot_terms)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"H22 B={B}: slot bits differ from plain")
        check(torch.equal(got.to(torch.int64) & 0xFFFFFFFF, tree()), f"H22 B={B}: bits vs torch tree")
        # The columns and the mask one element into their buffers (no vector
        # loads) and a tail of 5 rows past the last 8-row vector.
        m = n - 5
        ucols = [unaligned(t[:m]) for t in tcols]
        check(torch.equal(batched.slot_masks(ucols, offs, unaligned(base[:m]), table), want[:m]),
              f"H22 B={B}: unaligned columns or the tail differ from plain")
        col_bytes = sum(t.element_size() for t in tcols)
        prog = table.prog
        rec = record(
            lambda: batched.slot_masks(tcols, offs, base, table),
            lambda: batched.slot_masks_plain(tcols, offs, base, table), None,
            *bound(n * (1 + col_bytes + 4), n * prog.num_terms), 0,
            f"{n} rows, B={B} (padded {table.B}), T={table.T}, L={table.L}, "
            f"columns {table.columns}, {prog.num_terms} distinct terms, lists {prog.forms}",
        )
        rec["torch_tree_ms"] = time_ms(tree)
        geo = kernels.pred_slot_masks_geometry(n, prog.num_terms, prog.shared_words)
        rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(dev, *geo))
        log(f"H22 pred_slot_masks B={B} T={table.T} L={table.L}, {prog.num_terms} distinct terms, "
            f"lists {prog.forms}: bit-equal to plain and the torch tree, unaligned and tail too; "
            f"{rec['ms']:.5f} ms (floor {rec['floor_ms']:.5f}, plain {rec['plain_ms']:.4f}, torch "
            f"tree {rec['torch_tree_ms']:.4f}, bound {rec['bound_ms']:.5f})")
        if B == 7:
            records["pred_slot_masks"], bits7 = rec, got
        else:
            records["pred_slot_masks"][f"by_shape_B{B}"] = {
                k: rec[k] for k in ("ms", "plain_ms", "torch_tree_ms", "bound_ms", "floor_ms",
                                    "shape")}
    frame = ptxas_frame("pred_slot_masks_kernel")
    if frame is not None:
        check(frame == (0, 0, 0), f"H22: ptxas reports {frame} bytes of stack frame and spills")
    records["pred_slot_masks"]["b_ptxas_stack_spills"] = frame
    log(f"H22 ptxas stack frame, spill stores, spill loads: {frame}")
    lat = cols["latency"][0]
    status = cols["resp_status"][0]
    optin = kernels.smem_optin_bytes(dev)
    for B, R, F, S in ((7, 0, 1, N_SERVICES), (16, 2, 2, N_SERVICES), (32, 1, 1, 4096)):
        gids = torch.from_numpy(rng.integers(0, S, n).astype(np.int32)).to(dev)
        bits = bits7 if B == 7 else torch.from_numpy(
            rng.integers(-(2**31), 2**31, n).astype(np.int32)).to(dev)
        # Rows as the fold stages them: resp_status narrowed to uint16 at
        # offset 200, an int64 row; latency f64 and a second f64 row.
        irows = [segment.Narrow(status, 200),
                 torch.from_numpy(rng.integers(-(2**40), 2**40, n)).to(dev)][:R]
        frows = [lat, lat * 2.0][:F]
        got_i, got_f = batched.batched_segment_sums(irows, frows, gids, bits, B, S)
        again_f = batched.batched_segment_sums(irows, frows, gids, bits, B, S)[1]
        want_i, want_f = batched.batched_segment_sums_plain(irows, frows, gids, bits, B, S)
        _, abs_f = batched.batched_segment_sums_plain(irows, [f.abs() for f in frows], gids, bits,
                                                      B, S)
        lane, threads = kernels.h23_lane(B, R, F, S, optin)
        torch.cuda.synchronize()
        check(torch.equal(got_i, want_i), f"H23 B={B} S={S}: integer sums or presence differ")
        err = float((got_f - want_f).abs().max()) if F else 0.0
        check(bool(torch.all((got_f - want_f).abs() <= 1e-12 * abs_f)),
              f"H23 B={B} S={S}: f64 sums beyond 1e-12 * sum |v|")
        check(lane != "slots" or bits_equal(again_f, got_f), f"H23 B={B} S={S}: not the same bits")
        # One index_add_ over slot-flattened ids s * S + g of the B-times
        # expanded first f64 row (rows outside a slot into a spare cell).
        slots = torch.arange(B, device=dev)[:, None]
        on = ((bits.to(torch.int64)[None, :] >> slots) & 1).bool()
        flat = torch.where(on, slots * S + gids[None, :].long(), B * S).reshape(-1)
        vals = frows[0].expand(B, n).reshape(-1)
        lib_out = torch.zeros(B * S + 1, dtype=torch.float64, device=dev)
        row_bytes = sum(2 if isinstance(r, segment.Narrow) else 8 for r in irows) + 8 * F
        rec = record(
            lambda: batched.batched_segment_sums(irows, frows, gids, bits, B, S),
            lambda: batched.batched_segment_sums_plain(irows, frows, gids, bits, B, S),
            lambda: lib_out.index_add_(0, flat, vals),
            *bound(n * (4 + 4 + row_bytes) + B * (R + 1 + F) * S * 8,
                   int(on.sum()) * (R + 1 + F)),
            err, f"{n} rows, B={B}, R={R}, F={F}, S={S}, lane {lane}"
            + (f" ({threads} threads)" if threads else ""),
        )
        log(f"H23 batched_segment_sums B={B} R={R} F={F} S={S} ({lane}): integers exact, f64 max "
            f"abs err {err:.3g}{', the same bits twice' if lane == 'slots' else ''}; "
            f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, index_add_ "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f})")
        if B == 7:
            records["batched_segment_sums"] = rec
        else:
            records["batched_segment_sums"][f"by_shape_B{B}_S{S}"] = {
                k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return records


# f64 edge values of the f32 conversion (bits): NaN payloads of both signs,
# quiet and signalling, +-inf, +-0, f32 subnormals (2^-149, 1.5 * 2^-149,
# just below 2^-126), a rounding tie, values that overflow f32.
def ring_kernel_phase(dev) -> dict:
    """H24 against ``convert_block_plain`` on the card and against the host
    pack (numpy, pack_stream_window's transform) of the same rows, bit for
    bit, at a 2^21-row ring window, for every case of RING_CASES (uint8 and
    uint16 int-dictionary codes with C = 3, 256 and 65536, the largest
    int_dict_lut admits). Timed per case: kernel, plain version, the one
    torch call that computes the function where there is one (``Tensor.to``
    for the casts), and the torch sequence otherwise (narrow: a subtract
    and a cast; intdict: searchsorted, clamp, cast). Record: int64 ->
    uint16 narrow (resp_status, http_data_ring). Also reports what torch's
    own f64 -> f32 cast on the card makes of NaN payloads against numpy.
    Then the shard-stride lane: a window of D logical shards of one card
    ([D, nblk, b], 2^21 rows) converted in one launch into its slice of a
    staging of three windows (D runs at the staging's shard stride), for D
    1, 4 and 8 and every case, bit for bit the plain version on the same
    slice, the other windows untouched; timed at D 8 (``by_shards``)."""
    from pixie_tpu_torch.ops import codec, kernels
    from pixie_tpu_torch.ops.convert_edges import (
        F64_EDGES, RING_CASES, SHARD_COUNTS, ring_case, strided_staging,
    )
    from pixie_tpu_torch.parallel import staging

    rng = np.random.default_rng(24)
    n = BLOCK_ROWS
    by_case = {}
    record_out = None
    for name in RING_CASES:
        raw, col_plan, dt, off = ring_case(name, rng, n)
        x = torch.from_numpy(raw.reshape(1, 1, n)).to(dev)
        out = torch.empty((1, 1, n), dtype=codec.TORCH_DTYPES[dt], device=dev)
        out2 = torch.empty_like(out)
        int_dtype = dt if col_plan[0] == "raw" else None
        codec.convert_block(col_plan, x, out=out, int_dtype=int_dtype)
        codec.convert_block_plain(col_plan, x, out2)
        torch.cuda.synchronize()
        check(torch.equal(out.view(torch.uint8), out2.view(torch.uint8)),
              f"H24 {name}: differs from the plain version")
        with np.errstate(all="ignore"):
            if col_plan[0] == "raw":
                host = raw.astype(dt)
            else:
                plan = staging.StreamPlan(
                    col_plans={"c": col_plan}, narrow_offsets={}, int_dicts={},
                    block_dtypes={"c": dt}, window_rows=n, num_rows=n, n_windows=1, d=1,
                    nblk=1, b=n, gid_dtype=None, num_groups=1,
                )
                host = np.asarray(staging.pack_stream_window(plan, {"c": raw}, None, 0)[1]["c"])
        check(np.array_equal(out.cpu().numpy().reshape(-1).view(np.uint8),
                             host.reshape(-1).view(np.uint8)),
              f"H24 {name}: differs from the host pack")
        lut_t = (torch.as_tensor(col_plan[1][0], device=dev) if col_plan[0] == "intdict"
                 else None)
        dst = out.dtype
        if col_plan[0] in ("raw", "f32"):
            library, seq = (lambda: x.to(dst)), None
        elif col_plan[0] == "narrow":
            library, seq = None, (lambda: (x - off).to(dst))
        else:
            C = lut_t.numel()
            library = None
            seq = lambda: torch.searchsorted(lut_t, x.reshape(-1)).clamp_max_(C - 1).to(dst)
        kind = col_plan[0]
        lut_bytes = lut_t.numel() * 8 if lut_t is not None else 0
        # A binary search is ceil(log2(C + 1)) compares an element.
        ops = n * math.ceil(math.log2(lut_t.numel() + 1)) if lut_t is not None else n
        fn = (lambda: kernels.ring_convert(x, out, kind, off=off or 0, lut=lut_t))
        rec = record(
            fn, lambda: codec.convert_block_plain(col_plan, x, out2), library,
            *bound(n * (x.element_size() + out.element_size()) + lut_bytes, ops), 0.0,
            f"{x.dtype} [1,1,{n}] -> {dst}",
        )
        if seq is not None:
            rec["torch_seq_ms"] = time_ms(seq)
        by_case[name] = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_case[name]["torch_seq_ms"] = rec.get("torch_seq_ms")
        if name == "narrow_i64_u16":
            record_out = rec
    # torch's own cast of NaN payloads on the card against the host's.
    x = torch.from_numpy(F64_EDGES.view(np.float64)[:5].copy()).to(dev)
    card = x.to(torch.float32).cpu().numpy().view(np.uint32)
    with np.errstate(all="ignore"):
        host = F64_EDGES.view(np.float64)[:5].astype(np.float32).view(np.uint32)
    log("NaN payloads: f64 bits " + ", ".join(hex(v) for v in F64_EDGES[:5]) +
        f" -> Tensor.to(float32) on the card {[hex(v) for v in card]}, numpy (and H24) "
        f"{[hex(v) for v in host]}; equal: {bool(np.array_equal(card, host))}")
    record_out["by_case"] = by_case
    log("H24 ring_convert: bit for bit the plain version and the host pack in "
        f"{len(RING_CASES)} cases at {n} rows; ms [bound] " +
        ", ".join(f"{k} {v['ms']:.4f} [{v['bound_ms']:.4f}]" for k, v in by_case.items()))
    by_shards = {}
    for d in SHARD_COUNTS:
        nblk, b = 2, n // (2 * d)
        for name in RING_CASES:
            raw, col_plan, dt, off = ring_case(name, rng, n)
            x = torch.from_numpy(raw.reshape(d, nblk, b)).to(dev)
            tdt = codec.TORCH_DTYPES[dt]
            got_all, got = strided_staging(d, nblk, b, tdt, dev)
            want_all, want = strided_staging(d, nblk, b, tdt, dev)
            int_dtype = dt if col_plan[0] == "raw" else None
            kernels.reset_launches()
            codec.convert_block(col_plan, x, out=got, int_dtype=int_dtype)
            check(kernels.LAUNCHES["ring_convert"] == 1,
                  f"H24 {name} at D {d}: {kernels.LAUNCHES['ring_convert']} launches, not 1")
            codec.convert_block_plain(col_plan, x, want)
            torch.cuda.synchronize()
            check(torch.equal(got_all.view(torch.uint8), want_all.view(torch.uint8)),
                  f"H24 {name} at D {d}: the strided slice differs from the plain version's")
            if d != SHARD_COUNTS[-1]:
                continue
            lut_t = (torch.as_tensor(col_plan[1][0], device=dev) if col_plan[0] == "intdict"
                     else None)
            lut_bytes = lut_t.numel() * 8 if lut_t is not None else 0
            ops = n * math.ceil(math.log2(lut_t.numel() + 1)) if lut_t is not None else n
            kind = col_plan[0]
            ms = time_ms(lambda: kernels.ring_convert(x, got, kind, off=off or 0, lut=lut_t))
            bms = bound(n * (x.element_size() + got.element_size()) + lut_bytes, ops)[0]
            by_shards[name] = {"d": d, "ms": ms, "bound_ms": bms,
                               "plain_ms": time_ms(lambda: codec.convert_block_plain(
                                   col_plan, x, want), reps=10, warmup=1)}
    kernels.reset_launches()
    record_out["by_shards"] = by_shards
    log(f"H24 ring_convert, shard-stride lane: bit for bit the plain version at D "
        f"{', '.join(map(str, SHARD_COUNTS))} in {len(RING_CASES)} cases ({n} rows a window, "
        "one launch a window); at D 8, ms [bound; plain] " +
        ", ".join(f"{k} {v['ms']:.4f} [{v['bound_ms']:.4f}; {v['plain_ms']:.4f}]"
                  for k, v in by_shards.items()))
    return {"ring_convert": record_out}


def decode_keys(tdigest, ks: torch.Tensor, G: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(group, value) of H7a's sorted keys: packed u32 keys with the sign bit
    flipped, or int64 (group << 32 | order key)."""
    if ks.dtype == torch.int64:
        return ks >> 32, tdigest._from_order_key(ks & 0xFFFFFFFF)
    bits_g = (G + 1).bit_length()
    k = (ks.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    return k >> (32 - bits_g), tdigest._from_order_key((k << bits_g) & 0xFFFFFFFF)


def near_edge_rows(tdigest, g_s: torch.Tensor, G: int, C: int) -> torch.Tensor:
    """Per group, the sorted rows whose f64 cluster coordinate k(qmid) * C
    (qmid in f32, as the reference computes it) lies within the Fault-4
    contract's 1e-4 of an integer."""
    _, qmid = tdigest._row_clusters(g_s, G, C)
    q = torch.clamp(qmid.double(), float(np.float32(1e-7)), float(np.float32(1 - 1e-7)))
    c = (torch.asin(2 * q - 1) / math.pi + 0.5) * C
    near = ((c - torch.round(c)).abs() <= F4_EPS) & (g_s < G)
    return torch.bincount(g_s[near], minlength=G)[:G]


def copy_rate(dev) -> float:
    """Bytes/s of a 1 GiB device-to-device copy (read + write counted)."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() / (ms / 1e3)


# ---------------------------------------------------------------- the slice
def http_events(n_rows: int) -> dict:
    """bench.py's http_events generator (build_http, seed 42) with its truth
    counts, truth latency histograms and per-(service, status) counts."""
    rng = np.random.default_rng(42)
    svc = np.empty(n_rows, np.uint8)
    status = np.empty(n_rows, np.uint16)
    latency = np.empty(n_rows, np.float64)
    tc = np.zeros(N_SERVICES, np.int64)
    te = np.zeros(N_SERVICES, np.int64)
    th = np.zeros((N_SERVICES, TRUTH_BINS), np.int64)
    ts = np.zeros((N_SERVICES, len(STATUSES)), np.int64)
    opts = np.array(STATUSES, np.uint16)
    cum = np.cumsum([0.85, 0.05, 0.05, 0.05])
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        m = min(chunk, n_rows - off)
        si = rng.integers(0, N_SERVICES, m, dtype=np.uint8)
        pick = np.searchsorted(cum, rng.random(m), side="right")
        st = opts[pick]
        la = rng.exponential(3e7, m)
        svc[off : off + m] = si
        status[off : off + m] = st
        latency[off : off + m] = la
        tc += np.bincount(si, minlength=N_SERVICES)
        te += np.bincount(si, weights=(st >= 400), minlength=N_SERVICES).astype(np.int64)
        bins = np.digitize(la, TRUTH_EDGES)
        th += np.bincount(
            si.astype(np.int64) * TRUTH_BINS + bins, minlength=N_SERVICES * TRUTH_BINS
        ).reshape(N_SERVICES, TRUTH_BINS)
        ts += np.bincount(
            si.astype(np.int64) * len(STATUSES) + pick, minlength=N_SERVICES * len(STATUSES)
        ).reshape(N_SERVICES, len(STATUSES))
    return dict(svc=svc, status=status, latency=latency, tc=tc, te=te, th=th, ts=ts)


def conn_flows(n_rows: int) -> dict:
    """bench.py's conn_flows generator (build_flows, seed 45: 64 pods each
    side, remote_port uniform in [1024, 65535), byte counts uniform in
    [0, 2^20)) with its truth byte sums and distinct ports per (src, dst)."""
    rng = np.random.default_rng(45)
    d = {
        "src": rng.integers(0, N_PODS, n_rows, dtype=np.uint8),
        "dst": rng.integers(0, N_PODS, n_rows, dtype=np.uint8),
        "port": rng.integers(1024, 65535, n_rows, dtype=np.uint16),
        "bs": rng.integers(0, 1 << 20, n_rows, dtype=np.uint32),
        "br": rng.integers(0, 1 << 20, n_rows, dtype=np.uint32),
    }
    pair = d["src"].astype(np.int64) * N_PODS + d["dst"]
    # Per-pair byte sums stay below 2^53, so the float64 bincount is exact.
    d["sent"] = np.bincount(pair, weights=d["bs"], minlength=FLOW_GROUPS).astype(np.int64)
    d["recv"] = np.bincount(pair, weights=d["br"], minlength=FLOW_GROUPS).astype(np.int64)
    seen = np.zeros(FLOW_GROUPS << 16, dtype=bool)
    seen[(pair << 16) | d["port"]] = True
    d["distinct"] = seen.reshape(FLOW_GROUPS, 1 << 16).sum(axis=1)
    return d


def flow_extremes(fl: dict) -> None:
    """Per (src, dst) pair, the min and max of bytes_sent and bytes_recv:
    sort the keys pair << 20 | value (values < 2^20) and take each pair's
    first and last."""
    pair = fl["src"].astype(np.int64) * N_PODS + fl["dst"]
    bounds = np.arange(FLOW_GROUPS + 1, dtype=np.int64) << 20
    for col, key in (("bs", "bytes_sent"), ("br", "bytes_recv")):
        keys = np.sort((pair << 20) | fl[col])
        first = np.searchsorted(keys, bounds[:-1])
        last = np.searchsorted(keys, bounds[1:]) - 1
        check(bool(np.all(first <= last)), "conn_flows: a (src, dst) pair without rows")
        fl[f"{key}_min"] = keys[first] & 0xFFFFF
        fl[f"{key}_max"] = keys[last] & 0xFFFFF


def http_small(n_rows: int) -> dict:
    """bench.py's http_small generator (build_small, seed 44): 16 services,
    status {200: .9, 404: .05, 500: .05}, exponential(3e7) latency."""
    rng = np.random.default_rng(44)
    svc = rng.integers(0, N_SERVICES, n_rows, dtype=np.uint8)
    cum = np.cumsum([0.9, 0.05, 0.05])
    status = np.array([200, 404, 500], np.uint16)[
        np.searchsorted(cum, rng.random(n_rows), side="right")]
    return {"svc": svc, "status": status, "latency": rng.exponential(3e7, n_rows)}


def stacks(n_rows: int) -> dict:
    """bench.py's stacks generator (build_stacks, seed 43): 4096 stack ids,
    counts in [1, 100), with the truth count sum of each stack."""
    rng = np.random.default_rng(43)
    d = {"sid": rng.integers(0, N_STACKS, n_rows, dtype=np.uint16),
         "cnt": rng.integers(1, 100, n_rows, dtype=np.uint8)}
    # Sums stay below 2^53, so the float64 bincount is exact.
    d["sums"] = np.bincount(d["sid"], weights=d["cnt"], minlength=N_STACKS).astype(np.int64)
    return d


def stack_name(i: int) -> str:
    return f"main;f{i % 61};g{i % 127};h{i}"


def truth_quantile(hist_row: np.ndarray, q: float) -> float:
    total = hist_row.sum()
    if total == 0:
        return 0.0
    cum = np.cumsum(hist_row)
    i = min(int(np.searchsorted(cum, q * total)), TRUTH_BINS - 1)
    lo = TRUTH_EDGES[i - 1] if i >= 1 else TRUTH_LO
    hi = TRUTH_EDGES[i] if i < len(TRUTH_EDGES) else TRUTH_HI
    return math.sqrt(lo * hi)


def build_carnot(data: dict, n_rows: int, device: str):
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
    )
    table = carnot.table_store.create_table("http_events", rel, size_limit=1 << 42)
    svc_dict = table.dictionaries["service"]
    for i in range(N_SERVICES):  # identity codes 0..15, as bench.py
        svc_dict.get_code(f"ns/svc-{i}")
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        m = min(chunk, n_rows - off)
        table.write_pydict({
            "time_": np.arange(off, off + m, dtype=np.int64) * 1000,
            "service": DictColumn(data["svc"][off : off + m].astype(np.int32), svc_dict),
            "resp_status": data["status"][off : off + m],
            "latency": data["latency"][off : off + m],
        })
    table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "table expired rows")
    return carnot


def build_flows_carnot(fl: dict, n_rows: int, device: str):
    """bench.py's conn_flows table (run_config_3): identity dictionary codes
    for the 64 pods of each side, written in 16M-row chunks."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    S, I = DataType.STRING, DataType.INT64
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS), ("src", S), ("dst", S),
        ("remote_port", I), ("bytes_sent", I), ("bytes_recv", I),
    )
    table = carnot.table_store.create_table("conn_flows", rel, size_limit=1 << 42)
    for col in ("src", "dst"):
        for i in range(N_PODS):
            table.dictionaries[col].get_code(f"default/pod-{i}")
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        m = min(chunk, n_rows - off)
        sl = slice(off, off + m)
        table.write_pydict({
            "time_": np.arange(off, off + m, dtype=np.int64) * 1000,
            "src": DictColumn(fl["src"][sl].astype(np.int32), table.dictionaries["src"]),
            "dst": DictColumn(fl["dst"][sl].astype(np.int32), table.dictionaries["dst"]),
            "remote_port": fl["port"][sl],
            "bytes_sent": fl["bs"][sl],
            "bytes_recv": fl["br"][sl],
        })
    table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "table expired rows")
    return carnot


def build_small_table(carnot, name: str, hs: dict, n_rows: int) -> float:
    """bench.py's http_small table (ensure_small_table) as ``name`` in
    ``carnot``: identity service codes, 16M-row chunks, then compact() and
    stop(). Returns the seconds from create_table to stop(), the device's
    work included (a resident ring stages on the writer's thread)."""
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = carnot.table_store.create_table(name, rel, size_limit=1 << 42)
    sd = table.dictionaries["service"]
    for i in range(N_SERVICES):
        sd.get_code(f"ns/svc-{i}")
    for off in range(0, n_rows, 16_000_000):
        sl = slice(off, min(off + 16_000_000, n_rows))
        table.write_pydict({
            "time_": np.arange(sl.start, sl.stop, dtype=np.int64) * 1000,
            "service": DictColumn(hs["svc"][sl].astype(np.int32), sd),
            "resp_status": hs["status"][sl],
            "latency": hs["latency"][sl],
        })
    table.compact()
    table.stop()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "table expired rows")
    return seconds


def build_small_carnot(hs: dict, n_rows: int, device: str):
    """A Carnot holding bench.py's http_small table (no ring), and the
    seconds its table took to build."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    return carnot, build_small_table(carnot, "http_small", hs, n_rows)


def small_truths(hs: dict) -> dict:
    """http_small's truths in http_events' form (verify_sketches): counts,
    latency histograms and per-(service, status) counts of its statuses."""
    statuses = (200, 404, 500)
    svc = hs["svc"].astype(np.int64)
    tc = np.bincount(svc, minlength=N_SERVICES)
    th = np.zeros((N_SERVICES, TRUTH_BINS), np.int64)
    chunk = 16_000_000
    for off in range(0, svc.size, chunk):
        sl = slice(off, off + chunk)
        th += np.bincount(svc[sl] * TRUTH_BINS + np.digitize(hs["latency"][sl], TRUTH_EDGES),
                          minlength=N_SERVICES * TRUTH_BINS).reshape(N_SERVICES, TRUTH_BINS)
    pick = np.searchsorted(np.array(statuses), hs["status"])
    ts = np.bincount(svc * len(statuses) + pick, minlength=N_SERVICES * len(statuses))
    return dict(tc=tc, th=th, ts=ts.reshape(N_SERVICES, len(statuses)), statuses=statuses)


def build_stacks_carnot(st: dict, n_rows: int, device: str):
    """bench.py's stacks table (run_config_4): stack_trace codes equal the
    stack ids (identity dictionary), 16M-row chunks."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("stack_trace_id", DataType.INT64), ("stack_trace", DataType.STRING),
        ("count", DataType.INT64),
    )
    table = carnot.table_store.create_table("stacks", rel, size_limit=1 << 42)
    sd = table.dictionaries["stack_trace"]
    for i in range(N_STACKS):
        sd.get_code(stack_name(i))
    for off in range(0, n_rows, 16_000_000):
        sl = slice(off, min(off + 16_000_000, n_rows))
        table.write_pydict({
            "time_": np.arange(sl.start, sl.stop, dtype=np.int64) * 1000,
            "stack_trace_id": st["sid"][sl],
            "stack_trace": DictColumn(st["sid"][sl].astype(np.int32), sd),
            "count": st["cnt"][sl],
        })
    table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "table expired rows")
    return carnot


def join_fact(n_rows: int) -> dict:
    """bench.py's join_fact generator (run_config_8, seed 46): a service
    index per row, uniform over the 16 services, exponential(3e7) latency."""
    rng = np.random.default_rng(46)
    return {"svc_idx": rng.integers(0, N_SERVICES, n_rows, dtype=np.uint8),
            "latency": rng.exponential(3e7, n_rows)}


def build_join_carnot(jf: dict, n_rows: int, device: str):
    """bench.py's config 8 tables (run_config_8): svc_owners (service i owned
    by team-{i % 4}), svc_owners_partial (partial_owners(), row j owned by
    team-{j % 4}) and join_fact (identity service codes, 16M-row chunks);
    and svc_oncall, service i's i % 4 on-call rows j (engineer eng-{i}-{j},
    seats 1 + (i + j) % 5), 24 in all: services 0, 4, 8 and 12 have none."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    S = DataType.STRING
    for name, svcs in (("svc_owners", SERVICES), ("svc_owners_partial", partial_owners())):
        t = carnot.table_store.create_table(
            name, Relation.of(("svc", S, SemanticType.ST_SERVICE_NAME), ("owner", S)))
        t.write_pydict({
            "svc": np.array(svcs, dtype=object),
            "owner": np.array([f"team-{i % 4}" for i in range(len(svcs))], dtype=object),
        })
        t.compact()
        t.stop()
    t = carnot.table_store.create_table("svc_oncall", Relation.of(
        ("svc", S, SemanticType.ST_SERVICE_NAME), ("engineer", S), ("seats", DataType.INT64)))
    oncall = [(i, j) for i in range(N_SERVICES) for j in range(i % 4)]
    t.write_pydict({
        "svc": np.array([SERVICES[i] for i, _ in oncall], dtype=object),
        "engineer": np.array([f"eng-{i}-{j}" for i, j in oncall], dtype=object),
        "seats": np.array([1 + (i + j) % 5 for i, j in oncall], dtype=np.int64),
    })
    t.compact()
    t.stop()
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", S, SemanticType.ST_SERVICE_NAME),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
    )
    table = carnot.table_store.create_table("join_fact", rel, size_limit=1 << 42)
    fd = table.dictionaries["service"]
    for name in SERVICES:
        fd.get_code(name)
    for off in range(0, n_rows, 16_000_000):
        sl = slice(off, min(off + 16_000_000, n_rows))
        table.write_pydict({
            "time_": np.arange(sl.start, sl.stop, dtype=np.int64) * 1000,
            "service": DictColumn(jf["svc_idx"][sl].astype(np.int32), fd),
            "latency": jf["latency"][sl],
        })
    table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "table expired rows")
    return carnot


def verify_http_data(result, hs: dict) -> None:
    """Config 1: the first 1000 rows with resp_status >= 400, in row order;
    time_, service and latency / 1e6 bit-equal to numpy's."""
    rows = result.table("out")
    sel = np.flatnonzero(hs["status"] >= 400)[:SCAN_LIMIT]
    check(len(rows["time_"]) == SCAN_LIMIT, f"http_data: {len(rows['time_'])} rows")
    check(np.array_equal(np.asarray(rows["time_"]), sel * 1000), "http_data: time_")
    check(rows["service"] == [f"ns/svc-{i}" for i in hs["svc"][sel]], "http_data: service")
    lat = np.asarray(rows["latency_ms"], dtype=np.float64)
    check(np.array_equal(lat.view(np.int64), (hs["latency"][sel] / 1e6).view(np.int64)),
          "http_data: latency_ms")


def verify_flamegraph(result, st: dict) -> None:
    """Config 4: all 4096 stacks, each count sum exact, each stack_trace its
    identity string."""
    rows = result.table("merged")
    sids = np.asarray(rows["stack_trace_id"])
    check(len(sids) == N_STACKS and np.array_equal(np.sort(sids), np.arange(N_STACKS)),
          f"flamegraph: {len(sids)} stacks")
    check(np.array_equal(np.asarray(rows["count"]), st["sums"][sids]), "flamegraph: counts")
    check(rows["stack_trace"] == [stack_name(i) for i in sids], "flamegraph: stack_trace")


def verify_flow_span(result, fl: dict) -> None:
    """The flows min/max: 4096 pairs, each min and max exact."""
    rows = result.table("flow_span")
    check(len(rows["src"]) == FLOW_GROUPS, f"flow_span: got {len(rows['src'])} groups")
    pod = lambda name: int(name.rsplit("-", 1)[1])
    pair = np.array([pod(a) * N_PODS + pod(b) for a, b in zip(rows["src"], rows["dst"])])
    for key in ("bytes_sent_min", "bytes_sent_max", "bytes_recv_min", "bytes_recv_max"):
        check(np.array_equal(np.asarray(rows[key]), fl[key][pair]), f"flow_span: {key}")


def joined(result) -> dict:
    """The joined rows as numpy columns, strings as their index into the
    names given to ``names_of`` (fast at 4M rows: no per-row decode)."""
    from pixie_tpu_torch.table.row_batch import RowBatch

    batch = RowBatch.concat([b for b in result.tables["joined"] if b.num_rows])
    return {c.name: batch.col(c.name) for c in batch.relation}


def name_index(col, names: list) -> np.ndarray:
    """Each row's string as its index in ``names``: -1 for "" (an outer
    join's null), -2 for a string not in ``names``."""
    pos = {v: i for i, v in enumerate(names)}
    lut = np.array([-1 if v == "" else pos.get(v, -2) for v in col.dictionary.values()]
                   + [-2], dtype=np.int64)
    return lut[col.codes]


def f64_bits_equal(a, b) -> bool:
    a, b = np.ascontiguousarray(a, np.float64), np.ascontiguousarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def verify_join8(result, jf: dict) -> None:
    """Config 8 (INNER, one match a fact row): exactly n rows, time_ and
    latency the fact columns bit for bit in row order, svc == service ==
    the fact row's service, owner == team-{i % 4}."""
    cols = joined(result)
    n = len(jf["svc_idx"])
    idx = jf["svc_idx"].astype(np.int64)
    check(len(cols["time_"]) == n, f"join8: {len(cols['time_'])} rows, expected {n}")
    check(np.array_equal(cols["time_"], np.arange(n, dtype=np.int64) * 1000), "join8: time_")
    check(f64_bits_equal(cols["latency"], jf["latency"]), "join8: latency")
    check(np.array_equal(name_index(cols["svc"], SERVICES), idx), "join8: svc")
    check(np.array_equal(name_index(cols["service"], SERVICES), idx), "join8: service")
    check(np.array_equal(name_index(cols["owner"], [f"team-{i}" for i in range(4)]), idx % 4),
          "join8: owner")


def verify_join8_outer(result, jf: dict) -> None:
    """The OUTER join to svc_owners_partial, in order: the owned fact rows in
    row order with their owner; then the unowned fact rows in row order with
    svc and owner ""; then the 4 ghost rows with time_ 0, service "" and
    latency 0.0."""
    cols = joined(result)
    partial = partial_owners()
    idx = jf["svc_idx"].astype(np.int64)
    owned = ~np.isin(idx, UNOWNED)
    rows = np.concatenate([np.flatnonzero(owned), np.flatnonzero(~owned)])
    m, n = int(owned.sum()), len(idx)
    ghosts = [partial.index(f"ghost-{j}") for j in range(4)]
    pos = np.array([partial.index(s) if s in partial else -1 for s in SERVICES])
    nulls = np.full(n - m, -1)
    check(len(cols["time_"]) == n + 4, f"join8_outer: {len(cols['time_'])} rows, expected {n + 4}")
    check(np.array_equal(cols["time_"], np.concatenate([rows * 1000, [0] * 4])),
          "join8_outer: time_")
    check(f64_bits_equal(cols["latency"], np.concatenate([jf["latency"][rows], [0.0] * 4])),
          "join8_outer: latency")
    check(np.array_equal(name_index(cols["service"], SERVICES),
                         np.concatenate([idx[rows], [-1] * 4])), "join8_outer: service")
    check(np.array_equal(name_index(cols["svc"], partial),
                         np.concatenate([pos[idx[owned]], nulls, ghosts])), "join8_outer: svc")
    check(np.array_equal(name_index(cols["owner"], [f"team-{i}" for i in range(4)]),
                         np.concatenate([pos[idx[owned]] % 4, nulls, np.array(ghosts) % 4])),
          "join8_outer: owner")


def join_fact_truth(jf: dict) -> dict:
    """Per service: rows, latency sum, sum |latency|, min and max (numpy)."""
    idx, lat = jf["svc_idx"].astype(np.int64), jf["latency"]
    per = [lat[idx == i] for i in range(N_SERVICES)]
    return {"count": np.bincount(idx, minlength=N_SERVICES),
            "sum": np.array([p.sum() for p in per]), "abs": np.array([np.abs(p).sum() for p in per]),
            "min": np.array([p.min() for p in per]), "max": np.array([p.max() for p in per])}


def verify_join8_team_agg(result, truth: dict) -> None:
    """Per team t, over the fact rows of services i with i % 4 == t: n
    exact, lat_min and lat_max bit for bit, lat_total and lat_mean within
    1e-12 * sum |latency| (over n for the mean) of numpy's."""
    rows = result.table("out")
    check(rows["owner"] == [f"team-{t}" for t in range(4)], f"team_agg: groups {rows['owner']}")
    for t in range(4):
        sel = np.arange(N_SERVICES) % 4 == t
        n, total, mag = (int(truth["count"][sel].sum()), truth["sum"][sel].sum(),
                         truth["abs"][sel].sum())
        check(rows["n"][t] == n, f"team_agg team-{t}: n {rows['n'][t]}, expected {n}")
        check(abs(rows["lat_total"][t] - total) <= 1e-12 * mag, f"team_agg team-{t}: lat_total")
        check(abs(rows["lat_mean"][t] - total / n) <= 1e-12 * mag / n, f"team_agg team-{t}: lat_mean")
        check(f64_bits_equal([rows["lat_min"][t]], [truth["min"][sel].min()]), f"team_agg team-{t}: lat_min")
        check(f64_bits_equal([rows["lat_max"][t]], [truth["max"][sel].max()]), f"team_agg team-{t}: lat_max")


def verify_join8_oncall_agg(result, truth: dict) -> None:
    """The 12 services with k_i = i % 4 > 0 on-call rows, in code order:
    n = k_i * c_i, seats_total = c_i * sum_j seats_ij and seats_max exact,
    lat_total within 1e-12 * k_i * sum |latency_i| of k_i * sum latency_i."""
    rows = result.table("out")
    have = [i for i in range(N_SERVICES) if i % 4]
    check(rows["service"] == [SERVICES[i] for i in have], f"oncall_agg: groups {rows['service']}")
    for r, i in enumerate(have):
        k, c = i % 4, int(truth["count"][i])
        seats = [1 + (i + j) % 5 for j in range(k)]
        check(rows["n"][r] == k * c, f"oncall_agg svc-{i}: n")
        check(rows["seats_total"][r] == c * sum(seats), f"oncall_agg svc-{i}: seats_total")
        check(rows["seats_max"][r] == max(seats), f"oncall_agg svc-{i}: seats_max")
        check(abs(rows["lat_total"][r] - k * truth["sum"][i]) <= 1e-12 * k * truth["abs"][i],
              f"oncall_agg svc-{i}: lat_total")


def verify_join8_left_agg(result, truth: dict) -> None:
    """The four teams and the unowned services' group (owner ""), in
    LEFT_AGG_OWNERS' order: n exact, lat_max bit for bit, lat_mean within a
    relative 1e-12 of numpy's."""
    rows = result.table("out")
    check(rows["owner"] == LEFT_AGG_OWNERS, f"left_agg: groups {rows['owner']}")
    partial = partial_owners()
    team = [f"team-{partial.index(s) % 4}" if i not in UNOWNED else ""
            for i, s in enumerate(SERVICES)]
    for r, owner in enumerate(LEFT_AGG_OWNERS):
        sel = np.array([t == owner for t in team])
        n, total = int(truth["count"][sel].sum()), truth["sum"][sel].sum()
        check(rows["n"][r] == n, f"left_agg {owner!r}: n {rows['n'][r]}, expected {n}")
        check(abs(rows["lat_mean"][r] - total / n) <= 1e-12 * abs(total / n),
              f"left_agg {owner!r}: lat_mean")
        check(f64_bits_equal([rows["lat_max"][r]], [truth["max"][sel].max()]),
              f"left_agg {owner!r}: lat_max")


def let_events(n_rows: int) -> dict:
    """Q1-Q4's http_events, seed 47, as dictionary codes and values: 16
    services; request paths /api/v1/res-<r>/<id> over 32 resources and 128
    ids (code r * 128 + id), /healthz at 2% (code 4096) and /readyz at 1%
    (4097); 1024 client IPs and '-' at 1% (code 1024); config 2's status
    mix; exponential(3e7) latency; lognormal(7, 1) body sizes, rounded;
    rows 18 us apart, ending at LET_NOW."""
    rng = np.random.default_rng(47)
    u = rng.random(n_rows)
    path = rng.integers(0, N_PATHS, n_rows).astype(np.int32)
    path[u < 0.02] = N_PATHS
    path[(u >= 0.02) & (u < 0.03)] = N_PATHS + 1
    addr = rng.integers(0, N_ADDRS, n_rows).astype(np.int32)
    addr[rng.random(n_rows) < 0.01] = N_ADDRS
    opts = np.array(STATUSES, np.int64)
    status = opts[np.searchsorted(np.cumsum([0.85, 0.05, 0.05, 0.05]), rng.random(n_rows),
                                  side="right")]
    return dict(
        time_=LET_NOW - (n_rows - np.arange(n_rows, dtype=np.int64)) * LET_ROW_NS,
        svc=rng.integers(0, N_SERVICES, n_rows).astype(np.int32),
        path=path, addr=addr, status=status,
        latency=rng.exponential(3e7, n_rows),
        body=np.round(rng.lognormal(7.0, 1.0, n_rows)).astype(np.int64),
    )


def let_dictionaries() -> dict:
    paths = [f"/api/v1/res-{r}/{i}" for r in range(N_RESOURCES) for i in range(N_IDS)]
    addrs = [f"10.0.{i // 256}.{i % 256}" for i in range(N_ADDRS)]
    return {"service": LET_SERVICES, "req_path": paths + ["/healthz", "/readyz"],
            "remote_addr": addrs + ["-"]}


def build_let_carnot(ev: dict, n_rows: int, device: str):
    """Q1-Q4's table with identity dictionary codes, written in 16M-row
    chunks."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
        ("req_path", DataType.STRING), ("remote_addr", DataType.STRING),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
        ("resp_body_size", DataType.INT64, SemanticType.ST_BYTES),
    )
    table = carnot.table_store.create_table("http_events", rel, size_limit=1 << 42)
    for col, values in let_dictionaries().items():
        for v in values:
            table.dictionaries[col].get_code(v)
    codes = {"service": "svc", "req_path": "path", "remote_addr": "addr"}
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        sl = slice(off, min(off + chunk, n_rows))
        table.write_pydict({
            "time_": ev["time_"][sl],
            **{c: DictColumn(ev[k][sl], table.dictionaries[c]) for c, k in codes.items()},
            "resp_status": ev["status"][sl], "latency": ev["latency"][sl],
            "resp_body_size": ev["body"][sl],
        })
    table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == n_rows, "let table expired rows")
    return carnot


def let_truth(ev: dict) -> dict:
    """numpy truths of Q1-Q4 from the generated columns."""
    keep = (ev["path"] < N_PATHS) & (ev["addr"] < N_ADDRS)
    fam = keep & np.isin(ev["svc"], LET_FAMILY)
    t = {}
    # Q1: per (service, window) count, failures, body bytes, latency histogram.
    win = ev["time_"][fam] - np.remainder(ev["time_"][fam], LET_WINDOW_NS)
    w0 = int(win.min()) if win.size else 0
    wi = (win - w0) // LET_WINDOW_NS
    nw = int(wi.max()) + 1 if win.size else 1
    g = ev["svc"][fam].astype(np.int64) * nw + wi
    size = N_SERVICES * nw
    # Integer sums below 2^53 are exact in f64 in any order.
    t["q1"] = dict(
        w0=w0, nw=nw,
        count=np.bincount(g, minlength=size),
        fail=np.bincount(g, weights=ev["status"][fam] >= 400, minlength=size).astype(np.int64),
        bytes=np.bincount(g, weights=ev["body"][fam], minlength=size).astype(np.int64),
        hist=np.bincount(g * TRUTH_BINS + np.digitize(ev["latency"][fam], TRUTH_EDGES),
                         minlength=size * TRUTH_BINS).reshape(size, TRUTH_BINS),
    )
    st, cnt = np.unique(ev["status"][fam], return_counts=True)
    t["q2"] = dict(zip(st.tolist(), cnt.tolist()))
    lat = ev["latency"][fam]
    bins, cnt = np.unique((lat - np.remainder(lat, float(LET_BIN_NS))).astype(np.int64),
                          return_counts=True)
    t["q3"] = dict(zip(bins.tolist(), cnt.tolist()))
    # Q4: the endpoint of a path is its resource (code // 128), then the
    # two health paths.
    ep = np.where(ev["path"] < N_PATHS, ev["path"] // N_IDS,
                  N_RESOURCES + ev["path"] - N_PATHS).astype(np.int64)
    E = N_RESOURCES + 2
    x = ev["latency"]
    err = np.where(ev["status"] >= 400, ev["body"], 0)
    q4 = dict(
        n=np.bincount(ep, minlength=E),
        err_bytes=np.bincount(ep, weights=err, minlength=E).astype(np.int64),
        ms=np.bincount(ep, weights=np.floor(x / 1e6), minlength=E).astype(np.int64),
        sum=np.zeros(E), sumsq=np.zeros(E), mlog=np.zeros(E), path_max=np.zeros(E, np.int64),
    )
    pf = np.bincount(ev["path"], minlength=N_PATHS + 2)
    for e in range(E):
        xs = x[ep == e]  # np.sum adds pairwise: the f64 truths' error stays ~1e-16
        q4["sum"][e], q4["sumsq"][e] = np.sum(xs), np.sum(xs * xs)
        q4["mlog"][e] = np.sum(np.log10(xs))
        codes = (np.arange(e * N_IDS, (e + 1) * N_IDS) if e < N_RESOURCES
                 else [N_PATHS + e - N_RESOURCES])
        q4["path_max"][e] = pf[codes].max()
    seen = np.zeros((E, N_ADDRS + 1), bool)
    seen[ep, ev["addr"]] = True
    q4["clients"] = seen.sum(axis=1)
    t["q4"] = q4
    return t


def endpoint_names() -> list:
    return [f"/api/v1/res-{r}/{{id}}" for r in range(N_RESOURCES)] + ["/healthz", "/readyz"]


def verify_q1(result, t: dict) -> None:
    """Q1 (svc_let): the (service, window) groups of svc-1 and svc-10..15,
    time_ the window start, request and byte throughputs exact (count and
    byte sum over 10 s), error rate within 1e-9 of the truth's, p50, p90
    and p99 within 4% of the truth histogram's."""
    rows = result.table("let")
    q = t["q1"]
    want = {(LET_SERVICES[k // q["nw"]], q["w0"] + (k % q["nw"]) * LET_WINDOW_NS)
            for k in np.flatnonzero(q["count"])}
    got = list(zip(rows["k8s"], rows["time_"]))
    check(len(got) == len(set(got)) and set(got) == want, f"let groups: {len(got)} vs {len(want)}")
    for i, (svc, ts) in enumerate(got):
        k = LET_SERVICES.index(svc) * q["nw"] + (ts - q["w0"]) // LET_WINDOW_NS
        n = int(q["count"][k])
        check(rows["request_throughput"][i] == n / LET_WINDOW_NS, f"let {svc} {ts}: throughput")
        check(rows["bytes_throughput"][i] == int(q["bytes"][k]) / LET_WINDOW_NS,
              f"let {svc} {ts}: bytes")
        er = rows["error_rate"][i] * LET_WINDOW_NS / n
        check(abs(er - q["fail"][k] / n) <= 1e-9, f"let {svc} {ts}: error rate")
        for key, qq in (("latency_p50", 0.50), ("latency_p90", 0.90), ("latency_p99", 0.99)):
            want_q = truth_quantile(q["hist"][k], qq)
            check(abs(rows[key][i] - want_q) <= 0.04 * want_q, f"let {svc} {ts}: {key}")


def verify_q2(result, t: dict) -> None:
    rows = result.table("codes")
    check(dict(zip(rows["resp_status"], rows["count"])) == t["q2"], "http_code_histogram counts")


def verify_q3(result, t: dict) -> None:
    rows = result.table("lat_hist")
    check(dict(zip(rows["request_latency"], rows["count"])) == t["q3"],
          "latency_histogram bins and counts")


def verify_q4(result, t: dict) -> None:
    """Q4: counts, the select sum and the floor(ms) sum exact; distinct
    clients within 12% per endpoint and 2.5% on average; count-min total
    exact and max_est between the largest true path frequency and the
    total; variance within 4e-12 * sumsq / n of the truth's formula, stddev
    correspondingly; mean(log10) within a relative 1e-12."""
    rows = result.table("load")
    q = t["q4"]
    check(rows["endpoint"] == endpoint_names(), f"load endpoints: {rows['endpoint'][:3]}...")
    rel = []
    for e in range(len(rows["endpoint"])):
        n = int(q["n"][e])
        check(rows["n"][e] == n, f"load {e}: n")
        check(rows["err_bytes"][e] == q["err_bytes"][e], f"load {e}: err_bytes")
        check(rows["ms"][e] == q["ms"][e], f"load {e}: ms")
        cm = json.loads(rows["paths"][e])
        check(cm["total"] == n and q["path_max"][e] <= cm["max_est"] <= n, f"load {e}: count_min")
        rel.append(abs(rows["clients"][e] - q["clients"][e]) / q["clients"][e])
        ex2 = q["sumsq"][e] / n
        var = ex2 - (q["sum"][e] / n) ** 2
        check(abs(rows["var"][e] - var) <= 4e-12 * ex2, f"load {e}: variance")
        check(abs(rows["sd"][e] ** 2 - var) <= 4e-12 * ex2, f"load {e}: stddev")
        mlog = q["mlog"][e] / n
        check(abs(rows["mlog"][e] - mlog) <= 1e-12 * abs(mlog), f"load {e}: mean log10")
    check(max(rel) <= 0.12 and float(np.mean(rel)) <= 0.025, f"load clients: rel err {max(rel)}")


def verify(result, data: dict, n_rows: int) -> None:
    """bench.py's run_config_2 verify(), unchanged in substance."""
    rows = result.table("service_stats")
    by_svc = {s: i for i, s in enumerate(rows["service"])}
    check(len(by_svc) == N_SERVICES, f"got {len(by_svc)} groups")
    check(sum(rows["throughput"]) == n_rows, "row count mismatch")
    for j in range(N_SERVICES):
        i = by_svc[f"ns/svc-{j}"]
        check(rows["throughput"][i] == data["tc"][j], f"count of svc-{j}")
        want_er = data["te"][j] / data["tc"][j]
        check(abs(rows["error_rate"][i] - want_er) < 1e-9, f"error_rate of svc-{j}")
        q = json.loads(rows["latency"][i])
        for key, qq in (("p50", 0.50), ("p99", 0.99)):
            want = truth_quantile(data["th"][j], qq)
            check(abs(q[key] - want) <= 0.04 * want, f"{key} of svc-{j}")


def countmin_max_truth(ts: np.ndarray, statuses=STATUSES) -> np.ndarray:
    """Per service, the largest count-min cell the true per-status counts
    give: each status adds its count into its four buckets (the plain
    _buckets), and max_est is the largest cell of all four rows."""
    from pixie_tpu_torch.ops import countmin

    buckets = countmin._buckets(torch.tensor(statuses, dtype=torch.int64),
                                countmin.DEFAULT_DEPTH, countmin.DEFAULT_WIDTH)
    out = np.zeros(N_SERVICES, np.int64)
    for j in range(N_SERVICES):
        cells = np.zeros((countmin.DEFAULT_DEPTH, countmin.DEFAULT_WIDTH), np.int64)
        for d, b in enumerate(buckets):
            np.add.at(cells[d], b.numpy(), ts[j])
        out[j] = cells.max()
    return out


def verify_sketches(result, data: dict, n_rows: int) -> None:
    """Config 5: count-min totals equal the true per-service counts, max_est
    is at least the largest true status count and equals the bucket truth,
    and the t-digest p50/p99 lie within 4% of the truth histogram's."""
    rows = result.table("sketches")
    by_svc = {s: i for i, s in enumerate(rows["service"])}
    check(len(by_svc) == N_SERVICES, f"sketches: got {len(by_svc)} groups")
    max_truth = data.setdefault(
        "cm_max", countmin_max_truth(data["ts"], data.get("statuses", STATUSES)))
    for j in range(N_SERVICES):
        i = by_svc[f"ns/svc-{j}"]
        f = json.loads(rows["freq"][i])
        check(f["total"] == data["tc"][j], f"count-min total of svc-{j}")
        check(f["max_est"] >= data["ts"][j].max(), f"max_est of svc-{j} below its top status")
        check(f["max_est"] == max_truth[j], f"max_est of svc-{j}: {f['max_est']} != {max_truth[j]}")
        q = json.loads(rows["lat"][i])
        for key, qq in (("p50", 0.50), ("p99", 0.99)):
            want = truth_quantile(data["th"][j], qq)
            check(abs(q[key] - want) <= 0.04 * want, f"t-digest {key} of svc-{j}")


def verify_flows(result, fl: dict, n_rows: int) -> None:
    """Config 3: 4096 groups, byte sums equal the bincount truths, distinct
    ports within 12% for every pair (5.2 sigma at 1.04/sqrt(2048)) and mean
    |relative error| <= 2.5%."""
    rows = result.table("flows")
    check(len(rows["src"]) == FLOW_GROUPS, f"flows: got {len(rows['src'])} groups")
    pod = lambda name: int(name.rsplit("-", 1)[1])
    pair = np.array([pod(a) * N_PODS + pod(b) for a, b in zip(rows["src"], rows["dst"])])
    check(np.array_equal(np.sort(pair), np.arange(FLOW_GROUPS)), "flows: (src, dst) pairs")
    check(np.array_equal(np.asarray(rows["bytes_sent"]), fl["sent"][pair]), "bytes_sent")
    check(np.array_equal(np.asarray(rows["bytes_recv"]), fl["recv"][pair]), "bytes_recv")
    rel = np.abs(np.asarray(rows["ports"]) / fl["distinct"][pair] - 1.0)
    check(rel.max() <= 0.12, f"distinct ports: max rel err {rel.max():.4f}")
    check(rel.mean() <= 0.025, f"distinct ports: mean rel err {rel.mean():.4f}")
    fl["ports_rel"] = (float(rel.max()), float(rel.mean()))


def verify_flow_window(result) -> None:
    """flow_window: one row, time_min 0 and time_max (FLOW_ROWS - 1) * 1000
    ns, exactly."""
    rows = result.table("window")
    check(rows["time_min"] == [0] and rows["time_max"] == [(FLOW_ROWS - 1) * 1000],
          f"flow_window: {rows}")


def verify_status_mix(result, data: dict) -> None:
    """status_mix: 16 groups; distinct statuses within HLL's 12% of 4 in every
    group; count-min totals equal the true per-service counts and max_est
    the largest true cell."""
    rows = result.table("status_mix")
    by_svc = {s: i for i, s in enumerate(rows["service"])}
    check(len(by_svc) == N_SERVICES, f"status_mix: got {len(by_svc)} groups")
    max_truth = data.setdefault("cm_max", countmin_max_truth(data["ts"]))
    for j in range(N_SERVICES):
        i = by_svc[f"ns/svc-{j}"]
        check(abs(rows["kinds"][i] - len(STATUSES)) <= 0.12 * len(STATUSES),
              f"status_mix kinds of svc-{j}: {rows['kinds'][i]}")
        f = json.loads(rows["freq"][i])
        check(f["total"] == data["tc"][j], f"status_mix count-min total of svc-{j}")
        check(f["max_est"] == max_truth[j], f"status_mix max_est of svc-{j}")


def sorted_events(n_rows: int) -> dict:
    """http_events rows sorted by (service, status), stable: the run-heavy
    table of the sorted-key path, with its per-(service, status) truths."""
    data = http_events(n_rows)
    order = np.lexsort((data["status"], data["svc"]))
    out = dict(data)
    for k in ("svc", "status", "latency"):
        out[k] = data[k][order]
    return out


def verify_sorted(result, data: dict, want: dict) -> None:
    """The sorted-key path: 64 (service, status) groups in row order, counts
    and status sums equal the generator's truths, maxima equal the plain
    path's and the latency sums within 1e-12 of them, relative."""
    rows = result.table("sorted")
    n = N_SERVICES * len(STATUSES)
    check(len(rows["n"]) == n, f"sorted: {len(rows['n'])} groups")
    check(rows["service"] == [f"ns/svc-{j}" for j in range(N_SERVICES) for _ in STATUSES],
          "sorted: group order")
    check(rows["resp_status"] == list(STATUSES) * N_SERVICES, "sorted: status keys")
    check(np.array_equal(rows["n"], data["ts"].reshape(-1)), "sorted: counts")
    check(np.array_equal(rows["st"], (data["ts"] * np.array(STATUSES)).reshape(-1)),
          "sorted: status sums")
    check(rows["lat_max"] == want["lat_max"], "sorted: latency maxima vs the plain path")
    check(np.allclose(rows["lat"], want["lat"], rtol=1e-12, atol=0), "sorted: latency sums")


def quantiles_close(got: list, want: list, what: str) -> float:
    """The quantile contract between the kernel path and the plain path
    (PERF.md): parsed values within a relative 1e-2 (Fault-4), and three
    quarters within 1e-5. Returns the largest relative difference."""
    rel = []
    for gq, wq in zip(got, want):
        g, w = json.loads(gq), json.loads(wq)
        check(list(g) == list(w), f"{what}: quantile keys")
        rel += [abs(g[k] - w[k]) / max(abs(w[k]), 1e-300) for k in w]
    rel = np.array(rel)
    check(rel.max() <= 1e-2, f"{what}: quantile rel diff {rel.max()}")
    check((rel <= 1e-5).mean() >= 0.75, f"{what}: under 3/4 of quantiles within 1e-5")
    return float(rel.max())


def slice_parity(n_rows: int) -> None:
    """The kernel path against the plain path end to end, for the three
    queries of the earlier slices and the flows min/max, config 1 and config
    4 plain and filtered (any() through H11), and config 8's join and its
    LEFT, RIGHT and OUTER variants over svc_owners and svc_owners_partial."""
    from pixie_tpu_torch.ops.histogram import DEFAULT_SPEC

    data = http_events(n_rows)
    cuda, cpu = build_carnot(data, n_rows, CARD), build_carnot(data, n_rows, "cpu")
    got = cuda.execute_query(SERVICE_STATS).table("service_stats")
    want = cpu.execute_query(SERVICE_STATS).table("service_stats")
    check(got["service"] == want["service"], "group set/order: cuda vs cpu")
    check(got["throughput"] == want["throughput"], "throughput: cuda vs cpu")
    check(np.allclose(got["error_rate"], want["error_rate"], rtol=0, atol=1e-12),
          "error_rate: cuda vs cpu")
    for gq, wq in zip(got["latency"], want["latency"]):
        g, w = json.loads(gq), json.loads(wq)
        for k in w:
            check(g[k] == w[k] or max(g[k], w[k]) / min(g[k], w[k])
                  <= DEFAULT_SPEC.gamma * (1 + 1e-9), f"quantile {k}: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: service_stats kernel path == plain path")
    got = cuda.execute_query(SKETCHES).table("sketches")
    want = cpu.execute_query(SKETCHES).table("sketches")
    check(got["service"] == want["service"], "sketches group set/order: cuda vs cpu")
    check(got["freq"] == want["freq"], "count-min JSON: cuda vs cpu")
    worst = quantiles_close(got["lat"], want["lat"], "t-digest cuda vs cpu")
    log(f"slice parity at {n_rows} rows: sketches count-min JSON equal, t-digest "
        f"quantiles max rel diff {worst:.3g}")
    fl = conn_flows(n_rows)
    flows_cuda = build_flows_carnot(fl, n_rows, CARD)
    flows_cpu = build_flows_carnot(fl, n_rows, "cpu")
    got = flows_cuda.execute_query(FLOWS).table("flows")
    want = flows_cpu.execute_query(FLOWS).table("flows")
    for k in ("src", "dst", "bytes_sent", "bytes_recv"):
        check(got[k] == want[k], f"flows {k}: cuda vs cpu")
    dp = np.abs(np.asarray(got["ports"]) - np.asarray(want["ports"]))
    # Equal registers; H10's f64 sum may round a .5 the other way.
    check(dp.max() <= 1 and (dp > 0).mean() <= 1e-3, "flows ports: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: flows groups and byte sums equal, "
        f"{int((dp > 0).sum())} of {dp.size} distinct counts one apart")
    got = flows_cuda.execute_query(FLOW_SPAN).table("flow_span")
    want = flows_cpu.execute_query(FLOW_SPAN).table("flow_span")
    check(got == want, "flow_span: cuda vs cpu")
    hs = http_small(n_rows)
    got = build_small_carnot(hs, n_rows, CARD)[0].execute_query(HTTP_DATA).table("out")
    want = build_small_carnot(hs, n_rows, "cpu")[0].execute_query(HTTP_DATA).table("out")
    check(got == want and len(got["time_"]) == SCAN_LIMIT, "http_data: cuda vs cpu")
    st = stacks(n_rows)
    st_cuda, st_cpu = build_stacks_carnot(st, n_rows, CARD), build_stacks_carnot(st, n_rows, "cpu")
    for query in (FLAMEGRAPH, FLAMEGRAPH_FILTERED):
        got = st_cuda.execute_query(query).table("merged")
        want = st_cpu.execute_query(query).table("merged")
        check(got == want and len(got["stack_trace_id"]) == N_STACKS, "flamegraph: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: flow_span, http_data and flamegraph (plain and "
        "filtered) kernel path == plain path, every column")
    jf = join_fact(n_rows)
    join_cuda, join_cpu = build_join_carnot(jf, n_rows, CARD), build_join_carnot(jf, n_rows, "cpu")
    for how in ("inner", "left", "right", "outer"):
        for query in (JOIN8.replace("how='inner'", f"how='{how}'"),
                      JOIN8_OUTER.replace("how='outer'", f"how='{how}'")):
            got, want = joined(join_cuda.execute_query(query)), joined(join_cpu.execute_query(query))
            check(got.keys() == want.keys(), f"join {how}: columns")
            for k in got:
                a, b = got[k], want[k]
                same = (np.array_equal(a.decode(), b.decode()) if hasattr(a, "decode")
                        else np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)))
                check(same, f"join {how} {k}: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: joins INNER, LEFT, RIGHT and OUTER to svc_owners and "
        "svc_owners_partial, kernel path == plain path, every column and row order")
    for query in (JOIN8_TEAM_AGG, JOIN8_ONCALL_AGG, JOIN8_LEFT_AGG):
        got = join_cuda.execute_query(query).table("out")
        want = join_cpu.execute_query(query).table("out")
        check(got.keys() == want.keys() and len(got["n"]) > 0, "join aggregates: columns")
        for k in got:
            if want[k] and isinstance(want[k][0], float) and not k.endswith(("_min", "_max")):
                check(np.allclose(got[k], want[k], rtol=1e-12, atol=0), f"join aggregate {k}: cuda vs cpu")
            else:
                check(got[k] == want[k], f"join aggregate {k}: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: join8_team_agg, join8_oncall_agg (join-aggregate lane) "
        "and join8_left_agg (host AggNode): groups, counts, ints and min/max equal, sums within "
        "1e-12 relative")
    # The new paths, at the default window (one window here) and at 2^18-row
    # windows (four windows, each its own block, through the pinned ring and
    # the side stream), each run twice on the card.
    from pixie_tpu_torch.utils import flags

    for window in (flags.streaming_window_rows, 1 << 18):
        flags.set("streaming_window_rows", window)
        try:
            for rep in range(2):
                for c in (cuda, cpu, flows_cuda, flows_cpu):
                    c.device_executor.clear_caches()
                got = flows_cuda.execute_query(FLOW_WINDOW).table("window")
                want = flows_cpu.execute_query(FLOW_WINDOW).table("window")
                check(got == want and got["time_max"] == [(n_rows - 1) * 1000],
                      f"flow_window: cuda vs cpu ({window}-row windows)")
                got = cuda.execute_query(STATUS_MIX).table("status_mix")
                want = cpu.execute_query(STATUS_MIX).table("status_mix")
                check(got["service"] == want["service"] and got["freq"] == want["freq"],
                      f"status_mix: cuda vs cpu ({window}-row windows)")
                dk = np.abs(np.asarray(got["kinds"]) - np.asarray(want["kinds"]))
                check(dk.max() <= 1, "status_mix kinds: cuda vs cpu")
        finally:
            flags.reset("streaming_window_rows")
    log(f"slice parity at {n_rows} rows: flow_window and status_mix kernel path == plain path, "
        "one window and four, twice each")
    ml_parity(cuda, cpu, flows_cuda, flows_cpu, n_rows)
    shared_scan_parity(cuda, cpu, n_rows)
    let_parity(n_rows)


class CaptureScans:
    """Stands in for an executor's shared-scan coordinator: runs each query
    alone and keeps what it offered the coordinator (keys, terms and its
    compute_batch)."""

    def __init__(self):
        self.calls = []

    def run(self, key, compute, batch_key=None, terms=None, compute_batch=None):
        solo = compute()
        self.calls.append(dict(key=key, batch_key=batch_key, terms=terms,
                               compute_batch=compute_batch, solo=solo))
        return solo


def batched_call(carnot, queries: list) -> tuple:
    """Each query once (the first stages what all of them read), then again
    with the coordinator captured, then ONE ``_run_program_batched`` call
    over every query's terms: (each query's solo outputs, each slot's)."""
    ex = carnot.device_executor
    for q in queries:
        carnot.execute_query(q)
    cap, saved = CaptureScans(), ex._shared_scans
    ex._shared_scans = cap
    try:
        for q in queries:
            carnot.execute_query(q)
    finally:
        ex._shared_scans = saved
    calls = cap.calls
    check(len(calls) == len(queries) and all(c["terms"] is not None for c in calls)
          and len({c["batch_key"] for c in calls}) == 1,
          "batched parity: the queries do not share one batch key")
    return [c["solo"] for c in calls], calls[0]["compute_batch"]([c["terms"] for c in calls])


def outputs_close(got, want, what: str, sketch: bool, same_bins: bool) -> None:
    """One slot's outputs against another run's: presence and counts exact;
    f64 sums within 1e-12 * sum |v| (the latencies are positive, so sum |v|
    is the sum); quantiles equal (``same_bins``: both runs binned by H3) or
    one log bin apart (Fault-1, the card against the CPU); HLL estimates
    within a relative 1e-12 (equal registers)."""
    from pixie_tpu_torch.ops.histogram import DEFAULT_SPEC

    (gv, gp), gcap = got
    (wv, wp), wcap = want
    check(gcap == wcap and np.array_equal(gp, wp), f"{what}: presence")
    if not sketch:
        check(np.array_equal(gv[0], wv[0]), f"{what}: counts")
        check(bool(np.all(np.abs(gv[1] - wv[1]) <= 1e-12 * np.abs(wv[1]))), f"{what}: sums")
        return
    gq, wq = np.asarray(gv[0]), np.asarray(wv[0])
    ratio = np.maximum(gq, wq) / np.maximum(np.minimum(gq, wq), 1e-300)
    near = np.zeros(gq.shape, bool) if same_bins else ratio <= DEFAULT_SPEC.gamma * (1 + 1e-9)
    check(bool(np.all((gq == wq) | near)), f"{what}: quantiles")
    check(bool(np.all(np.abs(np.asarray(gv[1]) - np.asarray(wv[1]))
                      <= 1e-12 * np.abs(np.asarray(wv[1])))), f"{what}: HLL estimates")


def shared_scan_parity(cuda, cpu, n_rows: int) -> None:
    """K16's batched fold, kernel path against plain path: one batch of the
    sum group's seven families and one of the sketch group's three
    thresholds, each called directly through ``_run_program_batched`` (a
    fixed composition) on both executors; every slot of the card's batch
    also against the card's solo run of its query. H22 and H23 must have
    launched."""
    from pixie_tpu_torch.ops import kernels

    groups = (("sum", [soak_query(p, ("n", "total")) for p, _ in SOAK_PREDS], False),
              ("sketch", SKETCH_GROUP, True))
    for name, queries, sketch in groups:
        kernels.reset_launches()
        solo_c, slots_c = batched_call(cuda, queries)
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] for k in ("pred_slot_masks", "batched_segment_sums")}
        check(all(launched.values()), f"batched parity {name}: H22/H23 not launched: {launched}")
        _, slots_p = batched_call(cpu, queries)
        for s, (a, b, solo) in enumerate(zip(slots_c, slots_p, solo_c)):
            outputs_close(a, b, f"batched {name} slot {s}: cuda vs cpu", sketch, False)
            outputs_close(a, solo, f"batched {name} slot {s}: batched vs solo on the card",
                          sketch, True)
    log(f"slice parity at {n_rows} rows: K16 batched fold (7 sum families, 3 sketch thresholds) "
        "kernel path == plain path and == each query alone on the card")


def shared_truths(data: dict) -> list:
    """Per sum-group family: (counts, latency sums) per service, numpy."""
    out = []
    for _, fam in SOAK_PREDS:
        keep = fam(data["status"], data["latency"])
        svc = data["svc"][keep]
        out.append((np.bincount(svc, minlength=N_SERVICES),
                    np.bincount(svc, weights=data["latency"][keep], minlength=N_SERVICES)))
    return out


def verify_shared(res: dict, q: int, truths: list, serial: dict) -> None:
    """A shared-scan result against numpy (sum group: counts per service
    exact, latency sums within 1e-12 * sum |v|; sketch group: four status
    kinds per service within 12%) and against its serial baseline (counts,
    quantile JSON and distinct counts equal; sums within 1e-12 * sum |v|)."""
    cols = list(res)
    check(cols == list(serial) and res["service"] == serial["service"],
          f"shared query {q}: columns or groups differ from serial")
    if q < len(SUM_GROUP):
        counts, sums = truths[q // 2]
        idx = [int(s.rsplit("-", 1)[1]) for s in res["service"]]
        check(np.array_equal(np.asarray(res[cols[1]]), counts[idx]),
              f"shared query {q}: counts vs numpy")
        check(res[cols[1]] == serial[cols[1]], f"shared query {q}: counts vs serial")
        got = np.asarray(res[cols[2]])
        for want in (sums[idx], np.asarray(serial[cols[2]])):
            check(bool(np.all(np.abs(got - want) <= 1e-12 * sums[idx])),
                  f"shared query {q}: latency sums beyond 1e-12 * sum |v|")
    else:
        check(res["q"] == serial["q"] and res["u"] == serial["u"],
              f"shared query {q}: sketches differ from serial")
        check(all(abs(u - 4) <= 0.12 * 4 for u in res["u"]), f"shared query {q}: status kinds")


def shared_scan_path(carnot, data: dict, profile: bool) -> dict:
    """The concurrent serving path (bench.py config 6's query families over
    the service_stats table): the serial baselines first (each query twice,
    the second warm run timed), then SOAK_CLIENTS closed-loop client threads
    released on a barrier, SOAK_REQUESTS requests each (client i's r-th
    request sends query (i + SOAK_CLIENTS r) mod 17), with shared scans,
    predicate batching and a SOAK_WINDOW_MS window. Launch counts and lanes
    zeroed just before the concurrent run and read just after."""
    from pixie_tpu_torch.ops import kernels, segment
    from pixie_tpu_torch.utils import flags, metrics_registry

    carnot.device_executor.clear_caches()
    truths = shared_truths(data)
    serial, warm = [], []
    for q in SHARED_QUERIES:
        carnot.execute_query(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial.append(carnot.execute_query(q).table("out"))
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    for q, res in enumerate(serial):
        verify_shared(res, q, truths, res)
    m = metrics_registry()
    width = m.histogram("serving_shared_scan_batch_width")
    size = m.histogram("serving_shared_scan_batch_size")
    counters = {k: m.counter(f"serving_shared_scan_{k}_total") for k in (
        "dispatches", "saved_dispatches", "follower_detach", "predicate_batched_queries")}
    plan = [[(i + SOAK_CLIENTS * r) % len(SHARED_QUERIES) for r in range(SOAK_REQUESTS)]
            for i in range(SOAK_CLIENTS)]

    def run_clients():
        results, lat, errors = {}, [], []
        lock = threading.Lock()
        barrier = threading.Barrier(SOAK_CLIENTS)

        def client(i):
            try:
                barrier.wait()
                for r, q in enumerate(plan[i]):
                    t0 = time.perf_counter()
                    res = carnot.execute_query(SHARED_QUERIES[q]).table("out")
                    with lock:
                        lat.append(time.perf_counter() - t0)
                        results[(i, r)] = (q, res)
            except BaseException as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SOAK_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "shared_scan: a client thread hung")
        check(not errors, f"shared_scan: client errors {errors!r}")
        return results, lat, wall

    for k, v in (("shared_scans", True), ("shared_scan_predicate_batching", True),
                 ("shared_scan_window_ms", SOAK_WINDOW_MS)):
        flags.set(k, v)
    try:
        before = {k: c.value() for k, c in counters.items()}
        w0, z0 = width.merged_counts(), size.merged_counts()
        kernels.reset_launches()
        segment.reduce_lanes(reset=True)
        take_shapes()
        results, lat, wall = run_clients()
        launches = dict(kernels.LAUNCHES)
        lanes = segment.reduce_lanes(reset=True)
        shapes = take_shapes()
        delta = {k: c.value() - before[k] for k, c in counters.items()}
        widths = [a - b for a, b in zip(width.merged_counts(), w0)]
        sizes = [a - b for a, b in zip(size.merged_counts(), z0)]
        busy = None
        if profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, _, pwall = run_clients()
            device_us = sum(e.self_device_time_total for e in prof.events()
                            if e.device_type == DeviceType.CUDA)
            busy = (device_us / 1e6, pwall)
            log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20))
    finally:
        for k in ("shared_scan_window_ms", "shared_scan_predicate_batching", "shared_scans"):
            flags.reset(k)
    n_req = SOAK_CLIENTS * SOAK_REQUESTS
    check(len(results) == n_req, "shared_scan: missing results")
    for q, res in results.values():
        verify_shared(res, q, truths, serial[q])
    for name in ("pred_slot_masks", "batched_segment_sums"):
        check(launches[name] > 0, f"kernel {name} was not launched on the shared_scan path")
    check(sum(widths[1:]) > 0, f"shared_scan: no dispatch of width >= 2 ({widths})")
    check(delta["follower_detach"] == 0, "shared_scan: a follower detached")
    serial_s = sum(warm[q] for row in plan for q in row)
    lat = np.sort(np.asarray(lat))
    out = dict(
        launches=launches, lanes=lanes, wall=wall, qps=n_req / wall,
        serial_qps=n_req / serial_s, p50=float(np.percentile(lat, 50)),
        p99=float(np.percentile(lat, 99)), dispatches=delta["dispatches"], requests=n_req,
        widths=widths, sizes=sizes, counters=delta, serial_warm=warm, shapes=shapes,
    )
    log(f"shared_scan: {n_req} requests from {SOAK_CLIENTS} clients in {wall:.4f} s = "
        f"{out['qps']:.2f} queries/s (serial baselines' summed warm time {serial_s:.4f} s = "
        f"{out['serial_qps']:.2f} queries/s); latency p50 {out['p50']:.4f} s, p99 "
        f"{out['p99']:.4f} s; {delta['dispatches']:.0f} dispatches for {n_req} queries "
        f"({delta['dispatches'] / n_req:.3f} a query), saved {delta['saved_dispatches']:.0f}, "
        f"predicate-batched queries {delta['predicate_batched_queries']:.0f}, detached "
        f"{delta['follower_detach']:.0f}")
    log(f"shared_scan batch width histogram (buckets {width.buckets}): {widths}; "
        f"batch size histogram: {sizes}")
    log(f"shared_scan launches: { {k: v for k, v in launches.items() if v} }; lanes {lanes}")
    log(f"shared_scan serial warm s per query: {[round(w, 4) for w in warm]}")
    if busy is not None:
        log(f"profile shared_scan: device busy {busy[0]:.4f} s = {100 * busy[0] / busy[1]:.1f}% "
            f"of the profiled concurrent wall {busy[1]:.4f} s")
    return out


def sorted_path(n_rows: int) -> dict:
    """The sorted-key path (the gid lane and the status column through RLE,
    H18): the kernel path against the plain path at one window and at four,
    twice each, then driven on the card like a main path."""
    from pixie_tpu_torch.utils import flags

    data = sorted_events(n_rows)
    cuda, cpu = build_carnot(data, n_rows, CARD), build_carnot(data, n_rows, "cpu")
    want = cpu.execute_query(SORTED_KEYS).table("sorted")
    verify_sorted(cpu.execute_query(SORTED_KEYS), data, want)
    for window in (flags.streaming_window_rows, 1 << 18):
        flags.set("streaming_window_rows", window)
        try:
            for rep in range(2):
                cuda.device_executor.clear_caches()
                verify_sorted(cuda.execute_query(SORTED_KEYS), data, want)
        finally:
            flags.reset("streaming_window_rows")
    log(f"slice parity at {n_rows} rows: sorted keys kernel path == plain path (one window and "
        "four, twice each)")
    return drive(cuda, SORTED_KEYS, lambda r: verify_sorted(r, data, want),
                 ("codec_rle_decode", "segment_rows_sum_i64", "segment_rows_sum_f64",
                  "segment_minmax"))


def let_parity(n_rows: int) -> None:
    """Q1-Q4, kernel path against plain path at ``n_rows`` rows: groups,
    order, counts, integer sums, count-min JSON and time_ exact; the
    quantile latencies within one log bin (Fault-1); error rates, means and
    variances within a relative 1e-12 (f64 sums in another order); distinct
    counts at most one apart (equal registers, H10's f64 sum)."""
    from pixie_tpu_torch.ops.histogram import DEFAULT_SPEC

    ev = let_events(n_rows)
    cuda, cpu = build_let_carnot(ev, n_rows, CARD), build_let_carnot(ev, n_rows, "cpu")
    for table, query in let_queries().items():
        got = cuda.execute_query(query, now_ns=LET_NOW).table(table)
        want = cpu.execute_query(query, now_ns=LET_NOW).table(table)
        check(got.keys() == want.keys() and len(next(iter(got.values()))) > 0, f"{table}: columns")
        for k in got:
            g, w = got[k], want[k]
            if k.startswith("latency_p"):
                ok = all(abs(a - b) <= (DEFAULT_SPEC.gamma - 1) * max(a, b) * (1 + 1e-9) + 1
                         for a, b in zip(g, w))
            elif k == "clients":
                ok = max(abs(a - b) for a, b in zip(g, w)) <= 1
            elif w and isinstance(w[0], float):
                ok = np.allclose(g, w, rtol=1e-12, atol=0)
            else:
                ok = g == w
            check(ok, f"{table} {k}: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: svc_let, http_code_histogram, latency_histogram and "
        "endpoint load kernel path == plain path (quantiles within a bin, f64 within 1e-12)")


def ring_paths(small, hs: dict, truth: dict, plain_build_s: float, paths: dict) -> dict:
    """Resident ingest on the card: builds http_small_ring in ``small`` with
    ``resident_ingest`` on (the default window and depth: 2^21 rows, 64),
    checks the ring and its accounting, drives http_data_ring (config 1),
    a time-bounded count and sketches_ring (config 5's sketches) over it,
    then releases the ring. Returns the launches of the ring's build (its
    window decodes), which belong to the path."""
    from pixie_tpu_torch.ops import kernels
    from pixie_tpu_torch.parallel import staging
    from pixie_tpu_torch.utils import flags

    ex = small.device_executor
    flags.set("resident_ingest", True)
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        kernels.reset_launches()
        build_s = build_small_table(small, "http_small_ring", hs, SMALL_ROWS)
        build_launches = dict(kernels.LAUNCHES)
        rise = torch.cuda.memory_allocated() - mem0
        ring = ex._resident.ring_for("http_small_ring")
        snap, pool = ring.snapshot(), ex._staged_cache.snapshot()
        log(f"http_small_ring: built in {build_s:.3f} s with its ring, {plain_build_s:.3f} s "
            f"without (http_small); ring {json.dumps(snap)}; pool {json.dumps(pool)}; "
            f"memory_allocated rose {rise} B; launches "
            f"{ {k: v for k, v in build_launches.items() if v} }")
        check(snap["valid"] and snap["last_error"] is None, f"the ring is invalid: {snap}")
        check(snap["windows"] == RING_WINDOWS, f"ring windows {snap['windows']} != {RING_WINDOWS}")
        check(pool["resident_bytes"] == RING_BYTES,
              f"resident bytes {pool['resident_bytes']} != {RING_BYTES}")
        check(pool["pinned_bytes"] >= RING_BYTES, f"pinned bytes {pool['pinned_bytes']}")
        check(rise >= RING_BYTES, f"memory_allocated rose {rise} B < {RING_BYTES}")

        t0 = time.perf_counter()
        p = paths["http_data_ring"] = drive(
            small, HTTP_DATA_RING, lambda r: verify_http_data(r, hs),
            ("scan_compact", "scalar_eval", "ring_convert"), streamed=False,
        )
        cp = p["cold_phases"]
        check(cp.get("stage_resident_hits") == RING_WINDOWS,
              f"http_data_ring: {cp.get('stage_resident_hits')} resident hits")
        check(cp["wire_bytes"] < cp["stage_bytes"] / 3,
              f"http_data_ring: wire {cp['wire_bytes']} of stage {cp['stage_bytes']}")
        check(all(w.get("wire_bytes", 0.0) == 0.0 for w in p["warm_phases"]),
              f"http_data_ring: a warm query copied {p['warm_phases']}")
        check(p["lanes"].get("convert_narrow") == 2 * RING_WINDOWS
              and p["lanes"].get("convert_identity") == 2 * RING_WINDOWS,
              f"http_data_ring: lanes {p['lanes']}")
        log(f"http_data_ring: {time.perf_counter() - t0:.1f} s; lanes {p['lanes']}")

        bounded = (
            "df = px.DataFrame(table='http_small_ring', start_time=0, "
            f"end_time={(BOUNDED_ROWS - 1) * 1000})\n"
            "s = df.groupby(['service']).agg(n=('time_', px.count))\n"
            "px.display(s, 'bounded')\n"
        )
        ex.clear_caches()
        staging.reset_cold_profile()
        rows = small.execute_query(bounded).table("bounded")
        bp = staging.reset_cold_profile()
        want = np.bincount(hs["svc"][:BOUNDED_ROWS], minlength=N_SERVICES)
        got = {s: n for s, n in zip(rows["service"], rows["n"])}
        check(bp.get("stage_resident_hits", 0.0) == 0.0, f"time-bounded query: {bp}")
        check(all(got[f"ns/svc-{j}"] == want[j] for j in range(N_SERVICES))
              and sum(got.values()) == BOUNDED_ROWS, f"time-bounded counts {got}")
        log(f"time-bounded count over http_small_ring ({BOUNDED_ROWS} rows): 0 resident hits, "
            f"counts exact; cold {json.dumps({k: round(v, 3) for k, v in bp.items()})}")

        t0 = time.perf_counter()
        p = paths["sketches_ring"] = drive(
            small, SKETCHES_RING, lambda r: verify_sketches(r, truth, SMALL_ROWS),
            SKETCH_KERNELS + ("ring_convert",),
        )
        cp, lanes = p["cold_phases"], p["lanes"]
        check(cp.get("stage_resident_hits") == RING_WINDOWS
              and cp.get("stream_windows") == RING_WINDOWS + 1,
              f"sketches_ring: {cp.get('stage_resident_hits')} hits in "
              f"{cp.get('stream_windows')} windows")
        check(all(lanes.get(f"convert_{k}") == RING_WINDOWS for k in ("f32", "intdict", "narrow")),
              f"sketches_ring: lanes {lanes}")
        check(lanes.get("cell_lane") == 1 + WARM_QUERIES, f"sketches_ring: lanes {lanes}")
        ring_rows = p["result"].table("sketches")
        plain_rows = paths["sketches_small"]["result"].table("sketches")
        check(ring_rows["service"] == plain_rows["service"]
              and ring_rows["freq"] == plain_rows["freq"],
              "sketches_ring: count-min cells differ from the unringed table's")
        log(f"sketches_ring: {time.perf_counter() - t0:.1f} s; lanes {lanes}; count-min equal to "
            f"sketches_small's; t-digest quantiles bit-equal to sketches_small's: "
            f"{ring_rows['lat'] == plain_rows['lat']}")

        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        ring.release_all()
        torch.cuda.synchronize()
        drop = mem1 - torch.cuda.memory_allocated()
        pool = ex._staged_cache.snapshot()
        check(pool["resident_bytes"] == 0 and pool["resident_windows"] == 0,
              f"released ring still accounted: {pool}")
        check(drop >= RING_BYTES, f"memory_allocated dropped {drop} B < {RING_BYTES}")
        log(f"ring released: resident bytes 0, memory_allocated dropped {drop} B")
    finally:
        flags.reset("resident_ingest")
    return build_launches


# ---------------------------------------------------------------- the ML lane
RESERVOIR_K = 64
RESERVOIR_LATENCY = (
    "df = px.DataFrame(table='http_events')\n"
    "s = df.groupby(['service']).agg(\n"
    "    lat=('latency', px.reservoir_sample),\n"
    "    status=('resp_status', px.reservoir_sample),\n"
    "    n=('latency', px.count),\n"
    ")\n"
    "px.display(s, 'sample')\n"
)
FLOW_SAMPLE_MIN_RECV = 1 << 19  # about half the rows: the masked salt
RESERVOIR_FLOWS = (
    "df = px.DataFrame(table='conn_flows')\n"
    f"df = df[df.bytes_recv >= {FLOW_SAMPLE_MIN_RECV}]\n"
    "s = df.groupby(['src', 'dst']).agg(sent=('bytes_sent', px.reservoir_sample))\n"
    "px.display(s, 'sample')\n"
)
PATH_K = 8
PATH_EMBEDDINGS = (
    "df = px.DataFrame(table='http_events')\n"
    "t = df.groupby(['req_path']).agg(n=('latency', px.count))\n"
    "t.tokens = px.sentencepiece(t.req_path)\n"
    "t.emb = px.transformer(t.tokens)\n"
    f"t.k = {PATH_K}\n"
    "m = t.agg(model=('emb', 'k', px.kmeans))\n"
    "px.display(t[['req_path', 'n', 'emb']], 'emb')\n"
    "px.display(m, 'model')\n"
)
KM_ROWS, KM_K, KM_D = 1 << 16, 4, 64
KMEANS_SERVICES = (
    "df = px.DataFrame(table='embeddings')\n"
    f"df.k = {KM_K}\n"
    "m = df.groupby(['service']).agg(model=('emb', 'k', px.kmeans))\n"
    "px.display(m, 'models')\n"
)


def kmeans_predict_query(model: str) -> str:
    return ("df = px.DataFrame(table='embeddings')\n"
            f"df.cluster = px.kmeans_predict(df.emb, '{model}')\n"
            "s = df.groupby(['cluster']).agg(n=('time_', px.count))\n"
            "px.display(s, 'clusters')\n")


def encoder_flops(lens: np.ndarray) -> float:
    """The encoder's multiply-adds, as 2 operations each, that documents of
    ``lens`` tokens need: per layer and document of l tokens, Q, K, V and Wo
    over l rows, the scores and the context of 4 heads over l x l (a pad
    key's weight is exactly 0, a pad row never reaches the pool), and the
    MLP over l rows."""
    D, FF, H, DH = 64, 256, 4, 16
    ell = lens.astype(np.float64)
    per_layer = 2 * (4 * ell * D * D + 2 * H * ell * ell * DH + 2 * ell * D * FF)
    return float(2 * per_layer.sum())


def encoder_bytes(ids: np.ndarray, lens: np.ndarray, weight_floats: int) -> float:
    """The bytes the encoder must move for these documents: each document's
    real ids and its length, the embedding rows its ids name (each distinct
    row once), the positions of the longest document, every layer's weights
    once, and the embeddings out."""
    D = 64
    real = ids[np.arange(ids.shape[1])[None, :] < lens[:, None]]
    return float(real.size * 4 + lens.size * 4 + np.unique(real).size * D * 4
                 + int(lens.max()) * D * 4 + weight_floats * 4
                 + lens.size * D * 4)


def kmeans_flops(live: int, d: int, k: int, iters: int = 10) -> float:
    """The operations that ``live`` weighted points need: each seeding step
    one distance a point to the newest center (a running minimum), each
    Lloyd step k distances a point and its coordinates added to its own
    center's sum (3 operations a coordinate of a distance, 2 of a sum)."""
    seeding = (k - 1) * d * 3
    return float(live * (seeding + iters * (k * d * 3 + d * 2)))


def ml_kernel_phase(dev) -> dict:
    """H25-H28 against their plain versions on the card at the paths' shapes:
    H25 bit for bit on a 2^21-row block (int64 and f64 with NaN, +-0, +-inf,
    masked and not, a salt near 2^40); H26 bit for bit at 16 and 4096 groups
    on an empty and a full state and on forced equal priorities fed
    directly, and at its edges (``topk_edges``), through both entries (the
    sort-free one for few groups, the bucketed one); H27 within 1e-5 at G
    16, S 128, d 64, k 4 and 8 with duplicated points, with the plain
    version's NaN pattern on the NaN and infinity groups, exact on ties;
    H28 within 1e-5 at B 1 (1 and 64 tokens), every length 1..64 in one
    batch, lengths 0 and 70,
    and 4098 documents of 1, 17 and 64 tokens. Records: H25 f64 masked, H26's
    sort-free entry at 16 full groups (reservoir_latency's update; also an
    empty state and the whole update) and its bucketed entry at 4096
    (reservoir_flows'; also the bucketing sort and the whole update), H27
    k 8, H28 4098 documents."""
    from pixie_tpu_torch.ops import kernels, kmeans_edges, ml, transformer

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off: the plain versions' products run in full f32 on the card")
    rng = np.random.default_rng(40)
    n = BLOCK_ROWS
    records: dict = {}
    ints = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)).to(dev)
    f = rng.exponential(3e7, n)
    f[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf,
             np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]]
    floats = torch.from_numpy(f).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    salt = (1 << 40) + 12345
    salt_t = torch.tensor([salt], dtype=torch.int64, device=dev)
    for name, v in (("int64", ints), ("float64", floats)):
        for m in (None, mask):
            got, want = ml.priorities(v, salt, m), ml.priorities_plain(v, salt, m)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int64), want.view(torch.int64)),
                  f"H25 {name} mask={m is not None}: priorities differ from plain")
    words = floats.view(torch.int64)
    records["reservoir_priority"] = record(
        lambda: kernels.reservoir_priority(words, mask, salt_t),
        lambda: ml.priorities_plain(floats, salt_t, mask), None,
        *bound(n * (8 + 1 + 8), n * 40.0), 0.0,
        f"{n} rows f64, 70% masked in, salt 2^40 + 12345",
    )
    log(f"H25 reservoir_priority: int64 and f64, masked and not, bit for bit; "
        f"{records['reservoir_priority']['ms']:.4f} ms")

    def same_state(a: dict, b: dict) -> bool:
        return all(torch.equal(a[k].view(torch.int64) if a[k].dtype == torch.float64 else a[k],
                               b[k].view(torch.int64) if b[k].dtype == torch.float64 else b[k])
                   for k in b)

    for G in (N_SERVICES, FLOW_GROUPS):
        gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
        st_k = st_p = ml.reservoir_init(G, dev)
        for step in range(2):  # an empty state, then a full one
            st_k = ml.reservoir_update(st_k, gids, floats, mask)
            st_p = ml.update_plain(st_p, gids, floats, mask)
            torch.cuda.synchronize()
            check(same_state(st_k, st_p), f"H26 G={G} step {step}: state differs from plain")
        g = torch.where(mask, gids.to(torch.int64), G)
        pri = ml.priorities(floats, st_k["count"].sum(), mask)
        order, offsets = ml.bucket_rows(g, G)
        sv, sp = st_k["values"].view(torch.int64), st_k["priority"]
        # What the data needs: each candidate's priority and its order index
        # (bucketed) or each row's gid (sort-free), the values of the rows
        # that enter, the state read and written once.
        cand = int(mask.sum())
        entered = int((~torch.isin(ml.topk_rows_plain(st_k, g, pri, floats)["priority"], sp)).sum())
        state_bytes = 2 * G * RESERVOIR_K * 16
        if G == N_SERVICES:  # reservoir_latency's update: the sort-free entry
            g32, cnt = g.to(torch.int32), st_k["count"]
            rec = records["reservoir_topk_rows"] = record(
                lambda: kernels.reservoir_topk_rows(sv, sp, cnt, words, pri, g32),
                lambda: ml.topk_rows_plain(st_k, g, pri, floats), None,
                *bound(n * 4 + cand * 8 + entered * 8 + state_bytes + 2 * G * 8, cand * 4.0),
                0.0,
                f"{n} rows (gids, no bucketing) into {G} full reservoirs of {RESERVOIR_K}",
            )
            # The first block's call (an empty state: every chunk fills and
            # cuts) and the whole update (H25, H26).
            empty = ml.reservoir_init(G, dev)
            rec["by_empty_state_16"] = {
                "ms": time_ms(lambda: kernels.reservoir_topk_rows(
                    empty["values"].view(torch.int64), empty["priority"], empty["count"], words,
                    pri, g32)),
                "plain_ms": time_ms(lambda: ml.topk_rows_plain(empty, g, pri, floats))}
        else:  # reservoir_flows' update: the bucketed entry after the gid sort
            rec = records["reservoir_topk"] = record(
                lambda: kernels.reservoir_topk(sv, sp, words, pri, order, offsets),
                lambda: ml.topk_rows_plain(st_k, g, pri, floats), None,
                *bound(cand * 16 + entered * 8 + state_bytes + (G + 1) * 8, cand * 4.0), 0.0,
                f"{n} rows into {G} full reservoirs of {RESERVOIR_K}",
            )
            rec["by_bucket_rows_ms"] = time_ms(lambda: ml.bucket_rows(g, G))
        rec["by_update_ms"] = time_ms(lambda: ml.reservoir_update(st_k, gids, floats, mask))
    # Forced ties: priorities on a grid of 8 values, the state's too.
    G = N_SERVICES
    tie_pri = torch.from_numpy(np.floor(rng.random(n) * 8) / 8).to(dev)
    tie_pri[~mask] = -torch.inf
    tie_state = ml.reservoir_init(G, dev)
    tie_state["priority"] = torch.from_numpy(
        -np.sort(-np.floor(rng.random((G, RESERVOIR_K)) * 8) / 8, axis=1)).to(dev)
    tie_state["values"] = torch.from_numpy(rng.normal(0, 1, (G, RESERVOIR_K))).to(dev)
    gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    g = torch.where(mask, gids.to(torch.int64), G)
    order, offsets = ml.bucket_rows(g, G)
    vk, pk = kernels.reservoir_topk(tie_state["values"].view(torch.int64), tie_state["priority"],
                                    words, tie_pri, order, offsets)
    want = ml.topk_rows_plain(tie_state, g, tie_pri, floats)
    torch.cuda.synchronize()
    check(torch.equal(vk, want["values"].view(torch.int64)) and torch.equal(pk, want["priority"]),
          "H26 forced ties: the state's slots first, then the rows in row order")
    check(same_state(ml.reservoir_merge(tie_state, want), ml.reservoir_merge_plain(tie_state, want)),
          "H26 merge with ties: differs from plain")
    topk_edges(dev, rng)
    r26, r26r = records["reservoir_topk"], records["reservoir_topk_rows"]
    log(f"H26 reservoir_topk, reservoir_topk_rows: 16 and 4096 groups, empty and full, forced "
        f"ties, merges and the edges, bit for bit; sort-free {r26r['ms']:.4f} ms (16 groups; "
        f"{r26r['by_empty_state_16']['ms']:.4f} ms with an empty state), bucketed "
        f"{r26['ms']:.4f} ms (4096; bucket_rows {r26['by_bucket_rows_ms']:.4f} ms); the whole "
        f"update {r26r['by_update_ms']:.4f} ms (16), {r26['by_update_ms']:.4f} ms (4096)")

    Gk, S, d = N_SERVICES, 128, KM_D
    truth = rng.normal(0, 3, (8, d)).astype(np.float32)
    lab = rng.integers(0, 8, (Gk, S))
    pts_np = (truth[lab] + 0.05 * rng.normal(0, 1, (Gk, S, d))).astype(np.float32)
    pts_np[:, 96:] = pts_np[:, :32]  # exact duplicates: the first-index ties
    w_np = (rng.random((Gk, S)) < 0.9).astype(np.float32)
    pts, w = torch.from_numpy(pts_np).to(dev), torch.from_numpy(w_np).to(dev)
    for k in (4, 8):
        err = float((ml.kmeans_fit(pts, w, k) - ml.kmeans_fit_plain(pts, w, k)).abs().max())
        check(err <= 1e-5, f"H27 k={k}: centers {err:.3g} from plain")
    # NaN and infinities as the reference takes them (ops/kmeans_edges.py:
    # NaN in a live, a dead and the first live point, +-inf, every point
    # dead; k 3, 8 and 20 > S): the plain version's NaN pattern and 1e-5
    # elsewhere; the tie groups exactly.
    npts, nw = (torch.from_numpy(a).to(dev) for a in kmeans_edges.nan_groups())
    nan_centers = {}
    for k in (3, 8, 20):
        got, want = ml.kmeans_fit(npts, nw, k), ml.kmeans_fit_plain(npts, nw, k)
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan), f"H27 NaN groups k={k}: NaN pattern differs")
        err = float(torch.where(got == want, 0.0, (got - want).abs())[~nan].max())
        check(err <= 1e-5, f"H27 NaN groups k={k}: centers {err:.3g} from plain (inf = inf)")
        nan_centers[k] = int(nan.any(-1).sum())
    tpts, tw = (torch.from_numpy(a).to(dev) for a in kmeans_edges.tie_groups())
    for k in (2, 3, 4):
        check(torch.equal(ml.kmeans_fit(tpts, tw, k), ml.kmeans_fit_plain(tpts, tw, k)),
              f"H27 tie groups k={k}: not the first index")
    rec = records["kmeans_fit"] = record(
        lambda: kernels.kmeans_fit(pts, w, 8),
        lambda: ml.kmeans_fit_plain(pts, w, 8), None,
        *bound(Gk * S * d * 4 + Gk * S * 4 + Gk * 8 * d * 4, kmeans_flops(int(w_np.sum()), d, 8)),
        float((ml.kmeans_fit(pts, w, 8) - ml.kmeans_fit_plain(pts, w, 8)).abs().max()),
        f"G {Gk}, S {S}, d {d}, k 8, 10 iterations",
    )
    rec["floor_ms"] = time_ms(lambda: kernels.empty_launch(
        dev, *kernels.kmeans_fit_geometry(Gk, S, d, 8)))
    probe = torch.zeros(kernels.KMEANS_PROBE, dtype=torch.int64, device=dev)
    for _ in range(3):
        kernels.kmeans_fit(pts, w, 8, probe=probe)
    torch.cuda.synchronize()
    khz = kernels.sm_clock_khz(dev)
    rec["b_phases_us"] = dict(
        probe_phases_us(probe, ("load", "seeding", "lloyd"), 0, khz),
        assign=int(probe[4]) * 1e3 / khz, update=int(probe[5]) * 1e3 / khz)
    rec["b_nan_centers"] = nan_centers
    log(f"H27 kmeans_fit: k 4 and 8 within 1e-5 of plain; the NaN and inf groups with the plain "
        f"version's NaN pattern (centers holding NaN at k 3, 8, 20: {nan_centers}), 1e-5 "
        f"elsewhere; ties exact; {rec['ms']:.5f} ms (floor {rec['floor_ms']:.5f}, plain "
        f"{rec['plain_ms']:.4f}, bound {rec['bound_ms']:.5f}); CTA 0's phases us "
        f"{json.dumps(rec['b_phases_us'])}")

    params = transformer._init_params(0)
    enc = transformer.TransformerEncoder(params, dev)
    # One document of 1 and of 64 tokens; every length 1..64 in one batch
    # (tile edges inside documents); lengths 0 and 70 (clamped into 0..64);
    # then the path count of 1, 17 or 64 tokens, the timed shape.
    edge_lens = [np.array([1]), np.array([64]), rng.permutation(np.arange(1, 65)),
                 np.array([5, 0, 64, 70, 1, 0, 33]), rng.choice([1, 17, 64], N_PATHS + 2)]
    for lens_np in edge_lens:
        B = lens_np.shape[0]
        lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
        ids = torch.from_numpy(rng.integers(1, transformer.VOCAB, (B, 64)).astype(np.int32)).to(dev)
        ids[torch.arange(64, device=dev)[None, :] >= lens[:, None]] = 0
        before = kernels.LAUNCHES["encoder_forward"]
        got = enc(ids, lens)
        check(kernels.LAUNCHES["encoder_forward"] == before + 1, "H28: one launch a forward")
        want = transformer.encoder_forward_plain(ids, lens, enc.embed, enc.pos, enc.layers)
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"H28 {B} documents {sorted(set(lens_np.tolist()))[:8]}: "
                           f"embeddings {err:.3g} from plain")
    ids_np, lens_np = ids.cpu().numpy(), lens.cpu().numpy()
    records["encoder_forward"] = record(
        lambda: kernels.encoder_forward(ids, lens, enc.embed, enc.pos, enc.layers),
        lambda: transformer.encoder_forward_plain(ids, lens, enc.embed, enc.pos, enc.layers),
        None, *bound(encoder_bytes(ids_np, lens_np, enc.layers.numel()), encoder_flops(lens_np)), err,
        f"{B} documents of 1, 17 or 64 tokens, 2 layers, f32",
    )
    log(f"H28 encoder_forward: B 1 (1, 64 tokens), lengths 1..64 in one batch, lengths 0 "
        f"and 70, {B} documents: within 1e-5 of plain (max {err:.3g} at {B}); "
        f"{records['encoder_forward']['ms']:.4f} ms at {B}")
    return records


def topk_edges(dev, rng, n: int = BLOCK_ROWS) -> None:
    """H26 bit for bit against ``topk_rows_plain`` (both on the card) at
    2^21 rows, 70% masked in: 1, 16 and 4096 groups, one group holding every
    row, empty groups (the odd ones), k 1, 64 and 768 (at 16 and 4096
    groups), 64 groups of 16, priorities on a grid of 8 values (ties across
    every chunk edge) or not, an empty and a full state (its
    priorities on the grid too), through the bucketed entry and, where it
    fits, the sort-free one (its counts too); then
    ``reservoir_merge`` of 16 and 4096 full reservoirs with ties, chained as
    the TREE merge chains four shards' states."""
    from pixie_tpu_torch.ops import kernels, ml

    mask = rng.random(n) < 0.7
    words = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)).to(dev)
    cases = 0
    for name, G, k, layout in (("G1", 1, 64, "spread"), ("G16", 16, 64, "spread"),
                               ("G4096", 4096, 64, "spread"), ("one_group", 16, 64, "one"),
                               ("empty_groups", 16, 64, "even"), ("k1", 16, 1, "spread"),
                               ("k768", 16, 768, "spread"), ("k768_G4096", 4096, 768, "spread"),
                               ("G64_k16", 64, 16, "spread")):
        gids = rng.integers(0, G, n)
        if layout == "one":
            gids[:] = 5
        elif layout == "even":
            gids = 2 * rng.integers(0, G // 2, n)
        g = torch.from_numpy(np.where(mask, gids, G)).to(dev)
        order, offsets = ml.bucket_rows(g, G)
        for ties in (False, True):
            p = np.floor(rng.random(n) * 8) / 8 if ties else rng.random(n)
            pri = torch.from_numpy(np.where(mask, p, -np.inf)).to(dev)
            for full in (False, True):
                st = topk_state(rng, G, k, full, ties, dev)
                vk, pk = kernels.reservoir_topk(st["values"].view(torch.int64), st["priority"],
                                                words, pri, order, offsets)
                want = ml.topk_rows_plain(st, g, pri, words.view(torch.float64))
                torch.cuda.synchronize()
                check(torch.equal(vk, want["values"].view(torch.int64))
                      and torch.equal(pk.view(torch.int64), want["priority"].view(torch.int64)),
                      f"H26 {name} ties={ties} full={full}: differs from plain")
                cases += 1
                if kernels.topk_rows_fits(G, k):  # the sort-free entry
                    vr, pr_, cr = kernels.reservoir_topk_rows(
                        st["values"].view(torch.int64), st["priority"], st["count"], words, pri,
                        g.to(torch.int32))
                    torch.cuda.synchronize()
                    check(torch.equal(vr, want["values"].view(torch.int64))
                          and torch.equal(pr_.view(torch.int64),
                                          want["priority"].view(torch.int64))
                          and torch.equal(cr, want["count"]),
                          f"H26 sort-free {name} ties={ties} full={full}: differs from plain")
                    cases += 1
    for G in (N_SERVICES, FLOW_GROUPS):
        shards = [topk_state(rng, G, RESERVOIR_K, True, ties, dev)
                  for ties in (True, True, False, True)]
        acc = acc_plain = shards[0]
        for b in shards[1:]:
            acc, acc_plain = ml.reservoir_merge(acc, b), ml.reservoir_merge_plain(acc_plain, b)
            torch.cuda.synchronize()
            check(all(torch.equal(acc[key], acc_plain[key]) for key in acc),
                  f"H26 TREE merge of {G} reservoirs: differs from plain")
            cases += 1
    log(f"H26 edges: {cases} cases bit for bit (1-4096 groups, one group, empty groups, "
        f"k 1/64/768, ties, empty and full states, merges)")


def topk_state(rng, G: int, k: int, full: bool, ties: bool, dev) -> dict:
    """An empty reservoir state, or a full one in descending order whose
    priorities lie on a grid of 8 values (``ties``) or not."""
    from pixie_tpu_torch.ops import ml

    st = ml.reservoir_init(G, dev, k=k)
    if full:
        p = np.floor(rng.random((G, k)) * 8) / 8 if ties else rng.random((G, k))
        st["priority"] = torch.from_numpy(-np.sort(-p, axis=1)).to(dev)
        st["values"] = torch.from_numpy(rng.normal(0, 1, (G, k))).to(dev)
    return st


def np_splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 of uint64 values in numpy's wrapping uint64 arithmetic."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


def fold_blocks(n: int, shards: int) -> list:
    """[(first row, rows, shard)] of every block of an n-row table staged
    through the stream over ``shards`` shards, in each shard's fold order:
    the reference's geometry (windows of streaming_window_rows, clamped to
    the table's pow2-padded rows; block_geometry per window; shard s holds a
    window's rows from s * nblk * b)."""
    from pixie_tpu_torch.parallel.staging import _pow2_at_least, block_geometry
    from pixie_tpu_torch.utils import flags

    W = max(min(int(flags.streaming_window_rows), _pow2_at_least(max(n, 1), floor=1)), 1)
    b, nblk = block_geometry(W, shards, BLOCK_ROWS)
    out = []
    for s in range(shards):
        for w in range(-(-n // W)):
            end = min((w + 1) * W, n)
            for k in range(nblk):
                off = w * W + (s * nblk + k) * b
                out.append((off, max(min(b, end - off), 0), s))
    return out


def np_priority_keys(words: np.ndarray, mask, shards: int = 1) -> np.ndarray:
    """int64 [n]: each row's 53-bit priority key under the blocked salt rule:
    row i of a block gets combine(splitmix64(word), splitmix64(i + salt)) >>
    11, salt the masked-in rows of the earlier blocks of its shard's fold
    (``fold_blocks``); -1 for a row masked out. The blocks run on 8 threads
    (numpy's ufuncs release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    n = words.size
    keys = np.empty(n, np.int64)
    golden = np.uint64(0x9E3779B97F4A7C15)
    blocks = [blk for blk in fold_blocks(n, shards) if blk[1] > 0]
    salts, seen = [], [0] * shards
    for off, size, sh in blocks:
        salts.append(seen[sh])
        seen[sh] += size if mask is None else int(mask[off:off + size].sum())

    def block(j: int) -> None:
        off, size, _ = blocks[j]
        end = off + size
        h1 = np_splitmix64(words[off:end])
        h2 = np_splitmix64(np.arange(size, dtype=np.uint64) + np.uint64(salts[j]))
        h = np_splitmix64(h1 ^ (h2 + golden + (h1 << np.uint64(6)) + (h1 >> np.uint64(2))))
        k = (h >> np.uint64(11)).view(np.int64)
        if mask is not None:
            k[~mask[off:end]] = -1
        keys[off:end] = k

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(block, range(len(blocks))))
    return keys


def reservoir_truth(values: np.ndarray, gids: np.ndarray, G: int, mask=None,
                    shards: int = 1) -> list:
    """[G] JSON strings, as the port's finalize writes them, of each group's
    RESERVOIR_K rows of highest priority key (ties to the earlier row), from
    numpy's uint64 SplitMix64 under the blocked salt rule of a fold over
    ``shards`` shards (the shards' reservoirs merged: the top keys of all)."""
    is_int = values.dtype.kind in "iu"
    vals = values.astype(np.int64) if is_int else values.astype(np.float64)
    keys = np_priority_keys(vals.view(np.uint64), mask, shards)
    gids = gids.astype(np.int64)
    counts = np.bincount(gids[keys >= 0], minlength=G)
    need = np.minimum(counts, RESERVOIR_K)
    frac = min(1.0, 16.0 * RESERVOIR_K / max(int(counts[counts > 0].min()), 1))
    while True:  # candidates above a key every group keeps RESERVOIR_K over
        thr = int((1.0 - frac) * (1 << 53)) - 1 if frac < 1.0 else -1
        cand = np.nonzero(keys > thr)[0]
        have = np.bincount(gids[cand], minlength=G)
        if frac >= 1.0 or np.all(have >= need):
            break
        frac = min(1.0, frac * 4)
    order = cand[np.lexsort((cand, -keys[cand], gids[cand]))]
    bounds = np.searchsorted(gids[order], np.arange(G + 1))
    out = []
    for g in range(G):
        sample = vals[order[bounds[g] : bounds[g + 1]][:RESERVOIR_K]]
        if not is_int:
            sample = sample[np.isfinite(sample)]
        out.append(json.dumps({"count": int(counts[g]),
                               "sample": [int(x) if is_int else float(x) for x in sample]}))
    return out


def latency_sample_truth(data: dict, shards: int = 1) -> dict:
    gids = data["svc"]
    return dict(lat=reservoir_truth(data["latency"], gids, N_SERVICES, shards=shards),
                status=reservoir_truth(data["status"], gids, N_SERVICES, shards=shards))


def verify_reservoir_latency(result, data: dict, truth: dict) -> None:
    """reservoir_latency: 16 services; each JSON string-equal to numpy's."""
    rows = result.table("sample")
    idx = [SERVICES.index(s) for s in rows["service"]]
    check(sorted(idx) == list(range(N_SERVICES)), "reservoir_latency: the services")
    check(list(rows["n"]) == [int(data["tc"][i]) for i in idx], "reservoir_latency: counts")
    for i, lat, status in zip(idx, rows["lat"], rows["status"]):
        check(lat == truth["lat"][i], f"reservoir_latency: latency sample of {SERVICES[i]}")
        check(status == truth["status"][i], f"reservoir_latency: status sample of {SERVICES[i]}")
        check(len(json.loads(lat)["sample"]) == RESERVOIR_K, "reservoir_latency: 64 values")


def flows_sample_truth(fl: dict) -> list:
    pair = fl["src"].astype(np.int64) * N_PODS + fl["dst"]
    return reservoir_truth(fl["bs"], pair, FLOW_GROUPS, mask=fl["br"] >= FLOW_SAMPLE_MIN_RECV)


def verify_reservoir_flows(result, truth: list) -> None:
    """reservoir_flows: 4096 pod pairs; each JSON string-equal to numpy's."""
    rows = result.table("sample")
    pod = lambda name: int(name.rsplit("-", 1)[1])
    pair = [pod(a) * N_PODS + pod(b) for a, b in zip(rows["src"], rows["dst"])]
    check(sorted(pair) == list(range(FLOW_GROUPS)), "reservoir_flows: the pod pairs")
    for p, js in zip(pair, rows["sent"]):
        check(js == truth[p], f"reservoir_flows: the sample of pair {p}")


def path_embedding_truth(dev) -> np.ndarray:
    """f32 [4098, 64]: each request path's embedding by the plain encoder on
    the card, from the port's tokenizer, in let_dictionaries' order."""
    from pixie_tpu_torch.ops import transformer

    paths = let_dictionaries()["req_path"]
    ids = np.zeros((len(paths), 64), np.int32)
    lens = np.zeros(len(paths), np.int32)
    for i, p in enumerate(paths):
        toks = json.loads(transformer.tokenize(p))[:64]
        ids[i, : len(toks)] = [(t + 1) % transformer.VOCAB for t in toks]
        lens[i] = len(toks)
    enc = transformer.TransformerEncoder(transformer._init_params(0), dev)
    out = transformer.encoder_forward_plain(
        torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev),
        enc.embed, enc.pos, enc.layers)
    return out.cpu().numpy()


def verify_path_embeddings(result, path_counts: np.ndarray, want: np.ndarray) -> None:
    """path_embeddings: 4098 paths with their counts; each embedding within
    1e-5 of the plain encoder's after the JSON's 6-decimal rounding (5e-7);
    a k-means model of 8 centers of 64 dims."""
    rows = result.table("emb")
    names = let_dictionaries()["req_path"]
    idx = np.array([names.index(p) for p in rows["req_path"]])
    check(np.array_equal(np.sort(idx), np.arange(len(names))), "path_embeddings: the paths")
    check(np.array_equal(np.asarray(rows["n"]), path_counts[idx]), "path_embeddings: counts")
    got = np.array([json.loads(e) for e in rows["emb"]], np.float64)
    check(got.shape == (len(names), 64), f"path_embeddings: shape {got.shape}")
    err = float(np.abs(got - want[idx]).max())
    check(err <= 1e-5 + 5e-7, f"path_embeddings: {err:.3g} from the plain encoder")
    model = json.loads(result.table("model")["model"][0])
    centers = np.asarray(model["centers"])
    check(model["k"] == PATH_K and centers.shape == (PATH_K, 64) and np.isfinite(centers).all(),
          f"path_embeddings: model shape {centers.shape}")


def km_embeddings(n_rows: int) -> dict:
    """kmeans_services' table, seed 48: 16 services; each row one of 4
    well-separated 64-dim cluster centers (2.0 on its own 16 dims, 11.3
    apart) plus N(0, 0.1) noise, as JSON with 4 decimals."""
    rng = np.random.default_rng(48)
    centers = np.zeros((KM_K, KM_D))
    for c in range(KM_K):
        centers[c, c * 16 : (c + 1) * 16] = 2.0
    svc = rng.integers(0, N_SERVICES, n_rows)
    lab = rng.integers(0, KM_K, n_rows)
    pts = np.round(centers[lab] + 0.1 * rng.standard_normal((n_rows, KM_D)), 4)
    emb = np.array([json.dumps(p.tolist()) for p in pts], dtype=object)
    return dict(svc=svc, lab=lab, emb=emb, centers=centers)


def build_km_carnot(km: dict, n_rows: int, device: str):
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
                      ("service", DataType.STRING), ("emb", DataType.STRING))
    table = carnot.table_store.create_table("embeddings", rel)
    table.write_pydict({
        "time_": np.arange(n_rows, dtype=np.int64) * 1000,
        "service": np.array(SERVICES, dtype=object)[km["svc"]],
        "emb": km["emb"],
    })
    table.compact()
    table.stop()
    return carnot


def verify_kmeans_services(result, km: dict) -> None:
    """kmeans_services: one model a service, k 4, every true center within
    0.5 of a fitted one; keeps svc-0's model for the predict query."""
    rows = result.table("models")
    check(sorted(rows["service"]) == sorted(SERVICES), "kmeans_services: the services")
    for svc, js in zip(rows["service"], rows["model"]):
        model = json.loads(js)
        centers = np.asarray(model["centers"])
        check(model["k"] == KM_K and centers.shape == (KM_K, KM_D), f"{svc}: model shape")
        dist = np.linalg.norm(centers[None, :, :] - km["centers"][:, None, :], axis=2)
        check(dist.min(axis=1).max() <= 0.5, f"{svc}: a true center {dist.min(axis=1).max():.3f} "
              "from every fitted one")
        if svc == SERVICES[0]:
            km["model"] = js


def verify_kmeans_predict(result, km: dict) -> None:
    """The predicted clusters under svc-0's model: counts equal the
    generator's labels, each fitted center mapped to its nearest true one."""
    centers = np.asarray(json.loads(km["model"])["centers"])
    nearest = np.linalg.norm(centers[:, None, :] - km["centers"][None, :, :], axis=2).argmin(1)
    check(sorted(nearest.tolist()) == list(range(KM_K)), "kmeans_predict: the model's centers")
    rows = result.table("clusters")
    want = np.bincount(km["lab"], minlength=KM_K)
    got = dict(zip(rows["cluster"], rows["n"]))
    check(got == {j: int(want[nearest[j]]) for j in range(KM_K)},
          f"kmeans_predict: counts {got} against the labels {want.tolist()}")


def ml_parity(cuda, cpu, flows_cuda, flows_cpu, n_rows: int) -> None:
    """reservoir_latency and reservoir_flows: the kernel path's JSON equals
    the plain path's, every group."""
    for name, a, b, query in (("reservoir_latency", cuda, cpu, RESERVOIR_LATENCY),
                              ("reservoir_flows", flows_cuda, flows_cpu, RESERVOIR_FLOWS)):
        got, want = a.execute_query(query).table("sample"), b.execute_query(query).table("sample")
        check(got == want and len(next(iter(got.values()))) > 0, f"{name}: cuda vs cpu")
    log(f"slice parity at {n_rows} rows: reservoir_latency and reservoir_flows JSON "
        "kernel path == plain path")


# ---------------------------------------------------------------- the mesh
# bench.py config 10 (bench.py:1241-1275) with the table and query of
# tools/microbench_mesh.py (:50-58, :82-90): one group-by of the mergeable
# UDAs at every mesh width over the same devices: here 8 logical shards of
# one card, and a 4-shard mesh for the TREE merges.
MESH_ROWS = 1 << 25
MESH_SERVICES = 64
MESH_SHARDS = 8
MESH_WIDTHS = ("hosts:1,d:8", "hosts:2,d:4", "hosts:4,d:2", "hosts:8,d:1")
TREE_SHARDS = 4
MESH_QUERY = (
    "df = px.DataFrame(table='mesh_bench')\n"
    "g = df.groupby('service').agg("
    "n=('lat', px.count), s=('lat', px.sum),"
    " mn=('lat', px.min), mx=('lat', px.max),"
    " u=('service', px.approx_count_distinct),"
    " cm=('status', px.count_min))\n"
    "px.display(g, 'out')\n"
)
# The f64 sums' bound (PERF.md; ROADMAP Fault-17): |sum - fsum| <=
# 1e-12 * sum |v| of the group, the bound every port f64 sum is held to.
SUM_BOUND = 1e-12


def merge_lane_stack(rng, D: int, L: int, dtype, kind: str) -> torch.Tensor:
    """A [D, L] stack of D shards' leaves of one H29 lane: random values,
    the last shard empty (the identity of ``kind``), and for f64 NaN in
    shard 0 or 1, -0.0/+0.0 disagreeing in both orders, all -0.0, a NaN
    payload, +-inf and subnormals; int64 sums overflowing."""
    if dtype == torch.float64:
        a = rng.standard_normal((D, L)) * 1e3
        a[0, 0] = np.nan
        a[min(1, D - 1), 1] = np.nan
        a[:, 2] = 0.0
        a[0, 2] = -0.0
        a[:, 3] = -0.0
        a[min(1, D - 1), 3] = 0.0
        a[:, 4] = -0.0
        a[0, 5] = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
        a[0, 6], a[min(1, D - 1), 7] = np.inf, -np.inf
        a[:, 8] = 5e-324
        ident = {"sum": 0.0, "max": -np.inf, "min": np.inf}[kind]
    elif dtype == torch.int64:
        a = rng.integers(-(2**62), 2**62, (D, L), dtype=np.int64)
        a[:, :8] = 2**63 - 1
        ident = {"sum": 0, "max": -(2**63), "min": 2**63 - 1}[kind]
    else:
        a = rng.integers(0, 64, (D, L)).astype(np.int32)
        ident = {"max": 0, "min": 2**31 - 1}[kind]
    a[D - 1] = ident
    return torch.from_numpy(a).cuda()


MERGE_LANES = ((torch.int64, "sum"), (torch.float64, "sum"), (torch.int64, "max"),
               (torch.int64, "min"), (torch.int32, "max"), (torch.int32, "min"),
               (torch.float64, "max"), (torch.float64, "min"))


def merge_kernel_phase(dev) -> dict:
    """H29 against merge_stack_plain on the card, bit for bit, at D = 2, 4
    and 8 shards of L = 4096 groups in every lane (int64 and f64 sums;
    int64, int32 and f64 max and min; ``merge_lane_stack``'s edge values).
    Record: the config 10 fold's largest merge, its int64 sums at D = 8
    (count-min cells and totals, counts and presence of 64 groups), and
    each lane at D = 8, L = 4096."""
    from pixie_tpu_torch.ops import kernels, merge

    rng = np.random.default_rng(51)
    L = 4096
    by_lane = {}
    for D in (2, 4, 8):
        for dtype, kind in MERGE_LANES:
            stack = merge_lane_stack(rng, D, L, dtype, kind)
            got = kernels.merge_states(stack, kind)
            want = merge.merge_stack_plain(stack, kind)
            torch.cuda.synchronize()
            check(bits_equal(got, want), f"H29 {kind} {dtype} D {D}: kernel != plain")
            if D == 8:
                by_lane[f"{kind}_{str(dtype).split('.')[-1]}"] = time_ms(
                    lambda st=stack, k=kind: kernels.merge_states(st, k))
    L_main = MESH_SERVICES * (1 + 4 * 8192 + 1 + 1)
    stack = torch.from_numpy(rng.integers(0, 1 << 20, (MESH_SHARDS, L_main))).to(dev)
    got, want = kernels.merge_states(stack, "sum"), merge.merge_stack_plain(stack, "sum")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "H29 int64 sum at the mesh path's shape")
    b_ms, by = bound((MESH_SHARDS + 1) * L_main * 8, MESH_SHARDS * L_main)
    rec = record(
        lambda: kernels.merge_states(stack, "sum"),
        lambda: merge.merge_stack_plain(stack, "sum"),
        lambda: torch.sum(stack, 0), b_ms, by, 0.0,
        f"D {MESH_SHARDS}, L {L_main} int64 sums",
    )
    rec["by_lane_d8_l4096_ms"] = by_lane
    log(f"H29 merge_states: {rec['ms']:.4f} ms [bound {b_ms:.4f}], plain {rec['plain_ms']:.4f}, "
        f"torch.sum {rec['library_ms']:.4f}; D 8 L 4096 by lane {by_lane}")
    return {"merge_states": rec}


UNCALLED_ROWS = 1 << 21


def uncalled_kernel_phase(dev) -> dict:
    """H30-H32, the kernels of the TPU kernels no path calls, against their
    plain versions on the card, exactly: H30 (count-min query) over config
    10's state shape, 64 groups x 4 x 8192 cells filled by H6 from 2^22
    rows of resp_status values, and 2^21 (group, resp_status) queries; H31
    (hash_columns) over 2^21 rows of (int64 service code, f64 latency), and
    over edge words (-0.0, NaN payloads, +-inf, a bool column, eight
    columns); H32 (clz64) over H31's 2^21 outputs and the edge words 0, 1,
    2^63 and 2^64 - 1. Each timed with its plain version; no one torch call
    computes any of them (library_ms none), so the torch sequence's time is
    given: H30's gathers and min over precomputed buckets, H31 and H32 are
    their plain versions."""
    from pixie_tpu_torch.ops import countmin, hashing, kernels

    rng = np.random.default_rng(30)
    n = UNCALLED_ROWS
    out = {}
    # H30: config 10's count-min state (64 services, status 0-6).
    G, depth, width = MESH_SERVICES, countmin.DEFAULT_DEPTH, countmin.DEFAULT_WIDTH
    state = countmin.update(
        countmin.init(G, dev),
        torch.from_numpy(rng.integers(0, G, 1 << 22).astype(np.int32)).to(dev),
        torch.from_numpy(rng.integers(0, 7, 1 << 22)).to(dev),
    )
    gids = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.integers(0, 7, n)).to(dev)
    words = hashing.words64(vals).contiguous()
    got, want = countmin.query(state, gids, vals), countmin.query_plain(state, gids, vals)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "H30 countmin_query: kernel != plain")
    check(int(got.min()) > 0, "H30: every status was counted")
    g64 = gids.long()
    buckets = [b.long() for b in countmin._buckets(vals, depth, width)]
    # The bound reads only the state cells these queries touch, each once
    # (64 groups x 7 statuses x 4 rows at most), as H5/H6's count the cells
    # their rows touch.
    cells = int(torch.unique(torch.cat(
        [(g64 * depth + d) * width + b for d, b in enumerate(buckets)])).numel())
    rec = record(
        lambda: kernels.countmin_query(state, gids, words),
        lambda: countmin.query_plain(state, gids, vals), None,
        *bound(n * (4 + 8 + 8) + cells * 8, n * depth), 0.0,
        f"state [{G},{depth},{width}] int64 ({cells} cells touched), {n} queries",
    )
    rec["library_ms_torch_seq"] = time_ms(
        lambda: torch.stack([state[g64, d, b] for d, b in enumerate(buckets)]).min(0).values)
    out["countmin_query"] = rec
    # H31: (service code, latency) rows, then the edge words.
    code = torch.from_numpy(rng.integers(0, MESH_SERVICES, n)).to(dev)
    lat = torch.from_numpy(rng.exponential(3e7, n)).to(dev)
    h = hashing.hash_columns([code, lat], 0)
    torch.cuda.synchronize()
    check(torch.equal(h, hashing.hash_columns_plain([code, lat], 0)), "H31 hash_columns: kernel != plain")
    edge_f = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 5e-324] * 4,
                          dtype=torch.float64)
    edge_f[6] = torch.tensor([0x7FF8000000000001], dtype=torch.int64).view(torch.float64)[0]
    edge_i = torch.tensor([0, -1, 1, -(2**63), 2**63 - 1, 7] * 4, dtype=torch.int64)
    edge_b = torch.tensor([True, False, True] * 8)
    for cols, seed in (([edge_f], 0), ([edge_b, edge_i, edge_f], 3),
                       ([edge_i, edge_f, edge_b, edge_f, edge_i, edge_b, edge_f, edge_i], 5)):
        kg = hashing.hash_columns([c.to(dev) for c in cols], seed).cpu()
        check(torch.equal(kg, hashing.hash_columns_plain(cols, seed)),
              f"H31 hash_columns: edge words of {len(cols)} columns")
    rec = record(
        lambda: kernels.hash_columns([code, lat], 0),
        lambda: hashing.hash_columns_plain([code, lat], 0), None,
        *bound(n * (8 + 8 + 8), n * 40), 0.0, f"{n} rows x (int64, f64)",
    )
    rec["library_ms_torch_seq"] = rec["plain_ms"]
    out["hash_columns"] = rec
    # H32: H31's outputs, then the edge words.
    z = hashing.clz64(h)
    torch.cuda.synchronize()
    check(torch.equal(z, hashing.clz64_plain(h)), "H32 clz64: kernel != plain")
    edges = torch.tensor([0, 1, -(2**63), -1, 2**62, 2**63 - 1], dtype=torch.int64)
    check(hashing.clz64(edges.to(dev)).cpu().tolist() == [64, 63, 0, 0, 1, 1]
          and torch.equal(hashing.clz64_plain(edges), torch.tensor([64, 63, 0, 0, 1, 1],
                                                                   dtype=torch.int32)),
          "H32 clz64: the edge words")
    rec = record(
        lambda: kernels.clz64(h), lambda: hashing.clz64_plain(h), None,
        *bound(n * (8 + 4), n), 0.0, f"{n} u64",
    )
    rec["library_ms_torch_seq"] = rec["plain_ms"]
    out["clz64"] = rec
    for name, r in out.items():
        log(f"{name}: {r['ms']:.4f} ms [bound {r['bound_ms']:.4f}], plain {r['plain_ms']:.4f}, "
            f"torch sequence {r['library_ms_torch_seq']:.4f} (no one torch call)")
    return out


def mesh_table(n_rows: int, seed: int = 21) -> dict:
    """tools/microbench_mesh.py's mesh_bench columns (seed 21; config 12's
    seed 23), the service as its index (svc<i>), with the per-service
    truths: counts, min, max, math.fsum and sum |lat|."""
    rng = np.random.default_rng(seed)
    mb = {"svc": rng.integers(0, MESH_SERVICES, n_rows), "status": rng.integers(0, 7, n_rows),
          "lat": rng.standard_normal(n_rows)}
    order = np.argsort(mb["svc"].astype(np.uint8), kind="stable")
    lat = mb["lat"][order]
    counts = np.bincount(mb["svc"], minlength=MESH_SERVICES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    mb["n"] = counts
    mb["mn"] = np.minimum.reduceat(lat, starts)
    mb["mx"] = np.maximum.reduceat(lat, starts)
    mb["fsum"] = [math.fsum(lat[a:a + c]) for a, c in zip(starts, counts)]
    mb["abs"] = np.add.reduceat(np.abs(lat), starts)
    return mb


def build_mesh_carnot(mb: dict, n_rows: int, device: str):
    """A Carnot on the flat mesh d:1 of ``device`` with mesh_bench written
    (16M-row chunks); the widths' Carnots share its table store."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.types import DataType, Relation

    carnot = Carnot(device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(("service", DataType.STRING), ("status", DataType.INT64),
                      ("lat", DataType.FLOAT64))
    table = carnot.table_store.create_table("mesh_bench", rel, size_limit=1 << 42)
    svc_dict = table.dictionaries["service"]
    for i in range(MESH_SERVICES):
        svc_dict.get_code(f"svc{i}")
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        m = min(chunk, n_rows - off)
        table.write_pydict({
            "service": DictColumn(mb["svc"][off:off + m].astype(np.int32), svc_dict),
            "status": mb["status"][off:off + m],
            "lat": mb["lat"][off:off + m],
        })
    table.compact()
    table.stop()
    return carnot


def mesh_carnot(base, spec: str, shards: int, devices=None):
    """A Carnot over ``base``'s tables whose executor folds on the mesh
    ``spec`` over ``devices`` (by default ``shards`` logical shards of
    ``base``'s device)."""
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor

    devices = devices or [base.device_executor.device] * shards
    ex = DeviceExecutor(block_rows=BLOCK_ROWS, mesh_config=MeshConfig.parse(spec, shards),
                        devices=devices)
    return Carnot(table_store=base.table_store, device_executor=ex)


def verify_mesh(result, mb: dict) -> dict:
    """Config 10's outputs against numpy: counts, min and max exact, sums
    within SUM_BOUND * sum |v| of math.fsum, one distinct service per group,
    count-min totals the counts. Returns the outputs by service index."""
    rows = result.table("out")
    idx = [int(name[3:]) for name in rows["service"]]
    check(sorted(idx) == list(range(MESH_SERVICES)), "mesh: the 64 services")
    out = {}
    for k in ("n", "s", "mn", "mx", "u", "cm"):
        vals = [None] * MESH_SERVICES
        for i, v in zip(idx, rows[k]):
            vals[i] = v
        out[k] = vals
    for i in range(MESH_SERVICES):
        check(out["n"][i] == mb["n"][i], f"mesh: count of svc{i}")
        check(f64_bits_equal(out["mn"][i], mb["mn"][i]) and f64_bits_equal(out["mx"][i], mb["mx"][i]),
              f"mesh: min/max of svc{i}")
        err = abs(out["s"][i] - mb["fsum"][i])
        check(err <= SUM_BOUND * mb["abs"][i], f"mesh: sum of svc{i} off by {err}")
        check(out["u"][i] == 1, f"mesh: distinct services of svc{i}: {out['u'][i]}")
        check(json.loads(out["cm"][i])["total"] == mb["n"][i], f"mesh: count-min total of svc{i}")
    return out


def k18_reads(carnot, device: str) -> tuple:
    """(median K18 device ms, median seconds) of WARM_QUERIES more warm
    queries of config 10, each read alone (``merge_device_ms``)."""
    ex = carnot.device_executor
    ex.merge_device_ms()
    k18, secs = [], []
    for _ in range(WARM_QUERIES):
        t1 = time.perf_counter()
        carnot.execute_query(MESH_QUERY)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        k18.append(ex.merge_device_ms())
    return float(np.median(k18)), float(np.median(secs))


def mesh_paths(mb: dict, paths: dict, phase_s: dict, device: str = CARD) -> dict:
    """Config 10's sweep: d:1, then every 8-shard width, each driven (cold,
    then warm) and checked against numpy; every 8-shard width's integer,
    min/max, HLL and count-min outputs equal d:1's, and it launches H29.
    Three more warm queries a width read K18's device time (``k18_reads``).
    Returns {width: {warm_s, cold_s, k18_ms, k18_share, h29_launches}}."""
    t0 = time.perf_counter()
    base = build_mesh_carnot(mb, MESH_ROWS, device)
    log(f"mesh_bench: {MESH_ROWS} rows written in {time.perf_counter() - t0:.1f} s")
    phase_s["mesh_table"] = time.perf_counter() - t0
    summary, first = {}, None
    for spec in ("d:1",) + MESH_WIDTHS:
        t0 = time.perf_counter()
        c = base if spec == "d:1" else mesh_carnot(base, spec, MESH_SHARDS)
        got = {}
        name = "mesh_" + spec.replace(":", "").replace(",", "_")
        expect = ("segment_rows_sum_i64", "segment_minmax")
        paths[name] = drive(c, MESH_QUERY, lambda r: got.update(verify_mesh(r, mb)),
                            expect + (() if spec == "d:1" else ("merge_states",)))
        if spec == "d:1":
            check(paths[name]["launches"]["merge_states"] == 0, "d:1 launched H29")
            first = got
        else:
            for k in ("n", "mn", "mx", "u", "cm"):
                check(got[k] == first[k] if k != "mn" and k != "mx"
                      else all(f64_bits_equal(a, b) for a, b in zip(got[k], first[k])),
                      f"mesh {spec}: {k} differs from d:1")
        k18, warm_one = k18_reads(c, device)
        p = paths[name]
        summary[spec] = dict(warm_s=min(p["warm"]), cold_s=p["cold"], k18_ms=k18,
                             k18_share=k18 / (warm_one * 1e3),
                             h29_launches=p["launches"]["merge_states"])
        log(f"mesh {spec}: warm {min(p['warm']):.4f} s, cold {p['cold']:.3f} s, K18 {k18:.4f} ms "
            f"= {100 * k18 / (warm_one * 1e3):.2f}% of a warm query ({warm_one:.4f} s), "
            f"H29 launches {p['launches']['merge_states']} (medians of {WARM_QUERIES} more "
            "warm queries)")
        phase_s[name] = time.perf_counter() - t0
    return summary


def mesh_cards_sweep(n: int, device: str = CARD, cards=None) -> dict:
    """``--mesh-cards n``: config 10's table and query over n real cards and
    over n logical shards of card 0, at d:n and hosts:2,d:n/2, in turns
    (logical, cards, cards, logical), each driven cold and warm and checked
    as ``mesh_paths`` checks a width; the cards' outputs equal the logical
    shards' but the f64 sums. Returns {spec: {placement: (best warm s,
    best cold s, best of the turns' median K18 ms)}}."""
    if cards is None:
        check(torch.cuda.device_count() >= n, f"--mesh-cards {n}: {torch.cuda.device_count()} cards")
        cards = [torch.device("cuda", i) for i in range(n)]
    mb = mesh_table(MESH_ROWS)
    base = build_mesh_carnot(mb, MESH_ROWS, device)
    out = {}
    for spec in (f"d:{n}", f"hosts:2,d:{n // 2}"):
        res, first = {"cards": [], "logical": []}, None
        for placement in ("logical", "cards", "cards", "logical"):
            c = mesh_carnot(base, spec, n, cards if placement == "cards" else None)
            got = {}
            p = drive(c, MESH_QUERY, lambda r: got.update(verify_mesh(r, mb)), ("merge_states",))
            if first is None:
                first = got
            for k in ("n", "mn", "mx", "u", "cm"):
                check(str(got[k]) == str(first[k]), f"{spec} {placement}: {k} differs")
            res[placement].append((min(p["warm"]), p["cold"], k18_reads(c, device)[0]))
        out[spec] = {k: (min(r[0] for r in v), min(r[1] for r in v), min(r[2] for r in v))
                     for k, v in res.items()}
        log(f"mesh over {n} cards, {spec}: best warm / cold s / K18 ms: {out[spec]}")
    return out


def tree_merge_paths(carnot, data: dict, paths: dict, phase_s: dict,
                     profile: bool = False) -> None:
    """Config 5's t-digest (H8 merges) and reservoir_latency (H26 merges)
    over http_events on a 4-shard mesh of the card, held to the one-shard
    phases' truths: verify_sketches, and the reservoirs' numpy truth for the
    4-shard fold (``reservoir_truth``); with ``profile`` one warm
    reservoir_mesh4 query is traced (``profile_warm``)."""
    t0 = time.perf_counter()
    c = mesh_carnot(carnot, f"d:{TREE_SHARDS}", TREE_SHARDS)
    paths["sketches_mesh4"] = drive(
        c, SKETCHES, lambda r: verify_sketches(r, data, len(data["svc"])),
        ("tdigest_merge", "merge_states"),
    )
    phase_s["sketches_mesh4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = latency_sample_truth(data, TREE_SHARDS)
    log(f"reservoir_latency 4-shard truths in {time.perf_counter() - t0:.1f} s")
    paths["reservoir_mesh4"] = drive(
        c, RESERVOIR_LATENCY, lambda r: verify_reservoir_latency(r, data, truth),
        ("reservoir_topk_rows", "reservoir_topk", "merge_states"),
    )
    phase_s["reservoir_mesh4"] = time.perf_counter() - t0
    if profile:
        profile_warm(c, RESERVOIR_LATENCY, min(paths["reservoir_mesh4"]["warm"]),
                     "reservoir_mesh4")


MESH_JOIN_SPECS = ("hosts:2,d:4", "hosts:4,d:2")
JOIN_KERNELS = ("join_probe", "join_emit_pairs", "join_gather")


def joined_equal(a, b) -> bool:
    """Two joined results hold the same rows in the same order: numbers bit
    for bit, strings as decoded (each of b's codes mapped to the code of the
    same string in a's dictionary, so no row is decoded)."""
    ca, cb = joined(a), joined(b)
    if list(ca) != list(cb):
        return False
    for k in ca:
        x, y = ca[k], cb[k]
        if hasattr(x, "codes"):
            pos = {v: i for i, v in enumerate(x.dictionary.values())}
            lut = np.array([pos.get(v, -2) for v in y.dictionary.values()], dtype=np.int64)
            if len(x.codes) != len(y.codes) or not np.array_equal(
                    np.asarray(x.codes, np.int64), lut[y.codes]):
                return False
        elif not np.array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8)):
            return False
    return True


def mesh_join_paths(join_carnot, jf: dict, paths: dict, phase_s: dict, specs=MESH_JOIN_SPECS,
                    shards: int = MESH_SHARDS, devices=None, tag: str = "") -> dict:
    """Config 8's INNER and OUTER joins on meshes with a hosts axis (by
    default over ``shards`` logical shards of the card): each a main path
    (cold, then warm) through the partitioned lane (the join_partitioned
    lane on every query; H13-H15, and H12 for OUTER), held to the d:1
    paths' truths (verify_join8, verify_join8_outer) and to their rows, and
    to the replicated lane's rows on the same mesh (mesh_distributed_join
    off). Returns {path: {warm_s, cold_s, cold_reorder_s, warm_reorder_s}}."""
    from pixie_tpu_torch.utils import flags

    summary = {}
    for spec in specs:
        c = mesh_carnot(join_carnot, spec, shards, devices)
        for name, query, verify_fn, expect in (
            ("join8", JOIN8, verify_join8, JOIN_KERNELS),
            ("join8_outer", JOIN8_OUTER, verify_join8_outer, JOIN_KERNELS + ("scan_compact",)),
        ):
            t0 = time.perf_counter()
            pname = f"mesh{tag}_{name}_" + spec.replace(":", "").replace(",", "_")
            p = paths[pname] = drive(c, query, lambda r, f=verify_fn: f(r, jf), expect,
                                     streamed=False)
            check(p["lanes"] == {"join_partitioned": 1 + WARM_QUERIES},
                  f"{pname}: lanes {p['lanes']}, expected join_partitioned on every query")
            if name in paths:
                check(joined_equal(p["result"], paths[name]["result"]),
                      f"{pname}: rows differ from d:1's")
            flags.set("mesh_distributed_join", False)
            try:
                from pixie_tpu_torch.ops import segment

                segment.reduce_lanes(reset=True)
                replicated = c.execute_query(query)
                check(segment.reduce_lanes(reset=True) == {"join_sort_merge": 1},
                      f"{pname}: the flag off did not take the replicated lane")
            finally:
                flags.reset("mesh_distributed_join")
            check(joined_equal(p["result"], replicated),
                  f"{pname}: rows differ from the replicated lane's")
            del replicated
            summary[pname] = dict(
                warm_s=min(p["warm"]), cold_s=p["cold"],
                cold_reorder_s=p["cold_phases"].get("join_reorder", 0.0),
                warm_reorder_s=min(w.get("join_reorder", 0.0) for w in p["warm_phases"]),
            )
            log(f"{pname}: warm {summary[pname]['warm_s']:.4f} s (join_reorder "
                f"{summary[pname]['warm_reorder_s']:.4f}), cold {p['cold']:.3f} s "
                f"(join_reorder {summary[pname]['cold_reorder_s']:.4f}); equal to d:1 and to "
                "the replicated lane")
            phase_s[pname] = time.perf_counter() - t0
    return summary


# The sharded ring: bench.py's default http_small table at full
# width, ringed on 8 logical shards of the card (each 2^21-row window 8
# shards of 2^18 rows) at d:8 and at hosts:2,d:4; both executors' rings
# listen to one table, so its writes feed both.
RING_MESH_TABLE = "http_small_mesh"
RING_MESH_SPECS = ("d:8", "hosts:2,d:4")
RING_WINDOW_ROWS = 1 << 21  # resident_window_rows' default


def ring_mesh_queries(table: str = RING_MESH_TABLE) -> dict:
    return {"http_data": HTTP_DATA_RING.replace("'http_small_ring'", f"'{table}'"),
            "sketches": SKETCHES_RING.replace("'http_small_ring'", f"'{table}'")}


def ring_mesh_build(hs: dict, specs, shards: int, devices=None,
                    table: str = RING_MESH_TABLE) -> tuple:
    """({spec: Carnot}, build seconds, the build's launches): one Carnot a
    geometry over ``devices`` (by default ``shards`` logical shards of the
    card) sharing one table store, and http_small written once as ``table``
    with ``resident_ingest`` on, so every executor's ring stages its
    windows on the writer's thread. Each ring is checked: valid, 30 windows
    of [shards, nblk, b] lanes, RING_BYTES in its executor's pool, pinned."""
    from pixie_tpu_torch.distributed import MeshConfig
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.ops import kernels
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.utils import flags

    devices = devices or [CARD] * shards
    base = Carnot(device_executor=DeviceExecutor(
        block_rows=BLOCK_ROWS, mesh_config=MeshConfig.parse(specs[0], shards), devices=devices))
    carnots = {specs[0]: base}
    for spec in specs[1:]:
        carnots[spec] = mesh_carnot(base, spec, shards, devices)
    flags.set("resident_ingest", True)
    try:
        kernels.reset_launches()
        build_s = build_small_table(base, table, hs, SMALL_ROWS)
        launches = dict(kernels.LAUNCHES)
    finally:
        flags.reset("resident_ingest")
    for spec, c in carnots.items():
        ex = c.device_executor
        ring = ex._resident.ring_for(table)
        snap, pool = ring.snapshot(), ex._staged_cache.snapshot()
        log(f"ring {spec} over {len(set(map(str, devices)))} device(s): {json.dumps(snap)}; "
            f"pool {json.dumps(pool)}")
        check(snap["valid"] and snap["last_error"] is None, f"ring {spec} is invalid: {snap}")
        check(snap["windows"] == RING_WINDOWS and ring.d == shards,
              f"ring {spec}: {snap['windows']} windows of {ring.d} shards")
        check(ring.d * ring.nblk * ring.b == RING_WINDOW_ROWS,
              f"ring {spec}: windows of {ring.d} x {ring.nblk} x {ring.b} rows")
        check(all(lane.shape == (shards, ring.nblk, ring.b)
                  for w in ring.windows.values() for lane in w.blocks.values()),
              f"ring {spec}: a window is not shard-major")
        check(pool["resident_bytes"] == RING_BYTES and snap["bytes"] == RING_BYTES,
              f"ring {spec}: resident bytes {pool['resident_bytes']} != {RING_BYTES}")
        check(pool["pinned_bytes"] >= RING_BYTES, f"ring {spec}: pinned {pool['pinned_bytes']}")
    log(f"{table}: {SMALL_ROWS} rows written in {build_s:.3f} s feeding {len(carnots)} rings; "
        f"launches {({k: v for k, v in launches.items() if v})}")
    return carnots, build_s, launches


def ring_unringed(c, query: str, name: str):
    """``query`` on ``c``'s geometry with the ring off at query time and the
    stream at the ring's window size (the same shard-major layout), cold."""
    from pixie_tpu_torch.utils import flags

    was = flags.get("resident_ingest")
    flags.set("resident_ingest", False)
    flags.set("streaming_window_rows", RING_WINDOW_ROWS)
    try:
        c.device_executor.clear_caches()
        return c.execute_query(query).table(name)
    finally:
        flags.set("resident_ingest", was)
        flags.reset("streaming_window_rows")


def ring_mesh_paths(hs: dict, truth: dict, paths: dict, phase_s: dict,
                    profile: bool = False) -> tuple:
    """ring_mesh_d8 and ring_mesh_hosts2_d4: http_data (config 1) and config
    5's sketches over the sharded ring of RING_MESH_TABLE, each a main path
    (cold, then warm) held to bench.py's truths, as ``ring_paths`` holds
    the d:1 ring: every window a hit (30 on each cold query), the sketches'
    wire below a tenth of the staged bytes, a warm http_data query copying
    nothing; each output equal to the same geometry's with the ring off
    (stream windows of the ring's size). Then ring_mesh_chaos. With
    ``profile``, one warm query of each path under torch.profiler
    (``profile_warm``). Returns (the ring build's launches, {spec:
    summary}, the chaos summary)."""
    from pixie_tpu_torch.utils import flags

    t0 = time.perf_counter()
    carnots, build_s, build_launches = ring_mesh_build(hs, RING_MESH_SPECS, MESH_SHARDS)
    phase_s["ring_mesh_table"] = time.perf_counter() - t0
    queries = ring_mesh_queries()
    summary = {}
    flags.set("resident_ingest", True)
    try:
        for spec, c in carnots.items():
            tag = "ring_mesh_" + spec.replace(":", "").replace(",", "_")
            t0 = time.perf_counter()
            p = paths[f"{tag}_http_data"] = drive(
                c, queries["http_data"], lambda r: verify_http_data(r, hs),
                ("scan_compact", "scalar_eval", "ring_convert"), streamed=False,
            )
            cp = p["cold_phases"]
            check(cp.get("stage_resident_hits") == RING_WINDOWS,
                  f"{tag} http_data: {cp.get('stage_resident_hits')} resident hits")
            check(cp["wire_bytes"] < cp["stage_bytes"] / 3,
                  f"{tag} http_data: wire {cp['wire_bytes']} of stage {cp['stage_bytes']}")
            check(all(w.get("wire_bytes", 0.0) == 0.0 for w in p["warm_phases"]),
                  f"{tag} http_data: a warm query copied {p['warm_phases']}")
            check(p["launches"]["ring_convert"] == 2 * RING_WINDOWS,
                  f"{tag} http_data: {p['launches']['ring_convert']} H24 launches, expected one "
                  f"a converted column a window ({2 * RING_WINDOWS})")
            check(ring_unringed(c, queries["http_data"], "out") == p["result"].table("out"),
                  f"{tag} http_data: differs from the unringed {spec}")
            phase_s[f"{tag}_http_data"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            p = paths[f"{tag}_sketches"] = drive(
                c, queries["sketches"], lambda r: verify_sketches(r, truth, SMALL_ROWS),
                SKETCH_KERNELS + ("ring_convert",),
            )
            cp, lanes = p["cold_phases"], p["lanes"]
            check(cp.get("stage_resident_hits") == RING_WINDOWS
                  and cp.get("stream_windows") == RING_WINDOWS + 1,
                  f"{tag} sketches: {cp.get('stage_resident_hits')} hits in "
                  f"{cp.get('stream_windows')} windows")
            check(cp["wire_bytes"] < cp["stage_bytes"] / 10,
                  f"{tag} sketches: wire {cp['wire_bytes']} of stage {cp['stage_bytes']}")
            check(all(lanes.get(f"convert_{k}") == RING_WINDOWS
                      for k in ("f32", "intdict", "narrow")), f"{tag} sketches: lanes {lanes}")
            check(p["launches"]["ring_convert"] == 3 * RING_WINDOWS,
                  f"{tag} sketches: {p['launches']['ring_convert']} H24 launches")
            check(ring_unringed(c, queries["sketches"], "sketches")
                  == p["result"].table("sketches"),
                  f"{tag} sketches: differs from the unringed {spec}")
            ex = c.device_executor
            snap, pool = ex._resident.ring_for(RING_MESH_TABLE).snapshot(), ex._staged_cache.snapshot()
            check(snap["valid"] and snap["windows"] == RING_WINDOWS
                  and pool["pinned_bytes"] >= RING_BYTES, f"{tag}: ring {snap}, pool {pool}")
            summary[spec] = {
                "http_data": {"warm_s": min(paths[f"{tag}_http_data"]["warm"]),
                              "cold_s": paths[f"{tag}_http_data"]["cold"]},
                "sketches": {"warm_s": min(p["warm"]), "cold_s": p["cold"],
                             "wire_bytes": cp["wire_bytes"], "stage_bytes": cp["stage_bytes"]},
                "pinned_bytes": pool["pinned_bytes"],
            }
            log(f"{tag}: 30 hits a cold query, equal to the unringed {spec} bit for bit; "
                f"{json.dumps(summary[spec])}")
            if profile:
                for q in ("http_data", "sketches"):
                    profile_warm(c, queries[q], min(paths[f"{tag}_{q}"]["warm"]), f"{tag}_{q}")
            phase_s[f"{tag}_sketches"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chaos = ring_mesh_chaos(carnots["hosts:2,d:4"], queries["sketches"],
                                paths["ring_mesh_hosts2_d4_sketches"]["result"].table("sketches"))
        phase_s["ring_mesh_chaos"] = time.perf_counter() - t0
    finally:
        flags.reset("resident_ingest")
    for c in carnots.values():
        c.device_executor._resident.ring_for(RING_MESH_TABLE).release_all()
        c.device_executor.clear_caches()
    return build_launches, summary, chaos


def ring_mesh_chaos(c, query: str, unfaulted: dict) -> dict:
    """ring_mesh_chaos: config 5's sketches over the hosts:2,d:4 ring, cold,
    with one ``mesh.host_loss`` armed after half the windows' dispatches.
    The fold re-plans on the next rung (d:8), where the ring serves no
    window (every ring lookup of the query happens on the full geometry),
    and equals the unfaulted ringed output; the next cold query runs on the
    full geometry again and hits every window."""
    from pixie_tpu_torch.ops import kernels
    from pixie_tpu_torch.parallel import staging
    from pixie_tpu_torch.utils import faults, flags

    ex = c.device_executor
    full = ex.mesh_recovery_snapshot()["full_geometry"]
    ring = ex._resident.ring_for(RING_MESH_TABLE)
    sigs = []
    lookup = ring.lookup

    def spied(*a, **k):
        sigs.append(ex.mesh_recovery_snapshot()["geometry"])
        return lookup(*a, **k)

    ring.lookup = spied
    flags.set("streaming_window_rows", RING_WINDOW_ROWS)
    try:
        ex.clear_caches()
        staging.reset_cold_profile()
        kernels.reset_launches()
        torch.cuda.synchronize()
        faults.arm("mesh.host_loss", count=1, after=RING_WINDOWS // 2)
        t0 = time.perf_counter()
        try:
            res = c.execute_query(query).table("sketches")
        finally:
            faults.reset()
        torch.cuda.synchronize()
        faulted_s = time.perf_counter() - t0
        prof = staging.reset_cold_profile()
        snap = ex.mesh_recovery_snapshot()
        check(snap["degrade_events"] == 1 and snap["geometry"] != full,
              f"ring_mesh_chaos: no degrade: {snap}")
        check(sigs and set(sigs) == {full},
              f"ring_mesh_chaos: ring lookups on {sorted(set(sigs))}, not only {full}")
        check(res == unfaulted, "ring_mesh_chaos: the degraded fold differs from the ringed one")
        degraded_to, n_lookups = snap["geometry"], len(sigs)
        ex.clear_caches()
        staging.reset_cold_profile()
        res2 = c.execute_query(query).table("sketches")
        prof2 = staging.reset_cold_profile()
        check(prof2.get("stage_resident_hits") == RING_WINDOWS
              and ex.mesh_recovery_snapshot()["geometry"] == full,
              f"ring_mesh_chaos: the next query hit {prof2.get('stage_resident_hits')} windows "
              f"on {ex.mesh_recovery_snapshot()['geometry']}")
        check(res2 == unfaulted, "ring_mesh_chaos: the next query differs")
    finally:
        ring.lookup = lookup
        flags.reset("streaming_window_rows")
    out = dict(geometry=full, degraded_to=degraded_to, faulted_s=faulted_s,
               faulted_hits=prof.get("stage_resident_hits", 0.0), lookups=n_lookups,
               resume=ex.last_resume_stats, next_hits=prof2.get("stage_resident_hits"))
    log(f"ring_mesh_chaos: host lost after {RING_WINDOWS // 2} window dispatches on {full}, "
        f"the fold re-planned on {degraded_to} with no ring window served there, equal to the "
        f"unfaulted ringed fold; next query {RING_WINDOWS} hits on {full}; {json.dumps(out)}")
    return out


# The pushdown: config 8 with a pre-join predicate on each side.
PUSHDOWN_DROPPED = 5  # the INNER join drops svc-5's owner row
PUSHDOWN_OUTER_DROPPED = 6  # the OUTER join drops svc-6's (an owned service)


def join8_pushdown_queries(median: float) -> dict:
    r_pred = f"r = r[r.latency > {median!r}]\n"
    return {
        "join8_pushdown": JOIN8.replace(
            "j = l.merge", r_pred + f"l = l[l.svc != '{SERVICES[PUSHDOWN_DROPPED]}']\nj = l.merge"),
        "join8_outer_pushdown": JOIN8_OUTER.replace(
            "j = l.merge",
            r_pred + f"l = l[l.svc != '{SERVICES[PUSHDOWN_OUTER_DROPPED]}']\nj = l.merge"),
    }


def verify_join8_pushdown(result, jf: dict, median: float) -> None:
    """INNER to svc_owners without svc-5's row, of the fact rows with
    latency above the median: those rows but svc-5's in row order, svc ==
    service, owner team-{i % 4}."""
    cols = joined(result)
    idx = jf["svc_idx"].astype(np.int64)
    rows = np.flatnonzero((jf["latency"] > median) & (idx != PUSHDOWN_DROPPED))
    check(len(cols["time_"]) == rows.size,
          f"join8_pushdown: {len(cols['time_'])} rows, expected {rows.size}")
    check(np.array_equal(cols["time_"], rows * 1000), "join8_pushdown: time_")
    check(f64_bits_equal(cols["latency"], jf["latency"][rows]), "join8_pushdown: latency")
    check(np.array_equal(name_index(cols["svc"], SERVICES), idx[rows]), "join8_pushdown: svc")
    check(np.array_equal(name_index(cols["service"], SERVICES), idx[rows]),
          "join8_pushdown: service")
    check(np.array_equal(name_index(cols["owner"], [f"team-{i}" for i in range(4)]),
                         idx[rows] % 4), "join8_pushdown: owner")


def verify_join8_outer_pushdown(result, jf: dict, median: float) -> None:
    """OUTER to svc_owners_partial without svc-6's row, of the fact rows
    with latency above the median, in the lane's order: the matched fact
    rows in row order with their owner; the unmatched ones (unowned, or
    svc-6) in row order with svc and owner ""; then the 4 ghost rows."""
    cols = joined(result)
    partial = partial_owners()
    idx = jf["svc_idx"].astype(np.int64)
    sel = jf["latency"] > median
    owned = ~np.isin(idx, UNOWNED + (PUSHDOWN_OUTER_DROPPED,))
    rows = np.concatenate([np.flatnonzero(sel & owned), np.flatnonzero(sel & ~owned)])
    m = int((sel & owned).sum())
    ghosts = [partial.index(f"ghost-{j}") for j in range(4)]
    pos = np.array([partial.index(s) if s in partial else -1 for s in SERVICES])
    nulls = np.full(rows.size - m, -1)
    check(len(cols["time_"]) == rows.size + 4,
          f"join8_outer_pushdown: {len(cols['time_'])} rows, expected {rows.size + 4}")
    check(np.array_equal(cols["time_"], np.concatenate([rows * 1000, [0] * 4])),
          "join8_outer_pushdown: time_")
    check(f64_bits_equal(cols["latency"], np.concatenate([jf["latency"][rows], [0.0] * 4])),
          "join8_outer_pushdown: latency")
    check(np.array_equal(name_index(cols["service"], SERVICES),
                         np.concatenate([idx[rows], [-1] * 4])), "join8_outer_pushdown: service")
    check(np.array_equal(name_index(cols["svc"], partial),
                         np.concatenate([pos[idx[rows[:m]]], nulls, ghosts])),
          "join8_outer_pushdown: svc")
    check(np.array_equal(name_index(cols["owner"], [f"team-{i}" for i in range(4)]),
                         np.concatenate([pos[idx[rows[:m]]] % 4, nulls, np.array(ghosts) % 4])),
          "join8_outer_pushdown: owner")


def joined_multiset_equal(a, b) -> bool:
    """Two joined results hold the same rows as a multiset: each row as
    int64 words (strings as their index in the sorted union of both
    dictionaries' values, floats as their bits), the rows sorted."""
    ca, cb = joined(a), joined(b)
    if sorted(ca) != sorted(cb):
        return False
    mats = ([], [])
    for name in sorted(ca):
        x, y = ca[name], cb[name]
        if hasattr(x, "codes"):
            names = sorted(set(x.dictionary.values()) | set(y.dictionary.values()))
            mats[0].append(name_index(x, names))
            mats[1].append(name_index(y, names))
            continue
        for m, col in zip(mats, (x, y)):
            v = np.asarray(col)
            m.append(v.view(np.int64) if v.dtype == np.float64 else v.astype(np.int64))
    rows = [np.stack(m, axis=1) for m in mats]
    if rows[0].shape != rows[1].shape:
        return False
    a_rows, b_rows = (r[np.lexsort(r.T[::-1])] for r in rows)
    return np.array_equal(a_rows, b_rows)


def join8_pushdown_paths(join_carnot, jf: dict, paths: dict, phase_s: dict,
                         profile: bool = False) -> dict:
    """join8_pushdown and join8_outer_pushdown: config 8 with a pre-join
    predicate on each side (r.latency above its median, l.svc not one
    owned service), each a main path (cold, then warm) in the device lane
    (join_sort_merge on every query) held to its numpy truth, and to the
    host EquijoinNode's rows on the same tables (INNER in order, OUTER as a
    multiset: the host node interleaves each probe batch's unmatched rows);
    then each once on hosts:2,d:4 over 8 logical shards, in the partitioned
    lane (join_partitioned), equal to the device lane's rows in order. With
    ``profile``, one warm query of each under torch.profiler."""
    from pixie_tpu_torch.engine import Carnot

    median = float(np.median(jf["latency"]))
    queries = join8_pushdown_queries(median)
    host = Carnot(table_store=join_carnot.table_store)  # no device executor: the host nodes
    mesh = mesh_carnot(join_carnot, "hosts:2,d:4", MESH_SHARDS)
    out = {}
    for name, verify_fn, expect in (
        ("join8_pushdown", verify_join8_pushdown, JOIN_KERNELS),
        ("join8_outer_pushdown", verify_join8_outer_pushdown, JOIN_KERNELS + ("scan_compact",)),
    ):
        t0 = time.perf_counter()
        p = paths[name] = drive(join_carnot, queries[name],
                                lambda r, f=verify_fn: f(r, jf, median), expect, streamed=False)
        check(p["lanes"] == {"join_sort_merge": 1 + WARM_QUERIES},
              f"{name}: lanes {p['lanes']}, expected join_sort_merge on every query")
        t1 = time.perf_counter()
        on_host = host.execute_query(queries[name])
        host_s = time.perf_counter() - t1
        if name == "join8_pushdown":
            check(joined_equal(p["result"], on_host), f"{name}: rows differ from the host node's")
        else:
            check(joined_multiset_equal(p["result"], on_host),
                  f"{name}: rows differ from the host node's as a multiset")
        del on_host
        pname = f"{name}_hosts2_d4"
        pm = paths[pname] = drive(mesh, queries[name], lambda r, f=verify_fn: f(r, jf, median),
                                  expect, streamed=False)
        check(pm["lanes"] == {"join_partitioned": 1 + WARM_QUERIES},
              f"{pname}: lanes {pm['lanes']}, expected join_partitioned on every query")
        check(joined_equal(pm["result"], p["result"]), f"{pname}: rows differ from d:1's")
        out[name] = {"warm_s": min(p["warm"]), "cold_s": p["cold"], "host_node_s": host_s,
                     "rows": len(joined(p["result"])["time_"]),
                     "hosts2_d4_warm_s": min(pm["warm"]), "hosts2_d4_cold_s": pm["cold"],
                     "pushdown_s": p["cold_phases"].get("join_pushdown", 0.0)}
        log(f"{name}: {json.dumps(out[name])}; equal to numpy, the host node and hosts:2,d:4")
        if profile:
            profile_warm(join_carnot, queries[name], min(p["warm"]), name)
        phase_s[name] = time.perf_counter() - t0
    return out


CHAOS_ROWS = 1 << 25
CHAOS_WINDOWS = 8
CHAOS_SPEC = "hosts:2,d:4"
CHAOS_APPEND = 4096


def mesh_chaos(mb: dict, spec: str = CHAOS_SPEC, shards: int = MESH_SHARDS,
               devices=None, device: str = CARD) -> dict:
    """bench.py config 12 (tools/microbench_mesh.py:176-310) at config 10's
    scale: mesh_bench's query over a table of ``mb``'s rows (seed 23), written
    anew for each call, in
    CHAOS_WINDOWS stream windows on ``spec`` (by default over ``shards``
    logical shards of the card). The truth is the unfaulted flat fold over
    the same devices and numpy's (verify_mesh). Cold folds (a new executor
    each) with mesh_fold_checkpoint on and off, in turns; then one with
    ``mesh.host_loss`` armed after CHAOS_WINDOWS // 2 window dispatches: it
    must resume from that window's checkpoint on the next rung and equal
    the truth (counts, min/max, HLL and count-min exactly, the f64 sums
    within SUM_BOUND * sum |v|); then CHAOS_APPEND rows more and one more
    fold must run on the full geometry again."""
    from pixie_tpu_torch.ops import kernels
    from pixie_tpu_torch.parallel import staging
    from pixie_tpu_torch.table.column import DictColumn
    from pixie_tpu_torch.utils import faults, flags

    n = int(mb["n"].sum())
    t0 = time.perf_counter()
    chaos_base = build_mesh_carnot(mb, n, device)
    table_s = time.perf_counter() - t0
    flags.set("streaming_window_rows", n // CHAOS_WINDOWS)

    def cold_fold(sp, ckpt=True):
        flags.set("mesh_fold_checkpoint", ckpt)
        c = mesh_carnot(chaos_base, sp, shards, devices)
        staging.reset_cold_profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = c.execute_query(MESH_QUERY)
        torch.cuda.synchronize()
        return c, res, time.perf_counter() - t0, staging.reset_cold_profile()

    try:
        _, res, _, _ = cold_fold(f"d:{shards}")
        truth = verify_mesh(res, mb)
        walls = {True: [], False: []}
        ckpt_s = []
        for ckpt in (True, False, True, False):
            c, res, wall, prof = cold_fold(spec, ckpt)
            got = verify_mesh(res, mb)
            for k in ("n", "mn", "mx", "u", "cm"):
                check(str(got[k]) == str(truth[k]), f"chaos unfaulted {spec}: {k} differs")
            snap = c.device_executor.mesh_recovery_snapshot()
            check(snap["checkpoint_windows"] == (CHAOS_WINDOWS if ckpt else 0),
                  f"chaos: {snap['checkpoint_windows']} windows checkpointed")
            walls[ckpt].append(wall)
            if ckpt:
                ckpt_s.append(prof.get("stage_stream_ckpt", 0.0))
        after = CHAOS_WINDOWS // 2
        kernels.reset_launches()
        faults.arm("mesh.host_loss", count=1, after=after)
        try:
            c, res, faulted, prof = cold_fold(spec)
        finally:
            faults.reset()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        got = verify_mesh(res, mb)
        for k in ("n", "mn", "mx", "u", "cm"):
            check(str(got[k]) == str(truth[k]), f"chaos recovered {spec}: {k} differs")
        ex = c.device_executor
        snap, rs = ex.mesh_recovery_snapshot(), ex.last_resume_stats
        check(rs == {"resumed_from_window": after, "refolded_windows": CHAOS_WINDOWS - after,
                     "total_windows": CHAOS_WINDOWS}, f"chaos: resume stats {rs}")
        check(snap["degrade_events"] == 1 and snap["checkpoint_resumes"] == 1,
              f"chaos: snapshot {snap}")
        degraded_to = snap["geometry"]
        table = chaos_base.table_store.get_table("mesh_bench")
        rng = np.random.default_rng(24)
        table.write_pydict({
            "service": DictColumn(rng.integers(0, MESH_SERVICES, CHAOS_APPEND).astype(np.int32),
                                  table.dictionaries["service"]),
            "status": rng.integers(0, 7, CHAOS_APPEND),
            "lat": rng.standard_normal(CHAOS_APPEND),
        })
        res = c.execute_query(MESH_QUERY)
        check(sum(res.table("out")["n"]) == n + CHAOS_APPEND, "chaos: the fold after the append")
        restored = not ex.mesh_recovery_snapshot()["degraded"]
        check(restored, "chaos: the next fold did not restore the full geometry")
    finally:
        flags.reset("streaming_window_rows")
        flags.reset("mesh_fold_checkpoint")
    unfaulted = min(walls[True])
    frac = rs["refolded_windows"] / rs["total_windows"]
    check(frac < 1.0, "chaos: the checkpoints saved no window")
    summary = dict(
        geometry=spec, degraded_to=degraded_to, rows=n, windows=CHAOS_WINDOWS, table_s=table_s,
        fault_after_window=after, unfaulted_fold_s=unfaulted, faulted_fold_s=faulted,
        recovery_seconds=max(0.0, faulted - unfaulted),
        resumed_from_window=rs["resumed_from_window"], refolded_windows=rs["refolded_windows"],
        refolded_window_fraction=frac, checkpoint_saved_fraction=1.0 - frac,
        degrade_events=snap["degrade_events"], restored_after_next_fold=restored,
        cold_ckpt_on_s=walls[True], cold_ckpt_off_s=walls[False],
        stage_stream_ckpt_s=ckpt_s, faulted_launches=launches,
        recovered={k: got[k] for k in ("n", "mn", "mx", "u", "cm")},
    )
    log(f"mesh_chaos {spec}: recovery {summary['recovery_seconds']:.3f} s over the unfaulted "
        f"{unfaulted:.3f} s (faulted {faulted:.3f} s on {spec} -> {degraded_to}); resumed "
        f"from window {rs['resumed_from_window']}, refolded {rs['refolded_windows']} of "
        f"{CHAOS_WINDOWS}; cold checkpoints on {walls[True]} / off {walls[False]} s, "
        f"stage_stream_ckpt {ckpt_s} s; launches of the faulted fold {launches}")
    return summary


def mesh_cards_paths(n: int, paths: dict, phase_s: dict) -> dict:
    """``--mesh-cards n``: config 8's joins and config 12 at hosts:2,d:n/2
    over n real cards against the same geometry over n logical shards of
    card 0 (the joins in turns logical, cards, cards, logical, each held to
    the d:1 joins' truths and rows; the chaos once each, its recovered
    outputs equal). Returns {what: {placement: numbers}}."""
    cards = [torch.device("cuda", i) for i in range(n)]
    spec = f"hosts:2,d:{n // 2}"
    jf = join_fact(JOIN_ROWS)
    join_carnot = build_join_carnot(jf, JOIN_ROWS, CARD)
    for name, query, verify_fn, expect in (
        ("join8", JOIN8, verify_join8, JOIN_KERNELS),
        ("join8_outer", JOIN8_OUTER, verify_join8_outer, JOIN_KERNELS + ("scan_compact",)),
    ):
        paths[name] = drive(join_carnot, query, lambda r, f=verify_fn: f(r, jf), expect,
                            streamed=False)
    out = {"join": {"logical": [], "cards": []}}
    for i, placement in enumerate(("logical", "cards", "cards", "logical")):
        out["join"][placement].append(mesh_join_paths(
            join_carnot, jf, paths, phase_s, specs=(spec,), shards=n,
            devices=cards if placement == "cards" else None, tag=f"_{placement}{i}"))
    cm = mesh_table(CHAOS_ROWS, seed=23)
    chaos = {placement: mesh_chaos(cm, spec, n, cards if placement == "cards" else None)
             for placement in ("logical", "cards")}
    check(str(chaos["cards"].pop("recovered")) == str(chaos["logical"].pop("recovered")),
          "mesh_chaos over cards: the recovered outputs differ from the logical shards'")
    out["chaos"] = chaos
    log(f"mesh over {n} cards, {spec}: joins {json.dumps(out['join'])}; chaos "
        f"{json.dumps(chaos)}")
    return out


def ring_mesh_cards(n: int, cards=None) -> dict:
    """``--mesh-cards n``: http_small ringed at d:n over n logical shards
    of card 0 and then over n real cards (each its own table, written
    anew), http_data and config 5's sketches
    driven cold and warm on each, every cold query 30 hits; the cards'
    outputs equal the logical shards' (http_data's rows, the sketches'
    count-min cells and t-digest quantiles). Returns {placement: {query:
    (best warm s, cold s)}}."""
    from pixie_tpu_torch.utils import flags

    if cards is None:
        check(torch.cuda.device_count() >= n,
              f"--mesh-cards {n}: {torch.cuda.device_count()} cards")
        cards = [torch.device("cuda", i) for i in range(n)]
    hs = http_small(SMALL_ROWS)
    truth = small_truths(hs)
    out, results = {}, {}
    for placement, devices in (("logical", None), ("cards", cards)):
        carnots, build_s, _ = ring_mesh_build(hs, (f"d:{n}",), n, devices)
        c = carnots[f"d:{n}"]
        flags.set("resident_ingest", True)
        try:
            res = {}
            for q, query in ring_mesh_queries().items():
                verify_fn = ((lambda r: verify_http_data(r, hs)) if q == "http_data" else
                             (lambda r: verify_sketches(r, truth, SMALL_ROWS)))
                p = drive(c, query, verify_fn, ("ring_convert",), streamed=q == "sketches")
                check(p["cold_phases"].get("stage_resident_hits") == RING_WINDOWS,
                      f"ring over {n} {placement}: {q} hit "
                      f"{p['cold_phases'].get('stage_resident_hits')} windows")
                res[q] = p["result"].table("out" if q == "http_data" else "sketches")
                out.setdefault(placement, {})[q] = (min(p["warm"]), p["cold"])
            out[placement]["build_s"] = build_s
        finally:
            flags.reset("resident_ingest")
        results[placement] = res
        c.device_executor._resident.ring_for(RING_MESH_TABLE).release_all()
        del carnots, c
    a, b = results["logical"], results["cards"]
    check(a["http_data"] == b["http_data"], f"ring over {n} cards: http_data rows differ")
    check(a["sketches"]["freq"] == b["sketches"]["freq"]
          and a["sketches"]["service"] == b["sketches"]["service"],
          f"ring over {n} cards: count-min cells differ")
    out["sketches_equal"] = a["sketches"] == b["sketches"]
    log(f"ring over {n} cards against {n} logical shards of card 0, d:{n}: {json.dumps(out)}")
    return out


# With --log-shapes: the shape of every H4, H9, H10, H12, H16 and H18 launch
# a path makes, entries whose device values (selected rows, runs used, exact
# groups) are read when the path ends, so recording adds no sync inside a
# query.
SHAPES: Optional[list] = None


def log_launch_shapes(kernels) -> None:
    """Wraps H4's, H9's, H10's, H12's, H16's and H18's wrappers in ``kernels``
    so that each call adds its shape to SHAPES: for H4 S, nbins and Q; for
    H9 G, C, Q and the groups whose weights are whole and total at most
    2^24 (the exact ones); for H10 S and m; for H12 n, the
    selected rows, ``written`` before the launch, the limit (or cap) and the
    columns' widths (the index lane: none); for H16 n, K, cap, S_l, S_r, the
    dtypes ``jk`` and ``gids`` reach the kernel in, ``jk``'s offset and
    whether the effective mask is asked for; for H18 d, L, R, the block
    dtype and the runs each shard uses (the ends below L, plus one)."""
    from pixie_tpu_torch.ops import tdigest

    global SHAPES
    SHAPES = []

    def wrap(name, shape):
        fn = getattr(kernels, name)

        def logged(*a, **kw):
            SHAPES.append(shape(*a, **kw))
            return fn(*a, **kw)

        setattr(kernels, name, logged)

    def h12(mask, cols, written, bufs, limit, *rest, **kw):
        return {"kernel": "scan_compact", "n": mask.shape[0], "selected": mask.sum(),
                "written": written.clone(), "limit": limit,
                "widths": [c.element_size() for c in cols]}

    def h12_index(mask, cap, *rest, **kw):
        return {"kernel": "scan_compact", "lane": "index", "n": mask.shape[0],
                "selected": mask.sum(), "written": torch.zeros(1, dtype=torch.int32),
                "limit": cap, "widths": []}

    def h18(values, ends, out, *rest, **kw):
        d, L = out.shape
        return {"kernel": "codec_rle_decode", "d": d, "L": L, "R": values.shape[1],
                "dtype": str(out.dtype).split(".")[1],
                "runs": torch.clamp_max((ends < L).sum(dim=1) + 1, values.shape[1])}

    def h10(state, *rest, **kw):
        return {"kernel": "hll_estimate", "S": state.shape[0], "m": state.shape[1]}

    def h4(state, qs, *rest, **kw):
        return {"kernel": "hist_quantiles", "S": state.shape[0], "nbins": state.shape[1],
                "Q": qs.shape[0]}

    def h9(means, weights, qs, *rest, **kw):
        return {"kernel": "tdigest_quantiles", "G": means.shape[0], "C": means.shape[1],
                "Q": qs.shape[0], "exact": tdigest.quantile_exact_groups(weights).sum()}

    def h16(jk, gids, mask, n_right, left_vals, right_sums, acc, eff_mask=None,
            jk_offset=0, **kw):
        return {"kernel": "join_agg_fold", "n": jk.shape[0], "K": n_right.shape[0],
                "cap": acc.shape[1], "S_l": len(left_vals), "S_r": right_sums.shape[0],
                "jk": str(jk.dtype).split(".")[1], "jk_offset": int(jk_offset),
                "gids": str(gids.dtype).split(".")[1], "mask": mask is not None,
                "eff_mask": eff_mask is not None}

    wrap("hist_quantiles", h4)
    wrap("tdigest_quantiles", h9)
    wrap("hll_estimate", h10)
    wrap("join_agg_fold", h16)
    wrap("scan_compact", h12)
    if hasattr(kernels, "scan_compact_indices"):
        wrap("scan_compact_indices", h12_index)
    wrap("codec_rle_decode", h18)


def take_shapes() -> list:
    """SHAPES since the last call, their device values read (a sync)."""
    if SHAPES is None:
        return []
    out = []
    for e in SHAPES:
        e = dict(e)
        for k in ("selected", "written", "exact"):
            if k in e:
                e[k] = int(e[k].reshape(-1)[0]) if k == "written" else int(e[k])
        if "runs" in e:
            e["runs"] = [int(x) for x in e["runs"].tolist()]
        out.append(e)
    SHAPES.clear()
    return out


def write_http_events(table, data: dict, lo: int, hi: int, window_rows: int = 0) -> None:
    """http_events rows [lo, hi) of ``data`` into ``table`` (the service
    dictionary's identity codes already set): in 16M-row batches, or with
    ``window_rows`` in READ_ROWS-row batches, eow on the last batch of every
    ``window_rows`` rows from ``lo`` (and on the table's last batch)."""
    from pixie_tpu_torch.table.column import DictColumn

    svc_dict = table.dictionaries["service"]
    step = READ_ROWS if window_rows else 16_000_000
    off = lo
    while off < hi:
        m = min(step, hi - off)
        if window_rows:
            m = min(m, window_rows - (off - lo) % window_rows)
        end = off + m
        table.write_pydict({
            "time_": np.arange(off, end, dtype=np.int64) * 1000,
            "service": DictColumn(data["svc"][off:end].astype(np.int32), svc_dict),
            "resp_status": data["status"][off:end],
            "latency": data["latency"][off:end],
        }, eow=bool(window_rows) and ((end - lo) % window_rows == 0 or end == hi))
        off = end


def http_events_carnot(data: dict, lo: int, hi: int, device: str, window_rows: int = 0,
                       router=None, instance: str = "local"):
    """A Carnot with a DeviceExecutor on ``device`` whose http_events holds
    rows [lo, hi) of ``data`` (``write_http_events``)."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.types import DataType, Relation, SemanticType

    carnot = Carnot(router=router, instance=instance,
                    device_executor=DeviceExecutor(device=device, block_rows=BLOCK_ROWS))
    rel = Relation.of(
        ("time_", DataType.TIME64NS, SemanticType.ST_TIME_NS),
        ("service", DataType.STRING, SemanticType.ST_SERVICE_NAME),
        ("resp_status", DataType.INT64),
        ("latency", DataType.FLOAT64, SemanticType.ST_DURATION_NS),
    )
    table = carnot.table_store.create_table("http_events", rel, size_limit=1 << 42)
    for i in range(N_SERVICES):  # identity codes 0..15, as bench.py
        table.dictionaries["service"].get_code(f"ns/svc-{i}")
    write_http_events(table, data, lo, hi, window_rows)
    if not window_rows:
        table.compact()
    table.stop()
    check(table.min_row_id() == 0 and table.end_row_id() == hi - lo, "table expired rows")
    return carnot


def window_truths(data: dict, n_rows: int, window_rows: int) -> list:
    """The per-window truths of http_events cut every ``window_rows`` rows:
    for each window, the counts, error counts, truth latency histograms and
    per-status counts per service (``http_events``' keys)."""
    n_win = -(-n_rows // window_rows)
    slots = n_win * N_SERVICES
    tc = np.zeros(slots, np.int64)
    te = np.zeros(slots, np.int64)
    th = np.zeros(slots * TRUTH_BINS, np.int64)
    ts = np.zeros(slots * len(STATUSES), np.int64)
    opts = np.array(STATUSES, np.uint16)
    chunk = 16_000_000
    for off in range(0, n_rows, chunk):
        m = min(chunk, n_rows - off)
        slot = (np.arange(off, off + m, dtype=np.int64) // window_rows) * N_SERVICES + (
            data["svc"][off : off + m])
        st = data["status"][off : off + m]
        tc += np.bincount(slot, minlength=slots)
        te += np.bincount(slot, weights=(st >= 400), minlength=slots).astype(np.int64)
        th += np.bincount(slot * TRUTH_BINS + np.digitize(data["latency"][off : off + m],
                                                          TRUTH_EDGES),
                          minlength=slots * TRUTH_BINS)
        ts += np.bincount(slot * len(STATUSES) + np.searchsorted(opts, st),
                          minlength=slots * len(STATUSES))
    tc, te = tc.reshape(n_win, N_SERVICES), te.reshape(n_win, N_SERVICES)
    th = th.reshape(n_win, N_SERVICES, TRUTH_BINS)
    ts = ts.reshape(n_win, N_SERVICES, len(STATUSES))
    return [dict(tc=tc[w], te=te[w], th=th[w], ts=ts[w]) for w in range(n_win)]


class OneBatch:
    """A result whose ``table(name)`` is one RowBatch's columns: a window's
    batch handed to the whole-table verifiers."""

    def __init__(self, batch):
        self.batch = batch

    def table(self, name: str) -> dict:
        return self.batch.to_pydict()


def verify_windowed(result, name: str, truths: list, verify_one) -> None:
    """One batch a window, in window order, eow on each and eos on the last
    only; each window's batch verified against that window's truths."""
    batches = result.tables[name]
    check(len(batches) == len(truths), f"{name}: {len(batches)} batches for {len(truths)} windows")
    for w, (b, t) in enumerate(zip(batches, truths)):
        check(b.eow and b.eos == (w == len(truths) - 1), f"{name}: window {w}'s flags")
        verify_one(OneBatch(b), t, int(t["tc"].sum()))


def windowed_plan(carnot, query: str):
    """``query`` compiled, its aggregation made windowed: what a plan that
    reaches the engine through ``execute_plan`` carries (no PxL script
    makes a windowed aggregation)."""
    import dataclasses

    from pixie_tpu_torch.plan.operators import AggOp

    plan = carnot.compiler.compile(query, carnot.table_store.relation_map())
    (frag,) = plan.fragments
    aggs = [nid for nid in frag.nodes() if isinstance(frag.node(nid), AggOp)]
    check(len(aggs) == 1, f"windowed_plan: {len(aggs)} aggregations")
    frag._nodes[aggs[0]].op = dataclasses.replace(frag.node(aggs[0]), windowed=True)
    return plan


def split_query(pems: list, kelvin, query: str):
    """``query`` split by the port's DistributedPlanner over the PEM Carnots
    (each holding part of http_events) and the Kelvin, all on one
    BridgeRouter; each instance runs its fragments as an agent does
    (``execute_plan(manage_router=False)``, pixie_tpu/vizier/agent.py:667),
    the PEMs first. Every PEM's PARTIAL fragment must fold on its executor
    and hand its MERGE a StateBatch. Returns the Kelvin's result."""
    import uuid

    from pixie_tpu_torch.distributed import AgentInfo, DistributedPlanner, DistributedState
    from pixie_tpu_torch.plan.operators import AggOp, AggStage, BridgeSinkOp
    from pixie_tpu_torch.plan.plan import Plan

    rels = pems[0].table_store.relation_map()
    logical = kelvin.compiler.compile(query, rels, query_id=str(uuid.uuid4()))
    state = DistributedState([AgentInfo(p.instance, frozenset(rels)) for p in pems]
                             + [AgentInfo(kelvin.instance, frozenset(), is_kelvin=True)])
    plan = DistributedPlanner(kelvin.registry, rels).plan(logical, state)
    qid, router = plan.query_id, kelvin.router
    subs: dict = {}
    for f in plan.fragments:
        inst = plan.executing_instance[f.fragment_id]
        sub = subs.setdefault(inst, Plan(qid))
        sub.fragments.append(f)
        sub.executing_instance[f.fragment_id] = inst
        for nid in f.nodes():
            if isinstance(f.node(nid), BridgeSinkOp):
                router.register_producer(qid, f.node(nid).bridge_id)
    try:
        for p in pems:
            (frag,) = subs[p.instance].fragments
            stages = [frag.node(n).stage for n in frag.nodes() if isinstance(frag.node(n), AggOp)]
            check(stages == [AggStage.PARTIAL], f"{p.instance}: stages {stages}")
            p.execute_plan(subs[p.instance], manage_router=False)
        return kelvin.execute_plan(subs[kelvin.instance], manage_router=False)
    finally:
        router.cleanup_query(qid)


def pem_split_carnots(data: dict, n_rows: int, devices: list) -> tuple:
    """Two PEM Carnots (rows [0, n/2) and [n/2, n) of http_events, each with
    its own DeviceExecutor on ``devices[i]``) and a Kelvin Carnot on
    ``devices[2]``, sharing one BridgeRouter."""
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.exec import BridgeRouter

    router = BridgeRouter()
    half = n_rows // 2
    pems = [http_events_carnot(data, lo, hi, devices[i], router=router, instance=f"pem{i}")
            for i, (lo, hi) in enumerate(((0, half), (half, n_rows)))]
    kelvin = Carnot(router=router, instance="kelvin", device=devices[2])
    return pems, kelvin


def windowed_paths(data: dict, n_rows: int, paths: dict, phase_s: dict):
    """service_stats and config 5's sketches as windowed FULL folds over
    http_events cut into WINDOWS windows at full width: WINDOW_SLOTS
    (window, service) slots, so H3 past its cluster lane and the t-digest's
    wide lane (H7a, torch.sort, H7b). Returns the windowed Carnot."""
    t0 = time.perf_counter()
    window_rows = -(-n_rows // WINDOWS)
    win = http_events_carnot(data, 0, n_rows, CARD, window_rows=window_rows)
    truths = window_truths(data, n_rows, window_rows)
    log(f"windowed http_events: {n_rows} rows in {WINDOWS} windows written and their truths "
        f"in {time.perf_counter() - t0:.1f} s")
    phase_s["windowed_table"] = time.perf_counter() - t0
    for name, query, table, verify_one, expect in (
        ("svc_windowed", SERVICE_STATS, "service_stats", verify,
         ("segment_rows_sum_i64", "log_histogram_update", "hist_quantiles", "scalar_eval")),
        ("sketches_windowed", SKETCHES, "sketches", verify_sketches,
         ("tdigest_pack", "tdigest_cluster", "tdigest_merge", "tdigest_quantiles")),
    ):
        t0 = time.perf_counter()
        paths[name] = drive(
            win, query, lambda r, t=table, v=verify_one: verify_windowed(r, t, truths, v), expect,
            run=lambda q=query: win.execute_plan(windowed_plan(win, q)),
        )
        lanes = paths[name]["lanes"]
        check(lanes.get("fold_windowed") == 1 + WARM_QUERIES and "fold_key_host" in lanes,
              f"{name}: lanes {lanes}")
        cp = paths[name]["cold_phases"]
        log(f"{name}: the key plan {cp.get('key_plan', 0.0):.3f} s of the cold query's "
            f"{paths[name]['cold']:.3f} s ({100 * cp.get('key_plan', 0.0) / paths[name]['cold']:.1f}%; "
            f"_windowize_key_plan reads the table twice); warm key plans "
            f"{[round(p.get('key_plan', 0.0), 3) for p in paths[name]['warm_phases']]} s")
        phase_s[name] = time.perf_counter() - t0
    check(paths["sketches_windowed"]["launches"]["tdigest_update"] == 0,
          "sketches_windowed: a 512-slot update took H7")
    return win


def pem_split_paths(data: dict, n_rows: int, paths: dict, phase_s: dict,
                    devices=(CARD, CARD, CARD)) -> tuple:
    """service_stats and config 5's sketches split by the DistributedPlanner
    over two PEMs on ``devices[0]`` and ``devices[1]``, each folding its
    half of http_events as a PARTIAL aggregation whose states stay on its
    card, merged by the Kelvin's MERGE AggNode on ``devices[2]`` (H8, H4,
    H9 there), against the whole table's truths. Returns (pems, kelvin)."""
    t0 = time.perf_counter()
    pems, kelvin = pem_split_carnots(data, n_rows, list(devices))
    log(f"PEM split: {n_rows} rows over two PEMs on {devices[0]} and {devices[1]}, the Kelvin on "
        f"{devices[2]}, written in {time.perf_counter() - t0:.1f} s")
    phase_s["pem_split_tables"] = time.perf_counter() - t0
    for name, query, verify_fn, expect in (
        ("svc_pem_split", SERVICE_STATS, lambda r: verify(r, data, n_rows),
         ("segment_rows_sum_i64", "log_histogram_update", "hist_quantiles", "scalar_eval")),
        ("sketches_pem_split", SKETCHES, lambda r: verify_sketches(r, data, n_rows),
         ("tdigest_update", "tdigest_merge", "tdigest_quantiles")),
    ):
        t0 = time.perf_counter()
        paths[name] = drive(
            None, query, verify_fn, expect, run=lambda q=query: split_query(pems, kelvin, q),
            executors=[p.device_executor for p in pems],
        )
        lanes = paths[name]["lanes"]
        check(lanes.get("fold_partial") == 2 * (1 + WARM_QUERIES), f"{name}: lanes {lanes}")
        phase_s[name] = time.perf_counter() - t0
    return pems, kelvin


def drive(carnot, query: str, verify_fn, expect: tuple, now_ns=None,
          streamed: bool = True, offloaded: bool = True, run=None, executors=None) -> dict:
    """One main path: launch counts and lanes zeroed just before, one cold
    query (the executors' staged columns and key plans dropped first, so
    that no path reuses another's) and WARM_QUERIES warm queries, each
    verified, counts and lanes read just after. A ``streamed`` path must
    have staged its cold query through the stream (the stage_stream lane,
    once an executor) and no warm one; an ``offloaded`` one must have
    folded on the device lanes (a path of host aggregations only does not).
    ``run`` (default: ``carnot.execute_query(query)``) runs one query;
    ``executors`` (default: the carnot's) are the path's DeviceExecutors,
    each of which must have folded every query."""
    from pixie_tpu_torch.ops import kernels, segment
    from pixie_tpu_torch.parallel import staging

    executors = executors or [carnot.device_executor]
    run = run or (lambda: carnot.execute_query(query, now_ns=now_ns))

    def one() -> tuple:
        for ex in executors:
            ex.last_fold_ms = None
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(not offloaded or all(ex.last_fold_ms is not None for ex in executors),
              "fragment not offloaded")
        return result, secs

    for ex in executors:
        ex.clear_caches()
    kernels.reset_launches()
    staging.reset_cold_profile()
    segment.reduce_lanes(reset=True)
    torch.cuda.synchronize()
    take_shapes()
    result, cold = one()
    cold_phases = staging.reset_cold_profile()
    verify_fn(result)
    warm, warm_phases = [], []
    for _ in range(WARM_QUERIES):
        result, secs = one()
        warm.append(secs)
        warm_phases.append(staging.reset_cold_profile())
        verify_fn(result)
    launches = dict(kernels.LAUNCHES)
    lanes = segment.reduce_lanes(reset=True)
    for name in expect:
        check(launches[name] > 0, f"kernel {name} was not launched on its main path")
    if streamed:
        check(lanes.get("stage_stream") == len(executors)
              and cold_phases.get("stream_windows", 0) > 0,
              f"the cold query did not stream once an executor: lanes {lanes}")
    return dict(cold=cold, cold_phases=cold_phases, warm=warm, warm_phases=warm_phases,
                launches=launches, lanes=lanes, result=result, shapes=take_shapes())


# One turn of ``--ab-parent``: config 10's table and query in the tree of
# the working directory, every width cold once and then warm. In a tree
# whose executor has the recovery plane, each warm query alternates with one
# that calls the attempt and the dispatches directly (``bypassed``).
AB_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import chip_smoke as cs
from pixie_tpu_torch.ops import kernels
kernels.library()
mb = cs.mesh_table(cs.MESH_ROWS)
base = cs.build_mesh_carnot(mb, cs.MESH_ROWS, "cuda")
out = {}
for spec in ("d:1",) + cs.MESH_WIDTHS:
    c = base if spec == "d:1" else cs.mesh_carnot(base, spec, cs.MESH_SHARDS)
    ex = c.device_executor
    t = time.perf_counter(); c.execute_query(cs.MESH_QUERY); cold = time.perf_counter() - t
    plane = hasattr(ex, "_execute_with_recovery")
    warm, bypassed = [], []
    for i in range(2 * %d):
        off = plane and i %% 2 == 1
        if off:
            ex.try_execute_fragment = ex._try_execute_fragment
            ex._mesh_dispatch = lambda fn, what="fold": fn()
        t = time.perf_counter(); c.execute_query(cs.MESH_QUERY); dt = time.perf_counter() - t
        if off:
            del ex.try_execute_fragment, ex._mesh_dispatch
        (bypassed if off else warm).append(dt)
    out[spec] = {"cold_s": cold, "warm_s": warm, "bypassed_s": bypassed}
print("RESULT " + json.dumps(out), flush=True)
"""


def ab_turns(parent: str, pairs: int, child: str) -> dict:
    """``pairs`` pairs of turns of the ``child`` program, ``parent``'s tree
    and this one in ABBA order (parent, change, change, parent, ...), each
    turn its own process (its own kernel build, tables and executors),
    each printing one RESULT line of JSON. Returns each side's turns."""
    import os

    turns = {"parent": [], "change": []}
    here = os.path.dirname(os.path.abspath(__file__))
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for tag in order:
            p = subprocess.run([sys.executable, "-c", child],
                               cwd=parent if tag == "parent" else here,
                               capture_output=True, text=True, timeout=900)
            line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
            check(p.returncode == 0 and bool(line),
                  f"--ab-parent: the {tag} turn failed ({p.returncode}): {p.stderr[-2000:]}")
            turns[tag].append(json.loads(line[0][len("RESULT "):]))
            log(f"ab pair {i} {tag}: " + ", ".join(
                f"{k} {float(np.median(v['warm_s'] if isinstance(v, dict) else v)):.5f}"
                for k, v in turns[tag][-1].items()))
    return turns


def ab_widths(parent: str, pairs: int, warm: int = 15) -> dict:
    """``--ab-parent``: config 10's d:1 and 8-shard widths in ``parent``'s
    tree and in this one (``ab_turns``). A turn reads each width's cold
    query and ``warm`` warm ones (per turn the median). Per width: each
    side's turn medians, the change's wins and the change minus the
    parent's median of turn medians; in the change's turns also the
    recovery plane bypassed."""
    turns = ab_turns(parent, pairs, AB_CHILD % warm)
    out = {}
    for spec in turns["change"][0]:
        med = {tag: [float(np.median(t[spec]["warm_s"])) for t in turns[tag]] for tag in turns}
        cold = {tag: [t[spec]["cold_s"] for t in turns[tag]] for tag in turns}
        byp = [float(np.median(t[spec]["bypassed_s"])) for t in turns["change"]]
        out[spec] = dict(
            parent_warm=med["parent"], change_warm=med["change"], change_bypassed=byp,
            parent_cold=cold["parent"], change_cold=cold["change"],
            change_wins=sum(c < p for c, p in zip(med["change"], med["parent"])),
            delta_warm=float(np.median(med["change"]) - np.median(med["parent"])),
            delta_bypass=float(np.median(med["change"]) - np.median(byp)),
        )
        log(f"ab {spec}: warm parent {np.median(med['parent']):.5f} "
            f"[{min(med['parent']):.5f}, {max(med['parent']):.5f}], change "
            f"{np.median(med['change']):.5f} [{min(med['change']):.5f}, "
            f"{max(med['change']):.5f}], bypassed {np.median(byp):.5f}; change wins "
            f"{out[spec]['change_wins']} of {pairs}; cold parent {np.median(cold['parent']):.3f} "
            f"change {np.median(cold['change']):.3f}")
    return out


# One turn of ``--ab-parent --ab-paths``: the named paths in the tree of the
# working directory, each on its own table as the main run builds it:
# service_stats, sketches and reservoir_latency (http_events), flows,
# flow_span and reservoir_flows (conn_flows), svc_let, endpoint_load and
# path_embeddings (the let table) and mesh_d1 (config 10's table at d:1)
# warm, flow_window (conn_flows) cold (the executor's caches dropped before
# each query), the build of http_small_ring with resident ingest on (seconds
# from create_table to stop(), the ring's window decodes included),
# sketches_small (http_small), sketches_ring (http_small_ring, built with
# resident ingest on), sketches_mesh4 (a 4-shard mesh of the card) warm,
# shared_scan (three concurrent runs a turn: their walls); "kernels": H3,
# H8 and the t-digest update at their path shapes, one median each. The
# child runs the other tree's chip_smoke.py, so it calls only helpers that
# tree has.
AB_PATHS = ("service_stats", "sketches", "reservoir_latency", "flows", "flow_span",
            "reservoir_flows", "flow_window", "ring_build", "svc_let", "endpoint_load",
            "path_embeddings", "mesh_d1", "sketches_small", "sketches_ring", "sketches_mesh4",
            "shared_scan", "kernels")
AB_PATHS_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from pixie_tpu_torch.ops import kernels
kernels.library()
paths, reps = %r, %d
out = {}
def timed(c, q, cold, now_ns=None):
    if cold:
        c.device_executor.clear_caches()
    torch.cuda.synchronize()
    t = time.perf_counter(); c.execute_query(q, now_ns=now_ns); torch.cuda.synchronize()
    return time.perf_counter() - t
def warm(c, name, q, now_ns=None):
    if name in paths:
        timed(c, q, True, now_ns)
        out[name] = [timed(c, q, False, now_ns) for _ in range(reps)]
if {"service_stats", "sketches", "reservoir_latency", "sketches_mesh4",
        "shared_scan"} & set(paths):
    data = cs.http_events(1 << 26)
    c = cs.build_carnot(data, 1 << 26, "cuda")
    warm(c, "service_stats", cs.SERVICE_STATS)
    warm(c, "sketches", cs.SKETCHES)
    warm(c, "reservoir_latency", cs.RESERVOIR_LATENCY)
    if "sketches_mesh4" in paths:
        m4 = cs.mesh_carnot(c, f"d:{cs.TREE_SHARDS}", cs.TREE_SHARDS)
        warm(m4, "sketches_mesh4", cs.SKETCHES)
        del m4
    if "shared_scan" in paths:
        out["shared_scan"] = [cs.shared_scan_path(c, data, False)["wall"] for _ in range(3)]
    del c, data
if {"svc_let", "endpoint_load", "path_embeddings"} & set(paths):
    c = cs.build_let_carnot(cs.let_events(cs.LET_ROWS), cs.LET_ROWS, "cuda")
    queries = cs.let_queries()
    warm(c, "svc_let", queries["let"], cs.LET_NOW)
    warm(c, "endpoint_load", queries["load"], cs.LET_NOW)
    warm(c, "path_embeddings", cs.PATH_EMBEDDINGS)
    del c
if {"flows", "flow_span", "reservoir_flows", "flow_window"} & set(paths):
    f = cs.build_flows_carnot(cs.conn_flows(cs.FLOW_ROWS), cs.FLOW_ROWS, "cuda")
    warm(f, "flows", cs.FLOWS)
    warm(f, "flow_span", cs.FLOW_SPAN)
    if "reservoir_flows" in paths:
        timed(f, cs.RESERVOIR_FLOWS, True)
        out["reservoir_flows"] = [timed(f, cs.RESERVOIR_FLOWS, False) for _ in range(reps)]
    if "flow_window" in paths:
        out["flow_window"] = [timed(f, cs.FLOW_WINDOW, True) for _ in range(3)]
    del f
if "mesh_d1" in paths:
    c = cs.build_mesh_carnot(cs.mesh_table(cs.MESH_ROWS), cs.MESH_ROWS, "cuda")
    warm(c, "mesh_d1", cs.MESH_QUERY)
    del c
if "ring_build" in paths:
    from pixie_tpu_torch.engine import Carnot
    from pixie_tpu_torch.parallel import DeviceExecutor
    from pixie_tpu_torch.utils import flags
    hs = cs.http_small(cs.SMALL_ROWS)
    flags.set("resident_ingest", True)
    c = Carnot(device_executor=DeviceExecutor(device="cuda", block_rows=cs.BLOCK_ROWS))
    out["ring_build"] = [cs.build_small_table(c, "http_small_ring", hs, cs.SMALL_ROWS)]
if {"sketches_small", "sketches_ring"} & set(paths):
    hs = cs.http_small(cs.SMALL_ROWS)
    c, _ = cs.build_small_carnot(hs, cs.SMALL_ROWS, "cuda")
    warm(c, "sketches_small", cs.SKETCHES.replace("'http_events'", "'http_small'"))
    if "sketches_ring" in paths:
        from pixie_tpu_torch.utils import flags
        flags.set("resident_ingest", True)
        cs.build_small_table(c, "http_small_ring", hs, cs.SMALL_ROWS)
        warm(c, "sketches_ring", cs.SKETCHES_RING)
    del c, hs
if "kernels" in paths:
    # H3, H8 and the t-digest update through the calls both trees take, at
    # their path shapes, each its own median of 30 calls: H3 at
    # service_stats' block (2^21 f32 rows, 16 groups, a mask), H8 at
    # sketches' (a digest of 16 groups and a block's f64 sums) and the
    # whole t-digest update (H7 and H8) at sketches' block (f64 latency).
    import math
    import numpy as np
    from pixie_tpu_torch.ops import histogram, tdigest
    rng, n, dev = np.random.default_rng(0), cs.BLOCK_ROWS, torch.device("cuda")
    mask = torch.from_numpy(rng.random(n) < 0.97).to(dev)
    lat = torch.from_numpy(rng.exponential(3e7, n)).to(dev)
    g16 = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(dev)
    spec, st = histogram.DEFAULT_SPEC, histogram.init(16, dev)
    lat32 = lat.float()
    out["kernels:H3 S=16"] = [cs.time_ms(lambda: kernels.log_histogram_update(
        lat32, g16, mask, st, spec.min_value, math.log(spec.gamma)))]
    td = tdigest.update(tdigest.init(16, dev), g16, lat, mask)
    sums = kernels.tdigest_update_sums(lat, g16, mask, 16, tdigest.DEFAULT_CAPACITY)
    out["kernels:H8 G=16"] = [cs.time_ms(lambda: kernels.tdigest_merge(
        td["means"], td["weights"], sums[0], sums[1], raw_b=True))]
    out["kernels:tdigest update G=16"] = [
        cs.time_ms(lambda: tdigest.update(td, g16, lat, mask))]
print("RESULT " + json.dumps(out), flush=True)
"""


def ab_paths(parent: str, pairs: int, paths: list, reps: int = 15) -> dict:
    """``--ab-parent DIR --ab-paths ...``: the named paths of AB_PATHS in
    ``parent``'s tree and in this one (``ab_turns``); a warm path times
    ``reps`` warm queries a turn, flow_window three cold ones, ring_build
    one build, kernels one median of 30 calls each. Per path: each side's
    turn medians, the change's wins and the change minus the parent's
    median of turn medians, with the parent's own spread (its largest turn
    median less its smallest)."""
    turns = ab_turns(parent, pairs, AB_PATHS_CHILD % (tuple(paths), reps))
    out = {}
    for name in turns["change"][0]:
        med = {tag: [float(np.median(t[name])) for t in turns[tag]] for tag in turns}
        out[name] = dict(
            parent=med["parent"], change=med["change"],
            change_wins=sum(c < p for c, p in zip(med["change"], med["parent"])),
            delta=float(np.median(med["change"]) - np.median(med["parent"])),
            parent_spread=max(med["parent"]) - min(med["parent"]),
        )
        log(f"ab {name}: parent {np.median(med['parent']):.5f} [{min(med['parent']):.5f}, "
            f"{max(med['parent']):.5f}], change {np.median(med['change']):.5f} "
            f"[{min(med['change']):.5f}, {max(med['change']):.5f}]; change wins "
            f"{out[name]['change_wins']} of {pairs}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 26,
                    help="http_events rows (bench.py's full scale is 256000000)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm query of each path with torch.profiler "
                         "and print its device time by op")
    ap.add_argument("--mesh-cards", type=int, default=0,
                    help="run only config 10 over this many real cards against the same "
                         "geometry over logical shards of card 0 (needs that many cards)")
    ap.add_argument("--ab-parent", default="",
                    help="run only config 10's d:1 and 8-shard widths, this directory's tree "
                         "against this one's in turns (a checkout of another commit)")
    ap.add_argument("--ab-pairs", type=int, default=10, help="pairs of --ab-parent turns")
    ap.add_argument("--ab-paths", default="",
                    help="with --ab-parent: a comma list of " + ", ".join(AB_PATHS)
                         + " to compare instead of config 10's widths")
    ap.add_argument("--ab-reps", type=int, default=15,
                    help="with --ab-paths: warm queries a turn of a warm path")
    ap.add_argument("--log-shapes", default="",
                    help="also record the shape of every H4, H9, H10, H12, H16 and H18 launch "
                         "of each main path and write them to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if args.ab_parent:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi_line()}")
        if args.ab_paths:
            paths = args.ab_paths.split(",")
            check(set(paths) <= set(AB_PATHS), f"--ab-paths: {paths} not in {AB_PATHS}")
            log("ab: " + json.dumps(ab_paths(args.ab_parent, args.ab_pairs, paths,
                                             args.ab_reps)))
        else:
            log("ab: " + json.dumps(ab_widths(args.ab_parent, args.ab_pairs)))
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    from pixie_tpu_torch.ops import histogram, kernels, segment

    t_start = time.perf_counter()
    phase_s: dict = {}
    dev = torch.device(CARD)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'cached' if kernels.BUILD_INFO['cached'] else 'nvcc'}) -> {kernels.BUILD_INFO['path']}")
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"opt-in shared memory per block: {kernels.smem_optin_bytes(dev)} B")
    phase_s["build"] = time.perf_counter() - t0
    if args.mesh_cards:
        sweep = mesh_cards_sweep(args.mesh_cards)
        log(f"mesh cards sweep: {json.dumps(sweep)}; {time.perf_counter() - t_start:.1f} s")
        mesh_cards_paths(args.mesh_cards, {}, phase_s)
        log(f"mesh cards joins and chaos: {time.perf_counter() - t_start:.1f} s")
        ring_mesh_cards(args.mesh_cards)
        log(f"mesh cards ring: {time.perf_counter() - t_start:.1f} s")
        # The PEM split with its two PEMs on two cards, the Kelvin on card 0.
        split_paths: dict = {}
        pem_split_paths(http_events(args.rows), args.rows, split_paths, phase_s,
                        devices=("cuda:0", "cuda:1", "cuda:0"))
        for name, p in split_paths.items():
            log(f"{name} over cuda:0 and cuda:1: cold {p['cold']:.3f} s, warm "
                f"{[round(w, 4) for w in p['warm']]} s; launches "
                f"{ {k: v for k, v in p['launches'].items() if v} }")
        log(f"mesh cards PEM split: {time.perf_counter() - t_start:.1f} s")
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return 0

    t0 = time.perf_counter()
    records = kernel_phases(kernels, segment, histogram, dev)
    records.update(sketch_kernel_phases(dev))
    records.update(minmax_kernel_phase(dev))
    records.update(scan_kernel_phase(dev))
    records.update(join_kernel_phase(dev))
    records["scan_compact"]["by_join_unmatched"] = {
        k: v for k, v in records.pop("scan_compact_unmatched").items() if k != "host_paced_ms"}
    records.update(join_agg_kernel_phase(dev))
    records.update(scalar_kernel_phase(dev))
    records.update(codec_kernel_phase(dev))
    records.update(cell_kernel_phase(dev))
    records.update(batch_kernel_phase(dev))
    records.update(ring_kernel_phase(dev))
    records.update(ml_kernel_phase(dev))
    records.update(merge_kernel_phase(dev))
    records.update(uncalled_kernel_phase(dev))
    rate = copy_rate(dev)
    log(f"1 GiB device-to-device copy: {rate / 1e9:.1f} GB/s (read + write)")
    phase_s["kernels"] = time.perf_counter() - t0

    paths = {}
    if args.log_shapes:
        log_launch_shapes(kernels)
    t0 = time.perf_counter()
    slice_parity(1 << 20)
    paths["sorted_keys"] = sorted_path(SORTED_ROWS)
    phase_s["slice_parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = http_events(args.rows)
    carnot = build_carnot(data, args.rows, CARD)
    log(f"http_events: {args.rows} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_s["http_events_table"] = time.perf_counter() - t0

    # ---- the main paths: counts from zero before each, read after it
    t0 = time.perf_counter()
    paths["service_stats"] = drive(
        carnot, SERVICE_STATS, lambda r: verify(r, data, args.rows),
        ("segment_rows_sum_i64", "log_histogram_update", "hist_quantiles",
         "scalar_eval"),  # H17: mean(resp_status >= 400)
    )
    # count's presence row and the mean's bool predicate in one H1 launch a
    # block, the mean's count that presence row: no H2, no second H1.
    got = {k: paths["service_stats"]["launches"][k]
           for k in ("segment_rows_sum_i64", "segment_rows_sum_f64")}
    want = {"segment_rows_sum_i64": (1 + WARM_QUERIES) * -(-args.rows // BLOCK_ROWS),
            "segment_rows_sum_f64": 0}
    check(got == want, f"service_stats: launches {got}, expected {want}")
    phase_s["service_stats"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # count_min(resp_status) takes the int-dictionary cell lane (H21): no
    # hash kernel, no H6.
    paths["sketches"] = drive(
        carnot, SKETCHES, lambda r: verify_sketches(r, data, args.rows), SKETCH_KERNELS,
    )
    check(paths["sketches"]["lanes"].get("cell_lane") == 1 + WARM_QUERIES
          and paths["sketches"]["launches"]["countmin_update"] == 0
          and paths["sketches"]["launches"]["hash32"] == 0,
          f"sketches: count_min(resp_status) left the cell lane: {paths['sketches']['lanes']}")
    phase_s["sketches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["status_mix"] = drive(
        carnot, STATUS_MIX, lambda r: verify_status_mix(r, data),
        ("segment_rows_sum_i64", "hll_cell_update", "countmin_cell_update", "hll_estimate"),
    )
    check(paths["status_mix"]["launches"]["hll_update"] == 0
          and paths["status_mix"]["launches"]["countmin_update"] == 0,
          "status_mix: a sketch took its row path")
    phase_s["status_mix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lat_truth = latency_sample_truth(data)
    log(f"reservoir_latency truths in {time.perf_counter() - t0:.1f} s")
    paths["reservoir_latency"] = drive(
        carnot, RESERVOIR_LATENCY, lambda r: verify_reservoir_latency(r, data, lat_truth),
        ("reservoir_priority", "reservoir_topk_rows", "segment_rows_sum_i64"),
    )
    check(paths["reservoir_latency"]["launches"]["reservoir_topk"] == 0,
          "reservoir_latency: an update of 16 groups took the bucketed entry")
    phase_s["reservoir_latency"] = time.perf_counter() - t0
    tree_merge_paths(carnot, data, paths, phase_s, args.profile)
    t0 = time.perf_counter()
    shared = shared_scan_path(carnot, data, args.profile)
    phase_s["shared_scan"] = time.perf_counter() - t0
    win_carnot = windowed_paths(data, args.rows, paths, phase_s)
    pems, kelvin = pem_split_paths(data, args.rows, paths, phase_s)

    t0 = time.perf_counter()
    fl = conn_flows(FLOW_ROWS)
    flows = build_flows_carnot(fl, FLOW_ROWS, CARD)
    log(f"conn_flows: {FLOW_ROWS} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_s["conn_flows_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["flows"] = drive(
        flows, FLOWS, lambda r: verify_flows(r, fl, FLOW_ROWS),
        ("segment_rows_sum_i64", "hll_update", "hll_estimate"),
    )
    phase_s["flows"] = time.perf_counter() - t0
    log(f"flows distinct ports vs truth: max rel err {fl['ports_rel'][0]:.4f}, "
        f"mean {fl['ports_rel'][1]:.4f}")
    t0 = time.perf_counter()
    flow_extremes(fl)
    paths["flow_span"] = drive(
        flows, FLOW_SPAN, lambda r: verify_flow_span(r, fl), ("segment_minmax",)
    )
    phase_s["flow_span"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["flow_window"] = drive(
        flows, FLOW_WINDOW, verify_flow_window, ("codec_delta_decode", "segment_minmax")
    )
    phase_s["flow_window"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flow_truth = flows_sample_truth(fl)
    log(f"reservoir_flows truths in {time.perf_counter() - t0:.1f} s")
    paths["reservoir_flows"] = drive(
        flows, RESERVOIR_FLOWS, lambda r: verify_reservoir_flows(r, flow_truth),
        ("reservoir_priority", "reservoir_topk", "scalar_eval"),
    )
    check(paths["reservoir_flows"]["launches"]["reservoir_topk_rows"] == 0,
          "reservoir_flows: an update of 4096 groups took the sort-free entry")
    phase_s["reservoir_flows"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hs = http_small(SMALL_ROWS)
    small, small_build_s = build_small_carnot(hs, SMALL_ROWS, CARD)
    log(f"http_small: {SMALL_ROWS} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s (the table's build {small_build_s:.3f} s)")
    phase_s["http_small_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["http_data"] = drive(  # the scan stages in one piece (with the codec)
        small, HTTP_DATA, lambda r: verify_http_data(r, hs), ("scan_compact", "scalar_eval"),
        streamed=False,
    )
    phase_s["http_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small_truth = small_truths(hs)
    paths["sketches_small"] = drive(
        small, SKETCHES.replace("'http_events'", "'http_small'"),
        lambda r: verify_sketches(r, small_truth, SMALL_ROWS), SKETCH_KERNELS,
    )
    check(paths["sketches_small"]["lanes"].get("cell_lane") == 1 + WARM_QUERIES,
          f"sketches_small: lanes {paths['sketches_small']['lanes']}")
    phase_s["sketches_small"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring_launches = ring_paths(small, hs, small_truth, small_build_s, paths)
    phase_s["ring_paths"] = time.perf_counter() - t0
    ring_mesh_launches, ring_mesh, ring_chaos = ring_mesh_paths(hs, small_truth, paths, phase_s,
                                                                args.profile)

    t0 = time.perf_counter()
    st = stacks(SMALL_ROWS)
    stack_carnot = build_stacks_carnot(st, SMALL_ROWS, CARD)
    log(f"stacks: {SMALL_ROWS} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_s["stacks_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["flamegraph"] = drive(
        stack_carnot, FLAMEGRAPH, lambda r: verify_flamegraph(r, st),
        ("segment_rows_sum_i64",),
    )
    phase_s["flamegraph"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    jf = join_fact(JOIN_ROWS)
    join_carnot = build_join_carnot(jf, JOIN_ROWS, CARD)
    log(f"join_fact: {JOIN_ROWS} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_s["join_tables"] = time.perf_counter() - t0
    join_kernels = ("join_probe", "join_emit_pairs", "join_gather")
    for name, query, verify_fn, expect in (
        ("join8", JOIN8, verify_join8, join_kernels),
        ("join8_outer", JOIN8_OUTER, verify_join8_outer, join_kernels + ("scan_compact",)),
    ):
        t0 = time.perf_counter()
        paths[name] = drive(join_carnot, query, lambda r, f=verify_fn: f(r, jf), expect,
                            streamed=False)
        lanes = paths[name]["lanes"]
        check(lanes.get("join_sort_merge") == 1 + WARM_QUERIES,
              f"{name}: lanes {lanes}, expected join_sort_merge on every query")
        phase_s[name] = time.perf_counter() - t0
    truth = join_fact_truth(jf)
    host_agg = ("segment_rows_sum_i64", "segment_rows_sum_f64", "segment_minmax")
    for name, query, verify_fn, expect, lane in (
        ("join8_team_agg", JOIN8_TEAM_AGG, verify_join8_team_agg,
         host_agg + ("join_agg_fold",), "join_agg"),
        ("join8_oncall_agg", JOIN8_ONCALL_AGG, verify_join8_oncall_agg,
         host_agg + ("join_agg_fold",), "join_agg"),
        # The host AggNode's kernels (H1, H2, H11) prove it ran on the card.
        ("join8_left_agg", JOIN8_LEFT_AGG, verify_join8_left_agg,
         join_kernels + ("scan_compact",) + host_agg, "join_sort_merge"),
    ):
        t0 = time.perf_counter()
        paths[name] = drive(join_carnot, query, lambda r, f=verify_fn: f(r, truth), expect,
                            streamed=False)
        lanes = paths[name]["lanes"]
        check(lanes == {lane: 1 + WARM_QUERIES},
              f"{name}: lanes {lanes}, expected only {lane} on every query")
        phase_s[name] = time.perf_counter() - t0
    mesh_join = mesh_join_paths(join_carnot, jf, paths, phase_s)
    pushdown = join8_pushdown_paths(join_carnot, jf, paths, phase_s, args.profile)

    t0 = time.perf_counter()
    ev = let_events(LET_ROWS)
    let_carnot = build_let_carnot(ev, LET_ROWS, CARD)
    log(f"let http_events: {LET_ROWS} rows generated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    truth = let_truth(ev)
    path_counts = np.bincount(ev["path"], minlength=N_PATHS + 2)
    del ev
    log(f"let truths in {time.perf_counter() - t1:.1f} s")
    phase_s["let_table"] = time.perf_counter() - t0
    queries = let_queries()
    fold = ("scalar_eval", "segment_rows_sum_i64")
    for name, table, verify_fn, expect, lanes_want in (
        ("svc_let", "let", verify_q1,
         fold + ("log_histogram_update", "hist_quantiles"),
         {"fold_key_host": 1 + WARM_QUERIES, "stage_stream": 1}),
        ("code_histogram", "codes", verify_q2, fold,
         {"fold_key_host": 1 + WARM_QUERIES, "stage_stream": 1}),
        ("latency_histogram", "lat_hist", verify_q3, fold,
         {"fold_key_host": 1 + WARM_QUERIES, "stage_stream": 1}),
        ("endpoint_load", "load", verify_q4,
         fold + ("segment_rows_sum_f64", "hll_update", "hll_estimate", "countmin_update"),
         {"fold_key_lut": 1 + WARM_QUERIES, "arghash": 1 + WARM_QUERIES, "stage_stream": 1}),
    ):
        t0 = time.perf_counter()
        paths[name] = drive(let_carnot, queries[table], lambda r, f=verify_fn: f(r, truth),
                            expect, now_ns=LET_NOW)
        lanes = paths[name]["lanes"]
        check(lanes == lanes_want, f"{name}: lanes {lanes}, expected {lanes_want}")
        phase_s[name] = time.perf_counter() - t0
    # One int launch (H1) a block on each let path, and endpoint_load's f64
    # rows (stddev's and variance's shared latency and its squares,
    # mean(log_lat)) one f64 launch (H2) a block beside it; svc_let's mean of
    # its bool predicate rides the int launch: no H2.
    let_blocks = (1 + WARM_QUERIES) * -(-LET_ROWS // BLOCK_ROWS)
    for name, h2 in (("svc_let", 0), ("endpoint_load", let_blocks)):
        got = {k: paths[name]["launches"][k] for k in ("segment_rows_sum_i64",
                                                       "segment_rows_sum_f64")}
        check(got == {"segment_rows_sum_i64": let_blocks, "segment_rows_sum_f64": h2},
              f"{name}: launches {got}, expected {let_blocks} H1 and {h2} H2")
    t0 = time.perf_counter()
    emb_truth = path_embedding_truth(dev)
    paths["path_embeddings"] = drive(
        let_carnot, PATH_EMBEDDINGS,
        lambda r: verify_path_embeddings(r, path_counts, emb_truth),
        ("segment_rows_sum_i64", "encoder_forward", "kmeans_fit"),
    )
    phase_s["path_embeddings"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    km = km_embeddings(KM_ROWS)
    km_carnot = build_km_carnot(km, KM_ROWS, CARD)
    log(f"embeddings: {KM_ROWS} rows generated and written in {time.perf_counter() - t0:.1f} s")
    paths["kmeans_services"] = drive(  # a host aggregation: the AggNode, H27 at finalize
        km_carnot, KMEANS_SERVICES, lambda r: verify_kmeans_services(r, km), ("kmeans_fit",),
        streamed=False, offloaded=False,
    )
    paths["kmeans_predict"] = drive(
        km_carnot, kmeans_predict_query(km["model"]), lambda r: verify_kmeans_predict(r, km),
        ("segment_rows_sum_i64",),
    )
    phase_s["kmeans_services"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mb = mesh_table(MESH_ROWS)
    phase_s["mesh_truths"] = time.perf_counter() - t0
    mesh = mesh_paths(mb, paths, phase_s)
    t0 = time.perf_counter()
    chaos = mesh_chaos(mesh_table(CHAOS_ROWS, seed=23))
    chaos.pop("recovered")
    phase_s["mesh_chaos"] = time.perf_counter() - t0

    n_queries = 1 + WARM_QUERIES
    rows_of = {"service_stats": args.rows, "sketches": args.rows, "status_mix": args.rows,
               "flows": FLOW_ROWS, "flow_span": FLOW_ROWS, "flow_window": FLOW_ROWS,
               "sorted_keys": SORTED_ROWS, "http_data": SMALL_ROWS, "flamegraph": SMALL_ROWS,
               "join8": JOIN_ROWS, "join8_outer": JOIN_ROWS, "join8_team_agg": JOIN_ROWS,
               "join8_oncall_agg": JOIN_ROWS, "join8_left_agg": JOIN_ROWS,
               "svc_let": LET_ROWS, "code_histogram": LET_ROWS, "latency_histogram": LET_ROWS,
               "endpoint_load": LET_ROWS, "sketches_small": SMALL_ROWS,
               "http_data_ring": SMALL_ROWS, "sketches_ring": SMALL_ROWS,
               "reservoir_latency": args.rows, "reservoir_flows": FLOW_ROWS,
               "path_embeddings": LET_ROWS, "kmeans_services": KM_ROWS,
               "kmeans_predict": KM_ROWS, "sketches_mesh4": args.rows,
               "reservoir_mesh4": args.rows, "svc_windowed": args.rows,
               "sketches_windowed": args.rows, "svc_pem_split": args.rows,
               "sketches_pem_split": args.rows,
               **{"mesh_" + spec.replace(":", "").replace(",", "_"): MESH_ROWS
                  for spec in ("d:1",) + MESH_WIDTHS},
               **{name: JOIN_ROWS for name in mesh_join},
               **{f"{name}{sfx}": JOIN_ROWS for name in pushdown for sfx in ("", "_hosts2_d4")},
               **{f"ring_mesh_{spec.replace(':', '').replace(',', '_')}_{q}": SMALL_ROWS
                  for spec in RING_MESH_SPECS for q in ("http_data", "sketches")}}
    for name, p in paths.items():
        best = min(p["warm"])
        cp = p["cold_phases"]
        log(f"{name} cold {p['cold']:.3f} s "
            f"{json.dumps({k: round(v, 3) for k, v in cp.items()})}")
        if cp.get("stage_bytes"):
            log(f"{name} cold staging: {int(cp.get('stream_windows', 0))} stream windows, "
                f"stage_stream_pack_wait {cp.get('stage_stream_pack_wait', 0.0):.3f} s, "
                f"stage_stream_put {cp.get('stage_stream_put', 0.0):.3f} s, stage_encode "
                f"{cp.get('stage_encode', 0.0):.3f} s, stage_decode "
                f"{cp.get('stage_decode', 0.0):.3f} s, wire_bytes / stage_bytes = "
                f"{cp.get('wire_bytes', 0.0) / cp['stage_bytes']:.4f} "
                f"({int(cp.get('wire_bytes', 0))} / {int(cp['stage_bytes'])})")
        log(f"{name} warm {[round(w, 4) for w in p['warm']]} s; best {best:.4f} s = "
            f"{rows_of[name] / best:.4g} rows/s on {smi}")
        log(f"{name} launches over {n_queries} queries: "
            f"{ {k: v for k, v in p['launches'].items() if v} }; per query: "
            f"{ {k: v / n_queries for k, v in p['launches'].items() if v} }")
    if args.log_shapes:
        shapes = {name: p["shapes"] for name, p in {**paths, "shared_scan": shared}.items()
                  if p.get("shapes")}
        with open(args.log_shapes, "w") as f:
            json.dump(shapes, f, indent=1)
        log(f"H4, H9, H10, H12, H16 and H18 launch shapes by path: {json.dumps(shapes)}")
    launches = {k: sum(p["launches"][k] for p in paths.values()) + shared["launches"][k]
                + ring_launches[k] + ring_mesh_launches[k] for k in kernels.KERNELS}
    for name, count in launches.items():
        if name in UNCALLED:
            check(count == 0, f"kernel {name} has no caller but launched {count} times")
        else:
            check(count > 0, f"kernel {name} was not launched on the main paths")

    if args.profile:
        profile_warm(carnot, SERVICE_STATS, min(paths["service_stats"]["warm"]))
        profile_warm(carnot, SKETCHES, min(paths["sketches"]["warm"]))
        profile_warm(flows, FLOWS, min(paths["flows"]["warm"]))
        profile_warm(flows, FLOW_SPAN, min(paths["flow_span"]["warm"]))
        profile_warm(flows, FLOW_WINDOW, min(paths["flow_window"]["warm"]), "flow_window")
        profile_warm(carnot, STATUS_MIX, min(paths["status_mix"]["warm"]), "status_mix")
        profile_warm(small, HTTP_DATA, min(paths["http_data"]["warm"]))
        for name, query in (("sketches_small", SKETCHES.replace("'http_events'", "'http_small'")),
                            ("http_data_ring", HTTP_DATA_RING), ("sketches_ring", SKETCHES_RING)):
            profile_warm(small, query, min(paths[name]["warm"]), name)
        profile_warm(stack_carnot, FLAMEGRAPH, min(paths["flamegraph"]["warm"]))
        profile_warm(join_carnot, JOIN8, min(paths["join8"]["warm"]))
        profile_warm(join_carnot, JOIN8_OUTER, min(paths["join8_outer"]["warm"]))
        for name, query in (("join8_team_agg", JOIN8_TEAM_AGG),
                            ("join8_oncall_agg", JOIN8_ONCALL_AGG),
                            ("join8_left_agg", JOIN8_LEFT_AGG)):
            profile_warm(join_carnot, query, min(paths[name]["warm"]), name)
        for name, table in (("svc_let", "let"), ("code_histogram", "codes"),
                            ("latency_histogram", "lat_hist"), ("endpoint_load", "load")):
            profile_warm(let_carnot, queries[table], min(paths[name]["warm"]), name,
                         now_ns=LET_NOW)
        for name, query in (("svc_windowed", SERVICE_STATS), ("sketches_windowed", SKETCHES)):
            profile_warm(win_carnot, query, min(paths[name]["warm"]), name,
                         run=lambda q=query: win_carnot.execute_plan(windowed_plan(win_carnot, q)))
        for name, query in (("svc_pem_split", SERVICE_STATS), ("sketches_pem_split", SKETCHES)):
            profile_warm(kelvin, query, min(paths[name]["warm"]), name,
                         run=lambda q=query: split_query(pems, kelvin, q))
        for name, c, query in (
            ("reservoir_latency", carnot, RESERVOIR_LATENCY),
            ("reservoir_flows", flows, RESERVOIR_FLOWS),
            ("path_embeddings", let_carnot, PATH_EMBEDDINGS),
            ("kmeans_services", km_carnot, KMEANS_SERVICES),
            ("kmeans_predict", km_carnot, kmeans_predict_query(km["model"])),
        ):
            profile_warm(c, query, min(paths[name]["warm"]), name)

    log(f"mesh sweep (config 10, {MESH_ROWS} rows, {MESH_SHARDS} logical shards of the card): "
        f"{json.dumps(mesh)}")
    log(f"mesh joins (config 8, {JOIN_ROWS} fact rows, {MESH_SHARDS} logical shards of the "
        f"card): {json.dumps(mesh_join)}")
    log(f"mesh chaos (config 12, {CHAOS_ROWS} rows, {CHAOS_SPEC} over {MESH_SHARDS} logical "
        f"shards of the card): {json.dumps(chaos)}")
    log(f"ring mesh (http_small, {SMALL_ROWS} rows, {RING_WINDOWS} windows of {RING_WINDOW_ROWS} "
        f"rows over {MESH_SHARDS} logical shards of the card): {json.dumps(ring_mesh)}; chaos "
        f"{json.dumps(ring_chaos)}")
    log(f"join pushdown (config 8, {JOIN_ROWS} fact rows): {json.dumps(pushdown)}")
    phase_s["total"] = time.perf_counter() - t_start
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    out = []
    for name in kernels.KERNELS:
        r = records[name]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "host_paced_ms": r["host_paced_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "copy_bound_ms": r["bound_ms"] * HBM_BYTES_PER_S / rate
            if r["bound_by"] == "bytes" else None,
            **{k: v for k, v in r.items()
               if k.startswith(("b_", "by_", "torch_tree", "log10", "library_ms_", "sequence",
                                "sort_ms", "block_", "floor_"))},
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_warm(carnot, query: str, warm_best: float, name: str = "", now_ns=None,
                 run=None) -> None:
    """One warm query under torch.profiler (after one unprofiled query, which
    restages what a later path's cold query dropped): device time by op,
    and the device's busy time as a share of the profiled wall and of the
    best unprofiled warm query, and the host time beside it (the wall less
    the busy time). ``run`` runs the query (default: ``carnot``'s
    ``execute_query``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = run or (lambda: carnot.execute_query(query, now_ns=now_ns))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device events only: CPU ops also carry their kernels' device time.
    device_us = sum(
        e.self_device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    busy = device_us / 1e6
    log(f"profile {name or query.splitlines()[-1]}: device busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}% of the profiled wall {wall:.4f} s, "
        f"{100 * busy / warm_best:.1f}% of the best warm query {warm_best:.4f} s; host "
        f"{wall - busy:.4f} s")
    log(table)


if __name__ == "__main__":
    sys.exit(main())
