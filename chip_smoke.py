#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``weaviate_tpu_torch``) on one
NVIDIA card.

Run from the repository root:
    python3 chip_smoke.py [--seed N] [--rows N] [--hybrid-docs N]
    python3 chip_smoke.py --topk-times   # phases 0-1 and the selection timings only
    python3 chip_smoke.py --dist-times   # phases 0-1, distance_block, pq4_scan_reduce
                                         # and one approx batch, timed only
    python3 chip_smoke.py --bq-times     # phases 0-1, bq_scan_reduce at B = 1 / 8 /
                                         # 64 / 256, the prefix, the single-bit probe
    python3 chip_smoke.py --block-times  # phases 0-1, bq_hamming_block, bq_mxu_block,
                                         # pq4_recon_block, pq4_lut_block and bm25_block
                                         # checked and timed, the hybrid dispatch split
    python3 chip_smoke.py --import-times # phases 0-1, the FiQA-sized text import and a
                                         # 100,000-row vector batch_put with the native
                                         # host library, without it, and with it again
    python3 chip_smoke.py --ann-only [--ann-rows N]  # phases 0-1 and 11 only
    python3 chip_smoke.py --mesh-only [--rows N]     # phases 0-1 and 12 only
    python3 chip_smoke.py --tenants-only             # phases 0-1 and 13 at 1,000 tenants
    python3 chip_smoke.py --cluster-only [--rows N]  # phases 0-1 and 14 at 1,000,000 rows
    python3 chip_smoke.py --replication-only [--rows N]  # phases 0-1 and 15 at 500,000 rows
    python3 chip_smoke.py --chaos-only [--rows N]    # phases 0-1 and 16, 16c at 100,000 rows

It drives the port's flat nearVector path at VectorDBBench's
Performance768D1M case (Cohere wiki-22-12: 1,000,000 x 768, cosine,
top-k 100), with clustered Gaussian vectors made from ``--seed`` (nothing
is downloaded), in phases:

0. card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build: compiles every kernel in weaviate_tpu_torch/csrc with nvcc and
   prints each one's registers, shared memory and spills, and the
   residency (CTAs per SM) of the two selection kernels; beside them it
   builds the native host library (csrc/host/weaviate_native.cpp, g++)
   and fails unless it is active, so that the import phases time it;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes, with timings and bounds.
   fused_topk_scan also on the bf16 copy of the 1M-row corpus, at ragged
   shapes, under the dot metric on rows with exact zero products, and
   with its distances equal bit for bit to distance_block's at the rows
   it returns; fused_topk_pairs equal to its plain version on ties,
   +0.0 / -0.0, NaN / inf / MASKED entries, empty rows, M < k, k = 1 to
   256 and a row too wide for shared memory; both timed at the drain
   shapes (B = 1, 8, 64, 256; topk_times). distance_block also timed at
   the approx loop's group shape [256, 65536] beside addmm, and the
   grouped approx loop held bit for bit to the per-chunk loop on the card
   (filters, k past the live rows, NaN). pq4_scan_reduce also at m = 1024
   and ragged m past 896 segments. bq_scan_reduce at 17 ragged shapes (B
   past one query block, W = 1, 3, 25, 33 and 200, N = 1 and 9001, both
   layouts, with and without allow words and valid rows; W = 200 takes
   the popcount body it keeps), at the drains' B = 1, 8, 64 on the 1M-row
   words, and timed at B = 1, 8, 64, 256 and on the prefix beside the
   torch._int_mm product yardstick (bq_times). The four
   block kernels (bq_hamming_block, bq_mxu_block, pq4_lut_block,
   pq4_recon_block) at ragged shapes, then at 256 queries x the 1M-row
   corpus's sign words and 4-bit PQ codes with ~10% dead rows (and
   bq_hamming_block at HAM_CHECKS and UNALIGNED, timed beside
   torch.cdist(p=0) on the 0/1 planes and torch._int_mm), then
   bq_mxu_block at the two shapes of tools/probe_r4.py; bq_mxu_block is
   also held to bf16(exact hamming) at 768 dims and at MXU_CHECKS (W = 1,
   8, 9 and the popcount body's 200, B = 8, 129, 1,024), pq4_recon_block
   at RECON_CHECKS (ds = 1, 2, 3, 8, d off 16, codes past 15, the FFMA
   body at d = 1,024); pq4_lut_block also at
   LUT_CHECKS (ragged m up to 4,100, past the first design's cap, codes
   past 15, subnormal, -0.0 and infinite entries, dead rows). bm25_block
   at BM25_CHECKS (every term tile, T past one tile, terms outside [0,
   T), the 8-row dispatch's shape as padded to ops/bm25.GRAPH_SHAPE),
   timed from a CUDA graph. No path of the repo runs bq_hamming_block or
   pq4_recon_block: their launches are counted in this section's own
   window;
3. index: FlatIndex on the card, 1M rows, 1,024 queries through the
   async batch entry point for selection "approx" (distance_block per
   group of 8192-row chunks, fused_topk_pairs per group) and "fused" (fused_topk_scan + fused_topk_pairs),
   held to an exact plain recomputation (recall@10 / @100 must be 1.0),
   plus per-query filters (bitmask path) and a shared 0.5% filter
   (gathered path); then phase 10 (below) on its rows;
4. end to end: Database -> Collection.batch_put -> 8 client threads of
   near_vector through the shard's query batcher, held to the serial path
   and to the plain recomputation, then deletes and queries again. The
   kernels' launch counters are reset just before this phase and read
   just after it. Before that, the filter's allow words as a CUDA store
   packs them on the card are held bit for bit to numpy's packer at B =
   1, 8 and 64, each way timed; after the two selections, the approx run
   once more with the words packed on the host, as before the card
   packer (the filtered p50 before and after, in one call);
5. quantized index: the same corpus in a BQ FlatIndex, a BQ FlatIndex
   with a 128-bit sign prefix (two-stage scan) and a flat index that
   ``compress("pq")`` turns into 4-bit PQ on the card, 1,024 queries
   each at k=10 and k=100 (selection "approx") and k=10 ("fused"), plus
   per-query 10% filters; every returned id must carry its exact
   distance, deleted and disallowed ids never surface, recall@10 against
   the exact recomputation must reach the floor in RECALL_FLOOR (it also
   prints what rescore_limit 1 reads, a path without oversampling, and
   one batch's exact host rescore split into gather, distance and
   selection, as the reference arranges it and as the store does, whose
   answers must be equal bit for bit);
6. quantized end to end: ``Database.update_collection`` turns PQ on for
   phase 4's live collection and 8 client threads query it near its rows;
   then a second collection is created with BQ in its schema, loaded
   through batch_put and queried the same way. Each quantized collection
   is held to the serial path, to exact distances and to RECALL_FLOOR.

7. hybrid: a collection at the size of BEIR FiQA-2018 (Thakur et al.,
   NeurIPS 2021 Datasets and Benchmarks, Table 1: 57,638 documents,
   648 test queries, documents of 132 words and queries of 11 on
   average), ``title`` and ``text`` TEXT properties (word tokenization,
   en stopwords) and a 768-d cosine flat vector, Weaviate's BM25 defaults
   (k1 1.2, b 0.75), k=10 and the hybrid default (relativeScore, alpha
   0.75) in turn with rankedFusion at alpha 0.3 and 0.75. Deviations from
   FiQA: the text is Zipf text made from ``--seed`` (the en stopwords as
   the most frequent words), the vectors are clustered as in phase 4, the
   titles hold ~6 words (FiQA's are empty) and an int property ``n``
   carries a 10% filter. 8 client threads send (a) 648 FiQA-shaped
   queries, (b) 256 queries of the same shape whose words keep the
   candidate union within the 4,096-candidate budget, (c) (b) under
   where(n == 0) and (d) (b)'s queries with the index's selection set to
   "fused", so that the dense leg runs fused_topk_scan, each with one
   plain nearVector request per three hybrid ones on the same batcher.
   Every query of (b), (c) and (d) must take the device path (counted per
   query); every device answer is held to the host reference path
   (device_hybrid off), and every host-served query of (a) must exceed
   the budget. Then where a fused dispatch of 8 (b) rows goes
   (hybrid_split): the dense scan, the stacking, the upload and program
   on the host clock and CUDA events, and the card's memory after the
   phase (``--block-times`` sets the first design's program and the
   program's stages beside it).
8. conformance: ``kernel_conformance(device="cuda")``
   (weaviate_tpu_torch/ops/conformance.py, bench.py's sec_conformance) at
   bench's 128 dims must return "ok", and must launch every kernel in
   CONFORMANCE_KERNELS.
9. server: the port's ``Server`` serves the Database of phases 4-7 on
   127.0.0.1 (ports from the OS, no telemetry; REST and GraphQL, and gRPC
   where ``import grpc, google.protobuf`` works, else ``Server.assemble``
   without the gRPC listener, said on its line). 9a runs right after
   phase 4, before phase 6 compresses its collection: 1,024 GraphQL
   nearVector queries at limit 100 (every 4th under the 10% filter: host
   filter evaluation bounds those) from 8 client threads, and the same
   through gRPC Search, each answer equal to the in-process
   ``Collection.near_vector`` answer (ids and distance bits), then 64 of
   them under selection "fused". 9b runs after phase 7: 128 nearVector
   queries (half filtered) on each of phase 6's PQ and BQ collections and 64 hybrid queries
   on phase 7's, held to the in-process answers (hybrid under phase 7's
   tie rule), then the write path: 10,000 new 768-d objects through POST
   /v1/batch/objects in batches of 1,000, 1,000 of them (chosen by seed)
   read back with their vectors and found first by nearVector. Each half
   computes its in-process answers first, then resets the launch counters,
   runs its socket queries and reads them: 9a must launch distance_block,
   fused_topk_pairs and fused_topk_scan, 9b bm25_block, distance_block,
   bq_scan_reduce and pq4_scan_reduce. Each prints socket p50/p99/QPS
   beside the in-process numbers, the import rate and the card's name and
   power limit. 9c, right after 9a: the same gRPC queries through the
   native data plane (weaviate_tpu_torch/dataplane.py over
   csrc/host/dataplane.cpp, g++ and the system libnghttp2.so.14), served
   as the Server serves it under WEAVIATE_TPU_NATIVE_DATAPLANE=1, each
   answer equal to 9a's in-process one, at least 3/4 of them on the C++
   fast path (the filtered quarter takes the Python handlers), beside 9a's
   Python gRPC figures, then a round of the plane's native load
   generator; it must launch distance_block and fused_topk_pairs. Without
   libnghttp2.so.14 on the machine it prints that one fact (a missing
   system library, not the device or a kernel) and the run goes on.
10. epochs, right after phase 3: phase 3's rows and deletes in a
   FlatIndex cut into 8 sealed epochs (engine/epochs.py; 131,072 rows
   each at 1M rows), 256 queries at k 10 and 100, approx and fused,
   unfiltered and under per-query 10% filters, every answer bit for bit
   phase 3's single buffer's (fused_topk_pairs must merge the epochs in
   every fused dispatch); 30% of the rows of three epochs deleted,
   ``maintain()`` compacting them (their ledger bytes and
   torch.cuda.memory_allocated before and after) and the answers again;
   BQ and 4-bit PQ epoch indexes against single quantized stores on the
   same rows (one codebook), bit for bit; a 2-shard Database collection of
   200,000 rows with epoch_rows 32,768 whose shard quota makes the last
   imports migrate an epoch to the sibling, every acknowledged write held
   exactly once and read back, nearVector answers equal to an exact
   recomputation. It must launch distance_block, fused_topk_scan,
   fused_topk_pairs, bq_scan_reduce and pq4_scan_reduce. Then
   fused_topk_pairs is held to its plain version and timed at the epoch
   merge's shapes [256 / 8, 8 x k], k = 10 and 100, beside torch.topk.

11. ANN indexes, in the second process (below), at the SIFT1M row of Weaviate's published ANN
   benchmark (1,000,000 x 128, l2-squared, maxConnections 32,
   efConstruction 128, limit 10; ``--ann-rows`` cuts the depth), 1,000
   queries (half near a row, half fresh), exact answers in f64 on the
   card. 11a: ``HNSWIndex(device="cuda")`` bulk-built in one add_batch
   (the kNN graph through fused_topk_scan on a bf16 copy, the link
   selection in torch), each stage's seconds, the C++ walker at ef 64 /
   128 / 256 / 512 from 8 threads (recall@10 >= 0.95 at ef 512), 2,000
   incremental inserts and 10,000 deletes (no deleted id), a snapshot and
   restore answering identically, and a 50,000-row subset whose
   card-built graph must read recall@10 at ef 64 within 0.01 of the host
   path's; then fused_topk_scan at the build's shape against its plain
   version, addmm + topk and its bound. 11b: ``IVFIndex(nlist=1024,
   device="cuda")``, train / assign / scatter seconds, 256-query batches
   at nprobe 8 / 16 / 32 unfiltered and under 10% per-query filters (no
   deleted or disallowed id), nprobe = nlist recall 1.0, async == sync,
   5,000 delta rows each finding itself first, then ``compress("pq")``
   and the sweep again (within 0.05 of f32 IVF at nprobe 32). 11c: a
   ``vectorIndexType: "dynamic"`` collection importing 200,000 rows
   through batch_put (flat answers exact below the threshold, the
   upgrade's seconds, recall at the automatic nprobe), a maintain() tick,
   close and reopen (full-probe answers with the same ids and distances
   within 1e-6); then a Server whose REST-created hnsw class
   (maxConnections 32, efConstruction 128) imports 20,000 rows over REST
   and answers 64 GraphQL and gRPC nearVector queries identically to the
   in-process ones. 11a must launch fused_topk_scan and fused_topk_pairs,
   11b distance_block and fused_topk_pairs.

12. mesh, in the second process after phase 11: row-sharded serving (weaviate_tpu_torch/parallel) on the
   card, whose mesh repeats it: 8 row shards on cuda:0, each with its own
   tensors and its own scan, then the real merge. 12a: phase 3's corpus
   (1M x 768 cosine, 10,000 deleted) in a FlatIndex on the 8-shard 1-D
   mesh, one on the 2 x 4 ('host', 'ici') mesh and one buffer; 256-query
   batches at k 100, selections approx and fused, unfiltered, under a
   shared 50% filter and under per-query 10% filters: ids equal to the
   one buffer's and distances bit for bit (else within rtol 1e-6, said on
   the line), 1-D and two-level equal bit for bit, the 1-D mesh's
   recall@100 against the exact recomputation 1.0; the batch p50 on each
   mesh beside the one buffer's, and the shard scans' and the merge's own
   times (CUDA events). 12d: where torch.cuda.device_count() > 1 the same
   batches with one shard on each card; else a line saying it did not run
   and why. 12b: BQ (bf16 rows on the card, each shard rescoring its own
   candidates) and 4-bit PQ (host rescore) on both meshes, 256 queries
   near rows at k 10: recall@10 against the exact recomputation, every
   distance the exact one, 1-D and two-level equal bit for bit. 12c: a
   Database collection on the 2 x 4 mesh imported for 15 s through
   batch_put, the same objects in a one-buffer Database, the Server over
   the mesh database on 127.0.0.1: GraphQL (and gRPC) nearVector at limit
   100, half under the 10% filter, equal to the in-process answers, the
   in-process answers' ids equal to the one-buffer collection's; the
   /v1/debug/memory per-host rollup summing to the ledger's total. 12a
   must launch distance_block, fused_topk_scan and fused_topk_pairs, 12b
   bq_scan_reduce and pq4_scan_reduce, 12c distance_block and
   fused_topk_pairs (each counted on the mesh runs alone).

13. tenants and the device-time plane, last. 13a: a multi-tenant
   collection (768-d cosine, flat) of 200 HOT tenants of 1,000 rows
   (``--tenants-only``: 1,000 tenants), imported on 4 threads, odd
   tenants scanning with selection "fused"; tenant-scoped nearVector at
   k 10, with and without where(views >= 90), bit for bit equal to
   one-tenant collections of the same rows for 4 tenants; one tenant
   HOT -> COLD -> HOT and one HOT -> FROZEN (filesystem offload backend)
   -> HOT, the ledger and torch.cuda.memory_allocated down by the
   tenant's footprint meanwhile, a query to it refused, the answers after
   bit for bit the ones before; per-tenant bytes, the HOT tenants that
   fill the card, the import rate, the freeze and thaw times. 13b: the
   Server over the same database, 8 GraphQL clients to 50 tenants for
   2 s: the per-tenant meters sum to kernelscope's total, only queried
   tenants metered, every drain dispatch's CUDA-event residency in (0,
   its wall window], a /v1/debug/profile?ms=500 capture over the live
   traffic whose top kernel is distance_block, fused_topk_scan or
   merge_epoch_topk (not "other"), p50 / p90 of the served queries and
   the process's thread count; one driftwatch cycle over every tenant's
   canary at recall@10 1.0, /v1/debug/drift answering; a second process
   loading every kernel library from the build directory
   (compile_cache_events: all hits, no miss). The served traffic must
   launch distance_block, fused_topk_scan and fused_topk_pairs.

14. the cluster, last: three ClusterNodes in this process (node-0, node-1,
   node-2; real sockets on port 0, real gossip and Raft, every store on
   the card) hold a Performance768D1M collection (768-d cosine flat,
   desired_count 3, replication factor 1) between them. 14a imports
   through node-0's batch_put for at most 20 s (``--cluster-only``: all
   1,000,000 rows), two thirds of each batch crossing the internal
   transport, and the same sequential batches into a one-node Database
   on the same card with the same shard names (same routing, same doc
   ids). 14b: 8 GraphQL clients of nearVector k 100 (32 queries a run;
   ``--cluster-only`` 256) through node-0's REST, without and with where(views >= 90), then a few through node-1
   and node-2 and a pass under selection "fused": ids (tie-aware) and
   distances bit for bit the reference's, object_count, an aggregation
   and the batched object fetch equal, QPS / p50 / p99 beside the
   reference's over the same route; distance_block, fused_topk_pairs and
   fused_topk_scan must launch and every node's batcher must serve. 14c
   splits one traced query, stitched from the remote segments, into the
   remote hop, the owning node's batcher and kernels, and the merge, and
   prints the bytes of one remote search reply. 14d: an epoch-backed
   collection (4 sealed epochs of 2,048 rows, ``--cluster-only`` 65,536)
   whose shard on node-0 passes its quota. Each node reads its own
   shards' device bytes: while node-1 is made to read heavier than node-0
   nothing may move; then the epoch policy ships node-0's coldest sealed
   epoch to the sibling shard on node-1 over the shard RPC; every
   acknowledged write is held exactly once and the answers
   before and after are equal bit for bit. 14e: a schema write through a
   follower, timed; the leader node stops, the survivors elect within
   10 s and commit a schema write, and a nearVector through a survivor
   answers with the missing_shard marker, equal bit for bit to the
   reference restricted to the survivors' shards.

15. replication, last and alone: three ClusterNodes in this process, as in
   phase 14, hold a Performance768D1M collection (768-d cosine flat,
   desired_count 3) at replication factor 3, so every node holds every
   shard on the card; both of the phase's collections are created through
   Raft before any load. 15a imports through node-0's batch_put at QUORUM
   (each shard's batch through the 2PC coordinator) for at most 15 s
   (``--replication-only``: all --rows rows, 500,000 unless given: 1M
   did not fit its ~1,100 s), and the same batches into a
   one-node Database on the same card; rows/s beside the reference's and
   each node's store bytes (each holds the whole collection). 15b:
   nearVector k 100 through each node, unfiltered and under where(views >=
   90), then a pass under selection "fused": ids (tie-aware) and distances
   bit for bit the reference's, every read from the local replica (zero
   remote search RPCs); distance_block, fused_topk_pairs and
   fused_topk_scan must launch. 15c: node-2 cut off with faultline's
   topology: a batch at QUORUM is acknowledged, a put at ALL raises
   ConsistencyError, QUORUM get_object through node-0 reads the
   acknowledged rows; healed, hashbeat rounds on every node until every
   shard's Merkle roots are equal (rounds, rows applied, seconds),
   /v1/debug/replication reporting every shard converged, node-2's answers
   bit for bit node-0's and the reference's. 15d: a newer version of one
   object on node-0's replica only; get_object at ALL through node-2
   returns it and repairs the others; a nearVector with the old vector
   never returns the old row's distance. 15e: a factor-1 collection of
   8,192 rows (``--replication-only``: 65,536) scaled to 3 through
   node-0's update_collection (the scaler's copies, then the placement
   through Raft), rows copied a second, every node then answering locally,
   bit for bit the reference's. The nodes' hashbeat cycle is off in this
   phase (it drives the rounds itself); the launch counters are reset
   before each run through the nodes and read after it (the reference's
   runs do not count).

16. crash and chaos on the card over the port's harnesses
   (tools/crashtest_torch, tools/clusterchaos_torch); 16b and 16c last
   and alone (their elections and kills are timed). 16a, after phase 8
   while this process waits for the second one (it times no election):
   crashtest workers with ``--device cuda`` killed at
   hnsw.snap.pre_replace, hnsw.snap.post_replace and
   wal.append.post_fsync, side by side; each plan must fire and its store
   verify after the restart (no acknowledged op lost, none phantom, a
   non-empty recovery report) with the HNSW index reopened on the card.
   16b: the chaos scenarios crash_during_2pc and partition_plus_crash
   with every node's stores on cuda:0, the subprocess node's too: every
   invariant held, every event fired. 16c: a Performance768D1M collection
   (768-d cosine flat, factor 3) on three nodes, n2 a subprocess on the
   card; 20,000 rows (``--chaos-only``: 100,000) through n0's batch_put
   at QUORUM in batches of 1,000, n2 SIGKILLed at the midpoint and the
   import going on, then n2 restarted: the seconds its shards take to
   rebuild their device stores from the LSM, hashbeat rounds until every
   shard's Merkle roots are equal, every acknowledged row's digest equal
   on the three replicas and its object as written on n0 and n2 (read in
   bulk), 512 of them read back through get_object at ALL, n2's store
   bytes equal to n0's shard for shard, and 64 unfiltered, 64 filtered
   and 16 fused nearVector k 100 through n2 (``/chaos/near_vector``)
   served from its local replica (0 remote search RPCs), bit for bit n0's
   local answers (ids tie-aware); n2's launch counters
   (``/chaos/status``) must show distance_block, fused_topk_pairs and
   fused_topk_scan. 16d runs right after phase 10, on phase 3's index
   (``--chaos-only``: an index of its own with the same rows and
   deletes): FlatIndex.search_by_vector_distance of 4 queries (thresholds
   keeping about 50, 400, 3,000 and 20,000 rows, the last query under a
   50% allow list) under selections approx and fused, every row within
   the threshold as the host's recomputation finds it, none past it,
   distances within 1e-5, launching distance_block, fused_topk_pairs and
   fused_topk_scan; then EpochStore.get of 4,096 rows across five flat
   epochs equal to the rows written.

Phases 11 and 12 read nothing of phases 3 to 10, so they run in a second
process on the same card (the hidden ``--lane`` mode), started when phase
2 ends and joined after phase 8; its lines are printed when it ends, with
a line saying how long it ran beside the first. Phase 2's kernel times,
which the kernels line reports, are taken before it starts, and phases 13
to 15 after it ends; the times of phases 3 to 12 are taken with both
processes on the card and the host's cores (``--ann-only`` and
``--mesh-only`` run phases 11 and 12 alone).

Phases 5, 6, 7, 8, 9a, 9b, 9c, 10, 11, 12, 13, 14, 15, 16c and 16d each
reset the launch counters as they start and read them as they end (16c also
reads n2's own before and after its queries): every kernel in QUANT_KERNELS
must have run in phases 5 and 6, and ``bm25_block`` and ``distance_block``
in phase 7, whose run (d) must launch ``fused_topk_scan``.

It prints one line per phase, then a JSON line of per-kernel numbers, and
as its last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero without that line. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DIM = 768
METRIC = "cosine"
TOP_K = 100
ROWS = 1_000_000
BATCH = 256
QUERIES = 1024
CHUNK = 8192
ADD_BATCH = 65_536
IMPORT_BATCH = 10_000
# phase 4 cuts its row count past this: 45 s (440,000-480,000 rows on the
# card) since phase 12 joined the script, which ran 1,122 s of its 1,200 s
# with 60 s (550,000 rows; PERF.md)
IMPORT_BUDGET_S = 45.0
IMPORT_ROWS = 100_000    # --import-times' vector batch_put
# calls per client in phase 6 (CALLS) and phase 4 (PLAIN_CALLS), and phase
# 4's queries after its deletes: cut so that phase 7's FiQA-sized hybrid
# collection (whose text import takes minutes on the host) keeps the script
# within its time
CLIENTS, CALLS = 8, 32
PLAIN_CALLS = 16
VIEWS_CUT = 90           # where(views >= 90) keeps 10% of the 0..99 values
DELETES, REQUERIES = 1000, 32

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
FP32_FLOPS = 67e12
# f32 additions a second: an FADD takes the issue slot of an FMA, which
# the FP32 rate counts as two operations
FP32_ADDS = FP32_FLOPS / 2
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

RTOL, ATOL = 2e-4, 2e-3  # the reference's kernel tolerance (f32)
TIE_TOL = 1e-5           # distances closer than this are a tie
INT8_OPS = 1979e12
# single-bit products (wgmma .b1 AND-popc, bq_scan_reduce, bq_mxu_block): the guide's
# table has no such rate; one m64nNk256 b1 MMA issues at the rate of one
# m64nNk32 int8 MMA and covers 8 times its K (csrc/probes/wgmma_b1.cu,
# ``--bq-times``, NVIDIA H100 80GB HBM3 at 700 W), so 8 x the int8 peak
B1_OPS = 8 * INT8_OPS
KERNEL_SOURCES = {
    "distance_block": ("weaviate_tpu_torch/csrc/distance_block.cu",
                       "weaviate_tpu/ops/pallas_kernels.py:281"),
    "fused_topk_scan": ("weaviate_tpu_torch/csrc/fused_topk_scan.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:851"),
    "fused_topk_pairs": ("weaviate_tpu_torch/csrc/fused_topk_pairs.cu",
                         "weaviate_tpu/ops/pallas_kernels.py:992"),
    "bq_scan_reduce": ("weaviate_tpu_torch/csrc/bq_scan_reduce.cu",
                       "weaviate_tpu/ops/pallas_kernels.py:1166"),
    "pq4_scan_reduce": ("weaviate_tpu_torch/csrc/pq4_scan_reduce.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:1397"),
    "bm25_block": ("weaviate_tpu_torch/csrc/bm25_block.cu",
                   "weaviate_tpu/ops/pallas_kernels.py:1606"),
    "bq_mxu_block": ("weaviate_tpu_torch/csrc/bq_mxu_block.cu",
                     "weaviate_tpu/ops/pallas_kernels.py:417"),
    "pq4_lut_block": ("weaviate_tpu_torch/csrc/pq4_lut_block.cu",
                      "weaviate_tpu/ops/pallas_kernels.py:516"),
    "pq4_recon_block": ("weaviate_tpu_torch/csrc/pq4_recon_block.cu",
                        "weaviate_tpu/ops/pallas_kernels.py:624"),
    "bq_hamming_block": ("weaviate_tpu_torch/csrc/bq_hamming_block.cu",
                         "weaviate_tpu/ops/pallas_kernels.py:1495"),
}
# no path of the repo runs these two (the conformance entry point drives
# the other two block kernels): phase 2's block-kernel window counts them
PHASE2_PATH = ("bq_hamming_block", "pq4_recon_block")
CONFORMANCE_KERNELS = ("distance_block", "bq_mxu_block", "pq4_lut_block", "fused_topk_scan")
# bench.py's pq4 tolerance, 8e-3 * max(1, max|ref|): one bf16 ulp at the
# output's scale, for f32 sums taken in another order (pq4_recon_block)
PQ_TOL = 8e-3
PROBE_SHAPES = ((256, 48), (1024, 4))  # tools/probe_r4.py:176-177: (B, W) at 1M rows
# no single PyTorch call computes a strided block-argmin over hamming or
# LUT sums: the scan-reduce kernels have no library yardstick
NO_LIBRARY = "none: no single PyTorch call computes the function"
BQ_E2E_ROWS = 100_000
NEAR_NOISE = 0.3 / float(np.sqrt(DIM))  # noise of length 0.3 on a unit row
# recall@10 floors of the quantized paths (exact rescore of rescore_limit
# x k candidates, queries at cosine ~0.96 to a corpus row). The 1M-row runs
# on an H100 measured BQ 0.9728, BQ + prefix 0.9620, PQ4 0.8585, the PQ4
# collection 0.9744 and the BQ collection 0.9752 (PERF.md); each floor sits
# 0.06-0.08 below its reading. Phase 5 also prints what the same index
# reads with rescore_limit 1, a path that has lost its oversampling.
RECALL_FLOOR = {"bq": 0.9, "bq+prefix128": 0.9, "pq4": 0.8,
                "e2e pq4": 0.9, "e2e bq": 0.9}
# kernels each quantized phase must launch: the scans, and the pairs top-k
# that selection "fused" runs (phase 6 serves with "approx"). Neither phase
# runs distance_block or fused_topk_scan: the quantized store scans codes
# and rescores its candidates on the host
QUANT_KERNELS = {5: ("bq_scan_reduce", "pq4_scan_reduce", "fused_topk_pairs"),
                 6: ("bq_scan_reduce", "pq4_scan_reduce")}


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict = {}  # phase -> wall seconds, for the closing line


def timed(phase: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept in PHASE_SECONDS."""
    t = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[phase] = time.perf_counter() - t


# -- data ---------------------------------------------------------------------

def centers(seed: int) -> np.ndarray:
    return np.random.default_rng([seed, 1 << 40]).standard_normal(
        (1024, DIM), dtype=np.float32)


def clustered(seed: int, start: int, count: int, cent: np.ndarray) -> np.ndarray:
    """Rows [start, start + count) of the corpus: cluster centre plus
    noise of a per-row scale, so neighbours are spread, not tied."""
    rng = np.random.default_rng([seed, start])
    assign = rng.integers(0, len(cent), count)
    scale = rng.uniform(0.3, 1.2, (count, 1)).astype(np.float32)
    return cent[assign] + scale * rng.standard_normal((count, DIM), dtype=np.float32)


_CORPUS_BATCHES: dict = {}  # (seed, start, count) -> corpus_batch's rows


def corpus_batch(seed: int, start: int, count: int) -> np.ndarray:
    """``clustered(seed, start, count, centers(seed))``, made once a run:
    phases 2, 3, 5 and 12 read the same 1M-row corpus (3 GB on the host),
    which takes the host seconds to draw each time."""
    key = (seed, start, count)
    if key not in _CORPUS_BATCHES:
        _CORPUS_BATCHES[key] = clustered(seed, start, count, centers(seed))
    return _CORPUS_BATCHES[key]


def near_queries(seed: int, rows: np.ndarray, corpus_fn, noise: float = 0.3) -> np.ndarray:
    """Queries next to given corpus rows: the row plus Gaussian noise of
    ``noise`` per dimension. The corpus functions return unit rows, so
    the default (0.3 per dimension, 8x the row's length) leaves a query
    almost unrelated to its row, which an exact scan does not mind;
    the quantized phases take NEAR_NOISE, a query at cosine ~0.96 to its
    row, so that recall after a quantized scan means something."""
    rng = np.random.default_rng([seed, 1 << 41])
    base = corpus_fn(rows)
    return base + noise * rng.standard_normal(base.shape, dtype=np.float32)


# -- checks -------------------------------------------------------------------

def tie_aware_mismatches(ai, ad, bi, bd) -> int:
    """Positions where ids ``ai`` differ from the reference ``bi`` other
    than by a reordering among near-equal distances (or another member
    of a tie at the k-th place)."""
    bad = 0
    for r, p in zip(*np.nonzero(ai != bi)):
        if abs(float(ad[r, p]) - float(bd[r, p])) > TIE_TOL:
            bad += 1
            continue
        same = np.abs(bd[r] - bd[r, p]) <= TIE_TOL
        if not (ai[r, p] in bi[r][same] or abs(float(bd[r, p]) - float(bd[r, -1])) <= TIE_TOL):
            bad += 1
    return bad


def recall_at_k(exact_d_of_got, kth_d, k) -> float:
    """Mean share of the k returned ids whose exact distance is within
    TIE_TOL of the exact k-th distance (ties at the k-th place count)."""
    return float(((exact_d_of_got[:, :k] <= kth_d[:, None] + TIE_TOL).sum(1) / k).mean())


def recall(got_ids, exact_d_of_got, kth_d, k) -> float:
    """Share of the k returned ids that are true top-k: an id counts when
    its exact distance is within TIE_TOL of the exact k-th distance."""
    hits = [(len(set(g[:k].tolist())) == k
             and bool((dg[:k] <= kd + TIE_TOL).all()))
            for g, dg, kd in zip(got_ids, exact_d_of_got, kth_d)]
    return float(np.mean(hits))


class Timer:
    """Mean milliseconds of ``fn`` over ``reps`` launches, CUDA events."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bound_text(o: dict) -> str:
    """The bound and the kernel's share of it (bound_ms / ms), as the
    phase 2 lines print them."""
    return (f"bound {o['bound_ms']:.4f} ms ({o['bound_by']}), kernel at "
            f"{o['bound_ms'] / o['ms']:.1%} of its bound")


def scan_corpus(torch, seed: int, n: int = 1 << 20):
    """The full capacity of the 1M-row store on the card: unit rows of
    the clustered corpus, f32."""
    X = torch.empty((n, DIM), dtype=torch.float32, device="cuda")
    for s in range(0, n, ADD_BATCH):
        X[s:s + ADD_BATCH] = torch.nn.functional.normalize(
            torch.from_numpy(corpus_batch(seed, s, ADD_BATCH)).to("cuda"), dim=1)
    return X


def _scan_bound(X, b: int, k: int) -> tuple[float, str]:
    """fused_topk_scan's bound: the corpus, queries and valid bytes read
    once and [b, k] (f32, i32) written, against 2*b*n*d FP32 FFMA."""
    n, d = X.shape
    return bound_ms(n * d * X.element_size() + b * d * 4 + n + b * k * 8,
                    2.0 * b * n * d, FP32_FLOPS)


def _pairs_bound(b: int, m: int, k: int) -> tuple[float, str]:
    """fused_topk_pairs's bound: every value read once, the k winners' ids
    gathered and [b, k] (f32, i32) written; one compare per value."""
    return bound_ms(b * m * 4 + b * k * (4 + 8), b * m, FP32_FLOPS)


def scan_breakdown(torch, K, X, qs, timer) -> list[str]:
    """The scan kernel alone (no merge) against a build of it without its
    selection (``-DWTT_SCAN_SELECT=0``: tiles parked, nothing filtered),
    at B = 64 and 256, k = 100: what the product with its loads costs and
    what the filter and merges add."""
    from weaviate_tpu_torch.ops import _build

    full = _build.kernel("fused_topk_scan")
    product = _build.build_variant("fused_topk_scan", ("WTT_SCAN_SELECT=0",))
    parts = []
    for b in (64, 256):
        qk, qn, xn, valid, async_ok = K._kernel_args(qs[:b], X, METRIC, None, None)
        rows_per, slices = K.scan_slices(X.shape[0], b)
        od = torch.empty((b, slices * TOP_K), device="cuda")
        oi = torch.empty((b, slices * TOP_K), device="cuda", dtype=torch.int32)
        ms = {}
        for name, fn in (("scan", full), ("product", product)):
            def run(fn=fn):
                rc = fn(qk.data_ptr(), None, X.data_ptr(), 0, None, None, None, 0, b,
                        X.shape[0], X.shape[1], TOP_K, 2, rows_per, slices, od.data_ptr(),
                        oi.data_ptr(), int(async_ok), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"fused_topk_scan {name} build: cudaError {rc}")
            ms[name] = timer(run, reps=5)
        bm, _ = _scan_bound(X, b, TOP_K)
        parts.append(f"scan kernel alone B={b}: {ms['scan']:.4f} ms, its product alone "
                     f"{ms['product']:.4f} ms ({bm / ms['product']:.1%} of the FP32 bound), "
                     f"selection {ms['scan'] - ms['product']:.4f} ms")
    return parts


def group_rows(K) -> int:
    """Rows of one distance launch in the approx loop at a 256-query drain
    over the 1M-row store (ops/topk.scan_group_chunks). A tree from before
    the grouped loop (``--dist-times`` on a parent) launched 8192-row
    chunks; it is timed at 8 chunks, the group the budget gives."""
    from weaviate_tpu_torch.ops import topk

    if not hasattr(topk, "scan_group_chunks"):
        return 8 * CHUNK
    return topk.scan_group_chunks(BATCH, CHUNK, (1 << 20) // CHUNK, TOP_K, False) * CHUNK


def distance_times(torch, K, q, x, valid, timer, plain: bool = False) -> dict:
    """distance_block (cosine, valid mask) at q [B, d] x x [N, d] beside one
    cuBLAS addmm of the same product (1 - q.x) and its FP32 bound: q, x,
    valid read once and [B, N] f32 written, against 2*B*N*d FFMA. ``ms``
    is the kernel launched with its query prepared once, as the approx
    loop launches it (distance_block_prepared); ``wrapper_ms`` the whole
    wrapper call, which also normalizes the query in f64 on every call
    (at one 8192-row chunk its Python and small ops take longer than the
    kernel). A tree from before the prepared launch times the wrapper."""
    b, n = q.shape[0], x.shape[0]
    reps = max(10, min(50, (50 * CHUNK) // n))
    one = torch.ones((), device=x.device)
    qn = torch.nn.functional.normalize(q, dim=1)
    b_ms, b_by = bound_ms(q.numel() * 4 + x.numel() * x.element_size() + n + b * n * 4,
                          2.0 * b * n * q.shape[1], FP32_FLOPS)
    wrapper_ms = timer(lambda: K.distance_block(q, x, METRIC, valid=valid), reps=reps)
    o = dict(ms=wrapper_ms)
    if hasattr(K, "distance_query"):
        prep = K.distance_query(q, METRIC)
        o = dict(ms=timer(lambda: K.distance_block_prepared(prep, x, METRIC, valid=valid),
                          reps=reps), wrapper_ms=wrapper_ms)
    if plain:
        o["plain_ms"] = timer(lambda: K.distance_block_plain(q, x, METRIC, valid=valid),
                              reps=reps)
    o.update(library_ms=timer(lambda: torch.addmm(one, qn, x.T, alpha=-1.0), reps=reps),
             bound_ms=b_ms, bound_by=b_by)
    return o


def _distance_text(o: dict) -> str:
    plain = f"plain {o['plain_ms']:.4f} ms, " if "plain_ms" in o else ""
    wrapper = f" (wrapper call {o['wrapper_ms']:.4f} ms)" if "wrapper_ms" in o else ""
    return (f"kernel {o['ms']:.4f} ms{wrapper}, {plain}addmm {o['library_ms']:.4f} ms "
            f"(kernel / addmm {o['ms'] / o['library_ms']:.2f}), {_bound_text(o)}")


def _per_chunk_topk(torch, K, q, x, k, valid=None, allow_bits=None, metric=METRIC):
    """The approx loop as it ran before the grouped one: per 8192-row chunk
    distance_block, the filter, and the exact top-k of [running k | chunk]
    by int64 keys (ties to the lower position). The grouped loop must
    return its answer bit for bit."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
    from weaviate_tpu_torch.ops.topk import topk_smallest

    n, b = x.shape[0], q.shape[0]
    allow = None if allow_bits is None else K.unpack_allow_bitmask(allow_bits, n)
    best_d = torch.full((b, k), MASKED_DISTANCE, device=x.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=x.device)
    iota = torch.arange(CHUNK, dtype=torch.int32, device=x.device)
    for lo in range(0, n, CHUNK):
        d = K.distance_block(q, x[lo:lo + CHUNK], metric,
                             valid=None if valid is None else valid[lo:lo + CHUNK])
        if allow is not None:
            d = torch.where(allow[:, lo:lo + CHUNK], d, torch.full_like(d, MASKED_DISTANCE))
        best_d, best_i = topk_smallest(torch.cat([best_d, d], 1),
                                       torch.cat([best_i, (iota + lo).expand(b, CHUNK)], 1), k)
    return best_d, best_i


def _approx_loop_check(torch, K, seed: int) -> None:
    """The grouped approx loop (chunked_topk_distances: distance_block per
    group, fused_topk_pairs per group and per merge, the NaN guard) against
    the per-chunk loop on the card, bit for bit in distances and ids
    (MASKED slots' ids included): 256 queries x 2.5 groups of rows with 5%
    dead rows at k = 10 / 100, with per-query 10% allow bits, with k past
    the live rows, and under the dot metric with NaN rows and a NaN query
    (a negated NaN product sorts first) without a valid mask, and with one
    (the loop then trusts the card's canonical NaN, which is positive)."""
    from weaviate_tpu_torch.ops.topk import chunked_topk_distances

    rng = np.random.default_rng([seed, 9])
    n = group_rows(K) * 5 // 2 // CHUNK * CHUNK
    x = torch.nn.functional.normalize(
        torch.from_numpy(clustered(seed, 4 * 10**9, n, centers(seed))).to("cuda"), dim=1)
    q = torch.from_numpy(clustered(seed, 5 * 10**9, BATCH, centers(seed))).to("cuda")
    valid = torch.from_numpy(rng.random(n) > 0.05).to("cuda")
    bits = K.pack_allow_bitmask_t(torch.from_numpy(rng.random((BATCH, n)) < 0.1).to("cuda"))
    few = torch.zeros(n, dtype=torch.bool, device="cuda")
    few[::n // 7] = True
    xnan, qnan = x.clone(), q.clone()
    xnan[[5, n // 2, n - 1]] = float("nan")
    qnan[3] = float("nan")
    cases = [("valid k=10", q, x, 10, valid, None, METRIC),
             ("valid k=100", q, x, TOP_K, valid, None, METRIC),
             ("allow bits k=100", q, x, TOP_K, valid, bits, METRIC),
             ("k past the live rows", q, x, 16, few, None, METRIC),
             ("dot with NaN", qnan, xnan, 16, None, None, "dot"),
             ("dot with NaN and valid", qnan, xnan, 16, valid, None, "dot")]
    for name, qq, xx, k, v, ab, metric in cases:
        got = chunked_topk_distances(qq, xx, k, CHUNK, metric, valid=v, use_pallas=True,
                                     selection="approx", allow_bits=ab)
        want = _per_chunk_topk(torch, K, qq, xx, k, v, ab, metric)
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"approx loop {name}: grouped answer != per-chunk answer")
    log(f"phase 2 kernels: approx loop, {BATCH} queries x [{n},{DIM}] in groups of "
        f"{group_rows(K)} rows ({', '.join(c[0] for c in cases)}): distances and ids equal "
        f"to the per-chunk loop's bit for bit")


def residency_text(K) -> str:
    """CTAs per SM and dynamic shared memory of the two selection kernels
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at the k and widths
    the paths give them."""
    return "residency (CTAs per SM, dynamic smem bytes): " + "; ".join(
        f"{name} {label}: {K.kernel_residency(name, *args)}" for name, label, args in (
            ("fused_topk_scan", "k=10 f32", (10, 0, 256)),
            ("fused_topk_scan", "k=100 f32", (100, 0, 256)),
            ("fused_topk_scan", "k=128 f32", (128, 0, 256)),
            ("fused_topk_scan", "k=100 bf16", (100, 1, 256)),
            ("fused_topk_scan", "k=100 f32 B<=32", (100, 0, 8)),
            ("fused_topk_pairs", "M=12800", (12800,)),
            ("fused_topk_pairs", "M=16384", (16384,)),
            ("fused_topk_pairs", "M=200000", (200000,))))


def topk_times(torch, K, X, vmask, qs, timer) -> list[str]:
    """Times of the two selection kernels at the shapes a drain gives
    them: fused_topk_scan (merge included) at B = 1, 8, 64 and 256 on the
    f32 corpus ``X`` and at B = 256 on its bf16 copy, and fused_topk_pairs
    at each B's merge shape, at [256, 16384] for k = 100 and 256 and at
    [1 / 8, 12800]. Each beside its bound; the residency of both kernels
    where the build exports it. Returns one text part per shape."""
    parts = []
    n = X.shape[0]
    Xb = X.to(torch.bfloat16)
    for xs, name, bs in ((X, "f32", (1, 8, 64, 256)), (Xb, "bf16", (1, 256))):
        for b in bs:
            ms = timer(lambda: K.fused_topk_scan(qs[:b], xs, TOP_K, METRIC, valid=vmask), reps=5)
            bm, by = _scan_bound(xs, b, TOP_K)
            rows_per, slices = K.scan_slices(n, b)
            parts.append(f"scan {name} B={b} k={TOP_K}: {ms:.4f} ms ({slices} slices of "
                         f"{rows_per}), bound {bm:.4f} ms ({by}, {bm / ms:.1%})")
    del Xb
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(b, K.scan_slices(n, b)[1] * TOP_K, TOP_K) for b in (1, 8, 64, 256)]
    # [256, 12800] is the merge shape of the 8192-row slices the scan took
    # before its slices grew
    shapes += [(256, 12800, 100), (256, 16384, 100), (256, 16384, 256), (1, 12800, 100),
               (8, 12800, 100)]
    for b, m, k in shapes:
        v = torch.rand((b, m), device="cuda", generator=gen)
        i = torch.randint(0, n, (b, m), device="cuda", dtype=torch.int32, generator=gen)
        ms = timer(lambda: K.fused_topk_pairs(v, i, k), reps=20)
        lib = timer(lambda: torch.topk(v, k, dim=1, largest=False), reps=20)
        bm, by = _pairs_bound(b, m, k)
        parts.append(f"pairs [{b},{m}] k={k}: {ms:.4f} ms, torch.topk {lib:.4f} ms, "
                     f"bound {bm:.5f} ms ({by}, {bm / ms:.1%})")
    return parts


def dist_times(torch, K, seed: int, timer) -> list[str]:
    """The kernels and the loop this slice redesigned, timed so that two
    trees can be compared in one call (``--dist-times``): distance_block
    at [256, 8192] and at the approx loop's group shape beside cuBLAS
    addmm; pq4_scan_reduce at lut [256, 192, 16] x codes [1,048,576, 192]
    (random codes and tables: the time does not follow the values);
    then one 256-query approx batch over the 1M-row corpus through
    chunked_topk_distances (k = 100, 1% dead rows), unfiltered and with
    per-query 10% allow bits, host clock around a synchronised call,
    median of 5. Returns one text part per measurement."""
    from weaviate_tpu_torch.ops.topk import chunked_topk_distances

    X = scan_corpus(torch, seed)
    n = X.shape[0]
    rng = np.random.default_rng([seed, 2])
    vmask = torch.from_numpy(rng.random(n) > 0.01).to("cuda")
    qs = torch.from_numpy(near_queries(seed, rng.integers(0, ROWS, BATCH), lambda r: X[
        torch.from_numpy(r).to("cuda")].cpu().numpy())).to("cuda")
    parts = []
    for rows in (CHUNK, group_rows(K)):
        o = distance_times(torch, K, qs, X[:rows], vmask[:rows], timer)
        parts.append(f"distance_block [{BATCH},{DIM}] x [{rows},{DIM}]: {_distance_text(o)}")
    m = 192
    gen = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 16, (n, m), device="cuda", dtype=torch.uint8, generator=gen)
    lut = torch.randn((BATCH, m, 16), device="cuda", generator=gen)
    o = dict(ms=timer(lambda: K.pq4_scan_reduce(lut, codes, vmask, 64), reps=10))
    o["bound_ms"], o["bound_by"] = bound_ms(lut.numel() * 4 + codes.numel() + n
                                            + BATCH * (n // 64) * 8,
                                            2.0 * BATCH * n * 16 * m, INT8_OPS)
    parts.append(f"pq4_scan_reduce lut [{BATCH},{m},16] x codes [{n},{m}] reduce_l 64: "
                 f"kernel {o['ms']:.4f} ms, {_bound_text(o)}")
    del codes, lut
    bits = K.pack_allow_bitmask_t(torch.from_numpy(rng.random((BATCH, n)) < 0.1).to("cuda"))
    for name, ab in (("unfiltered", None), ("per-query 10% allow bits", bits)):
        times = []
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunked_topk_distances(qs, X, TOP_K, CHUNK, METRIC, valid=vmask, use_pallas=True,
                                   selection="approx", allow_bits=ab)
            torch.cuda.synchronize()
            if rep:  # the first call warms up
                times.append((time.perf_counter() - t0) * 1e3)
        parts.append(f"approx batch {BATCH} x [{n},{DIM}] k={TOP_K} {name}: "
                     f"{np.median(times):.2f} ms (median of {len(times)}, host clock; "
                     f"all {', '.join(f'{t:.2f}' for t in times)})")
    return parts


def _bq_bound(qw, xw, L) -> dict:
    """bq_scan_reduce's bound: words, valid and both outputs once against
    the reference kernel's cost estimate (2*B*N*32W, the +-1 product) at
    the single-bit rate B1_OPS the kernel's MMAs run at. ``xw`` is [N, W]
    or, transposed, [W, N]."""
    b, w = qw.shape
    n = xw.numel() // w
    ms, by = bound_ms(qw.numel() * 4 + xw.numel() * 4 + n + b * (n // L) * 8,
                      2.0 * b * n * 32 * w, B1_OPS)
    return dict(bound_ms=ms, bound_by=by)


def bq_times(torch, K, qw, xw, vmask, timer) -> list[str]:
    """bq_scan_reduce timed at the drains' B = 1, 8, 64 and 256 on the
    [N, 24 words] corpus, each beside its bound; the transposed 128-bit
    prefix [4, N] at B = 256; and the product alone
    as a yardstick: torch._int_mm on the unpacked operands, [256, 768] int8
    (+-1) x [768, N] int8 (0/1), no reduction (not library_ms: no single
    PyTorch call computes the function). Returns one text part each."""
    from weaviate_tpu_torch.ops import bq as bq_ops

    n, w = xw.shape
    L = bq_ops._auto_reduce_l(n)
    parts = []
    for b in (1, 8, 64, 256):
        q = qw[:b].contiguous()
        o = dict(ms=timer(lambda: K.bq_scan_reduce(q, xw, vmask, L), reps=20),
                 **_bq_bound(q, xw, L))
        parts.append(f"B={b}: {o['ms']:.4f} ms, {_bound_text(o)}")
    qp, pt = qw[:, :4].contiguous(), xw[:, :4].T.contiguous()
    o = dict(ms=timer(lambda: K.bq_scan_reduce(qp, pt, vmask, L, transposed=True), reps=20),
             **_bq_bound(qp, pt, L))
    parts.append(f"prefix [{qp.shape[0]},4] x [4,{n}] transposed: {o['ms']:.4f} ms, "
                 f"{_bound_text(o)}")
    del pt
    if not hasattr(K, "bq_queries_to_pm1"):  # a tree before this yardstick
        return parts
    try:
        pm1 = K.bq_queries_to_pm1(qw, w)  # [B, 32W] +-1 in bit-plane order j*W + word
        x01 = _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(pm1, x01.t()), reps=5)
        parts.append(f"yardstick torch._int_mm [{qw.shape[0]},{32 * w}] x [{32 * w},{n}] "
                     f"int8 (the product alone): {ms:.4f} ms")
        del x01
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    return parts


def bq_probe(torch) -> list[str]:
    """The single-bit wgmma probe (weaviate_tpu_torch/csrc/probes/
    wgmma_b1.cu): whether nvcc takes it for sm_90a, the tensor-core
    instructions its SASS holds, and the time of one m64n128k256 b1 MMA
    against one m64n128k32 s8 MMA (528 CTAs of one warpgroup, 4096 x 4
    MMAs each, chained on one accumulator)."""
    import ctypes
    import os

    from weaviate_tpu_torch.ops import _build

    src = os.path.join(_build.CSRC, "probes", "wgmma_b1.cu")
    if not os.path.exists(src):
        return ["probe: not in this tree"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "probe_wgmma_b1.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        err = [ln for ln in (r.stdout + r.stderr).splitlines() if "rror" in ln]
        return [f"probe: nvcc refused the b1 MMA for sm_90a: {' | '.join(err[:3])}"]
    parts = [f"probe: built ({_sass_summary(so)})"]
    fn = ctypes.CDLL(so).wtt_probe_mma_loop
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    blocks, iters = 528, 4096
    out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    timer = Timer(torch)
    ms = {}
    for b1 in (0, 1, 0, 1):
        rc = []
        t = timer(lambda: rc.append(fn(b1, blocks, iters, out.data_ptr(), stream)), reps=3)
        if any(rc):
            return parts + [f"probe: launch failed, cudaError {max(rc)}"]
        ms.setdefault(b1, []).append(t)
    per = {b1: min(v) * 1e6 / (blocks * iters * 4) for b1, v in ms.items()}  # ns per MMA, all SMs
    parts.append(f"probe: {blocks} x {iters * 4} MMAs: s8 m64n128k32 {min(ms[0]):.3f} ms, "
                 f"b1 m64n128k256 {min(ms[1]):.3f} ms; one b1 MMA takes "
                 f"{per[1] / per[0]:.2f}x one s8 MMA and covers 8x its K bits")
    return parts


def _sass_summary(so: str) -> str:
    """Tensor-core instructions in a built library's SASS (cuobjdump
    -sass): each opcode with a GMMA or MMA in its name, and its count."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return f"cuobjdump failed: {r.stderr.strip()[:200]}"
    ops: dict = {}
    # (not the register moves HFMA2.MMA, which issue on the MMA pipe)
    for op in re.findall(r"(?<![.\w])([A-Z0-9]*MMA[A-Z0-9_.x]*)", r.stdout):
        ops[op] = ops.get(op, 0) + 1
    return ", ".join(f"{op} x{c}" for op, c in sorted(ops.items())) or "no MMA instruction"


# -- phases -------------------------------------------------------------------

def card_clocks() -> str:
    """SM clock now and at most, power draw, temperature: two calls can
    land on cards of one name whose clocks differ, and every time of the
    run moves with them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"phase 0 card: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}


def phase_build(K) -> None:
    from weaviate_tpu_torch import native
    from weaviate_tpu_torch.ops import _build

    # the host library builds with g++ beside the kernels' nvcc runs
    t_native = time.perf_counter()
    lib = threading.Thread(target=native.available)
    lib.start()
    secs = _build.build_all()
    lib.join()
    native_s = time.perf_counter() - t_native
    regs = []
    for name in _build.SIGNATURES:
        with open(_build.log_path(name)) as f:
            text = f.read()
        used = [int(t.split()[0]) for t in text.split("Used ")[1:]]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
        # ptxas prints one line per instantiation: any non-zero one spills
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        regs.append(f"{name} max {max(used) if used else '?'} registers, "
                    f"{max(smem) if smem else 0} bytes static smem, "
                    f"{max(spills) if spills else 0} bytes spilled")
    log(f"phase 1 build: {secs:.1f} s for {len(_build.SIGNATURES)} kernels "
        f"(nvcc sm_90a, in parallel); {'; '.join(regs)}")
    if hasattr(K, "kernel_residency"):  # absent from builds before the radix select
        log(f"phase 1 build: {residency_text(K)}")
    for name in ("bq_scan_reduce", "pq4_scan_reduce", "pq4_lut_block", "bq_mxu_block",
                 "pq4_recon_block", "bq_hamming_block"):
        log(f"phase 1 build: {name} SASS: {_sass_summary(_build._lib_path(name))}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if not native.available():
        # the import phases would time the numpy codecs as the library's
        raise AssertionError("the native host library did not build or load "
                             f"({native.SRC} with {gxx[:1]})")
    built = ("built in " + f"{native.build_seconds:.1f} s" if native.build_seconds is not None
             else "loaded from an earlier build")
    log(f"phase 1 build: native host library {native.library_path()} ({gxx[0]}, "
        f"{' '.join(native.CXX_FLAGS)}) {built}; {native_s:.1f} s beside the kernels")


def phase_kernels(torch, K, seed: int) -> tuple[dict, dict]:
    """Each kernel against its plain version at the main path's shapes.
    Returns the per-kernel numbers and the launch counts of the block
    kernels' window."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE
    from weaviate_tpu_torch.ops.topk import merge_epoch_topk

    dev = "cuda"
    timer = Timer(torch)
    cent = centers(seed)
    rng = np.random.default_rng([seed, 2])
    out = {}

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    # distance_block: q [256, 768] x one 8192-row chunk
    q = to_dev(clustered(seed, 10**9, BATCH, cent))
    x = to_dev(clustered(seed, 2 * 10**9, CHUNK, cent))
    valid = to_dev(rng.random(CHUNK) > 0.05)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for metric in ("l2-squared", "dot", "cosine"):
            xx = torch.nn.functional.normalize(x, dim=1) if metric == "cosine" else x
            xx = xx.to(dtype).contiguous()
            a = K.distance_block(q, xx, metric, valid=valid)
            b = K.distance_block_plain(q, xx, metric, valid=valid)
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"distance_block {metric} {dtype} disagrees")
            err = max(err, (a - b).abs().max().item())
    xn = torch.nn.functional.normalize(x, dim=1).contiguous()
    # batch invariance: a query's distances must not move with the rows
    # batched beside it (the batcher pads drains to 1, 2, 4, 8, ... rows)
    full = K.distance_block(q, xn, METRIC)
    for b in (1, 2, 4, 8, 16, 32, 33, 64):
        if not torch.equal(K.distance_block(q[:b], xn, METRIC), full[:b]):
            raise AssertionError(f"distance_block rows at B={b} differ from B={BATCH}")
    at_chunk = distance_times(torch, K, q, xn, valid, timer, plain=True)
    # the wrapper's time is logged below; the kernels line keeps its keys
    out["distance_block"] = dict(max_abs_err=err,
                                 **{k: v for k, v in at_chunk.items() if k != "wrapper_ms"})
    group = group_rows(K)
    xg = torch.nn.functional.normalize(
        to_dev(clustered(seed, 3 * 10**9, group, cent)), dim=1).contiguous()
    vg = to_dev(rng.random(group) > 0.05)
    a = K.distance_block(q, xg, METRIC, valid=vg)
    if not torch.allclose(a, K.distance_block_plain(q, xg, METRIC, valid=vg), rtol=RTOL,
                          atol=ATOL):
        raise AssertionError(f"distance_block at the group shape [{BATCH},{group}] disagrees")
    at_group = distance_times(torch, K, q, xg, vg, timer)
    del a, xg, vg
    log(f"phase 2 kernels: distance_block q[{BATCH},{DIM}] x [{CHUNK},{DIM}] "
        f"l2/dot/cosine x f32/bf16 with valid mask, and cosine at the approx loop's group "
        f"shape [{group},{DIM}]: max_abs_err {err:.3g} (rtol {RTOL}, atol {ATOL}), rows "
        f"equal at B = 1..{BATCH} (batch-invariant); {_distance_text(at_chunk)}; "
        f"at [{BATCH}] x [{group}]: {_distance_text(at_group)}")
    _approx_loop_check(torch, K, seed)

    # fused_topk_scan at the full capacity of the 1M-row store
    X = scan_corpus(torch, seed)
    n = X.shape[0]
    vmask = to_dev(rng.random(n) > 0.01)
    allow = to_dev(rng.random((BATCH, n)) < 0.1)
    bits = K.pack_allow_bitmask_t(allow)
    qs = to_dev(near_queries(seed, rng.integers(0, ROWS, BATCH),
                             lambda r: X[torch.from_numpy(r).to(dev)].cpu().numpy()))
    err, bad = 0.0, 0
    cases = [(10, None), (100, None), (10, bits), (100, bits)]
    for k, ab in cases:
        ad, ai = K.fused_topk_scan(qs, X, k, METRIC, valid=vmask, allow_bits=ab)
        bd, bi = K.fused_topk_scan_plain(qs, X, k, METRIC, valid=vmask, allow_bits=ab)
        ad, ai, bd, bi = (t.cpu().numpy() for t in (ad, ai, bd, bi))
        if not np.array_equal(ai < 0, bi < 0):
            raise AssertionError(f"fused_topk_scan k={k}: live slots differ")
        live = bi >= 0
        if not np.allclose(ad[live], bd[live], rtol=RTOL, atol=ATOL):
            raise AssertionError(f"fused_topk_scan k={k}: distances disagree")
        err = max(err, float(np.abs(ad[live] - bd[live]).max()))
        bad += tie_aware_mismatches(ai, ad, bi, bd)
    # k beyond the live rows: -1 tails
    few = torch.zeros(4096, dtype=torch.bool, device=dev)
    few[::97] = True
    ad, ai = K.fused_topk_scan(qs, X[:4096], 100, METRIC, valid=few)
    bd, bi = K.fused_topk_scan_plain(qs, X[:4096], 100, METRIC, valid=few)
    if not torch.equal(ai, bi) or not bool((ai[:, int(few.sum()):] == -1).all()):
        raise AssertionError("fused_topk_scan k > live rows disagrees")
    if bad:
        raise AssertionError(f"fused_topk_scan: {bad} id mismatches outside ties")
    rows_per, slices = K.scan_slices(n, BATCH)
    b_ms, b_by = _scan_bound(X, BATCH, TOP_K)
    # yardstick: cuBLAS addmm (1 - q.x, dead rows + MASKED as a bias row) then torch.topk
    qsn = torch.nn.functional.normalize(qs, dim=1)
    bias = 1.0 + (~vmask).float() * MASKED_DISTANCE
    out["fused_topk_scan"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.fused_topk_scan(qs, X, TOP_K, METRIC, valid=vmask), reps=5),
        plain_ms=timer(lambda: K.fused_topk_scan_plain(qs, X, TOP_K, METRIC, valid=vmask),
                       reps=3, warmup=1),
        library_ms=timer(lambda: torch.topk(torch.addmm(bias, qsn, X.T, alpha=-1.0), TOP_K,
                                            dim=1, largest=False), reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by)
    log(f"phase 2 kernels: fused_topk_scan q[{BATCH},{DIM}] x [{n},{DIM}] k=10/100 "
        f"with and without per-query allow_bits, and k > live rows: ids equal to the plain "
        f"version ({bad} mismatches outside ties of {TIE_TOL}), max_abs_err {err:.3g}; "
        f"kernel {out['fused_topk_scan']['ms']:.3f} ms ({slices} slices of {rows_per} rows, "
        f"merge included), plain {out['fused_topk_scan']['plain_ms']:.3f} ms, "
        f"addmm+topk {out['fused_topk_scan']['library_ms']:.3f} ms, "
        f"{_bound_text(out['fused_topk_scan'])}")
    _scan_checks(torch, K, X, qs, vmask, bits)
    for part in topk_times(torch, K, X, vmask, qs, timer):
        log(f"phase 2 kernels: topk times: {part}")
    scan, operands = _scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer)
    out.update(scan)
    block, counts2 = _block_kernels(torch, K, operands, qs, rng, timer)
    out.update(block)
    del X, allow, bits, vmask, bias, operands
    torch.cuda.empty_cache()

    # fused_topk_pairs: [256, 8192] at k = 100 and 256, and the scan's merge shape
    vals = torch.randn((BATCH, CHUNK), device=dev)
    vals[:, ::5] = MASKED_DISTANCE
    ids = torch.randint(0, 1 << 30, (BATCH, CHUNK), device=dev, dtype=torch.int32)
    for k in (100, 256):
        a = K.fused_topk_pairs(vals, ids, k)
        b = K.fused_topk_pairs_plain(vals, ids, k)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"fused_topk_pairs k={k} disagrees")
    parts = [(torch.sort(torch.randn((BATCH, 64), device=dev), dim=1)[0],
              torch.randint(-1, 4096, (BATCH, 64), device=dev, dtype=torch.int32))
             for _ in range(3)]
    maps = [torch.randperm(1 << 16, device=dev)[:4096].to(torch.int32) for _ in range(3)]
    fa = merge_epoch_topk(parts, maps, TOP_K, selection="fused")
    fb = merge_epoch_topk(parts, maps, TOP_K, selection="exact")
    if not (torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])):
        raise AssertionError("merge_epoch_topk(selection='fused') disagrees with exact")
    m = slices * TOP_K
    mv = torch.sort(torch.rand((BATCH, slices, TOP_K), device=dev), dim=2)[0].reshape(BATCH, m)
    mi = torch.randint(0, n, (BATCH, m), device=dev, dtype=torch.int32)
    a = K.fused_topk_pairs(mv, mi, TOP_K)
    b = K.fused_topk_pairs_plain(mv, mi, TOP_K)
    if not torch.equal(a[1], b[1]):
        raise AssertionError(f"fused_topk_pairs [{BATCH},{m}] k={TOP_K}: ids disagree")
    err = (a[0] - b[0]).abs().max().item()
    b_ms, b_by = _pairs_bound(BATCH, m, TOP_K)
    out["fused_topk_pairs"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.fused_topk_pairs(mv, mi, TOP_K), reps=20),
        plain_ms=timer(lambda: K.fused_topk_pairs_plain(mv, mi, TOP_K), reps=20),
        library_ms=timer(lambda: torch.topk(mv, TOP_K, dim=1, largest=False), reps=20),
        bound_ms=b_ms, bound_by=b_by)
    log(f"phase 2 kernels: fused_topk_pairs [{BATCH},{CHUNK}] k=100/256 and "
        f"merge_epoch_topk(selection='fused'): equal to the plain version; at the scan's "
        f"merge shape [{BATCH},{m}] k={TOP_K}: ids equal, max_abs_err {err:.3g}; "
        f"kernel {out['fused_topk_pairs']['ms']:.4f} ms, "
        f"plain {out['fused_topk_pairs']['plain_ms']:.4f} ms, torch.topk "
        f"{out['fused_topk_pairs']['library_ms']:.4f} ms, {_bound_text(out['fused_topk_pairs'])}")
    _pairs_checks(torch, K)
    out["bm25_block"] = _bm25_kernel(torch, K, rng, timer)
    return out, counts2


def _scan_checks(torch, K, X, qs, vmask, bits) -> None:
    """fused_topk_scan beyond phase 2's f32 cases: the bf16 copy of the
    corpus held tie-aware to the plain version; its returned distances
    equal distance_block's at the returned rows, bit for bit, at f32 and
    bf16 (both sum k = 0 .. d-1 in one fmaf chain); the dot metric on rows
    orthogonal to the queries (exact zero products: every such row is at
    distance -0.0, thousands of ties that only the row breaks) equal to
    the plain version id for id."""
    n = X.shape[0]
    Xb = X.to(torch.bfloat16)
    bad, err = 0, 0.0
    for xs, name in ((X, "f32"), (Xb, "bf16")):
        for k, ab in ((10, bits), (TOP_K, None)):
            ad, ai = K.fused_topk_scan(qs, xs, k, METRIC, valid=vmask, allow_bits=ab)
            if xs is Xb:
                bd, bi = K.fused_topk_scan_plain(qs, xs, k, METRIC, valid=vmask, allow_bits=ab)
                a_, b_ = (ad.cpu().numpy(), ai.cpu().numpy()), (bd.cpu().numpy(), bi.cpu().numpy())
                if not np.array_equal(a_[1] < 0, b_[1] < 0):
                    raise AssertionError(f"fused_topk_scan bf16 k={k}: live slots differ")
                live = b_[1] >= 0
                if not np.allclose(a_[0][live], b_[0][live], rtol=RTOL, atol=ATOL):
                    raise AssertionError(f"fused_topk_scan bf16 k={k}: distances disagree")
                err = max(err, float(np.abs(a_[0][live] - b_[0][live]).max()))
                bad += tie_aware_mismatches(a_[1], a_[0], b_[1], b_[0])
            # bit-identity with distance_block at the returned rows
            same = True
            for s in range(0, qs.shape[0], 64):
                full = K.distance_block(qs[s:s + 64], xs, METRIC)
                got = ai[s:s + 64]
                want = torch.gather(full, 1, got.clamp(min=0).long())
                same &= bool(torch.equal(torch.where(got >= 0, want, ad[s:s + 64]), ad[s:s + 64]))
                del full
            if not same:
                raise AssertionError(f"fused_topk_scan {name} k={k}: distances differ from "
                                     "distance_block's at the returned rows")
    if bad:
        raise AssertionError(f"fused_topk_scan bf16: {bad} id mismatches outside ties")
    del Xb
    # ragged shapes: B past a 64-query block, N past a 128-row tile, d not
    # a multiple of 16 or of 4 (the synchronous, non-cp.async path)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ragged = ((3, 1000, 77), (70, 5000, 130), (1, 129, DIM), (130, 300, 36), (65, 9000, 20))
    for (b, m, d), metric in zip(ragged * 3, ("l2-squared",) * 5 + ("dot",) * 5 + ("cosine",) * 5):
        qr = torch.randn((b, d), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            xr = torch.randn((m, d), device="cuda", generator=gen).to(dtype)
            vr = torch.rand(m, device="cuda", generator=gen) > 0.2
            br = K.pack_allow_bitmask_t(torch.rand((b, m), device="cuda", generator=gen) < 0.7)
            for k, ab in ((7, None), (128, br)):
                ad, ai = K.fused_topk_scan(qr, xr, k, metric, valid=vr, allow_bits=ab)
                bd, bi = K.fused_topk_scan_plain(qr, xr, k, metric, valid=vr, allow_bits=ab)
                a_, b_ = (ad.cpu().numpy(), ai.cpu().numpy()), (bd.cpu().numpy(), bi.cpu().numpy())
                live = b_[1] >= 0
                if not (np.array_equal(a_[1] < 0, ~live)
                        and np.allclose(a_[0][live], b_[0][live], rtol=RTOL, atol=ATOL)
                        and tie_aware_mismatches(a_[1], a_[0], b_[1], b_[0]) == 0):
                    raise AssertionError(f"fused_topk_scan {metric} {dtype} [{b},{d}] x "
                                         f"[{m},{d}] k={k} disagrees with the plain version")
                full = K.distance_block(qr, xr, metric)
                want = torch.gather(full, 1, ai.clamp(min=0).long())
                if not torch.equal(torch.where(ai >= 0, want, ad), ad):
                    raise AssertionError(f"fused_topk_scan {metric} {dtype} [{b},{d}] x "
                                         f"[{m},{d}]: distances differ from distance_block's")
    # dot metric, exact zero products: queries live in the first half of
    # the dimensions, every third row in the second half only; the other
    # rows point away (distance > 0), so the k best are all zero ties
    gen = torch.Generator(device="cuda").manual_seed(7)
    nd = 20_000
    qd = torch.rand((64, DIM), device="cuda", generator=gen)
    qd[:, DIM // 2:] = 0.0
    xd = -torch.rand((nd, DIM), device="cuda", generator=gen)
    xd[::3, :DIM // 2] = 0.0
    for k in (10, TOP_K, 128):
        ad, ai = K.fused_topk_scan(qd, xd, k, "dot")
        bd, bi = K.fused_topk_scan_plain(qd, xd, k, "dot")
        if not (torch.equal(ai, bi) and torch.equal(ad, bd)):
            raise AssertionError(f"fused_topk_scan dot zero products k={k} disagrees")
        if not bool((ad == 0).all()):
            raise AssertionError("fused_topk_scan dot zero products: the ties did not win")
    log(f"phase 2 kernels: fused_topk_scan bf16 copy of the [{n},{DIM}] corpus k=10 (per-query "
        f"allow_bits) / {TOP_K}: ids equal to the plain version ({bad} mismatches outside ties),"
        f" max_abs_err {err:.3g}; f32 and bf16 distances equal distance_block's at the returned "
        f"rows bit for bit; {len(ragged)} ragged shapes x 3 metrics x f32/bf16 x k=7/128 "
        f"(per-query allow_bits at 128, d = 20 / 36 / 77 / 130 / 768) held alike; dot on [{nd},{DIM}] rows with exact zero products (ties at 0) "
        f"k=10/{TOP_K}/128: equal to the plain version")


def _pairs_checks(torch, K) -> None:
    """fused_topk_pairs equal to its plain version (ids and values under
    ==) on the inputs that break a careless select: values on 16 levels
    (the k-th value shared by many positions), +0.0 / -0.0 groups, NaN,
    +inf, -inf and MASKED_DISTANCE entries, rows with nothing live, M < k,
    M = 1, M not a multiple of 32, k = 1 / 100 / 256, [256, 16384] and a
    row too wide for shared memory ([8, 200000])."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(b, m):
        return torch.rand((b, m), device="cuda", generator=gen)

    def levels(b, m):
        return torch.floor(rand(b, m) * 16) / 16

    def zeros(b, m):
        v = levels(b, m) + 0.5
        z = rand(b, m) < 0.3
        sign = torch.where(rand(b, m) < 0.5, -1.0, 1.0)
        return torch.where(z, sign * 0.0, v)

    def specials(b, m):
        v = levels(b, m) - 0.5
        r = rand(b, m)
        v = torch.where(r < 0.1, float("nan"), v)
        v = torch.where((r >= 0.1) & (r < 0.2), float("inf"), v)
        v = torch.where((r >= 0.2) & (r < 0.3), MASKED_DISTANCE, v)
        v = torch.where((r >= 0.3) & (r < 0.32), float("-inf"), v)
        v[::4] = MASKED_DISTANCE  # nothing live
        v[1::4] = float("nan")
        v[2::8, : m // 2] = float("nan")
        return v

    cases = []
    for k in (1, TOP_K, 256):
        cases += [(f"16 levels k={k}", levels(64, 8192), k),
                  (f"+-0 k={k}", zeros(64, 4099), k),
                  (f"specials k={k}", specials(64, 4096), k),
                  (f"random k={k}", rand(64, 8192), k)]
    cases += [("M<k", levels(16, 50), TOP_K), ("M<k zeros", zeros(16, 200), 256),
              ("M=1 k=1", rand(8, 1), 1), ("M=1 k=100", specials(8, 1), TOP_K),
              ("M=1000+7", levels(33, 1007), TOP_K), ("M=31", zeros(3, 31), 16),
              ("[256,16384] k=100", rand(256, 16384), TOP_K),
              ("[256,16384] k=256", levels(256, 16384), 256),
              ("[256,16385] levels", levels(256, 16385), TOP_K),
              ("[8,200000] k=100", rand(8, 200_000), TOP_K),
              ("[8,200000] levels k=256", levels(8, 200_000), 256),
              ("[8,200000] specials", specials(8, 200_000), TOP_K)]
    for name, v, k in cases:
        ids = torch.randint(0, 1 << 30, v.shape, device="cuda", dtype=torch.int32, generator=gen)
        a = K.fused_topk_pairs(v, ids, k)
        b = K.fused_topk_pairs_plain(v, ids, k)
        if not (torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])):
            raise AssertionError(f"fused_topk_pairs {name} {tuple(v.shape)} disagrees")
    log(f"phase 2 kernels: fused_topk_pairs {len(cases)} edge cases (16-level ties, +0/-0, "
        f"NaN/+-inf/MASKED, empty rows, M < k, M = 1, ragged M, k = 1/100/256, [256,16384], "
        f"[8,200000] past shared memory): ids and values equal to the plain version")


def _bm25_operands(torch, rng, b, s, t, c, wild=False, dev="cuda"):
    """Random operands of bm25_block on the card: integer term
    frequencies (60% zero), property lengths, boosts including 0, real
    term indexes (every segment names a term below T, or with ``wild``
    ~15% of them a term outside [0, T) and the terms out of order) and
    idf, per-row k1 / b with the host-rounded 1 - b, and ~90% live
    candidates."""
    from weaviate_tpu_torch.ops import kernels as K

    tf = rng.integers(1, 6, (b, s, c)).astype(np.float32)
    tf[rng.random((b, s, c)) < 0.6] = 0.0
    k1 = rng.uniform(0.5, 2.0, b).astype(np.float32)
    bb = rng.uniform(0.0, 1.0, b).astype(np.float32)
    term = rng.integers(0, t, (b, s)).astype(np.int32)
    if wild:
        odd = rng.random((b, s)) < 0.15
        term[odd] = rng.choice(np.int32([-1, -7, t, t + 5, 2 ** 30]), int(odd.sum()))
    host = dict(
        seg_tf=tf, seg_len=rng.integers(1, 400, (b, s, c)).astype(np.float32),
        seg_term=term, seg_boost=rng.choice(np.float32([0.0, 0.5, 1.0, 2.0]), (b, s)),
        seg_avg=rng.uniform(20.0, 200.0, (b, s)).astype(np.float32),
        idf=rng.uniform(0.0, 8.0, (b, t)).astype(np.float32), k1=k1, b=bb,
        omb=(np.float32(1.0) - bb).astype(np.float32))
    ops = {n: torch.from_numpy(a).to(dev) for n, a in host.items()}
    ops["cand_bits"] = K.pack_allow_bitmask_t(
        torch.from_numpy(rng.random((b, c)) < 0.9).to(dev))
    return ops


BM25_ARGS = ("seg_tf", "seg_len", "seg_term", "seg_boost", "seg_avg", "idf", "k1", "b",
             "omb", "cand_bits")
BM25_SHAPE = (64, 16, 8, 4096)  # B, S, T, C of the hybrid path at its 4096 budget
# one fused hybrid dispatch of 8 rows as the card runs it: its operands
# padded up to ops/bm25.GRAPH_SHAPE (phase 7's split prints the padded
# shape of its own dispatches)
BM25_DISPATCH_SHAPE = (8, 64, 32, 4096)
# (B, S, T, C, wild terms): ragged shapes, every term tile of the kernel
# (8, 16, 32, 64 terms), T past one 64-term tile (T = 320 ending in a
# partial tile, T = 512), terms out of order and outside [0, T), and an
# 8-row dispatch's own pow2 shape before the padding
BM25_CHECKS = ((1, 1, 1, 512, False), (3, 5, 3, 1024, False), (7, 13, 6, 1536, False),
               (16, 32, 16, 2048, False), (2, 64, 64, 512, False), (33, 8, 8, 512, False),
               (2, 640, 320, 512, False), (3, 1024, 512, 1024, False),
               (4, 24, 24, 1024, True), (5, 40, 40, 512, True), (9, 300, 70, 1024, True),
               (6, 12, 12, 1536, True), (8, 32, 16, 4096, False), BM25_DISPATCH_SHAPE + (False,),
               BM25_SHAPE + (False,))


def bm25_checks(torch, K, rng, dev="cuda") -> int:
    """bm25_block against its plain version, bit for bit, at BM25_CHECKS:
    both evaluate the host scorer's f32 operations in its order, so
    equality is exact. Returns the number of shapes."""
    for b, s, t, c, wild in BM25_CHECKS:
        ops = _bm25_operands(torch, rng, b, s, t, c, wild, dev)
        a = K.bm25_block(*(ops[n] for n in BM25_ARGS))
        p = K.bm25_block_plain(*(ops[n] for n in BM25_ARGS))
        if not torch.equal(a.view(torch.int32), p.view(torch.int32)):
            bad = int((a != p).sum().item())
            raise AssertionError(f"bm25_block [{b},{s},{t},{c}]{' wild' if wild else ''}: "
                                 f"{bad} values differ from the plain version")
    return len(BM25_CHECKS)


def graph_ms(torch, K, fns, reps: int = 24) -> float:
    """Mean ms of one call on the card without the host's cost of
    launching it: ``reps`` calls, cycling through ``fns`` (operand sets
    that together overflow the 50 MB L2, so each call reads its operands
    from device memory), captured in one CUDA graph (the capture counts
    no launch) and replayed between CUDA events."""
    for fn in fns:  # warm-up, outside the graph
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with getattr(K, "recording_launches", contextlib.nullcontext)():
        with torch.cuda.graph(g):
            for i in range(reps):
                fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bm25_time(torch, K, rng, timer, shape, plain: bool = True) -> dict:
    """bm25_block timed at ``shape`` (B, S, T, C) beside its bound: both
    planes and the scalars read once, the output written once; operations,
    the reference kernel's cost estimate B*C*(4S + T(S+3)) at the FP32
    rate. ``ms`` is the kernel on the card (graph_ms, operands from device
    memory); ``call_ms`` the wrapper called from Python back to back, which
    the host's launch path bounds at these sizes."""
    b, s, t, c = shape
    nbytes = 2 * b * s * c * 4 + 3 * b * s * 4 + b * t * 4 + 3 * b * 4 + b * c // 8 \
        + b * c * 4
    sets = [[o[n] for n in BM25_ARGS] for o in (
        _bm25_operands(torch, rng, b, s, t, c) for _ in range(max(2, -(-120_000_000 // nbytes))))]
    args = sets[0]
    b_ms, b_by = bound_ms(nbytes, b * c * (4 * s + t * (s + 3)), FP32_FLOPS)
    return dict(max_abs_err=0.0,
                ms=graph_ms(torch, K, [lambda a=a: K.bm25_block(*a) for a in sets]),
                call_ms=timer(lambda: K.bm25_block(*args), reps=50),
                plain_ms=timer(lambda: K.bm25_block_plain(*args), reps=5) if plain else None,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def _bm25_kernel(torch, K, rng, timer) -> dict:
    """bm25_block against its plain version on the card, bit for bit
    (bm25_checks), then timed at the hybrid path's [64, 16, 8, 4096] and at
    one 8-row dispatch's BM25_DISPATCH_SHAPE."""
    from weaviate_tpu_torch.ops import bm25 as B

    if getattr(B, "GRAPH_SHAPE", BM25_DISPATCH_SHAPE[1:]) != BM25_DISPATCH_SHAPE[1:]:
        raise AssertionError(f"BM25_DISPATCH_SHAPE {BM25_DISPATCH_SHAPE} is not 8 rows at "
                             f"ops/bm25.GRAPH_SHAPE {B.GRAPH_SHAPE}")
    n = bm25_checks(torch, K, rng)
    o = bm25_time(torch, K, rng, timer, BM25_SHAPE)
    od = bm25_time(torch, K, rng, timer, BM25_DISPATCH_SHAPE, plain=False)
    call_ms = o.pop("call_ms")
    log(f"phase 2 kernels: bm25_block {n} shapes (ragged, every term tile, T past one tile, "
        f"terms outside [0, T), the dispatch's {list(BM25_DISPATCH_SHAPE)} and the hybrid "
        f"path's {list(BM25_SHAPE)} (B, S, T, C)): equal to the plain version bit for bit; "
        f"at {list(BM25_SHAPE)} kernel {o['ms']:.4f} ms (CUDA graph of launches, operands "
        f"from device memory; the wrapper called back to back {call_ms:.4f} ms), plain "
        f"{o['plain_ms']:.4f} ms, library {NO_LIBRARY}, {_bound_text(o)}; at "
        f"{list(BM25_DISPATCH_SHAPE)} kernel {od['ms']:.4f} ms (called {od['call_ms']:.4f}), "
        f"{_bound_text(od)}")
    return o


# pq4_lut_block beyond the main shape: (B, N, m, k, table, valid). Ragged m
# (1, 3, 17, 33) and m past the first design's 3,632-segment cap, B off the
# 64-query block, codes past k and past 15 (codes run to 17), tables of
# bf16 subnormals, -0.0 and zeros ("tiny"), infinite entries ("inf": NaN
# wherever the one-hot product meets 0 * inf), all-dead and partly dead rows
LUT_CHECKS = ((1, 257, 1, 16, "normal", None), (3, 1000, 3, 12, "normal", "dead10"),
              (65, 513, 17, 16, "tiny", "alldead"), (130, 2050, 33, 16, "tiny", "dead10"),
              (5, 4099, 192, 16, "normal", "dead10"), (64, 777, 48, 16, "inf", None),
              (70, 600, 40, 16, "inf", "dead10"), (7, 3001, 3700, 16, "normal", "dead10"),
              (2, 1536, 4100, 9, "tiny", None))


def _lut_table(rng, b, m, kc, kind) -> np.ndarray:
    lut = (rng.standard_normal((b, m, kc)) * 3).astype(np.float32)
    if kind == "tiny":  # bf16 subnormals j * 2**-133, -0.0 and zeros among small normals
        sub = (rng.integers(-127, 128, (b, m, kc)) * 2.0 ** -133).astype(np.float32)
        pick = rng.random((b, m, kc))
        lut = np.where(pick < 0.6, sub, lut * np.float32(2.0 ** -120)).astype(np.float32)
        lut[pick > 0.95] = -0.0
    elif kind == "inf":
        pick = rng.random((b, m, kc))
        lut[pick < 0.002] = np.inf
        lut[pick > 0.999] = -np.inf
    return lut


def _same_bits(torch, a, b, what) -> None:
    """Equal bit for bit, NaN payloads aside: NaN in the same places, every
    other entry the same bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against the plain "
                             f"version's {b.dtype} {tuple(b.shape)}")
    an, bn = a.isnan(), b.isnan()
    if not torch.equal(an, bn):
        raise AssertionError(f"{what}: NaN at {int((an != bn).sum())} other places")
    ia, ib = a[~an].view(torch.int16), b[~bn].view(torch.int16)
    if not torch.equal(ia, ib):
        raise AssertionError(f"{what}: {int((ia != ib).sum())} values differ from the "
                             "plain version")


def lut_checks(torch, K, rng, dev="cuda") -> int:
    """pq4_lut_block against its plain version at LUT_CHECKS, bit for bit
    (NaN payloads aside). Returns the number of cases run; a tree whose
    kernel refuses m past its cap skips those."""
    ran = 0
    for b, n, m, kc, kind, vmode in LUT_CHECKS:
        if m > getattr(K, "PQ4_LUT_MAX_SEGMENTS", m):
            continue
        lut = torch.from_numpy(_lut_table(rng, b, m, kc, kind)).to(dev)
        codes = torch.from_numpy(rng.integers(0, 18, (n, m)).astype(np.uint8)).to(dev)
        valid = None if vmode is None else torch.from_numpy(
            rng.random(n) > (1.1 if vmode == "alldead" else 0.1)).to(dev)
        _same_bits(torch, K.pq4_lut_block(lut, codes, valid),
                   K.pq4_lut_block_plain(lut, codes, valid),
                   f"pq4_lut_block [{b},{m},{kc}] x [{n},{m}] {kind} valid {vmode}")
        ran += 1
    return ran


def lut_time(torch, K, lut, codes, valid, timer, plain: bool = True) -> dict:
    """pq4_lut_block timed beside its bound: the f32 LUT, the codes and
    valid read once, the bf16 output written once; operations, the
    function's B*N*m f32 additions (the sum in segment order), each an
    FADD at the FP32 issue rate. ``onehot_ms``: a design figure, the
    one-hot product's 2*B*N*16m at the bf16 rate (the TPU kernel's MXU
    product; the kernel issues it besides the additions)."""
    b, m, _ = lut.shape
    n = codes.shape[0]
    b_ms, b_by = bound_ms(lut.numel() * 4 + codes.numel() + n + b * n * 2,
                          float(b * n * m), FP32_ADDS)
    return dict(max_abs_err=0.0, ms=timer(lambda: K.pq4_lut_block(lut, codes, valid), reps=5),
                plain_ms=timer(lambda: K.pq4_lut_block_plain(lut, codes, valid), reps=1,
                               warmup=0) if plain else None,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                onehot_ms=2.0 * b * n * 16 * m / BF16_FLOPS * 1e3)


def _same_scan(torch, a, b, what) -> float:
    """Scan-reduce outputs must be equal: vals everywhere, ids wherever
    the slot is live (the ids of masked slots are never read)."""
    from weaviate_tpu_torch.ops.distances import MASKED_DISTANCE

    (av, ai), (bv, bi) = a, b
    live = bv < MASKED_DISTANCE
    if not (torch.equal(av, bv) and torch.equal(ai[live], bi[live])):
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return (av - bv).abs().max().item()


def bq_ragged_checks(torch, K, rng, dev) -> int:
    """bq_scan_reduce against its plain version, bit for bit, at ragged
    shapes; returns the number of shapes."""
    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def allow_of(b, rows):
        return K.pack_allow_bitmask_t(torch.from_numpy(rng.random((b, rows)) < 0.5).to(dev))

    # B, N and W off every tile size, both layouts, masks: B past one
    # query block of the tensor-core body (65, 129, 257, 300), W = 1, 3,
    # 25, 33 and 200 (too wide for it: the popcount body), N = 1 and 9001,
    # with and without valid rows
    ragged = 0
    for b, rows, w, L, tp, masked, has_valid in [
            (1, 1, 1, 4, False, False, True), (7, 130, 3, 4, False, False, True),
            (33, 2001, 4, 8, True, False, True), (40, 9001, 24, 64, False, True, True),
            (70, 3000, 4, 2, True, True, True), (5, 5000, 25, 16, False, True, True),
            (65, 9001, 25, 16, False, True, True), (65, 1, 33, 2, True, False, False),
            (129, 1, 1, 4, False, True, True), (129, 9001, 24, 64, True, False, False),
            (257, 9001, 33, 64, False, False, True), (257, 2001, 1, 32, True, True, False),
            (300, 5000, 3, 8, False, True, False), (300, 9001, 25, 64, True, True, True),
            (1, 9001, 24, 64, False, True, False), (8, 9001, 33, 16, True, False, True),
            (17, 3000, 200, 8, False, True, True)]:
        q, x = words((b, w)), words((w, rows) if tp else (rows, w))
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev) if has_valid else None
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.bq_scan_reduce(q, x, valid, L, tp, allow_bits=ab),
                   K.bq_scan_reduce_plain(q, x, valid, L, tp, allow_bits=ab),
                   f"bq_scan_reduce ragged b={b} n={rows} w={w} transposed={tp} "
                   f"allow={masked} valid={has_valid}")
        ragged += 1
    return ragged


def _scan_reduce_kernels(torch, K, X, qs, vmask, bits, rng, timer) -> dict:
    """bq_scan_reduce and pq4_scan_reduce against their plain versions on
    the card: ragged shapes first, then the main path's (the 1M-row
    corpus X as sign words and as 4-bit PQ codes, with and without the
    per-query allow bits, and the two-stage scan's transposed prefix).
    Equality is exact: the arithmetic is integer, and the one f32
    division by the query's scale is exact in IEEE. Returns the numbers
    and the operands the block kernels reuse (the sign words, the 4-bit
    codes, the queries' LUTs and the centroids)."""
    from weaviate_tpu_torch.ops import bq as bq_ops
    from weaviate_tpu_torch.ops import pq as pq_ops

    dev = X.device
    n = X.shape[0]
    out = {}

    def allow_of(b, rows):
        return K.pack_allow_bitmask_t(torch.from_numpy(rng.random((b, rows)) < 0.5).to(dev))

    # ragged: B, N and m off every tile size, both layouts, masks
    ragged, pq_ragged = bq_ragged_checks(torch, K, rng, dev), 0
    for b, rows, m, kc, L, tp, masked in [(1, 1, 1, 16, 4, False, False),
                                          (7, 130, 8, 12, 4, False, False),
                                          (17, 2001, 12, 16, 8, True, True),
                                          (20, 9001, 24, 16, 64, False, True),
                                          (33, 5000, 33, 16, 16, False, False),
                                          (5, 4000, 192, 9, 32, True, False),
                                          # past the 896 segments the first kernel
                                          # refused: m = 1024 and ragged m
                                          (70, 9001, 1024, 16, 16, False, True),
                                          (70, 9001, 1024, 16, 16, True, True),
                                          (33, 5000, 901, 16, 8, False, True),
                                          (33, 5000, 901, 11, 8, True, True),
                                          (65, 3000, 1000, 16, 64, False, False)]:
        lut = torch.from_numpy((rng.standard_normal((b, m, kc)) * 3).astype(np.float32)).to(dev)
        codes = rng.integers(0, kc, (rows, m)).astype(np.uint8)
        c = torch.from_numpy(np.ascontiguousarray(codes.T) if tp else codes).to(dev)
        valid = torch.from_numpy(rng.random(rows) > 0.3).to(dev)
        ab = allow_of(b, rows) if masked else None
        _same_scan(torch, K.pq4_scan_reduce(lut, c, valid, L, tp, allow_bits=ab),
                   K.pq4_scan_reduce_plain(lut, c, valid, L, tp, allow_bits=ab),
                   f"pq4_scan_reduce ragged b={b} n={rows} m={m} kc={kc} transposed={tp}")
        pq_ragged += 1

    # the main path's shapes: [256, 24 words] x 1,048,576 rows, reduce_l 64
    # (and the drains' B = 1, 8, 64)
    L = bq_ops._auto_reduce_l(n)
    xw = torch.cat([bq_ops.bq_encode(X[s:s + ADD_BATCH]) for s in range(0, n, ADD_BATCH)])
    qw = bq_ops.bq_encode(qs)
    err = 0.0
    for ab in (None, bits):
        err = max(err, _same_scan(torch, K.bq_scan_reduce(qw, xw, vmask, L, allow_bits=ab),
                                  K.bq_scan_reduce_plain(qw, xw, vmask, L, allow_bits=ab),
                                  f"bq_scan_reduce [{BATCH},{qw.shape[1]}] x [{n}]"))
    for b in (1, 8, 64):
        _same_scan(torch, K.bq_scan_reduce(qw[:b], xw, vmask, L),
                   K.bq_scan_reduce_plain(qw[:b], xw, vmask, L),
                   f"bq_scan_reduce [{b},{qw.shape[1]}] x [{n}]")
    qp, pt = qw[:, :4].contiguous(), xw[:, :4].T.contiguous()  # the 128-bit prefix
    for ab in (None, bits):
        err = max(err, _same_scan(
            torch, K.bq_scan_reduce(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            K.bq_scan_reduce_plain(qp, pt, vmask, L, transposed=True, allow_bits=ab),
            f"bq_scan_reduce prefix [4,{n}]"))
    w = qw.shape[1]
    out["bq_scan_reduce"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.bq_scan_reduce(qw, xw, vmask, L), reps=10),
        plain_ms=timer(lambda: K.bq_scan_reduce_plain(qw, xw, vmask, L), reps=1, warmup=1),
        library_ms=None, **_bq_bound(qw, xw, L))
    o = out["bq_scan_reduce"]
    log(f"phase 2 kernels: bq_scan_reduce {ragged} ragged shapes, then "
        f"[{BATCH},{w} words] x [{n},{w}] reduce_l {L} with and without per-query "
        f"allow_bits, B = 1, 8, 64, and the transposed prefix [4,{n}]: equal to the plain "
        f"version (max_abs_err {err:.3g}); kernel {o['ms']:.4f} ms, plain "
        f"{o['plain_ms']:.3f} ms, library {NO_LIBRARY}, {_bound_text(o)}")
    for part in bq_times(torch, K, qw, xw, vmask, timer):
        log(f"phase 2 kernels: bq times: {part}")
    del pt

    # [256, m = 192] 4-bit codes of the same corpus, codebook trained here
    m = pq_ops.default_pq_segments(DIM)
    sample = X[torch.from_numpy(rng.choice(n, 65536, replace=False)).to(dev)].cpu().numpy()
    book = pq_ops.pq_fit(sample, m=m, k=16, iters=4, device=dev)
    codes = torch.cat([pq_ops._assign(X[s:s + ADD_BATCH], book.centroids, m).to(torch.uint8)
                       for s in range(0, n, ADD_BATCH)])
    lut = pq_ops.pq_lut(torch.nn.functional.normalize(qs, dim=1), book.centroids, METRIC, m)
    err = 0.0
    for ab in (None, bits):
        err = max(err, _same_scan(torch, K.pq4_scan_reduce(lut, codes, vmask, L, allow_bits=ab),
                                  K.pq4_scan_reduce_plain(lut, codes, vmask, L, allow_bits=ab),
                                  f"pq4_scan_reduce [{BATCH},{m}] x [{n}]"))
    b_ms, b_by = bound_ms(lut.numel() * 4 + codes.numel() + n + BATCH * (n // L) * 8,
                          2.0 * BATCH * n * 16 * m, INT8_OPS)
    out["pq4_scan_reduce"] = dict(
        max_abs_err=err,
        ms=timer(lambda: K.pq4_scan_reduce(lut, codes, vmask, L), reps=10),
        plain_ms=timer(lambda: K.pq4_scan_reduce_plain(lut, codes, vmask, L), reps=1, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    o = out["pq4_scan_reduce"]
    log(f"phase 2 kernels: pq4_scan_reduce {pq_ragged} ragged shapes (m = 1024 and 901 / "
        f"1000 among them, row-major and transposed, with allow words), then "
        f"lut [{BATCH},{m},16] x codes [{n},{m}] reduce_l {L} with and without per-query "
        f"allow_bits: equal to the plain version (max_abs_err {err:.3g}); kernel "
        f"{o['ms']:.3f} ms (the int8 table's quantization and blocked layout included), plain "
        f"{o['plain_ms']:.3f} ms, "
        f"library {NO_LIBRARY}, {_bound_text(o)}")
    return out, dict(qw=qw, xw=xw, codes=codes, lut=lut, centroids=book.centroids)


def _same_block(torch, a, b, what, tol=None) -> float:
    """Block-kernel outputs against the plain version's: the same dtype
    and shape; equal, or (``tol``) within tol * max(1, max|ref|) on live
    entries with every masked entry equal. Returns the largest error."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against the plain "
                             f"version's {b.dtype} {tuple(b.shape)}")
    if tol is None:
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {int((a != b).sum())} values differ from the "
                                 "plain version")
        return 0.0
    af, bf = a.float(), b.float()
    live = bf < 1e38  # masked entries are bf16(d + MASKED_DISTANCE)
    diff = (af - bf)[live].abs()
    err = diff.max().item() if diff.numel() else 0.0
    lim = tol * max(1.0, bf[live].abs().max().item() if diff.numel() else 0.0)
    if err > lim or not torch.equal(a[~live], b[~live]):
        raise AssertionError(f"{what}: max error {err} past {lim}, or masked entries differ")
    return err


# bq_mxu_block beyond the main shape: (B, N, W). W = 1, 8 and 9 on the
# single-bit body (one K step, a full one, one past it), W = 200 on the
# popcount body it keeps (bq_mxu_qblock 0); B = 8, 129 (two query blocks of
# 128) and 1,024 (the probe's), N off the 64-row tile
MXU_CHECKS = ((8, 4099, 1), (129, 9001, 8), (1024, 2050, 9), (8, 3001, 200),
              (129, 777, 200), (1024, 1001, 4))
# bq_hamming_block beyond the main shape: (B, N, W), the shapes of
# tests/test_torch_hamming_tc.py (W = 1, 3, 8, 9, 24, 25, 33; B = 1, 8, 129;
# N = 1, 63, 65, 9001), then W = 120 and 200 on the popcount body it keeps
# (bq_hamming_qblock 0) and the main W at B = 256; ham_checks also runs
# UNALIGNED on a base 4 bytes past 16-byte alignment (the 4-byte copies)
HAM_CHECKS = ((1, 1, 1), (8, 63, 3), (129, 65, 8), (1, 9001, 9), (8, 9001, 24),
              (129, 63, 25), (8, 65, 33), (129, 9001, 1), (1, 65, 24), (129, 1, 33),
              (8, 1, 9), (1, 63, 8), (1, 70, 120), (129, 33, 200), (256, 9001, 24))
UNALIGNED = ((8, 4099, 24), (129, 1001, 8), (256, 9001, 24))
# pq4_recon_block beyond the main shape: (B, N, m, k, ds, top code). ds = 3
# and 1 with d = m * ds no multiple of 16, ds = 8 and 2, codes past 15 (top
# code past 16), B past one 64-query block; d = 1,024 takes the FFMA body
# it keeps (pq4_recon_smem past the card's shared memory)
RECON_CHECKS = ((5, 7001, 25, 12, 3, 20), (65, 4099, 96, 16, 8, 17),
                (3, 999, 7, 16, 2, 18), (130, 2050, 33, 9, 1, 16), (7, 3001, 256, 16, 4, 20))


def mxu_recon_checks(torch, K, rng, dev) -> int:
    """bq_mxu_block (bit for bit) and pq4_recon_block (within PQ_TOL,
    l2 / dot / cosine) against their plain versions at MXU_CHECKS and
    RECON_CHECKS, with and without dead rows; bq_mxu_block also with a
    cached x_pop of arbitrary values and q_planes / q_pop. Returns the
    number of shapes run."""
    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for b, n, w in MXU_CHECKS:
        q, x = words((b, w)), words((n, w))
        valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        xp = torch.from_numpy(rng.uniform(0, 32 * w, n).astype(np.float32)).to(dev)
        planes = K.bq_queries_to_planes(q, w)
        for kw in ({}, dict(valid=valid),
                   dict(valid=valid, x_pop=xp, q_planes=planes, q_pop=planes.float().sum(1))):
            _same_block(torch, K.bq_mxu_block(q, x, **kw), K.bq_mxu_block_plain(q, x, **kw),
                        f"bq_mxu_block [{b},{w}] x [{n},{w}] {sorted(kw)}")
    for b, n, m, kc, ds, top in RECON_CHECKS:
        q = torch.from_numpy(rng.standard_normal((b, m * ds)).astype(np.float32)).to(dev)
        cent = torch.from_numpy(rng.standard_normal((m, kc, ds)).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, top, (n, m)).astype(np.uint8)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        for metric in ("l2-squared", "dot", "cosine"):
            qm = torch.nn.functional.normalize(q, dim=1) if metric == "cosine" else q
            for v in (None, valid):
                _same_block(torch, K.pq4_recon_block(qm, codes, cent, metric, v),
                            K.pq4_recon_block_plain(qm, codes, cent, metric, v),
                            f"pq4_recon_block {metric} [{b},{m * ds}] x [{n},{m}] ds {ds} "
                            f"codes < {top} valid {v is not None}", tol=PQ_TOL)
    return len(MXU_CHECKS) + len(RECON_CHECKS)


def ham_checks(torch, K, rng, dev) -> int:
    """bq_hamming_block bit for bit against its plain version at
    HAM_CHECKS, and at UNALIGNED on a corpus whose base is 4 bytes past
    16-byte alignment (the kernel's 4-byte copies where W % 4 == 0 would
    take 16-byte ones). Returns the number of shapes run."""
    def words(count):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, count, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for b, n, w in HAM_CHECKS:
        q, x = words(b * w).reshape(b, w), words(n * w).reshape(n, w)
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block [{b},{w}] x [{n},{w}]")
    for b, n, w in UNALIGNED:
        q = words(b * w).reshape(b, w)
        x = words(n * w + 1)[1:].view(n, w)  # 4 bytes past the allocation's start
        if x.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned corpus is aligned")
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block unaligned [{b},{w}] x [{n},{w}]")
    return len(HAM_CHECKS) + len(UNALIGNED)


def ham_bound(b: int, n: int, w: int) -> tuple[float, str]:
    """bq_hamming_block's bound: the words and the f32 output once, against
    the reference kernel's 2*B*N*32W operations at the single-bit rate
    B1_OPS its MMAs run at: bound by the bytes."""
    return bound_ms((b + n) * w * 4 + b * n * 4, 2.0 * b * n * 32 * w, B1_OPS)


def _bit_planes(torch, words, dtype):
    """[R, W] sign words -> [R, 32W] 0/1 planes in bit-plane order (column
    j*W + word), built in slices of ADD_BATCH rows."""
    n, w = words.shape
    shifts = torch.arange(32, device=words.device)
    out = torch.empty((n, 32 * w), dtype=dtype, device=words.device)
    for s in range(0, n, ADD_BATCH):
        out[s:s + ADD_BATCH] = ((words[s:s + ADD_BATCH].long()[:, None, :]
                                 >> shifts[None, :, None]) & 1).reshape(-1, 32 * w)
    return out


def ham_yardsticks(torch, qw, xw, ham, timer) -> tuple[float | None, str]:
    """bq_hamming_block's two yardsticks at its main shape: the library
    call, torch.cdist(p=0) on the 0/1 f32 bit planes (the count of planes
    that differ: the same function, which must equal the kernel's answer
    to count), and the product alone, torch._int_mm of the 0/1 int8 planes.
    Returns (library ms or None, text)."""
    lib_ms, parts = None, []
    try:
        q01, x01 = _bit_planes(torch, qw, torch.float32), _bit_planes(torch, xw, torch.float32)
        cd = torch.cdist(q01, x01, p=0)
        if torch.equal(cd, ham):
            lib_ms = timer(lambda: torch.cdist(q01, x01, p=0), reps=2, warmup=0)
            parts.append(f"library torch.cdist(p=0) on the 0/1 f32 planes [{qw.shape[0]},"
                         f"{q01.shape[1]}] x [{x01.shape[0]},{x01.shape[1]}]: equal to the "
                         f"kernel, {lib_ms:.4f} ms")
        else:
            parts.append(f"library torch.cdist(p=0): {int((cd != ham).sum())} values differ "
                         "from the kernel's: not counted")
        del q01, x01, cd
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"library torch.cdist(p=0) failed: {str(e).splitlines()[0]}")
    torch.cuda.empty_cache()
    try:
        q01, x01 = _bit_planes(torch, qw, torch.int8), _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(q01, x01.t()), reps=5)
        parts.append(f"the product alone, torch._int_mm [{qw.shape[0]},{q01.shape[1]}] x "
                     f"[{q01.shape[1]},{x01.shape[0]}] 0/1 int8: {ms:.4f} ms")
        del q01, x01
    except RuntimeError as e:
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    torch.cuda.empty_cache()
    return lib_ms, "; ".join(parts)


def mxu_bound(b: int, n: int, w: int) -> tuple[float, str]:
    """bq_mxu_block's bound: the words, the query popcounts, valid and the
    bf16 output once, against the reference kernel's cost estimate
    (2*B*N*32W, the 0/1 product) at the single-bit rate B1_OPS its MMAs
    run at, as bq_scan_reduce's: bound by the bytes."""
    return bound_ms((b + n) * w * 4 + b * 4 + n + b * n * 2, 2.0 * b * n * 32 * w, B1_OPS)


def _block_kernels(torch, K, ops, qs, rng, timer) -> tuple[dict, dict]:
    """The four block kernels against their plain versions on the card:
    ragged shapes (B = 1, 5, 256; N off every tile; W = 3 and 48; m = 24
    and 384; k = 12 and 16; LUT_CHECKS, MXU_CHECKS, RECON_CHECKS), then
    the main path's: 256 queries x the 1M-row corpus's sign words (W = 24)
    and 4-bit PQ codes (m = 192, ds = 4) from _scan_reduce_kernels, with
    ~10% dead rows; then bq_mxu_block at the shapes of tools/probe_r4.py.
    The bq kernels and pq4_lut_block must equal their plain versions bit
    for bit, pq4_recon_block within PQ_TOL. Returns the numbers and the
    launch counts of this window."""
    from weaviate_tpu_torch.ops.bq import bq_hamming_np

    dev = qs.device
    out = {}
    t0 = time.perf_counter()
    K.reset_launch_counts()  # the block kernels' window starts here

    def words(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def dead10(n):
        return torch.from_numpy(rng.random(n) > 0.1).to(dev)

    def popcounts(x):
        return K.popcount32(x.to(torch.int64) & 0xFFFFFFFF).sum(dim=1).float()

    ragged = 0
    for b, n, w in [(1, 1001, 3), (5, 70001, 48), (256, 4099, 3), (256, 9001, 48)]:
        q, x, valid = words((b, w)), words((n, w)), dead10(n)
        _same_block(torch, K.bq_hamming_block(q, x), K.bq_hamming_block_plain(q, x),
                    f"bq_hamming_block ragged [{b},{w}] x [{n},{w}]")
        # a caller's cached popcounts are used as given: any f32 values
        xp = torch.from_numpy(rng.uniform(0, 32 * w, n).astype(np.float32)).to(dev)
        planes = K.bq_queries_to_planes(q, w)
        for kw in ({}, dict(valid=valid),
                   dict(valid=valid, x_pop=xp, q_planes=planes, q_pop=planes.float().sum(1))):
            _same_block(torch, K.bq_mxu_block(q, x, **kw), K.bq_mxu_block_plain(q, x, **kw),
                        f"bq_mxu_block ragged [{b},{w}] x [{n},{w}] {sorted(kw)}")
        ragged += 1
    for b, n, m, kc, ds in [(1, 1001, 24, 12, 4), (5, 70001, 384, 16, 2),
                            (256, 4099, 24, 12, 4), (256, 9001, 384, 16, 2)]:
        lut, valid = randn(b, m, kc, scale=3.0), dead10(n)
        codes = torch.from_numpy(rng.integers(0, 16, (n, m)).astype(np.uint8)).to(dev)
        for v in (None, valid):
            _same_block(torch, K.pq4_lut_block(lut, codes, v), K.pq4_lut_block_plain(lut, codes, v),
                        f"pq4_lut_block ragged [{b},{m},{kc}] x [{n},{m}]")
        q, cent = randn(b, m * ds), randn(m, kc, ds)
        for metric in ("l2-squared", "dot", "cosine"):
            qm = torch.nn.functional.normalize(q, dim=1) if metric == "cosine" else q
            _same_block(torch, K.pq4_recon_block(qm, codes, cent, metric, valid),
                        K.pq4_recon_block_plain(qm, codes, cent, metric, valid),
                        f"pq4_recon_block ragged {metric} [{b},{m * ds}] x [{n},{m}] ds {ds}",
                        tol=PQ_TOL)
        ragged += 1
    lut_cases = lut_checks(torch, K, rng, dev)
    mr_cases = mxu_recon_checks(torch, K, rng, dev)
    ham_cases = ham_checks(torch, K, rng, dev)

    # the main path's shapes: 256 queries x 1,048,576 rows, 768 dims
    qw, xw = ops["qw"], ops["xw"]
    (b, w), n = qw.shape, xw.shape[0]
    valid = dead10(n)
    ham = K.bq_hamming_block(qw, xw)
    _same_block(torch, ham, K.bq_hamming_block_plain(qw, xw), f"bq_hamming_block [{b},{w}] x [{n}]")
    np_rows = 512  # numpy's unpacked bits of [B, np_rows, W] words stay at 100 MB
    want = bq_hamming_np(qw.cpu().numpy().view(np.uint32),
                         xw[:np_rows].cpu().numpy().view(np.uint32))
    if not np.array_equal(ham[:, :np_rows].cpu().numpy(), want):
        raise AssertionError("bq_hamming_block differs from bq_hamming_np")
    mxu = K.bq_mxu_block(qw, xw, valid=valid)
    _same_block(torch, mxu, K.bq_mxu_block_plain(qw, xw, valid=valid),
                f"bq_mxu_block [{b},{w}] x [{n}]")
    # past 256 bits bf16 rounds: live rows are bf16(exact hamming)
    if not torch.equal(mxu[:, valid], ham[:, valid].to(torch.bfloat16)):
        raise AssertionError("bq_mxu_block is not bf16(exact hamming) on the live rows")
    planes = K.bq_queries_to_planes(qw, w)
    cached = K.bq_mxu_block(qw, xw, popcounts(xw), valid, planes, planes.float().sum(1))
    if not torch.equal(cached, mxu):
        raise AssertionError("bq_mxu_block with cached x_pop and q_planes differs")
    del mxu, cached
    b_ms, b_by = ham_bound(b, n, w)
    ham_ms = timer(lambda: K.bq_hamming_block(qw, xw), reps=10)
    ham_lib_ms, ham_yard = ham_yardsticks(torch, qw, xw, ham, timer)
    del ham
    out["bq_hamming_block"] = dict(
        max_abs_err=0.0, ms=ham_ms,
        plain_ms=timer(lambda: K.bq_hamming_block_plain(qw, xw), reps=1, warmup=0),
        library_ms=ham_lib_ms, bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = mxu_bound(b, n, w)
    out["bq_mxu_block"] = dict(
        max_abs_err=0.0, ms=timer(lambda: K.bq_mxu_block(qw, xw, valid=valid), reps=10),
        plain_ms=timer(lambda: K.bq_mxu_block_plain(qw, xw, valid=valid), reps=1, warmup=0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # the probe shapes, kernel only, equal to the plain version on the first rows
    probe = []
    for pb, pw in PROBE_SHAPES:
        q2, x2 = words((pb, pw)), words((n, pw))
        head = 65_536
        _same_block(torch, K.bq_mxu_block(q2, x2)[:, :head], K.bq_mxu_block_plain(q2, x2[:head]),
                    f"bq_mxu_block probe [{pb},{pw}] x [{n}]")
        probe.append(f"[{pb},{pw} words] x [{n},{pw}] "
                     f"{timer(lambda: K.bq_mxu_block(q2, x2), reps=5):.3f} ms")
        del q2, x2
        torch.cuda.empty_cache()

    codes, lut, cent = ops["codes"], ops["lut"], ops["centroids"]
    m = cent.shape[0]
    _same_block(torch, K.pq4_lut_block(lut, codes, valid), K.pq4_lut_block_plain(lut, codes, valid),
                f"pq4_lut_block [{b},{m},16] x [{n},{m}]")
    qn = torch.nn.functional.normalize(qs, dim=1)
    err = 0.0
    for metric in ("l2-squared", "dot", "cosine"):
        err = max(err, _same_block(
            torch, K.pq4_recon_block(qn, codes, cent, metric, valid),
            K.pq4_recon_block_plain(qn, codes, cent, metric, valid),
            f"pq4_recon_block {metric} [{b},{DIM}] x [{n},{m}]", tol=PQ_TOL))
    lt = lut_time(torch, K, lut, codes, valid, timer)
    onehot = lt.pop("onehot_ms")
    out["pq4_lut_block"] = lt
    # operations: the distance product only; the reconstruction is a gather
    b_ms, b_by = bound_ms(qn.numel() * 4 + codes.numel() + cent.numel() * 4 + n + b * n * 2,
                          2.0 * b * n * DIM, BF16_FLOPS)
    out["pq4_recon_block"] = dict(
        max_abs_err=err, ms=timer(lambda: K.pq4_recon_block(qn, codes, cent, METRIC, valid),
                                  reps=5),
        plain_ms=timer(lambda: K.pq4_recon_block_plain(qn, codes, cent, METRIC, valid),
                       reps=1, warmup=0),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    counts = dict(K.launch_counts)
    for name in PHASE2_PATH:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched in phase 2")
    o = out
    log(f"phase 2 kernels: block kernels, {ragged // 2} ragged shapes each, then "
        f"[{b},{w} words] x [{n},{w}] with ~10% dead rows: bq_hamming_block equal to the plain "
        f"version and to bq_hamming_np (first {np_rows} rows), also at {ham_cases} more "
        f"shapes (HAM_CHECKS, UNALIGNED: W = 1 / 3 / 8 / 9 / 24 / 25 / 33 and the popcount "
        f"body's 120 / 200, B = 1 / 8 / 129 / 256, N = 1 / 63 / 65 / 9001, a base off 16-byte "
        f"alignment), kernel (query block {K.bq_hamming_qblock(b, w)}) "
        f"{o['bq_hamming_block']['ms']:.3f} ms, plain {o['bq_hamming_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['bq_hamming_block'])}; {ham_yard}; bq_mxu_block equal to the plain version and "
        f"to bf16(exact hamming) on the live rows, also with cached x_pop / q_planes, kernel "
        f"{o['bq_mxu_block']['ms']:.3f} ms, plain {o['bq_mxu_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['bq_mxu_block'])}; at the probe shapes {', '.join(probe)}; "
        f"bq_mxu_block and pq4_recon_block also at {mr_cases} more shapes (MXU_CHECKS, "
        f"RECON_CHECKS: W = 1 / 8 / 9 / 200, B = 8 / 129 / 1024; ds = 1 / 2 / 3 / 8, d off "
        f"16, codes past 15, the FFMA body at d = 1024)")
    log(f"phase 2 kernels: lut [{b},{m},16] x codes [{n},{m}] with ~10% dead rows: "
        f"pq4_lut_block equal to the plain version there and at {lut_cases} more cases "
        f"(LUT_CHECKS: ragged m up to 4100, codes past 15, subnormal / -0.0 / infinite "
        f"entries, dead rows), kernel "
        f"{o['pq4_lut_block']['ms']:.3f} ms, plain {o['pq4_lut_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['pq4_lut_block'])} (the exact sum's FADDs), the one-hot "
        f"product at the bf16 rate {onehot:.3f} ms; "
        f"pq4_recon_block l2/dot/cosine within "
        f"{PQ_TOL} x max(1, max|ref|) (max_abs_err {err:.3g}), {METRIC} kernel "
        f"{o['pq4_recon_block']['ms']:.3f} ms, plain {o['pq4_recon_block']['plain_ms']:.3f} ms, "
        f"{_bound_text(o['pq4_recon_block'])}; library {NO_LIBRARY}; launches in this window "
        f"{ {k: counts[k] for k in out} }; block kernels' checks and timings "
        f"{time.perf_counter() - t0:.1f} s")
    return out, counts


def _exact_distances(torch, qn, ref, mask):
    """Plain recomputation (TF32 off): exact cosine distances of unit
    queries ``qn`` to unit rows ``ref``; rows outside ``mask`` are inf."""
    d = 1.0 - qn @ ref.T
    return torch.where(mask, d, torch.full_like(d, float("inf")))


def _check_against_exact(torch, d_full, got_ids, k, what):
    got = torch.from_numpy(np.asarray(got_ids, dtype=np.int64)).to(d_full.device)
    if bool((got < 0).any()):
        raise AssertionError(f"{what}: fewer than {k} results")
    dg = torch.gather(d_full, 1, got)
    kd = torch.topk(d_full, k, dim=1, largest=False)[0][:, -1]
    if not bool(torch.isfinite(dg).all()):
        raise AssertionError(f"{what}: returned a deleted or disallowed row")
    r = recall(got.cpu().numpy(), dg.cpu().numpy(), kd.cpu().numpy(), k)
    if r != 1.0:
        raise AssertionError(f"{what}: recall@{k} {r}")
    return r


def phase_index(torch, seed: int, rows: int) -> dict:
    """Phase 3. Returns its index, rows (host and unit rows on the card),
    queries and deleted rows, which phase 10's epoch index is held to."""
    from weaviate_tpu_torch.engine.flat import FlatIndex

    dev = "cuda"
    rng = np.random.default_rng([seed, 3])
    idx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK, device=dev)
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    corpus = np.empty((rows, DIM), dtype=np.float32)
    t0 = time.perf_counter()
    for s in range(0, rows, ADD_BATCH):
        v = corpus_batch(seed, s, min(ADD_BATCH, rows - s))
        corpus[s:s + len(v)] = v
        idx.add_batch(np.arange(s, s + len(v)), v)
        ref[s:s + len(v)] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
    idx.store.flush_staged()
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    deleted = rng.choice(rows, 10_000, replace=False)
    idx.delete(*deleted.tolist())
    live = torch.ones(rows, dtype=torch.bool, device=dev)
    live[torch.from_numpy(deleted).to(dev)] = False
    deleted_set = set(deleted.tolist())
    queries = near_queries(seed, rng.integers(0, rows, QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    qn_all = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    parts = [f"add {rows} rows in {add_s:.1f} s ({rows / add_s:.0f} rows/s), "
             f"capacity {idx.store.capacity}, 10000 deleted"]
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        times = []
        for s in range(0, QUERIES, BATCH):
            qb = queries[s:s + BATCH]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, _d = idx.search_by_vector_batch_async(qb, TOP_K).result()
            times.append((time.perf_counter() - t1) * 1e3)
            if deleted_set.intersection(ids.ravel().tolist()):
                raise AssertionError(f"{selection}: a deleted id was returned")
            d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref,
                                      live[None, :])
            for k in (10, TOP_K):
                _check_against_exact(torch, d_full, ids[:, :k], k,
                                     f"index {selection} recall@{k}")
            del d_full
        parts.append(f"{selection}: recall@10 1.0, recall@100 1.0, "
                     f"{np.median(times):.1f} ms per {BATCH}-query batch (median of "
                     f"{len(times)}, host clock)")
        # per-query filters at 10% selectivity (bitmask-batched path)
        nq = 64
        masks = rng.random((nq, rows)) < 0.10
        qb = queries[:nq]
        ids, _d = idx.search_by_vector_batch_async(qb, 10, [m for m in masks]).result()
        allowed = torch.from_numpy(masks).to(dev) & live[None, :]
        d_full = _exact_distances(torch, qn_all[:nq], ref, allowed)
        _check_against_exact(torch, d_full, ids, 10, f"{selection} per-query 10% filter")
        # one shared filter at 0.5% (gathered path)
        shared = rng.choice(rows, rows // 200, replace=False)
        h = idx.store.search_async(qb, 10, idx._allow_mask(shared))
        if h.attrs["path"] != "gathered":
            raise AssertionError("0.5% shared filter did not take the gathered path")
        h.result()
        ids2, _d = idx.search_by_vector_batch(qb, 10, shared)
        smask = torch.zeros(rows, dtype=torch.bool, device=dev)
        smask[torch.from_numpy(shared).to(dev)] = True
        d_full = _exact_distances(torch, qn_all[:nq], ref, (smask & live)[None, :])
        _check_against_exact(torch, d_full, ids2, 10, f"{selection} shared 0.5% filter")
    log(f"phase 3 index: FlatIndex(device='cuda') {rows} x {DIM} {METRIC} f32; "
        + "; ".join(parts) + "; per-query 10% filters (bitmask) and a shared 0.5% "
        "filter (gathered) recall@10 1.0 for both selections")
    idx.store.selection = "approx"
    return dict(idx=idx, ref=ref, corpus=corpus, queries=queries, deleted=deleted)


def _collection(db, name: str, quantization: str | None = None):
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  VectorConfig, VectorIndexConfig)

    return db.create_collection(CollectionConfig(
        name=name,
        properties=[Property(name="category", data_type="text"),
                    Property(name="views", data_type="int")],
        vectors=[VectorConfig(index=VectorIndexConfig(
            index_type="flat", metric=METRIC, quantization=quantization))]))


def _uuid(prefix: int, row: int) -> str:
    return f"00000000-0000-4000-{prefix:04d}-{row:012d}"


def _import(torch, col, seed: int, rows: int, prefix: int, rng, budget_s: float):
    """batch_put ``rows`` objects of clustered vectors (cut when the time
    budget runs out). Returns (unit rows on the card, views, count, s)."""
    dev = "cuda"
    cent = centers(seed)
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    views = np.empty(rows, dtype=np.int64)
    t0 = time.perf_counter()
    done = 0
    while done < rows and time.perf_counter() - t0 < budget_s:
        n = min(IMPORT_BATCH, rows - done)
        v = clustered(seed, done, n, cent)
        vw = rng.integers(0, 100, n)
        res = col.batch_put([
            {"uuid": _uuid(prefix, done + i),
             "properties": {"category": f"cat{(done + i) % 100}", "views": int(vw[i])},
             "vector": v[i]} for i in range(n)])
        if any(r["status"] != "SUCCESS" for r in res):
            raise AssertionError(f"batch_put failed: {res[0]}")
        ref[done:done + n] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
        views[done:done + n] = vw
        done += n
    return ref[:done], views[:done], done, time.perf_counter() - t0


def _row_of(r) -> int:
    return int(r.uuid.rsplit("-", 1)[1])


def _run_clients(ask, nq: int):
    """CLIENTS threads, client c asking queries c, c + CLIENTS, ...;
    returns (answers, latencies ms, wall s)."""
    out = [None] * nq
    lat = [0.0] * nq
    errors = []

    def client(c):
        try:
            for i in range(c, nq, CLIENTS):
                t2 = time.perf_counter()
                out[i] = ask(i)
                lat[i] = (time.perf_counter() - t2) * 1e3
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"client errors: {errors[:1]}")
    return out, lat, wall


def _latency_stats(nq, lat, wall) -> str:
    lat_u, lat_f = np.asarray(lat[0::2]), np.asarray(lat[1::2])
    return (f"{nq / wall:.1f} QPS, p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms (unfiltered p50 "
            f"{np.percentile(lat_u, 50):.1f} ms, filtered p50 {np.percentile(lat_f, 50):.1f} ms)")


def _filter_mask(torch, n_res, live, views_t):
    """[n_res, rows] rows each query may return: odd queries carry the
    where(views >= VIEWS_CUT) filter."""
    odd = torch.arange(n_res, device=live.device)[:, None] % 2 == 1
    return live[None, :] & (~odd | (views_t[None, :] >= VIEWS_CUT))


@contextlib.contextmanager
def _host_packed_masks(K):
    """Swap the flat store's mask packer for the host (numpy) one the
    store used before packing moved to the card."""
    from weaviate_tpu_torch.engine import store as S

    card = S.batched_mask_operands

    def host_packed(allow_mask, n_queries, capacity, device, owner=None, mesh=None):
        with S.tracing.span("store.mask_pack", queries=n_queries):
            return K.as_bits_tensor(
                K.pack_allow_bitmask(allow_mask, K.mask_pad_cols(capacity)), device)

    S.batched_mask_operands = host_packed
    try:
        yield
    finally:
        S.batched_mask_operands = card


def _mask_pack_check(torch, K, shard, idx, where, rng) -> str:
    """The card packer's words against numpy's on phase 4's filter (each
    query's slot mask ANDed with a random 50% row), bit for bit, at B = 1,
    8 and 64, and what each way takes: numpy's pack (+ the upload of the
    words) against the upload of the bool rows + the card's pack."""
    from weaviate_tpu_torch.engine import store as S

    cap = idx.store.capacity
    n_cols = K.mask_pad_cols(cap)
    t0 = time.perf_counter()
    doc_mask = shard.allow_mask(where)
    eval_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    slot_mask = idx._allow_mask(doc_mask)
    translate_ms = (time.perf_counter() - t0) * 1e3
    parts = [f"where() evaluated in {eval_ms:.1f} ms, translated to {cap} store slots in "
             f"{translate_ms:.1f} ms"]
    for b in (1, 8, 64):
        rows = slot_mask[None, :] & (rng.random((b, cap)) < 0.5)
        want = K.pack_allow_bitmask(rows, n_cols)
        got = S.batched_mask_operands(rows, b, cap, "cuda")
        if not np.array_equal(got.cpu().numpy().view(np.uint32), want):
            raise AssertionError(f"card-packed allow words != numpy's at B = {b}")
        host, card = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            K.as_bits_tensor(K.pack_allow_bitmask(rows, n_cols), "cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            S.batched_mask_operands(rows, b, cap, "cuda")
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            card.append((time.perf_counter() - t1) * 1e3)
        parts.append(f"B = {b}: bit for bit; numpy pack + upload {np.median(host):.2f} ms, "
                     f"upload + card pack {np.median(card):.2f} ms")
    return "; ".join(parts)


def phase_end_to_end(torch, K, seed: int, rows: int, db) -> tuple[dict, dict]:
    """Returns phase 4's launch counts and the live collection's state,
    which phase 6 compresses and queries again."""
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    rng = np.random.default_rng([seed, 4])
    col = _collection(db, "Wiki")
    ref, views, done, import_s = _import(torch, col, seed + 1, rows, 8000, rng,
                                         IMPORT_BUDGET_S)
    cut = "" if done == rows else (
        f" (cut from {rows}: the import budget of {IMPORT_BUDGET_S:.0f} s ran out)")
    if col.object_count() != done:
        raise AssertionError(f"object_count {col.object_count()} != {done}")
    shard = next(iter(col.shards.values()))
    idx = shard.vector_indexes[""]
    live = torch.ones(done, dtype=torch.bool, device=dev)
    views_t = torch.from_numpy(views).to(dev)
    nq = CLIENTS * PLAIN_CALLS
    queries = near_queries(seed + 1, rng.integers(0, done, nq),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    qn = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)

    def ask(i):
        return col.near_vector(queries[i], k=10, where=where if i % 2 else None,
                               include_objects=False)

    def check_exact(results, what):
        """results[i] answers query i; odd queries carry the filter."""
        n_res = len(results)
        mask = _filter_mask(torch, n_res, live, views_t)
        for s in range(0, n_res, BATCH):
            d_full = _exact_distances(torch, qn[s:min(s + BATCH, n_res)], ref,
                                      mask[s:s + BATCH])
            got = [[_row_of(r) for r in res] for res in results[s:s + BATCH]]
            _check_against_exact(torch, d_full, got, 10, what)

    pack_text = _mask_pack_check(torch, K, shard, idx, where, rng)
    K.reset_launch_counts()  # the main path's run starts here
    timings = {}
    t1 = time.perf_counter()
    shard.dynamic_batching = False
    serial = [ask(i) for i in range(nq)]  # selection "approx", one at a time
    timings["serial"] = time.perf_counter() - t1
    check_exact(serial, "end to end serial")
    shard.dynamic_batching = True
    stats = []
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        out, lat, wall = _run_clients(ask, nq)
        for a, b in zip(serial, out):
            if [r.uuid for r in a] != [r.uuid for r in b]:
                raise AssertionError(f"{selection}: concurrent result != serial path")
        check_exact(out, f"end to end {selection}")
        stats.append(f"{selection}: {_latency_stats(nq, lat, wall)}")
    # the same approx run with the filter words packed on the host, as
    # before the card packer: the filtered p50 before and after, one call
    idx.store.selection = "approx"
    with _host_packed_masks(K):
        out, lat, wall = _run_clients(ask, nq)
    for a, b in zip(serial, out):
        if [r.uuid for r in a] != [r.uuid for r in b]:
            raise AssertionError("host-packed: concurrent result != serial path")
    stats.append(f"approx with the words packed on the host (numpy, as before): "
                 f"{_latency_stats(nq, lat, wall)}")
    batcher = shard._query_batchers[""]
    # deletes, then queries again through the batcher, both selections
    gone = rng.choice(done, DELETES, replace=False)
    t1 = time.perf_counter()
    for r in gone:
        if not col.delete_object(_uuid(8000, int(r))):
            raise AssertionError("delete_object returned False")
    timings["deletes"] = time.perf_counter() - t1
    live[torch.from_numpy(gone).to(dev)] = False
    gone_set = set(gone.tolist())
    for selection in ("approx", "fused"):
        idx.store.selection = selection
        again = [ask(i) for i in range(REQUERIES)]
        if any(_row_of(r) in gone_set for res in again for r in res):
            raise AssertionError("a deleted object was returned")
        check_exact(again, f"after deletes {selection}")
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 4 end to end: Database(device='cuda') flat {METRIC} collection, "
        f"batch_put {done} objects{cut} in {import_s:.1f} s "
        f"({done / import_s:.0f} objects/s, native host library {_native_state()}); serial path {nq} near_vector(k=10) in "
        f"{timings['serial']:.1f} s; {CLIENTS} clients x {PLAIN_CALLS} near_vector(k=10), "
        f"half where(views >= {VIEWS_CUT}, values 0..99): "
        + "; ".join(stats)
        + f"; equal to the serial path and recall@10 1.0 vs the plain recomputation; "
        f"{batcher.dispatches} batched dispatches for {batcher.batched_queries} "
        f"queries ({batcher.async_dispatches} async); {DELETES} deleted in "
        f"{timings['deletes']:.1f} s, {REQUERIES} queries per selection again, none "
        f"returned; launches {counts}; filter words: {pack_text}")
    for name in ("distance_block", "fused_topk_scan", "fused_topk_pairs"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    idx.store.selection = "approx"
    return counts, dict(col=col, ref=ref, live=live, views=views_t)


def _check_quantized(torch, d_full, ids, dists, k: int, what: str) -> float:
    """A quantized answer: every id live and allowed (a finite exact
    distance), every returned distance the exact one (the store rescored
    it), and recall@k against the exact top-k, which is returned."""
    got = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(d_full.device)
    if bool((got < 0).any()):
        raise AssertionError(f"{what}: fewer than {k} results")
    dg = torch.gather(d_full, 1, got)
    if not bool(torch.isfinite(dg).all()):
        raise AssertionError(f"{what}: returned a deleted or disallowed row")
    dt = torch.from_numpy(np.asarray(dists, dtype=np.float32)).to(d_full.device)
    if not torch.allclose(dt, dg, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: a returned distance is not its exact distance "
                             f"(max error {(dt - dg).abs().max().item():.3g})")
    kd = torch.topk(d_full, k, dim=1, largest=False)[0][:, -1]
    return recall_at_k(dg.cpu().numpy(), kd.cpu().numpy(), k)


QUANT_INDEXES = {"bq": {"quantization": "bq"},
                 "bq+prefix128": {"quantization": "bq", "prefix_bits": 128},
                 "pq4": {}}  # built plain, then compress("pq")


def _require_launched(counts: dict, phase: int) -> None:
    for name in QUANT_KERNELS[phase]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase {phase}")


def phase_quantized_index(torch, K, seed: int, rows: int) -> dict:
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.ops.distances import normalize_np

    dev = "cuda"
    rng = np.random.default_rng([seed, 5])
    # made once on the host (3 GB at 1M rows) and added to all three indexes
    corpus = np.concatenate([corpus_batch(seed, s, min(ADD_BATCH, rows - s))
                             for s in range(0, rows, ADD_BATCH)])
    ref = torch.empty((rows, DIM), dtype=torch.float32, device=dev)
    for s in range(0, rows, ADD_BATCH):
        ref[s:s + ADD_BATCH] = torch.nn.functional.normalize(
            torch.from_numpy(corpus[s:s + ADD_BATCH]).to(dev), dim=1)
    deleted = rng.choice(rows, 10_000, replace=False)
    deleted_set = set(deleted.tolist())
    live = torch.ones(rows, dtype=torch.bool, device=dev)
    live[torch.from_numpy(deleted).to(dev)] = False
    queries = near_queries(seed, rng.integers(0, rows, QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                           NEAR_NOISE)
    qn_all = torch.nn.functional.normalize(torch.from_numpy(queries).to(dev), dim=1)
    masks = rng.random((64, rows)) < 0.10
    allowed = torch.from_numpy(masks).to(dev) & live[None, :]
    parts = []
    K.reset_launch_counts()  # phase 5's run starts here
    timing_launches = dict.fromkeys(K.launch_counts, 0)  # the scan timed alone
    for name, kw in QUANT_INDEXES.items():
        t0 = time.perf_counter()
        idx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK, device=dev, **kw)
        for s in range(0, rows, ADD_BATCH):
            v = corpus[s:s + ADD_BATCH]
            idx.add_batch(np.arange(s, s + len(v)), v)
        train = ""
        if not kw:
            idx.store.flush_staged()
            t1 = time.perf_counter()
            idx.compress("pq")  # 16 centroids, m = 192: trained and encoded on the card
            torch.cuda.synchronize()
            train = f" (compress('pq') {time.perf_counter() - t1:.1f} s)"
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = idx.store
        idx.delete(*deleted.tolist())
        runs = []
        for selection, k in (("approx", 10), ("approx", TOP_K), ("fused", 10)):
            st.selection = selection
            times, scans, recs = [], [], []
            for s in range(0, QUERIES, BATCH):
                qb = queries[s:s + BATCH]
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ids, d = idx.search_by_vector_batch_async(qb, k).result()
                times.append((time.perf_counter() - t1) * 1e3)
                if deleted_set.intersection(ids.ravel().tolist()):
                    raise AssertionError(f"{name} {selection}: a deleted id was returned")
                d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref, live[None, :])
                recs.append(_check_quantized(torch, d_full, ids, d, k,
                                             f"{name} {selection} k={k}"))
                del d_full
                # the compressed scan alone on the same batch, host clock
                qd = torch.from_numpy(normalize_np(qb)).to(dev)
                before = dict(K.launch_counts)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st._scan(qd, min(k * st.rescore_limit, st.capacity), st.valid)
                torch.cuda.synchronize()
                scans.append((time.perf_counter() - t1) * 1e3)
                for kn, c in K.launch_counts.items():  # a yardstick, not the path
                    timing_launches[kn] += c - before[kn]
            r = float(np.mean(recs))
            if k == 10 and r < RECALL_FLOOR[name]:
                raise AssertionError(f"{name} {selection}: recall@10 {r:.4f} below the "
                                     f"floor {RECALL_FLOOR[name]}")
            t_med, s_med = float(np.median(times)), float(np.median(scans))
            split = ""
            if selection == "approx":
                before = dict(K.launch_counts)
                split = "; " + _rescore_split(torch, idx, queries[:BATCH], k)
                for kn, c in K.launch_counts.items():  # a measurement, not the path
                    timing_launches[kn] += c - before[kn]
            runs.append(f"{selection} k={k}: recall@{k} {r:.4f}, {t_med:.1f} ms per "
                        f"{BATCH}-query batch, scan {s_med:.1f} ms ({s_med / t_med:.0%})"
                        + split)
        st.selection = "approx"
        # what a path that has lost its oversampling reads: rescore_limit 1
        # hands the exact rescore only the scan's best k candidates
        limit, st.rescore_limit, recs = st.rescore_limit, 1, []
        for s in range(0, QUERIES, BATCH):
            ids, d = idx.search_by_vector_batch_async(queries[s:s + BATCH], 10).result()
            d_full = _exact_distances(torch, qn_all[s:s + BATCH], ref, live[None, :])
            recs.append(_check_quantized(torch, d_full, ids, d, 10, f"{name} rescore_limit 1"))
        st.rescore_limit = limit
        nq = len(masks)
        ids, d = idx.search_by_vector_batch_async(queries[:nq], 10, list(masks)).result()
        d_full = _exact_distances(torch, qn_all[:nq], ref, allowed)
        rf = _check_quantized(torch, d_full, ids, d, 10, f"{name} per-query 10% filters")
        parts.append(f"{name}: built in {build_s:.1f} s{train}; " + "; ".join(runs)
                     + f"; {nq} queries with per-query 10% filters: recall@10 {rf:.4f}; "
                     f"with rescore_limit 1 (floor {RECALL_FLOOR[name]}): recall@10 "
                     f"{float(np.mean(recs)):.4f}")
        del idx, st, d_full
        torch.cuda.empty_cache()
    counts = {kn: c - timing_launches[kn]  # ... and ends here
              for kn, c in K.launch_counts.items()}
    log(f"phase 5 quantized index: FlatIndex(device='cuda') {rows} x {DIM} {METRIC}, "
        f"10000 deleted, {QUERIES} queries through search_by_vector_batch_async (times "
        f"median by host clock; the scan's share is the compressed scan alone on the same "
        f"batch), every returned id at its exact distance, none deleted or disallowed: "
        + " | ".join(parts) + f"; launches {counts}")
    _require_launched(counts, 5)
    return counts


def _reference_rescore(hv, q, cand, k: int, metric: str, cap: int):
    """The exact host rescore as the reference writes it (the JAX
    package's ``QuantizedVectorStore._host_rescore``): one gather of every
    candidate row, one einsum, the mask, argpartition and a stable
    argsort. Returns ((out_d, out_i), [gather, distance, select] seconds)."""
    b, kc = cand.shape
    t0 = time.perf_counter()
    rows = hv[np.clip(cand, 0, cap - 1).reshape(-1)].reshape(b, kc, -1)
    t1 = time.perf_counter()
    if metric == "dot":
        dd = -np.einsum("bd,bkd->bk", q, rows)
    elif metric in ("cosine", "cosine-dot"):
        dd = 1.0 - np.einsum("bd,bkd->bk", q, rows)
    else:
        diff = q[:, None, :] - rows
        dd = np.einsum("bkd,bkd->bk", diff, diff)
    dd = np.where(cand >= 0, dd, np.float32(3.0e38))
    t2 = time.perf_counter()
    k_eff = min(k, kc)
    part = np.argpartition(dd, k_eff - 1, axis=1)[:, :k_eff]
    sel = np.take_along_axis(part, np.argsort(np.take_along_axis(dd, part, axis=1), axis=1,
                                              kind="stable"), axis=1)
    out_d = np.take_along_axis(dd, sel, axis=1).astype(np.float32)
    out_i = np.where(out_d >= np.float32(3.0e38), -1, np.take_along_axis(cand, sel, axis=1))
    return (out_d, out_i), [t1 - t0, t2 - t1, time.perf_counter() - t2]


def _rescore_split(torch, idx, qb, k: int) -> str:
    """One batch's exact host rescore before and after this slice's
    threads, on the same candidates (the store's own scan of the batch):
    the reference's arrangement, timed here (_reference_rescore), against
    the store's, read from its spans under a forced trace
    (``store.host_rescore.rows`` with the threads' summed gather and
    distance times, ``store.host_rescore.select``); host clock, median of
    3 each. The answers must be equal bit for bit."""
    from weaviate_tpu_torch.runtime import tracing

    st = idx.store
    q = st._maybe_norm(np.asarray(qb, dtype=np.float32))
    k_cand = min(max(k * st.rescore_limit, k), st.capacity)
    cand = st._scan(torch.from_numpy(q).to(st.device), k_cand, st.valid)[1]
    cand = cand.cpu().numpy().astype(np.int64)
    before, after = [], []
    for _ in range(3):
        want, secs = _reference_rescore(st._host_vectors, q, cand, k, st.metric, st.capacity)
        before.append([t * 1e3 for t in secs])
        with tracing.trace("chip_smoke.rescore", force=True):
            tr = tracing.capture()[0]
            got = st._host_rescore(q, cand, k)
        spans = {sp["name"]: sp for sp in tr.to_dict()["spans"]}
        rows = spans["store.host_rescore.rows"]
        after.append([rows["duration_ms"], spans["store.host_rescore.select"]["duration_ms"],
                      rows["attrs"]["gather_ms"], rows["attrs"]["distance_ms"],
                      rows["attrs"]["blocks"]])
        if not all(np.array_equal(a, b) for a, b in zip(want, got)):
            raise AssertionError("the host rescore differs from the reference's arithmetic")
    bm, am = np.median(before, axis=0), np.median(after, axis=0)
    return (f"host rescore of {cand.shape[1]} candidates a query: reference arrangement "
            f"{bm.sum():.1f} ms (gather {bm[0]:.1f}, distance {bm[1]:.1f}, select "
            f"{bm[2]:.1f}), the store {am[0] + am[1]:.1f} ms (gather + distance "
            f"{am[0]:.1f} in {am[4]:.0f} blocks on host threads, whose summed gather is "
            f"{am[2]:.1f} and distance {am[3]:.1f}; select {am[1]:.1f}), equal bit for bit")


def _quantized_clients(torch, col, ref, live, views_t, queries, where, what: str) -> str:
    """CLIENTS threads of near_vector(k=10), half filtered, through the
    shard's batcher, held to the serial path, to exact distances and to
    RECALL_FLOOR[what]."""
    shard = next(iter(col.shards.values()))
    nq = len(queries)
    qn = torch.nn.functional.normalize(torch.from_numpy(queries).to(ref.device), dim=1)

    def ask(i, k=10):
        return col.near_vector(queries[i], k=k, where=where if i % 2 else None,
                               include_objects=False)

    # the batcher pads k to a power of two (10 -> 16) and the store
    # oversamples rescore_limit x k candidates: the serial path that gives
    # the batcher's answers is the one asked for k = 16
    shard.dynamic_batching = False
    t1 = time.perf_counter()
    answers = [ask(i, 16)[:10] for i in range(nq)]
    serial_s = time.perf_counter() - t1
    shard.dynamic_batching = True
    out, lat, wall = _run_clients(ask, nq)
    for a, b in zip(answers, out):
        if [r.uuid for r in a] != [r.uuid for r in b]:
            raise AssertionError(f"{what}: concurrent result != serial path")
    mask = _filter_mask(torch, nq, live, views_t)
    recs = []
    for s in range(0, nq, BATCH):
        res = out[s:s + BATCH]
        d_full = _exact_distances(torch, qn[s:s + BATCH], ref, mask[s:s + BATCH])
        recs.append(_check_quantized(torch, d_full, [[_row_of(r) for r in x] for x in res],
                                     [[r.distance for r in x] for x in res], 10, what))
    r = float(np.mean(recs))
    if r < RECALL_FLOOR[what]:
        raise AssertionError(f"{what}: recall@10 {r:.4f} below the floor {RECALL_FLOOR[what]}")
    return (f"serial path {nq} near_vector(k=16) in {serial_s:.1f} s; {CLIENTS} clients x "
            f"{CALLS} near_vector(k=10), half where(views >= {VIEWS_CUT}): "
            f"{_latency_stats(nq, lat, wall)}; equal to the serial path, exact distances, "
            f"recall@10 {r:.4f}")


def phase_quantized_end_to_end(torch, K, seed: int, db, st4: dict) -> dict:
    import copy

    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    col = st4["col"]
    rng = np.random.default_rng([seed, 6])
    ref = st4["ref"]
    queries = near_queries(seed + 1, rng.integers(0, len(ref), CLIENTS * CALLS),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                           NEAR_NOISE)
    K.reset_launch_counts()  # phase 6's run starts here
    cfg = copy.deepcopy(col.config)
    cfg.vectors[0].index.quantization = "pq"
    t0 = time.perf_counter()
    db.update_collection(cfg)  # trains and encodes the live rows on the card
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    store = next(iter(col.shards.values())).vector_indexes[""].store
    if getattr(store, "quantization", None) != "pq" or \
            tuple(store.codebook.centroids.shape) != (DIM // 4, 16, 4):
        raise AssertionError("update_collection did not switch the live index to 4-bit PQ")
    part_pq = _quantized_clients(torch, col, ref, st4["live"], st4["views"], queries,
                                 where, "e2e pq4")
    col2 = _collection(db, "WikiBQ", quantization="bq")
    ref2, views2, done2, import_s = _import(torch, col2, seed + 2, BQ_E2E_ROWS, 8001, rng,
                                            IMPORT_BUDGET_S)
    if done2 != BQ_E2E_ROWS or col2.object_count() != done2:
        raise AssertionError(f"BQ collection holds {col2.object_count()} of {BQ_E2E_ROWS}")
    queries2 = near_queries(seed + 2, rng.integers(0, done2, CLIENTS * CALLS),
                            lambda r: ref2[torch.from_numpy(r).to(dev)].cpu().numpy(),
                            NEAR_NOISE)
    part_bq = _quantized_clients(torch, col2, ref2, torch.ones(done2, dtype=torch.bool,
                                                               device=dev),
                                 torch.from_numpy(views2).to(dev), queries2, where, "e2e bq")
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 6 quantized end to end: update_collection(quantization='pq') on phase 4's "
        f"live {len(ref)}-row collection in {compress_s:.1f} s (train + encode on the card); "
        f"queries near its rows: {part_pq} | a collection with quantization='bq' in its "
        f"schema, batch_put {done2} objects in {import_s:.1f} s "
        f"({done2 / import_s:.0f} objects/s); {part_bq}; launches {counts}")
    _require_launched(counts, 6)
    return counts


# -- phase 7: hybrid search at the size of BEIR FiQA-2018 -------------------------

FIQA_DOCS = 57_638        # corpus documents (Thakur et al., NeurIPS 2021 D&B, Table 1)
FIQA_QUERIES = 648        # test queries
FIQA_DOC_WORDS = 132.32   # average document length in words
FIQA_QUERY_WORDS = 10.77  # average query length in words
TITLE_WORDS = 6           # FiQA's titles are empty; here short ones, so BM25F spans two
VOCAB, ZIPF_S = 100_000, 1.0
HYBRID_K = 10
HYBRID_BUDGET = 4096      # WEAVIATE_TPU_HYBRID_MAX_CANDIDATES' default
BUDGET_QUERIES = 256      # queries of runs (b) and (c) each
# Weaviate's hybrid default (relativeScore, alpha 0.75), then rankedFusion at 0.3 and 0.75
HYBRID_SETTINGS = (("relativeScore", 0.75), ("rankedFusion", 0.3), ("rankedFusion", 0.75))
FUSED_RTOL = 1e-6         # the host fuses in Python floats, the device in f32


def _zipf_words(seed: int):
    """The vocabulary (rank -> word: the en stopwords first, as the most
    frequent ranks of English text are, then ``w<rank>``) and its Zipf
    probabilities."""
    from weaviate_tpu_torch.text.stopwords import _EN

    stop = sorted(_EN)
    words = np.array(stop + [f"w{r}" for r in range(len(stop), VOCAB)], dtype=object)
    p = 1.0 / np.arange(1, VOCAB + 1, dtype=np.float64) ** ZIPF_S
    return words, p / p.sum(), len(stop)


def _fiqa_corpus(seed: int, n: int):
    """``n`` documents of Zipf text (text ~132 words, title ~6), an int
    property ``n`` (i % 10: ``n == 0`` keeps 10%), and each word's
    document frequency over both properties (an upper bound of any query's
    candidate union)."""
    rng = np.random.default_rng([seed, 7])
    words, p, _ = _zipf_words(seed)
    sigma = 0.6
    lens = np.clip(np.rint(rng.lognormal(np.log(FIQA_DOC_WORDS) - sigma ** 2 / 2, sigma, n)),
                   5, 2000).astype(np.int64)
    tlens = 1 + rng.poisson(TITLE_WORDS - 1, n)
    df = np.zeros(VOCAB, np.int64)
    props = []
    for ln in (lens, tlens):
        ranks = rng.choice(VOCAB, int(ln.sum()), p=p)
        doc = np.repeat(np.arange(n, dtype=np.int64), ln)
        df += np.bincount(np.unique(doc * VOCAB + ranks) % VOCAB, minlength=VOCAB)
        ends = np.cumsum(ln)
        props.append([" ".join(words[ranks[e - m:e]]) for e, m in zip(ends, ln)])
    return props[0], props[1], df, float(lens.mean())


def _fiqa_queries(seed: int, df, budget: bool, count: int):
    """FiQA-shaped queries (~10.8 words, Zipf, stopwords included). With
    ``budget``, content words come only from the band of words whose
    document frequency keeps the sum over the query, and so its candidate
    union, within HYBRID_BUDGET."""
    rng = np.random.default_rng([seed, 8, int(budget)])
    words, p, n_stop = _zipf_words(seed)
    band = np.flatnonzero((df >= 8) & (df <= 1200))
    band = band[band >= n_stop]
    pb = p[band] / p[band].sum()
    out = []
    for _ in range(count):
        m = 1 + rng.poisson(FIQA_QUERY_WORDS - 1)
        toks, used = [], 0
        for r in rng.choice(VOCAB, m, p=p):
            if r < n_stop:
                toks.append(words[r])
                continue
            if budget:
                r = rng.choice(band, p=pb)
                if used + df[r] > HYBRID_BUDGET:
                    continue
                used += df[r]
            toks.append(words[r])
        if budget and used == 0:
            r = rng.choice(band, p=pb)
            toks.append(words[r])
        out.append(" ".join(toks))
    return out


def _same_answer(dev, ref) -> bool:
    """Two hybrid answers [(uuid, score)] agree: scores equal position by
    position within FUSED_RTOL, and every uuid that differs sits in a tie
    (within FUSED_RTOL) inside the list or at its k-th place."""
    if len(dev) != len(ref):
        return False
    ds = np.array([x[1] for x in dev], np.float64)
    rs = np.array([x[1] for x in ref], np.float64)
    if not np.allclose(ds, rs, rtol=FUSED_RTOL, atol=1e-9):
        return False
    tol = FUSED_RTOL * np.maximum(np.abs(rs), 1e-9) + 1e-9
    for pos, (u, sc) in enumerate(dev):
        if u == ref[pos][0]:
            continue
        tied = [v for v, t in ref if abs(t - sc) <= tol[pos]]
        if u not in tied and abs(sc - rs[-1]) > tol[pos]:
            return False
    return True


def _tie_ordered_reference(col, shard, query, vec, fusion, alpha, allow):
    """The host reference with the device path's tie order: every BM25
    candidate scored by the host scorer, the leg cut at the over-fetch
    after ordering by (score desc, doc id asc), the dense leg from the
    host path, fused by text/hybrid.py. Differs from the host path only
    in the order of exactly tied BM25 scores, which the host's
    argpartition leaves arbitrary (and which moves RRF ranks)."""
    from weaviate_tpu_torch.db.collection import SearchResult
    from weaviate_tpu_torch.text.hybrid import fusion_ranked, fusion_relative_score

    fetch = max(HYBRID_K * 10, 100)
    ids, scores = shard.bm25_search(query, 1 << 30, None, allow)
    order = np.lexsort((ids, -scores.astype(np.float64)))[:fetch]
    sparse = [SearchResult(uuid=shard._doc_to_uuid[int(i)], score=float(scores[j]))
              for j, i in zip(order, ids[order])]
    legs, weights = [], []
    if alpha < 1.0:
        legs.append(sparse)
        weights.append(1.0 - alpha)
    if alpha > 0.0:
        dense = col.near_vector(vec, k=fetch, include_objects=False,
                                allow_list_by_shard=None if allow is None
                                else {shard.name: allow})
        for r in dense:
            r.score = -r.distance
        legs.append(dense)
        weights.append(alpha)
    fuse = fusion_relative_score if fusion == "relativeScore" else fusion_ranked
    return [(r.uuid, s) for s, r in fuse(legs, weights, HYBRID_K)]


def _native_state() -> str:
    from weaviate_tpu_torch import native

    return "on" if native.available() else "off (numpy)"


def _fiqa_import(torch, seed: int, db, n_docs: int):
    """Phase 7's collection: FiQA-shaped text and clustered vectors
    through Collection.batch_put in batches of 2,000. Returns (collection,
    unit rows on the card, document frequencies, mean text length, the
    seconds spent making the text and importing it)."""
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  VectorConfig, VectorIndexConfig)

    dev = "cuda"
    t0 = time.perf_counter()
    texts, titles, df, mean_len = _fiqa_corpus(seed, n_docs)
    cent = centers(seed)
    gen_s = time.perf_counter() - t0
    col = db.create_collection(CollectionConfig(
        name="FiQA",
        properties=[Property(name="title", data_type="text"),
                    Property(name="text", data_type="text"),
                    Property(name="n", data_type="int")],
        vectors=[VectorConfig(index=VectorIndexConfig(index_type="flat", metric=METRIC))]))
    ref = torch.empty((n_docs, DIM), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    for s in range(0, n_docs, 2000):
        n = min(2000, n_docs - s)
        v = clustered(seed + 3, s, n, cent)
        res = col.batch_put([
            {"uuid": _uuid(8002, s + i),
             "properties": {"title": titles[s + i], "text": texts[s + i], "n": (s + i) % 10},
             "vector": v[i]} for i in range(n)])
        if any(r["status"] != "SUCCESS" for r in res):
            raise AssertionError(f"batch_put failed: {res[0]}")
        ref[s:s + n] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
    return col, ref, df, mean_len, gen_s, time.perf_counter() - t0


def import_run(torch, seed: int, n_docs: int, rows: int) -> dict:
    """The FiQA-sized text import (phase 7's) and a ``rows``-row vector
    batch_put (phase 4's) into a fresh Database on the card, with the
    native host library or without it (WEAVIATE_TPU_NO_NATIVE=1): the
    import rates of whichever path is active."""
    from weaviate_tpu_torch import native
    from weaviate_tpu_torch.db import Database

    tmp = tempfile.mkdtemp(prefix="chip_smoke_import_")
    db = None
    try:
        db = Database(tmp, device="cuda")
        col, _ref, _df, _len, _gen, text_s = _fiqa_import(torch, seed, db, n_docs)
        if col.object_count() != n_docs:
            raise AssertionError(f"object_count {col.object_count()} != {n_docs}")
        vcol = _collection(db, "Wiki")
        _, _, done, vec_s = _import(torch, vcol, seed + 1, rows, 8000,
                                    np.random.default_rng([seed, 4]), IMPORT_BUDGET_S)
        if vcol.object_count() != done:
            raise AssertionError(f"object_count {vcol.object_count()} != {done}")
    finally:
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"native": native.available(), "text_docs": n_docs, "text_s": text_s,
            "text_objects_s": n_docs / text_s, "vector_rows": done, "vector_s": vec_s,
            "vector_objects_s": done / vec_s}


def import_times(torch, seed: int, n_docs: int, rows: int) -> list[str]:
    """``--import-times``: import_run with the native host library, then
    in a child process with WEAVIATE_TPU_NO_NATIVE=1 (the numpy codecs),
    then with the library again, in one call. Returns one text part
    each."""
    import os

    def text(r):
        return (f"native host library {'on' if r['native'] else 'off (numpy)'}: "
                f"FiQA-sized text import {r['text_docs']} documents in {r['text_s']:.1f} s "
                f"({r['text_objects_s']:.0f} objects/s), vector batch_put {r['vector_rows']} "
                f"rows x {DIM} in {r['vector_s']:.1f} s ({r['vector_objects_s']:.0f} objects/s)")

    parts = [text(import_run(torch, seed, n_docs, rows))]
    env = dict(os.environ, WEAVIATE_TPU_NO_NATIVE="1")
    child = subprocess.run(
        [sys.executable, __file__, "--import-run", "--seed", str(seed), "--rows", str(rows),
         "--hybrid-docs", str(n_docs)], capture_output=True, text=True, timeout=1800, env=env)
    if child.returncode != 0:
        raise AssertionError(f"the numpy import run failed:\n{child.stderr[-4000:]}")
    numpy_run = json.loads(child.stdout.strip().splitlines()[-1])
    if numpy_run["native"]:
        raise AssertionError("WEAVIATE_TPU_NO_NATIVE=1 did not turn the library off")
    parts.append(text(numpy_run))
    parts.append(text(import_run(torch, seed, n_docs, rows)) + " (again)")
    return parts


def phase_hybrid(torch, K, seed: int, db, n_docs: int) -> tuple[dict, dict]:
    """Phase 7. Returns its launch counts and its collection's state
    (collection, unit rows on the card, document frequencies), which
    phase 9b queries again over the socket."""
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    rng = np.random.default_rng([seed, 9])
    col, ref, df, mean_len, gen_s, import_s = _fiqa_import(torch, seed, db, n_docs)
    if col.object_count() != n_docs:
        raise AssertionError(f"object_count {col.object_count()} != {n_docs}")
    shard = next(iter(col.shards.values()))
    if shard.hybrid_max_candidates != HYBRID_BUDGET:
        raise AssertionError(f"candidate budget {shard.hybrid_max_candidates}")
    where = Filter.where("n", Operator.EQUAL, 0)
    # run -> (queries, filter, the index's selection)
    runs = {"a": (_fiqa_queries(seed, df, False, FIQA_QUERIES), None, "approx"),
            "b": (_fiqa_queries(seed, df, True, BUDGET_QUERIES), None, "approx")}
    runs["c"] = (runs["b"][0], where, "approx")
    runs["d"] = (runs["b"][0], None, "fused")

    def vectors(count, tag):
        return near_queries(seed + tag, rng.integers(0, n_docs, count),
                            lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy(),
                            NEAR_NOISE)

    # per-query attribution: which path served each hybrid call
    tls = threading.local()
    served: dict = {}
    orig = col._hybrid_device

    def recording(*a, **kw):
        r = orig(*a, **kw)
        served[tls.key] = r is not None
        return r

    col._hybrid_device = recording
    idx = shard.vector_indexes[""]
    batcher = shard._query_batcher("", idx)
    K.reset_launch_counts()  # phase 7's run starts here
    d0 = batcher.dispatches
    answers, parts, qvecs, fused_launches = {}, [], {}, {}
    for name, (queries, flt, selection) in runs.items():
        idx.store.selection = selection
        nq = len(queries)
        qv = qvecs[name] = vectors(nq, 10 + ord(name))
        pv = vectors(nq // 3, 20 + ord(name))
        # one plain nearVector request after every third hybrid one
        reqs = []
        for i in range(nq):
            reqs.append(("h", i))
            if i % 3 == 2:
                reqs.append(("v", i // 3))

        def ask(j, _q=queries, _qv=qv, _pv=pv, _f=flt, _name=name, _reqs=reqs):
            kind, i = _reqs[j]
            if kind == "v":
                return col.near_vector(_pv[i], k=HYBRID_K, include_objects=False)
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            tls.key = (_name, i)
            return col.hybrid(_q[i], vector=_qv[i], alpha=alpha, k=HYBRID_K, fusion=fusion,
                              where=_f, include_objects=False)

        h0, l0 = batcher.hybrid_batched, K.launch_counts["bm25_block"]
        f0 = {kn: K.launch_counts[kn] for kn in ("fused_topk_scan", "fused_topk_pairs")}
        out, lat, wall = _run_clients(ask, len(reqs))
        fused_launches[name] = {kn: K.launch_counts[kn] - c for kn, c in f0.items()}
        hyb = [j for j, r in enumerate(reqs) if r[0] == "h"]
        n_dev = sum(served[(name, reqs[j][1])] for j in hyb)
        if batcher.hybrid_batched - h0 != n_dev:
            raise AssertionError(f"run {name}: {n_dev} queries served on the device but "
                                 f"hybrid_batched rose by {batcher.hybrid_batched - h0}")
        if name != "a" and n_dev != nq:
            raise AssertionError(f"run {name}: {nq - n_dev} of {nq} budget-eligible "
                                 "queries left the device path")
        for j in hyb:
            i = reqs[j][1]
            res = out[j]
            sc = np.array([r.score for r in res], np.float64)
            if not len(res) or not np.isfinite(sc).all() or (np.diff(sc) > 1e-7).any():
                raise AssertionError(f"run {name} query {i}: malformed answer")
            answers[(name, i)] = [(r.uuid, r.score) for r in res]
        launches = K.launch_counts["bm25_block"] - l0
        hl = np.asarray([lat[j] for j in hyb])
        parts.append(
            f"({name}) {nq} {'FiQA-shaped' if name == 'a' else 'budget-eligible'} hybrid "
            f"queries{' with where(n == 0), 10%' if flt is not None else ''} under "
            f"selection {selection} + {nq // 3} "
            f"nearVector from {CLIENTS} clients: device path served {n_dev}/{nq} "
            f"({n_dev / nq:.1%}), hybrid_batched +{batcher.hybrid_batched - h0}; "
            f"{len(hyb) / wall:.1f} hybrid QPS, p50 "
            f"{np.percentile(hl, 50):.1f} ms, p99 {np.percentile(hl, 99):.1f} ms; "
            f"bm25_block launches {launches} (one per fused dispatch, "
            f"{n_dev / max(launches, 1):.2f} hybrid rows each)")
    dispatches = batcher.dispatches - d0
    # ... and ends here: the host reference below runs the dense leg on the
    # card too, and its launches are not the hybrid path's
    counts = dict(K.launch_counts)
    col._hybrid_device = orig
    idx.store.selection = "approx"
    if fused_launches["d"]["fused_topk_scan"] <= 0:
        raise AssertionError("run d: the fused selection's dense leg did not launch "
                             "fused_topk_scan")
    # every answer of the device path against the host reference path, serially
    shard.device_hybrid = False
    exact = tie_ordered = over_budget = 0
    t1 = time.perf_counter()
    try:
        for (name, i), ans in answers.items():
            queries, flt, _selection = runs[name]
            if not served[(name, i)]:
                # the host path served it: the query's candidate union must
                # really exceed the budget
                allow = None if flt is None else shard.allow_mask(flt)
                pack = shard._inverted.bm25_pack(queries[i], None, allow,
                                                 max_candidates=1 << 30)
                if pack is None or len(pack["doc_ids"]) <= HYBRID_BUDGET:
                    raise AssertionError(f"run {name} query {i} took the host path "
                                         "within the candidate budget")
                over_budget += 1
                continue
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            host = col.hybrid(queries[i], vector=qvecs[name][i],
                              alpha=alpha, k=HYBRID_K, fusion=fusion, where=flt,
                              include_objects=False)
            if _same_answer(ans, [(r.uuid, r.score) for r in host]):
                exact += 1
                continue
            allow = None if flt is None else shard.allow_mask(flt)
            oracle = _tie_ordered_reference(col, shard, queries[i], qvecs[name][i],
                                            fusion, alpha, allow)
            if not _same_answer(ans, oracle):
                raise AssertionError(
                    f"run {name} query {i} {queries[i]!r} ({fusion} {alpha}): device, "
                    "host path, tie-ordered reference:\n" + "\n".join(
                        f"  {a[0][-8:]} {a[1]!r} | {h.uuid[-8:]} {h.score!r} | "
                        f"{o[0][-8:]} {o[1]!r}" for a, h, o in zip(ans, host, oracle)))
            tie_ordered += 1
    finally:
        shard.device_hybrid = True
    ref_s = time.perf_counter() - t1
    # where a device-served query's time goes (host clock, after the
    # count): the host's BM25 planning of one query, and one fused
    # dispatch of 8 (b) rows against the dense scan alone at its depth
    plan_ms, ops = [], []
    for i in range(64):
        fusion, alpha = HYBRID_SETTINGS[i % 3]
        t2 = time.perf_counter()
        ops.append(shard._hybrid_operand(idx, runs["b"][0][i], HYBRID_K, alpha, fusion,
                                         None, None))
        plan_ms.append((time.perf_counter() - t2) * 1e3)
    fused_ms, dense_ms = [], []
    batches = [(qvecs["b"][8 * r:8 * r + 8], ops[8 * r:8 * r + 8]) for r in range(8)]
    split = hybrid_split(torch, idx, batches)
    for r in range(8):
        rows = qvecs["b"][8 * r:8 * r + 8]
        t2 = time.perf_counter()
        idx.hybrid_batch_async(rows, 16, None, ops[8 * r:8 * r + 8]).result()
        t3 = time.perf_counter()
        idx.search_by_vector_batch_async(rows, 128).result()
        fused_ms.append((t3 - t2) * 1e3)
        dense_ms.append((time.perf_counter() - t3) * 1e3)
    log(f"phase 7 hybrid: BEIR FiQA-2018 shape, {n_docs} documents (text {mean_len:.1f} "
        f"words, title ~{TITLE_WORDS}, Zipf s={ZIPF_S} over {VOCAB} words, made in "
        f"{gen_s:.1f} s), {DIM}-d {METRIC} flat; batch_put in {import_s:.1f} s "
        f"({n_docs / import_s:.0f} objects/s, native host library {_native_state()}); k1 1.2, b 0.75, k={HYBRID_K}, "
        f"{'/'.join(f'{f} {a}' for f, a in HYBRID_SETTINGS)} in turn: " + " | ".join(parts)
        + f"; {dispatches} batched dispatches in all; host reference ({ref_s:.1f} s, serial, "
        f"device_hybrid off): {exact} device answers equal to it (uuids, scores within "
        f"rtol {FUSED_RTOL}, order where scores differ), {tie_ordered} equal to it once "
        f"exactly tied BM25 scores are ordered by doc id as the device orders them, 0 "
        f"differ; {over_budget} host-served queries all over the {HYBRID_BUDGET}-candidate "
        f"budget; launches {counts}, of which run (d) {fused_launches['d']}; "
        f"per device-served query: BM25 planning on the host "
        f"p50 {np.median(plan_ms):.2f} ms; a fused dispatch of 8 rows p50 "
        f"{np.median(fused_ms):.2f} ms against the dense scan alone (k 128) "
        f"{np.median(dense_ms):.2f} ms; the dispatch's split (one page-locked buffer with "
        f"compact planes, one non-blocking copy, a CUDA graph of the program): {split}; "
        f"device memory after the phase: {_memory_text(torch)}")
    for kn in ("bm25_block", "distance_block"):
        if counts[kn] <= 0:
            raise AssertionError(f"{kn} was not launched on the hybrid path")
    return counts, dict(col=col, ref=ref, df=df)


# -- where a fused hybrid dispatch's time goes ----------------------------------

# (module attribute, label, on the device): the stages of
# FlatIndex.hybrid_batch_async and ops/bm25.hybrid_topk that the split
# times, each wrapped while it runs
SPLIT_STAGES = (("search_async", "dense scan", True),
                ("stack_sparse_operands", "stack", False),
                ("stack_dispatch_operands", "stack", False),
                ("pack_to_device", "upload", True),
                ("hybrid_program", "upload + program", True),
                ("bm25_neg_scores", "bm25_block", True),
                ("masked_candidate_topk", "sparse top-k", True), ("fuse_topk", "fusion", True))


def _upload_per_array(pack: dict, device) -> dict:
    """The first design's upload, kept to compare with: one pageable
    ``.to(device)`` per stacked array (each waits for the stream)."""
    import torch

    from weaviate_tpu_torch.ops.kernels import as_bits_tensor

    out = {}
    for name, arr in pack.items():
        if not isinstance(arr, np.ndarray):
            continue
        if name == "cand_bits":
            out[name] = as_bits_tensor(np.array(arr), device)
        else:
            out[name] = torch.from_numpy(np.array(arr)).to(device)
    return out


def _memory_text(torch) -> str:
    """The card's memory as PyTorch holds it, and the bytes the cached
    hybrid CUDA graphs hold by their own estimate (ops/bm25.graph_bytes)."""
    from weaviate_tpu_torch.ops import bm25 as B

    gib = 1 << 30
    text = (f"reserved {torch.cuda.memory_reserved() / gib:.3f} GiB, allocated "
            f"{torch.cuda.memory_allocated() / gib:.3f} GiB")
    if hasattr(B, "hybrid_graph_bytes"):
        text += f", hybrid graphs {B.hybrid_graph_bytes() / gib:.3f} GiB (estimate)"
    return text


def _stacked_shape(pack) -> tuple:
    """(B, S, T, C) that a stacking stage returned: the padded shape of
    ``stack_dispatch_operands``, or the arrays' of ``stack_sparse_operands``."""
    if "shape" in pack:
        return tuple(int(x) for x in pack["shape"])
    b, s, c = pack["seg_tf"].shape
    return b, s, pack["idf"].shape[1], c


def hybrid_split(torch, idx, batches, k: int = 16, first_design: bool = False) -> str:
    """Where one fused hybrid dispatch goes: ``idx.hybrid_batch_async(rows,
    k, None, ops).result()`` for each (rows, ops) of ``batches`` (the first
    one warms up), with each stage of SPLIT_STAGES wrapped: its host time
    (the enqueue; an upload that waits for the stream waits here) and, for
    the device stages, CUDA events around it (the device's span of the
    stage, gaps included where the host is slower than the device); then
    the handle's ``.result()`` (the wait for the device and the copy back)
    on the host clock. Medians in ms. ``first_design``: the program as
    the first design ran it, to compare with: one pageable copy per
    stacked array (``_upload_per_array``), then hybrid_topk's launches one
    by one, no CUDA graph."""
    from weaviate_tpu_torch.ops import bm25 as B

    rec: dict = {}
    stacked: set = set()
    nest = threading.local()  # the stacking runs on another thread

    def timed(label, fn, device):
        def wrapper(*a, **kw):
            if getattr(nest, "depth", 0):  # a stage inside another (fuse_topk's top-k)
                return fn(*a, **kw)
            nest.depth = 1
            try:
                e0 = torch.cuda.Event(enable_timing=True) if device else None
                if e0 is not None:
                    e0.record()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                host = (time.perf_counter() - t0) * 1e3
                if label == "stack":
                    stacked.add(_stacked_shape(r))
                e1 = torch.cuda.Event(enable_timing=True) if device else None
                if e1 is not None:
                    e1.record()
                rec.setdefault(label, []).append((host, e0, e1))
                return r
            finally:
                nest.depth = 0
        return wrapper

    saved = []
    for attr, label, device in SPLIT_STAGES:
        owner = idx.store if attr == "search_async" else B
        fn = getattr(owner, attr, None)
        if fn is None:  # a tree without this stage
            continue
        saved.append((owner, attr, owner.__dict__.get(attr)))
        if first_design and attr == "stack_dispatch_operands":
            # the first design's padded planes (B.stack_sparse_operands, timed
            # as "stack" above)
            setattr(owner, attr, lambda ops, b_pad, **_kw: {
                "padded": B.stack_sparse_operands(ops, b_pad)})
            continue
        if first_design and attr == "hybrid_program":
            setattr(owner, attr, lambda dn_d, dn_i, pack, kk: B.hybrid_topk(
                dn_d, dn_i, B.pack_to_device(pack["padded"], dn_d.device), kk))
            continue
        if first_design and attr == "pack_to_device":
            fn = _upload_per_array
        setattr(owner, attr, timed(label, fn, device))
    rows_of = []
    walls, results = [], []
    try:
        for i, (rows, ops) in enumerate(batches):
            rec_before = {lb: len(v) for lb, v in rec.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = idx.hybrid_batch_async(rows, k, None, ops)
            t1 = time.perf_counter()
            h.result()
            t2 = time.perf_counter()
            if i == 0:  # warm-up: drop its records
                for lb in rec:
                    del rec[lb][rec_before.get(lb, 0):]
                continue
            walls.append((t2 - t0) * 1e3)
            results.append((t2 - t1) * 1e3)
            live = [op for op in ops if op is not None]
            rows_of.append((len(ops), max(op.seg_tf.shape[0] for op in live),
                            max(len(op.idf) for op in live), max(len(op.slots) for op in live)))
    finally:
        for owner, attr, orig in saved:
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
    torch.cuda.synchronize()
    parts = [f"wall p50 {np.median(walls):.3f} ms"]
    for label, device in dict((lb, dv) for _a, lb, dv in SPLIT_STAGES).items():
        got = rec.get(label, [])
        if not got:
            continue
        text = f"{label} host {np.median([h for h, _e0, _e1 in got]):.3f}"
        if device:
            text += f" / device {np.median([e0.elapsed_time(e1) for _h, e0, e1 in got]):.3f}"
        parts.append(text)
    parts.append(f"result() wait + copy host {np.median(results):.3f}")
    b, s_, t_, c_ = np.max(np.asarray(rows_of), axis=0)
    shapes = " / ".join(str(list(sh)) for sh in sorted(stacked))
    return (f"{len(walls)} dispatches of {b} rows (unpadded S <= {s_}, T <= {t_}, C <= {c_}; "
            f"stacked and launched at (B, S, T, C) {shapes}): " + ", ".join(parts) + " ms")


def hybrid_stages(torch, idx, rows, ops, k: int = 16) -> str:
    """One dispatch's program stage by stage, each alone on an idle card
    (synchronized before and after, CUDA events around it, so a stage's
    time is the device's span of it, host gaps between its launches
    included): the upload of the stacked operands, bm25_block, the sparse
    top-k, the fusion and the copy back, launched as ``hybrid_topk``
    launches them; then the whole program as a dispatch runs it
    (``hybrid_program``: a CUDA graph's replay, where the tree has one).
    Medians of 5 after a warm-up, in ms."""
    from weaviate_tpu_torch.ops import bm25 as B
    from weaviate_tpu_torch.ops.candidates import masked_candidate_topk

    fetch = max([k] + [int(op.fetch) for op in ops if op is not None])
    f_depth = 1 << max(0, fetch - 1).bit_length()
    dn_d, dn_i = idx.store.search_async(rows, f_depth, None, keep_rows=True).arrays
    pack = B.stack_sparse_operands(ops, len(rows))
    times: dict = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        r = fn()
        e1.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(e0.elapsed_time(e1))
        return r

    for _rep in range(6):
        dev = stage("upload", lambda: B.pack_to_device(pack, dn_d.device))
        neg = stage("bm25_block", lambda: B.bm25_neg_scores(*(dev[n] for n in BM25_ARGS)))
        fs = min(neg.shape[1], dn_d.shape[1])
        sp = stage("sparse top-k", lambda: masked_candidate_topk(neg, dev["slots"], fs))
        fu = stage("fusion", lambda: B.fuse_topk(sp[0], sp[1], dn_d, dn_i, dev["alpha"],
                                                 dev["kind"], dev["fetch"], k))
        stage("copy back", lambda: (fu[0][:, :k].cpu(), fu[1][:, :k].cpu()))
        if hasattr(B, "hybrid_program"):
            packed = B.stack_dispatch_operands(ops, len(rows), shape=B.GRAPH_SHAPE,
                                               pin=dn_d.is_cuda)
            stage("whole program (one upload, graph replay)",
                  lambda: B.hybrid_program(dn_d, dn_i, packed, k))
    return ", ".join(f"{name} {np.median(v[1:]):.3f}" for name, v in times.items()) + " ms"


def synthetic_hybrid(torch, seed: int, n_docs: int = FIQA_DOCS, dispatches: int = 9,
                     dev: str = "cuda"):
    """A flat cosine index of ``n_docs`` random 768-d rows on the card and
    ``dispatches`` batches of 8 hybrid rows with random FiQA-like sparse
    operands (8 query terms over two properties, 1,000-4,000 candidates),
    for timing the fused dispatch without phase 7's text import."""
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.ops.bm25 import SparseOperand, fusion_kind

    rng = np.random.default_rng([seed, 11])
    cent = centers(seed)
    idx = FlatIndex(DIM, METRIC, capacity=1 << 16, device=dev)
    for s in range(0, n_docs, 16384):
        n = min(16384, n_docs - s)
        idx.add_batch(np.arange(s, s + n), clustered(seed + 3, s, n, cent))
    batches = []
    for d in range(dispatches):
        ops = []
        for r in range(8):
            t = 8
            c = int(rng.integers(1000, HYBRID_BUDGET + 1))
            docs = np.sort(rng.choice(n_docs, c, replace=False)).astype(np.int64)
            tf = rng.integers(1, 4, (2 * t, c)).astype(np.float32)
            tf[rng.random((2 * t, c)) < 0.8] = 0.0
            fusion, alpha = HYBRID_SETTINGS[(8 * d + r) % 3]
            ops.append(SparseOperand(
                docs, idx.slots_for_doc_ids(docs), tf,
                rng.integers(1, 300, (2 * t, c)).astype(np.float32),
                np.repeat(np.arange(t, dtype=np.int32), 2),
                np.tile(np.float32([1.0, 1.0]), t), np.tile(np.float32([6.0, 132.0]), t),
                rng.uniform(0.5, 8.0, t).astype(np.float32), 1.2, 0.75,
                float(np.float32(1.0) - np.float32(0.75)), alpha, fusion_kind(fusion),
                max(HYBRID_K * 10, 100)))
        rows = clustered(seed + 5, 8 * d, 8, cent)
        batches.append((rows, ops))
    return idx, batches


def mxu_times(torch, K, gen, timer) -> list[str]:
    """bq_mxu_block at the main shape [256, 24 words] x 1,048,576 rows
    (~10% dead), equal to its plain version, timed beside its bound, with
    each query block the kernel could take (BQ_TC_QBLOCKS; the wrapper
    picks 128) and the popcount body it keeps; phase 8's [8, 4 words] x 512
    from a CUDA graph; and the product alone as a yardstick: torch._int_mm
    of the 0/1 int8 bit planes, [256, 768] x [768, N] (not library_ms: no
    PyTorch call computes the function). Returns one text part each."""
    dev = "cuda"
    n, w = 1 << 20, DIM // 32
    xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), dtype=torch.int32, device=dev,
                       generator=gen)
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, w), dtype=torch.int32, device=dev,
                       generator=gen)
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    _same_block(torch, K.bq_mxu_block(qw, xw, valid=valid),
                K.bq_mxu_block_plain(qw, xw, valid=valid), f"bq_mxu_block [{BATCH},{w}] x [{n}]")
    b_ms, b_by = mxu_bound(BATCH, n, w)
    o = dict(ms=timer(lambda: K.bq_mxu_block(qw, xw, valid=valid), reps=20), bound_ms=b_ms,
             bound_by=b_by)
    parts = [f"bq_mxu_block [{BATCH},{w} words] x [{n},{w}] ~10% dead: equal to the plain "
             f"version; kernel {o['ms']:.4f} ms, {_bound_text(o)}"]
    if hasattr(K, "bq_mxu_launch"):  # absent from trees before the single-bit body
        blocks = {qn: timer(lambda: K.bq_mxu_launch(qw, None, xw, None, valid, qn), reps=20)
                  for qn in K.BQ_TC_QBLOCKS[2:] + (0,)}
        parts.append(f"by query block (the wrapper takes {K.bq_mxu_qblock(BATCH, w)}; 0: the "
                     "popcount body): " + ", ".join(f"{qn} {ms:.4f} ms"
                                                    for qn, ms in blocks.items()))
    q8, x8 = qw[:8, :4].contiguous(), xw[:512, :4].contiguous()
    parts.append(f"phase 8's [8,4 words] x [512,4]: "
                 f"{graph_ms(torch, K, [lambda: K.bq_mxu_block(q8, x8)]):.4f} ms "
                 "(a CUDA graph of launches)")
    try:
        q01, x01 = _bit_planes(torch, qw, torch.int8), _bit_planes(torch, xw, torch.int8)
        ms = timer(lambda: torch._int_mm(q01, x01.t()), reps=5)
        parts.append(f"yardstick torch._int_mm [{BATCH},{32 * w}] x [{32 * w},{n}] 0/1 int8 "
                     f"(the product alone): {ms:.4f} ms")
        del x01
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch._int_mm failed: {str(e).splitlines()[0]}")
    return parts


def ham_times(torch, K, gen, timer) -> list[str]:
    """bq_hamming_block at the main shape [256, 24 words] x 1,048,576 rows,
    equal to its plain version, timed beside its bound: the wrapper (which
    lays out the query blocks each call), the kernel alone on blocks laid
    out once, each query block the tensor-core body could take and the
    popcount body it keeps (query block 0); then its two yardsticks
    (ham_yardsticks). Returns one text part each."""
    from weaviate_tpu_torch.ops import _build

    dev = "cuda"
    n, w = 1 << 20, DIM // 32
    xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), dtype=torch.int32, device=dev,
                       generator=gen)
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, w), dtype=torch.int32, device=dev,
                       generator=gen)
    ham = K.bq_hamming_block(qw, xw)
    _same_block(torch, ham, K.bq_hamming_block_plain(qw, xw), f"bq_hamming_block [{BATCH},{w}] x [{n}]")
    b_ms, b_by = ham_bound(BATCH, n, w)
    o = dict(ms=timer(lambda: K.bq_hamming_block(qw, xw), reps=20), bound_ms=b_ms, bound_by=b_by)
    parts = [f"bq_hamming_block [{BATCH},{w} words] x [{n},{w}]: equal to the plain version; "
             f"the wrapper {o['ms']:.4f} ms, {_bound_text(o)}"]
    qn = K.bq_hamming_qblock(BATCH, w)
    qm, out = K.bq_query_blocks(qw, qn), torch.empty_like(ham)
    fn, stream = _build.kernel("bq_hamming_block"), torch.cuda.current_stream().cuda_stream

    def kernel_only():
        fn(qm.data_ptr(), qw.data_ptr(), xw.data_ptr(), 1, BATCH, n, w, qn, -(-BATCH // qn), 1,
           out.data_ptr(), stream)
    kernel_only()
    if not torch.equal(out, ham):
        raise AssertionError("bq_hamming_block's kernel alone differs from the wrapper")
    o = dict(ms=timer(kernel_only, reps=20), bound_ms=b_ms, bound_by=b_by)
    parts.append(f"the kernel alone (query blocks laid out once) {o['ms']:.4f} ms, "
                 f"{_bound_text(o)}")
    # the body without its global stores (a -DWTT_BQ_TC_NOSTORE build),
    # beside the stores alone: one fill_ of the [B, N] f32 output
    nostore = _build.build_variant("bq_hamming_block", ("WTT_BQ_TC_NOSTORE",))

    def no_stores():
        nostore(qm.data_ptr(), qw.data_ptr(), xw.data_ptr(), 1, BATCH, n, w, qn, -(-BATCH // qn),
                1, out.data_ptr(), stream)
    no_stores()
    torch.cuda.synchronize()
    parts.append(f"its breakdown: the body without its global stores (-DWTT_BQ_TC_NOSTORE) "
                 f"{timer(no_stores, reps=20):.4f} ms, the stores alone (fill_ of the "
                 f"[{BATCH},{n}] f32 output) {timer(lambda: out.fill_(1.0), reps=20):.4f} ms")
    blocks = {q: timer(lambda: K.bq_hamming_launch(qw, xw, q), reps=20)
              for q in K.BQ_TC_QBLOCKS[2:] + (0,)}
    parts.append(f"by query block (the wrapper takes {qn}; 0: the popcount body it keeps): "
                 + ", ".join(f"{q} {ms:.4f} ms" for q, ms in blocks.items()))
    del out, qm
    parts.append(ham_yardsticks(torch, qw, xw, ham, timer)[1])
    return parts


def recon_times(torch, K, gen, timer) -> list[str]:
    """pq4_recon_block at the main shape, q [256, 768] x codes [1,048,576,
    192], ds 4, ~10% dead: l2 / dot / cosine within PQ_TOL of the plain
    version, each timed beside the bound; its fast path's MMAs alone and
    its A build alone (``-DWTT_RECON_PART`` builds); and the product alone as a
    yardstick: a bf16 torch.matmul of q by a materialized x_hat^T [768, N]
    (1.6 GB; not library_ms: the port never materializes x_hat). Returns
    one text part each."""
    dev = "cuda"
    n, m, ds = 1 << 20, DIM // 4, 4
    codes = torch.randint(0, 16, (n, m), dtype=torch.uint8, device=dev, generator=gen)
    cent = torch.randn((m, 16, ds), device=dev, generator=gen) * 0.2
    q = torch.nn.functional.normalize(torch.randn((BATCH, DIM), device=dev, generator=gen), dim=1)
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    b_ms, b_by = bound_ms(q.numel() * 4 + codes.numel() + cent.numel() * 4 + n + BATCH * n * 2,
                          2.0 * BATCH * n * DIM, BF16_FLOPS)
    parts = []
    for metric in ("l2-squared", "dot", "cosine"):
        err = _same_block(torch, K.pq4_recon_block(q, codes, cent, metric, valid),
                          K.pq4_recon_block_plain(q, codes, cent, metric, valid),
                          f"pq4_recon_block {metric} [{BATCH},{DIM}] x [{n},{m}]", tol=PQ_TOL)
        o = dict(ms=timer(lambda: K.pq4_recon_block(q, codes, cent, metric, valid), reps=10),
                 bound_ms=b_ms, bound_by=b_by)
        parts.append(f"pq4_recon_block {metric} [{BATCH},{DIM}] x [{n},{m}] ds {ds}: within "
                     f"PQ_TOL (max_abs_err {err:.3g}); kernel {o['ms']:.4f} ms, {_bound_text(o)}")
    if hasattr(K, "pq4_recon_fast"):  # the breakdown builds are this design's
        from weaviate_tpu_torch.ops import _build

        full, ms = _build.kernel("pq4_recon_block"), {}
        try:
            for part, what in ((1, "the MMAs alone"), (2, "the A build alone")):
                _build._funcs["pq4_recon_block"] = _build.build_variant(
                    "pq4_recon_block", (f"WTT_RECON_PART={part}",))
                ms[what] = timer(lambda: K.pq4_recon_block(q, codes, cent, METRIC, valid), reps=10)
        finally:
            _build._funcs["pq4_recon_block"] = full
        parts.append(f"pq4_recon_block {METRIC} breakdown (-DWTT_RECON_PART builds of the fast "
                     "path, same call): " + ", ".join(f"{w} {t:.4f} ms" for w, t in ms.items()))
    try:
        cb = torch.nn.functional.pad(K._pq4_recon_centroids(cent), (0, 0, 0, 1)) \
            .to(torch.bfloat16)  # [m, 17, ds], row 16 for the codes past 15
        seg = torch.arange(m, device=dev)
        xhat = torch.empty((n, DIM), dtype=torch.bfloat16, device=dev)
        for s in range(0, n, ADD_BATCH):
            c = codes[s:s + ADD_BATCH].long().clamp(max=16)
            xhat[s:s + ADD_BATCH] = cb[seg[None, :], c].reshape(-1, DIM)
        qb = q.to(torch.bfloat16)
        ms = timer(lambda: torch.matmul(qb, xhat.t()), reps=5)
        parts.append(f"yardstick torch.matmul [{BATCH},{DIM}] x [{DIM},{n}] bf16 on a "
                     f"materialized x_hat (the product alone): {ms:.4f} ms")
        del xhat
    except RuntimeError as e:  # a yardstick only: the run goes on without it
        parts.append(f"yardstick torch.matmul failed: {str(e).splitlines()[0]}")
    return parts


def block_times(torch, K, seed: int, timer) -> list[str]:
    """``--block-times``: bq_hamming_block, bq_mxu_block and
    pq4_recon_block held to their plain versions (HAM_CHECKS, UNALIGNED,
    MXU_CHECKS, RECON_CHECKS, the main shapes) and timed beside their
    bounds and yardsticks (ham_times, mxu_times, recon_times);
    pq4_lut_block and bm25_block held to their plain versions (LUT_CHECKS,
    the 1M-row shape; BM25_CHECKS) and timed at the main and dispatch
    shapes, then the fused hybrid dispatch's split on a synthetic
    FiQA-sized index. Returns one text part each."""
    from weaviate_tpu_torch.ops import bm25 as B

    rng = np.random.default_rng([seed, 2])
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = [f"bq_mxu_block and pq4_recon_block held to the plain versions at "
             f"{mxu_recon_checks(torch, K, rng, dev)} MXU_CHECKS / RECON_CHECKS shapes, "
             f"bq_hamming_block at {ham_checks(torch, K, rng, dev)} HAM_CHECKS / UNALIGNED "
             "shapes"]
    parts += ham_times(torch, K, gen, timer)
    torch.cuda.empty_cache()
    parts += mxu_times(torch, K, gen, timer) + recon_times(torch, K, gen, timer)
    torch.cuda.empty_cache()
    parts.append(f"pq4_lut_block equal to the plain version at {lut_checks(torch, K, rng)} "
                 f"LUT_CHECKS cases")
    n, m = 1 << 20, DIM // 4
    codes = torch.randint(0, 16, (n, m), dtype=torch.uint8, device=dev, generator=gen)
    lut = torch.randn((BATCH, m, 16), device=dev, generator=gen) * 3
    valid = torch.rand(n, device=dev, generator=gen) > 0.1
    _same_bits(torch, K.pq4_lut_block(lut, codes, valid), K.pq4_lut_block_plain(lut, codes, valid),
               f"pq4_lut_block [{BATCH},{m},16] x [{n},{m}]")
    o = lut_time(torch, K, lut, codes, valid, timer, plain=False)
    parts.append(f"pq4_lut_block [{BATCH},{m},16] x [{n},{m}] equal to the plain version; "
                 f"kernel {o['ms']:.3f} ms, {_bound_text(o)} (the exact sum's FADDs), the "
                 f"one-hot product at the bf16 rate {o['onehot_ms']:.3f} ms")
    del codes, lut, valid
    parts.append(f"bm25_block equal to the plain version at {bm25_checks(torch, K, rng)} "
                 "BM25_CHECKS shapes")
    for shape in (BM25_SHAPE, BM25_DISPATCH_SHAPE):
        o = bm25_time(torch, K, rng, timer, shape, plain=False)
        parts.append(f"bm25_block {list(shape)}: {o['ms']:.4f} ms (CUDA graph of launches; "
                     f"the wrapper called back to back {o['call_ms']:.4f}), {_bound_text(o)}")
    idx, batches = synthetic_hybrid(torch, seed)
    parts.append("fused dispatch split, synthetic FiQA-sized index: "
                 + hybrid_split(torch, idx, batches))
    if hasattr(B, "hybrid_program"):
        parts.append("the first design's program on the same index (padded planes, "
                     "per-array pageable uploads, launches one by one): "
                     + hybrid_split(torch, idx, batches, first_design=True))
    parts.append("the program's stages alone: " + hybrid_stages(torch, idx, *batches[1]))
    return parts


def phase_conformance(K) -> dict:
    """bench.py's kernel conformance through the port's entry point on the
    card; returns the launch counts of its run."""
    from weaviate_tpu_torch.ops.conformance import kernel_conformance

    K.reset_launch_counts()  # phase 8's run starts here
    t0 = time.perf_counter()
    status = kernel_conformance(device="cuda")
    counts = dict(K.launch_counts)
    if status != "ok":
        raise AssertionError(f"kernel conformance: {status}")
    for name in CONFORMANCE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched in phase 8")
    log(f"phase 8 conformance: kernel_conformance(device='cuda') at 128 dims, 8 queries x "
        f"512 rows: {status} in {time.perf_counter() - t0:.2f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# -- phase 9: the server over a real socket --------------------------------------

SERVER_QUERIES = 1024     # 9a: GraphQL nearVector queries, every 4th filtered
SERVER_FILTER_EVERY = 4   # 9a: host filter evaluation bounds the filtered ones
SERVER_FUSED = 64         # 9a: of them again under selection "fused"
SERVER_K = 100
SERVER_QUANT = 128        # 9b: nearVector queries on each quantized collection, half filtered
SERVER_HYBRID = 64        # 9b: hybrid queries on phase 7's collection
WRITE_ROWS, WRITE_BATCH, READ_BACK = 10_000, 1_000, 1_000
# kernels each half of the server phase must launch through the socket
SERVER_KERNELS = {"9a": ("distance_block", "fused_topk_pairs", "fused_topk_scan"),
                  "9c": ("distance_block", "fused_topk_pairs"),
                  "9b": ("bm25_block", "distance_block", "bq_scan_reduce",
                         "pq4_scan_reduce")}


def _grpc_present() -> bool:
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def start_server(db):
    """The port's Server over phase 4's Database on 127.0.0.1, ports
    chosen by the OS, no telemetry. Without grpcio the same assembly
    serves REST alone (Server.assemble), and says so."""
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.server import Server

    cfg = ServerConfig(data_path=db.data_dir, host="127.0.0.1", rest_port=0, grpc_port=0,
                       disable_telemetry=True)
    srv = Server(cfg, device="cuda", db=db)
    if _grpc_present():
        srv.start()
        log(f"phase 9 server: REST + GraphQL on {srv.rest.address}, gRPC on "
            f":{srv.grpc.port} (grpcio present)")
    else:
        srv.assemble()
        log(f"phase 9 server: grpc is absent (import grpc, google.protobuf failed): "
            f"REST + GraphQL on {srv.rest.address} through Server.assemble, no gRPC "
            "listener; nothing installed")
    return srv


def _gql(client, query: str, variables: dict) -> list:
    out = client.graphql(query, variables)
    if "errors" in out:
        raise AssertionError(f"GraphQL errors: {out['errors'][:1]}")
    return next(iter(out["data"]["Get"].values()))


def _near_gql(limit: int, filtered: bool, key: str = "distance") -> str:
    where = f", where: {{path: [\"views\"], operator: GreaterThanEqual, valueInt: {VIEWS_CUT}}}"
    return (f"query Q($v: [Float]) {{ Get {{ %s(limit: {limit}, nearVector: {{vector: $v}}"
            f"{where if filtered else ''}) {{ _additional {{ id {key} }} }} }} }}")


def _timed_text(lat, wall, nq: int) -> str:
    return (f"{nq / wall:.1f} QPS, p50 {np.percentile(lat, 50):.1f} ms, "
            f"p99 {np.percentile(lat, 99):.1f} ms")


def _socket_vs_inproc(col, client, queries, k: int, where, what: str,
                      grpc_port=None, every: int = 2) -> tuple[list[str], dict, list]:
    """``queries`` in process (CLIENTS threads through the batcher, the
    reference) and then over the socket; query i carries ``where`` when
    i % every == every - 1.
    GraphQL answers must equal the in-process ones exactly (ids, distance
    bits); so must gRPC's where grpcio is present. The reference runs
    outside the caller's launch window: it returns the socket closures,
    and the in-process answers."""
    nq = len(queries)
    name = col.config.name
    gql = {f: _near_gql(k, f) % name for f in (False, True)}

    def filtered(i):
        return i % every == every - 1

    def inproc(i):
        return [(r.uuid, r.distance) for r in
                col.near_vector(queries[i], k=k, where=where if filtered(i) else None)]

    ref, lat, wall = _run_clients(inproc, nq)
    parts = [f"{what}: in process {_timed_text(lat, wall, nq)}"]

    def over_graphql():
        def ask(i):
            rows = _gql(client, gql[filtered(i)], {"v": queries[i].tolist()})
            return [(r["_additional"]["id"], r["_additional"]["distance"]) for r in rows]

        out, lat, wall = _run_clients(ask, nq)
        for i, (a, b) in enumerate(zip(ref, out)):
            if a != b:
                raise AssertionError(f"{what} query {i}: GraphQL answer != in-process answer")
        return f"GraphQL over the socket {_timed_text(lat, wall, nq)}, identical"

    def over_grpc():
        import grpc

        from weaviate_tpu_torch.api.grpc import v1_pb2 as pb

        chan = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        search = chan.unary_unary("/weaviate.v1.Weaviate/Search",
                                  request_serializer=pb.SearchRequest.SerializeToString,
                                  response_deserializer=pb.SearchReply.FromString)

        def ask(i):
            req = pb.SearchRequest(collection=name, limit=k)
            req.near_vector.vector_bytes = np.asarray(queries[i], np.float32).tobytes()
            if filtered(i):
                req.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
                req.filters.target.property = "views"
                req.filters.value_int = VIEWS_CUT
            req.metadata.uuid = True
            req.metadata.distance = True
            return [(r.metadata.id, r.metadata.distance) for r in search(req).results]

        try:
            out, lat, wall = _run_clients(ask, nq)
        finally:
            chan.close()
        for i, (a, b) in enumerate(zip(ref, out)):
            if [u for u, _ in a] != [u for u, _ in b] or \
                    [np.float32(d) for _, d in a] != [np.float32(d) for _, d in b]:
                raise AssertionError(f"{what} query {i}: gRPC answer != in-process answer")
        return f"gRPC Search {_timed_text(lat, wall, nq)}, identical"

    runs = {"graphql": over_graphql}
    if grpc_port is not None:
        runs["grpc"] = over_grpc
    return parts, runs, ref


def phase_server_plain(torch, K, seed: int, srv, st4: dict) -> tuple[dict, dict]:
    """Phase 9a, before phase 6 compresses phase 4's collection: GraphQL
    (and gRPC) nearVector at limit 100, half under the 10% filter, held to
    the in-process answers; then SERVER_FUSED of them under selection
    "fused". Counts the socket runs' launches; returns them, and the
    queries with their in-process answers and the gRPC run's figures,
    which phase 9c sends through the native plane."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.filters import Filter, Operator

    dev = "cuda"
    t0 = time.perf_counter()
    col, ref = st4["col"], st4["ref"]
    rng = np.random.default_rng([seed, 91])
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    queries = near_queries(seed + 91, rng.integers(0, len(ref), SERVER_QUERIES),
                           lambda r: ref[torch.from_numpy(r).to(dev)].cpu().numpy())
    client = Client(srv.rest.address, timeout=120.0)
    grpc_port = srv.grpc.port if srv.grpc is not None else None
    idx = next(iter(col.shards.values())).vector_indexes[""]
    idx.store.selection = "approx"
    mix = (f"every {SERVER_FILTER_EVERY}th under where(views >= {VIEWS_CUT}), 10%")
    parts, runs, ref9 = _socket_vs_inproc(col, client, queries, SERVER_K, where,
                                    f"{SERVER_QUERIES} nearVector(limit {SERVER_K}), {mix}, "
                                    "selection approx", grpc_port, SERVER_FILTER_EVERY)
    idx.store.selection = "fused"
    fparts, fruns, _ = _socket_vs_inproc(col, client, queries[:SERVER_FUSED], SERVER_K, where,
                                      f"{SERVER_FUSED} of them under selection fused",
                                      every=SERVER_FILTER_EVERY)
    idx.store.selection = "approx"
    K.reset_launch_counts()  # phase 9a's socket window starts here
    socket = {name: fn() for name, fn in runs.items()}
    parts += socket.values()
    idx.store.selection = "fused"
    try:
        fparts.append(fruns["graphql"]())
    finally:
        idx.store.selection = "approx"
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 9a server ({time.perf_counter() - t0:.1f} s), plain nearVector on phase 4's "
        f"{len(ref)}-row collection over 127.0.0.1 from {CLIENTS} client threads "
        f"({_smi_line()}): " + "; ".join(parts)
        + " | " + "; ".join(fparts) + f"; launches through the socket {counts}")
    _require_server_launches(counts, "9a")
    return counts, dict(queries=queries, ref=ref9, grpc=socket.get("grpc"))


def _require_server_launches(counts: dict, part: str) -> None:
    for name in SERVER_KERNELS[part]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched through the server in phase {part}")


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _quant_queries(torch, col, seed: int, prefix: int, rows: int, tag: int) -> np.ndarray:
    """SERVER_QUANT queries near stored rows of ``col`` (deleted rows are
    skipped), read back through get_object."""
    rng = np.random.default_rng([seed, tag])
    vecs = []
    for r in rng.permutation(rows):
        obj = col.get_object(_uuid(prefix, int(r)))
        if obj is not None:
            vecs.append(obj.vector)
        if len(vecs) == SERVER_QUANT:
            break
    base = np.stack(vecs).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    noise = rng.standard_normal(base.shape).astype(np.float32) * NEAR_NOISE
    return base + noise


def phase_server_rest(torch, K, seed: int, srv, db, st7: dict, rows: int) -> dict:
    """Phase 9b, after phase 7: nearVector on phase 6's PQ and BQ
    collections and hybrid on phase 7's, held to the in-process answers;
    then the write path: WRITE_ROWS new objects through POST
    /v1/batch/objects, READ_BACK of them read back and found first by
    nearVector. Counts the socket runs' launches."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.filters import Filter, Operator

    t0 = time.perf_counter()
    client = Client(srv.rest.address, timeout=120.0)
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    socket_runs, parts = [], []
    for name, prefix, n_rows, tag in (("Wiki", 8000, rows, 92), ("WikiBQ", 8001,
                                                                 BQ_E2E_ROWS, 93)):
        col = db.get_collection(name)
        kind = getattr(next(iter(col.shards.values())).vector_indexes[""].store,
                       "quantization", "flat")
        qs = _quant_queries(torch, col, seed, prefix, n_rows, tag)
        p, r, _ = _socket_vs_inproc(col, client, qs, 10, where,
                                 f"{SERVER_QUANT} nearVector(limit 10), half filtered, on "
                                 f"phase 6's {kind} collection {name}")
        parts.append(p)
        socket_runs.append(r["graphql"])
    # hybrid: GraphQL against Collection.hybrid, phase 7's tie rule
    fiqa = st7["col"]
    hq = _fiqa_queries(seed + 9, st7["df"], True, SERVER_HYBRID)
    rng = np.random.default_rng([seed, 94])
    hv = near_queries(seed + 94, rng.integers(0, len(st7["ref"]), SERVER_HYBRID),
                      lambda r: st7["ref"][torch.from_numpy(r).to("cuda")].cpu().numpy(),
                      NEAR_NOISE)
    fusion_arg = {"relativeScore": "relativeScoreFusion", "rankedFusion": "rankedFusion"}
    hgql = ("query Q($v: [Float], $q: String, $a: Float) { Get { FiQA(limit: %d, "
            "hybrid: {query: $q, alpha: $a, vector: $v, fusionType: %s}) "
            "{ _additional { id score } } } }")

    def hyb_inproc(i):
        fusion, alpha = HYBRID_SETTINGS[i % 3]
        return [(r.uuid, r.score) for r in fiqa.hybrid(hq[i], vector=hv[i], alpha=alpha,
                                                       k=HYBRID_K, fusion=fusion)]

    href, lat, wall = _run_clients(hyb_inproc, SERVER_HYBRID)
    hparts = [f"{SERVER_HYBRID} hybrid(limit {HYBRID_K}) on phase 7's collection: in process "
              f"{_timed_text(lat, wall, SERVER_HYBRID)}"]

    def hyb_socket():
        def ask(i):
            fusion, alpha = HYBRID_SETTINGS[i % 3]
            rows_ = _gql(client, hgql % (HYBRID_K, fusion_arg[fusion]),
                         {"v": hv[i].tolist(), "q": hq[i], "a": alpha})
            return [(r["_additional"]["id"], r["_additional"]["score"]) for r in rows_]

        out, lat, wall = _run_clients(ask, SERVER_HYBRID)
        same = 0
        for i, (a, b) in enumerate(zip(href, out)):
            if not _same_answer(b, a):
                raise AssertionError(f"hybrid query {i}: GraphQL answer != in-process answer")
            same += a == b
        return (f"GraphQL over the socket {_timed_text(lat, wall, SERVER_HYBRID)}, "
                f"{same} identical, {SERVER_HYBRID - same} equal under phase 7's tie rule")

    K.reset_launch_counts()  # phase 9b's socket window starts here
    for p, fn in zip(parts, socket_runs):
        p.append(fn())
    hparts.append(hyb_socket())
    write_text = _server_writes(client, seed)
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 9b server ({time.perf_counter() - t0:.1f} s), quantized, hybrid and the "
        f"write path over 127.0.0.1 from {CLIENTS} client threads ({_smi_line()}): "
        + " | ".join("; ".join(p) for p in parts) + " | " + "; ".join(hparts)
        + f" | {write_text}; launches through the socket {counts}")
    _require_server_launches(counts, "9b")
    return counts


def _server_writes(client, seed: int) -> str:
    """WRITE_ROWS 768-d objects through POST /v1/batch/objects in batches
    of WRITE_BATCH; READ_BACK of them, chosen by seed, must come back from
    GET /v1/objects/{class}/{id} with the stored vector and first from a
    nearVector query on that vector."""
    name = "ServerWrites"
    client.create_class({"class": name, "vectorizer": "none", "vectorIndexType": "flat",
                         "vectorIndexConfig": {"distance": METRIC},
                         "properties": [{"name": "n", "dataType": ["int"]}]})
    rng = np.random.default_rng([seed, 95])
    vecs = rng.standard_normal((WRITE_ROWS, DIM)).astype(np.float32)
    ids = [_uuid(8009, i) for i in range(WRITE_ROWS)]
    # the request bodies are encoded before the clock starts: the rate is
    # the server's (JSON decoding, validation, batch_put), not the client's
    t0 = time.perf_counter()
    bodies = [json.dumps({"objects": [
        {"class": name, "id": ids[i], "properties": {"n": i}, "vector": vecs[i].tolist()}
        for i in range(s, min(WRITE_ROWS, s + WRITE_BATCH))]}).encode()
        for s in range(0, WRITE_ROWS, WRITE_BATCH)]
    encode_s = time.perf_counter() - t0
    host, port = client.addr.rsplit(":", 1)
    t0 = time.perf_counter()
    for body in bodies:
        conn = http.client.HTTPConnection(host, int(port), timeout=300)
        try:
            conn.request("POST", "/v1/batch/objects", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            res = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200 or any(r["result"].get("status") != "SUCCESS" for r in res):
            raise AssertionError(f"batch import failed: {resp.status} {res if resp.status != 200 else res[0]}")
    import_s = time.perf_counter() - t0
    pick = rng.choice(WRITE_ROWS, READ_BACK, replace=False)

    def read(j):
        i = int(pick[j])
        got = client.request("GET", f"/v1/objects/{name}/{ids[i]}",
                             params={"include": "vector"})
        if not np.array_equal(np.asarray(got["vector"], np.float32), vecs[i]):
            raise AssertionError(f"object {ids[i]} read back another vector")
        rows = _gql(client, _near_gql(10, False) % name, {"v": vecs[i].tolist()})
        if rows[0]["_additional"]["id"] != ids[i]:
            raise AssertionError(f"nearVector on object {ids[i]}'s vector returned "
                                 f"{rows[0]['_additional']['id']} first")
        return True

    _out, lat, wall = _run_clients(read, READ_BACK)
    return (f"write path: {WRITE_ROWS} objects through POST /v1/batch/objects in batches of "
            f"{WRITE_BATCH} in {import_s:.1f} s ({WRITE_ROWS / import_s:.0f} objects/s; the "
            f"client encoded the bodies beforehand in {encode_s:.1f} s), {READ_BACK} read back with their vectors and found first by "
            f"nearVector ({_timed_text(lat, wall, READ_BACK)} per read + query)")


# -- phase 9c: the native gRPC data plane -----------------------------------------

PLANE_FAST_SHARE = 0.75    # of 9c's queries the C++ fast path must serve at least
PLANE_BENCH_MS = 3000      # one round of the plane's native load generator
PLANE_BENCH_CONNS, PLANE_BENCH_STREAMS = CLIENTS, 4


def _libnghttp2() -> str:
    """What the dynamic loader knows of libnghttp2 (``ldconfig -p``)."""
    out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                         timeout=60).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if "nghttp2" in ln) or "none"


def phase_server_plane(torch, K, srv, st4: dict, st9a: dict) -> dict:
    """Phase 9c, right after 9a: the server's gRPC served through the
    native data plane, as ``Server`` serves it under
    WEAVIATE_TPU_NATIVE_DATAPLANE=1 (``Server._start_grpc``), beside the
    Python gRPC server 9a used. 9a's SERVER_QUERIES nearVector queries at
    limit 100 from CLIENTS threads (every SERVER_FILTER_EVERY-th under the
    10% filter, which the plane hands to the Python handlers), each answer
    equal to 9a's in-process one; at least PLANE_FAST_SHARE of them served
    by the C++ fast path; then one round of the plane's native load
    generator. Counts the launches of both. Without libnghttp2.so.14 on
    the machine it says so and launches nothing: a missing system
    library, not the device or a kernel; with it, a plane that does not
    build or start fails the run."""
    import grpc

    from weaviate_tpu_torch import dataplane
    from weaviate_tpu_torch.api.grpc import v1_pb2 as pb
    from weaviate_tpu_torch.api.grpc.native_plane import NativeDataPlane

    lib = _libnghttp2()
    if "libnghttp2.so.14" not in lib:
        log(f"phase 9c native plane: this machine has no libnghttp2.so.14 (ldconfig -p: "
            f"{lib}), a missing system library; the Python gRPC server serves (phase 9a)")
        return dict.fromkeys(K.launch_counts, 0)
    t0 = time.perf_counter()
    flag = os.environ.get("WEAVIATE_TPU_NATIVE_DATAPLANE")
    os.environ["WEAVIATE_TPU_NATIVE_DATAPLANE"] = "1"
    try:
        plane = srv._start_grpc()
    finally:
        if flag is None:
            del os.environ["WEAVIATE_TPU_NATIVE_DATAPLANE"]
        else:
            os.environ["WEAVIATE_TPU_NATIVE_DATAPLANE"] = flag
    if not isinstance(plane, NativeDataPlane):
        raise AssertionError(f"libnghttp2.so.14 is present ({lib}) but the server serves "
                             f"{type(plane).__name__}: the plane did not build or start")
    built = (f"built in {dataplane.build_seconds:.1f} s" if dataplane.build_seconds is not None
             else "already built")
    col, queries, ref = st4["col"], st9a["queries"], st9a["ref"]
    name = col.config.name
    chan = grpc.insecure_channel(f"127.0.0.1:{plane.port}")
    try:
        search = chan.unary_unary("/weaviate.v1.Weaviate/Search",
                                  request_serializer=pb.SearchRequest.SerializeToString,
                                  response_deserializer=pb.SearchReply.FromString)

        def request(i):
            req = pb.SearchRequest(collection=name, limit=SERVER_K, uses_123_api=True)
            req.near_vector.vector_bytes = np.asarray(queries[i], np.float32).tobytes()
            if i % SERVER_FILTER_EVERY == SERVER_FILTER_EVERY - 1:
                req.filters.operator = pb.Filters.OPERATOR_GREATER_THAN_EQUAL
                req.filters.target.property = "views"
                req.filters.value_int = VIEWS_CUT
            req.metadata.uuid = True
            req.metadata.distance = True
            return req

        # the first Search of a collection takes the fallback and registers
        # it; the reply cache then warms on its own thread: both timed
        t1 = time.perf_counter()
        search(request(0), timeout=120)
        if not plane.wait_registered(name, 60.0):
            raise AssertionError(f"the plane did not register {name}")
        plane.warm_collection(name)
        warm_s = time.perf_counter() - t1
        cache0 = plane.dp.cache_stats()
        f0, b0 = plane.dp.stats()

        def ask(i):
            return [(r.metadata.id, r.metadata.distance)
                    for r in search(request(i), timeout=120).results]

        K.reset_launch_counts()  # phase 9c's window starts here
        out, lat, wall = _run_clients(ask, len(queries))
        f1, b1 = plane.dp.stats()
        cache1 = plane.dp.cache_stats()
        head = pb.SearchRequest(collection=name, limit=SERVER_K, uses_123_api=True)
        head.metadata.uuid = True
        head.metadata.distance = True
        bench = dataplane.bench(plane.port, PLANE_BENCH_CONNS, PLANE_BENCH_STREAMS,
                                PLANE_BENCH_MS, DIM, head.SerializeToString())
        counts = dict(K.launch_counts)  # ... and ends here
    finally:
        chan.close()
        plane.stop()
    for i, (a, b) in enumerate(zip(ref, out)):
        if [u for u, _ in a] != [u for u, _ in b] or \
                [np.float32(d) for _, d in a] != [np.float32(d) for _, d in b]:
            raise AssertionError(f"9c query {i}: the plane's answer != the in-process answer")
    fast, fallback = f1 - f0, b1 - b0
    if fast < PLANE_FAST_SHARE * len(queries):
        raise AssertionError(f"9c: the C++ fast path served {fast} of {len(queries)} queries")
    if bench["errors"] or bench["done"] <= 0:
        raise AssertionError(f"9c: the native load generator failed: {bench}")
    log(f"phase 9c native plane ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
        f"libnghttp2 {lib}; plane library {built}; served by Server._start_grpc under "
        f"WEAVIATE_TPU_NATIVE_DATAPLANE=1 on :{plane.port}; registration + reply cache warm "
        f"of {cache0['entries']} objects {warm_s:.1f} s; {len(queries)} gRPC "
        f"nearVector(limit {SERVER_K}) from {CLIENTS} client threads, every "
        f"{SERVER_FILTER_EVERY}th under where(views >= {VIEWS_CUT}): "
        f"{_timed_text(lat, wall, len(queries))}, identical to the in-process answers; "
        f"fast path {fast}, fallback {fallback}; reply cache hits "
        f"{cache1['hits'] - cache0['hits']}, misses {cache1['misses'] - cache0['misses']} | "
        f"9a through the Python gRPC server: {st9a['grpc']} | native load generator "
        f"({PLANE_BENCH_CONNS} connections x {PLANE_BENCH_STREAMS} streams, "
        f"{PLANE_BENCH_MS} ms, random vectors, limit {SERVER_K}): {bench['done']} "
        f"requests, {bench['qps']:.1f} QPS, p50 {bench['p50_ms']:.1f} ms, p99 "
        f"{bench['p99_ms']:.1f} ms, {bench['errors']} errors; launches through the plane "
        f"{counts}")
    _require_server_launches(counts, "9c")
    return counts


# -- phase 10: the epoch store ------------------------------------------------------

EPOCH_COUNT = 8               # index level: the rows in 8 epochs (131,072 rows,
                              # 16 chunks, each at 1M rows)
EPOCH_QUERIES = 256
EPOCH_FILTER = 0.10           # per-query filters' selectivity
EPOCH_DELETE_FRAC = 0.30      # of the live rows of three epochs: two full ones
                              # and the last (1, 4 and 7 of 8)
EPOCH_COL_ROWS = 200_000      # collection level: 2 shards
EPOCH_COL_EPOCH_ROWS = 32_768
EPOCH_COL_QUOTA_AT = 180_000  # rows imported when shard-0's quota is set at its usage
EPOCH_COL_QUERIES = 64
PQ_TRAIN_ROWS = 65_536
EPOCH_KERNELS = ("distance_block", "fused_topk_scan", "fused_topk_pairs",
                 "bq_scan_reduce", "pq4_scan_reduce")


def _bits_equal(got, want, what: str) -> None:
    """(d, i) pairs: ids equal and distances equal bit for bit."""
    (gd, gi), (wd, wi) = got, want
    gd, wd = np.asarray(gd, np.float32), np.asarray(wd, np.float32)
    if not np.array_equal(np.asarray(gi), np.asarray(wi)):
        raise AssertionError(f"{what}: {int((np.asarray(gi) != np.asarray(wi)).sum())} ids "
                             "differ from the single buffer's")
    if not np.array_equal(gd.view(np.int32), wd.view(np.int32)):
        raise AssertionError(f"{what}: distances differ from the single buffer's bits "
                             f"(max {float(np.nanmax(np.abs(gd - wd)))})")


def _epoch_bytes(ledger, owner) -> dict:
    """Ledger bytes per epoch of ``owner``'s index: {eid: bytes}."""
    out = {}
    for comp, b in ledger.shard_component_bytes(*owner).items():
        if "@e" in comp:
            eid = int(comp.rsplit("@e", 1)[1])
            out[eid] = out.get(eid, 0) + b
    return out


def _epoch_rows(rows: int) -> int:
    """The power of two that cuts ``rows`` into EPOCH_COUNT epochs."""
    return 1 << (-(-rows // EPOCH_COUNT) - 1).bit_length()


def phase_epochs(torch, K, seed: int, rows: int, st3: dict) -> dict:
    """Phase 10, the epoch store at full width. Index level: phase 3's
    rows and deletes in a FlatIndex whose epoch_rows cuts them into
    EPOCH_COUNT sealed epochs (131,072 at 1M rows), EPOCH_QUERIES of phase 3's queries at k 10 and 100,
    selections approx and fused, unfiltered and under per-query 10%
    filters, every answer bit for bit phase 3's single buffer's; then 30%
    of the rows of three epochs deleted from both, ``maintain()`` (the
    epochs' ledger bytes and torch.cuda.memory_allocated before and after)
    and the same answers again; then BQ and 4-bit PQ epoch indexes on the
    same rows against single quantized stores built as phase 5's (one
    codebook), bit for bit. Collection level: a 2-shard Database
    collection of EPOCH_COL_ROWS rows with epoch_rows EPOCH_COL_EPOCH_ROWS
    whose shard-0 quota is set at its usage at EPOCH_COL_QUOTA_AT rows, so
    that the last imports migrate epochs; every acknowledged write read
    back exactly once, nearVector answers equal to an exact
    recomputation. The single-buffer references' launches are subtracted
    from the phase's count (the path is the epoch stores'). Then
    fused_topk_pairs timed at the merge shapes [256 / 8, 8 x k]."""
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.runtime import hbm_ledger
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger
    from weaviate_tpu_torch.runtime.metrics import epoch_migrations
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  ShardingConfig, VectorConfig,
                                                  VectorIndexConfig)

    dev = "cuda"
    t0 = time.perf_counter()
    idx, corpus, deleted = st3["idx"], st3["corpus"], st3["deleted"]
    qb = st3["queries"][:EPOCH_QUERIES]
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    masks = (torch.rand((EPOCH_QUERIES, idx.store.capacity), device=dev, generator=gen)
             < EPOCH_FILTER).cpu().numpy()
    yard = dict.fromkeys(K.launch_counts, 0)  # the references' launches, not the path's
    merges = {"dispatches": 0, "pairs": 0}    # fused epoch dispatches, their merges' launches
    parts = []

    def reference(fn):
        before = dict(K.launch_counts)
        out = fn()
        for kn, c in K.launch_counts.items():
            yard[kn] += c - before[kn]
        return out

    def timed(fn):
        """fn's answer and the ms of its second call (the first warms it)."""
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t1) * 1e3

    def flat_answer(index, filtered, k):
        if filtered:
            return index.store.search_async(qb, k, masks).result()
        ids, d = index.search_by_vector_batch_async(qb, k).result()
        return d, ids

    def flat_runs(eidx, what):
        es = eidx.epoch_store
        times = []
        for sel in ("approx", "fused"):
            idx.store.selection = es.selection = sel
            for k in (10, TOP_K):
                for filtered in (False, True):
                    want, t_s = reference(lambda: timed(lambda: flat_answer(idx, filtered, k)))
                    before = dict(K.launch_counts)
                    got, t_e = timed(lambda: flat_answer(eidx, filtered, k))
                    if sel == "fused":
                        merges["dispatches"] += 2
                        merges["pairs"] += (K.launch_counts["fused_topk_pairs"]
                                            - before["fused_topk_pairs"]
                                            - (K.launch_counts["fused_topk_scan"]
                                               - before["fused_topk_scan"]))
                    run = f"{sel} k={k}" + (" filtered" if filtered else "")
                    _bits_equal(got, want, f"{what} {run}")
                    times.append(f"{run} {t_e:.1f} / {t_s:.1f}")
        idx.store.selection = es.selection = "approx"
        return (f"{what}: 8 runs (approx / fused x k 10 / {TOP_K} x unfiltered / per-query "
                f"{EPOCH_FILTER:.0%} filters) bit for bit the single buffer's; "
                f"{EPOCH_QUERIES}-query batch ms, epochs / one buffer (second call, host "
                "clock): " + ", ".join(times))

    K.reset_launch_counts()  # phase 10's run starts here
    # -- index level ---------------------------------------------------------
    owner = ("Phase10", "index")
    t1 = time.perf_counter()
    with hbm_ledger.owner(*owner):
        eidx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK,
                         epoch_rows=_epoch_rows(rows), device=dev)
    for s in range(0, rows, ADD_BATCH):
        eidx.add_batch(np.arange(s, min(rows, s + ADD_BATCH)), corpus[s:s + ADD_BATCH])
    eidx.delete(*deleted.tolist())
    es = eidx.epoch_store
    es.seal_active()
    torch.cuda.synchronize()
    stats = [e for e in es.epoch_stats() if e["rows"]]
    parts.append(f"index: {rows} rows in {len(stats)} sealed epochs of "
                 f"{[e['rows'] for e in stats]} rows (capacity {es.capacity}) built in "
                 f"{time.perf_counter() - t1:.1f} s, {len(deleted)} deleted as phase 3")
    parts.append(flat_runs(eidx, "before deletes"))
    n_sealed = len(stats)
    cut = (1, n_sealed // 2, n_sealed - 1)
    doomed = np.concatenate([
        np.sort(np.random.default_rng([seed, 10, eid]).choice(
            es.live_globals_of(eid), int(es.epochs[eid].live_count() * EPOCH_DELETE_FRAC),
            replace=False)) for eid in cut])
    eidx.delete(*doomed.tolist())
    idx.delete(*doomed.tolist())
    st3["deleted"] = np.union1d(deleted, doomed)  # phase 16d reads phase 3's index after
    gc.collect()
    torch.cuda.synchronize()
    b_before, a_before = _epoch_bytes(ledger, owner), torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    if not es.maintain():
        raise AssertionError("maintain() did nothing after the deletes")
    torch.cuda.synchronize()
    maintain_s = time.perf_counter() - t1
    gc.collect()
    b_after, a_after = _epoch_bytes(ledger, owner), torch.cuda.memory_allocated()
    if es.compactions_total != len(cut):
        raise AssertionError(f"{es.compactions_total} epochs compacted, not {len(cut)}")
    freed = sum(b_before[e] - b_after[e] for e in cut)
    if freed <= 0:
        raise AssertionError("compaction released no ledger bytes of its epochs")
    parts.append(
        f"{len(doomed)} rows deleted ({EPOCH_DELETE_FRAC:.0%} of epochs "
        f"{list(cut)}), maintain() {maintain_s:.2f} s compacted "
        f"{es.compactions_total} epochs: ledger bytes "
        + ", ".join(f"e{e} {b_before[e]} -> {b_after[e]}" for e in cut)
        + f" ({freed} released), the other epochs unchanged "
        f"({sum(b_before.values()) - freed == sum(b_after.values())}); "
        f"torch.cuda.memory_allocated {a_before} -> {a_after}")
    parts.append(flat_runs(eidx, "after the compaction"))
    del eidx, es
    # -- quantized epochs against single quantized stores ---------------------
    for quant in ("bq", "pq4"):
        t1 = time.perf_counter()
        kw = {"quantization": "bq" if quant == "bq" else "pq"}
        single = reference(lambda: FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK,
                                             device=dev, **kw))
        if quant == "pq4":
            reference(lambda: single.store.train(corpus[:PQ_TRAIN_ROWS]))
            kw["codebook"] = single.store.codebook
        eq = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK,
                       epoch_rows=_epoch_rows(rows), device=dev, **kw)
        for s in range(0, rows, ADD_BATCH):
            ids_ = np.arange(s, min(rows, s + ADD_BATCH))
            reference(lambda: single.add_batch(ids_, corpus[s:s + ADD_BATCH]))
            eq.add_batch(ids_, corpus[s:s + ADD_BATCH])
        for ix in (single, eq):
            ix.delete(*deleted.tolist())
        build_s = time.perf_counter() - t1
        times = []
        for sel, k, filtered in (("approx", 10, False), ("approx", TOP_K, False),
                                 ("fused", 10, False), ("approx", 10, True)):
            single.store.selection = eq.store.selection = sel
            want, t_s = reference(lambda: timed(lambda: flat_answer(single, filtered, k)))
            got, t_e = timed(lambda: flat_answer(eq, filtered, k))
            run = f"{sel} k={k}" + (" filtered" if filtered else "")
            _bits_equal(got, want, f"{quant} {run}")
            times.append(f"{run} {t_e:.1f} / {t_s:.1f}")
        parts.append(f"{quant}: epoch index and single store on the same rows (one "
                     f"codebook) built in {build_s:.1f} s; bit for bit the single store's "
                     f"(one host rescore after the merge); {EPOCH_QUERIES}-query batch ms, "
                     "epochs / single (second call, host clock): " + ", ".join(times))
        del single, eq
        torch.cuda.empty_cache()
    # -- collection level ----------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_epochs_")
    db = Database(tmp, device=dev)
    try:
        col = db.create_collection(CollectionConfig(
            name="EpochWiki",
            properties=[Property(name="category", data_type="text"),
                        Property(name="views", data_type="int")],
            vectors=[VectorConfig(index=VectorIndexConfig(
                index_type="flat", metric=METRIC, epoch_rows=EPOCH_COL_EPOCH_ROWS))],
            sharding=ShardingConfig(desired_count=2)))
        cent = centers(seed + 10)
        rng = np.random.default_rng([seed, 10])
        ref = torch.empty((EPOCH_COL_ROWS, DIM), dtype=torch.float32, device=dev)
        rows_host = np.empty((EPOCH_COL_ROWS, DIM), dtype=np.float32)
        acked = []
        quota = None
        t1 = time.perf_counter()
        for s in range(0, EPOCH_COL_ROWS, IMPORT_BATCH):
            if s == EPOCH_COL_QUOTA_AT:
                fat = col.shards["shard-0"]
                quota = ledger.shard_bytes("EpochWiki", "shard-0")
                fat.shard_hbm_limit = quota  # over its 90% watermark from here on
                before_mig = epoch_migrations.labels("EpochWiki", "shard-0").value
            n = min(IMPORT_BATCH, EPOCH_COL_ROWS - s)
            v = rows_host[s:s + n] = clustered(seed + 10, s, n, cent)
            res = col.batch_put([
                {"uuid": _uuid(8010, s + i),
                 "properties": {"category": f"cat{(s + i) % 100}",
                                "views": int(rng.integers(0, 100))},
                 "vector": v[i]} for i in range(n)])
            acked += [r["uuid"] for r in res if r["status"] == "SUCCESS"]
            ref[s:s + n] = torch.nn.functional.normalize(torch.from_numpy(v).to(dev), dim=1)
        import_s = time.perf_counter() - t1
        migrated = epoch_migrations.labels("EpochWiki", "shard-0").value - before_mig
        if len(acked) != EPOCH_COL_ROWS:
            raise AssertionError(f"{EPOCH_COL_ROWS - len(acked)} writes were not acknowledged")
        if migrated < 1:
            raise AssertionError("no epoch migrated under shard-0's quota")
        held = [set(col.shards[n_]._doc_to_uuid.values()) for n_ in ("shard-0", "shard-1")]
        if held[0] & held[1] or held[0] | held[1] != set(acked) or \
                sum(len(h) for h in held) != len(acked):
            raise AssertionError("an acknowledged write is lost or held twice")
        moved = [u for u in acked if col.shards["shard-0"].migrated_to(u)]
        sample = np.random.default_rng([seed, 11]).choice(len(acked), 1000, replace=False)
        for u in [acked[j] for j in sample] + moved[:1000]:
            obj = col.get_object(u)
            if obj is None or not np.array_equal(np.asarray(obj.vector, np.float32),
                                                 rows_host[_row_of(obj)]):
                raise AssertionError(f"{u} did not read back")
        rows_q = rng.integers(0, EPOCH_COL_ROWS, EPOCH_COL_QUERIES)
        qs = near_queries(seed + 10, rows_q, lambda r: ref[torch.from_numpy(r).to(dev)]
                          .cpu().numpy(), NEAR_NOISE)
        where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
        res, lat, wall = _run_clients(
            lambda i: col.near_vector(qs[i], k=10, include_objects=False), len(qs))
        qn = torch.nn.functional.normalize(torch.from_numpy(qs).to(dev), dim=1)
        live = torch.ones(EPOCH_COL_ROWS, dtype=torch.bool, device=dev)
        d_full = reference(lambda: _exact_distances(torch, qn, ref, live[None, :]))
        for r_ in res:
            if len({x.uuid for x in r_}) != len(r_):
                raise AssertionError("a nearVector answer holds one object twice")
        _check_against_exact(torch, d_full, [[_row_of(x) for x in r_] for r_ in res], 10,
                             "epoch collection nearVector")
        filt = col.near_vector(qs[0], k=10, where=where, include_objects=True)
        if any(x.object.properties["views"] < VIEWS_CUT for x in filt):
            raise AssertionError("the filtered nearVector returned a disallowed object")
        shard_stats = {n_: [(e["rows"], e["live"]) for e in
                            col.shards[n_].vector_indexes[""].epoch_store.epoch_stats()]
                       for n_ in ("shard-0", "shard-1")}
        parts.append(
            f"collection: 2 shards, epoch_rows {EPOCH_COL_EPOCH_ROWS}, {EPOCH_COL_ROWS} "
            f"objects through batch_put in {import_s:.1f} s ({EPOCH_COL_ROWS / import_s:.0f} "
            f"objects/s), shard-0's quota set at its usage {quota} bytes at "
            f"{EPOCH_COL_QUOTA_AT} rows: {int(migrated)} epoch migrations "
            f"({len(moved)} objects) to shard-1, shard-0 now "
            f"{ledger.shard_bytes('EpochWiki', 'shard-0')} bytes; every acknowledged write "
            f"held exactly once ({len(held[0])} + {len(held[1])}), 1000 sampled and "
            f"{min(1000, len(moved))} migrated read back with their vectors; "
            f"{EPOCH_COL_QUERIES} nearVector(k=10) from {CLIENTS} clients "
            f"{_timed_text(lat, wall, len(qs))}, recall@10 1.0 against the exact "
            f"recomputation; epochs (rows, live) {shard_stats}")
        del d_full, ref
    finally:
        db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {kn: c - yard[kn] for kn, c in K.launch_counts.items()}  # ... and ends here
    if merges["pairs"] != merges["dispatches"] or not merges["dispatches"]:
        raise AssertionError(f"merge_epoch_topk launched fused_topk_pairs {merges['pairs']} "
                             f"times in {merges['dispatches']} fused dispatches")
    log(f"phase 10 epochs ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
        + " | ".join(parts) + f" | merge_epoch_topk launched fused_topk_pairs once in each "
        f"of the {merges['dispatches']} fused dispatches; launches {counts}")
    for name in EPOCH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 10")
    torch.cuda.empty_cache()
    return counts


def merge_times(torch, K) -> dict:
    """fused_topk_pairs at the epoch merge's shapes [256 / 8, 8 x k] for
    k = 10 and 100 (8 epochs of k survivors each): held to its plain
    version, timed from a CUDA graph beside torch.topk and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for b in (256, 8):
        for k in (10, TOP_K):
            m = 8 * k
            sets = [(torch.rand((b, m), device="cuda", generator=gen),
                     torch.randint(0, 1 << 20, (b, m), device="cuda", dtype=torch.int32,
                                   generator=gen)) for _ in range(8)]
            v, i = sets[0]
            kd, ki = K.fused_topk_pairs(v, i, k)
            pd, pi = K.fused_topk_pairs_plain(v, i, k)
            if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
                raise AssertionError(f"fused_topk_pairs [{b},{m}] k={k} != its plain version")
            ms = graph_ms(torch, K, [lambda v=v, i=i: K.fused_topk_pairs(v, i, k)
                                     for v, i in sets])
            lib = graph_ms(torch, K, [lambda v=v: torch.topk(v, k, dim=1, largest=False)
                                      for v, _ in sets])
            bm, by = _pairs_bound(b, m, k)
            out[f"[{b},{m}] k={k}"] = dict(ms=ms, library_ms=lib, bound_ms=bm, bound_by=by)
    log("phase 10 merge shapes: fused_topk_pairs equal to its plain version at "
        + "; ".join(f"{s}: kernel {o['ms']:.4f} ms, torch.topk {o['library_ms']:.4f} ms, "
                    f"bound {o['bound_ms']:.5f} ms ({o['bound_by']}, "
                    f"{o['bound_ms'] / o['ms']:.1%})" for s, o in out.items())
        + " (CUDA graph of launches over 8 operand sets)")
    return out


# -- phase 11: the ANN indexes on the card -------------------------------------
#
# The SIFT1M row of Weaviate's published ANN benchmark
# (weaviate.io/developers/weaviate/benchmarks/ann): 1,000,000 x 128,
# l2-squared, maxConnections 32, efConstruction 128, an ef sweep, limit 10
# (also the JAX package's HNSW defaults). The vectors are clustered
# Gaussians made from --seed (no SIFT file is in the repository).

ANN_DIM = 128
ANN_ROWS = 1_000_000
ANN_QUERIES = 1000        # half near a row, half fresh draws
ANN_K = 10
ANN_M, ANN_EFC = 32, 128
ANN_EFS = (64, 128, 256, 512)
ANN_RECALL_EF512 = 0.95   # hard limit of 11a
ANN_SUBSET = 50_000       # card-built vs host-built graph
ANN_SUBSET_TOL = 0.01
ANN_INSERTS, ANN_DELETES = 2000, 10_000
ANN_NLIST = 1024
ANN_NPROBES = (8, 16, 32)
ANN_BATCH = 256
ANN_FULL_PROBE = 16       # queries of the nprobe = nlist check
ANN_DELTA_ROWS = 5000     # stay below the delta's 8,192-row flush
ANN_PQ_TOL = 0.05         # IVF-PQ within this recall of f32 IVF at nprobe 32
DYN_ROWS, DYN_FIRST = 200_000, 5000
ANN_SERVER_ROWS, ANN_SERVER_QUERIES = 20_000, 64
ANN_KERNELS = {"11a": ("fused_topk_scan", "fused_topk_pairs"),
               "11b": ("distance_block", "fused_topk_pairs")}


ANN_SUBSPACE = 16         # the corpus's intrinsic dimension
ANN_NOISE = 0.05          # isotropic noise a dimension on top of it


def ann_rows(seed: int, key: int, count: int) -> np.ndarray:
    """``count`` rows of the 128-d corpus drawn under ``key``: one of
    1,024 centres plus noise of a per-row scale (0.3-1.2), as clustered()
    draws them, but in a 16-dimensional subspace shared by every cluster,
    then mapped to 128 dims, plus small isotropic noise. SIFT's
    descriptors have a low intrinsic dimension and form no islands. Two
    other recipes fail the benchmark's recall for the data's sake, not the
    index's: isotropic 128-d noise (clustered() as it is: the JAX
    package's host-path graph reads recall@10 0.73 at ef 512 on 20 such
    clusters of 1,000 rows, a CPU run), and a subspace per cluster, whose
    clusters are islands that the bulk build's exact kNN lists never
    bridge (PERF.md, "Open questions")."""
    space = np.random.default_rng([seed, 1 << 42])
    basis = space.standard_normal((ANN_SUBSPACE, ANN_DIM), dtype=np.float32) \
        / np.float32(np.sqrt(ANN_SUBSPACE))
    cent = space.standard_normal((1024, ANN_SUBSPACE), dtype=np.float32)
    rng = np.random.default_rng([seed, 1 << 43, key])
    assign = rng.integers(0, len(cent), count)
    scale = rng.uniform(0.3, 1.2, (count, 1)).astype(np.float32)
    w = cent[assign] + scale * rng.standard_normal((count, ANN_SUBSPACE), dtype=np.float32)
    return w @ basis + ANN_NOISE * rng.standard_normal((count, ANN_DIM), dtype=np.float32)


def ann_corpus(seed: int, n: int) -> np.ndarray:
    return ann_rows(seed, 0, n)


def ann_queries(seed: int, X: np.ndarray, n: int = ANN_QUERIES) -> np.ndarray:
    """Half next to a corpus row (noise ANN_NOISE a dimension), half fresh
    draws from the clusters."""
    rng = np.random.default_rng([seed, 111])
    near = X[rng.integers(0, len(X), n // 2)]
    near = near + ANN_NOISE * rng.standard_normal(near.shape, dtype=np.float32)
    return np.concatenate([near, ann_rows(seed, 1 << 30, n - n // 2)]).astype(np.float32)


def ann_truth(torch, X64, q: np.ndarray, k: int = ANN_K, dead=None, allow=None):
    """Exact top-k ids [B, k] (numpy) by l2 in f64 on the card. ``dead``
    [N] bool rows never count; ``allow`` [B, N] bool per query."""
    out = []
    for s in range(0, len(q), 250):
        qb = torch.from_numpy(q[s:s + 250]).to("cuda").double()
        d = (qb * qb).sum(1, keepdim=True) - 2.0 * qb @ X64.T + (X64 * X64).sum(1)[None]
        if dead is not None:
            d[:, dead] = float("inf")
        if allow is not None:
            d = torch.where(allow[s:s + 250], d, torch.full_like(d, float("inf")))
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy())
        del d
    return np.concatenate(out)


def ann_recall(got, truth) -> float:
    return float(np.mean([len(set(g[g >= 0].tolist()) & set(t.tolist())) / len(t)
                          for g, t in zip(got, truth)]))


def _build_scan_times(torch, K, X: np.ndarray, timer) -> str:
    """fused_topk_scan at the bulk build's shape: 1,024 corpus rows as
    queries against the bf16 copy of the corpus, k 49, l2 norms from the
    f32 rows; held to its plain version, timed beside addmm + topk.
    Returns (its text, whether it equalled the plain version)."""
    xf = torch.from_numpy(X).to("cuda")
    xb = xf.to(torch.bfloat16)
    norms = (xf * xf).sum(1)
    del xf
    q = xb[:1024]
    k = 49
    kd, ki = K.fused_topk_scan(q, xb, k, metric="l2-squared", x_sq_norms=norms)
    pd, pi = K.fused_topk_scan_plain(q, xb, k, "l2-squared", None, norms)
    if not (torch.equal(ki, pi) and torch.equal(kd, pd)):
        bad = int((ki != pi).sum())
        return (f"fused_topk_scan at the build shape != its plain version ({bad} ids, "
                f"{int((kd != pd).sum())} distances differ)"), False
    ms = timer(lambda: K.fused_topk_scan(q, xb, k, metric="l2-squared", x_sq_norms=norms),
               reps=5)
    qf, xt = q.float(), xb.float().T.contiguous()

    def lib():
        d = torch.addmm(norms[None, :], qf, xt, alpha=-2.0)
        return torch.topk(d, k, dim=1, largest=False)

    lib_ms = timer(lib, reps=5)
    n, d = xb.shape
    bm, by = bound_ms(n * d * 2 + 1024 * d * 2 + n * 4 + 1024 * k * 8,
                      2.0 * 1024 * n * d, BF16_FLOPS)
    del xb, xt, qf, norms
    torch.cuda.empty_cache()
    return (f"fused_topk_scan at the build shape [1024, {d}] x [{n}, {d}] bf16, k {k}: "
            f"equal to its plain version, kernel {ms:.3f} ms, addmm + topk {lib_ms:.3f} ms, "
            f"bound {bm:.4f} ms ({by}, {bm / ms:.1%})"), True


def _layer0_components(idx) -> str:
    """Strongly connected components of the graph's layer 0 (scipy): a
    bulk-built graph over clusters that its kNN lists never bridge falls
    apart into islands, and a walk cannot leave the one it enters."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    n = idx._count
    links = [idx._links[s][0] if idx._links[s] else np.empty(0, np.int32)
             for s in range(n)]
    lens = np.fromiter((len(x) for x in links), dtype=np.int64, count=n)
    cols = np.concatenate(links).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    g = csr_matrix((np.ones(len(cols), np.int8), cols, indptr), shape=(n, n))
    comps, labels = connected_components(g, directed=True, connection="strong")
    return (f"layer 0 has {comps} strongly connected components, the largest "
            f"{np.bincount(labels).max() / n:.4f} of the rows")


def _hnsw_search(idx, queries, ef: int):
    idx.ef = ef
    out, lat, wall = _run_clients(lambda i: idx.search_by_vector(queries[i], ANN_K), len(queries))
    ids = np.full((len(queries), ANN_K), -1, np.int64)
    dists = np.full((len(queries), ANN_K), np.inf, np.float32)
    for r, (i, d) in enumerate(out):
        ids[r, :len(i)] = i
        dists[r, :len(d)] = d
    return ids, dists, len(queries) / wall


def phase_ann_hnsw(torch, K, seed: int, X, X64, queries, truth, timer) -> dict:
    """11a: HNSW bulk-built on the card, searched through the C++ walker.
    Each part logs its line as it ends; the hard limits are checked at the
    end, so a failing run still prints every reading."""
    from weaviate_tpu_torch.engine import hnsw_build
    from weaviate_tpu_torch.engine.hnsw import HNSWIndex

    t0 = time.perf_counter()
    fails = []
    n = len(X)
    half = len(queries) // 2  # near queries first, then fresh ones
    # the kernel at the build's shape, outside the path's launch window
    scan_text, scan_ok = _build_scan_times(torch, K, X, timer)
    if not scan_ok:
        fails.append(scan_text)
    idx = HNSWIndex(dim=ANN_DIM, metric="l2-squared", max_connections=ANN_M,
                    ef_construction=ANN_EFC, capacity=n, device="cuda")
    K.reset_launch_counts()  # phase 11a's window starts here
    t1 = time.perf_counter()
    idx.add_batch(np.arange(n), X)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    stages = dict(hnsw_build.BUILD_STAGE_SECONDS)
    t1 = time.perf_counter()
    with idx._lock:
        idx._native_sync()
    stages["native_sync"] = time.perf_counter() - t1
    layers = [int((idx._levels[:n] >= ly).sum()) for ly in range(idx._max_level + 1)]
    t1 = time.perf_counter()
    comps = _layer0_components(idx)
    comps += f" ({time.perf_counter() - t1:.1f} s, scipy)"
    log(f"phase 11a HNSW: HNSWIndex(device='cuda') {n} x {ANN_DIM} l2-squared, M {ANN_M}, "
        f"efConstruction {ANN_EFC}: bulk build in {build_s:.1f} s (layer members {layers}; "
        + ", ".join(f"{s} {v:.2f}" for s, v in stages.items()) + f" s); {comps}; {scan_text}")
    sweep = {}
    for ef in ANN_EFS:
        ids, _d, qps = _hnsw_search(idx, queries, ef)
        sweep[ef] = ann_recall(ids, truth)
        log(f"phase 11a HNSW: ef {ef}: recall@10 {sweep[ef]:.4f} (near {ann_recall(ids[:half], truth[:half]):.4f}, "
            f"fresh {ann_recall(ids[half:], truth[half:]):.4f}), {qps:.0f} QPS from {CLIENTS} "
            f"threads ({len(queries)} queries)")
    if sweep[512] < ANN_RECALL_EF512:
        fails.append(f"HNSW recall@10 at ef 512 {sweep[512]:.4f} < {ANN_RECALL_EF512}")
    # the card's graph against the host path's on a subset
    sub = X[:ANN_SUBSET]
    truth_s = ann_truth(torch, X64[:ANN_SUBSET], queries)
    rec = {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        g = HNSWIndex(dim=ANN_DIM, metric="l2-squared", max_connections=ANN_M,
                      ef_construction=ANN_EFC, capacity=ANN_SUBSET, device=dev)
        t1 = time.perf_counter()
        g.add_batch(np.arange(ANN_SUBSET), sub)
        b_s = time.perf_counter() - t1
        ids_g, _d, _q = _hnsw_search(g, queries, 64)
        rec[where] = (ann_recall(ids_g, truth_s), b_s)
        del g
    log(f"phase 11a HNSW: {ANN_SUBSET}-row subset at ef 64: card-built recall@10 "
        f"{rec['card'][0]:.4f} (built in {rec['card'][1]:.1f} s), host-built "
        f"{rec['host'][0]:.4f} ({rec['host'][1]:.1f} s)")
    if abs(rec["card"][0] - rec["host"][0]) > ANN_SUBSET_TOL:
        fails.append(f"{ANN_SUBSET}-row subset: the card's graph reads recall@10 "
                     f"{rec['card'][0]:.4f} at ef 64, the host path's {rec['host'][0]:.4f}")
    # incremental inserts and deletes on the bulk graph
    extra = ann_rows(seed, 1 << 29, ANN_INSERTS)
    t1 = time.perf_counter()
    idx.add_batch(np.arange(n, n + ANN_INSERTS), extra)
    ins_s = time.perf_counter() - t1
    rng = np.random.default_rng([seed, 112])
    dead = rng.choice(n + ANN_INSERTS, ANN_DELETES, replace=False)
    idx.delete(*dead.tolist())
    X2 = torch.cat([X64, torch.from_numpy(extra).to("cuda").double()])
    dmask = torch.zeros(len(X2), dtype=torch.bool, device="cuda")
    dmask[torch.from_numpy(dead).to("cuda")] = True
    truth2 = ann_truth(torch, X2, queries, dead=dmask)
    del X2
    ids, dists, qps = _hnsw_search(idx, queries, 128)
    if set(dead.tolist()).intersection(ids.ravel().tolist()):
        fails.append("HNSW returned a deleted id")
    parts = [f"{ANN_INSERTS} incremental inserts in {ins_s:.1f} s ({ANN_INSERTS / ins_s:.0f}/s), "
             f"{ANN_DELETES} deletes: ef 128 recall@10 {ann_recall(ids, truth2):.4f}, "
             f"{qps:.0f} QPS, no deleted id"]
    # snapshot and restore: the same answers
    t1 = time.perf_counter()
    back = HNSWIndex.restore(idx.snapshot(), device="cuda")
    snap_s = time.perf_counter() - t1
    ids_b, dists_b, _ = _hnsw_search(back, queries, 128)
    if not (np.array_equal(ids_b, ids) and np.array_equal(dists_b, dists)):
        fails.append("the restored HNSW index answers differently")
    parts.append(f"snapshot + restore in {snap_s:.1f} s, answers identical")
    del back
    counts = dict(K.launch_counts)  # ... and ends here
    for name in ANN_KERNELS["11a"]:
        if counts[name] <= 0:
            fails.append(f"{name} was not launched by the HNSW bulk build")
    log(f"phase 11a HNSW ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
        + "; ".join(parts) + f"; launches {counts}")
    if fails:
        raise AssertionError("phase 11a: " + "; ".join(fails))
    return counts


def _ivf_batches(torch, idx, queries, allow=None):
    """256-query batches through search_by_vector_batch: ids [B, k], the
    median batch ms (host clock, synchronized)."""
    ids, times = [], []
    for s in range(0, len(queries), ANN_BATCH):
        qb = queries[s:s + ANN_BATCH]
        al = None if allow is None else [m for m in allow[s:s + ANN_BATCH]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        i, _d = idx.search_by_vector_batch(qb, ANN_K, al)
        times.append((time.perf_counter() - t1) * 1e3)
        ids.append(i)
    return np.concatenate(ids), float(np.median(times))


def phase_ann_ivf(torch, K, seed: int, X, X64, queries) -> dict:
    """11b: IVF with nlist 1,024 on the card, f32 then residual PQ."""
    from weaviate_tpu_torch.engine import ivf as ivf_mod
    from weaviate_tpu_torch.engine.ivf import IVFIndex

    t0 = time.perf_counter()
    n = len(X)
    spent = {"kmeans_fit": 0.0, "kmeans_assign": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return run

    orig = (ivf_mod.kmeans_fit, ivf_mod.kmeans_assign)
    ivf_mod.kmeans_fit = timed("kmeans_fit", orig[0])
    ivf_mod.kmeans_assign = timed("kmeans_assign", orig[1])
    K.reset_launch_counts()  # phase 11b's window starts here
    try:
        idx = IVFIndex(dim=ANN_DIM, metric="l2-squared", nlist=ANN_NLIST, device="cuda")
        t1 = time.perf_counter()
        idx.add_batch(np.arange(n), X)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
    finally:
        ivf_mod.kmeans_fit, ivf_mod.kmeans_assign = orig
    st = idx.store
    rest = build_s - spent["kmeans_fit"] - spent["kmeans_assign"]
    parts = [f"add {n} rows in {build_s:.1f} s (train {spent['kmeans_fit']:.1f} s, assign "
             f"{spent['kmeans_assign']:.1f} s, delta + lists + scatter {rest:.1f} s; nlist "
             f"{st.nlist}, list cap {st.list_cap})"]
    rng = np.random.default_rng([seed, 114])
    dead = rng.choice(n, ANN_DELETES, replace=False)
    idx.delete(*dead.tolist())
    dmask = torch.zeros(n, dtype=torch.bool, device="cuda")
    dmask[torch.from_numpy(dead).to("cuda")] = True
    dead_set = set(dead.tolist())
    allow_np = rng.random((len(queries), n)) < 0.10
    allow_t = torch.from_numpy(allow_np).to("cuda")
    truth = ann_truth(torch, X64, queries, dead=dmask)
    truth_f = ann_truth(torch, X64, queries, dead=dmask, allow=allow_t)

    def sweep(tag, truth, truth_f, nq=None):
        out = {}
        for p in ANN_NPROBES:
            st.nprobe = p
            ids, ms = _ivf_batches(torch, idx, queries)
            idsf, msf = _ivf_batches(torch, idx, queries, allow_np)
            if dead_set.intersection(ids.ravel().tolist()) or \
                    dead_set.intersection(idsf.ravel().tolist()):
                raise AssertionError(f"{tag}: a deleted id was returned")
            for r in range(len(queries)):
                live = idsf[r][idsf[r] >= 0]
                if live.size and not allow_np[r][live].all():
                    raise AssertionError(f"{tag}: a disallowed id was returned")
            out[p] = (ann_recall(ids, truth), ann_recall(idsf, truth_f))
            parts.append(f"{tag} nprobe {p}: recall@10 {out[p][0]:.4f}, {ms:.1f} ms a "
                         f"{ANN_BATCH}-query batch; 10% per-query filters {out[p][1]:.4f}, "
                         f"{msf:.1f} ms")
        st.nprobe = 0
        return out

    f32 = sweep("f32", truth, truth_f)
    # the full probe is the exact scan; 2 queries a probe chunk bound the
    # [chunk, nlist * cap, d] gather
    st.query_chunk, st.nprobe = 2, st.nlist
    ids, _ = idx.search_by_vector_batch(queries[:ANN_FULL_PROBE], ANN_K)
    st.query_chunk, st.nprobe = 16, 0
    full = ann_recall(ids, truth[:ANN_FULL_PROBE])
    if full != 1.0:
        raise AssertionError(f"IVF nprobe = nlist recall@10 {full} != 1.0")
    # async == sync, unfiltered and filtered
    st.nprobe = 32
    qb = queries[:ANN_BATCH]
    for al in (None, [m for m in allow_np[:ANN_BATCH]]):
        a = idx.search_by_vector_batch_async(qb, ANN_K, al).result()
        s = idx.search_by_vector_batch(qb, ANN_K, al)
        if not (np.array_equal(a[0], s[0]) and np.array_equal(a[1], s[1])):
            raise AssertionError("IVF async answer != sync answer")
    st.nprobe = 0
    parts.append(f"nprobe = nlist recall@10 1.0 ({ANN_FULL_PROBE} queries), async == sync "
                 "bit for bit")
    # rows that stay in the delta find themselves first before the flush
    drows = ann_rows(seed, 1 << 28, ANN_DELTA_ROWS)
    dids = np.arange(n, n + ANN_DELTA_ROWS)
    idx.add_batch(dids, drows)
    if st.delta.live_count() != ANN_DELTA_ROWS:
        raise AssertionError(f"{st.delta.live_count()} rows in the delta, not {ANN_DELTA_ROWS}")
    first, times = [], []
    for s in range(0, ANN_DELTA_ROWS, ANN_BATCH):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        i, _d = idx.search_by_vector_batch(drows[s:s + ANN_BATCH], ANN_K)
        times.append((time.perf_counter() - t1) * 1e3)
        first.append(i[:, 0])
    if not np.array_equal(np.concatenate(first), dids):
        raise AssertionError("a delta row did not find itself at rank 1")
    parts.append(f"{ANN_DELTA_ROWS} delta rows each first for itself "
                 f"({np.median(times):.1f} ms a batch with the delta leg)")
    X2 = torch.cat([X64, torch.from_numpy(drows).to("cuda").double()])
    dmask2 = torch.cat([dmask, torch.zeros(ANN_DELTA_ROWS, dtype=torch.bool, device="cuda")])
    allow_np2 = np.concatenate([allow_np, np.zeros((len(queries), ANN_DELTA_ROWS), bool)], 1)
    allow_t2 = torch.from_numpy(allow_np2).to("cuda")
    truth2 = ann_truth(torch, X2, queries, dead=dmask2)
    truth2_f = ann_truth(torch, X2, queries, dead=dmask2, allow=allow_t2)
    del X2, allow_t, allow_t2
    allow_np = allow_np2
    st.nprobe = 32
    ids, _ = _ivf_batches(torch, idx, queries)
    f32_32 = ann_recall(ids, truth2)
    st.nprobe = 0
    t1 = time.perf_counter()
    idx.compress("pq")
    torch.cuda.synchronize()
    parts.append(f"f32 with the delta leg nprobe 32 recall@10 {f32_32:.4f}; compress('pq') "
                 f"in {time.perf_counter() - t1:.1f} s ({st.pq_segments} segments, "
                 f"rescore_limit {st.rescore_limit})")
    pq = sweep("pq", truth2, truth2_f)
    if pq[32][0] < f32_32 - ANN_PQ_TOL:
        raise AssertionError(f"IVF-PQ recall@10 {pq[32][0]:.4f} at nprobe 32 more than "
                             f"{ANN_PQ_TOL} under f32 IVF's {f32_32:.4f}")
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 11b IVF ({time.perf_counter() - t0:.1f} s; {_smi_line()}): IVFIndex("
        f"nlist={ANN_NLIST}, device='cuda') {n} x {ANN_DIM} l2-squared, {ANN_DELETES} deleted, "
        f"{len(queries)} queries: " + "; ".join(parts) + f"; launches {counts}")
    for name in ANN_KERNELS["11b"]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in phase 11b")
    del f32
    return counts


def _dyn_answers(col, queries, full: bool = False):
    """``near_vector`` answers [(uuid, distance)] per query; ``full``
    probes every list of the upgraded index (the exact scan), 4 queries
    a probe chunk."""
    if not full:
        return [[(r.uuid, r.distance) for r in col.near_vector(q, k=ANN_K)] for q in queries]
    st = next(iter(col.shards.values())).vector_indexes[""].store
    keep = st.nprobe, st.query_chunk
    st.nprobe, st.query_chunk = st.nlist, 4
    try:
        return _dyn_answers(col, queries)
    finally:
        st.nprobe, st.query_chunk = keep


def phase_ann_dynamic_server(torch, K, seed: int, X, X64) -> dict:
    """11c: a dynamic collection through Database.batch_put across its
    upgrade, a restart, then a Server with a REST-created hnsw class."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.schema.config import (CollectionConfig, DataType, Property,
                                                  VectorConfig, VectorIndexConfig)
    from weaviate_tpu_torch.server import Server

    t0 = time.perf_counter()
    rows = min(DYN_ROWS, len(X))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ann_")
    parts = []
    K.reset_launch_counts()  # phase 11c's window starts here
    db = srv = None
    try:
        db = Database(tmp, device="cuda")
        col = db.create_collection(CollectionConfig(
            name="AnnDynamic", properties=[Property(name="n", data_type=DataType.INT)],
            vectors=[VectorConfig(name="", dim=ANN_DIM, index=VectorIndexConfig(
                index_type="dynamic", metric="l2-squared"))]))
        objs = lambda s, e: [{"uuid": _uuid(9100, i), "properties": {"n": i},  # noqa: E731
                              "vector": X[i]} for i in range(s, e)]
        rng = np.random.default_rng([seed, 115])
        qs = X[rng.integers(0, rows, 256)] + ANN_NOISE * rng.standard_normal(
            (256, ANN_DIM), dtype=np.float32)
        col.batch_put(objs(0, DYN_FIRST))
        dyn = next(iter(col.shards.values())).vector_indexes[""]
        got = np.asarray([[int(u[-12:]) for u, _ in a] for a in _dyn_answers(col, qs, False)])
        truth = ann_truth(torch, X64[:DYN_FIRST], qs)
        if dyn.upgraded or not np.array_equal(got, truth):
            raise AssertionError("the dynamic collection's flat answers != the exact answers")
        upgrade_s = []
        real = dyn.upgrade

        def timed_upgrade():
            t = time.perf_counter()
            real()
            upgrade_s.append(time.perf_counter() - t)

        dyn.upgrade = timed_upgrade
        t1 = time.perf_counter()
        for s in range(DYN_FIRST, rows, IMPORT_BATCH):
            col.batch_put(objs(s, min(rows, s + IMPORT_BATCH)))
        imp_s = time.perf_counter() - t1
        if not dyn.upgraded or len(upgrade_s) != 1:
            raise AssertionError("the dynamic collection did not upgrade once")
        st = dyn.store
        truth = ann_truth(torch, X64[:rows], qs)
        got = [[int(u[-12:]) for u, _ in a] for a in _dyn_answers(col, qs, False)]
        r_auto = ann_recall(np.asarray(got), truth)
        parts.append(f"flat below the threshold ({DYN_FIRST} rows) equal to the exact answers; "
                     f"batch_put of {rows - DYN_FIRST} more in {imp_s:.1f} s "
                     f"({(rows - DYN_FIRST) / imp_s:.0f} objects/s) with the upgrade to IVF at "
                     f"{dyn.threshold} rows in {upgrade_s[0]:.2f} s; recall@10 {r_auto:.4f} at "
                     f"the automatic nprobe ({st._effective_nprobe()} of {st.nlist} lists)")
        t1 = time.perf_counter()
        next(iter(col.shards.values())).epoch_maintenance()
        m_s = time.perf_counter() - t1
        before = _dyn_answers(col, qs[:64], True)
        r_m = ann_recall(np.asarray([[int(u[-12:]) for u, _ in a] for a in
                                     _dyn_answers(col, qs, False)]), truth)
        db.close()
        t1 = time.perf_counter()
        db = Database(tmp, device="cuda")
        reopen_s = time.perf_counter() - t1
        col = db.get_collection("AnnDynamic")
        dyn2 = next(iter(col.shards.values())).vector_indexes[""]
        after = _dyn_answers(col, qs[:64], True)
        if not dyn2.upgraded or len(dyn2) != rows:
            raise AssertionError("the reopened dynamic collection is in another regime")
        diff = 0.0
        for a, b in zip(before, after):
            if [u for u, _ in a] != [u for u, _ in b]:
                raise AssertionError("the reopened dynamic collection answers other ids")
            diff = max(diff, max(abs(x - y) / max(abs(x), 1e-30)
                                 for (_, x), (_, y) in zip(a, b)))
        if diff > 1e-6:
            raise AssertionError(f"reopened distances moved by {diff:.3g} (relative)")
        parts.append(f"maintain() tick in {m_s:.1f} s (retrain {st.retrain_count}), recall@10 "
                     f"{r_m:.4f}; close + reopen in {reopen_s:.1f} s (replays {rows} rows, "
                     f"nlist {dyn2.store.nlist}): full-probe answers identical ids, distances "
                     f"within {diff:.2g} relative")
        db.close()
        db = None
        # a Server with the reference's hnsw class JSON
        cfg = ServerConfig(data_path=os.path.join(tmp, "server"), host="127.0.0.1",
                           rest_port=0, grpc_port=0, disable_telemetry=True)
        srv = Server(cfg, device="cuda")
        if _grpc_present():
            srv.start()
        else:
            srv.assemble()
        client = Client(srv.rest.address, timeout=300.0)
        client.create_class({"class": "SiftHnsw", "vectorizer": "none",
                             "vectorIndexType": "hnsw",
                             "vectorIndexConfig": {"distance": "l2-squared",
                                                   "maxConnections": ANN_M,
                                                   "efConstruction": ANN_EFC},
                             "properties": [{"name": "n", "dataType": ["int"]}]})
        m = min(ANN_SERVER_ROWS, len(X))
        body = json.dumps({"objects": [
            {"class": "SiftHnsw", "id": _uuid(9200, i), "properties": {"n": i},
             "vector": X[i].tolist()} for i in range(m)]}).encode()
        host, port = client.addr.rsplit(":", 1)
        t1 = time.perf_counter()
        conn = http.client.HTTPConnection(host, int(port), timeout=600)
        try:
            conn.request("POST", "/v1/batch/objects", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            res = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200 or any(r["result"].get("status") != "SUCCESS" for r in res):
            raise AssertionError(f"REST import failed: {resp.status}")
        rest_s = time.perf_counter() - t1
        scol = srv.db.get_collection("SiftHnsw")
        sidx = next(iter(scol.shards.values())).vector_indexes[""]
        if sidx.index_type != "hnsw" or sidx.m != ANN_M or sidx.ef_construction != ANN_EFC:
            raise AssertionError("the REST class did not build an HNSW index with its config")
        sq = qs[:ANN_SERVER_QUERIES]
        sp, runs, _ref = _socket_vs_inproc(
            scol, client, sq, ANN_K, None, f"{ANN_SERVER_QUERIES} nearVector(limit {ANN_K})",
            srv.grpc.port if srv.grpc is not None else None, every=1 << 30)
        sp += [fn() for fn in runs.values()]
        parts.append(f"server: class created over REST with vectorIndexType hnsw "
                     f"(maxConnections {ANN_M}, efConstruction {ANN_EFC}), {m} objects over "
                     f"REST in {rest_s:.1f} s ({m / rest_s:.0f} objects/s, bulk build "
                     f"included); " + "; ".join(sp))
    finally:
        if srv is not None:
            srv.stop()
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    counts = dict(K.launch_counts)  # ... and ends here
    log(f"phase 11c dynamic + server ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
        + "; ".join(parts) + f"; launches {counts}")
    return counts


def phase_ann(torch, K, seed: int, rows: int) -> dict:
    """Phase 11: the ANN indexes on the card (11a HNSW, 11b IVF, 11c the
    dynamic collection and the server). Returns its launches, summed over
    its three windows."""
    t0 = time.perf_counter()
    X = ann_corpus(seed, rows)
    X64 = torch.from_numpy(X).to("cuda").double()
    queries = ann_queries(seed, X)
    truth = ann_truth(torch, X64, queries)
    timer = Timer(torch)
    # each part runs even when an earlier one failed its limits, so one
    # run reads them all; any failure fails the phase at its end
    counts, fails = dict.fromkeys(K.launch_counts, 0), []
    for part, run in (("11a", lambda: phase_ann_hnsw(torch, K, seed, X, X64, queries,
                                                      truth, timer)),
                      ("11b", lambda: phase_ann_ivf(torch, K, seed, X, X64, queries)),
                      ("11c", lambda: phase_ann_dynamic_server(torch, K, seed, X, X64))):
        try:
            for name, c in run().items():
                counts[name] += c
        except Exception as e:  # noqa: BLE001 — re-raised below
            traceback.print_exc()
            fails.append(f"{part}: {e}")
        gc.collect()
        torch.cuda.empty_cache()
    del X64
    log(f"phase 11 ANN indexes: {time.perf_counter() - t0:.1f} s, launches {counts}")
    if fails:
        raise AssertionError("phase 11 failed: " + " | ".join(fails))
    return counts


# -- phase 12: row-sharded serving over a mesh ---------------------------------

MESH_SHARDS = 8            # row shards of 12a / 12b, every one on the card
MESH_HOSTS = 2             # the 2 x 4 hierarchical mesh
MESH_TIMED = 4             # unfiltered 256-query batches checked per selection
MESH_REPS = 20             # batches timed per index and selection (12a; 12b half)
MESH_FILTER = 0.10         # per-query filters' selectivity
# the shared filter's: above capacity / 8, so the one buffer takes its
# masked scan (a mesh has no gathered cutover) and the two run one path
MESH_SHARED = 0.5
MESH_QUANT_K = 10
MESH_RTOL = 1e-6           # distances, if a launch's row count moved a sum
MESH_DB_ROWS = 200_000     # 12c: imported under MESH_DB_BUDGET_S
MESH_DB_BUDGET_S = 15.0
MESH_DB_QUERIES = 128      # 12c: GraphQL (and gRPC) nearVector, half filtered
MESH_KERNELS = {"12a": ("distance_block", "fused_topk_scan", "fused_topk_pairs"),
                "12b": ("bq_scan_reduce", "pq4_scan_reduce"),
                "12c": ("distance_block", "fused_topk_pairs")}


def _require_mesh_launches(counts: dict, part: str) -> None:
    for name in MESH_KERNELS[part]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched on the mesh in phase {part}")


def _meshes(devices) -> dict:
    from weaviate_tpu_torch.parallel.mesh import make_hierarchical_mesh, make_mesh

    return {"1-D": make_mesh(devices=devices),
            "2x4": make_hierarchical_mesh(n_hosts=MESH_HOSTS, devices=devices)}


def _answer(torch, idx, qb, k: int, allow=None, timed: list | None = None):
    """(ids, distances) of one batch through the async entry point, the
    host-clock milliseconds appended to ``timed``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids, d = idx.search_by_vector_batch_async(qb, k, allow).result()
    if timed is not None:
        timed.append((time.perf_counter() - t) * 1e3)
    return np.asarray(ids), np.asarray(d, dtype=np.float32)


def _equal_answers(got, want, what: str) -> bool:
    """Ids equal; True when the distances are equal bit for bit too, else
    they must agree within MESH_RTOL (and False is returned)."""
    (gi, gd), (wi, wd) = got, want
    if not np.array_equal(gi, wi):
        raise AssertionError(f"{what}: ids differ at {int((gi != wi).sum())} positions")
    if np.array_equal(gd.view(np.int32), wd.view(np.int32)):
        return True
    if not np.allclose(gd, wd, rtol=MESH_RTOL, atol=0.0):
        raise AssertionError(f"{what}: distances differ past rtol {MESH_RTOL}")
    return False


def _spread(ms: list) -> str:
    p10, p50, p90 = np.percentile(ms, [10, 50, 90])
    return f"{p50:.2f} ms (p10-p90 {p10:.2f}-{p90:.2f})"


def _timed_turns(torch, indexes: dict, batches: list, k: int, reps: int) -> dict:
    """Host-clock ms of ``reps`` batches through each index, after one
    warm-up batch each; the indexes take turns batch by batch, so a drift
    of the card's or the host's speed falls on all of them alike."""
    for idx in indexes.values():
        _answer(torch, idx, batches[0], k)
    lat = {name: [] for name in indexes}
    for r in range(reps):
        for name, idx in indexes.items():
            _answer(torch, idx, batches[r % len(batches)], k, None, lat[name])
    return lat


def _bit_equal(a, b, what: str) -> None:
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1].view(np.int32),
                                                          b[1].view(np.int32))):
        raise AssertionError(f"{what}: the 1-D and two-level answers differ")


def _mesh_build(torch, seed: int, rows: int, meshes: dict):
    """Phase 3's corpus (1M x 768 cosine, clustered, unit rows on the card
    for the exact checks) added to a one-buffer FlatIndex, a FlatIndex on
    each mesh, and on each mesh a BQ index (bf16 rows on the card, each
    shard rescoring its own candidates) and a 4-bit PQ index (one codebook,
    fitted on the first 131,072 rows; host rescore)."""
    from weaviate_tpu_torch.engine.flat import FlatIndex
    from weaviate_tpu_torch.ops import pq as pq_ops
    from weaviate_tpu_torch.ops.distances import normalize_np

    common = dict(dim=DIM, metric=METRIC, chunk_size=CHUNK, capacity=rows)
    flat = {"one buffer": FlatIndex(device="cuda", **common)}
    flat.update({name: FlatIndex(mesh=m, **common) for name, m in meshes.items()})
    t0 = time.perf_counter()
    train = normalize_np(np.concatenate([corpus_batch(seed, s, ADD_BATCH)
                                         for s in (0, ADD_BATCH)]))
    cb = pq_ops.pq_fit(train, m=pq_ops.default_pq_segments(DIM, 16), k=16,
                       device="cuda")
    train_s = time.perf_counter() - t0
    quant = {}
    for name, m in meshes.items():
        quant[("bq", name)] = FlatIndex(mesh=m, quantization="bq", rescore="device", **common)
        quant[("pq4", name)] = FlatIndex(mesh=m, quantization="pq", pq_centroids=16,
                                         codebook=cb, **common)
    ref = torch.empty((rows, DIM), dtype=torch.float32, device="cuda")
    spent = dict.fromkeys(list(flat) + [f"{q} {n}" for q, n in quant], 0.0)
    t0 = time.perf_counter()
    for s in range(0, rows, ADD_BATCH):
        v = corpus_batch(seed, s, min(ADD_BATCH, rows - s))
        ids = np.arange(s, s + len(v))
        for name, idx in list(flat.items()) + [(f"{q} {n}", i) for (q, n), i in quant.items()]:
            t1 = time.perf_counter()
            idx.add_batch(ids, v)
            spent[name] += time.perf_counter() - t1
        ref[s:s + len(v)] = torch.nn.functional.normalize(torch.from_numpy(v).to("cuda"), dim=1)
    for idx in list(flat.values()) + list(quant.values()):
        if hasattr(idx.store, "flush_staged"):
            idx.store.flush_staged()
    torch.cuda.synchronize()
    text = (f"{rows} rows added to 7 indexes in {time.perf_counter() - t0:.1f} s ("
            + ", ".join(f"{n} {s:.1f}" for n, s in spent.items())
            + f" s), PQ4 codebook fitted in {train_s:.1f} s")
    return flat, quant, ref, text


def _merge_times(torch, store, mesh, q, timer) -> str:
    """The per-shard scans and the merge of one 256-query batch, each on
    CUDA events, outside the launch window."""
    from weaviate_tpu_torch.parallel import sharded_search as tss

    cs = min(store.chunk_size, store.capacity // store.n_shards)

    def cands():
        return tss.sharded_candidates(q, store.vectors, store.valid, store.sq_norms,
                                      k=TOP_K, chunk_size=cs, metric="cosine", mesh=mesh,
                                      use_pallas=True, selection=store.selection)

    parts = cands()
    scan_ms = timer(cands, reps=3, warmup=1)
    merge_ms = timer(lambda: tss.merge_candidates(parts, mesh, TOP_K), reps=50)
    return f"shard scans {scan_ms:.3f} ms, merge {merge_ms:.4f} ms"


def phase_mesh(torch, K, seed: int, rows: int) -> dict:
    """Phase 12: the port's row-sharded serving on the card (module
    docstring). Returns the launches of its three windows."""
    from weaviate_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch)
    devices = [torch.device("cuda", 0)] * MESH_SHARDS
    meshes = _meshes(devices)
    flat, quant, ref, build_text = _mesh_build(torch, seed, rows, meshes)
    rng = np.random.default_rng([seed, 12])
    deleted = rng.choice(rows, 10_000, replace=False)
    for idx in list(flat.values()) + list(quant.values()):
        idx.delete(*deleted.tolist())
    live = torch.ones(rows, dtype=torch.bool, device="cuda")
    live[torch.from_numpy(deleted).to("cuda")] = False
    log(f"phase 12 mesh build: {build_text}; 10000 deleted from each; "
        f"{len(meshes)} meshes of {MESH_SHARDS} row shards on {devices[0]} "
        f"({', '.join(str(m.shape) for m in meshes.values())}); card memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")

    # 12a: the flat path, the one buffer's answers first (the reference)
    queries = near_queries(seed + 12, rng.integers(0, rows, MESH_TIMED * BATCH),
                           lambda r: ref[torch.from_numpy(r).to("cuda")].cpu().numpy())
    masks = [m for m in rng.random((BATCH, rows)) < MESH_FILTER]
    shared = np.sort(rng.choice(rows, int(rows * MESH_SHARED), replace=False))
    cases = [(f"unfiltered batch {b}", queries[b * BATCH:(b + 1) * BATCH], None)
             for b in range(MESH_TIMED)]
    cases += [(f"shared {MESH_SHARED:.0%} filter", queries[:BATCH], shared),
              (f"per-query {MESH_FILTER:.0%} filters", queries[:BATCH], masks)]
    answers = {}
    for name in ["one buffer"] + list(meshes):
        if name == list(meshes)[0]:
            K.reset_launch_counts()  # phase 12a's window: the mesh runs only
        for sel in ("approx", "fused"):
            flat[name].store.selection = sel
            for what, qb, allow in cases:
                answers[(name, sel, what)] = _answer(torch, flat[name], qb, TOP_K, allow)
    counts_a = dict(K.launch_counts)
    bit = {}
    for (name, sel, what), got in answers.items():
        if name == "one buffer":
            continue
        bit.setdefault(name, []).append(
            _equal_answers(got, answers[("one buffer", sel, what)], f"12a {name} {sel} {what}"))
        if name == "2x4":
            _bit_equal(answers[("1-D", sel, what)], got, f"12a {sel} {what}")
    qn = torch.nn.functional.normalize(torch.from_numpy(queries[:BATCH]).to("cuda"), dim=1)
    d_full = _exact_distances(torch, qn, ref, live[None, :])
    _check_against_exact(torch, d_full, answers[("1-D", "approx", "unfiltered batch 0")][0],
                         TOP_K, "12a 1-D mesh recall@100")
    del d_full
    times = {}
    batches = [queries[b * BATCH:(b + 1) * BATCH] for b in range(MESH_TIMED)]
    for sel in ("approx", "fused"):
        for idx in flat.values():
            idx.store.selection = sel
        for name, ms in _timed_turns(torch, flat, batches, TOP_K, MESH_REPS).items():
            times[(name, sel)] = ms
    parts = []
    for name in meshes:
        st = flat[name].store
        merge = []
        for sel in ("approx", "fused"):
            st.selection = sel
            merge.append(f"{sel} " + _merge_times(
                torch, st, meshes[name], torch.from_numpy(queries[:BATCH]).to("cuda"), timer))
        parts.append(
            f"{name}: batch p50 approx {_spread(times[(name, 'approx')])}, fused "
            f"{_spread(times[(name, 'fused')])}; " + "; ".join(merge))
    equal_bits = all(all(v) for v in bit.values())
    log(f"phase 12a mesh flat ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
        f"{rows} x {DIM} {METRIC}, {BATCH}-query batches at k {TOP_K}, selections approx and "
        f"fused, unfiltered / shared {MESH_SHARED:.0%} / per-query {MESH_FILTER:.0%}: ids equal "
        "to the one buffer's, distances "
        + ("equal bit for bit" if equal_bits else
           f"within rtol {MESH_RTOL} (not bit for bit: {sum(not x for v in bit.values() for x in v)} "
           "batches)")
        + "; 1-D and two-level equal bit for bit; the 1-D mesh's recall@100 against the "
        f"exact recomputation 1.0; batch times on the host clock, {MESH_REPS} batches "
        "each after a warm-up, the indexes taking turns: one buffer batch p50 approx "
        f"{_spread(times[('one buffer', 'approx')])}, fused "
        f"{_spread(times[('one buffer', 'fused')])} | " + " | ".join(parts)
        + f" (CUDA events); launches {counts_a}")
    _require_mesh_launches(counts_a, "12a")

    # 12d: one shard per card, where the machine has several
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        t1 = time.perf_counter()
        from weaviate_tpu_torch.engine.flat import FlatIndex

        cards = make_mesh()
        multi = FlatIndex.restore(flat["one buffer"].snapshot(), mesh=cards)
        for sel in ("approx", "fused"):
            multi.store.selection = sel
            for what, qb, allow in cases:
                _equal_answers(_answer(torch, multi, qb, TOP_K, allow),
                               answers[("one buffer", sel, what)], f"12d {sel} {what}")
        log(f"phase 12d cards ({time.perf_counter() - t1:.1f} s): one shard on each of "
            f"{n_cards} cards, every 12a batch's ids equal to the one buffer's")
        del multi
    else:
        log("phase 12d cards: did not run: torch.cuda.device_count() is 1 (this machine "
            "has one card); the mesh of 12a-12c repeats that card")
    for name in list(flat):
        del flat[name]
    gc.collect()
    torch.cuda.empty_cache()

    # 12b: BQ and PQ4 on both meshes, held to the exact recomputation
    t1 = time.perf_counter()
    qq = near_queries(seed + 121, rng.integers(0, rows, BATCH),
                      lambda r: ref[torch.from_numpy(r).to("cuda")].cpu().numpy(),
                      noise=NEAR_NOISE)
    qn = torch.nn.functional.normalize(torch.from_numpy(qq).to("cuda"), dim=1)
    d_full = _exact_distances(torch, qn, ref, live[None, :])
    K.reset_launch_counts()  # phase 12b's window
    got_q = {key: _answer(torch, idx, qq, MESH_QUANT_K) for key, idx in quant.items()}
    counts_b = dict(K.launch_counts)
    lat_q = _timed_turns(torch, quant, [qq], MESH_QUANT_K, MESH_REPS // 2)
    qparts = []
    for kind in ("bq", "pq4"):
        _bit_equal(got_q[(kind, "1-D")], got_q[(kind, "2x4")], f"12b {kind}")
        ids, dists = got_q[(kind, "1-D")]
        r = _check_quantized(torch, d_full, ids, dists, MESH_QUANT_K, f"12b {kind}")
        mode = quant[(kind, "1-D")].store.rescore_mode()
        qparts.append(f"{kind} (rescore {mode}): recall@{MESH_QUANT_K} {r:.4f}, batch p50 "
                      f"{_spread(lat_q[(kind, '1-D')])} (1-D) / "
                      f"{_spread(lat_q[(kind, '2x4')])} (2x4)")
        if r < RECALL_FLOOR[kind]:
            raise AssertionError(f"12b {kind}: recall@{MESH_QUANT_K} {r} under "
                                 f"{RECALL_FLOOR[kind]}")
    del d_full
    log(f"phase 12b mesh quantized ({time.perf_counter() - t1:.1f} s): {BATCH} queries near "
        f"rows (cosine ~0.96), 1-D and two-level equal bit for bit, every distance the exact "
        f"one; batch times on the host clock, {MESH_REPS // 2} batches each after a warm-up, "
        "the indexes taking turns: " + "; ".join(qparts) + f"; launches {counts_b}")
    _require_mesh_launches(counts_b, "12b")
    quant.clear()
    del ref, live
    gc.collect()
    torch.cuda.empty_cache()

    counts_c = phase_mesh_db(torch, K, seed)
    log(f"phase 12 mesh total {time.perf_counter() - t0:.1f} s")
    return {name: counts_a[name] + counts_b[name] + counts_c[name] for name in counts_a}


def phase_mesh_db(torch, K, seed: int) -> dict:
    """12c: a collection on the 2 x 4 mesh in a Database, imported under a
    time budget, served over a socket by the Server, every answer equal to
    an in-process one-buffer collection's on the same objects."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.server import Server

    t0 = time.perf_counter()
    mesh = _meshes([torch.device("cuda", 0)] * MESH_SHARDS)["2x4"]
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_mesh_") for _ in range(2)]
    plain = meshed = srv = None
    try:
        plain = Database(dirs[0], device="cuda")
        meshed = Database(dirs[1], mesh=mesh)
        mcol = _collection(meshed, "MeshWiki")
        pcol = _collection(plain, "MeshWiki")
        ref, _views, n, m_s = _import(torch, mcol, seed + 12, MESH_DB_ROWS, 12,
                                      np.random.default_rng([seed, 120]), MESH_DB_BUDGET_S)
        _r, _v, n2, p_s = _import(torch, pcol, seed + 12, n, 12,
                                  np.random.default_rng([seed, 120]), 1e9)
        if n2 != n:
            raise AssertionError(f"12c: the one-buffer import took {n2} of {n} rows")
        cfg = ServerConfig(data_path=meshed.data_dir, host="127.0.0.1", rest_port=0,
                           grpc_port=0, disable_telemetry=True)
        srv = Server(cfg, device="cuda", db=meshed)
        if _grpc_present():
            srv.start()
        else:
            srv.assemble()
        client = Client(srv.rest.address, timeout=120.0)
        rng = np.random.default_rng([seed, 122])
        queries = near_queries(seed + 122, rng.integers(0, n, MESH_DB_QUERIES),
                               lambda r: ref[torch.from_numpy(r).to("cuda")].cpu().numpy())
        where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
        parts, runs, inproc = _socket_vs_inproc(
            mcol, client, queries, SERVER_K, where,
            f"{MESH_DB_QUERIES} nearVector(limit {SERVER_K}), half under where(views >= "
            f"{VIEWS_CUT})", srv.grpc.port if srv.grpc is not None else None)
        K.reset_launch_counts()  # phase 12c's window: the socket runs on the mesh
        parts += [fn() for fn in runs.values()]
        counts = dict(K.launch_counts)
        # the mesh's answers (equal over the socket and in process, above)
        # against the one-buffer collection's on the same objects. A
        # filtered query served alone takes the one buffer's gathered
        # cutover, which a mesh has not: its distances may move in the
        # last bits there, its ids may not
        bits = []
        for i, q in enumerate(queries):
            want = [(r.uuid, r.distance) for r in pcol.near_vector(
                q, k=SERVER_K, where=where if i % 2 else None)]
            bits.append(_equal_answers(
                (np.array([u for u, _ in inproc[i]]), np.float32([d for _, d in inproc[i]])),
                (np.array([u for u, _ in want]), np.float32([d for _, d in want])),
                f"12c query {i} against the one-buffer collection"))
        parts.append(f"ids equal to the one-buffer collection's, distances bit for bit in "
                     f"{sum(bits)} of {len(bits)} (the rest within rtol {MESH_RTOL})")
        mem = client.request("GET", "/v1/debug/memory")["ledger"]
        hosts = mem["hbmHostBytes"]
        if sorted(hosts) != ["host-0", "host-1"] or sum(hosts.values()) != mem["totalBytes"]:
            raise AssertionError(f"12c: per-host rollup {hosts} does not sum to "
                                 f"{mem['totalBytes']}")
        log(f"phase 12c mesh database ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
            f"Database(mesh=2x4 on cuda:0) collection of {n} objects (batch_put {n / m_s:.0f} "
            f"objects/s on the mesh, {n / p_s:.0f} objects/s one buffer), Server over a socket"
            f"{'' if srv.grpc is not None else ' (REST only: grpc absent)'}: "
            + "; ".join(parts) + f"; /v1/debug/memory per-host bytes {hosts} sum to the "
            f"ledger's {mem['totalBytes']}; launches through the socket {counts}")
        _require_mesh_launches(counts, "12c")
        return counts
    finally:
        if srv is not None:
            srv.stop()
        for db in (meshed, plain):
            if db is not None:
                db.close()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


# -- phase 13: multi-tenancy and the device-time plane --------------------------

TENANTS = 200              # 13a's HOT tenants in the default run
TENANTS_ONLY = 1000        # --tenants-only's (about 25 GB of stores)
TENANT_ROWS = 1000         # rows a tenant
TENANT_IMPORTERS = 4       # threads importing tenants side by side
TENANT_PARITY = 4          # tenants held to one-tenant collections
TENANT_PARITY_Q = 16       # queries a parity tenant, each with and without the filter
TENANT_K = 10
TENANT_QUERIED = 50        # 13b's traffic goes to the first TENANT_QUERIED tenants
TENANT_TRAFFIC_S = 2.0     # 13b's served traffic before the capture (it runs on through it)
PROFILE_MS = 500
TENANT_KERNELS = ("distance_block", "fused_topk_scan", "fused_topk_pairs")
PROFILE_TOP = ("distance_block", "fused_topk_scan", "merge_epoch_topk")


def _tenant_name(t: int) -> str:
    return f"tenant-{t:04d}"


def _tenant_objects(seed: int, t: int, rows: int, cent: np.ndarray):
    """Tenant ``t``'s objects: rows of the clustered corpus from row
    t * rows, views for the 10% filter. Returns (objects, unit rows)."""
    v = clustered(seed + 13, t * rows, rows, cent)
    views = np.random.default_rng([seed, 13, t]).integers(0, 100, rows)
    objs = [{"uuid": _uuid(13, t * rows + i),
             "properties": {"category": f"cat{i % 100}", "views": int(views[i])},
             "vector": v[i]} for i in range(rows)]
    return objs, v / np.linalg.norm(v, axis=1, keepdims=True)


def _selection(col, shard_name: str, selection: str | None = None) -> str:
    """Set (or read) the selection of one shard's flat store."""
    store = col.shards[shard_name].vector_indexes[""].store
    if selection is not None:
        store.selection = selection
    return store.selection


def _tenant_answers(col, tenant, queries, where) -> list:
    out = []
    for q in queries:
        for w in (None, where):
            res = col.near_vector(q, k=TENANT_K, tenant=tenant, where=w,
                                  include_objects=False)
            out.append(([r.uuid for r in res], np.float32([r.distance for r in res])))
    return out


def _same_answers(got: list, want: list, what: str) -> None:
    for i, ((gi, gd), (wi, wd)) in enumerate(zip(got, want)):
        if gi != wi or not np.array_equal(gd, wd):
            raise AssertionError(f"13a: {what}: answer {i} differs ({gi[:3]} vs {wi[:3]})")


def _offload_round_trip(torch, db, col, ledger, tenant: str, status: str,
                        queries, where, want) -> str:
    """Take ``tenant`` to ``status`` and back to HOT: the ledger and
    torch.cuda.memory_allocated drop by the tenant's footprint meanwhile
    (no gc pass), a query to it is refused, and the answers after equal
    the ones before bit for bit."""
    sel = _selection(col, tenant)
    torch.cuda.synchronize()
    gc.collect()
    tb = ledger.shard_bytes("Tenants", tenant)
    a0, l0 = torch.cuda.memory_allocated(), ledger.total_bytes()
    t1 = time.perf_counter()
    db.update_tenant_status("Tenants", [{"name": tenant, "activityStatus": status}])
    t_off = time.perf_counter() - t1
    a_drop, l_drop = a0 - torch.cuda.memory_allocated(), l0 - ledger.total_bytes()
    if tb <= 0 or l_drop != tb or a_drop < tb:
        raise AssertionError(f"13a: {status} {tenant}: ledger dropped {l_drop}, "
                             f"memory_allocated {a_drop}, footprint {tb}")
    try:
        col.near_vector(queries[0], k=TENANT_K, tenant=tenant)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"13a: a query to a {status} tenant was served")
    t1 = time.perf_counter()
    db.update_tenant_status("Tenants", [{"name": tenant, "activityStatus": "HOT"}])
    t_on = time.perf_counter() - t1
    _selection(col, tenant, sel)
    if ledger.shard_bytes("Tenants", tenant) != tb:
        raise AssertionError(f"13a: {tenant} back HOT holds "
                             f"{ledger.shard_bytes('Tenants', tenant)} bytes, not {tb}")
    _same_answers(_tenant_answers(col, tenant, queries, where), want,
                  f"{tenant} after HOT -> {status} -> HOT")
    return (f"HOT -> {status} {t_off * 1e3:.0f} ms -> HOT {t_on * 1e3:.0f} ms, ledger and "
            f"memory_allocated down {l_drop} / {a_drop} bytes meanwhile, a query refused "
            f"({refused.split(';')[0]}), answers bit for bit")


def _raise_fd_limit(need: int) -> str:
    """Each tenant shard holds ~10 open files (its LSM buckets): raise
    this process's soft limit toward its hard limit."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        new = need if hard == resource.RLIM_INFINITY else min(hard, need)
        resource.setrlimit(resource.RLIMIT_NOFILE, (new, hard))
        soft = new
    if soft < need:
        raise AssertionError(f"13a: {need} open files needed, the hard limit is {hard}")
    return f"open-file limit {soft} (hard {hard})"


def _compile_cache_second_load():
    """Start a second process that loads every kernel library from the
    build directory phase 1 filled; ``.communicate()`` on the returned
    process gives its compile_cache_events (hits, no miss) as JSON."""
    code = ("import json\n"
            "from weaviate_tpu_torch.ops import _build\n"
            "from weaviate_tpu_torch.runtime import compile_cache, metrics\n"
            "compile_cache.ensure_compile_cache()\n"
            "_build.build_all()\n"
            "ev = metrics.compile_cache_events\n"
            "print(json.dumps({k: ev.labels(k).value for k in ('hit', 'miss')}))\n")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _served_traffic(client, names, seed: int, stop):
    """CLIENTS threads of GraphQL tenant nearVector until ``stop`` is set.
    Returns (the threads, (start, latency ms) per query, errors)."""
    lat, errors = [], []
    q = ("query Q($v: [Float]) { Get { Tenants(tenant: \"%s\", limit: "
         f"{TENANT_K}, nearVector: {{vector: $v}}) {{ _additional {{ id distance }} }} }} }}")

    def run(c):
        rng = np.random.default_rng([seed, 131, c])
        try:
            while not stop.is_set():
                t = names[int(rng.integers(0, len(names)))]
                v = rng.standard_normal(DIM).astype(np.float32)
                t2 = time.perf_counter()
                hits = _gql(client, q % t, {"v": v.tolist()})
                lat.append((t2, (time.perf_counter() - t2) * 1e3))
                if len(hits) != TENANT_K:
                    raise AssertionError(f"13b: {len(hits)} hits from {t}")
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(CLIENTS)]
    for t in threads:
        t.start()
    return threads, lat, errors


def profiler_warm_up():
    """The first torch.profiler capture in a process pays kineto's and
    CUPTI's start-up (seconds): one 1 ms capture on a thread of its own,
    started beside phase 1's nvcc build, takes it, so that 13b's capture
    window runs over the served traffic. Returns (thread, result dict:
    "s", or "error" to re-raise)."""
    from weaviate_tpu_torch.runtime import kernelscope

    kernelscope.configure(device="cuda")
    warm = {}

    def run():
        t = time.perf_counter()
        try:
            kernelscope._torch_capture(1)
        except Exception as e:  # noqa: BLE001 — re-raised in 13b
            warm["error"] = e
        warm["s"] = time.perf_counter() - t

    thread = threading.Thread(target=run, name="profiler-warm-up")
    thread.start()
    return thread, warm


def phase_tenants(torch, K, seed: int, n_tenants: int, rows: int = TENANT_ROWS,
                  warm_up=None) -> dict:
    """Phase 13: 13a multi-tenancy on one node, 13b the device-time plane
    on the same server. ``warm_up``: ``profiler_warm_up()``'s result
    (None: started here). Returns 13b's launches (the served
    traffic's)."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.config import ServerConfig
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.modules.backup_backends import FilesystemBackend
    from weaviate_tpu_torch.runtime import driftwatch, kernelscope, tailboard
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger
    from weaviate_tpu_torch.schema.config import (CollectionConfig, MultiTenancyConfig,
                                                  Property, VectorConfig, VectorIndexConfig)
    from weaviate_tpu_torch.server import Server

    t0 = time.perf_counter()
    fds = _raise_fd_limit(12 * (n_tenants + TENANT_PARITY) + 1024)
    warmer, warm = profiler_warm_up() if warm_up is None else warm_up
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tenants_")
    db = srv = second = None
    try:
        db = Database(os.path.join(tmp, "data"), device="cuda")
        backend = FilesystemBackend()
        backend.init({"path": os.path.join(tmp, "offload")})
        db.set_offload_backend(backend)
        col = db.create_collection(CollectionConfig(
            name="Tenants",
            properties=[Property(name="category", data_type="text"),
                        Property(name="views", data_type="int")],
            vectors=[VectorConfig(index=VectorIndexConfig(index_type="flat", metric=METRIC))],
            multi_tenancy=MultiTenancyConfig(enabled=True)))
        names = [_tenant_name(t) for t in range(n_tenants)]
        torch.cuda.synchronize()
        alloc0, led0 = torch.cuda.memory_allocated(), ledger.total_bytes()
        t1 = time.perf_counter()
        db.add_tenants("Tenants", names)
        t_add = time.perf_counter() - t1
        cent = centers(seed)

        def imp(t):
            objs, _ = _tenant_objects(seed, t, rows, cent)
            res = col.batch_put(objs, tenant=names[t])
            if any(r["status"] != "SUCCESS" for r in res):
                raise AssertionError(f"13a: batch_put into {names[t]} failed: {res[0]}")

        t1 = time.perf_counter()
        with ThreadPoolExecutor(TENANT_IMPORTERS) as ex:
            list(ex.map(imp, range(n_tenants)))
        t_imp = time.perf_counter() - t1
        for t in range(1, n_tenants, 2):  # odd tenants scan with fused_topk_scan
            _selection(col, names[t], "fused")
        torch.cuda.synchronize()
        per_tenant = ledger.shard_bytes("Tenants", names[0])
        if any(ledger.shard_bytes("Tenants", n) != per_tenant for n in names):
            raise AssertionError("13a: tenants of equal rows hold unequal ledger bytes")
        alloc_per = (torch.cuda.memory_allocated() - alloc0) / n_tenants
        led_per = (ledger.total_bytes() - led0) / n_tenants
        total_mem = torch.cuda.get_device_properties(0).total_memory
        fit = int(total_mem // per_tenant)
        parts = [f"{n_tenants} HOT tenants x {rows} rows: add_tenants {t_add:.1f} s, import "
                 f"{n_tenants * rows / t_imp:.0f} rows/s ({TENANT_IMPORTERS} threads); "
                 f"{per_tenant} ledger bytes a tenant ({led_per:.0f} in the ledger's total, "
                 f"{alloc_per:.0f} of memory_allocated a tenant), so {fit} HOT tenants fill "
                 f"the card's {total_mem} bytes; {fds}"]

        # tenant-scoped answers against one-tenant collections
        where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
        picks = sorted({0, n_tenants // 3, (2 * n_tenants) // 3, n_tenants - 1})[:TENANT_PARITY]
        want = {}
        for j, t in enumerate(picks):
            objs, unit = _tenant_objects(seed, t, rows, cent)
            solo = _collection(db, f"Solo{j}")
            solo.batch_put(objs)
            (sname,) = solo.shards
            _selection(solo, sname, _selection(col, names[t]))
            rng = np.random.default_rng([seed, 130, t])
            qs = near_queries(seed + 130 + t, rng.integers(0, rows, TENANT_PARITY_Q),
                              lambda r: unit[r])
            got = _tenant_answers(col, names[t], qs, where)
            ref = []
            for q in qs:
                for w in (None, where):
                    res = solo.near_vector(q, k=TENANT_K, where=w, include_objects=False)
                    ref.append(([r.uuid for r in res], np.float32([r.distance for r in res])))
            _same_answers(got, ref, f"{names[t]} against its one-tenant collection")
            if any(not t * rows <= int(u[-12:]) < (t + 1) * rows for ids, _ in got for u in ids):
                raise AssertionError(f"13a: {names[t]} answered another tenant's row")
            want[t] = (qs, got)
        parts.append(f"{len(picks)} tenants ({', '.join(names[t] for t in picks)}; selections "
                     f"{[_selection(col, names[t]) for t in picks]}) x {TENANT_PARITY_Q} "
                     f"queries with and without where(views >= {VIEWS_CUT}): ids and distances "
                     "bit for bit equal to one-tenant collections of the same rows")
        t_cold, t_frozen = picks[0], picks[1]
        parts.append(f"{names[t_cold]}: " + _offload_round_trip(
            torch, db, col, ledger, names[t_cold], "COLD", want[t_cold][0], where,
            want[t_cold][1]))
        parts.append(f"{names[t_frozen]}: " + _offload_round_trip(
            torch, db, col, ledger, names[t_frozen], "FROZEN", want[t_frozen][0], where,
            want[t_frozen][1]) + " (filesystem offload backend)")
        log(f"phase 13a tenants ({time.perf_counter() - t0:.1f} s; {_smi_line()}): "
            + "; ".join(parts))

        # 13b: the device-time plane on a server over the same database;
        # the second process loading the kernels runs beside it
        t1 = time.perf_counter()
        second = _compile_cache_second_load()
        cfg = ServerConfig(data_path=db.data_dir, host="127.0.0.1", rest_port=0, grpc_port=0,
                           disable_telemetry=True)
        srv = Server(cfg, device="cuda", db=db)
        if _grpc_present():
            srv.start()
        else:
            srv.assemble()
        client = Client(srv.rest.address, timeout=120.0)
        queried = names[:TENANT_QUERIED]
        # one driftwatch cycle over every tenant's canary, before the
        # traffic and the capture: its probes are each tenant's first
        # search, which uploads the rows the import staged (the write
        # path's copies, which the capture would otherwise rank as the
        # traffic's), and a capture's CUPTI teardown slowed the next
        # cycle by tens of seconds on the card
        t2 = time.perf_counter()
        driftwatch.run_cycle()
        t_drift = time.perf_counter() - t2
        drift = client.request("GET", "/v1/debug/drift")
        canaries = [c for c in drift["canaries"].values()
                    if c["collection"] == "Tenants" or c["collection"].startswith("Solo")]
        recalls = [c["last"]["recall"] for c in canaries if c.get("last")]
        if len(recalls) != n_tenants + len(picks) or min(recalls) != 1.0:
            raise AssertionError(f"13b: {len(recalls)} canaries read, recall min "
                                 f"{min(recalls) if recalls else None}")
        total0, meters0 = kernelscope.total_device_seconds(), kernelscope.meters_snapshot()
        pairs0 = kernelscope.snapshot()["cuda_event_pairs"]
        wall0 = time.time()
        K.reset_launch_counts()  # phase 13's window: the served traffic
        stop = threading.Event()
        threads, lat, errors = _served_traffic(client, queried, seed, stop)
        time.sleep(TENANT_TRAFFIC_S)
        warmer.join()
        if "error" in warm:
            raise AssertionError(f"13b: the warm-up capture failed: {warm['error']}")
        # a capture slows every thread: the latencies and the residency
        # ratio are read from before it
        t_cap, wall_cap = time.perf_counter(), time.time()
        pre = [r for r in tailboard.debug_flight()["dispatches"]
               if r["t"] >= wall0 and r.get("t_source") == "drain" and "window_ms" in r]
        prof = client.request("GET", f"/v1/debug/profile?ms={PROFILE_MS}")
        t_prof = time.perf_counter() - t_cap
        stop.set()
        for t in threads:
            t.join(timeout=120)
        counts = dict(K.launch_counts)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"13b: client errors: {errors[:1]}")
        n_threads = threading.active_count()
        total = kernelscope.total_device_seconds() - total0
        meters = {k: v - meters0.get(k, 0.0)
                  for k, v in kernelscope.meters_snapshot().items()}
        metered = sum(meters.values())
        if not total > 0 or abs(metered - total) > 1e-9 * total + 1e-12:
            raise AssertionError(f"13b: meters sum {metered!r}, total {total!r}")
        hot = {t for (c, t), v in meters.items() if c == "Tenants" and v > 0}
        if hot - set(queried) or not hot:
            raise AssertionError(f"13b: metered tenants {sorted(hot)[:5]} outside the queried")
        recs = pre + [r for r in tailboard.debug_flight()["dispatches"]
                      if r["t"] >= wall_cap and r.get("t_source") == "drain"
                      and "window_ms" in r]
        if not recs or any(not 0 < r["device_ms"] <= r["window_ms"] for r in recs):
            bad = [r for r in recs if not 0 < r["device_ms"] <= r["window_ms"]][:1]
            raise AssertionError(f"13b: {len(recs)} drain records, out of (0, window]: {bad}")
        if not pre:
            raise AssertionError("13b: no drain dispatch before the capture")
        ratio = np.float64([r["device_ms"] / r["window_ms"] for r in pre])
        ranked = [(k["kernel"], k["device_ms"]) for k in prof["kernels"]]
        other = [(e["name"][:60], e["device_ms"]) for k in prof["kernels"]
                 if k["kernel"] == "other" for e in k["top_events"]]
        if not ranked or ranked[0][0] not in PROFILE_TOP:
            raise AssertionError(f"13b: the capture ranks {ranked[:4]}; other: {other}")
        clean = [ms for t2, ms in lat if t2 + ms / 1e3 <= t_cap]
        log(f"phase 13b device-time plane ({time.perf_counter() - t1:.1f} s; {_smi_line()}): "
            f"{len(lat)} GraphQL tenant nearVector(limit {TENANT_K}) over {CLIENTS} clients "
            f"to {len(queried)} tenants, {len(clean)} of them in {TENANT_TRAFFIC_S:.1f} s "
            f"before the capture: {len(clean) / TENANT_TRAFFIC_S:.0f} QPS, p50 "
            f"{np.percentile(clean, 50):.2f} ms, p90 {np.percentile(clean, 90):.2f} ms; "
            f"{n_threads} threads in the process; meters sum {metered:.6f} s = total "
            f"{total:.6f} s, {len(hot)} tenants metered, all of them queried; {len(recs)} "
            f"drain dispatches with CUDA-event residency in (0, window], residency / window "
            f"before the capture p50 {np.percentile(ratio, 50):.3f} max {ratio.max():.3f}; "
            f"{kernelscope.snapshot()['cuda_event_pairs'] - pairs0} new CUDA-event pairs "
            f"(pool {kernelscope.snapshot()['cuda_event_pairs']}); /v1/debug/profile?ms="
            f"{PROFILE_MS} (answered in {t_prof:.1f} s; the 1 ms warm-up capture "
            f"took {warm['s']:.1f} s) ranks {ranked[:4]} of "
            f"{prof['total_device_ms']} device ms "
            f"({prof['raw_events']} events; \"other\" {other}); launches {counts}")
        for name in TENANT_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"13b: the served traffic launched no {name}")

        ks = client.request("GET", "/v1/debug/kernelscope")
        out, err = second.communicate(timeout=300)
        if second.returncode != 0:
            raise AssertionError(f"13b: the second load failed: {err[-2000:]}")
        cache = json.loads(out.strip().splitlines()[-1])
        if cache["hit"] != len(K.launch_counts) or cache["miss"] != 0:
            raise AssertionError(f"13b: second load's compile cache events {cache}")
        log(f"phase 13b driftwatch and cache: one "
            f"driftwatch cycle over {len(recalls)} canaries in {t_drift:.1f} s, canary "
            f"recall@10 min {min(recalls)}, gate {drift['gateOk']}; /v1/debug/drift and "
            f"/v1/debug/kernelscope answered ({len(ks['variants'])} variants, dispatches "
            f"{ks['dispatches']}); a second process loaded the kernels: compile_cache_events "
            f"{cache}")
        log(f"phase 13 tenants and the device-time plane: {time.perf_counter() - t0:.1f} s")
        return counts
    finally:
        warmer.join(timeout=300)
        if second is not None and second.poll() is None:
            second.kill()
            second.wait()
        if srv is not None:
            srv.stop()
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 14: the cluster ----------------------------------------------------------

CLUSTER_NODES = ("node-0", "node-1", "node-2")
CLUSTER_SHARDS = 3
# the default run's sizes keep phase 14 within about 60 s: the script ran
# 1,134 s of its 1,200 s before it; --cluster-only runs the full sizes
CLUSTER_BUDGET_S = 20.0     # the default run's import through node-0
CLUSTER_QUERIES = 32        # each REST run: 8 clients x 4 (--cluster-only: 8 x 32)
CLUSTER_ONLY_QUERIES = CLIENTS * CALLS
CLUSTER_SIDE = 2            # through node-1 and node-2 each, one of them filtered
CLUSTER_FUSED = 8           # the second pass, selection "fused"
CLUSTER_K = 100
CLUSTER_EPOCHS = 4          # sealed epochs of 14d's source shard
CLUSTER_EPOCH_ROWS = 2048   # the default run's; --cluster-only: 65,536
CLUSTER_EPOCH_ONLY_ROWS = 65_536
CLUSTER_EPOCH_SIBLING = 2048  # rows of 14d's sibling shard of its own
CLUSTER_EPOCH_Q = 8
CLUSTER_DEGRADED_Q = 4      # 14e's nearVector through a survivor
CLUSTER_ELECT_S = 10.0      # survivors elect a leader within this
CLUSTER_RPC_S = 120.0       # per-attempt ceiling of a shard RPC (14d's ingest)
CLUSTER_KERNELS = ("distance_block", "fused_topk_pairs", "fused_topk_scan")


def _cluster_config(name: str, epoch_rows: int = 0, shards: int = CLUSTER_SHARDS):
    from weaviate_tpu_torch.schema.config import (CollectionConfig, Property,
                                                  ShardingConfig, VectorConfig,
                                                  VectorIndexConfig)

    return CollectionConfig(
        name=name,
        properties=[Property(name="category", data_type="text"),
                    Property(name="views", data_type="int")],
        vectors=[VectorConfig(index=VectorIndexConfig(
            index_type="flat", metric=METRIC, epoch_rows=epoch_rows))],
        sharding=ShardingConfig(desired_count=shards))


def _cluster_boot(base: str, dev: str) -> list:
    """Three ClusterNodes in this process: real sockets on port 0, real
    gossip and Raft, every store on ``dev``."""
    from weaviate_tpu_torch.cluster import ClusterNode

    nodes = [ClusterNode(n, os.path.join(base, n), raft_peers=list(CLUSTER_NODES),
                         gossip_interval=0.1, election_timeout=(0.3, 0.6),
                         remote_timeout=CLUSTER_RPC_S, device=dev)
             for n in CLUSTER_NODES]
    for n in nodes:
        n.membership.join([p.address for p in nodes])
    for n in nodes:
        n.start()
        # each node's cycles would run the process-wide driftwatch registry,
        # every node's canaries three times over (one process a node runs
        # its own); phase 13 drives driftwatch
        n.db.cycles.unregister("driftwatch")
    for n in nodes:
        n.raft.wait_for_leader(timeout=20.0)
    return nodes


def _cluster_wait(cond, timeout: float, what: str, phase: str = "14",
                  detail=None) -> float:
    """Seconds until ``cond()`` holds; the condition is read once more at
    the deadline (a thread starved past it still sees the last state).
    ``detail()`` adds the state that was waited on to the failure."""
    t0 = time.perf_counter()
    while True:
        if cond():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 >= timeout:
            break
        time.sleep(0.01)
    extra = f": {detail()}" if detail is not None else ""
    raise AssertionError(f"phase {phase}: timed out waiting for {what}{extra}")


def _cluster_schema(fn, done, what: str, phase: str = "14") -> None:
    """A schema write, retried while leadership moves under it; a propose
    that timed out after it committed shows up as ``done()``."""
    last = None
    for _ in range(5):
        try:
            fn()
            return
        except Exception as e:  # noqa: BLE001 — a leader change, retried
            last = e
            if done():
                return
            time.sleep(0.2)
    raise AssertionError(f"phase {phase}: {what} failed: {last}")


def _cluster_rows(seed: int, start: int, n: int, cent, prefix: int) -> list:
    v = clustered(seed, start, n, cent)
    views = np.random.default_rng([seed, start, 14]).integers(0, 100, n)
    return [{"uuid": _uuid(prefix, start + i),
             "properties": {"category": f"cat{(start + i) % 100}", "views": int(views[i])},
             "vector": v[i]} for i in range(n)]


def _gql_answers(out: list) -> tuple:
    ids = np.asarray([[int(h["_additional"]["id"].rsplit("-", 1)[1]) for h in res]
                      for res in out])
    dists = np.asarray([[h["_additional"]["distance"] for h in res] for res in out])
    return ids, dists


def _same_cluster_answers(got: list, want: list, what: str) -> None:
    """ids through tie_aware_mismatches, distances bit for bit."""
    if [len(r) for r in got] != [len(r) for r in want]:
        raise AssertionError(f"phase 14 {what}: answer lengths differ")
    ai, ad = _gql_answers(got)
    bi, bd = _gql_answers(want)
    bad = tie_aware_mismatches(ai, ad, bi, bd)
    if bad or not np.array_equal(ad, bd) or not np.isfinite(ad).all():
        raise AssertionError(f"phase 14 {what}: {bad} id mismatches, distances "
                             f"equal {np.array_equal(ad, bd)}")


def _equal_hits(got: list, want: list) -> bool:
    """Two answers as (uuid, distance[, properties]) lists, bit for bit."""
    return got == want


def _set_selection(cols, selection: str) -> None:
    """Set the selection of every shard's flat store in ``cols``."""
    for c in cols:
        for s in c.shards.values():
            s.vector_indexes[""].store.selection = selection


def _dispatches(nodes, name: str) -> dict:
    out = {}
    for n in nodes:
        col = n.db.collections.get(name)
        out[n.name] = sum(b.dispatches for s in (col.shards.values() if col else ())
                          for b in s._query_batchers.values())
    return out


def _trace_split(trace: dict) -> str:
    """One traced query's spans: the remote hop (rpc.client less the owning
    node's shard.vector_search: encode, socket, decode, handler), the
    owning node's batcher and kernels (its shard.vector_search, and the
    batcher's wait / execute / transfer in it), and the merge (the query
    less its slowest leg)."""
    spans = trace["spans"]
    by_parent: dict = {}
    for s in spans:
        by_parent.setdefault(s.get("parent_id"), []).append(s)

    def below(s, name):
        out, todo = [], [s]
        while todo:
            x = todo.pop()
            for c in by_parent.get(x["span_id"], []):
                if c["name"] == name:
                    out.append(c)
                todo.append(c)
        return out

    query = next(s for s in spans if s["name"] == "query.vector")
    legs = []
    for c in below(query, "rpc.client"):
        sv = below(c, "shard.vector_search")
        serve = sum(x["duration_ms"] for x in sv)
        parts = {n: sum(x["duration_ms"] for x in below(c, n))
                 for n in ("batcher.wait", "batcher.execute", "batcher.transfer")}
        legs.append((c["duration_ms"], c["duration_ms"] - serve, serve, parts,
                     c["attrs"].get("addr")))
    local = [s for s in below(query, "shard.vector_search") if not s["attrs"].get("remote")]
    slowest = max([x[0] for x in legs] + [s["duration_ms"] for s in local])
    text = [f"query {query['duration_ms']:.2f} ms"]
    for total, hop, serve, parts, addr in legs:
        text.append(f"remote leg {total:.2f} ms = hop {hop:.2f} ms + owning node "
                    f"{serve:.2f} ms (batcher wait {parts['batcher.wait']:.2f}, execute "
                    f"{parts['batcher.execute']:.2f}, transfer "
                    f"{parts['batcher.transfer']:.2f})")
    for s in local:
        text.append(f"local leg {s['duration_ms']:.2f} ms")
    text.append(f"merge and the rest {query['duration_ms'] - slowest:.2f} ms")
    return "; ".join(text)


def phase_cluster(torch, K, seed: int, rows: int, budget_s: float, epoch_rows: int,
                  nq: int = CLUSTER_QUERIES, dev: str = "cuda") -> dict:
    """14: three ClusterNodes hold a Performance768D1M collection between
    them; every answer is held to a one-node Database on the same card."""
    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.api.rest import RestServer
    from weaviate_tpu_torch.cluster import transport
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.db.collection import Collection, SearchResult
    from weaviate_tpu_torch.db.sharding import ShardingState
    from weaviate_tpu_torch.runtime import degrade, tracing
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger
    from weaviate_tpu_torch.schema.config import Property

    smi = _smi_line() if dev == "cuda" else "cpu"
    base = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    nodes, closed, ref, rsrv = [], set(), None, None
    paused = contextlib.ExitStack()
    # the reference's class has its own name (the ledger keys its bytes by
    # collection and shard) and the same shard names as the cluster's
    name, rname, ename = "Cluster768", "Cluster768Ref", "ClusterEpochs"
    try:
        t0 = time.perf_counter()
        nodes = _cluster_boot(base, dev)
        boot_s = time.perf_counter() - t0
        ref = Database(os.path.join(base, "ref"), device=dev)
        _cluster_schema(lambda: nodes[0].create_collection(_cluster_config(name)),
                        lambda: name in nodes[0].db.collections, "create_collection")
        _cluster_wait(lambda: all(name in n.db.collections for n in nodes), 20.0,
                      "the collection on every node")
        ref.create_collection(_cluster_config(rname))
        col = nodes[0].get_collection(name)
        rcol = ref.get_collection(rname)
        owner = {s: col.sharding.nodes_for(s)[0] for s in col.sharding.shard_names}
        if sorted(owner.values()) != sorted(CLUSTER_NODES):
            raise AssertionError(f"phase 14: shards not spread over the nodes: {owner}")

        # 14a: the import, the same sequential batches into both
        cent = centers(seed + 14)
        done, cl_s, ref_s, crossed, first = 0, 0.0, 0.0, 0, None
        while done < rows and cl_s < budget_s:
            n = min(IMPORT_BATCH, rows - done)
            batch = _cluster_rows(seed + 14, done, n, cent, 1400)
            if first is None:
                first = np.stack([o["vector"] for o in batch])
            crossed += sum(owner[col.sharding.shard_for(o["uuid"])] != "node-0"
                           for o in batch)
            t1 = time.perf_counter()
            res = col.batch_put(batch)
            cl_s += time.perf_counter() - t1
            t1 = time.perf_counter()
            rres = rcol.batch_put(batch)
            ref_s += time.perf_counter() - t1
            if any(r["status"] != "SUCCESS" for r in res + rres):
                raise AssertionError(f"phase 14: batch_put failed: {res[0]} {rres[0]}")
            done += n
        cut = "" if done == rows else (f" (cut from {rows}: the import budget of "
                                       f"{budget_s:.0f} s ran out)")
        per_node = {n.name: sum(s.object_count() for s in n.get_collection(name).shards.values())
                    for n in nodes}
        log(f"phase 14a cluster import [{smi}]: 3 nodes booted in {boot_s:.2f} s; {done} rows"
            f"{cut} through node-0's batch_put in {cl_s:.1f} s ({done / cl_s:.0f} rows/s), "
            f"{crossed} of them ({crossed / done:.1%}) over the internal transport; the "
            f"one-node reference took the same batches in {ref_s:.1f} s "
            f"({done / ref_s:.0f} rows/s); rows a node {per_node}")
        if col.object_count() != done or rcol.object_count() != done \
                or sum(per_node.values()) != done:
            raise AssertionError(f"phase 14: object counts {col.object_count()} / "
                                 f"{rcol.object_count()} / {per_node} != {done}")

        # 14b: answers through REST, held bit for bit to the reference's. The
        # nodes' background cycles (LSM flush and compaction after the
        # import) wait while 14b and 14c measure, as the reference's
        # Database runs none; a cycle in flight finishes first
        t_part = time.perf_counter()
        for n in nodes:
            paused.enter_context(n.db.cycles.pause())
        pause_s = time.perf_counter() - t_part
        for n in nodes:
            n.serve_rest()
        rsrv = RestServer(ref)
        rsrv.start()
        clients = [Client(n.rest.address) for n in nodes]
        rclient = Client(rsrv.address)
        rng = np.random.default_rng([seed, 14])
        queries = near_queries(seed + 14, rng.integers(0, len(first), nq),
                               lambda r: first[r])

        def asker(client, filtered, cls=name):
            q = _near_gql(CLUSTER_K, filtered) % cls
            return lambda i: _gql(client, q, {"v": queries[i].tolist()})

        def set_selection(selection):
            _set_selection([n.get_collection(name) for n in nodes] + [rcol], selection)

        nf = CLUSTER_FUSED
        want, timings = {}, {}
        for filtered in (False, True):  # the reference first: its launches do not count
            want[filtered], lat, wall = _run_clients(asker(rclient, filtered, rname), nq)
            timings[("ref", filtered)] = _timed_text(lat, wall, nq)
        set_selection("fused")
        want["fused"] = [asker(rclient, i % 2 == 1, rname)(i) for i in range(nf)]
        set_selection("approx")
        before = _dispatches(nodes, name)
        K.reset_launch_counts()  # the cluster's run starts here
        got = {}
        for filtered in (False, True):
            got[filtered], lat, wall = _run_clients(asker(clients[0], filtered), nq)
            timings[("cluster", filtered)] = _timed_text(lat, wall, nq)
        side = {}
        for c in (1, 2):
            side[c] = [asker(clients[c], i % 2 == 1)(i) for i in range(CLUSTER_SIDE)]
        set_selection("fused")
        got["fused"] = [asker(clients[0], i % 2 == 1)(i) for i in range(nf)]
        set_selection("approx")
        counts = dict(K.launch_counts)  # ... and ends here
        after = _dispatches(nodes, name)
        for filtered in (False, True):
            _same_cluster_answers(got[filtered], want[filtered],
                                  "filtered" if filtered else "unfiltered")
        for c in (1, 2):
            ref_side = [want[i % 2 == 1][i] for i in range(CLUSTER_SIDE)]
            _same_cluster_answers(side[c], ref_side, f"through node-{c}")
        _same_cluster_answers(got["fused"], want["fused"], "selection fused")
        served = {k: after[k] - before[k] for k in after}
        if dev == "cuda":
            for kname in CLUSTER_KERNELS:
                if counts[kname] <= 0:
                    raise AssertionError(f"{kname} was not launched in phase 14")
        if any(v <= 0 for v in served.values()):
            raise AssertionError(f"phase 14: a node's batcher served nothing: {served}")
        # object_count, an aggregation and the batched fetch
        agg, ragg = col.aggregate(properties=["views"]), rcol.aggregate(properties=["views"])
        if agg != ragg:
            raise AssertionError(f"phase 14: aggregate {agg} != {ragg}")
        hits = col.near_vector(queries[0], k=CLUSTER_K, include_objects=False)
        t1 = time.perf_counter()
        col._attach_objects(hits)
        fetch_ms = (time.perf_counter() - t1) * 1e3
        rhits = rcol.near_vector(queries[0], k=CLUSTER_K)
        if not _equal_hits([(r.uuid, r.distance, r.object.properties) for r in hits],
                           [(r.uuid, r.distance, r.object.properties) for r in rhits]):
            raise AssertionError("phase 14: the batched fetch differs from the reference")
        log(f"phase 14b cluster answers [{smi}]: GraphQL nearVector k={CLUSTER_K} from "
            f"{CLIENTS} clients through node-0's REST, ids (tie-aware) and distances bit for "
            f"bit the one-node reference's: unfiltered {timings[('cluster', False)]} "
            f"(reference {timings[('ref', False)]}); where(views >= {VIEWS_CUT}) "
            f"{timings[('cluster', True)]} (reference {timings[('ref', True)]}); "
            f"{CLUSTER_SIDE} each through node-1 and node-2 and {nf} under selection "
            f"\"fused\" equal too; object_count {col.object_count()}, aggregate(views) "
            f"and the batched fetch of {len(hits)} objects ({fetch_ms:.1f} ms) equal; "
            f"launches {counts}; batcher dispatches a node {served} "
            f"({time.perf_counter() - t_part:.1f} s, {pause_s:.1f} s of it waiting for the "
            "nodes' cycles in flight)")

        # 14c: where one query's time goes, from its stitched trace
        with tracing.trace("cluster.nearVector", force=True):
            col.near_vector(queries[1], k=CLUSTER_K, include_objects=False)
        split = _trace_split(tracing.recent_traces(1)[0])
        rshard = next(s for s, o in owner.items() if o != "node-0")
        items = col.remote.search_shard(owner[rshard], name, rshard, vector=queries[1],
                                        k=CLUSTER_K, include_objects=False)
        items_obj = col.remote.search_shard(owner[rshard], name, rshard,
                                            vector=queries[1], k=CLUSTER_K)
        nbytes = len(transport.dumps({"results": items}))
        nbytes_obj = len(transport.dumps({"results": items_obj}))
        log(f"phase 14c where the time goes [{smi}]: one traced nearVector k={CLUSTER_K} "
            f"through node-0: {split}; one remote search reply {nbytes} bytes "
            f"({nbytes_obj} with the objects)")

        paused.close()

        # 14d: the cross-node epoch migration under a quota
        t_part = time.perf_counter()
        src_node, dst_node = nodes[0], nodes[1]
        state = ShardingState(shard_names=["shard-0", "shard-1"],
                              placement={"shard-0": [src_node.name],
                                         "shard-1": [dst_node.name]})
        _cluster_schema(lambda: src_node.create_collection(
            _cluster_config(ename, epoch_rows=epoch_rows, shards=2),
            sharding_state=ShardingState.from_dict(state.to_dict())),
            lambda: ename in src_node.db.collections, "the epoch collection")
        _cluster_wait(lambda: all(ename in n.db.collections for n in nodes), 20.0,
                      "the epoch collection on every node")
        ecol = src_node.get_collection(ename)
        want_src = CLUSTER_EPOCHS * epoch_rows
        ecent = centers(seed + 15)
        acked, n_src, n_dst, start = [], 0, 0, 0
        t1 = time.perf_counter()
        while n_src < want_src or n_dst < CLUSTER_EPOCH_SIBLING:
            batch = _cluster_rows(seed + 15, start, IMPORT_BATCH, ecent, 1500)
            start += IMPORT_BATCH
            keep = []
            for o in batch:
                if ecol.sharding.shard_for(o["uuid"]) == "shard-0":
                    if n_src < want_src:
                        keep.append(o)
                        n_src += 1
                elif n_dst < CLUSTER_EPOCH_SIBLING:
                    keep.append(o)
                    n_dst += 1
            res = ecol.batch_put(keep)
            if any(r["status"] != "SUCCESS" for r in res):
                raise AssertionError(f"phase 14d: batch_put failed: {res[0]}")
            acked += [o["uuid"] for o in keep]
        eimport_s = time.perf_counter() - t1
        src = ecol.shards["shard-0"]
        es = src.vector_indexes[""].epoch_store
        es.seal_active()
        dst_shard = dst_node.get_collection(ename).shards["shard-1"]
        eq = near_queries(seed + 15, rng.integers(0, len(first), CLUSTER_EPOCH_Q),
                          lambda r: first[r])
        answers_before = [[(r.uuid, r.distance) for r in
                           ecol.near_vector(q, k=CLUSTER_K, include_objects=False)]
                          for q in eq]

        def node_bytes():
            # the three nodes share this process's ledger, so each node's
            # reading (the source's own and its peers') is the bytes of the
            # epoch collection's shards it owns: the big collection's shards
            # weigh the same on every node but for the power-of-two steps of
            # their stores, which would decide the choice by chance
            return {n.name: sum(ledger.shard_bytes(ename, s)
                                for s in n.get_collection(ename).shards)
                    for n in nodes if n.name not in closed}

        moved_before, dst_before = es.migrations_total, dst_shard.object_count()
        src_bytes = ledger.shard_bytes(ename, "shard-0")
        own = node_bytes()
        if own[dst_node.name] >= own[src_node.name]:
            raise AssertionError(f"phase 14d: node-1 reads {own[dst_node.name]} bytes, not "
                                 f"under node-0's {own[src_node.name]}")
        with src_node.db.cycles.pause():
            src.shard_hbm_limit = 1  # past its watermark: the epoch policy moves
            src_node.db.local_hbm_provider = lambda: node_bytes()[src_node.name]
            try:
                # the only remote sibling's node reads heavier: nothing moves
                src_node.db.node_hbm_provider = lambda: {
                    **node_bytes(), dst_node.name: node_bytes()[src_node.name] + 1}
                src_node.db._epoch_cycle()
                if es.migrations_total != moved_before or src._migrated_count \
                        or dst_shard.object_count() != dst_before:
                    raise AssertionError("phase 14d: an epoch moved to a heavier node")
                src_node.db.node_hbm_provider = node_bytes
                t1 = time.perf_counter()
                with tracing.trace("cluster.migrate", force=True):
                    src_node.db._epoch_cycle()
                mig_s = time.perf_counter() - t1
            finally:
                src.shard_hbm_limit = 0
                src_node.db.node_hbm_provider = src_node._gossiped_hbm
                src_node.db.local_hbm_provider = None
        mig_spans = tracing.recent_traces(1)[0]["spans"]
        ingest = [x for x in mig_spans if x["name"] == "rpc.client"
                  and x["attrs"].get("path", "").endswith("/objects")]
        served = [x for x in mig_spans if x["name"] == "rpc.server"
                  and x["attrs"].get("remote")]
        mig_split = (f"the ingest RPC {sum(x['duration_ms'] for x in ingest):.0f} ms, "
                     f"node-1's handler {sum(x['duration_ms'] for x in served):.0f} ms "
                     "of it") if ingest else "no ingest span"
        moved = dst_shard.object_count() - dst_before
        if es.migrations_total != moved_before + 1 or moved <= 0:
            raise AssertionError(f"phase 14d: {es.migrations_total - moved_before} "
                                 f"migrations, {moved} rows on node-1's shard-1")
        answers_after = [[(r.uuid, r.distance) for r in
                          ecol.near_vector(q, k=CLUSTER_K, include_objects=False)]
                         for q in eq]
        if not all(_equal_hits(a, b) for a, b in zip(answers_after, answers_before)):
            raise AssertionError("phase 14d: answers after the migration differ")
        src_ids = set(src._doc_to_uuid.values())
        dst_ids = set(dst_shard._doc_to_uuid.values())
        if src_ids & dst_ids or (src_ids | dst_ids) != set(acked) \
                or len(src_ids) + len(dst_ids) != len(acked):
            raise AssertionError("phase 14d: an acknowledged write is not held exactly once")
        migrated = [u for u in acked if src.migrated_to(u) == "shard-1"]
        if len(migrated) != moved:
            raise AssertionError(f"phase 14d: {len(migrated)} routing markers for {moved} "
                                 "rows moved")
        for u in migrated[::max(1, len(migrated) // 256)]:
            obj = ecol.get_object(u)
            if obj is None or obj.uuid != u:
                raise AssertionError(f"phase 14d: migrated {u} does not read back")
        if ecol.object_count() != len(acked):
            raise AssertionError("phase 14d: object_count after the migration")
        log(f"phase 14d cross-node epoch migration [{smi}]: {len(acked)} rows ({n_src} on "
            f"node-0's shard-0 in {CLUSTER_EPOCHS} sealed epochs of {epoch_rows}, {n_dst} on "
            f"node-1's shard-1) imported in {eimport_s:.1f} s; shard-0 over its quota: with "
            f"node-1 reading heavier than node-0 nothing moved; with the nodes' own readings "
            f"(node-0 {own[src_node.name]}, node-1 {own[dst_node.name]} bytes) the "
            f"epoch policy moved one epoch ({moved} rows) to node-1 over the shard RPC in "
            f"{mig_s:.2f} s ({mig_split}); shard-0's ledger {src_bytes} -> "
            f"{ledger.shard_bytes(ename, 'shard-0')} bytes; every acknowledged write held "
            f"exactly once, the markers route reads, {CLUSTER_EPOCH_Q} nearVector k="
            f"{CLUSTER_K} answers bit for bit the ones before "
            f"({time.perf_counter() - t_part:.1f} s)")

        # 14e: Raft — a schema write through a follower, then the leader stops
        t_part = time.perf_counter()
        follower = next(n for n in nodes if not n.raft.is_leader)
        def has(n, prop):
            return n.get_collection(name).config.property(prop) is not None

        t1 = time.perf_counter()
        _cluster_schema(lambda: follower.add_property(name, Property("extra", "int")),
                        lambda: has(follower, "extra"), "add_property through a follower")
        _cluster_wait(lambda: all(has(n, "extra") for n in nodes), 20.0,
                      "the property on every node")
        write_s = time.perf_counter() - t1
        leader = next(n for n in nodes if n.raft.is_leader)
        survivors = [n for n in nodes if n is not leader]
        dead = {s for s, o in owner.items() if o == leader.name}
        t1 = time.perf_counter()
        leader.close()
        closed.add(leader.name)
        stop_s = time.perf_counter() - t1
        elect_s = _cluster_wait(lambda: any(n.raft.is_leader for n in survivors),
                                CLUSTER_ELECT_S, f"a leader within {CLUSTER_ELECT_S} s")
        new_leader = next(n for n in survivors if n.raft.is_leader)
        t1 = time.perf_counter()
        _cluster_schema(lambda: new_leader.add_property(name, Property("afterFailover", "int")),
                        lambda: has(new_leader, "afterFailover"),
                        "a schema write after the failover")
        _cluster_wait(lambda: all(has(n, "afterFailover") for n in survivors), 20.0,
                      "the post-failover property on the survivors")
        commit_s = time.perf_counter() - t1
        scol = survivors[0].get_collection(name)
        mismatched = 0
        for q in queries[:CLUSTER_DEGRADED_Q]:
            with degrade.collecting():
                res = scol.near_vector(q, k=CLUSTER_K, include_objects=False)
                markers = degrade.snapshot()
            if not any(m["kind"] == "missing_shard" and m["shard"] in dead for m in markers):
                raise AssertionError(f"phase 14e: no missing_shard marker: {markers}")
            lists = []
            for s in rcol.sharding.shard_names:
                if s in dead:
                    continue
                sh = rcol.shards[s]
                ids, d = sh.vector_search(np.asarray(q, np.float32), CLUSTER_K, "", None)
                lists.append([SearchResult(uuid=sh._doc_to_uuid[i], distance=x, shard=s)
                              for i, x in zip(ids.tolist(), d.tolist())
                              if i in sh._doc_to_uuid])
            exp = Collection._merge_by_distance(lists, CLUSTER_K)
            mismatched += not _equal_hits([(r.uuid, r.distance) for r in res],
                                          [(r.uuid, r.distance) for r in exp])
        if mismatched:
            raise AssertionError(f"phase 14e: {mismatched} degraded answers differ from the "
                                 "reference restricted to the survivors' shards")
        log(f"phase 14e raft [{smi}]: add_property through follower {follower.name} applied "
            f"on every node in {write_s * 1e3:.1f} ms; leader {leader.name} stopped, "
            f"{new_leader.name} elected in {elect_s:.2f} s (deadline {CLUSTER_ELECT_S:.0f} s), "
            f"a schema write committed on the survivors in {commit_s * 1e3:.1f} ms; "
            f"{CLUSTER_DEGRADED_Q} nearVector through {survivors[0].name} answered with "
            f"missing_shard for {sorted(dead)}, equal bit for bit to the reference over the "
            f"survivors' shards (the leader node's close took {stop_s:.1f} s; 14e "
            f"{time.perf_counter() - t_part:.1f} s)")
        return counts
    finally:
        paused.close()
        if rsrv is not None:
            rsrv.stop()
        for n in nodes:
            if n.name not in closed:
                n.close()
        if ref is not None:
            ref.close()
        shutil.rmtree(base, ignore_errors=True)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()


# -- phase 15: replication ----------------------------------------------------------

# the default run's sizes keep phase 15 within about 60 s; --replication-only
# imports --rows rows and scales 65,536
REPL_BUDGET_S = 15.0        # the default run's 2PC import through node-0
# --replication-only's default rows: 1,000,000 did not fit ~1,100 s (its
# 2PC import alone ran 971.2 s, 1,030 rows/s, on an H100 80GB HBM3 at
# 700 W: three nodes' LSM compaction and 2PC share one interpreter lock)
REPL_ONLY_ROWS = 500_000
REPL_QUERIES = 16           # nearVector a pass through each node (--replication-only 64)
REPL_ONLY_QUERIES = 64
REPL_FUSED = 4              # the pass under selection "fused", through each node
REPL_PART_ROWS = 2000       # 15c's batch written at QUORUM behind the cut
REPL_PART_START = 10 ** 9   # ... drawn past every row of 15a
REPL_READ_BACK = 64         # 15c's QUORUM reads of the acknowledged rows
REPL_CHECK_Q = 8            # 15c and 15e's nearVector through each node
REPL_SCALE_ROWS = 8192      # 15e's factor-1 collection (--replication-only 65,536)
REPL_SCALE_ONLY_ROWS = 65_536
REPL_MAX_ROUNDS = 8         # hashbeat rounds 15c may take to converge
REPL_DEPTH = 8              # the hashbeat's tree depth (HashBeater's default)


def _repl_config(name: str, factor: int):
    from weaviate_tpu_torch.schema.config import ReplicationConfig

    cfg = _cluster_config(name)
    cfg.replication = ReplicationConfig(factor=factor)
    return cfg


def _uid_int(uuid: str) -> int:
    """``_uuid(prefix, row)`` back to one integer (prefix and row)."""
    return int(uuid[-17:].replace("-", ""))


def _repl_answers(col, queries, where=None) -> tuple:
    """nearVector k 100 of each query: ids [nq, k] and distances [nq, k]."""
    ids, dists = [], []
    for q in queries:
        res = col.near_vector(np.asarray(q, np.float32), k=CLUSTER_K, where=where,
                              include_objects=False)
        ids.append([_uid_int(r.uuid) for r in res])
        dists.append([r.distance for r in res])
    return ids, dists


def _same_repl(got: tuple, want: tuple, what: str, phase: str = "15") -> None:
    """ids through tie_aware_mismatches, distances bit for bit."""
    if [len(r) for r in got[0]] != [len(r) for r in want[0]]:
        raise AssertionError(f"phase {phase} {what}: answer lengths differ")
    ai, bi = np.asarray(got[0]), np.asarray(want[0])
    ad, bd = np.float32(got[1]), np.float32(want[1])
    bad = tie_aware_mismatches(ai, ad, bi, bd)
    if bad or not np.array_equal(ad, bd) or not np.isfinite(ad).all():
        raise AssertionError(f"phase {phase} {what}: {bad} id mismatches, distances equal "
                             f"{np.array_equal(ad, bd)}")


@contextlib.contextmanager
def _remote_searches(nodes):
    """Every remote search leg the nodes send while the block runs."""
    calls: list = []
    for n in nodes:
        orig = n.remote.search_shard

        def counted(*a, _orig=orig, **kw):
            calls.append(a[:3])
            return _orig(*a, **kw)

        n.remote.search_shard = counted
    try:
        yield calls
    finally:
        for n in nodes:
            vars(n.remote).pop("search_shard", None)


def _node_run(K, acc: dict, fn):
    """``fn()`` with the launch counters set to 0 just before and added to
    ``acc`` just after: the runs through the nodes count, the reference's
    do not."""
    K.reset_launch_counts()
    try:
        return fn()
    finally:
        for k, v in K.launch_counts.items():
            acc[k] = acc.get(k, 0) + v


def _schema_state(nodes, cols, shards) -> str:
    """Each node's factor and replicas a shard beside its Raft position."""
    out = []
    for n, c in zip(nodes, cols):
        r = n.raft
        out.append(f"{n.name} factor {c.config.replication.factor} replicas "
                   f"{[len(c.sharding.nodes_for(s)) for s in shards]} raft {r.role} "
                   f"term {r.current_term} leader {r.leader_id} commit {r.commit_index} "
                   f"applied {r.last_applied} last {r._abs_last()}")
    return "; ".join(out)


def _local_rows(col, shards) -> int:
    return sum(col._load_shard(s).object_count() for s in shards)


def _store_bytes(col) -> int:
    """Device bytes of the collection's flat stores on this node."""
    total = 0
    for s in col.shards.values():
        st = s.vector_indexes[""].store
        for a in ("vectors", "valid", "sq_norms"):
            t = getattr(st, a, None)
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def _repl_serving(nodes, name: str, shards, timeout: float = 30.0) -> float:
    """After the heal: wait until every replica answers a digest probe from
    every node (the breakers opened by the cut released). The probe reads
    one key: a hashtree probe would build the shard's tree first, seconds
    at 100,000 rows a shard, past the probe's timeout."""
    from weaviate_tpu_torch.cluster.transport import RpcError, rpc
    from weaviate_tpu_torch.runtime import faultline

    t0 = time.perf_counter()
    pending = {(a.name, b.name) for a in nodes for b in nodes if a is not b}
    last = None
    while pending and time.perf_counter() - t0 < timeout:
        for src, dst in sorted(pending):
            addr = next(n.address for n in nodes if n.name == dst)
            try:
                with faultline.node_scope(src):
                    rpc(addr, f"/replicas/{name}/{shards[0]}/digest",
                        {"uuid": _uuid(0, 0)}, timeout=2.0)
                pending.discard((src, dst))
            except RpcError as e:
                last = e
        if pending:
            time.sleep(0.1)
    if pending:
        raise AssertionError(f"phase 15c: {sorted(pending)} not serving after the heal: {last}")
    return time.perf_counter() - t0


def phase_replication(torch, K, seed: int, rows: int, budget_s: float, scale_rows: int,
                      nq: int = REPL_QUERIES, dev: str = "cuda") -> dict:
    """15: three ClusterNodes hold a Performance768D1M collection at
    replication factor 3, every node a whole copy on the card; every answer
    is held to a one-node Database on the same card."""
    import copy

    from weaviate_tpu_torch.api.client import Client
    from weaviate_tpu_torch.db import Database
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.replication import ConsistencyError, HashBeater
    from weaviate_tpu_torch.runtime import faultline
    from weaviate_tpu_torch.runtime.hbm_ledger import ledger
    from weaviate_tpu_torch.storage.objects import StorageObject

    smi = _smi_line() if dev == "cuda" else "cpu"
    base = tempfile.mkdtemp(prefix="chip_smoke_repl_")
    nodes, ref = [], None
    paused = contextlib.ExitStack()
    name, rname, sname, srname = "Repl768", "Repl768Ref", "Scale768", "Scale768Ref"
    where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)
    counts: dict = dict.fromkeys(K.launch_counts, 0)
    try:
        t0 = time.perf_counter()
        nodes = _cluster_boot(base, dev)
        for n in nodes:
            # the phase drives the hashbeat rounds itself (15c): three nodes'
            # beats in one process would share one interpreter lock with the
            # import (a node of its own runs its own)
            n.db.cycles.unregister("hashbeat")
        boot_s = time.perf_counter() - t0
        ref = Database(os.path.join(base, "ref"), device=dev)
        # the phase's Raft schema writes, before any load (the scaler's
        # placement, 15e, is the third)
        t1 = time.perf_counter()
        for cname, factor in ((name, 3), (sname, 1)):
            _cluster_schema(lambda c=cname, f=factor: nodes[0].create_collection(
                _repl_config(c, f)), lambda c=cname: c in nodes[0].db.collections,
                f"create_collection {cname}", phase="15")
            _cluster_wait(lambda c=cname: all(c in n.db.collections for n in nodes), 20.0,
                          f"{cname} on every node", phase="15")
        raft_s = time.perf_counter() - t1
        ref.create_collection(_repl_config(rname, 1))  # the same shard names
        ref.create_collection(_repl_config(srname, 1))
        cols = [n.get_collection(name) for n in nodes]
        col, rcol = cols[0], ref.get_collection(rname)
        shards = sorted(col.sharding.shard_names)
        if any(sorted(c.sharding.nodes_for(s)) != sorted(CLUSTER_NODES)
               for c in cols for s in shards):
            raise AssertionError("phase 15: a shard is not placed on all three nodes")

        # 15a: the import at QUORUM through node-0, the same batches into the reference
        cent = centers(seed + 16)
        done, cl_s, ref_s, first = 0, 0.0, 0.0, None
        while done < rows and cl_s < budget_s:
            n = min(IMPORT_BATCH, rows - done)
            batch = _cluster_rows(seed + 16, done, n, cent, 1600)
            if first is None:
                first = np.stack([o["vector"] for o in batch])
            t1 = time.perf_counter()
            res = col.batch_put(batch, consistency="QUORUM")
            cl_s += time.perf_counter() - t1
            t1 = time.perf_counter()
            rres = rcol.batch_put(batch)
            ref_s += time.perf_counter() - t1
            if any(r["status"] != "SUCCESS" for r in res + rres):
                raise AssertionError(f"phase 15a: batch_put failed: {res[0]} {rres[0]}")
            done += n
        # QUORUM returned on two acks: the third replica's commits may be in flight
        t1 = time.perf_counter()
        _cluster_wait(lambda: all(_local_rows(c, shards) == done for c in cols), 300.0,
                      "every replica's commits", phase="15")
        settle_s = time.perf_counter() - t1
        cut = "" if done == rows else (f" (cut from {rows}: the import budget of "
                                       f"{budget_s:.0f} s ran out)")
        log(f"phase 15a replicated import [{smi}]: 3 nodes booted in {boot_s:.2f} s, both "
            f"collections through Raft in {raft_s:.2f} s; {done} rows{cut} through node-0's "
            f"batch_put at QUORUM, factor 3, in {cl_s:.1f} s ({done / cl_s:.0f} rows/s "
            f"acknowledged; the third copies in {settle_s:.2f} s more, "
            f"{done / (cl_s + settle_s):.0f} rows/s with all three); the one-node reference "
            f"took the same batches in {ref_s:.1f} s ({done / ref_s:.0f} rows/s)")

        # 15b: replicated reads through every node, from its local replica
        t_part = time.perf_counter()
        rng = np.random.default_rng([seed, 15])
        queries = near_queries(seed + 16, rng.integers(0, len(first), nq), lambda r: first[r])
        t1 = time.perf_counter()
        want = {False: _repl_answers(rcol, queries), True: _repl_answers(rcol, queries, where)}
        ref_q_s = time.perf_counter() - t1
        _set_selection([rcol], "fused")
        want["fused"] = _repl_answers(rcol, queries[:REPL_FUSED])
        _set_selection([rcol], "approx")
        got: dict = {}

        def reads():
            t = time.perf_counter()
            for i, c in enumerate(cols):
                got[(i, False)] = _repl_answers(c, queries)
                got[(i, True)] = _repl_answers(c, queries, where)
            spent = time.perf_counter() - t
            _set_selection(cols, "fused")
            try:
                for i, c in enumerate(cols):
                    got[(i, "fused")] = _repl_answers(c, queries[:REPL_FUSED])
            finally:
                _set_selection(cols, "approx")
            return spent

        with _remote_searches(nodes) as remote_calls:
            nodes_q_s = _node_run(K, counts, reads)
        read_counts = dict(counts)
        for i in range(3):
            for key in (False, True, "fused"):
                what = {False: "unfiltered", True: "filtered", "fused": "selection fused"}[key]
                _same_repl(got[(i, key)], want[key], f"15b {what} through node-{i}")
        if remote_calls:
            raise AssertionError(f"phase 15b: {len(remote_calls)} remote search RPCs: "
                                 f"{remote_calls[:3]}")
        if dev == "cuda":
            for kname in CLUSTER_KERNELS:
                if read_counts[kname] <= 0:
                    raise AssertionError(f"{kname} was not launched in phase 15b")
        node_bytes = {n.name: _store_bytes(c) for n, c in zip(nodes, cols)}
        live = {n.name: sum(len(c._load_shard(s).vector_indexes[""]) for s in shards)
                for n, c in zip(nodes, cols)}
        if any(v != done for v in live.values()) \
                or any(b < done * DIM * 4 for b in node_bytes.values()):
            raise AssertionError(f"phase 15b: a node does not hold the whole collection: "
                                 f"live rows {live}, store bytes {node_bytes}")
        per_q = 1e3 * nodes_q_s / (6 * nq)
        log(f"phase 15b replicated reads [{smi}]: nearVector k={CLUSTER_K} through each of the "
            f"3 nodes, {nq} unfiltered and {nq} under where(views >= {VIEWS_CUT}), then "
            f"{REPL_FUSED} under selection \"fused\": ids (tie-aware) and distances bit for "
            f"bit the one-node reference's; 0 remote search RPCs; {per_q:.2f} ms a query "
            f"through a node against {1e3 * ref_q_s / (2 * nq):.2f} on the reference; each "
            f"node holds the whole collection on the card: live rows {live}, store bytes "
            f"{node_bytes} (the ledger's {ledger.collection_bytes(name)} for all three); "
            f"launches {read_counts} ({time.perf_counter() - t_part:.1f} s)")

        # 15c: node-2 cut off; QUORUM acknowledged, ALL refused; heal and converge.
        # The nodes' background cycles (LSM flush and compaction after the
        # import) wait until the roots are equal, as in 14b; a cycle in
        # flight finishes first
        t_part = time.perf_counter()
        for n in nodes:
            paused.enter_context(n.db.cycles.pause())
        pause_s = time.perf_counter() - t_part
        faultline.isolate("node-2", name="repl-cut")
        # rows of their own (vectors too), past any row 15a drew
        part = _cluster_rows(seed + 16, REPL_PART_START, REPL_PART_ROWS, cent, 1601)
        extra = _uuid(1602, 0)
        try:
            with faultline.node_scope("node-0"):
                t1 = time.perf_counter()
                res = col.batch_put(part, consistency="QUORUM")
                part_s = time.perf_counter() - t1
                if any(r["status"] != "SUCCESS" for r in res):
                    raise AssertionError(f"phase 15c: a QUORUM write behind the cut was not "
                                         f"acknowledged: {res[0]}")
                try:
                    col.put_object({"category": "all", "views": 0}, vector=first[0],
                                   uuid=extra, consistency="ALL")
                except ConsistencyError as e:
                    all_err = str(e).split(":")[0]
                else:
                    raise AssertionError("phase 15c: a write at ALL was acknowledged with "
                                         "node-2 cut off")
                sample = part[::max(1, len(part) // REPL_READ_BACK)]
                t1 = time.perf_counter()
                for o in sample:
                    obj = col.get_object(o["uuid"], consistency="QUORUM")
                    if obj is None or obj.properties != o["properties"] \
                            or not np.array_equal(obj.vector, o["vector"]):
                        raise AssertionError(f"phase 15c: QUORUM read of {o['uuid']} "
                                             "behind the cut")
                quorum_read_ms = 1e3 * (time.perf_counter() - t1) / len(sample)
            behind = {n.name: _local_rows(c, shards) for n, c in zip(nodes, cols)}
        finally:
            faultline.heal("repl-cut")
        if behind != {"node-0": done + len(part), "node-1": done + len(part), "node-2": done}:
            raise AssertionError(f"phase 15c: rows a node behind the cut {behind}")
        if any(c._load_shard(col.sharding.shard_for(extra)).get_object(extra) is not None
               for c in cols):
            raise AssertionError("phase 15c: the write refused at ALL was committed")
        rres = rcol.batch_put(part)
        if any(r["status"] != "SUCCESS" for r in rres):
            raise AssertionError(f"phase 15c: the reference's batch_put failed: {rres[0]}")
        serve_s = _repl_serving(nodes, name, shards)
        beaters = [HashBeater(c, depth=REPL_DEPTH) for c in cols]

        def roots_equal() -> bool:
            with faultline.node_scope("node-0"):
                return all(beaters[0].roots_equal(s) for s in shards)

        rounds, applied, t1 = 0, 0, time.perf_counter()
        while not roots_equal():
            if rounds == REPL_MAX_ROUNDS:
                raise AssertionError(f"phase 15c: the roots differ after {rounds} hashbeat "
                                     "rounds")
            rounds += 1
            for n, b in zip(nodes, beaters):
                with faultline.node_scope(n.name):
                    applied += sum(b.beat_shard(s) for s in shards)
        conv_s = time.perf_counter() - t1
        paused.close()
        # one round more, every beat a no-op: the status registry reads it
        for n, b in zip(nodes, beaters):
            with faultline.node_scope(n.name):
                if sum(b.beat_shard(s) for s in shards):
                    raise AssertionError("phase 15c: a beat after convergence moved rows")
        rest = nodes[0].serve_rest()
        snap = Client(rest.address).request("GET", "/v1/debug/replication")
        mine = {s["shard"]: s for s in snap["shards"] if s["collection"] == name}
        if sorted(mine) != shards or any(s["state"] != "converged" or s["divergentEntries"]
                                         for s in mine.values()):
            raise AssertionError(f"phase 15c: /v1/debug/replication: {mine}")
        check_q = queries[:REPL_CHECK_Q]
        want_c = _repl_answers(rcol, check_q)
        got_c = _node_run(K, counts, lambda: [_repl_answers(cols[i], check_q) for i in (0, 2)])
        for i, g in zip((0, 2), got_c):
            _same_repl(g, want_c, f"15c through node-{i} after the heal")
        if got_c[0][0] != got_c[1][0]:
            raise AssertionError("phase 15c: node-2's ids differ from node-0's")
        if any(_local_rows(c, shards) != done + len(part) for c in cols):
            raise AssertionError("phase 15c: a node's rows after the heal")
        log(f"phase 15c partition and anti-entropy [{smi}]: node-2 cut off; {len(part)} rows at "
            f"QUORUM through node-0 acknowledged in {part_s:.2f} s; one put at ALL refused "
            f"({all_err}); {len(sample)} QUORUM get_object through node-0 read the "
            f"acknowledged rows ({quorum_read_ms:.2f} ms each); healed, every replica serving "
            f"after {serve_s:.2f} s; {rounds} hashbeat rounds on each node (tree depth "
            f"{REPL_DEPTH}) applied {applied} rows in {conv_s:.2f} s until every shard's "
            f"Merkle roots were equal; /v1/debug/replication: {len(mine)} shards converged, "
            f"{snap['totals']['rounds']} rounds; {REPL_CHECK_Q} nearVector through node-2 and "
            f"node-0 bit for bit the reference's ({time.perf_counter() - t_part:.1f} s, "
            f"{pause_s:.1f} s of it waiting for the nodes' cycles in flight)")

        # 15d: read repair of a newer version written to node-0's replica only
        t_part = time.perf_counter()
        u, v1 = _uuid(1600, 5), first[5]
        old_d = {r.uuid: r.distance for r in rcol.near_vector(
            v1, k=CLUSTER_K, include_objects=False)}[u]
        v2 = first[6]
        newer = StorageObject(uuid=u, properties={"category": "repaired", "views": 99},
                              last_update_time_ms=int(time.time() * 1000) + 5000)
        newer.vector = np.asarray(v2, np.float32)
        s_u = col.sharding.shard_for(u)
        cols[0]._load_shard(s_u).put_object_batch([newer])
        with faultline.node_scope("node-2"):
            t1 = time.perf_counter()
            obj = cols[2].get_object(u, consistency="ALL")
            repair_ms = 1e3 * (time.perf_counter() - t1)
        if obj is None or obj.properties["category"] != "repaired":
            raise AssertionError(f"phase 15d: the read at ALL through node-2 returned {obj}")
        if any(c._load_shard(s_u).get_object(u).properties["category"] != "repaired"
               for c in cols):
            raise AssertionError("phase 15d: a replica is still stale after the read repair")
        rcol.put_object({"category": "repaired", "views": 99}, vector=v2, uuid=u)
        want_d = _repl_answers(rcol, v1[None])
        got_d = _node_run(K, counts, lambda: [_repl_answers(c, v1[None]) for c in cols])
        for i, g in enumerate(got_d):
            _same_repl(g, want_d, f"15d through node-{i}")
            if any(x == _uid_int(u) and float(d) == old_d for x, d in zip(g[0][0], g[1][0])):
                raise AssertionError(f"phase 15d: node-{i} returned the old row's distance")
        slots = [len(c._load_shard(s_u).vector_indexes[""]) - c._load_shard(s_u).object_count()
                 for c in cols]
        if any(slots):
            raise AssertionError(f"phase 15d: live slots beyond the objects {slots}")
        log(f"phase 15d read repair [{smi}]: a newer version of one object on node-0's replica "
            f"only; get_object(consistency=\"ALL\") through node-2 returned it in "
            f"{repair_ms:.1f} ms and repaired node-1 and node-2; nearVector with the old vector "
            f"through each node bit for bit the reference's, none at the old row's distance "
            f"{old_d:.6f}, no extra live slot ({time.perf_counter() - t_part:.1f} s)")

        # 15e: the scaler, factor 1 -> 3 through node-0's update_collection
        t_part = time.perf_counter()
        scols = [n.get_collection(sname) for n in nodes]
        srcol = ref.get_collection(srname)
        scent = centers(seed + 17)
        sdone, sfirst = 0, None
        while sdone < scale_rows:
            n = min(IMPORT_BATCH, scale_rows - sdone)
            batch = _cluster_rows(seed + 17, sdone, n, scent, 1700)
            if sfirst is None:
                sfirst = np.stack([o["vector"] for o in batch])
            res = scols[0].batch_put(batch) + srcol.batch_put(batch)
            if any(r["status"] != "SUCCESS" for r in res):
                raise AssertionError(f"phase 15e: batch_put failed: {res[0]}")
            sdone += n
        held = {n.name: _local_rows(c, [s for s in shards if c._is_local(s)])
                for n, c in zip(nodes, scols)}
        cfg = copy.deepcopy(scols[0].config)
        cfg.replication.factor = 3
        t1 = time.perf_counter()
        _cluster_schema(lambda: nodes[0].update_collection(cfg),
                        lambda: nodes[0].get_collection(sname).config.replication.factor == 3,
                        "the scaler's update_collection", phase="15")
        scale_s = time.perf_counter() - t1
        _cluster_wait(lambda: all(c.config.replication.factor == 3 and all(
            len(c.sharding.nodes_for(s)) == 3 for s in shards) for c in scols), 20.0,
            "factor 3 on every node", phase="15",
            detail=lambda: _schema_state(nodes, scols, shards))
        placed_s = time.perf_counter() - t1
        copied = 2 * sdone  # each shard to the two nodes that lacked it
        if any(_local_rows(c, shards) != sdone for c in scols):
            raise AssertionError(f"phase 15e: rows a node after the scale "
                                 f"{[_local_rows(c, shards) for c in scols]}")
        squeries = near_queries(seed + 17, rng.integers(0, len(sfirst), REPL_CHECK_Q),
                                lambda r: sfirst[r])
        want_e = _repl_answers(srcol, squeries)
        with _remote_searches(nodes) as remote_calls:
            got_e = _node_run(K, counts, lambda: [_repl_answers(c, squeries) for c in scols])
        for i, g in enumerate(got_e):
            _same_repl(g, want_e, f"15e through node-{i} after the scale")
        if remote_calls:
            raise AssertionError(f"phase 15e: {len(remote_calls)} remote search RPCs")
        log(f"phase 15e scaler [{smi}]: a factor-1 collection of {sdone} rows (rows a node "
            f"{held}) scaled to 3 through node-0's update_collection in {scale_s:.2f} s "
            f"(the copies and two Raft commits; every node at factor 3 after "
            f"{placed_s:.2f} s): {copied} rows copied, {copied / scale_s:.0f} rows/s; "
            f"{REPL_CHECK_Q} nearVector through each node answered locally, bit for bit the "
            f"reference's ({time.perf_counter() - t_part:.1f} s); phase 15's launches through "
            f"the nodes {counts}")
        return counts
    finally:
        faultline.heal()
        paused.close()
        for n in nodes:
            n.close()
        if ref is not None:
            ref.close()
        shutil.rmtree(base, ignore_errors=True)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()


# -- phase 16: crash and chaos on the card ------------------------------------------

CRASH_PLANS = (("hnsw.snap.pre_replace", "kill"), ("hnsw.snap.post_replace", "kill"),
               ("wal.append.post_fsync", "kill"))
CHAOS_SCENARIOS = ("crash_during_2pc", "partition_plus_crash")
KILL_ROWS = 20_000          # 16c's rows in the default run
KILL_ONLY_ROWS = 100_000    # --chaos-only's
KILL_BATCH = 1000           # 16c's QUORUM batches through n0
KILL_QUERIES = 64           # 16c's nearVector through n2, unfiltered and filtered
KILL_FUSED = 16             # ... and under selection "fused"
KILL_MAX_ROUNDS = 8         # hashbeat rounds 16c may take to converge
KILL_ALL_READS = 512        # 16c's rows read through get_object at ALL, spread over the
                            # import (a read costs 6-13 ms of one host core; every row is
                            # held by digest on the three replicas)
KILL_RPC_S = 60.0           # per-attempt ceiling of a replica RPC in 16c
RANGE_QUERIES = 4           # 16d's range searches, the last one filtered
RANGE_WITHIN = (50, 400, 3000, 20_000)  # rows each query's threshold keeps (about)
RANGE_TOL = 1e-5            # 16d: a returned distance against the host's float32 one;
                            # rows this close to the threshold may fall either way
EPOCH_GET_ROWS = 70_000     # 16d: rows of the EpochStore read back
EPOCH_GET_EPOCH = 16_384
CHAOS_KERNELS = ("distance_block", "fused_topk_pairs", "fused_topk_scan")


def phase_crash(dev: str = "cuda") -> None:
    """16a: tools/crashtest_torch workers killed at three crashpoints, side
    by side, each store then reopened and verified with its HNSW index on
    ``dev``."""
    from tools.crashtest_torch.harness import POINT_PLANS, run_side_by_side

    base = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    cases = [(point, variant, dict(POINT_PLANS[point])[variant],
              os.path.join(base, f"{point}.{variant}")) for point, variant in CRASH_PLANS]
    for case in cases:
        os.makedirs(case[3])
    t = time.perf_counter()
    try:
        results = run_side_by_side(cases, device=dev)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    parts = []
    for res in results:
        if not (res.fired and res.ok and res.recovery_nonempty):
            raise AssertionError(f"phase 16a {res.point} {res.variant}: fired {res.fired} "
                                 f"(rc {res.worker_rc}), ok {res.ok}, lost {res.lost[:3]}, "
                                 f"phantom {res.phantom[:3]}")
        if not res.hnsw_device.startswith(dev):
            raise AssertionError(f"phase 16a {res.point}: the HNSW index reopened on "
                                 f"{res.hnsw_device}")
        parts.append(f"{res.point} ({res.variant}) fired, rc {res.worker_rc}, after "
                     f"{res.journaled_ops} acknowledged ops: 0 lost, 0 phantom, HNSW reopened "
                     f"on {res.hnsw_device}")
    log(f"phase 16a crash workers [{_smi_line() if dev == 'cuda' else dev}]: "
        + "; ".join(parts) + f" ({len(cases)} workers side by side, "
        f"{time.perf_counter() - t:.1f} s with the verifies)")


def phase_chaos_scenarios(dev: str = "cuda") -> None:
    """16b: two tools/clusterchaos_torch scenarios, every node's stores on
    ``dev``, the subprocess node's too."""
    from tools.clusterchaos_torch.harness import SCENARIOS, run_scenario

    parts = []
    for name in CHAOS_SCENARIOS:
        v = run_scenario(SCENARIOS[name], device=dev)
        want = len(SCENARIOS[name]["events"])
        bad = [i["name"] for i in v["invariants"] if not i["ok"]]
        if bad or len(v["events_fired"]) != want or not str(v["sub_device"]).startswith(dev):
            raise AssertionError(f"phase 16b {name}: invariants failed {bad} "
                                 f"{[i for i in v['invariants'] if not i['ok']]}, events "
                                 f"fired {len(v['events_fired'])} of {want}, the subprocess "
                                 f"node on {v['sub_device']}")
        st = v["stats"]
        parts.append(f"{name}: {len(v['invariants'])} invariants held, {want} of {want} events "
                     f"fired, {st['acked_writes']} of {st['writes']} writes acknowledged, "
                     f"{st['beat_rounds']} hashbeat rounds, subprocess node on "
                     f"{v['sub_device']} ({v['wall_s']} s)")
    log(f"phase 16b chaos scenarios [{_smi_line() if dev == 'cuda' else dev}]: "
        + "; ".join(parts))


def _shard_stores(col) -> dict:
    """Device bytes and live rows of each local shard's flat store (as
    tools/clusterchaos_torch/nodeproc reports them)."""
    out = {}
    for s, shard in sorted(col.shards.items()):
        st = shard.vector_indexes[""].store
        out[s] = {"bytes": sum(t.numel() * t.element_size()
                               for t in (st.vectors, st.valid, st.sq_norms)),
                  "live": len(shard.vector_indexes[""])}
    return out


def _replica_rows(cluster, cols, name: str, shards, vecs, props) -> str:
    """Every acknowledged row on every replica: its digest equal on the
    three (the agreement a read at ALL requires; one ``digests:bucket``
    call a shard and node) and its object, fetched in bulk from n0's and
    n2's replicas, as written. Returns what differs, or ""."""
    from weaviate_tpu_torch.cluster.transport import rpc
    from weaviate_tpu_torch.runtime import faultline
    from weaviate_tpu_torch.storage.objects import StorageObject

    buckets = list(range(1 << REPL_DEPTH))
    want = {_uuid(1800, i): i for i in range(len(vecs))}
    digests: dict = {}
    for node in ("n0", "n1", "n2"):
        got, raw = {}, {}
        for s in shards:
            if node == "n2":
                with faultline.node_scope("n0"):
                    ds = rpc(cluster.sub_addr, f"/replicas/{name}/{s}/digests:bucket",
                             {"depth": REPL_DEPTH, "buckets": buckets},
                             timeout=KILL_RPC_S)["digests"]
                us = [d["uuid"] for d in ds]
                for i in range(0, len(us), 2000):
                    with faultline.node_scope("n0"):
                        out = rpc(cluster.sub_addr, f"/replicas/{name}/{s}/objects:fetch",
                                  {"uuids": us[i:i + 2000]}, timeout=KILL_RPC_S)["objects"]
                    raw.update(zip(us[i:i + 2000], out))
            else:
                shard = cols[int(node[1])]._load_shard(s)
                ds = shard.bucket_digests(REPL_DEPTH, buckets)
                if node == "n0":
                    raw.update((d["uuid"], shard.objects.get(d["uuid"].encode())) for d in ds)
            got.update({d["uuid"]: (d["mtime"], d["deleted"], bytes(d["hash"])) for d in ds})
        live = {u for u, d in got.items() if not d[1]}
        if live != set(want):
            return (f"{node} holds {len(live)} live rows, {len(set(want) - live)} acknowledged "
                    f"missing, {len(live - set(want))} unknown")
        for u, r in raw.items():
            obj = StorageObject.from_bytes(r)
            i = want[u]
            if obj.properties != props[i] or not np.array_equal(obj.vector, vecs[i]):
                return f"{node}'s object {u} differs from the row written"
        digests[node] = got
    for node in ("n1", "n2"):
        if digests[node] != digests["n0"]:
            return f"{node}'s digests differ from n0's"
    return ""


def _sub_answers(cluster, name: str, queries, where=None, selection=None) -> tuple:
    """nearVector k 100 through the subprocess node's own Collection."""
    from weaviate_tpu_torch.cluster.transport import rpc
    from weaviate_tpu_torch.runtime import faultline

    with faultline.node_scope(faultline.OBSERVER):
        out = rpc(cluster.sub_addr, "/chaos/near_vector",
                  {"collection": name, "vectors": np.asarray(queries, np.float32),
                   "k": CLUSTER_K, "where": where, "selection": selection}, timeout=600.0)
    if out["remote_searches"]:
        raise AssertionError(f"phase 16c: {out['remote_searches']} remote search RPCs "
                             "through n2")
    return [[_uid_int(u) for u in r] for r in out["uuids"]], out["distances"]


def phase_kill(torch, K, seed: int, rows: int, dev: str = "cuda") -> dict:
    """16c: a Performance768D1M collection (768-d cosine flat, factor 3) on
    three nodes, n2 a subprocess on the card; n2 SIGKILLed midway through a
    QUORUM import through n0, restarted, converged and queried."""
    from weaviate_tpu_torch.cluster.transport import RpcError, rpc
    from weaviate_tpu_torch.filters import Filter, Operator
    from weaviate_tpu_torch.replication import HashBeater
    from weaviate_tpu_torch.runtime import faultline

    from tools.clusterchaos_torch.workload import ChaosCluster

    smi = _smi_line() if dev == "cuda" else "cpu"
    base = tempfile.mkdtemp(prefix="chip_smoke_kill_")
    name = "Kill768"
    counts: dict = dict.fromkeys(K.launch_counts, 0)
    cluster = None
    try:
        t0 = time.perf_counter()
        cluster = ChaosCluster(base, subprocess_node="n2", remote_timeout=KILL_RPC_S,
                               gossip_interval=0.1, election_timeout=(0.3, 0.6),
                               dead_after=5.0, device=dev)
        nodes = [cluster.nodes[n] for n in cluster.inproc_names()]
        for n in nodes:
            # the phase drives the hashbeat rounds itself, as phase 15 does
            for cycle in ("hashbeat", "driftwatch"):
                n.db.cycles.unregister(cycle)
        cluster.wait_members()
        _cluster_schema(lambda: nodes[0].create_collection(_repl_config(name, 3)),
                        lambda: name in nodes[0].db.collections,
                        f"create_collection {name}", phase="16")
        _cluster_wait(lambda: all(name in n.db.collections for n in nodes)
                      and name in cluster.sub_status()["collections"], 30.0,
                      f"{name} on every node", phase="16")
        boot_s = time.perf_counter() - t0
        cols = [n.get_collection(name) for n in nodes]
        shards = sorted(cols[0].sharding.shard_names)
        if any(sorted(cols[0].sharding.nodes_for(s)) != ["n0", "n1", "n2"] for s in shards):
            raise AssertionError("phase 16c: a shard is not placed on all three nodes")

        # the import at QUORUM through n0; n2 SIGKILLed at the midpoint
        cent = centers(seed + 18)
        vecs = np.empty((rows, DIM), np.float32)
        props: list = []
        kill_at, kill_rc, t1 = None, None, time.perf_counter()
        for start in range(0, rows, KILL_BATCH):
            if kill_at is None and start >= rows // 2:
                cluster.kill_sub()
                kill_at, kill_rc = start, cluster.sub_proc.returncode
            batch = _cluster_rows(seed + 18, start, min(KILL_BATCH, rows - start), cent, 1800)
            res = cols[0].batch_put(batch, consistency="QUORUM")
            bad = [r for r in res if r["status"] != "SUCCESS"]
            if bad:
                raise AssertionError(f"phase 16c: {len(bad)} rows of the batch at {start} not "
                                     f"acknowledged at QUORUM: {bad[0]}")
            for i, o in enumerate(batch):
                vecs[start + i] = o["vector"]
                props.append(o["properties"])
        import_s = time.perf_counter() - t1
        if kill_rc != -9:
            raise AssertionError(f"phase 16c: n2 exited {kill_rc} at the kill, not SIGKILL")

        # restart n2 on its data directory; each shard rebuilds its device
        # store from the LSM when it is first opened (the digest probes)
        t1 = time.perf_counter()
        cluster.restart_sub()
        ready_s = time.perf_counter() - t1
        cluster.wait_members(timeout=30.0)
        pending, last = set(shards), None
        while pending and time.perf_counter() - t1 < 120.0:
            for s in sorted(pending):
                try:
                    with faultline.node_scope("n0"):
                        rpc(cluster.sub_addr, f"/replicas/{name}/{s}/digest",
                            {"uuid": _uuid(1800, 0)}, timeout=KILL_RPC_S)
                    pending.discard(s)
                except RpcError as e:
                    last = e
            if pending:
                time.sleep(0.1)
        if pending:
            raise AssertionError(f"phase 16c: n2's shards {sorted(pending)} not serving after "
                                 f"the restart: {last}")
        serve_s = time.perf_counter() - t1
        status = cluster.sub_status()
        rebuilt = [r for r in status["rebuilds"] if r["collection"] == name]
        if sorted(r["shard"] for r in rebuilt) != shards or not str(status["device"]).startswith(dev):
            raise AssertionError(f"phase 16c: n2 rebuilt {rebuilt} on {status['device']}")
        rebuild_s = sum(r["seconds"] for r in rebuilt)
        rebuild_rows = sum(r["rows"] for r in rebuilt)

        # hashbeat rounds from n0 and n1 until every shard's roots are equal
        beaters = [HashBeater(c, depth=REPL_DEPTH) for c in cols]

        def roots_equal() -> bool:
            with faultline.node_scope("n0"):
                return all(beaters[0].roots_equal(s) for s in shards)

        rounds, applied, t2 = 0, 0, time.perf_counter()
        while not roots_equal():
            if rounds == KILL_MAX_ROUNDS:
                raise AssertionError(f"phase 16c: the roots differ after {rounds} rounds")
            rounds += 1
            for n, b in zip(nodes, beaters):
                with faultline.node_scope(n.name):
                    applied += sum(b.beat_shard(s) for s in shards)
        conv_s = time.perf_counter() - t2
        roots_s = time.perf_counter() - t1

        # every acknowledged row: its digest equal on the three replicas and
        # its object as written on n0 and n2; KILL_ALL_READS of them read
        # through get_object at ALL
        t2 = time.perf_counter()
        wrong = _replica_rows(cluster, cols, name, shards, vecs, props)
        if wrong:
            raise AssertionError(f"phase 16c: after convergence {wrong}")
        bulk_s = time.perf_counter() - t2
        t2 = time.perf_counter()
        sample = np.linspace(0, rows - 1, KILL_ALL_READS).astype(int)
        for i in sample:
            with faultline.node_scope("n0"):
                obj = cols[0].get_object(_uuid(1800, i), consistency="ALL")
            if obj is None or obj.properties != props[i] \
                    or not np.array_equal(obj.vector, vecs[i]):
                raise AssertionError(f"phase 16c: row {i} does not read back at ALL: {obj}")
        all_ms = 1e3 * (time.perf_counter() - t2) / len(sample)

        # n2's flat stores equal n0's, shard for shard
        mine = _shard_stores(cols[0])
        theirs = cluster.sub_status()["stores"].get(name)
        if theirs != mine or any(v["live"] != len(cols[0]._load_shard(s).vector_indexes[""])
                                 for s, v in mine.items()) \
                or sum(v["live"] for v in mine.values()) != rows:
            raise AssertionError(f"phase 16c: n2's stores {theirs} against n0's {mine}")

        # nearVector through n2, served from its local replica, against n0's
        # local answers bit for bit
        rng = np.random.default_rng([seed, 16])
        queries = near_queries(seed + 18, rng.integers(0, rows, KILL_QUERIES), lambda r: vecs[r])
        where = Filter.where("views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT)

        def local():
            out = {False: _repl_answers(cols[0], queries),
                   True: _repl_answers(cols[0], queries, where)}
            _set_selection(cols[:1], "fused")
            try:
                out["fused"] = _repl_answers(cols[0], queries[:KILL_FUSED])
            finally:
                _set_selection(cols[:1], "approx")
            return out

        with _remote_searches(nodes) as remote_calls:
            want = _node_run(K, counts, local)
        if remote_calls:
            raise AssertionError(f"phase 16c: {len(remote_calls)} remote search RPCs via n0")
        before = cluster.sub_status()["launches"]
        t2 = time.perf_counter()
        got = {False: _sub_answers(cluster, name, queries),
               True: _sub_answers(cluster, name, queries,
                                  ["views", Operator.GREATER_THAN_EQUAL, VIEWS_CUT]),
               "fused": _sub_answers(cluster, name, queries[:KILL_FUSED], selection="fused")}
        q_s = time.perf_counter() - t2
        after = cluster.sub_status()["launches"]
        sub_launches = {k: after[k] - before[k] for k in after}
        for key, what in ((False, "unfiltered"), (True, "filtered"), ("fused", "selection fused")):
            _same_repl(got[key], want[key], f"16c {what} through n2 against n0", phase="16")
        if dev == "cuda":
            missing = [k for k in CHAOS_KERNELS if sub_launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase 16c: {missing} not launched inside n2: "
                                     f"{sub_launches}")
        n0_launches = {k: v for k, v in counts.items() if v}
        for k, v in sub_launches.items():
            counts[k] += v
        log(f"phase 16c kill and restart [{smi}]: 3 nodes (n2 a subprocess on "
            f"{status['device']}) up with a factor-3 {DIM}-d {METRIC} collection in "
            f"{boot_s:.2f} s; {rows} rows through n0's batch_put at QUORUM in {import_s:.2f} s "
            f"({rows / import_s:.0f} rows/s acknowledged across the kill), n2 SIGKILLed (rc "
            f"{kill_rc}) at row {kill_at}; restarted and answering in {ready_s:.2f} s, its "
            f"{len(rebuilt)} shards rebuilt their device stores from the LSM ({rebuild_rows} "
            f"rows) in {rebuild_s:.3f} s, every shard serving {serve_s:.2f} s after the "
            f"restart; {rounds} hashbeat rounds applied {applied} rows in {conv_s:.2f} s, "
            f"roots equal {roots_s:.2f} s after the restart; every acknowledged row's digest "
            f"equal on the three replicas and its object as written on n0 and n2 "
            f"({bulk_s:.2f} s), {len(sample)} of them, spread over the import, read back "
            f"through get_object at ALL ({all_ms:.2f} ms each); n2's store bytes equal "
            f"n0's shard for shard ({sum(v['bytes'] for v in mine.values())} bytes); "
            f"{KILL_QUERIES} unfiltered, {KILL_QUERIES} filtered and {KILL_FUSED} fused "
            f"nearVector k={CLUSTER_K} through n2 bit for bit n0's local answers, 0 remote "
            f"search RPCs, {1e3 * q_s / (2 * KILL_QUERIES + KILL_FUSED):.2f} ms a query; "
            f"launches through n0 {n0_launches}, inside n2 "
            f"{ {k: v for k, v in sub_launches.items() if v} }")
        return counts
    finally:
        if cluster is not None:
            cluster.close()
        faultline.heal()
        shutil.rmtree(base, ignore_errors=True)
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()


def phase_chaos(torch, K, seed: int, rows: int, dev: str = "cuda") -> dict:
    """16b and 16c, alone (their elections and kills are timed): the two
    scenarios, then the kill."""
    timed("16b", phase_chaos_scenarios, dev)
    return timed("16c", phase_kill, torch, K, seed, rows, dev)


def _range_threshold(d: np.ndarray, want: int) -> float:
    """A threshold near the ``want``-th smallest of ``d``, in the middle of
    the widest gap among the 32 around it."""
    s = np.sort(d)
    lo, hi = max(want - 16, 1), min(want + 16, len(s) - 1)
    at = lo + int(np.argmax(s[lo:hi] - s[lo - 1:hi - 1]))
    return float((s[at] + s[at - 1]) / 2)


def phase_range_get(torch, K, seed: int, st3: dict, dev: str = "cuda") -> dict:
    """16d: FlatIndex.search_by_vector_distance on phase 3's index against
    the host's recomputation of every row within the threshold, under both
    selections; EpochStore.get on flat epochs against the rows written."""
    from weaviate_tpu_torch.engine.epochs import EpochStore

    idx, corpus, deleted = st3["idx"], st3["corpus"], st3["deleted"]
    rows = len(corpus)
    live = np.ones(rows, bool)
    live[deleted] = False
    rng = np.random.default_rng([seed, 16, 4])
    allow = np.nonzero(rng.random(rows) < 0.5)[0]
    allowed = np.zeros(rows, bool)
    allowed[allow] = True
    counts: dict = dict.fromkeys(K.launch_counts, 0)
    parts = []
    queries = near_queries(seed + 19, rng.integers(0, rows, RANGE_QUERIES),
                           lambda r: corpus[r], noise=NEAR_NOISE)
    # the host's recomputation: cosine distance of every row to each query
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    norms = np.sqrt(np.einsum("ij,ij->i", corpus, corpus))
    host = 1.0 - (corpus @ qn.T) / norms[:, None]
    for qi, (q, want) in enumerate(zip(queries, RANGE_WITHIN)):
        filtered = qi == RANGE_QUERIES - 1
        keep = live & allowed if filtered else live
        d = host[:, qi]
        thr = _range_threshold(d[keep], want)
        inside = np.nonzero(keep & (d <= thr - RANGE_TOL))[0]
        outside = keep & (d > thr + RANGE_TOL)
        band = int(np.count_nonzero(keep & (np.abs(d - thr) <= RANGE_TOL)))
        for selection in ("approx", "fused"):
            idx.store.selection = selection
            K.reset_launch_counts()
            t = time.perf_counter()
            try:
                ids, dists = idx.search_by_vector_distance(q, thr, allow if filtered else None)
            finally:
                idx.store.selection = "approx"
            ms = 1e3 * (time.perf_counter() - t)
            for k, v in K.launch_counts.items():
                counts[k] += v
            missing = np.setdiff1d(inside, ids)
            extra = ids[outside[ids] | ~keep[ids]]
            if len(missing) or len(extra):
                raise AssertionError(
                    f"phase 16d query {qi} ({selection}): {len(ids)} rows within {thr:.6f}; "
                    f"{len(missing)} the host finds are missing, {len(extra)} are past the "
                    f"threshold or not allowed")
            err = float(np.max(np.abs(dists - d[ids]))) if len(ids) else 0.0
            if err > RANGE_TOL or np.any(np.diff(dists) < 0):
                raise AssertionError(f"phase 16d query {qi} ({selection}): distances off the "
                                     f"host's by {err:.2e}, or not ascending")
            parts.append(f"{len(ids)} rows{' (filtered)' if filtered else ''} {selection} "
                         f"{ms:.1f} ms (max err {err:.1e}, {band} within {RANGE_TOL} of the "
                         "threshold)")
    if dev == "cuda":
        missing = [k for k in CHAOS_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"phase 16d: {missing} not launched: {counts}")
    # EpochStore.get on flat epochs (l2: rows are stored as written)
    es = EpochStore(DIM, epoch_rows=EPOCH_GET_EPOCH, device=dev)
    es.add(corpus[:EPOCH_GET_ROWS])
    dead = rng.choice(EPOCH_GET_ROWS, 2000, replace=False)
    es.delete(dead)
    es.compact()
    pick = rng.choice(np.setdiff1d(np.arange(EPOCH_GET_ROWS), dead), 4096, replace=False)
    t = time.perf_counter()
    got = es.get(pick)
    get_ms = 1e3 * (time.perf_counter() - t)
    if not np.array_equal(got, corpus[pick]):
        raise AssertionError("phase 16d: EpochStore.get differs from the rows written")
    n_epochs = len(es.epochs)
    del es
    log(f"phase 16d range search and row fetch [{_smi_line() if dev == 'cuda' else dev}]: "
        f"FlatIndex.search_by_vector_distance on phase 3's {rows} x {DIM} {METRIC} index "
        f"({len(deleted)} deleted), {RANGE_QUERIES} queries each under selection approx and "
        f"fused, every row within the threshold as the host's float32 recomputation finds "
        f"them and no row past it, distances within {RANGE_TOL}: " + "; ".join(parts)
        + f"; launches {counts}; EpochStore.get of {len(pick)} rows across {n_epochs} flat "
        f"epochs ({EPOCH_GET_EPOCH} rows each, after 2000 deletes and a compaction) equal to "
        f"the rows written in {get_ms:.1f} ms")
    return counts


def range_index(torch, seed: int, rows: int) -> dict:
    """--chaos-only's stand-in for phase 3's index: the same rows and
    deletes, without phase 3's queries."""
    from weaviate_tpu_torch.engine.flat import FlatIndex

    rng = np.random.default_rng([seed, 3])
    idx = FlatIndex(dim=DIM, metric=METRIC, chunk_size=CHUNK, device="cuda")
    corpus = np.empty((rows, DIM), dtype=np.float32)
    for s in range(0, rows, ADD_BATCH):
        v = corpus_batch(seed, s, min(ADD_BATCH, rows - s))
        corpus[s:s + len(v)] = v
        idx.add_batch(np.arange(s, s + len(v)), v)
    deleted = rng.choice(rows, 10_000, replace=False)
    idx.delete(*deleted.tolist())
    return dict(idx=idx, corpus=corpus, deleted=deleted)


# -- phases 11 and 12 in a second process -----------------------------------------

LANE_TAG = "lane result: "  # the second process's closing line, before its JSON
LANE_TIMEOUT_S = 1500.0     # past the script's own limit: a hang fails the run


def start_lane(seed: int, ann_rows: int, rows: int, out_dir: str):
    """Start phases 11 and 12 in a second process on the same card (the
    hidden ``--lane`` mode), its standard output into ``out_dir`` and its
    standard error beside this one's. The kernels and the native host
    library load from the build directory phase 1 filled. Returns the
    process and the path of its output."""
    path = os.path.join(out_dir, "lane.log")
    here = os.path.abspath(__file__)
    with open(path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, here, "--lane", "--seed", str(seed), "--ann-rows", str(ann_rows),
             "--rows", str(rows)], stdout=out, cwd=os.path.dirname(here))
    return proc, path


def join_lane(proc, path: str, t_start: float) -> tuple[dict, dict]:
    """Wait for ``start_lane``'s process, print its lines and return the
    launches of phases 11 and 12; its phase seconds join PHASE_SECONDS.
    A non-zero exit or a missing result fails the run."""
    try:
        rc = proc.wait(timeout=max(1.0, LANE_TIMEOUT_S - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    result = None
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith(LANE_TAG):
                result = json.loads(line[len(LANE_TAG):])
            else:
                log(line)
    log(f"phases 11 and 12: a second process on the same card, beside phases 3 to 8 of "
        f"the first, from the end of phase 2 for {time.perf_counter() - t_start:.1f} s "
        f"(exit {rc})")
    if rc is None:
        raise AssertionError(f"phases 11 and 12: the second process did not end within "
                             f"{LANE_TIMEOUT_S:.0f} s and was stopped")
    if rc != 0 or result is None:
        raise AssertionError("phases 11 and 12 failed in the second process "
                             f"(exit {rc}; its traceback is on standard error)")
    PHASE_SECONDS.update(result["seconds"])
    return result["11"], result["12"]


def run_lane(torch, K, seed: int, ann_rows: int, rows: int) -> None:
    """The second process: phases 11 and 12, then LANE_TAG and a JSON
    object of their launches and seconds."""
    counts11 = timed("11", phase_ann, torch, K, seed, ann_rows)
    gc.collect()
    torch.cuda.empty_cache()
    counts12 = timed("12", phase_mesh, torch, K, seed, rows)
    print(LANE_TAG + json.dumps({"11": counts11, "12": counts12, "seconds": PHASE_SECONDS}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None,
                    help="corpus rows (default: the 1M of Performance768D1M; "
                    f"--replication-only: {REPL_ONLY_ROWS:,})")
    ap.add_argument("--hybrid-docs", type=int, default=FIQA_DOCS,
                    help="phase 7's documents (default: FiQA-2018's 57,638)")
    ap.add_argument("--topk-times", action="store_true",
                    help="only build the kernels and time fused_topk_scan and "
                    "fused_topk_pairs at the drain shapes (no checks, no result line)")
    ap.add_argument("--bq-times", action="store_true",
                    help="only build the kernels, hold bq_scan_reduce to its plain version "
                    "(ragged shapes, the 1M-row shape, the prefix), time it at B = 1, 8, 64, "
                    "256 and on the prefix beside the _int_mm yardstick, and run the "
                    "single-bit wgmma probe (no result line)")
    ap.add_argument("--block-times", action="store_true",
                    help="only build the kernels, hold bq_mxu_block, pq4_recon_block, "
                    "pq4_lut_block and bm25_block to their plain versions, time them at the "
                    "main and dispatch shapes (the first two beside their product "
                    "yardsticks) and print the fused hybrid dispatch's split on a synthetic "
                    "index (no result line)")
    ap.add_argument("--dist-times", action="store_true",
                    help="only build the kernels and time distance_block, "
                    "pq4_scan_reduce and one approx batch (no checks, no result line)")
    ap.add_argument("--import-times", action="store_true",
                    help="only build the kernels and the native host library, then time "
                    "the FiQA-sized text import and a vector batch_put of --import-rows rows "
                    "with the library, without it (WEAVIATE_TPU_NO_NATIVE=1, a child "
                    "process) and with it again (no result line)")
    ap.add_argument("--import-rows", type=int, default=IMPORT_ROWS,
                    help="--import-times' vector rows (default 100,000)")
    ap.add_argument("--ann-rows", type=int, default=ANN_ROWS,
                    help="phase 11's corpus rows (default: SIFT1M's 1,000,000)")
    ap.add_argument("--ann-only", action="store_true",
                    help="only phases 0, 1 and 11 (the ANN indexes), a rehearsal of phase "
                    "11 (no result line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only phases 0, 1 and 12 (row-sharded serving over a mesh), a "
                    "rehearsal of phase 12 (no result line)")
    ap.add_argument("--tenants-only", action="store_true",
                    help=f"only phases 0, 1 and 13 (multi-tenancy and the device-time "
                    f"plane) at {TENANTS_ONLY} tenants (no result line)")
    ap.add_argument("--cluster-only", action="store_true",
                    help="only phases 0, 1 and 14 (the cluster) at --rows rows, no import "
                    f"budget, and sealed epochs of {CLUSTER_EPOCH_ONLY_ROWS:,} rows (no result "
                    "line)")
    ap.add_argument("--replication-only", action="store_true",
                    help="only phases 0, 1 and 15 (replication) at --rows rows (default "
                    f"{REPL_ONLY_ROWS:,}), no import "
                    f"budget, and a scaled collection of {REPL_SCALE_ONLY_ROWS:,} rows (no "
                    "result line)")
    ap.add_argument("--chaos-only", action="store_true",
                    help=f"only phases 0, 1 and 16 (crash and chaos on the card), 16c at "
                    f"{KILL_ONLY_ROWS:,} rows and 16d on an index of --rows rows of its own "
                    "(no result line)")
    ap.add_argument("--import-run", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--lane", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rows is None:
        args.rows = REPL_ONLY_ROWS if args.replication_only else ROWS
    if args.import_run:  # --import-times' child: one import run, its JSON line
        import torch

        print(json.dumps(import_run(torch, args.seed, args.hybrid_docs, args.rows)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; it needs an NVIDIA card",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    from weaviate_tpu_torch.ops import kernels as K

    from weaviate_tpu_torch.db import Database

    if args.lane:  # the default run's second process: phases 11 and 12
        run_lane(torch, K, args.seed, args.ann_rows, args.rows)
        return 0
    t0 = time.perf_counter()
    device = phase_card(torch)
    special = (args.topk_times or args.bq_times or args.block_times or args.dist_times
               or args.ann_only or args.mesh_only or args.import_times or args.cluster_only
               or args.replication_only or args.chaos_only)
    warm_up = None if special else profiler_warm_up()  # beside the build
    phase_build(K)
    if args.topk_times:
        X = scan_corpus(torch, args.seed)
        rng = np.random.default_rng([args.seed, 2])
        vmask = torch.from_numpy(rng.random(X.shape[0]) > 0.01).to("cuda")
        qs = torch.from_numpy(near_queries(args.seed, rng.integers(0, ROWS, BATCH), lambda r: X[
            torch.from_numpy(r).to("cuda")].cpu().numpy())).to("cuda")
        for part in topk_times(torch, K, X, vmask, qs, Timer(torch)):
            log(f"topk times: {part}")
        if hasattr(K, "kernel_residency"):  # the product-only build is this design's
            for part in scan_breakdown(torch, K, X, qs, Timer(torch)):
                log(f"topk times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.bq_times:
        # random words: the kernel's time does not follow the values
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        xw = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 20, 24), dtype=torch.int32,
                           device="cuda", generator=gen)
        qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (BATCH, 24), dtype=torch.int32,
                           device="cuda", generator=gen)
        vmask = torch.rand(1 << 20, device="cuda", generator=gen) > 0.01
        rng = np.random.default_rng([args.seed, 2])
        L = 64
        _same_scan(torch, K.bq_scan_reduce(qw, xw, vmask, L), K.bq_scan_reduce_plain(qw, xw, vmask, L),
                   "bq_scan_reduce main shape")
        pt = xw[:, :4].T.contiguous()
        _same_scan(torch, K.bq_scan_reduce(qw[:, :4].contiguous(), pt, vmask, L, transposed=True),
                   K.bq_scan_reduce_plain(qw[:, :4].contiguous(), pt, vmask, L, transposed=True),
                   "bq_scan_reduce prefix")
        del pt
        log(f"bq times: equal to the plain version at {bq_ragged_checks(torch, K, rng, 'cuda')} "
            "ragged shapes, the main shape and the prefix")
        for part in bq_times(torch, K, qw, xw, vmask, Timer(torch)) + bq_probe(torch):
            log(f"bq times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.block_times:
        for part in block_times(torch, K, args.seed, Timer(torch)):
            log(f"block times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.dist_times:
        for part in dist_times(torch, K, args.seed, Timer(torch)):
            log(f"dist times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    if args.ann_only:
        phase_ann(torch, K, args.seed, args.ann_rows)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.mesh_only:
        phase_mesh(torch, K, args.seed, args.rows)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.tenants_only:
        phase_tenants(torch, K, args.seed, TENANTS_ONLY, warm_up=warm_up)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.cluster_only:
        phase_cluster(torch, K, args.seed, args.rows, float("inf"),
                      CLUSTER_EPOCH_ONLY_ROWS, CLUSTER_ONLY_QUERIES)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.replication_only:
        phase_replication(torch, K, args.seed, args.rows, float("inf"),
                          REPL_SCALE_ONLY_ROWS, REPL_ONLY_QUERIES)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.chaos_only:
        timed("16a", phase_crash)
        counts = phase_chaos(torch, K, args.seed, KILL_ONLY_ROWS)
        log(f"phase 16 launches (16c through the nodes): {counts}")
        st = timed("16d index", range_index, torch, args.seed, args.rows)
        timed("16d", phase_range_get, torch, K, args.seed, st)
        del st
        log("phase seconds: "
            + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if args.import_times:
        for part in import_times(torch, args.seed, args.hybrid_docs, args.import_rows):
            log(f"import times: {part}")
        log(f"card after (SM clock, max SM clock, power, temperature): {card_clocks()}")
        return 0
    numbers, counts2 = timed("2", phase_kernels, torch, K, args.seed)
    log(f"card after phase 2 (SM clock, max SM clock, power, temperature): {card_clocks()}")
    # phases 11 and 12 run in a second process from here to phase 8's end
    lane_dir = tempfile.mkdtemp(prefix="chip_smoke_lane_")
    t_lane = time.perf_counter()
    lane, lane_log = start_lane(args.seed, args.ann_rows, args.rows, lane_dir)
    try:
        st3 = timed("3", phase_index, torch, args.seed, args.rows)
        counts10 = timed("10", phase_epochs, torch, K, args.seed, args.rows, st3)
        counts16d = timed("16d", phase_range_get, torch, K, args.seed, st3)
        del st3
        gc.collect()
        torch.cuda.empty_cache()
        timed("10 merge shapes", merge_times, torch, K)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        db = srv = None
        try:
            db = Database(tmp, device="cuda")
            # each path counts its own launches: phase 4 the plain one, phase 5
            # the quantized index, phase 6 the quantized collections, phase 7
            # hybrid, phase 9a/9b the server's socket runs and 9c the native
            # plane's (the server serves phase 4's database from here on; 9a
            # and 9c run before phase 6 compresses its collection), phase 10
            # (above) the epoch stores
            counts4, st4 = timed("4", phase_end_to_end, torch, K, args.seed, args.rows, db)
            srv = start_server(db)
            counts9a, st9a = timed("9a", phase_server_plain, torch, K, args.seed, srv, st4)
            counts9c = (timed("9c", phase_server_plane, torch, K, srv, st4, st9a)
                        if srv.grpc is not None else dict.fromkeys(K.launch_counts, 0))
            counts5 = timed("5", phase_quantized_index, torch, K, args.seed, args.rows)
            counts6 = timed("6", phase_quantized_end_to_end, torch, K, args.seed, db, st4)
            counts7, st7 = timed("7", phase_hybrid, torch, K, args.seed, db, args.hybrid_docs)
            counts9b = timed("9b", phase_server_rest, torch, K, args.seed, srv, db, st7,
                             args.rows)
        finally:
            if srv is not None:
                srv.stop()
            if db is not None:
                db.close()
            shutil.rmtree(tmp, ignore_errors=True)
        counts8 = timed("8", phase_conformance, K)
        # 16a times no election: its crash workers run while this process
        # waits for the second one
        timed("16a", phase_crash)
        counts11, counts12 = join_lane(lane, lane_log, t_lane)
    finally:
        if lane.poll() is None:  # this process failed first: stop the second
            lane.kill()
            lane.wait()
        shutil.rmtree(lane_dir, ignore_errors=True)
    _CORPUS_BATCHES.clear()  # no phase after 5 reads the corpus
    gc.collect()
    torch.cuda.empty_cache()
    counts13 = timed("13", phase_tenants, torch, K, args.seed, TENANTS, warm_up=warm_up)
    counts14 = timed("14", phase_cluster, torch, K, args.seed, args.rows, CLUSTER_BUDGET_S,
                     CLUSTER_EPOCH_ROWS)
    counts15 = timed("15", phase_replication, torch, K, args.seed, args.rows, REPL_BUDGET_S,
                     REPL_SCALE_ROWS)
    counts16 = phase_chaos(torch, K, args.seed, KILL_ROWS)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        # launches over the main paths: phases 4, 5, 6, 7, 8, the server's
        # 9a, 9b and 9c, the epochs' 10, the ANN indexes' 11, the mesh's 12,
        # the tenants' 13, the cluster's 14, replication's 15 and phase 16's
        # range search (16d) and restarted node (16c, inside n2 too), and
        # phase 2's window for the two kernels that no path runs
        launches = sum(c[name] for c in (counts4, counts5, counts6, counts7, counts8,
                                         counts9a, counts9b, counts9c, counts10, counts11,
                                         counts12, counts13, counts14, counts15, counts16,
                                         counts16d))
        if name in PHASE2_PATH:
            launches += counts2[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches, **numbers[name]))
    log("phase seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke.py: FAILED", file=sys.stderr)
        sys.exit(1)
