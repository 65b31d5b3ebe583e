#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py               # everything, as the chip check runs it
    python3 chip_smoke.py --skip-main   # device, build and kernel parity only
    python3 chip_smoke.py --ab OLD_TREE # K1-K6 of an older checkout vs this one
    python3 chip_smoke.py --k1-variants A=CSRC_DIR B=CSRC_DIR  # K1 builds
    python3 chip_smoke.py --k2-variants A=CSRC_DIR B=CSRC_DIR  # K2, K4
    python3 chip_smoke.py --k6-variants A=CSRC_DIR B=CSRC_DIR  # K6

Phases, one JSON line each:

1. device — the card's name and power limit as nvidia-smi prints them;
   then ``health``: ``obs.health.probe()``, a bounded child process that
   runs a small matmul on the card (healthy within ``MAX_TIMEOUT``);
2. build — every kernel source under ``raft_tpu_torch/ops/csrc`` compiled
   with nvcc, one process per source, all at once; then (``ptxas``) each
   kernel's registers, stack frame and spill bytes from the build log;
3. parity — each kernel against its plain twin on the card: K1 (strip
   scan; main-path shapes at dim 128, int8 lists, w ∈ {1024, 2048, 4096},
   kf ∈ {10, 20, 40}, a multi-sub-block class, padding strips and dead
   sub-blocks, ±inf/NaN bias lanes, fp32, bf16 and uint8 lists, kf = 512,
   and the selection's cases: scores ordered ascending, descending (every
   key passes the threshold, the queue overflows on every tile) and tied,
   kf 1 / 31 / 129 / 512, dead sub-blocks, bit for bit);
   K2 (packed 1-bit scan; rot_dim 128 at w 1024–4096 × kf 40/80/320, 2-
   and 4-bit codes, dead sub-blocks, ±inf/NaN bias, the tournament at kf
   20, kf 512, rot_dim 40, the selection's cases); K3 (paged scan; the
   serving plan w = 4096 with
   128-row pages, 32-row pages with tiles spanning pages, w = 64, 24-row
   pages, chains of 0, 1, partial and full length, a dead second
   sub-block, a filtered first sub-block, tombstones, NaN in every page no
   chain holds, kf 10…320, uint8/int8/bf16/fp32 pages, the selection's
   cases over a page table); K4 (paged packed scan; bits 1/2/4, kf
   10…320, rot_dim 40, the selection's cases); K5 (the IVF-PQ LUT scan,
   through the grouped entry — nc 16…256, s 8…64, m 128…3,968 and an odd
   130, qpl 16…320 and a partial slot block, +inf b_sum tails, all-zero
   LUT rows, an empty list, a LUT past 2^31 elements — and through the
   pair entry — the streamed path's tile shape, a hot list of many
   16-pair blocks, blocks of ≤ 8 pairs, an odd m, lists no pair probes;
   bitwise on integer-valued LUTs, within PARITY_RTOL on real-valued
   ones); K6 (fused CAGRA hop; deg 64,
   p 64, w 1/4/8 × itopk 32/64/96, duplicate-heavy graphs, -1 edges,
   invalid and all-invalid parents, an all-visited buffer, +inf buffer
   holes, a scalar-staging shape, parents whose code records start past
   byte 2^31; each case with its parents given and picking its own, from
   the case's unsorted buffer and from the sorted one a hop returns;
   bitwise on integer-valued qp, within tolerance on real-valued qp);
4. kmeans — Lloyd k-means on the dataset as fp32:
   ``kmeans.fit(KMeansParams(n_clusters=1024))`` (k-means++, max_iter 300,
   tol 1e-4), seeding and EM seconds apart, the inertia never rising, its
   ``cluster_cost`` equal to the inertia, ``predict`` on 10,000 rows equal
   to the argmin of ``pairwise_distance`` but at ties; ``kmeans.array``:
   the card's and the CPU's ``init="array"`` fits on a 100,000-row
   subsample for 10 iterations (centroids at rtol 1e-4, equal n_iter), and
   ``metric="euclidean"`` once;
   main — ``sift_like(1_000_000, 128, 10_000)`` and its tiled brute-force
   ground truth, made once for every path. IVF-PQ: ``ivf_pq.build`` at the
   bench's parameters (n_lists 1024, pq_dim 64, 8 bits, train fraction
   0.2), the bench's n_probes / k_fetch escalation with exact refine to
   k = 10, recall@10 ≥ 0.95 asserted, QPS over three 10k-query batches
   (all queries over all their time); K1's launch count on that run, then
   its time at the main path's own class inputs (the tile's bf16 rows and
   the plan's ``qids``, read by id as the search reads them; every K1
   path's class inputs are) beside its plain twin, a
   PyTorch yardstick (batched matmul + topk) and its bound, and its split
   into product and selection (``main.k1_split``: the product-only
   instantiation of the same template, ``raft_strip_scan_product``);
5. bq — the same for IVF-BQ: ``ivf_bq.build`` at the bench's parameters
   (n_lists 1024, 1 bit, dense rotation, train fraction 0.2), the bench's
   escalation (n_probes 16…256 at k_fetch 40, then k_fetch 80, 160, 320 at
   the best n_probes), refine to k = 10, recall@10 ≥ 0.95 and K2 launches
   asserted, QPS; then K2 at the path's own class inputs, the product
   loop its launches ran (asserted ``wgmma`` for 8-byte multiples of code
   bytes) and its product/selection split (``bq.k2_split``, the
   product-only ``raft_bq_scan_product``);
6. flat — IVF-Flat at the bench's parameters (n_lists 1024, train
   fraction 0.2, uint8 lists): n_probes 16…256 at k = 10 until recall@10
   ≥ 0.95, no refine; QPS, K1's launches on uint8 lists, K1 at the path's
   inputs and its product/selection split;
7. serve — the bench serving section's data plane on that index: a
   ``PagedListStore`` of 128-row pages, reserved for the window (plan and
   ``stats()`` printed); paged search through K3 (recall ≥ 0.95, ids
   agreeing with the packed search, QPS, batch-1 and batch-64 latency);
   a 64-round window (upsert 32 query vectors under ids 1,000,000 + i,
   search the 64 newest, delete the batch of 8 rounds earlier): 100%
   read-back, no deleted id returned, no growth; compact → packed search
   through K1 agrees, compact_swap keeps capacity, width and results; K3
   at the path's own class inputs;
8. serve.pq / serve.bq — stores made from the IVF-PQ and IVF-BQ indexes,
   paged search at each path's chosen (n_probes, k_fetch) with exact
   refine (K3 over the int8 cache, K4 over the codes), recall ≥ 0.95, one
   upsert/delete round (≥ 99% read-back before refine, no deleted id);
   K3 (on the int8 cache) and K4 at their paths' own class inputs, K4's
   product loop and split (``serve.bq.k4_split``) as K2's;
9. lut — the streamed IVF-PQ path: ``build_streaming`` from a host copy of
   the dataset (4 chunks of 250,000 rows, the 128-row granule, the main
   path's parameters), what ``"auto"`` resolves to (``"pallas"``), the
   dropped-row accounting, the escalation through ``backend="pallas"`` (K5
   over each query tile's probed pairs, one attempt) and exact refine,
   recall@10 ≥ 0.95, K5 launches = tiles and 0 dropped pairs asserted,
   QPS; the gather backend on 1,000 queries beside it; ``extend`` with the
   queries (read-back ≥ 0.99); K5 parity on the first and last query tile,
   then K5 on the first tile beside its twin, the one-hot bf16 bmm
   yardstick (on the tile's grouped layout) and its bound, and K5 and the
   select over p·m (``select_ms``) over every tile of one search; then
   ``cache`` —
   ``build_streaming(store="cache")`` searched with the default backend
   (K1 over the int8 cache), recall@10 ≥ 0.95 and K1 launches asserted;
10. cagra — CAGRA at the bench's shape (``bench.py``'s CAGRA section):
   build from the uint8 dataset with degrees 128 → 64 and the compression
   payload (build seconds by phase, K1's launches in the IVF-Flat
   candidate scan, graph and payload invariants), K1 at kf 129 on the
   build's first candidate batch and its product/selection split, the
   fused rungs (64, 4) and (96, 8) with
   K6 launches equal to the hops run, recall@10 ≥ 0.95 asserted, QPS over
   three batches beside the compressed traversal's, K6 parity on the
   path's state after hop 3 (picking its own parents, as the search
   runs it), then K6 at the path's inputs (time, twin, bound, launch
   layout; the parents-given entry and the torch pickup the path ran
   before, no longer on it, beside it) and the rest of a search
   (seeding, exit re-rank).

Filters and the family remainders ride the paths above. Each of main,
lut, cache, flat, bq (``search_refined``), serve, serve.pq, serve.bq and
cagra runs the bench's filtered rungs (``<path>.filtered``: masks from
``default_rng(13)`` at 10% and 1% selectivity with ids 0..9 passing, the
port's brute force over the survivors as ground truth, recall@10, the
widened n_probes / k_fetch, QPS beside the path's unfiltered QPS in the
same call, the path's kernel launches; no returned id fails its mask, an
all-fail filter gives -1 / +inf, recall ≥ 0.90 at 10% on every IVF and
serving path, CAGRA's printed). ``flat.k1_filtered``: K1 at the flat
path's class inputs with the bias of a filter passing only even lists, and
of one passing nothing, against the same inputs unfiltered.
``main.k1_filtered<r>`` and ``flat.k1_filtered<r>`` (r = 10, 25, 50, 75,
90): K1 at the path's class inputs under a filter passing a random r% of
the rows, at the n_probes the search widens to: the dense walk (at the
main path the tournament) beside the gathered walk, each against its twin,
the gathered walk bit for bit against the dense exact walk on every finite
slot, each walk's measured launches, then both timed (the gathered walk
won at every rate, so every filtered search takes it). ``<path>.filtered``
counts the gathered launches of the path's own filtered search beside
its K1 launches: all of them.
``serve.standing_filter``: ``set_filter`` gives the per-call ids and
survives compact + compact_swap; a permutation of the 1% mask as the
standing filter gives a fresh Bitset's ids. ``serve.gather``: k = 600 and
1000 on the flat and PQ stores through the gather scan ``"auto"`` takes.
``flat.extend`` / ``bq.extend``: the 10k queries added under ids
1,000,000 + i and found again through K1 / K2 (after refine).
``bq.streaming``: ``ivf_bq.build_streaming`` in 4 chunks of 250,000 rows
(dropped rows accounted for), recall ≥ 0.95 after refine at the bq pick.
``brute.metrics``: brute force in sqeuclidean, inner_product, cosine and
l1 on 100,000 rows × 1,000 queries against ``pairwise_distance`` +
``torch.topk``. K1–K4's synthetic parity sets hold filtered cases (whole
dead lists and half the other rows dead in the bias).

``--ab OLD_TREE`` drives the paths up to the LUT path, then times K1–K4 of
the older tree against this one's at the paths' own class inputs (K1 at
kf 20, kf 10 on uint8 and kf 129 on the CAGRA build's batch; K2; K3 and K4
at their serving inputs) in the order old, new, new, old, holds the two
trees' results against each other as ``compare`` holds a kernel and its
twin, and runs each tree's LUT search (K5) and IVF-PQ ragged search (K1)
in a process of its own on one index and query file (telemetry off), then
K6 on a CAGRA index built there: the two
trees' parents-given entries at one search's hops, the older tree's torch
pickup plus K6 against this tree's picking entry, and each tree's fused
search (QPS, recall, K6 launches) in a process of its own on one index
file; each path-level search runs in 8 processes, old, new, new, old
twice, 10 batches each, and a tree's figure is the median process's
median batch (``AB_ORDER``, ``AB_BATCHES``); it prints no last line. ``--k1-variants`` and
``--k2-variants`` time K1 (or K2 and K4) built from other kernel source
trees against each other at the paths' shapes (``strip_variants``);
``--k6-variants`` K6 at synthetic hops of the fused rungs
(``hop_variants``).

Telemetry and faults ride the paths too. ``<path>.obs`` (main, bq, flat,
serve, lut, cagra): one 10k-query search with telemetry on, its span tree
(``ivf_pq::search`` → ``ivf_pq::scan`` and the like), the
``*.search.queries`` and backend counters against the queries served and
the kernel's launches (equal to a telemetry-off run's), then QPS with
telemetry off, on and on in sync mode; ``obs``: the rungs' Chrome trace
under ``results/`` and their QPS table. ``faults``: the 1M streamed
IVF-BQ build with ``ivf_bq.build.encode_chunk=oom:1`` armed, bit-identical
to the unarmed build; a real CUDA OOM in brute force (a tile whose
(queries × rows) fp32 block exceeds the free memory) recovered by
``degrade_on_oom`` with ids equal to a default-tile search but at ties;
every faultpoint of the port armed once on 100,000-row indexes, surfacing
classified, then serving; a spent soft deadline keeping the first of three
k-means fits, marked degraded.

The obs cost layer and the serving managers ride the paths too.
``obs.cost``: ``costmodel.predict_index_bytes(**index_layout(x)) ==
memory.index_bytes(x)`` exactly for the IVF-PQ, IVF-BQ, IVF-Flat and CAGRA
indexes and the three serving stores at 1M × 128 (checked where each is
built, with the caching allocator's growth around the build beside it),
``hbm_budget()`` the card's total, ``platform_peaks()`` the card's entry of
the peak table, and ADMIT for one 10k batch of the flat store.
``serve.queue``: the flat store (K3) behind a ``QueryQueue`` at the flat
path's n_probes and k = 10 — a batch-1 baseline of 64 sequential queries;
windows of 256 Poisson requests at 2×, 5× and 10× its rate (max_batch 64,
fill_wait = the 64-batch latency, slo = max(4·that, 2·batch-1), deadlines
2·slo for every 5th request and 8·slo for the rest, 32 upserted rows and a
FIFO delete every 32 requests inside a reserved window, the paged-scan
cost hook, a 0.25 ``ShadowSampler`` against the store's exhaustive scan):
QPS, p50/p90/p99, multi-batch share and verdicts; no error verdict, K3
launches in each window, every dispatch priced, no new scan signature, no
unexplained retrace, shadow recall ≥ 0.90; a window with
``serving.queue.dispatch=oom:1`` armed (cap 64 → 32, every request ok); a
``CompactionManager`` cycle that keeps the results. ``obs.roofline``: in
sync mode one 10k batch of the flat store and of IVF-PQ ragged, the
roofline's model against the committed span times (model_to_measured ≤
1, no utilization over 1.05). ``serve.maint``: two PQ-cache stores (K3 on
the int8 cache) from the IVF-PQ index, pre-grown (``restore_shape``) to
the final footprint, take a drifted stream of 120,000 rows in 6 batches;
one is maintained (``MaintenanceManager``, exact row source), one is the
control: ≥ 1 cycle with pairs, every status classified, no new scan
signature, drifted recall@10 (refined) at least the control's, original
recall ≥ 0.95. ``capacity``: 8 IVF-Flat tenants of 250,000 rows (n_lists
256), warm IVF-BQ twins built on the card, ~4× oversubscribed, 480 Zipf
(1.1) requests through ``CapacityController`` with autopromotion: no OOM,
every outcome and transition classified, the promote latency measured, K1
launches for hot serves and K2 for warm ones.

The tuning loop and the bench runner ride the paths too. ``tuning``
(after ``serve.queue``, on its flat store, K3): ``bench.py``'s
``_autotune_rung`` at its full-size settings — probe ladder (4, 8, 16),
cap ladder (16, 32, 64), 96 Poisson requests a window, every (probe rung
∪ exact) × pow2 bucket met before any clock, the recall floor by the JAX
rung's rule (the middle of the measured ladder's widest gap when it
exceeds 0.08, else 0.03 under the top rung; printed as
``recall_floor_by``); the ``Autotuner`` (default window budget and
deadline) with a ``FlightRecorder`` writing
``results/flight_chip_smoke.jsonl`` (window 0 carries the health probe's
verdict): no tuner window skipped, no tuner request in an error verdict,
no flight window degraded; the emitted operating point read back with
``load_operating_point``, then a calm slice, a saturating spike and calm
recovery under the ``BurnRateController``: the point meets its SLO, the
knobs are restored, no calm action, no SLO in breach at the end, no
consequential unknown diagnosis, no new scan signature, no unclassified
verdict, ≥ 1 controller action, K3 launches; then the flight CLI
(``--validate --render --frontier``) and the report CLI (``--validate``)
on the recording, each in a child process. ``bench.runner`` (after
``cagra``, whose index is freed by then): ``bench.runner.main`` in this
process on the siftlike 1M × 128 config — brute force, IVF-Flat and
IVF-PQ at the flat and main paths' picks, CAGRA 128 → 64 at the cagra
path's fused rung — with each algo's build and searches counted apart:
brute force's recall 1.0, every other record's ≥ 0.95 and within 0.002 of
its path's figure earlier in the call, K1 launches for IVF-Flat and
IVF-PQ, K6 launches = the CAGRA searches' hops, and each record read
from the JSON the runner wrote with JAX's keys, naming the config's
parameters.

The CAGRA remainder and the distributed layer run last, every distributed
path at DIST_SHARDS = 4 shards on the one card (``local_mesh(4,
device="cuda")``): ``dist.kmeans`` (``distributed.kmeans.fit`` and
``fit_balanced`` with 1,024 clusters on the 1M × 128 rows: seconds,
inertia beside the single-index fit's, within DIST_KMEANS_SLACK);
``dist.brute_force`` (exact k = 10, ids equal the single index's but at
near-ties, and one search under the 10% mask); ``dist.ivf_flat``,
``dist.ivf_bq``, ``dist.ivf_pq`` (build, a 10k batch at the single path's
n_probes / k_fetch with refine for PQ and BQ: QPS as the median of 3,
recall@10 within DIST_RECALL_SLACK of the single path's, K1 / K2 launches
equal to the plan's shards × tiles × length classes, the kernel's share of
the search time by CUDA events); ``dist.ivf_pq.shard_loss`` (one shard
LOST: coverage 0.75, degraded, results equal to an index whose lost shard
holds nothing); ``dist.snapshot`` (the IVF-PQ index saved, loaded, its
lost shard wiped then ``restore_shard`` / ``recover``ed, results equal to
before the loss); ``dist.cagra`` (one CAGRA build a shard, K1 launches
per shard, the compressed loop with K6 launches 0, recall@10 ≥
DIST_CAGRA_GATE); ``dist.nccl`` (a world-1 NCCL process group on a free
localhost port: the nine comms self-tests, an IVF-PQ search equal to the
``local`` transport's, then torn down); ``cagra.nn_descent``
(``nn_descent.build`` at NND_ROWS × 128 with graph degree 64 from 128:
seconds a round, graph recall@64 on 1,000 nodes against the exact graph,
one round at the default 1 GiB workspace, then
``cagra.build(build_algo="nn_descent")`` and its search recall@10);
``cagra.hnsw`` (the single-index CAGRA graph through ``save_to_hnswlib``,
``HnswIndex.load`` + ``knn`` on 1,000 queries, and the native and Python
writers byte-identical on a 10,000-node slice).

The sparse tier, graph clustering and the hybrid and out-of-core paths
run after them. ``hybrid`` (``bench.py``'s hybrid rung): the first
200,000 rows fused with sparse rows (vocab 1,000, density 0.02,
``default_rng(13)``) hashed to 128 columns, IVF-BQ with n_lists 256 under
inner product (K2 over 256-wide fused rows), 256 queries at n_probes 32:
recall@10 against the exact fused top-10 (fp32 product, TF32 off), QPS,
K2 launches, the dense and CSR projections bit for bit, K2 against its
twin at the path's class calls and timed there (``hybrid.k2``); then
``hybrid.store``: ``to_store`` → ``serving.search`` over the fused
queries (K4), ids equal to ``hybrid.search``'s but at near-ties, K4
against its twin at the store's class calls. ``deep10m``
(``bench.py``'s section, whole): ``sift_like(10_000_000, 96, 10_000,
seed=1)`` on the card as uint8, ground truth and the brute baseline from
``batch_knn.search_device_chunked`` (32,768-row windows), IVF-PQ with
n_lists 4096, pq_dim 48 × 8 bits, train fraction 0.1 and list cap 4096
through K1 over the int8 cache at rot_dim 96 (n_probes 32 → 64 → 128 at
k_fetch 20, exact refine, the 0.95 gate): QPS, ``ann_beats_brute``, build
seconds, K1 launches, ``resilience.degraded_tile`` 0 (no OOM retry), and
K1 at the path's class calls against its twin and timed beside its bound
and yardstick (``deep10m.k1``: 96 is not a multiple of the 64-dim staging
chunk, so the plan takes the scalar-staged ``mma.sync`` route).
``batch_knn.out_of_core``: the same 10M rows as a host numpy array,
``search_out_of_core`` for 1,000 queries in workspace-sized chunks (ids
equal to the chunked scan's but at exact ties; seconds, host-to-card
GB/s), then ``BatchKQuery`` over the 1M brute-force index: three slabs of
32 equal one search at k 96. ``graph`` (the first 100,000 rows):
``knn_graph`` at k 31, its ``mst`` weight equal to scipy's minimum
spanning tree of the same graph within rel 1e-5, ``single_linkage``
into 64 clusters (n − 1 merge edges, 64 labels), ``spectral.partition``
into 8 with each eigenpair's residual, ``ball_cover`` answering 1,000
queries with brute force's ids but at near-ties, and ``eps_nn`` against
``eps_neighbors`` (adjacency counts).

The parity tail runs last, a line each sub-phase. ``tail.plan``: the
IVF-Flat index (uint8 lists) at the flat path's n_probes, 10,000 queries
searched with every query tile planned by the host planner
(``strip_scan.plan_strips``, numpy) and by the device plan
(``plan_tile``): values and ids bit for bit, K1 launches = the host plan's
classes summed over its tiles, both planners' milliseconds, K1 at the host
plan's class inputs against its twin. Then, each against float64 on the
host: ``tail.linalg`` (keyed sums and counts over the 1M rows with the
1,024 coarse keys and 1% out of range, twice with the same bits; gemm
(1M × 128)ᵀ(1M × 128); svd, qr, lstsq on 100,000 × 128 and a rank-64
lstsq; rsvd(k=16) on the 1M rows against the exact top 16 and the
Eckart–Young residual; Lanczos on a 4,096 × 4,096 SPD matrix against
``eigvalsh``'s 4 smallest), ``tail.stats`` (the contingency matrix of the
k-means fit's and the coarse assignment's 1M labels equal to numpy's
int64 one, the six comparison metrics, silhouette on 20,000 rows,
trustworthiness on 10,000 rows of the 2-component ``eig_dc`` projection at
k 10, the summary statistics), ``tail.kernels`` (the four Gram kernels on
10,000 × 10,000 × 128, ``masked_l2_nn`` for 100,000 rows against the
1,024 centres in 32 groups), ``tail.solver`` (linear assignment on 1,024
× 1,024 integer costs, total equal to scipy's, and 512 × 512 float costs
within n·ε_final; seconds and rounds), ``tail.merge`` (brute force on the
two halves merged by ``merge_topk`` against the whole search),
``tail.datasets`` (``deep_like_rows`` for 10M × 96 in 1M-row chunks,
rows/s, unit norms, 10,000 rows regenerated alone bit-identical) and
``tail.resources`` (``get_resources()`` from 16 threads: one instance on
``cuda:0``).

The port's static analysis rides along twice. ``analysis`` (first of the
paths): ``python -m raft_tpu_torch.analysis raft_tpu_torch
tests/test_torch_*.py chip_smoke.py`` in a child process whose CUDA lazy
init raises — exit 0 against the port's baseline
(``raft_tpu_torch/analysis/baseline.json``), no CUDA context and no JAX in
the child at its exit, under ``ANALYSIS_BUDGET_S`` of wall time; the
finding count, the baseline's share and the seconds. ``analysis.syncs``
(after ``obs.roofline``, while the IVF-PQ index is held): one warm ragged
IVF-PQ search at the main path's batch, n_probes and k_fetch under
``torch.cuda.set_sync_debug_mode("warn")``, every warning recorded
(``simplefilter("always")``); the syncs a search makes, grouped by the
``raft_tpu_torch`` file:line each warning points at, each site with the
rules that report it; every site that fires more than once a search must
be reported by ``loop-host-transfer``, ``launch-host-sync`` or
``tensor-branch`` (or stand in the baseline with a justification); K1's
launches equal its launches in the same search without the debug mode.
The debug mode sees only the syncs ATen checks (``.item()``, a blocking
copy, ``nonzero``), not ``torch.cuda.synchronize()`` or a ctypes launch.

Every kernel count is set to 0 just before a path is driven and read just
after it. Then a ``kernels`` line and, last, ``{"ok": true, "device":
{...}}``. Any failed phase raises: the script exits non-zero and prints no
last line. Without a CUDA device it exits 1 before printing anything.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_SOURCE = "raft_tpu_torch/ops/csrc/strip_scan.cu"
K2_SOURCE = "raft_tpu_torch/ops/csrc/bq_scan.cu"
K3_SOURCE = "raft_tpu_torch/ops/csrc/paged_scan.cu"
K4_SOURCE = "raft_tpu_torch/ops/csrc/paged_bq_scan.cu"
K5_SOURCE = "raft_tpu_torch/ops/csrc/pq_scan.cu"
K6_SOURCE = "raft_tpu_torch/ops/csrc/cagra_hop.cu"
# the main paths' size: the JAX bench's IVF-PQ and IVF-BQ sections
N_ROWS = 1_000_000
N_QUERIES = 10_000
N_LISTS = 1024
K = 10
STREAM_CHUNK_ROWS = 250_000   # the streamed builds: 4 chunks at 1M rows
K1_REPLACES = "raft_tpu/ops/strip_scan.py:340"
K2_REPLACES = "raft_tpu/ops/bq_scan.py:174"
K3_REPLACES = "raft_tpu/ops/strip_scan.py:955"
K4_REPLACES = "raft_tpu/ops/bq_scan.py:438"
K5_REPLACES = "raft_tpu/ops/pq_scan.py:79"
K6_REPLACES = "raft_tpu/ops/cagra_hop.py:64"
# the (n_probes, k_fetch) the IVF-BQ escalation picks at 1M x 128 (bq.search)
BQ_PICK = (256, 80)
# H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12          # fp32 outside the tensor cores (K6's sums)

# the analysis gate's wall-time budget (the child's torch import included)
ANALYSIS_BUDGET_S = 30.0
#: the rules that report a sync the card's debug mode sees
SYNC_RULES = ("loop-host-transfer", "launch-host-sync", "tensor-branch")

# values: summation-order noise plus one 12-bit packing quantum (2^-11
# relative); the absolute floor covers scores that cancel toward zero
PARITY_RTOL = 5e-4
PARITY_ATOL_FRAC = 1e-5      # × the case's largest |finite value|


# with --ab: each timed kernel's class inputs from its path, by kernel and
# shape, and the LUT path's index and queries in files under AB_FILES, beside
# the older tree (ab_phase reads them)
AB_INPUTS = None
AB_FILES = None
# the path-level A/B: each tree's search in a process of its own, in turns,
# AB_BATCHES timed batches a process, the median batch a process and the
# median process a tree
AB_ORDER = ("old", "new", "new", "old") * 2
AB_BATCHES = 10


def median(vals):
    vals = sorted(vals)
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else (vals[mid - 1] + vals[mid]) / 2


def keep_for_ab(key, value) -> None:
    if AB_INPUTS is not None:
        AB_INPUTS[key] = value


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out, strip_list, strip_rows):
    """topk_agreement over the rows a kernel defines: real strips, real
    rows. The absolute floor scales with the case's largest real score; the
    ±3.4e38 the packing clamp leaves for -inf scores is not one."""
    import torch

    from raft_tpu_torch.stats.metrics import topk_agreement

    (vk, ek), (vp, ep) = kernel_out, plain_out
    slots = torch.arange(vp.shape[1], device=vp.device)[None, :]
    rows = (strip_list >= 0)[:, None] & (slots < strip_rows[:, None])
    v = vp[rows]
    real = torch.isfinite(v) & (v.abs() < 1e38)    # not ±inf, not ±clamp
    top = float(v[real].abs().max()) if bool(real.any()) else 0.0
    return topk_agreement(vp, ep, vk, ek, rtol=PARITY_RTOL,
                          atol=PARITY_ATOL_FRAC * top, mask=rows)


def ordered_bias(order, lists, cols, span):
    """Scores that are the bias alone, ordered along a list's columns:
    ``"asc"`` (every new key is above the row's threshold once its carry
    is full), ``"desc"`` (every key passes it, so the candidate queue
    overflows on every tile) or ``"equal"`` (ties, ordered by the packed
    column). Integers below 2^24 apart per list, exact in fp32."""
    import torch

    base = (lists * span).to(torch.float32)
    if order == "asc":
        return base + cols.to(torch.float32)
    if order == "desc":
        return base + (span - cols).to(torch.float32)
    return torch.full_like(base + cols.to(torch.float32), 7.0)


def same_rows(kernel_out, plain_out, strip_list, strip_rows) -> bool:
    """Values and ids equal bit for bit over the rows a kernel defines (the
    ordered cases, whose scores are exact: ties must resolve by column)."""
    import torch

    slots = torch.arange(plain_out[0].shape[1],
                         device=plain_out[0].device)[None, :]
    rows = (strip_list >= 0)[:, None] & (slots < strip_rows[:, None])
    return all(bool(torch.equal(k[rows], p[rows]))
               for k, p in zip(kernel_out, plain_out))


def filter_bias(bias, ids, seed, dead_lists, list_of):
    """``bias`` under a filter built as a search builds it
    (``_filtering.apply_filter_bias`` of a ``Bitset``): the rows of the
    ``dead_lists`` fail (whole dead lists, so whole dead sub-blocks), half
    the other rows fail at random. ``ids`` (one per bias lane, -1 at
    padding) and ``list_of`` (each lane's list) shape like ``bias``."""
    import numpy as np
    import torch

    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors._filtering import apply_filter_bias

    n_ids = int(ids.max()) + 1
    mask = np.random.default_rng(seed).random(n_ids) < 0.5
    dead = torch.isin(list_of, torch.as_tensor(dead_lists,
                                               device=ids.device))
    mask[ids[dead & (ids >= 0)].cpu().numpy()] = False
    return apply_filter_bias(bias, ids,
                             Bitset.from_mask(mask, device=ids.device))


def synthetic_class(seed, *, w_blocks, n_sub, kf, dim=128, b_dtype="int8",
                    n_lists=8, s_real=24, s_pad=32, dead=False,
                    nonfinite=False, order=None, filtered=False, dev="cuda"):
    """One length class with random lists, bias and query blocks on
    ``dev``: padding strips scattered among the real ones, and strips
    whose real query rows are a prefix of their slots. ``b_dtype`` "int8",
    "uint8", "bf16" or "fp32" makes K1's list rows; "packed" makes K2's: ``dim/8``
    random code bytes per row, with a scale drawn per row (0 at padding).
    ``order`` zeroes the list rows (K2: the scales) so that every score is
    its bias, laid out by :func:`ordered_bias`. ``filtered`` puts a
    filter's +inf lanes in the bias (:func:`filter_bias`: lists 0 and 3
    dead, half of the rest). Returns the keyword arguments of the class
    call and the per-strip row counts."""
    import torch

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = w_blocks * 512
    m = w * n_sub
    if b_dtype == "int8":
        b = torch.randint(-127, 128, (n_lists, m, dim), generator=g, device=dev,
                          dtype=torch.int8)
    elif b_dtype == "uint8":
        b = torch.randint(0, 256, (n_lists, m, dim), generator=g, device=dev,
                          dtype=torch.uint8)
    elif b_dtype == "packed":
        b = torch.randint(0, 256, (n_lists, m, dim // 8), generator=g,
                          device=dev, dtype=torch.uint8)
    else:
        b = torch.randn((n_lists, m, dim), generator=g, device=dev) * 16
        b = b.to(torch.bfloat16 if b_dtype == "bf16" else torch.float32)
    lens = torch.randint(kf, m + 1, (n_lists,), generator=g, device=dev)
    col = torch.arange(m, device=dev)[None, :]
    bias = torch.rand((n_lists, m), generator=g, device=dev) * 1000.0
    bias = torch.where(col < lens[:, None], bias, float("inf"))
    if order is not None:
        if b_dtype != "packed":
            b = torch.zeros_like(b)
        bias = torch.where(col < lens[:, None], ordered_bias(
            order, torch.arange(n_lists, device=dev)[:, None], col, m),
            float("inf"))
    if dead:
        bias[0] = float("inf")                     # a fully dead list
        if n_sub > 1:
            bias[1, :w] = float("inf")             # dead first sub-block
            bias[2, w:2 * w] = float("inf")        # dead later sub-block
    if filtered:
        ids = torch.where(col < lens[:, None],
                          torch.arange(n_lists * m, device=dev).reshape(
                              n_lists, m), -1)
        lists = torch.arange(n_lists, device=dev)[:, None].expand(n_lists, m)
        bias = filter_bias(bias, ids, seed, [0, 3], lists)
    if nonfinite:
        u = torch.rand((n_lists, m), generator=g, device=dev)
        bias = torch.where(u < 0.01, float("nan"), bias)
        bias = torch.where((u >= 0.01) & (u < 0.02), float("-inf"), bias)
        bias = torch.where((u >= 0.02) & (u < 0.03), float("inf"), bias)
    strip_list = torch.randint(0, n_lists, (s_pad,), generator=g, device=dev)
    pad = torch.randperm(s_pad, generator=g, device=dev)[:s_pad - s_real]
    strip_list[pad] = -1
    rows = torch.randint(1, 193, (s_pad,), generator=g, device=dev)
    rows[: s_pad // 2] = 192                       # half the strips full
    slots = torch.arange(192, device=dev)[None, :, None]
    a = torch.randn((s_pad, 192, dim), generator=g, device=dev) * 4
    a = torch.where(slots < rows[:, None, None], a, 0.0)
    call = dict(strip_list=strip_list.to(torch.int32).contiguous(),
                a=a.to(torch.bfloat16).contiguous(), bias=bias.contiguous(),
                w_blocks=w_blocks, n_sub=n_sub, alpha=-2.0, kf=kf)
    if b_dtype == "packed":
        scale = 0.5 + 1.5 * torch.rand((n_lists, m), generator=g, device=dev)
        if order is not None:
            scale = torch.zeros_like(scale)
        call.update(list_codes=b.contiguous(), scale=torch.where(
            col < lens[:, None], scale, 0.0).contiguous())
    else:
        call.update(list_data=b.contiguous())
    return call, rows.to(torch.int32).contiguous()


# the threshold filter and candidate queue of the strip kernels' selection:
# ordered and tied scores, the queue overflowing on every tile, kf at its
# edges (1, 31 under both selections, 129, 512), dead sub-blocks; shared by
# K1 and K2 (``ordered_bias``)
SELECTION_CASES = (
    [(f"{order}_kf{kf}", dict(w_blocks=2, n_sub=1, kf=kf, order=order), False)
     for order in ("asc", "desc", "equal") for kf in (1, 31, 129)]
    + [("desc_tournament_kf31", dict(w_blocks=2, n_sub=1, kf=31,
                                     order="desc"), True),
       ("equal_tournament_kf16", dict(w_blocks=4, n_sub=1, kf=16,
                                      order="equal"), True),
       ("desc_kf512_n_sub2_dead", dict(w_blocks=1, n_sub=2, kf=512,
                                       order="desc", dead=True), False),
       ("asc_kf129_n_sub4_dead", dict(w_blocks=1, n_sub=4, kf=129,
                                      order="asc", dead=True), False),
       ("kf1_random", dict(w_blocks=8, n_sub=1, kf=1), False),
       ("kf31_random_exact", dict(w_blocks=4, n_sub=1, kf=31), False),
       ("kf129_random_n_sub2_dead",
        dict(w_blocks=2, n_sub=2, kf=129, dead=True), False),
       ("kf31_nonfinite_tournament",
        dict(w_blocks=2, n_sub=1, kf=31, nonfinite=True), True)])

PARITY_CASES = (
    [(f"main_w{512 * wb}_kf{kf}", dict(w_blocks=wb, n_sub=1, kf=kf), True)
     for wb in (2, 4, 8) for kf in (10, 20, 40)]
    + [("n_sub4_dead_kf40", dict(w_blocks=1, n_sub=4, kf=40, dead=True), False),
       ("n_sub2_tournament_kf20",
        dict(w_blocks=2, n_sub=2, kf=20, dead=True), True),
       ("padding_dead_lists_kf10", dict(w_blocks=2, n_sub=1, kf=10, dead=True),
        True),
       ("nonfinite_bias_kf40", dict(w_blocks=1, n_sub=1, kf=40, nonfinite=True),
        False),
       ("fp32_lists_kf20", dict(w_blocks=2, n_sub=1, kf=20, b_dtype="fp32"),
        True),
       ("bf16_lists_kf10", dict(w_blocks=1, n_sub=1, kf=10, b_dtype="bf16"),
        False),
       ("uint8_lists_kf10", dict(w_blocks=2, n_sub=1, kf=10, b_dtype="uint8"),
        False),
       ("uint8_n_sub2_dead_kf40",
        dict(w_blocks=1, n_sub=2, kf=40, b_dtype="uint8", dead=True), False),
       ("kf512_n_sub2", dict(w_blocks=1, n_sub=2, kf=512, dim=64), False),
       ("dim40_scalar_staging_kf20", dict(w_blocks=2, n_sub=1, kf=20, dim=40),
        True),
       # a search filter's bias: whole dead lists (dead sub-blocks), half
       # the other rows dead
       ("filtered_n_sub2_tournament_kf20",
        dict(w_blocks=2, n_sub=2, kf=20, filtered=True), True),
       ("filtered_uint8_kf10",
        dict(w_blocks=2, n_sub=1, kf=10, b_dtype="uint8", filtered=True),
        False)]
    + SELECTION_CASES
)

# K2: dim is the unpacked width bits·rot_dim (8 per code byte)
K2_PARITY_CASES = tuple(
    (name, dict(kw, b_dtype="packed"), approx_ok) for name, kw, approx_ok in
    [(f"main_w{512 * wb}_kf{kf}", dict(w_blocks=wb, n_sub=1, kf=kf), True)
     for wb in (2, 4, 8) for kf in (40, 80, 320)]
    + [("bits2_kf40", dict(w_blocks=2, n_sub=1, kf=40, dim=256), True),
       ("bits4_kf80", dict(w_blocks=2, n_sub=1, kf=80, dim=512), True),
       ("n_sub2_dead_kf80", dict(w_blocks=2, n_sub=2, kf=80, dead=True), True),
       ("n_sub4_dead_kf40", dict(w_blocks=1, n_sub=4, kf=40, dead=True), False),
       ("padding_dead_lists_kf40",
        dict(w_blocks=2, n_sub=1, kf=40, dead=True), True),
       ("nonfinite_bias_kf40", dict(w_blocks=1, n_sub=1, kf=40, nonfinite=True),
        True),
       ("tournament_kf20", dict(w_blocks=2, n_sub=1, kf=20), True),
       ("n_sub2_tournament_kf20",
        dict(w_blocks=2, n_sub=2, kf=20, dead=True), True),
       ("kf512_n_sub2", dict(w_blocks=1, n_sub=2, kf=512), False),
       ("rot_dim40_scalar_staging_kf40",
        dict(w_blocks=2, n_sub=1, kf=40, dim=40), True),
       ("filtered_n_sub2_kf80",
        dict(w_blocks=2, n_sub=2, kf=80, filtered=True), True)]
    + list(SELECTION_CASES))


def _kernel_pair(kernel):
    """(wrapper, plain twin) of a kernel by name."""
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import strip_scan as ss

    return {"strip_scan": (ss.strip_class, ss._strip_class_plain),
            "bq_scan": (bq.bq_class, bq._bq_class_plain),
            "paged_scan": (ss.paged_class, ss._paged_class_plain),
            "cagra_hop": (ch.fused_hop, ch.fused_hop_reference),
            "paged_bq_scan": (bq.paged_bq_class,
                              bq._paged_bq_class_plain)}[kernel]


def by_id_operands(a, strip_rows, seed):
    """The grouped (S, C, dim) operand ``a`` as K1 reads it in a search:
    (S·C, dim) query rows in a seeded random order and the slot table
    ``qids`` (S, C) that names them, -1 at or past ``strip_rows``."""
    import torch

    s_pad, c, dim = a.shape
    g = torch.Generator(device=a.device)
    g.manual_seed(seed)
    perm = torch.randperm(s_pad * c, generator=g, device=a.device)
    rows = torch.empty((s_pad * c, dim), dtype=a.dtype, device=a.device)
    rows[perm] = a.reshape(-1, dim)
    slots = torch.arange(c, device=a.device)[None, :]
    qids = torch.where(slots < strip_rows[:, None], perm.reshape(s_pad, c),
                       -1)
    return rows, qids.to(torch.int32).contiguous()


def parity_phase(kernel="strip_scan", cases=PARITY_CASES, seed0=1000,
                 dev="cuda"):
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    wrapper, plain = _kernel_pair(kernel)
    worst = 0.0
    for i, (name, kw, approx_ok) in enumerate(cases):
        call, rows = synthetic_class(seed0 + i, dev=dev, **kw)
        got = wrapper(**call, approx_ok=approx_ok, strip_rows=rows)
        want = plain(**call, approx_ok=approx_ok)
        if call["a"].is_cuda:
            torch.cuda.synchronize()
        verdict = compare(got, want, call["strip_list"], rows)
        if "order" in kw:
            verdict["bitwise"] = same_rows(got, want, call["strip_list"], rows)
            verdict["ok"] = verdict["ok"] and verdict["bitwise"]
        if kernel == "strip_scan":
            # K1 reading the same rows by id, as the search runs it, gives
            # the grouped call's bits
            q_rows, qids = by_id_operands(call["a"], rows, seed0 + i)
            by_id = wrapper(**dict(call, a=q_rows), approx_ok=approx_ok,
                            strip_rows=rows, qids=qids)
            verdict["by_id_bitwise"] = same_rows(by_id, got,
                                                 call["strip_list"], rows)
            verdict["ok"] = verdict["ok"] and verdict["by_id_bitwise"]
        emit({"phase": "parity", "kernel": kernel, "case": name,
              "tournament": ss.tournament_engaged(kw["kf"], 512 * kw["w_blocks"],
                                                  approx_ok),
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"{kernel} kernel disagrees with its plain "
                                 f"version on case {name}: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
    return worst


def synthetic_paged(seed, *, page_rows, table_width, ppf, kf, dim=128,
                    payload="uint8", n_lists=16, s_real=24, s_pad=32,
                    order=None, filtered=False, dev="cuda"):
    """One paged class on ``dev``: a page pool with chains of 0, 1,
    partial and full length (one ending on a sub-block boundary, so the
    next sub-block is dead), a list whose first sub-block is all +inf
    (filtered out), tombstones and never-filled tail slots at +inf bias,
    NaN payload and bias in every page no chain holds (page 0 among them),
    padding strips and strips with a prefix of real rows. ``payload``
    "uint8", "int8", "bf16" or "fp32" makes K3's pages; "bits1", "bits2",
    "bits4" make K4's codes (``dim`` is rot_dim) with a scale pool.
    ``order`` zeroes the pages (K4: the scales) and lays the bias of each
    list's chained rows out by :func:`ordered_bias` along the list's
    columns (no tombstones; tail slots stay +inf). ``filtered`` puts a
    filter's +inf lanes in the bias pool (:func:`filter_bias` over the
    rows' ids: lists 1 and 5 dead, half of the rest). Returns the keyword
    arguments of the class call and the per-strip row counts."""
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    R, W = page_rows, table_width
    n_sub = max(1, W // ppf)
    cap = n_lists * W + 8
    chains = torch.randint(0, W + 1, (n_lists,), generator=g, device=dev)
    chains[0], chains[1], chains[2] = 0, 1, max(1, ppf // 2)
    chains[3] = min(ppf, W)
    chains[4] = W
    perm = 1 + torch.randperm(cap - 1, generator=g, device=dev)
    slot = torch.arange(W, device=dev)
    first = torch.cumsum(chains, 0) - chains
    table = torch.where(slot[None, :] < chains[:, None],
                        perm[(first[:, None] + slot[None, :]).clamp(
                            max=cap - 2)], -1)
    chained = torch.zeros(cap, dtype=torch.bool, device=dev)
    chained[table[table >= 0]] = True
    if payload.startswith("bits"):
        nb = int(payload[4:]) * dim // 8
        pages = torch.randint(0, 256, (cap, R, nb), generator=g, device=dev,
                              dtype=torch.uint8)
        a_width = 8 * nb
    elif payload in ("uint8", "int8"):
        lo = 0 if payload == "uint8" else -127
        pages = torch.randint(lo, lo + 255, (cap, R, dim), generator=g,
                              device=dev).to(getattr(torch, payload))
        a_width = dim
    else:
        pages = torch.randn((cap, R, dim), generator=g, device=dev) * 16
        pages[~chained] = float("nan")
        pages = pages.to(torch.bfloat16 if payload == "bf16" else torch.float32)
        a_width = dim
    bias = torch.rand((cap, R), generator=g, device=dev) * 1000.0
    tomb = torch.rand((cap, R), generator=g, device=dev) < 0.03
    bias = torch.where(tomb, float("inf"), bias)
    fill = torch.randint(1, R + 1, (n_lists,), generator=g, device=dev)
    for l in range(n_lists):                          # tail pages
        if int(chains[l]):
            bias[table[l, int(chains[l]) - 1], int(fill[l]):] = float("inf")
    if order is not None:
        if not payload.startswith("bits"):
            pages = torch.zeros_like(pages)
        r = torch.arange(R, device=dev)
        for l in range(n_lists):
            for t in range(int(chains[l])):
                bias[table[l, t]] = ordered_bias(
                    order, torch.tensor(l, device=dev), t * R + r, W * R)
            if int(chains[l]):
                bias[table[l, int(chains[l]) - 1], int(fill[l]):] = \
                    float("inf")
    if n_sub > 1:
        bias[table[4, :ppf]] = float("inf")           # filtered first block
    if filtered:
        owner = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        for l in range(n_lists):
            owner[table[l, :int(chains[l])]] = l
        bias = filter_bias(
            bias, torch.arange(cap * R, device=dev).reshape(cap, R), seed,
            [1, 5], owner[:, None].expand(cap, R))
    bias[~chained] = float("nan")
    strip_list = torch.randint(0, n_lists, (s_pad,), generator=g, device=dev)
    strip_list[:n_lists] = torch.arange(n_lists, device=dev)
    pad = n_lists + torch.randperm(s_pad - n_lists, generator=g,
                                   device=dev)[:s_pad - s_real]
    strip_list[pad] = -1
    rows = torch.randint(1, 193, (s_pad,), generator=g, device=dev)
    rows[: s_pad // 2] = 192
    slots = torch.arange(192, device=dev)[None, :, None]
    a = torch.randn((s_pad, 192, a_width), generator=g, device=dev) * 4
    a = torch.where(slots < rows[:, None, None], a, 0.0)
    table = table.to(torch.int32)
    chains = chains.to(torch.int32)
    call = dict(strip_list=strip_list.to(torch.int32).contiguous(),
                table_flat=table.reshape(-1).contiguous(),
                chain_pages=chains.contiguous(),
                sub_live=ss.paged_sub_live(bias, table, chains, ppf,
                                           n_sub).contiguous(),
                a=a.to(torch.bfloat16).contiguous(),
                bias_pool=bias.contiguous(), ppf=ppf, n_sub=n_sub,
                page_rows=R, table_width=W, alpha=-2.0, kf=kf)
    if payload.startswith("bits"):
        scale = 0.5 + 1.5 * torch.rand((cap, R), generator=g, device=dev)
        if order is not None:
            scale = torch.zeros_like(scale)
        call.update(codes=pages.contiguous(), scale_pool=torch.where(
            torch.isfinite(bias), scale, 0.0).contiguous())
    else:
        call.update(pages=pages.contiguous())
    return call, rows.to(torch.int32).contiguous()


# the selection's cases over a page table (K3, and K4 with 1-bit codes):
# ordered and tied scores, kf 1 / 31 / 129 / 512, a chain that ends on a
# sub-block boundary (a dead second sub-block) and a filtered first one
PAGED_SELECTION_CASES = (
    [(f"{order}_r128_kf{kf}", dict(page_rows=128, table_width=8, ppf=4,
                                   kf=kf, order=order))
     for order in ("asc", "desc", "equal") for kf in (1, 31, 129)]
    + [("desc_r128_nsub2_kf512", dict(page_rows=128, table_width=8, ppf=4,
                                      kf=512, order="desc")),
       ("random_r32_nsub2_kf129", dict(page_rows=32, table_width=16, ppf=8,
                                       kf=129)),
       ("random_r128_kf1", dict(page_rows=128, table_width=8, ppf=4, kf=1))])

# (name, synthetic_paged keywords): K3's pages, then K4's codes
K3_PARITY_CASES = (
    [(f"serve_r128_w4096_kf{kf}", dict(page_rows=128, table_width=64, ppf=32,
                                       kf=kf)) for kf in (10, 20, 40)]
    # the ring loop's edges: pages of 64, 32, 8 and 4 rows (a tile of
    # several pages, chains ending mid-tile), 256 (a page of two tiles),
    # one, three and four 64-dim chunks, kf 1 to 512; 2-row pages and bf16 /
    # fp32 pools keep the staged loop
    + [("r64_nsub2_int8_kf10", dict(page_rows=64, table_width=16, ppf=8,
                                    kf=10, payload="int8")),
       ("r32_nsub2_kf1", dict(page_rows=32, table_width=16, ppf=8, kf=1)),
       ("r8_w128_kf10", dict(page_rows=8, table_width=32, ppf=16, kf=10)),
       ("r4_w256_int8_kf20", dict(page_rows=4, table_width=64, ppf=64, kf=20,
                                  payload="int8")),
       ("r256_nsub2_kf20", dict(page_rows=256, table_width=8, ppf=4, kf=20)),
       ("r128_dim64_int8_kf20", dict(page_rows=128, table_width=8, ppf=4,
                                     kf=20, payload="int8", dim=64)),
       ("r128_dim192_kf40", dict(page_rows=128, table_width=8, ppf=4, kf=40,
                                 dim=192)),
       ("r128_dim256_int8_kf129", dict(page_rows=128, table_width=8, ppf=4,
                                       kf=129, payload="int8", dim=256)),
       ("r128_nsub2_int8_kf512", dict(page_rows=128, table_width=8, ppf=4,
                                      kf=512, payload="int8")),
       ("r2_w128_kf10", dict(page_rows=2, table_width=128, ppf=64, kf=10)),
       ("r128_bf16_kf20", dict(page_rows=128, table_width=8, ppf=4, kf=20,
                               payload="bf16")),
       ("r64_fp32_kf10", dict(page_rows=64, table_width=16, ppf=8, kf=10,
                              payload="fp32"))]
    + [("r32_w64_kf20", dict(page_rows=32, table_width=2, ppf=2, kf=20)),
       ("r32_nsub2_spanning_tiles_kf40",
        dict(page_rows=32, table_width=16, ppf=8, kf=40, payload="int8")),
       ("r128_nsub2_kf80", dict(page_rows=128, table_width=8, ppf=4, kf=80)),
       ("r128_kf320_fp32", dict(page_rows=128, table_width=8, ppf=4, kf=320,
                                payload="fp32")),
       ("r24_w384_bf16_kf40", dict(page_rows=24, table_width=32, ppf=16,
                                   kf=40, payload="bf16", dim=64)),
       ("pq_cache_r128_kf40", dict(page_rows=128, table_width=64, ppf=32,
                                   kf=40, payload="int8")),
       ("filtered_r128_nsub2_kf10", dict(page_rows=128, table_width=16,
                                         ppf=8, kf=10, filtered=True)),
       ("filtered_pq_cache_r128_kf20", dict(page_rows=128, table_width=64,
                                            ppf=32, kf=20, payload="int8",
                                            filtered=True))]
    + PAGED_SELECTION_CASES)
K4_PARITY_CASES = (
    [(f"serve_bits1_r128_kf{kf}",
      dict(page_rows=128, table_width=64, ppf=32, kf=kf, payload="bits1"))
     for kf in (40, 80, 320)]
    + [("bits2_r32_nsub2_kf20", dict(page_rows=32, table_width=16, ppf=8,
                                     kf=20, payload="bits2")),
       ("bits4_r128_kf40", dict(page_rows=128, table_width=8, ppf=4, kf=40,
                                payload="bits4")),
       ("bits1_r32_w64_kf10", dict(page_rows=32, table_width=2, ppf=2, kf=10,
                                   payload="bits1")),
       ("bits1_rot40_scalar_kf20", dict(page_rows=64, table_width=8, ppf=4,
                                        kf=20, payload="bits1", dim=40)),
       ("filtered_bits1_r128_nsub2_kf80",
        dict(page_rows=128, table_width=16, ppf=8, kf=80, payload="bits1",
             filtered=True))]
    + [(name, dict(kw, payload="bits1")) for name, kw in
       PAGED_SELECTION_CASES])


def k3_loop(kw) -> str:
    """The product loop K3's plan picks for a synthetic_paged case: the
    ring on byte pools of whole 64-dim chunks whose pages make whole tiles
    (or tiles whole pages) of 16-byte bias rows, else the staged wgmma
    loop at whole chunks, else mma.sync."""
    r, dim = kw["page_rows"], kw.get("dim", 128)
    pages_tile = (r < 128 and 128 % r == 0 and r % 4 == 0) or r % 128 == 0
    if dim % 64:
        return "mma.sync"
    if kw.get("payload", "uint8") in ("uint8", "int8") and pages_tile:
        return "ring"
    return "wgmma"


def paged_parity_phase(kernel, cases, seed0, dev="cuda"):
    """K3 or K4 against its plain twin on synthetic paged classes. Besides
    the finite candidates, the +inf slots must carry the twin's offsets
    (the positions the all-+inf remainder of a block gives). K3 must run
    the loop its plan picks for the case (``k3_loop``)."""
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    wrapper, plain = _kernel_pair(kernel)
    worst = 0.0
    for i, (name, kw) in enumerate(cases):
        call, rows = synthetic_paged(seed0 + i, dev=dev, **kw)
        got = wrapper(**call, strip_rows=rows)
        loop = {}
        if kernel == "paged_scan" and call["a"].is_cuda:
            loop = {"loop": ss.PAGED_KERNEL.loop, "want_loop": k3_loop(kw)}
        want = plain(**call)
        if call["a"].is_cuda:
            torch.cuda.synchronize()
        verdict = compare(got, want, call["strip_list"], rows)
        slots = torch.arange(192, device=rows.device)[None, :]
        live = (call["strip_list"] >= 0)[:, None] & (slots < rows[:, None])
        inf = torch.isinf(want[0][live])
        verdict["inf_offsets_equal"] = bool(torch.equal(got[1][live][inf],
                                                        want[1][live][inf]))
        if "order" in kw:
            verdict["bitwise"] = same_rows(got, want, call["strip_list"], rows)
            verdict["ok"] = verdict["ok"] and verdict["bitwise"]
        emit({"phase": "parity", "kernel": kernel, "case": name,
              "n_sub": call["n_sub"], "w": call["ppf"] * call["page_rows"],
              **loop, **verdict})
        if not (verdict["ok"] and verdict["inf_offsets_equal"]):
            raise AssertionError(f"{kernel} kernel disagrees with its plain "
                                 f"version on case {name}: {verdict}")
        if loop and loop["loop"] != loop["want_loop"]:
            raise AssertionError(f"K3 ran {loop['loop']} on case {name}, "
                                 f"not {loop['want_loop']}")
        worst = max(worst, verdict["max_abs_err"])
    if kernel == "paged_scan":
        worst = max(worst, paged_upsert_parity(seed0 + len(cases), dev))
    return worst


def paged_upsert_parity(seed, dev="cuda"):
    """K3 on a serving-shaped uint8 pool (128-row pages, kf 10), then on
    the same pool after an upsert (fresh rows written into a free page that
    one list's chain takes up, a tombstone in another), each launch against
    the twin on the pool as it then stands: nothing of the first launch
    may linger in the second."""
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    wrapper, plain = _kernel_pair("paged_scan")
    call, rows = synthetic_paged(seed, page_rows=128, table_width=16, ppf=8,
                                 kf=10, dev=dev)
    worst = 0.0
    for when in ("before", "after"):
        got = wrapper(**call, strip_rows=rows)
        verdict = compare(got, plain(**call), call["strip_list"], rows)
        emit({"phase": "parity", "kernel": "paged_scan",
              "case": f"upsert_between_launches_{when}",
              "loop": ss.PAGED_KERNEL.loop if dev != "cpu" else None,
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"K3 disagrees with its plain version "
                                 f"{when} an upsert: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
        if when == "after":
            break
        # the upsert: list 2's chain takes a free page of fresh rows (NaN
        # before: never chained), list 5 loses a row to a tombstone
        table = call["table_flat"].reshape(-1, call["table_width"]).clone()
        chain = call["chain_pages"].clone()
        used = torch.zeros(call["pages"].shape[0], dtype=torch.bool,
                           device=table.device)
        used[table[table >= 0].long()] = True
        used[0] = True
        free = int(torch.nonzero(~used)[0])
        pages, bias = call["pages"].clone(), call["bias_pool"].clone()
        g = torch.Generator(device=pages.device)
        g.manual_seed(seed + 1)
        pages[free] = torch.randint(0, 256, pages[free].shape, generator=g,
                                    device=pages.device).to(pages.dtype)
        bias[free] = torch.rand(bias[free].shape, generator=g,
                                device=bias.device) * 1000.0
        table[2, int(chain[2])] = free
        chain[2] += 1
        if int(chain[5]):
            bias[table[5, 0], 0] = float("inf")
        call.update(pages=pages.contiguous(), bias_pool=bias.contiguous(),
                    table_flat=table.reshape(-1).contiguous(),
                    chain_pages=chain.contiguous(),
                    sub_live=ss.paged_sub_live(
                        bias, table, chain, call["ppf"],
                        call["n_sub"]).contiguous())
    return worst


def class_calls(probes, a_rows, n_lists, cls_ord, classes, class_counts,
                q_tile, kf, lists, by_id=False):
    """The per-class keyword arguments one search hands its kernel: every
    query tile, planned on the static layout as the search plans it.
    ``lists`` holds the list-side operands and alpha. With ``by_id`` (K1,
    as ``_strip_tile_body`` hands it its operands) each call takes the
    tile's rows cast to bf16 once and the class's slice of the plan's
    ``qids``; without (K2), the class's slice of the grouped operand."""
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    calls = []
    q, p = probes.shape
    for start in range(0, q, q_tile):
        qt = min(q_tile, q - start)
        region_starts, s_tot, layout = ss.static_layout(classes, class_counts,
                                                       qt, p)
        qids, strip_list, _, _, _ = ss._plan_device(
            probes[start:start + qt], cls_ord, n_lists, region_starts, s_tot)
        tile = a_rows[start:start + qt]
        if by_id:
            a_tile = tile.to(torch.bfloat16).contiguous()
        else:
            a_grouped = ss.group_queries(tile, qids)
        strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
        for (wb, ns, st, count) in layout:
            seg = slice(st, st + count)
            operand = (dict(a=a_tile, qids=qids[seg]) if by_id
                       else dict(a=a_grouped[seg].contiguous()))
            calls.append(dict(strip_list=strip_list[seg].contiguous(),
                              w_blocks=wb, n_sub=ns, kf=kf, approx_ok=True,
                              strip_rows=strip_rows[seg], **operand,
                              **lists))
    return calls


def grouped_operand(c, strips=slice(None)):
    """A class call's grouped (S, C, dim) bf16 query operand over
    ``strips``: ``a`` itself, or, for a call that reads its rows by id,
    the rows its ``qids`` name (``group_queries``)."""
    from raft_tpu_torch.ops import strip_scan as ss

    if c.get("qids") is None:
        return c["a"][strips]
    return ss.group_queries(c["a"], c["qids"][strips])


def grouped_calls(calls):
    """The same class calls on the grouped operand, for a K1 library that
    reads no ``qids`` (an older tree's, in ``--ab``)."""
    return [dict({k: v for k, v in c.items() if k != "qids"},
                 a=grouped_operand(c).contiguous()) for c in calls]


def main_path_class_inputs(index, queries, n_probes, kf, res):
    """The per-class arguments a main-path IVF-PQ search hands K1."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    queries = queries.to(torch.float32)
    n_probes = min(n_probes, index.n_lists)          # as search clamps it
    probes, qr_scaled, bias, _ = ivf_pq._pq_search_prep(
        queries, index.centers, index.rotation, index.b_sum,
        index.decoded_scale, n_probes, "exact", True)
    classes, class_counts, cls_ord, q_tile = ivf_flat._ragged_plan_static(
        index, n_probes, kf, res, int(index.decoded.shape[-1]))
    qt = min(q_tile, queries.shape[0])
    return class_calls(probes, qr_scaled, index.n_lists, cls_ord, classes,
                       class_counts, qt, kf,
                       dict(list_data=index.decoded, bias=bias.contiguous(),
                            alpha=-2.0), by_id=True), qt


def bq_path_class_inputs(index, queries, n_probes, kf, res):
    """The per-class arguments a main-path IVF-BQ search hands K2."""
    import torch

    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat

    queries = queries.to(torch.float32)
    n_probes = min(n_probes, index.n_lists)          # as search clamps it
    l2 = index.metric in ("sqeuclidean", "euclidean")
    probes, qr, _ = ivf_bq._bq_search_prep(
        queries, index.centers, index.rotation, n_probes, "exact", l2,
        index.bits, index.rotation_kind)
    classes, class_counts, cls_ord, q_tile = ivf_flat._ragged_plan_static(
        index, n_probes, kf, res, index.rot_dim * index.bits)
    qt = min(q_tile, queries.shape[0])
    return class_calls(probes, qr, index.n_lists, cls_ord, classes,
                       class_counts, qt, kf,
                       dict(list_codes=index.list_codes,
                            scale=index.list_scale, bias=index.list_bias,
                            alpha=-2.0 if l2 else -1.0)), qt


def scan_bound(calls, bytes_per_col):
    """Least time for one search's launches of a strip kernel: each input
    read once (the query blocks of live strips; each probed list's live
    columns — finite bias — once, at ``bytes_per_col`` each), each output
    written once, against 2·rows·live_cols·dim tensor-core flops for the
    real query rows of live strips. Padding columns (+inf bias) decide
    nothing by a product and are not counted."""
    import torch

    from raft_tpu_torch.ops.strip_scan import MC

    nbytes = 0
    flops = 0
    seen = torch.zeros(0, dtype=torch.int64)
    for c in calls:
        sl = c["strip_list"]
        live = sl >= 0
        width = c["w_blocks"] * MC * c["n_sub"]
        dim = c["a"].shape[-1]
        live_cols = torch.isfinite(c["bias"][:, :width]).sum(1)   # per list
        lists = sl[live].long()
        rows = c["strip_rows"][live].to(torch.int64)       # per live strip
        flops += 2 * int((rows * live_cols[lists]).sum()) * dim
        probed = lists.unique().cpu()
        new = probed[~torch.isin(probed, seen)]
        seen = torch.cat([seen, new])
        nbytes += int(live_cols[new.to(lists.device)].sum()) * bytes_per_col
        nbytes += int(rows.sum()) * (dim * 2 + c["kf"] * 8)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def library_yardstick(c):
    """One batched bf16 matmul plus torch.topk over the class's live
    strips (their query rows grouped first where the call reads them by
    id) — K1's PyTorch yardstick; the port never calls it."""
    import torch

    live = c["strip_list"] >= 0
    lists = c["strip_list"][live].long()
    width = c["w_blocks"] * 512 * c["n_sub"]
    a = grouped_operand(c, live)
    step = max(1, (4 << 30) // max(1, a.shape[1] * width * 10))
    for s in range(0, lists.numel(), step):
        li = lists[s:s + step]
        b = c["list_data"][li, :width].to(torch.bfloat16)
        sc = torch.matmul(a[s:s + step], b.transpose(1, 2)).float()
        sc = c["alpha"] * sc + c["bias"][li, :width][:, None, :]
        torch.topk(sc, c["kf"], dim=2, largest=False)


def bq_library_yardstick(c):
    """K2's PyTorch yardstick over the class's live strips: unpack the
    codes to ±1 bf16 with torch ops, one batched matmul, ·scale + bias,
    torch.topk. The port never calls it."""
    import torch

    live = c["strip_list"] >= 0
    lists = c["strip_list"][live].long()
    width = c["w_blocks"] * 512 * c["n_sub"]
    a = c["a"][live]
    step = max(1, (4 << 30) // max(1, a.shape[1] * width * 10))
    for s in range(0, lists.numel(), step):
        li = lists[s:s + step]
        packed = c["list_codes"][li, :width].to(torch.int32)
        bits = torch.cat([(packed >> j) & 1 for j in range(8)], dim=-1)
        b = (2 * bits - 1).to(torch.bfloat16)
        sc = torch.matmul(a[s:s + step], b.transpose(1, 2)).float()
        sc = (c["alpha"] * sc * c["scale"][li, :width][:, None, :]
              + c["bias"][li, :width][:, None, :])
        torch.topk(sc, c["kf"], dim=2, largest=False)


# ---------------------------------------------------------------------------
# Filtered rungs: the bench's filtered section (bench.py:728-869) on every
# path, through the path's own entry points
# ---------------------------------------------------------------------------

FILTER_SEED = 13             # bench.py's filtered section: default_rng(13)
SELECTIVITIES = (0.10, 0.01)
FILTER_RECALL_GATE = 0.90    # scripts/filter_smoke.py's gate at 10%


def filter_ladder(shared):
    """The bench's masks, made once for every path: one
    ``default_rng(13)``, 10% then 1% of the rows, ids 0..9 always pass;
    each with its Bitset on the card and its ground truth, the port's
    brute force over the surviving rows. Also an all-fail Bitset and a
    permutation of the 1% mask at the same popcount."""
    if "filters" in shared:
        return shared["filters"]
    import numpy as np
    import torch

    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import brute_force

    dataset, qs = shared["dataset"], shared["queries"]
    dev = dataset.device
    n = dataset.shape[0]
    rng = np.random.default_rng(FILTER_SEED)
    t = time.perf_counter()
    rungs = []
    for sel in SELECTIVITIES:
        mask = rng.random(n) < sel
        mask[:K] = True
        surv = torch.from_numpy(np.flatnonzero(mask)).to(dev)
        _, gi = brute_force.search(brute_force.build(dataset[surv],
                                                     device=dev), qs, K,
                                   device=dev)
        rungs.append({"selectivity": sel, "survivors": int(mask.sum()),
                      "mask": torch.from_numpy(mask).to(dev),
                      "bitset": Bitset.from_mask(mask, device=dev),
                      "gt": surv[gi.long()]})
    perm = rng.permutation(rungs[-1]["mask"].cpu().numpy())
    perm[:K] = True
    if dev.type == "cuda":
        torch.cuda.synchronize()
    shared["filters"] = {"rungs": rungs, "perm01": perm,
                         "none": Bitset.create(n, False, device=dev)}
    emit({"phase": "filters.setup", "seed": FILTER_SEED, "rows": n,
          "survivors": [r["survivors"] for r in rungs],
          "ground_truth_s": time.perf_counter() - t})
    return shared["filters"]


def id_recall(ids, gt) -> float:
    """recall@K by id (bench.py's ``_id_recall``): the share of each row's
    ground-truth ids found."""
    return float((ids.long()[:, :, None] == gt.long()[:, None, :]).any(2)
                 .float().mean())


def host_qps(fn, q, batches=3):
    """QPS over ``batches`` calls of ``fn`` on ``q`` queries, each timed on
    the host clock to its synchronize → (qps, batch seconds)."""
    import torch

    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return batches * q / sum(times), times


def filtered_rungs(shared, path, run, counter, widened,
                   gate=FILTER_RECALL_GATE, gathered=None):
    """``run(filter) → (values, ids)``, the path's own search (+ refine),
    unfiltered then at 10% and 1% selectivity: recall@10 against the
    survivors, the widened plan (``widened(filter)``), QPS beside the
    unfiltered QPS of the same call, and the path's kernel launches
    (``counter``, reset just before the first filtered search). Asserts no
    returned id fails its mask, the kernel ran, recall ≥ ``gate`` at 10%
    (None: printed only), and an all-fail filter gives ids -1, values
    +inf. ``gathered`` (K1's paths: ``STRIP_KERNEL_GATHERED``): the
    launches of K1's gathered walk, asserted to be all of the filtered
    search's K1 launches."""
    import torch

    ladder = filter_ladder(shared)
    q = shared["queries"].shape[0]
    base_qps, base_s = host_qps(lambda: run(None), q)
    rows = []
    for rung in ladder["rungs"]:
        f = rung["bitset"]
        reset_counts()
        v, i = run(f)
        torch.cuda.synchronize()
        launches = counter.launches
        walk = {}
        if gathered is not None:
            walk = {"gathered_launches": gathered.launches}
        ids = i.long()
        failed = int((~rung["mask"][ids[ids >= 0]]).sum())
        rec = id_recall(i, rung["gt"])
        qps, batch_s = host_qps(lambda: run(f), q)
        row = {"phase": f"{path}.filtered",
               "selectivity": rung["selectivity"],
               "survivors": rung["survivors"], "recall": rec,
               **widened(f), "qps": qps, "batch_s": batch_s,
               "unfiltered_qps": base_qps, "unfiltered_batch_s": base_s,
               "qps_ratio": qps / base_qps, "launches": launches,
               "masked_ids_returned": failed,
               "short_rows": int((i < 0).any(1).sum()), **walk}
        emit(row)
        rows.append(row)
        if failed or launches <= 0:
            raise AssertionError(f"{path}.filtered: {failed} masked ids "
                                 f"returned, {launches} kernel launches")
        if walk and walk["gathered_launches"] != launches:
            raise AssertionError(f"{path}.filtered: {walk} against "
                                 f"{launches} K1 launches")
        if gate is not None and rung["selectivity"] == 0.10 and rec < gate:
            raise AssertionError(f"{path}.filtered: recall@10 {rec} < {gate} "
                                 "at 10% selectivity")
    v, i = run(ladder["none"])
    if not (bool((i == -1).all()) and bool(torch.isposinf(v).all())):
        raise AssertionError(f"{path}.filtered: an all-fail filter returned "
                             "ids or finite values")
    return rows


def probes_widened(n_probes, n_lists, k_fetch=None, refined_cap=None):
    """``widened`` of :func:`filtered_rungs` for a path probing
    ``n_probes`` of ``n_lists`` (and fetching ``k_fetch``; IVF-BQ's
    refined search widens it too, up to ``refined_cap``)."""
    from raft_tpu_torch.neighbors import _filtering

    def widened(f):
        np_eff, kf_eff, rate, widen = _filtering.widen_plan(
            f, n_probes, n_lists, k_fetch=k_fetch if refined_cap else None,
            k_cap=refined_cap)
        out = {"pass_rate": rate, "widen": widen, "n_probes": np_eff}
        if k_fetch is not None:
            out["k_fetch"] = kf_eff if refined_cap else k_fetch
        return out
    return widened


def reset_counts():
    """Every kernel's launch count to 0 (just before a path is driven)."""
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import strip_scan as ss

    ch.HOP_KERNEL.reset()
    ps.PQ_KERNEL.reset()
    ss.STRIP_KERNEL.reset()
    ss.STRIP_KERNEL_GATHERED.reset()
    bq.BQ_KERNEL.reset()
    ss.PAGED_KERNEL.reset()
    bq.PAGED_BQ_KERNEL.reset()


def shared_data(n=N_ROWS, q=N_QUERIES, dev="cuda"):
    """The dataset, the queries and their brute-force top-10, made once
    for both paths."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.bench.datasets import sift_like
    from raft_tpu_torch.neighbors import brute_force

    res = Resources(device=dev)
    t = time.perf_counter()
    data, queries = sift_like(n, 128, q, seed=0)
    gen_s = time.perf_counter() - t
    dataset = torch.from_numpy(data).to(dev)
    qs = torch.from_numpy(queries).to(dev)
    t = time.perf_counter()
    gt_v, gt_i = brute_force.search(brute_force.build(dataset, res=res), qs, K,
                                    res=res)
    torch.cuda.synchronize()
    return {"dataset": dataset, "queries": qs, "gt": (gt_v, gt_i),
            "host": data,
            "data_gen_s": gen_s, "ground_truth_s": time.perf_counter() - t}


def class_width(c) -> int:
    """Columns per sub-block of a class call: w_blocks·512, or ppf·R for
    the paged kernels."""
    return c["ppf"] * c["page_rows"] if "ppf" in c else c["w_blocks"] * 512


def kernel_parity_at(calls, kernel, case):
    """The kernel against its twin on a search's own class inputs."""
    wrapper, plain = _kernel_pair(kernel)
    worst = 0.0
    for c in calls:
        verdict = compare(wrapper(**c), plain(**c), c["strip_list"],
                          c["strip_rows"])
        emit({"phase": "parity", "kernel": kernel,
              "case": f"{case}_w{class_width(c)}",
              "strips": int((c["strip_list"] >= 0).sum()), **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version on the main path: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
    return worst


def kernel_timing(calls, kernel, yardstick, bytes_per_col, bound=None):
    """One search's worth of a kernel's launches: its time, by class (w,
    n_sub), its twin's, the yardstick's, and the bound (``scan_bound`` for
    the packed kernels, ``paged_scan_bound`` for the paged ones)."""
    wrapper, plain = _kernel_pair(kernel)
    k_ms = cuda_ms(lambda: [wrapper(**c) for c in calls])
    by_class = {}
    for c in calls:       # classes of all query tiles, summed per class
        key = (class_width(c), c["n_sub"])
        by_class[key] = by_class.get(key, 0.0) + cuda_ms(lambda c=c: wrapper(**c))
    p_ms = cuda_ms(lambda: [plain(**c) for c in calls], reps=3)
    l_ms = cuda_ms(lambda: [yardstick(c) for c in calls], reps=3)
    bound_ms, bound_by, nbytes, flops = (bound or scan_bound)(calls,
                                                              bytes_per_col)
    return {"ms": k_ms, "ms_by_class": [[w, ns, ms] for (w, ns), ms
                                        in sorted(by_class.items())],
            "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "launches_per_search": len(calls)}


# a strip kernel's wrapper module, the module's launcher getter and the
# symbol of its product-only instantiation (None where there is none)
STRIP_LAUNCHERS = {
    "strip_scan": ("strip_scan", "_kernel_fn", "raft_strip_scan_product"),
    "bq_scan": ("bq_scan", "_kernel_fn", "raft_bq_scan_product"),
    "paged_scan": ("strip_scan", "_paged_kernel_fn",
                   "raft_paged_scan_product"),
    "paged_bq_scan": ("bq_scan", "_paged_kernel_fn",
                      "raft_paged_bq_scan_product"),
}


def launcher_of(kernel):
    """(wrapper module, launcher getter name, product-only symbol) of a
    strip kernel."""
    import importlib

    mod, getter, product = STRIP_LAUNCHERS[kernel]
    return importlib.import_module(f"raft_tpu_torch.ops.{mod}"), getter, \
        product


def product_loops(calls, kernel):
    """The product loops (``_native.PRODUCT_LOOPS``) a strip kernel's
    launches run at these class inputs, as each launch reports its own."""
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss

    counter = {"bq_scan": bq.BQ_KERNEL,
               "paged_scan": ss.PAGED_KERNEL,
               "paged_bq_scan": bq.PAGED_BQ_KERNEL}[kernel]
    wrapper = _kernel_pair(kernel)[0]
    loops = set()
    for c in calls:
        wrapper(**c)
        loops.add(counter.loop)
    return sorted(loops)


def check_ring(loops, what):
    """K3 at a serving input (byte pages of 128 rows) runs the ring loop."""
    if loops != ["ring"]:
        raise AssertionError(f"{what}: K3 ran {loops}, not the ring loop")


def check_wgmma(loops, nb, what):
    """A packed code row of a multiple of 8 bytes runs the wgmma loop."""
    if nb % 8 == 0 and loops != ["wgmma"]:
        raise AssertionError(f"{what}: nb {nb} ran {loops}, not wgmma")


def kernel_split(calls, phase, kernel="strip_scan", **info):
    """A strip kernel's time at one search's class inputs split into
    product and selection: the kernel, and the product-only instantiation
    of the same template (the same plan, tiles and score epilogue, no
    selection, no output), in the order full, product, product, full. The
    selection's share is the difference."""
    from raft_tpu_torch.ops import _native

    mod, getter, product = launcher_of(kernel)
    wrapper = _kernel_pair(kernel)[0]
    saved = getattr(mod, getter)
    full_fn = saved()
    prod_fn = getattr(_native.load(kernel), product)
    prod_fn.argtypes, prod_fn.restype = full_fn.argtypes, full_fn.restype
    times = {"full": [], "product": []}
    for which in ("full", "product", "product", "full"):
        fn = full_fn if which == "full" else prod_fn
        setattr(mod, getter, lambda fn=fn: fn)
        times[which].append(cuda_ms(lambda: [wrapper(**c) for c in calls]))
    setattr(mod, getter, saved)
    full = sum(times["full"]) / 2
    product = sum(times["product"]) / 2
    out = {"full_ms": full, "product_ms": product,
           "selection_ms": full - product,
           "selection_share": (full - product) / full, "order": times}
    emit({"phase": phase, **info, **out})
    return out


def main_phase(shared, n_lists=N_LISTS, dev="cuda"):
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    n, q = dataset.shape[0], qs.shape[0]
    before = allocated()
    t = time.perf_counter()
    index = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
        n_lists=n_lists, pq_dim=64, pq_bits=8,
        kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cost_row("ivf_pq", index, before)
    emit({"phase": "main.setup", "rows": n, "queries": q,
          "n_lists": n_lists, "max_list_size": index.max_list_size,
          "data_gen_s": shared["data_gen_s"],
          "ground_truth_s": shared["ground_truth_s"], "build_s": build_s})

    def run(kf, n_probes):
        _, cand = ivf_pq.search(index, qs, kf, n_probes=n_probes,
                                backend="ragged", res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    reset_counts()
    pick = pq_escalate(run, lambda v, i: neighborhood_recall(i, gt_i, v, gt_v),
                       "main.escalate")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = run(pick["k_fetch"], pick["n_probes"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = ss.STRIP_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("main path returned non-finite or misshapen results")
    if rec < 0.95:
        raise AssertionError(f"recall@10 {rec} < 0.95 at {pick}")
    if launches <= 0:
        raise AssertionError("the main path never launched the strip kernel")
    search_ms = cuda_ms(lambda: ivf_pq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"],
        backend="ragged", res=res), reps=3)
    _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                            n_probes=pick["n_probes"], backend="ragged",
                            res=res)
    refine_ms = cuda_ms(lambda: refine.refine(dataset, qs, cand, K, res=res),
                        reps=3)
    HELD["recall.main"] = (dict(pick), rec)
    emit({"phase": "main.search", **pick, "recall_final": rec,
          "qps": len(times) * q / sum(times), "batch_s": times, "search_ms": search_ms,
          "refine_ms": refine_ms, "k1_launches": launches})

    # K1 at the main path's own class inputs: parity at every k_fetch of the
    # escalation, timing at the chosen one
    max_err = 0.0
    for kf in (4 * K, 2 * K, K):
        calls, _ = main_path_class_inputs(index, qs, pick["n_probes"], kf, res)
        max_err = max(max_err, kernel_parity_at(
            calls, "strip_scan", f"main_path_nprobe{pick['n_probes']}_kf{kf}"))
    calls, qt = main_path_class_inputs(index, qs, pick["n_probes"],
                                       pick["k_fetch"], res)
    timing = kernel_timing(calls, "strip_scan", library_yardstick,
                           int(index.decoded.shape[-1]) + 4)
    emit({"phase": "main.k1", "n_probes": pick["n_probes"],
          "kf": pick["k_fetch"], "query_tile": qt,
          "classes": [[c["w_blocks"] * 512, c["n_sub"],
                       int((c["strip_list"] >= 0).sum())] for c in calls],
          **timing})
    kernel_split(calls, "main.k1_split", kf=pick["k_fetch"],
                 list_dtype="int8", tournament=True)
    keep_for_ab(("strip_scan", f"main_int8_kf{pick['k_fetch']}"), calls)
    del calls
    k1_filtered_sweep("main", index, qs, pick["n_probes"], pick["k_fetch"],
                      res, main_path_class_inputs)

    def frun(f):
        _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                                n_probes=pick["n_probes"], backend="ragged",
                                filter=f, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    filtered_rungs(shared, "main", frun, ss.STRIP_KERNEL, probes_widened(
        pick["n_probes"], n_lists, pick["k_fetch"]),
        gathered=ss.STRIP_KERNEL_GATHERED)
    obs_rung("main", lambda: ivf_pq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"],
        backend="ragged", res=res), q, "ivf_pq::search", "ivf_pq::scan",
        "ivf_pq.search", "backend.ragged", ss.STRIP_KERNEL)
    if AB_INPUTS is not None:
        AB_FILES.mkdir(parents=True, exist_ok=True)
        index.save(AB_FILES / "main.index")
        torch.save(qs.cpu(), AB_FILES / "main_queries.pt")
        AB_INPUTS["main"] = (AB_FILES / "main.index",
                             AB_FILES / "main_queries.pt", pick)
    return {"launches": launches, "max_abs_err": max_err,
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}, (index, pick)


def bq_gate_escalate(run_pair, recall_of, k: int, probe_ladder) -> dict:
    """The JAX bench's IVF-BQ recall-gate protocol (``bench.py``'s
    ``_bq_gate_escalate``, copied): escalate n_probes at a 4·k over-fetch
    first, then widen the over-fetch at the best n_probes until the exact
    re-rank holds the 0.95 gate, capped at 512. Every step is emitted."""
    best = None
    tried = []

    def step(nprobe, kf):
        rec = recall_of(*run_pair(nprobe, kf))
        tried.append(kf)
        emit({"phase": "bq.escalate", "n_probes": int(nprobe), "k_fetch": kf,
              "recall": rec})
        return rec

    for nprobe in probe_ladder:
        kf = min(4 * k, 512)
        rec = step(nprobe, kf)
        if best is None or rec > best["recall"]:
            best = {"n_probes": int(nprobe), "recall": round(rec, 4),
                    "k_fetch": kf}
        if rec >= 0.95:
            break
    if best["recall"] < 0.95:
        for kf in (8 * k, 16 * k, 32 * k):
            kf = min(kf, 512)
            rec = step(best["n_probes"], kf)
            if rec > best["recall"]:
                best.update(recall=round(rec, 4), k_fetch=kf)
            if rec >= 0.95:
                break
    best["k_fetch_tried"] = sorted(set(tried))
    return best


def bq_phase(shared, n_lists=N_LISTS, dev="cuda"):
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_bq, refine
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    n, q = dataset.shape[0], qs.shape[0]
    before = allocated()
    t = time.perf_counter()
    index = ivf_bq.build(dataset, ivf_bq.IvfBqParams(
        n_lists=n_lists, kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cost_row("ivf_bq", index, before)
    emit({"phase": "bq.setup", "rows": n, "queries": q, "n_lists": n_lists,
          "max_list_size": index.max_list_size, "rot_dim": index.rot_dim,
          "bits": index.bits, "rotation_kind": index.rotation_kind,
          "code_bytes_per_row": index.code_bytes_per_row, "build_s": build_s})

    def run(n_probes, kf):
        _, cand = ivf_bq.search(index, qs, kf, n_probes=n_probes, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    reset_counts()
    pick = bq_gate_escalate(
        run, lambda v, i: neighborhood_recall(i, gt_i, v, gt_v), K,
        (16, 32, 64, 128, 256))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = run(pick["n_probes"], pick["k_fetch"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = bq.BQ_KERNEL.launches
    k1_launches = ss.STRIP_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("the BQ path returned non-finite or misshapen "
                             "results")
    if rec < 0.95:
        raise AssertionError(f"BQ recall@10 {rec} < 0.95 at {pick}")
    if launches <= 0:
        raise AssertionError("the BQ path never launched the packed kernel")
    search_ms = cuda_ms(lambda: ivf_bq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"], res=res), reps=3)
    _, cand = ivf_bq.search(index, qs, pick["k_fetch"],
                            n_probes=pick["n_probes"], res=res)
    refine_ms = cuda_ms(lambda: refine.refine(dataset, qs, cand, K, res=res),
                        reps=3)
    HELD["recall.bq"] = (dict(pick), rec)
    emit({"phase": "bq.search", **pick, "recall_final": rec,
          "qps": len(times) * q / sum(times), "batch_s": times,
          "search_ms": search_ms, "refine_ms": refine_ms, "build_s": build_s,
          "code_bytes_per_row": index.code_bytes_per_row,
          "k2_launches": launches, "k1_launches": k1_launches})

    # K2 at the path's own class inputs: parity at every k_fetch the
    # escalation ran (at the chosen n_probes), timing at the chosen one
    max_err = 0.0
    for kf in pick["k_fetch_tried"]:
        calls, _ = bq_path_class_inputs(index, qs, pick["n_probes"], kf, res)
        max_err = max(max_err, kernel_parity_at(
            calls, "bq_scan", f"bq_path_nprobe{pick['n_probes']}_kf{kf}"))
        del calls
    calls, qt = bq_path_class_inputs(index, qs, pick["n_probes"],
                                     pick["k_fetch"], res)
    keep_for_ab(("bq_scan", f"bq_kf{pick['k_fetch']}"), calls)
    timing = kernel_timing(calls, "bq_scan", bq_library_yardstick,
                           index.code_bytes_per_row + 8)
    loops = product_loops(calls, "bq_scan")
    emit({"phase": "bq.k2", "n_probes": pick["n_probes"],
          "kf": pick["k_fetch"], "query_tile": qt, "loop": "/".join(loops),
          "strips": sum(int((c["strip_list"] >= 0).sum()) for c in calls),
          **timing})
    check_wgmma(loops, index.code_bytes_per_row, "bq.k2")
    kernel_split(calls, "bq.k2_split", "bq_scan", kf=pick["k_fetch"],
                 n_probes=pick["n_probes"])
    del calls
    ratio = pick["k_fetch"] // K

    def frun(f):
        return ivf_bq.search_refined(index, dataset, qs, K,
                                     n_probes=pick["n_probes"],
                                     refine_ratio=ratio, filter=f, res=res)

    filtered_rungs(shared, "bq", frun, bq.BQ_KERNEL, probes_widened(
        pick["n_probes"], n_lists, pick["k_fetch"], refined_cap=512))

    # extend with the queries under ids n + i, then find each of them
    t = time.perf_counter()
    ext = ivf_bq.extend(index, qs, new_ids=torch.arange(
        n, n + q, dtype=torch.int32, device=qs.device), res=res)
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t
    reset_counts()
    _, ie = ivf_bq.search_refined(ext, torch.cat([dataset, qs]), qs, K,
                                  n_probes=pick["n_probes"],
                                  refine_ratio=ratio, res=res)
    torch.cuda.synchronize()
    ext_launches = bq.BQ_KERNEL.launches
    own = torch.arange(n, n + q, device=ie.device)[:, None]
    readback = float((ie == own).any(dim=1).float().mean())
    emit({"phase": "bq.extend", "rows_added": q, "extend_s": extend_s,
          "max_list_size": ext.max_list_size, "size": ext.size,
          "readback_after_refine": readback, "k2_launches": ext_launches})
    if readback < 0.99 or ext_launches <= 0 or ext.size != n + q:
        raise AssertionError(f"bq.extend: read-back {readback}, "
                             f"{ext_launches} K2 launches, size {ext.size}")
    del ext, ie
    obs_rung("bq", lambda: ivf_bq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"], res=res), q,
        "ivf_bq::search", "ivf_bq::scan", "ivf_bq.search", "backend.packed",
        bq.BQ_KERNEL)
    return {"launches": launches, "max_abs_err": max_err,
            "loop": "/".join(loops),
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}, (index, pick)


def bq_streaming_phase(shared, pick, n_lists=N_LISTS, dev="cuda"):
    """``ivf_bq.build_streaming`` from a host copy of the dataset in 4
    chunks of 250,000 rows at the bq path's parameters: build seconds by
    phase, the dropped-row accounting (asserted, not zero), recall@10 ≥
    0.95 after refine at the bq path's chosen point, and K2's launches."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs, host = shared["dataset"], shared["queries"], shared["host"]
    gt_v, gt_i = shared["gt"]
    n, dim = host.shape
    q = qs.shape[0]
    t = time.perf_counter()
    index = ivf_bq.build_streaming(
        lambda s, e: host[s:e], n, dim, ivf_bq.IvfBqParams(
            n_lists=n_lists, kmeans_trainset_fraction=0.2),
        res=res, chunk_rows=STREAM_CHUNK_ROWS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    emit({"phase": "bq.streaming.setup", "rows": n, "n_lists": n_lists,
          "chunks": -(-n // STREAM_CHUNK_ROWS),
          "max_list_size": index.max_list_size,
          "streaming_dropped": index._streaming_dropped,
          "code_bytes_per_row": index.code_bytes_per_row,
          "build_s": build_s, "build_phases_s": index.build_timings_s})
    check_dropped(index, dataset, 512)
    ratio = pick["k_fetch"] // K

    def run():
        return ivf_bq.search_refined(index, dataset, qs, K,
                                     n_probes=pick["n_probes"],
                                     refine_ratio=ratio, res=res)

    reset_counts()
    v, i = run()
    torch.cuda.synchronize()
    launches = bq.BQ_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    qps, batch_s = host_qps(run, q)
    emit({"phase": "bq.streaming", "n_probes": pick["n_probes"],
          "k_fetch": pick["k_fetch"], "recall": rec, "qps": qps,
          "batch_s": batch_s, "k2_launches": launches})
    if rec < 0.95 or launches <= 0:
        raise AssertionError(f"bq.streaming: recall@10 {rec}, {launches} K2 "
                             "launches")
    del index
    torch.cuda.empty_cache()


BRUTE_METRICS = ("sqeuclidean", "inner_product", "cosine", "l1")
BRUTE_ROWS, BRUTE_QUERIES = 100_000, 1_000


def brute_metrics_phase(shared, dev="cuda"):
    """Brute force in four metrics on 100,000 rows × 1,000 queries of the
    dataset against ``pairwise_distance`` + ``torch.topk``: ids equal
    except at near-ties."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.distance import pairwise_distance
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    data = shared["dataset"][:BRUTE_ROWS].float()
    qs = shared["queries"][:BRUTE_QUERIES].float()
    for metric in BRUTE_METRICS:
        index = brute_force.build(data, metric, res=res)
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = brute_force.search(index, qs, K, res=res)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t
        t = time.perf_counter()
        d = pairwise_distance(qs, data, metric, res=res)
        largest = metric == "inner_product"
        pv, pi = torch.topk(d, K, dim=1, largest=largest, sorted=True)
        torch.cuda.synchronize()
        pairwise_s = time.perf_counter() - t
        sign = -1.0 if largest else 1.0     # topk_agreement ranks ascending
        # uint8 rows give integer l1 distances, which tie often and which
        # torch.topk orders arbitrarily: any share of ids may differ, each
        # only where the two values tie
        verdict = topk_agreement(sign * pv, pi, sign * v, i,
                                 rtol=1e-5, atol=1e-5 * float(pv.abs().max()),
                                 tie_rtol=1e-5, max_mismatch=1.0)
        emit({"phase": "brute.metrics", "metric": metric, "rows": BRUTE_ROWS,
              "queries": BRUTE_QUERIES, "search_s": search_s,
              "pairwise_topk_s": pairwise_s, **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"brute force {metric} disagrees with "
                                 f"pairwise_distance + topk: {verdict}")
        del d


SERVE_PLAN_PAGE_ROWS = 128   # the bench serving section's page height
WINDOW_ROUNDS = 64           # mutation window: rounds of
UPSERT_ROWS = 32             # upsert 32 rows, search 64 queries, delete
DELETE_LAG = 8               # the batch upserted 8 rounds earlier (FIFO)
UPSERT_ID0 = 1_000_000


def flat_phase(shared, n_lists=N_LISTS, dev="cuda"):
    """IVF-Flat at the bench's parameters on uint8 lists: the escalation
    n_probes 16…256 at k = 10 until recall@10 ≥ 0.95 (no refine: uint8
    distances are exact in bf16 × bf16 → fp32), QPS over three batches,
    K1's launches, then K1 at the path's own class inputs."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    q = qs.shape[0]
    before = allocated()
    t = time.perf_counter()
    index = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(
        n_lists=n_lists, kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cost_row("ivf_flat", index, before)
    emit({"phase": "flat.setup", "rows": dataset.shape[0], "n_lists": n_lists,
          "list_dtype": str(index.list_data.dtype).replace("torch.", ""),
          "max_list_size": index.max_list_size, "build_s": build_s})
    reset_counts()
    pick = None
    for n_probes in (16, 32, 64, 128, 256):
        v, i = ivf_flat.search(index, qs, K, n_probes=n_probes, res=res)
        rec = neighborhood_recall(i, gt_i, v, gt_v)
        emit({"phase": "flat.escalate", "n_probes": n_probes, "recall": rec})
        pick = {"n_probes": n_probes, "recall": rec}
        if rec >= 0.95:
            break
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = ivf_flat.search(index, qs, K, n_probes=pick["n_probes"],
                               res=res)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = ss.STRIP_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("IVF-Flat returned non-finite or misshapen results")
    if rec < 0.95:
        raise AssertionError(f"IVF-Flat recall@10 {rec} < 0.95 at {pick}")
    if launches <= 0:
        raise AssertionError("the IVF-Flat path never launched K1")
    HELD["recall.flat"] = (dict(pick), rec)
    emit({"phase": "flat.search", **pick, "recall_final": rec,
          "qps": len(times) * q / sum(times), "batch_s": times,
          "k1_launches_uint8": launches})
    calls, qt = flat_path_class_inputs(index, qs, pick["n_probes"], K, res)
    kernel_parity_at(calls, "strip_scan",
                     f"flat_path_nprobe{pick['n_probes']}_kf{K}")
    timing = kernel_timing(calls, "strip_scan", library_yardstick,
                           index.dim + 4)
    emit({"phase": "flat.k1", "n_probes": pick["n_probes"], "kf": K,
          "query_tile": qt, "list_dtype": "uint8",
          "classes": [[c["w_blocks"] * 512, c["n_sub"],
                       int((c["strip_list"] >= 0).sum())] for c in calls],
          **timing})
    kernel_split(calls, "flat.k1_split", kf=K, list_dtype="uint8",
                 tournament=False)
    keep_for_ab(("strip_scan", f"flat_uint8_kf{K}"), calls)
    k1_filtered(index, calls, pick)
    del calls
    k1_filtered_sweep("flat", index, qs, pick["n_probes"], K, res,
                      flat_path_class_inputs)

    def frun(f):
        return ivf_flat.search(index, qs, K, n_probes=pick["n_probes"],
                               filter=f, res=res)

    filtered_rungs(shared, "flat", frun, ss.STRIP_KERNEL, probes_widened(
        pick["n_probes"], n_lists), gathered=ss.STRIP_KERNEL_GATHERED)

    # extend with the queries under ids n + i: each finds itself through K1
    n = dataset.shape[0]
    t = time.perf_counter()
    ext = ivf_flat.extend(index, qs, new_ids=torch.arange(
        n, n + q, dtype=torch.int32, device=qs.device), res=res)
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t
    reset_counts()
    _, ie = ivf_flat.search(ext, qs, K, n_probes=pick["n_probes"], res=res)
    torch.cuda.synchronize()
    ext_launches = ss.STRIP_KERNEL.launches
    own = torch.arange(n, n + q, device=ie.device)[:, None]
    readback = float((ie == own).any(dim=1).float().mean())
    emit({"phase": "flat.extend", "rows_added": q, "extend_s": extend_s,
          "list_dtype": str(ext.list_data.dtype).replace("torch.", ""),
          "max_list_size": ext.max_list_size, "size": ext.size,
          "readback": readback, "k1_launches": ext_launches})
    if readback < 1.0 or ext_launches <= 0 or ext.size != n + q:
        raise AssertionError(f"flat.extend: read-back {readback}, "
                             f"{ext_launches} K1 launches, size {ext.size}")
    del ext, ie
    obs_rung("flat", lambda: ivf_flat.search(
        index, qs, K, n_probes=pick["n_probes"], res=res), q,
        "ivf_flat::search", "ivf_flat::scan", "ivf_flat.search",
        "backend.ragged", ss.STRIP_KERNEL)
    return index, pick, (v, i)


def k1_filtered(index, calls, pick):
    """K1 at the flat path's own class inputs with the bias of a filter
    that passes only the rows of even-numbered lists (every odd list's
    sub-blocks dead), and of one that passes nothing (every sub-block
    dead), against the same inputs unfiltered: parity with the twin, then
    the three times in the order unfiltered, even, none, none, even,
    unfiltered. Dead sub-blocks should cost K1 about nothing."""
    import torch

    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors._filtering import apply_filter_bias
    from raft_tpu_torch.ops import strip_scan as ss

    ids = index.list_ids
    even = (torch.arange(index.n_lists, device=ids.device)[:, None] % 2 == 0
            ) & (ids >= 0)
    mask = torch.zeros(index.size, dtype=torch.bool, device=ids.device)
    mask[ids[even].long()] = True
    variants = {"unfiltered": calls}
    for name, f in (("even", Bitset.from_mask(mask)),
                    ("none", Bitset.create(index.size, False,
                                           device=ids.device))):
        bias = apply_filter_bias(calls[0]["bias"], ids, f)
        variants[name] = [dict(c, bias=bias) for c in calls]
    err = kernel_parity_at(variants["even"], "strip_scan",
                           f"flat_path_filtered_even_lists_nprobe"
                           f"{pick['n_probes']}_kf{K}")
    err = max(err, kernel_parity_at(variants["none"], "strip_scan",
                                    f"flat_path_filtered_none_nprobe"
                                    f"{pick['n_probes']}_kf{K}"))
    wrapper = _kernel_pair("strip_scan")[0]
    times = {name: [] for name in variants}
    for name in ("unfiltered", "even", "none", "none", "even", "unfiltered"):
        cs = variants[name]
        times[name].append(cuda_ms(lambda cs=cs: [wrapper(**c) for c in cs]))
    dead = {name: float(sum(
        int((ss.sub_block_liveness(c["bias"], c["w_blocks"] * 512,
                                   c["n_sub"]) == 0).sum()) for c in cs[:1]))
        / float(cs[0]["bias"].shape[0] * cs[0]["n_sub"])
        for name, cs in variants.items()}
    emit({"phase": "flat.k1_filtered", "n_probes": pick["n_probes"], "kf": K,
          "pass_rate_even": float(mask.float().mean()),
          "dead_sub_block_share": dead,
          "ms": {name: sum(t) / 2 for name, t in times.items()},
          "order": times, "launches_per_search": len(calls),
          "max_abs_err": err})


#: the pass rates of the gathered walk's sweep (``k1_filtered_sweep``)
FILTER_SWEEP_RATES = (0.10, 0.25, 0.50, 0.75, 0.90)


def k1_filtered_sweep(path, index, queries, n_probes, kf, res,
                      class_inputs):
    """K1 at a path's class inputs (``class_inputs``, e.g.
    :func:`main_path_class_inputs`) under filters passing a random share r
    of the rows (``default_rng(23)``), r in :data:`FILTER_SWEEP_RATES`, at
    the n_probes the search widens to: the dense walk (the main path's
    tournament at kf 20) and the gathered walk the search takes, each held
    against its twin; the gathered walk
    against the dense walk with exact selection, bit for bit on every
    finite slot; each walk's K1 and gathered launches counted over one
    search's calls; then the two timed in the order dense, gathered,
    gathered, dense. One row ``<path>.k1_filtered<100 r>`` a rate."""
    import numpy as np
    import torch

    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import _filtering
    from raft_tpu_torch.ops import strip_scan as ss

    wrapper = _kernel_pair("strip_scan")[0]
    for r in FILTER_SWEEP_RATES:
        mask = np.random.default_rng(23).random(index.size) < r
        f = Bitset.from_mask(mask, device=index.list_ids.device)
        np_r, _, rate, _ = _filtering.widen_plan(f, n_probes, index.n_lists)
        calls, qt = class_inputs(index, queries, np_r, kf, res)
        bias = _filtering.apply_filter_bias(calls[0]["bias"], index.list_ids,
                                            f).contiguous()
        variants = {"dense": [dict(c, bias=bias) for c in calls]}
        variants["gathered"] = [dict(c, gathered=True)
                                for c in variants["dense"]]
        del calls
        case = f"{path}_path_filtered{round(100 * r)}_nprobe{np_r}_kf{kf}"
        err = max(kernel_parity_at(variants["dense"], "strip_scan",
                                   f"{case}_dense"),
                  kernel_parity_at(variants["gathered"], "strip_scan",
                                   f"{case}_gathered"))
        exact = True
        for c in variants["gathered"]:
            got = wrapper(**c)
            want = wrapper(**dict(c, gathered=False, approx_ok=False))
            slots = torch.arange(ss.C, device=bias.device)[None, :]
            rows = ((c["strip_list"] >= 0)[:, None]
                    & (slots < c["strip_rows"][:, None]))[:, :, None]
            fin = torch.isfinite(want[0]) & rows
            exact = exact and bool(
                torch.equal(fin, torch.isfinite(got[0]) & rows)
                and torch.equal(got[0][fin], want[0][fin])
                and torch.equal(got[1][fin], want[1][fin]))
        launches = {}
        for name, cs in variants.items():
            ss.STRIP_KERNEL.reset()
            ss.STRIP_KERNEL_GATHERED.reset()
            for c in cs:
                wrapper(**c)
            launches[name] = {"k1": ss.STRIP_KERNEL.launches,
                              "gathered": ss.STRIP_KERNEL_GATHERED.launches}
        times = {name: [] for name in variants}
        for name in ("dense", "gathered", "gathered", "dense"):
            cs = variants[name]
            times[name].append(cuda_ms(lambda cs=cs: [wrapper(**c)
                                                      for c in cs]))
        ms = {name: sum(t) / 2 for name, t in times.items()}
        emit({"phase": f"{path}.k1_filtered{round(100 * r)}",
              "n_probes": np_r, "kf": kf, "pass_rate": rate,
              "query_tile": qt, "launches": launches, "ms": ms,
              "gathered_over_dense": ms["gathered"] / ms["dense"],
              "order": times, "max_abs_err": err,
              "gathered_equals_dense_exact": exact})
        del variants
        if not exact:
            raise AssertionError(f"{path}.k1_filtered{round(100 * r)}: the "
                                 "gathered walk differs from the dense "
                                 "exact walk on a finite slot")
        if launches["gathered"]["gathered"] != launches["gathered"]["k1"] \
                or launches["dense"]["gathered"]:
            raise AssertionError(f"{path}.k1_filtered{round(100 * r)}: "
                                 f"launches {launches}")


def flat_path_class_inputs(index, queries, n_probes, kf, res):
    """The per-class arguments an IVF-Flat search hands K1 (uint8 rows)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    queries = queries.to(torch.float32)
    probes = ivf_flat._coarse_probes(queries, index.centers, n_probes,
                                     index.metric)
    bias = ivf_flat._ragged_bias(index.list_ids, index.list_norms, "l2")
    classes, class_counts, cls_ord, q_tile = ivf_flat._ragged_plan_static(
        index, n_probes, kf, res, index.dim)
    qt = min(q_tile, queries.shape[0])
    return class_calls(probes, queries, index.n_lists, cls_ord, classes,
                       class_counts, qt, kf,
                       dict(list_data=index.list_data, bias=bias,
                            alpha=-2.0), by_id=True), qt


def paged_class_inputs(snapshot, probes, a_rows, kf, row_bytes, q_tile,
                       alpha, codes=False):
    """The per-class arguments a paged search hands K3 (or, ``codes``,
    K4): every query tile planned on the capacity layout as the search
    plans it. ``snapshot`` is the store's ``paged_scan_state()``."""
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    payload, bias_pool, scale_pool, _, table, chain = snapshot
    plan, table_flat, chain, sub_live = ss.paged_scan_setup(
        payload, bias_pool, table, chain, probes, kf, row_bytes)
    calls = []
    for start in range(0, probes.shape[0], q_tile):
        qt = min(q_tile, probes.shape[0] - start)
        qids, strip_list, _, _, layout = plan(start, qt)
        a_grouped = ss.group_queries(a_rows[start:start + qt], qids)
        strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
        for (ppf, n_sub, st, count) in layout:
            c = dict(strip_list=strip_list[st:st + count].contiguous(),
                     table_flat=table_flat, chain_pages=chain,
                     sub_live=sub_live, a=a_grouped[st:st + count].contiguous(),
                     bias_pool=bias_pool, ppf=ppf, n_sub=n_sub,
                     page_rows=payload.shape[1], table_width=table.shape[1],
                     alpha=alpha, kf=kf,
                     strip_rows=strip_rows[st:st + count])
            if codes:
                c.update(codes=payload, scale_pool=scale_pool)
            else:
                c.update(pages=payload)
            calls.append(c)
    return calls


def serve_flat_inputs(store, qs, n_probes, kf, res):
    """The per-class arguments a paged IVF-Flat search of ``store`` hands
    K3 → (calls, query tile)."""
    from raft_tpu_torch.neighbors import ivf_flat

    probes = ivf_flat._coarse_probes(qs.float(), store.centers, n_probes,
                                     store.metric)
    q_tile = min(ivf_flat._paged_plan_static(store, n_probes, kf, res,
                                             store.dim), qs.shape[0])
    return paged_class_inputs(store.paged_scan_state(), probes, qs.float(),
                              kf, store.dim, q_tile, -2.0), q_tile


def paged_scan_bound(calls, bytes_per_col):
    """``scan_bound`` for the paged kernels: each probed list's live
    columns (finite-bias rows of its chained pages) read once at
    ``bytes_per_col``, the query blocks of live strips and the outputs
    once, and 2·rows·live_cols·dim flops for the real query rows."""
    import torch

    nbytes = 0
    flops = 0
    seen = torch.zeros(0, dtype=torch.int64)
    for c in calls:
        sl = c["strip_list"]
        live = sl >= 0
        table = c["table_flat"].reshape(-1, c["table_width"]).long()
        chain = c["chain_pages"].long()
        R = c["page_rows"]
        slot = torch.arange(table.shape[1], device=table.device)[None, :]
        fin = torch.isfinite(c["bias_pool"][table.clamp(min=0)]).sum(2)
        live_cols = torch.where((slot < chain[:, None]) & (table >= 0), fin,
                                0).sum(1)
        assert int(live_cols.max()) <= table.shape[1] * R
        dim = c["a"].shape[2]
        lists = sl[live].long()
        rows = c["strip_rows"][live].to(torch.int64)
        flops += 2 * int((rows * live_cols[lists]).sum()) * dim
        probed = lists.unique().cpu()
        new = probed[~torch.isin(probed, seen)]
        seen = torch.cat([seen, new])
        nbytes += int(live_cols[new.to(lists.device)].sum()) * bytes_per_col
        nbytes += int(rows.sum()) * (dim * 2 + c["kf"] * 8)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def paged_library_yardstick(c):
    """K3's (and, with codes, K4's) PyTorch yardstick over the class's live
    strips: gather each list's chained pages (up to the longest chain in
    the call), one batched bf16 matmul, the bias (+inf past the chain),
    torch.topk. The port never calls it."""
    import torch

    live = c["strip_list"] >= 0
    lists = c["strip_list"][live].long()
    table = c["table_flat"].reshape(-1, c["table_width"]).long()
    chain = c["chain_pages"].long()
    R = c["page_rows"]
    cmax = max(1, int(chain[lists].max())) if lists.numel() else 1
    a = c["a"][live]
    slot = torch.arange(cmax, device=table.device)
    step = max(1, (4 << 30) // max(1, a.shape[1] * cmax * R * 10))
    for s in range(0, lists.numel(), step):
        li = lists[s:s + step]
        pidx = table[li, :cmax].clamp(min=0)
        if "codes" in c:
            packed = c["codes"][pidx].reshape(li.numel(), cmax * R, -1).to(
                torch.int32)
            bits = torch.cat([(packed >> j) & 1 for j in range(8)], dim=-1)
            b = (2 * bits - 1).to(torch.bfloat16)
        else:
            b = c["pages"][pidx].reshape(li.numel(), cmax * R, -1).to(
                torch.bfloat16)
        sc = c["alpha"] * torch.matmul(a[s:s + step], b.transpose(1, 2)).float()
        if "codes" in c:
            sc = sc * c["scale_pool"][pidx].reshape(li.numel(), 1, cmax * R)
        bias = c["bias_pool"][pidx]
        bias = torch.where((slot[None, :] < chain[li][:, None])[:, :, None],
                           bias, float("inf")).reshape(li.numel(), 1, cmax * R)
        torch.topk(sc + bias, min(c["kf"], cmax * R), dim=2, largest=False)


def latency_ms(fn, n):
    """``n`` sequential calls, each timed on the host clock to its
    synchronize → (p50, p99) ms."""
    import torch

    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    lat.sort()
    return lat[len(lat) // 2], lat[min(len(lat) - 1, int(0.99 * len(lat)))]


def serve_phase(shared, flat_index, flat_pick, packed_out, dev="cuda"):
    """The serving data plane on the IVF-Flat index: a PagedListStore with
    128-row pages reserved for the mutation window; paged search through
    K3 (recall, agreement with the packed search, QPS, batch-1 and
    batch-64 latency); a 64-round window of upserts, searches and FIFO
    deletes; read-back, no deleted id, no growth; compact and
    compact_swap."""
    import torch

    from raft_tpu_torch import Resources, serving
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall, topk_agreement

    res = Resources(device=dev)
    qs = shared["queries"]
    gt_v, gt_i = shared["gt"]
    q = qs.shape[0]
    n_probes = flat_pick["n_probes"]
    before = allocated()
    t = time.perf_counter()
    store = serving.PagedListStore.from_index(
        flat_index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    store.reserve(WINDOW_ROUNDS * UPSERT_ROWS)
    store.device_table()        # built by the first search, counted now
    torch.cuda.synchronize()
    cost_row("serve.flat", store, before)
    ppf, n_sub, w = ss.paged_plan(store.table_width, store.page_rows,
                                  store.dim, K)
    chains = store._list_pages
    emit({"phase": "serve.setup", "store_s": time.perf_counter() - t,
          "plan": {"table_width": store.table_width, "ppf": ppf,
                   "n_sub": n_sub, "w": w},
          "chain_pages_mean": float(chains.mean()),
          "chain_pages_max": int(chains.max()), "stats": store.stats()})

    reset_counts()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = serving.search(store, qs, K, n_probes=n_probes, res=res)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    batch_launches = ss.PAGED_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    agreement = topk_agreement(packed_out[0], packed_out[1], v, i)
    if rec < 0.95 or not agreement["ok"]:
        raise AssertionError(f"paged search: recall {rec}, agreement with "
                             f"the packed search {agreement}")
    if batch_launches <= 0 or ss.STRIP_KERNEL.launches:
        raise AssertionError("the paged search did not run on K3 alone")
    one = qs[:1]
    p50_1, p99_1 = latency_ms(lambda: serving.search(store, one, K,
                                                     n_probes=n_probes,
                                                     res=res), 64)
    b64 = qs[:64]
    p50_64, p99_64 = latency_ms(lambda: serving.search(store, b64, K,
                                                       n_probes=n_probes,
                                                       res=res), 32)
    emit({"phase": "serve.search", "n_probes": n_probes, "recall": rec,
          "agreement_with_packed": agreement, "qps": len(times) * q / sum(times),
          "batch_s": times, "batch1_ms_p50": p50_1, "batch1_ms_p99": p99_1,
          "batch64_ms_p50": p50_64, "batch64_ms_p99": p99_64,
          "k3_launches_3_batches": batch_launches})

    # the mutation window: upsert 32 query vectors under ids 1,000,000 + i,
    # search the 64 newest of them, delete the batch of 8 rounds earlier
    growth0 = store.growth_events
    rows = qs[:WINDOW_ROUNDS * UPSERT_ROWS]
    up_ms, del_ms, fifo, deleted = [], [], [], []
    leaked = 0
    for r in range(WINDOW_ROUNDS):
        lo = r * UPSERT_ROWS
        ids = torch.arange(UPSERT_ID0 + lo, UPSERT_ID0 + lo + UPSERT_ROWS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        store.upsert(rows[lo:lo + UPSERT_ROWS], ids=ids)
        torch.cuda.synchronize()
        up_ms.append((time.perf_counter() - t) * 1e3)
        fifo.append(ids)
        hi = lo + UPSERT_ROWS
        _, got = serving.search(store, rows[max(0, hi - 64):hi], K,
                                n_probes=n_probes, res=res)
        if deleted:
            leaked += int(torch.isin(got.cpu().long(),
                                     torch.cat(deleted)).sum())
        if len(fifo) > DELETE_LAG:
            gone = fifo.pop(0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            store.delete(gone)
            torch.cuda.synchronize()
            del_ms.append((time.perf_counter() - t) * 1e3)
            deleted.append(gone)
    live = torch.cat(fifo)
    live_rows = rows[(live - UPSERT_ID0).to(rows.device)]
    _, got = serving.search(store, live_rows, K, n_probes=n_probes, res=res)
    got = got.cpu().long()
    readback = float((got == live[:, None]).any(1).float().mean())
    gone = torch.cat(deleted)
    leaked += int(torch.isin(got, gone).sum())
    _, got_all = serving.search(store, qs, K, n_probes=n_probes, res=res)
    leaked += int(torch.isin(got_all.cpu().long(), gone).sum())
    growth = store.growth_events - growth0
    # the serving path's run: batches, latency runs and the window
    launches = ss.PAGED_KERNEL.launches
    if ss.STRIP_KERNEL.launches:
        raise AssertionError("the paged search launched K1")
    emit({"phase": "serve.window", "k3_launches_serving_run": launches, "rounds": WINDOW_ROUNDS,
          "upsert_rows": UPSERT_ROWS, "search_queries": 64,
          "delete_lag": DELETE_LAG, "readback": readback,
          "deleted_ids_returned": leaked, "growth_events_in_window": growth,
          "upsert_ms_p50": sorted(up_ms)[len(up_ms) // 2],
          "upsert_ms_mean": sum(up_ms) / len(up_ms),
          "delete_ms_p50": sorted(del_ms)[len(del_ms) // 2],
          "delete_ms_mean": sum(del_ms) / len(del_ms),
          "stats": store.stats()})
    if readback < 1.0 or leaked or growth:
        raise AssertionError(f"mutation window: read-back {readback}, "
                             f"{leaked} deleted ids returned, {growth} growths")
    # after the serving path's count is read: the rung sets the counts to 0
    obs_rung("serve", lambda: serving.search(store, qs, K, n_probes=n_probes,
                                             res=res), q,
             "ivf_flat::search_paged", "ivf_flat::paged_pallas",
             "ivf_flat.search_paged", "backend.paged", ss.PAGED_KERNEL)

    # compact → the packed search through K1 agrees with the paged one;
    # compact_swap keeps capacity and width and the results
    version = store.mutation_version
    pv, pi = serving.search(store, qs, K, n_probes=n_probes, res=res)
    t = time.perf_counter()
    compacted = store.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t
    k1_before = ss.STRIP_KERNEL.launches
    cv, ci = ivf_flat.search(compacted, qs, K, n_probes=n_probes, res=res)
    compact_agree = topk_agreement(pv, pi, cv, ci)
    cap, width = store.capacity_pages, store.table_width
    t = time.perf_counter()
    swapped = store.compact_swap(compacted, version)
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t
    sv, si = serving.search(store, qs, K, n_probes=n_probes, res=res)
    same = bool(torch.equal(si, pi))
    emit({"phase": "serve.compact", "compact_s": compact_s, "swap_s": swap_s,
          "rows": compacted.size, "agreement_packed_vs_paged": compact_agree,
          "k1_launches": ss.STRIP_KERNEL.launches - k1_before,
          "swapped": swapped, "capacity_pages": store.capacity_pages,
          "table_width": store.table_width, "same_after_swap": same})
    if not (compact_agree["ok"] and swapped and same
            and (store.capacity_pages, store.table_width) == (cap, width)):
        raise AssertionError("compact / compact_swap changed the results or "
                             "the store's shape")

    # K3 at this path's own class inputs (the reserved store, k = 10)
    calls, q_tile = serve_flat_inputs(store, qs, n_probes, K, res)
    max_err = kernel_parity_at(calls, "paged_scan",
                               f"serve_path_nprobe{n_probes}_kf{K}")
    keep_for_ab(("paged_scan", f"serve_flat_kf{K}"), calls)
    timing = kernel_timing(calls, "paged_scan", paged_library_yardstick,
                           store.dim + 4, bound=paged_scan_bound)
    loops = product_loops(calls, "paged_scan")
    check_ring(loops, "serve.k3")
    emit({"phase": "serve.k3", "n_probes": n_probes, "kf": K,
          "loop": "/".join(loops), "query_tile": q_tile, "strips": sum(
              int((c["strip_list"] >= 0).sum()) for c in calls), **timing})
    kernel_split(calls, "serve.k3_split", "paged_scan", kf=K,
                 n_probes=n_probes, payload="uint8")
    del calls

    # filters: per call through K3 (the rows the window upserted, ids past
    # the masks, never pass), then a standing filter that survives
    # compaction, and a permutation of the 1% mask at its popcount
    def frun(f):
        return serving.search(store, qs, K, n_probes=n_probes, filter=f,
                              res=res)

    filtered_rungs(shared, "serve", frun, ss.PAGED_KERNEL, probes_widened(
        n_probes, store.n_lists))
    standing_filter_checks(shared, store, n_probes, res)
    serve_gather(shared, store, n_probes, res)
    HELD["serve.flat"] = (store, n_probes)
    return {"launches": launches, "max_abs_err": max_err,
            "loop": "/".join(loops),
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}


def standing_filter_checks(shared, store, n_probes, res):
    """A standing filter (``set_filter``) gives the per-call filter's ids;
    it survives compact + compact_swap with the same ids; a permutation of
    the 1% mask at the same popcount, installed as the standing filter,
    gives the ids of a fresh Bitset built from it per call."""
    import torch

    from raft_tpu_torch import serving
    from raft_tpu_torch.core.bitset import Bitset

    ladder = filter_ladder(shared)
    qs = shared["queries"]
    f10 = ladder["rungs"][0]["bitset"]
    _, per_call = serving.search(store, qs, K, n_probes=n_probes, filter=f10,
                                 res=res)
    store.set_filter(f10)
    _, standing = serving.search(store, qs, K, n_probes=n_probes, res=res)
    version = store.mutation_version
    t = time.perf_counter()
    swapped = store.compact_swap(store.compact(), version)
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t
    _, after = serving.search(store, qs, K, n_probes=n_probes, res=res)
    perm = ladder["perm01"]
    store.set_filter(perm)
    _, perm_standing = serving.search(store, qs, K, n_probes=n_probes,
                                      res=res)
    store.set_filter(None)
    _, perm_fresh = serving.search(store, qs, K, n_probes=n_probes,
                                   filter=Bitset.from_mask(perm, device=store.device),
                                   res=res)
    out = {"phase": "serve.standing_filter",
           "same_as_per_call": bool(torch.equal(standing, per_call)),
           "swapped": swapped, "compact_swap_s": swap_s,
           "same_after_compact_swap": bool(torch.equal(after, standing)),
           "perm01_popcount": int(perm.sum()),
           "perm01_same_as_fresh_bitset": bool(torch.equal(perm_standing,
                                                           perm_fresh))}
    emit(out)
    if not all(out[k] for k in ("same_as_per_call", "swapped",
                                "same_after_compact_swap",
                                "perm01_same_as_fresh_bitset")):
        raise AssertionError(f"standing filter: {out}")


GATHER_KS = (600, 1000)   # past K3's k ≤ 512: "auto" takes the gather scan
GATHER_QUERIES = 500      # the gather reads each probed page per query


def serve_gather(shared, store, n_probes, res, k_fetch=None):
    """The paged gather backend where K3's plan cannot feed k: ``"auto"``
    resolves to it at k = 600 and 1000 and serves. Flat store: its top 10
    agree with K3's k = 10 result except at near-ties. PQ store (two
    estimators: the fp32 codeword LUT and K3's int8 cache): both go
    through the exact refine and the gather's top 10 recall no less than
    K3's at ``k_fetch``."""
    import torch

    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import refine
    from raft_tpu_torch.stats.metrics import (neighborhood_recall,
                                              topk_agreement)

    dataset, qs = shared["dataset"], shared["queries"][:GATHER_QUERIES]
    gt_v, gt_i = (t[:GATHER_QUERIES] for t in shared["gt"])
    kind = "pq" if store.kind == "ivf_pq" else "flat"
    reset_counts()
    v3, i3 = serving.search(store, qs, k_fetch or K, n_probes=n_probes,
                            res=res)
    if k_fetch:
        v3, i3 = refine.refine(dataset, qs, i3, K, res=res)
    for k in GATHER_KS:
        engine = serving.paged_engine(store, k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        vg, ig = serving.search(store, qs, k, n_probes=n_probes, res=res)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t
        row = {"phase": "serve.gather", "store": kind, "k": k,
               "queries": GATHER_QUERIES, "engine": engine,
               "search_s": search_s, "full_rows": int((ig >= 0).all(1).sum())}
        if k_fetch:
            vr, ir = refine.refine(dataset, qs, ig, K, res=res)
            row.update(recall_gather=neighborhood_recall(ir, gt_i, vr, gt_v),
                       recall_k3=neighborhood_recall(i3, gt_i, v3, gt_v))
            ok = row["recall_gather"] >= row["recall_k3"]
        else:
            # K3's values carry the packed column in their low mantissa
            # bits, relative to the scan score −2⟨q, x⟩ + ‖x‖², which
            # adding ‖q‖² back cancels: the error is absolute at that scale
            atol = 5e-4 * float(qs.float().pow(2).sum(1).max())
            row["agreement_with_k3"] = topk_agreement(
                v3, i3, vg[:, :K], ig[:, :K], atol=atol)
            ok = row["agreement_with_k3"]["ok"]
        emit(row)
        if engine != "gather" or not ok or row["full_rows"] != GATHER_QUERIES:
            raise AssertionError(f"serve.gather: {row}")


def serve_codes_inputs(store, kind, qs, n_probes, kf, res):
    """The per-class arguments a paged IVF-PQ (K3 over the int8 cache) or
    IVF-BQ (K4 over the codes) search of ``store`` hands its kernel →
    (calls, kernel name, payload bytes a row, query tile)."""
    from raft_tpu_torch.neighbors import ivf_bq

    snap = store.paged_scan_state()
    l2 = store.metric in ("sqeuclidean", "euclidean")
    if kind == "pq":
        from raft_tpu_torch.neighbors import ivf_pq

        probes, qr, _ = ivf_pq._pq_probe_prep(
            qs.float(), store.centers, store.rotation, n_probes, "exact", l2)
        a_rows, width, kernel = qr * store.decoded_scale, store._cache_dim, \
            "paged_scan"
    else:
        probes, a_rows, _ = ivf_bq._bq_search_prep(
            qs.float(), store.centers, store.rotation, n_probes, "exact", l2,
            store.bq_bits, store.rotation_kind)
        width, kernel = store.rotation.shape[0] * store.bq_bits, "paged_bq_scan"
    q_tile = min(ivf_bq._paged_plan_static(store, n_probes, kf, res, width),
                 qs.shape[0])
    row_bytes = int(snap[0].shape[-1])
    calls = paged_class_inputs(snap, probes, a_rows, kf, row_bytes, q_tile,
                               -2.0 if l2 else -1.0, codes=kind == "bq")
    return calls, kernel, row_bytes, q_tile


def serve_codes_phase(shared, kind, index, pick, dev="cuda"):
    """Paged IVF-PQ (K3 over the int8 cache) or IVF-BQ (K4 over the codes)
    on a store made from the path's packed index, at the path's chosen
    (n_probes, k_fetch) with exact refine; then one upsert/delete round;
    then the path's kernel at its own class inputs."""
    import torch

    from raft_tpu_torch import Resources, serving
    from raft_tpu_torch.neighbors import refine
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    q = qs.shape[0]
    n_probes = min(pick["n_probes"], int(index.centers.shape[0]))
    kf = pick["k_fetch"]
    counter = ss.PAGED_KERNEL if kind == "pq" else bq.PAGED_BQ_KERNEL
    before = allocated()
    t = time.perf_counter()
    store = serving.PagedListStore.from_index(
        index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    store.reserve(4 * UPSERT_ROWS)
    store.device_table()        # built by the first search, counted now
    torch.cuda.synchronize()
    cost_row(f"serve.{kind}", store, before)
    store_s = time.perf_counter() - t

    def run(queries):
        _, cand = serving.search(store, queries, kf, n_probes=n_probes,
                                 res=res)
        return cand

    reset_counts()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cand = run(qs)
        v, i = refine.refine(dataset, qs, cand, K, res=res)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = counter.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    if rec < 0.95 or launches <= 0:
        raise AssertionError(f"paged {kind}: recall {rec}, {launches} launches")

    # filters and (PQ) the gather scan, while the store holds only dataset
    # rows (the exact refine reads them)
    def frun(f):
        _, cand = serving.search(store, qs, kf, n_probes=n_probes, filter=f,
                                 res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    filtered_rungs(shared, f"serve.{kind}", frun, counter, probes_widened(
        n_probes, store.n_lists, kf))
    if kind == "pq":
        serve_gather(shared, store, n_probes, res, k_fetch=kf)

    # one round: upsert 2·32 query vectors, delete half of them and 32
    # original rows, search the upserted rows' queries
    lo = WINDOW_ROUNDS * UPSERT_ROWS
    rows = qs[lo:lo + 2 * UPSERT_ROWS]
    ids = torch.arange(UPSERT_ID0 + lo, UPSERT_ID0 + lo + 2 * UPSERT_ROWS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    store.upsert(rows, ids=ids)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t) * 1e3
    gone = torch.cat([ids[UPSERT_ROWS:], torch.arange(UPSERT_ROWS) * 997])
    torch.cuda.synchronize()
    t = time.perf_counter()
    store.delete(gone)
    torch.cuda.synchronize()
    del_ms = (time.perf_counter() - t) * 1e3
    cand = run(rows).cpu().long()
    found = float((cand[:UPSERT_ROWS] == ids[:UPSERT_ROWS, None]).any(1)
                  .float().mean())
    leaked = int(torch.isin(cand, gone).sum()) + int(
        torch.isin(run(qs).cpu().long(), gone).sum())
    out = {"phase": f"serve.{kind}", "n_probes": n_probes, "k_fetch": kf,
           "store_s": store_s, "recall": rec,
           "qps": len(times) * q / sum(times), "batch_s": times,
           "launches": launches, "readback_pre_refine": found,
           "deleted_ids_returned": leaked, "upsert_ms": up_ms,
           "delete_ms": del_ms, "stats": store.stats()}
    emit(out)
    if found < 0.99 or leaked:
        raise AssertionError(f"paged {kind}: read-back {found}, {leaked} "
                             "deleted ids returned")
    # the path's kernel at its own class inputs
    calls, kernel, row_bytes, q_tile = serve_codes_inputs(store, kind, qs,
                                                          n_probes, kf, res)
    max_err = kernel_parity_at(calls, kernel,
                               f"serve_{kind}_nprobe{n_probes}_kf{kf}")
    keep_for_ab((kernel, f"serve_{kind}_kf{kf}"), calls)
    timing = kernel_timing(calls, kernel, paged_library_yardstick,
                           row_bytes + (8 if kind == "bq" else 4),
                           bound=paged_scan_bound)
    loops = product_loops(calls, kernel)
    if kind == "bq":
        check_wgmma(loops, row_bytes, "serve.bq.k4")
    else:
        check_ring(loops, "serve.pq.k3")
    loop = {"loop": "/".join(loops)}
    short = "k4" if kind == "bq" else "k3"
    emit({"phase": f"serve.{kind}.{short}",
          "n_probes": n_probes, "kf": kf, **loop,
          "query_tile": q_tile, "strips": sum(
              int((c["strip_list"] >= 0).sum()) for c in calls), **timing})
    kernel_split(calls, f"serve.{kind}.{short}_split", kernel, kf=kf,
                 n_probes=n_probes)
    return {"launches": launches, "max_abs_err": max_err, **loop,
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}


# ---------------------------------------------------------------------------
# K5 (the IVF-PQ LUT scan), the streamed IVF-PQ path and its cache-only twin
# ---------------------------------------------------------------------------


def synthetic_lut_scan(seed, *, nc, s, m, qpl, n_lists=64, integer=True,
                       dev="cuda"):
    """One K5 launch's inputs on ``dev``: grouped bf16 LUT rows (integer-
    valued in [-64, 64] with ``integer``, so every fp32 sum is exact;
    normal otherwise), uint8 codes, b_sum with +inf tails, every fourth
    slot's LUT row all zeros, and the last list empty (all +inf)."""
    import torch

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (n_lists, qpl, s * nc)
    if integer:
        luts = torch.randint(-64, 65, shape, generator=g, device=dev,
                             dtype=torch.int8).to(torch.bfloat16)
        b_sum = torch.randint(-500, 500, (n_lists, m), generator=g,
                              device=dev).float()
    else:
        luts = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        b_sum = torch.randn((n_lists, m), generator=g, device=dev) * 8
    luts[:, ::4] = 0
    lens = torch.randint(1, m + 1, (n_lists,), generator=g, device=dev)
    col = torch.arange(m, device=dev)[None, :]
    b_sum = torch.where(col < lens[:, None], b_sum, float("inf"))
    b_sum[-1] = float("inf")
    codes = torch.randint(0, nc, (n_lists, s, m), generator=g, device=dev,
                          dtype=torch.uint8)
    return dict(luts_grouped=luts, codes_t=codes, b_sum=b_sum.contiguous(),
                nc=nc)


K5_PARITY_CASES = (
    [(f"main_nc256_s64_m3968_qpl16_{kind}",
      dict(nc=256, s=64, m=3968, qpl=16, integer=kind == "int"))
     for kind in ("int", "real")]
    + [(f"nc{nc}_s{s}_m{m}_qpl{qpl}_{'int' if i else 'real'}",
        dict(nc=nc, s=s, m=m, qpl=qpl, integer=i))
       for nc, s, m, qpl, i in ((16, 8, 128, 48, True), (16, 64, 3968, 16, False),
                                (32, 16, 384, 320, True), (32, 64, 128, 16, False),
                                (64, 8, 3968, 48, True), (64, 64, 384, 320, False),
                                (256, 16, 128, 320, True), (256, 8, 384, 48, False))]
    + [("odd_m130_qpl20_int", dict(nc=16, s=8, m=130, qpl=20, integer=True)),
       ("luts_past_2G_elements_int",
        dict(nc=256, s=64, m=128, qpl=256, n_lists=544, integer=True))])


def synthetic_lut_pairs(seed, *, nc, s, m, q, p, n_lists, hot=0.0,
                        integer=True, dev="cuda"):
    """One K5 launch through the pair entry on ``dev``: a tile of q
    queries' LUT rows (integer-valued in [-64, 64] with ``integer``), each
    probing p distinct lists of the first n_lists - 4 (the last 4 lists get
    no pair), a share ``hot`` of the queries probing list 0 (a load of many
    16-pair blocks), the pairs sorted by list as the search sorts them;
    uint8 codes, b_sum with +inf tails and an all-+inf list."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = s * nc
    if integer:
        luts = torch.randint(-64, 65, (q, f), generator=g, device=dev,
                             dtype=torch.int8).to(torch.bfloat16)
        b_sum = torch.randint(-500, 500, (n_lists, m), generator=g,
                              device=dev).float()
    else:
        luts = torch.randn((q, f), generator=g, device=dev).to(torch.bfloat16)
        b_sum = torch.randn((n_lists, m), generator=g, device=dev) * 8
    luts[::5] = 0
    probes = torch.argsort(torch.rand((q, n_lists - 4), generator=g,
                                      device=dev), dim=1)[:, :p]
    hot_rows = torch.rand(q, generator=g, device=dev) < hot
    has0 = (probes == 0).any(1)
    probes[:, 0] = torch.where(hot_rows & ~has0, 0, probes[:, 0])
    lens = torch.randint(1, m + 1, (n_lists,), generator=g, device=dev)
    col = torch.arange(m, device=dev)[None, :]
    b_sum = torch.where(col < lens[:, None], b_sum, float("inf"))
    b_sum[1] = float("inf")
    codes = torch.randint(0, nc, (n_lists, s, m), generator=g, device=dev,
                          dtype=torch.uint8)
    pair_lut, pair_list, pair_out = ivf_pq._pallas_pairs(probes.to(torch.int32))
    return dict(luts=luts, pair_lut=pair_lut, pair_list=pair_list,
                pair_out=pair_out, codes_t=codes, b_sum=b_sum.contiguous(),
                nc=nc)


# (name, synthetic_lut_pairs keywords): the streamed path's shape at the
# chosen query tile, skewed loads, blocks of ≤ 8 pairs (the half path),
# an odd m, lists with no pair; bitwise on integer LUTs
K5_PAIR_CASES = (
    [(f"pairs_main_nc256_s64_m3968_q768_p16_{kind}",
      dict(nc=256, s=64, m=3968, q=768, p=16, n_lists=1024, hot=0.05,
           integer=kind == "int")) for kind in ("int", "real")]
    + [("pairs_hot_list_q256_p4_int",
        dict(nc=64, s=16, m=384, q=256, p=4, n_lists=32, hot=0.8)),
       ("pairs_half_blocks_q20_p2_int",
        dict(nc=16, s=8, m=128, q=20, p=2, n_lists=64)),
       ("pairs_odd_m130_int", dict(nc=32, s=8, m=130, q=64, p=3, n_lists=16,
                                   hot=0.5)),
       ("pairs_nc128_s32_real", dict(nc=128, s=32, m=256, q=96, p=8,
                                     n_lists=24, hot=0.3, integer=False))])


def compare_scan(kernel_out, plain_out, exact: bool) -> dict:
    """K5 against its twin: +inf where the twin has it; equal bit for bit
    with ``exact`` (integer-valued LUTs), else within PARITY_RTOL plus the
    floor (summation order)."""
    import torch

    fin = torch.isfinite(plain_out)
    inf_ok = bool(torch.equal(torch.isinf(kernel_out), torch.isinf(plain_out)))
    err = (kernel_out[fin].double() - plain_out[fin].double()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if exact:
        ok = inf_ok and bool(torch.equal(kernel_out, plain_out))
    else:
        top = float(plain_out[fin].abs().max()) if bool(fin.any()) else 0.0
        tol = PARITY_RTOL * plain_out[fin].double().abs() \
            + PARITY_ATOL_FRAC * top
        ok = inf_ok and bool((err <= tol).all())
    return {"ok": ok, "exact": exact, "max_abs_err": worst,
            "inf_positions_equal": inf_ok, "compared": int(fin.sum())}


def scan_parity_phase(cases=K5_PARITY_CASES, pair_cases=K5_PAIR_CASES,
                      seed0=5000, dev="cuda"):
    """K5 against its plain twins on every synthetic case, through the
    grouped entry (``pq_scan``, the trivial pair list) and the pair entry
    (``pq_scan_pairs``); one line each."""
    import torch

    from raft_tpu_torch.ops import pq_scan as ps

    worst = 0.0
    runs = ([(name, kw, synthetic_lut_scan, ps.pq_scan, ps.pq_scan_reference)
             for name, kw in cases]
            + [(name, kw, synthetic_lut_pairs, ps.pq_scan_pairs,
                ps.pq_scan_pairs_reference) for name, kw in pair_cases])
    for i, (name, kw, make, entry, twin) in enumerate(runs):
        call = make(seed0 + i, dev=dev, **kw)
        got = entry(**call)
        if got.is_cuda:
            torch.cuda.synchronize()
        verdict = compare_scan(got, twin(**call), kw.get("integer", True))
        extra = ({"lut_elements": call["luts_grouped"].numel()}
                 if "luts_grouped" in call else
                 {"pairs": call["pair_lut"].numel(), "max_list_load": int(
                     torch.bincount(call["pair_list"].long()).max())})
        emit({"phase": "parity", "kernel": "pq_scan", "case": name, **extra,
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"pq_scan disagrees with its plain version "
                                 f"on {name}: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
        del call, got
    return worst


def pq_escalate(run, recall_of, phase: str) -> dict:
    """The bench's IVF-PQ escalation: n_probes 16…256 at a 4× over-fetch
    until recall@10 ≥ 0.95, then the smallest over-fetch (20, 10) that
    still holds it. Every step is emitted as ``phase``."""
    pick = None
    for n_probes in (16, 32, 64, 128, 256):
        rec = recall_of(*run(4 * K, n_probes))
        emit({"phase": phase, "n_probes": n_probes, "k_fetch": 4 * K,
              "recall": rec})
        if pick is None or rec > pick["recall"]:
            pick = {"n_probes": n_probes, "k_fetch": 4 * K, "recall": rec}
        if rec >= 0.95:
            break
    if pick["recall"] >= 0.95:
        for kf in (2 * K, K):
            rec = recall_of(*run(kf, pick["n_probes"]))
            emit({"phase": phase, "n_probes": pick["n_probes"], "k_fetch": kf,
                  "recall": rec})
            if rec < 0.95:
                break
            pick.update(recall=rec, k_fetch=kf)
    return pick


def lut_tiles(index, queries, n_probes, res):
    """The pallas search's shared prep (coarse select, bf16 LUTs, codes
    list-minor) and a function that makes one query tile's K5 call as the
    search makes it (the tile's probed pairs sorted by list), with its
    probes, pair constants and block occupancy (pairs over 16 slots of
    every block K5 runs)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan as ps

    coarse, probes, luts, codes_t = ivf_pq._pallas_prep(
        queries.float(), index, min(n_probes, index.n_lists), "exact",
        res.compute_dtype)

    def tile(start, q_tile):
        pb = probes[start:start + q_tile]
        pair_lut, pair_list, pair_out = ivf_pq._pallas_pairs(pb)
        load = torch.bincount(pair_list.long(), minlength=index.n_lists)
        blocks = int(((load + ps.PAIRS_PER_BLOCK - 1)
                      // ps.PAIRS_PER_BLOCK).sum())
        return (dict(luts=luts[start:start + q_tile], pair_lut=pair_lut,
                     pair_list=pair_list, pair_out=pair_out, codes_t=codes_t,
                     b_sum=index.b_sum, nc=index.n_codes),
                {"probes": pb, "cvals": coarse[start:start + q_tile],
                 "occupancy": pair_lut.numel() / (ps.PAIRS_PER_BLOCK * blocks),
                 "max_list_load": int(load.max())})

    return probes.shape[0], tile


def lut_scan_bound(calls):
    """Least time for K5's launches: each input once (the tile's LUT
    table, the codes and b_sum of the lists its pairs probe, the pair
    arrays) and the scores written once at the HBM rate, against P·m·s
    fp32 adds at the fp32 rate; the larger one."""
    import torch

    nbytes = 0
    adds = 0
    for c in calls:
        _, s, m = c["codes_t"].shape
        pairs = c["pair_lut"].numel()
        lists = int(torch.unique(c["pair_list"]).numel())
        nbytes += (c["luts"].numel() * 2 + 3 * pairs * 4
                   + lists * (s * m + m * 4) + pairs * m * 4)
        adds += pairs * m * s
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = adds / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, adds, t_bytes, t_ops


def grouped_of(call, n_lists):
    """The JAX package's grouped layout of a pair call at a cap no list
    exceeds (16-aligned): (L, cap, s·nc) LUT rows, zeros at empty slots,
    for the one-hot yardstick."""
    from raft_tpu_torch.ops import pq_scan as ps

    load = int(call["pair_list"].bincount(minlength=n_lists).max())
    cap = -(-load // 16) * 16
    probes = call["pair_list"][call["pair_out"].argsort()].reshape(
        call["luts"].shape[0], -1)
    qids, _ = ps.group_probed_pairs(probes, n_lists, cap)
    luts_g = call["luts"][qids.clamp(min=0).long()]
    luts_g.masked_fill_((qids < 0)[:, :, None], 0)
    return dict(luts_grouped=luts_g, codes_t=call["codes_t"],
                b_sum=call["b_sum"], nc=call["nc"])


def lut_library_ms(c, lists_per_chunk=32) -> float:
    """K5's PyTorch yardstick on one launch's inputs: the TPU kernel's own
    product, a batched bf16 ``torch.bmm`` of the LUT rows against the
    one-hot expansion of the codes, plus b_sum. The one-hot is built
    outside the timed region, in list chunks that fit; the chunks' times
    are summed. The port never calls it."""
    import torch

    luts, codes, b_sum, nc = (c["luts_grouped"], c["codes_t"], c["b_sum"],
                              c["nc"])
    L, qpl, f = luts.shape
    _, s, m = codes.shape
    s_off = (torch.arange(s, device=codes.device) * nc)[None, :, None]
    total = 0.0
    for a in range(0, L, lists_per_chunk):
        b = min(L, a + lists_per_chunk)
        oh = torch.zeros((b - a, f, m), dtype=torch.bfloat16,
                         device=codes.device)
        oh.scatter_(1, codes[a:b].long() + s_off, 1.0)
        total += cuda_ms(lambda: torch.bmm(luts[a:b], oh).float()
                         + b_sum[a:b, None, :], reps=3, warmup=1)
        del oh
    return total


def check_dropped(index, dataset, group):
    """The streamed build's accounting: the rows missing from the index
    are exactly the ``_streaming_dropped`` it counts, and no list passes
    the auto cap. The one-pass diversion (the reference's contract) drops a
    row whose diverted list is full by its arrival rank in the chunk, which
    can happen while its nearest list still has room; the share of dropped
    rows whose two nearest lists both end at the cap is printed."""
    import torch

    from raft_tpu_torch.neighbors import _packing

    n = dataset.shape[0]
    cap = _packing.auto_list_cap(n, index.n_lists, group)
    present = torch.zeros(n, dtype=torch.bool, device=dataset.device)
    present[index.list_ids[index.list_ids >= 0].long()] = True
    missing = (~present).nonzero()[:, 0]
    sizes = index.list_sizes()
    both_full = None
    if missing.numel():
        l1, l2 = _packing.assign_top2(dataset[missing].float(), index.centers)
        both_full = float(((sizes[l1.long()] >= cap)
                           & (sizes[l2.long()] >= cap)).float().mean())
    emit({"phase": "streaming.dropped", "rows": missing.numel(), "cap": cap,
          "lists_at_cap": int((sizes >= cap).sum()),
          "max_list_fill": int(sizes.max()),
          "share_with_both_nearest_lists_full": both_full})
    if missing.numel() != index._streaming_dropped or int(sizes.max()) > cap:
        raise AssertionError(f"{missing.numel()} rows missing, "
                             f"{index._streaming_dropped} counted, largest "
                             f"list {int(sizes.max())} against cap {cap}")


def lut_phase(shared, n_lists=N_LISTS, dev="cuda"):
    """The streamed IVF-PQ path: ``build_streaming`` from a host copy of the
    dataset (4 chunks of 250,000 rows, 128-row granule), the bench's
    escalation through the pallas backend (K5) with exact refine, the
    gather backend beside it, ``extend`` with the queries, and K5 at the
    path's own pair inputs."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.ops.select_k import select_k
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs, host = shared["dataset"], shared["queries"], shared["host"]
    gt_v, gt_i = shared["gt"]
    n, dim = host.shape
    q = qs.shape[0]
    t = time.perf_counter()
    index = ivf_pq.build_streaming(
        lambda s, e: host[s:e], n, dim, ivf_pq.IvfPqParams(
            n_lists=n_lists, pq_dim=64, pq_bits=8,
            kmeans_trainset_fraction=0.2, group_size=128),
        res=res, chunk_rows=STREAM_CHUNK_ROWS, store="codes")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    auto = ivf_pq.resolve_backend("auto", "cuda", index.max_list_size, K)
    emit({"phase": "lut.setup", "rows": n, "n_lists": n_lists,
          "chunks": -(-n // STREAM_CHUNK_ROWS),
          "max_list_size": index.max_list_size, "group": index.group_size,
          "streaming_dropped": index._streaming_dropped,
          "code_bytes_per_row": index.list_codes.shape[-1],
          "build_s": build_s, "build_phases_s": index.build_timings_s,
          "auto_backend": auto})
    check_dropped(index, dataset, 128)
    if index.max_list_size % 128:
        raise AssertionError(f"max_list_size {index.max_list_size} is not "
                             "128-aligned")
    if not ss.strip_eligible(index.max_list_size) and auto != "pallas":
        raise AssertionError(f"auto resolved to {auto!r} on a 128-granule "
                             "CUDA index")
    searches = []

    def run(kf, n_probes, queries=qs):
        st = {}
        _, cand = ivf_pq.search(index, queries, kf, n_probes=n_probes,
                                backend="pallas", res=res, stats=st)
        searches.append(st)
        return refine.refine(dataset, queries, cand, K, res=res)

    def recall_of(v, i):
        return neighborhood_recall(i, gt_i, v, gt_v)

    reset_counts()
    pick = pq_escalate(run, recall_of, "lut.escalate")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = run(pick["k_fetch"], pick["n_probes"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = ps.PQ_KERNEL.launches
    expected = sum(st["tiles"] for st in searches)
    dropped = sum(a["dropped"] for st in searches for a in st["attempts"])
    one_attempt = all(len(st["attempts"]) == 1 for st in searches)
    rec = recall_of(v, i)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("the LUT path returned non-finite or misshapen "
                             "results")
    if rec < 0.95:
        raise AssertionError(f"LUT path recall@10 {rec} < 0.95 at {pick}")
    if launches <= 0 or launches != expected or dropped or not one_attempt:
        raise AssertionError(f"K5 launches {launches}, expected {expected} "
                             f"(one per tile); {dropped} pairs dropped, one "
                             f"attempt a search: {one_attempt}")
    st = {}
    search_ms = cuda_ms(lambda: ivf_pq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"],
        backend="pallas", res=res, stats=st), reps=3)
    _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                            n_probes=pick["n_probes"], backend="pallas",
                            res=res)
    refine_ms = cuda_ms(lambda: refine.refine(dataset, qs, cand, K, res=res),
                        reps=3)
    emit({"phase": "lut.search", **pick, "recall_final": rec,
          "qps": len(times) * q / sum(times), "batch_s": times,
          "search_ms": search_ms, "refine_ms": refine_ms,
          "query_tile": st["q_tile"], "tiles": st["tiles"],
          "max_list_load": st["max_list_load"],
          "attempts_per_search": [len(x["attempts"]) for x in searches],
          "dropped": dropped, "searches": len(searches),
          "k5_launches": launches})

    # the gather backend on the first 1,000 queries at the pick, against
    # the pallas one (the JAX package's own bar between the two)
    q_g = min(1000, q)
    vg, ig = ivf_pq.search(index, qs[:q_g], pick["k_fetch"],
                           n_probes=pick["n_probes"], backend="gather",
                           res=res)
    vp, ip_ = ivf_pq.search(index, qs[:q_g], pick["k_fetch"],
                            n_probes=pick["n_probes"], backend="pallas",
                            res=res)
    overlap = sum(len(set(a) & set(b)) for a, b in zip(
        ig.tolist(), ip_.tolist())) / ig.numel()
    vals_ok = bool(torch.allclose(vp, vg, rtol=0.05, atol=0.5))
    gather_ms = cuda_ms(lambda: ivf_pq.search(
        index, qs[:q_g], pick["k_fetch"], n_probes=pick["n_probes"],
        backend="gather", res=res), reps=1, warmup=0)
    pallas_ms = cuda_ms(lambda: ivf_pq.search(
        index, qs[:q_g], pick["k_fetch"], n_probes=pick["n_probes"],
        backend="pallas", res=res), reps=3, warmup=1)
    emit({"phase": "lut.gather", "queries": q_g, "overlap": overlap,
          "values_within_rtol_0.05": vals_ok,
          "max_abs_diff": float((vp - vg).abs().max()),
          "gather_ms": gather_ms, "pallas_ms": pallas_ms,
          "pallas_beats_gather": pallas_ms < gather_ms})
    if overlap < 0.95 or not vals_ok:
        raise AssertionError(f"gather and pallas disagree: overlap {overlap},"
                             f" values within tolerance {vals_ok}")
    del vg, ig, vp, ip_

    def frun(f):
        _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                                n_probes=pick["n_probes"], backend="pallas",
                                filter=f, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    filtered_rungs(shared, "lut", frun, ps.PQ_KERNEL, probes_widened(
        pick["n_probes"], n_lists, pick["k_fetch"]))

    # extend with the queries under ids n + i; each must find itself
    t = time.perf_counter()
    ext = ivf_pq.extend(index, qs, new_ids=torch.arange(
        n, n + q, dtype=torch.int32, device=qs.device), res=res)
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t
    _, ie = ivf_pq.search(ext, qs, K, n_probes=pick["n_probes"],
                          backend="pallas", res=res)
    own = torch.arange(n, n + q, device=ie.device)[:, None]
    readback = float((ie == own).any(dim=1).float().mean())
    emit({"phase": "lut.extend", "rows_added": q, "extend_s": extend_s,
          "max_list_size": ext.max_list_size, "size": ext.size,
          "readback": readback})
    if readback < 0.99:
        raise AssertionError(f"extend read-back {readback} < 0.99")
    del ext, ie

    # K5 at the path's own pair inputs (the pick's query tiles): parity on
    # the first and last tile; K5, its twin, the yardstick and the bound on
    # the first tile (the kernels line); then K5 and the select over p·m
    # over every tile of one search, beside the search
    qt = st["q_tile"]
    q_all, tile = lut_tiles(index, qs, pick["n_probes"], res)
    starts = list(range(0, q_all, qt))
    max_err = 0.0
    for start in sorted({starts[0], starts[-1]}):
        call, _ = tile(start, qt)
        verdict = compare_scan(ps.pq_scan_pairs(**call),
                               ps.pq_scan_pairs_reference(**call), False)
        emit({"phase": "parity", "kernel": "pq_scan",
              "case": f"lut_path_tile{start // qt}_nprobe{pick['n_probes']}",
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"pq_scan disagrees with its plain version "
                                 f"on the LUT path: {verdict}")
        max_err = max(max_err, verdict["max_abs_err"])
        del call
    call, info0 = tile(0, qt)
    k5_ms = cuda_ms(lambda: ps.pq_scan_pairs(**call), reps=5)
    plain_ms = cuda_ms(lambda: ps.pq_scan_pairs_reference(**call), reps=1,
                       warmup=1)
    grouped = grouped_of(call, index.n_lists)
    library_ms = lut_library_ms(grouped)
    lut_shape = list(grouped["luts_grouped"].shape)
    del grouped
    bound_ms, bound_by, nbytes, adds, t_bytes, t_ops = lut_scan_bound([call])
    del call
    k5_search_ms, bound_search_ms, select_ms, occ, loads = 0.0, 0.0, 0.0, [], []
    for start in starts:
        c, info = tile(start, qt)
        t_ms = cuda_ms(lambda: ps.pq_scan_pairs(**c), reps=3)
        k5_search_ms += t_ms
        bound_search_ms += lut_scan_bound([c])[0]
        n_q = info["probes"].shape[0]
        d = (ps.pq_scan_pairs(**c).reshape(n_q, pick["n_probes"], -1)
             + info["cvals"][:, :, None]).reshape(n_q, -1)
        select_ms += cuda_ms(lambda: select_k(d, pick["k_fetch"],
                                              select_min=True), reps=3)
        occ.append(info["occupancy"])
        loads.append(info["max_list_load"])
        del c, d
    if AB_INPUTS is not None:
        AB_FILES.mkdir(parents=True, exist_ok=True)
        index.save(AB_FILES / "lut.index")
        torch.save(qs.cpu(), AB_FILES / "lut_queries.pt")
        AB_INPUTS["lut"] = (AB_FILES / "lut.index",
                            AB_FILES / "lut_queries.pt", pick)
    qf = qs.float()
    prep_ms = cuda_ms(lambda: ivf_pq._pallas_prep(
        qf, index, pick["n_probes"], "exact", res.compute_dtype), reps=3)
    emit({"phase": "lut.k5", "n_probes": pick["n_probes"],
          "kf": pick["k_fetch"], "query_tile": qt, "tiles": len(starts),
          "launches_per_search": len(starts),
          "tile0": {"pairs": int(info0["probes"].numel()), "ms": k5_ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_lut_shape": lut_shape,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": nbytes, "adds": adds, "bytes_ms": t_bytes,
                    "adds_ms": t_ops, "occupancy": info0["occupancy"],
                    "max_list_load": info0["max_list_load"]},
          "k5_ms_per_search": k5_search_ms,
          "bound_ms_per_search": bound_search_ms,
          "select_ms": select_ms, "occupancy_mean": sum(occ) / len(occ),
          "max_list_load": loads, "search_ms": search_ms, "prep_ms": prep_ms,
          "other_ms": search_ms - k5_search_ms - select_ms - prep_ms})
    lut_q_tile_phase(index, qs, pick, tile, q_all, res)
    obs_rung("lut", lambda: ivf_pq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"],
        backend="pallas", res=res), q, "ivf_pq::search", "ivf_pq::scan",
        "ivf_pq.search", "backend.pallas", ps.PQ_KERNEL)
    del index
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err, "ms": k5_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def lut_q_tile_phase(index, qs, pick, tile, q_all, res):
    """The pallas search's query tile: the tile it picks (the largest the
    workspace allows) against the tile whose LUT table fits in half the
    50 MB L2 (so that a query's pairs would re-read its LUT row from L2),
    each forced through ``pallas_q_tile``, in the order L2-sized, picked,
    picked, L2-sized; the search and K5 summed over one search's tiles at
    each."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan as ps

    p, m = pick["n_probes"], index.max_list_size
    lut_row = index.pq_dim * index.n_codes * 2
    choose = ivf_pq.pallas_q_tile
    picked = choose(q_all, p, m, lut_row, res.workspace_bytes)
    l2_sized = min(picked, (24 << 20) // lut_row)
    rows = []
    for qt in (l2_sized, picked, picked, l2_sized):
        ivf_pq.pallas_q_tile = lambda *_, qt=qt: qt
        search_ms = cuda_ms(lambda: ivf_pq.search(
            index, qs, pick["k_fetch"], n_probes=p, backend="pallas",
            res=res), reps=3)
        ivf_pq.pallas_q_tile = choose
        k5_ms = 0.0
        for start in range(0, q_all, qt):
            c, _ = tile(start, qt)
            k5_ms += cuda_ms(lambda: ps.pq_scan_pairs(**c), reps=3)
            del c
        rows.append({"q_tile": qt, "tiles": -(-q_all // qt),
                     "search_ms": search_ms, "k5_ms": k5_ms})
    emit({"phase": "lut.q_tile", "picked": picked, "l2_sized": l2_sized,
          "lut_table_mb_at_picked": picked * lut_row / 2**20,
          "order": rows})


def cache_phase(shared, n_lists=N_LISTS, dev="cuda"):
    """The streamed cache-only IVF-PQ path (the DEEP-100M route at 1M):
    ``build_streaming(store="cache")`` at the auto granule and full
    cache_dim, ``search`` with the default backend (ragged: K1 over the
    int8 cache), the escalation with exact refine."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs, host = shared["dataset"], shared["queries"], shared["host"]
    gt_v, gt_i = shared["gt"]
    n, dim = host.shape
    q = qs.shape[0]
    t = time.perf_counter()
    index = ivf_pq.build_streaming(
        lambda s, e: host[s:e], n, dim, ivf_pq.IvfPqParams(
            n_lists=n_lists, pq_dim=64, pq_bits=8,
            kmeans_trainset_fraction=0.2),
        res=res, chunk_rows=STREAM_CHUNK_ROWS, store="cache")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cd = index.decoded.shape[-1]
    auto = ivf_pq.resolve_backend("auto", "cuda", index.max_list_size, K,
                                  cache_only=True)
    emit({"phase": "cache.setup", "rows": n, "n_lists": n_lists,
          "max_list_size": index.max_list_size, "group": index.group_size,
          "cache_dim": cd, "streaming_dropped": index._streaming_dropped,
          "bytes_per_row": cd + 8,
          "padded_bytes_per_row": index.n_lists * index.max_list_size
          * (cd + 8) / n,
          "build_s": build_s, "build_phases_s": index.build_timings_s,
          "auto_backend": auto})
    check_dropped(index, dataset, 512)
    if auto != "ragged":
        raise AssertionError(f"cache-only index: auto resolved to {auto!r}")

    def run(kf, n_probes):
        _, cand = ivf_pq.search(index, qs, kf, n_probes=n_probes, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    def recall_of(v, i):
        return neighborhood_recall(i, gt_i, v, gt_v)

    reset_counts()
    pick = pq_escalate(run, recall_of, "cache.escalate")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = run(pick["k_fetch"], pick["n_probes"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = ss.STRIP_KERNEL.launches
    rec = recall_of(v, i)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("the cache path returned non-finite or "
                             "misshapen results")
    if rec < 0.95 or launches <= 0:
        raise AssertionError(f"cache path recall@10 {rec} at {pick}, K1 "
                             f"launches {launches}")
    search_ms = cuda_ms(lambda: ivf_pq.search(
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"], res=res),
        reps=3)
    emit({"phase": "cache.search", **pick, "recall_final": rec,
          "qps": len(times) * q / sum(times), "batch_s": times,
          "search_ms": search_ms, "k1_launches": launches})

    def frun(f):
        _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                                n_probes=pick["n_probes"], filter=f, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    filtered_rungs(shared, "cache", frun, ss.STRIP_KERNEL, probes_widened(
        pick["n_probes"], n_lists, pick["k_fetch"]),
        gathered=ss.STRIP_KERNEL_GATHERED)
    del index
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# K6 (the fused CAGRA hop) and the CAGRA path
# ---------------------------------------------------------------------------


def synthetic_hop(seed, *, w, itopk, deg=64, p=64, n=20_000, q=512,
                  frac_invalid=0.0, dup_heavy=False, all_invalid=False,
                  all_visited=False, integer=True, far=False, dev="cuda"):
    """A random mid-traversal state on ``dev``: a graph with 10% -1 edges
    (ids from n/8 rows when ``dup_heavy``), int8 code records, a buffer
    with 15% +inf holes and random visited flags, parents with a
    ``frac_invalid`` share of -1 (all with ``all_invalid``), every slot
    visited with ``all_visited``. ``integer``
    makes qp integer-valued, so every fp32 sum is exact and the kernel must
    equal its twin bit for bit. ``far`` draws every parent from rows whose
    code records start past byte 2**31. Returns the hop's keyword
    arguments."""
    import torch

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    hi = max(2, n // 8) if dup_heavy else n
    graph = torch.randint(0, hi, (n, deg), generator=g, device=dev,
                          dtype=torch.int32)
    graph[torch.rand((n, deg), generator=g, device=dev) < 0.1] = -1
    codes = torch.randint(-127, 128, (n, deg, p), generator=g, device=dev,
                          dtype=torch.int8)
    if integer:
        qp = torch.randint(-20, 21, (q, p), generator=g, device=dev).float()
    else:
        qp = torch.randn((q, p), generator=g, device=dev) * 8
    # code-unit scores here are ‖c‖² − 2⟨qp, c⟩ ≈ 3.5e5 ± 2e4: the buffer
    # is drawn around them so candidates and buffer interleave
    buf_d = torch.sort(3.5e5 + 2e4 * torch.randn((q, itopk), generator=g,
                                                  device=dev), dim=1).values
    buf_ids = torch.randint(0, n, (q, itopk), generator=g, device=dev,
                            dtype=torch.int32)
    holes = torch.rand((q, itopk), generator=g, device=dev) < 0.15
    buf_ids[holes] = -1
    buf_d[holes] = float("inf")
    buf_vis = (torch.rand((q, itopk), generator=g, device=dev) < 0.5).float()
    if all_visited:
        buf_vis.fill_(1.0)
    lo = (1 << 31) // (deg * p) + 1 if far else 0
    parents = torch.randint(lo, n, (q, w), generator=g, device=dev,
                            dtype=torch.int32)
    if frac_invalid:
        parents[torch.rand((q, w), generator=g, device=dev)
                < frac_invalid] = -1
    if all_invalid:
        parents.fill_(-1)
    return dict(buf_ids=buf_ids, buf_d=buf_d.contiguous(), buf_vis=buf_vis,
                parents=parents, qp=qp, graph=graph, nbr_codes=codes)


HOP_PARITY_CASES = (
    [(f"deg64_p64_w{w}_itopk{it}", dict(w=w, itopk=it, frac_invalid=0.1))
     for w in (1, 4, 8) for it in (32, 64, 96)]
    + [("dup_heavy_w4_itopk64",
        dict(w=4, itopk=64, dup_heavy=True, frac_invalid=0.25)),
       ("dup_heavy_w8_itopk96", dict(w=8, itopk=96, dup_heavy=True)),
       ("all_parents_invalid_w4_itopk64",
        dict(w=4, itopk=64, all_invalid=True)),
       ("all_visited_w4_itopk64", dict(w=4, itopk=64, all_visited=True)),
       ("real_qp_w4_itopk64", dict(w=4, itopk=64, integer=False)),
       ("real_qp_w8_itopk96", dict(w=8, itopk=96, integer=False)),
       ("deg12_p18_scalar_staging",
        dict(deg=12, p=18, w=3, itopk=24, frac_invalid=0.25)),
       ("codes_past_2GiB_w8_itopk96",
        dict(w=8, itopk=96, n=600_000, far=True)),
       ("codes_past_2GiB_w4_itopk64",
        dict(w=4, itopk=64, n=600_000, far=True, frac_invalid=0.1))])


def compare_hop(kernel_out, plain_out, exact: bool) -> dict:
    """K6 against its twin: with ``exact`` (integer-valued qp, every sum
    exact) ids, values and vis must be equal; otherwise values within
    PARITY_RTOL plus the floor, ids equal except at near-ties
    (``topk_agreement``), vis equal wherever the ids are."""
    import torch

    from raft_tpu_torch.stats.metrics import topk_agreement

    (ki, kd, kv), (pi, pd, pv) = kernel_out, plain_out
    fin = torch.isfinite(pd)
    err = (kd[fin].double() - pd[fin].double()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if exact:
        ok = (torch.equal(ki, pi) and torch.equal(kd, pd)
              and torch.equal(kv, pv))
        return {"ok": bool(ok), "exact": True, "max_abs_err": worst,
                "id_mismatches": int((ki != pi).sum()),
                "vis_mismatches": int((kv != pv).sum()),
                "compared": int(fin.sum())}
    top = float(pd[fin].abs().max()) if bool(fin.any()) else 0.0
    verdict = topk_agreement(pd, pi, kd, ki, rtol=PARITY_RTOL,
                             atol=PARITY_ATOL_FRAC * top)
    same = ki == pi
    vis_ok = bool((kv[same] == pv[same]).all())
    verdict.update(exact=False, vis_ok=vis_ok, ok=verdict["ok"] and vis_ok)
    return verdict


def hop_parity_phase(cases=HOP_PARITY_CASES, seed0=6000, dev="cuda"):
    """K6 against its plain twin on every synthetic case, in both modes:
    with the case's parents (``raft_cagra_hop``), and picking its own
    ``w`` parents (``raft_cagra_pick_hop``) from the case's buffer (holes
    at random slots, so its keys are unsorted) and then from the sorted
    buffer the twin's first hop returns. One line a case and mode."""
    import torch

    from raft_tpu_torch.ops import cagra_hop as ch

    worst = 0.0
    for i, (name, kw) in enumerate(cases):
        call = synthetic_hop(seed0 + i, dev=dev, **kw)
        n = call["graph"].shape[0]
        exact = kw.get("integer", True)
        picking = dict(call, parents=None, width=call["parents"].shape[1])
        after = ch.fused_hop_reference(**call)
        resorted = dict(picking, buf_ids=after[0], buf_d=after[1],
                        buf_vis=after[2])
        for mode, calls in (("parents", [call]),
                            ("picking", [picking, resorted])):
            verdicts = []
            for c in calls:
                got = ch.fused_hop(**c)
                torch.cuda.synchronize()
                verdicts.append(compare_hop(got, ch.fused_hop_reference(**c),
                                            exact))
            verdict = dict(verdicts[-1], ok=all(v["ok"] for v in verdicts),
                           max_abs_err=max(v["max_abs_err"]
                                           for v in verdicts))
            emit({"phase": "parity", "kernel": "cagra_hop", "case": name,
                  "mode": mode, "rows": n,
                  "code_bytes": n * call["nbr_codes"][0].numel(), **verdict})
            if not verdict["ok"]:
                raise AssertionError(f"cagra_hop ({mode}) disagrees with its "
                                     f"plain version on {name}: {verdicts}")
            worst = max(worst, verdict["max_abs_err"])
        del call, picking, resorted, after
    return worst


def hop_bound(calls):
    """Least time for one search's K6 launches: the graph rows and code
    records of the valid parents (deg·(4 + p) bytes each), the buffer read
    and written (12 bytes a slot each way), qp, and the parents where a
    call gives them, against the two fp32 multiply-adds per code byte of
    ``ip`` and ``nrm``. A picking call's parents are counted as K6 picks
    them (``pick_parents``)."""
    from raft_tpu_torch.ops import cagra_hop as ch

    nbytes = 0
    flops = 0
    for c in calls:
        q, itopk = c["buf_ids"].shape
        deg = c["graph"].shape[1]
        p = c["qp"].shape[1]
        parents = c["parents"]
        given = parents is not None
        if not given:
            parents = ch.pick_parents(c["buf_ids"], c["buf_d"], c["buf_vis"],
                                      c["width"])[1]
        valid = int((parents >= 0).sum())
        nbytes += (valid * deg * (4 + p) + 2 * q * itopk * 12 + q * p * 4
                   + (parents.numel() * 4 if given else 0))
        flops += valid * deg * p * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def with_parents(call):
    """A picking call (``parents=None``) as the parents-given call of the
    same hop: the torch pickup (``pick_parents``) the port ran before K6
    picked its own parents, with the picked slots marked visited."""
    from raft_tpu_torch.ops import cagra_hop as ch

    vis, parents = ch.pick_parents(call["buf_ids"], call["buf_d"],
                                   call["buf_vis"], call["width"])
    return dict(call, buf_vis=vis, parents=parents, width=None)


def fused_init_args(index, queries, sp, q_tile):
    """The arguments ``cagra.search`` gives ``_fused_init`` for one tile of
    ``q_tile`` rows under search params ``sp``: the padded queries, the
    generator seeded from ``sp.seed``, itopk and the random seed count."""
    import torch

    from raft_tpu_torch.cluster import kmeans_balanced

    qs = torch.nn.functional.pad(queries.float(),
                                 (0, 0, 0, q_tile - queries.shape[0]))
    (gen,) = kmeans_balanced.seeded_generators(sp.seed, 1, queries.device)
    return (index, qs, gen, int(min(sp.itopk_size, index.size)),
            int(max(1, sp.num_random_samplings)))


def fused_hop_inputs(index, queries, sp, q_tile, hops):
    """Every K6 launch of one fused search of ``queries`` under search
    params ``sp`` (one tile of ``q_tile`` rows, as the search ran it): the
    hop's keyword arguments, hop by hop, from the same seeding and hops,
    each a picking call (``parents=None``, the buffer before its pickup)."""
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch

    buf_ids, buf_d, buf_vis, qp = cagra._fused_init(
        *fused_init_args(index, queries, sp, q_tile))
    state = (buf_ids, buf_d, buf_vis)
    calls = []
    for _ in range(hops):
        calls.append(dict(buf_ids=state[0], buf_d=state[1], buf_vis=state[2],
                          parents=None, width=int(sp.search_width), qp=qp,
                          graph=index.graph, nbr_codes=index.nbr_codes))
        state = ch.fused_hop(**calls[-1])
    return calls


CAGRA_LADDER = (("fused", 64, 4), ("fused", 96, 8))   # the bench's fused rungs


def cagra_k1_inputs(dataset, params, res):
    """K1's class inputs on the CAGRA build's IVF-Flat candidate scan: the
    build's own index (same params and seed) and its first batch of
    dataset rows at kf = ideg + 1 → (calls, q_tile, kf, n_probes, batch)."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat

    n, dim = dataset.shape
    kf = min(params.intermediate_graph_degree, n - 1) + 1
    n_lists = int(max(16, min(65536, round((n / 976) ** 0.5) ** 2, n // 64)))
    n_probes = max(8, n_lists // 16)
    X = dataset.to(torch.float32)
    flat = ivf_flat.build(X, ivf_flat.IvfFlatParams(
        n_lists=n_lists, kmeans_trainset_fraction=float(min(1.0, max(
            0.1, 200_000 / n))), group_size=512, seed=params.seed), res=res)
    batch = int(max(4096, min(n, res.workspace_bytes // (kf * (dim + 8) * 4))))
    calls, qt = flat_path_class_inputs(flat, X[:batch], n_probes, kf, res)
    return calls, qt, kf, n_probes, batch


def cagra_phase(shared, params=None, recall_gate=0.95, dev="cuda"):
    """CAGRA at the bench's shape: build from the uint8 dataset (degrees
    128 → 64, the IVF-Flat candidate scan through K1 at kf 129, the
    compression payload), K1 at the build's own first candidate batch,
    the fused rungs with K6's launches, QPS at the chosen rung beside the
    compressed traversal's, K6 parity on the path's state after hop 3 and
    K6 at the path's inputs. ``params`` and ``recall_gate`` are the
    bench's unless a CPU rehearsal at a tiny size sets them."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    n, dim = dataset.shape
    q = qs.shape[0]
    params = params or cagra.CagraParams(
        intermediate_graph_degree=128, graph_degree=64, build_algo="auto",
        compress="auto")
    reset_counts()
    before = allocated()
    t = time.perf_counter()
    index = cagra.build(dataset, params, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    cost_row("cagra", index, before)
    k1_build = ss.STRIP_KERNEL.launches
    g = index.graph
    deg = index.graph_degree
    p = index.nbr_codes.shape[2]
    self_edges = int((g == torch.arange(n, device=g.device)[:, None]).sum())
    degree = (g >= 0).sum(dim=1)
    proj = index.proj
    orth = float((proj.T @ proj - torch.eye(p, device=proj.device)).abs().max())
    payload = {"nbr_codes": deg * p, "graph": deg * 4,
               "dataset": dim * dataset.element_size(), "norms": 4}
    setup = {"phase": "cagra.setup", "rows": n, "queries": q,
             "dataset_dtype": str(index.dataset.dtype).replace("torch.", ""),
             "graph_degree": deg, "compress_dim": p, "build_s": build_s,
             "build_phases_s": index.build_timings_s,
             "k1_launches_build": k1_build,
             "mean_degree": float(degree.float().mean()),
             "min_degree": int(degree.min()), "self_edges": self_edges,
             "proj_orthonormal_err": orth,
             "proj_energy": float(index.proj_energy),
             "code_scale": float(index.code_scale),
             "centroids": int(index.centroids.shape[0]),
             "payload_bytes_per_row": payload,
             "bytes_per_row": sum(payload.values())}
    emit(setup)
    if self_edges or int(degree.min()) < deg or orth > 1e-4 \
            or not 0 < setup["proj_energy"] <= 1.0001:
        raise AssertionError(f"CAGRA build invariants fail: {setup}")
    if k1_build <= 0:
        raise AssertionError("the CAGRA build never launched K1")

    # K1 on the build's candidate scan: the same IVF-Flat index (same
    # params and seed), its first batch of dataset rows at kf = ideg + 1
    calls, qt, kf, n_probes, batch = cagra_k1_inputs(dataset, params, res)
    k1_err = kernel_parity_at(calls, "strip_scan",
                              f"cagra_build_fp32_nprobe{n_probes}_kf{kf}")
    timing = kernel_timing(calls, "strip_scan", library_yardstick, dim * 4 + 4)
    batches = -(-n // batch)
    emit({"phase": "cagra.k1", "kf": kf, "n_probes": n_probes,
          "list_dtype": "float32", "batch_rows": batch, "batches": batches,
          "query_tile": qt, "ms_per_build_est": timing["ms"] * batches,
          "classes": [[c["w_blocks"] * 512, c["n_sub"],
                       int((c["strip_list"] >= 0).sum())] for c in calls],
          **timing})
    kernel_split(calls, "cagra.k1_split", kf=kf, list_dtype="float32",
                 tournament=False)
    del calls

    def run(sp, stats=None):
        return cagra.search(index, qs, K, sp, res=res, stats=stats)

    pick = None
    for trav, itopk, w in CAGRA_LADDER:
        sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=w,
                                     traversal=trav)
        reset_counts()
        st = {}
        v, i = run(sp, st)
        torch.cuda.synchronize()
        launches = ch.HOP_KERNEL.launches
        rec = neighborhood_recall(i, gt_i, v, gt_v)
        emit({"phase": "cagra.rung", "traversal": trav, "itopk": itopk,
              "width": w, "recall": rec, "k6_launches": launches, **st})
        if st["mode"] != "fused" or launches <= 0 \
                or launches != sum(st["hops"]):
            raise AssertionError(f"the fused rung did not run through K6 "
                                 f"once a hop: {st}, {launches} launches")
        if pick is None and rec >= recall_gate:
            pick = {"itopk": itopk, "width": w, "sp": sp}
    if pick is None:
        raise AssertionError(f"no fused CAGRA rung reaches recall@10 "
                             f"{recall_gate}")

    reset_counts()
    times, hops = [], []
    for _ in range(3):
        st = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        v, i = run(pick["sp"], st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        hops.append(st["hops"])
    launches = ch.HOP_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError("CAGRA returned non-finite or misshapen results")
    if rec < recall_gate:
        raise AssertionError(f"CAGRA recall@10 {rec} < {recall_gate}")
    if launches != sum(sum(h) for h in hops):
        raise AssertionError(f"K6 launches {launches} != hops {hops}")
    comp = cagra.CagraSearchParams(itopk_size=pick["itopk"],
                                   search_width=pick["width"],
                                   traversal="compressed")
    ctimes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cv, ci = run(comp)
        torch.cuda.synchronize()
        ctimes.append(time.perf_counter() - t)
    crec = neighborhood_recall(ci, gt_i, cv, gt_v)
    emit({"phase": "cagra.search", "traversal": "fused",
          "itopk": pick["itopk"], "width": pick["width"], "recall": rec,
          "qps": len(times) * q / sum(times), "batch_s": times,
          "hops": hops, "k6_launches": launches,
          "compressed_qps": len(ctimes) * q / sum(ctimes),
          "compressed_batch_s": ctimes, "compressed_recall": crec})
    obs_rung("cagra", lambda: run(pick["sp"]), q, "cagra::search",
             "cagra::hop", "cagra.search", "traversal.fused",
             ch.HOP_KERNEL)

    # filters: the traversal routes through filtered-out nodes and masks
    # the buffer at the exit re-rank; recall is printed, not gated (the
    # result is what the itopk buffer holds)
    filtered_rungs(
        shared, "cagra",
        lambda f: cagra.search(index, qs, K, pick["sp"], filter=f, res=res),
        ch.HOP_KERNEL, lambda f: {"itopk": pick["itopk"],
                                  "width": pick["width"],
                                  "pass_rate": f.pass_rate()}, gate=None)

    # K6 at the path's own inputs: every hop of one search (picking its
    # own parents, as the search runs it), parity on the state after hop
    # 3, time, twin time and bound
    st = {}
    run(pick["sp"], st)
    if st["tiles"] != 1:
        raise AssertionError(f"expected one fused tile, got {st}")
    calls = fused_hop_inputs(index, qs, pick["sp"], st["q_tile"],
                             st["hops"][0])
    mid = calls[3]
    verdict = compare_hop(ch.fused_hop(**mid), ch.fused_hop_reference(**mid),
                          exact=False)
    emit({"phase": "parity", "kernel": "cagra_hop", "mode": "picking",
          "case": f"cagra_path_after_hop3_itopk{pick['itopk']}"
                  f"_w{pick['width']}", **verdict})
    if not verdict["ok"]:
        raise AssertionError(f"cagra_hop disagrees with its plain version on "
                             f"the CAGRA path: {verdict}")
    k6_ms = cuda_ms(lambda: [ch.fused_hop(**c) for c in calls], reps=5)
    plain_ms = cuda_ms(lambda: [ch.fused_hop_reference(**c) for c in calls],
                       reps=1, warmup=1)
    bound_ms, bound_by, nbytes, flops = hop_bound(calls)
    # the parents-given entry at the same hops, with the torch pickup the
    # path ran before K6 picked its own parents (no longer on the path)
    given = [with_parents(c) for c in calls]
    given_ms = cuda_ms(lambda: [ch.fused_hop(**c) for c in given], reps=5)
    pickup_ms = cuda_ms(lambda: [ch.pick_parents(
        c["buf_ids"], c["buf_d"], c["buf_vis"], c["width"]) for c in calls],
        reps=3)
    del given
    # the rest of a fused search: seeding and the exit re-rank
    init_args = fused_init_args(index, qs, pick["sp"], st["q_tile"])
    glue = {
        "init_ms": cuda_ms(lambda: cagra._fused_init(*init_args), reps=3),
        "finish_ms": cuda_ms(lambda: cagra._fused_finish(
            index, init_args[1], calls[-1]["buf_ids"], K, st["refine_topk"]),
            reps=3)}
    emit({"phase": "cagra.k6", "itopk": pick["itopk"], "width": pick["width"],
          "hops": len(calls), "query_tile": st["q_tile"],
          "launches_per_search": len(calls), "ms": k6_ms,
          "ms_per_hop": k6_ms / len(calls), "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "flops": flops, "library_ms": None,
          "layout": ch.launch_layout(pick["itopk"], pick["width"],
                                     index.graph_degree),
          "parents_given_ms": given_ms,
          "torch_pickup_ms_off_path": pickup_ms, **glue})
    # the graph the hnsw export writes (cagra_hnsw_phase)
    HELD["cagra.graph"] = (index.graph.cpu(), rec)
    HELD["recall.cagra"] = ({"itopk": pick["itopk"], "width": pick["width"]},
                            rec)
    del calls, mid, index
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": verdict["max_abs_err"],
            "ms": k6_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, k1_err


# ---------------------------------------------------------------------------
# the resilience and observability core on the card: health, k-means, the
# paths under telemetry, faults and recovery
# ---------------------------------------------------------------------------

OBS_ROWS = []       # each path's obs rung line, for the obs phase
OBS_SPANS = []      # the span records of each rung's checked search
OBS_TRACE = "results/trace_chip_smoke.json"


def health_phase():
    """``obs.health.probe()`` on the card, in its bounded child process:
    healthy, within ``MAX_TIMEOUT``."""
    from raft_tpu_torch import obs

    rep = obs.probe()
    HELD["health"] = rep       # window 0 of the tuning phase's recording
    emit({"phase": "health", **rep.as_dict(),
          "max_timeout_s": obs.MAX_TIMEOUT})
    if not rep.healthy or rep.elapsed_s > obs.MAX_TIMEOUT:
        raise AssertionError(f"health probe: {rep}")


def span_pairs(spans):
    """(span name, parent name) of span records."""
    names = {s["span_id"]: s["name"] for s in spans}
    return {(s["name"], names.get(s["parent_id"])) for s in spans}


def obs_rung(path, run, q, entry, scan, prefix, backend, counter):
    """One path's 10k-query search (``run``) under telemetry: its span tree
    holds ``entry`` → ``scan``; the ``<prefix>.queries`` counter equals the
    queries served and ``<prefix>.<backend>`` (``backend.ragged``,
    ``traversal.fused``, ...) the searches run; the
    kernel's launches (``counter``) with telemetry on equal those with it
    off (for CAGRA, also the hops the ``cagra::hop`` spans report). Then
    QPS over 3 batches with telemetry off, on, and on in sync mode."""
    import torch

    from raft_tpu_torch import obs

    obs.disable()
    obs.disable_sync()
    reset_counts()
    run()
    torch.cuda.synchronize()
    off_launches = counter.launches
    qps_off, s_off = host_qps(run, q)
    obs.enable()
    obs.reset()
    obs.clear_spans()
    reset_counts()
    run()
    torch.cuda.synchronize()
    on_launches = counter.launches
    spans = obs.spans()
    counters = obs.snapshot()["counters"]
    OBS_SPANS.extend(spans)
    pairs = span_pairs(spans)
    searches = counters.get(f"{prefix}.{backend}", 0)
    hop_sum = sum(s["attrs"]["hops"] for s in spans if s["name"] == scan
                  and "hops" in (s.get("attrs") or {}))
    row = {"phase": f"{path}.obs", "entry": entry, "scan": scan,
           "span_tree_ok": (scan, entry) in pairs, "spans": len(spans),
           "queries_counted": counters.get(f"{prefix}.queries", 0),
           "backend": backend, "backend_count": searches,
           "launches_off": off_launches, "launches_on": on_launches,
           "hops_in_spans": hop_sum or None}
    if not row["span_tree_ok"] or row["queries_counted"] != q \
            or searches != 1 or on_launches != off_launches \
            or on_launches <= 0 or (hop_sum and hop_sum != on_launches):
        obs.disable()
        raise AssertionError(f"{path}.obs: {row}, spans {sorted(pairs)}")
    qps_on, s_on = host_qps(run, q)
    obs.enable_sync()
    qps_sync, s_sync = host_qps(run, q)
    obs.disable_sync()
    obs.disable()
    obs.reset()
    obs.clear_spans()
    row.update(qps_off=qps_off, batch_s_off=s_off, qps_on=qps_on,
               batch_s_on=s_on, qps_sync=qps_sync, batch_s_sync=s_sync,
               on_over_off=qps_on / qps_off, sync_over_off=qps_sync / qps_off)
    emit(row)
    OBS_ROWS.append(row)


def obs_phase():
    """The Chrome trace of every path's checked search, written under
    ``results/``, and the QPS table of the obs rungs."""
    from raft_tpu_torch.core.fsio import atomic_write
    from raft_tpu_torch.obs import tracing

    doc = tracing.chrome_trace(span_records=OBS_SPANS, events=[],
                               extra={"source": "chip_smoke.py obs rungs"})
    with atomic_write(OBS_TRACE, "w") as f:
        json.dump(doc, f)
    emit({"phase": "obs", "trace": OBS_TRACE,
          "span_count": len(doc["traceEvents"]),
          "paths": [r["phase"][:-4] for r in OBS_ROWS],
          "qps": {r["phase"][:-4]: {k: r[k] for k in (
              "qps_off", "qps_on", "qps_sync", "on_over_off",
              "sync_over_off")} for r in OBS_ROWS}})
    if len(OBS_ROWS) != 6 or not doc["traceEvents"]:
        raise AssertionError(f"obs: {len(OBS_ROWS)} rungs ran, "
                             f"{len(doc['traceEvents'])} spans")


KMEANS_CLUSTERS = 1024       # the bench's n_lists
KMEANS_PREDICT_ROWS = 10_000
KMEANS_SUB_ROWS = 100_000    # the card-against-CPU fit
KMEANS_SUB_ITERS = 10
KMEANS_RISE_RTOL = 1e-5      # an fp32 sum of 1M terms, not a rise


def kmeans_phase(shared, dev="cuda"):
    """Lloyd k-means on the card at the bench's size: ``kmeans.fit`` with
    ``KMeansParams(n_clusters=1024)`` (k-means++, max_iter 300, tol 1e-4,
    n_init 1) on the 1M × 128 dataset as fp32, seeding and EM seconds
    apart, the inertia never rising from one iteration to the next,
    ``cluster_cost`` equal to the reported inertia, ``predict`` equal to
    the argmin of ``pairwise_distance`` but at ties, the card's and the
    CPU's ``init="array"`` fits equal on a 100,000-row subsample, and
    ``metric="euclidean"`` once."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.ops.distance import (fused_l2_nn_argmin,
                                             pairwise_distance)

    res = Resources(device=dev)
    X = shared["dataset"].to(torch.float32)
    n = X.shape[0]
    params = kmeans.KMeansParams(n_clusters=KMEANS_CLUSTERS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = kmeans.fit(X, params, res=res)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    # the same fit in its two parts, timed apart: the seeding, then the EM
    # loop from that seed, keeping each iteration's inertia
    gen = torch.Generator(device=X.device)
    gen.manual_seed(params.seed)
    w = torch.ones(n, device=X.device)
    t = time.perf_counter()
    c0 = kmeans._init_plus_plus(gen, X, w, KMEANS_CLUSTERS)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t
    history = []
    t = time.perf_counter()
    _, inertia_em, n_iter_em = kmeans._lloyd(
        X, c0, w, params.max_iter, params.tol, res.workspace_bytes, history)
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t
    rises = [(b - a) / a for a, b in zip(history, history[1:]) if b > a]
    cost = float(kmeans.cluster_cost(X, out.centroids, res=res))
    inertia = float(out.inertia)
    HELD["kmeans"] = (fit_s, inertia)
    # predict on 10,000 rows against the argmin of the full distance block
    rows = X[:KMEANS_PREDICT_ROWS]
    labels, _ = kmeans.predict(rows, out.centroids, res=res)
    d = pairwise_distance(rows, out.centroids, res=res)
    best = torch.argmin(d, dim=1)
    diff = labels != best
    gap = (d.gather(1, labels[:, None]) - d.gather(1, best[:, None])).abs()
    tie_tol = 1e-4 * d.gather(1, best[:, None]).abs() + 1e-3
    ties_only = bool((gap[diff] <= tie_tol[diff]).all())
    row = {"phase": "kmeans", "rows": n, "dim": X.shape[1],
           "n_clusters": KMEANS_CLUSTERS, "fit_s": fit_s, "n_iter": out.n_iter,
           "inertia": inertia, "seed_s": seed_s, "em_s": em_s,
           "em_n_iter": n_iter_em, "em_inertia": float(inertia_em),
           "em_s_per_iter": em_s / n_iter_em,
           "inertia_first": history[0], "inertia_last": history[-1],
           "largest_rise_rel": max(rises, default=0.0),
           "cluster_cost": cost, "predict_rows": KMEANS_PREDICT_ROWS,
           "predict_mismatches": int(diff.sum()),
           "predict_mismatches_ties_only": ties_only}
    emit(row)
    if max(rises, default=0.0) > KMEANS_RISE_RTOL:
        raise AssertionError(f"kmeans: the inertia rose: {history}")
    if abs(cost - inertia) > 1e-4 * abs(inertia):
        raise AssertionError(f"kmeans: cluster_cost {cost} != inertia "
                             f"{inertia}")
    if not ties_only or not bool(torch.isfinite(out.centroids).all()):
        raise AssertionError(f"kmeans: predict disagrees with the argmin: "
                             f"{row}")

    # the card's fit against the CPU's from one start on a subsample. A row
    # whose two nearest centroids are within the fp32 rounding of the gemm
    # may take either on either device, and one such flip moves its two
    # clusters' means and every later step: so the two devices are held in
    # lockstep (each step from the same centroids: labels equal but at
    # near-ties, every untouched cluster's mean at rtol 1e-4), then the two
    # free-running fits' n_iter and inertia
    sub = X[torch.randperm(n, generator=gen, device=X.device)
            [:KMEANS_SUB_ROWS]]
    start = sub[:KMEANS_CLUSTERS].clone()
    sub_cpu, c = sub.cpu(), start.cpu()
    w_card = torch.ones(KMEANS_SUB_ROWS, device=X.device)
    w_cpu = torch.ones(KMEANS_SUB_ROWS)
    xn = (sub_cpu.double() ** 2).sum(1)
    steps = []
    for _ in range(KMEANS_SUB_ITERS):
        _, lab_card = fused_l2_nn_argmin(sub, c.to(X.device))
        _, lab_cpu = fused_l2_nn_argmin(sub_cpu, c)
        lab_card = lab_card.cpu()
        flip = torch.nonzero(lab_card != lab_cpu)[:, 0]
        cd = c.double()
        d_a = ((sub_cpu[flip].double() - cd[lab_card[flip]]) ** 2).sum(1)
        d_b = ((sub_cpu[flip].double() - cd[lab_cpu[flip]]) ** 2).sum(1)
        bound = 1e-5 * (xn[flip] + (cd ** 2).sum(1).max())
        near = bool(((d_a - d_b).abs() <= bound).all())
        new_card, _ = kmeans._update_centers(sub, lab_card.to(X.device),
                                             w_card, KMEANS_CLUSTERS,
                                             c.to(X.device))
        new_cpu, _ = kmeans._update_centers(sub_cpu, lab_cpu, w_cpu,
                                            KMEANS_CLUSTERS, c)
        touched = torch.zeros(KMEANS_CLUSTERS, dtype=torch.bool)
        touched[lab_card[flip]] = True
        touched[lab_cpu[flip]] = True
        same = bool(torch.allclose(new_card.cpu()[~touched],
                                   new_cpu[~touched], rtol=1e-4, atol=1e-4))
        steps.append({"flips": int(flip.numel()), "flips_near_ties": near,
                      "clusters_touched": int(touched.sum()),
                      "others_allclose": same})
        c = new_cpu
    ap = kmeans.KMeansParams(n_clusters=KMEANS_CLUSTERS, init="array",
                             max_iter=KMEANS_SUB_ITERS)
    t = time.perf_counter()
    card = kmeans.fit(sub, ap, centroids=start, res=res)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = kmeans.fit(sub_cpu, ap, centroids=start.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t
    free_diff = (card.centroids.cpu() - cpu.centroids).abs()
    inertia_rel = abs(float(card.inertia) - float(cpu.inertia)) \
        / float(cpu.inertia)
    # metric="euclidean" from the fitted centroids: the sum of distances
    t = time.perf_counter()
    eu = kmeans.fit(X, kmeans.KMeansParams(
        n_clusters=KMEANS_CLUSTERS, init="array", metric="euclidean"),
        centroids=out.centroids, res=res)
    torch.cuda.synchronize()
    eu_s = time.perf_counter() - t
    d2, _ = fused_l2_nn_argmin(X, eu.centroids)
    eu_sum = float(torch.sqrt(d2).sum())
    row = {"phase": "kmeans.array", "rows": KMEANS_SUB_ROWS,
           "max_iter": KMEANS_SUB_ITERS, "lockstep": steps,
           "card_n_iter": card.n_iter, "cpu_n_iter": cpu.n_iter,
           "card_s": card_s, "cpu_s": cpu_s,
           "free_running_centroids_allclose": bool(torch.allclose(
               card.centroids.cpu(), cpu.centroids, rtol=1e-4, atol=1e-4)),
           "free_running_max_abs_diff": float(free_diff.max()),
           "free_running_clusters_differing": int(
               (free_diff > 1e-4 + 1e-4 * cpu.centroids.abs()).any(1).sum()),
           "card_inertia": float(card.inertia),
           "cpu_inertia": float(cpu.inertia), "inertia_rel_diff": inertia_rel,
           "euclidean_n_iter": eu.n_iter, "euclidean_s": eu_s,
           "euclidean_inertia": float(eu.inertia),
           "sum_of_distances": eu_sum}
    emit(row)
    if not all(st["flips_near_ties"] and st["others_allclose"]
               for st in steps) or card.n_iter != cpu.n_iter \
            or inertia_rel > 1e-4:
        raise AssertionError(f"kmeans: the card's fit differs from the "
                             f"CPU's: {row}")
    if abs(eu_sum - float(eu.inertia)) > 1e-4 * eu_sum:
        raise AssertionError(f"kmeans: the euclidean inertia is not the sum "
                             f"of distances: {row}")


FAULT_ROWS = 100_000         # the faultpoint sweep's indexes


def faults_phase(shared, dev="cuda"):
    """Faults and recovery on the card: the 1M streamed IVF-BQ build with
    ``ivf_bq.build.encode_chunk=oom:1`` armed bit-identical to the unarmed
    build; a real CUDA OOM in brute force recovered by halving the tile;
    every faultpoint of the port armed once, surfacing classified, then
    serving; a spent soft deadline keeping the first of three k-means
    fits."""
    import tempfile
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources, obs, resilience, serving
    from raft_tpu_torch.cluster import kmeans, kmeans_balanced
    from raft_tpu_torch.core import serialize
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import (brute_force, cagra, ivf_bq,
                                          ivf_flat, ivf_pq)

    res = Resources(device=dev)
    dataset, qs, host = shared["dataset"], shared["queries"], shared["host"]
    n, dim = host.shape

    # (1) the degraded streamed encode: two builds in deterministic mode
    # (the balanced k-means' index_add_ sums in a fixed order), one armed
    def bq_build():
        out = ivf_bq.build_streaming(
            lambda s, e: host[s:e], n, dim, ivf_bq.IvfBqParams(
                n_lists=N_LISTS, kmeans_trainset_fraction=0.2),
            res=res, chunk_rows=STREAM_CHUNK_ROWS)
        torch.cuda.synchronize()
        return out

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        clean = bq_build()
        obs.enable()
        obs.reset()
        resilience.clear_events()
        resilience.arm_faults("ivf_bq.build.encode_chunk=oom:1")
        degraded = bq_build()
        resilience.clear_faults()
        counters = obs.snapshot()["counters"]
        obs.disable()
        obs.reset()
    finally:
        torch.use_deterministic_algorithms(False)
    same = {name: bool(torch.equal(getattr(clean, name),
                                   getattr(degraded, name)))
            for name in ("centers", "list_codes", "list_scale", "list_bias",
                         "list_ids")}
    events = [e for e in resilience.recent_events()
              if e["event"] == "degraded_chunk"]
    row = {"phase": "faults.bq_encode", "rows": n,
           "chunks": -(-n // STREAM_CHUNK_ROWS), "bit_identical": same,
           "degraded_chunk": counters.get("ivf_bq.build.degraded_chunk", 0),
           "retries_oom": counters.get("resilience.retries.oom", 0),
           "sub_chunk_rows": [e["chunk_rows"] for e in events]}
    emit(row)
    if not all(same.values()) or row["degraded_chunk"] != 1:
        raise AssertionError(f"faults.bq_encode: {row}")
    del clean, degraded
    torch.cuda.empty_cache()

    # (2) a real CUDA OOM: a tile whose (queries × tile_rows) fp32 block is
    # larger than the card's free memory, recovered by halving the tile
    index = brute_force.build(dataset, res=res)
    free, total = torch.cuda.mem_get_info()
    q_oom = int(free // (4 * n)) + 1024
    queries = dataset[torch.arange(q_oom, device=dataset.device) % n]
    obs.enable()
    obs.reset()
    resilience.clear_events()
    t = time.perf_counter()
    v, i = brute_force.search(index, queries, K, tile_rows=n, res=res)
    torch.cuda.synchronize()
    oom_s = time.perf_counter() - t
    counters = obs.snapshot()["counters"]
    obs.disable()
    obs.reset()
    steps = [(e["from_size"], e["to_size"]) for e in resilience.recent_events()
             if e["event"] == "degraded_tile"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    dv, di = brute_force.search(index, queries, K, res=res)
    torch.cuda.synchronize()
    default_s = time.perf_counter() - t
    diff = i != di
    ties_only = bool(torch.allclose(v[diff], dv[diff], rtol=1e-5, atol=1e-3))
    row = {"phase": "faults.real_oom", "queries": q_oom, "rows": n,
           "free_bytes": free, "total_bytes": total,
           "block_bytes": 4 * q_oom * n, "steps": steps,
           "retries_oom": counters.get("resilience.retries.oom", 0),
           "degraded_s": oom_s, "default_tile_s": default_s,
           "id_mismatches": int(diff.sum()), "mismatches_ties_only": ties_only,
           "values_max_abs_err": float((v - dv).abs().max())}
    emit(row)
    if row["retries_oom"] < 1 or not ties_only:
        raise AssertionError(f"faults.real_oom: {row}")
    del index, queries, v, i, dv, di
    torch.cuda.empty_cache()

    # (3) every faultpoint once, on small indexes of the dataset's rows
    sub = dataset[:FAULT_ROWS]
    q = qs[:1000]
    flat = ivf_flat.build(sub, ivf_flat.IvfFlatParams(
        n_lists=64, group_size=512), res=res)
    pq = ivf_pq.build(sub, ivf_pq.IvfPqParams(
        n_lists=64, pq_dim=64, group_size=512), res=res)
    bq = ivf_bq.build(sub, ivf_bq.IvfBqParams(n_lists=64), res=res)
    stores = {k: serving.PagedListStore.from_index(v, page_rows=128,
                                                   res=res)
              for k, v in (("flat", flat), ("pq", pq), ("bq", bq))}
    cag = cagra.build(sub[:20_000], cagra.CagraParams(
        intermediate_graph_degree=64, graph_degree=32, compress="on"),
        res=res)
    fused = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                    traversal="fused")
    half = Bitset.from_mask(torch.arange(FAULT_ROWS) % 2 == 0, device=dev)
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "fault.bin"
    serialize.save_arrays(path, {"kind": "t"}, {"a": torch.arange(8)})
    cases = {
        "brute_force.search": lambda: brute_force.search(
            brute_force.build(sub, res=res), q, K, res=res),
        "ivf_flat.search.filter": lambda: ivf_flat.search(
            flat, q, K, filter=half, res=res),
        "ivf_flat.search.scan": lambda: ivf_flat.search(flat, q, K, res=res),
        "ivf_flat.search_paged.scan": lambda: ivf_flat.search_paged(
            stores["flat"], q, K, res=res),
        "ivf_pq.search.filter": lambda: ivf_pq.search(
            pq, q, K, filter=half, res=res),
        "ivf_pq.search.scan": lambda: ivf_pq.search(pq, q, K, res=res),
        "ivf_pq.search_paged.scan": lambda: ivf_pq.search_paged(
            stores["pq"], q, K, res=res),
        "ivf_bq.search.filter": lambda: ivf_bq.search(
            bq, q, K, filter=half, res=res),
        "ivf_bq.search.scan": lambda: ivf_bq.search(bq, q, K, res=res),
        "ivf_bq.search_paged.scan": lambda: ivf_bq.search_paged(
            stores["bq"], q, K, res=res),
        "ivf_bq.build.encode_chunk": lambda: ivf_bq.build_streaming(
            lambda s, e: host[s:e], FAULT_ROWS, dim,
            ivf_bq.IvfBqParams(n_lists=64), res=res, chunk_rows=50_000),
        "cagra.build": lambda: cagra.build(sub[:5000], cagra.CagraParams(
            intermediate_graph_degree=32, graph_degree=16), res=res),
        "cagra.search": lambda: cagra.search(cag, q, K, fused, res=res),
        "cagra.search.hop": lambda: cagra.search(cag, q, K, fused, res=res),
        "kmeans.fit.em": lambda: kmeans.fit(sub, kmeans.KMeansParams(
            n_clusters=64, max_iter=5), res=res),
        "kmeans_balanced.fit.em": lambda: kmeans_balanced.fit(sub, 64,
                                                              res=res),
        "serving.store.upsert": lambda: stores["flat"].upsert(
            q[:32], ids=torch.arange(UPSERT_ID0, UPSERT_ID0 + 32)),
        "serialize.save.write": lambda: serialize.save_arrays(
            path, {"kind": "t"}, {"a": torch.arange(9)}),
        "serialize.load.read": lambda: serialize.load_arrays(path),
    }
    swept = []
    for site, call in cases.items():
        # transient: the sites that degrade on an OOM would recover from one
        resilience.arm_faults(f"{site}=transient:1")
        try:
            call()
            kind = None
        except resilience.FaultInjected as e:
            kind = resilience.classify(e)
        resilience.clear_faults()
        call()
        torch.cuda.synchronize()
        swept.append({"site": site, "surfaced": kind})
    tmp.cleanup()
    emit({"phase": "faults.sweep", "sites": swept})
    bad = [s for s in swept if s["surfaced"] != resilience.TRANSIENT]
    if bad:
        raise AssertionError(f"faults.sweep: {bad}")
    del flat, pq, bq, stores, cag
    torch.cuda.empty_cache()

    # (4) a soft deadline spent before k-means starts: the first of three
    # fits comes back, marked degraded
    with resilience.Deadline(0.0, hard=False) as dl:
        t = time.perf_counter()
        out = kmeans.fit(sub, kmeans.KMeansParams(
            n_clusters=KMEANS_CLUSTERS, n_init=3), res=res)
        torch.cuda.synchronize()
        dl_s = time.perf_counter() - t
    row = {"phase": "faults.deadline", "rows": FAULT_ROWS,
           "n_clusters": KMEANS_CLUSTERS, "n_init": 3,
           "degraded": dl.degraded, "sites": dl.degraded_sites,
           "n_iter": out.n_iter, "inertia": float(out.inertia),
           "seconds": dl_s}
    emit(row)
    if not dl.degraded or dl.degraded_sites != ["kmeans.fit"]:
        raise AssertionError(f"faults.deadline: {row}")


AB_SHORT = {"strip_scan": "k1", "bq_scan": "k2", "paged_scan": "k3",
            "paged_bq_scan": "k4"}


def reads_no_qids(kernel, src) -> bool:
    """Whether the K1 source ``src`` is from before K1's entries took
    ``qids``."""
    return kernel == "strip_scan" and "qids" not in src.read_text()


def older_entry(fn, new_fn, kernel, src):
    """``fn``, an entry of an older tree's kernel library (source ``src``),
    typed as this tree's ``new_fn``. A K1 from before its entries took
    ``qids`` (argument 4 here) gets an adapter that drops it: the A/B
    hands that K1 its calls on the grouped operand (``grouped_calls``),
    which pass it null."""
    types = list(new_fn.argtypes)
    no_qids = reads_no_qids(kernel, src)
    if no_qids:
        del types[4]
    fn.argtypes, fn.restype = types, new_fn.restype
    if not no_qids:
        return fn

    def call(*args):
        if args[4] is not None:
            raise ValueError(f"{src} reads no qids")
        return fn(*args[:4], *args[5:])

    return call


def ab_phase(old_tree, shared, dev="cuda"):
    """The strip kernels K1–K4 of an older checkout (``old_tree``, e.g. a
    ``git archive`` of the parent commit) against this tree's, in one
    process on one card, at the paths' own class inputs, in the order old,
    new, new, old: K1 at the IVF-PQ path (int8, kf 20, the tournament), the
    IVF-Flat path (uint8, kf 10) and the CAGRA build's candidate scan (fp32,
    kf 129); K2 at the IVF-BQ path; K3 at the flat serving path (uint8, kf
    10) and the PQ serving path (the int8 cache, kf 20), K4 at the bq
    serving path. The older sources are built by nvcc beside that tree
    (both builds' ptxas lines are printed); the wrappers, plan and inputs
    are this tree's (the four kernels' C interfaces are the same, but for
    K1's ``qids``: an older K1 that reads none gets the classes grouped,
    this tree's K1 reads them by id as the search does); each
    kernel's product alone as well (``ab.k1_product`` .. ``ab.k4_product``)
    where the older tree has its product-only instantiation. Then K5 and
    K1 at path level: each tree's LUT search and IVF-PQ ragged search in a
    process of its own, on one index file and one query file, old, new,
    new, old, twice (``AB_ORDER``; the median of each tree's search ms,
    QPS, kernel ms and launches)."""
    import ctypes
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import _native

    res = Resources(device=dev)
    calls, *_ = cagra_k1_inputs(shared["dataset"], cagra.CagraParams(
        intermediate_graph_degree=128, graph_degree=64), res)
    keep_for_ab(("strip_scan", "cagra_fp32_kf129"), calls)
    out = Path(old_tree) / "raft_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    old_fns, old_libs, old_grouped, cases = {}, {}, {}, []
    for name in ("strip_scan", "bq_scan", "paged_scan", "paged_bq_scan"):
        src = Path(old_tree) / "raft_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
        lib = out / f"lib{name}-ab.so"
        built = subprocess.run(
            [_native.nvcc(), *_native.NVCC_FLAGS, *_native.PTXAS_FLAGS, "-o",
             str(lib), str(src)], check=True, capture_output=True, text=True)
        emit({"phase": "ab.ptxas", "kernel": name,
              "old": _native.parse_ptxas(built.stdout + built.stderr),
              "new": _native.resource_usage(_native.CSRC / f"{name}.cu")})
        mod, getter, _ = launcher_of(name)
        new_fn = getattr(mod, getter)()
        old_libs[name] = ctypes.CDLL(str(lib))
        old_fn = older_entry(getattr(old_libs[name], new_fn.__name__),
                             new_fn, name, src)
        old_fns[name] = (old_fn, new_fn)
        old_grouped[name] = reads_no_qids(name, src)
    for key in [k for k in AB_INPUTS if isinstance(k, tuple)]:
        name, shape = key
        # this tree's K1 reads the rows by id, as the search hands them; an
        # older K1 that reads no qids gets the same classes grouped
        calls = {"new": AB_INPUTS[key]}
        calls["old"] = (grouped_calls(calls["new"]) if old_grouped[name]
                        else calls["new"])
        mod, getter, _ = launcher_of(name)
        old_fn, new_fn = old_fns[name]
        old_lib = old_libs[name]
        wrapper = _kernel_pair(name)[0]
        times = []
        for which in ("old", "new", "new", "old"):
            fn = old_fn if which == "old" else new_fn
            setattr(mod, getter, lambda fn=fn: fn)
            times.append([which, cuda_ms(lambda cs=calls[which]: [
                wrapper(**c) for c in cs])])
        # the two trees' results held as the parity phases hold a kernel
        # against its twin: ids equal except at near-ties, values in rtol
        verdicts = []
        for c_old, c in zip(calls["old"], calls["new"]):
            setattr(mod, getter, lambda: old_fn)
            old_out = wrapper(**c_old)
            setattr(mod, getter, lambda: new_fn)
            verdicts.append(compare(wrapper(**c), old_out, c["strip_list"],
                                    c["strip_rows"]))
        old_ms = [t for w, t in times if w == "old"]
        new_ms = [t for w, t in times if w == "new"]
        cases.append({"kernel": name, "inputs": shape, "order": times,
                      "launches_per_search": len(calls["new"]),
                      "old_ms_mean": sum(old_ms) / 2,
                      "new_ms_mean": sum(new_ms) / 2,
                      "new_over_old": sum(new_ms) / sum(old_ms),
                      "same_ids_but_near_ties": all(v["ok"] for v in verdicts),
                      "id_mismatch_frac": max(v["id_mismatch_frac"]
                                              for v in verdicts),
                      "max_abs_err": max(v["max_abs_err"] for v in verdicts)})
        emit({"phase": "ab", **cases[-1]})
        product = launcher_of(name)[2]
        if hasattr(old_lib, product):
            # the product alone (the product-only instantiations): the old
            # tree's loop against this tree's at the same inputs
            old_p = older_entry(getattr(old_lib, product), new_fn, name,
                                Path(old_tree) / "raft_tpu_torch" / "ops"
                                / "csrc" / f"{name}.cu")
            new_p = getattr(_native.load(name), product)
            new_p.argtypes, new_p.restype = new_fn.argtypes, new_fn.restype
            prod = []
            for which in ("old", "new", "new", "old"):
                fn = old_p if which == "old" else new_p
                setattr(mod, getter, lambda fn=fn: fn)
                prod.append([which, cuda_ms(lambda cs=calls[which]: [
                    wrapper(**c) for c in cs])])
            emit({"phase": f"ab.{AB_SHORT[name]}_product", "inputs": shape,
                  "order": prod,
                  "old_ms_mean": sum(t for w, t in prod if w == "old") / 2,
                  "new_ms_mean": sum(t for w, t in prod if w == "new") / 2})
        setattr(mod, getter, lambda fn=new_fn: fn)

    # K5 and K1 at path level: each tree's LUT search and IVF-PQ ragged
    # search in a process of its own, telemetry off
    for path, backend, kernel in (("lut", "pallas", "pq_scan"),
                                  ("main", "ragged", "strip_scan")):
        index_file, query_file, pick = AB_INPUTS[path]
        runs = []
        for which in AB_ORDER:
            tree = Path(old_tree) if which == "old" else Path(__file__).parent
            ids_file = AB_FILES / f"{path}_ids_{which}.pt"
            done = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--search-child", str(tree.resolve()), backend,
                 str(index_file), str(query_file), str(pick["n_probes"]),
                 str(pick["k_fetch"]), str(ids_file)],
                check=True, capture_output=True, text=True)
            line = json.loads(done.stdout.strip().splitlines()[-1])
            runs.append({"tree": which, **line})
            emit({"phase": f"ab.{path}_run", **runs[-1]})
        same_ids = bool(torch.equal(
            torch.load(AB_FILES / f"{path}_ids_old.pt"),
            torch.load(AB_FILES / f"{path}_ids_new.pt")))

        def mean(which, key):
            return median([r[key] for r in runs if r["tree"] == which])

        row = {"kernel": kernel, "inputs": f"{path}_path_search",
               "backend": backend, "n_probes": pick["n_probes"],
               "k_fetch": pick["k_fetch"],
               "old_search_ms": mean("old", "search_ms"),
               "new_search_ms": mean("new", "search_ms"),
               "old_qps": mean("old", "qps"), "new_qps": mean("new", "qps"),
               "new_over_old_qps": mean("new", "qps") / mean("old", "qps"),
               "old_kernel_ms": mean("old", "kernel_ms"),
               "new_kernel_ms": mean("new", "kernel_ms"),
               "old_launches": mean("old", "launches"),
               "new_launches": mean("new", "launches"),
               "same_ids": same_ids}
        emit({"phase": "ab", **row})
        cases.append(row)
    return cases


def ab_k6_phase(old_tree, shared, dev="cuda"):
    """K6 of an older checkout against this tree's on the CAGRA path at the
    bench's rung (itopk 64, width 4), one index built here: (1) the older
    ``raft_cagra_hop`` against this tree's at the same parents-given calls
    (each hop of one search, parents from the torch pickup), old, new, new,
    old, the two results held as the parity phases hold a kernel and its
    twin; (2) one search's hops as the older tree ran them (the torch
    pickup, then its K6) against this tree's picking entry; (3) each
    tree's fused search in a process of its own (``--cagra-child``) on one
    index file, in ``AB_ORDER``: the median QPS, recall@10 and K6
    launches."""
    import ctypes
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import _native
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    qs = shared["queries"]
    gt_v, gt_i = shared["gt"]
    index = cagra.build(shared["dataset"], cagra.CagraParams(
        intermediate_graph_degree=128, graph_degree=64, build_algo="auto",
        compress="auto"), res=res)
    sp = cagra.CagraSearchParams(itopk_size=64, search_width=4,
                                 traversal="fused")
    st = {}
    cagra.search(index, qs, K, sp, res=res, stats=st)
    calls = fused_hop_inputs(index, qs, sp, st["q_tile"], st["hops"][0])
    given = [with_parents(c) for c in calls]

    src = Path(old_tree) / "raft_tpu_torch" / "ops" / "csrc" / "cagra_hop.cu"
    out = Path(old_tree) / "raft_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libcagra_hop-ab.so"
    built = subprocess.run(
        [_native.nvcc(), *_native.NVCC_FLAGS, *_native.PTXAS_FLAGS, "-o",
         str(lib), str(src)], check=True, capture_output=True, text=True)
    emit({"phase": "ab.ptxas", "kernel": "cagra_hop",
          "old": _native.parse_ptxas(built.stdout + built.stderr),
          "new": _native.resource_usage(_native.CSRC / "cagra_hop.cu")})
    new_fn = ch._kernel_fn()
    old_fn = ctypes.CDLL(str(lib)).raft_cagra_hop
    old_fn.argtypes, old_fn.restype = new_fn.argtypes, new_fn.restype

    def use(fn):
        ch._kernel_fn = lambda: fn

    def turns(run_old, run_new):
        order = []
        for which in ("old", "new", "new", "old"):
            order.append([which, cuda_ms(run_old if which == "old"
                                         else run_new, reps=5)])
        return {"order": order,
                "old_ms_mean": sum(t for w, t in order if w == "old") / 2,
                "new_ms_mean": sum(t for w, t in order if w == "new") / 2}

    def given_hops(fn):
        use(fn)
        return [ch.fused_hop(**c) for c in given]

    line = turns(lambda: given_hops(old_fn), lambda: given_hops(new_fn))
    verdicts = [compare_hop(a, b, exact=False) for a, b in
                zip(given_hops(new_fn), given_hops(old_fn))]
    cases = [{"kernel": "cagra_hop", "inputs": "cagra_path_parents_given",
              "hops": len(given), **line,
              "new_over_old": line["new_ms_mean"] / line["old_ms_mean"],
              "same_ids_but_near_ties": all(v["ok"] for v in verdicts),
              "id_mismatch_frac": max(v["id_mismatch_frac"]
                                      for v in verdicts),
              "max_abs_err": max(v["max_abs_err"] for v in verdicts)}]
    emit({"phase": "ab", **cases[-1]})
    del verdicts, given

    def old_search_hops():
        use(old_fn)
        return [ch.fused_hop(**with_parents(c)) for c in calls]

    def new_search_hops():
        use(new_fn)
        return [ch.fused_hop(**c) for c in calls]

    line = turns(old_search_hops, new_search_hops)
    use(new_fn)
    cases.append({"kernel": "cagra_hop",
                  "inputs": "cagra_path_hops_old_pickup_plus_k6_vs_picking",
                  "hops": len(calls), **line,
                  "new_over_old": line["new_ms_mean"] / line["old_ms_mean"]})
    emit({"phase": "ab", **cases[-1]})
    del calls

    # the fused search of each tree in a process of its own, one index file
    AB_FILES.mkdir(parents=True, exist_ok=True)
    index_file = AB_FILES / "cagra_index.pt"
    query_file = AB_FILES / "cagra_queries.pt"
    torch.save({k: v.cpu() for k, v in index.arrays().items()}, index_file)
    torch.save(qs.cpu(), query_file)
    del index
    torch.cuda.empty_cache()
    runs = []
    for which in AB_ORDER:
        tree = Path(old_tree) if which == "old" else Path(__file__).parent
        ids_file = AB_FILES / f"cagra_ids_{which}.pt"
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--cagra-child",
             str(tree.resolve()), str(index_file), str(query_file),
             str(sp.itopk_size), str(sp.search_width), str(ids_file)],
            check=True, capture_output=True, text=True)
        run = {"tree": which,
               **json.loads(done.stdout.strip().splitlines()[-1])}
        ids = torch.load(ids_file).to(gt_i.device)
        dists = torch.load(str(ids_file) + ".d").to(gt_v.device)
        run["recall"] = neighborhood_recall(ids, gt_i, dists, gt_v)
        runs.append(run)
        emit({"phase": "ab.cagra_run", **run})
    same_ids = bool(torch.equal(torch.load(AB_FILES / "cagra_ids_old.pt"),
                                torch.load(AB_FILES / "cagra_ids_new.pt")))

    def mean(which, key):
        return median([r[key] for r in runs if r["tree"] == which])

    cases.append({"kernel": "cagra_hop", "inputs": "cagra_fused_search",
                  "itopk": sp.itopk_size, "width": sp.search_width,
                  "old_qps": mean("old", "qps"), "new_qps": mean("new", "qps"),
                  "new_over_old_qps": mean("new", "qps") / mean("old", "qps"),
                  "old_recall": mean("old", "recall"),
                  "new_recall": mean("new", "recall"),
                  "old_k6_launches": mean("old", "k6_launches"),
                  "new_k6_launches": mean("new", "k6_launches"),
                  "same_ids": same_ids})
    emit({"phase": "ab", **cases[-1]})
    return cases


def cagra_child(tree, index_file, query_file, itopk, width, ids_file):
    """One tree's fused CAGRA search for ``ab_k6_phase``, in a process of
    its own: ``tree``'s package searches the index's arrays (a warm-up,
    then AB_BATCHES timed 10k-query batches, host clock to a synchronise)
    and saves the last batch's ids and distances. Prints one JSON line: the
    median batch's QPS, the batch seconds and K6 launches a search."""
    sys.path.insert(0, tree)
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch

    res = Resources(device="cuda")
    index = cagra.CagraIndex(**{k: v.cuda() for k, v in
                                torch.load(index_file).items()})
    qs = torch.load(query_file).cuda()
    sp = cagra.CagraSearchParams(itopk_size=int(itopk),
                                 search_width=int(width), traversal="fused")
    cagra.search(index, qs, K, sp, res=res)
    torch.cuda.synchronize()
    ch.HOP_KERNEL.reset()
    times = []
    for _ in range(AB_BATCHES):
        t = time.perf_counter()
        d, i = cagra.search(index, qs, K, sp, res=res)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    torch.save(i.cpu(), ids_file)
    torch.save(d.cpu(), ids_file + ".d")
    print(json.dumps({"module": ch.__file__,
                      "qps": qs.shape[0] / sorted(times)[AB_BATCHES // 2],
                      "batch_s": times,
                      "k6_launches": ch.HOP_KERNEL.launches / AB_BATCHES}),
          flush=True)
    return 0


def variant_shapes(family, res):
    """The class inputs ``strip_variants`` times, by shape name → (kernel,
    calls): for ``"k1"`` the three K1 shapes of the paths (IVF-PQ int8 kf
    20, IVF-Flat uint8 kf 10, the CAGRA build's first batch at fp32 kf
    129); for ``"k2"`` K2 at the IVF-BQ path and K4 at the bq serving path,
    both at the (n_probes, k_fetch) the IVF-BQ escalation picks
    (``BQ_PICK``); for ``"k3"`` K3 at the two serving inputs (the flat
    store's uint8 pages at kf 10, the IVF-PQ store's int8 cache at kf 20,
    n_probes 16, 128-row pages)."""
    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import cagra, ivf_bq, ivf_flat, ivf_pq

    shared = shared_data()
    dataset, qs = shared["dataset"], shared["queries"]
    if family == "k1":
        pq = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
            n_lists=N_LISTS, pq_dim=64, pq_bits=8,
            kmeans_trainset_fraction=0.2), res=res)
        ivf_pq.search(pq, qs[:100], 20, n_probes=16, backend="ragged",
                      res=res)
        flat = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(
            n_lists=N_LISTS, kmeans_trainset_fraction=0.2), res=res)
        return {
            "main_int8_kf20": ("strip_scan", main_path_class_inputs(
                pq, qs, 16, 20, res)[0]),
            "flat_uint8_kf10": ("strip_scan", flat_path_class_inputs(
                flat, qs, 16, 10, res)[0]),
            "cagra_fp32_kf129": ("strip_scan", cagra_k1_inputs(
                dataset, cagra.CagraParams(intermediate_graph_degree=128,
                                           graph_degree=64), res)[0])}
    if family == "k3":
        flat = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(
            n_lists=N_LISTS, kmeans_trainset_fraction=0.2), res=res)
        fstore = serving.PagedListStore.from_index(
            flat, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
        fstore.reserve(WINDOW_ROUNDS * UPSERT_ROWS)
        pq = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
            n_lists=N_LISTS, pq_dim=64, pq_bits=8,
            kmeans_trainset_fraction=0.2), res=res)
        pstore = serving.PagedListStore.from_index(
            pq, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
        pstore.reserve(4 * UPSERT_ROWS)
        return {f"serve_flat_kf{K}": ("paged_scan", serve_flat_inputs(
                    fstore, qs, 16, K, res)[0]),
                "serve_pq_kf20": ("paged_scan", serve_codes_inputs(
                    pstore, "pq", qs, 16, 20, res)[0])}
    n_probes, kf = min(BQ_PICK[0], N_LISTS), BQ_PICK[1]
    index = ivf_bq.build(dataset, ivf_bq.IvfBqParams(
        n_lists=N_LISTS, kmeans_trainset_fraction=0.2), res=res)
    store = serving.PagedListStore.from_index(
        index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    store.reserve(4 * UPSERT_ROWS)
    return {f"bq_kf{kf}": ("bq_scan", bq_path_class_inputs(
                index, qs, n_probes, kf, res)[0]),
            f"serve_bq_kf{kf}": ("paged_bq_scan", serve_codes_inputs(
                store, "bq", qs, n_probes, kf, res)[0])}


def strip_variants(family, specs):
    """Strip kernels built from other kernel source trees (``NAME=CSRC_DIR``,
    e.g. a copy of ``raft_tpu_torch/ops/csrc`` with one change) against
    each other at the paths' shapes (``variant_shapes``): K1 for ``"k1"``,
    K2 and K4 for ``"k2"``, K3 for ``"k3"``. Each tree's sources are built by nvcc, all at
    once (ptxas lines printed); then each kernel and its product-only
    instantiation are timed through this tree's wrapper, in the order of
    the specs and back, and each tree's output is compared with the first
    tree's, bit for bit and as ``compare`` holds a kernel to its twin. A tree whose library exports
    ``raft_prof_reset`` / ``raft_prof_read`` / ``raft_prof_names`` (device
    counters a variant adds) has them read over one run of each shape."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.ops import _native

    kernels = {"k1": ["strip_scan"], "k2": ["bq_scan", "paged_bq_scan"],
               "k3": ["paged_scan"]}[family]
    trees = dict(spec.split("=", 1) for spec in specs)
    emit({"phase": "device", "nvidia_smi": nvidia_smi_card(),
          "kind": torch.cuda.get_device_name(0)})
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(item):
        name, kernel = item
        lib = _native.BUILD_DIR / f"lib{kernel}-variant-{name}.so"
        done = subprocess.run(
            [_native.nvcc(), *_native.NVCC_FLAGS, *_native.PTXAS_FLAGS, "-o",
             str(lib), str(Path(trees[name]) / f"{kernel}.cu")], check=True,
            capture_output=True, text=True)
        return name, kernel, lib, _native.parse_ptxas(done.stdout +
                                                      done.stderr)

    fns = {}
    jobs = [(n, k) for n in trees for k in kernels]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for name, kernel, lib, usage in pool.map(build, jobs):
            emit({"phase": f"{family}_variants.ptxas", "variant": name,
                  "kernel": kernel, "usage": usage})
            mod, getter, product = launcher_of(kernel)
            new_fn = getattr(mod, getter)()
            cdll = ctypes.CDLL(str(lib))
            entry = {}
            for which, sym in (("full", new_fn.__name__),
                               ("product", product)):
                fn = getattr(cdll, sym)
                fn.argtypes, fn.restype = new_fn.argtypes, new_fn.restype
                entry[which] = fn
            if hasattr(cdll, "raft_prof_read"):
                cdll.raft_prof_names.restype = ctypes.c_char_p
                entry["prof"] = cdll
            fns[name, kernel] = entry

    res = Resources(device="cuda")
    names = list(trees)
    for shape, (kernel, calls) in variant_shapes(family, res).items():
        mod, getter, _ = launcher_of(kernel)
        saved = getattr(mod, getter)
        wrapper = _kernel_pair(kernel)[0]

        def run_with(fn):
            setattr(mod, getter, lambda: fn)
            return [wrapper(**c) for c in calls]

        times = {n: {"full": [], "product": []} for n in names}
        for n in names + names[::-1]:
            for which in ("full", "product"):
                fn = fns[n, kernel][which]
                times[n][which].append(cuda_ms(lambda: run_with(fn), reps=5))
        first = None
        for n in names:
            outs = run_with(fns[n, kernel]["full"])
            torch.cuda.synchronize()
            first = first or outs
            line = {"phase": f"{family}_variants", "inputs": shape,
                    "kernel": kernel, "variant": n,
                    "full_ms": sum(times[n]["full"]) / 2,
                    "product_ms": sum(times[n]["product"]) / 2,
                    "same_as_first": all(
                        same_rows(got, want, c["strip_list"], c["strip_rows"])
                        for got, want, c in zip(outs, first, calls)),
                    "agrees_with_first": all(
                        compare(got, want, c["strip_list"],
                                c["strip_rows"])["ok"]
                        for got, want, c in zip(outs, first, calls)),
                    "order": times[n]}
            prof = fns[n, kernel].get("prof")
            if prof is not None:
                names_ = prof.raft_prof_names().decode().split(",")
                buf = (ctypes.c_ulonglong * len(names_))()
                prof.raft_prof_reset()
                run_with(fns[n, kernel]["full"])
                torch.cuda.synchronize()
                prof.raft_prof_read(buf, len(names_))
                line["counters"] = dict(zip(names_, list(buf)))
            emit(line)
            del outs
        del first
        setattr(mod, getter, saved)
    return 0


def hop_variants(specs):
    """K6 built from other kernel source trees (``NAME=CSRC_DIR``, each a
    copy of ``raft_tpu_torch/ops/csrc`` with one change) against each
    other through this tree's wrapper, picking entry, at synthetic
    10,000-query hops of the bench's rungs ((64, 4) and (96, 8); deg 64,
    p 64, 1M rows, the buffer a first hop returns), in the order of the
    specs and back; each tree's output compared bit for bit with the
    first's. A tree whose library exports ``raft_prof_reset`` /
    ``raft_prof_read`` / ``raft_prof_names`` has its counters read (per
    warp, divided by the ``warps`` counter) over one hop."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from raft_tpu_torch.ops import _native
    from raft_tpu_torch.ops import cagra_hop as ch

    trees = dict(spec.split("=", 1) for spec in specs)
    emit({"phase": "device", "nvidia_smi": nvidia_smi_card(),
          "kind": torch.cuda.get_device_name(0)})
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    saved = ch._pick_kernel_fn
    ref = saved()

    def build(name):
        lib = _native.BUILD_DIR / f"libcagra_hop-variant-{name}.so"
        done = subprocess.run(
            [_native.nvcc(), *_native.NVCC_FLAGS, *_native.PTXAS_FLAGS, "-o",
             str(lib), str(Path(trees[name]) / "cagra_hop.cu")], check=True,
            capture_output=True, text=True)
        return name, lib, _native.parse_ptxas(done.stdout + done.stderr)

    fns = {}
    with ThreadPoolExecutor(len(trees)) as pool:
        for name, lib, usage in pool.map(build, trees):
            emit({"phase": "k6_variants.ptxas", "variant": name,
                  "usage": usage})
            cdll = ctypes.CDLL(str(lib))
            fn = cdll.raft_cagra_pick_hop
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            if hasattr(cdll, "raft_prof_read"):
                cdll.raft_prof_names.restype = ctypes.c_char_p
            fns[name] = (fn, cdll if hasattr(cdll, "raft_prof_read")
                         else None)
    names = list(trees)
    for _, itopk, w in CAGRA_LADDER:
        call = synthetic_hop(7, w=w, itopk=itopk, n=N_ROWS, q=N_QUERIES)
        call = dict(call, parents=None, width=w)
        ch._pick_kernel_fn = lambda: ref
        first = ch.fused_hop(**call)
        call.update(buf_ids=first[0], buf_d=first[1], buf_vis=first[2])

        def run_with(fn):
            ch._pick_kernel_fn = lambda: fn
            return ch.fused_hop(**call)

        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(cuda_ms(lambda: run_with(fns[n][0]), reps=20))
        base = None
        for n in names:
            out = run_with(fns[n][0])
            torch.cuda.synchronize()
            base = base or out
            line = {"phase": "k6_variants", "width": w, "itopk": itopk,
                    "variant": n, "ms": sum(times[n]) / 2,
                    "order": times[n],
                    "same_as_first": all(torch.equal(a, b)
                                         for a, b in zip(out, base))}
            prof = fns[n][1]
            if prof is not None:
                keys = prof.raft_prof_names().decode().split(",")
                buf = (ctypes.c_ulonglong * len(keys))()
                prof.raft_prof_reset()
                run_with(fns[n][0])
                torch.cuda.synchronize()
                prof.raft_prof_read(buf, len(keys))
                vals = dict(zip(keys, list(buf)))
                warps = max(1, vals.pop("warps"))
                line["per_warp"] = {k: v / warps for k, v in vals.items()}
            emit(line)
        del call, first, base
        torch.cuda.empty_cache()
    ch._pick_kernel_fn = saved
    return 0


def search_child(tree, backend, index_file, query_file, n_probes, k_fetch,
                 ids_file):
    """One tree's IVF-PQ search for ``ab_phase``, in a process of its own:
    ``tree``'s package loads the index and runs ``search(backend=...)`` on
    the queries (two warm-ups, then AB_BATCHES searches, each timed by CUDA
    events); the kernel's launches (K5 for "pallas", K1 for "ragged") are
    timed by CUDA events around the tree's own launcher. Prints one JSON
    line: the median search's ms and its QPS, every search's ms, kernel ms
    and launches per search."""
    sys.path.insert(0, tree)
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device="cuda")
    index = ivf_pq.IvfPqIndex.load(index_file, res=res)
    qs = torch.load(query_file).cuda()
    events = []
    mod, name = ((ps, "_pq_scan_cuda") if backend == "pallas"
                 else (ss, "_strip_class_cuda"))
    launch = getattr(mod, name)

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    setattr(mod, name, timed)

    def search():
        return ivf_pq.search(index, qs, int(k_fetch), n_probes=int(n_probes),
                             backend=backend, res=res)

    _, ids = search()
    torch.save(ids.cpu(), ids_file)
    search()
    events.clear()
    batch_ms = [cuda_ms(search, reps=1, warmup=0) for _ in range(AB_BATCHES)]
    torch.cuda.synchronize()
    kernel_ms = sum(s.elapsed_time(e) for s, e in events) / AB_BATCHES
    search_ms = sorted(batch_ms)[AB_BATCHES // 2]
    print(json.dumps({"module": mod.__file__, "search_ms": search_ms,
                      "qps": qs.shape[0] / search_ms * 1e3,
                      "batch_ms": batch_ms, "kernel_ms": kernel_ms,
                      "launches": len(events) / AB_BATCHES}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The obs cost layer and the serving managers
# ---------------------------------------------------------------------------

HELD = {}           # objects one path leaves for a later one
COST_ROWS = []      # obs.cost: each built object's prediction and residency
COST_CHECKS = {}    # obs.cost: the admission check of a 10k batch

QUEUE_LOADS = (2, 5, 10)     # offered load, × the batch-1 rate
QUEUE_REQUESTS = 256         # Poisson requests a window
QUEUE_BASELINE = 64          # sequential batch-1 queries
QUEUE_MAX_BATCH = 64
QUEUE_MUTATE_EVERY = 32      # 32 upserted rows and a FIFO delete
QUEUE_SHADOW_RATE = 0.25
QUEUE_ID0 = 3_000_000

MAINT_ROWS = 120_000         # the drifted stream: 12% of the store
MAINT_BATCHES = 6
MAINT_HOT_LISTS = 4          # the drift lands in a few lists
MAINT_QUERIES = 1_000
MAINT_SEED = 17
MAINT_KNOWN = {"ok", "idle", "noop", "denied", "stale", "oom", "transient",
               "fatal", "deadline", None}

CAP_TENANTS = 8
CAP_ROWS = 250_000
CAP_LISTS = 256
CAP_REQUESTS = 480
CAP_PROBES = 16
CAP_ZIPF = 1.1


def allocated():
    """Bytes the CUDA caching allocator holds after the queue drains; None
    off the card."""
    import torch

    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    return int(torch.cuda.memory_allocated())


def cost_row(name, obj, before=None):
    """Hold ``obs.costmodel``'s prediction of ``obj``'s resident bytes to
    ``obs.memory.index_bytes`` (exactly) and keep the row, with the
    allocator's growth since ``before`` beside it, for the obs.cost line."""
    from raft_tpu_torch.obs import costmodel, memory

    layout = costmodel.index_layout(obj)
    after = allocated()
    row = {"name": name, "kind": layout["kind"],
           "predicted": costmodel.predict_index_bytes(**layout),
           "index_bytes": memory.index_bytes(obj),
           "alloc_delta": (None if before is None or after is None
                           else after - before)}
    COST_ROWS.append(row)
    if row["predicted"] != row["index_bytes"]:
        raise AssertionError(f"obs.cost: prediction not exact: {row}")


def obs_cost_phase():
    """The cost model on the run's own objects: every prediction exact
    (each checked where it was built), the allocator's growth around each
    build beside it, the memory budget from the card, the roofline's peak
    table entry for the card, and the admission of a 10k batch."""
    import torch

    from raft_tpu_torch.obs import costmodel, roofline

    budget = costmodel.hbm_budget()
    peaks = roofline.platform_peaks()
    total = torch.cuda.mem_get_info()[1] if torch.cuda.is_available() else 0
    emit({"phase": "obs.cost", "objects": COST_ROWS, "budget": budget,
          "card_total_bytes": total, "peaks": peaks, **COST_CHECKS})
    names = {r["name"] for r in COST_ROWS}
    want = {"ivf_pq", "ivf_bq", "ivf_flat", "cagra", "serve.flat",
            "serve.pq", "serve.bq"}
    if not want <= names:
        raise AssertionError(f"obs.cost: no row for {sorted(want - names)}")
    if budget != {"bytes": total, "source": "device_stats"}:
        raise AssertionError(f"obs.cost: budget {budget}, card {total}")
    entry = next((row for row in roofline._PEAK_TABLE
                  if row[0] in peaks["device_kind"].lower()), None)
    if peaks["source"] != "table" or entry is None or \
            (peaks["peak_flops"], peaks["peak_bw"]) != entry[1:] or \
            not entry[0].startswith("h100"):
        raise AssertionError(f"obs.cost: peaks {peaks}")
    if COST_CHECKS.get("admission", {}).get("verdict") != costmodel.ADMIT:
        raise AssertionError(f"obs.cost: admission {COST_CHECKS}")


def _pct(vals, p):
    import numpy as np

    return float(np.percentile(np.asarray(vals, np.float64), p)) \
        if len(vals) else None


def serve_queue_phase(shared, store, n_probes, dev="cuda"):
    """The serving flat store (K3) behind a ``QueryQueue`` at the bench's
    serving parameters: a batch-1 baseline, then windows of Poisson
    requests at 2×, 5× and 10× its rate with mixed deadlines, upserts and
    FIFO deletes, the paged-scan cost hook and a shadow sampler; an OOM
    window (the batch cap halves, every request served); then a
    compaction cycle, which keeps the results."""
    import collections

    import numpy as np
    import torch

    from raft_tpu_torch import Resources, obs, resilience, serving
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import costmodel
    from raft_tpu_torch.obs import shadow as obs_shadow
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    qs = shared["queries"]
    nq = qs.shape[0]
    host_q = qs.cpu().numpy().astype(np.float32)
    store.set_filter(None)
    n_windows = len(QUEUE_LOADS) + 1
    store.reserve(n_windows * (QUEUE_REQUESTS // QUEUE_MUTATE_EVERY + 1)
                  * UPSERT_ROWS)
    COST_CHECKS["admission"] = costmodel.check_admission(
        costmodel.estimate_search(store, q=nq, k=K, n_probes=n_probes),
        entry="chip_smoke.serve_10k")

    def exact(x):
        return serving.search(store, x, K, n_probes=store.n_lists, res=res)

    # meet every batch bucket's and the exact scan's signature before the
    # windows: from here on a new one is a fault
    for b in serving.QueryQueue(lambda x: x, max_batch=QUEUE_MAX_BATCH).buckets:
        serving.search(store, host_q[:b], K, n_probes=n_probes, res=res)
    exact(host_q[:1])

    one = host_q[:1]
    base = []
    for j in range(QUEUE_BASELINE):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, ids = serving.search(store, host_q[j:j + 1], K, n_probes=n_probes,
                                res=res)
        ids.cpu()
        base.append(time.perf_counter() - t)
    lat1 = _pct(base, 50)
    full = []
    for j in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        serving.search(store, host_q[:QUEUE_MAX_BATCH], K, n_probes=n_probes,
                       res=res)[1].cpu()
        full.append(time.perf_counter() - t)
    lat_full = _pct(full, 50)
    rate1 = 1.0 / lat1
    slo = max(4 * lat_full, 2 * lat1)
    emit({"phase": "serve.queue.baseline", "n_probes": n_probes, "k": K,
          "batch1_p50_ms": lat1 * 1e3, "batch1_p99_ms": _pct(base, 99) * 1e3,
          "batch64_ms": lat_full * 1e3, "batch1_qps": rate1,
          "slo_ms": slo * 1e3, "fill_wait_ms": lat_full * 1e3,
          "admission_10k": COST_CHECKS["admission"]})
    del one

    sampler = obs_shadow.ShadowSampler(exact, k=K, rate=QUEUE_SHADOW_RATE,
                                       seed=MAINT_SEED)
    live = collections.deque()
    next_id = [QUEUE_ID0]
    mutations = [0]

    def mutate():
        ids = np.arange(next_id[0], next_id[0] + UPSERT_ROWS, dtype=np.int64)
        next_id[0] += UPSERT_ROWS
        rows = host_q[(ids - QUEUE_ID0) % nq]
        store.upsert(rows, ids)
        live.append(ids)
        if len(live) > 1:
            store.delete(live.popleft())
        mutations[0] += 1

    def window(name, load_x, seed, long_deadlines=False):
        rng = np.random.default_rng(seed)
        t_arr = np.cumsum(rng.exponential(1.0 / (load_x * rate1),
                                          QUEUE_REQUESTS))
        picks = rng.integers(0, nq, QUEUE_REQUESTS)
        q = serving.QueryQueue(
            serving.searcher(store, K, n_probes=n_probes, res=res),
            slo_s=slo, max_batch=QUEUE_MAX_BATCH, fill_wait_s=lat_full,
            cost_model=costmodel.paged_scan_estimator(store, K, n_probes),
            shadow=sampler)
        counters0 = obs.snapshot()["counters"]
        reset_counts()
        handles = []
        i = 0
        t0 = time.monotonic()
        while i < QUEUE_REQUESTS or q.depth:
            now = time.monotonic() - t0
            while i < QUEUE_REQUESTS and t_arr[i] <= now:
                mult = 8 if long_deadlines or i % 5 else 2
                handles.append(q.submit(host_q[picks[i]],
                                        timeout_s=mult * slo))
                i += 1
                if i % QUEUE_MUTATE_EVERY == 0:
                    mutate()
            if not q.pump() and i < QUEUE_REQUESTS:
                time.sleep(min(max(t_arr[i] - now, 0.0), 5e-4))
        wall = time.monotonic() - t0
        launches = ss.PAGED_KERNEL.launches
        counters = obs.snapshot()["counters"]
        verdicts = collections.Counter(h.verdict for h in handles)
        lats = [h.latency_s for h in handles if h.verdict == "ok"]
        admitted = sum(costmodel.admission_counts(counters).values()) - sum(
            costmodel.admission_counts(counters0).values())
        # every dispatch is priced once, the failed ones too
        failed = sum(v - counters0.get(k, 0) for k, v in counters.items()
                     if k.startswith("serving.dispatch.")
                     and k != "serving.dispatch.oom_halved")
        row = {"phase": f"serve.queue.{name}", "offered_x": load_x,
               "offered_qps": load_x * rate1,
               "achieved_qps": verdicts["ok"] / wall,
               "speedup": verdicts["ok"] / wall / rate1, "wall_s": wall,
               "p50_ms": _pct(lats, 50) * 1e3, "p90_ms": _pct(lats, 90) * 1e3,
               "p99_ms": _pct(lats, 99) * 1e3, "batches": q.batches,
               "multi_batch_share": q.multi_batches / max(q.batches, 1),
               "batch_cap": q.batch_cap, "verdicts": dict(verdicts),
               "admission_verdicts": admitted, "failed_dispatches": failed,
               "k3_launches": launches,
               "mutations": mutations[0]}
        emit(row)
        errors = sum(v for k, v in verdicts.items()
                     if k not in ("ok", resilience.DEADLINE))
        if errors or launches <= 0 or admitted != q.batches + failed:
            raise AssertionError(f"serve.queue.{name}: {errors} error "
                                 f"verdicts, {launches} K3 launches, "
                                 f"{admitted} admission verdicts for "
                                 f"{q.batches} + {failed} dispatches")
        return row, q

    obs.reset()
    obs.enable()
    try:
        t0 = serving.scan_trace_count()
        rows = []
        for load in QUEUE_LOADS:
            rows.append(window(f"x{load}", load, 100 + load)[0])
            while sampler.pump():        # the shadow's exact scans, off the
                pass                     # window
        shadow = sampler.estimate()
        trace_delta = serving.scan_trace_count() - t0
        resilience.arm_faults("serving.queue.dispatch=oom:1")
        oom_row, oom_q = window("oom", QUEUE_LOADS[0], 99,
                                long_deadlines=True)
    finally:
        resilience.clear_faults()
        obs.disable()
    p99_1 = _pct(base, 99) * 1e3
    fit = [r for r in rows if r["p99_ms"] <= p99_1]
    best = max(fit, key=lambda r: r["achieved_qps"]) if fit else None
    emit({"phase": "serve.queue", "batch1_qps": rate1,
          "best_speedup": best and best["achieved_qps"] / rate1,
          "best_at_x": best and best["offered_x"], "shadow": shadow,
          "scan_trace_delta": trace_delta,
          "unexplained_retraces": obs_compile.unexplained_retraces()})
    if trace_delta or obs_compile.unexplained_retraces() or \
            shadow["recall"] is None or shadow["recall"] < 0.90:
        raise AssertionError(f"serve.queue: trace delta {trace_delta}, "
                             f"shadow {shadow}")
    if oom_q.batch_cap != QUEUE_MAX_BATCH // 2 or \
            oom_row["verdicts"] != {"ok": QUEUE_REQUESTS}:
        raise AssertionError(f"serve.queue.oom: cap {oom_q.batch_cap}, "
                             f"verdicts {oom_row['verdicts']}")

    # compaction: the window's tombstones reclaimed, the results kept
    before = serving.search(store, qs, K, n_probes=n_probes, res=res)
    tomb = store.tombstones
    t = time.perf_counter()
    out = serving.CompactionManager(store, ratio=0.0).pump()
    compact_s = time.perf_counter() - t
    after = serving.search(store, qs, K, n_probes=n_probes, res=res)
    agree = topk_agreement(before[0], before[1], after[0], after[1])
    emit({"phase": "serve.queue.compact", "tombstones": tomb,
          "status": out and out["status"], "seconds": compact_s,
          "agreement": agree, "stats": store.stats()})
    if not out or out["status"] != "ok" or not tomb or not agree["ok"]:
        raise AssertionError(f"serve.queue.compact: {out}, {agree}")


TUNE_PROBES = (4, 8, 16)     # _autotune_rung's full-size probe ladder
TUNE_CAPS = (16, 32, 64)     # the batch-cap ladder: QUEUE_MAX_BATCH's range
TUNE_REQUESTS = 96           # Poisson requests a tuner window
TUNE_SEED = 17
FLIGHT_FILE = "results/flight_chip_smoke.jsonl"
FRONTIER_FILE = "results/frontier_chip_smoke.json"


def tuning_phase(shared, store, n_probes, dev="cuda"):
    """The tuning loop on the serving flat store (K3), after ``bench.py``'s
    ``_autotune_rung`` at its full-size settings: probe ladder (4, 8, 16),
    cap ladder (16, 32, 64), 96 Poisson requests a window, every (probe
    rung ∪ exact) × pow2 bucket met before any clock, the recall floor set
    by the JAX rung's rule (the middle of the widest gap of the measured
    ladder when that gap exceeds 0.08, else 0.03 under the top rung; the
    phase prints which). Phase A: the ``Autotuner`` (default window budget
    and deadline) moves the knobs by diagnosis and emits the operating
    point, a ``FlightRecorder`` writing every window to ``FLIGHT_FILE``;
    no window may be skipped and no request may end in an error verdict.
    Phase B: serving restarts at the point read back with
    ``load_operating_point``, a calm slice, a saturating spike and calm
    recovery under the ``BurnRateController``. Then the flight and report
    CLIs on the recording, each in a child process."""
    import collections

    import numpy as np

    from raft_tpu_torch import Resources, obs, serving
    from raft_tpu_torch.bench import progress as prog
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import explain as obs_explain
    from raft_tpu_torch.obs import flight as obs_flight
    from raft_tpu_torch.obs import memory as obs_memory
    from raft_tpu_torch.obs import report as obs_report
    from raft_tpu_torch.obs import shadow as obs_shadow
    from raft_tpu_torch.obs import slo as obs_slo
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.tuning import autotune

    t_phase = time.perf_counter()
    res = Resources(device=dev)
    rng = np.random.default_rng(TUNE_SEED)
    n_lists = store.n_lists
    probe_ladder, cap_ladder = list(TUNE_PROBES), list(TUNE_CAPS)
    n_req, cap_max = TUNE_REQUESTS, cap_ladder[-1]
    host_q = shared["queries"].cpu().numpy().astype(np.float32)
    q_pool = host_q[:max(64, 2 * n_req)]
    store.set_filter(None)

    def search(qq, nprobe):
        return serving.search(store, qq, K, n_probes=nprobe, res=res)

    def fetched(out):
        """Host fetch of a search's ids: returns once its launches ended."""
        return out[1].cpu().numpy()

    obs.reset()
    obs.enable()
    obs.disable_sync()
    reset_counts()
    # every (probe rung ∪ exact scan) × pow2 bucket before any clock: the
    # loop below — tuner windows, the controller's n_probes / batch-cap
    # moves, the shadow's exact scans — meets no new scan signature
    for np_ in probe_ladder + [n_lists]:
        b = 1
        while True:
            fetched(search(np.repeat(q_pool[:1], b, axis=0), np_))
            if b >= cap_max:
                break
            b = min(2 * b, cap_max)

    def timed(qq, reps):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fetched(search(qq, probe_ladder[-1]))
            times.append(time.perf_counter() - t)
        return max(1e-6, _pct(times, 50))

    lat1 = timed(q_pool[:1], 5)
    lat_full = timed(q_pool[:cap_max], 5)
    slo_s = max(4.0 * lat_full, 2.0 * lat1)

    # the recall floor sits in the widest gap between adjacent rungs of the
    # MEASURED ladder (meetable by a later rung, missed by the first) when
    # that gap is wide; else just under the top rung
    q_cal = q_pool[:cap_max]
    exact_cal = fetched(search(q_cal, n_lists))

    def recall_at(nprobe):
        got = fetched(search(q_cal, nprobe))
        hits = sum(len(set(got[i].tolist()) & set(exact_cal[i].tolist()))
                   for i in range(q_cal.shape[0]))
        return hits / (q_cal.shape[0] * K)

    ladder_recall = [recall_at(p) for p in probe_ladder]
    gaps = [ladder_recall[i + 1] - ladder_recall[i]
            for i in range(len(ladder_recall) - 1)]
    if gaps and max(gaps) > 0.08:
        gi = gaps.index(max(gaps))
        floor = (ladder_recall[gi] + ladder_recall[gi + 1]) / 2.0
        floor_by = "widest gap"
    else:
        floor = ladder_recall[-1] - 0.03
        floor_by = "top rung - 0.03"
    floor = round(min(0.95, max(0.2, floor)), 3)
    floor_hard = round(max(0.05, floor - 0.1), 3)
    slo = {"p99_s": 5.0 * slo_s, "recall_floor": floor}
    base_rate = 0.5 / lat1
    out = {"phase": "tuning", "n_lists": n_lists, "k": K,
           "serve_n_probes": n_probes, "probe_ladder": probe_ladder,
           "cap_ladder": cap_ladder, "requests_per_window": n_req,
           "batch1_ms": lat1 * 1e3, "batch64_ms": lat_full * 1e3,
           "slo_ms": slo_s * 1e3,
           "ladder_recall": [round(r, 4) for r in ladder_recall],
           "recall_floor": floor, "recall_floor_by": floor_by,
           "recall_floor_hard": floor_hard,
           "slo_p99_ms": slo["p99_s"] * 1e3}

    def window_traffic(queue, rate, n, timeout_mult=50.0, ctrl=None,
                       ctrl_every=0):
        """One Poisson traffic slice: submit at ``rate`` req/s and pump the
        queue in the gaps (this loop is the serving worker)."""
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
        handles = []
        i = 0
        t_start = time.perf_counter()
        while i < n:
            flight.maybe_sample()
            now = time.perf_counter() - t_start
            if now >= arrivals[i]:
                handles.append(queue.submit(q_pool[i % len(q_pool)],
                                            timeout_s=timeout_mult * slo_s))
                i += 1
                if ctrl is not None and ctrl_every and i % ctrl_every == 0:
                    ctrl.pump()
                continue
            if not queue.pump():
                time.sleep(min(arrivals[i] - now, 2e-4))
        queue.drain(timeout=120.0)
        return handles, time.perf_counter() - t_start

    # one recording over both phases: its providers follow the live objects
    live_objs = {"engine": None, "sampler": None, "queue": None,
                 "knobs": lambda: {"algo": store.kind, "n_lists": n_lists,
                                   "k": K}}
    prog.truncate(FLIGHT_FILE)
    health = HELD.get("health")
    flight = obs_flight.FlightRecorder(
        FLIGHT_FILE, knobs=lambda: live_objs["knobs"](),
        engine=lambda: live_objs["engine"],
        sampler=lambda: live_objs["sampler"],
        queue=lambda: live_objs["queue"], health=health,
        probe_health=health is None, interval_s=0.1)
    flight.sample()      # window 0 (the health verdict), off every clock

    # --- Phase A: the offline tuner --------------------------------------
    tuner_handles = []

    def serve_window(values):
        """ONE window under the proposed knobs with a fresh sampler and SLO
        engine (a windowed Wilson CI judges the knob move just made)."""
        nprobe, cap = int(values["n_probes"]), int(values["batch_cap"])
        sampler = obs_shadow.ShadowSampler(
            lambda qq: search(qq, n_lists), k=K, rate=1.0, seed=TUNE_SEED,
            max_pending=n_req + 8)
        engine = obs_slo.SloEngine(
            obs_slo.default_serving_slos(slo_s, sampler=sampler,
                                         recall_floor=floor),
            fast_window_s=30.0, slow_window_s=120.0)
        queue = serving.QueryQueue(
            serving.searcher(store, K, n_probes=nprobe, res=res),
            slo_s=slo_s, max_batch=cap, fill_wait_s=lat_full, shadow=sampler)
        live_objs.update(engine=engine, sampler=sampler, queue=queue,
                         knobs=lambda: {"algo": store.kind,
                                        "n_lists": n_lists, "k": K,
                                        "n_probes": nprobe, **queue.knobs()})
        handles, wall = window_traffic(queue, base_rate, n_req)
        tuner_handles.extend(handles)
        sampler.drain(timeout_s=60.0)
        ok = [h.latency_s for h in handles if h.verdict == "ok"]
        win = flight.sample() or {}
        report = win.get("report")
        if not isinstance(report, dict):
            report = obs_report.collect(engine=engine, sampler=sampler,
                                        queue=queue)
        return {"ops": {"qps": len(ok) / wall if wall > 0 else 0.0,
                        "p99_ub_s": _pct(ok, 99),
                        "requests_ok": len(ok)},
                "report": report}

    tuner = autotune.Autotuner(
        serve_window,
        [autotune.Knob("n_probes", probe_ladder),
         autotune.Knob("batch_cap", cap_ladder, start=cap_ladder[1]),
         autotune.Knob("algo", ["ivf_flat"]),
         autotune.Knob("n_lists", [n_lists]),
         autotune.Knob("k", [K])],
        slo=slo, settle=3)
    t = time.perf_counter()
    out["tuner"] = tuner.run()
    out["tuner_s"] = time.perf_counter() - t
    # a window the tuner skipped (its serve_fn raised: a launch error, the
    # deadline) and a request that ended in an error verdict both fail here
    out["tuner_skipped"] = out["tuner"].get("skipped", 0)
    out["tuner_requests"] = len(tuner_handles)
    out["tuner_deadline_misses"] = sum(h.verdict == "deadline"
                                       for h in tuner_handles)
    out["tuner_unclassified"] = sum(h.verdict not in ("ok", "deadline")
                                    for h in tuner_handles)
    emitted = tuner.emit_operating_point()
    windows = tuner.windows()
    primaries = collections.Counter()
    explain_invalid = unexplained = 0
    for rec in windows:
        diag = rec.get("explain") or {}
        key = diag.get("primary") or "healthy"
        primaries[key] += 1
        explain_invalid += len(obs_explain.validate(diag))
        # a CONSEQUENTIAL unknown: the window missed its bound undiagnosed
        if key == "unknown" and not rec["proposal"].get("meets_slo", True):
            unexplained += 1
    out.update(diagnosis_counts=dict(primaries),
               unexplained_diagnoses=unexplained,
               explain_invalid=explain_invalid,
               frontier_points=tuner.frontier().get("pareto_points", 0))
    if emitted is None:
        raise AssertionError(f"tuning: no operating point emitted: {out}")
    out.update(meets_slo=bool(emitted["meets_slo"]),
               tuned_qps=emitted["qps"], tuned_recall=emitted["recall"],
               tuned_p99_ms=(emitted["p99_ub_s"] * 1e3
                             if emitted["p99_ub_s"] is not None else None))

    # --- Phase B: online control at the tuned point ----------------------
    point = autotune.load_operating_point()
    knobs = (point or {}).get("knobs") or {}
    nprobe_tuned = knobs.get("n_probes")
    cap_tuned = knobs.get("batch_cap")
    if nprobe_tuned not in probe_ladder or cap_tuned not in cap_ladder:
        raise AssertionError(f"tuning: operating point read back as "
                             f"{point}")
    out["tuned_knobs"] = {"n_probes": nprobe_tuned, "batch_cap": cap_tuned}
    out["tuned_by"] = point.get("tuned_by")
    live = {"n_probes": int(nprobe_tuned)}

    def live_search(qq):
        return search(qq, live["n_probes"])

    sampler2 = obs_shadow.ShadowSampler(
        lambda qq: search(qq, n_lists), k=K, rate=1.0, seed=TUNE_SEED + 1,
        max_pending=8 * n_req)
    # burn windows scaled to the phase's wall clock; the latency target is
    # 2× the serving bound, because the engine's pow2-bucket bad counting
    # can overcount by up to 2× (the JAX rung's setting)
    engine2 = obs_slo.SloEngine(
        obs_slo.default_serving_slos(2.0 * slo_s, sampler=sampler2,
                                     recall_floor=floor_hard),
        fast_window_s=0.6, slow_window_s=2.5, threshold=5.0)
    queue2 = serving.QueryQueue(live_search, slo_s=slo_s, max_batch=cap_max,
                                fill_wait_s=lat_full, shadow=sampler2)
    queue2.set_batch_cap(int(cap_tuned))
    actuators = [
        serving.KnobActuator("n_probes", probe_ladder,
                             lambda: live["n_probes"],
                             lambda v: live.__setitem__("n_probes", int(v)),
                             costs_recall=True),
        serving.KnobActuator("batch_cap", cap_ladder,
                             lambda: queue2.batch_cap, queue2.set_batch_cap),
    ]
    ctrl = serving.BurnRateController(
        engine2, actuators, sampler=sampler2, recall_floor=floor_hard,
        max_actions=1, cool_windows=2, deadline_s=60.0)
    live_objs.update(engine=engine2, sampler=sampler2, queue=queue2,
                     knobs=lambda: {"algo": store.kind, "n_lists": n_lists,
                                    "k": K, "n_probes": live["n_probes"],
                                    **queue2.knobs()})
    flight.sample()
    traces0 = serving.scan_trace_count()
    unexplained0 = obs_compile.unexplained_retraces()

    # calm at the tuned point: the controller must hold
    calm, calm_wall = window_traffic(queue2, base_rate, n_req, ctrl=ctrl,
                                     ctrl_every=8)
    sampler2.drain(timeout_s=60.0)
    out["calm_actions"] = (ctrl.report() or {}).get("actions", 0)
    out["calm_qps"] = sum(h.verdict == "ok" for h in calm) / calm_wall

    # the spike: bursts dumped at once, each sized to a tail queue wait of
    # ≈6× slo_s off the measured dispatch at the tuned batch; the
    # controller is pumped between bursts
    t = time.perf_counter()
    fetched(live_search(q_pool[:int(cap_tuned)]))
    t_disp = max(time.perf_counter() - t, 1e-5)
    burst = int(cap_tuned) * min(96, max(3, int(6.0 * slo_s / t_disp) + 1))
    spike = []
    for _ in range(4):
        hs, _ = window_traffic(queue2, 1e9, burst, timeout_mult=400.0)
        spike.extend(hs)
        ctrl.pump()
        flight.maybe_sample()

    # recovery: calm slices until every knob is back at its tuned rung
    restored = False
    recovery = []
    for _ in range(40):
        hs, _ = window_traffic(queue2, base_rate, 8)
        recovery.extend(hs)
        tick = ctrl.pump() or {}
        flight.maybe_sample()
        restored = all(a.idx == a.tuned_idx for a in actuators)
        if restored and tick.get("status") == "cool" \
                and not tick.get("actions"):
            break
        time.sleep(0.05)
    final_rows = engine2.evaluate()
    sampler2.drain(timeout_s=60.0)
    obs_memory.sample("tuning")
    flight.sample()

    handles = calm + spike + recovery
    misses = sum(h.verdict == "deadline" for h in handles)
    crep = ctrl.report() or {}
    out.update(
        spike_burst=burst, spike_requests=len(spike),
        recovery_requests=len(recovery),
        new_scan_signatures=serving.scan_trace_count() - traces0,
        unexplained_retraces=obs_compile.unexplained_retraces()
        - unexplained0,
        deadline_misses=misses,
        unclassified=len(handles) - misses
        - sum(h.verdict == "ok" for h in handles),
        knobs_restored=bool(restored),
        controller_actions=crep.get("actions", 0),
        controller_nudges=crep.get("nudges", 0),
        controller_reverts=crep.get("reverts", 0),
        guardrail_holds=crep.get("guardrail_holds", 0),
        controller_failures=crep.get("failures", 0),
        breach_ticks=crep.get("breach_ticks", 0),
        spike_budget_burn=sum(1 for r in final_rows.values()
                              if isinstance(r, dict)
                              and r.get("state") == "breach"),
        final_slo={n: r.get("state") for n, r in final_rows.items()},
        flight_windows=flight.windows_recorded)

    # the episode from the recording alone: every controller action is a
    # complete tuning.action event on the window timeline
    recording = obs_flight.read_recording(FLIGHT_FILE)
    actions_seen = [e for rec in recording
                    if rec.get("type") == "flight_window"
                    for e in rec.get("events") or []
                    if e.get("event") == "tuning.action"]
    out["tuning_action_events"] = len(actions_seen)
    # a window whose sample or export degraded (classified, not raised)
    counters = obs.snapshot()["counters"]
    out["flight_degraded"] = {
        "sample_counter": counters.get("flight.sample_degraded", 0),
        "export_counter": counters.get("flight.export_degraded", 0),
        "windows_with_errors": sum(1 for rec in recording
                                   if rec.get("type") == "flight_window"
                                   and rec.get("errors"))}
    final_report = obs_report.collect(engine=engine2, sampler=sampler2,
                                      queue=queue2, controller=ctrl)
    obs_report.export(FLIGHT_FILE, final_report)
    out["report_problems"] = obs_report.validate(final_report)
    obs.disable()
    out["k3_launches"] = ss.PAGED_KERNEL.launches

    # the CLIs on the recording, each in a child process
    clis = {}
    for name, argv in (
            ("flight", ["-m", "raft_tpu_torch.obs.flight", FLIGHT_FILE,
                        "--validate", "--render", "--frontier",
                        FRONTIER_FILE]),
            ("report", ["-m", "raft_tpu_torch.obs.report", FLIGHT_FILE,
                        "--validate", "--output",
                        "results/report_chip_smoke.json"])):
        proc = subprocess.run([sys.executable] + argv, capture_output=True,
                              text=True, timeout=120)
        clis[name] = {"rc": proc.returncode,
                      "stdout_tail": proc.stdout.strip().splitlines()[-1:],
                      "stderr_tail": proc.stderr.strip().splitlines()[-3:]}
    out["clis"] = clis
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    bad = {key: out[key] for key in (
        "calm_actions", "spike_budget_burn", "unexplained_diagnoses",
        "new_scan_signatures", "unclassified", "explain_invalid",
        "unexplained_retraces", "controller_failures", "tuner_skipped",
        "tuner_unclassified") if out[key]}
    bad.update({f"flight.{key}": n for key, n in
                out["flight_degraded"].items() if n})
    if not out["meets_slo"] or not out["knobs_restored"] or bad \
            or out["controller_actions"] < 1 or out["k3_launches"] <= 0 \
            or out["tuning_action_events"] < out["controller_actions"] \
            or out["report_problems"] \
            or any(c["rc"] for c in clis.values()):
        raise AssertionError(f"tuning: {out}")
    return out["k3_launches"]


RUNNER_CONFIG = "results/runner_chip_smoke_config.json"
RUNNER_OUT = "results/runner_chip_smoke.json"
RUNNER_RECALL_SLACK = 0.002  # against the same path's figure in this call
#: a record's keys in the JAX runner's order
RUNNER_RECORD_KEYS = ["algo", "build_params", "search_params", "build_s",
                      "qps", "recall", "k"]


def runner_phase(shared, dev="cuda"):
    """The bench runner's entry point, ``bench.runner.main``, in this
    process (the launch counters see it) on the siftlike 1M × 128 config:
    brute force, IVF-Flat and IVF-PQ at the picks of the flat and main
    paths (n_probes; refine_ratio = k_fetch / k), and CAGRA 128 → 64 at the
    cagra path's fused rung. Brute force's recall is 1.0, every other
    record's ≥ 0.95 and within RUNNER_RECALL_SLACK of its path's figure
    earlier in this call; K1 launches in the IVF-Flat and IVF-PQ records,
    K6 launches = the CAGRA searches' hops. The records are read from the
    JSON the runner writes (its ``main`` returns nothing, as JAX's): one
    a search entry, with JAX's keys in JAX's order, naming the build and
    search parameters the config gave."""
    import torch

    from raft_tpu_torch.bench import runner
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import strip_scan as ss

    flat_pick, flat_rec = HELD["recall.flat"]
    pq_pick, pq_rec = HELD["recall.main"]
    cagra_pick, cagra_rec = HELD["recall.cagra"]
    n, dim = shared["dataset"].shape
    config = {
        "dataset": {"kind": "siftlike", "n": n, "dim": dim,
                    "n_queries": shared["queries"].shape[0], "seed": 0},
        "k": K,
        "algos": [
            {"name": "brute_force", "build": {}, "search": [{}]},
            {"name": "ivf_flat",
             "build": {"n_lists": N_LISTS, "kmeans_trainset_fraction": 0.2},
             "search": [{"n_probes": flat_pick["n_probes"]}]},
            {"name": "ivf_pq",
             "build": {"n_lists": N_LISTS, "pq_dim": 64, "pq_bits": 8,
                       "kmeans_trainset_fraction": 0.2},
             "search": [{"n_probes": pq_pick["n_probes"],
                         "refine_ratio": pq_pick["k_fetch"] // K}]},
            {"name": "cagra",
             "build": {"intermediate_graph_degree": 128, "graph_degree": 64},
             "search": [{"itopk_size": cagra_pick["itopk"],
                         "search_width": cagra_pick["width"],
                         "traversal": "fused"}]}]}
    with open(RUNNER_CONFIG, "w") as f:
        json.dump(config, f)

    # each algo's build and searches counted apart: the runner's factory
    # and the CAGRA search (for its hops) wrapped for this call only
    launches = {}
    hops = []
    make_algo, cagra_search = runner._make_algo, cagra.search

    def counted(name, fn):
        def run(*args):
            k1, k6 = ss.STRIP_KERNEL.launches, ch.HOP_KERNEL.launches
            result = fn(*args)
            row = launches.setdefault(name, {"K1": 0, "K6": 0})
            row["K1"] += ss.STRIP_KERNEL.launches - k1
            row["K6"] += ch.HOP_KERNEL.launches - k6
            return result
        return run

    def counting_make_algo(name, *args):
        build_fn, search_fn = make_algo(name, *args)
        return (counted(name + ".build", build_fn),
                counted(name + ".search", search_fn))

    def search_with_hops(*args, **kwargs):
        st = {}
        result = cagra_search(*args, stats=st, **kwargs)
        hops.append((st.get("mode"), sum(st.get("hops") or [0])))
        return result

    reset_counts()
    runner._make_algo, cagra.search = counting_make_algo, search_with_hops
    t = time.perf_counter()
    try:
        runner.main([RUNNER_CONFIG, "-o", RUNNER_OUT])
    finally:
        runner._make_algo, cagra.search = make_algo, cagra_search
    seconds = time.perf_counter() - t
    torch.cuda.empty_cache()
    with open(RUNNER_OUT) as f:
        records = json.load(f)
    asked = {a["name"]: (a["build"], a["search"][0])
             for a in config["algos"]}
    as_asked = all(
        list(r) == RUNNER_RECORD_KEYS and r["k"] == K
        and r["search_params"] == asked[r["algo"]][1]
        and all(r["build_params"].get(key) == v
                for key, v in asked[r["algo"]][0].items())
        for r in records)
    earlier = {"ivf_flat": flat_rec, "ivf_pq": pq_rec, "cagra": cagra_rec}
    rows = {r["algo"]: {"build_s": r["build_s"], "qps": r["qps"],
                        "recall": r["recall"],
                        "earlier_recall": earlier.get(r["algo"])}
            for r in records}
    hop_sum = sum(h for _, h in hops)
    row = {"phase": "bench.runner", "seconds": seconds, "records": rows,
           "launches": launches, "cagra_hops": hop_sum,
           "cagra_modes": sorted({m for m, _ in hops}),
           "records_as_asked": as_asked}
    emit(row)
    problems = []
    if [r["algo"] for r in records] != ["brute_force", "cagra", "ivf_flat",
                                        "ivf_pq"]:
        problems.append("records")
    if rows["brute_force"]["recall"] != 1.0:
        problems.append("brute force recall")
    for algo, ref in earlier.items():
        got = rows[algo]["recall"]
        if got < 0.95 or abs(got - ref) > RUNNER_RECALL_SLACK:
            problems.append(f"{algo} recall {got} against {ref}")
    for algo in ("ivf_flat", "ivf_pq"):
        if launches.get(f"{algo}.search", {}).get("K1", 0) <= 0:
            problems.append(f"{algo} launched no K1")
    k6 = launches.get("cagra.search", {}).get("K6", 0)
    if k6 <= 0 or k6 != hop_sum or row["cagra_modes"] != ["fused"]:
        problems.append(f"K6 {k6} against {hop_sum} hops")
    if not as_asked:
        problems.append("records do not name the config's parameters")
    if problems:
        raise AssertionError(f"bench.runner: {problems}: {row}")
    return launches


def roofline_phase(shared, store, n_probes, pq_index, pq_pick, dev="cuda"):
    """Sync mode, one 10k-query batch of the serving flat store (K3) and
    of IVF-PQ ragged (K1): the roofline's static model against the
    committed span times, with the card's peaks."""
    from raft_tpu_torch import Resources, obs, serving
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import roofline

    res = Resources(device=dev)
    qs = shared["queries"]

    def batches():
        serving.search(store, qs, K, n_probes=n_probes, res=res)
        ivf_pq.search(pq_index, qs, pq_pick["k_fetch"],
                      n_probes=pq_pick["n_probes"], backend="ragged",
                      res=res)

    batches()                               # the plans' host caches
    obs.reset()
    roofline.reset()
    obs.enable()
    obs.enable_sync()
    try:
        reset_counts()
        batches()
        summ = roofline.summary()
    finally:
        obs.disable_sync()
        obs.disable()
    keys = ("flops", "bytes", "bound", "predicted_bound_s", "measured_s",
            "mxu_utilization", "hbm_bw_utilization", "model_to_measured",
            "achieved_gflops", "dispatches")
    rows = {e: {k: summ["entries"].get(e, {}).get(k) for k in keys}
            for e in ("ivf_flat.paged_pallas", "ivf_pq.search")}
    emit({"phase": "obs.roofline", "peaks": summ["peaks"], "entries": rows,
          "occupancy": {e: summ["entries"].get(e, {}).get("occupancy")
                        for e in rows}})
    for e, r in rows.items():
        if r["measured_s"] is None or r["predicted_bound_s"] is None or \
                r["model_to_measured"] > 1.0 or \
                r["mxu_utilization"] > 1.05 or \
                r["hbm_bw_utilization"] > 1.05:
            raise AssertionError(f"obs.roofline: {e}: {r}")


def drifted_rows(centers, n, batch, sample_seed):
    """``n`` rows of drifted traffic at stream batch ``batch``: a
    ``sift_like`` sample (``sample_seed``) shrunk around a few lists'
    centers and pushed along one direction, further each batch; the lists
    and the direction come from ``MAINT_SEED``."""
    import numpy as np

    from raft_tpu_torch.bench.datasets import sift_like

    rng = np.random.default_rng(MAINT_SEED)
    hot = rng.choice(centers.shape[0], MAINT_HOT_LISTS, replace=False)
    direction = rng.standard_normal(centers.shape[1]).astype(np.float32)
    direction /= np.linalg.norm(direction)
    spread = float(np.median(np.linalg.norm(
        centers - centers.mean(0), axis=1)))
    raw, _ = sift_like(n, centers.shape[1], 1, seed=sample_seed)
    raw = raw.astype(np.float32)
    raw = (raw - raw.mean(0)) * 0.25
    pick = np.random.default_rng(sample_seed).integers(0, MAINT_HOT_LISTS,
                                                       n)
    shift = 0.25 * spread * (batch + 1)
    return (centers[hot[pick]] + raw + shift * direction).astype(np.float32)


def serve_maint_phase(shared, index, pick, dev="cuda"):
    """The PQ-cache store (K3 on the int8 cache) under a drifted stream of
    ``MAINT_ROWS`` rows in ``MAINT_BATCHES`` batches, maintained by
    ``MaintenanceManager`` (exact row source, as the bench runs it)
    against an unmaintained control; both pre-grown to the final
    footprint, so no scan meets a new shape."""
    import numpy as np
    import torch

    from raft_tpu_torch import Resources, serving
    from raft_tpu_torch.neighbors import brute_force, refine
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device=dev)
    host = shared["host"].astype(np.float32)
    n0 = host.shape[0]
    centers = index.centers.cpu().numpy()
    per = MAINT_ROWS // MAINT_BATCHES
    batches = [drifted_rows(centers, per, b, MAINT_SEED + 1 + b)
               for b in range(MAINT_BATCHES)]
    q_drift = drifted_rows(centers, MAINT_QUERIES, MAINT_BATCHES - 1,
                           MAINT_SEED + 99)
    rows_all = np.concatenate([host] + batches)
    n_probes, kf = pick["n_probes"], pick["k_fetch"]

    maintained = serving.PagedListStore.from_index(
        index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    control = serving.PagedListStore.from_index(
        index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    # the final footprint: every new row in its nearest list, twice the
    # longest resulting chain (a split may pile a list's rows on its donor)
    labels = maintained._assign_labels(torch.from_numpy(
        rows_all[n0:]).to(maintained.device))
    add = np.bincount(labels, minlength=maintained.n_lists)
    rows_per_page = maintained.page_rows
    chains = maintained._list_pages + -(-add // rows_per_page) + 1
    width = 1 << int(2 * chains.max() - 1).bit_length()
    pages = maintained.pages_used + int(-(-add // rows_per_page).sum()) \
        + 2 * maintained.n_lists
    for store in (maintained, control):
        store.restore_shape(pages, width)
    cost_row("serve.pq.maintained", maintained)
    mgr = serving.MaintenanceManager(
        maintained, compaction=None, drift_threshold=0.5, split_skew=1.5,
        row_source=lambda ids: rows_all[np.asarray(ids)])

    dev_all = torch.from_numpy(rows_all).to(res.device)
    gt_index = brute_force.build(dev_all, res=res)
    q_orig = shared["queries"][:MAINT_QUERIES]
    q_dr = torch.from_numpy(q_drift).to(res.device)
    gt_orig = brute_force.search(gt_index, q_orig, K, res=res)[1]
    gt_dr = brute_force.search(gt_index, q_dr, K, res=res)[1]
    del gt_index

    def recall(store, queries, gt):
        _, cand = serving.search(store, queries, kf, n_probes=n_probes,
                                 res=res)
        _, ids = refine.refine(dev_all, queries, cand, K, res=res)
        return id_recall(ids, gt)

    for store in (maintained, control):      # meet the scans' signatures
        recall(store, q_orig, gt_orig)
    t0 = serving.scan_trace_count()
    reset_counts()
    statuses, cycles = [], []
    next_id = n0
    for b, rows in enumerate(batches):
        ids = np.arange(next_id, next_id + rows.shape[0], dtype=np.int64)
        next_id += rows.shape[0]
        for store in (maintained, control):
            store.upsert(rows, ids)
        t = time.perf_counter()
        out = mgr.pump()
        rec = (out or {}).get("recluster") or {}
        statuses.append((out or {}).get("status"))
        cycles.append({"batch": b, "status": statuses[-1],
                       "seconds": time.perf_counter() - t,
                       "pairs": rec.get("pairs", 0),
                       "rows_moved": rec.get("rows_moved", 0),
                       "drift": round((out or {}).get("drift", {}).get(
                           "drift_score", 0.0), 4)})
    for _ in range(4):                       # let the detector go quiet
        if not mgr.detect()["drifted"]:
            break
        out = mgr.pump()
        rec = (out or {}).get("recluster") or {}
        statuses.append((out or {}).get("status"))
        cycles.append({"batch": "drain", "status": statuses[-1],
                       "pairs": rec.get("pairs", 0),
                       "rows_moved": rec.get("rows_moved", 0)})
    r_m = recall(maintained, q_dr, gt_dr)
    r_c = recall(control, q_dr, gt_dr)
    r_orig = recall(maintained, q_orig, gt_orig)
    r_orig_c = recall(control, q_orig, gt_orig)
    launches = ss.PAGED_KERNEL.launches
    delta = serving.scan_trace_count() - t0
    rep = mgr.report()
    emit({"phase": "serve.maint", "rows": MAINT_ROWS,
          "batches": MAINT_BATCHES, "n_probes": n_probes, "k_fetch": kf,
          "restore_shape": {"pages": pages, "table_width": width},
          "cycles": cycles, "report": {k: rep[k] for k in (
              "cycles", "pairs_total", "rows_moved", "stale_aborts",
              "failures", "skipped", "drift_score", "list_skew")},
          "recall_drifted_maintained": r_m, "recall_drifted_control": r_c,
          "recall_original_maintained": r_orig,
          "recall_original_control": r_orig_c,
          "scan_trace_delta": delta, "k3_launches": launches,
          "stats": maintained.stats()})
    unknown = [s for s in statuses if s not in MAINT_KNOWN]
    if rep["cycles"] < 1 or rep["pairs_total"] <= 0 or unknown or delta \
            or r_m < r_c or r_orig < 0.95 or launches <= 0:
        raise AssertionError(
            f"serve.maint: cycles {rep['cycles']}, pairs "
            f"{rep['pairs_total']}, unclassified {unknown}, trace delta "
            f"{delta}, recall {r_m} vs control {r_c}, original {r_orig}")


def capacity_phase(dev="cuda"):
    """Many IVF-Flat tenants over one memory budget (the bench's capacity
    rung at ``CAP_TENANTS`` × ``CAP_ROWS`` rows): Zipf popularity, Poisson
    requests through ``CapacityController`` at about 4× oversubscription,
    warm twins (IVF-BQ, K2) built on the card, snapshots in a temporary
    directory."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from raft_tpu_torch import Resources, resilience, serving
    from raft_tpu_torch.bench.datasets import sift_like
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import costmodel
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device=dev)
    rng = np.random.default_rng(29)
    snap = tempfile.TemporaryDirectory()
    try:
        registry = serving.TenantRegistry()
        sizing = serving.CapacityController(registry=registry,
                                            budget_bytes=1 << 50, res=res)
        queries = {}
        t = time.perf_counter()
        for i in range(CAP_TENANTS):
            name = f"tenant{i:02d}"
            data, qs = sift_like(CAP_ROWS, 128, 64, seed=10 + i)
            queries[name] = qs.astype(np.float32)
            idx = ivf_flat.build(torch.from_numpy(data).to(res.device),
                                 ivf_flat.IvfFlatParams(n_lists=CAP_LISTS),
                                 res=res)
            sizing.register(name, idx, snap.name)
        setup_s = time.perf_counter() - t
        total = registry.resident_bytes()
        biggest = max(t.resident_bytes() for t in registry.tenants())
        one_probe = costmodel.estimate_search(
            registry.tenants()[0].hot_obj, q=1, k=K,
            n_probes=CAP_PROBES)["transient_bytes"]
        budget = int(max(total / 4.0, (biggest + 2 * one_probe) / 0.8))
        ctrl = serving.CapacityController(registry=registry,
                                          budget_bytes=budget, window_s=0.2,
                                          res=res)
        t_end = time.perf_counter() + 30
        rec = ctrl.admit(0, entry="capacity.rebudget")
        while rec["verdict"] != "admit" and time.perf_counter() < t_end:
            if not ctrl.make_room(rec.get("shortfall_bytes", 0)):
                time.sleep(ctrl.window_s + 0.02)
            rec = ctrl.admit(0, entry="capacity.rebudget")

        names = sorted(queries)
        ranks = np.arange(1, CAP_TENANTS + 1, dtype=np.float64)
        pop = 1.0 / ranks ** CAP_ZIPF
        choices = rng.choice(CAP_TENANTS, size=CAP_REQUESTS, p=pop / pop.sum())
        think = rng.exponential(0.002, size=CAP_REQUESTS)
        outcomes = collections.Counter()
        reset_counts()
        t0 = time.perf_counter()
        for i in range(CAP_REQUESTS):
            name = names[int(choices[i])]
            q = queries[name][i % 64][None]
            try:
                with resilience.Deadline(2.0, label="capacity.request"):
                    out = ctrl.search(name, q, K, n_probes=CAP_PROBES)
                outcomes["degraded" if out.degraded else "ok"] += 1
            except Exception as e:
                kind = resilience.classify(e)
                outcomes["rejected" if isinstance(e, serving.CapacityRejected)
                         else kind] += 1
            if i % 12 == 0:
                ctrl.autopromote(1)
            if think[i] > 0.004:
                time.sleep(min(think[i], 0.01))
        wall = time.perf_counter() - t0
        k1, k2 = ss.STRIP_KERNEL.launches, bq.BQ_KERNEL.launches
        if ctrl.promote_latency()["count"] == 0:
            victim = names[-1]
            ctrl.demote(victim)
            ctrl.registry.get(victim).last_demoted = 0.0
            ctrl.promote(victim)
        rep = ctrl.report()
        failed = [e for e in resilience.recent_events()
                  if e.get("event") in ("capacity_demote_failed",
                                        "capacity_promote_failed",
                                        "capacity_replay_failed")]
    finally:
        snap.cleanup()
    plat = rep["promote"]
    emit({"phase": "capacity", "tenants": CAP_TENANTS, "rows": CAP_ROWS,
          "n_lists": CAP_LISTS, "setup_s": setup_s, "budget_bytes": budget,
          "oversubscription_x": total / budget, "requests": CAP_REQUESTS,
          "qps": CAP_REQUESTS / wall, "outcomes": dict(outcomes),
          "tiers": {"hot": rep["tenants_resident_hot"],
                    "warm": rep["tenants_resident_warm"],
                    "cold": rep["tenants_cold"]},
          "demotions": rep["demotions"], "promotions": rep["promotions"],
          "rejections": rep["rejections"], "promote": plat,
          "queued_degraded": rep["queued_degraded"],
          "k1_launches": k1, "k2_launches": k2,
          "failed_transitions": len(failed),
          "resident_fraction": rep["resident_fraction"]})
    known = {"ok", "degraded", "rejected", resilience.DEADLINE}
    if outcomes.get(resilience.OOM) or set(outcomes) - known or failed \
            or not plat.get("p50_s") or \
            (outcomes.get("degraded") and k2 <= 0) or \
            (outcomes.get("ok") and k1 <= 0):
        raise AssertionError(f"capacity: outcomes {dict(outcomes)}, failed "
                             f"{failed[:3]}, promote {plat}, K1 {k1}, K2 {k2}")


# ---------------------------------------------------------------------------
# the CAGRA remainder and the distributed indexes: DIST_SHARDS shards on one
# card (local transport), K1 / K2 in the shard scans, K6 never
# ---------------------------------------------------------------------------

DIST_SHARDS = 4              # shards on the one card
DIST_RECALL_SLACK = 0.01     # recall@10 against the single-index path's
DIST_KMEANS_SLACK = 1.10     # inertia against the single-index fit's
DIST_CAGRA_GATE = 0.90
DIST_LOST = 1                # the shard the shard-loss rung marks LOST
NND_ROWS = N_ROWS            # nn_descent rows (cut, with the reason printed,
NND_CUT = ""                 # where the script's time does not allow 1M)
NND_WORKSPACE = 16 << 30     # the join's blocks at 1M rows: 17, not 260
NND_SAMPLE_NODES = 1_000     # graph recall against the exact kNN graph
HNSW_QUERIES = 1_000
HNSW_SLICE = 10_000          # native and Python writers on a slice


def dist_comms(dev="cuda", world=DIST_SHARDS):
    from raft_tpu_torch.comms import Comms, local_mesh

    return Comms(local_mesh(world, device=dev))


def median_qps(fn, q, batches=3):
    """Search QPS of a ``q``-query batch: the median of ``batches`` host
    timings, each to its synchronize → (qps, batch seconds)."""
    _, times = host_qps(fn, q, batches)
    return q / median(times), times


def timed_kernel(module, name):
    """Wrap ``module.name`` (a kernel wrapper) so each call is bracketed by
    CUDA events; → (restore, read): ``read()`` syncs and returns the summed
    milliseconds of the wrapped calls since the wrap."""
    import torch

    orig = getattr(module, name)
    marks = []

    def wrapped(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(*args, **kw)
        b.record()
        marks.append((a, b))
        return out

    setattr(module, name, wrapped)

    def read():
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in marks)

    return (lambda: setattr(module, name, orig)), read


def predicted_launches(index, probes, q_width, k, workspace_bytes):
    """Launches of a distributed IVF search's strip kernel as its plan
    makes them: shards × Σ over query tiles of the tile's length classes."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    kf = min(int(k), ss.MC)
    q, p = probes.shape
    classes, cls_ord_np = ss.class_info(np.asarray(index.lens_max),
                                        dim=q_width)
    cls_ord = torch.as_tensor(cls_ord_np, device=probes.device)
    q_tile = ss.fit_q_tile(q, p, index.n_lists, len(classes), kf,
                           workspace_bytes, dim=q_width)
    per_shard = 0
    for start in range(0, q, q_tile):
        qt = min(q_tile, q - start)
        per_shard += len(ss.plan_tile(probes, start, qt, cls_ord, classes,
                                      index.n_lists)[4])
    return index.comms.size * per_shard, -(-q // q_tile)


def dist_kmeans_phase(shared, dev="cuda"):
    """``distributed.kmeans.fit`` (Lloyd, k-means++, 1,024 clusters) and
    ``fit_balanced`` (1,024 clusters, 20 iterations) on the 1M × 128
    dataset over DIST_SHARDS shards: seconds, n_iter, inertia beside the
    single-index ``cluster/kmeans`` fit on the same data."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.cluster.kmeans import KMeansParams
    from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
    from raft_tpu_torch.distributed import kmeans as dkm
    from raft_tpu_torch.ops.distance import fused_l2_nn_argmin

    res = Resources(device=dev)
    comms = dist_comms(dev)
    X = shared["dataset"].to(torch.float32)
    single_s, single_inertia = HELD["kmeans"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, labels = dkm.fit(X, KMeansParams(n_clusters=KMEANS_CLUSTERS),
                          comms=comms, res=res)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    t = time.perf_counter()
    centers, blabels, report = dkm.fit_balanced(
        X, KMEANS_CLUSTERS, KMeansBalancedParams(), comms=comms, res=res)
    torch.cuda.synchronize()
    bal_s = time.perf_counter() - t
    d2, _ = fused_l2_nn_argmin(X, centers)
    bal_inertia = float(d2.sum())
    sizes = torch.bincount(blabels, minlength=KMEANS_CLUSTERS)
    row = {"phase": "dist.kmeans", "shards": comms.size,
           "layout": f"{comms.size} shards on one card",
           "rows": X.shape[0], "n_clusters": KMEANS_CLUSTERS,
           "fit_s": fit_s, "n_iter": out.n_iter,
           "inertia": float(out.inertia), "single_fit_s": single_s,
           "single_inertia": single_inertia,
           "inertia_over_single": float(out.inertia) / single_inertia,
           "balanced_fit_s": bal_s, "balanced_inertia": bal_inertia,
           "balanced_min_size": int(sizes.min()),
           "balanced_max_size": int(sizes.max()),
           "coverage": report.coverage}
    emit(row)
    if not (bool(torch.isfinite(out.centroids).all())
            and bool(torch.isfinite(centers).all())
            and labels.shape[0] == X.shape[0] == blabels.shape[0]
            and report.coverage == 1.0
            and row["inertia_over_single"] <= DIST_KMEANS_SLACK
            and bal_inertia <= DIST_KMEANS_SLACK * single_inertia):
        raise AssertionError(f"dist.kmeans: {row}")


def dist_brute_phase(shared, dev="cuda"):
    """Sharded exact search, k 10, over DIST_SHARDS shards: ids equal the
    single-index brute force but at near-ties (recall with distances 1.0),
    and one filtered search (the 10% mask) against the single index's."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.distributed import brute_force as dbf
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    comms = dist_comms(dev)
    X = shared["dataset"].to(torch.float32)
    qs = shared["queries"]
    gt_v, gt_i = shared["gt"]
    t = time.perf_counter()
    index = dbf.build(X, comms=comms, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    qps, times = median_qps(lambda: dbf.search(index, qs, K, res=res),
                            qs.shape[0])
    v, i = dbf.search(index, qs, K, res=res)
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    same = float((i == gt_i).float().mean())
    rung = filter_ladder(shared)["rungs"][0]
    fv, fi = dbf.search(index, qs, K, filter=rung["bitset"], res=res)
    sv, si = brute_force.search(brute_force.build(X, res=res), qs, K,
                                filter=rung["bitset"], res=res)
    frec = neighborhood_recall(fi, si, fv, sv)
    passed = bool(rung["mask"][fi.long()].all())
    row = {"phase": "dist.brute_force", "shards": comms.size,
           "layout": f"{comms.size} shards on one card", "build_s": build_s,
           "qps": qps, "batch_s": times, "recall_with_ties": rec,
           "ids_equal_share": same, "filtered_selectivity":
           rung["selectivity"], "filtered_recall_with_ties": frec,
           "filtered_ids_pass": passed}
    emit(row)
    if rec != 1.0 or frec != 1.0 or not passed \
            or not bool(torch.isfinite(v).all()):
        raise AssertionError(f"dist.brute_force: {row}")


def dist_ivf_phase(shared, kind, dev="cuda"):
    """A distributed IVF family over DIST_SHARDS shards at the main path's
    configuration (n_lists 1024; IVF-PQ pq_dim 64 at 8 bits; the single
    path's n_probes and k_fetch): build seconds, search QPS (a 10k batch,
    median of 3), recall@10 (after refine for PQ and BQ) within
    DIST_RECALL_SLACK of the single-index path's, the kernel's launches
    equal to the plan's (shards × tiles × length classes) and its share of
    the search time. IVF-PQ also runs the shard-loss rung and returns its
    index for the snapshot phase."""
    import dataclasses

    import torch

    from raft_tpu_torch import Resources, resilience
    from raft_tpu_torch.distributed import ivf_bq as dbq
    from raft_tpu_torch.distributed import ivf_flat as dflat
    from raft_tpu_torch.distributed import ivf_pq as dpq
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq, refine
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    comms = dist_comms(dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    q = qs.shape[0]
    key = {"ivf_flat": "flat", "ivf_pq": "main", "ivf_bq": "bq"}[kind]
    pick, single_rec = HELD[f"recall.{key}"]
    n_probes = min(pick["n_probes"], N_LISTS)
    k_fetch = pick.get("k_fetch", K)
    if kind == "ivf_flat":
        mod, params = dflat, ivf_flat.IvfFlatParams(n_lists=N_LISTS)
        counter, wrapper, kernel = ss.STRIP_KERNEL, (ss, "strip_class"), "K1"
    elif kind == "ivf_pq":
        mod, params = dpq, ivf_pq.IvfPqParams(n_lists=N_LISTS, pq_dim=64,
                                              pq_bits=8)
        counter, wrapper, kernel = ss.STRIP_KERNEL, (ss, "strip_class"), "K1"
    else:
        mod, params = dbq, ivf_bq.IvfBqParams(n_lists=N_LISTS)
        counter, wrapper, kernel = bq.BQ_KERNEL, (bq, "bq_class"), "K2"
    torch.cuda.synchronize()
    t = time.perf_counter()
    index = mod.build(dataset, params, comms=comms, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t

    def search(health=None, idx=None):
        return mod.search(idx or index, qs, k_fetch, n_probes=n_probes,
                          res=res, health=health)

    def run():
        v, i = search()
        if kind == "ivf_flat":
            return v, i
        return refine.refine(dataset, qs, i, K, res=res)

    # the plan's launch count: the probes as the search makes them
    qf = qs.to(torch.float32)
    if kind == "ivf_flat":
        probes = ivf_flat._coarse_probes(qf, index.centers, n_probes,
                                         "sqeuclidean")
        width = index.dim
    elif kind == "ivf_pq":
        probes, _, _ = ivf_pq._pq_probe_prep(qf, index.centers,
                                             index.rotation, n_probes,
                                             "exact", True)
        width = index.decoded[0].shape[-1]
    else:
        probes, qr, _ = ivf_bq._bq_search_prep(qf, index.centers,
                                               index.rotation, n_probes,
                                               "exact", True, index.bits,
                                               index.rotation_kind)
        width = qr.shape[1]
    predicted, tiles = predicted_launches(index, probes, width, k_fetch,
                                          res.workspace_bytes)
    reset_counts()
    v, i = run()
    torch.cuda.synchronize()
    launches = counter.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    qps, times = median_qps(run, q)
    search_ms = cuda_ms(search, reps=3)
    restore, read = timed_kernel(*wrapper)
    try:
        search()
        kernel_ms = read()
    finally:
        restore()
    row = {"phase": f"dist.{kind}", "shards": comms.size,
           "layout": f"{comms.size} shards on one card",
           "n_lists": N_LISTS, "max_list_size": index.max_list_size,
           "n_probes": n_probes, "k_fetch": k_fetch, "build_s": build_s,
           "qps": qps, "batch_s": times, "recall": rec,
           "single_recall": single_rec, "kernel": kernel,
           "launches": launches, "launches_predicted": predicted,
           "tiles": tiles, "search_ms": search_ms, "kernel_ms": kernel_ms,
           "kernel_share": kernel_ms / search_ms}
    emit(row)
    if not bool(torch.isfinite(v).all()) or tuple(i.shape) != (q, K):
        raise AssertionError(f"dist.{kind} returned non-finite or misshapen "
                             f"results")
    if abs(rec - single_rec) > DIST_RECALL_SLACK:
        raise AssertionError(f"dist.{kind}: recall@10 {rec} against the "
                             f"single index's {single_rec}")
    if launches != predicted or launches <= 0:
        raise AssertionError(f"dist.{kind}: {launches} {kernel} launches, "
                             f"the plan makes {predicted}")
    if kind != "ivf_pq":
        return {kernel: launches}, None

    # one shard LOST: coverage 0.75, degraded, and exactly the search of
    # an index whose lost shard holds nothing
    health = resilience.ShardHealth()
    health.mark_lost(DIST_LOST, "chip_smoke shard-loss rung")
    lost = search(health)
    dead = dataclasses.replace(index, bias=[
        torch.full_like(b, float("inf")) if r == DIST_LOST else b
        for r, b in zip(comms.ranks, index.bias)])
    want = search(idx=dead)
    exact = bool(torch.equal(lost[1], want[1])
                 and torch.equal(lost[0], want[0]))
    rows_per = -(-dataset.shape[0] // comms.size)
    from_lost = int(((lost[1] >= DIST_LOST * rows_per)
                     & (lost[1] < (DIST_LOST + 1) * rows_per)).sum())
    rung = {"phase": "dist.ivf_pq.shard_loss", "lost": DIST_LOST,
            "coverage": lost.coverage, "degraded": lost.degraded,
            "lost_shards": list(lost.lost_shards),
            "exact_over_survivors": exact, "ids_from_lost_shard": from_lost}
    emit(rung)
    if lost.coverage != 0.75 or not lost.degraded or not exact \
            or from_lost or lost.lost_shards != (DIST_LOST,):
        raise AssertionError(f"dist.ivf_pq shard loss: {rung}")
    return {kernel: launches}, (index, search, health)


def dist_snapshot_phase(index, search, health):
    """The sharded IVF-PQ index through its snapshot: save, ``load`` (the
    same results), the LOST shard's tensors wiped and ``restore_shard`` /
    ``recover``ed from its file (the results before the loss, coverage
    back to 1.0)."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch

    from raft_tpu_torch.distributed import snapshot

    v0, i0 = search()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        snapshot.save(index, d)
        save_s = time.perf_counter() - t
        nbytes = sum(f.stat().st_size for f in Path(d).iterdir())
        t = time.perf_counter()
        loaded = snapshot.load(d, index.comms)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        v1, i1 = search(idx=loaded)
        same_load = bool(torch.equal(i1, i0) and torch.equal(v1, v0))
        wiped = dataclasses.replace(index, decoded=[
            torch.zeros_like(t_) if r == DIST_LOST else t_
            for r, t_ in zip(index.comms.ranks, index.decoded)])
        t = time.perf_counter()
        restored = snapshot.restore_shard(wiped, d, DIST_LOST)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        v2, i2 = search(idx=restored)
        same_restore = bool(torch.equal(i2, i0) and torch.equal(v2, v0))
        recovered_index, recovered = snapshot.recover(wiped, d, health)
        r3 = search(health=health, idx=recovered_index)
        same_recover = bool(torch.equal(r3[1], i0) and torch.equal(r3[0], v0))
    row = {"phase": "dist.snapshot", "kind": "ivf_pq", "bytes": nbytes,
           "save_s": save_s, "load_s": load_s, "restore_shard_s": restore_s,
           "load_equal": same_load, "restore_equal": same_restore,
           "recovered": list(recovered), "recover_equal": same_recover,
           "coverage_after": r3.coverage, "degraded_after": r3.degraded}
    emit(row)
    if not (same_load and same_restore and same_recover
            and recovered == (DIST_LOST,) and r3.coverage == 1.0
            and not r3.degraded):
        raise AssertionError(f"dist.snapshot: {row}")


def dist_cagra_phase(shared, params=None, dev="cuda"):
    """Sharded CAGRA over DIST_SHARDS shards: one single-index build a
    shard (the IVF candidate scan through K1, counted shard by shard),
    then the shard bodies' compressed loop in plain torch (K6 launches 0),
    recall@10 ≥ DIST_CAGRA_GATE, QPS. ``params`` are the CAGRA defaults
    unless a CPU rehearsal at a tiny size sets them."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.distributed import cagra as dcagra
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    comms = dist_comms(dev)
    dataset, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    q = qs.shape[0]
    per_shard = []
    orig = cagra.build

    def counted(*args, **kw):
        before = ss.STRIP_KERNEL.launches
        out = orig(*args, **kw)
        per_shard.append(ss.STRIP_KERNEL.launches - before)
        return out

    reset_counts()
    cagra.build = counted
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        index = dcagra.build(dataset, params or cagra.CagraParams(),
                             comms=comms, res=res)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
    finally:
        cagra.build = orig
    k1_build = ss.STRIP_KERNEL.launches
    sp = cagra.CagraSearchParams(itopk_size=64, search_width=4)
    reset_counts()
    st = {}
    v, i = dcagra.search(index, qs, K, sp, res=res, stats=st)
    torch.cuda.synchronize()
    k6 = ch.HOP_KERNEL.launches
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    qps, times = median_qps(lambda: dcagra.search(index, qs, K, sp, res=res),
                            q)
    row = {"phase": "dist.cagra", "shards": comms.size,
           "layout": f"{comms.size} shards on one card", "build_s": build_s,
           "rows_per_shard": index.rows_per_shard,
           "k1_launches_build": k1_build, "k1_launches_per_shard": per_shard,
           "payload": index.nbr_codes is not None,
           "seeding_table": index.centroids is not None,
           "itopk": 64, "width": 4, "mode": st["mode"], "recall": rec,
           "single_recall": HELD["cagra.graph"][1], "qps": qps,
           "batch_s": times, "k6_launches": k6}
    emit(row)
    if (len(per_shard) != comms.size or min(per_shard) <= 0 or k6 != 0
            or st["mode"] != "compressed" or rec < DIST_CAGRA_GATE
            or not bool(torch.isfinite(v).all())):
        raise AssertionError(f"dist.cagra: {row}")
    del index
    torch.cuda.empty_cache()
    return {"K1": k1_build, "K6": k6}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_nccl_phase(shared, dev="cuda"):
    """The ``process_group`` transport at world 1 on NCCL (a localhost
    rendezvous): the nine self-tests, and a distributed IVF-PQ search at
    world 1 equal to the same index's on the ``local`` transport; the
    group is torn down after."""
    import dataclasses

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.comms import (Comms, comms_self_test,
                                      init_distributed, process_group_mesh,
                                      shutdown_distributed)
    from raft_tpu_torch.core.resources import use_resources
    from raft_tpu_torch.distributed import ivf_pq as dpq
    from raft_tpu_torch.neighbors import ivf_pq

    res = Resources(device=dev)
    dataset, qs = shared["dataset"], shared["queries"]
    pick, _ = HELD["recall.main"]
    local = dist_comms(dev, world=1)
    index = dpq.build(dataset, ivf_pq.IvfPqParams(n_lists=N_LISTS, pq_dim=64,
                                                  pq_bits=8),
                      comms=local, res=res)
    want = dpq.search(index, qs, pick["k_fetch"], n_probes=pick["n_probes"],
                      res=res)
    t = time.perf_counter()
    with use_resources(res):        # the backend follows the device
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=60.0)
    init_s = time.perf_counter() - t
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        mesh = process_group_mesh()
        checks = comms_self_test(mesh)
        pg_index = dataclasses.replace(index, comms=Comms(mesh))
        got = dpq.search(pg_index, qs, pick["k_fetch"],
                         n_probes=pick["n_probes"], res=res)
        torch.cuda.synchronize()
    finally:
        shutdown_distributed()
    same = bool(torch.equal(got[1], want[1]))
    row = {"phase": "dist.nccl", "backend": backend, "world": 1,
           "init_s": init_s, "self_test": checks, "ids_equal_local": same,
           "values_equal_local": bool(torch.equal(got[0], want[0]))}
    emit(row)
    want_backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if backend != want_backend or not all(checks.values()) or not same:
        raise AssertionError(f"dist.nccl: {row}")


def graph_recall(graph, X, nodes, k):
    """Recall of ``graph``'s rows at ``nodes`` against their exact k
    nearest neighbours in X (self excluded)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force

    _, nn = brute_force.knn(X[nodes], X, k + 1, device=X.device)
    exact = nn[:, 1:]
    got = graph[nodes][:, :k].long()
    return float((got[:, :, None] == exact[:, None, :].long()).any(2)
                 .float().mean())


def cagra_nn_descent_phase(shared, dev="cuda"):
    """``nn_descent.build`` at NND_ROWS × 128 with the CAGRA defaults
    (graph_degree 64, intermediate 128): seconds, iterations, graph recall
    against the exact kNN graph on NND_SAMPLE_NODES sampled nodes; then
    CAGRA search recall@10 from ``cagra.build(build_algo="nn_descent")``."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra, nn_descent
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev, workspace_bytes=NND_WORKSPACE)
    X = shared["dataset"][:NND_ROWS].to(torch.float32)
    n = X.shape[0]
    gen = torch.Generator(device=X.device)
    gen.manual_seed(7)
    nodes = torch.randperm(n, generator=gen, device=X.device)[
        :NND_SAMPLE_NODES]
    stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    graph = nn_descent.build(X, nn_descent.NNDescentParams(), res=res,
                             stats=stats)
    torch.cuda.synchronize()
    nnd_s = time.perf_counter() - t
    g_rec = graph_recall(graph, X, nodes, 64)
    del graph
    torch.cuda.empty_cache()
    # one round at the default workspace, whose smaller join blocks each
    # merge the whole (n, K) state: what a user calling with default
    # Resources pays a round
    dflt = {}
    nn_descent.build(X, nn_descent.NNDescentParams(max_iterations=1),
                     res=Resources(device=dev), stats=dflt)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    index = cagra.build(X, cagra.CagraParams(build_algo="nn_descent"),
                        res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    qs = shared["queries"]
    if n == shared["dataset"].shape[0]:
        gt_v, gt_i = shared["gt"]
    else:
        from raft_tpu_torch.neighbors import brute_force

        gt_v, gt_i = brute_force.search(brute_force.build(X, res=res), qs,
                                        K, res=res)
    v, i = cagra.search(index, qs, K, cagra.CagraSearchParams(
        itopk_size=64, search_width=4), res=res)
    rec = neighborhood_recall(i, gt_i, v, gt_v)
    row = {"phase": "cagra.nn_descent", "rows": n, "dim": X.shape[1],
           "cut": NND_CUT or None, "graph_degree": 64,
           "intermediate_graph_degree": 128, "seconds": nnd_s,
           "iterations": stats["iterations"], "updates": stats["updates"],
           "join_block": stats["block"],
           "join_blocks": -(-n // stats["block"]), "init_s": stats["init_s"],
           "default_workspace_bytes": Resources(device=dev).workspace_bytes,
           "default_join_blocks": -(-n // dflt["block"]),
           "default_round_s": dflt["round_s"][0],
           "round_s": stats["round_s"], "graph_recall_at_64": g_rec,
           "sample_nodes": NND_SAMPLE_NODES, "cagra_build_s": build_s,
           "cagra_build_phases_s": index.build_timings_s,
           "cagra_recall": rec}
    emit(row)
    if not 0.5 <= g_rec <= 1.0 or rec < 0.9 \
            or not bool(torch.isfinite(v).all()):
        raise AssertionError(f"cagra.nn_descent: {row}")
    del index
    torch.cuda.empty_cache()


def cagra_hnsw_phase(shared):
    """``save_to_hnswlib`` of the single-index 1M CAGRA graph into a
    temporary directory, ``HnswIndex.load`` + ``knn`` on HNSW_QUERIES
    queries (recall@10, bytes, seconds, the writer), and the native and
    Python writers' bytes equal on a HNSW_SLICE-node slice."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from raft_tpu_torch import native
    from raft_tpu_torch.neighbors import hnsw
    from raft_tpu_torch.neighbors.cagra import CagraIndex
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    graph, cagra_rec = HELD.pop("cagra.graph")
    data = shared["host"].astype(np.float32)
    qs = shared["queries"][:HNSW_QUERIES].cpu().numpy()
    gt_v, gt_i = (t[:HNSW_QUERIES].cpu() for t in shared["gt"])
    lib = native.get_native_lib()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "cagra_1m.hnsw"
        t = time.perf_counter()
        which = hnsw.save_to_hnswlib(CagraIndex(data, graph.numpy(), None),
                                     path)
        save_s = time.perf_counter() - t
        nbytes = path.stat().st_size
        t = time.perf_counter()
        h = hnsw.HnswIndex.load(path, dim=data.shape[1])
        load_s = time.perf_counter() - t
        t = time.perf_counter()
        dv, di = h.knn(qs, K, ef=64)
        knn_s = time.perf_counter() - t
        g = np.ascontiguousarray(graph.numpy()[:HNSW_SLICE], np.uint32)
        x = np.ascontiguousarray(data[:HNSW_SLICE])
        hnsw.write_native(lib, Path(d) / "n.bin", g, x, HNSW_SLICE // 2)
        hnsw.write_python(Path(d) / "p.bin", g, x, HNSW_SLICE // 2)
        same = (Path(d) / "n.bin").read_bytes() == (Path(d) / "p.bin"
                                                     ).read_bytes()
    rec = neighborhood_recall(di, gt_i, dv, gt_v)
    row = {"phase": "cagra.hnsw", "rows": data.shape[0],
           "degree": int(graph.shape[1]), "writer": which, "bytes": nbytes,
           "save_s": save_s, "load_s": load_s, "queries": HNSW_QUERIES,
           "knn_s": knn_s, "ef": 64, "recall": rec,
           "cagra_recall": cagra_rec, "slice_rows": HNSW_SLICE,
           "native_python_identical": same}
    emit(row)
    if which != "native" or not same or rec < 0.9:
        raise AssertionError(f"cagra.hnsw: {row}")


# ---------------------------------------------------------------------------
# The sparse tier, graph clustering, the hybrid and out-of-core paths:
# bench.py's hybrid rung (:834-864) and deep10m section (:2800-2881), then
# the out-of-core scan and the graph half on the shared rows
# ---------------------------------------------------------------------------

HYBRID_ROWS = 200_000        # bench.py's filtered section on the card (FN)
HYBRID_LISTS = 256
HYBRID_VOCAB = 1_000
HYBRID_DENSITY = 0.02
HYBRID_SPARSE_DIM = 128
HYBRID_QUERIES = 256         # bench.py's FQ = min(Q, 256)
HYBRID_PROBES = 32           # NPROBE0 * 2
HYBRID_SEED = 13             # the filtered section's default_rng(13)
DEEP_ROWS = 10_000_000       # bench.py's _deep10m_crossover
DEEP_DIM = 96
DEEP_LISTS = 4096
DEEP_CHUNK = 32_768          # the chunked exact scan's window
DEEP_PROBES = (32, 64, 128)  # the ladder at k_fetch 2·K, then exact refine
DEEP_REPS = 3
OOC_QUERIES = 1_000
SLAB = 32                    # BatchKQuery: three slabs of 32
SLAB_QUERIES = 1_000
GRAPH_ROWS = 100_000
GRAPH_QUERIES = 1_000
GRAPH_CLUSTERS = 64
SPECTRAL_PARTS = 8
BALL_WORKSPACE = 8 << 30     # ball cover's (tile, batch, m, dim) gathers


def hybrid_sparse_rows(n):
    """bench.py's hybrid rung's sparse rows: ``vocab`` term weights at
    density 0.02, from ``default_rng(13)``."""
    import numpy as np

    rng = np.random.default_rng(HYBRID_SEED)
    return ((rng.random((n, HYBRID_VOCAB)) < HYBRID_DENSITY)
            * rng.random((n, HYBRID_VOCAB))).astype(np.float32)


def hybrid_phase(shared, dev="cuda"):
    """bench.py's hybrid rung at its on-card sizes: a hybrid IVF-BQ index
    over the first 200,000 rows fused with hashed sparse rows (K2 over
    128 + 128 = 256-wide fused rows), recall@10 against the exact fused
    ground truth (fp32 product, TF32 off, top-k), QPS and K2's launches;
    the dense and CSR projections bit for bit; K2 against its twin at the
    path's class calls; then ``to_store`` → ``serving.search`` over fused
    queries (K4), its ids against ``hybrid.search``'s but at near-ties and
    K4 against its twin at the store's class calls."""
    import torch

    from raft_tpu_torch import Resources, serving, sparse
    from raft_tpu_torch.neighbors import hybrid, ivf_bq
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import distance as dist
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    t = time.perf_counter()
    sp_host = hybrid_sparse_rows(HYBRID_ROWS)
    gen_s = time.perf_counter() - t
    dense = shared["dataset"][:HYBRID_ROWS].to(torch.float32)
    sp = torch.from_numpy(sp_host).to(dev)
    proj_dense = hybrid.project_sparse(sp, HYBRID_SPARSE_DIM)
    csr = sparse.csr_from_dense(sp)
    proj_csr = hybrid.project_sparse(csr, HYBRID_SPARSE_DIM)
    same_projection = bool(torch.equal(proj_dense, proj_csr))
    nnz = int(csr.nnz())
    del csr, proj_csr
    torch.cuda.synchronize()
    t = time.perf_counter()
    hyb = hybrid.build(dense, sp, ivf_bq.IvfBqParams(
        n_lists=HYBRID_LISTS, metric="inner_product",
        kmeans_trainset_fraction=0.2), sparse_dim=HYBRID_SPARSE_DIM, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    qd = shared["queries"][:HYBRID_QUERIES].to(torch.float32)
    qs_sp = sp[:HYBRID_QUERIES]
    fused_q = hybrid.fuse_queries(hyb, qd, qs_sp)
    fused_rows = torch.cat([dense, hyb.beta * proj_dense], dim=1)
    gt = torch.topk(dist.matmul_t(fused_q, fused_rows), K, dim=1).indices

    def run():
        return hybrid.search(hyb, qd, qs_sp, K, n_probes=HYBRID_PROBES,
                             res=res)

    reset_counts()
    hv, hi = run()
    torch.cuda.synchronize()
    launches = bq.BQ_KERNEL.launches
    rec = id_recall(hi, gt)
    qps, batch_s = host_qps(run, HYBRID_QUERIES)
    emit({"phase": "hybrid", "rows": HYBRID_ROWS, "vocab": HYBRID_VOCAB,
          "density": HYBRID_DENSITY, "nnz": nnz,
          "sparse_dim": HYBRID_SPARSE_DIM, "fused_dim": hyb.dim,
          "n_lists": HYBRID_LISTS, "n_probes": HYBRID_PROBES,
          "queries": HYBRID_QUERIES, "sparse_gen_s": gen_s,
          "build_s": build_s, "hybrid_recall": rec, "qps": qps,
          "batch_s": batch_s, "k2_launches": launches,
          "projection_dense_equals_csr": same_projection})
    if not same_projection:
        raise AssertionError("hybrid: the dense and CSR projections differ")
    if launches <= 0 or hyb.dim != 128 + HYBRID_SPARSE_DIM \
            or not bool(torch.isfinite(hv).all()) \
            or tuple(hi.shape) != (HYBRID_QUERIES, K):
        raise AssertionError(f"hybrid: {launches} K2 launches, dim "
                             f"{hyb.dim}, results {tuple(hi.shape)}")
    calls, qt = bq_path_class_inputs(hyb.index, fused_q, HYBRID_PROBES, K,
                                     res)
    k2_err = kernel_parity_at(calls, "bq_scan",
                              f"hybrid_fused{hyb.dim}_nprobe"
                              f"{HYBRID_PROBES}_kf{K}")
    k2 = kernel_timing(calls, "bq_scan", bq_library_yardstick,
                       hyb.index.code_bytes_per_row + 8)
    emit({"phase": "hybrid.k2", "fused_dim": hyb.dim,
          "rot_dim": hyb.index.rot_dim, "query_tile": qt,
          "loop": "/".join(product_loops(calls, "bq_scan")), **k2})
    del calls

    store = hybrid.to_store(hyb, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    reset_counts()
    sv, si = serving.search(store, fused_q, K, n_probes=HYBRID_PROBES,
                            res=res)
    torch.cuda.synchronize()
    store_launches = bq.PAGED_BQ_KERNEL.launches
    atol = 5e-4 * float((fused_q.double() ** 2).sum(1).max())
    verdict = topk_agreement(hv, hi, sv, si, rtol=5e-4, atol=atol,
                             tie_rtol=1e-3)
    calls, _, row_bytes, _ = serve_codes_inputs(store, "bq", fused_q,
                                                HYBRID_PROBES, K, res)
    k4_err = kernel_parity_at(calls, "paged_bq_scan",
                              f"hybrid_store_nprobe{HYBRID_PROBES}_kf{K}")
    emit({"phase": "hybrid.store", "k4_launches": store_launches,
          "recall": id_recall(si, gt), "agrees_with_search": verdict,
          "page_rows": SERVE_PLAN_PAGE_ROWS, "code_bytes_per_row": row_bytes})
    if store_launches <= 0 or not verdict["ok"]:
        raise AssertionError(f"hybrid.store: {store_launches} K4 launches, "
                             f"{verdict}")
    del calls, store, hyb, fused_rows, proj_dense, sp, dense
    torch.cuda.empty_cache()
    return ({"launches_hybrid": launches, "max_abs_err": k2_err,
             "hybrid_fused256": {k: k2[k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
            {"launches_hybrid_store": store_launches, "max_abs_err": k4_err})


def deep10m_phase(dev="cuda"):
    """bench.py's deep10m section whole and at full size: ``sift_like(10M,
    96, 10k, seed=1)`` on the card as uint8; exact ground truth and the
    brute baseline from ``batch_knn.search_device_chunked`` (32,768-row
    windows); IVF-PQ (n_lists 4096, pq_dim 48 × 8 bits, train fraction
    0.1, list cap 4096) searched through K1 over the int8 cache at
    rot_dim 96 (n_probes 32 → 64 → 128 at k_fetch 20, exact refine) up to
    the 0.95 gate; QPS, ``ann_beats_brute``, build seconds, K1's launches
    and K1 at the path's class calls against its twin, timed beside its
    bound and yardstick. No OOM retry: the card holds 80 GB, and
    ``resilience.degraded_tile`` must stay 0. The host rows, the queries
    and the ground truth stay in ``HELD`` for the out-of-core phase."""
    import torch

    from raft_tpu_torch import Resources, resilience
    from raft_tpu_torch.bench.datasets import sift_like
    from raft_tpu_torch.neighbors import batch_knn, ivf_pq, refine
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    res = Resources(device=dev)
    resilience.clear_events()
    t = time.perf_counter()
    data_u8, queries_u8 = sift_like(DEEP_ROWS, DEEP_DIM, N_QUERIES, seed=1)
    gen_s = time.perf_counter() - t
    dataset = torch.from_numpy(data_u8).to(dev)
    queries = torch.from_numpy(queries_u8).to(dev).to(torch.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    gt_v, gt_i = batch_knn.search_device_chunked(
        dataset, queries, K, chunk_rows=DEEP_CHUNK, res=res)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t
    brute_qps, brute_s = host_qps(lambda: batch_knn.search_device_chunked(
        dataset, queries, K, chunk_rows=DEEP_CHUNK, res=res), N_QUERIES,
        batches=1)
    emit({"phase": "deep10m.brute", "rows": DEEP_ROWS, "dim": DEEP_DIM,
          "queries": N_QUERIES, "data_gen_s": gen_s, "chunk_rows": DEEP_CHUNK,
          "ground_truth_s": gt_s, "qps": brute_qps, "batch_s": brute_s})

    before = allocated()
    t = time.perf_counter()
    index = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
        n_lists=DEEP_LISTS, pq_dim=DEEP_DIM // 2, pq_bits=8,
        kmeans_trainset_fraction=0.1, list_size_cap=4096), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    rot_dim = int(index.rotation.shape[0])
    after = allocated()
    emit({"phase": "deep10m.setup", "build_s": build_s,
          "max_list_size": index.max_list_size, "rot_dim": rot_dim,
          "backend": ivf_pq.resolve_backend("auto", "cuda",
                                            index.max_list_size, 2 * K),
          "index_bytes_growth": None if before is None else after - before})

    def run(n_probes, qs=queries):
        _, cand = ivf_pq.search(index, qs, 2 * K, n_probes=n_probes, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    reset_counts()
    pick, ladder = None, []
    for n_probes in DEEP_PROBES:
        v, i = run(n_probes)
        rec = neighborhood_recall(i, gt_i, v, gt_v)
        ladder.append([n_probes, rec])
        if pick is None or rec > pick["recall"]:
            pick = {"n_probes": n_probes, "recall": rec, "k_fetch": 2 * K}
        if rec >= 0.95:
            break
    qps, batch_s = host_qps(lambda: run(pick["n_probes"]), N_QUERIES,
                            batches=DEEP_REPS)
    launches = ss.STRIP_KERNEL.launches
    degraded = [e for e in resilience.recent_events()
                if e["event"] == "degraded_tile"]
    out = {"phase": "deep10m.search", **pick, "ladder": ladder, "qps": qps,
           "batch_s": batch_s, "brute_qps": brute_qps,
           "ann_beats_brute": bool(qps > brute_qps and pick["recall"] >= 0.95),
           "build_s": build_s, "k1_launches": launches,
           "resilience.degraded_tile": len(degraded)}
    emit(out)
    if pick["recall"] < 0.95 or launches <= 0 or degraded \
            or not bool(torch.isfinite(v).all()):
        raise AssertionError(f"deep10m: {out}")

    # K1 at rot_dim 96: not a multiple of the 64-dim staging chunk, so the
    # plan takes the scalar-staged mma.sync route
    calls, qt = main_path_class_inputs(index, queries, pick["n_probes"],
                                       2 * K, res)
    k1_err = kernel_parity_at(calls, "strip_scan",
                              f"deep10m_dim{rot_dim}_nprobe"
                              f"{pick['n_probes']}_kf{2 * K}")
    timing = kernel_timing(calls, "strip_scan", library_yardstick,
                           rot_dim + 4)
    emit({"phase": "deep10m.k1", "rot_dim": rot_dim,
          "dim_mod_staging_chunk": rot_dim % 64,
          "n_probes": pick["n_probes"], "kf": 2 * K, "query_tile": qt,
          "classes": [[c["w_blocks"] * 512, c["n_sub"],
                       int((c["strip_list"] >= 0).sum())] for c in calls],
          **timing})
    del calls, index, dataset
    torch.cuda.empty_cache()
    HELD["deep10m"] = (data_u8, queries, gt_v, gt_i)
    return {"launches_deep10m": launches, "max_abs_err": k1_err,
            "deep10m_dim96": {k: timing[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def out_of_core_phase(shared, dev="cuda"):
    """``batch_knn.search_out_of_core`` over the deep10m rows kept as a host
    numpy array, for the first 1,000 queries, chunked by the default
    workspace: its ids against ``search_device_chunked``'s but at
    near-ties, seconds and host-to-card GB/s; then ``BatchKQuery`` over the
    1M ``brute_force`` index, three slabs of 32 equal to one search at
    k 96."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import batch_knn, brute_force
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    data_u8, queries, gt_v, gt_i = HELD.pop("deep10m")
    qs = queries[:OOC_QUERIES]
    n, dim = data_u8.shape
    chunk = int(max(K, min(n, res.workspace_bytes
                           // max(1, (dim + qs.shape[0]) * 4))))
    torch.cuda.synchronize()
    t = time.perf_counter()
    ov, oi = batch_knn.search_out_of_core(data_u8, qs, K, res=res)
    torch.cuda.synchronize()
    ooc_s = time.perf_counter() - t
    h2d_bytes = n * dim * 4          # fp32 chunks, each row once
    # uint8 rows and queries: every distance is an integer below 2^24, so
    # both scans compute it exactly; ids may differ only at exact ties
    verdict = topk_agreement(gt_v[:OOC_QUERIES], gt_i[:OOC_QUERIES], ov, oi,
                             rtol=0.0, atol=0.5, tie_rtol=0.0)
    out = {"phase": "batch_knn.out_of_core", "rows": n, "dim": dim,
           "queries": OOC_QUERIES, "chunk_rows": chunk,
           "chunks": -(-n // chunk), "seconds": ooc_s,
           "h2d_bytes": h2d_bytes, "h2d_gb_s": h2d_bytes / ooc_s / 1e9,
           "agrees_with_device_chunked": verdict}
    emit(out)
    if not verdict["ok"]:
        raise AssertionError(f"batch_knn.out_of_core: {out}")
    del data_u8, queries, gt_v, gt_i

    bf = brute_force.build(shared["dataset"], res=res)
    q = shared["queries"][:SLAB_QUERIES]
    t = time.perf_counter()
    slabs = []
    for slab in batch_knn.BatchKQuery(bf, q, SLAB, res=res):
        slabs.append(slab)
        if len(slabs) == 3:
            break
    torch.cuda.synchronize()
    slab_s = time.perf_counter() - t
    whole_v, whole_i = brute_force.search(bf, q, 3 * SLAB, res=res)
    same = bool(torch.equal(torch.cat([s[1] for s in slabs], 1), whole_i)
                and torch.equal(torch.cat([s[0] for s in slabs], 1), whole_v))
    emit({"phase": "batch_knn.batch_k_query", "rows": bf.size,
          "queries": SLAB_QUERIES, "slab": SLAB, "slabs": len(slabs),
          "seconds": slab_s, "equals_one_search_at_k96": same})
    if not same or len(slabs) != 3:
        raise AssertionError("batch_knn: three slabs of 32 differ from one "
                             "search at k 96")


def graph_phase(shared, dev="cuda"):
    """The graph half on the first 100,000 rows: ``knn_graph`` at
    k = ⌊log2 n⌋ + 15 = 31, its Borůvka ``mst`` total weight against
    scipy's minimum spanning tree of the same symmetrised graph (rel
    1e-5); ``single_linkage(n_clusters=64)`` (n − 1 merge edges, exactly
    64 labels); ``spectral.partition`` into 8 with each eigenpair's
    residual ‖Lv − λv‖; ``ball_cover`` answering 1,000 queries with brute
    force's ids but at near-ties; ``eps_nn`` and ``eps_neighbors``
    agreeing on the adjacency counts."""
    import math

    import numpy as np
    import scipy.sparse as scsp
    from scipy.sparse.csgraph import minimum_spanning_tree

    import torch

    from raft_tpu_torch import Resources, spectral
    from raft_tpu_torch.cluster.single_linkage import single_linkage
    from raft_tpu_torch.neighbors import (ball_cover, brute_force,
                                          epsilon_neighborhood)
    from raft_tpu_torch.sparse import linalg, neighbors, solver
    from raft_tpu_torch.sparse.convert import coo_to_csr
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    X = shared["dataset"][:GRAPH_ROWS].to(torch.float32)
    n = X.shape[0]
    k = int(math.log2(n)) + 15
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return out

    g = timed("knn_graph_s", lambda: neighbors.knn_graph(X, k, res=res))
    m = timed("mst_s", lambda: solver.mst(g))
    n_edges = int(m.n_edges)
    total = float(m.weight[:n_edges].double().sum())
    keep = g.valid.cpu().numpy()
    w = g.vals.cpu().numpy()[keep].astype(np.float64)
    w[w == 0] = np.nextafter(0.0, 1.0)   # scipy reads a 0 as no edge
    t = time.perf_counter()
    sp_graph = scsp.csr_matrix((w, (g.rows.cpu().numpy()[keep],
                                    g.cols.cpu().numpy()[keep])),
                               shape=(n, n))
    ref_tree = minimum_spanning_tree(sp_graph)
    ref_total = float(ref_tree.sum())
    times["scipy_mst_s"] = time.perf_counter() - t
    rel = abs(total - ref_total) / max(ref_total, 1e-30)

    link = timed("single_linkage_s",
                 lambda: single_linkage(X, GRAPH_CLUSTERS, res=res))
    link_edges = int((link.mst_src >= 0).sum())
    n_labels = int(torch.unique(link.labels).numel())

    labels, evals, evecs = timed("spectral_s", lambda: spectral.partition(
        g, SPECTRAL_PARTS, res=res))
    lap = coo_to_csr(linalg.laplacian(g, normalized=True))
    resid = [float(torch.linalg.vector_norm(
        linalg.spmv(lap, evecs[:, j]) - evals[j] * evecs[:, j]))
        for j in range(evals.shape[0])]
    parts = int(torch.unique(labels).numel())

    q = shared["queries"][:GRAPH_QUERIES].to(torch.float32)
    big = Resources(device=dev, workspace_bytes=BALL_WORKSPACE)
    bc = timed("ball_cover_build_s", lambda: ball_cover.build(X, res=big))
    bv, bi = timed("ball_cover_query_s",
                   lambda: ball_cover.knn_query(bc, q, K, res=big))
    fv, fi = brute_force.search(brute_force.build(X, res=res), q, K,
                                res=res)
    scale = float((X.double() ** 2).sum(1).max())
    verdict = topk_agreement(fv, fi, bv * bv, bi,
                             rtol=1e-5, atol=2e-6 * scale, tie_rtol=1e-4)
    eps = float(torch.sqrt(fv[:, K - 1].median()))
    adj, deg = timed("eps_nn_s", lambda: ball_cover.eps_nn(bc, q, eps,
                                                           res=big))
    adj2, deg2 = timed("eps_neighbors_s",
                       lambda: epsilon_neighborhood.eps_neighbors(
                           q, X, eps, res=res))
    pair_diff = int((adj != adj2).sum())
    deg_total = int(deg2.sum())
    row = {"phase": "graph", "rows": n, "k": k, "capacity": g.capacity,
           "mst_edges": n_edges, "mst_weight": total,
           "scipy_mst_weight": ref_total, "mst_rel_err": rel,
           "components": n - n_edges,
           "single_linkage_edges": link_edges, "labels": n_labels,
           "spectral_parts": parts, "eigenvalues": evals.tolist(),
           "residuals": resid, "ball_cover_landmarks": bc.n_landmarks,
           "ball_cover_max_list": int(bc.list_data.shape[1]),
           "ball_cover_vs_brute": verdict, "eps": eps,
           "eps_degree_total": deg_total,
           "eps_pairs_differing": pair_diff,
           "eps_degrees_equal": bool(torch.equal(deg, deg2)), **times}
    emit(row)
    if rel > 1e-5 or link_edges != n - 1 or n_labels != GRAPH_CLUSTERS \
            or not verdict["ok"] or pair_diff > 1e-3 * max(deg_total, 1) \
            or not all(math.isfinite(r) for r in resid):
        raise AssertionError(f"graph: {row}")
    del g, m, link, bc, adj, adj2, lap
    torch.cuda.empty_cache()


TAIL_SUB_ROWS = 100_000      # svd / qr / lstsq rows
TAIL_SPD = 4096              # the Lanczos matrix
TAIL_SIL_ROWS = 20_000       # silhouette rows
TAIL_TRUST_ROWS = 10_000     # trustworthiness rows
TAIL_GRAM = 10_000           # Gram kernels: 10,000 × 10,000 × 128
TAIL_MASKED_ROWS = 100_000   # masked_l2_nn rows, against the 1,024 centres
TAIL_GROUPS = 32
TAIL_ASSIGN = (1024, 512)    # linear assignment: integer, float costs
DEEP_TAIL_ROWS = 10_000_000  # deep_like_rows: 10M × 96 in 1M-row chunks
DEEP_TAIL_CHUNK = 1_000_000
DEEP_TAIL_PICKS = 10_000


def tail_timed(times, name, fn):
    """``fn()`` between two synchronisations; its seconds under ``name``."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t
    return out


def rel_err(got, want) -> float:
    """max |got − want| over max |want|, in float64 on the host."""
    import torch

    g = torch.as_tensor(got).double().cpu()
    w = torch.as_tensor(want).double().cpu()
    return float((g - w).abs().max() / max(float(w.abs().max()), 1e-300))


def tail_plan_phase(shared, index, pick, dev="cuda"):
    """K1 through the host planner: the held IVF-Flat index (uint8 lists)
    at the flat path's n_probes, 10,000 queries, the strip search
    (``strip_scan._scan_tiles``, K1 per class) run once with every query
    tile planned by ``strip_scan.host_plan`` (``plan_strips``, numpy) and
    once by the device plan (``plan_tile``): values and ids bit for bit,
    K1's launches = the host plan's classes summed over tiles, the
    planner's host milliseconds beside the device plan's, and K1 at the
    host plan's class inputs against its twin."""
    import numpy as np
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device=dev)
    qs = shared["queries"].to(torch.float32)
    n_probes = pick["n_probes"]
    probes = ivf_flat._coarse_probes(qs, index.centers, n_probes,
                                     index.metric)
    bias = ivf_flat._ragged_bias(index.list_ids, index.list_norms, "l2")
    lens = ivf_flat._lens_np(index)
    n_lists, dim = index.n_lists, index.dim
    classes, cls_ord_np = ss.class_info(lens, dim=dim)
    cls_ord = torch.as_tensor(cls_ord_np, device=dev)
    q, p = probes.shape
    q_tile = ss.fit_q_tile(q, p, n_lists, len(classes), K,
                           res.workspace_bytes, dim=dim)
    plans = {"host": lambda: ss.host_plan(probes, lens, n_lists, dim),
             "device": lambda: lambda start, qt: ss.plan_tile(
                 probes, start, qt, cls_ord, classes, n_lists)}
    k1 = ss._k1_class_fn(index.list_data, bias, -2.0, K, False)

    def search(planner):
        return ss._scan_tiles(qs, probes, index.list_ids, K, K, q_tile,
                              plans[planner](), k1)

    times, launches, out = {}, {}, {}
    for planner in ("host", "device"):
        search(planner)                          # warm
        reset_counts()
        out[planner] = tail_timed(times, f"search_{planner}_s",
                                  lambda: search(planner))
        launches[planner] = ss.STRIP_KERNEL.launches
    (hv, hi), (dv, di) = out["host"], out["device"]
    probes_np = probes.cpu().numpy()
    host_ms, device_ms, expected, calls = [], [], 0, []
    for start in range(0, q, q_tile):
        qt = min(q_tile, q - start)
        t = time.perf_counter()
        sp = ss.plan_strips(probes_np[start:start + qt], lens, n_lists, dim)
        host_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ss.plan_tile(probes, start, qt, cls_ord, classes, n_lists)
        torch.cuda.synchronize()
        device_ms.append((time.perf_counter() - t) * 1e3)
        expected += len(sp.class_layout)
        qids = torch.from_numpy(sp.qids).to(dev)
        strip_list = torch.from_numpy(sp.strip_list).to(dev)
        a = ss.group_queries(qs[start:start + qt], qids)
        rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
        for (wb, ns, st, cnt) in sp.class_layout:
            calls.append(dict(strip_list=strip_list[st:st + cnt].contiguous(),
                              a=a[st:st + cnt].contiguous(), w_blocks=wb,
                              n_sub=ns, kf=K, approx_ok=False,
                              strip_rows=rows[st:st + cnt],
                              list_data=index.list_data, bias=bias,
                              alpha=-2.0))
    worst = kernel_parity_at(calls, "strip_scan",
                             f"tail_plan_host_nprobe{n_probes}_kf{K}")
    same = bool(torch.equal(hv, dv) and torch.equal(hi, di))
    row = {"phase": "tail.plan", "n_probes": n_probes, "queries": q,
           "q_tile": q_tile, "tiles": -(-q // q_tile),
           "list_dtype": str(index.list_data.dtype).replace("torch.", ""),
           "bit_equal": same, "k1_launches": launches,
           "k1_launches_expected": expected,
           "planner_host_ms": host_ms, "planner_device_ms": device_ms,
           "k1_parity_classes": len(calls), "k1_max_abs_err": worst, **times}
    emit(row)
    if not same or launches["host"] != expected \
            or launches["device"] != expected:
        raise AssertionError(f"tail.plan: {row}")
    return launches, worst


def tail_linalg_phase(shared, keys, dev="cuda"):
    """The dense linear algebra at the path's sizes, each against a float64
    host run: keyed sums and counts over the 1M rows (1,024 keys from the
    IVF coarse assignment, 1% of them moved out of range, twice: the same
    bits), gemm (1M × 128)ᵀ(1M × 128), svd / qr / lstsq on 100,000 × 128
    (and a rank-deficient lstsq), rsvd(k=16) on the 1M rows against the
    host's exact top 16 and the Eckart–Young rebuild error, Lanczos on a
    4,096 × 4,096 SPD matrix against ``eigvalsh``'s 4 smallest."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops import linalg

    X = shared["dataset"].to(torch.float32)
    n = X.shape[0]
    x64 = shared["host"].astype(np.float64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    k_bad = keys.clone()
    out_of_range = torch.rand(n, generator=gen, device=dev) < 0.01
    k_bad[out_of_range] = torch.where(
        torch.rand(n, generator=gen, device=dev)[out_of_range] < 0.5,
        -1, KMEANS_CLUSTERS + 7).to(k_bad.dtype)
    times, errs = {}, {}
    sums = tail_timed(times, "reduce_rows_by_key_s", lambda: linalg.
                      reduce_rows_by_key(X, k_bad, KMEANS_CLUSTERS))
    again = linalg.reduce_rows_by_key(X, k_bad, KMEANS_CLUSTERS)
    kb = k_bad.cpu().numpy().astype(np.int64)
    ok = (kb >= 0) & (kb < KMEANS_CLUSTERS)
    ref = torch.zeros((KMEANS_CLUSTERS, 128), dtype=torch.float64)
    ref.index_add_(0, torch.from_numpy(kb[ok]), torch.from_numpy(x64[ok]))
    errs["reduce_rows_by_key"] = rel_err(sums, ref)
    counts = tail_timed(times, "bincount_s", lambda: linalg.bincount(
        k_bad, KMEANS_CLUSTERS))
    ref_counts = np.bincount(kb[ok], minlength=KMEANS_CLUSTERS)
    wsum = linalg.bincount(k_bad, KMEANS_CLUSTERS, weights=X[:, 0])
    errs["bincount_weighted"] = rel_err(wsum, np.bincount(
        kb[ok], weights=x64[ok, 0], minlength=KMEANS_CLUSTERS))
    gram = tail_timed(times, "gemm_s", lambda: linalg.gemm(
        X, X, transpose_a=True))
    g64 = x64.T @ x64
    errs["gemm"] = rel_err(gram, g64)

    sub = X[:TAIL_SUB_ROWS] - X[:TAIL_SUB_ROWS].mean(0)
    s64 = sub.double().cpu().numpy()
    u, s, vt = tail_timed(times, "svd_s", lambda: linalg.svd(sub))
    ref_s = np.linalg.svd(s64, compute_uv=False)
    errs["svd_s"] = rel_err(s, ref_s)
    errs["svd_rebuild"] = rel_err((u * s) @ vt, s64)
    qm, r = tail_timed(times, "qr_s", lambda: linalg.qr(sub))
    errs["qr_rebuild"] = rel_err(qm @ r, s64)
    errs["qr_orthonormal"] = float(
        (qm.T.double() @ qm.double() - torch.eye(128, dtype=torch.float64,
                                                 device=dev)).abs().max())
    errs["qr_upper"] = float(torch.tril(r, -1).abs().max())
    ref_r = np.linalg.qr(s64, mode="r")
    signs = np.sign(np.diag(ref_r)) * np.sign(np.diag(
        r.double().cpu().numpy()))
    errs["qr_r_vs_host"] = rel_err(r.double() * torch.as_tensor(
        signs, device=dev)[:, None], ref_r)
    b = sub[:, :8].sum(1) + torch.randn(TAIL_SUB_ROWS, generator=gen,
                                        device=dev)
    b64 = b.double().cpu().numpy()
    rc = np.finfo(np.float32).eps * TAIL_SUB_ROWS
    x_ls = tail_timed(times, "lstsq_s", lambda: linalg.lstsq(sub, b))
    errs["lstsq"] = rel_err(x_ls, np.linalg.lstsq(s64, b64, rcond=rc)[0])
    deficient = torch.cat([sub[:, :64], sub[:, :64]], dim=1)   # rank 64
    x_def = linalg.lstsq(deficient, b)
    ref_def = np.linalg.lstsq(np.concatenate([s64[:, :64]] * 2, 1), b64,
                              rcond=rc)[0]
    errs["lstsq_rank_deficient"] = rel_err(x_def, ref_def)
    errs["lstsq_split_equally"] = rel_err(x_def[:64], x_def[64:].double()
                                          .cpu().numpy())

    gen_r = torch.Generator(device=dev)
    gen_r.manual_seed(0)
    ru, rs, rvt = tail_timed(times, "rsvd_s", lambda: linalg.rsvd(
        X, 16, p=16, n_iter=8, generator=gen_r))
    ev = np.sqrt(np.maximum(np.linalg.eigvalsh(g64)[::-1], 0.0))
    errs["rsvd_s_rel"] = float(np.abs(rs.double().cpu().numpy() / ev[:16]
                                      - 1).max())
    resid = 0.0
    for s0 in range(0, n, 250_000):
        d = X[s0:s0 + 250_000].double() - (ru[s0:s0 + 250_000].double()
                                           * rs.double()) @ rvt.double()
        resid += float((d * d).sum())
    optimal = float((ev[16:] ** 2).sum())
    errs["rsvd_rebuild_vs_optimal"] = abs(resid / optimal - 1.0)

    q_, _ = torch.linalg.qr(torch.randn(TAIL_SPD, TAIL_SPD, generator=gen,
                                        device=dev, dtype=torch.float64))
    lam = torch.cat([torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64,
                                  device=dev),
                     torch.linspace(1.0, 10.0, TAIL_SPD - 4,
                                    dtype=torch.float64, device=dev)])
    spd64 = (q_ * lam) @ q_.T
    spd = spd64.to(torch.float32)
    w, _ = tail_timed(times, "lanczos_s", lambda: linalg.lanczos(
        spd, 4, max_iters=256))
    ref_w = np.linalg.eigvalsh(spd.double().cpu().numpy())[:4]
    errs["lanczos_vs_lam_max"] = float(np.abs(w.double().cpu().numpy()
                                              - ref_w).max() / 10.0)
    bits_equal = bool(torch.equal(sums, again))
    row = {"phase": "tail.linalg", "rows": n, "keys": KMEANS_CLUSTERS,
           "keys_out_of_range": int(out_of_range.sum()),
           "keyed_sum_same_bits": bits_equal,
           "bincount_exact": bool(np.array_equal(counts.cpu().numpy()
                                                 .astype(np.int64),
                                                 ref_counts)),
           "errors": errs, "rsvd_singular_values": rs.tolist(),
           "exact_singular_values": ev[:16].tolist(),
           "lanczos": w.tolist(), "eigvalsh": ref_w.tolist(), **times}
    emit(row)
    # fp32 factorizations: backward errors of O(n·eps) at n = 128
    bounds = {"reduce_rows_by_key": 1e-6, "bincount_weighted": 1e-6,
              "gemm": 1e-5, "svd_s": 1e-5, "svd_rebuild": 1e-4,
              "qr_rebuild": 1e-5, "qr_orthonormal": 1e-5, "qr_upper": 0.0,
              "qr_r_vs_host": 1e-4, "lstsq": 1e-3,
              "lstsq_rank_deficient": 1e-3, "lstsq_split_equally": 1e-5,
              "rsvd_s_rel": 1e-3, "rsvd_rebuild_vs_optimal": 1e-3,
              "lanczos_vs_lam_max": 1e-4}
    bad = {k_: v for k_, v in errs.items() if not v <= bounds[k_]}
    if bad or not bits_equal or not row["bincount_exact"]:
        raise AssertionError(f"tail.linalg out of bounds {bad}: {row}")


def _host_cluster_metrics(c):
    """RI, ARI, MI, homogeneity, completeness and V from an int64
    contingency matrix, in float64 (sklearn's definitions)."""
    import numpy as np

    c = c.astype(np.float64)
    n = c.sum()
    rows, cols = c.sum(1), c.sum(0)

    def comb2(v):
        return v * (v - 1) / 2

    sum_comb, sa, sb = comb2(c).sum(), comb2(rows).sum(), comb2(cols).sum()
    expected = sa * sb / comb2(n)
    ari = (sum_comb - expected) / ((sa + sb) / 2 - expected)
    ri = (comb2(n) + 2 * sum_comb - sa - sb) / comb2(n)
    pij = c / n
    nz = pij > 0
    pi, pj = rows / n, cols / n
    mi = float((pij[nz] * np.log(pij[nz] / np.outer(pi, pj)[nz])).sum())

    def ent(p):
        p = p[p > 0]
        return float(-(p * np.log(p)).sum())

    h_c, h_k = ent(pi), ent(pj)
    hom = mi / h_c if h_c else 1.0
    com = mi / h_k if h_k else 1.0
    v = 2 * hom * com / (hom + com) if hom + com else 0.0
    return {"rand_index": ri, "adjusted_rand_index": ari,
            "mutual_info_score": mi, "homogeneity_score": hom,
            "completeness_score": com, "v_measure": v}


def _host_silhouette(x64, lab, k):
    """Mean silhouette (squared euclidean) in float64 on the host (torch
    on the CPU): distance tiles by one product each, per-cluster sums by
    ``index_add_`` along the columns."""
    import torch

    x = torch.from_numpy(x64)
    lab_t = torch.from_numpy(lab).to(torch.int64)
    n = x.shape[0]
    counts = torch.bincount(lab_t, minlength=k).to(torch.float64)
    sq = (x * x).sum(1)
    out = []
    for s0 in range(0, n, 2000):
        d = torch.clamp(sq[s0:s0 + 2000, None] + sq[None, :]
                        - 2 * x[s0:s0 + 2000] @ x.T, min=0.0)
        csum = torch.zeros((d.shape[0], k), dtype=torch.float64)
        csum.index_add_(1, lab_t, d)
        lb = lab_t[s0:s0 + 2000]
        rows = torch.arange(d.shape[0])
        own = counts[lb]
        a = csum[rows, lb] / torch.clamp(own - 1, min=1)
        other = torch.where(counts[None, :] > 0, csum / torch.clamp(
            counts, min=1), float("inf"))
        other[rows, lb] = float("inf")
        b = other.min(1).values
        out.append(torch.where(own > 1, (b - a) / torch.clamp(
            torch.maximum(a, b), min=1e-30), torch.zeros_like(a)))
    return float(torch.cat(out).mean())


def _host_trustworthiness(x64, e64, k):
    """Trustworthiness in float64 on the host (torch on the CPU): each
    row's k nearest in the embedding and their ranks in the original
    space, both by stable sorts (the lower index first at ties), self
    excluded."""
    import torch

    x, e = torch.from_numpy(x64), torch.from_numpy(e64)
    n = x.shape[0]
    sx, se = (x * x).sum(1), (e * e).sum(1)
    cols = torch.arange(n)
    penalty = 0
    for s0 in range(0, n, 500):
        rows = torch.arange(s0, min(s0 + 500, n))
        r = torch.arange(len(rows))
        d = sx[rows, None] + sx[None, :] - 2 * x[rows] @ x.T
        de = se[rows, None] + se[None, :] - 2 * e[rows] @ e.T
        d[r, rows] = float("inf")
        de[r, rows] = float("inf")
        knn = torch.argsort(de, dim=1, stable=True)[:, :k]
        order = torch.argsort(d, dim=1, stable=True)
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, cols.expand(len(rows), n))
        penalty += int(torch.clamp(torch.gather(ranks, 1, knn) - k + 1,
                                   min=0).sum())
    return 1.0 - penalty * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def tail_stats_phase(shared, centers, coarse, dev="cuda"):
    """The metrics at the path's sizes against float64 host runs: the
    contingency matrix of two 1M labellings (the labels of the ``kmeans``
    path's fit, ``kmeans.fit`` with 1,024 clusters, and the IVF coarse
    assignment) equal to numpy's int64 one, the six comparison
    metrics from it; silhouette on 20,000 rows over the fit's 1,024
    clusters; trustworthiness on 10,000 rows of the 2-component
    ``eig_dc`` projection at k 10; the summary statistics of the 1M rows."""
    import numpy as np
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.ops import linalg
    from raft_tpu_torch.ops.distance import fused_l2_nn_argmin
    from raft_tpu_torch.stats import metrics, summary

    res = Resources(device=dev)
    X = shared["dataset"].to(torch.float32)
    n = X.shape[0]
    x_host = shared["host"]
    times, errs = {}, {}
    fit = tail_timed(times, "kmeans_fit_s", lambda: kmeans.fit(
        X, kmeans.KMeansParams(n_clusters=KMEANS_CLUSTERS), res=res))
    km = fused_l2_nn_argmin(X, fit.centroids)[1]
    cm = tail_timed(times, "contingency_s", lambda: metrics.
                    contingency_matrix(km, coarse))
    a_np, b_np = km.cpu().numpy(), coarse.cpu().numpy().astype(np.int64)
    nt, np_ = int(a_np.max()) + 1, int(b_np.max()) + 1
    ref_cm = np.bincount(a_np * np_ + b_np, minlength=nt * np_).reshape(
        nt, np_)
    cm_equal = bool(np.array_equal(cm.cpu().numpy().astype(np.int64), ref_cm))
    ref = _host_cluster_metrics(ref_cm)
    got = {}
    for name in ref:
        got[name] = float(tail_timed(times, f"{name}_s", lambda name=name:
                                     getattr(metrics, name)(km, coarse)))
        errs[name] = abs(got[name] - ref[name]) / max(abs(ref[name]), 1e-30)

    lab = km[:TAIL_SIL_ROWS]
    sil = float(tail_timed(times, "silhouette_s", lambda: metrics.
                           silhouette_score(X[:TAIL_SIL_ROWS], lab,
                                            KMEANS_CLUSTERS)))
    ref_sil = _host_silhouette(x_host[:TAIL_SIL_ROWS].astype(np.float64),
                               lab.cpu().numpy(), KMEANS_CLUSTERS)
    errs["silhouette"] = abs(sil - ref_sil) / abs(ref_sil)

    xt = X[:TAIL_TRUST_ROWS]
    xc = xt - xt.mean(0)
    _, vecs = linalg.eig_dc(summary.cov(xc))
    emb = xc @ vecs[:, -2:]                         # the 2 largest
    tw = float(tail_timed(times, "trustworthiness_s", lambda: metrics.
                          trustworthiness_score(xt, emb, 10)))
    ref_tw = _host_trustworthiness(x_host[:TAIL_TRUST_ROWS].astype(
        np.float64), emb.double().cpu().numpy(), 10)
    errs["trustworthiness_abs"] = abs(tw - ref_tw)

    x64 = x_host.astype(np.float64)
    mean = tail_timed(times, "mean_s", lambda: summary.mean(X))
    errs["mean"] = rel_err(mean, x64.mean(0))
    errs["sum_"] = rel_err(summary.sum_(X), x64.sum(0))
    var = tail_timed(times, "vars_s", lambda: summary.vars_(X))
    errs["vars_"] = rel_err(var, x64.var(0, ddof=1))
    errs["stddev"] = rel_err(summary.stddev(X, sample=False),
                             x64.std(0))
    mu, mv = summary.meanvar(X)
    errs["meanvar"] = max(rel_err(mu, x64.mean(0)),
                          rel_err(mv, x64.var(0, ddof=1)))
    errs["mean_center"] = rel_err(summary.mean_center(X[:1000], device=dev),
                                  x64[:1000] - x64[:1000].mean(0))
    lo, hi = summary.minmax(X)
    hist = tail_timed(times, "histogram_s", lambda: summary.histogram(
        X, 16, 0.0, 256.0))
    ref_hist = np.stack([np.bincount(np.minimum(x_host[:, j] // 16, 15),
                                     minlength=16) for j in range(128)], 1)
    w = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    w64 = w.double().cpu().numpy()
    errs["weighted_mean"] = rel_err(summary.weighted_mean(X, w),
                                    w64 @ x64 / w64.sum())
    sizes = torch.bincount(coarse.long(), minlength=KMEANS_CLUSTERS)
    disp = summary.dispersion(centers, sizes)
    c64 = centers.double().cpu().numpy()
    s64 = sizes.cpu().numpy().astype(np.float64)
    mu_c = (c64 * s64[:, None]).sum(0) / s64.sum()
    errs["dispersion"] = rel_err(disp, np.sqrt(
        (((c64 - mu_c) ** 2).sum(1) * s64).sum()))
    ent = summary.entropy(km, KMEANS_CLUSTERS)
    p_ = np.bincount(a_np, minlength=KMEANS_CLUSTERS) / n
    errs["entropy"] = rel_err(ent, -(p_[p_ > 0] * np.log(p_[p_ > 0])).sum())
    q_ = np.bincount(b_np, minlength=KMEANS_CLUSTERS) / n
    kl = summary.kl_divergence(torch.as_tensor(p_, device=dev),
                               torch.as_tensor(q_, device=dev))
    keep = p_ > 0
    errs["kl_divergence"] = rel_err(kl, (p_[keep] * np.log(
        p_[keep] / q_[keep])).sum())
    row = {"phase": "tail.stats", "rows": n, "kmeans_n_iter": fit.n_iter,
           "contingency_shape": list(cm.shape),
           "contingency_equal": cm_equal, "metrics": got,
           "host_metrics": ref, "silhouette": sil, "host_silhouette": ref_sil,
           "trustworthiness": tw, "host_trustworthiness": ref_tw,
           "minmax_exact": bool(np.array_equal(lo.cpu().numpy(),
                                               x_host.min(0))
                                and np.array_equal(hi.cpu().numpy(),
                                                   x_host.max(0))),
           "histogram_exact": bool(np.array_equal(hist.cpu().numpy(),
                                                  ref_hist)),
           "errors": errs, **times}
    emit(row)
    bounds = {name: 1e-5 for name in ref}
    bounds.update(silhouette=1e-4, trustworthiness_abs=1e-3, mean=1e-6,
                  sum_=1e-6, vars_=1e-5, stddev=1e-5, meanvar=1e-5,
                  mean_center=1e-6, weighted_mean=1e-5, dispersion=1e-5,
                  entropy=1e-5, kl_divergence=1e-5)
    bad = {k_: v for k_, v in errs.items() if not v <= bounds[k_]}
    if bad or not (cm_equal and row["minmax_exact"]
                   and row["histogram_exact"]):
        raise AssertionError(f"tail.stats out of bounds {bad}: {row}")
    return km


def tail_kernels_phase(shared, centers, dev="cuda"):
    """The Gram kernels on 10,000 × 10,000 × 128 (the first 10,000 rows
    against the next 10,000) and ``masked_l2_nn`` for 100,000 rows against
    the 1,024 IVF centres in 32 groups (half the groups admitted a row,
    16 rows admitting none), each against float64 on the host."""
    import numpy as np
    import torch

    from raft_tpu_torch.ops import kernels

    X = shared["dataset"].to(torch.float32)
    xh = torch.from_numpy(shared["host"]).double()
    x, y = X[:TAIL_GRAM], X[TAIL_GRAM:2 * TAIL_GRAM]
    x64, y64 = xh[:TAIL_GRAM], xh[TAIL_GRAM:2 * TAIL_GRAM]
    lin64 = x64 @ y64.T
    d64 = torch.clamp((x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None, :]
                      - 2 * lin64, min=0.0)
    cases = {
        "linear_kernel": ({}, lin64),
        "polynomial_kernel": ({"degree": 3, "gain": 1e-6, "offset": 1.0},
                              (1e-6 * lin64 + 1.0) ** 3),
        "tanh_kernel": ({"gain": 1e-6, "offset": -1.0},
                        torch.tanh(1e-6 * lin64 - 1.0)),
        "rbf_kernel": ({"gain": 1e-6}, torch.exp(-1e-6 * d64)),
    }
    errs, ms = {}, {}
    for name, (kw, want) in cases.items():
        fn = getattr(kernels, name)
        got = fn(x, y, **kw)
        errs[name] = rel_err(got, want)
        ms[name] = cuda_ms(lambda fn=fn, kw=kw: fn(x, y, **kw), reps=3)
        del got
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    xm = X[:TAIL_MASKED_ROWS]
    groups = torch.arange(KMEANS_CLUSTERS, device=dev) % TAIL_GROUPS
    adj = torch.rand(TAIL_MASKED_ROWS, TAIL_GROUPS, generator=gen,
                     device=dev) < 0.5
    adj[:16] = False
    mins, args = kernels.masked_l2_nn(xm, centers, adj, groups)
    ms["masked_l2_nn"] = cuda_ms(lambda: kernels.masked_l2_nn(
        xm, centers, adj, groups), reps=3)
    c64 = centers.double().cpu()
    xm64 = xh[:TAIL_MASKED_ROWS]
    dm = torch.clamp((xm64 ** 2).sum(1)[:, None] + (c64 ** 2).sum(1)[None, :]
                     - 2 * xm64 @ c64.T, min=0.0)
    dm = torch.where(adj.cpu()[:, groups.cpu()], dm, float("inf")).numpy()
    ref_min = dm.min(1)
    ref_arg = np.where(np.isfinite(ref_min), dm.argmin(1), -1)
    got_min = mins.double().cpu().numpy()
    got_arg = args.cpu().numpy()
    fin = np.isfinite(ref_min)
    errs["masked_l2_nn_min"] = float(np.abs(got_min[fin] - ref_min[fin]).max()
                                     / ref_min[fin].max())
    differ = got_arg != ref_arg
    # a different argmin only at a near-tie: its own distance within the
    # value tolerance of the best (rows admitting nothing compare as -1)
    alt = dm[np.arange(len(got_arg)), np.clip(got_arg, 0, None)]
    gap = np.where(fin, alt - np.where(fin, ref_min, 0.0), 0.0)
    near_tie = gap <= 1e-5 * ref_min[fin].max()
    row = {"phase": "tail.kernels", "gram": [TAIL_GRAM, TAIL_GRAM, 128],
           "masked_rows": TAIL_MASKED_ROWS, "groups": TAIL_GROUPS,
           "none_admitted": int((~fin).sum()),
           "argmin_differs": int(differ.sum()),
           "argmin_differs_unexplained": int((differ & ~near_tie).sum()),
           "errors": errs, "ms": ms}
    emit(row)
    bounds = {"linear_kernel": 1e-6, "polynomial_kernel": 1e-5,
              "tanh_kernel": 1e-5, "rbf_kernel": 1e-5,
              "masked_l2_nn_min": 1e-5}
    bad = {k_: v for k_, v in errs.items() if not v <= bounds[k_]}
    if bad or row["argmin_differs_unexplained"] \
            or not np.array_equal(got_arg[~fin], ref_arg[~fin]) \
            or row["none_admitted"] != 16:
        raise AssertionError(f"tail.kernels out of bounds {bad}: {row}")


def tail_solver_phase(dev="cuda"):
    """``linear_assignment`` on 1,024 × 1,024 integer costs in [0, 1000)
    (the total equal to scipy's) and on 512 × 512 float costs (within
    n·ε_final of scipy's): seconds and auction rounds."""
    import importlib

    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from raft_tpu_torch.solver import linear_assignment

    la = importlib.import_module("raft_tpu_torch.solver.linear_assignment")
    rng = np.random.default_rng(17)
    out = {}
    for n, kind in zip(TAIL_ASSIGN, ("int", "float")):
        c = (rng.integers(0, 1000, (n, n)) if kind == "int"
             else rng.standard_normal((n, n))).astype(np.float32)
        times = {}
        r2c, total = tail_timed(times, "s", lambda: linear_assignment(c))
        stats = dict(la.LAST_RUN)
        t = time.perf_counter()
        ri, ci = linear_sum_assignment(c)
        scipy_s = time.perf_counter() - t
        want = float(c[ri, ci].astype(np.float64).sum())
        perm = sorted(r2c.cpu().tolist()) == list(range(n))
        rng_c = float(c.max() - c.min())
        eps_final = min(rng_c / (2.0 * n * (n + 1)), 1.0 / (2.0 * (n + 1)))
        got = float(c[np.arange(n), r2c.cpu().numpy()].astype(np.float64)
                    .sum())
        ok = perm and (got == want if kind == "int"
                       else got <= want + n * eps_final + 1e-6 * abs(want))
        out[kind] = {"n": n, "total": got, "scipy_total": want,
                     "eps_final": eps_final, "seconds": times["s"],
                     "scipy_s": scipy_s, **stats, "ok": ok}
    emit({"phase": "tail.solver", **out})
    if not all(v["ok"] for v in out.values()):
        raise AssertionError(f"tail.solver: {out}")


def tail_merge_phase(shared, dev="cuda"):
    """Brute force over each half of the 1M rows, the two top-10 lists
    merged by ``merge_topk``: the whole search's values, and its ids apart
    from near-ties."""
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.select_k import merge_topk
    from raft_tpu_torch.stats.metrics import topk_agreement

    res = Resources(device=dev)
    X, qs = shared["dataset"], shared["queries"]
    gt_v, gt_i = shared["gt"]
    half = X.shape[0] // 2
    times = {}
    va, ia = tail_timed(times, "half_a_s", lambda: brute_force.search(
        brute_force.build(X[:half], res=res), qs, K, res=res))
    vb, ib = tail_timed(times, "half_b_s", lambda: brute_force.search(
        brute_force.build(X[half:], res=res), qs, K, res=res))
    ib = torch.where(ib >= 0, ib + half, ib)
    mv, mi = tail_timed(times, "merge_s", lambda: merge_topk(va, ia, vb, ib))
    scale = float((X[:1000].float() ** 2).sum(1).max())
    verdict = topk_agreement(gt_v, gt_i, mv, mi, rtol=1e-5,
                             atol=1e-6 * scale, tie_rtol=1e-5)
    emit({"phase": "tail.merge", "queries": qs.shape[0], "k": K,
          "values_equal": bool(torch.equal(mv, gt_v)), "agreement": verdict,
          **times})
    if not verdict["ok"]:
        raise AssertionError(f"tail.merge: {verdict}")


def tail_datasets_phase(dev="cuda"):
    """``deep_like_rows`` for 10M × 96 rows in 1M-row chunks (rows/s):
    unit norms, and 10,000 random row ids regenerated alone bit-identical
    to their rows in the chunks."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.datasets import deep_like_rows

    rng = np.random.default_rng(96)
    picks = np.sort(rng.choice(DEEP_TAIL_ROWS, DEEP_TAIL_PICKS,
                               replace=False))
    picks_t = torch.as_tensor(picks, device=dev)
    kept, worst, gen_s = [], 0.0, 0.0
    for s0 in range(0, DEEP_TAIL_ROWS, DEEP_TAIL_CHUNK):
        ids = torch.arange(s0, s0 + DEEP_TAIL_CHUNK, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows = deep_like_rows(ids)
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - t
        norms = torch.linalg.vector_norm(rows.double(), dim=1)
        worst = max(worst, float((norms - 1.0).abs().max()))
        inside = picks_t[(picks_t >= s0) & (picks_t < s0 + DEEP_TAIL_CHUNK)]
        kept.append(rows[inside - s0])
        del rows, norms
    alone = torch.cat([deep_like_rows(picks_t[j:j + 1])
                       for j in range(0, 100)])
    batch = deep_like_rows(picks_t)
    kept = torch.cat(kept)
    same = bool(torch.equal(batch, kept) and torch.equal(alone, kept[:100]))
    row = {"phase": "tail.datasets", "rows": DEEP_TAIL_ROWS, "dim": 96,
           "chunk": DEEP_TAIL_CHUNK, "generate_s": gen_s,
           "rows_per_s": DEEP_TAIL_ROWS / gen_s, "max_norm_err": worst,
           "picked": DEEP_TAIL_PICKS, "picked_bit_equal": same}
    emit(row)
    if worst > 1e-6 or not same:
        raise AssertionError(f"tail.datasets: {row}")


def tail_resources_phase():
    """``get_resources()`` from 16 threads: one pooled instance, on the
    card."""
    import threading

    import torch

    from raft_tpu_torch.core import resources_manager

    resources_manager.clear_pool()
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        resources_manager.get_resources())) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    one = len(got) == 16 and all(r is got[0] for r in got)
    row = {"phase": "tail.resources", "threads": 16, "one_instance": one,
           "device": str(got[0].device)}
    emit(row)
    if not one or got[0].device != torch.device("cuda", 0):
        raise AssertionError(f"tail.resources: {row}")


def tail_phase(shared, index, pick, dev="cuda"):
    """The parity tail on the card, one line a sub-phase: ``tail.plan``
    (K1 through the host planner) then the linear algebra, metrics, Gram
    kernels, solver, merge, dataset and pool sub-phases, in a
    ``use_resources`` scope of ``dev``. Returns K1's launches and worst
    twin error from ``tail.plan``."""
    import torch

    from raft_tpu_torch import Resources, use_resources
    from raft_tpu_torch.ops.distance import fused_l2_nn_argmin

    t = time.perf_counter()
    launches, worst = tail_plan_phase(shared, index, pick, dev)
    emit({"phase": "tail.plan.done", "seconds": time.perf_counter() - t})
    centers = index.centers
    X = shared["dataset"].to(torch.float32)
    coarse = fused_l2_nn_argmin(X, centers)[1]       # the IVF assignment
    del X
    with use_resources(Resources(device=dev)):
        tail_subphases(shared, centers, coarse, dev)
    return launches, worst


def tail_subphases(shared, centers, coarse, dev):
    """The sub-phases after ``tail.plan``, each followed by its seconds."""
    import torch

    for name, run in (
            ("linalg", lambda: tail_linalg_phase(shared, coarse, dev)),
            ("stats", lambda: tail_stats_phase(shared, centers, coarse, dev)),
            ("kernels", lambda: tail_kernels_phase(shared, centers, dev)),
            ("solver", lambda: tail_solver_phase(dev)),
            ("merge", lambda: tail_merge_phase(shared, dev)),
            ("datasets", lambda: tail_datasets_phase(dev)),
            ("resources", tail_resources_phase)):
        t = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        emit({"phase": f"tail.{name}.done",
              "seconds": time.perf_counter() - t})


# the child of the analysis phase: the gate's command as ``python -m`` runs
# it, with CUDA's lazy init made to raise, reporting at exit whether CUDA
# was initialised and which JAX modules were loaded
ANALYSIS_CHILD = """
import atexit, json, runpy, sys, torch
def boom(*a, **k):
    raise AssertionError("CUDA initialised")
torch.cuda._lazy_init = boom
def report():
    print(json.dumps({"cuda": torch.cuda.is_initialized(),
                      "jax": sorted(m for m in sys.modules if m == "jax"
                                    or m.startswith(("jax.", "raft_tpu."))
                                    or m == "raft_tpu")}), file=sys.stderr)
atexit.register(report)
sys.argv = ["raft_tpu_torch.analysis", *sys.argv[1:]]
runpy.run_module("raft_tpu_torch.analysis", run_name="__main__",
                 alter_sys=True)
"""


def analysis_phase():
    """The port's graftlint gate in a child process (module docstring)."""
    from pathlib import Path

    from raft_tpu_torch.analysis.baseline import DEFAULT_PATH, Baseline
    from raft_tpu_torch.analysis.write_baseline import scan_paths

    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", ANALYSIS_CHILD, "--json", *scan_paths(root)],
        cwd=root, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t
    if out.returncode != 0:
        raise AssertionError(f"graftlint exit {out.returncode}:\n"
                             f"{out.stdout[-4000:]}{out.stderr[-4000:]}")
    report = json.loads(out.stdout)
    child = json.loads(out.stderr.strip().splitlines()[-1])
    entries = Baseline.load(DEFAULT_PATH).entries
    emit({"phase": "analysis", "rc": out.returncode,
          "findings": report["new"] + report["baselined"],
          "new": report["new"], "baselined": report["baselined"],
          "baseline_entries": len(entries),
          "baseline_count": sum(e["count"] for e in entries),
          "seconds": seconds, "cuda_in_child": child["cuda"],
          "jax_in_child": child["jax"]})
    if report["new"] or child["cuda"] or child["jax"]:
        raise AssertionError(f"analysis: {report['new']} new findings, "
                             f"child {child}")
    if seconds >= ANALYSIS_BUDGET_S:
        raise AssertionError(f"analysis took {seconds:.1f} s "
                             f"(budget {ANALYSIS_BUDGET_S} s)")


def statement_lines(path, line):
    """The first and last line of the innermost statement of ``path`` that
    holds ``line`` (a warning names the line Python is executing, which in
    a statement spread over lines need not be its first)."""
    import ast

    spans = [(node.end_lineno - node.lineno, node.lineno, node.end_lineno)
             for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.stmt)
             and node.lineno <= line <= node.end_lineno]
    return min(spans)[1:] if spans else (line, line)


def analysis_syncs_phase(shared, index, pick, dev="cuda"):
    """The syncs of one warm ragged IVF-PQ search as the card reports them,
    held against the sync rules (module docstring)."""
    import collections
    import warnings
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.analysis import analyze_paths
    from raft_tpu_torch.analysis.baseline import DEFAULT_PATH, Baseline
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device=dev)
    qs = shared["queries"]

    def run():
        return ivf_pq.search(index, qs, pick["k_fetch"],
                             n_probes=pick["n_probes"], backend="ragged",
                             res=res)

    run()
    torch.cuda.synchronize()
    reset_counts()
    run()
    torch.cuda.synchronize()
    plain_launches = ss.STRIP_KERNEL.launches
    reset_counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = ss.STRIP_KERNEL.launches

    root = Path(__file__).resolve().parent
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    sites, outside = collections.Counter(), collections.Counter()
    for w in syncs:
        path = Path(w.filename).resolve()
        if root / "raft_tpu_torch" in path.parents:
            sites[(path.relative_to(root).as_posix(), w.lineno)] += 1
        else:
            outside[f"{w.filename}:{w.lineno}"] += 1
    findings = [f for f in analyze_paths(["raft_tpu_torch"], root=root)
                if f.rule in SYNC_RULES]
    justified = {(e["path"], e["snippet"]) for e in
                 Baseline.load(DEFAULT_PATH).entries
                 if e["rule"] in SYNC_RULES and e.get("justification")}
    rows, unreported = [], []
    for (rel, line), count in sorted(sites.items()):
        first, last = statement_lines(root / rel, line)
        rules = sorted({f.rule for f in findings
                        if f.path == rel and first <= f.line <= last})
        baselined = any((rel, f.snippet) in justified for f in findings
                        if f.path == rel and first <= f.line <= last)
        rows.append({"site": f"{rel}:{line}", "count": count,
                     "reported_by": rules, "baselined": baselined})
        if count > 1 and not rules:
            unreported.append(f"{rel}:{line}")
    emit({"phase": "analysis.syncs", "n_probes": pick["n_probes"],
          "k_fetch": pick["k_fetch"], "queries": qs.shape[0],
          "syncs_per_search": len(syncs), "sites": rows,
          "outside_package": dict(outside),
          "repeated_unreported": unreported, "k1_launches": launches,
          "k1_launches_without_debug_mode": plain_launches,
          "other_warnings": len(caught) - len(syncs)})
    if launches != plain_launches or launches <= 0:
        raise AssertionError(f"K1 launched {launches} times under the sync "
                             f"debug mode, {plain_launches} without it")
    if unreported:
        raise AssertionError(f"per-search sync sites no rule reports: "
                             f"{unreported}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel parity phases")
    ap.add_argument("--ab", metavar="OLD_TREE",
                    help="after the paths up to the LUT path, time K1-K4 "
                         "and K6 of an older checkout against this tree's "
                         "at the paths' inputs and the two trees' LUT (K5) "
                         "and fused CAGRA searches, then stop")
    ap.add_argument("--k1-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K1 built from these kernel source trees "
                         "against each other at the paths' K1 shapes, then "
                         "stop")
    ap.add_argument("--k2-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K2 and K4 built from these kernel source "
                         "trees against each other at the IVF-BQ and bq "
                         "serving paths' shapes, then stop")
    ap.add_argument("--k3-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K3 built from these kernel source trees "
                         "against each other at the two serving paths' "
                         "shapes (flat uint8 kf 10, PQ int8 cache kf 20), "
                         "then stop")
    ap.add_argument("--k6-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K6 built from these kernel source trees "
                         "against each other at synthetic hops of the "
                         "bench's fused rungs, then stop")
    ap.add_argument("--search-child", nargs=7, help=argparse.SUPPRESS)
    ap.add_argument("--cagra-child", nargs=6, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.search_child:
        return search_child(*args.search_child)
    if args.cagra_child:
        return cagra_child(*args.cagra_child)
    if args.k1_variants:
        return strip_variants("k1", args.k1_variants)
    if args.k2_variants:
        return strip_variants("k2", args.k2_variants)
    if args.k3_variants:
        return strip_variants("k3", args.k3_variants)
    if args.k6_variants:
        return hop_variants(args.k6_variants)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from raft_tpu_torch.ops import _native

    card = nvidia_smi_card()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    health_phase()

    t = time.perf_counter()
    built = _native.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "nvcc_s": built,
          "sources": [src.name for src in _native.sources()]})
    emit({"phase": "ptxas", "usage": {
        src.name: _native.resource_usage(src) for src in _native.sources()}})

    empty = {"launches": 0, "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    k1 = {"name": "strip_scan", "route": "cuda", "source": K1_SOURCE,
          "replaces": K1_REPLACES, "parity": "ok", **empty,
          "max_abs_err": parity_phase("strip_scan", PARITY_CASES, 1000)}
    k2 = {"name": "bq_scan", "route": "cuda", "source": K2_SOURCE,
          "replaces": K2_REPLACES, "parity": "ok", **empty,
          "max_abs_err": parity_phase("bq_scan", K2_PARITY_CASES, 2000)}
    k3 = {"name": "paged_scan", "route": "cuda", "source": K3_SOURCE,
          "replaces": K3_REPLACES, "parity": "ok", **empty,
          "max_abs_err": paged_parity_phase("paged_scan", K3_PARITY_CASES,
                                            3000)}
    k4 = {"name": "paged_bq_scan", "route": "cuda", "source": K4_SOURCE,
          "replaces": K4_REPLACES, "parity": "ok", **empty,
          "max_abs_err": paged_parity_phase("paged_bq_scan", K4_PARITY_CASES,
                                            4000)}
    k5 = {"name": "pq_scan", "route": "cuda", "source": K5_SOURCE,
          "replaces": K5_REPLACES, "parity": "ok", **empty,
          "max_abs_err": scan_parity_phase()}
    k6 = {"name": "cagra_hop", "route": "cuda", "source": K6_SOURCE,
          "replaces": K6_REPLACES, "parity": "ok", **empty,
          "max_abs_err": hop_parity_phase()}
    if args.ab:
        from pathlib import Path

        global AB_INPUTS, AB_FILES
        AB_INPUTS = {}
        AB_FILES = Path(args.ab).resolve() / "ab_files"
    if not args.skip_main:
        t = time.perf_counter()
        shared = shared_data()
        emit({"phase": "data", "seconds": time.perf_counter() - t})
        held = HELD

        def fold(entry, result):
            worst = entry["max_abs_err"]
            entry.update(result)
            entry["max_abs_err"] = max(worst, entry["max_abs_err"])

        def ivf_pq():
            result, held["main"] = main_phase(shared)
            fold(k1, result)

        def ivf_bq():
            result, held["bq"] = bq_phase(shared)
            fold(k2, result)

        def bq_streaming():
            bq_streaming_phase(shared, held["bq"][1])

        def ivf_flat():
            held["flat"] = flat_phase(shared)
            held["tail.flat"] = held["flat"][:2]    # for tail.plan

        def serve():
            fold(k3, serve_phase(shared, *held.pop("flat")))

        def serve_queue():
            serve_queue_phase(shared, *held["serve.flat"])

        def tuning():
            k3["launches_tuning"] = tuning_phase(shared, *held["serve.flat"])

        def bench_runner():
            launches = runner_phase(shared)
            k1["launches_runner"] = {
                name: row["K1"] for name, row in launches.items()
                if row["K1"]}
            k6["launches_runner"] = launches["cagra.search"]["K6"]

        def serve_pq():
            serve_codes_phase(shared, "pq", *held["main"])

        def roofline():
            roofline_phase(shared, *held.pop("serve.flat"), *held["main"])

        def analysis_syncs():
            k1["launches_analysis_syncs"] = analysis_syncs_phase(
                shared, *held["main"])

        def serve_maint():
            serve_maint_phase(shared, *held.pop("main"))

        def serve_bq():
            fold(k4, serve_codes_phase(shared, "bq", *held.pop("bq")))

        def lut():
            fold(k5, lut_phase(shared))

        def cache():
            cache_phase(shared)

        def brute():
            brute_metrics_phase(shared)

        def cagra():       # its index holds 4.2 GB of codes
            result, k1_err = cagra_phase(shared)
            fold(k6, result)
            k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)

        dist_launches = {}

        def dist_ivf(kind):
            def run():
                launches, pq = dist_ivf_phase(shared, kind)
                dist_launches[f"dist.{kind}"] = launches
                if pq is not None:
                    held["dist.pq"] = pq
            return run

        def dist_cagra():
            dist_launches["dist.cagra"] = dist_cagra_phase(shared)

        def hybrid_path():
            k2_result, k4_result = hybrid_phase(shared)
            fold(k2, k2_result)
            fold(k4, k4_result)

        def deep10m():
            fold(k1, deep10m_phase())

        def tail():
            launches, worst = tail_phase(shared, *held.pop("tail.flat"))
            k1["launches_tail_plan"] = launches
            k1["max_abs_err"] = max(k1["max_abs_err"], worst)

        for name, path in (("analysis", analysis_phase),
                           ("kmeans", lambda: kmeans_phase(shared)),
                           ("main", ivf_pq), ("bq", ivf_bq),
                           ("bq.streaming", bq_streaming),
                           ("flat", ivf_flat), ("serve", serve),
                           ("serve.queue", serve_queue),
                           ("tuning", tuning),
                           ("serve.pq", serve_pq), ("obs.roofline", roofline),
                           ("analysis.syncs", analysis_syncs),
                           ("serve.maint", serve_maint),
                           ("serve.bq", serve_bq),
                           ("lut", lut), ("cache", cache), ("brute", brute),
                           ("capacity", capacity_phase),
                           ("cagra", cagra), ("bench.runner", bench_runner),
                           ("obs.cost", obs_cost_phase),
                           ("obs", obs_phase),
                           ("faults", lambda: faults_phase(shared)),
                           ("dist.kmeans", lambda: dist_kmeans_phase(shared)),
                           ("dist.brute_force",
                            lambda: dist_brute_phase(shared)),
                           ("dist.ivf_flat", dist_ivf("ivf_flat")),
                           ("dist.ivf_bq", dist_ivf("ivf_bq")),
                           ("dist.ivf_pq", dist_ivf("ivf_pq")),
                           ("dist.snapshot", lambda: dist_snapshot_phase(
                               *held.pop("dist.pq"))),
                           ("dist.cagra", dist_cagra),
                           ("dist.nccl", lambda: dist_nccl_phase(shared)),
                           ("cagra.nn_descent",
                            lambda: cagra_nn_descent_phase(shared)),
                           ("cagra.hnsw", lambda: cagra_hnsw_phase(shared)),
                           ("hybrid", hybrid_path), ("deep10m", deep10m),
                           ("batch_knn.out_of_core",
                            lambda: out_of_core_phase(shared)),
                           ("graph", lambda: graph_phase(shared)),
                           ("tail", tail)):
            t = time.perf_counter()
            path()
            emit({"phase": f"{name}.done", "seconds": time.perf_counter() - t})
            if args.ab and name == "lut":
                ab_phase(args.ab, shared)
                ab_k6_phase(args.ab, shared)
                return 0
    if not args.skip_main:
        # the distributed paths' launches ("N shards on one card")
        k1["launches_dist"] = {
            "dist.ivf_flat": dist_launches["dist.ivf_flat"]["K1"],
            "dist.ivf_pq": dist_launches["dist.ivf_pq"]["K1"],
            "dist.cagra.build": dist_launches["dist.cagra"]["K1"]}
        k2["launches_dist"] = {"dist.ivf_bq":
                               dist_launches["dist.ivf_bq"]["K2"]}
        k6["launches_dist"] = {"dist.cagra": dist_launches["dist.cagra"]["K6"]}
    emit({"kernels": [k1, k2, k3, k4, k5, k6]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
