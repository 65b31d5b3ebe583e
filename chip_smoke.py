#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py               # everything, as the chip check runs it
    python3 chip_smoke.py --skip-main   # device, build and kernel parity only
    python3 chip_smoke.py --ab OLD_TREE # K1-K5 of an older checkout vs this one
    python3 chip_smoke.py --k1-variants A=CSRC_DIR B=CSRC_DIR  # K1 builds
    python3 chip_smoke.py --k2-variants A=CSRC_DIR B=CSRC_DIR  # K2, K4

Phases, one JSON line each:

1. device — the card's name and power limit as nvidia-smi prints them;
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
   invalid and all-invalid parents, +inf buffer holes, a scalar-staging
   shape, parents whose code records start past byte 2^31; bitwise on
   integer-valued qp, within tolerance on real-valued qp);
4. main — ``sift_like(1_000_000, 128, 10_000)`` and its tiled brute-force
   ground truth, made once for every path. IVF-PQ: ``ivf_pq.build`` at the
   bench's parameters (n_lists 1024, pq_dim 64, 8 bits, train fraction
   0.2), the bench's n_probes / k_fetch escalation with exact refine to
   k = 10, recall@10 ≥ 0.95 asserted, QPS over three 10k-query batches
   (all queries over all their time); K1's launch count on that run, then
   its time at the main path's own class inputs beside its plain twin, a
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
   path's state after hop 3, then K6 at the path's inputs (time, twin,
   bound) and the rest of a search (seeding, pickups, exit re-rank).

``--ab OLD_TREE`` drives the paths up to the LUT path, then times K1–K4 of
the older tree against this one's at the paths' own class inputs (K1 at
kf 20, kf 10 on uint8 and kf 129 on the CAGRA build's batch; K2; K3 and K4
at their serving inputs) in the order old, new, new, old, holds the two
trees' results against each other as ``compare`` holds a kernel and its
twin, and runs each tree's LUT search (K5) in a process of its own on one
index and query file; it prints no last line. ``--k1-variants`` and
``--k2-variants`` time K1 (or K2 and K4) built from other kernel source
trees against each other at the paths' shapes (``strip_variants``).

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

# values: summation-order noise plus one 12-bit packing quantum (2^-11
# relative); the absolute floor covers scores that cancel toward zero
PARITY_RTOL = 5e-4
PARITY_ATOL_FRAC = 1e-5      # × the case's largest |finite value|


# with --ab: each timed kernel's class inputs from its path, by kernel and
# shape, and the LUT path's index and queries in files under AB_FILES, beside
# the older tree (ab_phase reads them)
AB_INPUTS = None
AB_FILES = None


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


def synthetic_class(seed, *, w_blocks, n_sub, kf, dim=128, b_dtype="int8",
                    n_lists=8, s_real=24, s_pad=32, dead=False,
                    nonfinite=False, order=None, dev="cuda"):
    """One length class with random lists, bias and query blocks on
    ``dev``: padding strips scattered among the real ones, and strips
    whose real query rows are a prefix of their slots. ``b_dtype`` "int8",
    "uint8", "bf16" or "fp32" makes K1's list rows; "packed" makes K2's: ``dim/8``
    random code bytes per row, with a scale drawn per row (0 at padding).
    ``order`` zeroes the list rows (K2: the scales) so that every score is
    its bias, laid out by :func:`ordered_bias`. Returns the keyword
    arguments of the class call and the per-strip row counts."""
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
        True)]
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
        dict(w_blocks=2, n_sub=1, kf=40, dim=40), True)]
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
                    order=None, dev="cuda"):
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
    columns (no tombstones; tail slots stay +inf). Returns the keyword
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
    + [("r32_w64_kf20", dict(page_rows=32, table_width=2, ppf=2, kf=20)),
       ("r32_nsub2_spanning_tiles_kf40",
        dict(page_rows=32, table_width=16, ppf=8, kf=40, payload="int8")),
       ("r128_nsub2_kf80", dict(page_rows=128, table_width=8, ppf=4, kf=80)),
       ("r128_kf320_fp32", dict(page_rows=128, table_width=8, ppf=4, kf=320,
                                payload="fp32")),
       ("r24_w384_bf16_kf40", dict(page_rows=24, table_width=32, ppf=16,
                                   kf=40, payload="bf16", dim=64)),
       ("pq_cache_r128_kf40", dict(page_rows=128, table_width=64, ppf=32,
                                   kf=40, payload="int8"))]
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
                                        kf=20, payload="bits1", dim=40))]
    + [(name, dict(kw, payload="bits1")) for name, kw in
       PAGED_SELECTION_CASES])


def paged_parity_phase(kernel, cases, seed0, dev="cuda"):
    """K3 or K4 against its plain twin on synthetic paged classes. Besides
    the finite candidates, the +inf slots must carry the twin's offsets
    (the positions the all-+inf remainder of a block gives)."""
    import torch

    wrapper, plain = _kernel_pair(kernel)
    worst = 0.0
    for i, (name, kw) in enumerate(cases):
        call, rows = synthetic_paged(seed0 + i, dev=dev, **kw)
        got = wrapper(**call, strip_rows=rows)
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
              **verdict})
        if not (verdict["ok"] and verdict["inf_offsets_equal"]):
            raise AssertionError(f"{kernel} kernel disagrees with its plain "
                                 f"version on case {name}: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
    return worst


def class_calls(probes, a_rows, n_lists, cls_ord, classes, class_counts,
                q_tile, kf, lists):
    """The per-class keyword arguments one search hands its kernel: every
    query tile, planned on the static layout as the search plans it.
    ``lists`` holds the list-side operands and alpha."""
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
        a_grouped = ss.group_queries(a_rows[start:start + qt], qids)
        strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
        for (wb, ns, st, count) in layout:
            calls.append(dict(strip_list=strip_list[st:st + count].contiguous(),
                              a=a_grouped[st:st + count].contiguous(),
                              w_blocks=wb, n_sub=ns, kf=kf, approx_ok=True,
                              strip_rows=strip_rows[st:st + count], **lists))
    return calls


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
                            alpha=-2.0)), qt


def bq_path_class_inputs(index, queries, n_probes, kf, res):
    """The per-class arguments a main-path IVF-BQ search hands K2."""
    import torch

    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat

    queries = queries.to(torch.float32)
    n_probes = min(n_probes, index.n_lists)          # as search clamps it
    probes, qr, _ = ivf_bq._bq_search_prep(
        queries, index.centers, index.rotation, n_probes, "exact", True,
        index.bits, index.rotation_kind)
    classes, class_counts, cls_ord, q_tile = ivf_flat._ragged_plan_static(
        index, n_probes, kf, res, index.rot_dim * index.bits)
    qt = min(q_tile, queries.shape[0])
    return class_calls(probes, qr, index.n_lists, cls_ord, classes,
                       class_counts, qt, kf,
                       dict(list_codes=index.list_codes,
                            scale=index.list_scale, bias=index.list_bias,
                            alpha=-2.0)), qt


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
        dim = c["a"].shape[2]
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
    strips — K1's PyTorch yardstick; the port never calls it."""
    import torch

    live = c["strip_list"] >= 0
    lists = c["strip_list"][live].long()
    width = c["w_blocks"] * 512 * c["n_sub"]
    a = c["a"][live]
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


def reset_counts():
    """Every kernel's launch count to 0 (just before a path is driven)."""
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import cagra_hop as ch
    from raft_tpu_torch.ops import pq_scan as ps
    from raft_tpu_torch.ops import strip_scan as ss

    ch.HOP_KERNEL.reset()
    ps.PQ_KERNEL.reset()
    ss.STRIP_KERNEL.reset()
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
    "paged_scan": ("strip_scan", "_paged_kernel_fn", None),
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
    """The product loops (``"wgmma"``, ``"mma.sync"``) a packed kernel's
    launches run at these class inputs, as each launch reports its own."""
    from raft_tpu_torch.ops import bq_scan as bq

    counter = {"bq_scan": bq.BQ_KERNEL,
               "paged_bq_scan": bq.PAGED_BQ_KERNEL}[kernel]
    wrapper = _kernel_pair(kernel)[0]
    loops = set()
    for c in calls:
        wrapper(**c)
        loops.add(counter.loop)
    return sorted(loops)


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
    t = time.perf_counter()
    index = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
        n_lists=n_lists, pq_dim=64, pq_bits=8,
        kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
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
    t = time.perf_counter()
    index = ivf_bq.build(dataset, ivf_bq.IvfBqParams(
        n_lists=n_lists, kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
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
    return {"launches": launches, "max_abs_err": max_err,
            "loop": "/".join(loops),
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}, (index, pick)


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
    t = time.perf_counter()
    index = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(
        n_lists=n_lists, kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
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
    return index, pick, (v, i)


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
                            alpha=-2.0)), qt


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
    t = time.perf_counter()
    store = serving.PagedListStore.from_index(
        flat_index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    store.reserve(WINDOW_ROUNDS * UPSERT_ROWS)
    torch.cuda.synchronize()
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
    snap = store.paged_scan_state()
    probes = ivf_flat._coarse_probes(qs.float(), store.centers, n_probes,
                                     store.metric)
    q_tile = min(ivf_flat._paged_plan_static(store, n_probes, K, res,
                                             store.dim), q)
    calls = paged_class_inputs(snap, probes, qs.float(), K, store.dim, q_tile,
                               -2.0)
    max_err = kernel_parity_at(calls, "paged_scan",
                               f"serve_path_nprobe{n_probes}_kf{K}")
    keep_for_ab(("paged_scan", f"serve_flat_kf{K}"), calls)
    timing = kernel_timing(calls, "paged_scan", paged_library_yardstick,
                           store.dim + 4, bound=paged_scan_bound)
    emit({"phase": "serve.k3", "n_probes": n_probes, "kf": K,
          "query_tile": q_tile, "strips": sum(
              int((c["strip_list"] >= 0).sum()) for c in calls), **timing})
    return {"launches": launches, "max_abs_err": max_err,
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}


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
    t = time.perf_counter()
    store = serving.PagedListStore.from_index(
        index, page_rows=SERVE_PLAN_PAGE_ROWS, res=res)
    store.reserve(4 * UPSERT_ROWS)
    torch.cuda.synchronize()
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
    loop = {}
    if kind == "bq":
        loops = product_loops(calls, kernel)
        check_wgmma(loops, row_bytes, "serve.bq.k4")
        loop = {"loop": "/".join(loops)}
    emit({"phase": f"serve.{kind}.{'k4' if kind == 'bq' else 'k3'}",
          "n_probes": n_probes, "kf": kf, **loop,
          "query_tile": q_tile, "strips": sum(
              int((c["strip_list"] >= 0).sum()) for c in calls), **timing})
    if kind == "bq":
        kernel_split(calls, "serve.bq.k4_split", "paged_bq_scan", kf=kf,
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
    del index
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# K6 (the fused CAGRA hop) and the CAGRA path
# ---------------------------------------------------------------------------


def synthetic_hop(seed, *, w, itopk, deg=64, p=64, n=20_000, q=512,
                  frac_invalid=0.0, dup_heavy=False, all_invalid=False,
                  integer=True, far=False, dev="cuda"):
    """A random mid-traversal state on ``dev``: a graph with 10% -1 edges
    (ids from n/8 rows when ``dup_heavy``), int8 code records, a buffer
    with 15% +inf holes and random visited flags, parents with a
    ``frac_invalid`` share of -1 (all with ``all_invalid``). ``integer``
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
    """K6 against its plain twin on every synthetic case; one line each."""
    import torch

    from raft_tpu_torch.ops import cagra_hop as ch

    worst = 0.0
    for i, (name, kw) in enumerate(cases):
        call = synthetic_hop(seed0 + i, dev=dev, **kw)
        got = ch.fused_hop(**call)
        torch.cuda.synchronize()
        verdict = compare_hop(got, ch.fused_hop_reference(**call),
                              kw.get("integer", True))
        n = call["graph"].shape[0]
        emit({"phase": "parity", "kernel": "cagra_hop", "case": name,
              "rows": n, "code_bytes": n * call["nbr_codes"][0].numel(),
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"cagra_hop disagrees with its plain "
                                 f"version on {name}: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
        del call, got
    return worst


def hop_bound(calls):
    """Least time for one search's K6 launches: the graph rows and code
    records of the valid parents (deg·(4 + p) bytes each), the buffer read
    and written (12 bytes a slot each way), parents and qp, against the two
    fp32 multiply-adds per code byte of ``ip`` and ``nrm``."""
    nbytes = 0
    flops = 0
    for c in calls:
        q, itopk = c["buf_ids"].shape
        w = c["parents"].shape[1]
        deg = c["graph"].shape[1]
        p = c["qp"].shape[1]
        valid = int((c["parents"] >= 0).sum())
        nbytes += valid * deg * (4 + p) + 2 * q * itopk * 12 + q * (w + p) * 4
        flops += valid * deg * p * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


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
    hop's keyword arguments, hop by hop, from the same seeding, pickup and
    hops."""
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_hop as ch

    width = int(sp.search_width)
    buf_ids, buf_d, buf_vis, qp = cagra._fused_init(
        *fused_init_args(index, queries, sp, q_tile))
    state = (buf_ids, buf_d, buf_vis)
    calls = []
    for _ in range(hops):
        ids_b, d_b, vis, parents = cagra._fused_pickup(state, width)
        calls.append(dict(buf_ids=ids_b, buf_d=d_b, buf_vis=vis,
                          parents=parents, qp=qp, graph=index.graph,
                          nbr_codes=index.nbr_codes))
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
    t = time.perf_counter()
    index = cagra.build(dataset, params, res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
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

    # K6 at the path's own inputs: every hop of one search, parity on the
    # state after hop 3, time, twin time and bound
    st = {}
    run(pick["sp"], st)
    if st["tiles"] != 1:
        raise AssertionError(f"expected one fused tile, got {st}")
    calls = fused_hop_inputs(index, qs, pick["sp"], st["q_tile"],
                             st["hops"][0])
    mid = calls[3]
    verdict = compare_hop(ch.fused_hop(**mid), ch.fused_hop_reference(**mid),
                          exact=False)
    emit({"phase": "parity", "kernel": "cagra_hop",
          "case": f"cagra_path_after_hop3_itopk{pick['itopk']}"
                  f"_w{pick['width']}", **verdict})
    if not verdict["ok"]:
        raise AssertionError(f"cagra_hop disagrees with its plain version on "
                             f"the CAGRA path: {verdict}")
    k6_ms = cuda_ms(lambda: [ch.fused_hop(**c) for c in calls], reps=5)
    plain_ms = cuda_ms(lambda: [ch.fused_hop_reference(**c) for c in calls],
                       reps=1, warmup=1)
    bound_ms, bound_by, nbytes, flops = hop_bound(calls)
    # the rest of a fused search: seeding, the 16 parent pickups, the exit
    init_args = fused_init_args(index, qs, pick["sp"], st["q_tile"])
    glue = {
        "init_ms": cuda_ms(lambda: cagra._fused_init(*init_args), reps=3),
        "pickup_ms": cuda_ms(lambda: [cagra._fused_pickup(
            (c["buf_ids"], c["buf_d"], c["buf_vis"]), pick["width"])
            for c in calls], reps=3),
        "finish_ms": cuda_ms(lambda: cagra._fused_finish(
            index, init_args[1], calls[-1]["buf_ids"], K, st["refine_topk"]),
            reps=3)}
    emit({"phase": "cagra.k6", "itopk": pick["itopk"], "width": pick["width"],
          "hops": len(calls), "query_tile": st["q_tile"],
          "launches_per_search": len(calls), "ms": k6_ms,
          "ms_per_hop": k6_ms / len(calls), "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "flops": flops, "library_ms": None, **glue})
    del calls, mid, index
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": verdict["max_abs_err"],
            "ms": k6_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, k1_err


def ab_phase(old_tree, shared, dev="cuda"):
    """The strip kernels K1–K4 of an older checkout (``old_tree``, e.g. a
    ``git archive`` of the parent commit) against this tree's, in one
    process on one card, at the paths' own class inputs, in the order old,
    new, new, old: K1 at the IVF-PQ path (int8, kf 20, the tournament), the
    IVF-Flat path (uint8, kf 10) and the CAGRA build's candidate scan (fp32,
    kf 129); K2 at the IVF-BQ path; K3 at the flat serving path, K4 at the
    bq serving path. The older sources are built by nvcc beside that tree
    (both builds' ptxas lines are printed); the wrappers, plan and inputs
    are this tree's (the four kernels' C interfaces are the same); K1's
    product alone as well (``ab.k1_product``) where the older tree has the
    product-only instantiation. Then K5
    at path level (its C interface changed): each tree's LUT search in a
    process of its own, on one index file and one query file, old, new,
    new, old."""
    import ctypes
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import _native
    from raft_tpu_torch.ops import strip_scan as ss

    res = Resources(device=dev)
    calls, *_ = cagra_k1_inputs(shared["dataset"], cagra.CagraParams(
        intermediate_graph_degree=128, graph_degree=64), res)
    keep_for_ab(("strip_scan", "cagra_fp32_kf129"), calls)
    out = Path(old_tree) / "raft_tpu_torch" / "_build"
    out.mkdir(parents=True, exist_ok=True)
    old_fns, old_libs, cases = {}, {}, []
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
        old_fn = getattr(old_libs[name], new_fn.__name__)
        old_fn.argtypes, old_fn.restype = new_fn.argtypes, new_fn.restype
        old_fns[name] = (old_fn, new_fn)
    for key in [k for k in AB_INPUTS if isinstance(k, tuple)]:
        name, shape = key
        calls = AB_INPUTS[key]
        mod, getter, _ = launcher_of(name)
        old_fn, new_fn = old_fns[name]
        old_lib = old_libs[name]
        wrapper = _kernel_pair(name)[0]
        times = []
        for which in ("old", "new", "new", "old"):
            fn = old_fn if which == "old" else new_fn
            setattr(mod, getter, lambda fn=fn: fn)
            times.append([which, cuda_ms(lambda: [wrapper(**c)
                                                  for c in calls])])
        # the two trees' results held as the parity phases hold a kernel
        # against its twin: ids equal except at near-ties, values in rtol
        verdicts = []
        for c in calls:
            setattr(mod, getter, lambda: old_fn)
            old_out = wrapper(**c)
            setattr(mod, getter, lambda: new_fn)
            verdicts.append(compare(wrapper(**c), old_out, c["strip_list"],
                                    c["strip_rows"]))
        old_ms = [t for w, t in times if w == "old"]
        new_ms = [t for w, t in times if w == "new"]
        cases.append({"kernel": name, "inputs": shape, "order": times,
                      "launches_per_search": len(calls),
                      "old_ms_mean": sum(old_ms) / 2,
                      "new_ms_mean": sum(new_ms) / 2,
                      "new_over_old": sum(new_ms) / sum(old_ms),
                      "same_ids_but_near_ties": all(v["ok"] for v in verdicts),
                      "id_mismatch_frac": max(v["id_mismatch_frac"]
                                              for v in verdicts),
                      "max_abs_err": max(v["max_abs_err"] for v in verdicts)})
        emit({"phase": "ab", **cases[-1]})
        if name == "strip_scan" and hasattr(old_lib,
                                            "raft_strip_scan_product"):
            # the product alone (the product-only instantiations): the old
            # tree's loop against this tree's at the same inputs
            old_p = old_lib.raft_strip_scan_product
            new_p = _native.load("strip_scan").raft_strip_scan_product
            for f in (old_p, new_p):
                f.argtypes, f.restype = new_fn.argtypes, new_fn.restype
            prod = []
            for which in ("old", "new", "new", "old"):
                fn = old_p if which == "old" else new_p
                ss._kernel_fn = lambda fn=fn: fn
                prod.append([which, cuda_ms(lambda: [wrapper(**c)
                                                     for c in calls])])
            ss._kernel_fn = lambda fn=new_fn: fn
            emit({"phase": "ab.k1_product", "inputs": shape, "order": prod,
                  "old_ms_mean": sum(t for w, t in prod if w == "old") / 2,
                  "new_ms_mean": sum(t for w, t in prod if w == "new") / 2})

    # K5 at path level: each tree's LUT search in its own process
    index_file, query_file, pick = AB_INPUTS["lut"]
    runs = []
    for which in ("old", "new", "new", "old"):
        tree = Path(old_tree) if which == "old" else Path(__file__).parent
        ids_file = AB_FILES / f"lut_ids_{which}.pt"
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--lut-child",
             str(tree.resolve()), str(index_file), str(query_file),
             str(pick["n_probes"]), str(pick["k_fetch"]), str(ids_file)],
            check=True, capture_output=True, text=True)
        line = json.loads(done.stdout.strip().splitlines()[-1])
        runs.append({"tree": which, **line})
        emit({"phase": "ab.lut_run", **runs[-1]})
    same_ids = bool(torch.equal(torch.load(AB_FILES / "lut_ids_old.pt"),
                                torch.load(AB_FILES / "lut_ids_new.pt")))

    def mean(which, key):
        vals = [r[key] for r in runs if r["tree"] == which]
        return sum(vals) / len(vals)

    lut = {"kernel": "pq_scan", "inputs": "lut_path_search",
           "n_probes": pick["n_probes"], "k_fetch": pick["k_fetch"],
           "old_search_ms": mean("old", "search_ms"),
           "new_search_ms": mean("new", "search_ms"),
           "old_k5_ms": mean("old", "k5_ms"), "new_k5_ms": mean("new", "k5_ms"),
           "old_k5_launches": mean("old", "k5_launches"),
           "new_k5_launches": mean("new", "k5_launches"),
           "same_ids": same_ids}
    emit({"phase": "ab", **lut})
    cases.append(lut)
    return cases


def variant_shapes(family, res):
    """The class inputs ``strip_variants`` times, by shape name → (kernel,
    calls): for ``"k1"`` the three K1 shapes of the paths (IVF-PQ int8 kf
    20, IVF-Flat uint8 kf 10, the CAGRA build's first batch at fp32 kf
    129); for ``"k2"`` K2 at the IVF-BQ path and K4 at the bq serving path,
    both at the (n_probes, k_fetch) the IVF-BQ escalation picks
    (``BQ_PICK``)."""
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
    K2 and K4 for ``"k2"``. Each tree's sources are built by nvcc, all at
    once (ptxas lines printed); then each kernel and its product-only
    instantiation are timed through this tree's wrapper, in the order of
    the specs and back, and each tree's output is compared bit for bit
    with the first tree's. A tree whose library exports
    ``raft_prof_reset`` / ``raft_prof_read`` / ``raft_prof_names`` (device
    counters a variant adds) has them read over one run of each shape."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.ops import _native

    kernels = ["strip_scan"] if family == "k1" else ["bq_scan",
                                                      "paged_bq_scan"]
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


def lut_child(tree, index_file, query_file, n_probes, k_fetch, ids_file):
    """One tree's LUT search for ``ab_phase``, in a process of its own:
    ``tree``'s package loads the index and runs ``search(backend="pallas")``
    on the queries (a warm-up, then 3 timed searches); K5's launches are
    timed by CUDA events around the tree's own launcher. Prints one JSON
    line: search ms, K5 ms and K5 launches per search."""
    sys.path.insert(0, tree)
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan as ps

    res = Resources(device="cuda")
    index = ivf_pq.IvfPqIndex.load(index_file, res=res)
    qs = torch.load(query_file).cuda()
    events = []
    launch = ps._pq_scan_cuda

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    ps._pq_scan_cuda = timed

    def search():
        return ivf_pq.search(index, qs, int(k_fetch), n_probes=int(n_probes),
                             backend="pallas", res=res)

    _, ids = search()
    torch.save(ids.cpu(), ids_file)
    events.clear()
    search_ms = cuda_ms(search, reps=3, warmup=0)
    torch.cuda.synchronize()
    k5_ms = sum(s.elapsed_time(e) for s, e in events) / 3
    print(json.dumps({"module": ps.__file__, "search_ms": search_ms,
                      "k5_ms": k5_ms, "k5_launches": len(events) / 3}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel parity phases")
    ap.add_argument("--ab", metavar="OLD_TREE",
                    help="after the paths up to the LUT path, time K1-K4 "
                         "of an older checkout against this tree's at the "
                         "paths' inputs and the two trees' LUT searches "
                         "(K5), then stop")
    ap.add_argument("--k1-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K1 built from these kernel source trees "
                         "against each other at the paths' K1 shapes, then "
                         "stop")
    ap.add_argument("--k2-variants", nargs="+", metavar="NAME=CSRC_DIR",
                    help="time K2 and K4 built from these kernel source "
                         "trees against each other at the IVF-BQ and bq "
                         "serving paths' shapes, then stop")
    ap.add_argument("--lut-child", nargs=6, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.lut_child:
        return lut_child(*args.lut_child)
    if args.k1_variants:
        return strip_variants("k1", args.k1_variants)
    if args.k2_variants:
        return strip_variants("k2", args.k2_variants)

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
        held = {}

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

        def ivf_flat():
            held["flat"] = flat_phase(shared)

        def serve():
            fold(k3, serve_phase(shared, *held.pop("flat")))

        def serve_pq():
            serve_codes_phase(shared, "pq", *held.pop("main"))

        def serve_bq():
            fold(k4, serve_codes_phase(shared, "bq", *held.pop("bq")))

        def lut():
            fold(k5, lut_phase(shared))

        def cache():
            cache_phase(shared)

        def cagra():       # last: its index holds 4.2 GB of codes
            result, k1_err = cagra_phase(shared)
            fold(k6, result)
            k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)

        for name, path in (("main", ivf_pq), ("bq", ivf_bq),
                           ("flat", ivf_flat), ("serve", serve),
                           ("serve.pq", serve_pq), ("serve.bq", serve_bq),
                           ("lut", lut), ("cache", cache), ("cagra", cagra)):
            t = time.perf_counter()
            path()
            emit({"phase": f"{name}.done", "seconds": time.perf_counter() - t})
            if args.ab and name == "lut":
                ab_phase(args.ab, shared)
                return 0
    emit({"kernels": [k1, k2, k3, k4, k5, k6]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
