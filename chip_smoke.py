#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py               # everything, as the chip check runs it
    python3 chip_smoke.py --skip-main   # device, build and kernel parity only

Phases, one JSON line each:

1. device — the card's name and power limit as nvidia-smi prints them;
2. build — every kernel source under ``raft_tpu_torch/ops/csrc`` compiled
   with nvcc, one process per source, all at once;
3. parity — kernel K1 (strip scan) against its plain twin on the card:
   main-path shapes (dim 128, int8 lists, w ∈ {1024, 2048, 4096},
   kf ∈ {10, 20, 40}), a multi-sub-block class, padding strips and dead
   sub-blocks, ±inf/NaN bias lanes, fp32 and bf16 lists, kf = 512; then
   kernel K2 (packed 1-bit scan) against its twin: main-path shapes
   (rot_dim 128, 1 bit, w ∈ {1024, 2048, 4096}, kf ∈ {40, 80, 320}),
   2- and 4-bit codes, dead sub-blocks, ±inf/NaN bias with scale 0 at
   padding, the tournament at kf 20, kf 512, rot_dim 40;
4. main — ``sift_like(1_000_000, 128, 10_000)`` and its tiled brute-force
   ground truth, made once for both paths. IVF-PQ: ``ivf_pq.build`` at the
   bench's parameters (n_lists 1024, pq_dim 64, 8 bits, train fraction
   0.2), the bench's n_probes / k_fetch escalation with exact refine to
   k = 10, recall@10 ≥ 0.95 asserted, QPS over three 10k-query batches
   (all queries over all their time); K1's launch count on that run, then
   its time at the main path's own class inputs beside its plain twin, a
   PyTorch yardstick (batched matmul + topk) and its bound;
5. bq — the same for IVF-BQ: ``ivf_bq.build`` at the bench's parameters
   (n_lists 1024, 1 bit, dense rotation, train fraction 0.2), the bench's
   escalation (n_probes 16…256 at k_fetch 40, then k_fetch 80, 160, 320 at
   the best n_probes), refine to k = 10, recall@10 ≥ 0.95 and K2 launches
   asserted, QPS; then K2 at the path's own class inputs.

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
# the main paths' size: the JAX bench's IVF-PQ and IVF-BQ sections
N_ROWS = 1_000_000
N_QUERIES = 10_000
N_LISTS = 1024
K = 10
K1_REPLACES = "raft_tpu/ops/strip_scan.py:340"
K2_REPLACES = "raft_tpu/ops/bq_scan.py:174"
# H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12

# values: summation-order noise plus one 12-bit packing quantum (2^-11
# relative); the absolute floor covers scores that cancel toward zero
PARITY_RTOL = 5e-4
PARITY_ATOL_FRAC = 1e-5      # × the case's largest |finite value|


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def synthetic_class(seed, *, w_blocks, n_sub, kf, dim=128, b_dtype="int8",
                    n_lists=8, s_real=24, s_pad=32, dead=False,
                    nonfinite=False, dev="cuda"):
    """One length class with random lists, bias and query blocks on
    ``dev``: padding strips scattered among the real ones, and strips
    whose real query rows are a prefix of their slots. ``b_dtype`` "int8",
    "bf16" or "fp32" makes K1's list rows; "packed" makes K2's: ``dim/8``
    random code bytes per row, with a scale drawn per row (0 at padding).
    Returns the keyword arguments of the class call and the per-strip row
    counts."""
    import torch

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = w_blocks * 512
    m = w * n_sub
    if b_dtype == "int8":
        b = torch.randint(-127, 128, (n_lists, m, dim), generator=g, device=dev,
                          dtype=torch.int8)
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
        call.update(list_codes=b.contiguous(), scale=torch.where(
            col < lens[:, None], scale, 0.0).contiguous())
    else:
        call.update(list_data=b.contiguous())
    return call, rows.to(torch.int32).contiguous()


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
       ("kf512_n_sub2", dict(w_blocks=1, n_sub=2, kf=512, dim=64), False),
       ("dim40_scalar_staging_kf20", dict(w_blocks=2, n_sub=1, kf=20, dim=40),
        True)]
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
        dict(w_blocks=2, n_sub=1, kf=40, dim=40), True)])


def _kernel_pair(kernel):
    """(wrapper, plain twin) of a kernel by name."""
    from raft_tpu_torch.ops import bq_scan as bq
    from raft_tpu_torch.ops import strip_scan as ss

    return {"strip_scan": (ss.strip_class, ss._strip_class_plain),
            "bq_scan": (bq.bq_class, bq._bq_class_plain)}[kernel]


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
        emit({"phase": "parity", "kernel": kernel, "case": name,
              "tournament": ss.tournament_engaged(kw["kf"], 512 * kw["w_blocks"],
                                                  approx_ok),
              **verdict})
        if not verdict["ok"]:
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
    from raft_tpu_torch.ops import strip_scan as ss

    ss.STRIP_KERNEL.reset()
    bq.BQ_KERNEL.reset()


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
            "data_gen_s": gen_s, "ground_truth_s": time.perf_counter() - t}


def kernel_parity_at(calls, kernel, case):
    """The kernel against its twin on a search's own class inputs."""
    wrapper, plain = _kernel_pair(kernel)
    worst = 0.0
    for c in calls:
        verdict = compare(wrapper(**c), plain(**c), c["strip_list"],
                          c["strip_rows"])
        emit({"phase": "parity", "kernel": kernel,
              "case": f"{case}_w{512 * c['w_blocks']}",
              "strips": int((c["strip_list"] >= 0).sum()), **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version on the main path: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
    return worst


def kernel_timing(calls, kernel, yardstick, bytes_per_col):
    """One search's worth of a kernel's launches: its time, by class, its
    twin's, the yardstick's, and the bound."""
    wrapper, plain = _kernel_pair(kernel)
    k_ms = cuda_ms(lambda: [wrapper(**c) for c in calls])
    by_class = {}
    for c in calls:       # classes of all query tiles, summed per class
        key = (c["w_blocks"] * 512, c["n_sub"])
        by_class[key] = by_class.get(key, 0.0) + cuda_ms(lambda c=c: wrapper(**c))
    p_ms = cuda_ms(lambda: [plain(**c) for c in calls], reps=3)
    l_ms = cuda_ms(lambda: [yardstick(c) for c in calls], reps=3)
    bound_ms, bound_by, nbytes, flops = scan_bound(calls, bytes_per_col)
    return {"ms": k_ms, "ms_by_class": [[w, ns, ms] for (w, ns), ms
                                        in sorted(by_class.items())],
            "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "launches_per_search": len(calls)}


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
        _, cand = ivf_pq.search(index, qs, kf, n_probes=n_probes, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    # the bench's escalation: n_probes at 4× over-fetch until the recall
    # gate holds, then the smallest over-fetch that still holds it
    reset_counts()
    pick = None
    for n_probes in (16, 32, 64, 128, 256):
        v, i = run(4 * K, n_probes)
        rec = neighborhood_recall(i, gt_i, v, gt_v)
        emit({"phase": "main.escalate", "n_probes": n_probes, "k_fetch": 4 * K,
              "recall": rec})
        if pick is None or rec > pick["recall"]:
            pick = {"n_probes": n_probes, "k_fetch": 4 * K, "recall": rec}
        if rec >= 0.95:
            break
    if pick["recall"] >= 0.95:
        for kf in (2 * K, K):
            v, i = run(kf, pick["n_probes"])
            rec = neighborhood_recall(i, gt_i, v, gt_v)
            emit({"phase": "main.escalate", "n_probes": pick["n_probes"],
                  "k_fetch": kf, "recall": rec})
            if rec < 0.95:
                break
            pick.update(recall=rec, k_fetch=kf)
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
        index, qs, pick["k_fetch"], n_probes=pick["n_probes"], res=res), reps=3)
    _, cand = ivf_pq.search(index, qs, pick["k_fetch"],
                            n_probes=pick["n_probes"], res=res)
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
    return {"launches": launches, "max_abs_err": max_err,
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}


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
    timing = kernel_timing(calls, "bq_scan", bq_library_yardstick,
                           index.code_bytes_per_row + 8)
    emit({"phase": "bq.k2", "n_probes": pick["n_probes"],
          "kf": pick["k_fetch"], "query_tile": qt,
          "strips": sum(int((c["strip_list"] >= 0).sum()) for c in calls),
          **timing})
    return {"launches": launches, "max_abs_err": max_err,
            **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel parity phases")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from raft_tpu_torch.ops import _native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
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

    empty = {"launches": 0, "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    k1 = {"name": "strip_scan", "route": "cuda", "source": K1_SOURCE,
          "replaces": K1_REPLACES, "parity": "ok", **empty,
          "max_abs_err": parity_phase("strip_scan", PARITY_CASES, 1000)}
    k2 = {"name": "bq_scan", "route": "cuda", "source": K2_SOURCE,
          "replaces": K2_REPLACES, "parity": "ok", **empty,
          "max_abs_err": parity_phase("bq_scan", K2_PARITY_CASES, 2000)}
    if not args.skip_main:
        shared = shared_data()
        for entry, phase in ((k1, main_phase), (k2, bq_phase)):
            worst = entry["max_abs_err"]
            entry.update(phase(shared))
            entry["max_abs_err"] = max(worst, entry["max_abs_err"])
    emit({"kernels": [k1, k2]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
