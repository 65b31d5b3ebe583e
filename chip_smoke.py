#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py               # everything, as the chip check runs it
    python3 chip_smoke.py --skip-main   # device, build and kernel parity only

Phases, one JSON line each:

1. device — the card's name and power limit as nvidia-smi prints them;
2. build — the kernel source under ``raft_tpu_torch/ops/csrc`` compiled
   with nvcc;
3. parity — kernel K1 (strip scan) against its plain twin on the card:
   main-path shapes (dim 128, int8 lists, w ∈ {1024, 2048, 4096},
   kf ∈ {10, 20, 40}), a multi-sub-block class, padding strips and dead
   sub-blocks, ±inf/NaN bias lanes, fp32 and bf16 lists, kf = 512;
4. main — ``sift_like(1_000_000, 128, 10_000)``, tiled brute-force ground
   truth, ``ivf_pq.build`` at the bench's parameters (n_lists 1024,
   pq_dim 64, 8 bits, train fraction 0.2), the bench's n_probes / k_fetch
   escalation with exact refine to k = 10, recall@10 ≥ 0.95 asserted, QPS
   over three 10k-query batches (all queries over all their time); K1's launch count on that run, then its time
   at the main path's own class inputs beside its plain twin, a PyTorch
   yardstick (batched matmul + topk) and its bound.

Then a ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed phase raises: the script exits non-zero and prints no last
line. Without a CUDA device it exits 1 before printing anything.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

K1_SOURCE = "raft_tpu_torch/ops/csrc/strip_scan.cu"
# the main path's size: the JAX bench's headline IVF-PQ section
N_ROWS = 1_000_000
N_QUERIES = 10_000
N_LISTS = 1024
K1_REPLACES = "raft_tpu/ops/strip_scan.py:340"
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
    """topk_agreement over the rows K1 defines: real strips, real rows."""
    import torch

    from raft_tpu_torch.stats.metrics import topk_agreement

    (vk, ek), (vp, ep) = kernel_out, plain_out
    slots = torch.arange(vp.shape[1], device=vp.device)[None, :]
    rows = (strip_list >= 0)[:, None] & (slots < strip_rows[:, None])
    fin = torch.isfinite(vp[rows])
    top = float(vp[rows][fin].abs().max()) if bool(fin.any()) else 0.0
    return topk_agreement(vp, ep, vk, ek, rtol=PARITY_RTOL,
                          atol=PARITY_ATOL_FRAC * top, mask=rows)


def synthetic_class(seed, *, w_blocks, n_sub, kf, dim=128, b_dtype="int8",
                    n_lists=8, s_real=24, s_pad=32, dead=False,
                    nonfinite=False, dev="cuda"):
    """One length class with random lists, bias and query blocks on
    ``dev``: padding strips scattered among the real ones, and strips
    whose real query rows are a prefix of their slots. Returns the
    positional arguments of ``strip_class`` and the per-strip row counts."""
    import torch

    dev = torch.device(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = w_blocks * 512
    m = w * n_sub
    if b_dtype == "int8":
        b = torch.randint(-127, 128, (n_lists, m, dim), generator=g, device=dev,
                          dtype=torch.int8)
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
    return ((strip_list.to(torch.int32).contiguous(),
             a.to(torch.bfloat16).contiguous(), b.contiguous(),
             bias.contiguous(), w_blocks, n_sub, -2.0, kf),
            rows.to(torch.int32).contiguous())


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


def parity_phase(dev="cuda"):
    import torch

    from raft_tpu_torch.ops import strip_scan as ss

    worst = 0.0
    for i, (name, kw, approx_ok) in enumerate(PARITY_CASES):
        args, rows = synthetic_class(1000 + i, dev=dev, **kw)
        got = ss.strip_class(*args, approx_ok=approx_ok, strip_rows=rows)
        want = ss._strip_class_plain(*args, approx_ok=approx_ok)
        if args[1].is_cuda:
            torch.cuda.synchronize()
        verdict = compare(got, want, args[0], rows)
        emit({"phase": "parity", "kernel": "strip_scan", "case": name,
              "tournament": ss.tournament_engaged(kw["kf"], 512 * kw["w_blocks"],
                                                  approx_ok),
              **verdict})
        if not verdict["ok"]:
            raise AssertionError(f"strip_scan kernel disagrees with its plain "
                                 f"version on case {name}: {verdict}")
        worst = max(worst, verdict["max_abs_err"])
    return worst


def main_path_class_inputs(index, queries, n_probes, kf, res):
    """The per-class arguments a main-path search hands K1."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import strip_scan as ss

    queries = queries.to(torch.float32)
    probes, qr_scaled, bias, _ = ivf_pq._pq_search_prep(
        queries, index.centers, index.rotation, index.b_sum,
        index.decoded_scale, n_probes, "exact", True)
    classes, class_counts, cls_ord, q_tile = ivf_flat._ragged_plan_static(
        index, n_probes, kf, res, int(index.decoded.shape[-1]))
    qt = min(q_tile, queries.shape[0])
    region_starts, s_tot, layout = ss.static_layout(classes, class_counts, qt,
                                                   n_probes)
    qids, strip_list, _, _, _ = ss._plan_device(
        probes[:qt], cls_ord, index.n_lists, region_starts, s_tot)
    a_grouped = ss.group_queries(qr_scaled[:qt], qids)
    strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
    calls = []
    for (wb, ns, start, count) in layout:
        calls.append(dict(strip_list=strip_list[start:start + count].contiguous(),
                          a=a_grouped[start:start + count].contiguous(),
                          list_data=index.decoded, bias=bias.contiguous(),
                          w_blocks=wb, n_sub=ns, alpha=-2.0, kf=kf,
                          approx_ok=True,
                          strip_rows=strip_rows[start:start + count]))
    return calls, qt


def k1_bound(calls):
    """Least time for K1 over a search's classes: each input read once
    (the query blocks of live strips; each probed list's live columns —
    finite bias — with their bias, once), each output written once,
    against 2·rows·live_cols·dim tensor-core flops for the real query rows
    of live strips. Padding columns (+inf bias) decide nothing by a
    product and are not counted."""
    import torch

    from raft_tpu_torch.ops.strip_scan import MC

    nbytes = 0
    flops = 0
    for c in calls:
        sl = c["strip_list"]
        live = sl >= 0
        width = c["w_blocks"] * MC * c["n_sub"]
        dim = c["a"].shape[2]
        live_cols = torch.isfinite(c["bias"][:, :width]).sum(1)   # per list
        lists = sl[live].long()
        rows = c["strip_rows"][live].to(torch.int64)       # per live strip
        flops += 2 * int((rows * live_cols[lists]).sum()) * dim
        cols = int(live_cols[lists.unique()].sum())
        nbytes += cols * (dim * c["list_data"].element_size() + 4)
        nbytes += int(rows.sum()) * (dim * 2 + c["kf"] * 8)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def library_yardstick(c):
    """One batched bf16 matmul plus torch.topk over the class's live
    strips — the PyTorch yardstick; the port never calls it."""
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


def main_phase(n=N_ROWS, q=N_QUERIES, n_lists=N_LISTS, dev="cuda"):
    import torch

    from raft_tpu_torch import Resources
    from raft_tpu_torch.bench.datasets import sift_like
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import strip_scan as ss
    from raft_tpu_torch.stats.metrics import neighborhood_recall

    K = 10
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
    gt_s = time.perf_counter() - t

    t = time.perf_counter()
    index = ivf_pq.build(dataset, ivf_pq.IvfPqParams(
        n_lists=n_lists, pq_dim=64, pq_bits=8,
        kmeans_trainset_fraction=0.2), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    emit({"phase": "main.setup", "rows": n, "queries": q,
          "n_lists": n_lists, "max_list_size": index.max_list_size,
          "data_gen_s": gen_s, "ground_truth_s": gt_s, "build_s": build_s})

    def run(kf, n_probes):
        _, cand = ivf_pq.search(index, qs, kf, n_probes=n_probes, res=res)
        return refine.refine(dataset, qs, cand, K, res=res)

    # the bench's escalation: n_probes at 4× over-fetch until the recall
    # gate holds, then the smallest over-fetch that still holds it
    ss.STRIP_KERNEL.reset()
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
        for c in calls:
            got = ss.strip_class(**c)
            want = ss._strip_class_plain(**c)
            verdict = compare(got, want, c["strip_list"], c["strip_rows"])
            emit({"phase": "parity", "kernel": "strip_scan",
                  "case": f"main_path_nprobe{pick['n_probes']}_kf{kf}_"
                          f"w{512 * c['w_blocks']}",
                  "strips": int((c["strip_list"] >= 0).sum()), **verdict})
            if not verdict["ok"]:
                raise AssertionError(f"strip_scan disagrees with its plain "
                                     f"version on the main path: {verdict}")
            max_err = max(max_err, verdict["max_abs_err"])
    calls, qt = main_path_class_inputs(index, qs, pick["n_probes"],
                                       pick["k_fetch"], res)
    k_ms = cuda_ms(lambda: [ss.strip_class(**c) for c in calls])
    k_ms_by_class = [cuda_ms(lambda c=c: ss.strip_class(**c)) for c in calls]
    p_ms = cuda_ms(lambda: [ss._strip_class_plain(**c) for c in calls], reps=3)
    l_ms = cuda_ms(lambda: [library_yardstick(c) for c in calls], reps=3)
    bound_ms, bound_by, nbytes, flops = k1_bound(calls)
    emit({"phase": "main.k1", "n_probes": pick["n_probes"],
          "kf": pick["k_fetch"], "query_tile": qt,
          "classes": [[c["w_blocks"] * 512, c["n_sub"],
                       int((c["strip_list"] >= 0).sum())] for c in calls],
          "ms": k_ms, "ms_by_class": k_ms_by_class, "plain_ms": p_ms, "library_ms": l_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "flops": flops, "launches_per_search": len(calls)})
    return {"launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": l_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel parity phase")
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
          "nvcc_s": built})

    worst = parity_phase()
    k1 = {"name": "strip_scan", "route": "cuda", "source": K1_SOURCE,
          "replaces": K1_REPLACES, "parity": "ok", "launches": 0,
          "max_abs_err": worst,
          "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
          "library_ms": None}
    if not args.skip_main:
        k1.update(main_phase())
        k1["max_abs_err"] = max(worst, k1["max_abs_err"])
    emit({"kernels": [k1]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
