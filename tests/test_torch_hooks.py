"""The JAX package's telemetry, fault and recovery hooks in the port's
families, held against the JAX package's on the same inputs.

* Work counters: a JAX-built index carried into the port and searched
  with telemetry on in both packages counts the same queries, probes,
  rows scanned and backend (``<family>.search.*``,
  ``<family>.search_paged.*``, ``cagra.search.*``,
  ``brute_force.search.*``); builds count the same rows and lists.
* Span trees: each search's entry span has its scan span under it, with
  the JAX package's names.
* Faultpoints: every site the port carries is armed once; the call
  surfaces the injected failure classified, and the next call serves (as
  ``tests/test_faultpoint_coverage.py`` does for the JAX package). A scan
  of the port's source holds the list complete.
* Recovery: an injected OOM in the streamed IVF-BQ encode, the IVF-BQ
  scan, brute force and the store's upsert re-runs the same path smaller
  and gives the undegraded result (bit-identical for the encode).
"""

import re
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serving as jsv
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.comms import bootstrap as tboot
from raft_tpu_torch.comms import comms as tcomms
from raft_tpu_torch.core.resources import Resources, use_resources
from raft_tpu_torch.distributed import ivf_flat as tdflat
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import batch_knn as tbk
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu.core.bitset import Bitset as JBitset

torch.set_num_threads(2)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_state():
    tres.clear_faults()
    tres.clear_events()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()
        ob.clear_spans()
    yield
    tres.clear_faults()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()
        ob.clear_spans()


@pytest.fixture(scope="module")
def data():
    ds, qs = sift_like(4000, 32, 100, seed=31)
    return ds.astype(np.float32), qs.astype(np.float32)


def carry_flat(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "list_data", "list_ids")}
    if j.list_norms is not None:
        arrays["list_norms"] = np.asarray(j.list_norms)
    return tfl.from_jax_arrays({"kind": "ivf_flat", "metric": j.metric,
                                "group_size": j.group_size}, arrays,
                               device=CPU)


def carry_pq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    return tpq.from_jax_arrays(
        {"kind": "ivf_pq", "metric": j.metric, "pq_bits": j.pq_bits,
         "group_size": j.group_size, "codebook_kind": j.codebook_kind,
         "pq_dim_hint": j.pq_dim_hint}, arrays, device=CPU)


def carry_bq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return tbq.from_jax_arrays({"kind": "ivf_bq", "metric": j.metric,
                                "bits": j.bits,
                                "rotation_kind": j.rotation_kind}, arrays,
                               device=CPU)


@pytest.fixture(scope="module")
def indexes(data):
    ds, _ = data
    jf = jfl.build(ds, jfl.IvfFlatParams(n_lists=8, group_size=512,
                                         kmeans_n_iters=5))
    jp = jpq.build(ds, jpq.IvfPqParams(n_lists=8, pq_dim=8, group_size=512,
                                       kmeans_n_iters=5))
    jb = jbq.build(ds, jbq.IvfBqParams(n_lists=8, kmeans_n_iters=5))
    return {"ivf_flat": (jf, carry_flat(jf)), "ivf_pq": (jp, carry_pq(jp)),
            "ivf_bq": (jb, carry_bq(jb))}


def counters(ob, prefix):
    return {k: v for k, v in ob.snapshot()["counters"].items()
            if k.startswith(prefix)}


#: the port's phase spans inside a search, which the JAX package does not
#: record (tests/test_torch_obs_search.py holds them)
PORT_PHASES = ("strip_scan::", "ivf_pq::probe_select", "ivf_pq::bias",
               "ivf_pq::finalize", "refine::refine")


def tree(ob):
    """(span, parent) names; the JAX package's ``obs.*`` spans (its cost
    layer, not yet ported) and the port's phase spans are left out."""
    spans = [s for s in ob.spans() if not s["name"].startswith("obs.")
             and not s["name"].startswith(PORT_PHASES)]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return {(s["name"], by_id.get(s["parent_id"])) for s in spans}


def both_enabled():
    for ob in (jobs, tobs):
        ob.reset()
        ob.clear_spans()
        ob.enable()


SEARCHES = [
    ("ivf_flat", "ragged", False), ("ivf_flat", "gather", False),
    ("ivf_flat", "gather", True), ("ivf_pq", "ragged", False),
    ("ivf_pq", "gather", False), ("ivf_pq", "gather", True),
    ("ivf_bq", None, False), ("ivf_bq", None, True)]


@pytest.mark.parametrize("family,backend,filtered", SEARCHES)
def test_search_counters_and_spans_match_jax(data, indexes, family, backend,
                                             filtered):
    _, qs = data
    jidx, tidx = indexes[family]
    jmod, tmod = {"ivf_flat": (jfl, tfl), "ivf_pq": (jpq, tpq),
                  "ivf_bq": (jbq, tbq)}[family]
    kw = {} if backend is None else {"backend": backend}
    jkw, tkw = dict(kw), dict(kw)
    if filtered:
        mask = np.random.default_rng(5).random(4000) < 0.3
        jkw["filter"] = JBitset.from_mask(mask)
        tkw["filter"] = Bitset.from_mask(mask, device=CPU)
    both_enabled()
    jmod.search(jidx, qs, 10, n_probes=3, **jkw)
    tmod.search(tidx, qs, 10, n_probes=3, device=CPU, **tkw)
    want = counters(jobs, f"{family}.search.")
    if family == "ivf_pq":
        # the port counts K1's work exactly (strip_scan.k1.products_*) in
        # place of this padded upper bound
        want.pop("ivf_pq.search.rows_scanned")
    assert counters(tobs, f"{family}.search.") == want
    assert want[f"{family}.search.queries"] == qs.shape[0]
    assert tree(tobs) == tree(jobs)
    assert (f"{family}::scan", f"{family}::search") in tree(tobs)
    if filtered:
        (scan,) = [s for s in tobs.spans() if s["name"] == f"{family}::scan"]
        (jscan,) = [s for s in jobs.spans() if s["name"] == f"{family}::scan"]
        assert scan["attrs"] == jscan["attrs"]


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_paged_gather_counters_and_spans_match_jax(data, indexes, family):
    _, qs = data
    jidx, tidx = indexes[family]
    jmod, tmod = {"ivf_flat": (jfl, tfl), "ivf_pq": (jpq, tpq)}[family]
    jstore = jsv.PagedListStore.from_index(jidx, page_rows=32)
    tstore = tsv.PagedListStore.from_index(tidx, page_rows=32, device=CPU)
    both_enabled()
    jmod.search_paged(jstore, qs, 10, n_probes=3, backend="gather")
    tmod.search_paged(tstore, qs, 10, n_probes=3, backend="gather",
                      device=CPU)
    assert counters(tobs, f"{family}.search_paged.") == \
        counters(jobs, f"{family}.search_paged.")
    assert (f"{family}::paged_scan", f"{family}::search_paged") \
        in tree(tobs) & tree(jobs)


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "ivf_bq"])
def test_paged_kernel_path_span(data, indexes, family):
    _, qs = data
    tmod = {"ivf_flat": tfl, "ivf_pq": tpq, "ivf_bq": tbq}[family]
    tstore = tsv.PagedListStore.from_index(indexes[family][1], page_rows=32,
                                           device=CPU)
    tobs.enable()
    tmod.search_paged(tstore, qs, 10, n_probes=3, backend="paged",
                      device=CPU)
    assert (f"{family}::paged_pallas", f"{family}::search_paged") \
        in tree(tobs)
    c = counters(tobs, f"{family}.search_paged.")
    assert c[f"{family}.search_paged.backend.paged"] == 1
    assert c[f"{family}.search_paged.queries"] == qs.shape[0]


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq", "ivf_bq"])
def test_build_counters_match_jax(data, family):
    ds, _ = data
    jmod, tmod = {"ivf_flat": (jfl, tfl), "ivf_pq": (jpq, tpq),
                  "ivf_bq": (jbq, tbq)}[family]
    kw = dict(n_lists=8, kmeans_n_iters=5)
    if family == "ivf_pq":
        kw["pq_dim"] = 8
    both_enabled()
    jmod.build(ds[:2000], getattr(jmod, _params(family))(**kw))
    tmod.build(ds[:2000], getattr(tmod, _params(family))(**kw), device=CPU)
    for prefix in (f"{family}.build.", "kmeans_balanced."):
        assert counters(tobs, prefix) == counters(jobs, prefix)
    names = {n for n, _ in tree(tobs)}
    assert {f"{family}::build", f"{family}::coarse_train",
            "kmeans_balanced::fit", "kmeans_balanced::em"} <= names
    assert names <= {n for n, _ in tree(jobs)}


def _params(family):
    return {"ivf_flat": "IvfFlatParams", "ivf_pq": "IvfPqParams",
            "ivf_bq": "IvfBqParams"}[family]


@pytest.fixture(scope="module")
def cagra_pair(data):
    ds, qs = data
    X = ds[:1500]
    j = jcg.build(X, jcg.CagraParams(graph_degree=16,
                                     intermediate_graph_degree=32,
                                     compress="on"))
    # under 4,096 rows the JAX index has no seeding table (None)
    arrays = {name: getattr(j, name) for name in
              ("dataset", "graph", "norms", "proj", "code_scale", "nbr_codes",
               "centroids", "centroid_reps", "proj_energy")}
    arrays = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    return j, tcg.from_jax_arrays({"kind": "cagra"}, arrays, device=CPU)


def test_cagra_counters_and_spans_match_jax(data, cagra_pair):
    _, qs = data
    j, t = cagra_pair
    both_enabled()
    sp = dict(itopk_size=32, search_width=2, traversal="compressed")
    jcg.search(j, qs, 10, jcg.CagraSearchParams(**sp))
    tcg.search(t, qs, 10, tcg.CagraSearchParams(**sp), device=CPU)
    assert counters(tobs, "cagra.search.") == counters(jobs, "cagra.search.")
    tobs.reset()
    tobs.clear_spans()
    tcg.search(t, qs, 10, tcg.CagraSearchParams(
        itopk_size=32, search_width=2, traversal="fused"), device=CPU)
    assert ("cagra::hop", "cagra::search") in tree(tobs)
    assert counters(tobs, "cagra.search.")["cagra.search.traversal.fused"] == 1


def test_brute_force_counters_match_jax(data):
    ds, qs = data
    both_enabled()
    jbf.search(jbf.build(ds), qs, 10, tile_rows=1000)
    tbf.search(tbf.build(ds, device=CPU), qs, 10, tile_rows=1000, device=CPU)
    assert counters(tobs, "brute_force.") == counters(jobs, "brute_force.")
    assert ("brute_force::search", None) in tree(tobs) & tree(jobs)


# ---------------------------------------------------------------------------
# every faultpoint, once
# ---------------------------------------------------------------------------


def _fault_cases(data, indexes, cagra_pair, tmp_path):
    ds, qs = data
    flat, pq, bq = (indexes[f][1] for f in ("ivf_flat", "ivf_pq", "ivf_bq"))
    f = Bitset.from_mask(np.arange(4000) % 2 == 0, device=CPU)
    stores = {k: tsv.PagedListStore.from_index(v, page_rows=32, device=CPU)
              for k, v in (("flat", flat), ("pq", pq), ("bq", bq))}
    _, cag = cagra_pair
    path = tmp_path / "x.bin"
    tser.save_arrays(path, {"kind": "t"}, {"a": np.arange(4)})
    fused = tcg.CagraSearchParams(itopk_size=32, search_width=2,
                                  traversal="fused")
    two = tcomms.Comms(tboot.local_mesh(2, device=CPU))
    dflat = tdflat.build(ds, tfl.IvfFlatParams(n_lists=4, kmeans_n_iters=2),
                         comms=two, device=CPU)
    return {
        "brute_force.search": lambda: tbf.search(
            tbf.build(ds, device=CPU), qs, 5, device=CPU),
        "ivf_flat.search.filter": lambda: tfl.search(
            flat, qs, 5, filter=f, device=CPU),
        "ivf_flat.search.scan": lambda: tfl.search(flat, qs, 5, device=CPU),
        "ivf_flat.search_paged.scan": lambda: tfl.search_paged(
            stores["flat"], qs, 5, device=CPU),
        "ivf_pq.search.filter": lambda: tpq.search(
            pq, qs, 5, filter=f, device=CPU),
        "ivf_pq.search.scan": lambda: tpq.search(pq, qs, 5, device=CPU),
        "ivf_pq.search_paged.scan": lambda: tpq.search_paged(
            stores["pq"], qs, 5, device=CPU),
        "ivf_bq.search.filter": lambda: tbq.search(
            bq, qs, 5, filter=f, device=CPU),
        "ivf_bq.search.scan": lambda: tbq.search(bq, qs, 5, device=CPU),
        "ivf_bq.search_paged.scan": lambda: tbq.search_paged(
            stores["bq"], qs, 5, device=CPU),
        "ivf_bq.build.encode_chunk": lambda: tbq.build_streaming(
            lambda s, e: ds[s:e], 2000, ds.shape[1],
            tbq.IvfBqParams(n_lists=4, kmeans_n_iters=2), device=CPU,
            chunk_rows=1000),
        "cagra.build": lambda: tcg.build(ds[:600], tcg.CagraParams(
            graph_degree=8, intermediate_graph_degree=16), device=CPU),
        "cagra.search": lambda: tcg.search(cag, qs, 5, fused, device=CPU),
        "cagra.search.hop": lambda: tcg.search(cag, qs, 5, fused,
                                               device=CPU),
        "kmeans.fit.em": lambda: tkm.fit(ds[:500], tkm.KMeansParams(
            n_clusters=4, max_iter=3), device=CPU),
        "kmeans_balanced.fit.em": lambda: tkb.fit(ds[:500], 4, device=CPU),
        "serving.store.upsert": lambda: stores["flat"].upsert(
            qs[:8], ids=np.arange(90_000, 90_008)),
        "serialize.save.write": lambda: tser.save_arrays(
            path, {"kind": "t"}, {"a": np.arange(9)}),
        "serialize.load.read": lambda: tser.load_arrays(path),
        "distributed.assign_phase": lambda: tdflat.build(
            ds, tfl.IvfFlatParams(n_lists=4, kmeans_n_iters=2), comms=two,
            device=CPU),
        "distributed.tiled_search.tile": lambda: tdflat.search(
            dflat, qs, 5, n_probes=2, device=CPU),
        "comms.init_distributed": lambda: _init_and_leave(),
        "batch_knn.search_device_chunked": lambda: tbk.search_device_chunked(
            ds, qs, 5, chunk_rows=1000, device=CPU),
        "batch_knn.search_out_of_core.chunk": lambda: tbk.search_out_of_core(
            ds, qs, 5, chunk_rows=1000, device=CPU),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_and_leave():
    """A one-rank gloo group joined and left (its handshake is retried
    once, so an armed fault surfaces only when it fires twice)."""
    with use_resources(Resources(device=CPU)):
        assert tboot.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                      timeout_s=30.0)
        tboot.shutdown_distributed()


#: modules whose faultpoints sit inside their own classifying handlers
#: (the serving managers, the shadow sampler, the flight recorder, the
#: tuner and the burn-rate controller): an armed fault there becomes a
#: verdict, a status, a degraded window or a skipped window/tick, never an
#: exception; tests/test_torch_serving_managers.py,
#: tests/test_torch_obs_remainder.py and tests/test_torch_tuning.py arm
#: each one
_MANAGER_FILES = {"batching.py", "compaction.py", "maintenance.py",
                  "capacity.py", "shadow.py", "flight.py", "autotune.py",
                  "controller.py"}


def _port_sites():
    """Every faultpoint site string in the port's source outside the
    managers (f-string sites expanded over the IVF kinds)."""
    sites = set()
    for f in (REPO / "raft_tpu_torch").rglob("*.py"):
        if f.parent.name == "resilience":   # the grammar's own examples
            continue
        if f.name in _MANAGER_FILES:
            continue
        text = f.read_text()
        sites |= set(re.findall(r'faultpoint\(\s*"([^"{}]+)"\)', text))
        for tmpl in re.findall(r'faultpoint\(\s*f"([^"]+)"\)', text):
            if tmpl == "{site}" or "{kind}" not in tmpl:
                continue
            sites |= {tmpl.replace("{kind}", k)
                      for k in ("ivf_flat", "ivf_pq", "ivf_bq")}
        for site in re.findall(r'_filter_plan\(\s*"([^"]+)"', text):
            sites.add(site)
        for tmpl in re.findall(r'_filter_plan\(\s*f"([^"]+)"', text):
            sites |= {tmpl.replace("{kind}", k)
                      for k in ("ivf_flat", "ivf_pq", "ivf_bq")}
    return sites


def test_every_port_faultpoint_is_covered(data, indexes, cagra_pair,
                                          tmp_path):
    cases = _fault_cases(data, indexes, cagra_pair, tmp_path)
    assert _port_sites() == set(cases) == set(TRANSIENT_SPECS)


TRANSIENT_SPECS = {spec.split("=")[0]: spec for spec in (
    "brute_force.search=transient:1", "ivf_flat.search.filter=transient:1",
    "ivf_flat.search.scan=transient:1",
    "ivf_flat.search_paged.scan=transient:1",
    "ivf_pq.search.filter=transient:1", "ivf_pq.search.scan=transient:1",
    "ivf_pq.search_paged.scan=transient:1",
    "ivf_bq.search.filter=transient:1", "ivf_bq.search.scan=transient:1",
    "ivf_bq.search_paged.scan=transient:1",
    "ivf_bq.build.encode_chunk=transient:1", "cagra.build=transient:1",
    "cagra.search=transient:1", "cagra.search.hop=transient:1",
    "kmeans.fit.em=transient:1", "kmeans_balanced.fit.em=transient:1",
    "serving.store.upsert=transient:1", "serialize.save.write=transient:1",
    "serialize.load.read=transient:1",
    "distributed.assign_phase=transient:1",
    "distributed.tiled_search.tile=transient:1",
    "batch_knn.search_device_chunked=transient:1",
    "batch_knn.search_out_of_core.chunk=transient:1",
    # the bootstrap retries one TRANSIENT failure: two make it surface
    "comms.init_distributed=transient:2")}


@pytest.mark.parametrize("site", sorted(TRANSIENT_SPECS))
def test_armed_faultpoint_surfaces_classified_then_serves(
        data, indexes, cagra_pair, tmp_path, site):
    run = _fault_cases(data, indexes, cagra_pair, tmp_path)[site]
    # transient: the OOM-degrading sites would recover from an oom
    tres.arm_faults(TRANSIENT_SPECS[site])
    with pytest.raises(tres.FaultInjected) as ei:
        run()
    assert tres.classify(ei.value) == tres.TRANSIENT
    assert tres.armed_sites()[site] == ("transient", 0)
    run()


# ---------------------------------------------------------------------------
# recovery: the same path, smaller
# ---------------------------------------------------------------------------


def test_degraded_streamed_bq_encode_is_bit_identical(data):
    ds, _ = data

    def build():
        return tbq.build_streaming(
            lambda s, e: ds[s:e], ds.shape[0], ds.shape[1],
            tbq.IvfBqParams(n_lists=8, kmeans_n_iters=3), device=CPU,
            chunk_rows=2000)

    clean = build()
    tobs.enable()
    tres.arm_faults("ivf_bq.build.encode_chunk=oom:1")
    degraded = build()
    c = tobs.snapshot()["counters"]
    assert c["ivf_bq.build.degraded_chunk"] == 1
    assert c["resilience.retries.oom"] == 1
    for name in ("list_codes", "list_ids", "list_scale", "list_bias"):
        torch.testing.assert_close(getattr(degraded, name),
                                   getattr(clean, name), rtol=0, atol=0)
    ev = [e for e in tres.recent_events() if e["event"] == "degraded_chunk"]
    assert ev and ev[0]["chunk_rows"] == 1000


def test_bq_search_degrades_the_query_tile(data, indexes):
    _, qs = data
    t = indexes["ivf_bq"][1]
    want = tbq.search(t, qs, 10, n_probes=4, device=CPU)
    tobs.enable()
    tres.arm_faults("ivf_bq.search.scan=oom:1")
    got = tbq.search(t, qs, 10, n_probes=4, device=CPU)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    c = tobs.snapshot()["counters"]
    assert c["ivf_bq.search.degraded_tile"] == 1
    assert c["resilience.retries.oom"] == 1


def test_brute_force_degrades_the_tile(data):
    ds, qs = data
    idx = tbf.build(ds, device=CPU)
    want = tbf.search(idx, qs, 10, tile_rows=4000, device=CPU)
    tobs.enable()
    tres.arm_faults("brute_force.search=oom:2")
    got = tbf.search(idx, qs, 10, tile_rows=4000, device=CPU)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tobs.snapshot()["counters"]["resilience.retries.oom"] == 2
    ev = [(e["from_size"], e["to_size"]) for e in tres.recent_events()
          if e["event"] == "degraded_tile"]
    assert ev == [(4000, 2000), (2000, 1000)]


def test_store_upsert_degrades_the_chunk(data, indexes):
    ds, qs = data
    flat = indexes["ivf_flat"][1]
    ids = np.arange(50_000, 50_000 + qs.shape[0])
    clean = tsv.PagedListStore.from_index(flat, page_rows=32, device=CPU)
    clean.upsert(qs, ids=ids)
    tobs.enable()
    degraded = tsv.PagedListStore.from_index(flat, page_rows=32, device=CPU)
    tres.arm_faults("serving.store.upsert=oom:1")
    out = degraded.upsert(qs, ids=ids)
    assert out["upserts"] == qs.shape[0]
    c = tobs.snapshot()["counters"]
    assert c["resilience.retries.oom"] == 1
    assert c["serving.store.upserts"] == qs.shape[0]
    for st in (clean, degraded):
        v, i = tfl.search_paged(st, qs, 1, n_probes=8, device=CPU)
        np.testing.assert_array_equal(i[:, 0].numpy(), ids)
    assert degraded.size == clean.size
