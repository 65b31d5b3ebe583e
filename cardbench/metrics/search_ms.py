"""Milliseconds a request spends in ``neighbors.ivf_pq.search`` (probe
select, strip plan, K1 and the merge), by CUDA events around the call,
averaged over every request of the window."""


def read(trace):
    ms = trace.layer_ms.get("search")
    return sum(ms) / len(ms) if ms else None
