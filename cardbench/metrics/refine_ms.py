"""Milliseconds a request spends in ``neighbors.refine.refine`` (exact
re-rank of the k_fetch candidates), by CUDA events around the call,
averaged over every request of the window."""


def read(trace):
    ms = trace.layer_ms.get("refine")
    return sum(ms) / len(ms) if ms else None
