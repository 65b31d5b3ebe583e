"""Milliseconds a request spends in ``neighbors.cagra.search`` (seeding,
the hops, the host's frontier checks and the exit re-rank), by CUDA events
around the call, averaged over every request of the window."""


def read(trace):
    ms = trace.layer_ms.get("search")
    return sum(ms) / len(ms) if ms else None
