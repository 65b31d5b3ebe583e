"""Seconds a build spends training the coarse centres (balanced k-means
under ``ivf_pq.build``): the port's ``ivf_pq::coarse_train`` span in sync
mode (committed time), summed over the window and divided by its builds."""

SPANS = ("ivf_pq::coarse_train",)


def read(trace):
    total = sum(s["dur_s"] for s in trace.spans if s["name"] in SPANS)
    return total / trace.builds if trace.builds and total else None
