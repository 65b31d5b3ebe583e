"""Seconds a build spends encoding and packing the rows: the port's
``ivf_pq::encode`` and ``ivf_pq::pack`` spans in sync mode (committed
time), summed over the window and divided by its builds."""

SPANS = ("ivf_pq::encode", "ivf_pq::pack")


def read(trace):
    total = sum(s["dur_s"] for s in trace.spans if s["name"] in SPANS)
    return total / trace.builds if trace.builds and total else None
