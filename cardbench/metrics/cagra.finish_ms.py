"""Device milliseconds a request spends in the port's ``cagra::finish`` span:
the exact re-rank of the buffer against the rows at the exit. The card's
time between each span's entry and exit marks, summed over the window (the
loop's per-name totals) and divided by its requests; None where the port
records no such span or no device time."""

SPAN = "cagra::finish"


def read(trace):
    n = len(trace.layer_ms.get("search", []))
    dev = [s["device_s"] for s in trace.spans
           if s["name"] == SPAN and s.get("device_s")]
    return 1e3 * sum(dev) / n if n and dev else None
