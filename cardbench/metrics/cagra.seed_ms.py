"""Device milliseconds a request spends in the port's ``cagra::seed`` span:
seeding the buffer (the queries into code units, the gemm against the IVF
centres, the packed top-k and the first merge). The card's time between
each span's entry and exit marks, summed over the window (the loop's
per-name totals) and divided by its requests; None where the port records
no such span or no device time."""

SPAN = "cagra::seed"


def read(trace):
    n = len(trace.layer_ms.get("search", []))
    dev = [s["device_s"] for s in trace.spans
           if s["name"] == SPAN and s.get("device_s")]
    return 1e3 * sum(dev) / n if n and dev else None
