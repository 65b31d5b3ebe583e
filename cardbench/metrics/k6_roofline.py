"""K6's share of its roofline, in percent: the least time of the window's
hops (``cardbench/roofline/cagra_hop``: operations at the card's float32
peak, bytes at its HBM bandwidth, whichever bounds) over the device time of
K6's launches in the profiled window, the profiler's kernels named
``cagra_hop_kernel`` (``ops/csrc/cagra_hop.cu``)."""

K6_NAME = "cagra_hop_kernel"


def read(trace):
    k6_s = sum(s for name, s in trace.device_ops.items() if K6_NAME in name)
    least = trace.work.get("k6", {}).get("least_s")
    if not k6_s or not least:
        return None
    return 100.0 * least / k6_s
