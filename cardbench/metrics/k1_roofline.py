"""K1's share of its roofline, in percent: the least time of the window's
list scans (``cardbench/roofline/ivf_scan``: operations at the card's bf16
peak, bytes at its HBM bandwidth, whichever bounds) over the device time
of K1's launches in the profiled window. K1's launches are the profiler's
kernels whose names carry every part of one of :data:`K1_NAMES`: the
strip kernels over packed lists (``ListAddr``) with the dense list source
(``DenseSrc``), as ``ops/csrc/strip_scan.cu`` instantiates them; the paged
scan (K3) takes ``PagedAddr`` and IVF-BQ (K2) ``PackedSrc``."""


K1_NAMES = (("strip_kernel", "DenseSrc", "ListAddr"),)


def is_k1(name: str) -> bool:
    return any(all(part in name for part in parts) for parts in K1_NAMES)


def read(trace):
    k1_s = sum(s for name, s in trace.device_ops.items() if is_k1(name))
    least = trace.work.get("k1", {}).get("least_s")
    if not k1_s or not least:
        return None
    return 100.0 * least / k1_s
