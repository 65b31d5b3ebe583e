"""Percent of the profiled search window in which no kernel, copy or fill
ran on the card (the complement of the union of their intervals). Read
for ``idle_share.search`` and ``idle_share.host_paced``."""


def read(trace):
    return trace.idle_share
