"""Percent of the profiled build window in which no kernel, copy or fill
ran on the card (the complement of the union of their intervals). The
traced build window runs the port's spans in sync mode, whose drain at
each span's exit this share includes."""


def read(trace):
    return trace.idle_share
