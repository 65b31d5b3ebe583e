"""The share of K6's launched parents that expand a real node, in percent:
100 × the port's ``cagra.k6.parents_live`` (per query and hop, the
unvisited live buffer entries, at most the hop's width, summed on the
card) over ``cagra.k6.parents_launched`` (queries × width, per hop). Below
100 where hops run on for queries whose frontier has closed."""


def read(trace):
    counters = trace.work.get("k6", {}).get("counters", {})
    launched = counters.get("cagra.k6.parents_launched")
    live = counters.get("cagra.k6.parents_live")
    if not launched or live is None:
        return None
    return 100.0 * live / launched
