"""The work of CAGRA's fused traversal hop (kernel K6), counted from the
task: in every hop each query expands ``width`` parents, scores their
``degree`` neighbours from the int8 codes inlined in the parents' records,
and merges the scores into its buffer of ``itopk`` candidates.

* bytes, a query a hop: the parents' graph rows (``width · degree`` int32
  ids), their code records (``width · degree · p`` int8), the query in code
  units (``p`` float32), and the buffer's ids (int32), distances (float32)
  and visited flags (float32), read once and written once;
* operations, a query a hop: ``4 · width · degree · p``, the product
  ⟨qp, c⟩ and the norm ‖c‖² of every candidate code, a multiply and an add
  each, in float32 on the CUDA cores (the rate :data:`RATE` names).

Every parent slot a hop launches is counted, live or not: the share that
expands a real node is the port's ``cagra.k6.parents_live`` over
``parents_launched``."""

from __future__ import annotations

#: the peak of :mod:`cardbench.roofline.peaks` that K6's products run at
RATE = "fp32_flops"


def work(q: int, hops: int, width: int, degree: int, p: int,
         itopk: int) -> dict:
    """{"flops", "bytes"} of ``hops`` hops over ``q`` queries each (a
    window's hops summed over its requests, one query tile a request)."""
    cand = int(width) * int(degree)
    per_hop = cand * 4 + cand * int(p) + 4 * int(p) + 2 * int(itopk) * 12
    n = int(q) * int(hops)
    return {"flops": float(n * 4 * cand * int(p)),
            "bytes": float(n * per_hop)}
