"""Linear assignment by Bertsekas' auction with ε-scaling (counterpart of
``raft_tpu/solver/linear_assignment.py``).

A round is three vectorised steps: every unassigned row bids its top-2
margin on its best column, each column takes its highest bid (the lowest
row among equal bids), and the winning bids become the prices. The JAX
package runs the rounds of a phase under ``lax.while_loop``; here they run
on the device in batches of ``ROUNDS_PER_CHECK`` with one host read of
"any row unassigned?" per batch. A round with no unassigned row has no
bid and changes nothing, so the batching gives the JAX package's answer;
the round count kept on the device is the one its loop would count. The
ε-scaling schedule (ε from range/2 down by 5× to ``eps_final``), the round
budget ``50n + 1000`` with its ×8 escalation up to three times, and the
``RuntimeError`` for rows left unassigned are the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, to_device)

#: auction rounds run between two host checks of the assignment
ROUNDS_PER_CHECK = 32

#: the last call's auction: ``rounds`` (the rounds the JAX package's loop
#: would run, over every phase), ``phases`` and host ``checks``
LAST_RUN = {"rounds": 0, "phases": 0, "checks": 0}


def _round(benefits, row_to_col, col_to_row, prices, eps, rounds):
    """One auction round (a no-op once every row is assigned)."""
    n = benefits.shape[0]
    dev = benefits.device
    unassigned = row_to_col < 0
    v = benefits - prices[None, :]
    jstar = torch.argmax(v, dim=1)                   # the first on ties
    rows = torch.arange(n, device=dev)
    top = v[rows, jstar]
    second = v.clone()
    second[rows, jstar] = float("-inf")
    second = second.amax(dim=1)
    bid_amount = prices[jstar] + top - second + eps
    bids = torch.where(unassigned, bid_amount, float("-inf"))
    # column side: the highest bid, then the lowest row that made it
    key = torch.where(unassigned, jstar, n)
    best_bid = torch.full((n + 1,), float("-inf"), device=dev).scatter_reduce(
        0, key, bids, "amax")[:n]
    has_bid = torch.isfinite(best_bid)
    at_best = unassigned & (bids == best_bid[torch.clamp(jstar, max=n - 1)])
    winner = torch.full((n + 1,), n, dtype=torch.int64, device=dev
                        ).scatter_reduce(0, key, torch.where(at_best, rows, n),
                                         "amin")[:n]
    winner = torch.where(has_bid, winner, n)
    # column ownership is authoritative; rows are rebuilt from it
    col_to_row = torch.where(has_bid, winner, col_to_row)
    pos = torch.where(col_to_row >= 0, col_to_row, n)
    row_to_col = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    row_to_col[pos] = rows
    prices = torch.where(has_bid, best_bid, prices)
    return (row_to_col[:n], col_to_row, prices,
            rounds + unassigned.any().to(torch.int64))


def _auction_phase(benefits, prices, eps: float, max_rounds: int):
    """Rounds from an empty assignment until every row holds a column or
    ``max_rounds`` rounds ran → (row_to_col, prices)."""
    n = benefits.shape[0]
    dev = benefits.device
    row_to_col = torch.full((n,), -1, dtype=torch.int64, device=dev)
    col_to_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    done_rounds = 0
    while done_rounds < max_rounds:
        for _ in range(min(ROUNDS_PER_CHECK, max_rounds - done_rounds)):
            row_to_col, col_to_row, prices, rounds = _round(
                benefits, row_to_col, col_to_row, prices, eps_t, rounds)
        LAST_RUN["checks"] += 1
        done_rounds = int(rounds)
        if bool((row_to_col >= 0).all()):
            break
    LAST_RUN["rounds"] += done_rounds
    LAST_RUN["phases"] += 1
    return row_to_col, prices


def linear_assignment(costs, eps_final: float = 0.0,
                      device: Optional[DeviceLike] = None,
                      res: Optional[Resources] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost perfect assignment of an (n, n) cost matrix → (row_to_col
    (n,) int32, total cost, a 0-d float32).

    ``eps_final`` defaults to ``min(range / (2n(n+1)), 1/(2(n+1)))``: the
    second term keeps n·ε < 1/2, so integer costs solve exactly; the
    answer is within n·ε_final of the optimum. Raises ``RuntimeError`` when
    rows stay unassigned after the escalated round budget (non-finite
    costs), never returning a partial assignment."""
    dev = resolve_device(device, res)
    costs = to_device(costs, dev).to(torch.float32)
    if costs.ndim != 2 or costs.shape[0] != costs.shape[1]:
        raise ValueError(f"costs must be square, got {tuple(costs.shape)}")
    n = costs.shape[0]
    LAST_RUN.update(rounds=0, phases=0, checks=0)
    benefits = -costs
    rng = float(costs.max() - costs.min()) or 1.0
    if eps_final <= 0:
        eps_final = min(rng / (2.0 * n * (n + 1)), 1.0 / (2.0 * (n + 1)))
    # the JAX package's ε arithmetic: python floats, fp32 once per phase
    eps = max(rng / 2.0, eps_final)
    prices = torch.zeros(n, dtype=torch.float32, device=dev)
    max_rounds = 50 * n + 1000
    while True:
        row_to_col, prices = _auction_phase(benefits, prices, eps, max_rounds)
        if eps <= eps_final:
            break
        eps = max(eps / 5.0, eps_final)
    for _ in range(3):
        if bool((row_to_col >= 0).all()):
            break
        max_rounds *= 8
        row_to_col, prices = _auction_phase(benefits, prices, eps_final,
                                            max_rounds)
    if not bool((row_to_col >= 0).all()):
        raise RuntimeError(
            "auction failed to assign all rows (non-finite costs?); "
            f"{int((row_to_col < 0).sum())} rows unassigned")
    rows = torch.arange(n, device=dev)
    total = costs[rows, torch.clamp(row_to_col, 0, n - 1)].sum()
    return row_to_col.to(torch.int32), total
