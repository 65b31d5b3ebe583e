"""Port parity: ``raft_tpu_torch.solver.linear_assignment`` (the ε-scaling
auction) against the JAX package and ``scipy.optimize.linear_sum_assignment``
on the same numpy costs (``device="cpu"``), as ``tests/test_parity_tail.py``
holds the JAX package: integer costs solve exactly (the total equals
scipy's), float costs within n·ε_final of scipy's. The rounds run in the
JAX package's fp32 order, so the assignment itself equals JAX's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from raft_tpu.solver import linear_assignment as jla
from raft_tpu_torch.solver import linear_assignment as tla

torch.set_num_threads(2)
CPU = "cpu"
LA = importlib.import_module("raft_tpu_torch.solver.linear_assignment")


def _costs(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 100, (n, n)).astype(np.float32)
    return rng.standard_normal((n, n)).astype(np.float32)


@pytest.mark.parametrize("n,kind", [(2, "int"), (10, "int"), (60, "int"),
                                    (128, "int"), (40, "float"),
                                    (80, "float")])
def test_assignment_is_optimal_and_equals_jax(n, kind):
    c = _costs(n, n, kind)
    r2c, total = tla(c, device=CPU)
    assert r2c.dtype == torch.int32
    assert sorted(r2c.tolist()) == list(range(n))      # a permutation
    ri, ci = linear_sum_assignment(c)
    want = float(c[ri, ci].astype(np.float64).sum())
    if kind == "int":
        assert float(total) == want
    else:
        rng = float(c.max() - c.min())
        eps_final = min(rng / (2.0 * n * (n + 1)), 1.0 / (2.0 * (n + 1)))
        assert float(total) <= want + n * eps_final + 1e-4 * abs(want)
    jr, jt = jla(jnp.asarray(c))
    np.testing.assert_array_equal(r2c.numpy(), np.asarray(jr))
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-6)
    assert LA.LAST_RUN["rounds"] > 0 and LA.LAST_RUN["phases"] >= 1


def test_explicit_eps_final_is_within_its_bound():
    c = _costs(3, 50, "float")
    r2c, total = tla(c, eps_final=0.05, device=CPU)
    ri, ci = linear_sum_assignment(c)
    assert float(total) <= float(c[ri, ci].sum()) + 50 * 0.05
    np.testing.assert_array_equal(
        r2c.numpy(), np.asarray(jla(jnp.asarray(c), eps_final=0.05)[0]))


def test_rounds_per_check_does_not_change_the_answer(monkeypatch):
    """A round with every row assigned makes no bid, so checking after
    every round or every 32 gives the same assignment and round count."""
    c = _costs(4, 64, "int")
    r32, t32 = tla(c, device=CPU)
    rounds32 = dict(LA.LAST_RUN)
    monkeypatch.setattr(LA, "ROUNDS_PER_CHECK", 1)
    r1, t1 = tla(c, device=CPU)
    assert torch.equal(r1, r32) and float(t1) == float(t32)
    assert LA.LAST_RUN["rounds"] == rounds32["rounds"]
    assert LA.LAST_RUN["checks"] >= rounds32["checks"]


def test_unassigned_rows_escalate_then_raise(monkeypatch):
    """The round budget 50n + 1000, ×8 up to three times, then
    ``RuntimeError`` — never a partial assignment."""
    budgets = []

    def stuck(benefits, prices, eps, max_rounds):
        budgets.append(max_rounds)
        return torch.full((benefits.shape[0],), -1, dtype=torch.int64), prices

    monkeypatch.setattr(LA, "_auction_phase", stuck)
    with pytest.raises(RuntimeError, match="4 rows unassigned"):
        tla(_costs(5, 4, "int"), device=CPU)
    base = 50 * 4 + 1000
    assert budgets[-4:] == [base, base * 8, base * 64, base * 512]


def test_rejects_a_non_square_matrix():
    with pytest.raises(ValueError, match="square"):
        tla(np.zeros((3, 4), np.float32), device=CPU)
