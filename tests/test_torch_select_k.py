"""Port parity: raft_tpu_torch.ops.select_k against raft_tpu.ops.select_k on
the same numpy rows (ties, ±inf, NaN)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import select_k as jsk
from raft_tpu_torch.ops import select_k as tsk

torch.set_num_threads(2)


def _rows(seed, shape=(6, 300), zeros=True):
    """Small integers (many ties) with ±inf and NaN sprinkled in. Without
    ``zeros`` every value is non-zero: the JAX package's packed select runs
    under XLA's flush-to-zero, where packed ±0 scores collapse (ROADMAP
    Queue 3), so its packed oracle is only taken on non-zero rows."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-9, 10, shape).astype(np.float32)
    if not zeros:
        v = np.where(v == 0, 11.0, v).astype(np.float32)
    u = rng.random(shape)
    v[u < 0.05] = np.inf
    v[(u >= 0.05) & (u < 0.08)] = -np.inf
    v[(u >= 0.08) & (u < 0.11)] = np.nan
    v[0, :] = np.nan                     # an all-NaN row
    v[1, : shape[1] // 2] = np.inf       # a long +inf tail
    return v


@pytest.mark.parametrize("bits", [9, 12, 13])
def test_pack_values_bit_identical(bits):
    v = _rows(1, (5, 1 << (bits - 1)))
    want = np.asarray(jsk.pack_values(jnp.asarray(v), bits)).view(np.int32)
    got = tsk.pack_values(torch.from_numpy(v), bits).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert tsk.pack_clamp_for(bits) == jsk.pack_clamp_for(bits)


@pytest.mark.parametrize("k", [1, 10, 64])
def test_iter_topk_min_packed_bit_identical(k):
    v = _rows(2, zeros=False)
    wv, wi = jsk.iter_topk_min_packed(jnp.asarray(v), k)
    gv, gi = tsk.iter_topk_min_packed(torch.from_numpy(v), k)
    np.testing.assert_array_equal(gv.numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [1, 7, 40])
def test_iter_topk_min_identical(k):
    v = _rows(3)
    wv, wi = jsk.iter_topk_min(jnp.asarray(v), k)
    gv, gi = tsk.iter_topk_min(torch.from_numpy(v), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_exact_lowest_index_ties(select_min):
    rng = np.random.default_rng(4)
    v = rng.integers(0, 5, (8, 257)).astype(np.float32)   # heavy ties
    ids = rng.permutation(8 * 257).reshape(8, 257).astype(np.int32)
    wv, wi = jsk.select_k(jnp.asarray(v), 12, select_min=select_min,
                          indices=jnp.asarray(ids))
    gv, gi = tsk.select_k(torch.from_numpy(v), 12, select_min=select_min,
                          indices=torch.from_numpy(ids))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [2, 4, 40, 300])
def test_select_k_exact_ranks_nan_as_jax_iter(select_min, k):
    """NaN ranks as +inf in a min-select and as -inf in a max-select (it
    is mapped to +inf before the select): the JAX package's ``iter``
    contract, which its TPU route runs. Rows from ``_rows``: NaN
    sprinkled, an all-NaN row, ±inf."""
    v = _rows(7)
    if k <= 4:
        v = np.array([[1, np.nan, 3, 2]], np.float32)
    wv, wi = jsk.select_k(jnp.asarray(v), k, select_min=select_min,
                          algo="iter")
    gv, gi = tsk.select_k(torch.from_numpy(v), k, select_min=select_min,
                          algo="exact")
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert not torch.isnan(gv).any()


def test_jax_cpu_exact_select_ranks_nan_first_in_a_max_select():
    """The named divergence (ROADMAP Queue 3, closed by decision): the JAX
    package's ``algo="exact"`` on the CPU is ``lax.top_k``, which ranks
    NaN above every number; the port keeps the ``iter`` order above."""
    v = np.array([[1, np.nan, 3, 2]], np.float32)
    jv, ji = jsk.select_k(jnp.asarray(v), 2, select_min=False, algo="exact")
    assert np.isnan(np.asarray(jv)[0, 0]) and np.asarray(jv)[0, 1] == 3
    np.testing.assert_array_equal(np.asarray(ji), [[1, 2]])
    gv, gi = tsk.select_k(torch.from_numpy(v), 2, select_min=False)
    np.testing.assert_array_equal(gv.numpy(), [[3, 2]])
    np.testing.assert_array_equal(gi.numpy(), [[2, 3]])
    jv, _ = jsk.select_k(jnp.asarray(v), 4, select_min=True, algo="exact")
    assert np.isnan(np.asarray(jv)[0, 3])
    gv, _ = tsk.select_k(torch.from_numpy(v), 4, select_min=True)
    assert float(gv[0, 3]) == float("inf")


def test_packed_zero_scores_stay_distinct():
    # the port orders packed values exactly, denormals included: ±0 scores
    # keep their own columns instead of collapsing into one pass
    v = torch.tensor([[0.0, -0.0, 0.0, 1.0, -0.0, 2.0]])
    vals, idx = tsk.iter_topk_min_packed(v, 6)
    assert sorted(idx[0].tolist()) == [0, 1, 2, 3, 4, 5]
    assert vals[0, :4].abs().max() == 0 and torch.isfinite(vals).all()


def test_select_k_rejects_bad_k():
    with pytest.raises(ValueError):
        tsk.select_k(torch.zeros(3, 4), 5)
