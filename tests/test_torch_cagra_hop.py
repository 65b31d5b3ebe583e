"""The fused CAGRA hop of the PyTorch port (K6's plain twin) against the JAX
package's ``fused_hop_reference`` and its Pallas kernel in interpret mode,
on the same numpy inputs.

With integer-valued ``qp`` every product and fp32 sum of the hop is exact,
so the twin must equal the reference bit for bit: ids, packed values and
visited flags. Scores stay away from zero: the JAX CPU oracle flushes the
denormals that packed scores near zero become (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import cagra_hop as jhop
from raft_tpu.ops.select_k import iter_topk_min_packed as jax_packed_select
from raft_tpu_torch.ops import cagra_hop as thop
from raft_tpu_torch.stats.metrics import topk_agreement

torch.set_num_threads(2)


def _case(rng, n, deg, p, q, w, itopk, frac_invalid=0.0, dup_heavy=False,
          integer=True, all_invalid=False):
    """A mid-traversal state as numpy arrays: a graph with -1 edges (ids
    from n/8 rows when ``dup_heavy``), an ascending buffer with +inf holes,
    random visited flags, parents with a ``frac_invalid`` share of -1."""
    hi = max(2, n // 8) if dup_heavy else n
    graph = rng.integers(0, hi, (n, deg)).astype(np.int32)
    graph[rng.random((n, deg)) < 0.1] = -1
    codes = rng.integers(-127, 128, (n, deg, p)).astype(np.int8)
    if integer:
        qp = rng.integers(-20, 21, (q, p)).astype(np.float32)
    else:
        qp = rng.normal(size=(q, p)).astype(np.float32) * 8
    scale = p * 5400.0          # ‖c‖² of random int8 codes
    buf_d = np.sort(scale + scale * 0.05 * rng.normal(size=(q, itopk)),
                    axis=1).astype(np.float32)
    buf_ids = rng.integers(0, n, (q, itopk)).astype(np.int32)
    empty = rng.random((q, itopk)) < 0.15
    buf_ids[empty] = -1
    buf_d[empty] = np.inf
    buf_vis = (rng.random((q, itopk)) < 0.5).astype(np.float32)
    parents = rng.integers(0, n, (q, w)).astype(np.int32)
    if frac_invalid:
        parents[rng.random((q, w)) < frac_invalid] = -1
    if all_invalid:
        parents[:] = -1
    return buf_ids, buf_d, buf_vis, parents, qp, graph, codes


def _torch(args):
    return [torch.from_numpy(a.copy()) for a in args]


def _assert_bitwise(got, want):
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("dup_heavy", [False, True])
def test_twin_is_bitwise_the_jax_kernel_and_reference(dup_heavy):
    """The cases of tests/test_cagra_hop.py (invalid parents, -1 edges,
    +inf holes; duplicate-heavy or not) with integer-valued qp."""
    rng = np.random.default_rng(3 if dup_heavy else 4)
    args = _case(rng, n=300, deg=8, p=16, q=32, w=3, itopk=24,
                 frac_invalid=0.25, dup_heavy=dup_heavy)
    got = thop.fused_hop_reference(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    _assert_bitwise(got, jhop.fused_hop_reference(*jargs))
    _assert_bitwise(got, jhop.fused_hop(*jargs, q_block=16, interpret=True))


@pytest.mark.parametrize("w,itopk", [(1, 32), (4, 64), (8, 96), (2, 40)])
def test_twin_is_bitwise_the_jax_reference_over_widths(w, itopk):
    """The bench's widths and buffer sizes at degree 16 (merge widths 48 to
    224, pack bits 6 to 8)."""
    rng = np.random.default_rng(10 + w)
    args = _case(rng, n=500, deg=16, p=32, q=24, w=w, itopk=itopk,
                 frac_invalid=0.1, dup_heavy=w == 8)
    _assert_bitwise(thop.fused_hop_reference(*_torch(args)),
                    jhop.fused_hop_reference(*[jnp.asarray(a) for a in args]))


def test_all_parents_invalid_is_noop():
    """A hop past a closed frontier returns the buffer (re-packed) and the
    JAX kernel's answer, so the chunked hop loop may over-run."""
    rng = np.random.default_rng(5)
    args = _case(rng, n=200, deg=4, p=8, q=16, w=2, itopk=16,
                 all_invalid=True)
    got = thop.fused_hop_reference(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    _assert_bitwise(got, jhop.fused_hop(*jargs, q_block=8, interpret=True))
    again = thop.fused_hop_reference(got[0], got[1], got[2],
                                     *_torch(args[3:]))
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    d = got[1].numpy()
    assert (np.diff(np.where(np.isinf(d), 1e30, d), axis=1) >= 0).all()


def test_real_valued_qp_within_tolerance():
    """Real-valued qp: fp32 sums in another order, values at rtol 5e-4,
    ids equal except at near-ties."""
    rng = np.random.default_rng(8)
    args = _case(rng, n=400, deg=8, p=16, q=32, w=4, itopk=32,
                 frac_invalid=0.1, integer=False)
    ti, td, tv = thop.fused_hop_reference(*_torch(args))
    ji, jd, jv = (torch.from_numpy(np.array(a)) for a in
                  jhop.fused_hop_reference(*[jnp.asarray(a) for a in args]))
    verdict = topk_agreement(jd, ji, td, ti, rtol=5e-4, atol=1e-3)
    assert verdict["ok"], verdict
    same = ti == ji
    assert torch.equal(tv[same], jv[same])


def test_twin_takes_chunks_of_rows(monkeypatch):
    """Row chunks (the bound on the twin's (rows, b, b) compare) change
    nothing."""
    rng = np.random.default_rng(9)
    args = _torch(_case(rng, n=300, deg=8, p=16, q=40, w=3, itopk=24,
                        frac_invalid=0.2))
    whole = thop.fused_hop_reference(*args)
    monkeypatch.setattr(thop, "_PLAIN_CHUNK_BYTES", 1)
    chunked = thop.fused_hop_reference(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_takes_the_twin_on_cpu_without_counting():
    rng = np.random.default_rng(11)
    args = _torch(_case(rng, n=100, deg=4, p=8, q=8, w=2, itopk=8))
    before = thop.HOP_KERNEL.launches
    got = thop.fused_hop(*args)
    assert thop.HOP_KERNEL.launches == before
    for a, b in zip(got, thop.fused_hop_reference(*args)):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(12)
    buf_ids, buf_d, buf_vis, parents, qp, graph, codes = _torch(
        _case(rng, n=100, deg=4, p=8, q=8, w=2, itopk=8))
    with pytest.raises(ValueError, match="nbr_codes"):
        thop.fused_hop(buf_ids, buf_d, buf_vis, parents, qp, graph,
                       codes[:, :, :4])
    with pytest.raises(ValueError, match="buf_d"):
        thop.fused_hop(buf_ids, buf_d[:, :4], buf_vis, parents, qp, graph,
                       codes)
    with pytest.raises(ValueError, match="itopk"):
        thop.fused_hop(buf_ids, buf_d, buf_vis,
                       torch.zeros((8, 600), dtype=torch.int32), qp, graph,
                       codes)
    # the checks a CUDA call makes before it launches (run here on CPU
    # tensors: they reject before any card is touched)
    with pytest.raises(TypeError, match="nbr_codes must be torch.int8"):
        thop.check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp, graph,
                                codes.to(torch.uint8))
    with pytest.raises(TypeError, match="parents must be torch.int32"):
        thop.check_hop_operands(buf_ids, buf_d, buf_vis, parents.long(), qp,
                                graph, codes)
    with pytest.raises(ValueError, match="contiguous"):
        thop.check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp,
                                graph.T.contiguous().T, codes)


def test_max_fused_rows_is_the_int32_id_bound():
    """K6 gathers with 64-bit addresses, so its bound is the int32 id, not
    the TPU kernel's 2**24 (fp32 one-hot extraction)."""
    assert thop.MAX_FUSED_ROWS == (1 << 31) - 1
    assert jhop.MAX_FUSED_ROWS == 1 << 24
    stats = thop.occupancy_stats(10_000, 32, 8, 64, 64, 96)
    assert stats["q_pad"] == 10_016      # what a 32-row grid would pad
    assert stats["candidates_per_query"] == 512
    # K6 sorts only the 512 candidates (16 keys a lane), not all 608 keys
    assert stats["merge_width"] == 608 and stats["sort_width"] == 512
    assert stats["code_bytes_per_query"] == 32_768
    # a warp a query, 4 a block: 10,000 queries take 2,500 blocks
    assert stats["warps_per_query"] == 1
    assert stats["queries_per_block"] == 4 and stats["blocks"] == 2500


@pytest.mark.parametrize("shape,why", [
    ((1_000_000, 64, 4, 64, 64), ""),             # the bench's fused rungs
    ((1_000_000, 96, 8, 64, 64), ""),
    ((1 << 31, 64, 4, 64, 64), "rows"),
    ((1000, 64, 32, 64, 64), "itopk"),            # merge past the sort width
    ((1000, 64, 15, 128, 128), "shared memory"),  # 240 KB of code records
])
def test_hop_shape_error_names_each_limit(shape, why):
    """The launcher's limits, named before a launch; the wrapper refuses
    the same shapes (the row bound is left out: it needs 2**31 rows)."""
    err = thop.hop_shape_error(*shape)
    if not why:
        assert err == ""
        return
    assert why in err
    if why != "rows":
        _, itopk, w, deg, p = shape
        with pytest.raises(ValueError, match=why):
            thop.fused_hop(torch.zeros((2, itopk), dtype=torch.int32),
                           torch.zeros((2, itopk)), torch.zeros((2, itopk)),
                           torch.zeros((2, w), dtype=torch.int32),
                           torch.zeros((2, p)),
                           torch.zeros((50, deg), dtype=torch.int32),
                           torch.zeros((50, deg, p), dtype=torch.int8))


# ---------------------------------------------------------------------------
# the picking mode: the hop picks its own parents
# ---------------------------------------------------------------------------


def _jax_pick_hop(args, w):
    """JAX's fused loop body for one hop (``cagra._fused_hop_chunk``): the
    packed pickup of the best ``w`` unvisited valid slots, marked visited,
    then ``fused_hop_reference``."""
    buf_ids, buf_d, buf_vis, _, qp, graph, codes = [jnp.asarray(a)
                                                    for a in args]
    itopk = buf_ids.shape[1]
    pkey = jnp.where((buf_vis > 0) | (buf_ids < 0), jnp.float32(jnp.inf),
                     buf_d)
    pv, ppos = jax_packed_select(pkey, w)
    parents = jnp.where(jnp.isinf(pv), -1,
                        jnp.take_along_axis(buf_ids, ppos, axis=1))
    picked = jnp.any(jnp.arange(itopk)[None, None, :] == ppos[:, :, None],
                     axis=1)
    vis = jnp.where(picked, jnp.float32(1.0), buf_vis)
    return parents, jhop.fused_hop_reference(buf_ids, buf_d, vis, parents,
                                             qp, graph, codes)


def _pick(args, w):
    """The port's picking hop (the twin on these CPU tensors)."""
    buf_ids, buf_d, buf_vis, _, qp, graph, codes = _torch(args)
    return thop.fused_hop(buf_ids, buf_d, buf_vis, None, qp, graph, codes,
                          width=w)


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("itopk", [32, 64, 96])
def test_picking_twin_is_bitwise_jax_pickup_and_reference(w, itopk):
    """Without parents the hop picks them as JAX's loop body does: the
    packed select over itopk columns, -1 where the pick is +inf, the picks
    marked visited; then the hop, bit for bit on integer-valued qp."""
    rng = np.random.default_rng(100 + 10 * w + itopk)
    args = _case(rng, n=500, deg=16, p=32, q=24, w=w, itopk=itopk,
                 dup_heavy=w == 8)
    parents, want = _jax_pick_hop(args, w)
    _assert_bitwise(_pick(args, w), want)
    vis, got_parents = thop.pick_parents(*_torch(args)[:3], w)
    np.testing.assert_array_equal(got_parents.numpy(), np.asarray(parents))


def test_picking_twin_is_jax_fused_loop_body():
    """The same hop against JAX's own loop body, ``_fused_hop_chunk`` run
    for one hop with its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(31)
    w, itopk = 4, 32
    args = _case(rng, n=300, deg=8, p=16, q=16, w=w, itopk=itopk)
    buf_ids, buf_d, buf_vis, _, qp, graph, codes = [jnp.asarray(a)
                                                    for a in args]
    ids, d, vis, hops = jcagra._fused_hop_chunk(
        graph, codes, qp, buf_ids, buf_d, buf_vis, jnp.int32(0),
        jnp.int32(1), itopk=itopk, width=w, min_iter=1, q_block=8,
        interpret=True)
    assert int(hops) == 1
    _assert_bitwise(_pick(args, w), (ids, d, vis))


def test_picking_skips_holes_and_runs_out_of_parents():
    """A buffer that is mostly -1 holes: holes are never picked, and a row
    with fewer than ``w`` unvisited valid slots gets -1 parents (whose
    picked slots are marked visited all the same)."""
    rng = np.random.default_rng(32)
    w, itopk = 8, 32
    args = list(_case(rng, n=400, deg=16, p=32, q=24, w=w, itopk=itopk))
    holes = rng.random((24, itopk)) < 0.7
    args[0][holes] = -1
    args[1][holes] = np.inf
    parents, want = _jax_pick_hop(args, w)
    parents = np.asarray(parents)
    assert (parents == -1).any() and (parents >= 0).any()
    _assert_bitwise(_pick(args, w), want)


def test_picking_all_visited_is_a_noop():
    """Every slot visited: every parent is -1 and the hop returns the
    buffer re-packed, as JAX's; a second hop changes nothing."""
    rng = np.random.default_rng(33)
    args = list(_case(rng, n=200, deg=8, p=16, q=16, w=4, itopk=32))
    args[2][:] = 1.0
    parents, want = _jax_pick_hop(args, 4)
    assert (np.asarray(parents) == -1).all()
    got = _pick(args, 4)
    _assert_bitwise(got, want)
    again = thop.fused_hop(*got, None, *_torch(args[4:]), width=4)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_picking_tie_order():
    """Equal distances everywhere (the buffer, and candidates whose code
    records are one repeated row): the pickup and the merge break ties by
    column, lowest first, as JAX's packed select does."""
    rng = np.random.default_rng(34)
    args = list(_case(rng, n=300, deg=8, p=16, q=16, w=4, itopk=32))
    args[1][np.isfinite(args[1])] = 86_400.0
    args[6][:] = args[6][0, 0]
    parents, want = _jax_pick_hop(args, 4)
    got = _pick(args, 4)
    _assert_bitwise(got, want)
    # each row holds at most two distinct values: every slot was a tie
    for row in got[1].numpy():
        assert len(np.unique(row[np.isfinite(row)])) <= 2


def test_picking_real_valued_qp_within_tolerance():
    rng = np.random.default_rng(35)
    args = _case(rng, n=400, deg=8, p=16, q=32, w=4, itopk=64,
                 integer=False)
    ti, td, tv = _pick(args, 4)
    _, want = _jax_pick_hop(args, 4)
    ji, jd, jv = (torch.from_numpy(np.array(a)) for a in want)
    verdict = topk_agreement(jd, ji, td, ti, rtol=5e-4, atol=1e-3)
    assert verdict["ok"], verdict
    same = ti == ji
    assert torch.equal(tv[same], jv[same])


def test_picking_width_past_itopk_takes_every_slot():
    """The packed select returns at most itopk slots, so a width past
    itopk expands every slot, as a width of itopk does."""
    rng = np.random.default_rng(36)
    args = _case(rng, n=200, deg=4, p=8, q=8, w=2, itopk=8)
    for a, b in zip(_pick(args, 11), _pick(args, 8)):
        assert torch.equal(a, b)


def test_picking_wrapper_needs_a_width_and_counts_nothing_on_cpu():
    rng = np.random.default_rng(37)
    buf_ids, buf_d, buf_vis, _, qp, graph, codes = _torch(
        _case(rng, n=100, deg=4, p=8, q=8, w=2, itopk=8))
    with pytest.raises(ValueError, match="width"):
        thop.fused_hop(buf_ids, buf_d, buf_vis, None, qp, graph, codes)
    before = thop.HOP_KERNEL.launches
    got = thop.fused_hop(buf_ids, buf_d, buf_vis, None, qp, graph, codes,
                         width=2)
    assert thop.HOP_KERNEL.launches == before
    vis, parents = thop.pick_parents(buf_ids, buf_d, buf_vis, 2)
    for a, b in zip(got, thop.fused_hop_reference(buf_ids, buf_d, vis,
                                                  parents, qp, graph,
                                                  codes)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_picking_kernel_matches_plain_twin_on_card():
    """K6's picking entry against its twin on the card, bitwise on
    integer-valued qp: an unsorted buffer with holes, then the sorted
    buffer the first hop returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6 is CUDA code with no CPU mode")
    rng = np.random.default_rng(22)
    buf_ids, buf_d, buf_vis, _, qp, graph, codes = [
        t.cuda() for t in _torch(_case(rng, n=2000, deg=64, p=64, q=64, w=4,
                                       itopk=64, dup_heavy=True))]
    state = (buf_ids, buf_d, buf_vis)
    for _ in range(2):
        got = thop.fused_hop(*state, None, qp, graph, codes, width=4)
        want = thop.fused_hop_reference(*state, None, qp, graph, codes,
                                        width=4)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        state = got


@pytest.mark.cuda
def test_kernel_matches_plain_twin_on_card():
    """K6 against its plain twin on the card (runs where there is one):
    bitwise on integer-valued qp, with duplicate ids and invalid parents."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K6 is CUDA code with no CPU mode")
    rng = np.random.default_rng(21)
    args = [t.cuda() for t in _torch(_case(rng, n=2000, deg=64, p=64, q=64,
                                           w=4, itopk=64, frac_invalid=0.2,
                                           dup_heavy=True))]
    got = thop.fused_hop(*args)
    want = thop.fused_hop_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
