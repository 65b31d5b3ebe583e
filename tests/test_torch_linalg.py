"""Port parity: ``raft_tpu_torch.ops.{linalg,matrix,kernels}`` against the
JAX package on the same numpy inputs (``device="cpu"``).

Tolerances: integer results exact; elementwise fp32 at rtol 1e-6; products
and reductions at rtol 1e-5 (fp32 sums in another order); bf16 results
within one bf16 step (2⁻⁸ relative). Decompositions are held by their
contract: ``qr`` by Q·R = A, orthonormal Q, upper-triangular R and JAX's R
up to row signs; ``svd`` to JAX's u and s at rtol 1e-4 and its vt with the
rows flipped; ``rsvd`` (whose ``omega`` torch cannot draw from
``jax.random``) by invariants on a decaying spectrum; ``lstsq`` to JAX's
minimum-norm solution, rank-deficient inputs included; ``lanczos`` to
``numpy.linalg.eigvalsh``'s smallest eigenvalues.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import kernels as jk
from raft_tpu.ops import linalg as jl
from raft_tpu.ops import matrix as jm
from raft_tpu_torch.ops import kernels as tk
from raft_tpu_torch.ops import linalg as tl
from raft_tpu_torch.ops import matrix as tm
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.sparse import csr_from_dense

torch.set_num_threads(2)
CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(seed, shape=(300, 24), dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# -- gemm, dot, axpy, norms, reductions ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True)])
def test_gemm_equals_jax(dtype, ta, tb):
    rng = np.random.default_rng(1)
    a = rng.integers(-9, 10, (40, 30)) if dtype == "int8" else \
        rng.standard_normal((40, 30))
    b = rng.integers(-9, 10, (30, 20)) if dtype == "int8" else \
        rng.standard_normal((30, 20))
    a = a.T.copy() if ta else a
    b = b.T.copy() if tb else b
    alpha = 1.0 if dtype == "int8" else 0.75
    ja = jnp.asarray(a, dtype)
    jb = jnp.asarray(b, dtype)
    want = np.asarray(jl.gemm(ja, jb, ta, tb, alpha=alpha).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tl.gemm(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt),
                  ta, tb, alpha=alpha, device=CPU)
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gemm_beta_c_dot_axpy_equal_jax():
    a, b, c = _rows(2, (30, 16)), _rows(3, (16, 12)), _rows(4, (30, 12))
    np.testing.assert_allclose(
        tl.gemm(a, b, alpha=2.0, beta=0.5, c=c, device=CPU).numpy(),
        np.asarray(jl.gemm(a, b, alpha=2.0, beta=0.5, c=c)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(tl.dot(a, b, device=CPU).numpy(),
                               np.asarray(jl.dot(a, b)), rtol=1e-5, atol=1e-5)
    v = _rows(5, (16,))
    np.testing.assert_allclose(tl.dot(v, v, device=CPU).numpy(),
                               np.asarray(jl.dot(v, v)), rtol=1e-5)
    np.testing.assert_allclose(tl.axpy(0.3, a, c[:, :1], device=CPU).numpy(),
                               np.asarray(jl.axpy(0.3, a, c[:, :1])),
                               rtol=1e-6)


@pytest.mark.parametrize("norm_type", ["l1", "l2", "sql2", "linf"])
@pytest.mark.parametrize("axis", [0, 1])
def test_norm_and_normalize_equal_jax(norm_type, axis):
    x = _rows(6)
    np.testing.assert_allclose(tl.norm(x, norm_type, axis, device=CPU).numpy(),
                               np.asarray(jl.norm(x, norm_type, axis)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        tl.normalize(x, norm_type, axis, device=CPU).numpy(),
        np.asarray(jl.normalize(x, norm_type, axis)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("op", ["sum", "min", "max", "mean"])
@pytest.mark.parametrize("axis", [0, 1])
def test_reduce_equals_jax(op, axis):
    x = _rows(7)
    np.testing.assert_allclose(tl.reduce(x, axis, op, device=CPU).numpy(),
                               np.asarray(jl.reduce(x, axis, op)), rtol=1e-5,
                               atol=1e-6)
    got = tl.reduce(x, axis, op, main_op=torch.abs, device=CPU).numpy()
    want = np.asarray(jl.reduce(x, axis, op, main_op=jnp.abs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _keys(seed, m, n_keys):
    """Keys in range plus some below 0 and at or past ``n_keys``, which
    ``jax.nn.one_hot`` maps to all-zero rows."""
    k = np.random.default_rng(seed).integers(-3, n_keys + 3, m)
    return k.astype(np.int32)


@pytest.mark.parametrize("n_keys", [1, 7, 64])
def test_keyed_reductions_equal_jax(n_keys):
    x = _rows(8, (500, 12))
    rk = _keys(9, 500, n_keys)
    np.testing.assert_allclose(
        tl.reduce_rows_by_key(x, rk, n_keys, device=CPU).numpy(),
        np.asarray(jl.reduce_rows_by_key(x, rk, n_keys)), rtol=1e-5,
        atol=1e-5)
    ck = _keys(10, 12, n_keys)
    np.testing.assert_allclose(
        tl.reduce_cols_by_key(x, ck, n_keys, device=CPU).numpy(),
        np.asarray(jl.reduce_cols_by_key(x, ck, n_keys)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(
        tl.bincount(rk, n_keys, device=CPU).numpy(),
        np.asarray(jl.bincount(jnp.asarray(rk), n_keys)))
    w = _rows(11, (500,))
    np.testing.assert_allclose(
        tl.bincount(rk, n_keys, weights=w, device=CPU).numpy(),
        np.asarray(jl.bincount(jnp.asarray(rk), n_keys, weights=w)),
        rtol=1e-5, atol=1e-5)


def test_keyed_reduction_is_the_same_bits_every_call():
    x = torch.from_numpy(_rows(12, (2000, 8)))
    k = torch.from_numpy(_keys(13, 2000, 16))
    first = tl.reduce_rows_by_key(x, k, 16, device=CPU)
    for _ in range(3):
        assert torch.equal(tl.reduce_rows_by_key(x, k, 16, device=CPU), first)


@pytest.mark.parametrize("axis", [0, 1])
def test_matrix_vector_op_equals_jax(axis):
    x = _rows(14, (20, 6))
    v = _rows(15, (6 if axis == 1 else 20,))
    for top, jop in ((torch.add, jnp.add), (torch.mul, jnp.multiply)):
        np.testing.assert_allclose(
            tl.matrix_vector_op(x, v, axis, top, device=CPU).numpy(),
            np.asarray(jl.matrix_vector_op(x, v, axis, jop)), rtol=1e-6)


# -- decompositions -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(50, 8), (8, 8), (300, 24)])
def test_qr_contract_and_jax_r_up_to_row_signs(shape):
    a = _rows(16, shape)
    q, r = tl.qr(a, device=CPU)
    qn, rn = q.double().numpy(), r.double().numpy()
    np.testing.assert_allclose(qn @ rn, a, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(qn.T @ qn, np.eye(shape[1]), atol=1e-5)
    assert np.array_equal(np.triu(rn), rn)
    jr = np.asarray(jl.qr(jnp.asarray(a))[1])
    signs = np.sign(np.diag(jr)) * np.sign(np.diag(rn))
    np.testing.assert_allclose(rn * signs[:, None], jr, rtol=1e-4,
                               atol=1e-4 * np.abs(jr).max())


def _raw_signs(u):
    """sign_flip's sign per column of a raw u."""
    idx = np.argmax(np.abs(u), axis=0)
    s = np.sign(u[idx, np.arange(u.shape[1])])
    return np.where(s == 0, 1.0, s)


def test_svd_flips_vt_with_u_which_jax_does_not():
    """Queue 3's reference fault, repaired on the port's side: the JAX
    package's ``svd`` applies ``sign_flip`` to the columns of u and leaves
    the rows of vt, so its factors stop rebuilding the input whenever a
    column flips (here 4 of 8 by LAPACK's raw signs on this machine; max
    error 4.99)."""
    a = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    ju, js, jvt = (np.asarray(t) for t in jl.svd(jnp.asarray(a)))
    raw_u, _, raw_vt = (np.asarray(t) for t in jnp.linalg.svd(
        jnp.asarray(a), full_matrices=False))
    np.testing.assert_array_equal(jvt, raw_vt)       # JAX leaves vt as is
    signs = _raw_signs(raw_u)
    assert bool((signs < 0).any())
    u, s, vt = (t.numpy() for t in tl.svd(a, device=CPU))
    np.testing.assert_allclose(u, ju, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s, js, rtol=1e-4)
    np.testing.assert_allclose(vt, jvt * signs[:, None], rtol=1e-4,
                               atol=1e-5)
    norm = np.linalg.norm(a)
    assert np.abs(u * s @ vt - a).max() <= 1e-4 * norm
    jax_err = np.abs(ju * js @ jvt - a).max()
    assert jax_err > 4.9, jax_err                    # the reference fault


def test_svd_full_matrices_rebuilds():
    a = _rows(17, (12, 30))
    u, s, vt = tl.svd(a, full_matrices=True, device=CPU)
    assert tuple(u.shape) == (12, 12) and tuple(vt.shape) == (30, 30)
    rebuilt = (u * s) @ vt[:12]
    assert float((rebuilt - torch.from_numpy(a)).abs().max()) \
        <= 1e-4 * np.linalg.norm(a)


def _decaying(seed, m=400, n=60):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 10.0 * 0.7 ** np.arange(n)
    return ((u * s) @ v.T).astype(np.float32)


def _truncated(a, k):
    u, s, vt = np.linalg.svd(a.astype(np.float64), full_matrices=False)
    return s, (u[:, :k] * s[:k]) @ vt[:k]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rsvd_invariants_on_a_decaying_spectrum(seed):
    """rsvd(k=4, p=4) of a 400 × 60 matrix with singular values 10·0.7^i:
    s within rtol 1e-3 of the exact top 4 (JAX's too), the rank-4 rebuild
    within 1e-3·‖a‖ of the truncated SVD's."""
    a = _decaying(seed)
    exact_s, trunc = _truncated(a, 4)
    gen = torch.Generator().manual_seed(seed)
    u, s, vt = (t.double().numpy() for t in tl.rsvd(a, 4, p=4, generator=gen,
                                                      device=CPU))
    np.testing.assert_allclose(s, exact_s[:4], rtol=1e-3)
    assert np.abs(u * s @ vt - trunc).max() <= 1e-3 * np.linalg.norm(a)
    js = np.asarray(jl.rsvd(jnp.asarray(a), 4, p=4,
                            key=jax.random.key(seed))[1])
    np.testing.assert_allclose(js, exact_s[:4], rtol=1e-3)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rsvd_flips_vt_with_u_which_jax_does_not(seed):
    """Queue 3's reference fault in ``rsvd``: on ``default_rng(0)`` 50 × 8
    at k 4, p 4 (the range finder spans the whole row space, so the rank-4
    factors are exact), the JAX package's factors miss the rank-4
    truncation by 2.93, 3.45 and 6.06 at keys 1, 2 and 3; the port's
    rebuild it within 1e-4·‖a‖."""
    a = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    _, trunc = _truncated(a, 4)
    gen = torch.Generator().manual_seed(seed)
    u, s, vt = (t.double().numpy() for t in tl.rsvd(a, 4, p=4, generator=gen,
                                                      device=CPU))
    assert np.abs(u * s @ vt - trunc).max() <= 1e-4 * np.linalg.norm(a)
    ju, js, jvt = (np.asarray(t, np.float64) for t in jl.rsvd(
        jnp.asarray(a), 4, p=4, key=jax.random.key(seed)))
    assert np.abs(ju * js @ jvt - trunc).max() > 1.0


@pytest.mark.parametrize("shape,rank", [((60, 8), 8), ((60, 8), 5),
                                        ((6, 10), 6)])
@pytest.mark.parametrize("vector_b", [True, False])
def test_lstsq_is_the_minimum_norm_solution_as_jax(shape, rank, vector_b):
    rng = np.random.default_rng(18)
    m, n = shape
    a = (rng.standard_normal((m, rank)) @ rng.standard_normal((rank, n))
         ).astype(np.float32)
    b = rng.standard_normal((m,) if vector_b else (m, 3)).astype(np.float32)
    got = tl.lstsq(a, b, device=CPU).numpy()
    want = np.asarray(jl.lstsq(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
    ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=np.finfo(np.float32).eps * max(m, n))[0]
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


def _spd(seed, n=64):
    """An SPD matrix; the Lanczos runs take the full Krylov space
    (``max_iters = n``), where the eigenvalues are exact to fp32."""
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (g @ g.T / n + np.diag(np.linspace(0.1, 2.0, n))).astype(np.float32)


@pytest.mark.parametrize("form", ["dense", "csr", "matvec"])
def test_lanczos_smallest_eigenvalues(form):
    a = _spd(19)
    want = np.linalg.eigvalsh(a.astype(np.float64))[:3]
    n = a.shape[0]
    if form == "dense":
        got = tl.lanczos(a, 3, max_iters=n, device=CPU)
        jw = np.asarray(jl.lanczos(jnp.asarray(a), 3, max_iters=n)[0])
    elif form == "csr":
        got = tl.lanczos(csr_from_dense(a, device=CPU), 3, max_iters=n,
                         device=CPU)
        jw = None
    else:
        ta = torch.from_numpy(a)
        got = tl.lanczos(lambda v: ta @ v, 3, n=n, max_iters=n, device=CPU)
        jw = None
    w, v = got
    np.testing.assert_allclose(w.numpy(), want, rtol=1e-4)
    if jw is not None:
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4)
    resid = a @ v.numpy() - v.numpy() * w.numpy()[None, :]
    assert np.abs(resid).max() < 1e-3


# -- matrix ops ---------------------------------------------------------------

def _tied(seed):
    return np.random.default_rng(seed).integers(0, 5, (40, 17)).astype(
        np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_argmax_argmin_equal_jax(axis):
    x = _tied(20)
    for tf, jf in ((tm.argmax, jm.argmax), (tm.argmin, jm.argmin)):
        got = tf(x, axis, device=CPU)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf(x, axis)))


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_cols_per_row_is_stable_as_jax(ascending):
    x = _tied(21)
    gv, gi = tm.sort_cols_per_row(x, ascending, device=CPU)
    jv, ji = jm.sort_cols_per_row(x, ascending)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    assert gi.dtype == torch.int32


def test_matrix_ops_equal_jax():
    x = _rows(22, (30, 6))
    ids = np.array([4, 0, 29, 4], np.int32)
    np.testing.assert_array_equal(tm.gather(x, ids, device=CPU).numpy(),
                                  np.asarray(jm.gather(x, ids)))
    up = _rows(23, (2, 6))
    np.testing.assert_array_equal(
        tm.scatter(x, [3, 7], up, device=CPU).numpy(),
        np.asarray(jm.scatter(x, np.array([3, 7]), up)))
    np.testing.assert_array_equal(
        tm.slice_matrix(x, (2, 9), (1, 4), device=CPU).numpy(),
        np.asarray(jm.slice_matrix(x, (2, 9), (1, 4))))
    v = _rows(24, (6,))
    np.testing.assert_allclose(
        tm.linewise_op(x, v, device=CPU).numpy(),
        np.asarray(jm.linewise_op(x, v)), rtol=1e-6)
    w = _rows(25, (30,))
    np.testing.assert_allclose(
        tm.linewise_op(x, w, along_rows=False, op=torch.add,
                       device=CPU).numpy(),
        np.asarray(jm.linewise_op(x, w, along_rows=False, op=jnp.add)),
        rtol=1e-6)
    t = torch.from_numpy(x)
    c = tm.copy(t, device=CPU)
    assert torch.equal(c, t) and c.data_ptr() != t.data_ptr()
    for axis in (0, 1):
        np.testing.assert_array_equal(tm.reverse(x, axis, device=CPU).numpy(),
                                      np.asarray(jm.reverse(x, axis)))
    np.testing.assert_array_equal(
        tm.init_constant((3, 4), 2.5, device=CPU).numpy(),
        np.asarray(jm.init_constant((3, 4), 2.5)))


# -- Gram kernels -------------------------------------------------------------

@pytest.mark.parametrize("kernel,kw", [
    ("linear_kernel", {}), ("polynomial_kernel", {"degree": 2, "gain": 0.5,
                                                  "offset": 1.0}),
    ("tanh_kernel", {"gain": 0.1, "offset": -0.2}),
    ("rbf_kernel", {"gain": 0.05})])
def test_gram_kernels_equal_jax(kernel, kw):
    x, y = _rows(26, (120, 16)), _rows(27, (90, 16))
    got = getattr(tk, kernel)(x, y, device=CPU, **kw).numpy()
    want = np.asarray(getattr(jk, kernel)(x, y, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("workspace", [1 << 30, 4096])
def test_masked_l2_nn_equals_jax(sqrt, workspace):
    """Integer rows (exact squared distances, many ties), a row that
    admits nothing, and tiles of a few rows under a small workspace."""
    rng = np.random.default_rng(28)
    x = rng.integers(-3, 4, (70, 5)).astype(np.float32)
    y = rng.integers(-3, 4, (50, 5)).astype(np.float32)
    groups = rng.integers(0, 6, 50).astype(np.int32)
    adj = rng.random((70, 6)) < 0.4
    adj[3] = False
    gv, gi = tk.masked_l2_nn(x, y, adj, groups, sqrt=sqrt,
                             res=Resources(device=CPU,
                                           workspace_bytes=workspace))
    jv, ji = jk.masked_l2_nn(x, y, adj, groups, sqrt=sqrt)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    assert gi.dtype == torch.int32 and int(gi[3]) == -1
    with pytest.raises(ValueError):
        tk.masked_l2_nn(x, y, adj, groups[:3], device=CPU)
