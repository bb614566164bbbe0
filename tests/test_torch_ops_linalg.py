"""The port's linear-algebra ops (``mxnet_tpu_torch/ops/linalg.py``)
against the JAX package's (``mxnet_tpu/ops/linalg.py``) on the CPU, under
both names of each (``_linalg_*``, ``linalg_*``): forward values and
input gradients (``jax.vjp``) from the same numpy inputs at ``rtol=1e-5,
atol=1e-6`` unless a case states a wider tolerance with its reason.
``gelqf`` and ``syevd`` are held by what does not depend on the solver's
signs (L·Q and Vᵀ·diag(w)·V, orthogonality, the eigenvalues) and by the
entries themselves, after aligning each row's sign."""
import numpy as np
import pytest

from torch_parity import hold, port_run, jax_run, rand

# products of several factorizations: their float32 rounding adds up
FACT = dict(rtol=2e-5, atol=2e-5)


def _spd(seed, b=2, n=4):
    a = rand(seed, b, n, n)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)) \
        .astype(np.float32)


def _tri(seed, lower=True, b=2, n=4):
    a = rand(seed, b, n, n) * 0.3 + 2.0 * np.eye(n, dtype=np.float32)
    return (np.tril(a) if lower else np.triu(a)).astype(np.float32)


@pytest.mark.parametrize("prefix", ["_linalg_", "linalg_"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_gemm2(prefix, ta, tb):
    a = rand(1, 2, 3, 4) if not ta else rand(1, 2, 4, 3)
    b = rand(2, 2, 4, 5) if not tb else rand(2, 2, 5, 4)
    attrs = {"transpose_a": ta, "transpose_b": tb, "alpha": 0.7}
    hold(prefix + "gemm2", [a, b], attrs)
    hold(prefix + "gemm", [a, b, rand(3, 2, 3, 5)], dict(attrs, beta=-1.3))


@pytest.mark.parametrize("prefix", ["_linalg_", "linalg_"])
@pytest.mark.parametrize("lower", [True, False])
def test_potrf_potri(prefix, lower):
    hold(prefix + "potrf", [_spd(4)], {"lower": lower}, tol=FACT)
    hold(prefix + "potri", [_tri(5, lower)], {"lower": lower}, tol=FACT)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_trsm_trmm(transpose, rightside, lower):
    attrs = {"transpose": transpose, "rightside": rightside,
             "lower": lower, "alpha": 1.5}
    # the off-triangle entries must not be read: fill them with noise
    a = _tri(6, lower) + (np.triu(rand(7, 2, 4, 4), 1) if lower
                          else np.tril(rand(7, 2, 4, 4), -1))
    b = rand(8, 2, 4, 3) if not rightside else rand(8, 2, 3, 4)
    hold("_linalg_trsm", [a, b], attrs, tol=FACT)
    hold("linalg_trmm", [a, b], attrs)


@pytest.mark.parametrize("transpose", [False, True])
def test_syrk(transpose):
    hold("linalg_syrk", [rand(9, 2, 3, 5)], {"transpose": transpose,
                                             "alpha": 2.0})


@pytest.mark.parametrize("offset", [0, 1, -2])
def test_diag_ops(offset):
    hold("linalg_extractdiag", [rand(10, 2, 4, 4)], {"offset": offset})
    hold("_linalg_makediag", [rand(11, 2, 3)], {"offset": offset})
    for lower in (True, False):
        off = offset if (offset <= 0) == lower or offset == 0 else -offset
        hold("linalg_extracttrian", [rand(12, 2, 4, 4)],
             {"offset": off, "lower": lower})


def test_sumlogdiag():
    hold("linalg_sumlogdiag", [_spd(13)])


@pytest.mark.parametrize("name", ["inverse", "det"])
def test_inverse_and_det(name):
    hold("linalg_" + name, [_spd(14)], tol=FACT)
    hold("_linalg_" + name, [rand(15, 3, 3, 3)], tol=FACT,
         gtol=dict(rtol=1e-4, atol=1e-5))


def test_slogdet():
    a = rand(16, 3, 4, 4)
    hold("linalg_slogdet", [a], tol=FACT, gtol=dict(rtol=1e-4, atol=1e-5))


def _row_signs(got, want, axis=-1):
    """Per-row signs that align ``got``'s rows with ``want``'s."""
    s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return np.where(s == 0, 1, s)


@pytest.mark.parametrize("shape", [(2, 3, 5), (2, 4, 4)])
def test_gelqf_by_products_and_aligned_entries(shape):
    a = rand(17, *shape)
    (jl, jq), _ = jax_run("linalg_gelqf", [a], {})
    (pl, pq), _ = port_run("linalg_gelqf", [a], {})
    np.testing.assert_allclose(pl @ pq, a, **FACT)
    eye = np.broadcast_to(np.eye(shape[1], dtype=np.float32), pq.shape[:1]
                          + (shape[1], shape[1]))
    np.testing.assert_allclose(pq @ pq.transpose(0, 2, 1), eye, atol=2e-6)
    np.testing.assert_array_equal(np.triu(pl, 1), 0.0)
    s = _row_signs(pq, jq)              # rows of Q, columns of L
    np.testing.assert_allclose(pq * s, jq, **FACT)
    np.testing.assert_allclose(pl * s.transpose(0, 2, 1), jl, **FACT)


def test_gelqf_on_the_host_shares_lapacks_signs():
    """On the CPU both packages reach LAPACK's geqrf, so even the signs
    agree: entries and gradients held directly."""
    hold("linalg_gelqf", [rand(18, 2, 3, 5)], tol=FACT,
         gtol=dict(rtol=1e-4, atol=1e-5))


def test_syevd_gradient_with_the_signs_aligned():
    """An eigenvector's sign is free: where the port's row is the JAX
    row times s, the port's gradient under head H equals JAX's under
    s·H."""
    a = _spd(22, n=4)
    (jv, _), jg = jax_run("linalg_syevd", [a], {}, grad=True)
    hv, hw = rand(23, 2, 4, 4), rand(24, 2, 4)
    (pv, _), pg = port_run("linalg_syevd", [a], {}, heads=[hv, hw])
    s = _row_signs(pv, jv)
    # eigenvector gradients divide by eigenvalue gaps, which amplify
    # float32 rounding
    np.testing.assert_allclose(pg[0], jg([hv * s, hw])[0], rtol=1e-3,
                               atol=1e-4)


def test_syevd_by_products_and_aligned_entries():
    a = _spd(19, n=5)
    (jv, jw), _ = jax_run("linalg_syevd", [a], {})
    (pv, pw), _ = port_run("linalg_syevd", [a], {})
    np.testing.assert_allclose(pw, jw, **FACT)
    recon = pv.transpose(0, 2, 1) @ (pw[..., :, None] * pv)
    np.testing.assert_allclose(recon, a, rtol=2e-5, atol=1e-4)
    eye = np.broadcast_to(np.eye(5, dtype=np.float32), pv.shape)
    np.testing.assert_allclose(pv @ pv.transpose(0, 2, 1), eye, atol=2e-6)
    np.testing.assert_allclose(pv * _row_signs(pv, jv), jv,
                               rtol=1e-4, atol=1e-5)


def test_syevd_eigenvalue_gradient():
    """The eigenvalues' gradient does not depend on the vectors' signs
    (the head on the vectors is zero)."""
    a = _spd(20, n=4)
    heads = [np.zeros((2, 4, 4), np.float32), rand(21, 2, 4)]
    _, jg = jax_run("linalg_syevd", [a], {}, grad=True)
    _, pg = port_run("linalg_syevd", [a], {}, heads=heads)
    np.testing.assert_allclose(pg[0], jg(heads)[0], rtol=1e-4, atol=1e-5)
