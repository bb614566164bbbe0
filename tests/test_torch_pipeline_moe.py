"""The port's pipeline (``pp``) and routed MoE (``ep``) against the JAX
package (``tests/test_pipeline_moe.py``'s six non-dryrun oracles), on
the same numpy inputs:

- ``pipeline_apply`` over four gloo ranks as ``{pp: 2, dp: 2}``: each
  rank's rows of the output against JAX's on a mesh of the same sizes
  (rtol = atol = 2e-5), the gradients of ``sum(out ** 2)`` against
  ``jax.grad`` of JAX's ``pipeline_apply`` (rtol 1e-4, atol 1e-5), the
  whole stage stack against this rank's piece, and the ``n_micro``
  ``ValueError`` over ``{pp: 4}``;
- ``topk_route``'s dispatch and combine exactly and its aux loss (a
  tie, a capacity that drops claims, k = 1 and 2), ``load_balance_
  loss``, and ``moe_ffn`` with its gradients at ``mesh=None``;
- ``moe_ffn`` over ``{dp: 2, tp: 2}`` (``ep_axis="tp"``, capacity factor
  1.0, so claims drop) against JAX's on the global array: this rank's
  rows of the output, the aux loss, and the gradients of ``sum(out **
  2) + 0.01 * aux``;
- the autograd collectives the two build on (``copy_to_axis``,
  ``reduce_from_axis``, ``psum``, ``gather_from_axis`` with either
  backward, ``ppermute_grad``) exactly, on integer-valued data."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar

import torch_mesh_ranks as h

PIPE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return h.spawn(tmp_path_factory.mktemp("pipeline_moe"), "pipeline_moe",
                   4)


def _no_errors(results, prefix):
    errs = h.errors(results, prefix)
    assert not errs, "\n".join(errs)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.create_mesh(axes, devices=jax.devices()[:n])


def _jstage(p, x):
    w, b = p
    return jnp.tanh(x @ w + b)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    """JAX's pipeline output and gradients on the same inputs."""
    mesh = _jmesh({"pp": 2, "dp": 2})
    w, b, x = (jnp.asarray(a) for a in h.pipe_data())

    def run(w, b, x):
        return jpar.pipeline_apply(_jstage, (w, b), x, mesh=mesh, axis="pp",
                                   mb_spec=JP(None, "dp", None))
    out = run(w, b, x)
    grads = jax.grad(lambda w, b, x: jnp.sum(run(w, b, x) ** 2),
                     argnums=(0, 1, 2))(w, b, x)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_pipeline_matches_jax(ranks, jax_pipe):
    _no_errors(ranks, "check_pipeline_apply")
    out, _ = jax_pipe
    w, b, x = h.pipe_data()
    want = x
    for s in range(2):
        want = np.tanh(want @ w[s] + b[s])
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    for r in ranks:
        stage, d = r["pipe_apply/coords"]
        np.testing.assert_allclose(r["pipe_apply/out"],
                                   out[:, 2 * d:2 * d + 2], **PIPE_TOL)
        # the whole stage stack and this rank's piece give the same bits
        np.testing.assert_array_equal(r["pipe_apply/stacked"],
                                      r["pipe_apply/out"])


def test_pipeline_gradients_match_jax(ranks, jax_pipe):
    _, (dw, db, dx) = jax_pipe
    for r in ranks:
        stage, d = r["pipe_apply/coords"]
        np.testing.assert_allclose(r["pipe_apply/dw"][0], dw[stage],
                                   **GRAD_TOL)
        np.testing.assert_allclose(r["pipe_apply/db"][0], db[stage],
                                   **GRAD_TOL)
        np.testing.assert_allclose(r["pipe_apply/dx"],
                                   dx[:, 2 * d:2 * d + 2], **GRAD_TOL)


def test_too_few_microbatches_raises(ranks):
    _no_errors(ranks, "check_pipeline_n_micro")
    with pytest.raises(ValueError, match="n_micro"):
        jpar.pipeline_apply(lambda w, x: x @ w, jnp.zeros((4, 4, 4)),
                            jnp.zeros((2, 2, 4)), mesh=_jmesh({"pp": 4}),
                            axis="pp")
    for r in ranks:
        kind, msg = r["pipe_micro"]
        assert kind == "ValueError" and "n_micro" in msg


def test_pipeline_on_one_rank_runs_the_stages_in_turn():
    w, b, x = h.pipe_data()
    params = tpar.stack_stage_params([(torch.from_numpy(w[i]),
                                       torch.from_numpy(b[i]))
                                      for i in (0,)])
    got = tpar.pipeline_apply(lambda p, z: torch.tanh(z @ p[0] + p[1]),
                              params, torch.from_numpy(x), mesh=None)
    np.testing.assert_allclose(got.numpy(), np.tanh(x @ w[0] + b[0]),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _logits(S, E, seed, tie):
    rs = np.random.RandomState(seed)
    lg = rs.normal(0, 1, (S, E)).astype(np.float32)
    if tie:
        lg[1] = lg[1, 0]              # every expert tied
        lg[4, E - 2] = lg[4, E - 1]   # a tie for second place
    return lg


@pytest.mark.parametrize("S,E,k,C,tie", [
    (16, 4, 2, 3, True),              # capacity 3 drops claims
    (16, 4, 2, 16, False),            # nothing drops
    (12, 3, 1, 2, True),
    (9, 5, 2, 4, False)])
def test_topk_route_matches_jax(S, E, k, C, tie):
    lg = _logits(S, E, S + E, tie)
    jd, jc, ja = jpar.topk_route(jnp.asarray(lg), k, C)
    td, tc, ta = tpar.topk_route(torch.from_numpy(lg), k, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    d = td.numpy()
    assert d.sum(axis=0).max() <= 1.0 and d.sum(axis=(1, 2)).max() <= k
    if C < S * k / E:
        assert d.sum() < S * k          # some claims dropped


def test_load_balance_loss_matches_jax():
    rs = np.random.RandomState(1)
    probs = rs.dirichlet(np.ones(4), 10).astype(np.float32)
    top1 = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 10)]
    np.testing.assert_allclose(
        float(tpar.load_balance_loss(torch.from_numpy(probs),
                                     torch.from_numpy(top1))),
        float(jpar.load_balance_loss(jnp.asarray(probs), jnp.asarray(top1))),
        rtol=1e-6)


def _jax_moe_grads(args, capacity_factor, mesh=None, k=2):
    def loss(x, gw, w1, w2):
        out, aux = jpar.moe_ffn(x, gw, w1, w2, k=k,
                                capacity_factor=capacity_factor, mesh=mesh,
                                ep_axis="tp")
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)
    (_, (out, aux)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


def _close(got, want, tol=MOE_TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 4.0])
def test_moe_ffn_and_grads_match_jax(capacity_factor):
    rs = np.random.RandomState(3)
    x = rs.normal(0, 1, (2, 4, 6)).astype(np.float32)
    gw = rs.normal(0, 1, (6, 4)).astype(np.float32)
    w1 = rs.normal(0, 0.5, (4, 6, 8)).astype(np.float32)
    w2 = rs.normal(0, 0.5, (4, 8, 6)).astype(np.float32)
    out, aux, grads = _jax_moe_grads([jnp.asarray(a) for a in
                                      (x, gw, w1, w2)], capacity_factor)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, gw, w1, w2)]
    tout, taux = tpar.moe_ffn(*ts, k=2, capacity_factor=capacity_factor)
    ((tout ** 2).sum() + 0.01 * taux).backward()
    _close(tout.detach().numpy(), out)
    np.testing.assert_allclose(float(taux.detach()), aux, rtol=1e-6)
    for t, g in zip(ts, grads):
        _close(t.grad.numpy(), g)


def test_moe_ffn_over_dp_tp_matches_jax(ranks):
    _no_errors(ranks, "check_moe_mesh")
    mesh = _jmesh({"dp": 2, "tp": 2})
    x, gw, w1, w2 = h.moe_data()
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a, spec in ((x, JP("dp")), (gw, JP()), (w1, JP("tp")),
                            (w2, JP("tp")))]
    out, aux, (dx, dgw, dw1, dw2) = _jax_moe_grads(
        args, h.MOE_CAPACITY_FACTOR, mesh=mesh)
    for rank, r in enumerate(ranks):
        d, t = divmod(rank, 2)
        _close(r["moe/out"], out[2 * d:2 * d + 2])
        np.testing.assert_allclose(r["moe/aux"], aux, rtol=1e-6)
        _close(r["moe/dx"], dx[2 * d:2 * d + 2])
        _close(r["moe/dgw"], dgw)
        _close(r["moe/dw1"], dw1[2 * t:2 * t + 2])
        _close(r["moe/dw2"], dw2[2 * t:2 * t + 2])


def test_moe_capacity_drops_in_the_mesh_case():
    """The mesh case's problem really drops claims: its global capacity
    (ceil(2 * 16 / 4 * 1.0) = 8) holds fewer than the claims on the
    busiest expert."""
    x, gw, _, _ = h.moe_data()
    d, _, _ = tpar.topk_route(torch.from_numpy(x.reshape(-1, 6) @ gw), 2, 8)
    assert float(d.sum()) < 16 * 2


def _coll_expect(name, rank):
    """The value and gradient ``check_autograd_collectives`` must read on
    ``rank`` of the {dp: 2, tp: 2} world (rank = 2 * dp + tp)."""
    xs = [np.arange(4, dtype=np.float32) + 10 * r for r in range(4)]
    d, t = divmod(rank, 2)
    group = [2 * d, 2 * d + 1]                  # this rank's tp slice

    def cot(r, n):
        return np.arange(n, dtype=np.float32) + 100 * r
    if name == "copy":
        return xs[rank], sum(cot(r, 4) for r in group)
    if name == "reduce":
        return sum(xs[r] for r in group), cot(rank, 4)
    if name == "psum":
        return sum(xs[r] for r in group), sum(cot(r, 4) for r in group)
    if name == "gather_slice":
        return np.concatenate([xs[r] for r in group]), \
            cot(rank, 8)[4 * t:4 * t + 4]
    if name == "gather_sum":
        return np.concatenate([xs[r] for r in group]), \
            sum(cot(r, 8) for r in group)[4 * t:4 * t + 4]
    if name == "gather_both":
        return np.concatenate(xs), cot(rank, 16)[4 * rank:4 * rank + 4]
    if name == "ppermute":
        peer = group[1 - t]
        return xs[peer], cot(peer, 4)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["copy", "reduce", "psum", "gather_slice",
                                  "gather_sum", "gather_both", "ppermute"])
def test_autograd_collectives(ranks, name):
    _no_errors(ranks, "check_autograd_collectives")
    for rank, r in enumerate(ranks):
        out, grad = _coll_expect(name, rank)
        np.testing.assert_array_equal(r["coll_grad/%s/out" % name], out)
        np.testing.assert_array_equal(r["coll_grad/%s/grad" % name], grad)


def test_parallel_exports_the_pipeline_and_moe():
    from mxnet_tpu_torch.parallel import moe, pipeline
    assert tpar.pipeline_apply is pipeline.pipeline_apply
    assert tpar.stack_stage_params is pipeline.stack_stage_params
    assert tpar.moe_ffn is moe.moe_ffn
    assert tpar.topk_route is moe.topk_route
    assert tpar.load_balance_loss is moe.load_balance_loss
