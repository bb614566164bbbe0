"""The port's ``dryrun_multichip(8, device="cpu")`` (``mxnet_tpu_torch/
dryrun.py``) against the JAX entry point's step (``__graft_entry__.py``)
for both factorizations of 8: ``dp2/tp2/sp2`` (the default) and
``dp2/pp2/sp2`` (``MXNET_TPU_DRYRUN_DEGENERATE_AXIS=tp``).

The test process rebuilds the JAX step from ``mxnet_tpu.parallel``'s
``ring_attention``, ``moe_ffn`` and ``pipeline_apply`` exactly as
``__graft_entry__.py`` writes it, returning the gradients and the
updated parameters, and holds that rebuild to the entry point's own
printed loss (5 decimals). The port's eight gloo ranks (``tools.launch``)
leave their updated shards and exchanged gradients in a directory; each
is held to JAX's piece for that rank: the loss at rtol 1e-5, every
updated shard at atol 1e-6, every gradient at 1e-4 of its largest
element (the updates are small: the gradient is the sharper reading)."""
import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import dryrun as tdry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))                  # the entry point beside the packages

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
GRAD_RTOL = 1e-4
FACTORIZATIONS = {"pp": {"dp": 2, "pp": 1, "tp": 2, "sp": 2},
                  "tp": {"dp": 2, "pp": 2, "tp": 1, "sp": 2}}


@contextlib.contextmanager
def _degenerate(axis):
    old = os.environ.get("MXNET_TPU_DRYRUN_DEGENERATE_AXIS")
    os.environ["MXNET_TPU_DRYRUN_DEGENERATE_AXIS"] = axis
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_TPU_DRYRUN_DEGENERATE_AXIS")
        else:
            os.environ["MXNET_TPU_DRYRUN_DEGENERATE_AXIS"] = old


def _jax_step(sizes, host, dims):
    """``__graft_entry__.py``'s train step (:152-195) on the 8-device CPU
    mesh, returning the loss, the gradients and the updated parameters."""
    mesh = jpar.create_mesh(sizes, devices=jax.devices()[:8])
    B, T, H, Dh, D = (dims[k] for k in ("B", "T", "H", "Dh", "D"))
    n_micro = dims["n_micro"]
    params = {n: jax.device_put(host[n], NamedSharding(
        mesh, P(*tdry.SPECS[n]))) for n in tdry.PARAMS}
    x, y = (jax.device_put(host[n], NamedSharding(mesh, P("dp", "sp", None)))
            for n in ("x", "y"))

    def pipe_stage(stage_p, h):
        w1, w2 = stage_p
        return h + jax.nn.relu(h @ w1) @ w2

    def loss_fn(p, x, y):
        h = x
        q = (h @ p["wq"]).reshape(B, T, H, Dh)
        k = (h @ p["wk"]).reshape(B, T, H, Dh)
        v = (h @ p["wv"]).reshape(B, T, H, Dh)
        attn = jpar.ring_attention(q, k, v, mesh=mesh, axis="sp",
                                   causal=True)
        h = h + attn.reshape(B, T, D) @ p["wo"]
        h = jax.lax.with_sharding_constraint(
            h, NamedSharding(mesh, P("dp", "sp", None)))
        moe_out, aux = jpar.moe_ffn(h, p["wg"], p["w1"], p["w2"], k=2,
                                    mesh=mesh, ep_axis="tp")
        h = h + moe_out
        mbs = h.reshape(n_micro, B // n_micro, T, D)
        mbs = jpar.pipeline_apply(pipe_stage, (p["pw1"], p["pw2"]), mbs,
                                  mesh=mesh, axis="pp",
                                  mb_spec=P(None, "dp", "sp", None))
        h = mbs.reshape(B, T, D)
        out = h @ p["wout"]
        return jnp.mean((out - y) ** 2) + 0.01 * aux

    def train_step(p, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        new_p = jax.tree_util.tree_map(lambda w, g: w - 0.01 * g, p, grads)
        return loss, grads, new_p

    loss, grads, new = jax.jit(train_step)(params, x, y)
    return (float(loss), {n: np.asarray(v) for n, v in grads.items()},
            {n: np.asarray(v) for n, v in new.items()}, mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per factorization: the JAX entry point's printed line, the
    rebuild's (loss, grads, new params, mesh), the port's printed line,
    its rank-0 readings and the directory of its ranks' shards."""
    from __graft_entry__ import dryrun_multichip as jax_dryrun
    out = {}
    for axis in FACTORIZATIONS:
        with _degenerate(axis):
            sizes = tdry.mesh_sizes(8)
            dims = tdry.jax_dims(sizes)
            host = tdry.init_host(sizes, dims)
            jbuf, tbuf = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(jbuf):
                jax_dryrun(8)
            rebuilt = _jax_step(sizes, host, dims)
            shards = str(tmp_path_factory.mktemp("dryrun_" + axis))
            with contextlib.redirect_stdout(tbuf):
                rec = tdry.dryrun_multichip(8, device="cpu", out_dir=shards)
        out[axis] = dict(sizes=sizes, host=host, jax_line=jbuf.getvalue(),
                         rebuilt=rebuilt, port_line=tbuf.getvalue(),
                         rec=rec, shards=shards)
    return out


def _piece(mesh, sizes, rank, name, value):
    """JAX's piece of ``value`` on device ``rank`` under the spec."""
    coords = dict(zip(mesh.axis_names, np.argwhere(
        np.vectorize(lambda d: d.id)(mesh.devices) == rank)[0]))
    spec = list(tdry.SPECS[name]) + [None] * value.ndim
    sl = []
    for size, ax in zip(value.shape, spec):
        if ax is None:
            sl.append(slice(None))
        else:
            step = size // sizes[ax]
            sl.append(slice(coords[ax] * step, (coords[ax] + 1) * step))
    return value[tuple(sl)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("axis", ["pp", "tp"])
def test_mesh_sizes_match_the_entry_point(n, axis):
    from __graft_entry__ import _mesh_sizes
    with _degenerate(axis):
        assert tdry.mesh_sizes(n) == _mesh_sizes(n)


@pytest.mark.parametrize("axis", list(FACTORIZATIONS))
def test_rebuild_matches_the_entry_points_printed_loss(runs, axis):
    r = runs[axis]
    assert r["sizes"] == FACTORIZATIONS[axis]
    line = [ln for ln in r["jax_line"].splitlines()
            if ln.startswith("dryrun_multichip OK")][-1]
    assert line == "dryrun_multichip OK: n=8 mesh=%s loss=%.5f" % (
        r["sizes"], r["rebuilt"][0])
    # the JAX mesh is in device-id order: rank r holds device r's piece
    assert [d.id for d in r["rebuilt"][3].devices.flat] == list(range(8))


@pytest.mark.parametrize("axis", list(FACTORIZATIONS))
def test_port_loss_matches_jax(runs, axis):
    r = runs[axis]
    assert r["port_line"].strip() == \
        "dryrun_multichip OK: n=8 mesh=%s loss=%.5f" % (r["sizes"],
                                                         r["rec"]["loss"])
    np.testing.assert_allclose(r["rec"]["loss"], r["rebuilt"][0],
                               rtol=LOSS_RTOL)
    assert r["rec"]["sizes"] == r["sizes"] and r["rec"]["moved"]


@pytest.mark.parametrize("axis", list(FACTORIZATIONS))
def test_port_shards_match_jax(runs, axis):
    r = runs[axis]
    _, grads, new, mesh = r["rebuilt"]
    for rank in range(8):
        with np.load(os.path.join(r["shards"], "dryrun.rank%d.npz"
                                  % rank)) as f:
            for name in tdry.PARAMS:
                want = _piece(mesh, r["sizes"], rank, name, new[name])
                assert f[name].shape == want.shape, (rank, name)
                np.testing.assert_allclose(f[name], want, rtol=0,
                                           atol=PARAM_ATOL,
                                           err_msg="%d %s" % (rank, name))
                g = _piece(mesh, r["sizes"], rank, name, grads[name])
                np.testing.assert_allclose(
                    f["grad_" + name], g, rtol=0,
                    atol=GRAD_RTOL * float(np.abs(grads[name]).max()),
                    err_msg="grad %d %s" % (rank, name))


def test_dryrun_raises_without_cuda_or_a_cpu_request(monkeypatch):
    import torch
    from mxnet_tpu_torch import MXNetError
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tdry.dryrun_multichip(8)
