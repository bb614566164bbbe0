"""Port parity: contexts on distinct devices in one process, the
in-process ``dp`` mesh (``parallel.mesh.DeviceMesh``), against the JAX
package's mesh over the same contexts.

The port reaches the path on the CPU through ``Context.torch_device``
patched to map ``cpu(i)`` to ``torch.device("cpu", i)``, four distinct
torch devices in one process (on the card the same code runs over
``[gpu(0), cpu(0)]``); the JAX package runs its mesh over its host
devices (``tests/conftest.py``). The same numpy inputs and weights go
through both, and through the port's one-context run.

Tolerances: trajectories at ``tests/test_data_parallel.py``'s (losses
rtol 5e-4, atol 5e-5; final weights rtol 5e-3, atol 1e-4); one op or one
BatchNorm step over the mesh against one device at fp32 parity (rtol
1e-5, atol 1e-6: the shards' sums are added in another order); the
in-program sync against the plain fused update bit for bit (the same
elementwise rule on the same values).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, fault, profiler
from mxnet_tpu_torch.gluon.convert import params_from_numpy
from mxnet_tpu_torch.ops import registry

N_DEV = 4
LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
W_TOL = dict(rtol=5e-3, atol=1e-4)
FP32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _distinct_cpus(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.delenv("MXNET_GRAD_OVERLAP", raising=False)
    monkeypatch.delenv("MXNET_NONFINITE_GUARD", raising=False)
    real = tmx.Context.torch_device
    monkeypatch.setattr(tmx.Context, "torch_device", lambda self: (
        torch.device("cpu", self.device_id) if self.device_type == "cpu"
        else real(self)))
    fault.reset()
    registry.reset_mesh_stats()
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield
    fault.reset()


def _ctxs(mx, n=N_DEV):
    return [mx.cpu(i) for i in range(n)]


def _synthetic_images(n, num_classes=4, seed=3):
    """tests/test_data_parallel.py's data."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, n)
    x = rng.normal(0, 0.1, (n, 3, 8, 8)).astype(np.float32)
    for i, yi in enumerate(y):
        x[i, yi % 3, :, :] += 0.5 + 0.1 * yi
    return x, y.astype(np.float32)


def _weights(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


# ---------------------------------------------------------------------------
# the Gluon loop (tests/test_data_parallel.py:_gluon_train)
# ---------------------------------------------------------------------------

def _convnet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
            nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
            nn.Dense(32, activation="relu"), nn.Dense(4))
    return net


def _gluon_train(mx, ctx_list, init, hybridize=False, num_batches=4,
                 batch_size=16, epochs=2, head_grad=None, net=None):
    """``init`` (structural name -> numpy) set into the port's net (the
    JAX run passes its initialized ``net``), then SGD with momentum;
    returns (losses, the net's final weights, trainer). ``head_grad(step)``
    gives a step's loss head gradient (numpy) or None."""
    x, y = _synthetic_images(num_batches * batch_size)
    if net is None:
        net = _convnet(mx)
        net.initialize(mx.init.Xavier(), ctx=ctx_list)
        params_from_numpy(net, init)
    if hybridize:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, step = [], 0
    for _ in range(epochs):
        for b in range(num_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            xs = mx.gluon.utils.split_and_load(x[sl], ctx_list)
            ys = mx.gluon.utils.split_and_load(y[sl], ctx_list)
            with mx.autograd.record():
                ls = [loss_fn(net(xi), yi) for xi, yi in zip(xs, ys)]
            hg = head_grad(step) if head_grad is not None else None
            for l in ls:
                l.backward(None if hg is None else mx.nd.array(hg))
            trainer.step(batch_size)
            losses.append(float(np.mean([l.asnumpy().mean() for l in ls])))
            step += 1
    return np.asarray(losses), _weights(net), trainer


def _jax_gluon(hybridize=False):
    jmx.random.seed(7)
    np.random.seed(7)
    net = _convnet(jmx)
    net.initialize(jmx.init.Xavier(), ctx=_ctxs(jmx))
    x, _ = _synthetic_images(2)
    net(jmx.nd.array(x, ctx=jmx.cpu(0)))
    init = _weights(net)
    losses, w, _ = _gluon_train(jmx, _ctxs(jmx), init, hybridize, net=net)
    return init, losses, w


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_gluon_trajectory_matches_jax_and_one_context(hybridize):
    """split_and_load shards the batch over the mesh, the parameters are
    replicated over it, BatchNorm takes the global batch's moments: the
    port's 4-context run is the JAX package's 4-device run and the
    port's own one-context run; no op gathers."""
    init, jl, jw = _jax_gluon(hybridize)
    l4, w4, _ = _gluon_train(tmx, _ctxs(tmx), init, hybridize)
    assert registry.mesh_stats()["gathers"] == {}
    if hybridize:
        assert sum(registry.mesh_stats()["lockstep"].values()) == len(l4)
    l1, w1, _ = _gluon_train(tmx, [tmx.cpu(0)], init, hybridize)
    assert np.isfinite(l4).all() and l4[-1] < l4[0]
    np.testing.assert_allclose(l4, jl, **LOSS_TOL)
    np.testing.assert_allclose(l4, l1, **LOSS_TOL)
    for name in jw:
        np.testing.assert_allclose(w4[name], jw[name], **W_TOL)
        np.testing.assert_allclose(w4[name], w1[name], **W_TOL)


# ---------------------------------------------------------------------------
# the Module loop (tests/test_data_parallel.py:_train)
# ---------------------------------------------------------------------------

def _convnet_sym(mx, num_classes=4):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           name="conv1")
    h = mx.sym.BatchNorm(h, name="bn1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = mx.sym.flatten(h)
    h = mx.sym.FullyConnected(h, num_hidden=32, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"),
                                name="softmax")


def _module_train(mx, contexts, params, num_batches=4, batch_size=16,
                  epochs=2):
    """Module.forward/backward/update with ``params`` (arg, aux numpy
    dicts; JAX's Xavier draw when None); returns (losses, fc2_weight,
    params)."""
    x, y = _synthetic_images(num_batches * batch_size)
    mod = mx.module.Module(_convnet_sym(mx), context=contexts)
    mod.bind(data_shapes=[("data", (batch_size, 3, 8, 8))],
             label_shapes=[("softmax_label", (batch_size,))])
    if params is None:
        mx.random.seed(11)
        mod.init_params(mx.init.Xavier())
        arg, aux = mod.get_params()
        params = ({k: v.asnumpy() for k, v in arg.items()},
                  {k: v.asnumpy() for k, v in aux.items()})
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in params[0].items()},
                        aux_params={k: mx.nd.array(v)
                                    for k, v in params[1].items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.05),
                                         ("momentum", 0.9)))
    losses = []
    for _ in range(epochs):
        for b in range(num_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            batch = mx.io.DataBatch(data=[mx.nd.array(x[sl])],
                                    label=[mx.nd.array(y[sl])])
            mod.forward(batch, is_train=True)
            mod.backward()
            out = mod.get_outputs()[0].asnumpy()
            labels = y[sl].astype(int)
            losses.append(float(
                -np.log(out[np.arange(batch_size), labels] + 1e-8).mean()))
            mod.update()
    return (np.asarray(losses), mod._exec.arg_dict["fc2_weight"].asnumpy(),
            params)


def test_module_trajectory_matches_jax_and_one_context():
    """Module(context=[4 contexts]) binds ONE executor over the mesh: the
    trajectory is the JAX package's dp-4 run and the one-context run."""
    jl, jw, params = _module_train(jmx, _ctxs(jmx), None)
    l4, w4, _ = _module_train(tmx, _ctxs(tmx), params)
    assert registry.mesh_stats()["gathers"] == {}
    l1, w1, _ = _module_train(tmx, tmx.cpu(0), params)
    assert np.isfinite(l4).all() and l4[-1] < l4[0]
    np.testing.assert_allclose(l4, jl, **LOSS_TOL)
    np.testing.assert_allclose(l4, l1, **LOSS_TOL)
    np.testing.assert_allclose(w4, jw, **W_TOL)
    np.testing.assert_allclose(w4, w1, **W_TOL)


def test_module_odd_batch_raises_and_outputs_are_global():
    """A batch that does not divide over the devices raises MXNetError
    at bind and at reshape, in both packages; the outputs of a predict
    forward are one global, host-readable array, the JAX package's."""
    for mx in (jmx, tmx):
        mod = mx.module.Module(_convnet_sym(mx), context=_ctxs(mx, 3))
        with pytest.raises(mx.base.MXNetError, match="not divisible"):
            mod.bind(data_shapes=[("data", (16, 3, 8, 8))],
                     label_shapes=[("softmax_label", (16,))])
    x, _ = _synthetic_images(16)
    outs = []
    params = None
    for mx in (jmx, tmx):
        mod = mx.module.Module(_convnet_sym(mx), context=_ctxs(mx))
        mod.bind(data_shapes=[("data", (16, 3, 8, 8))],
                 label_shapes=[("softmax_label", (16,))])
        if params is None:
            mod.init_params(mx.init.Xavier())
            arg, aux = mod.get_params()
            params = ({k: v.asnumpy() for k, v in arg.items()},
                      {k: v.asnumpy() for k, v in aux.items()})
        else:
            mod.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in params[0].items()},
                            aux_params={k: mx.nd.array(v)
                                        for k, v in params[1].items()})
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)],
                                    label=[mx.nd.zeros((16,))]),
                    is_train=False)
        out = mod.get_outputs()[0]
        assert out.shape == (16, 4)
        outs.append(out.asnumpy())
        if mx is tmx:
            assert isinstance(out, tmx.nd.MeshNDArray)
            with pytest.raises(tmx.base.MXNetError, match="not divisible"):
                mod.reshape(data_shapes=[("data", (6, 3, 8, 8))],
                            label_shapes=[("softmax_label", (6,))])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[1].sum(axis=1), np.ones(16), rtol=1e-5)


def test_module_input_gradients_over_mesh():
    """inputs_need_grad over the mesh: the batch's gradient comes back
    shard by shard and reads as the one-device bind's, whole."""
    x, y = _synthetic_images(16)
    grads, params = [], None
    for ctx in (_ctxs(tmx), tmx.cpu(0)):
        mod = tmx.module.Module(_convnet_sym(tmx), context=ctx)
        mod.bind(data_shapes=[("data", (16, 3, 8, 8))],
                 label_shapes=[("softmax_label", (16,))],
                 inputs_need_grad=True)
        if params is None:
            mod.init_params(tmx.init.Xavier())
            params = mod.get_params()
        else:
            mod.init_params(arg_params=params[0], aux_params=params[1])
        mod.forward(tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                     label=[tmx.nd.array(y)]),
                    is_train=True)
        mod.backward()
        grads.append(mod.get_input_grads()[0].asnumpy())
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_allclose(grads[0], grads[1], **FP32)


# ---------------------------------------------------------------------------
# split_and_load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw,pieces", [
    ((32, 4), {}, [(8, 4)] * 4),
    ((3, 8, 5), dict(batch_axis=1), [(3, 2, 5)] * 4),
    ((6, 4), dict(even_split=False), None),
], ids=["even", "batch-axis-1", "uneven-replicated"])
def test_split_and_load_matches_jax(shape, kw, pieces):
    """One element of the global shape and values, as the JAX package's
    mesh array: split over the mesh along ``batch_axis`` one shard a
    device, or, for an indivisible batch with ``even_split=False``, one
    replicated array."""
    data = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = tmx.gluon.utils.split_and_load(data, _ctxs(tmx), **kw)
    want = jmx.gluon.utils.split_and_load(data, _ctxs(jmx), **kw)
    assert len(got) == len(want) == 1
    assert isinstance(got[0], tmx.nd.MeshNDArray)
    assert got[0].shape == want[0].shape == data.shape
    assert got[0].context == tmx.cpu(0)
    np.testing.assert_array_equal(got[0].asnumpy(), want[0].asnumpy())
    mt = got[0]._mt
    if pieces is None:
        assert mt.axis is None and len(mt.shards) == 1
    else:
        assert [tuple(p.shape) for p in mt.shards] == pieces
    whole = got[0].as_in_context(tmx.cpu(0))
    assert type(whole) is tmx.nd.NDArray
    np.testing.assert_array_equal(whole.asnumpy(), data)


def test_split_and_load_uneven_raises_as_jax():
    data = np.zeros((6, 4), np.float32)
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="evenly split"):
            mx.gluon.utils.split_and_load(data, _ctxs(mx))


# ---------------------------------------------------------------------------
# BatchNorm over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_over_mesh_matches_one_device(fix_gamma):
    """Training BatchNorm over a batch split four ways: its output, the
    moving statistics it writes and the gradients of the data, gamma and
    beta are one device's over the whole batch (fp32 parity); an eval
    step runs shard by shard on the moving statistics."""
    rng = np.random.RandomState(4)
    x = (rng.randn(8, 3, 5, 5) * 2 + 1).astype(np.float32)
    head = rng.randn(8, 3, 5, 5).astype(np.float32)
    gamma, beta = rng.rand(3).astype(np.float32) + 0.5, rng.randn(3)

    def run(ctx_list):
        bn = tmx.gluon.nn.BatchNorm(in_channels=3, scale=not fix_gamma)
        bn.initialize(ctx=ctx_list)
        bn.gamma.set_data(gamma)
        bn.beta.set_data(beta.astype(np.float32))
        xs = tmx.gluon.utils.split_and_load(x, ctx_list)
        with autograd.record():
            y = bn(xs[0])
        y.backward(tmx.nd.array(head))
        ev = bn(xs[0])
        grads = [p.grad().asnumpy() for p in (bn.gamma, bn.beta)
                 if p.grad_req != "null"]
        return (y.asnumpy(), bn.running_mean.data().asnumpy(),
                bn.running_var.data().asnumpy(), grads, ev.asnumpy())

    one, mesh = run([tmx.cpu(0)]), run(_ctxs(tmx))
    assert registry.mesh_stats()["gathers"] == {}
    for a, b in zip(mesh[:3] + (mesh[4],), one[:3] + (one[4],)):
        np.testing.assert_allclose(a, b, **FP32)
    for a, b in zip(mesh[3], one[3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_batchnorm_data_gradient_over_mesh():
    """The gradient that reaches the batch through the mesh BatchNorm
    (its cross-shard terms) is one device's."""
    rng = np.random.RandomState(6)
    x = rng.randn(8, 2, 3, 3).astype(np.float32)
    head = rng.randn(8, 2, 3, 3).astype(np.float32)
    attrs = dict(fix_gamma=False, eps=1e-3, momentum=0.9)
    gamma = tmx.nd.array(rng.rand(2) + 0.5)
    beta = tmx.nd.array(rng.randn(2))

    def grad_of(ctx_list):
        leaf = tmx.nd.array(x)
        leaf.attach_grad()
        with autograd.record(), autograd.train_mode():
            src = tmx.gluon.utils.split_and_load(leaf, ctx_list)[0]
            y = tmx.nd.BatchNorm(src, gamma, beta, tmx.nd.zeros((2,)),
                                 tmx.nd.ones((2,)), **attrs)
        y.backward(tmx.nd.array(head))
        return leaf.grad.asnumpy()

    np.testing.assert_allclose(grad_of(_ctxs(tmx)), grad_of([tmx.cpu(0)]),
                               **FP32)


# ---------------------------------------------------------------------------
# the in-program sync
# ---------------------------------------------------------------------------

def test_grad_overlap_sync_equals_plain_update(monkeypatch, tmp_path):
    """MXNET_GRAD_OVERLAP=1 routes the Trainer's fused update through the
    bucketed reduce-scatter + ZeRO-1 sharded update over the in-process
    mesh: the same weights as the plain fused update, bit for bit, with
    each device holding its slice of the momentum; ``save_states``
    writes the plain run's per-parameter layout."""
    init, _, _ = _jax_gluon()
    plain_l, plain_w, plain_tr = _gluon_train(tmx, _ctxs(tmx), init)
    assert plain_tr._fused_updater._sync_mesh is None
    monkeypatch.setenv("MXNET_GRAD_OVERLAP", "1")
    monkeypatch.setenv("MXNET_GRAD_BUCKET_MB", "0.001")
    before = profiler.counters().get("fused_step_sync_dispatches", 0)
    sync_l, sync_w, sync_tr = _gluon_train(tmx, _ctxs(tmx), init)
    fused = sync_tr._fused_updater
    assert fused._sync_mesh is not None and fused._sync_mesh.size == N_DEV
    assert profiler.counters()["fused_step_sync_dispatches"] - before \
        == len(sync_l)
    assert len(fused._sync_plan.buckets) > 1
    for flat in fused._sync_state.ensure():
        assert len(flat.shards) == N_DEV
        assert flat.shards[0].numel() * N_DEV == flat.shape[0]
    np.testing.assert_array_equal(sync_l, plain_l)
    for name in plain_w:
        np.testing.assert_array_equal(sync_w[name], plain_w[name])
    sync_tr.save_states(str(tmp_path / "sync.states"))
    plain_tr.save_states(str(tmp_path / "plain.states"))
    st_sync = {i: s.asnumpy() for i, s in sync_tr._updaters[0].states.items()}
    st_plain = {i: s.asnumpy()
                for i, s in plain_tr._updaters[0].states.items()}
    assert sorted(st_sync) == sorted(st_plain)
    for i in st_plain:
        np.testing.assert_array_equal(st_sync[i], st_plain[i])


def test_nonfinite_gradient_skips_the_step_on_every_shard(monkeypatch):
    """A non-finite gradient planted on the last shard (an inf in its
    rows' head gradient) skips the whole step under the guard, with the
    bucketed sync as without it: every weight keeps its value, the guard
    counts one skipped step, and the next steps train on. The JAX
    ``make_bucketed_apply``'s guard."""
    init, _, _ = _jax_gluon()
    monkeypatch.setenv("MXNET_NONFINITE_GUARD", "skip_step")

    def head(step):
        g = np.ones((16,), np.float32)
        if step == 2:
            g[-1] = np.inf
        return g

    for overlap in ("0", "1"):
        monkeypatch.setenv("MXNET_GRAD_OVERLAP", overlap)
        fault.reset()
        snaps = []
        orig = tmx.gluon.Trainer.step

        def step(self, batch_size, ignore_stale_grad=False):
            orig(self, batch_size, ignore_stale_grad)
            snaps.append({p.name: p.data().asnumpy().copy()
                          for p in self._params if p.grad_req != "null"})
        monkeypatch.setattr(tmx.gluon.Trainer, "step", step)
        losses, _, tr = _gluon_train(tmx, _ctxs(tmx), init, epochs=1,
                                     head_grad=head)
        monkeypatch.setattr(tmx.gluon.Trainer, "step", orig)
        assert (tr._fused_updater._sync_mesh is not None) == \
            (overlap == "1")
        assert fault.stats()["skipped_steps"] == 1
        for name in snaps[1]:
            np.testing.assert_array_equal(snaps[2][name], snaps[1][name])
            assert not np.array_equal(snaps[3][name], snaps[2][name]) \
                or "gamma" in name
        assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the mesh rules and the gather counter
# ---------------------------------------------------------------------------

def _mesh_and_whole(data, axis=0):
    mesh = tmx.gluon.utils.split_and_load(data, _ctxs(tmx),
                                          batch_axis=axis)[0]
    return mesh, tmx.nd.array(data)


@pytest.mark.parametrize("name,fn,axis", [
    ("reshape", lambda nd, x: nd.reshape(x, shape=(0, 0, 2, -1)), 0),
    ("transpose", lambda nd, x: nd.transpose(x, axes=(1, 0, 2)), 0),
    ("sum-exclude", lambda nd, x: nd.sum(x, axis=0, exclude=True), 0),
    ("mean-keepdims", lambda nd, x: nd.mean(x, axis=2, keepdims=True), 0),
    ("softmax", lambda nd, x: nd.softmax(x, axis=-1), 0),
    ("slice_axis", lambda nd, x: nd.slice_axis(x, axis=2, begin=1,
                                               end=3), 0),
    ("concat", lambda nd, x: nd.concat(x, x * 2, dim=2), 0),
    ("expand_dims", lambda nd, x: nd.expand_dims(x, axis=0), 0),
    ("swapaxes", lambda nd, x: nd.SwapAxis(x, dim1=0, dim2=2), 0),
    ("fc-no-flatten", lambda nd, x: nd.FullyConnected(
        x, nd.ones((3, 4)), nd.zeros((3,)), num_hidden=3,
        flatten=False), 1),
    ("broadcast", lambda nd, x: x * nd.ones((1, 1, 4)) + 1.5, 1),
    ("flash-attention", lambda nd, x: nd._contrib_flash_attention(
        x.reshape((0, 0, 1, 4)), x.reshape((0, 0, 1, 4)),
        x.reshape((0, 0, 1, 4)), causal=True), 0),
], ids=lambda v: v if isinstance(v, str) else "")
def test_mesh_rules_run_local_and_match_one_device(name, fn, axis):
    """Each op with a mesh rule runs shard by shard (no gather), its
    output laid over the mesh, equal to one device's."""
    data = np.random.RandomState(8).randn(8, 4, 4).astype(np.float32)
    mesh, whole = _mesh_and_whole(data, axis)
    got = fn(tmx.nd, mesh)
    want = fn(tmx.nd, whole)
    assert registry.mesh_stats()["gathers"] == {}
    assert isinstance(got, tmx.nd.MeshNDArray)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **FP32)


def test_gather_counter_counts_an_op_without_a_rule():
    """An op with no mesh rule (sort) or outside its rule (softmax over
    the split axis) runs whole on the first device, counted by name, and
    still gives one device's result."""
    data = np.random.RandomState(9).randn(8, 3).astype(np.float32)
    mesh, whole = _mesh_and_whole(data)
    for fn in (lambda x: tmx.nd.sort(x, axis=0),
               lambda x: tmx.nd.softmax(x, axis=0)):
        np.testing.assert_allclose(fn(mesh).asnumpy(),
                                   fn(whole).asnumpy(), **FP32)
    assert registry.mesh_stats()["gathers"] == {"sort": 1, "softmax": 1}
    registry.reset_mesh_stats()
    assert registry.mesh_stats()["gathers"] == {}


def test_dropout_draw_over_mesh_is_one_devices():
    """A Dropout draw over a mesh array is the one-device draw: the whole
    mask from the first device's generator, split."""
    data = np.random.RandomState(10).rand(8, 6).astype(np.float32) + 1
    mesh, whole = _mesh_and_whole(data)
    outs = []
    for x in (mesh, whole):
        tmx.random.seed(3)
        with autograd.train_mode():
            outs.append(tmx.nd.Dropout(x, p=0.5).asnumpy())
    assert registry.mesh_stats()["gathers"] == {}
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0] == 0).any() and (outs[0] != 0).any()


def test_attention_block_over_mesh_forward_and_grads():
    """MeshMultiHeadAttention over the mesh (Dense, reshape and the
    attention op run shard by shard: the plain version on each CPU
    shard, the kernel on a CUDA one) equals one device forward and
    backward."""
    x = np.random.RandomState(12).randn(4, 8, 16).astype(np.float32)
    results = []
    weights = None
    for ctx_list in (_ctxs(tmx), [tmx.cpu(0)]):
        net = tmx.gluon.contrib.nn.MeshMultiHeadAttention(16, 2, causal=True)
        net.initialize(tmx.init.Xavier(), ctx=ctx_list)
        if weights is None:
            net(tmx.nd.array(x[:1]))
            weights = _weights(net)
        else:
            params_from_numpy(net, weights)
        xs = tmx.gluon.utils.split_and_load(x, ctx_list)[0]
        with autograd.record():
            y = net(xs)
        y.backward()
        results.append((y.asnumpy(), {k: p.grad().asnumpy() for k, p in
                                      net._collect_params_with_prefix()
                                      .items()}))
    assert registry.mesh_stats()["gathers"] == {}
    np.testing.assert_allclose(results[0][0], results[1][0], **FP32)
    for k in results[1][1]:
        np.testing.assert_allclose(results[0][1][k], results[1][1][k],
                                   rtol=1e-5, atol=1e-5)


def test_attach_grad_on_a_mesh_array():
    """A mesh array marked with attach_grad is a leaf a shard: backward
    and autograd.grad give its whole gradient, one device's."""
    x = np.random.RandomState(14).randn(8, 3).astype(np.float32)
    w = tmx.nd.array(np.random.RandomState(15).randn(3, 2))
    got = []
    for ctx_list in (_ctxs(tmx), [tmx.cpu(0)]):
        xs = tmx.gluon.utils.split_and_load(x, ctx_list)[0]
        xs.attach_grad()
        with autograd.record():
            y = (tmx.nd.dot(xs, w) ** 2).sum(axis=1)
        y.backward()
        with autograd.record():
            z = (tmx.nd.dot(xs, w) ** 2).sum(axis=1)
        got.append((xs.grad.asnumpy(), autograd.grad(z, [xs])[0].asnumpy()))
    for a, b in zip(got[0], got[1]):
        np.testing.assert_allclose(a, b, **FP32)
    np.testing.assert_allclose(got[0][0], got[0][1], **FP32)


def test_replicated_batch_gradient_is_counted_once():
    """An indivisible batch loaded with even_split=False is one replicated
    array: its gradient into a parameter is the whole batch's once, not
    once a device."""
    x = np.random.RandomState(13).randn(6, 3).astype(np.float32)
    grads = []
    for ctx_list in (_ctxs(tmx), [tmx.cpu(0)]):
        dense = tmx.gluon.nn.Dense(2, in_units=3)
        dense.initialize(tmx.init.One(), ctx=ctx_list)
        xs = tmx.gluon.utils.split_and_load(x, ctx_list, even_split=False)
        with autograd.record():
            y = dense(xs[0]).sum()
        y.backward()
        grads.append(dense.weight.grad().asnumpy())
    np.testing.assert_allclose(grads[0], grads[1], **FP32)
