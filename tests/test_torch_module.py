"""Port parity: the symbolic training path (``mx.mod.Module``, ``mx.io``,
``metric``, ``lr_scheduler``, ``callback``, ``model``'s checkpoints,
``nd.save``/``nd.load``) against ``mxnet_tpu``, on the CPU.

Both packages start from the same parameters (the JAX package's Xavier,
drawn from numpy and carried over) and shuffle from the same numpy
seed; the JAX ``fit`` reads its iterator directly
(``MXNET_DATA_PIPELINE=0``, the port has no async pipeline yet). The
MNIST-MLP gate of ``tests/test_module.py`` then follows JAX's loss batch
by batch within ``TRAJ_TOL`` (fp32 sums in another order, compounded
over 48 SGD steps at lr 0.5 and momentum 0.9) and passes JAX's 0.95
accuracy; one ResNet-18 Module SGD step with weight decay matches JAX's
weights, BatchNorm statistics and loss.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_op as tco

TOL = dict(rtol=1e-5, atol=1e-6)
# the MLP gate's per-batch loss, port vs JAX, over 6 epochs of 8 batches
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
# the ResNet-18 step's input side: at 32x32 the last stage's BatchNorms
# see two values a channel at batch 2 (1x1 maps), an ill-conditioned
# normalization whose fp32 results differ between any two summation
# orders (JAX's own logits differ from float64 by up to 1.7e-2 there);
# at 64x64 they see eight
IMAGE = 64
GRAD_REL = 1e-4
_FIX_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures", "checkpoints")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _standin(body, device, pool):
    """A CUDA capture's contract on the CPU (test_torch_cached_op.py):
    one call now, its output buffers kept, each replay writes the body's
    result into them."""
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def _mlp_sym(mx, num_hidden=64, num_classes=10):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=num_hidden, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"),
                                name="softmax")


def _synthetic_mnist(n=512, dim=64, num_classes=10, seed=0):
    """tests/test_module.py's learnable synthetic classification data."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1.5, (num_classes, dim))
    y = rng.randint(0, num_classes, n)
    x = centers[y] + rng.normal(0, 0.5, (n, dim))
    return x.astype(np.float32), y.astype(np.float32)


def _jax_init(sym, data_shape, label_shape, seed=0):
    """Initial parameters from the JAX package's Xavier (numpy draws)."""
    np.random.seed(seed)
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(initializer=jmx.init.Xavier())
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _nd(mx, params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _ce(mod, batch):
    p = mod.get_outputs()[0].asnumpy()
    y = batch.label[0].asnumpy().astype(int)
    return float(-np.log(p[np.arange(len(y)), y] + 1e-12).mean())


def _fit(mx, sym, x, y, init, seed, batch_size, **fit_kw):
    """``fit`` from ``init`` with numpy seeded for the shuffles; returns
    the module and the per-batch training loss."""
    np.random.seed(seed)
    train = mx.io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                              label_name="softmax_label")
    mod = mx.mod.Module(sym, context=mx.cpu())
    losses = []

    def record(param):
        losses.append(_ce(mod, param.locals["data_batch"]))
    mod.fit(train, arg_params=_nd(mx, init[0]), aux_params=_nd(mx, init[1]),
            batch_end_callback=record, **fit_kw)
    return mod, np.array(losses)


def test_mlp_gate_follows_jax_trajectory():
    """tests/test_module.py:44 on the port: the same data, initial
    parameters and shuffles; the per-batch loss follows JAX's within
    TRAJ_TOL and the port's accuracy passes JAX's gate (0.95)."""
    x, y = _synthetic_mnist()
    init = _jax_init(_mlp_sym(jmx), (64, 64), (64,))
    kw = dict(optimizer="sgd", num_epoch=6, eval_metric="acc",
              optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    runs = [_fit(mx, _mlp_sym(mx), x, y, init, 5, 64, **kw)
            for mx in (jmx, tmx)]
    (jmod, jloss), (tmod, tloss) = runs
    assert len(tloss) == len(jloss) == 48
    np.testing.assert_allclose(tloss, jloss, **TRAJ_TOL)
    assert tloss[-1] < tloss[0] * 0.1
    scores = [mod.score(mx.io.NDArrayIter(x, y, batch_size=64), "acc")
              for mx, mod in ((jmx, jmod), (tmx, tmod))]
    assert scores[1][0][0] == scores[0][0][0] == "accuracy"
    assert scores[1][0][1] > 0.95, scores
    assert scores[1][0][1] == pytest.approx(scores[0][0][1], abs=1e-9)
    for name, value in jmod.get_params()[0].items():
        np.testing.assert_allclose(tmod.get_params()[0][name].asnumpy(),
                                   value.asnumpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_adam_composite_metric_and_topk_match_jax():
    x, y = _synthetic_mnist(n=256)
    init = _jax_init(_mlp_sym(jmx), (32, 64), (32,), seed=1)
    res = []
    for mx in (jmx, tmx):
        metric = mx.metric.create(["acc", "ce"])
        mod, loss = _fit(mx, _mlp_sym(mx), x, y, init, 6, 32,
                         optimizer="adam", num_epoch=4,
                         optimizer_params={"learning_rate": 0.01},
                         eval_metric=metric)
        it = mx.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        res.append((loss, metric.get_name_value(),
                    mod.score(it, mx.metric.TopKAccuracy(top_k=3))))
    (jl, jm, js), (tl, tm, ts) = res
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert [n for n, _ in tm] == [n for n, _ in jm] == ["accuracy",
                                                        "cross-entropy"]
    np.testing.assert_allclose([v for _, v in tm], [v for _, v in jm],
                               rtol=1e-4, atol=1e-5)
    assert ts[0][0] == js[0][0] == "top_k_accuracy_3"
    assert ts[0][1] > 0.9 and ts[0][1] == pytest.approx(js[0][1], abs=1e-9)


def test_score_after_fit_replays_one_graph():
    """In-place writes keep the predict graph: after ``fit`` (whose epoch
    ends rewrite every parameter), ``score`` and ``predict`` over many
    batches capture once and replay (a stand-in capture on the CPU)."""
    x, y = _synthetic_mnist(n=256)
    init = _jax_init(_mlp_sym(jmx), (32, 64), (32,), seed=2)
    mod, _ = _fit(tmx, _mlp_sym(tmx), x, y, init, 7, 32, num_epoch=2,
                  optimizer_params={"learning_rate": 0.1})
    want = mod.predict(tmx.io.NDArrayIter(x, y, batch_size=32)).asnumpy()
    mod._exec.graphs = tco._Graphs("cpu", capture=_standin)
    it = tmx.io.NDArrayIter(x, y, batch_size=32)
    mod.score(it, "acc")
    got = mod.predict(it).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert mod._exec.stats() == dict(captures=1, replays=16,
                                     recaptures=0, signatures=1,
                                     eager_rng=0, eager_host=0, grouped=0)


def test_predict_and_input_grads_match_jax():
    x, y = _synthetic_mnist(n=100)
    init = _jax_init(_mlp_sym(jmx), (32, 64), (32,), seed=3)
    preds, grads = [], []
    for mx in (jmx, tmx):
        it = mx.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        mod = mx.mod.Module(_mlp_sym(mx), context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.set_params(_nd(mx, init[0]), _nd(mx, init[1]))
        preds.append(mod.predict(it).asnumpy())
        gmod = mx.mod.Module(_mlp_sym(mx), context=mx.cpu())
        gmod.bind(data_shapes=[("data", (4, 64))],
                  label_shapes=[("softmax_label", (4,))],
                  inputs_need_grad=True)
        gmod.set_params(_nd(mx, init[0]), _nd(mx, init[1]))
        gmod.forward(mx.io.DataBatch(data=[mx.nd.array(x[:4])],
                                     label=[mx.nd.array(y[:4])]),
                     is_train=True)
        gmod.backward()
        grads.append(gmod.get_input_grads()[0].asnumpy())
    assert preds[1].shape == (100, 10)           # the pad rows are cut
    np.testing.assert_allclose(preds[1], preds[0], **TOL)
    assert np.abs(grads[1]).sum() > 0
    np.testing.assert_allclose(grads[1], grads[0], **TOL)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    """Padding, discarding and rolling over, with shuffles from the same
    numpy seed: the same batches, pads and descriptors."""
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.float32)
    seen = []
    for mx in (jmx, tmx):
        np.random.seed(9)
        it = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=True,
                               last_batch_handle=handle)
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                           for b in it])
            it.reset()
        seen.append((epochs, [tuple(d) for d in it.provide_data],
                     [tuple(d) for d in it.provide_label]))
    (je, jd, jl), (te, td, tl) = seen
    assert td == jd and tl == jl
    assert len(te) == len(je)
    for tb, jb in zip(te, je):
        assert len(tb) == len(jb)
        for (tx, ty, tp), (jx, jy, jp) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tp == jp
    if handle == "pad":
        assert [b[2] for b in te[0]] == [0, 0, 2]


def test_fixture_checkpoint_loads_through_model():
    """tests/test_checkpoint_backcompat.py:38 on the port: the committed
    Module checkpoint reproduces the fixture's recorded forward."""
    import json
    for tag in sorted(d for d in os.listdir(_FIX_ROOT)
                      if os.path.isdir(os.path.join(_FIX_ROOT, d))):
        with open(os.path.join(_FIX_ROOT, tag, "manifest.json")) as f:
            man = json.load(f)
        sym, args, auxs = tmx.model.load_checkpoint(
            os.path.join(_FIX_ROOT, tag, "mlp"), 1)
        mod = tmx.mod.Module(sym, data_names=("data",),
                             label_names=("softmax_label",),
                             context=tmx.cpu())
        x = np.asarray(man["x_fix"], np.float32)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", (x.shape[0],))],
                 for_training=False)
        mod.set_params(args, auxs)
        mod.forward(tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                     label=[tmx.nd.zeros((x.shape[0],))]),
                    is_train=False)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   np.asarray(man["mlp_forward"]), **TOL)
        # tests/test_checkpoint_backcompat.py's sparse payload (order
        # step 5): the csr and row_sparse entries load and hold the
        # manifest's values
        payload = tmx.nd.load(os.path.join(_FIX_ROOT, tag, "arrays.nd"))
        np.testing.assert_allclose(payload["dense"].asnumpy(),
                                   np.asarray(man["dense"]), rtol=1e-6)
        for key, stype, want in (("csr", "csr", "csr_dense"),
                                 ("rsp", "row_sparse", "rsp_dense")):
            assert payload[key].stype == stype
            np.testing.assert_allclose(
                payload[key].tostype("default").asnumpy(),
                np.asarray(man[want]), rtol=1e-6)
        dense = tmx.nd.load(os.path.join(_FIX_ROOT, tag, "gluon.params"))
        assert dense and all(isinstance(v, tmx.nd.NDArray)
                             for v in dense.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nd_save_load_across_packages(tmp_path, writer):
    rng = np.random.RandomState(4)
    d = {"w": rng.randn(3, 4).astype(np.float32),
         "i": np.arange(5, dtype=np.int32),
         "h": rng.randn(2).astype(np.float16)}
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    fname = str(tmp_path / "a.nd")
    src.nd.save(fname, {k: src.nd.array(v) for k, v in d.items()})
    got = dst.nd.load(fname)
    assert sorted(got) == sorted(d)
    for k, v in d.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k].asnumpy(), v)
    src.nd.save(fname, [src.nd.array(d["w"]), src.nd.array(d["i"])])
    lst = dst.nd.load(fname)
    assert isinstance(lst, list) and len(lst) == 2
    np.testing.assert_array_equal(lst[1].asnumpy(), d["i"])
    assert not os.path.exists(fname + ".tmp")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_module_checkpoint_across_packages(tmp_path, writer):
    """``Module.save_checkpoint`` of either package (the single-file
    format) loads through the other's ``Module.load``, same forward."""
    x, y = _synthetic_mnist(n=32)
    init = _jax_init(_mlp_sym(jmx), (32, 64), (32,), seed=4)
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    prefix = str(tmp_path / "mlp")
    outs = []
    for mx in (src, dst):
        it = mx.io.NDArrayIter(x, y, batch_size=32)
        if mx is src:
            mod = mx.mod.Module(_mlp_sym(mx), context=mx.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.set_params(_nd(mx, init[0]), _nd(mx, init[1]))
            mod.save_checkpoint(prefix, 1)
        else:
            mod = mx.mod.Module.load(prefix, 1, context=mx.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
        mod.forward(next(iter(it)), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_unported_paths_raise_naming_their_items(tmp_path, monkeypatch):
    """The item-10 paths run (checkpoint_prefix, resume, optimizer
    states), and so do item 12's kvstore paths: two contexts on one
    device make a ``local`` store, ``dist_sync`` outside a launched
    world is one worker. Contexts on distinct devices (this test's
    first form raised for them) bind one executor over their in-process
    mesh: the batch split, the step's weights those of the one-device
    bind."""
    x, y = _synthetic_mnist(n=64)
    it = tmx.io.NDArrayIter(x, y, batch_size=32)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    prefix = str(tmp_path / "c")
    mod.fit(it, num_epoch=1, checkpoint_prefix=prefix,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert os.path.isfile(prefix + "-0000.ckpt.json")
    assert os.path.isfile(prefix + "-0000.states")
    again = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    again.fit(it, num_epoch=1, resume_from_checkpoint=prefix,
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    from mxnet_tpu_torch import fault as tfault
    assert tfault.stats()["resumed_from_epoch"] == 0
    mod.save_optimizer_states(str(tmp_path / "s"))
    mod.load_optimizer_states(str(tmp_path / "s"))
    mod.save_checkpoint(prefix, 1, True)
    assert os.path.isfile(prefix + "-0001.states")
    two = tmx.mod.Module(_mlp_sym(tmx), context=[tmx.cpu(), tmx.cpu()])
    two.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    two.init_params()
    two.init_optimizer(kvstore="local")
    assert two._kvstore.type == "local" and two._update_on_kvstore
    assert two._updater is None and not two._fused_eligible()
    w = two._exec.arg_dict["fc1_weight"]
    ptr, before = w._data.data_ptr(), w.asnumpy()
    batch = next(iter(it))
    two.forward(batch, is_train=True)
    two.backward()
    two.update()
    assert w._data.data_ptr() == ptr          # pulled back in place
    assert not np.array_equal(w.asnumpy(), before)
    two.save_optimizer_states(str(tmp_path / "kv.states"))
    two.load_optimizer_states(str(tmp_path / "kv.states"))
    mod.init_optimizer(kvstore="dist_sync", force_init=True)
    assert mod._kvstore.num_workers == 1 and mod._update_on_kvstore
    assert mod._optimizer.rescale_grad == 1.0 / 32
    cpu_device = tmx.Context.torch_device
    monkeypatch.setattr(tmx.Context, "torch_device", lambda self: (
        torch.device("cpu", self.device_id)
        if self.device_type == "cpu" else cpu_device(self)))
    apart = tmx.mod.Module(_mlp_sym(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
    apart.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    assert apart._exec.mesh is not None and apart._exec.mesh.size == 2
    assert isinstance(apart._exec.arg_dict["data"], tmx.nd.MeshNDArray)
    monkeypatch.undo()
    one = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    one.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    one.init_params()
    arg, aux = one.get_params()
    for m in (apart, one):
        m.init_params(arg_params=arg, aux_params=aux, force_init=True)
        m.init_optimizer(kvstore=None, optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        m.forward(batch, is_train=True)
        m.backward()
        m.update()
    np.testing.assert_allclose(apart.get_params()[0]["fc1_weight"].asnumpy(),
                               one.get_params()[0]["fc1_weight"].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_module_reshape_and_output_shapes():
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (8, 64))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params()
    assert mod.output_shapes == [("softmax_output", (8, 10))]
    w = mod._exec.arg_dict["fc1_weight"]
    mod.reshape(data_shapes=[("data", (4, 64))],
                label_shapes=[("softmax_label", (4,))])
    assert mod._exec.arg_dict["fc1_weight"] is w
    mod.forward(tmx.io.DataBatch(data=[tmx.nd.ones((4, 64))],
                                 label=[tmx.nd.zeros((4,))]), is_train=False)
    assert mod.output_shapes == [("softmax_output", (4, 10))]


def _resnet18_sym(mx):
    """ResNet-18 v1 traced with ``net(sym.var("data"))`` plus
    SoftmaxOutput, and the net's parameters after Xavier and one forward
    (numpy)."""
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1, 3, IMAGE, IMAGE)))
    params = {p.name: p.data().asnumpy()
              for p in net.collect_params().values()}
    return params, mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                        name="softmax")


def test_resnet18_module_sgd_step_matches_jax():
    """One Module SGD step (lr 0.1, momentum 0.9, wd 1e-4) on ResNet-18 v1
    at batch 2, IMAGE x IMAGE, 10 classes, from the same weights: the
    loss and the BatchNorm moving statistics within rtol = 1e-5 of
    JAX's, each weight's step within GRAD_REL. Both run the
    conv-bias/BatchNorm peephole."""
    rng = np.random.RandomState(12)
    x = rng.randn(2, 3, IMAGE, IMAGE).astype(np.float32)
    y = np.array([3, 7], np.float32)
    np.random.seed(13)
    params, jsym = _resnet18_sym(jmx)
    _, tsym = _resnet18_sym(tmx)
    syms = (jsym, tsym)
    assert tsym.list_arguments() == jsym.list_arguments()
    aux_names = jsym.list_auxiliary_states()
    assert tsym.list_auxiliary_states() == aux_names
    # moving statistics away from 0/1, so the step's blend shows
    init = ({k: v for k, v in params.items() if k not in aux_names},
            {k: (rng.rand(*params[k].shape) + 0.5).astype(np.float32)
             if "var" in k else rng.randn(*params[k].shape).astype(
                 np.float32) * 0.1 for k in aux_names})
    res = []
    for mx, sym in zip((jmx, tmx), syms):
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", (2,))])
        mod.set_params(_nd(mx, init[0]), _nd(mx, init[1]))
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        batch = mx.io.DataBatch(data=[mx.nd.array(x)],
                                label=[mx.nd.array(y)])
        mod.forward_backward(batch)
        loss = _ce(mod, batch)
        mod.update()
        args, auxs = mod.get_params()
        res.append((loss, {k: v.asnumpy() for k, v in args.items()},
                    {k: v.asnumpy() for k, v in auxs.items()}))
    (jl, ja, jx), (tl, ta, tx) = res
    assert tl == pytest.approx(jl, rel=1e-5)
    for k in ja:
        # each weight's step (lr * (grad / batch + wd * w)) within
        # GRAD_REL of its largest entry, as test_torch_resnet.py holds
        # ResNet-18's gradients (two libraries' CPU convolutions, 20
        # BatchNorm backward passes)
        step = ja[k] - init[0][k]
        np.testing.assert_allclose(ta[k] - init[0][k], step, rtol=0,
                                   atol=GRAD_REL * np.abs(step).max(),
                                   err_msg=k)
    for k in jx:
        np.testing.assert_allclose(tx[k], jx[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    moved = [k for k in ja if not np.array_equal(ta[k], init[0][k])]
    assert len(moved) > len(ja) // 2


@pytest.mark.parametrize("name,kw", [
    ("acc", {}), ("top_k_acc", {"top_k": 3}), ("ce", {}), ("nll_loss", {}),
    ("perplexity", {"ignore_label": 2}), ("f1", {}), ("mcc", {}),
    ("mae", {}), ("mse", {}), ("rmse", {}), ("pearsoncorrelation", {}),
    ("loss", {}), ("acc_ignore", {"ignore_label": 1}),
])
def test_metric_values_match_jax(name, kw):
    rng = np.random.RandomState(17)
    binary = name in ("f1", "mcc")
    ncls = 2 if binary else 5
    labels = [rng.randint(0, ncls, (8,)).astype(np.float32)
              for _ in range(3)]
    preds = [rng.dirichlet(np.ones(ncls), 8).astype(np.float32)
             for _ in range(3)]
    if name in ("mae", "mse", "rmse", "pearsoncorrelation"):
        labels = [rng.randn(8).astype(np.float32) for _ in range(3)]
        preds = [rng.randn(8).astype(np.float32) for _ in range(3)]
    key = "acc" if name == "acc_ignore" else name
    vals = []
    for mx in (jmx, tmx):
        metric = mx.metric.create(key, **kw)
        for lb, pr in zip(labels, preds):
            metric.update([mx.nd.array(lb)], [mx.nd.array(pr)])
        vals.append(metric.get_name_value())
    assert [n for n, _ in vals[1]] == [n for n, _ in vals[0]]
    np.testing.assert_allclose([v for _, v in vals[1]],
                               [v for _, v in vals[0]], rtol=1e-6)


def test_lr_schedulers_match_jax():
    cases = [("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.1)),
             ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3,
                                           base_lr=0.2, warmup_steps=2,
                                           warmup_begin_lr=0.01)),
             ("PolyScheduler", dict(max_update=12, base_lr=0.1, pwr=2,
                                    final_lr=0.01, warmup_steps=3)),
             ("CosineScheduler", dict(max_update=10, base_lr=0.5,
                                      final_lr=0.05, warmup_steps=2,
                                      warmup_mode="constant",
                                      warmup_begin_lr=0.1))]
    for cls, kw in cases:
        j = getattr(jmx.lr_scheduler, cls)(**kw)
        t = getattr(tmx.lr_scheduler, cls)(**kw)
        assert [t(n) for n in range(15)] == [j(n) for n in range(15)], cls
    opts = [mx.optimizer.create("sgd", learning_rate=0.1,
                                lr_scheduler=mx.lr_scheduler.FactorScheduler(
                                    step=2, factor=0.5))
            for mx in (jmx, tmx)]
    for o in opts:
        o.num_update = 5
    assert opts[1]._get_lr(0) == opts[0]._get_lr(0)


def test_optimizer_reads_symbol_multipliers_like_jax():
    syms = []
    for mx in (jmx, tmx):
        w = mx.sym.var("fc_weight", lr_mult=2.0, wd_mult=0.5)
        syms.append(mx.sym.FullyConnected(mx.sym.var("data"), w,
                                          num_hidden=3, name="fc"))
    opts = [mx.optimizer.create("sgd", sym=s, learning_rate=0.1, wd=0.01,
                                param_idx2name={0: "fc_weight",
                                                1: "fc_bias"})
            for mx, s in zip((jmx, tmx), syms)]
    assert opts[1].lr_mult == opts[0].lr_mult == {"fc_weight": 2.0}
    assert opts[1].wd_mult == opts[0].wd_mult
    assert [opts[1]._get_lr(i) for i in (0, 1)] == \
        [opts[0]._get_lr(i) for i in (0, 1)]
    assert [opts[1]._get_wd(i) for i in (0, 1)] == \
        [opts[0]._get_wd(i) for i in (0, 1)]


def test_speedometer_and_callbacks_log_like_jax(monkeypatch, caplog):
    """Speedometer on a fixed clock (0.5 s a reading) logs the same
    lines in both packages; ProgressBar, log_train_metric and
    LogValidationMetricsCallback too."""
    import time as _time
    lines = []
    for mx in (jmx, tmx):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(_time, "time", lambda clock=clock: next(clock))
        metric = mx.metric.create("acc")
        cbs = [mx.callback.Speedometer(16, frequent=2),
               mx.callback.ProgressBar(total=6, length=10),
               mx.callback.log_train_metric(3),
               mx.callback.LogValidationMetricsCallback()]
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for nbatch in range(6):
                metric.update([mx.nd.array([1., 0.])],
                              [mx.nd.array([[0.2, 0.8], [0.9, 0.1]])])
                param = mx.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                               eval_metric=metric,
                                               locals={})
                for cb in cbs:
                    cb(param)
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[1] == lines[0]
    assert sum("samples/sec\taccuracy=" in m for m in lines[1]) == 2


def test_checkpoint_callbacks_write_loadable_epochs(tmp_path):
    x, y = _synthetic_mnist(n=64)
    prefix = str(tmp_path / "cb")
    it = tmx.io.NDArrayIter(x, y, batch_size=32)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.1},
            epoch_end_callback=[tmx.callback.do_checkpoint(prefix),
                                tmx.callback.module_checkpoint(
                                    mod, prefix + "m", period=2)])
    assert tmx.model.list_checkpoint_epochs(prefix) == [1, 2]
    assert tmx.model.list_checkpoint_epochs(prefix + "m") == [2]
    epoch, args, _ = tmx.model.load_latest_valid_checkpoint(prefix)
    assert epoch == 2
    np.testing.assert_array_equal(args["fc1_weight"].asnumpy(),
                                  mod.get_params()[0]["fc1_weight"]
                                  .asnumpy())
    jsym, jargs, _ = jmx.model.load_checkpoint(prefix, 2)
    assert jsym.list_arguments() == mod.symbol.list_arguments()
    np.testing.assert_array_equal(jargs["fc2_bias"].asnumpy(),
                                  args["fc2_bias"].asnumpy())


def test_fit_under_telemetry_writes_the_same_step_records_as_jax(tmp_path):
    """``fit`` with a telemetry run: one step record a batch, each with
    the data_wait, compute and optimizer phases, and the same run
    summary counts as the JAX package's fit."""
    import json
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as ttel
    x, y = _synthetic_mnist(n=96)
    init = _jax_init(_mlp_sym(jmx), (32, 64), (32,), seed=8)
    seen = []
    for mx, tel in ((jmx, jtel), (tmx, ttel)):
        sink = str(tmp_path / ("%s.jsonl" % mx.__name__))
        tel.start(filename=sink)
        try:
            _fit(mx, _mlp_sym(mx), x, y, init, 3, 32, num_epoch=2,
                 optimizer_params={"learning_rate": 0.1})
        finally:
            summary = tel.stop()
        with open(sink) as f:
            steps = [r for r in map(json.loads, f) if r["type"] == "step"]
        seen.append((summary["steps"], summary["samples"],
                     [sorted(set(r.get("phases_ms", {})) & {
                         "data_wait", "compute", "optimizer"})
                      for r in steps]))
    assert seen[1] == seen[0]
    assert seen[1][:2] == (6, 192)
    assert seen[1][2][0] == ["compute", "data_wait", "optimizer"]
