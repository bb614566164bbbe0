"""Port parity: files across the two packages, on the CPU — Gluon's
``export`` and ``SymbolBlock.imports``, ``save_parameters`` /
``load_parameters`` (structural keys, and the legacy file keyed by full
names), ``ParameterDict.save`` / ``load``, and a ``SymbolBlock`` built
from Symbols.

``nd.save``/``nd.load`` and the Symbol JSON keep the JAX package's
formats, so a file that either package writes loads in the other: each
direction must give the writer's logits (rtol = atol = 1e-5; the same
weights give the same logits, within the two libraries' convolution
rounding). The traced input is named ``data0`` in both packages, and
the parameters carry ``arg:``/``aux:`` keys.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_op as tco
from mxnet_tpu_torch.gluon.convert import params_from_numpy

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _net(mx):
    """Convolutions, BatchNorm (auxiliary states), a Concat of two
    branches, a Dropout and a classifier: every key kind of the files."""
    nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"))
        branches = cnn.HybridConcurrent(axis=1)
        with branches.name_scope():
            branches.add(nn.Conv2D(3, 1), nn.MaxPool2D(3, 1, 1))
        net.add(branches, nn.Dropout(0.5), nn.GlobalAvgPool2D(),
                nn.Dense(5))
    return net


def _pair(x):
    """A JAX net and a port net with the same weights (the JAX net's,
    BatchNorm statistics perturbed), both hybridized and called once;
    returns them and JAX's logits."""
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    rs = np.random.RandomState(3)
    for k, p in jnet._collect_params_with_prefix().items():
        if k.endswith(("running_mean", "running_var", "gamma", "beta")):
            p.set_data(jmx.nd.array(rs.uniform(0.5, 1.5, p.shape)
                                    .astype(np.float32)))
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = _net(tmx)
    tnet.initialize()
    params_from_numpy(tnet, {k: p.data().asnumpy() for k, p
                             in jnet._collect_params_with_prefix().items()})
    tnet.hybridize()
    np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(), want,
                               **LOGIT_TOL)
    return jnet, tnet, want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_imports_across_packages(writer, tmp_path):
    """One package's ``export`` pair loads through the other's
    ``SymbolBlock.imports(..., ["data0"], ...)`` and gives the writer's
    logits; the two packages write the same graph and keys."""
    x = _rand(1, 2, 3, 8, 8)
    jnet, tnet, want = _pair(x)
    paths = {}
    for name, net in (("jax", jnet), ("port", tnet)):
        paths[name] = net.export(str(tmp_path / name), epoch=3)
        assert paths[name][1].endswith("-0003.params")
    reader = tmx if writer == "jax" else jmx
    sym_file, params_file = paths[writer]
    block = reader.gluon.SymbolBlock.imports(sym_file, ["data0"],
                                             params_file)
    got = block(reader.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    keys = [sorted(tmx.nd.load(p[1])) for p in paths.values()]
    assert keys[0] == keys[1]
    assert {k[:4] for k in keys[0]} == {"arg:", "aux:"}
    graphs = [tmx.sym.load(p[0]) for p in paths.values()]
    assert graphs[0].list_arguments() == graphs[1].list_arguments()
    assert graphs[0].list_arguments()[0] == "data0"
    assert graphs[0].list_auxiliary_states() == \
        graphs[1].list_auxiliary_states()
    ops = [[n.op.name for n in g._topo_nodes() if n.op is not None]
           for g in graphs]
    assert ops[0] == ops[1] and "Concat" in ops[0] and "Dropout" in ops[0]


def test_imported_block_replays_its_graph(tmp_path):
    """A SymbolBlock always runs one CachedOp: on the graph holder (a
    stand-in capture on the CPU) one capture, then replays; the
    Dropout in the imported graph draws nothing in predict mode."""
    x = _rand(2, 2, 3, 8, 8)
    _, tnet, want = _pair(x)
    sym_file, params_file = tnet.export(str(tmp_path / "net"))
    block = tmx.gluon.SymbolBlock.imports(sym_file, "data0", params_file)
    block(tmx.nd.array(x))
    op = block._cached_op
    op.graphs = tco._Graphs("cpu", capture=_standin())
    for _ in range(3):
        np.testing.assert_allclose(block(tmx.nd.array(x)).asnumpy(), want,
                                   **LOGIT_TOL)
    assert op.stats() == dict(captures=1, replays=3, recaptures=0,
                              signatures=1, eager_rng=0, eager_host=0)


def _standin():
    def capture(body, device, pool):
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    return capture


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_parameters_across_packages(writer, tmp_path):
    """``save_parameters`` (structural keys) in one package,
    ``load_parameters`` into a fresh net of the other: the writer's
    logits."""
    x = _rand(4, 2, 3, 8, 8)
    jnet, tnet, want = _pair(x)
    fname = str(tmp_path / "net.params")
    (jnet if writer == "jax" else tnet).save_parameters(fname)
    reader = tmx if writer == "jax" else jmx
    fresh = _net(reader)
    fresh.load_parameters(fname)
    assert sorted(reader.nd.load(fname)) == sorted(
        fresh._collect_params_with_prefix())
    np.testing.assert_allclose(fresh(reader.nd.array(x)).asnumpy(), want,
                               **LOGIT_TOL)


def test_legacy_full_name_file_loads(tmp_path):
    """A file keyed by full parameter names (``ParameterDict.save`` with
    the block's prefix stripped) loads through ``load_parameters``;
    ``ParameterDict.load`` restores the prefix."""
    x = _rand(5, 2, 3, 8, 8)
    jnet, tnet, want = _pair(x)
    for writer, net in (("jax", jnet), ("port", tnet)):
        fname = str(tmp_path / ("%s.params" % writer))
        net.collect_params().save(fname, strip_prefix=net.prefix)
        assert not any("." in k for k in tmx.nd.load(fname))
        fresh = _net(tmx)
        fresh.load_parameters(fname)
        np.testing.assert_allclose(fresh(tmx.nd.array(x)).asnumpy(), want,
                                   **LOGIT_TOL)
        other = _net(tmx)
        other.collect_params().load(fname, restore_prefix=other.prefix)
        np.testing.assert_allclose(other(tmx.nd.array(x)).asnumpy(), want,
                                   **LOGIT_TOL)
    with pytest.raises(ValueError, match="does not start with"):
        tnet.collect_params().save(str(tmp_path / "x"), strip_prefix="zz")


def test_load_parameters_missing_and_extra_keys(tmp_path):
    x = _rand(6, 1, 3, 8, 8)
    _, tnet, _ = _pair(x)
    fname = str(tmp_path / "net.params")
    tnet.save_parameters(fname)
    small = tmx.gluon.nn.HybridSequential()
    with small.name_scope():
        small.add(tmx.gluon.nn.Conv2D(4, 3, padding=1))
    with pytest.raises(ValueError, match="is not present"):
        small.load_parameters(fname)
    small.load_parameters(fname, ignore_extra=True)
    np.testing.assert_array_equal(small[0].weight.data().asnumpy(),
                                  tnet[0].weight.data().asnumpy())
    bigger = _net(tmx)
    with bigger.name_scope():
        bigger.add(tmx.gluon.nn.Dense(2))
    with pytest.raises(AssertionError, match="is missing"):
        bigger.load_parameters(fname)


def test_symbol_block_from_symbols_defers_and_matches_jax():
    """A SymbolBlock over a Symbol with a variadic Concat: its
    parameters take their shapes from the first input, and with JAX's
    weights its output equals JAX's SymbolBlock's."""
    x = _rand(7, 3, 6)
    outs = []
    weights = None
    for mx in (jmx, tmx):
        data = mx.sym.var("data")
        a = mx.sym.FullyConnected(data, num_hidden=4, name="fa")
        b = mx.sym.FullyConnected(data, num_hidden=2, name="fb")
        out = mx.sym.Concat(a, mx.sym.Activation(b, act_type="tanh"),
                            data, dim=1)
        block = mx.gluon.SymbolBlock(out, data)
        assert sorted(block.collect_params()) == [
            "fa_bias", "fa_weight", "fb_bias", "fb_weight"]
        block.initialize()
        block(mx.nd.array(x))
        if weights is None:
            weights = {k: p.data().asnumpy()
                       for k, p in block.collect_params().items()}
        else:
            for k, p in block.collect_params().items():
                p.set_data(weights[k])
        outs.append(block(mx.nd.array(x)).asnumpy())
        assert block(data).list_outputs() == out.list_outputs()
    assert outs[1].shape == (3, 12)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_module_loads_an_exported_pair(reader, tmp_path):
    """``Module.load(prefix, 0, data_names=("data0",))`` of either
    package reads the port's ``export`` pair and predicts the port
    net's logits."""
    x = _rand(8, 2, 3, 8, 8)
    _, tnet, want = _pair(x)
    tnet.export(str(tmp_path / "net"))
    mx = jmx if reader == "jax" else tmx
    mod = mx.mod.Module.load(str(tmp_path / "net"), 0,
                             data_names=("data0",), label_names=None,
                             context=mx.cpu())
    mod.bind(data_shapes=[("data0", x.shape)], for_training=False)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)]), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                               **LOGIT_TOL)
