"""Port parity: the helper modules (``engine``, ``storage``, ``runtime``,
``libinfo``, ``registry``, ``util``, ``test_utils``) and the single names
of the JAX package's modules, against ``mxnet_tpu`` on the CPU.

The JAX oracles run on the port: ``tests/test_misc_modules.py``'s
registry and libinfo cases, ``tests/test_aux_subsystems.py``'s storage
case and ``tests/test_fault_tolerance.py``'s ``wait_for_all`` fault
guard (:117). Every public name of each JAX module resolves on the
port; where both packages compute a value (the registry's factories,
``util``'s dtypes, ``test_utils``' oracles, ``attr_key``) the values are
equal. ``engine.naive_engine`` is held to its contract through a
stand-in capture: inside it a hybridized block's call and an
executor's predict run op by op, with no capture and no replay.
"""
import importlib
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FAST_RETRY_ENV = {"MXNET_KVSTORE_TIMEOUT": "0.15",
                  "MXNET_KVSTORE_RETRY_BACKOFF": "0.01",
                  "MXNET_KVSTORE_RETRY_MAX_BACKOFF": "0.04",
                  "MXNET_FAULT_HANG_SECONDS": "0.02"}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


HELPERS = ["engine", "storage", "runtime", "libinfo", "registry", "util",
           "test_utils"]
SINGLE_NAMES = [("envs", "declared"), ("envs", "render_reference"),
                ("base", "NotImplementedForSymbol"), ("base", "get_env"),
                ("base", "string_types"), ("base", "classproperty"),
                ("base", "atomic_write_bytes"),
                ("ndarray.ndarray", "imperative_mixed_precision"),
                ("ops.optimizer_ops", "stable_sqrt"),
                ("ops.registry", "attr_key"), ("ops.extra", "get_op"),
                ("optimizer", "opt_registry_create"),
                ("gluon.parameter", "tensor_types"),
                ("telemetry", "PHASES"), ("contrib", "onnx_export")]


@pytest.mark.parametrize("module", HELPERS)
def test_every_public_name_of_the_jax_helper_resolves(module):
    jmod = importlib.import_module("mxnet_tpu." + module)
    tmod = importlib.import_module("mxnet_tpu_torch." + module)
    assert tmod.__all__ == jmod.__all__
    for name in jmod.__all__:
        assert callable(getattr(tmod, name)) == \
            callable(getattr(jmod, name)), name


@pytest.mark.parametrize("module,name", SINGLE_NAMES)
def test_single_names_resolve(module, name):
    jmod = importlib.import_module("mxnet_tpu." + module)
    tmod = importlib.import_module("mxnet_tpu_torch." + module)
    assert callable(getattr(tmod, name)) == callable(getattr(jmod, name))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_engine_knobs_match_jax():
    for mx in (jmx, tmx):
        assert mx.engine.engine_type() == "ThreadedEnginePerDevice"
        prev = mx.engine.set_bulk_size(4)
        with mx.engine.bulk(8):
            assert mx.engine._bulk_size == 8
        assert mx.engine._bulk_size == 4
        mx.engine.set_bulk_size(prev)
    assert tmx.engine.compiler_options() is None
    assert tmx.engine.compiler_options(tmx.gpu(0)) is None


@pytest.fixture
def fault_env(monkeypatch):
    from mxnet_tpu_torch import fault
    for k, v in FAST_RETRY_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MXNET_FAULT_PLAN", raising=False)
    fault.reset()
    yield fault
    fault.reset()


def test_wait_for_all_unrecoverable_hang_raises(fault_env):
    fault_env.set_plan("wait:step=1:hang:count=inf")
    with pytest.raises(tmx.CollectiveTimeoutError):
        tmx.engine.wait_for_all()


def test_wait_for_all_recovers_from_single_hang(fault_env):
    fault_env.set_plan("wait:step=1:hang")
    tmx.engine.wait_for_all()
    assert fault_env.stats()["injected"]["wait"] == 1


def _standin(calls):
    def capture(body, device, pool):
        calls.append(1)
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    return capture


def test_naive_engine_runs_op_by_op(monkeypatch):
    from mxnet_tpu_torch import cached_op
    calls = []
    monkeypatch.setattr(cached_op._Graphs.__init__, "__defaults__",
                        ("cpu", _standin(calls)))
    net = tmx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(tmx.gluon.nn.Dense(4, in_units=3, activation="relu"),
                tmx.gluon.nn.Dense(2, in_units=4))
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(np.random.RandomState(0).randn(5, 3)
                     .astype(np.float32))
    with tmx.engine.naive_engine():
        assert tmx.engine.is_naive()
        naive = net(x).asnumpy()
        naive2 = net(x).asnumpy()
    assert not tmx.engine.is_naive()
    stats = net._cached_op.stats()
    assert (stats["captures"], stats["replays"], calls) == (0, 0, [])
    graph = net(x).asnumpy()
    assert net._cached_op.stats()["captures"] == 1 and calls == [1]
    np.testing.assert_array_equal(naive, graph)
    np.testing.assert_array_equal(naive2, graph)
    # an executor's predict graph: op by op inside, captured outside
    data = tmx.sym.var("data")
    sym = tmx.sym.FullyConnected(data, num_hidden=2, name="fc")
    ex = sym.bind(tmx.cpu(), {"data": x, "fc_weight": tmx.nd.ones((2, 3)),
                              "fc_bias": tmx.nd.zeros((2,))})
    ex.graphs = cached_op._Graphs("cpu", capture=_standin(calls))
    with tmx.engine.naive_engine():
        ex.forward(is_train=False)
    assert ex.graphs.stats()["captures"] == 0
    ex.forward(is_train=False)
    assert ex.graphs.stats()["captures"] == 1


# ---------------------------------------------------------------------------
# storage, runtime, libinfo
# ---------------------------------------------------------------------------

def test_storage_stats_on_the_cpu():
    stats = tmx.storage.memory_stats()
    assert stats == {}
    snap = tmx.storage.pool_snapshot()
    assert isinstance(snap, dict) and snap["cpu"] == {}
    assert tmx.storage.bytes_allocated() == 0
    assert tmx.storage.memory_stats(tmx.cpu()) == {}
    assert tmx.storage.memory_stats("cpu") == {}


def test_storage_stats_of_a_cuda_device_carry_jax_keys(monkeypatch):
    import torch
    seen = []

    def fake_stats(dev):
        seen.append(dev)
        return {"allocated_bytes.all.current": 1024,
                "allocated_bytes.all.peak": 4096,
                "allocation.all.allocated": 7}
    monkeypatch.setattr(torch.cuda, "memory_stats", fake_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (10, 80 * 2 ** 30))
    stats = tmx.storage.memory_stats(0)
    assert stats == {"bytes_in_use": 1024, "peak_bytes_in_use": 4096,
                     "bytes_limit": 80 * 2 ** 30, "num_allocs": 7}
    assert seen == [torch.device("cuda", 0)]
    assert tmx.storage.bytes_allocated(tmx.gpu(0)) == 1024
    assert tmx.storage.bytes_limit("cuda:0") == 80 * 2 ** 30


def test_runtime_features_key_set_and_values():
    import torch
    jfeat, tfeat = jmx.runtime.Features(), tmx.runtime.Features()
    assert list(tfeat) == list(jfeat)
    for name in ("TPU", "XLA", "PALLAS", "JAX_DISTRIBUTED", "TENSORRT"):
        assert not tfeat.is_enabled(name)
    assert tfeat.is_enabled("cuda") == (torch.version.cuda is not None)
    assert tfeat["CUDNN"].enabled == torch.backends.cudnn.is_available()
    assert tfeat["OPENCV"].enabled == jfeat["OPENCV"].enabled
    assert repr(tfeat["TPU"]) == "✖ TPU"
    assert [f.name for f in tmx.runtime.feature_list()] == list(jfeat)


def test_libinfo_paths():
    paths = tmx.libinfo.find_lib_path()
    assert isinstance(paths, list)
    for p in paths:
        assert p.endswith(".so") and os.path.exists(p)
        assert os.path.dirname(p).endswith(os.path.join("mxnet_tpu_torch",
                                                        "_build"))
    inc = tmx.libinfo.find_include_path()
    assert "flash_fwd.cu" in os.listdir(inc)
    assert tmx.libinfo.__version__ == jmx.libinfo.__version__


def test_libinfo_lists_a_built_kernel(monkeypatch, tmp_path):
    from mxnet_tpu_torch.parallel import _build
    monkeypatch.setattr(_build, "_OUT", str(tmp_path))
    src, out = _build._lib_path("flash_fwd")
    assert out not in tmx.libinfo.find_lib_path()
    open(out, "wb").close()
    assert out in tmx.libinfo.find_lib_path()


# ---------------------------------------------------------------------------
# registry, util
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "port"])
def test_registry_factory_roundtrip(mx):
    class Base:
        def __init__(self, x=1):
            self.x = x

    reg = mx.registry.get_register_func(Base, "thing")
    create = mx.registry.get_create_func(Base, "thing")

    @reg
    class Special(Base):
        pass

    inst = create("special", x=5)
    assert isinstance(inst, Special) and inst.x == 5
    assert create(inst) is inst
    assert create('{"name": "special", "x": 7}').x == 7
    assert create(thing="special").x == 1
    assert "special" in mx.registry.get_registry(Base)
    with pytest.raises(AssertionError):
        create("unknown_thing")
    alias = mx.registry.get_alias_func(Base, "thing")

    @alias("extra_name", "other")
    class Other(Base):
        pass
    assert isinstance(create("extra_name"), Other)
    assert sorted(mx.registry.get_registry(Base)) == \
        ["extra_name", "other", "special"]
    with pytest.warns(UserWarning):
        reg(Special, "extra_name")


def test_util_matches_jax():
    for mx in (jmx, tmx):
        assert not mx.util.is_np_shape()
        with mx.util.np_shape(True):
            assert mx.util.is_np_shape()

        @mx.util.use_np_shape
        def probe():
            return mx.util.is_np_shape()
        assert probe() and not mx.util.is_np_shape()
    for dt in ("float64", "int64", "uint64", "float32", "int8", "float16"):
        assert tmx.util.canonical_dtype(dt) == jmx.util.canonical_dtype(dt)
    assert tmx.util.int64_enabled() == jmx.util.int64_enabled() is False
    try:
        tmx.util.set_int64_tensor_size(True)
        assert tmx.util.canonical_dtype("int64") == np.dtype("int64")
    finally:
        tmx.util.set_int64_tensor_size(False)


# ---------------------------------------------------------------------------
# test_utils
# ---------------------------------------------------------------------------

def test_default_context_honours_the_variable(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CTX", "gpu:0")
    ctx = tmx.test_utils.default_context()
    assert (ctx.device_type, ctx.device_id) == ("gpu", 0)
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CTX", "cpu")
    assert tmx.test_utils.default_context() == tmx.cpu(0)
    monkeypatch.delenv("MXNET_TEST_DEFAULT_CTX")
    assert tmx.test_utils.default_context() == tmx.cpu(0)


def _conv_net(mx):
    data = mx.sym.var("data")
    conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                              name="conv")
    act = mx.sym.Activation(conv, act_type="tanh", name="act")
    return mx.sym.FullyConnected(mx.sym.Flatten(act), num_hidden=3,
                                 name="fc")


def _conv_params():
    rng = np.random.RandomState(2)
    return {"data": rng.randn(2, 2, 5, 5).astype(np.float32),
            "conv_weight": rng.randn(4, 2, 3, 3).astype(np.float32) * .3,
            "conv_bias": rng.randn(4).astype(np.float32),
            "fc_weight": rng.randn(3, 100).astype(np.float32) * .1,
            "fc_bias": rng.randn(3).astype(np.float32)}


def test_check_consistency_matches_jax():
    params = _conv_params()
    want = jmx.test_utils.check_consistency(
        _conv_net(jmx), ctx_list=[jmx.cpu(0)], arg_params=params)
    got = tmx.test_utils.check_consistency(
        _conv_net(tmx), ctx_list=[tmx.cpu(0), tmx.cpu(1)],
        arg_params=params)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    # forward only, and from shapes
    tmx.test_utils.check_consistency(
        _conv_net(tmx), ctx_list=[tmx.cpu(0)], grad_req="null",
        shapes={k: v.shape for k, v in params.items()})


def test_check_consistency_catches_a_gradient_mismatch(monkeypatch):
    """A second context whose backward differs must fail the oracle."""
    from mxnet_tpu_torch import executor
    real = executor.Executor.backward

    def skewed(self, out_grads=None, **kw):
        res = real(self, out_grads, **kw)
        if self._ctx.device_id == 1:
            for g in self.grad_arrays:
                if g is not None:
                    g[:] = g * 1.01
        return res
    monkeypatch.setattr(executor.Executor, "backward", skewed)
    with pytest.raises(AssertionError, match="grad"):
        tmx.test_utils.check_consistency(
            _conv_net(tmx), ctx_list=[tmx.cpu(0), tmx.cpu(1)],
            arg_params=_conv_params())


def test_symbolic_checks_match_jax():
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    for mx in (jmx, tmx):
        data = mx.sym.var("data")
        out = mx.sym.FullyConnected(data, num_hidden=2, no_bias=True,
                                    name="fc")
        loc = {"data": x, "fc_weight": w}
        mx.test_utils.check_symbolic_forward(out, loc, [x @ w.T])
        og = np.ones((3, 2), np.float32)
        mx.test_utils.check_symbolic_backward(
            out, loc, [og], {"data": og @ w, "fc_weight": og.T @ x})
        mx.test_utils.check_numeric_gradient(out, loc, numeric_eps=1e-2,
                                             rtol=5e-2)
        got = mx.test_utils.simple_forward(out, data=x, fc_weight=w)
        np.testing.assert_allclose(got, x @ w.T, rtol=1e-5)
        with pytest.raises(AssertionError):
            mx.test_utils.check_symbolic_forward(out, loc, [x @ w.T + 1])


def test_array_helpers_match_jax():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for mx in (jmx, tmx):
        assert mx.test_utils.same(a, a.copy())
        assert mx.test_utils.almost_equal(a, a * (1 + 1e-7))
        mx.test_utils.assert_almost_equal(mx.nd.array(a), a)
        with pytest.raises(AssertionError, match="not equal"):
            mx.test_utils.assert_almost_equal(a, a + 1)
    np.random.seed(0)
    shapes = [tmx.test_utils.rand_shape_2d(), tmx.test_utils.rand_shape_3d(),
              tmx.test_utils.rand_shape_nd(4)]
    np.random.seed(0)
    assert shapes == [jmx.test_utils.rand_shape_2d(),
                      jmx.test_utils.rand_shape_3d(),
                      jmx.test_utils.rand_shape_nd(4)]
    np.random.seed(1)
    dense = tmx.test_utils.rand_ndarray((4, 5))
    np.random.seed(1)
    np.testing.assert_array_equal(
        dense.asnumpy(), jmx.test_utils.rand_ndarray((4, 5)).asnumpy())
    csr = tmx.test_utils.rand_ndarray((6, 7), stype="csr", density=0.3)
    assert csr.stype == "csr" and csr.shape == (6, 7)
    with tmx.test_utils.random_seed(5) as s:
        assert s.seed == 5
        first = np.random.rand()
    with tmx.test_utils.random_seed(5):
        assert np.random.rand() == first


# ---------------------------------------------------------------------------
# the single names
# ---------------------------------------------------------------------------

def test_single_names_match_jax(tmp_path, monkeypatch):
    import torch
    import jax.numpy as jnp
    from mxnet_tpu import base as jbase, envs as jenvs
    from mxnet_tpu_torch import base as tbase, envs as tenvs
    assert tenvs.declared("MXNET_FUSED_STEP") and \
        not tenvs.declared("MXNET_NOPE")
    ref = tenvs.render_reference()
    for name in tenvs.registry():
        assert "`%s`" % name in ref
    assert "do not edit" in ref.lower()

    def fn():
        pass
    for args in (("broadcast_to", 1, "x"), (None,)):
        assert str(tbase.NotImplementedForSymbol(fn, *args)) == \
            str(jbase.NotImplementedForSymbol(fn, *args))
    monkeypatch.setenv("SOME_KNOB", "7")
    for a in (("SOME_KNOB", 1), ("SOME_KNOB", None, float),
              ("SOME_KNOB", False), ("UNSET_KNOB", 3)):
        assert tbase.get_env(*a) == jbase.get_env(*a)
    assert tbase.string_types == jbase.string_types

    class K:
        @tbase.classproperty
        def name(cls):
            return cls.__name__
    assert K.name == "K"
    target = str(tmp_path / "f.bin")
    tbase.atomic_write_bytes(target, b"abc")
    assert open(target, "rb").read() == b"abc"
    assert not os.path.exists(target + ".tmp")
    assert tmx.nd.ndarray.imperative_mixed_precision() is None
    x = np.array([0.0, 2.0, 9.0, 1e-30], np.float32)
    from mxnet_tpu_torch.ops.optimizer_ops import stable_sqrt
    from mxnet_tpu.ops.optimizer_ops import stable_sqrt as j_sqrt
    np.testing.assert_array_equal(stable_sqrt(torch.tensor(x)).numpy(),
                                  np.asarray(j_sqrt(jnp.asarray(x))))
    from mxnet_tpu_torch.ops.registry import attr_key, get_op
    from mxnet_tpu.ops.registry import attr_key as j_attr_key
    attrs = {"kernel": [3, 3], "b": {"y": [1], "x": 2}, "a": "s"}
    assert attr_key(attrs) == j_attr_key(attrs)
    hash(attr_key(attrs))
    from mxnet_tpu_torch.ops import extra
    assert extra.get_op is get_op
    assert tmx.optimizer.opt_registry_create is tmx.optimizer.create
    assert isinstance(tmx.optimizer.opt_registry_create("sgd"),
                      tmx.optimizer.SGD)
    from mxnet_tpu.gluon import parameter as jparam
    from mxnet_tpu_torch.gluon import parameter as tparam
    assert tparam.tensor_types is jparam.tensor_types is None
    assert tmx.telemetry.PHASES == jmx.telemetry.PHASES
    assert tenvs.get_str("MXNET_ENGINE_TYPE") == \
        jenvs.get_str("MXNET_ENGINE_TYPE")
