"""The port's creation ops (``mxnet_tpu_torch/ops/init_ops.py``) against
the JAX package's (``mxnet_tpu/ops/init_ops.py``) on the CPU: values,
shapes and dtypes exactly (``_arange`` fills as numpy's float32
``arange``, which ``jnp.arange`` calls), and ``_contrib_arange_like``'s
gradient (zero) too."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from torch_parity import hold, rand

EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.mark.parametrize("attrs", [
    {"start": 5}, {"start": 0.1, "stop": 1.7, "step": 0.3},
    {"start": -2, "stop": 3, "step": 0.5, "repeat": 2},
    {"start": 10, "stop": 0, "step": -1.5}, {"start": 0, "stop": 7,
                                             "dtype": "int32"},
    {"start": 1e-3, "stop": 1.0, "step": 1.0 / 7}, {"start": 3, "stop": 3}])
def test_arange(attrs):
    hold("_arange", [], attrs, tol=EXACT)


@pytest.mark.parametrize("attrs", [
    {"start": 0, "stop": 1, "num": 5}, {"start": -3, "stop": 2, "num": 7,
                                        "endpoint": False},
    {"start": 0.1, "stop": 0.9, "num": 13}, {"start": 2, "stop": 2,
                                             "num": 1},
    {"start": -1, "stop": 9, "num": 4, "dtype": "int32"}])
def test_linspace(attrs):
    # XLA's fused float32 arithmetic differs from torch's by up to one
    # ulp in some entries: rule 5's tolerance, not exact
    hold("_linspace", [], attrs)


@pytest.mark.parametrize("attrs", [{"N": 3}, {"N": 3, "M": 5, "k": 1},
                                   {"N": 4, "M": 2, "k": -1,
                                    "dtype": "int32"}])
def test_eye(attrs):
    hold("_eye", [], attrs, tol=EXACT)


@pytest.mark.parametrize("name,attrs", [
    ("_ones", {"shape": (2, 3)}), ("_ones", {"shape": (4,),
                                            "dtype": "int32"}),
    ("_full", {"shape": (3, 2), "value": 2.5}),
    ("_full", {"shape": (2,), "value": 7, "dtype": "int32"})])
def test_ones_and_full(name, attrs):
    hold(name, [], attrs, tol=EXACT)


@pytest.mark.parametrize("attrs", [{}, {"start": 2.0, "step": 0.5},
                                   {"axis": 1, "start": -1.0},
                                   {"axis": 0, "repeat": 3}])
def test_arange_like(attrs):
    hold("_contrib_arange_like", [rand(1, 3, 4)], attrs)


def test_nullary_ops_land_on_the_ctx_attribute_or_current_context():
    out = tmx.nd.invoke_nd("_arange", [], {"start": 4}, ctx=tmx.cpu())
    assert out.context == tmx.cpu()
    for name in ("_ones", "_full", "_eye", "_linspace"):
        op = tmx.ops.get_op(name)
        res, _ = tmx.ops.invoke(op, [], {"shape": (2,), "N": 2})
        assert res[0].device.type == "cpu"
