"""The port's top-level names against the JAX package's, and two faults
found there: the names ``mxnet_tpu/__init__.py`` exports must resolve on
``mxnet_tpu_torch`` (those of modules not ported yet are listed below,
each with its ROADMAP item), importing the package must build no CUDA
kernel, and ``Pooling`` on 2-D data with no kernel must return what the
JAX package returns."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


# public names of mxnet_tpu/__init__.py the port does not carry yet, with
# the ROADMAP queue A item (or the reason) that brings them
UNPORTED = {
    "engine": "item 8",
    "util": "item 8", "runtime": "item 8", "registry": "item 8",
    "libinfo": "item 8", "storage": "item 8",
    "test_utils": "item 8",
    "tpu": "TPU devices: the port runs on CUDA devices",
    "num_tpus": "TPU devices: the port runs on CUDA devices",
}


def _public_names(path):
    """Every public name ``path`` binds at module level: imports, defs
    and assignments."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_"))


JAX_NAMES = _public_names(ROOT / "mxnet_tpu" / "__init__.py")


def test_unported_list_names_only_jax_names_the_port_lacks():
    for name in UNPORTED:
        assert name in JAX_NAMES, name
        assert not hasattr(tmx, name), \
            "%s is ported now: take it off UNPORTED" % name


@pytest.mark.parametrize("name", [n for n in JAX_NAMES
                                  if n not in UNPORTED])
def test_every_jax_top_level_name_resolves_on_the_port(name):
    assert hasattr(jmx, name)
    got = getattr(tmx, name)
    want = getattr(jmx, name)
    # a module of one package is the same module of the other
    if type(want).__name__ == "module":
        assert type(got).__name__ == "module"
        assert got.__name__ == want.__name__.replace(
            "mxnet_tpu", "mxnet_tpu_torch", 1)
    else:
        assert callable(got) == callable(want)


def test_named_imports_and_context_helpers():
    assert tmx.Module is tmx.module.Module
    assert tmx.Executor is tmx.executor.Executor
    assert tmx.Optimizer is tmx.optimizer.Optimizer
    assert tmx.save_checkpoint is tmx.model.save_checkpoint
    assert tmx.load_checkpoint is tmx.model.load_checkpoint
    assert issubclass(tmx.InjectedFault, MXNetError)
    pinned = tmx.cpu_pinned(0)
    assert str(pinned) == str(jmx.cpu_pinned(0)) == "cpu_pinned(0)"
    assert pinned.device_typeid == jmx.cpu_pinned(0).device_typeid
    assert pinned.torch_device().type == "cpu"
    arr = tmx.nd.ones((2,), ctx=pinned)
    assert arr.asnumpy().tolist() == [1.0, 1.0]


def test_gpu_memory_info_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        tmx.gpu_memory_info(0)


def test_importing_the_package_builds_no_kernel():
    """The top-level import, ``serving`` and ``parallel`` (with the
    attention module) load no CUDA library and start no compiler."""
    code = (
        "import mxnet_tpu_torch.parallel._build as b\n"
        "import mxnet_tpu_torch.io.native as n\n"
        "calls = []\n"
        "b._start = lambda name: calls.append(('nvcc', name))\n"
        "b.library = lambda name: calls.append(('load', name))\n"
        "n._build = lambda path: calls.append(('g++', path))\n"
        "import importlib\n"
        "import mxnet_tpu_torch as mx\n"
        "mx.serving, mx.parallel, mx.rtc\n"
        "importlib.import_module('mxnet_tpu_torch.parallel."
        "flash_attention')\n"
        "assert not b._libs and n._LIB is None, (b._libs, n._LIB)\n"
        "print('calls', calls)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "calls []"


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
def test_pooling_on_2d_data_with_no_kernel_matches_jax(pool_type):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    want = jmx.nd.Pooling(jmx.nd.array(x), pool_type=pool_type).asnumpy()
    got = tmx.nd.Pooling(tmx.nd.array(x, ctx=tmx.cpu()),
                         pool_type=pool_type).asnumpy()
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pooling_on_1d_data_raises_mxnet_error():
    with pytest.raises(MXNetError):
        tmx.nd.Pooling(tmx.nd.ones((4,), ctx=tmx.cpu()))
