"""The port's public surface against the JAX package's, module by module:
what ``tests/test_torch_toplevel.py`` does for the top-level names, over
every module of ``mxnet_tpu``. Each public name defined at the top level
of a JAX module (a function, a class or a constant, read from the
module's source) must resolve on the port's counterpart module, and each
public attribute of a class that module defines (a method, a property, a
class attribute) on the port's class. What the port leaves out on
purpose is listed in ``DELIBERATE`` with the reason, and each entry there
must still be missing. The walk over the packages happens inside the
tests, not when this file is imported."""
import ast
import functools
import importlib
import inspect
import os
import pkgutil

import pytest

# "module.name" or "module.Class.attribute" -> why the port has no such name
DELIBERATE = {
    "mxnet_tpu.rtc.PallasKernel":
        "a Pallas kernel for the TPU; the port's runtime kernels are CUDA C "
        "compiled by NVRTC (rtc.CudaKernel)",
    "mxnet_tpu.rtc.PallasModule":
        "Pallas kernels for the TPU; the port's counterpart is "
        "rtc.CudaModule",
    "mxnet_tpu.random.new_key":
        "a JAX PRNG key; the port draws from torch.Generator objects",
    "mxnet_tpu.placement.GroupedProgram":
        "one XLA program over placement groups; the port runs a group's "
        "ops on their own devices eagerly",
    "mxnet_tpu.context.tpu": "a TPU context; the port runs on CUDA cards",
    "mxnet_tpu.context.num_tpus": "counts TPU devices; the port has "
                                  "num_gpus",
    "mxnet_tpu.context.Context.jax_device":
        "a jax.Device; the port's counterpart is Context.torch_device",
    "mxnet_tpu.executor.Executor.fused_plan":
        "a raw JAX trace of the fused step, for callers composing it into "
        "their own jax.jit; the port's fused step is a CUDA graph",
    "mxnet_tpu.tools.lint.rules.load_jit_allowlist":
        "the jax.jit staging rule's allowlist; the port's lint checks CUDA "
        "graph capture instead",
    "mxnet_tpu.tools.lint.rules.check_jit_staging":
        "the jax.jit staging rule; the port's lint checks CUDA graph "
        "capture instead",
    "mxnet_tpu.tools.lint.rules.check_traced_purity":
        "the rule against side effects in traced JAX code; the port traces "
        "nothing",
    "mxnet_tpu.base.T": "the TypeVar of the registry's annotations",
}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _top_level_names(path):
    """The public names a module's source defines at its top level."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


def _has_static(cls, name):
    """``name`` on ``cls`` or a base, without running a descriptor."""
    return any(name in vars(k) for k in inspect.getmro(cls))


@functools.lru_cache(maxsize=None)
def _missing():
    """(modules compared, the sorted JAX names the port lacks)."""
    import mxnet_tpu
    root = os.path.dirname(mxnet_tpu.__file__)
    modules = ["mxnet_tpu"] + sorted(
        m.name for m in pkgutil.walk_packages([root], "mxnet_tpu."))
    missing = []
    for name in modules:
        jmod = importlib.import_module(name)
        tmod = importlib.import_module(
            "mxnet_tpu_torch" + name[len("mxnet_tpu"):])
        for attr in _top_level_names(jmod.__file__):
            if not hasattr(tmod, attr):
                missing.append("%s.%s" % (name, attr))
                continue
            jobj, tobj = getattr(jmod, attr, None), getattr(tmod, attr)
            if not (inspect.isclass(jobj) and jobj.__module__ == name):
                continue
            for member in vars(jobj):
                if member.startswith("_"):
                    continue
                if not (inspect.isclass(tobj) and _has_static(tobj, member)):
                    missing.append("%s.%s.%s" % (name, attr, member))
    return len(modules), tuple(sorted(missing))


def test_every_jax_public_name_resolves_on_the_port():
    count, missing = _missing()
    assert count > 150, "walked only %d modules of mxnet_tpu" % count
    unexplained = [n for n in missing if n not in DELIBERATE]
    assert not unexplained, (
        "public names of the JAX package the port lacks (port them, or "
        "list them in DELIBERATE with the reason): %s" % unexplained)


def test_deliberate_gaps_are_still_missing():
    _, missing = _missing()
    landed = sorted(set(DELIBERATE) - set(missing))
    assert not landed, ("these names have landed on the port; take them "
                        "out of DELIBERATE: %s" % landed)
