"""mxnet_tpu_torch stands alone: it imports neither JAX nor the JAX
package. Every module imports in a subprocess in which both are
blocked, and no file of the port (nor chip_smoke.py) names either in an
import statement."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "mxnet_tpu_torch"
BLOCKED = ("jax", "jaxlib", "mxnet_tpu")


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_and_mxnet_tpu_blocked():
    mods = _modules()
    for mod in ("serving.decode", "serving.router", "serving.fleet",
                "parallel.multihost", "tools.launch", "log", "profiler",
                "tracing", "telemetry", "metering", "livemetrics",
                "flightrec", "tools.diagnose", "attribute",
                "symbol.symbol", "symbol.infer", "cached_op",
                "gluon.nn.conv_layers", "gluon.model_zoo.vision.resnet",
                "executor", "checkpoint", "io.io", "metric", "lr_scheduler",
                "callback", "model", "module.base_module",
                "module.module", "amp", "fused_step", "fault",
                "optimizer.optimizer", "optimizer._pickle",
                "ops.optimizer_ops", "gluon.trainer", "recordio",
                "io.native", "io.image_record", "io.pipeline",
                "module.sequential_module", "module.python_module",
                "tools.im2rec", "tools.rec2idx", "gluon.data.dataset",
                "gluon.data.sampler", "gluon.data.dataloader",
                "gluon.data.vision.transforms", "ops.rnn_op",
                "ops.init_ops", "rnn.rnn_cell", "rnn.io", "bucketing.ladder",
                "bucketing.padding", "bucketing.record", "bucketing.masked",
                "bucketing.iter", "bucketing.packing",
                "module.bucketing_module", "gluon.rnn.rnn_cell",
                "gluon.rnn.rnn_layer"):
        assert "mxnet_tpu_torch." + mod in mods
    code = ("import sys\n"
            "for name in %r:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            "for mod in %r:\n"
            "    importlib.import_module(mod)\n"
            "print('ok', len(%r))\n" % (BLOCKED, mods, mods))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok %d" % len(mods)


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_mxnet_tpu(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in BLOCKED, "%s imports %s" % (path.name, name)


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase's helper must not shadow another phase's: chip_smoke.py
    binds each top-level function, class and constant once."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names.extend(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    dup = sorted({n for n in names if names.count(n) > 1})
    assert not dup, dup
