"""Port parity: ``tools.parse_log``, ``tools.flakiness_checker``,
``tools.bandwidth``'s unrounded rate and ``tools.lint`` against
``mxnet_tpu`` on the CPU.

``parse_log`` runs ``tests/test_tools_band.py``'s cases in both
packages. The lint runs ``tests/test_lint.py``'s fixture snippets: the
four rules the packages share (``atomic-write``, ``counter-lock``,
``thread-hygiene``, ``env-registry``) give the JAX package's verdict on
each snippet, its path moved from ``mxnet_tpu/`` to
``mxnet_tpu_torch/``; ``graph-capture`` and ``captured-purity``, the
port's counterparts of ``jit-staging`` and ``traced-purity``, have
snippets of their own; and the port's tree lints clean within the JAX
gate's time budget.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.tools.lint import (RULES, lint_paths, lint_source,
                                        rule_names)
from mxnet_tpu_torch.tools.lint.core import load_baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# parse_log
# ---------------------------------------------------------------------------

LOG_CASES = [
    (["INFO Epoch[0] Train-accuracy=0.75",
      "INFO Epoch[0] Validation-accuracy=0.70",
      "INFO Epoch[0] Time cost=12.5",
      "INFO Epoch[1] Train-accuracy=0.85",
      "INFO Epoch[1] Time cost=11.0"], ("accuracy",)),
    (["INFO Epoch[0] Train-cross-entropy=1e-07",
      "INFO Epoch[0] Validation-cross-entropy=2.5e-03",
      "INFO Epoch[1] Train-cross-entropy=-0.125",
      "INFO Epoch[1] Validation-cross-entropy=1.5E+02",
      "INFO Epoch[1] Time cost=3.25"], ("cross-entropy",)),
    (["Epoch[2] Train-accuracy=0.5", "Epoch[2] Train-mse=4",
      "noise", "Epoch[3] Validation-mse=3.5"], ("accuracy", "mse")),
]


@pytest.mark.parametrize("lines,metrics", LOG_CASES)
def test_parse_log_matches_jax(lines, metrics):
    from mxnet_tpu.tools import parse_log as jpl
    from mxnet_tpu_torch.tools import parse_log as tpl
    table = tpl.parse(lines, metrics)
    assert table == jpl.parse(lines, metrics)
    assert tpl.format_table(table, metrics) == \
        jpl.format_table(table, metrics)


def test_parse_log_values_and_cli(tmp_path, capsys):
    from mxnet_tpu_torch.tools.parse_log import parse, main
    t = parse(LOG_CASES[0][0])
    assert t[0] == {"train-accuracy": 0.75, "val-accuracy": 0.70,
                    "time": 12.5}
    t = parse(LOG_CASES[1][0], ("cross-entropy",))
    assert t[0]["train-cross-entropy"] == 1e-07
    assert t[1]["train-cross-entropy"] == -0.125
    assert t[1]["val-cross-entropy"] == 150.0
    log = tmp_path / "train.log"
    log.write_text("\n".join(LOG_CASES[0][0]) + "\n")
    assert main([str(log)])[1]["train-accuracy"] == 0.85
    out = capsys.readouterr().out
    assert out.startswith("epoch\ttime") and "0.85" in out


# ---------------------------------------------------------------------------
# flakiness_checker
# ---------------------------------------------------------------------------

def test_flakiness_checker_counts_failing_seeds(tmp_path, capsys):
    """One trial a seed drawn as the JAX checker draws them; a trial
    fails exactly when its test does under that MXNET_TEST_SEED."""
    import random
    from mxnet_tpu_torch.tools.flakiness_checker import (main,
                                                         run_test_trials)
    f = tmp_path / "test_seeded.py"
    f.write_text(textwrap.dedent("""
        import os
        def test_seed_parity():
            assert int(os.environ["MXNET_TEST_SEED"]) % 2 == 0
    """))

    def seeds_of(seed, n):
        base = random.Random(seed)
        return [base.randint(0, 2 ** 31 - 1) for _ in range(n)]
    failures, seeds = run_test_trials(str(f), 3, seed=11)
    assert seeds == seeds_of(11, 3)       # two odd seeds, one even
    assert sorted(s for s, _ in failures) == sorted(s for s in seeds
                                                    if s % 2)
    assert main([str(f), "-n", "1", "-s", "3"]) == seeds_of(3, 1)[0] % 2
    assert "trials failed" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# bandwidth: the rate stays unrounded
# ---------------------------------------------------------------------------

def test_bandwidth_reads_positive_over_a_slow_batch(monkeypatch):
    """A 264-byte payload over a 3 s batch is ~0.35 kB/s: six decimals
    of GB/s read 0.0, the unrounded rate does not."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    from mxnet_tpu_torch.tools import bandwidth
    clock = iter(float(i) * 3.0 for i in range(100))
    monkeypatch.setattr(bandwidth.time, "time", lambda: next(clock))
    shapes = [(8, 4), (16,), (3, 3, 2)]
    rows = bandwidth.measure(shapes, num_workers=2, num_batches=2)
    for r in rows:
        assert r["error"] == 0 and r["time_s"] == 3.0
        assert r["bandwidth_gbps"] > 0
        assert r["bandwidth_gbps"] == pytest.approx(2 * 264 * 2 / 3.0 / 1e9)
        assert round(r["bandwidth_gbps"], 6) == 0.0


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

def run(src, path="mxnet_tpu_torch/somemodule.py", rules=None):
    vs = lint_source(textwrap.dedent(src), path, rules=rules)
    return [v.rule for v in vs]


SHARED = ["atomic-write", "counter-lock", "thread-hygiene", "env-registry"]

# (snippet, path under the package, test_lint.py's verdict)
SHARED_CASES = [
    ("""
     def save(path, payload):
         with open(path, "wb") as f:
             f.write(payload)
     """, "somemodule.py", ["atomic-write"]),
    ("""
     import os
     def save(path, payload):
         tmp = path + ".tmp"
         with open(tmp, "wb") as f:
             f.write(payload)
         os.replace(tmp, path)
     """, "somemodule.py", []),
    ("""
     def log(path, line):
         with open(path, "a") as f:
             f.write(line)
     def load(path):
         with open(path) as f:
             return f.read()
     """, "somemodule.py", []),
    ("""
     def save(path, s):
         with open(path, mode="w") as f:
             f.write(s)
     """, "somemodule.py", ["atomic-write"]),
    ("""
     def tick(w):
         w.hits += 1
     """, "telemetry.py", ["counter-lock"]),
    ("""
     import threading
     _lock = threading.Lock()
     def tick(w):
         with _lock:
             w.hits += 1
     """, "telemetry.py", []),
    ("""
     def tick_locked(w):
         w.hits += 1
     """, "telemetry.py", []),
    ("""
     class W:
         def __init__(self):
             self.hits = 0
     """, "telemetry.py", []),
    ("""
     _state = {"counters": {}}
     def bump(name):
         _state["counters"][name] = _state["counters"].get(name, 0) + 1
     """, "profiler.py", ["counter-lock"]),
    ("""
     def tick(w):
         w.hits += 1
     """, "ndarray/ndarray.py", []),
    ("""
     import threading
     _lock = threading.Lock()
     def outer(w):
         with _lock:
             def worker():
                 w.hits += 1
             return worker
     """, "telemetry.py", ["counter-lock"]),
    ("""
     import threading
     def go(fn):
         t = threading.Thread(target=fn)
         t.start()
     """, "somemodule.py", ["thread-hygiene"]),
    ("""
     import threading
     def go(fn):
         t = threading.Thread(target=fn, daemon=True)
         t.start()
     """, "somemodule.py", []),
    ("""
     import queue
     def make():
         return queue.Queue()
     """, "io/pipeline.py", ["thread-hygiene"]),
    ("""
     import queue
     def make(depth):
         return queue.Queue(maxsize=depth)
     """, "io/pipeline.py", []),
    ("""
     import queue
     q = queue.Queue()
     """, "somemodule.py", []),
    ("""
     import os
     v = os.environ.get("MXNET_FOO", "")
     """, "somemodule.py", ["env-registry"]),
    ("""
     import os
     a = os.environ["MXNET_FOO"]
     b = os.getenv("MXNET_BAR")
     """, "somemodule.py", ["env-registry", "env-registry"]),
    ("""
     from PKG.base import get_env
     v = get_env("MXNET_FOO", 1, int)
     """, "somemodule.py", ["env-registry"]),
    ("""
     from PKG import envs
     v = envs.get_int("MXNET_TELEMETRY_RING")
     """, "somemodule.py", []),
    ("""
     from PKG import envs
     v = envs.get_int("MXNET_DEFINITELY_NOT_DECLARED")
     """, "somemodule.py", ["env-registry"]),
    ("""
     from . import envs
     v = envs.get_int("MXNET_DEFINITELY_NOT_DECLARED")
     """, "somemodule.py", ["env-registry"]),
    ("""
     import os
     v = os.environ.get("JAX_PLATFORMS", "")
     """, "somemodule.py", []),
    ("""
     import os
     v = os.environ.get("MXNET_FOO")
     """, "envs.py", []),
]


@pytest.mark.parametrize("case", range(len(SHARED_CASES)))
def test_shared_rules_give_jax_verdicts(case):
    from mxnet_tpu.tools.lint import lint_source as jlint
    src, rel, want = SHARED_CASES[case]
    got = run(src.replace("PKG", "mxnet_tpu_torch"),
              "mxnet_tpu_torch/" + rel, rules=SHARED)
    jgot = [v.rule for v in jlint(
        textwrap.dedent(src.replace("PKG", "mxnet_tpu")),
        "mxnet_tpu/" + rel, rules=SHARED)]
    assert got == jgot == want


def test_rule_registry_complete():
    assert set(rule_names()) == {
        "graph-capture", "atomic-write", "counter-lock",
        "thread-hygiene", "captured-purity", "env-registry"}
    for name, fn in RULES.items():
        assert fn.rule_doc, name


CAPTURE_CASES = [
    ("""
     import torch
     g = torch.cuda.CUDAGraph()
     with torch.cuda.graph(g):
         pass
     """, "serving/x.py", ["graph-capture", "graph-capture"]),
    ("""
     from torch.cuda import graph, make_graphed_callables
     def f(g, fn):
         with graph(g):
             pass
         return make_graphed_callables(fn, ())
     """, "serving/x.py", ["graph-capture", "graph-capture"]),
    ("""
     import torch
     g = torch.cuda.CUDAGraph()
     """, "cached_op.py", []),
    ("""
     import torch
     pool = torch.cuda.graph_pool_handle()
     s = torch.cuda.Stream()
     """, "serving/x.py", []),
]


@pytest.mark.parametrize("case", range(len(CAPTURE_CASES)))
def test_graph_capture_rule(case):
    src, rel, want = CAPTURE_CASES[case]
    assert run(src, "mxnet_tpu_torch/" + rel,
               rules=["graph-capture"]) == want


PURITY_CASES = [
    ("""
     import time
     def step(graphs, tensors):
         def body(feed):
             return [feed[0] * time.time()]
         return graphs.run(body, tensors, (0,))
     """, ["captured-purity"]),
    ("""
     import numpy as np
     class E:
         def forward(self, tensors):
             def body(feed):
                 return [feed[0] + np.random.rand()]
             return self.graphs.run(body, tensors, ())
     """, ["captured-purity"]),
    ("""
     _n = 0
     def make(holder, device):
         def call():
             global _n
             _n += 1
         return holder._capture(call, device, None)
     """, ["captured-purity"]),
    ("""
     import os
     def make(device):
         def body():
             return os.environ.get("X")
         return _cuda_capture(body, device, None)
     """, ["captured-purity"]),
    ("""
     import time
     def step(graphs, tensors):
         t0 = time.perf_counter()
         def body(feed):
             return [feed[0] * 2]
         out = graphs.run(body, tensors, (0,))
         return out, time.perf_counter() - t0
     """, []),
    ("""
     import random
     def body(feed):
         return feed
     def other():
         return random.random()
     def step(graphs, t):
         return graphs.run(body, t, ())
     """, []),
]


@pytest.mark.parametrize("case", range(len(PURITY_CASES)))
def test_captured_purity_rule(case):
    src, want = PURITY_CASES[case]
    assert run(src, rules=["captured-purity"]) == want


def test_suppression_and_baseline(tmp_path):
    src = textwrap.dedent("""
        def save(p, b):
            with open(p, "wb") as f:  # mxlint: disable=atomic-write
                f.write(b)
    """)
    collected = []
    assert lint_source(src, "mxnet_tpu_torch/m.py",
                       count_suppressed=collected) == []
    assert [v.rule for v in collected] == ["atomic-write"]
    assert [v.rule for v in lint_source(
        src.replace("atomic-write", "env-registry"),
        "mxnet_tpu_torch/m.py")] == ["atomic-write"]
    assert lint_source("# mxlint: disable-file=atomic-write\n" + src.replace(
        "  # mxlint: disable=atomic-write", ""), "mxnet_tpu_torch/m.py") == []
    f = tmp_path / "mxnet_tpu_torch" / "mod.py"
    f.parent.mkdir()
    f.write_text("import torch\ng = torch.cuda.CUDAGraph()\n")
    entry = {"rule": "graph-capture", "path": "mxnet_tpu_torch/mod.py",
             "context": "g = torch.cuda.CUDAGraph()",
             "rationale": "fixture: grandfathered on purpose"}
    res = lint_paths([str(f)], baseline=[entry])
    assert res.ok and [v.rule for v in res.baselined] == ["graph-capture"]
    assert not lint_paths([str(f)], baseline=[]).ok
    f.write_text("x = 1\n")
    res = lint_paths([str(f)], baseline=[entry])
    assert res.ok and len(res.stale_baseline) == 1
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps({"entries": [
        {"rule": "graph-capture", "path": "x", "context": "y"}]}))
    with pytest.raises(ValueError, match="rationale"):
        load_baseline(str(bad))


def test_cli_json_and_exit_codes(tmp_path, capsys):
    from mxnet_tpu_torch.tools.lint.__main__ import main
    bad = tmp_path / "mxnet_tpu_torch" / "m.py"
    bad.parent.mkdir()
    bad.write_text("import os\nv = os.environ.get('MXNET_FOO')\n")
    assert main([str(bad), "--no-baseline"]) == 1
    assert "env-registry" in capsys.readouterr().out
    assert main([str(bad), "--format", "json"]) == 1
    d = json.loads(capsys.readouterr().out)
    assert d["version"] == 1 and d["counts"] == {"env-registry": 1}
    assert d["violations"][0]["path"] == "mxnet_tpu_torch/m.py"
    good = tmp_path / "mxnet_tpu_torch" / "ok.py"
    good.write_text("x = 1\n")
    assert main([str(good)]) == 0
    assert main(["--list-rules"]) == 0
    assert "graph-capture" in capsys.readouterr().out
    assert main(["--envs"]) == 0
    out = capsys.readouterr().out
    assert "MXNET_FUSED_STEP" in out and "mxnet_tpu_torch/envs.py" in out
    assert main(["--rules", "nope"]) == 2
    broken = tmp_path / "mxnet_tpu_torch" / "broken.py"
    broken.write_text("def broken(:\n")
    assert [v.rule for v in lint_paths([str(broken)], baseline=[])
            .violations] == ["parse-error"]


def test_port_tree_lints_clean_and_fast():
    t0 = time.perf_counter()
    res = lint_paths()
    wall = time.perf_counter() - t0
    assert res.ok, "\n".join(repr(v) for v in res.violations)
    assert not res.stale_baseline, res.stale_baseline
    assert res.files > 150
    assert wall < 10.0, "tree-wide lint took %.1fs" % wall
    entries = load_baseline()
    assert len(entries) <= 3
    for e in entries:
        assert e["rationale"].strip()


def test_lint_module_entry_point_exits_zero():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_")}
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.lint"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout
