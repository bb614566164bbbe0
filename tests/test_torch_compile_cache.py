"""The port's persistent compile cache (``mxnet_tpu_torch.compile_cache``)
against the JAX package's (tests/test_compile_cache.py), on the CPU.

The mechanics the two share are held to the JAX module directly: the
key anatomy, the LRU survivors of one directory, the stale-tmp sweep,
the ``stats()`` key set and ``graph_token``. The JAX tests that store
XLA executables become their port counterparts over device code: the
nvcc libraries of ``parallel/_build.py`` (built here by a stand-in
``$CUDA_HOME/bin/nvcc`` script that writes its ``-o`` file and logs each
call) and the NVRTC cubins of ``rtc.py`` (NVRTC and the driver stubbed).
The warm-restart oracle runs in two subprocesses: the second builds
nothing and loads every library from disk. No test writes into the
repo's ``_build/``: ``_build._OUT`` and ``rtc._OUT`` point at
``tmp_path``.
"""
import contextlib
import hashlib
import json
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import compile_cache as jcc
from mxnet_tpu_torch import compile_cache, compile_watch, profiler, rtc, \
    telemetry
from mxnet_tpu_torch.parallel import _build
from mxnet_tpu_torch.tools import diagnose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = "Cuda compilation tools, release 12.9, V12.9.41"

# a stand-in nvcc: "--version" prints RELEASE, a build writes its -o file
# (the same bytes for the same source) and ptxas-style report lines; each
# call appends one line to $NVCC_LOG
FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "nvcc: NVIDIA (R) Cuda compiler driver"
  echo "%s"
  echo version >> "$NVCC_LOG"
  exit 0
fi
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "build $a" >> "$NVCC_LOG"
printf 'library of %%s\\n' "$(basename "$a")" > "$out"
echo "ptxas info    : Used 40 registers, 0 bytes spill stores"
""" % RELEASE


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch, tmp_path):
    for var in ("MXNET_COMPILE_CACHE_DIR", "MXNET_COMPILE_CACHE_MB",
                "MXNET_COMPILE_CACHE_QUEUE", "MXNET_COMPILE_WATCH",
                "MXNET_TELEMETRY", "MXNET_TELEMETRY_FILE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    # process-wide memos of the producers and the version tags: each test
    # starts as a fresh process would
    monkeypatch.setattr(compile_cache, "_tags", {})
    monkeypatch.setattr(_build, "_cached", {})
    monkeypatch.setattr(_build, "_version", [])
    proc = tmp_path / "proc"
    proc.mkdir()
    monkeypatch.setattr(_build, "_proc_dir", [str(proc)])
    monkeypatch.setattr(_build, "_OUT", str(tmp_path / "build"))
    monkeypatch.setattr(rtc, "_OUT", str(tmp_path / "build" / "rtc"))
    for mod in (compile_cache, jcc):
        mod.disable()
    compile_watch.disable()
    telemetry.reset()
    yield
    for mod in (compile_cache, jcc):
        mod.disable()
    compile_watch.disable()
    telemetry.reset()


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """The stand-in toolkit; returns a reader of its call log:
    ``(builds, version reads)``."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    exe = home / "bin" / "nvcc"
    exe.write_text(FAKE_NVCC)
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("NVCC_LOG", str(log))

    def calls():
        lines = log.read_text().splitlines() if log.exists() else []
        return (sum(ln.startswith("build") for ln in lines),
                sum(ln == "version" for ln in lines))
    return calls


def _entries(d):
    return sorted(n for n in os.listdir(d) if n.endswith(".mxc"))


def _restart():
    """What a new process forgets: the libraries it took from the cache
    or built into it."""
    _build._cached.clear()


def _counter_deltas(before):
    now = profiler.counters()
    return {k[len("compile_cache_"):]: now.get(k, 0) - before.get(k, 0)
            for k in now if k.startswith("compile_cache_")
            and now.get(k, 0) != before.get(k, 0)}


# ---------------------------------------------------------------------------
# keys, held to the JAX package's
# ---------------------------------------------------------------------------

KEY_BASE = ("site", ("s",), (("f32", 1),), "opts")
KEY_VARIANTS = [("other", ("s",), (("f32", 1),), "opts"),
                ("site", ("t",), (("f32", 1),), "opts"),
                ("site", ("s",), (("f32", 2),), "opts"),
                ("site", ("s",), (("f32", 1),), "donate")]


@pytest.mark.parametrize("variant", KEY_VARIANTS,
                         ids=["site", "statics", "signature", "options"])
def test_every_key_component_changes_the_key(variant):
    for mod in (compile_cache, jcc):
        base = mod.entry_key(*KEY_BASE)
        assert base == mod.entry_key(*KEY_BASE)
        assert base != mod.entry_key(*variant)
    # the port's key is its own hash: the version tags differ
    assert compile_cache.entry_key(*KEY_BASE) != jcc.entry_key(*KEY_BASE)


def test_version_tag_changes_the_key(monkeypatch):
    base = compile_cache.entry_key(*KEY_BASE)
    tag = compile_cache._version_tag()
    monkeypatch.setitem(compile_cache._tags, None,
                        tag[:4] + ("NVIDIA H100 80GB HBM3", "9.0", 1))
    assert compile_cache.entry_key(*KEY_BASE) != base


def test_version_tag_names_compiler_and_topology(nvcc, monkeypatch):
    from mxnet_tpu_torch.libinfo import __version__
    tag = compile_cache._version_tag()
    assert tag == (__version__, torch.__version__,
                   torch.version.cuda, None, "cpu", None, 0)
    # the toolchain of an nvcc site is nvcc's release line, read once
    nv = compile_cache._version_tag("nvcc:flash_fwd")
    assert nv[:3] == tag[:3] and nv[4:] == tag[4:]
    assert nv[3] == RELEASE
    compile_cache.entry_key("nvcc:flash_decode", (), "x")
    assert nvcc() == (0, 1)
    # an nvrtc site's is nvrtcVersion
    monkeypatch.setattr(rtc, "nvrtc_version", lambda: "12.9")
    assert compile_cache._version_tag("nvrtc")[3] == "12.9"


def test_graph_token_equal_for_equal_bytes():
    for text in ("{\"nodes\": []}", b"\x00\x01artifact", ""):
        assert compile_cache.graph_token(text) == jcc.graph_token(text)
    assert compile_cache.graph_token("a") != compile_cache.graph_token("b")


def test_stats_key_sets_equal(tmp_path):
    got = compile_cache.enable(str(tmp_path / "port"))
    want = jcc.enable(str(tmp_path / "jax"))
    assert got is not None and want is not None
    assert set(compile_cache.stats()) == set(jcc.stats())
    assert compile_cache.cache_dir() == str(tmp_path / "port")


# ---------------------------------------------------------------------------
# the directory's housekeeping, held to the JAX package's
# ---------------------------------------------------------------------------

# (name, size in bytes, age in seconds)
LRU_FILES = [("a", 700, 50), ("b", 300, 40), ("c", 500, 30),
             ("d", 200, 20), ("e", 400, 10), ("f", 100, 0)]


def _plant(d, files, now):
    d.mkdir()
    for name, size, age in files:
        p = d / (name + ".mxc")
        p.write_bytes(b"x" * size)
        os.utime(p, (now - age, now - age))


def _stop(c):
    c.pending.put(None)
    c.writer.join(timeout=10)
    assert not c.writer.is_alive()


@pytest.mark.parametrize("cap_bytes", [2200, 1500, 800, 150, 50])
def test_lru_survivors_match_jax(tmp_path, cap_bytes):
    now = time.time()
    survivors = {}
    for label, mod in (("port", compile_cache), ("jax", jcc)):
        d = tmp_path / label
        _plant(d, LRU_FILES, now)
        c = mod._Cache(str(d), max_mb=cap_bytes / float(1 << 20))
        c._evict_lru()
        _stop(c)
        survivors[label] = (_entries(str(d)), c.evictions)
    assert survivors["port"] == survivors["jax"]
    total = sum(size for _n, size, _a in LRU_FILES)
    if cap_bytes < total:
        assert survivors["port"][1] > 0


def test_stale_tmp_swept_live_kept(tmp_path):
    now = time.time()
    for label, mod in (("port", compile_cache), ("jax", jcc)):
        d = tmp_path / label
        d.mkdir()
        stale = d / ("k1.mxc.tmp.%d" % 11)
        live = d / ("k2.mxc.tmp.%d" % 12)
        for p in (stale, live):
            p.write_bytes(b"partial")
        os.utime(stale, (now - 7200, now - 7200))
        _stop(mod._Cache(str(d)))
        assert sorted(os.listdir(str(d))) == [live.name], label


# ---------------------------------------------------------------------------
# hit / miss / corruption / LRU over payload bytes
# ---------------------------------------------------------------------------

def test_cold_miss_then_warm_hit(tmp_path):
    compile_cache.enable(str(tmp_path))
    key = compile_cache.entry_key("nvcc-free:demo", ("s",), "sig")
    assert compile_cache.lookup(key) is None
    compile_cache.store(key, b"\x7fELF library bytes")
    compile_cache.flush()
    st = compile_cache.stats()
    assert (st["misses"], st["hits"], st["stores"]) == (1, 0, 1)
    assert st["entries"] == 1 and st["size_bytes"] > 0
    assert compile_cache.lookup(key) == b"\x7fELF library bytes"
    assert compile_cache.stats()["hits"] == 1


@pytest.mark.parametrize("wreck", ["garbage", "truncated", "header"])
def test_corrupt_entry_degrades_to_miss(tmp_path, wreck):
    compile_cache.enable(str(tmp_path))
    key = compile_cache.entry_key("demo", (), "sig")
    compile_cache.store(key, b"payload" * 100)
    compile_cache.flush()
    (name,) = _entries(str(tmp_path))
    path = tmp_path / name
    blob = path.read_bytes()
    path.write_bytes({"garbage": b"garbage",
                      "truncated": blob[:len(blob) - 10],
                      "header": blob[:12]}[wreck])
    assert compile_cache.lookup(key) is None
    st = compile_cache.stats()
    assert (st["misses"], st["errors"], st["hits"]) == (1, 1, 0)
    assert _entries(str(tmp_path)) == []          # the bad file is gone


def test_version_mismatch_is_a_miss(tmp_path):
    compile_cache.enable(str(tmp_path))
    key = compile_cache.entry_key("demo", (), "sig")
    compile_cache.store(key, b"cubin")
    compile_cache.flush()
    (name,) = _entries(str(tmp_path))
    path = tmp_path / name
    blob = path.read_bytes()
    n = int.from_bytes(blob[4:8], "little")
    header = json.loads(blob[8:8 + n])
    header["tag"][0] = "0.0.1"
    raw = json.dumps(header).encode()
    path.write_bytes(blob[:4] + len(raw).to_bytes(4, "little") + raw
                     + blob[8 + n:])
    assert compile_cache.lookup(key) is None
    st = compile_cache.stats()
    assert st["errors"] == 1 and st["hits"] == 0


def test_lru_eviction_bounds_the_directory(tmp_path):
    compile_cache.enable(str(tmp_path), max_mb=4096 / float(1 << 20))
    for i in range(8):
        compile_cache.store(compile_cache.entry_key("demo", (i,), "s"),
                            bytes(1000))
        compile_cache.flush()
    st = compile_cache.stats()
    assert st["evictions"] > 0
    assert st["size_bytes"] <= st["max_bytes"]
    assert st["entries"] < 8


def test_full_queue_drops_the_store(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_CACHE_QUEUE", "1")
    c = compile_cache.enable(str(tmp_path))
    # park the writer so the queue stays full
    _stop(c)
    c.pending = type(c.pending)(maxsize=1)
    compile_cache.store("k1", b"a")
    compile_cache.store("k2", b"b")
    assert compile_cache.stats()["stores_dropped"] == 1
    assert c.pending.get_nowait()[0] == "k1"     # room for disable()'s stop


def test_unwritable_dir_degrades_not_kills(tmp_path, monkeypatch):
    target = tmp_path / "file-not-dir"
    target.write_text("occupied")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(target))
    with pytest.warns(UserWarning, match="persistent compile "
                                         "cache disabled"):
        assert not compile_cache.maybe_enable()
    assert not compile_cache.enabled()
    # warned once: the latch holds until an explicit enable/disable
    assert not compile_cache.maybe_enable()


def test_counters_reach_profiler_metrics_surface(tmp_path, nvcc):
    before = dict(profiler.counters())
    compile_cache.enable(str(tmp_path / "cache"))
    _build.build_all(["flash_decode"])
    compile_cache.flush()
    _restart()
    _build.build_all(["flash_decode"])
    d = _counter_deltas(before)
    assert d["misses"] == 1 and d["hits"] == 1
    assert d["bytes_written"] > 0 and d["bytes_read"] > 0
    assert nvcc()[0] == 1


# ---------------------------------------------------------------------------
# the producers: parallel/_build.py's nvcc libraries
# ---------------------------------------------------------------------------

def test_cache_off_builds_as_before(tmp_path, nvcc):
    before = dict(profiler.counters())
    paths = _build.build_all(["nms_sweep"])
    out = paths["nms_sweep"]
    assert os.path.dirname(out) == str(tmp_path / "build")
    assert out == _build._lib_path("nms_sweep")[1]
    assert os.path.exists(_build.log_path("nms_sweep"))
    assert _build.build_all(["nms_sweep"]) == paths   # current: no build
    assert nvcc() == (1, 0)
    assert not compile_cache.enabled()
    assert _counter_deltas(before) == {}


def test_cache_only_mode_works_without_the_watch(tmp_path, nvcc):
    compile_cache.enable(str(tmp_path / "cache"))
    assert not compile_watch.enabled()
    cold = _build.build_all(["flash_fwd", "nms_sweep"])
    compile_cache.flush()
    assert nvcc()[0] == 2
    want = {n: open(p, "rb").read() for n, p in cold.items()}
    _restart()
    warm = _build.build_all(["flash_fwd", "nms_sweep"])
    assert nvcc()[0] == 2                       # nothing built again
    assert {n: open(p, "rb").read() for n, p in warm.items()} == want
    with open(_build.log_path("flash_fwd")) as f:
        assert "registers" in f.read()          # the ptxas report too
    st = compile_cache.stats()
    assert (st["hits"], st["misses"], st["stores"]) == (2, 2, 2)
    assert compile_watch.stats() is None
    assert not os.path.exists(str(tmp_path / "build"))


def test_truncated_library_entry_is_rebuilt(tmp_path, nvcc):
    cache = tmp_path / "cache"
    compile_cache.enable(str(cache))
    want = open(_build.build_all(["flash_decode"])["flash_decode"],
                "rb").read()
    compile_cache.flush()
    (name,) = _entries(str(cache))
    blob = (cache / name).read_bytes()
    (cache / name).write_bytes(blob[:len(blob) // 2])
    _restart()
    got = _build.build_all(["flash_decode"])["flash_decode"]
    compile_cache.flush()
    assert open(got, "rb").read() == want
    st = compile_cache.stats()
    assert (st["misses"], st["errors"], st["hits"]) == (2, 1, 0)
    assert nvcc()[0] == 2                       # the rebuild
    _restart()
    _build.build_all(["flash_decode"])
    assert compile_cache.stats()["hits"] == 1 and nvcc()[0] == 2


def test_over_cap_directory_evicts(tmp_path, nvcc):
    compile_cache.enable(str(tmp_path / "cache"), max_mb=600 / (1 << 20))
    _build.build_all(["flash_fwd", "flash_decode", "nms_sweep"])
    compile_cache.flush()
    st = compile_cache.stats()
    assert st["stores"] == 3 and st["evictions"] > 0
    assert st["entries"] < 3 and st["size_bytes"] <= st["max_bytes"]


def test_build_failure_still_raises(tmp_path, nvcc, monkeypatch):
    from mxnet_tpu_torch.base import MXNetError
    home = tmp_path / "broken"
    (home / "bin").mkdir(parents=True)
    exe = home / "bin" / "nvcc"
    exe.write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo release 0 "
                   "&& exit 0\necho 'error: bad source'\nexit 2\n")
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    compile_cache.enable(str(tmp_path / "cache"))
    with pytest.raises(MXNetError, match="bad source"):
        _build.build_all(["nms_sweep"])
    compile_cache.flush()
    assert compile_cache.stats()["stores"] == 0


WORKER = r"""
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[2])
from mxnet_tpu_torch import compile_cache, profiler
from mxnet_tpu_torch.parallel import _build
_build._OUT = sys.argv[1]
paths = _build.build_all()
compile_cache.flush()
libs = {}
for name, path in paths.items():
    with open(path, "rb") as f:
        libs[name] = hashlib.sha256(f.read()).hexdigest()
    assert os.path.exists(_build.log_path(name)), name
print(json.dumps({"stats": compile_cache.stats(), "libs": libs,
                  "counters": {k: v for k, v in profiler.counters().items()
                               if k.startswith("compile_cache_")}}))
"""


def test_warm_restart_builds_nothing(tmp_path, nvcc):
    """Two processes on one cache directory: the first builds the six
    libraries and stores them, the second runs no nvcc build and loads
    all six, byte for byte."""
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=str(tmp_path / "cache"),
               TMPDIR=str(tmp_path))
    runs = []
    for _ in range(2):
        before = nvcc()
        res = subprocess.run(
            [sys.executable, "-c", WORKER, str(tmp_path / "build"), ROOT],
            env=env, cwd=str(tmp_path), capture_output=True, text=True,
            timeout=240)
        assert res.returncode == 0, res.stderr
        after = nvcc()
        runs.append((json.loads(res.stdout.strip().splitlines()[-1]),
                     after[0] - before[0], after[1] - before[1]))
    (cold, cold_builds, cold_versions), (warm, warm_builds, warm_versions) \
        = runs
    n = len(_build.SOURCES)
    assert n == 6
    assert cold_builds == n and cold_versions == 1
    assert cold["stats"]["misses"] == n and cold["stats"]["stores"] == n
    assert cold["stats"]["entries"] == n and cold["stats"]["hits"] == 0
    assert warm_builds == 0 and warm_versions == 1
    assert warm["stats"]["hits"] == n and warm["stats"]["misses"] == 0
    assert warm["stats"]["stores"] == 0
    assert warm["counters"]["compile_cache_hits"] == n
    assert warm["libs"] == cold["libs"]
    assert not os.path.exists(str(tmp_path / "build"))


# ---------------------------------------------------------------------------
# the producers: rtc.py's NVRTC cubins
# ---------------------------------------------------------------------------

AXPY = r"""
extern "C" __global__ void axpy(float alpha, const float *x, float *y) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    y[i] += alpha * x[i];
}
"""


class _FakeDriver:
    def __init__(self):
        self.loaded = []

    def cuModuleLoadData(self, module, cubin):
        self.loaded.append(bytes(cubin))
        return 0


@pytest.fixture
def nvrtc(monkeypatch):
    """NVRTC and the driver stubbed; returns (compiles, the driver)."""
    compiles = []

    def compile_(source, options, names, name):
        compiles.append(options)
        return (b"CUBIN:" + hashlib.sha256(source.encode()).digest(),
                {n: "_Z" + n for n in names})
    drv = _FakeDriver()
    monkeypatch.setattr(rtc, "_compile", compile_)
    monkeypatch.setattr(rtc, "_arch", lambda index: "sm_90a")
    monkeypatch.setattr(rtc, "_pushed",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(rtc, "nvrtc_version", lambda: "12.9")
    monkeypatch.setitem(rtc._libs, "cuda", drv)
    return compiles, drv


@pytest.mark.parametrize("cached", [False, True],
                         ids=["build_dir", "compile_cache"])
def test_rtc_cubin_compiled_once_then_loaded(tmp_path, nvrtc, cached):
    compiles, drv = nvrtc
    if cached:
        compile_cache.enable(str(tmp_path / "cache"))
    cold = rtc.CudaModule(AXPY)
    cold._load(0)
    assert cold.from_cache is False and cold.compile_seconds >= 0
    compile_cache.flush()
    warm = rtc.CudaModule(AXPY)
    warm._load(0)
    assert warm.from_cache is True and len(compiles) == 1
    assert warm._lowered == cold._lowered == {"axpy": "_Zaxpy"}
    assert drv.loaded[0] == drv.loaded[1]
    assert compiles[0][0] == "--gpu-architecture=sm_90a"
    on_disk = os.path.exists(str(tmp_path / "build" / "rtc"))
    if cached:
        st = compile_cache.stats()
        assert (st["misses"], st["hits"], st["entries"]) == (1, 1, 1)
        assert not on_disk
    else:
        assert on_disk and not compile_cache.enabled()


def test_rtc_options_and_arch_change_the_entry(tmp_path, nvrtc, monkeypatch):
    compiles, _drv = nvrtc
    compile_cache.enable(str(tmp_path / "cache"))
    rtc.CudaModule(AXPY)._load(0)
    rtc.CudaModule(AXPY, options=("-use_fast_math",))._load(0)
    monkeypatch.setattr(rtc, "_arch", lambda index: "sm_80")
    rtc.CudaModule(AXPY)._load(0)
    compile_cache.flush()
    assert len(compiles) == 3
    assert compile_cache.stats()["entries"] == 3


# ---------------------------------------------------------------------------
# compile records, telemetry and diagnose
# ---------------------------------------------------------------------------

def _building_program(site, names=("flash_decode",)):
    def fn(x):
        _build.build_all(list(names))
        return x * 2
    return compile_watch.jit(fn, site, statics=("t",))


def _compile_records(sink):
    with open(sink) as f:
        return [r for r in map(json.loads, f) if r.get("type") == "compile"]


def test_compile_records_tagged_and_diagnose_row(tmp_path, nvcc, capsys):
    sink = str(tmp_path / "run.jsonl")
    compile_cache.enable(str(tmp_path / "cache"))
    compile_watch.enable()
    telemetry.start(filename=sink)
    for restart in (False, True, False):
        if restart:
            compile_cache.flush()
            _restart()
        fn = _building_program("demo:tel")
        telemetry.step_begin()
        fn(torch.ones(4))
        telemetry.step_end()
    summary = telemetry.stop()
    cache_block = summary["compile"]["cache"]
    assert (cache_block["hits"], cache_block["misses"]) == (1, 1)
    records = _compile_records(sink)
    assert records[0]["cause"] == "first_compile"
    # cold: built fresh; restart: from disk; third wrapper in the same
    # process: the library is already loaded, nothing looked up
    assert [r["cache"] for r in records] == ["miss", "hit", "none"]
    ss = compile_watch.site_stats("demo:tel")
    assert ss["demo:tel"]["count"] == 3
    assert ss["demo:tel"]["cache_hits"] == 1
    assert compile_watch.stats()["cache_hits"] == 1
    assert summary["compile"]["programs"]["demo:tel"]["cache_hits"] == 1
    diagnose.main([sink])
    out = capsys.readouterr().out
    assert "compile-cache:" in out
    assert "1 hit(s) / 1 miss(es)" in out


def _standin(body, device, pool):
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def test_capture_window_tags_its_warm_up_lookups(tmp_path, nvcc):
    """The graph path (a stand-in capture on the CPU): the lookups the
    capture's warm-up call makes tag its record; replays make none."""
    from mxnet_tpu_torch.cached_op import _Graphs
    compile_cache.enable(str(tmp_path / "cache"))
    compile_watch.enable()
    for _ in range(2):
        fn = _building_program("demo:cap", names=("flash_fwd", "nms_sweep"))
        site = fn.graphs.site
        fn._graphs = _Graphs("cpu", capture=_standin)
        fn._graphs.site = site
        for _ in range(3):
            np.testing.assert_array_equal(fn(torch.ones(3)).numpy(), 2.0)
        assert fn.graphs.stats()["captures"] == 1
        compile_cache.flush()
        _restart()
    ss = compile_watch.site_stats("demo:cap")["demo:cap"]
    assert ss["count"] == 2 and ss["cache_hits"] == 1
    st = compile_cache.stats()
    assert (st["misses"], st["hits"]) == (2, 2)
    assert nvcc()[0] == 2


def test_cacheless_run_keeps_summary_shape(tmp_path):
    sink = str(tmp_path / "run.jsonl")
    compile_watch.enable()
    telemetry.start(filename=sink)
    fn = compile_watch.jit(lambda x: x * 3, "demo:plain")
    telemetry.step_begin()
    fn(torch.ones(4))
    telemetry.step_end()
    summary = telemetry.stop()
    assert "cache" not in summary["compile"]
    assert "cache_hits" not in summary["compile"]["programs"]["demo:plain"]
    assert all("cache" not in r for r in _compile_records(sink))
    assert "cache_hits" not in compile_watch.site_stats()["demo:plain"]


# ---------------------------------------------------------------------------
# serving warm-ups flush the cache
# ---------------------------------------------------------------------------

def test_inference_server_warmup_persists_what_it_built(tmp_path, nvcc):
    from mxnet_tpu_torch.serving import InferenceServer
    compile_cache.enable(str(tmp_path / "cache"))
    w = torch.from_numpy(np.random.RandomState(0).randn(6, 3)
                         .astype(np.float32))

    def model(x):
        _build.build_all(["flash_decode"])
        return x @ w
    srv = InferenceServer(model, max_batch=2, max_queue=8,
                          batch_window_ms=0.0)
    try:
        assert srv.warmup(np.zeros(6, np.float32)) == 2
    finally:
        srv.stop()
    # no flush() here: warmup's own put the entry on disk
    st = compile_cache.stats()
    assert st["stores"] == 1 and st["entries"] == 1


def test_decode_server_warmup_flushes(monkeypatch):
    from mxnet_tpu_torch import serving
    flushes = []
    monkeypatch.setattr(compile_cache, "flush",
                        lambda timeout=None: flushes.append(timeout))
    model = serving.ToyDecoderLM(vocab=32, n_layers=1, n_heads=2,
                                 head_dim=8, max_len=64)
    srv = serving.DecodeServer(model, model.init_params(seed=0,
                                                        device="cpu"),
                               device="cpu", seq_ladder=[16],
                               max_new_tokens=4, start=False)
    try:
        assert srv.warmup() == 2
    finally:
        srv.stop()
    assert flushes == [None]
