"""Compile & hardware-utilization observability (counterpart of
``mxnet_tpu/compile_watch.py``).

The JAX package stages every ``jax.jit`` site through this module. The
port builds no XLA executables: its programs are CUDA graphs, one per
argument signature, held by ``cached_op._Graphs`` and captured by
``cached_op._cuda_capture``. A "compile" here is therefore:

- on the card, one CUDA graph capture (its eager warm-up call, then the
  capture), made under ``cached_op._CAPTURE_LOCK``;
- on the CPU, where a program runs eagerly, the first call of a new
  argument signature.

Either way each new key is:

- timed (per-compile duration + cumulative compile seconds),
- keyed by the argument signature (shape, stride, dtype, device of each
  tensor) plus the storage of the inputs the program reads in place,
- diffed against the previous key of the same *logical program* (same
  site and statics, across executor rebinds), naming the argument that
  changed — for a recapture, the parameter replaced by a new tensor —
  the **recompile cause**,
- costed once: flops from ``torch.utils.flop_counter.FlopCounterMode``
  over the warm-up eager call, plus the hand kernels' flops from the
  launches that call made (``parallel.flash_attention``, the formula of
  ``PERF.md`` §6's bound column), and bytes from :class:`_ByteCounter`.
  ``FlopCounterMode`` knows only the aten ops with a formula (mm, addmm,
  bmm, convolution, SDPA): the elementwise flops XLA's
  ``cost_analysis`` counts are missing, so the port's MFU reads lower
  than the JAX package's for the same model.

A **recompile storm** — ``MXNET_COMPILE_STORM_K`` (default 3) compiles
of one program within ``MXNET_COMPILE_STORM_STEPS`` (default 50) steps
— fires a one-time warning naming the churning argument.

Every watched replay (or eager call) accrues its program's flops/bytes
into the current telemetry step; at the step boundary they combine with
the step's wall time into **MFU** and memory-bandwidth utilization
against the peak table (H100 SXM from NVIDIA's spec sheet, a
placeholder for the CPU; ``MXNET_DEVICE_PEAK_FLOPS`` /
``MXNET_DEVICE_PEAK_BW`` override both). The peak is dtype-aware: a
program's flops are normalized by its compute dtype's factor against
the table's bf16 peak (on the H100, fp32 at 67 TFLOP/s, or 495 TFLOP/s
while ``torch.backends.cuda.matmul.allow_tf32`` is on; cuDNN's own TF32
flag is not consulted).

Sites of the port: ``op:_cachedopN.<head>`` (a hybridized block's
CachedOp), ``executor:fwd:eval`` (a bound executor's predict program;
the port trains op by op under torch autograd, so its train programs
have no site), ``fused_step:module`` / ``fused_step:trainer`` (the fused
step), ``bucketing:<shape>`` (one bucket of a shape ladder),
``decode[:name]:step`` / ``:prefill:sN`` / ``:cow`` (the decode server's
program set) and ``serving[:name]:bN[:sM]`` (an ``InferenceServer``
bucket). The JAX package's per-op eager jit (``op:<name>``),
``autograd:backward``, ``collective:<prim>`` and ``placement:segN`` have
no port program — the port runs those eagerly — and so no site.

Everything flows into the active telemetry run: ``compile`` and
``utilization`` JSONL records plus ``compile``/``utilization`` blocks in
the ``summary`` record; ``python -m mxnet_tpu_torch.tools.diagnose
run.jsonl`` renders them. Compiles at the fused-step sites also bridge
into ``profiler.counters()`` as ``fused_step_compile_ms``.

Off by default, always cheap when off: a watched call is one
module-global ``None`` check, and the telemetry step hook is the same
check — with the watch off the JSONL sink is byte-identical to a run
without this module. Enable with ``MXNET_COMPILE_WATCH=1`` (picked up at
wrapper creation and at ``telemetry.start()``) or :func:`enable`.

The persistent compile cache (:mod:`~mxnet_tpu_torch.compile_cache`)
keeps the device code a capture builds (nvcc libraries, NVRTC cubins),
not the CUDA graph, which cannot be written to disk: a restart captures
again and builds nothing again. While the cache is on, each ``compile``
record carries ``"cache"``: ``"hit"`` when every device-code lookup its
capture made (the warm-up call and the capture, on the capturing
thread) came from disk, ``"miss"`` when anything was built fresh,
``"none"`` when nothing was looked up; ``site_stats()`` and ``stats()``
count the ``"hit"`` captures as ``cache_hits``, and the summary's
``compile`` block gains ``cache`` (:func:`compile_cache.stats`). With
the cache off no record carries the key.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import compile_cache, envs

__all__ = ["enabled", "enable", "disable", "reset", "maybe_enable",
           "jit", "stats", "site_stats", "recent_mfu", "peak_table",
           "dtype_peak_factor", "describe_arrays", "step_reset",
           "run_reset", "summary_blocks",
           "WatchedFunction", "Site"]

_lock = threading.Lock()
_watch = None          # the active _Watch; module-global None check


# ---------------------------------------------------------------------------
# peak-performance tables
# ---------------------------------------------------------------------------

# Peak FLOP/s per device, the bf16 dense tensor-core rate (NVIDIA H100
# SXM spec sheet), keyed by torch.cuda.get_device_name(). The CPU has no
# meaningful single number: the placeholder keeps the MFU math defined
# and is expected to be overridden via MXNET_DEVICE_PEAK_FLOPS.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "cpu": 1e11,
}

# Peak device-memory bandwidth, bytes/s.
PEAK_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "cpu": 50e9,
}

# Achievable peak by COMPUTE dtype relative to the table's bf16 rate.
# The CPU placeholder keeps the JAX package's convention; the H100 rows
# are the spec sheet's dense rates over its 989 TFLOP/s bf16 figure
# (fp32: 67 TFLOP/s on the CUDA cores, 495 TFLOP/s as TF32).
PEAK_DTYPE_FACTOR = {
    "float64": 0.25, "float32": 0.5,
    "float16": 1.0, "bfloat16": 1.0,
    "int8": 2.0,
}
_H100_FACTOR = {
    "float64": 67.0 / 989.0, "float32": 67.0 / 989.0,
    "float16": 1.0, "bfloat16": 1.0, "int8": 1979.0 / 989.0,
}
_H100_TF32 = 495.0 / 989.0


def _device_kind():
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0), "gpu"
    return "cpu", "cpu"


def dtype_peak_factor(dtype):
    """The per-dtype peak factor the MFU math uses (1.0 for unknown
    dtypes), for this process's device: importable by benchmarks, one
    dtype convention tree-wide."""
    dtype = str(dtype).replace("torch.", "")
    kind, _ = _device_kind()
    if kind.startswith("NVIDIA H100"):
        if dtype == "float32" and torch.backends.cuda.matmul.allow_tf32:
            return _H100_TF32
        return _H100_FACTOR.get(dtype, 1.0)
    return PEAK_DTYPE_FACTOR.get(dtype, 1.0)


_DTYPE_WIDTH = {"float64": 3, "float32": 2, "bfloat16": 1,
                "float16": 1}


def _key_compute_dtype(key):
    """The compute dtype of one argument-signature key: the narrowest
    float among tensor leaves, else int8 when only int8 tensors flow,
    else None (integer-only programs run no math worth scaling)."""
    narrowest = None
    saw_int8 = False
    for sig in key:
        dt = sig[2]
        if dt == "int8":
            saw_int8 = True
        elif dt in _DTYPE_WIDTH and (
                narrowest is None
                or _DTYPE_WIDTH[dt] < _DTYPE_WIDTH[narrowest]):
            narrowest = dt
    if narrowest is not None:
        return narrowest
    return "int8" if saw_int8 else None


_warned_kinds = set()


def _lookup_peak(table, kind, platform):
    if kind in table:
        return table[kind]
    for k, v in table.items():
        if k != "cpu" and (kind.startswith(k) or k.startswith(kind)):
            return v
    if platform != "cpu" and kind not in _warned_kinds:
        _warned_kinds.add(kind)
        warnings.warn(
            "compile_watch: no builtin peak table entry for device "
            "kind %r; using the placeholder row — set "
            "MXNET_DEVICE_PEAK_FLOPS/MXNET_DEVICE_PEAK_BW for "
            "meaningful MFU/BW figures" % kind)
    return table["cpu"]


def peak_table():
    """The (per-device peak FLOP/s, peak bytes/s, device kind, device
    count) the MFU math uses — env overrides applied. A port program
    runs on one device (a rank mesh is one process a device), so the
    count is 1."""
    kind, platform = _device_kind()
    flops = envs.get_float("MXNET_DEVICE_PEAK_FLOPS") or \
        _lookup_peak(PEAK_FLOPS, kind, platform)
    bw = envs.get_float("MXNET_DEVICE_PEAK_BW") or \
        _lookup_peak(PEAK_BW, kind, platform)
    return float(flops), float(bw), kind, 1


# ---------------------------------------------------------------------------
# watch state
# ---------------------------------------------------------------------------

class _Watch:
    """All compile/utilization accumulators. Mutation under the module
    lock; the telemetry callbacks never run while this lock is held
    (lock order: telemetry._lock → compile_watch._lock)."""

    def __init__(self):
        self.t0 = time.time()
        self.compile_count = 0
        self.compile_total_s = 0.0
        self.cache_hits = 0     # captures whose device code all came
                                # from the persistent compile cache
        self.programs = {}      # (site, statics) -> per-program dict
        self.site_last = {}     # site -> (flops, bytes) of its latest
                                # dispatch
        self.storms = []
        self.dispatches = 0
        self.step_flops = 0.0
        self.step_flops_norm = 0.0
        self.step_bytes = 0.0
        self.step_dispatches = 0
        self.step_compiles = 0
        self.step_compile_s = 0.0
        self.total_flops = 0.0
        self.total_bytes = 0.0
        self.mfu_ring = deque(maxlen=max(
            1, envs.get_int("MXNET_TELEMETRY_RING")))
        self.bw_ring = deque(maxlen=self.mfu_ring.maxlen)
        self.storm_k = max(2, envs.get_int("MXNET_COMPILE_STORM_K"))
        self.storm_steps = max(
            1, envs.get_int("MXNET_COMPILE_STORM_STEPS"))
        self.peak_flops, self.peak_bw, self.device_kind, self.n_devices \
            = peak_table()

    def program(self, site, statics):
        """Per-program state. Identity is (site, statics): programs with
        different static configuration are different programs by design;
        the same site+statics recompiling on argument signature IS
        churn. stats() re-aggregates per site."""
        key = (site, statics)
        p = self.programs.get(key)
        if p is None:
            p = self.programs[key] = {
                "site": site, "count": 0, "total_s": 0.0,
                "last_desc": None, "causes": {}, "recent": deque(),
                "warned": False, "churn": {}}
        return p


def enabled():
    """True while the compile watch is active."""
    return _watch is not None


def enable():
    """Turn the watch on (idempotent). Reads the storm/peak env knobs
    and registers the per-step utilization probe with telemetry."""
    global _watch
    with _lock:
        if _watch is None:
            _watch = _Watch()
    from . import telemetry
    telemetry._util_probe = _step_probe
    telemetry._util_reset = step_reset
    return _watch


def disable():
    """Turn the watch off; programs keep their graphs."""
    global _watch
    from . import telemetry
    telemetry._util_probe = None
    telemetry._util_reset = None
    with _lock:
        _watch = None


def reset():
    """disable(): the programs keep their graphs (recapturing identical
    programs would distort the very accounting this module exists
    for)."""
    disable()


def maybe_enable():
    """Enable when MXNET_COMPILE_WATCH asks for it (called at wrapper
    creation and from ``telemetry.start``). Returns True when active
    after the call."""
    if _watch is not None:
        return True
    if envs.get_bool("MXNET_COMPILE_WATCH"):
        enable()
        return True
    return False


# ---------------------------------------------------------------------------
# argument signatures
# ---------------------------------------------------------------------------

_SHORT_DTYPE = {"float32": "f32", "float64": "f64", "float16": "f16",
                "bfloat16": "bf16", "int32": "i32", "int64": "i64",
                "uint32": "u32", "uint8": "u8", "int8": "i8",
                "bool": "pred"}


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def signature(tensors):
    """The signature key of a flat tensor list: shape, stride, dtype and
    device of each tensor (a program specializes on all four)."""
    return tuple((tuple(t.shape), t.stride(), _dtype_name(t.dtype),
                  str(t.device)) for t in tensors)


def _short_sig(t):
    """Human form of a tensor signature: ``f32[32,784]``."""
    shape = getattr(t, "shape", None)
    if shape is None:
        return type(t).__name__
    dt = _dtype_name(getattr(t, "dtype", "?"))
    return "%s[%s]" % (_SHORT_DTYPE.get(dt, dt),
                       ",".join(str(d) for d in shape))


def describe_arrays(names, arrays):
    """name -> short signature dict for a flat array list (call-site
    helper for a program's argument names)."""
    out = {}
    for i, a in enumerate(arrays):
        n = names[i] if names is not None and i < len(names) \
            else "arg%d" % i
        out[str(n)] = _short_sig(a)
    return out


def _diff_desc(old, new):
    """(cause, churning-arg names) between two description dicts. Only
    arguments present on BOTH sides with a different signature count as
    churn; a different argument SET means a different model was bound at
    this site, which is setup, not churn."""
    if old is None:
        return "first_compile", []
    modified = []
    reshaped = []
    for name in new:
        if name not in old:
            reshaped.append("%s: new %s" % (name, new[name]))
        elif old[name] != new[name]:
            modified.append((name, "%s: %s -> %s"
                             % (name, old[name], new[name])))
    for name in old:
        if name not in new:
            reshaped.append("%s: removed" % name)
    if modified:
        names = [n for n, _ in modified]
        shown = [d for _, d in modified[:3]]
        if len(modified) > 3:
            shown.append("+%d more" % (len(modified) - 3))
        return "changed " + "; ".join(shown), names
    if reshaped:
        return "rebound " + "; ".join(reshaped[:3]), []
    # identical description but a different full key (a stride or
    # device the short form hides) or a fresh holder for the same
    # logical program (an executor rebind)
    return "rebind_or_placement", []


# ---------------------------------------------------------------------------
# cost counting
# ---------------------------------------------------------------------------

class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs. An
    upper bound of XLA's fused count: an intermediate that a fused XLA
    program keeps in registers is written and read back here, op by
    op."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves, _ = tree_flatten((args, kwargs, out))
        self.nbytes += sum(t.numel() * t.element_size() for t in leaves
                           if isinstance(t, torch.Tensor))
        return out


def count_cost(call):
    """Run ``call()`` once under the flop and byte counters; returns
    ``(output, flops, bytes)``. The hand kernels' launches inside add
    their own flops and bytes (``flash_attention.counting_work``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from .parallel import flash_attention as fa
    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteCounter()
    with fa.counting_work() as work:
        with flop_mode, byte_mode:
            out = call()
    return (out, float(flop_mode.get_total_flops()) + work["flops"],
            float(byte_mode.nbytes) + work["bytes"])


def counted(call):
    """``(wrapped, cost)``: ``wrapped()`` is ``call()``, and its FIRST
    call (a capture's eager warm-up, or a CPU program's first call) runs
    under :func:`count_cost` and fills ``cost`` (``flops``, ``bytes``).
    ``cost`` also holds this thread's compile-cache lookups before the
    first call and after the last (``cache_from``, ``cache_to``)."""
    cost = {}

    def wrapped():
        if cost:
            out = call()
        else:
            before = compile_cache.thread_outcomes()
            out, flops, nbytes = count_cost(call)
            cost.update(flops=flops, bytes=nbytes, cache_from=before)
        cost["cache_to"] = compile_cache.thread_outcomes()
        return out
    return wrapped, cost


def _cache_tag(cost):
    """The compile-cache outcome of one capture's lookups: ``"miss"``
    when any was built fresh, ``"hit"`` when all came from disk,
    ``"none"`` when it made none."""
    h0, m0 = cost.get("cache_from", (0, 0))
    h1, m1 = cost.get("cache_to", (h0, m0))
    return "miss" if m1 > m0 else "hit" if h1 > h0 else "none"


# ---------------------------------------------------------------------------
# sites and programs
# ---------------------------------------------------------------------------

class Site:
    """What a graph holder reports under: the site name, the statics
    that make it a distinct program, the argument names (for the
    recompile-cause diff) and a ``profiler.counters()`` entry that
    mirrors compile milliseconds."""

    __slots__ = ("name", "statics", "names", "counter")

    def __init__(self, name, statics=None, names=None, counter=None):
        self.name = name
        self.statics = statics
        self.names = names
        self.counter = counter


def note_compile(site, tensors, dur, cost, replaced=()):
    """Record one compile (a capture, or a CPU program's first call of a
    key) of ``site`` over ``tensors``; ``replaced`` names the in-place
    inputs whose storage changed (a recapture's cause). Returns the cost
    entry the program accrues at each later call, or None when the
    watch is off."""
    w = _watch
    if w is None:
        return None
    desc = describe_arrays(site.names, tensors)
    cdtype = _key_compute_dtype(signature(tensors))
    factor = dtype_peak_factor(cdtype) if cdtype else 1.0
    flops = cost.get("flops", 0.0)
    nbytes = cost.get("bytes", 0.0)
    cache = _cache_tag(cost) if compile_cache.enabled() else None
    event = _record_compile(w, site.name, site.statics, dur, desc, flops,
                            nbytes, list(replaced), cache)
    if cdtype is not None:
        event["compute_dtype"] = cdtype
    if site.counter:
        from . import profiler
        profiler.increment_counter(site.counter, dur * 1e3)
    _emit_compile_record(event)
    return {"flops": flops, "bytes": nbytes, "flops_norm": flops / factor}


def accrue(site, entry):
    """Accrue one call of a compiled program at ``site`` (a
    :class:`Site` or its name) into the current step."""
    w = _watch
    if w is None or entry is None:
        return
    with _lock:
        w.dispatches += 1
        w.step_dispatches += 1
        w.step_flops += entry["flops"]
        w.step_flops_norm += entry["flops_norm"]
        w.step_bytes += entry["bytes"]
        if site is not None:
            w.site_last[getattr(site, "name", site)] = (entry["flops"],
                                                        entry["bytes"])


def last_dispatch(site):
    """The cost of the latest watched dispatch at ``site``,
    ``{"flops", "bytes"}`` as the watch recorded it for the program
    (its counted FLOPs and bytes), or None when the watch is off or
    the site has not dispatched: the metering layer's cost of a
    program run."""
    w = _watch
    if w is None:
        return None
    with _lock:
        c = w.site_last.get(site)
    if c is None:
        return None
    return {"flops": c[0], "bytes": c[1]}


class WatchedFunction:
    """A program over torch tensors: on CUDA tensors one CUDA graph per
    argument signature (a ``cached_op._Graphs`` holder: the inputs are
    staged into the graph's static buffers, the outputs copied out), on
    other devices an eager call. Either way its compiles are recorded
    under ``site`` while the watch is on. Positional tensor arguments
    (a keyword call runs ``fn`` unwatched); returns what ``fn`` returns
    (a tensor or a tuple of them).
    Replays of one program are serialized (they share its static
    buffers); different programs replay concurrently."""

    def __init__(self, fn, site, names=None, counter=None, statics=None):
        from .cached_op import _Graphs
        self._fn = fn
        self._graphs = _Graphs()
        self._graphs.site = Site(site, statics=statics, names=names,
                                 counter=counter)
        self._mu = threading.Lock()
        self._single = None     # fn returns one tensor, not a tuple

    @property
    def site(self):
        return self._graphs.site.name

    @property
    def graphs(self):
        """The graph holder (its ``stats()``: captures, replays,
        recaptures)."""
        return self._graphs

    def _body(self, feed):
        out = self._fn(*feed)
        self._single = isinstance(out, torch.Tensor)
        return [out] if self._single else list(out)

    def __call__(self, *args, **kwargs):
        if kwargs:
            # every framework site is positional: a keyword call runs
            # the function as is, unwatched
            return self._fn(*args, **kwargs)
        tensors = list(args)
        data = tuple(range(len(tensors)))     # every input is staged
        if self._graphs.serves(tensors):
            with self._mu:
                outs = self._graphs.run(self._body, tensors, data)
        else:
            outs = self._graphs.eager(self._body, tensors, data)
        return outs[0] if self._single else tuple(outs)


def jit(fn, site, names=None, counter=None, statics=None):
    """Wrap ``fn`` as a :class:`WatchedFunction`: ``site`` names the
    logical program (recompiles of the same (site, statics) identity
    are diffed and storm-tracked across holders), ``names`` name the
    positional arguments for the recompile-cause diff, and ``counter``
    mirrors compile milliseconds into ``profiler.counters()``."""
    maybe_enable()
    return WatchedFunction(fn, site, names=names, counter=counter,
                           statics=statics)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def _step_clock(w):
    """The storm window's clock: telemetry steps when a run is active,
    watched calls otherwise."""
    from . import telemetry
    run = telemetry._run
    if run is not None:
        return run.steps
    return w.dispatches


def _record_compile(w, site, statics, dur, desc, flops, nbytes,
                    replaced, cache=None):
    """Fold one compile into the program's stats (under the lock) and
    return the JSONL-ready event dict, tagged with its compile-cache
    outcome ``cache`` unless None. The storm warning fires outside the
    lock."""
    storm = None
    clock = _step_clock(w)
    with _lock:
        w.compile_count += 1
        w.compile_total_s += dur
        w.step_compiles += 1
        w.step_compile_s += dur
        p = w.program(site, statics)
        p["count"] += 1
        p["total_s"] += dur
        if cache == "hit":
            w.cache_hits += 1
            p["cache_hits"] = p.get("cache_hits", 0) + 1
        if replaced:
            cause = "replaced " + "; ".join(replaced[:3])
            changed = list(replaced)
        else:
            cause, changed = _diff_desc(p["last_desc"], desc)
        p["last_desc"] = desc
        ckey = cause.split(" ", 1)[0]
        p["causes"][ckey] = p["causes"].get(ckey, 0) + 1
        for n in changed:
            p["churn"][n] = p["churn"].get(n, 0) + 1
        if changed:
            p["recent"].append(clock)
        while p["recent"] and clock - p["recent"][0] > w.storm_steps:
            p["recent"].popleft()
        if changed and len(p["recent"]) >= w.storm_k and not p["warned"]:
            p["warned"] = True
            arg = max(p["churn"], key=p["churn"].get)
            storm = {"program": site, "arg": arg,
                     "compiles": len(p["recent"]),
                     "window_steps": w.storm_steps}
            w.storms.append(storm)
        seq = p["count"]
    if storm is not None:
        warnings.warn(
            "compile_watch: recompile storm — program '%s' compiled "
            "%d times within %d steps; argument '%s' keeps changing "
            "shape/dtype or storage. Pad or bucket it (each distinct "
            "signature is a full CUDA graph capture)."
            % (storm["program"], storm["compiles"],
               storm["window_steps"], storm["arg"]), stacklevel=4)
        from . import telemetry
        telemetry.note("compile_storms")
    event = {"type": "compile", "program": site, "n": seq,
             "dur_ms": round(dur * 1e3, 3), "cause": cause}
    if changed:
        event["changed"] = list(changed)
    if flops:
        event["flops"] = flops
    if nbytes:
        event["bytes"] = nbytes
    if cache is not None:
        event["cache"] = cache
    return event


def _emit_compile_record(event):
    """Append the compile event to the active telemetry run and, with
    tracing on, render it on the trace's ``compile`` track. Called with
    no compile_watch lock held."""
    from . import telemetry, tracing
    telemetry.external_record(event)
    if tracing._tracer is not None:
        dur_s = event.get("dur_ms", 0.0) / 1e3
        args = {"program": event.get("program"),
                "cause": event.get("cause")}
        if event.get("changed"):
            args["changed"] = event["changed"]
        tracing.add("compile:%s" % event.get("program"), "compile",
                    tracing.now() - dur_s, dur_s,
                    tid=tracing.track("compile"), args=args)


def step_reset():
    """Drop anything accrued outside an open telemetry step (warm-up
    calls, init work between runs); telemetry calls this at
    ``step_begin``. No-op when the watch is off."""
    w = _watch
    if w is None:
        return
    with _lock:
        _zero_step(w)


def _zero_step(w):
    w.step_flops = 0.0
    w.step_flops_norm = 0.0
    w.step_bytes = 0.0
    w.step_dispatches = 0
    w.step_compiles = 0
    w.step_compile_s = 0.0


def run_reset():
    """Re-scope the utilization accumulators to a fresh telemetry run
    (called from ``telemetry.start``); compile counts stay lifetime and
    are run-scoped via the start() baseline."""
    w = _watch
    if w is None:
        return
    with _lock:
        w.mfu_ring.clear()
        w.bw_ring.clear()
        w.total_flops = 0.0
        w.total_bytes = 0.0
        _zero_step(w)


def _step_probe(step_seq, dur_s):
    """telemetry's per-step hook (installed by :func:`enable`): drain
    the step accumulators into a ``utilization`` record dict, or None
    when this step called nothing watched. Runs under telemetry's lock
    — must not call back into telemetry."""
    w = _watch
    if w is None:
        return None
    with _lock:
        flops = w.step_flops
        flops_norm = w.step_flops_norm
        nbytes = w.step_bytes
        dispatches = w.step_dispatches
        compiles = w.step_compiles
        compile_s = w.step_compile_s
        _zero_step(w)
        if dispatches == 0 and compiles == 0:
            return None
        w.total_flops += flops
        w.total_bytes += nbytes
        rec = {"dispatches": dispatches}
        if dur_s > 0 and flops:
            mfu = flops_norm / (dur_s * w.peak_flops * w.n_devices)
            rec["flops"] = flops
            if flops_norm != flops:
                rec["flops_norm"] = flops_norm
            rec["mfu"] = float("%.6g" % mfu)
            w.mfu_ring.append(mfu)
        if dur_s > 0 and nbytes:
            bwu = nbytes / (dur_s * w.peak_bw * w.n_devices)
            rec["bytes"] = nbytes
            rec["bw_util"] = float("%.6g" % bwu)
            w.bw_ring.append(bwu)
        if compiles:
            rec["compiles"] = compiles
            rec["compile_ms"] = round(compile_s * 1e3, 3)
        return rec


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def recent_mfu(n=None):
    """Mean MFU over the last ``n`` utilization-carrying steps (None
    when the watch is off or nothing was measured) — the Speedometer's
    extra column."""
    w = _watch
    if w is None:
        return None
    with _lock:
        vals = list(w.mfu_ring)
    if n:
        vals = vals[-int(n):]
    if not vals:
        return None
    return sum(vals) / len(vals)


def stats():
    """Snapshot: compile counts/seconds per program, causes, storms,
    utilization aggregates, the peak table in use. None when the watch
    is off."""
    w = _watch
    if w is None:
        return None
    from .telemetry import percentile
    with _lock:
        programs = {}
        for p in w.programs.values():
            agg = programs.get(p["site"])
            if agg is None:
                agg = programs[p["site"]] = {
                    "count": 0, "total_s": 0.0, "causes": {},
                    "specializations": 0}
            agg["count"] += p["count"]
            agg["total_s"] = round(agg["total_s"] + p["total_s"], 6)
            agg["specializations"] += 1
            for k, v in p["causes"].items():
                agg["causes"][k] = agg["causes"].get(k, 0) + v
            if p.get("cache_hits"):
                agg["cache_hits"] = agg.get("cache_hits", 0) \
                    + p["cache_hits"]
            if p["churn"]:
                churn = agg.setdefault("churn", {})
                for k, v in p["churn"].items():
                    churn[k] = churn.get(k, 0) + v
        mfu = list(w.mfu_ring)
        bwu = list(w.bw_ring)
        out = {
            "compiles": w.compile_count,
            "compile_total_s": round(w.compile_total_s, 6),
            "cache_hits": w.cache_hits,
            "programs": programs,
            "storms": [dict(s) for s in w.storms],
            "dispatches": w.dispatches,
            "total_flops": w.total_flops,
            "total_bytes": w.total_bytes,
            "device_kind": w.device_kind,
            "n_devices": w.n_devices,
            "peak_flops": w.peak_flops,
            "peak_bw": w.peak_bw,
        }
    if mfu:
        out["mfu"] = {"p50": percentile(mfu, 50),
                      "p90": percentile(mfu, 90),
                      "last": mfu[-1], "samples": len(mfu)}
    if bwu:
        out["bw_util"] = {"p50": percentile(bwu, 50),
                          "p90": percentile(bwu, 90),
                          "samples": len(bwu)}
    return out


def site_stats(prefix=None):
    """Per-site compile counts — ``{site: {"count", "total_s"}}``,
    optionally filtered to sites starting with ``prefix``. The serving
    oracle: under any request mix, ``site_stats("serving")`` holds
    exactly the bucket-ladder sites, each compiled once per replica
    device. None when the watch is off."""
    w = _watch
    if w is None:
        return None
    out = {}
    with _lock:
        for p in w.programs.values():
            site = p["site"]
            if prefix is not None and not site.startswith(prefix):
                continue
            agg = out.setdefault(site, {"count": 0, "total_s": 0.0})
            agg["count"] += p["count"]
            agg["total_s"] = round(agg["total_s"] + p["total_s"], 6)
            if p.get("cache_hits"):
                # captures whose device code came from the persistent
                # compile cache; present only when hits happened, so a
                # cacheless run's output keeps its shape
                agg["cache_hits"] = agg.get("cache_hits", 0) \
                    + p["cache_hits"]
    return out


def summary_blocks():
    """The ``compile`` / ``utilization`` blocks telemetry.report()
    embeds in the summary record; (None, None) when the watch is off —
    which keeps an off-run's sink byte-identical."""
    s = stats()
    if s is None:
        return None, None
    compile_block = {
        "count": s["compiles"],
        "total_s": s["compile_total_s"],
        "programs": s["programs"],
    }
    if s["storms"]:
        compile_block["storms"] = s["storms"]
    cache = compile_cache.stats()
    if cache is not None:
        compile_block["cache"] = cache
    util_block = {
        "device_kind": s["device_kind"],
        "n_devices": s["n_devices"],
        "peak_flops": s["peak_flops"],
        "peak_bw": s["peak_bw"],
        "total_flops": s["total_flops"],
        "total_bytes": s["total_bytes"],
    }
    if "mfu" in s:
        util_block["mfu"] = s["mfu"]
    if "bw_util" in s:
        util_block["bw_util"] = s["bw_util"]
    return compile_block, util_block
