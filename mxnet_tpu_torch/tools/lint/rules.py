"""The mxlint rules of the port (counterpart of
``mxnet_tpu/tools/lint/rules.py``): each encodes one convention of
the package.

Four rules are the JAX package's, over the port's paths:
``atomic-write``, ``counter-lock``, ``thread-hygiene`` and
``env-registry``. Its ``jit-staging`` and ``traced-purity`` check JAX
tracing; their counterparts here check the port's programs, CUDA
graphs: ``graph-capture`` (every capture goes through
``cached_op._cuda_capture``) and ``captured-purity`` (a body handed to
a graph holder is pure). Every rule is AST-based, individually
suppressible with ``# mxlint: disable=<rule>`` and baselinable with a
written rationale; a rule may miss exotic constructions but must not
be noisy.
"""
from __future__ import annotations

import ast
import re

from .core import rule

# ---------------------------------------------------------------------------
# graph-capture: every CUDA graph capture goes through cached_op
# ---------------------------------------------------------------------------

_CAPTURE_HOME = "mxnet_tpu_torch/cached_op.py"
_GRAPH_API = ("graph", "CUDAGraph", "make_graphed_callables")
_GRAPH_RE = re.compile(r"(^|\.)cuda(\.graphs)?\.(%s)$" % "|".join(_GRAPH_API))


@rule("graph-capture",
      "every CUDA graph is captured by cached_op._cuda_capture (its "
      "process-wide capture lock, the collector held off, the launch "
      "recording)")
def check_graph_capture(ctx):
    if ctx.relpath == _CAPTURE_HOME:
        return
    al = ctx.aliases
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        try:
            text = ast.unparse(fn)
        except Exception:
            continue
        hit = bool(_GRAPH_RE.search(text))
        if not hit and isinstance(fn, ast.Name):
            ref = al.names.get(fn.id)
            hit = ref is not None and ref[1] in _GRAPH_API \
                and ref[0].startswith("torch.cuda")
        if hit:
            yield ctx.violation(
                "graph-capture", node,
                "%s(...) outside cached_op — capture through "
                "cached_op._cuda_capture (a graph holder: cached_op."
                "_Graphs, serving.decode._Programs) so the capture "
                "takes the process-wide lock, holds the cyclic "
                "collector off and records its kernel launches" % text)


# ---------------------------------------------------------------------------
# atomic-write: durable writes go tmp + os.replace
# ---------------------------------------------------------------------------

_WRITE_MODES = re.compile(r"^[wx]b?\+?$")


def _open_mode(call):
    """The mode string of an ``open`` call, or None when dynamic."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _scope_calls_os_replace(ctx, node):
    """True when the enclosing function (or module body, for
    module-level writes) also calls ``os.replace``/``os.rename`` —
    the write-then-rename discipline in one scope."""
    scope = ctx.enclosing_function(node) or ctx.tree
    for sub in ast.walk(scope):
        if isinstance(sub, ast.Call):
            base, attr = ctx.call_name(sub)
            if attr in ("replace", "rename") and base is not None \
                    and ctx.aliases.module_is(base, "os"):
                return True
    return False


@rule("atomic-write",
      "no bare open(..., 'w'/'wb') of durable files — write tmp then "
      "os.replace (a preempted save must leave the old file intact)")
def check_atomic_write(ctx):
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        base, attr = ctx.call_name(node)
        if attr != "open" or base is not None:
            continue
        mode = _open_mode(node)
        if mode is None or not _WRITE_MODES.match(mode):
            continue                     # reads, appends, dynamic
        if _scope_calls_os_replace(ctx, node):
            continue
        yield ctx.violation(
            "atomic-write", node,
            "bare open(..., %r) write without os.replace in scope — "
            "write to a tmp name and os.replace() it (see "
            "base.atomic_write_bytes)" % mode)


# ---------------------------------------------------------------------------
# counter-lock: telemetry/profiler counter bumps hold their lock
# ---------------------------------------------------------------------------

# the shared-counter attribute names of the observability stack; a
# += / -= on one of these OUTSIDE a with-lock races the readers that
# export it.  Bare local names are never flagged.
_COUNTER_ATTRS = frozenset({
    "compile_count", "compile_total_s", "cache_hits", "cache_hit_s",
    "degraded", "dispatches", "step_flops", "step_bytes",
    "step_dispatches", "step_compiles", "step_compile_s",
    "total_flops", "total_bytes", "hits", "misses", "errors",
    "evictions", "stores", "stores_dropped", "bytes_read",
    "bytes_written", "hit_s", "saves", "failures", "records_dropped",
    "dropped", "steps", "samples",
})

# dict containers whose item-writes count as counter mutations
_COUNTER_SUBSCRIPTS = ("counters", "aggregate")

_LOCKISH = re.compile(r"lock|_mu\b|mutex|cond", re.IGNORECASE)

# modules where the counter conventions apply (the observability
# stack + its writers); elsewhere ad-hoc counters are local state
_COUNTER_MODULES = (
    "mxnet_tpu_torch/profiler.py", "mxnet_tpu_torch/telemetry.py",
    "mxnet_tpu_torch/compile_watch.py",
    "mxnet_tpu_torch/livemetrics.py", "mxnet_tpu_torch/tracing.py",
    "mxnet_tpu_torch/checkpoint.py", "mxnet_tpu_torch/serving/",
    "mxnet_tpu_torch/bucketing/record.py",
)


def _counter_target(node):
    """The flagged component name when ``node`` (an assignment
    target) mutates shared counter state, else None."""
    if isinstance(node, ast.Attribute):
        if node.attr in _COUNTER_ATTRS:
            return node.attr
    if isinstance(node, ast.Subscript):
        # _state["counters"][name] = ... / ["aggregate"] writes
        inner = node.value
        if isinstance(inner, ast.Subscript) and \
                isinstance(inner.slice, ast.Constant) and \
                inner.slice.value in _COUNTER_SUBSCRIPTS:
            return '["%s"]' % inner.slice.value
    return None


@rule("counter-lock",
      "observability counter mutations (+=) hold their designated "
      "lock (an unlocked bump races the exporters that read it)")
def check_counter_lock(ctx):
    if not any(ctx.relpath.startswith(m) or ctx.relpath == m
               for m in _COUNTER_MODULES):
        return
    for node in ctx.nodes:
        if isinstance(node, ast.AugAssign):
            name = _counter_target(node.target)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Subscript):
            name = _counter_target(node.targets[0])
        else:
            continue
        if name is None:
            continue
        fn = ctx.enclosing_function(node)
        if fn is None and not isinstance(
                ctx.parents.get(node), (ast.With, ast.AsyncWith)):
            continue                 # module-level init, not mutation
        if fn is not None and fn.name in ("__init__",):
            continue                 # constructor: no concurrent view
        if fn is not None and fn.name.endswith("_locked"):
            # the tree's caller-holds-the-lock convention: the
            # ``_locked`` suffix IS the contract (and the rule checks
            # every caller site takes a lock around such calls is out
            # of scope for a lexical pass)
            continue
        if ctx.under_with_matching(node, _LOCKISH):
            continue
        yield ctx.violation(
            "counter-lock", node,
            "counter %s mutated outside a with-lock block — take "
            "the module/object lock (or suppress with a rationale "
            "if the caller provably holds it)" % name)


# ---------------------------------------------------------------------------
# thread-hygiene: daemon-or-drained threads, bounded queues
# ---------------------------------------------------------------------------

_PIPELINE_MODULES = (
    "mxnet_tpu_torch/io/", "mxnet_tpu_torch/serving/", "mxnet_tpu_torch/checkpoint.py",
    "mxnet_tpu_torch/bucketing/",
    "mxnet_tpu_torch/kvstore_server.py", "mxnet_tpu_torch/livemetrics.py",
)


def _kw(call, name):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


@rule("thread-hygiene",
      "threading.Thread sites are daemon=True (or suppressed with "
      "their join/drain path named); queue.Queue() in pipeline/"
      "writer modules declares a maxsize (bounded backpressure)")
def check_thread_hygiene(ctx):
    al = ctx.aliases
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        base, attr = ctx.call_name(node)
        # Thread(...) without daemon=True
        is_thread = (attr == "Thread" and (
            (base is not None and al.module_is(base, "threading"))
            or (base is None and al.name_is(attr, "threading",
                                            "Thread"))))
        if is_thread:
            daemon = _kw(node, "daemon")
            if not (isinstance(daemon, ast.Constant)
                    and daemon.value is True):
                yield ctx.violation(
                    "thread-hygiene", node,
                    "threading.Thread without daemon=True — a "
                    "non-daemon worker must be suppressed here with "
                    "a comment naming its join/drain path (a "
                    "non-daemon worker blocked on a put outlives "
                    "its process)")
            continue
        # unbounded queue.Queue() in pipeline/writer modules
        if not any(ctx.relpath.startswith(m) for m in
                   _PIPELINE_MODULES):
            continue
        is_queue = (attr in ("Queue", "LifoQueue",
                             "PriorityQueue") and (
            (base is not None and al.module_is(base, "queue"))
            or (base is None and al.name_is(attr, "queue", attr))))
        if is_queue:
            size = node.args[0] if node.args else _kw(node, "maxsize")
            unbounded = size is None or (
                isinstance(size, ast.Constant) and
                not size.value)
            if unbounded:
                yield ctx.violation(
                    "thread-hygiene", node,
                    "queue.Queue() without maxsize in a pipeline/"
                    "writer module — unbounded queues hide "
                    "backpressure until the host OOMs; bound it or "
                    "suppress naming the upstream bound")


# ---------------------------------------------------------------------------
# captured-purity: no host impurities inside bodies handed to a capture
# ---------------------------------------------------------------------------

_IMPURE_TIME = ("time", "perf_counter", "monotonic", "time_ns",
                "process_time")


def _capture_call_body(ctx, node):
    """The name a call hands to a graph holder as the body to capture:
    the first positional argument of ``_cuda_capture(...)``, of a
    holder's ``capture``/``_capture`` and of ``<...>graphs.run(...)``."""
    if not node.args or not isinstance(node.args[0], ast.Name):
        return None
    fn = node.func
    if isinstance(fn, ast.Name):
        return node.args[0].id if fn.id == "_cuda_capture" else None
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in ("_cuda_capture", "_capture", "capture"):
        return node.args[0].id
    if fn.attr == "run":
        recv = fn.value
        name = recv.attr if isinstance(recv, ast.Attribute) else \
            recv.id if isinstance(recv, ast.Name) else ""
        if name.endswith("graphs"):
            return node.args[0].id
    return None


def _collect_captured_functions(ctx):
    """FunctionDefs handed by name to a capture in the same file (the
    closest definition of the name in an enclosing scope, or any in the
    file when none encloses the call)."""
    defs = {}
    for node in ctx.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    out = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _capture_call_body(ctx, node)
        if name is None:
            continue
        cands = defs.get(name, ())
        scope = ctx.enclosing_function(node)
        local = [d for d in cands if scope is not None
                 and ctx.enclosing_function(d) is scope]
        out.extend(local or cands)
    return out


@rule("captured-purity",
      "no clock reads, host random draws, global mutation or "
      "os.environ reads inside a body handed to a CUDA graph capture — "
      "they run once at capture and every replay repeats that result")
def check_captured_purity(ctx):
    al = ctx.aliases
    seen = set()
    for fn in _collect_captured_functions(ctx):
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                yield ctx.violation(
                    "captured-purity", node,
                    "global statement inside captured body %r — the "
                    "mutation runs at capture only, never at a replay"
                    % fn.name)
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "random" and \
                    isinstance(f.value.value, ast.Name) and \
                    (al.module_is(f.value.value.id, "numpy")
                     or f.value.value.id in ("np", "numpy", "_np")):
                yield ctx.violation(
                    "captured-purity", node,
                    "np.random.%s inside captured body %r is drawn once "
                    "at capture and replayed as a constant — draw from "
                    "a torch.Generator registered with the graph"
                    % (f.attr, fn.name))
                continue
            if isinstance(f, ast.Attribute) and f.attr == "get" and \
                    isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "environ":
                yield ctx.violation(
                    "captured-purity", node,
                    "os.environ read inside captured body %r is "
                    "evaluated at capture only" % fn.name)
                continue
            base, attr = ctx.call_name(node)
            if base is None:
                continue
            if al.module_is(base, "time") and attr in _IMPURE_TIME:
                yield ctx.violation(
                    "captured-purity", node,
                    "time.%s() inside captured body %r runs at capture "
                    "only — a replay does not read the clock"
                    % (attr, fn.name))
            elif (al.module_is(base, "random")
                  and attr in ("random", "randint", "uniform",
                               "randrange", "choice", "shuffle",
                               "gauss", "normalvariate")):
                yield ctx.violation(
                    "captured-purity", node,
                    "python random.%s() inside captured body %r is "
                    "drawn once at capture" % (attr, fn.name))


# ---------------------------------------------------------------------------
# env-registry: MXNET_* reads go through mxnet_tpu_torch.envs
# ---------------------------------------------------------------------------

_ENV_EXEMPT_FILES = (
    "mxnet_tpu_torch/envs.py",      # the registry reads os.environ
    "mxnet_tpu_torch/tools/lint/",  # this package (fixture strings)
)


def _mxnet_const(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("MXNET_"):
        return node.value
    return None


@rule("env-registry",
      "every MXNET_* read goes through the typed mxnet_tpu_torch.envs "
      "registry (declared default + doc, MXNetError naming the "
      "variable on a malformed value)")
def check_env_registry(ctx):
    if any(ctx.relpath == m or ctx.relpath.startswith(m)
           for m in _ENV_EXEMPT_FILES):
        return
    # lazily import the registry for the declared-name check; the
    # lint must still run (minus that check) if envs cannot import
    try:
        from ... import envs as _envs
        declared = set(_envs.registry())
    except Exception:
        declared = None
    al = ctx.aliases
    for node in ctx.nodes:
        # os.environ["MXNET_X"] loads
        if isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "environ":
                name = _mxnet_const(node.slice)
                if name:
                    yield ctx.violation(
                        "env-registry", node,
                        "os.environ[%r] — read it through "
                        "mxnet_tpu_torch.envs accessors" % name)
            continue
        if not isinstance(node, ast.Call):
            continue
        base, attr = ctx.call_name(node)
        name = _mxnet_const(node.args[0]) if node.args else None
        if name is None:
            continue
        # os.environ.get("MXNET_X") / environ.get(...)
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "get" and (
                (isinstance(f.value, ast.Attribute)
                 and f.value.attr == "environ")
                or (isinstance(f.value, ast.Name)
                    and al.name_is(f.value.id, "os", "environ"))):
            yield ctx.violation(
                "env-registry", node,
                "os.environ.get(%r) — read it through "
                "mxnet_tpu_torch.envs accessors" % name)
            continue
        # os.getenv("MXNET_X")
        if attr == "getenv" and base is not None \
                and al.module_is(base, "os"):
            yield ctx.violation(
                "env-registry", node,
                "os.getenv(%r) — read it through mxnet_tpu_torch.envs "
                "accessors" % name)
            continue
        # legacy base.get_env("MXNET_X", ...)
        if attr == "get_env":
            yield ctx.violation(
                "env-registry", node,
                "legacy get_env(%r) — use the typed mxnet_tpu_torch.envs "
                "accessor (declared default + parse errors that "
                "name the variable)" % name)
            continue
        # envs.get_*("MXNET_TYPO") — statically check declarations
        if declared is not None and attr in (
                "get_bool", "get_int", "get_float", "get_str",
                "get_path", "get_raw") and base is not None \
                and al.module_is(base, "envs") \
                and name not in declared:
            yield ctx.violation(
                "env-registry", node,
                "envs.%s(%r): variable is not declared in "
                "mxnet_tpu_torch/envs.py — declare it (typo?) before "
                "reading it" % (attr, name))
