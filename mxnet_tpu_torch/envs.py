"""Typed ``MXNET_*`` environment-variable registry (counterpart of
``mxnet_tpu/envs.py``), limited to the knobs this slice reads.

Every knob is DECLARED once — name, type, default, one-line doc — and
read through the typed accessors. Names, types and defaults are the
JAX package's own:

- a read of an UNDECLARED ``MXNET_*`` name raises;
- a value that does not parse as the declared type raises
  ``MXNetError`` naming the variable;
- an accessor of the wrong kind raises;
- reads stay point-of-use (nothing is cached), so a test that flips a
  variable mid-process sees the new value.

:func:`snapshot` lists the declared knobs that are set; the flight
recorder stores it in each bundle.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from .base import MXNetError

__all__ = ["EnvVar", "declare", "declared", "registry", "get_bool",
           "get_int", "get_float", "get_str", "get_path", "get_raw",
           "snapshot", "render_reference"]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


class EnvVar:
    """One declared knob: ``name``, ``kind`` (bool/int/float/str/path),
    ``default`` (returned when unset), ``doc``, ``group``."""

    __slots__ = ("name", "kind", "default", "doc", "group")

    def __init__(self, name, kind, default, doc, group):
        self.name = name
        self.kind = kind
        self.default = default
        self.doc = doc
        self.group = group

    def __repr__(self):
        return "EnvVar(%s, %s, default=%r)" % (self.name, self.kind,
                                               self.default)


_REGISTRY: Dict[str, EnvVar] = {}


def declare(name, kind, default, doc, group="misc"):
    if kind not in ("bool", "int", "float", "str", "path"):
        raise MXNetError("envs.declare(%s): unknown kind %r"
                         % (name, kind))
    if name in _REGISTRY:
        raise MXNetError("envs.declare(%s): already declared" % name)
    var = EnvVar(name, kind, default, doc, group)
    _REGISTRY[name] = var
    return var


def declared(name):
    """True when ``name`` is a declared variable."""
    return name in _REGISTRY


def registry():
    """The declarations, in declaration order (a copy)."""
    return dict(_REGISTRY)


_G = "core"
declare("MXNET_DEFAULT_CONTEXT", "str", "",
        "Override the default device context: cpu / gpu.", _G)

_G = "fault"
declare("MXNET_FAULT_PLAN", "str", "",
        "Deterministic fault-injection plan, e.g. "
        "'serve_decode:step=1:hang' (see fault.py).", _G)
declare("MXNET_FAULT_HANG_SECONDS", "float", 0.05,
        "Duration of an injected 'hang' fault.", _G)
declare("MXNET_NONFINITE_GUARD", "str", "",
        "Non-finite gradient policy: skip_step | scale_backoff | "
        "empty (off).", _G)
declare("MXNET_LOSS_SCALE", "float", 2.0 ** 15,
        "Initial loss scale for the scale_backoff guard.", _G)
declare("MXNET_LOSS_SCALE_WINDOW", "int", 2000,
        "Good steps between loss-scale growth attempts.", _G)
declare("MXNET_AMP_POLICY", "str", "",
        "Default AMP compute dtype for amp.DtypePolicy.from_env: "
        "bfloat16 | float16 | empty (off).", _G)
declare("MXNET_AMP_RULES", "str", "",
        "Ordered per-parameter dtype overrides for the AMP policy, "
        "'substring=dtype,...' — first match wins (see amp.py).", _G)
declare("MXNET_ASYNC_CHECKPOINT", "bool", True,
        "Write checkpoints from the bounded background writer "
        "instead of blocking the step.", _G)
declare("MXNET_CHECKPOINT_INFLIGHT", "int", 2,
        "Bounded queue depth of in-flight async checkpoint "
        "snapshots (backpressure past it).", _G)
declare("MXNET_KVSTORE_TIMEOUT", "float", 60.0,
        "Seconds a collective may retry before "
        "CollectiveTimeoutError.", _G)
declare("MXNET_KVSTORE_RETRY_BACKOFF", "float", 0.05,
        "Initial collective retry backoff, seconds.", _G)
declare("MXNET_KVSTORE_RETRY_MAX_BACKOFF", "float", 2.0,
        "Backoff ceiling for collective retries, seconds.", _G)

_G = "parallel"
declare("MXNET_GRAD_OVERLAP", "bool", False,
        "Bucketed gradient exchange: the kvstore's push/pull runs "
        "once per size-capped bucket instead of once per key; on a rank "
        "mesh, a reduce-scatter per bucket and the ZeRO-1 sharded "
        "update.", _G)
declare("MXNET_GRAD_BUCKET_MB", "float", 4.0,
        "Gradient-bucket size cap for the overlap path, MB.", _G)
declare("MXNET_PARAM_SHARD", "bool", False,
        "Keep parameters FSDP-sharded at rest over the rank mesh, "
        "gathered at step entry.", _G)

_G = "io"
declare("MXNET_DATA_PIPELINE", "bool", True,
        "Route Module/Gluon fit loops through the async input "
        "pipeline.", _G)
declare("MXNET_DATA_WORKERS", "int", 2,
        "Decode-pool width of the async input pipeline.", _G)
declare("MXNET_USE_NATIVE_IO", "bool", True,
        "Use the native record/image readers where available.", _G)

_G = "bucketing"
declare("MXNET_BUCKET_LADDER", "str", "",
        "Process-default shape ladder: '8,16,32' or "
        "'4x16,8x16,8x32' (parsed by bucketing.ladder).", _G)
declare("MXNET_BUCKET_WINDOW", "int", None,
        "Ragged-stream reorder window, samples (default "
        "4 x batch_size).", _G)
declare("MXNET_BUCKETING_RECORD_EVERY", "int", 50,
        "Batches between bucketing telemetry records.", _G)

_G = "core"
declare("MXNET_FUSED_STEP", "bool", True,
        "Run the whole optimizer update (and, on the Module path, "
        "forward + backward with it) as one CUDA graph per signature "
        "(eager fallback when off).", _G)
declare("MXNET_UPDATE_ON_KVSTORE", "bool", None,
        "Run optimizer updates on the kvstore instead of the worker "
        "(default depends on the kvstore type).", _G)
declare("MXNET_ENGINE_TYPE", "str", "ThreadedEnginePerDevice",
        "Reported execution-engine type (reference-parity knob; "
        "informational: torch's streams order the work).", _G)
declare("MXNET_INT64_TENSOR_SIZE", "bool", False,
        "Enable int64 tensor indexing (large-tensor support).", _G)
declare("MXNET_TEST_DEFAULT_CTX", "str", None,
        "Device context the test utilities bind to, e.g. 'cpu' or "
        "'gpu:0'.", _G)

_G = "compile"
declare("MXNET_COMPILE_WATCH", "bool", False,
        "Watch every program site: per-capture timing, recompile "
        "causes, storms, MFU.", _G)
declare("MXNET_COMPILE_STORM_K", "int", 3,
        "Compiles of one program within the storm window that fire "
        "the recompile-storm warning.", _G)
declare("MXNET_COMPILE_STORM_STEPS", "int", 50,
        "The recompile-storm window, in telemetry steps (watched "
        "dispatches without a run).", _G)
declare("MXNET_DEVICE_PEAK_FLOPS", "float", 0.0,
        "Per-device peak FLOP/s for MFU math (0 = use the built-in "
        "peak table).", _G)
declare("MXNET_DEVICE_PEAK_BW", "float", 0.0,
        "Per-device peak memory bandwidth bytes/s for BW-utilization "
        "math (0 = built-in table).", _G)
declare("MXNET_COMPILE_CACHE_DIR", "path", "",
        "Directory for the persistent on-disk store of compiled device "
        "code (nvcc libraries, NVRTC cubins); empty disables it.", _G)
declare("MXNET_COMPILE_CACHE_MB", "float", 512.0,
        "LRU byte cap for the on-disk compile cache, in MB.", _G)
declare("MXNET_COMPILE_CACHE_QUEUE", "int", 64,
        "Bounded depth of the compile-cache background store queue "
        "(overflow drops the store, entry stays cold).", _G)

_G = "serving"
declare("MXNET_SERVING_MAX_OUTSTANDING", "int", 2,
        "Per-replica outstanding-dispatch bound (admission "
        "backpressure).", _G)
declare("MXNET_SERVING_RECORD_EVERY", "int", 50,
        "Batches between serving telemetry records.", _G)
declare("MXNET_SERVING_LATENCY_RING", "int", 8192,
        "Ring size of the serving latency reservoir.", _G)
declare("MXNET_SERVING_PRIORITIES", "int", 3,
        "Number of admission priority classes (0 lowest .. N-1 "
        "highest); overload sheds the lowest class first.", _G)
declare("MXNET_KV_PAGE_SIZE", "int", 16,
        "Tokens per KV-cache page of the paged decode pool.", _G)
declare("MXNET_KV_POOL_PAGES", "int", 256,
        "Total pages in the decode KV-cache pool (page 0 is the "
        "reserved dump page).", _G)
declare("MXNET_KV_DTYPE", "str", "float32",
        "Storage dtype of the paged KV-cache pool: float32 | "
        "bfloat16 | int8 (int8 adds per-page scales and dequantizes "
        "on gather).", _G)
declare("MXNET_KV_PREFIX_CACHE", "bool", False,
        "Prefix-aware KV page sharing: completed prefills register "
        "their page-aligned token runs in a content-hashed index; a "
        "matching later prompt enters decode on the SHARED pages.", _G)
declare("MXNET_KV_MODEL_QUOTA", "int", 0,
        "Default per-model page quota when several DecodeServers "
        "share one KVCachePool (0 = no quota).", _G)
declare("MXNET_DECODE_WINDOW", "int", 8,
        "Concurrent decode slots of the continuous batcher (the "
        "decode step's fixed batch size).", _G)
declare("MXNET_DECODE_STOP_TIMEOUT_MS", "int", 5000,
        "Bound on DecodeServer.stop waiting for its scheduler thread; "
        "past it, outstanding streams fail with ServerClosedError.", _G)

_G = "router"
declare("MXNET_ROUTER_PROBE_MS", "int", 50,
        "Milliseconds between fleet health-probe sweeps of the "
        "serving router.", _G)
declare("MXNET_ROUTER_STRIKES", "int", 2,
        "Consecutive failed probes before a replica is confirmed "
        "lost (two-strike false-positive guard).", _G)
declare("MXNET_ROUTER_MAX_INFLIGHT", "int", 8,
        "Per-replica bound on router-dispatched in-flight sessions "
        "(excess sessions wait in the tenant queues).", _G)
declare("MXNET_ROUTER_TENANT_QUEUE", "int", 256,
        "Per-tenant router queue bound; past it the newest lowest-"
        "priority queued session of that tenant is shed.", _G)
declare("MXNET_ROUTER_TENANT_WEIGHT", "float", 1.0,
        "Default weighted-fair-queueing weight of a tenant not "
        "configured explicitly.", _G)
declare("MXNET_ROUTER_TENANT_RATE", "float", 0.0,
        "Default per-tenant token-bucket refill rate, tokens/sec "
        "(prompt + budgeted generation tokens; 0 = unlimited).", _G)
declare("MXNET_ROUTER_TENANT_BURST", "float", 0.0,
        "Default per-tenant token-bucket capacity (0 = 2 x rate, or "
        "unlimited when the rate is 0).", _G)
declare("MXNET_ROUTER_DRAIN_TIMEOUT_MS", "int", 10000,
        "Graceful-drain budget per replica; sessions still streaming "
        "past it fail over to the remaining replicas.", _G)
declare("MXNET_ROUTER_RECORD_EVERY", "int", 50,
        "Router pump rounds (with activity) between router telemetry "
        "records.", _G)
declare("MXNET_ROUTER_AUTOSCALE_IDLE_ROUNDS", "int", 500,
        "Consecutive idle health-sweep rounds before the autoscaler "
        "hook suggests scale_down to the supervisor callback.", _G)

_G = "launch"
declare("MXNET_TPU_COORDINATOR", "str", None,
        "Multi-process coordinator address (host:port, or a "
        "torch.distributed init URL) for parallel.distributed.init.", _G)
declare("MXNET_TPU_WORLD", "int", None,
        "Multi-process world size.", _G)
declare("MXNET_TPU_RANK", "int", None,
        "This process's rank in the multi-process world.", _G)
declare("MXNET_LAUNCH_MAX_RESTARTS", "int", 3,
        "Supervised-launcher restart budget: whole-job relaunches "
        "after a worker death before giving up.", _G)
declare("MXNET_LAUNCH_BACKOFF", "float", 1.0,
        "First supervised-restart backoff, seconds (doubles per "
        "consecutive restart).", _G)
declare("MXNET_LAUNCH_GRACE", "float", 5.0,
        "Seconds between SIGTERM and SIGKILL when the launcher tears "
        "down surviving workers.", _G)
declare("MXNET_LAUNCH_ALLOW_SHRINK", "bool", False,
        "Supervised restart after a host loss may relaunch with N-1 "
        "workers (degraded) instead of a same-size replacement.", _G)
declare("MXNET_LAUNCH_RESTART", "int", 0,
        "Restart generation, set BY the supervisor in every worker's "
        "env (0 = first launch).", _G)
declare("MXNET_LAUNCH_RESUME_EPOCH", "int", None,
        "Last good manifest epoch, set BY the supervisor on restart "
        "so workers resume instead of starting fresh.", _G)
declare("MXNET_HB_DIR", "path", "",
        "Heartbeat directory of the launcher contract; workers "
        "touch per-rank files, the monitor detects stale peers.", _G)
declare("MXNET_HB_INTERVAL_MS", "int", 200,
        "Milliseconds between heartbeat-file touches.", _G)
declare("MXNET_HB_TIMEOUT_MS", "int", 2000,
        "Peer-heartbeat staleness that counts as a lost host "
        "(HostLostError + nonzero exit).", _G)

_G = "telemetry"
declare("MXNET_TELEMETRY", "bool", False,
        "Auto-start a telemetry run at the first step.", _G)
declare("MXNET_TELEMETRY_FILE", "path", "",
        "JSONL sink for telemetry records; empty keeps records "
        "in-memory only.", _G)
declare("MXNET_TELEMETRY_RING", "int", 1024,
        "Ring size of the per-metric latency reservoirs.", _G)
declare("MXNET_TELEMETRY_MEM_INTERVAL", "int", 10,
        "Steps between device memory samples.", _G)
declare("MXNET_TELEMETRY_FLUSH_STEPS", "int", 50,
        "Steps between sink flushes.", _G)
declare("MXNET_TELEMETRY_MAX_RECORDS", "int", 100000,
        "In-memory record cap for sink-less runs (overflow drops and "
        "counts).", _G)
declare("MXNET_TRACE", "bool", False,
        "Arm the request/step tracer.", _G)
declare("MXNET_TRACE_FILE", "path", "",
        "Perfetto-JSON sink the tracer exports to at exit/disable.", _G)
declare("MXNET_TRACE_RING", "int", 200000,
        "Bounded in-memory trace-event ring (oldest dropped).", _G)
declare("MXNET_TRACE_TRACKS", "int", 4096,
        "Cap on distinct trace tracks (request lanes).", _G)
declare("MXNET_TRACE_WIRE", "bool", True,
        "Propagate the serializable trace context across process "
        "boundaries (router dispatch) while tracing is on; off keeps "
        "every wire payload byte-identical even with a tracer armed.",
        _G)
declare("MXNET_FLIGHTREC_DIR", "path", "",
        "Arm the flight recorder: post-mortem bundles (trace ring, "
        "recent telemetry, env/graph/serving state, the triggering "
        "alert) land here on watchdog alerts and crash paths.", _G)
declare("MXNET_FLIGHTREC_MAX_BUNDLES", "int", 8,
        "Keep at most this many flight-recorder bundles (oldest "
        "deleted first).", _G)
declare("MXNET_FLIGHTREC_MAX_BYTES", "int", 16 << 20,
        "Total on-disk budget for flight-recorder bundles; oldest "
        "bundles are deleted until a new one fits.", _G)
declare("MXNET_FLIGHTREC_INTERVAL_MS", "int", 5000,
        "Rate limit between flight-recorder dumps; triggers inside "
        "the window are counted as suppressed, never stacked.", _G)
declare("MXNET_FLIGHTREC_RECORDS", "int", 256,
        "Last K telemetry records the flight recorder keeps in its "
        "bounded shadow ring for bundles.", _G)
declare("MXNET_PROFILER_MAX_EVENTS", "int", 1000000,
        "Host-profiler event cap; overflow increments "
        "profiler_events_dropped instead of growing forever.", _G)
declare("MXNET_METRICS_PORT", "int", 0,
        "Serve the live /metrics endpoint on this port (0 picks a "
        "free port when started explicitly; unset disables).", _G)
declare("MXNET_METRICS_HOST", "str", "",
        "Bind host for the /metrics endpoint (default 127.0.0.1).",
        _G)
declare("MXNET_WATCHDOG", "bool", False,
        "Arm the SLO watchdog over serving/training step health.", _G)
declare("MXNET_WATCHDOG_DRIFT", "float", 1.5,
        "Step-time drift factor over baseline that counts as a slow "
        "step.", _G)
declare("MXNET_WATCHDOG_WINDOW", "int", 20,
        "Sliding window (steps) for watchdog drift checks.", _G)
declare("MXNET_WATCHDOG_BASELINE", "int", 50,
        "Steps used to establish the watchdog's baseline step "
        "time.", _G)
declare("MXNET_WATCHDOG_SUSTAIN", "int", 10,
        "Consecutive slow windows before the watchdog fires.", _G)
declare("MXNET_WATCHDOG_SHED_RATE", "float", 0.3,
        "Shed share of new serving requests that counts as a "
        "breach.", _G)
declare("MXNET_WATCHDOG_MIN_REQUESTS", "int", 20,
        "Minimum requests in a window before serving SLO checks "
        "apply.", _G)
declare("MXNET_WATCHDOG_QUEUE_FRAC", "float", 0.9,
        "Admission-queue occupancy fraction that counts as "
        "saturation.", _G)
declare("MXNET_WATCHDOG_SKEW", "float", 2.0,
        "Max replica service-time skew before the watchdog flags an "
        "unhealthy replica.", _G)
declare("MXNET_METER_FILE", "path", "",
        "JSONL ledger for per-request usage records (metering); empty "
        "keeps the bounded in-memory tail only.", _G)
declare("MXNET_METER_FLUSH_EVERY", "int", 32,
        "Closed usage records between ledger appends and usage "
        "telemetry snapshots.", _G)
declare("MXNET_METER_MAX_RECORDS", "int", 100000,
        "In-memory cap on closed usage records (the ledger file is "
        "unbounded; the tail ring is not).", _G)


_UNSET = object()


def _var(name, kind):
    var = _REGISTRY.get(name)
    if var is None:
        raise MXNetError(
            "%s is not a registered environment variable — declare "
            "it in mxnet_tpu_torch/envs.py (typed, with a default and "
            "a one-line doc)" % name)
    if var.kind != kind:
        raise MXNetError(
            "%s is declared as %s but was read as %s — use get_%s()"
            % (name, var.kind, kind, var.kind))
    return var


def _read(name, kind, default):
    var = _var(name, kind)
    raw = os.environ.get(name)
    if raw is None:
        return var.default if default is _UNSET else default
    return raw


def _unset_default(name, default):
    var = _REGISTRY[name]
    return var.default if default is _UNSET else default


def get_bool(name, default=_UNSET) -> Optional[bool]:
    """Strict boolean: 1/true/yes/on or 0/false/no/off (case-
    insensitive); an empty value means unset; anything else raises
    naming the variable."""
    raw = _read(name, "bool", default)
    if not isinstance(raw, str):
        return raw
    tok = raw.strip().lower()
    if not tok:
        return _unset_default(name, default)
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    raise MXNetError(
        "%s=%r is not a boolean — use one of %s / %s"
        % (name, raw, "|".join(_TRUE), "|".join(_FALSE)))


def get_int(name, default=_UNSET) -> Optional[int]:
    raw = _read(name, "int", default)
    if not isinstance(raw, str):
        return raw
    if not raw.strip():
        return _unset_default(name, default)
    try:
        return int(raw.strip())
    except ValueError:
        raise MXNetError("%s=%r is not an integer" % (name, raw))


def get_float(name, default=_UNSET) -> Optional[float]:
    raw = _read(name, "float", default)
    if not isinstance(raw, str):
        return raw
    if not raw.strip():
        return _unset_default(name, default)
    try:
        return float(raw.strip())
    except ValueError:
        raise MXNetError("%s=%r is not a number" % (name, raw))


def get_str(name, default=_UNSET) -> Optional[str]:
    raw = _read(name, "str", default)
    return raw.strip() if isinstance(raw, str) else raw


def get_path(name, default=_UNSET) -> Optional[str]:
    """A filesystem path (no existence check); surrounding whitespace
    stripped."""
    raw = _read(name, "path", default)
    return raw.strip() if isinstance(raw, str) else raw


def get_raw(name) -> Optional[str]:
    """The unparsed value of a DECLARED variable (None when unset) —
    for knobs with their own grammar (``MXNET_FAULT_PLAN``,
    ``MXNET_BUCKET_LADDER``)."""
    if name not in _REGISTRY:
        _var(name, "str")          # raises the not-registered error
    return os.environ.get(name)


def snapshot():
    """{name: raw value} for every DECLARED variable currently set in
    the process environment."""
    return {name: os.environ[name] for name in _REGISTRY
            if name in os.environ}


def render_reference():
    """The MXNET_* environment-variable reference as markdown, derived
    from the registry (``python -m mxnet_tpu_torch.tools.lint --envs``)."""
    lines = ["# MXNET_* environment variables",
             "",
             "Generated from `mxnet_tpu_torch/envs.py` by "
             "`python -m mxnet_tpu_torch.tools.lint --envs` — do not "
             "edit by hand.", ""]
    groups = {}
    for var in _REGISTRY.values():
        groups.setdefault(var.group, []).append(var)
    for group, entries in groups.items():
        lines.append("## %s" % group)
        lines.append("")
        lines.append("| variable | type | default | description |")
        lines.append("|---|---|---|---|")
        for v in entries:
            default = "" if v.default is None else repr(v.default)
            lines.append("| `%s` | %s | `%s` | %s |"
                         % (v.name, v.kind, default, v.doc))
        lines.append("")
    return "\n".join(lines)
