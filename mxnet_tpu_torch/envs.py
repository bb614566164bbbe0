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
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from .base import MXNetError

__all__ = ["EnvVar", "declare", "registry", "get_bool", "get_int",
           "get_float", "get_str", "get_raw"]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


class EnvVar:
    """One declared knob: ``name``, ``kind`` (bool/int/float/str),
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
    if kind not in ("bool", "int", "float", "str"):
        raise MXNetError("envs.declare(%s): unknown kind %r"
                         % (name, kind))
    if name in _REGISTRY:
        raise MXNetError("envs.declare(%s): already declared" % name)
    var = EnvVar(name, kind, default, doc, group)
    _REGISTRY[name] = var
    return var


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

_G = "serving"
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


def get_raw(name) -> Optional[str]:
    """The unparsed value of a DECLARED variable (None when unset) —
    for knobs with their own grammar (``MXNET_FAULT_PLAN``)."""
    if name not in _REGISTRY:
        _var(name, "str")          # raises the not-registered error
    return os.environ.get(name)
