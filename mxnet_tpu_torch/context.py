"""Device contexts (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` names a (device_type, device_id) pair and resolves to a
``torch.device``: ``cpu()`` to the host, ``gpu(i)`` to ``cuda:i``. The
default context is ``gpu(0)``. Where no CUDA device is visible the
default RAISES, unless the caller asked for the CPU: ``ctx=mx.cpu()``, a
``with mx.cpu():`` scope, or ``MXNET_DEFAULT_CONTEXT=cpu``. (The JAX
package falls back to the CPU silently; the port does not.)
``cpu_pinned()`` names host memory, as in the JAX package; it resolves
to the host device.

:func:`resolve_device` is the same rule for entry points that take a
``device`` argument instead of a context (the serving path).
"""
from __future__ import annotations

import threading

import torch

from . import envs
from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "gpu_memory_info", "as_context", "context_of",
           "resolve_device"]

_NO_CUDA = ("no CUDA device is visible: mxnet_tpu_torch runs on gpu(0) "
            "by default — ask for the CPU with ctx=mx.cpu() (device='cpu' "
            "where a call takes a device), a `with mx.cpu():` scope or "
            "MXNET_DEFAULT_CONTEXT=cpu")


class Context:
    """Device context (reference: python/mxnet/context.py:29)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _scope = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._scope, "value", None)
        Context._scope.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._scope.value = self._old_ctx

    def torch_device(self):
        """The ``torch.device``; a gpu context raises where its CUDA
        device is not visible."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError("context %s: %s" % (self, _NO_CUDA))
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s: only %d CUDA device(s) visible"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    """A CPU context (reference: context.py:201)."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """A pinned host memory context (reference: context.py:219)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """A CUDA device context."""
    return Context("gpu", device_id)


def num_gpus():
    """Number of visible CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id=0):
    """``(free, total)`` bytes of CUDA device ``device_id``; raises
    where no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise MXNetError("no accelerator device present")
    return torch.cuda.mem_get_info(device_id)


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else the
    default: ``MXNET_DEFAULT_CONTEXT`` when set, else ``gpu(0)``, which
    raises where no CUDA device is visible."""
    ctx = getattr(Context._scope, "value", None)
    if ctx is not None:
        return ctx
    override = envs.get_str("MXNET_DEFAULT_CONTEXT").lower()
    if override:
        return Context(override, 0)
    if not torch.cuda.is_available():
        raise MXNetError(_NO_CUDA)
    return Context("gpu", 0)


def as_context(value):
    """A Context, or its string form (``"gpu(0)"``), as a Context."""
    if isinstance(value, Context):
        return value
    kind, _, rest = str(value).partition("(")
    return Context(kind, int(rest.rstrip(")") or 0))


def context_of(device):
    """The context of a ``torch.device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return cpu()
    if device.type == "cuda":
        return gpu(device.index if device.index is not None
                   else torch.cuda.current_device())
    raise MXNetError("no context for device %s" % device)


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`; None means the device of
    :func:`current_context` (a ``with mx.cpu():`` scope, else
    ``MXNET_DEFAULT_CONTEXT``, else ``cuda:0``), which raises when no CUDA
    device is visible and the CPU was not asked for."""
    if device is not None:
        return torch.device(device)
    return current_context().torch_device()
