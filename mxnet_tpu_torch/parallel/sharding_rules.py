"""Name-rule partition specs: the sharding-rules layer of sharded-parameter
(FSDP) training (counterpart of ``mxnet_tpu/parallel/sharding_rules.py``,
whose pure-Python rules this module copies).

Every parameter gets a :class:`~mxnet_tpu_torch.parallel.mesh.
PartitionSpec` chosen by *name heuristics* over a :class:`SpecLayout` of
named mesh axes (``data``/``fsdp``/``tp``), overridable per parameter
(ZeRO stage 3, Rajbhandari et al., SC 2020):

- :class:`SpecLayout` — the axis vocabulary, resolved against the mesh's
  real axis names by :meth:`SpecLayout.for_mesh` (on a 1-axis ``dp``
  mesh the ``fsdp`` axis *is* ``dp``: the data-parallel ranks hold the
  shards);
- :func:`parameter_spec_from_name` — embeddings and projection/ffn/
  dense/conv weights shard their leading dim over ``fsdp`` (and their
  columns over a live ``tp`` axis); norms, biases, 1-D tensors and
  unknown names stay replicated;
- :class:`ShardingRules` — overrides (ordered substring → spec, first
  match wins, ``None`` forces replicated) over the heuristics, made
  feasible for the mesh: a leading dim that does not divide the axis is
  zero-padded up to the next multiple (:class:`ParamShardPlan` carries
  the pad/slice bridges), a non-leading one drops its axis.

``MXNET_PARAM_SHARD=1`` (default off) is the gate the trainers read.
"""
from __future__ import annotations

import numpy as _np

from .mesh import PartitionSpec as P

__all__ = ["SpecLayout", "parameter_spec_from_name", "ShardingRules",
           "ParamShardPlan", "param_shard_enabled"]


def param_shard_enabled():
    """The ``MXNET_PARAM_SHARD`` gate, default off (read per build)."""
    from .. import envs
    return envs.get_bool("MXNET_PARAM_SHARD")


def _axis_sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class SpecLayout:
    """Named mesh axes for parameter sharding: ``data`` carries the
    batch, ``fsdp`` the parameter row shards, ``tp`` the column shards.
    :meth:`for_mesh` maps them onto the axes a mesh spells."""

    __slots__ = ("data_axis", "fsdp_axis", "tp_axis")

    def __init__(self, data_axis="data", fsdp_axis="fsdp", tp_axis="tp"):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis

    @classmethod
    def for_mesh(cls, mesh):
        """``fsdp`` prefers a literal ``fsdp`` axis, else rides ``dp``;
        ``tp`` survives only as an axis of size > 1; ``data`` prefers
        ``data``, else ``dp``."""
        names = tuple(getattr(mesh, "axis_names", ()))
        sizes = _axis_sizes(mesh) if names else {}
        data = "data" if "data" in names else \
            ("dp" if "dp" in names else None)
        fsdp = "fsdp" if "fsdp" in names else \
            ("dp" if "dp" in names else None)
        tp = "tp" if sizes.get("tp", 0) > 1 else None
        return cls(data_axis=data, fsdp_axis=fsdp, tp_axis=tp)

    def __repr__(self):
        return "SpecLayout(data=%r, fsdp=%r, tp=%r)" % (
            self.data_axis, self.fsdp_axis, self.tp_axis)


# name fragments of parameters replicated whatever their rank: norm
# terms and biases are tiny, and a shard would cost a gather per use
_REPLICATED_ROLES = ("bias", "beta", "gamma", "moving_mean",
                     "moving_var", "running_mean", "running_var",
                     "norm", "scale", "alpha")

# name fragments of a row-shardable projection/ffn weight
_PROJECTION_ROLES = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv",
                     "query", "key", "value", "attn", "proj", "ffn",
                     "fc", "dense", "hidden", "output", "conv",
                     "weight")

_EMBEDDING_ROLES = ("embed", "embedding", "lookup_table", "wte", "wpe")


def parameter_spec_from_name(name, shape=None, layout=None):
    """The heuristic spec of one parameter. Precedence: rank <= 1 (when
    ``shape`` is known) → replicated; a replicated role → ``P()``; an
    embedding → rows over ``fsdp``; a projection/ffn/dense/conv weight →
    rows over ``fsdp`` and, with a live ``tp`` axis, columns over ``tp``;
    anything else → replicated."""
    layout = layout or SpecLayout()
    if layout.fsdp_axis is None:
        return P()
    if shape is not None and len(shape) <= 1:
        return P()
    low = name.lower()
    if any(r in low for r in _REPLICATED_ROLES):
        return P()
    if any(r in low for r in _EMBEDDING_ROLES):
        return P(layout.fsdp_axis)
    if any(r in low for r in _PROJECTION_ROLES):
        if layout.tp_axis is not None and shape is not None \
                and len(shape) >= 2:
            return P(layout.fsdp_axis, layout.tp_axis)
        return P(layout.fsdp_axis)
    return P()


class ParamShardPlan:
    """One parameter's resolved placement: the feasible spec, the
    (possibly padded) storage shape, and the pad/slice bridges between
    the logical value and the sharded storage."""

    __slots__ = ("name", "spec", "shape", "padded_shape", "sharded",
                 "padded")

    def __init__(self, name, spec, shape, padded_shape):
        self.name = name
        self.spec = spec
        self.shape = tuple(int(s) for s in shape)
        self.padded_shape = tuple(int(s) for s in padded_shape)
        self.sharded = any(ax is not None for ax in spec)
        self.padded = self.padded_shape != self.shape

    def sharding(self, mesh):
        from .mesh import NamedSharding
        return NamedSharding(mesh, self.spec)

    def pad(self, value):
        """Zero-pad a logical value (numpy or torch) up to the storage
        shape; exact, the step slices the zero rows back off."""
        if not self.padded:
            return value
        if isinstance(value, _np.ndarray):
            return _np.pad(value, [(0, p - s) for s, p in
                                   zip(self.shape, self.padded_shape)])
        import torch
        out = torch.zeros(self.padded_shape, dtype=value.dtype,
                          device=value.device)
        out[tuple(slice(0, s) for s in self.shape)] = value
        return out

    def logical(self, value):
        """Slice a (padded) value back to the logical shape."""
        if not self.padded:
            return value
        return value[tuple(slice(0, s) for s in self.shape)]

    def bytes_per_device(self, dtype, mesh):
        """Resident bytes per rank: the padded shard of a sharded
        parameter, the full size of a replicated one."""
        n = 1
        sizes = _axis_sizes(mesh)
        for ax in self.spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n *= sizes.get(a, 1)
        total = int(_np.prod(self.padded_shape)) if self.padded_shape \
            else 1
        return (total // n) * _itemsize(dtype)


def _itemsize(dtype):
    name = str(dtype).replace("torch.", "")
    return 2 if name == "bfloat16" else _np.dtype(name).itemsize


class ShardingRules:
    """The per-mesh resolver: overrides → heuristics → feasibility.

    Per spec dim: an axis that exists and divides the dim shards as
    asked; a LEADING dim that does not divide keeps the axis and pads
    the storage (noted once per parameter as ``param_shard_padded:
    <name>``); a non-leading dim that does not divide, or an unknown
    axis, drops that entry."""

    def __init__(self, mesh, layout=None, overrides=None):
        self.mesh = mesh
        self.layout = layout if layout is not None \
            else SpecLayout.for_mesh(mesh)
        self.overrides = dict(overrides or {})
        self._axis_sizes = _axis_sizes(mesh)
        self._noted_pads = set()

    def raw_spec(self, name, shape=None):
        """The first matching override, else the name heuristic."""
        for pat, spec in self.overrides.items():
            if pat in name:
                return P() if spec is None else P(*spec)
        return parameter_spec_from_name(name, shape=shape,
                                        layout=self.layout)

    def plan(self, name, shape):
        """The feasible :class:`ParamShardPlan` of one parameter."""
        shape = tuple(int(s) for s in shape)
        spec = self.raw_spec(name, shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        entries = entries[:len(shape)]
        feasible, padded = [], list(shape)
        for d, ax in enumerate(entries):
            if ax is None:
                feasible.append(None)
                continue
            # a tuple entry shards one dim over the PRODUCT of its axes
            axes = ax if isinstance(ax, tuple) else (ax,)
            n, known = 1, True
            for a in axes:
                size = self._axis_sizes.get(a)
                if size is None:
                    known = False
                    break
                n *= size
            if not known or n <= 1:
                feasible.append(None)
            elif shape[d] % n == 0:
                feasible.append(ax)
            elif d == 0:
                feasible.append(ax)
                padded[d] = -(-shape[d] // n) * n
            else:
                feasible.append(None)
        return ParamShardPlan(name, P(*feasible), shape, padded)

    def plans(self, shapes):
        return {n: self.plan(n, s) for n, s in shapes.items()}

    def note_padded(self, name):
        """Note a padded parameter once (telemetry and the log): the pad
        is exact but costs its share of extra bytes."""
        if name in self._noted_pads:
            return
        self._noted_pads.add(name)
        from .. import telemetry
        telemetry.note("param_shard_padded:%s" % name)
        import logging
        logging.getLogger(__name__).info(
            "param shard: %s leading dim padded up to the next multiple "
            "of the shard axis (pad-and-slice, exact)", name)

    def bytes_per_device(self, shapes, dtypes):
        """``(sharded_bytes, replicated_bytes)`` resident per rank for a
        ``{name: shape}`` roster."""
        sharded = replicated = 0
        for name, shape in shapes.items():
            plan = self.plan(name, shape)
            b = plan.bytes_per_device(dtypes[name], self.mesh)
            if plan.sharded:
                sharded += b
            else:
                replicated += b
        return sharded, replicated
