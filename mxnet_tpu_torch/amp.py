"""Per-parameter dtype policy for mixed-precision (AMP) training
(counterpart of ``mxnet_tpu/amp.py``, the port's own copy).

The policy is a name-rule table: ordered user overrides (substring →
dtype, first match wins) take precedence over role heuristics;
normalization statistics and affine terms (``gamma``/``beta``/running
stats/``norm``) stay float32 whatever the compute dtype. fp32 master
weights and optimizer state live in the optimizer's multi-precision
layout (``optimizer.py``), the fused step runs the whole mixed-precision
update inside its one CUDA graph (``fused_step.py``), and dynamic loss
scaling is the ``scale_backoff`` policy of the non-finite guard
(``fault.py``); a loss-scale change is a new value in the graph's
scalar buffer, never a recapture.

Checkpoints: :func:`master_params` snapshots the exact fp32 masters
out of a Trainer's optimizer state, ``checkpoint.save_arrays(meta=
{"dtype_policy": policy.describe()})`` records the policy in the
manifest, and :func:`seed_masters` puts loaded masters back bit for bit
under any resume policy (``checkpoint.restore_params(policy=...)``
casts the fp32 arrays to each parameter's resolved dtype).
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["DtypePolicy", "parse_rules", "master_params", "seed_masters"]

# name fragments that stay float32 under any compute dtype; dense-layer
# biases follow the compute dtype so a layer's product stays one dtype
_FP32_ROLES = ("gamma", "beta", "moving_mean", "moving_var",
               "running_mean", "running_var", "norm")

_DTYPES = ("float32", "bfloat16", "float16")


def _check_dtype(dt):
    if dt not in _DTYPES:
        raise MXNetError("amp: unknown policy dtype %r (one of %s)"
                         % (dt, list(_DTYPES)))
    return dt


def parse_rules(spec):
    """Parse the ``MXNET_AMP_RULES`` grammar, ``'substring=dtype,...'``,
    into the ordered override mapping :class:`DtypePolicy` takes."""
    rules = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError("amp: bad rule %r (want 'substring=dtype')"
                             % part)
        pat, dt = part.split("=", 1)
        rules[pat.strip()] = _check_dtype(dt.strip())
    return rules


class DtypePolicy:
    """One storage/compute dtype per parameter name: ordered user
    overrides → fp32 role fragments → the compute dtype. ``compute``
    ``"float32"`` makes the policy an exact no-op."""

    def __init__(self, compute="bfloat16", rules=None):
        self.compute = _check_dtype(compute)
        self.rules = dict(rules or {})
        for dt in self.rules.values():
            _check_dtype(dt)

    @classmethod
    def from_env(cls):
        """The ``MXNET_AMP_POLICY`` + ``MXNET_AMP_RULES`` knobs; None when
        the policy knob is unset or empty (AMP off)."""
        from . import envs
        compute = envs.get_str("MXNET_AMP_POLICY")
        if not compute:
            return None
        return cls(compute=compute,
                   rules=parse_rules(envs.get_str("MXNET_AMP_RULES")))

    def resolve(self, name):
        """The policy dtype (a string) of one parameter name."""
        for pat, dt in self.rules.items():
            if pat in name:
                return dt
        low = name.lower()
        if any(r in low for r in _FP32_ROLES):
            return "float32"
        return self.compute

    def is_mixed(self):
        return self.compute != "float32"

    def apply(self, block):
        """Cast a Gluon block's parameters in place, each to its
        resolved dtype (``Parameter.cast``). Returns the block."""
        for p in block.collect_params().values():
            p.cast(self.resolve(p.name))
        return block

    def cast_params(self, params):
        """Module-path form: ``{name: NDArray}`` → a new dict with every
        value cast to its resolved dtype (values already in it pass
        through untouched)."""
        out = {}
        for name, arr in params.items():
            dt = self.resolve(name)
            out[name] = arr if str(arr.dtype) == dt else arr.astype(dt)
        return out

    def describe(self):
        """The JSON-safe manifest record: compute dtype + ordered rules."""
        return {"compute": self.compute,
                "rules": [[p, d] for p, d in self.rules.items()]}

    @classmethod
    def from_describe(cls, meta):
        """Inverse of :meth:`describe` (None for an absent record)."""
        if not meta:
            return None
        return cls(compute=meta.get("compute", "float32"),
                   rules=dict(meta.get("rules") or []))

    def __repr__(self):
        return "DtypePolicy(compute=%r, rules=%r)" % (self.compute,
                                                      self.rules)


def master_params(trainer):
    """``{name: fp32 master NDArray}`` for every multi-precision
    parameter of a Gluon Trainer: the arrays the optimizer steps, so
    checkpointing THESE makes a cross-policy resume exact. Parameters
    without a master (fp32 weights, or no state yet) are absent."""
    optimizer = trainer._optimizer
    updater = trainer._updaters[0]
    out = {}
    for i, p in enumerate(trainer._params):
        state = updater.states.get(i)
        if state is None or p._data is None:
            continue
        master = optimizer.master_from_state(p.data(), state)
        if master is not None:
            out[p.name] = master
    return out


def seed_masters(trainer, masters):
    """Seed a Trainer's optimizer state with exact fp32 masters (the
    resume half of :func:`master_params`): each named parameter gets its
    multi-precision state if absent, and its master is overwritten bit
    for bit. Names without a low-precision multi-precision layout are
    ignored. Returns the number seeded."""
    import torch
    optimizer = trainer._optimizer
    updater = trainer._updaters[0]
    seeded = 0
    for i, p in enumerate(trainer._params):
        m = masters.get(p.name)
        if m is None or p._data is None:
            continue
        if i not in updater.states:
            updater.states[i] = \
                optimizer.create_state_multi_precision(i, p.data())
            updater.states_synced[i] = True
        master = optimizer.master_from_state(p.data(), updater.states[i])
        if master is None:
            continue
        with torch.no_grad():
            master._data.copy_(m._data.to(master._data.device,
                                          torch.float32))
        seeded += 1
    return seeded
