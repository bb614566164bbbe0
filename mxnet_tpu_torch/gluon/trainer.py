"""Gluon Trainer on one device (counterpart of
``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` rescales the gradients by ``1/batch_size`` (times
``rescale_grad``), reduces them across workers (a no-op on one device)
and applies the optimizer, parameter by parameter, in place. A
parameter whose gradient no backward wrote since the last step is
stale: ``step`` raises unless ``ignore_stale_grad=True``, which skips
it. The kvstore kinds that span devices or processes (``dist*``,
``tpu*``) raise NotImplementedError until the parallel layer is ported
(ROADMAP queue A item 12); a fused all-parameter update is a later PR.

Telemetry, as in the JAX Trainer: each ``step``/``update`` is one step
boundary of the telemetry run (``telemetry.maybe_start`` starts one
from the environment; tick mode, the step spans from the previous
call), with the parameter update under the ``optimizer`` phase. The
JAX Trainer times the cross-worker reduce under ``sync`` only when it
has a kvstore, which one device never has, so the ``sync`` phase comes
with the multi-device kvstore. Each step also ticks the usage meter's
training account (``metering.training_step``).
"""
from __future__ import annotations

from .. import metering, telemetry
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_param_list(params):
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            "First argument must be a list or dict of Parameters, "
            "got %s." % (type(params)))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got list of %s." % (type(p)))
    return list(params)


class Trainer:
    """Applies an Optimizer to a set of Parameters after backward
    (reference: trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(kvstore, str) and ("dist" in kvstore
                                         or "tpu" in kvstore):
            raise NotImplementedError(
                "Trainer(kvstore=%r): multi-device and multi-process "
                "gradient reduction is not ported yet (ROADMAP queue A "
                "item 12)" % kvstore)
        self._params = _as_param_list(params)
        opts = dict(optimizer_params or {})
        self._scale = float(opts.get("rescale_grad", 1.0))
        roster = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if opts:
                raise AssertionError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            optimizer.param_dict = roster
        else:
            self._optimizer = opt.create(optimizer, param_dict=roster,
                                         **opts)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        sched = self._optimizer.lr_scheduler
        return self._optimizer.lr if sched is None \
            else sched(self._optimizer.num_update)

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Cross-worker gradient reduction (reference: trainer.py:331):
        nothing to reduce on one device."""

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce + update, rescaled by batch size
        (reference: trainer.py:302)."""
        telemetry.maybe_start(meta={"source": "gluon.Trainer"})
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update_step(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update only — the caller already ran allreduce_grads
        (reference: trainer.py:363)."""
        telemetry.maybe_start(meta={"source": "gluon.Trainer"})
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update_step(batch_size, ignore_stale_grad)

    def _update_step(self, batch_size, ignore_stale_grad):
        with telemetry.span("optimizer"):
            self._apply_updates(ignore_stale_grad)
        telemetry.step_tick(samples=batch_size)
        metering.training_step()

    def _apply_updates(self, ignore_stale_grad):
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            if not param._data._fresh_grad:
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` on context %s has not "
                        "been updated by backward since last `step`. This "
                        "could mean a bug in your model that made it only "
                        "use a subset of the Parameters (Blocks) for this "
                        "iteration. If you are intentionally only using a "
                        "subset, call step with ignore_stale_grad=True to "
                        "suppress this warning and skip updating of "
                        "Parameters with stale gradient"
                        % (param.name, str(param.list_ctx()[0])))
                continue
            self._updater(i, param.grad(), param.data())
            param._data._fresh_grad = False
