"""Optimizers (counterpart of ``mxnet_tpu/optimizer/optimizer.py``).

Every optimizer the JAX package registers, with its attribute names,
state layouts and update arithmetic:

- the fused-kernel family (``SGD``, ``Signum``, ``FTML``, ``NAG``,
  ``Adam``, ``AdaGrad``, ``RMSProp``, ``Ftrl``, ``LBSGD``) runs the
  registered update ops of ``ops/optimizer_ops.py``;
- the composed family (``DCASGD``, ``SGLD``, ``AdaDelta``, ``Adamax``,
  ``Nadam``, ``Test``) writes the JAX package's NDArray arithmetic in
  torch.

Updates write the weight and every state in place (``copy_`` under
``no_grad``): a CUDA graph that reads them (a hybridized block's, the
fused step's) keeps its addresses.

**Multi-precision.** With ``multi_precision=True`` a float16/bfloat16
weight gets an fp32 master copy in its state (``(master, inner)``;
SGD's ``(mom_or_None, master)``), the update runs on the master and the
weight becomes the master's cast (:meth:`Optimizer.master_from_state`
reads the master back for ``amp.master_params``).

**The fused-step protocol** (``fused_step.py``):
:meth:`Optimizer.fused_step_fn` returns the update as a function over
tensors, ``fn(grad, weight, states, lr, wd, rescale) -> (new_weight,
new_states)``, the same ``*_rule`` functions the eager ops call, so a
fused step is bit-identical to the eager loop. SGD, Adam, AdaGrad and
RMSProp have one (``fn.scalar_dtype = float32`` on their
multi-precision forms); the others return None and the fused paths
fall back to the eager loop, counted.

**Updater** holds the per-index states. Every update funnels through
it, so planned ``grad`` faults and the non-finite guard (``fault.py``)
apply there. ``get_states``/``set_states`` read and write the JAX
package's pickle: ``(states, optimizer)`` whose classes are named by
their ``mxnet_tpu`` paths and whose NDArrays pickle as ``{"data":
numpy, "ctx": str}`` (:mod:`~mxnet_tpu_torch.optimizer._pickle`), so a
``.states`` file crosses between the packages both ways.

**Lazy row updates.** A row_sparse gradient (``ndarray/sparse.py``;
what ``Trainer`` builds for an ``Embedding(sparse_grad=True)``) updates
only the rows it names: SGD (with ``lazy_update``, the default), Adam
(the same), AdaGrad and Ftrl gather those rows of the weight and of each
state, run the registered update op on that block and scatter the
results back (:func:`_lazy_row_update`). Untouched rows and their states
take no weight decay and no momentum decay. ``lazy_update=False``
densifies the gradient instead.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..base import MXNetError, Registry
from .. import ops as _ops
from ..ops import optimizer_ops as _rules

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl", "Adamax",
           "Nadam", "LBSGD", "Test", "Updater", "get_updater", "register",
           "create"]

_REG = Registry("optimizer", case_sensitive=False)


def register(klass):
    _REG.register(klass.__name__)(klass)
    return klass


def _is_low_precision(dtype):
    """float16 or bfloat16 counts as low precision for master weights."""
    return str(dtype) in ("float16", "bfloat16")


def _apply(op_name, inputs, attrs):
    """Run a registered update op on NDArrays and write its new weight
    and new states back into ``inputs[0]`` and its mutable inputs, in
    place."""
    op = _ops.get_op(op_name)
    nattrs = _ops.normalize_attrs(op, attrs)
    with torch.no_grad():
        out = op.forward(nattrs, *[x._data for x in inputs])
        if not isinstance(out, (tuple, list)):
            out = (out,)
        n_out = op.resolve_num_outputs(nattrs)
        inputs[0]._data.copy_(out[0])
        for mi, val in zip(op.mutable_inputs, out[n_out:]):
            inputs[mi]._data.copy_(val)


def _lazy_row_update(op_name, weight, grad, states, attrs):
    """The row-lazy sparse update (reference: the row_sparse kernels of
    src/operator/optimizer_op.cc with ``lazy_update=True``): the
    registered update op runs on the rows ``grad`` names, gathered from
    the weight and from each state, and its results are scattered back
    into those rows in place (the row ids are unique, so the scatter is
    exact); no other row, and no other row of a state, changes."""
    op = _ops.get_op(op_name)
    nattrs = _ops.normalize_attrs(op, attrs)
    rows = grad.indices._data.to(torch.long)
    with torch.no_grad():
        picked = [weight._data.index_select(0, rows), grad.data._data] + \
            [s._data.index_select(0, rows) for s in states]
        out = op.forward(nattrs, *picked)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        n_out = op.resolve_num_outputs(nattrs)
        weight._data.index_copy_(0, rows, out[0].to(weight._data.dtype))
        for mi, val in zip(op.mutable_inputs, out[n_out:]):
            state = states[mi - 2]._data
            state.index_copy_(0, rows, val.to(state.dtype))


def _rsp_grad(grad):
    """``grad`` when it is a RowSparseNDArray, else None."""
    return grad if getattr(grad, "stype", "default") == "row_sparse" \
        else None


def _zeros_like(weight):
    from ..ndarray import NDArray
    return NDArray(torch.zeros_like(weight._data.detach()))


def _fp32_state(weight):
    """fp32 accumulator zeros on the weight's device, whatever the
    weight's dtype (the reference's ``ndarray.zeros`` default)."""
    from ..ndarray import NDArray
    return NDArray(torch.zeros_like(weight._data.detach(),
                                    dtype=torch.float32))


def _cast_copy(weight, dtype):
    from ..ndarray import NDArray
    return NDArray(weight._data.detach().to(dtype, copy=True))


class Optimizer:
    """Base optimizer: per-index update counting, lr/wd multiplier
    tables, multi-precision plumbing (reference: optimizer.py:37). With
    ``sym`` (what ``Module.init_optimizer`` passes), the symbol's
    ``__lr_mult__`` and ``__wd_mult__`` variable attributes seed the
    tables."""

    def __init__(self, rescale_grad=1., param_idx2name=None, wd=0.,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0,
                 multi_precision=False, param_dict=None):
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise AssertionError("param_idx2name should be a dict of "
                                 "param indexes to names.")
        self.rescale_grad, self.clip_gradient = rescale_grad, clip_gradient
        self.lr, self.wd = learning_rate, wd
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.aggregate_num = 0
        self.idx2name = dict(param_idx2name)
        self.sym_info = () if sym is None else \
            (sym.attr_dict(), sym.list_arguments())
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(
        lambda name, **kwargs: create(name, **kwargs))

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if _is_low_precision(weight.dtype):
            if self.multi_precision:
                master = _cast_copy(weight, torch.float32)
                return (master, self.create_state(index, master))
            warnings.warn(
                "Accumulating with float16 in optimizer can lead to poor "
                "accuracy or slow convergence. Consider using "
                "multi_precision=True option.")
        return self.create_state(index, weight)

    # -- update protocol --------------------------------------------------
    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master, inner = state
            self.update(index, master, _cast_copy(grad, torch.float32),
                        inner)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def master_from_state(self, weight, state):
        """The fp32 master NDArray in one parameter's multi-precision
        state (the base ``(master, inner)`` layout), or None when the
        weight has none."""
        if self.multi_precision and _is_low_precision(weight.dtype) \
                and isinstance(state, tuple) and len(state) == 2:
            return state[0]
        return None

    # -- hyperparameter plumbing ------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined.")
        self.lr = lr

    def _mults_from_sym(self, attr_key):
        """``{argument: multiplier}`` from the symbol's ``__lr_mult__`` or
        ``__wd_mult__`` variable attributes."""
        if not self.sym_info:
            return {}
        attrs, arg_names = self.sym_info
        return {n: float(attrs[n][attr_key]) for n in arg_names
                if attr_key in attrs.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._mults_from_sym("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # biases/betas get no decay; weights and norm gammas keep it
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._mults_from_sym("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in (index if isinstance(index, (list, tuple)) else [index]):
            count = self._index_update_count.get(idx,
                                                 self.begin_num_update) + 1
            self._index_update_count[idx] = count
            self.num_update = max(count, self.num_update)

    def _scaled(self, index, base, mult_table, param_attr):
        """``base`` scaled by the param_dict entry, the multiplier table
        or the name-keyed table, in that order."""
        if index in self.param_dict:
            return base * getattr(self.param_dict[index], param_attr)
        if index in mult_table:
            return base * mult_table[index]
        if index in self.idx2name:
            return base * mult_table.get(self.idx2name[index], 1.0)
        return base

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None else \
            self.lr_scheduler(self.num_update)
        return self._scaled(index, base, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self._scaled(index, self.wd, self.wd_mult, "wd_mult")

    def _step_inputs(self, index):
        """(lr, wd, base op attributes) for one index, counting the
        update."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return lr, wd, kw

    def _prepared_grad(self, grad, wd=None, weight=None):
        """The composed optimizers' gradient: rescale, optionally fold
        wd in, clip (a new tensor)."""
        g = grad._data * self.rescale_grad
        if wd is not None:
            g = g + wd * weight._data
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    # -- fused-step protocol (fused_step.py) ------------------------------
    def fused_step_fn(self, index, weight):
        """The update as ``fn(grad, weight, states, lr, wd, rescale) ->
        (new_weight, new_states)`` over tensors (``states`` the flat
        tuple of this index's state tensors, the scalars 0-d tensors),
        computing what the eager update computes operation for
        operation; None when this optimizer has none (the fused paths
        then run the eager loop). A multi-precision form sets
        ``fn.scalar_dtype = torch.float32``: its master math is fp32."""
        return None

    def fused_step_scalars(self, index):
        """Host-side per-step ``(lr, wd)`` for one parameter, advancing
        the update counters as the eager ``_step_inputs`` does. Per-step
        corrections (Adam's bias correction) fold into the lr."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def fused_rollback_count(self, index):
        """Undo one ``fused_step_scalars`` count advance: the guard
        skipped this parameter's update inside the graph, and the eager
        path counts only applied updates."""
        c = self._index_update_count.get(index)
        if c is None:
            return
        self._index_update_count[index] = c - 1
        self.num_update = max([self.begin_num_update]
                              + list(self._index_update_count.values()))

    def fused_static_key(self):
        """The static hyperparameters a captured fused step bakes in:
        part of its cache key, so changing one captures a new graph."""
        return (type(self).__name__, self.clip_gradient)

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)


# ---------------------------------------------------------------------------
# fused-kernel optimizers
# ---------------------------------------------------------------------------

@register
class SGD(Optimizer):
    """SGD with momentum, lazy sparse rows and multi-precision
    (reference: optimizer.py:498)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master = _cast_copy(weight, torch.float32)
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    def master_from_state(self, weight, state):
        # SGD's mp layout is (mom_or_None, master): master LAST
        if self.multi_precision and _is_low_precision(weight.dtype) \
                and isinstance(state, tuple) and len(state) == 2:
            return state[1]
        return None

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        rsp = _rsp_grad(grad)
        if rsp is not None:
            if not self.lazy_update:
                grad = rsp.tostype("default")
            elif self.momentum != 0.0:
                return _lazy_row_update("sgd_mom_update", weight, rsp,
                                        [state],
                                        dict(kw, momentum=self.momentum))
            else:
                return _lazy_row_update("sgd_update", weight, rsp, [], kw)
        if self.momentum != 0.0:
            _apply("sgd_mom_update", [weight, grad, state],
                   dict(kw, momentum=self.momentum))
        else:
            _apply("sgd_update", [weight, grad], kw)

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and _is_low_precision(weight.dtype)):
            return self.update(index, weight, grad, state)
        _, _, kw = self._step_inputs(index)
        mom, master = state if isinstance(state, tuple) else (None, state)
        if self.momentum != 0.0:
            _apply("mp_sgd_mom_update", [weight, grad, mom, master],
                   dict(kw, momentum=self.momentum))
        else:
            _apply("mp_sgd_update", [weight, grad, master], kw)

    def fused_step_fn(self, index, weight):
        """``sgd_update``/``sgd_mom_update`` (``mp_sgd_update``/
        ``mp_sgd_mom_update`` for a multi-precision low-dtype weight,
        states ``[mom?, master]``)."""
        mu, clip = self.momentum, self.clip_gradient
        if self.multi_precision and _is_low_precision(weight.dtype):
            def fn(grad, weight, states, lr, wd, rescale):
                if mu == 0.0:
                    new_w, new_w32 = _rules.mp_sgd_rule(
                        weight, grad, states[0], lr, wd, rescale, clip)
                    return new_w, (new_w32,)
                new_w, new_mom, new_w32 = _rules.mp_sgd_mom_rule(
                    weight, grad, states[0], states[1], lr, wd, rescale, mu,
                    clip)
                return new_w, (new_mom, new_w32)
            fn.scalar_dtype = torch.float32
            return fn

        def fn(grad, weight, states, lr, wd, rescale):
            if mu == 0.0:
                return _rules.sgd_rule(weight, grad, lr, wd, rescale,
                                       clip), ()
            new_w, new_mom = _rules.sgd_mom_rule(
                weight, grad, states[0], lr, wd, rescale, mu, clip)
            return new_w, (new_mom,)
        return fn

    def fused_static_key(self):
        return (type(self).__name__, self.clip_gradient, self.momentum)


@register
class Signum(Optimizer):
    """Sign-of-gradient SGD (reference: optimizer.py:728)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        if state is None:
            _apply("signsgd_update", [weight, grad], kw)
        else:
            _apply("signum_update", [weight, grad, state],
                   dict(kw, momentum=self.momentum, wd_lh=self.wd_lh))


@register
class FTML(Optimizer):
    """Follow-the-moving-leader (reference: optimizer.py:809)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        d, v, z = state
        _apply("ftml_update", [weight, grad, d, v, z],
               dict(kw, beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon,
                    t=self._index_update_count[index]))


@register
class NAG(Optimizer):
    """Nesterov momentum (reference: optimizer.py:1026)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        if state is None:
            _apply("sgd_update", [weight, grad], kw)
        else:
            _apply("nag_mom_update", [weight, grad, state],
                   dict(kw, momentum=self.momentum))


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size
    (reference: optimizer.py:1148): ``lr_t = lr * sqrt(1 - b2^t) /
    (1 - b1^t)``, not ``torch.optim.Adam``'s form."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _corrected(self, lr, index):
        t = self._index_update_count[index]
        return lr * math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        lr, _, kw = self._step_inputs(index)
        kw["lr"] = self._corrected(lr, index)
        mean, var = state
        kw.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        rsp = _rsp_grad(grad)
        if rsp is not None:
            if self.lazy_update:
                return _lazy_row_update("adam_update", weight, rsp,
                                        [mean, var], kw)
            grad = rsp.tostype("default")
        _apply("adam_update", [weight, grad, mean, var], kw)

    def fused_step_fn(self, index, weight):
        """``adam_update`` (wd folded in before the clip); ``lr`` comes
        bias-corrected from :meth:`fused_step_scalars`. A multi-precision
        low-dtype weight runs the base layout ``[master, mean, var]``."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        clip = self.clip_gradient
        if self.multi_precision and _is_low_precision(weight.dtype):
            def fn(grad, weight, states, lr, wd, rescale):
                master, mean, var = states
                new_w32, new_mean, new_var = _rules.adam_rule(
                    master, grad.to(torch.float32), mean, var, lr, wd,
                    rescale, b1, b2, eps, clip)
                return new_w32.to(weight.dtype), (new_w32, new_mean, new_var)
            fn.scalar_dtype = torch.float32
            return fn

        def fn(grad, weight, states, lr, wd, rescale):
            new_w, new_mean, new_var = _rules.adam_rule(
                weight, grad, states[0], states[1], lr, wd, rescale, b1, b2,
                eps, clip)
            return new_w, (new_mean, new_var)
        return fn

    def fused_step_scalars(self, index):
        lr, wd = super().fused_step_scalars(index)
        return self._corrected(lr, index), wd

    def fused_static_key(self):
        return (type(self).__name__, self.clip_gradient, self.beta1,
                self.beta2, self.epsilon)


@register
class AdaGrad(Optimizer):
    """Accumulated squared-gradient scaling (reference:
    optimizer.py:1280); sparse updates are always row-lazy."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        kw["epsilon"] = self.float_stable_eps
        rsp = _rsp_grad(grad)
        if rsp is not None:
            return _lazy_row_update("adagrad_update", weight, rsp, [state],
                                    kw)
        _apply("adagrad_update", [weight, grad, state], kw)

    def fused_step_fn(self, index, weight):
        """``adagrad_update`` (multi-precision: ``[master, history]``)."""
        eps, clip = self.float_stable_eps, self.clip_gradient
        if self.multi_precision and _is_low_precision(weight.dtype):
            def fn(grad, weight, states, lr, wd, rescale):
                new_w32, new_h = _rules.adagrad_rule(
                    states[0], grad.to(torch.float32), states[1], lr, wd,
                    rescale, eps, clip)
                return new_w32.to(weight.dtype), (new_w32, new_h)
            fn.scalar_dtype = torch.float32
            return fn

        def fn(grad, weight, states, lr, wd, rescale):
            new_w, new_h = _rules.adagrad_rule(weight, grad, states[0], lr,
                                               wd, rescale, eps, clip)
            return new_w, (new_h,)
        return fn

    def fused_static_key(self):
        return (type(self).__name__, self.clip_gradient,
                self.float_stable_eps)


@register
class RMSProp(Optimizer):
    """Tieleman/Hinton (plain) or Graves (centered) RMSProp (reference:
    optimizer.py:1347)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon, self.centered = epsilon, centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        states = tuple(_fp32_state(weight) for _ in range(n))
        return states if self.centered else states[0]

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        if self.centered:
            n, g, delta = state
            _apply("rmspropalex_update", [weight, grad, n, g, delta],
                   dict(kw, gamma1=self.gamma1, gamma2=self.gamma2,
                        epsilon=self.epsilon))
        else:
            _apply("rmsprop_update", [weight, grad, state],
                   dict(kw, gamma1=self.gamma1, epsilon=self.epsilon))
        if self.clip_weights:
            with torch.no_grad():
                weight._data.clamp_(-self.clip_weights, self.clip_weights)

    def fused_step_fn(self, index, weight):
        """``rmsprop_update``/``rmspropalex_update`` plus the
        ``clip_weights`` pass (multi-precision: ``[master, n]`` /
        ``[master, n, g, delta]``)."""
        rho, mu, eps = self.gamma1, self.gamma2, self.epsilon
        clip, cw = self.clip_gradient, self.clip_weights
        centered = self.centered

        def rule(w, g, sts, lr, wd, rescale):
            if centered:
                out = _rules.rmspropalex_rule(w, g, *sts, lr, wd, rescale,
                                              rho, mu, eps, clip)
            else:
                out = _rules.rmsprop_rule(w, g, sts[0], lr, wd, rescale, rho,
                                          eps, clip)
            new_w = out[0]
            if cw:
                new_w = torch.clamp(new_w, -cw, cw)
            return new_w, tuple(out[1:])

        if self.multi_precision and _is_low_precision(weight.dtype):
            def fn(grad, weight, states, lr, wd, rescale):
                new_w32, new_states = rule(states[0], grad.to(torch.float32),
                                           states[1:], lr, wd, rescale)
                return new_w32.to(weight.dtype), (new_w32,) + new_states
            fn.scalar_dtype = torch.float32
            return fn

        def fn(grad, weight, states, lr, wd, rescale):
            return rule(weight, grad, states, lr, wd, rescale)
        return fn

    def fused_static_key(self):
        return (type(self).__name__, self.clip_gradient, self.gamma1,
                self.gamma2, self.epsilon, self.centered,
                self.clip_weights)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py:1440); sparse updates are
    row-lazy."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_fp32_state(weight), _fp32_state(weight))

    def update(self, index, weight, grad, state):
        _, _, kw = self._step_inputs(index)
        kw.update(lamda1=self.lamda1, beta=self.beta)
        z, n = state
        rsp = _rsp_grad(grad)
        if rsp is not None:
            return _lazy_row_update("ftrl_update", weight, rsp, [z, n], kw)
        _apply("ftrl_update", [weight, grad, z, n], kw)


# ---------------------------------------------------------------------------
# composed optimizers
# ---------------------------------------------------------------------------

@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference: optimizer.py:778)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda
        self.weight_previous = {}

    def create_state(self, index, weight):
        mom = _zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, _cast_copy(weight, weight._data.dtype))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._step_inputs(index)
        g = self._prepared_grad(grad)
        mom, prev = state
        with torch.no_grad():
            w = weight._data
            compensated = g + wd * w + self.lamda * g * g * (w - prev._data)
            if mom is None:
                step = -lr * compensated
            else:
                mom._data.copy_(self.momentum * mom._data
                                - lr * compensated)
                step = mom._data
            prev._data.copy_(w)
            w.copy_(w + step)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: SGD plus step-scaled
    Gaussian noise, drawn from the weight's device generator
    (reference: optimizer.py:1108)."""

    def update(self, index, weight, grad, state):
        from .. import random as _random
        lr, wd, _ = self._step_inputs(index)
        g = self._prepared_grad(grad)
        with torch.no_grad():
            w = weight._data
            noise = torch.randn(w.shape, generator=_random.generator(
                w.device), device=w.device, dtype=torch.float32) \
                .to(w.dtype) * math.sqrt(lr)
            w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class AdaDelta(Optimizer):
    """Adaptive delta with two squared accumulators (reference:
    optimizer.py:1500)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_fp32_state(weight), _fp32_state(weight))

    def update(self, index, weight, grad, state):
        _, wd, _ = self._step_inputs(index)
        g = self._prepared_grad(grad)
        sq_grad, sq_delta = (s._data for s in state)
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            sq_grad.copy_(rho * sq_grad + (1. - rho) * g * g)
            delta = (torch.sqrt(sq_delta + eps)
                     / torch.sqrt(sq_grad + eps)) * g
            sq_delta.copy_(rho * sq_delta + (1. - rho) * delta * delta)
            w = weight._data
            w.copy_(w - delta - wd * w)


@register
class Adamax(Optimizer):
    """Infinity-norm Adam (reference: optimizer.py:1553)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_fp32_state(weight), _fp32_state(weight))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._step_inputs(index)
        lr /= 1. - self.beta1 ** self._index_update_count[index]
        g = self._prepared_grad(grad, wd, weight)
        m, u = (s._data for s in state)
        with torch.no_grad():
            m.copy_(self.beta1 * m + (1. - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
            w = weight._data
            w.copy_(w - lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with a Nesterov momentum schedule (reference:
    optimizer.py:1591)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_fp32_state(weight), _fp32_state(weight))

    def _momentum_at(self, t):
        return self.beta1 * (1. - 0.5 * 0.96 ** (t * self.schedule_decay))

    def update(self, index, weight, grad, state):
        lr, wd, _ = self._step_inputs(index)
        t = self._index_update_count[index]
        g = self._prepared_grad(grad, wd, weight)
        mu_t, mu_next = self._momentum_at(t), self._momentum_at(t + 1)
        self.m_schedule *= mu_t
        schedule_next = self.m_schedule * mu_next
        m, v = (s._data for s in state)
        with torch.no_grad():
            m.copy_(self.beta1 * m + (1. - self.beta1) * g)
            v.copy_(self.beta2 * v + (1. - self.beta2) * g * g)
            g_hat = g / (1. - self.m_schedule)
            m_hat = m / (1. - schedule_next)
            v_hat = v / (1. - self.beta2 ** t)
            blended = (1. - mu_t) * g_hat + mu_next * m_hat
            w = weight._data
            w.copy_(w - lr * blended / (torch.sqrt(v_hat) + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD with LARS-style warmup (reference:
    optimizer.py:856); implemented as layer-wise-scaled SGD."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy='linear', warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(momentum=momentum,
                         multi_precision=multi_precision, **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs, self.num_epochs = warmup_epochs, num_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch


@register
class Test(Optimizer):
    """Plain ``w -= lr * grad`` (the reference keeps one too)."""

    def create_state(self, index, weight):
        return _fp32_state(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            w = weight._data
            w.copy_(w - self.lr * (grad._data * self.rescale_grad))


# registry alias matching the reference
_REG.register("ccsgd", allow_override=True)(SGD)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    cls = _REG.find(str(name))
    if cls is None:
        raise MXNetError("Cannot find optimizer %s" % name)
    return cls(**kwargs)


class Updater:
    """Per-index optimizer state around one Optimizer (reference:
    optimizer.py:1608). A state is made at a parameter's first update.
    Planned ``grad`` faults and the non-finite guard act here; with
    neither on the call goes straight to the optimizer."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        from .. import fault
        if fault.is_enabled():
            grad, skip = fault.filter_gradient(index, grad)
            if skip:
                return
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, context):
        return state

    def set_states(self, states):
        """Load what :meth:`get_states` (of either package) wrote."""
        from ._pickle import loads
        payload = loads(states)
        if isinstance(payload, tuple) and len(payload) == 2:
            self.states, self.optimizer = payload
        else:
            self.states = payload
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        """The pickle the JAX package's ``Updater.set_states`` loads."""
        from ._pickle import dumps
        return dumps((self.states, self.optimizer) if dump_optimizer
                     else self.states)


def get_updater(optimizer):
    return Updater(optimizer)
