"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``):
the ``_contrib_*`` ops under their short names, and the symbolic control
flow (reference: python/mxnet/symbol/contrib.py foreach/while_loop/cond,
backed by src/operator/control_flow.cc).

The body runs once over placeholder variables and yields a subgraph
Symbol; every other variable the body touches is a *free* input, cut at
its variable leaves as the reference's ``_cut_subgraph`` cuts it (a
Gluon parameter used in the body binds and takes its gradient through
the node's input). The subgraph becomes a :class:`Subgraph` attribute of
ONE ``_foreach``/``_while_loop``/``_cond`` node (``ops/control_flow.py``),
which a bound executor, a hybridized block or the fused step runs inside
its own program, captured whole in its CUDA graph.
"""
from __future__ import annotations

import itertools

from ..base import MXNetError
from ..ops.control_flow import Subgraph
from . import symbol as _sym

__all__ = ["foreach", "while_loop", "cond"]

_uid = itertools.count()


def _as_list(x):
    if x is None:
        return [], True
    if isinstance(x, (list, tuple)):
        return list(x), False
    return [x], True


def _check_syms(syms, what):
    for s in syms:
        if not isinstance(s, _sym.Symbol):
            raise MXNetError("%s must be Symbols, got %s" % (what, type(s)))
        if len(s._outputs) != 1:
            raise MXNetError("%s must be single-output Symbols" % what)


def _cut(outs, placeholders):
    """``(Subgraph, free input Symbols)`` of the traced outputs.

    ``placeholders`` maps a placeholder variable's name to ``("data" |
    "state", i)``. A free variable keeps its outer node, so the returned
    Symbols bind by the caller's own names."""
    group = _sym.Group(outs)
    var_nodes = {n.name: n for n in group._topo_nodes() if n.is_variable()}
    layout, free_syms = [], []
    for a in group.list_arguments():
        if a in placeholders:
            layout.append(placeholders[a])
        else:
            layout.append(("free", len(free_syms)))
            free_syms.append(_sym.Symbol([(var_nodes[a], 0)]))
    return Subgraph(group, layout), free_syms


def _placeholders(prefix, kind, n, placeholders):
    out = []
    for i in range(n):
        name = "%s%d" % (prefix, i)
        placeholders[name] = (kind, i)
        out.append(_sym.var(name))
    return out


def foreach(body, data, init_states, name=None):
    """Run ``body`` over dim 0 of ``data`` (reference: symbol/contrib.py
    foreach, control_flow.cc:1255): ``body(data_item, states) ->
    (outputs, new_states)``. Returns ``(outputs, final_states)``, the
    outputs stacked on a new leading axis."""
    uid = next(_uid)
    data_list, data_single = _as_list(data)
    states, states_single = _as_list(init_states)
    _check_syms(data_list, "foreach data")
    _check_syms(states, "foreach init_states")
    if not data_list:
        raise MXNetError("foreach needs at least one data input")

    placeholders = {}
    data_vars = _placeholders("_foreach%d_data" % uid, "data",
                              len(data_list), placeholders)
    state_vars = _placeholders("_foreach%d_state" % uid, "state",
                               len(states), placeholders)
    outs, new_states = body(data_vars[0] if data_single else data_vars,
                            state_vars[0] if states_single else state_vars)
    outs, outs_single = _as_list(outs)
    new_states, _ = _as_list(new_states)
    if len(new_states) != len(states):
        raise MXNetError("foreach body returned %d states, expected %d"
                         % (len(new_states), len(states)))

    sub, free_syms = _cut(outs + new_states, placeholders)
    inputs = data_list + states + free_syms
    res = _sym.create(
        "_foreach", inputs,
        {"subgraph": sub, "num_data": len(data_list),
         "num_states": len(states), "num_out_data": len(outs),
         "num_free": len(free_syms), "__num_args__": len(inputs)},
        name=name)
    out_syms = [res[i] for i in range(len(outs))]
    state_syms = [res[len(outs) + i] for i in range(len(states))]
    return (out_syms[0] if outs_single else out_syms,
            state_syms[0] if states_single else state_syms)


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """A loop of at most ``max_iterations`` steps (reference:
    symbol/contrib.py while_loop, control_flow.cc:1316): ``cond(*loop_vars)
    -> scalar``, ``func(*loop_vars) -> (outputs, new_loop_vars)``. The
    stacked outputs have ``max_iterations`` rows, zero past the steps
    run (the reference leaves them undefined)."""
    uid = next(_uid)
    loop_vars, single_var = _as_list(loop_vars)
    _check_syms(loop_vars, "while_loop loop_vars")
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    if not loop_vars:
        raise MXNetError("while_loop requires at least one loop var")

    placeholders = {}
    state_vars = _placeholders("_while%d_var" % uid, "state",
                               len(loop_vars), placeholders)
    cond_out = cond(*state_vars)
    if not isinstance(cond_out, _sym.Symbol):
        raise MXNetError("while_loop cond must return a Symbol")
    cond_sub, cond_free = _cut([cond_out], placeholders)

    step = func(*state_vars)
    if not (isinstance(step, tuple) and len(step) == 2):
        raise MXNetError(
            "while_loop func must return (outputs, new_loop_vars)")
    outs, new_vars = step
    outs, outs_single = _as_list(outs)
    new_vars, _ = _as_list(new_vars)
    if len(new_vars) != len(loop_vars):
        raise MXNetError(
            "while_loop func returned %d loop_vars, expected %d"
            % (len(new_vars), len(loop_vars)))
    body_sub, body_free = _cut(outs + new_vars, placeholders)

    inputs = loop_vars + cond_free + body_free
    res = _sym.create(
        "_while_loop", inputs,
        {"cond_subgraph": cond_sub, "body_subgraph": body_sub,
         "num_states": len(loop_vars), "num_out_data": len(outs),
         "max_iterations": int(max_iterations),
         "num_free_cond": len(cond_free), "num_free_body": len(body_free),
         "__num_args__": len(inputs)},
        name=name)
    out_syms = [res[i] for i in range(len(outs))]
    var_syms = [res[len(outs) + i] for i in range(len(loop_vars))]
    return (out_syms[0] if outs_single else out_syms,
            var_syms[0] if single_var else var_syms)


def cond(pred, then_func, else_func, name=None):
    """``then_func()`` where the scalar Symbol ``pred`` is nonzero, else
    ``else_func()`` (reference: symbol/contrib.py cond,
    control_flow.cc:1378); the branches take no arguments and close over
    outer Symbols. The predicate is read on the device."""
    if not isinstance(pred, _sym.Symbol):
        raise MXNetError("cond pred must be a Symbol")
    pred_sub, pred_free = _cut([pred], {})
    then_outs, then_single = _as_list(then_func())
    _check_syms(then_outs, "cond then outputs")
    then_sub, then_free = _cut(then_outs, {})
    else_outs, _ = _as_list(else_func())
    _check_syms(else_outs, "cond else outputs")
    else_sub, else_free = _cut(else_outs, {})
    if len(then_outs) != len(else_outs):
        raise MXNetError(
            "cond branches must return the same number of outputs "
            "(%d vs %d)" % (len(then_outs), len(else_outs)))

    inputs = pred_free + then_free + else_free
    res = _sym.create(
        "_cond", inputs,
        {"cond_subgraph": pred_sub, "then_subgraph": then_sub,
         "else_subgraph": else_sub, "num_states": 0,
         "num_free_cond": len(pred_free), "num_free_then": len(then_free),
         "num_free_else": len(else_free), "num_outputs_": len(then_outs),
         "__num_args__": len(inputs)},
        name=name)
    outs = [res[i] for i in range(len(then_outs))]
    return outs[0] if then_single else outs


def _install():
    from ..ndarray.contrib import install_contrib_ops
    from . import register as _register
    install_contrib_ops(globals(), _register.make_stub)


_install()
