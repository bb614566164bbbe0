"""Control-flow operators (counterpart of ``mxnet_tpu/ops/control_flow.py``;
reference: src/operator/control_flow.cc ``_foreach`` :1255,
``_while_loop`` :1316, ``_cond`` :1378).

A loop or branch body is a Symbol subgraph carried as an op attribute
(:class:`Subgraph`), its plan built once by
``cached_op.build_graph_callable``. The op bodies are torch code with no
host read, so a loop or a branch inside a hybridized block, a bound
executor or the fused step is captured whole in that program's CUDA
graph:

- ``_foreach`` runs the body once per slice of dim 0 (the JAX
  package's ``lax.scan``, unrolled: a captured graph holds T copies of
  the body) and stacks the per-step outputs;
- ``_while_loop`` is the JAX package's masked scan: ``max_iterations``
  steps, an ``active`` flag kept on the device and ANDed with the
  condition each step, finished steps' outputs zero and their states
  held by ``torch.where``. It never leaves the loop early on the host.
  Its gradient is the masked form's, as in the JAX package: a masked
  step still runs its body, so a body whose derivative is not finite
  there (``sqrt(0)``) gives a NaN gradient;
- ``_cond`` computes both branches and selects the taken one's outputs
  with ``torch.where`` on a device predicate. Under autograd its
  gradient is each branch's vector-Jacobian product with the whole
  incoming gradient, SELECTED by the predicate (``_Select``): the
  untaken branch's non-finite values are discarded, not multiplied by
  zero, so the gradient is the taken branch's alone, as ``lax.cond``'s.

A subgraph runs its ops in predict mode (the JAX package calls its plan
with no ``__train__``). The subgraph ops draw from the generator the
node is given, each step anew; a node draws in predict mode when an op
of one of its subgraphs does (``OpDef.draws_in``), and it runs host code
when one of them does (``Custom``: ``OpDef.runs_host_code``), so the
program holders decide about their graphs from what the loop holds.
"""
from __future__ import annotations

import json

import torch

from ..base import MXNetError
from .registry import register, normalize_attrs

__all__ = ["Subgraph"]


class Subgraph:
    """A Symbol subgraph as a callable over tensors, usable as a hashable
    op attribute.

    ``layout`` maps each subgraph argument (in ``list_arguments`` order)
    to where its value comes from at each invocation: ``("data", i)``,
    the i-th sliced input; ``("state", i)``, the i-th loop state;
    ``("free", i)``, the i-th closed-over (free) input."""

    def __init__(self, sym, layout):
        from ..cached_op import build_graph_callable
        fn, arg_names, aux_names, n_rng, n_out = build_graph_callable(sym)
        if aux_names:
            raise MXNetError(
                "control-flow subgraphs cannot carry mutable auxiliary "
                "states (got %s); hoist the stateful op out of the loop"
                % (aux_names,))
        self.sym = sym
        self.fn = fn
        self.arg_names = arg_names
        self.layout = [(str(k), int(i)) for k, i in layout]
        self.n_rng = n_rng
        self.n_out = n_out
        if len(self.layout) != len(arg_names):
            raise MXNetError(
                "subgraph layout covers %d args but the traced graph has "
                "%d (%s)" % (len(self.layout), len(arg_names), arg_names))
        # whether a run draws (in predict mode, the mode a subgraph runs
        # in), and whether it calls user Python (a Custom op)
        ops = [(n.op, normalize_attrs(n.op, n.attrs))
               for n in sym._topo_nodes() if n.op is not None]
        self.draws = any(op.draws_in(a, False) for op, a in ops)
        self.host_code = any(op.runs_host_code(a) for op, a in ops)

    def bind_vals(self, data, states, free):
        pools = {"data": data, "state": states, "free": free}
        return [pools[kind][i] for kind, i in self.layout]

    def __call__(self, data, states, free, rng=None):
        outs = self.fn({}, *self.bind_vals(data, states, free), rng=rng)
        return list(outs[:self.n_out])

    def __str__(self):
        return self.to_json_attr()

    # identity hashing, as the JAX package's
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # -- JSON round trip (Symbol.tojson / load_json) -----------------------
    def to_json_attr(self):
        return "__subgraph__:" + json.dumps(
            {"symbol": json.loads(self.sym.tojson()),
             "layout": self.layout})

    @staticmethod
    def from_json_attr(s):
        from ..symbol import symbol as _sym
        payload = json.loads(s[len("__subgraph__:"):])
        sym = _sym.load_json(json.dumps(payload["symbol"]))
        return Subgraph(sym, [(k, i) for k, i in payload["layout"]])


def _subgraphs(attrs, keys):
    return [attrs[k] for k in keys if isinstance(attrs.get(k), Subgraph)]


def _draws(keys):
    return lambda attrs, is_train: any(s.draws
                                       for s in _subgraphs(attrs, keys))


def _host_code(keys):
    return lambda attrs: any(s.host_code for s in _subgraphs(attrs, keys))


# ---------------------------------------------------------------------------
# _foreach: the body over dim 0
# ---------------------------------------------------------------------------

def _foreach_impl(attrs, *inputs, rng=None):
    sub = attrs["subgraph"]
    n_data = attrs["num_data"]
    n_state = attrs["num_states"]
    n_out_data = attrs["num_out_data"]
    data = inputs[:n_data]
    states = list(inputs[n_data:n_data + n_state])
    free = list(inputs[n_data + n_state:])
    length = data[0].shape[0] if n_data else 0
    if length == 0:
        raise MXNetError("_foreach over an empty dim 0")
    ys = [[] for _ in range(n_out_data)]
    for t in range(length):
        outs = sub([d[t] for d in data], states, free, rng=rng)
        for slot, o in zip(ys, outs[:n_out_data]):
            slot.append(o)
        states = outs[n_out_data:]
    return tuple(torch.stack(s) for s in ys) + tuple(states)


register("_foreach", _foreach_impl, arg_names=("data",),
         defaults={"subgraph": None, "num_data": 1, "num_states": 0,
                   "num_out_data": 1, "num_free": 0},
         num_outputs=lambda a: a["num_out_data"] + a["num_states"],
         key_var_num_args="__num_args__", needs_rng=True,
         draws=_draws(("subgraph",)), host_code=_host_code(("subgraph",)))


# ---------------------------------------------------------------------------
# _while_loop: a masked loop of max_iterations steps
# ---------------------------------------------------------------------------

def _while_loop_impl(attrs, *inputs, rng=None):
    cond_sub = attrs["cond_subgraph"]
    body_sub = attrs["body_subgraph"]
    n_state = attrs["num_states"]
    n_out_data = attrs["num_out_data"]
    max_iter = attrs["max_iterations"]
    if max_iter is None or int(max_iter) <= 0:
        raise MXNetError("_while_loop requires a positive max_iterations")
    n_cf = attrs["num_free_cond"]
    states = list(inputs[:n_state])
    cond_free = list(inputs[n_state:n_state + n_cf])
    body_free = list(inputs[n_state + n_cf:])
    active = torch.ones((), dtype=torch.bool, device=states[0].device)
    ys = [[] for _ in range(n_out_data)]
    for _ in range(int(max_iter)):
        c = cond_sub([], states, cond_free, rng=rng)[0]
        active = torch.logical_and(active, c.reshape(()).to(torch.bool))
        outs = body_sub([], states, body_free, rng=rng)
        for slot, o in zip(ys, outs[:n_out_data]):
            slot.append(torch.where(active, o, torch.zeros_like(o)))
        states = [torch.where(active, n, s)
                  for n, s in zip(outs[n_out_data:], states)]
    return tuple(torch.stack(s) for s in ys) + tuple(states)


register("_while_loop", _while_loop_impl, arg_names=("data",),
         defaults={"cond_subgraph": None, "body_subgraph": None,
                   "num_states": 1, "num_out_data": 0,
                   "max_iterations": None, "num_free_cond": 0,
                   "num_free_body": 0},
         num_outputs=lambda a: a["num_out_data"] + a["num_states"],
         key_var_num_args="__num_args__", needs_rng=True,
         draws=_draws(("cond_subgraph", "body_subgraph")),
         host_code=_host_code(("cond_subgraph", "body_subgraph")))


# ---------------------------------------------------------------------------
# _cond: both branches, the taken one selected on the device
# ---------------------------------------------------------------------------

class _Select(torch.autograd.Function):
    """Both branches' outputs selected by ``pred``; the backward takes
    each branch's vector-Jacobian product with the incoming gradient and
    selects between them, so the untaken branch contributes nothing,
    not even a NaN."""

    @staticmethod
    def forward(ctx, pred, then_sub, else_sub, n_state, n_then, rng, *xs):
        flags = ctx.needs_input_grad[6:]
        leaves = [x.detach().requires_grad_(f) if f else x.detach()
                  for x, f in zip(xs, flags)]
        then_in = leaves[:n_state] + leaves[n_state:n_state + n_then]
        else_in = leaves[:n_state] + leaves[n_state + n_then:]
        with torch.enable_grad():
            t_outs = then_sub([], then_in[:n_state], then_in[n_state:],
                              rng=rng)
            e_outs = else_sub([], else_in[:n_state], else_in[n_state:],
                              rng=rng)
        ctx.pred = pred
        ctx.split = (n_state, n_then)
        ctx.graphs = (then_in, t_outs, else_in, e_outs)
        outs = tuple(torch.where(pred, t.detach(), e.detach())
                     for t, e in zip(t_outs, e_outs))
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        then_in, t_outs, else_in, e_outs = ctx.graphs
        n_state, n_then = ctx.split
        pred = ctx.pred

        def vjp(outs, leaves):
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if o.requires_grad and g is not None]
            want = [x for x in leaves if x.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs and want else [None] * len(want)
            it = iter(got)
            return [next(it) if x.requires_grad else None for x in leaves]
        tg, eg = vjp(t_outs, then_in), vjp(e_outs, else_in)
        ctx.graphs = None

        def pick(x, a, b):
            if a is None and b is None:
                return None
            zero = torch.zeros_like(x)
            return torch.where(pred, zero if a is None else a,
                               zero if b is None else b)
        out = [pick(x, a, b) for x, a, b
               in zip(then_in[:n_state], tg[:n_state], eg[:n_state])]
        out += [pick(x, a, None) for x, a
                in zip(then_in[n_state:], tg[n_state:])]
        out += [pick(x, None, b) for x, b
                in zip(else_in[n_state:], eg[n_state:])]
        return (None,) * 6 + tuple(out)


def _cond_impl(attrs, *inputs, rng=None):
    pred_sub = attrs["cond_subgraph"]
    then_sub = attrs["then_subgraph"]
    else_sub = attrs["else_subgraph"]
    n_state = attrs["num_states"]       # inputs both branches share
    n_pf = attrs["num_free_cond"]
    n_tf = attrs["num_free_then"]
    states = list(inputs[:n_state])
    pred_free = list(inputs[n_state:n_state + n_pf])
    then_free = list(inputs[n_state + n_pf:n_state + n_pf + n_tf])
    else_free = list(inputs[n_state + n_pf + n_tf:])
    pred = pred_sub([], states, pred_free, rng=rng)[0]
    pred = pred.detach().reshape(()).to(torch.bool)
    branch_in = states + then_free + else_free
    if torch.is_grad_enabled() and any(x.requires_grad for x in branch_in):
        return _Select.apply(pred, then_sub, else_sub, n_state, n_tf, rng,
                             *branch_in)
    t_outs = then_sub([], states, then_free, rng=rng)
    e_outs = else_sub([], states, else_free, rng=rng)
    return tuple(torch.where(pred, t, e) for t, e in zip(t_outs, e_outs))


register("_cond", _cond_impl, arg_names=("data",),
         defaults={"cond_subgraph": None, "then_subgraph": None,
                   "else_subgraph": None, "num_states": 1,
                   "num_free_cond": 0, "num_free_then": 0,
                   "num_free_else": 0, "num_outputs_": 1},
         num_outputs=lambda a: a["num_outputs_"],
         key_var_num_args="__num_args__", needs_rng=True,
         draws=_draws(("cond_subgraph", "then_subgraph", "else_subgraph")),
         host_code=_host_code(("cond_subgraph", "then_subgraph",
                               "else_subgraph")))
