"""Test oracles (counterpart of ``mxnet_tpu/test_utils.py``; parity:
python/mxnet/test_utils.py, the helper library the reference ships
inside the package because user tests import it).

Numeric-gradient checking against autograd, numpy-oracle forward and
backward checks, the reference's cross-device consistency oracle
(``check_consistency(sym, ctx_list=[mx.cpu(), mx.gpu(0)])``: the same
graph on every context, forward and every argument gradient, plus an
op-by-op run on the first context), and seeded reproducibility
helpers.
"""
from __future__ import annotations

import os
import numpy as np

from . import envs
from .base import MXNetError
from .context import Context, cpu, current_context

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_ndarray", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "simple_forward", "random_seed"]


def default_context():
    """The context of ``MXNET_TEST_DEFAULT_CTX`` (``gpu:0``, ``cpu``),
    else the current one (reference test_utils.py:53 uses a global; the
    variable keeps suites device-portable)."""
    name = envs.get_str("MXNET_TEST_DEFAULT_CTX")
    if name:
        dev, _, idx = name.partition(":")
        return Context(dev, int(idx or 0))
    return current_context()


def set_default_context(ctx):
    """Make ``ctx`` this thread's current context."""
    Context._scope.value = ctx


def same(a, b):
    return np.array_equal(a, b)


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=('a', 'b'),
                        equal_nan=False):
    from .ndarray import NDArray
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    rtol = 1e-5 if rtol is None else rtol
    atol = 1e-20 if atol is None else atol
    if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        index = np.unravel_index(
            np.argmax(np.abs(np.asarray(a) - np.asarray(b))),
            np.asarray(a).shape) if np.asarray(a).shape else ()
        raise AssertionError(
            "Items are not equal (rtol=%g, atol=%g):\n%s=%s\n%s=%s\n"
            "max abs err at %s" % (rtol, atol, names[0], a, names[1], b,
                                   index))


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None, **kwargs):
    from .ndarray import array
    dtype = dtype or "float32"
    data = np.random.uniform(-1, 1, size=shape).astype(dtype)
    if stype == "default":
        return array(data, ctx=ctx or default_context())
    from .ndarray import sparse as _sp
    density = 0.1 if density is None else density
    mask = np.random.uniform(0, 1, size=shape) < density
    data = data * mask
    return _sp.cast_storage(array(data, ctx=ctx or default_context()),
                            stype)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    from .ndarray import array
    ctx = ctx or default_context()
    inputs = {k: array(v, ctx=ctx) for k, v in inputs.items()}
    exe = sym.bind(ctx, inputs)
    exe.forward(is_train=is_train)
    outputs = [o.asnumpy() for o in exe.outputs]
    if len(outputs) == 1:
        outputs = outputs[0]
    return outputs


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, use_forward_train=True,
                           ctx=None, grad_stype_dict=None, dtype=np.float32):
    """Finite differences vs the executor's autograd gradient
    (reference: test_utils.py:801)."""
    from .ndarray import array
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    location = {k: np.asarray(v, dtype=dtype) for k, v in location.items()}
    aux_states = {k: np.asarray(v, dtype=dtype)
                  for k, v in (aux_states or {}).items()}
    if grad_nodes is None:
        grad_nodes = [k for k in arg_names]

    # scalarize: sum(out * random_proj) so the head is a scalar
    proj_seed = np.random.RandomState(0)

    args = {k: array(v, ctx=ctx) for k, v in location.items()}
    grad_req = {k: ("write" if k in grad_nodes else "null")
                for k in arg_names}
    grads = {k: array(np.zeros_like(location[k]), ctx=ctx)
             for k in grad_nodes}
    exe = sym.bind(ctx, args, args_grad=grads, grad_req=grad_req,
                   aux_states={k: array(v, ctx=ctx)
                               for k, v in aux_states.items()})
    exe.forward(is_train=use_forward_train)
    projs = [proj_seed.uniform(-1, 1, size=o.shape).astype(dtype)
             for o in exe.outputs]
    out_grads = [array(p, ctx=ctx) for p in projs]
    exe.forward_backward(out_grads=out_grads, is_train=use_forward_train)
    sym_grads = {k: grads[k].asnumpy() for k in grad_nodes}

    def loss_at(loc):
        a = {k: array(v, ctx=ctx) for k, v in loc.items()}
        e = sym.bind(ctx, a, aux_states={k: array(v, ctx=ctx)
                                         for k, v in aux_states.items()})
        e.forward(is_train=use_forward_train)
        return sum(float(np.sum(o.asnumpy() * p))
                   for o, p in zip(e.outputs, projs))

    atol = atol if atol is not None else rtol
    for name in grad_nodes:
        base = {k: v.copy() for k, v in location.items()}
        num_grad = np.zeros_like(location[name])
        flat = base[name].reshape(-1)
        ng_flat = num_grad.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            f_plus = loss_at(base)
            flat[i] = orig - numeric_eps
            f_minus = loss_at(base)
            flat[i] = orig
            ng_flat[i] = (f_plus - f_minus) / (2 * numeric_eps)
        assert_almost_equal(num_grad, sym_grads[name], rtol=rtol, atol=atol,
                            names=("numeric_%s" % name, "autodiff_%s" % name))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None, dtype=np.float32):
    """Forward vs numpy oracle (reference: test_utils.py:939)."""
    from .ndarray import array
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    args = {k: array(np.asarray(v, dtype=dtype), ctx=ctx)
            for k, v in location.items()}
    aux = {k: array(np.asarray(v, dtype=dtype), ctx=ctx)
           for k, v in (aux_states or {}).items()}
    exe = sym.bind(ctx, args, aux_states=aux)
    exe.forward(is_train=False)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    for out, exp in zip(exe.outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol, atol=atol)
    return exe.outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None, dtype=np.float32):
    """Backward vs numpy oracle (reference: test_utils.py:1017)."""
    from .ndarray import array
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(arg_names, expected))
    args = {k: array(np.asarray(v, dtype=dtype), ctx=ctx)
            for k, v in location.items()}
    grads = {k: array(np.zeros(np.asarray(location[k]).shape, dtype=dtype),
                      ctx=ctx) for k in expected}
    reqs = {k: (grad_req if k in expected else "null") for k in arg_names} \
        if isinstance(grad_req, str) else grad_req
    aux = {k: array(np.asarray(v, dtype=dtype), ctx=ctx)
           for k, v in (aux_states or {}).items()}
    exe = sym.bind(ctx, args, args_grad=grads, grad_req=reqs, aux_states=aux)
    ogs = [array(np.asarray(g, dtype=dtype), ctx=ctx) for g in (
        out_grads if isinstance(out_grads, (list, tuple)) else [out_grads])]
    exe.forward_backward(out_grads=ogs, is_train=True)
    for name, exp in expected.items():
        assert_almost_equal(grads[name].asnumpy(), exp, rtol=rtol, atol=atol,
                            names=("grad_%s" % name, "expected_%s" % name))
    return exe


def check_consistency(sym, ctx_list=None, scale=1.0, dtype=None,
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, grad_req="write", **kwargs):
    """Cross-device oracle (the reference's cpu-vs-gpu
    check_consistency, test_utils.py:1224): run the SAME graph through
    the executor on every context in ``ctx_list`` (``[mx.cpu(),
    mx.gpu(0)]``), plus op by op on the first context, and compare all
    outputs against the first context's. With
    ``grad_req='write'`` (the reference default) the BACKWARD runs on
    every context too and every argument gradient is compared;
    ``grad_req='null'`` restores forward-only checking."""
    from .ndarray import array, zeros as nd_zeros, ones as nd_ones
    from . import autograd as ag
    ctx = ctx_list[0] if ctx_list else default_context()
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    shapes = kwargs.get("shapes")
    if arg_params is None:
        arg_params = {n: np.random.normal(0, scale, size=s).astype(
            dtype or np.float32) for n, s in shapes.items()}
    else:
        arg_params = dict(arg_params)   # never mutate the caller's dict
    if aux_params is None:
        aux_params = {n: arg_params.pop(n) for n in aux_names
                      if n in arg_params}
    with_grad = grad_req == "write"

    def _bind(c):
        grads = {k: nd_zeros(np.shape(v), ctx=c, dtype=str(
            np.asarray(v).dtype)) for k, v in arg_params.items()} \
            if with_grad else None
        ex = sym.bind(
            c, {k: array(v, ctx=c) for k, v in arg_params.items()},
            args_grad=grads,
            grad_req={k: grad_req if with_grad else "null"
                      for k in arg_params},
            aux_states={k: array(v, ctx=c)
                        for k, v in aux_params.items()}
            if aux_params else None)
        return ex, grads

    def _run(c):
        ex, grads = _bind(c)
        outs = ex.forward(is_train=with_grad)
        g = {}
        if with_grad:
            ex.backward([nd_ones(o.shape, ctx=c,
                                 dtype=str(o.asnumpy().dtype))
                         for o in outs])
            g = {k: v.asnumpy() for k, v in grads.items()}
        return [o.asnumpy() for o in outs], g

    # symbolic path, per context — outputs AND gradients must agree
    sym_outs, sym_grads = _run(ctx)
    for other in (ctx_list or [])[1:]:
        outs_o, grads_o = _run(other)
        for ref_o, got_o in zip(sym_outs, outs_o):
            assert_almost_equal(ref_o, got_o, rtol=tol or 1e-4,
                                atol=tol or 1e-4,
                                names=(str(ctx), str(other)))
        for k in sym_grads:
            assert_almost_equal(sym_grads[k], grads_o[k],
                                rtol=tol or 1e-4, atol=tol or 1e-4,
                                names=("grad(%s)@%s" % (k, ctx),
                                       "grad(%s)@%s" % (k, other)))
    # eager path: interpret the graph node by node through NDArray ops,
    # in the symbolic leg's mode (train when gradients are checked:
    # invoke_nd takes __train__ from the autograd mode)
    env = {}
    all_params = dict(arg_params, **aux_params)
    mode = ag.train_mode() if with_grad else ag.predict_mode()
    with mode:
        for node in sym._topo_nodes():
            if node.is_variable():
                env[(id(node), 0)] = array(all_params[node.name],
                                           ctx=ctx)
            else:
                from .ndarray.ndarray import invoke_nd
                ins = [env[(id(s), i)] for (s, i) in node.inputs]
                outs = invoke_nd(node.op, ins, dict(node.attrs))
                if not isinstance(outs, list):
                    outs = [outs]
                for i, o in enumerate(outs):
                    env[(id(node), i)] = o
    eager_outs = [env[(id(n), i)].asnumpy() for (n, i) in sym._outputs]
    tol = tol or 1e-4
    for s_o, e_o in zip(sym_outs, eager_outs):
        assert_almost_equal(s_o, e_o, rtol=tol, atol=tol,
                            names=("symbolic", "eager"))
    return sym_outs


class random_seed:
    """Seed scope printing repro info on failure (reference:
    tests/python/unittest/common.py with_seed)."""

    def __init__(self, seed=None):
        self._seed = seed

    def __enter__(self):
        from . import random as _r
        seed = self._seed if self._seed is not None \
            else np.random.randint(0, 2**31)
        self.seed = seed
        np.random.seed(seed)
        _r.seed(seed)
        return self

    def __exit__(self, etype, *args):
        if etype is not None:
            print("*** test failure seed: MXNET_TEST_SEED=%d ***" % self.seed)
