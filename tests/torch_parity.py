"""Shared harness of the port's operator parity tests
(``tests/test_torch_ops_*.py``): one registered op run through the JAX
package's registry (its ``forward`` under ``jax.vjp``) and through the
port's (``ops.invoke`` under torch autograd) on the same numpy inputs,
outputs and input gradients compared. No JAX Gluon block is built."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import mxnet_tpu.ops as jops
import mxnet_tpu_torch.ops as tops

TOL = dict(rtol=1e-5, atol=1e-6)


def rand(seed, *shape, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.randn(*shape).astype(np.float32)


def _floating(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def jax_run(name, arrays, attrs, grad=False, grad_outs=None):
    """The JAX op's outputs (numpy) and, with ``grad``, the ``jax.vjp``
    of its float inputs over the outputs ``grad_outs`` (every float
    output by default), from one evaluation."""
    op = jops.get_op(name)
    nattrs = jops.normalize_attrs(op, attrs)
    n_out = op.resolve_num_outputs(nattrs)
    xs = [jnp.asarray(a) for a in arrays]

    def f(*vals):
        return _as_tuple(op.forward(nattrs, *vals))[:n_out]

    if not grad:
        return [np.asarray(o) for o in f(*xs)], None
    diff = [i for i, a in enumerate(arrays) if _floating(a)]

    def g(*fvals):
        full = list(xs)
        for i, v in zip(diff, fvals):
            full[i] = v
        res = f(*full)
        sel = grad_outs if grad_outs is not None else \
            [k for k, o in enumerate(res)
             if jnp.issubdtype(o.dtype, jnp.floating)]
        return tuple(res[k] for k in sel), res

    _, vjp, outs = jax.vjp(g, *[xs[i] for i in diff], has_aux=True)

    def grads(heads):
        return [np.asarray(gr)
                for gr in vjp(tuple(jnp.asarray(h) for h in heads))]
    return [np.asarray(o) for o in outs], grads


def port_run(name, arrays, attrs, heads=None, grad_outs=None,
             device="cpu"):
    """The port op's outputs and gradients, as :func:`jax_run`."""
    op = tops.get_op(name)
    ts = [torch.from_numpy(np.array(a, copy=True)).to(device)
          for a in arrays]
    diff = [i for i, a in enumerate(arrays) if _floating(a)]
    if heads is not None:
        for i in diff:
            ts[i].requires_grad_(True)
    with torch.set_grad_enabled(heads is not None):
        outs, _ = tops.invoke(op, ts, attrs)
    res = [o.detach().cpu().numpy() for o in outs]
    if heads is None:
        return res, None
    sel = grad_outs if grad_outs is not None else \
        [k for k, o in enumerate(res) if _floating(o)]
    pairs = [(outs[k], torch.from_numpy(np.asarray(h)).to(device))
             for k, h in zip(sel, heads) if outs[k].requires_grad]
    grads = torch.autograd.grad([p[0] for p in pairs], [ts[i] for i in diff],
                                grad_outputs=[p[1] for p in pairs],
                                allow_unused=True) if pairs \
        else [None] * len(diff)
    return res, [np.zeros(arrays[i].shape, np.float32) if gr is None
                 else gr.cpu().numpy() for i, gr in zip(diff, grads)]


def hold(name, arrays, attrs=None, grad=True, tol=TOL, gtol=None,
         heads_seed=7, grad_outs=None, dtype=True):
    """Hold the port's op ``name`` to the JAX package's on ``arrays``:
    outputs (shape, dtype, values at ``tol``) and, with ``grad``, the
    float inputs' gradients at ``gtol`` (``tol`` by default) from
    random head gradients. Returns the port's outputs."""
    attrs = dict(attrs or {})
    arrays = [np.asarray(a) for a in arrays]
    want, vjp = jax_run(name, arrays, attrs, grad, grad_outs)
    heads = None
    if grad:
        sel = grad_outs if grad_outs is not None else \
            [k for k, o in enumerate(want) if _floating(o)]
        rs = np.random.RandomState(heads_seed)
        heads = [np.asarray(rs.randn(*want[k].shape), want[k].dtype)
                 for k in sel]
    got, ggrads = port_run(name, arrays, attrs, heads, grad_outs)
    wgrads = vjp(heads) if grad else None
    assert len(got) == len(want), (name, len(got), len(want))
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if dtype:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    if grad:
        for g, w in zip(ggrads, wgrads):
            np.testing.assert_allclose(g, w, err_msg=name + " grad",
                                       **(gtol or tol))
    return got
