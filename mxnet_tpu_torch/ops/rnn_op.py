"""Fused RNN operator (counterpart of ``mxnet_tpu/ops/rnn_op.py``;
reference: src/operator/rnn.cc + rnn-inl.h:380, cudnn_rnn-inl.h).

Inputs: data ``(T, N, I)``, the flat parameter vector, state
``(L*D, N, H)`` and, for LSTM, ``state_cell``. The parameter layout is
cuDNN's and the JAX package's (every layer's and direction's
``i2h``/``h2h`` weights first, then all the biases), with the gate
orders LSTM i,f,g,o and GRU r,z,n, so Gluon layer weights and symbolic
checkpoints move between the packages. The weights are views into the
flat vector, so its gradient is one tensor.

The computation is the JAX op's ``_run_direction`` per (layer,
direction): one input-projection product for all T steps, then a loop
over time with ``h·W_h2hᵀ`` and the gate arithmetic. The JAX op is a
``lax.scan`` outside any Pallas kernel; here the products go to cuBLAS
through ``torch.matmul`` and the loop unrolls into the caller's CUDA
graph. Dropout (``p``) applies between layers, only in training.
"""
from __future__ import annotations

import torch

from .registry import register

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _rnn_args(attrs):
    names = ["data", "parameters", "state"]
    if attrs.get("mode", "lstm") == "lstm":
        names.append("state_cell")
    return names


def _rnn_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def param_size(mode, num_layers, bidirectional, input_size, state_size):
    """Length of the flat parameter vector."""
    G, H = _NGATES[mode], int(state_size)
    D = 2 if bidirectional else 1
    size = 0
    for layer in range(int(num_layers)):
        in_sz = int(input_size) if layer == 0 else H * D
        size += D * G * H * (in_sz + H + 2)
    return size


def _unpack_params(params, mode, L, D, I, H):
    """Per-(layer, direction) ``(w_i2h, w_h2h)`` and ``(b_i2h, b_h2h)``
    as views of the flat vector."""
    G = _NGATES[mode]
    ws, bs = [], []
    off = 0

    def take(n, *shape):
        nonlocal off
        v = params[off:off + n].view(*shape)
        off += n
        return v
    for layer in range(L):
        in_sz = I if layer == 0 else H * D
        ws.append([(take(G * H * in_sz, G * H, in_sz),
                    take(G * H * H, G * H, H)) for _ in range(D)])
    for _ in range(L):
        bs.append([(take(G * H, G * H), take(G * H, G * H))
                   for _ in range(D)])
    return ws, bs


def _run_direction(mode, x, h, c, w_i2h, w_h2h, b_i2h, b_h2h,
                   reverse=False):
    """One (layer, direction) over time: ``(outputs (T, N, H), h_T,
    c_T)`` (``c_T`` None outside LSTM)."""
    if reverse:
        x = torch.flip(x, (0,))
    # the input projections of ALL steps in one product
    xg = torch.matmul(x, w_i2h.t()) + b_i2h
    w_h = w_h2h.t()
    outs = []
    for t in range(x.shape[0]):
        if mode == "lstm":
            gates = xg[t] + torch.matmul(h, w_h) + b_h2h
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            hg = torch.matmul(h, w_h) + b_h2h
            xr, xz, xn = xg[t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
        else:
            pre = xg[t] + torch.matmul(h, w_h) + b_h2h
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        outs.append(h)
    out = torch.stack(outs, 0)
    if reverse:
        out = torch.flip(out, (0,))
    return out, h, c


def _rnn_draws(attrs, is_train):
    return is_train and float(attrs.get("p", 0.0)) > 0 \
        and int(attrs.get("num_layers", 1)) > 1


def _rnn_forward(attrs, data, parameters, state, state_cell=None, rng=None):
    mode = attrs.get("mode", "lstm")
    H = int(attrs["state_size"])
    L = int(attrs.get("num_layers", 1))
    D = 2 if attrs.get("bidirectional", False) else 1
    p = float(attrs.get("p", 0.0))
    T, N, I = data.shape
    ws, bs = _unpack_params(parameters, mode, L, D, I, H)
    drop = _rnn_draws(attrs, bool(attrs.get("__train__", False)))
    if drop and rng is None and data.device.type != "meta":
        from .. import random as _random
        rng = _random.generator(data.device)

    x = data
    h_states, c_states = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            idx = layer * D + d
            c0 = state_cell[idx] if state_cell is not None else None
            out, hT, cT = _run_direction(mode, x, state[idx], c0,
                                         *ws[layer][d], *bs[layer][d],
                                         reverse=(d == 1))
            outs.append(out)
            h_states.append(hT)
            if mode == "lstm":
                c_states.append(cT)
        x = torch.cat(outs, dim=-1) if D == 2 else outs[0]
        if drop and layer < L - 1 and x.device.type != "meta":
            keep = 1.0 - p
            mask = (torch.rand(x.shape, generator=rng, device=x.device)
                    < keep).to(x.dtype)
            x = x * mask / keep
    outputs = [x]
    if attrs.get("state_outputs", False):
        outputs.append(torch.stack(h_states, 0))
        if mode == "lstm":
            outputs.append(torch.stack(c_states, 0))
    return tuple(outputs)


def _rnn_shapes(attrs, data, parameters, state, state_cell=None):
    H = int(attrs["state_size"])
    D = 2 if attrs.get("bidirectional", False) else 1
    T, N, _ = data.shape
    shapes = [((T, N, D * H), data.dtype)]
    if attrs.get("state_outputs", False):
        n_states = 2 if attrs.get("mode", "lstm") == "lstm" else 1
        shapes += [(tuple(state.shape), state.dtype)] * n_states
    return shapes


register("RNN", _rnn_forward,
         arg_names=("data", "parameters", "state", "state_cell"),
         defaults={"state_size": 0, "num_layers": 1, "bidirectional": False,
                   "mode": "lstm", "p": 0.0, "state_outputs": False,
                   "projection_size": None, "lstm_state_clip_min": None,
                   "lstm_state_clip_max": None, "lstm_state_clip_nan": False,
                   "__train__": False},
         num_outputs=_rnn_outputs, needs_rng=True, draws=_rnn_draws,
         arg_names_fn=_rnn_args, output_shapes=_rnn_shapes)
