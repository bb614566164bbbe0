"""``chip_smoke.py`` phase 21 (b)'s model at toy size on the CPU:
ToyDecoderLM's decoder written in ``mx.sym`` with the operator breadth
(``chip_smoke.sym_lm``: ``batch_dot``, ``_contrib_div_sqrt_dim``, a
causal mask from ``_arange``, ``broadcast_lesser_equal`` and
``broadcast_like``, ``softmax_cross_entropy`` under ``MakeLoss``,
``topk`` under ``BlockGrad``) at 2 layers and width 64, on
``ToyDecoderLM.init_params(seed=0)`` weights. Its logits are held to
``ToyDecoderLM.prefill`` (the plain attention route) and to the same
symbol built and run by the JAX package; its greedy tokens to the
model's argmax; one SGD step through ``Module`` (the fused step under a
stand-in capture, and eager) to the JAX package's Module step from the
same weights and batch, at ``rtol=1e-5`` on the loss and rule 5's
tolerances on the weights. (SGD, not phase 21's Adam: Adam's first step
is lr·g/(|g| + eps), which moves by up to lr where |g| is near eps, so
it would hide the gradients' agreement.)"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving import ToyDecoderLM

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab=97, n_layers=2, n_heads=2, head_dim=32, d_ff=128,
           max_len=16)
TOL = dict(rtol=1e-5, atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _weights():
    model = ToyDecoderLM(impl="plain", **CFG)
    params = model.init_params(seed=0, device="cpu")
    return model, params, CS.sym_lm_args(params, CFG["n_layers"])


def _tokens(seed, batch, seq):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], (batch, seq)).astype(np.float32)


def _predict(mx, args, tokens):
    T = tokens.shape[1]
    sym = CS.sym_lm(mx, CFG["vocab"], CFG["n_layers"], CFG["n_heads"],
                    CFG["head_dim"], CFG["d_ff"], T, train=False)
    feed = {k: mx.nd.array(v) for k, v in args.items()}
    feed["data"] = mx.nd.array(tokens)
    ex = sym.bind(mx.cpu(), feed, grad_req="null")
    return [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("T", [16, 7])
def test_symbolic_lm_logits_match_toydecoder_and_jax(T):
    model, params, args = _weights()
    tokens = _tokens(1, 2, T)
    logits, top = _predict(tmx, args, tokens)
    with torch.no_grad():
        want = model.prefill(params, torch.from_numpy(tokens).long())[0]
    np.testing.assert_allclose(logits, want.numpy(), **TOL)
    jlogits, jtop = _predict(jmx, args, tokens)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_array_equal(top[..., 0], np.argmax(want.numpy(), -1))
    np.testing.assert_array_equal(top, jtop)


def test_symbolic_lm_greedy_stream_in_a_fixed_window():
    """Phase 21 (b)'s greedy check: the symbol's topk at the prompt's end
    in a fixed window (later positions cannot reach back through the
    causal mask) against ToyDecoderLM's prefill + decode stream."""
    model, params, args = _weights()
    T, prompt = 16, 10
    window = np.zeros((1, T), np.float32)
    window[0, :prompt] = _tokens(2, 1, prompt)[0]
    got = []
    for i in range(T - prompt):
        _, top = _predict(tmx, args, window)
        nxt = int(top[0, prompt + i - 1, 0])
        got.append(nxt)
        window[0, prompt + i] = nxt
    toks = torch.from_numpy(window[:, :prompt]).long()
    want = []
    with torch.no_grad():
        logits, kk, vv = model.prefill(params, toks)
        L, H, Dh = model.n_layers, model.n_heads, model.head_dim
        kc = torch.zeros(L, 1, T, H, Dh)
        vc = torch.zeros_like(kc)
        kc[:, :, :prompt], vc[:, :, :prompt] = kk, vv
        last = logits[0, -1]
        for i in range(T - prompt):
            tok = int(torch.argmax(last))
            want.append(tok)
            out, nk, nv = model.decode(params, torch.tensor([tok]),
                                       torch.tensor([prompt + i]), kc, vc)
            kc[:, :, prompt + i], vc[:, :, prompt + i] = nk, nv
            last = out[0]
    assert got == want


def _module_step(mx, args, x, y):
    """One Module SGD step; returns (loss a token, {name: weights}, the
    module)."""
    B, T = x.shape
    sym = CS.sym_lm(mx, CFG["vocab"], CFG["n_layers"], CFG["n_heads"],
                    CFG["head_dim"], CFG["d_ff"], T, batch=B)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("label", y.shape)])
    mod.set_params({k: mx.nd.array(v) for k, v in args.items()}, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=0.5, rescale_grad=1.0))
    batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])
    mod.forward_backward(batch)
    mod.update()
    loss = float(mod.get_outputs()[0].asnumpy()) / (B * T)
    arg, _ = mod.get_params()
    return loss, {k: v.asnumpy() for k, v in arg.items()}, mod


@pytest.mark.parametrize("fused", [True, False])
def test_symbolic_lm_module_step_matches_jax(fused, monkeypatch):
    from mxnet_tpu_torch import cached_op, fused_step

    def standin(body, device, pool):  # the body re-runs at each replay
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    fused_step.set_graph_factory(
        lambda: cached_op._Graphs("cpu", capture=standin))
    try:
        _, _, args = _weights()
        x = _tokens(3, 2, 16)
        y = _tokens(4, 2, 16)
        loss, got, mod = _module_step(tmx, args, x, y)
        stats = mod._fused.stats() if mod._fused else None
    finally:
        fused_step.set_graph_factory(None)
    jloss, want, _ = _module_step(jmx, args, x, y)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if fused:
        assert stats is not None and stats["captures"] == 1
