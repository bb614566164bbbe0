"""The port's default device: ``context.resolve_device(None)`` follows
``current_context()``, so the serving entry points (``ToyDecoderLM.
init_params``, ``DecodeServer`` and its ``KVCachePool``,
``serving.convert``) run on the CPU under ``MXNET_DEFAULT_CONTEXT=cpu``
or a ``with mx.cpu():`` scope, as the JAX server does; with neither and
no CUDA device they raise."""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.context import resolve_device

PROMPT = [3, 1, 4, 1, 5]
MODEL = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=256)


def _stream(srv, n=6):
    req = srv.submit(PROMPT, max_new_tokens=n)
    for _ in range(200):
        if req.done():
            break
        srv._tick()
    return [int(t) for t in req.result(timeout=1)]


def _serve(device=None):
    """A server from seed-0 weights, ``device`` None throughout."""
    model = tserving.ToyDecoderLM(**MODEL)
    params = model.init_params(seed=0, device=device)
    srv = tserving.DecodeServer(model, params, device=device, start=False)
    return srv, params


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return monkeypatch


@pytest.mark.parametrize("request_kind", ["env", "scope"])
def test_server_follows_a_cpu_request(no_cuda, request_kind):
    """Under either request the server, its pool and the weights land on
    the CPU and serve; the greedy stream equals a server built with
    ``device="cpu"``."""
    if request_kind == "env":
        no_cuda.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
        scope = contextlib.nullcontext()
    else:
        scope = tmx.cpu()
    with scope:
        assert resolve_device(None) == torch.device("cpu")
        srv, params = _serve()
        assert srv._device == torch.device("cpu")
        assert srv._pool.device == torch.device("cpu")
        assert all(v.device.type == "cpu" for v in params.values())
        converted = tserving.params_from_numpy(
            {k: v.numpy() for k, v in params.items()}, None,
            model=tserving.ToyDecoderLM(**MODEL))
        assert all(v.device.type == "cpu" for v in converted.values())
        got = _stream(srv)
    want = _stream(_serve("cpu")[0])
    assert got == want and len(got) == 6


def test_no_request_without_cuda_raises(no_cuda):
    with pytest.raises(MXNetError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tserving.ToyDecoderLM(**MODEL).init_params(seed=0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_explicit_device_wins_over_the_context(no_cuda):
    no_cuda.setenv("MXNET_DEFAULT_CONTEXT", "gpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with tmx.cpu():
        assert resolve_device(None) == torch.device("cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        resolve_device(None)
    np.testing.assert_array_equal(
        tmx.nd.zeros((2,), ctx=tmx.cpu()).asnumpy(), np.zeros(2))
