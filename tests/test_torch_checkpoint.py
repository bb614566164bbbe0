"""Port parity: the read half of ``mxnet_tpu_torch.checkpoint`` and the
decode server's weight swap from a manifest, against what
``mxnet_tpu.checkpoint.save_arrays`` writes, on the CPU.

A manifest with an fp32 entry, a bfloat16 entry (npz keeps it as raw
``|V2`` bytes; the port reinterprets them as ``torch.bfloat16``) and an
entry sharded over four devices of the CPU mesh (re-assembled from its
pieces) loads bit for bit in the port. A torn shard (one byte flipped)
raises naming the file, and ``latest_manifest_epoch`` skips the torn
epoch. ``tests/test_decode.py::test_hot_swap_from_checkpoint_manifest``
runs over a port server: the swapped weights' greedy stream equals the
JAX server's under the same weights.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu import model as jmodel
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import serving as tserving


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _write(prefix, epoch, seed=0):
    """A JAX manifest checkpoint: an fp32 weight, a bf16 weight, an
    int32 aux entry and an fp32 weight sharded over 4 devices. Returns
    the numpy values (bf16 as float32)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 5).astype(np.float32)
    b16 = rng.randn(2, 7).astype(np.float32)
    steps = np.arange(6, dtype=np.int32)
    big = rng.randn(8, 4).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    sharded = jax.device_put(jnp.asarray(big), NamedSharding(mesh, P("dp")))
    flat = jckpt.snapshot_params(
        {"w": w, "b16": jnp.asarray(b16, jnp.bfloat16), "big": sharded},
        {"steps": steps})
    jckpt.save_arrays(prefix, epoch, flat)
    b16_rounded = np.asarray(jnp.asarray(b16, jnp.bfloat16)
                             .astype(jnp.float32))
    return {"w": w, "b16": b16_rounded, "big": big, "steps": steps}


def test_manifest_from_jax_loads_bit_for_bit(tmp_path):
    prefix = str(tmp_path / "ck")
    want = _write(prefix, 3)
    assert len(tckpt.load_manifest(prefix, 3)["shards"]) == 4
    got = tckpt.load_param_arrays(prefix, 3)
    assert set(got) == set(want)
    assert got["b16"].dtype == torch.bfloat16
    assert got["steps"].dtype == torch.int32
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].float().numpy()
                                      if name == "b16" else got[name].numpy(),
                                      value, err_msg=name)
    arrays = tckpt.load_arrays(prefix, 3)
    assert sorted(arrays) == ["arg:b16", "arg:big", "arg:w", "aux:steps"]
    jarrays = jckpt.load_arrays(prefix, 3)
    for key in ("arg:w", "arg:big", "aux:steps"):
        np.testing.assert_array_equal(arrays[key].asnumpy(),
                                      jarrays[key].asnumpy())
    assert tckpt.validate_manifest(prefix, 3)["epoch"] == 3
    assert tckpt.latest_manifest_epoch(prefix) == 3


def _tear(prefix, epoch, shard_file):
    path = os.path.join(os.path.dirname(prefix), shard_file)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    return os.path.basename(path)


def test_torn_shard_raises_naming_the_file(tmp_path):
    prefix = str(tmp_path / "ck")
    _write(prefix, 1)
    torn = _tear(prefix, 1, "ck-0001.shard02-of-04.params")
    for load in (tckpt.load_param_arrays, tckpt.load_arrays,
                 tckpt.validate_manifest, tmodel.load_params):
        with pytest.raises(MXNetError, match=torn.replace(".", r"\.")):
            load(prefix, 1)
    with pytest.raises(JaxMXNetError, match="checksum"):
        jckpt.load_arrays(prefix, 1)            # the reference agrees


def test_latest_manifest_epoch_skips_a_torn_epoch(tmp_path):
    prefix = str(tmp_path / "ck")
    _write(prefix, 1, seed=1)
    _write(prefix, 2, seed=2)
    assert tckpt.latest_manifest_epoch(prefix) == 2
    _tear(prefix, 2, "ck-0002.params")
    assert tckpt.latest_manifest_epoch(prefix) == 1
    assert tckpt.latest_manifest_epoch(prefix) == \
        jckpt.latest_manifest_epoch(prefix)
    assert tckpt.latest_manifest_epoch(prefix, validate=False) == 2
    assert tckpt.latest_manifest_epoch(str(tmp_path / "none")) is None
    with pytest.raises(MXNetError, match="no manifest"):
        tckpt.load_arrays(str(tmp_path / "none"), 0)


def test_model_load_params_reads_manifest_and_single_file(tmp_path):
    """``model.load_params``: a manifest epoch through the checksummed
    reader, a single-file epoch through ``nd.load``; the newest valid
    epoch wins after a torn one."""
    prefix = str(tmp_path / "ck")
    want = _write(prefix, 1)
    args, auxs = tmodel.load_params(prefix, 1)
    np.testing.assert_array_equal(args["big"].asnumpy(), want["big"])
    np.testing.assert_array_equal(auxs["steps"].asnumpy(), want["steps"])
    from mxnet_tpu import ndarray as jnd
    jnd.save(str(tmp_path / "ck-0002.params"),
             {"arg:w": jnd.array(want["w"] * 2)})
    args, _ = tmodel.load_params(prefix, 2)
    np.testing.assert_array_equal(args["w"].asnumpy(), want["w"] * 2)
    assert tmodel.list_checkpoint_epochs(prefix) == [1, 2]
    open(str(tmp_path / "ck-0003.params"), "wb").write(b"torn")
    epoch, args, _ = tmodel.load_latest_valid_checkpoint(prefix)
    assert epoch == 2
    assert jmodel.load_latest_valid_checkpoint(prefix)[0] == 2


def _toy(seed=3):
    kw = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=128)
    jm = jserving.ToyDecoderLM(**kw)
    tm = tserving.ToyDecoderLM(**kw)
    return jm, tm, jm.init_params(seed=seed)


def _drain(srv, *reqs, limit=500):
    n = 0
    while not all(r.done() for r in reqs):
        srv._tick()
        n += 1
        assert n < limit, "scheduler made no progress"


def _stream(srv, prompt, n):
    req = srv.submit(prompt, max_new_tokens=n)
    _drain(srv, req)
    return [int(t) for t in req.result(timeout=1)]


def test_hot_swap_from_checkpoint_manifest(tmp_path):
    """``test_decode.py::test_hot_swap_from_checkpoint_manifest`` over a
    port server: a manifest that the JAX package writes, swapped in by
    ``swap_weights(prefix=, epoch=)``, serves the JAX server's stream
    under the same weights."""
    jm, tm, params_a = _toy(seed=3)
    params_b = jm.init_params(seed=7)
    prefix = str(tmp_path / "lm")
    jckpt.save_arrays(prefix, 0, jckpt.snapshot_params(
        {k: np.asarray(v) for k, v in params_b.items()}))
    prompt = np.arange(1, 6)
    cfg = dict(seq_ladder=[16], max_new_tokens=8, window=2, page_size=8,
               pool_pages=16, start=False)
    jsrv = jserving.DecodeServer(jm, params_a, **cfg)
    tsrv = tserving.DecodeServer(tm, tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in params_a.items()}, "cpu", model=tm),
        device="cpu", **cfg)
    try:
        for srv in (jsrv, tsrv):
            assert srv.swap_weights(prefix=prefix, epoch=0) == 2
        want = _stream(jsrv, prompt, 6)
        assert _stream(tsrv, prompt, 6) == want
        assert tsrv.stats()["swaps"] == 1
    finally:
        jsrv.stop()
        tsrv.stop()


def test_swap_from_torn_manifest_raises_and_keeps_serving(tmp_path):
    jm, tm, params_a = _toy(seed=3)
    prefix = str(tmp_path / "lm")
    jckpt.save_arrays(prefix, 0, jckpt.snapshot_params(
        {k: np.asarray(v) for k, v in jm.init_params(seed=7).items()}))
    torn = _tear(prefix, 0, "lm-0000.params")
    srv = tserving.DecodeServer(tm, tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in params_a.items()}, "cpu", model=tm),
        device="cpu", seq_ladder=[16], max_new_tokens=4, window=1,
        page_size=8, pool_pages=16, start=False)
    try:
        with pytest.raises(MXNetError, match=torn.replace(".", r"\.")):
            srv.swap_weights(prefix=prefix, epoch=0)
        with pytest.raises(MXNetError, match="exactly one"):
            srv.swap_weights({}, prefix=prefix)
        with pytest.raises(MXNetError, match="exactly one"):
            srv.swap_weights()
        assert srv.stats()["weight_version"] == 1
        assert len(_stream(srv, np.arange(1, 4), 3)) == 3
    finally:
        srv.stop()
