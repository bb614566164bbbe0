"""Port parity: the checkpoint writer (``mxnet_tpu_torch/checkpoint.py``'s
write half, ``CheckpointManager``), ``fit(checkpoint_prefix=,
resume_from_checkpoint=)`` and the optimizer-state files, against
``mxnet_tpu`` on the CPU.

- files cross both ways: a manifest checkpoint (a bfloat16 entry, the
  ``dtype_policy`` meta, a ``.states`` sibling) written by either
  package loads in the other with the same bytes; Module checkpoints
  with optimizer states and Trainer ``save_states`` files load in the
  other package's ``Module.load(load_optimizer_states=True)`` and
  ``Trainer.load_states``;
- ``tests/test_checkpoint.py``'s single-process cases on the port:
  kill mid-save (``ckpt_write``/``ckpt_fsync`` faults) never leaves a
  manifest over a torn file, a torn shard or states file rolls the scan
  back, the bounded queue applies backpressure, a failed async save
  warns and training continues, async and sync fits train bit for bit
  alike, and a resumed fit ends bit-identical to the uninterrupted one;
- the ``checkpoint`` telemetry records and diagnose's Checkpoints table.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch import fault, telemetry
from mxnet_tpu_torch.model import latest_checkpoint_scan, \
    list_checkpoint_epochs


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    monkeypatch.delenv("MXNET_FAULT_PLAN", raising=False)
    monkeypatch.delenv("MXNET_ASYNC_CHECKPOINT", raising=False)
    fault.reset()
    telemetry.reset()
    yield
    fault.reset()
    telemetry.reset()


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _mlp_sym(mx):
    d = mx.sym.Variable("data")
    f1 = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
    a1 = mx.sym.Activation(f1, act_type="relu")
    f2 = mx.sym.FullyConnected(a1, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def _iter(mx):
    rng = np.random.RandomState(5)
    x = rng.normal(0, 1, (64, 32)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    return mx.io.NDArrayIter(x, y, batch_size=32, label_name="softmax_label")


_INIT = {k: np.random.RandomState(i).uniform(-0.2, 0.2, s)
         .astype(np.float32) for i, (k, s) in enumerate(sorted({
             "fc1_weight": (16, 32), "fc1_bias": (16,),
             "fc2_weight": (10, 16), "fc2_bias": (10,)}.items()))}


def _fit(num_epoch, mx=tmx, **fit_kwargs):
    mod = mx.module.Module(_mlp_sym(mx), context=mx.cpu())
    mod.fit(_iter(mx), optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=num_epoch,
            arg_params={k: mx.nd.array(v) for k, v in _INIT.items()},
            aux_params={}, **fit_kwargs)
    return mod


def _params_np(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


# ---------------------------------------------------------------------------
# files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_files_cross_packages(writer, tmp_path):
    """A manifest checkpoint with a bfloat16 entry, an fp32 entry, the
    dtype-policy meta and a states sibling: written by either package,
    validated and loaded by both, bit for bit."""
    prefix = str(tmp_path / "x")
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    m = np.linspace(-1, 1, 5).astype(np.float32)
    mx = jmx if writer == "jax" else tmx
    args = {"w": mx.nd.array(w).astype("bfloat16"), "b": mx.nd.array(m)}
    states = pickle.dumps({"momentum": 1})
    meta = {"dtype_policy": {"compute": "bfloat16", "rules": []}}
    mx.checkpoint.save_arrays(prefix, 3,
                              mx.checkpoint.snapshot_params(args, {}),
                              states_bytes=states, meta=meta)
    for reader in (jmx, tmx):
        reader.checkpoint.validate_manifest(prefix, 3)
        a, _ = reader.checkpoint.restore_params(prefix, 3)
        assert str(a["w"].dtype) == "bfloat16"
        np.testing.assert_array_equal(a["w"].astype("float32").asnumpy(),
                                      w.astype(np.float32).astype(
                                          _bf16_np()).astype(np.float32))
        np.testing.assert_array_equal(a["b"].asnumpy(), m)
        pol = reader.checkpoint.saved_dtype_policy(prefix, 3)
        assert pol.compute == "bfloat16"
    jman = jmx.checkpoint.load_manifest(prefix, 3)
    assert jman["params"]["arg:w"]["dtype"] == "bfloat16"
    assert jman["meta"] == meta
    assert jman["optimizer_states"]["bytes"] == len(states)


def _bf16_np():
    import jax.numpy as jnp
    return jnp.bfloat16


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_module_checkpoint_with_states_crosses(direction, tmp_path):
    """``save_checkpoint(..., save_optimizer_states=True)`` of one
    package, ``Module.load(..., load_optimizer_states=True)`` of the
    other: the same parameters and momentum, and one more step matches
    a step of the writer."""
    src, dst = (tmx, jmx) if direction == "port_to_jax" else (jmx, tmx)
    prefix = str(tmp_path / "m")
    mod = _fit(1, mx=src)
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    loaded = dst.module.Module.load(prefix, 1, load_optimizer_states=True,
                                    context=dst.cpu())
    it = _iter(dst)
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    loaded.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    want = {i: [a.asnumpy() for a in _flat(s)]
            for i, s in mod._updater.states.items()}
    got = {i: [a.asnumpy() for a in _flat(s)]
           for i, s in loaded._updater.states.items()}
    assert sorted(got) == sorted(want)
    for i in want:
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    for k, v in _params_np(mod).items():
        np.testing.assert_array_equal(_params_np(loaded)[k], v)


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    return [state]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_trainer_states_cross(direction, tmp_path):
    """``Trainer.save_states`` (background on the port side) loads in
    the other package's ``Trainer.load_states``, optimizer included,
    with ``param_dict`` reset to the loading Trainer's parameters."""
    src, dst = (tmx, jmx) if direction == "port_to_jax" else (jmx, tmx)
    fname = str(tmp_path / "t.states")
    trainers = []
    for mx in (src, dst):
        net = mx.gluon.nn.Dense(4, in_units=3)
        net.initialize(mx.init.One())
        trainers.append((net, mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9})))
    net, tr = trainers[0]
    with src.autograd.record():
        loss = net(src.nd.ones((2, 3))).sum()
    loss.backward()
    tr.step(2)
    if src is tmx:
        tr.save_states(fname, background=True)
        tmx.checkpoint.flush_async_writes()
    else:
        tr.save_states(fname)
    dnet, dtr = trainers[1]
    dtr.load_states(fname)
    assert dtr._optimizer.momentum == 0.9
    assert dtr._optimizer.param_dict[0] is list(
        dnet.collect_params().values())[0]
    got = [a.asnumpy() for a in _flat(dtr._updaters[0].states[0])]
    want = [a.asnumpy() for a in _flat(tr._updaters[0].states[0])]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_manager_roundtrip_and_manifest(tmp_path):
    prefix = str(tmp_path / "ck")
    args = {"w": tmx.nd.array(np.arange(12, dtype=np.float32)
                              .reshape(3, 4)), "b": tmx.nd.ones((4,))}
    auxs = {"m": tmx.nd.zeros((2,))}
    mgr = ck.CheckpointManager(prefix, async_=False)
    mgr.save(0, args, auxs, states_bytes=b"\x80\x04N.")
    files = sorted(os.listdir(tmp_path))
    assert {"ck-0000.params", "ck-0000.ckpt.json",
            "ck-0000.states"} <= set(files)
    assert not any(f.endswith(".tmp") for f in files)
    man = ck.load_manifest(prefix, 0)
    assert man["epoch"] == 0 and len(man["shards"]) == 1
    la, lx = ck.restore_params(prefix, 0)
    np.testing.assert_array_equal(la["w"].asnumpy(), args["w"].asnumpy())
    np.testing.assert_array_equal(lx["m"].asnumpy(), auxs["m"].asnumpy())
    assert mgr.stats()["saves"] == 1
    assert mgr.stats()["last_good_epoch"] == 0
    # shard 0 is the single-file format both packages' nd.load read
    for mx in (jmx, tmx):
        payload = mx.nd.load(prefix + "-0000.params")
        np.testing.assert_array_equal(payload["arg:w"].asnumpy(),
                                      args["w"].asnumpy())


def test_snapshot_is_a_clone_the_step_cannot_reach():
    """The snapshot is a device-side copy: a later in-place write to the
    live weight (a fused step's replay) does not reach it."""
    w = tmx.nd.ones((3,))
    flat = ck.snapshot_params({"w": w})
    with torch.no_grad():
        w._data.add_(1.0)
    np.testing.assert_array_equal(flat["arg:w"].numpy(), np.ones(3))


def test_kill_mid_save_never_references_torn_shard(tmp_path):
    prefix = str(tmp_path / "kill")
    args = {"w": tmx.nd.ones((4, 4))}
    mgr = ck.CheckpointManager(prefix, async_=False)
    mgr.save(0, args, {})
    fault.set_plan("ckpt_write:step=1:raise")
    mgr.save(1, args, {})
    assert mgr.stats()["failures"] == 1
    assert mgr.stats()["last_good_epoch"] == 0
    assert ck.load_manifest(prefix, 1) is None
    assert not os.path.exists(prefix + "-0001.params")
    assert latest_checkpoint_scan(prefix)[0] == 0
    assert fault.stats()["injected"]["ckpt_write"] == 1


def test_kill_between_states_and_params_never_accepts_epoch(tmp_path):
    prefix = str(tmp_path / "sb")
    states = pickle.dumps({"momentum": 1})
    args = {"w": tmx.nd.ones((2,))}
    mgr = ck.CheckpointManager(prefix, async_=False)
    mgr.save(0, args, {}, states_bytes=states)
    # epoch 1 visits states (1), shard (2), manifest (3)
    fault.set_plan("ckpt_write:step=2:raise")
    mgr.save(1, args, {}, states_bytes=states)
    assert mgr.stats()["failures"] == 1
    assert not os.path.exists(prefix + "-0001.params")
    assert list_checkpoint_epochs(prefix) == [0]
    assert latest_checkpoint_scan(prefix)[0] == 0


def test_fsync_site_is_injectable(tmp_path):
    prefix = str(tmp_path / "fsync")
    fault.set_plan("ckpt_fsync:step=1:raise")
    mgr = ck.CheckpointManager(prefix, async_=False)
    mgr.save(0, {"w": tmx.nd.ones((2,))}, {})
    assert mgr.stats()["failures"] == 1
    assert ck.load_manifest(prefix, 0) is None
    assert fault.stats()["injected"]["ckpt_fsync"] == 1


def test_truncated_shard_fails_checksum_and_scan_falls_back(tmp_path):
    prefix = str(tmp_path / "torn")
    mgr = ck.CheckpointManager(prefix, async_=False)
    mgr.save(0, {"w": tmx.nd.ones((8, 8))}, {})
    mgr.save(1, {"w": tmx.nd.ones((8, 8))}, {})
    with open(prefix + "-0001.params", "r+b") as f:
        f.truncate(32)
    with pytest.raises(tmx.MXNetError, match="torn/corrupt"):
        ck.validate_manifest(prefix, 1)
    found = latest_checkpoint_scan(prefix)
    assert found[0] == 0 and found[3] == 1


def test_corrupt_states_checksum_rejects_manifest_epoch(tmp_path):
    prefix = str(tmp_path / "sib")
    mgr = ck.CheckpointManager(prefix, async_=False)
    states = pickle.dumps({"momentum": 1})
    mgr.save(0, {"w": tmx.nd.ones((2, 2))}, {}, states_bytes=states)
    mgr.save(1, {"w": tmx.nd.ones((2, 2))}, {}, states_bytes=states)
    with open(prefix + "-0001.states", "wb") as f:
        f.write(b"torn")
    found = latest_checkpoint_scan(prefix)
    assert found[0] == 0 and found[3] == 1


def test_backpressure_queue_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CHECKPOINT_INFLIGHT", "1")
    prefix = str(tmp_path / "bp")
    mgr = ck.CheckpointManager(prefix, async_=True)
    assert mgr._q.maxsize == 1
    for e in range(6):
        mgr.save(e, {"w": tmx.nd.ones((64, 64))}, {})
    mgr.close()
    st = mgr.stats()
    assert st["saves"] == 6 and st["failures"] == 0
    assert st["last_good_epoch"] == 5
    assert latest_checkpoint_scan(prefix)[0] == 5


def test_failed_async_save_warns_but_training_continues(tmp_path):
    fault.set_plan("ckpt_write:step=1:raise")
    mod = _fit(2, checkpoint_prefix=str(tmp_path / "ok"))
    assert _params_np(mod)
    assert latest_checkpoint_scan(str(tmp_path / "ok"))[0] == 1


def test_fit_async_vs_sync_bit_identical_trajectory(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_ASYNC_CHECKPOINT", "0")
    ps = _params_np(_fit(3, checkpoint_prefix=str(tmp_path / "s")))
    monkeypatch.setenv("MXNET_ASYNC_CHECKPOINT", "1")
    pa = _params_np(_fit(3, checkpoint_prefix=str(tmp_path / "a")))
    for k in ps:
        np.testing.assert_array_equal(ps[k], pa[k])
    for p in ("s", "a"):
        assert list_checkpoint_epochs(str(tmp_path / p)) == [0, 1, 2]


def test_fit_survives_killed_save_and_resumes_bit_identical(tmp_path):
    """Epoch 1's save is killed; resuming from epoch 0 with its
    optimizer states ends bit-identical to the uninterrupted run."""
    prefix = str(tmp_path / "acc")
    p_ref = _params_np(_fit(4, checkpoint_prefix=str(tmp_path / "ref")))
    # visits per save: states + shard + manifest
    fault.set_plan("ckpt_write:step=4:raise")
    _fit(2, checkpoint_prefix=prefix)
    fault.set_plan(None)
    assert latest_checkpoint_scan(prefix)[0] == 0
    same = _fit(4, checkpoint_prefix=prefix, resume_from_checkpoint=True)
    assert fault.stats()["resumed_from_epoch"] == 0
    for k, v in _params_np(same).items():
        np.testing.assert_array_equal(p_ref[k], v)


def test_checkpoint_records_and_diagnose_round_trip(tmp_path):
    from mxnet_tpu_torch.tools import diagnose
    sink = str(tmp_path / "run.jsonl")
    telemetry.start(filename=sink, meta={"source": "Module.fit"})
    _fit(2, checkpoint_prefix=str(tmp_path / "c"))
    summary = telemetry.stop()
    assert summary["checkpoint"]["saves"] == 2
    assert summary["checkpoint"]["last_good_epoch"] == 1
    tel = diagnose.read_telemetry(sink)
    assert [c["epoch"] for c in tel["checkpoints"]] == [0, 1]
    assert all(c["ok"] and c["bytes"] > 0 for c in tel["checkpoints"])
    text = diagnose.format_telemetry(tel)
    assert "----------Checkpoints----------" in text
    assert "last good    : epoch 1" in text


def test_flush_async_writes_raises_on_failed_write(tmp_path):
    bad = str(tmp_path / "no" / "such" / "dir" / "x.states")
    ck.write_bytes_async(bad, b"abc")
    with pytest.raises(tmx.MXNetError, match="x.states"):
        ck.flush_async_writes()
    ck.flush_async_writes()
    good = str(tmp_path / "ok.states")
    ck.write_bytes_async(good, b"abc")
    ck.flush_async_writes()
    assert os.path.exists(good)
