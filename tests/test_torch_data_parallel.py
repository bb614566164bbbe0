"""The port's ``DistributedTrainer`` with ZeRO-1 (``grad_sync``'s bucketed
reduce-scatter and sharded optimizer state) on two gloo CPU ranks,
against the JAX package (``tests/test_grad_sync.py``'s oracles, :55-:284
and :453-:635) and its own claims:

- the bucket plan and the gates, in this process;
- overlap on (size-capped buckets, state ``1/N`` a rank) against overlap
  off (one bucket, replicated state): bit for bit, five optimizers, five
  steps; ZeRO-1's ``1/N`` on the real state tensors; parameters placed
  once;
- one Adam step against the JAX package's trainer on a 2-device mesh at
  rtol 1e-5, atol 1e-6 (ROADMAP rule 5) and five steps at rtol 1e-4;
- sharded-state checkpoints: the resumed trajectory equals the
  uninterrupted one bit for bit, a changed bucket partition is refused
  with the trainer untouched, a JAX 8-device save loads on the two ranks
  and the ranks' save loads in the JAX package (one step after either
  at the one-step tolerance);
- ``ShardedOptState``'s seed/export inverse, the in-program accounting
  bytes and the diagnose Gradient sync and memory tables of a rank's
  sink, rendered by both packages' diagnose;
- a conv net with ``BatchNorm`` and ``SyncBatchNorm`` over dp = 2: its
  moving statistics equal the JAX mesh program's global-batch ones;
- sequence parallelism on four ranks as ``{dp: 2, sp: 2}``: the
  trainer on an attention net and on one whose position ids come from
  ``arange_like`` (three SGD steps, each rank its rows and its half of
  the sequence) against JAX's trainer on a mesh of the same sizes, with
  FSDP and ZeRO-1 over dp bit for bit the same run, and
  ``make_data_parallel_step`` on per-token data against JAX's step."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import grad_sync as jgs
from mxnet_tpu_torch.parallel import grad_sync as tgs

import torch_mesh_ranks as h

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
N = 2


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """An 8-device JAX trainer's checkpoint after two Adam steps, and its
    third step."""
    prefix = str(tmp_path_factory.mktemp("jaxck") / "jck")
    _, _, tr = h.jax_dist_run(8, steps=2)
    tr.save_checkpoint(prefix, 0)
    batches = h.dist_batches(3)
    x, y = batches[2]
    loss = float(tr.fit_batch(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
    tr.sync_gluon_params()
    params = [p.data().asnumpy() for _, p in
              sorted(tr._net.collect_params().items())]
    return prefix, loss, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_ckpt):
    tmp = tmp_path_factory.mktemp("data_parallel")
    return h.spawn(tmp, "data_parallel", N,
                   {"tmp": str(tmp), "jax_ckpt": jax_ckpt[0]})


def _no_errors(results, prefix):
    errs = h.errors(results, prefix)
    assert not errs, "\n".join(errs)


# ---------------------------------------------------------------------------
# the plan and the gates (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,axis", [(4 * 150, 8), (600, 2), (4 * 40, 3)])
def test_plan_backward_order_and_cap_match_jax(cap, axis):
    shapes = [(100,), (50,), (200,), (10,)]
    tp = tgs.GradSyncPlan(shapes, ["float32"] * 4, axis_size=axis,
                          cap_bytes=cap)
    jp = jgs.GradSyncPlan(shapes, ["float32"] * 4, axis_size=axis,
                          cap_bytes=cap)
    assert tp.signature() == jp.signature()
    assert tp.layout_key() == jp.layout_key()
    for b in tp.buckets:
        assert b.padded_size % axis == 0 and b.padded_size - b.total < axis


def test_plan_dtype_split_and_monolith():
    shapes = [(16,), (16,), (16,)]
    dts = ["float32", "float16", "float16"]
    tp = tgs.GradSyncPlan(shapes, dts, axis_size=4,
                          cap_bytes=tgs.MONOLITH_CAP)
    jp = jgs.GradSyncPlan(shapes, dts, axis_size=4,
                          cap_bytes=jgs.MONOLITH_CAP)
    assert [b.dtype for b in tp.buckets] == ["float16", "float32"]
    assert tp.signature() == jp.signature()
    assert tp.describe() == jp.describe()


def test_bucket_cap_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAD_BUCKET_MB", "2.5")
    assert tgs.bucket_cap_bytes() == int(2.5 * (1 << 20))
    monkeypatch.setenv("MXNET_GRAD_OVERLAP", "on")
    assert tgs.overlap_enabled()
    monkeypatch.setenv("MXNET_GRAD_OVERLAP", "0")
    assert not tgs.overlap_enabled()


# ---------------------------------------------------------------------------
# trajectory identity and ZeRO-1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(len(h.OPTIMIZERS)),
                         ids=[o + ("_mom" if "momentum" in p else "")
                              for o, p in h.OPTIMIZERS])
def test_distributed_trainer_bitexact(ranks, k):
    """Overlap on is overlap off, bit for bit, over five steps."""
    _no_errors(ranks, "check_bitexact")
    for r in ranks:
        off, on = "bitexact/%d/0" % k, "bitexact/%d/1" % k
        np.testing.assert_array_equal(r[off + "/losses"], r[on + "/losses"])
        for i in range(4):
            np.testing.assert_array_equal(r["%s/p%d" % (off, i)],
                                          r["%s/p%d" % (on, i)])
        assert r[on + "/buckets"] > 1 and r[off + "/buckets"] == 1
        assert r[on + "/overlap"] and not r[off + "/overlap"]
    for i in range(4):
        np.testing.assert_array_equal(ranks[0]["bitexact/%d/1/p%d" % (k, i)],
                                      ranks[1]["bitexact/%d/1/p%d" % (k, i)])


def test_one_step_and_trajectory_match_jax(ranks):
    """Adam, overlap on: one step at the one-step tolerance, five at the
    trajectory's, against the JAX trainer on a 2-device mesh."""
    _no_errors(ranks, "check_zero1")
    losses, params, _ = h.jax_dist_run(N, steps=5)
    one_loss, one_params, _ = h.jax_dist_run(N, steps=1)
    for r in ranks:
        np.testing.assert_allclose(r["zero1/1/loss"], one_loss, **STEP_TOL)
        for i, p in enumerate(one_params):
            np.testing.assert_allclose(r["zero1/1/p%d" % i], p, **STEP_TOL)
        np.testing.assert_allclose(r["bitexact/2/1/losses"], losses,
                                   **TRAJ_TOL)
        for i, p in enumerate(params):
            np.testing.assert_allclose(r["bitexact/2/1/p%d" % i], p,
                                       **TRAJ_TOL)


@pytest.mark.parametrize("overlap,shard", [(False, False), (True, True)])
def test_world_of_one_trains_like_one_jax_device(overlap, shard,
                                                 monkeypatch):
    """Without a process group the mesh has one rank and every axis size
    1: the trainer runs the single-device path, held to the JAX trainer
    on one device for five Adam steps."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import gluon as tgluon
    from mxnet_tpu_torch import parallel as tpar
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    losses, params, _ = h.jax_dist_run(1, overlap=overlap, param_shard=shard)
    net = h.dist_net(tmx)
    tr = tpar.DistributedTrainer(
        net, tgluon.loss.SoftmaxCrossEntropyLoss(), tpar.local_mesh("dp"),
        optimizer="adam", optimizer_params={"learning_rate": 0.01},
        grad_overlap=overlap, bucket_mb=0.001, param_shard=shard)
    got = [float(tr.fit_batch(tmx.nd.array(x), tmx.nd.array(y)).asnumpy())
           for x, y in h.dist_batches(5)]
    tr.sync_gluon_params()
    np.testing.assert_allclose(got[0], losses[0], **STEP_TOL)
    np.testing.assert_allclose(got, losses, **TRAJ_TOL)
    for (_, p), want in zip(sorted(net.collect_params().items()), params):
        np.testing.assert_allclose(p.data().asnumpy(), want, **TRAJ_TOL)
    assert tr.overlap is overlap and tr.param_shard is shard


def test_zero1_state_memory_is_one_over_n(ranks):
    for r in ranks:
        off, on = r["zero1/0/bytes"], r["zero1/1/bytes"]
        assert off > 0 and on * N == off
        for local, padded in zip(r["zero1/1/local_sizes"],
                                 r["zero1/1/padded_sizes"]):
            assert local * N == padded
        assert r["zero1/0/local_sizes"] == r["zero1/0/padded_sizes"]


def test_distributed_trainer_params_placed_once(ranks):
    _no_errors(ranks, "check_placed_once")
    for r in ranks:
        assert r["placed/dispatch"] == 2
        assert r["placed/dirty"] is False
        assert r["placed/tensors"] is True


def test_distributed_trainer_rejects_unknown_optimizer(ranks):
    for r in ranks:
        assert r["unknown_opt"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_sharded_state(ranks):
    _no_errors(ranks, "check_checkpoint")
    for r in ranks:
        np.testing.assert_array_equal(r["ckpt/resumed"], r["ckpt/ref"][3:])
    with open("%s-0000.ckpt.json" % ranks[0]["ckpt/prefix"]) as f:
        manifest = json.load(f)
    opt_keys = [k for k in manifest["params"] if k.startswith("opt:bucket")]
    assert opt_keys and all(".slot" in k for k in opt_keys)
    assert all(len(manifest["params"][k]["pieces"]) == N for k in opt_keys)
    assert len(manifest["shards"]) == N and manifest["processes"] == N


def test_checkpoint_restore_rejects_changed_bucket_layout(ranks):
    for r in ranks:
        assert "bucket partition" in r["ckpt/reject"]
        assert r["ckpt/untouched"] is True
        assert r["ckpt/buckets"][0] != r["ckpt/buckets"][1]


def test_jax_8_device_checkpoint_loads_on_two_ranks(ranks, jax_ckpt):
    """The JAX save (8 pieces a state vector, padded for 8) re-padded for
    two ranks: the next step agrees with JAX's own third step."""
    _no_errors(ranks, "check_cross_load")
    _, loss, params = jax_ckpt
    for r in ranks:
        np.testing.assert_allclose(r["cross/loss"], [loss], **STEP_TOL)
        for i, p in enumerate(params):
            np.testing.assert_allclose(r["cross/p%d" % i], p, **STEP_TOL)


def test_port_checkpoint_loads_in_jax(ranks):
    """The ranks' save read by the JAX package: its parameters bit for
    bit, and a JAX 2-device trainer restored from it takes the ranks'
    next step."""
    from mxnet_tpu import checkpoint as jck
    prefix = ranks[0]["cross/port_prefix"]
    flat = jck.load_arrays(prefix, 0)
    names = sorted(k for k in flat if k.startswith("arg:"))
    for i, k in enumerate(names):
        np.testing.assert_array_equal(flat[k].asnumpy(),
                                      ranks[0]["cross/port_p%d" % i])
    losses, params, _ = h.jax_dist_run(N, steps=1, load=(prefix, 0), skip=2)
    np.testing.assert_allclose(losses, ranks[0]["cross/port_next_loss"],
                               **STEP_TOL)
    for i, p in enumerate(params):
        np.testing.assert_allclose(p, ranks[0]["cross/port_next_p%d" % i],
                                   **STEP_TOL)


def test_sharded_state_seed_export_inverse(ranks):
    _no_errors(ranks, "check_seed_export")
    for r in ranks:
        assert r["seed/inverse"] and r["seed/reload"]
        assert sorted(r["seed/keys"]) == sorted(
            ["opt:bucket%02d.slot%d" % (b, k)
             for b in range(r["seed/buckets"]) for k in range(2)]
            + ["opt:layout"])


# ---------------------------------------------------------------------------
# telemetry: accounting, the Sync table, the memory table
# ---------------------------------------------------------------------------

def test_in_program_accounting_bytes(ranks):
    _no_errors(ranks, "check_telemetry")
    r = ranks[0]
    assert r["tel/bucket_row"]["bytes"] == r["tel/bucket_bytes"]
    assert r["tel/bucket_row"]["time_ms"] == 0.0
    assert r["tel/steps"] == 1


@pytest.mark.parametrize("package", ["port", "jax"])
def test_diagnose_sync_table(ranks, package):
    if package == "port":
        from mxnet_tpu_torch.tools import diagnose
    else:
        from mxnet_tpu.tools import diagnose
    sink = ranks[0]["tel/sync_sink"]
    text = diagnose.format_telemetry(diagnose.read_telemetry(sink))
    assert "Gradient sync" in text
    assert "bucket00" in text and "bucket01" in text
    assert "sync share" in text
    assert "in-program   : 1 step(s)" in text
    assert diagnose.main([sink]) in (None, 0)


def test_diagnose_sync_table_same_in_both_packages(ranks):
    from mxnet_tpu.tools import diagnose as jd
    from mxnet_tpu_torch.tools import diagnose as td
    sink = ranks[0]["tel/sync_sink"]

    def table(mod):
        text = mod.format_telemetry(mod.read_telemetry(sink))
        start = text.index("----------Gradient sync")
        return text[start:text.index("sync share", start)]
    assert table(td) == table(jd)


def test_memory_breakdown_through_diagnose(ranks):
    from mxnet_tpu_torch.tools.diagnose import format_telemetry, \
        read_telemetry
    r = ranks[0]
    bd = r["tel/breakdown"]
    assert bd and bd["params_sharded"] > 0
    assert bd["opt_state"] == r["tel/state_bytes"]
    out = format_telemetry(read_telemetry(r["tel/mem_sink"]))
    assert "params sharded (1/N)" in out
    assert "optimizer state" in out
    assert "grad_sync:bucket00" in r["tel/comms"]


# ---------------------------------------------------------------------------
# BatchNorm and SyncBatchNorm over dp = 2
# ---------------------------------------------------------------------------

def _jax_bn_run():
    from mxnet_tpu.gluon import nn
    mesh = jpar.create_mesh({"dp": N}, devices=jax.devices()[:N])
    net = nn.HybridSequential(prefix="bnnet_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(4, 3, padding=1),
                jgluon.contrib.nn.SyncBatchNorm(), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(4))
    net.initialize()
    batches = h.bn_batches()
    net(jmx.nd.array(batches[0][0][:2]))
    plist = sorted(net.collect_params().items())
    for (name, p), v in zip(plist, h.bn_init([p.data().shape
                                              for _, p in plist])):
        if "running_var" in name:
            v = np.abs(v) + 1.0
        p.set_data(jmx.nd.array(v))
    tr = jpar.DistributedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                 mesh, optimizer="sgd",
                                 optimizer_params={"learning_rate": 0.1},
                                 grad_overlap=True)
    losses = [float(tr.fit_batch(jmx.nd.array(x), jmx.nd.array(y))
                    .asnumpy()) for x, y in batches]
    tr.sync_gluon_params()
    return np.array(losses), {n: p.data().asnumpy() for n, p in
                              sorted(net.collect_params().items())}


@pytest.fixture(scope="module")
def jax_bn():
    return _jax_bn_run()


@pytest.mark.parametrize("layer", ["batchnorm0", "syncbatchnorm0"])
@pytest.mark.parametrize("stat", ["running_mean", "running_var"])
def test_batchnorm_moving_stats_are_the_global_batchs(ranks, jax_bn, layer,
                                                      stat):
    _no_errors(ranks, "check_batchnorm")
    _, want = jax_bn
    key = "bnnet_%s_%s" % (layer, stat)
    for r in ranks:
        np.testing.assert_allclose(r["bn/" + key], want[key], **STEP_TOL)
    np.testing.assert_array_equal(ranks[0]["bn/" + key],
                                  ranks[1]["bn/" + key])


def test_batchnorm_net_trains_like_jax(ranks, jax_bn):
    losses, want = jax_bn
    for r in ranks:
        np.testing.assert_allclose(r["bn/losses"], losses, **TRAJ_TOL)
        for key, w in want.items():
            np.testing.assert_allclose(r["bn/" + key], w, err_msg=key,
                                       **TRAJ_TOL)


# ---------------------------------------------------------------------------
# sequence parallelism: {dp: 2, sp: 2} on four ranks
# ---------------------------------------------------------------------------

SP_AXES = {"dp": 2, "sp": 2}


@pytest.fixture(scope="module")
def ranks_sp(tmp_path_factory):
    return h.spawn(tmp_path_factory.mktemp("sp_trainer"), "sp_trainer", 4)


def _jax_sp_run(kind):
    from mxnet_tpu.parallel.mesh import use_mesh
    mesh = jpar.create_mesh(SP_AXES, devices=jax.devices()[:4])
    net = h.sp_net(jmx, kind)
    tr = jpar.DistributedTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), mesh, optimizer="sgd",
        optimizer_params={"learning_rate": h.SP_LR})
    with use_mesh(mesh):
        losses = [float(tr.fit_batch(jmx.nd.array(x),
                                     jmx.nd.array(y)).asnumpy())
                  for x, y in h.sp_batches(kind)]
    tr.sync_gluon_params()
    return np.array(losses), [p.data().asnumpy() for _, p in
                              sorted(net.collect_params().items())]


@pytest.mark.parametrize("kind", ["probe", "positioned"])
def test_sp_trainer_matches_jax(ranks_sp, kind):
    _no_errors(ranks_sp, "check_sp_trainer")
    losses, params = _jax_sp_run(kind)
    key = "sp/" + kind
    for r in ranks_sp:
        np.testing.assert_allclose(r[key + "/losses"][0], losses[0],
                                   **STEP_TOL)
        np.testing.assert_allclose(r[key + "/losses"], losses, **TRAJ_TOL)
        for i, p in enumerate(params):
            np.testing.assert_allclose(r["%s/p%d" % (key, i)], p,
                                       **TRAJ_TOL)
        np.testing.assert_array_equal(r[key + "/losses"],
                                      ranks_sp[0][key + "/losses"])


def test_sp_trainer_fsdp_zero1_bitexact(ranks_sp):
    for r in ranks_sp:
        np.testing.assert_array_equal(r["sp/fsdp/losses"],
                                      r["sp/probe/losses"])


def test_sp_trainer_needs_per_token_labels(ranks_sp):
    for r in ranks_sp:
        assert "has no sequence dim to split over the mesh's 'sp' axis" \
            in r["sp/no_seq"]


def _jax_sp_step():
    mesh = jpar.create_mesh(SP_AXES, devices=jax.devices()[:4])

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    step, bsh = jpar.make_data_parallel_step(
        loss_fn, mesh, optimizer_update=lambda p, g: p - 0.1 * g,
        donate=False)
    params = {"w": jnp.zeros((4, 1)), "b": jnp.zeros((1,))}
    losses = []
    for x, y in h.sp_step_data():
        loss, params = step(params, {"x": jax.device_put(x, bsh),
                                     "y": jax.device_put(y, bsh)})
        losses.append(float(loss))
    return np.array(losses), params


def test_sp_data_parallel_step_matches_jax(ranks_sp):
    _no_errors(ranks_sp, "check_sp_dp_step")
    losses, params = _jax_sp_step()
    for r in ranks_sp:
        np.testing.assert_allclose(r["sp_step/0/losses"][0], losses[0],
                                   **STEP_TOL)
        np.testing.assert_allclose(r["sp_step/0/losses"], losses,
                                   **TRAJ_TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["sp_step/0/" + k],
                                       np.asarray(params[k]), **TRAJ_TOL)
            np.testing.assert_array_equal(r["sp_step/0/" + k],
                                          r["sp_step/1/" + k])
        assert r["sp_step/spec"] == ["dp", "sp"]
