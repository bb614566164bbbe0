"""The port's FSDP (``parallel.sharding_rules`` and ``param_shard=True``)
against the JAX package and its own claims (``tests/test_param_shard.
py``'s oracles, :58-:375 and :602-:660):

- the rule table — layout resolution, every heuristic branch, override
  precedence, divisibility (pad-and-slice on the leading dim, an axis
  dropped elsewhere) and the bytes ledger — resolved by both packages on
  meshes of the same axis sizes, in this process (the rules read only a
  mesh's axis names and sizes);
- on two gloo CPU ranks: the DistributedTrainer with FSDP against the
  replicated one bit for bit (three optimizers, overlap on and off), the
  parameter bytes a rank at ``1/N`` (padded) on the real tensors and in
  the memory breakdown, the padded parameter noted by name, a same-mesh
  resume bit for bit, a JAX 8-device FSDP save restored on two ranks
  (re-sharded, one step at rtol 1e-5, atol 1e-6),
  ``make_data_parallel_step`` with FSDP against its replicated run and
  against JAX, the gate's default, and ``make_mesh``;
- on four gloo ranks as ``{dp: 2, tp: 2}`` (the tp probe: Dense(64,
  relu) -> Dense(10) over 32 inputs, Adam): with FSDP each projection
  weight rests as its ``P(dp, tp)`` piece, equal to JAX's piece for
  piece, ``param_bytes_per_device()`` equals JAX's (2984 bytes), the
  trajectory is the ``{dp: 2}`` run's bit for bit and JAX's at the step
  tolerances; without FSDP ``tp`` places nothing."""
import json

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import PartitionSpec as TP

import torch_mesh_ranks as h

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
N = 2


class _AxesOnly:
    """A mesh as the rules see it: axis names and sizes."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(tuple(axes.values()))


def _meshes(axes):
    n = int(np.prod(list(axes.values())))
    return (jpar.create_mesh(axes, devices=jax.devices()[:n]),
            _AxesOnly(axes))


@pytest.fixture(scope="module")
def jax_fsdp_ckpt(tmp_path_factory):
    """An 8-device JAX FSDP trainer's checkpoint after two Adam steps (the
    (10, 32) head weight padded to 16 rows), and its third step."""
    prefix = str(tmp_path_factory.mktemp("jaxfsdp") / "jf")
    _, _, tr = h.jax_dist_run(8, steps=2, param_shard=True, prefix="pshard_")
    tr.save_checkpoint(prefix, 0)
    x, y = h.dist_batches(3)[2]
    loss = float(tr.fit_batch(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
    tr.sync_gluon_params()
    return prefix, loss, [p.data().asnumpy() for _, p in
                          sorted(tr._net.collect_params().items())]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_fsdp_ckpt):
    tmp = tmp_path_factory.mktemp("param_shard")
    return h.spawn(tmp, "param_shard", N,
                   {"tmp": str(tmp), "jax_ckpt": jax_fsdp_ckpt[0],
                    "jax_ckpt_fsdp": True, "prefix": "pshard_",
                    "classes": 9})


def _no_errors(results, prefix):
    errs = h.errors(results, prefix)
    assert not errs, "\n".join(errs)


# ---------------------------------------------------------------------------
# the rule table (one process, both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 4, "tp": 2},
                                  {"fsdp": 8}, {"data": 2, "fsdp": 2,
                                                "tp": 2}, {"sp": 8}])
def test_spec_layout_resolution(axes):
    jm, tm = _meshes(axes)
    jl, tl = jpar.SpecLayout.for_mesh(jm), tpar.SpecLayout.for_mesh(tm)
    assert (tl.data_axis, tl.fsdp_axis, tl.tp_axis) == \
        (jl.data_axis, jl.fsdp_axis, jl.tp_axis)


NAMES = [("tok_embedding_weight", (100, 8)), ("l0_q_proj_weight", (32, 32)),
         ("l0_k_proj_weight", (32, 32)), ("l0_v_proj_weight", (32, 32)),
         ("l0_o_proj_weight", (32, 32)), ("ffn_up_weight", (32, 16)),
         ("dense3_weight", (32, 16)), ("fc1_weight", (32, 16)),
         ("conv0_weight", (32, 16)), ("fc1_bias", (32, 16)),
         ("bn_gamma", (32, 16)), ("bn_beta", (32, 16)),
         ("bn_moving_mean", (32, 16)), ("layernorm_weight", (32, 16)),
         ("loss_scale_alpha", (32, 16)), ("fc1_weight", (32,)),
         ("mysterious_thing", (32, 16))]


@pytest.mark.parametrize("tp", [None, "tp"])
@pytest.mark.parametrize("name,shape", NAMES)
def test_heuristic_every_branch(name, shape, tp):
    jl = jpar.SpecLayout(fsdp_axis="dp", tp_axis=tp)
    tl = tpar.SpecLayout(fsdp_axis="dp", tp_axis=tp)
    assert tuple(tpar.parameter_spec_from_name(name, shape, tl)) == \
        tuple(jpar.parameter_spec_from_name(name, shape, jl))


def test_override_precedence():
    jm, tm = _meshes({"dp": 8})
    over = {"special": (None, "dp"), "spec": ("dp",), "fc9": None}
    jr = jpar.ShardingRules(jm, overrides={
        k: None if v is None else JP(*v) for k, v in over.items()})
    tr = tpar.ShardingRules(tm, overrides={
        k: None if v is None else TP(*v) for k, v in over.items()})
    for name, shape in (("my_special_weight", (32, 32)),
                        ("spectral_weight", (32, 32)),
                        ("fc9_weight", (32, 32)), ("fc1_weight", (32, 32)),
                        ("fc1_bias", (32,))):
        assert tuple(tr.raw_spec(name, shape)) == \
            tuple(jr.raw_spec(name, shape)), name
    assert tr.raw_spec("my_special_weight", (32, 32)) == TP(None, "dp")


@pytest.mark.parametrize("axes,overrides,name,shape", [
    ({"dp": 8}, None, "fc1_weight", (32, 20)),
    ({"dp": 8}, None, "fc2_weight", (10, 32)),
    ({"dp": 8}, {"odd": (None, "dp")}, "odd_weight", (16, 30)),
    ({"dp": 8}, {"w": ("nonexistent",)}, "w0", (16, 4)),
    ({"dp": 2}, None, "fc2_weight", (9, 32)),
    ({"data": 1, "fsdp": 4, "tp": 2}, None, "stage1_fc1_weight", (8, 6)),
    ({"data": 1, "fsdp": 4, "tp": 2}, None, "embed_weight", (10, 6)),
])
def test_plan_divisibility_and_padding(axes, overrides, name, shape):
    jm, tm = _meshes(axes)
    jr = jpar.ShardingRules(jm, overrides=overrides and {
        k: JP(*v) for k, v in overrides.items()})
    tr = tpar.ShardingRules(tm, overrides=overrides and {
        k: TP(*v) for k, v in overrides.items()})
    jp, tp = jr.plan(name, shape), tr.plan(name, shape)
    assert tuple(tp.spec) == tuple(jp.spec)
    assert (tp.sharded, tp.padded, tp.padded_shape) == \
        (jp.sharded, jp.padded, jp.padded_shape)
    assert tp.bytes_per_device("float32", tm) == \
        jp.bytes_per_device("float32", jm)
    v = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(tp.pad(v), np.asarray(jp.pad(v)))
    np.testing.assert_array_equal(tp.logical(tp.pad(v)), v)


def test_rules_bytes_ledger():
    jm, tm = _meshes({"dp": 8})
    shapes = {"fc1_weight": (32, 20), "fc2_weight": (10, 32),
              "fc1_bias": (32,)}
    dtypes = dict.fromkeys(shapes, "float32")
    assert tpar.ShardingRules(tm).bytes_per_device(shapes, dtypes) == \
        jpar.ShardingRules(jm).bytes_per_device(shapes, dtypes)


def test_param_shard_gate_default_off(monkeypatch):
    monkeypatch.delenv("MXNET_PARAM_SHARD", raising=False)
    assert not tpar.param_shard_enabled()
    monkeypatch.setenv("MXNET_PARAM_SHARD", "on")
    assert tpar.param_shard_enabled()
    monkeypatch.setenv("MXNET_PARAM_SHARD", "0")
    assert not tpar.param_shard_enabled()


def test_shard_params_notes_on_one_rank():
    """On a world of 1 nothing shards: every placement is whole."""
    from mxnet_tpu_torch import telemetry
    import torch
    mesh = tpar.local_mesh("dp")
    placed = tpar.shard_params({"fc1_weight": torch.ones(32, 4),
                                "fc1_bias": torch.ones(32)}, mesh,
                               rules=tpar.ShardingRules(mesh))
    assert all(v.is_fully_replicated for v in placed.values())
    telemetry.reset()


def test_shard_params_rules_layer_and_notes(ranks):
    """On two ranks: a divisible weight lands sharded, a (9, 4) one stays
    replicated at its logical shape (noted ``param_shard_fallback``) or,
    with ``pad=True``, is stored padded and sharded (noted
    ``param_shard_padded``); biases stay whole. JAX's 2-device mesh
    places them the same way."""
    _no_errors(ranks, "check_shard_params")
    from mxnet_tpu import telemetry as jtel
    mesh = jpar.create_mesh({"dp": N}, devices=jax.devices()[:N])
    vals = {"fc1_weight": np.ones((32, 4), np.float32),
            "fc2_weight": np.ones((9, 4), np.float32),
            "fc1_bias": np.ones((32,), np.float32)}
    jtel.start()
    try:
        placed = jpar.shard_params(vals, mesh,
                                   rules=jpar.ShardingRules(mesh))
        padded = jpar.shard_params(vals, mesh,
                                   rules=jpar.ShardingRules(mesh), pad=True)
        events = jtel.report()["events"]
    finally:
        jtel.stop()
    for r in ranks:
        assert r["shard/fc1"] == [
            placed["fc1_weight"].is_fully_replicated,
            list(placed["fc1_weight"].addressable_shards[0].data.shape)]
        assert r["shard/fc2"] == [placed["fc2_weight"].is_fully_replicated,
                                  list(placed["fc2_weight"].shape)]
        assert r["shard/bias"] == placed["fc1_bias"].is_fully_replicated
        assert r["shard/padded"] == [
            list(padded["fc2_weight"].shape),
            padded["fc2_weight"].is_fully_replicated]
        assert r["shard/events"] == {
            k: v for k, v in events.items() if k.startswith("param_shard")}
        assert r["shard/legacy"] == [False, True]


# ---------------------------------------------------------------------------
# the DistributedTrainer with FSDP (two ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(3), ids=["sgd", "sgd_mom", "adam"])
def test_fsdp_bitexact(ranks, k):
    _no_errors(ranks, "check_fsdp")
    for r in ranks:
        off, on = "fsdp/%d/0" % k, "fsdp/%d/1" % k
        np.testing.assert_array_equal(r[off + "/losses"], r[on + "/losses"])
        for i in range(4):
            np.testing.assert_array_equal(r["%s/p%d" % (off, i)],
                                          r["%s/p%d" % (on, i)])
        assert r[on + "/flag"] and not r[off + "/flag"]
        plans = r[on + "/plans"]
        assert any(sharded for sharded, _, _ in plans)
        # the (9, 32) head weight pads to (10, 32) in the rules' layout
        assert any(padded for _, padded, _ in plans)
        # at rest each rank holds 1/N of every zero-padded bucket
        assert [local * N for local in r[on + "/local"]] == \
            r[on + "/buckets"]


def test_fsdp_bitexact_without_overlap(ranks):
    for r in ranks:
        a, b = "fsdp_no_overlap/0", "fsdp_no_overlap/1"
        np.testing.assert_array_equal(r[a + "/losses"], r[b + "/losses"])
        for i in range(4):
            np.testing.assert_array_equal(r["%s/p%d" % (a, i)],
                                          r["%s/p%d" % (b, i)])
        assert r[b + "/flags"] == [True, False]


def test_fsdp_param_bytes_one_over_n(ranks):
    """At rest each rank holds half of every bucket: with 0.001 MB
    buckets the roster (32, 20), (32,), (9, 32), (9,) falls into four,
    one a parameter, the (9,) bias padded to 10; nothing else is
    resident (no aux states)."""
    exp_on = (32 * 20 + 32 + 9 * 32 + 10) // N * 4
    exp_off = (32 * 20 + 9 * 32 + 32 + 9) * 4
    for r in ranks:
        assert r["fsdp_bytes/1"] == exp_on
        assert r["fsdp_bytes/0"] == exp_off
        bd = r["fsdp_breakdown/1"]
        assert bd["params_sharded"] == exp_on
        assert bd["params_replicated"] == 0
        assert bd["opt_state"] == r["fsdp_state/1"]


def test_fsdp_padded_param_note(ranks):
    _no_errors(ranks, "check_telemetry")
    events = ranks[0]["tel/events"]
    padded = [k for k in events if k.startswith("param_shard_padded:")]
    assert padded and any("dense1_weight" in k for k in padded)


def test_memory_breakdown_through_diagnose(ranks):
    from mxnet_tpu_torch.tools.diagnose import format_telemetry, \
        read_telemetry
    r = ranks[0]
    assert r["tel/breakdown"]["params_sharded"] > 0
    out = format_telemetry(read_telemetry(r["tel/mem_sink"]))
    assert "params sharded (1/N)" in out and "optimizer state" in out


def test_fsdp_checkpoint_resume_bitexact(ranks):
    _no_errors(ranks, "check_fsdp_checkpoint")
    for r in ranks:
        np.testing.assert_array_equal(r["fsdp_ckpt/resumed"],
                                      r["fsdp_ckpt/ref"][3:])
    with open("%s-0000.ckpt.json" % ranks[0]["fsdp_ckpt/prefix"]) as f:
        manifest = json.load(f)
    entry = manifest["params"]["arg:pshard_dense0_weight"]
    assert len(entry["pieces"]) == N and entry["shape"] == [32, 20]
    assert manifest["params"]["arg:pshard_dense1_weight"]["shape"] == [10, 32]


def test_fsdp_checkpoint_elastic_8_to_2(ranks, jax_fsdp_ckpt):
    """JAX's 8-device FSDP save restored on two ranks: re-sharded for the
    new axis, and its next step is JAX's third."""
    _no_errors(ranks, "check_cross_load")
    _, loss, params = jax_fsdp_ckpt
    for r in ranks:
        np.testing.assert_allclose(r["cross/loss"], [loss], **STEP_TOL)
        for i, p in enumerate(params):
            np.testing.assert_allclose(r["cross/p%d" % i], p, **STEP_TOL)
        # half of each one-parameter bucket a rank: (32, 20), (32,),
        # (10, 32) and (10,)
        assert sorted(r["cross/local_sizes"]) == sorted(
            [32 * 20 // N, 32 // N, 10 * 32 // N, 10 // N])


def test_port_fsdp_checkpoint_loads_in_jax(ranks):
    from mxnet_tpu import checkpoint as jck
    flat = jck.load_arrays(ranks[0]["cross/port_prefix"], 0)
    names = sorted(k for k in flat if k.startswith("arg:"))
    for i, k in enumerate(names):
        np.testing.assert_array_equal(flat[k].asnumpy(),
                                      ranks[0]["cross/port_p%d" % i])


# ---------------------------------------------------------------------------
# make_data_parallel_step with FSDP, make_mesh
# ---------------------------------------------------------------------------

def test_data_parallel_step_fsdp_bitexact(ranks):
    _no_errors(ranks, "check_fsdp_dp_step")
    for r in ranks:
        assert r["fsdp_step/0/loss"] == r["fsdp_step/1/loss"]
        for k in ("fc1_weight", "fc1_bias"):
            np.testing.assert_array_equal(r["fsdp_step/0/" + k],
                                          r["fsdp_step/1/" + k])
        assert r["fsdp_step/1/fc1_weight/local"] == [32 // N, 8]
        assert r["fsdp_step/1/fc1_bias/local"] == [8]


def test_data_parallel_step_fsdp_matches_jax(ranks):
    import jax.numpy as jnp
    mesh = jpar.create_mesh({"dp": N}, devices=jax.devices()[:N])
    host, batch = h.fsdp_step_data()

    def loss_fn(params, b):
        out = b["x"] @ params["fc1_weight"] + params["fc1_bias"]
        return jnp.mean((out - b["y"]) ** 2)

    rules = jpar.ShardingRules(mesh)
    params = jpar.shard_params(dict(host), mesh, rules=rules)
    step, bsh = jpar.make_data_parallel_step(loss_fn, mesh, param_shard=True,
                                             param_rules=rules, donate=False)
    b = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    for _ in range(3):
        loss, params = step(params, b)
    for r in ranks:
        np.testing.assert_allclose(r["fsdp_step/1/loss"], float(loss),
                                   rtol=1e-5)
        for k in ("fc1_weight", "fc1_bias"):
            np.testing.assert_allclose(r["fsdp_step/1/" + k],
                                       np.asarray(params[k]), **STEP_TOL)


def test_make_mesh_fsdp_and_tp(ranks):
    _no_errors(ranks, "check_make_mesh")
    jm = jpar.make_mesh(fsdp=N, devices=jax.devices()[:N])
    jt = jpar.make_mesh(tp=N, devices=jax.devices()[:N])
    host = np.arange(48, dtype=np.float32).reshape(8, 6)
    jplan = jpar.ShardingRules(jm).plan("stage1_fc1_weight", (8, 6))
    tplan = jpar.ShardingRules(jt).plan("stage1_fc1_weight", (8, 6))
    tiles = jax.device_put(host, NamedSharding(jm, jplan.spec))
    ttiles = jax.device_put(host, NamedSharding(jt, tplan.spec))
    for rank, r in enumerate(ranks):
        assert r["make_mesh/axes"] == list(jm.axis_names)
        assert r["make_mesh/shape"] == list(jm.devices.shape)
        lay = jpar.SpecLayout.for_mesh(jm)
        assert r["make_mesh/layout"] == [lay.data_axis, lay.fsdp_axis,
                                         lay.tp_axis]
        assert r["make_mesh/spec"] == list(jplan.spec)
        assert r["make_mesh/bytes"] == jplan.bytes_per_device("float32", jm)
        assert r["make_mesh/padded"] == list(
            jpar.ShardingRules(jm).plan("embed_weight", (9, 6)).padded_shape)
        np.testing.assert_array_equal(
            r["make_mesh/local"],
            np.asarray(tiles.addressable_shards[rank].data))
        np.testing.assert_array_equal(r["make_mesh/full"], host)
        assert r["make_mesh/tp_spec"] == list(tplan.spec)
        np.testing.assert_array_equal(
            r["make_mesh/tp_local"],
            np.asarray(ttiles.addressable_shards[rank].data))
        assert r["make_mesh/batch"] == [4, 5]
        assert "does not divide" in r["make_mesh/bad"]


# ---------------------------------------------------------------------------
# the tp axis: {dp: 2, tp: 2} on four ranks
# ---------------------------------------------------------------------------

TP_AXES = {"dp": 2, "tp": 2}
TP_BYTES = 2984               # (64, 32) / 4 + (10, 64) / 4 + 74 biases


@pytest.fixture(scope="module")
def ranks_tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_trainer")
    return h.spawn(tmp, "tp_trainer", 4, {"tmp": str(tmp)})


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's trainer on the tp probe over {dp: 2, tp: 2}, FSDP on and
    off: losses, weights, bytes and (FSDP) the per-device pieces."""
    out = {}
    mesh = jpar.create_mesh(TP_AXES, devices=jax.devices()[:4])
    for shard in (True, False):
        net = h.tp_net(jmx)
        tr = jpar.DistributedTrainer(
            net, jgluon.loss.SoftmaxCrossEntropyLoss(), mesh,
            optimizer="adam", optimizer_params={"learning_rate": 0.01},
            param_shard=shard)
        losses = [float(tr.fit_batch(jmx.nd.array(x),
                                     jmx.nd.array(y)).asnumpy())
                  for x, y in h.dist_batches(3, width=h.TP_WIDTH)]
        rec = dict(losses=np.array(losses),
                   bytes=tr.param_bytes_per_device(),
                   roster=list(tr._roster),
                   pieces=[{s.device.id: np.asarray(s.data)
                            for s in v.addressable_shards}
                           for v in tr._param_vals])
        tr.sync_gluon_params()
        rec["params"] = [p.data().asnumpy() for _, p in
                         sorted(net.collect_params().items())]
        out[shard] = rec
    return out


def test_tp_param_bytes_match_jax(ranks_tp, jax_tp):
    _no_errors(ranks_tp, "check_tp_trainer")
    assert jax_tp[True]["bytes"] == TP_BYTES
    for r in ranks_tp:
        assert r["tp/1/bytes"] == jax_tp[True]["bytes"]
        assert r["tp/0/bytes"] == jax_tp[False]["bytes"]
        bd = r["tp/1/breakdown"]
        assert bd["params_sharded"] + bd["params_replicated"] == TP_BYTES
        # Adam's two slots rest beside each piece
        assert r["tp/1/state_bytes"] == 2 * TP_BYTES


def test_tp_shards_match_jax_piece_for_piece(ranks_tp, jax_tp):
    want = jax_tp[True]
    for rank, r in enumerate(ranks_tp):
        assert r["tp/1/roster"] == want["roster"]
        assert r["tp/1/specs"][0] == ["dp", "tp"]
        for name, pieces in zip(want["roster"], want["pieces"]):
            got = r["tp/1/local/" + name]
            assert got.shape == pieces[rank].shape, name
            np.testing.assert_allclose(got, pieces[rank], err_msg=name,
                                       **STEP_TOL)


@pytest.mark.parametrize("shard", [1, 0], ids=["fsdp", "replicated"])
def test_tp_trajectory_is_the_dp_runs(ranks, ranks_tp, jax_tp, shard):
    """{dp: 2, tp: 2} trains as {dp: 2} does, bit for bit (the tp ranks
    repeat the dp work), and as JAX's trainer on the same mesh."""
    _no_errors(ranks, "check_tp_reference")
    ref = ranks[0]
    for r in ranks_tp:
        key = "tp/%d" % shard
        np.testing.assert_array_equal(r[key + "/losses"],
                                      ref["tp_ref/losses"])
        for i in range(4):
            np.testing.assert_array_equal(r["%s/p%d" % (key, i)],
                                          ref["tp_ref/p%d" % i])
        want = jax_tp[bool(shard)]
        np.testing.assert_allclose(r[key + "/losses"][0], want["losses"][0],
                                   **STEP_TOL)
        np.testing.assert_allclose(r[key + "/losses"], want["losses"],
                                   rtol=1e-4, atol=1e-6)
        for i, p in enumerate(want["params"]):
            np.testing.assert_allclose(r["%s/p%d" % (key, i)], p,
                                       rtol=1e-4, atol=1e-6)


def test_tp_checkpoint_names_its_queue_item(ranks_tp):
    for r in ranks_tp:
        assert "ROADMAP queue A item 12" in r["tp/1/ckpt"]
