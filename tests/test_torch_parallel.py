"""The port's rank mesh, collectives, sequence parallelism and
``make_data_parallel_step`` against the JAX package on the CPU
(``tests/test_parallel.py``'s oracles).

Two gloo ranks (and four, for a ``{"dp": 2, "sp": 2}`` mesh) run
``torch_mesh_ranks``' suites once per module; each result is held to the
JAX package's mesh of the same sizes on the 8 CPU devices, on the same
numpy inputs:

- the collectives exactly (integer-valued or exactly representable
  data: a sum's order cannot show);
- ring and Ulysses attention, causal and not: the output against JAX's
  mesh form and the q/k/v gradients of one cotangent against ``jax.vjp``
  of JAX's local attention, at rtol = atol = 2e-5; the output against
  JAX's local attention at the JAX test's 1e-4;
- ``make_data_parallel_step``'s first step at rtol 1e-5, atol 1e-6
  (ROADMAP rule 5), its 50-step trajectory at rtol 1e-4 (two sums of 16
  rows against one of 32, compounded), and its bucketed exchange bit for
  bit against its one-bucket exchange.

A world of 1 runs the single-device path; the multi-host heartbeat's
``HostLostError`` raises ``NotImplementedError`` naming its queue item.
On the ``{"dp": 2, "sp": 2}`` mesh both data-parallel paths train, each
rank on its rows and its half of the sequence, as one process does on
the whole batch."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tpar

import torch_mesh_ranks as h

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
N = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return h.spawn(tmp_path_factory.mktemp("parallel"), "parallel", N)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return h.spawn(tmp_path_factory.mktemp("parallel4"), "parallel4", 4)


def _no_errors(results, prefix):
    errs = h.errors(results, prefix)
    assert not errs, "\n".join(errs)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.create_mesh(axes, devices=jax.devices()[:n])


def _cat(results, key, axis=0):
    return np.concatenate([r[key] for r in results], axis=axis)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_axes_match_jax(ranks):
    _no_errors(ranks, "check_mesh")
    jm = _jmesh({"dp": N})
    for r in ranks:
        assert r["mesh/axes"] == jpar.mesh_axes(jm)
        assert r["mesh/local"] == {"dp": N}
        assert r["mesh/auto"] == N
        jmm = jpar.make_mesh(devices=jax.devices()[:N])
        assert r["mesh/make"] == [list(jmm.axis_names),
                                  list(jmm.devices.shape)]


def test_mesh_size_must_be_the_world(ranks):
    for r in ranks:
        msg = r["mesh/oversize"]
        assert "python -m mxnet_tpu_torch.tools.launch -n %d" % (N + 1) \
            in msg


def test_current_mesh_and_links(ranks):
    for r in ranks:
        assert r["mesh/current"] and r["mesh/after"]
        # every hop between ranks crosses a process: all of it is dcn
        assert r["mesh/link"] == [0, 1000]


def test_world_of_one_runs_the_single_device_path():
    mesh = tpar.create_mesh({"dp": 1, "sp": 1})
    assert tpar.mesh_axes(mesh) == {"dp": 1, "sp": 1}
    x = torch.arange(6, dtype=torch.float32)
    assert tpar.all_reduce(x, mesh, "dp") is x
    np.testing.assert_array_equal(tpar.reduce_scatter(x, mesh, "dp"), x)
    q, k, v, _ = h.attn_inputs((1, 8, 2, 4), 4)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_array_equal(
        tpar.ring_attention(*ts, mesh=mesh, causal=True).numpy(),
        tpar.local_attention(*ts, causal=True).numpy())
    with pytest.raises(ValueError, match="launch them with python -m "
                       "mxnet_tpu_torch.tools.launch -n 2"):
        tpar.create_mesh({"dp": 2})


@pytest.mark.parametrize("name", ["HostLostError"])
def test_next_slice_names_raise(name):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A item 12, order step 6"):
        getattr(tpar, name)()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _jax_collectives():
    mesh = _jmesh({"dp": N})
    x = jnp.arange(16, dtype=jnp.float32)
    xs = jax.device_put(x, NamedSharding(mesh, JP("dp")))
    return mesh, {
        "all_reduce": np.asarray(jpar.all_reduce(xs, mesh, "dp")),
        "all_reduce_max": np.asarray(jpar.all_reduce(xs, mesh, "dp",
                                                     op="max")),
        "all_reduce_mean": np.asarray(jpar.all_reduce(xs, mesh, "dp",
                                                      op="mean")),
        "all_gather": np.asarray(jpar.all_gather(xs, mesh, "dp")),
        "all_gather_stacked": np.asarray(jpar.all_gather(xs, mesh, "dp",
                                                         tiled=False)),
        "ppermute": np.asarray(jpar.ppermute(
            xs, mesh, "dp", [(i, (i + 1) % N) for i in range(N)])),
        "ppermute_partial": np.asarray(jpar.ppermute(xs, mesh, "dp",
                                                     [(0, 1)])),
        "broadcast": np.asarray(jpar.broadcast(xs, mesh, "dp",
                                               root=N - 1)),
    }


@pytest.mark.parametrize("name", ["all_reduce", "all_reduce_max",
                                  "all_reduce_mean", "all_gather",
                                  "all_gather_stacked"])
def test_reduce_and_gather_match_jax(ranks, name):
    _no_errors(ranks, "check_collectives")
    _, want = _jax_collectives()
    for r in ranks:
        got = r["coll/" + name]
        np.testing.assert_array_equal(got, want[name].reshape(got.shape))


@pytest.mark.parametrize("name", ["ppermute", "ppermute_partial",
                                  "broadcast"])
def test_shard_collectives_match_jax(ranks, name):
    _, want = _jax_collectives()
    np.testing.assert_array_equal(_cat(ranks, "coll/" + name), want[name])


def test_all_to_all_and_psum(ranks):
    blocks = [np.arange(2 * 4 * N, dtype=np.float32).reshape(2, 4 * N)
              + 100 * r for r in range(N)]
    for r, res in enumerate(ranks):
        want = np.concatenate([b[:, 4 * r:4 * (r + 1)] for b in blocks])
        np.testing.assert_array_equal(res["coll/all_to_all"], want)
        per = 16 // N
        np.testing.assert_array_equal(
            res["coll/psum_eager"],
            3 * np.arange(r * per, (r + 1) * per, dtype=np.float32))


@pytest.mark.parametrize("d0", h.RS_DIMS)
def test_reduce_scatter_pads_odd_leading_dim(ranks, d0):
    """tests/test_grad_sync.py's pad-and-slice: the ranks' rows put
    together are the sum, at the original shape."""
    mesh = _jmesh({"dp": N})
    val = np.random.RandomState(d0).randint(-100, 100, (d0, 3)) \
        .astype(np.float32)
    want = np.asarray(jpar.collectives.reduce_scatter(
        jax.device_put(val, NamedSharding(mesh, JP())), mesh))
    got = _cat(ranks, "coll/rs%d" % d0)
    assert got.shape == (d0, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, val * N)


def test_reduce_scatter_divisible_unchanged(ranks):
    val = np.arange(16, dtype=np.float32).reshape(16, 1)
    np.testing.assert_array_equal(_cat(ranks, "coll/rs_div"), val * N)


def test_bucket_reduce_scatter_all_gather_round_trip(ranks):
    mesh = _jmesh({"dp": N})
    rng = np.random.RandomState(3)
    stacked = [jax.device_put(rng.normal(0, 1, (N,) + s).astype(np.float32),
                              NamedSharding(mesh, JP("dp")))
               for s in h.BUCKET_SHAPES]
    flat = jpar.collectives.bucket_reduce_scatter(stacked, mesh)
    full = np.asarray(jpar.collectives.bucket_all_gather(flat, mesh))
    # two addends: the sum is exact in any order
    np.testing.assert_array_equal(_cat(ranks, "coll/bucket_local"),
                                  np.asarray(flat))
    for r in ranks:
        np.testing.assert_array_equal(r["coll/bucket_full"], full)


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_attention(impl, causal, shape, seed, axes):
    """JAX's output on a mesh of ``axes`` (the sequence over ``sp``), and
    the q/k/v gradients of the same attention through ``jax.vjp`` of
    its local form (the mesh form's vjp is the same function's, and
    compiles for tens of seconds on the CPU); all global."""
    axes = dict(axes)
    mesh = _jmesh(axes)
    q, k, v, dout = h.attn_inputs(shape, seed)
    sh = NamedSharding(mesh, JP(None, "sp", None, None))
    fn = jpar.ring_attention if impl == "ring" else jpar.ulysses_attention
    out = fn(*[jax.device_put(a, sh) for a in (q, k, v)], mesh=mesh,
             axis="sp", causal=causal)
    ref, vjp = jax.vjp(lambda a, b, c: jpar.local_attention(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads = vjp(jnp.asarray(dout))
    return [np.asarray(out)] + [np.asarray(g) for g in grads] \
        + [np.asarray(ref)]


@pytest.mark.parametrize("case", h.ATTN_CASES,
                         ids=["%s_%s" % (c[0], "causal" if c[1] else "full")
                              for c in h.ATTN_CASES])
def test_attention_matches_jax_mesh(ranks, case):
    _no_errors(ranks, "check_attention")
    impl, causal, shape, seed = case
    want = _jax_attention(impl, causal, shape, seed, (("sp", N),))
    key = "attn/%s_%s" % (impl, "causal" if causal else "full")
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(_cat(ranks, "%s/%s" % (key, name), 1), w,
                                   err_msg=name, **ATTN_TOL)


@pytest.mark.parametrize("case", h.ATTN_CASES,
                         ids=["%s_%s" % (c[0], "causal" if c[1] else "full")
                              for c in h.ATTN_CASES])
def test_attention_matches_local(ranks, case):
    """tests/test_parallel.py's oracle: the sharded result equals local
    attention over the whole sequence."""
    impl, causal, shape, seed = case
    ref = _jax_attention(impl, causal, shape, seed, (("sp", N),))[-1]
    key = "attn/%s_%s/out" % (impl, "causal" if causal else "full")
    np.testing.assert_allclose(_cat(ranks, key, 1), ref, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "auto"])
def test_attention_op_under_sp_mesh(ranks, impl):
    """``_contrib_flash_attention`` under ``use_mesh``: JAX's op takes the
    whole sequence and shards it; the port's ranks pass their slices."""
    _no_errors(ranks, "check_attention_op")
    mesh = _jmesh({"sp": N})
    q, k, v, _ = h.attn_inputs((2, 16, 8, 4), 7)
    with jpar.mesh.use_mesh(mesh):
        want = jmx.nd.contrib.flash_attention(
            jmx.nd.array(q), jmx.nd.array(k), jmx.nd.array(v), impl=impl,
            causal=True).asnumpy()
    np.testing.assert_allclose(_cat(ranks, "attn_op/" + impl, 1), want,
                               **ATTN_TOL)


CASES4 = [c for c in h.ATTN_CASES if c[2][0] % 2 == 0]


@pytest.mark.parametrize("case", CASES4,
                         ids=["%s_%s" % (c[0], "causal" if c[1] else "full")
                              for c in CASES4])
def test_attention_on_dp_sp_mesh(ranks4, case):
    """Four ranks as ``{"dp": 2, "sp": 2}``: rank (d, s) holds batch rows
    d and sequence slice s; JAX's 4-device mesh of the same axes."""
    _no_errors(ranks4, "check_attention4")
    impl, causal, shape, seed = case
    want = _jax_attention(impl, causal, shape, seed, (("dp", 2), ("sp", 2)))
    key = "attn4/%s_%s" % (impl, "causal" if causal else "full")
    B, T = shape[0] // 2, shape[1] // 2
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        for rank, res in enumerate(ranks4):
            d, s = divmod(rank, 2)
            np.testing.assert_allclose(
                res["%s/%s" % (key, name)],
                w[d * B:(d + 1) * B, s * T:(s + 1) * T], err_msg=name,
                **ATTN_TOL)


def test_axis_groups_follow_jax_device_order(ranks4):
    jm = _jmesh({"dp": 2, "sp": 2})
    order = [d.id for d in jm.devices.flat]
    assert order == [0, 1, 2, 3]
    for rank, res in enumerate(ranks4):
        d, s = divmod(rank, 2)
        assert res["groups/coords"] == [d, s]
        assert float(res["groups/dp"][0]) == s + (s + 2)
        assert float(res["groups/sp"][0]) == 2 * d + (2 * d + 1)


def _one_process_sp_losses(k, monkeypatch):
    """The same two runs in this process, on the whole batch (a world of
    one rank)."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    mesh = tpar.create_mesh({"dp": 1, "sp": 1})
    if k == 0:
        tr = tpar.DistributedTrainer(
            h.sp_net(tmx, "probe"), tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
            mesh, optimizer="sgd",
            optimizer_params={"learning_rate": h.SP_LR})
        return [float(tr.fit_batch(tmx.nd.array(x), tmx.nd.array(y))
                      .asnumpy()) for x, y in h.sp_batches("probe")]
    step, _ = tpar.make_data_parallel_step(
        lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), mesh,
        optimizer_update=lambda p, g: p - 0.1 * g)
    params, losses = {"w": torch.zeros(4, 1)}, []
    for x, y in h.sp_step_data():
        loss, params = step(params, {"x": x, "y": y})
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("k", range(2),
                         ids=["DistributedTrainer", "make_data_parallel_step"])
def test_dp_paths_train_over_sp_axis(ranks4, k, monkeypatch):
    """A ``{"dp": 2, "sp": 2}`` mesh: each rank takes its dp rows and its
    sp half of the sequence; the ranks agree and follow the one-process
    run on the whole batch."""
    _no_errors(ranks4, "check_attention4")
    key = ("sp_train/trainer", "sp_train/step")[k]
    want = _one_process_sp_losses(k, monkeypatch)
    for res in ranks4:
        assert res[key] == ranks4[0][key]
        np.testing.assert_allclose(res[key], want, **TRAJ_TOL)
    if k == 1:
        assert ranks4[0][key][-1] < ranks4[0][key][0]


# ---------------------------------------------------------------------------
# make_data_parallel_step
# ---------------------------------------------------------------------------

def _jax_dp_step():
    mesh = _jmesh({"dp": N})

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    step, bsh = jpar.make_data_parallel_step(
        loss_fn, mesh, optimizer_update=lambda p, g: p - 0.2 * g,
        donate=False)
    params = {"w": jnp.zeros((4, 1)), "b": jnp.zeros((1,))}
    losses, first = [], None
    for x, y in h.dp_step_data():
        loss, params = step(params, {"x": jax.device_put(x, bsh),
                                     "y": jax.device_put(y, bsh)})
        losses.append(float(loss))
        if first is None:
            first = np.asarray(params["w"])
    return np.array(losses), first, params


def test_data_parallel_step_matches_jax(ranks):
    _no_errors(ranks, "check_dp_step")
    losses, first, params = _jax_dp_step()
    for r in ranks:
        np.testing.assert_allclose(r["dp_step/0/losses"][0], losses[0],
                                   **STEP_TOL)
        np.testing.assert_allclose(r["dp_step/0/first_w"], first,
                                   **STEP_TOL)
        np.testing.assert_allclose(r["dp_step/0/losses"], losses,
                                   **TRAJ_TOL)
        np.testing.assert_allclose(r["dp_step/0/w"], np.asarray(params["w"]),
                                   **TRAJ_TOL)
        assert r["dp_step/0/losses"][-1] < r["dp_step/0/losses"][0] * 0.1


def test_data_parallel_step_buckets_bitexact(ranks):
    for r in ranks:
        for key in ("losses", "w", "b"):
            np.testing.assert_array_equal(r["dp_step/0/" + key],
                                          r["dp_step/1/" + key])
    np.testing.assert_array_equal(ranks[0]["dp_step/1/w"],
                                  ranks[1]["dp_step/1/w"])
