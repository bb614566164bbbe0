"""The port's ``parallel/multihost.py`` against the JAX package's
(``tests/test_multihost.py``'s heartbeat and step-boundary cases) and its
own claims:

- ``Heartbeat._check_peers(now)`` of both packages on the same peer files
  and mtimes, sweep by sweep: a fresh peer, a stale peer needing two
  strikes, self-starvation, startup grace for a previous generation's
  beat, the ``.done`` marker, a peer that disappears, and who watches
  whom;
- ``step_boundary`` visits ``proc_exit`` and surfaces a loss, alone, in
  ``DistributedTrainer.fit_batch`` and in ``Module.fit``;
- the store exchange over two gloo ranks: the bounded barrier,
  ``exchange_arrays`` in rank order, ``cross_host_sum`` equal to numpy's
  rank-major left fold bit for bit, a slow rank whose heartbeat is fresh
  waited for, and a rank that never posts named in a ``HostLostError``
  within the bound;
- the ``{dp: 2, tp: 2}`` FSDP trainer's checkpoint over four ranks: a
  fresh trainer loads it and its next step equals the running trainer's
  bit for bit, and ``mxnet_tpu.checkpoint`` reads the same full arrays;
- the launch knobs' names, types and defaults, and the module's public
  names."""
import os
import time

import numpy as np
import pytest

from mxnet_tpu import envs as jenvs
from mxnet_tpu import fault as jfault
from mxnet_tpu.parallel import multihost as jmh
from mxnet_tpu_torch import envs as tenvs
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import multihost as tmh

import torch_mesh_ranks as h

PACKAGES = {"jax": jmh, "torch": tmh}
BASE = 1.0e9                      # the sweeps' clock: files' mtimes are set
                                  # against it, not against time.time()


# ---------------------------------------------------------------------------
# the heartbeat, sweep by sweep, in both packages
# ---------------------------------------------------------------------------

def _write(d, rank, age):
    path = os.path.join(d, "hb-%d" % rank)
    with open(path, "w") as f:
        f.write("beat\n")
    os.utime(path, (BASE - age, BASE - age))


def _hb(mod, d, rank=0, world=2, started=BASE - 120):
    hb = mod.Heartbeat(rank, world, hb_dir=d, exit_on_loss=False)
    hb._started = started
    hb._last_touch = BASE
    return hb


def _case_fresh(mod, d):
    hb = _hb(mod, d)
    _write(d, 1, 0.1)
    return [hb._check_peers(BASE)]


def _case_stale_two_strikes(mod, d):
    hb = _hb(mod, d)
    _write(d, 1, 5.0)
    return [hb._check_peers(BASE), dict(hb._strikes), hb._check_peers(BASE)]


def _case_self_starvation(mod, d):
    hb = _hb(mod, d)
    _write(d, 1, 5.0)
    hb._last_touch = BASE - 10.0
    return [hb._check_peers(BASE), hb._check_peers(BASE), dict(hb._strikes)]


def _case_previous_generation(mod, d):
    _write(d, 1, 300.0)
    hb = _hb(mod, d, started=BASE)
    out = [hb._check_peers(BASE), hb._check_peers(BASE)]
    _write(d, 1, 0.0)
    return out + [hb._check_peers(BASE),
                  sorted(k for k in hb._seen if isinstance(k, int))]


def _case_done_marker(mod, d):
    hb = _hb(mod, d)
    _write(d, 1, 5.0)
    with open(os.path.join(d, "hb-1.done"), "w") as f:
        f.write("done\n")
    return [hb._check_peers(BASE), hb._check_peers(BASE)]


def _case_disappeared(mod, d):
    hb = _hb(mod, d)
    _write(d, 1, 0.1)
    out = [hb._check_peers(BASE)]
    os.unlink(os.path.join(d, "hb-1"))
    return out + [hb._check_peers(BASE), hb._check_peers(BASE)]


def _case_who_watches_whom(mod, d):
    return [mod.Heartbeat(0, 4, hb_dir=d)._peers(),
            mod.Heartbeat(2, 4, hb_dir=d)._peers()]


CASES = {
    "fresh": (_case_fresh, [None]),
    "stale_two_strikes": (_case_stale_two_strikes,
                          [None, {1: 1},
                           "rank 1 heartbeat stale for 5.000s (timeout "
                           "1.000s) — host lost or wedged"]),
    "self_starvation": (_case_self_starvation, [None, None, {}]),
    "previous_generation": (_case_previous_generation,
                            [None, None, None, [1]]),
    "done_marker": (_case_done_marker, [None, None]),
    "disappeared": (_case_disappeared,
                    [None, None, "rank 1 heartbeat file disappeared — host "
                                 "lost"]),
    "who_watches_whom": (_case_who_watches_whom, [[1, 2, 3], [0]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_heartbeat_sweeps_match_the_jax_package(case, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("MXNET_HB_TIMEOUT_MS", "1000")
    fn, want = CASES[case]
    got = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = fn(mod, str(d))
    assert got["torch"] == got["jax"]
    assert got["torch"] == want


def test_never_seen_peer_is_lost_after_the_grace(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HB_TIMEOUT_MS", "1000")
    got = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        hb = _hb(mod, str(d))
        got[name] = [hb._check_peers(BASE)]
        hb._last_touch = BASE + 6          # our own beat stays fresh
        got[name] += [hb._check_peers(BASE + 6), hb._check_peers(BASE + 6)]
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == [None, None]
    assert got["torch"][2].startswith("rank 1 heartbeat never appeared")


def test_writer_and_clean_departure(tmp_path, monkeypatch):
    """The writer beats (ticks, a fresh file), and a clean stop leaves
    the ``.done`` marker a restarted incarnation removes."""
    monkeypatch.setenv("MXNET_HB_INTERVAL_MS", "20")
    hb = tmh.Heartbeat(0, 1, hb_dir=str(tmp_path)).start()
    time.sleep(0.3)
    hb.stop()
    assert hb.ticks >= 3
    assert time.time() - os.stat(tmp_path / "hb-0").st_mtime < 5
    (tmp_path / "hb-0.done").write_text("done\n")
    tmh.Heartbeat(0, 1, hb_dir=str(tmp_path)).start().stop()
    assert not (tmp_path / "hb-0.done").exists()


def test_heartbeat_starts_only_under_the_contract(tmp_path, monkeypatch):
    import sys
    for var in ("DMLC_WORKER_ID", "DMLC_NUM_WORKER", "MXNET_TPU_RANK",
                "MXNET_TPU_WORLD", "MXNET_HB_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert tmh.maybe_start_heartbeat() is None
    monkeypatch.setenv("MXNET_HB_DIR", str(tmp_path))
    assert tmh.maybe_start_heartbeat() is None          # a world of one
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    hb = tmh.maybe_start_heartbeat(rank=1, world=2)
    try:
        assert hb is tmh.heartbeat() and hb.rank == 1 and hb.world == 2
        assert tmh.maybe_start_heartbeat(rank=1, world=2) is hb
        assert (tmp_path / "hb-1").exists()
    finally:
        tmh.stop_heartbeat()
    assert tmh.heartbeat() is None
    assert (tmp_path / "hb-1.done").exists()


# ---------------------------------------------------------------------------
# step boundaries
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_multihost():
    yield
    tfault.set_plan(None)
    tmh._dying[0] = False
    tmh._host_lost[0] = None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_step_boundary_fault_site_and_loss(pkg, clean_multihost):
    mod, fault = (jmh, jfault) if pkg == "jax" else (tmh, tfault)
    fault.set_plan("proc_exit:step=3:raise")
    try:
        mod.step_boundary()
        mod.step_boundary()
        with pytest.raises(fault.InjectedFault):
            mod.step_boundary()
        assert mod._dying[0]
    finally:
        fault.set_plan(None)
        mod._dying[0] = False
    mod._host_lost[0] = "rank 1 gone (test)"
    try:
        with pytest.raises(mod.HostLostError, match="rank 1 gone"):
            mod.step_boundary()
    finally:
        mod._host_lost[0] = None
        mod._dying[0] = False


def _trainer():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel as par
    net = mx.gluon.nn.HybridSequential(prefix="sb_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4))
    net.initialize()
    return mx, par.DistributedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        par.create_mesh({"dp": 1}), optimizer="sgd")


def test_fit_batch_visits_the_step_boundary(clean_multihost, monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    mx, tr = _trainer()
    x = mx.nd.array(np.ones((4, 3), np.float32))
    y = mx.nd.array(np.zeros((4,), np.float32))
    tfault.set_plan("proc_exit:step=2:raise")
    tr.fit_batch(x, y)
    with pytest.raises(tfault.InjectedFault):
        tr.fit_batch(x, y)
    assert tr.dispatch_count == 1
    tfault.set_plan(None)
    tmh._dying[0] = False
    tmh._host_lost[0] = "rank 1 heartbeat stale (test)"
    with pytest.raises(tmh.HostLostError):
        tr.fit_batch(x, y)
    assert tr.dispatch_count == 1


def test_module_fit_visits_the_step_boundary(clean_multihost, monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    import mxnet_tpu_torch as mx
    data = mx.sym.var("data")
    out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(data, num_hidden=3),
                               name="softmax")
    it = mx.io.NDArrayIter(np.ones((20, 5), np.float32),
                           np.zeros((20,), np.float32), batch_size=4)
    mod = mx.mod.Module(out, context=mx.cpu())
    seen = []
    tfault.set_plan("proc_exit:step=3:raise")
    with pytest.raises(tfault.InjectedFault):
        mod.fit(it, num_epoch=1, optimizer="sgd",
                batch_end_callback=lambda p: seen.append(p.nbatch))
    assert len(seen) == 2
    tfault.set_plan(None)
    tmh._dying[0] = False
    tmh._host_lost[0] = "rank 1 heartbeat stale (test)"
    it.reset()
    with pytest.raises(tmh.HostLostError):
        mod.fit(it, num_epoch=1, optimizer="sgd")


# ---------------------------------------------------------------------------
# the store exchange over two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks_mh(tmp_path_factory):
    results = h.spawn(tmp_path_factory.mktemp("mh"), "multihost", 2)
    for r in results:
        assert not h.errors(results, ""), h.errors(results, "")
    return results


def test_barrier_and_exchange_in_rank_order(ranks_mh):
    for r in ranks_mh:
        assert r["mh/x"] == [[[0, 0, 0, 0], [0, 0]],
                             [[0, 1, 2, 3], [1, 1]]]
        assert r["mh/x_dtypes"] == [["int64", "int64"]] * 2
        assert r["mh/barrier_s"] < 5


def test_cross_host_sum_is_the_rank_major_left_fold(ranks_mh):
    stacks = [h.mh_stacks(r) for r in range(2)]
    for leaf in range(2):
        acc = None
        for rank_stack in stacks:
            for row in rank_stack[leaf]:
                acc = row.copy() if acc is None else acc + row
        for r in ranks_mh:
            assert r["mh/sum%d" % leaf].dtype == acc.dtype
            np.testing.assert_array_equal(r["mh/sum%d" % leaf], acc)
    # the same fold through the JAX package's function on one process
    jsum = jmh.cross_host_sum("t", [np.concatenate([s[leaf] for s in stacks])
                                    for leaf in range(2)])
    for leaf in range(2):
        np.testing.assert_array_equal(ranks_mh[0]["mh/sum%d" % leaf],
                                      jsum[leaf])


def test_a_slow_rank_with_a_fresh_beat_is_waited_for(ranks_mh):
    for r in ranks_mh:
        assert r["mh/slow"] == ["r0", "r1"]
    assert ranks_mh[0]["mh/slow_s"] > 2.0


def test_a_silent_rank_is_named_within_the_bound(ranks_mh):
    msg = ranks_mh[0]["mh/silent"]
    assert "rank(s) 1 produced nothing within 1500ms" in msg, msg
    assert 1.4 < ranks_mh[0]["mh/silent_s"] < 10


# ---------------------------------------------------------------------------
# the {dp: 2, tp: 2} FSDP checkpoint over four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks_tp_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpck")
    results = h.spawn(tmp, "tp_ckpt", 4)
    assert not h.errors(results, ""), h.errors(results, "")
    return tmp, results


def test_tp_checkpoint_round_trips_bit_for_bit(ranks_tp_ckpt):
    _, ranks = ranks_tp_ckpt
    for r in ranks:
        assert r["tpck/states_equal"]
        assert r["tpck/fresh_loss"] == r["tpck/loss"]
        for i in range(4):
            np.testing.assert_array_equal(r["tpck/fresh_after/%d" % i],
                                          r["tpck/after/%d" % i])


def test_tp_checkpoint_reads_back_in_the_jax_package(ranks_tp_ckpt):
    from mxnet_tpu import checkpoint as jckpt
    tmp, ranks = ranks_tp_ckpt
    prefix = str(tmp / "tpck")
    manifest = jckpt.load_manifest(prefix, 0)
    assert manifest["processes"] == 4
    w = manifest["params"]["arg:tpnet_dense0_weight"]
    assert len(w["pieces"]) == 4
    assert sorted(p["index"][0][0] for p in w["pieces"]) == [0, 0, 32, 32]
    flat = jckpt.load_arrays(prefix, 0)
    r0 = ranks[0]
    for name in r0["tpck/roster"]:
        np.testing.assert_array_equal(flat["arg:" + name].asnumpy(),
                                      r0["tpck/arg/" + name])
    slots = [k for k in flat if k.startswith("opt:2d:")]
    assert len(slots) == 2 * len(r0["tpck/roster"])
    for k in slots:
        np.testing.assert_array_equal(flat[k].asnumpy(), r0["tpck/" + k])


# ---------------------------------------------------------------------------
# knobs and names
# ---------------------------------------------------------------------------

KNOBS = ["MXNET_LAUNCH_MAX_RESTARTS", "MXNET_LAUNCH_BACKOFF",
         "MXNET_LAUNCH_ALLOW_SHRINK", "MXNET_LAUNCH_RESUME_EPOCH",
         "MXNET_HB_INTERVAL_MS", "MXNET_HB_TIMEOUT_MS", "MXNET_HB_DIR",
         "MXNET_LAUNCH_GRACE", "MXNET_LAUNCH_RESTART"]


@pytest.mark.parametrize("name", KNOBS)
def test_launch_knobs_have_the_jax_defaults(name):
    j, t = jenvs.registry()[name], tenvs.registry()[name]
    assert (t.kind, t.default) == (j.kind, j.default)


def test_public_names_and_exit_code():
    from mxnet_tpu_torch import parallel as tpar
    assert set(jmh.__all__) <= set(tmh.__all__)
    assert all(hasattr(tmh, n) for n in jmh.__all__)
    assert tmh.HOST_LOST_EXIT == jmh.HOST_LOST_EXIT == 43
    assert tpar.HostLostError is tmh.HostLostError
    assert issubclass(tmh.HostLostError, MXNetError)
    assert str(tpar.HostLostError("rank 1 lost")) == "rank 1 lost"
    assert "proc_hb" in tfault._SITES and "proc_exit" in tfault._SITES


def test_outside_a_group_the_control_plane_is_local():
    from mxnet_tpu_torch.parallel import distributed
    assert not distributed.is_initialized()
    assert tmh.coordination_client() is None
    assert tmh.supports_global_spmd()
    tmh.barrier("alone")
    assert tmh.exchange_bytes("alone", b"x") == [b"x"]
    got = tmh.cross_host_sum("alone", [np.arange(6.0).reshape(3, 2)])
    np.testing.assert_array_equal(got[0], [6.0, 9.0])
    distributed.barrier()


def test_a_detected_loss_reaches_the_crash_path(tmp_path, monkeypatch,
                                                clean_multihost):
    """The monitor's loss notes ``host_lost`` in telemetry, dumps a
    ``crash:host_lost`` flight bundle and surfaces at the next step
    boundary; a dying rank's stop dumps ``crash:host_dying``; a restarted
    generation's telemetry renders diagnose's restarts line."""
    from mxnet_tpu_torch import flightrec, telemetry
    from mxnet_tpu_torch.tools.diagnose import format_telemetry, \
        read_telemetry
    monkeypatch.setenv("MXNET_HB_TIMEOUT_MS", "200")
    monkeypatch.setenv("MXNET_HB_INTERVAL_MS", "20")
    monkeypatch.setenv("MXNET_LAUNCH_RESTART", "1")
    sink = str(tmp_path / "run.jsonl")
    telemetry.reset()
    telemetry.start(filename=sink)
    flightrec.enable(str(tmp_path / "fr"))
    try:
        _write(str(tmp_path), 1, 0.0)
        os.utime(tmp_path / "hb-1", (time.time() - 5, time.time() - 5))
        hb = tmh.Heartbeat(0, 2, hb_dir=str(tmp_path), exit_on_loss=False)
        hb._started -= 60
        hb.start()
        deadline = time.time() + 10
        while tmh.host_lost() is None and time.time() < deadline:
            time.sleep(0.02)
        hb.stop()
        assert "rank 1 heartbeat stale" in tmh.host_lost()
        with pytest.raises(tmh.HostLostError, match="rank 1"):
            tmh.step_boundary()
        monkeypatch.setenv("MXNET_HB_DIR", str(tmp_path / "own"))
        monkeypatch.setattr(__import__("sys"), "excepthook",
                            __import__("sys").excepthook)
        tmh.maybe_start_heartbeat(rank=0, world=2)
        tmh.stop_heartbeat(clean=False)
        reasons = [flightrec.read_bundle(p)["reason"]
                   for p in flightrec.list_bundles(str(tmp_path / "fr"))]
        assert reasons == ["crash:host_lost", "crash:host_dying"]
        assert (tmp_path / "own" / "hb-0").exists()
        assert not (tmp_path / "own" / "hb-0.done").exists()
    finally:
        flightrec.disable()
        telemetry.stop()
    text = format_telemetry(read_telemetry(sink))
    assert "restart generation 1" in text
    telemetry.reset()
