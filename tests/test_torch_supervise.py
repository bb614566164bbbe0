"""The port's supervised launcher (``tools/launch.py --supervise``) and
the multi-host fault path end to end, against the JAX package
(``tests/test_multihost.py``'s launcher and subprocess cases):

- the restart budget: the same ``python -c`` command under both
  packages' supervisors gives the same sequence of event kinds;
- ``--supervise`` through the CLI: a world that fails in generation 0
  and succeeds in generation 1, with the generation and the resume epoch
  in each worker's environment;
- the JAX test's ``_TRAIN_WORKER``, ported: two gloo CPU ranks through
  ``python -m mxnet_tpu_torch.tools.launch``, rank 1 killed at its 6th
  step by ``proc_exit:step=6:raise``, the supervisor restarting the
  world from epoch 0's manifest; the final weights equal an
  uninterrupted run's bit for bit, the last manifest records
  ``processes: 2``, and both runs are held to the JAX package's
  ``DistributedTrainer`` on a ``{dp: 2}`` mesh at rtol 1e-5, atol 1e-6
  (ROADMAP rule 5);
- a wedged host: rank 1's heartbeat writer stalls for good
  (``proc_hb:step=1:stall:count=inf``) while the process lives on; rank
  0's monitor exits 43 (``HOST_LOST_EXIT``) and the launcher with it,
  well inside the sleep the job would otherwise spend.

The JAX worker's ``WARM_CACHE`` assertion (a restarted generation
compiles nothing fresh) is left out of the ported worker: the port's
compile cache keeps device code (nvcc libraries, NVRTC cubins), and a
CPU worker builds none, so there is nothing for it to warm.
``chip_smoke.py`` phase 33 is its card counterpart: a warm child process
runs no nvcc and no NVRTC compile."""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS, BATCH, LR = 3, 4, 16, 0.05
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               MXNET_DEFAULT_CONTEXT="cpu", OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _launch(args, env, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"] + args,
        env=env, cwd=ROOT, capture_output=True, timeout=timeout)


def _kinds(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# the supervisor against the JAX package's
# ---------------------------------------------------------------------------

def test_supervisor_gives_up_after_budget_as_the_jax_one(tmp_path,
                                                         monkeypatch):
    from mxnet_tpu.tools import launch as jlaunch
    from mxnet_tpu_torch.tools import launch as tlaunch
    monkeypatch.setenv("MXNET_LAUNCH_GRACE", "1")
    monkeypatch.setenv("MXNET_LAUNCH_BACKOFF", "0.1")
    monkeypatch.delenv("MXNET_HB_DIR", raising=False)
    cmd = [sys.executable, "-c", "import sys; sys.exit(9)"]
    got = {}
    for name, mod in (("jax", jlaunch), ("torch", tlaunch)):
        events = str(tmp_path / ("%s.jsonl" % name))
        assert mod.supervise(1, cmd, events_file=events,
                             max_restarts=1) == 9
        got[name] = _kinds(events)
    kinds = [r["kind"] for r in got["torch"]]
    assert kinds == [r["kind"] for r in got["jax"]]
    assert kinds.count("launch") == 2 and kinds[-1] == "give_up"
    for a, b in zip(got["jax"], got["torch"]):
        assert set(a) == set(b), (a, b)
        for key in ("attempt", "rank", "code", "workers", "resume_epoch"):
            assert a.get(key) == b.get(key), (key, a, b)


def test_supervise_through_the_cli(tmp_path):
    events = tmp_path / "ev.jsonl"
    prefix = tmp_path / "none"
    code = ("import os, sys\n"
            "gen = os.environ['MXNET_LAUNCH_RESTART']\n"
            "assert os.path.isdir(os.environ['MXNET_HB_DIR'])\n"
            "print('GEN', gen, repr(os.environ['MXNET_LAUNCH_RESUME_EPOCH'])"
            ", flush=True)\n"
            "sys.exit(5 if gen == '0' and "
            "os.environ['DMLC_WORKER_ID'] == '1' else 0)\n")
    r = _launch(["-n", "2", "--supervise", "--max-restarts", "2",
                 "--resume-prefix", str(prefix), "--events-file",
                 str(events), sys.executable, "-c", code],
                _env(MXNET_LAUNCH_BACKOFF=0.1, MXNET_LAUNCH_GRACE=1))
    out = r.stdout.decode()
    assert r.returncode == 0, (out, r.stderr.decode()[-2000:])
    assert "GEN 1 ''" in out
    kinds = [rec["kind"] for rec in _kinds(events)]
    assert kinds == ["launch", "worker_failed", "teardown", "restart",
                     "launch", "success"]
    failed = _kinds(events)[1]
    assert (failed["rank"], failed["code"]) == (1, 5)


# ---------------------------------------------------------------------------
# the supervised restart, bit for bit
# ---------------------------------------------------------------------------

_TRAIN_WORKER = r'''
import os, sys
# the rank-conditioned fault plan lands BEFORE the package import (the
# import joins the group, visiting fault sites, which latches the plan)
_rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
_gen = int(os.environ.get("MXNET_LAUNCH_RESTART", "0") or 0)
_fault = os.environ.get("TEST_FAULT_STEP", "")
if _fault and _rank == 1 and _gen == 0:
    os.environ["MXNET_FAULT_PLAN"] = "proc_exit:step=%s:raise" % _fault
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, envs
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import create_mesh
from mxnet_tpu_torch.parallel.data_parallel import DistributedTrainer

out, opt, prefix = sys.argv[1], sys.argv[2], sys.argv[3]
EPOCHS, STEPS, B = int(os.environ["TEST_EPOCHS"]), 4, 16
kv = mx.kv.create("dist_sync")
rank, world = kv.rank, kv.num_workers
mesh = create_mesh({"dp": world})
np.random.seed(3)
net = nn.HybridSequential(prefix="mh_")
with net.name_scope():
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
net.initialize(mx.init.Xavier(rnd_type="gaussian"))
net(mx.nd.array(np.zeros((2, 8), np.float32)))
if rank == 0 and _gen == 0:
    np.savez(out + ".init.npz", **{k: v.data().asnumpy() for k, v in
                                   net.collect_params().items()})
tr = DistributedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), mesh,
                        optimizer=opt, learning_rate=0.05)
resume = envs.get_int("MXNET_LAUNCH_RESUME_EPOCH")
begin = 0
if resume is not None:
    tr.load_checkpoint(prefix, resume)
    begin = resume + 1
losses = []
for epoch in range(begin, EPOCHS):
    rng = np.random.RandomState(100 + epoch)
    data = rng.randn(STEPS, B, 8).astype(np.float32)
    lab = rng.randint(0, 4, size=(STEPS, B)).astype(np.float32)
    for s in range(STEPS):
        losses.append(float(tr.fit_batch(mx.nd.array(data[s]),
                                         mx.nd.array(lab[s])).asnumpy()))
    tr.save_checkpoint(prefix, epoch)
tr.sync_gluon_params()
if rank == 0:
    res = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    res["losses"] = np.array(losses)
    np.savez(out, **res)
# one write: the two ranks share the launcher's stdout
sys.stdout.write("TRAIN_WORKER_DONE %d %d\n" % (rank, begin))
sys.stdout.flush()
'''


def _jax_run(init):
    """The JAX package's DistributedTrainer over {dp: 2} on two CPU
    devices, from the same initial weights and batches (each global
    batch whole: the mesh splits it)."""
    from mxnet_tpu.gluon import nn
    mesh = jpar.create_mesh({"dp": 2}, devices=jax.devices()[:2])
    net = nn.HybridSequential(prefix="mh_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize()
    net(jmx.nd.array(np.zeros((2, 8), np.float32)))
    for name, p in net.collect_params().items():
        p.set_data(jmx.nd.array(init[name]))
    tr = jpar.DistributedTrainer(net, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                 mesh, optimizer="adam", learning_rate=LR)
    for epoch in range(EPOCHS):
        rng = np.random.RandomState(100 + epoch)
        data = rng.randn(STEPS, BATCH, 8).astype(np.float32)
        lab = rng.randint(0, 4, size=(STEPS, BATCH)).astype(np.float32)
        for s in range(STEPS):
            tr.fit_batch(jmx.nd.array(data[s]), jmx.nd.array(lab[s]))
    tr.sync_gluon_params()
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def test_supervised_restart_resumes_the_exact_trajectory(tmp_path):
    from mxnet_tpu_torch import checkpoint as ckpt
    worker = tmp_path / "worker.py"
    worker.write_text(_TRAIN_WORKER)
    common = dict(TEST_EPOCHS=EPOCHS, MXNET_HB_TIMEOUT_MS=2000,
                  MXNET_LAUNCH_BACKOFF=0.2, MXNET_LAUNCH_GRACE=3)
    events = str(tmp_path / "events.jsonl")
    sup_out, ref_out = str(tmp_path / "sup.npz"), str(tmp_path / "ref.npz")
    r = _launch(["-n", "2", "--supervise", "--resume-prefix",
                 str(tmp_path / "sup"), "--events-file", events,
                 sys.executable, str(worker), sup_out, "adam",
                 str(tmp_path / "sup")], _env(TEST_FAULT_STEP=6, **common))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    recs = _kinds(events)
    kinds = [rec["kind"] for rec in recs]
    assert kinds == ["launch", "worker_failed", "teardown", "restart",
                     "launch", "success"], kinds
    assert recs[1]["rank"] == 1 and recs[1]["code"] == 1
    assert recs[-2]["attempt"] == 1 and recs[-2]["resume_epoch"] == 0
    assert "TRAIN_WORKER_DONE 0 1" in r.stdout.decode()
    r2 = _launch(["-n", "2", sys.executable, str(worker), ref_out, "adam",
                  str(tmp_path / "ref")], _env(**common))
    assert r2.returncode == 0, r2.stderr[-3000:]
    ws, wr = dict(np.load(sup_out)), dict(np.load(ref_out))
    assert set(ws) == set(wr) and len(wr) == 5
    for k in sorted(wr):
        if k == "losses":
            continue
        assert np.array_equal(wr[k], ws[k]), \
            "%s: the resumed trajectory diverged from the uninterrupted" % k
    # the resumed epochs' losses are the uninterrupted run's last eight
    np.testing.assert_array_equal(ws["losses"], wr["losses"][STEPS:])
    epoch = ckpt.latest_manifest_epoch(str(tmp_path / "sup"))
    assert epoch == EPOCHS - 1
    assert ckpt.load_manifest(str(tmp_path / "sup"), epoch)["processes"] == 2
    want = _jax_run(dict(np.load(ref_out + ".init.npz")))
    for k, v in want.items():
        np.testing.assert_allclose(wr[k], v, **STEP_TOL)


_HB_WORKER = r'''
import os, sys, time
_rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
if _rank == 1:
    # wedge the heartbeat writer for good: the process keeps running, the
    # beat stops, rank 0 must detect it within MXNET_HB_TIMEOUT_MS
    os.environ["MXNET_FAULT_PLAN"] = "proc_hb:step=1:stall:count=inf"
    os.environ["MXNET_FAULT_HANG_SECONDS"] = "600"
import mxnet_tpu_torch as mx
kv = mx.kv.create("dist_sync")
print("HB_WORKER_UP", kv.rank, time.time(), flush=True)
time.sleep(120)   # rank 0's monitor must end the job long before this
print("HB_WORKER_SLEPT_THROUGH", kv.rank, flush=True)
sys.exit(0)
'''


def test_heartbeat_detects_a_wedged_host(tmp_path):
    from mxnet_tpu_torch.parallel.multihost import HOST_LOST_EXIT
    worker = tmp_path / "hb_worker.py"
    worker.write_text(_HB_WORKER)
    hb_dir = tmp_path / "hb"
    hb_dir.mkdir()
    t0 = time.monotonic()
    r = _launch(["-n", "2", sys.executable, str(worker)],
                _env(MXNET_HB_DIR=hb_dir, MXNET_HB_TIMEOUT_MS=1500,
                     MXNET_LAUNCH_GRACE=2), timeout=150)
    elapsed = time.monotonic() - t0
    text = (r.stdout + r.stderr).decode()
    assert r.returncode == HOST_LOST_EXIT, (r.returncode, text[-3000:])
    assert "HB_WORKER_SLEPT_THROUGH" not in text
    assert "HostLostError" in text and "rank 1 heartbeat" in text, \
        text[-3000:]
    assert elapsed < 100, elapsed
