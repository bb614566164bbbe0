"""The port's dist kvstore across processes, on the CPU: two gloo ranks
run the dense assertions of ``tests/test_dist_kvstore.py`` (34-67), a
barrier, a planned push fault retried to the same bytes and an endless
one that raises ``CollectiveTimeoutError``, and the row_sparse cases
(69-104: a push reduced by row union, never densified, and
``row_sparse_pull``); first spawned directly over
a ``FileStore`` (no TCP port to race for under xdist), then through
``tools.launch``'s DMLC_* contract (``tests/test_launch.py``), with the
launcher's CLI cases; and ``tools.bandwidth.measure``
(``tests/test_tools_band.py``). The worker imports only the port."""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120

_WORKER = textwrap.dedent(r'''
    import logging
    import os
    import sys

    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault
    from mxnet_tpu_torch.parallel import distributed

    if len(sys.argv) > 1:          # spawned directly: a file store
        distributed.init("file://" + sys.argv[1], int(sys.argv[2]),
                         int(sys.argv[3]))
    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    want_nw = int(sys.argv[2]) if len(sys.argv) > 1 \
        else int(os.environ["DMLC_NUM_WORKER"])
    assert nw == want_nw, (nw, want_nw)
    assert kv.stats()["backend"] == "gloo", kv.stats()
    shape = (3, 3)
    big_shape = (50, 4)

    kv.init(3, mx.nd.ones(shape))
    kv.init(99, mx.nd.ones(big_shape))

    # one push per worker of (rank+1)*ones: the pull sees the global sum
    kv.push(3, mx.nd.ones(shape) * (rank + 1))
    out = mx.nd.zeros(shape)
    kv.pull(3, out=out)
    want = sum(r + 1 for r in range(nw))
    assert np.allclose(out.asnumpy(), want), (out.asnumpy(), want)

    # repeated pushes keep reducing fresh values
    for it in range(3):
        kv.push(99, mx.nd.ones(big_shape) * (it + rank))
        out = mx.nd.zeros(big_shape)
        kv.pull(99, out=out)
        want = sum(it + r for r in range(nw))
        assert np.allclose(out.asnumpy(), want), (it, out.asnumpy(), want)

    # rank-dependent values: every worker agrees on the reduced result
    kv.init(7, mx.nd.zeros(shape))
    val = np.arange(9, dtype=np.float32).reshape(shape) * (rank + 1)
    kv.push(7, mx.nd.array(val))
    out = mx.nd.zeros(shape)
    kv.pull(7, out=out)
    want = np.arange(9, dtype=np.float32).reshape(shape) * \
        sum(r + 1 for r in range(nw))
    assert np.allclose(out.asnumpy(), want)
    kv.barrier()

    # a planned push fault on every rank is retried to the same bytes
    x = np.random.RandomState(rank).randn(5, 7).astype(np.float32)
    kv.init(11, mx.nd.zeros((5, 7)))
    kv.push(11, mx.nd.array(x))
    base = mx.nd.zeros((5, 7))
    kv.pull(11, out=base)
    fault.set_plan("push:step=1:raise")
    kv.push(11, mx.nd.array(x))
    again = mx.nd.zeros((5, 7))
    kv.pull(11, out=again)
    stats = fault.stats()
    assert stats["injected"]["push"] == 1 and stats["retries"] >= 1, stats
    assert (again.asnumpy() == base.asnumpy()).all()
    # an endless one raises after the deadline, before any collective
    # (the group's own timeout was fixed at the join)
    os.environ["MXNET_KVSTORE_TIMEOUT"] = "0.3"
    fault.reset()
    fault.set_plan("push:step=1:raise:count=inf")
    try:
        kv.push(11, mx.nd.array(x))
    except mx.CollectiveTimeoutError:
        pass
    else:
        raise AssertionError("an endless push fault did not raise")
    fault.set_plan(None)
    kv.barrier()
    print("WORKER_OK %d" % rank, flush=True)
''')


# tests/test_dist_kvstore.py:69-104 on the port: a row_sparse push
# reduced by row union across the ranks, never densified, and
# row_sparse_pull of the reduced value; each rank saves what it holds
_RSP_WORKER = textwrap.dedent(r'''
    import sys

    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    from mxnet_tpu_torch.parallel import distributed

    distributed.init("file://" + sys.argv[1], int(sys.argv[2]),
                     int(sys.argv[3]))
    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    rsp_shape = (20, 3)
    kv.init(11, mx.nd.zeros(rsp_shape))
    rows = np.array([1 + rank, 5, 12 + rank], dtype=np.int64)  # overlap @5
    vals = np.random.RandomState(rank).randn(3, 3).astype(np.float32)
    rsp = RowSparseNDArray(mx.nd.array(vals), mx.nd.array(rows), rsp_shape)

    orig_tostype = RowSparseNDArray.tostype

    def _no_densify(self, stype):
        raise AssertionError("rsp cross-worker push densified")
    RowSparseNDArray.tostype = _no_densify
    kv.push(11, rsp)
    RowSparseNDArray.tostype = orig_tostype

    stored = kv._data[11]
    assert stored.stype == "row_sparse", stored
    assert stored.indices.asnumpy().tolist() == sorted(
        {1 + r for r in range(nw)} | {5} | {12 + r for r in range(nw)})
    out = RowSparseNDArray(mx.nd.zeros((0, 3)),
                           mx.nd.array(np.zeros((0,), np.int64)), rsp_shape)
    kv.row_sparse_pull(11, out=out, row_ids=mx.nd.array(
        np.array([12, 5, 12], np.int64)))
    assert out.stype == "row_sparse"
    assert out.indices.asnumpy().tolist() == [5, 12]
    np.savez(sys.argv[4] + str(rank), indices=stored.indices.asnumpy(),
             data=stored.data.asnumpy(), pulled=out.data.asnumpy())
    kv.barrier()
    print("WORKER_OK %d" % rank, flush=True)
''')


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               MXNET_DEFAULT_CONTEXT="cpu", MXNET_KVSTORE_TIMEOUT="20",
               MXNET_KVSTORE_RETRY_BACKOFF="0.01",
               MXNET_KVSTORE_RETRY_MAX_BACKOFF="0.04")
    return env


def _wait(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_gloo_ranks_over_a_file_store(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(store), "2", str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_env(tmp_path), cwd=str(tmp_path)) for rank in range(2)]
    outs = _wait(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (rank,
                                                          out[-3000:])
        assert "WORKER_OK %d" % rank in out


def test_two_gloo_ranks_reduce_a_row_sparse_push_by_row_union(tmp_path):
    """Each rank pushes rows {1 + r, 5, 12 + r} of its own values: the
    stored union and its values equal the one-process sum, bit for bit
    on both ranks, and the pull gathers rows 5 and 12 of it."""
    import numpy as np
    script = tmp_path / "rsp_worker.py"
    script.write_text(_RSP_WORKER)
    store, saved = tmp_path / "store", str(tmp_path / "rank")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(store), "2", str(rank), saved],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_env(tmp_path), cwd=str(tmp_path)) for rank in range(2)]
    outs = _wait(procs)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (rank,
                                                          out[-3000:])
        assert "WORKER_OK %d" % rank in out
    want = np.zeros((20, 3), np.float32)
    for rank in range(2):
        vals = np.random.RandomState(rank).randn(3, 3).astype(np.float32)
        want[[1 + rank, 5, 12 + rank]] += vals
    got = [dict(np.load(saved + "%d.npz" % r)) for r in range(2)]
    for key in ("indices", "data", "pulled"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
    assert got[0]["indices"].tolist() == [1, 2, 5, 12, 13]
    assert got[0]["indices"].dtype == np.int32
    np.testing.assert_array_equal(got[0]["data"], want[[1, 2, 5, 12, 13]])
    np.testing.assert_array_equal(got[0]["pulled"], want[[5, 12]])


def test_launch_local_runs_the_dist_kvstore(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           "2", "-s", "1", "--env", "MXNET_FAULT_HANG_SECONDS:0.02",
           sys.executable, str(script)]
    out = subprocess.run(cmd, env=_env(tmp_path), cwd=ROOT,
                         capture_output=True, timeout=RANK_TIMEOUT)
    text = out.stdout.decode() + out.stderr.decode()
    assert out.returncode == 0, text[-3000:]
    assert "WORKER_OK 0" in text and "WORKER_OK 1" in text


def test_launch_cli_validation(monkeypatch):
    from mxnet_tpu_torch.tools import launch
    monkeypatch.setenv("MXNET_LAUNCH_GRACE", "0.5")
    for launcher in ("ssh", "mpi", "sge", "yarn"):
        with pytest.raises(NotImplementedError, match="local launcher"):
            launch.main(["-n", "2", "--launcher", launcher, "echo", "hi"])
    assert launch.main(["-n", "2", "--supervise", "--max-restarts", "0",
                        sys.executable, "-c", "print('ok')"]) == 0
    assert launch.main(["-n", "1", "-s", "2", sys.executable, "-c",
                        "print('ok')"]) == 0
    # the first failing worker's exit code propagates verbatim
    assert launch.main(["-n", "1", sys.executable, "-c",
                        "import sys; sys.exit(3)"]) == 3
    # ... and the survivors are torn down: rank 0 would sleep 60 s
    code = ("import os, sys, time\n"
            "if os.environ['DMLC_WORKER_ID'] == '0':\n"
            "    time.sleep(60)\n"
            "sys.exit(7)\n")
    assert launch.main(["-n", "2", sys.executable, "-c", code]) == 7
    assert launch._exit_code(-9) == 137 and launch._exit_code(None) == 1


def test_spawned_workers_carry_the_dmlc_contract(tmp_path, monkeypatch):
    import json
    from mxnet_tpu_torch.tools import launch
    code = ("import json, os, sys\n"
            "env = {k: v for k, v in os.environ.items()\n"
            "       if k.startswith('DMLC_')}\n"
            "json.dump(env, open(sys.argv[1] + env['DMLC_WORKER_ID'], 'w'))\n")
    procs, port = launch._spawn_workers(
        2, [sys.executable, "-c", code, str(tmp_path / "c")])
    for p in procs:
        assert p.wait(timeout=RANK_TIMEOUT) == 0
    for rank in range(2):
        env = json.load(open(str(tmp_path / "c") + str(rank)))
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert launch.worker_contract() == {
            "rank": rank, "world": 2, "uri": "127.0.0.1", "port": port}
    monkeypatch.delenv("DMLC_ROLE")
    assert launch.worker_contract() is None


def test_bandwidth_measure_runs_and_checks(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    from mxnet_tpu_torch.tools.bandwidth import measure
    shapes = [(8, 4), (16,), (3, 3, 2)]
    rows = measure(shapes, num_workers=2, num_batches=2)
    assert len(rows) == 2
    for r in rows:
        assert r["error"] == 0
        assert r["bandwidth_gbps"] > 0
    rows = measure(shapes, kv_type="device", num_workers=3, num_batches=1,
                   optimizer="sgd", gc_type="2bit")
    assert rows[0]["error"] == 0
