"""Training through the port's kvstore, on the CPU, at small size.

- BASELINE config 1's MLP (``examples/train_mnist_module.py``) through
  ``Module.fit(kvstore='dist_sync')`` on two gloo ranks x 8 samples,
  held to the JAX package's one-process ``Module.fit`` at batch 16 on
  the same numpy data and initial weights (ROADMAP rule 5's tolerance:
  the ranks' gradient is two sums of 8, JAX's one sum of 16).
- ``examples/train_gluon_cnn.py``'s ``build_net`` in fp32 through
  ``Trainer(kvstore='dist_sync')`` for 3 steps: both ranks end
  bit-identical, and equal, bit for bit, to the two-replica twin (one
  process, two replicas from the same weights, each fed its rank's
  half, the gradients summed in rank order, one update).
- ``Module`` over ``[cpu(0), cpu(1)]`` with ``kvstore='local'``, held to
  ``tests/test_module.py``'s ``test_module_kvstore_local_update`` on the
  JAX package's two-device CPU mesh.

The ranks and the twin run torch on one thread, so the CPU kernels sum
in one order in every process."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120
TOL = dict(rtol=1e-5, atol=1e-6)
RANK_BATCH = 8
MLP_BATCHES = 4
CNN_BATCH = 4
CNN_STEPS = 3
CNN_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
MLP_SGD = {"learning_rate": 0.1, "momentum": 0.9}

_WORKER = textwrap.dedent(r'''
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.parallel import distributed


    def part(name):
        return {k[len(name) + 1:]: v for k, v in data.items()
                if k.startswith(name + "/")}


    def mlp(d):
        """Config 1's MLP through Module.fit on a dist_sync store."""
        sym = mx.sym.var("data")
        for i, width in enumerate((128, 64, 10)):
            sym = mx.sym.FullyConnected(sym, num_hidden=width,
                                        name="fc%d" % (i + 1))
            if width != 10:
                sym = mx.sym.Activation(sym, act_type="relu")
        sym = mx.sym.SoftmaxOutput(sym, name="softmax")
        it = mx.io.NDArrayIter(d["x"][rank], d["y"][rank],
                               batch_size=int(d["batch"]), shuffle=False,
                               label_name="softmax_label")
        mod = mx.mod.Module(sym, context=mx.cpu())
        init = {k[5:]: mx.nd.array(v) for k, v in d.items()
                if k.startswith("init/")}
        mod.fit(it, arg_params=init, aux_params={}, optimizer="sgd",
                optimizer_params={"learning_rate": float(d["lr"]),
                                  "momentum": 0.9},
                kvstore="dist_sync", num_epoch=1)
        args, _ = mod.get_params()
        res = {"final/" + k: v.asnumpy() for k, v in args.items()}
        res["update_on_kvstore"] = np.array(mod._update_on_kvstore)
        res["rescale"] = np.array(mod._optimizer.rescale_grad)
        return res


    def cnn(d):
        """build_net through Trainer(kvstore='dist_sync'), seeded alike."""
        np.random.seed(7)
        mx.random.seed(7)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(16, kernel_size=3, padding=1,
                                activation="relu"))
        net.add(gluon.nn.MaxPool2D(pool_size=2))
        net.add(gluon.nn.Conv2D(32, kernel_size=3, padding=1,
                                activation="relu"))
        net.add(gluon.nn.GlobalAvgPool2D())
        net.add(gluon.nn.Dense(10))
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(d["x"][0, rank]))
        params = list(net.collect_params().values())
        res = {"init/%d" % i: p.data().asnumpy()
               for i, p in enumerate(params)}
        net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9,
                                 "wd": 1e-4}, kvstore="dist_sync")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for step in range(d["x"].shape[0]):
            with autograd.record():
                loss = loss_fn(net(mx.nd.array(d["x"][step, rank])),
                               mx.nd.array(d["y"][step, rank]))
            loss.backward()
            trainer.step(2 * d["x"].shape[2])
        res.update(("final/%d" % i, p.data().asnumpy())
                   for i, p in enumerate(params))
        res["backend"] = np.array(trainer._kvstore.stats()["backend"])
        return res


    store, rank, path, out = sys.argv[1:5]
    rank = int(rank)
    distributed.init("file://" + store, 2, rank)
    data = dict(np.load(path))
    res = {}
    for name, fn in (("mlp", mlp), ("cnn", cnn)):
        res.update((name + "/" + k, v) for k, v in fn(part(name)).items())
    np.savez(out, **res)
    print("RANK_OK %d" % rank, flush=True)
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks over a file store, the MLP fit then the CNN steps in one
    process group; each rank's saved arrays, by part."""
    tmp_path = tmp_path_factory.mktemp("ranks")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    x, y, init = _mlp_data()
    data = {"mlp/" + k: v for k, v in _mlp_rank_data(x, y, init).items()}
    cx, cy = _cnn_data()
    data.update({"cnn/x": cx, "cnn/y": cy})
    np.savez(str(tmp_path / "data.npz"), **data)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               MXNET_DEFAULT_CONTEXT="cpu", MXNET_DATA_PIPELINE="0",
               MXNET_KVSTORE_TIMEOUT="60")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), str(rank),
         str(tmp_path / "data.npz"), str(tmp_path / ("rank%d.npz" % rank))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (rank,
                                                           out[-3000:])
    saved = [dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
             for r in range(2)]
    return {part: [{k[len(part) + 1:]: v for k, v in r.items()
                    if k.startswith(part + "/")} for r in saved]
            for part in ("mlp", "cnn")}


def _mlp_data():
    """Synthetic MNIST-shaped data (examples/train_mnist_module.py's
    generator) and Xavier-like initial weights, from numpy seeds."""
    rng = np.random.RandomState(0)
    n = 2 * RANK_BATCH * MLP_BATCHES
    protos = rng.normal(0, 2.5, (10, 784)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    x = ((protos[y.astype(int)] + rng.normal(0, 1.0, (n, 784)))
         / 3.0).astype(np.float32)
    init = {}
    for name, (fan_in, width) in (("fc1", (784, 128)), ("fc2", (128, 64)),
                                  ("fc3", (64, 10))):
        bound = np.sqrt(6.0 / (fan_in + width))
        init[name + "_weight"] = rng.uniform(
            -bound, bound, (width, fan_in)).astype(np.float32)
        init[name + "_bias"] = np.zeros(width, np.float32)
    return x, y, init


def _mlp_rank_data(x, y, init):
    """Rank r takes the r-th half of every global batch of 16."""
    halves = x.reshape(MLP_BATCHES, 2, RANK_BATCH, 784)
    yhalves = y.reshape(MLP_BATCHES, 2, RANK_BATCH)
    data = {"x": halves.transpose(1, 0, 2, 3).reshape(2, -1, 784),
            "y": yhalves.transpose(1, 0, 2).reshape(2, -1),
            "batch": np.array(RANK_BATCH),
            "lr": np.array(MLP_SGD["learning_rate"])}
    data.update(("init/" + k, v) for k, v in init.items())
    return data


def _jax_mlp():
    data = jmx.sym.var("data")
    h = jmx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    h = jmx.sym.Activation(h, act_type="relu")
    h = jmx.sym.FullyConnected(h, num_hidden=64, name="fc2")
    h = jmx.sym.Activation(h, act_type="relu")
    h = jmx.sym.FullyConnected(h, num_hidden=10, name="fc3")
    return jmx.sym.SoftmaxOutput(h, name="softmax")


def test_mlp_module_fit_over_two_ranks_equals_jax_at_the_summed_batch(
        ranks, monkeypatch):
    x, y, init = _mlp_data()
    ranks = ranks["mlp"]
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    it = jmx.io.NDArrayIter(x, y, batch_size=2 * RANK_BATCH, shuffle=False,
                            label_name="softmax_label")
    mod = jmx.mod.Module(_jax_mlp(), context=jmx.cpu())
    mod.fit(it, arg_params={k: jmx.nd.array(v) for k, v in init.items()},
            aux_params={}, optimizer="sgd", optimizer_params=MLP_SGD,
            num_epoch=1)
    want, _ = mod.get_params()
    for r in ranks:
        assert bool(r["update_on_kvstore"])
        assert float(r["rescale"]) == 1.0 / (2 * RANK_BATCH)
    for name, w in want.items():
        np.testing.assert_array_equal(ranks[0]["final/" + name],
                                      ranks[1]["final/" + name])
        np.testing.assert_allclose(ranks[0]["final/" + name], w.asnumpy(),
                                   **TOL)
        assert not np.allclose(ranks[0]["final/" + name], init[name])


def _cnn(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(16, kernel_size=3, padding=1,
                               activation="relu"))
    net.add(mx.gluon.nn.MaxPool2D(pool_size=2))
    net.add(mx.gluon.nn.Conv2D(32, kernel_size=3, padding=1,
                               activation="relu"))
    net.add(mx.gluon.nn.GlobalAvgPool2D())
    net.add(mx.gluon.nn.Dense(10))
    return net


def _synthetic_cifar(n, rng):
    """examples/train_gluon_cnn.py's synthetic_cifar."""
    protos = rng.normal(0, 1.5, (10, 3, 1, 1)).astype(np.float32)
    y = rng.randint(0, 10, n)
    x = protos[y] + rng.normal(0, 0.8, (n, 3, 32, 32)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def _twin(x, y, init):
    """Two replicas in one process from ``init``, each fed its rank's
    half; the gradients summed in rank order; one update, copied to the
    second replica. Returns the first replica's final parameters."""
    nets = [_cnn(tmx), _cnn(tmx)]
    for net in nets:
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        net(tmx.nd.array(x[0, 0]))
        for p, v in zip(net.collect_params().values(), init):
            p.set_data(tmx.nd.array(v))
        net.hybridize()
    params = [list(net.collect_params().values()) for net in nets]
    trainer = tmx.gluon.Trainer(nets[0].collect_params(), "sgd",
                                dict(CNN_SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for step in range(x.shape[0]):
        for rank, net in enumerate(nets):
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(x[step, rank])),
                               tmx.nd.array(y[step, rank]))
            loss.backward()
        with torch.no_grad():
            for pa, pb in zip(*params):
                pa.grad()._data.add_(pb.grad()._data)
        trainer.step(2 * CNN_BATCH)
        for pa, pb in zip(*params):
            pb.set_data(pa.data())
    return [p.data().asnumpy() for p in params[0]]


def _cnn_data():
    x, y = _synthetic_cifar(CNN_STEPS * 2 * CNN_BATCH,
                            np.random.RandomState(0))
    return (x.reshape(CNN_STEPS, 2, CNN_BATCH, 3, 32, 32),
            y.reshape(CNN_STEPS, 2, CNN_BATCH))


def test_gluon_cnn_trainer_over_two_ranks_equals_the_twin(ranks,
                                                          monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    x, y = _cnn_data()
    ranks = ranks["cnn"]
    n = len([k for k in ranks[0] if k.startswith("final/")])
    assert n == 6 and str(ranks[0]["backend"]) == "gloo"
    for i in range(n):
        # seeded alike, the ranks start equal and stay bit-identical
        np.testing.assert_array_equal(ranks[0]["init/%d" % i],
                                      ranks[1]["init/%d" % i])
        np.testing.assert_array_equal(ranks[0]["final/%d" % i],
                                      ranks[1]["final/%d" % i])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        twin = _twin(x, y, [ranks[0]["init/%d" % i] for i in range(n)])
    finally:
        torch.set_num_threads(threads)
    for i, w in enumerate(twin):
        np.testing.assert_array_equal(ranks[0]["final/%d" % i], w)
        assert not np.array_equal(w, ranks[0]["init/%d" % i])


def _mlp_sym(mx):
    """tests/test_module.py's ``_mlp_sym``."""
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"),
                                name="softmax")


def test_module_over_two_contexts_with_a_local_store_matches_jax(
        monkeypatch):
    """tests/test_module.py:136-146 through both packages from the same
    initial weights: JAX binds a two-device mesh, the port one executor
    (both contexts are the host); both create a ``local`` store that
    updates on the store."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    rng = np.random.RandomState(0)
    centers = rng.normal(0, 1.5, (10, 64))
    y = rng.randint(0, 10, 128)
    x = (centers[y] + rng.normal(0, 0.5, (128, 64))).astype(np.float32)
    y = y.astype(np.float32)
    init = {"fc1_weight": rng.uniform(-0.2, 0.2, (64, 64)),
            "fc1_bias": np.zeros(64), "fc2_weight":
            rng.uniform(-0.2, 0.2, (10, 64)), "fc2_bias": np.zeros(10)}
    results = []
    for mx in (tmx, jmx):
        it = mx.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        mod = mx.mod.Module(_mlp_sym(mx), context=[mx.cpu(0), mx.cpu(1)])
        mod.fit(it, arg_params={k: mx.nd.array(v.astype(np.float32))
                                for k, v in init.items()},
                aux_params={}, optimizer="sgd",
                optimizer_params={"learning_rate": 0.3}, num_epoch=3,
                kvstore="local")
        assert mod._kvstore.type == "local" and mod._update_on_kvstore
        assert mod.score(it, "acc")[0][1] > 0.5
        args, _ = mod.get_params()
        results.append({k: v.asnumpy() for k, v in args.items()})
    assert len(tmx.gluon.utils.split_and_load(
        x, [tmx.cpu(0), tmx.cpu(1)])) == 1
    for name, want in results[1].items():
        np.testing.assert_allclose(results[0][name], want, **TOL)
