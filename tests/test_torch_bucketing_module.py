"""Port parity: ``BucketingModule`` against ``mxnet_tpu``, on the CPU.

A 2-layer LSTM language model (vocabulary 32, hidden 24, ladder
[4, 8, 12], batch 8) starts from the JAX package's ``arg_params`` (set
by name: the cells keep the reference's parameter names) and reads the
same ``BucketSentenceIter`` batches in the same order (one numpy seed).
After a few SGD or Adam steps across buckets every weight is within
``STEP_TOL`` of JAX's: fp32 products and gate arithmetic in another
summation order, compounded through T steps, two layers and six
updates (Adam's first steps divide by small second moments, hence the
looser ``ADAM_TOL``). The fused step runs through a stand-in capture
(``cached_op._Graphs("cpu", capture=...)``) and must capture once per
bucket seen and never again in a second epoch: the port's form of
``tests/test_bucketing.py::test_bucketed_fit_compiles_ladder_size_
programs``. The ``bucketing`` telemetry records equal JAX's, and both
diagnose tools print the same Bucketing table from the port's sink.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_op as tco
from mxnet_tpu_torch import fused_step, profiler

STEP_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_TOL = dict(rtol=1e-3, atol=1e-5)
V, E, H, B = 32, 16, 24, 8
LADDER = [4, 8, 12]


def _standin(body, device, pool):
    """A CUDA capture's contract on the CPU: one call now, its output
    buffers kept, each replay writes the body's result into them."""
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")
    fused_step.set_graph_factory(
        lambda: tco._Graphs("cpu", capture=_standin))
    yield
    fused_step.set_graph_factory(None)


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _corpus(n=72, seed=7, lo=3, hi=13):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, V, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _lstm_sym_gen(mx, fused=False):
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        if fused:
            stack = mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                        prefix="lstm_")
        else:
            stack = mx.rnn.SequentialRNNCell()
            for i in range(2):
                stack.add(mx.rnn.LSTMCell(H, prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, embed, layout="NTC",
                                  merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, H))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label_f = mx.sym.Reshape(label, shape=(-1,))
        out = mx.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                   use_ignore=True, ignore_label=0)
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _emb_sym_gen(mx, V=20, E=8):
    """tests/test_bucketing.py's ``_lm_sym_gen``: Embedding -> FC."""
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=V, output_dim=E,
                               name="embed")
        pred = mx.sym.Reshape(emb, shape=(-1, E))
        pred = mx.sym.FullyConnected(pred, num_hidden=V, name="pred")
        out = mx.sym.SoftmaxOutput(pred, mx.sym.Reshape(label, shape=(-1,)),
                                   name="softmax", use_ignore=True,
                                   ignore_label=0, normalization="valid")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _bound(mx, sym_gen, it, arg_params=None):
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if arg_params is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in arg_params.items()},
                        aux_params={})
    return mod


def _train(mx, mod, sents, optimizer, params, n_batches, seed=11):
    mod.init_optimizer(optimizer=optimizer, optimizer_params=params)
    np.random.seed(seed)
    it = mx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                   invalid_label=0)
    keys = []
    for batch in it:
        if len(keys) == n_batches:
            break
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        keys.append(batch.bucket_key)
    return keys, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("optimizer, params, tol", [
    ("sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5},
     STEP_TOL),
    ("adam", {"learning_rate": 0.01}, ADAM_TOL)], ids=["sgd", "adam"])
def test_steps_across_buckets_match_jax(monkeypatch, optimizer, params,
                                        tol, fused):
    monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
    sents = _corpus()
    np.random.seed(11)
    jit = jmx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                     invalid_label=0)
    jmod = _bound(jmx, _lstm_sym_gen(jmx), jit)
    start = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tmod = _bound(tmx, _lstm_sym_gen(tmx), jit, arg_params=start)
    jkeys, want = _train(jmx, jmod, sents, optimizer, params, 6)
    before = profiler.counters().get("fused_step_fallbacks", 0)
    tkeys, got = _train(tmx, tmod, sents, optimizer, params, 6)
    assert tkeys == jkeys and len(set(tkeys)) == len(LADDER)
    assert sorted(got) == sorted(want)
    for name in want:
        assert not np.array_equal(want[name], start[name]), name
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)
    stats = tmod.stats()
    assert list(stats) == ["bucketing:%d" % k for k in LADDER]
    for key, st in stats.items():
        n = tkeys.count(int(key.split(":")[1]))
        assert st["fused"]["dispatches"] == (n if fused else 0), key
        assert st["fused"]["captures"] == (1 if fused else 0), key
        assert st["fused"]["recaptures"] == 0
    assert profiler.counters().get("fused_step_fallbacks", 0) == before


def test_fused_rnn_cell_variant_matches_jax():
    """The FusedRNNCell variant (one RNN op, ``lstm_parameters``) through
    BucketingModule: the same steps as JAX's within STEP_TOL."""
    sents = _corpus(seed=3)
    np.random.seed(11)
    jit = jmx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                     invalid_label=0)
    jmod = jmx.mod.BucketingModule(_lstm_sym_gen(jmx, fused=True),
                                   default_bucket_key=12,
                                   context=jmx.cpu())
    jmod.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    from mxnet_tpu_torch.ops.rnn_op import param_size
    flat = np.random.RandomState(2).uniform(
        -0.1, 0.1, param_size("lstm", 2, False, E, H)).astype(np.float32)
    jmod.init_params(jmx.init.Xavier(),
                     arg_params={"lstm_parameters": jmx.nd.array(flat)},
                     allow_missing=True)
    start = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    assert "lstm_parameters" in start
    tmod = _bound(tmx, _lstm_sym_gen(tmx, fused=True), jit,
                  arg_params=start)
    sgd = {"learning_rate": 0.5}
    jkeys, want = _train(jmx, jmod, sents, "sgd", sgd, 5)
    tkeys, got = _train(tmx, tmod, sents, "sgd", sgd, 5)
    assert tkeys == jkeys
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **STEP_TOL)
    assert all(st["fused"]["captures"] == 1
               for st in tmod.stats().values()
               if st["fused"]["dispatches"])


def _fit(mod, it, epochs=1):
    mod.fit(it, num_epoch=epochs,
            eval_metric=tmx.metric.Perplexity(ignore_label=0),
            optimizer="sgd", optimizer_params={"learning_rate": 0.05})


@pytest.mark.parametrize("pipeline", ["0", "1"], ids=["direct", "pipeline"])
def test_bucketed_fit_captures_ladder_size_graphs(monkeypatch, pipeline):
    """~40 distinct lengths through a bucketed ``Module.fit``: one fused
    capture per bucket, and a second epoch captures nothing new."""
    monkeypatch.setenv("MXNET_DATA_PIPELINE", pipeline)
    rng = np.random.RandomState(7)
    sents = [list(rng.randint(1, 20, size=L))
             for L in rng.choice(np.arange(3, 43), size=160)]
    assert len({len(s) for s in sents}) >= 38
    ladder = [11, 22, 32, 42]
    it = tmx.rnn.BucketSentenceIter(sents, batch_size=8, buckets=ladder,
                                    invalid_label=0)
    mod = tmx.mod.BucketingModule(_emb_sym_gen(tmx),
                                  default_bucket_key=it.default_bucket_key)
    _fit(mod, it)
    warm = mod.stats()
    assert list(warm) == ["bucketing:%d" % k for k in ladder]
    assert all(st["fused"]["captures"] == 1 for st in warm.values()), warm
    _fit(mod, it)
    steady = mod.stats()
    for key in warm:
        assert steady[key]["fused"]["captures"] == 1, steady
        assert steady[key]["fused"]["recaptures"] == 0
        assert steady[key]["fused"]["replays"] > \
            warm[key]["fused"]["replays"]


def test_sibling_step_does_not_go_stale_on_a_new_bucket_bind():
    """The JAX stale-cache guard (bucketing_module.py:172-179): a bucket
    bound after a SIBLING stepped must seed from the live weights."""
    sents = _corpus()
    np.random.seed(0)
    it = tmx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                    invalid_label=0)
    mod = _bound(tmx, _lstm_sym_gen(tmx), it)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mod.get_params()                  # the donor caches its weights
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    mod.forward(batches[4], is_train=True)
    mod.backward()
    mod.update()
    stepped = {k: v.asnumpy().copy()
               for k, v in mod._buckets[12]._exec.arg_dict.items()
               if k in mod._buckets[12]._param_names}
    mod.prepare(batches[8])           # binds bucket 8, sharing weights
    assert 8 in mod._buckets
    for name, value in stepped.items():
        live = mod._buckets[12]._exec.arg_dict[name].asnumpy()
        assert (live == value).all(), name


def test_optimizer_initialized_on_another_bucket_serves_every_bucket():
    """init_optimizer while a non-default bucket is current: every bound
    bucket and each one bound later steps with that one optimizer state
    (the reference's borrow_optimizer)."""
    sents = _corpus()
    np.random.seed(0)
    it = tmx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                    invalid_label=0)
    mod = _bound(tmx, _emb_sym_gen(tmx, V, E), it)
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    mod.forward(batches[4], is_train=False)         # bucket 4 is current
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    for key in (12, 8, 4):
        mod.forward(batches[key], is_train=True)
        mod.backward()
        mod.update()
    updaters = {id(m._updater) for m in mod._buckets.values()}
    assert len(updaters) == 1 and None not in updaters
    assert all(m.optimizer_initialized for m in mod._buckets.values())
    assert all(st["fused"]["dispatches"] == 1
               for st in mod.stats().values())


def test_padded_step_equals_tight_step():
    """tests/test_bucketing.py::TestModulePathIdentity in the port: one
    fused step on a padded bucket (8 rows x len 8, ignore-labelled pads)
    against the tight batch (3 x 5). The embedding's update is exact
    (padded positions scatter exact zeros); the FC weight and bias
    agree within 1e-7 (their reductions run over more, zero, terms)."""
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    Vs, Es = 12, 6
    rng = np.random.RandomState(0)
    init = {"embed_weight": rng.randn(Vs, Es).astype(np.float32) * 0.1,
            "pred_weight": rng.randn(Vs, Es).astype(np.float32) * 0.1,
            "pred_bias": np.zeros((Vs,), np.float32)}

    def one_step(rows, L, data, label):
        mod = tmx.mod.BucketingModule(_emb_sym_gen(tmx, Vs, Es),
                                      default_bucket_key=L)
        mod.bind(data_shapes=[DataDesc("data", (rows, L))],
                 label_shapes=[DataDesc("softmax_label", (rows, L))])
        mod.init_params(arg_params={k: tmx.nd.array(v)
                                    for k, v in init.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "rescale_grad": 1.0})
        batch = DataBatch([tmx.nd.array(data)], [tmx.nd.array(label)],
                          bucket_key=L,
                          provide_data=[DataDesc("data", (rows, L))],
                          provide_label=[DataDesc("softmax_label",
                                                  (rows, L))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        assert mod.stats()["bucketing:%d" % L]["fused"]["dispatches"] == 1
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    sents = [rng.randint(1, Vs, size=L) for L in (3, 5, 4)]
    tight_d = np.zeros((3, 5), np.float32)
    tight_l = np.zeros((3, 5), np.float32)
    for i, s in enumerate(sents):
        tight_d[i, :len(s)] = s
        tight_l[i, :len(s) - 1] = s[1:]
    pad_d = np.zeros((8, 8), np.float32)
    pad_l = np.zeros((8, 8), np.float32)
    pad_d[:3, :5] = tight_d
    pad_l[:3, :5] = tight_l
    tight = one_step(3, 5, tight_d, tight_l)
    padded = one_step(8, 8, pad_d, pad_l)
    assert (tight["embed_weight"] == padded["embed_weight"]).all()
    for name in ("pred_weight", "pred_bias"):
        np.testing.assert_allclose(tight[name], padded[name], rtol=0,
                                   atol=1e-7)


def test_predict_slices_scaled_pad_rows_for_lm_outputs():
    rng = np.random.RandomState(3)
    sents = [list(rng.randint(1, 9, size=5)) for _ in range(6)]
    it = tmx.rnn.BucketSentenceIter(sents, batch_size=4, buckets=[6],
                                    invalid_label=0)
    mod = tmx.mod.BucketingModule(_emb_sym_gen(tmx, 9, 4),
                                  default_bucket_key=6)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(tmx.init.Xavier())
    assert mod.predict(it).shape[0] == 6 * 6
    assert mod.stats()["bucketing:6"]["predict"]["replays"] == 0  # cpu


def test_lstm_lm_fit_perplexity_falls():
    """BucketingModule.fit on the LSTM LM (the fused step through the
    stand-in capture): perplexity falls from epoch 1 to 3."""
    sents = _corpus(n=96, seed=5)
    np.random.seed(0)
    it = tmx.rnn.BucketSentenceIter(sents, batch_size=B, buckets=LADDER,
                                    invalid_label=0)
    mod = tmx.mod.BucketingModule(_lstm_sym_gen(tmx),
                                  default_bucket_key=it.default_bucket_key)
    seen = []

    def on_epoch(epoch, sym, arg, aux):
        seen.append(ppl.get()[1])
    ppl = tmx.metric.Perplexity(ignore_label=0)
    mod.fit(it, num_epoch=3, eval_metric=ppl, optimizer="adam",
            optimizer_params={"learning_rate": 0.01},
            initializer=tmx.init.Xavier(), epoch_end_callback=on_epoch)
    assert len(seen) == 3 and seen[2] < seen[0], seen
    assert all(st["fused"]["captures"] == 1 for st in mod.stats().values())


# ---------------------------------------------------------------------------
# telemetry and diagnose
# ---------------------------------------------------------------------------

def _stable(rec):
    return {k: v for k, v in rec.items() if k != "t"}


def _bucketing_run(pkg, tmp_path):
    mx = jmx if pkg == "jax" else tmx
    mx.telemetry.reset()
    sink = str(tmp_path / ("%s.jsonl" % pkg))
    mx.telemetry.start(filename=sink, run_id="xpkg")
    rng = np.random.RandomState(3)
    samples = [(rng.randint(1, 10, size=L).astype(np.float32),
                np.float32(0)) for L in rng.choice([3, 5, 7, 30], size=24)]
    pipe = mx.bucketing.BucketedPipeline(samples, batch_size=4,
                                         ladder=[8, 16], record_every=2)
    for _ in pipe:
        mx.telemetry.step_begin()
        mx.telemetry.step_end(samples=4)
    pipe.stats.emit()
    np.random.seed(1)
    it = mx.rnn.BucketSentenceIter(
        [list(rng.randint(1, 9, size=5)) for _ in range(6)]
        + [list(rng.randint(1, 9, size=50))], batch_size=4, buckets=[6],
        invalid_label=0)
    for _ in it:
        pass
    summary = mx.telemetry.stop()
    mx.telemetry.reset()
    return sink, summary


def test_bucketing_records_and_diagnose_match_jax(tmp_path, capsys):
    import warnings
    from mxnet_tpu.tools import diagnose as jdiagnose
    from mxnet_tpu_torch.tools import diagnose
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsink, jsum = _bucketing_run("jax", tmp_path)
        tsink, tsum = _bucketing_run("port", tmp_path)

    def records(path):
        return [_stable(json.loads(line)) for line in open(path)
                if json.loads(line)["type"] == "bucketing"]
    assert records(tsink) == records(jsink)
    assert tsum["bucketing"] == jsum["bucketing"]
    assert set(tsum["bucketing"]) == {"BucketedPipeline",
                                      "BucketSentenceIter"}
    for fmt in ([], ["--format", "json"]):
        jdiagnose.main([tsink] + fmt)
        want = capsys.readouterr().out
        diagnose.main([tsink] + fmt)
        got = capsys.readouterr().out
        assert got == want
    diagnose.main([tsink])
    out = capsys.readouterr().out
    assert "----------Bucketing----------" in out
    assert "discarded" in out and "padding" in out


def test_unbucketed_run_writes_no_bucketing_record(tmp_path):
    sink = str(tmp_path / "run.jsonl")
    tmx.telemetry.reset()
    tmx.telemetry.start(filename=sink)
    tmx.telemetry.step_begin()
    tmx.telemetry.step_end(samples=4)
    summary = tmx.telemetry.stop()
    tmx.telemetry.reset()
    assert "bucketing" not in summary
    assert all(json.loads(line)["type"] != "bucketing"
               for line in open(sink))
