"""Port parity: the bucketing package (ladders, padding, mask-aware
losses and metrics, ``BucketedPipeline``, ``BucketSentenceIter`` and
packing) against ``mxnet_tpu``, on the CPU.

Everything that is numpy on both sides — ladders, padding, packing
planes, the pipelines' batches and their order, the metrics, the
telemetry snapshots — must be BIT-identical to the JAX package's. The
masked losses run in torch against JAX's XLA: their values are held to
``LOSS_TOL`` (a log-softmax in another order), while the port's own
padded == unpadded identities hold bit for bit, as in
``tests/test_bucketing.py``. Packed attention goes through the
registered ``_contrib_flash_attention`` with its segment plane and is
held to a tolerance against a dense masked softmax (the JAX package's
own packed-attention tests are one of its reds, no oracle).
"""
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import bucketing as jb
from mxnet_tpu_torch import bucketing as tb

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert (a == b).all() or (np.isnan(a) == np.isnan(b)).all() and \
        (a[~np.isnan(a)] == b[~np.isnan(b)]).all()


# ---------------------------------------------------------------------------
# ladders
# ---------------------------------------------------------------------------

LADDER_CASES = [
    ("explicit", lambda b: b.ShapeLadder([(4, 8), (4, 16), (8, 16),
                                          (8, 32)]),
     [(3, 7), (5, 9), (8, 32), (9, 4)]),
    ("geometric", lambda b: b.ShapeLadder.geometric((8, 32), (2, 8)),
     [(3, 9), (1, 1), (8, 32)]),
    ("geometric_cap", lambda b: b.ShapeLadder.geometric((8, 64), (2, 8),
                                                        cap=(8, 20)),
     [(3, 9), (8, 20)]),
    ("bucket", lambda b: b.BucketLadder.geometric(64, cap=20),
     [3, 9, 20, 21]),
    ("as_ladder", lambda b: b.as_ladder(np.array([8, 16, 32])),
     [np.int64(3), 16, 33]),
    ("aligned", lambda b: b.BucketLadder([3, 9, 17]).aligned(8), [5, 17]),
]


@pytest.mark.parametrize("name, make, probes", LADDER_CASES,
                         ids=[c[0] for c in LADDER_CASES])
def test_ladder_matches_jax(name, make, probes):
    j, t = make(jb), make(tb)
    assert type(t).__name__ == type(j).__name__
    assert t.shapes == j.shapes and len(t) == len(j)
    assert list(t) == list(j)
    assert t.max_shape == j.max_shape
    for p in probes:
        assert t.bucket_for(p) == j.bucket_for(p)


@pytest.mark.parametrize("bad", [
    lambda b: b.ShapeLadder([]), lambda b: b.ShapeLadder([(0, 4)]),
    lambda b: b.ShapeLadder([(4,), (4, 8)]),
    lambda b: b.ShapeLadder([(4, 8)]).bucket_for((3,)),
    lambda b: b.BucketLadder.geometric(64, cap=0),
    lambda b: b.ShapeLadder.geometric((8, 64), cap=(1, 2, 3))])
def test_ladder_errors_match_jax(bad):
    with pytest.raises(jmx.base.MXNetError):
        bad(jb)
    with pytest.raises(tmx.base.MXNetError):
        bad(tb)


@pytest.mark.parametrize("raw", ["8,16,32", "4x16,8x16,8x32", "nope",
                                 "8,x", "8,4x16", "0x8", "-3", ""])
def test_ladder_from_env_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("MXNET_BUCKET_LADDER", raw)
    try:
        want = jb.ladder_from_env(default=[2, 4])
    except jmx.base.MXNetError as e:
        with pytest.raises(tmx.base.MXNetError,
                           match="MXNET_BUCKET_LADDER"):
            tb.ladder_from_env(default=[2, 4])
        assert "MXNET_BUCKET_LADDER" in str(e)
        return
    got = tb.ladder_from_env(default=[2, 4])
    assert type(got).__name__ == type(want).__name__
    assert got.shapes == want.shapes


def test_site_names_and_sort_keys_match_jax():
    for key in (12, (4, 12), np.int64(7)):
        assert tb.bucket_site(key) == jb.bucket_site(key)
        assert tb.format_bucket(key) == jb.format_bucket(key)
    keys = ["16", "4", "8", "4x8", "2x16"]
    from mxnet_tpu.bucketing.ladder import bucket_sort_key as jkey
    assert sorted(keys, key=tb.bucket_sort_key) == sorted(keys, key=jkey)
    from mxnet_tpu_torch.serving import BucketLadder as ServingLadder
    assert ServingLadder is tb.BucketLadder


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

def test_padding_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    xs = [rng.randn(L, 3).astype(np.float32) for L in (2, 5, 3)]
    for kwargs in (dict(seq_len=8), dict(seq_len=8, pad_value=-1),
                   dict(seq_len=5)):
        want = jb.pad_samples(xs, 4, **kwargs)
        got = tb.pad_samples(xs, 4, **kwargs)
        _same(got[0], want[0])
        _same(got[1], want[1])
        assert got[2] == want[2]
        for a, b in zip(tb.slice_valid(*got), jb.slice_valid(*want)):
            _same(a, b)
    labs = [np.float32(2), np.float32(0)]
    for a, b in zip(tb.pad_samples(labs, 4, pad_value=-1),
                    jb.pad_samples(labs, 4, pad_value=-1)):
        _same(a, b)
    _same(tb.position_mask([2, 4, 0], 5), jb.position_mask([2, 4, 0], 5))
    _same(tb.pad_batch([np.ones(3), np.zeros(3)], 4),
          jb.pad_batch([np.ones(3), np.zeros(3)], 4))
    assert tb.slice_rows((np.arange(4), np.arange(8)), 2) == (2, 2)
    for bad in (lambda b: b.pad_samples([np.zeros(3)], 2, seq_len=2),
                lambda b: b.pad_samples([np.zeros(3)] * 4, 2),
                lambda b: b.pad_samples([], 2)):
        with pytest.raises(tmx.base.MXNetError):
            bad(tb)


# ---------------------------------------------------------------------------
# mask-aware losses and metrics
# ---------------------------------------------------------------------------

def _loss_samples(C=5):
    rng = np.random.RandomState(5)
    xs = [rng.randn(L, C).astype(np.float32) for L in (3, 5, 2, 4)]
    labs = [rng.randint(0, C, size=x.shape[0]).astype(np.float32)
            for x in xs]
    return xs, labs


def _masked_per_sample(mx, b, loss_fn, xs, labs, rows, L, order):
    px, vl, _ = b.pad_samples([xs[i] for i in order], rows, seq_len=L)
    pl, _, _ = b.pad_samples([labs[i] for i in order], rows, seq_len=L)
    mask = b.position_mask(vl, L)
    return loss_fn(mx.nd.array(px), mx.nd.array(pl),
                   mx.nd.array(mask)).asnumpy()


def test_masked_softmax_ce_matches_jax_and_is_padding_exact():
    xs, labs = _loss_samples()
    jloss, tloss = jb.MaskedSoftmaxCELoss(), tb.MaskedSoftmaxCELoss()
    want = _masked_per_sample(jmx, jb, jloss, xs, labs, 6, 8, [0, 1, 2, 3])
    got = _masked_per_sample(tmx, tb, tloss, xs, labs, 6, 8, [0, 1, 2, 3])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    # the port's own identities, bit for bit: padded == unpadded, pad
    # rows exactly 0, batch-mates and bucket do not matter
    for i, (x, lab) in enumerate(zip(xs, labs)):
        ref = tloss(tmx.nd.array(x[None]), tmx.nd.array(lab[None]),
                    tmx.nd.array(np.ones((1, len(x)), np.float32)))
        assert got[i] == ref.asnumpy()[0], i
    assert got[4:].tolist() == [0.0, 0.0]
    other = _masked_per_sample(tmx, tb, tloss, xs, labs, 4, 16,
                               [2, 0, 3, 1])
    for i, j in enumerate([1, 3, 0, 2]):
        assert got[i] == other[j]


def test_masked_l2_and_batch_reduction_match_jax():
    pred = np.array([[1.0, 2.0, 9.0], [3.0, 9.0, 9.0]], np.float32)
    lab = np.array([[0.0, 4.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    out = tb.MaskedL2Loss()(tmx.nd.array(pred), tmx.nd.array(lab),
                            tmx.nd.array(mask)).asnumpy()
    want = jb.MaskedL2Loss()(jmx.nd.array(pred), jmx.nd.array(lab),
                             jmx.nd.array(mask)).asnumpy()
    assert out.tolist() == want.tolist() == [1.25, 2.0]
    vec = np.array([1.0, 3.0, 0.0, 0.0], np.float32)
    assert float(tb.masked_batch_loss(tmx.nd.array(vec), 2).asnumpy()) \
        == float(jb.masked_batch_loss(jmx.nd.array(vec), 2).asnumpy())
    with pytest.raises(tmx.base.MXNetError):
        tb.masked_batch_loss(tmx.nd.array(vec), 0)


def test_masked_loss_hybridizes():
    xs, labs = _loss_samples()
    loss = tb.MaskedSoftmaxCELoss()
    eager = _masked_per_sample(tmx, tb, loss, xs, labs, 6, 8, [0, 1, 2, 3])
    loss.hybridize()
    hybrid = _masked_per_sample(tmx, tb, loss, xs, labs, 6, 8,
                                [0, 1, 2, 3])
    np.testing.assert_allclose(hybrid, eager, **LOSS_TOL)


def _metric_case(b):
    rng = np.random.RandomState(11)
    C, lens = 6, [3, 5, 2, 4]
    preds = [rng.rand(L, C).astype(np.float32) for L in lens]
    preds = [p / p.sum(axis=1, keepdims=True) for p in preds]
    labs = [rng.randint(1, C, size=L).astype(np.float32) for L in lens]
    pp, vl, _ = b.pad_samples(preds, 6, seq_len=8)
    pp[b.position_mask(vl, 8) == 0] = 1.0 / C
    pl, _, _ = b.pad_samples(labs, 6, seq_len=8, pad_value=0)
    return preds, labs, pp, pl


@pytest.mark.parametrize("make", [
    lambda mx, b: mx.metric.Perplexity(ignore_label=0),
    lambda mx, b: mx.metric.Accuracy(axis=-1, ignore_label=0),
    lambda mx, b: b.MaskedMetric(mx.metric.CrossEntropy(), ignore_label=0)],
    ids=["perplexity", "accuracy", "masked_ce"])
def test_masked_metrics_match_jax_bit_for_bit(make):
    out = []
    for mx, b in ((jmx, jb), (tmx, tb)):
        _, _, pp, pl = _metric_case(b)
        m = make(mx, b)
        m.update([mx.nd.array(pl)], [mx.nd.array(pp)])
        out.append(m.get())
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# BucketedPipeline
# ---------------------------------------------------------------------------

def _stream(n=37, seed=3, top=14):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 10, size=L).astype(np.float32),
             np.float32(L % 3))
            for L in rng.choice([3, 4, 5, 6, 7, 9, 11, top], size=n)]


def _lm_stream(n=41, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 10, size=L).astype(np.float32),
             rng.randint(1, 10, size=L).astype(np.float32))
            for L in rng.randint(2, 20, size=n)]


def _batches(pipe, epochs=2):
    out = []
    for _ in range(epochs):
        for b in pipe:
            row = [b.bucket_key, b.pad, b.data[0].asnumpy(),
                   b.label[0].asnumpy() if b.label else None,
                   np.asarray(b.valid_lengths), b.valid_rows]
            for extra in ("segment_ids", "positions", "n_segments"):
                if hasattr(b, extra):
                    row.append(getattr(b, extra))
            out.append(row)
        pipe.reset()
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                _same(a, b)
            else:
                assert a == b


PIPELINES = [
    ("scalar_labels", lambda b: b.BucketedPipeline(
        _stream(), batch_size=4, ladder=[4, 8, 16])),
    ("lm_labels", lambda b: b.BucketedPipeline(
        _lm_stream(), batch_size=4, ladder=[8, 16, 24], invalid_label=0)),
    ("window", lambda b: b.BucketedPipeline(
        [np.ones(3, np.float32)] * 4 + [np.ones(9, np.float32)]
        + [np.ones(3, np.float32)] * 20, batch_size=4, ladder=[4, 16],
        window=6)),
    ("discard", lambda b: b.BucketedPipeline(
        [np.ones(3, np.float32)] * 4 + [np.ones(99, np.float32)] * 2,
        batch_size=4, ladder=[8])),
    ("per_sample_vec", lambda b: b.BucketedPipeline(
        [(np.arange(L, dtype=np.float32), np.ones(5, np.float32))
         for L in (5, 3, 7, 4)], batch_size=4, ladder=[8],
        label_mode="per_sample")),
    ("packed", lambda b: b.PackedPipeline(
        _lm_stream(n=60), batch_size=4, ladder=[8, 16, 24])),
    ("packed_window", lambda b: b.PackedPipeline(
        _lm_stream(n=30, seed=9), batch_size=2, ladder=[16, 32],
        window=5, invalid_label=-1)),
]


@pytest.mark.parametrize("name, make", PIPELINES,
                         ids=[p[0] for p in PIPELINES])
def test_pipeline_batches_match_jax_bit_for_bit(name, make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe, tpipe = make(jb), make(tb)
        want, got = _batches(jpipe), _batches(tpipe)
    _assert_same_batches(got, want)
    assert tpipe.stats.snapshot() == jpipe.stats.snapshot()
    assert [tuple(d) for d in tpipe.provide_data] == \
        [tuple(d) for d in jpipe.provide_data]
    assert [tuple(d) for d in tpipe.provide_label] == \
        [tuple(d) for d in jpipe.provide_label]
    # decode_raw builds host batches; the eager next() placed them
    b = next(iter(make(tb)))
    assert b.data[0]._data.device.type == "cpu"


def test_one_shot_iterator_reset_keeps_samples():
    def gen():
        for L in (3, 3, 3, 5):
            yield np.ones(L, np.float32)
    pipe = tb.BucketedPipeline(gen(), batch_size=4, ladder=[4, 8])
    pipe.reset()
    assert sum(4 - b.pad for b in pipe) == 4
    pipe.reset()
    assert sum(1 for _ in pipe) == 0


def test_pipeline_errors_match_jax(monkeypatch):
    monkeypatch.delenv("MXNET_BUCKET_LADDER", raising=False)
    for b, err in ((jb, jmx.base.MXNetError), (tb, tmx.base.MXNetError)):
        with pytest.raises(err):
            b.BucketedPipeline(_stream(), batch_size=4)
        with pytest.raises(err):
            b.BucketedPipeline(_stream(), batch_size=4, ladder=[8],
                               label_mode="bogus")
        with pytest.raises(err, match="per-position"):
            b.PackedPipeline([(np.ones(3, np.float32), np.float32(1))],
                             batch_size=2, ladder=[8])
    monkeypatch.setenv("MXNET_BUCKET_LADDER", "4,8")
    assert tb.BucketedPipeline(_stream(top=7), batch_size=4) \
        .ladder.buckets == [4, 8]


def test_async_pipeline_wrap_bit_identical():
    """tests/test_bucketing.py::test_async_pipeline_wrap_bit_identical in
    the port: the decode pool and placer deliver the eager batches,
    validity attributes included."""
    from mxnet_tpu_torch.io.pipeline import AsyncInputPipeline
    eager = _batches(tb.BucketedPipeline(_stream(), batch_size=4,
                                         ladder=[4, 8, 16]), epochs=1)
    pooled = AsyncInputPipeline(
        tb.BucketedPipeline(_stream(), batch_size=4, ladder=[4, 8, 16]),
        num_workers=3, placement=tmx.cpu())
    try:
        got = _batches(pooled, epochs=1)
    finally:
        pooled.close()
    _assert_same_batches(got, eager)


def test_overlong_discard_warned_once():
    rng = np.random.RandomState(1)
    samples = [rng.randint(1, 9, size=L).astype(np.float32)
               for L in (3, 30, 4, 31, 5, 6, 7, 3)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = tb.PackedPipeline(samples, batch_size=2, ladder=[8])
        n = sum(b.n_segments for b in pipe)
    assert n == 6 and pipe.stats.snapshot()["discarded"] == 2
    msgs = [str(w.message) for w in caught if "DISCARDED" in str(w.message)]
    assert len(msgs) == 1 and "length-30" in msgs[0]


# ---------------------------------------------------------------------------
# BucketSentenceIter
# ---------------------------------------------------------------------------

def _sentences(n=64, seed=0, lo=3, hi=15):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 20, size=rng.randint(lo, hi)))
            for _ in range(n)]


SENTENCE_CASES = [
    ("buckets", dict(batch_size=4, buckets=[5, 10, 15], invalid_label=0)),
    ("auto_buckets", dict(batch_size=4, invalid_label=-1)),
    ("tail_pad_discard", dict(batch_size=8, buckets=[6, 12],
                              invalid_label=0)),
    ("time_major", dict(batch_size=4, buckets=[8, 16], invalid_label=0,
                        layout="TN")),
    ("empty_bucket", dict(batch_size=4, buckets=[2, 10, 40],
                          invalid_label=0)),
]


@pytest.mark.parametrize("name, kwargs", SENTENCE_CASES,
                         ids=[c[0] for c in SENTENCE_CASES])
def test_bucket_sentence_iter_matches_jax(name, kwargs):
    """Same corpus, same numpy seed: the same batches in the same order
    over two epochs, and the same bucketing snapshot."""
    sents = _sentences()
    runs = []
    for mx in (jmx, tmx):
        np.random.seed(12)
        it = mx.rnn.BucketSentenceIter(sents, **kwargs)
        rows = []
        for _ in range(2):
            for b in it:
                rows.append([b.bucket_key, b.pad, b.data[0].asnumpy(),
                             b.label[0].asnumpy(),
                             tuple(b.provide_data[0].shape)])
            it.reset()
        runs.append((rows, it.bucketing.snapshot(), it.default_bucket_key,
                     [tuple(d.shape) for d in it.provide_data]))
    _assert_same_batches(runs[1][0], runs[0][0])
    assert runs[1][1:] == runs[0][1:]


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "a"], ["c", "b"], ["d"]]
    for kwargs in (dict(invalid_label=0, start_label=1),
                   dict(invalid_label=-1)):
        assert tmx.rnn.encode_sentences(sents, **kwargs) == \
            jmx.rnn.encode_sentences(sents, **kwargs)
    _, vocab = tmx.rnn.encode_sentences(sents, invalid_label=0,
                                        start_label=1)
    with pytest.raises(tmx.base.MXNetError):
        tmx.rnn.encode_sentences([["z"]], vocab=vocab)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _pack_corpus(n=40, seed=7, C=5):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(int(L), C).astype(np.float32)
          for L in rng.choice(np.arange(3, 43), size=n)]
    labs = [rng.randint(0, C, size=len(x)).astype(np.float32) for x in xs]
    return xs, labs


def test_packing_functions_match_jax_bit_for_bit():
    assert tb.first_fit_decreasing([3, 5, 2, 4, 1], 8) == \
        jb.first_fit_decreasing([3, 5, 2, 4, 1], 8)
    xs, labs = _pack_corpus()
    for kwargs in (dict(), dict(rows=40, pad_value=-1)):
        want = jb.pack_samples(xs, 64, **kwargs)
        got = tb.pack_samples(xs, 64, **kwargs)
        for a, b in zip(got[:3], want[:3]):
            _same(a, b)
        assert got[3] == want[3]
    packed, seg, _, bins = tb.pack_samples(xs, 64)
    lab_t = tb.pack_samples(labs, 64, bins=bins, pad_value=-1)
    lab_j = jb.pack_samples(labs, 64, bins=bins, pad_value=-1)
    _same(lab_t[0], lab_j[0])
    _same(tb.segment_masks(seg), jb.segment_masks(seg))
    for a, b in zip(tb.segment_gather(seg, len(xs), n_pad=48),
                    jb.segment_gather(seg, len(xs), n_pad=48)):
        _same(a, b)
    for causal in (False, True):
        _same(tb.segment_attention_mask(seg, causal=causal),
              jb.segment_attention_mask(seg, causal=causal))
    for a, b, x in zip(tb.unpack(packed, seg), jb.unpack(packed, seg), xs):
        _same(a, b)
        _same(a, x)
    for bad in (lambda b: b.first_fit_decreasing([9], 8),
                lambda b: b.first_fit_decreasing([0], 8),
                lambda b: b.pack_samples([np.ones(4)] * 3, 8, rows=1),
                lambda b: b.unpack(packed, seg, seq_axis=0)):
        with pytest.raises(tmx.base.MXNetError):
            bad(tb)


def test_packed_losses_match_padded_bit_for_bit_and_jax():
    xs, labs = _pack_corpus(n=16)
    L = 64
    px, vl, _ = tb.pad_samples(xs, 16, seq_len=L)
    pl, _, _ = tb.pad_samples(labs, 16, seq_len=L)
    ref = tb.MaskedSoftmaxCELoss()(
        tmx.nd.array(px), tmx.nd.array(pl),
        tmx.nd.array(tb.position_mask(vl, L))).asnumpy()
    kx, seg, _, bins = tb.pack_samples(xs, L)
    kl = tb.pack_samples(labs, L, bins=bins, pad_value=-1)[0]
    idx, mask = tb.segment_gather(seg, 16)
    args = [kx, kl, idx.astype(np.int32), mask]
    got = tb.PackedSoftmaxCELoss()(
        *[tmx.nd.array(a, dtype=a.dtype) for a in args]).asnumpy()
    assert kx.shape[0] < 16 and (got == ref).all()
    want = jb.PackedSoftmaxCELoss()(
        *[jmx.nd.array(a, dtype=a.dtype) for a in args]).asnumpy()
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    l2 = tb.PackedL2Loss()(*[tmx.nd.array(a, dtype=a.dtype) for a in
                             (kx[..., 0], kl, idx.astype(np.int32), mask)])
    l2j = jb.PackedL2Loss()(*[jmx.nd.array(a, dtype=a.dtype) for a in
                              (kx[..., 0], kl, idx.astype(np.int32), mask)])
    np.testing.assert_allclose(l2.asnumpy(), l2j.asnumpy(), **LOSS_TOL)


def _packed_qkv(B=3, T=16, H=2, D=8, seed=0):
    rng = np.random.RandomState(seed)
    samples = [rng.randn(L, H, D).astype(np.float32)
               for L in (5, 7, 3, 9, 4, 6)]
    packed, seg, _, _ = tb.pack_samples(samples, T, rows=B)
    return samples, packed, seg


def _dense_segment_attention(x, seg, causal):
    """softmax(scale QK^T + mask) V per head, masked by
    ``segment_attention_mask`` (a fully masked padding row gives 0)."""
    import torch
    q = x.permute(0, 2, 1, 3)
    s = q @ q.transpose(-1, -2) / np.sqrt(x.shape[-1])
    allowed = torch.from_numpy(tb.segment_attention_mask(seg, causal))
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, -1))
    return (p @ q).permute(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_attention_through_the_registered_op(causal):
    import torch
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_flash_attention")
    attrs = dict(op.defaults, causal=causal)
    samples, packed, seg = _packed_qkv()
    x = torch.tensor(packed, requires_grad=True)
    out = op.forward(attrs, x, x, x, torch.from_numpy(seg))
    ref = _dense_segment_attention(x, seg, causal)
    real = torch.from_numpy(seg > 0)
    np.testing.assert_allclose(out[real].detach().numpy(),
                               ref[real].detach().numpy(), **ATTN_TOL)
    # each sample attends to itself only: its rows equal the sample
    # attended alone
    r, t = np.nonzero(seg == 2)
    alone = torch.tensor(samples[1][None])
    want = op.forward(attrs, alone, alone, alone)
    np.testing.assert_allclose(out[r[0], t[0]:t[-1] + 1].detach().numpy(),
                               want[0].numpy(), **ATTN_TOL)
    # no gradient crosses a segment: a loss on sample 2 only
    (out[r[0], t[0]:t[-1] + 1] ** 2).sum().backward()
    g = x.grad.numpy()
    assert (g[seg != 2] == 0).all()
    assert np.abs(g[seg == 2]).sum() > 0
    xr = torch.tensor(packed, requires_grad=True)
    (_dense_segment_attention(xr, seg, causal)[r[0], t[0]:t[-1] + 1]
     ** 2).sum().backward()
    np.testing.assert_allclose(g, xr.grad.numpy(), **ATTN_GRAD_TOL)
