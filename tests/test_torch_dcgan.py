"""The DCGAN of MXNet's Gluon GAN tutorial (after Radford et al. 2015),
narrowed to ngf = ndf = 4, nz 16, batch 4, 64x64 images: one numpy set
of weights (``Normal(0.02)`` drawn by the JAX package, BatchNorm
statistics included) and one numpy latent and image batch go into both
packages, which take the tutorial's discriminator step (real and
detached fake batch, ``SigmoidBCELoss``) and generator step, each with
Adam (lr 2e-4, beta1 0.5). Losses, the binary-accuracy metric and every
updated weight and statistic agree at ``rtol=1e-5, atol=1e-6``, eager
and hybridized."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
NZ, NGF, NDF, BATCH, IMAGE = 16, 4, 4, 4, 64
ADAM = {"learning_rate": 2e-4, "beta1": 0.5}


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def generator(mx, ngf=NGF):
    """G: 1x1 latent -> 4x4 -> ... -> 64x64, tanh; no biases."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2DTranspose(ngf * 8, 4, 1, 0, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"))
        for mult in (4, 2, 1):
            net.add(nn.Conv2DTranspose(ngf * mult, 4, 2, 1, use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"))
        net.add(nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False),
                nn.Activation("tanh"))
    return net


def discriminator(mx, ndf=NDF):
    """D: 64x64 -> 32 -> 16 -> 8 -> 4 -> one logit; no biases."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False), nn.LeakyReLU(0.2))
        for mult in (2, 4, 8):
            net.add(nn.Conv2D(ndf * mult, 4, 2, 1, use_bias=False),
                    nn.BatchNorm(), nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return net


def facc(label, pred):
    """The tutorial's binary accuracy (on D's raw outputs)."""
    pred = pred.ravel()
    label = label.ravel()
    return ((pred > 0.5) == label).mean()


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _numpy_setup():
    """JAX nets' Normal(0.02) weights after one deferred-init forward,
    the latent and a real batch in [-1, 1]."""
    rs = np.random.RandomState(0)
    latent = rs.randn(BATCH, NZ, 1, 1).astype(np.float32)
    real = np.tanh(rs.randn(BATCH, 3, IMAGE, IMAGE)).astype(np.float32)
    np.random.seed(1)
    g, d = generator(jmx), discriminator(jmx)
    g.initialize(jmx.init.Normal(0.02))
    d.initialize(jmx.init.Normal(0.02))
    d(g(jmx.nd.array(latent)))
    return _weights(g), _weights(d), latent, real


def _gan_steps(mx, gw, dw, latent, real, hybridize):
    """The tutorial's D step then G step from the given weights."""
    g, d = generator(mx), discriminator(mx)
    g.initialize()
    d.initialize()
    for net, weights, probe in ((g, gw, latent), (d, dw, real)):
        if mx is tmx:
            params_from_numpy(net, weights)
            continue
        net(mx.nd.array(probe))            # fixes the deferred shapes
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[k]))
    if hybridize:
        g.hybridize()
        d.hybridize()
    loss = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    trainer_g = mx.gluon.Trainer(g.collect_params(), "adam", dict(ADAM))
    trainer_d = mx.gluon.Trainer(d.collect_params(), "adam", dict(ADAM))
    metric = mx.metric.CustomMetric(facc)
    z = mx.nd.array(latent)
    data = mx.nd.array(real)
    real_label = mx.nd.ones((BATCH,))
    fake_label = mx.nd.zeros((BATCH,))
    with mx.autograd.record():
        output = d(data).reshape((-1, 1))
        err_real = loss(output, real_label)
        metric.update([real_label], [output])
        fake = g(z)
        output = d(fake.detach()).reshape((-1, 1))
        err_fake = loss(output, fake_label)
        err_d = err_real + err_fake
        err_d.backward()
    metric.update([fake_label], [output])
    trainer_d.step(BATCH)
    with mx.autograd.record():
        fake = g(z)
        output = d(fake).reshape((-1, 1))
        err_g = loss(output, real_label)
        err_g.backward()
    trainer_g.step(BATCH)
    return dict(err_d=err_d.asnumpy(), err_g=err_g.asnumpy(),
                fake=fake.asnumpy(), acc=metric.get()[1],
                **{"g:" + k: v for k, v in _weights(g).items()},
                **{"d:" + k: v for k, v in _weights(d).items()})


def test_generator_and_discriminator_shapes_and_trainable_totals():
    """At the tutorial's widths G holds 3,576,704 trainable parameters
    and D 2,765,568 (the shapes alone: nothing is run)."""
    def trainable(mx, net, shape):
        net.initialize()
        net.infer_shape(mx.nd.zeros(shape))
        return sum(int(np.prod(p.shape))
                   for p in net.collect_params().values()
                   if p.grad_req != "null")
    got = (trainable(tmx, generator(tmx, 64), (1, 100, 1, 1)),
           trainable(tmx, discriminator(tmx, 64), (1, 3, 64, 64)))
    assert got == (3576704, 2765568)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
def test_one_gan_step_matches_jax(hybridize):
    gw, dw, latent, real = _numpy_setup()
    want = _gan_steps(jmx, gw, dw, latent, real, hybridize)
    got = _gan_steps(tmx, gw, dw, latent, real, hybridize)
    assert sorted(got) == sorted(want)
    assert got["acc"] == want["acc"]
    moved = 0
    for key, w in want.items():
        if key == "acc":
            continue
        np.testing.assert_allclose(got[key], w, **TOL, err_msg=key)
        base = gw.get(key[2:]) if key.startswith("g:") else \
            dw.get(key[2:]) if key.startswith("d:") else None
        moved += base is not None and not np.array_equal(w, base)
    # every weight and BatchNorm statistic of both nets moved
    assert moved == len(gw) + len(dw)
    assert np.all(np.abs(got["fake"]) <= 1.0)
    np.testing.assert_allclose(got["err_d"].mean(), 2 * np.log(2),
                               rtol=0.2)


def test_a_capture_holds_the_cyclic_collector_off(monkeypatch):
    """A block collected while a CUDA graph captures can free another
    graph, whose destruction invalidates the capture (phase 20 met it:
    the previous layer's predict graph, freed by the collector inside
    the next capture). ``_cuda_capture`` keeps the collector off for the
    capture only, and restores it when the body raises."""
    import contextlib
    import gc

    import torch
    from mxnet_tpu_torch import cached_op

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        yield

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    seen = []

    def body():
        seen.append(gc.isenabled())
        return torch.zeros(1)
    cached_op._cuda_capture(body, "cpu", None)
    # the warm-up on the side stream collects as usual, the capture not
    assert seen == [True, False] and gc.isenabled()

    def failing():
        seen.append(gc.isenabled())
        if len(seen) > 3:
            raise RuntimeError("capture failed")
        return torch.zeros(1)
    with pytest.raises(RuntimeError):
        cached_op._cuda_capture(failing, "cpu", None)
    assert gc.isenabled()
