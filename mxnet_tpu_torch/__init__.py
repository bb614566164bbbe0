"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The port runs beside the JAX package and mirrors its module paths, so
each module here has a counterpart of the same name under
``mxnet_tpu/``. It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``mxnet_tpu``. Entry points run on the CUDA device
(``gpu(0)``) unless the caller asks for the CPU (``ctx=mx.cpu()``,
``with mx.cpu():``, ``MXNET_DEFAULT_CONTEXT=cpu``, or ``device="cpu"``
on the serving path); the attention kernels are CUDA C++ written for
Hopper (``parallel/csrc``), built with ``nvcc`` at first use.

What is ported:

- the token path of the LM server: ``serving.DecodeServer`` over
  ``serving.ToyDecoderLM``, with the paged KV pool (``serving.kvcache``)
  and the prefill/decode attention kernels (``parallel.flash_attention``);
- Gluon training: ``nd``/ops/``autograd``, ``gluon`` blocks, losses and
  ``Trainer`` with SGD and Adam, and ``MeshMultiHeadAttention`` over the
  flash kernels, forward and backward.
- the last two TPU kernels: the int8-cache decode attention
  (``flash_decode(k_scale=, v_scale=)`` on ``parallel/csrc/
  flash_decode_q8.cu``) and runtime compilation of user CUDA C kernels
  (``rtc.CudaModule``, NVRTC);
- the framework core up to ``entry()``: ``mx.sym`` (the Symbol graph),
  ``cached_op`` (``build_graph_callable``, ``CachedOp``: one CUDA graph
  per input signature on the card), ``HybridBlock.hybridize()``, the
  conv/pooling/BatchNorm layers and ``gluon.model_zoo.vision``'s
  ResNets;
- the symbolic training path: ``Symbol.bind``/``simple_bind``/``eval``
  and the ``executor`` (predict runs as CUDA graphs on the card),
  ``mx.mod.Module`` with ``fit``/``score``/``predict``, ``mx.io``'s
  ``NDArrayIter``, ``metric``, ``lr_scheduler``, ``callback``,
  ``model``'s checkpoints, ``nd.save``/``nd.load``, and the read half of
  ``checkpoint`` (manifests), which ``DecodeServer.swap_weights(
  prefix=, epoch=)`` loads;
- mixed-precision training and the fused step: ``mx.amp``'s dtype
  policy with fp32 masters (``multi_precision``), every optimizer the
  JAX package registers, the whole update (and, through ``Module``,
  forward + backward with it) as one CUDA graph per signature
  (``fused_step``), the non-finite guard with loss scaling
  (``fault``), and the checkpoint writer with ``fit(checkpoint_prefix=,
  resume_from_checkpoint=)``;
- the input path: ``recordio`` (``.rec``/``.idx``, ``IRHeader``
  packing), the native RecordIO reader (``io/csrc``, built with g++ at
  first use), ``mx.io``'s ``ImageRecordIter``/``ImageDetRecordIter``,
  ``CSVIter``, ``MNISTIter``, ``ResizeIter``, ``PrefetchingIter`` and
  the async input pipeline (``io.pipeline``: a decode pool and a placer
  copying batches to the card on its own stream) through which
  ``Module.fit`` reads, ``SequentialModule``/``PythonModule``,
  ``tools.im2rec``/``tools.rec2idx`` and ``gluon.data`` (datasets,
  samplers, the DataLoader with ``device_prefetch``, vision
  transforms);
- variable-length training: the ``RNN`` op, ``mx.rnn`` (symbolic cells,
  ``BucketSentenceIter``), ``gluon.rnn``, ``mx.bucketing`` (ladders,
  padding, masked losses and metrics, ``BucketedPipeline``, packing)
  and ``mx.mod.BucketingModule`` (one fused-step CUDA graph per
  bucket);
- the rest of the Gluon surface and ``mx.random``: the sampling ops
  (``mx.nd.random``, ``mx.sym.random``: ``_random_*``, ``_sample_*``,
  ``multinomial``, ``shuffle``, each drawn on its device from that
  device's generator), the ``LeakyReLU`` family of activations,
  ``InstanceNorm``, ``PixelShuffle1D/2D/3D``, ``Lambda``/``HybridLambda``,
  the losses of ``gluon.loss`` but ``CTCLoss``, forward hooks and
  ``summary``, ``gluon.Constant``, ``gluon.utils`` and the
  ``Orthogonal``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias`` and ``Mixed``
  initializers;
- the kvstore: ``mx.kv`` (``local``, ``device``, ``dist_sync`` on a
  ``torch.distributed`` all-reduce, ``dist_async`` degraded to sync),
  the kvstore paths of ``Module`` and ``gluon.Trainer``, fault's retries
  (``CollectiveTimeoutError``), ``parallel.distributed``, the local
  launcher (``python -m mxnet_tpu_torch.tools.launch -n N ...``) and
  ``tools.bandwidth``. A worker the launcher spawns joins its process
  group when it imports the package.
- the deploy path: ``deploy`` (``torch.export`` artifacts, with the
  attention kernels as ``torch.library`` ops in them, and format-3 int8
  artifacts), ``contrib.quantization`` and the quantized ops,
  ``serving.InferenceServer`` and ``compile_watch``;
- control flow and user code inside graphs: ``mx.sym.contrib.foreach``/
  ``while_loop``/``cond`` (one ``_foreach``/``_while_loop``/``_cond``
  node, captured whole in its program's CUDA graph), ``mx.operator``
  (``Custom`` ops in Python), ``autograd.Function`` and
  ``autograd.get_symbol``, ``contrib.autograd``, ``mx.monitor`` and
  ``mx.viz``;
- the rest of the breadth: ``gluon.contrib.rnn`` (the convolutional
  RNN/LSTM/GRU cells, ``VariationalDropoutCell``, ``LSTMPCell``),
  ``contrib``'s ``io``, ``svrg_optimization``, ``tensorboard``, ``text``
  and ``onnx``, the helpers ``engine``, ``storage``, ``runtime``,
  ``libinfo``, ``registry``, ``util`` and ``test_utils``, and the tools
  ``parse_log``, ``flakiness_checker`` and ``lint`` (``python -m
  mxnet_tpu_torch.tools.lint``).

Typical use mirrors MXNet::

    import mxnet_tpu_torch as mx
    net = mx.gluon.nn.Dense(10)
    net.initialize(mx.init.Xavier())          # on gpu(0)
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``ROADMAP.md`` lists what waits for later slices.
"""


def _join_launcher_process_group():
    """Join the process group of the launcher's DMLC_* contract
    (``tools/launch.py``) at import, as the JAX package does, so a
    launched worker needs no launcher-specific code
    (``fault.join_process_group``; a no-op without the contract)."""
    import os
    if int(os.environ.get("DMLC_NUM_WORKER", "1") or 1) <= 1 \
            or "DMLC_WORKER_ID" not in os.environ:
        return
    from . import fault
    fault.join_process_group()


_join_launcher_process_group()

from .base import MXNetError
from . import fault
from .fault import CollectiveTimeoutError, InjectedFault
from .context import Context, cpu, gpu, cpu_pinned, current_context, \
    num_gpus, gpu_memory_info
from .name import NameManager
from .attribute import AttrScope
from . import base
from . import ops
from . import operator      # registers the `Custom` op before the stubs
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import random
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import cached_op
from . import autograd
from . import initializer
from . import initializer as init
from . import optimizer
from .optimizer import Optimizer
from . import gluon
from . import rtc
from . import executor
from .executor import Executor
from . import io
from . import recordio
from . import image
from . import metric
from . import lr_scheduler
from . import callback
from . import model
from .model import save_checkpoint, load_checkpoint
from . import checkpoint
from . import log
from . import profiler
from . import tracing
from . import telemetry
from . import livemetrics
from . import flightrec
from . import compile_watch
from . import amp
from . import fused_step
from . import module
from . import module as mod
from .module import Module
from . import rnn
from . import bucketing
from . import serving
from . import deploy
from . import contrib
from . import parallel
from . import kvstore as kvstore_module
from .kvstore import KVStore
from . import kvstore_server
from . import monitor
from . import visualization
from . import visualization as viz
from . import engine
from . import util
from . import runtime
from . import registry
from . import libinfo
from . import storage
from . import test_utils


def kvstore_create(name="local"):
    """``mx.kv.create`` under its top-level name."""
    return kvstore_module.create(name)


# the `mx.kv` alias of reference scripts
kv = kvstore_module

__all__ = ["MXNetError", "fault", "InjectedFault", "Context", "cpu", "gpu",
           "cpu_pinned", "current_context", "num_gpus", "gpu_memory_info",
           "NameManager", "AttrScope", "base", "ops", "nd", "ndarray",
           "NDArray", "random", "sym", "symbol", "Symbol", "cached_op",
           "autograd", "init", "initializer", "optimizer", "Optimizer",
           "gluon", "rtc", "executor", "Executor", "io", "recordio",
           "metric", "lr_scheduler", "callback", "model", "save_checkpoint",
           "load_checkpoint", "checkpoint", "log", "profiler", "tracing",
           "telemetry", "livemetrics", "flightrec", "amp", "fused_step",
           "module", "mod", "Module", "rnn", "bucketing", "serving",
           "contrib", "parallel", "CollectiveTimeoutError",
           "kvstore_module", "kv",
           "KVStore", "kvstore_server", "kvstore_create", "operator",
           "monitor", "visualization", "viz", "engine", "util", "runtime",
           "registry", "libinfo", "storage", "test_utils"]
