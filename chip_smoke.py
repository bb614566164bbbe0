"""On-card smoke run of the PyTorch/CUDA port (mxnet_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc; exits non-zero, printing
no result, anywhere else. Phases (any failure exits non-zero):

1. device — CUDA present, capability >= (9, 0); prints the card's
   ``nvidia-smi`` name and power limit;
2. build — the five attention kernels from
   ``mxnet_tpu_torch/parallel/csrc`` (one nvcc per source, started
   together), with the ptxas register and spill lines of every kernel
   instance (the decode libraries: one kernel a width), and the count
   of tensor-core instructions
   (``HMMA``/``HGMMA`` in ``cuobjdump -sass``) in the forward and each
   backward library, which must not be 0;
3. kernels vs plain — the forward kernel (3xTF32 on the tensor cores)
   at the server's one-prompt prefill, B1 at every rung of its ladder
   (T 64, 128, 256, 512) and at T 300, and the decode kernel over the
   server's window (B8 T576 H12 D64) at random lengths and with one
   live stream (lengths 576, 1, ..., 1), against
   their plain PyTorch versions on the card (fp32, TF32 off, forward O
   and LSE and decode within rtol = atol = 1e-5), with the
   device time (CUDA-graph replay) and per-call time (CUDA events) of
   the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only), and each kernel's
   bound from its bytes and flops; the forward at each of its two
   block shapes (S = 1 or 4 warps on a row group, forced through
   ``mxt_flash_fwd_split``), each held to the plain version and timed,
   beside the host's choice; the decode kernel's splits of the cache
   (the host's choice), a second launch bit-identical, NaN past each
   length changing nothing, and one call's device time with a cold L2
   (``cold_ms``) beside the warm one;
4. training-shape kernels vs plain — the forward kernel at the LM's
   B8 T1024 causal, a packed causal batch (B2 T256), non-causal
   cross-attention (Tq 128, Tk 320), D = 30 (4-byte staging) with Tq <
   Tk and D = 128 with Tq > Tk, at both block shapes (rtol = atol =
   1e-5; rows with no live key must carry the plain version's LSE), each
   shape timed at B8 T1024; two launches bit-identical; at B2 T256 its O
   and LSE against float64 dense attention, at most FWD_F64_RATIO times
   the fp32 plain version's own error. Then the
   dK/dV and dQ kernels (3xTF32 on the tensor cores) against their plain
   versions and against torch autograd of dense attention (rtol = atol
   = 1e-4) at the same five shapes, timed the same way, with the
   backward of scaled_dot_product_attention as the yardstick and both
   bounds (3xTF32 on the tensor cores, fp32 on the CUDA cores); two
   launches on one input must be bit-identical, and a dK with a zeroed
   tile must fail the comparison; at B2 T256 each kernel's error against
   a float64 dense autograd, beside the fp32 plain version's own;
   flash_attention on CUDA tensors returns a tensor with a grad_fn whose
   gradients reach q, k and v;
5. model — ToyDecoderLM at GPT-2-small width (12 layers, 12 heads x 64,
   d_ff 3072, vocab 50257, 1024 positions; random weights from seed 0):
   prefill logits and 16 stepwise decode logits, kernels vs plain;
6. server — the first slice's main path: DecodeServer, its fixed
   program set captured as CUDA graphs in warmup (the decode step and
   one prefill a ladder rung), serves 16 streamed requests (one consumed
   through tokens(), one cancelled midway) by graph replay; every stream
   equals a server-free greedy loop over the same model; exactly
   ``1 + len(ladder)`` captures, none during traffic, one replay a step,
   and launch counts exact (each replay adds the launches its graph
   holds). Kernel launch counts are zeroed just before this run and
   read just after it. Then the same 16 requests' run over an int8 KV
   pool, each stream held to a greedy loop over an int8 paged cache;
   then a weight swap mid-traffic with the prefix cache on (a full-page
   prefix hit copies its shared page through the copy graph), then a
   second swap from a checkpoint manifest (``swap_weights(prefix=,
   epoch=)``; written here by ``write_manifest``, npz shards with their
   SHA-256, one entry in two pieces): each swap adds exactly one
   generation's captures, streams admitted before and after each equal
   the greedy loop under their own weights, the old generations' graphs
   are dropped once their requests finish, and a manifest with one byte
   of a shard flipped raises, naming the file;
7. int8 decode — the third slice's ``flash_decode(k_scale=, v_scale=)``
   on ``flash_decode_q8.cu``: at B8 T576 H12 D64 on a cache quantized
   page by page as the int8 pool does it (raw int8 pages, each page's
   scale repeated over its 16 slots) and at the JAX test's B2 T128 H2
   D8, the kernel against its plain version and against
   ``flash_decode.cu`` on the dequantized cache (rtol = atol = 1e-5,
   and whether the two are bit-identical), and garbage past each row's
   length (random bytes, NaN scales) must leave its output
   bit-identical; the host's splits and cold-L2 times of both decode
   kernels at B8 T576; then, on phase 6's int8 pool, one decode step's
   calls (one per layer) over the raw pages of live requests, launch
   counts zeroed just before and read just after, held the same way;
8. rtc — ``mx.rtc.CudaModule`` compiles four CUDA C kernels (axpy and
   scale_rows of tests/test_rtc.py, row_sum, a shared-memory reduction
   with 256-thread blocks, and axpy_v4, an axpy with 16-byte loads and
   stores) with NVRTC and launches each once on gpu(0) arrays (launch
   counts zeroed just before and read just after: 4, one each), held
   to torch (rtol = atol = 1e-6 for the axpys and scale_rows, 1e-5 for
   row_sum); axpy_v4's ragged tail; in-out arrays of another dtype or
   layout are written back, a launch above 48 KB of shared memory
   works, a launch from a fresh thread works, a broken source raises
   with the compiler's log, and a CPU context raises. NVRTC's SASS
   against ``nvcc -O3``'s for the same source, kernel by kernel. Compile
   seconds (cold and from the disk cache); host microseconds per launch,
   stage by stage and whole, beside cuLaunchKernel alone and torch.add;
   each kernel's device time from CUDA-graph replays (as phases 3-4;
   a replay must equal the eager launch bit for bit), the eager stream's
   time beside it, the plain expression's, one PyTorch call's and the
   bound;
9. step profile — where one steady decode step's time goes (kernel
   classes, device idle share, from the profiler), replayed from the
   server's CUDA graph and run eagerly on the same inputs (identical
   tokens; ``model.decode`` from a graph equal to the eager logits), the
   step graph's device time alone, the graphs' memory, and whole
   scheduler ticks around the replayed step;
10. training — the second slice's main path: a Gluon decoder LM at the
   same width (``gluon_lm``) on gpu(0), batch 8 x 1024 random tokens,
   next-token SoftmaxCrossEntropyLoss, Adam (lr 1e-3). One
   record/backward against a twin with dense attention and the same
   weights (every gradient and the loss must agree), and again with the
   twin reusing the kernel route's ReLU masks, then 20 Trainer
   steps on one fixed batch (the loss must fall; launch counts zeroed
   just before and read just after: 12 per step for each of flash_fwd,
   flash_bwd_dkdv and flash_bwd_dq), then ms per step, tokens/s and the
   device idle share from the profiler; then 3 more steps under an armed
   telemetry run: one step record a step after the first (tick mode),
   each with its optimizer phase, and one memory record read from the
   card;
11. router (run after 9, before 10, which frees the model) — the fleet
   Router over two DecodeServers on the card, each with its own pool,
   both on graphs: 16 sessions over two tenants; replica 1 is not
   warmed, so its captures run while replica 0 replays, and replica 0
   swaps to a copy of its weights during one of them; replica 1 is
   killed once its sessions stream: zero failed streams, every stream
   equal to the greedy loop; then two more sessions on the survivor and
   a graceful drain of it, which they outlive; the router's stats,
   client-side TTFT and inter-token p50, exact launch counts;
12. observability (after 11, before 10) — first the cost of arming on
   one warmed server (phase 9's shapes), in turns disarmed, armed,
   armed with a /metrics scrape thread (twice), armed, disarmed: wall ms
   of a scheduler tick around the replayed step and the inter-token p50
   of each turn, and the ms of each scrape. Then the ninth slice's
   path: the telemetry run (sink), the tracer, the flight recorder,
   /metrics on 127.0.0.1 and the SLO watchdog armed from the
   environment, and a meter with a ledger; a Router over two
   DecodeServers at GPT-2-small width (ladder [64, 128], window 8,
   prefix cache on), one warmed and one not (its captures run while
   /metrics is scraped), 8 sessions of two tenants (one tenant's
   prompts share a two-page prefix), /metrics scraped every 100 ms from
   a client thread; one replica killed once every session streams, then
   the survivor drained. Launch counts zeroed just before the traffic
   and read just after (12 a replayed step or prefill, or a capture).
   Zero failed streams, each equal to the greedy loop; exactly one
   flight-recorder bundle, carrying the replica_lost alert; each
   session's router- and replica-side spans joined under its request
   id in causal order; the usage ledger reconciled (tokens, replayed
   tokens, page-seconds, prefix credits equal to the servers' hit
   counters); FLOPs and bytes billed equal to each program's count
   times its graph replays; no scrape raised, every scrape parses, at
   least one ran while the traffic did and each of those carries the
   router's counters and each live replica's, no counter goes down from
   one scrape to the next, one scrape overlapped a capture, and the last
   one's decode and router counters equal ``stats()``; ``python -m
   mxnet_tpu_torch.tools.diagnose --format json`` on the directory and
   the tool's ``main`` on the sink report every reconcile line true.

13. resnet (run last) — the tenth slice's main path, ``entry()``'s
   five lines through ``import mxnet_tpu_torch as mx`` on gpu(0)
   (``vision.resnet50_v1(classes=10)``, Xavier from ``mx.random.seed(0)``,
   a forward on zeros, ``net(sym.var("data"))``,
   ``build_graph_callable``) at batch 2, 32x32, fp32 with TF32 off: the
   plan and the hybridized net (``net.hybridize()``: the CachedOp's CUDA
   graph) against the imperative run on the card (rtol = atol = 1e-5),
   over 8 calls on 4 inputs exactly 1 capture and 8 replays, each call's
   output its own tensor; the output weight written in place by
   ``set_data`` (a replay, the output follows) and replaced by a new
   tensor (one counted recapture, the output follows). One training
   call under ``record()`` on the hybridized net, for it and for
   ResNet-18 at batch 2, 64x64: every BatchNorm's moving statistics
   against momentum*old + (1-momentum)*batch, the batch moments
   recomputed in float64 from that BatchNorm's input; gradients reach
   every conv weight. Then ms a batch and images/s (median of 20 after
   warm-up), device busy ms by class and the idle share (profiler), peak
   memory and the bound (convolution and FC FLOPs at the fp32 peak, or
   the weights' bytes), imperative and hybridized, at entry()'s config
   and at the reference's benchmark size (ResNet-50, classes 1000,
   batch 32, 224x224), there with one extra labelled reading with
   cuDNN's TF32 on. Attention kernel launches, zeroed before, must read
   0: no kernel of the port is on this path.
14. module (after 13) — the eleventh slice's main path, the symbolic
   API: ResNet-50 v1 (``vision.resnet50_v1(classes=1000)`` traced with
   ``net(sym.var("data"))`` plus ``SoftmaxOutput``) trained by
   ``mx.mod.Module.fit`` on gpu(0) over an ``NDArrayIter`` of 64 random
   images (batch 32, 224x224, labels 0-999, numpy seed), SGD (lr 0.0125,
   momentum 0.9, wd 1e-4), Xavier, ``eval_metric="acc"`` and a
   Speedometer, 10 epochs: the loss by epoch must fall from the first to
   the last and every step's gradients be finite; ``score`` and
   ``predict`` over the images on the executor's CUDA graph (1 capture,
   then replays, no recapture), the probabilities equal to an eager
   predict forward; a training step's ms (median after warm-up) with and
   without ``update_metric``, images/s, device busy ms by class, the
   optimizer loop's alone, the idle share and peak memory; predict
   images/s by graph. Then one Module step against one Gluon step
   (``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``Trainer("sgd")``) from the same weights and batch: the loss, the
   moving statistics and every weight's step agree (MODULE_TOL,
   MODULE_STEP_REL), and the Module's deferred conv biases' gradients
   read exactly 0. TF32 off; attention kernel launches, zeroed before,
   must read 0.
15. zoo (after 14) — the twelfth slice's Gluon vision surface as the
   reference's ``benchmark_score.py`` runs it: ``alexnet``, ``vgg16``,
   ``vgg16_bn``, ``densenet121``, ``squeezenet1.1``, ``mobilenet1.0``,
   ``mobilenetv2_1.0`` at 224x224 and ``inceptionv3`` at 299x299, each
   at its published widths, 1000 classes, batch 32, Xavier from
   ``mx.random.seed(0)``: the hybridized net's logits against the
   imperative run's (ZOO_TOL); 1 capture, 39 replays, 0 recaptures and
   0 eager-rng calls, the five nets with Dropout included; ms a batch by
   replay (median of 20 after warm-up), images/s, device busy by class
   (convolutions, BatchNorm/elementwise, pooling, FC, concat) and the
   idle share, peak memory and the share of the FLOP bound. A net whose
   Dropout draws in predict mode (``mode="always"``) runs op by op,
   each call counted as eager-rng. Attention kernel launches, zeroed
   before, must read 0.
16. export and training (after 15) — Inception-v3's ``export`` loaded
   by ``gluon.SymbolBlock.imports(..., ["data0"], ...)`` on gpu(0): the
   exporting graph's logits (1 capture); tests/test_placement.py's
   two-group net under ``group2ctxs={"dev1": cpu(0), "dev2": gpu(0)}``:
   fc1 and relu1 run on the host, fc2 and the head on cuda:0, fc1's
   gradient on the host, one grouped step equal to an ungrouped one on
   gpu(0) (PLACE_TOL), and ``Module.fit`` 10 epochs to accuracy > 0.8;
   then AlexNet (1000 classes) at batch 512, 224x224: one Module step
   held to a Gluon step (``autograd.record`` -> ``Trainer("sgd")``)
   from the same weights, batch and generator seed, so the same Dropout
   masks: every weight's step within ALEXNET_STEP_REL, the loss within
   MODULE_TOL, each Dropout's keep fraction within 5 binomial standard
   deviations of 0.5; then trained through ``Module.fit`` on 1024
   random images (numpy seed 90; labels from 16 classes), SGD, 5 epochs
   = 10 steps, Dropout drawing from the executor's generator: the loss
   finite and falling from the first epoch to the last, every step's
   gradients finite; ms a step, images/s, device busy by class, the
   idle share and peak memory. Attention kernel launches, zeroed before, must read 0.

It prints a ``{"kernels": [...]}`` line, one entry per kernel and main
path (``path``: server, observability, training, int8 decode or rtc;
``launches`` from that path's run, times at the shape it gives the
kernel), and, last,
``{"ok": true, "device": {...}}``.
"""
import contextlib
import ctypes
import gc
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): fp32 on the CUDA cores, TF32 on the
# tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the attention forward and backward kernels take each fp32 product as
# three TF32 products (3xTF32: hi*hi + hi*lo + lo*hi)
TF32_PASSES = 3
TOL = dict(rtol=1e-5, atol=1e-5)
# the scratch buffer written before each cold-L2 timing (L2: 50 MB), and
# the spin (~0.5 ms at the H100's clock) that hides the call's host work
COLD_FLUSH_BYTES = 128 << 20
SPIN_CYCLES = 1 << 20
# the forward's float64 check (B2 T256): the kernel's error against
# float64 dense attention may be at most this many times the fp32 plain
# version's own (3xTF32 products, summed in another order)
FWD_F64_RATIO = 4.0
# flash_fwd.cu's block shapes: S warps share each 16-row group of a
# block's query tile (64- or 16-row blocks). mxt_flash_fwd, which the port
# calls, picks one from the grid; mxt_flash_fwd_split forces one
FWD_SPLITS = (1, 4)
# logits tolerance of the 12-layer model, kernels vs plain: attention
# rounding (~1e-7 relative) is carried through 12 residual layers into
# logits of magnitude up to ~30
LOGIT_ATOL = 1e-3
TIE_MARGIN = 1e-4
GPT2_SMALL = dict(vocab=50257, n_layers=12, n_heads=12, head_dim=64,
                  d_ff=3072, max_len=1024)
FWD_SRC = "mxnet_tpu_torch/parallel/csrc/flash_fwd.cu"
DEC_SRC = "mxnet_tpu_torch/parallel/csrc/flash_decode.cu"
BWD_SRC = {"flash_bwd_dkdv": "mxnet_tpu_torch/parallel/csrc/flash_bwd_dkdv.cu",
           "flash_bwd_dq": "mxnet_tpu_torch/parallel/csrc/flash_bwd_dq.cu"}
FWD_TPU = "mxnet_tpu/parallel/flash_attention.py:83"
DEC_TPU = "mxnet_tpu/parallel/flash_attention.py:516"
BWD_TPU = {"flash_bwd_dkdv": "mxnet_tpu/parallel/flash_attention.py:137",
           "flash_bwd_dq": "mxnet_tpu/parallel/flash_attention.py:187"}
# backward kernels vs plain: 3xTF32 products (~2^-22 relative each, a
# scratch emulation put them 1e-6 to 3e-6 off fp32) summed over up to
# 1024 rows in another order than the plain einsums
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
# flops per live (q, k) pair and head, per D: dK/dV (S, dP, dV, dK) and
# dQ (S, dP, dQ)
BWD_FLOPS = {"flash_bwd_dkdv": 8, "flash_bwd_dq": 6}
# the training check, max|diff| / max|grad| per parameter, kernel route
# vs the dense-attention twin. The two softmax algorithms differ by ~1e-7
# in fp32; where that flips a ReLU pre-activation across zero, one
# token's term (about 1% of max |grad|) enters or leaves a row of that
# layer's ffn1 weight gradient. So the ffn1 weights get GRAD_RTOL_RELU
# (a few flips), every other parameter GRAD_RTOL (7x the largest
# reading, 1.3e-3), and a second pass of the twin that reuses the kernel
# route's ReLU masks, which takes the flips out, holds every parameter
# to GRAD_RTOL_SHARED. Per-sample losses within LOSS_ATOL.
GRAD_RTOL = 1e-2
GRAD_RTOL_RELU = 5e-2
GRAD_RTOL_SHARED = 1e-3
LOSS_ATOL = 1e-4
TRAIN_BATCH = 8
Q8_SRC = "mxnet_tpu_torch/parallel/csrc/flash_decode_q8.cu"
Q8_TPU = "mxnet_tpu/parallel/flash_attention.py:528"
RTC_SRC = "mxnet_tpu_torch/rtc.py"
RTC_TPU = "mxnet_tpu/rtc.py:105"
# the int8 pool's page size
PAGE = 16
# rtc kernels vs torch: axpy may contract to one FMA (one ulp), row_sum
# adds in another order than torch.sum
RTC_TOL = dict(rtol=1e-6, atol=1e-6)
ROWSUM_TOL = dict(rtol=1e-5, atol=1e-5)
# launches in each host-time loop of phase 8
RTC_REPS = 2000
# the server phases' DecodeServer: GPT-2-small prompts up to 512 tokens
SERVER_CFG = dict(seq_ladder=[64, 128, 256, 512], max_new_tokens=64,
                  window=8, page_size=16, pool_pages=384)
# the ResNet phase: entry()'s config (batch, image, classes), the
# reference's benchmark size, the training check's second net, and its
# tolerances: logits by graph replay and through build_graph_callable vs
# the imperative run on the card (the same cuDNN calls, another
# launch path); the written-back moving statistics vs
# momentum*old + (1-momentum)*batch recomputed in float64 (fp32 one-pass
# shifted moments against float64 two-pass ones)
RESNET_ENTRY = (2, 32, 10)
RESNET_BENCH = (32, 224, 1000)
RESNET18_TRAIN = (2, 64, 10)
RESNET_TOL = dict(rtol=1e-5, atol=1e-5)
RESNET_STAT_TOL = dict(rtol=1e-5, atol=1e-5)
RESNET_ITERS = 20
# device time by class in the ResNet profile, first match wins
RESNET_CLASSES = (("pooling", ("pool", "pad")),
                  ("convolutions", ("conv", "fprop", "implicit", "winograd",
                                    "fft", "nchwkcrs", "nhwckrsc")),
                  ("FC (matmul)", ("gemm",)),
                  ("BatchNorm/elementwise", ("elementwise",)))
# the symbolic training path (phase 14): ResNet-50 v1 through Module at
# the reference's benchmark size (batch, image, classes), the images, the
# epochs and SGD's settings; one Module step against one Gluon step from
# the same weights and batch: each weight's step (lr * (grad/batch + wd *
# w) + momentum * 0) within MODULE_STEP_REL of its largest entry, the
# moving statistics and the loss within MODULE_TOL (the same cuDNN calls
# in both, but the Module runs the biased 1x1 convs without their bias,
# which BatchNorm absorbs); the predict graph's outputs equal an eager
# predict forward exactly. SGD's rate is the reference's 0.1 at batch
# 256 scaled linearly to batch 32: at 0.1 the curve is chaotic, and
# cuDNN's free algorithm choice alone sent one run's loss from 10.66 in
# the first epoch to 16.33 in the last, where others fell to 5.3-6.6
# (scratch/module_fit_spread.py)
MODULE_BENCH = (32, 224, 1000)
MODULE_IMAGES = 64
MODULE_EPOCHS = 10
MODULE_SGD = dict(learning_rate=0.0125, momentum=0.9, wd=1e-4)
# the held step keeps the rate 0.1: it is read as new weights minus old
# in fp32, whose rounding is a larger share of a smaller step (2.15e-4
# of the largest entry at 0.1, 8.05e-4 at 0.0125 on an H100)
MODULE_STEP_SGD = dict(MODULE_SGD, learning_rate=0.1)
MODULE_STEP_REL = 1e-3
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
MODULE_ITERS = 10
# device time by class in a Module training step, first match wins
MODULE_CLASSES = (("convolution backward", ("dgrad", "wgrad", "bprop")),
                  ("convolution forward", ("conv", "fprop", "implicit",
                                           "winograd", "fft", "nchwkcrs",
                                           "nhwckrsc", "xmma")),
                  ("FC (matmul)", ("gemm",)),
                  ("SoftmaxOutput", ("softmax",)),
                  ("pooling", ("pool", "pad")),
                  ("BatchNorm/elementwise", ("elementwise", "reduce")))
# the Gluon vision surface (phase 15): one net per model-zoo family at
# its published widths, 1000 classes, batch 32, as the reference's
# example/image-classification/benchmark_score.py runs them; the graph's
# logits held to the imperative run's within ZOO_TOL
ZOO_BENCH = (("alexnet", 224), ("vgg16", 224), ("vgg16_bn", 224),
             ("densenet121", 224), ("squeezenet1.1", 224),
             ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
             ("inceptionv3", 299))
ZOO_BATCH = 32
ZOO_CLASSES_N = 1000
ZOO_TOL = dict(rtol=1e-5, atol=1e-5)
ZOO_DROPOUT = ("alexnet", "vgg16", "vgg16_bn", "squeezenet1.1", "inceptionv3")
# device time by class in a zoo forward, first match wins
ZOO_CLASSES = (("pooling", ("pool",)),
               ("concat", ("catarray", "concat")),
               ("convolutions", ("conv", "fprop", "implicit", "winograd",
                                 "fft", "nchwkcrs", "nhwckrsc", "xmma",
                                 "depthwise")),
               ("FC (matmul)", ("gemm",)),
               ("BatchNorm/elementwise", ("elementwise", "reduce")))
# phase 16: placement over cpu(0)/gpu(0) on tests/test_placement.py's
# two-group net and data; AlexNet trained through Module at the
# reference's training size (batch, image, classes; BASELINE.md:25), on
# TRAIN_IMAGES random images whose labels come from TRAIN_LABELS of the
# classes (so that 10 steps can move the loss), TRAIN_EPOCHS epochs
PLACE_TOL = dict(rtol=1e-5, atol=1e-5)
ALEXNET_TRAIN = (512, 224, 1000)
TRAIN_IMAGES = 1024
TRAIN_EPOCHS = 5
TRAIN_LABELS = 16
ALEXNET_SGD = dict(learning_rate=0.005, momentum=0.9, wd=5e-4)
# one AlexNet Module step against one Gluon step with the same Dropout
# masks: each weight's step within ALEXNET_STEP_REL of its largest entry.
# Without BatchNorm the conv weight gradients cancel heavily: on an H100
# (fp32, TF32 off) the same Gluon step through cuDNN and through torch's
# native convolutions differs by up to 6.9e-3 of the largest entry
# (conv1), and two cuDNN runs of it by 1.0e-3; different masks move it
# by order 1
ALEXNET_STEP_REL = 2e-2
# the kernels each main path runs
SERVER_KERNELS = ("flash_fwd", "flash_decode")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# user kernels for mx.rtc: tests/test_rtc.py's two in CUDA C, a
# shared-memory reduction, and an axpy written for this card
RTC_KERNELS = r"""
extern "C" __global__ void axpy(float alpha, const float *x, float *y) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    y[i] += alpha * x[i];
}

// out[row, :] = x[row, :] * (row + 1): one block per row, one thread per
// column
extern "C" __global__ void scale_rows(const float *x, float *out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    out[i] = x[i] * (float)(blockIdx.x + 1);
}

// out[row] = sum of x[row, 0:n]: one block per row, blockDim.x strided
// partial sums added by a tree in dynamic shared memory (blockDim.x
// floats, a power of two)
extern "C" __global__ void row_sum(const float *x, float *out, int n) {
    extern __shared__ float part[];
    const float *r = x + (long)blockIdx.x * n;
    float s = 0.f;
    for (int j = threadIdx.x; j < n; j += blockDim.x) s += r[j];
    part[threadIdx.x] = s;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

// axpy written for this card: y[0:n] += alpha * x[0:n] four floats a
// thread through 16-byte float4 loads and stores (x and y 16-byte
// aligned, as torch allocates them), a grid-stride loop, the last n % 4
// floats one a thread
extern "C" __global__ void axpy_v4(float alpha, const float *x, float *y,
                                   int n) {
    const float4 *x4 = reinterpret_cast<const float4 *>(x);
    float4 *y4 = reinterpret_cast<float4 *>(y);
    long n4 = n / 4, stride = (long)gridDim.x * blockDim.x;
    long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long i = t; i < n4; i += stride) {
        float4 a = x4[i], b = y4[i];
        b.x += alpha * a.x;
        b.y += alpha * a.y;
        b.z += alpha * a.z;
        b.w += alpha * a.w;
        y4[i] = b;
    }
    if (t < n - 4 * n4) y[4 * n4 + t] += alpha * x[4 * n4 + t];
}
"""


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def call_ms(fn, iters=20, warm=3):
    """Median time of one call on the card's clock, from CUDA events:
    device work plus any gap while the host prepares the launch."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_ms(fn, before=None):
    """CUDA-event time of ``fn()``, after ``before()`` (queued ahead of
    the start event)."""
    if before is not None:
        before()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, iters=20, reps=5):
    """Device time of the GPU work one call launches, without host
    gaps: ``iters`` calls captured in one CUDA graph, the graph replayed
    between CUDA events; the median of ``reps`` replays over ``iters``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(events_ms(graph.replay) / iters
                             for _ in range(reps))


def cold_ms(fn, reps=20):
    """(cold, warm) device ms of ONE call: the median over ``reps``
    CUDA-event timings of one eager call, cold each after COLD_FLUSH_BYTES
    of a scratch buffer are written (more than twice the 50 MB L2: none
    of the call's inputs is left there), warm each right after another
    call. A spin kernel (``torch.cuda._sleep``, ~0.5 ms, no memory
    traffic) runs ahead of the start event each time, so the call's host
    work is queued before its timing starts. A decode layer's gathered
    cache (28 MB at B8 T576) is otherwise partly held in L2 from one
    graph replay to the next, which flatters a kernel bound by its
    bytes."""
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")

    def after(first):
        first()
        torch.cuda._sleep(SPIN_CYCLES)
    fn()
    cold = statistics.median(
        events_ms(fn, lambda i=i: after(lambda: flush.fill_(float(i))))
        for i in range(reps))
    warm = statistics.median(events_ms(fn, lambda: after(fn))
                             for _ in range(reps))
    del flush
    return cold, warm


def timed(fn):
    """(device ms, per-call ms) of one call."""
    return device_ms(fn), call_ms(fn)


def stream_ms(fn, iters=10):
    """Time per call of ``iters`` calls issued back to back between two
    CUDA events, after a warm-up call: device time when the device is
    the bottleneck (used where a call runs torch autograd, which a CUDA
    graph capture does not take)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def report(name, what, ms, plain_ms, lib_ms, bound, bound_by):
    print("  %-30s %s | device ms: kernel %.4f plain %.4f sdpa %.4f |"
          " per-call ms: kernel %.4f plain %.4f sdpa %.4f | bound %.2f us"
          " (%s)" % (name, what, ms[0], plain_ms[0], lib_ms[0], ms[1],
                     plain_ms[1], lib_ms[1], bound * 1e3, bound_by))


def close(got, want, tol=TOL):
    """(max abs error, within tol) over finite reference entries."""
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= tol["atol"] + tol["rtol"] * want.abs()).all())
    return float(err.max()), ok


def phase_device():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        fail("needs compute capability >= 9.0, got %s" % (cap,))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi failed: %s" % smi.stderr.strip()
    print("card:", line)
    print("torch %s, CUDA %s, capability %s"
          % (torch.__version__, torch.version.cuda, cap))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from mxnet_tpu_torch.parallel import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print("build: %.1f s" % (time.perf_counter() - t0))
    for name in libs:
        with open(_build.log_path(name)) as f:
            for ln in f:
                # ptxas names each kernel instance, then its resources
                entry = re.search(r"Compiling entry function .*?((?:fwd|dkdv|"
                                  r"dq|decode_q8|decode)_kernel)(?:I((?:Li"
                                  r"\d+E)+)E)?", ln)
                if entry:
                    print("  %s: %s<%s>" % (name, entry.group(1), ", ".join(
                        re.findall(r"\d+", entry.group(2) or ""))))
                elif "registers" in ln or "spill" in ln:
                    print("  %s: %s" % (name, ln.strip()))
    # the forward and backward kernels' contractions must run on the tensor
    # cores
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("flash_fwd",) + tuple(BWD_SRC):
        sass = subprocess.run([cuobjdump, "-sass", libs[name]],
                              capture_output=True, text=True, timeout=120)
        if sass.returncode != 0:
            fail("cuobjdump -sass %s: %s" % (libs[name], sass.stderr))
        hmma = len(re.findall(r"\bHMMA\b", sass.stdout))
        hgmma = len(re.findall(r"\bHGMMA\b", sass.stdout))
        print("  %s: tensor-core instructions in the SASS: HMMA %d, HGMMA %d"
              % (name, hmma, hgmma))
        if hmma + hgmma == 0:
            fail("%s has no tensor-core instruction" % name)


def fwd_split_entry(path):
    """``mxt_flash_fwd_split`` of the flash_fwd library at ``path``:
    ``mxt_flash_fwd``'s arguments, then S before the stream."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = ctypes.CDLL(path).mxt_flash_fwd_split
    fn.argtypes = [p] * 6 + [i] * 5 + [f, i, i, p]
    fn.restype = i
    return fn


_fwd_split_fn = []


def fwd_forced(q, k, v, seg, scale, causal, split, fn=None):
    """One call of flash_fwd.cu at block shape ``split`` (``fn``, an
    ``mxt_flash_fwd_split``, else the port's built library's) on
    contiguous inputs, as ``_fwd_cuda`` makes it but counting no launch:
    (o, lse)."""
    if fn is None:
        if not _fwd_split_fn:
            from mxnet_tpu_torch.parallel import _build
            _fwd_split_fn.append(fwd_split_entry(
                _build.build_all()["flash_fwd"]))
        fn = _fwd_split_fn[0]
    B, Tq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Tq, k.shape[1], D, float(scale),
            int(causal), split, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail("flash_fwd at S = %d: launch failed with cudaError %d"
             % (split, rc))
    return o, lse


def segment_plane(B, T, seed, dev):
    """(B, T) int32 packed-row segment ids: four segments, then a pad
    tail of 16 positions (id 0)."""
    rs = np.random.RandomState(seed)
    cuts = np.sort(rs.choice(np.arange(1, T - 16), 3, replace=False))
    ids = np.zeros(T, np.int32)
    for i, (a, b) in enumerate(zip([0] + list(cuts), list(cuts) + [T - 16])):
        ids[a:b] = i + 1
    return torch.from_numpy(np.tile(ids, (B, 1))).to(dev)


def live_mask(B, Tq, Tk, causal, seg, dev):
    """(B, Tq, Tk) bool: the (q, k) pairs the masks let through."""
    qp = torch.arange(Tq, device=dev)[:, None]
    kp = torch.arange(Tk, device=dev)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=dev)
    if causal:
        live &= qp >= kp
    live = live.expand(B, Tq, Tk)
    if seg is not None:
        live = live & (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
    return live


def fwd_bounds(B, Tq, Tk, H, D, live, segmented):
    """(3xTF32 bound ms, fp32 bound ms, bound_by, flops, bytes) of the
    forward: 4*D flops per live pair and head (S = Q K^T and P V); q, k
    and v read, o and the LSE written, and the segment plane read."""
    flops = 4.0 * D * int(live.sum()) * H
    nbytes = 4.0 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + B * H * Tq)
    if segmented:
        nbytes += 4.0 * B * Tq
    tc_s = TF32_PASSES * flops / PEAK_TF32_FLOPS
    bound = max(tc_s, nbytes / PEAK_BYTES) * 1e3
    bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES > tc_s else "operations"
    return bound, bound_fp32, bound_by, flops, nbytes


def fwd_case(tfa, B, Tq, Tk, H, D, causal, segmented, seed,
             time_splits=False):
    """The forward kernel on one input: O and LSE against the plain
    version (``_torch_fwd_lse``) on the rows with a live key, and the LSE
    of rows with none equal to the plain version's, at the host's block
    shape and at each forced one (``FWD_SPLITS``); a second
    launch must be bit-identical; the host's choice is read off as the
    forced shape whose output it equals. Times the host's choice (and,
    with ``time_splits``, every shape) beside the plain version and
    SDPA."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, Tq, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev) for _ in range(2))
    seg = segment_plane(B, Tq, seed, dev) if segmented else None
    scale = D ** -0.5
    want, want_lse = tfa._torch_fwd_lse(q, k, v, seg, scale, causal)
    live = live_mask(B, Tq, Tk, causal, seg, dev)
    rows = live.any(-1)                   # (B, Tq): rows with a live key
    want_rows = want_lse.permute(0, 2, 1)
    outs, errs = {}, []
    for split in (None,) + FWD_SPLITS:
        got, lse = tfa._fwd_cuda(q, k, v, seg, scale, causal) \
            if split is None else \
            fwd_forced(q, k, v, seg, scale, causal, split)
        outs[split] = (got, lse)
        err, ok = close(got[rows], want[rows], TOL)
        lse_rows = lse.permute(0, 2, 1)
        lse_err, lse_ok = close(lse_rows[rows], want_rows[rows], TOL)
        # rows that attend to nothing (segment id 0): the plain version's
        # LSE exactly, which the backward's P recompute reads
        dead_ok = torch.equal(lse_rows[~rows], want_rows[~rows])
        errs.append((split, err, lse_err, ok and lse_ok and dead_ok))
    again = tfa._fwd_cuda(q, k, v, seg, scale, causal)
    same = all(torch.equal(a, b) for a, b in zip(again, outs[None]))
    choice = next((s for s in FWD_SPLITS
                   if all(torch.equal(a, b)
                          for a, b in zip(outs[s], outs[None]))), None)
    bound, bound_fp32, bound_by, flops, nbytes = fwd_bounds(
        B, Tq, Tk, H, D, live, segmented)
    ms = timed(lambda: tfa._fwd_cuda(q, k, v, seg, scale, causal))
    plain_ms = timed(lambda: tfa.flash_attention(
        q, k, v, causal=causal, segment_ids=seg, impl="plain"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is None:
        lib = lambda: sdpa(qt, kt, vt, is_causal=causal)  # noqa: E731
    else:
        mask = live[:, None]
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)    # noqa: E731
    lib_ms = timed(lib)
    split_ms = {s: device_ms(lambda s=s: fwd_forced(
        q, k, v, seg, scale, causal, s)) for s in FWD_SPLITS} \
        if time_splits else {}
    name = "fwd B%d Tq%d Tk%d H%d D%d %s%s" % (
        B, Tq, Tk, H, D, "causal" if causal else "full",
        " seg" if segmented else "")
    err = max(e for _, e, _, _ in errs)
    lse_err = max(e for _, _, e, _ in errs)
    print("  %-34s err %.3g lse_err %.3g | device ms: kernel %.4f plain %.4f"
          " sdpa %.4f | per-call ms: kernel %.4f plain %.4f sdpa %.4f |"
          " bound %.2f us 3xTF32 (%s) [%.2f us fp32 CUDA cores] | %.2f"
          " GFLOP, %.1f MB" % (name, err, lse_err, ms[0], plain_ms[0],
                              lib_ms[0], ms[1], plain_ms[1], lib_ms[1],
                              bound * 1e3, bound_by, bound_fp32 * 1e3,
                              flops / 1e9, nbytes / 1e6))
    print("    block shapes (S warps a row group), err O/LSE: %s; %d rows"
          " with no live key, LSE equal to plain: %s; host's choice S ="
          " %s; second launch bit-identical: %s%s" % (
              ", ".join("S=%s %.3g/%.3g" % ("host" if sp is None else sp,
                                            e, le)
                        for sp, e, le, _ in errs), int((~rows).sum()),
              all(ok for _, _, _, ok in errs), choice, same,
              "" if not split_ms else "; device ms " + ", ".join(
                  "S=%d %.4f" % kv for kv in split_ms.items())))
    if not all(ok for _, _, _, ok in errs):
        fail("flash_fwd disagrees with the plain version: %s" % name)
    if not same or choice is None:
        fail("flash_fwd: a second launch differs, or the host's launch"
             " equals no block shape: %s" % name)
    return dict(err=max(err, lse_err), ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by=bound_by,
                bound_fp32_ms=bound_fp32, split_ms=split_ms, choice=choice)


def fwd_f64_case(tfa, B=2, T=256, H=12, D=64):
    """The forward kernel's O and LSE against float64 dense attention,
    beside the fp32 plain version's own float64 error, on one causal
    input (B2 T256): the kernel's may be at most ``FWD_F64_RATIO`` times
    the plain version's."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(14)
    q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
               for _ in range(3))
    scale = D ** -0.5
    kern = tfa._fwd_cuda(q, k, v, None, scale, True)
    plain = tfa._torch_fwd_lse(q, k, v, None, scale, True)
    q64, k64, v64 = (x.double() for x in (q, k, v))
    o64 = tfa._torch_reference(q64, k64, v64, scale, True)
    s64 = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
    s64 = torch.where(live_mask(1, T, T, True, None, dev)[:, None], s64,
                      -1e30)
    ref = (o64, torch.logsumexp(s64, -1))
    errs = {what: [float((a.double() - r).abs().max())
                   for a, r in zip(outs, ref)]
            for what, outs in (("kernel", kern), ("fp32 plain", plain))}
    ratio = [a / b for a, b in zip(errs["kernel"], errs["fp32 plain"])]
    print("  forward vs float64 dense attention at B%d T%d H%d D%d causal,"
          " max abs err O/LSE: kernel %s; fp32 plain version %s; ratio %s"
          " (at most %g)"
          % (B, T, H, D, "/".join("%.3g" % e for e in errs["kernel"]),
             "/".join("%.3g" % e for e in errs["fp32 plain"]),
             "/".join("%.2f" % r for r in ratio), FWD_F64_RATIO))
    if not all(e <= TOL["atol"] for e in errs["kernel"]) \
            or not all(r <= FWD_F64_RATIO for r in ratio):
        fail("flash_fwd disagrees with float64 dense attention")


def decode_splits(name, B, H, T, D):
    """The host's number of splits of the cache for a call of decode
    kernel ``name`` (flash_decode or flash_decode_q8) on these shapes."""
    from mxnet_tpu_torch.parallel import _build
    return _build.library(name).splits(B, H, T, D)


def decode_case(tfa, B, T, H, D, seed, lens_np=None):
    """The fp32 decode kernel on one input, at random lengths from 1 to T
    (rows 0 and B-1 at 1 and T) or at ``lens_np``: against its plain
    version (and, twice launched, against itself; with NaN past each
    length, bit-identical), timed warm from CUDA-graph replays and cold
    after an L2 flush, beside SDPA and its bound."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, T, H, D, generator=g).to(dev)
            for _ in range(2))
    if lens_np is None:
        lens_np = np.random.RandomState(seed).randint(1, T + 1, size=B)
        lens_np[0], lens_np[-1] = 1, T
    lens_np = np.asarray(lens_np)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    got = tfa._decode_cuda(q, k, v, lens, D ** -0.5)
    want = tfa.flash_decode(q, k, v, lens, impl="plain")
    err, ok = close(got, want)
    tail = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    dirty = tfa._decode_cuda(q, k.masked_fill(tail[:, :, None, None],
                                              float("nan")),
                             v.masked_fill(tail[:, :, None, None],
                                           float("nan")), lens, D ** -0.5)
    same = torch.equal(tfa._decode_cuda(q, k, v, lens, D ** -0.5), got)
    clean_tail = torch.equal(dirty, got)
    live = int(lens_np.sum())
    flops = 4.0 * D * live * H
    nbytes = 4.0 * H * (2 * live * D + 2 * B * D) + 4.0 * B
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    ms = timed(lambda: tfa._decode_cuda(q, k, v, lens, D ** -0.5))
    cold = cold_ms(lambda: tfa._decode_cuda(q, k, v, lens, D ** -0.5))
    plain_ms = timed(lambda: tfa.flash_decode(q, k, v, lens,
                                              impl="plain"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    lib_ms = timed(lambda: torch.nn.functional
                   .scaled_dot_product_attention(qt, kt, vt,
                                                 attn_mask=mask))
    splits = decode_splits("flash_decode", B, H, T, D)
    report("decode B%d T%d H%d D%d" % (B, T, H, D),
           "err %.3g live keys %d" % (err, live), ms, plain_ms, lib_ms,
           bound, "bytes")
    print("  %-30s splits %d (%d blocks); one call, device ms: cold L2 %.4f,"
          " warm %.4f; second launch bit-identical %s; NaN past each length"
          " leaves the output bit-identical: %s"
          % ("", splits, B * H * splits, cold[0], cold[1], same, clean_tail))
    if not ok:
        fail("flash_decode disagrees with the plain version")
    if not same:
        fail("flash_decode is not deterministic")
    if not clean_tail:
        fail("flash_decode read past a row's length")
    return dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                library_ms=lib_ms[0], bound_ms=bound, bound_by="bytes",
                cold_ms=cold[0], splits=splits)


def probe_comparison(tfa, args, got, want):
    """Two launches of each backward kernel on one input must give
    bit-identical outputs (no atomics: each block sums in a fixed
    order), and the comparison must fail on a dK with one 64-key tile
    zeroed."""
    again = {"flash_bwd_dkdv": tfa._bwd_cuda("flash_bwd_dkdv", *args),
             "flash_bwd_dq": (tfa._bwd_cuda("flash_bwd_dq", *args),)}
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for kn in got
               for a, b in zip(got[kn], again[kn]))
    bad = got["flash_bwd_dkdv"][0].clone()
    bad[0, 64:128, 0] = 0.0
    tile_err, tile_ok = close(bad, want["flash_bwd_dkdv"][0], BWD_TOL)
    print("  determinism: a second launch of each kernel on the same input"
          " gives bit-identical dk, dv, dq: %s; dK with keys 64-127 of"
          " (b0, h0) zeroed: err %.3g, check %s"
          % (same, tile_err, "passes" if tile_ok else "fails (as it must)"))
    if not same:
        fail("the backward kernels are not deterministic")
    if tile_ok:
        fail("the backward comparison cannot see a planted difference")


def f64_case(tfa, B=2, T=256, H=12, D=64):
    """Each backward kernel's error against torch autograd of dense
    attention in float64, beside the fp32 plain version's own float64
    error, on one causal input (B2 T256)."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(14)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = tfa._fwd_cuda(q, k, v, None, scale, True)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dcap, None, scale, True)
    kern = tfa._bwd_cuda("flash_bwd_dkdv", *args) \
        + (tfa._bwd_cuda("flash_bwd_dq", *args),)
    plain = tfa._torch_bwd_dkdv(*args) + (tfa._torch_bwd_dq(*args),)
    leaves = [x.double().requires_grad_(True) for x in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(tfa.flash_attention(
        *leaves, causal=True, scale=scale, impl="plain"), leaves,
        do.double())
    ref = (dk, dv, dq)
    errs = {}
    for what, outs in (("kernels", kern), ("fp32 plain", plain)):
        errs[what] = [float((a.double() - r).abs().max())
                      for a, r in zip(outs, ref)]
    print("  vs float64 dense autograd at B%d T%d H%d D%d causal, max abs err"
          " dk/dv/dq: kernels %s; fp32 plain versions %s (max |grad| %.3g)"
          % (B, T, H, D, "/".join("%.3g" % e for e in errs["kernels"]),
             "/".join("%.3g" % e for e in errs["fp32 plain"]),
             max(float(r.abs().max()) for r in ref)))
    if not all(e <= BWD_TOL["atol"] for e in errs["kernels"]):
        fail("backward kernels disagree with float64 dense autograd")


def bwd_case(tfa, B, Tq, Tk, H, D, causal, segmented, seed, probe=False):
    """Both backward kernels against their plain versions on one input,
    with a zero cotangent on rows that attend to nothing (a masked
    loss), and the backward of scaled_dot_product_attention as the
    yardstick; with ``probe``, also :func:`probe_comparison`. Returns
    {kernel name: record}."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, do = (torch.randn(B, Tq, H, D, generator=g).to(dev) for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev) for _ in range(2))
    seg = segment_plane(B, Tq, seed, dev) if segmented else None
    scale = D ** -0.5
    if seg is not None:
        do[seg == 0] = 0.0
    o, lse = tfa._fwd_cuda(q, k, v, seg, scale, causal)
    dcap = torch.sum(do * o, dim=-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dcap, seg, scale, causal)
    got = {"flash_bwd_dkdv": tfa._bwd_cuda("flash_bwd_dkdv", *args),
           "flash_bwd_dq": (tfa._bwd_cuda("flash_bwd_dq", *args),)}
    torch.cuda.synchronize()
    want = {"flash_bwd_dkdv": tfa._torch_bwd_dkdv(*args),
            "flash_bwd_dq": (tfa._torch_bwd_dq(*args),)}
    plain = {"flash_bwd_dkdv": lambda: tfa._torch_bwd_dkdv(*args),
             "flash_bwd_dq": lambda: tfa._torch_bwd_dq(*args)}
    # the yardstick: SDPA's backward (dq, dk and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    live = live_mask(B, Tq, Tk, causal, seg, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if seg is None:
        out = sdpa(qt, kt, vt, is_causal=causal)
    else:
        out = sdpa(qt, kt, vt, attn_mask=live[:, None])
    dot = do.transpose(1, 2).contiguous()
    lib_ms = stream_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    pairs = int(live.sum()) * H
    name = "bwd B%d Tq%d Tk%d H%d D%d %s%s" % (
        B, Tq, Tk, H, D, "causal" if causal else "full",
        " seg" if segmented else "")
    # an independent reference: torch autograd of the dense attention
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    dense = torch.autograd.grad(tfa.flash_attention(
        *leaves, causal=causal, segment_ids=seg, impl="plain"), leaves, do)
    del leaves
    kernel_grads = (got["flash_bwd_dq"][0],) + got["flash_bwd_dkdv"]
    dense_errs = [close(a, b, BWD_TOL) for a, b in zip(kernel_grads, dense)]
    print("  %-14s %-34s dq/dk/dv vs torch autograd of dense attention:"
          " max abs err %.3g" % ("both", name,
                                 max(e for e, _ in dense_errs)))
    if not all(ok for _, ok in dense_errs):
        fail("backward kernels disagree with dense autograd: %s" % name)
    if probe:
        probe_comparison(tfa, args, got, want)
    rec = {}
    for kname in ("flash_bwd_dkdv", "flash_bwd_dq"):
        errs = [close(a, b, BWD_TOL) for a, b in zip(got[kname],
                                                     want[kname])]
        err = max(e for e, _ in errs)
        flops = BWD_FLOPS[kname] * D * pairs
        qd, kd = B * Tq * H * D, B * Tk * H * D
        if kname == "flash_bwd_dkdv":     # q, do, k, v, lse, D in; dk, dv out
            nbytes = 4.0 * (2 * qd + 4 * kd + 2 * B * H * Tq)
        else:                              # q, do, k, v, lse, D in; dq out
            nbytes = 4.0 * (3 * qd + 2 * kd + 2 * B * H * Tq)
        if seg is not None:
            nbytes += 4.0 * B * Tq
        # the bound: 3xTF32 on the tensor cores (what the kernels run);
        # beside it the same flops in fp32 on the CUDA cores
        tc_s = TF32_PASSES * flops / PEAK_TF32_FLOPS
        bound = max(tc_s, nbytes / PEAK_BYTES) * 1e3
        bound_fp32 = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES > tc_s else "operations"
        ms = timed(lambda kn=kname: tfa._bwd_cuda(kn, *args))
        plain_ms = timed(plain[kname])
        print("  %-14s %-34s err %.3g | device ms: kernel %.4f plain %.4f |"
              " per-call ms: kernel %.4f plain %.4f | sdpa bwd (dq, dk, dv)"
              " %.4f ms | bound %.2f us 3xTF32 (%s), %.2f us fp32 CUDA"
              " cores | %.1f GFLOP, %.1f MB"
              % (kname, name, err, ms[0], plain_ms[0], ms[1], plain_ms[1],
                 lib_ms, bound * 1e3, bound_by, bound_fp32 * 1e3,
                 flops / 1e9, nbytes / 1e6))
        if not all(ok for _, ok in errs):
            fail("%s disagrees with the plain version: %s" % (kname, name))
        rec[kname] = dict(err=err, ms=ms[0], plain_ms=plain_ms[0],
                          library_ms=lib_ms, bound_ms=bound,
                          bound_by=bound_by, bound_fp32_ms=bound_fp32)
    return rec


def check_flash_grad(tfa):
    """flash_attention on CUDA tensors that require grad returns a tensor
    with a grad_fn, and the gradients that reach q, k and v equal torch
    autograd of the plain version."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v, do = (torch.randn(2, 200, 4, 32, generator=g).to(dev)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    if out.grad_fn is None:
        fail("flash_attention on CUDA returned a tensor with no grad_fn")
    got = torch.autograd.grad(out, leaves, do)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        tfa.flash_attention(*ref, causal=True, impl="plain"), ref, do)
    errs = [close(a, b, BWD_TOL) for a, b in zip(got, want)]
    print("flash_attention on CUDA: grad_fn %s; dq/dk/dv vs torch autograd"
          " of the plain version: max abs err %.3g"
          % (type(out.grad_fn).__name__, max(e for e, _ in errs)))
    if not all(ok for _, ok in errs):
        fail("flash_attention gradients disagree with the plain version")


def phase_bwd_kernels(tfa):
    """The training shapes: the forward kernel at the LM's B8 T1024
    causal, on a packed causal batch, on non-causal cross-attention and
    at D = 30 and D = 128, and against float64; then both backward
    kernels at the same shapes. Returns the forward's main-shape record
    (its error the largest of these cases), the backward kernels'
    main-shape records and the largest error of each backward kernel."""
    H, D = 12, 64
    print("forward kernel (3xTF32 tensor cores) vs plain (fp32, TF32 off,"
          " O and LSE, rtol = atol = %g):" % TOL["rtol"])
    T = GPT2_SMALL["max_len"]
    fwd = fwd_case(tfa, TRAIN_BATCH, T, T, H, D, True, False, seed=10,
                   time_splits=True)
    others = [fwd_case(tfa, 2, 256, 256, H, D, True, True, seed=7),
              fwd_case(tfa, 2, 128, 320, H, D, False, False, seed=13),
              fwd_case(tfa, 1, 100, 150, 3, 30, True, False, seed=15),
              fwd_case(tfa, 1, 160, 96, 2, 128, True, False, seed=16)]
    fwd["err"] = max([fwd["err"]] + [c["err"] for c in others])
    fwd_f64_case(tfa)
    print("backward kernels (3xTF32 tensor cores) vs plain (fp32, TF32 off,"
          " rtol = atol = %g):" % BWD_TOL["rtol"])
    main = bwd_case(tfa, TRAIN_BATCH, 1024, 1024, H, D, True, False,
                    seed=11, probe=True)
    seg = bwd_case(tfa, 2, 256, 256, H, D, True, True, seed=12)
    cross = bwd_case(tfa, 2, 128, 320, H, D, False, False, seed=13)
    # the other staging paths and causal alignments: D = 30 (4-byte
    # granules, padded columns) with Tq < Tk, D = 128 with Tq > Tk
    odd = bwd_case(tfa, 1, 100, 150, 3, 30, True, False, seed=15)
    wide = bwd_case(tfa, 1, 160, 96, 2, 128, True, False, seed=16)
    errs = {kn: max(c[kn]["err"] for c in (main, seg, cross, odd, wide))
            for kn in main}
    print("  both kernels at %s: %.4f ms, sdpa backward %.4f ms; bounds"
          " %.4f ms 3xTF32, %.4f ms fp32 CUDA cores"
          % ("B8 T1024 causal", sum(main[kn]["ms"] for kn in main),
             main["flash_bwd_dkdv"]["library_ms"],
             sum(main[kn]["bound_ms"] for kn in main),
             sum(main[kn]["bound_fp32_ms"] for kn in main)))
    f64_case(tfa)
    check_flash_grad(tfa)
    return fwd, main, errs


def phase_kernels(tfa):
    """The server's shapes: the forward at one prompt (B1) at every rung
    of the server's ladder and at a ragged T 300, each block shape timed;
    the decode kernel over the window of 8 at random lengths and with one
    live stream (one row at T, seven at 1). Returns the forward's T512
    record (its error the largest of the rungs), and the decode record
    at random lengths (its error the larger of the two)."""
    H, D = 12, 64
    print("forward kernel (3xTF32 tensor cores) at the server's prefill"
          " rungs vs plain (O and LSE, rtol = atol = %g):" % TOL["rtol"])
    fwd = {T: fwd_case(tfa, 1, T, T, H, D, True, False, seed=T,
                       time_splits=True) for T in (64, 128, 256, 300, 512)}
    print("decode kernel vs plain (rtol = atol = %g):" % TOL["rtol"])
    dec = decode_case(tfa, 8, 576, H, D, seed=9)
    one = decode_case(tfa, 8, 576, H, D, seed=19,
                      lens_np=[576] + [1] * 7)
    rec = dict(fwd[512], err=max(c["err"] for c in fwd.values()))
    return rec, dict(dec, err=max(dec["err"], one["err"])), fwd


def top2_margin(logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_model(model_k, model_p, params):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(1)
    P, steps = 128, 16
    toks = torch.randint(0, model_k.vocab, (1, P), generator=g).to(dev)
    with torch.no_grad():
        lk, kk, vk = model_k.prefill(params, toks)
        lp, _, _ = model_p.prefill(params, toks)
        err = float((lk - lp).abs().max())
        L, H, Dh = model_k.n_layers, model_k.n_heads, model_k.head_dim
        kc = torch.zeros(L, 1, P + steps, H, Dh, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :P], vc[:, :, :P] = kk, vk
        tok = torch.argmax(lk[0, P - 1])[None]
        for i in range(steps):
            pos = torch.tensor([P + i], device=dev)
            dk, nk, nv = model_k.decode(params, tok, pos, kc, vc)
            dp, _, _ = model_p.decode(params, tok, pos, kc, vc)
            err = max(err, float((dk - dp).abs().max()))
            kc[:, :, P + i], vc[:, :, P + i] = nk, nv
            tok = torch.argmax(dk[0])[None]
    scale = float(lk.abs().max())
    print("model: prefill + %d decode steps, max |logit| %.3g, kernels vs"
          " plain max abs err %.3g (tolerance %g)"
          % (steps, scale, err, LOGIT_ATOL))
    if not err <= LOGIT_ATOL:
        fail("model logits: kernels vs plain differ by %g" % err)
    return err


def greedy_loop(model, params, prompt, n_new, rung, window, T):
    """Server-free greedy generation at the server's shapes: prefill at
    the prompt's rung, then stepwise decode at the window width with
    the request in row 0 of a contiguous cache. Returns the tokens and
    the top-2 logit margin at each."""
    dev = torch.device("cuda", 0)
    L, H, Dh = model.n_layers, model.n_heads, model.head_dim
    P = len(prompt)
    toks = torch.zeros(1, rung, dtype=torch.long, device=dev)
    toks[0, :P] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    with torch.no_grad():
        logits, k, v = model.prefill(params, toks)
        kc = torch.zeros(L, window, T, H, Dh, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, 0, :P], vc[:, 0, :P] = k[:, 0, :P], v[:, 0, :P]
        out = [int(torch.argmax(logits[0, P - 1]))]
        margins = [top2_margin(logits[0, P - 1])]
        tokens = torch.zeros(window, dtype=torch.long, device=dev)
        positions = torch.zeros(window, dtype=torch.long, device=dev)
        while len(out) < n_new:
            pos = P + len(out) - 1
            tokens[0], positions[0] = out[-1], pos
            lg, nk, nv = model.decode(params, tokens, positions, kc, vc)
            kc[:, 0, pos], vc[:, 0, pos] = nk[:, 0], nv[:, 0]
            out.append(int(torch.argmax(lg[0])))
            margins.append(top2_margin(lg[0]))
    return out, margins


def greedy_loop_q8(model, params, prompt, n_new, rung, window, max_pages):
    """:func:`greedy_loop` over an int8 paged cache: the request's K/V
    quantized into pages 1..max_pages of a private int8 pool the way the
    server's pool does it (``scatter_prefill_q8``, then one
    ``scatter_token_q8`` a step) and dequantized by ``gather_pages_q8``
    before each decode step, the request in row 0 of the window."""
    from mxnet_tpu_torch.serving import KVCachePool, kvcache
    dev = torch.device("cuda", 0)
    pool = KVCachePool(model.n_layers, model.n_heads, model.head_dim,
                       page_size=PAGE, n_pages=max_pages + 1, dtype="int8",
                       device=dev)
    table = torch.zeros(window, max_pages, dtype=torch.long, device=dev)
    table[0] = torch.arange(1, max_pages + 1, device=dev)
    P = len(prompt)
    toks = torch.zeros(1, rung, dtype=torch.long, device=dev)
    toks[0, :P] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    planes = ((pool.k, pool.k_scale), (pool.v, pool.v_scale))
    with torch.no_grad():
        logits, k, v = model.prefill(params, toks)
        for (pages, scales), seq in zip(planes, (k, v)):
            kvcache.scatter_prefill_q8(pages, scales, table[0], seq[:, 0], P)
        out = [int(torch.argmax(logits[0, P - 1]))]
        margins = [top2_margin(logits[0, P - 1])]
        tokens = torch.zeros(window, dtype=torch.long, device=dev)
        positions = torch.zeros(window, dtype=torch.long, device=dev)
        while len(out) < n_new:
            tokens[0], positions[0] = out[-1], P + len(out) - 1
            kc, vc = (kvcache.gather_pages_q8(pages, scales, table)
                      for pages, scales in planes)
            lg, nk, nv = model.decode(params, tokens, positions, kc, vc)
            for (pages, scales), new in zip(planes, (nk, nv)):
                kvcache.scatter_token_q8(pages, scales, table, positions,
                                         new)
            out.append(int(torch.argmax(lg[0])))
            margins.append(top2_margin(lg[0]))
    return out, margins


def server_specs(vocab, seed, n=16, prompt=(20, 501), new=(32, 65)):
    """``n`` requests (prompt, new tokens, priority 0/1) drawn from
    ``seed``: prompts of 20..500 tokens, 32..64 new tokens."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, vocab, size=rs.randint(*prompt)),
             int(rs.randint(*new)), i % 2) for i in range(n)]


def check_streams(what, specs, results, reference):
    """Every stream against ``reference(prompt, n) -> (tokens,
    margins)``; a divergence must sit at a top-2 tie."""
    ties = 0
    for i, ((p, _n, _pri), got) in enumerate(zip(specs, results)):
        got = [int(t) for t in got]
        want, margins = reference(p, len(got))
        if got != want:
            step = next(j for j, (a, b) in enumerate(zip(got, want))
                        if a != b)
            print("  %s: request %d diverges at step %d: top-2 margin %.3g"
                  % (what, i, step, margins[step]))
            if margins[step] >= TIE_MARGIN:
                fail("%s: request %d differs from the greedy loop"
                     % (what, i))
            ties += 1
    print("%s: streams equal the greedy loop: %d/%d (%d at a tie)"
          % (what, len(results), len(results), ties))


def check_graphs(what, st, warm, launches, n_layers, captured=True):
    """The fixed program set's oracle on one server's ``stats()`` (``warm``:
    its graphs right after warmup): ``1 + len(ladder)`` captures of the
    serving generation, none during traffic, one replay a step, and
    exact launch counts — each replay adds the layers' launches its
    graph holds, each capture's eager first call launches them once
    (``captured``: the captures fall inside the counted run)."""
    g = st["graphs"]
    want = {"step": 1, "prefill": len(st["ladder"]), "cow": 0}
    if g is None or warm["captures"] != want or g["captures"] != want:
        fail("%s: captures %s after warmup, %s after traffic, want %s"
             % (what, warm and warm["captures"], g and g["captures"], want))
    if g["after_warmup"] or g["recaptures"]:
        fail("%s: %d captures during traffic, %d recaptures"
             % (what, g["after_warmup"], g["recaptures"]))
    if (g["replays"]["step"], g["replays"]["prefill"]) != \
            (st["decode_steps"], st["prefill_steps"]):
        fail("%s: replays %s for %d decode and %d prefill steps"
             % (what, g["replays"], st["decode_steps"],
                st["prefill_steps"]))
    extra = int(captured)
    exact = {"flash_decode": n_layers * (st["decode_steps"] + extra),
             "flash_fwd": n_layers * (st["prefill_steps"]
                                      + extra * len(st["ladder"]))}
    if any(launches[k] != n for k, n in exact.items()):
        fail("%s: launches %s, want %s" % (what, launches, exact))
    print("  %s graphs: captures %s (none in traffic, %d recaptures),"
          " replays %s, launches exact %s; graph memory %s MB"
          % (what, g["captures"], g["recaptures"], g["replays"], exact,
             {k: round(b / 2 ** 20, 1)
              for k, b in g["memory_bytes"].items()}))


def phase_server(model, params, tfa):
    from mxnet_tpu_torch.serving import DecodeServer
    specs = server_specs(model.vocab, seed=0)
    tfa.reset_launches()                  # the main path starts here
    t0 = time.perf_counter()
    srv = DecodeServer(model, params, **SERVER_CFG)
    try:
        srv.warmup()
        t_warm = time.perf_counter() - t0
        warm = srv.stats()["graphs"]
        reqs = [srv.submit(p, max_new_tokens=n, priority=pri)
                for p, n, pri in specs]
        victim = reqs[1]
        deadline = time.monotonic() + 120
        while len(victim.generated) < 8 and not victim.done():
            if time.monotonic() > deadline:
                fail("request 1 made no progress")
            time.sleep(0.001)
        victim.cancel()
        streamed = list(reqs[0].tokens(timeout=120))
        results = [r.result(timeout=300) for r in reqs]
        st = srv.stats()
    finally:
        srv.stop()
    launches = dict(tfa.launches)         # ... and ends here
    wall = time.perf_counter() - t0
    print("server (CUDA graphs): %d requests, warmup %.2f s, serve %.2f s;"
          " tokens/s %.1f, ttft p50 %.2f ms, inter-token p50 %.2f ms;"
          " launches %s" % (len(reqs), t_warm, wall - t_warm,
                            st["tokens_per_sec"], st["ttft_ms"]["p50"],
                            st["inter_token_ms"]["p50"], launches))
    if streamed != [int(t) for t in results[0]]:
        fail("tokens() stream differs from result()")
    if victim.state != "cancelled" or not 8 <= len(results[1]) < \
            specs[1][1]:
        fail("request 1 was not cancelled midway (state %s, %d tokens)"
             % (victim.state, len(results[1])))
    for i, (r, (_p, n, _pri)) in enumerate(zip(reqs, specs)):
        if i != 1 and (r.state != "done" or len(results[i]) != n):
            fail("request %d: state %s, %d/%d tokens"
                 % (i, r.state, len(results[i]), n))
    if st["completed"] != 15 or st["cancelled"] != 1 or st["errors"]:
        fail("server counters: %s" % {k: st[k] for k in
                                      ("completed", "cancelled", "errors")})
    if min(launches[k] for k in SERVER_KERNELS) < 1:
        fail("a kernel of the path never launched: %s" % launches)
    check_graphs("server", st, warm, launches, model.n_layers)
    T = srv._max_pages * SERVER_CFG["page_size"]
    check_streams("server", specs, results, lambda p, n: greedy_loop(
        model, params, p, n, srv._seq_ladder.bucket_for(len(p)),
        SERVER_CFG["window"], T))
    return launches, st


def phase_server_int8(model, params, tfa):
    """Phase 6 over an int8 pool: 16 requests on graphs, each stream held
    to :func:`greedy_loop_q8`. Returns the pool (phase 7 reads it)."""
    from mxnet_tpu_torch.serving import DecodeServer
    os.environ["MXNET_KV_DTYPE"] = "int8"
    try:
        srv = DecodeServer(model, params, **SERVER_CFG)
    finally:
        del os.environ["MXNET_KV_DTYPE"]
    specs = server_specs(model.vocab, seed=1)
    try:
        if not srv._pool.quantized:
            fail("the int8 pool is not quantized")
        tfa.reset_launches()
        srv.warmup()
        warm = srv.stats()["graphs"]
        reqs = [srv.submit(p, max_new_tokens=n, priority=pri)
                for p, n, pri in specs]
        results = [r.result(timeout=300) for r in reqs]
        st = srv.stats()
    finally:
        srv.stop()
    launches = dict(tfa.launches)
    if st["completed"] != len(specs) or any(
            len(o) != n for o, (_p, n, _pri) in zip(results, specs)):
        fail("int8 pool run did not complete: %s" % st["completed"])
    print("server int8 pool (CUDA graphs): %d/%d requests complete,"
          " tokens/s %.1f, ttft p50 %.2f ms, inter-token p50 %.2f ms"
          % (st["completed"], len(specs), st["tokens_per_sec"],
             st["ttft_ms"]["p50"], st["inter_token_ms"]["p50"]))
    check_graphs("server int8 pool", st, warm, launches, model.n_layers)
    check_streams("server int8 pool", specs, results,
                  lambda p, n: greedy_loop_q8(
                      model, params, p, n,
                      srv._seq_ladder.bucket_for(len(p)),
                      SERVER_CFG["window"], srv._max_pages))
    return srv._pool


def write_manifest(prefix, epoch, arrays, split):
    """A checkpoint manifest in the format ``mxnet_tpu_torch.checkpoint``
    reads (the port has no writer yet, the card host no JAX): every entry
    ``arg:<name>`` whole in shard 0 (``prefix-%04d.params``), except
    ``split``, cut by rows into two pieces, the second in shard 1; each
    shard an npz payload with its SHA-256 in ``prefix-%04d.ckpt.json``,
    written last. ``arrays``: {name: host numpy array}."""
    import hashlib
    tag = "%s-%04d" % (prefix, epoch)
    shards, layout = [{}, {}], {}
    for name, arr in arrays.items():
        key = "arg:" + name
        entry = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        if name == split:
            half = arr.shape[0] // 2
            entry["pieces"] = []
            for i, (a, b) in enumerate(((0, half), (half, arr.shape[0]))):
                pkey = "%s::piece%d" % (key, i)
                shards[i][pkey] = arr[a:b]
                entry["pieces"].append({"shard": i, "key": pkey, "index": [
                    [a, b]] + [[0, d] for d in arr.shape[1:]]})
        else:
            shards[0][key] = arr
            entry["pieces"] = [{"shard": 0, "key": key, "index": None}]
        layout[key] = entry
    files, paths = [], []
    for i, roster in enumerate(shards):
        buf = io.BytesIO()
        np.savez(buf, **roster)
        paths.append(tag + (".params" if i == 0 else
                            ".shard%02d-of-%02d.params" % (i, len(shards))))
        with open(paths[-1], "wb") as f:
            f.write(buf.getvalue())
        files.append({"file": os.path.basename(paths[-1]), "shard": i,
                      "sha256": hashlib.sha256(buf.getvalue()).hexdigest(),
                      "bytes": len(buf.getvalue())})
    with open(tag + ".ckpt.json", "w") as f:
        json.dump({"format": 1, "epoch": epoch, "time": time.time(),
                   "shards": files, "params": layout}, f)
    return paths


def phase_swap(model, params):
    """Weight swaps mid-traffic on graphs, with the prefix cache on: 4
    requests stream on generation 1 (the second repeats the first's
    64-token prompt: a full-page prefix hit whose re-fed last token
    copies the shared page, through the copy graph), ``swap_weights``
    flips to a second random dict, 4 more are admitted on generation 2;
    then ``swap_weights(prefix=, epoch=)`` flips to a third dict read
    from a checkpoint manifest (two shard files, one entry in two
    pieces), 4 more are admitted on generation 3, and a manifest with
    one byte of a shard flipped must raise, naming the file, and leave
    the server on generation 3. Each swap adds exactly one generation's
    captures (``1 + len(ladder)``), none during traffic; every stream
    equals the greedy loop under its own weights; the older generations'
    graphs are dropped once their last request finishes."""
    import tempfile
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.serving import DecodeServer
    cfg = dict(SERVER_CFG, seq_ladder=[64, 128])
    params_b = model.init_params(seed=1, device="cuda")
    params_c = model.init_params(seed=2, device="cuda")
    specs = server_specs(model.vocab, seed=3, n=12, prompt=(20, 129),
                         new=(24, 41))
    shared = np.random.RandomState(4).randint(0, model.vocab, size=64)
    specs[:2] = [(shared, 32, 0), (shared, 24, 1)]
    srv = DecodeServer(model, params, prefix_cache=True, **cfg)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        host_c = {k: v.cpu().numpy() for k, v in params_c.items()}
        write_manifest(prefix, 7, host_c, split="embed")
        torn = write_manifest(prefix, 8, host_c, split="embed")[1]
        with open(torn, "r+b") as f:
            f.seek(os.path.getsize(torn) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            n_prog = srv.warmup()
            old = [srv.submit(p, max_new_tokens=n) for p, n, _ in specs[:4]]
            deadline = time.monotonic() + 120
            while min(len(r.generated) for r in old) < 4:
                if time.monotonic() > deadline:
                    fail("swap: generation 1 made no progress")
                time.sleep(0.001)
            srv.swap_weights(params_b)
            inflight = sum(not r.done() for r in old)
            new = [srv.submit(p, max_new_tokens=n) for p, n, _ in specs[4:8]]
            while min(len(r.generated) for r in new) < 4:
                if time.monotonic() > deadline:
                    fail("swap: generation 2 made no progress")
                time.sleep(0.001)
            t0 = time.perf_counter()
            version = srv.swap_weights(prefix=prefix, epoch=7)
            load_ms = (time.perf_counter() - t0) * 1e3
            inflight_b = sum(not r.done() for r in new)
            third = [srv.submit(p, max_new_tokens=n)
                     for p, n, _ in specs[8:]]
            results = [r.result(timeout=300) for r in old + new + third]
            try:
                srv.swap_weights(prefix=prefix, epoch=8)
                fail("swap: a manifest with a torn shard loaded")
            except MXNetError as exc:
                torn_msg = str(exc)
            st = srv.stats()
        finally:
            srv.stop()
    g = st["graphs"]
    print("swap: %d of 4 generation-1 requests streaming at the swap to a"
          " dict, %d of 4 generation-2 at the swap from a manifest (version"
          " %d, %.1f ms to read, check and place %.1f MB); prefix hits %d,"
          " copy-on-write splits %d; graphs %s"
          % (inflight, inflight_b, version, load_ms,
             sum(a.nbytes for a in host_c.values()) / 1e6,
             st["prefix"]["hits"], st["prefix"]["cow_splits"],
             {k: g[k] for k in ("captures", "replays", "after_warmup",
                                "recaptures", "generations", "retired")}))
    print("  torn shard: %s" % torn_msg)
    if os.path.basename(torn) not in torn_msg \
            or st["weight_version"] != 3:
        fail("swap: the torn manifest gave %r, weight version %d"
             % (torn_msg, st["weight_version"]))
    if inflight < 1:
        fail("swap: no generation-1 request was streaming at the swap")
    if g["after_warmup"] != 2 * (n_prog - 1) or g["recaptures"] \
            or g["generations"] != [3] or g["retired"] != 2:
        fail("swap: want %d captures for each of generations 2 and 3, "
             "none again, and generations 1-2 retired: %s"
             % (n_prog - 1, g))
    if g["captures"]["cow"] != 1 or g["replays"]["cow"] < 1 \
            or st["prefix"]["cow_splits"] != g["replays"]["cow"]:
        fail("swap: copy-on-write %s, %d splits"
             % ({k: g[k]["cow"] for k in ("captures", "replays")},
                st["prefix"]["cow_splits"]))
    T = srv._max_pages * cfg["page_size"]
    for what, part, res, tree in (("swap: generation 1", specs[:4],
                                   results[:4], params),
                                  ("swap: generation 2", specs[4:8],
                                   results[4:8], params_b),
                                  ("swap: generation 3 (manifest)",
                                   specs[8:], results[8:], params_c)):
        check_streams(what, part, res, lambda p, n, tree=tree: greedy_loop(
            model, tree, p, n, srv._seq_ladder.bucket_for(len(p)),
            cfg["window"], T))
    del params_b, params_c


def step_inputs(srv):
    """The decode step's inputs over ``srv``'s active requests, as
    ``DecodeServer._decode_group`` builds them."""
    D, M = srv._window, srv._max_pages
    tokens = np.zeros((D,), np.int64)
    positions = np.zeros((D,), np.int64)
    pts = np.zeros((D, M), np.int64)
    for i, r in enumerate(srv._active):
        tokens[i] = r.generated[-1]
        positions[i] = len(r.prompt) + len(r.generated) - 1
        pts[i, :len(r.pages)] = r.pages
    return tokens, positions, pts


STEP_CLASSES = (("attention kernels", ("decode_kernel", "fwd_kernel")),
                ("matmul", ("gemm", "cutlass", "sm90_", "ampere_")),
                ("KV gather/scatter", ("index", "gather", "scatter")))


def profile_steps(fn, steps, classes=STEP_CLASSES):
    """(wall ms a call, device busy ms a call, busy ms by kernel class,
    the top kernels, wall ms a call without the profiler) of ``steps``
    calls of ``fn`` under the profiler (and 4 x ``steps`` without);
    ``classes``: (class, name substrings), first match wins, the rest
    "other"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * steps):
        fn()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) * 1e3 / (4 * steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    by_class, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        kernels.append((us, e.key, e.count))
        name = e.key.lower()
        cls = next((c for c, keys in classes
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
    return (wall, sum(by_class.values()), by_class,
            sorted(kernels, reverse=True), bare)


def phase_step_profile(model, params, card, steps=5):
    """Where one steady decode step's time goes, the step replayed from
    the server's CUDA graph and run eagerly (its capture body,
    ``_decode_step``, with today's host-to-device copies) on the same
    inputs: a full window of 8 requests (prompts of 256) is admitted,
    then ``steps`` calls of each run under the profiler. Prints wall ms
    a step, device busy ms by kernel class and the device's idle share
    of each; the two must give identical tokens, and ``model.decode``
    replayed from a graph must give the eager call's logits. Then the
    same for whole scheduler ticks (``_tick``: admission and
    bookkeeping around one replayed step). Prints the server's graph
    memory."""
    from mxnet_tpu_torch.serving import DecodeServer, kvcache
    srv = DecodeServer(model, params, seq_ladder=[256], max_new_tokens=64,
                       window=8, page_size=16, pool_pages=384, start=False)
    try:
        rs = np.random.RandomState(2)
        reqs = [srv.submit(rs.randint(0, model.vocab, size=256),
                           max_new_tokens=64) for _ in range(8)]
        while srv.stats()["active"] < 8:
            srv._tick()                   # prefills (one per tick)
        srv._tick()
        ver = srv._params
        ins = step_inputs(srv)
        modes = {"graph replay": lambda: srv._run_step(ver, *ins),
                 "eager": lambda: srv._decode_step(
                     ver.tree, *ins).cpu().numpy()}
        toks = {mode: fn() for mode, fn in modes.items()}
        if not np.array_equal(toks["graph replay"], toks["eager"]):
            fail("step: graph replay tokens %s, eager %s"
                 % (toks["graph replay"], toks["eager"]))
        runs = {mode: profile_steps(fn, steps) for mode, fn in modes.items()}
        step = srv._programs._graphs[("step", 0, ver.version)]
        replay_ms = events_ms(lambda: [step.replay() for _ in range(20)]) / 20
        # the logits, which the step graph keeps on the device: a graph of
        # model.decode over the same gathered caches against one eager call
        dev = [torch.from_numpy(a).cuda() for a in ins]
        pool = srv._pool

        def logits():
            with torch.no_grad():
                kc, vc = (kvcache.gather_pages(t, dev[2])
                          for t in (pool.k, pool.v))
                return model.decode(ver.tree, dev[0], dev[1], kc, vc)[0]
        want = logits()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            logits()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = logits()
        graph.replay()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        # whole scheduler ticks around the replayed step: the step's own
        # wall plus the scheduler's Python around it
        ticks = srv.stats()["decode_steps"]
        runs["tick (replay)"] = profile_steps(srv._tick, steps)
        if srv.stats()["decode_steps"] - ticks != 5 * steps:
            fail("step: %d ticks ran %d decode steps"
                 % (5 * steps, srv.stats()["decode_steps"] - ticks))
        mem = srv.stats()["graphs"]["memory_bytes"]
        for r in reqs:
            r.cancel()
    finally:
        srv.stop(drain=False)
    print("decode step (window 8, ~256-token contexts; %s): tokens of the"
          " graph replay and the eager step identical; model.decode logits"
          " graph vs eager max abs diff %.3g; the step graph alone %.3f ms"
          " of device time (CUDA events, 20 replays); graph memory %s MB"
          % (card, diff, replay_ms,
             {k: round(b / 2 ** 20, 1) for k, b in mem.items()}))
    if diff != 0.0:
        fail("step: model.decode from a graph differs from eager by %g"
             % diff)
    for mode, (wall, busy, by_class, kernels, bare) in runs.items():
        print("  %-12s wall %.2f ms, device busy %.2f ms, idle share %.2f"
              " (profiled); wall %.2f ms without the profiler"
              % (mode, wall, busy, 1 - busy / wall if wall else
                 float("nan"), bare))
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print("    %-18s %.3f ms/step" % (cls, ms))
        for us, key, count in kernels[:4]:
            print("    top: %.3f ms/step in %d calls/step  %s"
                  % (us / 1e3 / steps, count // steps, key[:70]))
    return {mode: dict(wall_ms=r[0], busy_ms=r[1], bare_ms=r[4])
            for mode, r in runs.items()}


def consume(reqs, t0):
    """Per-token arrival times of each request, read through its
    ``tokens()`` iterator on a thread of its own (started now)."""
    stamps = [[] for _ in reqs]

    def read(req, out):
        for _tok in req.tokens(timeout=300):
            out.append(time.monotonic() - t0)
    threads = [threading.Thread(target=read, args=(r, s), daemon=True)
               for r, s in zip(reqs, stamps)]
    for t in threads:
        t.start()
    return stamps, threads


def watch_programs(srv, name, log, busy):
    """Wrap ``srv``'s program set so that each capture and replay
    appends ``(name, kind, start, end)`` (monotonic s) to ``log``;
    ``name`` is in the set ``busy`` while one of its captures runs."""
    P = srv._programs
    for kind in ("capture", "replay"):
        def timed_call(*a, _fn=getattr(P, kind), _kind=kind):
            t = time.monotonic()
            if _kind == "capture":
                busy.add(name)
            try:
                return _fn(*a)
            finally:
                busy.discard(name)
                log.append((name, _kind, t, time.monotonic()))
        setattr(P, kind, timed_call)


def phase_router(model, params, tfa):
    """The fleet Router over two port DecodeServers on the card, each
    with its own pool, both on graphs: 16 sessions over two tenants
    (prompts 20..500, 32..64 new tokens). Replica 0 is warmed, replica
    1 is not (the README's Router example), so replica 1 captures its
    1 + len(ladder) programs at its first prefill, on its thread, while
    replica 0 replays; during one of those captures replica 0 swaps to
    a copy of the weights (a second generation with the same values,
    so every stream keeps one greedy reference; ``phase_swap`` holds
    distinct weights): replica 0 captures the new generation at its
    next prefill, behind replica 1's captures (one capture at a time in
    the process), and retires the old one once its rows finish. Once
    replica 1's sessions stream, replica 1 is killed and they fail over
    to replica 0. Zero failed streams, every stream equal to the greedy
    loop; then two more sessions and a graceful drain of replica 0,
    which they outlive. Launch counts zeroed just before the traffic and read just
    after: one replay adds a graph's launches, one capture's eager
    call launches them once."""
    from mxnet_tpu_torch.serving import DecodeServer, Router
    reps = [DecodeServer(model, params, name="replica-%d" % i, **SERVER_CFG)
            for i in range(2)]
    warm, cold = reps
    warm.warmup()
    copy = {k: v.clone() for k, v in params.items()}
    specs = server_specs(model.vocab, seed=5)
    more = server_specs(model.vocab, seed=6, n=2)
    log, busy = [], set()
    for srv, name in ((warm, "warm"), (cold, "cold")):
        watch_programs(srv, name, log, busy)
    before = [s.stats()["graphs"]["captures"] for s in reps]
    tfa.reset_launches()
    t0 = time.monotonic()
    router = Router(reps)
    try:
        reqs = [router.submit(p, max_new_tokens=n,
                              tenant="acme" if i % 2 else "zeta")
                for i, (p, n, _pri) in enumerate(specs)]
        stamps, threads = consume(reqs, t0)
        deadline = time.monotonic() + 120
        # the swap, once replica 0 has replayed 8 times since replica 1
        # began to capture (or once replica 1's last program is
        # captured): after it, replica 0's next prefill needs captures of
        # its own, which wait behind replica 1's
        t_cold = None
        while t_cold is None or sum(
                e[:2] == ("warm", "replay") and e[2] >= t_cold
                for e in list(log)) < 8:
            if t_cold is None and "cold" in busy:
                t_cold = time.monotonic()
            if time.monotonic() > deadline \
                    or cold._programs.captures["step"]:
                break
            time.sleep(0.0002)
        t_swap = time.monotonic()
        warm.swap_weights(copy)
        t_swapped = time.monotonic()
        # the kill, once every session bound to replica 1 streams (its
        # captures done; replica 0's later sessions may still wait for
        # their own captures, behind replica 1's)
        victim = next(r for r in router.replicas_up() if r.server is cold)
        while True:
            on_victim = [q for q in reqs if q._replica is victim]
            if on_victim and min(len(q.emitted) for q in on_victim) >= 2:
                break
            if time.monotonic() > deadline:
                fail("router: replica-1's sessions made no progress")
            time.sleep(0.001)
        n_bound = len(on_victim)
        victim.kill()
        results = [q.result(timeout=300) for q in reqs]
        st = router.stats()
        survivor = router.replicas_up()[0]
        extra = [router.submit(p, max_new_tokens=n) for p, n, _ in more]
        deadline = time.monotonic() + 120
        while min(len(q.emitted) for q in extra) < 2:
            if time.monotonic() > deadline:
                fail("router: sessions on the survivor made no progress")
            time.sleep(0.002)
        router.drain(survivor.name, wait=True)
        results += [q.result(timeout=300) for q in extra]
        st2 = router.stats()
        for t in threads:
            t.join(60)
    finally:
        router.stop()
    launches = dict(tfa.launches)
    rep_st = [s.stats() for s in reps]
    ttft = [s[0] * 1e3 for s in stamps if s]
    gaps = [(b - a) * 1e3 for s in stamps for a, b in zip(s, s[1:])]
    spans = [(a, b) for n, k, a, b in log if (n, k) == ("cold", "capture")]
    inside = sum(any(a <= t < b for a, b in spans)
                 for n, k, t, _e in log if (n, k) == ("warm", "replay"))
    swap_in = any(a < t_swapped and t_swap < b for a, b in spans)
    print("router: 2 replicas (replica-1 unwarmed), %d sessions, replica"
          " %s killed mid-stream (%d sessions bound); failed %d, completed"
          " %d, failovers %d, replay tokens %d, resume p50 %.2f ms; ttft"
          " p50 %.2f ms, inter-token p50 %.2f ms (client side); launches"
          " %s" % (len(reqs), victim.name, n_bound, st["failed"],
                   st["completed"], st["failovers"], st["replay_tokens"],
                   st.get("failover_resume_ms", {}).get("p50", float("nan")),
                   statistics.median(ttft), statistics.median(gaps),
                   launches))
    print("  captures beside replays: replica-1 captured %d programs in"
          " %.1f ms (%.1f-%.1f ms after the first submit), replica-0"
          " replayed %d times inside them; replica-0's swap (%.2f ms,"
          " at %.1f ms) %s a replica-1 capture"
          % (len(spans), sum(b - a for a, b in spans) * 1e3,
             (min(a for a, _ in spans) - t0) * 1e3 if spans else 0,
             (max(b for _, b in spans) - t0) * 1e3 if spans else 0,
             inside, (t_swapped - t_swap) * 1e3, (t_swap - t0) * 1e3,
             "overlapped" if swap_in else "did not overlap"))
    print("  router stats after the drain: %s" % json.dumps(
        {k: st2[k] for k in ("replicas", "replicas_up", "completed",
                             "failed", "failovers", "replicas_lost",
                             "drains", "drain_timeouts", "dispatched",
                             "replay_tokens", "tenants")}))
    for s in rep_st:
        g = s["graphs"]
        print("  %s graphs: %s" % (s["name"], {k: g[k] for k in (
            "captures", "replays", "after_warmup", "recaptures",
            "generations", "retired")}))
    if st["failed"] or st["completed"] != len(reqs) \
            or st["replicas_lost"] != 1 or st["failovers"] != n_bound \
            or n_bound < 1:
        fail("router: %d bound to the victim, %s" % (n_bound, {
            k: st[k] for k in ("failed", "completed", "replicas_lost",
                               "failovers")}))
    if any(q.failovers for q in extra) or survivor.server is not warm \
            or survivor.state != "drained" or st2["failed"] \
            or st2["completed"] != len(reqs) + len(extra):
        fail("router drain: survivor %s %s, %s" % (
            survivor.name, survivor.state, {
                k: st2[k] for k in ("failed", "completed", "failovers")}))
    n_prog = 1 + len(SERVER_CFG["seq_ladder"])
    gw, gc = rep_st[0]["graphs"], rep_st[1]["graphs"]
    if gc["after_warmup"] or gc["recaptures"] \
            or sum(gc["captures"].values()) != n_prog \
            or not gc["replays"]["step"]:
        fail("router: replica-1 (unwarmed) graphs %s" % gc)
    if gw["after_warmup"] != n_prog or gw["recaptures"] \
            or gw["generations"] != [2] or gw["retired"] != 1:
        fail("router: replica-0 wants one generation's captures after the"
             " swap, none again, generation 1 retired: %s" % gw)
    if not inside:
        fail("router: replica-0 never replayed while replica-1 captured")
    exact = {}
    for kernel, site, steps in (("flash_decode", "step", "decode_steps"),
                                ("flash_fwd", "prefill", "prefill_steps")):
        exact[kernel] = model.n_layers * sum(
            s[steps] + s["graphs"]["captures"][site] - b[site]
            for s, b in zip(rep_st, before))
    if any(launches[k] != n for k, n in exact.items()):
        fail("router: launches %s, want %s" % (launches, exact))
    T = reps[0]._max_pages * SERVER_CFG["page_size"]
    check_streams("router", specs + more, results, lambda p, n: greedy_loop(
        model, params, p, n, reps[0]._seq_ladder.bucket_for(len(p)),
        SERVER_CFG["window"], T))
    return launches


OBS_CFG = dict(seq_ladder=[64, 128], max_new_tokens=64, window=8,
               page_size=16, pool_pages=384)
OBS_ENV = ("MXNET_TELEMETRY_FILE", "MXNET_TRACE", "MXNET_METRICS_PORT",
           "MXNET_METRICS_HOST", "MXNET_WATCHDOG", "MXNET_FLIGHTREC_DIR",
           "MXNET_METER_FILE")
SCRAPE_S = 0.1


def arm_everything(tmp):
    """Arm every observability subsystem from the environment, as an
    operator does, into ``tmp``: the telemetry run (sink), the tracer, the
    flight recorder, /metrics on 127.0.0.1 (an ephemeral port) and the
    SLO watchdog (all four by ``telemetry.start``), and the meter with a
    ledger. Returns the /metrics port."""
    from mxnet_tpu_torch import livemetrics, metering, telemetry
    os.environ.update({
        "MXNET_TELEMETRY_FILE": os.path.join(tmp, "telemetry.jsonl"),
        "MXNET_TRACE": "1", "MXNET_METRICS_PORT": "0",
        "MXNET_METRICS_HOST": "127.0.0.1", "MXNET_WATCHDOG": "1",
        "MXNET_FLIGHTREC_DIR": os.path.join(tmp, "flightrec"),
        "MXNET_METER_FILE": os.path.join(tmp, "meter", "usage.jsonl")})
    os.makedirs(os.path.join(tmp, "meter"))
    telemetry.reset()
    telemetry.start(run_id="observability")
    metering.start(name="fleet")
    return livemetrics.server_port()


def disarm_everything():
    """Stop what :func:`arm_everything` armed (the sink's summary, the
    ledger's last lines) and clear the environment."""
    from mxnet_tpu_torch import (flightrec, livemetrics, metering,
                                 telemetry, tracing)
    metering.stop()
    telemetry.stop()
    tracing.reset()
    flightrec.disable()
    livemetrics.disable_watchdog()
    livemetrics.stop_server()
    for key in OBS_ENV:
        os.environ.pop(key, None)


def scraper(port, pages):
    """A client thread scraping /metrics every ``SCRAPE_S``, appending
    ``(start, end, page)`` (monotonic s around each request) to
    ``pages``. Returns ``end()``, which stops the thread and fails the
    run if a scrape raised (an HTTP error, a reset connection) or the
    thread did not stop; later calls do nothing."""
    import urllib.request
    stop = threading.Event()
    errors = []

    def run():
        try:
            while not stop.is_set():
                t = time.monotonic()
                page = urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port,
                    timeout=10).read().decode("utf-8")
                pages.append((t, time.monotonic(), page))
                stop.wait(SCRAPE_S)
        except Exception as exc:          # noqa: BLE001 — end() fails
            errors.append(exc)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def end():
        if stop.is_set():
            return
        stop.set()
        thread.join(30)
        if thread.is_alive():
            fail("observability: the /metrics scraper did not stop")
        if errors:
            fail("observability: a /metrics scrape failed: %r" % errors[0])
    return end


def parse_metrics(page, counters=None):
    """{series with labels: value} of one Prometheus text page; a line
    that does not parse fails the run. The families the page types as
    counters are added to the set ``counters`` when one is given."""
    out = {}
    for line in page.splitlines():
        if line.startswith("# TYPE ") and line.endswith(" counter") \
                and counters is not None:
            counters.add(line.split()[2])
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) "
                     r"([-+0-9.eEinfa]+)$", line)
        if m is None:
            fail("observability: unparseable /metrics line %r" % line)
        out[m.group(1)] = float(m.group(2))
    return out


ARM_TURNS = ("disarmed", "armed", "armed+scrape", "armed+scrape", "armed",
             "disarmed") * 2


def tick_server(model, params, ticks):
    """Phase 9's server (ladder [256], window 8, page 16, 384 pages),
    unstarted and warmed, with the budget for ``ticks`` timed ticks."""
    from mxnet_tpu_torch.serving import DecodeServer
    srv = DecodeServer(model, params, seq_ladder=[256],
                       max_new_tokens=ticks + 16, window=8, page_size=16,
                       pool_pages=384, start=False)
    srv.warmup()
    return srv


def tick_turn(srv, vocab, rs, ticks, mode):
    """One turn on :func:`tick_server`'s server: arm per ``mode``
    (disarmed, armed, or armed+scrape: armed with the /metrics scrape
    thread during the timed ticks), admit 8 fresh requests (prompts of
    256), time ``ticks`` scheduler ticks around the replayed step one by
    one (their mean is phase 9's unprofiled reading), read the
    inter-token p50 the server recorded in them, cancel and disarm.
    Returns (mean tick ms, median tick ms, inter-token p50 ms, the ms
    of each scrape, request to page read)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        port = arm_everything(tmp) if mode != "disarmed" else None
        reqs = [srv.submit(rs.randint(0, vocab, size=256),
                           max_new_tokens=ticks + 16) for _ in range(8)]
        while srv.stats()["active"] < 8:
            srv._tick()
        srv._tick()
        pages = []
        end_scrape = scraper(port, pages) \
            if mode == "armed+scrape" else None
        n0 = srv.stats()["tokens_out"]
        walls = []
        torch.cuda.synchronize()
        for _ in range(ticks):
            t0 = time.perf_counter()
            srv._tick()                   # ends on the tokens' copy back
            walls.append((time.perf_counter() - t0) * 1e3)
        # each token of a timed tick is one inter-token interval (the
        # ring is bounded: read its newest entries)
        gaps = list(srv._intervals)[n0 - srv.stats()["tokens_out"]:]
        if end_scrape is not None:
            end_scrape()
        for r in reqs:
            r.cancel()
        while srv.stats()["active"]:
            srv._tick()
        if mode != "disarmed":
            disarm_everything()
    if mode == "armed+scrape" and not pages:
        fail("observability: no scrape during a timed turn")
    return (statistics.mean(walls), statistics.median(walls),
            statistics.median(gaps), [(b - a) * 1e3 for a, b, _p in pages])


def arming_cost(model, params, card, ticks=100):
    """The cost of arming on one warmed server (:func:`tick_server`), in
    the turns of ``ARM_TURNS`` (each mode before and after each other,
    twice). Returns {mode: [:func:`tick_turn`'s readings, ...]}."""
    srv = tick_server(model, params, ticks)
    rs = np.random.RandomState(12)
    out = {}
    try:
        for mode in ARM_TURNS:
            out.setdefault(mode, []).append(
                tick_turn(srv, model.vocab, rs, ticks, mode))
    finally:
        srv.stop(drain=False)
    print("observability: cost of arming on one warmed server (phase 9's:"
          " window 8, ~256-token contexts, %d ticks a turn, turns %s; %s):"
          % (ticks, ", ".join(ARM_TURNS), card))
    for mode, turns in out.items():
        print("  %-13s tick wall ms mean %s (median %s); inter-token p50"
              " ms %s%s" % (
                  mode, " / ".join("%.3f" % t[0] for t in turns),
                  " / ".join("%.3f" % t[1] for t in turns),
                  " / ".join("%.3f" % t[2] for t in turns),
                  "" if mode != "armed+scrape" else "; scrapes %s, ms"
                  " a scrape median %s, max %s" % (
                      " / ".join(str(len(t[3])) for t in turns),
                      " / ".join("%.3f" % statistics.median(t[3])
                                 for t in turns),
                      " / ".join("%.3f" % max(t[3]) for t in turns))))
        print("  %-13s medians of the turns: tick mean %.3f, tick median"
              " %.3f, inter-token p50 %.3f ms" % (
                  "", *(statistics.median(t[i] for t in turns)
                        for i in range(3))))
    return out


def fleet_specs(vocab, seed):
    """Phase 12's 8 sessions: tenant acme's four share a 32-token (two
    page) prefix, tenant zeta's four are random; prompts 40..96 tokens,
    24..40 new."""
    rs = np.random.RandomState(seed)
    base = rs.randint(0, vocab, size=32)
    specs = []
    for i in range(8):
        n = int(rs.randint(40, 97))
        p = np.concatenate([base, rs.randint(0, vocab, size=n - 32)]) \
            if i % 2 else rs.randint(0, vocab, size=n)
        specs.append((p, int(rs.randint(24, 41)), "acme" if i % 2
                      else "zeta"))
    return specs


def joined_spans(events, reqs):
    """Per session: its router- and replica-side spans under its request
    id, in causal order (router queue first; where a prefill ran, the
    replica's queue, then the prefill, then the decode span). Returns the
    number of sessions that joined."""
    spans = {}
    for e in events:
        rid = (e.get("args") or {}).get("request_id")
        if e.get("ph") == "X" and rid is not None:
            spans.setdefault(rid, {}).setdefault(
                (e["cat"], e["name"]), []).append(e["ts"])
    for q in reqs:
        got = {k: min(v) for k, v in spans.get(q.request_id, {}).items()}
        if ("router", "queue") not in got or ("decode", "decode") not in got:
            fail("observability: session %s lacks joined spans: %s"
                 % (q.request_id, sorted(got)))
        first_decode = min(t for (cat, _n), t in got.items()
                           if cat == "decode")
        order = [got["router", "queue"], first_decode]
        if ("decode", "prefill") in got:
            order += [got["decode", "queue"], got["decode", "prefill"]]
        if order != sorted(order):
            fail("observability: session %s spans out of causal order: %s"
                 % (q.request_id, got))
    return len(reqs)


def reconcile_lines(js):
    """Every ``reconciled``/``ok`` verdict in a diagnose JSON report
    (key path, value)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "reconciled":
                    out.append((path + "/" + k, v))
                walk(v, path + "/" + k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, "%s/%d" % (path, i))
    walk(js, "")
    return out


def observability_drill(model, params, tfa, card):
    """Phase 12's drill: everything armed from the environment, a Router
    over two DecodeServers (each its own pool, prefix cache on), 8
    sessions from two tenants, /metrics scraped every 100 ms from a
    client thread; one replica killed once its sessions stream, then the
    survivor drained. Replica obs-0 is warmed, obs-1 is not: obs-1
    captures its programs at its first prefill while the scrapes read
    its ``stats()``. Every page scraped while the traffic ran must carry
    the router's series and each live replica's, with no counter going
    down, and one scrape must overlap a capture. Launch counts zeroed
    just before the traffic and read just after. Returns the
    launches."""
    import tempfile
    import urllib.request
    from mxnet_tpu_torch import flightrec, metering, tracing
    from mxnet_tpu_torch.serving import DecodeServer, Router
    from mxnet_tpu_torch.tools import diagnose
    with tempfile.TemporaryDirectory() as tmp:
        t_phase = time.perf_counter()
        port = arm_everything(tmp)
        sink = os.environ["MXNET_TELEMETRY_FILE"]
        bundles_dir = os.environ["MXNET_FLIGHTREC_DIR"]
        ledger = os.environ["MXNET_METER_FILE"]
        # a record every tick: the lost replica's last record holds every
        # session dispatched to it, so the fleet report can reconcile
        reps = [DecodeServer(model, params, name="obs-%d" % i,
                             prefix_cache=True, record_every=1, **OBS_CFG)
                for i in range(2)]
        reps[0].warmup()
        log, busy = [], set()
        watch_programs(reps[1], "cold", log, busy)
        costs = [srv.program_costs() for srv in reps]
        specs = fleet_specs(model.vocab, seed=8)
        before = [s.stats() for s in reps]
        tfa.reset_launches()              # this slice's path starts here
        router = Router(reps, name="obs-front")
        pages = []
        end_scrape = scraper(port, pages)
        try:
            t0 = time.monotonic()
            reqs = [router.submit(p, max_new_tokens=n, tenant=t)
                    for p, n, t in specs[:2]]
            deadline = time.monotonic() + 120
            while min(len(q.emitted) for q in reqs) < 1:
                if time.monotonic() > deadline:
                    fail("observability: the first sessions made no"
                         " progress")
                time.sleep(0.002)
            reqs += [router.submit(p, max_new_tokens=n, tenant=t)
                     for p, n, t in specs[2:]]
            stamps, readers = consume(reqs, t0)
            # the kill, once every session streams (each dispatch is in
            # its replica's records by then)
            while min(len(q.emitted) for q in reqs) < 2:
                if time.monotonic() > deadline:
                    fail("observability: the sessions made no progress")
                time.sleep(0.001)
            victim = next((q._replica for q in reqs
                           if not q.done() and q._replica is not None),
                          None)
            if victim is None:
                fail("observability: no replica with streaming sessions"
                     " to kill")
            # at most these re-home: one may finish before the loss is
            # confirmed
            n_bound = sum(q._replica is victim and not q.done()
                          for q in reqs)
            victim.kill()
            t_kill = time.monotonic()
            results = [q.result(timeout=300) for q in reqs]
            for t in readers:
                t.join(60)
            t_done = time.monotonic()
            end_scrape()
            st = router.stats()
            rep_st = [s.stats() for s in reps]
            final = parse_metrics(urllib.request.urlopen(
                "http://127.0.0.1:%d/metrics" % port, timeout=10).read()
                .decode("utf-8"))
            launches = dict(tfa.launches)     # ... and ends here
            survivor = router.replicas_up()[0]
            router.drain(survivor.name, wait=True)
        finally:
            try:
                end_scrape()
            finally:
                router.stop()
        snap = metering.snapshot()
        events = tracing.export()["traceEvents"]
        trace_stats = tracing.stats()
        fr = flightrec.stats()
        disarm_everything()
        t_traffic = time.perf_counter() - t_phase
        # -- streams and the router
        if st["failed"] or st["completed"] != len(reqs) \
                or st["replicas_lost"] != 1 \
                or not 1 <= st["failovers"] <= n_bound:
            fail("observability: router %s, %d bound to the victim" % ({
                k: st[k] for k in ("failed", "completed", "replicas_lost",
                                   "failovers")}, n_bound))
        T = reps[0]._max_pages * OBS_CFG["page_size"]
        check_streams("observability", [(p, n, 0) for p, n, _t in specs],
                      results, lambda p, n: greedy_loop(
                          model, params, p, n,
                          reps[0]._seq_ladder.bucket_for(len(p)),
                          OBS_CFG["window"], T))
        # -- launches: every step and prefill replayed its graph, and
        # each of obs-1's captures launched its kernels once
        exact = {k: model.n_layers * sum(
            a[key] - b[key] + a["graphs"]["captures"][site]
            - b["graphs"]["captures"][site] for a, b in zip(rep_st, before))
            for k, site, key in (("flash_decode", "step", "decode_steps"),
                                 ("flash_fwd", "prefill", "prefill_steps"))}
        if any(launches[k] != n or not n for k, n in exact.items()):
            fail("observability: launches %s, want %s" % (launches, exact))
        # -- one flight-recorder bundle, carrying the replica_lost alert
        bundles = flightrec.list_bundles(bundles_dir)
        if len(bundles) != 1 or fr["failed"]:
            fail("observability: %d bundles (want 1), recorder %s"
                 % (len(bundles), fr))
        bundle = flightrec.read_bundle(bundles[0])
        if (bundle["alert"] or {}).get("kind") != "replica_lost" \
                or bundle["alert"]["replica"] != victim.name \
                or bundle["alert"]["sessions"] != st["failovers"]:
            fail("observability: bundle alert %s" % bundle["alert"])
        sites = bundle["compile_sites"]
        # -- spans joined under each session's request id
        joined = joined_spans(events, reqs)
        # -- the usage ledger reconciles
        lines = [json.loads(line) for line in open(ledger)]
        hits = sum(s["prefix"]["hit_tokens"] for s in rep_st)
        gen = sum(len(r) for r in results)
        if not snap["reconcile"]["ok"] or len(lines) != len(reqs) \
                or snap["totals"]["generated_tokens"] != gen \
                or sum(x["generated_tokens"] for x in lines) != gen \
                or snap["totals"]["replay_tokens"] != st["replay_tokens"] \
                or snap["totals"]["prefix_hit_tokens"] != hits \
                or not snap["totals"]["page_seconds"] > 0:
            fail("observability: usage %s, %d ledger lines, %d tokens,"
                 " %d hit tokens" % (snap["totals"], len(lines), gen, hits))
        # -- FLOPs and bytes billed: program counts x dispatches
        want_f = want_b = 0.0
        for s, b, c in zip(rep_st, before, costs):
            g, g0 = s["graphs"], b["graphs"]
            n_step = g["replays"]["step"] - g0["replays"]["step"]
            want_f += n_step * c["step"][0]
            want_b += n_step * c["step"][1]
            for rung, n in g["prefill_replays"].items():
                n -= g0["prefill_replays"].get(rung, 0)
                want_f += n * c["prefill"][rung][0]
                want_b += n * c["prefill"][rung][1]
        got_f, got_b = snap["totals"]["flops"], snap["totals"]["bytes"]
        if abs(got_f - want_f) > 1e-9 * want_f \
                or abs(got_b - want_b) > 1e-9 * want_b:
            fail("observability: billed %.6g FLOPs / %.6g bytes, program"
                 " counts x dispatches %.6g / %.6g"
                 % (got_f, got_b, want_f, want_b))
        # -- the last scrape agrees with stats()
        lab = '{router="obs-front"}'
        for key in ("requests", "dispatched", "completed", "failed",
                    "failovers", "replay_tokens", "replicas_lost"):
            if final.get("mxnet_router_%s_total%s" % (key, lab)) != st[key]:
                fail("observability: scrape router %s %s, stats %s" % (
                    key, final.get("mxnet_router_%s_total%s" % (key, lab)),
                    st[key]))
        for s in rep_st:
            slab = '{server="%s"}' % s["name"]
            if s["name"] == victim.name:
                if "mxnet_decode_requests_total" + slab in final:
                    fail("observability: the lost replica is still scraped")
                continue
            for key in ("requests", "completed", "prefill_steps",
                        "decode_steps", "tokens_out"):
                got = final.get("mxnet_decode_%s_total%s" % (key, slab))
                if got != s[key]:
                    fail("observability: scrape decode %s %s, stats %s"
                         % (key, got, s[key]))
        # -- every page scraped while the traffic ran carries the router
        # and each live replica, counters never go down, and one scrape
        # overlapped obs-1's captures
        counters = set()
        scraped = [(a, b, parse_metrics(page, counters))
                   for a, b, page in pages]
        during = [(a, b, m) for a, b, m in scraped if t0 <= a < t_done]
        if not during:
            fail("observability: no scrape while the traffic ran")
        survivor_name = next(s.name for s in reps if s.name != victim.name)
        for a, b, m in during:
            live = [survivor_name] + ([victim.name] if b < t_kill else [])
            want = ['mxnet_router_%s_total{router="obs-front"}' % key
                    for key in ("requests", "dispatched", "completed",
                                "failed", "failovers", "replay_tokens",
                                "replicas_lost")]
            want += ['mxnet_decode_%s_total{server="%s"}' % (key, name)
                     for name in live for key in (
                         "requests", "completed", "prefill_steps",
                         "decode_steps", "tokens_out")]
            missing = [k for k in want if k not in m]
            if missing:
                fail("observability: a scrape %.1f ms into the traffic"
                     " lacks %s" % ((a - t0) * 1e3, missing))
        for (_a, _b, prev), (a, _b2, cur) in zip(scraped, scraped[1:]):
            down = [k for k, v in cur.items()
                    if k.split("{")[0] in counters and k in prev
                    and v < prev[k]]
            if down:
                fail("observability: counters went down in a scrape %.1f"
                     " ms into the traffic: %s" % ((a - t0) * 1e3, {
                         k: (prev[k], cur[k]) for k in down}))
        captures = [(a, b) for _n, kind, a, b in log if kind == "capture"]
        overlap = sum(any(a < cb and ca < b for ca, cb in captures)
                      for a, b, _m in scraped)
        if not overlap:
            fail("observability: no scrape overlapped obs-1's %d captures"
                 % len(captures))
        scrape_ms = [(b - a) * 1e3 for a, b, _m in scraped]
        # -- diagnose on the sink and on the directory: every reconcile
        # line OK
        # the entry point once, on the directory (the fleet report);
        # the sink's report in this process
        t_diag = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.diagnose", tmp,
             "--format", "json"], capture_output=True, text=True,
            timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode != 0:
            fail("observability: diagnose %s: %s" % (tmp, out.stderr[-800:]))
        diag_out = {tmp: json.loads(out.stdout)}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            diagnose.main([sink, "--format", "json"])
        diag_out[sink] = json.loads(buf.getvalue())
        verdicts = reconcile_lines(diag_out[sink]) \
            + reconcile_lines(diag_out[tmp])
        if not verdicts or not all(v is True for _k, v in verdicts):
            fail("observability: diagnose reconcile lines %s" % verdicts)
        fleet = diag_out[tmp]["serving"]
        if fleet["replicas_lost"] != 1 or fleet["replica_lost_alerts"] != 1 \
                or len(diag_out[tmp]["bundles"]) != 1:
            fail("observability: fleet report %s, %d bundles" % (
                fleet, len(diag_out[tmp]["bundles"])))
        t_diag = time.perf_counter() - t_diag
        kinds = {}
        for line in open(sink):
            kind = json.loads(line)["type"]
            kinds[kind] = kinds.get(kind, 0) + 1
        if kinds.get("memory", 0) < 1:
            fail("observability: no memory record read from the card")
    gaps = [(b - a) * 1e3 for s in stamps for a, b in zip(s, s[1:])]
    ttft = [s[0] * 1e3 for s in stamps if s]
    print("observability: router over 2 replicas (GPT-2-small width, %d"
          " layers, ladder %s, window %d), %d sessions of 2 tenants,"
          " replica %s killed (%d sessions streaming on it); failed %d,"
          " completed %d, failovers %d; client ttft p50 %.2f ms,"
          " inter-token p50 %.2f ms;"
          " launches %s; %s" % (model.n_layers, OBS_CFG["seq_ladder"],
                                OBS_CFG["window"], len(reqs), victim.name,
                                n_bound, st["failed"], st["completed"],
                                st["failovers"], statistics.median(ttft),
                                statistics.median(gaps), launches, card))
    print("  armed: sink records %s; trace %s; 1 flight-recorder bundle"
          " (%s, %d records, %d trace events); %d/%d sessions' spans"
          " joined; %d scrapes every %.0f ms (%d while the traffic ran,"
          " each with the router's and the live replicas' counters, none"
          " going down; %d overlapping obs-1's %d captures; ms a scrape"
          " median %.3f, max %.3f), the last equal to stats()"
          % (json.dumps(kinds, sort_keys=True), trace_stats,
             bundle["alert"]["kind"], len(bundle["records"]),
             len(bundle["trace"]["traceEvents"]), joined, len(reqs),
             len(pages), SCRAPE_S * 1e3, len(during), overlap,
             len(captures), statistics.median(scrape_ms), max(scrape_ms)))
    print("  usage: reconciled %s; tokens %d prompt + %d generated, %d"
          " replayed, %d prefix-credited; page-seconds %.4f; billed %.6g"
          " FLOPs, %.6g bytes = program counts x dispatches"
          % (snap["reconcile"]["ok"], snap["totals"]["prompt_tokens"], gen,
             snap["totals"]["replay_tokens"], hits,
             snap["totals"]["page_seconds"], got_f, got_b))
    print("  program counts: step %.6g FLOPs / %.6g bytes (%.6g / %.6g a"
          " row, window %d); prefill %s; bundle compile_sites %s"
          % (costs[0]["step"][0], costs[0]["step"][1],
             costs[0]["step"][0] / OBS_CFG["window"],
             costs[0]["step"][1] / OBS_CFG["window"], OBS_CFG["window"],
             ", ".join("rung %d %.6g FLOPs / %.6g bytes (%.6g / %.6g a"
                       " token)" % (r, f, b, f / r, b / r)
                       for r, (f, b) in sorted(costs[0]["prefill"].items())),
             json.dumps(sites, sort_keys=True)))
    print("  diagnose --format json: %d reconcile lines, all OK (%.1f s);"
          " armed %.1f s (warmups and traffic)"
          % (len(verdicts), t_diag, t_traffic))
    return launches


def phase_observability(model, params, tfa, card):
    """Phase 12: the cost of arming on one warmed server, then the armed
    fleet drill. Returns the drill's launches."""
    t0 = time.perf_counter()
    arming_cost(model, params, card)
    launches = observability_drill(model, params, tfa, card)
    print("observability: phase 12 %.1f s" % (time.perf_counter() - t0))
    return launches


def gluon_lm(mx):
    """The training model, a user script of the port's Gluon: the pre-LN
    decoder of ToyDecoderLM.prefill composed from Embedding, LayerNorm,
    MeshMultiHeadAttention and Dense blocks."""
    nn = mx.gluon.nn

    class DecoderLayer(mx.gluon.HybridBlock):
        def __init__(self, units, heads, d_ff, impl, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.ln1 = nn.LayerNorm()
                self.attn = mx.gluon.contrib.nn.MeshMultiHeadAttention(
                    units, heads, causal=True, use_bias=False, impl=impl)
                self.ln2 = nn.LayerNorm()
                self.ffn1 = nn.Dense(d_ff, activation="relu", use_bias=False,
                                     flatten=False)
                self.ffn2 = nn.Dense(units, use_bias=False, flatten=False)
            self.relu_masks = None    # a list: keeps each pass's ReLU mask

        def hybrid_forward(self, F, x):
            h = x + self.attn(self.ln1(x))
            a = self.ffn1(self.ln2(h))
            if self.relu_masks is not None:
                self.relu_masks.append(a > 0)
            return h + self.ffn2(a)

    class DecoderLM(mx.gluon.HybridBlock):
        def __init__(self, vocab, units, heads, layers, d_ff, max_len,
                     impl="auto", **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, units)
                self.pos = nn.Embedding(max_len, units)
                self.layers = nn.HybridSequential()
                with self.layers.name_scope():
                    for _ in range(layers):
                        self.layers.add(DecoderLayer(units, heads, d_ff,
                                                     impl))
                self.ln_f = nn.LayerNorm()
                self.head = nn.Dense(vocab, use_bias=False, flatten=False)

        def hybrid_forward(self, F, tokens, positions):
            h = self.embed(tokens) + self.pos(positions)
            return self.head(self.ln_f(self.layers(h)))

    return DecoderLM


def shared_relu(mx):
    """A ReLU block that applies a given 0/1 mask instead of its input's
    sign, and counts the positions where the two disagree (``flips``)."""

    class SharedReLU(mx.gluon.nn.Activation):
        def __init__(self, mask, **kwargs):
            super().__init__("relu", **kwargs)
            self.mask, self.flips = mask, 0

        def hybrid_forward(self, F, x):
            self.flips = int(((x > 0) != self.mask).sum().asscalar())
            return x * self.mask

    return SharedReLU


def grad_ratios(src, twin):
    """max|diff| / max|grad| per parameter: ``src``'s gradients (by
    structural name) against ``twin``'s."""
    out = {}
    for name, p in twin._collect_params_with_prefix().items():
        gd, gk = p.grad()._data, src[name].grad()._data
        out[name] = float((gk - gd).abs().max()
                          / gd.abs().max().clamp_min(1e-30))
    return out


def print_groups(ratios):
    for group, keys in (("attention", ("attn.",)),
                        ("ffn1", ("ffn1.",)), ("ffn2", ("ffn2.",)),
                        ("other", ())):
        names = [n for n in ratios if any(k in n for k in keys)] if keys \
            else [n for n in ratios if "attn." not in n and "ffn" not in n]
        top = sorted(names, key=lambda n: -ratios[n])[:3]
        print("    %-9s worst: %s" % (group, ", ".join(
            "%s %.3g" % (n, ratios[n]) for n in top)))


def check_against_dense(mx, net, twin, ctx, step_loss):
    """One record/backward on the kernel route ``net`` and on ``twin``
    (dense attention, given ``net``'s weights), then again on the twin
    with the kernel route's ReLU masks; fails unless every gradient and
    per-sample loss agrees within its tolerance."""
    twin.initialize(mx.init.Xavier(), ctx=ctx)
    src = net._collect_params_with_prefix()
    for name, p in twin._collect_params_with_prefix().items():
        p.set_data(src[name].data())
    layers = [net.layers[i] for i in range(len(net.layers))]
    for layer in layers:
        layer.relu_masks = []
    loss_k = step_loss(net)
    masks = [layer.relu_masks[0] for layer in layers]
    for layer in layers:
        layer.relu_masks = None
    loss_d = step_loss(twin)
    ratios = grad_ratios(src, twin)
    tol = {n: GRAD_RTOL_RELU if n.endswith("ffn1.weight") else GRAD_RTOL
           for n in ratios}
    loss_err = float(np.abs(loss_k - loss_d).max())
    print("  gradients, kernels vs dense attention, max|diff| / max|grad|"
          " per parameter: worst %.3g, median %.3g (tolerance %g, ffn1"
          " weights %g); loss %.6f vs %.6f, max per-sample diff %.3g"
          " (tolerance %g)"
          % (max(ratios.values()), statistics.median(ratios.values()),
             GRAD_RTOL, GRAD_RTOL_RELU, float(loss_k.mean()),
             float(loss_d.mean()), loss_err, LOSS_ATOL))
    print_groups(ratios)
    SharedReLU = shared_relu(mx)
    twin_layers = [twin.layers[i] for i in range(len(twin.layers))]
    for layer, mask in zip(twin_layers, masks):
        layer.ffn1.act = SharedReLU(mask)
    loss_s = step_loss(twin)
    shared = grad_ratios(src, twin)
    flips = [layer.ffn1.act.flips for layer in twin_layers]
    shared_loss_err = float(np.abs(loss_k - loss_s).max())
    print("  the twin again with the kernel route's ReLU masks: %d of %d"
          " ReLU pre-activations flipped sign between the routes (per"
          " layer: %s); gradients worst %.3g, median %.3g (tolerance %g);"
          " max per-sample loss diff %.3g"
          % (sum(flips), len(flips) * masks[0].size, flips,
             max(shared.values()), statistics.median(shared.values()),
             GRAD_RTOL_SHARED, shared_loss_err))
    print_groups(shared)
    if any(ratios[n] > tol[n] for n in ratios) or loss_err > LOSS_ATOL:
        fail("training gradients or loss: kernels vs dense attention")
    if max(shared.values()) > GRAD_RTOL_SHARED \
            or shared_loss_err > LOSS_ATOL:
        fail("training gradients or loss: kernels vs dense attention with"
             " shared ReLU masks")


def phase_training(tfa, card, steps=20, prof_steps=3):
    """The second slice's main path: Gluon training of the LM at
    GPT-2-small width on gpu(0). (a) one record/backward against a twin
    with dense attention and the same weights, then again with the twin
    reusing the kernel route's ReLU masks; (b) `steps` Adam steps on one
    fixed batch, launch counts zeroed just before and read just after;
    (c) the step's time and device idle share. Returns the launches."""
    import mxnet_tpu_torch as mx
    cfg = dict(vocab=GPT2_SMALL["vocab"], layers=GPT2_SMALL["n_layers"],
               heads=GPT2_SMALL["n_heads"],
               units=GPT2_SMALL["n_heads"] * GPT2_SMALL["head_dim"],
               d_ff=GPT2_SMALL["d_ff"], max_len=GPT2_SMALL["max_len"])
    B, T = TRAIN_BATCH, GPT2_SMALL["max_len"]
    ctx = mx.gpu(0)
    seq = np.random.RandomState(0).randint(0, cfg["vocab"], size=(B, T + 1))
    tokens = mx.nd.array(seq[:, :T].astype(np.float32), ctx=ctx)
    labels = mx.nd.array(seq[:, 1:].astype(np.float32), ctx=ctx)
    positions = mx.nd.array(np.arange(T, dtype=np.float32), ctx=ctx)
    DecoderLM = gluon_lm(mx)
    t0 = time.perf_counter()
    mx.random.seed(0)
    net = DecoderLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():          # deferred shapes, from a short input
        net(tokens[:1, :16], positions[:16])
    n_params = sum(p.data().size for p in net.collect_params().values())
    torch.cuda.synchronize()
    print("training: GPT-2-small-width Gluon LM, %.1fM parameters, batch"
          " %d x %d tokens, init %.1f s"
          % (n_params / 1e6, B, T, time.perf_counter() - t0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step_loss(m):
        with mx.autograd.record():
            loss = loss_fn(m(tokens, positions), labels)
        loss.backward()
        return loss.asnumpy()

    # (a) the kernel route against a dense-attention twin
    check_against_dense(mx, net, DecoderLM(impl="dense", **cfg), ctx,
                        step_loss)
    gc.collect()                          # a block and its scope: a cycle
    torch.cuda.empty_cache()

    # (b) Adam steps on one fixed batch: the main path
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()                  # the main path starts here
    curve, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = step_loss(net)
        trainer.step(B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        curve.append(float(loss.mean()))
    launches = dict(tfa.launches)         # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("  Adam loss curve (%d steps, lr 1e-3): %s"
          % (steps, " ".join("%.4f" % x for x in curve)))
    print("  launches in %d steps: %s" % (steps, launches))
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        fail("the training loss did not fall: %s" % curve)
    for kname in TRAIN_KERNELS:
        if launches[kname] != cfg["layers"] * steps:
            fail("%s launched %d times in %d steps, want %d per step"
                 % (kname, launches[kname], steps, cfg["layers"]))

    # (c) where a step's time goes
    ms = statistics.median(step_ms[1:])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(prof_steps):
            step_loss(net)
            trainer.step(B)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / prof_steps
    classes = {"attention fwd": ("fwd_kernel",),
               "attention bwd": ("dkdv_kernel", "dq_kernel"),
               "matmul": ("gemm", "cutlass", "sm90_", "ampere_"),
               "softmax/log_softmax": ("softmax",),
               "layer norm": ("layer_norm", "layernorm")}
    by_class, kernels = {}, []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        kernels.append((us, e.key, e.count))
        name = e.key.lower()
        cls = next((c for c, keys in classes.items()
                    if any(k in name for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / prof_steps
    busy = sum(by_class.values())
    print("  train step (%s): %.1f ms per step (median of steps 2-%d),"
          " %.0f tokens/s; peak memory %.1f GB; profiled %d steps: wall"
          " %.1f ms, device busy %.1f ms, idle share %.3f"
          % (card, ms, steps, B * T / ms * 1e3, peak_gb, prof_steps, wall,
             busy, 1 - busy / wall if wall else float("nan")))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-20s %.2f ms/step" % (cls, cms))
    for us, key, count in sorted(kernels, reverse=True)[:8]:
        print("    top: %.2f ms/step in %d calls/step  %s"
              % (us / 1e3 / prof_steps, count // prof_steps, key[:70]))
    armed_steps(step_loss, net, trainer, B, card)
    return launches


def armed_steps(step_loss, net, trainer, B, card, steps=3):
    """``steps`` more Trainer steps under an armed telemetry run (after
    the timed ones, which it must not move): the Trainer ticks one step
    record a call after the first (tick mode), each with its optimizer
    phase and samples, and ``stop`` writes one memory record read from
    the card's allocator."""
    import tempfile
    from mxnet_tpu_torch import telemetry
    with tempfile.TemporaryDirectory() as tmp:
        sink = os.path.join(tmp, "train.jsonl")
        telemetry.reset()
        telemetry.start(filename=sink, run_id="training")
        for _ in range(steps):
            step_loss(net)
            trainer.step(B)
        summary = telemetry.stop()
        recs = [json.loads(line) for line in open(sink)]
    step_recs = [r for r in recs if r["type"] == "step"]
    mem = [r for r in recs if r["type"] == "memory"]
    if len(step_recs) != steps - 1 or any(
            r.get("samples") != B or not r.get("phases_ms", {})
            .get("optimizer") for r in step_recs):
        fail("training telemetry: step records %s" % step_recs)
    if len(mem) != 1 or mem[0]["device"] != "cuda:0" \
            or not 0 < mem[0]["bytes_in_use"] <= mem[0]["peak_bytes_in_use"]:
        fail("training telemetry: memory records %s" % mem)
    print("  armed telemetry, %d more steps (%s): step records %s ms"
          " (optimizer phase %s ms); memory cuda:0 %.2f GB allocated, peak"
          " %.2f GB; summary steps %d, samples %d"
          % (steps, card, " / ".join("%.1f" % r["dur_ms"]
                                     for r in step_recs),
             " / ".join("%.2f" % r["phases_ms"]["optimizer"]
                        for r in step_recs),
             mem[0]["bytes_in_use"] / 1e9,
             mem[0]["peak_bytes_in_use"] / 1e9, summary["steps"],
             summary["samples"]))


def q8_pool_cache(B, T, H, D, lens, seed):
    """A seeded fp32 K and V cache stored the way the int8 pool stores
    it: each row quantized page by page (``scatter_prefill_q8``, pages of
    16 slots, rows up to its length), then gathered raw (int8 pages, each
    page's scale repeated over its slots) and dequantized
    (``gather_pages_q8``). Returns (k8, v8, k_scale, v_scale, k_deq,
    v_deq)."""
    from mxnet_tpu_torch.serving import kvcache
    dev = torch.device("cuda", 0)
    M = T // PAGE
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.arange(1, B * M + 1, device=dev).reshape(B, M)
    out = []
    for _ in range(2):
        seq = torch.randn(B, T, H, D, generator=g).to(dev)
        pages = torch.zeros(1, B * M + 1, PAGE, H, D, dtype=torch.int8,
                            device=dev)
        scales = torch.zeros(1, B * M + 1, device=dev)
        for b in range(B):
            kvcache.scatter_prefill_q8(pages, scales, table[b], seq[b][None],
                                       int(lens[b]))
        out += [kvcache.gather_pages(pages, table)[0],
                torch.repeat_interleave(scales[:, table], PAGE,
                                        dim=-1)[0].contiguous(),
                kvcache.gather_pages_q8(pages, scales, table)[0]]
    k8, ks, kd, v8, vs, vd = out
    return k8, v8, ks, vs, kd, vd


def q8_hold(tfa, what, q, k8, v8, ks, vs, kd, vd, lens, seed):
    """The int8 kernel on one input: (i) against its plain version, (ii)
    against flash_decode.cu on the dequantized cache, (iii) with random
    bytes and NaN scales past each row's length, which must leave its
    output bit-identical. Returns (output, error vs plain, error vs the
    fp32 kernel)."""
    scale = q.shape[-1] ** -0.5
    got = tfa.flash_decode(q, k8, v8, lens, k_scale=ks, v_scale=vs)
    want = tfa.flash_decode(q, k8, v8, lens, k_scale=ks, v_scale=vs,
                            impl="plain")
    err, ok = close(got, want)
    fp32 = tfa._decode_cuda(q, kd, vd, lens, scale)
    err32, ok32 = close(got, fp32)
    same = torch.equal(got, fp32)
    B, T = ks.shape
    tail = torch.arange(T, device=q.device)[None, :] >= lens[:, None].long()
    g = torch.Generator(device="cpu").manual_seed(seed)
    gk, gv = k8.clone(), v8.clone()
    for t in (gk, gv):
        noise = torch.randint(-128, 128, t.shape, generator=g,
                              dtype=torch.int8).to(q.device)
        t[tail] = noise[tail]
    nan = float("nan")
    dirty = tfa.flash_decode(q, gk, gv, lens, k_scale=ks.masked_fill(tail, nan),
                             v_scale=vs.masked_fill(tail, nan))
    clean_tail = torch.equal(dirty, got)
    torch.cuda.synchronize()
    print("  %-34s vs plain err %.3g; vs flash_decode.cu on the dequantized"
          " cache err %.3g, bit-identical %s; garbage tail (%d positions,"
          " NaN scales) leaves the output bit-identical: %s"
          % (what, err, err32, same, int(tail.sum()), clean_tail))
    if not ok:
        fail("flash_decode_q8 disagrees with the plain version: %s" % what)
    if not ok32:
        fail("flash_decode_q8 disagrees with flash_decode.cu on the"
             " dequantized cache: %s" % what)
    if not clean_tail:
        fail("flash_decode_q8 read past a row's length: %s" % what)
    return got, err, err32


def phase_q8_decode(tfa):
    """The int8 kernel at decode_case's shape on a pool-built cache, and
    at the JAX test's shape on random int8 and scales; times at the
    first. Returns the record of the first and the largest error vs the
    plain version."""
    dev = torch.device("cuda", 0)
    B, T, H, D = 8, 576, 12, 64
    print("int8 decode kernel (flash_decode_q8.cu) vs plain and vs"
          " flash_decode.cu (rtol = atol = %g):" % TOL["rtol"])
    lens_np = np.random.RandomState(9).randint(1, T + 1, size=B)
    lens_np[0], lens_np[-1] = 1, T                # decode_case's lengths
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    g = torch.Generator(device="cpu").manual_seed(21)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k8, v8, ks, vs, kd, vd = q8_pool_cache(B, T, H, D, lens_np, seed=22)
    _, err, _ = q8_hold(tfa, "B8 T576 H12 D64 pool pages", q, k8, v8, ks,
                        vs, kd, vd, lens, seed=23)
    # the JAX test's inputs (tests/test_kv_int8.py): B2 T128 H2 D8 (int8
    # rows staged 4 bytes at a time); and D7 (one byte at a time)
    err_small = 0.0
    for (sB, sT, sH, sD), slens, what in (
            ((2, 128, 2, 8), [37, 128], "B2 T128 H2 D8 (JAX test inputs)"),
            ((3, 100, 3, 7), [1, 50, 100], "B3 T100 H3 D7")):
        rs = np.random.RandomState(5)
        sq = torch.from_numpy(rs.randn(sB, 1, sH, sD).astype(np.float32))
        sk, sv = (torch.from_numpy(rs.randint(-127, 128, size=(
            sB, sT, sH, sD)).astype(np.int8)) for _ in range(2))
        sks, svs = (torch.from_numpy(rs.uniform(0.005, 0.02, size=(
            sB, sT)).astype(np.float32)) for _ in range(2))
        sq, sk, sv, sks, svs = (t.to(dev) for t in (sq, sk, sv, sks, svs))
        slens = torch.tensor(slens, dtype=torch.int32, device=dev)
        sdeq = [t.float() * sc[:, :, None, None]
                for t, sc in ((sk, sks), (sv, svs))]
        _, e, _ = q8_hold(tfa, what, sq, sk, sv, sks, svs, sdeq[0], sdeq[1],
                          slens, seed=24)
        err_small = max(err_small, e)
    live = int(lens_np.sum())
    nbytes = 2.0 * live * H * D + 2 * 4.0 * live + 2 * 4.0 * B * H * D \
        + 4.0 * B                 # int8 K, V; their scales; q, o; lengths
    flops = 6.0 * D * live * H    # dequantizing multiplies, q.k, p.v
    bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FP32_FLOPS \
        else "operations"
    ms = timed(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                        v_scale=vs))
    cold = cold_ms(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                            v_scale=vs))
    plain_ms = timed(lambda: tfa.flash_decode(q, k8, v8, lens, k_scale=ks,
                                              v_scale=vs, impl="plain"))
    fp32_ms = timed(lambda: tfa._decode_cuda(q, kd, vd, lens, D ** -0.5))
    fp32_cold = cold_ms(lambda: tfa._decode_cuda(q, kd, vd, lens,
                                                 D ** -0.5))
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]

    def deq_sdpa():                # a yardstick only: no single call
        kf = (k8.float() * ks[:, :, None, None]).transpose(1, 2)
        vf = (v8.float() * vs[:, :, None, None]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kf, vf, attn_mask=mask)
    yard_ms = timed(deq_sdpa)
    fp32_bytes = 4.0 * H * (2 * live * D + 2 * B * D) + 4.0 * B
    splits = decode_splits("flash_decode_q8", B, H, T, D)
    print("  %-34s device ms: kernel %.4f plain %.4f | flash_decode.cu on"
          " the dequantized cache %.4f (bound %.2f us) | dequantize + sdpa"
          " %.4f (yardstick) | per-call ms: kernel %.4f plain %.4f | bound"
          " %.2f us (%s, %.3f MB)"
          % ("B8 T576 H12 D64 (%d live keys)" % live, ms[0], plain_ms[0],
             fp32_ms[0], fp32_bytes / PEAK_BYTES * 1e6, yard_ms[0], ms[1],
             plain_ms[1], bound * 1e3, bound_by, nbytes / 1e6))
    print("  %-34s splits %d (%d blocks); one call, device ms: cold L2 %.4f,"
          " warm %.4f | flash_decode.cu on the dequantized cache: cold L2"
          " %.4f, warm %.4f"
          % ("", splits, B * H * splits, cold[0], cold[1], fp32_cold[0],
             fp32_cold[1]))
    return dict(err=max(err, err_small), ms=ms[0], plain_ms=plain_ms[0],
                library_ms=None, bound_ms=bound, bound_by=bound_by,
                cold_ms=cold[0], splits=splits)


def phase_q8_pool(tfa, model, params, pool):
    """The int8 kernel's main path: on phase 6's int8 pool, a server
    admits 4 requests and runs a few decode steps; then one decode
    step's calls, ``flash_decode(k_scale=, v_scale=)`` for each layer
    over the live requests' raw pages and scales, with launch counts
    zeroed just before and read just after; then each layer held as in
    phase 7. Returns the launches and the largest error vs plain."""
    from mxnet_tpu_torch.serving import DecodeServer, kvcache
    dev = torch.device("cuda", 0)
    srv = DecodeServer(model, params, pool=pool, seq_ladder=[64, 128],
                       max_new_tokens=32, window=8, start=False)
    rs = np.random.RandomState(4)
    reqs = [srv.submit(rs.randint(0, model.vocab, size=30 + 25 * i),
                       max_new_tokens=32) for i in range(4)]
    try:
        while srv.stats()["active"] < len(reqs):
            srv._tick()                   # prefills (one per tick)
        for _ in range(5):
            srv._tick()
        torch.cuda.synchronize()
        rows = [r for r in reqs if r.state == "active"]
        table = torch.zeros(len(rows), srv._max_pages, dtype=torch.long)
        lens = []
        for i, r in enumerate(rows):
            table[i, :len(r.pages)] = torch.tensor(r.pages)
            lens.append(len(r.prompt) + len(r.generated) - 1)
        table = table.to(dev)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        k8, v8 = (kvcache.gather_pages(t, table) for t in (pool.k, pool.v))
        ks, vs = (torch.repeat_interleave(s[:, table], PAGE, dim=-1)
                  .contiguous() for s in (pool.k_scale, pool.v_scale))
        kd, vd = (kvcache.gather_pages_q8(t, s, table) for t, s in
                  ((pool.k, pool.k_scale), (pool.v, pool.v_scale)))
    finally:
        for r in reqs:
            r.cancel()
        srv.stop(drain=False)
    L, n, T, H, D = k8.shape
    g = torch.Generator(device="cpu").manual_seed(25)
    q = torch.randn(L, n, 1, H, D, generator=g).to(dev)
    tfa.reset_launches()                  # the main path starts here
    outs = [tfa.flash_decode(q[i], k8[i], v8[i], lens, k_scale=ks[i],
                             v_scale=vs[i]) for i in range(L)]
    torch.cuda.synchronize()
    launches = dict(tfa.launches)         # ... and ends here
    print("int8 pool of the server: %d live requests, lengths %s, %d layers"
          " x %d cached positions; launches %s"
          % (n, lens.tolist(), L, T, launches))
    if launches["flash_decode_q8"] != L:
        fail("flash_decode_q8 launched %d times in %d layers"
             % (launches["flash_decode_q8"], L))
    if launches["flash_decode"]:
        fail("an int8 call went through the fp32 decode kernel")
    err = 0.0
    for i in (0, L - 1):
        got, e, _ = q8_hold(tfa, "layer %d of the server's pool" % i, q[i],
                            k8[i], v8[i], ks[i], vs[i], kd[i], vd[i], lens,
                            seed=26 + i)
        if not torch.equal(got, outs[i]):
            fail("flash_decode_q8 is not deterministic on layer %d" % i)
        err = max(err, e)
    return launches, err


def host_us(loop, reps):
    """Host microseconds per call of ``loop()``, which makes ``reps``
    calls, on the host's clock (the card is synchronised before and
    after, outside the timing)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    loop()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / reps / 1e3


def rtc_floors(rtc, fn, alpha, x, y, reps=RTC_REPS):
    """Two floors under an rtc launch of the axpy ``fn`` on the 1024
    floats ``x``, ``y`` (torch tensors), host µs per call over ``reps``
    calls: cuLaunchKernel alone through ctypes with a prebuilt argument
    array, and torch.add(y, x, alpha=)."""
    cu = rtc._cuda()
    cu.cuCtxGetCurrent.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    cu.cuCtxGetCurrent.restype = ctypes.c_int
    vals = [ctypes.c_float(alpha), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(y.data_ptr())]
    params = (ctypes.c_void_p * 3)(*[ctypes.addressof(v) for v in vals])
    stream = torch.cuda.current_stream(0).cuda_stream
    grid = x.numel() // 256
    cur = ctypes.c_void_p()
    cu.cuCtxGetCurrent(ctypes.byref(cur))
    if not cur.value:
        fail("rtc: no CUDA context is current on the main thread")
    rcs = set()

    def raw():
        for _ in range(reps):
            rcs.add(cu.cuLaunchKernel(fn, grid, 1, 1, 256, 1, 1, 0, stream,
                                      params, None))

    def add():
        for _ in range(reps):
            torch.add(y, x, alpha=alpha)
    raw()
    add()
    out = dict(raw_launch_us=host_us(raw, reps),
               library_host_us=host_us(add, reps))
    if rcs != {0}:
        fail("rtc: cuLaunchKernel returned %s" % sorted(rcs))
    return out


def sass_kernels(cubin):
    """{kernel: [instruction, ...]} of ``cuobjdump -sass cubin``, NOPs
    left out."""
    from mxnet_tpu_torch.parallel import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail("cuobjdump -sass %s: %s" % (cubin, out.stderr))
    kernels, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+([^;]*);", line)
        if m and name and not m.group(1).strip().startswith("NOP"):
            kernels[name].append(m.group(1).strip())
    return kernels


def rtc_sass(mod, arch):
    """NVRTC's cubin of RTC_KERNELS (from ``mod``'s disk cache) against
    ``nvcc -O3 -gencode arch=compute_90a,code=sm_90a -cubin`` of the same
    source, kernel by kernel: instruction count, global loads and stores
    by width, and whether the instruction streams are identical."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import _build
    nvrtc_cubin = os.path.join(mx.rtc._OUT, "%s-%s.cubin"
                               % (mod._key[:16], arch))
    src = os.path.join(mx.rtc._OUT, "sass_check.cu")
    nvcc_cubin = os.path.join(mx.rtc._OUT, "sass_check.cubin")
    with open(src, "w") as f:
        f.write(RTC_KERNELS)
    cc = subprocess.run([_build._nvcc(), "-cubin", "-O3", "-gencode",
                         "arch=compute_90a,code=sm_90a", "-o", nvcc_cubin,
                         src], capture_output=True, text=True, timeout=300)
    if cc.returncode != 0:
        fail("nvcc -cubin of RTC_KERNELS: %s" % cc.stderr)
    got, want = sass_kernels(nvrtc_cubin), sass_kernels(nvcc_cubin)
    lib = mx.rtc._nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor))
    nvcc_version = subprocess.run([_build._nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip().splitlines()
    print("  NVRTC %d.%d against %s" % (major.value, minor.value,
                                        nvcc_version[-1]))
    out = {}
    for name in sorted(want):
        a, b = got.get(name, []), want[name]
        mem = [sorted(i.split()[0] for i in ins
                      if re.match(r"(LDG|STG)\b", i)) for ins in (a, b)]
        diff = [(i, p, q) for i, (p, q) in enumerate(zip(a, b)) if p != q]
        # the same instructions on other registers
        renamed = [re.sub(r"\bU?R\d+\b", "R", i) for i in a] == \
            [re.sub(r"\bU?R\d+\b", "R", i) for i in b]
        same_ops = sorted(i.split()[0] for i in a) == \
            sorted(i.split()[0] for i in b)
        out[name] = dict(nvrtc=len(a), nvcc=len(b), identical=a == b,
                         identical_but_registers=renamed,
                         same_opcodes=same_ops, mem_nvrtc=mem[0],
                         mem_nvcc=mem[1], differing=len(diff))
        print("  SASS %-10s NVRTC %d instructions %s | nvcc -O3 %d %s |"
              " identical: %s, but for register names: %s, the same"
              " opcodes: %s%s" % (
                  name, len(a), " ".join(mem[0]), len(b), " ".join(mem[1]),
                  a == b, renamed, same_ops,
                  "".join("\n    %d: %s | %s" % d for d in diff[:4])))
    return out


def rtc_stream_pinned(mx):
    """Whether the stream handle mx.rtc launches on
    (``torch._C._cuda_getCurrentRawStream``) equals the public
    ``torch.cuda.current_stream(0).cuda_stream`` on the default stream, on
    a side stream and inside a CUDA-graph capture."""
    def same():
        return mx.rtc._raw_stream(0) == \
            torch.cuda.current_stream(0).cuda_stream
    side = torch.cuda.Stream()
    got = [same()]
    with torch.cuda.stream(side):
        got.append(same())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got.append(same())
        torch.zeros(1, device="cuda").add_(1)   # a capture holds a node
    return got


def rtc_breakdown(k, args, ctx, grid_dims, block_dims, reps=RTC_REPS):
    """Mean ns per launch of each stage of ``CudaKernel.launch`` over
    ``reps`` launches of kernel ``k``: its calls, in its order, with a
    clock read between stages."""
    import mxnet_tpu_torch as mx
    rtc = mx.rtc
    ns = time.perf_counter_ns
    cu = rtc._libs["cuda"]
    stages = ("checks", "device check + plan lookup", "stream lookup",
              "marshalling", "context check", "cuLaunchKernel",
              "count + write-back")
    acc = [0] * len(stages)
    for _ in range(reps):
        t0 = ns()
        grid, block, smem = k._check(args, grid_dims, block_dims, 0)
        c = ctx if ctx is not None else mx.current_context()
        if c.device_type != "gpu":
            fail("rtc: not a GPU context")
        index = c.device_id
        t1 = ns()
        plan = k._plans.get(index)
        for i in k._arrays:
            if args[i]._data.get_device() != index:
                fail("rtc: argument %d on another device" % i)
        t2 = ns()
        stream = rtc._raw_stream(index)
        t3 = ns()
        with plan.lock:
            temps, writeback = plan.pack(args)
            t4 = ns()
            cu.cuCtxGetCurrent(plan.cur_ref)
            if plan.cur.value != plan.ctx:
                fail("rtc: the primary context is not current on the main"
                     " thread")
            t5 = ns()
            rc = cu.cuLaunchKernel(plan.fn, grid[0], grid[1], grid[2],
                                   block[0], block[1], block[2], smem,
                                   stream, plan.params, None)
            t6 = ns()
        t7 = ns()
        if rc:
            fail("rtc: cuLaunchKernel returned %d" % rc)
        rtc.launches["rtc"] += 1
        if writeback:
            with torch.no_grad():
                for arr, t in writeback:
                    arr._data.copy_(t)
        del temps
        t8 = ns()
        for n, d in enumerate((t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                               (t5 - t4) + (t7 - t6), t6 - t5, t8 - t7)):
            acc[n] += d
    return {st: a / reps for st, a in zip(stages, acc)}


def replay_equals_eager(launch, out, init):
    """Whether one launch captured in a CUDA graph and replayed writes
    ``out`` bit for bit as the same launch made eagerly, both from
    ``out = init``."""
    out.copy_(init)
    launch()
    torch.cuda.synchronize()
    eager = out.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    out.copy_(init)
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


def fresh_thread_launch(mx, k, ctx):
    """An axpy launch from a new thread that has never used CUDA: whether
    a context was current there before the launch, and the error of its
    result."""
    rtc = mx.rtc
    x = mx.nd.NDArray(torch.randn(1024, device="cuda"))
    y = mx.nd.NDArray(torch.randn(1024, device="cuda"))
    want = torch.add(y._data, x._data, alpha=2.0)
    seen = {}

    def work():
        cur = ctypes.c_void_p()
        rtc._libs["cuda"].cuCtxGetCurrent(ctypes.byref(cur))
        seen["current"] = bool(cur.value)
        try:
            k.launch((2.0, x, y), ctx, (4, 1, 1), (256, 1, 1))
        except mx.MXNetError as exc:
            seen["error"] = exc
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    if t.is_alive() or "error" in seen:
        fail("rtc: a launch from a fresh thread failed: %s"
             % seen.get("error", "it hung"))
    torch.cuda.synchronize()
    err, ok = close(y._data, want, RTC_TOL)
    if not ok:
        fail("rtc: the fresh thread's launch disagrees (err %g)" % err)
    return seen["current"], err


def phase_rtc(card):
    """The rtc path: mx.rtc compiles RTC_KERNELS and launches each of the
    four on gpu(0) arrays (launch counts zeroed just before, read just
    after), held to torch; then write-back, shared memory above 48 KB, a
    launch from a fresh thread, a broken source, a CPU context, graph
    replays against eager launches, the SASS against nvcc's, the host
    cost of a launch stage by stage, and each kernel's device time.
    Returns one record per kernel and the path's launch counts."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    g = torch.Generator(device="cpu").manual_seed(31)
    n = 1 << 26
    x = mx.nd.NDArray(torch.randn(n, generator=g).to(dev))
    y = mx.nd.NDArray(torch.randn(n, generator=g).to(dev))
    y4 = mx.nd.NDArray(y._data.clone())
    rows, cols = 4096, 1024
    xs = mx.nd.NDArray(torch.randn(rows, cols, generator=g).to(dev))
    outs = mx.nd.zeros((rows, cols), ctx=ctx)
    xr = mx.nd.NDArray(torch.rand(4096, 4096, generator=g).to(dev))
    sums = mx.nd.zeros((4096,), ctx=ctx)
    alpha = 0.5
    y0 = y._data.clone()
    y_ptr = y._data.data_ptr()
    v4_grid = (n // 4 + 255) // 256
    calls = {}

    mx.rtc.reset_launches()               # the rtc path starts here
    mod = mx.rtc.CudaModule(RTC_KERNELS)
    axpy = mod.get_kernel("axpy", "float alpha, const float *x, float *y")
    scale_rows = mod.get_kernel("scale_rows", "const float *x, float *out")
    row_sum = mod.get_kernel("row_sum", "const float *x, float *out, int n")
    axpy_v4 = mod.get_kernel("axpy_v4",
                             "float alpha, const float *x, float *y, int n")
    for name, launch in (
            ("axpy", lambda: axpy.launch((alpha, x, y), ctx,
                                         (n // 256, 1, 1), (256, 1, 1))),
            ("scale_rows", lambda: scale_rows.launch(
                (xs, outs), ctx, (rows, 1, 1), (cols, 1, 1))),
            ("row_sum", lambda: row_sum.launch(
                (xr, sums, 4096), ctx, (4096, 1, 1), (256, 1, 1),
                shared_mem=256 * 4)),
            ("axpy_v4", lambda: axpy_v4.launch(
                (alpha, x, y4, n), ctx, (v4_grid, 1, 1), (256, 1, 1)))):
        before = mx.rtc.launches["rtc"]
        launch()
        calls[name] = mx.rtc.launches["rtc"] - before
    torch.cuda.synchronize()
    launches = dict(mx.rtc.launches)      # ... and ends here
    cold = (mod.compile_seconds, mod.from_cache)
    errs = {}
    want_axpy = torch.add(y0, x._data, alpha=alpha)
    for name, got, want, tol in (
            ("axpy", y._data, want_axpy, RTC_TOL),
            ("scale_rows", outs._data, xs._data * torch.arange(
                1, rows + 1, device=dev, dtype=torch.float32)[:, None],
             RTC_TOL),
            ("row_sum", sums._data, xr._data.sum(dim=1), ROWSUM_TOL),
            ("axpy_v4", y4._data, want_axpy, RTC_TOL)):
        errs[name], ok = close(got, want, tol)
        if not ok:
            fail("rtc kernel %s disagrees with torch (err %g)"
                 % (name, errs[name]))
    if y._data.data_ptr() != y_ptr:
        fail("rtc: a contiguous float32 in-out array was not written in"
             " place")
    print("rtc: 4 kernels compiled by NVRTC in %.3f s (from the disk cache:"
          " %s), launched on %s: max abs err vs torch axpy %.3g, scale_rows"
          " %.3g, row_sum %.3g, axpy_v4 %.3g; launches %s (%s)"
          % (cold[0], cold[1], ctx, errs["axpy"], errs["scale_rows"],
             errs["row_sum"], errs["axpy_v4"], launches, calls))
    # four kernels, one launch each
    if launches["rtc"] != 4 or set(calls.values()) != {1}:
        fail("rtc launched %d kernels (%s), want 4, one each"
             % (launches["rtc"], calls))
    # axpy_v4's ragged tail: n % 4 floats one a thread
    nr = (1 << 20) + 3
    xt = mx.nd.NDArray(torch.randn(nr, generator=g).to(dev))
    yt = mx.nd.NDArray(torch.randn(nr, generator=g).to(dev))
    want_t = torch.add(yt._data, xt._data, alpha=alpha)
    axpy_v4.launch((alpha, xt, yt, nr), ctx, (1024, 1, 1), (256, 1, 1))
    tail_err, tail_ok = close(yt._data, want_t, RTC_TOL)
    if not tail_ok:
        fail("rtc: axpy_v4 at %d floats (a ragged tail, a grid-stride loop)"
             " err %g" % (nr, tail_err))

    # a second module of the same source loads the cubin from the disk
    mod2 = mx.rtc.CudaModule(RTC_KERNELS)
    ax2 = mod2.get_kernel("axpy", "float alpha, const float *x, float *y")
    small = 1 << 12
    xh = mx.nd.NDArray(torch.randn(small, generator=g).to(dev).half())
    y64 = mx.nd.NDArray(torch.randn(small, generator=g,
                                    dtype=torch.float64).to(dev))
    y64_0 = y64._data.clone()
    ax2.launch((2.0, xh, y64), ctx, (small // 256, 1, 1), (256, 1, 1))
    want = (y64_0.float() + 2.0 * xh._data.float()).double()
    wb_err, wb_ok = close(y64._data, want, RTC_TOL)
    if not (mod2.from_cache and wb_ok and y64._data.dtype == torch.float64):
        fail("rtc: cache load %s, float16 input / float64 in-out write-back"
             " err %g (dtype %s)" % (mod2.from_cache, wb_err,
                                     y64._data.dtype))
    # a non-contiguous in-out array, and more than 48 KB of shared memory
    out_t = mx.nd.NDArray(torch.zeros(cols, 256, device=dev).t())
    scale_rows.launch((xs[:256], out_t), ctx, (256, 1, 1), (cols, 1, 1))
    part = mx.nd.zeros((256,), ctx=ctx)
    row_sum.launch((xr[:256], part, 4096), ctx, (256, 1, 1), (256, 1, 1),
                   shared_mem=64 * 1024)
    nc_err, nc_ok = close(out_t._data, outs._data[:256], RTC_TOL)
    sm_err, sm_ok = close(part._data, sums._data[:256], ROWSUM_TOL)
    torch.cuda.synchronize()
    print("  from the disk cache: %.3f s; float16 input + float64 in-out"
          " array written back (err %.3g, dtype %s); non-contiguous in-out"
          " (err %.3g); row_sum with 64 KB of shared memory (err %.3g);"
          " axpy_v4 at %d floats (err %.3g)"
          % (mod2.compile_seconds, wb_err, str(y64._data.dtype), nc_err,
             sm_err, nr, tail_err))
    if not (nc_ok and sm_ok):
        fail("rtc: non-contiguous write-back or large shared memory")
    was_current, th_err = fresh_thread_launch(mx, axpy, ctx)
    print("  a launch from a fresh thread (a context current there before:"
          " %s) agrees (err %.3g)" % (was_current, th_err))

    # errors: a broken source carries the compiler's log; a CPU context
    broken = mx.rtc.CudaModule(
        'extern "C" __global__ void broken(float *x) '
        '{ x[0] = undefined_name; }')
    try:
        broken.get_kernel("broken", "float *x").launch(
            (part,), ctx, (1, 1, 1), (1, 1, 1))
        fail("rtc: a broken source compiled")
    except mx.MXNetError as exc:
        if "undefined_name" not in str(exc):
            fail("rtc: the compile error lacks the compiler's log: %s" % exc)
        print("  broken source raises MXNetError with the log: %s"
              % str(exc).strip().splitlines()[-1][:100])
    try:
        axpy.launch((alpha, x, y), mx.cpu(), (1, 1, 1), (1, 1, 1))
        fail("rtc: a launch on mx.cpu() did not raise")
    except mx.MXNetError as exc:
        print("  mx.cpu() launch raises MXNetError: %s" % exc)

    # the private stream call the launch uses, against the public one
    pinned = rtc_stream_pinned(mx)
    print("  the launch's stream equals torch.cuda.current_stream() on the"
          " default stream, a side stream, in a capture: %s" % pinned)
    if not all(pinned):
        fail("rtc: _cuda_getCurrentRawStream differs from current_stream")
    # NVRTC's code against nvcc's
    sass = rtc_sass(mod, mx.rtc._arch(0))

    # host cost of a launch: stage by stage, whole, and two floors
    xs_small = mx.nd.NDArray(torch.randn(1024, device=dev))
    ys_small = mx.nd.NDArray(torch.randn(1024, device=dev))
    small_args = (alpha, xs_small, ys_small)

    def host_loop():
        for _ in range(RTC_REPS):
            axpy.launch(small_args, ctx, (4, 1, 1), (256, 1, 1))
    host_loop()
    stages = {st: v / 1e3 for st, v in rtc_breakdown(
        axpy, small_args, ctx, (4, 1, 1), (256, 1, 1)).items()}
    host = host_us(host_loop, RTC_REPS)
    floors = rtc_floors(mx.rtc, mod._function(0, "axpy"), alpha,
                        xs_small._data, ys_small._data)
    print("  host %.2f us per launch (%d launches of a 1024-float axpy);"
          " stages: %s (sum %.2f); cuLaunchKernel alone %.2f us, torch.add"
          " %.2f us per call (%s)"
          % (host, RTC_REPS, ", ".join("%s %.2f" % kv
                                        for kv in stages.items()),
             sum(stages.values()), floors["raw_launch_us"],
             floors["library_host_us"], card))

    # device time of each kernel: graph replays (as rows 1-5), the
    # eager stream beside it, the plain expression and one PyTorch call
    r = torch.arange(1, rows + 1, device=dev, dtype=torch.float32)
    cases = {
        "axpy": (lambda: axpy.launch((alpha, x, y), ctx, (n // 256, 1, 1),
                                     (256, 1, 1)),
                 lambda: y._data + alpha * x._data,
                 lambda: torch.add(y._data, x._data, alpha=alpha),
                 3 * 4.0 * n, 2.0 * n, y._data, y0, "axpy 2^26 float32"),
        "scale_rows": (
            lambda: scale_rows.launch((xs, outs), ctx, (rows, 1, 1),
                                      (cols, 1, 1)),
            lambda: xs._data * torch.arange(1, rows + 1, device=dev,
                                            dtype=torch.float32)[:, None],
            lambda: xs._data * r[:, None],
            2 * 4.0 * rows * cols, 1.0 * rows * cols, outs._data,
            torch.zeros_like(outs._data), "scale_rows 4096 x 1024 float32"),
        "row_sum": (
            lambda: row_sum.launch((xr, sums, 4096), ctx, (4096, 1, 1),
                                   (256, 1, 1), shared_mem=256 * 4),
            # the kernel's order: 256 strided partial sums a row, then
            # those added
            lambda: xr._data.view(4096, 16, 256).sum(dim=1).sum(dim=1),
            lambda: xr._data.sum(dim=1),
            4.0 * (4096 * 4096 + 4096), 4096.0 * 4096, sums._data,
            torch.zeros_like(sums._data), "row_sum 4096 x 4096 float32"),
        "axpy_v4": (
            lambda: axpy_v4.launch((alpha, x, y4, n), ctx, (v4_grid, 1, 1),
                                   (256, 1, 1)),
            lambda: y4._data + alpha * x._data,
            lambda: torch.add(y4._data, x._data, alpha=alpha),
            3 * 4.0 * n, 2.0 * n, y4._data, y0, "axpy_v4 2^26 float32"),
    }
    recs = {}
    for name, (launch, plain, lib, nbytes, flops, out, init,
               shape) in cases.items():
        same = replay_equals_eager(launch, out, init)
        if not same:
            fail("rtc: %s replayed from a CUDA graph differs from its eager"
                 " launch" % name)
        ms = device_ms(launch)
        eager_ms = stream_ms(launch, iters=20)
        plain_ms = device_ms(plain)
        lib_ms = device_ms(lib)
        bound = max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_FP32_FLOPS \
            else "operations"
        recs[name] = dict(err=errs[name], ms=ms, stream_ms=eager_ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound, bound_by=bound_by, shape=shape,
                          launches=calls[name], graph_equals_eager=same,
                          sass_identical_to_nvcc=sass[name]["identical"],
                          sass_identical_but_registers=sass[name][
                              "identical_but_registers"])
        print("  %-10s device ms (20 in one CUDA graph): kernel %.4f (20 on"
              " the stream: %.4f), plain %.4f, library %.4f | bound %.4f ms"
              " (%s) | graph replay == eager: %s (%s)"
              % (name, ms, eager_ms, plain_ms, lib_ms, bound, bound_by, same,
                 card))
    recs["axpy"].update(host_us=host, library_host_us=floors[
        "library_host_us"], raw_launch_us=floors["raw_launch_us"],
        host_stages_us=stages)
    print("  rtc phase: %.1f s" % (time.perf_counter() - t_phase))
    return recs, launches


def resnet_net(mx, layers, batch, image, classes):
    """ResNet v1 as ``entry()`` builds it: Xavier from ``mx.random.seed(0)``
    on gpu(0), deferred shapes fixed by one forward on zeros."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = vision.get_model("resnet%d_v1" % layers, classes=classes)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((batch, 3, image, image)))
    return net


def resnet_plan(net):
    """``entry()``'s lowering of ``net``: ``net(sym.var("data"))`` →
    ``build_graph_callable``, and its forward (eval), reading each
    parameter's current tensor."""
    from mxnet_tpu_torch import symbol as sym_mod
    from mxnet_tpu_torch.cached_op import build_graph_callable
    out = net(sym_mod.var("data"))
    fn, arg_names, aux_names, n_rng, n_out = build_graph_callable(out)
    if (n_rng, n_out) != (0, 1):
        fail("resnet: build_graph_callable gave n_rng %d, n_out %d"
             % (n_rng, n_out))
    params = {p.name: p for p in net.collect_params().values()}

    def forward(x):
        vals = [x if n == "data" else params[n].data()._data
                for n in arg_names]
        vals += [params[n].data()._data for n in aux_names]
        with torch.no_grad():
            return fn({"__train__": False}, *vals)[0]
    return out, forward, arg_names, aux_names


def resnet_cost(sym, batch, image):
    """(FLOPs, bytes) of one forward: 2 x the multiply-adds of every
    Convolution and FullyConnected node (shapes from the graph's
    inference), and the parameters, auxiliary states, input and logits
    each moved once."""
    internals = sym.get_internals()
    _, shapes, _ = internals.infer_shape(data=(batch, 3, image, image))
    shape_of = dict(zip(internals.list_outputs(), shapes))
    flops = 0
    for node in sym._topo_nodes():
        if node.op is not None and node.op.name in ("Convolution",
                                                    "FullyConnected"):
            out = shape_of[node.name + "_output"]
            w = shape_of[node.inputs[1][0].name]
            flops += 2 * int(np.prod(out)) * int(np.prod(w[1:]))
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(
        data=(batch, 3, image, image))
    nbytes = 4 * sum(int(np.prod(s)) for s in
                     arg_shapes + out_shapes + aux_shapes)
    return flops, nbytes


def resnet_bound(flops, nbytes):
    """(bound ms, bound by) at the card's fp32 peak and memory rate."""
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(by_ops, by_bytes) * 1e3, \
        "operations" if by_ops >= by_bytes else "bytes"


def wall_ms(fn, iters=RESNET_ITERS, warm=3):
    """Median host ms of one call that ends in a device sync (what a
    user waits for), after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def resnet_inference(mx, card):
    """``entry()``'s config on the card: its five lines, the imperative
    run, the hybridized run (one CUDA graph), both held to each other;
    one capture then replays only; copied outputs; a parameter written
    in place (a replay) and one replaced by a new tensor (one counted
    recapture). Returns the net."""
    batch, image, classes = RESNET_ENTRY
    net = resnet_net(mx, 50, batch, image, classes)
    n_params = sum(p.data().size for p in net.collect_params().values())
    _sym, forward, arg_names, aux_names = resnet_plan(net)
    xs = [mx.nd.array(np.random.RandomState(40 + i).randn(
        batch, 3, image, image).astype(np.float32)) for i in range(4)]
    eager = [net(x)._data.clone() for x in xs]
    errs = []
    for x, want in zip(xs, eager):
        got = forward(x._data)
        errs.append(close(got, want, RESNET_TOL))
    net.hybridize()
    ys = [net(x) for x in xs]
    first = ys[0]._data.clone()
    ys += [net(x) for x in xs]
    for y, want in zip(ys, eager + eager):
        errs.append(close(y._data, want, RESNET_TOL))
    st = net._cached_op.stats()
    distinct = len({y._data.data_ptr() for y in ys}) == len(ys)
    kept = torch.equal(ys[0]._data, first)
    print("resnet: entry()'s config (ResNet-50 v1, classes %d, batch %d, "
          "%dx%d, %.2fM parameters, %d args + %d aux; %s): "
          "build_graph_callable and the hybridized net (CUDA graph) vs "
          "the imperative run on the card, max abs err %.3g (tol rtol = "
          "atol = %g); graphs %s; %d outputs distinct tensors: %s, the "
          "first unchanged by later calls: %s"
          % (classes, batch, image, image, n_params / 1e6, len(arg_names),
             len(aux_names), card, max(e for e, _ in errs),
             RESNET_TOL["rtol"], st, len(ys), distinct, kept))
    if not all(ok for _, ok in errs):
        fail("resnet: entry() logits differ from the imperative run")
    if st != dict(captures=1, replays=len(ys), recaptures=0, signatures=1,
                  eager_rng=0):
        fail("resnet: expected 1 capture and %d replays, got %s"
             % (len(ys), st))
    if not (distinct and kept):
        fail("resnet: a call's output is not its own tensor")
    # in place (set_data copies into the tensor the graph reads): a replay
    w = net.output.weight
    w.set_data(w.data() * 0.5)
    y = net(xs[0])
    err_a, ok_a = close(y._data, forward(xs[0]._data), RESNET_TOL)
    st_a = net._cached_op.stats()
    # replaced by a new tensor: one counted recapture
    w.data()._set_data(w.data()._data * 3.0)
    y2 = net(xs[0])
    err_b, ok_b = close(y2._data, forward(xs[0]._data), RESNET_TOL)
    st_b = net._cached_op.stats()
    moved = not torch.equal(y._data, y2._data) \
        and not torch.equal(y._data, first)
    print("  output weight set_data in place: %s, err %.3g; replaced by a "
          "new tensor: %s, err %.3g; outputs moved: %s"
          % (st_a, err_a, st_b, err_b, moved))
    if not (ok_a and ok_b and moved):
        fail("resnet: outputs after the weight changes are wrong")
    if (st_a["captures"], st_a["recaptures"]) != (1, 0) \
            or (st_b["captures"], st_b["recaptures"]) != (2, 1):
        fail("resnet: weight changes gave %s then %s" % (st_a, st_b))
    return net


def resnet_train_call(mx, net, batch, image, label):
    """One hybridized training call under ``record()``: every BatchNorm's
    written-back moving statistics against momentum*old +
    (1-momentum)*batch, the batch moments recomputed in float64 from
    that BatchNorm's input (the train-mode plan of the same graph, on
    copies of the statistics); gradients reach every conv weight."""
    from mxnet_tpu_torch import ops, symbol as sym_mod
    from mxnet_tpu_torch.cached_op import build_graph_callable
    sym = net(sym_mod.var("data"))
    x = mx.nd.array(np.random.RandomState(50).randn(
        batch, 3, image, image).astype(np.float32))
    head = mx.nd.array(np.random.RandomState(51).randn(
        batch, net.output.weight.shape[0]).astype(np.float32))
    params = {p.name: p for p in net.collect_params().values()}
    bns = [n for n in sym._topo_nodes()
           if n.op is not None and n.op.name == "BatchNorm"]
    fn, arg_names, aux_names, _, n_out = build_graph_callable(
        sym_mod.Symbol([n.inputs[0] for n in bns]))
    vals = [x._data if n == "data" else params[n].data()._data
            for n in arg_names]
    vals += [params[n].data()._data.clone() for n in aux_names]
    with torch.no_grad():
        bn_in = fn({"__train__": True}, *vals)[:n_out]
    old = {n.inputs[i][0].name: params[n.inputs[i][0].name].data()._data
           .double().clone() for n in bns for i in (3, 4)}
    net.hybridize()
    with mx.autograd.record():
        y = net(x)
        loss = (y * head).sum()
    loss.backward()
    torch.cuda.synchronize()
    worst, bad = 0.0, []
    for node, xin in zip(bns, bn_in):
        m = ops.normalize_attrs(node.op, node.attrs)["momentum"]
        d = xin.double()
        red = [i for i in range(d.dim()) if i != 1]
        batch = {3: d.mean(dim=red), 4: d.var(dim=red, unbiased=False)}
        for i in (3, 4):
            name = node.inputs[i][0].name
            want = m * old[name] + (1 - m) * batch[i]
            got = params[name].data()._data.double()
            err, ok = close(got, want, RESNET_STAT_TOL)
            worst = max(worst, err)
            if not ok or torch.equal(got, old[name]):
                bad.append(name)
    convs = [p for p in net.collect_params().values()
             if "conv" in p.name and p.name.endswith("weight")]
    no_grad = [p.name for p in convs
               if not bool(torch.isfinite(p.grad()._data).all())
               or float(p.grad()._data.abs().sum()) == 0.0]
    print("  training call, %s, hybridized under record(): logits %s "
          "finite %s; %d BatchNorms' moving statistics vs momentum*old + "
          "(1-momentum)*batch in float64, max abs err %.3g (tol rtol %g, "
          "atol %g); gradients reach %d of %d conv weights"
          % (label, tuple(y.shape), bool(torch.isfinite(y._data).all()),
             len(bns), worst, RESNET_STAT_TOL["rtol"],
             RESNET_STAT_TOL["atol"], len(convs) - len(no_grad),
             len(convs)))
    if bad or no_grad or not bool(torch.isfinite(y._data).all()):
        fail("resnet: training call, %s: statistics %s, gradients %s"
             % (label, bad[:4], no_grad[:4]))


def resnet_timing(mx, net, batch, image, label, card, tf32=False):
    """Images/s, ms a batch (median of RESNET_ITERS after warm-up), the
    device busy ms by class and idle share (profiler), peak memory and
    the bound, imperative and hybridized; with ``tf32``, one extra
    hybridized reading with cuDNN's TF32 on."""
    from mxnet_tpu_torch import symbol as sym_mod
    x = mx.nd.array(np.random.RandomState(60).randn(
        batch, 3, image, image).astype(np.float32))
    flops, nbytes = resnet_cost(net(sym_mod.var("data")), batch, image)
    bound, bound_by = resnet_bound(flops, nbytes)
    rows = {}
    outs = {}
    for mode in ("imperative", "hybridized"):
        net.hybridize(active=mode == "hybridized")
        net(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: net(x))
        peak = torch.cuda.max_memory_allocated()
        prof = profile_steps(lambda: net(x), 3, RESNET_CLASSES)
        outs[mode] = net(x)._data
        rows[mode] = (ms, peak, prof)
    err, ok = close(outs["hybridized"], outs["imperative"], RESNET_TOL)
    if not ok:
        fail("resnet: %s hybridized vs imperative max abs err %g"
             % (label, err))
    print("resnet timing, %s (batch %d, %dx%d, fp32, TF32 off; %s): "
          "%.4g GFLOP a batch (%.4g GMAC an image), %.1f MB moved once; "
          "bound %.4f ms (%s); hybridized vs imperative max abs err %.3g"
          % (label, batch, image, image, card, flops / 1e9,
             flops / 2e9 / batch, nbytes / 1e6, bound, bound_by, err))
    result = {}
    for mode, (ms, peak, (wall, busy, by_class, kernels, bare)) \
            in rows.items():
        print("  %-10s %.3f ms a batch, %.1f images/s, %.3f of the bound; "
              "peak memory %.1f MB; profiled: wall %.3f ms, device busy "
              "%.3f ms, idle share %.3f"
              % (mode, ms, batch * 1e3 / ms, bound / ms, peak / 2 ** 20,
                 wall, busy, 1 - busy / wall if wall else float("nan")))
        for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print("    %-24s %.3f ms a batch" % (cls, cms))
        for us, key, count in kernels[:3]:
            print("    top: %.3f ms in %d calls  %s"
                  % (us / 1e3 / 3, count // 3, key[:70]))
        result[mode] = dict(ms=ms, images_s=batch * 1e3 / ms,
                            busy_ms=busy, peak_mb=peak / 2 ** 20)
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        try:
            net.hybridize()      # a new graph: the old one holds fp32 kernels
            ms = wall_ms(lambda: net(x))
            err32 = float((net(x)._data - outs["hybridized"]).abs().max())
        finally:
            torch.backends.cudnn.allow_tf32 = False
        print("  [data for amp, not a mode of the port] hybridized with "
              "cuDNN TF32 on (matmul TF32 off): %.3f ms a batch, %.1f "
              "images/s; max abs diff vs fp32 %.3g"
              % (ms, batch * 1e3 / ms, err32))
        result["tf32_ms"] = ms
    net.hybridize(active=False)
    return result


def phase_resnet(card):
    """The tenth slice's main path: ``entry()``'s five lines through the
    port's entry points on gpu(0), the hybridized net on CUDA graphs,
    one training call each for ResNet-50 (entry's config) and ResNet-18
    (64x64), then timings at the reference's benchmark size and at
    entry()'s. No attention kernel is on this path: the launch counts,
    zeroed just before, must read 0 after. Returns the readings."""
    import mxnet_tpu_torch as mx
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    net = resnet_inference(mx, card)
    resnet_train_call(mx, net, RESNET_ENTRY[0], RESNET_ENTRY[1],
                      "ResNet-50, entry()'s config")
    batch, image, classes = RESNET18_TRAIN
    r18 = resnet_net(mx, 18, batch, image, classes)
    resnet_train_call(mx, r18, batch, image, "ResNet-18, batch %d, %dx%d"
                      % (batch, image, image))
    del r18
    readings = {"entry": resnet_timing(mx, net, RESNET_ENTRY[0],
                                       RESNET_ENTRY[1], "entry()'s config",
                                       card)}
    del net
    torch.cuda.empty_cache()
    batch, image, classes = RESNET_BENCH
    big = resnet_net(mx, 50, batch, image, classes)
    readings["bench"] = resnet_timing(
        mx, big, batch, image, "ResNet-50 v1, classes %d" % classes, card,
        tf32=True)
    del big
    torch.cuda.empty_cache()
    if any(tfa.launches.values()):
        fail("resnet: the ResNet path launched attention kernels: %s"
             % tfa.launches)
    print("  attention kernel launches on the ResNet path: %s (none is on "
          "it); resnet phase %.1f s"
          % (dict(tfa.launches), time.perf_counter() - t_phase))
    return readings


def module_resnet(mx, classes):
    """ResNet-50 v1 as the reference's symbolic scripts train it: the
    Gluon model traced with ``net(sym.var("data"))`` plus
    ``SoftmaxOutput`` (the net itself is never run), and the Module's
    batch arguments."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1(classes=classes)
    net.initialize()
    return mx.sym.SoftmaxOutput(net(mx.sym.var("data")), name="softmax")


def fit_curve(mod, it, num_epoch, callbacks=(), **fit_kw):
    """``mod.fit(it, ...)`` with a batch-end watch after ``callbacks``:
    each batch's loss from the SoftmaxOutput probabilities and a
    device-side all-finite flag over the gradients. Returns the mean
    loss of each epoch, the steps taken, the steps whose gradients were
    all finite and the fit's seconds."""
    losses, finite = [], []

    def watch(param):
        probs = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data.long()
        losses.append(-torch.log(probs.gather(1, label[:, None]) + 1e-12)
                      .mean())
        grads = [g._data for g in mod._exec.grad_arrays if g is not None]
        finite.append(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=num_epoch,
            batch_end_callback=list(callbacks) + [watch], **fit_kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    per = len(losses) // num_epoch
    epochs = [float(torch.stack(losses[i * per:(i + 1) * per]).mean())
              for i in range(num_epoch)]
    return epochs, len(losses), int(torch.stack(finite).sum()), fit_s


def module_fit(mx, x, y, batch, card, sgd=MODULE_SGD):
    """``Module.fit`` over an NDArrayIter of the images: SGD, Xavier,
    ``eval_metric="acc"`` and a Speedometer, through ``fit_curve``.
    Returns the module, the loss of each epoch, the steps taken and the
    steps whose gradients were all finite."""
    mx.random.seed(0)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(module_resnet(mx, MODULE_BENCH[2]))
    epochs, steps, n_finite, fit_s = fit_curve(
        mod, it, MODULE_EPOCHS, [mx.callback.Speedometer(batch, 2)],
        optimizer="sgd", optimizer_params=sgd,
        initializer=mx.init.Xavier(), eval_metric="acc")
    print("module: Module.fit, ResNet-50 v1 (classes %d) on %d images, "
          "batch %d, %dx%d, fp32, TF32 off, SGD lr %g, %d epochs = %d "
          "steps in %.2f s (%s); loss by epoch %s; gradients all finite in "
          "%d of %d steps; %d conv biases deferred into BatchNorm"
          % (MODULE_BENCH[2], len(x), batch, x.shape[2], x.shape[3],
             sgd["learning_rate"], MODULE_EPOCHS, steps, fit_s, card,
             " ".join("%.4f" % v for v in epochs), n_finite, steps,
             len(mod._exec._bias_defer)))
    return mod, epochs, steps, n_finite


def check_fit(what, epochs, steps, n_finite, want_steps):
    """A fit ran ``want_steps`` steps, every gradient was finite, and the
    loss is finite and fell from the first epoch to the last."""
    if steps != want_steps:
        fail("%s: fit ran %d steps" % (what, steps))
    if not all(np.isfinite(epochs)) or not epochs[-1] < epochs[0]:
        fail("%s: the loss did not fall: %s" % (what, epochs))
    if n_finite != steps:
        fail("%s: non-finite gradients in %d steps"
             % (what, steps - n_finite))


def module_vs_gluon(mx, x, y):
    """One SGD step through the Module and one through the Gluon path
    (``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
    ``Trainer("sgd")``) from the same weights and batch: every weight's
    step, the moving statistics and the loss agree; the deferred conv
    biases' gradients read exactly 0 on the Module side."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    batch = x.shape[0]
    mx.random.seed(1)
    net = vision.resnet50_v1(classes=MODULE_BENCH[2])
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1,) + x.shape[1:]))
    params = {p.name: p for p in net.collect_params().values()}
    old = {n: p.data()._data.detach().clone() for n, p in params.items()}
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                             name="softmax"))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (batch,))])
    mod.set_params({n: params[n].data() for n in mod._param_names},
                   {n: params[n].data() for n in mod._aux_names})
    mod.init_optimizer(optimizer="sgd", optimizer_params=MODULE_STEP_SGD)
    data, label = mx.nd.array(x), mx.nd.array(y)
    mod.forward_backward(mx.io.DataBatch(data=[data], label=[label]))
    probs = mod.get_outputs()[0]._data
    m_loss = float(-torch.log(probs.gather(1, label._data.long()[:, None]))
                   .mean())
    ex = mod._exec
    deferred = [bias[1] for _, bias in ex._bias_defer.values()]
    zero = all(not bool(ex.grad_arrays[i]._data.any()) for i in deferred)
    mod.update()
    m_args, m_aux = mod.get_params()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", MODULE_STEP_SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(batch)
    g_loss = float(loss.mean().asscalar())
    # a deferred bias's gradient is 0 in exact arithmetic: the Gluon
    # step's rounding noise there is held against the net's largest step
    biases = {ex.arg_names[i] for i in deferred}
    steps = {n: p.data()._data.detach() - old[n] for n, p in params.items()
             if n not in m_aux}
    largest = max(float(st.abs().max()) for st in steps.values())
    worst_step, worst_stat, bad = 0.0, 0.0, []
    for n, p in params.items():
        if n in m_aux:
            err, ok = close(m_aux[n]._data, p.data()._data, MODULE_TOL)
            worst_stat = max(worst_stat, err)
        else:
            scale = largest if n in biases \
                else float(steps[n].abs().max()) or 1.0
            err = float((m_args[n]._data - old[n] - steps[n]).abs().max()) \
                / scale
            ok = err <= MODULE_STEP_REL
            worst_step = max(worst_step, err)
        if not ok:
            bad.append(n)
    loss_ok = abs(m_loss - g_loss) <= MODULE_TOL["atol"] \
        + MODULE_TOL["rtol"] * abs(g_loss)
    print("  one Module step vs one Gluon step (record -> "
          "SoftmaxCrossEntropyLoss -> Trainer('sgd'), same weights and "
          "batch): loss %.6f vs %.6f; worst weight step error %.3g of its "
          "largest entry (tol %g), %d params; moving statistics max abs err "
          "%.3g (tol rtol %g, atol %g); %d deferred biases' gradients "
          "exactly 0: %s"
          % (m_loss, g_loss, worst_step, MODULE_STEP_REL, len(params),
             worst_stat, MODULE_TOL["rtol"], MODULE_TOL["atol"],
             len(deferred), zero))
    if bad or not loss_ok or not zero or not deferred:
        fail("module: the Module step differs from the Gluon step: %s, "
             "loss %s, deferred biases zero %s (%d)"
             % (bad[:4], (m_loss, g_loss), zero, len(deferred)))


def module_predict(mx, mod, x, y, card):
    """``Module.score`` and ``Module.predict`` over the images on the
    executor's CUDA graph: 1 capture, then replays, 0 recaptures; the
    probabilities equal an eager predict forward of the same plan."""
    batch = MODULE_BENCH[0]
    ex = mod._exec
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    score = mod.score(it, "acc")
    probs = mod.predict(it)._data
    st = ex.stats()
    run = ex._make_graph_fn(False)
    errs = []
    for i in range(0, len(x), batch):
        ex._gather_inputs({"data": x[i:i + batch]})
        args, aux = ex._values()
        with torch.no_grad():
            want = run(args, aux)[0][0]
        errs.append(float((probs[i:i + batch] - want).abs().max()))
    n_batches = len(x) // batch
    print("  predict: score %s and predict over %d images on the executor's "
          "CUDA graph: graphs %s; probabilities vs an eager predict forward "
          "max abs err %.3g (expected 0)"
          % (score, len(x), st, max(errs)))
    if st != dict(captures=1, replays=2 * n_batches, recaptures=0,
                  signatures=1, eager_rng=0, grouped=0):
        fail("module: predict graphs %s, want 1 capture and %d replays"
             % (st, 2 * n_batches))
    if max(errs) != 0.0:
        fail("module: predict graph differs from eager by %g" % max(errs))
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])
    ms = wall_ms(lambda: mod.forward(feed, is_train=False),
                 iters=MODULE_ITERS)
    print("  predict by graph: %.3f ms a batch, %.1f images/s (%s)"
          % (ms, batch * 1e3 / ms, card))
    return ms


def module_timing(mx, mod, x, y, card):
    """A training step's ms (median after warm-up) with and without
    ``update_metric`` (its host read-back syncs each step), images/s,
    device busy ms by class, the optimizer loop's busy ms alone, the
    idle share and peak memory."""
    batch = MODULE_BENCH[0]
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])
    metric = mx.metric.create("acc")

    def step(with_metric):
        mod.forward_backward(feed)
        mod.update()
        if with_metric:
            mod.update_metric(metric, feed.label)
    def back_to_back(with_metric):
        """Mean ms a step over MODULE_ITERS steps issued back to back,
        one sync at the end (only the metric's read-back syncs between
        them)."""
        step(with_metric)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MODULE_ITERS):
            step(with_metric)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / MODULE_ITERS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = {w: wall_ms(lambda w=w: step(w), iters=MODULE_ITERS)
          for w in (True, False)}
    b2b = {w: back_to_back(w) for w in (True, False)}
    peak = torch.cuda.max_memory_allocated()
    wall, busy, by_class, kernels, _ = profile_steps(
        lambda: step(False), 3, MODULE_CLASSES)
    _, opt_busy, _, _, _ = profile_steps(mod.update, 3, MODULE_CLASSES)
    print("module timing (ResNet-50 v1, batch %d, %dx%d, fp32, TF32 off; "
          "%s): a training step %.3f ms with update_metric, %.3f ms "
          "without (median of %d after warm-up, a sync after each), %.1f "
          "images/s; back to back (one sync after %d steps) %.3f ms with "
          "update_metric, %.3f without; peak memory %.1f MB; profiled: "
          "wall %.3f ms, device busy %.3f ms, idle share %.3f; the "
          "optimizer loop alone %.3f ms busy"
          % (batch, x.shape[2], x.shape[3], card, ms[True], ms[False],
             MODULE_ITERS, batch * 1e3 / ms[True], MODULE_ITERS, b2b[True],
             b2b[False], peak / 2 ** 20, wall, busy,
             1 - busy / wall if wall else float("nan"), opt_busy))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a step" % (cls, cms))
    for us, key, count in kernels[:3]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    return ms, b2b


def phase_module(card):
    """The eleventh slice's main path: ResNet-50 v1 trained through
    ``mx.mod.Module`` on gpu(0) at the reference's benchmark size, one
    Module step held to one Gluon step, predict on the executor's CUDA
    graph, and the step's timings. No attention kernel is on this path:
    the launch counts, zeroed just before, must read 0 after."""
    import mxnet_tpu_torch as mx
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, image, classes = MODULE_BENCH
    rs = np.random.RandomState(70)
    x = rs.randn(MODULE_IMAGES, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, MODULE_IMAGES).astype(np.float32)
    tfa.reset_launches()
    mod, epochs, steps, n_finite = module_fit(mx, x, y, batch, card)
    check_fit("module", epochs, steps, n_finite,
              MODULE_EPOCHS * MODULE_IMAGES // batch)
    module_predict(mx, mod, x, y, card)
    module_timing(mx, mod, x, y, card)
    del mod
    torch.cuda.empty_cache()
    module_vs_gluon(mx, x[:batch], y[:batch])
    torch.cuda.empty_cache()
    if any(tfa.launches.values()):
        fail("module: the Module path launched attention kernels: %s"
             % tfa.launches)
    print("  attention kernel launches on the Module path: %s (none is on "
          "it); module phase %.1f s"
          % (dict(tfa.launches), time.perf_counter() - t_phase))


def zoo_net(mx, name, image):
    """A model-zoo net at its published widths and 1000 classes, Xavier
    from ``mx.random.seed(0)`` on gpu(0), deferred shapes fixed by one
    imperative forward on ``x`` (returned, with its logits)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = vision.get_model(name, classes=ZOO_CLASSES_N)
    net.initialize(mx.init.Xavier())
    x = mx.nd.array(np.random.RandomState(80).randn(
        ZOO_BATCH, 3, image, image).astype(np.float32))
    eager = net(x)._data.clone()
    return net, x, eager


def zoo_case(mx, name, image, card):
    """One family: the hybridized net (one CUDA graph) against the
    imperative run, its graph counters, ms a batch by replay (median of
    RESNET_ITERS after warm-up), images/s, device busy ms by class and
    idle share, peak memory and the share of the FLOP bound."""
    from mxnet_tpu_torch import symbol as sym_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net, x, eager = zoo_net(mx, name, image)
    n_params = sum(p.data().size for p in net.collect_params().values())
    flops, nbytes = resnet_cost(net(sym_mod.var("data")), ZOO_BATCH, image)
    bound, bound_by = resnet_bound(flops, nbytes)
    net.hybridize()
    y = net(x)
    err, ok = close(y._data, eager, ZOO_TOL)
    ms = wall_ms(lambda: net(x))
    wall, busy, by_class, kernels, _ = profile_steps(lambda: net(x), 3,
                                                     ZOO_CLASSES)
    peak = torch.cuda.max_memory_allocated()
    st = net._cached_op.stats()
    n_drop = sum(1 for n in net(sym_mod.var("data"))._topo_nodes()
                 if n.op is not None and n.op.name == "Dropout")
    calls = 1 + RESNET_ITERS + 3 + 4 * 3 + 3
    print("zoo: %s (%d, %dx%d, %.2fM parameters, %d Dropout; %s): graph vs "
          "imperative max abs err %.3g (tol rtol = atol = %g); graphs %s; "
          "%.3f ms a batch, %.1f images/s; %.4g GFLOP a batch, bound "
          "%.4f ms (%s), %.3f of it; peak memory %.1f MB; profiled: wall "
          "%.3f ms, device busy %.3f ms, idle share %.3f"
          % (name, ZOO_BATCH, image, image, n_params / 1e6, n_drop, card,
             err, ZOO_TOL["rtol"], st, ms, ZOO_BATCH * 1e3 / ms,
             flops / 1e9, bound, bound_by, bound / ms, peak / 2 ** 20, wall,
             busy, 1 - busy / wall if wall else float("nan")))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a batch" % (cls, cms))
    for us, key, count in kernels[:2]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    if not ok:
        fail("zoo: %s graph logits differ from the imperative run by %g"
             % (name, err))
    if st != dict(captures=1, replays=calls, recaptures=0, signatures=1,
                  eager_rng=0):
        fail("zoo: %s graphs %s, want 1 capture and %d replays"
             % (name, st, calls))
    if (n_drop > 0) != (name in ZOO_DROPOUT):
        fail("zoo: %s holds %d Dropout" % (name, n_drop))
    return net, x, y._data.clone(), dict(ms=ms, busy=by_class, peak=peak)


def zoo_always_dropout(mx):
    """A net whose Dropout draws in predict mode (``mode="always"``):
    each call op by op, counted as ``eager_rng``, no capture, two
    different draws."""
    class Always(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Dropout(x, p=0.5, mode="always")
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64), Always())
    net.initialize()
    net.hybridize()
    x = mx.nd.ones((8, 32))
    outs = [net(x)._data.clone() for _ in range(3)]
    st = net._cached_op.stats()
    kept = float((outs[1] != 0).float().mean())
    print("  Dropout(mode='always') in predict: graphs %s; two calls "
          "differ: %s; kept %.3f" % (st, not torch.equal(outs[1], outs[2]),
                                     kept))
    if (st["captures"], st["eager_rng"]) != (0, 3) \
            or torch.equal(outs[1], outs[2]):
        fail("zoo: a plan that draws in predict mode gave %s" % st)


def phase_zoo(card):
    """Phase 15, the Gluon vision surface as benchmark_score.py runs it:
    one net per family hybridized on gpu(0), one CUDA graph each, the
    four with Dropout included; a plan that draws in predict mode runs
    op by op, counted. No attention kernel is on this path: the launch
    counts, zeroed just before, must read 0 after. Returns the
    Inception-v3 net, its input and its graph logits."""
    import mxnet_tpu_torch as mx
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    kept = None
    for name, image in ZOO_BENCH:
        t0 = time.perf_counter()
        net, x, y, _ = zoo_case(mx, name, image, card)
        print("    %s %.1f s" % (name, time.perf_counter() - t0))
        if name == "inceptionv3":
            kept = (net, x, y)
        del net, x, y
    zoo_always_dropout(mx)
    if any(tfa.launches.values()):
        fail("zoo: the zoo path launched attention kernels: %s"
             % tfa.launches)
    print("  attention kernel launches on the zoo path: %s (none is on "
          "it); zoo phase %.1f s"
          % (dict(tfa.launches), time.perf_counter() - t_phase))
    return kept


def export_on_card(mx, net, x, y):
    """``export`` then ``SymbolBlock.imports`` on gpu(0): the imported
    block's graph gives the exporting net's logits."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        sym_file, params_file = net.export(os.path.join(tmp, "inc"))
        block = mx.gluon.SymbolBlock.imports(sym_file, ["data0"],
                                             params_file, ctx=mx.gpu(0))
        got = block(x)._data
        got = block(x)._data
    err, ok = close(got, y, ZOO_TOL)
    print("export: inceptionv3 export -> SymbolBlock.imports(['data0']) on "
          "%s: logits max abs err %.3g vs the exporting graph (exactly "
          "equal: %s); imported graphs %s"
          % (got.device, err, torch.equal(got, y),
             block._cached_op.stats()))
    if not ok or block._cached_op.stats()["captures"] != 1:
        fail("export: imported logits differ by %g" % err)


def place_net(mx):
    """tests/test_placement.py's two-group net."""
    data = mx.sym.var("data")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
    with mx.AttrScope(ctx_group="dev2"):
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        out = mx.sym.SoftmaxOutput(h, mx.sym.var("label"), name="softmax")
    return out


def placement_step(mx, sym, g2c):
    """One training step (forward + backward) of an executor bound on
    gpu(0), grouped by ``g2c`` or not, from fixed numpy values."""
    rs = np.random.RandomState(3)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(8, 10), label=(8,))[0]))
    args = {n: mx.nd.array(rs.randn(*shapes[n]).astype(np.float32) * 0.1,
                           ctx=mx.gpu(0)) for n in sym.list_arguments()}
    args["label"] = mx.nd.array(rs.randint(0, 4, (8,)).astype(np.float32),
                                ctx=mx.gpu(0))
    grads = {n: mx.nd.zeros(shapes[n], ctx=mx.gpu(0)) for n in shapes
             if n not in ("data", "label")}
    ex = sym.bind(mx.gpu(0), args, args_grad=grads, group2ctx=g2c,
                  grad_req={n: "write" for n in grads})
    ex.forward(is_train=True)
    ex.backward()
    return ex


def phase_placement(mx, card):
    """Module(group2ctxs={"dev1": cpu(0), "dev2": gpu(0)}): the dev1
    segment's activations and fc1's gradients on the host, the head on
    cuda:0; one grouped step equal to an ungrouped one on gpu(0); the
    JAX test's training reaches accuracy > 0.8."""
    sym = place_net(mx)
    g2c = {"dev1": mx.cpu(0), "dev2": mx.gpu(0)}
    grp = placement_step(mx, sym, g2c)
    ref = placement_step(mx, sym, None)
    worst = 0.0
    for name in ["softmax_output"] + ["fc1_weight", "fc1_bias",
                                      "fc2_weight", "fc2_bias"]:
        a = grp.outputs[0] if name == "softmax_output" \
            else grp.grad_dict[name]
        b = ref.outputs[0] if name == "softmax_output" \
            else ref.grad_dict[name]
        err, ok = close(a._data.cpu(), b._data.cpu(), PLACE_TOL)
        worst = max(worst, err)
        if not ok:
            fail("placement: grouped %s differs from gpu(0)'s by %g"
                 % (name, err))
    seen = {}
    grp.set_monitor_callback(lambda n, v: seen.setdefault(
        n, str(v._data.device)), monitor_all=True)
    grp.forward(is_train=False)
    devs = dict(fc1=seen.get("fc1_output"), relu1=seen.get("relu1_output"),
                fc2=seen.get("fc2_output"),
                fc1_grad=str(grp.grad_dict["fc1_weight"]._data.device),
                head=str(grp.outputs[0]._data.device))
    rng = np.random.RandomState(11)
    X = rng.randn(64, 10).astype(np.float32)
    w = rng.randn(10, 4)
    y = np.argmax(X @ w, axis=1).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=16, label_name="label")
    np.random.seed(5)
    mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0), group2ctxs=g2c)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2},
            initializer=mx.init.Xavier(rnd_type="uniform", magnitude=2))
    fit_s = time.perf_counter() - t0
    it.reset()
    acc = dict(mod.score(it, "acc"))["accuracy"]
    segs = []
    for ctx in mod._exec._op_ctxs:
        if not segs or segs[-1][0] != str(ctx):
            segs.append([str(ctx), 0])
        segs[-1][1] += 1
    print("placement: group2ctxs dev1 -> cpu(0), dev2 -> gpu(0) (%s): "
          "segments %s; devices %s; one grouped step vs gpu(0) alone max "
          "abs err %.3g (tol rtol = atol = %g); Module.fit 10 epochs in "
          "%.2f s, accuracy %.3f; graphs %s"
          % (card, segs, devs, worst, PLACE_TOL["rtol"], fit_s, acc,
             mod._exec.stats()))
    if devs != dict(fc1="cpu", relu1="cpu", fc2="cuda:0", fc1_grad="cpu",
                    head="cuda:0"):
        fail("placement: devices %s" % devs)
    if acc <= 0.8:
        fail("placement: accuracy %.3f" % acc)


def alexnet_vs_gluon(mx, x, y):
    """One AlexNet SGD step through the Module and one through the Gluon
    path (``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
    ``Trainer("sgd")``) from the same weights and batch, each after
    ``mx.random.seed(3)``, so that both draw the same Dropout masks from
    the card's generator: every weight's step within ALEXNET_STEP_REL of
    its largest entry and the loss within MODULE_TOL. Returns, per
    Dropout layer of the Gluon step, its keep fraction and the count of
    nonzero inputs."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    batch = x.shape[0]
    mx.random.seed(2)
    net = vision.alexnet(classes=ALEXNET_TRAIN[2])
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1,) + x.shape[1:]))
    params = {p.name: p for p in net.collect_params().values()}
    old = {n: p.data()._data.detach().clone() for n, p in params.items()}
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                             name="softmax"))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (batch,))])
    mod.set_params({n: params[n].data() for n in mod._param_names},
                   {n: params[n].data() for n in mod._aux_names})
    mod.init_optimizer(optimizer="sgd", optimizer_params=ALEXNET_SGD)
    data, label = mx.nd.array(x), mx.nd.array(y)
    mx.random.seed(3)
    mod.forward_backward(mx.io.DataBatch(data=[data], label=[label]))
    probs = mod.get_outputs()[0]._data
    m_loss = float(-torch.log(probs.gather(1, label._data.long()[:, None]))
                   .mean())
    mod.update()
    m_args, _ = mod.get_params()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", ALEXNET_SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    fractions = []
    mx.random.seed(3)
    with mx.autograd.record():
        # net.features layer by layer (its own order), to read each
        # Dropout's mask
        h = data
        for layer in net.features:
            src, h = h, layer(h)
            if isinstance(layer, mx.gluon.nn.Dropout):
                live = src._data != 0
                fractions.append((float((h._data[live] != 0).float().mean()),
                                  int(live.sum())))
        loss = loss_fn(net.output(h), label)
    loss.backward()
    trainer.step(batch)
    g_loss = float(loss.mean().asscalar())
    worst, bad = 0.0, []
    for n, p in params.items():
        step = p.data()._data.detach() - old[n]
        err = float((m_args[n]._data - old[n] - step).abs().max()) \
            / (float(step.abs().max()) or 1.0)
        worst = max(worst, err)
        if err > ALEXNET_STEP_REL:
            bad.append(n)
    loss_ok = abs(m_loss - g_loss) <= MODULE_TOL["atol"] \
        + MODULE_TOL["rtol"] * abs(g_loss)
    print("  one AlexNet Module step vs one Gluon step (record -> "
          "SoftmaxCrossEntropyLoss -> Trainer('sgd'), same weights, batch "
          "%d and Dropout masks): loss %.6f vs %.6f; worst weight step "
          "error %.3g of its largest entry (tol %g), %d params"
          % (batch, m_loss, g_loss, worst, ALEXNET_STEP_REL, len(params)))
    if bad or not loss_ok:
        fail("alexnet: the Module step differs from the Gluon step: %s, "
             "loss %s" % (bad[:4], (m_loss, g_loss)))
    return fractions


def alexnet_curve(mx, x, y):
    """AlexNet (Xavier from ``mx.random.seed(0)``) trained through
    ``Module.fit`` by ``fit_curve`` over the images for TRAIN_EPOCHS
    epochs. Returns the module and ``fit_curve``'s readings."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = vision.alexnet(classes=ALEXNET_TRAIN[2])
    net.initialize()
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                             name="softmax"))
    it = mx.io.NDArrayIter(x, y, batch_size=ALEXNET_TRAIN[0])
    return mod, fit_curve(mod, it, TRAIN_EPOCHS, optimizer="sgd",
                          optimizer_params=ALEXNET_SGD,
                          initializer=mx.init.Xavier())


def alexnet_fit(mx, card):
    """AlexNet through ``Module.fit`` at batch 512, 224x224, 1000
    classes: SGD over TRAIN_IMAGES random images for TRAIN_EPOCHS epochs,
    Dropout drawing from the executor's generator. First one Module
    step held to a Gluon step with the same Dropout masks (whose keep
    fractions are checked); then every fit step's gradients finite, the
    loss falling from the first epoch to the last, ms a step, images/s,
    idle share and peak memory."""
    batch, image, classes = ALEXNET_TRAIN
    rs = np.random.RandomState(90)
    x = rs.randn(TRAIN_IMAGES, 3, image, image).astype(np.float32)
    y = rs.randint(0, TRAIN_LABELS, TRAIN_IMAGES).astype(np.float32)
    fractions = alexnet_vs_gluon(mx, x[:batch], y[:batch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod, (epochs, steps, n_finite, fit_s) = alexnet_curve(mx, x, y)
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])

    def step():
        mod.forward_backward(feed)
        mod.update()
    ms = wall_ms(step, iters=MODULE_ITERS)
    peak = torch.cuda.max_memory_allocated()
    wall, busy, by_class, _, _ = profile_steps(step, 3, MODULE_CLASSES)
    print("alexnet: Module.fit, AlexNet (classes %d) on %d images, batch "
          "%d, %dx%d, fp32, TF32 off, %d epochs = %d steps in %.2f s (%s); "
          "loss by epoch %s; gradients all finite in %d of %d steps; "
          "Dropout keep fraction in the held step %s (p = 0.5); a step "
          "%.3f ms (median of %d after warm-up), %.1f images/s; peak memory %.1f MB; profiled: "
          "wall %.3f ms, device busy %.3f ms, idle share %.3f"
          % (classes, len(x), batch, image, image, TRAIN_EPOCHS,
             steps, fit_s, card, " ".join("%.4f" % v for v in epochs),
             n_finite, steps,
             ["%.4f of %d" % f for f in fractions], ms, MODULE_ITERS,
             batch * 1e3 / ms, peak / 2 ** 20, wall, busy,
             1 - busy / wall if wall else float("nan")))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a step" % (cls, cms))
    check_fit("alexnet", epochs, steps, n_finite,
              TRAIN_EPOCHS * len(x) // batch)
    if len(fractions) != 2:
        fail("alexnet: %d Dropout layers ran" % len(fractions))
    for frac, n in fractions:
        # 5 binomial standard deviations around 0.5
        if abs(frac - 0.5) > 5 * 0.5 / np.sqrt(n):
            fail("alexnet: Dropout keep fraction %.4f of %d" % (frac, n))


def phase_export_train(card, inception):
    """Phase 16: export -> SymbolBlock.imports on the card, placement
    over cpu(0)/gpu(0) through Module, and AlexNet trained through
    Module with Dropout drawing. No attention kernel is on this path."""
    import mxnet_tpu_torch as mx
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    export_on_card(mx, *inception)
    del inception
    torch.cuda.empty_cache()
    phase_placement(mx, card)
    alexnet_fit(mx, card)
    torch.cuda.empty_cache()
    if any(tfa.launches.values()):
        fail("export/train: attention kernels launched: %s" % tfa.launches)
    print("  attention kernel launches on phase 16: %s; phase %.1f s"
          % (dict(tfa.launches), time.perf_counter() - t_phase))


def kernel_row(name, source, replaces, path, shape, launches, rec, err):
    """One entry of the ``{"kernels": [...]}`` line; the decode kernels'
    also carry their cold-L2 time of one call and the host's splits."""
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               path=path, shape=shape, launches=launches[name],
               max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
               bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
               library_ms=rec["library_ms"], ok=True)
    row.update((key, rec[key]) for key in ("cold_ms", "splits")
               if key in rec)
    return row


def rtc_row(name, rec, launches):
    """One entry of the ``{"kernels": [...]}`` line for an rtc kernel. The
    axpy row (``rtc``) carries the wrapper's count over the rtc path and
    the host times; each other row the count's rise at its own launch."""
    row = dict(name="rtc" if name == "axpy" else "rtc:" + name,
               route="cuda", source=RTC_SRC, replaces=RTC_TPU, path="rtc",
               launches=launches["rtc"] if name == "axpy"
               else rec["launches"], max_abs_err=rec["err"], ok=True)
    row.update((key, val) for key, val in rec.items()
               if key not in ("err", "launches"))
    return row


def main():
    t_start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.serving import ToyDecoderLM
    tfa = importlib.import_module(
        "mxnet_tpu_torch.parallel.flash_attention")
    phase_build()
    print("kernels vs plain (fp32, TF32 off; device ms = GPU time per call"
          " from CUDA-graph replays, per-call ms = median CUDA-event time of"
          " one eager call; %s):" % card)
    fwd, dec, fwd_rungs = phase_kernels(tfa)
    train_fwd, bwd, bwd_errs = phase_bwd_kernels(tfa)
    t0 = time.perf_counter()
    model_k = ToyDecoderLM(**GPT2_SMALL)
    model_p = ToyDecoderLM(impl="plain", **GPT2_SMALL)
    params = model_k.init_params(seed=0, device="cuda")
    print("model: GPT-2-small width, %.1fM parameters, init %.1f s"
          % (sum(p.numel() for p in params.values()) / 1e6,
             time.perf_counter() - t0))
    phase_model(model_k, model_p, params)
    launches, _st = phase_server(model_k, params, tfa)
    pool8 = phase_server_int8(model_k, params, tfa)
    phase_swap(model_k, params)
    q8 = phase_q8_decode(tfa)
    q8_launches, q8_pool_err = phase_q8_pool(tfa, model_k, params, pool8)
    del pool8
    rtc, rtc_launches = phase_rtc(card)
    phase_step_profile(model_k, params, card)
    phase_router(model_k, params, tfa)
    obs_launches = phase_observability(model_k, params, tfa, card)
    obs_dec = decode_case(tfa, OBS_CFG["window"], (OBS_CFG["seq_ladder"][-1]
                          + OBS_CFG["max_new_tokens"]), 12, 64, seed=29)
    del model_k, model_p, params
    torch.cuda.empty_cache()
    train_launches = phase_training(tfa, card)
    phase_resnet(card)
    phase_module(card)
    phase_export_train(card, phase_zoo(card))
    # one row per kernel and main path: launches from that path's run,
    # times at the shape that path gives the kernel
    train_shape = "B%d T%d H12 D64 causal" % (TRAIN_BATCH,
                                              GPT2_SMALL["max_len"])
    kernels = [
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "server",
                   "B1 T512 H12 D64 causal", launches, fwd, fwd["err"]),
        kernel_row("flash_decode", DEC_SRC, DEC_TPU, "server",
                   "B8 T576 H12 D64", launches, dec, dec["err"]),
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "observability",
                   "B1 T128 H12 D64 causal", obs_launches, fwd_rungs[128],
                   fwd_rungs[128]["err"]),
        kernel_row("flash_decode", DEC_SRC, DEC_TPU, "observability",
                   "B8 T192 H12 D64", obs_launches, obs_dec,
                   obs_dec["err"]),
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "training", train_shape,
                   train_launches, train_fwd, train_fwd["err"]),
    ] + [kernel_row(kname, BWD_SRC[kname], BWD_TPU[kname], "training",
                    train_shape, train_launches, bwd[kname],
                    bwd_errs[kname])
         for kname in ("flash_bwd_dkdv", "flash_bwd_dq")] + [
        kernel_row("flash_decode_q8", Q8_SRC, Q8_TPU, "int8 decode",
                   "B8 T576 H12 D64 int8", q8_launches, q8,
                   max(q8["err"], q8_pool_err)),
    ] + [rtc_row(name, rtc[name], rtc_launches) for name in rtc]
    print("total %.1f s" % (time.perf_counter() - t_start))
    print("card:", card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
