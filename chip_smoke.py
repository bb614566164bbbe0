"""On-card smoke run of the PyTorch/CUDA port (mxnet_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (sm_90) and nvcc; exits non-zero, printing
no result, anywhere else. Phases (any failure exits non-zero):

1. device — CUDA present, capability >= (9, 0); prints the card's
   ``nvidia-smi`` name and power limit;
2. build — the five attention kernels and the NMS sweep from
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
   device idle share from the profiler; the Trainer's update is the
   fused step (one CUDA graph replay a step: 1 capture, 0 recaptures
   across the Adam steps), timed beside ``MXNET_FUSED_STEP=0``'s
   per-parameter loop; then 3 more steps under an armed
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
   Speedometer, 10 epochs on the fused step (forward + backward + update
   one CUDA graph replay; the non-finite guard on, so the graph tests
   every gradient): the loss by epoch must fall from the first to
   the last and every step's gradients be finite; ``score`` and
   ``predict`` over the images on the executor's CUDA graph (1 capture,
   then replays, no recapture), the probabilities equal to an eager
   predict forward; a training step's ms (median after warm-up) with and
   without ``update_metric``, images/s, device busy ms by class, the
   eager optimizer loop's alone, the idle share and peak memory, and the
   step with ``MXNET_FUSED_STEP=0``; predict
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
   = 10 steps on the fused step, Dropout drawing from the executor's
   generator inside the graph: the loss finite and falling from the
   first epoch to the last, every step's gradients finite; ms a step
   (and with ``MXNET_FUSED_STEP=0``), images/s, device busy by class,
   the idle share and peak memory. Attention kernel launches, zeroed
   before, must read 0.
17. amp (after 16) — the thirteenth slice's main path, mixed precision
   and the fused step, on ResNet-50 v1 at phase 14's size and data:
   (a) 3 fp32 Module steps by the fused step and 3 eager from the same
   weights under deterministic cuDNN, every array bit-identical, the
   fused graphs 1 capture, 3 replays, 0 recaptures, 0 fallbacks, each
   path's ms a step; (b) bfloat16 AMP through ``Module.fit``
   (``DtypePolicy("bfloat16").cast_params``, the batch cast to bfloat16
   in the symbol, SGD momentum ``multi_precision=True`` at lr 0.0125, 10
   epochs, fused): the loss falls, every gradient finite, each bf16
   weight the cast of its fp32 master, BatchNorm terms fp32; ms a step,
   images/s, idle share, busy by class and peak memory beside phase
   14's fp32 fused and eager steps; (c) one bf16 Gluon step (hybridized,
   ``policy.apply``, fused Trainer) against one bf16 Module step from
   the same weights within AMP_STEP_REL (``scratch/amp_step_spread.py``
   measures the spread); (d) the hybridized forward in bfloat16 by graph
   replay, ms a batch and the share of the bf16 FLOP bound beside phase
   13's fp32; (e) ``MXNET_NONFINITE_GUARD=scale_backoff`` with a planned
   grad NaN on step 3: skipped inside the graph (the weights of steps 2
   and 3 equal), the loss scale halved, ``skipped_steps`` 1, 0
   recaptures; (f) ``fit(checkpoint_prefix=)`` with the async writer, 2
   epochs, a fresh Module resumed from epoch 1 with its optimizer states:
   after epoch 2 bit-identical to an uninterrupted run (deterministic
   cuDNN); a policy checkpoint of the masters resumes under fp32 as
   exactly those masters; a save's blocking ms async and sync, its
   bytes; (g) ``flash_attention`` forward and backward at phase 4's LM
   shape and ``flash_decode`` at the server's window on bfloat16 inputs,
   within one bfloat16 step of the plain versions, bfloat16 out, the
   kernels counted. Attention kernel launches over (a)-(f), zeroed
   before, must read 0.
18. input (after 17) — the fourteenth slice's main path, the input
   path: 256 synthetic 256x320 JPEGs (seed 0: smooth gradients and a
   slow wave plus low-amplitude noise, quality 95) packed by
   ``tools.im2rec`` into a ``.rec``/``.idx`` pair; (a) the decoder
   (cv2, else PIL), ``os.cpu_count()``, the ``.rec`` bytes; (b) MB/s of
   a scan by the Python ``MXRecordIO`` and by the native
   ``PrefetchingRecordReader`` (built with g++); (c) ``ImageRecordIter``
   (3x224x224, resize 256, random crop and mirror, ImageNet mean/std,
   batch 32, ``preprocess_threads`` 4) decoding alone through the
   pipeline's pool at ``MXNET_DATA_WORKERS`` 1, 2 and 4, images/s;
   (d) ResNet-50 v1 ``Module.fit`` over that iterator through the async
   pipeline (placed on cuda:0 by the placer's stream), SGD at lr
   0.0125, 3 epochs = 24 fused steps under a telemetry run: ms a step,
   images/s, the data_wait share, h2d copies and bytes, the fused
   graphs (1 capture, 0 recaptures), the loss finite, the first
   epoch's placed batches bit-identical to the eager iterator's, no
   pipeline thread left; then 2 more epochs with
   ``MXNET_DATA_PIPELINE=0`` and one under the profiler (idle share),
   beside phase 14's step; (d') the same fit over ``NDArrayIter``'s
   split protocol on a fresh module (always runs); (e) ``gluon.data.
   DataLoader(ArrayDataset, num_workers=4, device_prefetch=True)``
   feeding a hybridized Gluon ResNet-50 ``Trainer`` for 5 steps, the
   batches on cuda:0 and h2d accounted; (f) 200 batches placed at depth
   4 while the consumer's stream runs a long kernel before comparing
   each with its host source bitwise (the cross-stream allocator
   check). Without cv2 or PIL, (c) and (d) print "not run: no cv2 or
   PIL on this host" and (b) reads records of random bytes. No kernel
   of the table is on this path: the attention and decode launch
   counts, zeroed before, must read 0.
19. bucketing (after 18) — the fifteenth slice's main path, variable-
   length training, BASELINE config 3 (the reference's
   example/rnn/bucketing/lstm_bucketing.py at its defaults: 2 x
   ``mx.rnn.LSTMCell(200)``, Embedding 200, FC to the vocabulary of
   10000, ``SoftmaxOutput(use_ignore=True, ignore_label=0)``, buckets
   10-60, batch 32, SGD lr 0.01, momentum 0, wd 1e-5, Xavier(in,
   2.34), ``Perplexity(0)``) on a synthetic corpus of PTB's shape
   (``lm_corpus``: 4096 sentences from seed 0), fp32, TF32 off.
   (a) ``BucketingModule.fit`` over ``rnn.BucketSentenceIter``, 2
   epochs on the fused step: one capture per bucket seen, none new and
   no recapture in epoch 2, no fused-step fallback, the perplexity
   falling from epoch 1 to 2; each capture's ms, ms a step by bucket
   (forward + backward + update replayed, no metric), real and padded
   tokens/s over epoch 2, the padding share, the metric's host ms, the
   bucket-60 step's idle share and kernels (its graph's nodes) under
   the profiler, peak memory; (b) the same fit with
   ``MXNET_FUSED_STEP=0`` and its ms a step, and one bucket-60 step
   each way from the same weights: probabilities and every array
   bit-identical but ``embed_weight`` (atomics), held to
   LM_EMBED_STEP_REL; (c) the ``FusedRNNCell`` variant (one ``RNN`` op,
   2 layers of 200) from (a)'s weights (its probabilities equal the
   unrolled cells' within LM_FUSED_TOL), fitted and read as (a), and
   the ``RNN`` op's forward + backward at T60 N32 H200 by graph replay
   beside cuDNN's ``torch._VF.lstm`` on the same weights (a yardstick
   only); (d) a hybridized Gluon LM (``gluon.rnn.LSTM(200,
   num_layers=2)``) trained by ``Trainer`` on ``bucketing.
   BucketedPipeline`` batches with ``MaskedSoftmaxCELoss`` and
   ``masked_batch_loss``: the loss falls, the fused update 1 capture,
   one predict graph per bucket; (e) ``bucketing.PackedPipeline``
   batches (seed 0, ladder [256], 72 samples of 16-240 positions, each
   q, k and v at H12 D64) through ``_contrib_flash_attention`` with
   their segment plane, causal, forward and backward on the kernels:
   held to the plain version (TOL, BWD_TOL), no gradient outside the
   touched sample, launch counts zeroed just before and read just
   after (one each of flash_fwd, flash_bwd_dkdv and flash_bwd_dq a
   batch); then the three kernels timed at B8 T256 on that segment
   plane (as phases 3-4). Attention and decode launches over (a)-(d),
   zeroed before, must read 0.
20. gan (after 19) — the sixteenth slice's main path, the rest of the
   Gluon surface and ``mx.random``, fp32 with TF32 off: (a) each of the
   17 sampling ops (``_random_*``, ``_sample_*``, ``_sample_multinomial``
   with ``get_prob``, ``_shuffle``) at 2^20 draws made on gpu(0), with
   no host-to-device copy while they draw (profiler), held to the
   moments and bounds of tests/test_random_samplers.py with its
   tolerances scaled by sqrt(40000 / 2^20), ``randint`` within a
   chi-square bound, the shuffle a permutation, the tensor-parameter
   rows each to its own parameters; ``mx.random.seed(n)`` repeats the
   draws and ``seed(n, ctx=gpu(0))`` restarts only the card's; (b) the
   new layers (the LeakyReLU family, rrelu in predict mode,
   ``InstanceNorm``, ``HybridLambda``, the three ``PixelShuffle``s)
   hybridized on the card at the DCGAN's shapes, the ten losses and
   ``norm``, against the port on the CPU from the same numpy inputs
   (outputs, input and parameter gradients, the predict graph's output;
   rtol = atol = 1e-5), and the five new initializers bit-identical on
   both under one numpy seed; (c) the DCGAN of MXNet's Gluon GAN
   tutorial at its widths (nz 100, ngf = ndf = 64, 64x64, batch 64;
   ``summary()`` counts 3,576,704 trainable parameters in G and
   2,765,568 in D), ``Normal(0.02)``, ``SigmoidBCELoss``, two
   ``Trainer("adam", beta1=0.5)`` at lr 2e-4, both nets hybridized, the
   latent drawn by ``mx.nd.random.normal`` on gpu(0) each step: the
   first step bit-identical to the same nets run op by op under
   deterministic cuDNN, D's first loss near 2 ln 2; then 150 steps on
   2048 synthetic images (``gan_images``, seed 0) under the non-finite
   guard: no step skipped, every loss finite, the tutorial's binary
   accuracy of D above chance, G's samples in [-1, 1], no graph
   recaptured; ms a GAN step, images/s, device busy by class
   (convolutions, Adam, BatchNorm/elementwise), the idle share and peak
   memory. Attention, decode and rtc launches over (a)-(c), zeroed
   before, must read 0.
21. ops (after 20) — the seventeenth slice, the operator breadth, fp32
   with TF32 off: (a) every registered op whose body lives in the
   port's elemwise, reduce, matrix, indexing, init_ops, nn, linalg,
   extra, deformable or control_flow module and does not draw (the
   list taken from the registry; ``_foreach``, ``_while_loop`` and
   ``_cond`` over subgraphs built with ``mx.sym.contrib``, the cond
   both ways;
   an op without a case in ``ops_cases`` fails the phase) runs on
   gpu(0) and on cpu() from the same numpy inputs (the reference's
   ``check_consistency``): outputs and input gradients within OPS_TOL
   of each other (normwise, max |gpu - cpu| / max |cpu|; OPS_WIDE
   states the wider ones), indices and counts bit-equal (the ties of
   ``sort``/``argsort``/``topk``/``argmax``), at the LM's activations
   (8 x 1024 x 768), (b)'s attention shapes and vocabulary, and 64 SPD
   matrices of 128 x 128; gelqf's and syevd's rows aligned by sign
   first; every GPU run under ``torch.cuda.set_sync_debug_mode``: an op
   that makes the host wait fails, but OPS_SYNC_OK; the count swept and
   the ten largest errors printed; (b) ToyDecoderLM's GPT-2-small-width
   decoder written in ``mx.sym`` with the slice's ops (``sym_lm``:
   ``batch_dot``, ``_contrib_div_sqrt_dim``, a causal mask from
   ``_arange`` with ``broadcast_lesser_equal``/``broadcast_like``,
   ``softmax_cross_entropy`` under ``MakeLoss``, ``topk`` under
   ``BlockGrad``) on ``ToyDecoderLM.init_params(seed=0)``: its logits
   at B1 T512 against ``ToyDecoderLM.prefill`` (the flash_fwd route;
   LOGIT_ATOL), 16 greedy tokens in a fixed T512 window against the
   model's prefill + decode stream (a difference only at a printed
   top-2 gap below LOGIT_ATOL); one fused ``Module`` step against one
   eager from the same weights (as phase 14 holds a step); then
   ``Module.fit`` over an ``NDArrayIter`` of synthetic tokens, batch 8
   x 1024, Adam lr 1e-3, 5 steps on the fused step: 1 capture, 0
   recaptures, the loss falling; ms a step, tokens/s, busy by class
   (``batch_dot`` products, FC products, the rest, from the eager
   step's profile), the idle share and peak memory. The attention,
   decode and rtc launch counts, zeroed before the symbol's runs, must
   read 0 after.
22. kvstore (after 21) — the eighteenth slice, ``mx.kv`` on
   ``torch.distributed``, fp32 with TF32 off and deterministic cuDNN:
   (a) ``device`` and ``local`` stores on gpu(0), every call under
   ``torch.cuda.set_sync_debug_mode("error")``: a list push of four
   per-context copies pulled as the exact list-order sum into the
   destinations' own tensors (``data_ptr`` unchanged), an updater
   accumulating over three pushes, 2-bit compression and its residual
   over three pushes bit-equal to the plain formula; then two ranks,
   separate processes under ``python -m mxnet_tpu_torch.tools.launch -n
   2`` (``chip_smoke.py kv-rank DIR``), both on gpu(0), whose process
   group is gloo's by the backend rule (two ranks share the card; gloo
   stages CUDA tensors through the host): (b) the dense assertions of
   tests/test_dist_kvstore.py (34-67), a barrier, a planned
   ``push:step=1:raise`` on both ranks retried to the same bytes,
   ``dist_async``'s one warning; (c) BASELINE config 5 at its published
   width: ``model_zoo.vision.resnet18_v1(classes=10)`` on 3x32x32,
   hybridized, ``Trainer("sgd", lr 0.05, momentum 0.9, wd 1e-4,
   kvstore="dist_sync")``, 64 images a rank a step of
   ``kv_cifar`` (examples/train_gluon_cnn.py's synthetic_cifar, seed 0),
   12 steps, both ranks seeded alike, once per key and once with
   ``MXNET_GRAD_OVERLAP=1``: every parameter bit-identical across the
   ranks and across the two exchanges, rank 0's arrays bit-identical to
   the two-replica twin run here (``kv_twin``), the update graph 1
   capture and 0 recaptures a rank, the loss falling; ms a step (median
   of steps 5-20) split into forward + backward, ``sync`` and the
   update, images/s over both ranks, the exchange's GB/s, peak memory;
   (d) config 1's MLP through ``Module.fit(kvstore="dist_sync")``, 2
   ranks x 50 for 10 steps, ``update_on_kvstore`` True, against a
   one-process fit at batch 100 within KV_MLP_TOL; (e)
   ``tools.bandwidth.measure`` over ResNet-18's shapes, ``device`` store,
   2 worker copies here, and a two-rank dist_sync push + pull round over
   the same shapes, both in GB/s with the reference's accounting (the
   second a one-card, process-to-process figure). A failing rank fails
   the phase with its last lines. The attention, decode and rtc launch
   counts, zeroed before, read 0 here and on every rank.
23. sparse (after 22) — the nineteenth slice, sparse storage, BASELINE
   config 4 (``example/sparse``'s factorization machine at MXNet v1.5's
   defaults: 2,000,000 features, factor 16, batch 1000) on a synthetic
   libsvm file of Criteo's shape (``fm_rows``: 39 features a row, 13
   numeric and 26 categorical fields, each field's ids from its own range
   drawn Zipf-skewed; 50,000 rows from seed 0), fp32 with TF32 off: (a)
   the sparse primitives at the FM's shapes on gpu(0) against the host
   (FM_TOL): csr (1000 x 2M, 39 stored a row) ``dot`` a (2M, 16) matrix,
   transposed against (1000, 16) and against a vector, ``cast_storage``
   dense -> row_sparse -> dense at (2M, 16) with one batch's rows non-zero
   and dense <-> csr at FM_CSR_COLS columns, ``retain``, ``csr + csr``,
   ``_square_sum`` and ``getnnz``, each with its host syncs, and
   ``dot``'s per-call ms beside ``torch.sparse.mm``'s (a yardstick
   only); (b) SGD with momentum, Adam, AdaGrad and Ftrl lazy at (2M, 16)
   on one batch's rows: untouched rows and states bit-identical, touched
   rows within FM_TOL of the host, ``lazy_update=False`` densifying;
   Adam's lazy update timed in its parts beside the dense update; (c) the
   FM of tests/test_sparse.py (two ``nn.Embedding(sparse_grad=True)``
   and the pairwise term, ``SigmoidBinaryCrossEntropyLoss``, Adam lr
   0.02) trained through ``gluon.Trainer`` on batches of
   ``mx.io.LibSVMIter``, 2 epochs: step 1 against the host from the same
   weights, epoch 2's mean loss below epoch 1's, ``fused_step_fallbacks``
   = steps (a sparse step runs eagerly); ms a step (median and range),
   samples/s, the idle share and busy ms by stage (profiler ranges),
   host syncs a step, peak memory; (d) a ``local`` store's
   ``row_sparse_pull`` of the trained v by five batches' ids equal to
   those weight rows bit for bit, then two ranks through phase 22's
   launcher (``chip_smoke.py sparse-rank DIR``) each pushing the
   row_sparse v gradient of its own batch: the stored union equal to the
   one-process sum bit for bit on both ranks, no push densifying, a
   push's ms and bytes; (e) the attention, decode and rtc launch counts,
   zeroed before, read 0.
24. mesh (after 23) — the twentieth slice, the rank mesh, fp32 with TF32
   off: the three flash kernels held to their plain versions (and timed
   beside SDPA and their bounds) at the shapes the mesh gives them, B2
   T1024 H6 D64 (Ulysses over sp = 2) and B4 T1024 H12 D64 (a dp rank);
   (a)'s twin in this process: phase 10's Gluon LM (``gluon_lm`` behind
   ``mesh_lm``'s one input, seed 0) one Adam step through the Gluon
   ``Trainer`` on the global batch 8 x 1024; then two ranks under phase
   22's launcher (``chip_smoke.py mesh-rank DIR``, gloo, both on
   gpu(0)): (a) ``parallel.DistributedTrainer`` over ``{"dp": 2}`` with
   ``grad_overlap=True`` (ZeRO-1) and ``param_shard=True`` (FSDP), Adam
   lr 1e-3, MESH_STEPS steps on the global batch (4 rows a rank), a
   manifest checkpoint every FT_STEPS steps and the heartbeat armed (this
   run is phase 27 (a)): the ranks'
   initial weights equal the twin's, step 1 within MESH_STEP1_FLIP of
   the twin (the loss before and after within LOSS_ATOL), the loss
   falling and equal on both ranks, overlap off and FSDP off
   bit-identical to it after MESH_IDENT_STEPS steps, one SGD step's exchanged gradient
   within phase 10's gradient tolerances of the twin's, parameter and
   Adam-state bytes a rank about half the twin's, 12 launches of each
   flash kernel a step (counts zeroed just before the steps and read
   just after); ms a step, ``sync`` ms (the FSDP entry gather
   included), peak memory; (b) the LM at B2 T1024 over ``{"sp": 2}`` (512 positions a
   rank), forward and backward with ``impl="ulysses"`` then ``"ring"``,
   gradients summed over sp, against the one-process flash route on the
   same weights (logits within MESH_LOGIT_ATOL, gradients within phase
   10's tolerances), ms fwd + bwd for each; Ulysses launches each flash
   kernel 12 times a rank, ring none (its block is plain torch). Both
   get phase 10's second pass: (a)'s twin again on the global batch with
   each layer's ReLU replaced by the ranks' masks (their rows), (b)'s
   one-process route with the ranks' masks (their sequence halves), every
   gradient within GRAD_RTOL_SHARED.
25. mesh axes (after 24) — the twenty-first slice, every mesh axis, fp32
   with TF32 off. Four ranks under phase 22's launcher (``chip_smoke.py
   mesh4-rank DIR``): (a) phase 24's LM and batch through the
   ``DistributedTrainer`` over ``{"dp": 2, "sp": 2}`` (B4 x T512 a rank,
   ring attention through the op's auto route, global positions, ZeRO-1
   and FSDP over dp), Adam lr 1e-3, MESH4_STEPS steps: step 1's loss
   before and after within LOSS_ATOL of phase 24's twin, the loss falling
   and equal on every rank; one SGD step's exchanged gradient at both of
   phase 10's tiers (the second with the ranks' ReLU masks, their rows
   and sequence halves, in the twin); (b) the same over ``{"dp": 2,
   "tp": 2}`` with FSDP: each weight at rest as its 2-D piece, parameter
   bytes a rank the rules' (projections 1/4, embeddings 1/2, norms whole),
   the losses equal to phase 24 (a)'s first MESH4_STEPS bit for bit;
   then (phase 27 (d)) its state saved once (the 2-D pieces and their
   Adam state, each piece under its global index), loaded by a fresh
   trainer, and one more step of each: losses, pieces and state equal
   bit for bit.
   Then eight ranks (``python -m mxnet_tpu_torch.dryrun rank``, the
   dryrun's own worker, gloo on gpu(0)): (c) ``dryrun_multichip``'s step
   at the JAX entry point's dims over ``dp2/tp2/sp2`` and ``dp2/pp2/sp2``,
   (d) the same step at GPT-2-small width (D768 H12 F3072 E4 T1024, B =
   2 * dp * n_micro: 8 and 16): the loss within DRY_LOSS_RTOL and every
   updated shard within DRY_ATOL + DRY_RTOL * max|w| of a one-process
   twin of the step on the card (plain attention). Every rank prints ms a
   step, ``sync`` ms, peak memory, the gloo-staged bytes and its share of
   the parameter bytes; the flash launch counts, zeroed before each path,
   are read after it: (a), (c) and (d) launch none (ring attention's
   block is plain torch), (b) 12 of each flash kernel a step.

26. serve (after 25) — the twenty-second slice, deploy and serve, fp32
   with TF32 off. (a) ResNet-50 v1 as phase 13 builds it (1000 classes,
   3x224x224, seed 0) exported by ``mx.deploy.export_compiled`` on the
   card with buckets SERVE_BUCKETS, loaded (every program on cuda:0) and
   served by ``InferenceServer(max_queue=64, batch_window_ms=2.0)``:
   ``warmup()`` captures the three bucket graphs (``compile_watch``:
   three sites, one compile each); 8 client threads x 8 requests (seed 1):
   no compile and no recapture during traffic, replays = batches, each
   answer within SERVE_TOL of the hybridized net on its sample alone and
   bit-identical to the Predictor's program at its bucket; export s,
   bytes, capture ms, requests/s, latency, occupancy, batches by bucket,
   ms a batch at bucket 32 by replay beside phase 13's CachedOp replay;
   a shed drill and a deadline drill (``MXNET_FAULT_PLAN`` hang at
   ``serve_dispatch``). (b) examples/serve_artifact.py's convnet exported
   in a CPU-only subprocess (``chip_smoke.py export-cpu DIR``) and
   on the card, both served on cuda:0: no program names the CPU, answers
   within PORTABLE_TOL. (c) phase 10's LM (163.0M parameters, not
   hybridized) as an in-process callable, ladder LM_SERVE_LADDER x seq
   LM_SERVE_SEQ: a capture each, flash_fwd 12 launches a replay
   (counters zeroed before the traffic, read after), per-position max
   logit and argmax against the model alone; hybridized, its CachedOp
   captures nothing inside a bucket graph. (d) phase 14's
   ``Module.fit`` under
   ``MXNET_COMPILE_WATCH=1`` for WATCH_STEPS steps: one
   ``fused_step:module`` compile, a step's flops within WATCH_FLOPS_REL of
   the hand count, the utilization record's MFU = flops / (step s x the
   table's fp32 peak).
27. fault tolerance (after 26) — the twenty-third slice, multi-host
   fault tolerance, fp32 with TF32 off. (a) is phase 24 (a)'s run:
   FT_EPOCHS epochs of FT_STEPS steps of the LM over ``{"dp": 2}``
   (ZeRO-1, FSDP, Adam) on the global batch, a manifest checkpoint after
   each epoch, the heartbeat armed at MXNET_HB_TIMEOUT_MS =
   FT_HB_TIMEOUT_MS. (b) the same two ranks (``chip_smoke.py ft-rank
   DIR``, gloo, both on gpu(0)) under ``python -m mxnet_tpu_torch.tools.
   launch --supervise --resume-prefix --events-file``, rank 1 carrying
   ``proc_exit:step=FT_KILL_STEP:raise`` in generation 0 (at epoch 1's
   first step, after epoch 0's manifest):
   the events launch, worker_failed, teardown, restart, launch, success;
   the restart resumes from epoch 0's manifest, its final weights equal
   (a)'s bit for bit (SHA-256 a parameter) and its losses (a)'s last
   epochs', the last manifest records ``processes: 2``; no false host
   loss in (a) or (b); detection to relaunch from the events file, save
   and load ms, bytes a rank, ms a step before and after the restart, 12
   launches of each flash kernel a step (zeroed before the steps, read
   after). (c), beside (b): a wedged host; both ranks join and place the
   model, then rank 1's heartbeat writer stalls for good
   (``proc_hb:step=1:stall:count=inf``, timeout FT_WEDGE_TIMEOUT_MS):
   rank 0 exits 43 with ``HostLostError``, the launcher with it; stall
   to detection from the monitor's message. (d) runs inside phase 25
   (b): the ``{dp: 2, tp: 2}`` FSDP state saved, loaded by a fresh
   trainer, one more step of each bit for bit.
28. deploy, the rest (after 27) — the twenty-fourth slice, fp32 with TF32
   off: the attention kernels as ``torch.library`` ops
   (``mxnet_tpu_torch::flash_fwd`` and its backward pair,
   ``::flash_decode``, ``::flash_decode_q8``) in artifacts, and format-3
   int8 artifacts. (a) phase 10's LM (seed 0) with (max logit, argmax)
   heads exported on the card with buckets LM_ART_BUCKETS at T
   LM_ART_T, loaded with ``load_compiled`` and served by the
   ``InferenceServer``: a capture a bucket in warmup, none in traffic; 32
   requests of 100-1024 tokens (seed 2) padded at the end, each
   position's (max logit, argmax) against the model alone at
   LM_SERVE_TOL; the meta names ``flash_fwd``, every program calls it
   and none of the plain attention's ops; flash_fwd 12 launches a
   replay (zeroed before the traffic, read after), the plain attention
   never called; ms a B8 T1024 batch by the artifact's replay beside
   phase 26 (c)'s in-process callable and the hybridized net's
   CachedOp; export s a bucket and the artifact's bytes. (b) FC ->
   flash attention -> FC (ATT_SHAPE's widths) exported in phase 26 (b)'s
   CPU-only subprocess and on the card, both served on cuda:0: flash_fwd launched by the CPU export's
   programs, answers within PORTABLE_TOL of the card export's. (c)
   ``_contrib_decode_attention`` at B8 T576 H12 D64 (lengths an input)
   exported and run through the Predictor at random lengths and at
   576, 1, ..., 1: flash_decode launched once a call, held to the plain
   version at DEC_ART_TOL. (d) phase 26 (a)'s ResNet-50 v1 and weights
   through ``contrib.quantization.quantize_model`` (naive, 4 batches of
   32 synthetic images, seed 3) and ``export_compiled(quantize=True)``
   with buckets Q8_BUCKETS: the 54 calibrated ranges equal
   quantize_model's, ``max_abs_delta`` recomputed op by op within
   Q8_DELTA_TOL; 8 clients x 16 requests (seed 5), each answer held to
   the quantized Symbol op by op on the batch the server formed
   (Q8_TOL) and to the Predictor's program at its bucket bit for bit;
   requests/s and the bucket-32 replay beside phase 26 (a)'s fp32;
   device ms by kernel class (int8 GEMM, im2col copies) and by op class
   (quantized products, quantize, requantize, dequantize). (e) host µs
   a ``flash_attention`` call through the op beside ``_fwd_cuda`` at B1
   T64, and with ``_build.library`` made to fail an op call on cuda:0
   raises ``MXNetError``.
29. control flow (after 28) — the twenty-fifth slice, fp32 with TF32
   off, BASELINE config 3 at phase 19's constants with its time loop
   ONE ``_foreach`` node (``mx.sym.contrib.foreach``, the cells called
   once in the body, so phase 19's parameter names): (a) 41 batches of
   phase 19's corpus (up to CF_PER_BUCKET a bucket, all six buckets)
   through BucketingModule on the fused step against phase 19's
   unrolled twin from the same Xavier weights: each batch's loss
   within CF_LOSS_REL, one capture a bucket, none again, no fused-step
   fallback; each bucket's capture s and ms a step beside the twin's.
   (b) greedy generation from (a)'s weights as ONE ``_while_loop``
   node bound in predict mode: batch 32, the first 10 tokens of 32
   corpus sentences as prompts, ``n_steps`` an input of 40 of
   CF_MAX_ITER (the masked tail runs), each step's token ``cond(i <
   10, prompt[:, i], the last argmax)``; its first call eager under
   ``set_sync_debug_mode("error")``, then one capture and
   CF_REPLAYS replays; the tokens equal a host loop's of nd calls, the
   tail rows zero; replay ms against the host loop's. (c) (a)'s LM at
   bucket 30 through ``Module.fit`` for 20 batches with a ``Custom``
   softmax loss written in NDArray calls against a SoftmaxOutput twin
   on the fused step: losses and weights within CF_CUSTOM_REL, one
   ``fused_step_fallbacks`` a step, the user's ``in_data`` on gpu(0); a
   hybridized block holding ``F.Custom``: 0 captures, its calls
   counted as ``eager_host``. (d) the LM as a Gluon block
   (``F.contrib.foreach``) recorded eagerly on one batch: ``get_symbol``
   of its logits bound with the block's parameters within
   CF_SYMBOL_TOL; the gates through a user ``autograd.Function`` (the
   stable sigmoid) give the built-in sigmoid's gradients within
   CF_FUNCTION_TOL. (e) ``Monitor(monitor_all=True)`` on (a)'s module
   for one step sees the ``_foreach`` node's outputs, the step one
   counted fallback; ``print_summary``'s total for the foreach LM
   equals the unrolled LM's. The attention, decode and rtc launch
   counts read 0 over the phase.
30. vision (after 29) — the twenty-sixth slice, fp32 with TF32 off,
   through ``parallel/csrc/nms_sweep.cu`` (greedy NMS, redesigned in the
   thirtieth: one chain a class from a stable sort of the class ids, a
   short chain's bit mask and sweep in one block's shared memory, a long
   chain's mask across the card and its sweep 64 boxes a step). (a) the
   SSD300 head
   of MXNet v1.5's example/ssd ``get_config('vgg16_reduced', 300)``: its
   six maps' MultiBoxPrior anchors (8732), 21 classes, batch 32,
   ``cls_prob`` a softmax of seeded logits, 1-42 boxes an image (seed 0,
   -1 padded): MultiBoxTarget, MultiBoxDetection (nms_threshold 0.45,
   threshold 0.01, nms_topk 400, which is not read) and box_nms over its
   output, nms_sweep counted (zeroed before, read after: 2); each call's
   keep mask bit-equal to ``nms_keep_plain`` over all 32 samples on the
   card (the plain version 8 samples a call), the head at B2 within
   rtol = atol = 1e-5 of its plain path (every NMS through
   ``nms_keep_plain``); the head and the NMS call at B32 by CUDA-graph
   replay, the call's parts (the class order and the kernel's four
   passes, each launched alone) by CUDA events around replays. (a')
   MultiBoxDetection with force_suppress=True at B32 (one chain of 8732
   a sample, the long-chain worst case), nms_sweep counted 1, its keep
   mask held on NMS_CHUNK samples, timed the same way. (b) Faster R-CNN
   (VGG16, example/rcnn's test defaults: 600x1000, stride 16, 38x63
   features, scales (8, 16, 32), ratios (0.5, 1, 2), pre 6000, post
   300, threshold 0.7, min size 16): Proposal at B1 and MultiProposal
   at B2 bit-equal to their plain path (2 launches), then ROIPooling and
   ROIAlign (7x7, 1/16, sample_ratio 2) of (1, 512, 38, 63) over the 300
   proposals, forward and backward, with their peak memory (no (R, PH,
   PW, C, H, W) tensor) and the card against the host on 32 RoIs. (c)
   Deformable R-FCN's res5: DeformableConvolution 3x3 512->512, pad 2,
   dilate 2, 4 deformable groups, no bias, on (1, 512, 38, 63);
   PSROIPooling and DeformablePSROIPooling (21 x 7x7 over 1029
   channels, 4 samples a part, trans_std 0.1) over the 300 RoIs; forward
   and backward, card against host within VISION_REL. (d) ``mx.image``:
   ImageDetIter with CreateDetAugmenter (rand_crop 0.5, rand_pad 0.5,
   rand_mirror, mean/std) over a .rec of 256 synthetic 300x300 JPEGs
   (seed 0), batch 32, images/s, the last batch into (a)'s
   MultiBoxTarget. (e) a hybridized block holding dgl ops on gpu(0):
   run op by op (``eager_host``), no capture. The new device ops' card
   against host cases are phase 21 (a)'s. The attention, decode and rtc
   launch counts read 0 over the phase.
31. breadth (after 30) — the twenty-seventh slice, the rest of the
   breadth, fp32 with TF32 off; no TPU kernel lies on it. (a) Shi et
   al. 2015's best Moving MNIST ConvLSTM ("Convolutional LSTM Network",
   NeurIPS) at full width, ``gluon.contrib.rnn.Conv2DLSTMCell``s in
   ``HybridSequentialRNNCell``s: 64x64 frames as 16 channels of 4x4
   patches at 16x16, an encoder of three cells (128, 64, 64 hidden, 5x5
   i2h and h2h) over 10 frames, a forecaster of the same widths
   unrolled 10 steps from its states, a 1x1 convolution over the
   forecaster's concatenated states to 16 channels, per-pixel sigmoid
   cross-entropy, RMSProp lr 1e-3 (the paper's), batch 16 of synthetic
   bouncing squares (seed 0; no Moving MNIST download); hybridized,
   CLSTM_STEPS steps of ``autograd.record`` -> ``backward`` ->
   ``Trainer.step``: step 1's loss equal to an un-hybridized twin's
   (same weights) within CLSTM_TOL, the fused update 1 capture and 0
   recaptures, the loss falling; ms a step and peak memory. (b) MXNet
   v1.5 example/rnn/large_word_lm's LSTM-2048-512:
   ``VariationalDropoutCell(LSTMPCell(2048, 512))``, embedding 512,
   bptt 20, batch 128, dropout 0.1 on inputs, states and outputs,
   hybridized, one fwd + bwd twice (cut: the head is a full softmax
   over 10,000 ids, where the example samples over 793,471 ids, which
   the JAX package does not do): three ``Dropout`` nodes in the traced
   graph (one a mask), the output mask shared by all 20 steps of a call
   and scaled by 1/(1-p), a fresh mask at the second call; in predict
   mode one CUDA graph, masks all ones. (c) ``contrib.
   svrg_optimization.SVRGModule`` on gpu(0) over
   tests/test_aux_subsystems.py's least-squares problem, fed by
   ``contrib.io.DataLoaderIter``, the fused step on: after a snapshot,
   two corrected steps equal w - lr (g - g_snap + g_full) computed by
   hand on the card within SVRG_TOL, each counted in
   ``fused_step_fallbacks``; ``fit`` for 3 epochs halves the mse.
   (d) the helpers: ``test_utils.check_consistency`` of (a)'s first
   cell over ``[cpu(), gpu(0)]`` (forward and every argument gradient),
   ``runtime.Features()`` (CUDA and CUDNN on, TPU, XLA and PALLAS off),
   ``storage.memory_stats(0)["bytes_in_use"]`` growing by a 256 MiB
   allocation, (a)'s block in predict mode inside
   ``engine.naive_engine()`` with no capture (then one outside it), and
   ``libinfo.find_lib_path()`` listing phase 2's kernel libraries. The
   counts of the kernel table's rows 1-7 (attention, decode, rtc,
   nms_sweep), zeroed before, read 0 over the phase.

32. contexts on distinct devices in one process: the in-process ``dp``
   mesh over ``[gpu(0), cpu(0)]`` (cuda:0 and the host, the two torch
   devices this machine has; N CUDA devices take the same code path),
   fp32, TF32 off. (a) BASELINE config 5 at its published width,
   ``resnet18_v1(classes=10)`` on 3x32x32 as phase 22 builds it (Xavier,
   hybridized, SGD momentum 0.9, lr 0.05; the compared steps start
   after 10 steps on gpu(0), past the moving means' zero start, see
   DM_WARM), batch 32 through
   ``split_and_load`` (16 a shard), 4 steps against a twin on
   ``[gpu(0)]`` from the same weights and data: losses within rtol
   5e-4, atol 5e-5, final weights within rtol 5e-3, atol 1e-4 (the JAX
   oracle's, tests/test_data_parallel.py); ms a step, each shard's share
   (its 16 images' forward and backward alone on its device), and the
   gather counter per op (``ops.mesh_stats()``), empty for ResNet-18.
   (b) the same net as a Symbol with a ``SoftmaxOutput`` head:
   ``Module(context=[gpu(0), cpu(0)]).fit`` over 4 batches against the
   one-context twin (per-batch cross-entropy and final weights, the
   same tolerances), a bind at batch 33 raises ``MXNetError``, and
   ``get_outputs()[0]`` is one global (32, 10) array. (c) (a) again
   under ``MXNET_GRAD_OVERLAP=1``: the bucketed reduce-scatter and
   ZeRO-1 sharded update over the two devices equals (a)'s plain run at
   the same tolerances, each device holding its slice of the momentum;
   then, under the non-finite guard, an inf planted in the CPU shard's
   head gradient skips that step on both devices (weights unchanged,
   ``skipped_steps`` 1) and the next step trains. (d)
   ``gluon.contrib.nn.MeshMultiHeadAttention`` (units 256, 4 heads,
   causal) over the mesh at B4 T256 H4 D64, forward and backward,
   against the one-device run (rtol = atol = 1e-5 forward, 1e-4 the
   gradients); the flash_fwd/flash_bwd_dkdv/flash_bwd_dq launch counts
   over the mesh run equal those of a gpu(0) run over the CUDA shard's
   B2 alone (the CPU shard runs the plain versions), and the kernels at
   that shape against their plain versions, timed.

33. the persistent compile cache (``mxnet_tpu_torch.compile_cache``):
   every nvcc build of the phase goes through ``$CUDA_HOME/bin/nvcc``,
   a wrapper that logs each call and runs the real nvcc. (a) cold start:
   a child process on a fresh ``MXNET_COMPILE_CACHE_DIR`` builds
   ``flash_decode`` and ``nms_sweep`` through ``_build.build_all`` (two
   nvcc builds, started together) and compiles phase 8's module
   (``RTC_KERNELS``) by NVRTC for its ``axpy``, launched and held to
   ``y + a*x``; after ``flush()``: misses 3, stores 3, 3 entries on
   disk. (b) warm start: a second child on that directory with the
   compile watch and a telemetry run on. A hybridized block over
   ``_contrib_decode_attention`` at the server's shape (B8 T576 H12
   D64, lengths from seed 33) is the path (launch counts zeroed just
   before, read just after CC_CALLS calls): its one capture loads
   ``flash_decode`` from disk, its ``compile`` record is tagged
   ``"hit"`` and ``site_stats()`` counts ``cache_hits``; its output is
   held to the plain version (rtol = atol = 1e-5); then ``nms_sweep``
   loads and its keep mask equals ``nms_keep_plain``'s, and the axpy
   loads (``from_cache``; NVRTC's compile entry point called 0 times)
   and matches. Hits 3, misses 0, no nvcc build. The decode kernel is
   then timed at that shape as in phase 3 (the row "compile cache, warm
   start"). (c) faults, in this process: ``nms_sweep``'s entry cut in
   half reads as one counted miss and error, is rebuilt (one nvcc
   build) and its launch's keep mask still equals the plain version's,
   under an ``MXNET_COMPILE_CACHE_MB`` one byte under the three
   entries, which evicts (``stats()["evictions"] > 0``).

Cuts for phase 31's time (in depth: every check kept): phase 24 (b)'s
timed Ulysses/ring iterations MESH_SP_ITERS 3 -> 1; phases 24 (a) and
27 FT_STEPS 2 -> 1 an epoch (MESH_STEPS 4 -> 2 Adam steps; phase 27 (b)'s
kill at its step boundary 4 -> 2, epoch 1's first step, and its resumed
steps 2 -> 1); phase 26 (a)'s requests SERVE_PER_CLIENT 16 -> 8 a
client, (b)'s CONVNET_BUCKETS [1, 2, 4, 8] -> [1, 8] and
CONVNET_REQUESTS 32 -> 16, (c)'s LM_SERVE_REQUESTS 16 -> 8, (d)'s
WATCH_STEPS 5 -> 3. Cuts for phase 33's time (the same way): phase
19 (d)'s Gluon LM LM_GLUON_STEPS 96 -> 64; phase 20 (c)'s
GAN_STEPS 300 -> 150 and GAN_TIMED 20 -> 10; phase 21 (b)'s
SYM_LM_STEPS 10 -> 5; phase 22 (c)'s KV_STEPS 20 -> 12; phase 23's
FM_ROWS 100,000 -> 50,000.

It prints a ``{"kernels": [...]}`` line, one entry per kernel and main
path (``path``: server, observability, training, int8 decode, rtc,
packing, mesh dp / mesh sp ulysses / mesh dp x tp, rank 0's launches,
serving (InferenceServer), fault tolerance (b), rank 0's launches in
its second generation, LM artifact (InferenceServer), CPU-exported
artifact, decode artifact, ssd detection or rpn proposal, in-process
mesh [gpu(0), cpu(0)], compile cache, warm start;
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
import logging
import math
import os
import random
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
                                  r"dq|decode_q8|decode|list|short|long_mask|"
                                  r"long_sweep)_kernel)"
                                  r"(?:I((?:L[ib]\d+E)+)E)?", ln)
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
             time_splits=False, seg=None):
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
    if segmented and seg is None:
        seg = segment_plane(B, Tq, seed, dev)
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


def bwd_case(tfa, B, Tq, Tk, H, D, causal, segmented, seed, probe=False,
             seg=None):
    """Both backward kernels against their plain versions on one input,
    with a zero cotangent on rows that attend to nothing (a masked
    loss), and the backward of scaled_dot_product_attention as the
    yardstick; with ``probe``, also :func:`probe_comparison`. Returns
    {kernel name: record}."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, do = (torch.randn(B, Tq, H, D, generator=g).to(dev) for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev) for _ in range(2))
    if segmented and seg is None:
        seg = segment_plane(B, Tq, seed, dev)
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
    sign, and counts the positions where the two disagree (``flips``);
    with ``mask`` None it is the plain ReLU."""

    class SharedReLU(mx.gluon.nn.Activation):
        def __init__(self, mask, **kwargs):
            super().__init__("relu", **kwargs)
            self.mask, self.flips = mask, 0

        def hybrid_forward(self, F, x):
            if self.mask is None:
                return super().hybrid_forward(F, x)
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

    def full_step():
        step_loss(net)
        trainer.step(B)
    fused_ms = wall_ms(full_step, iters=5, warm=1)
    fst = trainer._fused_updater.stats()
    with fused_gate(False):
        eager_ms = wall_ms(full_step, iters=5, warm=1)
    print("  the Trainer's fused update (one CUDA graph replay a step): "
          "%.1f ms a step; with MXNET_FUSED_STEP=0 (the per-parameter "
          "loop) %.1f ms a step (%s); fused graphs %s"
          % (fused_ms, eager_ms, card, fst))
    if fst["captures"] != 1 or fst["recaptures"] != 0:
        fail("training: the fused update's graphs %s, want 1 capture and "
             "no recapture across the Adam steps" % fst)
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
                  eager_rng=0, eager_host=0):
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


@contextlib.contextmanager
def guard_on(policy="skip_step"):
    """The non-finite guard on for the block (``MXNET_NONFINITE_GUARD``),
    its state fresh before and after."""
    from mxnet_tpu_torch import fault
    old = os.environ.get("MXNET_NONFINITE_GUARD")
    os.environ["MXNET_NONFINITE_GUARD"] = policy
    fault.reset()
    try:
        yield fault
    finally:
        if old is None:
            os.environ.pop("MXNET_NONFINITE_GUARD", None)
        else:
            os.environ["MXNET_NONFINITE_GUARD"] = old
        fault.reset()


@contextlib.contextmanager
def env_set(name, value):
    """The environment variable ``name`` set to ``value`` for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def fused_gate(on):
    """``MXNET_FUSED_STEP`` set to ``on`` for the block."""
    return env_set("MXNET_FUSED_STEP", "1" if on else "0")


def fit_curve(mod, it, num_epoch, callbacks=(), **fit_kw):
    """``mod.fit(it, ...)`` with a batch-end watch after ``callbacks``:
    each batch's loss from the SoftmaxOutput probabilities and whether
    every gradient of the step was finite. Under the fused step the
    gradients live inside its CUDA graph and never reach the executor's
    arrays, so the fit runs with the non-finite guard on (``skip_step``):
    the graph tests every gradient and a step with a non-finite one
    counts in ``fault.stats()["skipped_steps"]``; the eager path's
    gradient arrays are tested on the device as well. Returns the mean
    loss of each epoch, the steps taken, the steps whose gradients were
    all finite and the fit's seconds."""
    losses, finite = [], []
    with guard_on() as fault:
        skipped = [fault.stats()["skipped_steps"]]

        def watch(param):
            probs = mod.get_outputs()[0]._data
            label = param.locals["data_batch"].label[0]._data.long()
            losses.append(-torch.log(probs.float().gather(1, label[:, None])
                                     + 1e-12).mean())
            grads = [g._data for g in mod._exec.grad_arrays
                     if g is not None]
            now = fault.stats()["skipped_steps"]
            finite.append(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all()
                          & (now == skipped[-1]))
            skipped.append(now)
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
                  signatures=1, eager_rng=0, eager_host=0, grouped=0):
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
    with fused_gate(False):
        eager_ms = wall_ms(lambda: step(False), iters=MODULE_ITERS)
        e_wall, e_busy, _, _, _ = profile_steps(lambda: step(False), 3,
                                                MODULE_CLASSES)
    fst = mod._fused.stats() if mod._fused else None
    print("module timing (ResNet-50 v1, batch %d, %dx%d, fp32, TF32 off; "
          "%s): a training step by the fused step's graph replay %.3f ms "
          "with update_metric, %.3f ms without (median of %d after "
          "warm-up, a sync after each), %.1f images/s; back to back (one "
          "sync after %d steps) %.3f ms with update_metric, %.3f without; "
          "peak memory %.1f MB; profiled: wall %.3f ms, device busy %.3f "
          "ms, idle share %.3f; the eager optimizer loop alone %.3f ms "
          "busy; with MXNET_FUSED_STEP=0 (eager forward + backward + "
          "loop) %.3f ms a step, idle share %.3f; fused graphs %s"
          % (batch, x.shape[2], x.shape[3], card, ms[True], ms[False],
             MODULE_ITERS, batch * 1e3 / ms[True], MODULE_ITERS, b2b[True],
             b2b[False], peak / 2 ** 20, wall, busy,
             1 - busy / wall if wall else float("nan"), opt_busy, eager_ms,
             1 - e_busy / e_wall if e_wall else float("nan"), fst))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a step" % (cls, cms))
    for us, key, count in kernels[:3]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    return dict(fused_ms=ms[False], eager_ms=eager_ms,
                idle=1 - busy / wall if wall else float("nan"),
                eager_idle=1 - e_busy / e_wall if e_wall else float("nan"))


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
    timing = module_timing(mx, mod, x, y, card)
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
    return timing


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
                  eager_rng=0, eager_host=0):
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
    with fused_gate(False):
        eager_ms = wall_ms(step, iters=MODULE_ITERS)
    print("alexnet: Module.fit, AlexNet (classes %d) on %d images, batch "
          "%d, %dx%d, fp32, TF32 off, %d epochs = %d steps in %.2f s (%s); "
          "loss by epoch %s; gradients all finite in %d of %d steps; "
          "Dropout keep fraction in the held step %s (p = 0.5); a step by "
          "the fused step's graph replay %.3f ms (median of %d after "
          "warm-up), %.1f images/s, with MXNET_FUSED_STEP=0 %.3f ms; "
          "fused graphs %s; peak memory %.1f MB; profiled: "
          "wall %.3f ms, device busy %.3f ms, idle share %.3f"
          % (classes, len(x), batch, image, image, TRAIN_EPOCHS,
             steps, fit_s, card, " ".join("%.4f" % v for v in epochs),
             n_finite, steps,
             ["%.4f of %d" % f for f in fractions], ms, MODULE_ITERS,
             batch * 1e3 / ms, eager_ms,
             mod._fused.stats() if mod._fused else None, peak / 2 ** 20,
             wall, busy, 1 - busy / wall if wall else float("nan")))
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


# ---------------------------------------------------------------------------
# phase 17: mixed precision and the fused step
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12
AMP_SGD = dict(MODULE_SGD, multi_precision=True)
AMP_STEPS = 3
# one bf16 Module step against one bf16 Gluon step (phase 17 (c), under
# deterministic cuDNN): each master's step, the worst entry's difference
# over the step's largest entry. The Module's SoftmaxOutput takes its
# softmax in bf16 and the Gluon loss in fp32, and a bf16 backward
# carries that rounding difference through 53 BatchNorms: in fp32 the
# same two steps part by 2.3e-4 (phase 14), in bf16 by 0.079-0.213 over
# four seeds' weights on phase 17's batch, the same with cuDNN free and
# deterministic (scratch/amp_step_spread.py; NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md, PR 13). Held at 0.3: a missing loss-scale division,
# a wrong rate or a bf16 update of the master moves a step by 1 or more.
AMP_STEP_REL = 0.3
# a bfloat16 result held to its plain version computed on the same
# bfloat16 inputs, both float32 inside: the two float32 results agree to
# ~1e-5, so after the cast to bfloat16 an entry moves by at most one
# bfloat16 step, 2^-7 of the largest magnitude
BF16_STEP = 2.0 ** -7


def amp_resnet(mx, classes):
    """ResNet-50 v1 for bfloat16 training: the traced symbol casts the
    batch to bfloat16 first (the data iterator stays float32), then
    ``SoftmaxOutput``."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1(classes=classes)
    net.initialize()
    return mx.sym.SoftmaxOutput(net(mx.sym.var("data").astype("bfloat16")),
                                name="softmax")


def amp_module(mx, sym, x, policy, seed, opt=AMP_SGD):
    """A Module over ``sym`` bound at phase 14's batch, Xavier from
    ``mx.random.seed(seed)``, its parameters cast by ``policy``
    (``cast_params``; None keeps float32), SGD with ``opt``."""
    batch = MODULE_BENCH[0]
    mod = mx.mod.Module(sym)
    mod.bind(data_shapes=[("data", (batch,) + x.shape[1:])],
             label_shapes=[("softmax_label", (batch,))])
    mx.random.seed(seed)
    mod.init_params(initializer=mx.init.Xavier())
    if policy is not None:
        args, auxs = mod.get_params()
        mod.set_params(policy.cast_params(args), auxs)
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    return mod


def param_tensors(mod):
    """Every argument and auxiliary state of the bound executor, by name
    (the live tensors)."""
    ex = mod._exec
    out = {n: ex.arg_dict[n]._data for n in mod._param_names}
    out.update((n, ex.aux_dict[n]._data) for n in mod._aux_names)
    return out


def masters_of(mod):
    """``{name: fp32 master tensor}`` from a Module's multi-precision
    optimizer state."""
    opt, upd = mod._optimizer, mod._updater
    out = {}
    for i, name in enumerate(mod._param_names):
        st = upd.states.get(i)
        if st is None:
            continue
        m = opt.master_from_state(mod._exec.arg_dict[name], st)
        if m is not None:
            out[name] = m._data
    return out


@contextlib.contextmanager
def deterministic_cudnn():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def amp_fused_vs_eager(mx, x, y, card):
    """(a) three fp32 Module steps by the fused step and three eager
    from the same weights and batch, deterministic cuDNN: every weight
    and moving statistic bit-identical; the fused graphs 1 capture, 3
    replays, 0 recaptures, 0 fallbacks. Returns each path's ms a step."""
    from mxnet_tpu_torch import profiler
    batch = MODULE_BENCH[0]
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])
    sym = module_resnet(mx, MODULE_BENCH[2])
    ends, ms, stats = {}, {}, {}
    fb0 = profiler.counters().get("fused_step_fallbacks", 0)
    with deterministic_cudnn():
        for fused in (True, False):
            with fused_gate(fused):
                mod = amp_module(mx, sym, x, None, seed=4,
                                 opt=MODULE_SGD)
                times = []
                for _ in range(AMP_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mod.forward_backward(feed)
                    mod.update()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ends[fused] = {n: t.clone()
                               for n, t in param_tensors(mod).items()}
                stats[fused] = mod._fused.stats() if mod._fused else None
                ms[fused] = wall_ms(lambda: (mod.forward_backward(feed),
                                             mod.update()),
                                    iters=MODULE_ITERS)
                del mod
                torch.cuda.empty_cache()
    fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - fb0
    differ = [n for n in ends[True]
              if not torch.equal(ends[True][n], ends[False][n])]
    print("amp (a): 3 fp32 ResNet-50 Module steps fused vs 3 eager, same "
          "weights and batch, deterministic cuDNN (%s): %d of %d arrays "
          "bit-identical; fused graphs after the 3 steps %s; fallbacks %d; "
          "ms a step (median of %d after warm-up, deterministic cuDNN) "
          "fused %.3f, eager %.3f"
          % (card, len(ends[True]) - len(differ), len(ends[True]),
             stats[True], fallbacks, MODULE_ITERS, ms[True], ms[False]))
    if differ:
        fail("amp: fused and eager steps differ in %s" % differ[:4])
    if stats[True] is None or (stats[True]["captures"],
                               stats[True]["recaptures"]) != (1, 0) \
            or fallbacks:
        fail("amp: fused graphs %s, fallbacks %d" % (stats[True],
                                                    fallbacks))
    # the first three replays: stats were read after them, before timing
    if stats[True]["replays"] != AMP_STEPS:
        fail("amp: %d replays in %d fused steps" % (stats[True]["replays"],
                                                    AMP_STEPS))
    return ms


def amp_fit(mx, x, y, card, fp32):
    """(b) bfloat16 AMP through ``Module.fit``: ResNet-50 v1 with its
    parameters cast by ``DtypePolicy("bfloat16").cast_params``, SGD
    momentum with ``multi_precision=True`` at phase 14's lr, 10 epochs on
    the fused step: the loss falls, every gradient finite, each bfloat16
    weight the bfloat16 cast of its fp32 master, BatchNorm terms fp32;
    then ms a step, images/s, idle share, busy by class and peak memory
    beside phase 14's fp32 readings."""
    from mxnet_tpu_torch.amp import DtypePolicy
    batch = MODULE_BENCH[0]
    policy = DtypePolicy("bfloat16")
    torch.cuda.reset_peak_memory_stats()
    mod = amp_module(mx, amp_resnet(mx, MODULE_BENCH[2]), x, policy,
                     seed=0)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    epochs, steps, n_finite, fit_s = fit_curve(
        mod, it, MODULE_EPOCHS, optimizer="sgd", optimizer_params=AMP_SGD,
        eval_metric="acc")
    check_fit("amp", epochs, steps, n_finite,
              MODULE_EPOCHS * MODULE_IMAGES // batch)
    dtypes = {n: str(t.dtype).replace("torch.", "")
              for n, t in param_tensors(mod).items()}
    masters = masters_of(mod)
    bad = [n for n, m in masters.items()
           if not torch.equal(mod._exec.arg_dict[n]._data,
                              m.to(torch.bfloat16))]
    norm = [n for n in dtypes if any(r in n for r in ("gamma", "beta",
                                                      "moving_"))]
    low = [n for n in dtypes if dtypes[n] == "bfloat16"]
    if bad or not masters or len(masters) != len(low) \
            or any(dtypes[n] != "float32" for n in norm):
        fail("amp: weights vs masters %s, %d masters for %d bf16 weights, "
             "norm dtypes %s" % (bad[:4], len(masters), len(low),
                                 sorted({dtypes[n] for n in norm})))
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])

    def step():
        mod.forward_backward(feed)
        mod.update()
    ms = wall_ms(step, iters=MODULE_ITERS)
    peak = torch.cuda.max_memory_allocated()
    wall, busy, by_class, kernels, _ = profile_steps(step, 3,
                                                     MODULE_CLASSES)
    _, opt_busy, _, _, _ = profile_steps(mod.update, 3, MODULE_CLASSES)
    print("amp (b): Module.fit, ResNet-50 v1 in bfloat16 (DtypePolicy "
          "cast_params: %d bf16 weights with fp32 masters, %d BatchNorm "
          "terms fp32), SGD momentum lr %g multi_precision, %d epochs = %d "
          "steps on the fused step in %.2f s (%s); loss by epoch %s; "
          "gradients all finite in %d of %d steps; every bf16 weight the "
          "cast of its master"
          % (len(low), len(norm), AMP_SGD["learning_rate"], MODULE_EPOCHS,
             steps, fit_s, card, " ".join("%.4f" % v for v in epochs),
             n_finite, steps))
    print("  bf16 step %.3f ms (median of %d after warm-up), %.1f images/s; "
          "peak memory %.1f MB; profiled: wall %.3f ms, device busy %.3f "
          "ms, idle share %.3f; the eager optimizer loop alone %.3f ms "
          "busy; fused graphs %s"
          % (ms, MODULE_ITERS, batch * 1e3 / ms, peak / 2 ** 20, wall, busy,
             1 - busy / wall if wall else float("nan"), opt_busy,
             mod._fused.stats()))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a step" % (cls, cms))
    for us, key, count in kernels[:3]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    print("  beside phase 14 (fp32, TF32 off): fused %.3f ms a step (idle "
          "%.3f), eager %.3f ms (idle %.3f); bf16 fused %.3f ms (idle "
          "%.3f): %.2fx the fp32 fused step's speed"
          % (fp32["fused_ms"], fp32["idle"], fp32["eager_ms"],
             fp32["eager_idle"], ms, 1 - busy / wall if wall else 0.0,
             fp32["fused_ms"] / ms))
    return mod, ms


def amp_gluon_vs_module(mx, x, y, seed=1):
    """(c) one bfloat16 Gluon step (hybridized net, ``policy.apply``,
    the fused Trainer, ``multi_precision``) against one bfloat16 Module
    step (fused) from the same weights and batch: every weight's step
    within AMP_STEP_REL of its largest entry, the moving statistics
    within MODULE_TOL. The Module's SoftmaxOutput takes its softmax in
    bfloat16 and the Gluon loss in float32 (the logits cast first), so
    the two steps part by bfloat16 rounding: AMP_STEP_REL is the spread
    measured on the card (see its definition). Returns the worst step
    error and the moving statistics' error."""
    from mxnet_tpu_torch.amp import DtypePolicy
    from mxnet_tpu_torch.gluon.model_zoo import vision
    batch = x.shape[0]
    policy = DtypePolicy("bfloat16")
    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=MODULE_BENCH[2])
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1,) + x.shape[1:]))
    policy.apply(net)
    params = {p.name: p for p in net.collect_params().values()}
    old = {n: p.data()._data.detach().clone() for n, p in params.items()}
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(
        net(mx.sym.var("data").astype("bfloat16")), name="softmax"))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", (batch,))])
    mod.set_params({n: params[n].data() for n in mod._param_names},
                   {n: params[n].data() for n in mod._aux_names})
    opt = dict(MODULE_STEP_SGD, multi_precision=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    data, label = mx.nd.array(x), mx.nd.array(y)
    mod.forward_backward(mx.io.DataBatch(data=[data], label=[label]))
    mod.update()
    m_masters = masters_of(mod)
    m_args, m_aux = mod.get_params()
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(data.astype("bfloat16")).astype("float32"),
                       label)
    loss.backward()
    trainer.step(batch)
    g_masters = {n: m._data for n, m in mx.amp.master_params(
        trainer).items()}
    # a deferred conv bias's Module gradient is 0 in exact arithmetic:
    # the Gluon step's rounding noise there is held against the net's
    # largest step, as in phase 14
    ex = mod._exec
    biases = {ex.arg_names[bias[1]] for _, bias in ex._bias_defer.values()}
    steps = {n: g_masters.get(n, p.data()._data).detach().float()
             - old[n].float() for n, p in params.items() if n not in m_aux}
    largest = max(float(st.abs().max()) for st in steps.values())
    worst, worst_stat, rows = 0.0, 0.0, []
    for n, p in params.items():
        if n in m_aux:
            err, _ = close(m_aux[n]._data, p.data()._data, MODULE_TOL)
            worst_stat = max(worst_stat, err)
            continue
        m_new = m_masters.get(n, m_args[n]._data).float()
        scale = largest if n in biases \
            else float(steps[n].abs().max()) or 1.0
        err = float((m_new - old[n].float() - steps[n]).abs().max()) / scale
        rows.append((err, n))
        worst = max(worst, err)
    rows.sort(reverse=True)
    print("amp (c): one bf16 Module step vs one bf16 Gluon step (hybridized, "
          "policy.apply, fused Trainer, multi_precision; same weights and "
          "batch): worst master step error %.4g of its largest entry (tol "
          "%g; largest: %s), moving statistics max abs err %.3g (tol rtol "
          "%g, atol %g); fused Trainer graphs %s"
          % (worst, AMP_STEP_REL, ", ".join("%s %.3g" % (n, e)
                                            for e, n in rows[:3]),
             worst_stat, MODULE_TOL["rtol"], MODULE_TOL["atol"],
             trainer._fused_updater.stats()))
    if worst > AMP_STEP_REL or not np.isfinite(worst) \
            or worst_stat > 1e-2:
        fail("amp: the bf16 Module step differs from the Gluon step by %g "
             "(stats %g)" % (worst, worst_stat))
    return worst, worst_stat


def amp_inference(mx, card, fp32_reading):
    """(d) ResNet-50 v1's hybridized forward in bfloat16 (``policy.apply``
    on the net, a bfloat16 batch) by graph replay at batch 32, 224x224:
    ms a batch and the share of the bfloat16 FLOP bound, beside phase
    13's fp32 reading."""
    from mxnet_tpu_torch.amp import DtypePolicy
    from mxnet_tpu_torch import symbol as sym_mod
    batch, image, classes = RESNET_BENCH
    net = resnet_net(mx, 50, batch, image, classes)
    flops, _ = resnet_cost(net(sym_mod.var("data")), batch, image)
    DtypePolicy("bfloat16").apply(net)
    nbytes = sum(p.data()._data.numel() * p.data()._data.element_size()
                 for p in net.collect_params().values()) \
        + batch * 3 * image * image * 2 + batch * classes * 2
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(60).randn(
        batch, 3, image, image).astype(np.float32)).astype("bfloat16")
    out = net(x)
    if str(out.dtype) != "bfloat16" or not bool(
            torch.isfinite(out._data.float()).all()):
        fail("amp: bf16 inference output %s, finite %s"
             % (out.dtype, bool(torch.isfinite(out._data.float()).all())))
    ms = wall_ms(lambda: net(x))
    st = net._cached_op.stats()
    wall, busy, by_class, _, _ = profile_steps(lambda: net(x), 3,
                                               RESNET_CLASSES)
    fp = fp32_reading
    print("amp (d): ResNet-50 v1 hybridized forward in bfloat16 by graph "
          "replay, batch %d, %dx%d (%s): %.3f ms a batch, %.1f images/s, "
          "%.3f of the bf16 bound (%.4f ms: %.4g GFLOP at %g TFLOP/s); "
          "idle share %.3f; graphs %s; beside phase 13's fp32 hybridized "
          "%.3f ms (%.1f images/s): %.2fx"
          % (batch, image, image, card, ms, batch * 1e3 / ms, bound / ms,
             bound, flops / 1e9, PEAK_BF16_FLOPS / 1e12,
             1 - busy / wall if wall else float("nan"), st, fp["ms"],
             fp["images_s"], fp["ms"] / ms))
    for cls, cms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print("    %-24s %.3f ms a batch" % (cls, cms))
    return ms


def amp_guard(mx, x, y, card):
    """(e) the non-finite guard under ``scale_backoff`` on the bfloat16
    Module: a planned ``grad`` NaN on step 3 (every parameter's visit of
    that step): the step is skipped inside the graph (the weights after
    steps 2 and 3 equal), the loss scale halves, ``skipped_steps`` reads
    1, and the graph is never recaptured."""
    from mxnet_tpu_torch.amp import DtypePolicy
    batch = MODULE_BENCH[0]
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:batch])],
                           label=[mx.nd.array(y[:batch])])
    with guard_on("scale_backoff") as fault:
        mod = amp_module(mx, amp_resnet(mx, MODULE_BENCH[2]), x,
                         DtypePolicy("bfloat16"), seed=6)
        n = len(mod._exec._grad_positions)
        fault.set_plan("grad:step=%d:nan:count=%d" % (2 * n + 1, n))
        scale0 = fault.loss_scale()
        snaps = []
        for _ in range(4):
            mod.forward_backward(feed)
            mod.update()
            snaps.append({k: t.clone() for k, t in
                          param_tensors(mod).items()})
        st = fault.stats()
        # the weights hold; the moving statistics move in any forward
        held = all(torch.equal(snaps[1][k], snaps[2][k])
                   for k in mod._param_names)
        moved = any(not torch.equal(snaps[2][k], snaps[3][k])
                    for k in mod._param_names)
        fst = mod._fused.stats()
        scale = fault.loss_scale()
        fault.set_plan(None)
    print("amp (e): scale_backoff guard, planned grad NaN on step 3 of 4 "
          "(%d parameter visits; %s): weights after steps 2 and 3 equal %s, "
          "step 4 moved them %s; loss scale %g -> %g; skipped_steps %d; "
          "fused graphs %s"
          % (n, card, held, moved, scale0, scale, st["skipped_steps"], fst))
    if not held or not moved or scale != scale0 / 2 \
            or st["skipped_steps"] != 1 or fst["recaptures"] != 0 \
            or fst["captures"] != 1:
        fail("amp: the guard's skip: held %s, moved %s, scale %g, "
             "skipped %d, graphs %s" % (held, moved, scale,
                                       st["skipped_steps"], fst))


def amp_checkpoints(mx, x, y, card):
    """(f) ``fit(checkpoint_prefix=)`` with the async writer, 2 epochs of
    the bfloat16 Module; a fresh Module resumed from epoch 1 with
    ``resume_from_checkpoint=True`` and its optimizer states, then epoch
    2: its weights, masters and moving statistics equal an uninterrupted
    3-epoch run's bit for bit (deterministic cuDNN). A policy checkpoint
    of the fp32 masters resumes under fp32 as exactly those masters. The
    blocking ms of a save, async and sync, and the bytes written."""
    import tempfile
    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.amp import DtypePolicy
    batch = MODULE_BENCH[0]
    policy = DtypePolicy("bfloat16")
    sym = amp_resnet(mx, MODULE_BENCH[2])
    ends = {}
    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        prefix = os.path.join(tmp, "r50")
        for run in ("straight", "first", "resumed"):
            mod = amp_module(mx, sym, x, policy, seed=8)
            it = mx.io.NDArrayIter(x, y, batch_size=batch)
            kw = dict(optimizer="sgd", optimizer_params=AMP_SGD,
                      eval_metric="acc")
            if run == "straight":
                mod.fit(it, num_epoch=3, **kw)
            elif run == "first":
                mod.fit(it, num_epoch=2, checkpoint_prefix=prefix, **kw)
            else:
                mod = mx.mod.Module(sym)
                mod.fit(it, num_epoch=3, checkpoint_prefix=prefix,
                        resume_from_checkpoint=True, **kw)
            torch.cuda.synchronize()
            ends[run] = dict({n: t.clone() for n, t in
                              param_tensors(mod).items()},
                             **{"master:" + n: m.clone()
                                for n, m in masters_of(mod).items()})
            if run == "first":
                arg, aux = mod.get_params()
                states = mod._optimizer_state_bytes()
                mast = {n: mx.nd.NDArray(m) for n, m in
                        masters_of(mod).items()}
            del mod
            torch.cuda.empty_cache()
        from mxnet_tpu_torch import fault
        resumed_from = fault.stats()["resumed_from_epoch"]
        blocking, nbytes = {}, {}
        for async_ in (True, False):
            mgr = ck.CheckpointManager(os.path.join(tmp, "t%d" % async_),
                                       async_=async_)
            mgr.save(0, arg, aux, states_bytes=states)
            blocking[async_] = mgr.last_blocking_ms
            mgr.close()
            nbytes[async_] = mgr.stats()["bytes_written"]
        pol_prefix = os.path.join(tmp, "pol")
        mgr = ck.CheckpointManager(pol_prefix, async_=False,
                                   meta={"dtype_policy": policy.describe()})
        mgr.save(0, mast, aux)
        a32, _ = ck.restore_params(pol_prefix, 0,
                                   policy=DtypePolicy("float32"))
        exact = all(torch.equal(a32[n]._data.to(m._data.device), m._data)
                    for n, m in mast.items())
    differ = [k for k in ends["straight"]
              if not torch.equal(ends["straight"][k], ends["resumed"][k])]
    print("amp (f): Module.fit with checkpoint_prefix (async writer), 2 "
          "epochs, then a fresh Module resumed from epoch %s with its "
          "optimizer states for epoch 2 (%s): %d of %d arrays (weights, "
          "masters, moving statistics) bit-identical to an uninterrupted "
          "3-epoch run; a save's blocking ms async %.2f, sync %.2f, %d "
          "bytes written (params, states); the policy checkpoint's fp32 "
          "resume equals the masters exactly: %s"
          % (resumed_from, card, len(ends["straight"]) - len(differ),
             len(ends["straight"]), blocking[True], blocking[False],
             nbytes[True], exact))
    if differ or resumed_from != 1 or not exact \
            or nbytes[True] != nbytes[False]:
        fail("amp: resume differs in %s (from %s), masters exact %s"
             % (differ[:4], resumed_from, exact))


def amp_attention(tfa, card):
    """(g) bfloat16 attention: ``flash_attention`` forward and backward
    at phase 4's LM shape (B8 T1024 H12 D64, causal) and ``flash_decode``
    at the server's window (B8 T576 H12 D64), bfloat16 inputs: the
    outputs and gradients bfloat16, each within one bfloat16 step of its
    plain version (BF16_STEP of the largest magnitude), the launch
    counters counting the kernels."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(12)

    def bf(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)) \
            .to(dev, torch.bfloat16)
    B, T, H, D = TRAIN_BATCH, GPT2_SMALL["max_len"], 12, 64
    q, k, v, do = bf(B, T, H, D), bf(B, T, H, D), bf(B, T, H, D), \
        bf(B, T, H, D)
    res = {}
    for impl in (None, "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if impl is None:
            tfa.reset_launches()
        out = tfa.flash_attention(*leaves, causal=True, impl=impl)
        out.backward(do)
        torch.cuda.synchronize()
        if impl is None:
            launches = dict(tfa.launches)
        res[impl] = [out] + [t.grad for t in leaves]
    errs = []
    for name, a, b in zip(("o", "dq", "dk", "dv"), res[None], res["plain"]):
        a, b = a.detach().float(), b.detach().float()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        errs.append((name, err, scale))
        if err > BF16_STEP * scale:
            fail("amp: bf16 flash_attention %s err %g of %g"
                 % (name, err, scale))
    dtypes = {t.dtype for t in res[None]}
    if dtypes != {torch.bfloat16}:
        fail("amp: bf16 flash_attention returned %s" % dtypes)
    want = dict.fromkeys(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), 1)
    if any(launches[n] != c for n, c in want.items()):
        fail("amp: bf16 attention launches %s" % launches)
    Tw = SERVER_CFG["seq_ladder"][-1] + SERVER_CFG["max_new_tokens"]
    W = SERVER_CFG["window"]
    qd, kd, vd = bf(W, 1, H, D), bf(W, Tw, H, D), bf(W, Tw, H, D)
    lens = torch.from_numpy(rs.randint(1, Tw + 1, size=W).astype(np.int32))
    tfa.reset_launches()
    got = tfa.flash_decode(qd, kd, vd, lens.to(dev))
    torch.cuda.synchronize()
    dlaunch = tfa.launches["flash_decode"]
    ref = tfa.flash_decode(qd, kd, vd, lens.to(dev), impl="plain")
    dscale = float(ref.float().abs().max())
    derr = float((got.float() - ref.float()).abs().max())
    q32, k32, v32 = q.float(), k.float(), v.float()
    fp32_ms = call_ms(lambda: tfa.flash_attention(q32, k32, v32,
                                                  causal=True))
    bf16_ms = call_ms(lambda: tfa.flash_attention(q, k, v, causal=True))
    print("amp (g): bf16 attention through the fp32 kernels (upcast, "
          "launch, cast back; %s): flash_attention B%d T%d H%d D%d causal "
          "%s; launches %s; flash_decode B%d T%d bf16 err %.3g of %.3g, "
          "launches %d; tol one bf16 step (%g of the largest magnitude); "
          "forward per call bf16 %.3f ms vs fp32 %.3f ms"
          % (card, B, T, H, D, ", ".join("%s err %.3g of %.3g" % e
                                         for e in errs), launches, W, Tw,
             derr, dscale, dlaunch, BF16_STEP, bf16_ms, fp32_ms))
    if got.dtype != torch.bfloat16 or derr > BF16_STEP * dscale \
            or dlaunch != 1:
        fail("amp: bf16 flash_decode %s err %g launches %d"
             % (got.dtype, derr, dlaunch))


def phase_amp(card, tfa, fp32_module, fp32_resnet):
    """Phase 17: mixed precision and the fused step on ResNet-50 v1 at
    the reference's training size with phase 14's data and seed, and
    bfloat16 attention. No attention kernel is on the ResNet paths: the
    launch counts, zeroed just before (a)-(f), must read 0 after."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, image, classes = MODULE_BENCH
    rs = np.random.RandomState(70)
    x = rs.randn(MODULE_IMAGES, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, MODULE_IMAGES).astype(np.float32)
    tfa.reset_launches()
    amp_fused_vs_eager(mx, x, y, card)
    torch.cuda.empty_cache()
    mod, _ = amp_fit(mx, x, y, card, fp32_module)
    del mod
    torch.cuda.empty_cache()
    with deterministic_cudnn():
        amp_gluon_vs_module(mx, x[:batch], y[:batch])
    torch.cuda.empty_cache()
    amp_inference(mx, card, fp32_resnet["bench"]["hybridized"])
    torch.cuda.empty_cache()
    amp_guard(mx, x, y, card)
    torch.cuda.empty_cache()
    amp_checkpoints(mx, x, y, card)
    torch.cuda.empty_cache()
    if any(tfa.launches.values()):
        fail("amp: the ResNet paths launched attention kernels: %s"
             % tfa.launches)
    amp_attention(tfa, card)
    print("  amp phase %.1f s" % (time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# phase 18: the input path
# ---------------------------------------------------------------------------

INPUT_IMAGES = 256
INPUT_HW = (256, 320)
INPUT_QUALITY = 95
INPUT_LABELS = 16
INPUT_BATCH = 32
INPUT_SHAPE = (3, 224, 224)
INPUT_RESIZE = 256
INPUT_EPOCHS = 3
INPUT_MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53)
INPUT_STD = dict(std_r=58.395, std_g=57.12, std_b=57.375)
INPUT_THREADS = 4
INPUT_WORKERS = (1, 2, 4)
INPUT_NOT_RUN = "not run: no cv2 or PIL on this host"
LOADER_IMAGES = 160
LOADER_STEPS = 5
LOADER_WORKERS = 4
STREAM_BATCHES = 200
STREAM_DEPTH = 4
STREAM_BATCH = (16, 3, 32, 32)
STREAM_SLEEP_CYCLES = 2_000_000


def image_decoder():
    """The JPEG library ``recordio`` decodes with here (cv2, else PIL),
    or None."""
    try:
        import cv2
        return "cv2 %s" % cv2.__version__
    except ImportError:
        pass
    try:
        import PIL
        return "PIL %s" % PIL.__version__
    except ImportError:
        return None


def write_input_images(root):
    """INPUT_IMAGES 256x320 JPEGs (seed 0): smooth gradients and a slow
    wave per channel plus low-amplitude noise, so they encode near
    natural sizes; one subdirectory a label (INPUT_LABELS)."""
    from mxnet_tpu_torch import recordio
    rs = np.random.RandomState(0)
    h, w = INPUT_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(INPUT_IMAGES):
        a, f, ph = rs.uniform(-1, 1, (3, 2)), rs.uniform(0.5, 3, (3, 2)), \
            rs.uniform(0, 6.3, 3)
        img = np.stack([128 + 60 * (a[c, 0] * yy / h + a[c, 1] * xx / w)
                        + 40 * np.sin(2 * np.pi * (f[c, 0] * yy / h
                                                   + f[c, 1] * xx / w)
                                      + ph[c]) for c in range(3)], -1)
        img = np.clip(img + rs.normal(0, 4, img.shape), 0,
                      255).astype(np.uint8)
        d = os.path.join(root, "label%02d" % (i % INPUT_LABELS))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "img%03d.jpg" % i), "wb") as f_out:
            f_out.write(recordio._imencode(img, INPUT_QUALITY, ".jpg"))


def write_raw_rec(prefix, sizes):
    """Without a decoder: records of random bytes at JPEG-like sizes, so
    that (b) still reads a file of that shape."""
    from mxnet_tpu_torch import recordio
    rs = np.random.RandomState(0)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, n in enumerate(sizes):
        rec.write_idx(i, recordio.pack(recordio.IRHeader(
            0, float(i % INPUT_LABELS), i, 0), rs.bytes(n)))
    rec.close()


def record_read_rates(rec_path, reps=10):
    """(b): MB/s of a whole scan of the .rec, the Python reader against
    the native prefetching reader (best of ``reps``, page cache warm)."""
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.io import native
    size = os.path.getsize(rec_path)

    def scan(open_reader):
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            r = open_reader()
            n = 0
            while r.read() is not None:
                n += 1
            r.close()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return n, size / best / 1e6
    n_py, py = scan(lambda: recordio.MXRecordIO(rec_path, "r"))
    if not native.available():
        fail("input: the native reader did not build (%s)"
             % native.lib_path())
    n_nat, nat = scan(lambda: native.PrefetchingRecordReader(rec_path))
    if n_py != n_nat:
        fail("input: the readers saw %d and %d records" % (n_py, n_nat))
    return n_py, py, nat


def record_iter(mx, prefix, threads=INPUT_THREADS):
    """The reference training flow's reader at phase 18's settings."""
    return mx.io.ImageRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=INPUT_SHAPE, batch_size=INPUT_BATCH, resize=INPUT_RESIZE,
        rand_crop=True, rand_mirror=True, shuffle=True, seed=0,
        preprocess_threads=threads, **INPUT_MEAN, **INPUT_STD)


def decode_rate(mx, prefix, workers, threads=INPUT_THREADS, epochs=2):
    """(c): images/s of decode and augmentation alone, host batches
    through the pipeline's pool of ``workers`` (no placement)."""
    it = record_iter(mx, prefix, threads)
    pipe = mx.io.AsyncInputPipeline(it, num_workers=workers)
    try:
        t0 = time.perf_counter()
        n = 0
        for e in range(epochs):
            if e:
                pipe.reset()
            n += sum(b.data[0].shape[0] for b in pipe)
        dt = time.perf_counter() - t0
    finally:
        pipe.close()
        it.close()
    return n / dt


def thread_census():
    """The process's other live threads, by name with its trailing
    number dropped."""
    counts = {}
    for t in threading.enumerate():
        if t is not threading.main_thread():
            name = re.sub(r"[-_]?\d+(_\d+)?$", "", t.name)
            counts[name] = counts.get(name, 0) + 1
    return ", ".join("%s x%d" % kv for kv in sorted(counts.items())) \
        or "none"


def pipeline_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("mxio-") and t.is_alive()]


class FitWatch:
    """A batch-end callback: each batch's loss from the SoftmaxOutput
    probabilities (kept on the card until the end) and, through epoch
    ``keep - 1``, the batch as it reached the step, copied to the host."""

    def __init__(self, mod, keep=0):
        self.mod, self.keep = mod, keep
        self.losses, self.kept, self.devices = [], [], set()

    def __call__(self, param):
        batch = param.locals["data_batch"]
        probs = self.mod.get_outputs()[0]._data
        label = batch.label[0]._data
        self.losses.append(-torch.log(probs.float().gather(
            1, label.long()[:, None]) + 1e-12).mean())
        self.devices.add(str(batch.data[0]._data.device))
        if param.epoch < self.keep:
            self.kept.append((batch.data[0]._data.cpu(), label.cpu()))

    def epoch_losses(self, epochs):
        per = len(self.losses) // epochs
        return [float(torch.stack(self.losses[i * per:(i + 1) * per]).mean())
                for i in range(epochs)]


def timed_fit(mx, mod, it, watch, begin, end, steps_per_epoch):
    """``mod.fit`` over epochs [begin, end) under a telemetry run: wall s,
    the steady steps' (all but the first epoch of a fresh fit) median
    and mean ms, their data_wait share, and the h2d counters' deltas."""
    import tempfile
    from mxnet_tpu_torch import profiler, telemetry
    before = profiler.counters()
    with tempfile.TemporaryDirectory() as tmp:
        sink = os.path.join(tmp, "fit.jsonl")
        telemetry.reset()
        telemetry.start(filename=sink, run_id="input")
        t0 = time.perf_counter()
        try:
            mod.fit(it, begin_epoch=begin, num_epoch=end, optimizer="sgd",
                    optimizer_params=MODULE_SGD,
                    initializer=mx.init.Xavier(), eval_metric="acc",
                    batch_end_callback=watch)
            torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            telemetry.stop()
            recs = [json.loads(line) for line in open(sink)]
            telemetry.reset()
    after = profiler.counters()
    steps = [r for r in recs if r["type"] == "step"]
    steady = steps[steps_per_epoch:] if begin == 0 else steps
    durs = [r["dur_ms"] for r in steady]
    waits = [r.get("phases_ms", {}).get("data_wait", 0.0) for r in steady]
    return dict(
        wall=wall, steps=len(steps), ms=statistics.median(durs),
        mean_ms=sum(durs) / len(durs), wait_share=sum(waits) / sum(durs),
        h2d_calls=after.get("h2d_calls", 0) - before.get("h2d_calls", 0),
        h2d_bytes=after.get("h2d_bytes", 0) - before.get("h2d_bytes", 0))


def fit_idle(mx, mod, it, begin, steps_per_epoch):
    """Two more epochs of a fitted module (its graphs captured) under the
    profiler: the first whole, the second in a steady window (its steps
    3 to 7, the profiler's active steps by its schedule, timed between
    the batch-end callbacks, each after ``update_metric``'s sync).
    Returns ((wall ms, busy ms) of the epoch, (wall ms, busy ms) of the
    window)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def busy_ms(prof):
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.self_device_time_total > 0) / 1e3
    kw = dict(optimizer="sgd", optimizer_params=MODULE_SGD,
              eval_metric="acc")
    it.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mod.fit(it, begin_epoch=begin, num_epoch=begin + 1, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    epoch = (wall, busy_ms(prof))
    it.reset()
    stamps = []
    active = min(5, steps_per_epoch - 3)
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
            wait=1, warmup=1, active=active, repeat=1)) as prof:
        def tick(param):
            stamps.append(time.perf_counter())
            prof.step()
        mod.fit(it, begin_epoch=begin + 1, num_epoch=begin + 2,
                batch_end_callback=tick, **kw)
    window = ((stamps[1 + active] - stamps[1]) * 1e3, busy_ms(prof))
    return epoch, window


def check_input_fit(what, mod, watch, epochs, want_steps):
    """A fit through the pipeline: the steps ran, the loss is finite,
    the batches reached the step on the card, one capture of the fused
    step and no recapture, no pipeline thread left."""
    st = mod._fused.stats() if mod._fused else None
    losses = watch.epoch_losses(epochs)
    left = pipeline_threads()
    if len(watch.losses) != want_steps:
        fail("%s: fit ran %d steps, want %d" % (what, len(watch.losses),
                                                want_steps))
    if not all(np.isfinite(losses)):
        fail("%s: non-finite loss %s" % (what, losses))
    if watch.devices != {"cuda:0"}:
        fail("%s: batches reached the step on %s" % (what, watch.devices))
    if st is None or st["captures"] != 1 or st["recaptures"] != 0:
        fail("%s: fused graphs %s, want 1 capture, 0 recaptures"
             % (what, st))
    if left:
        fail("%s: pipeline threads alive after fit: %s" % (what, left))
    return losses, st


def check_first_epoch(what, kept, eager_batches):
    """The first epoch's batches as the pipeline placed them against the
    eager iterator's, bit for bit."""
    if len(kept) != len(eager_batches):
        fail("%s: %d placed batches, %d eager" % (what, len(kept),
                                                  len(eager_batches)))
    for i, ((pd, pl), (ed, el)) in enumerate(zip(kept, eager_batches)):
        if not (torch.equal(pd, ed) and torch.equal(pl, el)):
            fail("%s: placed batch %d differs from the eager one" % (what, i))


def check_h2d(what, res, steps, batch_bytes):
    """A fit's h2d copies: two a step (data and label), plus those of the
    batches the pipeline placed for the epoch after the last (fit resets
    its iterator after every epoch, as the reference's does; they are
    dropped at close), each batch's bytes whole."""
    extra = res["h2d_calls"] - 2 * steps
    if extra < 0 or extra % 2 or extra > 2 * 8 \
            or res["h2d_bytes"] != res["h2d_calls"] // 2 * batch_bytes:
        fail("%s: h2d %d copies, %d bytes for %d steps of %d bytes"
             % (what, res["h2d_calls"], res["h2d_bytes"], steps,
                batch_bytes))
    res["h2d_extra"] = extra


def input_record_fit(mx, prefix, card, module_readings):
    """(d): ResNet-50 v1 trained by ``Module.fit`` over ImageRecordIter
    through the pipeline, then two more epochs with the pipeline off and
    one under the profiler; the first epoch's placed batches against the
    eager iterator's."""
    steps_per_epoch = INPUT_IMAGES // INPUT_BATCH
    mx.random.seed(0)
    it = record_iter(mx, prefix)
    mod = mx.mod.Module(module_resnet(mx, MODULE_BENCH[2]))
    watch = FitWatch(mod, keep=1)
    on = timed_fit(mx, mod, it, watch, 0, INPUT_EPOCHS, steps_per_epoch)
    losses, st = check_input_fit("input (d)", mod, watch, INPUT_EPOCHS,
                                 INPUT_EPOCHS * steps_per_epoch)
    check_h2d("input (d)", on, INPUT_EPOCHS * steps_per_epoch,
              INPUT_BATCH * (4 * int(np.prod(INPUT_SHAPE)) + 4))
    eager_it = record_iter(mx, prefix)
    eager = []
    for _ in range(steps_per_epoch):
        b = eager_it.next()
        eager.append((b.data[0]._data.cpu(), b.label[0]._data.cpu()))
    eager_it.close()
    check_first_epoch("input (d)", watch.kept, eager)
    watch.kept = []
    it.reset()
    off_watch = FitWatch(mod)
    with env_set("MXNET_DATA_PIPELINE", "0"):
        off = timed_fit(mx, mod, it, off_watch, INPUT_EPOCHS,
                        INPUT_EPOCHS + 2, steps_per_epoch)
    (e_wall, e_busy), (w_wall, w_busy) = fit_idle(
        mx, mod, it, INPUT_EPOCHS + 2, steps_per_epoch)
    idle = 1 - w_busy / w_wall
    st_after = mod._fused.stats()
    if st_after["captures"] != 1 or st_after["recaptures"] != 0:
        fail("input (d): fused graphs after the later fits %s" % st_after)
    it.close()
    print("input (d): Module.fit, ResNet-50 v1 (classes %d), %d images from"
          " the .rec through ImageRecordIter (3x%dx%d, resize %d, random crop"
          " and mirror, ImageNet mean/std, preprocess_threads %d) and the "
          "pipeline (MXNET_DATA_WORKERS %d, depth 2, placed on cuda:0), "
          "batch %d, SGD lr %g, %d epochs = %d fused steps in %.2f s (%s): "
          "%.3f ms a step (median of epochs 2-%d; mean %.3f), %.1f images/s; "
          "data_wait %.4f of a step; idle share %.3f in a steady window of"
          " one more epoch (steps 3-7: wall %.1f ms, busy %.1f), %.3f over "
          "a whole epoch (wall %.1f, busy %.1f: the epoch's start and end "
          "included); h2d %d copies (%d of them "
          "for the epoch after the last), %d bytes; "
          "fused graphs %s; loss by epoch %s; first epoch's %d placed batches"
          " bit-identical to the eager iterator's; no pipeline thread left"
          % (MODULE_BENCH[2], INPUT_IMAGES, INPUT_SHAPE[1], INPUT_SHAPE[2],
             INPUT_RESIZE, INPUT_THREADS, mx.io.data_workers(), INPUT_BATCH,
             MODULE_SGD["learning_rate"], INPUT_EPOCHS, on["steps"],
             on["wall"], card, on["ms"], INPUT_EPOCHS, on["mean_ms"],
             INPUT_BATCH * 1e3 / on["ms"], on["wait_share"], idle, w_wall,
             w_busy, 1 - e_busy / e_wall, e_wall, e_busy, on["h2d_calls"], on["h2d_extra"], on["h2d_bytes"], st,
             " ".join("%.4f" % v for v in losses), steps_per_epoch))
    print("  the same module, 2 more epochs with MXNET_DATA_PIPELINE=0: "
          "%.3f ms a step (mean %.3f), %.1f images/s, data_wait %.4f of a "
          "step; phase 14 (NDArrayIter from memory, fused step, this run): "
          "%.3f ms a step"
          % (off["ms"], off["mean_ms"], INPUT_BATCH * 1e3 / off["ms"],
             off["wait_share"], module_readings["fused_ms"]))
    del mod
    torch.cuda.empty_cache()
    return on, off, idle


def input_ndarray_fit(mx, card):
    """(d'): the same fit over NDArrayIter's split protocol through the
    pipeline (phase 14's images), on a fresh module: its capture runs
    while the placer copies."""
    batch, image, classes = MODULE_BENCH
    rs = np.random.RandomState(70)
    x = rs.randn(MODULE_IMAGES, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, MODULE_IMAGES).astype(np.float32)
    per = MODULE_IMAGES // batch
    mx.random.seed(0)
    np.random.seed(18)
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=True)
    np.random.seed(18)
    eager_it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=True)
    eager = [(b.data[0]._data.cpu(), b.label[0]._data.cpu())
             for b in eager_it]
    mod = mx.mod.Module(module_resnet(mx, classes))
    watch = FitWatch(mod, keep=1)
    res = timed_fit(mx, mod, it, watch, 0, INPUT_EPOCHS, per)
    losses, st = check_input_fit("input (d')", mod, watch, INPUT_EPOCHS,
                                 INPUT_EPOCHS * per)
    check_first_epoch("input (d')", watch.kept, eager)
    check_h2d("input (d')", res, INPUT_EPOCHS * per,
              batch * (4 * image * image * 3 + 4))
    print("input (d'): Module.fit over NDArrayIter's split protocol through"
          " the pipeline (phase 14's %d images, shuffled), %d epochs = %d "
          "fused steps in %.2f s (%s): %.3f ms a step (median of epochs "
          "2-%d), data_wait %.4f; h2d %d copies (%d for the epoch after "
          "the last), %d bytes; fused graphs %s;"
          " loss by epoch %s; first epoch bit-identical to the eager "
          "iterator's; no pipeline thread left"
          % (MODULE_IMAGES, INPUT_EPOCHS, res["steps"], res["wall"], card,
             res["ms"], INPUT_EPOCHS, res["wait_share"], res["h2d_calls"],
             res["h2d_extra"], res["h2d_bytes"], st, " ".join("%.4f" % v for v in losses)))
    del mod
    torch.cuda.empty_cache()
    return res


def input_loader_trainer(mx, card):
    """(e): ``gluon.data.DataLoader(ArrayDataset, num_workers=4,
    device_prefetch=True)`` feeding a hybridized Gluon ResNet-50 Trainer
    for LOADER_STEPS steps: batches arrive on cuda:0, h2d accounted."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rs = np.random.RandomState(71)
    x = rs.randn(LOADER_IMAGES, *INPUT_SHAPE).astype(np.float32)
    y = rs.randint(0, MODULE_BENCH[2], LOADER_IMAGES).astype(np.float32)
    mx.random.seed(0)
    net = vision.resnet50_v1(classes=MODULE_BENCH[2])
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", MODULE_SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loader = DataLoader(ArrayDataset(x, y), batch_size=INPUT_BATCH,
                        num_workers=LOADER_WORKERS, device_prefetch=True)
    before = profiler.counters()
    losses, devices, times = [], set(), []
    t0 = time.perf_counter()
    for data, label in loader:
        devices.update({str(data._data.device), str(label._data.device)})
        with mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(INPUT_BATCH)
        losses.append(loss.mean()._data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    after = profiler.counters()
    calls = after.get("h2d_calls", 0) - before.get("h2d_calls", 0)
    nbytes = after.get("h2d_bytes", 0) - before.get("h2d_bytes", 0)
    want_bytes = LOADER_IMAGES * (4 * int(np.prod(INPUT_SHAPE)) + 4)
    loss_vals = [float(v) for v in losses]
    left = pipeline_threads()
    if len(losses) != LOADER_STEPS or devices != {"cuda:0"}:
        fail("input (e): %d steps, batches on %s" % (len(losses), devices))
    if (calls, nbytes) != (2 * LOADER_STEPS, want_bytes):
        fail("input (e): h2d %d calls, %d bytes; want %d, %d"
             % (calls, nbytes, 2 * LOADER_STEPS, want_bytes))
    if not all(np.isfinite(loss_vals)) or left:
        fail("input (e): loss %s, threads left %s" % (loss_vals, left))
    print("input (e): DataLoader(ArrayDataset of %d images, batch %d, "
          "num_workers %d, device_prefetch=True) -> hybridized Gluon "
          "ResNet-50 v1, record -> SoftmaxCrossEntropyLoss -> "
          "Trainer('sgd'), %d steps (%s): batches on %s; h2d %d copies, %d "
          "bytes; %.1f ms a step after the first (%.1f first); loss %s; no "
          "pipeline thread left"
          % (LOADER_IMAGES, INPUT_BATCH, LOADER_WORKERS, len(losses), card,
             sorted(devices), calls, nbytes,
             statistics.median(times[1:]) * 1e3, times[0] * 1e3,
             " ".join("%.4f" % v for v in loss_vals)))
    del net, trainer
    torch.cuda.empty_cache()


def input_stream_check(mx, card, device=None):
    """(f): STREAM_BATCHES batches placed at depth STREAM_DEPTH while the
    consumer's stream runs a long kernel before each comparison: each
    placed batch is compared bitwise on that stream with its host
    source (copied to the card beforehand), and dropped before the
    comparison has run. A block the allocator handed to the placer's
    next copy before the comparison ran would differ."""
    device = device or torch.device("cuda", 0)
    n, rest = STREAM_BATCHES * STREAM_BATCH[0], STREAM_BATCH[1:]
    x = np.random.RandomState(72).rand(n, *rest).astype(np.float32)
    want = torch.from_numpy(x).to(device).view(torch.int32)
    it = mx.io.NDArrayIter(x, np.arange(n, dtype=np.float32),
                           batch_size=STREAM_BATCH[0])
    pipe = mx.io.AsyncInputPipeline(it, num_workers=2,
                                    prefetch_depth=STREAM_DEPTH,
                                    placement=device)
    oks = []
    t0 = time.perf_counter()
    try:
        for i in range(STREAM_BATCHES):
            got = pipe.next().data[0]._data
            torch.cuda._sleep(STREAM_SLEEP_CYCLES)
            rows = want[i * STREAM_BATCH[0]:(i + 1) * STREAM_BATCH[0]]
            oks.append((got.view(torch.int32) == rows).all())
            del got
        enqueued = time.perf_counter() - t0
        torch.cuda.synchronize()
        drained = time.perf_counter() - t0
    finally:
        pipe.close()
    bad = STREAM_BATCHES - int(torch.stack(oks).sum())
    if bad:
        fail("input (f): %d of %d placed batches differ from their host "
             "source" % (bad, STREAM_BATCHES))
    print("input (f): %d batches of %s placed at depth %d while the "
          "consumer's stream ran a %d-cycle kernel before each comparison "
          "(%s): all bit-identical to their host source; the host enqueued"
          " in %.3f s, the stream drained at %.3f s"
          % (STREAM_BATCHES, "x".join(map(str, STREAM_BATCH)), STREAM_DEPTH,
             STREAM_SLEEP_CYCLES, card, enqueued, drained))


def phase_input(card, module_readings):
    """Phase 18: the input path, the fourteenth slice's main path.
    Attention and decode launch counts, zeroed before, must read 0."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.tools import im2rec
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    decoder = image_decoder()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "input")
        t0 = time.perf_counter()
        if decoder:
            root = os.path.join(tmp, "images")
            write_input_images(root)
            lst, _ = im2rec.make_list(root, prefix)
            im2rec.im2rec(lst, root, prefix, quality=INPUT_QUALITY)
        else:
            write_raw_rec(prefix, np.random.RandomState(1).randint(
                30000, 60000, INPUT_IMAGES))
        write_s = time.perf_counter() - t0
        rec_bytes = os.path.getsize(prefix + ".rec")
        print("input (a): decoder: %s; os.cpu_count() %d; .rec %d bytes "
              "(%d records, %.1f KB a record, %s) written in %.2f s"
              % (decoder or "none (neither cv2 nor PIL)", os.cpu_count(),
                 rec_bytes, INPUT_IMAGES, rec_bytes / INPUT_IMAGES / 1e3,
                 "%dx%d JPEGs at quality %d by tools.im2rec"
                 % (INPUT_HW + (INPUT_QUALITY,)) if decoder
                 else "random bytes: no encoder", write_s))
        n, py, nat = record_read_rates(prefix + ".rec")
        print("input (b): record read, %d records (%s): Python MXRecordIO "
              "%.1f MB/s, native PrefetchingRecordReader %.1f MB/s"
              % (n, card, py, nat))
        if decoder:
            print("input (c): host before decoding: load average %s, %d "
                  "cores usable, other threads of this process: %s"
                  % ("/".join("%.2f" % v for v in os.getloadavg()),
                     len(os.sched_getaffinity(0)), thread_census()))
            rates = {w: decode_rate(mx, prefix, w) for w in INPUT_WORKERS}
            wide = decode_rate(mx, prefix, 4, threads=os.cpu_count())
            print("input (c): ImageRecordIter decode + augment alone, "
                  "preprocess_threads %d, host batches (%s): %s images/s; "
                  "preprocess_threads %d at 4 workers %.1f images/s"
                  % (INPUT_THREADS, card, ", ".join(
                      "MXNET_DATA_WORKERS %d %.1f" % (w, r)
                      for w, r in rates.items()), os.cpu_count(), wide))
            input_record_fit(mx, prefix, card, module_readings)
        else:
            print("input (c): %s" % INPUT_NOT_RUN)
            print("input (d): %s" % INPUT_NOT_RUN)
    input_ndarray_fit(mx, card)
    input_loader_trainer(mx, card)
    input_stream_check(mx, card)
    if any(tfa.launches.values()):
        fail("input: the input path launched attention kernels: %s"
             % tfa.launches)
    print("  attention kernel launches on the input path: %s (none is on "
          "it); input phase %.1f s"
          % (dict(tfa.launches), time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# phase 19: variable-length training (BucketingModule, the RNN path)
# ---------------------------------------------------------------------------

# BASELINE config 3, the reference's example/rnn/bucketing/lstm_bucketing.py
# at its argparse defaults: 2 x LSTMCell(200), Embedding(200), FC(vocab),
# SoftmaxOutput; buckets 10-60, batch 32, SGD lr 0.01, momentum 0, wd 1e-5,
# Xavier(in, 2.34); PTB's vocabulary of 10000 (ids 1..9999, 0 = invalid)
LM_VOCAB = 10000
LM_EMBED = 200
LM_HIDDEN = 200
LM_LAYERS = 2
LM_BUCKETS = [10, 20, 30, 40, 50, 60]
LM_BATCH = 32
LM_SGD = dict(learning_rate=0.01, momentum=0.0, wd=1e-5)
LM_EPOCHS = 2
# (b): the eager fit, cut to one epoch (its steps are ~10x the fused
# ones); from the same weights and batches its epoch-1 perplexity is the
# fused fit's within LM_PPL_REL (bit for bit when the embedding's
# backward accumulates in a fixed order)
LM_EAGER_EPOCHS = 1
LM_PPL_REL = 1e-4
# the synthetic corpus of PTB's shape (no PTB in the repository): Zipf
# unigrams, a sparse first-order Markov chain (each token's successors
# drawn from the unigram, taken with LM_CHAIN probability, else a fresh
# unigram draw), gamma-distributed sentence lengths (mean ~21 tokens, a
# tail past 60 that the iterator discards and counts)
LM_SENTENCES = 4096
LM_SUCCESSORS = 4
LM_SUCCESSOR_P = (0.55, 0.25, 0.12, 0.08)
LM_CHAIN = 0.6
LM_LENGTH_GAMMA = (3.0, 7.0)
LM_SEED = 0
# (c): the fused RNN op against the unrolled cells from the same weights,
# the softmax's probabilities at the first batch (fp32, TF32 off)
LM_FUSED_TOL = dict(rtol=1e-4, atol=1e-7)
# (b): a fused step against an eager one from the same weights and batch:
# every array bit-identical but the embedding, whose CUDA backward
# accumulates with atomics: its step within LM_EMBED_STEP_REL of the
# largest step
LM_EMBED_STEP_REL = 1e-5
# (d): the Gluon LM's per-sample loss is the mean over its positions, so
# the Module's rate (a gradient summed over a sentence) times the mean
# sentence length
LM_GLUON_LR = 0.2
LM_GLUON_STEPS = 64                 # (cut from 96: phase 33's time)
# (e): packed attention at the training shape's heads
PACK_LADDER = [256]
PACK_BATCH = 8
PACK_HEADS = 12
PACK_DIM = 64
PACK_SAMPLES = 72
PACK_LENGTHS = (16, 240)
PACK_BATCHES = 3
PACK_SHAPE = "B%d T%d H%d D%d causal seg" % (PACK_BATCH, PACK_LADDER[-1],
                                             PACK_HEADS, PACK_DIM)
LM_CLASSES = (("matmul", ("gemm", "cutlass", "sm90_", "ampere_", "gemv")),
              ("softmax", ("softmax",)),
              ("embedding", ("embedding", "index")))


def lm_corpus(seed=LM_SEED):
    """PTB-shaped synthetic sentences of token ids 1..LM_VOCAB-1."""
    n, vocab = LM_SENTENCES, LM_VOCAB
    rs = np.random.RandomState(seed)
    ids = np.arange(1, vocab)
    unigram = 1.0 / ids
    unigram /= unigram.sum()
    succ = rs.choice(ids, size=(vocab, LM_SUCCESSORS), p=unigram)
    lengths = np.maximum(2, np.rint(rs.gamma(*LM_LENGTH_GAMMA, size=n))
                         ).astype(int)
    toks = np.empty((n, int(lengths.max())), np.int64)
    toks[:, 0] = rs.choice(ids, size=n, p=unigram)
    for t in range(1, toks.shape[1]):
        pick = rs.choice(LM_SUCCESSORS, size=n, p=LM_SUCCESSOR_P)
        chain = succ[toks[:, t - 1], pick]
        fresh = rs.choice(ids, size=n, p=unigram)
        toks[:, t] = np.where(rs.rand(n) < LM_CHAIN, chain, fresh)
    return [list(toks[i, :lengths[i]]) for i in range(n)]


def lm_sym_gen(mx, fused=False):
    """The reference's sym_gen (lstm_bucketing.py; ``fused``:
    cudnn_lstm_bucketing.py's FusedRNNCell at the same widths), with
    ``use_ignore`` for the padded tails."""
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=LM_VOCAB,
                                 output_dim=LM_EMBED, name="embed")
        if fused:
            cell = mx.rnn.FusedRNNCell(LM_HIDDEN, num_layers=LM_LAYERS,
                                       mode="lstm", prefix="lstm_")
        else:
            cell = mx.rnn.SequentialRNNCell()
            for i in range(LM_LAYERS):
                cell.add(mx.rnn.LSTMCell(num_hidden=LM_HIDDEN,
                                         prefix="lstm_l%d_" % i))
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, LM_HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=LM_VOCAB,
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax",
                                    use_ignore=True, ignore_label=0)
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lm_iter(mx, sents):
    """The training iterator, its shuffles from LM_SEED."""
    np.random.seed(LM_SEED)
    return mx.rnn.BucketSentenceIter(sents, LM_BATCH, buckets=LM_BUCKETS,
                                     invalid_label=0)


def lm_module(mx, sym_gen, it, arg_params=None):
    """A bound BucketingModule with the reference's Xavier (or the given
    arg_params)."""
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(LM_SEED)
    if arg_params is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    else:
        mod.init_params(initializer=None, arg_params={
            k: mx.nd.array(v) for k, v in arg_params.items()},
            aux_params={})
    return mod


def fused_lstm_params(args):
    """The unrolled cells' weights as the RNN op's flat vector (weights,
    then biases, layer by layer), LSTMCell's in-graph forget bias of 1.0
    folded into each layer's i2h bias: the same model."""
    H = LM_HIDDEN
    ws, bs = [], []
    for i in range(LM_LAYERS):
        p = "lstm_l%d_" % i
        ws += [args[p + "i2h_weight"].ravel(), args[p + "h2h_weight"].ravel()]
        b = args[p + "i2h_bias"].copy()
        b[H:2 * H] += 1.0
        bs += [b, args[p + "h2h_bias"]]
    out = {k: v for k, v in args.items() if not k.startswith("lstm_l")}
    out["lstm_parameters"] = np.concatenate(ws + bs).astype(np.float32)
    return out


class CaptureClock:
    """Wall ms of each fused-step capture (the eager warm-up on the side
    stream and the capture), in order: the graph holders that
    ``fused_step.set_graph_factory(clock.factory)`` makes time their
    captures."""

    def __init__(self):
        self.ms = []

    def factory(self):
        from mxnet_tpu_torch.cached_op import _Graphs
        graphs = _Graphs()
        base = graphs._capture

        def timed_capture(body, device, pool, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = base(body, device, pool, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        graphs._capture = timed_capture
        return graphs


class LMWatch:
    """fit's batch-end and epoch-end callbacks: each batch's bucket and
    wall stamp, the capture (if any) its step made, and at each epoch's
    end the perplexity, the per-bucket graph counters and the iterator's
    bucketing snapshot."""

    def __init__(self, mod, it, ppl, clock):
        self.mod, self.it, self.ppl, self.clock = mod, it, ppl, clock
        self.buckets, self.captures, self.epochs = [], {}, []
        self.t0 = time.perf_counter()

    def __call__(self, param):
        key = param.locals["data_batch"].bucket_key
        self.buckets.append(key)
        if len(self.clock.ms) > sum(len(v) for v in self.captures.values()):
            self.captures.setdefault(key, []).append(self.clock.ms[-1])

    def epoch_end(self, epoch, sym, arg, aux):
        torch.cuda.synchronize()
        self.epochs.append(dict(
            t=time.perf_counter(), steps=len(self.buckets),
            ppl=self.ppl.get()[1],
            stats={k: dict(v["fused"]) for k, v in self.mod.stats().items()},
            snap=self.it.bucketing.snapshot()))


def lm_fit(mx, mod, it, epochs, clock):
    """``mod.fit`` over ``it`` for ``epochs`` (the reference's optimizer,
    Perplexity(invalid_label)); returns the watch."""
    from mxnet_tpu_torch import fused_step
    ppl = mx.metric.Perplexity(ignore_label=0)
    watch = LMWatch(mod, it, ppl, clock)
    fused_step.set_graph_factory(clock.factory)
    try:
        mod.fit(it, num_epoch=epochs, eval_metric=ppl, optimizer="sgd",
                optimizer_params=LM_SGD, batch_end_callback=watch,
                epoch_end_callback=watch.epoch_end)
    finally:
        fused_step.set_graph_factory(None)
    return watch


def lm_batches(it):
    """One batch of each bucket, in bucket order."""
    it.reset()
    out = {}
    for b in it:
        out.setdefault(b.bucket_key, b)
    return [out[k] for k in sorted(out)]


def lm_step(mod, batch):
    """One training step as fit takes it, without the metric."""
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def lm_report(what, watch, card, fused=True):
    """The fit's readings: perplexity by epoch, the last epoch's rates
    (from the end of the one before, or from the fit's start for a
    one-epoch fit) and padding, the per-bucket graph counters. On the
    fused step checks one capture per bucket seen and, over two epochs,
    none new in the second and the perplexity falling."""
    e1, last = watch.epochs[0], watch.epochs[-1]
    if len(watch.epochs) > 1:
        t0, snap0, steps0 = e1["t"], e1["snap"], e1["steps"]
    else:
        t0, snap0, steps0 = watch.t0, dict.fromkeys(
            ("total_elements", "padded_elements"), 0), 0
    secs = last["t"] - t0
    real = (last["snap"]["total_elements"] - last["snap"]["padded_elements"]) \
        - (snap0["total_elements"] - snap0["padded_elements"])
    total = last["snap"]["total_elements"] - snap0["total_elements"]
    steps = last["steps"] - steps0
    print("  %s: perplexity by epoch %s; epoch %d: %d steps in %.2f s, %.1f "
          "ms a step with the metric, %.0f real tokens/s, %.0f padded "
          "tokens/s (%s); padding share %s over the run, pad rows %d, "
          "discarded %d"
          % (what, " ".join("%.2f" % e["ppl"] for e in watch.epochs),
             len(watch.epochs), steps, secs, secs * 1e3 / max(steps, 1),
             real / secs, total / secs, card, last["snap"]["padding_share"],
             last["snap"]["pad_rows"], last["snap"]["discarded"]))
    caps = {k: st["captures"] for k, st in e1["stats"].items()}
    print("  %s: fused-step captures per bucket after epoch 1 %s, after "
          "epoch %d %s; recaptures %s; capture ms (warm-up + capture) %s"
          % (what, caps, len(watch.epochs),
             {k: st["captures"] for k, st in last["stats"].items()},
             {k: st["recaptures"] for k, st in last["stats"].items()},
             {k: ["%.1f" % v for v in ms]
              for k, ms in sorted(watch.captures.items())}))
    seen = sorted(set(watch.buckets))
    if list(caps) != ["bucketing:%d" % k for k in seen]:
        fail("%s: buckets %s bound, %s seen" % (what, list(caps), seen))
    want = 1 if fused else 0
    if any(v != want for v in caps.values()):
        fail("%s: captures per bucket after epoch 1: %s" % (what, caps))
    for key, st in last["stats"].items():
        if st["captures"] != want or st["recaptures"]:
            fail("%s: a later epoch recaptured %s: %s" % (what, key, st))
    ppl = [e["ppl"] for e in watch.epochs]
    if not all(np.isfinite(ppl)) or \
            (len(ppl) > 1 and not ppl[-1] < ppl[0]):
        fail("%s: the perplexity did not fall: %s" % (what, ppl))
    return dict(ppl=ppl, secs=secs, real_tps=real / secs,
                padded_tps=total / secs,
                padding=last["snap"]["padding_share"],
                capture_ms={k: v[0] for k, v in watch.captures.items()})


def lm_step_times(mod, batches, card, what, iters=10):
    """ms a step (forward + backward + update, no metric) for one batch of
    each bucket: the median CUDA-event time of ``iters`` steps after 2."""
    ms = {b.bucket_key: call_ms(lambda b=b: lm_step(mod, b), iters=iters,
                                warm=2) for b in batches}
    print("  %s: ms a step by bucket %s (%s)"
          % (what, " ".join("%d:%.3f" % kv for kv in sorted(ms.items())),
             card))
    return ms


def lm_profile(mod, batch, card, what):
    """Idle share and kernels of the bucket's replayed step (profiler);
    the kernels of one step are the nodes its graph holds."""
    wall, busy, by_class, kernels, bare = profile_steps(
        lambda: lm_step(mod, batch), 5, classes=LM_CLASSES)
    nodes = sum(n for _, _, n in kernels) / 5
    print("  %s: bucket %d step under the profiler %.3f ms wall (%.3f "
          "without), busy %.3f ms, idle share %.3f; %s; %.0f kernels a "
          "step (the graph's kernel nodes) (%s)"
          % (what, batch.bucket_key, wall, bare, busy, 1 - busy / wall,
             ", ".join("%s %.3f" % kv for kv in sorted(by_class.items())),
             nodes, card))
    return dict(wall=wall, busy=busy, idle=1 - busy / wall, nodes=nodes)


def lm_fused_vs_eager(mx, sym_gen, init, batch, card):
    """(b): one fused step and one eager step (``MXNET_FUSED_STEP=0``)
    from the same weights on the same batch: the probabilities and every
    array bit-identical but the embedding, held to LM_EMBED_STEP_REL of
    its largest step (its CUDA backward accumulates with atomics)."""
    res = {}
    for fused in (True, False):
        mod = mx.mod.BucketingModule(sym_gen,
                                     default_bucket_key=batch.bucket_key)
        mod.bind(data_shapes=batch.provide_data,
                 label_shapes=batch.provide_label)
        mod.init_params(initializer=None, arg_params={
            k: mx.nd.array(v) for k, v in init.items()}, aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
        with fused_gate(fused):
            lm_step(mod, batch)
            probs = mod.get_outputs()[0].asnumpy()
        res[fused] = (probs, {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()})
        del mod
    same = {k: bool((res[True][1][k] == res[False][1][k]).all())
            for k in init}
    step = np.abs(res[False][1]["embed_weight"] - init["embed_weight"]).max()
    emb = np.abs(res[True][1]["embed_weight"]
                 - res[False][1]["embed_weight"]).max()
    probs_same = bool((res[True][0] == res[False][0]).all())
    print("  (b) one bucket-%d step, fused against MXNET_FUSED_STEP=0 from "
          "the same weights: probabilities bit-identical %s; every array "
          "but embed_weight bit-identical %s; embed_weight %s (held %s)"
          % (batch.bucket_key, probs_same,
             all(v for k, v in same.items() if k != "embed_weight"),
             "bit-identical" if same["embed_weight"] else
             "differs by %.3g, %.3g of its largest step %.3g"
             % (emb, emb / max(step, 1e-30), step),
             "bit for bit" if same["embed_weight"] else
             "to %g of its largest step: its CUDA backward may accumulate "
             "with atomics" % LM_EMBED_STEP_REL))
    if not probs_same or not all(v for k, v in same.items()
                                 if k != "embed_weight"):
        fail("(b): the fused step differs from the eager step: %s" % same)
    if emb > LM_EMBED_STEP_REL * step:
        fail("(b): the embedding's fused step differs by %.3g" % emb)


def rnn_op_timing(mx, init, card):
    """(c): the RNN op's forward + backward at T60 N32 H200, 2 layers, by
    CUDA-graph replay, beside cuDNN's LSTM (``torch._VF.lstm``) on the
    same weights, a yardstick only; the outputs of both held together."""
    from mxnet_tpu_torch.ops.registry import get_op
    dev = mx.current_context().torch_device()
    T, N, H, L = LM_BUCKETS[-1], LM_BATCH, LM_HIDDEN, LM_LAYERS
    g = torch.Generator(device="cpu").manual_seed(19)
    x = torch.randn(T, N, LM_EMBED, generator=g).to(dev)
    dy = torch.randn(T, N, H, generator=g).to(dev)
    flat = torch.from_numpy(init["lstm_parameters"]).to(dev)
    h0 = torch.zeros(L, N, H, device=dev)
    c0 = torch.zeros(L, N, H, device=dev)
    op = get_op("RNN")
    attrs = dict(op.defaults, state_size=H, num_layers=L, mode="lstm",
                 state_outputs=True, __train__=True)

    def port():
        # fresh leaves each call, as the fused step makes them: a capture
        # must not reach the autograd nodes of leaves made outside it
        xl, fl = (t.detach().requires_grad_(True) for t in (x, flat))
        out = op.forward(attrs, xl, fl, h0, c0)[0]
        return out, torch.autograd.grad(out, (xl, fl), dy)
    lstm = torch.nn.LSTM(LM_EMBED, H, L).to(dev)
    G4 = 4 * H
    with torch.no_grad():
        off = 0
        for layer in range(L):
            for name, n in (("weight_ih_l%d", G4 * (LM_EMBED if layer == 0
                                                    else H)),
                            ("weight_hh_l%d", G4 * H)):
                w = getattr(lstm, name % layer)
                w.copy_(flat[off:off + n].view_as(w))
                off += n
        for layer in range(L):
            for name in ("bias_ih_l%d", "bias_hh_l%d"):
                b = getattr(lstm, name % layer)
                b.copy_(flat[off:off + G4])
                off += G4
    lstm.flatten_parameters()
    weights = [w.detach() for w in lstm._flat_weights]

    def cudnn():
        xl = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in weights]
        out = torch._VF.lstm(xl, (h0, c0), ws, True, L, 0.0, True, False,
                             False)[0]
        return out, torch.autograd.grad(out, [xl] + ws, dy)
    (po, pg), (co, cg) = port(), cudnn()
    err = float((po - co).detach().abs().max())
    gerr = float((pg[0] - cg[0]).abs().max())
    port_ms, eager_ms = device_ms(port, iters=5), stream_ms(port)
    try:
        cudnn_ms, how = device_ms(cudnn, iters=5), "graph replay"
    except RuntimeError as exc:     # cuDNN's RNN would not capture
        cudnn_ms, how = stream_ms(cudnn), "back-to-back calls (%s)" \
            % str(exc).splitlines()[0][:80]
    fwd = 2.0 * N * T * G4 * (LM_EMBED + H + (L - 1) * 2 * H)
    flops = 3 * fwd                       # backward: twice the forward
    bound = flops / PEAK_FP32_FLOPS * 1e3
    print("  (c) RNN op forward + backward, T%d N%d H%d, %d layers, fp32: "
          "%.3f ms by graph replay (%.3f ms eager, calls back to back); "
          "cuDNN's LSTM (torch._VF.lstm, same weights, a yardstick only) "
          "%.3f ms by %s; outputs differ by %.3g, input gradients by %.3g; "
          "bound %.4f ms (%.2f GFLOP at the fp32 peak; the recurrence is %d "
          "dependent steps) (%s)"
          % (T, N, H, L, port_ms, eager_ms, cudnn_ms, how, err, gerr, bound,
             flops / 1e9, T * L, card))
    if err > 1e-4 or gerr > 1e-4:
        fail("(c): the RNN op disagrees with cuDNN's LSTM: %.3g %.3g"
             % (err, gerr))
    return dict(ms=port_ms, eager_ms=eager_ms, cudnn_ms=cudnn_ms,
                bound_ms=bound)


def lstm_gluon_lm(mx):
    """(d): Embedding -> gluon.rnn.LSTM(200, num_layers=2) -> Dense(vocab),
    the LM of the reference's gluon word_language_model at this width."""
    class LM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = mx.gluon.nn.Embedding(LM_VOCAB, LM_EMBED)
                self.lstm = mx.gluon.rnn.LSTM(LM_HIDDEN,
                                              num_layers=LM_LAYERS,
                                              layout="NTC",
                                              input_size=LM_EMBED)
                self.out = mx.gluon.nn.Dense(LM_VOCAB, flatten=False,
                                             in_units=LM_HIDDEN)

        def hybrid_forward(self, F, x, h, c):
            y, _ = self.lstm(self.embed(x), [h, c])
            return self.out(y)
    return LM()


def gluon_lm_train(mx, sents, card):
    """(d): the hybridized Gluon LM trained through ``Trainer`` on
    ``BucketedPipeline`` batches with ``MaskedSoftmaxCELoss`` and
    ``masked_batch_loss``; then one predict call a bucket on the
    CachedOp's graphs (one capture a bucket) and a second round (replays
    only)."""
    from mxnet_tpu_torch import bucketing
    samples = [(np.asarray(s[:-1], np.float32), np.asarray(s[1:], np.float32))
               for s in sents]
    pipe = bucketing.BucketedPipeline(samples, LM_BATCH, ladder=LM_BUCKETS,
                                      invalid_label=0, name="lm")
    net = lstm_gluon_lm(mx)
    mx.random.seed(LM_SEED)
    net.initialize(mx.init.Xavier(factor_type="in", magnitude=2.34))
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(LM_SGD, learning_rate=LM_GLUON_LR))
    loss_fn = bucketing.MaskedSoftmaxCELoss()
    zeros = mx.nd.zeros((LM_LAYERS, LM_BATCH, LM_HIDDEN))
    losses, times, keys, first = [], [], [], {}
    for batch in pipe:
        if len(losses) == LM_GLUON_STEPS:
            break
        first.setdefault(batch.bucket_key, batch)
        mask = mx.nd.array(pipe.mask_for(batch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            logits = net(batch.data[0], zeros, zeros)
            loss = bucketing.masked_batch_loss(
                loss_fn(logits, batch.label[0], mask), batch.valid_rows)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        times.append((time.perf_counter() - t0) * 1e3)
        keys.append(batch.bucket_key)
    head, tail = np.mean(losses[:16]), np.mean(losses[-16:])
    upd = trainer._fused_updater.stats() if trainer._fused_updater else {}
    for _ in range(2):
        for batch in first.values():
            net(batch.data[0], zeros, zeros).asnumpy()
    graphs = net._cached_op.stats()
    by_bucket = {}
    for k, t in zip(keys[8:], times[8:]):
        by_bucket.setdefault(k, []).append(t)
    print("  (d) Gluon LM (hybridized Embedding -> gluon.rnn.LSTM(%d, %d "
          "layers) -> Dense(%d)), Trainer SGD lr %g on BucketedPipeline "
          "batches, MaskedSoftmaxCELoss + masked_batch_loss: %d steps, loss "
          "%.4f over the first 16 steps -> %.4f over the last 16; ms a step "
          "(median, after 8) %s (%s); fused update graphs %s; predict graphs "
          "over %d buckets twice: %s; pipeline padding share %s"
          % (LM_HIDDEN, LM_LAYERS, LM_VOCAB, LM_GLUON_LR, len(losses), head,
             tail, " ".join("%d:%.2f" % (k, statistics.median(v))
                            for k, v in sorted(by_bucket.items())), card,
             upd, len(first), graphs,
             pipe.stats.snapshot()["padding_share"]))
    if not np.isfinite(tail) or not tail < head:
        fail("(d): the Gluon LM's loss did not fall: %.4f -> %.4f"
             % (head, tail))
    if graphs["captures"] != len(first) or graphs["recaptures"] \
            or graphs["replays"] != 2 * len(first):
        fail("(d): predict graphs %s over %d buckets" % (graphs, len(first)))
    if upd.get("captures") != 1 or upd.get("recaptures"):
        fail("(d): the Trainer's fused update graphs: %s" % upd)
    return dict(head=head, tail=tail, ms={k: statistics.median(v)
                                          for k, v in by_bucket.items()})


def pack_stream(seed=0):
    """Mixed-length samples for the packing path: each (L, heads, 3 x D),
    q, k and v side by side."""
    rs = np.random.RandomState(seed)
    return [rs.randn(int(L), PACK_HEADS, 3 * PACK_DIM).astype(np.float32)
            for L in rs.randint(PACK_LENGTHS[0], PACK_LENGTHS[1] + 1,
                                PACK_SAMPLES)]


def packed_attention(mx, tfa, card):
    """(e): PackedPipeline batches through ``_contrib_flash_attention``
    with their segment plane, causal, forward and backward on the
    kernels, held to the plain version (TOL forward, BWD_TOL backward),
    no gradient outside the touched sample; launch counts zeroed just
    before and read just after. Returns (launches, the first batch's
    plane on the card, the largest forward and backward errors)."""
    from mxnet_tpu_torch import bucketing
    pipe = bucketing.PackedPipeline(pack_stream(), PACK_BATCH,
                                    ladder=PACK_LADDER, name="pack")
    batches = []
    for b in pipe:
        batches.append(b)
        if len(batches) == PACK_BATCHES:
            break
    tfa.reset_launches()
    runs = []
    for b in batches:
        x = b.data[0]._data
        seg = torch.from_numpy(b.segment_ids).to(x.device)
        q, k, v = (mx.nd.NDArray(x[..., i * PACK_DIM:(i + 1) * PACK_DIM]
                                 .contiguous()) for i in range(3))
        for a in (q, k, v):
            a.attach_grad()
        touched = int(b.n_segments) // 2 + 1
        sel = mx.nd.NDArray((seg == touched).to(torch.float32)[..., None,
                                                                 None])
        with mx.autograd.record():
            out = mx.nd._contrib_flash_attention(
                q, k, v, mx.nd.NDArray(seg), causal=True)
            loss = (out * out * sel).sum()
        loss.backward()
        runs.append((b, seg, out._data.detach(),
                     [a.grad._data.clone() for a in (q, k, v)], touched))
    torch.cuda.synchronize()
    launches = dict(tfa.launches)
    ferr = berr = 0.0
    for b, seg, got, grads, touched in runs:
        x = b.data[0]._data
        leaves = [x[..., i * PACK_DIM:(i + 1) * PACK_DIM].contiguous()
                  .requires_grad_(True) for i in range(3)]
        ref = tfa.flash_attention(*leaves, causal=True, segment_ids=seg,
                                  impl="plain")
        sel = (seg == touched).to(torch.float32)[..., None, None]
        want = torch.autograd.grad((ref * ref * sel).sum(), leaves)
        real = seg > 0
        e, ok = close(got[real], ref.detach()[real], TOL)
        ferr = max(ferr, e)
        if not ok:
            fail("(e): packed forward disagrees with the plain version: %.3g"
                 % e)
        for g, w in zip(grads, want):
            e, ok = close(g, w, BWD_TOL)
            berr = max(berr, e)
            if not ok:
                fail("(e): packed backward disagrees with the plain "
                     "version: %.3g" % e)
            if bool((g[seg != touched] != 0).any()):
                fail("(e): a gradient crossed a segment (sample %d)"
                     % touched)
    want = {"flash_fwd": len(runs), "flash_bwd_dkdv": len(runs),
            "flash_bwd_dq": len(runs)}
    print("  (e) PackedPipeline (seed 0, ladder %s, %d mixed-length samples "
          "%d-%d): %d batches of B%d T%d H%d D%d, %s samples a batch, real "
          "token fraction %s; _contrib_flash_attention causal with the "
          "segment plane, forward and backward: err %.3g forward, %.3g "
          "backward; gradients zero outside the touched sample; segmented "
          "launches %s"
          % (PACK_LADDER, PACK_SAMPLES, PACK_LENGTHS[0], PACK_LENGTHS[1],
             len(runs), PACK_BATCH, PACK_LADDER[-1], PACK_HEADS, PACK_DIM,
             [int(r[0].n_segments) for r in runs],
             pipe.stats.snapshot()["real_token_fraction"], ferr, berr,
             {k: launches[k] for k in want}))
    if any(launches[k] != n for k, n in want.items()) or \
            any(v for k, v in launches.items() if k not in want):
        fail("(e): segmented launches %s, want %s" % (launches, want))
    return launches, runs[0][1], ferr, berr


def phase_bucketing(card, tfa):
    """Phase 19: variable-length training, the fifteenth slice's main
    path. Returns (the packing path's launches, its forward record, its
    backward records, its errors)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sents = lm_corpus()
    lens = np.array([len(s) for s in sents])
    print("bucketing: synthetic corpus of PTB's shape (seed %d): %d "
          "sentences, vocabulary %d (Zipf), %d successors a token taken "
          "with p %.2f; lengths mean %.1f, %.1f%% under 40, %d past %d "
          "(discarded); made in %.2f s"
          % (LM_SEED, len(sents), LM_VOCAB, LM_SUCCESSORS, LM_CHAIN,
             lens.mean(), 100.0 * (lens < 40).mean(),
             int((lens > LM_BUCKETS[-1]).sum()), LM_BUCKETS[-1],
             time.perf_counter() - t0))
    tfa.reset_launches()
    # (a) the LSTM LM through BucketingModule.fit on the fused step
    it = lm_iter(mx, sents)
    mod = lm_module(mx, lm_sym_gen(mx), it)
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    print("  (a) 2 x LSTMCell(%d) + Embedding(%d) + FC(%d) + SoftmaxOutput"
          "(use_ignore), %.2fM parameters, buckets %s, batch %d, SGD %s, "
          "Xavier(in, 2.34), %d epochs = %d steps an epoch"
          % (LM_HIDDEN, LM_EMBED, LM_VOCAB, sum(v.size for v in
                                                init.values()) / 1e6,
             LM_BUCKETS, LM_BATCH, LM_SGD, LM_EPOCHS, len(it.idx)))
    before = profiler.counters().get("fused_step_fallbacks", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = CaptureClock()
    watch = lm_fit(mx, mod, it, LM_EPOCHS, clock)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - before
    fused = lm_report("(a)", watch, card)
    print("  (a) fused_step_fallbacks %d; peak memory %.1f MB allocated, "
          "%.1f MB reserved" % (fallbacks, peak,
                                torch.cuda.memory_reserved() / 2 ** 20))
    if fallbacks:
        fail("(a): %d fused-step fallbacks" % fallbacks)
    batches = lm_batches(it)
    step_ms = lm_step_times(mod, batches, card, "(a) fused, replayed")
    t1 = time.perf_counter()
    ppl = mx.metric.Perplexity(ignore_label=0)
    mod.update_metric(ppl, batches[-1].label)
    torch.cuda.synchronize()
    print("  (a) update_metric (Perplexity, probabilities to the host) on "
          "the bucket-%d batch: %.2f ms" % (batches[-1].bucket_key,
                                            (time.perf_counter() - t1) * 1e3))
    prof = lm_profile(mod, batches[-1], card, "(a)")
    if any(tfa.launches.values()):
        fail("(a): the LSTM LM launched attention kernels: %s"
             % tfa.launches)
    print("  (a) done at %.1f s of the phase" % (time.perf_counter() - t_phase))
    # (b) the same fit with MXNET_FUSED_STEP=0, and one step each way
    with fused_gate(False):
        it_b = lm_iter(mx, sents)
        mod_b = lm_module(mx, lm_sym_gen(mx), it_b, arg_params=init)
        watch_b = lm_fit(mx, mod_b, it_b, LM_EAGER_EPOCHS, CaptureClock())
        eager = lm_report("(b) MXNET_FUSED_STEP=0", watch_b, card,
                          fused=False)
        eager_ms = lm_step_times(mod_b, lm_batches(it_b), card,
                                 "(b) eager", iters=5)
    print("  (b) fused against eager ms a step: %s; epoch-1 perplexity "
          "%.6f fused, %.6f eager"
          % (" ".join("%d: %.3f / %.3f" % (k, step_ms[k], eager_ms[k])
                      for k in sorted(step_ms)), fused["ppl"][0],
             eager["ppl"][0]))
    if abs(eager["ppl"][0] - fused["ppl"][0]) > LM_PPL_REL * fused["ppl"][0]:
        fail("(b): the eager fit's epoch-1 perplexity %.6f is not the fused "
             "fit's %.6f" % (eager["ppl"][0], fused["ppl"][0]))
    del mod_b, it_b
    lm_fused_vs_eager(mx, lm_sym_gen(mx), init, batches[-1], card)
    print("  (b) done at %.1f s of the phase" % (time.perf_counter() - t_phase))
    # (c) the FusedRNNCell variant: one RNN op, from (a)'s weights
    finit = fused_lstm_params(init)
    it_c = lm_iter(mx, sents)
    mod_c = lm_module(mx, lm_sym_gen(mx, fused=True), it_c,
                      arg_params=finit)
    ref = lm_module(mx, lm_sym_gen(mx), lm_iter(mx, sents), arg_params=init)
    probe = batches[0]
    mod_c.forward(probe, is_train=False)
    ref.forward(probe, is_train=False)
    err, ok = close(mod_c.get_outputs()[0]._data, ref.get_outputs()[0]._data,
                    LM_FUSED_TOL)
    print("  (c) FusedRNNCell (one RNN op, 2 layers of %d) from (a)'s "
          "weights: bucket-%d probabilities against the unrolled cells' "
          "max abs err %.3g (rtol %g, atol %g)"
          % (LM_HIDDEN, probe.bucket_key, err, LM_FUSED_TOL["rtol"],
             LM_FUSED_TOL["atol"]))
    if not ok:
        fail("(c): the RNN op's model disagrees with the unrolled cells")
    del ref
    watch_c = lm_fit(mx, mod_c, it_c, LM_EPOCHS, CaptureClock())
    fused_c = lm_report("(c) FusedRNNCell", watch_c, card)
    step_c = lm_step_times(mod_c, lm_batches(it_c), card,
                           "(c) FusedRNNCell, replayed")
    prof_c = lm_profile(mod_c, lm_batches(it_c)[-1], card, "(c)")
    del mod_c, it_c, mod, it
    rnn = rnn_op_timing(mx, finit, card)
    print("  (c) done at %.1f s of the phase" % (time.perf_counter() - t_phase))
    # (d) the Gluon path
    gl = gluon_lm_train(mx, sents, card)
    if any(tfa.launches.values()):
        fail("(a)-(d): the LSTM paths launched attention kernels: %s"
             % tfa.launches)
    print("  attention and decode kernel launches over (a)-(d): %s (none "
          "is on these paths); (d) done at %.1f s of the phase"
          % (dict(tfa.launches), time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    # (e) the packing path on the flash kernels
    launches, seg, ferr, berr = packed_attention(mx, tfa, card)
    H, D, T = PACK_HEADS, PACK_DIM, PACK_LADDER[-1]
    fwd = fwd_case(tfa, PACK_BATCH, T, T, H, D, True, True, seed=31,
                   seg=seg)
    bwd = bwd_case(tfa, PACK_BATCH, T, T, H, D, True, True, seed=32,
                   seg=seg)
    print("bucketing phase %.1f s" % (time.perf_counter() - t_phase))
    return dict(launches=launches, fwd=fwd, bwd=bwd, ferr=max(ferr, fwd["err"]),
                berr={k: max(berr, bwd[k]["err"]) for k in bwd},
                fused=fused, eager=eager, fused_c=fused_c, step_ms=step_ms,
                eager_ms=eager_ms, step_c=step_c, prof=prof, prof_c=prof_c,
                rnn=rnn, gluon=gl)


# ---------------------------------------------------------------------------
# phase 20: the rest of the Gluon surface, mx.random and the DCGAN
# ---------------------------------------------------------------------------

RANDOM_DRAWS = 1 << 20
SAMPLER_N = 40000                   # tests/test_random_samplers.py's N
SAMPLER_RTOL = 0.08                 # and its RTOL
# its tolerances scaled to this sample size (a moment's spread falls as
# 1/sqrt(n))
SAMPLER_SCALE = math.sqrt(SAMPLER_N / RANDOM_DRAWS)
RANDINT_CHI2 = 30.0                 # 5 degrees of freedom: p ~ 1.4e-5
GAN_NZ, GAN_NGF, GAN_NDF, GAN_NC = 100, 64, 64, 3
GAN_IMAGE = 64
GAN_BATCH = 64
GAN_IMAGES = 2048
GAN_STEPS = 150                     # (cut from 300: phase 33's time)
GAN_TIMED = 10                      # (cut from 20: phase 33's time)
GAN_SPIN_CYCLES = 1 << 24           # ~8 ms: longer than a Trainer.step's host work
GAN_SEED = 0
GAN_ADAM = dict(learning_rate=2e-4, beta1=0.5)
GAN_TRAINABLE = (3576704, 2765568)  # G, D at the tutorial's widths
GAN_TOL = dict(rtol=1e-5, atol=1e-5)
GAN_LOSS_START = 2 * math.log(2)
GAN_ACC_MIN = 0.6
GAN_CLASSES = (("convolutions", ("conv", "dgrad", "wgrad", "fprop", "bprop",
                                 "xmma", "implicit", "gemm", "cutlass",
                                 "winograd", "fft", "nchw", "nhwc",
                                 "sm90_", "sm80_", "cudnn")),)


def h2d_copies(prof):
    """The host-to-device copies in a CUDA profile."""
    return sum(1 for e in prof.events() if "memcpy htod" in e.name.lower())


def random_cases(mx, ctx):
    """The 17 sampling ops, each at RANDOM_DRAWS draws on ``ctx``: (name,
    draw, check), ``check(numpy sample) -> [(what, ok)]``. The
    tensor-parameter samplers draw two rows of half as many under their
    own parameters."""
    n = RANDOM_DRAWS
    s = SAMPLER_SCALE
    rt = SAMPLER_RTOL * s
    half = n // 2

    def two(a, b):
        return mx.nd.array(np.array([a, b], np.float32), ctx=ctx)

    def near(what, got, want, rtol=0.0, atol=0.0):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return ("%s %s (want %s)" % (what, np.round(got, 4).tolist(),
                                     np.round(want, 4).tolist()),
                bool(np.all(np.abs(got - want)
                            <= atol + rtol * np.abs(want))))

    def integral(x):
        return ("integers", bool(np.all(x == np.round(x))))

    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.3, 0.2]], np.float32)

    def multinomial_check(out):
        draws, lp = out
        rows = [np.bincount(draws[r], minlength=3) / half for r in range(2)]
        want_lp = np.log(probs)[np.arange(2)[:, None], draws]
        return [near("row frequencies", rows, probs, atol=0.02 * s),
                ("log-probabilities", bool(np.allclose(lp, want_lp,
                                                       rtol=1e-5,
                                                       atol=1e-6)))]

    def randint_check(x):
        counts = np.bincount(x.astype(np.int64), minlength=9)[3:9]
        expect = x.size / 6.0
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        return [("bounds [%d, %d]" % (x.min(), x.max()),
                 x.min() == 3 and x.max() == 8),
                ("chi-square %.2f < %.1f" % (chi2, RANDINT_CHI2),
                 chi2 < RANDINT_CHI2)]

    # the parameter arrays are made here: a draw copies nothing to the card
    rows = {pair: two(*pair) for pair in [
        (-3.0, 2.0), (0.0, 5.0), (0.25, 0.5), (0.4, 0.5),
        (1.0, 0.5), (1.0, 4.0), (1.0, 9.0), (2.0, 5.0),
        (2.0, 9.0), (4.0, 2.0), (5.0, 2.0)]}
    probs_nd = mx.nd.array(probs, ctx=ctx)
    shuffle_src = mx.nd.array(np.arange(n, dtype=np.float32), ctx=ctx)
    nd = mx.nd
    return [
        ("_random_uniform",
         lambda: nd._random_uniform(low=-2.0, high=3.0, shape=(n,), ctx=ctx),
         lambda x: [("bounds", x.min() >= -2.0 and x.max() < 3.0),
                    near("mean", x.mean(), 0.5, atol=0.05 * s),
                    near("var", x.var(), 25.0 / 12, rtol=rt)]),
        ("_random_normal",
         lambda: nd._random_normal(loc=1.5, scale=2.0, shape=(n,), ctx=ctx),
         lambda x: [near("mean", x.mean(), 1.5, atol=0.05 * s),
                    near("std", x.std(), 2.0, rtol=rt)]),
        ("_random_gamma",
         lambda: nd._random_gamma(alpha=3.0, beta=2.0, shape=(n,), ctx=ctx),
         lambda x: [near("mean", x.mean(), 6.0, rtol=rt),
                    near("var", x.var(), 12.0, rtol=2 * rt),
                    ("positive", x.min() > 0)]),
        ("_random_exponential",
         lambda: nd._random_exponential(lam=4.0, shape=(n,), ctx=ctx),
         lambda x: [near("mean", x.mean(), 0.25, rtol=rt),
                    near("std", x.std(), 0.25, rtol=2 * rt)]),
        ("_random_poisson",
         lambda: nd._random_poisson(lam=7.0, shape=(n,), ctx=ctx),
         lambda x: [near("mean", x.mean(), 7.0, rtol=rt),
                    near("var", x.var(), 7.0, rtol=2 * rt), integral(x)]),
        ("_random_randint",
         lambda: nd._random_randint(low=3, high=9, shape=(n,), ctx=ctx),
         randint_check),
        ("_random_negative_binomial",
         lambda: nd._random_negative_binomial(k=5.0, p=0.4, shape=(n,),
                                              ctx=ctx),
         lambda x: [near("mean", x.mean(), 7.5, rtol=rt),
                    near("var", x.var(), 18.75, rtol=2 * rt), integral(x)]),
        ("_random_generalized_negative_binomial",
         lambda: nd._random_generalized_negative_binomial(
             mu=4.0, alpha=0.25, shape=(n,), ctx=ctx),
         lambda x: [near("mean", x.mean(), 4.0, rtol=rt),
                    near("var", x.var(), 8.0, rtol=2 * rt), integral(x)]),
        ("_sample_uniform",
         lambda: nd._sample_uniform(rows[0.0, 5.0], rows[1.0, 9.0],
                                    shape=(half,)),
         lambda x: [near("row means", x.mean(1), [0.5, 7.0], atol=0.08 * s),
                    ("row bounds", x[0].min() >= 0 and x[0].max() < 1
                     and x[1].min() >= 5 and x[1].max() < 9)]),
        ("_sample_normal",
         lambda: nd._sample_normal(rows[-3.0, 2.0], rows[1.0, 0.5],
                                   shape=(half,)),
         lambda x: [near("row means", x.mean(1), [-3.0, 2.0], atol=0.08 * s),
                    near("row stds", x.std(1), [1.0, 0.5], rtol=rt)]),
        ("_sample_gamma",
         lambda: nd._sample_gamma(rows[2.0, 5.0], rows[1.0, 0.5],
                                  shape=(half,)),
         lambda x: [near("row means", x.mean(1), [2.0, 2.5], rtol=rt),
                    near("row vars", x.var(1), [2.0, 1.25], rtol=2 * rt)]),
        ("_sample_exponential",
         lambda: nd._sample_exponential(rows[1.0, 4.0], shape=(half,)),
         lambda x: [near("row means", x.mean(1), [1.0, 0.25], rtol=rt)]),
        ("_sample_poisson",
         lambda: nd._sample_poisson(rows[2.0, 9.0], shape=(half,)),
         lambda x: [near("row means", x.mean(1), [2.0, 9.0], rtol=rt),
                    near("row vars", x.var(1), [2.0, 9.0], rtol=2 * rt),
                    integral(x)]),
        ("_sample_negative_binomial",
         lambda: nd._sample_negative_binomial(rows[5.0, 2.0], rows[0.4, 0.5],
                                              shape=(half,)),
         lambda x: [near("row means", x.mean(1), [7.5, 2.0], rtol=rt),
                    near("row vars", x.var(1), [18.75, 4.0], rtol=2 * rt)]),
        ("_sample_generalized_negative_binomial",
         lambda: nd._sample_generalized_negative_binomial(
             rows[4.0, 2.0], rows[0.25, 0.5], shape=(half,)),
         lambda x: [near("row means", x.mean(1), [4.0, 2.0], rtol=rt),
                    near("row vars", x.var(1), [8.0, 4.0], rtol=2 * rt)]),
        ("_sample_multinomial",
         lambda: nd._sample_multinomial(probs_nd,
                                        shape=(half,), get_prob=True),
         multinomial_check),
        ("_shuffle", lambda: nd._shuffle(shuffle_src),
         lambda x: [("a permutation", bool(np.array_equal(
             np.sort(x), np.arange(n, dtype=np.float32)))),
             ("not the identity", not np.array_equal(
                 x, np.arange(n, dtype=np.float32)))]),
    ]


def random_on_card(mx, ctx, card):
    """(a): every sampling op at RANDOM_DRAWS draws made on ``ctx``'s
    device (no host-to-device copy while they draw), held to the
    moments and bounds of tests/test_random_samplers.py; the seeds."""
    from torch.profiler import ProfilerActivity, profile
    dev = ctx.torch_device()
    mx.random.seed(GAN_SEED)
    cases = random_cases(mx, ctx)
    for _, draw, _ in cases:        # each generator exists before the run
        draw()
    torch.cuda.synchronize()
    outs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, draw, _ in cases:
            outs[name] = draw()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    copies = h2d_copies(prof)
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    print("  (a) 17 sampling ops, %d draws each on %s: %.2f ms wall, device "
          "busy %.3f ms (profiled), host-to-device copies while drawing: %d; "
          "tolerances of tests/test_random_samplers.py x %.4f (sqrt(%d / "
          "%d)); %s"
          % (RANDOM_DRAWS, dev, wall, busy, copies, SAMPLER_SCALE,
             SAMPLER_N, RANDOM_DRAWS, card))
    if copies:
        fail("(a): %d host-to-device copies while the samplers drew" % copies)
    for name, _, check in cases:
        out = outs[name]
        parts = out if isinstance(out, (list, tuple)) else [out]
        if any(p._data.device != dev for p in parts):
            fail("(a): %s drew on %s" % (name, [p._data.device
                                              for p in parts]))
        host = [p.asnumpy() for p in parts]
        size = host[0].size
        results = check(host if len(host) > 1 else host[0])
        print("    %-38s %s %s: %s" % (name, host[0].dtype, host[0].shape,
                                       "; ".join(w for w, _ in results)))
        if size != RANDOM_DRAWS:
            fail("(a): %s made %d draws" % (name, size))
        bad = [w for w, ok in results if not ok]
        if bad:
            fail("(a): %s: %s" % (name, bad))
    # seeds: seed(n) repeats the card's draws; seed(n, ctx) only the card's
    cpu = mx.cpu()

    def pair():
        return (mx.nd.random.normal(shape=(64,), ctx=ctx).asnumpy(),
                mx.nd.random.normal(shape=(64,), ctx=cpu).asnumpy())
    mx.random.seed(5)
    g1, c1 = pair()
    g2, c2 = pair()
    mx.random.seed(5)
    g1b, c1b = pair()
    mx.random.seed(5, ctx=ctx)
    g1c, c2c = pair()
    ok = (np.array_equal(g1, g1b) and np.array_equal(c1, c1b)
          and not np.array_equal(g1, g2) and np.array_equal(g1c, g1)
          and np.array_equal(c2c, c2))
    print("  (a) mx.random.seed(5) repeats the draws on both devices: %s; "
          "seed(5, ctx=%s) restarts the card's stream only (the host's "
          "goes on): %s" % (np.array_equal(g1, g1b)
                            and np.array_equal(c1, c1b),
                            ctx, np.array_equal(g1c, g1)
                            and np.array_equal(c2c, c2)))
    if not ok:
        fail("(a): seeding does not repeat the draws as it should")
    return dict(wall_ms=wall, busy_ms=busy)


def layer_cases(mx):
    """(name, make, input shape, train mode of the recorded call) of the
    new layers at the DCGAN's shapes, the discriminator's (64, 128, 16,
    16) activations, the generator's (64, 256, 8, 8) features; rrelu is
    held in predict mode (in training it draws its slopes)."""
    nn, cnn = mx.gluon.nn, mx.gluon.contrib.nn
    act = (GAN_BATCH, 2 * GAN_NDF, 16, 16)
    feat = (GAN_BATCH, 4 * GAN_NGF, 8, 8)
    return [
        ("LeakyReLU(0.2)", lambda: nn.LeakyReLU(0.2), act),
        ("PReLU", lambda: nn.PReLU(), act),
        ("ELU", lambda: nn.ELU(0.8), act),
        ("SELU", lambda: nn.SELU(), act),
        ("GELU", lambda: nn.GELU(), act),
        ("Swish", lambda: nn.Swish(1.5), act),
        ("InstanceNorm", lambda: nn.InstanceNorm(
            scale=True, in_channels=feat[1],
            gamma_initializer=mx.init.Constant(1.5),
            beta_initializer=mx.init.Constant(-0.25)), feat),
        ("HybridLambda(tanh)", lambda: nn.HybridLambda("tanh"),
         (GAN_BATCH, GAN_NC, GAN_IMAGE, GAN_IMAGE)),
        ("rrelu (predict)", lambda: nn.HybridLambda(
            lambda F, x: F.LeakyReLU(x, act_type="rrelu")[0]), act, False),
        ("PixelShuffle1D(2)", lambda: cnn.PixelShuffle1D(2),
         (GAN_BATCH, 2 * GAN_NDF, 64)),
        ("PixelShuffle2D(2)", lambda: cnn.PixelShuffle2D(2), feat),
        ("PixelShuffle3D(2)", lambda: cnn.PixelShuffle3D(2),
         (8, GAN_NGF, 4, 8, 8)),
    ]


def loss_cases(mx):
    """(name, make, arrays): the ten losses, D's (64, 1) logits for the
    sigmoid family, (64, 100) rows for the rest."""
    rs = np.random.RandomState(41)
    L = mx.gluon.loss
    b, w = GAN_BATCH, GAN_NZ

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)

    def pos(*shape):
        return (rs.rand(*shape) * 0.9 + 0.05).astype(np.float32)

    def bits(*shape):
        return (rs.rand(*shape) > 0.5).astype(np.float32)

    def sign(*shape):
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)
    sw = pos(b, 1)
    return [
        ("SigmoidBCELoss", L.SigmoidBCELoss, [r(b, 1) * 3, bits(b, 1), sw]),
        ("SigmoidBCELoss(pos_weight)", L.SigmoidBCELoss,
         [r(b, w), bits(b, w), sw, pos(w) * 3]),
        ("SigmoidBCELoss(from_sigmoid)",
         lambda: L.SigmoidBCELoss(from_sigmoid=True),
         [pos(b, w), bits(b, w), sw]),
        ("L1Loss", L.L1Loss, [r(b, w), r(b, w), sw]),
        ("KLDivLoss", lambda: L.KLDivLoss(from_logits=False),
         [r(b, w), pos(b, w), sw]),
        ("HuberLoss", lambda: L.HuberLoss(rho=0.5), [r(b, w), r(b, w), sw]),
        ("HingeLoss", L.HingeLoss, [r(b, w), sign(b, w), sw]),
        ("SquaredHingeLoss", L.SquaredHingeLoss, [r(b, w), sign(b, w), sw]),
        ("LogisticLoss", L.LogisticLoss, [r(b, w), sign(b, w), sw]),
        ("TripletLoss", L.TripletLoss, [r(b, w), r(b, w), r(b, w)]),
        ("PoissonNLLLoss", lambda: L.PoissonNLLLoss(compute_full=True),
         [r(b, w), pos(b, w) * 4, sw]),
        ("CosineEmbeddingLoss", lambda: L.CosineEmbeddingLoss(margin=0.1),
         [r(b, w), r(b, w), sign(b), sw[:, 0]]),
    ]


def block_grads(mx, net, x, head, ctx, train_mode=True):
    """(output, input gradient, {param: gradient}) of one recorded call."""
    xin = mx.nd.array(x, ctx=ctx)
    xin.attach_grad()
    with mx.autograd.record(train_mode=train_mode):
        out = net(xin)
    out.backward(mx.nd.array(head, ctx=ctx))
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return out.asnumpy(), xin.grad.asnumpy(), grads


def worst(pairs, tol=GAN_TOL, of_largest=False):
    """(max abs error, all within tol) over (got, want) numpy pairs;
    ``of_largest`` scales atol by each array's largest entry (a sum over
    the batch, which two devices add in another order)."""
    err, ok = 0.0, True
    for got, want in pairs:
        want = np.asarray(want, np.float64)
        d = np.abs(np.asarray(got, np.float64) - want)
        err = max(err, float(d.max()) if d.size else 0.0)
        atol = tol["atol"] * (max(float(np.abs(want).max()), 1.0)
                              if of_largest else 1.0)
        ok = ok and bool(np.all(np.isfinite(got))) and bool(
            np.all(d <= atol + tol["rtol"] * np.abs(want)))
    return err, ok


def layers_on_card(mx, ctx, card):
    """(b): each new layer hybridized on ``ctx`` against the port on the
    CPU (eager) from the same numpy input, weights and head gradient:
    the output, the input and parameter gradients of a recorded call,
    and the predict-mode output (the card's by graph replay); the ten
    losses and ``norm`` with their gradients; the five initializers on
    both devices under one numpy seed."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    cpu = mx.cpu()
    rs = np.random.RandomState(40)
    n_checks = 0
    for name, make, shape, *mode in layer_cases(mx):
        train = mode[0] if mode else True
        x = rs.randn(*shape).astype(np.float32)
        host = make()
        host.initialize(ctx=cpu)
        want = host(mx.nd.array(x, ctx=cpu))
        weights = {k: p.data().asnumpy() for k, p in
                   host._collect_params_with_prefix().items()}
        head = rs.randn(*want.shape).astype(np.float32)
        card_net = make()
        card_net.initialize(ctx=ctx)
        params_from_numpy(card_net, weights, ctx=ctx)
        card_net.hybridize()
        w_out, w_dx, w_dp = block_grads(mx, host, x, head, cpu, train)
        g_out, g_dx, g_dp = block_grads(mx, card_net, x, head, ctx, train)
        pred = card_net(mx.nd.array(x, ctx=ctx)).asnumpy()
        pred_want = host(mx.nd.array(x, ctx=cpu)).asnumpy()
        err, ok = worst([(g_out, w_out), (g_dx, w_dx), (pred, pred_want)])
        perr, pok = worst([(g_dp[k], w_dp[k]) for k in w_dp],
                          of_largest=True)
        st = card_net._cached_op.stats()
        print("    %-28s %-20s out %s, predict graph %s: max abs err %.3g; "
              "%d parameter gradient(s) (largest entry %s) %.3g"
              % (name, shape, g_out.shape, st, err, len(w_dp),
                 ["%.4g" % np.abs(w_dp[k]).max() for k in sorted(w_dp)],
                 perr))
        if not (ok and pok) or sorted(g_dp) != sorted(w_dp):
            fail("(b): %s on the card disagrees with the CPU (%.3g, %.3g)"
                 % (name, err, perr))
        if st["captures"] != 1 or st["eager_rng"]:
            fail("(b): %s's predict call did not replay a graph: %s"
                 % (name, st))
        n_checks += 1
    for name, make, arrays in loss_cases(mx):
        res = []
        for dev in (cpu, ctx):
            args = [mx.nd.array(a, ctx=dev) for a in arrays]
            args[0].attach_grad()
            with mx.autograd.record():
                out = make()(*args)
            out.backward()
            res.append((out.asnumpy(), args[0].grad.asnumpy()))
        err, ok = worst([(res[1][0], res[0][0]), (res[1][1], res[0][1])])
        print("    %-28s loss %s and its gradient: max abs err %.3g"
              % (name, res[1][0].shape, err))
        if not ok:
            fail("(b): %s on the card disagrees with the CPU (%.3g)"
                 % (name, err))
        n_checks += 1
    x = rs.randn(GAN_BATCH, GAN_NZ, 4).astype(np.float32)
    head = rs.randn(GAN_BATCH, 4).astype(np.float32)
    res = []
    for dev in (cpu, ctx):
        a = mx.nd.array(x, ctx=dev)
        a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.norm(a, axis=1)
        out.backward(mx.nd.array(head, ctx=dev))
        res.append((out.asnumpy(), a.grad.asnumpy()))
    err, ok = worst([(res[1][0], res[0][0]), (res[1][1], res[0][1])])
    print("    %-28s (64, 100, 4) over axis 1 and its gradient: max abs "
          "err %.3g" % ("norm", err))
    if not ok:
        fail("(b): norm on the card disagrees with the CPU")
    inits = [("Orthogonal", lambda: mx.init.Orthogonal(), (256, 512)),
             ("MSRAPrelu", lambda: mx.init.MSRAPrelu(), (128, 64, 4, 4)),
             ("Bilinear", lambda: mx.init.Bilinear(), (64, 64, 4, 4)),
             ("LSTMBias", lambda: mx.init.LSTMBias(), (800,)),
             ("Mixed", lambda: mx.init.Mixed(
                 [".*bias", ".*"], [mx.init.Zero(), mx.init.Orthogonal()]),
              (100, 64))]
    same = []
    for name, make, shape in inits:
        arrs = []
        for dev in (cpu, ctx):
            np.random.seed(GAN_SEED)
            arr = mx.nd.zeros(shape, ctx=dev)
            make()(mx.init.InitDesc("layer_weight"), arr)
            arrs.append(arr.asnumpy())
        same.append(bool(np.array_equal(*arrs)))
    print("  (b) %d layers and %d losses (+ norm) on %s against the CPU "
          "within rtol = atol = %g (a parameter gradient, a sum over the "
          "batch, within atol %g of its largest entry), TF32 off; the five "
          "initializers bit-identical on both devices under one numpy "
          "seed: %s"
          % (len(layer_cases(mx)), len(loss_cases(mx)), ctx,
             GAN_TOL["rtol"], GAN_TOL["atol"],
             dict(zip([i[0] for i in inits], same))))
    if not all(same):
        fail("(b): an initializer differs between the card and the CPU")
    return n_checks


def gan_nets(mx, ngf=GAN_NGF, ndf=GAN_NDF):
    """The tutorial's generator and discriminator (no biases)."""
    nn = mx.gluon.nn
    g = nn.HybridSequential()
    with g.name_scope():
        g.add(nn.Conv2DTranspose(ngf * 8, 4, 1, 0, use_bias=False),
              nn.BatchNorm(), nn.Activation("relu"))
        for mult in (4, 2, 1):
            g.add(nn.Conv2DTranspose(ngf * mult, 4, 2, 1, use_bias=False),
                  nn.BatchNorm(), nn.Activation("relu"))
        g.add(nn.Conv2DTranspose(GAN_NC, 4, 2, 1, use_bias=False),
              nn.Activation("tanh"))
    d = nn.HybridSequential()
    with d.name_scope():
        d.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False), nn.LeakyReLU(0.2))
        for mult in (2, 4, 8):
            d.add(nn.Conv2D(ndf * mult, 4, 2, 1, use_bias=False),
                  nn.BatchNorm(), nn.LeakyReLU(0.2))
        d.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return g, d


def gan_images(dev):
    """GAN_IMAGES synthetic 64x64 RGB images in [-1, 1], made on ``dev``
    from GAN_SEED: a coloured background and two soft blobs of random
    colour, centre and radius."""
    n = GAN_IMAGES
    gen = torch.Generator(device=dev).manual_seed(GAN_SEED)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    axis = torch.linspace(-1.0, 1.0, GAN_IMAGE, device=dev)
    yy, xx = axis.reshape(1, 1, -1, 1), axis.reshape(1, 1, 1, -1)
    img = (u(n, GAN_NC, 1, 1) * 2 - 1) * 0.3
    for _ in range(2):
        cy, cx = (u(n, 1, 1, 1) * 1.4 - 0.7 for _ in range(2))
        rad = u(n, 1, 1, 1) * 0.3 + 0.15
        blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad ** 2))
        img = img + blob * (u(n, GAN_NC, 1, 1) * 2 - 1) * 1.5
    return torch.tanh(img)


def gan_facc(label, pred):
    """The tutorial's binary accuracy, on D's raw outputs."""
    pred = pred.ravel()
    label = label.ravel()
    return ((pred > 0.5) == label).mean()


class GanLoop:
    """The tutorial's loop over a pair of nets: D's step on a real and a
    detached fake batch, then G's step; both by Adam."""

    def __init__(self, mx, g, d, ctx):
        self.mx, self.g, self.d, self.ctx = mx, g, d, ctx
        self.loss = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        self.trainer_g = mx.gluon.Trainer(g.collect_params(), "adam",
                                          dict(GAN_ADAM))
        self.trainer_d = mx.gluon.Trainer(d.collect_params(), "adam",
                                          dict(GAN_ADAM))
        self.real_label = mx.nd.ones((GAN_BATCH,), ctx=ctx)
        self.fake_label = mx.nd.zeros((GAN_BATCH,), ctx=ctx)
        self.metric = mx.metric.CustomMetric(gan_facc)
        self.adam_events = []
        self.adam_host = []

    def latent(self):
        return self.mx.nd.random.normal(0, 1, shape=(GAN_BATCH, GAN_NZ, 1, 1),
                                        ctx=self.ctx)

    def step(self, data, z=None, metric=False, time_adam=False):
        """One GAN step; returns (D's loss, G's loss, the fake batch),
        NDArrays on the card."""
        mx, g, d = self.mx, self.g, self.d
        z = self.latent() if z is None else z
        with mx.autograd.record():
            output = d(data).reshape((-1, 1))
            err_real = self.loss(output, self.real_label)
            if metric:
                self.metric.update([self.real_label], [output])
            fake = g(z)
            output = d(fake.detach()).reshape((-1, 1))
            err_fake = self.loss(output, self.fake_label)
            err_d = err_real + err_fake
            err_d.backward()
        if metric:
            self.metric.update([self.fake_label], [output])
        self._update(self.trainer_d, time_adam)
        with mx.autograd.record():
            fake = g(z)
            output = d(fake).reshape((-1, 1))
            err_g = self.loss(output, self.real_label)
            err_g.backward()
        self._update(self.trainer_g, time_adam)
        return err_d, err_g, fake

    def _update(self, trainer, timed):
        """``trainer.step``; timed, a spin kernel runs ahead of the start
        event, so the step's host work is queued before its device time
        starts (the events read the replayed update alone), and the host
        clock reads the call."""
        if not timed:
            trainer.step(GAN_BATCH)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(GAN_SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        trainer.step(GAN_BATCH)
        self.adam_host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        self.adam_events.append((start, end))


def gan_weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def gan_first_step(mx, ctx, data, z):
    """The first step of the hybridized nets against the same nets run
    op by op, from the same weights (Normal(0.02) from
    ``mx.random.seed(GAN_SEED)``) and latent, under deterministic cuDNN:
    losses, fakes, every weight and statistic bit-identical. Returns the
    hybridized loop (one step taken), its first losses and the trainable
    parameter counts."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    mx.random.seed(GAN_SEED)
    g0, d0 = gan_nets(mx)
    g0.initialize(mx.init.Normal(0.02), ctx=ctx)
    d0.initialize(mx.init.Normal(0.02), ctx=ctx)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g0.summary(z)
        d0.summary(g0(z))
    totals = [int(m) for m in re.findall(r"Trainable params: (\d+)",
                                         buf.getvalue())]
    print("  (c) summary(): trainable parameters G %s, D %s (want %d, %d)"
          % (totals[0], totals[1], *GAN_TRAINABLE))
    if tuple(totals) != GAN_TRAINABLE:
        fail("(c): summary() counts %s trainable parameters" % totals)
    gw, dw = gan_weights(g0), gan_weights(d0)
    g1, d1 = gan_nets(mx)
    for net, weights in ((g1, gw), (d1, dw)):
        net.initialize(ctx=ctx)
        params_from_numpy(net, weights, ctx=ctx)
        net.hybridize()
    res = []
    with deterministic_cudnn():
        for g, d in ((g0, d0), (g1, d1)):
            loop = GanLoop(mx, g, d, ctx)
            err_d, err_g, fake = loop.step(data, z=z, metric=True)
            res.append(dict(err_d=err_d.asnumpy(), err_g=err_g.asnumpy(),
                            fake=fake.asnumpy(),
                            **{"g:" + k: v for k, v in gan_weights(g).items()},
                            **{"d:" + k: v for k, v in gan_weights(d).items()}))
    diff = {k: float(np.abs(res[1][k] - res[0][k]).max()) for k in res[0]}
    same = all(np.array_equal(res[1][k], res[0][k]) for k in res[0])
    moved = sum(not np.array_equal(res[1][k], (gw if k[0] == "g" else dw)
                                   [k[2:]])
                for k in res[1] if k[:2] in ("g:", "d:"))
    first = dict(err_d=float(res[1]["err_d"].mean()),
                 err_g=float(res[1]["err_g"].mean()))
    print("  (c) first step, hybridized against op by op (deterministic "
          "cuDNN): bit-identical %s (largest difference %.3g over %d "
          "arrays); %d of %d weights and statistics moved; D's loss %.4f "
          "(2 ln 2 = %.4f), G's %.4f"
          % (same, max(diff.values()), len(diff), moved, len(gw) + len(dw),
             first["err_d"], GAN_LOSS_START, first["err_g"]))
    if not same:
        fail("(c): the hybridized first step differs from the op-by-op "
             "one: %s" % {k: v for k, v in diff.items() if v})
    if moved != len(gw) + len(dw):
        fail("(c): the first step left weights unchanged")
    if abs(first["err_d"] - GAN_LOSS_START) > 0.25 * GAN_LOSS_START:
        fail("(c): D's first loss %.4f is not near 2 ln 2" % first["err_d"])
    return loop, first, totals


def phase_gan(card):
    """Phase 20: the sixteenth slice's main path, the rest of the Gluon
    surface and ``mx.random``, with the DCGAN of MXNet's Gluon GAN
    tutorial (docs/tutorials/unsupervised_learning/gan.md in
    incubator-mxnet v1.5, after Radford et al. 2015) at its published
    widths. Cuts: the tutorial's LFW / CIFAR-10 images are not in the
    repository, so the data are GAN_IMAGES synthetic coloured blobs
    made on the card from seed GAN_SEED (``gan_images``); and the depth
    is GAN_STEPS steps (about 5 epochs of those images), not 25 epochs.
    No kernel of the table is on this path: the attention, decode and
    rtc launch counts, zeroed before, must read 0 after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tfa.reset_launches()
    rtc.reset_launches()
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    rnd = random_on_card(mx, ctx, card)
    print("  (a) done at %.1f s of the phase" % (time.perf_counter() - t_phase))
    n_checks = layers_on_card(mx, ctx, card)
    print("  (b) %d layer and loss checks; done at %.1f s of the phase"
          % (n_checks, time.perf_counter() - t_phase))
    # (c) the DCGAN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    images = gan_images(dev)
    print("  (c) DCGAN: nz %d, ngf %d, ndf %d, nc %d, %dx%d, batch %d, fp32, "
          "TF32 off; Adam %s for both nets; %d synthetic images from seed "
          "%d (%.1f MB on the card, %.3f..%.3f)"
          % (GAN_NZ, GAN_NGF, GAN_NDF, GAN_NC, GAN_IMAGE, GAN_IMAGE,
             GAN_BATCH, GAN_ADAM, GAN_IMAGES, GAN_SEED,
             images.numel() * 4 / 2 ** 20, float(images.min()),
             float(images.max())))
    order = torch.Generator(device=dev).manual_seed(GAN_SEED + 1)

    def batches():
        while True:
            keys = torch.rand(GAN_IMAGES, generator=order, device=dev)
            perm = torch.argsort(keys)
            for i in range(GAN_IMAGES // GAN_BATCH):
                yield mx.nd.NDArray(
                    images[perm[i * GAN_BATCH:(i + 1) * GAN_BATCH]])
    feed = batches()
    mx.random.seed(GAN_SEED)
    z0 = mx.nd.random.normal(0, 1, shape=(GAN_BATCH, GAN_NZ, 1, 1), ctx=ctx)
    loop, first, _ = gan_first_step(mx, ctx, next(feed), z0)
    with guard_on("skip_step") as fault:
        losses = []
        acc = []
        loop.metric.reset()
        t0 = time.perf_counter()
        for step in range(1, GAN_STEPS):
            err_d, err_g, fake = loop.step(next(feed), metric=True)
            losses.append(torch.stack([err_d._data.detach().mean(),
                                       err_g._data.detach().mean()]))
            if step % 25 == 0:
                acc.append(loop.metric.get()[1])
                loop.metric.reset()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        skipped = fault.stats()["skipped_steps"]
    curve = torch.stack(losses).cpu().numpy()
    samples = loop.g(loop.latent())
    lo, hi = float(samples._data.min()), float(samples._data.max())
    finite = bool(np.isfinite(curve).all())
    print("  (c) %d more steps with the metric in %.2f s (%.2f ms a step); "
          "non-finite guard (skip_step) skipped %d; losses finite %s; D's "
          "loss by 25 steps %s; G's %s; the tutorial's binary accuracy of "
          "D (real vs fake, raw outputs > 0.5) by 25 steps %s"
          % (GAN_STEPS - 1, train_s, train_s * 1e3 / (GAN_STEPS - 1),
             skipped, finite,
             " ".join("%.3f" % v for v in curve[24::25, 0]),
             " ".join("%.3f" % v for v in curve[24::25, 1]),
             " ".join("%.3f" % a for a in acc)))
    late = float(np.mean(acc[len(acc) // 2:]))
    print("  (c) D's accuracy over the second half %.3f (chance 0.5, held "
          "above %.2f); G's samples (predict, by graph) in [%.4f, %.4f]"
          % (late, GAN_ACC_MIN, lo, hi))
    if skipped or not finite:
        fail("(c): a non-finite loss or gradient (%d steps skipped)"
             % skipped)
    if not late > GAN_ACC_MIN:
        fail("(c): D's accuracy %.3f did not rise above chance" % late)
    if lo < -1.0 or hi > 1.0:
        fail("(c): G's samples leave [-1, 1]: %g..%g" % (lo, hi))
    # timing: the step without the metric, D's and G's halves, Adam
    data = next(feed)
    for _ in range(3):
        loop.step(data)
    torch.cuda.synchronize()
    d_ms, g_ms, step_ms = [], [], []
    for _ in range(GAN_TIMED):
        t0 = time.perf_counter()
        loop.step(data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    loop.adam_events.clear()
    for _ in range(GAN_TIMED):
        loop.step(data, time_adam=True)
    torch.cuda.synchronize()
    adam_ms = sum(s.elapsed_time(e) for s, e in loop.adam_events) / GAN_TIMED
    adam_host = sum(loop.adam_host) / GAN_TIMED
    ms = statistics.median(step_ms)
    wall, busy, by_class, kernels, _ = profile_steps(lambda: loop.step(data),
                                                     3, GAN_CLASSES)
    other = by_class.get("other", 0.0)
    conv = by_class.get("convolutions", 0.0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    idle = 1 - busy / wall if wall else float("nan")
    print("  (c) %s: %.3f ms a GAN step (D and G, median of %d, no metric), "
          "%.1f images/s (%d real + %d generated a step); profiled: wall "
          "%.3f ms, device busy %.3f ms, idle share %.3f; busy by class: "
          "convolutions %.3f ms, Adam (both fused updates' replays, CUDA "
          "events behind a spin kernel) %.3f ms, BatchNorm/elementwise and "
          "the rest %.3f ms; the two Trainer.step calls' host ms %.3f; peak "
          "memory %.1f MB"
          % (card, ms, GAN_TIMED, GAN_BATCH * 1e3 / ms, GAN_BATCH, GAN_BATCH,
             wall, busy, idle, conv, adam_ms, max(other - adam_ms, 0.0),
             adam_host, peak))
    for us, key, count in kernels[:4]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    st = {"G": loop.g._cached_op.stats(), "D": loop.d._cached_op.stats()}
    fused = {"G": loop.trainer_g._fused_updater.stats(),
             "D": loop.trainer_d._fused_updater.stats()}
    print("  (c) CachedOp graphs %s (training runs op by op under record; "
          "the sample is G's predict graph); fused Adam updates %s (one "
          "signature without the guard, one with it)" % (st, fused))
    if any(s["recaptures"] for s in st.values()) or any(
            f["recaptures"] or f["captures"] != f["signatures"]
            for f in fused.values()):
        fail("(c): a graph was captured again after the first step: %s %s"
             % (st, fused))
    launches = dict(tfa.launches, rtc=rtc.launches["rtc"])
    print("  attention, decode and rtc kernel launches over (a)-(c): %s "
          "(none is on this path); gan phase %.1f s"
          % (launches, time.perf_counter() - t_phase))
    if any(launches.values()):
        fail("gan: the path launched a kernel of the table: %s" % launches)
    return dict(ms=ms, images_s=GAN_BATCH * 1e3 / ms, busy=busy, idle=idle,
                conv=conv, adam=adam_ms, adam_host=adam_host, peak=peak,
                first=first, acc=acc, random=rnd)


# ---------------------------------------------------------------------------
# Phase 21: the operator breadth
# ---------------------------------------------------------------------------

OPS_MODULES = ("elemwise", "reduce", "matrix", "indexing", "init_ops", "nn",
               "linalg", "extra", "detection", "deformable", "control_flow")
OPS_ACT = (8, 1024, 768)            # the LM's activations: elementwise, reduce
OPS_SPD = (64, 128)                 # 64 SPD matrices of 128 x 128: linalg
OPS_TOL = 1e-5                      # max |gpu - cpu| / max |cpu|, fwd and grad
# wider normwise tolerances, with their reasons
OPS_WIDE = {
    # the factorizations' rounding grows with the condition number
    # (cuSOLVER against LAPACK)
    "_linalg_potri": 1e-4, "_linalg_inverse": 1e-4, "_linalg_trsm": 1e-4,
    "_linalg_det": 1e-4, "_linalg_slogdet": 1e-4, "_linalg_gelqf": 1e-4,
    "_linalg_potrf": 1e-4, "_linalg_sumlogdiag": 1e-4,
    # eigenvector gradients divide by eigenvalue gaps (1e-3 apart at 128)
    "_linalg_syevd": 1e-3,
    # CTC runs T log-space steps, each a logaddexp whose CUDA and host
    # exp/log1p round differently
    "_contrib_ctc_loss": 1e-4,
    # lgamma's CUDA and host implementations differ by float32 ulps,
    # which exp turns into relative error
    "gamma": 4e-5, "gammaln": 4e-5,
    # every probability carries the rounding of a 50257-term normalizer
    # (~sqrt(n) float32 ulps, summed in another order on each device)
    "softmax_cross_entropy": 4e-5,
}
OPS_SYNC_OK = ("_linalg_syevd",)    # torch.linalg.eigh reads its info flag
SYM_LM_BATCH = 8
SYM_LM_STEPS = 5                    # (cut from 10: phase 33's time)
SYM_LM_T = 512                      # the forward and greedy checks' window
SYM_LM_PROMPT = 496                 # the greedy check's prompt in that window
SYM_LM_NEW = 16
SYM_LM_ADAM = dict(learning_rate=1e-3)
SYM_LM_ITERS = 10
SYM_LM_CLASSES = (("batch_dot products", ("aten::bmm",)),
                  ("FC products", ("aten::mm", "aten::addmm")))


def _r(rs, shape, lo=None, hi=None):
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return rs.standard_normal(shape).astype(np.float32)


def ops_cases(rs, act, spd, heads, vocab, seq, width):
    """``{op name: [case, ...]}`` for phase 21 (a): each case is ``(arrays,
    attrs, opts)``; ``opts``: ``grad`` (False: forward only), ``exact``
    (outputs bit-equal: indices, counts), ``align`` (a factorization
    whose rows' signs the solver picks). Elementwise and reduce ops run
    at the LM's activations ``act``, the attention ops at one sequence of
    (b)'s (``heads`` x ``seq`` x ``width / heads``), the embedding and
    the loss at its ``vocab``, linalg on ``spd`` SPD matrices.
    ``tests/test_torch_op_registry.py`` runs it at toy sizes on the
    CPU."""
    f32 = np.float32
    dh = width // heads
    A = _r(rs, act)
    B1 = _r(rs, (1,) + act[1:])
    P = _r(rs, act, 0.1, 3.0)
    U = _r(rs, act, -0.9, 0.9)
    T = np.round(_r(rs, act) * 4) / 2              # halves: ties, x.5 values
    T1 = np.round(_r(rs, (1,) + act[1:]) * 4) / 2
    near1 = _r(rs, act, 0.99, 1.01)
    nan = A.copy()
    nan.reshape(-1)[::97] = np.nan
    nan1 = near1.copy()
    nan1.reshape(-1)[::97] = np.nan
    sgn = np.where(_r(rs, (1,) + act[1:]) < 0, -1, 1).astype(f32)
    div = sgn * _r(rs, (1,) + act[1:], 0.5, 2.0)
    img = _r(rs, (8, 16, 32, 32))
    n, m = spd
    M = _r(rs, (n, m, m)) / np.sqrt(m)
    S = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(m, dtype=f32)).astype(f32)
    L = np.linalg.cholesky(S.astype(np.float64)).astype(f32)
    D16 = (S[:, :16, :16] * 2.0).astype(f32)
    # eigenvalues 0.5..4.5 evenly apart: the eigenvectors are well
    # defined (a Wishart matrix's smallest eigenvalues crowd together)
    Q = np.linalg.qr(rs.standard_normal((n, m, m)))[0]
    Sev = ((Q * np.linspace(0.5, 4.5, m)) @ Q.transpose(0, 2, 1)) \
        .astype(f32)
    Bm = _r(rs, (n, m, 32))
    q = _r(rs, (heads, seq, dh))
    k = _r(rs, (heads, seq, dh))
    scores = _r(rs, (heads, seq, seq)) * 4
    ids = rs.randint(0, vocab, (act[0], act[1])).astype(f32)
    logits = np.round(_r(rs, (1, seq // 2, vocab)) * 2) / 2
    ce = _r(rs, (seq, vocab)) * 3
    ce_label = rs.randint(0, vocab, (seq,)).astype(f32)
    ctc = _r(rs, (100, 32, 50)) * 2
    ctc_label = rs.randint(1, 50, (32, 20)).astype(f32)
    ctc_label[:, 15:] = 0
    g, b = _r(rs, act[-1:], 0.5, 1.5), _r(rs, act[-1:])
    g16, b16 = _r(rs, (16,), 0.5, 1.5), _r(rs, (16,))
    seqlen = rs.randint(1, act[0] + 1, act[1]).astype(f32)
    rows = act[1] // 16                             # rows an assignment writes

    def c(arrays, attrs=None, **opts):
        return (list(arrays), dict(attrs or {}), opts)

    cases = {}
    unary = {"abs": A, "sign": T, "ceil": T, "floor": T, "trunc": T,
             "fix": T, "round": T, "rint": T, "square": A, "sqrt": P,
             "exp": A, "log": P, "relu": A, "sigmoid": A, "tanh": A,
             "negative": A, "softsign": A, "_copy": A, "identity": A,
             "zeros_like": A, "ones_like": A, "logical_not": T,
             "log10": P, "log2": P, "log1p": P, "expm1": A, "rsqrt": P,
             "cbrt": A, "rcbrt": P, "sin": A, "cos": A,
             "tan": U, "arcsin": U, "arccos": U, "arctan": A, "sinh": A,
             "cosh": A, "arcsinh": A, "arccosh": P + 1.0, "arctanh": U,
             "degrees": A, "radians": A, "erf": A, "erfinv": U,
             "gamma": P + 0.1, "gammaln": P, "reciprocal": P}
    for name, x in unary.items():
        cases[name] = [c([x])]
    binary = {"broadcast_add": (A, B1), "broadcast_sub": (A, B1),
              "broadcast_mul": (A, B1), "broadcast_div": (A, div),
              "broadcast_power": (P, B1 * 0.5), "broadcast_maximum": (A, B1),
              "broadcast_minimum": (A, B1), "broadcast_mod": (A * 3, div),
              "broadcast_hypot": (A, B1), "_scatter_elemwise_div": (A, P)}
    for name in ("equal", "not_equal", "greater", "greater_equal",
                 "lesser", "lesser_equal", "logical_and", "logical_or",
                 "logical_xor"):
        binary["broadcast_" + name] = (T, T1)
    for name, (x, y) in binary.items():
        cases[name] = [c([x, y])]
    scalar = {"_plus_scalar": (A, 0.5), "_minus_scalar": (A, 0.5),
              "_rminus_scalar": (A, 0.5), "_mul_scalar": (A, -1.5),
              "_div_scalar": (A, 1.5), "_rdiv_scalar": (P, 1.5),
              "_power_scalar": (P, 1.5), "_rpower_scalar": (A, 2.0),
              "_mod_scalar": (A * 3, 0.7), "_rmod_scalar": (P, 2.5),
              "_maximum_scalar": (A, 0.3), "_minimum_scalar": (A, 0.3),
              "_hypot_scalar": (A, 0.3), "_scatter_plus_scalar": (A, 0.5),
              "_scatter_minus_scalar": (A, 0.5)}
    for name in ("equal", "not_equal", "greater", "greater_equal",
                 "lesser", "lesser_equal", "logical_and", "logical_or",
                 "logical_xor"):
        scalar["_%s_scalar" % name] = (T, 0.5)
    for name, (x, s) in scalar.items():
        cases[name] = [c([x], {"scalar": s})]
    cases.update({
        "Cast": [c([A], {"dtype": "float16"})],
        "clip": [c([A], {"a_min": -0.5, "a_max": 0.5})],
        "where": [c([T, A, B1.repeat(act[0], 0)])],
        "smooth_l1": [c([A], {"scalar": 1.5})],
        "BlockGrad": [c([A])],
        "make_loss": [c([A], {"grad_scale": 0.5})],
        "shape_array": [c([A], grad=False, exact=True)],
        "size_array": [c([A], grad=False, exact=True)],
        # reductions
        "sum": [c([A], {"axis": -1}), c([A])],
        "mean": [c([A], {"axis": (0, 1)})],
        "max": [c([A], {"axis": -1})], "min": [c([A], {"axis": 1})],
        "prod": [c([near1], {"axis": -1})],
        "nansum": [c([nan], {"axis": -1})],
        "nanprod": [c([nan1], {"axis": -1})],
        "norm": [c([A], {"axis": -1})],
        "argmax": [c([T], {"axis": -1}, exact=True)],
        "argmin": [c([T], {"axis": 1}, exact=True)],
        "argmax_channel": [c([T], exact=True)],
        "broadcast_to": [c([B1], {"shape": act})],
        "broadcast_axis": [c([A[:, :1]], {"axis": 1, "size": act[1]})],
        "broadcast_like": [c([B1, A])],
        # shapes and products
        "Reshape": [c([A], {"shape": (0, -1)})],
        "Flatten": [c([A])],
        "SliceChannel": [c([A], {"num_outputs": 3, "axis": 2})],
        "Concat": [c([A, A * 2], {"dim": 2, "num_args": 2})],
        "stack": [c([A, B1.repeat(act[0], 0)], {"axis": 1, "num_args": 2})],
        "expand_dims": [c([A], {"axis": 1})],
        "transpose": [c([A], {"axes": (2, 0, 1)})],
        "reverse": [c([A], {"axis": 1})],
        "dot": [c([A[0], _r(rs, (act[-1], act[-1]))])],
        "Pad": [c([img], {"mode": "reflect",
                          "pad_width": (0, 0, 0, 0, 2, 3, 1, 2)})],
        "SwapAxis": [c([A], {"dim1": 0, "dim2": 2})],
        "slice_axis": [c([A], {"axis": 1, "begin": 10, "end": -10})],
        "tile": [c([img[:2]], {"reps": (1, 2, 1, 2)})],
        "reshape_like": [c([A, A.reshape(act[0], -1)])],
        "batch_dot": [c([q, k], {"transpose_b": True}),
                      c([_r(rs, (heads, seq, seq)), k])],
        "slice": [c([A], {"begin": (None, 1000, 5), "end": (None, 0, None),
                          "step": (2, -3, 7)})],
        "slice_like": [c([A, A[:3, :100, :64]], {"axes": (0, 1)})],
        "squeeze": [c([A[:, :1]], {"axis": 1})],
        "repeat": [c([A[:2]], {"repeats": 3, "axis": 1})],
        "diag": [c([A], {"k": 3, "axis1": 1, "axis2": 2})],
        "khatri_rao": [c([_r(rs, (64, 512)), _r(rs, (32, 512))],
                         {"num_args": 2})],
        "depth_to_space": [c([img], {"block_size": 2})],
        "space_to_depth": [c([img], {"block_size": 2})],
        "_rnn_param_concat": [c([A.reshape(-1), B1.reshape(-1)],
                                {"num_args": 2})],
        # indexing and ordering
        "Embedding": [c([ids, _r(rs, (vocab, width))],
                        {"input_dim": vocab, "output_dim": width})],
        "_contrib_SparseEmbedding": [c([ids, _r(rs, (vocab, width))],
                                       {"input_dim": vocab,
                                        "output_dim": width})],
        "_sparse_retain": [c([A[0], rs.permutation(act[1])[:rows]
                              .astype(f32)])],
        "pick": [c([A, rs.randint(0, act[-1], act[:2]).astype(f32)])],
        "gather_nd": [c([A, np.stack([rs.randint(0, n_, 4096) for n_ in
                                      act[:2]]).astype(f32)])],
        "take": [c([A[0], rs.randint(-5, act[1] + 5, (64, 32)).astype(f32)],
                   {"mode": "clip"}),
                 c([A[0], rs.randint(-5, act[1] + 5, (64,)).astype(f32)],
                   {"mode": "wrap"})],
        "batch_take": [c([A[0], rs.randint(0, act[-1], act[1])
                          .astype(f32)])],
        "one_hot": [c([ids[:, :256] % 1000], {"depth": 1000}, grad=False)],
        "topk": [c([logits], {"k": 1, "ret_typ": "both"}, exact=True),
                 c([logits], {"k": 4, "ret_typ": "both"}, exact=True),
                 c([T], {"k": 3, "ret_typ": "mask", "is_ascend": True},
                   exact=True)],
        "sort": [c([T], {"is_ascend": False}, exact=True)],
        "argsort": [c([T], {"is_ascend": False}, exact=True)],
        "scatter_nd": [c([_r(rs, (act[1], act[-1])),
                          rs.permutation(act[1] * 2)[:act[1]][None]
                          .astype(f32)], {"shape": (act[1] * 2, act[-1])})],
        "_getitem": [c([A, np.array([3, 0, 7], np.int32)],
                       {"spec": (("e",), ("s", None, None, -2), ("a",)),
                        "num_arrays": 1})],
        "_contrib_boolean_mask": [c([A[0], (ids[0] % 3 == 0).astype(f32)])],
        "_contrib_index_copy": [c([A[0], rs.permutation(act[1])[:rows]
                                   .astype(f32), _r(rs, (rows, act[-1]))])],
        # creation
        "_zeros": [c([], {"shape": act})], "_ones": [c([], {"shape": act})],
        "_full": [c([], {"shape": act, "value": 0.25})],
        "_arange": [c([], {"start": 0, "stop": seq}),
                    c([], {"start": 0.1, "stop": 7.3, "step": 0.3,
                           "repeat": 2})],
        "_linspace": [c([], {"start": -3, "stop": 7, "num": 1000})],
        "_eye": [c([], {"N": seq, "M": seq // 2, "k": 3})],
        "_contrib_arange_like": [c([A], {"axis": 1})],
        # neural-network ops
        "Activation": [c([A], {"act_type": "relu"})],
        "BatchNorm": [c([img, g16, b16, np.zeros(16, f32),
                         np.ones(16, f32)], {"__train__": True,
                                             "fix_gamma": False})],
        "LayerNorm": [c([A, g, b], {"eps": 1e-5})],
        "InstanceNorm": [c([img, g16, b16])],
        "FullyConnected": [c([A, _r(rs, (act[-1], act[-1])) * 0.05],
                             {"num_hidden": act[-1], "no_bias": True,
                              "flatten": False})],
        "Convolution": [c([img, _r(rs, (32, 16, 3, 3)) * 0.1, _r(rs, (32,))],
                          {"kernel": (3, 3), "num_filter": 32,
                           "pad": (1, 1)})],
        "Deconvolution": [c([img[:, :, :16, :16], _r(rs, (16, 8, 4, 4)) * 0.1],
                            {"kernel": (4, 4), "num_filter": 8,
                             "stride": (2, 2), "pad": (1, 1),
                             "no_bias": True})],
        "Pooling": [c([img], {"kernel": (2, 2), "stride": (2, 2),
                              "pool_type": "max"}),
                    c([img], {"kernel": (3, 3), "stride": (2, 2),
                              "pool_type": "avg", "pad": (1, 1)})],
        "softmax": [c([scores], {"axis": -1})],
        "log_softmax": [c([A], {"axis": -1})],
        "softmin": [c([A], {"axis": -1})],
        "SoftmaxActivation": [c([img], {"mode": "channel"})],
        "SoftmaxOutput": [c([ce[:, :1000], ce_label % 1000],
                            {"normalization": "batch"}),
                          c([ce[:, :1000], ce_label % 1000],
                            {"normalization": "valid"})],
        "SequenceMask": [c([A, seqlen], {"use_sequence_length": True})],
        "SequenceLast": [c([A, seqlen], {"use_sequence_length": True})],
        "SequenceReverse": [c([A, seqlen], {"use_sequence_length": True})],
        "L2Normalization": [c([img], {"mode": "channel"})],
        "LRN": [c([img], {"nsize": 5})],
        "UpSampling": [c([img], {"scale": 2, "num_args": 1}),
                       c([img[:, :, :8, :8]], {"scale": 2,
                                               "sample_type": "bilinear",
                                               "num_args": 1})],
        "softmax_cross_entropy": [c([ce, ce_label])],
        "_contrib_div_sqrt_dim": [c([q])],
        "_contrib_ctc_loss": [c([ctc, ctc_label])],
        "LinearRegressionOutput": [c([A, B1.repeat(act[0], 0)])],
        "LogisticRegressionOutput": [c([A, B1.repeat(act[0], 0)])],
        "MAERegressionOutput": [c([A, B1.repeat(act[0], 0)])],
        # linear algebra
        "_linalg_gemm2": [c([S, Bm], {"alpha": 0.5}),
                          c([S, S], {"transpose_b": True})],
        "_linalg_gemm": [c([S, Bm, Bm], {"beta": -1.0})],
        "_linalg_potrf": [c([S])], "_linalg_potri": [c([L])],
        "_linalg_trsm": [c([L, Bm], {"alpha": 2.0}),
                         c([L, Bm.transpose(0, 2, 1)],
                           {"rightside": True, "transpose": True})],
        "_linalg_trmm": [c([L, Bm], {"lower": True})],
        "_linalg_syrk": [c([Bm], {"alpha": 0.5})],
        "_linalg_sumlogdiag": [c([L])],
        "_linalg_extractdiag": [c([S], {"offset": 1})],
        "_linalg_makediag": [c([Bm[:, :, 0]], {"offset": -1})],
        "_linalg_extracttrian": [c([S], {"offset": -1})],
        "_linalg_gelqf": [c([M], align="gelqf")],
        "_linalg_syevd": [c([Sev], align="syevd")],
        "_linalg_inverse": [c([S])], "_linalg_det": [c([D16])],
        "_linalg_slogdet": [c([S])],
        # the rest
        "Crop": [c([img], {"h_w": (20, 24), "center_crop": True})],
        "_contrib_fft": [c([A.reshape(-1, act[-1])[:2048]])],
        "_contrib_ifft": [c([A.reshape(-1, act[-1])[:2048]])],
        "_contrib_BilinearResize2D": [c([img], {"height": 48, "width": 40}),
                                      c([img], {"height": 20, "width": 13})],
        "_contrib_AdaptiveAvgPooling2D": [c([img], {"output_size": (4, 8)}),
                                          c([img], {"output_size": (5, 7)})],
        "_histogram": [c([A.reshape(-1)[:4096]], {"bin_cnt": 20,
                                                   "range": (-3.0, 3.0)},
                         grad=False, exact=True)],
        "_ravel_multi_index": [c([np.stack([rs.randint(0, 8, 4096),
                                            rs.randint(0, 1024, 4096)])
                                  .astype(f32)], {"shape": (8, 1024)},
                                 grad=False, exact=True)],
        "_unravel_index": [c([rs.randint(0, 8192, 4096).astype(f32)],
                             {"shape": (8, 1024)}, grad=False, exact=True)],
        "hard_sigmoid": [c([A * 3])],
        # the dense bodies of the sparse ops (order step 5)
        "_square_sum": [c([A], {"axis": -1}),
                        c([A], {"axis": (0, 2), "keepdims": True})],
        "_contrib_getnnz": [c([np.where(np.abs(A) < 0.5, 0, A)],
                              {"axis": 1}, grad=False, exact=True)],
        "cast_storage": [c([A], {"stype": "row_sparse"})],
        "add_n": [c([A, A * 2, B1.repeat(act[0], 0)], {"num_args": 3})],
        "_grad_add": [c([A, A * 2])],
        "_identity_with_attr_like_rhs": [c([A, A])],
        "_zeros_without_dtype": [c([], {"shape": act})],
        "_split_v2": [c([A], {"indices": (100, 500), "axis": 1})],
        "_slice_assign": [c([A, _r(rs, (act[0], rows, act[-1]))],
                            {"begin": (None, rows), "end": (None, 2 * rows)})],
        "_slice_assign_scalar": [c([A], {"begin": (None, 900),
                                         "end": (None, 100),
                                         "step": (None, -2),
                                         "scalar": 0.5})],
        "_scatter_set_nd": [c([A[0], rs.permutation(act[1])[:rows][None]
                               .astype(f32), _r(rs, (rows, act[-1]))])],
        "_contrib_quadratic": [c([A], {"a": 0.5, "b": -1.0, "c": 2.0})],
        "_contrib_gradientmultiplier": [c([A], {"scalar": -0.5})],
        "SVMOutput": [c([A[0], rs.randint(0, act[-1], act[1]).astype(f32)],
                        {"margin": 1.0})],
        "IdentityAttachKLSparseReg": [c([A])],
    })
    for v1 in ("BatchNorm", "Convolution", "Pooling"):
        cases[v1 + "_v1"] = cases[v1]
    # no mesh in this phase: the synchronized op is BatchNorm's body
    cases["_contrib_SyncBatchNorm"] = cases["BatchNorm"]
    cases.update(control_flow_cases(rs, act))
    cases.update(vision_cases(rs, act))
    return cases


def control_flow_cases(rs, act):
    """Phase 21 (a)'s cases of ``_foreach``, ``_while_loop`` and ``_cond``
    at the activations ``act``: each node's attributes (its subgraphs as
    their ``__subgraph__:`` JSON, which the op parses) from a graph built
    with ``mx.sym.contrib``. foreach runs a tanh recurrence over dim 0
    with a free weight; while_loop 3 live and 2 masked steps of one;
    cond both ways, the untaken branch a ``sqrt`` at 0."""
    import mxnet_tpu_torch as mx
    sym = mx.sym
    f32 = np.float32
    X = _r(rs, act)
    S = _r(rs, act[1:])
    W = _r(rs, act[-1:])
    w_ = sym.var("w")

    def step(x, st):
        h = sym.tanh(x * w_ + st)
        return h, h
    out, _ = sym.contrib.foreach(step, sym.var("d"), sym.var("s"))
    fe = out.list_attr()
    out, _ = sym.contrib.while_loop(
        lambda i, v: i < 3,
        lambda i, v: (v * w_, [i + 1, sym.tanh(v * w_ + 1)]),
        [sym.var("i"), sym.var("v")], max_iterations=5)
    wl = out.list_attr()
    a = sym.var("a")
    cd = sym.contrib.cond(sym.sum(a) > 0, lambda: a * w_,
                          lambda: sym.sqrt(sym.relu(-a) * 0.0)).list_attr()
    pos = np.abs(S) + 0.1
    return {
        "_foreach": [([X, S, W], fe, {})],
        "_while_loop": [([np.zeros((1,), f32), S, W], wl, {})],
        "_cond": [([pos, pos, W, pos], cd, {}),
                  ([-pos, -pos, W, -pos], cd, {})],
    }


def ops_swept(ops):
    """The distinct registered ops of phase 21 (a), from the port's
    registry: every op whose body lives in one of OPS_MODULES and does
    not draw (the samplers, Dropout and LeakyReLU are phase 20's; a
    control-flow op draws only where its subgraphs do), and the names
    (canonical and aliases) that reach each."""
    names = {}
    for name in ops.list_ops():
        op = ops.get_op(name)
        module = op.forward.__module__.rsplit(".", 1)[-1]
        if module not in OPS_MODULES \
                or (op.needs_rng and module != "control_flow"):
            continue
        names.setdefault(op.name, []).append(name)
    return names


def op_leaves(arrays, device, grad):
    """The inputs as tensors on ``device``; with ``grad`` the float ones
    require gradients."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in arrays]
    return [t.requires_grad_(True) if grad and t.is_floating_point() else t
            for t in ts]


def op_outputs(ops, name, leaves, attrs, device):
    """The op's outputs on ``leaves`` (a graph behind them where the
    leaves require gradients); a nullary op gets ``device`` as its
    ``ctx``."""
    op = ops.get_op(name)
    if not leaves and "ctx" in op.defaults:
        attrs = dict(attrs, ctx="gpu(0)" if device.type == "cuda"
                     else "cpu(0)")
    with torch.set_grad_enabled(any(t.requires_grad for t in leaves)):
        outs, _ = ops.invoke(op, leaves, attrs)
    return list(outs)


def op_grads(outs, leaves, heads):
    """The gradients of the leaves that require them, backward from
    ``heads`` on the outputs (None: not differentiated); zeros where no
    output reaches a leaf."""
    diff = [t for t in leaves if t.requires_grad]
    pairs = [(o, h) for o, h in zip(outs, heads)
             if h is not None and o.requires_grad]
    grads = torch.autograd.grad(
        [o for o, _ in pairs], diff, [h for _, h in pairs],
        allow_unused=True) if pairs else [None] * len(diff)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(diff, grads)]


def _rel_err(got, want):
    """max |got - want| / max |want| over the entries finite in ``want``
    (NaN where the two differ in finiteness)."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("nan")
    if not bool(fin.any()):
        return 0.0
    got, want = got[fin].double(), want[fin].double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def sweep_one(ops, name, case, gen, dev, cpu):
    """(forward error, gradient error, synced) of one case, gpu(0)
    against cpu(): normwise relative errors (0/1 for ``exact`` outputs:
    bit-equal or not) compared on the card, heads drawn from the host
    generator ``gen``; ``synced``: the card's run made the host wait
    (``torch.cuda.set_sync_debug_mode``; its inputs and heads are on the
    card before it starts)."""
    arrays, attrs, opts = case
    grad = opts.get("grad", True)
    c_in = op_leaves(arrays, cpu, grad)
    g_in = [t.detach().to(dev).requires_grad_(t.requires_grad)
            for t in c_in]
    c_outs = op_outputs(ops, name, c_in, attrs, cpu)
    heads = [torch.randn(tuple(o.shape), generator=gen).to(o.dtype)
             if grad and o.requires_grad else None for o in c_outs]
    g_heads = [None if h is None else h.to(dev) for h in heads]

    def on_card():
        outs = op_outputs(ops, name, g_in, attrs, dev)
        return outs, op_grads(outs, g_in, g_heads) if grad else []
    torch.cuda.synchronize()
    synced = False
    torch.cuda.set_sync_debug_mode("error")
    try:
        g_outs, g_grads = on_card()
    except RuntimeError as err:
        if "synchroniz" not in str(err):
            raise
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if synced:
        g_outs, g_grads = on_card()
    c_ref = [o.detach().to(dev) for o in c_outs]
    g_outs = [o.detach() for o in g_outs]
    align = opts.get("align")
    if align:
        # the solver's row signs: align the card's rows to the host's,
        # and take the host's gradient under the heads the aligned rows
        # see (a sign-free comparison)
        k = 1 if align == "gelqf" else 0       # Q's rows, or V's
        s = torch.sign((g_outs[k] * c_ref[k]).sum(-1, keepdim=True))
        s[s == 0] = 1
        sc = s.cpu()
        if align == "gelqf":
            g_outs = [g_outs[0] * s.transpose(-1, -2), g_outs[1] * s]
            heads = [heads[0] * sc.transpose(-1, -2), heads[1] * sc]
        else:
            g_outs = [g_outs[0] * s, g_outs[1]]
            heads = [heads[0] * sc, heads[1]]
    c_grads = op_grads(c_outs, c_in, heads) if grad else []
    fwd = 0.0
    for g, c in zip(g_outs, c_ref):
        if g.dtype != c.dtype or g.shape != c.shape:
            return float("nan"), float("nan"), synced
        if opts.get("exact") or not g.is_floating_point():
            fwd = max(fwd, 0.0 if torch.equal(g, c) else 1.0)
        else:
            fwd = max(fwd, _rel_err(g, c))
    bwd = 0.0
    for g, c in zip(g_grads, c_grads):
        bwd = max(bwd, _rel_err(g, c.to(dev)))
    return fwd, bwd, synced


def _vision_boxes(rs, n, extent, lo, hi):
    """(n, 4) corner boxes inside [0, extent]^2 with sides in [lo, hi)."""
    ctr = rs.uniform(0, extent, (n, 2))
    wh = rs.uniform(lo, hi, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def vision_cases(rs, act):
    """Phase 21 (a)'s cases of the spatial, image, detection and
    deformable ops (order step 8's breadth), sized from the activations
    ``act``: ``act[1]`` boxes or anchors, images of side about
    sqrt(act[1]). The box decoders' offsets are 0 (exp(0) and the anchor
    centres are exact on both devices), so the NMS keep masks, which
    chip_smoke.py phase 30 (a) holds bit for bit, see one box set."""
    f32 = np.float32
    bsz, n = act[0], act[1]
    S = max(4, int(round(math.sqrt(n))))
    C = max(2, act[-1] // 48)
    R = max(4, n // 16)

    def c(arrays, attrs=None, **opts):
        return ([np.asarray(a) for a in arrays], dict(attrs or {}), opts)
    img = _r(rs, (2, C, S, S))
    theta = (np.tile(np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]], f32),
                     (2, 1)) + _r(rs, (2, 6)) * 0.05).astype(f32)
    grid = _r(rs, (2, 2, S, S), -1.1, 1.1)
    hwc = _r(rs, (S, S + 2, 3), 0, 255)
    u8 = rs.randint(0, 256, (S, S + 2, 3)).astype(np.uint8)
    rois = np.concatenate([rs.randint(0, 2, (R, 1)).astype(f32),
                           _vision_boxes(rs, R, 2 * S, 2, S)], 1)
    anchors = _vision_boxes(rs, n, 1.0, 0.05, 0.4)[None]
    label = np.full((bsz, 6, 5), -1, f32)
    for b in range(bsz):
        k = 1 + b % 5
        label[b, :k, 0] = rs.randint(0, 3, k)
        label[b, :k, 1:] = _vision_boxes(rs, k, 1.0, 0.1, 0.5)
    logits = _r(rs, (bsz, 4, n)) * 2
    prob = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(f32)
    rec = np.concatenate([rs.randint(0, 3, (bsz, n, 1)).astype(f32),
                          _r(rs, (bsz, n, 1), 0, 1),
                          _vision_boxes(rs, bsz * n, 1.0, 0.05, 0.4)
                          .reshape(bsz, n, 4)], 2)
    A_, Hf, Wf = 9, S, S + 3
    rpn_cls = _r(rs, (2, 2 * A_, Hf, Wf), 0, 1)
    rpn_box = np.zeros((2, 4 * A_, Hf, Wf), f32)
    im_info = np.array([[Hf * 16, Wf * 16, 1.0], [Hf * 12, Wf * 16, 1.0]], f32)
    rpn = {"rpn_pre_nms_top_n": A_ * Hf * Wf // 2,
           "rpn_post_nms_top_n": max(8, n // 8), "threshold": 0.7,
           "rpn_min_size": 4, "scales": (2.0, 4.0, 8.0),
           "ratios": (0.5, 1.0, 2.0)}
    ps_data = _r(rs, (2, 27, S, S))
    trans = _r(rs, (R, 2, 3, 3)) * 0.5
    ps = {"spatial_scale": 0.5, "output_dim": 3, "pooled_size": 3}
    dps = dict(ps, group_size=3, sample_per_part=2, trans_std=0.1)
    return {
        "GridGenerator": [c([theta], {"target_shape": (S, S + 1)}),
                          c([_r(rs, (2, 2, S, S))],
                            {"transform_type": "warp"})],
        "BilinearSampler": [c([img, grid])],
        "SpatialTransformer": [c([img, theta], {"target_shape": (S, S)})],
        "Correlation": [c([img, _r(rs, img.shape)],
                          {"max_displacement": 2, "kernel_size": 3,
                           "stride2": 2}),
                        c([img, _r(rs, img.shape)],
                          {"max_displacement": 1, "is_multiply": False})],
        "_image_to_tensor": [c([u8], grad=False), c([hwc[None] / 255.0])],
        "_image_normalize": [c([_r(rs, (2, 3, S, S))],
                               {"mean": (0.4, 0.5, 0.6),
                                "std": (0.2, 0.3, 0.25)})],
        "_image_resize": [c([hwc], {"size": (S // 2 + 1, S // 2)}),
                          c([hwc[None]], {"size": (S + 5, S + 3)}),
                          c([u8], {"size": (S // 2 + 1, S + 3)}, grad=False)],
        "_contrib_edge_id": [c([img[0, 0], rs.randint(0, S, n).astype(f32),
                                rs.randint(0, S, n).astype(f32)])],
        "_contrib_MultiBoxPrior": [c([img], {"sizes": (0.2, 0.3),
                                             "ratios": (1.0, 2.0, 0.5),
                                             "clip": True})],
        "_contrib_MultiBoxTarget": [c([anchors, label, prob])],
        "_contrib_MultiBoxDetection": [
            c([prob, np.zeros((bsz, 4 * n), f32), anchors],
              {"nms_threshold": 0.45}),
            c([prob, np.zeros((bsz, 4 * n), f32), anchors],
              {"force_suppress": True, "nms_topk": 20})],
        "_contrib_box_iou": [c([anchors[0], rec[0, :n // 2, 2:]]),
                             c([anchors[0], rec[0, :n // 2, 2:]],
                               {"format": "center"})],
        "_contrib_box_nms": [c([rec], {"overlap_thresh": 0.5}),
                             c([rec], {"id_index": 0, "valid_thresh": 0.2,
                                       "topk": 10}),
                             c([rec], {"id_index": 0,
                                       "force_suppress": True}),
                             c([rec], {"in_format": "center"})],
        "_contrib_bipartite_matching": [c([_r(rs, (bsz, 6, n // 4))],
                                          {"threshold": 0.1}, grad=False,
                                          exact=True)],
        "_contrib_ROIAlign": [c([img, rois], {"pooled_size": (3, 3),
                                              "spatial_scale": 0.5,
                                              "sample_ratio": 2})],
        "ROIPooling": [c([img, rois], {"pooled_size": (3, 3),
                                       "spatial_scale": 0.5})],
        "_contrib_DeformableConvolution": [
            c([img[:1], _r(rs, (1, 36, S, S)),
               _r(rs, (C, C, 3, 3)) * 0.3],
              {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2),
               "num_filter": C, "num_deformable_group": 2,
               "no_bias": True})],
        "_contrib_PSROIPooling": [c([ps_data, rois], ps)],
        "_contrib_DeformablePSROIPooling": [
            c([ps_data, rois, trans], dps),
            c([ps_data, rois], dict(dps, no_trans=True))],
        "_contrib_Proposal": [c([rpn_cls[:1], rpn_box[:1], im_info[:1]],
                                rpn)],
        "_contrib_MultiProposal": [c([rpn_cls, rpn_box, im_info],
                                     dict(rpn, output_score=True))],
        "_contrib_count_sketch": [c([_r(rs, act[:2]),
                                     rs.randint(0, 64, act[1]).astype(f32),
                                     rs.choice([-1.0, 1.0], act[1])
                                     .astype(f32)], {"out_dim": 64})],
    }


def ops_sweep(card, dev=None):
    """(a): every registered op of OPS_MODULES on gpu(0) against cpu()
    (the reference's ``check_consistency``): forward and gradient, the
    ties of the ordering ops bit-equal; and no op makes the host wait
    for the card (but OPS_SYNC_OK, whose torch call reads a status
    flag)."""
    from mxnet_tpu_torch import ops
    t0 = time.perf_counter()
    dev, cpu = dev or torch.device("cuda", 0), torch.device("cpu")
    rs = np.random.RandomState(21)
    gen = torch.Generator().manual_seed(21)
    cfg = GPT2_SMALL
    cases = ops_cases(rs, OPS_ACT, OPS_SPD, cfg["n_heads"], cfg["vocab"],
                      cfg["max_len"], cfg["n_heads"] * cfg["head_dim"])
    swept = ops_swept(ops)
    missing = sorted(set(swept) - set(cases))
    if missing:
        fail("(a): no sweep case for %s" % missing)
    rows, bad, synced = [], [], []
    for name in sorted(swept):
        tol = OPS_WIDE.get(name, OPS_TOL)
        for case in cases[name]:
            fwd, bwd, sync = sweep_one(ops, name, case, gen, dev, cpu)
            exact = case[2].get("exact")
            rows.append((max(fwd / tol if not exact else fwd, bwd / tol)
                         if fwd == fwd and bwd == bwd else float("inf"),
                         name, fwd, bwd, tol))
            if not (fwd <= (0.0 if exact else tol) and bwd <= tol):
                bad.append((name, fwd, bwd, tol))
            if sync:
                synced.append(name)
    n_names = sum(len(v) for v in swept.values())
    print("  (a) consistency sweep (%s): %d op names (%d distinct ops of %s) "
          "in %d cases, gpu(0) against cpu(), forward and gradient, "
          "normwise relative error max|gpu-cpu|/max|cpu| against %g (wider "
          "where stated), indices and counts bit-equal; %.1f s"
          % (card, n_names, len(swept), "/".join(OPS_MODULES), len(rows),
             OPS_TOL, time.perf_counter() - t0))
    for ratio, name, fwd, bwd, tol in sorted(rows, reverse=True)[:10]:
        print("    %-32s fwd %.3g grad %.3g (tolerance %g)"
              % (name, fwd, bwd, tol))
    print("  (a) ops whose GPU run made the host wait: %s (allowed: %s)"
          % (synced or "none", list(OPS_SYNC_OK)))
    if bad:
        fail("(a): gpu(0) and cpu() differ beyond tolerance: %s" % bad[:8])
    if set(synced) - set(OPS_SYNC_OK):
        fail("(a): ops read the card from the host: %s"
             % sorted(set(synced) - set(OPS_SYNC_OK)))
    return dict(names=n_names, ops=len(swept), cases=len(rows),
                worst=sorted(rows, reverse=True)[:10], synced=synced,
                s=time.perf_counter() - t0)


def sym_lm(mx, vocab, n_layers, n_heads, head_dim, d_ff, seq, batch=1,
           train=True):
    """ToyDecoderLM's function written as an MXNet 1.5 user wrote a
    decoder in ``mx.sym``: pre-LN, ReLU, no biases; attention by
    ``batch_dot`` over heads folded into the batch, the query scaled by
    ``_contrib_div_sqrt_dim``, a causal mask from ``_arange``,
    ``broadcast_lesser_equal`` and ``broadcast_like``, ``softmax``. The
    training symbol is ``MakeLoss`` of ``softmax_cross_entropy`` (summed,
    its gradient scaled to the mean by ``grad_scale``); the predict
    symbol gives the logits and the greedy token, ``topk`` under
    ``BlockGrad``. Variables: ``data``/``label`` (B, ``seq``) token ids,
    and :func:`sym_lm_args`' names."""
    S = mx.sym
    d = n_heads * head_dim
    data = S.var("data")
    pos = S.arange(0, seq, name="positions")
    h = S.Embedding(data, S.var("embed_weight"), input_dim=vocab,
                    output_dim=d, name="embed")
    p = S.expand_dims(S.Embedding(pos, S.var("pos_weight"), input_dim=seq,
                                  output_dim=d, name="pos"), axis=0)
    h = h + S.broadcast_like(p, h)
    row = S.reshape(pos, shape=(seq, 1))
    col = S.reshape(pos, shape=(1, seq))
    allowed = S.broadcast_lesser_equal(col, row)       # (seq, seq) 0/1
    bias = S.expand_dims((allowed - 1.0) * 1e9, axis=0)

    def heads(x):           # (B, T, d) -> (B*H, T, Dh)
        x = S.reshape(x, shape=(0, 0, n_heads, head_dim))
        return S.reshape(S.transpose(x, axes=(0, 2, 1, 3)), shape=(-3, 0, 0))

    for i in range(n_layers):
        pre = "l%d_" % i

        def fc(x, name, units):
            return S.FullyConnected(x, S.var(pre + name + "_weight"),
                                    num_hidden=units, no_bias=True,
                                    flatten=False, name=pre + name)
        x = S.LayerNorm(h, S.var(pre + "att_gamma"), S.var(pre + "att_beta"),
                        eps=1e-5, name=pre + "att_ln")
        q = S._contrib_div_sqrt_dim(heads(fc(x, "wq", d)))
        k, v = heads(fc(x, "wk", d)), heads(fc(x, "wv", d))
        att = S.batch_dot(q, k, transpose_b=True, name=pre + "scores")
        att = att + S.broadcast_like(bias, att)
        att = S.batch_dot(S.softmax(att, axis=-1), v, name=pre + "context")
        att = S.reshape(S.transpose(S.reshape(att, shape=(-4, -1, n_heads,
                                                          0, 0)),
                                    axes=(0, 2, 1, 3)), shape=(0, 0, -3))
        h = h + fc(att, "wo", d)
        x = S.LayerNorm(h, S.var(pre + "ffn_gamma"), S.var(pre + "ffn_beta"),
                        eps=1e-5, name=pre + "ffn_ln")
        h = h + fc(S.relu(fc(x, "w1", d_ff)), "w2", d)
    h = S.LayerNorm(h, S.var("out_gamma"), S.var("out_beta"), eps=1e-5,
                    name="out_ln")
    logits = S.FullyConnected(h, S.var("head_weight"), num_hidden=vocab,
                              no_bias=True, flatten=False, name="head")
    if not train:
        return S.Group([logits, S.BlockGrad(S.topk(logits, axis=-1, k=1))])
    label = S.var("label")
    ce = S.softmax_cross_entropy(S.reshape(logits, shape=(-1, vocab)),
                                 S.reshape(label, shape=(-1,)))
    return S.MakeLoss(ce, grad_scale=1.0 / (batch * seq), name="loss")


def sym_lm_args(params, n_layers):
    """``{argument name: numpy array}`` for :func:`sym_lm` from a
    ToyDecoderLM flat parameter dict (numpy or tensors): FullyConnected
    holds each ``x @ W`` matrix transposed."""
    def a(x):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        return np.ascontiguousarray(x, dtype=np.float32)
    out = {"embed_weight": a(params["embed"]),
           "pos_weight": a(params["pos"]),
           "out_gamma": a(params["out_g"]), "out_beta": a(params["out_b"]),
           "head_weight": a(params["wout"]).T.copy()}
    for i in range(n_layers):
        src, pre = "l%d." % i, "l%d_" % i
        out.update({pre + "att_gamma": a(params[src + "att_g"]),
                    pre + "att_beta": a(params[src + "att_b"]),
                    pre + "ffn_gamma": a(params[src + "ffn_g"]),
                    pre + "ffn_beta": a(params[src + "ffn_b"])})
        for w in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[pre + w + "_weight"] = a(params[src + w]).T.copy()
    return out


def sym_lm_forward(mx, model, params, card, tfa):
    """(b) 1-2: the predict symbol at B1 T512 bound on gpu(0) with the
    weights of ``params``: its logits against ``ToyDecoderLM.prefill``
    (the flash_fwd route) on the same weights and tokens, then 16 greedy
    tokens, each the symbol's ``topk`` at the prompt's end in a fixed
    T512 window, against the model's prefill + decode stream. Returns
    (max logit error, tokens equal, the launch counts of the symbol's
    run)."""
    seq = SYM_LM_T
    cfg = GPT2_SMALL
    sym = sym_lm(mx, cfg["vocab"], cfg["n_layers"], cfg["n_heads"],
                 cfg["head_dim"], cfg["d_ff"], seq, train=False)
    ctx = mx.gpu(0)
    dev = ctx.torch_device()
    args = {k: mx.nd.array(v, ctx=ctx)
            for k, v in sym_lm_args(params, cfg["n_layers"]).items()}
    g = torch.Generator(device="cpu").manual_seed(21)
    prompt = torch.randint(0, cfg["vocab"], (1, SYM_LM_PROMPT), generator=g)
    window = torch.zeros(1, seq, dtype=torch.float32)
    window[0, :SYM_LM_PROMPT] = prompt[0].float()
    args["data"] = mx.nd.array(window.numpy(), ctx=ctx)
    ex = sym.bind(ctx, args, grad_req="null")
    tfa.reset_launches()
    from mxnet_tpu_torch import rtc
    rtc.reset_launches()
    t0 = time.perf_counter()
    ex.forward(is_train=False)
    logits = ex.outputs[0]._data.clone()
    toks, plen = [], SYM_LM_PROMPT
    for _ in range(SYM_LM_NEW):
        ex.forward(is_train=False, data=mx.nd.array(window.numpy(), ctx=ctx))
        nxt = int(ex.outputs[1]._data[0, plen - 1, 0])
        toks.append(nxt)
        window[0, plen] = nxt
        plen += 1
    torch.cuda.synchronize()
    sym_s = time.perf_counter() - t0
    launches = dict(tfa.launches, rtc=rtc.launches["rtc"])
    graphs = ex.stats()
    # the reference: ToyDecoderLM on the same weights (flash_fwd route),
    # outside the counted window
    with torch.no_grad():
        ref, kk, vv = model.prefill(params, window[:, :SYM_LM_PROMPT].long()
                                    .to(dev))
        err = float((logits[:, :SYM_LM_PROMPT] - ref).abs().max())
        L, H, Dh = model.n_layers, model.n_heads, model.head_dim
        P = SYM_LM_PROMPT
        kc = torch.zeros(L, 1, P + SYM_LM_NEW, H, Dh, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :, :P], vc[:, :, :P] = kk, vv
        last = ref[0, P - 1]
        want, gaps = [], []
        for i in range(SYM_LM_NEW):
            tok = int(torch.argmax(last))
            want.append(tok)
            gaps.append(top2_margin(last))
            pos = torch.tensor([P + i], device=dev)
            out, nk, nv = model.decode(params, torch.tensor([tok],
                                                            device=dev),
                                       pos, kc, vc)
            kc[:, :, P + i], vc[:, :, P + i] = nk, nv
            last = out[0]
    scale = float(ref.abs().max())
    print("  (b) predict symbol at B1 T%d (%s): logits against "
          "ToyDecoderLM.prefill (flash_fwd) on the same weights: max abs "
          "error %.3g (tolerance %g, max |logit| %.3g); %d greedy tokens "
          "by the symbol's topk in a fixed T%d window (%.2f s with the "
          "first forward): %s; the model's stream %s; executor graphs %s"
          % (seq, card, err, LOGIT_ATOL, scale, SYM_LM_NEW, seq, sym_s,
             toks, want, graphs))
    if not err <= LOGIT_ATOL:
        fail("(b): the symbol's logits differ from ToyDecoderLM.prefill by "
             "%g" % err)
    first = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
                 None)
    if first is not None:
        print("  (b) the streams part at token %d: top-2 logit gap there "
              "%.3g" % (first, gaps[first]))
        if not gaps[first] < LOGIT_ATOL:
            fail("(b): greedy token %d differs (%d vs %d) with a top-2 gap "
                 "%g above the logits' tolerance"
                 % (first, toks[first], want[first], gaps[first]))
    del ex, args, logits, ref
    return err, first is None, launches


def sym_lm_module(mx, args_np, fused):
    """A Module over the training symbol at batch SYM_LM_BATCH x 1024 on
    gpu(0) with the given weights and Adam."""
    cfg = GPT2_SMALL
    T = cfg["max_len"]
    sym = sym_lm(mx, cfg["vocab"], cfg["n_layers"], cfg["n_heads"],
                 cfg["head_dim"], cfg["d_ff"], T, batch=SYM_LM_BATCH)
    with fused_gate(fused):
        mod = mx.mod.Module(sym, data_names=("data",), label_names=("label",),
                            context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (SYM_LM_BATCH, T))],
                 label_shapes=[("label", (SYM_LM_BATCH, T))])
        mod.set_params({k: mx.nd.array(v, ctx=mx.gpu(0))
                        for k, v in args_np.items()}, {})
        mod.init_optimizer(optimizer="adam",
                           optimizer_params=dict(SYM_LM_ADAM,
                                                 rescale_grad=1.0))
    return mod


def sym_lm_train(mx, params, card, tfa):
    """(b) 3-5: ``Module.fit`` over an NDArrayIter of synthetic tokens
    (B8 x 1024, SYM_LM_STEPS steps) on the fused step; the first step
    fused against eager from the same weights; ms a step, tokens/s, busy
    by class, the idle share and peak memory."""
    from mxnet_tpu_torch import profiler, rtc
    cfg = GPT2_SMALL
    T, V = cfg["max_len"], cfg["vocab"]
    B = SYM_LM_BATCH
    args_np = sym_lm_args(params, cfg["n_layers"])
    rs = np.random.RandomState(21)
    # synthetic tokens: a random walk over a window of the vocabulary,
    # so the next token is predictable from the current one
    span = min(2048, V // 2)
    steps = rs.randint(-3, 4, (B * SYM_LM_STEPS, T + 1))
    toks = (np.cumsum(steps, axis=1) % span + rs.randint(
        0, V - span, (B * SYM_LM_STEPS, 1))).astype(np.float32)
    x, y = toks[:, :T], toks[:, 1:]
    feed = mx.io.DataBatch(data=[mx.nd.array(x[:B], ctx=mx.gpu(0))],
                           label=[mx.nd.array(y[:B], ctx=mx.gpu(0))])
    # the first step, fused against eager from the same weights, held
    # as phase 14 holds a Module step to a Gluon step
    ends, loss = {}, {}
    for fused in (True, False):
        with fused_gate(fused):
            mod = sym_lm_module(mx, args_np, fused)
            mod.forward_backward(feed)
            mod.update()
            loss[fused] = float(mod.get_outputs()[0]._data) / (B * T)
            ends[fused] = {n: t.clone() for n, t in param_tensors(mod).items()}
            del mod
            torch.cuda.empty_cache()
    same, worst, bad = 0, 0.0, []
    for n, t in ends[True].items():
        if torch.equal(t, ends[False][n]):
            same += 1
            continue
        step = torch.from_numpy(args_np[n]).to(t.device) - ends[False][n]
        err = float((t - ends[False][n]).abs().max()) \
            / (float(step.abs().max()) or 1.0)
        worst = max(worst, err)
        if not err <= MODULE_STEP_REL:
            bad.append(n)
    loss_ok = abs(loss[True] - loss[False]) <= MODULE_TOL["atol"] \
        + MODULE_TOL["rtol"] * abs(loss[False])
    print("  (b) one fused step against one eager step (MXNET_FUSED_STEP=0) "
          "from the same weights and batch: loss %.6f vs %.6f; %d of %d "
          "arrays bit-identical, the worst weight step error %.3g of its "
          "largest entry (tolerance %g, as phase 14)"
          % (loss[True], loss[False], same, len(ends[True]), worst,
             MODULE_STEP_REL))
    if bad or not loss_ok:
        fail("(b): the fused step differs from the eager step: %s, loss %s"
             % (bad[:4], loss))
    del ends
    # Module.fit: SYM_LM_STEPS fused steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod = sym_lm_module(mx, args_np, True)
    it = mx.io.NDArrayIter(x, y, batch_size=B, data_name="data",
                           label_name="label")
    losses = []
    fb0 = profiler.counters().get("fused_step_fallbacks", 0)
    tfa.reset_launches()
    rtc.reset_launches()

    def watch(param):
        losses.append(mod.get_outputs()[0]._data.reshape(()) / (B * T))
    t0 = time.perf_counter()
    with fused_gate(True):
        mod.fit(it, num_epoch=1, eval_metric=mx.metric.Loss(),
                batch_end_callback=[watch], optimizer="adam",
                optimizer_params=dict(SYM_LM_ADAM, rescale_grad=1.0))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(tfa.launches, rtc=rtc.launches["rtc"])
        stats = mod._fused.stats() if mod._fused else None
        fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - fb0
        losses = [float(v) for v in losses]
        print("  (b) Module.fit (%s): GPT-2-small width in mx.sym, B%d x "
              "T%d, Adam lr %g, %d steps in %.2f s on the fused step; loss "
              "a token by step %s; fused graphs %s, fallbacks %d"
              % (card, B, T, SYM_LM_ADAM["learning_rate"], len(losses),
                 fit_s, " ".join("%.4f" % v for v in losses), stats,
                 fallbacks))
        if len(losses) != SYM_LM_STEPS or not all(np.isfinite(losses)) \
                or not losses[-1] < losses[0]:
            fail("(b): the fit's loss did not fall: %s" % losses)
        if stats is None or (stats["captures"], stats["recaptures"]) \
                != (1, 0) or fallbacks:
            fail("(b): fused graphs %s, fallbacks %d" % (stats, fallbacks))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        feed = mx.io.DataBatch(data=[mx.nd.array(x[:B], ctx=mx.gpu(0))],
                               label=[mx.nd.array(y[:B], ctx=mx.gpu(0))])

        def step():
            mod.forward_backward(feed)
            mod.update()
        ms = wall_ms(step, iters=SYM_LM_ITERS)
        wall, busy, _, kernels, _ = profile_steps(step, 3, classes=())
    # the products by class from the eager step, where torch's ops name
    # the work (a graph replay shows only kernels); the rest is the
    # fused step's busy time less those
    with fused_gate(False):
        eager = sym_lm_module(mx, args_np, False)

        def eager_step():
            eager.forward_backward(feed)
            eager.update()
        eager_step()
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eager_step()
            torch.cuda.synchronize()
        by_class = {cls: sum(e.device_time_total
                             for e in prof.key_averages()
                             if e.key in keys) / 1e3
                    for cls, keys in SYM_LM_CLASSES}
        by_class["softmax/mask/elementwise and the rest"] = \
            busy - sum(by_class.values())
        del eager
    idle = 1 - busy / wall if wall else float("nan")
    print("  (b) %s: %.3f ms a fused step (median of %d, no metric), %.0f "
          "tokens/s; profiled: wall %.3f ms, busy %.3f ms, idle share %.3f; "
          "busy by class (the products from the eager step's ops): %s; "
          "peak memory %.2f GiB; phase 10's Gluon LM step at this width "
          "(flash attention) read 173.8 ms"
          % (card, ms, SYM_LM_ITERS, B * T * 1e3 / ms, wall, busy, idle,
             ", ".join("%s %.3f ms" % kv for kv in by_class.items()),
             peak))
    for us, key, count in kernels[:4]:
        print("    top: %.3f ms in %d calls  %s"
              % (us / 1e3 / 3, count // 3, key[:70]))
    del mod
    torch.cuda.empty_cache()
    return dict(ms=ms, tokens_s=B * T * 1e3 / ms, busy=busy, idle=idle,
                by_class=by_class, peak=peak, losses=losses,
                launches=launches)


def phase_ops(card):
    """Phase 21: the seventeenth slice, the operator breadth. (a) the
    consistency sweep of every registered op of OPS_MODULES, gpu(0)
    against cpu(); (b) ToyDecoderLM's GPT-2-small-width decoder written
    in ``mx.sym`` with the slice's ops (``sym_lm``), on ToyDecoderLM's
    ``init_params(seed=0)`` weights: its logits and greedy tokens held to
    ToyDecoderLM's, then ``Module.fit`` on the fused step. fp32, TF32
    off. No kernel of the table is on this path: the attention, decode
    and rtc launch counts, zeroed before (b)'s symbol runs and read
    after, must read 0."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import ToyDecoderLM
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sweep = ops_sweep(card, mx.gpu(0).torch_device())
    model = ToyDecoderLM(**GPT2_SMALL)
    params = model.init_params(seed=0, device=mx.gpu(0).torch_device())
    err, same, fwd_launches = sym_lm_forward(mx, model, params, card, tfa)
    print("  (b) forward done at %.1f s of the phase"
          % (time.perf_counter() - t_phase))
    train = sym_lm_train(mx, params, card, tfa)
    del params, model
    torch.cuda.empty_cache()
    launches = {k: fwd_launches[k] + train["launches"][k]
                for k in fwd_launches}
    print("  attention, decode and rtc kernel launches over (b)'s symbol "
          "runs: %s (none is on this path); ops phase %.1f s"
          % (launches, time.perf_counter() - t_phase))
    if any(launches.values()):
        fail("ops: the path launched a kernel of the table: %s" % launches)
    return dict(sweep=sweep, logit_err=err, greedy_equal=same, **train)


# ---------------------------------------------------------------------------
# Phase 22: the kvstore
# ---------------------------------------------------------------------------

# BASELINE config 5 (ResNet CIFAR-10, kvstore=dist_sync): Gluon's
# resnet18_v1 at 10 classes on 3x32x32 images (tools/bandwidth.py's own
# CIFAR defaults), 64 images a rank a step on 2 ranks, SGD as the
# reference's example/distributed_training trains it; cut in steps only
KV_RANKS = 2
KV_BATCH = 64
KV_STEPS = 12                       # (cut from 20: phase 33's time)
KV_TIMED = 4                        # the medians read steps 5-12
KV_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
KV_SEED = 0
# BASELINE config 1's MLP (examples/train_mnist_module.py) through
# Module.fit on 2 ranks x 50 for 10 steps against one process at batch
# 100: the ranks' gradient is two cuBLAS sums of 50 where the one process
# takes one of 100, carried through 10 SGD steps with momentum 0.9
KV_MLP_BATCH = 50
KV_MLP_STEPS = 10
KV_MLP_SGD = dict(learning_rate=0.01, momentum=0.9)
KV_MLP_TOL = dict(rtol=1e-4, atol=1e-6)
KV_BAND_ROUNDS = 5
KV_SHAPE = (2, 3)
KV_LAUNCH_TIMEOUT = 300


def kv_cifar(n, seed=KV_SEED):
    """examples/train_gluon_cnn.py's synthetic_cifar (its generator, here
    without the JAX package): ten colour prototypes plus noise."""
    rng = np.random.RandomState(seed)
    protos = rng.normal(0, 1.5, (10, 3, 1, 1)).astype(np.float32)
    y = rng.randint(0, 10, n)
    x = protos[y] + rng.normal(0, 0.8, (n, 3, 32, 32)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def kv_rank_batches(mx, rank):
    """Rank ``rank``'s half of every global batch of KV_RANKS x KV_BATCH
    images, placed on gpu(0) ahead of the steps."""
    x, y = kv_cifar(KV_STEPS * KV_RANKS * KV_BATCH)
    x = x.reshape(KV_STEPS, KV_RANKS, KV_BATCH, 3, 32, 32)
    y = y.reshape(KV_STEPS, KV_RANKS, KV_BATCH)
    ctx = mx.gpu(0)
    return [(mx.nd.array(x[s, rank], ctx=ctx), mx.nd.array(y[s, rank],
                                                              ctx=ctx))
            for s in range(KV_STEPS)]


def kv_mlp_data():
    """examples/train_mnist_module.py's synthetic MNIST generator for
    KV_MLP_STEPS global batches, and Xavier-like initial weights."""
    rng = np.random.RandomState(KV_SEED)
    n = KV_MLP_STEPS * KV_RANKS * KV_MLP_BATCH
    protos = rng.normal(0, 2.5, (10, 784)).astype(np.float32)
    y = rng.randint(0, 10, n)
    x = ((protos[y] + rng.normal(0, 1.0, (n, 784))) / 3.0).astype(np.float32)
    init = {}
    for name, (fan_in, width) in (("fc1", (784, 128)), ("fc2", (128, 64)),
                                  ("fc3", (64, 10))):
        bound = math.sqrt(6.0 / (fan_in + width))
        init[name + "_weight"] = rng.uniform(
            -bound, bound, (width, fan_in)).astype(np.float32)
        init[name + "_bias"] = np.zeros(width, np.float32)
    return x, y.astype(np.float32), init


def kv_mlp_fit(mx, x, y, batch, init, kvstore):
    """examples/train_mnist_module.py's symbol through Module.fit on
    gpu(0), one epoch, in order; the module."""
    sym = mx.sym.var("data")
    for i, width in enumerate((128, 64, 10)):
        sym = mx.sym.FullyConnected(sym, num_hidden=width,
                                    name="fc%d" % (i + 1))
        if width != 10:
            sym = mx.sym.Activation(sym, act_type="relu")
    sym = mx.sym.SoftmaxOutput(sym, name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False,
                           label_name="softmax_label")
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.fit(it, arg_params={k: mx.nd.array(v) for k, v in init.items()},
            aux_params={}, optimizer="sgd", optimizer_params=KV_MLP_SGD,
            kvstore=kvstore, num_epoch=1)
    return mod


def kv_resnet(mx, init=None):
    """resnet18_v1(classes=10) on gpu(0), Xavier, its parameters set to
    ``init`` (a list in ``collect_params`` order) when given, hybridized;
    (net, parameter list)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 3, 32, 32), ctx=mx.gpu(0)))
    params = list(net.collect_params().values())
    if init is not None:
        for p, v in zip(params, init):
            p.set_data(mx.nd.array(v, ctx=mx.gpu(0)))
    net.hybridize()
    return net, params


def kv_host(params):
    """Host copies of the parameters' values."""
    return [p.data()._data.detach().cpu().numpy().copy() for p in params]


def kv_rank_train(mx, net, params, batches, overlap):
    """KV_STEPS Trainer(kvstore='dist_sync') steps of the global batch on
    this rank's half: each step's ms split into forward + backward (host
    clock to a synchronize), ``sync`` (the kvstore exchange's telemetry
    span) and the update (the rest of ``step``, to a synchronize)."""
    from mxnet_tpu_torch import autograd, gluon, profiler, telemetry
    os.environ["MXNET_GRAD_OVERLAP"] = "1" if overlap else "0"
    buckets0 = profiler.counters().get("grad_sync_kvstore_buckets", 0)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(KV_SGD),
                            kvstore="dist_sync")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    telemetry.reset()
    telemetry.start(run_id="kvstore")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, losses, prev = [], [], {}
    for x, y in batches:
        telemetry.step_begin()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.step(KV_RANKS * KV_BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phases = telemetry.report()["phases_ms"]
        sync = phases.get("sync", 0.0) - prev.get("sync", 0.0)
        prev = phases
        rows.append(((t2 - t0) * 1e3, (t1 - t0) * 1e3, sync,
                     (t2 - t1) * 1e3 - sync))
        losses.append(loss._data.detach().mean())
    telemetry.stop()
    telemetry.reset()
    os.environ.pop("MXNET_GRAD_OVERLAP", None)
    grad_bytes = sum(p.grad()._data.numel() * 4 for p in params
                     if p.grad_req != "null")
    med = [statistics.median(r[i] for r in rows[KV_TIMED:])
           for i in range(4)]
    return dict(
        step_ms=med[0], fb_ms=med[1], sync_ms=med[2], update_ms=med[3],
        images_s=KV_RANKS * KV_BATCH * 1e3 / med[0],
        exchange_gbs=2 * grad_bytes * KV_RANKS / (med[2] / 1e3) / 1e9,
        grad_bytes=grad_bytes, grads=sum(p.grad_req != "null"
                                         for p in params),
        peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
        losses=[float(v) for v in torch.stack(losses).cpu()],
        graphs=trainer._fused_updater.stats(), kv=trainer._kvstore.stats(),
        buckets=(profiler.counters().get("grad_sync_kvstore_buckets", 0)
                 - buckets0) // KV_STEPS)


def kv_rank_dense(mx, kv, rank, say):
    """(b): tests/test_dist_kvstore.py's dense assertions (34-67) on
    gpu(0) arrays, a barrier, a planned push fault on every rank retried
    to the same bytes, and dist_async's one warning."""
    from mxnet_tpu_torch import fault
    nw = kv.num_workers
    shape, big_shape = (3, 3), (50, 4)
    kv.init(3, mx.nd.ones(shape))
    kv.init(99, mx.nd.ones(big_shape))
    kv.push(3, mx.nd.ones(shape) * (rank + 1))
    out = mx.nd.zeros(shape)
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), sum(r + 1 for r in range(nw)))
    for it in range(3):
        kv.push(99, mx.nd.ones(big_shape) * (it + rank))
        out = mx.nd.zeros(big_shape)
        kv.pull(99, out=out)
        assert np.allclose(out.asnumpy(), sum(it + r for r in range(nw)))
    kv.init(7, mx.nd.zeros(shape))
    kv.push(7, mx.nd.array(np.arange(9, dtype=np.float32).reshape(shape)
                           * (rank + 1)))
    out = mx.nd.zeros(shape)
    kv.pull(7, out=out)
    assert np.allclose(out.asnumpy(), np.arange(9).reshape(shape)
                       * sum(r + 1 for r in range(nw)))
    t0 = time.perf_counter()
    kv.barrier()
    barrier_ms = (time.perf_counter() - t0) * 1e3
    x = mx.nd.array(np.random.RandomState(rank).randn(64, 257)
                    .astype(np.float32))
    kv.init(11, mx.nd.zeros(x.shape))
    kv.push(11, x)
    base = mx.nd.zeros(x.shape)
    kv.pull(11, out=base)
    fault.set_plan("push:step=1:raise")
    try:
        kv.push(11, x)
        again = mx.nd.zeros(x.shape)
        kv.pull(11, out=again)
        stats = fault.stats()
    finally:
        fault.set_plan(None)
    assert stats["injected"]["push"] == 1 and stats["retries"] >= 1, stats
    assert bool((again._data == base._data).all()), "retry changed bytes"
    from mxnet_tpu_torch import kvstore as kvs
    warned = []
    handler = logging.Handler()
    handler.emit = lambda rec: warned.append(rec.getMessage())
    logging.getLogger().addHandler(handler)
    try:
        kvs._DIST_ASYNC_WARNED = False
        mx.kv.create("dist_async")
        mx.kv.create("dist_async")
    finally:
        logging.getLogger().removeHandler(handler)
    hits = [m for m in warned if "dist_async" in m]
    assert len(hits) == 1 and "degrades to synchronous" in hits[0], hits
    say("(b) rank %d: dense assertions of tests/test_dist_kvstore.py "
        "passed over %d workers; barrier %.3f ms; a planned push fault "
        "retried (%d retries) to the same bytes; dist_async warned once"
        % (rank, nw, barrier_ms, stats["retries"]))
    return dict(barrier_ms=barrier_ms, retries=stats["retries"])


def kv_rank_band(mx, kv, rank):
    """(e) on the ranks: KV_BAND_ROUNDS rounds of dist_sync push + pull
    over ResNet-18's weight shapes (tools/bandwidth.py's, on gpu(0));
    GB/s with the reference's accounting, the sums checked after."""
    from mxnet_tpu_torch.tools import bandwidth
    shapes = bandwidth._layer_shapes("resnet18_v1", 10, (3, 32, 32))
    vals = [mx.nd.ones(s) * (rank + 1) for s in shapes]
    outs = [mx.nd.zeros(s) for s in shapes]
    for i, s in enumerate(shapes):
        kv.init("band%d" % i, mx.nd.zeros(s))
    total = sum(int(np.prod(s)) * 4 for s in shapes)
    times = []
    for _ in range(KV_BAND_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(shapes)):
            kv.push("band%d" % i, vals[i])
            kv.pull("band%d" % i, out=outs[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    want = sum(r + 1 for r in range(kv.num_workers))
    errors = sum(not bool((o._data == want).all()) for o in outs)
    return dict(keys=len(shapes), bytes=total, errors=errors,
                gbs=[2 * total * kv.num_workers / t / 1e9 for t in times],
                ms=[t * 1e3 for t in times])


def kv_rank_main(outdir):
    """One rank of phase 22, spawned by ``python -m mxnet_tpu_torch.tools.
    launch -n 2`` (``chip_smoke.py kv-rank DIR``): importing the package
    joins the launcher's process group. Runs (b)-(e) on gpu(0) and
    writes its readings to DIR/rank<r>.json, its weights to npz files and
    its log to DIR/rank<r>.log; any failure is written there and exits
    1."""
    import traceback
    rank = int(os.environ["DMLC_WORKER_ID"])
    log = open(os.path.join(outdir, "rank%d.log" % rank), "w")

    def say(line):
        log.write(line + "\n")
        log.flush()
        print(line, flush=True)
    res = {"rank": rank}
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import rtc
        tfa = importlib.import_module(
            "mxnet_tpu_torch.parallel.flash_attention")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        tfa.reset_launches()
        rtc.reset_launches()
        kv = mx.kv.create("dist_sync")
        res.update(kv.stats())
        say("rank %d of %d joined: backend %s, device %s"
            % (rank, kv.num_workers, res["backend"],
               torch.cuda.get_device_name(0)))
        res["b"] = kv_rank_dense(mx, kv, rank, say)
        batches = kv_rank_batches(mx, rank)
        np.random.seed(KV_SEED)
        mx.random.seed(KV_SEED)
        net, params = kv_resnet(mx)
        init = kv_host(params)
        res["trainable"] = [i for i, p in enumerate(params)
                            if p.grad_req != "null"]
        if rank == 0:
            np.savez(os.path.join(outdir, "init.npz"), *init)
        res["c"] = {}
        for name, overlap in (("per_key", False), ("overlap", True)):
            if overlap:
                net, params = kv_resnet(mx, init)
            res["c"][name] = kv_rank_train(mx, net, params, batches, overlap)
            np.savez(os.path.join(outdir, "rank%d_%s.npz" % (rank, name)),
                     *kv_host(params))
            r = res["c"][name]
            say("(c) rank %d, %s: %.3f ms a step (fwd+bwd %.3f, sync %.3f, "
                "update %.3f), loss %.4f -> %.4f, update graph %s"
                % (rank, name, r["step_ms"], r["fb_ms"], r["sync_ms"],
                   r["update_ms"], r["losses"][0], r["losses"][-1],
                   r["graphs"]))
        del net, params, batches
        torch.cuda.empty_cache()
        x, y, init = kv_mlp_data()
        glob = x.reshape(KV_MLP_STEPS, KV_RANKS, KV_MLP_BATCH, 784)
        gy = y.reshape(KV_MLP_STEPS, KV_RANKS, KV_MLP_BATCH)
        mod = kv_mlp_fit(mx, glob[:, rank].reshape(-1, 784),
                         gy[:, rank].reshape(-1), KV_MLP_BATCH, init,
                         "dist_sync")
        args, _ = mod.get_params()
        np.savez(os.path.join(outdir, "rank%d_mlp.npz" % rank),
                 **{k: v.asnumpy() for k, v in args.items()})
        res["d"] = dict(update_on_kvstore=bool(mod._update_on_kvstore),
                        rescale=mod._optimizer.rescale_grad,
                        kv=mod._kvstore.stats())
        res["e"] = kv_rank_band(mx, kv, rank)
        kv.barrier()
        res["launches"] = dict(tfa.launches, rtc=rtc.launches["rtc"])
        say("rank %d done" % rank)
    except BaseException:                        # noqa: BLE001
        res["error"] = traceback.format_exc()
        say(res["error"])
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    log.close()
    return 1 if "error" in res else 0


def kv_single_process(mx):
    """(a): the single-process stores on the card, every call under
    ``set_sync_debug_mode("error")``: list pushes of per-context copies
    (device and local), exact sums pulled into the destinations' own
    tensors, an updater accumulating over pushes, 2-bit compression held
    to its plain formula over three pushes."""
    ctx = mx.gpu(0)
    rs = np.random.RandomState(KV_SEED)
    parts = [rs.randn(256, 1024).astype(np.float32) for _ in range(4)]
    grads = [(rs.randn(512, 512) * 0.4).astype(np.float32)
             for _ in range(3)]
    copies = [mx.nd.array(p, ctx=ctx) for p in parts]
    outs = {t: [mx.nd.zeros(parts[0].shape, ctx=ctx) for _ in range(2)]
            for t in ("device", "local")}
    ptrs = {t: [o._data.data_ptr() for o in v] for t, v in outs.items()}
    acc_out = mx.nd.zeros(parts[0].shape, ctx=ctx)
    g_nd = [mx.nd.array(g, ctx=ctx) for g in grads]
    q_outs = [mx.nd.zeros(grads[0].shape, ctx=ctx) for _ in grads]
    zeros = mx.nd.zeros(parts[0].shape, ctx=ctx)
    torch.cuda.synchronize()
    stores = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in ("device", "local"):
            kv = stores[t] = mx.kv.create(t)
            kv.init("w", zeros)
            kv.push("w", copies)
            kv.pull("w", out=outs[t])
        acc = mx.kv.create("local")

        def updater(key, pushed, stored):
            stored += pushed
        acc.set_updater(updater)
        acc.init(0, zeros)
        for _ in range(3):
            acc.push(0, copies[:2])
        acc.pull(0, out=acc_out)
        comp = mx.kv.create("device")
        comp.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        comp.init(0, mx.nd.zeros(grads[0].shape, ctx=ctx))
        for g, o in zip(g_nd, q_outs):
            comp.push(0, g)
            comp.pull(0, out=o)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    for t in ("device", "local"):
        if [o._data.data_ptr() for o in outs[t]] != ptrs[t]:
            fail("(a) %s: a pull replaced a destination's tensor" % t)
        for o in outs[t]:
            if not np.array_equal(o.asnumpy(), want):
                fail("(a) %s: the pulled sum differs from the list-order "
                     "sum" % t)
    if not np.array_equal(acc_out.asnumpy(),
                          3 * (parts[0] + parts[1])):
        fail("(a) the updater's accumulation is wrong")
    res = np.zeros(grads[0].shape, np.float32)
    for g, o in zip(grads, q_outs):
        x = g + res
        q = np.where(x >= 0.5, 0.5, np.where(x <= -0.5, -0.5, 0.0)) \
            .astype(np.float32)
        res = (x - q).astype(np.float32)
        if not np.array_equal(o.asnumpy(), q):
            fail("(a) 2-bit compression differs from its plain formula")
    if not np.array_equal(comp._compression._residual[0].cpu().numpy(),
                          res):
        fail("(a) the 2-bit residual differs from its plain formula")
    print("  (a) device and local stores on gpu(0) under "
          "set_sync_debug_mode('error'): a list push of %d copies of "
          "%s pulled as the exact list-order sum into the destinations' "
          "own tensors; an updater's 3 accumulated pushes exact; 2-bit "
          "compression and its residual over 3 pushes bit-equal to the "
          "plain formula" % (len(parts), parts[0].shape))


def kv_launch(outdir, role="kv-rank", n=KV_RANKS,
              timeout=KV_LAUNCH_TIMEOUT, env=None):
    """Runs the ranks: ``python -m mxnet_tpu_torch.tools.launch -n N``
    over ``chip_smoke.py <role> DIR`` from the checkout (``env``: more
    variables for the ranks); their readings. A failing rank fails the
    phase with its last lines."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), sys.executable, os.path.abspath(__file__), role, outdir]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                              text=True, timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = "timeout", exc.stdout or "", exc.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    secs = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        path = os.path.join(outdir, "rank%d.json" % r)
        ranks.append(json.load(open(path)) if os.path.exists(path)
                     else {"error": "rank %d wrote no result" % r})
    if rc != 0 or any("error" in r for r in ranks):
        for r in range(n):
            path = os.path.join(outdir, "rank%d.log" % r)
            tail = open(path).read()[-3000:] if os.path.exists(path) else ""
            print("  rank %d's last lines:\n%s%s"
                  % (r, tail, ranks[r].get("error", "")))
        print("  launcher stderr:\n%s" % err[-3000:])
        fail("kvstore: the launched ranks failed (launcher exit %s)" % rc)
    for line in out.splitlines():
        print("    " + line)
    return ranks, secs


def kv_twin(mx, init):
    """The two-replica twin of (c): two ResNet-18s on gpu(0) from the
    ranks' initial weights, each fed its rank's half, the gradients
    summed in rank order into the first replica's, one fused SGD update
    of the global batch, its weights copied to the second (each keeps
    its own BatchNorm statistics, as each rank does)."""
    from mxnet_tpu_torch import autograd, gluon
    reps = [kv_resnet(mx, init) for _ in range(KV_RANKS)]
    batches = [kv_rank_batches(mx, r) for r in range(KV_RANKS)]
    trainer = gluon.Trainer(reps[0][0].collect_params(), "sgd",
                            dict(KV_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(KV_STEPS):
        for (net, _), rank_batches in zip(reps, batches):
            x, y = rank_batches[s]
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
        with torch.no_grad():
            for pa, pb in zip(reps[0][1], reps[1][1]):
                if pa.grad_req != "null":
                    pa.grad()._data.add_(pb.grad()._data)
        trainer.step(KV_RANKS * KV_BATCH)
        for pa, pb in zip(reps[0][1], reps[1][1]):
            if pa.grad_req != "null":
                pb.set_data(pa.data())
    return kv_host(reps[0][1])


def kv_npz(outdir, name):
    with np.load(os.path.join(outdir, name)) as f:
        return [f["arr_%d" % i] for i in range(len(f.files))]


def phase_kv(card):
    """Phase 22: the eighteenth slice, the kvstore. (a) the single-process
    stores on gpu(0) under ``set_sync_debug_mode("error")``; then two
    ranks, separate processes under ``python -m mxnet_tpu_torch.tools.
    launch -n 2``, both on gpu(0) (the one card: the process group is
    gloo's, which stages CUDA tensors through the host), run (b) the
    dense dist_sync assertions, (c) BASELINE config 5 (resnet18_v1 at 10
    classes, 3x32x32, 64 images a rank, 12 steps, once per key and once
    bucketed), (d) config 1's MLP through ``Module.fit`` and (e) a
    dist_sync push + pull round over ResNet-18's shapes; this process
    holds them to (c)'s two-replica twin, (d)'s one-process fit at the
    summed batch and runs ``tools.bandwidth.measure`` on a ``device``
    store. fp32, TF32 off, deterministic cuDNN. No kernel of the table
    is on this path: its launch counts, zeroed before, must read 0 in
    this process and on every rank."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.tools import bandwidth
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tfa.reset_launches()
    rtc.reset_launches()
    kv_single_process(mx)
    outdir = tempfile.mkdtemp(prefix="kv_ranks_")
    try:
        ranks, launch_s = kv_launch(outdir)
        print("  (b)-(e) ranks: %d processes on %s, backend %s, %.1f s of "
              "launch" % (len(ranks), card, ranks[0]["backend"], launch_s))
        init = kv_npz(outdir, "init.npz")
        finals = {(r, name): kv_npz(outdir, "rank%d_%s.npz" % (r, name))
                  for r in range(KV_RANKS) for name in ("per_key", "overlap")}
        mlps = [dict(np.load(os.path.join(outdir, "rank%d_mlp.npz" % r)))
                for r in range(KV_RANKS)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    # (c): across ranks (the trainable parameters: each rank's BatchNorm
    # keeps its own moving statistics), across the two exchanges (every
    # array), against the twin (every array)
    trainable = ranks[0]["trainable"]
    for name in ("per_key", "overlap"):
        if any(not np.array_equal(finals[(0, name)][i], finals[(1, name)][i])
               for i in trainable):
            fail("(c) %s: the ranks' parameters differ" % name)
    for r in range(KV_RANKS):
        if any(not np.array_equal(a, b) for a, b in
               zip(finals[(r, "per_key")], finals[(r, "overlap")])):
            fail("(c) rank %d: the bucketed exchange's arrays differ from "
                 "the per-key loop's" % r)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        twin = kv_twin(mx, init)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    diff = [float(np.abs(a - b).max()) for a, b in
            zip(finals[(0, "per_key")], twin)]
    same = all(np.array_equal(a, b)
               for a, b in zip(finals[(0, "per_key")], twin))
    print("  (c) after %d steps: the two ranks' %d parameters "
          "bit-identical, per key and bucketed; each rank's %d arrays "
          "(BatchNorm statistics included) bit-identical across the two "
          "exchanges; rank 0's against the two-replica twin in this "
          "process: bit-identical %s (max |diff| %.3g)"
          % (KV_STEPS, len(trainable), len(twin), same, max(diff)))
    if not same:
        fail("(c): rank 0's weights differ from the twin's (max |diff| %g)"
             % max(diff))
    for r, rank in enumerate(ranks):
        for name, c in rank["c"].items():
            g = c["graphs"]
            print("  (c) rank %d, %s exchange: %.3f ms a step (median of "
                  "steps %d-%d): forward + backward %.3f, sync %.3f, update "
                  "%.3f; %.1f images/s over both ranks; exchange %.3f GB/s "
                  "(2 x %.1f MB x %d ranks / sync; %d gradient arrays, %s "
                  "buckets a step); peak memory %.1f MB; update graph captures %d, "
                  "recaptures %d; loss %.4f -> %.4f; %s"
                  % (r, name, c["step_ms"], KV_TIMED + 1, KV_STEPS,
                     c["fb_ms"], c["sync_ms"], c["update_ms"], c["images_s"],
                     c["exchange_gbs"], c["grad_bytes"] / 1e6, KV_RANKS,
                     c["grads"], c["buckets"] or "no", c["peak_mb"],
                     g["captures"], g["recaptures"], c["losses"][0],
                     c["losses"][-1], card))
            if g["captures"] != 1 or g["recaptures"] != 0:
                fail("(c) rank %d %s: the update graph was captured again: "
                     "%s" % (r, name, g))
            early = np.mean(c["losses"][:5])
            late = np.mean(c["losses"][-5:])
            if not late < early:
                fail("(c) rank %d %s: the loss did not fall (%.4f -> %.4f)"
                     % (r, name, early, late))
    # (d): the MLP against one process at the summed batch
    x, y, init_mlp = kv_mlp_data()
    one = kv_mlp_fit(mx, x, y, KV_RANKS * KV_MLP_BATCH, init_mlp, "local")
    args, _ = one.get_params()
    worst = 0.0
    for k, v in args.items():
        want = v.asnumpy()
        if not np.array_equal(mlps[0][k], mlps[1][k]):
            fail("(d): the ranks' %s differ" % k)
        err = np.abs(mlps[0][k] - want)
        worst = max(worst, float(err.max()))
        if not (err <= KV_MLP_TOL["atol"]
                + KV_MLP_TOL["rtol"] * np.abs(want)).all():
            fail("(d): %s off the one-process fit by %g" % (k, err.max()))
    d = ranks[0]["d"]
    print("  (d) config 1's MLP through Module.fit(kvstore='dist_sync'), %d "
          "ranks x %d for %d steps: update_on_kvstore %s, rescale_grad %g; "
          "the ranks bit-identical; against one process at batch %d: max "
          "|diff| %.3g (held to rtol %g, atol %g)"
          % (KV_RANKS, KV_MLP_BATCH, KV_MLP_STEPS, d["update_on_kvstore"],
             d["rescale"], KV_RANKS * KV_MLP_BATCH, worst,
             KV_MLP_TOL["rtol"], KV_MLP_TOL["atol"]))
    if not d["update_on_kvstore"]:
        fail("(d): _create_kvstore did not update on the dist store")
    # (e): bandwidth, one process on a device store and two ranks
    with mx.gpu(0):
        shapes = bandwidth._layer_shapes("resnet18_v1", 10, (3, 32, 32))
        rows = bandwidth.measure(shapes, kv_type="device", num_workers=2,
                                 num_batches=KV_BAND_ROUNDS)
    if any(r["error"] for r in rows):
        fail("(e): tools.bandwidth.measure found wrong sums: %s" % rows)
    local_gbs = statistics.median(r["bandwidth_gbps"] for r in rows)
    e = ranks[0]["e"]
    if any(rank["e"]["errors"] for rank in ranks):
        fail("(e): the two-rank round's sums are wrong")
    dist_gbs = statistics.median(e["gbs"])
    print("  (e) KVStore push + pull bandwidth over ResNet-18's %d weight "
          "arrays (%.1f MB), reference accounting 2 x bytes x workers / s, "
          "%s: tools.bandwidth.measure, 'device' store, 2 worker copies in "
          "one process on gpu(0): %.3f GB/s (median of %d rounds, sums "
          "checked); dist_sync over 2 ranks on the one card, process to "
          "process through gloo: %.3f GB/s (median of %d rounds, %.3f ms a "
          "round; sums checked). The second is a one-card figure, not a "
          "multi-card NVLink one."
          % (e["keys"], e["bytes"] / 1e6, card, local_gbs, len(rows),
             dist_gbs, KV_BAND_ROUNDS, statistics.median(e["ms"])))
    launches = dict(tfa.launches, rtc=rtc.launches["rtc"])
    rank_launches = [rank["launches"] for rank in ranks]
    print("  attention, decode and rtc kernel launches over phase 22: %s in "
          "this process, %s on the ranks (none is on this path); kvstore "
          "phase %.1f s" % (launches, rank_launches,
                            time.perf_counter() - t_phase))
    if any(launches.values()) or any(any(r.values()) for r in rank_launches):
        fail("kvstore: the path launched a kernel of the table")
    return dict(ranks=ranks, local_gbs=local_gbs, dist_gbs=dist_gbs,
                mlp_err=worst)


# ---------------------------------------------------------------------------
# Phase 23: sparse storage
# ---------------------------------------------------------------------------

# BASELINE config 4 ("example/sparse: factorization-machine") at MXNet
# v1.5 example/sparse/factorization_machine's defaults (--input-size
# 2000000 --factor-size 16 --batch-size 1000) on Criteo-shaped rows: 39
# features a row, 13 numeric and 26 categorical fields, each field's ids
# from its own range of the 2M, drawn skewed (Zipf) so hot ids repeat;
# a synthetic libsvm file from seed 0, as Criteo is not in the
# repository; cut in rows (50,000 = 50 batches; 100,000 before phase
# 33's time) and epochs (2) only
FM_FEATURES = 2000000
FM_FACTOR = 16
FM_BATCH = 1000
FM_NUMERIC = 13
FM_CATEGORICAL = 26
FM_NUMERIC_IDS = 1024               # a numeric field's value buckets
FM_ZIPF = 1.2
FM_ROWS = 50000
FM_EPOCHS = 2
FM_ADAM = dict(learning_rate=0.02)
FM_SEED = 0
FM_TOL = dict(rtol=1e-5, atol=1e-5)
FM_LAZY_WD = 0.01
FM_CSR_COLS = 65536                 # the dense <-> csr cast's width
FM_PROFILE_STEPS = 5
FM_PUSHES = 5
FM_STAGES = ("fm:forward", "fm:backward", "fm:row_set", "fm:lazy_update")


def fm_rows(n, seed=FM_SEED):
    """(ids (n, 39) int64, values (n, 39) float32, labels (n,) float32):
    field f's ids lie in its own range, ascending with f, so a row's ids
    are distinct and sorted; a numeric field's value is a log-scaled
    count, a categorical one's 1; labels from a hidden linear model of
    the features."""
    rs = np.random.RandomState(seed)
    n_fields = FM_NUMERIC + FM_CATEGORICAL
    cat = (FM_FEATURES - FM_NUMERIC * FM_NUMERIC_IDS) // FM_CATEGORICAL
    sizes = [FM_NUMERIC_IDS] * FM_NUMERIC + [cat] * FM_CATEGORICAL
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ids = np.empty((n, n_fields), np.int64)
    for f, (start, size) in enumerate(zip(starts, sizes)):
        ids[:, f] = start + (rs.zipf(FM_ZIPF, n) - 1) % size
    vals = np.ones((n, n_fields), np.float32)
    vals[:, :FM_NUMERIC] = (np.log1p(rs.geometric(0.05, (n, FM_NUMERIC)))
                            / 5).astype(np.float32)
    true_w = rs.normal(0, 0.5, FM_FEATURES).astype(np.float32)
    logit = (true_w[ids] * vals).sum(1) - 0.5
    y = (rs.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return ids, vals, y


def fm_write_libsvm(path, ids, vals, y):
    fmt = "%d" + " %d:%.6g" * ids.shape[1] + "\n"
    cols = np.empty((ids.shape[0], 2 * ids.shape[1]), object)
    cols[:, 0::2] = ids
    cols[:, 1::2] = vals
    with open(path, "w") as f:
        for label, row in zip(y, cols):
            f.write(fmt % ((int(label),) + tuple(row)))


def fm_net(mx, ctx):
    """tests/test_sparse.py:302-314's FM at config 4's widths: two
    ``nn.Embedding(sparse_grad=True)`` (w: 2M x 1, v: 2M x 16) and the
    pairwise term, eager (the row stash needs NDArray lookups), Normal
    (0.05) from ``mx.random.seed(FM_SEED)``."""
    nn = mx.gluon.nn

    class FM(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = nn.Embedding(FM_FEATURES, 1, sparse_grad=True)
                self.v = nn.Embedding(FM_FEATURES, FM_FACTOR,
                                      sparse_grad=True)

        def hybrid_forward(self, F, idx, vals):
            linear = (F.squeeze(self.w(idx), axis=2) * vals).sum(1)
            vx = self.v(idx) * vals.expand_dims(2)
            s1 = vx.sum(1) ** 2
            s2 = (vx ** 2).sum(1)
            return linear + 0.5 * (s1 - s2).sum(1)

    mx.random.seed(FM_SEED)
    net = FM()
    net.initialize(mx.init.Normal(0.05), ctx=ctx)
    return net


def fm_inputs(mx, csr):
    """The FM's (ids, values) of a csr batch whose rows hold 39 entries
    each: its index and value arrays as (rows, 39), on its device."""
    n = csr.shape[0]
    return (mx.nd.NDArray(csr.indices._data.reshape(n, -1)),
            mx.nd.NDArray(csr.data._data.reshape(n, -1)))


def fm_step(mx, net, trainer, loss_fn, batch, total=None):
    """One training step of the FM on a LibSVMIter batch; the loss's sum
    is added on the device to ``total``."""
    from torch.profiler import record_function
    idx, vals = fm_inputs(mx, batch.data[0])
    with record_function("fm:forward"):
        with mx.autograd.record():
            loss = loss_fn(net(idx, vals), batch.label[0])
    with record_function("fm:backward"):
        loss.backward()
    trainer.step(FM_BATCH)
    if total is not None:
        total.add_(loss._data.detach().sum())
    return loss


@contextlib.contextmanager
def fm_stage_ranges(mx):
    """The Trainer's row set and lazy update, each under a profiler
    range (``fm:row_set``, ``fm:lazy_update``), while profiling."""
    from torch.profiler import record_function
    from mxnet_tpu_torch.optimizer import optimizer as opt_mod
    trainer_cls = mx.gluon.Trainer
    to_rsp, lazy = trainer_cls._to_row_sparse, opt_mod._lazy_row_update

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper
    trainer_cls._to_row_sparse = staticmethod(ranged("fm:row_set", to_rsp))
    opt_mod._lazy_row_update = ranged("fm:lazy_update", lazy)
    try:
        yield
    finally:
        trainer_cls._to_row_sparse = staticmethod(to_rsp)
        opt_mod._lazy_row_update = lazy


def count_syncs(fn):
    """(``fn()``, the host syncs it made): the calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own one-time notice ("a prototype feature ...") is no
    # sync
    return out, sum(1 for w in caught if "synchroniz" in str(w.message)
                    and "prototype" not in str(w.message))


def sparse_hold(what, got, want, tol=FM_TOL):
    """Fail unless card result ``got`` equals host result ``want`` (index
    arrays bit for bit, values within ``tol``); their max abs error."""
    def parts(x):
        if getattr(x, "stype", "default") == "csr":
            return [("indptr", x.indptr), ("indices", x.indices),
                    ("data", x.data)]
        if getattr(x, "stype", "default") == "row_sparse":
            return [("indices", x.indices), ("data", x.data)]
        return [("data", x)]
    if got.stype != want.stype or got.shape != want.shape:
        fail("(a) %s: %s %s on the card, %s %s on the host"
             % (what, got.stype, got.shape, want.stype, want.shape))
    err = 0.0
    for (name, g), (_, w) in zip(parts(got), parts(want)):
        g, w = g.asnumpy(), w.asnumpy()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail("(a) %s: %s is %s %s on the card, %s %s on the host"
                 % (what, name, g.dtype, g.shape, w.dtype, w.shape))
        if name != "data" or not np.issubdtype(g.dtype, np.floating):
            if not np.array_equal(g, w):
                fail("(a) %s: %s differs from the host's" % (what, name))
            continue
        if g.size:
            err = max(err, float(np.abs(g - w).max()))
        if not np.allclose(g, w, **tol):
            fail("(a) %s: values off the host's by %g" % (what, err))
    return err


def fm_csr(mx, ids, vals, ctx, cols=FM_FEATURES):
    n, k = ids.shape
    return mx.nd.sparse.csr_matrix(
        (vals.reshape(-1), ids.reshape(-1) % cols,
         np.arange(0, n * k + 1, k)), shape=(n, cols), ctx=ctx)


def sparse_primitives(mx, ids, vals, card):
    """(a): the sparse primitives at the FM's shapes, each on gpu(0)
    against the same call on the host from the same inputs (fp32, TF32
    off, FM_TOL), with its host syncs; ``dot``'s per-call ms (CUDA
    events) beside ``torch.sparse.mm`` on the same matrix (a yardstick
    only) and its bound."""
    sp = mx.nd.sparse
    gpu, cpu = mx.gpu(0), mx.cpu()
    rs = np.random.RandomState(FM_SEED + 1)
    B = FM_BATCH
    csr = fm_csr(mx, ids[:B], vals[:B], gpu)
    csr2 = fm_csr(mx, ids[B:2 * B], vals[B:2 * B], gpu)
    V = rs.standard_normal((FM_FEATURES, FM_FACTOR)).astype(np.float32)
    G = rs.standard_normal((B, FM_FACTOR)).astype(np.float32)
    rows = np.unique(ids[:B])
    D = np.zeros((FM_FEATURES, FM_FACTOR), np.float32)
    D[rows] = rs.standard_normal((rows.size, FM_FACTOR))
    X = fm_csr(mx, ids[:B], vals[:B], cpu, FM_CSR_COLS).asnumpy()
    keep = rows[::2]

    def cases(ctx, c, c2):
        # every input is on ``ctx`` before a case runs: a case's host
        # syncs are its own
        v = mx.nd.array(V, ctx=ctx)
        v0 = v[:, 0]
        g = mx.nd.array(G, ctx=ctx)
        d = mx.nd.array(D, ctx=ctx)
        r = d.tostype("row_sparse")
        x = mx.nd.array(X, ctx=ctx)
        xc = x.tostype("csr")
        k = mx.nd.array(keep, ctx=ctx, dtype="int32")
        return [
            ("dot(csr, V)", lambda: sp.dot(c, v)),
            ("dot(csr, G, transpose_a)",
             lambda: sp.dot(c, g, transpose_a=True)),
            ("dot(csr, V[:, 0])", lambda: sp.dot(c, v0)),
            ("cast_storage(dense -> row_sparse)",
             lambda: d.tostype("row_sparse")),
            ("cast_storage(row_sparse -> dense)",
             lambda: r.tostype("default")),
            ("cast_storage(dense -> csr), %d columns" % FM_CSR_COLS,
             lambda: x.tostype("csr")),
            ("cast_storage(csr -> dense), %d columns" % FM_CSR_COLS,
             lambda: xc.tostype("default")),
            ("retain(row_sparse, half its rows)", lambda: sp.retain(r, k)),
            ("csr + csr", lambda: c + c2),
            ("_square_sum(V, axis=1)",
             lambda: mx.nd._square_sum(v, axis=1)),
            ("getnnz(dense, axis=1)",
             lambda: mx.nd.contrib.getnnz(x, axis=1)),
        ]
    host = cases(cpu, csr.copyto(cpu), csr2.copyto(cpu))
    rows_out = []
    for (what, fn), (_, host_fn) in zip(cases(gpu, csr, csr2), host):
        got, syncs = count_syncs(fn)
        err = sparse_hold(what, got, host_fn())
        rows_out.append((what, syncs, err))
    back = sp.cast_storage(mx.nd.array(D, ctx=gpu), "row_sparse") \
        .tostype("default")
    if not np.array_equal(back.asnumpy(), D):
        fail("(a) dense -> row_sparse -> dense is not the identity")
    for what, syncs, err in rows_out:
        print("  (a) %-44s card = host (max |err| %.3g), %d host sync%s"
              % (what, err, syncs, "" if syncs == 1 else "s"))
    v = mx.nd.array(V, ctx=gpu)
    ours = call_ms(lambda: sp.dot(csr, v))
    tcsr = torch.sparse_csr_tensor(
        csr.indptr._data.long(), csr.indices._data.long(), csr.data._data,
        size=csr.shape, check_invariants=False)
    lib = call_ms(lambda: torch.sparse.mm(tcsr, v._data))
    if not torch.allclose(torch.sparse.mm(tcsr, v._data),
                          sp.dot(csr, v)._data, **FM_TOL):
        fail("(a) torch.sparse.mm disagrees with sparse.dot")
    nnz = csr.data.shape[0]
    nbytes = nnz * (4 + 4 + FM_FACTOR * 4) + (B + 1) * 4 \
        + B * FM_FACTOR * 4
    bound = max(nbytes / PEAK_BYTES, 2 * nnz * FM_FACTOR
                / PEAK_FP32_FLOPS) * 1e3
    print("  (a) dot(csr %dx%d, %d stored, V %dx%d): %.4f ms a call "
          "(CUDA events; gather + index_add_), torch.sparse.mm %.4f ms "
          "(yardstick), bound %.4f ms (bytes: each stored value, its "
          "column id and V row read once, the output written once); %s"
          % (B, FM_FEATURES, nnz, FM_FEATURES, FM_FACTOR, ours, lib, bound,
             card))
    return dict(primitives=rows_out, dot_ms=ours, dot_lib_ms=lib,
                dot_bound_ms=bound)


LAZY_OPTS = (("sgd", dict(momentum=0.9)), ("adam", {}), ("adagrad", {}),
             ("ftrl", {}))


def lazy_optimizers(mx, ids, card):
    """(b): the four lazy optimizers at (2M, 16) on one batch's touched
    rows, on gpu(0) against the host from the same inputs: untouched
    rows and states bit-identical to their start, touched rows within
    FM_TOL of the host; ``lazy_update=False`` densifies (SGD, Adam).
    Then Adam's lazy update taken apart (gather, the update op on the
    block, scatter) against the dense update of the whole table."""
    sp = mx.nd.sparse
    gpu, cpu = mx.gpu(0), mx.cpu()
    rs = np.random.RandomState(FM_SEED + 2)
    W0 = (rs.standard_normal((FM_FEATURES, FM_FACTOR)) * 0.05) \
        .astype(np.float32)
    rows = np.unique(ids[:FM_BATCH])
    g = rs.standard_normal((rows.size, FM_FACTOR)).astype(np.float32)
    untouched = np.ones(FM_FEATURES, bool)
    untouched[rows] = False

    def run(name, kwargs, ctx, lazy=True):
        extra = {} if name in ("adagrad", "ftrl") else {"lazy_update": lazy}
        opt = mx.optimizer.create(name, learning_rate=0.1, wd=FM_LAZY_WD,
                                  **dict(kwargs, **extra))
        w = mx.nd.array(W0, ctx=ctx)
        state = opt.create_state(0, w)
        grad = sp.row_sparse_array((mx.nd.array(g, ctx=ctx),
                                    mx.nd.array(rows, ctx=ctx,
                                                dtype="int32")),
                                   shape=(FM_FEATURES, FM_FACTOR), ctx=ctx)
        opt.update(0, w, grad, state)
        states = state if isinstance(state, tuple) else (state,)
        return w.asnumpy(), [s.asnumpy() for s in states if s is not None]
    worst = 0.0
    for name, kwargs in LAZY_OPTS:
        (w, states), (hw, hstates) = (run(name, kwargs, gpu),
                                      run(name, kwargs, cpu))
        if not np.array_equal(w[untouched], W0[untouched]):
            fail("(b) %s: an untouched row moved" % name)
        if any(s[untouched].any() for s in states):
            fail("(b) %s: an untouched row's state moved" % name)
        for a, b in zip([w] + states, [hw] + hstates):
            err = float(np.abs(a[rows] - b[rows]).max())
            worst = max(worst, err)
            if not np.allclose(a[rows], b[rows], **FM_TOL):
                fail("(b) %s: touched rows off the host's by %g"
                     % (name, err))
    for name, kwargs in LAZY_OPTS[:2]:
        w, _ = run(name, kwargs, gpu, lazy=False)
        if not (w[untouched] != W0[untouched]).any(axis=1).all():
            fail("(b) %s lazy_update=False: an untouched row kept its "
                 "value (the update did not densify)" % name)
    print("  (b) SGD (momentum 0.9), Adam, AdaGrad, Ftrl on (%d, %d) with "
          "%d touched rows (wd %g): untouched rows and states bit-identical "
          "to their start; touched rows card = host (max |err| %.3g); "
          "lazy_update=False moves every row (SGD, Adam)"
          % (FM_FEATURES, FM_FACTOR, rows.size, FM_LAZY_WD, worst))
    # Adam's lazy update taken apart, on the card
    opt = mx.optimizer.create("adam", learning_rate=0.1)
    w = mx.nd.array(W0, ctx=gpu)
    mean, var = opt.create_state(0, w)
    grad = sp.row_sparse_array((mx.nd.array(g, ctx=gpu),
                                mx.nd.array(rows, ctx=gpu, dtype="int32")),
                               shape=(FM_FEATURES, FM_FACTOR), ctx=gpu)
    idx = grad.indices._data.long()
    op = mx.ops.get_op("adam_update")
    attrs = mx.ops.normalize_attrs(op, dict(lr=0.1, wd=0.0, beta1=0.9,
                                            beta2=0.999, epsilon=1e-8))
    blocks = [t.index_select(0, idx) for t in (w._data, mean._data,
                                               var._data)]
    with torch.no_grad():
        gather = call_ms(lambda: [t.index_select(0, idx) for t in
                                  (w._data, mean._data, var._data)])
        rule = call_ms(lambda: op.forward(attrs, blocks[0], grad.data._data,
                                          blocks[1], blocks[2]))
        scatter = call_ms(lambda: [t.index_copy_(0, idx, b) for t, b in
                                   zip((w._data, mean._data, var._data),
                                       blocks)])
        whole = call_ms(lambda: opt.update(0, w, grad, (mean, var)))
        dense_g = torch.zeros_like(w._data)
        dense = call_ms(lambda: op.forward(attrs, w._data, dense_g,
                                           mean._data, var._data))
    nbytes = rows.size * FM_FACTOR * 4 * 7 + rows.size * 4
    bound = nbytes / PEAK_BYTES * 1e3
    print("  (b) Adam's lazy update of %d rows: %.4f ms a call (gather of "
          "w, mean, var %.4f, the update op on the block %.4f, scatter "
          "%.4f; CUDA events), bound %.4f ms (bytes: 4 blocks read, 3 "
          "written); the dense update of all %d rows %.4f ms; %s"
          % (rows.size, whole, gather, rule, scatter, bound, FM_FEATURES,
             dense, card))
    return dict(lazy_err=worst, touched=int(rows.size), adam_ms=whole,
                gather_ms=gather, rule_ms=rule, scatter_ms=scatter,
                dense_adam_ms=dense, lazy_bound_ms=bound)


def fm_first_step(mx, net, trainer, loss_fn, batch):
    """Step 1 on the card and on the host from the same initial weights
    and batch. The dense gradients before the update agree within FM_TOL
    normwise (max |card - host| over max |host|). Every weight after it
    agrees within FM_TOL plus that gradient difference carried through
    Adam's first step: with g the rescaled gradient, the step is
    lr g / (|g| + e'), e' = epsilon / sqrt(1 - beta2), whose slope
    lr e' / (|g| + e')^2 turns a gradient difference d into at most that
    slope times d where |g| is near e'. Returns (max |weight error|, the
    count of weights whose bound the carried difference widened, the
    card's loss)."""
    cpu = mx.cpu()
    host = fm_net(mx, cpu)
    for src, dst in ((net.w, host.w), (net.v, host.v)):
        dst.weight.set_data(mx.nd.array(src.weight.data().asnumpy(),
                                        ctx=cpu))
    host_trainer = mx.gluon.Trainer(host.collect_params(), "adam",
                                    dict(FM_ADAM))
    hbatch = mx.io.DataBatch(data=[batch.data[0].copyto(cpu)],
                             label=[batch.label[0].as_in_context(cpu)])
    grads, losses = {}, {}
    for tag, n, t, b in (("card", net, trainer, batch),
                         ("host", host, host_trainer, hbatch)):
        idx, vals = fm_inputs(mx, b.data[0])
        with mx.autograd.record():
            losses[tag] = loss_fn(n(idx, vals), b.label[0])
        losses[tag].backward()
        grads[tag] = [p.grad().asnumpy() for p in (n.w.weight, n.v.weight)]
        # the host's step is not the card's: it counts no fallback
        with fused_gate(tag == "card"):
            t.step(FM_BATCH)
    opt = host_trainer.optimizer
    lr, eps = opt.lr, opt.epsilon / math.sqrt(1 - opt.beta2)
    worst, widened = 0.0, 0
    for name, gc_, gh, pc, ph in zip(
            ("w", "v"), grads["card"], grads["host"], (net.w, net.v),
            (host.w, host.v)):
        scale = float(np.abs(gh).max())
        diff = float(np.abs(gc_ - gh).max())
        if diff > FM_TOL["rtol"] * scale:
            fail("(c) step 1: %s's gradient off the host's by %g of its "
                 "largest" % (name, diff / scale))
        a, b = pc.weight.data().asnumpy(), ph.weight.data().asnumpy()
        # the slope's largest value between the two gradients
        g = np.maximum(np.abs(gh) - diff, 0) / FM_BATCH
        carried = lr * eps / (g + eps) ** 2 * (diff / FM_BATCH)
        tol = FM_TOL["atol"] + FM_TOL["rtol"] * np.abs(b)
        err = np.abs(a - b)
        if not (err <= tol + carried).all():
            k = int(np.argmax(err - tol - carried))
            fail("(c) step 1: %s off the host's by %g (gradient %g, "
                 "bound %g)" % (name, err.flat[k], gh.flat[k],
                                tol.flat[k] + carried.flat[k]))
        worst = max(worst, float(err.max()))
        widened += int((err > tol).sum())
    del host, host_trainer
    return worst, widened, losses["card"]


def fm_train(mx, path, card):
    """(c): the FM trained on gpu(0) from the libsvm file through
    ``mx.io.LibSVMIter``, FM_EPOCHS epochs, Adam; step 1 held to the host;
    ms a step, samples/s, the device's idle share and busy ms by stage
    (profiler), host syncs a step, the fused-step fallbacks, the peak
    memory the training adds to what the process held before it (the
    weights, states, gradients and every step's temporaries)."""
    gpu = mx.gpu(0)
    t0 = time.perf_counter()
    with gpu:
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(FM_FEATURES,),
                              batch_size=FM_BATCH)
    parse_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    net = fm_net(mx, gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(FM_ADAM))
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    mx.profiler.reset_counters()
    losses, step_ms, steps = [], [], 0
    step1 = None
    for epoch in range(FM_EPOCHS):
        it.reset()
        total = torch.zeros((), device=gpu.torch_device())
        with gpu:
            batches = iter(it)
            for batch in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                if step1 is None:
                    step1 = fm_first_step(mx, net, trainer, loss_fn, batch)
                    total.add_(step1[2]._data.detach().sum())
                else:
                    fm_step(mx, net, trainer, loss_fn, batch, total)
                torch.cuda.synchronize()
                if epoch == FM_EPOCHS - 1:
                    step_ms.append((time.perf_counter() - t) * 1e3)
                steps += 1
        losses.append(float(total) / FM_ROWS)
    peak_mb = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    fallbacks = mx.profiler.counters().get("fused_step_fallbacks", 0)
    # one step's host syncs, then a short profile by stage
    it.reset()
    with gpu:
        prof_batches = [it.next() for _ in range(FM_PROFILE_STEPS + 1)]
        _, syncs = count_syncs(lambda: fm_step(mx, net, trainer, loss_fn,
                                               prof_batches[0]))
        stages, busy, wall = fm_profile(mx, net, trainer, loss_fn,
                                        prof_batches[1:])
    med = statistics.median(step_ms)
    print("  (c) LibSVMIter parsed %d rows in %.1f s; %d steps over %d "
          "epochs (batch %d, Adam lr %g): mean loss by epoch %s; step 1 "
          "card = host within rtol %g, atol %g and the gradient's "
          "difference carried through Adam's first step (max |err| %.3g; "
          "%d weights outside rtol and atol alone)"
          % (FM_ROWS, parse_s, steps, FM_EPOCHS, FM_BATCH,
             FM_ADAM["learning_rate"], ["%.5f" % x for x in losses],
             FM_TOL["rtol"], FM_TOL["atol"], step1[0], step1[1]))
    print("  (c) epoch %d: %.3f ms a step (median; range %.3f-%.3f), %.0f "
          "samples/s; under the profiler (%d steps) %.3f ms a step, device "
          "busy %.3f ms, idle share %.3f; busy by stage: %s; host syncs a "
          "step %d; fused_step_fallbacks %d (= %d steps); peak memory %.1f "
          "MB above the phase's start; %s"
          % (FM_EPOCHS, med, min(step_ms), max(step_ms),
             FM_BATCH / med * 1e3, FM_PROFILE_STEPS, wall, busy,
             1 - busy / wall, ", ".join("%s %.3f" % kv
                                        for kv in stages.items()),
             syncs, fallbacks, steps, peak_mb, card))
    if not losses[1] < losses[0]:
        fail("(c) the loss did not fall from epoch 1 to 2: %s" % losses)
    if fallbacks != steps:
        fail("(c) fused_step_fallbacks %d, steps %d" % (fallbacks, steps))
    return net, dict(losses=losses, step_ms=med, step_range=(
        min(step_ms), max(step_ms)), samples_s=FM_BATCH / med * 1e3,
        busy_ms=busy, idle=1 - busy / wall, stages=stages, syncs=syncs,
        peak_mb=peak_mb, fallbacks=fallbacks, steps=steps,
        step1_err=step1[0], step1_noisy=step1[1], parse_s=parse_s)


def fm_profile(mx, net, trainer, loss_fn, batches):
    """(device ms by stage a step, device busy ms a step, wall ms a step)
    over ``batches`` under the profiler: forward, backward (the dense
    gradient), the row set (``Trainer._to_row_sparse``) and the lazy
    update (gather, Adam, scatter), from the profiler's ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with fm_stage_ranges(mx), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            fm_step(mx, net, trainer, loss_fn, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    stages = dict.fromkeys(FM_STAGES, 0.0)
    busy = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in stages:
            stages[ev.name] += ev.device_time_total / 1e3 / len(batches)
        elif ev.device_type == DeviceType.CUDA and ev.name not in stages \
                and not getattr(ev, "is_user_annotation", False):
            # the device's own work: the ranges' spans on the device's
            # timeline are not work
            busy += ev.device_time / 1e3 / len(batches)
    return stages, busy, wall


def fm_kvstore(mx, net, ids, card):
    """(d), one process: a ``local`` store's ``row_sparse_pull`` of the
    trained v by five batches' column ids equals those rows of the
    weight, bit for bit, deduplicated and sorted."""
    gpu = mx.gpu(0)
    kv = mx.kv.create("local")
    v = net.v.weight.data()
    kv.init("v", v)
    weight = v.asnumpy()
    for b in range(5):
        sl = ids[b * FM_BATCH:(b + 1) * FM_BATCH]
        out = mx.nd.sparse.zeros("row_sparse", v.shape, ctx=gpu)
        kv.row_sparse_pull("v", out=out, row_ids=mx.nd.array(
            sl.reshape(-1), ctx=gpu, dtype="int32"))
        want = np.unique(sl)
        if not np.array_equal(out.indices.asnumpy(), want) \
                or not np.array_equal(out.data.asnumpy(), weight[want]):
            fail("(d) row_sparse_pull of batch %d differs from the "
                 "weight's rows" % b)
    print("  (d) local store: row_sparse_pull of the trained v (%d x %d) "
          "by 5 batches' column ids = those rows of the weight, bit for "
          "bit, deduplicated and sorted" % v.shape)


def sparse_rank_main(outdir):
    """One rank of phase 23 (d), spawned by ``python -m mxnet_tpu_torch.
    tools.launch -n 2`` (``chip_smoke.py sparse-rank DIR``): the FM from
    seed on gpu(0), one forward + backward on its own batch, and the
    row_sparse v gradient of it pushed to a dist_sync store
    (FM_PUSHES times, timed; ``RowSparseNDArray.tostype`` patched to
    raise, so a densifying push fails); writes its gradient, the stored
    value and its readings to DIR."""
    import traceback
    rank = int(os.environ["DMLC_WORKER_ID"])
    res = {"rank": rank}
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
        torch.backends.cuda.matmul.allow_tf32 = False
        kv = mx.kv.create("dist_sync")
        res.update(kv.stats())
        with np.load(os.path.join(outdir, "batches.npz")) as f:
            ids, vals, y = f["ids"][rank], f["vals"][rank], f["y"][rank]
        gpu = mx.gpu(0)
        net = fm_net(mx, gpu)
        loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(ids, ctx=gpu, dtype="int32"),
                               mx.nd.array(vals, ctx=gpu)),
                           mx.nd.array(y, ctx=gpu))
        loss.backward()
        grad = mx.gluon.Trainer._to_row_sparse(net.v.weight,
                                               net.v.weight.grad())
        kv.init(3, mx.nd.zeros((FM_FEATURES, FM_FACTOR), ctx=gpu))

        def densified(self, stype):
            raise AssertionError("the row_sparse push densified")
        orig = RowSparseNDArray.tostype
        RowSparseNDArray.tostype = densified
        ms = []
        try:
            for _ in range(FM_PUSHES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kv.push(3, grad)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            RowSparseNDArray.tostype = orig
        stored = kv._data[3]
        res.update(stype=stored.stype, push_ms=ms,
                   rows=int(grad.indices.shape[0]),
                   union=int(stored.indices.shape[0]))
        np.savez(os.path.join(outdir, "rank%d.npz" % rank),
                 g_idx=grad.indices.asnumpy(), g_data=grad.data.asnumpy(),
                 s_idx=stored.indices.asnumpy(),
                 s_data=stored.data.asnumpy())
        kv.barrier()
    except BaseException:                        # noqa: BLE001
        res["error"] = traceback.format_exc()
        print(res["error"], flush=True)
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    return 1 if "error" in res else 0


def fm_dist_push(ids, vals, y, card):
    """(d), two ranks on the one card through phase 22's launcher: each
    pushes the row_sparse v gradient of its own batch; the stored union
    and its values equal the one-process sum of the two gradients, bit
    for bit on both ranks, and no push densified."""
    import shutil
    import tempfile
    outdir = tempfile.mkdtemp(prefix="sparse_ranks_")
    try:
        sl = slice(0, 2 * FM_BATCH)
        np.savez(os.path.join(outdir, "batches.npz"),
                 ids=ids[sl].reshape(2, FM_BATCH, -1).astype(np.int32),
                 vals=vals[sl].reshape(2, FM_BATCH, -1),
                 y=y[sl].reshape(2, FM_BATCH))
        ranks, secs = kv_launch(outdir, "sparse-rank")
        saved = [dict(np.load(os.path.join(outdir, "rank%d.npz" % r)))
                 for r in range(KV_RANKS)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    union = np.union1d(saved[0]["g_idx"], saved[1]["g_idx"])
    want = np.zeros((union.size, FM_FACTOR), np.float32)
    for s in saved:
        want[np.searchsorted(union, s["g_idx"])] += s["g_data"]
    for r, (rank, s) in enumerate(zip(ranks, saved)):
        if rank["stype"] != "row_sparse":
            fail("(d) rank %d stored a %s value" % (r, rank["stype"]))
        if not np.array_equal(s["s_idx"], union) \
                or not np.array_equal(s["s_data"], want):
            fail("(d) rank %d's stored union differs from the one-process "
                 "sum" % r)
    if not all(np.array_equal(saved[0][k], saved[1][k])
               for k in ("s_idx", "s_data")):
        fail("(d) the ranks' stored values differ")
    push = [statistics.median(r["push_ms"]) for r in ranks]
    nbytes = FM_FEATURES + union.size * FM_FACTOR * 4
    print("  (d) 2 ranks (%s, %.1f s of launch) each push the row_sparse v "
          "gradient of its own batch (%d and %d rows): the stored union (%d "
          "rows) and its values = the one-process sum, bit for bit on both "
          "ranks; no push densified; a push %.3f / %.3f ms (median of %d), "
          "%.2f MB a rank each way (a one-byte mask of %d rows, then the "
          "%d x %d block), %.3f GB/s; %s"
          % (ranks[0]["backend"], secs, ranks[0]["rows"], ranks[1]["rows"],
             union.size, push[0], push[1], FM_PUSHES, nbytes / 1e6,
             FM_FEATURES, union.size, FM_FACTOR,
             nbytes / (max(push) / 1e3) / 1e9, card))
    return dict(push_ms=push, push_bytes=nbytes, union=int(union.size),
                rank_rows=[r["rows"] for r in ranks], launch_s=secs)


def phase_sparse(card):
    """Phase 23: sparse storage, BASELINE config 4. (a) the sparse
    primitives at the FM's shapes, card against host; (b) the four lazy
    optimizers at (2M, 16); (c) the factorization machine trained
    through Gluon from a synthetic libsvm file; (d) the kvstore: a local
    ``row_sparse_pull`` and a two-rank row_sparse push; (e) the kernels
    of the table launch 0 times over the phase. fp32, TF32 off."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tfa.reset_launches()
    rtc.reset_launches()
    t0 = time.perf_counter()
    ids, vals, y = fm_rows(FM_ROWS)
    tmp = tempfile.mkdtemp(prefix="fm_")
    try:
        path = os.path.join(tmp, "fm.libsvm")
        fm_write_libsvm(path, ids, vals, y)
        print("  data: %d Criteo-shaped rows (%d numeric + %d categorical "
              "fields over %d ids, Zipf %g; %d distinct ids, %.1f MB of "
              "libsvm) from seed %d in %.1f s"
              % (FM_ROWS, FM_NUMERIC, FM_CATEGORICAL, FM_FEATURES, FM_ZIPF,
                 np.unique(ids).size, os.path.getsize(path) / 1e6, FM_SEED,
                 time.perf_counter() - t0))
        prim = sparse_primitives(mx, ids, vals, card)
        lazy = lazy_optimizers(mx, ids, card)
        net, fm = fm_train(mx, path, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fm_kvstore(mx, net, ids, card)
    del net
    torch.cuda.empty_cache()
    dist = fm_dist_push(ids, vals, y, card)
    launches = dict(tfa.launches, rtc=rtc.launches["rtc"])
    print("  (e) attention, decode and rtc kernel launches over phase 23: "
          "%s (none is on this path); sparse phase %.1f s"
          % (launches, time.perf_counter() - t_phase))
    if any(launches.values()):
        fail("sparse: the path launched a kernel of the table: %s"
             % launches)
    return dict(prim, **lazy, **fm, **dist)


# ---------------------------------------------------------------------------
# phase 24: the rank mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_BATCH = 8                      # the global batch of (a): 4 a rank
# (a)'s run is also phase 27's uninterrupted reference: FT_EPOCHS epochs
# of FT_STEPS steps on the global batch, a manifest checkpoint after each
# epoch, the heartbeat armed at FT_HB_TIMEOUT_MS (a full-width step keeps
# the host busy ~2 s in the gloo exchange) (cut from 10 steps without
# checkpoints: phase 27's time; from 3 epochs to 2: phase 30's; from 2
# steps an epoch to 1: phase 31's)
FT_EPOCHS = 2
FT_STEPS = 1
FT_HB_TIMEOUT_MS = 10000
MESH_STEPS = FT_EPOCHS * FT_STEPS
MESH_IDENT_STEPS = 1                # steps of the on/off identity runs
                                    # (cut from 2: the slower hosts' time)
MESH_ADAM = dict(learning_rate=1e-3)
MESH_SEED = 0
MESH_SP_BATCH = 2
MESH_SP_ITERS = 1                   # (cut from 3: phase 31's time)
# (a)'s step 1 against the twin. Adam's first step is about lr * sign(g)
# whatever g's scale, so it cannot show a wrongly weighted gradient: a
# one-step SGD run (lr MESH_SGD_LR, no momentum, no wd) moves each weight
# by exactly the exchanged gradient, held per parameter to the twin's
# gradient of the global mean at phase 10's GRAD_RTOL (GRAD_RTOL_RELU
# for the ffn1 weights); a half-batch or mis-scaled gradient is off by
# 0.5 or more. The gradient is read back as (before - after) / lr, in
# fp32 weights: lr 1e3 keeps that reading's rounding (half an ulp of a
# LayerNorm gain's 1.0 over lr) near 1e-6 of even the smallest gradient,
# where lr 1 left it at 1e-3 of the gains' own, the second tier's
# tolerance. Of the Adam run's step 1: the loss before and after within
# LOSS_ATOL of the twin's, and at most MESH_STEP1_FLIP of all the
# elements stepping the other way
MESH_SGD_LR = 1e3
MESH_STEP1_FLIP = 1e-4
MESH_LOGIT_ATOL = LOGIT_ATOL
MESH_SP_SHAPE = "B%d T%d H%d D64 causal" % (
    MESH_SP_BATCH, GPT2_SMALL["max_len"], GPT2_SMALL["n_heads"] // MESH_RANKS)
MESH_DP_SHAPE = "B%d T%d H%d D64 causal" % (
    MESH_BATCH // MESH_RANKS, GPT2_SMALL["max_len"], GPT2_SMALL["n_heads"])


def mesh_lm(mx):
    """Phase 10's Gluon LM behind one input: the positions come from the
    tokens' own length (``contrib.arange_like``), so the
    DistributedTrainer traces it as ``net(data)``."""
    DecoderLM = gluon_lm(mx)

    class PositionedLM(mx.gluon.HybridBlock):
        def __init__(self, **cfg):
            super().__init__()
            with self.name_scope():
                self.lm = DecoderLM(**cfg)

        def hybrid_forward(self, F, tokens):
            return self.lm(tokens, F.contrib.arange_like(tokens, axis=1))

    return PositionedLM


def mesh_cfg():
    return dict(vocab=GPT2_SMALL["vocab"], layers=GPT2_SMALL["n_layers"],
                heads=GPT2_SMALL["n_heads"],
                units=GPT2_SMALL["n_heads"] * GPT2_SMALL["head_dim"],
                d_ff=GPT2_SMALL["d_ff"], max_len=GPT2_SMALL["max_len"])


def mesh_tokens(batch):
    T = GPT2_SMALL["max_len"]
    seq = np.random.RandomState(MESH_SEED).randint(
        0, GPT2_SMALL["vocab"], size=(batch, T + 1))
    return seq[:, :T].astype(np.float32), seq[:, 1:].astype(np.float32)


def mesh_net(mx, ctx):
    """The LM from seed MESH_SEED (Xavier), on ``ctx``: the same weights
    in every process that builds it."""
    PositionedLM = mesh_lm(mx)
    mx.random.seed(MESH_SEED)
    net = PositionedLM(**mesh_cfg())
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.array(np.zeros((1, 16), np.float32), ctx=ctx))
    return net


def mesh_host(net):
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


def mesh_fingerprint(host):
    return {n: float(np.abs(v.astype(np.float64)).sum())
            for n, v in host.items()}


def mesh_set(mx, net, host, ctx):
    for n, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(host[n], ctx=ctx))


def mesh_twin(mx, ctx):
    """(a)'s twin: phase 10's one-process Gluon Trainer (Adam, fused
    update) on the global batch, one step; the weights before and after
    and the gradient of the global mean on the host, the step's loss,
    and the full parameter and Adam state bytes."""
    net = mesh_net(mx, ctx)
    init = mesh_host(net)
    x, y = mesh_tokens(MESH_BATCH)
    tokens, labels = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               dict(MESH_ADAM))
    with mx.autograd.record():
        loss = loss_fn(net(tokens), labels)
    loss.backward()
    grad = {n: p.grad().asnumpy() / MESH_BATCH
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}
    trainer.step(MESH_BATCH)
    step1 = mesh_host(net)
    with mx.autograd.pause():
        loss2 = float(loss_fn(net(tokens), labels).mean().asscalar())
    n = sum(v.size for v in init.values())
    rec = dict(init=init, step1=step1, grad=grad,
               loss=float(loss.mean().asscalar()),
               loss2=loss2,
               param_bytes=4 * n, state_bytes=8 * n, n_params=n,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del net, trainer, loss, tokens, labels
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_rank_dp(mx, par, tfa, ctx, rank, outdir, init, say):
    """(a) on one rank: the DistributedTrainer over {"dp": 2} with
    ZeRO-1 and FSDP, MESH_STEPS Adam steps on the global batch, a
    checkpoint each FT_STEPS (phase 27 (a)); then the
    overlap-off and FSDP-off runs, MESH_IDENT_STEPS steps each from the
    same weights, held bit for bit to the first run's weights at that
    step; then one SGD step of the first run's modes (rank 0's weights
    after it to sgd1.npz)."""
    from mxnet_tpu_torch.parallel import multihost
    mesh = par.create_mesh({"dp": MESH_RANKS})
    x, y = mesh_tokens(MESH_BATCH)
    tokens, labels = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    net = mesh_net(mx, ctx)
    out = {"fingerprint": mesh_fingerprint(mesh_host(net))}

    def trainer(overlap, shard, optimizer="adam", params=MESH_ADAM):
        mesh_set(mx, net, init, ctx)
        return par.DistributedTrainer(
            net, loss_fn, mesh, optimizer=optimizer,
            optimizer_params=dict(params), grad_overlap=overlap,
            param_shard=shard)

    tr = trainer(True, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launches()              # (a)'s main path starts here
    curve, step_ms, sync_ms, ident = [], [], [], None
    ft = dict(save_ms=[], save_bytes=[])
    for step in range(MESH_STEPS):
        t0 = time.perf_counter()
        loss = float(tr.fit_batch(tokens, labels).asscalar())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sync_ms.append(tr.last_sync_s * 1e3)
        curve.append(loss)
        if step + 1 in (1, MESH_IDENT_STEPS):
            tr.sync_gluon_params()
            host = mesh_host(net)
            if step == 0 and rank == 0:
                np.savez(os.path.join(outdir, "step1.npz"), **host)
            if step + 1 == MESH_IDENT_STEPS:
                ident = host
        if (step + 1) % FT_STEPS == 0:
            ft_save(tr, os.path.join(outdir, "ck"), step // FT_STEPS, rank,
                    ft)
    out["launches"] = dict(tfa.launches)      # ... and ends here
    tr.sync_gluon_params()
    ft.update(curve=curve, step_ms=step_ms, host_lost=multihost.host_lost())
    if rank == 0:
        ft["digest"] = ft_digest(mesh_host(net))
    out["ft"] = ft
    out.update(curve=curve, step_ms=step_ms, sync_ms=sync_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               state_bytes=tr.state_bytes_per_device(),
               param_bytes=tr.param_bytes_per_device(),
               breakdown=tr._memory_breakdown(),
               buckets=len(tr._plan.buckets),
               padded=[pl.name for pl in tr._param_plans if pl.padded],
               sharded=sum(pl.sharded for pl in tr._param_plans),
               plans=len(tr._param_plans))
    say("(a) rank %d: loss %.4f -> %.4f, %.1f ms a step (sync %.1f), peak "
        "%.2f GB, launches %s" % (rank, curve[0], curve[-1],
                                  statistics.median(step_ms[1:]),
                                  statistics.median(sync_ms[1:]),
                                  out["peak_gb"], out["launches"]))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    out["identity"] = {}
    for name, overlap, shard in (("overlap off", False, True),
                                 ("FSDP off", True, False)):
        tr = trainer(overlap, shard)
        for _ in range(MESH_IDENT_STEPS):
            tr.fit_batch(tokens, labels)
        tr.sync_gluon_params()
        host = mesh_host(net)
        out["identity"][name] = all(np.array_equal(host[n], ident[n])
                                    for n in ident)
        del tr, host
        gc.collect()
        torch.cuda.empty_cache()
    say("(a) rank %d: bit-identical after %d steps: %s"
        % (rank, MESH_IDENT_STEPS, out["identity"]))
    tr = trainer(True, True, "sgd", dict(learning_rate=MESH_SGD_LR))
    out["sgd_loss"] = float(tr.fit_batch(tokens, labels).asscalar())
    tr.sync_gluon_params()
    if rank == 0:
        np.savez(os.path.join(outdir, "sgd1.npz"), **mesh_host(net))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    mesh_rank_masks(mx, par, net, init, ctx, tokens, mesh, outdir, rank,
                    "masks")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rank_masks(mx, par, net, init, ctx, tokens, mesh, outdir, rank,
                    tag):
    """This rank's ReLU masks (``a > 0`` of each layer's ffn1) of the net
    at ``init`` on its piece of ``tokens`` (its dp rows and, over sp, its
    half of the sequence), the forward the SGD step ran, bit-packed to
    DIR/<tag>.rank<r>.npz."""
    spec = ("dp", "sp") if "sp" in mesh.axis_names else ("dp",)
    local = mx.nd.NDArray(par.NamedSharding(mesh, par.PartitionSpec(*spec))
                          .shard(tokens._data).contiguous())
    mesh_set(mx, net, init, ctx)
    layers = [net.lm.layers[i] for i in range(len(net.lm.layers))]
    for layer in layers:
        layer.relu_masks = []
    with par.use_mesh(mesh), mx.autograd.pause():
        net(local)
    np.savez(os.path.join(outdir, "%s.rank%d.npz" % (tag, rank)),
             **{"l%d" % i: np.packbits(layer.relu_masks[0].asnumpy() > 0,
                                       axis=-1)
                for i, layer in enumerate(layers)})
    for layer in layers:
        layer.relu_masks = None


def mesh_masks(outdir, tag, n_ranks, coords):
    """The ranks' masks assembled over the global batch: ``coords(r)``
    gives rank r's (row block, sequence block) of ``n_ranks`` ranks."""
    B, T, F = MESH_BATCH, GPT2_SMALL["max_len"], GPT2_SMALL["d_ff"]
    blocks = [coords(r) for r in range(n_ranks)]
    nb = max(b for b, _ in blocks) + 1
    ns = max(s for _, s in blocks) + 1
    full = [np.zeros((B, T, F), bool) for _ in range(GPT2_SMALL["n_layers"])]
    for r, (b, s) in enumerate(blocks):
        rows = slice(b * B // nb, (b + 1) * B // nb)
        cols = slice(s * T // ns, (s + 1) * T // ns)
        with np.load(os.path.join(outdir, "%s.rank%d.npz" % (tag, r))) as f:
            for i, m in enumerate(full):
                m[rows, cols] = np.unpackbits(f["l%d" % i], axis=-1,
                                              count=F).astype(bool)
    return full


def mesh_twin_shared(mx, ctx, init, masks):
    """The twin's gradient of the global mean (global batch, flash
    attention) with each layer's ReLU replaced by the ranks' masks
    (phase 10's second pass); also the sign flips between the routes."""
    net = mesh_net(mx, ctx)
    mesh_set(mx, net, init, ctx)
    SharedReLU = shared_relu(mx)
    layers = [net.lm.layers[i] for i in range(len(net.lm.layers))]
    for layer, m in zip(layers, masks):
        layer.ffn1.act = SharedReLU(mx.nd.array(m.astype(np.float32),
                                                ctx=ctx))
    x, y = mesh_tokens(MESH_BATCH)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
    loss.backward()
    grad = {n: p.grad().asnumpy() / MESH_BATCH
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}
    flips = [layer.ffn1.act.flips for layer in layers]
    del net, layers, loss
    gc.collect()
    torch.cuda.empty_cache()
    return grad, flips


def mesh_grads(net):
    return {n: p.grad()._data.clone()
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def mesh_rank_sp(mx, par, tfa, ctx, rank, init, say):
    """(b) on one rank: the LM at B2 T1024 over {"sp": 2}, this rank's
    512 positions, forward and backward with impl="ulysses" and then
    "ring" (the gradients summed over the axis), against the one-process
    flash route over the whole sequence, on the same weights."""
    from mxnet_tpu_torch.parallel import collectives
    mesh = par.create_mesh({"sp": MESH_RANKS})
    x, y = mesh_tokens(MESH_SP_BATCH)
    T = x.shape[1]
    Tl = T // MESH_RANKS
    lo, hi = rank * Tl, (rank + 1) * Tl
    net = mesh_net(mx, ctx)
    mesh_set(mx, net, init, ctx)
    lm = net.lm
    layers = [lm.layers[i] for i in range(len(lm.layers))]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def route(impl, tok, lab, pos, denom, sharded, grads=True):
        """Forward + backward; with ``grads``, the gradients (summed over
        the sp ranks when ``sharded``)."""
        for layer in layers:
            layer.attn._impl = impl
        for p in net.collect_params().values():
            if p.grad_req != "null":
                p.zero_grad()
        with par.use_mesh(mesh if sharded else None):
            with mx.autograd.record():
                logits = lm(tok, pos)
                loss = loss_fn(logits, lab).sum() / denom
            loss.backward()
        torch.cuda.synchronize()
        if not grads:
            return logits._data, None
        out = mesh_grads(net)
        if sharded:
            out = {n: collectives.all_reduce(g, mesh, "sp")
                   for n, g in out.items()}
        return logits._data, out

    def timed_route(*args):
        """ms of forward + backward (the gradient sum not included)."""
        ms = []
        for _ in range(MESH_SP_ITERS):
            t0 = time.perf_counter()
            route(*args, grads=False)
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    tok = mx.nd.array(x[:, lo:hi], ctx=ctx)
    lab = mx.nd.array(y[:, lo:hi], ctx=ctx)
    pos = mx.nd.array(np.arange(lo, hi, dtype=np.float32), ctx=ctx)
    denom = float(MESH_SP_BATCH * MESH_RANKS)
    full = (mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx),
            mx.nd.array(np.arange(T, dtype=np.float32), ctx=ctx),
            float(MESH_SP_BATCH), False)
    ref_logits, ref_grads = route("flash", *full)
    ref_logits = ref_logits[:, lo:hi]
    out = {"ref_ms": timed_route("flash", *full)}
    SharedReLU = shared_relu(mx)
    for layer in layers:                  # the plain ReLU until a mask is set
        layer.ffn1.act = SharedReLU(None)

    def ratios_of(grads, ref):
        return {n: float((grads[n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                for n, g in ref.items()}

    for impl in ("ulysses", "ring"):
        for layer in layers:
            layer.relu_masks = []
        tfa.reset_launches()              # (b)'s route starts here
        logits, grads = route(impl, tok, lab, pos, denom, True)
        out[impl] = {"launches": dict(tfa.launches)}   # ... ends here
        ratios = ratios_of(grads, ref_grads)
        # phase 10's second pass: the one-process route again with the
        # ranks' ReLU masks (the sequence halves gathered over sp)
        for layer in layers:
            half = layer.relu_masks[0]._data.movedim(1, 0).contiguous()
            layer.relu_masks = None
            whole = collectives.all_gather(half, mesh, "sp").movedim(0, 1)
            layer.ffn1.act.mask = mx.nd.NDArray(whole.contiguous())
        _, shared_grads = route("flash", *full)
        flips = [layer.ffn1.act.flips for layer in layers]
        for layer in layers:
            layer.ffn1.act.mask = None
        shared = ratios_of(grads, shared_grads)
        del shared_grads
        out[impl].update(shared_worst=max(shared.values()),
                         shared_median=statistics.median(shared.values()),
                         shared_worst_name=max(shared, key=shared.get),
                         shared_flips=sum(flips))
        over = [n for n, r in ratios.items()
                if r > (GRAD_RTOL_RELU if n.endswith("ffn1.weight")
                        else GRAD_RTOL)]
        out[impl].update(
            logit_err=float((logits - ref_logits).abs().max()),
            grad_worst=max(ratios.values()),
            grad_median=statistics.median(ratios.values()),
            grad_worst_name=max(ratios, key=ratios.get), grad_over=over,
            ms=timed_route(impl, tok, lab, pos, denom, True))
        say("(b) rank %d %s: logits max abs err %.3g, gradients worst "
            "%.3g (%s), with shared masks %.3g (%s), %.1f ms fwd+bwd (one "
            "process %.1f), launches %s"
            % (rank, impl, out[impl]["logit_err"], out[impl]["grad_worst"],
               out[impl]["grad_worst_name"], out[impl]["shared_worst"],
               out[impl]["shared_worst_name"], out[impl]["ms"],
               out["ref_ms"], out[impl]["launches"]))
    del net, lm, layers
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rank_main(outdir):
    """One rank of phase 24, spawned by ``python -m mxnet_tpu_torch.tools.
    launch -n 2`` (``chip_smoke.py mesh-rank DIR``) on gpu(0): (a) and
    (b); its readings to DIR/rank<r>.json, rank 0's step-1 weights to
    DIR/step1.npz, its log to DIR/rank<r>.log; any failure is written
    there and exits 1."""
    import traceback
    rank = int(os.environ["DMLC_WORKER_ID"])
    log = open(os.path.join(outdir, "rank%d.log" % rank), "w")

    def say(line):
        log.write(line + "\n")
        log.flush()
        print(line, flush=True)
    res = {"rank": rank}
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import parallel as par
        from mxnet_tpu_torch.parallel import distributed
        tfa = importlib.import_module(
            "mxnet_tpu_torch.parallel.flash_attention")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ctx = mx.gpu(0)
        res["backend"] = distributed.backend()
        say("rank %d of %d joined: backend %s, device %s"
            % (rank, distributed.num_workers(), res["backend"],
               torch.cuda.get_device_name(0)))
        init = mesh_host(mesh_net(mx, ctx))
        torch.cuda.empty_cache()
        res["a"] = mesh_rank_dp(mx, par, tfa, ctx, rank, outdir, init, say)
        res["b"] = mesh_rank_sp(mx, par, tfa, ctx, rank, init, say)
        distributed.barrier()
        say("rank %d done" % rank)
    except Exception:                            # noqa: BLE001
        res["error"] = traceback.format_exc()
        say(res["error"])
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    log.close()
    return 1 if "error" in res else 0


def mesh_sgd_grads(twin, outdir, grad=None, fname="sgd1.npz"):
    """The SGD step's exchanged gradient, ``(init - after) / lr``, held
    to the twin's gradient (``grad``, else ``twin["grad"]``): ``{name:
    max|diff| / max|grad|}``."""
    out = {}
    with np.load(os.path.join(outdir, fname)) as f:
        for n, want in (grad or twin["grad"]).items():
            got = (twin["init"][n].astype(np.float64)
                   - f[n].astype(np.float64)) / MESH_SGD_LR
            out[n] = float(np.abs(got - want).max()
                           / max(float(np.abs(want).max()), 1e-30))
    return out


def mesh_step1(twin, lr, outdir):
    """(a)'s Adam step 1 against the twin: the share of all elements
    whose step goes the other way, and per parameter (largest share
    first) that share, the share further than 1e-3 lr apart with the
    median size of the twin's step there, and the largest difference
    (in units of lr)."""
    rows, flips, total = [], 0, 0
    with np.load(os.path.join(outdir, "step1.npz")) as f:
        for n, want in twin["step1"].items():
            init = twin["init"][n]
            got_step, want_step = f[n] - init, want - init
            d = np.abs(got_step - want_step) / lr
            off = d > 1e-3
            flip = int((np.sign(got_step) != np.sign(want_step)).sum())
            flips, total = flips + flip, total + want.size
            rows.append((flip / want.size, float(d.max()), float(off.mean()),
                         float(np.median(np.abs(want_step[off])) / lr)
                         if off.any() else 0.0, n))
    rows.sort(reverse=True)
    return flips / total, rows


def phase_mesh(card, tfa):
    """Phase 24: the twentieth slice, the rank mesh. Each kernel of the
    Ulysses path held to its plain version at its shapes here; (a)'s
    one-process twin; then two ranks, separate processes under ``python
    -m mxnet_tpu_torch.tools.launch -n 2``, both on gpu(0) (gloo by the
    backend rule, CUDA tensors staged through the host): (a) the
    DistributedTrainer over {"dp": 2} with ZeRO-1 and FSDP, (b) Ulysses
    and ring attention over {"sp": 2}. fp32, TF32 off. Returns the
    kernel records and the Ulysses launch counts."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, H = GPT2_SMALL["max_len"], GPT2_SMALL["n_heads"]
    print("  the kernels at the mesh's shapes (%s):" % card)
    kern = {"sp": dict(bwd_case(tfa, MESH_SP_BATCH, T, T, H // MESH_RANKS,
                                64, True, False, seed=41),
                       flash_fwd=fwd_case(tfa, MESH_SP_BATCH, T, T,
                                          H // MESH_RANKS, 64, True, False,
                                          seed=41)),
            "dp": dict(bwd_case(tfa, MESH_BATCH // MESH_RANKS, T, T, H, 64,
                                True, False, seed=42),
                       flash_fwd=fwd_case(tfa, MESH_BATCH // MESH_RANKS, T,
                                          T, H, 64, True, False, seed=42))}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    twin = mesh_twin(mx, mx.gpu(0))
    print("  (a)'s twin: one process, Gluon Trainer (Adam lr %g, fused "
          "update), global batch %d x %d, %.1fM parameters: step-1 loss "
          "%.5f, peak %.2f GB, %.1f s"
          % (MESH_ADAM["learning_rate"], MESH_BATCH, T,
             twin["n_params"] / 1e6, twin["loss"], twin["peak_gb"],
             time.perf_counter() - t0))
    outdir = tempfile.mkdtemp(prefix="mesh_")
    try:
        ranks, secs = kv_launch(
            outdir, "mesh-rank", MESH_RANKS,
            env=dict(MXNET_HB_DIR=os.path.join(outdir, "hb"),
                     MXNET_HB_TIMEOUT_MS=str(FT_HB_TIMEOUT_MS)))
        lr = MESH_ADAM["learning_rate"]
        flip_share, step1_rows = mesh_step1(twin, lr, outdir)
        sgd_ratios = mesh_sgd_grads(twin, outdir)
        shared_grad, shared_flips = mesh_twin_shared(
            mx, mx.gpu(0), twin["init"],
            mesh_masks(outdir, "masks", MESH_RANKS, lambda r: (r, 0)))
        shared_ratios = mesh_sgd_grads(twin, outdir, shared_grad)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    a = [r["a"] for r in ranks]
    b = [r["b"] for r in ranks]
    if any(r["fingerprint"] != mesh_fingerprint(twin["init"]) for r in a):
        fail("mesh: a rank's initial weights differ from the twin's")
    ratio_p = a[0]["param_bytes"] / twin["param_bytes"]
    ratio_s = a[0]["state_bytes"] / twin["state_bytes"]
    print("  (a) 2 ranks (%s, %.1f s of launch), {dp: 2}, "
          "DistributedTrainer(grad_overlap=True, param_shard=True), Adam lr "
          "%g, global batch %d x %d (%d a rank), %d steps: loss %s; step 1 "
          "against the twin: loss %.6f / %.6f before, %.6f / %.6f after "
          "(tolerance %g); share of the elements stepping the other way "
          "%.3g (at most %g)"
          % (ranks[0]["backend"], secs, lr, MESH_BATCH, T,
             MESH_BATCH // MESH_RANKS, MESH_STEPS,
             " ".join("%.4f" % c for c in a[0]["curve"]), a[0]["curve"][0],
             twin["loss"], a[0]["curve"][1], twin["loss2"], LOSS_ATOL,
             flip_share, MESH_STEP1_FLIP))
    sgd_over = [n for n, r in sgd_ratios.items()
                if r > (GRAD_RTOL_RELU if n.endswith("ffn1.weight")
                        else GRAD_RTOL)]
    print("  (a) one SGD step (lr %g) of the same modes: the exchanged "
          "gradient against the twin's, max|diff| / max|grad| per "
          "parameter: worst %.3g (%s), median %.3g (tolerance %g, ffn1 "
          "weights %g: phase 10's); loss %.6f (%s)"
          % (MESH_SGD_LR, max(sgd_ratios.values()),
             max(sgd_ratios, key=sgd_ratios.get),
             statistics.median(sgd_ratios.values()), GRAD_RTOL,
             GRAD_RTOL_RELU, a[0]["sgd_loss"], card))
    print_groups(sgd_ratios)
    print("  (a) the twin again with the ranks' ReLU masks (phase 10's second"
          " pass; %d pre-activations flipped sign between the routes, per "
          "layer %s): the exchanged gradient worst %.3g (%s), median %.3g "
          "(tolerance %g, every parameter; %s)"
          % (sum(shared_flips), shared_flips, max(shared_ratios.values()),
             max(shared_ratios, key=shared_ratios.get),
             statistics.median(shared_ratios.values()), GRAD_RTOL_SHARED,
             card))
    print_groups(shared_ratios)
    for flip, dmax, off, size, name in step1_rows[:5]:
        print("    step 1, %s: %.3g of its elements step the other way, "
              "%.3g further than 1e-3 lr apart (the twin's step there: "
              "median %.3g lr), largest difference %.3g lr"
              % (name, flip, off, size, dmax))
    for r, rec in enumerate(a):
        print("    rank %d: %.1f ms a step (median of steps 2-%d; sync %.1f "
              "ms), peak %.2f GB; parameters %.1f MB a rank (%.3f of the "
              "twin's %.1f MB: %d of %d sharded, padded %s), Adam state "
              "%.1f MB (%.3f of %.1f MB), %d buckets; breakdown %s; "
              "launches %s; bit-identical after %d steps: %s; %s"
              % (r, statistics.median(rec["step_ms"][1:]), MESH_STEPS,
                 statistics.median(rec["sync_ms"][1:]), rec["peak_gb"],
                 rec["param_bytes"] / 1e6,
                 rec["param_bytes"] / twin["param_bytes"],
                 twin["param_bytes"] / 1e6, rec["sharded"], rec["plans"],
                 rec["padded"], rec["state_bytes"] / 1e6,
                 rec["state_bytes"] / twin["state_bytes"],
                 twin["state_bytes"] / 1e6, rec["buckets"],
                 rec["breakdown"], rec["launches"], MESH_IDENT_STEPS,
                 rec["identity"], card))
    L = GPT2_SMALL["n_layers"]
    for r, rec in enumerate(a):
        if not all(np.isfinite(rec["curve"])) \
                or not rec["curve"][-1] < rec["curve"][0]:
            fail("(a) rank %d: the loss did not fall: %s" % (r, rec["curve"]))
        if not all(rec["identity"].values()):
            fail("(a) rank %d: an on/off pair is not bit-identical: %s"
                 % (r, rec["identity"]))
        for kname in TRAIN_KERNELS:
            if rec["launches"][kname] != L * MESH_STEPS:
                fail("(a) rank %d: %s launched %d times in %d steps, want "
                     "%d a step" % (r, kname, rec["launches"][kname],
                                    MESH_STEPS, L))
        if not (0.45 < rec["param_bytes"] / twin["param_bytes"] < 0.55
                and 0.45 < rec["state_bytes"] / twin["state_bytes"] < 0.55):
            fail("(a) rank %d: parameter or state bytes are not about half "
                 "the twin's" % r)
    if a[0]["curve"] != a[1]["curve"]:
        fail("(a) the ranks' losses differ")
    if sgd_over:
        fail("(a) the exchanged gradient is outside its tolerance of the "
             "twin's: %s" % sgd_over)
    if max(shared_ratios.values()) > GRAD_RTOL_SHARED:
        fail("(a) the exchanged gradient is outside %g of the twin's with "
             "shared ReLU masks" % GRAD_RTOL_SHARED)
    if flip_share > MESH_STEP1_FLIP \
            or abs(a[0]["curve"][0] - twin["loss"]) > LOSS_ATOL \
            or abs(a[0]["curve"][1] - twin["loss2"]) > LOSS_ATOL:
        fail("(a) step 1 is outside its tolerance of the twin")
    print("  (b) {sp: 2}, the LM at B%d T%d (%d positions a rank), forward "
          "+ backward on the same weights, gradients summed over sp, "
          "against the one-process flash route (%s):"
          % (MESH_SP_BATCH, T, T // MESH_RANKS, card))
    for impl in ("ulysses", "ring"):
        for r, rec in enumerate(b):
            x = rec[impl]
            print("    %-7s rank %d: logits max abs err %.3g (tolerance "
                  "%g), gradients max|diff| / max|grad| worst %.3g (%s), "
                  "median %.3g (tolerance %g, ffn1 weights %g: phase 10's); "
                  "with the ranks' ReLU masks shared (%d sign flips) worst "
                  "%.3g (%s), median %.3g (tolerance %g); %.1f ms fwd+bwd vs "
                  "%.1f ms one process; kernel launches %s"
                  % (impl, r, x["logit_err"], MESH_LOGIT_ATOL,
                     x["grad_worst"], x["grad_worst_name"], x["grad_median"],
                     GRAD_RTOL, GRAD_RTOL_RELU, x["shared_flips"],
                     x["shared_worst"], x["shared_worst_name"],
                     x["shared_median"], GRAD_RTOL_SHARED, x["ms"],
                     rec["ref_ms"], x["launches"]))
            if x["logit_err"] > MESH_LOGIT_ATOL or x["grad_over"] \
                    or x["shared_worst"] > GRAD_RTOL_SHARED:
                fail("(b) %s on rank %d is outside its tolerance of the "
                     "one-process route" % (impl, r))
        for kname in TRAIN_KERNELS:
            n = [rec[impl]["launches"][kname] for rec in b]
            if impl == "ulysses" and min(n) != L:
                fail("(b) ulysses: %s launched %s times on the ranks, want "
                     "%d each" % (kname, n, L))
    print("  ring attention launched %s of the table's kernels on the ranks"
          " (its block is plain torch, as the JAX package's is jnp); mesh "
          "phase %.1f s" % ([{k: rec["ring"]["launches"][k]
                              for k in TRAIN_KERNELS} for rec in b],
                            time.perf_counter() - t_phase))
    return dict(kern=kern, dp_launches=a[0]["launches"],
                sp_launches=b[0]["ulysses"]["launches"],
                ring_launches=b[0]["ring"]["launches"], twin=twin,
                curve=a[0]["curve"], ft=[rec["ft"] for rec in a], ft_s=secs)


# ---------------------------------------------------------------------------
# phase 25: every mesh axis
# ---------------------------------------------------------------------------

MESH4_RANKS = 4
MESH4_STEPS = 2                     # (cut from 5: phase 27's time; 3: 30's)
MESH4_LAUNCH_TIMEOUT = 600
DRY_RANKS = 8
DRY_WIDTH = dict(D=768, H=12, F=3072, E=4, T=1024)
DRY_LOSS_RTOL = 1e-5
DRY_ATOL, DRY_RTOL = 1e-6, 1e-5
DRY_LAUNCH_TIMEOUT = 600


def staged_bytes():
    from mxnet_tpu_torch import profiler
    return profiler.counters().get("collective_staged_bytes", 0)


def mesh4_trainer(mx, par, net, init, ctx, mesh, optimizer="adam",
                  params=MESH_ADAM):
    mesh_set(mx, net, init, ctx)
    return par.DistributedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh,
        optimizer=optimizer, optimizer_params=dict(params),
        grad_overlap=True, param_shard=True)


def mesh4_steps(mx, tfa, tr, tokens, labels):
    """MESH4_STEPS steps, launch counts zeroed just before and read just
    after: the curve, ms and sync ms a step, peak memory, staged bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged0 = staged_bytes()
    tfa.reset_launches()                  # the path starts here
    curve, step_ms, sync_ms = [], [], []
    for _ in range(MESH4_STEPS):
        t0 = time.perf_counter()
        curve.append(float(tr.fit_batch(tokens, labels).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sync_ms.append(tr.last_sync_s * 1e3)
    return dict(launches=dict(tfa.launches), curve=curve, step_ms=step_ms,
                sync_ms=sync_ms, staged=staged_bytes() - staged0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                param_bytes=tr.param_bytes_per_device(),
                state_bytes=tr.state_bytes_per_device())


def mesh4_checkpoint(mx, par, tr, net, init, ctx, mesh, tokens, labels,
                     outdir, rank):
    """Phase 27 (d) on one rank: (b)'s trainer saves its state once, a
    fresh trainer loads it, and each takes one more step: the losses, the
    2-D pieces and the Adam state equal bit for bit; save and load ms,
    this rank's shard bytes."""
    from mxnet_tpu_torch import checkpoint as ckpt
    prefix = os.path.join(outdir, "tp2d")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_checkpoint(prefix, 0)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = mesh4_trainer(mx, par, net, init, ctx, mesh)
    t0 = time.perf_counter()
    fresh.load_checkpoint(prefix, 0)
    load_ms = (time.perf_counter() - t0) * 1e3
    loss = float(tr.fit_batch(tokens, labels).asscalar())
    loss_fresh = float(fresh.fit_batch(tokens, labels).asscalar())
    same = all(torch.equal(a, b) for a, b in
               zip(list(tr._param_vals) + list(tr._state_vals),
                   list(fresh._param_vals) + list(fresh._state_vals)))
    manifest = ckpt.load_manifest(prefix, 0)
    del fresh
    return dict(save_ms=save_ms, load_ms=load_ms, loss=loss,
                loss_fresh=loss_fresh, same=same,
                bytes=os.path.getsize(ckpt._shard_file(prefix, 0, rank, 4)),
                processes=manifest["processes"],
                spanning=sum(len(e["pieces"]) == 4
                             for e in manifest["params"].values()))


def mesh4_rank_main(outdir):
    """One rank of phase 25's four, spawned by ``python -m mxnet_tpu_torch.
    tools.launch -n 4`` (``chip_smoke.py mesh4-rank DIR``) on gpu(0): (a)
    over {"dp": 2, "sp": 2}, (b) over {"dp": 2, "tp": 2}; readings to
    DIR/rank<r>.json, rank 0's SGD-step weights to DIR/sgd4.npz, every
    rank's ReLU masks to DIR/masks4.rank<r>.npz."""
    import traceback
    rank = int(os.environ["DMLC_WORKER_ID"])
    log = open(os.path.join(outdir, "rank%d.log" % rank), "w")

    def say(line):
        log.write(line + "\n")
        log.flush()
        print(line, flush=True)
    res = {"rank": rank}
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import parallel as par
        tfa = importlib.import_module(
            "mxnet_tpu_torch.parallel.flash_attention")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ctx = mx.gpu(0)
        net = mesh_net(mx, ctx)
        init = mesh_host(net)
        x, y = mesh_tokens(MESH_BATCH)
        tokens, labels = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        # (a) {dp: 2, sp: 2}
        mesh = par.create_mesh({"dp": 2, "sp": 2})
        res["backend"] = par.distributed.backend()
        tr = mesh4_trainer(mx, par, net, init, ctx, mesh)
        res["a"] = mesh4_steps(mx, tfa, tr, tokens, labels)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        tr = mesh4_trainer(mx, par, net, init, ctx, mesh, "sgd",
                           dict(learning_rate=MESH_SGD_LR))
        res["a"]["sgd_loss"] = float(tr.fit_batch(tokens, labels).asscalar())
        tr.sync_gluon_params()
        if rank == 0:
            np.savez(os.path.join(outdir, "sgd4.npz"), **mesh_host(net))
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        mesh_rank_masks(mx, par, net, init, ctx, tokens, mesh, outdir, rank,
                        "masks4")
        a = res["a"]
        say("(a) rank %d {dp: 2, sp: 2}: loss %s, %.1f ms a step (sync %.1f),"
            " peak %.2f GB, staged %.1f MB, launches %s"
            % (rank, a["curve"], statistics.median(a["step_ms"][1:]),
               statistics.median(a["sync_ms"][1:]), a["peak_gb"],
               a["staged"] / 1e6, a["launches"]))
        # (b) {dp: 2, tp: 2}
        mesh = par.create_mesh({"dp": 2, "tp": 2})
        tr = mesh4_trainer(mx, par, net, init, ctx, mesh)
        res["b"] = mesh4_steps(mx, tfa, tr, tokens, labels)
        rules = par.ShardingRules(mesh)
        res["b"]["rules_bytes"] = int(sum(
            rules.plan(n, tuple(p.shape)).bytes_per_device("float32", mesh)
            for n, p in net.collect_params().items()))
        res["b"]["pieces"] = sorted({str(list(pl.spec))
                                     for pl in tr._param_plans})
        res["b"]["ckpt"] = mesh4_checkpoint(mx, par, tr, net, init, ctx, mesh,
                                            tokens, labels, outdir, rank)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        b = res["b"]
        say("(b) rank %d {dp: 2, tp: 2}: loss %s, %.1f ms a step (sync %.1f),"
            " peak %.2f GB, parameters %.1f MB a rank (the rules' %.1f MB),"
            " staged %.1f MB, launches %s"
            % (rank, b["curve"], statistics.median(b["step_ms"][1:]),
               statistics.median(b["sync_ms"][1:]), b["peak_gb"],
               b["param_bytes"] / 1e6, b["rules_bytes"] / 1e6,
               b["staged"] / 1e6, b["launches"]))
        par.distributed.barrier()
        say("rank %d done" % rank)
    except Exception:                            # noqa: BLE001
        res["error"] = traceback.format_exc()
        say(res["error"])
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    log.close()
    return 1 if "error" in res else 0


def dry_piece(value, name, sizes, rank):
    """Rank ``rank``'s piece of a whole dryrun array (ranks row-major over
    the mesh's dp, pp, tp, sp)."""
    from mxnet_tpu_torch import dryrun
    coords = dict(zip(sizes, np.unravel_index(rank, tuple(sizes.values()))))
    out = value
    for d, ax in enumerate(dryrun.SPECS[name]):
        if ax is not None:
            step = value.shape[d] // sizes[ax]
            out = out.narrow(d, coords[ax] * step, step)
    return out


def dry_twin(run, outdir):
    """The one-process twin of one dryrun on the card (plain attention),
    held to every rank's loss and updated shards; returns the readings."""
    from mxnet_tpu_torch import dryrun
    sizes = dryrun.mesh_sizes(DRY_RANKS, run["degenerate"])
    dims = dryrun.jax_dims(sizes, run.get("width"))
    host = dryrun.init_host(sizes, dims)
    dev = torch.device("cuda", 0)
    t = {n: torch.from_numpy(v).to(dev) for n, v in host.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, new, grads, _ = dryrun.dryrun_step(
        {n: t[n] for n in dryrun.PARAMS}, t["x"], t["y"], None, dims,
        plain=True)
    torch.cuda.synchronize()
    rec = dict(loss=loss, ms=(time.perf_counter() - t0) * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               sizes=sizes, dims=dims, worst=0.0, worst_name="",
               grad_worst=0.0, grad_worst_name="", over=[],
               param_bytes=sum(host[n].nbytes for n in dryrun.PARAMS))
    for r in range(DRY_RANKS):
        with np.load(os.path.join(outdir, "%s.rank%d.npz"
                                  % (run["tag"], r))) as f:
            for n in dryrun.PARAMS:
                want = dry_piece(new[n], n, sizes, r).cpu().numpy()
                bound = DRY_ATOL + DRY_RTOL * float(new[n].abs().max())
                err = float(np.abs(f[n] - want).max())
                if err / bound > rec["worst"]:
                    rec["worst"], rec["worst_name"] = err / bound, n
                if err > bound:
                    rec["over"].append((r, n, err, bound))
                g = dry_piece(grads[n], n, sizes, r).cpu().numpy()
                ratio = float(np.abs(f["grad_" + n] - g).max()
                              / max(float(grads[n].abs().max()), 1e-30))
                if ratio > rec["grad_worst"]:
                    rec["grad_worst"], rec["grad_worst_name"] = ratio, n
    del t, new, grads
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_mesh_axes(card, tfa, mesh24):
    """Phase 25: the twenty-first slice, every mesh axis. (a) and (b) on
    four ranks, (c) and (d) on eight (the module docstring); returns (b)'s
    flash launch counts on rank 0."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dryrun
    t_phase = time.perf_counter()
    twin = mesh24["twin"]
    L, T = GPT2_SMALL["n_layers"], GPT2_SMALL["max_len"]
    outdir = tempfile.mkdtemp(prefix="mesh4_")
    try:
        ranks, secs = kv_launch(outdir, "mesh4-rank", MESH4_RANKS,
                                MESH4_LAUNCH_TIMEOUT)
        sgd = mesh_sgd_grads(twin, outdir, fname="sgd4.npz")
        shared_grad, flips = mesh_twin_shared(
            mx, mx.gpu(0), twin["init"],
            mesh_masks(outdir, "masks4", MESH4_RANKS,
                       lambda r: divmod(r, 2)))
        shared = mesh_sgd_grads(twin, outdir, shared_grad, "sgd4.npz")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    a = [r["a"] for r in ranks]
    b = [r["b"] for r in ranks]
    print("  four ranks (%s, %.1f s of launch), phase 24's LM (%.1fM "
          "parameters, seed 0), global batch %d x %d, Adam lr %g, %d steps, "
          "ZeRO-1 and FSDP over dp (%s):"
          % (ranks[0]["backend"], secs, twin["n_params"] / 1e6, MESH_BATCH,
             T, MESH_ADAM["learning_rate"], MESH4_STEPS, card))
    for name, recs in (("(a) {dp: 2, sp: 2}", a), ("(b) {dp: 2, tp: 2}", b)):
        for r, rec in enumerate(recs):
            print("    %s rank %d: loss %s; %.1f ms a step (median of steps "
                  "2-%d; sync %.1f ms), peak %.2f GB, gloo-staged %.1f MB "
                  "over the steps, parameters %.1f MB a rank (%.4f of the "
                  "twin's %.1f MB), Adam state %.1f MB; flash launches %s"
                  % (name, r, " ".join("%.4f" % c for c in rec["curve"]),
                     statistics.median(rec["step_ms"][1:]), MESH4_STEPS,
                     statistics.median(rec["sync_ms"][1:]), rec["peak_gb"],
                     rec["staged"] / 1e6, rec["param_bytes"] / 1e6,
                     rec["param_bytes"] / twin["param_bytes"],
                     twin["param_bytes"] / 1e6, rec["state_bytes"] / 1e6,
                     rec["launches"]))
    sgd_over = [n for n, v in sgd.items()
                if v > (GRAD_RTOL_RELU if n.endswith("ffn1.weight")
                        else GRAD_RTOL)]
    print("  (a) step 1 against phase 24's twin: loss %.6f / %.6f before, "
          "%.6f / %.6f after (tolerance %g); one SGD step (lr %g, loss %.6f):"
          " the exchanged gradient against the twin's, max|diff| / max|grad|"
          " worst %.3g (%s), median %.3g (tolerance %g, ffn1 weights %g); "
          "with the ranks' ReLU masks (rows x sequence halves; %d sign "
          "flips) worst %.3g (%s), median %.3g (tolerance %g); %s"
          % (a[0]["curve"][0], twin["loss"], a[0]["curve"][1], twin["loss2"],
             LOSS_ATOL, MESH_SGD_LR, a[0]["sgd_loss"], max(sgd.values()),
             max(sgd, key=sgd.get), statistics.median(sgd.values()),
             GRAD_RTOL, GRAD_RTOL_RELU, sum(flips), max(shared.values()),
             max(shared, key=shared.get), statistics.median(shared.values()),
             GRAD_RTOL_SHARED, card))
    print_groups(shared)
    ref = mesh24["curve"][:MESH4_STEPS]
    same = all(rec["curve"] == ref for rec in b)
    worst_b = max(abs(c - w) for rec in b for c, w in zip(rec["curve"], ref))
    print("  (b) losses against phase 24 (a)'s {dp: 2} run: %s (largest "
          "difference %.3g; pieces %s); parameter bytes a rank %d, the rules'"
          " %d" % ("bit for bit" if same else "NOT bit for bit", worst_b,
                   b[0]["pieces"], b[0]["param_bytes"], b[0]["rules_bytes"]))
    for r, rec in enumerate(a):
        if rec["curve"] != a[0]["curve"] or not all(np.isfinite(rec["curve"])) \
                or not rec["curve"][-1] < rec["curve"][0]:
            fail("(a) rank %d: the loss did not fall or differs across ranks:"
                 " %s" % (r, rec["curve"]))
        if any(rec["launches"].values()):
            fail("(a) rank %d: the ring route launched flash kernels: %s"
                 % (r, rec["launches"]))
    if abs(a[0]["curve"][0] - twin["loss"]) > LOSS_ATOL \
            or abs(a[0]["curve"][1] - twin["loss2"]) > LOSS_ATOL:
        fail("(a) step 1 is outside its tolerance of the twin")
    if sgd_over or max(shared.values()) > GRAD_RTOL_SHARED:
        fail("(a) the exchanged gradient is outside its tolerances: %s, "
             "shared worst %.3g" % (sgd_over, max(shared.values())))
    if worst_b > LOSS_ATOL:
        fail("(b) the losses are outside LOSS_ATOL of the {dp: 2} run's")
    for r, rec in enumerate(b):
        ck = rec["ckpt"]
        print("    phase 27 (d) rank %d: (b)'s {dp: 2, tp: 2} FSDP state saved in %.1f "
              "ms (%.1f MB this rank's shard; %d entries as 4 pieces, "
              "processes %d), loaded by a fresh trainer in %.1f ms; one more "
              "step: loss %.6f running, %.6f fresh, pieces and Adam state "
              "%s (%s)" % (r, ck["save_ms"], ck["bytes"] / 1e6, ck["spanning"],
                           ck["processes"], ck["load_ms"], ck["loss"],
                           ck["loss_fresh"], "bit for bit" if ck["same"]
                           else "DIFFERENT", card))
        if not ck["same"] or ck["loss"] != ck["loss_fresh"] \
                or ck["processes"] != MESH4_RANKS or not ck["spanning"]:
            fail("phase 27 (d) rank %d: the 2-D checkpoint did not "
                 "round-trip: %s"
                 % (r, ck))
        if rec["param_bytes"] != rec["rules_bytes"]:
            fail("(b) rank %d: %d parameter bytes, the rules give %d"
                 % (r, rec["param_bytes"], rec["rules_bytes"]))
        for kname in TRAIN_KERNELS:
            if rec["launches"][kname] != L * MESH4_STEPS:
                fail("(b) rank %d: %s launched %d times in %d steps, want %d "
                     "a step" % (r, kname, rec["launches"][kname],
                                 MESH4_STEPS, L))
    # (c) and (d): the dryrun step over eight ranks
    runs = [dict(tag="%s_%s" % (kind, deg), n=DRY_RANKS, degenerate=deg,
                 width=width)
            for kind, width in (("c", None), ("d", DRY_WIDTH))
            for deg in ("pp", "tp")]
    outdir = tempfile.mkdtemp(prefix="dryrun_")
    try:
        t0 = time.perf_counter()
        dranks = dryrun.launch_runs(DRY_RANKS, runs, "cuda:0", outdir,
                                    DRY_LAUNCH_TIMEOUT)
        secs = time.perf_counter() - t0
        twins = [dry_twin(run, outdir) for run in runs]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    print("  eight ranks (%s, %.1f s of launch with the four steps), "
          "dryrun_multichip's step, one SGD step at lr %g (%s):"
          % (dranks[0]["backend"], secs, dryrun.LR, card))
    for k, (run, tw) in enumerate(zip(runs, twins)):
        recs = [r["runs"][k] for r in dranks]
        print("    (%s) %s %s: B%d T%d D%d H%d F%d E%d n_micro %d, %.2fM "
              "parameters; loss %.7f, the twin's %.7f (rel %.3g, tolerance "
              "%g); updated shards worst %.3g of the bound (%s; bound %g + "
              "%g max|w|), gradients worst %.3g of max|g| (%s); twin %.1f ms, "
              "peak %.2f GB" % (run["tag"][0], run["tag"], tw["sizes"],
                            *(tw["dims"][x] for x in ("B", "T", "D", "H",
                                                      "F", "E", "n_micro")),
                            tw["param_bytes"] / 4e6, recs[0]["loss"],
                            tw["loss"],
                            abs(recs[0]["loss"] - tw["loss"]) / abs(tw["loss"]),
                            DRY_LOSS_RTOL, tw["worst"], tw["worst_name"],
                            DRY_ATOL, DRY_RTOL, tw["grad_worst"],
                            tw["grad_worst_name"], tw["ms"],
                            tw["peak_gb"]))
        for r, rec in enumerate(recs):
            print("      rank %d: %.1f ms a step (sync %.1f), peak %.2f GB, "
                  "gloo-staged %.2f MB, parameters %.3f of the whole, flash "
                  "launches %s" % (r, rec["ms"], rec["sync_ms"],
                                   rec["peak_gb"] or 0.0,
                                   rec["staged_bytes"] / 1e6,
                                   rec["param_bytes"] / tw["param_bytes"],
                                   rec["launches"]))
        if any(abs(rec["loss"] - tw["loss"]) > DRY_LOSS_RTOL * abs(tw["loss"])
               for rec in recs) or tw["over"]:
            fail("(%s) the dryrun is outside its tolerance of the twin: %s"
                 % (run["tag"], tw["over"][:4]))
        if any(any(rec["launches"].values()) for rec in recs):
            fail("(%s) the dryrun launched flash kernels" % run["tag"])
    print("  phase 25 launches none of the kernel table's rows in (a), (c) "
          "and (d) (zeroed counters, read 0); (b) launches the flash kernels "
          "%s on rank 0; mesh axes phase %.1f s"
          % (b[0]["launches"], time.perf_counter() - t_phase))
    return dict(tp_launches=b[0]["launches"])


# ---------------------------------------------------------------------------
# phase 26: the deploy and serve path
# ---------------------------------------------------------------------------

# (a) ResNet-50 v1 as phase 13 builds it at the reference's size, exported
# with one program a bucket and served: 8 clients x 8 requests from
# seed 1; each answer against the hybridized net on its sample alone
# (the example's tolerance) and bit for bit against the Predictor's
# program at the bucket it ran in; the drills' queue bound and burst
SERVE_BUCKETS = [1, 32]             # (cut from six: phase 27's time; from
                                    # [1, 8, 32]: the slower hosts' time)
SERVE_IMAGE = 224
SERVE_CLASSES = 1000
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 8                # (cut from 32: phase 28's time;
                                    # from 16: phase 31's)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
SHED_QUEUE = 4
SHED_BURST = 64
DEADLINE_HANG_S = "0.2"
# (b) examples/serve_artifact.py's convnet exported on the CPU (a CPU-only
# subprocess) and on the card, both served on the card
CONVNET_BUCKETS = [1, 8]            # (cut from [1, 2, 4, 8]: phase 31's
                                    # time)
CONVNET_REQUESTS = 16               # (cut from 32: phase 31's time)
PORTABLE_TOL = dict(rtol=1e-5, atol=1e-6)
# (c) phase 10's LM as an in-process callable: 8 requests of 100-256
# tokens from seed 2; per position (max logit, argmax) against the model
# alone on the request (cut from ladder [1, 2, 4, 8] x seq [256, 1024]
# and 32 requests of 100-1024 tokens: phase 28 (a) serves the LM at T
# 1024 from an artifact)
LM_SERVE_LADDER = [1, 8]
LM_SERVE_SEQ = [256]
LM_SERVE_REQUESTS = 8               # (cut from 16: phase 31's time)
LM_SERVE_LENGTHS = (100, 256)
LM_SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
# (d) phase 14's Module.fit under MXNET_COMPILE_WATCH=1
WATCH_STEPS = 3                     # (cut from 5: phase 31's time)
WATCH_FLOPS_REL = 0.01
WATCH_MFU_REL = 1e-3


def convnet_export(mx, path, ctx):
    """examples/serve_artifact.py's convnet and weights (seed 0) on
    ``ctx``, exported with one program a bucket of CONVNET_BUCKETS."""
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, name="conv1", kernel=(3, 3),
                           num_filter=8, pad=(1, 1))
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = mx.sym.Flatten(h)
    out = mx.sym.FullyConnected(h, name="fc", num_hidden=10)
    rs = np.random.RandomState(0)
    params = {
        "conv1_weight": mx.nd.array(rs.randn(8, 3, 3, 3) * 0.1, ctx=ctx),
        "conv1_bias": mx.nd.zeros((8,), ctx=ctx),
        "fc_weight": mx.nd.array(rs.randn(10, 8 * 16 * 16) * 0.01,
                                 ctx=ctx),
        "fc_bias": mx.nd.zeros((10,), ctx=ctx),
    }
    mx.deploy.export_compiled(out, path, params=params,
                              input_shapes={"data": (1, 3, 32, 32)},
                              batch_sizes=CONVNET_BUCKETS)
    return path


def export_cpu_main(outdir):
    """``chip_smoke.py export-cpu DIR``: the CPU exports, run in a process
    that sees no CUDA device: (b)'s convnet (``DIR/convnet-cpu.mxp``) and
    phase 28 (b)'s attention graph (``DIR/att-cpu.mxp``), one process
    start for both."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    if torch.cuda.is_available():
        print("export-cpu: a CUDA device is visible")
        return 1
    for name, export in (("convnet-cpu.mxp", convnet_export),
                         ("att-cpu.mxp", attention_export)):
        path = os.path.join(outdir, name)
        export(mx, path, mx.cpu())
        print("export-cpu: %s, %d bytes" % (path, os.path.getsize(path)))
    return 0


@contextlib.contextmanager
def timing_calls(module, names):
    """``{name: [s a call]}`` of ``module``'s functions ``names`` over
    the block (each wrapped, then restored)."""
    spent = {n: [] for n in names}
    orig = {n: getattr(module, n) for n in names}

    def timed_fn(n):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig[n](*a, **kw)
            finally:
                spent[n].append(time.perf_counter() - t0)
        return call
    for n in names:
        setattr(module, n, timed_fn(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(module, n, orig[n])


def serve_traffic(srv, samples, clients):
    """``clients`` threads each submit their share of ``samples`` (each
    one array, or a tuple of one array per input; with backpressure:
    ``block=True``), then wait for them. Returns the
    futures in sample order and the traffic's wall seconds."""
    futs = [None] * len(samples)
    errors = []
    per = len(samples) // clients

    def client(c):
        try:
            mine = range(c * per, (c + 1) * per)
            for i in mine:
                sample = samples[i] if isinstance(samples[i], tuple) \
                    else (samples[i],)
                futs[i] = srv.submit(*sample, block=True)
            for i in mine:
                futs[i].result(timeout=300)
        except Exception as exc:            # noqa: BLE001
            errors.append(repr(exc))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail("serve: client errors %s" % errors[:3])
    return futs, wall


def program_graphs(srv, device="cuda:0"):
    """``{key: graph holder}`` of a server's programs on ``device``."""
    return {key: fn.graphs for (dev, key), fn in srv._programs.items()
            if dev == device}


def serve_drills(mx, pred, card):
    """(a)'s shed drill (a burst of SHED_BURST into a queue of SHED_QUEUE)
    and deadline drill (a planned hang at ``serve_dispatch``: every queued
    request fails with RequestTimeoutError)."""
    from mxnet_tpu_torch import fault, serving
    x = np.zeros((3, SERVE_IMAGE, SERVE_IMAGE), np.float32)
    with serving.InferenceServer(pred, ladder=[SERVE_BUCKETS[-1]],
                                 max_queue=SHED_QUEUE, batch_window_ms=2.0,
                                 name="shed") as srv:
        srv.warmup()
        shed, futs = 0, []
        for _ in range(SHED_BURST):
            try:
                futs.append(srv.submit(x))
            except serving.ServerOverloadedError:
                shed += 1
        for f in futs:
            f.result(timeout=120)
        st = srv.stats()
    if shed < 1 or st["shed"] != shed or st["completed"] != len(futs) \
            or st["queue_peak"] > SHED_QUEUE:
        fail("serve: shed drill: %d shed by the client, stats %s"
             % (shed, st))
    print("  (a) shed drill: burst of %d into max_queue %d: %d shed "
          "(ServerOverloadedError), %d served, queue peak %d (bound %d)"
          % (SHED_BURST, SHED_QUEUE, shed, st["completed"],
             st["queue_peak"], SHED_QUEUE))
    with env_set("MXNET_FAULT_PLAN", "serve_dispatch:step=1:hang:count=2"), \
            env_set("MXNET_FAULT_HANG_SECONDS", DEADLINE_HANG_S):
        fault.reset()
        try:
            srv = serving.InferenceServer(pred, ladder=[1], max_queue=16,
                                          batch_window_ms=0.0,
                                          name="deadline")
            srv.warmup()
            futs = [srv.submit(x, deadline_ms=1) for _ in range(3)]
            timed_out = 0
            for f in futs:
                try:
                    f.result(timeout=60)
                except serving.RequestTimeoutError:
                    timed_out += 1
            st = srv.stats()
            srv.stop()
        finally:
            fault.reset()
        fault.reset()
    if timed_out != 3 or st["timeouts"] != 3 or st["completed"] != 0 \
            or st["dispatch_faults"] < 1:
        fail("serve: deadline drill: %d timed out, stats %s"
             % (timed_out, st))
    print("  (a) deadline drill: MXNET_FAULT_PLAN hang %s s at "
          "serve_dispatch: %d of 3 queued requests failed with "
          "RequestTimeoutError, %d served, %d dispatch faults"
          % (DEADLINE_HANG_S, timed_out, st["completed"],
             st["dispatch_faults"]))


def serve_resnet(mx, card, bench_ms):
    """(a): ResNet-50 v1 exported, loaded and served on the card."""
    import tempfile
    from mxnet_tpu_torch import compile_watch, serving
    net = resnet_net(mx, 50, 1, SERVE_IMAGE, SERVE_CLASSES)
    net.hybridize()
    shape = (1, 3, SERVE_IMAGE, SERVE_IMAGE)
    net(mx.nd.zeros(shape))                 # the graph export reads
    tmp = tempfile.mkdtemp(prefix="mxt-serve-")
    path = os.path.join(tmp, "resnet50.mxp")
    t0 = time.perf_counter()
    with timing_calls(torch.export, ("export", "save")) as spent:
        mx.deploy.export_compiled(net, path, input_shapes={"data0": shape},
                                  batch_sizes=SERVE_BUCKETS)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = mx.deploy.load_compiled(path)
    load_s = time.perf_counter() - t0
    meta = pred.meta
    size = os.path.getsize(path)
    print("  (a) ResNet-50 v1 (%d classes, 3x%dx%d, seed 0) exported on the "
          "card: %.2f s for %d buckets; s a bucket: torch.export.export %s, "
          "torch.export.save %s; artifact %d bytes (programs %s bytes, "
          "weights once: %d bytes); loaded on %s in %.2f s; program devices "
          "%s (%s)"
          % (SERVE_CLASSES, SERVE_IMAGE, SERVE_IMAGE, export_s,
             len(SERVE_BUCKETS),
             [round(t, 2) for t in spent["export"]],
             [round(t, 2) for t in spent["save"]], size,
             [p["length"] for p in meta["programs"]],
             meta["weights"]["length"], pred.device, load_s,
             sorted(pred.program_devices()), card))
    if pred.program_devices() != {"cuda:0"} or \
            pred.batch_sizes != SERVE_BUCKETS:
        fail("serve: the loaded artifact: devices %s, buckets %s"
             % (pred.program_devices(), pred.batch_sizes))
    compile_watch.enable()
    srv = serving.InferenceServer(pred, max_queue=64, batch_window_ms=2.0)
    t0 = time.perf_counter()
    n = srv.warmup()
    warm_s = time.perf_counter() - t0
    warm = compile_watch.site_stats("serving")
    graphs = program_graphs(srv)
    want_sites = {"serving:b%d" % b for b in SERVE_BUCKETS}
    if n != len(SERVE_BUCKETS) or set(warm) != want_sites or \
            any(s["count"] != 1 for s in warm.values()):
        fail("serve: warmup readied %d programs, sites %s" % (n, warm))
    print("  (a) warmup: %d programs captured in %.2f s; capture ms by "
          "bucket %s"
          % (n, warm_s, {b: round(warm["serving:b%d" % b]["total_s"] * 1e3,
                                  1) for b in SERVE_BUCKETS}))
    replays0 = sum(g.replays for g in graphs.values())
    rs = np.random.RandomState(1)
    xs = rs.randn(SERVE_CLIENTS * SERVE_PER_CLIENT, 3, SERVE_IMAGE,
                  SERVE_IMAGE).astype(np.float32)
    futs, wall = serve_traffic(srv, xs, SERVE_CLIENTS)
    st = srv.stats()
    srv.stop()
    after = compile_watch.site_stats("serving")
    traffic_replays = sum(g.replays for g in graphs.values()) - replays0
    recaptures = sum(g.recaptures for g in graphs.values())
    compiles_in_traffic = sum(after[s]["count"] - warm[s]["count"]
                              for s in warm)
    print("  (a) traffic: %d clients x %d requests in %.3f s: %.1f "
          "requests/s; latency ms p50 %.2f p99 %.2f; occupancy %.3f; "
          "batches by bucket %s; replays %d = batches %d; compiles during "
          "traffic %d (bound 0), recaptures %d (bound 0) (%s)"
          % (SERVE_CLIENTS, SERVE_PER_CLIENT, wall, len(xs) / wall,
             st["latency_ms"]["p50"], st["latency_ms"]["p99"],
             st["occupancy"], st["buckets"], traffic_replays, st["batches"],
             compiles_in_traffic, recaptures, card))
    if st["completed"] != len(xs) or st["shed"] or st["timeouts"] or \
            set(after) != want_sites or compiles_in_traffic or recaptures \
            or traffic_replays != st["batches"]:
        fail("serve: traffic stats %s, sites %s, replays %d"
             % (st, after, traffic_replays))
    # each answer against the hybridized net on its sample alone
    worst = 0.0
    for i, f in enumerate(futs):
        want = net(mx.nd.array(xs[i:i + 1]))._data[0].cpu().numpy()
        got = f.result()
        err = float(np.max(np.abs(got - want)))
        worst = max(worst, err)
        if not np.allclose(got, want, **SERVE_TOL):
            fail("serve: request %d differs from the net alone by %g"
                 % (i, err))
    # ... and bit for bit against the Predictor's program at its bucket
    exact = 0
    with torch.inference_mode():
        for b in SERVE_BUCKETS:
            idx = [i for i, f in enumerate(futs) if f.bucket == b]
            for k in range(0, len(idx), b):
                group = idx[k:k + b]
                batch = np.zeros((b,) + xs.shape[1:], np.float32)
                batch[:len(group)] = xs[group]
                out = pred.program(b)(torch.from_numpy(batch).cuda())
                out = out.cpu().numpy()
                for row, i in enumerate(group):
                    if not np.array_equal(out[row], futs[i].result()):
                        fail("serve: request %d differs from the "
                             "Predictor's bucket-%d program" % (i, b))
                    exact += 1
    x32 = torch.from_numpy(
        xs[np.arange(SERVE_BUCKETS[-1]) % len(xs)]).cuda()
    fn = srv._programs[("cuda:0", SERVE_BUCKETS[-1])]
    with torch.inference_mode():
        replay_ms = wall_ms(lambda: fn(x32))
    print("  (a) answers vs the hybridized net alone: max abs err %.3g "
          "(rtol %g, atol %g); %d of %d bit-identical to the Predictor at "
          "their bucket; ms a batch at bucket %d by artifact replay %.3f "
          "(%.1f images/s) beside phase 13's CachedOp replay %.3f (%s)"
          % (worst, SERVE_TOL["rtol"], SERVE_TOL["atol"], exact, len(xs),
             SERVE_BUCKETS[-1], replay_ms,
             SERVE_BUCKETS[-1] * 1e3 / replay_ms, bench_ms, card))
    serve_drills(mx, pred, card)
    compile_watch.disable()
    del srv, pred, net, fn, x32
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(export_s=export_s, bytes=size, rps=len(xs) / wall,
                replay_ms=replay_ms)


def serve_portable(mx, card):
    """(b): the convnet exported in a CPU-only process serves on cuda:0,
    equal to a card export's answers; nothing of its programs stays on
    the CPU. Returns the directory of the CPU exports, which holds phase
    28 (b)'s attention artifact."""
    import tempfile
    from mxnet_tpu_torch import serving
    tmp = tempfile.mkdtemp(prefix="mxt-port-")
    cpu_path = os.path.join(tmp, "convnet-cpu.mxp")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               MXNET_DEFAULT_CONTEXT="cpu")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "export-cpu", tmp], env=env,
                         capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if res.returncode != 0:
        fail("serve: the CPU export failed: %s" % res.stderr[-2000:])
    card_path = convnet_export(mx, os.path.join(tmp, "convnet-card.mxp"),
                               mx.gpu(0))
    rs = np.random.RandomState(1)
    xs = rs.randn(CONVNET_REQUESTS, 3, 32, 32).astype(np.float32)
    outs, devs = {}, {}
    for tag, path in (("cpu", cpu_path), ("card", card_path)):
        pred = mx.deploy.load_compiled(path)
        devs[tag] = pred.program_devices()
        with serving.InferenceServer(pred, max_queue=64,
                                     batch_window_ms=2.0,
                                     name="convnet-" + tag) as srv:
            srv.warmup()
            futs, _ = serve_traffic(srv, xs, 4)
        outs[tag] = np.stack([f.result() for f in futs])
    err = float(np.max(np.abs(outs["cpu"] - outs["card"])))
    print("  (b) serve_artifact.py's convnet exported in a CPU-only process "
          "(%.1f s with its start and phase 28 (b)'s export), loaded on "
          "cuda:0: program devices %s "
          "(card export: %s); %d requests served from each, max abs diff "
          "%.3g (rtol %g, atol %g)"
          % (sub_s, sorted(devs["cpu"]), sorted(devs["card"]),
             CONVNET_REQUESTS, err, PORTABLE_TOL["rtol"],
             PORTABLE_TOL["atol"]))
    if devs["cpu"] != {"cuda:0"} or devs["card"] != {"cuda:0"}:
        fail("serve: a loaded program names another device: %s" % devs)
    if not np.allclose(outs["cpu"], outs["card"], **PORTABLE_TOL):
        fail("serve: the CPU export's answers differ from the card's by %g"
             % err)
    for name in ("convnet-cpu.mxp", "convnet-card.mxp"):
        os.remove(os.path.join(tmp, name))
    return tmp


def lm_serving_net(mx):
    """Phase 10's LM (GPT-2-small width, Xavier from seed 0 on gpu(0)),
    not hybridized, and the in-process callable over it: tokens (B, S)
    -> per position (max logit, argmax)."""
    cfg = dict(vocab=GPT2_SMALL["vocab"], layers=GPT2_SMALL["n_layers"],
               heads=GPT2_SMALL["n_heads"],
               units=GPT2_SMALL["n_heads"] * GPT2_SMALL["head_dim"],
               d_ff=GPT2_SMALL["d_ff"], max_len=GPT2_SMALL["max_len"])
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = gluon_lm(mx)(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((1, 16), ctx=ctx),
            mx.nd.array(np.arange(16, dtype=np.float32), ctx=ctx))
    NDArray = mx.nd.NDArray

    def lm(tokens):
        pos = torch.arange(tokens.shape[1], dtype=torch.float32,
                           device=tokens.device)
        logits = net(NDArray(tokens), NDArray(pos))._data
        top = logits.max(-1)
        return top.values, top.indices
    return net, lm, cfg


def lm_alone(net, mx, tokens):
    """The model alone on one request: (max logit, argmax, top-2
    margin) per position."""
    ctx = mx.gpu(0)
    with torch.inference_mode():
        logits = net(mx.nd.array(tokens[None], ctx=ctx),
                     mx.nd.array(np.arange(len(tokens), dtype=np.float32),
                                 ctx=ctx))._data[0]
        top = torch.topk(logits, 2, dim=-1).values
        return (logits.max(-1).values.cpu().numpy(),
                logits.argmax(-1).cpu().numpy(),
                (top[:, 0] - top[:, 1]).cpu().numpy())


def serve_lm(mx, card, tfa):
    """(c): the LM as an in-process callable on the server's bucket
    graphs; the flash kernel inside them."""
    from mxnet_tpu_torch import compile_watch, serving
    net, lm, cfg = lm_serving_net(mx)
    n_params = sum(p.data().size for p in net.collect_params().values())
    compile_watch.enable()
    srv = serving.InferenceServer(lm, ladder=LM_SERVE_LADDER,
                                  seq_ladder=LM_SERVE_SEQ, max_queue=64,
                                  batch_window_ms=2.0, name="lm")
    t0 = time.perf_counter()
    n = srv.warmup(np.zeros(LM_SERVE_SEQ[-1], np.float32))
    warm_s = time.perf_counter() - t0
    warm = compile_watch.site_stats("serving:lm")
    graphs = program_graphs(srv)
    n_prog = len(LM_SERVE_LADDER) * len(LM_SERVE_SEQ)
    if n != n_prog or len(warm) != n_prog or any(s["count"] != 1
                                                 for s in warm.values()):
        fail("serve: the LM's warmup readied %d programs, sites %s"
             % (n, warm))
    held = {k: g._entries[next(iter(g._entries))].launches
            for k, g in graphs.items()}
    rs = np.random.RandomState(2)
    lengths = rs.randint(LM_SERVE_LENGTHS[0], LM_SERVE_LENGTHS[1] + 1,
                         LM_SERVE_REQUESTS)
    samples = [rs.randint(0, cfg["vocab"], L).astype(np.float32)
               for L in lengths]
    replays0 = sum(g.replays for g in graphs.values())
    tfa.reset_launches()                      # the main path starts here
    futs, wall = serve_traffic(srv, samples, 4)
    launches = dict(tfa.launches)             # ... and ends here
    st = srv.stats()
    srv.stop()
    traffic_replays = sum(g.replays for g in graphs.values()) - replays0
    after = compile_watch.site_stats("serving:lm")
    per_replay = {k: v.get("flash_fwd", 0) for k, v in held.items()}
    if launches["flash_fwd"] != GPT2_SMALL["n_layers"] * traffic_replays \
            or any(v != GPT2_SMALL["n_layers"] for v in per_replay.values()) \
            or any(v for k, v in launches.items() if k != "flash_fwd") \
            or after != warm or st["completed"] != LM_SERVE_REQUESTS:
        fail("serve: the LM's launches %s over %d replays (held %s), "
             "sites %s, stats %s" % (launches, traffic_replays, per_replay,
                                     after, st))
    worst, ties = 0.0, 0
    for L, tokens, f in zip(lengths, samples, futs):
        got_max, got_arg = f.result()
        want_max, want_arg, margin = lm_alone(net, mx, tokens)
        err = float(np.max(np.abs(got_max[:L] - want_max)))
        worst = max(worst, err)
        if not np.allclose(got_max[:L], want_max, **LM_SERVE_TOL):
            fail("serve: the LM's reply of %d tokens differs from the model "
                 "alone by %g" % (L, err))
        off = got_arg[:L] != want_arg
        ties += int(off.sum())
        if (off & (margin > TIE_MARGIN)).any():
            fail("serve: the LM's argmax differs off a tie (%d positions)"
                 % int((off & (margin > TIE_MARGIN)).sum()))
    print("  (c) phase 10's LM (%.1fM parameters, not hybridized) as an "
          "in-process callable, ladder %s x seq %s: %d programs captured in "
          "%.2f s (capture ms %s); %d requests of %d-%d tokens in %.3f s: "
          "%.2f requests/s, latency ms p50 %.1f p99 %.1f, batches %s; "
          "flash_fwd launches %d = %d per replay x %d replays (held by each "
          "graph: %s); max logit max abs err %.3g vs the model alone "
          "(rtol %g, atol %g), argmax equal but %d tied positions (%s)"
          % (n_params / 1e6, LM_SERVE_LADDER, LM_SERVE_SEQ, n, warm_s,
             {k: round(v["total_s"] * 1e3, 1) for k, v in warm.items()},
             LM_SERVE_REQUESTS, LM_SERVE_LENGTHS[0], LM_SERVE_LENGTHS[1],
             wall, LM_SERVE_REQUESTS / wall, st["latency_ms"]["p50"],
             st["latency_ms"]["p99"], st["buckets"], launches["flash_fwd"],
             GPT2_SMALL["n_layers"], traffic_replays,
             sorted(set(per_replay.values())), worst,
             LM_SERVE_TOL["rtol"], LM_SERVE_TOL["atol"], ties, card))
    # a hybridized block inside a bucket's graph runs its plan there: its
    # own CachedOp captures nothing
    net.hybridize()
    L = int(lengths[0])
    with serving.InferenceServer(lm, ladder=[1], seq_ladder=[LM_SERVE_SEQ[0]
                                 if L <= LM_SERVE_SEQ[0]
                                 else LM_SERVE_SEQ[-1]],
                                 name="lm-hybridized") as hsrv:
        hsrv.warmup(np.zeros(L, np.float32))
        got_max, _ = hsrv.predict(samples[0], timeout=120)
    cop = net._cached_op.stats()
    want_max = futs[0].result()[0][:L]
    herr = float(np.max(np.abs(got_max[:L] - want_max)))
    if cop["captures"] != 0 or not np.allclose(got_max[:L], want_max,
                                               **LM_SERVE_TOL):
        fail("serve: the hybridized LM in a bucket graph: CachedOp %s, "
             "err %g" % (cop, herr))
    print("  (c) the LM hybridized, inside the server's bucket graph: its "
          "CachedOp captured %d graphs (its plan ran inside the bucket's), "
          "reply within %.3g of the unhybridized one" % (cop["captures"],
                                                         herr))
    compile_watch.disable()
    del srv, net, lm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def module_flops(sym, batch, image):
    """(forward flops, the first convolution's): 2 x the multiply-adds of
    every Convolution and FullyConnected node; the first convolution
    reads the data, whose gradient no one asks for."""
    internals = sym.get_internals()
    _, shapes, _ = internals.infer_shape(data=(batch, 3, image, image),
                                         softmax_label=(batch,))
    shape_of = dict(zip(internals.list_outputs(), shapes))
    total, first = 0, None
    for node in sym._topo_nodes():
        if node.op is not None and node.op.name in ("Convolution",
                                                    "FullyConnected"):
            out = shape_of[node.name + "_output"]
            w = shape_of[node.inputs[1][0].name]
            f = 2 * int(np.prod(out)) * int(np.prod(w[1:]))
            total += f
            if first is None and node.op.name == "Convolution":
                first = f
    return total, first


def watch_module(mx, card):
    """(d): phase 14's Module.fit (ResNet-50 v1, batch 32, 224x224, 1000
    classes) for WATCH_STEPS steps with MXNET_COMPILE_WATCH=1."""
    from mxnet_tpu_torch import compile_watch, telemetry
    batch, image, classes = MODULE_BENCH
    rs = np.random.RandomState(70)
    x = rs.randn(WATCH_STEPS * batch, 3, image, image).astype(np.float32)
    y = rs.randint(0, classes, WATCH_STEPS * batch).astype(np.float32)
    compile_watch.disable()
    with env_set("MXNET_COMPILE_WATCH", "1"):
        telemetry.start(run_id="compile-watch")
        mx.random.seed(0)
        sym = module_resnet(mx, classes)
        mod = mx.mod.Module(sym)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
                optimizer="sgd", optimizer_params=MODULE_SGD,
                initializer=mx.init.Xavier())
        summary = telemetry.stop()
    records = telemetry._last_run.records
    steps = [r for r in records if r.get("type") == "step"]
    utils = {r["seq"]: r for r in records if r.get("type") == "utilization"}
    prog = compile_watch.stats()["programs"].get("fused_step:module", {})
    fwd, first = module_flops(sym, batch, image)
    hand = 3 * fwd - first
    last = steps[-1]
    util = utils.get(last["seq"], {})
    flops = util.get("flops", 0.0)
    peak = compile_watch.peak_table()[0] \
        * compile_watch.dtype_peak_factor("float32")
    want_mfu = flops / (last["dur_ms"] / 1e3 * peak)
    print("  (d) Module.fit under MXNET_COMPILE_WATCH=1, %d steps: site "
          "fused_step:module %d compile(s) in %.1f ms, fused_step_compile_ms "
          "%.1f; flops of one step %.6g (torch's flop counter) vs the hand "
          "count %.6g (3 x forward %.6g - the first conv's %.6g: no data "
          "gradient), rel diff %.2g (bound %g); step %d: %.3f ms, MFU %.4g "
          "against %.4g TFLOP/s fp32 (TF32 off) = flops / (step s x peak) "
          "%.4g; bytes %.4g, bandwidth use %.4g (%s)"
          % (len(steps), prog.get("count", 0), prog.get("total_s", 0) * 1e3,
             summary.get("counters", {}).get("fused_step_compile_ms", 0.0),
             flops, hand, fwd, first, abs(flops - hand) / hand,
             WATCH_FLOPS_REL, last["seq"], last["dur_ms"],
             util.get("mfu", float("nan")), peak / 1e12, want_mfu,
             util.get("bytes", 0.0), util.get("bw_util", float("nan")),
             card))
    if len(steps) != WATCH_STEPS or prog.get("count") != 1 or \
            not summary.get("counters", {}).get("fused_step_compile_ms"):
        fail("compile watch: %d steps, fused_step:module %s, counters %s"
             % (len(steps), prog, summary.get("counters")))
    if abs(flops - hand) > WATCH_FLOPS_REL * hand:
        fail("compile watch: a step's flops %g vs the hand count %g"
             % (flops, hand))
    if abs(util.get("mfu", 0.0) - want_mfu) > WATCH_MFU_REL * want_mfu:
        fail("compile watch: MFU %s vs %g" % (util.get("mfu"), want_mfu))
    compile_watch.disable()
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return dict(mfu=util.get("mfu"), flops=flops, hand=hand)


def phase_serve(card, tfa, resnet_readings):
    """The twenty-second slice's main path: deploy artifacts through
    torch.export and the continuous-batching InferenceServer on CUDA
    graphs, (a)-(d) as the module docstring sets out; fp32, TF32 off.
    Returns (a)'s readings, (c)'s launches and the forward kernel's
    record at (c)'s top bucket."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    resnet = serve_resnet(mx, card,
                          resnet_readings["bench"]["hybridized"]["ms"])
    cpu_dir = serve_portable(mx, card)
    if any(tfa.launches.values()):
        fail("serve: the convnet paths launched attention kernels: %s"
             % tfa.launches)
    launches = serve_lm(mx, card, tfa)
    tfa.reset_launches()
    watch_module(mx, card)
    if any(tfa.launches.values()):
        fail("serve: the Module path launched attention kernels: %s"
             % tfa.launches)
    lm_fwd = fwd_case(tfa, LM_SERVE_LADDER[-1], LM_SERVE_SEQ[-1],
                      LM_SERVE_SEQ[-1], GPT2_SMALL["n_heads"],
                      GPT2_SMALL["head_dim"], True, False, seed=26)
    print("  attention kernel launches: none in (a), (b) and (d) (zeroed, "
          "read 0); (c) %s; serve phase %.1f s"
          % (launches, time.perf_counter() - t_phase))
    return dict(launches=launches, resnet=resnet, lm_fwd=lm_fwd,
                cpu_dir=cpu_dir)


# ---------------------------------------------------------------------------
# phase 27: multi-host fault tolerance
# ---------------------------------------------------------------------------

# (b) replays phase 24 (a)'s schedule under the supervisor, rank 1 dying
# at its FT_KILL_STEP-th step boundary in generation 0 (epoch 1's first
# step; mid epoch 1, its 4th, before FT_STEPS fell to 1), so epoch 0's
# manifest is the resume point; (c)'s heartbeat bound is the JAX wedge
# test's, and (c) runs beside (b) (its ranks mostly sleep)
FT_KILL_STEP = FT_STEPS + 1
FT_WEDGE_TIMEOUT_MS = 1500
FT_BACKOFF_S = 0.5
FT_GRACE_S = 5
FT_LAUNCH_TIMEOUT = 600


def ft_digest(host):
    """SHA-256 of each parameter's bytes: equal digests, equal bits."""
    import hashlib
    return {n: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for n, v in host.items()}


def ft_save(tr, prefix, epoch, rank, ft):
    """One epoch's checkpoint: its ms and this rank's shard bytes into
    ``ft``."""
    from mxnet_tpu_torch import checkpoint as ckpt
    t0 = time.perf_counter()
    tr.save_checkpoint(prefix, epoch)
    ft["save_ms"].append((time.perf_counter() - t0) * 1e3)
    ft["save_bytes"].append(os.path.getsize(ckpt._shard_file(
        prefix, epoch, rank, MESH_RANKS)))


def ft_rank_train(mx, par, tfa, ctx, rank, outdir, say):
    """(b) on one rank: phase 24 (a)'s trainer and schedule, resumed from
    MXNET_LAUNCH_RESUME_EPOCH when the supervisor set it."""
    from mxnet_tpu_torch import envs
    from mxnet_tpu_torch.parallel import multihost
    prefix = os.path.join(outdir, "ck")
    net = mesh_net(mx, ctx)
    x, y = mesh_tokens(MESH_BATCH)
    tokens, labels = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
    tr = par.DistributedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        par.create_mesh({"dp": MESH_RANKS}), optimizer="adam",
        optimizer_params=dict(MESH_ADAM), grad_overlap=True, param_shard=True)
    ft = dict(load_ms=None, begin=0, save_ms=[], save_bytes=[])
    resume = envs.get_int("MXNET_LAUNCH_RESUME_EPOCH")
    if resume is not None:
        t0 = time.perf_counter()
        tr.load_checkpoint(prefix, resume)
        ft["load_ms"] = (time.perf_counter() - t0) * 1e3
        ft["begin"] = resume + 1
    torch.cuda.synchronize()
    tfa.reset_launches()                  # the path starts here
    curve, step_ms = [], []
    for epoch in range(ft["begin"], FT_EPOCHS):
        for _ in range(FT_STEPS):
            t0 = time.perf_counter()
            curve.append(float(tr.fit_batch(tokens, labels).asscalar()))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        ft_save(tr, prefix, epoch, rank, ft)
        say("rank %d epoch %d: loss %s, saved in %.1f ms"
            % (rank, epoch, curve[-FT_STEPS:], ft["save_ms"][-1]))
    ft["launches"] = dict(tfa.launches)   # ... and ends here
    tr.sync_gluon_params()
    ft.update(curve=curve, step_ms=step_ms, host_lost=multihost.host_lost())
    if rank == 0:
        ft["digest"] = ft_digest(mesh_host(net))
    return ft


def ft_rank_main(outdir):
    """One rank of phase 27 (``chip_smoke.py ft-rank DIR`` under the
    launcher) on gpu(0). ``FT_MODE=train``: (b), rank 1 carrying
    ``proc_exit:step=FT_KILL_STEP:raise`` in generation 0; ``FT_MODE=
    wedge``: (c), both ranks join and place the model, then rank 1's
    heartbeat writer stalls for good (``proc_hb:step=1:stall:count=inf``,
    installed once both placed it) while both sleep. Readings to
    DIR/rank<r>.gen<g>.json."""
    import traceback
    rank = int(os.environ["DMLC_WORKER_ID"])
    gen = int(os.environ.get("MXNET_LAUNCH_RESTART", "0") or 0)
    mode = os.environ["FT_MODE"]
    # the plan lands before the package import (the join visits fault
    # sites, which latches the plan)
    if mode == "train" and rank == 1 and gen == 0:
        os.environ["MXNET_FAULT_PLAN"] = "proc_exit:step=%d:raise" \
            % FT_KILL_STEP
    log = open(os.path.join(outdir, "rank%d.gen%d.log" % (rank, gen)), "w")

    def say(line):
        log.write(line + "\n")
        log.flush()
        print(line, flush=True)
    res = {"rank": rank, "gen": gen}
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import fault, parallel as par
        tfa = importlib.import_module(
            "mxnet_tpu_torch.parallel.flash_attention")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ctx = mx.gpu(0)
        if mode == "wedge":
            mesh_net(mx, ctx)
            torch.cuda.synchronize()
            say("FT_WEDGE_PLACED rank %d" % rank)
            par.distributed.barrier("ft/placed")
            if rank == 1:
                # the wedge from the next writer tick on: the process
                # lives, its beat stops
                os.environ["MXNET_FAULT_HANG_SECONDS"] = "600"
                fault.set_plan("proc_hb:step=1:stall:count=inf")
            time.sleep(120)       # rank 0's monitor ends the job first
            say("FT_WEDGE_SLEPT_THROUGH rank %d" % rank)
        else:
            res.update(ft_rank_train(mx, par, tfa, ctx, rank, outdir, say))
        say("rank %d generation %d done" % (rank, gen))
    except Exception:                            # noqa: BLE001
        res["error"] = traceback.format_exc()
        say(res["error"])
    with open(os.path.join(outdir, "rank%d.gen%d.json" % (rank, gen)),
              "w") as f:
        json.dump(res, f)
    log.close()
    return 1 if "error" in res else 0


def ft_start(outdir, mode, flags=(), **env_extra):
    """Starts ``python -m mxnet_tpu_torch.tools.launch -n 2 [flags]
    chip_smoke.py ft-rank DIR``, its output to DIR/launch.out; returns
    (process, start time)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env.update(PYTHONPATH=here + os.pathsep + env.get("PYTHONPATH", ""),
               FT_MODE=mode)
    env.update({k: str(v) for k, v in env_extra.items()})
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(MESH_RANKS)] + list(flags) + [
        sys.executable, os.path.abspath(__file__), "ft-rank", outdir]
    with open(os.path.join(outdir, "launch.out"), "w") as sink:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=sink,
                                stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def ft_wait(outdir, started):
    """(exit code, output, seconds) of an :func:`ft_start` launch; a launch
    past FT_LAUNCH_TIMEOUT is killed (code "timeout")."""
    proc, t0 = started
    try:
        rc = proc.wait(timeout=max(FT_LAUNCH_TIMEOUT - (time.perf_counter()
                                                        - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    secs = time.perf_counter() - t0
    with open(os.path.join(outdir, "launch.out")) as f:
        return rc, f.read(), secs


def ft_ranks(outdir, gen, rc, text, what):
    """Generation ``gen``'s rank readings; fails the phase, with the
    launch's last lines, if it or a rank failed."""
    ranks = []
    for r in range(MESH_RANKS):
        path = os.path.join(outdir, "rank%d.gen%d.json" % (r, gen))
        ranks.append(json.load(open(path)) if os.path.exists(path)
                     else {"error": "rank %d wrote no result" % r})
    if rc != 0 or any("error" in r for r in ranks):
        for r in range(MESH_RANKS):
            print("  rank %d: %s" % (r, ranks[r].get("error", "")))
        print("  the launch's output:\n%s" % text[-4000:])
        fail("%s: the launched ranks failed (launcher exit %s)" % (what, rc))
    return ranks


def phase_fault_tolerance(card, mesh24):
    """Phase 27: the twenty-third slice, multi-host fault tolerance (the
    module docstring): (a) is phase 24 (a)'s run (``mesh24["ft"]``), (b)
    and (c) run here, side by side. Returns (b)'s flash launch counts on
    rank 0 in its second generation."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import checkpoint as ckpt
    t_phase = time.perf_counter()
    L = GPT2_SMALL["n_layers"]
    a = mesh24["ft"]
    root = tempfile.mkdtemp(prefix="ft_")
    try:
        bdir, cdir = os.path.join(root, "b"), os.path.join(root, "c")
        os.makedirs(bdir)
        os.makedirs(cdir)
        events = os.path.join(bdir, "events.jsonl")
        b_run = ft_start(
            bdir, "train", ["--supervise", "--resume-prefix",
                            os.path.join(bdir, "ck"), "--events-file",
                            events], MXNET_HB_TIMEOUT_MS=FT_HB_TIMEOUT_MS,
            MXNET_LAUNCH_BACKOFF=FT_BACKOFF_S, MXNET_LAUNCH_GRACE=FT_GRACE_S)
        c_run = ft_start(cdir, "wedge", MXNET_HB_DIR=os.path.join(cdir, "hb"),
                         MXNET_HB_TIMEOUT_MS=FT_WEDGE_TIMEOUT_MS,
                         MXNET_LAUNCH_GRACE=2)
        rc_c, text_c, c_s = ft_wait(cdir, c_run)
        rc, text_b, b_s = ft_wait(bdir, b_run)
        b = ft_ranks(bdir, 1, rc, text_b, "(b) supervised")
        gen0 = []
        for r in range(MESH_RANKS):
            path = os.path.join(bdir, "rank%d.gen0.json" % r)
            gen0.append(json.load(open(path)).get("error", "")
                        if os.path.exists(path) else "")
        with open(events) as f:
            recs = [json.loads(line) for line in f]
        last = ckpt.latest_manifest_epoch(os.path.join(bdir, "ck"))
        manifest = ckpt.load_manifest(os.path.join(bdir, "ck"), last)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    false_losses = text_b.count("HostLostError")
    kinds = [r["kind"] for r in recs]
    by = {k: [r for r in recs if r["kind"] == k] for k in set(kinds)}
    print("  (a) phase 24 (a)'s run (%.1f s of launch): 2 ranks, {dp: 2}, "
          "ZeRO-1 and FSDP, Adam lr %g, %d epochs of %d steps on the global "
          "batch %d x %d, a checkpoint each epoch, the heartbeat armed "
          "(timeout %d ms): %.1f ms a step (median); save %s ms, %s MB "
          "a rank (%s)"
          % (mesh24["ft_s"], MESH_ADAM["learning_rate"], FT_EPOCHS, FT_STEPS,
             MESH_BATCH, GPT2_SMALL["max_len"], FT_HB_TIMEOUT_MS,
             statistics.median(a[0]["step_ms"]),
             [[round(v, 1) for v in r["save_ms"]] for r in a],
             [[round(v / 1e6, 1) for v in r["save_bytes"]] for r in a], card))
    want = ["launch", "worker_failed", "teardown", "restart", "launch",
            "success"]
    if kinds != want:
        fail("(b) the supervisor's events are %s, want %s" % (kinds, want))
    failed, relaunch = by["worker_failed"][0], by["launch"][1]
    print("  (b) supervised (%.1f s of launch, beside (c)): rank %d exited %s "
          "at step boundary %d in generation 0, %.3f s after the "
          "launch; teardown %.3f s, backoff %.1f s; detection to relaunch "
          "%.3f s (the resume scan validates the manifests); resumed from "
          "epoch %s; load %.1f ms; %.1f ms a step after the restart "
          "(median; (a)'s %.1f); save %s ms, %s MB a rank; last manifest "
          "epoch %s, processes %s; launches %s (%s)"
          % (b_s, failed["rank"], failed["code"], FT_KILL_STEP,
             failed["detect_s"], by["teardown"][0]["teardown_s"],
             by["restart"][0]["backoff_s"], relaunch["t"] - failed["t"],
             relaunch["resume_epoch"], b[0]["load_ms"] or float("nan"),
             statistics.median(b[0]["step_ms"]),
             statistics.median(a[0]["step_ms"]),
             [[round(v, 1) for v in r["save_ms"]] for r in b],
             [[round(v / 1e6, 1) for v in r["save_bytes"]] for r in b],
             last, manifest.get("processes"), b[0]["launches"], card))
    same = a[0]["digest"] == b[0]["digest"]
    print("  (b) final weights against (a): %s (%d parameters by SHA-256); "
          "the resumed losses %s, (a)'s %s; false host losses in (a) and "
          "(b): %d (bound 0)"
          % ("bit for bit" if same else "DIFFERENT", len(a[0]["digest"]),
             b[0]["curve"], a[0]["curve"][FT_STEPS:], false_losses))
    stale = re.search(r"rank 1 heartbeat stale for ([0-9.]+)s", text_c)
    placed = text_c.count("FT_WEDGE_PLACED")
    print("  (c) wedged host: both ranks placed the model (%d), then rank "
          "1's heartbeat writer stalled for good; launcher exit %s (want "
          "%d) in %.1f s; stall to detection %s s against "
          "MXNET_HB_TIMEOUT_MS %d (two strikes of the 200 ms sweep); "
          "HostLostError in the output: %s"
          % (placed, rc_c, 43, c_s, stale.group(1) if stale else "?",
             FT_WEDGE_TIMEOUT_MS, "HostLostError" in text_c))
    # rank 1's planned death at its step boundary ends rank 0's step too
    # (its collective fails, or its monitor reads the dying marker), and
    # the supervisor names the lowest rank found dead at its 0.1 s poll:
    # either rank may be the one recorded; the planned fault must be rank
    # 1's, and no other failure rank 0's
    planned = "InjectedFault" in gen0[1]
    others = [r for r in range(MESH_RANKS)
              if r != 1 and "InjectedFault" in gen0[r]]
    print("  (b) generation 0: rank 1 died of the planned fault: %s; the "
          "supervisor recorded rank %d first" % (planned, failed["rank"]))
    if not planned or others or failed["code"] != 1 \
            or failed["rank"] not in range(MESH_RANKS) \
            or relaunch["resume_epoch"] != 0 or b[0]["begin"] != 1:
        fail("(b) the restart did not resume from epoch 0 after rank 1's "
             "planned fault: %s" % recs)
    if not same:
        fail("(b) the resumed run's final weights differ from (a)'s")
    if last != FT_EPOCHS - 1 or manifest.get("processes") != MESH_RANKS:
        fail("(b) the last manifest: epoch %s, processes %s"
             % (last, manifest.get("processes")))
    if b[0]["curve"] != a[0]["curve"][FT_STEPS:]:
        fail("(b) the resumed losses differ from (a)'s")
    if false_losses or any(r["host_lost"] for r in a + b):
        fail("(a)/(b): %d false host losses" % false_losses)
    for r, rec in enumerate(b):
        for kname in TRAIN_KERNELS:
            if rec["launches"][kname] != L * (MESH_STEPS - FT_STEPS):
                fail("(b) rank %d: %s launched %d times in %d steps, want %d "
                     "a step" % (r, kname, rec["launches"][kname],
                                 MESH_STEPS - FT_STEPS, L))
    if rc_c != 43 or "HostLostError" not in text_c or not stale \
            or placed != MESH_RANKS or "FT_WEDGE_SLEPT_THROUGH" in text_c:
        fail("(c) the wedged host was not detected: exit %s\n%s"
             % (rc_c, text_c[-3000:]))
    print("  fault tolerance phase %.1f s" % (time.perf_counter() - t_phase))
    return dict(launches=b[0]["launches"])


# ---------------------------------------------------------------------------
# phase 28: the deploy path, the rest
# ---------------------------------------------------------------------------

# (a) phase 10's LM exported (buckets LM_ART_BUCKETS at T LM_ART_T) and
# served from the artifact: LM_ART_REQUESTS requests of LM_ART_LENGTHS
# tokens (seed 2), padded at the end
LM_ART_BUCKETS = [8]                # (cut from [1, 8]: phase 30's time)
LM_ART_T = 1024
LM_ART_REQUESTS = 32
LM_ART_LENGTHS = (100, 1024)
LM_ART_SHAPE = "B8 T1024 H12 D64 causal"
# (b) FC -> causal flash attention -> FC, serve_artifact-sized
ATT_T, ATT_IN, ATT_HEADS, ATT_DIM = 64, 32, 4, 16
ATT_BUCKETS = [1, 2, 4, 8]
ATT_REQUESTS = 32
ATT_SHAPE = "B8 T%d H%d D%d causal" % (ATT_T, ATT_HEADS, ATT_DIM)
# (c) the decode op at the server's window
DEC_ART = (8, 576, 12, 64)
DEC_ART_TOL = dict(rtol=1e-5, atol=1e-5)
# (d) phase 26 (a)'s ResNet-50 v1 as a format-3 int8 artifact
Q8_BUCKETS = [32]                   # (cut from [1, 32]: phase 30's time)
Q8_CALIB = (4, 32)                  # batches x images, seed 3
Q8_CLIENTS = 8
Q8_PER_CLIENT = 16
Q8_TOL = dict(rtol=1e-4, atol=1e-5)
Q8_DELTA_TOL = dict(rtol=1e-4, atol=1e-6)
Q8_CLASSES = (("int8 GEMM", ("gemm", "cutlass", "xmma", "imma", "sm90_")),
              ("im2col and padding copies", ("copy", "pad", "cat_")),
              ("reductions (quantize ranges)", ("reduce",)))
Q8_CUSTOM_OPS = ["mxnet_tpu_torch::" + n for n in (
    "dequantize", "quantize_v2", "quantized_conv",
    "quantized_fully_connected", "requantize")]
Q8_OPS = (("int8 GEMM ops (im2col + _int_mm + bias)",
           ("_contrib_quantized_conv", "_contrib_quantized_fully_connected")),
          ("quantize", ("_contrib_quantize_v2",)),
          ("requantize", ("_contrib_requantize",)),
          ("dequantize", ("_contrib_dequantize",)))
# (e) host cost of a flash_attention call through the op
OP_HOST_REPS = 2000
# the plain attention's ops (the LM artifact's max-logit head is an amax)
PLAIN_ATTENTION_OPS = {"aten::exp", "aten::logsumexp", "aten::bmm",
                       "aten::einsum", "aten::_softmax"}


def graph_targets(pred):
    """The op names each of a Predictor's programs calls."""
    return [{n.target.name() for n in ep.graph.nodes
             if n.op == "call_function"
             and isinstance(n.target, torch._ops.OpOverload)}
            for _b, ep in pred._programs]


@contextlib.contextmanager
def counting_plain(tfa):
    """``{"calls": n}``: calls of the plain attention versions (the ops'
    CPU route and ``impl="plain"``) inside the block."""
    seen = {"calls": 0}
    orig = {n: getattr(tfa, n) for n in ("_torch_fwd_lse", "_torch_reference",
                                         "_torch_decode")}

    def wrap(fn):
        def call(*a, **kw):
            seen["calls"] += 1
            return fn(*a, **kw)
        return call
    for n, fn in orig.items():
        setattr(tfa, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in orig.items():
            setattr(tfa, n, fn)


def lm_artifact(mx, net, path):
    """(a)'s export: the LM's graph with (max logit, argmax) heads per
    position over inputs ``tokens`` and ``positions`` (B, T), one
    program a bucket. Returns (export s, s a bucket by stage)."""
    logits = net(mx.sym.var("tokens"), mx.sym.var("positions"))
    sym = mx.sym.Group([mx.sym.max(logits, axis=-1),
                        mx.sym.argmax(logits, axis=-1)])
    params = {p.name: p.data() for p in net.collect_params().values()}
    t0 = time.perf_counter()
    with timing_calls(torch.export, ("export", "save")) as spent:
        mx.deploy.export_compiled(
            sym, path, params=params,
            input_shapes={"tokens": (1, LM_ART_T),
                          "positions": (1, LM_ART_T)},
            batch_sizes=LM_ART_BUCKETS)
    return time.perf_counter() - t0, spent


def serve_lm_artifact(mx, card, tfa):
    """(a): phase 10's LM exported on the card, loaded, served by the
    InferenceServer from its bucket graphs."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import compile_watch, serving
    net, lm, cfg = lm_serving_net(mx)
    tmp = tempfile.mkdtemp(prefix="mxt-lm-")
    path = os.path.join(tmp, "lm.mxp")
    export_s, spent = lm_artifact(mx, net, path)
    t0 = time.perf_counter()
    pred = mx.deploy.load_compiled(path)
    load_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    held_ops = graph_targets(pred)
    if pred.meta["custom_ops"] != ["mxnet_tpu_torch::flash_fwd"] \
            or any("mxnet_tpu_torch::flash_fwd" not in t
                   or t & PLAIN_ATTENTION_OPS for t in held_ops) \
            or pred.program_devices() != {"cuda:0"}:
        fail("deploy: the LM artifact: custom_ops %s, programs' ops %s, "
             "devices %s" % (pred.meta["custom_ops"], held_ops,
                             pred.program_devices()))
    print("  (a) phase 10's LM (GPT-2-small width, seed 0) exported on the "
          "card with (max logit, argmax) heads, buckets %s at T %d: %.2f s; "
          "s a bucket: torch.export.export %s, torch.export.save %s; "
          "artifact %d bytes (programs %s, weights once %d); loaded on %s in "
          "%.2f s; meta custom_ops %s; each program calls flash_fwd and none "
          "of %s (%s)"
          % (LM_ART_BUCKETS, LM_ART_T, export_s,
             [round(t, 2) for t in spent["export"]],
             [round(t, 2) for t in spent["save"]], size,
             [p["length"] for p in pred.meta["programs"]],
             pred.meta["weights"]["length"], pred.device, load_s,
             pred.meta["custom_ops"], sorted(PLAIN_ATTENTION_OPS), card))
    compile_watch.enable()
    srv = serving.InferenceServer(pred, max_queue=64, batch_window_ms=2.0,
                                  name="lm-artifact")
    rs = np.random.RandomState(2)
    lengths = rs.randint(LM_ART_LENGTHS[0], LM_ART_LENGTHS[1] + 1,
                         LM_ART_REQUESTS)
    tokens = [rs.randint(0, cfg["vocab"], L).astype(np.float32)
              for L in lengths]
    positions = np.arange(LM_ART_T, dtype=np.float32)
    samples = [(np.pad(t, (0, LM_ART_T - len(t))), positions)
               for t in tokens]
    with counting_plain(tfa) as plain:
        t0 = time.perf_counter()
        n = srv.warmup()
        warm_s = time.perf_counter() - t0
        warm = compile_watch.site_stats("serving:lm-artifact")
        graphs = program_graphs(srv)
        held = {k: g._entries[next(iter(g._entries))].launches
                for k, g in graphs.items()}
        replays0 = sum(g.replays for g in graphs.values())
        tfa.reset_launches()                  # the main path starts here
        futs, wall = serve_traffic(srv, samples, 4)
        launches = dict(tfa.launches)         # ... and ends here
    st = srv.stats()
    srv.stop()
    after = compile_watch.site_stats("serving:lm-artifact")
    traffic_replays = sum(g.replays for g in graphs.values()) - replays0
    per_replay = sorted({v.get("flash_fwd", 0) for v in held.values()})
    layers = GPT2_SMALL["n_layers"]
    if n != len(LM_ART_BUCKETS) or len(warm) != n \
            or any(s["count"] != 1 for s in warm.values()) or after != warm \
            or per_replay != [layers] \
            or launches["flash_fwd"] != layers * traffic_replays \
            or any(v for k, v in launches.items() if k != "flash_fwd") \
            or plain["calls"] or traffic_replays != st["batches"] \
            or st["completed"] != LM_ART_REQUESTS:
        fail("deploy: the LM artifact's serving: %d programs, sites %s -> "
             "%s, held %s, launches %s over %d replays, plain calls %d, "
             "stats %s" % (n, warm, after, held, launches, traffic_replays,
                           plain["calls"], st))
    worst, ties = 0.0, 0
    for L, toks, f in zip(lengths, tokens, futs):
        got_max, got_arg = f.result()
        want_max, want_arg, margin = lm_alone(net, mx, toks)
        err = float(np.max(np.abs(got_max[:L] - want_max)))
        worst = max(worst, err)
        if not np.allclose(got_max[:L], want_max, **LM_SERVE_TOL):
            fail("deploy: the LM artifact's reply of %d tokens differs from "
                 "the model alone by %g" % (L, err))
        off = got_arg[:L] != want_arg
        ties += int(off.sum())
        if (off & (margin > TIE_MARGIN)).any():
            fail("deploy: the LM artifact's argmax differs off a tie")
    print("  (a) served: warmup captured %d bucket graphs in %.2f s (capture "
          "ms %s), none in traffic; %d requests of %d-%d tokens (padded at "
          "the end to %d) in %.3f s: %.2f requests/s, latency ms p50 %.1f "
          "p99 %.1f, batches %s; flash_fwd launches %d = %d a replay x %d "
          "replays, no other kernel, the plain attention called %d times; max"
          " logit max abs err %.3g vs the model alone (rtol %g, atol %g), "
          "argmax equal but %d tied positions (%s)"
          % (n, warm_s, {k: round(v["total_s"] * 1e3, 1)
                         for k, v in warm.items()}, LM_ART_REQUESTS,
             LM_ART_LENGTHS[0], LM_ART_LENGTHS[1], LM_ART_T, wall,
             LM_ART_REQUESTS / wall, st["latency_ms"]["p50"],
             st["latency_ms"]["p99"], st["buckets"], launches["flash_fwd"],
             layers, traffic_replays, plain["calls"], worst,
             LM_SERVE_TOL["rtol"], LM_SERVE_TOL["atol"], ties, card))
    # one B8 T1024 batch three ways: the artifact's bucket graph, phase 26
    # (c)'s in-process callable on a server graph, the hybridized net's
    # CachedOp graph (its logits)
    dev = torch.device("cuda", 0)
    tok8 = torch.from_numpy(np.stack([s[0] for s in samples[:8]])).to(dev)
    pos8 = torch.from_numpy(np.tile(positions, (8, 1))).to(dev)
    fn = srv._programs[("cuda:0", LM_ART_BUCKETS[-1])]
    with torch.inference_mode():
        art_ms = wall_ms(lambda: fn(tok8, pos8), iters=10)
    with serving.InferenceServer(lm, ladder=[8], seq_ladder=[LM_ART_T],
                                 name="lm-callable") as csrv:
        csrv.warmup(np.zeros(LM_ART_T, np.float32))
        cfn = csrv._programs[("cuda:0", (8, LM_ART_T))]
        with torch.inference_mode():
            callable_ms = wall_ms(lambda: cfn(tok8), iters=10)
    net.hybridize()
    NDArray = mx.nd.NDArray
    with torch.inference_mode():
        cached_ms = wall_ms(lambda: net(NDArray(tok8), NDArray(pos8)),
                            iters=10)
    print("  (a) ms a B8 T%d batch: artifact bucket-graph replay %.3f; phase "
          "26 (c)'s in-process callable on a server graph %.3f; the "
          "hybridized net's CachedOp replay (its logits) %.3f (%s)"
          % (LM_ART_T, art_ms, callable_ms, cached_ms, card))
    compile_watch.disable()
    del srv, pred, net, lm, fn, tok8, pos8
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches=launches, export_s=export_s, bytes=size,
                replay_ms=art_ms, callable_ms=callable_ms,
                cached_ms=cached_ms)


def attention_export(mx, path, ctx):
    """(b)'s graph and weights (seed 0) on ``ctx``: FC -> q, k, v ->
    causal ``_contrib_flash_attention`` -> FC, exported with one program
    a bucket of ATT_BUCKETS."""
    units = ATT_HEADS * ATT_DIM
    d = mx.sym.var("data")
    heads = [mx.sym.reshape(mx.sym.FullyConnected(
        d, num_hidden=units, flatten=False, name=n),
        shape=(0, 0, ATT_HEADS, ATT_DIM)) for n in "qkv"]
    att = mx.sym._contrib_flash_attention(*heads, causal=True)
    out = mx.sym.FullyConnected(mx.sym.reshape(att, shape=(0, 0, units)),
                                num_hidden=10, flatten=False, name="o")
    rs = np.random.RandomState(0)
    params = {}
    for n in "qkv":
        params[n + "_weight"] = mx.nd.array(
            rs.randn(units, ATT_IN) * ATT_IN ** -0.5, ctx=ctx)
        params[n + "_bias"] = mx.nd.zeros((units,), ctx=ctx)
    params["o_weight"] = mx.nd.array(rs.randn(10, units) * units ** -0.5,
                                     ctx=ctx)
    params["o_bias"] = mx.nd.zeros((10,), ctx=ctx)
    mx.deploy.export_compiled(out, path, params=params,
                              input_shapes={"data": (1, ATT_T, ATT_IN)},
                              batch_sizes=ATT_BUCKETS)
    return path


def serve_attention_portable(mx, card, tfa, tmp):
    """(b): the attention graph exported in phase 26 (b)'s CPU-only
    process (into ``tmp``) launches the kernel once served on the card,
    equal to a card export."""
    import shutil
    from mxnet_tpu_torch import serving
    cpu_path = os.path.join(tmp, "att-cpu.mxp")
    card_path = attention_export(mx, os.path.join(tmp, "att-card.mxp"),
                                 mx.gpu(0))
    rs = np.random.RandomState(1)
    xs = rs.randn(ATT_REQUESTS, ATT_T, ATT_IN).astype(np.float32)
    outs, devs, launches, ops = {}, {}, {}, {}
    for tag, path in (("cpu", cpu_path), ("card", card_path)):
        pred = mx.deploy.load_compiled(path)
        devs[tag] = pred.program_devices()
        ops[tag] = (pred.meta["custom_ops"],
                    all("mxnet_tpu_torch::flash_fwd" in t
                        and not t & PLAIN_ATTENTION_OPS
                        for t in graph_targets(pred)))
        with serving.InferenceServer(pred, max_queue=64,
                                     batch_window_ms=2.0,
                                     name="attention-" + tag) as srv:
            srv.warmup()
            tfa.reset_launches()
            futs, _ = serve_traffic(srv, xs, 4)
            launches[tag] = dict(tfa.launches)
        outs[tag] = np.stack([f.result() for f in futs])
    err = float(np.max(np.abs(outs["cpu"] - outs["card"])))
    print("  (b) FC -> flash attention -> FC (%s) exported in phase 26 (b)'s "
          "CPU-only process and on the card, each served on cuda:0: program "
          "devices %s / %s; custom_ops and op nodes (no plain attention) %s "
          "/ %s; flash_fwd launches in traffic %d / %d; %d requests, max abs "
          "diff %.3g (rtol %g, atol %g)"
          % (ATT_SHAPE, sorted(devs["cpu"]), sorted(devs["card"]),
             ops["cpu"], ops["card"], launches["cpu"]["flash_fwd"],
             launches["card"]["flash_fwd"], ATT_REQUESTS, err,
             PORTABLE_TOL["rtol"], PORTABLE_TOL["atol"]))
    if devs["cpu"] != {"cuda:0"} or devs["card"] != {"cuda:0"}:
        fail("deploy: a loaded attention program names another device: %s"
             % devs)
    want_ops = (["mxnet_tpu_torch::flash_fwd"], True)
    if ops["cpu"] != want_ops or ops["card"] != want_ops:
        fail("deploy: the attention artifacts' ops: %s" % ops)
    if launches["cpu"]["flash_fwd"] <= 0 or any(
            v for lc in launches.values() for k, v in lc.items()
            if k != "flash_fwd"):
        fail("deploy: the CPU-exported attention artifact launched %s"
             % launches)
    if not np.allclose(outs["cpu"], outs["card"], **PORTABLE_TOL):
        fail("deploy: the CPU export's answers differ from the card's by %g"
             % err)
    shutil.rmtree(tmp, ignore_errors=True)
    return launches["cpu"]


def decode_artifact(mx, card, tfa):
    """(c): ``_contrib_decode_attention`` at the server's window, exported
    (the graph has no parameters: traced on the CPU) and run on the card
    through the Predictor, held to the plain version."""
    import shutil
    import tempfile
    B, T, H, D = DEC_ART
    sym = mx.sym._contrib_decode_attention(
        mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v"),
        mx.sym.var("lengths"))
    tmp = tempfile.mkdtemp(prefix="mxt-dec-")
    path = os.path.join(tmp, "decode.mxp")
    mx.deploy.export_compiled(sym, path, params={}, input_shapes={
        "q": (B, 1, H, D), "k": (B, T, H, D), "v": (B, T, H, D),
        "lengths": (B,)})
    pred = mx.deploy.load_compiled(path)
    rs = np.random.RandomState(28)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k, v = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    cases = [rs.randint(1, T + 1, B), np.array([T] + [1] * (B - 1))]
    tfa.reset_launches()
    got = [pred(q, k, v, lens.astype(np.float32)) for lens in cases]
    launches = dict(tfa.launches)
    dev = torch.device("cuda", 0)
    errs = []
    for lens, g in zip(cases, got):
        want = tfa.flash_decode(
            *(torch.from_numpy(x).to(dev) for x in (q, k, v)),
            torch.from_numpy(lens.astype(np.int32)).to(dev),
            impl="plain").cpu().numpy()
        errs.append(float(np.max(np.abs(g - want))))
        if not np.allclose(g, want, **DEC_ART_TOL):
            fail("deploy: the decode artifact differs from the plain "
                 "version by %g" % errs[-1])
    ops = graph_targets(pred)
    print("  (c) _contrib_decode_attention (B%d T%d H%d D%d, lengths an "
          "input) exported and run on %s: custom_ops %s, flash_decode in the "
          "program %s; random lengths and 576, 1, ..., 1: max abs err vs the "
          "plain version %s (rtol %g, atol %g); launches %s (%s)"
          % (B, T, H, D, pred.device, pred.meta["custom_ops"],
             all("mxnet_tpu_torch::flash_decode" in t for t in ops),
             ["%.3g" % e for e in errs], DEC_ART_TOL["rtol"],
             DEC_ART_TOL["atol"], launches, card))
    if pred.meta["custom_ops"] != ["mxnet_tpu_torch::flash_decode"] \
            or launches["flash_decode"] != len(cases) \
            or any(v for n, v in launches.items() if n != "flash_decode"):
        fail("deploy: the decode artifact: custom_ops %s, launches %s"
             % (pred.meta["custom_ops"], launches))
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


class CalibBatches:
    """Calibration batches (``.data`` lists of NDArrays on the card), as
    an iterator over DataBatch-like objects with ``reset``."""

    def __init__(self, mx, arrays):
        self._batches = [type("Batch", (), {"data": [
            mx.nd.array(a, ctx=mx.gpu(0))]})() for a in arrays]

    def __iter__(self):
        return iter(self._batches)

    def reset(self):
        pass


def op_by_op(sym, args, aux):
    """``sym``'s predict forward op by op (no graph) on (N, ...) tensors
    on the card, its parameters read in place."""
    from mxnet_tpu_torch.cached_op import build_graph_callable
    fn, arg_names, aux_names, _n_rng, _n_out = build_graph_callable(sym)

    def forward(x):
        vals = [x if n == "data" else args[n]._data for n in arg_names]
        vals += [aux[n]._data for n in aux_names]
        with torch.inference_mode():
            return fn({"__train__": False}, *vals)[0]
    return forward


@contextlib.contextmanager
def annotated_ops(ops, names):
    """Each op of ``names`` runs inside a ``record_function`` named
    ``mxop:<name>`` (the profiler attributes its kernels to it)."""
    from torch.profiler import record_function
    orig = {n: ops.get_op(n).forward for n in names}

    def wrap(n, fn):
        def forward(*a, **kw):
            with record_function("mxop:" + n):
                return fn(*a, **kw)
        return forward
    for n, fn in orig.items():
        ops.get_op(n).forward = wrap(n, fn)
    try:
        yield
    finally:
        for n, fn in orig.items():
            ops.get_op(n).forward = fn


def op_class_ms(mx, forward, x, steps=3):
    """Device busy ms a call by registered-op class (Q8_OPS, the rest
    "other ops"), from the profiler over ``steps`` op-by-op calls: the
    kernels under each op's host-side ``mxop:`` range (its GPU-side
    range spans the idle time between them too, so it is not read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = sorted({n for _c, ns in Q8_OPS for n in ns})
    forward(x)
    torch.cuda.synchronize()
    with annotated_ops(mx.ops, names):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                forward(x)
            torch.cuda.synchronize()
    by_op, total = {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        total += e.self_device_time_total / 1e3 / steps
        if e.name.startswith("mxop:"):
            by_op[e.name[5:]] = by_op.get(e.name[5:], 0.0) \
                + e.device_time_total / 1e3 / steps
    out = {c: sum(by_op.get(n, 0.0) for n in ns) for c, ns in Q8_OPS}
    out["other ops"] = total - sum(out.values())
    return out


def serve_resnet_int8(mx, card, fp32):
    """(d): phase 26 (a)'s ResNet-50 v1 and weights quantized (naive
    calibration), exported as a format-3 artifact and served."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import compile_watch, serving
    from mxnet_tpu_torch.contrib import quantization as q8
    net = resnet_net(mx, 50, 1, SERVE_IMAGE, SERVE_CLASSES)
    sym = net(mx.sym.var("data"))
    params = {p.name: p.data() for p in net.collect_params().values()}
    args = {n: params[n] for n in sym.list_arguments() if n in params}
    aux = {n: params[n] for n in sym.list_auxiliary_states()}
    rs = np.random.RandomState(3)
    calib = CalibBatches(mx, [
        rs.randn(Q8_CALIB[1], 3, SERVE_IMAGE, SERVE_IMAGE).astype(
            np.float32) for _ in range(Q8_CALIB[0])])
    t0 = time.perf_counter()
    qsym, qargs, qaux = q8.quantize_model(
        sym, args, aux, calib_mode="naive", calib_data=calib,
        num_calib_batches=Q8_CALIB[0])
    quant_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="mxt-q8-")
    path = os.path.join(tmp, "resnet50-int8.mxp")
    t0 = time.perf_counter()
    with timing_calls(torch.export, ("export", "save")) as spent:
        mx.deploy.export_compiled(
            sym, path, params=args, aux_params=aux,
            input_shapes={"data": (1, 3, SERVE_IMAGE, SERVE_IMAGE)},
            batch_sizes=Q8_BUCKETS, quantize=True, calib_data=calib,
            num_calib_batches=Q8_CALIB[0])
    export_s = time.perf_counter() - t0
    pred = mx.deploy.load_compiled(path)
    meta = pred.meta
    qb = pred.quantization
    # the ranges on quantize_model's requantize nodes are the meta's
    req = {n.name[:-len("_requantize")]: (float(n.attrs["min_calib_range"]),
                                          float(n.attrs["max_calib_range"]))
           for n in qsym._topo_nodes() if not n.is_variable()
           and n.op.name == "_contrib_requantize"}
    ranges_equal = req == {n: tuple(r) for n, r in qb["ranges"].items()}
    # the recorded delta, recomputed op by op over the calibration batches
    fwd32, fwd8 = op_by_op(sym, args, aux), op_by_op(qsym, qargs, qaux)
    delta = 0.0
    for b in calib:
        x = b.data[0]._data
        delta = max(delta, float((fwd8(x) - fwd32(x)).abs().max()))
    print("  (d) ResNet-50 v1 (phase 26 (a)'s net and weights) quantized, "
          "naive calibration on %d x %d synthetic images (seed 3): "
          "quantize_model %.2f s; format-3 export with buckets %s %.2f s (s a "
          "bucket: torch.export.export %s, torch.export.save %s), %d bytes; "
          "%d calibrated ranges, equal to quantize_model's: %s; "
          "max_abs_delta %.6g recorded, %.6g recomputed op by op; "
          "custom_ops %s (%s)"
          % (Q8_CALIB[0], Q8_CALIB[1], quant_s, Q8_BUCKETS, export_s,
             [round(t, 2) for t in spent["export"]],
             [round(t, 2) for t in spent["save"]], os.path.getsize(path),
             len(qb["ranges"]), ranges_equal, qb["max_abs_delta"], delta,
             [n.split("::")[1] for n in meta["custom_ops"]], card))
    if meta["format"] != 3 or not ranges_equal or len(req) != 54 \
            or not np.isclose(delta, qb["max_abs_delta"], **Q8_DELTA_TOL) \
            or meta["custom_ops"] != Q8_CUSTOM_OPS \
            or pred.program_devices() != {"cuda:0"}:
        fail("deploy: the int8 artifact: format %s, %d ranges equal %s, "
             "delta %g vs %g, custom_ops %s, devices %s"
             % (meta["format"], len(req), ranges_equal, delta,
                qb["max_abs_delta"], meta["custom_ops"],
                pred.program_devices()))
    compile_watch.enable()
    srv = serving.InferenceServer(pred, max_queue=64, batch_window_ms=2.0,
                                  name="resnet-int8")
    n = srv.warmup()
    warm = compile_watch.site_stats("serving:resnet-int8")
    graphs = program_graphs(srv)
    rs = np.random.RandomState(5)
    xs = rs.randn(Q8_CLIENTS * Q8_PER_CLIENT, 3, SERVE_IMAGE,
                  SERVE_IMAGE).astype(np.float32)
    futs, wall = serve_traffic(srv, xs, Q8_CLIENTS)
    st = srv.stats()
    srv.stop()
    after = compile_watch.site_stats("serving:resnet-int8")
    recaptures = sum(g.recaptures for g in graphs.values())
    if n != len(Q8_BUCKETS) or after != warm or recaptures \
            or st["completed"] != len(xs) or st["shed"] or st["timeouts"]:
        fail("deploy: the int8 server: %d programs, sites %s -> %s, "
             "recaptures %d, stats %s" % (n, warm, after, recaptures, st))
    # each answer against its batch as the server formed it: the int8
    # graph quantizes its input over the whole batch
    batches = {}
    for i, f in enumerate(futs):
        batches.setdefault(f.batch, []).append((f.row, i))
    worst, exact = 0.0, 0
    dev = torch.device("cuda", 0)
    for rows in batches.values():
        rows.sort()
        idx = [i for _r, i in rows]
        b = futs[idx[0]].bucket
        batch = np.zeros((b,) + xs.shape[1:], np.float32)
        batch[:len(idx)] = xs[idx]
        xb = torch.from_numpy(batch).to(dev)
        want = fwd8(xb).cpu().numpy()
        with torch.inference_mode():
            prog = pred.program(b)(xb).cpu().numpy()
        for row, i in enumerate(idx):
            got = futs[i].result()
            worst = max(worst, float(np.max(np.abs(got - want[row]))))
            if not np.allclose(got, want[row], **Q8_TOL):
                fail("deploy: int8 request %d differs from the quantized "
                     "Symbol op by op by %g"
                     % (i, float(np.max(np.abs(got - want[row])))))
            if not np.array_equal(got, prog[row]):
                fail("deploy: int8 request %d differs from the Predictor's "
                     "bucket-%d program" % (i, b))
            exact += 1
    x32 = torch.from_numpy(xs[:Q8_BUCKETS[-1]]).to(dev)
    fn = srv._programs[("cuda:0", Q8_BUCKETS[-1])]
    with torch.inference_mode():
        replay_ms = wall_ms(lambda: fn(x32))
        _w, busy, by_class, top, _bare = profile_steps(
            lambda: fn(x32), 5, classes=Q8_CLASSES)
    ops_ms = op_class_ms(mx, fwd8, x32)
    print("  (d) served: warmup captured %d bucket graphs, none in traffic; "
          "%d clients x %d requests in %.3f s: %.1f requests/s (phase 26 "
          "(a) fp32: %.1f), latency ms p50 %.2f p99 %.2f, batches %s; each "
          "answer vs the quantized Symbol op by op on its batch: max abs err "
          "%.3g (rtol %g, atol %g), %d of %d bit-identical to the Predictor's"
          " program at its bucket; ms a batch at bucket %d by replay %.3f "
          "(%.1f images/s) vs phase 26 (a)'s fp32 artifact %.3f (%s)"
          % (n, Q8_CLIENTS, Q8_PER_CLIENT, wall, len(xs) / wall, fp32["rps"],
             st["latency_ms"]["p50"], st["latency_ms"]["p99"], st["buckets"],
             worst, Q8_TOL["rtol"], Q8_TOL["atol"], exact, len(xs),
             Q8_BUCKETS[-1], replay_ms, Q8_BUCKETS[-1] * 1e3 / replay_ms,
             fp32["replay_ms"], card))
    print("  (d) bucket-32 replay, device busy ms %.3f by kernel class %s; "
          "top kernels %s; op by op, device ms by op class %s (%s)"
          % (busy, {k: round(v, 3) for k, v in by_class.items()},
             [(round(us / 5e3, 3), name[:60], cnt // 5)
              for us, name, cnt in top[:5]],
             {k: round(v, 3) for k, v in ops_ms.items()}, card))
    compile_watch.disable()
    del srv, pred, net, fn, x32, fwd8, fwd32, calib
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(replay_ms=replay_ms, rps=len(xs) / wall, by_class=by_class,
                ops_ms=ops_ms)


def op_route(card, tfa):
    """(e): the host cost of ``flash_attention`` through the op beside
    the direct ctypes wrapper, and an op call on the card raising when
    the kernel's library does not load."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import _build
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(64)
    q, k, v = (torch.randn(1, 64, 12, 64, generator=g).to(dev)
               for _ in range(3))
    scale = 64 ** -0.5

    def through_op():
        for _ in range(OP_HOST_REPS):
            tfa.flash_attention(q, k, v, causal=True)

    def direct():
        for _ in range(OP_HOST_REPS):
            tfa._fwd_cuda(q, k, v, None, scale, True)
    through_op()
    direct()
    op_us = [host_us(through_op, OP_HOST_REPS) for _ in range(2)]
    ctypes_us = [host_us(direct, OP_HOST_REPS) for _ in range(2)]
    orig = _build.library

    def broken(name):
        raise MXNetError("library %s made to fail" % name)
    _build.library = broken
    try:
        tfa.flash_attention(q, k, v, causal=True)
        raised = None
    except MXNetError as exc:
        raised = str(exc)
    finally:
        _build.library = orig
    print("  (e) host us a call at B1 T64 H12 D64 causal: flash_attention "
          "through op mxnet_tpu_torch::flash_fwd %s, the ctypes wrapper "
          "_fwd_cuda %s (the dispatcher's cost: %.1f us); with "
          "_build.library made to fail, an op call on cuda:0 raised "
          "MXNetError: %s (%s)"
          % (["%.1f" % u for u in op_us], ["%.1f" % u for u in ctypes_us],
             min(op_us) - min(ctypes_us), raised, card))
    if raised is None or "made to fail" not in raised:
        fail("deploy: an op call with the kernel library failing did not "
             "raise MXNetError")
    return dict(op_us=min(op_us), ctypes_us=min(ctypes_us))


def phase_deploy_rest(card, tfa, serve):
    """The twenty-fourth slice's main path: artifacts that hold attention
    (the kernels as torch.library ops) and int8 format-3 artifacts, (a)-(e)
    as the module docstring sets out; fp32, TF32 off."""
    import mxnet_tpu_torch as mx
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lm = serve_lm_artifact(mx, card, tfa)
    att_launches = serve_attention_portable(mx, card, tfa,
                                            serve["cpu_dir"])
    dec_launches = decode_artifact(mx, card, tfa)
    tfa.reset_launches()
    q8 = serve_resnet_int8(mx, card, serve["resnet"])
    if any(tfa.launches.values()):
        fail("deploy: the int8 ResNet launched attention kernels: %s"
             % tfa.launches)
    route = op_route(card, tfa)
    att_fwd = fwd_case(tfa, 8, ATT_T, ATT_T, ATT_HEADS, ATT_DIM, True,
                       False, seed=28)
    print("  attention kernel launches: (a) %s, (b) %s, (c) %s, none in (d); "
          "phase 28 %.1f s" % (lm["launches"], att_launches, dec_launches,
                               time.perf_counter() - t_phase))
    return dict(lm=lm, att_launches=att_launches, att_fwd=att_fwd,
                dec_launches=dec_launches, q8=q8, route=route)


# ---------------------------------------------------------------------------
# phase 29: control flow and user code inside graphs
# ---------------------------------------------------------------------------

# BASELINE config 3 at phase 19's constants, its time loop ONE _foreach
# node. (a) up to CF_PER_BUCKET batches of each bucket, round robin (at
# least CF_MIN_BATCHES), against phase 19's unrolled twin from the same
# weights, each batch's loss within CF_LOSS_REL
CF_PER_BUCKET = 8
CF_MIN_BATCHES = 40
CF_LOSS_REL = 1e-4
CF_STEP_ITERS = 5
# (b) greedy generation: CF_STEPS live steps of CF_MAX_ITER (the masked
# tail runs), the first CF_PROMPT tokens the prompt's
CF_PROMPT = 10
CF_STEPS = 40
CF_MAX_ITER = 50
CF_REPLAYS = 3
# (c) the Custom softmax loss at one bucket for CF_CUSTOM_BATCHES steps
CF_CUSTOM_BUCKET = 30
CF_CUSTOM_BATCHES = 20
CF_CUSTOM_REL = 1e-4
CF_HEAD_CALLS = 3
# (d) get_symbol's logits, and a user Function's gradients against the
# built-in sigmoid's (normwise: max |a - b| / max |b|)
CF_SYMBOL_TOL = 1e-5
CF_FUNCTION_TOL = 1e-6


def cf_cells(mx):
    cell = mx.rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        cell.add(mx.rnn.LSTMCell(num_hidden=LM_HIDDEN,
                                 prefix="lstm_l%d_" % i))
    return cell


def cf_sym_gen(mx, custom=False):
    """Phase 19's LM with its time loop as ONE foreach node: the cells are
    called once in the body, so the parameters are phase 19's by name;
    ``custom``: (c)'s Custom softmax loss in SoftmaxOutput's place."""
    def sym_gen(seq_len):
        label = mx.sym.Reshape(mx.sym.var("softmax_label"), shape=(-1,))
        embed = mx.sym.Embedding(data=mx.sym.var("data"), input_dim=LM_VOCAB,
                                 output_dim=LM_EMBED, name="embed")
        cell = cf_cells(mx)
        steps = mx.sym.SwapAxis(embed, dim1=0, dim2=1)          # (T, B, E)
        first = mx.sym.Reshape(mx.sym.slice_axis(steps, axis=0, begin=0,
                                                 end=1), shape=(-3, -1))
        outs, _ = mx.sym.contrib.foreach(
            lambda x, states: cell(x, states), steps,
            cell.begin_state(x=first), name="lstm_foreach")
        outs = mx.sym.SwapAxis(outs, dim1=0, dim2=1)            # (B, T, H)
        pred = mx.sym.FullyConnected(
            mx.sym.Reshape(outs, shape=(-1, LM_HIDDEN)),
            num_hidden=LM_VOCAB, name="pred")
        if custom:
            out = mx.sym.Custom(pred, label, op_type="cf_softmax",
                                name="softmax")
        else:
            out = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax",
                                       use_ignore=True, ignore_label=0)
        return out, ("data",), ("softmax_label",)
    return sym_gen


def cf_register_softmax(mx, seen):
    """(c)'s Custom op ``cf_softmax``: the softmax over the vocabulary in
    NDArray calls; its backward ``y - onehot(label)`` with label 0
    ignored, as SoftmaxOutput(use_ignore, ignore_label=0) computes it.
    Each forward notes its ``in_data``'s context in ``seen``."""
    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(in_data[0].context)
            x = in_data[0]
            e = mx.nd.exp(x - mx.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / mx.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, label = out_data[0], in_data[1]
            keep = mx.nd.expand_dims(label != 0, axis=1)
            self.assign(in_grad[0], req[0],
                        (y - mx.nd.one_hot(label, y.shape[1])) * keep)
            self.assign(in_grad[1], req[1],
                        mx.nd.zeros(label.shape, ctx=label.context))

    @mx.operator.register("cf_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def cf_loss(out, label):
    """Mean cross-entropy over the positions that are not padding, kept
    on the card."""
    lab = label._data.reshape(-1).long()
    keep = lab != 0
    picked = out._data.gather(1, lab[:, None]).squeeze(1)
    return -(torch.log(picked.clamp_min(1e-30)) * keep).sum() / keep.sum()


def cf_batches(it):
    """Up to CF_PER_BUCKET batches of each bucket, round robin."""
    it.reset()
    by = {}
    for b in it:
        if len(by.setdefault(b.bucket_key, [])) < CF_PER_BUCKET:
            by[b.bucket_key].append(b)
    out = []
    for k in range(CF_PER_BUCKET):
        out += [by[key][k] for key in sorted(by) if k < len(by[key])]
    return out, {key: len(v) for key, v in sorted(by.items())}


def cf_train(mx, sym_gen, it, arg_params, batches, clock):
    """A BucketingModule over ``sym_gen`` from ``arg_params`` stepped
    over ``batches`` on the fused step: the module, each batch's loss
    (host), and the capture ms of each bucket's first step."""
    from mxnet_tpu_torch import fused_step
    mod = lm_module(mx, sym_gen, it, arg_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=LM_SGD)
    losses, caps = [], {}
    fused_step.set_graph_factory(clock.factory)
    try:
        for b in batches:
            n = len(clock.ms)
            lm_step(mod, b)
            losses.append(cf_loss(mod.get_outputs()[0], b.label[0]))
            if len(clock.ms) > n:
                caps.setdefault(b.bucket_key, []).extend(clock.ms[n:])
    finally:
        fused_step.set_graph_factory(None)
    return mod, torch.stack(losses).cpu().numpy(), caps


def cf_foreach_training(mx, card, sents):
    """(a): the foreach LM through BucketingModule on the fused step
    against phase 19's unrolled twin, from the same weights over the
    same batches."""
    from mxnet_tpu_torch import profiler
    it = lm_iter(mx, sents)
    batches, per_bucket = cf_batches(it)
    if len(per_bucket) != len(LM_BUCKETS) or len(batches) < CF_MIN_BATCHES:
        fail("control flow (a): batches by bucket %s" % per_bucket)
    twin_mod = lm_module(mx, lm_sym_gen(mx), it)
    init = {k: v.asnumpy() for k, v in twin_mod.get_params()[0].items()}
    del twin_mod
    fb0 = profiler.counters().get("fused_step_fallbacks", 0)
    t0 = time.perf_counter()
    mod, losses, caps = cf_train(mx, cf_sym_gen(mx), it, init, batches,
                                 CaptureClock())
    fe_s = time.perf_counter() - t0
    fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - fb0
    stats = {k: v["fused"] for k, v in mod.stats().items()}
    t0 = time.perf_counter()
    twin, t_losses, t_caps = cf_train(mx, lm_sym_gen(mx), it, init, batches,
                                      CaptureClock())
    twin_s = time.perf_counter() - t0
    rel = np.abs(losses - t_losses) / np.abs(t_losses)
    one = [batches[i] for i in range(len(LM_BUCKETS))]
    fe_ms = lm_step_times(mod, one, card, "(a) foreach", CF_STEP_ITERS)
    un_ms = lm_step_times(twin, one, card, "(a) unrolled", CF_STEP_ITERS)
    print("  (a) %d batches %s, foreach LM (one _foreach node a bucket) vs "
          "phase 19's unrolled twin from the same weights: loss first %.4f "
          "last %.4f, max relative difference %.3g (tolerance %g); "
          "fused-step fallbacks %d; %.1f s vs %.1f s (%s)"
          % (len(batches), per_bucket, losses[0], losses[-1], rel.max(),
             CF_LOSS_REL, fallbacks, fe_s, twin_s, card))
    for key in sorted(caps):
        print("    bucket %d: capture (warm-up + capture) %.2f s vs %.2f s "
              "unrolled; ms a step %.3f vs %.3f"
              % (key, caps[key][0] / 1e3, t_caps[key][0] / 1e3, fe_ms[key],
                 un_ms[key]))
    print("  (a) fused-step graphs by bucket: %s"
          % {k: (v["captures"], v["recaptures"]) for k, v in stats.items()})
    if not np.all(np.isfinite(losses)) or rel.max() > CF_LOSS_REL:
        fail("control flow (a): losses differ from the unrolled twin's: "
             "%s vs %s" % (losses[:6], t_losses[:6]))
    if fallbacks:
        fail("control flow (a): %d fused-step fallbacks" % fallbacks)
    if len(stats) != len(LM_BUCKETS) or any(
            v["captures"] != 1 or v["recaptures"] for v in stats.values()):
        fail("control flow (a): captures by bucket %s" % stats)
    return dict(mod=mod, it=it, init=init, batches=batches, losses=losses,
                capture_s={k: v[0] / 1e3 for k, v in caps.items()},
                twin_capture_s={k: v[0] / 1e3 for k, v in t_caps.items()},
                ms=fe_ms, twin_ms=un_ms, rel=float(rel.max()))


def cf_gen_sym(mx):
    """(b): greedy generation as ONE _while_loop node: ``n_steps`` live
    steps of CF_MAX_ITER; each step's token is ``cond(i < CF_PROMPT,
    prompt[:, i], the last step's argmax)``, fed through (a)'s
    embedding, cells and output layer (parameters by (a)'s names)."""
    cell = cf_cells(mx)
    prompt = mx.sym.var("prompt")
    embed_w = mx.sym.var("embed_weight")
    pred_w, pred_b = mx.sym.var("pred_weight"), mx.sym.var("pred_bias")

    def body(i, prev, *states):
        tok = mx.sym.contrib.cond(
            i < CF_PROMPT,
            lambda: mx.sym.Reshape(mx.sym.take(prompt, i, axis=1),
                                   shape=(-1,)),
            lambda: prev)
        emb = mx.sym.Embedding(tok, weight=embed_w, input_dim=LM_VOCAB,
                               output_dim=LM_EMBED, name="embed")
        out, new_states = cell(emb, list(states))
        logits = mx.sym.FullyConnected(out, weight=pred_w, bias=pred_b,
                                       num_hidden=LM_VOCAB, name="pred")
        return tok, [i + 1, mx.sym.argmax(logits, axis=1)] + new_states
    loop_vars = [mx.sym.var("i0"), mx.sym.var("tok0")] + [
        mx.sym.var("state%d" % k) for k in range(2 * LM_LAYERS)]
    toks, _ = mx.sym.contrib.while_loop(
        lambda i, *rest: i < mx.sym.var("n_steps"), body, loop_vars,
        max_iterations=CF_MAX_ITER, name="generate")
    return toks


def cf_host_loop(mx, params, prompt, n_steps):
    """The generation step op by op with nd calls, the host choosing
    each token's source (LSTMCell's arithmetic, operation for
    operation)."""
    nd, H = mx.nd, LM_HIDDEN
    B = prompt.shape[0]
    ctx = prompt.context
    states = [nd.zeros((B, H), ctx=ctx) for _ in range(2 * LM_LAYERS)]
    prev, toks = None, []
    for i in range(n_steps):
        tok = prompt[:, i] if i < CF_PROMPT else prev
        x = nd.Embedding(tok, params["embed_weight"], input_dim=LM_VOCAB,
                         output_dim=LM_EMBED)
        new = []
        for layer in range(LM_LAYERS):
            p = "lstm_l%d_" % layer
            h, c = states[2 * layer], states[2 * layer + 1]
            gates = nd.FullyConnected(x, params[p + "i2h_weight"],
                                      params[p + "i2h_bias"],
                                      num_hidden=4 * H) \
                + nd.FullyConnected(h, params[p + "h2h_weight"],
                                    params[p + "h2h_bias"], num_hidden=4 * H)
            g = nd.SliceChannel(gates, num_outputs=4, axis=1)
            c = nd.sigmoid(g[1] + 1.0) * c + nd.sigmoid(g[0]) * nd.tanh(g[2])
            x = nd.sigmoid(g[3]) * nd.tanh(c)
            new += [x, c]
        states = new
        prev = nd.argmax(nd.FullyConnected(x, params["pred_weight"],
                                           params["pred_bias"],
                                           num_hidden=LM_VOCAB), axis=1)
        toks.append(tok)
    return nd.stack(*toks)


def cf_generation(mx, card, ctx, trained, sents):
    """(b): (a)'s trained weights, the generation graph bound in predict
    mode: its first call eager (op by op) under the sync-debug mode
    ``error``, then one CUDA graph captured once and replayed; the token
    stream against the host loop."""
    params = {k: v.as_in_context(ctx)
              for k, v in trained.get_params()[0].items()}
    prompt = np.array([s[:CF_PROMPT] for s in sents
                       if len(s) >= CF_PROMPT][:LM_BATCH], np.float32)
    args = dict(params)
    args.update(prompt=mx.nd.array(prompt, ctx=ctx),
                n_steps=mx.nd.array([CF_STEPS], ctx=ctx),
                i0=mx.nd.zeros((1,), ctx=ctx),
                tok0=mx.nd.zeros((LM_BATCH,), ctx=ctx))
    args.update(("state%d" % k, mx.nd.zeros((LM_BATCH, LM_HIDDEN), ctx=ctx))
                for k in range(2 * LM_LAYERS))
    sym = cf_gen_sym(mx)
    ex = sym.bind(ctx, {n: args[n] for n in sym.list_arguments()},
                  grad_req="null")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = ex.forward(is_train=True)[0]._data.clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    outs = [ex.forward()[0].asnumpy() for _ in range(CF_REPLAYS)]
    st = ex.stats()
    host = cf_host_loop(mx, params, args["prompt"], CF_STEPS).asnumpy()
    replay_ms = call_ms(lambda: ex.forward(), iters=10, warm=2)
    host_ms = call_ms(lambda: cf_host_loop(mx, params, args["prompt"],
                                           CF_STEPS), iters=3, warm=1)
    toks = outs[0]
    print("  (b) greedy generation, batch %d, prompt %d tokens, while_loop "
          "of %d steps (%d live: n_steps an input) with a cond in its body: "
          "eager first call under sync-debug 'error' without a host wait; "
          "graph stats %s; tokens equal the host loop's: %s, the masked "
          "rows %d-%d zero: %s; replay %.3f ms vs the host loop %.3f ms "
          "(%s)"
          % (LM_BATCH, CF_PROMPT, CF_MAX_ITER, CF_STEPS, st,
             np.array_equal(toks[:CF_STEPS], host), CF_STEPS,
             CF_MAX_ITER - 1, not toks[CF_STEPS:].any(), replay_ms,
             host_ms, card))
    print("  (b) stream 0: %s" % toks[:CF_STEPS, 0].astype(int).tolist())
    if st["captures"] != 1 or st["replays"] < 2 or st["recaptures"] \
            or st["eager_rng"] or st["eager_host"]:
        fail("control flow (b): graph stats %s" % st)
    if not (np.array_equal(toks[:CF_STEPS], host)
            and np.array_equal(eager.cpu().numpy(), toks)
            and all(np.array_equal(o, toks) for o in outs)
            and not toks[CF_STEPS:].any()):
        fail("control flow (b): the tokens differ from the host loop's")
    if not np.array_equal(toks[:CF_PROMPT], prompt.T):
        fail("control flow (b): the prompt was not fed")
    return dict(replay_ms=replay_ms, host_ms=host_ms, stats=st)


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cf_custom(mx, card, ctx, a):
    """(c): (a)'s LM at one bucket through Module.fit with the Custom
    softmax loss, each step a counted fallback from the fused step,
    against a SoftmaxOutput twin on it; and a hybridized Gluon block
    holding F.Custom, run op by op."""
    from mxnet_tpu_torch import profiler
    seen = []
    cf_register_softmax(mx, seen)
    a["it"].reset()
    rows = [b for b in a["it"] if b.bucket_key == CF_CUSTOM_BUCKET]
    rows = rows[:CF_CUSTOM_BATCHES]
    x = np.concatenate([b.data[0].asnumpy() for b in rows])
    y = np.concatenate([b.label[0].asnumpy() for b in rows])
    runs = {}
    for custom in (True, False):
        it = mx.io.NDArrayIter(x, y, batch_size=LM_BATCH, shuffle=False,
                               label_name="softmax_label")
        sym = cf_sym_gen(mx, custom)(CF_CUSTOM_BUCKET)[0]
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in a["init"].items()})
        losses = []

        def ce(label, pred, losses=losses):
            lab = label.ravel().astype(int)
            keep = lab != 0
            losses.append(float(-np.log(np.maximum(
                pred[np.arange(len(lab)), lab][keep], 1e-30)).mean()))
            return losses[-1]
        fb0 = profiler.counters().get("fused_step_fallbacks", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=LM_SGD,
                eval_metric=mx.metric.CustomMetric(ce))
        torch.cuda.synchronize()
        runs[custom] = dict(
            losses=np.array(losses), s=time.perf_counter() - t0,
            fallbacks=profiler.counters().get("fused_step_fallbacks", 0)
            - fb0, args={k: v.asnumpy()
                         for k, v in mod.get_params()[0].items()})
    c, s = runs[True], runs[False]
    loss_rel = float((np.abs(c["losses"] - s["losses"])
                      / np.abs(s["losses"])).max())
    w_rel = max(_normwise(c["args"][k], s["args"][k]) for k in s["args"])
    devices = sorted({str(d) for d in seen})

    class Head(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="cfhead_")
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(LM_VOCAB, in_units=LM_HIDDEN)

        def hybrid_forward(self, F, h, label):
            return F.Custom(self.dense(h), label, op_type="cf_softmax")
    head = Head()
    head.initialize(mx.init.Xavier(), ctx=ctx)
    head.hybridize()
    rs = np.random.RandomState(29)
    h = mx.nd.array(rs.randn(LM_BATCH, LM_HIDDEN).astype(np.float32),
                    ctx=ctx)
    lab = mx.nd.array(rs.randint(0, LM_VOCAB, LM_BATCH).astype(np.float32),
                      ctx=ctx)
    outs = [head(h, lab) for _ in range(CF_HEAD_CALLS)]
    want = torch.softmax(head.dense(h)._data, dim=1)
    head_err = _normwise(outs[-1].asnumpy(), want.cpu().numpy())
    hst = head._cached_op.stats()
    print("  (c) bucket %d, %d batches through Module.fit: Custom softmax "
          "loss (NDArray calls on the worker thread) vs SoftmaxOutput on the "
          "fused step: losses max relative difference %.3g, weights %.3g "
          "(tolerance %g); fused-step fallbacks %d vs %d; in_data on %s; "
          "%.2f s vs %.2f s (%.1f vs %.1f ms a step); hybridized block with "
          "F.Custom: stats %s, error %.3g (%s)"
          % (CF_CUSTOM_BUCKET, len(rows), loss_rel, w_rel, CF_CUSTOM_REL,
             c["fallbacks"], s["fallbacks"], devices, c["s"], s["s"],
             c["s"] * 1e3 / len(rows), s["s"] * 1e3 / len(rows), hst,
             head_err, card))
    if len(rows) != CF_CUSTOM_BATCHES or loss_rel > CF_CUSTOM_REL \
            or w_rel > CF_CUSTOM_REL:
        fail("control flow (c): the Custom loss differs from SoftmaxOutput")
    if c["fallbacks"] != len(rows) or s["fallbacks"]:
        fail("control flow (c): fallbacks %d and %d"
             % (c["fallbacks"], s["fallbacks"]))
    if devices != [str(ctx)]:
        fail("control flow (c): the user's in_data sat on %s" % devices)
    if hst["captures"] or hst["eager_host"] != CF_HEAD_CALLS \
            or head_err > CF_SYMBOL_TOL:
        fail("control flow (c): the hybridized Custom block: %s, error %g"
             % (hst, head_err))
    return dict(loss_rel=loss_rel, w_rel=w_rel,
                custom_ms=c["s"] * 1e3 / len(rows),
                softmax_ms=s["s"] * 1e3 / len(rows))


def cf_gluon_lm(mx):
    """(a)'s LM as a Gluon block, its parameters by (a)'s names and its
    time loop ``F.contrib.foreach``; ``gate`` replaces the gates'
    sigmoid (a user Function's, for (d))."""
    H, E, V = LM_HIDDEN, LM_EMBED, LM_VOCAB

    class LM(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="")
            self.gate = None
            shapes = {"embed_weight": (V, E), "pred_weight": (V, H),
                      "pred_bias": (V,)}
            for layer in range(LM_LAYERS):
                p = "lstm_l%d_" % layer
                shapes.update({p + "i2h_weight": (4 * H, E if layer == 0
                                                  else H),
                               p + "i2h_bias": (4 * H,),
                               p + "h2h_weight": (4 * H, H),
                               p + "h2h_bias": (4 * H,)})
            for name, shape in shapes.items():
                setattr(self, name, self.params.get(name, shape=shape))

        def hybrid_forward(self, F, data, **p):
            sig = self.gate or F.sigmoid
            embed = F.Embedding(data, p["embed_weight"], input_dim=V,
                                output_dim=E)
            steps = F.SwapAxis(embed, dim1=0, dim2=1)
            first = F.Reshape(F.slice_axis(steps, axis=0, begin=0, end=1),
                              shape=(-3, -1))
            zero = F.tile(F.slice_axis(first, axis=1, begin=0, end=1) * 0.0,
                          reps=(1, H))

            def step(x, states):
                new = []
                for layer in range(LM_LAYERS):
                    q = "lstm_l%d_" % layer
                    h, c = states[2 * layer], states[2 * layer + 1]
                    gates = F.FullyConnected(x, p[q + "i2h_weight"],
                                             p[q + "i2h_bias"],
                                             num_hidden=4 * H) \
                        + F.FullyConnected(h, p[q + "h2h_weight"],
                                           p[q + "h2h_bias"],
                                           num_hidden=4 * H)
                    g = F.SliceChannel(gates, num_outputs=4, axis=1)
                    c = sig(g[1] + 1.0) * c + sig(g[0]) * F.tanh(g[2])
                    x = sig(g[3]) * F.tanh(c)
                    new += [x, c]
                return x, new
            outs, _ = F.contrib.foreach(step, steps, [zero] * (2 * LM_LAYERS))
            outs = F.SwapAxis(outs, dim1=0, dim2=1)
            return F.FullyConnected(F.Reshape(outs, shape=(-1, H)),
                                    p["pred_weight"], p["pred_bias"],
                                    num_hidden=V)
    return LM()


def cf_stable_sigmoid(mx):
    """The stable sigmoid of MXNet's ``autograd.Function`` docs, its
    output kept on the instance for the backward."""
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            e = mx.nd.exp(-mx.nd.abs(x))
            y = mx.nd.where(x >= 0, 1 / (1 + e), e / (1 + e))
            self.y = y
            return y

        def backward(self, dy):
            return dy * self.y * (1 - self.y)
    return lambda x: Sigmoid()(x)


def cf_symbol_and_function(mx, card, ctx, a):
    """(d): (a)'s LM recorded eagerly on the card as a Gluon block on
    one batch of the first bucket: ``get_symbol`` of its logits bound
    with the block's parameters gives the same logits; the gates through
    a user Function give the built-in sigmoid's gradients."""
    net = cf_gluon_lm(mx)
    net.initialize(ctx=ctx)
    trained = a["mod"].get_params()[0]
    for name, p in net.collect_params().items():
        p.set_data(trained[name].as_in_context(ctx))
    batch = a["batches"][0]
    data = batch.data[0].as_in_context(ctx)
    label = batch.label[0].as_in_context(ctx)
    grads, logits = {}, {}
    for kind in ("builtin", "function"):
        net.gate = None if kind == "builtin" else cf_stable_sigmoid(mx)
        with mx.autograd.record():
            out = net(data)
            loss = mx.nd.softmax_cross_entropy(out, label.reshape((-1,)))
        loss.backward()
        logits[kind] = out
        grads[kind] = {n: p.grad().asnumpy()
                       for n, p in net.collect_params().items()}
    sym = mx.autograd.get_symbol(logits["builtin"])
    params = net.collect_params()
    free = [n for n in sym.list_arguments() if n not in params]
    args = {n: params[n].data() for n in sym.list_arguments() if n in params}
    args.update({n: data for n in free})
    got = sym.bind(ctx, args, grad_req="null").forward()[0].asnumpy()
    sym_err = _normwise(got, logits["builtin"].asnumpy())
    fn_err = max(_normwise(grads["function"][n], grads["builtin"][n])
                 for n in grads["builtin"])
    n_ops = len([n for n in json.loads(sym.tojson())["nodes"]
                 if n["op"] != "null"])
    print("  (d) bucket %d batch recorded eagerly (Gluon block, "
          "F.contrib.foreach): get_symbol -> %d ops, arguments %d (%s the "
          "data), bound with the block's parameters: logits error %.3g "
          "(tolerance %g); the gates through a user autograd.Function "
          "(stable sigmoid): gradients error %.3g against the built-in "
          "sigmoid's (tolerance %g) (%s)"
          % (batch.bucket_key, n_ops, len(sym.list_arguments()), free,
             sym_err, CF_SYMBOL_TOL, fn_err, CF_FUNCTION_TOL, card))
    if len(free) != 1 or sym_err > CF_SYMBOL_TOL:
        fail("control flow (d): get_symbol's logits: free %s, error %g"
             % (free, sym_err))
    if fn_err > CF_FUNCTION_TOL:
        fail("control flow (d): the Function's gradients differ: %g"
             % fn_err)
    return dict(sym_err=sym_err, fn_err=fn_err, n_ops=n_ops)


def cf_monitor_summary(mx, card, a):
    """(e): a Monitor on (a)'s module for one batch (the step falls back
    to the eager one, counted) sees the _foreach node's outputs; the
    foreach LM's print_summary total against the unrolled LM's."""
    from mxnet_tpu_torch import profiler
    mod = a["mod"]
    mon = mx.monitor.Monitor(1, pattern=".*", monitor_all=True)
    mod.install_monitor(mon)
    fb0 = profiler.counters().get("fused_step_fallbacks", 0)
    mon.tic()
    lm_step(mod, a["batches"][0])
    stats = mon.toc()
    fallbacks = profiler.counters().get("fused_step_fallbacks", 0) - fb0
    loop = [(n, v) for _, n, v in stats if n.startswith("lstm_foreach")]
    shape = {"data": (LM_BATCH, LM_BUCKETS[0]),
             "softmax_label": (LM_BATCH, LM_BUCKETS[0])}
    sym = cf_sym_gen(mx)(LM_BUCKETS[0])[0]
    arrays = sum(int(np.prod(s)) for n, s in zip(
        sym.list_arguments(), sym.infer_shape(**shape)[0]) if n not in shape)
    totals = {}
    for what, gen in (("foreach", cf_sym_gen(mx)), ("unrolled",
                                                    lm_sym_gen(mx))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            totals[what] = mx.viz.print_summary(gen(LM_BUCKETS[0])[0],
                                                shape=shape)
        totals[what + "_lines"] = buf.getvalue().count("\n")
    print("  (e) Monitor(monitor_all) for one step: %d stats, the foreach "
          "node's %s; fused-step fallbacks %d; print_summary totals: "
          "foreach %d (%d lines), unrolled %d (%d lines) (the JAX "
          "package's rule: a parameter counts where a layer bears its "
          "prefix, so the cells' are not; the arrays hold %d)"
          % (len(stats), [(n, v.strip()[:12]) for n, v in loop], fallbacks,
             totals["foreach"], totals["foreach_lines"], totals["unrolled"],
             totals["unrolled_lines"], arrays))
    if not loop or fallbacks != 1:
        fail("control flow (e): monitor stats %s, fallbacks %d"
             % ([n for _, n, _ in stats], fallbacks))
    if totals["foreach"] != totals["unrolled"]:
        fail("control flow (e): print_summary totals %s" % totals)
    return totals


def phase_control_flow(card, tfa, ctx=None):
    """The twenty-fifth slice's main path: BASELINE config 3's LM with
    its time loop a foreach, trained on the fused step, generating by a
    while_loop with a cond inside one CUDA graph, a Custom loss, get_symbol
    and a user Function, Monitor and print_summary; (a)-(e) as the module
    docstring sets out; fp32, TF32 off."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    t_phase = time.perf_counter()
    ctx = ctx or mx.gpu(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launches()
    rtc.reset_launches()
    sents = lm_corpus()
    a = cf_foreach_training(mx, card, sents)
    b = cf_generation(mx, card, ctx, a["mod"], sents)
    c = cf_custom(mx, card, ctx, a)
    d = cf_symbol_and_function(mx, card, ctx, a)
    e = cf_monitor_summary(mx, card, a)
    launched = dict(tfa.launches, rtc=rtc.launches["rtc"])
    print("  attention, decode and rtc launches over the phase: %s; phase 29 "
          "%.1f s" % (launched, time.perf_counter() - t_phase))
    if any(launched.values()):
        fail("control flow: kernels launched on a path that has none: %s"
             % launched)
    return dict(a={k: v for k, v in a.items()
                   if k in ("capture_s", "twin_capture_s", "ms", "twin_ms",
                            "rel")}, b=b, c=c, d=d, e=e)


# ---------------------------------------------------------------------------
# phase 30: vision breadth (the SSD and Faster R-CNN heads, deformable
# R-FCN, mx.image, the dgl host ops)
# ---------------------------------------------------------------------------

NMS_SRC = "mxnet_tpu_torch/parallel/csrc/nms_sweep.cu"
NMS_TPU = ("no TPU kernel; replaces lax.scan at mxnet_tpu/ops/detection.py:171"
           " and mxnet_tpu/ops/deformable.py:363")
# MXNet v1.5 example/ssd/symbol/symbol_factory.py get_config('vgg16_reduced',
# 300): six maps, their anchor sizes, ratios and steps (8732 anchors)
SSD_MAPS = (38, 19, 10, 5, 3, 1)
SSD_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
             (.88, .961))
SSD_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
              (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5))
SSD_STEPS = tuple(x / 300.0 for x in (8, 16, 32, 64, 100, 300))
SSD_ANCHORS = 8732
SSD_CLASSES = 21                    # VOC's 20 and the background
SSD_BATCH = 32
SSD_CHECK = 2                       # the head's batch held to its plain path
NMS_CHUNK = 8                       # samples a plain NMS call holds a kernel
                                    # mask to (its IoU: 2.4 GB at n = 8732)
SSD_MAX_OBJECTS = 42
SSD_DETECT = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
# MXNet example/rcnn's test defaults: VGG16, 600 x 1000, stride 16
RCNN_IMAGE = (600, 1000)
RCNN_FEAT = (512, 38, 63)
RCNN_RPN = dict(feature_stride=16, scales=(8.0, 16.0, 32.0),
                ratios=(0.5, 1.0, 2.0), rpn_pre_nms_top_n=6000,
                rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16)
RCNN_POOL = dict(pooled_size=(7, 7), spatial_scale=1.0 / 16)
# Deformable ConvNets' R-FCN, ResNet-101 res5 and its position-sensitive
# heads over 21 classes
RFCN_CONV = dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=512,
                 num_deformable_group=4, no_bias=True)
RFCN_PS = dict(spatial_scale=1.0 / 16, output_dim=21, pooled_size=7,
               group_size=7)
RFCN_DPS = dict(RFCN_PS, part_size=7, sample_per_part=4, trans_std=0.1)
VISION_IMAGES = 256
VISION_HW = 300
VISION_TOL = dict(rtol=1e-5, atol=1e-5)
VISION_REL = 1e-5                   # card against host, normwise


def ssd_anchors(mx, ctx):
    """The 8732 SSD300 anchors from MultiBoxPrior over the six maps."""
    parts = [mx.nd.contrib.MultiBoxPrior(
        mx.nd.zeros((1, 1, s, s), ctx=ctx), sizes=sizes, ratios=ratios,
        steps=(step, step)) for s, sizes, ratios, step
        in zip(SSD_MAPS, SSD_SIZES, SSD_RATIOS, SSD_STEPS)]
    return mx.nd.concat(*parts, dim=1)


def ssd_labels(rs, batch):
    """1-42 boxes an image, classes 0-19, padded with -1 rows."""
    label = np.full((batch, SSD_MAX_OBJECTS, 5), -1, np.float32)
    for b in range(batch):
        k = rs.randint(1, SSD_MAX_OBJECTS + 1)
        lo = rs.uniform(0, 0.8, (k, 2))
        label[b, :k, 0] = rs.randint(0, SSD_CLASSES - 1, k)
        label[b, :k, 1:3] = lo
        label[b, :k, 3:5] = lo + rs.uniform(0.05, 0.2, (k, 2))
    return label


@contextlib.contextmanager
def nms_calls(det, plain=False):
    """Records each ``nms_keep`` call's arguments; with ``plain`` every
    call runs ``nms_keep_plain`` (the plain path on the card)."""
    calls, orig = [], det.nms_keep

    def spy(boxes, thresh, cls=None, plus_one=False):
        calls.append((boxes.detach().clone(), thresh,
                      None if cls is None else cls.detach().clone(),
                      plus_one))
        return (det.nms_keep_plain if plain else orig)(boxes, thresh, cls,
                                                       plus_one)
    det.nms_keep = spy
    try:
        yield calls
    finally:
        det.nms_keep = orig


def nms_bound(keep, cls):
    """(bound ms, bound_by) of one call from this run's data: the IoUs of
    the pairs i < j the class gate lets through (about 14 fp32 operations
    each) at the fp32 peak, against the bytes of the boxes and ids read
    once and the keep mask written once."""
    B, n = keep.shape
    pairs = sum(L * (L - 1) // 2 for L in nms_chains(cls, B, n))
    flops = 14.0 * pairs
    nbytes = B * n * (16 + (4 if cls is not None else 0) + 1)
    t_flops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_flops, t_bytes) * 1e3,
            "operations" if t_flops >= t_bytes else "bytes")


def nms_chains(cls, B, n):
    """The chain lengths of a call: a sample's boxes of one class id (a
    NaN id alone), or each sample whole without a gate."""
    if cls is None:
        return [n] * B
    out = []
    for c in cls.cpu():
        c = c + 0.0
        nan = int(torch.isnan(c).sum())
        out += torch.unique(c[~torch.isnan(c)], return_counts=True)[1] \
            .tolist() + [1] * nan
    return out


def nms_passes_ms(det, boxes, thresh, cls, plus_one):
    """Device ms of each part of one call, each launched alone into a
    CUDA graph over a workspace the whole call filled first (CUDA events
    around the replays): the class order (the stable sort), then the
    kernel's passes: the lists, the short chains, the long chains' mask
    and their sweep (0 where no chain is long: n <= the short limit)."""
    from mxnet_tpu_torch.parallel import _build
    fn = _build.library("nms_sweep")
    B, n = boxes.shape[:2]
    order = det._nms_order(cls)
    work = torch.empty(fn.workspace(B, n), dtype=torch.uint8,
                       device=boxes.device)
    keep = torch.empty((B, n), dtype=torch.bool, device=boxes.device)

    def run(passes):
        det._nms_launch(fn, boxes, thresh, cls, order, plus_one, work, keep,
                        passes, torch.cuda.current_stream().cuda_stream)
    run(det.NMS_ALL_PASSES)
    torch.cuda.synchronize()
    out = dict(order=device_ms(lambda: det._nms_order(cls), iters=5, reps=3)
               if cls is not None else 0.0)
    for name, bit in (("lists", 1), ("short", 2), ("long_mask", 4),
                      ("long_sweep", 8)):
        out[name] = (device_ms(lambda b=bit: run(b), iters=5, reps=3)
                     if bit < 4 or n > det.NMS_SHORT_CHAIN else 0.0)
    run(det.NMS_ALL_PASSES)
    return out


def nms_hold(det, what, calls, samples=None):
    """Each recorded call's kernel keep mask against ``nms_keep_plain``'s
    on the same card inputs, bit for bit, over every sample of the call
    (or its first ``samples``; the plain version NMS_CHUNK samples at a
    time); returns the plain version's ms for each call, its chunks'
    CUDA-event times summed."""
    plain_ms = []
    for boxes, thresh, cls, plus_one in calls:
        got = det.nms_keep(boxes, thresh, cls, plus_one)
        ms = 0.0
        for lo in range(0, min(boxes.shape[0], samples or boxes.shape[0]),
                        NMS_CHUNK):
            sl = slice(lo, lo + NMS_CHUNK)
            c = None if cls is None else cls[sl]
            out = []
            ms += events_ms(lambda: out.append(det.nms_keep_plain(
                boxes[sl], thresh, c, plus_one)))
            if not torch.equal(got[sl], out[0]):
                fail("%s: the nms_sweep keep mask differs from "
                     "nms_keep_plain in samples %d-%d of %s (%d of %d "
                     "entries)" % (what, lo, lo + out[0].shape[0] - 1,
                                   tuple(boxes.shape),
                                   int((got[sl] != out[0]).sum()),
                                   out[0].numel()))
        plain_ms.append(ms)
    return plain_ms


def nms_record(det, what, boxes, thresh, cls, plus_one, plain_ms, launches,
               card):
    """For one path's kernel row, at the shape the path gave the kernel:
    the device ms of the whole ``nms_keep`` call (the class order and the
    kernel's passes, by CUDA-graph replay), each part apart
    (:func:`nms_passes_ms`), the plain version's ms (``plain_ms``, from
    :func:`nms_hold`), the bound, the chains and the launches."""
    def call():
        det.nms_keep(boxes, thresh, cls, plus_one)
    ms = device_ms(call, iters=3, reps=3)
    parts = nms_passes_ms(det, boxes, thresh, cls, plus_one)
    keep = det.nms_keep(boxes, thresh, cls, plus_one)
    bound, by = nms_bound(keep, cls)
    chains = nms_chains(cls, *keep.shape)
    long = [L for L in chains if L > det.NMS_SHORT_CHAIN]
    print("  %s nms_sweep at %s (%s IoU%s): the call %.4f ms (device, by "
          "replay; apart: order %.4f, lists %.4f, short chains %.4f, long "
          "mask %.4f, long sweep %.4f) | plain %.4f ms (its calls of %d "
          "samples, summed) | bound %.4f ms (%s) | %d chains (longest %d; %d "
          "over %d boxes) | %d kept | launches on the path %d (%s)"
          % (what, tuple(boxes.shape[:2]), "+1" if plus_one else "corner",
             ", class-gated" if cls is not None else "", ms, parts["order"],
             parts["lists"], parts["short"], parts["long_mask"],
             parts["long_sweep"], plain_ms, NMS_CHUNK, bound, by,
             len(chains), max(chains), len(long), det.NMS_SHORT_CHAIN,
             int(keep.sum()), launches, card))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, err=0.0, launches=launches,
                parts_ms=parts)


def ssd_inputs(mx, ctx):
    """(a)'s anchors, class probabilities, box offsets and labels at
    batch SSD_BATCH (seed 0)."""
    rs = np.random.RandomState(0)
    anchors = ssd_anchors(mx, ctx)
    if anchors.shape != (1, SSD_ANCHORS, 4):
        fail("(a): MultiBoxPrior gave %s anchors, want %d"
             % (anchors.shape, SSD_ANCHORS))
    logits = rs.standard_normal((SSD_BATCH, SSD_CLASSES, SSD_ANCHORS)) \
        .astype(np.float32)
    cls_prob = mx.nd.softmax(mx.nd.array(logits, ctx=ctx), axis=1)
    loc = mx.nd.array((rs.standard_normal((SSD_BATCH, 4 * SSD_ANCHORS))
                       * 0.2).astype(np.float32), ctx=ctx)
    label = mx.nd.array(ssd_labels(rs, SSD_BATCH), ctx=ctx)
    return anchors, cls_prob, loc, label


def vision_force(mx, det, card, anchors, cls_prob, loc):
    """(a'): MultiBoxDetection with force_suppress=True at B32 (one chain
    of 8732 boxes a sample), nms_sweep counted (1), its keep mask held on
    its first NMS_CHUNK samples (the row's plain ms is theirs), the call
    timed."""
    torch.cuda.synchronize()
    det.reset_launches()
    with nms_calls(det) as calls:
        dets = mx.nd.contrib.MultiBoxDetection(
            cls_prob, loc, anchors, force_suppress=True, **SSD_DETECT)
        torch.cuda.synchronize()
    launched = det.launches["nms_sweep"]
    if launched != 1 or len(calls) != 1 or calls[0][2] is not None:
        fail("(a') force_suppress launched nms_sweep %d times (%d calls), "
             "want 1 ungated" % (launched, len(calls)))
    if not bool(torch.isfinite(dets._data).all()):
        fail("(a') a detection is not finite")
    plain_ms = nms_hold(det, "(a')", calls, samples=NMS_CHUNK)
    boxes, thresh, _, _ = calls[0]
    return nms_record(det, "(a') ssd force_suppress", boxes, thresh, None,
                      False, plain_ms[0], launched, card)


def vision_ssd(mx, det, card, ctx):
    """(a): the SSD300 head at batch 32 on the card."""
    t0 = time.perf_counter()
    anchors, cls_prob, loc, label = ssd_inputs(mx, ctx)

    def head(cp, lp, lab):
        tgt = mx.nd.contrib.MultiBoxTarget(anchors, lab, cp)
        dets = mx.nd.contrib.MultiBoxDetection(cp, lp, anchors, **SSD_DETECT)
        kept = mx.nd.contrib.box_nms(dets, overlap_thresh=0.45,
                                     valid_thresh=0.01, id_index=0)
        return list(tgt) + [dets, kept]
    torch.cuda.synchronize()
    det.reset_launches()
    with nms_calls(det) as calls:
        outs = head(cls_prob, loc, label)
        torch.cuda.synchronize()
    launched = det.launches["nms_sweep"]
    if launched != 2 or len(calls) != 2:
        fail("(a): the head launched nms_sweep %d times (%d calls), want 2"
             % (launched, len(calls)))
    for o in outs:
        if not bool(torch.isfinite(o._data).all()):
            fail("(a): a head output is not finite")
    dets = outs[3]._data
    n_kept = int((dets[..., 0] >= 0).sum())
    n_final = int((outs[4]._data[..., 1] >= 0).sum())
    if not (outs[0].shape == (SSD_BATCH, 4 * SSD_ANCHORS)
            and dets.shape == (SSD_BATCH, SSD_ANCHORS, 6) and n_kept > 0):
        fail("(a): head shapes %s, %d detections"
             % ([o.shape for o in outs], n_kept))
    plain_ms = nms_hold(det, "(a)", calls)
    # the head at batch 2 through the plain path on the card
    sl = [x[:SSD_CHECK] for x in (cls_prob, loc, label)]
    got = head(*sl)
    with nms_calls(det, plain=True):
        want = head(*sl)
    err = 0.0
    for g, w in zip(got, want):
        e, ok = close(g._data, w._data, VISION_TOL)
        err = max(err, e)
        if not ok:
            fail("(a): the head at B%d differs from its plain path by %.3g"
                 % (SSD_CHECK, e))
    boxes, thresh, cls, _ = calls[0]
    rec = nms_record(det, "(a) ssd", boxes, thresh, cls, False, plain_ms[0],
                     launched, card)
    # B32: the whole head by CUDA-graph replay
    tensors = [cls_prob._data, loc._data, label._data]
    invoke = [(mx.ops.get_op(n), a) for n, a in (
        ("_contrib_MultiBoxTarget", {}),
        ("_contrib_MultiBoxDetection", SSD_DETECT),
        ("_contrib_box_nms", dict(overlap_thresh=0.45, valid_thresh=0.01,
                                  id_index=0)))]

    def head_t():
        cp, lp, lab = tensors
        a = anchors._data
        mx.ops.invoke(invoke[0][0], [a, lab, cp], invoke[0][1])
        d = mx.ops.invoke(invoke[1][0], [cp, lp, a], invoke[1][1])[0][0]
        mx.ops.invoke(invoke[2][0], [d], invoke[2][1])
    head_ms = device_ms(head_t, iters=2, reps=3)
    print("  (a) SSD300 head (vgg16_reduced 300: maps %s, %d anchors, %d "
          "classes), batch %d, 1-%d boxes an image: MultiBoxTarget, "
          "MultiBoxDetection (nms_threshold 0.45, threshold 0.01, nms_topk "
          "400: not read, as in the JAX package), box_nms; %d detections "
          "kept, %d after box_nms; nms_sweep launched %d times; %d keep "
          "masks bit-equal to nms_keep_plain over all %d samples; the head "
          "at B%d equal to its plain path within rtol = atol = 1e-5 (max abs "
          "err %.3g)"
          % (SSD_MAPS, SSD_ANCHORS, SSD_CLASSES, SSD_BATCH, SSD_MAX_OBJECTS,
             n_kept, n_final, launched, len(plain_ms), SSD_BATCH, SSD_CHECK,
             err))
    print("  (a) B%d by CUDA-graph replay: the head %.3f ms a batch, "
          "nms_sweep %.3f ms a call of it; %.1f s (%s)"
          % (SSD_BATCH, head_ms, rec["ms"], time.perf_counter() - t0, card))
    rec["head_ms"] = head_ms
    rec["force"] = vision_force(mx, det, card, anchors, cls_prob, loc)
    return rec, anchors, cls_prob


def card_vs_host(what, fn, arrays, grad=True):
    """Normwise relative errors (forward, gradient) of ``fn(*nd
    arrays)`` on gpu(0) against cpu() from the same numpy arrays, the
    gradient of the float inputs under a sum of the outputs."""
    import mxnet_tpu_torch as mx
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        xs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
        diff = [x for x in xs if grad and x.dtype == np.float32]
        for x in diff:
            x.attach_grad()
        with mx.autograd.record():
            out = fn(*xs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = sum((o * o).sum() for o in outs)
        if diff:
            loss.backward()
        res.append(([o._data.detach().cpu() for o in outs],
                    [x.grad._data.cpu() for x in diff]))
    (g_o, g_g), (c_o, c_g) = res
    fwd = max(_rel_err(g, c) for g, c in zip(g_o, c_o))
    bwd = max([_rel_err(g, c) for g, c in zip(g_g, c_g)] or [0.0])
    if not (fwd <= VISION_REL and bwd <= VISION_REL):
        fail("%s: card and host differ: forward %.3g, gradient %.3g"
             % (what, fwd, bwd))
    return fwd, bwd, g_o


def rcnn_inputs(mx, ctx):
    """(b)'s RPN scores, deltas and image info at B2 (seed 1); returns the
    generator, drawn on after them, and the three arrays."""
    rs = np.random.RandomState(1)
    _, Hf, Wf = RCNN_FEAT
    A = len(RCNN_RPN["scales"]) * len(RCNN_RPN["ratios"])
    cls = rs.uniform(0, 1, (2, 2 * A, Hf, Wf)).astype(np.float32)
    box = (rs.standard_normal((2, 4 * A, Hf, Wf)) * 0.1).astype(np.float32)
    info = np.array([RCNN_IMAGE + (1.0,)] * 2, np.float32)
    return rs, [mx.nd.array(a, ctx=ctx) for a in (cls, box, info)]


def vision_rcnn(mx, det, card, ctx):
    """(b): Faster R-CNN's proposals, ROIPooling and ROIAlign."""
    t0 = time.perf_counter()
    rs, nd_in = rcnn_inputs(mx, ctx)
    C, Hf, Wf = RCNN_FEAT

    def rpn(c, b, i):
        return [mx.nd.contrib.Proposal(c[:1], b[:1], i[:1], **RCNN_RPN),
                mx.nd.contrib.MultiProposal(c, b, i, output_score=True,
                                            **RCNN_RPN)]
    torch.cuda.synchronize()
    det.reset_launches()
    with nms_calls(det) as calls:
        props = rpn(*nd_in)
        torch.cuda.synchronize()
    launched = det.launches["nms_sweep"]
    if launched != 2:
        fail("(b): the proposals launched nms_sweep %d times, want 2"
             % launched)
    with nms_calls(det, plain=True):
        plain = rpn(*nd_in)
    same = torch.equal(props[0]._data, plain[0]._data) and all(
        torch.equal(g._data, w._data) for g, w in zip(props[1], plain[1]))
    if not same:
        fail("(b): the proposals differ from their plain path")
    plain_ms = nms_hold(det, "(b)", calls)
    rois = props[0]
    if rois.shape != (RCNN_RPN["rpn_post_nms_top_n"], 5):
        fail("(b): Proposal gave %s" % (rois.shape,))
    boxes, thresh, _, _ = calls[0]
    rec = nms_record(det, "(b) rpn", boxes, thresh, None, True, plain_ms[0],
                     launched, card)
    # ROIPooling / ROIAlign over the 300 proposals, forward and backward
    feat = rs.standard_normal((1, C, Hf, Wf)).astype(np.float32)
    r_np = rois.asnumpy()
    six = rois.shape[0] * 7 * 7 * C * Hf * Wf * 4
    peaks = {}
    for name, attrs in (("ROIPooling", RCNN_POOL),
                        ("ROIAlign", dict(RCNN_POOL, sample_ratio=2))):
        x = mx.nd.array(feat, ctx=ctx)
        x.attach_grad()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with mx.autograd.record():
            out = getattr(mx.nd, name)(x, rois, **attrs)
        out.backward()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        if not (bool(torch.isfinite(x.grad._data).all())
                and out.shape == (rois.shape[0], C, 7, 7)):
            fail("(b) %s: shape %s or a gradient not finite"
                 % (name, out.shape))
        ms = stream_ms(lambda: getattr(mx.nd, name)(x, rois, **attrs), 3)
        fwd, bwd, _ = card_vs_host(
            "(b) " + name, lambda d, r: getattr(mx.nd, name)(d, r, **attrs),
            [feat, r_np[:32]])
        print("  (b) %s 7x7 of (1, %d, %d, %d) over %d RoIs: forward %.3f ms;"
              " peak memory forward and backward %.1f MB (an (R, PH, PW, C, "
              "H, W) tensor would be %.1f GB); card vs host on 32 RoIs: "
              "forward %.3g, gradient %.3g" % (
                  name, C, Hf, Wf, rois.shape[0], ms, peaks[name] / 2**20,
                  six / 2**30, fwd, bwd))
        if peaks[name] >= six / 8:
            fail("(b) %s: peak %d bytes, near the (R, PH, PW, C, H, W) "
                 "tensor's %d" % (name, peaks[name], six))
    print("  (b) Faster R-CNN (VGG16, example/rcnn's test defaults: %dx%d, "
          "stride 16, scales %s, ratios %s, pre %d, post %d, threshold "
          "%g, min size %d): Proposal at B1 and MultiProposal at B2 equal "
          "their plain path bit for bit, %d keep masks bit-equal; %.1f s"
          % (RCNN_IMAGE + (RCNN_RPN["scales"], RCNN_RPN["ratios"],
                           RCNN_RPN["rpn_pre_nms_top_n"],
                           RCNN_RPN["rpn_post_nms_top_n"],
                           RCNN_RPN["threshold"], RCNN_RPN["rpn_min_size"],
                           len(plain_ms), time.perf_counter() - t0)))
    rec["peaks"] = peaks
    return rec, r_np


def vision_rfcn(mx, card, rois):
    """(c): the deformable R-FCN head, forward and backward, card against
    host."""
    t0 = time.perf_counter()
    rs = np.random.RandomState(2)
    C, Hf, Wf = RCNN_FEAT
    data = rs.standard_normal((1, C, Hf, Wf)).astype(np.float32)
    offset = (rs.standard_normal((1, 72, Hf, Wf)) * 0.5).astype(np.float32)
    weight = (rs.standard_normal((C, C, 3, 3)) / 48).astype(np.float32)
    ps = rs.standard_normal((1, 21 * 49, Hf, Wf)).astype(np.float32)
    trans = (rs.standard_normal((rois.shape[0], 2, 7, 7)) * 0.5).astype(
        np.float32)
    rows = []
    for what, fn, arrays in (
            ("DeformableConvolution 3x3 512->512 pad 2 dilate 2, 4 groups",
             lambda d, o, w: mx.nd.contrib.DeformableConvolution(
                 d, o, w, **RFCN_CONV), [data, offset, weight]),
            ("PSROIPooling 21 x 7x7 over %d RoIs" % rois.shape[0],
             lambda d, r: mx.nd.contrib.PSROIPooling(d, r, **RFCN_PS),
             [ps, rois]),
            ("DeformablePSROIPooling, 4 samples a part, trans_std 0.1",
             lambda d, r, t: mx.nd.contrib.DeformablePSROIPooling(
                 d, r, t, **RFCN_DPS), [ps, rois, trans])):
        fwd, bwd, outs = card_vs_host("(c) " + what, fn, arrays)
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            fail("(c) %s: not finite" % what)
        xs = [mx.nd.array(a, ctx=mx.gpu(0)) for a in arrays]
        ms = stream_ms(lambda: fn(*xs), 3)
        rows.append((what, tuple(outs[0].shape), ms, fwd, bwd))
    for what, shape, ms, fwd, bwd in rows:
        print("  (c) %s -> %s: forward %.3f ms; card vs host forward %.3g, "
              "gradient %.3g (%s)" % (what, shape, ms, fwd, bwd, card))
    print("  (c) deformable R-FCN head: %.1f s" % (time.perf_counter() - t0))


def vision_image(mx, card, anchors, cls_prob, tmp):
    """(d): ImageDetIter over a .rec of 256 synthetic 300x300 JPEGs with
    CreateDetAugmenter's crops, pads and mirrors, its batches into (a)'s
    MultiBoxTarget."""
    import cv2
    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    prefix = os.path.join(tmp, "vision")
    rec = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    yy, xx = np.mgrid[0:VISION_HW, 0:VISION_HW]
    for i in range(VISION_IMAGES):
        img = np.stack([(xx + i) % 256, (yy * 2 + i) % 256,
                        rs.randint(0, 256, (VISION_HW, VISION_HW)) // 64
                        * 64], -1).astype(np.uint8)
        k = rs.randint(1, 7)
        objs = np.zeros((k, 5), np.float32)
        lo = rs.uniform(0, 0.7, (k, 2))
        objs[:, 0] = rs.randint(0, SSD_CLASSES - 1, k)
        objs[:, 1:3], objs[:, 3:5] = lo, lo + rs.uniform(0.1, 0.3, (k, 2))
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        rec.write_idx(i, mx.recordio.pack(mx.recordio.IRHeader(
            0, np.concatenate([[2, 5], objs.reshape(-1)]), i, 0),
            buf.tobytes()))
    rec.close()
    write_s = time.perf_counter() - t0
    random.seed(0)
    it = mx.image.ImageDetIter(
        batch_size=SSD_BATCH, data_shape=(3, VISION_HW, VISION_HW),
        path_imgrec=prefix + ".rec", shuffle=True, rand_crop=0.5,
        rand_pad=0.5, rand_mirror=True, mean=True, std=True)
    t1 = time.perf_counter()
    batches = list(it)
    read_s = time.perf_counter() - t1
    if len(batches) != VISION_IMAGES // SSD_BATCH:
        fail("(d): %d batches" % len(batches))
    b = batches[-1]
    tgt = mx.nd.contrib.MultiBoxTarget(anchors, b.label[0], cls_prob)
    ok = (b.data[0].shape == (SSD_BATCH, 3, VISION_HW, VISION_HW)
          and b.data[0].context == mx.gpu(0)
          and bool(torch.isfinite(b.data[0]._data).all())
          and all(bool(torch.isfinite(t._data).all()) for t in tgt)
          and float(tgt[1].sum().asscalar()) > 0)
    if not ok:
        fail("(d): a batch or its MultiBoxTarget is wrong")
    print("  (d) mx.image: ImageDetIter (CreateDetAugmenter rand_crop 0.5, "
          "rand_pad 0.5, rand_mirror, mean/std) over a .rec of %d synthetic "
          "%dx%d JPEGs (written in %.1f s): %d batches of %s, label shape "
          "%s (-1 padded), %.1f images/s; the last batch's labels through "
          "(a)'s MultiBoxTarget: %d anchors matched (%s)"
          % (VISION_IMAGES, VISION_HW, VISION_HW, write_s, len(batches),
             b.data[0].shape, b.label[0].shape, VISION_IMAGES / read_s,
             int(tgt[1].sum().asscalar()) // 4, card))
    return VISION_IMAGES / read_s


def vision_host_ops(mx, card):
    """(e): a hybridized block holding dgl ops on gpu(0): each predict
    call op by op, counted as eager_host, no capture, results on the
    card."""
    class Sample(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, indptr, indices, eids, seeds):
            adj = F.contrib.dgl_adjacency(indptr, indices, eids)
            sub = F.contrib.dgl_csr_neighbor_uniform_sample(
                indptr, indices, eids, seeds, num_args=4, num_hops=2,
                num_neighbor=2, max_num_vertices=16)
            return adj[2] * 2.0, sub[0]
    n = 64
    rows = [sorted({(v + d) % n for d in (1, 3, 7)}) for v in range(n)]
    indptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    indices = np.array([u for r in rows for u in r], np.int64)
    args = [mx.nd.array(a, ctx=mx.gpu(0), dtype=np.int64) for a in (
        indptr, indices, np.arange(indices.shape[0]), np.array([0, 5]))]
    blk = Sample()
    blk.hybridize()
    for _ in range(3):
        w, verts = blk(*args)
    st = blk._cached_op.stats()
    on_card = w.context == mx.gpu(0) and verts.context == mx.gpu(0)
    print("  (e) dgl host ops in a hybridized block on gpu(0): 3 calls, "
          "stats %s, results on %s, %d vertices sampled (%s)"
          % (st, w.context, int(verts.asnumpy()[-1]), card))
    if not (st["eager_host"] == 3 and st["captures"] == 0 and on_card):
        fail("(e): the dgl ops were not run op by op on the host: %s" % st)


def phase_vision(card, tfa):
    """Phase 30 (see the module docstring)."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import detection as det
    t_phase = time.perf_counter()
    ctx = mx.gpu(0)
    tfa.reset_launches()
    rtc.reset_launches()
    ssd, anchors, cls_prob = vision_ssd(mx, det, card, ctx)
    rpn, rois = vision_rcnn(mx, det, card, ctx)
    vision_rfcn(mx, card, rois)
    with tempfile.TemporaryDirectory() as tmp:
        vision_image(mx, card, anchors, cls_prob, tmp)
    vision_host_ops(mx, card)
    launched = dict(tfa.launches, rtc=rtc.launches["rtc"])
    print("  attention, decode and rtc launches over the phase: %s; phase 30 "
          "%.1f s" % (launched, time.perf_counter() - t_phase))
    if any(launched.values()):
        fail("vision: kernels launched on a path that has none: %s"
             % launched)
    return dict(ssd=ssd, rpn=rpn)


# ---------------------------------------------------------------------------
# phase 31: the rest of the breadth (gluon.contrib.rnn, contrib, helpers)
# ---------------------------------------------------------------------------

# (a) Shi et al. 2015, "Convolutional LSTM Network" (NeurIPS), its best
# Moving MNIST model: 64x64 frames cut into 4x4 patches (16 channels of
# 16x16), an encoder of three ConvLSTM cells (128, 64, 64 hidden, 5x5
# i2h and h2h) reading 10 frames, a forecaster of the same widths
# unrolled 10 steps from the encoder's states (its input blank), a 1x1
# convolution over the forecaster's concatenated states to 16 channels,
# per-pixel sigmoid cross-entropy; RMSProp lr 1e-3, decay 0.9 (the
# paper's); batch 16 of synthetic bouncing squares from seed 0 in place
# of Moving MNIST (nothing is downloaded)
CLSTM_FRAME = 64
CLSTM_PATCH = 4
CLSTM_HIDDEN = (128, 64, 64)
CLSTM_KERNEL = 5
CLSTM_IN = 10
CLSTM_OUT = 10
CLSTM_BATCH = 16
CLSTM_STEPS = 12
CLSTM_RMSPROP = dict(learning_rate=1e-3, gamma1=0.9)
CLSTM_TOL = dict(rtol=1e-5, atol=1e-5)
# (b) MXNet v1.5 example/rnn/large_word_lm's LSTM-2048-512: embedding 512,
# an LSTMPCell(2048, 512) under a VariationalDropoutCell (0.1 on inputs,
# states and outputs), bptt 20, batch 128; the head cut to a full softmax
# over 10,000 ids (the example's sampled softmax over 793,471 ids is not
# in the JAX package)
LWLM_VOCAB = 10000
LWLM_EMBED = 512
LWLM_HIDDEN = 2048
LWLM_BPTT = 20
LWLM_BATCH = 128
LWLM_DROP = 0.1
# (c) tests/test_aux_subsystems.py's least-squares SVRG problem
SVRG_N, SVRG_D, SVRG_BATCH, SVRG_LR = 64, 5, 16, 0.05
SVRG_TOL = dict(rtol=1e-5, atol=1e-6)
# (d) check_consistency of (a)'s first cell over [cpu(), gpu(0)], batch 4
CONSIST_BATCH = 4
STORAGE_PROBE_BYTES = 256 * 2 ** 20


def bouncing_squares(n, frames, size, seed):
    """``(n, frames, size, size)`` float32 in {0, 1}: two squares a
    sequence (6-12 px) moving 1-4 px a frame, bouncing off the walls."""
    rs = np.random.RandomState(seed)
    out = np.zeros((n, frames, size, size), np.float32)
    for i in range(n):
        for _ in range(2):
            side = rs.randint(6, 13)
            pos = rs.uniform(0, size - side, 2)
            vel = rs.uniform(1, 4, 2) * rs.choice([-1, 1], 2)
            for t in range(frames):
                y, x = pos.astype(int)
                out[i, t, y:y + side, x:x + side] = 1.0
                pos = pos + vel
                for d in range(2):
                    if pos[d] < 0 or pos[d] > size - side:
                        vel[d] = -vel[d]
                        pos[d] = min(max(pos[d], 0), size - side)
    return out


def patched(frames, patch):
    """``(n, T, H, W)`` -> ``(n, T, patch * patch, H / patch, W / patch)``
    (the paper's 4x4 patches as channels)."""
    n, t, h, w = frames.shape
    x = frames.reshape(n, t, h // patch, patch, w // patch, patch)
    return np.ascontiguousarray(x.transpose(0, 1, 3, 5, 2, 4).reshape(
        n, t, patch * patch, h // patch, w // patch))


def convlstm_net(mx):
    """(a)'s encoder-forecaster as one HybridBlock: ``net(x, blank,
    *states)`` with ``x`` (B, CLSTM_IN, C, S, S), ``blank`` the
    forecaster's (B, C, S, S) zero input and the encoder's six begin
    states; returns the forecast logits (B, CLSTM_OUT, C, S, S)."""
    crnn = mx.gluon.contrib.rnn
    chans = CLSTM_PATCH * CLSTM_PATCH
    size = CLSTM_FRAME // CLSTM_PATCH

    class ConvLSTMForecaster(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = mx.gluon.rnn.HybridSequentialRNNCell()
                self.forecaster = mx.gluon.rnn.HybridSequentialRNNCell()
                for seq in (self.encoder, self.forecaster):
                    c_in = chans
                    for hid in CLSTM_HIDDEN:
                        seq.add(crnn.Conv2DLSTMCell(
                            (c_in, size, size), hid, CLSTM_KERNEL,
                            CLSTM_KERNEL, i2h_pad=CLSTM_KERNEL // 2))
                        c_in = hid
                self.head = mx.gluon.nn.Conv2D(
                    chans, 1, in_channels=sum(CLSTM_HIDDEN))

        def hybrid_forward(self, F, x, blank, *states):
            _, states = self.encoder.unroll(
                CLSTM_IN, x, begin_state=list(states), layout="NTC",
                merge_outputs=True)
            self.forecaster.reset()
            preds = []
            for _ in range(CLSTM_OUT):
                _, states = self.forecaster(blank, states)
                preds.append(self.head(F.concat(*states[0::2], dim=1)))
            return F.stack(*preds, axis=1)
    return ConvLSTMForecaster()


def convlstm_train(mx, card, ctx):
    """(a): the first step's loss hybridized against an un-hybridized
    twin with the same weights, then CLSTM_STEPS Trainer steps on the
    fused update (1 capture, 0 recaptures), the loss falling."""
    from mxnet_tpu_torch.gluon.convert import params_from_numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = patched(bouncing_squares(CLSTM_BATCH, CLSTM_IN + CLSTM_OUT,
                                      CLSTM_FRAME, 0), CLSTM_PATCH)
    x = mx.nd.array(frames[:, :CLSTM_IN], ctx=ctx)
    y = mx.nd.array(frames[:, CLSTM_IN:], ctx=ctx)
    blank = mx.nd.zeros((CLSTM_BATCH,) + frames.shape[2:], ctx=ctx)
    net = convlstm_net(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    states = net.encoder.begin_state(batch_size=CLSTM_BATCH, ctx=ctx)
    twin = convlstm_net(mx)
    twin.initialize(ctx=ctx)
    params_from_numpy(twin, {k: p.data().asnumpy() for k, p in
                             net._collect_params_with_prefix().items()},
                      ctx=ctx)
    n_params = sum(p.data().size for p in net.collect_params().values())
    loss_fn = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()

    def loss_of(block):
        return loss_fn(block(x, blank, *states), y).mean()
    with mx.autograd.record():
        eager = loss_of(twin)
    eager.backward()
    eager_loss = float(eager.asscalar())
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "rmsprop",
                               dict(CLSTM_RMSPROP))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    curve, ms = [], []
    for _ in range(CLSTM_STEPS):
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_of(net)
        loss.backward()
        trainer.step(1)
        curve.append(float(loss.asscalar()))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fst = trainer._fused_updater.stats()
    print("  (a) Shi et al.'s ConvLSTM encoder-forecaster (%s hidden, %dx%d "
          "kernels, %d -> %d frames of %dx%d as %d %dx%d patches), batch %d, "
          "%.2fM parameters, RMSProp %s, hybridized: step-1 loss %.7f, the "
          "un-hybridized twin's %.7f; losses %s; %.1f ms a step (median of "
          "steps 2-%d), peak %.2f GiB; the fused update's graphs %s (%s)"
          % (CLSTM_HIDDEN, CLSTM_KERNEL, CLSTM_KERNEL, CLSTM_IN, CLSTM_OUT,
             CLSTM_FRAME, CLSTM_FRAME, CLSTM_PATCH ** 2,
             CLSTM_FRAME // CLSTM_PATCH, CLSTM_FRAME // CLSTM_PATCH,
             CLSTM_BATCH, n_params / 1e6, CLSTM_RMSPROP, curve[0],
             eager_loss, [round(v, 5) for v in curve],
             statistics.median(ms[1:]), CLSTM_STEPS, peak, fst, card))
    if not np.isclose(curve[0], eager_loss, **CLSTM_TOL):
        fail("(a) the hybridized step-1 loss %.8f differs from the "
             "un-hybridized twin's %.8f" % (curve[0], eager_loss))
    if fst["captures"] != 1 or fst["recaptures"] != 0:
        fail("(a) the fused update's graphs %s, want 1 capture and no "
             "recapture" % fst)
    if not all(np.isfinite(curve)) or curve[-1] >= curve[0]:
        fail("(a) the loss did not fall: %s" % curve)
    return dict(net=net, x=x, blank=blank, states=states, curve=curve,
                ms=statistics.median(ms[1:]), peak_gib=peak)


def large_word_lm(mx, card, ctx):
    """(b): VariationalDropoutCell(LSTMPCell(2048, 512)) at the example's
    width, hybridized: one fwd + bwd; each mask one ``Dropout`` node of
    the traced graph, the output mask the same at every step of a call,
    scaled by 1/(1-p), a fresh mask at the next call; in predict mode the
    block's one CUDA graph with all-ones masks."""
    crnn = mx.gluon.contrib.rnn

    class LM(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = mx.gluon.nn.Embedding(LWLM_VOCAB, LWLM_EMBED)
                self.cell = crnn.VariationalDropoutCell(
                    crnn.LSTMPCell(LWLM_HIDDEN, LWLM_EMBED,
                                   input_size=LWLM_EMBED),
                    drop_inputs=LWLM_DROP, drop_states=LWLM_DROP,
                    drop_outputs=LWLM_DROP)
                self.out = mx.gluon.nn.Dense(LWLM_VOCAB, flatten=False,
                                             in_units=LWLM_EMBED)

        def hybrid_forward(self, F, tokens, r0, c0):
            outs, _ = self.cell.unroll(LWLM_BPTT, self.embed(tokens),
                                       begin_state=[r0, c0], layout="NTC",
                                       merge_outputs=True)
            return self.out(outs), outs, self.cell.drop_outputs_mask
    net = LM()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    rs = np.random.RandomState(3)
    tokens = mx.nd.array(rs.randint(0, LWLM_VOCAB, (LWLM_BATCH, LWLM_BPTT)),
                         ctx=ctx)
    labels = mx.nd.array(rs.randint(0, LWLM_VOCAB, (LWLM_BATCH, LWLM_BPTT)),
                         ctx=ctx)
    r0, c0 = net.cell.begin_state(batch_size=LWLM_BATCH, ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            logits, outs, mask = net(tokens, r0, c0)
            loss = loss_fn(logits, labels).mean()
        loss.backward()
        torch.cuda.synchronize()
        runs.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                         loss=float(loss.asscalar()),
                         zero=(outs._data == 0).cpu().numpy(),
                         mask=mask._data.cpu().numpy()))
    graph = net._cached_graph[1]
    dropouts = sum(1 for n in graph._topo_nodes()
                   if n.op is not None and n.op.name == "Dropout")
    shared = all(np.array_equal(r["zero"][:, t], r["mask"] == 0)
                 for r in runs for t in range(LWLM_BPTT))
    scale = [float(np.unique(r["mask"][r["mask"] != 0]).max()) for r in runs]
    fresh = not np.array_equal(runs[0]["mask"], runs[1]["mask"])
    drop_share = [float((r["mask"] == 0).mean()) for r in runs]
    cst0 = net._cached_op.stats()
    pred = [net(tokens, r0, c0)[2]._data.cpu().numpy() for _ in range(2)]
    cst = net._cached_op.stats()
    grads_ok = all(np.isfinite(p.grad().asnumpy()).all()
                   for p in net.collect_params().values())
    print("  (b) large_word_lm's LSTM-2048-512 (embedding %d, bptt %d, batch "
          "%d, vocab cut to %d, full softmax), VariationalDropoutCell %.1f on "
          "inputs, states and outputs, hybridized: fwd + bwd %.1f / %.1f ms, "
          "losses %.5f / %.5f; %d Dropout nodes in the traced graph; the "
          "output mask shared by all %d steps: %s; kept scale %s (want "
          "%.6f); dropped shares %s; the second call's mask fresh: %s; "
          "predict mode %s -> %s (masks all ones: %s) (%s)"
          % (LWLM_EMBED, LWLM_BPTT, LWLM_BATCH, LWLM_VOCAB, LWLM_DROP,
             runs[0]["ms"], runs[1]["ms"], runs[0]["loss"], runs[1]["loss"],
             dropouts, LWLM_BPTT, shared, scale, 1 / (1 - LWLM_DROP),
             [round(s, 4) for s in drop_share], fresh, cst0, cst,
             all((p == 1).all() for p in pred), card))
    if dropouts != 3 or not shared or not fresh or not grads_ok:
        fail("(b) the variational masks: %d Dropout nodes (want 3), shared "
             "%s, fresh %s, finite gradients %s"
             % (dropouts, shared, fresh, grads_ok))
    if any(abs(s - 1 / (1 - LWLM_DROP)) > 1e-6 for s in scale) or \
            any(abs(d - LWLM_DROP) > 0.02 for d in drop_share):
        fail("(b) the masks' scale %s or dropped share %s" % (scale,
                                                               drop_share))
    if cst["captures"] - cst0["captures"] != 1 or cst["recaptures"] or \
            not all((p == 1).all() for p in pred):
        fail("(b) predict mode: graphs %s -> %s, masks all ones %s"
             % (cst0, cst, [bool((p == 1).all()) for p in pred]))
    return dict(ms=runs[1]["ms"])


def svrg_on_card(mx, card, ctx):
    """(c): SVRGModule on gpu(0) fed by contrib.io.DataLoaderIter: two
    steps after a snapshot against w - lr (g - g_snap + g_full) by hand
    on the card (the fused step is on, so a dropped correction shows),
    then ``fit`` with the mse falling."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule
    from mxnet_tpu_torch.fused_step import fused_step_enabled
    rng = np.random.RandomState(0)
    w_true = rng.randn(SVRG_D, 1).astype(np.float32)
    X = rng.randn(SVRG_N, SVRG_D).astype(np.float32)
    y = (X @ w_true).ravel()
    w0 = np.random.RandomState(7).normal(0, 0.1, (1, SVRG_D)) \
        .astype(np.float32)
    data = mx.sym.var("data")
    out = mx.sym.LinearRegressionOutput(
        mx.sym.FullyConnected(data, num_hidden=1, no_bias=True, name="fc"),
        mx.sym.var("lin_label"), name="lin")

    def feed():
        ds = mx.gluon.data.ArrayDataset(mx.nd.array(X, ctx=ctx),
                                        mx.nd.array(y, ctx=ctx))
        return mx.contrib.io.DataLoaderIter(
            mx.gluon.data.DataLoader(ds, batch_size=SVRG_BATCH),
            label_name="lin_label")

    def module():
        mod = SVRGModule(out, data_names=("data",),
                         label_names=("lin_label",), context=ctx,
                         update_freq=1)
        it = feed()
        mod.bind(it.provide_data, it.provide_label, for_training=True)
        mod.init_params(arg_params={"fc_weight": mx.nd.array(w0, ctx=ctx)})
        return mod, it
    mod, it = module()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": SVRG_LR})
    mod.update_full_grads(it)
    batches = list(it)
    it.reset()
    falls0 = profiler.counters().get("fused_step_fallbacks", 0)
    got = []
    for b in batches[:2]:
        mod.forward_backward(b)
        mod.update()
        got.append(mod.get_params()[0]["fc_weight"]._data.clone())
    falls = profiler.counters().get("fused_step_fallbacks", 0) - falls0
    # by hand on the card: the gradient of LinearRegressionOutput summed
    # over a batch, the optimizer's rescale 1/batch
    dev = ctx.torch_device()
    Xd, yd = torch.tensor(X, device=dev), torch.tensor(y, device=dev)

    def grad(w, lo, hi):
        xb = Xd[lo:hi]
        return ((xb @ w.t()).squeeze(1) - yd[lo:hi]) @ xb / SVRG_BATCH

    w_snap = torch.tensor(w0, device=dev)
    g_full = sum(grad(w_snap, i, i + SVRG_BATCH)
                 for i in range(0, SVRG_N, SVRG_BATCH)) / (SVRG_N // SVRG_BATCH)
    w, want = w_snap.clone(), []
    for i in range(2):
        lo = i * SVRG_BATCH
        w = w - SVRG_LR * (grad(w, lo, lo + SVRG_BATCH)
                           - grad(w_snap, lo, lo + SVRG_BATCH) + g_full)
        want.append(w.clone())
    err = max(float((g - h).abs().max()) for g, h in zip(got, want))
    plain = w_snap - SVRG_LR * grad(w_snap, 0, SVRG_BATCH)
    # fit, fed by the DataLoaderIter, from the same start
    fmod, fit_it = module()
    mse0 = fmod.score(fit_it, "mse")[0][1]
    fmod.fit(fit_it, num_epoch=3, optimizer="sgd", eval_metric="mse",
             optimizer_params={"learning_rate": SVRG_LR})
    mse1 = fmod.score(fit_it, "mse")[0][1]
    print("  (c) SVRGModule on %s fed by DataLoaderIter (N %d, D %d, batch "
          "%d, SGD lr %g, fused step %s): two corrected steps against w - "
          "lr (g - g_snap + g_full) by hand on the card, max |diff| %.3g "
          "(the uncorrected first step differs by %.3g); eager steps "
          "counted in fused_step_fallbacks %d; fit 3 epochs: mse %.5f -> "
          "%.5f (%s)"
          % (ctx, SVRG_N, SVRG_D, SVRG_BATCH, SVRG_LR, fused_step_enabled(),
             err, float((got[0] - plain).abs().max()), falls, mse0, mse1,
             card))
    for g, h in zip(got, want):
        if not torch.allclose(g, h, **SVRG_TOL):
            fail("(c) the SVRG step %s differs from the hand-computed %s"
                 % (g.tolist(), h.tolist()))
    if falls != 2 or not mse1 < 0.5 * mse0:
        fail("(c) fallbacks %d (want 2), mse %.5f -> %.5f"
             % (falls, mse0, mse1))


def helpers_on_card(mx, card, ctx, clstm):
    """(d): check_consistency of (a)'s first cell over [cpu(), gpu(0)];
    runtime.Features; storage.memory_stats across a 256 MiB allocation;
    (a)'s block in predict mode inside engine.naive_engine() (no
    capture) and outside it (one); libinfo's built kernels."""
    from mxnet_tpu_torch import libinfo, runtime, storage, test_utils
    from mxnet_tpu_torch.parallel import _build
    chans, size = CLSTM_PATCH ** 2, CLSTM_FRAME // CLSTM_PATCH
    hid = CLSTM_HIDDEN[0]
    cell = mx.gluon.contrib.rnn.Conv2DLSTMCell(
        (chans, size, size), hid, CLSTM_KERNEL, CLSTM_KERNEL,
        i2h_pad=CLSTM_KERNEL // 2, prefix="c1_")
    out, (h, c) = cell(mx.sym.var("data"), [mx.sym.var("h"),
                                            mx.sym.var("c")])
    sym = mx.sym.Group([out, c])
    rs = np.random.RandomState(5)
    k2 = CLSTM_KERNEL * CLSTM_KERNEL
    params = {"data": rs.randn(CONSIST_BATCH, chans, size, size),
              "h": rs.randn(CONSIST_BATCH, hid, size, size),
              "c": rs.randn(CONSIST_BATCH, hid, size, size),
              "c1_i2h_weight": rs.randn(4 * hid, chans, CLSTM_KERNEL,
                                        CLSTM_KERNEL) / np.sqrt(chans * k2),
              "c1_h2h_weight": rs.randn(4 * hid, hid, CLSTM_KERNEL,
                                        CLSTM_KERNEL) / np.sqrt(hid * k2),
              "c1_i2h_bias": rs.randn(4 * hid) * 0.1,
              "c1_h2h_bias": rs.randn(4 * hid) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    t0 = time.perf_counter()
    outs = test_utils.check_consistency(sym, ctx_list=[mx.cpu(), ctx],
                                        arg_params=params)
    consist_s = time.perf_counter() - t0
    feats = runtime.Features()
    on = {k: feats.is_enabled(k) for k in ("CUDA", "CUDNN", "NCCL", "TPU",
                                           "XLA", "PALLAS")}
    before = storage.memory_stats(0)["bytes_in_use"]
    probe = torch.empty(STORAGE_PROBE_BYTES, dtype=torch.uint8,
                        device=ctx.torch_device())
    grown = storage.memory_stats(0)["bytes_in_use"] - before
    del probe
    stats = storage.memory_stats(0)
    net = clstm["net"]
    args = [clstm["x"], clstm["blank"]] + list(clstm["states"])
    st0 = net._cached_op.stats()
    with mx.engine.naive_engine():
        naive = net(*args)._data.clone()
    st1 = net._cached_op.stats()
    graph = net(*args)._data.clone()
    st2 = net._cached_op.stats()
    naive_err = float((naive - graph).abs().max())
    built = [_build._lib_path(name)[1] for name in _build.SOURCES]
    libs = libinfo.find_lib_path()
    print("  (d) check_consistency of (a)'s first cell (%s, batch %d) over "
          "[cpu(), %s], forward and every argument gradient: passed in %.1f "
          "s (outputs %s); Features %s; bytes_in_use +%d over a %d-byte "
          "allocation, stats %s; (a)'s block in predict mode inside "
          "naive_engine(): graphs %s -> %s, then outside %s (max |diff| "
          "%.3g); find_lib_path: %d libraries, the %d kernels' among them: "
          "%s (%s)"
          % (type(cell).__name__, CONSIST_BATCH, ctx, consist_s,
             [o.shape for o in outs], on, grown, STORAGE_PROBE_BYTES,
             stats, st0, st1, st2, naive_err, len(libs), len(built),
             all(b in libs for b in built), card))
    if not (on["CUDA"] and on["CUDNN"]) or on["TPU"] or on["XLA"] \
            or on["PALLAS"]:
        fail("(d) runtime.Features: %s" % on)
    if grown < STORAGE_PROBE_BYTES or set(stats) != {
            "bytes_in_use", "peak_bytes_in_use", "bytes_limit",
            "num_allocs"}:
        fail("(d) storage: +%d bytes over a %d-byte allocation, keys %s"
             % (grown, STORAGE_PROBE_BYTES, sorted(stats)))
    if st1["captures"] != st0["captures"] or st1["replays"] != \
            st0["replays"] or st2["captures"] != st0["captures"] + 1 \
            or naive_err > 1e-5:
        fail("(d) naive_engine: graphs %s -> %s -> %s, |diff| %g"
             % (st0, st1, st2, naive_err))
    if not all(b in libs for b in built):
        fail("(d) find_lib_path %s lacks the built kernels %s"
             % (libs, built))


def phase_breadth(card, tfa):
    """Phase 31 (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import detection as det
    t_phase = time.perf_counter()
    ctx = mx.gpu(0)
    tfa.reset_launches()
    rtc.reset_launches()
    det.reset_launches()
    clstm = convlstm_train(mx, card, ctx)
    lwlm = large_word_lm(mx, card, ctx)
    svrg_on_card(mx, card, ctx)
    helpers_on_card(mx, card, ctx, clstm)
    launched = dict(tfa.launches, rtc=rtc.launches["rtc"], **det.launches)
    print("  launches of the kernel table's rows 1-7 over the phase: %s; "
          "phase 31 %.1f s" % (launched, time.perf_counter() - t_phase))
    if any(launched.values()):
        fail("breadth: kernels launched on a path that has none: %s"
             % launched)
    return dict(clstm_ms=clstm["ms"], lwlm_ms=lwlm["ms"])


# ---------------------------------------------------------------------------
# Phase 32: contexts on distinct devices in one process
# ---------------------------------------------------------------------------

DM_BATCH = 32                       # 16 images a shard
DM_STEPS = 4
# the compared steps start from Xavier weights trained DM_WARM steps on
# gpu(0): with the moving means still at 0, BatchNorm's one-pass variance
# (shifted by the moving mean, the JAX package's numerics) cancels on
# channels whose mean dwarfs their spread, and two summation orders of
# one device part by ~1e-3 in the loss within 4 steps
DM_WARM = 10
DM_SGD = dict(learning_rate=0.05, momentum=0.9)
DM_LOSS_TOL = dict(rtol=5e-4, atol=5e-5)
DM_W_TOL = dict(rtol=5e-3, atol=1e-4)
DM_ATT = dict(B=4, T=256, H=4, D=64)
DM_ATT_SHAPE = "B2 T256 H4 D64 causal (the CUDA shard of B4)"
DM_ATT_TOL = dict(rtol=1e-5, atol=1e-5)
DM_ATT_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def dm_contexts(mx):
    return [mx.gpu(0), mx.cpu(0)]


def dm_resnet(mx, ctx_list, init=None):
    """resnet18_v1(classes=10) initialized over ``ctx_list`` (Xavier),
    its parameters set to ``init`` (collect_params order) when given,
    hybridized; (net, parameter list)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=ctx_list)
    net(mx.nd.zeros((1, 3, 32, 32), ctx=ctx_list[0]))
    params = list(net.collect_params().values())
    if init is not None:
        for p, v in zip(params, init):
            p.set_data(mx.nd.array(v, ctx=ctx_list[0]))
    net.hybridize()
    return net, params


def dm_gluon(mx, ctx_list, init, x, y, head=None):
    """DM_STEPS Trainer steps of the hybridized ResNet-18 over
    ``ctx_list``, each batch through split_and_load; ``head(step)``: a
    head gradient (numpy) for that step, or None. Returns the losses,
    the host weights after every step, the ms of each step and the
    trainer."""
    from mxnet_tpu_torch import autograd, gluon
    net, params = dm_resnet(mx, ctx_list, init)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(DM_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, weights, ms = [], [], []
    for s in range(DM_STEPS):
        xs = gluon.utils.split_and_load(x[s], ctx_list)
        ys = gluon.utils.split_and_load(y[s], ctx_list)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        hg = head(s) if head is not None else None
        for loss in ls:
            loss.backward(None if hg is None
                          else mx.nd.array(hg, ctx=ctx_list[0]))
        trainer.step(DM_BATCH)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.mean([l.asnumpy().mean() for l in ls])))
        weights.append([p.data().asnumpy().copy() for p in params
                        if p.grad_req != "null"])
    return losses, weights, ms, trainer


def dm_warm(mx, x, y):
    """Xavier weights (seed 32) trained DM_WARM Trainer steps on gpu(0):
    every parameter and moving statistic, collect_params order."""
    from mxnet_tpu_torch import autograd, gluon
    mx.random.seed(32)
    net, params = dm_resnet(mx, [mx.gpu(0)])
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(DM_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for s in range(DM_WARM):
        a, b = mx.nd.array(x[s], ctx=mx.gpu(0)), mx.nd.array(y[s],
                                                               ctx=mx.gpu(0))
        with autograd.record():
            loss = loss_fn(net(a), b)
        loss.backward()
        trainer.step(DM_BATCH)
    return [p.data().asnumpy() for p in params]


def dm_shard_ms(mx, init, x, y, ctx):
    """One shard's share: ms of the forward and backward of its
    DM_BATCH // 2 images alone on its device (median of 3, after one
    warm-up)."""
    from mxnet_tpu_torch import autograd, gluon
    net, _ = dm_resnet(mx, [ctx], init)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mx.nd.array(x[0][:DM_BATCH // 2], ctx=ctx)
    ys = mx.nd.array(y[0][:DM_BATCH // 2], ctx=ctx)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def dm_close(what, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    if not np.allclose(got, want, **tol):
        fail("%s: max |diff| %.3g (tolerance %s)"
             % (what, float(np.max(np.abs(got - want))), tol))


def dm_weights_close(what, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        dm_close("%s, parameter %d" % (what, i), a, b, DM_W_TOL)


def dm_module(mx, init, x, y):
    """(b): Module.fit over the mesh against the one-context twin, both
    from ``init`` (collect_params order)."""
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.gluon.model_zoo import vision
    block = vision.resnet18_v1(classes=10)
    sym = mx.sym.SoftmaxOutput(block(mx.sym.var("data")), name="softmax")
    init_args = ({}, {})
    for p, v in zip(block.collect_params().values(), init):
        init_args[p.grad_req == "null"][p.name] = mx.nd.array(v)
    data = np.concatenate(x[:DM_STEPS])
    label = np.concatenate(y[:DM_STEPS])
    runs = {}
    for name, ctx in (("mesh", dm_contexts(mx)), ("twin", mx.gpu(0))):
        it = mx.io.NDArrayIter(data, label, batch_size=DM_BATCH,
                               label_name="softmax_label")
        mod = mx.mod.Module(sym, context=ctx)
        ce = []
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(DM_SGD),
                arg_params=init_args[0], aux_params=init_args[1],
                eval_metric=metric.create("ce"),
                batch_end_callback=lambda p, ce=ce: ce.append(
                    p.eval_metric.get()[1]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        arg, _ = mod.get_params()
        runs[name] = (mod, ce, {k: v.asnumpy() for k, v in arg.items()},
                      secs)
    mod, ce, arg, secs = runs["mesh"]
    twin, ce1, arg1, secs1 = runs["twin"]
    dm_close("(b) per-batch cross-entropy, mesh vs twin", ce, ce1,
             DM_LOSS_TOL)
    for k in arg1:
        dm_close("(b) %s, mesh vs twin" % k, arg[k], arg1[k], DM_W_TOL)
    if mod._exec.mesh is None:
        fail("(b) the Module did not bind over the mesh")
    batch = mx.io.DataBatch(data=[mx.nd.array(x[0])],
                            label=[mx.nd.array(y[0])])
    mod.forward(batch, is_train=False)
    out = mod.get_outputs()[0]
    twin.forward(batch, is_train=False)
    if not isinstance(out, mx.nd.MeshNDArray) \
            or out.shape != (DM_BATCH, 10) \
            or not np.isfinite(out.asnumpy()).all():
        fail("(b) get_outputs()[0] is %s of shape %s, not one global "
             "(32, 10) array" % (type(out).__name__, out.shape))
    dm_close("(b) predict outputs, mesh vs twin", out.asnumpy(),
             twin.get_outputs()[0].asnumpy(), DM_W_TOL)
    odd = mx.mod.Module(sym, context=dm_contexts(mx))
    try:
        odd.bind(data_shapes=[("data", (DM_BATCH + 1, 3, 32, 32))],
                 label_shapes=[("softmax_label", (DM_BATCH + 1,))])
    except mx.base.MXNetError as e:
        odd_msg = str(e)
    else:
        fail("(b) a bind at batch %d over two devices did not raise"
             % (DM_BATCH + 1))
    print("  (b) Module.fit over the mesh, %d batches: %.2f s (twin on "
          "gpu(0): %.2f s), cross-entropy %s vs twin %s; outputs one "
          "global %s; batch 33 raised: %s"
          % (DM_STEPS, secs, secs1, ["%.5f" % v for v in ce],
             ["%.5f" % v for v in ce1], out.shape, odd_msg[:60]))
    return dict(fit_s=secs, twin_fit_s=secs1)


def dm_attention(mx, tfa):
    """(d): MeshMultiHeadAttention over the mesh, forward and backward,
    against the one-device run; the kernels' launch counts from the
    mesh run against a gpu(0) run over the CUDA shard's half."""
    from mxnet_tpu_torch import autograd
    B, T, H, D = (DM_ATT[k] for k in "BTHD")
    x = np.random.RandomState(32).randn(B, T, H * D).astype(np.float32)
    weights, runs = None, {}
    for name, ctx_list, rows in (("twin", [mx.gpu(0)], B),
                                 ("shard", [mx.gpu(0)], B // 2),
                                 ("mesh", dm_contexts(mx), B)):
        net = mx.gluon.contrib.nn.MeshMultiHeadAttention(H * D, H,
                                                         causal=True)
        net.initialize(mx.init.Xavier(), ctx=ctx_list)
        net(mx.nd.array(x[:1], ctx=ctx_list[0]))
        params = net._collect_params_with_prefix()
        if weights is None:
            weights = {k: p.data().asnumpy() for k, p in params.items()}
        for k, p in params.items():
            p.set_data(mx.nd.array(weights[k], ctx=ctx_list[0]))
        xs = mx.gluon.utils.split_and_load(x[:rows], ctx_list)[0]
        torch.cuda.synchronize()
        tfa.reset_launches()
        t0 = time.perf_counter()
        with autograd.record():
            y = net(xs)
        y.backward()
        torch.cuda.synchronize()
        runs[name] = (y.asnumpy(), {k: p.grad().asnumpy()
                                    for k, p in params.items()},
                      dict(tfa.launches), (time.perf_counter() - t0) * 1e3)
    out, grads, launches, ms = runs["mesh"]
    dm_close("(d) attention forward, mesh vs one device", out,
             runs["twin"][0], DM_ATT_TOL)
    for k in grads:
        dm_close("(d) %s gradient, mesh vs one device" % k, grads[k],
                 runs["twin"][1][k], DM_ATT_GRAD_TOL)
    want = runs["shard"][2]
    if launches != want or not all(launches[k] for k in TRAIN_KERNELS):
        fail("(d) kernel launches over the mesh %s, the CUDA shard's "
             "alone %s" % (launches, want))
    print("  (d) MeshMultiHeadAttention B%d T%d H%d D%d causal over the "
          "mesh: fwd + bwd %.1f ms (one device %.1f ms); launches %s, the "
          "CUDA shard's B%d alone: %s; the CPU shard ran the plain versions"
          % (B, T, H, D, ms, runs["twin"][3], launches, B // 2, want))
    return launches


def phase_device_mesh(card, tfa):
    """Phase 32 (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, ops
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctxs = dm_contexts(mx)
    xs, ys = kv_cifar((DM_WARM + DM_STEPS) * DM_BATCH, seed=32)
    x = xs.reshape(-1, DM_BATCH, 3, 32, 32)
    y = ys.reshape(-1, DM_BATCH)
    init = dm_warm(mx, x, y)
    x, y = x[DM_WARM:], y[DM_WARM:]
    # (a)
    ops.reset_mesh_stats()
    mesh_l, mesh_w, mesh_ms, _ = dm_gluon(mx, ctxs, init, x, y)
    gathers = ops.mesh_stats()["gathers"]
    twin_l, twin_w, twin_ms, _ = dm_gluon(mx, [mx.gpu(0)], init, x, y)
    dm_close("(a) losses, mesh vs twin", mesh_l, twin_l, DM_LOSS_TOL)
    dm_weights_close("(a) final weights, mesh vs twin", mesh_w[-1],
                     twin_w[-1])
    if gathers:
        fail("(a) ops gathered on ResNet-18's path: %s" % gathers)
    cuda_share = dm_shard_ms(mx, init, x, y, mx.gpu(0))
    cpu_share = dm_shard_ms(mx, init, x, y, mx.cpu(0))
    print("  (a) ResNet-18 (config 5) batch %d over [gpu(0), cpu(0)] (%s): "
          "%.1f ms a step (steps 2-%d: %s), twin on gpu(0) %.1f ms; the "
          "shards' shares, each 16 images' fwd + bwd alone: cuda:0 %.1f "
          "ms, cpu %.1f ms; losses %s (twin %s); gathers %s"
          % (DM_BATCH, card, statistics.median(mesh_ms[1:]), DM_STEPS,
             ["%.1f" % v for v in mesh_ms[1:]],
             statistics.median(twin_ms[1:]), cuda_share, cpu_share,
             ["%.5f" % v for v in mesh_l], ["%.5f" % v for v in twin_l],
             gathers))
    # (b)
    module = dm_module(mx, init, x, y)
    # (c)
    with env_set("MXNET_GRAD_OVERLAP", "1"):
        sync_l, sync_w, sync_ms, sync_tr = dm_gluon(mx, ctxs, init, x, y)
        fused = sync_tr._fused_updater
        if fused is None or fused._sync_mesh is None:
            fail("(c) the Trainer's update did not take the in-program "
                 "sync over the mesh")
        devices = sorted({str(s.device) for f in fused._sync_state.ensure()
                          for s in f.shards})
        dm_close("(c) losses, sync vs (a)", sync_l, mesh_l, DM_LOSS_TOL)
        dm_weights_close("(c) final weights, sync vs (a)", sync_w[-1],
                         mesh_w[-1])

        def head(step):
            g = np.ones((DM_BATCH,), np.float32)
            if step == 1:
                g[-1] = np.inf          # a row of the CPU shard
            return g
        with guard_on():
            _, bad_w, _, _ = dm_gluon(mx, ctxs, init, x, y, head)
            skipped = fault.stats()["skipped_steps"]
        if skipped != 1:
            fail("(c) the guard counted %d skipped steps, not 1" % skipped)
        if any(not np.array_equal(a, b) for a, b in zip(bad_w[1],
                                                         bad_w[0])):
            fail("(c) a weight moved in the poisoned step")
        if all(np.array_equal(a, b) for a, b in zip(bad_w[2], bad_w[1])):
            fail("(c) the step after the poisoned one did not train")
    print("  (c) MXNET_GRAD_OVERLAP=1: %d buckets, ZeRO-1 momentum slices "
          "on %s, %.1f ms a step; losses %s; the poisoned step (an inf in "
          "the CPU shard's head gradient) skipped on both devices, "
          "skipped_steps %d"
          % (len(fused._sync_plan.buckets), devices,
             statistics.median(sync_ms[1:]), ["%.5f" % v for v in sync_l],
             skipped))
    # (d)
    launches = dm_attention(mx, tfa)
    print("  the kernels at the CUDA shard's shape (%s):" % DM_ATT_SHAPE)
    B, T, H, D = DM_ATT["B"] // 2, DM_ATT["T"], DM_ATT["H"], DM_ATT["D"]
    kern = dict(bwd_case(tfa, B, T, T, H, D, True, False, seed=32),
                flash_fwd=fwd_case(tfa, B, T, T, H, D, True, False,
                                   seed=32))
    secs = time.perf_counter() - t_phase
    print("  phase 32 %.1f s" % secs)
    return dict(launches=launches, kern=kern, seconds=secs,
                step_ms=statistics.median(mesh_ms[1:]),
                cuda_share_ms=cuda_share, cpu_share_ms=cpu_share, **module)


# ---------------------------------------------------------------------------
# phase 33: the persistent compile cache
# ---------------------------------------------------------------------------

CC_KERNELS = ("flash_decode", "nms_sweep")  # built cold, loaded warm
CC_DEC = (8, 576, 12, 64)                   # the server's decode window
CC_SEED = 33
CC_CALLS = 3                                # the warm path's block calls
CC_AXPY_N = 1 << 20
CC_NMS = (2, 2048)                          # boxes of the nms_sweep check
CC_NMS_THRESH = 0.5
CC_TIMEOUT = 300
CC_NVCC = """#!/bin/sh
echo "$*" >> "%s"
exec "%s" "$@"
"""


def cc_axpy(mx):
    """Phase 8's module through mx.rtc: its axpy once over CC_AXPY_N
    floats on gpu(0), against ``y + a*x``; returns (error, module)."""
    g = torch.Generator(device="cpu").manual_seed(CC_SEED)
    dev = torch.device("cuda", 0)
    x = mx.nd.NDArray(torch.randn(CC_AXPY_N, generator=g).to(dev))
    y = mx.nd.NDArray(torch.randn(CC_AXPY_N, generator=g).to(dev))
    want = torch.add(y._data, x._data, alpha=0.5)
    mod = mx.rtc.CudaModule(RTC_KERNELS)
    k = mod.get_kernel("axpy", "float alpha, const float *x, float *y")
    k.launch((0.5, x, y), mx.gpu(0), (CC_AXPY_N // 256, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    err, ok = close(y._data, want, RTC_TOL)
    if not ok:
        fail("the axpy disagrees with y + a*x (max abs error %g)" % err)
    return err, mod


def cc_nms(det):
    """One ``nms_keep`` launch on random corner boxes in score order,
    its keep mask against ``nms_keep_plain``'s; returns the kept count."""
    g = torch.Generator(device="cpu").manual_seed(CC_SEED)
    B, n = CC_NMS
    lo = torch.rand(B, n, 2, generator=g) * 0.9
    boxes = torch.cat([lo, lo + 0.02 + torch.rand(B, n, 2, generator=g)
                       * 0.1], dim=-1).cuda()
    keep = det.nms_keep(boxes, CC_NMS_THRESH)
    if not torch.equal(keep, det.nms_keep_plain(boxes, CC_NMS_THRESH)):
        fail("nms_sweep's keep mask differs from nms_keep_plain's")
    return int(keep.sum())


def cc_dump(outdir, role, res):
    path = os.path.join(outdir, role + ".json")
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)


def cc_cold_main(outdir):
    """Phase 33 (a), a child on an empty cache directory."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache
    from mxnet_tpu_torch.parallel import _build
    t0 = time.perf_counter()
    _build.build_all(list(CC_KERNELS))
    build_s = time.perf_counter() - t0
    err, mod = cc_axpy(mx)
    compile_cache.flush()
    cc_dump(outdir, "cc-cold", dict(
        build_s=build_s, rtc_s=mod.compile_seconds,
        from_cache=mod.from_cache, axpy_err=err,
        stats=compile_cache.stats()))
    return 0


def cc_warm_main(outdir):
    """Phase 33 (b), a child on the directory (a) filled."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compile_cache, compile_watch, rtc, telemetry
    from mxnet_tpu_torch.ops import detection as det
    from mxnet_tpu_torch.parallel import flash_attention as tfa
    compiles = []
    nvrtc = rtc._compile

    def counting(*args):
        compiles.append(args[3])
        return nvrtc(*args)
    rtc._compile = counting

    class Decode(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, q, k, v, lens):
            return F.contrib.decode_attention(q, k, v, lens)

    B, T, H, D = CC_DEC
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(CC_SEED)
    q = torch.randn(B, 1, H, D, generator=g).to(dev)
    k, v = (torch.randn(B, T, H, D, generator=g).to(dev) for _ in range(2))
    lens_np = np.random.RandomState(CC_SEED).randint(1, T + 1, size=B)
    lens_np[0], lens_np[-1] = 1, T
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    net = Decode()
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    args = [mx.nd.NDArray(t) for t in (q, k, v, lens)]
    compile_watch.enable()
    sink = os.path.join(outdir, "cc-warm.jsonl")
    telemetry.start(filename=sink)
    tfa.reset_launches()                  # the warm path starts here
    t0 = time.perf_counter()
    for _ in range(CC_CALLS):
        out = net(*args)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(tfa.launches)         # ... and ends here
    telemetry.stop()
    err, ok = close(out._data, tfa.flash_decode(q, k, v, lens, impl="plain"))
    if not ok:
        fail("the warm block's decode attention disagrees with the plain "
             "version (max abs error %g)" % err)
    with open(sink) as f:
        tags = [(r["program"], r.get("cache")) for r in map(json.loads, f)
                if r.get("type") == "compile"]
    sites = compile_watch.site_stats("op:")
    kept = cc_nms(det)
    axpy_err, mod = cc_axpy(mx)
    stats = compile_cache.stats()
    rec = decode_case(tfa, B, T, H, D, seed=CC_SEED, lens_np=lens_np)
    cc_dump(outdir, "cc-warm", dict(
        path_s=path_s, launches=launches, err=err, tags=tags, sites=sites,
        kept=kept, axpy_err=axpy_err, rtc_s=mod.compile_seconds,
        from_cache=mod.from_cache, nvrtc_compiles=len(compiles),
        stats=stats, rec=rec))
    return 0


def phase_compile_cache(card):
    """Phase 33 (see the module docstring); returns the warm start's
    kernel record, launches and error."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import compile_cache
    from mxnet_tpu_torch.ops import detection as det
    from mxnet_tpu_torch.parallel import _build
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="ccache_")
    cache = os.path.join(root, "cache")
    log = os.path.join(root, "nvcc.log")
    home = os.path.join(root, "cuda")
    os.makedirs(os.path.join(home, "bin"))
    wrapper = os.path.join(home, "bin", "nvcc")
    with open(wrapper, "w") as f:
        f.write(CC_NVCC % (log, _build._nvcc()))
    os.chmod(wrapper, 0o755)
    env = dict(os.environ, MXNET_COMPILE_CACHE_DIR=cache, CUDA_HOME=home)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")

    def nvcc_builds():
        if not os.path.exists(log):
            return 0
        with open(log) as f:
            return sum(" -o " in ln for ln in f)

    def child(role):
        before = nvcc_builds()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               role, root], cwd=here, env=env,
                              capture_output=True, text=True,
                              timeout=CC_TIMEOUT)
        secs = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print("    " + line)
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            fail("(%s) the child exited %d" % (role, proc.returncode))
        with open(os.path.join(root, role + ".json")) as f:
            return json.load(f), secs, nvcc_builds() - before

    def entries():
        return sorted(n for n in os.listdir(cache) if n.endswith(".mxc"))

    try:
        # (a) cold start
        cold, cold_s, cold_builds = child("cc-cold")
        st = cold["stats"]
        print("  (a) cold start: a child process on an empty cache, %.1f s: "
              "nvcc builds of %s %.1f s (%d nvcc builds), NVRTC compile and "
              "load of phase 8's module %.3f s (from the cache: %s), axpy max"
              " abs error %g; after flush(): misses %d, stores %d, %d entries"
              " (%d bytes) on disk (%s)"
              % (cold_s, " and ".join(CC_KERNELS), cold["build_s"],
                 cold_builds, cold["rtc_s"], cold["from_cache"],
                 cold["axpy_err"], st["misses"], st["stores"], st["entries"],
                 st["size_bytes"], card))
        if (st["misses"], st["stores"], st["hits"]) != (3, 3, 0) \
                or len(entries()) != 3 or cold_builds != 2 \
                or cold["from_cache"]:
            fail("(a) a cold start must miss, build and store 3 entries: %s,"
                 " %d nvcc builds" % (st, cold_builds))
        # (b) warm start
        warm, warm_s, warm_builds = child("cc-warm")
        st = warm["stats"]
        block = [t for t in warm["tags"] if t[0].startswith("op:")]
        hits = sum(s.get("cache_hits", 0) for s in warm["sites"].values())
        print("  (b) warm start: a child process on that cache, %.1f s: "
              "hits %d, misses %d, errors %d, %d bytes read in %.4f s; nvcc "
              "builds %d, NVRTC compiles %d (phase 8's module loaded in "
              "%.4f s, from the cache: %s); the hybridized decode block's "
              "%d calls %.3f s (its capture loads flash_decode), compile "
              "records %s, cache_hits by site %s, launches %s; block vs "
              "plain max abs error %g, nms_sweep kept %d (equal to the plain"
              " version), axpy max abs error %g"
              % (warm_s, st["hits"], st["misses"], st["errors"],
                 st["bytes_read"], st["hit_s"], warm_builds,
                 warm["nvrtc_compiles"], warm["rtc_s"], warm["from_cache"],
                 CC_CALLS, warm["path_s"], warm["tags"],
                 {n: s.get("cache_hits", 0)
                  for n, s in warm["sites"].items()},
                 warm["launches"], warm["err"], warm["kept"],
                 warm["axpy_err"]))
        if (st["hits"], st["misses"]) != (3, 0) or warm_builds \
                or warm["nvrtc_compiles"] or not warm["from_cache"]:
            fail("(b) a warm start built something: %s, %d nvcc builds, %d "
                 "NVRTC compiles" % (st, warm_builds,
                                     warm["nvrtc_compiles"]))
        if [t[1] for t in block] != ["hit"] or hits < 1:
            fail("(b) the block's capture is not one compile record tagged "
                 "'hit': %s, cache_hits %d" % (block, hits))
        if warm["launches"]["flash_decode"] < 1:
            fail("(b) the warm path launched no flash_decode")
        # (c) faults, in this process
        key = compile_cache.entry_key("nvcc:nms_sweep", tuple(_build._FLAGS),
                                      _build._digest("nms_sweep")[1])
        path = os.path.join(cache, key + ".mxc")
        if not os.path.exists(path):
            fail("(c) nms_sweep's entry is not at its key %s" % key)
        total = sum(os.path.getsize(os.path.join(cache, n))
                    for n in entries())
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
        before = nvcc_builds()
        with env_set("CUDA_HOME", home), env_set(
                "MXNET_COMPILE_CACHE_MB", repr((total - 1) / float(1 << 20))):
            try:
                compile_cache.enable(cache)
                _build._libs.pop("nms_sweep", None)
                t0 = time.perf_counter()
                kept = cc_nms(det)
                rebuild_s = time.perf_counter() - t0
                compile_cache.flush()
                st = compile_cache.stats()
            finally:
                compile_cache.disable()
        builds = nvcc_builds() - before
        print("  (c) nms_sweep's entry truncated to %d of %d bytes, cap %d "
              "bytes (one under the three entries): misses %d, errors %d, "
              "hits %d, nvcc builds %d (rebuilt and launched in %.1f s, kept "
              "%d, equal to the plain version), stores %d, evictions %d, %d "
              "entries (%d bytes) left"
              % (len(blob) // 2, len(blob), total - 1, st["misses"],
                 st["errors"], st["hits"], builds, rebuild_s, kept,
                 st["stores"], st["evictions"], st["entries"],
                 st["size_bytes"]))
        if (st["misses"], st["errors"], st["hits"], builds) != (1, 1, 0, 1) \
                or st["stores"] != 1 or not st["evictions"] > 0 \
                or st["size_bytes"] > st["max_bytes"]:
            fail("(c) the truncated entry is not one counted miss rebuilt, "
                 "or the cap did not evict: %s, %d nvcc builds"
                 % (st, builds))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("  cold start %.1f s, warm start %.1f s; phase 33 %.1f s"
          % (cold_s, warm_s, time.perf_counter() - t_phase))
    return dict(rec=warm["rec"], launches=warm["launches"],
                err=max(warm["err"], warm["rec"]["err"]),
                cold_s=cold_s, warm_s=warm_s)


def kernel_row(name, source, replaces, path, shape, launches, rec, err):
    """One entry of the ``{"kernels": [...]}`` line; the decode kernels'
    also carry their cold-L2 time of one call and the host's splits."""
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               path=path, shape=shape, launches=launches[name],
               max_abs_err=err, ms=rec["ms"], plain_ms=rec["plain_ms"],
               bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
               library_ms=rec["library_ms"], ok=True)
    row.update((key, rec[key]) for key in ("cold_ms", "splits", "parts_ms")
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
    resnet_readings = phase_resnet(card)
    module_readings = phase_module(card)
    phase_export_train(card, phase_zoo(card))
    phase_amp(card, tfa, module_readings, resnet_readings)
    phase_input(card, module_readings)
    pack = phase_bucketing(card, tfa)
    phase_gan(card)
    phase_ops(card)
    phase_kv(card)
    print("sparse (BASELINE config 4):")
    phase_sparse(card)
    print("mesh (the rank mesh: dp with ZeRO-1 and FSDP, sp):")
    mesh = phase_mesh(card, tfa)
    print("mesh axes (sp and tp in the trainer, the dryrun over pp, ep, tp, "
          "sp and dp):")
    axes = phase_mesh_axes(card, tfa, mesh)
    print("serve (deploy artifacts through torch.export, the "
          "InferenceServer on CUDA graphs, the compile watch):")
    serve = phase_serve(card, tfa, resnet_readings)
    print("fault tolerance (the heartbeat, the supervised restart, the 2-D "
          "checkpoint in phase 25):")
    ft = phase_fault_tolerance(card, mesh)
    print("deploy, the rest (the attention kernels as torch.library ops in "
          "artifacts, format-3 int8 artifacts):")
    rest = phase_deploy_rest(card, tfa, serve)
    print("control flow (foreach, while_loop and cond inside graphs, Custom "
          "ops, get_symbol and autograd.Function, Monitor and viz):")
    phase_control_flow(card, tfa)
    print("vision (the SSD300 and Faster R-CNN heads through nms_sweep, "
          "deformable R-FCN, mx.image, the dgl host ops):")
    vision = phase_vision(card, tfa)
    print("the rest of the breadth (gluon.contrib.rnn: Shi et al.'s ConvLSTM "
          "and the LSTM-2048-512 with variational dropout; SVRG fed by "
          "contrib.io; the helpers):")
    phase_breadth(card, tfa)
    print("contexts on distinct devices in one process (the in-process dp "
          "mesh over [gpu(0), cpu(0)]: Gluon, Module, the in-program sync, "
          "attention on a shard):")
    dmesh = phase_device_mesh(card, tfa)
    print("the persistent compile cache (nvcc libraries and NVRTC cubins "
          "kept across a restart: a cold child, a warm child, faults):")
    ccache = phase_compile_cache(card)
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
    ] + [rtc_row(name, rtc[name], rtc_launches) for name in rtc] + [
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "packing", PACK_SHAPE,
                   pack["launches"], pack["fwd"], pack["ferr"]),
    ] + [kernel_row(kname, BWD_SRC[kname], BWD_TPU[kname], "packing",
                    PACK_SHAPE, pack["launches"], pack["bwd"][kname],
                    pack["berr"][kname])
         for kname in ("flash_bwd_dkdv", "flash_bwd_dq")] + [
        kernel_row(kname, FWD_SRC if kname == "flash_fwd" else BWD_SRC[kname],
                   FWD_TPU if kname == "flash_fwd" else BWD_TPU[kname],
                   path, shape, mesh[key], mesh["kern"][kind][kname],
                   mesh["kern"][kind][kname]["err"])
        for path, shape, key, kind in (
            ("mesh dp (rank 0)", MESH_DP_SHAPE, "dp_launches", "dp"),
            ("mesh sp ulysses (rank 0)", MESH_SP_SHAPE, "sp_launches", "sp"))
        for kname in TRAIN_KERNELS] + [
        kernel_row(kname, FWD_SRC if kname == "flash_fwd" else BWD_SRC[kname],
                   FWD_TPU if kname == "flash_fwd" else BWD_TPU[kname],
                   "mesh dp x tp (rank 0)", MESH_DP_SHAPE, axes["tp_launches"],
                   mesh["kern"]["dp"][kname], mesh["kern"]["dp"][kname]["err"])
        for kname in TRAIN_KERNELS] + [
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "serving (InferenceServer)",
                   "B%d T%d H12 D64 causal" % (LM_SERVE_LADDER[-1],
                                               LM_SERVE_SEQ[-1]),
                   serve["launches"], serve["lm_fwd"],
                   serve["lm_fwd"]["err"])
    ] + [
        kernel_row(kname, FWD_SRC if kname == "flash_fwd" else BWD_SRC[kname],
                   FWD_TPU if kname == "flash_fwd" else BWD_TPU[kname],
                   "fault tolerance (b) (rank 0)", MESH_DP_SHAPE,
                   ft["launches"], mesh["kern"]["dp"][kname],
                   mesh["kern"]["dp"][kname]["err"])
        for kname in TRAIN_KERNELS] + [
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "LM artifact "
                   "(InferenceServer)", LM_ART_SHAPE, rest["lm"]["launches"],
                   train_fwd, train_fwd["err"]),
        kernel_row("flash_fwd", FWD_SRC, FWD_TPU, "CPU-exported artifact",
                   ATT_SHAPE, rest["att_launches"], rest["att_fwd"],
                   rest["att_fwd"]["err"]),
        kernel_row("flash_decode", DEC_SRC, DEC_TPU, "decode artifact",
                   "B8 T576 H12 D64", rest["dec_launches"], dec, dec["err"]),
    ] + [
        kernel_row("nms_sweep", NMS_SRC, NMS_TPU, path, shape,
                   {"nms_sweep": vision[key]["launches"]}, vision[key],
                   vision[key]["err"])
        for path, shape, key in (
            ("ssd detection", "B%d n%d corner IoU, class-gated"
             % (SSD_BATCH, SSD_ANCHORS), "ssd"),
            ("rpn proposal", "B1 n%d +1 IoU"
             % RCNN_RPN["rpn_pre_nms_top_n"], "rpn"))] + [
        kernel_row("nms_sweep", NMS_SRC, NMS_TPU,
                   "ssd detection, force_suppress",
                   "B%d n%d corner IoU, one chain a sample"
                   % (SSD_BATCH, SSD_ANCHORS),
                   {"nms_sweep": vision["ssd"]["force"]["launches"]},
                   vision["ssd"]["force"], vision["ssd"]["force"]["err"])] + [
        kernel_row(kname, FWD_SRC if kname == "flash_fwd" else BWD_SRC[kname],
                   FWD_TPU if kname == "flash_fwd" else BWD_TPU[kname],
                   "in-process mesh [gpu(0), cpu(0)]", DM_ATT_SHAPE,
                   dmesh["launches"], dmesh["kern"][kname],
                   dmesh["kern"][kname]["err"])
        for kname in TRAIN_KERNELS] + [
        kernel_row("flash_decode", DEC_SRC, DEC_TPU,
                   "compile cache, warm start", "B%d T%d H%d D%d" % CC_DEC,
                   ccache["launches"], ccache["rec"], ccache["err"])]
    print("total %.1f s" % (time.perf_counter() - t_start))
    print("card:", card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["kv-rank"]:
        sys.exit(kv_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["sparse-rank"]:
        sys.exit(sparse_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["mesh4-rank"]:
        sys.exit(mesh4_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["ft-rank"]:
        sys.exit(ft_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["export-cpu"]:
        sys.exit(export_cpu_main(sys.argv[2]))
    if sys.argv[1:2] == ["cc-cold"]:
        sys.exit(cc_cold_main(sys.argv[2]))
    if sys.argv[1:2] == ["cc-warm"]:
        sys.exit(cc_warm_main(sys.argv[2]))
    sys.exit(main())
