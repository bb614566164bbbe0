"""Stateful autoregressive serving: continuous prefill/decode batching
over a paged KV cache (counterpart of ``mxnet_tpu/serving/decode.py``).

:class:`DecodeServer` keeps the JAX server's design and interface:

- **Prefill/decode split** — a prompt runs ONE prefill pass at its
  smallest bucketing-ladder rung, writing its K/V into the paged pool
  and emitting the first token; every later token comes from the
  decode step: a fixed-width batch (``window`` rows) of
  query-length-1 rows, page-table gather → cached attention
  (``parallel.flash_attention.flash_decode``) → new-token K/V scatter.
- **Paged KV cache** (``serving.kvcache``) — fixed-size pages, per
  request page tables, page 0 the masked dump page, updated IN PLACE.
  Pages allocate on demand; under pool pressure the scheduler preempts
  the newest lowest-priority active request (counted, typed error).
- **Prefix sharing & multi-model pools** (``MXNET_KV_PREFIX_CACHE``,
  ``pool=``) — a completed prefill registers its page-aligned token run
  in the pool's content-hashed index; a later prompt that matches
  enters decode on the SHARED refcounted pages and feeds only the
  un-cached suffix through the decode step. The first write into a
  still-shared page copies it first (copy-on-write; an int8 page's
  scales copy with it); a planned ``kv_cow`` raise degrades to a
  private re-prefill, never a wrong token.
- **Continuous batching** — one scheduler loop interleaves at most one
  prefill with every decode step.
- **Streaming + cancellation**, **deadlines**, **priorities** (bounded
  queue sheds the lowest class first), **weight hot-swap**
  (:meth:`DecodeServer.swap_weights` with a parameter dict or from a
  checkpoint manifest; in-flight requests finish on the weights they
  started with).
- **Faults** — ``serve_admit`` per submit, ``serve_decode`` per decode
  step, ``kv_evict`` per page reclaim, ``kv_share``/``kv_cow`` on the
  prefix path.

**The fixed program set as CUDA graphs.** The JAX server compiles one
prefill program per ladder rung, one decode-step program and one
copy-on-write program, and checks through ``compile_watch`` that no
other program is ever compiled. On a CUDA device this server captures
the same set as CUDA graphs (:class:`_Programs`): the decode step
(``_decode_step``: gather → ``model.decode`` → scatter → argmax) and
each rung's prefill (``_prefill_step``) once per weight generation, the
page copy once. Every step after that is one graph replay over static
input buffers, staged from pinned host memory; the graphs of a
generation are dropped once no request of it remains. ``stats()
["graphs"]`` counts captures, replays and recaptures (the oracle:
``1 + len(ladder)`` captures a generation, plus one copy, and none
again in steady state). :meth:`DecodeServer.warmup` captures
generation 1's set; a later generation's is captured at its first use.
A capture that fails raises: nothing falls back to eager on the card.
On a CPU device the same step bodies run eagerly. Each capture reports
to the compile watch under the JAX package's sites (``decode[:name]:
step``, ``:prefill:sN``, ``:cow``); the eager CPU server has no program
and so no site.

**Device.** The server runs on ``device`` (default ``cuda:0``; with no
CUDA device, construction raises unless ``device="cpu"``). Its
scheduler thread enters that device, and the kernels launch on that
thread's current stream.

**Observability** (each hook one ``None`` check while disarmed, as in
the JAX server): a router's trace context is adopted at ``submit`` and
the request's ``queue``, ``prefill`` and ``decode`` spans land on its
track under the router's ``request_id``; each tick integrates the
active requests' KV page-seconds into the meter; a prefix hit credits
its cached tokens; each prefill and decode step bills its program's
analytic cost (:meth:`DecodeServer.program_costs`); cumulative
``decode``/``prefix_cache`` telemetry records and the ``/metrics``
gauges read :meth:`DecodeServer.stats`. Every hook runs on the host
between programs, after the step's tokens are copied back: none runs
inside a captured graph, and none waits for the device.

The model contract (see :class:`ToyDecoderLM`, the reference model):

- ``model.prefill(params, tokens) -> (logits, k, v)`` — ``tokens (B,
  L)`` long; ``logits (B, L, V)``; ``k``/``v`` ``(n_layers, B, L, H,
  D)``. Rows at/after the true prompt length may be garbage.
- ``model.decode(params, tokens, positions, k_cache, v_cache) ->
  (logits, k_new, v_new)`` — ``tokens (B,)``/``positions (B,)`` long;
  caches ``(n_layers, B, T, H, D)`` gathered from the pool, NOT yet
  containing the new token: the model inserts ``k_new``/``v_new`` at
  ``positions`` before attending. ``logits (B, V)``; ``k_new``/``v_new``
  ``(n_layers, B, H, D)``.
- ``model.n_layers`` / ``model.n_heads`` / ``model.head_dim`` size the
  pool; ``model.max_len`` and ``model.vocab``, when present, bound
  positions and prompt tokens (torch indexing raises where JAX clamps).

Sampling is greedy (argmax): deterministic by construction.
"""
from __future__ import annotations

import contextlib
import itertools
import queue as _queue_mod
import threading
import time
from collections import deque

import numpy as _np
import torch

from .. import compile_cache, envs, fault, livemetrics, metering, \
    profiler, telemetry, tracing
from ..base import MXNetError
from ..bucketing.ladder import BucketLadder
# one capture at a time in the process (CachedOp's graphs too):
# torch.cuda.graph synchronises the device and empties the allocator's
# cache before it captures, which another thread's capture in flight
# would not survive
from ..cached_op import _CAPTURE_LOCK, _cuda_capture
from ..context import resolve_device
from . import kvcache
from .kvcache import KVCachePool
from .server import (RequestTimeoutError, ServerClosedError,
                     ServerOverloadedError, validate_priority,
                     shed_lowest_locked)

__all__ = ["DecodeServer", "DecodeRequest", "ToyDecoderLM"]

_DONE = object()          # stream sentinel

_SITES = ("step", "prefill", "cow")


class _ParamsVersion:
    """One immutable weight generation: requests pin the version they
    prefilled with; decode batches group by it, so a hot swap never
    mixes generations inside one step."""

    __slots__ = ("version", "tree")

    def __init__(self, version, tree):
        self.version = version
        self.tree = tree


class DecodeRequest:
    """One streaming generation: a future over the full token list plus
    a per-token stream. :meth:`tokens` iterates tokens live,
    :meth:`result` blocks for the whole list."""

    __slots__ = ("prompt", "max_new", "priority", "deadline", "eos_id",
                 "request_id", "t_submit", "pages", "generated",
                 "params", "state", "_cancelled", "_stream", "_event",
                 "_error", "_last_emit", "_t_first", "trace_args",
                 "_t_trace", "pending", "pending_pos", "prefix_cached")

    def __init__(self, prompt, max_new, priority, deadline, eos_id,
                 request_id):
        self.prompt = prompt
        self.max_new = max_new
        self.priority = priority
        self.deadline = deadline
        self.eos_id = eos_id
        self.request_id = request_id
        self.t_submit = time.monotonic()
        self.pages = []
        self.generated = []
        self.params = None            # _ParamsVersion, set at prefill
        self.state = "queued"         # queued|active|done|failed|cancelled
        self._cancelled = False
        # bounded by construction: at most max_new tokens + sentinel
        self._stream = _queue_mod.Queue(maxsize=max_new + 2)
        self._event = threading.Event()
        self._error = None
        self._last_emit = None
        self._t_first = None
        self.trace_args = None    # span args while traced (carries an
                                  # adopted router request_id, if any)
        self._t_trace = None      # trace-clock submit stamp
        # prefix-cache suffix feed: tokens still to run through the
        # decode step (outputs discarded until the last, which IS the
        # first generated token), and the position the next one writes
        self.pending = None
        self.pending_pos = 0
        self.prefix_cached = 0    # prompt tokens served from the index

    def done(self):
        return self._event.is_set()

    def cancel(self):
        """Ask the server to drop this request: it is reaped before the
        next decode step and its pages are freed then. A cancelled
        request completes WITHOUT an error — the stream just ends,
        :meth:`result` returns the tokens so far, and ``state ==
        "cancelled"``. Safe from any thread; idempotent."""
        self._cancelled = True

    def result(self, timeout=None):
        """Block for the full generation; returns an int32 array of the
        generated tokens. Raises the request's error."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                "request %s did not complete within %ss"
                % (self.request_id, timeout))
        if self._error is not None:
            raise self._error
        return _np.asarray(self.generated, _np.int32)

    def tokens(self, timeout=None):
        """Iterate generated tokens as they stream in; ``timeout``
        bounds the wait per token. Raises the request's error after
        yielding every token that landed before it."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def _push(self, token):
        try:
            self._stream.put_nowait(int(token))
        except _queue_mod.Full:       # unreachable by construction
            pass

    def _complete(self, error=None, state=None):
        """Finalize (first caller wins): the state is set BEFORE the
        event fires, and the ``_DONE`` sentinel always lands — on a full
        stream the oldest unconsumed token is dropped to make room."""
        if self._event.is_set():
            return
        self._error = error
        self.state = state if state is not None \
            else ("failed" if error is not None else "done")
        while True:
            try:
                self._stream.put_nowait(_DONE)
                break
            except _queue_mod.Full:
                try:
                    self._stream.get_nowait()
                except _queue_mod.Empty:
                    pass
        self._event.set()


# ---------------------------------------------------------------------------
# the reference decode model
# ---------------------------------------------------------------------------

class ToyDecoderLM:
    """A minimal pre-LN transformer LM implementing the decode-model
    contract. Prefill attention is ``flash_attention(causal=True)``;
    decode attention is ``flash_decode``. Parameters are a FLAT
    ``{name: tensor}`` dict with the JAX model's names. ``impl="plain"``
    sends attention to the plain PyTorch versions on any device (the
    tests and ``chip_smoke.py`` use it to hold the kernels to them)."""

    def __init__(self, vocab=32, n_layers=2, n_heads=2, head_dim=8,
                 d_ff=None, max_len=256, impl=None):
        self.vocab = int(vocab)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.d_model = self.n_heads * self.head_dim
        self.d_ff = int(d_ff) if d_ff else 4 * self.d_model
        self.max_len = int(max_len)
        self.impl = impl
        self._scale = 1.0 / float(self.head_dim) ** 0.5

    def param_shapes(self):
        """``{name: shape}`` of the flat parameter dict."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        shapes = {"embed": (V, D), "pos": (self.max_len, D),
                  "out_g": (D,), "out_b": (D,), "wout": (D, V)}
        for i in range(self.n_layers):
            shapes.update({
                "l%d.att_g" % i: (D,), "l%d.att_b" % i: (D,),
                "l%d.wq" % i: (D, D), "l%d.wk" % i: (D, D),
                "l%d.wv" % i: (D, D), "l%d.wo" % i: (D, D),
                "l%d.ffn_g" % i: (D,), "l%d.ffn_b" % i: (D,),
                "l%d.w1" % i: (D, F), "l%d.w2" % i: (F, D),
            })
        return shapes

    def init_params(self, seed=0, device=None):
        """Random float32 parameters at the JAX model's shapes and
        scales (normal x 0.5 for ``embed``, 0.1 for ``pos`` and the
        layer matrices, 0.2 for ``wout``; LayerNorm gains 1, biases 0),
        drawn with numpy from ``seed``. The values differ from the JAX
        ``init_params(seed)``; carry those across with
        ``serving.convert.params_from_numpy``."""
        rng = _np.random.default_rng(seed)
        dev = resolve_device(device)
        scales = {"embed": 0.5, "pos": 0.1, "wout": 0.2}
        out = {}
        for name, shape in self.param_shapes().items():
            kind = name.rsplit(".", 1)[-1]
            if kind.endswith("_g"):
                arr = _np.ones(shape, _np.float32)
            elif kind.endswith("_b"):
                arr = _np.zeros(shape, _np.float32)
            else:
                arr = rng.standard_normal(shape, dtype=_np.float32) \
                    * _np.float32(scales.get(name, 0.1))
            out[name] = torch.from_numpy(arr).to(dev)
        return out

    @staticmethod
    def _ln(x, g, b):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b

    def prefill(self, params, tokens):
        from ..parallel.flash_attention import flash_attention
        B, L = tokens.shape
        H, Dh = self.n_heads, self.head_dim
        h = params["embed"][tokens] + params["pos"][:L][None]
        ks, vs = [], []
        for i in range(self.n_layers):
            x = self._ln(h, params["l%d.att_g" % i],
                         params["l%d.att_b" % i])
            q = (x @ params["l%d.wq" % i]).reshape(B, L, H, Dh)
            k = (x @ params["l%d.wk" % i]).reshape(B, L, H, Dh)
            v = (x @ params["l%d.wv" % i]).reshape(B, L, H, Dh)
            a = flash_attention(q, k, v, causal=True, scale=self._scale,
                                impl=self.impl)
            h = h + a.reshape(B, L, -1) @ params["l%d.wo" % i]
            x = self._ln(h, params["l%d.ffn_g" % i],
                         params["l%d.ffn_b" % i])
            h = h + torch.relu(x @ params["l%d.w1" % i]) \
                @ params["l%d.w2" % i]
            ks.append(k)
            vs.append(v)
        logits = self._ln(h, params["out_g"], params["out_b"]) \
            @ params["wout"]
        return logits, torch.stack(ks), torch.stack(vs)

    def decode(self, params, tokens, positions, k_cache, v_cache):
        from ..parallel.flash_attention import flash_decode
        B = tokens.shape[0]
        H, Dh = self.n_heads, self.head_dim
        rows = torch.arange(B, device=tokens.device)
        h = params["embed"][tokens] + params["pos"][positions]
        k_new, v_new = [], []
        for i in range(self.n_layers):
            x = self._ln(h, params["l%d.att_g" % i],
                         params["l%d.att_b" % i])
            q = (x @ params["l%d.wq" % i]).reshape(B, 1, H, Dh)
            k = (x @ params["l%d.wk" % i]).reshape(B, H, Dh)
            v = (x @ params["l%d.wv" % i]).reshape(B, H, Dh)
            # the new token's K/V joins a copy of the cache at its own
            # position BEFORE attending — cache index == position (a
            # bfloat16 cache rounds it, as the JAX model's does)
            kc = k_cache[i].clone()
            vc = v_cache[i].clone()
            kc[rows, positions] = k.to(kc.dtype)
            vc[rows, positions] = v.to(vc.dtype)
            a = flash_decode(q, kc.to(q.dtype), vc.to(q.dtype),
                             positions + 1, scale=self._scale,
                             impl=self.impl)
            h = h + a.reshape(B, -1) @ params["l%d.wo" % i]
            x = self._ln(h, params["l%d.ffn_g" % i],
                         params["l%d.ffn_b" % i])
            h = h + torch.relu(x @ params["l%d.w1" % i]) \
                @ params["l%d.w2" % i]
            k_new.append(k)
            v_new.append(v)
        logits = self._ln(h, params["out_g"], params["out_b"]) \
            @ params["wout"]
        return logits, torch.stack(k_new), torch.stack(v_new)

    def cost(self, rows, queries, keys):
        """Analytic ``(flops, bytes)`` of one forward over ``rows``
        sequences of ``queries`` query tokens, each attending over
        ``keys`` keys, at the program's static shapes (as XLA's
        ``cost_analysis`` counts a compiled program: padded rows and
        masked keys included). With d = d_model, f = d_ff, V = vocab,
        L = n_layers and n = rows x queries query tokens:

        - flops = n (L (8 d^2 + 4 d f) + 2 d V) + 4 L rows queries keys d:
          per layer the Q/K/V/O projections (4 d x d), the two FFN
          matrices (d x f, f x d), attention's Q K^T and P V (2 d
          multiply-adds per query-key pair each), and the LM head; a
          multiply-add counts 2;
        - bytes = 4 (L (4 d^2 + 2 d f + 4 d) + 2 d + d V) + 4 n (2 d + V):
          every weight matrix and LayerNorm vector read once, one
          ``embed`` and one ``pos`` row gathered per query token, and
          the float32 logits written.

        The decode server adds the K/V pages its program gathers and
        scatters (``DecodeServer.program_costs``)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        n = rows * queries
        flops = n * (L * (8 * d * d + 4 * d * f) + 2 * d * V) \
            + 4 * L * rows * queries * keys * d
        nbytes = 4 * (L * (4 * d * d + 2 * d * f + 4 * d) + 2 * d
                      + d * V) + 4 * n * (2 * d + V)
        return float(flops), float(nbytes)


# ---------------------------------------------------------------------------
# the fixed program set
# ---------------------------------------------------------------------------

class _Graph:
    """One captured program: its replay, its output, the kernel
    launches it holds, and the weights it reads (kept alive with it)."""

    __slots__ = ("replay", "output", "launches", "weights", "cost")

    def __init__(self, replay, output, launches, weights, cost=None):
        self.replay = replay
        self.output = output
        self.launches = launches
        self.weights = weights
        self.cost = cost


class _Programs:
    """The decode server's fixed program set, keyed by (site, rung,
    generation): site ``"step"`` (rung 0) and ``"prefill"`` (one a
    ladder rung) per weight generation, ``"cow"`` (rung 0, generation
    None) once. Each program's inputs live in static device buffers, one
    set per (site, rung) shared by the generations; an array input is
    staged through pinned host memory, an int by a device fill.
    ``capture(body, device, pool)`` makes a program (:func:`_cuda_capture`
    on the card; the tests drive the bookkeeping on the CPU with a
    stand-in)."""

    def __init__(self, device, capture=_cuda_capture):
        self.device = device
        self._capture = capture
        # the compile-watch site prefix: decode[:server name]
        self.site = "decode"
        self._cuda = device.type == "cuda"
        self._mempool = None
        self._graphs = {}
        self._inputs = {}        # (site, rung) -> [(device, host or None)]
        self._staged = None      # event after the last staging copies
        self._seen = set()
        # the counters are read by other threads (stats(), a /metrics
        # scrape, the flight recorder) while this server's thread
        # captures and replays: updates and copies hold the lock
        self._lock = threading.Lock()
        self.captures = dict.fromkeys(_SITES, 0)
        self.replays = dict.fromkeys(_SITES, 0)
        self.prefill_replays = {}    # rung -> replays
        self.recaptures = 0      # a key captured again
        self.after_warmup = 0    # captures once warmup() has run
        self.retired = 0         # generations dropped
        self.memory_bytes = dict.fromkeys(_SITES, 0)
        self.warmed = False

    def has(self, site, rung, generation):
        return (site, rung, generation) in self._graphs

    def generations(self):
        with self._lock:
            return self._generations_unlocked()

    def _generations_unlocked(self):
        return sorted({k[2] for k in self._graphs if k[2] is not None})

    def _buffers(self, site, rung, args):
        bufs = self._inputs.get((site, rung))
        if bufs is None:
            bufs = []
            for a in args:
                if isinstance(a, (int, _np.integer)):
                    bufs.append((torch.zeros((), dtype=torch.long,
                                             device=self.device), None))
                    continue
                host = torch.zeros(a.shape, dtype=torch.long,
                                   pin_memory=self._cuda)
                bufs.append((torch.zeros(a.shape, dtype=torch.long,
                                         device=self.device), host))
            self._inputs[(site, rung)] = bufs
        return bufs

    def _stage(self, bufs, args):
        if self._staged is not None:
            # the pinned buffers are rewritten only once the copies out
            # of them have landed
            self._staged.synchronize()
        for (dev, host), a in zip(bufs, args):
            if host is None:
                dev.fill_(int(a))
            else:
                host.numpy()[...] = a
                dev.copy_(host, non_blocking=True)
        if self._cuda:
            if self._staged is None:
                self._staged = torch.cuda.Event()
            self._staged.record()

    def capture(self, site, rung, generation, args, body, weights=None):
        """Capture ``body(*inputs)`` as program (site, rung, generation)
        over the static buffers shaped like ``args``, with every input
        zero (tables of the dump page, ``n_valid`` 0) for its eager
        call."""
        from .. import compile_watch
        key = (site, rung, generation)
        bufs = self._buffers(site, rung, args)
        self._stage(bufs, [0 if host is None else 0 * a
                           for (_d, host), a in zip(bufs, args)])
        inputs = [dev for dev, _host in bufs]
        call = lambda: body(*inputs)          # noqa: E731
        watched = compile_watch.enabled()
        if watched:
            call, cost = compile_watch.counted(call)
        with _CAPTURE_LOCK:
            if self._cuda:
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            replay, out, held = self._capture(call, self.device,
                                              self._pool())
            dur = time.perf_counter() - t0
            if self._cuda:
                grew = torch.cuda.memory_reserved(self.device) - before
                with self._lock:
                    self.memory_bytes[site] += grew
        with self._lock:
            self.recaptures += int(key in self._seen)
            self.after_warmup += int(self.warmed)
            self._seen.add(key)
            self.captures[site] += 1
            self._graphs[key] = graph = _Graph(replay, out, dict(held),
                                               weights)
        if watched:
            name = "%s:%s" % (self.site, site) if site != "prefill" \
                else "%s:prefill:s%d" % (self.site, rung)
            where = compile_watch.Site(name, statics=(self.site, site,
                                                      rung, generation))
            graph.cost = (where, compile_watch.note_compile(
                where, inputs, dur, cost))

    def _pool(self):
        # one graph memory pool for the server's graphs: they replay one
        # at a time on its thread, and each keeps its output alive
        if self._cuda and self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        return self._mempool

    def replay(self, site, rung, generation, args):
        """Stage ``args`` into the program's inputs, replay it, count
        the launches it holds; returns its output tensor."""
        from ..parallel import flash_attention as fa
        g = self._graphs[(site, rung, generation)]
        self._stage(self._inputs[(site, rung)], args)
        g.replay()
        fa.add_launches(g.launches)
        with self._lock:
            self.replays[site] += 1
            if site == "prefill":
                self.prefill_replays[rung] = \
                    self.prefill_replays.get(rung, 0) + 1
        if g.cost is not None:
            from .. import compile_watch
            compile_watch.accrue(*g.cost)
        return g.output

    def retire(self, live):
        """Drop the graphs (and with them the weights) of every
        generation not in ``live``."""
        with self._lock:
            dead = [k for k in self._graphs
                    if k[2] is not None and k[2] not in live]
            self.retired += len({k[2] for k in dead})
            for k in dead:
                del self._graphs[k]

    def stats(self):
        with self._lock:
            return {"captures": dict(self.captures),
                    "replays": dict(self.replays),
                    "prefill_replays": dict(self.prefill_replays),
                    "recaptures": self.recaptures,
                    "after_warmup": self.after_warmup,
                    "generations": self._generations_unlocked(),
                    "retired": self.retired,
                    "memory_bytes": dict(self.memory_bytes)}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def _place(params, device):
    return {k: torch.as_tensor(v, device=device) for k, v in params.items()}


class DecodeServer:
    """Continuous-batching autoregressive server (module docstring has
    the architecture). ``seq_ladder`` buckets PROMPT lengths (ints, a
    :class:`BucketLadder`, or None for a geometric [16..128] default);
    rungs are page-aligned, and when the model declares a ``max_len``
    the ladder top + ``max_new_tokens`` must fit it. ``window`` is the
    decode step's fixed batch width (``MXNET_DECODE_WINDOW``);
    ``max_new_tokens`` caps any request's generation budget and, with
    the top rung, sizes the page tables. ``start=False`` leaves the
    scheduler unstarted so tests drive :meth:`_tick` by hand."""

    def __init__(self, model, params, *, seq_ladder=None,
                 max_new_tokens=64, window=None, page_size=None,
                 pool_pages=None, pool=None, pool_quota=None,
                 pool_priority=0, prefix_cache=None, share_group=None,
                 max_queue=64, default_deadline_ms=None,
                 record_every=None, name=None, device=None,
                 start=True):
        for attr in ("prefill", "decode", "n_layers", "n_heads",
                     "head_dim"):
            if not hasattr(model, attr):
                raise MXNetError(
                    "DecodeServer: model lacks %r — the decode-model "
                    "contract is prefill/decode plus "
                    "n_layers/n_heads/head_dim (see "
                    "serving.decode.ToyDecoderLM)" % attr)
        self._model = model
        self.name = name
        if device is None and pool is not None:
            device = pool.device
        self._device = resolve_device(device)

        if seq_ladder is None:
            seq_ladder = BucketLadder.geometric(128, 16)
        elif not isinstance(seq_ladder, BucketLadder):
            seq_ladder = BucketLadder(seq_ladder)
        self._max_new = int(max_new_tokens)
        if self._max_new < 1:
            raise MXNetError("DecodeServer: max_new_tokens must be "
                             ">= 1, got %d" % max_new_tokens)
        if pool is not None:
            if pool_pages is not None:
                raise MXNetError(
                    "DecodeServer: pool_pages= conflicts with an "
                    "external pool= — size the shared pool once, "
                    "where it is built")
            if page_size is not None \
                    and int(page_size) != pool.page_size:
                raise MXNetError(
                    "DecodeServer: page_size=%d does not match the "
                    "shared pool's %d" % (int(page_size),
                                          pool.page_size))
            if (pool.n_layers, pool.n_heads, pool.head_dim) != \
                    (int(model.n_layers), int(model.n_heads),
                     int(model.head_dim)):
                raise MXNetError(
                    "DecodeServer: shared pool geometry (layers=%d, "
                    "heads=%d, head_dim=%d) does not match the "
                    "model's (%d, %d, %d) — co-tenant models must "
                    "agree on the page shape"
                    % (pool.n_layers, pool.n_heads, pool.head_dim,
                       model.n_layers, model.n_heads, model.head_dim))
            if pool.device != self._device:
                raise MXNetError(
                    "DecodeServer: shared pool lives on %s, the server "
                    "on %s" % (pool.device, self._device))
            self._pool = pool
        else:
            self._pool = KVCachePool(model.n_layers, model.n_heads,
                                     model.head_dim,
                                     page_size=page_size,
                                     n_pages=pool_pages,
                                     device=self._device)
        self._owner = self._pool.attach(
            name or "model", quota=pool_quota, priority=pool_priority,
            preempt=self._pool_preempt_cb)
        self._prefix_on = bool(prefix_cache) \
            if prefix_cache is not None \
            else envs.get_bool("MXNET_KV_PREFIX_CACHE")
        self._share_group = share_group
        self._preempt_asks = 0    # co-tenant give-back requests pending
        # prompt rungs fill whole pages; the table width covers the
        # longest prompt plus the full generation budget
        self._seq_ladder = seq_ladder.aligned(self._pool.page_size)
        self._max_context = self._seq_ladder.max_batch + self._max_new
        model_reach = getattr(model, "max_len", None)
        if model_reach is not None and self._max_context > model_reach:
            raise MXNetError(
                "DecodeServer: ladder top %d + max_new_tokens %d = "
                "%d positions exceeds the model's max_len %d — an "
                "out-of-range positional gather would fail on the "
                "device; shrink the ladder/budget or raise the "
                "model's reach"
                % (self._seq_ladder.max_batch, self._max_new,
                   self._max_context, model_reach))
        self._max_pages = self._pool.pages_for(self._max_context)
        if self._max_pages > self._pool.usable_pages:
            raise MXNetError(
                "DecodeServer: one max-size request needs %d pages "
                "but the pool only has %d usable — raise "
                "MXNET_KV_POOL_PAGES or shrink the ladder/"
                "max_new_tokens" % (self._max_pages,
                                    self._pool.usable_pages))
        self._window = max(1, int(window) if window is not None
                           else envs.get_int("MXNET_DECODE_WINDOW"))
        self._max_queue = max(1, int(max_queue))
        self._levels = max(1, envs.get_int("MXNET_SERVING_PRIORITIES"))
        self._default_deadline = (float(default_deadline_ms) / 1e3
                                  if default_deadline_ms is not None
                                  else None)
        self._record_every = int(record_every) if record_every \
            else envs.get_int("MXNET_SERVING_RECORD_EVERY")

        self._cond = threading.Condition()
        self._queue = deque()
        self._active = []
        self._params = _ParamsVersion(1, _place(params, self._device))
        # the fixed program set as CUDA graphs; eager on the CPU
        self._programs = _Programs(self._device) \
            if self._device.type == "cuda" else None
        if self._programs is not None:
            self._programs.site = "decode" if not name \
                else "decode:%s" % name
        self._rid = itertools.count(1)
        self._stats = {"requests": 0, "completed": 0, "cancelled": 0,
                       "timeouts": 0, "shed": 0, "errors": 0,
                       "preempted": 0, "prefill_steps": 0,
                       "decode_steps": 0, "decode_faults": 0,
                       "tokens_out": 0, "queue_peak": 0, "swaps": 0,
                       "prefix_hits": 0, "prefix_misses": 0,
                       "prefix_hit_tokens": 0, "cow_splits": 0,
                       "cow_degraded": 0, "cross_preempts": 0}
        self._shed_by_priority = {}
        ring = max(1, envs.get_int("MXNET_SERVING_LATENCY_RING"))
        self._intervals = deque(maxlen=ring)    # inter-token ms
        self._ttft = deque(maxlen=ring)         # submit -> first token
        self._steps_since_record = 0
        self._costs = self.program_costs()
        self._t0 = time.perf_counter()
        self._stopping = False
        self._drain = True
        self._closed = False
        self._started = False
        self._warming = False
        self._thread = None
        livemetrics.register_decode_server(self)
        livemetrics.maybe_start()
        if start:
            self.start()

    # -- the steps (the graphs' bodies; they update the pool in place) -----
    def _to_dev(self, x):
        """A step input on the device: a tensor is taken as it is (a
        static buffer of the program set), an array or int is copied."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(_np.asarray(x)).to(self._device,
                                                   torch.long)

    @torch.no_grad()
    def _prefill_step(self, params, tokens, n_valid, page_table):
        """Prefill one prompt (``tokens (1, rung)``, ``n_valid`` real
        tokens), write its K/V through ``page_table`` and return the
        greedy first token (a 0-d device tensor). Each input may be a
        device tensor, ``n_valid`` a 0-d one: nothing here reads a value
        on the host."""
        tokens = self._to_dev(tokens)
        n_valid = self._to_dev(n_valid)
        logits, k_seq, v_seq = self._model.prefill(params, tokens)
        pt = self._to_dev(page_table)
        pool = self._pool
        if pool.quantized:
            kvcache.scatter_prefill_q8(pool.k, pool.k_scale, pt,
                                       k_seq[:, 0], n_valid)
            kvcache.scatter_prefill_q8(pool.v, pool.v_scale, pt,
                                       v_seq[:, 0], n_valid)
        else:
            kvcache.scatter_prefill(pool.k, pt, k_seq[:, 0], n_valid)
            kvcache.scatter_prefill(pool.v, pt, v_seq[:, 0], n_valid)
        # the row of the last real token, gathered on the device (n_valid
        # 0, warmup's, wraps to the last row as a negative index does)
        last = torch.remainder(n_valid - 1, tokens.shape[1]).reshape(1)
        return torch.argmax(logits[0].index_select(0, last)[0])

    @torch.no_grad()
    def _decode_step(self, params, tokens, positions, page_tables):
        """One decode step over the window: gather (int8 pools
        dequantize here) → model.decode → scatter. Returns the greedy
        tokens ``(window,)`` on the device."""
        toks = self._to_dev(tokens)
        pos = self._to_dev(positions)
        pts = self._to_dev(page_tables)
        pool = self._pool
        if pool.quantized:
            k_cache = kvcache.gather_pages_q8(pool.k, pool.k_scale, pts)
            v_cache = kvcache.gather_pages_q8(pool.v, pool.v_scale, pts)
        else:
            k_cache = kvcache.gather_pages(pool.k, pts)
            v_cache = kvcache.gather_pages(pool.v, pts)
        logits, k_new, v_new = self._model.decode(
            params, toks, pos, k_cache, v_cache)
        if pool.quantized:
            kvcache.scatter_token_q8(pool.k, pool.k_scale, pts, pos,
                                     k_new)
            kvcache.scatter_token_q8(pool.v, pool.v_scale, pts, pos,
                                     v_new)
        else:
            kvcache.scatter_token(pool.k, pts, pos, k_new)
            kvcache.scatter_token(pool.v, pts, pos, v_new)
        return torch.argmax(logits, dim=-1)

    # -- the program set: a graph replay on the card, the body on the CPU --
    def _prefill_args(self, rung):
        return (_np.zeros((1, rung), _np.int64), 0,
                _np.zeros((self._max_pages,), _np.int64))

    def _step_args(self):
        W, M = self._window, self._max_pages
        return (_np.zeros((W,), _np.int64), _np.zeros((W,), _np.int64),
                _np.zeros((W, M), _np.int64))

    def _capture_generation(self, ver):
        """Capture ``ver``'s decode step and every rung's prefill (those
        not captured yet); returns the number of programs the
        generation has. Runs under the pool's ``step_lock``: each
        capture's eager call writes the dump page."""
        P, tree, gen = self._programs, ver.tree, ver.version
        for rung in self._seq_ladder.buckets:
            if not P.has("prefill", rung, gen):
                P.capture("prefill", rung, gen, self._prefill_args(rung),
                          lambda *a: self._prefill_step(tree, *a), tree)
        if not P.has("step", 0, gen):
            P.capture("step", 0, gen, self._step_args(),
                      lambda *a: self._decode_step(tree, *a), tree)
        return 1 + len(self._seq_ladder.buckets)

    def program_costs(self):
        """``{"step": (flops, bytes), "prefill": {rung: (flops,
        bytes)}}`` of the fixed program set, from the programs' static
        shapes — the counterpart of the JAX server's per-program
        ``cost_analysis``, which the meter bills (a prefill's whole cost
        to its request, a step's in equal shares over its rows). The
        model's :meth:`ToyDecoderLM.cost` counts the forward; the K/V
        traffic is added here: the step gathers ``window x max_pages x
        page_size`` cached tokens and scatters ``window`` new ones, a
        prefill at rung R scatters R (an int8 pool's float32 page scales
        ride along). None when the model has no ``cost``."""
        cost = getattr(self._model, "cost", None)
        if cost is None:
            return None
        pool = self._pool
        W, T = self._window, self._max_pages * pool.page_size
        scale_tok = 2 * pool.n_layers * 4 if pool.quantized else 0
        flops, nbytes = cost(W, 1, T)
        step = (flops, nbytes + W * T * pool.token_bytes
                + W * self._max_pages * scale_tok
                + W * (pool.token_bytes + scale_tok))
        prefill = {}
        for rung in self._seq_ladder.buckets:
            flops, nbytes = cost(1, rung, rung)
            prefill[rung] = (flops, nbytes + rung * pool.token_bytes
                             + pool.pages_for(rung) * scale_tok)
        return {"step": step, "prefill": prefill}

    def _capture_cow(self):
        if not self._programs.has("cow", 0, None):
            self._programs.capture("cow", 0, None, (0, 0),
                                   self._pool.copy_page)

    def _run_prefill(self, ver, tokens, n_valid, page_table):
        """The greedy first token (an int) of one prefill."""
        if self._programs is None:
            return int(self._prefill_step(ver.tree, tokens, n_valid,
                                          page_table))
        self._capture_generation(ver)
        return int(self._programs.replay(
            "prefill", tokens.shape[1], ver.version,
            (tokens, n_valid, page_table)))

    def _run_step(self, ver, tokens, positions, page_tables):
        """The greedy tokens ``(window,)`` of one decode step, as numpy."""
        if self._programs is None:
            out = self._decode_step(ver.tree, tokens, positions,
                                    page_tables)
        else:
            self._capture_generation(ver)
            out = self._programs.replay(
                "step", 0, ver.version, (tokens, positions, page_tables))
        return out.cpu().numpy()

    def _run_cow(self, src, dst):
        if self._programs is None:
            self._pool.copy_page(src, dst)
            return
        self._capture_cow()
        self._programs.replay("cow", 0, None, (src, dst))

    def _retire_generations(self):
        """Drop the graphs of every generation no request holds."""
        if self._programs is None:
            return
        with self._cond:
            live = {r.params.version for r in self._active
                    if r.params is not None}
            live.add(self._params.version)
        self._programs.retire(live)

    def _namespace(self, ver):
        """The prefix-index namespace: share group (defaults to this
        server's unique pool attachment) + weight generation."""
        return (self._share_group or self._owner, ver.version)

    def _pool_preempt_cb(self):
        """A co-tenant's give-back ask. Runs on the REQUESTER's thread,
        so it only schedules: our own scheduler preempts one of its
        active requests on its next tick."""
        with self._cond:
            if self._closed or self._stopping or not self._active:
                return False
            self._preempt_asks += 1
            self._stats["cross_preempts"] += 1
            self._cond.notify_all()
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._started:
            return self
        if self._closed:
            raise ServerClosedError("DecodeServer already stopped")
        self._started = True
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, name="mxnet-decode-scheduler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the server. ``drain=True`` finishes every queued and
        active generation first; ``drain=False`` fails them with
        ServerClosedError and reclaims their pages. Either way every
        outstanding stream TERMINATES: the scheduler join is bounded by
        ``MXNET_DECODE_STOP_TIMEOUT_MS``, and a scheduler wedged past it
        degrades the stop to the non-draining path."""
        if self._closed:
            return
        with self._cond:
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
        if self._started:
            join_s = max(
                envs.get_int("MXNET_DECODE_STOP_TIMEOUT_MS"), 1) / 1e3
            self._thread.join(join_s)
            if self._thread.is_alive():
                # wedged scheduler: the typed-error path below retires
                # its work (_complete is first-wins)
                drain = False
                with self._cond:
                    self._drain = False
        elif drain:
            while self._has_work():
                self._tick()
        if not drain:
            with self._cond:
                doomed = list(self._queue) + list(self._active)
                self._queue.clear()
                del self._active[:]
            for r in doomed:
                self._finish(r, ServerClosedError(
                    "server stopped; request %s dropped"
                    % r.request_id))
        self._closed = True
        # the prefix index is NOT released: on a shared pool surviving
        # co-tenants keep hitting the cached prefixes
        self._emit_record()
        self._pool.detach(self._owner)
        livemetrics.deregister_decode_server(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def warmup(self):
        """Make the fixed program set ready before taking traffic: each
        prefill rung, the decode step, and the copy-on-write copy when
        the prefix cache is on. On a CUDA device each is captured as a
        CUDA graph for the serving weights (its eager first call builds
        the kernels, or loads them from the persistent compile cache,
        which is flushed before this returns); on the CPU each runs
        once. Warmup writes only the dump page (``n_valid=0``, all-zero
        tables). The scheduler is paused meanwhile. Returns the number
        of programs."""
        with self._cond:
            if self._closed:
                raise ServerClosedError("DecodeServer is stopped")
            self._warming = True
            ver = self._params
        try:
            with self._pool.step_lock:
                if self._programs is not None:
                    with self._on_device():
                        n = self._capture_generation(ver)
                        if self._prefix_on:
                            self._capture_cow()
                            n += 1
                    self._programs.warmed = True
                else:
                    n = 0
                    for rung in self._seq_ladder.buckets:
                        self._run_prefill(ver, *self._prefill_args(rung))
                        n += 1
                    self._run_step(ver, *self._step_args())
                    n += 1
                    if self._prefix_on:
                        self._run_cow(0, 0)   # dump page onto itself
                        n += 1
            compile_cache.flush()
            return n
        finally:
            with self._cond:
                self._warming = False
                self._cond.notify_all()

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens=None, priority=0,
               deadline_ms=None, eos_id=None, trace_ctx=None):
        """Admit one generation: ``prompt`` is a 1-D int token array
        (length <= the ladder top, tokens in ``0..vocab-1``). Returns a
        :class:`DecodeRequest` streaming up to ``max_new_tokens`` greedy
        tokens (stopping early at ``eos_id``). ``priority`` (0 lowest ..
        ``MXNET_SERVING_PRIORITIES``-1) drives overload shedding and
        KV-pool preemption. ``deadline_ms`` bounds the WHOLE generation.
        ``trace_ctx`` (a router's :func:`tracing.wire_context`) joins
        this server's spans to the router's under the session's
        ``request_id`` while the tracer is armed; disarmed, it is
        ignored."""
        if self._closed:
            raise ServerClosedError("DecodeServer is stopped")
        prompt = _np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise MXNetError(
                "DecodeServer.submit: prompt must be a non-empty 1-D "
                "token array, got shape %s" % (prompt.shape,))
        prompt = prompt.astype(_np.int32)
        if len(prompt) > self._seq_ladder.max_batch:
            raise MXNetError(
                "DecodeServer.submit: prompt length %d exceeds the "
                "ladder top %d" % (len(prompt),
                                   self._seq_ladder.max_batch))
        vocab = getattr(self._model, "vocab", None)
        if vocab is not None and (prompt.min() < 0
                                  or prompt.max() >= vocab):
            raise MXNetError(
                "DecodeServer.submit: prompt tokens must lie in "
                "0..%d, got %d..%d" % (vocab - 1, prompt.min(),
                                       prompt.max()))
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self._max_new
        if not 1 <= max_new <= self._max_new:
            raise MXNetError(
                "DecodeServer.submit: max_new_tokens must be in "
                "1..%d (the server budget), got %d"
                % (self._max_new, max_new))
        priority = validate_priority(priority, self._levels)
        fault.inject("serve_admit")
        deadline_s = (float(deadline_ms) / 1e3
                      if deadline_ms is not None
                      else self._default_deadline)
        rid = "d%06d" % next(self._rid)
        req = DecodeRequest(prompt, max_new, priority,
                            req_deadline(deadline_s), eos_id, rid)
        if tracing.enabled():
            joined = rid
            args = {"server_request_id": rid}
            if trace_ctx:
                adopted = tracing.adopt_context(
                    trace_ctx, name="ctx:submit", cat="wire",
                    tid=tracing.track("req %s"
                                      % trace_ctx.get("request_id", rid)))
                if adopted and adopted.get("request_id"):
                    joined = adopted["request_id"]
            args["request_id"] = joined
            req.trace_args = args
            req._t_trace = tracing.now()
        victim = None
        shed = stopping = False
        with self._cond:
            if self._stopping:
                stopping = True
            else:
                self._stats["requests"] += 1
                if len(self._queue) >= self._max_queue:
                    victim = shed_lowest_locked(self._queue, priority)
                    self._stats["shed"] += 1
                    if victim is None:
                        self._note_shed_locked(priority)
                        shed = True
                    else:
                        self._note_shed_locked(victim.priority)
                if not shed:
                    self._queue.append(req)
                    if len(self._queue) > self._stats["queue_peak"]:
                        self._stats["queue_peak"] = len(self._queue)
                    self._cond.notify_all()
        if stopping:
            raise ServerClosedError(
                "DecodeServer is stopping; request %s not admitted"
                % rid)
        if victim is not None:
            telemetry.note("decode_shed")
            profiler.increment_counter("decode_shed")
            victim._complete(ServerOverloadedError(
                "decode: request %s (priority %d) shed for a "
                "priority-%d arrival — queue full (max_queue=%d)"
                % (victim.request_id, victim.priority, priority,
                   self._max_queue)))
        if shed:
            telemetry.note("decode_shed")
            profiler.increment_counter("decode_shed")
            raise ServerOverloadedError(
                "decode: request %s (priority %d) shed — queue full "
                "(max_queue=%d) and no lower-priority request to "
                "displace; retry with backoff or raise max_queue"
                % (rid, priority, self._max_queue))
        return req

    def _note_shed_locked(self, priority):
        self._shed_by_priority[priority] = \
            self._shed_by_priority.get(priority, 0) + 1

    # -- weight hot-swap ---------------------------------------------------
    def swap_weights(self, params=None, *, prefix=None, epoch=None,
                     validate=True):
        """Zero-downtime weight swap: load the new parameter dict
        alongside the old one, flip atomically between steps. ``params``
        must match the serving dict's names, shapes and dtypes; or
        ``prefix``/``epoch`` name a checkpoint manifest, read through
        ``checkpoint.load_param_arrays`` (each file checked against its
        SHA-256 with ``validate``: a torn file raises, naming it). In-flight
        requests finish on the weights they started with; requests
        admitted after the flip use the new ones; the old dict frees
        when its last request drains. Returns the new version number."""
        if (params is None) == (prefix is None):
            raise MXNetError("swap_weights: pass exactly one of params= "
                             "or prefix=/epoch=")
        if params is None:
            from .. import checkpoint
            params = checkpoint.load_param_arrays(prefix, epoch,
                                                  validate=validate)
        cur = self._params.tree
        if not isinstance(params, dict) or set(params) != set(cur):
            raise MXNetError(
                "swap_weights: parameter tree structure differs from "
                "the serving one (%s vs %s) — a swap replaces values, "
                "never architecture"
                % (sorted(params) if isinstance(params, dict)
                   else type(params).__name__, sorted(cur)))
        new_tree = _place(params, self._device)
        for key, old in cur.items():
            new = new_tree[key]
            if tuple(old.shape) != tuple(new.shape) \
                    or old.dtype != new.dtype:
                raise MXNetError(
                    "swap_weights: %s shape/dtype mismatch (%s/%s vs "
                    "%s/%s) — a swap replaces values, never shapes"
                    % (key, tuple(new.shape), new.dtype,
                       tuple(old.shape), old.dtype))
        if self._device.type == "cuda":
            # the copies land BEFORE the flip: the next step must never
            # read a half-loaded dict (a stream's sync, not the device's:
            # another server's thread may be capturing a graph)
            torch.cuda.current_stream(self._device).synchronize()
        with self._cond:
            old = self._params
            new_version = old.version + 1
            self._params = _ParamsVersion(new_version, new_tree)
            self._stats["swaps"] += 1
        if self._prefix_on:
            # the old generation's cached prefixes can never be hit
            # again (the namespace carries the version)
            self._pool.prefix_release(self._namespace(old))
        telemetry.note("decode_weight_swaps")
        profiler.increment_counter("decode_weight_swaps")
        return new_version

    # -- scheduler ---------------------------------------------------------
    def _has_work(self):
        with self._cond:
            return bool(self._queue or self._active)

    def _on_device(self):
        return torch.cuda.device(self._device) \
            if self._device.type == "cuda" else contextlib.nullcontext()

    def _loop(self):
        with self._on_device():
            while True:
                with self._cond:
                    # idle: submit/stop/warmup-end all notify; the 1 s
                    # belt only backstops a lost wake
                    while not self._stopping and (
                            self._warming
                            or (not self._queue and not self._active)):
                        self._cond.wait(1.0)
                    if self._stopping and (not self._drain
                                           or (not self._queue
                                               and not self._active)):
                        break
                if not self._tick():
                    # head-of-line blocked or a reap-only pass
                    with self._cond:
                        self._cond.wait(0.002)

    def _tick(self):
        """One scheduler pass: reap cancellations/deadlines, admit at
        most ONE prefill, run ONE decode step over every active request.
        Returns True when any step ran."""
        with self._cond:
            if self._warming:
                return False
            asks = self._preempt_asks
            self._preempt_asks = 0
        # co-tenant give-back asks first: preempting one of our own
        # active requests frees pages a higher-priority model needs
        for _ in range(asks):
            victim = self._pick_victim(below=self._levels)
            if victim is None:
                break
            self._preempt(victim)
        self._reap()
        did = self._admit_one()
        did = self._decode_once() or did
        self._retire_generations()
        if metering.enabled():
            # integrate KV page holdings at the step boundary: each
            # active request's pages x dt accrue to its tenant AND to
            # the meter's pool total in one dual-entry pass
            with self._cond:
                entries = [(metering.inner_key(self, r.request_id),
                            len(r.pages)) for r in self._active]
            metering.request_pages(entries, time.monotonic())
        if did:
            self._steps_since_record += 1
            if self._steps_since_record >= self._record_every:
                self._steps_since_record = 0
                self._emit_record()
        return did

    def _reap(self):
        now = time.monotonic()
        doomed = []
        with self._cond:
            for r in list(self._queue):
                if r._cancelled or (r.deadline is not None
                                    and now > r.deadline):
                    self._queue.remove(r)
                    doomed.append(r)
            for r in list(self._active):
                if r._cancelled or (r.deadline is not None
                                    and now > r.deadline):
                    self._active.remove(r)
                    doomed.append(r)
        for r in doomed:
            if r._cancelled:
                self._finish(r, None, cancelled=True)
            else:
                telemetry.note("decode_timeout")
                profiler.increment_counter("decode_timeouts")
                self._finish(r, RequestTimeoutError(
                    "request %s deadline passed after %.1f ms "
                    "(%d/%d tokens generated)"
                    % (r.request_id, (now - r.t_submit) * 1e3,
                       len(r.generated), r.max_new)))

    def _finish(self, req, error, cancelled=False):
        """Retire one request: reclaim its pages (the counted
        ``kv_evict`` path), account it, complete the future."""
        if req.trace_args is not None and req._t_trace is not None:
            tracing.add(
                "decode", "decode", req._t_trace,
                tracing.now() - req._t_trace,
                tid=tracing.track("req %s" % req.trace_args["request_id"]),
                args=dict(req.trace_args,
                          tokens=len(req.generated),
                          outcome=("cancelled" if cancelled
                                   else "ok" if error is None
                                   else type(error).__name__)))
            req._t_trace = None
        if req.pages:
            if self._prefix_on and not cancelled and error is None \
                    and req.params is not None:
                # K/V is written for every position except the LAST
                # generated token's: register prompt + generated[:-1]
                run = [int(t) for t in req.prompt] \
                    + [int(t) for t in req.generated[:-1]]
                self._pool.prefix_insert(
                    self._namespace(req.params), run, req.pages)
            self._pool.free(req.pages)
            req.pages = []
        with self._cond:
            if cancelled:
                self._stats["cancelled"] += 1
            elif error is None:
                self._stats["completed"] += 1
            elif isinstance(error, RequestTimeoutError):
                self._stats["timeouts"] += 1
            elif isinstance(error, ServerOverloadedError):
                self._stats["preempted"] += 1
            else:
                self._stats["errors"] += 1
            self._cond.notify_all()
        req._complete(error, state="cancelled" if cancelled else None)

    def _pick_victim(self, below, exclude=None):
        """The preemption victim under KV-pool pressure: the NEWEST
        member of the LOWEST priority class strictly below ``below``
        among active requests. None when nothing qualifies."""
        with self._cond:
            best = None
            for r in self._active:
                if r is exclude or r.priority >= below:
                    continue
                if best is None or r.priority <= best.priority:
                    best = r        # later in list = newer
            if best is not None:
                self._active.remove(best)
        return best

    def _preempt(self, victim):
        telemetry.note("decode_preempted")
        profiler.increment_counter("decode_preempted")
        self._finish(victim, ServerOverloadedError(
            "decode: request %s (priority %d) preempted under KV-"
            "pool pressure after %d token(s) — raise "
            "MXNET_KV_POOL_PAGES or lower concurrency"
            % (victim.request_id, victim.priority,
               len(victim.generated))))

    def _admit_one(self):
        with self._cond:
            if self._stopping and not self._drain:
                return False
            if not self._queue or len(self._active) >= self._window:
                return False
            req = self._queue[0]
            ver = self._params    # pinned BEFORE the index lookup
        P = len(req.prompt)
        shared, cached = [], 0
        if self._prefix_on:
            shared, cached = self._pool.prefix_lookup(
                self._namespace(ver), req.prompt)
            with self._cond:
                if shared:
                    self._stats["prefix_hits"] += 1
                    self._stats["prefix_hit_tokens"] += cached
                else:
                    self._stats["prefix_misses"] += 1
            if shared:
                # credited at the SAME point the hit counters increment,
                # so the meter's credits reconcile with prefix_hit_tokens
                metering.request_prefix(
                    metering.inner_key(self, req.request_id), cached,
                    cached * self._pool.token_bytes)
        need = self._pool.pages_for(P + 1) - len(shared)
        pages = self._pool.alloc(need, owner=self._owner)
        while pages is None:
            victim = self._pick_victim(below=req.priority)
            if victim is None:
                # ask lower-pool-priority co-tenants for pages, then
                # wait; the retained prefix refs must come back
                self._pool.request_preempt(self._owner)
                if shared:
                    self._pool.free(shared)
                return False
            self._preempt(victim)
            pages = self._pool.alloc(need, owner=self._owner)
        with self._cond:
            if not self._queue or self._queue[0] is not req \
                    or req._cancelled:
                pages_back = shared + pages   # reaped meanwhile
            else:
                self._queue.popleft()
                req.pages = shared + pages
                req.state = "active"
                req.params = ver
                req.prefix_cached = cached
                self._active.append(req)
                pages_back = None
        if pages_back is not None:
            self._pool.free(pages_back)
            return False
        if shared:
            # prefix hit: no prefill at all. The un-cached suffix feeds
            # through the decode step token by token; a fully cached
            # page-aligned prompt re-runs only its last token (whose
            # write COWs the shared page)
            start = min(cached, P - 1)
            req.pending = deque(int(t) for t in req.prompt[start:])
            req.pending_pos = start
            return True
        t_pre = tracing.now() if req.trace_args is not None else None
        rung = self._seq_ladder.bucket_for(P)
        tokens = _np.zeros((1, rung), _np.int64)
        tokens[0, :P] = req.prompt
        pt = _np.zeros((self._max_pages,), _np.int64)
        pt[:len(req.pages)] = req.pages
        try:
            with self._pool.step_lock:
                tok = self._run_prefill(req.params, tokens, P, pt)
        except Exception as exc:       # noqa: BLE001 — model errors
            with self._cond:           # belong to the request
                if req in self._active:
                    self._active.remove(req)
            self._finish(req, exc)
            return True
        if self._costs is not None and metering.enabled():
            # a prefill is this one request: the whole program is its
            # share
            metering.request_flops(
                metering.inner_key(self, req.request_id),
                *self._costs["prefill"][rung])
        if self._prefix_on:
            # register the prompt's full pages so the NEXT same-prefix
            # prompt shares them
            self._pool.prefix_insert(self._namespace(ver), req.prompt,
                                     req.pages)
        now = time.perf_counter()
        req._t_first = now
        req._last_emit = now
        if t_pre is not None:
            # the first token is on the host (the copy back waited for
            # the device): the prefill span ends here
            rtid = tracing.track("req %s" % req.trace_args["request_id"])
            if req._t_trace is not None:
                tracing.add("queue", "decode", req._t_trace,
                            t_pre - req._t_trace, tid=rtid,
                            args=req.trace_args)
            tracing.add("prefill", "decode", t_pre,
                        tracing.now() - t_pre, tid=rtid,
                        args=dict(req.trace_args, rung=rung))
            req._t_trace = tracing.now()
        with self._cond:
            self._stats["prefill_steps"] += 1
            self._stats["tokens_out"] += 1
            self._ttft.append(
                (time.monotonic() - req.t_submit) * 1e3)
        req.generated.append(tok)
        req._push(tok)
        if len(req.generated) >= req.max_new or \
                (req.eos_id is not None and tok == req.eos_id):
            with self._cond:
                if req in self._active:
                    self._active.remove(req)
            self._finish(req, None)
        return True

    def _ensure_pages(self, rows):
        """Grow each row's page table to cover its next write position,
        preempting lower-priority active requests under pool pressure
        (the row itself fails if nothing below it can be evicted). A
        write landing in a still-SHARED page copies it first. Returns
        the surviving rows."""
        survivors = []
        for r in rows:
            if r.state != "active":
                continue               # preempted earlier in this pass
            failed = False
            while True:
                wp = r.pending_pos if r.pending \
                    else len(r.prompt) + len(r.generated) - 1
                needed = wp // self._pool.page_size + 1
                while len(r.pages) < needed:
                    pg = self._pool.alloc(1, owner=self._owner)
                    if pg is not None:
                        r.pages.extend(pg)
                        continue
                    victim = self._pick_victim(below=r.priority,
                                               exclude=r)
                    if victim is None:
                        if self._pool.request_preempt(self._owner):
                            # a co-tenant gives pages back: this row
                            # stays active and retries next tick
                            failed = True
                            break
                        with self._cond:
                            if r in self._active:
                                self._active.remove(r)
                        self._preempt(r)
                        failed = True
                        break
                    self._preempt(victim)
                    if victim in survivors:
                        survivors.remove(victim)
                if failed:
                    break
                if self._prefix_on and \
                        self._pool.ref(r.pages[wp // self._pool
                                               .page_size]) > 1:
                    got = self._cow_row(r, wp // self._pool.page_size)
                    if got == "died":
                        failed = True
                        break
                    if got == "degraded":
                        continue   # re-alloc from position 0
                break
            if not failed:
                survivors.append(r)
        return survivors

    def _cow_row(self, r, pidx):
        """Copy-on-write split of ``r``'s still-shared page ``pidx``:
        copy the page (an int8 page with its scales) to a fresh private
        page, drop the writer's reference from the shared one, swap the
        table entry. Visits the ``kv_cow`` fault site; a planned raise
        degrades the row to a PRIVATE re-prefill. Returns "ok" |
        "degraded" | "died"."""
        try:
            fault.inject("kv_cow")
        except fault.InjectedFault:
            with self._cond:
                self._stats["cow_degraded"] += 1
            self._degrade_private(r)
            return "degraded"
        pg = self._pool.alloc(1, owner=self._owner)
        while pg is None:
            victim = self._pick_victim(below=r.priority, exclude=r)
            if victim is None:
                with self._cond:
                    if r in self._active:
                        self._active.remove(r)
                self._preempt(r)
                return "died"
            self._preempt(victim)
            pg = self._pool.alloc(1, owner=self._owner)
        old, new = int(r.pages[pidx]), int(pg[0])
        with self._pool.step_lock:
            self._run_cow(old, new)
        self._pool.cow_release(old)
        r.pages[pidx] = new
        with self._cond:
            self._stats["cow_splits"] += 1
        return "ok"

    def _degrade_private(self, r):
        """Fall back to a fully private row: drop every page reference
        and queue everything the row has computed so far — prompt +
        generated — through the decode step from position 0."""
        if r.pages:
            self._pool.free(r.pages)
            r.pages = []
        r.pending = deque(
            [int(t) for t in r.prompt] + [int(t) for t in r.generated])
        r.pending_pos = 0
        r.prefix_cached = 0

    def _decode_once(self):
        with self._cond:
            rows = list(self._active)
        if not rows:
            return False
        try:
            fault.inject("serve_decode")
        except fault.InjectedFault:
            # a planned raise/hang at the decode site: counted; active
            # requests age meanwhile (the deadline tests' lever)
            with self._cond:
                self._stats["decode_faults"] += 1
            return True
        rows = self._ensure_pages(rows)
        if not rows:
            return True
        groups = {}
        for r in rows:
            groups.setdefault(r.params, []).append(r)
        for ver in sorted(groups, key=lambda v: v.version):
            self._decode_group(ver, groups[ver])
        return True

    def _decode_group(self, ver, rows):
        D, M = self._window, self._max_pages
        tokens = _np.zeros((D,), _np.int64)
        positions = _np.zeros((D,), _np.int64)
        pts = _np.zeros((D, M), _np.int64)
        for i, r in enumerate(rows):
            if r.pending:
                # prefix-cache suffix feed at its own position
                tokens[i] = r.pending[0]
                positions[i] = r.pending_pos
            else:
                tokens[i] = r.generated[-1]
                positions[i] = len(r.prompt) + len(r.generated) - 1
            pts[i, :len(r.pages)] = r.pages
        try:
            with self._pool.step_lock:
                toks = self._run_step(ver, tokens, positions, pts)
        except Exception as exc:       # noqa: BLE001 — model errors
            with self._cond:           # belong to the batch's requests
                for r in rows:
                    if r in self._active:
                        self._active.remove(r)
            for r in rows:
                self._finish(r, exc)
            return
        if self._costs is not None and metering.enabled():
            # the step ran ONE batch over these rows: each request is
            # billed an equal share of the program's cost
            flops, nbytes = self._costs["step"]
            share = 1.0 / len(rows)
            for r in rows:
                metering.request_flops(
                    metering.inner_key(self, r.request_id),
                    flops * share, nbytes * share)
        now = time.perf_counter()
        emitting = []
        for i, r in enumerate(rows):
            if r.pending:
                r.pending.popleft()
                r.pending_pos += 1
                if r.pending:
                    continue   # mid-suffix: the output is discarded
                r.pending = None
            emitting.append((i, r))
        finished = []
        with self._cond:
            self._stats["decode_steps"] += 1
            for i, r in emitting:
                self._stats["tokens_out"] += 1
                if r._last_emit is not None:
                    self._intervals.append((now - r._last_emit) * 1e3)
                elif r._t_first is None:
                    # a prefix-hit row's FIRST token lands here
                    r._t_first = now
                    self._ttft.append(
                        (time.monotonic() - r.t_submit) * 1e3)
                r._last_emit = now
        for i, r in emitting:
            tok = int(toks[i])
            r.generated.append(tok)
            r._push(tok)
            if len(r.generated) >= r.max_new or \
                    (r.eos_id is not None and tok == r.eos_id):
                finished.append(r)
        if finished:
            with self._cond:
                for r in finished:
                    if r in self._active:
                        self._active.remove(r)
            for r in finished:
                self._finish(r, None)

    # -- stats & telemetry -------------------------------------------------
    def stats(self):
        """Cumulative decode-serving snapshot: request counts, token
        throughput, time-to-first-token and inter-token latency
        percentiles, prefill-vs-decode step mix, KV-pool occupancy, swap
        state, prefix-cache counters."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        with self._cond:
            s = dict(self._stats)
            intervals = list(self._intervals)
            ttft = list(self._ttft)
            depth = len(self._queue)
            active = len(self._active)
            version = self._params.version
            versions = {id(r.params) for r in self._active
                        if r.params is not None}
            versions.add(id(self._params))
            shed_pri = dict(self._shed_by_priority)
        steps = s["prefill_steps"] + s["decode_steps"]
        out = {
            "name": getattr(self, "_metrics_label", None)
            or self.name or "default",
            "kind": "decode",
            "requests": s["requests"],
            "completed": s["completed"],
            "cancelled": s["cancelled"],
            "timeouts": s["timeouts"],
            "shed": s["shed"],
            "errors": s["errors"],
            "preempted": s["preempted"],
            "queue_depth": depth,
            "queue_peak": s["queue_peak"],
            "max_queue": self._max_queue,
            "active": active,
            "window": self._window,
            "prefill_steps": s["prefill_steps"],
            "decode_steps": s["decode_steps"],
            "decode_faults": s["decode_faults"],
            "prefill_fraction": round(s["prefill_steps"] / steps, 4)
            if steps else None,
            "tokens_out": s["tokens_out"],
            "tokens_per_sec": round(s["tokens_out"] / elapsed, 3),
            "kv": self._pool.stats(),
            "swaps": s["swaps"],
            "weight_version": version,
            "versions_alive": len(versions),
            "ladder": list(self._seq_ladder.buckets),
            # the fixed program set (None: eager, on the CPU)
            "graphs": self._programs.stats()
            if self._programs is not None else None,
        }
        if intervals:
            out["inter_token_ms"] = {
                "mean": round(sum(intervals) / len(intervals), 3),
                "p50": round(telemetry.percentile(intervals, 50), 3),
                "p99": round(telemetry.percentile(intervals, 99), 3),
                "max": round(max(intervals), 3),
            }
        if ttft:
            out["ttft_ms"] = {
                "mean": round(sum(ttft) / len(ttft), 3),
                "p50": round(telemetry.percentile(ttft, 50), 3),
                "p99": round(telemetry.percentile(ttft, 99), 3),
            }
        if shed_pri:
            out["shed_by_priority"] = {str(k): v for k, v
                                       in sorted(shed_pri.items())}
        lookups = s["prefix_hits"] + s["prefix_misses"]
        out["prefix"] = {
            "enabled": self._prefix_on,
            "owner": self._owner,
            "hits": s["prefix_hits"],
            "misses": s["prefix_misses"],
            "hit_rate": round(s["prefix_hits"] / lookups, 4)
            if lookups else 0.0,
            "hit_tokens": s["prefix_hit_tokens"],
            "bytes_saved": s["prefix_hit_tokens"]
            * self._pool.token_bytes,
            "cow_splits": s["cow_splits"],
            "cow_degraded": s["cow_degraded"],
            "cross_preempts": s["cross_preempts"],
            "pool": self._pool.prefix_stats(),
        }
        return out

    def latency_snapshot(self):
        """Recent inter-token intervals (ms), oldest first: the /metrics
        decode histogram's source."""
        with self._cond:
            return list(self._intervals)

    def _emit_record(self):
        st = self.stats()
        telemetry.decode_event(st)
        if self._prefix_on:
            px = dict(st["prefix"])
            px["name"] = st["name"]
            kv = st.get("kv") or {}
            if "owners" in kv:
                px["owners"] = kv["owners"]
            telemetry.prefix_cache_event(px)


def req_deadline(deadline_s):
    """Absolute monotonic deadline from a relative seconds budget
    (None disables; 0 is a real immediate deadline)."""
    return time.monotonic() + deadline_s if deadline_s is not None \
        else None
