"""Paged KV-cache pool for stateful autoregressive decode (counterpart
of ``mxnet_tpu/serving/kvcache.py``).

The server owns one device-resident pool of **fixed-size pages** per K
and V — shape ``(n_layers, n_pages, page_size, n_heads, head_dim)`` —
and each in-flight request holds a *page table*, a short list of page
ids covering its token positions in order:

- **gather** (:func:`gather_pages`) — indexing the pool with a
  ``(batch, max_pages)`` page table yields a ``(batch, max_pages *
  page_size, ...)`` contiguous copy per request, where a token's cache
  index IS its absolute position. Unallocated table entries point at
  the reserved **dump page 0**, whose garbage the per-row ``lengths`` of
  ``parallel.flash_attention.flash_decode`` masks to exact-zero weight.
- **scatter** (:func:`scatter_token` / :func:`scatter_prefill`) — new
  K/V rows write back through the same table.

**In place, not functional.** The JAX ops return an updated pool
(``.at[].set``) and the server re-points its arrays at it. Here every
scatter writes into the pool tensors themselves (``index_put_``), which
saves a copy of the whole pool per step; the scatter functions return
the same tensors for symmetry with the JAX signatures. Duplicate
indices (the inactive rows of a decode window all write slot 0 of the
dump page) land in the dump page, which nobody reads.

Page *accounting* is host-side: an allocate/free free-list under a
lock, refcounts for prefix sharing, per-model quotas, and counters.
Page reclaim visits the ``kv_evict`` fault site once per page; a
planned raise there is counted and the page is reclaimed anyway.

**Quantized storage** (``MXNET_KV_DTYPE=int8`` or ``dtype=``): int8
pages with one float32 scale per ``(layer, page)``
(``.k_scale``/``.v_scale``, shape ``(L, P)``):

- :func:`gather_pages_q8` dequantizes on gather;
- :func:`scatter_token_q8` grows a page's scale monotonically
  (``max(old, amax/127)``) and requantizes the page body under it —
  except on a page's FIRST slot, where the scale is set fresh;
- :func:`scatter_prefill_q8` sets each covered page's scale from its
  own token chunk (rows at/after ``n_valid`` are zeroed first).

Rounding is half to even (``torch.round``, as ``jnp.round``), clipped
to +-127 before the int8 cast. bfloat16 storage needs no scales.

**Prefix sharing** (:class:`PrefixIndex`): refcounted pages under SHA-1
digests of the whole token prefix up to each page boundary, namespaced
by share group + weight generation; cold entries are evicted LRU-first
under pool pressure, refcounted pages never. **Multi-model pools**:
:meth:`KVCachePool.attach` registers several decode servers on one pool
with quotas and pool priorities; ``step_lock`` serializes their steps
on the shared tensors.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import envs, fault
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["KVCachePool", "PrefixIndex", "gather_pages",
           "scatter_token", "scatter_prefill", "pages_for",
           "gather_pages_q8", "scatter_token_q8",
           "scatter_prefill_q8"]

_INT8_MAX = 127.0
_EPS = 1e-8          # scale floor: an all-zero chunk still divides

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def pages_for(n_tokens, page_size):
    """Pages needed to back ``n_tokens`` positions."""
    return -(-int(n_tokens) // int(page_size))


def _index(x, device):
    return torch.as_tensor(x, device=device).to(torch.long)


# ---------------------------------------------------------------------------
# pool ops
# ---------------------------------------------------------------------------

def gather_pages(pages, page_table):
    """``pages (L, P, S, ...)`` indexed by ``page_table (B, M)`` →
    contiguous per-request caches ``(L, B, M*S, ...)``: cache index ==
    absolute token position. Table entries of 0 bring in the dump
    page — finite garbage the attention mask zeroes exactly."""
    g = pages[:, _index(page_table, pages.device)]   # (L, B, M, S, ...)
    shape = g.shape
    return g.reshape(shape[0], shape[1], shape[2] * shape[3],
                     *shape[4:])


def _token_slots(pages, page_table, positions):
    """(page id, slot) of each row's absolute position."""
    S = pages.shape[2]
    pos = _index(positions, pages.device)
    table = _index(page_table, pages.device)
    pidx = torch.gather(table, 1, (pos // S)[:, None])[:, 0]   # (B,)
    return pidx, pos % S


def scatter_token(pages, page_table, positions, new):
    """Write one decode step's new K (or V) rows into the pool IN
    PLACE: ``new (L, B, H, D)`` lands at each row's absolute
    ``positions (B,)`` through its ``page_table (B, M)`` row. Inactive
    rows must carry an all-zero table row — their write lands in the
    dump page. Returns ``pages``."""
    pidx, slot = _token_slots(pages, page_table, positions)
    pages[:, pidx, slot] = new.to(pages.dtype)
    return pages


def _prefill_slots(pages, page_table_row, Lr, n_valid):
    S = pages.shape[2]
    pos = torch.arange(Lr, device=pages.device)
    table = _index(page_table_row, pages.device)
    valid = pos < _index(n_valid, pages.device)
    pidx = torch.where(valid, table[pos // S], 0)
    return pos, valid, pidx, pos % S


def scatter_prefill(pages, page_table_row, seq, n_valid):
    """Write one request's prefill K (or V) sequence into the pool IN
    PLACE: ``seq (L, Lr, H, D)`` at positions ``0..Lr-1`` through
    ``page_table_row (M,)``. Positions at or beyond ``n_valid`` (rung
    padding) are routed to the dump page. ``n_valid`` may be an int or a
    0-d tensor on the pool's device, which the write reads there (no
    host sync: the server's prefill graphs take it so). Returns
    ``pages``."""
    _pos, _valid, pidx, slot = _prefill_slots(
        pages, page_table_row, seq.shape[1], n_valid)
    pages[:, pidx, slot] = seq.to(pages.dtype)
    return pages


# ---------------------------------------------------------------------------
# quantized (int8 + per-page float32 scale) variants
# ---------------------------------------------------------------------------

def _quantize(x):
    return torch.clamp(torch.round(x), -_INT8_MAX, _INT8_MAX) \
        .to(torch.int8)


def gather_pages_q8(pages, scales, page_table):
    """:func:`gather_pages` for an int8 pool: ``pages (L, P, S, ...)``
    int8 + ``scales (L, P)`` float32, indexed by ``page_table (B, M)``
    → DEQUANTIZED float32 caches ``(L, B, M*S, ...)`` — each page's
    scale broadcasts over its token slots."""
    table = _index(page_table, pages.device)
    g = pages[:, table]                        # (L, B, M, S, ...)
    s = scales[:, table]                       # (L, B, M)
    extra = (1,) * (g.dim() - s.dim())
    out = g.to(torch.float32) * s.reshape(s.shape + extra)
    shape = out.shape
    return out.reshape(shape[0], shape[1], shape[2] * shape[3],
                       *shape[4:])


def scatter_token_q8(pages, scales, page_table, positions, new):
    """:func:`scatter_token` for an int8 pool, IN PLACE: quantize the
    step's new float32 rows ``new (L, B, H, D)`` into their pages and
    grow each touched page's scale monotonically — ``max(old,
    amax/127)`` — with the page body requantized under the grown scale.
    A write on a page's FIRST slot instead sets the scale fresh and
    zeroes the body (a newly allocated page whose stale content belongs
    to a prior tenant). Returns ``(pages, scales)``."""
    pidx, slot = _token_slots(pages, page_table, positions)
    B = new.shape[1]
    amax = torch.amax(torch.abs(new), dim=(2, 3))        # (L, B)
    need = torch.clamp_min(amax, _EPS) / _INT8_MAX
    old = scales[:, pidx]                                 # (L, B)
    first = (slot == 0)[None, :]
    new_scale = torch.where(first, need, torch.maximum(old, need))
    ratio = torch.where(first, torch.zeros_like(old), old / new_scale)
    body = pages[:, pidx].to(torch.float32) \
        * ratio[:, :, None, None, None]                   # (L, B, S, H, D)
    rows = torch.arange(B, device=pages.device)
    body[:, rows, slot] = new / new_scale[:, :, None, None]
    pages[:, pidx] = _quantize(body)
    scales[:, pidx] = new_scale
    return pages, scales


def scatter_prefill_q8(pages, scales, page_table_row, seq, n_valid):
    """:func:`scatter_prefill` for an int8 pool, IN PLACE: one request's
    prefill rows ``seq (L, Lr, H, D)`` quantize page-chunk-wise — each
    covered page's scale comes from its own ``page_size``-token chunk's
    amax (rows at/after ``n_valid`` are zeroed first, so rung padding
    neither lands in a page nor inflates a scale). Scales are SET, not
    grown. Returns ``(pages, scales)``."""
    S = pages.shape[2]
    L, Lr = seq.shape[0], seq.shape[1]
    pos, valid, pidx, slot = _prefill_slots(pages, page_table_row, Lr,
                                            n_valid)
    seq = torch.where(valid[None, :, None, None], seq,
                      torch.zeros((), dtype=seq.dtype, device=seq.device))
    Lp = -(-Lr // S) * S
    seq_p = seq if Lp == Lr else torch.cat(
        [seq, seq.new_zeros((L, Lp - Lr) + tuple(seq.shape[2:]))], dim=1)
    chunks = seq_p.reshape(L, Lp // S, S, *seq.shape[2:])
    red = tuple(range(2, chunks.dim()))
    pscale = torch.clamp_min(torch.amax(torch.abs(chunks), dim=red),
                             _EPS) / _INT8_MAX            # (L, n_chunks)
    rscale = pscale[:, :, None].expand(L, Lp // S, S).reshape(L, Lp)[:, :Lr]
    pages[:, pidx, slot] = _quantize(seq / rscale[:, :, None, None])
    table = _index(page_table_row, pages.device)
    cpos = torch.arange(Lp // S, device=pages.device) * S
    cpidx = torch.where(cpos < _index(n_valid, pages.device),
                        table[cpos // S], 0)
    scales[:, cpidx] = pscale
    return pages, scales


# ---------------------------------------------------------------------------
# the prefix index
# ---------------------------------------------------------------------------

class PrefixIndex:
    """Content-addressed index over page-aligned token runs — the
    sharing map of the prefix cache.

    Keys are SHA-1 digests of the FULL token prefix up to each page
    boundary, computed incrementally and seeded with a namespace (share
    group + weight generation). Values are page ids. Each entry holds
    ONE pool reference — an indexed page survives the request that
    filled it until cold-prefix eviction reclaims it. Entries are
    LRU-ordered; eviction only takes entries whose page has no holder
    beyond the index itself. All mutation happens under the owning
    pool's lock."""

    def __init__(self, page_size):
        self.page_size = int(page_size)
        self._entries = OrderedDict()    # digest -> (page, namespace)
        self.hits = 0          # lookups that matched >= 1 page
        self.misses = 0        # lookups that matched nothing
        self.hit_tokens = 0    # prompt tokens served from the index
        self.inserted = 0      # entries ever registered
        self.evicted = 0       # entries dropped (cold or released)

    def __len__(self):
        return len(self._entries)

    def digests(self, namespace, tokens):
        """One digest per FULL page of ``tokens``, each covering the
        whole prefix up to its page boundary (chain-hashed: page i's
        digest extends page i-1's)."""
        arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
        h = hashlib.sha1(repr(namespace).encode())
        S = self.page_size
        out = []
        for i in range(len(arr) // S):
            h.update(arr[i * S:(i + 1) * S].tobytes())
            out.append(h.hexdigest())
        return out

    def _walk_locked(self, digests):
        """The pages of the longest consecutive hit run."""
        pages = []
        for d in digests:
            ent = self._entries.get(d)
            if ent is None:
                break
            pages.append(ent[0])
        return pages


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class KVCachePool:
    """One model's paged KV storage + host-side page accounting.

    The device tensors (``.k`` / ``.v``, plus ``.k_scale`` /
    ``.v_scale`` in int8 mode) are updated in place by the decode
    server's scheduler thread under ``step_lock``. Page ids are
    allocated lowest-first, so allocation order is deterministic. Page 0
    is reserved as the dump page and never allocated. ``device`` None
    means the current context's device, ``cuda:0`` unless the CPU was
    asked for (see :func:`~mxnet_tpu_torch.context.resolve_device`).
    """

    def __init__(self, n_layers, n_heads, head_dim, *, page_size=None,
                 n_pages=None, dtype=None, device=None):
        self.page_size = int(page_size) if page_size is not None \
            else envs.get_int("MXNET_KV_PAGE_SIZE")
        self.n_pages = int(n_pages) if n_pages is not None \
            else envs.get_int("MXNET_KV_POOL_PAGES")
        if self.page_size < 1:
            raise MXNetError("KVCachePool: page_size must be >= 1, "
                             "got %d" % self.page_size)
        if self.n_pages < 2:
            raise MXNetError(
                "KVCachePool: need at least 2 pages (page 0 is the "
                "reserved dump page), got %d" % self.n_pages)
        shape = (int(n_layers), self.n_pages, self.page_size,
                 int(n_heads), int(head_dim))
        if dtype is None:
            dtype = envs.get_str("MXNET_KV_DTYPE") or "float32"
        if isinstance(dtype, str):
            if dtype not in _DTYPES:
                raise MXNetError(
                    "KVCachePool: unknown MXNET_KV_DTYPE %r (one of "
                    "float32 | bfloat16 | int8)" % dtype)
            dtype = _DTYPES[dtype]
        if dtype not in _DTYPES.values():
            raise MXNetError("KVCachePool: unsupported dtype %s" % dtype)
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros(shape[:2], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(shape[:2], dtype=torch.float32,
                                       device=self.device)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self._lock = threading.Lock()
        # serializes co-tenant servers' steps on the shared tensors
        self.step_lock = threading.Lock()
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> 1
        self._used_peak = 0
        self._evicted = 0
        self._alloc_failures = 0
        self._pages_alloced = 0
        self._pages_freed = 0
        self._refs = {}          # page -> refcount (absent == free)
        self._page_owner = {}    # page -> client name (quota credit)
        self._clients = {}       # name -> {quota, priority, preempt, used}
        self._cow_splits = 0
        self._quota_denials = 0
        self.prefix = PrefixIndex(self.page_size)
        # bytes one token's K+V occupies across all layers
        elem = torch.empty((), dtype=dtype).element_size()
        self.token_bytes = (2 * self.n_layers * self.n_heads
                            * self.head_dim * elem)

    @property
    def usable_pages(self):
        """Allocatable pages (the pool minus the dump page)."""
        return self.n_pages - 1

    def pages_for(self, n_tokens):
        return pages_for(n_tokens, self.page_size)

    def alloc(self, n, owner=None):
        """``n`` page ids (lowest-free-first), or None when the pool
        cannot satisfy the request. With ``owner=`` (an :meth:`attach`
        name) the pages count against that model's quota; a quota
        denial fails WITHOUT evicting anyone else's cache. A plain
        shortfall first evicts COLD prefix-index entries through the
        counted ``kv_evict`` path, then retries."""
        n = int(n)
        while True:
            with self._lock:
                client = self._clients.get(owner)
                if client is not None and client["quota"] is not None \
                        and client["used"] + n > client["quota"]:
                    self._quota_denials += 1
                    self._alloc_failures += 1
                    return None
                if n <= len(self._free):
                    pages = [self._free.pop() for _ in range(n)]
                    for p in pages:
                        self._refs[p] = 1
                        if owner is not None:
                            self._page_owner[p] = owner
                    if client is not None:
                        client["used"] += n
                    self._pages_alloced += n
                    used = self.usable_pages - len(self._free)
                    if used > self._used_peak:
                        self._used_peak = used
                    return pages
                cold = self._pop_cold_prefixes_locked(
                    n - len(self._free))
                if not cold:
                    self._alloc_failures += 1
                    return None
            self.free(cold)   # counted kv_evict, outside the lock

    def free(self, pages):
        """Drop one reference per page. The LAST holder's drop visits
        the ``kv_evict`` fault site — a planned raise there is counted
        and the page is reclaimed anyway. Returns the number of pages
        actually reclaimed."""
        reclaimed = 0
        for p in pages:
            p = int(p)
            with self._lock:
                refs = self._refs.get(p, 1)
                if refs > 1:
                    self._refs[p] = refs - 1
                    continue
                self._refs.pop(p, None)
                owner = self._page_owner.pop(p, None)
                client = self._clients.get(owner)
                if client is not None and client["used"] > 0:
                    client["used"] -= 1
            try:
                fault.inject("kv_evict")
            except fault.InjectedFault:
                pass          # counted in fault.stats(); never a leak
            with self._lock:
                self._free.append(p)
                self._evicted += 1
                self._pages_freed += 1
                reclaimed += 1
        return reclaimed

    def retain(self, pages):
        """Add one reference to each page (prefix-share / index)."""
        with self._lock:
            for p in pages:
                p = int(p)
                self._refs[p] = self._refs.get(p, 1) + 1

    def ref(self, page):
        """Current refcount of ``page`` (0 if free)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def cow_release(self, page):
        """Drop the writer's reference from a shared page after a
        copy-on-write split (the other holders keep it)."""
        with self._lock:
            p = int(page)
            refs = self._refs.get(p, 1)
            if refs > 1:
                self._refs[p] = refs - 1
            self._cow_splits += 1

    def copy_page(self, src, dst):
        """Copy page ``src`` onto page ``dst`` in every layer (the
        copy-on-write split); an int8 page's scales travel with it, so
        the private copy dequantizes exactly like the shared one.
        ``src``/``dst`` are page ids or one-element long tensors on the
        pool's device, which the copy reads there (the server's copy
        graph takes them so)."""
        src = _index(src, self.device).reshape(1)
        dst = _index(dst, self.device).reshape(1)
        planes = (self.k, self.v)
        if self.quantized:
            planes += (self.k_scale, self.v_scale)
        for t in planes:
            t.index_copy_(1, dst, t.index_select(1, src))

    # -- multi-model attachment ---------------------------------------

    def attach(self, name, *, quota=None, priority=0, preempt=None):
        """Register a decode server as a pool tenant. Returns the
        (uniquified) owner name to pass to ``alloc(owner=)``. ``quota``
        caps the tenant's held pages (default ``MXNET_KV_MODEL_QUOTA``;
        0 = unlimited); ``preempt`` is a callback
        :meth:`request_preempt` may invoke from a HIGHER-priority
        tenant's thread — it must only schedule work."""
        if quota is None:
            q = envs.get_int("MXNET_KV_MODEL_QUOTA")
            quota = q if q > 0 else None
        with self._lock:
            base = str(name)
            uniq = base
            i = 1
            while uniq in self._clients:
                i += 1
                uniq = "%s-%d" % (base, i)
            self._clients[uniq] = {
                "quota": int(quota) if quota is not None else None,
                "priority": int(priority),
                "preempt": preempt,
                "used": 0,
            }
            return uniq

    def detach(self, name):
        with self._lock:
            self._clients.pop(name, None)

    def request_preempt(self, owner):
        """Ask LOWER-pool-priority co-tenants to give pages back:
        invokes their preemption callbacks (lowest priority first,
        outside the pool lock) until one accepts. Returns True if any
        tenant accepted."""
        with self._lock:
            me = self._clients.get(owner)
            my_pri = me["priority"] if me is not None else 0
            victims = sorted(
                ((c["priority"], n, c["preempt"])
                 for n, c in self._clients.items()
                 if n != owner and c["preempt"] is not None
                 and c["priority"] < my_pri and c["used"] > 0),
                key=lambda t: t[0])
        for _pri, _name, cb in victims:
            try:
                if cb():
                    return True
            except Exception:   # noqa: BLE001 — a co-tenant's failure
                continue        # must not stop the search
        return False

    # -- prefix cache --------------------------------------------------

    def prefix_lookup(self, namespace, tokens):
        """Longest page-aligned cached run of ``tokens`` under
        ``namespace``: returns ``(pages, n_tokens)`` with one reference
        RETAINED per returned page. Visits the ``kv_share`` fault site
        once per would-be hit; a planned raise there is a MISS."""
        digests = self.prefix.digests(namespace, tokens)
        if not digests:
            return [], 0
        with self._lock:
            if not self.prefix._walk_locked(digests):
                self.prefix.misses += 1
                return [], 0
        try:
            fault.inject("kv_share")
        except fault.InjectedFault:
            with self._lock:
                self.prefix.misses += 1
            return [], 0
        with self._lock:
            pages = self.prefix._walk_locked(digests)
            if not pages:          # raced away between the two walks
                self.prefix.misses += 1
                return [], 0
            for i, p in enumerate(pages):
                self._refs[p] = self._refs.get(p, 1) + 1
                self.prefix._entries.move_to_end(digests[i])
            n_tok = len(pages) * self.page_size
            self.prefix.hits += 1
            self.prefix.hit_tokens += n_tok
            return list(pages), n_tok

    def prefix_insert(self, namespace, tokens, pages):
        """Register ``pages`` (backing ``tokens`` from position 0) under
        their prefix digests. First writer wins; each NEW entry retains
        its page."""
        digests = self.prefix.digests(namespace, tokens)
        with self._lock:
            for i, d in enumerate(digests):
                if i >= len(pages):
                    break
                if d in self.prefix._entries:
                    self.prefix._entries.move_to_end(d)
                    continue
                p = int(pages[i])
                if p not in self._refs:
                    continue      # page already reclaimed elsewhere
                self._refs[p] = self._refs[p] + 1
                self.prefix._entries[d] = (p, namespace)
                self.prefix.inserted += 1

    def prefix_release(self, namespace):
        """Drop every index entry of ``namespace`` and free the index's
        references."""
        with self._lock:
            drop = [(d, ent[0])
                    for d, ent in self.prefix._entries.items()
                    if ent[1] == namespace]
            for d, _p in drop:
                del self.prefix._entries[d]
                self.prefix.evicted += 1
        self.free([p for _d, p in drop])

    def _pop_cold_prefixes_locked(self, n):
        """Up to ``n`` COLD index pages (refcount 1), oldest-LRU first;
        removes their entries and returns the pages for the caller to
        ``free`` OUTSIDE the lock."""
        out = []
        for d in list(self.prefix._entries):
            if len(out) >= n:
                break
            page, _ns = self.prefix._entries[d]
            if self._refs.get(page, 0) != 1:
                continue
            del self.prefix._entries[d]
            self.prefix.evicted += 1
            out.append(page)
        return out

    def stats(self):
        with self._lock:
            free = len(self._free)
            out = {
                "page_size": self.page_size,
                "pages": self.usable_pages,
                "dtype": str(self.dtype).replace("torch.", ""),
                "free": free,
                "used": self.usable_pages - free,
                "peak_used": self._used_peak,
                "evicted": self._evicted,
                "alloc_failures": self._alloc_failures,
                "pages_alloced": self._pages_alloced,
                "pages_freed": self._pages_freed,
                "shared_pages": sum(
                    1 for r in self._refs.values() if r > 1),
                "cow_splits": self._cow_splits,
                "quota_denials": self._quota_denials,
            }
            if self._clients:
                out["owners"] = {
                    n: {"used": c["used"], "quota": c["quota"],
                        "priority": c["priority"]}
                    for n, c in self._clients.items()}
            return out

    def prefix_stats(self):
        """The prefix cache's own counters."""
        with self._lock:
            px = self.prefix
            total = px.hits + px.misses
            return {
                "entries": len(px._entries),
                "hits": px.hits,
                "misses": px.misses,
                "hit_rate": px.hits / total if total else 0.0,
                "hit_tokens": px.hit_tokens,
                "bytes_saved": px.hit_tokens * self.token_bytes,
                "inserted": px.inserted,
                "evicted": px.evicted,
                "shared_pages": sum(
                    1 for r in self._refs.values() if r > 1),
                "cow_splits": self._cow_splits,
            }
