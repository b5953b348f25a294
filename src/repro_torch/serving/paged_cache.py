"""Block-granular paged KV-cache pool (the vLLM idea, sized for SD serving);
the allocator is copied from repro/serving/paged_cache.py, the device
storage is torch.

One pool per model holds EVERY concurrent request's KV in fixed-size pages
(`page_size` tokens x all layers x kv heads x head dim); a request owns a
page table (ordered page list) + a token length.  This is what turns the
single-request serving path into a multi-tenant runtime:

* admission is a reservation against the free list (worst-case pages for
  prompt + max_new_tokens + draft window), so a request admitted by the
  batcher can never OOM mid-flight;
* speculative rewind is O(1): decrement the length and push whole pages that
  fell past the new high-water mark back onto the free list — the exact
  paged analogue of the dense cache's "reset the length" trick;
* release returns pages AND the unused tail of the reservation, so finished
  requests immediately make room for queued ones (continuous batching).

Two storage modes:

* ``alloc_storage=True`` (legacy / benchmark baseline): host-side numpy
  arrays, or CPU torch tensors for a torch dtype such as bfloat16
  (layer-stacked, ``(n_layers, num_pages, page_size, kv_heads,
  head_dim)``); a consumer gathers a request's pages into a dense view and
  scatters written spans back (``PagedSequence.append``/``gather_into``,
  serving/host_gather.py).
* ``alloc_storage=False`` (device-resident serving): this object is pure
  allocator/bookkeeper — KV bytes live in torch device tensors built by
  ``device_pool_init`` and are written in place by the model forward
  (``models/layers.paged_attention_update``), so no per-round host copies
  exist.  Sequences then use ``ensure_backed``/``advance``/``rewind(...,
  release_pages=False)`` so their page tables stay stable while the data
  stays on device.

The ``kernels/paged_attn.py`` kernel attends *in place* through the page
table (no gather) — same page layout either way.

Invariants (what the engine's hot loop is allowed to assume):

* **Page-table lifetime stability** — in device-resident mode a sequence's
  pages are reserved at admission AND backed eagerly (``ensure_backed``),
  so ``pages`` never changes between admission and release: the engine
  uploads each request's table row once and reuses it for every dispatch
  of the request's lifetime, including whole fused-PAR steps.
* **Rewind bounds** — ``rewind(n)`` requires ``0 <= n <= length`` (both
  validated); with ``release_pages=False`` it is a pure O(1) length update
  that never touches pages or data.  Callers may transiently ``advance``
  up to the reservation's capacity (a draft/verify window past the
  committed prefix) before rewinding back — the admission-time reservation
  (prompt + max_new_tokens + max draft window) is exactly the high-water
  bound that makes this safe.
* **Stale slots are write-before-read** — data past ``length`` is garbage
  by contract; every consumer masks by length and every new write lands at
  ``length``-relative positions, so rewound windows are overwritten before
  they could ever be attended.
* **Scratch page** — the device arrays carry one extra page (index
  ``num_pages``) the allocator never hands out; inactive or role-masked
  batch rows write there (duplicate writes are harmless because nothing
  reads it).
* **Scale freshness (``kv_quant="int8"``)** — a quantized pool stores K/V
  as int8 plus a per-slot-per-head float32 scale, laid out page-granular
  exactly like the data (``(..., page, slot, kv_head, 1)``), so a page's
  scales travel with the page through the table.  A scale entry must never
  outlive the value it was computed for: every write path stores value and
  scale together (host ``append`` quantizes both in one call; the device
  scatter writes both in one dispatch), and ``rewind``/``release`` zero
  the scale entries of dropped positions so a reused page can never
  dequantize with a stale scale.
* **Shared read-only prefix pages (prefix cache)** — a page may be mapped
  by several sequences at once: ``allocate_sequence(shared_pages=...,
  shared_tokens=...)`` maps an existing prefix (refcounting each page)
  ahead of a discounted reservation, and ``_give_page`` only frees a page
  when its last reference drops — releasing one mapper can never free a
  page another row (or the radix tree) still maps.  A sequence never
  WRITES a shared page: full shared pages sit entirely below the prefix
  (writes start at ``length >= shared_tokens``), and the one page a write
  could land in — a partially-shared last block — is copy-on-write
  swapped for a private page first (``needs_cow``/``cow_last_shared``;
  the replacement is funded by the reservation, which never discounts the
  partial page).  Speculative rewind therefore stays confined to private
  pages by construction, and ``rewind`` additionally refuses to pop a
  shared page.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PagedKVPool",
    "PagedSequence",
    "PoolStats",
    "bytes_per_token_for",
    "device_pool_store",
    "kv_quantize_np",
    "num_pages_for_bytes",
]

# "mixed" is allocator/stats-only: one page allocator backs BOTH a dense
# and an int8 device store (the engine picks a store per request), so host
# storage cannot be allocated in that mode and every page is accounted at
# the sum of both kinds' bytes.
KV_QUANT_MODES = ("none", "int8", "mixed")
_SCALE_BYTES = 4  # float32 per-slot-per-head scale


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)  # ceil div


def kv_quantize_np(span: np.ndarray):
    """Symmetric per-token-per-head int8 quantization (host mirror of
    ``models/layers._kv_quantize``): span (..., hd) -> (int8 values,
    float32 scales (..., 1))."""
    s = np.maximum(np.abs(span).max(axis=-1, keepdims=True), 1e-8) / 127.0
    s = s.astype(np.float32)
    q = np.clip(np.rint(span / s), -127, 127).astype(np.int8)
    return q, s


def _is_torch_dtype(dtype) -> bool:
    try:
        np.dtype(dtype)
    except TypeError:
        return True
    return False


def _dtype_info(dtype) -> Tuple[int, str]:
    """(itemsize, name) of a numpy dtype or a torch dtype (the port's pools
    carry the torch dtype of their device store, e.g. bfloat16)."""
    try:
        d = np.dtype(dtype)
    except TypeError:
        return dtype.itemsize, str(dtype).replace("torch.", "")
    return d.itemsize, d.name


def bytes_per_token_for(
    n_layers: int,
    kv_heads: int,
    head_dim: int,
    dtype=np.float32,
    kv_quant: str = "none",
) -> Dict[str, int]:
    """K+V bytes one cached token occupies under each storage kind a pool of
    this geometry allocates.  This is derived from the ACTUAL device-store
    layout (``device_pool_store``): dense pages are ``2 * n_layers *
    kv_heads * head_dim`` elements of the model dtype; int8 pages store the
    same element count as int8 PLUS one float32 scale per (slot, kv head)
    per K and per V — the per-page scale arrays are first-class residency,
    not bookkeeping, so every byte gauge denominated in this unit includes
    them.  ``"mixed"`` pools back every page with BOTH storages and report
    both kinds."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"kv_quant must be one of {KV_QUANT_MODES}, got {kv_quant!r}"
        )
    base = 2 * n_layers * kv_heads  # K and V, every layer, every kv head
    itemsize, name = _dtype_info(dtype)
    dense = base * head_dim * itemsize
    quant = base * (head_dim * 1 + _SCALE_BYTES)  # int8 values + f32 scale
    if kv_quant == "none":
        return {name: dense}
    if kv_quant == "int8":
        return {"int8": quant}
    return {name: dense, "int8": quant}


def num_pages_for_bytes(
    byte_budget: int,
    n_layers: int,
    kv_heads: int,
    head_dim: int,
    page_size: int,
    dtype=np.float32,
    kv_quant: str = "none",
) -> int:
    """Pages a byte budget buys under a storage kind — the admission-side
    inverse of ``bytes_per_token_for``.  Feeding COMPRESSED bytes (not raw
    page counts) into pool sizing is what lets an int8 pool admit ~3.5x the
    resident requests of an fp32 pool at the same byte budget: the page
    count scales with the true bytes/page of the storage kind."""
    per_page = sum(
        bytes_per_token_for(n_layers, kv_heads, head_dim, dtype, kv_quant)
        .values()
    ) * page_size
    if byte_budget < per_page:
        raise ValueError(
            f"pool byte budget {byte_budget} is below one page "
            f"({per_page} bytes at page_size={page_size}, kv_quant={kv_quant!r})"
        )
    return byte_budget // per_page


@dataclasses.dataclass
class PoolStats:
    num_pages: int
    page_size: int
    used_pages: int
    reserved_pages: int  # reservation not yet backed by allocated pages
    free_pages: int  # physically free (some may be spoken for)
    available_pages: int  # free minus outstanding reservations
    high_water_pages: int
    kv_quant: str = "none"
    bytes_per_token: float = 0.0  # K+V bytes (incl. scales) per cached token
    kv_bytes_total: int = 0  # bytes resident in allocated pages right now
    # bytes resident per storage kind — page-granular, derived from the
    # device-store layout, so int8/mixed totals include the per-page f32
    # scale arrays (kv_bytes_total is exactly the sum of these)
    kv_bytes_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    shared_pages: int = 0  # pages mapped by more than one holder (ref > 1)

    @property
    def utilization(self) -> float:
        return self.used_pages / self.num_pages if self.num_pages else 0.0


class PagedKVPool:
    """Fixed-size page pool with a free-list allocator and reservations."""

    def __init__(
        self,
        n_layers: int,
        kv_heads: int,
        head_dim: int,
        num_pages: int,
        page_size: int,
        dtype=np.float32,
        alloc_storage: bool = True,
        kv_quant: str = "none",
    ):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        if kv_quant not in KV_QUANT_MODES:
            raise ValueError(
                f"kv_quant must be one of {KV_QUANT_MODES}, got {kv_quant!r}"
            )
        self.n_layers = n_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.dtype = dtype
        self.kv_quant = kv_quant
        self.k_scale = None
        self.v_scale = None
        if alloc_storage:
            if kv_quant == "mixed":
                raise NotImplementedError(
                    "kv_quant='mixed' pools are allocator-only (the engine "
                    "keeps one device store per kind); host-mode storage "
                    "must pick 'none' or 'int8'"
                )
            shape = (n_layers, num_pages, page_size, kv_heads, head_dim)
            if _is_torch_dtype(dtype):
                # a torch dtype (bfloat16 has no numpy dtype): CPU tensors
                # of that dtype move the same bytes; dense pages only
                if kv_quant != "none":
                    raise NotImplementedError(
                        "host storage of a torch dtype holds dense pages (kv_quant='none')"
                    )
                import torch  # deferred: the allocator stays importable without torch

                self.k = torch.zeros(shape, dtype=dtype)
                self.v = torch.zeros(shape, dtype=dtype)
            else:
                store_dt = np.int8 if kv_quant == "int8" else dtype
                self.k = np.zeros(shape, store_dt)
                self.v = np.zeros(shape, store_dt)
            if kv_quant == "int8":
                sshape = shape[:-1] + (1,)
                self.k_scale = np.zeros(sshape, np.float32)
                self.v_scale = np.zeros(sshape, np.float32)
        else:  # pure allocator: KV bytes live in a device pool
            self.k = None
            self.v = None
        # LIFO free list: recently released pages are reused first (warm)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._allocated: set = set()
        self._reserved_unbacked = 0
        self.high_water = 0
        # page refcounts for SHARED pages only (allocated pages default to
        # ref 1); a page frees when its last reference drops
        self._ref: Dict[int, int] = {}

    # -- accounting ---------------------------------------------------------

    @property
    def used_pages(self) -> int:
        return len(self._allocated)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages neither allocated nor promised to an admitted request."""
        return len(self._free) - self._reserved_unbacked

    def can_reserve(self, n_pages: int) -> bool:
        return n_pages <= self.available_pages

    def bytes_per_token_by_kind(self) -> Dict[str, int]:
        """K+V bytes one cached token occupies, split by storage kind
        (label value is the storage dtype name: the model dtype for dense
        pages, ``"int8"`` for compressed pages incl. their f32 scale).
        Dense/int8 pools have one entry; ``"mixed"`` pools back every page
        with BOTH storages and report both."""
        return bytes_per_token_for(
            self.n_layers, self.kv_heads, self.head_dim,
            self.dtype, self.kv_quant,
        )

    def bytes_per_token(self) -> int:
        """K+V bytes one cached token occupies, including scale overhead for
        quantized pools — the dtype-aware unit `kv_bytes_total` and the
        bench's residency A/B are denominated in.  (``"mixed"`` pools sum
        both storages: every page is backed dense AND int8.)"""
        return sum(self.bytes_per_token_by_kind().values())

    def bytes_per_page(self) -> int:
        return self.bytes_per_token() * self.page_size

    def stats(self) -> PoolStats:
        used_tokens = self.used_pages * self.page_size
        by_kind = {
            kind: bpt * used_tokens
            for kind, bpt in self.bytes_per_token_by_kind().items()
        }
        return PoolStats(
            num_pages=self.num_pages,
            page_size=self.page_size,
            used_pages=self.used_pages,
            reserved_pages=self._reserved_unbacked,
            free_pages=self.free_pages,
            available_pages=self.available_pages,
            high_water_pages=self.high_water,
            kv_quant=self.kv_quant,
            bytes_per_token=float(self.bytes_per_token()),
            kv_bytes_total=sum(by_kind.values()),
            kv_bytes_by_kind=by_kind,
            shared_pages=self.shared_page_count,
        )

    # -- shared-page refcounting (prefix cache) -------------------------------

    @property
    def shared_page_count(self) -> int:
        """Pages currently held by more than one reference (mapped by
        several sequences and/or pinned by the prefix-cache radix tree)."""
        return len(self._ref)

    def page_ref(self, page: int) -> int:
        """Reference count of `page` (0 when free, 1 for a sole owner)."""
        if page not in self._allocated:
            return 0
        return self._ref.get(page, 1)

    def incref_page(self, page: int) -> None:
        """Add a reference to an ALLOCATED page (map it into another
        sequence, or pin it in the prefix-cache tree).  Every reference is
        returned through ``_give_page``, which frees only the last one."""
        if page not in self._allocated:
            raise RuntimeError(f"incref of unallocated page {page}")
        self._ref[page] = self._ref.get(page, 1) + 1

    # -- sequence lifecycle -------------------------------------------------

    def allocate_sequence(
        self,
        max_tokens: int,
        shared_pages: Optional[Sequence[int]] = None,
        shared_tokens: int = 0,
    ) -> Optional["PagedSequence"]:
        """Reserve worst-case capacity for one request; None if it won't fit.

        `max_tokens` is the cache high-water mark (prompt + generation +
        draft/verify window), not just the prompt length.

        ``shared_pages``/``shared_tokens`` map an existing read-only prefix
        (prefix cache hit): the listed pages — covering exactly
        ``shared_tokens`` positions — are refcounted and become the front of
        the new sequence's page table, and the reservation is discounted by
        the number of FULLY shared pages.  A partially-shared last page is
        deliberately NOT discounted: its reservation slot funds the private
        copy ``cow_last_shared`` swaps in before the sequence's first write
        into that block."""
        capacity = pages_for(max_tokens, self.page_size)
        if capacity > self.num_pages:
            raise ValueError(
                f"request needs {capacity} pages > pool capacity "
                f"{self.num_pages}"
            )
        shared = list(shared_pages) if shared_pages else []
        if shared:
            if not 0 < shared_tokens <= max_tokens:
                raise ValueError(
                    f"shared_tokens {shared_tokens} out of (0, {max_tokens}]"
                )
            if pages_for(shared_tokens, self.page_size) != len(shared):
                raise ValueError(
                    f"{len(shared)} shared pages cover "
                    f"{pages_for(shared_tokens, self.page_size)} blocks, not "
                    f"shared_tokens={shared_tokens}"
                )
        elif shared_tokens:
            raise ValueError("shared_tokens without shared_pages")
        full_shared = shared_tokens // self.page_size
        need = capacity - full_shared
        if not self.can_reserve(need):
            return None
        for page in shared:
            self.incref_page(page)
        self._reserved_unbacked += need
        return PagedSequence(
            self, reservation=need,
            shared_pages=shared, shared_tokens=shared_tokens,
            capacity_pages=capacity,
        )

    # -- internal page ops (called by PagedSequence) ------------------------

    def _take_page(self) -> int:
        page = self._free.pop()
        self._allocated.add(page)
        self._reserved_unbacked -= 1
        self.high_water = max(self.high_water, self.used_pages)
        return page

    def _give_page(self, page: int, *, back_to_reservation: bool) -> None:
        if page not in self._allocated:
            raise RuntimeError(f"double-free of page {page}")
        ref = self._ref.get(page, 1)
        if ref > 1:
            # another sequence (or the prefix tree) still maps this page:
            # drop one reference, keep the page allocated.  A shared page
            # was never part of this holder's reservation, so it cannot
            # return to one.
            if back_to_reservation:
                raise RuntimeError(
                    f"shared page {page} cannot return to a reservation"
                )
            if ref == 2:
                del self._ref[page]
            else:
                self._ref[page] = ref - 1
            return
        self._allocated.remove(page)
        self._free.append(page)
        if back_to_reservation:
            self._reserved_unbacked += 1


class PagedSequence:
    """One request's page table + length over a shared PagedKVPool.

    A sequence may start life with a read-only SHARED PREFIX (prefix cache
    hit): ``pages[:n_shared]`` are refcounted pages owned jointly with other
    sequences and/or the prefix tree, covering ``shared_tokens`` committed
    positions, and ``length`` starts at ``shared_tokens``.  Shared pages are
    never written; when ``shared_tokens`` ends mid-page the holder must call
    ``cow_last_shared()`` before its first write (``append``/``advance``
    enforce this).  Rewind never reaches below ``shared_tokens``, so the
    speculative-rewind contract only ever touches private pages."""

    def __init__(
        self,
        pool: PagedKVPool,
        reservation: int,
        shared_pages: Sequence[int] = (),
        shared_tokens: int = 0,
        capacity_pages: Optional[int] = None,
    ):
        self.pool = pool
        self.pages: List[int] = list(shared_pages)
        self.length = shared_tokens
        self.reservation = reservation
        self.n_shared = len(self.pages)
        self.shared_tokens = shared_tokens
        self.capacity_pages = (
            capacity_pages if capacity_pages is not None else reservation
        )
        self.released = False

    # -- index helpers ------------------------------------------------------

    def _flat_index(self, start: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(page ids, in-page slots) for token positions [start, start+n)."""
        pos = np.arange(start, start + n)
        page_idx = pos // self.pool.page_size
        return np.asarray(self.pages, np.int64)[page_idx], pos % self.pool.page_size

    def flat_slots(self, positions) -> np.ndarray:
        """Flat pool-slot index (page * page_size + in-page slot) of each
        absolute token position — the device-store row a position occupies
        once pool arrays are viewed as (n_layers, P * page_size, ...).

        Positions must be backed (< len(pages) * page_size).  This is the
        public indexing the engine's tree-path compaction uses to copy
        accepted-branch KV into canonical chain order on device."""
        assert not self.released, "flat_slots on a released sequence"
        pos = np.asarray(positions, np.int64)
        ps = self.pool.page_size
        assert pos.size == 0 or (
            pos.min() >= 0 and pos.max() < len(self.pages) * ps
        ), (positions, len(self.pages))
        pages = np.asarray(self.pages, np.int64)[pos // ps]
        return pages * ps + pos % ps

    def _ensure_capacity(self, n_tokens: int) -> None:
        need = pages_for(n_tokens, self.pool.page_size)
        while len(self.pages) < need:
            if len(self.pages) >= self.capacity_pages:
                raise RuntimeError(
                    f"sequence exceeded its reservation-backed capacity of "
                    f"{self.capacity_pages} pages"
                )
            self.pages.append(self.pool._take_page())

    # -- shared-prefix / copy-on-write ---------------------------------------

    @property
    def owned_pages(self) -> int:
        """Pages this sequence owns privately (excludes the shared prefix)."""
        return len(self.pages) - self.n_shared

    @property
    def needs_cow(self) -> bool:
        """True while the write frontier sits inside a shared page: the
        prefix ends mid-block, so the first write would scatter into a page
        other holders read.  ``cow_last_shared()`` clears it."""
        return self.n_shared > 0 and self.length < self.n_shared * self.pool.page_size

    def cow_last_shared(self) -> Tuple[int, int]:
        """Swap the partially-shared last prefix page for a private copy.

        Funded by this sequence's reservation — allocation deliberately does
        not discount the partial block.  On host-storage pools the page
        contents (values AND scales) are copied here; storage-less pools
        return ``(src, dst)`` so the device-resident caller can mirror the
        copy in its device stores before the next table upload.  The source
        page loses one reference."""
        assert not self.released, "cow on a released sequence"
        if not self.needs_cow:
            raise RuntimeError("cow_last_shared: no partially-shared page")
        if self.owned_pages >= self.reservation:
            raise RuntimeError("cow_last_shared: reservation exhausted")
        src = self.pages[self.n_shared - 1]
        dst = self.pool._take_page()
        if self.pool.k is not None:
            self.pool.k[:, dst] = self.pool.k[:, src]
            self.pool.v[:, dst] = self.pool.v[:, src]
            if self.pool.k_scale is not None:
                self.pool.k_scale[:, dst] = self.pool.k_scale[:, src]
                self.pool.v_scale[:, dst] = self.pool.v_scale[:, src]
        self.pages[self.n_shared - 1] = dst
        self.n_shared -= 1
        self.pool._give_page(src, back_to_reservation=False)
        return src, dst

    # -- data path ----------------------------------------------------------

    def append(self, k_span: np.ndarray, v_span: np.ndarray) -> None:
        """Write KV for token span [length, length+L) and advance length.

        k_span/v_span: (n_layers, L, kv_heads, head_dim)."""
        assert not self.released, "append on a released sequence"
        if self.pool.k is None:
            raise RuntimeError(
                "host append on a storage-less pool (device-resident mode); "
                "use advance() — data is written by the model forward"
            )
        l = k_span.shape[1]
        if l == 0:
            return
        if self.needs_cow:
            raise RuntimeError(
                "append into a partially-shared page; call cow_last_shared() first"
            )
        self._ensure_capacity(self.length + l)
        pg, slot = self._flat_index(self.length, l)
        if self.pool.kv_quant == "int8":
            kq, ks = kv_quantize_np(np.asarray(k_span, np.float32))
            vq, vs = kv_quantize_np(np.asarray(v_span, np.float32))
            # value and scale land together — a slot is never readable with
            # a scale from a previous tenant of the page
            self.pool.k[:, pg, slot] = kq
            self.pool.v[:, pg, slot] = vq
            self.pool.k_scale[:, pg, slot] = ks
            self.pool.v_scale[:, pg, slot] = vs
        else:
            self.pool.k[:, pg, slot] = k_span
            self.pool.v[:, pg, slot] = v_span
        self.length += l

    # -- device-resident bookkeeping (no host data path) --------------------

    def ensure_backed(self, n_tokens: int) -> None:
        """Eagerly back pages for `n_tokens` capacity (device-resident mode:
        backing everything at admission keeps the page table stable for the
        request's whole lifetime, so it uploads once, not per round).
        Admission already reserved the worst case, so this cannot fail for
        n_tokens within the reservation."""
        assert not self.released, "ensure_backed on a released sequence"
        self._ensure_capacity(n_tokens)

    def advance(self, n: int) -> None:
        """Advance length by n WITHOUT touching data — the device pool was
        already written in place by the model forward's paged scatter."""
        assert not self.released, "advance on a released sequence"
        if n < 0:
            raise ValueError(f"advance expects n >= 0, got {n}")
        if n > 0 and self.needs_cow:
            raise RuntimeError(
                "advance into a partially-shared page; call cow_last_shared() "
                "first (the device scatter would have written a shared page)"
            )
        self._ensure_capacity(self.length + n)
        self.length += n

    def gather_into(self, k_dst: np.ndarray, v_dst: np.ndarray) -> None:
        """Materialize the dense per-request view: dst (n_layers, S_pad, kvh,
        hd) receives the pages' contents at their token positions.  Slots
        beyond `length` are left as-is — every consumer masks by length."""
        assert not self.released
        if self.pool.k is None:
            raise RuntimeError(
                "host gather on a storage-less pool (device-resident mode)"
            )
        assert self.length <= k_dst.shape[1], (self.length, k_dst.shape)
        n = len(self.pages)
        if n == 0:
            return
        ps = self.pool.page_size
        pg = np.asarray(self.pages, np.int64)
        # the last page's tail may overhang a dst that is not a multiple of
        # page_size — clamp the copy (only junk slots past `length` drop)
        m = min(n * ps, k_dst.shape[1])
        span = self.pool.k[:, pg].reshape(self.pool.n_layers, n * ps, *k_dst.shape[2:])
        span_v = self.pool.v[:, pg].reshape(self.pool.n_layers, n * ps, *v_dst.shape[2:])
        if self.pool.kv_quant == "int8":
            sshape = (self.pool.n_layers, n * ps, self.pool.kv_heads, 1)
            ks = self.pool.k_scale[:, pg].reshape(sshape)
            vs = self.pool.v_scale[:, pg].reshape(sshape)
            k_dst[:, :m] = (span[:, :m].astype(np.float32) * ks[:, :m]).astype(
                k_dst.dtype
            )
            v_dst[:, :m] = (span_v[:, :m].astype(np.float32) * vs[:, :m]).astype(
                v_dst.dtype
            )
        else:
            k_dst[:, :m] = span[:, :m]
            v_dst[:, :m] = span_v[:, :m]

    def rewind(self, n: int, *, release_pages: bool = True) -> None:
        """Drop the last n tokens in O(pages dropped): adjust the length and
        return whole pages past the new high-water mark to the free list
        (into this sequence's reservation, so it may regrow).

        release_pages=False keeps every backed page (device-resident mode:
        the table must stay stable and the pages are reserved anyway), making
        speculative rewind a pure O(1) length update — mirroring the
        engine's `rewind` contract including its n >= 0 / over-rewind
        validation.

        On a quantized pool BOTH forms additionally zero the dropped
        positions' scale entries (the partially-rewound tail of the retained
        last page included): data past ``length`` is garbage by contract,
        but a scale is *metadata* — left stale it could pair with a later
        tenant's int8 values if a write path ever split value and scale.
        Zeroing makes the failure mode loud (dequantizes to 0) instead of
        silently plausible."""
        assert not self.released, "rewind on a released sequence"
        if n < 0:
            raise ValueError(f"rewind expects n >= 0, got {n}")
        if n > self.length:
            raise ValueError(f"over-rewind: length {self.length} < rewind {n}")
        if self.length - n < self.shared_tokens:
            raise ValueError(
                f"rewind below the shared prefix: {self.length - n} < "
                f"{self.shared_tokens} committed shared tokens"
            )
        old_length = self.length
        self.length -= n
        self._invalidate_scales(self.length, old_length)
        if not release_pages:
            return
        keep = max(pages_for(self.length, self.pool.page_size), self.n_shared)
        while len(self.pages) > keep:
            self.pool._give_page(self.pages.pop(), back_to_reservation=True)

    def _invalidate_scales(self, start: int, stop: int) -> None:
        """Zero host-side scale entries for token positions [start, stop)
        (clamped to backed pages) — no-op for unquantized or storage-less
        pools (the device scatter writes value+scale in one dispatch, so
        device pools have no stale-scale window to close)."""
        if self.pool.k_scale is None:
            return
        # never scribble on pages other holders still read: skip the shared
        # prefix and any privately-listed page the prefix tree pinned after
        # this sequence donated it (pool ref > 1)
        start = max(start, self.n_shared * self.pool.page_size)
        stop = min(stop, len(self.pages) * self.pool.page_size)
        if stop <= start:
            return
        pg, slot = self._flat_index(start, stop - start)
        sole = np.asarray([self.pool.page_ref(int(p)) <= 1 for p in pg])
        pg, slot = pg[sole], slot[sole]
        if len(pg) == 0:
            return
        self.pool.k_scale[:, pg, slot] = 0.0
        self.pool.v_scale[:, pg, slot] = 0.0

    def release(self) -> None:
        """Return every page reference and the unused reservation to the
        pool.  Shared pages (prefix hits, or private pages later donated to
        the prefix tree) only lose a reference here; a page is freed at its
        last reference, so releasing one row can never free a page another
        row still maps."""
        if self.released:
            raise RuntimeError("double release of PagedSequence")
        self._invalidate_scales(0, len(self.pages) * self.pool.page_size)
        owned = self.owned_pages
        for page in self.pages:
            self.pool._give_page(page, back_to_reservation=False)
        self.pool._reserved_unbacked -= self.reservation - owned
        self.pages = []
        self.length = 0
        self.n_shared = 0
        self.released = True


# ---------------------------------------------------------------------------
# Device-resident pool storage
# ---------------------------------------------------------------------------


def device_pool_store(pool: PagedKVPool, device,
                      kv_quant: Optional[str] = None) -> Dict[str, "object"]:
    """Device storage for `pool` of one storage kind (``kv_quant``, default
    the pool's own; a "mixed" pool builds one store per kind): ``{"k",
    "v"}`` torch tensors of shape ``(n_layers, num_pages + 1, page_size,
    kv_heads, head_dim)`` on ``device``, of the pool's dtype (a
    ``torch.dtype``) for "none", int8 for "int8" plus float32 ``{"k_scale",
    "v_scale"}`` of shape ``(..., kv_heads, 1)`` (one scale per slot and kv
    head, on the same page layout).

    One extra SCRATCH page (index ``pool.num_pages``, never handed out by
    the allocator) absorbs writes from inactive batch rows, whose page
    tables point every slot at it.  The model forward writes new tokens
    (and their scales) in place (``models/layers.paged_attention_update``);
    speculative rewind never touches the tensors (stale slots are masked by
    length, then overwritten)."""
    import torch  # deferred: the allocator stays importable without torch

    kind = kv_quant if kv_quant is not None else pool.kv_quant
    if kind not in ("none", "int8"):
        raise ValueError(
            f"a device store holds one storage kind ('none' or 'int8'), got {kind!r}"
        )
    if not isinstance(pool.dtype, torch.dtype):
        raise TypeError(f"device stores need a torch dtype, got {pool.dtype}")
    shape = (
        pool.n_layers,
        pool.num_pages + 1,
        pool.page_size,
        pool.kv_heads,
        pool.head_dim,
    )
    if kind == "int8":
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=pool.dtype, device=device),
        "v": torch.zeros(shape, dtype=pool.dtype, device=device),
    }
