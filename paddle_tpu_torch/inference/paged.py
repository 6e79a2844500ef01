"""Paged KV cache and decode attention for serving.

Counterpart of ``paddle_tpu/inference/paged.py``.  The page pool is one
``[L, KV, num_pages, page_size, D]`` tensor each for K and V on the
cache's device (CUDA unless the caller names another), and — unlike the
JAX package, whose arrays are immutable — it is UPDATED IN PLACE:
``write_at``, ``append`` and the executor's per-layer decode writes
(``write_token``) store into the same storage, so the pool is never
copied.  This module alone knows the pool's layout and the
position -> (page, offset) arithmetic.  Page allocation is control plane and stays on the
host: a free list, a ``[max_seqs, max_pages_per_seq]`` int32 page table
(-1 = unset) and the per-slot lengths, all numpy.

Decode attention goes through :func:`paged_decode_attention`, the
reference's router: the head dims the hand-written kernels take go to
``ops.kernels.paged_decode`` (the CUDA kernels for tensors on the card,
their plain versions for tensors on the CPU), the rest to the dense
route (:func:`dense_paged_attention` and its int8 twin), as
``paddle_tpu`` sends shapes off its kernel's gate to
``_dense_paged_attention``.  ``PT_PAGED_IMPL`` forces a route.
:func:`masked_multihead_attention` is the single-token decode attention
over a dense cache.

Decode reads its per-step inputs from fixed-address device buffers
(``stage``: ids, positions, lengths and the page tables, filled by one
copy from a pinned host buffer), so a captured CUDA graph of the step
replays over the current batch.  The storage holds one page past
``num_pages``, the scratch page: no slot owns it, and the warm-up a
capture runs (``scratch_step``) writes only there.  ``k_pages`` /
``v_pages`` (and the int8 scales) are views of the first ``num_pages``.

``quant="int8"`` (``None`` follows ``PT_QUANT``) makes the pools int8
with one f32 scale per (layer, kv head, page) in ``k_scales`` /
``v_scales`` [L, KV, P]: writes quantize through ``ops.quant.kv_write``
(in place, as the float writes are), ``gather_dense`` dequantizes the
gathered window to ``compute_dtype``, and decode attention takes
``paged_decode_quant``.  The int8 K and V pools (and their scales) are
the two halves of one tensor, so one ``kv_write`` quantizes both: half
the eager launches of two calls, the same bits.  The float path is
unchanged by it.

Pages are REFCOUNTED, as in the reference: a page is on the free list
(count 0) or held by one or more owners, slot page-table rows and the
prefix cache's radix tree.  A page held twice is read-only: every write
path goes through :meth:`make_writable`, which copies a shared page into
a fresh one (one indexed device copy across all layers and kv heads,
the int8 scales with it).  ``free`` drops one reference a page, so
shared pages outlive the sequences that used them; ``reclaimer`` (the
prefix cache's LRU eviction) is asked for pages before any
"KV page pool exhausted" raise, and ``trim`` releases the pages a
rejected speculative window had reserved.  With no prefix cache every
count is 0 or 1 and nothing is copied.

Speculative decode's verify step reads two more step buffers, filled by
the same staging copy: the window ids ``[max_seqs, max_window]`` and the
commit limits ``[max_seqs]`` (:meth:`stage_verify`).

Fault points, as in the reference: ``prefix.cow`` brackets one
copy-on-write, ``quant.kv_write`` one host-side int8 page write
(``write_at`` / ``append``; after = pages and scales written, length not
yet advanced) and ``quant.dequant`` one dequantizing ``gather_dense``.
The per-layer decode writes (``write_token``) run inside the captured
decode step and fire nothing.

Not ported (ROADMAP.md Queue 1, item 8): the sequence-parallel writes
(``write_sharded``, ``gather_shards``).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import quant as _quant
from ..ops.kernels import paged_decode as _pd
from ..ops.kernels.paged_decode import paged_decode, paged_decode_quant
from ..testing import faults as _faults

_POOL_EXHAUSTED = "KV page pool exhausted"


# -- decode attention ops ----------------------------------------------------


def masked_multihead_attention(q, k_cache, v_cache, lengths):
    """Single-token decode attention against a dense cache (the
    reference's ``masked_multihead_attention``).

    q ``[B, H, D]``; k_cache / v_cache ``[B, KV, T, D]``; lengths ``[B]``
    valid token counts.  Returns ``[B, H, D]`` in q's dtype.  GQA when
    ``H % KV == 0``.  fp32 math, positions at or past the length masked
    with -1e30 (:func:`_dense_window`).  ``paddle_tpu``'s is a plain XLA
    function (its scores are float64 under x64, inside 2e-5 of these),
    so this one is plain PyTorch."""
    return _dense_window(q, k_cache.float(), v_cache.float(),
                         lengths.to(q.device))


def _dense_window(q, kc, vc, lengths):
    """fp32 decode attention of q ``[B, H, D]`` over gathered fp32
    windows kc / vc ``[B, KV, T, D]``, masked to each length: scores
    masked with -1e30, and V rows past the length zeroed (what an unread
    page holds never reaches the output).  No host sync and no tensor
    made from host data, so a CUDA graph can capture it."""
    B, H, D = q.shape
    KV, T = kc.shape[1], kc.shape[2]
    valid = (torch.arange(T, device=q.device)[None]
             < lengths.long()[:, None])                      # [B, T]
    qg = q.reshape(B, KV, H // KV, D).float()
    logits = torch.einsum("bkgd,bktd->bkgt", qg, kc) * (1.0 / np.sqrt(D))
    p = torch.softmax(logits.masked_fill(~valid[:, None, None], -1e30),
                      dim=-1)
    vc = vc.masked_fill(~valid[:, None, :, None], 0.0)
    out = torch.einsum("bkgt,bktd->bkgd", p, vc)
    return out.reshape(B, H, D).to(q.dtype)


def dense_paged_attention(q, k_pages, v_pages, lengths, page_indices):
    """The dense route of :func:`paged_decode_attention` (the reference's
    ``_dense_paged_attention``): gather each sequence's page window into
    a dense fp32 ``[B, KV, pps * ps, D]`` copy, then fp32 attention
    masked to the length, cast to q's dtype.  Any head dim.

    q ``[B, H, D]``; k/v_pages ``[KV, P, ps, D]``; lengths ``[B]``;
    page_indices ``[B, pps]`` (every entry a valid page id).  A separate
    function from the kernel's plain version
    (``ops.kernels.paged_decode.paged_decode_reference``), which only
    CPU tensors reach.  ``dense_paged_attention.launches`` counts its
    calls (no kernel: named as ``core.aot.CountedGraph`` reads a
    counter, so a replayed graph adds its captured calls)."""
    B, _, D = q.shape
    KV, _, ps, _ = k_pages.shape
    T = page_indices.shape[1] * ps
    idx = page_indices.long()
    kc = k_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
    vc = v_pages[:, idx].transpose(0, 1).reshape(B, KV, T, D).float()
    dense_paged_attention.launches += 1
    return _dense_window(q, kc, vc, lengths)


dense_paged_attention.launches = 0


def dense_paged_attention_q(q, k_pages, v_pages, lengths, page_indices,
                            k_scales, v_scales):
    """The int8 twin of :func:`dense_paged_attention` (the reference's
    ``_dense_paged_attention_q``): the gathered window (never the whole
    pool) dequantized with its per-page scales ``[KV, P]``, then the same
    fp32 attention.  ``dense_paged_attention_q.launches`` counts its
    calls."""
    B, _, D = q.shape
    KV, _, ps, _ = k_pages.shape
    T = page_indices.shape[1] * ps
    idx = page_indices.long()

    def window(pages, scales):
        w = pages[:, idx].float() * scales[:, idx][..., None, None]
        return w.transpose(0, 1).reshape(B, KV, T, D)

    dense_paged_attention_q.launches += 1
    return _dense_window(q, window(k_pages, k_scales),
                         window(v_pages, v_scales), lengths)


dense_paged_attention_q.launches = 0

#: the values of ``PT_PAGED_IMPL``.  The reference's fourth, ``stock``,
#: names jax's own TPU kernel, which the port has no counterpart of: it
#: is refused like any other unknown value.
PAGED_IMPLS = ("auto", "pallas", "dense")


def _select_impl(head_dim):
    """The decode-attention route: ``PT_PAGED_IMPL`` (default ``auto``)
    forces ``pallas`` (the hand-written kernels) or ``dense``; ``auto``
    takes ``pallas`` for a head dim in the kernels' ``_HEAD_DIMS`` and
    ``dense`` elsewhere, as the reference gates on the head dim.  The
    dtypes and the page size are not part of the gate: what the kernels
    cannot take raises in them.  A Python decision on shapes, so a
    captured graph keeps its route."""
    impl = os.environ.get("PT_PAGED_IMPL", "auto").lower()
    if impl not in PAGED_IMPLS:
        raise ValueError(
            f"PT_PAGED_IMPL={impl!r}: expected {'|'.join(PAGED_IMPLS)}")
    if impl != "auto":
        return impl
    return "pallas" if head_dim in _pd._HEAD_DIMS else "dense"


def paged_decode_attention(q, k_pages, v_pages, lengths, page_indices,
                           pages_per_compute_block=4, k_scales=None,
                           v_scales=None):
    """Decode attention over one layer of the page pool, routed by
    :func:`_select_impl` before any call:

    - ``pallas``: ``ops.kernels.paged_decode`` (``paged_decode_quant``
      with scales), which launches the hand-written kernels for CUDA
      tensors (and raises on what they do not take, a dtype pair
      included) and runs their plain versions for CPU tensors; raises
      ``ValueError`` here for a head dim outside the kernels' gate;
    - ``dense``: :func:`dense_paged_attention` /
      :func:`dense_paged_attention_q`.

    No route catches a kernel's error.  q ``[B, H, D]``; k/v_pages
    ``[KV, P, ps, D]``; lengths ``[B]`` and page_indices ``[B, pps]``
    int32; ``k_scales`` / ``v_scales`` ``[KV, P]`` select the int8
    pages.  ``pages_per_compute_block`` is the tiling of jax's own TPU
    kernel, accepted for the reference's signature and unused.  Returns
    ``[B, H, D]`` in q's dtype."""
    D = q.shape[-1]
    quant = k_scales is not None
    if _select_impl(D) == "pallas":
        if D not in _pd._HEAD_DIMS:
            raise ValueError(
                f"PT_PAGED_IMPL=pallas: the paged-decode kernels take "
                f"head_dim in {_pd._HEAD_DIMS}; got head_dim {D}")
        if quant:
            return paged_decode_quant(q, k_pages, v_pages, lengths,
                                      page_indices, k_scales, v_scales)
        return paged_decode(q, k_pages, v_pages, lengths, page_indices)
    if quant:
        return dense_paged_attention_q(q, k_pages, v_pages, lengths,
                                       page_indices, k_scales, v_scales)
    return dense_paged_attention(q, k_pages, v_pages, lengths,
                                 page_indices)


class PagedKVCache:
    """Block-table KV cache: a pre-allocated page pool plus a page-table
    row per sequence slot (slots 0..max_seqs-1).

    ``max_pages_per_seq`` is the per-sequence budget; ``num_pages`` may
    be smaller than ``max_seqs * max_pages_per_seq`` so that a serving
    pool is oversubscribed and admission and preemption have work to
    do.  Every capacity failure raises ``RuntimeError`` containing
    "KV page pool exhausted" and mutates nothing."""

    def __init__(self, n_layers, n_kv_heads, head_dim, num_pages,
                 page_size=16, max_seqs=8, dtype=torch.bfloat16,
                 max_pages_per_seq=None, device=None, quant=None,
                 max_window=8):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = (num_pages // max_seqs
                                  if max_pages_per_seq is None
                                  else int(max_pages_per_seq))
        self.max_seqs = max_seqs
        self.device = resolve_device(device)
        #: what consumers compute in: the pool dtype of a float pool, the
        #: requested dtype when the pool is int8
        self.compute_dtype = dtype
        self.quant = _quant.quant_mode(quant)
        # one page past num_pages is the scratch page: no slot owns it, it
        # is in no free list and no table, and the warm-up a graph capture
        # runs writes there.  The public pools and scales are views of the
        # first num_pages; the kernels and the in-graph writes take the
        # whole storage, so a page id means the same page in both.
        self.scratch_page = num_pages
        shape = (n_layers, n_kv_heads, num_pages + 1, page_size, head_dim)
        if self.quant == "int8":
            # [2, ...]: index 0 is K, 1 is V
            self._kv_pages = torch.zeros((2,) + shape, dtype=torch.int8,
                                         device=self.device)
            self._kv_scales = torch.zeros((2,) + shape[:3],
                                          dtype=torch.float32,
                                          device=self.device)
            self._k_all, self._v_all = self._kv_pages
            self._ks_all, self._vs_all = self._kv_scales
            self.k_scales = self._ks_all[:, :, :num_pages]
            self.v_scales = self._vs_all[:, :, :num_pages]
        else:
            self._k_all = torch.zeros(shape, dtype=dtype, device=self.device)
            self._v_all = torch.zeros(shape, dtype=dtype, device=self.device)
            self.k_scales = self.v_scales = None
        self.k_pages = self._k_all[:, :, :num_pages]
        self.v_pages = self._v_all[:, :, :num_pages]
        self._free = list(range(num_pages - 1, -1, -1))
        self.page_table = np.full((max_seqs, self.max_pages_per_seq),
                                  -1, np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self._active = [False] * max_seqs
        # per-page owner count: slot page-table rows + the prefix tree
        self.page_refs = np.zeros((num_pages,), np.int32)
        self.cow_count = 0         # copy-on-write page copies performed
        # optional callable(shortfall_pages) that tries to free pages (the
        # prefix cache's LRU eviction), asked before any exhausted raise
        self.reclaimer = None
        # fixed-address step buffers, int32: ids, positions and lengths
        # rows, the [max_seqs, pps] page tables, then verify's window ids
        # [max_seqs, max_window] and commit limits [max_seqs]; filled
        # from one (pinned) host staging buffer by one copy a step
        ms, pps = max_seqs, self.max_pages_per_seq
        self.max_window = int(max_window)
        W = self.max_window
        pin = self.device.type == "cuda"
        self._stage = torch.zeros(ms * (4 + pps + W), dtype=torch.int32,
                                  pin_memory=pin)
        self._step = torch.zeros_like(self._stage, device=self.device)
        self.step_ids, self.step_positions, self.step_lengths = \
            self._step[:3 * ms].view(3, ms)
        t = 3 * ms + ms * pps
        self.step_tables = self._step[3 * ms:t].view(ms, pps)
        self.step_window = self._step[t:t + ms * W].view(ms, W)
        self.step_limits = self._step[t + ms * W:]
        self._staged = None        # CUDA event of the last staging copy

    # -- control plane (host) ------------------------------------------

    def allocate(self) -> int:
        """Claim a sequence slot."""
        for s in range(self.max_seqs):
            if not self._active[s]:
                self._active[s] = True
                self.lengths[s] = 0
                return s
        raise RuntimeError("no free sequence slots (continuous batching "
                           "is full) — free() a finished sequence first")

    def free(self, seq: int) -> None:
        """Release every assigned page of a slot (reserved-but-unwritten
        ones too) and the slot itself.  A page returns to the free list
        only when its last owner lets go: a page the prefix tree also
        holds merely drops a reference."""
        for pid in self.page_table[seq]:
            if pid >= 0:
                self._deref(int(pid))
        self.page_table[seq] = -1
        self.lengths[seq] = 0
        self._active[seq] = False

    # -- refcounted page pool --------------------------------------------

    def _pop_page(self) -> int:
        pid = self._free.pop()
        self.page_refs[pid] = 1
        return pid

    def _deref(self, pid: int) -> None:
        self.page_refs[pid] -= 1
        if self.page_refs[pid] == 0:
            self._free.append(pid)
        elif self.page_refs[pid] < 0:
            raise AssertionError(
                f"page {pid} refcount went negative (double free)")

    def _reclaim(self, shortfall: int) -> None:
        """Ask the attached prefix cache, if any, to evict enough cold
        pages to cover ``shortfall``."""
        if self.reclaimer is not None and shortfall > 0:
            self.reclaimer(shortfall)

    def attach(self, seq: int, page_ids, n_tokens: int) -> None:
        """Attach already-written pages BY REFERENCE (a prefix-cache
        hit): the slot's first ``len(page_ids)`` table entries point at
        the shared pages and its length starts at ``n_tokens``.  The last
        page may be covered in part; the first write to it copies it."""
        n_pages = len(page_ids)
        if n_tokens > n_pages * self.page_size:
            raise ValueError(
                f"attach: {n_tokens} tokens exceed {n_pages} pages "
                f"x {self.page_size}")
        if n_pages > self.max_pages_per_seq:
            raise RuntimeError(
                f"sequence {seq} needs {n_pages} pages > per-seq "
                f"budget {self.max_pages_per_seq}")
        for i, pid in enumerate(page_ids):
            if self.page_table[seq, i] >= 0:
                raise AssertionError(
                    f"attach over an assigned slot {i} of seq {seq}")
            self.page_table[seq, i] = int(pid)
            self.page_refs[int(pid)] += 1
        self.lengths[seq] = int(n_tokens)

    def make_writable(self, seq: int, start: int, end: int) -> None:
        """Copy-on-write guard: every page-table slot overlapping token
        positions [start, end) must be owned by this slot alone before an
        in-place write; a shared page is copied into a fresh one."""
        if end <= start:
            return
        ps = self.page_size
        for slot in range(start // ps, -(-end // ps)):
            pid = int(self.page_table[seq, slot])
            if pid >= 0 and self.page_refs[pid] > 1:
                self._cow(seq, slot)

    def _cow(self, seq: int, slot: int) -> None:
        _faults.fire("prefix.cow", "before")
        if not self._free:
            self._reclaim(1)
        if not self._free:
            raise RuntimeError(f"{_POOL_EXHAUSTED} (copy-on-write of a "
                               f"shared prefix page)")
        old = int(self.page_table[seq, slot])
        new = self._pop_page()
        # one indexed copy across all layers and kv heads (K and V are
        # the two halves of one int8 tensor); an int8 page is meaningless
        # without its scale, so the scales are copied with it
        if self.k_scales is not None:
            self._kv_pages[:, :, :, new] = self._kv_pages[:, :, :, old]
            self._kv_scales[:, :, :, new] = self._kv_scales[:, :, :, old]
        else:
            self._k_all[:, :, new] = self._k_all[:, :, old]
            self._v_all[:, :, new] = self._v_all[:, :, old]
        self.page_table[seq, slot] = new
        self.page_refs[old] -= 1
        self.cow_count += 1
        _faults.fire("prefix.cow", "after")

    def trim(self, seq: int) -> int:
        """Release every assigned page-table slot past the page cover of
        the sequence's current length (the rollback of a speculative
        window whose tail was rejected).  Returns the slots released."""
        keep = -(-int(self.lengths[seq]) // self.page_size)
        freed = 0
        for slot in range(keep, self.max_pages_per_seq):
            pid = int(self.page_table[seq, slot])
            if pid >= 0:
                self._deref(pid)
                self.page_table[seq, slot] = -1
                freed += 1
        return freed

    def _plan_missing(self, seq: int, new_len: int):
        """The page-table slots that still need a page for ``seq`` to
        hold ``new_len`` tokens (idempotent across retries)."""
        need = -(-new_len // self.page_size)
        if need > self.max_pages_per_seq:
            raise RuntimeError(
                f"sequence {seq} needs {need} pages > per-seq budget "
                f"{self.max_pages_per_seq}")
        return [i for i in range(need) if self.page_table[seq, i] < 0]

    def _ensure_capacity(self, seq: int, new_len: int) -> None:
        missing = self._plan_missing(seq, new_len)
        if len(missing) > len(self._free):
            self._reclaim(len(missing) - len(self._free))
        if len(missing) > len(self._free):
            raise RuntimeError(_POOL_EXHAUSTED)
        for i in missing:
            self.page_table[seq, i] = self._pop_page()

    def reserve(self, seqs, extra_tokens=1) -> None:
        """Batch-atomic reservation: plan every sequence's missing pages
        first and commit only if the whole batch fits.  ``extra_tokens``
        is one int or a per-sequence list aligned with ``seqs``."""
        seqs = list(seqs)
        extras = (list(extra_tokens)
                  if isinstance(extra_tokens, (list, tuple, np.ndarray))
                  else [extra_tokens] * len(seqs))
        plans = [(s, self._plan_missing(s, int(self.lengths[s]) + int(e)))
                 for s, e in zip(seqs, extras)]
        need = sum(len(m) for _, m in plans)
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        if need > len(self._free):
            raise RuntimeError(_POOL_EXHAUSTED)
        for s, missing in plans:
            for i in missing:
                self.page_table[s, i] = self._pop_page()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def free_slots(self) -> int:
        return self._active.count(False)

    # -- data plane (device, in place) ---------------------------------

    def write_at(self, seq: int, k, v, start: int) -> None:
        """Write k/v [L, KV, T, D] at positions ``start..start+T-1``,
        allocating pages as needed and copying any shared page in the
        span first; the length becomes ``start + T``."""
        T = int(k.shape[2])
        self._ensure_capacity(seq, start + T)
        self.make_writable(seq, start, start + T)
        ps = self.page_size
        if self.k_scales is not None:
            row = self.page_table[seq]
            pos = np.arange(start, start + T)
            pids = row[pos // ps]
            _faults.fire("quant.kv_write", "before")
            _quant.kv_write(self._kv_pages, self._kv_scales,
                            torch.as_tensor(pids, device=self.device),
                            torch.as_tensor(pos % ps, device=self.device),
                            torch.stack([k, v]),
                            torch.as_tensor(np.unique(pids),
                                            device=self.device))
            _faults.fire("quant.kv_write", "after")
            self.lengths[seq] = start + T
            return
        k = k.to(self.k_pages.dtype)
        v = v.to(self.v_pages.dtype)
        t = 0
        while t < T:
            pos = start + t
            page, off = pos // ps, pos % ps
            n = min(ps - off, T - t)           # span within this page
            pid = int(self.page_table[seq, page])
            self.k_pages[:, :, pid, off:off + n] = k[:, :, t:t + n]
            self.v_pages[:, :, pid, off:off + n] = v[:, :, t:t + n]
            t += n
        self.lengths[seq] = start + T

    def token_slots(self, page_indices, positions):
        """(page ids, in-page offsets), each int64 [B], of token
        ``positions[b]`` of the sequence whose table row is
        ``page_indices[b]`` (as returned by ``tables``)."""
        rows = torch.arange(positions.shape[0], device=positions.device)
        pids = page_indices[rows, positions // self.page_size].long()
        return pids, (positions % self.page_size).long()

    def write_token(self, layer: int, pids, offs, k, v) -> None:
        """Store one token per row of k/v [B, KV, D] into layer
        ``layer`` at the slots ``token_slots`` gave.  Lengths are the
        caller's to advance."""
        if self.k_scales is not None:
            _quant.kv_write(self._kv_pages[:, layer],
                            self._kv_scales[:, layer], pids, offs,
                            torch.stack([k, v]).transpose(1, 2))
            return
        kp, vp = self._k_all[layer], self._v_all[layer]
        kp[:, pids, offs] = k.transpose(0, 1).to(kp.dtype)
        vp[:, pids, offs] = v.transpose(0, 1).to(vp.dtype)

    def append(self, seqs, k, v) -> None:
        """Decode-step write of one token per listed sequence: k/v
        [L, KV, B, D].  Reserves for the whole batch first, so a
        capacity failure mutates nothing."""
        seqs = list(seqs)
        self.reserve(seqs, extra_tokens=1)
        for s in seqs:
            pos = int(self.lengths[s])
            self.make_writable(s, pos, pos + 1)
        table, lens = self.tables(seqs)
        pids, offs = self.token_slots(table, lens.long())
        quant = self.k_scales is not None
        if quant:
            _faults.fire("quant.kv_write", "before")
        for layer in range(self.k_pages.shape[0]):
            self.write_token(layer, pids, offs, k[layer].transpose(0, 1),
                             v[layer].transpose(0, 1))
        if quant:
            _faults.fire("quant.kv_write", "after")
        for s in seqs:
            self.lengths[s] += 1

    def gather_dense(self, seq: int, length=None):
        """A sequence's pages gathered into dense [L, KV, n * ps, D]
        copies (n = page cover of ``length``, default the current
        length).  Positions >= length are garbage for the consumer to
        mask.  Refuses an unset page slot inside the length rather than
        read another sequence's page."""
        L = int(self.lengths[seq]) if length is None else int(length)
        n = -(-L // self.page_size)
        row = self.page_table[seq, :n]
        if (row < 0).any():
            bad = int(np.argmax(row < 0))
            raise RuntimeError(
                f"gather_dense: sequence {seq} page slot {bad} is "
                f"unset inside the requested length {L} "
                f"({n} pages) — refusing to read garbage from page 0")
        pids = torch.as_tensor(row, device=self.device).long()
        k = self.k_pages[:, :, pids]           # [L, KV, n, ps, D]
        v = self.v_pages[:, :, pids]
        if self.k_scales is not None:
            _faults.fire("quant.dequant", "before")
            k = _quant.kv_dequant(k, self.k_scales[:, :, pids],
                                  self.compute_dtype)
            v = _quant.kv_dequant(v, self.v_scales[:, :, pids],
                                  self.compute_dtype)
            _faults.fire("quant.dequant", "after")
        sh = (k.shape[0], k.shape[1], n * self.page_size, k.shape[4])
        return k.reshape(sh), v.reshape(sh)

    def stage(self, seqs, ids=None):
        """Fill the step buffers for the listed slots, in order: row b
        gets ``ids[b]`` (0 when not given), the slot's length as both its
        position and its length, and its page-table row with unset (-1)
        entries clipped to page 0, which the kernel never reads.  One
        host-to-device copy of the staging buffer (non-blocking from
        pinned memory on CUDA).  Returns the device views
        (ids, positions, lengths [B], tables [B, pps]), all int32; the
        next ``stage`` overwrites them."""
        seqs = list(seqs)
        B = len(seqs)
        host = self._host_stage(seqs)
        host[0][0, :B] = 0 if ids is None else np.asarray(ids, np.int32)
        self._restage()
        return (self.step_ids[:B], self.step_positions[:B],
                self.step_lengths[:B], self.step_tables[:B])

    def stage_verify(self, seqs, window, limits):
        """:meth:`stage` for a verify step: besides the lengths and the
        tables, row b of the window buffer gets ``window[b]`` (the last
        token then the draft, zero-padded; at most ``max_window`` wide)
        and the limits buffer ``limits[b]``.  One copy, as ``stage``."""
        seqs = list(seqs)
        B = len(seqs)
        window = np.asarray(window, np.int32).reshape(B, -1)
        if window.shape[1] > self.max_window:
            raise ValueError(f"verify window {window.shape[1]} > the step "
                             f"buffers' max_window {self.max_window}")
        rows, win, lim = self._host_stage(seqs)
        win[:B] = 0
        win[:B, :window.shape[1]] = window
        lim[:B] = np.asarray(limits, np.int32)
        self._restage()

    def _host_stage(self, seqs):
        """Wait until the last staging copy has read the pinned buffer,
        then write the lengths and page tables of ``seqs`` into it;
        returns its (id/position/length rows, window, limits) views."""
        B, ms, W = len(seqs), self.max_seqs, self.max_window
        if self._staged is not None:   # the last copy has read the buffer
            self._staged.synchronize()
        host = self._stage.numpy()
        rows = host[:3 * ms].reshape(3, ms)
        rows[1, :B] = rows[2, :B] = self.lengths[seqs]
        t = 3 * ms + ms * self.max_pages_per_seq
        host[3 * ms:t].reshape(ms, -1)[:B] = np.maximum(
            self.page_table[seqs], 0)
        return (rows, host[t:t + ms * W].reshape(ms, W),
                host[t + ms * W:])

    def _restage(self):
        self._step.copy_(self._stage, non_blocking=True)
        if self.device.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record()

    @contextlib.contextmanager
    def scratch_step(self):
        """Point every step buffer at the scratch page (ids, positions,
        lengths, window and limits 0, every table entry the scratch page)
        for a warm-up or a capture, so a forward run under it writes K/V
        into no live page; put the staged values back on exit."""
        self._step.zero_()
        self.step_tables.fill_(self.scratch_page)
        try:
            yield
        finally:
            self._restage()

    def tables(self, seqs):
        """(page_indices [B, pps] int32, lengths [B] int32) on the
        cache's device for the listed slots: :meth:`stage`'s views, so
        valid until the next stage."""
        _, _, lens, table = self.stage(seqs)
        return table, lens

    def attend(self, layer: int, q, seqs):
        """Decode attention for one layer: q [B, H, D] over the listed
        sequences' pages, at their current lengths."""
        return self.attend_tables(layer, q, *self.tables(seqs))

    def attend_tables(self, layer: int, q, page_indices, lengths):
        """Decode attention for one layer over explicit ``tables``-style
        page_indices [B, pps] and lengths [B] (int32, on the cache's
        device)."""
        quant = self.k_scales is not None
        return paged_decode_attention(
            q, self._k_all[layer], self._v_all[layer], lengths,
            page_indices,
            k_scales=self._ks_all[layer] if quant else None,
            v_scales=self._vs_all[layer] if quant else None)
