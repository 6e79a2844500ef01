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

Decode attention goes through ``ops.kernels.paged_decode`` — the CUDA
kernel for tensors on the card, its plain version for tensors on the
CPU.

Not ported yet (later slices): page refcounts and copy-on-write for the
prefix cache, ``trim`` for speculative decode, the int8 pool, and the
sequence-parallel writes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kernels.paged_decode import paged_decode

_POOL_EXHAUSTED = "KV page pool exhausted"


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
                 max_pages_per_seq=None, device=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = (num_pages // max_seqs
                                  if max_pages_per_seq is None
                                  else int(max_pages_per_seq))
        self.max_seqs = max_seqs
        self.device = resolve_device(device)
        shape = (n_layers, n_kv_heads, num_pages, page_size, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(num_pages - 1, -1, -1))
        self.page_table = np.full((max_seqs, self.max_pages_per_seq),
                                  -1, np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self._active = [False] * max_seqs

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
        ones too) and the slot itself."""
        for pid in self.page_table[seq]:
            if pid >= 0:
                self._free.append(int(pid))
        self.page_table[seq] = -1
        self.lengths[seq] = 0
        self._active[seq] = False

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
            raise RuntimeError(_POOL_EXHAUSTED)
        for i in missing:
            self.page_table[seq, i] = self._free.pop()

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
        if sum(len(m) for _, m in plans) > len(self._free):
            raise RuntimeError(_POOL_EXHAUSTED)
        for s, missing in plans:
            for i in missing:
                self.page_table[s, i] = self._free.pop()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def free_slots(self) -> int:
        return self._active.count(False)

    # -- data plane (device, in place) ---------------------------------

    def write_at(self, seq: int, k, v, start: int) -> None:
        """Write k/v [L, KV, T, D] at positions ``start..start+T-1``,
        allocating pages as needed; the length becomes ``start + T``."""
        T = int(k.shape[2])
        self._ensure_capacity(seq, start + T)
        k = k.to(self.k_pages.dtype)
        v = v.to(self.v_pages.dtype)
        ps = self.page_size
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
        kp, vp = self.k_pages[layer], self.v_pages[layer]
        kp[:, pids, offs] = k.transpose(0, 1).to(kp.dtype)
        vp[:, pids, offs] = v.transpose(0, 1).to(vp.dtype)

    def append(self, seqs, k, v) -> None:
        """Decode-step write of one token per listed sequence: k/v
        [L, KV, B, D].  Reserves for the whole batch first, so a
        capacity failure mutates nothing."""
        seqs = list(seqs)
        self.reserve(seqs, extra_tokens=1)
        table, lens = self.tables(seqs)
        pids, offs = self.token_slots(table, lens.long())
        for layer in range(self.k_pages.shape[0]):
            self.write_token(layer, pids, offs, k[layer].transpose(0, 1),
                             v[layer].transpose(0, 1))
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
        sh = (k.shape[0], k.shape[1], n * self.page_size, k.shape[4])
        return k.reshape(sh), v.reshape(sh)

    def tables(self, seqs):
        """(page_indices [B, pps] int32, lengths [B] int32) on the
        cache's device for the listed slots; unset (-1) entries past a
        length are clipped to page 0, which the kernel never reads."""
        table = torch.from_numpy(np.maximum(self.page_table[seqs], 0))
        lens = torch.from_numpy(self.lengths[seqs].copy())
        return table.to(self.device), lens.to(self.device)

    def attend(self, layer: int, q, seqs):
        """Decode attention for one layer: q [B, H, D] over the listed
        sequences' pages, at their current lengths."""
        return self.attend_tables(layer, q, *self.tables(seqs))

    def attend_tables(self, layer: int, q, page_indices, lengths):
        """Decode attention for one layer over explicit ``tables``-style
        page_indices [B, pps] and lengths [B] (int32, on the cache's
        device)."""
        return paged_decode(q, self.k_pages[layer], self.v_pages[layer],
                            lengths, page_indices)
