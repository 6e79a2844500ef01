"""PagedExecutor — the model-execution backend of the serving stack.

Counterpart of ``paddle_tpu/inference/server/executor.py``: it owns the
stacked Llama parameters and the :class:`PagedKVCache`, and exposes the
slot-granular operations the scheduler drives:

  * ``prefill(sid, ids)``            whole-prompt prefill
  * ``prefill_chunk(sid, ids, t0)``  chunked prefill: attend the slot's
                                     written pages, write the chunk's KV
  * ``decode(sids)``                 one greedy token per listed slot
  * ``decode_n(sids, n)``            n greedy tokens per listed slot, the
                                     argmax fed back on the device
  * ``verify(sids, drafts, limits, k)`` one speculative window per slot:
                                     the longest draft prefix the model
                                     agrees with plus its next token
  * ``rollback(sids)``               release the pages a rejected window
                                     had reserved
  * ``decode_async`` / ``verify_async`` the same steps, returning a
                                     pending result whose ``wait()`` is
                                     the step's only host sync
  * ``attach_prefix(sid, pages, n)`` point a fresh slot at cached pages

The forwards are eager PyTorch and mirror the JAX programs op for op,
dtype rules included: RMSNorm in fp32 cast back, RoPE promoting a bf16
stream to fp32 for q and k, prefill softmax in fp32 cast back to the
activation dtype, masked with ``finfo(dtype).min``.  Weight products and
prefill attention are ``torch.matmul`` (the JAX package leaves them to
XLA); decode writes and attention go through ``PagedKVCache``
(``write_token``, ``attend_tables``) and so through
``paged_decode_attention``'s route: the paged-decode kernel (its plain
version for CPU tensors) where its gate passes, the dense route
elsewhere (a head dim outside 64, 128 and 256).

The program plane (``core/aot.py``).  Where every serving program of the
reference is one jitted XLA program, ``serve.decode``,
``serve.decode_n`` and ``serve.verify`` here are :class:`CountedGraph` s:
the eager forward over the cache's fixed-address step buffers, captured
as a CUDA graph once per batch size B (and per n, or per window W), then
replayed, so a decode step costs the host one staging copy, one replay
and one [B] token copy.  ``serve.verify`` runs every sequence's window
``[last token, draft...]`` in one forward with B*W query rows through
the same paged decode attention (each table row repeated W times, row
(b, w) masked to ``lengths[b] + w + 1``), takes the greedy acceptance
and packs the accepted tokens in the program, with shapes fixed by the
rung (no host read, no data-dependent shape).  The async twins replay
the same graphs, then copy the result into one of two pinned host slots
without blocking and record an event that ``wait()`` waits on.  Capture
is lazy (the first step at a new B), or done up front by
``aot_warmup``; ``seal`` then forbids new captures.  On the CPU the same
calls run the forward eagerly over the same buffers.  Prefill stays
eager: under an armed ladder its past cover is padded onto the page
buckets as in the reference.

``quant="int8"`` (``None`` follows ``PT_QUANT``) quantizes the seven
per-layer projections to per-channel int8 at construction, dropping the
dense copies, and makes the KV pool int8: every projection then runs
through ``ops.quant.qmatmul`` (the int8-weight matmul kernel) and every
decode attention through ``paged_decode_quant``.  The embedding, the
norms, the RoPE tables and the LM head stay in the checkpoint dtype.

Every in-program page write is preceded by the copy-on-write guard
(``make_writable``) over the positions it writes, so a page shared with
the prefix cache is never written in place.

Not ported yet (later slices): the sequence-parallel prefill.  Not
ported: the reference's on-disk executable cache (a CUDA graph cannot be
serialized).
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...core import aot
from ...device import resolve_device
from ...models.llama import params_to, rope_tables
from ...ops import quant as _quant
from ...ops.kernels import paged_decode as _pd
from ...ops.kernels import quant_matmul as _qm
from ...ops.nn_ops import rms_norm, rope
from ..paged import (
    PagedKVCache, dense_paged_attention, dense_paged_attention_q,
)

#: the stacked decoder weights quantized under ``quant="int8"``
_QUANT_LAYER_WEIGHTS = (
    "self_attn.q_proj.weight", "self_attn.k_proj.weight",
    "self_attn.v_proj.weight", "self_attn.o_proj.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight",
    "mlp.down_proj.weight",
)


def _mm(x, w):
    """Weight matmul that dispatches on the weight's form: a plain
    tensor is ``x @ w``, a ``{"qweight", "scale"}`` dict goes through
    the int8-weight matmul."""
    if _quant.is_quantized(w):
        return _quant.qmatmul(x, w)
    return x @ w


def _quantize_stacked(w):
    """``quantize_linear`` of a stacked ``[L, in, out]`` weight, one layer
    at a time, so the f32 temporaries are one layer's (bit-identical to
    quantizing the stack: the scale is per layer and output channel)."""
    parts = [_quant.quantize_linear(w[i]) for i in range(w.shape[0])]
    return {name: torch.stack([p[name] for p in parts])
            for name in ("qweight", "scale")}


class _PendingDecode:
    """The unread result of one async decode dispatch: the token row is
    on its way to a pinned host slot.  ``wait()`` is the commit fence: it
    waits for that copy alone, then does the last-token bookkeeping the
    sync path does inline.  Idempotent."""

    __slots__ = ("_ex", "sids", "_host", "_event", "_toks", "_out")

    def __init__(self, ex, sids, host, event):
        self._ex = ex
        self.sids = sids
        self._host = host
        self._event = event
        self._toks = None
        self._out = None

    def _fetch(self):
        """Read the pinned slot once (before it can be reused)."""
        if self._toks is None:
            if self._event is not None:
                self._event.synchronize()
            self._toks = self._host.numpy().copy()
            self._host = self._event = None
        return self._toks

    def wait(self) -> dict:
        if self._out is None:
            toks = self._fetch()
            out = {}
            for i, s in enumerate(self.sids):
                tok = int(toks[i])
                self._ex.last_token[s] = tok
                out[s] = tok
            self._out = out
        return self._out


class _PendingVerify(_PendingDecode):
    """The unread result of one async verify dispatch: the packed token
    block [B*W] and the per-sequence counts [B] in one pinned row.
    ``wait()`` also applies the length and last-token bookkeeping of the
    sync :meth:`PagedExecutor.verify`; it returns (tokens by slot,
    accepted drafts by slot)."""

    __slots__ = ()

    def wait(self):
        if self._out is None:
            vals = self._fetch()
            self._out = self._ex._commit_verify(self.sids, vals)
        return self._out


class PagedExecutor:
    """Execution backend over the paged KV cache.

    ``params`` is the port's parameter dict (``models/llama.py``); it is
    moved to ``device`` if it lies elsewhere.  ``dtype`` is the KV pool
    dtype (the compute dtype of an int8 pool).  ``num_pages=None`` sizes
    the pool so every slot can reach ``max_len``; a smaller pool
    oversubscribes it.  ``quant`` is ``"none"``, ``"int8"`` or ``None``
    (follow ``PT_QUANT``), validated here.  ``spec_window`` is the widest
    verify window W = k + 1 the step buffers must hold (at least 8)."""

    def __init__(self, config, params, max_seqs=4, page_size=16,
                 max_len=256, dtype=torch.float32, num_pages=None,
                 device=None, quant=None, spec_window=None):
        self.device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.max_len = int(max_len)
        self.quant = _quant.quant_mode(quant)
        params = params_to(params, device=self.device)
        self.layers = dict(params["layers"])
        if self.quant == "int8":
            for name in _QUANT_LAYER_WEIGHTS:
                self.layers[name] = _quantize_stacked(self.layers.pop(name))
        cos, sin = rope_tables(cfg, device=self.device)
        self._tied = bool(cfg.tie_word_embeddings)
        self.tops = {
            "embed": params["embed"],
            "norm_w": params["norm"],
            "head_w": (params["embed"] if self._tied
                       else params["lm_head"]),
            "cos": cos,
            "sin": sin,
        }
        pages_per_seq = -(-max_len // page_size)
        self.cache = PagedKVCache(
            n_layers=cfg.num_hidden_layers,
            n_kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
            num_pages=(max_seqs * pages_per_seq if num_pages is None
                       else int(num_pages)),
            page_size=page_size, max_seqs=max_seqs, dtype=dtype,
            max_pages_per_seq=pages_per_seq, device=self.device,
            quant=self.quant, max_window=max(8, int(spec_window or 0)))
        # per-layer views of the stacked weights, sliced once
        self._layers = [
            {n: ({k: t[i] for k, t in w.items()} if isinstance(w, dict)
                 else w[i]) for n, w in self.layers.items()}
            for i in range(cfg.num_hidden_layers)]
        self.last_token = {}
        #: (sid, n_tokens) per prefill forward
        self.prefill_events = []
        # the decode programs: captured per rung, sharing one graph pool
        # (they never run at once); the launch tallies they replay are
        # the serving kernels' counters
        graph = functools.partial(
            aot.CountedGraph, device=self.device,
            scratch=self.cache.scratch_step,
            counters=(_pd.paged_decode, _pd.paged_decode_quant,
                      _qm.quant_matmul, dense_paged_attention,
                      dense_paged_attention_q),
            pool=(torch.cuda.graph_pool_handle()
                  if self.device.type == "cuda" else None))
        self._graph_decode = graph(self._decode_tok_step,
                                   name="serve.decode")
        self._graph_decode_n = graph(self._decode_n_step,
                                     name="serve.decode_n")
        self._graph_verify = graph(self._verify_step, name="serve.verify")
        # True runs the decode and verify forwards eagerly, never
        # captured: the A/B baseline of chip_smoke.py
        self._eager_decode = False
        # the async twins' result rows: two pinned host slots, so a
        # step's tokens are never overwritten by the next step's copy
        # before its wait() has read them
        ms, W = max_seqs, self.cache.max_window
        self._host_out = torch.zeros(
            (2, ms * W + ms), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self._slot_pending = [None, None]
        self._next_slot = 0
        self.async_dispatches = 0
        self.rollback_pages = 0
        # AOT plane state: a non-None ladder makes the scheduler floor
        # prefill chunks onto its rungs and prefill_chunk pad the past
        # cover onto page buckets; None (PT_AOT=off) changes nothing
        self.aot_ladder = None
        self._aot_page_buckets = None
        self._aot_sealed = False
        self._aot_config = None

    @property
    def programs(self) -> dict:
        """The captured programs, by name suffix."""
        return {"decode": self._graph_decode,
                "decode_n": self._graph_decode_n,
                "verify": self._graph_verify}

    @property
    def verify_traces(self) -> int:
        """Captures of ``serve.verify`` (one per (B, W) rung)."""
        return self._graph_verify.traces

    @property
    def verify_dispatches(self) -> int:
        """Calls of ``serve.verify``: one per verify step."""
        return self._graph_verify.dispatches

    @torch.no_grad()
    def aot_warmup(self, prefill_chunk=None, spec_window=None,
                   decode_n_steps=(), ladder=None):
        """Capture every (program x shape rung) the executor can
        dispatch, so a warmed engine serves with no capture after warmup:
        ``serve.decode`` at every batch 1..max_seqs, ``serve.decode_n``
        at every (batch, n) for n in ``decode_n_steps`` and, when
        ``spec_window`` gives the verify window W = k + 1,
        ``serve.verify`` at every (batch, W).  Then
        :meth:`arm_ladder` arms the prefill chunk ladder and the
        past-cover page buckets; prefill chunks stay eager, so they have
        no entries.

        Each entry resolves ``warm`` (already captured) or ``capture``; an
        entry that fails is recorded in ``failed`` and skipped, so warmup
        never takes the engine down (the rung then captures at its first
        call, or raises there).  Returns the report."""
        kvc = self.cache
        if spec_window and int(spec_window) > kvc.max_window:
            raise ValueError(f"spec_window {spec_window} > the step "
                             f"buffers' max_window {kvc.max_window}")
        plan = []
        for B in range(1, kvc.max_seqs + 1):
            plan.append((self._graph_decode, (B,)))
            for n in decode_n_steps:
                plan.append((self._graph_decode_n, (B, int(n))))
            if spec_window:
                plan.append((self._graph_verify, (B, int(spec_window))))
        t0 = time.perf_counter()
        report = {"capture": 0, "warm": 0, "failed": [], "programs": {}}
        for prog, rung in plan:
            try:
                how = prog.aot_capture(rung)
            except Exception as e:  # a failed entry must not kill warmup
                report["failed"].append(
                    (prog.name, rung, f"{type(e).__name__}: {e}"))
                continue
            report[how] += 1
            report["programs"][prog.name] = \
                report["programs"].get(prog.name, 0) + 1
        report["entries"] = len(plan)
        report["seconds"] = round(time.perf_counter() - t0, 3)
        ladder = self.arm_ladder(prefill_chunk, ladder)
        report["ladder"] = ladder.rungs
        report["page_buckets"] = self._aot_page_buckets
        self._aot_config = dict(prefill_chunk=prefill_chunk,
                                spec_window=spec_window,
                                decode_n_steps=tuple(decode_n_steps),
                                ladder=ladder)
        return report

    def arm_ladder(self, prefill_chunk=None, ladder=None):
        """Arm the prefill chunk ladder (``ladder``, default the powers
        of two up to ``prefill_chunk`` or ``max_len``) and the past-cover
        page buckets, as :meth:`aot_warmup` does, without capturing a
        program.  Returns the ladder."""
        if ladder is None:
            cap = (min(int(prefill_chunk), self.max_len)
                   if prefill_chunk else self.max_len)
            ladder = aot.BucketLadder.pow2(cap)
        self.aot_ladder = ladder
        self._aot_page_buckets = aot.page_buckets(
            self.cache.max_pages_per_seq)
        return ladder

    def _aot_rewarm(self):
        """Re-run the last warmup configuration (every entry then
        resolves ``warm``); None until the executor has warmed once."""
        if self._aot_config is None:
            return None
        return self.aot_warmup(**self._aot_config)

    def seal(self):
        """PT_AOT=strict: forbid captures after warmup.  Every warmed
        program is sealed (a call at a rung with no graph raises
        :class:`~paddle_tpu_torch.core.aot.AotMissError`), and
        whole-prompt ``prefill``, routed through chunks by the scheduler,
        refuses direct calls too."""
        if self.aot_ladder is None:
            raise ValueError("seal() before aot_warmup()")
        for prog in self.programs.values():
            if prog._exe:
                prog.seal()
        self._aot_sealed = True

    def _layer(self, i):
        return self._layers[i]

    def _head(self, x):
        w = self.tops["head_w"]
        return x @ (w.T if self._tied else w)

    # -- forwards --------------------------------------------------------

    def _mlp(self, x, lp):
        eps = self.config.rms_norm_eps
        h2 = rms_norm(x, lp["post_attention_layernorm.weight"], eps)
        gate = _mm(h2, lp["mlp.gate_proj.weight"])
        up = _mm(h2, lp["mlp.up_proj.weight"])
        return x + _mm(F.silu(gate) * up, lp["mlp.down_proj.weight"])

    def _qkv(self, x, lp, pos):
        """Projections + RoPE: q [B, S, nh, d], k/v [B, S, nkv, d]."""
        cfg = self.config
        nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, S = x.shape[:2]
        h = rms_norm(x, lp["input_layernorm.weight"], cfg.rms_norm_eps)
        q = _mm(h, lp["self_attn.q_proj.weight"]).reshape(B, S, nh, d)
        k = _mm(h, lp["self_attn.k_proj.weight"]).reshape(B, S, nkv, d)
        v = _mm(h, lp["self_attn.v_proj.weight"]).reshape(B, S, nkv, d)
        q, k = rope(q, k, self.tops["cos"], self.tops["sin"], pos)
        return q, k, v

    def _attend_dense(self, x, q, kf, vf, mask, lp):
        """Masked attention of q [B, S, nh, d] over kf/vf [B, nkv, T, d]
        (GQA heads expanded here), then the output projection and the
        residual."""
        cfg = self.config
        g = cfg.num_attention_heads // cfg.num_key_value_heads
        B, S = q.shape[:2]
        if g > 1:
            kf = kf.repeat_interleave(g, dim=1)
            vf = vf.repeat_interleave(g, dim=1)
        qt = q.transpose(1, 2)                            # [B, nh, S, d]
        logits = (qt @ kf.transpose(-1, -2)) * (1.0 / np.sqrt(cfg.head_dim))
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        p = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = (p @ vf).transpose(1, 2).reshape(B, S, -1)
        return x + _mm(o, lp["self_attn.o_proj.weight"])

    def _prefill_fwd(self, ids):
        """[1, S] prompt -> (last-token logits [V], k [L, KV, S, D],
        v [L, KV, S, D]) with plain causal attention."""
        B, S = ids.shape
        x = self.tops["embed"][ids]
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        causal = torch.ones((S, S), dtype=torch.bool,
                            device=self.device).tril()
        ks, vs = [], []
        for i in range(self.config.num_hidden_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(x, lp, pos)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            x = self._attend_dense(x, q, kt, vt, causal, lp)
            x = self._mlp(x, lp)
            ks.append(kt[0])
            vs.append(vt[0])
        x = rms_norm(x, self.tops["norm_w"], self.config.rms_norm_eps)
        return self._head(x[:, -1])[0], torch.stack(ks), torch.stack(vs)

    def _chunk_fwd(self, ids, pos0, past_k, past_v, past_len):
        """Chunked-prefill forward: ids [1, C] at positions
        ``pos0..pos0+C-1``; past_k/past_v [L, KV, P, D] are the slot's
        written KV gathered dense (positions >= past_len masked).
        Returns (last-position logits [V], chunk k/v [L, KV, C, D])."""
        B, C = ids.shape
        P = past_k.shape[2]
        x = self.tops["embed"][ids]
        pos = pos0 + torch.arange(C, device=self.device)[None].expand(B, C)
        mask = torch.cat(
            [(torch.arange(P, device=self.device) < past_len)[None]
             .expand(C, P),
             torch.ones((C, C), dtype=torch.bool,
                        device=self.device).tril()], dim=1)   # [C, P+C]
        ks, vs = [], []
        for i in range(self.config.num_hidden_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(x, lp, pos)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            kf = torch.cat([past_k[i][None].to(kt.dtype), kt], dim=2)
            vf = torch.cat([past_v[i][None].to(vt.dtype), vt], dim=2)
            x = self._attend_dense(x, q, kf, vf, mask, lp)
            x = self._mlp(x, lp)
            ks.append(kt[0])
            vs.append(vt[0])
        x = rms_norm(x, self.tops["norm_w"], self.config.rms_norm_eps)
        return self._head(x[:, -1])[0], torch.stack(ks), torch.stack(vs)

    def _decode_fwd(self, ids, positions, lengths, page_tables):
        """One token per listed slot: ids [B], positions [B] (the token's
        position), lengths [B] int32 (tokens already in the pool),
        page_tables [B, pps] int32.  Reads no value on the host, so it
        can be captured.  Each layer writes the token's K/V
        into its page in place, then attends over ``lengths + 1``.
        Returns logits [B, V]."""
        cfg = self.config
        nh, d = cfg.num_attention_heads, cfg.head_dim
        cache = self.cache
        B = ids.shape[0]
        x = self.tops["embed"][ids][:, None]                  # [B, 1, h]
        pos = positions[:, None]
        pids, offs = cache.token_slots(page_tables, positions)
        for i in range(cfg.num_hidden_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(x, lp, pos)
            cache.write_token(i, pids, offs, k[:, 0], v[:, 0])
            o = cache.attend_tables(i, q[:, 0].contiguous(), page_tables,
                                    lengths + 1)
            o = o.reshape(B, 1, nh * d).to(x.dtype)
            x = x + _mm(o, lp["self_attn.o_proj.weight"])
            x = self._mlp(x, lp)
        x = rms_norm(x, self.tops["norm_w"], cfg.rms_norm_eps)
        return self._head(x[:, 0])

    def _decode_tok_fwd(self, ids, positions, lengths, page_tables):
        """:meth:`_decode_fwd` with the greedy argmax in the program:
        tokens [B] int32."""
        logits = self._decode_fwd(ids, positions, lengths, page_tables)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _decode_n_fwd(self, ids, positions, lengths, page_tables, n):
        """``n`` greedy steps in one program, each step's argmax the next
        one's ids (the tables cover all n tokens).  Returns tokens
        [n, B] int32."""
        toks = []
        for _ in range(n):
            ids = self._decode_tok_fwd(ids, positions, lengths, page_tables)
            toks.append(ids)
            positions, lengths = positions + 1, lengths + 1
        return torch.stack(toks)

    def _verify_logits(self, ids, lengths, page_tables, limits):
        """Speculative-verify forward: ids [B, W] int32 is each
        sequence's last committed token then its zero-padded draft;
        window token w sits at position ``lengths[b] + w``; limits [B]
        caps how many window tokens a sequence may commit.  Each layer
        writes the K/V of every valid window cell (w < limit) into its
        page; the cells past a limit write into the scratch page, never a
        live one.  Then B*W query rows attend through the paged decode
        kernel, each sequence's table row repeated W times and row
        (b, w) masked to ``lengths[b] + w + 1`` keys, which is the causal
        mask inside the window.  Reads no value on the host.  Returns
        logits [B, W, V]."""
        cfg = self.config
        nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        cache = self.cache
        ps = cache.page_size
        B, W = ids.shape
        pps = page_tables.shape[1]
        w = torch.arange(W, dtype=torch.int32, device=ids.device)
        x = self.tops["embed"][ids]                       # [B, W, h]
        pos = lengths[:, None] + w[None]                  # [B, W]
        slot = pos // ps
        pids = torch.gather(page_tables, 1,
                            slot.clamp(max=pps - 1).long())
        valid = (w[None] < limits[:, None]) & (slot < pps)
        pids = torch.where(valid, pids, cache.scratch_page).reshape(-1) \
            .long()
        offs = (pos % ps).reshape(-1).long()
        lens_f = (pos + 1).reshape(-1)
        # a copy: the kernel takes contiguous tables (at B = 1 a reshape
        # of the expanded rows would be a view with a zero stride)
        tables_f = page_tables[:, None].expand(B, W, pps).contiguous() \
            .view(B * W, pps)
        for i in range(cfg.num_hidden_layers):
            lp = self._layer(i)
            q, k, v = self._qkv(x, lp, pos)
            cache.write_token(i, pids, offs,
                              k.reshape(B * W, nkv, d),
                              v.reshape(B * W, nkv, d))
            o = cache.attend_tables(i, q.reshape(B * W, nh, d).contiguous(),
                                    tables_f, lens_f)
            o = o.reshape(B, W, nh * d).to(x.dtype)
            x = x + _mm(o, lp["self_attn.o_proj.weight"])
            x = self._mlp(x, lp)
        x = rms_norm(x, self.tops["norm_w"], cfg.rms_norm_eps)
        return self._head(x)

    def _verify_fwd(self, ids, lengths, page_tables, limits):
        """:meth:`_verify_logits`, then the greedy acceptance and the
        packing in the program.  With t the argmax at each window
        position, draft w + 1 is accepted iff every earlier draft matched
        t, so ``emit_n = min(1 + accepted, limit)`` tokens of t are the
        plain greedy stream.  The accepted cells of all sequences are
        packed in order to the front of one [B*W] vector and the other
        cells after them, also in order (the reference's stable sort on
        a rank key), by a scatter to prefix-sum destinations: shapes fixed
        by (B, W), nothing read on the host.  Returns (packed [B*W],
        emit_n [B]), int32."""
        W = ids.shape[1]
        t = torch.argmax(self._verify_logits(ids, lengths, page_tables,
                                             limits), dim=-1).int()
        m = (ids[:, 1:] == t[:, :-1]).int()
        acc = torch.cumprod(m, dim=1).sum(dim=1)
        emit_n = torch.minimum(acc + 1, limits.long()).int()
        w = torch.arange(W, dtype=torch.int32, device=ids.device)
        keep = (w[None] < emit_n[:, None]).reshape(-1).int()
        dest = torch.where(keep.bool(), torch.cumsum(keep, 0) - 1,
                           keep.sum() + torch.cumsum(1 - keep, 0) - 1)
        flat = t.reshape(-1)
        packed = torch.empty_like(flat).scatter_(0, dest.long(), flat)
        return packed, emit_n

    def _step_inputs(self, B):
        c = self.cache
        return (c.step_ids[:B], c.step_positions[:B], c.step_lengths[:B],
                c.step_tables[:B])

    def _decode_tok_step(self, rung):
        """``serve.decode`` at rung (B,), over the step buffers."""
        return self._decode_tok_fwd(*self._step_inputs(rung[0]))

    def _decode_n_step(self, rung):
        """``serve.decode_n`` at rung (B, n), over the step buffers."""
        B, n = rung
        return self._decode_n_fwd(*self._step_inputs(B), n)

    def _verify_step(self, rung):
        """``serve.verify`` at rung (B, W), over the step buffers:
        packed tokens then the counts, one int32 [B*W + B] row."""
        B, W = rung
        c = self.cache
        packed, emit_n = self._verify_fwd(
            c.step_window[:B, :W], c.step_lengths[:B], c.step_tables[:B],
            c.step_limits[:B])
        return torch.cat([packed, emit_n])

    # -- slot-granular control plane ------------------------------------

    @property
    def free_slots(self) -> int:
        return self.cache.free_slots

    @property
    def free_pages(self) -> int:
        return self.cache.free_pages

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.cache.page_size)

    def alloc_slot(self) -> int:
        return self.cache.allocate()

    def free_slot(self, sid: int) -> None:
        self.cache.free(sid)
        self.last_token.pop(sid, None)

    def attach_prefix(self, sid: int, page_ids, n_tokens: int) -> None:
        """Point a fresh slot's page table at already-computed prefix
        pages (a cache hit): chunked prefill then starts at token
        ``n_tokens`` instead of 0."""
        self.cache.attach(sid, page_ids, n_tokens)

    def prepare_write(self, sid: int, start: int, n_tokens: int) -> None:
        """Allocate the pages a prefill chunk over [start, start + n)
        needs and copy any shared page in it, before any compute (a
        pool-exhausted raise here lets the scheduler preempt cleanly)."""
        self.cache._ensure_capacity(sid, start + n_tokens)
        self.cache.make_writable(sid, start, start + n_tokens)

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64)[None],
                               device=self.device)

    @torch.no_grad()
    def prefill(self, sid: int, prompt_ids) -> int:
        """Whole-prompt prefill into an allocated slot; returns the
        first greedy token."""
        if self._aot_sealed:
            raise aot.AotMissError(
                "[serve.prefill] PT_AOT=strict: whole-prompt prefill has "
                "an unbounded [1, S] shape and cannot be warmed; the "
                "scheduler routes prompts through prefill_chunk's bucket "
                "ladder instead")
        ids = self._ids(prompt_ids)
        self.prefill_events.append((sid, int(ids.shape[1])))
        logits, k, v = self._prefill_fwd(ids)
        self.cache.write_at(sid, k, v, 0)
        tok = int(torch.argmax(logits))
        self.last_token[sid] = tok
        return tok

    @torch.no_grad()
    def prefill_chunk(self, sid: int, chunk_ids, start: int,
                      final: bool) -> int | None:
        """One prefill chunk at position ``start`` attending the slot's
        already-written pages.  When ``final``, records and returns the
        prompt's first greedy token; else returns None."""
        past_k, past_v = self.cache.gather_dense(sid, start)
        if self.aot_ladder is not None:
            # bucket the past cover as the reference does: zero pages up
            # to the next bucket, which the past_len mask drops
            ps = self.cache.page_size
            pages = past_k.shape[2] // ps
            b = aot.bucket_pages(pages, self._aot_page_buckets)
            if b > pages:
                pad = (0, 0, 0, (b - pages) * ps)
                past_k, past_v = F.pad(past_k, pad), F.pad(past_v, pad)
        ids = self._ids(chunk_ids)
        self.prefill_events.append((sid, int(ids.shape[1])))
        logits, k, v = self._chunk_fwd(ids, start, past_k, past_v, start)
        self.cache.write_at(sid, k, v, start)
        if not final:
            return None
        tok = int(torch.argmax(logits))
        self.last_token[sid] = tok
        return tok

    def _run(self, prog, eager, rung):
        """One decode program at ``rung``: replayed (or eager on the
        CPU) through its CountedGraph, or eager when ``_eager_decode``."""
        return eager(rung) if self._eager_decode else prog(rung)

    @torch.no_grad()
    def decode(self, sids) -> dict:
        """One greedy decode step over an explicit batch of slots.
        Returns {sid: next_token}."""
        sids = list(sids)
        if not sids:
            return {}
        toks = self._dispatch_decode(sids).tolist()   # one [B] transfer
        out = {}
        for s, tok in zip(sids, toks):
            self.last_token[s] = tok
            out[s] = tok
        return out

    def _guard(self, sids, extras):
        """Reserve each slot's next ``extras`` tokens (batch-atomic, one
        int or a list aligned with ``sids``) and copy any shared page
        they fall in: the in-program writes never touch a shared page."""
        cache = self.cache
        cache.reserve(sids, extra_tokens=extras)
        if not isinstance(extras, (list, tuple)):
            extras = [extras] * len(sids)
        for s, e in zip(sids, extras):
            pos = int(cache.lengths[s])
            cache.make_writable(s, pos, pos + int(e))

    def _dispatch_decode(self, sids):
        """Page work, staging and the ``serve.decode`` call of one decode
        step; advances the lengths and returns the device token row."""
        cache = self.cache
        self._guard(sids, 1)
        cache.stage(sids, [self.last_token[s] for s in sids])
        toks = self._run(self._graph_decode, self._decode_tok_step,
                         (len(sids),))
        for s in sids:
            cache.lengths[s] += 1
        return toks

    def _pending(self, cls, sids, dev):
        """A ``cls`` pending result of the device row ``dev``: its copy
        into the next pinned host slot starts now (non-blocking on the
        card, an event recorded after it).  A slot still holding an
        unread result is read first."""
        slot = self._next_slot
        self._next_slot ^= 1
        old = self._slot_pending[slot]
        if old is not None:
            old._fetch()
        host = self._host_out[slot, :dev.numel()]
        event = None
        if self.device.type == "cuda":
            host.copy_(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host.copy_(dev)
        pending = self._slot_pending[slot] = cls(self, sids, host, event)
        self.async_dispatches += 1
        return pending

    @torch.no_grad()
    def decode_async(self, sids) -> _PendingDecode:
        """Dispatch one greedy decode step without reading its result.
        The page work and the length bookkeeping happen now, so the
        scheduler can plan the next step against post-step lengths while
        the card runs; the returned object's ``wait()`` is the step's
        only host sync (one [B] copy, the last-token updates)."""
        sids = list(sids)
        if not sids:
            return _PendingDecode(self, [], torch.zeros(0, dtype=torch.int32),
                                  None)
        return self._pending(_PendingDecode, sids,
                             self._dispatch_decode(sids))

    def _dispatch_verify(self, sids, drafts, limits, k):
        """Page work, staging and the ``serve.verify`` call of one verify
        step; returns the device row [B*W + B] (packed tokens, counts)."""
        cache = self.cache
        W = int(k) + 1
        limits = [int(x) for x in limits]
        # batch-atomic per-sequence lookahead, then the COW guard over
        # each window: the same write discipline as decode
        self._guard(sids, limits)
        window = np.zeros((len(sids), W), np.int32)
        for i, (s, dr) in enumerate(zip(sids, drafts)):
            window[i, 0] = self.last_token[s]
            dr = np.asarray(dr, np.int32).reshape(-1)[:k]
            window[i, 1:1 + len(dr)] = dr
        cache.stage_verify(sids, window, limits)
        return self._run(self._graph_verify, self._verify_step,
                         (len(sids), W))

    def _commit_verify(self, sids, vals):
        """Split one verify result row (packed tokens, then counts) into
        per-slot tokens and advance lengths and last tokens.  Returns
        ({sid: tokens}, {sid: accepted drafts})."""
        B = len(sids)
        packed, counts = vals[:-B], vals[-B:]
        out, accepted = {}, {}
        off = 0
        for s, n in zip(sids, counts):
            n = int(n)
            toks = [int(t) for t in packed[off:off + n]]
            off += n
            self.cache.lengths[s] += n
            self.last_token[s] = toks[-1]
            out[s] = toks
            accepted[s] = n - 1
        return out, accepted

    @torch.no_grad()
    def verify(self, sids, drafts, limits, k):
        """Speculative decode step: every listed slot's window (its last
        token, then up to ``k`` drafted tokens) through one
        ``serve.verify`` call; commit the longest draft prefix the model
        agrees with plus the model's own next token.

        ``drafts`` and ``limits`` align with ``sids``; a limit (>= 1) caps
        the tokens a slot may commit (the caller clamps it to the page
        budget, the generation cap and the draft length).  Returns
        ({sid: [tokens...]}, {sid: accepted draft tokens}); each slot
        advances by 1 + accepted, exactly its greedy stream."""
        sids = list(sids)
        if not sids:
            return {}, {}
        vals = self._dispatch_verify(sids, drafts, limits, k)
        return self._commit_verify(sids, np.asarray(vals.tolist()))

    @torch.no_grad()
    def verify_async(self, sids, drafts, limits, k) -> _PendingVerify:
        """:meth:`verify` split at its one sync point: the window is
        verified now (pages reserved, shared pages copied, K/V written in
        the program) and the token copy plus the length bookkeeping move
        into the returned object's ``wait()``."""
        sids = list(sids)
        if not sids:
            return _PendingVerify(self, [], torch.zeros(0, dtype=torch.int32),
                                  None)
        return self._pending(_PendingVerify, sids,
                             self._dispatch_verify(sids, drafts, limits, k))

    def rollback(self, sids) -> int:
        """Release the pages reserved for rejected draft positions: trim
        every listed slot's table back to its committed length.  Returns
        the pages released."""
        freed = sum(self.cache.trim(s) for s in sids)
        self.rollback_pages += freed
        return freed

    @torch.no_grad()
    def decode_n(self, sids, n) -> dict:
        """``n`` greedy tokens per listed slot in one program.  Returns
        {sid: [tok_1..tok_n]}.  Pages for all n tokens are reserved up
        front (batch-atomic), so the in-program page writes can never
        overflow a sequence's table."""
        sids, n = list(sids), int(n)
        if not sids:
            return {}
        if n < 1:
            raise ValueError(f"decode_n: n must be >= 1, got {n}")
        cache = self.cache
        self._guard(sids, n)
        cache.stage(sids, [self.last_token[s] for s in sids])
        toks = self._run(self._graph_decode_n, self._decode_n_step,
                         (len(sids), n)).tolist()    # [n][B]
        out = {}
        for i, s in enumerate(sids):
            cache.lengths[s] += n
            self.last_token[s] = toks[-1][i]
            out[s] = [t[i] for t in toks]
        return out
