"""PagedExecutor — the model-execution backend of the serving stack.

Counterpart of ``paddle_tpu/inference/server/executor.py``: it owns the
stacked Llama parameters and the :class:`PagedKVCache`, and exposes the
slot-granular operations the scheduler drives:

  * ``prefill(sid, ids)``            whole-prompt prefill
  * ``prefill_chunk(sid, ids, t0)``  chunked prefill: attend the slot's
                                     written pages, write the chunk's KV
  * ``decode(sids)``                 one greedy token per listed slot

The forwards are eager PyTorch and mirror the JAX programs op for op,
dtype rules included: RMSNorm in fp32 cast back, RoPE promoting a bf16
stream to fp32 for q and k, prefill softmax in fp32 cast back to the
activation dtype, masked with ``finfo(dtype).min``.  Weight products and
prefill attention are ``torch.matmul`` (the JAX package leaves them to
XLA); decode writes and attention go through ``PagedKVCache``
(``write_token``, ``attend_tables``) and so through the paged-decode
kernel (its plain version for CPU tensors).

Not ported yet (later slices): ``decode_n``, ``verify``, the async
twins, AOT warmup, int8 weights and pools, prefix attach and the
sequence-parallel prefill.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...models.llama import params_to, rope_tables
from ...ops.nn_ops import rms_norm, rope
from ..paged import PagedKVCache


class PagedExecutor:
    """Execution backend over the paged KV cache.

    ``params`` is the port's parameter dict (``models/llama.py``); it is
    moved to ``device`` if it lies elsewhere.  ``dtype`` is the KV pool
    dtype.  ``num_pages=None`` sizes the pool so every slot can reach
    ``max_len``; a smaller pool oversubscribes it."""

    def __init__(self, config, params, max_seqs=4, page_size=16,
                 max_len=256, dtype=torch.float32, num_pages=None,
                 device=None):
        self.device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.max_len = int(max_len)
        params = params_to(params, device=self.device)
        self.layers = params["layers"]
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
            max_pages_per_seq=pages_per_seq, device=self.device)
        self.last_token = {}

    def _layer(self, i):
        return {n: w[i] for n, w in self.layers.items()}

    def _head(self, x):
        w = self.tops["head_w"]
        return x @ (w.T if self._tied else w)

    # -- forwards --------------------------------------------------------

    def _mlp(self, x, lp):
        eps = self.config.rms_norm_eps
        h2 = rms_norm(x, lp["post_attention_layernorm.weight"], eps)
        gate = h2 @ lp["mlp.gate_proj.weight"]
        up = h2 @ lp["mlp.up_proj.weight"]
        return x + (F.silu(gate) * up) @ lp["mlp.down_proj.weight"]

    def _qkv(self, x, lp, pos):
        """Projections + RoPE: q [B, S, nh, d], k/v [B, S, nkv, d]."""
        cfg = self.config
        nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, S = x.shape[:2]
        h = rms_norm(x, lp["input_layernorm.weight"], cfg.rms_norm_eps)
        q = (h @ lp["self_attn.q_proj.weight"]).reshape(B, S, nh, d)
        k = (h @ lp["self_attn.k_proj.weight"]).reshape(B, S, nkv, d)
        v = (h @ lp["self_attn.v_proj.weight"]).reshape(B, S, nkv, d)
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
        return x + o @ lp["self_attn.o_proj.weight"]

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
        page_tables [B, pps] int32.  Each layer writes the token's K/V
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
            x = x + o @ lp["self_attn.o_proj.weight"]
            x = self._mlp(x, lp)
        x = rms_norm(x, self.tops["norm_w"], cfg.rms_norm_eps)
        return self._head(x[:, 0])

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

    def prepare_write(self, sid: int, start: int, n_tokens: int) -> None:
        """Allocate the pages a prefill chunk over [start, start + n)
        needs, before any compute (a pool-exhausted raise here lets the
        scheduler preempt cleanly)."""
        self.cache._ensure_capacity(sid, start + n_tokens)

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64)[None],
                               device=self.device)

    @torch.no_grad()
    def prefill(self, sid: int, prompt_ids) -> int:
        """Whole-prompt prefill into an allocated slot; returns the
        first greedy token."""
        ids = self._ids(prompt_ids)
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
        ids = self._ids(chunk_ids)
        logits, k, v = self._chunk_fwd(ids, start, past_k, past_v, start)
        self.cache.write_at(sid, k, v, start)
        if not final:
            return None
        tok = int(torch.argmax(logits))
        self.last_token[sid] = tok
        return tok

    @torch.no_grad()
    def decode(self, sids) -> dict:
        """One greedy decode step over an explicit batch of slots.
        Returns {sid: next_token}."""
        sids = list(sids)
        if not sids:
            return {}
        cache = self.cache
        # batch-atomic page reservation before any in-place write
        cache.reserve(sids, extra_tokens=1)
        ids = torch.tensor([self.last_token[s] for s in sids],
                           device=self.device)
        tables, lengths = cache.tables(sids)
        positions = lengths.long()
        logits = self._decode_fwd(ids, positions, lengths, tables)
        for s in sids:
            cache.lengths[s] += 1
        toks = torch.argmax(logits, dim=-1).cpu().tolist()  # one transfer
        out = {}
        for s, tok in zip(sids, toks):
            self.last_token[s] = tok
            out[s] = tok
        return out
