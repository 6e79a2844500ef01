"""Greedy incremental decoding with a static KV cache, and the
layer-stacking helper shared by the serving executor and the weight
converter.

Counterpart of ``paddle_tpu/models/generation.py`` (``LlamaDecoder``,
``_stack_layer_params``).  The reference stacks the weights on a layer
axis and runs the decode loop as one jitted ``lax.scan``, compiled per
``(B, S, max_new_tokens)`` and kept in an LRU of 8.  Eager PyTorch has
nothing to compile, so the decoder here keeps no per-shape state: each
call allocates its static cache ``[L, B, S + new, n_kv, d]`` in the
model's dtype and drops it at return (one held cache of Llama-2-13B at
B = 8, S + new = 544 is 3.57 GB), and it reads the model's own
parameters, never a stacked copy (13B in bf16 is 26 GB).

The forward keeps the reference's rounding points: RMSNorm in fp32
rounded to the stream's dtype, RoPE with the fp32 tables (a bf16 q and
k come out fp32, and k is rounded to the cache's dtype when written),
scores from the grouped einsum under jnp's promotion, then multiplied by
``1 / np.sqrt(d)``, a numpy float64 — ``paddle_tpu`` runs with x64 on,
so the scores become float64 — masked with ``finfo(float64).min``,
softmax in fp32, probabilities rounded to the stream's dtype before
``p @ V``.  Attention here is plain PyTorch, as the reference's is plain
XLA: decoding launches none of the hand-written kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.nn_ops import einsum, rms_norm, rope
from .llama import LAYER_WEIGHTS, rope_tables


def stack_layer_params(state: dict, n_layers: int,
                       prefix="llama.layers") -> dict:
    """{name: [L, ...] tensor} from a flat state dict whose per-layer
    entries are keyed ``{prefix}.{i}.{name}`` and hold tensors."""
    return {n: torch.stack([state[f"{prefix}.{i}.{n}"]
                            for i in range(n_layers)])
            for n in LAYER_WEIGHTS}


class LlamaDecoder:
    """Greedy incremental decoder over a ``LlamaForCausalLM``'s
    parameters, on the model's device::

        decoder = LlamaDecoder(model)
        out_ids = decoder.generate(input_ids, max_new_tokens=32)  # [B, new]

    It holds the model itself, not its weights: every call reads the
    current parameters (an in-place optimizer step is seen at the next
    call)."""

    def __init__(self, model):
        self.model = model
        self.config = model.config
        dev = model.llama.embed_tokens.weight.device
        # fp32 tables, as the reference's: the module's own rope buffers
        # follow a ``Module.to(dtype)`` cast, these do not
        self.cos, self.sin = rope_tables(self.config, dev)

    def _head_weight(self):
        m = self.model
        if self.config.tie_word_embeddings:
            return m.llama.embed_tokens.weight.t()
        return m.lm_head.weight

    def _new_cache(self, B, max_len, dtype, device):
        """The per-call static K and V caches ``[L, B, max_len, n_kv,
        d]``, zero."""
        cfg = self.config
        shape = (cfg.num_hidden_layers, B, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _forward(self, ids, kc, vc, pos_start):
        """ids ``[B, S]`` at positions ``pos_start..pos_start+S-1``; writes
        their K/V into ``kc`` / ``vc`` (``[L, B, max_len, n_kv, d]``, in
        place) and returns the last position's logits ``[B, V]``."""
        cfg = self.config
        nh, nkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        eps = cfg.rms_norm_eps
        B, S = ids.shape
        Lc = kc.shape[2]
        dev = ids.device
        llama = self.model.llama
        x = llama.embed_tokens.weight[ids]                    # [B, S, h]
        positions = pos_start + torch.arange(S, device=dev)
        pos_ids = positions[None].expand(B, S)
        scale = 1.0 / np.sqrt(d)          # float64, as under JAX's x64
        keep = (torch.arange(Lc, device=dev)[None, :]
                <= positions[:, None])                        # [S, Lc]
        g = nh // nkv
        for i, layer in enumerate(llama.layers):
            attn, mlp = layer.self_attn, layer.mlp
            h = rms_norm(x, layer.input_layernorm.weight, eps)
            q = attn.q_proj(h).reshape(B, S, nh, d)
            k = attn.k_proj(h).reshape(B, S, nkv, d)
            v = attn.v_proj(h).reshape(B, S, nkv, d)
            q, k = rope(q, k, self.cos, self.sin, pos_ids)
            kc[i, :, pos_start:pos_start + S] = k.to(kc.dtype)
            vc[i, :, pos_start:pos_start + S] = v.to(vc.dtype)
            qt = q.transpose(1, 2).reshape(B, nkv, g, S, d)
            kt = kc[i].transpose(1, 2)                     # [B, nkv, Lc, d]
            vt = vc[i].transpose(1, 2)
            logits = einsum("bngqd,bnkd->bngqk", qt, kt).double() * scale
            logits = logits.masked_fill(~keep, torch.finfo(torch.float64).min)
            probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            del logits
            o = einsum("bngqk,bnkd->bngqd", probs, vt)
            o = o.reshape(B, nh, S, d).transpose(1, 2).reshape(B, S, nh * d)
            x = x + attn.o_proj(o)
            h2 = rms_norm(x, layer.post_attention_layernorm.weight, eps)
            gate, up = mlp.gate_proj(h2), mlp.up_proj(h2)
            x = x + mlp.down_proj(torch.nn.functional.silu(gate) * up)
        x = rms_norm(x, llama.norm.weight, eps)
        return einsum("bh,hv->bv", x[:, -1], self._head_weight())

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16):
        """Greedy decode: ``[B, max_new_tokens]`` generated ids, in the
        ids' integer dtype; a tensor for a tensor (on the model's
        device), a numpy array for anything else.  Raises ``ValueError``
        when ``max_new_tokens < 1`` or the prompt plus the new tokens
        exceed ``max_position_embeddings``."""
        wrap = isinstance(input_ids, torch.Tensor)
        dev = self.model.llama.embed_tokens.weight.device
        ids = (input_ids if wrap
               else torch.from_numpy(np.asarray(input_ids))).to(dev)
        B, S = ids.shape
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if S + max_new_tokens > self.config.max_position_embeddings:
            raise ValueError(
                f"prompt {S} + max_new_tokens {max_new_tokens} exceeds "
                f"max_position_embeddings "
                f"{self.config.max_position_embeddings}")
        kc, vc = self._new_cache(B, S + max_new_tokens,
                                 self.model.llama.embed_tokens.weight.dtype,
                                 dev)
        tok = torch.argmax(self._forward(ids.long(), kc, vc, 0), dim=-1)
        toks = [tok]
        for pos in range(S, S + max_new_tokens - 1):
            tok = torch.argmax(self._forward(tok[:, None], kc, vc, pos),
                               dim=-1)
            toks.append(tok)
        out = torch.stack(toks, dim=1).to(ids.dtype)
        return out if wrap else out.cpu().numpy()
