"""Manual (hand-driven) serving over the paged KV cache.

Counterpart of ``paddle_tpu/inference/serving.py``: ``PagedLlamaEngine``
is the thin shim over :class:`~paddle_tpu_torch.inference.server.
executor.PagedExecutor` (the backend the continuous-batching
``ServingEngine`` drives), with explicit ``add_request`` / ``step`` /
``decode_n`` / ``finish`` and no queueing, admission or preemption: the
caller is the scheduler.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.convert import serving_params
from .server.executor import PagedExecutor


class PagedLlamaEngine:
    """Greedy continuous-batching decoder for a ``LlamaForCausalLM``::

        engine = PagedLlamaEngine(model, max_seqs=4, page_size=16,
                                  max_len=256)
        sid = engine.add_request(prompt_ids)           # prefill
        out = engine.step()                            # {sid: next_token}
        engine.finish(sid)                             # free pages

    ``dtype`` is the KV pool's; the weights keep the model's dtype (that
    of its embedding), as the reference's executor takes the state dict
    as it is.  The executor's stacked weights are built on the model's
    device from its parameters (``models.convert.serving_params``): a
    copy, so later in-place updates of the model are not seen."""

    def __init__(self, model, max_seqs=4, page_size=16, max_len=256,
                 dtype=torch.float32):
        w = model.llama.embed_tokens.weight
        params = serving_params(model, device=w.device, dtype=w.dtype)
        self._ex = PagedExecutor(model.config, params, max_seqs=max_seqs,
                                 page_size=page_size, max_len=max_len,
                                 dtype=dtype, device=w.device)

    # the shim exposes the executor's state under the historical names
    @property
    def config(self):
        return self._ex.config

    @property
    def cache(self):
        return self._ex.cache

    @property
    def layers(self):
        return self._ex.layers

    @property
    def tops(self):
        return self._ex.tops

    @property
    def _last_token(self):
        return self._ex.last_token

    def add_request(self, prompt_ids) -> int:
        """Prefill one prompt; returns the sequence slot id."""
        sid = self._ex.alloc_slot()
        try:
            self._ex.prefill(sid, np.asarray(prompt_ids))
        except BaseException:
            self._ex.free_slot(sid)  # don't strand the slot on failure
            raise
        return sid

    def finish(self, sid: int):
        self._ex.free_slot(sid)

    def step(self):
        """One greedy decode step over every active sequence."""
        return self._ex.decode(sorted(self._ex.last_token))

    def decode_n(self, n):
        """``n`` greedy tokens per active sequence in one dispatch.
        Returns {sid: [tok_1..tok_n]}."""
        return self._ex.decode_n(sorted(self._ex.last_token), n)
