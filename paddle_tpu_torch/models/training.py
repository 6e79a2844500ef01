"""The AdamW train step.  Counterpart of ``paddle_tpu/models/training.py``
``CompiledTrainStep`` (with ``_adamw_tree_update``,
``_clip_by_global_norm`` and ``_default_no_decay``) for one device.

``paddle_tpu`` compiles forward, backward, clipping and the update into
one XLA program; here they run eagerly, with the same arithmetic and the
same rounding points: compute parameters in ``compute_dtype`` (names
containing ``"norm"`` stay fp32), an fp32 master copy, moments stored in
``moments_dtype``, and the update math in fp32.  The update is written
out rather than taken from ``torch.optim.AdamW``, whose bf16 state would
also be updated in bf16 arithmetic.

The module's own parameters are the compute parameters: the constructor
casts them in place and every step updates them in place (``paddle_tpu``
keeps a separate tree and writes it back on ``sync_to_model``; here that
is a no-op).  That keeps one copy of the compute weights on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(d):
    if d is None or isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unknown dtype {d!r}")
    return _DTYPES[d]


def _default_no_decay(name):
    return "norm" in name or name.endswith(".bias") or "layernorm" in name


def _f32(x):
    return np.float32(x)


class CompiledTrainStep:
    """AdamW train step over a module whose ``forward(*batch)`` returns the
    loss (``LlamaForCausalLM(input_ids, labels)``, or a wrapper around
    ``BertForQuestionAnswering`` that passes span labels).  A parameter
    the loss does not reach (BERT's pooler under the QA head) gets a zero
    gradient, as ``jax.grad`` gives it.

    ``step(*batch) -> loss`` (a 0-dim fp32 tensor on the device; reading
    it synchronises).  The state (module parameters, fp32 master, moments)
    lives on ``device``, default CUDA (see ``device.resolve_device``); the
    module is moved there.  Options of ``paddle_tpu``'s step that this
    port does not have yet raise ``NotImplementedError``: ``mesh``,
    ``update_fn``, ``loss_fn``, ``remat=True``,
    ``master_dtype="bfloat16_sr"``, ``multi_step`` and ``guarded_step``
    (ROADMAP.md Queue 1, item 3).  ``donate`` is accepted and has no
    effect: the step updates the parameters in place already."""

    def __init__(self, model, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, grad_clip_norm=1.0, compute_dtype=None,
                 no_decay_fn=_default_no_decay, moments_dtype="float32",
                 master_dtype="float32", device=None, mesh=None,
                 update_fn=None, loss_fn=None, remat=False, donate=True):
        for name, value, off in (("mesh", mesh, None),
                                 ("update_fn", update_fn, None),
                                 ("loss_fn", loss_fn, None),
                                 ("remat", remat, False)):
            if value is not off:
                raise NotImplementedError(
                    f"CompiledTrainStep({name}=...) is not ported yet "
                    "(ROADMAP.md Queue 1, item 3)")
        if master_dtype == "bfloat16_sr":
            raise NotImplementedError(
                "master_dtype='bfloat16_sr' (stochastic rounding, no fp32 "
                "master) is not ported yet (ROADMAP.md Queue 1, item 3)")
        if master_dtype != "float32":
            raise ValueError(f"unknown master_dtype {master_dtype!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lr = float(lr)
        self._hyper = (float(beta1), float(beta2), float(eps),
                       float(weight_decay))
        self._clip = None if grad_clip_norm is None else float(grad_clip_norm)
        self._no_decay = no_decay_fn
        self._t = 0
        cd = _dtype(compute_dtype)
        mdt = _dtype(moments_dtype)
        self.params = dict(model.named_parameters())
        with torch.no_grad():
            for k, p in self.params.items():
                # norm weights stay fp32: the norm ops cast them into the
                # stream dtype per op (or use them in fp32, when fused)
                if cd is not None and p.is_floating_point() \
                        and "norm" not in k:
                    p.data = p.data.to(cd)
        self._master = {k: p.detach().to(torch.float32, copy=True)
                        for k, p in self.params.items()}
        self._m = {k: torch.zeros_like(p, dtype=mdt)
                   for k, p in self.params.items()}
        self._v = {k: torch.zeros_like(p, dtype=mdt)
                   for k, p in self.params.items()}

    def _batch(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        return torch.as_tensor(np.asarray(b), device=self.device)

    def step(self, *batch):
        """One AdamW step on ``batch``; returns the loss before the
        update."""
        batch = [self._batch(b) for b in batch]
        self._t += 1
        for p in self.params.values():
            p.grad = None
        loss = self.model(*batch)
        loss.backward()
        with torch.no_grad():
            self._update()
        return loss.detach()

    def _clipped_grads(self):
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        if self._clip is None:
            return grads
        names = sorted(grads)           # jax.tree.leaves order of a dict
        gsq = sum(grads[k].float().square().sum() for k in names)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self._clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {k: g * scale.to(g.dtype) for k, g in grads.items()}

    def _update(self):
        beta1, beta2, eps, wd = self._hyper
        lr = self.lr
        t = _f32(self._t)
        # bias corrections and decay factors in fp32, as the XLA program
        # forms them from its fp32 step count and learning rate
        c1 = float(_f32(1) - _f32(beta1) ** t)
        c2 = float(_f32(1) - _f32(beta2) ** t)
        grads = self._clipped_grads()
        for k, p in self.params.items():
            g = grads[k].float()
            mk = beta1 * self._m[k].float() + (1 - beta1) * g
            vk = beta2 * self._v[k].float() + (1 - beta2) * g * g
            mhat = mk / c1
            vhat = vk / c2
            w = 0.0 if self._no_decay(k) else wd
            master = self._master[k]
            master.mul_(float(_f32(1) - _f32(lr) * _f32(w)))
            master.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
            p.copy_(master)
            self._m[k] = mk.to(self._m[k].dtype)
            self._v[k] = vk.to(self._v[k].dtype)

    def sync_to_model(self):
        """No-op: the module's parameters are the compute parameters and
        are updated in place by every step."""

    def state_dict(self):
        """Copies of the state: ``params`` (compute dtype), ``master``
        (fp32), ``m``, ``v`` (moments dtype) and the step count ``t``."""
        def cp(tree):
            return {k: v.detach().clone() for k, v in tree.items()}

        return {"params": cp(self.params), "master": cp(self._master),
                "m": cp(self._m), "v": cp(self._v), "t": self._t}

    def multi_step(self, k, *batch, stacked=False):
        raise NotImplementedError(
            "multi_step is not ported yet (ROADMAP.md Queue 1, item 3)")

    def guarded_step(self, threshold, *batch):
        raise NotImplementedError(
            "guarded_step is not ported yet (ROADMAP.md Queue 1, item 3)")
