"""The AdamW train step.  Counterpart of ``paddle_tpu/models/training.py``
``CompiledTrainStep`` (with ``_adamw_tree_update``,
``_clip_by_global_norm``, ``_stochastic_round_bf16`` and
``_default_no_decay``) for one device.

``paddle_tpu`` compiles forward, backward, clipping and the update into
one XLA program.  Here ``step`` runs them eagerly, and ``multi_step(k)``
captures k of them into one CUDA graph (``core.aot.CountedGraph``) that
later calls replay: the counterpart of the reference's ``lax.scan`` over
k steps in one program.  The arithmetic and the rounding points are the
reference's: compute parameters in ``compute_dtype`` (names containing
``"norm"`` stay fp32), an fp32 master copy (none with
``master_dtype="bfloat16_sr"``), moments stored in ``moments_dtype``,
and the update math in fp32.

The update runs tensor by tensor, so its fp32 temporaries are those of
one tensor at a time (at Llama-2-7B an fp32 copy of every moment at
once would not fit beside the state).  The step count and the learning
rate reach it as fp32 tensors on the device, and the bias corrections
``1 - beta^t`` are formed there, so a captured graph reads this step's
values on every replay.  Every write of the state goes through one
gate, a device bool: ``guarded_step`` forms it from the loss and the
gradient norm, the other steps hold it True (False only during a
graph's warm-up).

The module's own parameters are the compute parameters: the constructor
casts them in place and every step updates them in place (``paddle_tpu``
keeps a separate tree and writes it back on ``sync_to_model``; here that
is a no-op).  That keeps one copy of the compute weights on the card,
and the addresses a captured graph holds never change.  Buffers (a batch
norm's running statistics) are not state of the step: they keep their
dtype, and the step's forward leaves them as they are.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import aot
from ..device import resolve_device
from ..nn.norm import running_stats_frozen
from ..optimizer.lr import LRScheduler, ReduceOnPlateau
from ..testing import faults

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: the seed of the stochastic-rounding generator (the reference's
#: ``PRNGKey(0x5A)``)
SR_SEED = 0x5A


def _dtype(d):
    if d is None or isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unknown dtype {d!r}")
    return _DTYPES[d]


def _default_no_decay(name):
    return "norm" in name or name.endswith(".bias") or "layernorm" in name


def sr_bits(x32, r):
    """fp32 ``x32`` to bf16 by stochastic rounding on the given random
    bits ``r`` (int32 in [0, 2^16), x32's shape): the bf16 whose bits
    are the high half of ``bits(x32) + r``, which is
    ``_stochastic_round_bf16``'s ``((u + r) >> 16)`` on uint32 ``u``.
    torch has no uint32 arithmetic: the sum runs on the int32 view,
    whose wrap-around is the uint32 sum's, and the high halves are read
    as int16 from the little-endian words."""
    s = x32.reshape(-1).view(torch.int32) + r.reshape(-1)
    return s.view(torch.int16)[1::2].view(torch.bfloat16).reshape(
        x32.shape)


def stochastic_round_bf16(x32, generator):
    """``sr_bits`` on 16 random bits per element drawn from
    ``generator`` (on x32's device): unbiased, E[round(x)] = x."""
    r = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32,
                      device=x32.device, generator=generator)
    return sr_bits(x32, r)


def _generator_slots(model):
    """(module, attribute, generator) of every ``torch.Generator`` the
    model's modules hold (dropout)."""
    return [(mod, attr, v) for mod in model.modules()
            for attr, v in vars(mod).items()
            if isinstance(v, torch.Generator)]


def _model_generators(model):
    """The distinct ``torch.Generator`` s the model's modules hold."""
    seen = {}
    for _, _, g in _generator_slots(model):
        seen.setdefault(id(g), g)
    return list(seen.values())


def _capturing():
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


class _Replay:
    """``checkpoint`` contexts that give the recompute the forward's
    random draws.

    Eagerly the forward snapshots every generator, the recompute runs
    from the snapshot and puts the generators back after.  A snapshot
    cannot be read under a CUDA-graph capture (its offset is the graph's
    until a replay), so there each module generator has a *twin*
    (``clone_state``) registered with the graph beside it: the module
    draws its forward masks from its own generator and its recompute
    masks from the twin, swapped into the module's attribute for the
    recompute.  The twin starts every replay where its generator stands
    (:meth:`sync`), and both advance by the same draws within a replay,
    so the recompute draws what the forward drew on every replay, while
    each replay draws anew."""

    def __init__(self, model):
        self.slots = _generator_slots(model)
        self.generators = _model_generators(model)
        self.twins = {}
        self.saved = None
        self.captured = False

    def make_twins(self):
        """One twin per generator, on its device (the capture's graph
        registers them); returns them."""
        for g in self.generators:
            if id(g) not in self.twins:
                self.twins[id(g)] = g.clone_state()
        return list(self.twins.values())

    def sync(self):
        """Each twin to its generator's state: before every replay."""
        for g in self.generators:
            twin = self.twins.get(id(g))
            if twin is not None:
                twin.set_state(g.get_state())

    @contextlib.contextmanager
    def forward(self):
        self.captured = _capturing()
        if not self.captured:
            self.saved = [g.get_state() for g in self.generators]
        yield

    @contextlib.contextmanager
    def recompute(self):
        if self.captured:
            swapped = [(m, a, g) for m, a, g in self.slots
                       if id(g) in self.twins]
            for m, a, g in swapped:
                setattr(m, a, self.twins[id(g)])
            try:
                yield
            finally:
                for m, a, g in swapped:
                    setattr(m, a, g)
            return
        now = [g.get_state() for g in self.generators]
        for g, s in zip(self.generators, self.saved):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(self.generators, now):
                g.set_state(s)

    def __call__(self):
        return self.forward(), self.recompute()


def _train_counters():
    """The launch-counted kernel wrappers a train step may run."""
    from ..ops.kernels import grouped_gemm, long_attention, rms_norm
    from ..ops.kernels import short_attention

    return (rms_norm.rms_norm_fwd, rms_norm.rms_norm_bwd,
            long_attention.attention_fwd, long_attention.attention_bwd,
            short_attention.short_attention_fwd,
            short_attention.short_attention_bwd, grouped_gemm.grouped_ffn,
            grouped_gemm.grouped_ffn_q)


class CompiledTrainStep:
    """AdamW train step over a module whose ``forward(*batch)`` returns the
    loss (``LlamaForCausalLM(input_ids, labels)``, or a wrapper around
    ``BertForQuestionAnswering`` that passes span labels), or whose
    outputs ``loss_fn`` turns into one.  A parameter the loss does not
    reach (BERT's pooler under the QA head) gets a zero gradient, as
    ``jax.grad`` gives it.

    ``step(*batch) -> loss`` (a 0-dim fp32 tensor on the device; reading
    it synchronises) runs one step eagerly.  ``multi_step(k, *batch)``
    runs k steps as one replayed CUDA graph and returns the last loss;
    ``guarded_step(threshold, *batch)`` applies the update only where
    the loss and the gradient norm are finite and the loss is at most
    ``threshold``.  ``lr`` is a float or an ``optimizer.lr.LRScheduler``:
    each step reads ``lr()`` and then calls ``lr.step()``.

    Options as in ``paddle_tpu``: ``update_fn(master, grads, m, v, t,
    lr) -> (new_master, m, v)`` (dicts of tensors; grads already clipped;
    t and lr fp32 device scalars) replaces AdamW; ``loss_fn`` makes the
    last ``n_labels`` batch elements labels, ``loss =
    loss_fn(*model(*inputs), *labels)``; ``moments`` ("mv", "m" or
    "none") allocates only the moment trees the update reads;
    ``remat=True`` runs the whole forward under ``torch.utils.checkpoint``
    (dropout masks drawn again from the forward's generator states,
    eagerly and in a captured ``multi_step``: see ``_Replay``);
    ``master_dtype="bfloat16_sr"`` keeps no fp32 master: the bf16
    parameters are the master, the update math runs in fp32 and each
    bf16 tensor is written back by stochastic rounding, its bits drawn
    from the step's own generator seeded with ``SR_SEED``.

    The state (module parameters, fp32 master, moments) lives on
    ``device`` (or ``state_device``; default CUDA, see
    ``device.resolve_device``): a module built on the CPU moves there
    one tensor at a time.  ``mesh`` raises ``NotImplementedError``
    (ROADMAP.md Queue 1, item 8); ``donate`` has no effect: the step
    updates the state in place already."""

    def __init__(self, model, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, grad_clip_norm=1.0, compute_dtype=None,
                 no_decay_fn=_default_no_decay, moments_dtype="float32",
                 master_dtype="float32", device=None, mesh=None,
                 update_fn=None, loss_fn=None, n_labels=1, moments="mv",
                 state_device=None, remat=False, donate=True):
        if mesh is not None:
            raise NotImplementedError(
                "CompiledTrainStep(mesh=...) is not ported yet (ROADMAP.md "
                "Queue 1, item 8)")
        if master_dtype not in ("float32", "bfloat16_sr"):
            raise ValueError(f"unknown master_dtype {master_dtype!r}")
        if moments not in ("mv", "m", "none"):
            raise ValueError(f"unknown moments {moments!r}")
        if update_fn is None and moments != "mv":
            raise ValueError("the AdamW update reads both moments: "
                             "moments='mv' (or pass update_fn)")
        if state_device is not None and device is not None and \
                torch.device(state_device) != torch.device(device):
            raise ValueError(f"device={device!r} and state_device="
                             f"{state_device!r} disagree")
        self.device = resolve_device(
            device if state_device is None else state_device)
        self.model = model.to(self.device)
        self.lr = lr if isinstance(lr, LRScheduler) else float(lr)
        self._hyper = (float(beta1), float(beta2), float(eps),
                       float(weight_decay))
        self._clip = None if grad_clip_norm is None else float(grad_clip_norm)
        self._no_decay = no_decay_fn
        self._update_fn = update_fn
        self._loss_fn = loss_fn
        self._n_labels = int(n_labels)
        self._single_copy = master_dtype == "bfloat16_sr"
        self._t = 0
        cd = _dtype(compute_dtype)
        mdt = _dtype(moments_dtype)
        self.params = dict(model.named_parameters())
        self._sorted = sorted(self.params)      # jax.tree.leaves order
        with torch.no_grad():
            for k, p in self.params.items():
                # norm weights stay fp32: the norm ops cast them into the
                # stream dtype per op (or use them in fp32, when fused).
                # The rule is by name, as in paddle_tpu: a ResNet's
                # bn*.weight / bn*.bias lack "norm" and are cast
                if cd is not None and p.is_floating_point() \
                        and "norm" not in k:
                    p.data = p.data.to(cd)
        self._master = ({} if self._single_copy else
                        {k: p.detach().to(torch.float32, copy=True)
                         for k, p in self.params.items()})
        self._m = ({k: torch.zeros_like(p, dtype=mdt)
                    for k, p in self.params.items()}
                   if moments in ("mv", "m") else {})
        self._v = ({k: torch.zeros_like(p, dtype=mdt)
                    for k, p in self.params.items()}
                   if moments == "mv" else {})
        self._sr_gen = torch.Generator(device=self.device)
        self._sr_gen.manual_seed(SR_SEED)
        self._remat = _Replay(model) if remat else None
        # the graph's generators: the step's own, the model's and, under
        # remat, the recompute's twins of the model's
        self._generators = ([self._sr_gen] + _model_generators(model)
                            + (self._remat.make_twins() if remat else []))
        self._zeros = {}
        # the update gate of step() and multi_step: True, and False
        # during a graph's warm-up, which so writes the state back
        # unchanged; multi_step's graph: one per (k, stacked, batch
        # shapes and dtypes), over fixed-address buffers
        self._live = torch.ones((), dtype=torch.bool, device=self.device)
        self._multi_bufs = {}
        self.last_losses = None
        self._graph = aot.CountedGraph(
            self._multi_body, name="train.multi_step", device=self.device,
            scratch=self._scratch, counters=_train_counters(),
            generators=self._generators, release=True)

    # -- the update -----------------------------------------------------

    def _scalar(self, value):
        """An fp32 0-dim tensor on the device, filled by a kernel (no
        host-to-device copy)."""
        return torch.full((), float(value), dtype=torch.float32,
                          device=self.device)

    def _coefficients(self, t, lr):
        """The update's fp32 device scalars, formed as the XLA program
        forms them from its fp32 step count and learning rate."""
        beta1, beta2, _, wd = self._hyper
        return {"c1": 1 - torch.pow(beta1, t), "c2": 1 - torch.pow(beta2, t),
                "lr": lr, "decay": 1.0 - lr * wd}

    def _global_norm(self, grads):
        """sqrt of the fp32 sum of squares, per tensor in sorted-name
        order and summed in that order, as ``_clip_by_global_norm``."""
        gsq = None
        for k in self._sorted:
            s = grads[k].float().square().sum()
            gsq = s if gsq is None else gsq + s
        return torch.sqrt(gsq)

    def _clip_scale(self, gnorm):
        return torch.clamp(self._clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)

    @staticmethod
    def _write(dst, src, ok):
        """dst <- src (cast to dst's dtype) where ``ok`` (a device bool)
        holds; otherwise dst keeps its value."""
        torch.where(ok, src.to(dst.dtype), dst, out=dst)

    def _update(self, grads, scale, t, lr, ok):
        """The AdamW update of every parameter from ``grads`` (unclipped;
        ``scale`` the clip factor or None) at fp32 device scalars ``t``
        and ``lr``, written only where the device bool ``ok`` holds."""
        if self._update_fn is not None:
            return self._update_with_fn(grads, scale, t, lr, ok)
        beta1, beta2, eps, _ = self._hyper
        c = self._coefficients(t, lr)
        for k in self._sorted:
            p = self.params[k]
            g = grads[k]
            if scale is not None:               # g * scale.astype(g.dtype)
                g = g * scale.to(g.dtype)
            g = g.float()
            mk = beta1 * self._m[k].float() + (1 - beta1) * g
            vk = beta2 * self._v[k].float() + (1 - beta2) * g * g
            upd = c["lr"] * (mk / c["c1"])
            upd /= torch.sqrt(vk / c["c2"]) + eps
            w = p.float() if self._single_copy else self._master[k]
            new = (w * c["decay"] - upd if not self._no_decay(k)
                   else w - upd)
            del upd
            if self._single_copy and p.dtype == torch.bfloat16:
                new = stochastic_round_bf16(new, self._sr_gen)
            self._write(p, new, ok)
            if not self._single_copy:
                self._write(w, new, ok)
            del new
            self._write(self._m[k], mk, ok)
            self._write(self._v[k], vk, ok)

    def _update_with_fn(self, grads, scale, t, lr, ok):
        if scale is not None:
            grads = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        master = ({k: p.float() for k, p in self.params.items()}
                  if self._single_copy else self._master)
        newp, new_m, new_v = self._update_fn(master, grads, self._m,
                                             self._v, t, lr)
        for k in self._sorted:
            w = newp[k].float()
            p = self.params[k]
            if self._single_copy and p.dtype == torch.bfloat16:
                w = stochastic_round_bf16(w, self._sr_gen)
            self._write(p, w, ok)
            if not self._single_copy:
                self._write(self._master[k], newp[k], ok)
            if k in self._m:
                self._write(self._m[k], new_m[k], ok)
            if k in self._v:
                self._write(self._v[k], new_v[k], ok)

    # -- forward and backward --------------------------------------------

    def _loss_of(self, *batch):
        if self._loss_fn is None:
            return self.model(*batch)
        n = self._n_labels
        ins, labels = (batch[:-n], batch[-n:]) if n else (batch, ())
        out = self.model(*ins)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return self._loss_fn(*outs, *labels)

    def _forward(self, batch):
        if self._remat is None:
            return self._loss_of(*batch)
        # the whole forward rematerialised in the backward
        return checkpoint(self._loss_of, *batch, use_reentrant=False,
                          preserve_rng_state=False, context_fn=self._remat)

    def _zero(self, k):
        z = self._zeros.get(k)
        if z is None:
            z = self._zeros[k] = torch.zeros_like(self.params[k])
        return z

    def _grads(self, loss):
        names = [k for k in self._sorted if self.params[k].requires_grad]
        got = torch.autograd.grad(loss, [self.params[k] for k in names],
                                  allow_unused=True)
        grads = dict(zip(names, got))
        return {k: grads[k] if grads.get(k) is not None else self._zero(k)
                for k in self._sorted}

    def _run(self, batch, t, lr, gate=None, inject_grads=False):
        """Forward, backward, clipping and the update at device scalars
        ``t`` and ``lr``: one train step, gated by ``_live`` or, with
        ``gate`` (``guarded_step``'s fp32 device vector [ceiling, loss
        inject, grad inject]), by the verdict formed here; returns (loss,
        gnorm or None, ok).  ``inject_grads`` adds the grad inject to
        every gradient (the reference always adds it; unarmed it is 0, so
        the pass is skipped).  Batch norms normalise with the batch
        statistics and leave their running statistics as they were, as
        in ``paddle_tpu``'s compiled step (ROADMAP.md Queue 3)."""
        with running_stats_frozen(self.model):
            loss = self._forward(batch)
            grads = self._grads(loss)
        loss = loss.detach()
        if gate is not None:
            loss = loss + gate[1].to(loss.dtype)
            if inject_grads:
                grads = {k: g + gate[2].to(g.dtype)
                         for k, g in grads.items()}
        gnorm = (self._global_norm(grads)
                 if self._clip is not None or gate is not None
                 else None)
        ok = self._live
        if gate is not None:
            ok = (torch.isfinite(loss) & torch.isfinite(gnorm)
                  & (loss.float() <= gate[0]))
        scale = None if self._clip is None else self._clip_scale(gnorm)
        with torch.no_grad():
            self._update(grads, scale, t, lr, ok)
        return loss, gnorm, ok

    def _next_lr(self):
        if isinstance(self.lr, LRScheduler):
            value = float(self.lr())
            self.lr.step()
            return value
        return self.lr

    def _batch(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        return torch.as_tensor(np.asarray(b), device=self.device)

    # -- the entry points -------------------------------------------------

    def step(self, *batch):
        """One AdamW step on ``batch``, eagerly; returns the loss before
        the update.  The ``train.step`` fault point fires at the host
        boundary, before and after."""
        faults.fire("train.step", "before")
        batch = [self._batch(b) for b in batch]
        self._t += 1
        lr = self._next_lr()
        loss, _, _ = self._run(batch, self._scalar(self._t),
                               self._scalar(lr))
        faults.fire("train.step", "after")
        return loss

    def guarded_step(self, threshold, *batch):
        """One step through the anomaly gate: the update is applied only
        where the loss and the global gradient norm are finite and the
        loss is at most ``threshold`` (``inf`` disables the ceiling).
        The gate is formed on the device and applied per tensor inside
        the update (``torch.where(ok, new, old)`` written in place), so
        no second copy of the state is held.  A skipped step leaves the
        parameters, the master, both moments and the step count as they
        were (found_inf semantics); the scheduler advances either way,
        as in ``paddle_tpu``.  Returns ``(loss, grad_norm, ok)`` as host
        float, float, bool (the one synchronisation).

        The ``guard.nan_loss``, ``guard.loss_spike`` and ``guard.nan_grad``
        points (``inject``) are polled here into the gate vector
        [ceiling, loss inject, grad inject], as in ``paddle_tpu``: armed,
        they poison the loss or the gradients inside the gated step, so
        the skip path the guardian sees is the production one;
        ``train.step`` fires before and after."""
        faults.fire("train.step", "before")
        l_inj = 0.0
        if faults.poll("guard.nan_loss") is not None:
            l_inj = float("nan")
        else:
            spike = faults.poll("guard.loss_spike")
            if spike is not None:
                l_inj = 1e6 if spike is True else float(spike)
        g_inj = float("nan") \
            if faults.poll("guard.nan_grad") is not None else 0.0
        batch = [self._batch(b) for b in batch]
        self._t += 1
        lr = self._next_lr()
        gate = torch.tensor([threshold, l_inj, g_inj], dtype=torch.float32)
        loss, gnorm, ok = self._run(
            batch, self._scalar(self._t), self._scalar(lr),
            gate=gate.to(self.device), inject_grads=g_inj != 0.0)
        faults.fire("train.step", "after")
        loss_f, gnorm_f, ok_b = float(loss), float(gnorm), bool(ok)
        if not ok_b:
            self._t -= 1
        return loss_f, gnorm_f, ok_b

    def multi_step(self, k, *batch, stacked=False):
        """``k`` steps in one dispatch; returns the last step's loss.

        ``stacked`` (a bool, or one per batch element) marks elements
        whose leading axis of size ``k`` holds distinct per-step data;
        other elements are reused every step.  An ``LRScheduler`` gives
        the next k rates, read on the host before the run exactly as k
        ``step`` calls would read them; ``ReduceOnPlateau`` depends on
        the losses and is rejected, and a rejected call leaves the
        scheduler where it was.

        On CUDA the k steps (forward, backward, clipping and update each)
        are one CUDA graph per (k, stacked, batch shapes and dtypes),
        captured at the first call after an eager warm-up whose update
        is gated off (the state and the generators come out of it as
        they went in) and replayed after: the batch, the k rates and the
        first step count are copied into the graph's fixed buffers (from
        pinned staging when they come from the host) before each replay.
        On the CPU the k steps run as a loop over the same body.  The k
        losses of the last call are kept in ``last_losses``."""
        if isinstance(self.lr, ReduceOnPlateau):
            raise ValueError(
                "multi_step cannot precompute a loss-dependent schedule "
                "(ReduceOnPlateau): use step()")
        k = int(k)
        batch = [b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b)) for b in batch]
        if isinstance(stacked, bool):
            stacked = (stacked,) * len(batch)
        else:
            stacked = tuple(bool(s) for s in stacked)
        if len(stacked) != len(batch):
            raise ValueError(f"stacked has {len(stacked)} entries for "
                             f"{len(batch)} batch elements")
        for b, s in zip(batch, stacked):
            if s and (b.dim() == 0 or b.shape[0] != k):
                raise ValueError(
                    f"stacked batch element must have leading dim {k}, "
                    f"got {tuple(b.shape)}")
        # the scheduler advances only after every check passed
        lrs = [self._next_lr() for _ in range(k)]
        t0 = self._t + 1
        self._t += k
        if self.device.type != "cuda":
            batch = [b.to(self.device) for b in batch]
            losses = []
            for i in range(k):
                per = [b[i] if s else b for b, s in zip(batch, stacked)]
                losses.append(self._run(per, self._scalar(t0 + i),
                                        self._scalar(lrs[i]))[0])
            self.last_losses = torch.stack(losses)
            return losses[-1]
        rung = (k, stacked, tuple((tuple(b.shape), b.dtype) for b in batch))
        bufs = self._multi_bufs.get(rung)
        if bufs is None:
            bufs = self._multi_bufs[rung] = self._make_bufs(k, batch)
        self._stage(bufs, batch, t0, lrs)
        if self._remat is not None:
            self._remat.sync()
        self.last_losses = self._graph(rung).clone()
        return self.last_losses[-1].clone()

    def _make_bufs(self, k, batch):
        dev = self.device
        scalars = torch.zeros(k + 1, dtype=torch.float32, device=dev)
        return {
            "batch": [torch.empty(b.shape, dtype=b.dtype, device=dev)
                      for b in batch],
            "host": [None if b.device.type == "cuda" else
                     torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                     for b in batch],
            "scalars": scalars, "t0": scalars[0], "lrs": scalars[1:],
            "stage": torch.zeros(k + 1, dtype=torch.float32,
                                 pin_memory=True),
            "event": None}

    def _stage(self, bufs, batch, t0, lrs):
        """Fill a graph's buffers: [t0, lr_0 .. lr_k-1] and host batch
        elements through pinned staging (non-blocking), device elements
        by a device copy."""
        if bufs["event"] is not None:   # the last copies read the staging
            bufs["event"].synchronize()
        st = bufs["stage"].numpy()
        st[0] = t0
        st[1:] = lrs
        bufs["scalars"].copy_(bufs["stage"], non_blocking=True)
        for buf, host, b in zip(bufs["batch"], bufs["host"], batch):
            if host is None:
                buf.copy_(b)
            else:
                host.copy_(b)
                buf.copy_(host, non_blocking=True)
        bufs["event"] = torch.cuda.Event()
        bufs["event"].record()

    def _multi_body(self, rung):
        """The captured program: k steps over the rung's buffers."""
        k, stacked, _ = rung
        bufs = self._multi_bufs[rung]
        losses = []
        for i in range(k):
            per = [b[i] if s else b for b, s in zip(bufs["batch"], stacked)]
            losses.append(self._run(per, bufs["t0"] + i, bufs["lrs"][i])[0])
        return torch.stack(losses)

    @contextlib.contextmanager
    def _scratch(self):
        """Around the warm-up and the capture: the update gate held
        False, and every generator put back as it was on exit."""
        states = [g.get_state() for g in self._generators]
        self._live.fill_(False)
        try:
            yield
        finally:
            self._live.fill_(True)
            for g, s in zip(self._generators, states):
                g.set_state(s)

    # -- state --------------------------------------------------------------

    def sync_to_model(self):
        """No-op: the module's parameters are the compute parameters and
        are updated in place by every step."""

    def state_dict(self):
        """Copies of the state: ``params`` (compute dtype), ``master``
        (fp32; empty with ``bfloat16_sr``), ``m``, ``v`` (moments dtype),
        the step count ``t`` and, with a scheduler, ``lr_scheduler``."""
        def cp(tree):
            return {k: v.detach().clone() for k, v in tree.items()}

        state = {"params": cp(self.params), "master": cp(self._master),
                 "m": cp(self._m), "v": cp(self._v), "t": self._t}
        if isinstance(self.lr, LRScheduler):
            state["lr_scheduler"] = self.lr.state_dict()
        return state

    def set_state_dict(self, state):
        """Load a ``state_dict`` (tensors or arrays; any device) into the
        state in place, so captured graphs stay valid, and the
        scheduler's state when both have one."""
        with torch.no_grad():
            for name, tree in (("params", self.params),
                               ("master", self._master), ("m", self._m),
                               ("v", self._v)):
                for k, dst in tree.items():
                    src = state[name][k]
                    dst.copy_(src if isinstance(src, torch.Tensor)
                              else torch.from_numpy(np.array(src)))
        self._t = int(state["t"])
        if "lr_scheduler" in state and isinstance(self.lr, LRScheduler):
            self.lr.set_state_dict(dict(state["lr_scheduler"]))
