"""The optimizer base.  Counterpart of ``paddle_tpu/optimizer/optimizer.py``:
a parameter list or param groups (dicts with ``params`` and an optional
``learning_rate`` factor and ``weight_decay``), a float or an
``LRScheduler`` learning rate, L2 / L1 decay added to the gradient,
gradient clipping before the update, ``step``, ``clear_grad``,
``minimize`` and ``state_dict`` / ``set_state_dict``.

The parameters are ``torch.nn.Parameter`` s, updated in place under
``no_grad`` (per-parameter torch ops, in the order of the reference's
formulas).  Rounding points follow the reference:

* master weights (``multi_precision=True``, or after
  ``amp.decorate``): a non-fp32 parameter is updated through an fp32
  copy made from it at its first step, then rounded back into it;
* accumulators are fp32 under master weights, else in the parameter's
  dtype (each optimizer may fix its own: Adam's moments are fp32);
* each parameter has its own step count ``_t``;
* a parameter's lr is the optimizer's lr times its group's factor times
  ``p.optimize_attr["learning_rate"]`` where the parameter has one.

Parameter names.  The reference names each parameter with a global
counter (``linear_0.w_0``) and keys its state ``{name}.{slot}``; a
torch parameter has no name (torch keeps ``Tensor.name``, read-only, for
named tensors).  The port's rule: ``p.param_name`` where the caller set
one, else ``param_{i}``, ``i`` its index in the optimizer's parameter
list (the reference's own fallback).  ``AdamW``'s
``apply_decay_param_fun`` receives that name.
``models.convert.optimizer_state_to_port`` / ``_to_reference`` map
between the two rules.

The update runs under ``amp.state.no_amp``: the reference's updates are
raw jnp code, which its AMP policy never casts.
"""
from __future__ import annotations

import torch

from ..amp.state import no_amp
from .lr import LRScheduler


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def weak(x, dtype):
    """A Python number as a weak-typed jnp scalar meets a tensor of
    ``dtype``: scalar arithmetic is done in float64 (the reference runs
    with x64 on), and the result rounded to the tensor's dtype where it
    meets it, which torch does itself for fp32; a bf16 or fp16 tensor
    gets the number rounded to its dtype first."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(float(x), dtype=dtype))
    return float(x)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._use_master_weights = multi_precision
        self._accumulators: dict[int, dict] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._global_step = 0

        if weight_decay is None:
            self._weight_decay = None
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = L2Decay(float(weight_decay))
        else:
            self._weight_decay = weight_decay

        self._param_groups = []
        if parameters is not None:
            parameters = list(parameters)
            if parameters and isinstance(parameters[0], dict):
                for group in parameters:
                    g = dict(group)
                    g.setdefault("learning_rate", 1.0)
                    g["params"] = list(g["params"])
                    self._param_groups.append(g)
            else:
                self._param_groups.append({"params": parameters,
                                           "learning_rate": 1.0})
        self._parameters_provided = parameters is not None

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when the learning rate is a scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # -- parameters ----------------------------------------------------------
    def _parameter_list(self):
        out = []
        for g in self._param_groups:
            out.extend(g["params"])
        return out

    @property
    def _parameter_groups(self):
        return self._param_groups

    def _param_names(self):
        """Each parameter's name by the port's rule (module docstring)."""
        return [getattr(p, "param_name", None) or f"param_{i}"
                for i, p in enumerate(self._parameter_list())]

    def _name_of(self, p):
        name = getattr(p, "param_name", None)
        if name:
            return name
        for i, q in enumerate(self._parameter_list()):
            if q is p:
                return f"param_{i}"
        raise KeyError("parameter not in this optimizer")

    # -- state -------------------------------------------------------------
    def _get_accumulator(self, p, name, init=None, dtype=None):
        slots = self._accumulators.setdefault(id(p), {})
        if name not in slots:
            d = dtype or (torch.float32 if self._use_master_weights
                          else p.dtype)
            slots[name] = (torch.zeros(p.shape, dtype=d, device=p.device)
                           if init is None else init)
        return slots[name]

    def _set_accumulator(self, p, name, value):
        self._accumulators.setdefault(id(p), {})[name] = value

    def _step_count(self, p):
        """Per-parameter step counter (a host number)."""
        slots = self._accumulators.setdefault(id(p), {})
        t = int(slots.get("_t", 0)) + 1
        slots["_t"] = t
        return t

    def _master_weight(self, p):
        mw = self._master_weights.get(id(p))
        if mw is None:
            mw = p.detach().to(torch.float32)
            self._master_weights[id(p)] = mw
        return mw

    # -- step --------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        with no_amp():
            self._step()

    def _step(self):
        self._global_step += 1
        for group in self._param_groups:
            params_grads = [(p, p.grad) for p in group["params"]
                            if p.grad is not None and p.requires_grad]
            if not params_grads:
                continue
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            group_lr = self.get_lr() * group.get("learning_rate", 1.0)
            wd = group.get("weight_decay", self._weight_decay)
            if isinstance(wd, (int, float)):
                wd = L2Decay(float(wd))
            for p, g in params_grads:
                attr = getattr(p, "optimize_attr", None)
                lr = group_lr * attr.get("learning_rate", 1.0) \
                    if attr is not None else group_lr
                self._apply_one(p, g, lr, wd)

    @property
    def _apply_weight_decay_in_grad(self):
        return True

    def _apply_one(self, p, g, lr, wd):
        use_master = (self._use_master_weights
                      and p.dtype != torch.float32)
        pd = self._master_weight(p) if use_master else p.detach()
        gd = g.detach()
        if gd.dtype != pd.dtype:
            gd = gd.to(pd.dtype)
        if wd is not None and self._apply_weight_decay_in_grad \
                and getattr(p, "regularizer", None) is None:
            if isinstance(wd, L2Decay) and wd.coeff:
                gd = gd + weak(wd.coeff, pd.dtype) * pd
            elif isinstance(wd, L1Decay) and wd.coeff:
                gd = gd + weak(wd.coeff, pd.dtype) * torch.sign(pd)
        new_p = self._update_param(p, pd, gd, lr, wd)
        if use_master:
            self._master_weights[id(p)] = new_p
        p.copy_(new_p)

    def _update_param(self, p, pd, gd, lr, wd):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- serialization -----------------------------------------------------
    def state_dict(self):
        """``{"global_step", "accumulators": {"{name}.{slot}": value},
        ["LR_Scheduler"]}``: tensors are copies on their parameters'
        device, ``_t`` a host int, master weights under
        ``{name}.master_weight``."""
        state = {"global_step": self._global_step}
        accum = {}
        for key, p in zip(self._param_names(), self._parameter_list()):
            for sname, val in self._accumulators.get(id(p), {}).items():
                accum[f"{key}.{sname}"] = (val.detach().clone()
                                           if torch.is_tensor(val) else val)
            if id(p) in self._master_weights:
                accum[f"{key}.master_weight"] = \
                    self._master_weights[id(p)].detach().clone()
        state["accumulators"] = accum
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state):
        self._global_step = state.get("global_step", 0)
        accum = state.get("accumulators", {})
        for key, p in zip(self._param_names(), self._parameter_list()):
            for full, val in accum.items():
                if not full.startswith(key + "."):
                    continue
                sname = full[len(key) + 1:]
                if sname == "_t":
                    self._set_accumulator(p, sname, int(val))
                    continue
                t = torch.as_tensor(val).to(p.device).clone()
                if sname == "master_weight":
                    self._master_weights[id(p)] = t
                else:
                    self._set_accumulator(p, sname, t)
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    load_state_dict = set_state_dict
