"""The optimizer family.  Counterpart of ``paddle_tpu/optimizer/
optimizers.py``: ``SGD``, ``Momentum`` (Nesterov too), ``Adagrad``,
``RMSProp``, ``Adam``, ``AdamW`` (decoupled decay,
``apply_decay_param_fun``, ``lr_ratio``), ``Lamb`` and ``LarsMomentum``
(``Lars``), each update written with torch ops in the order of the
reference's jitted formula, its scalars formed in float64 as the
reference's weak-typed scalars are (``optimizer.weak``).  A fused multi-tensor
update is later work (ROADMAP.md, the device items)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, weak


def _bias_corrections(beta1, beta2, t):
    """``1 - beta1 ** t`` and ``1 - beta2 ** t`` in float64."""
    return 1.0 - beta1 ** t, 1.0 - beta2 ** t


def _adam_moments(g, m, v, beta1, beta2):
    m = weak(beta1, m.dtype) * m + (1.0 - beta1) * g
    v = weak(beta2, v.dtype) * v + (1.0 - beta2) * g * g
    return m, v


class SGD(Optimizer):
    def _update_param(self, p, pd, gd, lr, wd):
        return pd - weak(lr, pd.dtype) * gd


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update_param(self, p, pd, gd, lr, wd):
        vel = self._get_accumulator(p, "velocity")
        if vel.dtype != pd.dtype:
            vel = vel.to(pd.dtype)
        mu, lr = weak(self._momentum, pd.dtype), weak(lr, pd.dtype)
        vel = mu * vel + gd
        if self._use_nesterov:
            new_p = pd - (gd + mu * vel) * lr
        else:
            new_p = pd - lr * vel
        self._set_accumulator(p, "velocity", vel)
        return new_p


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, pd, gd, lr, wd):
        mom = self._get_accumulator(
            p, "moment", init=torch.full(p.shape, self._init_acc,
                                         dtype=pd.dtype, device=pd.device))
        mom = mom + gd * gd
        new_p = pd - weak(lr, pd.dtype) * gd / (
            torch.sqrt(mom) + weak(self._epsilon, pd.dtype))
        self._set_accumulator(p, "moment", mom)
        return new_p


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _update_param(self, p, pd, gd, lr, wd):
        dt = pd.dtype
        ms = self._get_accumulator(p, "mean_square", dtype=dt)
        mom = self._get_accumulator(p, "momentum", dtype=dt)
        ms = weak(self._rho, dt) * ms + (1.0 - self._rho) * gd * gd
        mom = weak(self._momentum, dt) * mom + weak(lr, dt) * gd \
            / torch.sqrt(ms + weak(self._epsilon, dt))
        self._set_accumulator(p, "mean_square", ms)
        self._set_accumulator(p, "momentum", mom)
        return pd - mom


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _moments_step(self, p, pd, gd, lr, coeff=None):
        m = self._get_accumulator(p, "moment1", dtype=torch.float32)
        v = self._get_accumulator(p, "moment2", dtype=torch.float32)
        t = self._step_count(p)
        p32 = pd.to(torch.float32)
        g32 = gd.to(torch.float32)
        if coeff is not None:     # AdamW: decoupled decay first
            p32 = p32 * (1.0 - lr * coeff)
        m, v = _adam_moments(g32, m, v, self._beta1, self._beta2)
        bc1, bc2 = _bias_corrections(self._beta1, self._beta2, t)
        new_p = p32 - weak(lr, torch.float32) * (m / bc1) / (
            torch.sqrt(v / bc2) + weak(self._epsilon, torch.float32))
        self._set_accumulator(p, "moment1", m)
        self._set_accumulator(p, "moment2", v)
        return new_p.to(pd.dtype)

    def _update_param(self, p, pd, gd, lr, wd):
        return self._moments_step(p, pd, gd, lr)


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * coeff)`` before the Adam
    step, never in the gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._coeff = float(weight_decay) if isinstance(
            weight_decay, (int, float)) else weight_decay.coeff
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    @property
    def _apply_weight_decay_in_grad(self):
        return False

    def _update_param(self, p, pd, gd, lr, wd):
        coeff = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._name_of(p)):
            coeff = 0.0
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        return self._moments_step(p, pd, gd, lr, coeff)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, pd, gd, lr, wd):
        wd_coeff = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd_coeff = 0.0
        m = self._get_accumulator(p, "moment1", dtype=torch.float32)
        v = self._get_accumulator(p, "moment2", dtype=torch.float32)
        t = self._step_count(p)
        p32, g32 = pd.to(torch.float32), gd.to(torch.float32)
        m, v = _adam_moments(g32, m, v, self._beta1, self._beta2)
        bc1, bc2 = _bias_corrections(self._beta1, self._beta2, t)
        r = (m / bc1) / (torch.sqrt(v / bc2)
                         + weak(self._epsilon, torch.float32)) \
            + weak(wd_coeff, torch.float32) * p32
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        r_norm = torch.sqrt(torch.sum(r * r))
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = p32 - weak(lr, torch.float32) * ratio * r
        self._set_accumulator(p, "moment1", m)
        self._set_accumulator(p, "moment2", v)
        return new_p.to(pd.dtype)


class LarsMomentum(Optimizer):
    """LARS momentum (the reference's ``lars_momentum``): a layer-wise
    rate ``lars_coeff * |p| / (|g| + lars_wd * |p| + eps)`` (1 where
    either norm is 0), the velocity in fp32."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, epsilon=1e-9, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def _update_param(self, p, pd, gd, lr, wd):
        f32 = torch.float32
        vel = self._get_accumulator(p, "velocity", dtype=f32)
        p32, g32 = pd.to(f32), gd.to(f32)
        p_norm = torch.sqrt(torch.sum(p32 * p32))
        g_norm = torch.sqrt(torch.sum(g32 * g32))
        lwd = weak(self._lars_wd, f32)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            weak(self._lars_coeff, f32) * p_norm
            / (g_norm + lwd * p_norm + weak(self._epsilon, f32)),
            torch.ones_like(p_norm))
        scaled = (g32 + lwd * p32) * local_lr * weak(lr, f32)
        vel = weak(self._momentum, f32) * vel.to(f32) + scaled
        self._set_accumulator(p, "velocity", vel)
        return (p32 - vel).to(pd.dtype)


Lars = LarsMomentum
