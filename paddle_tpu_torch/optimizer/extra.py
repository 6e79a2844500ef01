"""``Adamax``, ``NAdam``, ``RAdam``, ``Adadelta``, ``Rprop`` and ``ASGD``.

Counterpart of ``paddle_tpu/optimizer/extra.py`` (reference
``python/paddle/optimizer/{adamax,nadam,radam,adadelta,rprop,asgd}.py``).
Each update is the reference's jitted formula written with torch ops in
the same order, on fp32 accumulators, the parameter updated in fp32 and
rounded to its dtype.  The reference's Python scalars are weak-typed
float64 under x64: they are formed here in float64 (Python floats) and
rounded to fp32 where they meet a tensor, which torch does itself;
where the reference passes ``jnp.float32(...)`` the scalar is rounded
to fp32 first (:func:`_f32`).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _f32(x):
    """A host number rounded to fp32, as ``jnp.float32(x)``."""
    return float(torch.tensor(float(x), dtype=torch.float32))


class Adamax(Optimizer):
    """Adam variant on the infinity norm (reference
    ``python/paddle/optimizer/adamax.py:45``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _update_param(self, p, pd, gd, lr, wd):
        m = self._get_accumulator(p, "moment", dtype=torch.float32)
        inf = self._get_accumulator(p, "inf_norm", dtype=torch.float32)
        t = self._step_count(p)
        g = gd.float()
        m = self._beta1 * m + (1 - self._beta1) * g
        inf = torch.maximum(self._beta2 * inf + self._epsilon, g.abs())
        new_p = pd.float() - (lr / (1 - self._beta1 ** t)) * m / inf
        self._set_accumulator(p, "moment", m)
        self._set_accumulator(p, "inf_norm", inf)
        return new_p.to(pd.dtype)


class NAdam(Optimizer):
    """Adam with Nesterov momentum (reference
    ``python/paddle/optimizer/nadam.py:49``): the mu-product schedule
    with ``momentum_decay``, the product kept on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._psi = float(momentum_decay)

    def _update_param(self, p, pd, gd, lr, wd):
        m = self._get_accumulator(p, "moment1", dtype=torch.float32)
        v = self._get_accumulator(p, "moment2", dtype=torch.float32)
        slots = self._accumulators.setdefault(id(p), {})
        mu_prod = slots.get("_mu_prod", 1.0)
        t = self._step_count(p)
        b1, b2 = self._beta1, self._beta2
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        g = gd.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        # jnp.float32(mu_prod) * weak f64 scalars: fp32 scalar math
        mu_prod_t = _f32(_f32(mu_prod) * mu_t)
        mu_prod_t1 = _f32(mu_prod_t * mu_t1)
        m_hat = mu_t1 * m / _f32(1 - mu_prod_t1) \
            + (1 - mu_t) * g / _f32(1 - mu_prod_t)
        v_hat = v / (1 - b2 ** t)
        new_p = pd.float() - lr * m_hat / (torch.sqrt(v_hat)
                                           + self._epsilon)
        slots["_mu_prod"] = mu_prod * mu_t
        self._set_accumulator(p, "moment1", m)
        self._set_accumulator(p, "moment2", v)
        return new_p.to(pd.dtype)


class RAdam(Optimizer):
    """Rectified Adam (reference ``python/paddle/optimizer/radam.py:49``):
    the variance-rectification term gated on rho_t > 5."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _update_param(self, p, pd, gd, lr, wd):
        m = self._get_accumulator(p, "moment1", dtype=torch.float32)
        v = self._get_accumulator(p, "moment2", dtype=torch.float32)
        t = self._step_count(p)
        b1, b2 = self._beta1, self._beta2
        rho_inf = 2.0 / (1 - b2) - 1
        b2pow = b2 ** t
        rho_t = _f32(rho_inf - 2.0 * t * b2pow / (1 - b2pow))
        rho_inf = _f32(rho_inf)
        g, pf = gd.float(), pd.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat = m / (1 - b1 ** t)
        if rho_t > 5.0:
            l_t = (1 - b2pow) ** 0.5 / (torch.sqrt(v) + self._epsilon)
            num = _f32(_f32(_f32(rho_t - 4) * _f32(rho_t - 2)) * rho_inf)
            den = _f32(_f32(_f32(rho_inf - 4) * _f32(rho_inf - 2)) * rho_t)
            r_t = _f32(_f32(num / den) ** 0.5)
            new_p = pf - lr * m_hat * r_t * l_t
        else:
            new_p = pf - lr * m_hat
        self._set_accumulator(p, "moment1", m)
        self._set_accumulator(p, "moment2", v)
        return new_p.to(pd.dtype)


class Adadelta(Optimizer):
    """Adadelta (reference ``python/paddle/optimizer/adadelta.py``):
    running averages of g² and of the update², the scaled delta."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)
        self._rho = float(rho)
        self._epsilon = float(epsilon)

    def _update_param(self, p, pd, gd, lr, wd):
        asg = self._get_accumulator(p, "avg_squared_grad",
                                    dtype=torch.float32)
        asu = self._get_accumulator(p, "avg_squared_update",
                                    dtype=torch.float32)
        rho, eps = self._rho, self._epsilon
        g = gd.float()
        asg = rho * asg + (1 - rho) * g * g
        delta = -torch.sqrt((asu + eps) / (asg + eps)) * g
        asu = rho * asu + (1 - rho) * delta * delta
        self._set_accumulator(p, "avg_squared_grad", asg)
        self._set_accumulator(p, "avg_squared_update", asu)
        return (pd.float() + lr * delta).to(pd.dtype)


class Rprop(Optimizer):
    """Resilient backprop, full-batch rule (reference
    ``python/paddle/optimizer/rprop.py``): per-element learning rates in
    ``learning_rate_range``, multiplied by ``etas`` on sign agreement;
    a sign flip skips the step and zeroes the stored gradient."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = map(float, learning_rate_range)
        self._eta_neg, self._eta_pos = map(float, etas)
        self._init_lr = float(learning_rate) if isinstance(
            learning_rate, (int, float)) else 0.001

    def _update_param(self, p, pd, gd, lr, wd):
        prev = self._get_accumulator(p, "prev_grad", dtype=torch.float32)
        slots = self._accumulators.setdefault(id(p), {})
        if "learning_rates" not in slots:
            slots["learning_rates"] = torch.full(
                pd.shape, self._init_lr, dtype=torch.float32,
                device=pd.device)
        lrs = slots["learning_rates"]
        g, pf = gd.float(), pd.float()
        sign = torch.sign(g * prev)
        lrs = torch.clamp(
            torch.where(sign > 0, lrs * self._eta_pos,
                        torch.where(sign < 0, lrs * self._eta_neg, lrs)),
            self._lr_min, self._lr_max)
        flip = sign < 0
        g_eff = torch.where(flip, torch.zeros_like(g), g)
        new_p = torch.where(flip, pf, pf - torch.sign(g) * lrs)
        self._set_accumulator(p, "prev_grad", g_eff)
        slots["learning_rates"] = lrs
        return new_p.to(pd.dtype)


class ASGD(Optimizer):
    """SAG-style averaged stochastic gradient (reference
    ``python/paddle/optimizer/asgd.py``): a running sum ``d`` over the
    last ``batch_num`` per-index gradients."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        if batch_num <= 0:
            raise ValueError("batch_num must be positive")
        self._n = int(batch_num)
        self._wd = float(weight_decay) if isinstance(
            weight_decay, (int, float)) else (
                weight_decay.coeff if weight_decay is not None else 0.0)

    def _update_param(self, p, pd, gd, lr, wd):
        d = self._get_accumulator(p, "d", dtype=torch.float32)
        slots = self._accumulators.setdefault(id(p), {})
        m = slots.get("_m", 0)
        if "ys" not in slots:
            slots["ys"] = torch.zeros((self._n,) + tuple(pd.shape),
                                      dtype=torch.float32, device=pd.device)
        i = m % self._n
        g, pf = gd.float(), pd.float()
        d = d - slots["ys"][i] + g
        n_eff, wd32 = _f32(min(m + 1, self._n)), _f32(self._wd)
        new_p = pf - lr * (d / n_eff + wd32 * pf)
        slots["ys"][i] = g
        slots["_m"] = m + 1
        self._set_accumulator(p, "d", d)
        return new_p.to(pd.dtype)
