"""L-BFGS with the strong-Wolfe line search.

Counterpart of ``paddle_tpu/optimizer/lbfgs.py`` (reference
``python/paddle/optimizer/lbfgs.py:120``: Nocedal & Wright's two-loop
recursion, Algorithm 7.5, and the strong-Wolfe cubic line search).  The
reference keeps the flat parameters, gradients and the (s, y) history
as float64 numpy vectors on the host; here they are float64 tensors on
the parameters' device, in the same order of operations, and only the
scalars that steer the control flow (``gtd``, ``ys``, losses, norms)
are read to the host, as the reference reads them.  ``step`` takes a
closure that re-evaluates the loss and its gradients.
"""
from __future__ import annotations

import math

import torch

from .optimizer import Optimizer


def _gather_flat(params, attr):
    outs = []
    for p in params:
        if attr == "data":
            outs.append(p.detach().reshape(-1).double())
        elif p.grad is None:
            outs.append(torch.zeros(p.numel(), dtype=torch.float64,
                                    device=p.device))
        else:
            outs.append(p.grad.detach().reshape(-1).double())
    return torch.cat(outs)


def _dot(a, b):
    return float(a @ b)


def _absmax(v):
    return float(v.abs().max()) if v.numel() else 0.0


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    # reference lbfgs.py _cubic_interpolate (Nocedal & Wright eq. 3.59)
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 * d1 - g1 * g2
    if d2_square >= 0:
        d2 = math.sqrt(d2_square)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1)
                                        / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1)
                                        / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


class LBFGS(Optimizer):
    """L-BFGS (reference optimizer/lbfgs.py:120).  ``step(closure)``
    returns the loss of the last evaluation (a 0-d fp32 tensor)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        if max_eval is None:
            max_eval = max_iter * 5 // 4
        super().__init__(learning_rate=learning_rate,
                         parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        self.max_iter = int(max_iter)
        self.max_eval = int(max_eval)
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("only 'strong_wolfe' is supported")
        self.line_search_fn = line_search_fn
        self._state = {"func_evals": 0, "n_iter": 0,
                       "old_sks": [], "old_yks": [], "ro": [],
                       "d": None, "t": None, "prev_flat_grad": None,
                       "H_diag": 1.0}

    # -- flat parameter io --------------------------------------------------
    @torch.no_grad()
    def _set_flat(self, flat):
        offset = 0
        for p in self._parameter_list():
            n = p.numel()
            p.copy_(flat[offset:offset + n].reshape(p.shape).to(p.dtype))
            offset += n

    def _directional_evaluate(self, closure, x, t, d):
        self._set_flat(x + t * d)
        loss = float(closure())
        flat_grad = _gather_flat(self._parameter_list(), "grad")
        self._state["func_evals"] += 1
        return loss, flat_grad

    # -- strong wolfe (reference _strong_wolfe) ------------------------------
    def _strong_wolfe(self, closure, x, t, d, f, g, gtd,
                      c1=1e-4, c2=0.9, tolerance_change=1e-9,
                      max_ls=25):
        d_norm = _absmax(d)
        g = g.clone()
        f_new, g_new = self._directional_evaluate(closure, x, t, d)
        ls_func_evals = 1
        gtd_new = _dot(g_new, d)
        t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
        done = False
        ls_iter = 0
        while ls_iter < max_ls:
            if f_new > (f + c1 * t * gtd) or \
                    (ls_iter > 1 and f_new >= f_prev):
                bracket = [t_prev, t]
                bracket_f = [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone()]
                bracket_gtd = [gtd_prev, gtd_new]
                break
            if abs(gtd_new) <= -c2 * gtd:
                bracket = [t, t]
                bracket_f = [f_new, f_new]
                bracket_g = [g_new, g_new]
                bracket_gtd = [gtd_new, gtd_new]
                done = True
                break
            if gtd_new >= 0:
                bracket = [t_prev, t]
                bracket_f = [f_prev, f_new]
                bracket_g = [g_prev, g_new.clone()]
                bracket_gtd = [gtd_prev, gtd_new]
                break
            min_step = t + 0.01 * (t - t_prev)
            max_step = t * 10
            tmp = t
            t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new,
                                   gtd_new, bounds=(min_step, max_step))
            t_prev, f_prev, g_prev, gtd_prev = \
                tmp, f_new, g_new.clone(), gtd_new
            f_new, g_new = self._directional_evaluate(closure, x, t, d)
            ls_func_evals += 1
            gtd_new = _dot(g_new, d)
            ls_iter += 1
        else:
            bracket = [0, t]
            bracket_f = [f, f_new]
            bracket_g = [g, g_new]
            bracket_gtd = [gtd, gtd_new]

        insuf_progress = False
        low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] \
            else (1, 0)
        while not done and ls_iter < max_ls:
            if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
                break
            t = _cubic_interpolate(bracket[0], bracket_f[0],
                                   bracket_gtd[0], bracket[1],
                                   bracket_f[1], bracket_gtd[1])
            eps = 0.1 * (max(bracket) - min(bracket))
            if min(max(bracket) - t, t - min(bracket)) < eps:
                if insuf_progress or t >= max(bracket) or \
                        t <= min(bracket):
                    if abs(t - max(bracket)) < abs(t - min(bracket)):
                        t = max(bracket) - eps
                    else:
                        t = min(bracket) + eps
                    insuf_progress = False
                else:
                    insuf_progress = True
            else:
                insuf_progress = False
            f_new, g_new = self._directional_evaluate(closure, x, t, d)
            ls_func_evals += 1
            gtd_new = _dot(g_new, d)
            ls_iter += 1
            if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
                bracket[high_pos] = t
                bracket_f[high_pos] = f_new
                bracket_g[high_pos] = g_new.clone()
                bracket_gtd[high_pos] = gtd_new
                low_pos, high_pos = (0, 1) \
                    if bracket_f[0] <= bracket_f[1] else (1, 0)
            else:
                if abs(gtd_new) <= -c2 * gtd:
                    done = True
                elif gtd_new * (bracket[high_pos]
                                - bracket[low_pos]) >= 0:
                    bracket[high_pos] = bracket[low_pos]
                    bracket_f[high_pos] = bracket_f[low_pos]
                    bracket_g[high_pos] = bracket_g[low_pos]
                    bracket_gtd[high_pos] = bracket_gtd[low_pos]
                bracket[low_pos] = t
                bracket_f[low_pos] = f_new
                bracket_g[low_pos] = g_new.clone()
                bracket_gtd[low_pos] = gtd_new
        t = bracket[low_pos]
        return bracket_f[low_pos], bracket_g[low_pos], t, ls_func_evals

    # -- main step -----------------------------------------------------------
    def step(self, closure=None):
        if closure is None:
            raise RuntimeError("LBFGS.step requires a closure that "
                               "re-evaluates the model and returns "
                               "the loss")
        state = self._state
        lr = self.get_lr()
        orig_loss = closure()
        loss = float(orig_loss)
        state["func_evals"] += 1
        current_evals = 1
        params = self._parameter_list()
        flat_grad = _gather_flat(params, "grad")
        if _absmax(flat_grad) <= self.tolerance_grad:
            return orig_loss

        n_iter = 0
        while n_iter < self.max_iter:
            n_iter += 1
            state["n_iter"] += 1
            if state["n_iter"] == 1:
                d = -flat_grad
                state["old_sks"], state["old_yks"], state["ro"] = \
                    [], [], []
                H_diag = 1.0
            else:
                y = flat_grad - state["prev_flat_grad"]
                s = state["d"] * state["t"]
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(state["old_sks"]) == self.history_size:
                        state["old_sks"].pop(0)
                        state["old_yks"].pop(0)
                        state["ro"].pop(0)
                    state["old_sks"].append(s)
                    state["old_yks"].append(y)
                    state["ro"].append(1.0 / ys)
                    H_diag = ys / _dot(y, y)
                else:
                    H_diag = state["H_diag"]
                # two-loop recursion
                num_old = len(state["old_sks"])
                al = [0.0] * num_old
                q = -flat_grad
                for i in range(num_old - 1, -1, -1):
                    al[i] = _dot(state["old_sks"][i], q) * state["ro"][i]
                    q = q - al[i] * state["old_yks"][i]
                d = q * H_diag
                for i in range(num_old):
                    be_i = _dot(state["old_yks"][i], d) * state["ro"][i]
                    d = d + state["old_sks"][i] * (al[i] - be_i)
            state["H_diag"] = H_diag
            state["prev_flat_grad"] = flat_grad.clone()
            prev_loss = loss
            gtd = _dot(flat_grad, d)
            if gtd > -self.tolerance_change:
                break
            if state["n_iter"] == 1:
                t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
            else:
                t = lr
            x0 = _gather_flat(params, "data")
            if self.line_search_fn == "strong_wolfe":
                loss, flat_grad, t, ls_evals = self._strong_wolfe(
                    closure, x0, t, d, loss, flat_grad, gtd)
                self._set_flat(x0 + t * d)
                current_evals += ls_evals
            else:
                self._set_flat(x0 + t * d)
                loss = float(closure())
                flat_grad = _gather_flat(params, "grad")
                current_evals += 1
                state["func_evals"] += 1
            state["d"], state["t"] = d, t
            if current_evals >= self.max_eval:
                break
            if _absmax(flat_grad) <= self.tolerance_grad:
                break
            if _absmax(d * t) <= self.tolerance_change:
                break
            if abs(loss - prev_loss) < self.tolerance_change:
                break
        dev = params[0].device if params else None
        return torch.tensor(loss, dtype=torch.float32, device=dev)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list():
            p.grad = None

    def state_dict(self):
        s = self._state

        def cpu(v):
            return None if v is None else v.detach().cpu().numpy()

        return {
            "func_evals": s["func_evals"], "n_iter": s["n_iter"],
            "old_sks": [cpu(v) for v in s["old_sks"]],
            "old_yks": [cpu(v) for v in s["old_yks"]],
            "ro": list(s["ro"]), "H_diag": s["H_diag"],
            "d": cpu(s["d"]), "t": s["t"],
            "prev_flat_grad": cpu(s["prev_flat_grad"]),
        }

    def set_state_dict(self, state):
        s = self._state
        params = self._parameter_list()
        dev = params[0].device if params else None

        def dev64(v):
            return torch.as_tensor(v, dtype=torch.float64, device=dev)

        for k in ("func_evals", "n_iter", "ro", "H_diag", "t"):
            if k in state:
                s[k] = state[k]
        for k in ("old_sks", "old_yks"):
            if k in state:
                s[k] = [dev64(v) for v in state[k]]
        for k in ("d", "prev_flat_grad"):
            if k in state and state[k] is not None:
                s[k] = dev64(state[k])
