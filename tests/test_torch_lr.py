"""The port's LR schedulers (``paddle_tpu_torch.optimizer.lr``) against
``paddle_tpu.optimizer.lr``: each of the 17 schedules, built with the
same arguments in both packages, gives the same 50 rates (the same
Python arithmetic, so equal floats), and a state dict carries a
schedule across instances.  The train step reads a scheduler as the
reference does: ``lr()`` before each step, then ``step()``."""
import numpy as np
import pytest

import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer.lr as plr
from paddle_tpu_torch import optimizer as popt

# name -> (constructor arguments) for both packages; a callable
# argument gives each package its own instance
SCHEDULES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay(boundaries=[5, 20],
                                                 values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(
        0.1, decay_steps=20, end_lr=0.001, power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=30), warmup_steps=10,
        start_lr=0.0, end_lr=0.1),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=30),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[10, 25, 40],
                                                 gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1,
                                                           lambda e: 0.97),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=20, eta_min=0.001),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=7, T_mult=2),
    "OneCycleLR": lambda m: m.OneCycleLR(max_learning_rate=0.1,
                                         total_steps=50),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, patience=2,
                                                   factor=0.5, cooldown=1),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                     mode="triangular2"),
}

#: a loss curve for ReduceOnPlateau: falls, then stalls
METRICS = np.concatenate([np.linspace(2.0, 1.0, 15),
                          np.full(35, 1.0)]).tolist()


def _sequence(sched, n=50, plateau=False):
    out = []
    for i in range(n):
        out.append(float(sched()))
        if plateau:
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


def test_every_schedule_is_covered():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)
             and getattr(jlr, n) is not jlr.LRScheduler}
    assert names == set(SCHEDULES) and len(names) == 17
    assert all(getattr(popt, n) is getattr(plr, n) for n in names)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    plateau = name == "ReduceOnPlateau"
    want = _sequence(SCHEDULES[name](jlr), plateau=plateau)
    got = _sequence(SCHEDULES[name](plr), plateau=plateau)
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize("name", ["LinearWarmup", "StepDecay",
                                  "MultiplicativeDecay", "ReduceOnPlateau"])
def test_state_dict_resumes(name):
    """20 steps, a state dict into a fresh instance, 20 more: the same
    rates as 40 steps of one instance."""
    plateau = name == "ReduceOnPlateau"
    whole = _sequence(SCHEDULES[name](plr), n=40, plateau=plateau)
    first = SCHEDULES[name](plr)
    head = _sequence(first, n=20, plateau=plateau)
    second = SCHEDULES[name](plr)
    second.set_state_dict(first.state_dict())
    tail = []
    for i in range(20):
        tail.append(float(second()))
        second.step(METRICS[20 + i]) if plateau else second.step()
    assert head + tail == whole
