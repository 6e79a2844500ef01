"""The port's training guardian against ``paddle_tpu``'s.

As the reference's ``tests/test_guardian.py``, its state machine and its
compiled path:

- on one seeded sequence of losses and gradient norms (NaNs, infs and
  spikes among them), ``TrainingGuardian.observe`` gives the reference's
  decisions, f32 spike ceilings, skips, rollbacks, events and abort
  bundle;
- ``GuardedTrainStep`` over each package's ``CompiledTrainStep`` on a
  2-layer tiny Llama (fp32), with ``guard.nan_loss``, ``guard.loss_spike``
  and ``guard.nan_grad`` armed: the same decisions, and the same state
  after the rollback within the fp32 tolerance of
  ``tests/test_torch_train_step.py`` (rtol 1e-5); a recovered run ends
  bit for bit where the clean run does;
- the clean guarded step is the plain step bit for bit, a skipped step
  leaves the state and the step count as they were, and the
  ``train.step`` point fires hit for hit.

The hapi and ``GradScaler`` cases of the reference wait for those
modules (ROADMAP.md Queue 1, items 4 and 9).
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.ckpt_commit import \
    CheckpointManager as JaxManager
from paddle_tpu.models import CompiledTrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.training import GuardedTrainStep as JaxGuarded
from paddle_tpu.training import GuardianAbort as JaxAbort
from paddle_tpu.training import GuardianPolicy as JaxPolicy
from paddle_tpu.training import TrainingGuardian as JaxGuardian
from paddle_tpu.training.guardian import \
    _flatten_train_state as jax_flatten
from paddle_tpu_torch.distributed.ckpt_commit import CheckpointManager
from paddle_tpu_torch.models import (
    CompiledTrainStep, LlamaConfig, LlamaForCausalLM, load_numpy_state,
)
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.training import (
    Decision, GuardedTrainStep, GuardianAbort, GuardianPolicy,
    TrainingGuardian,
)
from paddle_tpu_torch.training.guardian import (
    _flatten_train_state, _unflatten_train_state, guardian_for_model,
)

N_STEPS = 10
POLICY = dict(window=8, min_history=4, skip_budget=2, rollback_budget=2,
              checkpoint_every=4)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


# -- the state machine ---------------------------------------------------------

def test_policy_validation():
    for kw in (dict(window=1), dict(min_history=0),
               dict(budget_backoff=0.0), dict(budget_backoff=1.5)):
        with pytest.raises(ValueError):
            GuardianPolicy(**kw)
        with pytest.raises(ValueError):
            JaxPolicy(**kw)


def _sequence(seed=5, n=40, rate=1.0):
    """(loss, grad_norm) pairs: a noisy decaying curve with NaN, inf,
    NaN-gradient and spike bursts (about 30% of the steps after the
    warm-up, times ``rate``), seeded."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        loss = float(3.0 * np.exp(-i / 30) + 0.05 * rng.randn())
        gnorm = float(abs(rng.randn()) + 0.5)
        r = rng.rand() / rate
        if i > 6 and r < 0.08:
            loss = float("nan")
        elif i > 6 and r < 0.14:
            loss = float("inf")
        elif i > 6 and r < 0.20:
            gnorm = float("nan")
        elif i > 6 and r < 0.30:
            loss *= 50.0
        out.append((loss, gnorm))
    return out


def _drive(g, seq):
    """Feed the sequence as GuardedTrainStep does (the f32 ceiling as the
    gate's threshold); returns the trace and the abort bundle, if any."""
    trace = []
    try:
        for loss, gnorm in seq:
            thr = float(np.float32(g.spike_threshold()))
            d = g.observe(loss, gnorm, threshold=thr)
            trace.append((d.value, thr))
            if d.value == "rollback":
                trace.append(("restored", g.rollback()))
    except (GuardianAbort, JaxAbort) as e:
        return trace, e.bundle, str(e)
    return trace, None, None


def _np_state(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 6).astype(np.float32),
            "b": rng.randn(6).astype(np.float32)}


@pytest.mark.parametrize("seed,rate", [(5, 1.0), (11, 1.0), (23, 1.0),
                                       (5, 3.0)])
def test_observe_matches_the_reference(tmp_path, seed, rate):
    committed = _np_state(1)
    applied = {}
    mgr = CheckpointManager(str(tmp_path / "p"))
    mgr.save({k: torch.from_numpy(v) for k, v in committed.items()}, 3)
    g = TrainingGuardian(
        GuardianPolicy(window=8, min_history=4, skip_budget=2,
                       budget_backoff=0.5, rollback_budget=2),
        manager=mgr,
        state_fn=lambda: {k: torch.zeros(v.shape)
                          for k, v in committed.items()},
        apply_fn=applied.update)
    jmgr = JaxManager(str(tmp_path / "r"), world_size=1, rank=0)
    jmgr.save(dict(committed), 3)
    japplied = {}
    jg = JaxGuardian(
        JaxPolicy(window=8, min_history=4, skip_budget=2,
                  budget_backoff=0.5, rollback_budget=2),
        manager=jmgr,
        state_fn=lambda: {k: np.zeros_like(v) for k, v in committed.items()},
        apply_fn=japplied.update)
    seq = _sequence(seed, rate=rate)
    mine, theirs = _drive(g, seq), _drive(jg, seq)
    assert mine[0] == theirs[0]                 # decisions and ceilings
    assert mine[1] == theirs[1]                 # the abort bundle
    assert mine[2] == theirs[2]                 # the diagnosis
    for attr in ("skips", "rollbacks", "total_anomalies", "steps_seen",
                 "events", "_skip_budget", "_anomaly_run"):
        assert getattr(g, attr) == getattr(jg, attr), attr
    assert any(d == "skip" for d, _ in mine[0])
    assert (mine[1] is not None) is (rate > 1.0)    # the ladder's end
    if g.rollbacks:
        for k, v in committed.items():
            assert np.array_equal(applied[k].numpy(), v)
            assert np.array_equal(np.asarray(japplied[k]), v)


def test_spike_threshold_and_classify_as_the_reference():
    g = TrainingGuardian(GuardianPolicy(window=8, min_history=4))
    jg = JaxGuardian(JaxPolicy(window=8, min_history=4))
    for v in (2.0, 2.1, 1.9, 2.0, 5.0, 5.0):
        g.observe(v)
        jg.observe(v)
        assert g.spike_threshold() == jg.spike_threshold()
    for args in ((float("nan"),), (float("inf"),), (1.0, float("nan")),
                 (100.0, None, 10.0), (1.0, 2.0, 10.0)):
        assert g.classify(*args) == jg.classify(*args)


def test_abort_directly_without_rollback_source():
    g = TrainingGuardian(GuardianPolicy(window=8, min_history=2,
                                        skip_budget=1))
    assert g.observe(float("inf")) is Decision.SKIP
    with pytest.raises(GuardianAbort) as ei:
        g.observe(float("inf"))
    assert ei.value.bundle["rank"] == 0


def test_guardian_for_model_waits_for_hapi():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, "
                       "item 9"):
        guardian_for_model(None, None)


# -- the compiled path ---------------------------------------------------------

def _np_model_state(model):
    return {k: np.array(v._data, dtype=np.float32)
            for k, v in model.state_dict().items()}


def _steps(lr=1e-2):
    """(port CompiledTrainStep, paddle_tpu CompiledTrainStep) over a
    2-layer tiny Llama on the same weights, fp32."""
    paddle.seed(11)
    jmodel = JaxLlama(JaxConfig.tiny())
    cfg = LlamaConfig(**{f.name: getattr(jmodel.config, f.name)
                         for f in fields(LlamaConfig)})
    assert cfg.num_hidden_layers == 2
    pmodel = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state(pmodel, _np_model_state(jmodel))
    return (CompiledTrainStep(pmodel, lr=lr, device="cpu"),
            JaxTrainStep(jmodel, lr=lr, donate=False))


def _batch(i):
    ids = np.random.RandomState(1000 + i).randint(0, 256, (2, 16))
    return ids.astype(np.int64), np.roll(ids, -1, axis=-1).astype(np.int64)


def _master(step):
    return {k: np.asarray(v, np.float32)
            for k, v in step.state_dict()["master"].items()}


def _assert_close(a, b, rtol=1e-5):
    assert sorted(a) == sorted(b)
    for k in a:
        err = np.linalg.norm(a[k] - b[k])
        assert err <= rtol * np.linalg.norm(b[k]), (k, err)


def _run_guarded(step, manager, n=N_STEPS):
    g_cls = GuardedTrainStep if isinstance(step, CompiledTrainStep) \
        else JaxGuarded
    pol = (GuardianPolicy if g_cls is GuardedTrainStep else JaxPolicy)(
        **POLICY)
    g = g_cls(step, manager=manager, policy=pol)
    decisions, after_rollback = [], None
    while g.global_step < n:
        _, d = g.step(*_batch(g.global_step + 1))
        decisions.append((g.global_step, d.value))
        if d.value == "rollback" and after_rollback is None:
            after_rollback = _master(step)
    return g, decisions, after_rollback


@pytest.mark.parametrize("burst", [
    "guard.nan_loss:before:5=inject",
    "guard.loss_spike:before:5=inject:1e4",
    "guard.nan_grad:before:5=inject",
])
def test_guarded_train_step_as_the_reference(tmp_path, burst):
    """An anomaly burst at step 5 (skip, skip, rollback to the commit of
    step 4) in each package: the same decisions, the state after the
    rollback the committed step's (bit for bit in each package; rtol
    1e-5 across them), and a finished run within rtol 1e-5 of the
    reference's and bit for bit the port's clean run."""
    spec = ",".join([burst] * 3)
    port, ref = _steps()
    clean, _ = _steps()
    out = []
    for step, fm, mgr_cls, root in (
            (port, faults, CheckpointManager, "p"),
            (ref, jfaults, JaxManager, "r")):
        fm.reset(spec)
        kw = {} if mgr_cls is CheckpointManager else dict(world_size=1,
                                                          rank=0)
        mgr = mgr_cls(str(tmp_path / root), **kw)
        g, decisions, restored = _run_guarded(step, mgr)
        assert g.guardian.skips == 2 and g.guardian.rollbacks == 1
        # the rolled-back state is the step-4 commit, bit for bit
        flat = {k: np.zeros_like(v) for k, v in
                jax_flatten(ref.state_dict()).items()} \
            if step is ref else {k: torch.zeros_like(v) for k, v in
                                 _flatten_train_state(
                                     port.state_dict()).items()}
        assert mgr.load(flat, step=4) == 4
        committed = {k[len("master/"):]: np.asarray(v, np.float32)
                     for k, v in flat.items() if k.startswith("master/")}
        for k, v in committed.items():
            assert np.array_equal(restored[k], v), k
        out.append((decisions, restored, _master(step),
                    g.guardian.events))
        fm.disarm_all()
    assert out[0][0] == out[1][0]
    assert [e[:2] for e in out[0][3]] == [e[:2] for e in out[1][3]]
    _assert_close(out[0][1], out[1][1])
    _assert_close(out[0][2], out[1][2])
    # the recovered run ends where an uninjected run ends, bit for bit
    gc, _, _ = _run_guarded(clean, None)
    for k, v in _master(clean).items():
        assert np.array_equal(v, out[0][2][k]), k


def test_each_package_rolls_back_from_the_other_s_commit(tmp_path):
    """The flat names are the reference's: a commit of either train step
    loads into the other's template and applies."""
    port, ref = _steps()
    for i in range(2):
        port.step(*_batch(i))
        ref.step(*_batch(i))
    JaxManager(str(tmp_path / "r"), world_size=1, rank=0).save(
        jax_flatten(ref.state_dict()), 2)
    other, jother = _steps()
    template = _flatten_train_state(other.state_dict())
    assert CheckpointManager(str(tmp_path / "r")).load(template) == 2
    other.set_state_dict(_unflatten_train_state(template))
    assert other._t == 2
    _assert_close(_master(other), _master(ref), rtol=0)
    CheckpointManager(str(tmp_path / "p")).save(
        _flatten_train_state(port.state_dict()), 2)
    jtemplate = {k: np.zeros_like(v) for k, v in
                 jax_flatten(jother.state_dict()).items()}
    JaxManager(str(tmp_path / "p"), world_size=1, rank=0).load(jtemplate)
    assert int(np.asarray(jtemplate["t"])) == 2
    for k, v in _master(port).items():
        assert np.array_equal(np.asarray(jtemplate[f"master/{k}"]), v), k


def test_guarded_clean_step_is_the_plain_step_bit_for_bit():
    plain, _ = _steps()
    guarded, _ = _steps()
    for i in range(4):
        want = plain.step(*_batch(i))
        loss, gnorm, ok = guarded.guarded_step(float("inf"), *_batch(i))
        assert ok and np.isfinite(gnorm) and loss == float(want)
    assert plain._t == guarded._t == 4
    for tree in ("params", "_master", "_m", "_v"):
        a, b = getattr(plain, tree), getattr(guarded, tree)
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)


@pytest.mark.parametrize("spec", [
    "guard.nan_loss:before:1=inject",
    "guard.nan_grad:before:1=inject",
    "guard.loss_spike:before:1=inject:1e6",
])
def test_skip_preserves_state_found_inf_semantics(spec):
    ts, _ = _steps()
    ts.guarded_step(float("inf"), *_batch(1))
    snap = {name: {k: v.clone() for k, v in getattr(ts, name).items()}
            for name in ("params", "_master", "_m", "_v")}
    t0 = ts._t
    faults.reset(spec)
    loss, gnorm, ok = ts.guarded_step(1e3, *_batch(2))
    assert not ok
    if "nan_loss" in spec:
        assert not np.isfinite(loss)
    elif "nan_grad" in spec:
        assert np.isfinite(loss) and not np.isfinite(gnorm)
    else:
        assert loss > 1e3
    assert ts._t == t0
    for name, tree in snap.items():
        for k, v in tree.items():
            assert torch.equal(getattr(ts, name)[k], v), (name, k)
    _, _, ok2 = ts.guarded_step(1e3, *_batch(2))
    assert ok2


def test_persistent_anomaly_aborts_with_bundle(tmp_path):
    ts, _ = _steps()
    g = GuardedTrainStep(
        ts, manager=CheckpointManager(str(tmp_path)),
        policy=GuardianPolicy(window=8, min_history=4, skip_budget=1,
                              rollback_budget=1))
    for i in range(3):
        g.step(*_batch(i + 1))
    faults.reset("guard.nan_loss:before:*=inject")
    with pytest.raises(GuardianAbort) as ei:
        for _ in range(8):
            g.step(*_batch(g.global_step + 1))
    b = ei.value.bundle
    assert b["monitor"] == "nan_loss" and b["rollbacks"] == 1
    assert b["rank"] == 0 and len(b["loss_window"]) == 3


def test_train_step_point_hit_for_hit():
    """``train.step`` fires before and after each ``step`` and each
    ``guarded_step`` in either package, as many times."""
    port, ref = _steps()
    hits = []
    for step, fm in ((port, faults), (ref, jfaults)):
        specs = [fm.arm("train.step", ph, "*", "delay", "0")
                 for ph in ("before", "after")]
        step.step(*_batch(0))
        step.guarded_step(float("inf"), *_batch(1))
        step.step(*_batch(2))
        hits.append([s.hits for s in specs])
    assert hits[0] == hits[1] == [3, 3]
    faults.reset("train.step:before:2=raise")
    with pytest.raises(faults.InjectedFault):
        for i in range(3):
            port.step(*_batch(i))
