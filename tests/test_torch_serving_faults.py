"""The port's serving fault points against ``paddle_tpu``'s.

Every point the port wires into serving (``serve.*``, ``prefix.*``,
``spec.*``, ``async.*``, ``quant.*``) sits at the reference's place in
the control flow, so one armed spec trips at the same hit in both
packages.  For each point x phase, an armed ``raise`` under a seeded
load, each package's engine driven by its own
``run_load(on_error="continue")``, must leave both engines in the
same state: the same number of escaped faults, every request's tokens
and final state equal token for token (a ``serve.request`` or ``quant.*``
raise fails one request alone; any other escapes the step and the
next step carries on, so the streams are the fault-free ones), the
port's page pool consistent (``check_pool_invariants``) after every
step, and the engine serving a new request exactly after.  Then the
reference's single-point cases: ``async.replan`` on a cancel,
``quant.pack`` failing the build, and ``aot.lower`` / ``aot.compile``
failing one warmup entry only (the warmup then serves as a clean warm
engine does).

The weights are the port's seeded tiny Llama
(``testing.durability_worker.build("tiny", ...)``: vocab 256, hidden 64,
2 layers, 4 heads, 2 kv heads, fp32) loaded into the reference's model
through ``models.numpy_state``.  Streams must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.models.llama import _rope_tables
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.testing import load as jload
from paddle_tpu_torch.inference.server import (
    ServingEngine, check_pool_invariants,
)
from paddle_tpu_torch.models import numpy_state
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.durability_worker import build
from paddle_tpu_torch.testing import load
from paddle_tpu_torch.testing.load import LoadSpec, generate_load

BASE = dict(max_seqs=2, page_size=4, max_len=64, prefill_chunk=8)
LOAD = dict(n_requests=5, mean_interarrival=1.0, prompt_len=(4, 14),
            max_new=(4, 8), vocab=256, seed=3)
#: per serving variant: the engine's arguments and the load that makes
#: each of its points fire at least twice (the undersized prefix pool
#: evicts and copies on write; the repetitive load drafts)
CASES = {
    "plain": (BASE, LOAD),
    "prefix": (dict(BASE, num_pages=11, prefix_cache=True),
               dict(LOAD, prefix_share=0.8, prefix_len=10,
                    prefix_pool=2)),
    "spec": (dict(BASE, spec_decode="ngram"),
             dict(LOAD, repeat_share=0.8, repeat_period=3,
                  max_new=(8, 12))),
    "async": (dict(BASE, async_exec=True), LOAD),
    "async_spec": (dict(BASE, async_exec=True, spec_decode="ngram"),
                   dict(LOAD, repeat_share=0.8, repeat_period=3,
                        max_new=(8, 12))),
    "quant": (dict(BASE, quant="int8"), LOAD),
}
POINTS = [
    ("serve.step", "plain"), ("serve.decode", "plain"),
    ("serve.admit", "plain"), ("serve.request", "plain"),
    ("prefix.match", "prefix"), ("prefix.cow", "prefix"),
    ("prefix.evict", "prefix"),
    ("spec.draft", "spec"), ("spec.verify", "spec"),
    ("spec.rollback", "spec"),
    ("async.plan", "async"), ("async.commit", "async"),
    ("async.commit", "async_spec"), ("spec.verify", "async_spec"),
    ("quant.kv_write", "quant"), ("quant.dequant", "quant"),
]
PROMPT = np.random.RandomState(3).randint(1, 256, (9,)).astype(np.int32)


def reference_tiny_llama(params, cfg):
    """The reference's tiny Llama on the port's ``params``: built under
    ``jax.eval_shape`` after ``paddle.seed(11)`` (its initializers compile
    nothing and advance the generator as an eager build does), its rope
    tables computed eagerly, every parameter set from ``params``."""
    jcfg = JaxConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)
    paddle.seed(11)
    paddle.get_rng_state()      # the key made eagerly, not under the trace
    box = {}

    def build():
        box["m"] = LlamaForCausalLM(jcfg)
        return {k: p._data for k, p in box["m"].named_parameters()}

    jax.eval_shape(build)
    model = box["m"]
    cos, sin = _rope_tables(jcfg)
    model.llama.rope_cos._data = jnp.asarray(cos)
    model.llama.rope_sin._data = jnp.asarray(sin)
    model.eval()
    missing, unknown = model.set_state_dict(numpy_state(params, cfg))
    assert not missing and not unknown
    return model


@pytest.fixture(scope="module")
def pair():
    cfg, params, _, _ = build("tiny", "cpu")
    return reference_tiny_llama(params, cfg), cfg, params


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


def _engines(pair, kw):
    model, cfg, params = pair
    return (ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                          **kw),
            JaxEngine(model, **kw))


_SHARED = {}


def _shared(pair, case):
    """One engine pair per serving variant, shared by that variant's
    cases (the reference's engine compiles its programs per instance):
    each case drives both engines through the same sequence, under
    rids of its own, so the two stay mirrors of each other."""
    if case not in _SHARED:
        _SHARED[case] = _engines(pair, CASES[case][0])
    return _SHARED[case]


class _Audited:
    """The engine, with its page pool checked after every step."""

    def __init__(self, eng):
        self._eng = eng

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def step(self):
        try:
            return self._eng.step()
        finally:
            check_pool_invariants(self._eng.executor.cache, self._eng.prefix)


def _drive(eng, work, load_mod, tag):
    """``run_load(on_error="continue")`` of the engine's own package,
    arrivals counted from the engine's current tick and rids prefixed by
    ``tag``; returns ({rid: (tokens, state)}, escaped faults)."""
    work = [dict(w, rid=tag + w["rid"],
                 arrival_tick=w["arrival_tick"] + eng.tick) for w in work]
    out = load_mod.run_load(eng, work, on_error="continue")
    return ({r: (h.tokens, h.state.value)
             for r, h in out["handles"].items()}, len(out["errors"]))


def _fresh(eng, rid):
    """One more request after the load: the engine must still serve."""
    h = eng.submit(PROMPT, max_new_tokens=6, rid=rid)
    t0 = eng.tick
    while h.state.value not in ("finished", "truncated", "failed"):
        assert eng.tick < t0 + 100
        eng.step()
    return h.tokens, h.state.value


@pytest.mark.parametrize("phase", ["before", "after"])
@pytest.mark.parametrize("point,case", POINTS,
                         ids=[f"{p}-{c}" for p, c in POINTS])
def test_fault_matches_reference(pair, point, case, phase):
    work = generate_load(LoadSpec(**CASES[case][1]))
    eng, jeng = _shared(pair, case)
    tag = f"{point}:{phase}:"
    faults.arm(point, phase, 2, "raise")
    jfaults.arm(point, phase, 2, "raise")
    got, errors = _drive(_Audited(eng), work, load, tag)
    want, jerrors = _drive(jeng, work, jload, tag)
    assert errors == jerrors, (errors, jerrors)
    assert got == want
    confined = point == "serve.request" or point.startswith("quant.")
    failed = [r for r, (_, st) in got.items() if st == "failed"]
    if confined:
        assert errors == 0 and len(failed) == 1, (errors, failed)
    else:
        assert errors == 1 and not failed, (errors, failed)
    faults.reset("")
    jfaults.reset("")
    assert _fresh(eng, tag) == _fresh(jeng, tag)
    check_pool_invariants(eng.executor.cache, eng.prefix)
    if eng.prefix is None:
        assert eng.executor.free_pages == eng.executor.cache.num_pages


def _run_with_cancel(eng, fmod, tag):
    """Two requests; cancel the first once it has streamed 3 tokens and
    a next-step plan is parked: the commit-side finish then invalidates
    the parked plan (``async.replan``)."""
    a, b = tag + "a", tag + "b"
    replans = eng.scheduler.replans
    eng.submit(PROMPT, max_new_tokens=30, rid=a)
    hb = eng.submit(PROMPT[:5], max_new_tokens=30, rid=b)
    got, cancelled, errors = {a: [], b: []}, False, 0
    t0 = eng.tick
    while eng.scheduler.has_work():
        assert eng.tick < t0 + 500
        try:
            out = eng.step()
        except fmod.InjectedFault:
            errors += 1
            continue
        for rid, toks in out.items():
            got[rid].extend(toks)
        if not cancelled and len(got[a]) >= 3 \
                and eng.scheduler._pending is not None:
            eng.cancel(a)
            cancelled = True
    return hb.tokens, errors, eng.scheduler.replans - replans


@pytest.mark.parametrize("phase", ["before", "after"])
def test_async_replan_fault(pair, phase):
    eng, jeng = _shared(pair, "async")
    faults.arm("async.replan", phase, 1, "raise")
    jfaults.arm("async.replan", phase, 1, "raise")
    got = _run_with_cancel(eng, faults, f"replan:{phase}:")
    want = _run_with_cancel(jeng, jfaults, f"replan:{phase}:")
    assert got == want and got[1] == 1     # (tokens, faults, replans)
    assert got[2] == (phase == "after")
    check_pool_invariants(eng.executor.cache)
    assert eng.executor.free_pages == eng.executor.cache.num_pages


@pytest.mark.parametrize("phase", ["before", "after"])
def test_quant_pack_fault_fails_the_build(pair, phase):
    kw = dict(BASE, quant="int8")
    faults.arm("quant.pack", phase, 2, "raise")
    with pytest.raises(faults.InjectedFault):
        _engines(pair, kw)
    faults.reset("")
    eng, jeng = _engines(pair, kw)
    assert _fresh(eng, "x") == _fresh(jeng, "x")


@pytest.mark.parametrize("point", ["aot.lower", "aot.compile"])
@pytest.mark.parametrize("phase", ["before", "after"])
def test_warmup_fault_fails_only_that_entry(pair, point, phase):
    """A raise around one warmup capture records that rung as failed;
    the others capture, the ladder is armed and the engine serves (the
    failed rung captures at its first call, which fires no point)."""
    model, cfg, params = pair
    eng = ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                        **dict(BASE, aot="off"))
    faults.arm(point, phase, 1, "raise")
    rep = eng.executor.aot_warmup(prefill_chunk=8)
    assert len(rep["failed"]) == 1, rep["failed"]
    assert rep["failed"][0][0] == "serve.decode"
    assert rep["capture"] == rep["entries"] - 1
    assert eng.executor.aot_ladder is not None
    faults.reset("")
    # the same ladder, warmed cleanly (held against the reference's
    # warm engine in test_torch_aot.py)
    clean = ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                          **dict(BASE, aot="warm"))
    assert not clean._aot_report["failed"]
    assert _fresh(eng, "x") == _fresh(clean, "x")
