"""The double-buffered async scheduler of the PyTorch port against its
sync path and ``paddle_tpu``.

Mirrors ``tests/test_async_exec.py`` (its fault-point and telemetry-
registry tests left out: the port has neither yet) on the reference's
tiny Llama (2 layers, hidden 64, vocab 256, ``paddle.seed(11)``) in fp32
on the CPU.  Splitting a step into plan / dispatch / overlap / fence /
commit must not move a token: under a seeded load on an undersized pool
(preemption, and with the prefix cache and speculative decode also hits,
evictions and drafts) the async engine's PER-STEP emission maps equal
the sync engine's and the reference's async engine's, with the pool
invariants after every step.  A cancellation that invalidates a parked
plan is replanned with exact streams.  Every async step makes one
program call and one host read.

On the card (``cuda``): two async steps in flight at once (two pinned
result slots) return the tokens of two sync steps.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu_torch.inference.server import (
    PagedExecutor, RequestState, ServingEngine, check_pool_invariants,
)
from paddle_tpu_torch.models import LlamaConfig, from_numpy_state
from paddle_tpu_torch.testing.load import LoadSpec, generate_load

ENGINE_KW = dict(max_seqs=2, page_size=4, max_len=128)
PROMPT = np.random.RandomState(2).randint(1, 256, (8,)).astype(np.int32)
LOAD = dict(n_requests=8, mean_interarrival=2.0, prompt_len=(4, 12),
            max_new=(6, 10), vocab=256, seed=21, prefix_share=0.6,
            prefix_len=10, prefix_pool=2, repeat_share=0.5,
            repeat_period=3)
TIGHT_KW = dict(max_seqs=2, page_size=4, max_len=64, num_pages=11,
                prefill_chunk=8)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    jcfg = JaxConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=128)
    model = LlamaForCausalLM(jcfg)
    cfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                         for f in fields(LlamaConfig)})
    state = {k: np.asarray(v._data) for k, v in model.state_dict().items()}
    return model, cfg, from_numpy_state(state, cfg, "cpu", torch.float32)


def _engine(pair, **kw):
    _, cfg, params = pair
    return ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                         **dict(ENGINE_KW, **kw))


def _drive(eng, work, check_invariants=False):
    """Replay the seeded load, recording the per-step emission maps."""
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    per_step = []
    while pending or eng.in_flight:
        assert eng.tick < 3000, "load did not drain"
        while pending and pending[0]["arrival_tick"] <= eng.tick:
            w = pending.pop(0)
            eng.submit(w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                       rid=w["rid"])
        per_step.append(eng.step())
        if check_invariants:
            check_pool_invariants(eng.executor.cache,
                                  getattr(eng, "prefix", None))
    return per_step, {w["rid"]: (list(eng.request(w["rid"]).generated),
                                 eng.request(w["rid"]).state.value)
                      for w in work}


# -- the gate ------------------------------------------------------------------

def test_env_gate(pair, monkeypatch):
    monkeypatch.setenv("PT_ASYNC_EXEC", "on")
    assert _engine(pair).scheduler.async_mode
    monkeypatch.setenv("PT_ASYNC_EXEC", "off")
    assert not _engine(pair).scheduler.async_mode
    monkeypatch.delenv("PT_ASYNC_EXEC")
    assert not _engine(pair).scheduler.async_mode
    monkeypatch.setenv("PT_ASYNC_EXEC", "on")           # the argument wins
    assert not _engine(pair, async_exec=False).scheduler.async_mode
    monkeypatch.setenv("PT_ASYNC_EXEC", "eager")
    with pytest.raises(ValueError, match="PT_ASYNC_EXEC"):
        _engine(pair)


def test_off_mode_is_todays_path(pair):
    eng = _engine(pair, async_exec=False)
    want = eng.submit(PROMPT, max_new_tokens=12).result()
    assert eng.executor.async_dispatches == 0
    assert eng.executor.programs["decode"].dispatches > 0
    assert eng.scheduler.replans == 0
    assert eng.scheduler.host_overlap_ratio == 0.0
    on = _engine(pair, async_exec=True)
    assert on.submit(PROMPT, max_new_tokens=12).result() == want
    assert on.executor.async_dispatches > 0


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_async_step_is_one_dispatch(pair, spec):
    """Each async step is one program call (``serve.decode``, or
    ``serve.verify`` under spec) and one async dispatch, whose result
    is read once, through a pinned slot."""
    eng = _engine(pair, async_exec=True, spec_decode=spec)
    eng.submit(PROMPT, max_new_tokens=24)
    eng.submit(np.tile(PROMPT, 2), max_new_tokens=24)
    prog = eng.executor.programs["decode" if spec == "off" else "verify"]
    other = eng.executor.programs["verify" if spec == "off" else "decode"]
    prev = 0
    while eng.scheduler.has_work():
        assert eng.tick < 500
        eng.step()
        assert prog.dispatches - prev <= 1, "one dispatch per step"
        prev = prog.dispatches
    assert prog.dispatches == eng.executor.async_dispatches > 0
    assert prog.traces <= ENGINE_KW["max_seqs"]
    assert other.dispatches == 0


# -- load parity ---------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "prefix", "spec",
                                     "prefix_spec"])
def test_async_load_parity(pair, variant):
    """The seeded load on the undersized pool: the async engine's
    per-step emission maps equal the sync engine's and the reference's
    async engine's; the pool invariants hold after every async step."""
    kw = dict(TIGHT_KW)
    if "prefix" in variant:
        kw["prefix_cache"] = True
    if "spec" in variant:
        kw["spec_decode"] = "ngram"
    work = generate_load(LoadSpec(**LOAD))
    steps_off, off = _drive(_engine(pair, async_exec=False, **kw), work)
    on_eng = _engine(pair, async_exec=True, **kw)
    steps_on, on = _drive(on_eng, work, check_invariants=True)
    jeng = JaxEngine(pair[0], dtype=jnp.float32, async_exec=True,
                     **dict(ENGINE_KW, **kw))
    steps_ref, ref = _drive(jeng, jax_generate_load(JaxLoadSpec(**LOAD)))
    assert steps_on == steps_off == steps_ref, variant
    assert on == off == ref, variant
    assert all(s == "finished" for _, s in on.values())
    sched = on_eng.scheduler
    assert sched.device_s > 0
    assert sched.replans == jeng.scheduler.replans
    if variant == "plain":
        assert sched.overlapped_s > 0      # steady stretches overlapped
    s = on_eng.stats()
    assert s["preemptions"] > 0
    if "prefix" in variant:
        assert s["evicted_pages"] > 0 and s["cached_tokens"] > 0
    else:
        assert on_eng.executor.free_pages == on_eng.executor.cache.num_pages
    if "spec" in variant:
        assert on_eng.metrics.draft_proposed > 0


# -- replan --------------------------------------------------------------------

def _run_with_cancel(eng, async_exec):
    """Two requests; cancel the first once it has streamed three tokens
    and (async) a next-step plan is parked, so the commit-side finish
    invalidates the parked plan."""
    eng.submit(PROMPT, max_new_tokens=30, rid="a")
    eng.submit(PROMPT[:5], max_new_tokens=30, rid="b")
    got, cancelled = {"a": [], "b": []}, False
    while eng.scheduler.has_work():
        assert eng.tick < 500
        for rid, toks in eng.step().items():
            got[rid].extend(toks)
        if not cancelled and len(got["a"]) >= 3 and (
                not async_exec or eng.scheduler._pending is not None):
            eng.cancel("a")
            cancelled = True
        check_pool_invariants(eng.executor.cache)
    return got


def test_replan_on_cancel_keeps_streams_exact(pair):
    e_off, e_on = _engine(pair, async_exec=False), _engine(pair,
                                                           async_exec=True)
    jeng = JaxEngine(pair[0], dtype=jnp.float32, async_exec=True,
                     **ENGINE_KW)
    got_off = _run_with_cancel(e_off, False)
    got_on = _run_with_cancel(e_on, True)
    assert got_on == got_off == _run_with_cancel(jeng, True)
    assert e_on.scheduler.replans == jeng.scheduler.replans >= 1
    assert e_off.scheduler.replans == 0
    assert e_on.request("b").state is RequestState.FINISHED
    assert e_on.request("a").state is RequestState.CANCELLED
    assert e_on.executor.free_pages == e_on.executor.cache.num_pages


# -- overlap telemetry -----------------------------------------------------------

class _Tick:
    """A logical clock: each read advances one unit."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_overlap_telemetry(pair):
    eng = _engine(pair, async_exec=True, clock=_Tick())
    eng.submit(PROMPT, max_new_tokens=24)
    eng.run()
    sched = eng.scheduler
    assert sched.host_overlap_ratio > 0.0 and sched.overlapped_s > 0.0
    assert set(sched.phase_totals) == {"plan", "dispatch", "overlap",
                                       "fence", "commit"}
    assert set(sched.last_phase_seconds) <= set(sched.phase_totals)
    assert sched.device_s == pytest.approx(
        sched.phase_totals["dispatch"] + sched.phase_totals["overlap"]
        + sched.phase_totals["fence"])


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_two_async_steps_in_flight(quant):
    """Two decode_async dispatches on disjoint slots, both in flight
    before either wait(): each returns what a sync decode of its slots
    returns (the second copy lands in the other pinned slot, after the
    first on the stream); then a verify_async beside a decode_async."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from paddle_tpu_torch.models import init_llama_params

    dev = torch.device("cuda")
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    params = init_llama_params(cfg, seed=3, device=dev, dtype=torch.bfloat16)
    a, b = (PagedExecutor(cfg, params, dtype=torch.bfloat16, device=dev,
                          quant=quant, max_seqs=4, page_size=16, max_len=96)
            for _ in range(2))
    rng = np.random.RandomState(5)
    for n in (7, 16, 33, 20):
        p = rng.randint(1, 256, (n,)).astype(np.int32)
        for ex in (a, b):
            ex.prefill(ex.alloc_slot(), p)
    for _ in range(3):
        p1, p2 = a.decode_async([0, 1]), a.decode_async([2, 3])
        assert p1.wait() == b.decode([0, 1])
        assert p2.wait() == b.decode([2, 3])
    d = [[int(a.last_token[2])] * 2, [int(a.last_token[3])]]
    p1 = a.verify_async([2, 3], d, [3, 2], 4)
    p2 = a.decode_async([0, 1])
    assert p1.wait() == b.verify([2, 3], d, [3, 2], 4)
    assert p2.wait() == b.decode([0, 1])
    assert a.async_dispatches == 8
    np.testing.assert_array_equal(a.cache.lengths, b.cache.lengths)
