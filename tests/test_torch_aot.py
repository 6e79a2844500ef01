"""The serving program plane of the PyTorch port against ``paddle_tpu``.

``paddle_tpu_torch/core/aot.py`` (the ladder, the page buckets, the
``PT_AOT`` gate, ``CountedGraph``) and the executor's AOT surface
(``aot_warmup``, ``seal``, ``decode_n``, the ladder routing of the
scheduler), on the reference's tiny Llama and engine shape
(``tests/test_aot.py``: 2 layers, hidden 64, vocab 256, ``KW``) in fp32
on the CPU.  There a ``CountedGraph`` runs its forward eagerly over the
same fixed-address buffers a capture on the card reads, so the streams
hold the buffer plumbing; only the capture itself needs the card (the
tests marked ``cuda``).

``paddle_tpu`` runs with ``aot="off"`` only: its warm engines load
executables from a disk cache, which fails on the tests' 8-device CPU
mesh, and ``aot="off"`` gives the same streams as its ``aot="warm"`` by
its own ``test_warmed_load_zero_traces_and_parity[plain]``.  The load
is the reference's seeded ``LOAD_SPEC`` without its prefix and repeat
keys (the prefix cache and speculative decode are held in
``test_torch_prefix_cache.py`` and ``test_torch_spec_decode.py``); with
spec on, ``aot_warmup(spec_window=W)`` also captures ``serve.verify``.
Token streams and terminal states must be IDENTICAL.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core import aot as jaot
from paddle_tpu.inference.server import PagedExecutor as JaxExecutor
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu_torch.core import aot
from paddle_tpu_torch.inference.server import PagedExecutor, ServingEngine
from paddle_tpu_torch.models import LlamaConfig, from_numpy_state
from paddle_tpu_torch.testing.load import LoadSpec, generate_load

KW = dict(max_seqs=2, page_size=4, max_len=64, num_pages=11,
          prefill_chunk=8)
EXEC_KW = dict(max_seqs=2, page_size=4, max_len=64, num_pages=11)
LOAD = dict(n_requests=8, mean_interarrival=2.0, prompt_len=(4, 12),
            max_new=(6, 10), vocab=256, seed=21)
PROMPT = np.random.RandomState(2).randint(1, 256, (8,)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """The reference's model (``paddle.seed(11)``) and the port's
    config and fp32 CPU parameters holding the same weights."""
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
                         **dict(KW, **kw))


def _drive(eng, work):
    """Replay the seeded load as the reference's ``_drive`` does;
    returns {rid: (tokens, state)}."""
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles = {}
    while pending or eng.in_flight:
        assert eng.tick < 3000, "load did not drain"
        while pending and pending[0]["arrival_tick"] <= eng.tick:
            w = pending.pop(0)
            handles[w["rid"]] = eng.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                rid=w["rid"])
        eng.step()
    return {rid: (list(h.tokens), h.state.value)
            for rid, h in handles.items()}


@pytest.fixture(scope="module")
def work():
    jwork = jax_generate_load(JaxLoadSpec(**LOAD))
    pwork = generate_load(LoadSpec(**LOAD))
    for a, b in zip(jwork, pwork):       # same draws, same requests
        assert a["rid"] == b["rid"] and a["arrival_tick"] == b["arrival_tick"]
        np.testing.assert_array_equal(a["prompt_ids"], b["prompt_ids"])
        assert a["max_new_tokens"] == b["max_new_tokens"]
    return jwork, pwork


@pytest.fixture(scope="module", params=["none", "int8"])
def streams(request, pair, work):
    """The three runs of the seeded load at one quant mode:
    ``paddle_tpu`` off, the port off, the port warm (with its engine)."""
    quant = request.param
    jwork, pwork = work
    jeng = JaxEngine(pair[0], dtype=jnp.float32, aot="off", quant=quant,
                     **KW)
    warm = _engine(pair, aot="warm", quant=quant)
    return {"quant": quant,
            "jax": _drive(jeng, jwork),
            "off": _drive(_engine(pair, aot="off", quant=quant), pwork),
            "warm": _drive(warm, pwork),
            "warm_engine": warm}


# -- ladder / bucket units ----------------------------------------------------


def _same(ours, ref, *args):
    """``ours(*args)`` returns what ``ref(*args)`` returns, or raises the
    ValueError with the same message."""
    try:
        want = ref(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ours(*args)
        assert str(got.value) == str(e)
    else:
        assert ours(*args) == want


def test_ladder_units_equal_reference():
    for cap in (0, 1, 5, 8, 64, 100):
        for lo in (1, 2, 3):
            _same(lambda c, l: aot.BucketLadder.pow2(c, l).rungs,
                  lambda c, l: jaot.BucketLadder.pow2(c, l).rungs, cap, lo)
    for rungs in ([1, 2, 4, 8], [4, 8], [3, 5, 9], [7], [1, 2, 4, 64],
                  [2, 2, 8]):
        ours, ref = aot.BucketLadder(rungs), jaot.BucketLadder(rungs)
        assert ours.rungs == ref.rungs and repr(ours) == repr(ref)
        for n in range(0, 140):
            assert ours.floor(n) == ref.floor(n)
            assert ours.ceil(n) == ref.ceil(n)
            assert (n in ours) == (n in ref)
            _same(ours.chunks, ref.chunks, n)


@pytest.mark.parametrize("rungs", [[0, 4], [], [-2, 1]])
def test_ladder_rejects_bad_rungs(rungs):
    with pytest.raises(ValueError, match="positive"):
        jaot.BucketLadder(rungs)
    with pytest.raises(ValueError, match="positive"):
        aot.BucketLadder(rungs)


def test_page_buckets_equal_reference():
    for pages in range(1, 70):
        b = aot.page_buckets(pages)
        assert b == jaot.page_buckets(pages)
        for n in range(0, pages + 4):
            assert aot.bucket_pages(n, b) == jaot.bucket_pages(n, b)
    assert aot.MODES == jaot.MODES


def test_mode_env_gate(monkeypatch, pair):
    monkeypatch.delenv("PT_AOT", raising=False)
    assert aot.mode() == "off"
    for m in aot.MODES:
        monkeypatch.setenv("PT_AOT", m)
        assert aot.mode() == m == jaot.mode()
    monkeypatch.setenv("PT_AOT", "eager")
    with pytest.raises(ValueError, match="PT_AOT"):
        aot.mode()
    with pytest.raises(ValueError, match="PT_AOT"):
        _engine(pair)
    with pytest.raises(ValueError, match="PT_AOT"):
        _engine(pair, aot="eager")
    # the explicit argument wins over the environment
    monkeypatch.setenv("PT_AOT", "strict")
    eng = _engine(pair, aot="off")
    assert eng.aot_mode == "off" and eng.executor.aot_ladder is None
    monkeypatch.setenv("PT_AOT", "warm")
    eng = _engine(pair)
    assert eng.aot_mode == "warm" and eng.executor.aot_ladder is not None


def test_off_mode_leaves_no_ladder(pair):
    eng = _engine(pair, aot="off")
    assert eng.aot_mode == "off" and eng._aot_report is None
    assert eng.executor.aot_ladder is None
    assert all(not p._exe for p in eng.executor.programs.values())


def test_seal_requires_warmup(pair):
    eng = _engine(pair, aot="off")
    with pytest.raises(ValueError, match="aot_warmup"):
        eng.executor.seal()


def test_spec_window_not_ported(pair, monkeypatch):
    """``aot_warmup(spec_window=3)`` captures ``serve.verify`` at every
    batch beside ``serve.decode``; a strict engine with spec on (k = 2,
    so W = 3) serves through verify steps with no capture after
    ``seal()``, the plain greedy stream, and a miss at an unwarmed W."""
    eng = _engine(pair, aot="off")
    rep = eng.executor.aot_warmup(spec_window=3)
    ms = KW["max_seqs"]
    assert not rep["failed"]
    assert rep["programs"] == {"serve.decode": ms, "serve.verify": ms}
    assert set(eng.executor.programs["verify"]._exe) == {
        (b, 3) for b in range(1, ms + 1)}
    want = _engine(pair, aot="off").submit(PROMPT, max_new_tokens=12).result()
    monkeypatch.setenv("PT_SPEC_K", "2")
    strict = _engine(pair, aot="strict", spec_decode="ngram")
    ex = strict.executor
    assert strict._aot_report["programs"]["serve.verify"] == ms
    traces = sum(p.traces for p in ex.programs.values())
    assert strict.submit(PROMPT, max_new_tokens=12).result() == want
    assert ex.verify_dispatches > 0
    assert sum(p.traces for p in ex.programs.values()) == traces
    with pytest.raises(aot.AotMissError, match="serve.verify"):
        ex.programs["verify"]((ms, 4))


# -- warmup -------------------------------------------------------------------


def test_warmup_report_one_entry_per_rung(pair):
    eng = _engine(pair, aot="warm", decode_n_steps=(2, 3))
    rep = eng._aot_report
    ms = KW["max_seqs"]
    assert not rep["failed"]
    assert rep["programs"] == {"serve.decode": ms, "serve.decode_n": 2 * ms}
    assert rep["entries"] == rep["capture"] == 3 * ms and rep["warm"] == 0
    assert rep["ladder"] == (1, 2, 4, 8)
    assert rep["page_buckets"] == jaot.page_buckets(16)
    progs = eng.executor.programs
    assert set(progs["decode"]._exe) == {(b,) for b in range(1, ms + 1)}
    assert set(progs["decode_n"]._exe) == {
        (b, n) for b in range(1, ms + 1) for n in (2, 3)}
    assert sum(p.traces for p in progs.values()) == rep["capture"]
    assert sum(p.dispatches for p in progs.values()) == 0
    # idempotent re-warm: every entry already captured
    rep2 = eng.executor._aot_rewarm()
    assert rep2["warm"] == rep2["entries"] == 3 * ms and rep2["capture"] == 0
    assert sum(p.traces for p in progs.values()) == rep["capture"]


def test_arm_ladder_arms_what_warmup_arms_without_capture(pair):
    """``arm_ladder`` is the arming step of ``aot_warmup`` alone: the same
    ladder and page buckets as a warm engine, no program captured, and
    the prompt served through the ladder gives the unarmed stream."""
    warm = _engine(pair, aot="warm").executor
    eng = _engine(pair, aot="off")
    ex = eng.executor
    ladder = ex.arm_ladder(KW["prefill_chunk"])
    assert ladder is ex.aot_ladder
    assert ladder.rungs == warm.aot_ladder.rungs == (1, 2, 4, 8)
    assert ex._aot_page_buckets == warm._aot_page_buckets
    assert all(not p._exe for p in ex.programs.values())
    want = _engine(pair, aot="off").submit(PROMPT, max_new_tokens=8).result()
    assert eng.submit(PROMPT, max_new_tokens=8).result() == want


# -- warm equals off equals the reference -------------------------------------


def test_warm_streams_equal_off_and_reference(streams):
    """Plain and int8: the seeded load gives the same greedy streams and
    terminal states warm, off, and on ``paddle_tpu``; the warm engine
    served with no capture after warmup."""
    assert streams["off"] == streams["jax"], streams["quant"]
    assert streams["warm"] == streams["jax"], streams["quant"]
    assert all(s == "finished" for _, s in streams["warm"].values())
    progs = streams["warm_engine"].executor.programs
    rep = streams["warm_engine"]._aot_report
    assert sum(p.traces for p in progs.values()) == rep["capture"]
    assert progs["decode"].dispatches > 0


def test_whole_prompt_routes_through_ladder(pair):
    """No prefill_chunk: under a ladder the scheduler still decomposes
    whole prompts into rungs (``prefill`` is never called), with the same
    tokens as the whole-prompt path."""
    kw = dict(prefill_chunk=None)
    base = _engine(pair, aot="off", **kw)
    want = base.submit(PROMPT, max_new_tokens=6).result()
    assert base.executor.prefill_events[0][1] == len(PROMPT)
    eng = _engine(pair, aot="warm", **kw)
    ex = eng.executor
    assert ex.aot_ladder.rungs == (1, 2, 4, 8, 16, 32, 64)

    def refuse(*a, **k):
        raise AssertionError("whole-prompt prefill under a ladder")

    ex.prefill = refuse
    assert eng.submit(PROMPT, max_new_tokens=6).result() == want
    assert [n for _, n in ex.prefill_events] == [8]
    odd = np.random.RandomState(4).randint(1, 256, (13,)).astype(np.int32)
    want = base.submit(odd, max_new_tokens=5).result()
    assert eng.submit(odd, max_new_tokens=5).result() == want
    assert [n for _, n in ex.prefill_events[1:]] == [8, 4, 1]


def test_strict_seals_prefill_and_unwarmed_rungs(pair):
    eng = _engine(pair, aot="strict")
    ex = eng.executor
    h = eng.submit(PROMPT, max_new_tokens=4)
    eng.run()
    assert h.result() == _engine(pair, aot="off").submit(
        PROMPT, max_new_tokens=4).result()
    with pytest.raises(aot.AotMissError, match="prefill"):
        ex.prefill(0, np.arange(1, 6, dtype=np.int32))
    # decode_n was never warmed at n = 2: not sealed, captures lazily;
    # decode at a batch past max_seqs has no graph and raises
    sid = ex.alloc_slot()
    ex.prefill_chunk(sid, PROMPT, 0, final=True)
    assert len(ex.decode_n([sid], 2)[sid]) == 2
    with pytest.raises(aot.AotMissError, match="serve.decode"):
        ex.programs["decode"]((KW["max_seqs"] + 1,))
    ex.free_slot(sid)
    h = eng.submit(PROMPT, max_new_tokens=4)
    eng.run()
    assert h.state.value == "finished"


# -- decode_n -----------------------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_n_equals_n_decodes_and_reference(pair, quant):
    model, cfg, params = pair
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, 256, (n,)).astype(np.int32) for n in (5, 9)]
    n = 5
    jex = JaxExecutor(model, dtype=jnp.float32, quant=quant, **EXEC_KW)
    pexs = [PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                          quant=quant, **EXEC_KW) for _ in range(2)]
    firsts = []
    for ex in [jex] + pexs:
        sids = [ex.alloc_slot() for _ in prompts]
        firsts.append([ex.prefill(s, p) for s, p in zip(sids, prompts)])
    assert firsts[0] == firsts[1] == firsts[2]
    want = jex.decode_n(sids, n)
    got = pexs[0].decode_n(sids, n)
    steps = [pexs[1].decode(sids) for _ in range(n)]
    assert got == want
    assert got == {s: [st[s] for st in steps] for s in sids}
    for ex in pexs:
        np.testing.assert_array_equal(ex.cache.lengths, jex.cache.lengths)
        np.testing.assert_array_equal(ex.cache.page_table,
                                      jex.cache.page_table)
        assert ex.last_token == jex.last_token
    for name in ("k_pages", "v_pages"):
        torch.testing.assert_close(getattr(pexs[0].cache, name),
                                   getattr(pexs[1].cache, name),
                                   rtol=0, atol=0)
    progs = pexs[0].programs
    assert progs["decode_n"].dispatches == 1
    assert set(progs["decode_n"]._exe) == {(2, n)}
    # the next decode continues from the last decode_n token
    assert pexs[0].decode(sids) == pexs[1].decode(sids) == jex.decode(sids)


# -- the CPU side of the capture plumbing -------------------------------------


def test_counted_graph_counts_and_seals_on_cpu(pair):
    _, cfg, params = pair
    ex = PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                       **EXEC_KW)
    sids = [ex.alloc_slot(), ex.alloc_slot()]
    for s in sids:
        ex.prefill(s, PROMPT)
    prog = ex.programs["decode"]
    ex.decode(sids)
    ex.decode(sids[:1])
    ex.decode(sids)
    assert prog.traces == 2 and prog.dispatches == 3
    assert set(prog._exe) == {(1,), (2,)}
    assert prog.aot_capture((2,)) == "warm" and prog.traces == 2
    prog.seal()
    ex.decode(sids)
    ex.free_slot(sids[0])
    ex.free_slot(sids[1])
    prog._exe.pop((1,))
    s = ex.alloc_slot()
    ex.prefill(s, PROMPT)
    with pytest.raises(aot.AotMissError, match="rung"):
        ex.decode([s])


def _changed_pages(before, after):
    """Page ids whose bytes differ, over the whole storage (the scratch
    page included): pages [..., P + 1, ps, D], scales [..., P + 1]."""
    diff = (before != after).cpu().numpy()
    axis = diff.ndim - 3 if diff.ndim >= 5 else diff.ndim - 1
    rest = tuple(d for d in range(diff.ndim) if d != axis)
    return set(np.nonzero(diff.any(axis=rest))[0].tolist())


def _pool_tensors(cache):
    if cache.k_scales is not None:
        return [cache._kv_pages, cache._kv_scales]
    return [cache._k_all, cache._v_all]


def _live(t):
    """A pool or scale tensor without its scratch page."""
    return t[..., :-1, :, :] if t.dim() >= 5 else t[..., :-1]


def _check_scratch_only(ex, sids):
    """One decode step at a new batch (so a warm-up runs under the
    scratch step first): the only pages written are the scratch page and
    the live tables' pages at the slots' positions."""
    cache = ex.cache
    before = [t.clone() for t in _pool_tensors(cache)]
    traces = ex.programs["decode"].traces
    pos = {s: int(cache.lengths[s]) for s in sids}
    ex.decode(sids)
    assert ex.programs["decode"].traces == traces + 1
    live = {int(cache.page_table[s, pos[s] // cache.page_size])
            for s in sids}
    changed = set()
    for b, a in zip(before, _pool_tensors(cache)):
        changed |= _changed_pages(b, a)
    assert cache.scratch_page in changed
    assert changed <= live | {cache.scratch_page}, (changed, live)
    assert cache.scratch_page not in cache._free
    assert (cache.page_table != cache.scratch_page).all()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_warmup_writes_only_the_scratch_page_on_cpu(pair, quant):
    _, cfg, params = pair
    ex = PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                       quant=quant, **EXEC_KW)
    sids = [ex.alloc_slot(), ex.alloc_slot()]
    for s in sids:
        ex.prefill(s, PROMPT)
    _check_scratch_only(ex, sids)
    assert ex.cache.k_pages.shape[2] == EXEC_KW["num_pages"]


def test_executor_frees_without_the_collector(pair):
    """The programs hold the executor weakly: dropping the last reference
    frees it (and on the card its graphs) at once, never inside a later
    capture through the cyclic collector."""
    import gc
    import weakref

    gc.disable()
    try:
        eng = _engine(pair, aot="warm")
        eng.submit(PROMPT, max_new_tokens=3).result()
        refs = [weakref.ref(eng.executor),
                weakref.ref(eng.executor.programs["decode"])]
        del eng
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# head_dim 64: the narrowest the paged-decode kernel takes
CUDA_CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
CUDA_KW = dict(max_seqs=4, page_size=16, max_len=96)


def _cuda_executors(device, quant, n=2):
    from paddle_tpu_torch.models import init_llama_params

    cfg = LlamaConfig(**CUDA_CFG)
    params = init_llama_params(cfg, seed=3, device=device,
                               dtype=torch.bfloat16)
    exs = [PagedExecutor(cfg, params, dtype=torch.bfloat16, device=device,
                         quant=quant, **CUDA_KW) for _ in range(n)]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, (L,)).astype(np.int32)
               for L in (7, 16, 33, 20)]
    for ex in exs:
        for p in prompts:
            ex.prefill(ex.alloc_slot(), p)
    return cfg, exs


def _counters():
    from paddle_tpu_torch.ops.kernels import paged_decode as pd
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    return pd.paged_decode, pd.paged_decode_quant, qm.quant_matmul


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_replay_equals_eager_bit_for_bit(cuda_device, quant):
    """At every batch 1..max_seqs, the replayed step gives the eager
    step's tokens and pool bytes exactly; dispatches count replays."""
    _, (eager, graph) = _cuda_executors(cuda_device, quant)
    eager._eager_decode = True
    for B in range(1, CUDA_KW["max_seqs"] + 1):
        sids = list(range(B))
        for _ in range(3):
            assert graph.decode(sids) == eager.decode(sids), B
        for a, b in zip(_pool_tensors(graph.cache),
                        _pool_tensors(eager.cache)):
            assert torch.equal(_live(a), _live(b)), B
    prog = graph.programs["decode"]
    assert prog.traces == CUDA_KW["max_seqs"]
    assert prog.dispatches == 3 * CUDA_KW["max_seqs"]
    assert eager.programs["decode"].dispatches == 0
    toks_n = graph.decode_n([0, 1], 4)
    toks_1 = [eager.decode([0, 1]) for _ in range(4)]
    assert toks_n == {s: [t[s] for t in toks_1] for s in (0, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_launch_tallies_add_up_under_replay(cuda_device, quant):
    cfg, (ex,) = _cuda_executors(cuda_device, quant, n=1)
    pd, pdq, qmm = _counters()
    sids = [0, 1, 2]
    ex.decode(sids)                # captures B = 3 (not counted) and runs
    for f in (pd, pdq, qmm):
        f.launches = 0
    qmm.routes = dict.fromkeys(qmm.routes, 0)
    steps = 5
    for _ in range(steps):
        ex.decode(sids)
    ex.decode([0])                 # a capture inside the counted window
    L = cfg.num_hidden_layers
    steps += 1
    if quant == "int8":
        assert (pd.launches, pdq.launches) == (0, L * steps)
        assert qmm.launches == qmm.routes["decode"] == 7 * L * steps
    else:
        assert (pd.launches, pdq.launches, qmm.launches) == \
            (L * steps, 0, 0)


@pytest.mark.cuda
def test_captured_int8_step_writes_only_scratch_and_live(cuda_device):
    _, (ex,) = _cuda_executors(cuda_device, "int8", n=1)
    _check_scratch_only(ex, [0, 2])
    torch.cuda.synchronize()
