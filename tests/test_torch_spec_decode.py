"""N-gram speculative decode of the PyTorch port against ``paddle_tpu``.

Mirrors ``tests/test_spec_decode.py`` (its fault-point tests left out:
the port has no fault points yet) on the reference's tiny Llama (2
layers, hidden 64, vocab 256, ``paddle.seed(11)``) in fp32 on the CPU:

  * ``NGramProposer`` proposes what the reference's does on seeded
    histories, with the same index;
  * the port's verify forward against the reference's ``_verify_fwd`` on
    the same prompts and drafts: the packed tokens and counts equal,
    the window logits within atol 1e-4 (fp32 both sides, other summation
    orders, as ``tests/test_torch_serving.py``), the pools within one
    int8 quantum; the window write itself (valid cells to their pages,
    cells past a limit to the scratch page, which the reference drops)
    leaves int8 pages and scales bit for bit equal to the reference's
    ``kv_write`` on the same values;
  * the ngram stream equals the plain greedy one and the reference's,
    with an exact token budget, one ``serve.verify`` call a step, every
    rejected window's pages returned, and under a seeded load with
    preemption, eviction and prefix hits step by step equal to the
    reference's control plane.

On the card (``cuda``): a captured ``serve.verify`` replays equal to its
eager run bit for bit, tokens and pools.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.paged import PagedKVCache as JaxCache
from paddle_tpu.inference.server import NGramProposer as JaxProposer
from paddle_tpu.inference.server import PagedExecutor as JaxExecutor
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.ops import quant as jquant
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu_torch.inference.paged import PagedKVCache
from paddle_tpu_torch.inference.server import (
    NGramProposer, PagedExecutor, RequestState, ServingEngine,
    check_pool_invariants,
)
from paddle_tpu_torch.models import LlamaConfig, from_numpy_state
from paddle_tpu_torch.testing.load import LoadSpec, generate_load

ATOL = 1e-4
ENGINE_KW = dict(max_seqs=2, page_size=4, max_len=128)

# the seed-2 prompt drives this model into a 4-token greedy cycle
CYCLING_PROMPT = np.random.RandomState(2).randint(
    1, 256, (8,)).astype(np.int32)


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


def _cold(pair, prompt, max_new=8, **kw):
    return _engine(pair, **kw).submit(prompt, max_new_tokens=max_new).result()


# -- the proposer --------------------------------------------------------------

def test_proposer_unit_cases():
    for cls in (NGramProposer, JaxProposer):
        p = cls(max_ngram=3)
        p.begin("r", [5, 6, 7, 8, 5, 6, 7])
        assert p.propose("r", 4).tolist() == [8, 5, 6, 7]
        assert p.propose("r", 2).tolist() == [8, 5]
        p.begin("r", [1, 2, 3, 4, 5])
        assert p.propose("r", 4).size == 0
        assert p.propose("missing", 4).size == 0
        p = cls(max_ngram=2)
        p.begin("r", [9, 1, 2])
        assert p.propose("r", 4).size == 0     # the tail never self-matches
        p.drop("r")
        assert p.history_len("r") == 0
    with pytest.raises(ValueError, match="max_ngram"):
        NGramProposer(max_ngram=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proposer_equals_reference_on_seeded_histories(seed):
    """Incremental extends over a small vocabulary (many collisions):
    every proposal at every k, and the index, equal the reference's, and
    the incremental index equals one rebuilt from the whole history."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 6, (60,)).tolist()
    for max_ngram in (1, 2, 3, 4):
        ours, ref = NGramProposer(max_ngram), JaxProposer(max_ngram)
        ours.begin("r", toks[:10])
        ref.begin("r", toks[:10])
        for t in toks[10:]:
            for k in (0, 1, 3, 4, 8):
                assert (ours.propose("r", k).tolist()
                        == ref.propose("r", k).tolist())
            ours.extend("r", t)
            ref.extend("r", t)
        assert ours._index["r"] == ref._index["r"]
        fresh = NGramProposer(max_ngram)
        fresh.begin("r", toks)
        assert fresh._index["r"] == ours._index["r"]


# -- the verify forward --------------------------------------------------------

def _deq(c):
    """A cache's pools as f32 numpy (dequantized where int8)."""
    def one(pages, scales):
        p = np.asarray(pages, np.float32)
        return p if scales is None else p * np.asarray(scales)[..., None,
                                                                None]
    if isinstance(c.k_pages, torch.Tensor):
        ks = None if c.k_scales is None else c.k_scales.numpy()
        vs = None if c.v_scales is None else c.v_scales.numpy()
        return one(c.k_pages.numpy(), ks), one(c.v_pages.numpy(), vs)
    return one(c.k_pages, c.k_scales), one(c.v_pages, c.v_scales)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_verify_matches_reference(pair, quant):
    """Two slots, a fully correct draft and one right for two tokens then
    wrong, limits 5 and 4: the same packed tokens, counts, commits,
    lengths and tables as the reference; logits within ATOL."""
    model, cfg, params = pair
    kw = dict(max_seqs=2, page_size=4, max_len=64)
    jex = JaxExecutor(model, dtype=jnp.float32, quant=quant, **kw)
    pex, ref = (PagedExecutor(cfg, params, dtype=torch.float32,
                              device="cpu", quant=quant, **kw)
                for _ in range(2))
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, 256, (n,)).astype(np.int32) for n in (7, 10)]
    for ex in (jex, pex, ref):
        sids = [ex.alloc_slot() for _ in prompts]
        for s, p in zip(sids, prompts):
            ex.prefill(s, p)
    greedy = ref.decode_n(sids, 5)
    k, limits = 4, [5, 4]
    drafts = [greedy[sids[0]][:4],
              greedy[sids[1]][:2] + [(greedy[sids[1]][2] + 1) % 256, 3]]
    # the reference's forward, eagerly on the pools before its verify,
    # with its head's output caught
    jex.cache.reserve(sids, extra_tokens=limits)
    window = np.zeros((2, k + 1), np.int32)
    for i, s in enumerate(sids):
        window[i, 0] = jex.last_token[s]
        window[i, 1:1 + len(drafts[i])] = drafts[i]
    heads = []
    jex._head = lambda x, tops: heads.append(
        JaxExecutor._head(jex, x, tops)) or heads[-1]
    jpacked, jemit, _, _ = jex._verify_fwd(
        jex.layers, jex.tops, jnp.asarray(window), *jex._pools(),
        jnp.asarray(jex.cache.lengths[sids]),
        jnp.asarray(np.maximum(jex.cache.page_table[sids], 0)),
        jnp.asarray(limits, jnp.int32))
    del jex._head
    want = jex.verify(sids, drafts, limits, k)
    # the port's public call, its head's output and program row caught
    logits, rows = [], []
    pex._head = lambda x: logits.append(PagedExecutor._head(pex, x)) \
        or logits[-1]
    run = pex._run
    pex._run = lambda *a: rows.append(run(*a)) or rows[-1]
    got = pex.verify(sids, drafts, limits, k)
    assert got == want
    assert got[1] == {sids[0]: 4, sids[1]: 2}
    assert got[0][sids[0]] == greedy[sids[0]]
    assert got[0][sids[1]] == greedy[sids[1]][:3]
    np.testing.assert_array_equal(
        rows[0].numpy(), np.concatenate([np.asarray(jpacked),
                                         np.asarray(jemit)]))
    # logits[0] is the capture's warm-up over the scratch page
    assert len(logits) == 2 and len(heads) == 1
    np.testing.assert_allclose(logits[-1].numpy(), np.asarray(heads[0]),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pex.cache.lengths, jex.cache.lengths)
    np.testing.assert_array_equal(pex.cache.page_table,
                                  jex.cache.page_table)
    assert pex.last_token == jex.last_token
    for ours, theirs in zip(_deq(pex.cache), _deq(jex.cache)):
        if quant == "int8":        # one quantum of the page's scale
            tol = np.asarray(jex.cache.k_scales).max() * 1.01 + 1e-6
        else:
            tol = 1e-5
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol)
    # rollback trims both to the committed lengths
    assert pex.rollback(sids) == jex.rollback(sids)
    np.testing.assert_array_equal(pex.cache.page_table,
                                  jex.cache.page_table)
    assert pex.verify_dispatches == 1


@pytest.mark.parametrize("B", [1, 2])
def test_verify_attention_inputs_are_what_the_kernel_takes(pair, B):
    """The verify forward hands paged decode contiguous q, int32 tables
    [B*W, pps] and int32 lengths [B*W], as the CUDA kernel requires (a
    repeated table row must be a copy, not a zero-stride view), with row
    (b, w) masked to ``lengths[b] + w + 1``."""
    _, cfg, params = pair
    ex = PagedExecutor(cfg, params, dtype=torch.float32, device="cpu",
                       max_seqs=2, page_size=4, max_len=64)
    sids = [ex.alloc_slot() for _ in range(B)]
    for s in sids:
        ex.prefill(s, CYCLING_PROMPT[:5 + s])
    seen = []
    attend = ex.cache.attend_tables

    def checked(layer, q, tables, lens):
        seen.append((tables.clone(), lens.clone()))
        assert q.is_contiguous() and tables.is_contiguous()
        assert lens.is_contiguous()
        assert tables.dtype == lens.dtype == torch.int32
        return attend(layer, q, tables, lens)

    ex.cache.attend_tables = checked
    lengths = ex.cache.lengths[sids].copy()
    ex.verify(sids, [[1, 2]] * B, [3] * B, 4)
    tables, lens = seen[-1]
    W = 5
    assert tables.shape == (B * W, ex.cache.max_pages_per_seq)
    np.testing.assert_array_equal(
        lens.numpy(), (lengths[:, None] + np.arange(W) + 1).reshape(-1))
    np.testing.assert_array_equal(
        tables.numpy(), np.repeat(np.maximum(
            ex.cache.page_table[sids], 0), W, axis=0))


def test_verify_window_write_int8_bit_exact():
    """The window write of a verify step on int8 pools: cells under each
    limit go to their pages, the others to the scratch page (the
    reference sends them past the pool, where ``mode="drop"`` discards
    them).  The same values give bit-identical live pages and scales,
    and no live page outside the windows changes."""
    L, KV, D, P, ps, B, W = 2, 2, 8, 10, 4, 2, 4
    kw = dict(n_layers=L, n_kv_heads=KV, head_dim=D, num_pages=P,
              page_size=ps, max_seqs=B, max_pages_per_seq=4, quant="int8")
    tc = PagedKVCache(device="cpu", dtype=torch.float32, **kw)
    jc = JaxCache(dtype=jnp.float32, **kw)
    rng = np.random.RandomState(8)
    for n in (5, 9):
        v = rng.randn(L, KV, n, D).astype(np.float32)
        for c, conv in ((tc, torch.from_numpy), (jc, jnp.asarray)):
            s = c.allocate()
            c.write_at(s, conv(v), conv(v * 0.5), 0)
    limits = np.asarray([4, 2], np.int32)
    for c in (tc, jc):
        c.reserve([0, 1], extra_tokens=limits.tolist())
    lengths = tc.lengths[[0, 1]].copy()
    tables = np.maximum(tc.page_table[[0, 1]], 0)
    pos = lengths[:, None] + np.arange(W)[None]
    slot = pos // ps
    pids = np.take_along_axis(tables, np.minimum(slot, 3), axis=1)
    valid = (np.arange(W)[None] < limits[:, None]) & (slot < 4)
    offs = (pos % ps).reshape(-1)
    before = tc._kv_pages.clone()
    kv = rng.randn(L, 2, KV, B * W, D).astype(np.float32) * 3
    for layer in range(L):
        tc.write_token(layer, torch.from_numpy(
            np.where(valid, pids, tc.scratch_page).reshape(-1)),
            torch.from_numpy(offs),
            torch.from_numpy(kv[layer, 0].transpose(1, 0, 2)),
            torch.from_numpy(kv[layer, 1].transpose(1, 0, 2)))
    jp = np.where(valid, pids, P).reshape(-1)
    kp, ks = jquant.kv_write(jc.k_pages, jc.k_scales, jnp.asarray(jp),
                             jnp.asarray(offs), jnp.asarray(kv[:, 0]))
    vp, vs = jquant.kv_write(jc.v_pages, jc.v_scales, jnp.asarray(jp),
                             jnp.asarray(offs), jnp.asarray(kv[:, 1]))
    for ours, theirs in ((tc.k_pages, kp), (tc.v_pages, vp),
                         (tc.k_scales, ks), (tc.v_scales, vs)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    touched = set(pids[valid].tolist()) | {tc.scratch_page}
    changed = set(np.nonzero((tc._kv_pages != before).numpy()
                             .any(axis=(0, 1, 2, 4, 5)))[0].tolist())
    assert tc.scratch_page in changed and changed <= touched


# -- engine level --------------------------------------------------------------

def test_off_mode_is_todays_path(pair):
    eng, dflt = _engine(pair, spec_decode="off"), _engine(pair)
    assert eng.spec is None and dflt.spec is None
    want = _cold(pair, CYCLING_PROMPT, max_new=12)
    assert eng.submit(CYCLING_PROMPT, max_new_tokens=12).result() == want
    assert eng.executor.verify_dispatches == 0
    assert eng.executor.programs["decode"].dispatches > 0
    assert eng.stats()["tokens_per_decode_step"] == 1.0


def test_ngram_stream_equals_off_and_reference(pair):
    """On a cycling stream the speculative engine emits the plain greedy
    tokens, in fewer steps, with the reference's acceptance counts."""
    t_off = _cold(pair, CYCLING_PROMPT, max_new=60, spec_decode="off")
    ng = _engine(pair, spec_decode="ngram")
    h = ng.submit(CYCLING_PROMPT, max_new_tokens=60)
    assert h.result() == t_off
    jng = JaxEngine(pair[0], dtype=jnp.float32, spec_decode="ngram",
                    **ENGINE_KW)
    jh = jng.submit(CYCLING_PROMPT, max_new_tokens=60)
    assert jh.result() == t_off
    s, js = ng.stats(), jng.stats()
    for key in ("steps", "decode_tokens", "draft_acceptance_rate",
                "tokens_per_decode_step", "tpot_steps_p50"):
        assert s[key] == js[key], key
    assert s["draft_acceptance_rate"] > 0.2
    assert s["tokens_per_decode_step"] > 1.1
    assert s["tpot_steps_p50"] < 1.0
    m = h.metrics()
    assert 0 < m["draft_accepted"] <= m["draft_proposed"]
    assert (m["draft_accepted"], m["draft_proposed"]) == \
        (jh.metrics()["draft_accepted"], jh.metrics()["draft_proposed"])


def test_exact_token_budget_no_overshoot(pair):
    for max_new in (5, 7, 11):
        eng = _engine(pair, spec_decode="ngram")
        h = eng.submit(CYCLING_PROMPT, max_new_tokens=max_new)
        toks = h.result()
        assert len(toks) == max_new and h.state is RequestState.FINISHED
        assert toks == _cold(pair, CYCLING_PROMPT, max_new=max_new)


def test_rollback_returns_all_pages(pair):
    eng = _engine(pair, spec_decode="ngram")
    hs = [eng.submit(CYCLING_PROMPT, max_new_tokens=40),
          eng.submit(np.random.RandomState(5).randint(
              1, 256, (9,)).astype(np.int32), max_new_tokens=40)]
    eng.run()
    assert all(h.state is RequestState.FINISHED for h in hs)
    ex = eng.executor
    assert ex.rollback_pages > 0
    assert ex.free_pages == ex.cache.num_pages
    check_pool_invariants(ex.cache)


def test_env_gate(pair, monkeypatch):
    monkeypatch.setenv("PT_SPEC_DECODE", "ngram")
    monkeypatch.setenv("PT_SPEC_K", "3")
    monkeypatch.setenv("PT_SPEC_NGRAM", "2")
    eng = _engine(pair)
    assert eng.spec is not None and eng.spec.k == 3
    assert eng.spec.proposer.max_ngram == 2
    monkeypatch.delenv("PT_SPEC_K")
    monkeypatch.delenv("PT_SPEC_NGRAM")
    eng = _engine(pair)
    assert (eng.spec.k, eng.spec.proposer.max_ngram) == (4, 3)
    monkeypatch.setenv("PT_SPEC_DECODE", "off")
    assert _engine(pair).spec is None
    monkeypatch.delenv("PT_SPEC_DECODE")
    assert _engine(pair).spec is None
    monkeypatch.setenv("PT_SPEC_DECODE", "medusa")
    with pytest.raises(ValueError, match="PT_SPEC_DECODE"):
        _engine(pair)
    monkeypatch.delenv("PT_SPEC_DECODE")
    with pytest.raises(ValueError, match="spec_decode"):
        _engine(pair, spec_decode="eagle")
    monkeypatch.setenv("PT_SPEC_K", "0")
    with pytest.raises(ValueError, match="PT_SPEC_K"):
        _engine(pair, spec_decode="ngram")


def test_verify_is_one_call_per_step(pair):
    """One ``serve.verify`` call a scheduler step with a running batch,
    captured once per batch size, and more tokens than calls."""
    eng = _engine(pair, spec_decode="ngram")
    eng.submit(CYCLING_PROMPT, max_new_tokens=50)
    eng.submit(np.tile(CYCLING_PROMPT, 2), max_new_tokens=50)
    prog = eng.executor.programs["verify"]
    prev = 0
    while eng.scheduler.has_work():
        eng.step()
        assert prog.dispatches - prev <= 1
        prev = prog.dispatches
    assert prog.dispatches == eng.metrics.spec_steps > 0
    assert prog.traces <= ENGINE_KW["max_seqs"]
    assert set(prog._exe) <= {(b, 5) for b in (1, 2)}
    assert eng.metrics.decode_tokens > eng.metrics.spec_steps
    assert eng.executor.programs["decode"].dispatches == 0


SPEC_LOAD = dict(n_requests=8, mean_interarrival=2.0, prompt_len=(4, 12),
                 max_new=(6, 10), vocab=256, seed=21, prefix_share=0.6,
                 prefix_len=10, prefix_pool=2, repeat_share=0.5,
                 repeat_period=3)
TIGHT_KW = dict(max_seqs=2, page_size=4, max_len=64, num_pages=11,
                prefill_chunk=8, prefix_cache=True)


def _drive(pair, load, engine_kw, reference=False):
    """The seeded load step by step (the reference's engine beside it
    when ``reference``): the emitted tokens, page tables, refcounts, COW
    counts and tree pages equal after every step, and the port's pool
    invariants hold.  Returns (engine, work, {rid: Request})."""
    work = generate_load(LoadSpec(**load))
    for a, b in zip(jax_generate_load(JaxLoadSpec(**load)), work):
        np.testing.assert_array_equal(a["prompt_ids"], b["prompt_ids"])
    eng = _engine(pair, **engine_kw)
    jeng = (JaxEngine(pair[0], dtype=jnp.float32,
                      **dict(ENGINE_KW, **engine_kw)) if reference else None)
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    while pending or eng.in_flight:
        assert eng.tick < 3000, "load did not drain"
        while pending and pending[0]["arrival_tick"] <= eng.tick:
            w = pending.pop(0)
            for e in (eng, jeng) if reference else (eng,):
                e.submit(w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                         rid=w["rid"])
        out = eng.step()
        c = eng.executor.cache
        if reference:
            assert out == jeng.step(), eng.tick
            jc = jeng.executor.cache
            np.testing.assert_array_equal(c.page_table, jc.page_table)
            np.testing.assert_array_equal(c.page_refs, jc.page_refs)
            assert c._free == jc._free and c.cow_count == jc.cow_count
            if eng.prefix is not None:
                assert eng.prefix.pages() == jeng.prefix.pages()
        check_pool_invariants(c, eng.prefix)
    return eng, work, {w["rid"]: eng.request(w["rid"]) for w in work}


def test_spec_under_load_with_preemption_eviction_prefix(pair):
    """Preemption, eviction, prefix hits and drafts all fire; the port's
    control plane equals the reference's after every step, and every
    stream equals the non-speculative run's."""
    eng, work, reqs = _drive(pair, SPEC_LOAD,
                             dict(TIGHT_KW, spec_decode="ngram"),
                             reference=True)
    s = eng.stats()
    assert s["preemptions"] > 0 and s["evicted_pages"] > 0
    assert s["cached_tokens"] > 0 and eng.metrics.draft_proposed > 0
    _, _, base = _drive(pair, SPEC_LOAD, dict(TIGHT_KW, spec_decode="off"))
    for w in work:
        assert reqs[w["rid"]].state is RequestState.FINISHED
        assert reqs[w["rid"]].generated == base[w["rid"]].generated, w["rid"]


def test_warm_prefix_spec_matches_cold_nonspec(pair):
    seed = np.tile(CYCLING_PROMPT, 2)[:12]
    warm_prompt = np.concatenate([seed, np.asarray([3, 1, 4, 1, 5],
                                                   np.int32)])
    want = _cold(pair, warm_prompt, max_new=24, spec_decode="off",
                 prefix_cache=False)
    eng = _engine(pair, spec_decode="ngram", prefix_cache=True)
    eng.submit(seed, max_new_tokens=24).result()   # plant the prefix
    h = eng.submit(warm_prompt, max_new_tokens=24)
    while h.state is not RequestState.FINISHED:
        assert eng.tick < 500
        eng.step()
        check_pool_invariants(eng.executor.cache, eng.prefix)
    assert h.tokens == want
    assert h.metrics()["cached_tokens"] > 0
    assert eng.executor.verify_dispatches > 0


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_verify_replay_equals_eager_bit_for_bit(quant):
    """Two executors on the card with the same prompts: the one whose
    ``serve.verify`` is a replayed graph and the one that runs it
    eagerly commit the same tokens and write the same pool bytes, at
    every batch size; and ``seal()`` after ``aot_warmup(spec_window)``
    captures nothing more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from paddle_tpu_torch.models import init_llama_params

    dev = torch.device("cuda")
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    params = init_llama_params(cfg, seed=3, device=dev, dtype=torch.bfloat16)
    exs = [PagedExecutor(cfg, params, dtype=torch.bfloat16, device=dev,
                         quant=quant, max_seqs=4, page_size=16, max_len=96)
           for _ in range(2)]
    graph, eager = exs
    eager._eager_decode = True
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, (n,)).astype(np.int32)
               for n in (7, 16, 33, 20)]
    for ex in exs:
        for p in prompts:
            ex.prefill(ex.alloc_slot(), p)
    report = graph.aot_warmup(spec_window=5)
    assert not report["failed"]
    assert report["programs"]["serve.verify"] == 4
    graph.seal()
    traces = graph.verify_traces
    for B in (1, 2, 3, 4):
        sids = list(range(B))
        drafts = [[int(graph.last_token[s])] * (s % 4) for s in sids]
        limits = [1 + len(d) for d in drafts]
        for _ in range(2):
            assert graph.verify(sids, drafts, limits, 4) == \
                eager.verify(sids, drafts, limits, 4), B
            graph.rollback(sids)
            eager.rollback(sids)
        a, b = graph.cache, eager.cache
        pools = ((a._kv_pages, b._kv_pages), (a._kv_scales, b._kv_scales)) \
            if quant == "int8" else ((a._k_all, b._k_all),
                                     (a._v_all, b._v_all))
        for x, y in pools:
            assert torch.equal(x[..., :-1, :, :] if x.dim() > 4
                               else x[..., :-1], y[..., :-1, :, :]
                               if y.dim() > 4 else y[..., :-1]), B
    assert graph.verify_traces == traces
    assert graph.verify_dispatches == 8 and eager.verify_dispatches == 0
