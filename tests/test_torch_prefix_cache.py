"""The prefix cache and the refcounted page pool of the PyTorch port
against ``paddle_tpu``.

Mirrors ``tests/test_prefix_cache.py`` (its fault-point tests left out:
the port has no fault points yet) on the reference's tiny Llama (2
layers, hidden 64, vocab 256, ``paddle.seed(11)``) in fp32 on the CPU,
and holds each result against the reference's own run of the same
operations on the same numpy weights:

  * the radix tree (round trip, split, LRU eviction with refcount
    pinning) gives the same matches, pages and counters;
  * attach and copy-on-write on a bf16 and an int8 pool: page tables,
    ``page_refs``, ``cow_count``, and the pages AND their scales bit for
    bit after the same writes;
  * a warm request streams what a cold one does, prefilling only its
    suffix, and a mid-page divergence copies the shared page;
  * a seeded ``prefix_share`` load on an undersized pool (preemption and
    eviction both fire) gives, step by step, the reference's emitted
    tokens, page tables, ``page_refs``, ``cow_count`` and tree pages,
    with ``check_pool_invariants`` after every step.

Token streams must be IDENTICAL; pages bit for bit where the inputs are
the same numpy arrays.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.paged import PagedKVCache as JaxCache
from paddle_tpu.inference.server import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu_torch.inference.paged import PagedKVCache
from paddle_tpu_torch.inference.server import (
    PrefixCache, RequestState, ServingEngine, check_pool_invariants,
)
from paddle_tpu_torch.models import LlamaConfig, from_numpy_state
from paddle_tpu_torch.testing.load import LoadSpec, generate_load

ENGINE_KW = dict(max_seqs=2, page_size=4, max_len=64)


@pytest.fixture(scope="module")
def pair():
    """The reference's model and the port's config and fp32 CPU
    parameters holding the same weights."""
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


def _jax_engine(pair, **kw):
    return JaxEngine(pair[0], dtype=jnp.float32, **dict(ENGINE_KW, **kw))


def _prompts_sharing_prefix(seed=0, prefix_len=18, suffix_lens=(7, 9)):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, 256, (prefix_len,)).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.randint(1, 256, (n,)).astype(np.int32)])
        for n in suffix_lens]


def _cold(pair, prompt, max_new=8, **kw):
    eng = _engine(pair, prefix_cache=False, **kw)
    return eng.submit(prompt, max_new_tokens=max_new).result()


# -- radix tree (no model) ---------------------------------------------------

def _bare_caches(num_pages=16, page_size=4, max_seqs=4):
    kw = dict(n_layers=1, n_kv_heads=1, head_dim=4, num_pages=num_pages,
              page_size=page_size, max_seqs=max_seqs,
              max_pages_per_seq=num_pages)
    return PagedKVCache(device="cpu", **kw), JaxCache(**kw)


def _fill(cache, seq, n_tokens):
    """A prefill's page work: allocate pages and set the length."""
    cache._ensure_capacity(seq, n_tokens)
    cache.lengths[seq] = n_tokens


def _same_pool(tc, jc, tree=None, jtree=None):
    np.testing.assert_array_equal(tc.page_table, jc.page_table)
    np.testing.assert_array_equal(tc.page_refs, jc.page_refs)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    assert tc._free == jc._free
    assert tc.cow_count == jc.cow_count
    if tree is not None:
        assert tree.pages() == jtree.pages()
        assert tree.stats() == jtree.stats()
        check_pool_invariants(tc, tree)
    else:
        check_pool_invariants(tc)


def test_tree_match_insert_roundtrip():
    (tc, jc) = _bare_caches()
    tree, jtree = PrefixCache(tc), JaxPrefixCache(jc)
    ids = np.arange(100, 112, dtype=np.int32)        # 3 full pages
    ext = np.concatenate([ids, [7, 8, 9]]).astype(np.int32)
    div = ids.copy()
    div[6] = 250
    for c, t in ((tc, tree), (jc, jtree)):
        s = c.allocate()
        _fill(c, s, 12)
        assert t.insert(ids, c.page_table[s]) == 3
    for q, want in ((ids, (11, 3)), (ext, (12, 3)), (div, (6, 2))):
        got = tree.match(q)
        assert (got[0], len(got[1])) == want
        assert got == jtree.match(q)
        assert tree.match_len(q) == jtree.match_len(q) == want[0]
    _same_pool(tc, jc, tree, jtree)


def test_tree_split_shares_common_run():
    tc, jc = _bare_caches()
    tree, jtree = PrefixCache(tc), JaxPrefixCache(jc)
    ids_a = np.arange(50, 62, dtype=np.int32)
    ids_b = ids_a.copy()
    ids_b[8:] = [200, 201, 202, 203]
    for c, t in ((tc, tree), (jc, jtree)):
        a = c.allocate()
        _fill(c, a, 12)
        t.insert(ids_a, c.page_table[a])
        b = c.allocate()
        _fill(c, b, 12)
        assert t.insert(ids_b, c.page_table[b]) == 1   # the divergent page
    qa = np.concatenate([ids_a, [1]]).astype(np.int32)
    qb = np.concatenate([ids_b, [1]]).astype(np.int32)
    (n_a, pg_a), (n_b, pg_b) = tree.match(qa), tree.match(qb)
    assert n_a == n_b == 12
    assert pg_a[:2] == pg_b[:2] and pg_a[2] != pg_b[2]
    assert (jtree.match(qa), jtree.match(qb)) == ((n_a, pg_a), (n_b, pg_b))
    _same_pool(tc, jc, tree, jtree)


def test_tree_eviction_lru_and_refcount_pinning():
    tc, jc = _bare_caches()
    trees = [PrefixCache(tc), JaxPrefixCache(jc)]
    for c, t in zip((tc, jc), trees):
        a = c.allocate()
        _fill(c, a, 8)
        t.insert(np.arange(10, 18, dtype=np.int32), c.page_table[a])
        b = c.allocate()
        _fill(c, b, 8)
        t.insert(np.arange(60, 68, dtype=np.int32), c.page_table[b])
        # both sequences hold their pages: nothing is evictable
        assert t.evictable_pages() == 0 and t.evict(99) == 0
        c.free(a)              # A's tree pages drop to one reference
        assert t.evictable_pages() == 2
        assert t.evict(1) == 2  # the whole leaf goes at once
        assert t.evicted_pages == 2
        assert all(c.page_refs[p] == 2 for p in t.pages())
    _same_pool(tc, jc, *trees)


def _pool_caches(quant, dtype):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=8, num_pages=10,
              page_size=4, max_seqs=3, max_pages_per_seq=5, quant=quant)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    return (PagedKVCache(device="cpu", dtype=dtype, **kw),
            JaxCache(dtype=jdt, **kw))


def _host_pools(c):
    """Pages (as f32 or int8) and scales of a cache, numpy."""
    def np_(t):
        if isinstance(t, torch.Tensor):
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16
                          else t)
    out = [np_(c.k_pages), np_(c.v_pages)]
    if c.k_scales is not None:
        out += [np_(c.k_scales), np_(c.v_scales)]
    return out


@pytest.mark.parametrize("quant,dtype", [("none", torch.bfloat16),
                                         ("int8", torch.float32)],
                         ids=["bf16", "int8"])
def test_attach_and_cow_isolate_shared_page(quant, dtype):
    """The same writes, attach and copy-on-write on both caches: page
    tables, refcounts, the COW count and every page (and, on the int8
    pool, every scale) bit for bit; the shared page is never written."""
    tc, jc = _pool_caches(quant, dtype)
    tree, jtree = PrefixCache(tc), JaxPrefixCache(jc)
    rng = np.random.RandomState(4)
    ids = np.arange(30, 38, dtype=np.int32)
    vals = [rng.randn(2, 2, n, 8).astype(np.float32) for n in (8, 2, 3)]
    jvals = [jnp.asarray(v).astype(jnp.bfloat16 if quant == "none"
                                   else jnp.float32) for v in vals]
    tvals = [torch.from_numpy(v).to(dtype) for v in vals]
    for c, t, vs in ((tc, tree, tvals), (jc, jtree, jvals)):
        a = c.allocate()
        c.write_at(a, vs[0], vs[0] * 2, 0)
        t.insert(ids, c.page_table[a])
        b = c.allocate()
        n, pages = t.match(
            np.concatenate([ids[:6], [240, 241]]).astype(np.int32))
        assert n == 6 and len(pages) == 2
        c.attach(b, pages, n)
        shared = int(c.page_table[b, 1])
        assert c.page_refs[shared] == 3          # A + tree + B
        before = [p.copy() for p in _host_pools(c)]
        c.write_at(b, vs[1], vs[1] * 3, 6)       # into the partial page
        assert c.cow_count == 1
        assert int(c.page_table[b, 1]) != shared
        assert c.page_refs[shared] == 2
        for x, y in zip(before, _host_pools(c)):  # the original untouched
            np.testing.assert_array_equal(x[:, :, shared], y[:, :, shared])
        c.write_at(a, vs[2], vs[2], 8)           # A grows past its pages
    for x, y in zip(_host_pools(tc), _host_pools(jc)):
        np.testing.assert_array_equal(x, y)
    _same_pool(tc, jc, tree, jtree)


def test_trim_and_reclaimer_match_reference():
    """``trim`` after a rejected tail and the reclaimer inside
    ``reserve``: the same tables, refcounts and free lists."""
    tc, jc = _bare_caches(num_pages=6, max_seqs=2)
    trees = [PrefixCache(tc), JaxPrefixCache(jc)]
    for c, t in zip((tc, jc), trees):
        c.reclaimer = t.evict
        a = c.allocate()
        _fill(c, a, 8)
        t.insert(np.arange(1, 9, dtype=np.int32), c.page_table[a])
        c.free(a)                                  # 2 cold tree pages
        b = c.allocate()
        _fill(c, b, 6)
        c.reserve([b], extra_tokens=14)            # needs the cold pages
        assert t.evicted_pages == 2
        assert c.trim(b) == 3                      # back to 6 tokens
    _same_pool(tc, jc, *trees)


# -- engine level ------------------------------------------------------------

def test_warm_request_equals_cold_and_prefills_only_suffix(pair):
    pa, pb = _prompts_sharing_prefix(0, 18, (7, 9))
    want_a, want_b = _cold(pair, pa), _cold(pair, pb)
    eng = _engine(pair, prefix_cache=True)
    jeng = _jax_engine(pair, prefix_cache=True)
    assert eng.submit(pa, max_new_tokens=8).result() == want_a
    assert jeng.submit(pa, max_new_tokens=8).result() == want_a
    check_pool_invariants(eng.executor.cache, eng.prefix)
    n_events = len(eng.executor.prefill_events)
    hb = eng.submit(pb, max_new_tokens=8)
    assert hb.result() == want_b
    assert jeng.submit(pb, max_new_tokens=8).result() == want_b
    check_pool_invariants(eng.executor.cache, eng.prefix)
    # 18 shared tokens were attached: the warm prefill saw 27 - 18
    warm = eng.executor.prefill_events[n_events:]
    assert sum(n for _, n in warm) == len(pb) - 18
    assert eng.executor.prefill_events == jeng.executor.prefill_events
    assert hb.metrics()["cached_tokens"] == 18
    s, js = eng.stats(), jeng.stats()
    assert s["cached_tokens"] == js["cached_tokens"] == 18
    assert s["prefix_hit_rate"] == js["prefix_hit_rate"] > 0
    assert eng.executor.cache.cow_count == jeng.executor.cache.cow_count >= 1


def test_cow_divergence_mid_page_streams_exact(pair):
    rng = np.random.RandomState(3)
    base = rng.randint(1, 256, (14,)).astype(np.int32)  # 14 % 4 = 2
    pa = np.concatenate([base, rng.randint(1, 256, (6,)).astype(np.int32)])
    pb = np.concatenate([base, rng.randint(1, 256, (6,)).astype(np.int32)])
    assert pa[14] != pb[14]
    want_b = _cold(pair, pb, max_new=6)
    eng = _engine(pair, prefix_cache=True)
    eng.submit(pa, max_new_tokens=6).result()
    cow0 = eng.executor.cache.cow_count
    assert eng.submit(pb, max_new_tokens=6).result() == want_b
    assert eng.executor.cache.cow_count > cow0
    check_pool_invariants(eng.executor.cache, eng.prefix)


def test_off_mode_equals_todays_engine_and_reports_zeros(pair):
    pa, pb = _prompts_sharing_prefix(5, 16, (5, 8))
    off, on = _engine(pair, prefix_cache=False), _engine(pair,
                                                         prefix_cache=True)
    jon = _jax_engine(pair, prefix_cache=True)
    for p in (pa, pb):
        want = off.submit(p, max_new_tokens=6).result()
        assert on.submit(p, max_new_tokens=6).result() == want
        assert jon.submit(p, max_new_tokens=6).result() == want
    s_off, s_on = off.stats(), on.stats()
    assert (s_off["cached_tokens"], s_off["prefix_hit_rate"],
            s_off["evicted_pages"]) == (0, 0.0, 0)
    assert s_on["cached_tokens"] == jon.stats()["cached_tokens"] > 0
    assert off.prefix is None and off.executor.cache.reclaimer is None
    check_pool_invariants(off.executor.cache)


def test_env_gate(pair, monkeypatch):
    monkeypatch.setenv("PT_PREFIX_CACHE", "on")
    assert _engine(pair).prefix is not None
    monkeypatch.setenv("PT_PREFIX_CACHE", "off")
    assert _engine(pair).prefix is None
    monkeypatch.delenv("PT_PREFIX_CACHE")
    assert _engine(pair).prefix is None                  # default off
    monkeypatch.setenv("PT_PREFIX_CACHE", "on")
    assert _engine(pair, prefix_cache=False).prefix is None
    monkeypatch.setenv("PT_PREFIX_CACHE", "maybe")
    with pytest.raises(ValueError, match="PT_PREFIX_CACHE"):
        _engine(pair)


PREFIX_LOAD = dict(n_requests=8, mean_interarrival=2.0, prompt_len=(4, 12),
                   max_new=(6, 10), vocab=256, seed=21, prefix_share=0.6,
                   prefix_len=10, prefix_pool=2)
# undersized pool: 11 pages for 2 slots x a 16-page budget, so decode
# growth preempts and cached pages must be evicted
TIGHT_KW = dict(max_seqs=2, page_size=4, max_len=64, num_pages=11,
                prefill_chunk=8, prefix_cache=True)


def _lockstep(pair, load, engine_kw, quant="none"):
    """The seeded load through the port and the reference, one step at a
    time: after every step the emitted tokens, page tables, refcounts,
    free lists, COW counts and tree pages are equal and the port's pool
    invariants hold.  Returns the port's engine and handles."""
    jwork = jax_generate_load(JaxLoadSpec(**load))
    work = generate_load(LoadSpec(**load))
    for a, b in zip(jwork, work):           # same draws, same requests
        assert a["arrival_tick"] == b["arrival_tick"]
        np.testing.assert_array_equal(a["prompt_ids"], b["prompt_ids"])
        assert a["max_new_tokens"] == b["max_new_tokens"]
    _, cfg, params = pair
    eng = ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                        quant=quant, **engine_kw)
    jeng = JaxEngine(pair[0], dtype=jnp.float32, quant=quant, **engine_kw)
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles = {}
    while pending or eng.in_flight:
        assert eng.tick < 3000, "load did not drain"
        while pending and pending[0]["arrival_tick"] <= eng.tick:
            w = pending.pop(0)
            for e in (eng, jeng):
                e.submit(w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                         rid=w["rid"])
            handles[w["rid"]] = eng.request(w["rid"])
        assert eng.step() == jeng.step(), eng.tick
        c, jc = eng.executor.cache, jeng.executor.cache
        np.testing.assert_array_equal(c.page_table, jc.page_table)
        np.testing.assert_array_equal(c.page_refs, jc.page_refs)
        np.testing.assert_array_equal(c.lengths, jc.lengths)
        assert c._free == jc._free and c.cow_count == jc.cow_count
        if eng.prefix is not None:
            assert eng.prefix.pages() == jeng.prefix.pages()
        check_pool_invariants(c, eng.prefix)
    assert jeng.in_flight == 0
    return eng, jeng, work, handles


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_seeded_load_matches_reference_step_by_step(pair, quant):
    """Prefix-heavy seeded load on the undersized pool: preemption and
    eviction both fire, every request finishes, and the port's control
    plane equals the reference's after every step."""
    eng, jeng, work, reqs = _lockstep(pair, PREFIX_LOAD, TIGHT_KW, quant)
    for w in work:
        r = reqs[w["rid"]]
        assert r.state is RequestState.FINISHED, (w["rid"], r.state)
        assert len(r.generated) == w["max_new_tokens"]
    s, js = eng.stats(), jeng.stats()
    assert s["cached_tokens"] == js["cached_tokens"] > 0
    assert s["evicted_pages"] == js["evicted_pages"] > 0
    assert s["preemptions"] == js["preemptions"] > 0
    # the streams equal the cache-off run of the same load
    off = _engine(pair, quant=quant, **dict(TIGHT_KW, prefix_cache=False))
    pending = sorted(generate_load(LoadSpec(**PREFIX_LOAD)),
                     key=lambda w: (w["arrival_tick"], w["rid"]))
    hs = {}
    while pending or off.in_flight:
        while pending and pending[0]["arrival_tick"] <= off.tick:
            w = pending.pop(0)
            hs[w["rid"]] = off.submit(w["prompt_ids"],
                                      max_new_tokens=w["max_new_tokens"],
                                      rid=w["rid"])
        off.step()
    for w in work:
        assert hs[w["rid"]].tokens == reqs[w["rid"]].generated, w["rid"]


def test_eviction_never_reclaims_live_pages(pair):
    pa, pb = _prompts_sharing_prefix(9, 16, (6, 7))
    eng = _engine(pair, prefix_cache=True)
    eng.submit(pa, max_new_tokens=6).result()
    h = eng.submit(pb, max_new_tokens=12)
    eng.step()
    eng.step()                             # admitted, mid-flight
    assert not eng.request(h.rid).terminal
    cache = eng.executor.cache
    live = [int(p) for p in cache.page_table[eng.request(h.rid).sid]
            if p >= 0]
    eng.prefix.evict(cache.num_pages)      # demand more than exists
    for p in live:
        assert cache.page_refs[p] >= 1     # never freed under a slot
    check_pool_invariants(cache, eng.prefix)
    assert h.result() == _cold(pair, pb, max_new=12)
