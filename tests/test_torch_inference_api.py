"""The port's public decoding and inference surface against ``paddle_tpu``.

On the CPU, same numpy inputs and weights in both packages:

- ``masked_multihead_attention`` and the dense routes
  (``dense_paged_attention`` / ``_q`` against ``_dense_paged_attention``
  / ``_q``) within 2e-5 absolute for fp32 outputs: fp32 on the port,
  float64 scores on the reference (its ``/ np.sqrt(D)`` is a float64
  scalar under x64), softmax over at most 64 keys.  A bf16 output within
  one bf16 ulp (relative 2^-8): the two round the same fp32 value to
  bf16, or neighbours across a rounding boundary.
- ``paged_decode_attention``'s routes under every ``PT_PAGED_IMPL``
  value, and the invalid one.
- ``ServingEngine`` at head dim 80 (outside the kernels' 64 / 128 /
  256): both packages on their dense routes, greedy streams token for
  token.
- ``PagedLlamaEngine`` against ``paddle_tpu``'s engine and dense
  decoder: the dense-decoder match, continuous batching, slot reuse,
  ``decode_n`` equal to per-step decoding (the counterparts of
  ``tests/test_paged_serving.py``).
- The predictor: list and handle workflows against ``paddle_tpu``'s
  predictor over the same layer (fp32, within 1e-6), ``Config`` knobs,
  low precision, the pool, the misc functions and the refusals that
  wait for ``jit.save`` / ``jit.load`` (ROADMAP.md Queue 1, item 9).
"""
import re
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.inference as jinfer
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.inference.serving import PagedLlamaEngine as JaxPagedEngine
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.generation import LlamaDecoder as JaxDecoder
from paddle_tpu.testing.load import LoadSpec as JaxLoadSpec
from paddle_tpu.testing.load import generate_load as jax_generate_load
from paddle_tpu.testing.load import run_load as jax_run_load
import paddle_tpu_torch.inference as infer
from paddle_tpu_torch.inference import paged
from paddle_tpu_torch.inference.server import ServingEngine
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, from_numpy_state, load_numpy_state,
)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.testing.load import LoadSpec, generate_load, run_load

ATOL = 2e-5
BF16_ULP = 2.0 ** -8

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
#: head dim 80: 160 / 2 heads
D80 = dict(TINY, hidden_size=160, num_attention_heads=2,
           num_key_value_heads=2)


def _pair(kw, seed=11):
    paddle.seed(seed)
    jmodel = JaxLlama(JaxConfig(**kw))
    state = {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}
    model = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_numpy_state(model, state)
    return jmodel, model, state


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


# -- decode attention ops ------------------------------------------------------


@pytest.mark.parametrize("H,KV", [(8, 8), (8, 2)])
def test_masked_multihead_attention(H, KV):
    rng = np.random.RandomState(0)
    B, T, D = 3, 40, 64
    q = rng.randn(B, H, D).astype(np.float32)
    kc = rng.randn(B, KV, T, D).astype(np.float32)
    vc = rng.randn(B, KV, T, D).astype(np.float32)
    lens = np.array([1, 17, 40], np.int32)
    want = np.asarray(jpaged.masked_multihead_attention(q, kc, vc, lens))
    got = infer.masked_multihead_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _pages(rng, KV=2, P=12, ps=4, D=80):
    return (rng.randn(KV, P, ps, D).astype(np.float32),
            rng.randn(KV, P, ps, D).astype(np.float32))


def _tables(rng, B=3, pps=4, P=12):
    table = np.stack([rng.permutation(P)[:pps] for _ in range(B)])
    return table.astype(np.int32), np.array([1, 9, 16], np.int32)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_dense_route_bf16_pool(q_dtype):
    """The dense route over a bf16 pool (q fp32, as RoPE makes it, and
    q bf16) against ``_dense_paged_attention``."""
    rng = np.random.RandomState(1)
    kp, vp = _pages(rng)
    table, lens = _tables(rng)
    q = rng.randn(3, 4, 80).astype(np.float32)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk = torch.from_numpy(kp).bfloat16()
    tv = torch.from_numpy(vp).bfloat16()
    want = np.asarray(jpaged._dense_paged_attention(
        jnp.asarray(tq.float().numpy()).astype(q_dtype),
        jnp.asarray(tk.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(tv.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lens), jnp.asarray(table)).astype(jnp.float32))
    got = paged.dense_paged_attention(tq, tk, tv, torch.from_numpy(lens),
                                      torch.from_numpy(table))
    assert got.dtype == tq.dtype
    tol = ATOL if q_dtype == "float32" else BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_dense_route_int8_pool():
    rng = np.random.RandomState(2)
    KV, P, ps, D = 2, 12, 4, 80
    kp = rng.randint(-127, 128, (KV, P, ps, D)).astype(np.int8)
    vp = rng.randint(-127, 128, (KV, P, ps, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (KV, P)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (KV, P)).astype(np.float32)
    table, lens = _tables(rng)
    q = rng.randn(3, 4, D).astype(np.float32)
    want = np.asarray(jpaged._dense_paged_attention_q(
        q, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table), jnp.asarray(ks), jnp.asarray(vs)))
    t = torch.from_numpy
    got = paged.dense_paged_attention_q(t(q), t(kp), t(vp), t(lens),
                                        t(table), t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


class _Spy:
    """Stands in for a kernel wrapper in ``inference.paged``: records the
    call and forwards it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)

    @property
    def launches(self):     # the functions count through their own name
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@pytest.fixture
def spies(monkeypatch):
    s = {n: _Spy(getattr(paged, n))
         for n in ("paged_decode", "paged_decode_quant",
                   "dense_paged_attention", "dense_paged_attention_q")}
    for n, spy in s.items():
        monkeypatch.setattr(paged, n, spy)
    return s


def _route_case(D, quant):
    rng = np.random.RandomState(3)
    KV, P, ps = 2, 12, 4
    q = torch.from_numpy(rng.randn(3, 4, D).astype(np.float32))
    table, lens = _tables(rng)
    args = [torch.from_numpy(table), torch.from_numpy(lens)]
    if quant:
        kp = torch.from_numpy(rng.randint(-127, 128, (KV, P, ps, D))
                              .astype(np.int8))
        sc = torch.full((KV, P), 0.01)
        return (q, kp, kp.clone(), args[1], args[0]), dict(
            k_scales=sc, v_scales=sc.clone())
    kp = torch.from_numpy(rng.randn(KV, P, ps, D).astype(np.float32))
    return (q, kp, kp.clone(), args[1], args[0]), {}


ROUTES = [  # (PT_PAGED_IMPL, D, quant, the function called or an error)
    ("auto", 128, False, "paged_decode"),
    ("auto", 80, False, "dense_paged_attention"),
    ("auto", 64, True, "paged_decode_quant"),
    ("auto", 80, True, "dense_paged_attention_q"),
    ("pallas", 128, False, "paged_decode"),
    ("pallas", 256, True, "paged_decode_quant"),
    ("pallas", 80, False, (ValueError, "head_dim")),
    ("pallas", 80, True, (ValueError, "head_dim")),
    # jax's own TPU kernel has no counterpart in the port
    ("stock", 128, False, (ValueError, "expected auto|pallas|dense")),
    ("stock", 128, True, (ValueError, "expected auto|pallas|dense")),
    ("stock", 80, False, (ValueError, "expected auto|pallas|dense")),
    ("dense", 128, False, "dense_paged_attention"),
    ("dense", 128, True, "dense_paged_attention_q"),
    ("Dense", 64, False, "dense_paged_attention"),
]


@pytest.mark.parametrize("impl,D,quant,want", ROUTES)
def test_paged_decode_attention_routes(monkeypatch, spies, impl, D, quant,
                                       want):
    monkeypatch.setenv("PT_PAGED_IMPL", impl)
    args, kw = _route_case(D, quant)
    if isinstance(want, tuple):
        with pytest.raises(want[0], match=re.escape(want[1])):
            paged.paged_decode_attention(*args, **kw)
        assert not any(s.calls for s in spies.values())
        return
    out = paged.paged_decode_attention(*args, **kw)
    assert {n for n, s in spies.items() if s.calls} == {want}
    assert out.shape == args[0].shape
    # every route computes the same function
    q, kp, vp, lens, table = args
    if quant:
        ref = jpaged._dense_paged_attention_q(
            q.numpy(), kp.numpy(), vp.numpy(), lens.numpy(), table.numpy(),
            kw["k_scales"].numpy(), kw["v_scales"].numpy())
    else:
        ref = jpaged._dense_paged_attention(q.numpy(), kp.numpy(),
                                            vp.numpy(), lens.numpy(),
                                            table.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_select_impl_matches_reference_and_refuses_bad_value(monkeypatch):
    for impl in ("pallas", "dense"):
        monkeypatch.setenv("PT_PAGED_IMPL", impl)
        assert paged._select_impl(64) == jpaged._select_impl(64, 16)
    monkeypatch.delenv("PT_PAGED_IMPL")
    # auto gates on the head dim alone: a dtype pair the kernels lack
    # reaches them (and raises there on the card), never the dense route
    assert paged._select_impl(80) == "dense"
    for D in (64, 128, 256):
        assert paged._select_impl(D) == "pallas"
    # an unknown value, and ``stock`` (jax's own TPU kernel, which the
    # port does not have), raise in the reference's wording
    for bad in ("fused", "stock"):
        monkeypatch.setenv("PT_PAGED_IMPL", bad)
        with pytest.raises(ValueError) as port_err:
            paged._select_impl(128)
        assert str(port_err.value) == \
            f"PT_PAGED_IMPL={bad!r}: expected auto|pallas|dense"
    monkeypatch.setenv("PT_PAGED_IMPL", "fused")
    with pytest.raises(ValueError, match="PT_PAGED_IMPL='fused': expected"):
        jpaged._select_impl(128, 16)


# -- serving at head dim 80 ------------------------------------------------------


SPEC = dict(n_requests=5, mean_interarrival=1.5, prompt_len=(4, 20),
            max_new=(4, 10), vocab=256, seed=5)
ENGINE_KW = dict(max_seqs=2, page_size=4, max_len=64)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serving_engine_head_dim_80(spies, quant):
    """Head dim 80: the port serves on its dense route (no kernel wrapper
    called) and its greedy streams equal ``paddle_tpu``'s, which takes
    its own dense route."""
    jmodel, model, state = _pair(D80)
    cfg = model.config
    params = from_numpy_state(state, cfg, "cpu", torch.float32)
    jout = jax_run_load(JaxEngine(jmodel, dtype=jnp.float32, quant=quant,
                                  **ENGINE_KW),
                        jax_generate_load(JaxLoadSpec(**SPEC)))
    before = (paged.dense_paged_attention.fn.launches,
              paged.dense_paged_attention_q.fn.launches)
    pout = run_load(ServingEngine(cfg, params, dtype=torch.float32,
                                  device="cpu", quant=quant, **ENGINE_KW),
                    generate_load(LoadSpec(**SPEC)))
    want = {r: h.tokens for r, h in jout["handles"].items()}
    got = {r: h.tokens for r, h in pout["handles"].items()}
    assert got == want
    assert spies["paged_decode"].calls == 0
    assert spies["paged_decode_quant"].calls == 0
    dense = "dense_paged_attention" + ("_q" if quant == "int8" else "")
    assert spies[dense].calls > 0
    # the counter a graph reads: the serving calls, less the warm-up
    # calls a capture runs (and takes back)
    after = (paged.dense_paged_attention.fn.launches,
             paged.dense_paged_attention_q.fn.launches)
    i = int(quant == "int8")
    assert 0 < after[i] - before[i] <= spies[dense].calls


def test_serving_engine_head_dim_80_refuses_forced_kernel(monkeypatch):
    _, model, state = _pair(D80)
    params = from_numpy_state(state, model.config, "cpu", torch.float32)
    monkeypatch.setenv("PT_PAGED_IMPL", "pallas")
    eng = ServingEngine(model.config, params, dtype=torch.float32,
                        device="cpu", **ENGINE_KW)
    eng.submit(np.arange(1, 9), max_new_tokens=4)
    with pytest.raises(ValueError, match="head_dim"):
        for _ in range(8):
            eng.step()


# -- PagedLlamaEngine ------------------------------------------------------------


def _dense_tokens(jmodel, prompt, n):
    out = JaxDecoder(jmodel).generate(np.asarray(prompt)[None],
                                      max_new_tokens=n)
    return [int(t) for t in np.asarray(out)[0]]


def test_paged_engine_matches_dense_decoder(tiny):
    jmodel, model, _ = tiny
    prompt = np.random.RandomState(0).randint(0, 256, (7,)).astype(np.int32)
    n = 6
    want = _dense_tokens(jmodel, prompt, n)
    for eng in (infer.PagedLlamaEngine(model, max_seqs=2, page_size=4,
                                       max_len=64),
                JaxPagedEngine(jmodel, max_seqs=2, page_size=4,
                               max_len=64)):
        sid = eng.add_request(prompt)
        got = [eng._last_token[sid]]
        for _ in range(n - 1):
            got.append(eng.step()[sid])
        assert got == want, (type(eng), got, want)
    # the port's generate gives the dense decoder's tokens as well
    assert list(model.generate(prompt[None], max_new_tokens=n)[0]) == want


def test_paged_engine_continuous_batching(tiny):
    jmodel, model, _ = tiny
    rng = np.random.RandomState(1)
    p1 = rng.randint(0, 256, (5,)).astype(np.int32)
    p2 = rng.randint(0, 256, (9,)).astype(np.int32)
    want1, want2 = _dense_tokens(jmodel, p1, 5), _dense_tokens(jmodel, p2, 3)
    eng = infer.PagedLlamaEngine(model, max_seqs=2, page_size=4, max_len=64)
    s1 = eng.add_request(p1)
    got1 = [eng._last_token[s1]]
    got1.append(eng.step()[s1])          # s1 decodes alone
    s2 = eng.add_request(p2)             # s2 joins mid-flight
    got2 = [eng._last_token[s2]]
    for _ in range(2):
        out = eng.step()                 # both decode in one batch
        got1.append(out[s1])
        got2.append(out[s2])
    got1.append(eng.step()[s1])
    eng.finish(s1)                       # s1 leaves; s2 continues
    assert got1 == want1 and got2 == want2
    assert s1 not in eng._last_token
    assert eng.config is eng._ex.config and eng.cache is eng._ex.cache
    assert eng.layers is eng._ex.layers and eng.tops is eng._ex.tops


def test_paged_engine_slot_reuse_and_failed_prefill(tiny):
    _, model, _ = tiny
    rng = np.random.RandomState(2)
    eng = infer.PagedLlamaEngine(model, max_seqs=1, page_size=4, max_len=32)
    p = rng.randint(0, 256, (6,)).astype(np.int32)
    s = eng.add_request(p)
    eng.step()
    eng.finish(s)
    s2 = eng.add_request(p)              # the slot comes back
    assert s2 == s and eng.step()[s2] is not None
    eng.finish(s2)
    with pytest.raises(RuntimeError):    # longer than max_len: no pages
        eng.add_request(rng.randint(0, 256, (40,)))
    assert eng.cache.free_slots == 1     # the failed prefill freed it


def test_paged_engine_decode_n_matches_per_step(tiny):
    jmodel, model, _ = tiny
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, (5,)).astype(np.int32),
               rng.randint(0, 256, (9,)).astype(np.int32)]
    n = 6
    a = infer.PagedLlamaEngine(model, max_seqs=2, page_size=4, max_len=64)
    sids_a = [a.add_request(p) for p in prompts]
    per_step = {s: [] for s in sids_a}
    for _ in range(n):
        for s, t in a.step().items():
            per_step[s].append(t)
    b = infer.PagedLlamaEngine(model, max_seqs=2, page_size=4, max_len=64)
    sids_b = [b.add_request(p) for p in prompts]
    fused = b.decode_n(n)
    j = JaxPagedEngine(jmodel, max_seqs=2, page_size=4, max_len=64)
    sids_j = [j.add_request(p) for p in prompts]
    jfused = j.decode_n(n)
    for sa, sb, sj in zip(sids_a, sids_b, sids_j):
        assert fused[sb] == per_step[sa] == [int(t) for t in jfused[sj]]
    nxt_a, nxt_b = a.step(), b.step()
    for sa, sb in zip(sids_a, sids_b):
        assert nxt_a[sa] == nxt_b[sb]


# -- the predictor -----------------------------------------------------------------


def _mlp_pair(seed=5):
    """paddle_tpu's ``Sequential(Linear(8, 16), ReLU, Linear(16, 4))`` and
    the port's with the same weights, on the CPU."""
    paddle.seed(seed)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 4))
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"),
                              torch.nn.ReLU(),
                              Linear(16, 4, device="cpu"))
    load_numpy_state(net, {k: np.asarray(v._data)
                           for k, v in jnet.state_dict().items()})
    return jnet, net


def _x(seed=0):
    return np.random.RandomState(seed).randn(2, 8).astype(np.float32)


def test_predictor_list_and_handle_workflows():
    jnet, net = _mlp_pair()
    x = _x()
    want = jinfer.Predictor(jnet).run([x])[0]
    pred = infer.create_predictor(net)
    got = pred.run([x])
    assert len(got) == 1 and isinstance(got[0], np.ndarray)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-6)
    # a tensor input works the same
    np.testing.assert_array_equal(pred.run([torch.from_numpy(x)])[0],
                                  got[0])
    # the handle workflow
    names = pred.get_input_names()
    assert names == ["input"]
    h = pred.get_input_handle(names[0])
    h.copy_from_cpu(x)
    assert h.shape() == [2, 8] and h.type() == "float32"
    assert pred.get_output_names() == ["output_0"]
    assert pred.run() is True
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(out, got[0])
    # an unfed handle raises, as in the reference
    fresh = infer.Predictor(net)
    with pytest.raises(ValueError, match="not fed"):
        fresh.run()
    # share_external_data adopts the tensor without a copy
    t = torch.from_numpy(x)
    h2 = fresh.get_input_handle("input")
    h2.share_external_data(t)
    assert h2._data is t
    fresh.run()
    np.testing.assert_array_equal(
        fresh.get_output_handle("output_0").copy_to_cpu(), got[0])


def test_predictor_on_llama_equals_model(tiny):
    _, model, _ = tiny
    ids = np.random.RandomState(4).randint(0, 256, (1, 12))
    pred = infer.Predictor(model)
    assert pred.get_input_names() == ["input_ids", "labels", "attn_mask"]
    got = pred.run([ids])[0]
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_config_knobs():
    cfg = infer.Config()
    assert cfg.use_gpu() and cfg.device() == torch.device("cuda", 0)
    cfg.enable_use_gpu(256, 1)
    assert cfg.gpu_device_id() == 1 and cfg.device() == torch.device(
        "cuda", 1)
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.device().type == "cpu"
    cfg.enable_memory_optim()
    cfg.switch_ir_optim(True)
    cfg.enable_low_precision("bfloat16")
    cfg.set_optim_cache_dir("unused")
    cfg.disable_glog_info()
    cfg.enable_profile()
    cfg.enable_mkldnn()
    cfg.set_cpu_math_library_num_threads(2)
    cfg.switch_use_feed_fetch_ops(False)
    cfg.switch_specify_input_names(True)
    cfg.exp_disable_tensorrt_ops(["x"])
    cfg.pass_builder().delete_pass("fc_fuse_pass")
    assert cfg.pass_builder().all_passes() == []
    assert cfg._deleted_passes == {"fc_fuse_pass"}
    assert cfg.memory_optim_enabled() and cfg.glog_info_disabled()
    summary = cfg.summary()
    assert "bfloat16" in summary and "cpu" in summary
    cfg.set_model("m")
    assert cfg.model_dir() == "m"
    with pytest.raises(NotImplementedError):
        cfg.enable_tensorrt_engine()
    with pytest.raises(NotImplementedError, match="single"):
        infer.Config("a", "b")
    # the reference's knobs record the same values
    jcfg = jinfer.Config()
    jcfg.enable_memory_optim()
    assert jcfg.memory_optim_enabled() == cfg.memory_optim_enabled()


def test_predictor_with_config_places_and_memory_optim():
    jnet, net = _mlp_pair()
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.enable_memory_optim()
    pred = infer.Predictor(net, config=cfg)
    x = _x()
    a = pred.run([x])[0]
    b = pred.run([x.copy()])[0]          # a second run still works
    want = jinfer.Predictor(jnet).run([x])[0]
    np.testing.assert_allclose(a, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a, b)


def test_predictor_low_precision():
    """``enable_low_precision`` runs over a bf16 copy of the floating
    parameters (the module keeps its fp32 ones); the output agrees with
    ``paddle_tpu``'s low-precision predictor within bf16's rounding and
    with fp32 within the reference's 0.05."""
    jnet, net = _mlp_pair()
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.enable_low_precision("bfloat16")
    pred = infer.Predictor(net, config=cfg)
    x = _x()
    got = pred.run([x])[0]
    assert all(v.dtype == torch.bfloat16 for v in pred._params.values())
    assert all(p.dtype == torch.float32 for p in net.parameters())
    jpred = jinfer.Predictor(jnet)
    jpred._config = jinfer.Config()
    jpred._config.enable_low_precision("bfloat16")
    jpred._config.disable_gpu()
    want = np.asarray(jpred.run([x])[0], np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * BF16_ULP * np.abs(want).max())
    fp32 = infer.Predictor(net).run([x])[0]
    np.testing.assert_allclose(got, fp32, rtol=0.05, atol=0.05)


def test_predictor_pool():
    _, net = _mlp_pair()
    pool = infer.PredictorPool(net, 2)
    x = _x()
    a = pool.retrieve(0).run([x])[0]
    b = pool.retrieve(1).run([x])[0]
    np.testing.assert_array_equal(a, b)
    assert pool.retrieve(0) is not pool.retrieve(1)


def test_item_9_refusals():
    with pytest.raises(NotImplementedError, match="item 9"):
        infer.Predictor(infer.Config("saved/model"))
    with pytest.raises(NotImplementedError, match="item 9"):
        infer.create_predictor(infer.Config("saved/model"))
    with pytest.raises(NotImplementedError, match="item 9"):
        infer.PredictorPool(infer.Config("saved/model"), 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        infer.convert_to_mixed_precision("saved/model",
                                         mixed_model_file="saved/mixed")
    with pytest.raises(TypeError):
        infer.Predictor(object())


def test_misc_inference_surface():
    for name in ("float32", "float16", "bfloat16", "int64", "int32", "int8",
                 "uint8", "bool"):
        assert infer.get_num_bytes_of_data_type(name) == \
            jinfer.get_num_bytes_of_data_type(name), name
    assert infer.get_num_bytes_of_data_type(infer.DataType.BFLOAT16) == 2
    assert infer.get_num_bytes_of_data_type(torch.int64) == 8
    assert infer.get_trt_compile_version() == \
        jinfer.get_trt_compile_version() == (0, 0, 0)
    assert infer.get_trt_runtime_version() == (0, 0, 0)
    assert "paddle_tpu_torch" in infer.get_version()
    assert infer._get_phi_kernel_name("matmul_v2") == "matmul_v2"
    t = infer.Tensor("x")
    assert t.shape() == [] and t.type() is None
    t.copy_from_cpu(np.ones((2, 3), np.float32))
    t.reshape([3, 2])
    assert t.shape() == [3, 2] and t.type() == "float32"
    for cls in ("DataType", "PrecisionType", "PlaceType"):
        want = {k: v for k, v in vars(getattr(jinfer, cls)).items()
                if not k.startswith("_")}
        got = {k: v for k, v in vars(getattr(infer, cls)).items()
               if not k.startswith("_")}
        assert got == want, cls
    xc = infer.XpuConfig()
    assert (xc.device_id, xc.l3_size, xc.conv_autotune_level) == (0, 0, 0)
    bf = infer.Tensor("y")
    bf.share_external_data(torch.ones(2, dtype=torch.bfloat16))
    assert bf.type() == "bfloat16" and bf.copy_to_cpu().dtype == np.float32


def test_reexports():
    from paddle_tpu_torch.inference.server import (
        PagedExecutor, RequestHandle, RequestState,
    )

    assert infer.PagedExecutor is PagedExecutor
    assert infer.RequestHandle is RequestHandle
    assert infer.RequestState is RequestState
    assert infer.ServingEngine is ServingEngine
    assert infer.PagedKVCache is paged.PagedKVCache
    assert infer.paged_decode_attention is paged.paged_decode_attention
    for name in ("PagedKVCache", "masked_multihead_attention",
                 "paged_decode_attention", "PagedLlamaEngine",
                 "PagedExecutor", "RequestHandle", "RequestState",
                 "ServingEngine"):
        assert hasattr(jinfer, name) and hasattr(infer, name)
    assert {f.name for f in fields(LlamaConfig)} <= \
        {f.name for f in fields(JaxConfig)}
