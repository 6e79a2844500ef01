"""The port's serving fleet (``ServingCluster``) against ``paddle_tpu``'s.

The fleet-wide invariant, as in the reference's ``tests/test_cluster.py``
and ``tests/test_chaos.py``: per-request token streams equal a single
engine's, whatever the routing, in all four serving variants (plain,
prefix, spec, async), and a replica that crashes, hangs or raises
mid-load loses no request — its work fails over (recompute, or a hung
replica's pages salvaged) and finishes with the same stream, every live
replica's page pool consistent after every step.  The single engine's
streams are held against ``paddle_tpu``'s engine on the same weights,
the router's placements and a replica crash and hang against
``paddle_tpu``'s fleet (the same failovers, salvages and restarts), and
the chaos schedules drawn are the reference's.
Overload shedding returns terminal REJECTED with a retry-after.
``drain``, ``join`` and ``disaggregated=True``: ``test_torch_elastic.py``.

Weights: the port's seeded tiny Llama (vocab 256, hidden 64, 2 layers,
fp32), loaded into the reference's model.  Streams must be identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingCluster as JaxCluster
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.testing.load import run_load as jax_run_load
from paddle_tpu_torch.inference.server import (
    DEAD_STATES, RequestRejected, RequestState, Router, ServingCluster,
    ServingEngine, check_pool_invariants,
)
from paddle_tpu_torch.models import numpy_state
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.durability_worker import build
from paddle_tpu_torch.testing.load import LoadSpec, generate_load, run_load

KW = dict(max_seqs=2, page_size=4, max_len=64, prefill_chunk=8)
#: tests/test_chaos.py's load, and tests/test_cluster.py's
CHAOS = dict(n_requests=8, mean_interarrival=1.0, prompt_len=(4, 14),
             max_new=(4, 8), vocab=256, seed=3)
SPREAD = dict(n_requests=8, mean_interarrival=2.0, prompt_len=(4, 20),
              max_new=(3, 8), vocab=256, seed=7, prefix_share=0.5,
              prefix_len=8, prefix_pool=3, zipf_s=1.2)
VARIANTS = {
    "plain": {},
    "prefix": {"prefix_cache": True},
    "spec": {"spec_decode": "ngram"},
    "async": {"async_exec": True},
}
SERVED = (RequestState.FINISHED, RequestState.TRUNCATED)


@pytest.fixture(scope="module")
def pair():
    cfg, params, _, _ = build("tiny", "cpu")
    paddle.seed(11)
    model = LlamaForCausalLM(JaxConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128))
    model.eval()
    missing, unknown = model.set_state_dict(numpy_state(params, cfg))
    assert not missing and not unknown
    return model, cfg, params


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


def _cluster(pair, **kw):
    _, cfg, params = pair
    return ServingCluster(cfg, params, dtype=torch.float32, device="cpu",
                          **dict(KW, **kw))


def _engine(pair, **kw):
    _, cfg, params = pair
    return ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                         **dict(KW, **kw))


def _audit(cl):
    for rep in cl.replicas:
        if rep.state not in DEAD_STATES:
            check_pool_invariants(rep.engine.executor.cache,
                                  rep.engine.prefix)


def _drive(cl, work, fmod=faults, max_steps=400, audit=True):
    """run_load with the pool audit after every step (a fault escaping
    the cluster's step is counted, and the fleet keeps going)."""
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles = {}
    while pending or cl.in_flight:
        assert cl.tick < max_steps, "the fleet did not drain"
        while pending and pending[0]["arrival_tick"] <= cl.tick:
            w = pending.pop(0)
            handles[w["rid"]] = cl.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                priority=w["priority"], rid=w["rid"])
        try:
            cl.step()
        except fmod.InjectedFault:
            pass
        if audit:
            _audit(cl)
    return handles


def _assert_zero_loss(handles, base):
    for rid, h in handles.items():
        assert h.state in SERVED, (rid, h.state)
        assert h.tokens == base[rid], f"{rid}: stream diverged"


@pytest.fixture(scope="module")
def baseline(pair):
    """The fault-free single-engine streams of the chaos load — held
    here against ``paddle_tpu``'s engine on the same weights."""
    work = generate_load(LoadSpec(**CHAOS))
    out = run_load(_engine(pair), work)
    ref = jax_run_load(JaxEngine(pair[0], **KW), work)
    base = {r: h.tokens for r, h in out["handles"].items()}
    assert base == {r: h.tokens for r, h in ref["handles"].items()}
    return work, base


def _fleet_counts(cl):
    return dict(failovers=cl.failovers, restarts=cl.restarts,
                salvages=cl.salvages, salvaged_pages=cl.salvaged_pages,
                retired=cl.retired, degraded=cl.router.degraded,
                states=[r.state for r in cl.replicas])


# -- streams across the fleet == a single engine ---------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cluster_streams_match_single_engine(pair, variant):
    kw = VARIANTS[variant]
    work = generate_load(LoadSpec(**dict(
        SPREAD, repeat_share=0.5 if variant == "spec" else 0.0)))
    base = run_load(_engine(pair, **kw), work)
    cl = _cluster(pair, n_replicas=3, cluster=True, **kw)
    res = run_load(cl, work)
    assert res["errors"] == []
    for w in work:
        h = res["handles"][w["rid"]]
        assert h.state is RequestState.FINISHED, (variant, w["rid"])
        assert h.tokens == base["handles"][w["rid"]].tokens, \
            (variant, w["rid"])
    busy = [r for r in cl.replicas if r.engine.metrics.submitted > 0]
    assert len(busy) >= 2
    if variant == "prefix":
        assert cl.router.affinity_hits >= 1
        assert cl.stats()["cached_tokens"] > 0
    _audit(cl)


def test_plain_fleet_routes_as_the_reference(pair):
    """The same load on both packages' 3-replica fleets: the router
    places every request on the same replica."""
    work = generate_load(LoadSpec(**SPREAD))
    cl = _cluster(pair, n_replicas=3, cluster=True)
    jcl = JaxCluster(pair[0], n_replicas=3, cluster=True, **KW)
    run_load(cl, work)
    jax_run_load(jcl, work)
    assert {r: rep.name for r, rep in cl._owner.items()} \
        == {r: rep.name for r, rep in jcl._owner.items()}
    assert [r.engine.metrics.submitted for r in cl.replicas] \
        == [r.engine.metrics.submitted for r in jcl.replicas]


# -- the gate and the surface ---------------------------------------------

def test_gate_off_is_single_engine_parity(pair, baseline, monkeypatch):
    work, base = baseline
    monkeypatch.delenv("PT_CLUSTER", raising=False)
    cl = _cluster(pair, n_replicas=4)
    assert not cl.enabled and len(cl.replicas) == 1
    res = run_load(cl, work)
    assert {r: h.tokens for r, h in res["handles"].items()} == base
    monkeypatch.setenv("PT_CLUSTER", "on")
    assert len(_cluster(pair, n_replicas=2).replicas) == 2


def test_gate_bogus_value_raises(pair, monkeypatch):
    monkeypatch.setenv("PT_CLUSTER", "bogus")
    with pytest.raises(ValueError, match="PT_CLUSTER"):
        _cluster(pair, n_replicas=2)


def test_router_policy_validated():
    with pytest.raises(ValueError, match="policy"):
        Router(policy="round-robin")


def test_elastic_part_is_not_ported(pair):
    """The elastic part is ported now (its tests are
    ``tests/test_torch_elastic.py``): drain, join and a disaggregated
    fleet no longer raise."""
    cl = _cluster(pair, n_replicas=2, cluster=True)
    assert cl.drain("r0").state == "draining"
    assert cl.join().name == "r2"
    dis = _cluster(pair, n_replicas=2, cluster=True, disaggregated=True)
    assert [r.role for r in dis.replicas] == ["prefill", "decode"]
    for point in ("replica.drain", "replica.join", "kv.handoff"):
        assert point in faults.REGISTERED


def test_duplicate_rid_across_replicas_dedupes(pair):
    cl = _cluster(pair, n_replicas=2, cluster=True)
    h1 = cl.submit(np.asarray([1, 2, 3], np.int32), rid="dup")
    h2 = cl.submit(np.asarray([4, 5, 6], np.int32), rid="dup")
    assert h2._req is h1._req and cl.dedup_hits == 1
    cl.run()
    assert h2.tokens == h1.tokens
    h3 = cl.submit(np.asarray([7, 8, 9], np.int32), rid="dup")
    assert h3._req is h1._req and cl.dedup_hits == 2


def test_match_len_probe_is_read_only(pair):
    eng = _engine(pair, prefix_cache=True)
    prompt = (np.arange(1, 25, dtype=np.int32) % 250) + 1
    eng.submit(prompt, max_new_tokens=4).result()
    prefix = eng.prefix
    before = (prefix.lookups, prefix.hits, prefix.hit_tokens,
              prefix._clock)
    probed = prefix.match_len(prompt)
    assert probed > 0
    assert (prefix.lookups, prefix.hits, prefix.hit_tokens,
            prefix._clock) == before
    got, _ = prefix.match(prompt)
    assert probed == got
    miss = np.full((6,), 7, np.int32)
    assert prefix.match_len(miss) == prefix.match(miss)[0] == 0


# -- faults at the fleet's own points: degrade, never lose -----------------

@pytest.mark.parametrize("phase", ["before", "after"])
def test_route_pick_fault_degrades_without_loss(pair, baseline, phase):
    work, base = baseline
    faults.arm("route.pick", phase, 1, "raise")
    cl = _cluster(pair, n_replicas=2, cluster=True)
    _assert_zero_loss(_drive(cl, work), base)
    assert cl.router.degraded == 1


def test_req_failover_fault_degrades_to_first_healthy(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:7=crash,"
                 "req.failover:before:1=raise")
    cl = _cluster(pair, n_replicas=3, cluster=True)
    _assert_zero_loss(_drive(cl, work), base)
    assert cl.router.degraded >= 1


# -- replica faults: zero loss, the reference's recovery -------------------

@pytest.mark.parametrize("nth,action", [(5, "crash"), (7, "hang"),
                                        (9, "raise")])
def test_replica_fault_zero_loss_as_the_reference(pair, baseline, nth,
                                                  action):
    """One replica fault mid-load: the replica fails (a hang after the
    missed-beat threshold), every request finishes with its stream, the
    replica restarts — and under a crash or a hang ``paddle_tpu``'s
    fleet does the same (a raise takes the crash's failover path)."""
    work, base = baseline
    spec = f"replica.fail:before:{nth}={action}"
    faults.reset(spec)
    cl = _cluster(pair, n_replicas=3, cluster=True)
    handles = _drive(cl, work)
    _assert_zero_loss(handles, base)
    assert cl.failovers > 0 and cl.restarts > 0
    assert all(r.state == "active" for r in cl.replicas)
    assert cl.in_flight == 0 and not cl._orphans
    if action == "raise":
        return
    jfaults.reset(spec)
    jcl = JaxCluster(pair[0], n_replicas=3, cluster=True, **KW)
    _drive(jcl, work, jfaults, audit=False)
    assert _fleet_counts(cl) == _fleet_counts(jcl)


@pytest.mark.parametrize("seed", [7, 21, 1337])
def test_chaos_schedule_zero_loss(pair, baseline, seed):
    """A seeded chaos schedule over every registered point (the port's
    unwired points never fire): whatever fires, no request is lost and
    the streams stay exact."""
    work, base = baseline
    cl = _cluster(pair, n_replicas=3, cluster=True)
    specs = faults.chaos_schedule(seed, steps=48)
    assert specs == jfaults.chaos_schedule(seed, steps=48)
    faults.reset(",".join(specs))
    _assert_zero_loss(_drive(cl, work), base)
    assert cl.in_flight == 0 and not cl._orphans


# -- detection mechanics ---------------------------------------------------

def test_hang_detected_at_missed_beat_threshold(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:2=hang")
    cl = _cluster(pair, n_replicas=2, cluster=True, beat_timeout=3)
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles, hung_at, failed_at = {}, None, None
    while pending or cl.in_flight:
        assert cl.tick < 400
        while pending and pending[0]["arrival_tick"] <= cl.tick:
            w = pending.pop(0)
            handles[w["rid"]] = cl.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                rid=w["rid"])
        cl.step()
        _audit(cl)
        for rep in cl.replicas:
            if rep.hung and hung_at is None:
                hung_at = cl.tick
            if rep.state == "failed" and failed_at is None:
                failed_at = cl.tick
    assert hung_at is not None and failed_at is not None
    assert failed_at - hung_at == 2     # beat_timeout=3, last beat t-1
    assert cl.restarts == 1
    _assert_zero_loss(handles, base)


def test_crash_fails_over_same_tick(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:4=crash")
    cl = _cluster(pair, n_replicas=2, cluster=True)
    seen_failed = []
    pending = sorted(work, key=lambda w: (w["arrival_tick"], w["rid"]))
    handles = {}
    while pending or cl.in_flight:
        assert cl.tick < 400
        while pending and pending[0]["arrival_tick"] <= cl.tick:
            w = pending.pop(0)
            handles[w["rid"]] = cl.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                rid=w["rid"])
        cl.step()
        _audit(cl)
        for rep in cl.replicas:
            if rep.state == "failed" and rep.name not in seen_failed:
                seen_failed.append(rep.name)
                assert rep.engine.in_flight == 0
    assert seen_failed
    _assert_zero_loss(handles, base)


def test_handles_survive_failover(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:3=crash")
    cl = _cluster(pair, n_replicas=2, cluster=True)
    rid0 = work[0]["rid"]
    h = cl.submit(work[0]["prompt_ids"],
                  max_new_tokens=work[0]["max_new_tokens"], rid=rid0)
    assert h.result() == base[rid0]
    assert h.state is RequestState.FINISHED and cl.failovers >= 1


def test_orphans_park_then_rehome(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:3=crash")
    cl = _cluster(pair, n_replicas=1, cluster=True, backoff_base=2)
    handles = _drive(cl, work, max_steps=600)
    assert cl.restarts == 1 and not cl._orphans
    _assert_zero_loss(handles, base)


# -- restart + circuit breaker ---------------------------------------------

def test_breaker_retires_flapping_replica(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:3=crash,"
                 "replica.restart:before:*=raise")
    cl = _cluster(pair, n_replicas=2, cluster=True, restart_budget=2,
                  backoff_base=1)
    handles = _drive(cl, work, max_steps=600)
    victim = [r for r in cl.replicas if r.state == "retired"]
    assert len(victim) == 1 and victim[0].fail_streak == 3
    assert cl.restarts_failed == 2 and cl.restarts == 0
    _assert_zero_loss(handles, base)


def test_probation_resets_streak(pair, baseline):
    work, base = baseline
    faults.reset("replica.fail:before:3=crash")
    cl = _cluster(pair, n_replicas=2, cluster=True, beat_timeout=2,
                  backoff_base=1)
    handles = _drive(cl, work, max_steps=600)
    victim = [r for r in cl.replicas if r.restarts][0]
    assert victim.fail_streak == 0 and victim.state == "active"
    _assert_zero_loss(handles, base)


# -- overload shedding -----------------------------------------------------

def test_req_shed_fault_degrades_to_admission(pair):
    faults.reset("req.shed:before:*=raise")
    cl = _cluster(pair, n_replicas=2, cluster=True, max_queue=1)
    hs = [cl.submit(np.arange(1, 9), max_new_tokens=3, rid=f"s{i}")
          for i in range(4)]
    assert all(h.state is not RequestState.REJECTED for h in hs)
    assert cl.sheds == 0
    for h in hs:
        assert len(h.result()) == 3


def test_shed_overload_terminal_rejected(pair):
    cl = _cluster(pair, n_replicas=2, cluster=True, max_queue=3)
    hs = {f"s{i}": cl.submit(np.arange(1, 7), max_new_tokens=3,
                             rid=f"s{i}") for i in range(8)}
    rejected = {r: h for r, h in hs.items()
                if h.state is RequestState.REJECTED}
    assert rejected and len(rejected) < len(hs)
    for h in rejected.values():
        assert h.finish_reason == "overload"
        assert h._req.retry_after >= 1
        with pytest.raises(RequestRejected) as ei:
            h.result()
        assert ei.value.retry_after >= 1
    for r, h in hs.items():
        if r not in rejected:
            assert len(h.result()) == 3
    assert cl.sheds == len(rejected)
    assert all(cl.request(r) is None for r in rejected)


def test_shed_deadline_unmeetable(pair):
    cl = _cluster(pair, n_replicas=1, cluster=True, shed_deadlines=True)
    backlog = [cl.submit(np.arange(1, 9), max_new_tokens=6, rid=f"b{i}")
               for i in range(4)]
    h_bad = cl.submit(np.arange(1, 5), max_new_tokens=2, deadline=1,
                      rid="tight")
    assert h_bad.state is RequestState.REJECTED
    assert h_bad.finish_reason == "deadline_unmeetable"
    assert h_bad._req.retry_after >= 1
    h_ok = cl.submit(np.arange(1, 5), max_new_tokens=2, deadline=100,
                     rid="loose")
    assert h_ok.state is not RequestState.REJECTED
    assert len(h_ok.result()) == 2
    assert h_ok._req.finish_reason != "deadline"
    for h in backlog:
        h.result()


def test_shedding_off_by_default_is_bitexact(pair, baseline):
    work, base = baseline
    cl = _cluster(pair, n_replicas=3, cluster=True)
    handles = _drive(cl, work)
    assert cl.sheds == 0 and cl.failovers == 0 and cl.restarts == 0
    _assert_zero_loss(handles, base)


def test_router_rechecks_admitting_at_pick_time(pair):
    """A replica that failed after the candidate snapshot must not win
    the pick (the reference drains it; the port fails it)."""
    cl = _cluster(pair, n_replicas=3, cluster=True)
    cands = cl._admitting()
    assert len(cands) == 3
    prompt = np.arange(1, 9).astype(np.int32)
    cl.fail("r0", reason="test")
    rep, _ = cl.router.pick(cands, prompt)
    assert rep.name != "r0"
    r = Router(policy="random", seed=0)
    assert "r0" not in {r.pick(cands, prompt)[0].name for _ in range(20)}
