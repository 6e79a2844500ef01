"""The port's elastic fleet against ``paddle_tpu``'s: ``drain``, ``join``
and disaggregated prefill → decode handoff.

As in the reference's ``tests/test_cluster.py``: a drain re-steers the
drained replica's queue and the fleet (with a joined replica) finishes
every request with a single engine's stream; a disaggregated fleet
prefills on one role and decodes on the other, each handed-off
sequence's pages landing refcounted; every page pool passes its audit.
Each case also drives ``paddle_tpu``'s fleet through the same calls and
holds the streams and the fleet's counters equal to it (the fault
matrix under ``replica.drain``, ``replica.join`` and ``kv.handoff`` is
``tests/test_torch_elastic_faults.py``, a file of its own so that two
workers share the fleets' compiles).  With the journal on, ``recover`` after a
drain and after a handoff is held against ``paddle_tpu``'s, the journals
byte for byte.

Weights: the port's seeded tiny Llama (vocab 256, hidden 64, 2 layers,
fp32), loaded into the reference's model.  Streams must be identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingCluster as JaxCluster
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.testing.load import run_load as jax_run_load
from paddle_tpu_torch.inference.server import (
    DEAD_STATES, RequestState, ServingCluster, ServingEngine,
    check_pool_invariants,
)
from paddle_tpu_torch.inference.server.wal import segment_paths
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.durability_worker import build
from paddle_tpu_torch.testing.load import LoadSpec, generate_load, run_load

from test_torch_serving_faults import reference_tiny_llama  # noqa: E402

KW = dict(max_seqs=2, page_size=4, max_len=64, prefill_chunk=8)
#: tests/test_chaos.py's load (as tests/test_torch_cluster.py)
LOAD = dict(n_requests=8, mean_interarrival=1.0, prompt_len=(4, 14),
            max_new=(4, 8), vocab=256, seed=3)


@pytest.fixture(scope="module")
def pair():
    cfg, params, _, _ = build("tiny", "cpu")
    model = reference_tiny_llama(params, cfg)
    return model, cfg, params


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


@pytest.fixture(scope="module")
def baseline(pair):
    """The single-engine streams of the load, held against
    ``paddle_tpu``'s engine on the same weights."""
    work = generate_load(LoadSpec(**LOAD))
    out = run_load(_engine(pair), work)
    ref = jax_run_load(JaxEngine(pair[0], **KW), work)
    base = {r: h.tokens for r, h in out["handles"].items()}
    assert base == {r: h.tokens for r, h in ref["handles"].items()}
    return work, base


def _engine(pair, **kw):
    _, cfg, params = pair
    return ServingEngine(cfg, params, dtype=torch.float32, device="cpu",
                         **dict(KW, **kw))


def _fleets(pair, **kw):
    """(port fleet, paddle_tpu fleet) of the same construction."""
    model, cfg, params = pair
    wal = kw.pop("wal", None)
    port = ServingCluster(cfg, params, cluster=True, dtype=torch.float32,
                          device="cpu", wal=None if wal is None
                          else str(wal[0]), **dict(KW, **kw))
    ref = JaxCluster(model, cluster=True, wal=None if wal is None
                     else str(wal[1]), **dict(KW, **kw))
    return port, ref


def _audit(cl):
    for rep in cl.replicas:
        if rep.state not in DEAD_STATES:
            check_pool_invariants(rep.engine.executor.cache,
                                  rep.engine.prefix)


def _submit_all(cl, work):
    return {w["rid"]: cl.submit(w["prompt_ids"],
                                max_new_tokens=w["max_new_tokens"],
                                rid=w["rid"])
            for w in work}


def _run(cl, audit, until=None, max_steps=400):
    while cl.in_flight:
        if until is not None and cl.tick >= until:
            return
        cl.step()
        if audit:
            _audit(cl)
        assert cl.tick < max_steps, "the fleet did not drain"


def _counts(cl):
    return dict(resteered=cl.resteered, drains=cl.drains,
                drains_aborted=cl.drains_aborted, joins=cl.joins,
                joins_aborted=cl.joins_aborted, handoffs=cl.handoffs,
                handoff_tokens=cl.handoff_tokens,
                handoffs_skipped=cl.handoffs_skipped,
                failovers=cl.failovers,
                roles=[r.role for r in cl.replicas],
                states=[r.state for r in cl.replicas],
                submitted=[r.engine.metrics.submitted for r in cl.replicas],
                decode_tokens=[r.engine.metrics.decode_tokens
                               for r in cl.replicas])


def _tokens(handles):
    return {rid: h.tokens for rid, h in handles.items()}


def _assert_served(handles, base):
    for rid, h in handles.items():
        assert h.state.value == RequestState.FINISHED.value, (rid, h.state)
        assert h.tokens == base[rid], f"{rid}: stream diverged"


def _drain_and_join(cl, work, audit):
    """Burst-submit, three ticks, drain r0 (which holds a queue by
    then), join, run to the end."""
    handles = _submit_all(cl, work)
    for _ in range(3):
        cl.step()
    rep = cl.drain("r0")
    assert rep.state in ("draining", "drained")
    assert cl.join() is not None
    _run(cl, audit)
    return handles


# -- drain and join -----------------------------------------------------------

def test_drain_resteers_queue_and_join_serves(pair, baseline):
    work, base = baseline
    cl, jcl = _fleets(pair, n_replicas=2)
    handles = _drain_and_join(cl, work, audit=True)
    assert cl.resteered > 0              # queued work moved, not lost
    assert len(cl.replicas) == 3
    assert cl.replica("r0").state == "drained"
    assert cl.replica("r0").engine.in_flight == 0
    _assert_served(handles, base)
    jhandles = _drain_and_join(jcl, work, audit=False)
    assert _tokens(handles) == _tokens(jhandles)
    assert _counts(cl) == _counts(jcl)
    assert cl.stats()["router"] == jcl.stats()["router"]
    page = cl._statusz()
    assert page["drains"] == {"done": 1, "aborted": 0}
    assert page["joins"]["done"] == 1 and page["joins"]["last"]["replica"] \
        == "r2"
    with pytest.raises(RuntimeError, match="last admitting"):
        for r in cl.replicas:            # draining every admitting
            cl.drain(r.name)             # replica must refuse the last
    _audit(cl)


def test_drain_unknown_replica_raises(pair):
    cl = ServingCluster(pair[1], pair[2], n_replicas=2, cluster=True,
                        dtype=torch.float32, device="cpu", **KW)
    with pytest.raises(KeyError, match="no replica named"):
        cl.drain("r9")


def test_drain_last_admitting_and_dead_replicas_raise(pair):
    """The refusals, each as the reference refuses: the last admitting
    replica; a failed replica (nothing to hand off); a double drain is
    a no-op that fires no point and counts nothing."""
    cl, jcl = _fleets(pair, n_replicas=2)
    for c, fm in ((cl, faults), (jcl, jfaults)):
        spec = fm.arm("replica.drain", "before", "*", "delay", "0")
        first = c.drain("r0")
        assert first.state == "draining"        # idle: retires next tick
        assert c.drain("r0") is first           # a double drain: no-op
        assert spec.hits == 1 and c.drains == 1
        with pytest.raises(RuntimeError, match="last admitting"):
            c.drain("r1")
        assert spec.hits == 1
    cl2, jcl2 = _fleets(pair, n_replicas=3)
    for c in (cl2, jcl2):
        c.fail("r1")
        with pytest.raises(ValueError, match="only active replicas drain"):
            c.drain("r1")
        assert c.drains == 0


def test_double_drain_is_a_no_op(pair, baseline):
    work, base = baseline
    cl, jcl = _fleets(pair, n_replicas=2)
    out = []
    for c in (cl, jcl):
        handles = _submit_all(c, work)
        for _ in range(3):
            c.step()
        first = c.drain("r0")
        moved = c.resteered
        assert c.drain("r0") is first        # the same replica back
        assert c.resteered == moved and c.drains == 1
        _run(c, audit=c is cl)
        assert c.drain("r0").state == "drained" and c.drains == 1
        out.append(_tokens(handles))
    assert out[0] == out[1] == base


def test_join_while_draining(pair, baseline):
    """A join during a drain builds a fresh replica under a fresh name
    and never touches the draining one; the re-steered queue lands on
    the newcomer only from the next routing decision on."""
    work, base = baseline
    cl, jcl = _fleets(pair, n_replicas=2)
    got = []
    for c in (cl, jcl):
        handles = _submit_all(c, work)
        for _ in range(2):
            c.step()
        c.drain("r0")
        assert c.replica("r0").state == "draining"
        rep = c.join()
        assert rep.name == "r2" and rep.state == "active"
        assert c.replica("r0").state == "draining"
        assert rep.engine.metrics.submitted == 0
        _run(c, audit=c is cl)
        assert c.replica("r0").state == "drained"
        got.append((_tokens(handles), _counts(c)))
    assert got[0] == got[1]
    assert got[0][0] == base


def test_join_roles_and_graph_report(pair):
    cl = ServingCluster(pair[1], pair[2], n_replicas=2, cluster=True,
                        disaggregated=True, dtype=torch.float32,
                        device="cpu", **KW)
    rep = cl.join()
    assert rep.role == "decode" and rep.name == "r2"
    assert cl.join(role="prefill").role == "prefill"
    with pytest.raises(ValueError, match="join role"):
        cl.join(role="bogus")
    last = cl.last_join
    assert last["replica"] == "r3" and last["role"] == "prefill"
    # the CPU captures nothing: the report is still formed
    assert last["graphs_captured"] == 0 and last["capture_s"] == 0.0
    assert [r["role"] for r in cl._statusz()["replicas"]] == [
        "prefill", "decode", "decode", "prefill"]


# -- disaggregated prefill -> decode ------------------------------------------

def test_disaggregated_handoff_parity_and_invariants(pair, baseline):
    work, base = baseline
    cl, jcl = _fleets(pair, n_replicas=2, disaggregated=True)
    assert [r.role for r in cl.replicas] == ["prefill", "decode"]
    assert [r.admitting for r in cl.replicas] == [True, False]
    cl.handoff_audit = []
    handles = _submit_all(cl, work)
    _run(cl, audit=True)
    assert cl.handoffs > 0
    _assert_served(handles, base)
    # roles were respected: the decode replica admitted nothing but
    # decoded the handed-off sequences
    decode = cl.replica("r1").engine
    assert decode.metrics.submitted == 0
    assert decode.metrics.decode_tokens > 0
    # every copy landed as gathered (crc32 of the K/V, source vs target)
    assert len(cl.handoff_audit) == cl.handoffs
    for rec in cl.handoff_audit:
        assert rec["crc_src"] == rec["crc_dst"], rec
        assert rec["pages"] == -(-rec["tokens"] // KW["page_size"])
    assert sum(r["tokens"] for r in cl.handoff_audit) == cl.handoff_tokens
    jhandles = _submit_all(jcl, work)
    _run(jcl, audit=False)
    assert _tokens(handles) == _tokens(jhandles)
    assert _counts(cl) == _counts(jcl)
    assert cl._statusz()["handoffs"] == jcl._statusz()["handoffs"]
    _audit(cl)


@pytest.mark.parametrize("n_replicas,n_prefill", [(3, None), (3, 2)])
def test_disaggregated_roles_as_the_reference(pair, baseline, n_replicas,
                                              n_prefill):
    work, base = baseline
    cl, jcl = _fleets(pair, n_replicas=n_replicas, disaggregated=True,
                      n_prefill=n_prefill)
    assert [r.role for r in cl.replicas] == [r.role for r in jcl.replicas]
    res = run_load(cl, work)
    jres = jax_run_load(jcl, work)
    assert {r: h.tokens for r, h in res["handles"].items()} == base
    assert {r: h.tokens for r, h in jres["handles"].items()} == base
    assert _counts(cl) == _counts(jcl)
    _audit(cl)


def test_disaggregated_needs_two_replicas(pair):
    _, cfg, params = pair
    with pytest.raises(ValueError, match="disaggregated"):
        ServingCluster(cfg, params, n_replicas=1, cluster=True,
                       disaggregated=True, dtype=torch.float32,
                       device="cpu", **KW)
    for bad in (0, 2):
        with pytest.raises(ValueError, match="n_prefill"):
            ServingCluster(cfg, params, n_replicas=2, cluster=True,
                           disaggregated=True, n_prefill=bad,
                           dtype=torch.float32, device="cpu", **KW)
    # the gate off collapses the fleet to one mixed engine
    off = ServingCluster(cfg, params, n_replicas=2, cluster=False,
                         disaggregated=True, dtype=torch.float32,
                         device="cpu", **KW)
    assert not off.disaggregated and [r.role for r in off.replicas] == [
        "mixed"]


# -- the journal: recover after a drain and after a handoff ------------------

def _bytes(path):
    return [open(p, "rb").read() for p in segment_paths(path)]


@pytest.mark.parametrize("kind", ["drain", "handoff"])
def test_recover_after_elastic_moves_as_the_reference(pair, baseline,
                                                      tmp_path, kind):
    """Both fleets serve the load into a journal through a drain + join
    (or disaggregated, with handoffs) and stop at tick 8, as a crash
    would: the journals are byte-equal; each package recovers its own
    journal with equal reports, finishes every stream as the
    uninterrupted run, and journals the same continuation."""
    work, base = baseline
    kw = dict(n_replicas=2, disaggregated=kind == "handoff")
    cl, jcl = _fleets(pair, wal=(tmp_path / "port", tmp_path / "ref"),
                      **kw)
    for c in (cl, jcl):
        _submit_all(c, work)
        for _ in range(3):
            c.step()
        if kind == "drain":
            c.drain("r0")
            c.join()
        _run(c, audit=c is cl, until=8)
        assert c.tick == 8 and c.in_flight
        if kind == "handoff":
            assert c.handoffs > 0
        else:
            assert c.resteered > 0
    del cl, jcl
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")
    model, cfg, params = pair
    mine = ServingCluster.recover(cfg, params, str(tmp_path / "port"),
                                  cluster=True, dtype=torch.float32,
                                  device="cpu", **dict(KW, **kw))
    theirs = JaxCluster.recover(model, str(tmp_path / "ref"), cluster=True,
                                **dict(KW, **kw))
    assert mine.recovery == theirs.recovery
    assert mine.recovery["resubmitted"] > 0
    for c in (mine, theirs):
        handles = _submit_all(c, work)
        _run(c, audit=c is mine)
        _assert_served(handles, base)
    mine.wal.close()
    theirs.wal.close()
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")


def test_elastic_points_registered():
    for point in ("replica.drain", "replica.join", "kv.handoff"):
        assert point in faults.REGISTERED
    assert np.all([p in jfaults.REGISTERED for p in faults.REGISTERED])
