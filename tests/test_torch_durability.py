"""Durable serving in the port against ``paddle_tpu``: the journal, the
whole-process crash recovery and the hung-replica salvage.

The reference's ``tests/test_durability.py``, ported whole: an accepted
request either finishes with exactly the stream of an uninterrupted run
or is reported rejected, across any failure up to a SIGKILL of the
serving process.  The subprocesses are
``python -m paddle_tpu_torch.testing.durability_worker`` on the CPU,
killed with SIGKILL at seeded journal depths or by an armed ``crash`` /
``truncate`` fault (exit 53), and recovered with
``ServingCluster.recover`` on the same seeded weights.

Across packages: both write the same journal bytes for the same run
(stopped at a tick, then recovered and finished); the port recovers a journal that ``paddle_tpu`` wrote mid-run and
``paddle_tpu`` one that the port wrote, both finish with the
uninterrupted streams, and their ``recovery`` reports are equal.  The
uninterrupted streams are the port's single engine's, held here against
``paddle_tpu``'s on the same weights.

Weights: the worker's ``tiny`` setup (vocab 256, hidden 64, 2 layers,
fp32, drawn on the CPU from seed 11), loaded into the reference's model
through ``models.numpy_state``.  Streams must be identical.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.server import ServingCluster as JaxCluster
from paddle_tpu.inference.server import ServingEngine as JaxEngine
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference.server import (
    DEAD_STATES, RequestState, ServingCluster, ServingEngine,
    check_pool_invariants, replay,
)
from paddle_tpu_torch.inference.server.wal import (
    compact, segment_paths, stream_crc,
)
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.testing.durability_worker import build

from test_torch_serving_faults import reference_tiny_llama  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    """(model, cfg, params, engine kwargs, work): the worker's tiny
    setup and the reference's model on its weights."""
    cfg, params, kw, work = build("tiny", "cpu")
    model = reference_tiny_llama(params, cfg)
    return model, cfg, params, kw, work


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


def _jkw(kw):
    return {k: v for k, v in kw.items() if k not in ("device", "dtype")}


@pytest.fixture(scope="module")
def baseline(setup):
    """{rid: tokens} of a fault-free, journal-free single engine — the
    uninterrupted run every recovered stream must match — equal to
    ``paddle_tpu``'s."""
    model, cfg, params, kw, work = setup
    eng = ServingEngine(cfg, params, **kw)
    base = {w["rid"]: eng.submit(
        w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
        rid=w["rid"]).result() for w in work}
    jeng = JaxEngine(model, **_jkw(kw))
    assert base == {w["rid"]: jeng.submit(
        w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
        rid=w["rid"]).result() for w in work}
    return base


def _cluster(setup, **kw):
    _, cfg, params, ekw, _ = setup
    return ServingCluster(cfg, params, n_replicas=2, cluster=True,
                          **dict(ekw, **kw))


def _recover(setup, wal_dir, **kw):
    _, cfg, params, ekw, _ = setup
    return ServingCluster.recover(cfg, params, str(wal_dir), n_replicas=2,
                                  cluster=True, **dict(ekw, **kw))


def _audit(cl):
    for rep in cl.replicas:
        if rep.state not in DEAD_STATES:
            check_pool_invariants(rep.engine.executor.cache,
                                  rep.engine.prefix)


def _drive(cl, work, max_steps=400, audit=True, until=None):
    """Submit at arrival ticks and step until drained (or until tick
    ``until``); returns {rid: handle}."""
    handles = {}
    i = 0
    while i < len(work) or cl.in_flight:
        if until is not None and cl.tick >= until:
            break
        while i < len(work) and work[i]["arrival_tick"] <= cl.tick:
            w = work[i]
            i += 1
            handles[w["rid"]] = cl.submit(
                w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
                rid=w["rid"])
        cl.step()
        if audit:
            _audit(cl)
        assert cl.tick < max_steps, "cluster did not drain"
    return handles


def _drain(cl, max_steps=400, audit=True):
    while cl.in_flight:
        cl.step()
        if audit:
            _audit(cl)
        assert cl.tick < max_steps, "recovered cluster did not drain"


def _assert_bit_identical(handles, baseline):
    for rid, h in handles.items():
        assert h.tokens == baseline[rid], \
            f"{rid}: {h.tokens} != baseline {baseline[rid]}"


def _bytes(path):
    return [open(p, "rb").read() for p in segment_paths(path)]


# -- gate + plumbing -------------------------------------------------------

def test_engine_follows_pt_wal(setup, monkeypatch, tmp_path):
    _, cfg, params, kw, _ = setup
    monkeypatch.setenv("PT_WAL", "on")
    monkeypatch.setenv("PT_WAL_DIR", str(tmp_path / "j"))
    eng = ServingEngine(cfg, params, **kw)
    assert eng.wal is not None and eng.scheduler.wal is eng.wal
    assert ServingEngine(cfg, params, wal=False, **kw).wal is None
    monkeypatch.setenv("PT_WAL", "bogus")
    with pytest.raises(ValueError, match="PT_WAL"):
        ServingEngine(cfg, params, **kw)
    monkeypatch.delenv("PT_WAL")
    assert ServingEngine(cfg, params, **kw).stats()["durability"] == {
        "wal": None, "dedup_hits": 0}


def test_wal_off_is_bitexact_default(setup, baseline, monkeypatch):
    monkeypatch.delenv("PT_WAL", raising=False)
    cl = _cluster(setup)
    assert cl.wal is None
    assert all(r.engine.wal is None and r.engine.scheduler.wal is None
               for r in cl.replicas)
    _assert_bit_identical(_drive(cl, setup[4]), baseline)


def test_wal_journal_roundtrip(setup, baseline, tmp_path):
    work = setup[4]
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    _assert_bit_identical(_drive(cl, work), baseline)
    recs, report = replay(tmp_path / "j")
    assert report["corrupt"] == 0 and report["torn_bytes"] == 0
    subs = [r for r in recs if r["t"] == "submit"]
    fins = {r["rid"]: r for r in recs if r["t"] == "finish"}
    admits = {r["rid"] for r in recs if r["t"] == "admit"}
    assert {s["rid"] for s in subs} == set(baseline) == admits
    for rid, toks in baseline.items():
        assert [r["tok"] for r in recs
                if r["t"] == "token" and r["rid"] == rid] == toks, rid
        assert fins[rid]["n"] == len(toks)
        assert fins[rid]["crc"] == stream_crc(toks)
    by_rid = {w["rid"]: w for w in work}
    for s in subs:
        assert s["prompt"] == list(map(int, by_rid[s["rid"]]["prompt_ids"]))


# -- idempotent duplicate submit -------------------------------------------

def test_engine_duplicate_submit_returns_original(setup, tmp_path):
    _, cfg, params, kw, _ = setup
    eng = ServingEngine(cfg, params, wal=str(tmp_path / "j"), **kw)
    h1 = eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4,
                    rid="dup")
    h2 = eng.submit(np.asarray([9, 9, 9], np.int32), max_new_tokens=4,
                    rid="dup")
    assert h2._req is h1._req and eng.dedup_hits == 1
    toks = h1.result()
    h3 = eng.submit(np.asarray([1, 2, 3], np.int32), rid="dup")
    assert h3._req is h1._req and h3.tokens == toks
    recs, _ = replay(tmp_path / "j")
    assert sum(1 for r in recs if r["t"] == "dedup") == 2
    assert sum(1 for r in recs if r["t"] == "submit") == 1
    assert eng.stats()["durability"]["dedup_hits"] == 2


def test_anonymous_rids_skip_explicit_collisions(setup):
    _, cfg, params, kw, _ = setup
    eng = ServingEngine(cfg, params, **kw)
    h0 = eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=2,
                    rid="req-0")
    h1 = eng.submit(np.asarray([4, 5, 6], np.int32), max_new_tokens=2)
    h2 = eng.submit(np.asarray([7, 8, 9], np.int32), max_new_tokens=2)
    assert len({h0._req.rid, h1._req.rid, h2._req.rid}) == 3
    assert eng.dedup_hits == 0
    cl = _cluster(setup)
    c0 = cl.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=2,
                   rid="req-0")
    c1 = cl.submit(np.asarray([4, 5, 6], np.int32), max_new_tokens=2)
    c2 = cl.submit(np.asarray([7, 8, 9], np.int32), max_new_tokens=2)
    assert len({c0._req.rid, c1._req.rid, c2._req.rid}) == 3
    assert cl.dedup_hits == 0


# -- crash recovery (in process) -------------------------------------------

def test_recover_serves_finished_from_log(setup, baseline, tmp_path):
    work = setup[4]
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    _drive(cl, work)
    del cl      # whole-process crash: the journal is all that survives
    cl2 = _recover(setup, tmp_path / "j")
    assert cl2.recovery["served_from_log"] == len(baseline)
    assert cl2.recovery["resubmitted"] == 0
    for rid, toks in baseline.items():
        h = cl2.recovered_handles[rid]
        assert h.state in (RequestState.FINISHED, RequestState.TRUNCATED)
        assert h.tokens == toks and h._req.recovered
    assert cl2.stats()["decode_tokens"] == 0     # nothing recomputed
    handles = {w["rid"]: cl2.submit(
        w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
        rid=w["rid"]) for w in work}
    assert cl2.dedup_hits == len(work)
    _assert_bit_identical(handles, baseline)


def test_recover_resubmits_in_flight_twice(setup, baseline, tmp_path):
    work = setup[4]
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    _drive(cl, work, until=8)       # abandon mid-load
    submitted = set(cl._owner) | {r.rid for r in cl._orphans}
    del cl
    cl2 = _recover(setup, tmp_path / "j")
    rec = cl2.recovery
    assert rec["resubmitted"] > 0
    assert rec["served_from_log"] + rec["resubmitted"] == len(submitted)
    assert set(cl2.recovered_handles) == submitted
    handles = {w["rid"]: cl2.submit(
        w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
        rid=w["rid"]) for w in work}
    assert cl2.dedup_hits == len(submitted)
    _drain(cl2)
    _assert_bit_identical(handles, baseline)
    # recovery is journaled too: a second recovery still converges
    cl3 = _recover(setup, tmp_path / "j")
    for rid, toks in baseline.items():
        assert cl3.recovered_handles[rid].tokens == toks
    assert cl3.recovery["resubmitted"] == 0


def test_recover_advances_anonymous_rids(setup, tmp_path):
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    old = [cl.submit(np.asarray([3, i + 1], np.int32), max_new_tokens=3)
           for i in range(3)]
    rids = {h._req.rid for h in old}
    assert rids == {"req-0", "req-1", "req-2"}
    for h in old:
        h.result()
    del cl
    cl2 = _recover(setup, tmp_path / "j")
    assert cl2._next_rid == 3
    h = cl2.submit(np.asarray([9, 9], np.int32), max_new_tokens=2)
    assert h._req.rid not in rids and not h._req.recovered
    assert cl2.dedup_hits == 0 and h.result()


def test_recover_resubmit_after_shed_supersedes_reject(setup, tmp_path):
    _, cfg, params, kw, _ = setup
    eng = ServingEngine(cfg, params, wal=str(tmp_path / "j"), **kw)
    for rid in ("r1", "r2"):
        eng.wal.append({"t": "reject", "rid": rid, "reason": "overload",
                        "retry_after": 2})
    toks = eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4,
                      rid="r1").result()
    eng.wal.close()
    cl = _recover(setup, tmp_path / "j")
    assert set(cl.recovered_handles) == {"r1"}
    h = cl.recovered_handles["r1"]
    assert h.state is not RequestState.REJECTED and h.tokens == toks
    assert cl.recovery["corrupt"] == 0
    assert cl.recovery["served_from_log"] == 1
    h2 = cl.submit(np.asarray([5, 6], np.int32), max_new_tokens=2,
                   rid="r2")
    assert cl.dedup_hits == 0 and h2.result()


def _drop_finish(wal_dir, rid):
    """Delete ``rid``'s finish line: what a crash between its last token
    record and its finish record leaves."""
    key = f'"t":"finish","rid":"{rid}"'.encode()
    for seg in segment_paths(wal_dir):
        lines = open(seg, "rb").read().splitlines(keepends=True)
        kept = [ln for ln in lines if key not in ln]
        if len(kept) < len(lines):
            open(seg, "wb").write(b"".join(kept))
            return
    pytest.fail(f"no finish record for {rid}")


@pytest.mark.parametrize("reason", ["length", "eos"])
def test_recover_completes_stream_without_finish(setup, tmp_path, reason):
    """A stream whose every token record reached the journal but whose
    finish record did not is complete: recovery serves it from the log
    with exactly its tokens and journals the missing finish (paddle_tpu
    resubmits it instead, and its re-prefill emits one token too many:
    the one place the two reports differ)."""
    model, cfg, params, kw, _ = setup
    prompt = np.asarray([5, 17, 3, 9], np.int32)
    eos = None
    if reason == "eos":
        eos = ServingEngine(cfg, params, **kw).submit(
            prompt, max_new_tokens=6).result()[1]
    ekw = dict(kw, eos_token_id=eos)
    eng = ServingEngine(cfg, params, wal=str(tmp_path / "j"), **ekw)
    toks = eng.submit(prompt, max_new_tokens=6, rid="a").result()
    eng.submit(prompt[:2], max_new_tokens=6, rid="b").result()
    eng.wal.close()
    assert len(toks) == (2 if reason == "eos" else 6)
    _drop_finish(tmp_path / "j", "a")
    for _ in range(2):      # the second recovery reads the journaled finish
        cl = ServingCluster.recover(cfg, params, str(tmp_path / "j"),
                                    n_replicas=2, cluster=True, **ekw)
        assert cl.recovery["served_from_log"] == 2
        assert cl.recovery["resubmitted"] == 0
        h = cl.recovered_handles["a"]
        assert h.state is RequestState.FINISHED and h.tokens == toks
        assert h._req.finish_reason == reason and not cl.in_flight
        cl.wal.close()
    fins = [r for r in replay(tmp_path / "j")[0]
            if r["t"] == "finish" and r["rid"] == "a"]
    assert len(fins) == 1 and fins[0]["n"] == len(toks) \
        and fins[0]["crc"] == stream_crc(toks)
    if reason == "length":
        _drop_finish(tmp_path / "j", "a")
        theirs = JaxCluster.recover(model, str(tmp_path / "j"),
                                    n_replicas=2, cluster=True, **_jkw(kw))
        assert (theirs.recovery["served_from_log"],
                theirs.recovery["resubmitted"]) == (1, 1)


# -- across packages ---------------------------------------------------------

def test_each_package_recovers_the_other_s_journal(setup, baseline,
                                                   tmp_path):
    """Both packages serve the load into a journal and stop at tick 8
    (a crash): the journals are byte-equal; the port recovers the
    reference's and the reference the port's, with equal reports, and
    both finish every stream as the uninterrupted run."""
    model, _, _, kw, work = setup
    cl = _cluster(setup, wal=str(tmp_path / "port"))
    _drive(cl, work, until=8)
    jcl = JaxCluster(model, n_replicas=2, cluster=True,
                     wal=str(tmp_path / "ref"), **_jkw(kw))
    _drive(jcl, work, until=8, audit=False)
    assert cl.tick == jcl.tick == 8
    del cl, jcl
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")
    mine = _recover(setup, tmp_path / "ref")
    theirs = JaxCluster.recover(model, str(tmp_path / "port"),
                                n_replicas=2, cluster=True, **_jkw(kw))
    assert mine.recovery == theirs.recovery
    assert mine.recovery["resubmitted"] > 0
    for c in (mine, theirs):
        handles = {w["rid"]: c.submit(
            w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
            rid=w["rid"]) for w in work}
        _drain(c, audit=c is mine)
        _assert_bit_identical(handles, baseline)
    # each writes its recovery's continuation: the same bytes again
    mine.wal.close()
    theirs.wal.close()
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")


# -- crash recovery (a real subprocess) -------------------------------------

def _run_worker_until(wal_dir, kill_after, fault_spec="", timeout=240):
    """Spawn the worker; SIGKILL it once its journal holds
    ``kill_after`` records (or let an armed fault end it).  Returns
    (returncode, drained)."""
    env = {**os.environ, "PT_FAULTS": "",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.testing.durability_worker",
         str(wal_dir), fault_spec, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    drained = False
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            assert time.monotonic() < deadline, "worker timed out"
            if line.startswith("DRAINED"):
                drained = True
            if kill_after is not None and line.startswith("tick "):
                if int(line.split()[-1]) >= kill_after:
                    proc.kill()          # SIGKILL, no goodbye
                    break
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, drained


def _recover_and_verify(setup, wal_dir, baseline):
    work = setup[4]
    cl = _recover(setup, wal_dir)
    _audit(cl)
    assert cl.recovery["records"] > 0
    handles = {w["rid"]: cl.submit(
        w["prompt_ids"], max_new_tokens=w["max_new_tokens"],
        rid=w["rid"]) for w in work}
    assert cl.dedup_hits == len(cl.recovered_handles)
    _drain(cl)
    _assert_bit_identical(handles, baseline)
    return cl


@pytest.mark.parametrize("kill_after", [6, 20, 34])
def test_sigkill_subprocess_recovers(setup, baseline, tmp_path,
                                     kill_after):
    rc, drained = _run_worker_until(tmp_path / "j", kill_after)
    assert rc == -signal.SIGKILL and not drained
    cl = _recover_and_verify(setup, tmp_path / "j", baseline)
    assert cl.recovery["resubmitted"] + cl.recovery["served_from_log"] \
        == len(cl.recovered_handles)


@pytest.mark.parametrize("fault_spec", [
    "wal.append:after:12=crash",     # a hard kill right after an append
    "wal.fsync:before:2=crash",      # ...and before a batched barrier
    "wal.append:after:12=truncate",  # a torn write + a hard kill
])
def test_crash_fault_subprocess_recovers(setup, baseline, tmp_path,
                                         fault_spec):
    rc, drained = _run_worker_until(tmp_path / "j", None,
                                    fault_spec=fault_spec)
    assert rc == faults.EXIT_CODE == 53 and not drained
    _recover_and_verify(setup, tmp_path / "j", baseline)


def test_wal_compact_preserves_recovery(setup, baseline, tmp_path):
    rc, drained = _run_worker_until(tmp_path / "j", 20)
    assert rc == -signal.SIGKILL and not drained
    rep = compact(tmp_path / "j")
    assert rep["records_kept"] > 0
    _recover_and_verify(setup, tmp_path / "j", baseline)


def test_corrupt_token_record_downgrades_to_recompute(setup, baseline,
                                                      tmp_path):
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    _drive(cl, setup[4])
    del cl
    victim = max(baseline, key=lambda r: len(baseline[r]))
    for seg in segment_paths(tmp_path / "j"):
        with open(seg, "r+b") as f:
            raw = f.read()
            pos = raw.find(f'"t":"token","rid":"{victim}"'.encode())
            if pos >= 0:
                f.seek(pos)
                f.write(b"X")
                break
    else:
        pytest.fail(f"no token record found for {victim}")
    cl2 = _recover(setup, tmp_path / "j")
    assert cl2.recovery["corrupt"] >= 1
    assert cl2.recovery["resubmitted"] >= 1
    assert not cl2.recovered_handles[victim]._req.terminal
    _drain(cl2)
    for rid, toks in baseline.items():
        assert cl2.recovered_handles[rid].tokens == toks, rid


# -- journaling faults never take serving down ------------------------------

@pytest.mark.parametrize("point,phase", [
    ("wal.append", "before"), ("wal.append", "after"),
    ("wal.fsync", "before"), ("wal.fsync", "after"),
])
def test_wal_fault_degrades_not_serving(setup, baseline, tmp_path, point,
                                        phase):
    faults.reset(f"{point}:{phase}:3=raise")
    cl = _cluster(setup, wal=str(tmp_path / "j"))
    cl.wal.fsync_every = 2
    _assert_bit_identical(_drive(cl, setup[4]), baseline)
    assert cl.wal.errors >= 1


# -- hung-replica KV-page salvage ---------------------------------------------

def _hang_and_drive(setup, spec, **kw):
    faults.reset(spec)
    cl = _cluster(setup, beat_timeout=2, **kw)
    handles = _drive(cl, setup[4])
    faults.reset("")
    return cl, handles


def test_salvage_on_hang_skips_reprefill(setup, baseline):
    hang = "replica.fail:before:7=hang"
    cl, handles = _hang_and_drive(setup, hang)
    _assert_bit_identical(handles, baseline)
    assert cl.salvages >= 1 and cl.salvaged_pages > 0
    assert cl.failovers >= cl.salvages
    ref, ref_handles = _hang_and_drive(setup, hang, salvage=False)
    _assert_bit_identical(ref_handles, baseline)
    assert ref.salvages == 0
    assert cl.stats()["prefill_tokens"] < ref.stats()["prefill_tokens"]
    # the reference's fleet salvages the same pages
    model, _, _, kw, work = setup
    jfaults.reset(hang)
    jcl = JaxCluster(model, n_replicas=2, cluster=True, beat_timeout=2,
                     **_jkw(kw))
    _drive(jcl, work, audit=False)
    assert (cl.salvages, cl.salvaged_pages, cl.failovers) \
        == (jcl.salvages, jcl.salvaged_pages, jcl.failovers)


@pytest.mark.parametrize("spec,expect_salvage", [
    ("replica.fail:before:7=hang,kv.salvage:before:1=inject", False),
    ("replica.fail:before:7=hang,kv.salvage:before:1=raise", False),
    ("replica.fail:before:7=hang,kv.salvage:after:1=raise", True),
])
def test_salvage_faults_fall_back_bit_identically(setup, baseline, spec,
                                                  expect_salvage):
    cl, handles = _hang_and_drive(setup, spec)
    _assert_bit_identical(handles, baseline)
    if expect_salvage:
        assert cl.salvages >= 1 and cl.salvages_failed == 0
    else:
        assert cl.salvages == 0 and cl.salvages_failed >= 1


def test_crash_victim_never_salvaged(setup, baseline):
    cl, handles = _hang_and_drive(setup, "replica.fail:before:7=crash")
    _assert_bit_identical(handles, baseline)
    assert cl.salvages == 0 and cl.failovers >= 1


def test_int8_salvage_recovers(setup, tmp_path):
    """Under int8 pools a salvage re-quantizes the dequantized pages; a
    copy that would not land bit for bit fails the crc check and the
    request recomputes — either way every stream equals the fault-free
    int8 fleet's."""
    _, cfg, params, kw, work = setup
    clean = _cluster(setup, quant="int8")
    want = {r: h.tokens for r, h in _drive(clean, work).items()}
    cl, handles = _hang_and_drive(setup, "replica.fail:before:7=hang",
                                  quant="int8")
    assert {r: h.tokens for r, h in handles.items()} == want
    assert cl.salvages + cl.salvages_failed >= 1
