"""The port's write-ahead journal against ``paddle_tpu``'s.

``paddle_tpu_torch/inference/server/wal.py`` is a copy of the
reference's module.  The same record sequence must give byte-equal
segments in both packages (rotation included), and each package must
replay and compact the other's journal to the same records, the same
report and the same bytes.  Then the reference's journal-level tests
(``tests/test_durability.py``), on the port: fsync batching, rotation, a
roll that survives a failing fsync, compaction (terminal requests
dropped, live ones kept, ``compact_every``, the crash window), a torn
tail, a corrupt interior record and a ``wal.replay`` raise that leaves
the journal replayable.  Byte equality, no tolerance.
"""
import os
import shutil

import pytest

from paddle_tpu.inference.server import wal as jwal
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference.server import wal
from paddle_tpu_torch.inference.server.wal import (
    WriteAheadLog, compact, replay, resolve_wal, segment_paths, stream_crc,
)
from paddle_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


def _journal_stream(w, rid, toks, finish=True):
    w.append({"t": "submit", "rid": rid, "prompt": [1, 2, 3],
              "max_new": len(toks), "prio": 0, "deadline": None})
    w.append({"t": "admit", "rid": rid, "tick": 1})
    for i, t in enumerate(toks):
        w.append({"t": "token", "rid": rid, "tok": t, "i": i})
    if finish:
        w.append({"t": "finish", "rid": rid, "state": "finished",
                  "reason": "length", "n": len(toks),
                  "crc": stream_crc(toks)})


def _mixed(w):
    """A journal with every lifecycle: finished, in flight, shed,
    resubmitted after a shed, a dedup and a recover record."""
    _journal_stream(w, "a", [5, 6, 7])
    _journal_stream(w, "b", [9])
    _journal_stream(w, "d", [4, 4], finish=False)
    w.append({"t": "submit", "rid": "e", "prompt": [7], "max_new": 2,
              "prio": 0, "deadline": 3})
    w.append({"t": "reject", "rid": "e", "reason": "overload",
              "retry_after": 2})
    w.append({"t": "reject", "rid": "f", "reason": "overload",
              "retry_after": 1})
    w.append({"t": "submit", "rid": "f", "prompt": [8], "max_new": 2,
              "prio": 0, "deadline": None})
    w.append({"t": "token", "rid": "f", "tok": 3, "i": 0})
    w.append({"t": "dedup", "rid": "a"})
    w.append({"t": "recover", "segments": 1, "records": 9})


def _bytes(path):
    return [open(p, "rb").read() for p in segment_paths(path)]


def _names(path):
    return [os.path.basename(p) for p in segment_paths(path)]


# -- byte compatibility --------------------------------------------------

@pytest.mark.parametrize("segment_bytes", [256 * 1024, 200])
def test_same_records_same_bytes(tmp_path, segment_bytes):
    a = WriteAheadLog(tmp_path / "port", fsync_every=3,
                      segment_bytes=segment_bytes)
    b = jwal.WriteAheadLog(tmp_path / "ref", fsync_every=3,
                           segment_bytes=segment_bytes)
    for w in (a, b):
        _mixed(w)
        w.close()
    assert _names(tmp_path / "port") == _names(tmp_path / "ref")
    assert _bytes(tmp_path / "port") == _bytes(tmp_path / "ref")
    assert len(_names(tmp_path / "port")) == (
        1 if segment_bytes > 1000 else 6)
    sa, sb = a.statusz(), b.statusz()
    for st in (sa, sb):
        st.pop("dir")
        st.pop("write_s")
    assert sa == sb
    assert stream_crc([5, 6, 7]) == jwal.stream_crc([5, 6, 7])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_replays_and_compacts_the_other_s(tmp_path, writer):
    mod = wal if writer == "port" else jwal
    w = mod.WriteAheadLog(tmp_path / "j", fsync_every=4, segment_bytes=300)
    _mixed(w)
    w.close()
    with open(segment_paths(tmp_path / "j")[-1], "ab") as f:
        f.write(b'0badc0de {"t":"tok')          # a torn tail
    for d in ("p", "r"):
        shutil.copytree(tmp_path / "j", tmp_path / d)
    recs_p, rep_p = replay(tmp_path / "p")
    recs_r, rep_r = jwal.replay(tmp_path / "r")
    assert recs_p == recs_r and rep_p == rep_r
    assert rep_p["torn_bytes"] > 0 and rep_p["corrupt"] == 0
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "r")   # repaired
    assert compact(tmp_path / "p") == jwal.compact(tmp_path / "r")
    assert _names(tmp_path / "p") == _names(tmp_path / "r")
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "r")
    recs, _ = replay(tmp_path / "p")
    assert sorted({r["rid"] for r in recs}) == ["d", "f"]


# -- the gate ------------------------------------------------------------

def test_pt_wal_env_gate(monkeypatch, tmp_path):
    monkeypatch.setenv("PT_WAL", "bogus")
    with pytest.raises(ValueError, match="PT_WAL"):
        wal.wal_enabled()
    monkeypatch.setenv("PT_WAL", "on")
    monkeypatch.delenv("PT_WAL_DIR", raising=False)
    with pytest.raises(ValueError, match="PT_WAL_DIR"):
        wal.default_wal()
    monkeypatch.setenv("PT_WAL_DIR", str(tmp_path / "j"))
    assert isinstance(wal.default_wal(), WriteAheadLog)
    monkeypatch.setenv("PT_WAL", "off")
    assert wal.default_wal() is None
    assert resolve_wal(False) is None
    assert isinstance(resolve_wal(str(tmp_path / "k")), WriteAheadLog)
    with pytest.raises(ValueError, match="wal="):
        resolve_wal(123)
    with pytest.raises(ValueError, match="fsync_every"):
        WriteAheadLog(tmp_path / "m", fsync_every=0)


# -- journal-level behavior (the reference's tests, on the port) ----------

def test_wal_fsync_batching(tmp_path):
    w = WriteAheadLog(tmp_path / "j", fsync_every=4)
    for i in range(10):
        w.append({"t": "token", "rid": "r", "tok": i})
    assert w.appended == 10
    assert w.fsyncs == 2 and w.last_fsync_at == 8
    assert w.statusz()["lag_records"] == 2
    w.fsync()
    assert w.fsyncs == 3 and w.statusz()["lag_records"] == 0
    assert 0 < w.statusz()["write_s"] < 1.0


def test_wal_segment_rotation(tmp_path):
    w = WriteAheadLog(tmp_path / "j", fsync_every=4, segment_bytes=128)
    for i in range(10):
        w.append({"t": "token", "rid": "r", "tok": i})
    w.close()
    st = w.statusz()
    assert st["segments"] > 1
    recs, report = replay(tmp_path / "j")
    assert [r["tok"] for r in recs] == list(range(10))
    assert report["segments"] == st["segments"]
    assert report["corrupt"] == 0 and report["torn_bytes"] == 0
    # a new writer never appends to an old (possibly torn) segment
    w2 = WriteAheadLog(tmp_path / "j", fsync_every=4)
    w2.append({"t": "token", "rid": "r", "tok": 10})
    w2.close()
    assert w2.statusz()["segments"] == st["segments"] + 1
    recs2, _ = replay(tmp_path / "j")
    assert [r["tok"] for r in recs2] == list(range(11))


def test_wal_roll_survives_fsync_failure(tmp_path):
    w = WriteAheadLog(tmp_path / "j", fsync_every=100, segment_bytes=64)
    faults.reset("wal.fsync:before:*=raise")
    for i in range(6):
        w.append({"t": "token", "rid": "r", "tok": i})
    faults.reset("")
    w.close()
    assert w.errors >= 1
    assert w.statusz()["segments"] > 1
    recs, report = replay(tmp_path / "j")
    assert [r["tok"] for r in recs] == list(range(6))
    assert report["corrupt"] == 0


def test_wal_compact_drops_terminal_keeps_live(tmp_path):
    w = WriteAheadLog(tmp_path / "j", fsync_every=1, segment_bytes=200)
    _mixed(w)
    n_before = len(segment_paths(tmp_path / "j"))
    assert n_before > 1
    rep = w.compact()
    assert rep["live_rids"] == 2 and rep["segments_dropped"] == n_before
    assert rep["records_dropped"] > 0
    assert len(segment_paths(tmp_path / "j")) == 1
    recs, report = replay(tmp_path / "j")
    assert sorted({r["rid"] for r in recs}) == ["d", "f"]
    assert [r["tok"] for r in recs
            if r.get("t") == "token" and r["rid"] == "d"] == [4, 4]
    assert report["corrupt"] == 0 and report["torn_bytes"] == 0
    _journal_stream(w, "g", [1])
    assert int(os.path.basename(
        segment_paths(tmp_path / "j")[-1])[4:12]) \
        == rep["segment_index"] + 1
    assert w.compactions == 1 and w.statusz()["compactions"] == 1
    w.close()


def test_wal_compact_every_trigger(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_WAL_COMPACT_EVERY", "5")
    w = WriteAheadLog(tmp_path / "j", fsync_every=1)
    _journal_stream(w, "a", [1, 2])     # submit, admit, 2 tokens, finish
    assert w.compactions == 1
    recs, _ = replay(tmp_path / "j")
    assert recs == []
    w.close()
    with pytest.raises(ValueError, match="compact_every"):
        WriteAheadLog(tmp_path / "k", compact_every=-1)


def test_wal_compact_crash_window_degrades(tmp_path):
    w = WriteAheadLog(tmp_path / "j", fsync_every=1)
    w.append({"t": "submit", "rid": "x", "prompt": [1]})
    w.append({"t": "token", "rid": "x", "i": 0, "tok": 2})
    faults.reset("wal.compact:after:1=raise")
    rep = w.compact()
    faults.reset("")
    assert rep is None and w.errors >= 1
    assert len(segment_paths(tmp_path / "j")) == 2   # old + complete new
    recs, _ = replay(tmp_path / "j")
    toks = [r for r in recs if r.get("t") == "token"]
    assert len(toks) == 2               # the duplicate is present...
    got = []
    for r in toks:
        if int(r["i"]) == len(got):
            got.append(r["tok"])
    assert got == [2]                   # ...and folds to one token
    w.append({"t": "token", "rid": "x", "i": 1, "tok": 9})
    assert len(segment_paths(tmp_path / "j")) == 3
    w.close()


def _write_records(path, recs, **kw):
    w = WriteAheadLog(path, **kw)
    for r in recs:
        w.append(r)
    w.close()
    return w


def test_torn_tail_truncated_on_replay(tmp_path):
    _write_records(tmp_path / "j",
                   [{"t": "token", "rid": "r", "tok": i} for i in range(6)])
    seg = segment_paths(tmp_path / "j")[-1]
    with open(seg, "ab") as f:
        f.write(b"deadbeef {\"t\": \"tok")
    recs, report = replay(tmp_path / "j")
    assert [r["tok"] for r in recs] == list(range(6))
    assert report["torn_bytes"] > 0
    recs2, report2 = replay(tmp_path / "j")
    assert [r["tok"] for r in recs2] == list(range(6))
    assert report2["torn_bytes"] == 0


def test_corrupt_interior_record_skipped(tmp_path):
    _write_records(tmp_path / "j",
                   [{"t": "token", "rid": "r", "tok": i} for i in range(6)])
    seg = segment_paths(tmp_path / "j")[-1]
    with open(seg, "r+b") as f:
        raw = f.read()
        f.seek(raw.index(b'"tok":2'))
        f.write(b"X")
    for d in ("p", "r"):
        shutil.copytree(tmp_path / "j", tmp_path / d)
    recs, report = replay(tmp_path / "p")
    assert report["corrupt"] == 1 and report["torn_bytes"] == 0
    assert [r["tok"] for r in recs] == [0, 1, 3, 4, 5]
    assert jwal.replay(tmp_path / "r") == (recs, report)


def test_wal_replay_raise_is_clean(tmp_path):
    _write_records(tmp_path / "j", [{"t": "token", "rid": "r", "tok": 1}])
    faults.reset("wal.replay:before:1=raise")
    with pytest.raises(faults.InjectedFault):
        replay(tmp_path / "j")
    faults.reset("")
    recs, _ = replay(tmp_path / "j")
    assert [r["tok"] for r in recs] == [1]


@pytest.mark.parametrize("point,phase", [
    ("wal.append", "before"), ("wal.append", "after"),
    ("wal.fsync", "before"), ("wal.fsync", "after"),
])
def test_wal_fault_degrades_to_errors(tmp_path, point, phase):
    """An injected raise at an append or fsync is absorbed into
    ``errors`` in both packages alike: the same records land."""
    for mod, fmod, d in ((wal, faults, "p"), (jwal, jfaults, "r")):
        fmod.reset(f"{point}:{phase}:3=raise")
        w = mod.WriteAheadLog(tmp_path / d, fsync_every=2)
        for i in range(8):
            w.append({"t": "token", "rid": "r", "tok": i, "i": i})
        fmod.reset("")
        w.close()
        assert w.errors == 1
    assert _bytes(tmp_path / "p") == _bytes(tmp_path / "r")
