"""Write-ahead request journal for durable serving.

An append-only log of request lifecycle records (submit / admit /
token-emission / finish / reject / dedup) that makes an accepted
request survive the loss of the whole serving process: after a crash,
``ServingCluster.recover(wal_dir)`` replays the journal, serves
already-finished streams straight from the log, and re-submits
in-flight requests through the preemption-recompute idiom so recovered
streams are bit-identical to an uninterrupted run.

Layout and framing (references: classic ARIES-style WAL, LevelDB log
format):

- the journal is a directory of numbered **segments**
  (``wal-00000001.jsonl`` ...); a writer always starts a fresh segment
  so a torn tail from a previous incarnation is never appended to;
- each record is one line: ``<crc32 hex8> <compact json>\\n`` — the
  crc32 is over the json bytes, so replay detects both torn tails
  (half-written final lines: physically truncated on replay) and
  interior bit-rot (crc mismatch: the record is skipped and counted;
  a finish record whose token count/crc no longer matches the replayed
  stream downgrades that request to the recompute path, never to a
  wrong answer; token records carry their stream index ``i`` so replay
  trusts only a contiguous-from-zero prefix — a token past a bit-rot
  gap is recomputed, not replayed);
- each append is one raw ``write(2)`` straight to the OS (a SIGKILL
  loses nothing) and ``fsync()`` runs every ``fsync_every`` records —
  the batching keeps the WAL-on throughput tax within the gated ≥0.95×
  budget.  Records past the last fsync can be lost to power failure;
  replay then simply sees a shorter prefix and recomputes the rest
  bit-identically.

Journaling must never take serving down: append/fsync failures
(injected via the ``wal.append``/``wal.fsync`` fault points or real
``OSError``) are absorbed into ``errors`` and serving continues with a
degraded journal.  The gate is ``PT_WAL={off,on}`` (+ ``PT_WAL_DIR``);
off is bit-exact with the WAL-free engine.

Counterpart of ``paddle_tpu/inference/server/wal.py``: a copy of the
whole module (the port imports nothing of the JAX package).  The records
carry no wall-clock time, so the same run on the same weights writes the
same bytes in both packages, and each package replays, compacts and
recovers the other's journal.
"""
from __future__ import annotations

import glob
import json
import os
import time
import zlib

import numpy as np

from ... import obs
from ...testing import faults

__all__ = [
    "WriteAheadLog", "replay", "stream_crc", "wal_enabled",
    "default_wal", "resolve_wal", "segment_paths", "compact",
]

_SEG_FMT = "wal-{:08d}.jsonl"
_SEG_GLOB = "wal-*.jsonl"


def wal_enabled() -> bool:
    mode = os.environ.get("PT_WAL", "off").lower()
    if mode not in ("off", "on"):
        raise ValueError(f"PT_WAL={mode!r}: expected off|on")
    return mode == "on"


def default_wal():
    """WriteAheadLog from PT_WAL / PT_WAL_DIR, or None when off."""
    if not wal_enabled():
        return None
    path = os.environ.get("PT_WAL_DIR")
    if not path:
        raise ValueError("PT_WAL=on requires PT_WAL_DIR=<journal dir>")
    return WriteAheadLog(path)


def resolve_wal(wal):
    """None = follow PT_WAL; False forces off; a path string or a
    WriteAheadLog force on (bench A/B and cluster-owned journals)."""
    if wal is None:
        return default_wal()
    if wal is False:
        return None
    if isinstance(wal, WriteAheadLog):
        return wal
    if isinstance(wal, (str, os.PathLike)):
        return WriteAheadLog(os.fspath(wal))
    raise ValueError(f"wal={wal!r}: expected None|False|path|WriteAheadLog")


def stream_crc(tokens) -> int:
    """crc32 over a token stream; stamped into finish records so replay
    can prove a journaled stream is complete before serving it."""
    return zlib.crc32(np.asarray(list(tokens), np.int32).tobytes())


def segment_paths(path):
    return sorted(glob.glob(os.path.join(path, _SEG_GLOB)))


class WriteAheadLog:
    """Append-only crc32-framed JSON-lines journal with segment
    rotation and batched fsync.  Single writer per directory."""

    def __init__(self, path, fsync_every=None, segment_bytes=256 * 1024,
                 compact_every=None):
        if fsync_every is None:
            fsync_every = int(os.environ.get("PT_WAL_FSYNC_EVERY", "32"))
        if fsync_every < 1:
            raise ValueError("fsync_every must be >= 1")
        if compact_every is None:
            compact_every = int(os.environ.get("PT_WAL_COMPACT_EVERY", "0"))
        if compact_every < 0:
            raise ValueError("compact_every must be >= 0 (0 = never)")
        self.dir = os.fspath(path)
        os.makedirs(self.dir, exist_ok=True)
        self.fsync_every = fsync_every
        self.segment_bytes = segment_bytes
        self.compact_every = compact_every
        self.appended = 0
        self.fsyncs = 0
        self.compactions = 0
        self.errors = 0
        # wall seconds spent inside append/fsync: the journal's true
        # serving-path cost, measured within-run so host drift between
        # bench legs can't fake (or hide) a tax
        self.write_s = 0.0
        self.last_fsync_at = 0      # `appended` watermark at last fsync
        self._since_fsync = 0
        self._since_compact = 0
        self._f = None
        self._seg_path = None
        self._seg_bytes = 0
        existing = segment_paths(self.dir)
        # never append to an old segment: its tail may be torn, and
        # replay truncates tears — a fresh segment keeps new records
        # safely after any repair point
        self._seg_index = (int(os.path.basename(existing[-1])[4:12])
                           if existing else 0)
        obs.handle()    # the PT_OBS gate: on raises (not ported)

    # -- writing ---------------------------------------------------------

    def _roll(self):
        if self._f is not None:
            # the final fsync of the outgoing segment degrades like any
            # other journal failure, and the fd closes regardless —
            # rotation must complete even on a sick disk, or persistent
            # fsync errors would leak the fd and pin the segment
            try:
                self._do_fsync()
            except (faults.InjectedFault, OSError):
                self.errors += 1
            finally:
                fd, self._f = self._f, None
                os.close(fd)
        self._seg_index += 1
        self._seg_path = os.path.join(
            self.dir, _SEG_FMT.format(self._seg_index))
        # raw fd: each record is exactly one write(2) straight to the
        # OS (SIGKILL-durable) with no buffered-writer bookkeeping on
        # the serving hot path
        self._f = os.open(self._seg_path,
                          os.O_CREAT | os.O_APPEND | os.O_WRONLY, 0o644)
        self._seg_bytes = 0

    def append(self, rec: dict) -> None:
        """Journal one record.  Failures (injected or OSError) degrade
        to ``errors`` — the serving path never pays for a sick disk."""
        t0 = time.perf_counter()
        try:
            faults.fire("wal.append", "before", path=self._seg_path)
            if self._f is None or self._seg_bytes >= self.segment_bytes:
                self._roll()
            body = json.dumps(rec, separators=(",", ":")).encode()
            line = b"%08x " % zlib.crc32(body) + body + b"\n"
            os.write(self._f, line)
            self._seg_bytes += len(line)
            self.appended += 1
            self._since_fsync += 1
            self._since_compact += 1
            faults.fire("wal.append", "after", path=self._seg_path)
        except (faults.InjectedFault, OSError):
            self.errors += 1
            self.write_s += time.perf_counter() - t0
        else:
            # stop the clock before the batched fsync: fsync() keeps
            # its own time, so the barrier is never counted twice
            self.write_s += time.perf_counter() - t0
            if self._since_fsync >= self.fsync_every:
                self.fsync()
            if self.compact_every and self._since_compact >= self.compact_every:
                self.compact()

    def _do_fsync(self):
        faults.fire("wal.fsync", "before", path=self._seg_path)
        os.fsync(self._f)
        self.fsyncs += 1
        self.last_fsync_at = self.appended
        self._since_fsync = 0
        faults.fire("wal.fsync", "after", path=self._seg_path)

    def fsync(self) -> None:
        if self._f is None:
            return
        t0 = time.perf_counter()
        try:
            self._do_fsync()
        except (faults.InjectedFault, OSError):
            self.errors += 1
        self.write_s += time.perf_counter() - t0

    def close(self) -> None:
        if self._f is not None:
            self.fsync()
            os.close(self._f)
            self._f = None

    def compact(self):
        """Rewrite the journal's live state into one fresh segment and
        drop the finished history (module :func:`compact`), coordinating
        with this open writer: the current segment is fsynced and closed
        first (so the rewrite sees every appended record and may unlink
        the segment), and the next ``append`` rolls a brand-new segment
        strictly after the compacted one.  Runs inline on the append
        path when ``compact_every``/``PT_WAL_COMPACT_EVERY`` is set, so
        like every other journal operation a failure degrades to
        ``errors`` and serving continues on the uncompacted directory.
        Returns the compaction report, or None on a degraded failure."""
        t0 = time.perf_counter()
        report = None
        try:
            if self._f is not None:
                try:
                    self._do_fsync()
                except (faults.InjectedFault, OSError):
                    self.errors += 1
                finally:
                    fd, self._f = self._f, None
                    os.close(fd)
            report = compact(self.dir)
            self.compactions += 1
        except (faults.InjectedFault, OSError):
            self.errors += 1
        finally:
            # re-anchor the segment counter on what is actually on disk:
            # whether the rewrite landed or died half-way, the next roll
            # must pick an index after every existing segment (reusing a
            # live name would interleave new appends into old history)
            existing = segment_paths(self.dir)
            if existing:
                self._seg_index = int(os.path.basename(existing[-1])[4:12])
            self._since_compact = 0
        self.write_s += time.perf_counter() - t0
        return report

    def statusz(self) -> dict:
        segs = segment_paths(self.dir)
        return {
            "dir": self.dir,
            "segments": len(segs),
            "bytes": sum(os.path.getsize(p) for p in segs),
            "appended": self.appended,
            "fsyncs": self.fsyncs,
            "compactions": self.compactions,
            "errors": self.errors,
            "lag_records": self._since_fsync,
            "last_fsync_at_record": self.last_fsync_at,
            "write_s": round(self.write_s, 6),
        }


def _decode_line(line: bytes):
    """(record, crc_ok) — (None, False) when the frame/json is
    unparseable (candidate torn tail)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None, False
    body = line[9:]
    try:
        want = int(line[:8], 16)
        rec = json.loads(body)
    except ValueError:
        return None, False
    if not isinstance(rec, dict):
        return None, False
    return rec, zlib.crc32(body) == want


def replay(path, repair=True):
    """Replay a journal directory -> (records, report).

    Torn tails (a trailing run of unparseable lines in a segment — a
    crash mid-append) are physically truncated when ``repair`` so a
    later writer never lands records behind garbage.  Interior corrupt
    records (bit-rot: crc mismatch or garbage followed by valid lines)
    are skipped and counted — recovery downgrades any stream they
    touched to the recompute path.
    """
    faults.fire("wal.replay", "before", path=path)
    records = []
    report = {"segments": 0, "records": 0, "corrupt": 0, "torn_bytes": 0}
    for seg in segment_paths(path):
        report["segments"] += 1
        with open(seg, "rb") as f:
            raw = f.read()
        entries = []         # (start_offset, rec|None, crc_ok)
        pos = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            end = len(raw) if nl == -1 else nl
            rec, ok = _decode_line(raw[pos:end])
            if nl == -1:     # unterminated final line is always torn
                entries.append((pos, None, False))
                break
            entries.append((pos, rec if ok else None, ok))
            pos = nl + 1
        # split the trailing run of invalid entries: that's the torn
        # tail; invalid entries before any later valid one are bit-rot
        tail = len(entries)
        while tail > 0 and entries[tail - 1][1] is None:
            tail -= 1
        for start, rec, _ok in entries[:tail]:
            if rec is None:
                report["corrupt"] += 1
            else:
                records.append(rec)
                report["records"] += 1
        if tail < len(entries):
            torn_at = entries[tail][0]
            report["torn_bytes"] += len(raw) - torn_at
            if repair:
                with open(seg, "ab") as f:
                    f.truncate(torn_at)
    faults.fire("wal.replay", "after", path=path)
    return records, report


def _terminal_rids(records):
    """rids whose journaled lifecycle is finished business — safe to
    drop under at-least-once delivery.  Mirrors ``recover``'s fold:

    - **finished & proven**: a submit plus a finish whose token count
      and crc match the replayed contiguous-from-zero token prefix.
      Dropping it loses only the serve-from-log dedup fast path; a
      client resubmit recomputes the same stream bit-identically
      (deterministic greedy decode).
    - **rejected & not superseded**: the reject was delivered live when
      it happened (rejects are never deduped), and no later submit
      restarted the rid, so nothing remains to restore.
    - **unrestorable**: a rid with lifecycle records but no surviving
      submit (interior bit-rot ate it).  Recovery could only count it
      corrupt, never restore it; the client's resubmit arrives as a
      fresh stream either way.

    Everything else — unfinished streams, finishes that fail their own
    proof, resubmitted-after-reject rids — is live and must be kept.
    """
    by = {}
    for rec in records:
        rid = rec.get("rid")
        if rid is None:
            continue
        e = by.setdefault(rid, {"tokens": [], "submit": None,
                                "finish": None, "reject": None})
        t = rec.get("t")
        if t == "submit":
            if e["reject"] is not None:
                # post-backoff retry supersedes the shed attempt: the
                # rid is a fresh stream from here (same rule as recover)
                e.update(submit=rec, finish=None, reject=None, tokens=[])
            elif e["submit"] is None:
                e["submit"] = rec
        elif t == "token":
            if int(rec.get("i", -1)) == len(e["tokens"]):
                e["tokens"].append(int(rec.get("tok", -1)))
        elif t == "finish":
            e["finish"] = rec
        elif t == "reject":
            e["reject"] = rec
    out = set()
    for rid, e in by.items():
        if e["submit"] is None:
            out.add(rid)
        elif e["reject"] is not None:
            out.add(rid)
        elif (e["finish"] is not None
              and int(e["finish"].get("n", -1)) == len(e["tokens"])
              and int(e["finish"].get("crc", -1)) == stream_crc(e["tokens"])):
            out.add(rid)
    return out


def compact(path):
    """Rewrite a journal directory's **live** state into one fresh
    segment and unlink the finished history -> report dict.

    The journal is append-only, so a long-lived server accretes
    segments full of finished streams that recovery would only replay
    to dedup.  Compaction replays the directory (repairing torn
    tails), keeps every record of every live rid verbatim (so a
    post-compaction ``recover`` folds them identically), writes them
    crc-framed into a fresh segment numbered after all existing ones,
    fsyncs it, and only then unlinks the old segments.

    Crash safety leans entirely on ``recover``'s duplicate-idempotent
    replay — every window leaves a directory that recovers to the same
    state:

    - **before the new segment is durable**: old segments are intact;
      the partial new segment is at worst a torn tail (truncated on
      replay) holding duplicates of records still present in the old
      segments — submit is first-write-wins and token replay only
      extends a contiguous prefix, so duplicates are no-ops;
    - **mid-unlink**: the new segment is complete and holds all live
      state; surviving old segments add only duplicates and
      already-terminal lifecycles.

    Single writer per directory: callers with an open
    :class:`WriteAheadLog` must use its :meth:`~WriteAheadLog.compact`
    method, which closes the active segment first.
    """
    faults.fire("wal.compact", "before", path=path)
    old = segment_paths(path)
    report = {"segments_dropped": 0, "records_kept": 0,
              "records_dropped": 0, "live_rids": 0, "segment_index": 0}
    if not old:
        faults.fire("wal.compact", "after", path=path)
        return report
    records, _rep = replay(path)
    terminal = _terminal_rids(records)
    keep = [r for r in records
            if r.get("rid") is not None and r["rid"] not in terminal]
    live = {r["rid"] for r in keep}
    new_index = max(int(os.path.basename(p)[4:12]) for p in old) + 1
    new_path = os.path.join(os.fspath(path), _SEG_FMT.format(new_index))
    fd = os.open(new_path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
    try:
        for rec in keep:
            body = json.dumps(rec, separators=(",", ":")).encode()
            os.write(fd, b"%08x " % zlib.crc32(body) + body + b"\n")
        os.fsync(fd)
    finally:
        os.close(fd)
    # the "after" phase sits between the durable rewrite and the
    # unlinks: a crash injected here leaves old+new coexisting, the
    # exact window the docstring's idempotence argument covers
    faults.fire("wal.compact", "after", path=path)
    for p in old:
        os.unlink(p)
    report.update(segments_dropped=len(old), records_kept=len(keep),
                  records_dropped=len(records) - len(keep),
                  live_rids=len(live), segment_index=new_index)
    return report
