"""Deterministic fault injection for crash-safety tests.

Production code is threaded with *named fault points* —
``faults.fire("ckpt.shard_write", "after", path=...)`` — that are inert
unless armed.  Arming is either declarative via the ``PT_FAULTS``
environment variable (survives fork/exec into launch trainers and
DataLoader pool workers) or programmatic via :func:`arm` (in-process
tests).

Grammar (comma-separated specs)::

    PT_FAULTS="point:phase:nth=action[:arg][,point:phase:nth=action...]"

    point   registered dotted name (see REGISTERED)
    phase   before | after              (site-relative)
    nth     1-based hit count at which the fault fires, or * (every hit)
    action  crash          os._exit(EXIT_CODE) — a hard kill, exactly
                           what a preemption looks like to the survivors
            raise          raise InjectedFault (exercises error
                           propagation, e.g. async-save handles)
            truncate       truncate the file at the site's ``path`` to
                           half its bytes, then os._exit — a torn write
            delay:SECS     sleep SECS (default 0.05) and continue
            hang[:SECS]    at a generic site: a bounded wall-clock
                           stall (like delay); at the supervised
                           replica points the cluster consume()s it
                           and the replica stalls SILENTLY — no steps,
                           no heartbeats — until the missed-beat
                           watchdog fails it
            corrupt        flip one bit in the middle of the file at the
                           site's ``path`` and CONTINUE — silent bit rot
                           (checksum verification must catch it at load)
            inject[:ARG]   value injection: the site polls the harness
                           via :func:`poll` and poisons its own value
                           (NaN loss, spiked loss, NaN grads) when armed.
                           ``fire`` never trips these — only value sites
                           consume them.

Example: ``PT_FAULTS="ckpt.shard_write:after:2=crash"`` kills the
process right after the second shard file hits disk — mid-save, before
metadata or commit.  Counters are per-process and per-spec, so a forked
DataLoader worker counts its own hits (deterministic per worker).

Counterpart of ``paddle_tpu/testing/faults.py``: a copy of the whole
module (the port imports nothing of the JAX package), with the same
registry, so one spec string arms the same point in either package.
The port's serving, fleet, checkpoint, train-step and ``DataLoader``
worker (``io.worker``) sites follow the reference's control flow, hit
for hit.  Points whose site the port does not have yet stay registered:
``hapi.save`` (``hapi``; ROADMAP.md Queue 1, item 9), the
telemetry ones (``obs.*``; item 9), ``aot.cache`` (the port keeps no
compile cache on disk) and ``sp.*`` (item 8).
"""
from __future__ import annotations

import os
import threading
import time

#: exit status used by ``crash``/``truncate`` so tests can tell an
#: injected kill from an organic failure.
EXIT_CODE = 53

#: every fault point threaded through the codebase; firing or arming an
#: unknown name is an error (typos must not silently never fire).
REGISTERED = {
    "ckpt.shard_write": "each sharded .npy write in save_state_dict "
                        "(before=pre-write, after=file on disk)",
    "ckpt.metadata": "the per-rank metadata.json write",
    "ckpt.commit": "CheckpointManager commit (before=pre-rename, "
                   "after=renamed but COMMIT sentinel not yet written)",
    "io.worker": "DataLoader pool worker around one batch fetch",
    "train.step": "CompiledTrainStep.step host boundary",
    "hapi.save": "hapi ModelCheckpoint save",
    "guard.nan_loss": "guardian monitor: poison the step loss to NaN "
                      "(value site — arm with the 'inject' action)",
    "guard.nan_grad": "guardian monitor: poison the gradients to NaN "
                      "while the loss stays finite (value site)",
    "guard.loss_spike": "guardian monitor: add a large finite spike to "
                        "the step loss (value site; arg = magnitude)",
    "serve.step": "serving Scheduler.step (before=iteration not "
                  "started, after=iteration fully committed)",
    "serve.admit": "one admission in the serving scheduler (before=no "
                   "slot allocated yet, after=request PREFILLING)",
    "serve.decode": "the batched decode dispatch (before=pages "
                    "reserved, nothing written; after=tokens emitted)",
    "serve.request": "one request's prefill work — an exception here "
                     "is confined to that request (state FAILED)",
    "prefix.match": "one admission-time radix-tree prefix lookup "
                    "(before=tree untouched, after=match computed but "
                    "nothing attached)",
    "prefix.cow": "one copy-on-write of a shared KV page (before=no "
                  "page popped, after=table repointed at the copy)",
    "prefix.evict": "one LRU eviction of a zero-refcount prefix-tree "
                    "leaf (before=node still linked, after=pages back "
                    "on the free list)",
    "spec.draft": "the per-step n-gram draft sweep (pure index reads: "
                  "before and after both fire with nothing mutated)",
    "spec.verify": "the batched draft-window verification (before="
                   "pages reserved, nothing written; after=accepted "
                   "tokens committed and emitted)",
    "spec.rollback": "the post-verify page trim (before=rejected-"
                     "draft pages still assigned, after=pages back on "
                     "the free list)",
    "async.plan": "the double-buffered step's host planning phase "
                  "(before=nothing this step has mutated, after=plan "
                  "built and pages reserved, nothing dispatched)",
    "async.commit": "the double-buffered step's commit fence (before="
                    "dispatched results parked un-applied — the next "
                    "step completes the commit first; after=tokens "
                    "applied, admission/prefill not yet run)",
    "async.replan": "a parked plan invalidated by commit (before="
                    "stale plan discarded, nothing else mutated; "
                    "after=audit counter bumped, replanning live)",
    "obs.dump": "one flight-recorder dump (before=ring intact, nothing "
                "serialized; after=dump text retained/written)",
    "obs.export": "one Chrome-trace export (before=no file, after=file "
                  "on disk)",
    "obs.event": "one structured-event-log journal write (before=no "
                 "line appended, after=line on disk/in tail)",
    "obs.http": "one health-plane HTTP request (before=nothing "
                "written to the socket; a raise here becomes a 500 "
                "response, after=response sent)",
    "aot.lower": "one AOT lowering in CountedJit.aot_compile (before="
                 "nothing traced; after=lowered, not yet compiled — a "
                 "raise in either phase fails only that warmup entry)",
    "aot.compile": "one AOT lowered.compile() (before=lowered, no "
                   "executable; after=executable built, not yet in "
                   "the table or on disk)",
    "aot.cache": "one persistent compile-cache entry load (before=file "
                 "untouched — corrupt/truncate target the entry file; "
                 "after=executable deserialized; ANY failure degrades "
                 "to a miss + recompile, never a crash)",
    "quant.pack": "one per-channel int8 weight quantization in "
                  "quantize_linear (before=weight untouched, after="
                  "QuantizedLinear dict built — a raise fails the "
                  "engine BUILD, never a serving step)",
    "quant.kv_write": "one host-side quantized KV page write "
                      "(write_at/append; before=pool untouched, after="
                      "pages+scales updated, length not yet bumped)",
    "quant.dequant": "one dense dequantizing gather of a sequence's "
                     "int8 pages (gather_dense; before=nothing read, "
                     "after=dense f32/bf16 copy built — the pool is "
                     "never mutated by a read)",
    "route.pick": "one cluster router placement decision (before=no "
                  "replica chosen, nothing submitted; after=decision "
                  "made, request not yet handed to the engine — a "
                  "raise at either phase re-steers, never loses the "
                  "request)",
    "replica.drain": "one replica drain (before=replica still "
                     "admitting, nothing re-steered; after=admission "
                     "closed and queued requests re-steered, in-flight "
                     "work still finishing in place)",
    "replica.join": "one elastic replica join (before=no engine "
                    "built; after=engine AOT-rewarmed from the shared "
                    "compile cache and routable — a raise leaves the "
                    "fleet exactly as it was)",
    "kv.handoff": "one disaggregated prefill→decode KV-page handoff "
                  "(before=pages still on the prefill replica, "
                  "nothing copied — the request keeps decoding where "
                  "it is; after=pages landed refcounted on the decode "
                  "replica, source slot not yet freed)",
    "replica.fail": "one supervised replica step (before=the CHAOS "
                    "injection site — the cluster CONSUMES crash/hang/"
                    "raise here: crash kills the replica instantly, "
                    "hang stalls it silently until the watchdog "
                    "misses its beats, raise fails it with an "
                    "exception; after=failure handled, every in-"
                    "flight request already failed over)",
    "replica.restart": "one automatic replica restart attempt "
                       "(before=no engine rebuilt — a raise fails the "
                       "attempt and counts against the circuit-"
                       "breaker budget; after=engine rebuilt and AOT-"
                       "rewarmed, replica not yet active)",
    "req.failover": "one request migration off a failed replica "
                    "(before=still owned by the dead replica — a "
                    "raise degrades to the first healthy replica, "
                    "never loses the request; after=re-queued on the "
                    "target for bit-identical re-prefill)",
    "req.shed": "one admission-control rejection at the cluster "
                "boundary (before=verdict computed, nothing rejected "
                "— a raise degrades to ADMITTING the request; after="
                "terminal REJECTED with retry_after set)",
    "wal.append": "one write-ahead-log record append (before=no line "
                  "written — truncate/corrupt target the live "
                  "segment, crash simulates a SIGKILL mid-append; "
                  "after=line flushed to the OS, fsync possibly "
                  "pending — a raise at either phase DEGRADES "
                  "journaling into wal.errors, never the serving "
                  "path)",
    "wal.fsync": "one batched WAL fsync barrier (before=records "
                 "flushed but not yet durable — a crash here loses "
                 "at most the unsynced tail, which replay recomputes "
                 "bit-identically; after=segment durable through its "
                 "last appended record; a raise degrades to "
                 "wal.errors)",
    "wal.replay": "one WAL directory replay during crash recovery "
                  "(before=nothing read — truncate/corrupt target a "
                  "segment file, a raise aborts this recovery "
                  "attempt cleanly and the journal stays replayable; "
                  "after=records reconstructed, nothing resubmitted "
                  "yet)",
    "kv.salvage": "one hung-replica KV-page salvage (before=pages "
                  "still readable on the victim — a raise falls back "
                  "to the recompute failover, never loses the "
                  "request; after=pages landed crc32-verified on the "
                  "target, request not yet moved; inject=corrupt the "
                  "copy in flight so the crc check must catch it and "
                  "fall back to recompute)",
    "wal.compact": "one WAL journal compaction (before=nothing "
                   "rewritten — a crash leaves the old segments "
                   "intact; after=live records rewritten into the "
                   "fresh segment and fsynced, old segments not yet "
                   "unlinked — a crash here leaves old+new segments "
                   "whose duplicate records replay idempotently; a "
                   "raise degrades to wal.errors and the journal "
                   "keeps appending uncompacted)",
    "sp.shard": "one per-rank KV page-range write during "
                "sequence-parallel prefill (before=no range of this "
                "chunk written; after=this rank's stripe landed at "
                "its offset — a raise fails ONLY the bracketed "
                "request via the serve.request isolation path, the "
                "engine and its pool stay serviceable)",
    "sp.gather": "one prefill->decode page all-gather at the end of a "
                 "sequence-parallel prefill (before=pages still "
                 "sharded-by-range; after=every rank holds the full "
                 "page set and decode proceeds byte-identical to the "
                 "single-device path — a raise fails only the "
                 "request, never the engine)",
}

_PHASES = ("before", "after")


class InjectedFault(RuntimeError):
    """Raised by the ``raise`` action."""


class _Spec:
    __slots__ = ("point", "phase", "nth", "action", "arg", "hits")

    def __init__(self, point, phase, nth, action, arg=None):
        if point not in REGISTERED:
            raise ValueError(
                f"unknown fault point {point!r}; registered: "
                f"{sorted(REGISTERED)}")
        if phase not in _PHASES:
            raise ValueError(f"fault phase must be one of {_PHASES}, "
                             f"got {phase!r}")
        if action not in ("crash", "raise", "truncate", "delay",
                          "corrupt", "inject", "hang"):
            raise ValueError(f"unknown fault action {action!r}")
        self.point = point
        self.phase = phase
        self.nth = nth  # int (1-based) or "*"
        self.action = action
        self.arg = arg
        self.hits = 0


_lock = threading.Lock()
_specs = None  # lazily parsed; None = not yet read from env


def _parse(text):
    specs = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        try:
            site, action = part.split("=", 1)
            point, phase, nth = site.split(":")
        except ValueError:
            raise ValueError(
                f"bad PT_FAULTS spec {part!r}; expected "
                "'point:phase:nth=action[:arg]'") from None
        arg = None
        if ":" in action:
            action, arg = action.split(":", 1)
        specs.append(_Spec(point, phase,
                           "*" if nth == "*" else int(nth), action, arg))
    return specs


def _ensure_loaded():
    global _specs
    if _specs is None:
        _specs = _parse(os.environ.get("PT_FAULTS", ""))
    return _specs


def reset(spec_text=None):
    """Re-arm from ``spec_text`` (or the current ``PT_FAULTS`` env when
    None), zeroing all hit counters.  Tests call this between cases."""
    global _specs
    with _lock:
        if spec_text is None:
            spec_text = os.environ.get("PT_FAULTS", "")
        _specs = _parse(spec_text)
    return _specs


def arm(point, phase="before", nth=1, action="raise", arg=None):
    """Programmatically add one armed spec (in-process tests)."""
    with _lock:
        _ensure_loaded()
        spec = _Spec(point, phase, nth, action, arg)
        _specs.append(spec)
    return spec


def disarm_all():
    global _specs
    with _lock:
        _specs = []


def _flip_bit(path):
    """Flip one bit in the middle of the file — the on-disk signature of
    silent bit rot.  The process continues; nothing crashes here — the
    corruption must be CAUGHT later (checksum verification at load)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = size // 2
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0x10]))
        f.flush()
        os.fsync(f.fileno())


def _trip(spec, path):
    if spec.action == "delay":
        time.sleep(float(spec.arg) if spec.arg is not None else 0.05)
        return
    if spec.action == "hang":
        # at a generic fire() site a hang is a bounded wall-clock stall
        # (arg seconds, default 0.05) the per-step watchdog can see; at
        # the supervised replica sites the cluster consume()s the spec
        # instead and the stall is a SILENT logical one — the replica
        # stops stepping and beating until the missed-beat threshold
        # trips.
        time.sleep(float(spec.arg) if spec.arg is not None else 0.05)
        return
    if spec.action == "corrupt":
        if path and os.path.isfile(path):
            _flip_bit(path)
        return
    if spec.action == "raise":
        raise InjectedFault(
            f"injected fault at {spec.point}:{spec.phase} "
            f"(hit {spec.hits})")
    # isfile guard: some sites (e.g. ckpt.commit) fire with a directory
    # path — skip straight to the hard kill rather than die on open().
    if spec.action == "truncate" and path and os.path.isfile(path):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    # crash / truncate: hard kill, no atexit, no flush — the point is
    # that survivors must cope with exactly this.
    os._exit(EXIT_CODE)


def fire(point, phase, path=None):
    """Hit the fault point; no-op unless an armed spec matches.

    ``inject`` specs are NEVER tripped here — they are value faults a
    site consumes via :func:`poll`; counting their hits at a ``fire``
    site would silently shift which call the injection lands on.
    """
    specs = _specs if _specs is not None else _ensure_loaded()
    if not specs:
        return
    assert point in REGISTERED, f"unregistered fault point {point!r}"
    tripped = None
    with _lock:
        for spec in specs:
            if spec.point != point or spec.phase != phase \
                    or spec.action == "inject":
                continue
            spec.hits += 1
            if spec.nth == "*" or spec.hits == spec.nth:
                tripped = spec
                break
    if tripped is not None:
        _trip(tripped, path)


def poll(point, phase="before"):
    """Value-injection probe: returns the matching armed ``inject``
    spec's arg (or ``True`` when the spec has no arg) when the fault
    fires at this hit, else ``None``.  The call site poisons its own
    value — e.g. the guardian's train-step wrapper turns the loss NaN —
    so the injected anomaly flows through the REAL monitoring path."""
    specs = _specs if _specs is not None else _ensure_loaded()
    if not specs:
        return None
    assert point in REGISTERED, f"unregistered fault point {point!r}"
    hit = None
    with _lock:
        for spec in specs:
            if spec.point != point or spec.phase != phase \
                    or spec.action != "inject":
                continue
            spec.hits += 1
            if spec.nth == "*" or spec.hits == spec.nth:
                hit = spec.arg if spec.arg is not None else True
                break
    return hit


def consume(point, phase="before"):
    """Supervised-site probe: pop the matching armed spec's
    ``(action, arg)`` WITHOUT executing its side effect.

    The cluster's replica-scoped points (``replica.fail``,
    ``replica.restart``) use this instead of :func:`fire` so that
    ``crash`` and ``hang`` become *replica-level* faults the fleet
    absorbs in-process — instant death and a silent stall — rather
    than ``os._exit`` killing the whole test process.  ``inject``
    specs are skipped exactly as in :func:`fire`.  Returns ``None``
    when nothing fires at this hit.
    """
    specs = _specs if _specs is not None else _ensure_loaded()
    if not specs:
        return None
    assert point in REGISTERED, f"unregistered fault point {point!r}"
    hit = None
    with _lock:
        for spec in specs:
            if spec.point != point or spec.phase != phase \
                    or spec.action == "inject":
                continue
            spec.hits += 1
            if spec.nth == "*" or spec.hits == spec.nth:
                hit = (spec.action, spec.arg)
                break
    return hit


def registered_points():
    """Names usable in specs — the property test iterates these."""
    return sorted(REGISTERED)


# -- seeded chaos schedules (PT_CHAOS) --------------------------------

#: actions the chaos generator draws.  ``crash`` and ``hang`` are only
#: drawn onto the supervised replica point (the in-process fleet
#: absorbs them); ``raise`` is drawn across every registered point —
#: the one generic action that degrades instead of killing the test
#: process.
CHAOS_ACTIONS = ("crash", "hang", "raise")


def parse_chaos(text=None):
    """Parse ``PT_CHAOS="<seed>:<steps>"`` (or ``text``) into
    ``(seed, steps)``; returns ``None`` when unset/empty."""
    if text is None:
        text = os.environ.get("PT_CHAOS", "")
    text = text.strip()
    if not text:
        return None
    try:
        seed_s, steps_s = text.split(":")
        seed, steps = int(seed_s), int(steps_s)
    except ValueError:
        raise ValueError(
            f"bad PT_CHAOS {text!r}; expected '<seed>:<steps>'") \
            from None
    if steps < 1:
        raise ValueError(f"PT_CHAOS steps must be >= 1, got {steps}")
    return seed, steps


def chaos_schedule(seed, steps, n_faults=None):
    """Draw one deterministic randomized fault schedule.

    Returns a list of ``PT_FAULTS`` spec strings (pass
    ``",".join(...)`` to :func:`reset`): ``n_faults`` firings (default
    ``max(2, steps // 8)``) with seeded point/phase/hit-count draws
    spread over a run of roughly ``steps`` cluster steps.  Value-only
    ``guard.*`` sites are skipped (they consume ``inject``, never
    trip), and crash/hang land exclusively on ``replica.fail`` so the
    supervised fleet absorbs them in-process.  Same seed, same
    schedule — the chaos tests replay it against a fault-free baseline
    and assert bit-identical streams.
    """
    import random

    rng = random.Random(int(seed))
    steps = int(steps)
    n = max(2, steps // 8) if n_faults is None else int(n_faults)
    points = [p for p in registered_points()
              if not p.startswith("guard.")]
    specs = []
    for _ in range(n):
        action = CHAOS_ACTIONS[rng.randrange(len(CHAOS_ACTIONS))]
        if action in ("crash", "hang"):
            point, phase = "replica.fail", "before"
        else:
            point = points[rng.randrange(len(points))]
            phase = _PHASES[rng.randrange(len(_PHASES))]
        nth = rng.randrange(1, max(2, steps))
        specs.append(f"{point}:{phase}:{nth}={action}")
    return specs


def chaos_from_env():
    """Arm the schedule ``PT_CHAOS`` describes (replacing any armed
    specs); returns the spec-string list, or ``None`` when unset."""
    parsed = parse_chaos()
    if parsed is None:
        return None
    seed, steps = parsed
    specs = chaos_schedule(seed, steps)
    reset(",".join(specs))
    return specs
