"""Multi-replica serving fleet over the shared logical clock.

Counterpart of ``paddle_tpu/inference/server/cluster.py``.  One
:class:`ServingEngine` is a single box; the fleet wraps N of them (each
with its own page pool and executor; replicas of one ``(config,
params)`` share the weight tensors, so two bf16 replicas hold the
weights once) behind a :class:`Router` that places every
request by **prefix affinity** — probe each replica's radix tree with
the read-only :meth:`PrefixCache.match_len` — falling back to queue
depth and page-pool headroom, so shared-prefix traffic lands where its
KV pages already live.

Determinism: replicas step in lockstep — one cluster ``step()`` steps
every live replica once — and greedy streams depend only on weights +
prompt (page identity never enters the numerics), so per-request token
streams are bit-identical to a single engine whatever the routing, in
all four serving variants (plain / prefix / spec / async).

Gate: ``PT_CLUSTER`` (off|on; anything else raises).  Off, the cluster
degenerates to ONE replica with a pass-through router — the bit-exact
single-engine path.

Survivability (the :class:`ReplicaSupervisor`): replicas heartbeat on
the logical clock; a crash, hang, or escaping exception marks the
replica FAILED and every request it held fails over — re-queued through
the router for a bit-identical prompt+generated re-prefill (the
preemption-recompute idiom) on a healthy replica, handles untouched; a
HUNG replica's running requests are salvaged instead (their committed
KV pages copied to the target through ``gather_dense`` → ``write_at``,
crc32-verified).  Failed replicas restart after exponential backoff (a
fresh engine; under ``aot="warm"`` it re-captures its graphs) under a
consecutive-failure circuit breaker that retires flappers.  Admission
control (``max_queue`` + deadline-aware early rejection) sheds
saturating load as terminal REJECTED-with-retry-after — never silent
loss.  Fault points: ``route.pick``, ``replica.fail`` (crash/hang/raise
consumed in-process), ``replica.restart``, ``req.failover``,
``req.shed`` and ``kv.salvage``; each degrades, none loses a request.

Durability: one write-ahead journal (``wal``, see ``wal.py``) shared by
the fleet; :meth:`ServingCluster.recover` rebuilds a fleet from it after
a whole-process crash.

Elasticity: :meth:`ServingCluster.drain` closes one replica's admission
and re-steers its queue, :meth:`ServingCluster.join` adds a fresh
replica, and ``disaggregated=True`` splits the fleet into prefill and
decode roles, each finished prefill's KV pages handed to a decode
replica by one ``gather_dense`` → ``write_at`` copy (salvage's).  Points
``replica.drain``, ``replica.join`` and ``kv.handoff``.  The port keeps
no compile cache on disk: a joined replica captures its own decode
graphs (its report gives the graphs captured and their seconds where
the reference gives disk hits and compiles).  The telemetry plane
(events, gauges, ``/statusz`` serving; ROADMAP.md Queue 1, item 9): the
fleet asks the ``PT_OBS`` gate once, and only its off path runs;
:meth:`ServingCluster._statusz` still forms the reference's page.
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from ... import obs
from ...testing import faults
from . import wal as wal_mod
from .engine import ServingEngine, _gate
from .request import (Request, RequestHandle, RequestRejected,
                      RequestState)
from .wal import resolve_wal, stream_crc

#: states in which a replica no longer steps or holds live requests.
DEAD_STATES = ("drained", "failed", "restarting", "retired")


class Replica:
    """One engine plus its fleet-side control state."""

    __slots__ = ("name", "engine", "role", "state",
                 "last_beat", "hung", "fail_streak", "fails",
                 "restarts", "restart_at", "probation_until")

    def __init__(self, name, engine, role="mixed"):
        self.name = name
        self.engine = engine
        self.role = role            # mixed | prefill | decode
        self.state = "active"
        # survivability bookkeeping (the ReplicaSupervisor's state):
        self.last_beat = 0          # cluster tick of the last full step
        self.hung = False           # injected silent stall in progress
        self.fail_streak = 0        # consecutive failures (breaker)
        self.fails = 0              # lifetime failures
        self.restarts = 0           # lifetime successful restarts
        self.restart_at = None      # tick of the next restart attempt
        self.probation_until = None  # healthy-until tick resets streak

    @property
    def depth(self) -> int:
        """Queue depth the router balances on: everything holding or
        waiting for a slot."""
        s = self.engine.scheduler
        return len(s.queue) + len(s.prefilling) + len(s.running)

    @property
    def admitting(self) -> bool:
        return (self.state == "active" and not self.hung
                and self.role in ("mixed", "prefill"))

    def __repr__(self):
        return (f"Replica({self.name}, role={self.role}, "
                f"state={self.state}, depth={self.depth})")


class Router:
    """Placement policy over the admitting replicas.

    ``affinity`` (default): maximize the prefix-affinity probe (tokens
    of the prompt already resident in the replica's radix tree), then
    lowest queue depth, then most free pages, then lowest replica index
    — fully deterministic.  (The reference ranks a sequence-parallel fit
    between affinity and depth; it is zero on every replica of a fleet
    without sequence parallelism, as the port's is.)  ``random``: a
    seeded uniform pick, the A/B control arm.
    """

    POLICIES = ("affinity", "random")

    def __init__(self, policy="affinity", seed=0):
        if policy not in self.POLICIES:
            raise ValueError(
                f"router policy must be one of {self.POLICIES}, "
                f"got {policy!r}")
        self.policy = policy
        self._rng = np.random.RandomState(seed)
        self.decisions = 0
        self.affinity_hits = 0     # picks that landed on cached pages
        self.degraded = 0          # injected-fault fallback placements

    def pick(self, candidates, prompt_ids):
        """(replica, affinity_tokens) for one request.

        The admitting flag is re-checked here, at decision time, not
        just when the candidate list was snapshotted: a replica that
        failed between the snapshot and the pick must never win the
        placement.  When every candidate went stale the original list
        is kept — the caller owns the no-admitting-replica error path.
        """
        live = [r for r in candidates if r.admitting]
        if live:
            candidates = live
        if self.policy == "random":
            return candidates[int(self._rng.randint(
                len(candidates)))], 0
        best, best_key = None, None
        for i, rep in enumerate(candidates):
            prefix = rep.engine.prefix
            aff = (prefix.match_len(prompt_ids)
                   if prefix is not None else 0)
            key = (aff, -rep.depth, rep.engine.executor.free_pages, -i)
            if best is None or key > best_key:
                best, best_key = rep, key
        if best_key[0] > 0:
            self.affinity_hits += 1
        return best, best_key[0]


def _crc(k, v) -> int:
    """crc32 over the bytes of two tensors (any dtype, any device)."""
    def raw(t):
        return t.contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes()

    return zlib.crc32(raw(v), zlib.crc32(raw(k)))


def _with_room(candidates, length):
    """The least loaded candidate (depth, then most free pages) with a
    free slot and the pages for ``length`` + 1 tokens, else None."""
    for rep in sorted(candidates,
                      key=lambda r: (r.depth, -r.engine.executor.free_pages)):
        ex = rep.engine.executor
        if ex.free_slots >= 1 and ex.free_pages >= ex.pages_for(length + 1):
            return rep
    return None


def _gather_kv(ex, sid, length):
    """One sequence's committed K/V, [L, KV, length, D] each:
    ``gather_dense`` pads to the page cover, and positions >= length are
    garbage that must never travel or enter a checksum."""
    k, v = ex.cache.gather_dense(sid, length)
    return k[:, :, :length], v[:, :, :length]


def _land_kv(ex, k, v) -> int:
    """Write gathered K/V into a fresh slot of ``ex``'s pool (pages
    allocated refcounted by ``write_at``); returns the slot.  The one
    copy path of a salvage and a handoff."""
    sid = ex.alloc_slot()
    try:
        ex.cache.write_at(sid, k, v, 0)
    except Exception:
        ex.free_slot(sid)
        raise
    return sid


class ReplicaSupervisor:
    """Crash/hang detection and closed-loop recovery for one fleet.

    Detection is deterministic on the logical clock: a replica that
    completes a step beats (``last_beat = cluster tick``); one that
    misses ``beat_timeout`` consecutive beats — a hang, silent or
    injected — is marked FAILED.  ``watchdog_s`` (off by default: wall
    time is nondeterministic) additionally bounds one step's wall
    clock; a step that finishes but blows the deadline fails the
    replica after its tokens are kept.

    Every non-terminal request on a failed replica fails over: it is
    re-queued through the :class:`Router` for a bit-identical
    prompt+generated re-prefill on a healthy replica, its
    :class:`RequestHandle` untouched (a hung replica's running requests
    are salvaged with their pages instead, :meth:`_salvage`).  With no
    healthy target the request parks on the cluster's orphan list
    (never lost) and re-homes as soon as a replica restarts.

    Restart is automatic (``auto_restart``): after an exponential
    backoff (``backoff_base * 2**(streak-1)`` ticks) the replica
    rebuilds its engine and rejoins admission.  A circuit breaker
    retires it permanently once ``fail_streak`` exceeds
    ``restart_budget``; the streak resets only after the replica
    survives a probation window (``2 * beat_timeout`` ticks).
    """

    def __init__(self, cluster, beat_timeout=3, watchdog_s=None,
                 auto_restart=True, restart_budget=3, backoff_base=2):
        if int(beat_timeout) < 1:
            raise ValueError(
                f"beat_timeout must be >= 1, got {beat_timeout}")
        self.cluster = cluster
        self.beat_timeout = int(beat_timeout)
        self.watchdog_s = (None if watchdog_s is None
                           else float(watchdog_s))
        self.auto_restart = bool(auto_restart)
        self.restart_budget = int(restart_budget)
        self.backoff_base = max(1, int(backoff_base))
        self.probation = 2 * self.beat_timeout

    # -- supervised stepping --------------------------------------------

    def step_replica(self, rep) -> dict:
        """One replica step under supervision; returns its emitted
        map ({} when the replica stalled, crashed, or failed)."""
        cl = self.cluster
        hit = faults.consume("replica.fail", "before")
        if hit is not None:
            action = hit[0]
            if action == "hang":
                rep.hung = True     # silent: no step, no beat
            elif action == "crash":
                self.fail(rep, "crash")
                return {}
            else:                   # raise & friends: exception path
                self.fail(rep, f"injected:{action}")
                return {}
        if rep.hung:
            return {}
        t0 = (time.monotonic() if self.watchdog_s is not None
              else None)
        try:
            out = rep.engine.step()
        except Exception as e:
            # one replica's step blowing up must not take the fleet
            # down: confine it, fail the replica, fail over its work
            self.fail(rep, f"{type(e).__name__}: {e}")
            return {}
        rep.last_beat = cl._tick
        if t0 is not None and time.monotonic() - t0 > self.watchdog_s:
            # the step finished but blew its wall-clock deadline: the
            # tokens it emitted are valid and are returned
            self.fail(rep, "watchdog")
        return out

    # -- detection + recovery loop --------------------------------------

    def poll(self) -> None:
        """Once per cluster step: missed-beat detection, probation
        expiry, due restarts, orphan re-homing."""
        cl = self.cluster
        tick = cl._tick
        for rep in list(cl.replicas):
            if rep.state in ("active", "draining"):
                if tick - rep.last_beat >= self.beat_timeout:
                    self.fail(rep, "missed_beats")
                elif (rep.fail_streak
                      and rep.probation_until is not None
                      and tick >= rep.probation_until):
                    rep.fail_streak = 0     # survived probation
                    rep.probation_until = None
            elif (rep.state == "failed" and self.auto_restart
                  and rep.restart_at is not None
                  and tick >= rep.restart_at):
                self.restart(rep)
        if cl._orphans:
            self._rehome()

    def fail(self, rep, reason) -> None:
        """Mark one replica FAILED and fail over every non-terminal
        request it holds.  Idempotent on already-dead replicas."""
        cl = self.cluster
        if rep.state in ("failed", "restarting", "retired", "drained"):
            return
        # a HUNG replica stopped stepping but its engine is intact: its
        # page pool is still readable, so running requests can be
        # salvaged instead of re-prefilled.  A crashed/raising replica's
        # engine is garbage — decide before the hung flag is cleared.
        salvageable = cl.salvage and (
            rep.hung or reason in ("missed_beats", "watchdog"))
        rep.state = "failed"
        rep.hung = False
        rep.fails += 1
        rep.fail_streak += 1
        rep.probation_until = None
        try:
            faults.fire("replica.fail", "after")
        except faults.InjectedFault:
            pass            # the failure is already being handled
        # strip every live request off the dead scheduler (its engine is
        # garbage — the restart path rebuilds it, so no slot or page
        # bookkeeping is owed here) and fail each over
        sch = rep.engine.scheduler
        live = [r for r in sch.requests.values() if not r.terminal]
        for req in live:
            for pool in (sch.queue, sch.prefilling, sch.running):
                if req in pool:
                    pool.remove(req)
            sch.requests.pop(req.rid, None)
            if sch.spec is not None:
                try:
                    sch.spec.on_release(req)
                except Exception:
                    pass    # the dead engine's draft state is garbage
            cl._owner.pop(req.rid, None)
            if salvageable and req.state is RequestState.RUNNING \
                    and req.sid is not None \
                    and self._salvage(req, rep):
                continue
            self._failover(req, rep)
        # schedule the restart — or trip the breaker
        if rep.fail_streak > self.restart_budget:
            self.retire(rep)
        elif self.auto_restart:
            backoff = self.backoff_base * (
                2 ** (rep.fail_streak - 1))
            rep.restart_at = cl._tick + backoff

    def _failover(self, req, src) -> None:
        """Fail one request over to a healthy replica (or the orphan
        list).  The recompute resume is the preemption idiom: prefill
        prompt+generated from scratch, decode resumes bit-identically
        after the already-streamed tokens."""
        cl = self.cluster
        cl.failovers += 1
        if not req.terminal:
            req.resume_ids = np.concatenate(
                [req.prompt_ids,
                 np.asarray(req.generated, np.int32)]).astype(np.int32)
            req.prefill_done = 0
            req.sid = None
            req.state = RequestState.QUEUED
        if not self._place(req, src=src):
            cl._orphans.append(req)

    def _salvage(self, req, src) -> bool:
        """Move one RUNNING request's committed KV pages off a hung
        replica onto an admitting one (``gather_dense`` → ``write_at``),
        skipping the re-prefill: decoding resumes from the same last
        token over the same values, so the stream continues
        bit-identically.

        The copy is crc32-verified end to end (source gather → land →
        target re-gather); a mismatch, a capacity shortfall, an injected
        ``kv.salvage`` raise or an unreadable source returns False — the
        caller falls back to the recompute failover, never loss."""
        cl = self.cluster
        src_ex = src.engine.executor
        try:
            length = int(src_ex.cache.lengths[req.sid])
        except Exception:
            return False
        if length <= 0:
            return False
        dst = _with_room((r for r in cl._admitting() if r is not src),
                         length)
        if dst is None:
            return False
        try:
            faults.fire("kv.salvage", "before")
            k, v = _gather_kv(src_ex, req.sid, length)
        except Exception:
            cl.salvages_failed += 1
            return False
        crc = _crc(k, v)
        if faults.poll("kv.salvage") is not None:
            # injected in-flight corruption: the verify must catch it
            k = k.clone()
            flat = k.view(-1)
            flat[flat.numel() // 2] += 1
        dst_ex = dst.engine.executor
        try:
            dst_sid = _land_kv(dst_ex, k, v)
        except Exception:
            cl.salvages_failed += 1
            return False
        crc_got = None
        try:
            crc_got = _crc(*_gather_kv(dst_ex, dst_sid, length))
        except Exception:
            pass
        if crc_got != crc:
            # corrupt copy: give the pages back, recompute instead
            dst_ex.free_slot(dst_sid)
            cl.salvages_failed += 1
            return False
        dst_ex.last_token[dst_sid] = src_ex.last_token[req.sid]
        try:
            faults.fire("kv.salvage", "after")
        except faults.InjectedFault:
            pass            # pages landed verified: the salvage commits
        req.sid = dst_sid
        dst_sch = dst.engine.scheduler
        dst_sch.requests[req.rid] = req
        dst_sch.running.append(req)
        dst_sch._pending = None     # a stale async plan must replan
        if dst_sch.spec is not None:
            dst_sch.spec.on_running(req)
        cl._owner[req.rid] = dst
        cl.failovers += 1           # a salvage is a (cheap) failover
        cl.salvages += 1
        cl.salvaged_pages += int(
            (dst_ex.cache.page_table[dst_sid] >= 0).sum())
        return True

    def _place(self, req, src=None) -> bool:
        """Route one failed-over request onto an admitting replica;
        False when none exists.  An injected ``req.failover`` raise
        degrades to the first admitting replica — never loss."""
        cl = self.cluster
        targets = cl._admitting()
        if not targets:
            return False
        try:
            faults.fire("req.failover", "before")
            dst, _ = cl.router.pick(targets, req.resume_ids)
        except faults.InjectedFault:
            cl.router.degraded += 1
            dst = targets[0]
        dst.engine.scheduler.add(req)
        cl._owner[req.rid] = dst
        try:
            faults.fire("req.failover", "after")
        except faults.InjectedFault:
            pass            # the migration is already committed
        return True

    def _rehome(self) -> None:
        """Drain the orphan list onto whatever is admitting now."""
        cl = self.cluster
        remaining = []
        for req in cl._orphans:
            if req.terminal:
                continue
            if not self._place(req):
                remaining.append(req)
        cl._orphans[:] = remaining

    # -- restart + circuit breaker --------------------------------------

    def restart(self, rep):
        """One automatic restart attempt: rebuild the engine and rejoin
        admission.  A failed attempt counts against the breaker budget
        and doubles the backoff."""
        cl = self.cluster
        if rep.state != "failed":
            raise ValueError(
                f"cannot restart {rep.name}: state={rep.state!r}")
        rep.state = "restarting"
        rep.restart_at = None
        try:
            faults.fire("replica.restart", "before")
            eng = cl._build_engine()
            faults.fire("replica.restart", "after")
        except Exception:
            cl.restarts_failed += 1
            rep.fail_streak += 1
            if rep.fail_streak > self.restart_budget:
                self.retire(rep)
            else:
                rep.state = "failed"
                backoff = self.backoff_base * (
                    2 ** (rep.fail_streak - 1))
                rep.restart_at = cl._tick + backoff
            return None
        rep.engine = eng
        rep.state = "active"
        rep.hung = False
        rep.last_beat = cl._tick
        rep.restarts += 1
        rep.probation_until = cl._tick + self.probation
        cl.restarts += 1
        self._rehome()
        return rep

    def retire(self, rep) -> None:
        """Circuit breaker: permanently remove a flapping replica from
        rotation (state ``retired`` — never restarted)."""
        cl = self.cluster
        if rep.state == "retired":
            return
        rep.state = "retired"
        rep.restart_at = None
        cl.retired += 1


class ServingCluster:
    """N engine replicas behind a :class:`Router`, stepped in lockstep
    on one logical clock.  Exposes the single-engine driving surface
    (``submit`` / ``step`` / ``run`` / ``tick`` / ``in_flight`` /
    ``stats``), so :func:`paddle_tpu_torch.testing.load.run_load` drives
    a fleet exactly like one engine.

    ``cluster``: None = follow ``PT_CLUSTER`` (default off — the cluster
    collapses to one replica, bit-exact single-engine); True/False force
    it.  Engine keyword arguments (``max_seqs``, ``page_size``,
    ``prefix_cache``, ``aot``, ``device``, ``dtype``, ``quant``, ...)
    apply to every replica, built from the same ``(config, params)``.
    There is no ``compile_cache=``: a restarted replica's engine
    re-captures its CUDA graphs under ``aot="warm"``.
    """

    def __init__(self, config, params, n_replicas=2, cluster=None,
                 router_policy="affinity", router_seed=0,
                 disaggregated=False, n_prefill=None, clock=None,
                 beat_timeout=3, watchdog_s=None, auto_restart=True,
                 restart_budget=3, backoff_base=2, max_queue=None,
                 shed_deadlines=None, wal=None, salvage=True,
                 **engine_kwargs):
        if cluster is None:
            cluster = _gate("PT_CLUSTER")
        self.enabled = bool(cluster)
        if not self.enabled:
            n_replicas, disaggregated = 1, False
        n_replicas = int(n_replicas)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if disaggregated and n_replicas < 2:
            raise ValueError(
                "disaggregated mode needs >= 2 replicas "
                "(at least one prefill and one decode role)")
        self.disaggregated = bool(disaggregated)
        self.config = config
        self.params = params
        self._engine_kwargs = dict(engine_kwargs)
        # durable serving: ONE journal shared by the whole fleet (None =
        # follow PT_WAL, default off; a path or WriteAheadLog forces
        # on).  The cluster resolves the gate once and pins its engines
        # to that decision: two writers must never share a directory.
        self.wal = resolve_wal(wal)
        self._engine_kwargs["wal"] = (self.wal if self.wal is not None
                                      else False)
        # salvage: move a HUNG victim's committed KV pages to the
        # failover target instead of re-prefilling (crash victims still
        # recompute — a crashed engine's pool is garbage)
        self.salvage = bool(salvage)
        self._clock = clock
        self.router = Router(policy=router_policy, seed=router_seed)
        self.replicas: list = []
        self._n_built = 0
        self._tick = 0
        self._next_rid = 0
        self._owner: dict = {}      # rid -> Replica (current home)
        self.handoffs = 0
        self.handoff_tokens = 0
        self.handoffs_skipped = 0
        self.drains = 0
        self.drains_aborted = 0
        self.joins = 0
        self.joins_aborted = 0
        self.resteered = 0
        self.last_join = None       # the last join's capture report
        #: a list makes every handoff append its audit record (crc32 of
        #: the K/V at the source and as landed, the copy's seconds and
        #: bytes); None (the default) costs nothing
        self.handoff_audit = None
        self.supervisor = ReplicaSupervisor(
            self, beat_timeout=beat_timeout, watchdog_s=watchdog_s,
            auto_restart=auto_restart, restart_budget=restart_budget,
            backoff_base=backoff_base)
        # admission control: max_queue bounds the fleet-wide queued
        # backlog; shed_deadlines (default: on iff max_queue is set)
        # early-rejects requests whose deadline is provably unmeetable
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_deadlines = (self.max_queue is not None
                               if shed_deadlines is None
                               else bool(shed_deadlines))
        self.failovers = 0
        self.sheds = 0
        self.restarts = 0
        self.restarts_failed = 0
        self.retired = 0
        self.salvages = 0           # hung-replica KV-page migrations
        self.salvages_failed = 0    # fell back to recompute
        self.salvaged_pages = 0
        self.dedup_hits = 0         # duplicate submits deduplicated
        self._orphans: list = []    # failed-over, awaiting a home
        self._served: dict = {}     # rid -> terminal Request restored
        #                             from the journal (served from log)
        self.recovery = None        # report dict set by recover()
        self.recovered_handles = {}  # rid -> handle, set by recover()
        self._obs = obs.handle()    # the PT_OBS gate: on raises
        n_pre = 0
        if self.disaggregated:
            n_pre = (max(1, n_replicas // 2) if n_prefill is None
                     else int(n_prefill))
            if not 1 <= n_pre < n_replicas:
                raise ValueError(
                    f"n_prefill must be in [1, {n_replicas - 1}], "
                    f"got {n_pre}")
        for i in range(n_replicas):
            role = "mixed"
            if self.disaggregated:
                role = "prefill" if i < n_pre else "decode"
            self._build_replica(role)

    def _build_engine(self) -> ServingEngine:
        """One replica engine — the build and restart path."""
        return ServingEngine(self.config, self.params, clock=self._clock,
                             **self._engine_kwargs)

    def _build_replica(self, role="mixed") -> Replica:
        name = f"r{self._n_built}"
        self._n_built += 1
        rep = Replica(name, self._build_engine(), role=role)
        rep.last_beat = self._tick
        self.replicas.append(rep)
        return rep

    def replica(self, name) -> Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r} "
                       f"(have {[r.name for r in self.replicas]})")

    # -- routing + submission -------------------------------------------

    def _admitting(self):
        return [r for r in self.replicas if r.admitting]

    def _recovering(self) -> bool:
        """True when capacity is expected back: some replica is mid
        restart or failed with a restart already scheduled."""
        return any(
            r.state == "restarting"
            or (r.state == "failed" and r.restart_at is not None)
            for r in self.replicas)

    def _route(self, rid, prompt_ids):
        cands = self._admitting()
        if not cands:
            raise RuntimeError(
                "ServingCluster: no admitting replica")
        self.router.decisions += 1
        degraded = False
        try:
            faults.fire("route.pick", "before")
            rep, aff = self.router.pick(cands, prompt_ids)
        except faults.InjectedFault:
            # degraded placement: deterministic fallback to the first
            # admitting replica — the request is never dropped
            self.router.degraded += 1
            rep, aff, degraded = cands[0], 0, True
        if not degraded:
            try:
                faults.fire("route.pick", "after")
            except faults.InjectedFault:
                self.router.degraded += 1   # the decision stands
        return rep, aff

    def submit(self, prompt_ids, max_new_tokens=16, priority=0,
               deadline=None, on_token=None, rid=None) -> RequestHandle:
        """Route one request to a replica; the returned handle drives
        the whole cluster (``result()`` / ``stream()`` step every
        replica), so it stays live across failovers."""
        if rid is None:
            # auto rids must never collide with journaled, recovered or
            # client-supplied rids (recover() also advances _next_rid
            # past every replayed req-N)
            rid = f"req-{self._next_rid}"
            while self._known(rid) is not None:
                self._next_rid += 1
                rid = f"req-{self._next_rid}"
        known = self._known(rid)
        if known is not None:
            # idempotent duplicate submit: at-least-once clients get the
            # ORIGINAL request back (live, orphaned, or terminal —
            # including streams recovered from the journal); journaled
            self.dedup_hits += 1
            if self.wal is not None:
                self.wal.append({"t": "dedup", "rid": rid})
            return RequestHandle(self, known)
        self._next_rid += 1
        verdict = self._shed_verdict(deadline)
        if verdict is not None:
            shed = self._shed(rid, prompt_ids, max_new_tokens,
                              priority, deadline, on_token, verdict)
            if shed is not None:
                return shed     # REJECTED terminal, never silent loss
        if not self._admitting() and self._recovering():
            # the whole admitting set is down but a restart is already
            # scheduled: park the request (never refused, never lost)
            req = Request(rid, prompt_ids,
                          max_new_tokens=max_new_tokens,
                          priority=priority, deadline=deadline,
                          on_token=on_token)
            if len(req.prompt_ids) == 0:
                raise ValueError("prompt_ids must be non-empty")
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            self._orphans.append(req)
            if self.wal is not None:
                # parked submits are accepted work: journal them like
                # any other, so a crash while orphaned still recovers
                self.wal.append({
                    "t": "submit", "rid": rid,
                    "prompt": req.prompt_ids.tolist(),
                    "max_new": req.max_new_tokens,
                    "prio": req.priority, "deadline": req.deadline})
            return RequestHandle(self, req)
        rep, _ = self._route(rid, np.asarray(
            prompt_ids, np.int32).reshape(-1))
        handle = rep.engine.submit(
            prompt_ids, max_new_tokens=max_new_tokens,
            priority=priority, deadline=deadline, on_token=on_token,
            rid=rid)
        self._owner[rid] = rep
        return RequestHandle(self, handle._req)

    # -- admission control (overload shedding) --------------------------

    def _queued_total(self) -> int:
        return len(self._orphans) + sum(
            len(r.engine.scheduler.queue) for r in self.replicas
            if r.state not in DEAD_STATES)

    def _shed_verdict(self, deadline):
        """(reason, retry_after_steps) to reject now, else None.

        Deterministic on the logical clock: the backlog bound counts
        every queued-not-admitted request fleet-wide; the deadline check
        uses a lower bound on TTFT (one prefill step plus the queue
        overflow ahead of the best replica)."""
        queued = self._queued_total()
        if self.max_queue is not None and queued >= self.max_queue:
            return ("overload", max(1, queued - self.max_queue + 1))
        if deadline is not None and self.shed_deadlines:
            best = None
            for rep in self._admitting():
                est = 1 + max(0, rep.depth
                              - rep.engine.executor.cache.max_seqs)
                if best is None or est < best:
                    best = est
            if best is not None and best > int(deadline):
                return ("deadline_unmeetable",
                        max(1, best - int(deadline)))
        return None

    def _shed(self, rid, prompt_ids, max_new_tokens, priority,
              deadline, on_token, verdict):
        """Reject one request at the boundary: terminal REJECTED with a
        retry-after hint.  An injected ``req.shed`` before-raise
        degrades to ADMITTING the request (returns None)."""
        reason, retry_after = verdict
        try:
            faults.fire("req.shed", "before")
        except faults.InjectedFault:
            return None
        req = Request(rid, prompt_ids, max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline,
                      on_token=on_token)
        req.state = RequestState.REJECTED
        req.finish_reason = reason
        req.retry_after = int(retry_after)
        req.error = RequestRejected(rid, reason, retry_after)
        self.sheds += 1
        # NOT added to the dedup set: a retry_after verdict invites a
        # resubmit of the same rid after backing off
        if self.wal is not None:
            self.wal.append({"t": "reject", "rid": rid,
                             "reason": reason,
                             "retry_after": int(retry_after)})
        try:
            faults.fire("req.shed", "after")
        except faults.InjectedFault:
            pass                # the rejection is already terminal
        return RequestHandle(self, req)

    def cancel(self, rid) -> None:
        rep = self._owner.get(rid)
        if rep is not None:
            rep.engine.cancel(rid)
            return
        for req in self._orphans:   # cancelled while awaiting a home
            if req.rid == rid and not req.terminal:
                req.cancel_flag = True

    def request(self, rid):
        return self._known(rid)

    def _known(self, rid):
        """The live/terminal Request for ``rid`` wherever it lives — its
        owning replica, the journal-restored terminal set, or the orphan
        list — else None."""
        rep = self._owner.get(rid)
        if rep is not None:
            req = rep.engine.request(rid)
            if req is not None:
                return req
        req = self._served.get(rid)
        if req is not None:
            return req
        for req in self._orphans:
            if req.rid == rid:
                return req
        return None

    # -- driving ---------------------------------------------------------

    def step(self) -> dict:
        """One cluster iteration: every live replica steps once under
        the supervisor's watch, then disaggregated handoffs run, the
        supervisor polls (missed-beat detection, restarts, orphan
        re-homing) and finished drains retire.  Returns the merged
        {rid: [tokens]} map."""
        self._tick += 1
        emitted: dict = {}
        for rep in list(self.replicas):
            if rep.state in DEAD_STATES:
                continue
            for rid, toks in self.supervisor.step_replica(rep).items():
                emitted.setdefault(rid, []).extend(toks)
        if self.disaggregated:
            self._migrate()
        self.supervisor.poll()
        for rep in self.replicas:
            if rep.state == "draining" and rep.engine.in_flight == 0:
                rep.state = "drained"
        return emitted

    def run(self, max_steps=100000) -> dict:
        while self.in_flight:
            if self._tick >= max_steps:
                raise RuntimeError(
                    f"cluster did not drain in {max_steps} steps")
            self.step()
        return self.stats()

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def in_flight(self) -> int:
        return len(self._orphans) + sum(
            rep.engine.in_flight for rep in self.replicas
            if rep.state not in DEAD_STATES)

    # -- operator hooks --------------------------------------------------

    def fail(self, name, reason="operator") -> Replica:
        """Force one replica FAILED (the operator's kill switch):
        in-flight requests fail over at once, the supervisor owns the
        restart and breaker follow-up."""
        rep = self.replica(name) if not isinstance(name, Replica) \
            else name
        self.supervisor.fail(rep, reason)
        return rep

    def drain(self, name) -> Replica:
        """Close one replica's admission and re-steer its queued
        requests; prefilling and running work finishes in place and the
        replica retires (state ``drained``) once idle.  Refuses to drain
        the last admitting replica: the fleet must keep accepting.

        Draining a ``draining`` or ``drained`` replica is a no-op (the
        same replica back, no counter, no re-steer, no fault point);
        draining a ``failed``, ``restarting`` or ``retired`` one raises,
        as there is nothing to hand off."""
        rep = self.replica(name) if not isinstance(name, Replica) \
            else name
        if rep.state in ("draining", "drained"):
            return rep
        if rep.state != "active":
            raise ValueError(
                f"cannot drain {rep.name}: state={rep.state!r} "
                f"(only active replicas drain)")
        targets = [r for r in self.replicas
                   if r is not rep and r.admitting]
        if rep.admitting and not targets:
            raise RuntimeError(
                f"cannot drain {rep.name}: it is the last admitting "
                f"replica")
        try:
            faults.fire("replica.drain", "before")
        except faults.InjectedFault:
            # aborted before anything moved: the replica stays active
            self.drains_aborted += 1
            return rep
        rep.state = "draining"
        sch = rep.engine.scheduler
        moved = list(sch.queue)
        for req in moved:
            sch.queue.remove(req)
            sch.requests.pop(req.rid, None)
            self._owner.pop(req.rid, None)
        for req in moved:
            dst, _ = self.router.pick(targets, req.resume_ids)
            dst.engine.scheduler.add(req)
            self._owner[req.rid] = dst
            self.resteered += 1
        try:
            faults.fire("replica.drain", "after")
        except faults.InjectedFault:
            pass                    # the drain is already committed
        self.drains += 1
        return rep

    def join(self, role=None):
        """Add a fresh replica (``role`` default ``decode`` in a
        disaggregated fleet, else ``mixed``); returns it, or None when an
        injected ``replica.join`` fault aborts the build (the fleet as it
        was).  A join never touches a draining replica; a draining
        replica's re-steered queue may land on the newcomer at the next
        routing decision only.  The port has no compile cache on disk:
        the new engine captures its own decode graphs (at build under
        ``aot="warm"``, else at first use), and ``last_join`` reports
        the graphs captured and their seconds at the join."""
        if role is None:
            role = "decode" if self.disaggregated else "mixed"
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"join role must be mixed|prefill|decode, got {role!r}")
        try:
            faults.fire("replica.join", "before")
        except faults.InjectedFault:
            self.joins_aborted += 1
            return None
        t0 = time.perf_counter()
        rep = self._build_replica(role=role)
        try:
            faults.fire("replica.join", "after")
        except faults.InjectedFault:
            pass            # engine built: the join is committed
        self.joins += 1
        self.last_join = dict(replica=rep.name, role=role,
                              build_s=time.perf_counter() - t0,
                              **self.graphs(rep))
        return rep

    @staticmethod
    def graphs(rep) -> dict:
        """A replica's captured programs: graphs captured and the host
        seconds their captures took (warm-ups included)."""
        progs = rep.engine.executor.programs.values()
        return {"graphs_captured": sum(p.traces for p in progs),
                "capture_s": sum(p.seconds for p in progs)}

    # -- disaggregated prefill -> decode handoff --------------------------

    def _migrate(self):
        decode_reps = [r for r in self.replicas
                       if r.role == "decode" and r.state == "active"]
        if not decode_reps:
            return
        for rep in self.replicas:
            if rep.role != "prefill" or rep.state == "drained":
                continue
            for req in list(rep.engine.scheduler.running):
                self._handoff(rep, req, decode_reps)

    def _handoff(self, src, req, decode_reps) -> bool:
        """Move one RUNNING sequence from a prefill replica to the
        decode replica with the most room: its K/V pages by salvage's
        copy (``gather_dense`` → ``write_at``), its last token, then the
        request.  Skips (the request keeps decoding on its source:
        degradation, never loss) when no decode replica has room or an
        injected ``kv.handoff`` before-fault fires."""
        src_ex = src.engine.executor
        length = int(src_ex.cache.lengths[req.sid])
        dst = _with_room(decode_reps, length)
        if dst is None:
            self.handoffs_skipped += 1
            return False
        try:
            faults.fire("kv.handoff", "before")
        except faults.InjectedFault:
            self.handoffs_skipped += 1
            return False
        dst_ex = dst.engine.executor
        audit = self.handoff_audit
        if audit is None:
            dst_sid = _land_kv(dst_ex, *_gather_kv(src_ex, req.sid, length))
        else:
            dst_sid = self._audited_copy(src_ex, req, length, dst_ex)
        dst_ex.last_token[dst_sid] = src_ex.last_token[req.sid]
        try:
            faults.fire("kv.handoff", "after")
        except faults.InjectedFault:
            pass    # pages landed refcounted: the handoff commits
        src_sch = src.engine.scheduler
        if src_sch.spec is not None:
            src_sch.spec.on_release(req)
        src_sch.running.remove(req)
        src_sch.requests.pop(req.rid, None)
        src_ex.free_slot(req.sid)
        src_sch._pending = None   # any parked plan names the old slot
        dst_sch = dst.engine.scheduler
        req.sid = dst_sid
        dst_sch.requests[req.rid] = req
        dst_sch.running.append(req)
        dst_sch._pending = None   # the predicted running set changed
        if dst_sch.spec is not None:
            dst_sch.spec.on_running(req)
        self._owner[req.rid] = dst
        self.handoffs += 1
        self.handoff_tokens += length
        return True

    def _audited_copy(self, src_ex, req, length, dst_ex) -> int:
        """The handoff's copy with its audit record: the gather and the
        write each timed between device synchronisations, the crc32 of
        the K/V at the source and as landed taken outside the timing."""
        dev = dst_ex.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        sync()
        t0 = time.perf_counter()
        k, v = _gather_kv(src_ex, req.sid, length)
        sync()
        t1 = time.perf_counter()
        crc = _crc(k, v)
        sync()
        t2 = time.perf_counter()
        dst_sid = _land_kv(dst_ex, k, v)
        sync()
        t3 = time.perf_counter()
        self.handoff_audit.append(dict(
            rid=req.rid, tokens=length,
            pages=int((dst_ex.cache.page_table[dst_sid] >= 0).sum()),
            bytes=2 * (k.numel() * k.element_size()),
            gather_s=t1 - t0, write_s=t3 - t2, crc_src=crc,
            crc_dst=_crc(*_gather_kv(dst_ex, dst_sid, length))))
        return dst_sid

    # -- introspection ---------------------------------------------------

    def _statusz(self) -> dict:
        """The reference's ``/statusz`` "cluster" page (routing,
        handoffs, drains, joins, survivability, each replica's role,
        state and pool); the port serves no page yet (item 9), so
        callers read it directly."""
        return {
            "tick": self._tick,
            "enabled": self.enabled,
            "disaggregated": self.disaggregated,
            "router": {
                "policy": self.router.policy,
                "decisions": self.router.decisions,
                "affinity_hits": self.router.affinity_hits,
                "degraded": self.router.degraded,
                "resteered": self.resteered,
            },
            "handoffs": {
                "done": self.handoffs,
                "tokens": self.handoff_tokens,
                "skipped": self.handoffs_skipped,
            },
            "drains": {"done": self.drains,
                       "aborted": self.drains_aborted},
            "joins": {"done": self.joins,
                      "aborted": self.joins_aborted,
                      "last": self.last_join},
            "survivability": {
                "failovers": self.failovers,
                "shed": self.sheds,
                "orphans": len(self._orphans),
                "restarts": {"done": self.restarts,
                             "failed": self.restarts_failed},
                "retired": self.retired,
            },
            "replicas": [
                {
                    "name": rep.name,
                    "role": rep.role,
                    "state": rep.state,
                    "tick": rep.engine.tick,
                    "in_flight": rep.engine.in_flight,
                    "queued": len(rep.engine.scheduler.queue),
                    "running": len(rep.engine.scheduler.running),
                    "pool": {
                        "num_pages":
                            rep.engine.executor.cache.num_pages,
                        "free_pages": rep.engine.executor.free_pages,
                    },
                    "prefix": (None if rep.engine.prefix is None
                               else rep.engine.prefix.stats()),
                    **self.graphs(rep),
                }
                for rep in self.replicas
            ],
        }

    def stats(self) -> dict:
        """Aggregate fleet stats plus each replica's engine stats.
        ``agg_tok_per_step`` is decode tokens per cluster tick."""
        per = {rep.name: rep.engine.stats() for rep in self.replicas}
        reqs: dict = {}
        for p in per.values():
            for k, n in p["requests"].items():
                reqs[k] = reqs.get(k, 0) + n
        decode = sum(p["decode_tokens"] for p in per.values())
        prefill = sum(p["prefill_tokens"] for p in per.values())
        cached = sum(p["cached_tokens"] for p in per.values())
        return {
            "steps": self._tick,
            "replicas": len(self.replicas),
            "requests": reqs,
            "decode_tokens": decode,
            "prefill_tokens": prefill,
            "cached_tokens": cached,
            "agg_tok_per_step": round(decode / max(self._tick, 1), 4),
            "prefix_hit_rate": round(
                cached / max(cached + prefill, 1), 4),
            "router": {
                "policy": self.router.policy,
                "decisions": self.router.decisions,
                "affinity_hits": self.router.affinity_hits,
                "degraded": self.router.degraded,
                "resteered": self.resteered,
            },
            "handoffs": self.handoffs,
            "handoffs_skipped": self.handoffs_skipped,
            "failovers": self.failovers,
            "shed": self.sheds,
            "orphans": len(self._orphans),
            "restarts": self.restarts,
            "restarts_failed": self.restarts_failed,
            "retired": self.retired,
            "salvages": self.salvages,
            "salvages_failed": self.salvages_failed,
            "salvaged_pages": self.salvaged_pages,
            "dedup_hits": self.dedup_hits,
            "wal_appended": (0 if self.wal is None
                             else self.wal.appended),
            "per_replica": per,
        }

    # -- whole-process crash recovery -----------------------------------

    def _stream_end(self, req, toks):
        """The terminal (state, reason) that the replayed stream ``toks``
        of ``req`` has reached by the scheduler's rule in ``_on_token``
        (eos, then the length cap), or None while it is still open."""
        sch = self.replicas[0].engine.scheduler
        if toks and sch.eos_token_id is not None \
                and toks[-1] == int(sch.eos_token_id):
            return RequestState.FINISHED, "eos"
        cap = min(req.max_new_tokens,
                  sch.executor.max_len - len(req.prompt_ids))
        if len(toks) < cap:
            return None
        if cap < req.max_new_tokens:
            return RequestState.TRUNCATED, "length"
        return RequestState.FINISHED, "length"

    @classmethod
    def recover(cls, config, params, wal_dir, **kwargs) -> "ServingCluster":
        """Rebuild a serving fleet from its write-ahead journal after a
        whole-process crash (SIGKILL included).

        Replays the journal (torn tails truncated, corrupt records
        skipped and counted), builds the cluster (``kwargs`` as for the
        constructor) and settles every journaled request into exactly
        one of:

        - **served from the log**: a finish record whose token count and
          crc32 match the replayed stream (or a reject record) restores
          the terminal request verbatim — no recompute; so does a
          replayed stream that already ends by the engine's own rule
          (the length cap or eos) but lost its finish record, which is
          then journaled (``paddle_tpu`` resubmits that stream and
          emits one token too many);
        - **resubmitted**: anything in flight at the crash (or whose
          tail records were torn or corrupt) re-enters through the
          preemption-recompute idiom — prompt + replayed tokens
          re-prefill and decoding resumes after them.

        Journaling continues into the same directory (a fresh segment),
        so recovery is itself crash-safe and repeatable.  Client
        resubmits of a journaled rid dedupe to the restored request.
        ``recovery`` holds the report; ``recovered_handles`` maps every
        journaled rid to a live handle.  Deadlines are not rebuilt: the
        logical clock restarted.
        """
        records, report = wal_mod.replay(wal_dir)
        cl = cls(config, params, wal=wal_dir, **kwargs)
        by: dict = {}
        order: list = []
        for rec in records:
            t, rid = rec.get("t"), rec.get("rid")
            if rid is None:
                continue
            e = by.get(rid)
            if e is None:
                e = by[rid] = {"tokens": []}
                order.append(rid)
            if t == "submit":
                if "reject" in e:
                    # shed rids are not deduped, so a submit AFTER a
                    # reject is the client's post-backoff retry: it
                    # supersedes the rejection and starts a fresh stream
                    e["submit"] = rec
                    e["tokens"] = []
                    del e["reject"]
                elif "submit" not in e:
                    e["submit"] = rec   # at-least-once: first write wins
            elif t == "token":
                # only the contiguous-from-zero prefix is trusted: a
                # token past a corrupt record's gap is recomputed
                if int(rec.get("i", len(e["tokens"]))) == len(e["tokens"]):
                    e["tokens"].append(int(rec["tok"]))
            elif t == "finish":
                e["finish"] = rec
            elif t == "reject":
                e["reject"] = rec
        # advance the auto-rid counter past every journaled req-N, so a
        # fresh anonymous submit never dedups to a recovered request
        for rid in by:
            if isinstance(rid, str) and rid.startswith("req-"):
                try:
                    cl._next_rid = max(cl._next_rid, int(rid[4:]) + 1)
                except ValueError:
                    pass
        served = resubmitted = 0
        cl.recovered_handles = {}
        for seq, rid in enumerate(order):
            e = by[rid]
            sub = e.get("submit")
            if sub is None:
                if "reject" in e:
                    # shed and never resubmitted: the rejection was
                    # delivered live and is not deduped — nothing to
                    # restore
                    continue
                # lifecycle records without a submit record (its line
                # was corrupt): no prompt to recompute from
                report["corrupt"] += 1
                continue
            req = Request(rid, np.asarray(sub["prompt"], np.int32),
                          max_new_tokens=sub["max_new"],
                          priority=sub.get("prio", 0),
                          arrival_seq=seq)
            req.recovered = True
            fin, rej, toks = e.get("finish"), e.get("reject"), e["tokens"]
            end = None if rej is not None else cl._stream_end(req, toks)
            if rej is not None:
                req.state = RequestState.REJECTED
                req.finish_reason = rej["reason"]
                req.retry_after = int(rej["retry_after"])
                req.error = RequestRejected(rid, rej["reason"],
                                            rej["retry_after"])
                served += 1
            elif fin is not None and fin["n"] == len(toks) \
                    and fin["crc"] == stream_crc(toks):
                # the journaled stream is provably complete: serve it
                # straight from the log
                req.generated = list(toks)
                req.state = RequestState(fin["state"])
                req.finish_reason = fin["reason"]
                if req.state is RequestState.FAILED:
                    req.error = RuntimeError(fin["reason"])
                cl._served[rid] = req
                served += 1
            elif end is not None:
                # complete but its finish record was lost (the crash fell
                # between the last token record and the finish): finish
                # it from the log and journal the finish it lacked.
                # paddle_tpu resubmits such a stream and emits one token
                # past its end
                req.generated = list(toks)
                req.state, req.finish_reason = end
                cl._served[rid] = req
                if cl.wal is not None:
                    cl.wal.append({
                        "t": "finish", "rid": rid, "state": req.state.value,
                        "reason": req.finish_reason, "n": len(toks),
                        "crc": stream_crc(toks)})
                served += 1
            else:
                # in flight at the crash (or its finish/token records
                # were torn): the recompute idiom resumes it after the
                # replayed prefix
                req.generated = list(toks)
                req.resume_ids = np.concatenate(
                    [req.prompt_ids,
                     np.asarray(toks, np.int32)]).astype(np.int32)
                req.prefill_done = 0
                req.state = RequestState.QUEUED
                if not cl.supervisor._place(req):
                    cl._orphans.append(req)
                resubmitted += 1
            cl.recovered_handles[rid] = RequestHandle(cl, req)
        cl.recovery = {
            "segments": report["segments"],
            "records": report["records"],
            "corrupt": report["corrupt"],
            "torn_bytes": report["torn_bytes"],
            "served_from_log": served,
            "resubmitted": resubmitted,
            "orphaned": len(cl._orphans),
        }
        if cl.wal is not None:
            cl.wal.append({"t": "recover", **cl.recovery})
            cl.wal.fsync()
        return cl
