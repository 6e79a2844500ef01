"""The serving programs' AOT plane: shape ladders and captured CUDA graphs.

Counterpart of ``paddle_tpu/core/aot.py`` and of ``CountedJit``
(``paddle_tpu/analysis/audit.py``).  The mode knob, the miss error, the
bucket ladder and the page buckets are copies of the reference's.  Where
the reference AOT-compiles one XLA executable per (program x shape rung),
the port captures one ``torch.cuda.CUDAGraph`` per rung
(:class:`CountedGraph`): a captured decode step replays every kernel of
the forward with one host call, which is what ``jax.jit`` gives a
fixed-shape program on the TPU.  ``models.CompiledTrainStep.multi_step``
captures its k train steps through the same class (the counterpart of
the reference's ``lax.scan`` over k steps in one program).

Not ported: ``CompileCache``, ``signature`` and ``cache_root``.  A CUDA
graph holds device addresses of the process that captured it and cannot
be serialized, so there is no executable to keep on disk; a warm engine
captures at build (a fraction of a second per rung).

Fault points: an explicit :meth:`CountedGraph.aot_capture` (the warmup)
fires ``aot.lower`` around the warm-up run of the forward and
``aot.compile`` around the graph's capture, never inside the captured
region.  A raise there fails that warmup entry only (the executor's
warmup records it and serving goes on; the rung captures at its first
call).  ``aot.cache`` has no site: nothing is kept on disk.
"""
from __future__ import annotations

import gc
import inspect
import os
import time
import weakref

import torch

from ..testing import faults

MODES = ("off", "warm", "strict")


class AotMissError(RuntimeError):
    """A sealed (PT_AOT=strict) program was dispatched at a shape rung
    the warmup never captured."""


def mode() -> str:
    """``PT_AOT`` (default ``off``); a value outside :data:`MODES` raises."""
    m = os.environ.get("PT_AOT", "off").strip().lower()
    if m not in MODES:
        raise ValueError(f"PT_AOT must be one of {MODES}, got {m!r}")
    return m


# -- the shape-bucket ladder --------------------------------------------------

class BucketLadder:
    """Sorted positive rungs a runtime quantity is quantized onto.

    ``floor(n)`` (largest rung <= n) drives chunked prefill: taking the
    floor rung of the remaining prompt each step decomposes any length
    into descending rungs (for powers of two, its binary expansion).
    ``ceil(n)`` (smallest rung >= n) drives padding-style bucketing."""

    def __init__(self, rungs):
        rungs = sorted({int(r) for r in rungs})
        if not rungs or rungs[0] < 1:
            raise ValueError(f"BucketLadder needs positive rungs, "
                             f"got {rungs}")
        self.rungs = tuple(rungs)

    @classmethod
    def pow2(cls, cap, lo=1) -> "BucketLadder":
        """Powers of two from ``lo`` up to (at most) ``cap``."""
        cap, r = int(cap), int(lo)
        if cap < r:
            raise ValueError(f"pow2 ladder cap {cap} < lo {lo}")
        rungs = []
        while r <= cap:
            rungs.append(r)
            r *= 2
        return cls(rungs)

    def floor(self, n):
        """Largest rung <= n, or None when n is below the ladder."""
        n = int(n)
        best = None
        for r in self.rungs:
            if r > n:
                break
            best = r
        return best

    def ceil(self, n):
        """Smallest rung >= n, or None when n is above the ladder."""
        n = int(n)
        for r in self.rungs:
            if r >= n:
                return r
        return None

    def chunks(self, total):
        """Descending rung decomposition of ``total``: the chunk sequence
        the scheduler produces for a prompt."""
        out, left = [], int(total)
        while left > 0:
            r = self.floor(left)
            if r is None:
                raise ValueError(
                    f"{left} is below the smallest rung "
                    f"{self.rungs[0]}")
            out.append(r)
            left -= r
        return out

    def __contains__(self, n):
        return int(n) in self.rungs

    def __repr__(self):
        return f"BucketLadder{self.rungs}"


def page_buckets(max_pages) -> tuple:
    """Past-KV page-cover buckets: 0 (no past), powers of two, and the
    per-seq page budget itself as the cap."""
    out, r = [0], 1
    while r < int(max_pages):
        out.append(r)
        r *= 2
    out.append(int(max_pages))
    return tuple(sorted(set(out)))


def bucket_pages(n, buckets):
    """Smallest bucket >= n (capped at the top bucket)."""
    n = int(n)
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


# -- captured programs --------------------------------------------------------

def _read(counters):
    return [(c.launches, dict(getattr(c, "routes", None) or {}))
            for c in counters]


def _add(counters, tally):
    for c, (n, routes) in zip(counters, tally):
        c.launches += n
        for k, v in routes.items():
            c.routes[k] = c.routes.get(k, 0) + v


def _restore(counters, state):
    for c, (n, routes) in zip(counters, state):
        c.launches = n
        if routes:
            c.routes.update(routes)


def _weak(fn):
    """A callable returning ``fn``, holding a bound method weakly."""
    if inspect.ismethod(fn):
        return weakref.WeakMethod(fn)
    return lambda: fn


def _no_fire(point, phase):
    return None


class CountedGraph:
    """A forward over fixed-address buffers, captured once per shape rung
    and replayed: the port's ``CountedJit``.

    ``fn(rung)`` runs the program at ``rung`` (a tuple of ints, such as
    ``(B,)``): it reads its inputs from buffers whose addresses never
    change, which the caller fills before each call, and returns its
    outputs.  ``scratch()`` is a context manager entered around the
    warm-up and the capture: it points the input buffers at state that
    writes nothing live (the KV pool's scratch page) and puts the staged
    inputs back on exit.

    On ``device`` CUDA, :meth:`aot_capture` runs ``fn`` once eagerly on a
    side stream (first-use attributes and workspaces must not happen under
    capture), then captures it into a ``torch.cuda.CUDAGraph`` whose memory
    comes from ``pool`` (graphs that never run at once may share one).
    ``generators`` are the ``torch.Generator`` s ``fn`` draws from besides
    the default one: each is registered with the graph, so a replay
    advances it and draws fresh numbers (unregistered, every replay would
    repeat the capture's draw).  With ``release`` the allocator's cache is
    emptied between the warm-up and the capture, so that the graph's
    private pool can take the memory the warm-up held (a 7B train step's
    warm-up and graph would not both fit); serving's small decode graphs
    skip that synchronisation.
    A call at a captured rung replays; a call at a new rung captures first,
    as ``jax.jit`` traces on a first call, unless :meth:`seal` was called,
    and then it raises :class:`AotMissError`.  A capture that fails
    raises: nothing falls back to the eager forward.

    On the CPU (the tests) :meth:`aot_capture` runs the same warm-up under
    ``scratch`` and records the rung, and a call runs ``fn`` eagerly over
    the same buffers.

    ``traces`` counts captures, ``seconds`` the host time they took
    (warm-ups included), and ``dispatches`` calls (replays on CUDA).
    ``counters`` are the launch-counted kernel wrappers (an int
    ``launches``, optionally a dict ``routes``).  A replay launches no
    wrapper, so each graph keeps the tally of counted launches its
    capture recorded and adds it on every replay; the warm-up's and the
    capture's own increments are taken back, so a counter moves once per
    kernel run of the serving path, replayed or eager."""

    def __init__(self, fn, *, name, device, scratch, counters=(),
                 pool=None, generators=(), release=False):
        self.name = name
        self.device = torch.device(device)
        self.traces = 0
        self.seconds = 0.0
        self.dispatches = 0
        # bound methods are held weakly: the executor (or the train step)
        # owns its programs, and a reference cycle would leave its graphs
        # and their memory to the collector
        self._fn = _weak(fn)
        self._scratch_ref = _weak(scratch)
        self._counters = tuple(counters)
        self._pool = pool
        self._generators = tuple(generators)
        self._release = release
        #: rung -> (graph, outputs, launch tally); graph None on the CPU
        self._exe = {}
        self._sealed = False

    @property
    def fn(self):
        return self._fn()

    def _scratch(self):
        return self._scratch_ref()()

    def _warm_and_capture(self, rung, points):
        fire = faults.fire if points else _no_fire
        fn = self.fn
        if self.device.type != "cuda":
            fire("aot.lower", "before")
            fn(rung)
            fire("aot.lower", "after")
            fire("aot.compile", "before")
            fire("aot.compile", "after")
            return None, None, [(0, {}) for _ in self._counters]
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        fire("aot.lower", "before")
        with torch.cuda.stream(side):
            fn(rung)
        stream.wait_stream(side)
        fire("aot.lower", "after")
        if self._release:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        before = _read(self._counters)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        # no collection during the capture: a finalizer that frees another
        # graph or an event there (a CUDA call the capture forbids)
        # invalidates it
        fire("aot.compile", "before")
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = fn(rung)
        finally:
            if enabled:
                gc.enable()
        fire("aot.compile", "after")
        tally = [(n - n0, {k: v - r0.get(k, 0) for k, v in r.items()})
                 for (n, r), (n0, r0) in zip(_read(self._counters), before)]
        return graph, out, tally

    def aot_capture(self, rung, points=True) -> str:
        """Capture the program at ``rung`` unless it already is; returns
        ``"warm"`` (already captured) or ``"capture"``.  ``points``: fire
        the ``aot.*`` fault points (the warmup's captures do; a capture
        at a first call does not, as the reference's plain jit does
        not)."""
        rung = tuple(rung)
        if rung in self._exe:
            return "warm"
        state = _read(self._counters)
        t0 = time.perf_counter()
        try:
            with self._scratch():
                exe = self._warm_and_capture(rung, points)
        finally:
            _restore(self._counters, state)
        self._exe[rung] = exe
        self.traces += 1
        self.seconds += time.perf_counter() - t0
        return "capture"

    def seal(self) -> None:
        """Forbid captures from now on: a call at a rung with no graph
        raises :class:`AotMissError`."""
        self._sealed = True

    def __call__(self, rung):
        rung = tuple(rung)
        if rung not in self._exe:
            if self._sealed:
                raise AotMissError(
                    f"[{self.name}] PT_AOT=strict: dispatch at rung {rung} "
                    f"after seal(), which the warmup never captured (the "
                    f"shape ladder must cover every runtime shape)")
            self.aot_capture(rung, points=False)
        self.dispatches += 1
        graph, out, tally = self._exe[rung]
        if graph is None:
            return self.fn(rung)
        graph.replay()
        _add(self._counters, tally)
        return out
