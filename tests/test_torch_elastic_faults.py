"""The elastic fleet's fault matrix against ``paddle_tpu``'s: under the
fault points ``replica.drain``, ``replica.join`` and ``kv.handoff``,
one injected raise at the point's first hit and the same calls on both
fleets give the same streams (each a single engine's), the same counters
and the armed spec hit as many times in each package.

Split from ``tests/test_torch_elastic.py`` (whose fixtures and helpers
it uses) so that two workers share the fleets' compiles.
"""
import pytest

from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.inference.server import RequestState
from paddle_tpu_torch.testing import faults

from test_torch_elastic import (  # noqa: F401,E402  (fixtures by name)
    _clean, _counts, _fleets, _run, _submit_all, baseline, pair,
)


# -- the fault matrix: degrade, never lose, hit for hit -----------------------

@pytest.mark.parametrize("point", ["replica.drain", "replica.join",
                                   "kv.handoff"])
@pytest.mark.parametrize("phase", ["before", "after"])
def test_fault_matrix_hit_for_hit(pair, baseline, point, phase):
    """One injected raise at the point's first hit, the same calls on
    both fleets: the same streams (each a single engine's), the same
    counters, and the armed spec hit as many times in each package."""
    work, base = baseline
    disagg = point == "kv.handoff"
    cl, jcl = _fleets(pair, n_replicas=2, disaggregated=disagg)
    got = []
    for c, fm in ((cl, faults), (jcl, jfaults)):
        spec = fm.arm(point, phase, 1, "raise")
        other = fm.arm(point, "after" if phase == "before" else "before",
                       "*", "delay", "0")
        handles = _submit_all(c, work)
        for _ in range(3):
            c.step()
        if point == "replica.drain":
            rep = c.drain("r0")
            if phase == "before":        # aborted before anything moved
                assert rep.state == "active" and c.drains_aborted == 1
                assert c.resteered == 0
            else:                        # the drain is already committed
                assert rep.state in ("draining", "drained")
                assert c.drains == 1
        if point == "replica.join":
            rep = c.join()
            if phase == "before":        # the fleet exactly as it was
                assert rep is None and len(c.replicas) == 2
                assert c.joins_aborted == 1
            else:                        # engine built: join committed
                assert rep is not None and len(c.replicas) == 3
                assert c.joins == 1
        _run(c, audit=c is cl)
        for rid, h in handles.items():
            assert h.state.value == RequestState.FINISHED.value, \
                (point, phase, rid)
            assert h.tokens == base[rid], (point, phase, rid)
        if point == "kv.handoff":
            if phase == "before":        # first shipment skipped in place
                assert c.handoffs_skipped >= 1
            assert c.handoffs >= 1       # later shipments still commit
        got.append((spec.hits, other.hits, _counts(c)))
    assert got[0] == got[1]
    assert got[0][0] >= 1
