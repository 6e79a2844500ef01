"""``Adamax``, ``NAdam``, ``RAdam``, ``Adadelta``, ``Rprop`` and ``ASGD``
(``paddle_tpu/optimizer/extra.py``) are not ported yet: each raises,
naming ROADMAP.md Queue 1, item 9."""
from __future__ import annotations

from .optimizer import Optimizer


def _not_ported(name):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"optimizer.{name} is not ported yet (ROADMAP.md Queue 1, "
            f"item 9)")
    return type(name, (Optimizer,), {"__init__": __init__})


Adamax = _not_ported("Adamax")
NAdam = _not_ported("NAdam")
RAdam = _not_ported("RAdam")
Adadelta = _not_ported("Adadelta")
Rprop = _not_ported("Rprop")
ASGD = _not_ported("ASGD")
