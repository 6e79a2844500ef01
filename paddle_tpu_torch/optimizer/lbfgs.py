"""``LBFGS`` (``paddle_tpu/optimizer/lbfgs.py``) is not ported yet: it
raises, naming ROADMAP.md Queue 1, item 9."""
from __future__ import annotations

from .extra import _not_ported

LBFGS = _not_ported("LBFGS")
