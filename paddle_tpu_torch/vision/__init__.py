"""Vision models of the port.  Counterpart of ``paddle_tpu/vision`` for
the ResNet family (``models``); the rest of the zoo, ``transforms``,
``datasets`` and ``ops`` are not ported yet (ROADMAP.md Queue 1,
item 4)."""
from . import models  # noqa: F401
