"""Vision of the port.  Counterpart of ``paddle_tpu/vision``: the model
zoo (``models``, every family the reference exports).  ``transforms``,
``datasets`` and ``ops`` (nms, roi_align, deform_conv, ...) are not
ported yet (ROADMAP.md Queue 1, item 4)."""
from . import models  # noqa: F401
