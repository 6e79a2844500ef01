"""Vision of the port.  Counterpart of ``paddle_tpu/vision``: the model
zoo (``models``, every family the reference exports), the detection ops
(``ops``: nms, roi_align, yolo_box, deform_conv2d, ...), the host-side
``transforms`` and the local-file ``datasets``."""
from . import datasets, models, ops, transforms  # noqa: F401
