"""``auto_cast`` and ``decorate``.  Counterpart of
``paddle_tpu/amp/auto_cast.py``: level O1 casts the white-list ops to the
low dtype and the black-list ops to fp32; O2 casts every op outside the
black list to the low dtype (plain arithmetic, reshapes and concats
included).  ``decorate(level="O2")`` casts the model's parameters to
the low dtype, keeps the norm layers' in fp32 and turns on the
optimizers' master weights.

``auto_cast`` sets the state and puts the op registry's ``DispatchMode``
on the stack for the torch functions between the port's named ops (see
``amp/state.py``).  This is
not ``torch.autocast``: its lists differ and it has no O2.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from .state import amp_state, to_dtype


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    st = amp_state()
    prev = (st.enabled, st.level, st.dtype, set(st.custom_white),
            set(st.custom_black))
    st.enabled = bool(enable)
    st.level = level
    st.dtype = dtype
    if custom_white_list:
        st.custom_white = set(custom_white_list)
    if custom_black_list:
        st.custom_black = set(custom_black_list)
    from ..ops import registry

    registry.acquire_mode()
    try:
        yield
    finally:
        registry.release_mode()
        (st.enabled, st.level, st.dtype, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def _norm_layer_types():
    from ..nn.norm import GroupNorm, LayerNorm, RMSNorm, _BatchNormBase

    return (_BatchNormBase, LayerNorm, GroupNorm, RMSNorm)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: every floating parameter of each model, outside the norm
    layers (and ``excluded_layers``), is cast to ``dtype`` in place (the
    ``Parameter`` objects stay, so optimizers built on them see the
    cast); the optimizers get master weights unless ``master_weight`` is
    False."""
    low = to_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)

    if level == "O2":
        norm_types = _norm_layer_types()
        for model in model_list:
            for layer in model.modules():
                if excluded_layers and isinstance(
                        layer, tuple(excluded_layers)):
                    continue
                if isinstance(layer, norm_types):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        with torch.no_grad():
                            p.data = p.data.to(low)

    if optimizers is None:
        return models if single_model else model_list
    if master_weight is not False:
        opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
            else [optimizers]
        for opt in opt_list:
            opt._use_master_weights = True
    return (models if single_model else model_list), optimizers
