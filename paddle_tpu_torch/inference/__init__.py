"""Inference predictor and the serving exports.

Counterpart of ``paddle_tpu/inference/__init__.py`` (Paddle's
``paddle.inference``: ``Config``, ``create_predictor``, the handle
workflow of ``paddle_inference_api.h:81``).  Where the reference's
predictor compiles a live Layer's forward with ``jax.jit`` over its
parameter pytree, this one runs a live ``nn.Module``'s forward eagerly:
with its own parameters as they are, or, when a ``Config`` asks for a
device or a low precision, through ``torch.func.functional_call`` over a
placed or cast copy of them.

Not ported (ROADMAP.md Queue 1, item 9): a predictor loaded from a saved
program (``Config(model_path)``, which needs ``jit.save`` / ``jit.load``)
and ``convert_to_mixed_precision``, which rewrites such a file; both
raise ``NotImplementedError``.
"""
from __future__ import annotations

import inspect
import logging

import numpy as np
import torch

_ITEM_9 = "ROADMAP.md Queue 1, item 9"


class Config:
    """The predictor's knobs (Paddle's ``paddle.inference.Config``).

    The device defaults to the card (``cuda:0``); ``enable_use_gpu(...,
    device_id)`` names ``cuda:<device_id>``, ``disable_gpu()`` the CPU.
    ``model_path`` is recorded, but a predictor built from it needs
    ``jit.load`` (see the module's docstring)."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        if params_path is not None and params_path != model_path:
            # the reference saves program and weights in one file
            raise NotImplementedError(
                "paddle_tpu saves program and weights in a single "
                f"'<prefix>.pdparams' file; pass that prefix as model_path "
                f"(got params_path={params_path!r})")
        self._device = None

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       *a, **k):
        """Run on ``cuda:<device_id>`` (Paddle's Config::EnableUseGpu);
        the memory pool size is the caching allocator's business."""
        self._device = ("gpu", int(device_id))

    def disable_gpu(self):
        self._device = ("cpu", 0)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_threads = int(n)

    # -- analysis / optimization knobs: recorded; the ones that have a
    # counterpart here steer it

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def enable_memory_optim(self, flag=True):
        """Recorded only: the reference donates run()'s input buffers to
        XLA; eager PyTorch frees intermediates as it goes and has no
        buffer to donate."""
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self):
        return getattr(self, "_memory_optim", False)

    def enable_mkldnn(self):
        pass  # an x86 backend knob with nothing to steer here

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError(
            "TensorRT is not bound by this port: precision is controlled "
            "via enable_low_precision()")

    def enable_low_precision(self, dtype="bfloat16"):
        """Serve in ``dtype``: the predictor runs over a copy of the
        module's floating parameters and buffers cast to it."""
        self._low_precision = str(dtype)

    def switch_use_feed_fetch_ops(self, flag=False):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    def set_optim_cache_dir(self, path):
        """Recorded only: the reference points JAX's persistent
        compilation cache there; eager PyTorch compiles nothing."""
        self._optim_cache_dir = str(path)

    def use_gpu(self):
        return self.device().type == "cuda"

    def gpu_device_id(self):
        d = self._device
        return d[1] if d else 0

    def device(self) -> torch.device:
        """The device the knobs name: ``cuda:<id>`` unless
        ``disable_gpu()``."""
        kind, idx = self._device or ("gpu", 0)
        return torch.device("cpu") if kind == "cpu" \
            else torch.device("cuda", idx)

    def disable_glog_info(self):
        logging.getLogger("torch").setLevel(logging.ERROR)
        self._glog_disabled = True

    def glog_info_disabled(self):
        return getattr(self, "_glog_disabled", False)

    def enable_profile(self):
        self._profile = True

    def pass_builder(self):
        """No pass pipeline here; a recorder, so tooling that deletes
        passes keeps working."""
        cfg = self

        class _PassBuilder:
            def all_passes(self):
                return []

            def delete_pass(self, name):
                cfg._deleted_passes = getattr(cfg, "_deleted_passes",
                                              set()) | {name}

        return _PassBuilder()

    def exp_disable_tensorrt_ops(self, ops):
        pass  # no TensorRT here

    def set_model(self, model_path, params_path=None):
        self.model_path = model_path

    def model_dir(self):
        return self.model_path

    def summary(self):
        rows = [("model_path", str(self.model_path)),
                ("device", str(self.device())),
                ("ir_optim", str(getattr(self, "_ir_optim", True))),
                ("memory_optim",
                 str(getattr(self, "_memory_optim", False))),
                ("low_precision",
                 str(getattr(self, "_low_precision", None)))]
        w = max(len(k) for k, _ in rows) + 2
        return "\n".join(f"{k:<{w}}{v}" for k, v in rows)


class DataType:
    """Paddle's ``paddle_infer.DataType``."""

    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT64 = "int64"
    INT32 = "int32"
    INT8 = "int8"
    UINT8 = "uint8"
    BOOL = "bool"


class PrecisionType:
    """Paddle's ``paddle_infer.PrecisionType``."""

    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class PlaceType:
    """Paddle's ``paddle_infer.PlaceType``."""

    CPU = "cpu"
    GPU = "gpu"
    XPU = "xpu"
    CUSTOM = "custom"
    UNK = "unk"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 (which numpy has no type for) widened exactly
    to fp32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Tensor:
    """The feed / fetch handle of the handle workflow (Paddle's
    ``paddle_infer.Tensor``)."""

    def __init__(self, name=""):
        self.name = name
        self._data = None

    def copy_from_cpu(self, data):
        self._data = torch.from_numpy(np.array(data))

    def share_external_data(self, data):
        """Adopt ``data`` without a copy (a tensor stays where it
        lies)."""
        self._data = data if isinstance(data, torch.Tensor) \
            else torch.from_numpy(np.asarray(data))

    def copy_to_cpu(self):
        return _to_numpy(self._data)

    def reshape(self, shape):
        if self._data is not None:
            self._data = self._data.reshape(tuple(shape))

    def shape(self):
        return list(self._data.shape) if self._data is not None else []

    def type(self):
        return _dtype_name(self._data.dtype) if self._data is not None \
            else None


class Predictor:
    """A predictor over a live ``nn.Module``::

        predictor = Predictor(module)            # or create_predictor
        out = predictor.run([np_array, ...])     # -> [np_array, ...]

    and the handle workflow (``paddle_inference_api.h:81``)::

        h = predictor.get_input_handle(name); h.copy_from_cpu(x)
        predictor.run()
        out = predictor.get_output_handle(
            predictor.get_output_names()[0]).copy_to_cpu()

    Without ``config`` the forward runs on the module's own parameters
    where they lie.  With one, the parameters and buffers are placed on
    ``config.device()`` and, under ``enable_low_precision``, cast (their
    floating ones) to its dtype: a copy wherever either differs, taken
    once, and the forward runs through ``torch.func.functional_call``
    over it.  Inputs go to the parameters' device; outputs come back as
    numpy (bf16 widened to fp32).  The module is put in eval mode.

    A ``Config`` as the source needs ``jit.load`` and raises
    ``NotImplementedError`` (ROADMAP.md Queue 1, item 9)."""

    def __init__(self, source, model_builder=None, config=None):
        if isinstance(source, Config):
            raise NotImplementedError(
                "a predictor loaded from a saved program (Config("
                f"model_path={source.model_path!r})) needs jit.save / "
                f"jit.load, not ported ({_ITEM_9}); pass the live module: "
                "Predictor(module, config=config)")
        if not isinstance(source, torch.nn.Module):
            raise TypeError(f"Predictor expects Config or nn.Module, got "
                            f"{type(source)}")
        self.layer = source
        self._config = config
        self.layer.eval()
        self._params = None
        self._input_handles = {}
        self._output_handles = {}
        self._output_names = []

    def _build(self):
        named = {**dict(self.layer.named_parameters()),
                 **dict(self.layer.named_buffers())}
        cfg = self._config
        if cfg is None:
            self._params = {}
            first = next(iter(named.values()), None)
            self._device = (first.device if first is not None
                            else torch.device("cpu"))
            return
        dev = cfg.device()
        lp = getattr(cfg, "_low_precision", None)
        lp = getattr(torch, lp) if lp else None

        def place(t):
            t = t.detach().to(dev)
            return t.to(lp) if lp is not None and t.is_floating_point() \
                else t

        self._params = {k: place(v) for k, v in named.items()}
        self._device = dev

    def get_input_names(self):
        sig = inspect.signature(self.layer.forward)
        return [p for p in sig.parameters if p != "self"]

    # -- handle workflow ------------------------------------------------

    def get_input_handle(self, name):
        return self._input_handles.setdefault(name, Tensor(name))

    def get_output_names(self):
        if not self._output_names:
            # one generic slot per output; populated after the first run
            return ["output_0"]
        return list(self._output_names)

    def get_output_handle(self, name):
        return self._output_handles.setdefault(name, Tensor(name))

    def _run_handles(self):
        names = self.get_input_names()
        ins = []
        for n in names:
            h = self._input_handles.get(n)
            if h is None or h._data is None:
                raise ValueError(
                    f"input handle {n!r} not fed — call "
                    "get_input_handle(name).copy_from_cpu(data) first")
            ins.append(h._data)
        outs = self._execute(ins)
        self._output_names = [f"output_{i}" for i in range(len(outs))]
        for i, o in enumerate(outs):
            self.get_output_handle(self._output_names[i])._data = o
        return True

    @torch.no_grad()
    def _execute(self, ins):
        if self._params is None:
            self._build()
        ins = [(i if isinstance(i, torch.Tensor)
                else torch.from_numpy(np.asarray(i))).to(self._device)
               for i in ins]
        if self._params:
            out = torch.func.functional_call(self.layer, self._params,
                                             tuple(ins))
        else:
            out = self.layer(*ins)
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def run(self, inputs=None):
        """List style: ``run([x, ...])`` -> ``[np, ...]``.  Handle style:
        feed through ``get_input_handle``, call ``run()`` with no
        argument, fetch through ``get_output_handle``."""
        if inputs is None:
            return self._run_handles()
        return [_to_numpy(o) for o in self._execute(list(inputs))]


def create_predictor(source, model_builder=None, config=None):
    """``Predictor(source, model_builder, config)``: a live module, or a
    ``Config`` (which raises, see :class:`Predictor`)."""
    return Predictor(source, model_builder=model_builder, config=config)


class PredictorPool:
    """``size`` predictors over one source (Paddle's
    ``paddle_infer.PredictorPool``): over a live module they share its
    parameters (with a ``config``, each holds its own placed copy)."""

    def __init__(self, source, size=1, model_builder=None, config=None):
        self._predictors = [Predictor(source, model_builder, config=config)
                            for _ in range(int(size))]

    def retrieve(self, idx):
        return self._predictors[idx]


class XpuConfig:
    """Signature parity for XPU binding (no XPU here; the attributes
    are recorded)."""

    def __init__(self):
        self.device_id = 0
        self.l3_size = 0
        self.conv_autotune_level = 0


def get_version():
    from .. import __version__

    return f"paddle_tpu_torch {__version__} (PyTorch inference)"


def get_num_bytes_of_data_type(dtype):
    """Bytes an element of ``dtype`` (a name such as ``"bfloat16"`` or a
    ``torch.dtype``)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty((), dtype=dt).element_size()


def get_trt_compile_version():
    return (0, 0, 0)  # no TensorRT here


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name):
    """The reference maps fluid op names to phi kernel names; there is
    no such table here, so a name is its own."""
    return op_name


def convert_to_mixed_precision(model_file, params_file=None,
                               mixed_model_file=None,
                               mixed_precision="bfloat16", backend=None,
                               keep_io_types=True, black_list=None,
                               model_builder=None, **kwargs):
    """Rewrites a saved program at a mixed precision in the reference;
    the saved program needs ``jit.save`` / ``jit.load``: not ported."""
    raise NotImplementedError(
        f"convert_to_mixed_precision rewrites a jit.save file, not ported "
        f"({_ITEM_9}); a live module serves in low precision through "
        "Predictor(module, config) with config.enable_low_precision()")


from .paged import (  # noqa: F401,E402
    PagedKVCache, masked_multihead_attention, paged_decode_attention,
)
from .serving import PagedLlamaEngine  # noqa: F401,E402
from .server import (  # noqa: F401,E402
    PagedExecutor, RequestHandle, RequestState, ServingEngine,
)
