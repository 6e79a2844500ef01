"""The port's ``paddle.*`` namespace (``paddle_tpu_torch/__init__.py``):
coverage of ``paddle``'s declared list (``tests/data/reference_api.json``,
read only), the Tensor-method binding, dtypes and places, ``to_tensor``'s
dtype rules, ``_misc_api`` and the import's weight, against
``paddle_tpu`` on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import dtype as pdt
from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.core.tensor_method_table import (
    TENSOR_METHOD_FUNC, TORCH_MEANING_DIFFERS)
from paddle_tpu_torch.device import resolve_device

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _restore_place():
    prev = paddle.get_device()
    yield
    paddle.set_device(prev)


def _declared():
    with open(os.path.join(HERE, "data", "reference_api.json")) as f:
        return json.load(f)["paddle"]


# The declared names the port does not have yet, each with the ROADMAP
# Queue 1 item that ports it.
_ITEM_9C = (
    # ops/extra.py
    "angle as_strided atleast_1d atleast_2d atleast_3d bucketize cdist "
    "column_stack combinations conj copysign cumulative_trapezoid deg2rad "
    "diagflat diagonal_scatter diff dsplit dstack gammainc gammaincc gammaln "
    "heaviside hsplit hypot i0e i1 i1e imag index_add index_fill index_put "
    "index_put_ index_sample isin isneginf isposinf isreal kron kthvalue "
    "ldexp logcumsumexp logit masked_scatter mode multigammaln mv nanmedian "
    "nanquantile nextafter pdist polar polygamma rad2deg real renorm reverse "
    "rot90 round row_stack scatter_nd searchsorted select_scatter sgn "
    "shard_index signbit sinc slice_scatter take tensor_split tensordot "
    "trace trapezoid tril_indices triu_indices unflatten unfold vander "
    "vsplit "
    # ops/tail.py
    "add_n bitwise_left_shift bitwise_right_shift block_diag cartesian_prod "
    "crop frexp histogramdd hstack is_empty is_integer multiplex reduce_as "
    "shape strided_slice view_as vstack "
    # ops/linalg.py, but matmul
    "addmm bincount bmm cross dist dot einsum histogram inner mm outer "
    # in-place variants of those families
    "addmm_ bitwise_left_shift_ bitwise_right_shift_ copysign_ gammainc_ "
    "gammaincc_ gammaln_ hypot_ index_add_ index_fill_ ldexp_ logit_ "
    "masked_scatter_ multigammaln_ polygamma_ renorm_ sinc_ "
    # autograd/ (its grad-mode names are ported)
    "grad").split()
ABSENT = {**{n: "item 9c" for n in _ITEM_9C},
          "flops": "item 9e", "Model": "item 9e", "summary": "item 9e",
          "DataParallel": "item 8"}


def test_declared_names_exist_or_are_mapped():
    """Every declared name exists, except the 128 mapped to the ROADMAP
    item that ports them; a mapped name that now exists fails (stale)."""
    names = _declared()
    assert len(names) == 421
    assert set(ABSENT) <= set(names)
    stale = sorted(n for n in ABSENT if hasattr(paddle, n))
    assert not stale, f"ported now, drop from ABSENT: {stale}"
    missing = sorted(n for n in names if n not in ABSENT
                     and not hasattr(paddle, n))
    assert not missing, missing
    assert len(ABSENT) == 128 and len(names) - len(ABSENT) == 293
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        roadmap = f.read().lower()
    for item in set(ABSENT.values()):
        assert f"{item}:" in roadmap or f"{item} " in roadmap, item


def test_item_9a_names_come_from_the_port():
    """The ported names are the port's own objects, not the reference's
    (nothing of ``paddle_tpu`` is reachable through them)."""
    for n in _declared():
        if n in ABSENT:
            continue
        obj = getattr(paddle, n)
        mod = getattr(obj, "__module__", "") or ""
        assert not mod.startswith(("paddle_tpu.", "jax")), (n, mod)


#: public names of the port's namespace that ``paddle_tpu``'s lacks
PORT_ONLY = {"BOUND_TENSOR_METHODS", "resolve_device"}


def test_namespace_exports_nothing_extra():
    """``from .ops import *`` exports the op names the reference's
    namespace has, none of the ops package's internals (submodules, the
    kernel wrapper ``grouped_ffn``, ``random.shuffle``), and the port's
    top level holds no public name the reference's lacks but
    :data:`PORT_ONLY`."""
    import types

    from paddle_tpu_torch import ops

    ref_names = set(dir(ref))
    assert not set(ops.__all__) - ref_names
    for n in ("grouped_ffn", "shuffle", "math_ops", "activation_ops",
              "annotations"):
        assert n not in ops.__all__, n
    extra = {n for n in dir(paddle) if not n.startswith("_")
             and not isinstance(getattr(paddle, n), types.ModuleType)
             and n != "annotations"} - ref_names
    assert extra == PORT_ONLY


@pytest.fixture(scope="module")
def fresh_import():
    """What a fresh process sees around ``import paddle_tpu_torch``: the
    ``torch.Tensor`` attributes it replaced, the names it bound that
    torch had, the bound names, and the modules of ``jax``,
    ``paddle_tpu`` and ``triton`` it pulled in."""
    code = (
        "import torch, json, sys\n"
        "base = {k: id(v) for k, v in vars(torch.Tensor).items()}\n"
        "tb = {k: id(v) for k, v in vars(torch._C.TensorBase).items()}\n"
        "had = set(dir(torch.Tensor))\n"
        "import paddle_tpu_torch as p\n"
        "after = vars(torch.Tensor)\n"
        "changed = [k for k, v in base.items() if id(after.get(k)) != v]\n"
        "changed += [k for k, v in tb.items()\n"
        "            if id(vars(torch._C.TensorBase).get(k)) != v]\n"
        "heavy = [m for m in sys.modules if m.split('.')[0] in\n"
        "         ('jax', 'jaxlib', 'paddle_tpu', 'triton')]\n"
        "print(json.dumps({'changed': changed,\n"
        "  'rebound': sorted(set(p.BOUND_TENSOR_METHODS) & had),\n"
        "  'bound': p.BOUND_TENSOR_METHODS, 'heavy': heavy}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_method_table_binds_only_absent_names(fresh_import):
    """No attribute ``torch.Tensor`` had before the import is replaced,
    and every bound name was absent."""
    res = fresh_import
    assert res["changed"] == [] and res["rebound"] == []
    for n in ("cast", "concat", "equal_all", "scale", "stop_gradient",
              "astype", "place", "reshape_", "where_"):
        assert n in res["bound"], n
    table_bound = [n for n in res["bound"] if n in TENSOR_METHOD_FUNC]
    assert all(callable(getattr(paddle, n)) for n in table_bound)


PINNED_DIFFERS = {
    "signature": "chunk flatten gather index_select prod quantile scatter "
                 "scatter_ split t t_ transpose unsqueeze view where",
    "result": "allclose argsort cummax cummin cumprod cumsum equal "
              "logsumexp max median min nonzero numel sort topk unique",
    "generator": "bernoulli_ cauchy_ exponential_ geometric_ log_normal_ "
                 "multinomial normal_ uniform_",
}


def test_torch_meaning_differs_list_is_pinned():
    """The names whose torch method keeps torch's meaning while the flat
    function means Paddle's: torch has each, the port did not rebind it,
    and the flat function exists."""
    got = {}
    for n, kind in TORCH_MEANING_DIFFERS.items():
        got.setdefault(kind, []).append(n)
    for kind, names in PINNED_DIFFERS.items():
        assert sorted(got[kind]) == sorted(names.split()), kind
    assert len(got["dtype"]) == 50 and len(got["in place"]) == 62
    for n in TORCH_MEANING_DIFFERS:
        assert n not in paddle.BOUND_TENSOR_METHODS
        assert callable(getattr(paddle, n)), n
    x = torch.arange(12.0).reshape(3, 4)
    assert isinstance(x.max(1), tuple) and not isinstance(
        paddle.max(x, 1), tuple)
    assert tuple(paddle.transpose(x, [1, 0]).shape) == (4, 3)
    assert len(x.split(2)) == 2 and len(paddle.split(x, 2, 1)) == 2
    assert x.view(torch.int32).dtype == torch.int32
    assert torch.equal(paddle.view(x, "int32"), x.to(torch.int32))
    assert x.add_(1).dtype == torch.float32


def test_dtypes_map_onto_torch():
    names = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
             "bfloat16", "float32", "float64", "complex64", "complex128",
             "float8_e4m3fn", "float8_e5m2"]
    for n in names:
        d = getattr(paddle, n)
        assert isinstance(d, torch.dtype) and isinstance(d, paddle.dtype)
        assert pdt.dtype_name(d) == str(getattr(ref, n)) == n
        assert pdt.dtype_name(n) == ref.core.dtype.dtype_name(n)
        for f in ("is_floating_point", "is_integer", "is_complex"):
            assert getattr(pdt, f)(n) == getattr(ref.core.dtype, f)(n), (n, f)
    assert paddle.bool8 is torch.bool and paddle.Tensor is torch.Tensor
    for alias in ("fp16", "bf16", "fp32", "fp64"):
        assert pdt.dtype_name(alias) == ref.core.dtype.dtype_name(alias)
    for spec in (np.float32, np.dtype("int16"), float, int, bool):
        assert pdt.dtype_name(spec) == ref.core.dtype.dtype_name(spec)
    assert paddle.get_default_dtype() is torch.float32
    paddle.set_default_dtype("float64")
    try:
        assert paddle.get_default_dtype() is torch.float64
        with pytest.raises(TypeError):
            paddle.set_default_dtype("int32")
    finally:
        paddle.set_default_dtype("float32")


def test_places():
    """Places and their torch devices; the deliberate differences from
    the reference: CUDA is the accelerator, the start place is
    ``gpu:0`` whatever the machine, ``is_compiled_with_cuda`` is true."""
    assert paddle.get_device() == "gpu:0" and ref.get_device() == "cpu:0"
    assert paddle.is_compiled_with_cuda() and not ref.is_compiled_with_cuda()
    assert paddle.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    assert paddle.TPUPlace is paddle.CUDAPlace
    assert paddle.XPUPlace is paddle.CUDAPlace
    assert paddle.CUDAPinnedPlace is paddle.CPUPlace
    assert paddle.CPUPlace(0) == paddle.CPUPlace(0) != paddle.CUDAPlace(0)
    for name, want in [("cpu", "cpu:0"), ("gpu:1", "gpu:1"),
                       ("cuda", "gpu:0"), ("tpu", "gpu:0")]:
        paddle.set_device(name)
        assert paddle.get_device() == want
    assert paddle.device_count() == torch.cuda.device_count()
    with pytest.raises(ValueError):
        pplace.CustomPlace("npu", 0).torch_device()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_cpu_fallback():
    """With no card a tensor made without a place raises (the current
    place stays CUDA), and ``resolve_device(None)`` follows
    ``set_device``; ``place="cpu"`` and ``set_device("cpu")`` run."""
    for make in (lambda: paddle.ones([2]), lambda: paddle.to_tensor([1.0]),
                 lambda: paddle.rand([2]), lambda: paddle.arange(3),
                 lambda: paddle.create_parameter([2, 2], "float32")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert paddle.to_tensor([1.0], place="cpu").device.type == "cpu"
    assert paddle.to_tensor([1.0], place=paddle.CPUPlace()).place \
        == paddle.CPUPlace(0)
    paddle.set_device("cpu")
    assert resolve_device(None) == torch.device("cpu")
    assert paddle.ones([2]).device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


TO_TENSOR = {
    "pyfloat": (2.5, None), "pyint": (3, None), "pybool": (True, None),
    "int_list": ([1, 2], None), "float_list": ([[1.0, 2.0]], None),
    "bool_list": ([True, False], None), "mixed_list": ([1, 2.5], None),
    "np_f64": (np.array([0.1, 0.2]), None),
    "np_f32": (np.array([0.1], np.float32), None),
    "np_i32": (np.array([1, 2], np.int32), None),
    "np_i64": (np.array([1, 2]), None), "np_u8": (np.array([7], np.uint8), None),
    "np_scalar_f32": (np.float32(1.5), None),
    "np_scalar_i32": (np.int32(4), None),
    "np_scalar_f64": (np.float64(1.5), None),
    "dtype_f64": ([1.0], "float64"), "dtype_i32": ([1.7], "int32"),
    "dtype_bf16": (np.array([0.1]), "bfloat16"),
    "dtype_obj": ([1], paddle.float16),
}


@pytest.mark.parametrize("default", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(TO_TENSOR))
def test_to_tensor_dtype_rules(case, default):
    """``to_tensor``'s dtype and values as the reference's, under either
    default dtype: Python floats and float64 numpy arrays take the
    default, Python ints give int64."""
    data, dtype = TO_TENSOR[case]
    ref_dtype = dtype if not isinstance(dtype, torch.dtype) \
        else pdt.dtype_name(dtype)
    ref.set_default_dtype(default)
    paddle.set_default_dtype(default)
    try:
        want = np.asarray(ref.to_tensor(data, dtype=ref_dtype)._data)
        got = paddle.to_tensor(data, dtype=dtype, place="cpu")
    finally:
        ref.set_default_dtype("float32")
        paddle.set_default_dtype("float32")
    assert pdt.dtype_name(got.dtype) == str(want.dtype), case
    np.testing.assert_array_equal(got.float().numpy() if got.dtype
                                  == torch.bfloat16 else got.numpy(),
                                  want.astype(np.float32) if want.dtype.name
                                  == "bfloat16" else want)


def test_to_tensor_of_tensor_and_parameters():
    x = torch.arange(3.0)
    y = paddle.to_tensor(x, dtype="float64", stop_gradient=False)
    assert y.dtype == torch.float64 and y.requires_grad and not y.stop_gradient
    assert y.data_ptr() != x.data_ptr()
    p = paddle.Parameter(torch.ones(2), name="w")
    assert isinstance(p, torch.nn.Parameter) and p.name == "w"
    assert p.persistable and p.trainable and not p.stop_gradient
    q = paddle.EagerParamBase(torch.ones(2), trainable=False)
    assert q.stop_gradient and q.optimize_attr == {"learning_rate": 1.0}
    z = torch.zeros(2)
    z.stop_gradient = False
    assert z.requires_grad
    z.set_value(np.array([1.0, 2.0]))
    assert z.tolist() == [1.0, 2.0] and z.dtype == torch.float32
    assert z.astype("int32").dtype == torch.int32
    assert z.place == paddle.CPUPlace(0)


def test_misc_api():
    paddle.set_device("cpu")
    for d in ("float32", "float16", "bfloat16", "float64"):
        a, b = paddle.finfo(d), ref.finfo(d)
        for k in ("min", "max", "bits", "eps", "tiny", "smallest_normal",
                  "resolution", "dtype"):
            assert getattr(a, k) == getattr(b, k), (d, k)
    for d in ("int8", "int32", "int64", "uint8"):
        a, b = paddle.iinfo(d), ref.iinfo(d)
        assert (a.min, a.max, a.bits, a.dtype) == (b.min, b.max, b.bits,
                                                   b.dtype)
    x = np.ones((2, 3), np.float32)
    assert paddle.is_tensor(paddle.to_tensor(x)) and not paddle.is_tensor(x)
    for f in ("is_floating_point", "is_complex"):
        for v in (x, x.astype(np.int32), x.astype(np.complex64)):
            assert getattr(paddle, f)(paddle.to_tensor(v)) == bool(
                getattr(ref, f)(ref.to_tensor(v)))
    assert int(paddle.rank(paddle.to_tensor(x))) == int(
        ref.rank(ref.to_tensor(x)).item())
    assert paddle.rank(paddle.to_tensor(x)).dtype == torch.int64
    outs = paddle.broadcast_tensors([paddle.to_tensor(x[:1]),
                                     paddle.to_tensor(x[:, :1])])
    assert [tuple(o.shape) for o in outs] == [(2, 3), (2, 3)]
    assert paddle.tolist(paddle.to_tensor(x)) == ref.tolist(ref.to_tensor(x))
    reader = paddle.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == list(ref.batch(lambda: iter(range(5)), 2)())
    assert list(paddle.batch(lambda: iter(range(5)), 2, True)()) == [
        [0, 1], [2, 3]]
    assert paddle.check_shape([2, 3])
    with pytest.raises(TypeError):
        paddle.check_shape([2.0])
    with paddle.LazyGuard():
        pass
    paddle.disable_signal_handler()
    assert paddle.in_dynamic_mode()
    p = paddle.create_parameter([4, 6], "float32")
    bound = np.sqrt(6.0 / 10)
    assert isinstance(p, paddle.Parameter) and not p.stop_gradient
    assert float(p.detach().abs().max()) <= bound
    assert float(paddle.create_parameter([3], "float32", is_bias=True)
                 .detach().abs().max()) == 0.0
    assert paddle.get_flags("FLAGS_use_fused_rms_norm") == {
        "FLAGS_use_fused_rms_norm": False}
    paddle.set_flags({"use_fused_rms_norm": True})
    try:
        assert paddle.get_flags(["use_fused_rms_norm"]) == {
            "use_fused_rms_norm": True}
    finally:
        paddle.set_flags({"use_fused_rms_norm": False})


def test_import_is_light(fresh_import):
    """``import paddle_tpu_torch`` pulls in no ``jax``, no ``paddle_tpu``
    and no ``triton``."""
    assert fresh_import["heavy"] == []


def test_grad_mode():
    """``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` /
    ``is_grad_enabled`` switch recording as the reference's do, as
    context managers and (``no_grad``) as a decorator."""
    for m in (paddle, ref):
        assert m.is_grad_enabled()
        with m.no_grad():
            assert not m.is_grad_enabled()
            with m.enable_grad():
                assert m.is_grad_enabled()
        with m.set_grad_enabled(False):
            assert not m.is_grad_enabled()
        assert m.no_grad()(lambda: m.is_grad_enabled())() is False
        assert m.is_grad_enabled()
    w = torch.ones(2, requires_grad=True)
    with paddle.no_grad():
        paddle.subtract_(w, paddle.to_tensor([0.5, 0.25], place="cpu"))
    assert w.tolist() == [0.5, 0.75] and w.is_leaf and w.requires_grad
