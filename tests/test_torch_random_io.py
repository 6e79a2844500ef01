"""The port's random ops (``paddle_tpu_torch/ops/random.py``) and
``paddle.save`` / ``paddle.load`` (``framework_io.py``) against
``paddle_tpu``'s on the CPU.

JAX's threefry stream is not Philox, so random parity is: the result
shapes and dtypes of every draw equal the reference's
(``jax.eval_shape`` of the reference's call, which draws nothing), the
values lie in the stated range, draws repeat under ``seed`` and under
``set_rng_state(get_rng_state())``, and moments at 2^16 samples fall
within 6 standard errors.  Saved files cross between the two packages in
both directions with equal values and dtypes, bfloat16 included.
"""
import os

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import random as prandom


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


P = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.25, 0.25]], np.float32)

# name: the draw, on either package
DRAWS = {
    "rand": lambda m: m.rand([3, 4]),
    "rand[bf16]": lambda m: m.rand([5], "bfloat16"),
    "randn": lambda m: m.randn([2, 3]),
    "randn[f64]": lambda m: m.randn([4], "float64"),
    "standard_normal": lambda m: m.standard_normal([3]),
    "uniform": lambda m: m.uniform([6], min=2.0, max=5.0),
    "randint": lambda m: m.randint(2, 9, [4, 5]),
    "randint[one]": lambda m: m.randint(7, shape=[3]),
    "randint[i32]": lambda m: m.randint(0, 5, [3], "int32"),
    "randint_like": lambda m: m.randint_like(m.zeros([2, 3], "int32"), 0, 4),
    "randperm": lambda m: m.randperm(10),
    "normal": lambda m: m.normal(1.0, 2.0, [3, 2]),
    "normal[tensor]": lambda m: m.normal(m.zeros([3]), m.ones([2, 1])),
    "gaussian": lambda m: m.gaussian([4], 1.0, 0.5),
    "bernoulli": lambda m: m.bernoulli(m.full([8], 0.3)),
    "multinomial": lambda m: m.multinomial(m.to_tensor(P), 2),
    "multinomial[repl]": lambda m: m.multinomial(m.to_tensor(P[0]), 5, True),
    "poisson": lambda m: m.poisson(m.full([6], 3.0)),
    "standard_gamma": lambda m: m.standard_gamma(m.full([5], 2.0)),
    "binomial": lambda m: m.binomial(m.full([5], 10.0), m.full([5], 0.3)),
    "log_normal": lambda m: m.log_normal(0.0, 0.5, [4]),
    "normal_": lambda m: m.normal_(m.zeros([3])),
    "uniform_": lambda m: m.uniform_(m.zeros([3], "float64"), 1.0, 2.0),
    "exponential_": lambda m: m.exponential_(m.zeros([4]), 2.0),
    "bernoulli_": lambda m: m.bernoulli_(m.zeros([4]), 0.5),
    "cauchy_": lambda m: m.cauchy_(m.zeros([4])),
    "geometric_": lambda m: m.geometric_(m.zeros([4]), 0.3),
    "log_normal_": lambda m: m.log_normal_(m.zeros([4])),
}

RANGES = {
    "rand": (0.0, 1.0), "rand[bf16]": (0.0, 1.0), "uniform": (2.0, 5.0),
    "randint": (2, 8), "randint[one]": (0, 6), "randint[i32]": (0, 4),
    "randint_like": (0, 3), "randperm": (0, 9), "bernoulli": (0, 1),
    "multinomial": (0, 3), "multinomial[repl]": (0, 3), "poisson": (0, None),
    "standard_gamma": (0, None), "binomial": (0, 10), "log_normal": (0, None),
    "uniform_": (1.0, 2.0), "exponential_": (0, None), "bernoulli_": (0, 1),
    "geometric_": (1, None), "log_normal_": (0, None),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_shape_dtype_range(name):
    # the reference's key made eagerly: one first made under the trace
    # would leak into its generator
    ref.get_rng_state()
    want = jax.eval_shape(lambda: DRAWS[name](ref)._data)
    got = DRAWS[name](paddle)
    assert tuple(got.shape) == tuple(want.shape), name
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
    lo, hi = RANGES.get(name, (None, None))
    v = got.double()
    if lo is not None:
        assert float(v.min()) >= lo, name
    if hi is not None:
        assert float(v.max()) <= hi, name
    if name == "randperm":
        assert sorted(got.tolist()) == list(range(10))
    if name == "multinomial":
        assert all(len(set(r)) == 2 for r in got.tolist())
        assert 1 not in got[1].tolist()   # a zero-probability category


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_seed_and_state_replay(name):
    """``seed`` repeats a draw; ``set_rng_state(get_rng_state())``
    replays it; a different seed gives other values."""
    paddle.seed(1234)
    a = DRAWS[name](paddle)
    paddle.seed(1234)
    b = DRAWS[name](paddle)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    state = paddle.get_rng_state()
    c = DRAWS[name](paddle)
    paddle.set_rng_state(state)
    d = DRAWS[name](paddle)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


def test_generators_are_the_modules_own():
    """Draws come from the module's generator, never from torch's global
    one: reseeding torch leaves them alone."""
    paddle.seed(5)
    a = paddle.rand([4])
    paddle.seed(5)
    torch.manual_seed(99)
    b = paddle.rand([4])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert prandom.generator("cpu") is prandom.generator(torch.device("cpu"))
    paddle.seed(6)
    assert not torch.equal(paddle.rand([4]), a)


@pytest.mark.parametrize("name", ["rand", "randn", "randint"])
def test_moments(name):
    """Mean and variance at 2^16 samples within 6 standard errors."""
    n = 1 << 16
    paddle.seed(0)
    if name == "rand":
        v, mu, var = paddle.rand([n]).double(), 0.5, 1 / 12
    elif name == "randn":
        v, mu, var = paddle.randn([n]).double(), 0.0, 1.0
    else:
        v = paddle.randint(-3, 7, [n]).double()
        mu, var = 1.5, (10 ** 2 - 1) / 12
    se = np.sqrt(var / n)
    assert abs(float(v.mean()) - mu) < 6 * se
    assert abs(float(v.var()) - var) < 6 * var * np.sqrt(2 / n) * 1.5


# -- save / load ---------------------------------------------------------------------

def _tree(m, bf16):
    """The same state on either package: float32, int64, bool, bfloat16,
    nested containers and plain Python values."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    t = {"w": m.to_tensor(w), "step": m.to_tensor(np.arange(5)),
         "mask": m.to_tensor(np.array([True, False])),
         "nested": [m.to_tensor(w[0]), {"lr": 0.1, "name": "adam"}],
         "tuple": (1, 2.5)}
    if bf16:
        t["h"] = m.cast(m.to_tensor(w), "bfloat16")
    return t


def _values(obj):
    """Leaves as (dtype name, float64 values) pairs, containers kept."""
    if isinstance(obj, dict):
        return {k: _values(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_values(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return (str(obj.dtype).replace("torch.", ""),
                obj.double().numpy().tolist())
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.astype(np.float64).tolist())
    return obj


def test_port_file_loads_in_reference(tmp_path):
    path = os.path.join(tmp_path, "sub", "state.pdparams")
    paddle.save(_tree(paddle, True), path)
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".tmp." in f]
    got = ref.load(path)
    want = _tree(ref, True)
    want = {k: (np.asarray(v._data) if hasattr(v, "_data") else v)
            for k, v in want.items()}
    want["nested"] = [np.asarray(want["nested"][0]._data),
                      want["nested"][1]]
    assert _values(got) == _values(want)


def test_reference_file_loads_in_port(tmp_path):
    path = os.path.join(tmp_path, "state.pdparams")
    ref.save(_tree(ref, True), path)
    got = paddle.load(path)
    assert _values(got) == _values(_tree(paddle, True))
    assert got["h"].dtype == torch.bfloat16
    assert got["w"].device.type == "cpu"


def test_port_roundtrip_bit_for_bit(tmp_path):
    path = os.path.join(tmp_path, "state.pd")
    src = _tree(paddle, True)
    src["f8"] = paddle.cast(src["w"], "float8_e4m3fn")
    paddle.save(src, path)
    got = paddle.load(path)
    for k in ("w", "step", "mask", "h", "f8"):
        assert got[k].dtype == src[k].dtype
        assert torch.equal(got[k].view(torch.uint8), src[k].view(torch.uint8))
    assert got["nested"][1] == {"lr": 0.1, "name": "adam"}
    assert got["tuple"] == (1, 2.5)


def test_load_places_on_current_place(tmp_path):
    """``load`` puts tensors on the current place; with no card and the
    place left at CUDA it raises rather than dropping to the CPU."""
    path = os.path.join(tmp_path, "x.pd")
    paddle.save({"x": paddle.ones([2])}, path)
    paddle.set_device("gpu:0")
    if torch.cuda.is_available():
        assert paddle.load(path)["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paddle.load(path)
    paddle.set_device("cpu")
    assert paddle.load(path)["x"].device.type == "cpu"
