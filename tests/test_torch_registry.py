"""The port's flags, op registry, InferMeta validation and numeric
debugging (``paddle_tpu_torch/core/flags.py``, ``core/enforce.py``,
``ops/registry.py``, ``ops/infermeta.py``, ``amp/debugging.py``) against
``paddle_tpu`` on the CPU.

* Flags: the reference's table (names, types, defaults) and
  ``set_flags`` keeping each flag's type; fault 1: with
  ``FLAGS_check_nan_inf`` on, ``paddle.log(-1)`` raises
  ``FloatingPointError`` with the reference's message (level 1 prints).
* InferMeta: the reference's own catalogue (``tests/test_infermeta.py``,
  read as text, its ``paddle_tpu`` imports pointed at the port) runs
  against the port's public API, case by case; every validator call the
  port makes on the way is replayed through the reference's validator on
  the same metadata, and must pass or fail as the port's did, with the
  same message.  Nothing is compiled: validators read shapes and dtype
  names only.  Left out, with the reason: the traced-value case (the
  port has no ``paddle.jit``) and the in-place random fills called as
  Tensor methods (``x.cauchy_(loc=...)``: a torch method keeps torch's
  meaning, ``core/tensor_method_table.py``).
* Every op name with a validator reaches the port's dispatch.
* ``amp.debugging``: the operator-statistics table of the same model's
  forward, with and without O1, equals the reference's entry for entry;
  the tensor checker's op lists and levels.
"""
import contextlib
import inspect
import io
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.amp import debugging as rdebug
from paddle_tpu.core import flags as rflags
from paddle_tpu.ops import infermeta as rinfer
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import enforce
from paddle_tpu_torch.core import flags as pflags
from paddle_tpu_torch.ops import infermeta as pinfer
from paddle_tpu_torch.ops import registry

HERE = os.path.dirname(__file__)


@pytest.fixture(autouse=True)
def _cpu():
    prev = paddle.get_device()
    paddle.set_device("cpu")
    yield
    paddle.set_device(prev)


# -- flags ------------------------------------------------------------------------

def test_flag_table_matches_reference():
    """The same flags, types and defaults; the reference defines ten."""
    want = {k: (f.type, f.default) for k, f in rflags._registry.items()}
    got = {k: (f.type, f.default) for k, f in pflags._registry.items()}
    assert got == want and len(got) == 10
    assert paddle.get_flags(list(want)) == ref.get_flags(list(want))


def test_set_flags_keeps_types():
    keep = paddle.get_flags(["FLAGS_check_nan_inf_level",
                             "FLAGS_allocator_strategy", "FLAGS_benchmark"])
    try:
        paddle.set_flags({"FLAGS_check_nan_inf_level": "1",
                          "allocator_strategy": "naive_best_fit",
                          "FLAGS_benchmark": "true"})
        got = paddle.get_flags(["FLAGS_check_nan_inf_level",
                                "FLAGS_allocator_strategy",
                                "FLAGS_benchmark"])
        assert got == {"FLAGS_check_nan_inf_level": 1,
                       "FLAGS_allocator_strategy": "naive_best_fit",
                       "FLAGS_benchmark": True}
        paddle.set_flags({"FLAGS_check_nan_inf_level": 0.0})
        assert paddle.get_flags("FLAGS_check_nan_inf_level") == {
            "FLAGS_check_nan_inf_level": 0}
        with pytest.raises(ValueError, match="Unknown flag"):
            paddle.set_flags({"FLAGS_no_such_flag": 1})
    finally:
        paddle.set_flags(keep)


def test_fault1_check_nan_inf_raises_as_reference():
    """Fault 1: ``set_flags({"FLAGS_check_nan_inf": True})`` was refused
    ("Unknown flag"); now ``log(-1)`` raises FloatingPointError with the
    reference's message, at level 1 prints it, and with the flag off
    returns NaN."""
    msgs = []
    for P in (paddle, ref):
        kw = {"place": "cpu"} if P is paddle else {}
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError) as e:
                P.log(P.to_tensor([-1.0], **kw))
            msgs.append(str(e.value))
            P.set_flags({"FLAGS_check_nan_inf_level": 1})
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                P.log(P.to_tensor([-1.0], **kw))
            msgs.append(buf.getvalue().strip())
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False,
                         "FLAGS_check_nan_inf_level": 0})
    assert msgs[0] == msgs[2] == "Operator log output contains NaN/Inf"
    assert msgs[1] == msgs[3] == "[check_nan_inf] " + msgs[0]
    assert np.isnan(paddle.log(paddle.to_tensor([-1.0])).item())
    # a module-level op (matmul), an op inside a layer, the torch mode
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = paddle.to_tensor([[np.inf, 1.0]])
        for fn, name in ((lambda: paddle.matmul(x, x.T), "matmul"),
                         (lambda: x * 2, "multiply")):
            with pytest.raises(FloatingPointError, match=name):
                fn()
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})


def test_enforce_errors_match_reference():
    from paddle_tpu.core import enforce as renforce

    names = [n for n, v in vars(renforce).items()
             if isinstance(v, type) and issubclass(v, Exception)]
    for n in names:
        mine, theirs = getattr(enforce, n), getattr(renforce, n)
        assert [b.__name__ for b in mine.__mro__] == \
            [b.__name__ for b in theirs.__mro__]
    with pytest.raises(enforce.InvalidArgumentError, match="bad"):
        enforce.enforce(False, "bad")


# -- InferMeta ---------------------------------------------------------------------

LEFT_OUT = {
    "test_validators_skip_traced_values": "the port has no paddle.jit",
    "test_cauchy_fills_in_place": "Tensor.cauchy_ keeps torch's meaning",
    "test_cauchy_rejects_nonpositive_scale":
        "Tensor.cauchy_ keeps torch's meaning",
    "test_cauchy_rejects_integer_destination":
        "Tensor.cauchy_ keeps torch's meaning",
    "test_geometric_rejects_probs_out_of_range":
        "Tensor.geometric_ keeps torch's meaning",
    "test_exponential_rejects_nonpositive_lam":
        "Tensor.exponential_ keeps torch's meaning",
    "test_log_normal_rejects_nonpositive_std":
        "Tensor.log_normal_ keeps torch's meaning",
}


def _catalogue():
    """{case id: (function, args)} of the reference's InferMeta tests,
    their imports pointed at the port."""
    with open(os.path.join(HERE, "test_infermeta.py")) as f:
        src = f.read()
    src = re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", src)
    ns = {"__name__": "infermeta_catalogue"}
    exec(compile(src, "test_infermeta (port)", "exec"), ns)
    cases = {}
    for name, fn in ns.items():
        if not name.startswith("test_") or not callable(fn) \
                or name in LEFT_OUT:
            continue
        params = [m for m in getattr(fn, "pytestmark", [])
                  if m.name == "parametrize"]
        if not params:
            cases[name] = (fn, ())
            continue
        argnames, values = params[0].args[0], params[0].args[1]
        multi = "," in argnames
        for i, v in enumerate(values):
            cases[f"{name}[{i}]"] = (fn, tuple(v) if multi else (v,))
    return cases


CATALOGUE = _catalogue()


def _outcome(fn, datas, attrs):
    try:
        fn(datas, attrs)
    except Exception as e:      # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", sorted(CATALOGUE))
def test_infermeta_catalogue_on_the_port(case, monkeypatch):
    fn, args = CATALOGUE[case]
    calls = []
    original = pinfer.validate

    def recording(op_name, datas, attrs):
        calls.append((op_name, tuple(pinfer.meta(d) for d in datas),
                      {k: pinfer.meta(v) for k, v in attrs.items()}))
        return original(op_name, datas, attrs)

    monkeypatch.setattr(pinfer, "validate", recording)
    fn(*args)
    for op_name, datas, attrs in calls:
        if op_name not in pinfer._VALIDATORS:
            continue
        got = _outcome(pinfer._VALIDATORS[op_name], datas, attrs)
        want = _outcome(rinfer._VALIDATORS[op_name], datas, attrs)
        assert got == want, (op_name, got, want)


def test_validator_tables_and_dispatch():
    """The same 105 validators, with the same code apart from the
    metadata conversion; every one's op name reaches the port's
    dispatch."""
    assert set(pinfer._VALIDATORS) == set(rinfer._VALIDATORS)
    assert len(pinfer._VALIDATORS) == 105
    for name, fn in pinfer._VALIDATORS.items():
        assert inspect.getsource(fn) == inspect.getsource(
            rinfer._VALIDATORS[name]), name
    assert set(pinfer._VALIDATORS) <= set(registry.all_ops())
    hit = set()
    for case in CATALOGUE:
        for n in re.findall(r"test_([a-z0-9_]+?)_(?:accepts|rejects)", case):
            hit.add(n)
    assert len(hit) > 60


def test_validation_runs_on_metadata_only():
    """A validator sees shapes and dtype names, never values: a tensor
    on the meta device (no data) validates and fails as a CPU one."""
    x = torch.empty(2, 3, device="meta")
    y = torch.empty(4, 5, device="meta")
    with pytest.raises(enforce.InvalidArgumentError, match="width"):
        pinfer.validate("matmul", (x, y), {})
    pinfer.validate("matmul", (x, y.T[:3]), {})
    m = pinfer.meta(torch.zeros(2, dtype=torch.bfloat16))
    assert (m.shape, m.dtype, m.ndim) == ((2,), "bfloat16", 1)


# -- amp.debugging -----------------------------------------------------------------

def _mlp(P, w1, w2):
    def f(x):
        h = P.nn.functional.relu(P.matmul(x, w1) + 1.0)
        return P.nn.functional.softmax(P.matmul(h, w2) * 2.0, axis=-1)
    return f


@pytest.mark.parametrize("level", ["O0", "O1", "O2"])
def test_operator_stats_match_reference(level):
    rng = np.random.RandomState(0)
    x, w1, w2 = rng.randn(4, 8), rng.randn(8, 16), rng.randn(16, 4)
    tables = {}
    for P, dbg in ((paddle, paddle.amp.debugging), (ref, rdebug)):
        t = [P.to_tensor(a.astype(np.float32)) for a in (x, w1, w2)]
        f = _mlp(P, t[1], t[2])
        dbg.enable_operator_stats_collection()
        try:
            if level == "O0":
                f(t[0])
            else:
                with P.amp.auto_cast(level=level):
                    f(t[0])
        finally:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tables[P.__name__] = dbg.disable_operator_stats_collection()
    assert tables["paddle_tpu_torch"] == tables["paddle_tpu"]
    assert tables["paddle_tpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with paddle.amp.debugging.collect_operator_stats():
            paddle.add(paddle.ones([2]), paddle.ones([2]))
    assert "add" in buf.getvalue() and "op list" in buf.getvalue()
    assert paddle.amp.state.amp_state().tally is None


def test_tensor_checker_config_scopes_the_check():
    D = paddle.amp.debugging
    bad = paddle.to_tensor([-1.0])
    cfg = D.TensorCheckerConfig(enable=True, skipped_op_list=["log"])
    D.enable_tensor_checker(cfg)
    try:
        paddle.log(bad)                       # skipped
        with pytest.raises(FloatingPointError, match="sqrt"):
            paddle.sqrt(bad)
    finally:
        D.disable_tensor_checker()
    D.enable_tensor_checker(D.TensorCheckerConfig(
        enable=True, checked_op_list=["sqrt"],
        debug_mode=D.DebugMode.CHECK_NAN_INF))
    try:
        paddle.log(bad)                       # not listed
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            paddle.sqrt(bad)                  # level 1: printed
        assert "Operator sqrt output contains NaN/Inf" in buf.getvalue()
    finally:
        D.disable_tensor_checker()
    assert not paddle.get_flags("check_nan_inf")["check_nan_inf"]
    D.enable_tensor_checker(D.TensorCheckerConfig(enable=False))
    assert not paddle.get_flags("check_nan_inf")["check_nan_inf"]
