"""The port's fault-injection harness against ``paddle_tpu``'s.

``paddle_tpu_torch/testing/faults.py`` is a copy of the reference's
module: the ``PT_FAULTS`` grammar and its errors, the ``nth`` / ``*``
hit counting, ``fire`` / ``poll`` / ``consume``, the registry (all 47
points, name for name and text for text) and the seeded chaos schedules
must be the reference's, so that one spec string arms the same fault in
either package.  A subprocess armed with ``crash`` exits with
``EXIT_CODE`` 53.
"""
import os
import subprocess
import sys

import pytest

from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    faults.reset("")
    jfaults.reset("")
    yield
    faults.reset("")
    jfaults.reset("")


def test_registry_is_the_reference_s():
    assert len(faults.REGISTERED) == 47
    assert faults.REGISTERED == jfaults.REGISTERED
    assert faults.registered_points() == jfaults.registered_points()
    assert faults.EXIT_CODE == jfaults.EXIT_CODE == 53
    assert faults.CHAOS_ACTIONS == jfaults.CHAOS_ACTIONS


@pytest.mark.parametrize("text", [
    "serve.step:before:2=raise",
    "wal.append:after:12=truncate,wal.fsync:before:*=delay:0.01",
    "replica.fail:before:7=hang:0.5, kv.salvage:before:1=inject",
    "",
])
def test_grammar_parses_as_the_reference(text):
    got = [(s.point, s.phase, s.nth, s.action, s.arg)
           for s in faults.reset(text)]
    want = [(s.point, s.phase, s.nth, s.action, s.arg)
            for s in jfaults.reset(text)]
    assert got == want


@pytest.mark.parametrize("text,match", [
    ("serve.stepp:before:1=raise", "unknown fault point"),
    ("serve.step:during:1=raise", "fault phase"),
    ("serve.step:before:1=explode", "unknown fault action"),
    ("serve.step:before=raise", "bad PT_FAULTS spec"),
    ("serve.step:before:1", "bad PT_FAULTS spec"),
])
def test_grammar_errors(text, match):
    with pytest.raises(ValueError, match=match):
        faults.reset(text)
    with pytest.raises(ValueError, match=match):
        jfaults.reset(text)


def test_env_is_read_lazily(monkeypatch):
    monkeypatch.setenv("PT_FAULTS", "serve.step:before:1=raise")
    faults.reset()
    with pytest.raises(faults.InjectedFault):
        faults.fire("serve.step", "before")
    monkeypatch.setenv("PT_FAULTS", "")
    faults.reset()
    faults.fire("serve.step", "before")


def test_nth_and_star_counting():
    faults.arm("serve.decode", "after", 3, "raise")
    faults.arm("serve.admit", "before", "*", "raise")
    for _ in range(2):
        faults.fire("serve.decode", "after")
        faults.fire("serve.decode", "before")    # other phase: no hit
    with pytest.raises(faults.InjectedFault, match="hit 3"):
        faults.fire("serve.decode", "after")
    faults.fire("serve.decode", "after")         # nth fires once only
    for _ in range(3):
        with pytest.raises(faults.InjectedFault):
            faults.fire("serve.admit", "before")
    faults.disarm_all()
    faults.fire("serve.admit", "before")


def test_unregistered_point_asserts():
    faults.arm("serve.step", "before", 5, "raise")
    with pytest.raises(AssertionError, match="unregistered"):
        faults.fire("serve.stepp", "before")


def test_poll_and_consume():
    # inject specs are value faults: fire() never trips or counts them
    faults.reset("kv.salvage:before:2=inject,"
                 "replica.fail:before:1=hang:3")
    faults.fire("kv.salvage", "before")
    assert faults.poll("kv.salvage") is None
    assert faults.poll("kv.salvage") is True
    assert faults.poll("kv.salvage") is None
    assert faults.consume("replica.fail") == ("hang", "3")
    assert faults.consume("replica.fail") is None


def test_delay_and_corrupt(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(16)))
    faults.reset("wal.append:before:1=corrupt,wal.append:after:1=delay:0")
    faults.fire("wal.append", "before", path=str(p))
    faults.fire("wal.append", "after", path=str(p))
    got = p.read_bytes()
    assert got[8] == 8 ^ 0x10 and got[:8] + got[9:] == bytes(
        range(8)) + bytes(range(9, 16))


@pytest.mark.parametrize("seed,steps,n", [(7, 48, None), (21, 48, None),
                                          (1337, 48, None), (5, 64, 9)])
def test_chaos_schedule_is_the_reference_s(seed, steps, n):
    got = faults.chaos_schedule(seed, steps, n_faults=n)
    assert got == jfaults.chaos_schedule(seed, steps, n_faults=n)
    faults.reset(",".join(got))     # every drawn spec parses


def test_chaos_env(monkeypatch):
    assert faults.parse_chaos("42:64") == (42, 64)
    assert faults.parse_chaos("") is None
    monkeypatch.delenv("PT_CHAOS", raising=False)
    assert faults.parse_chaos() is None
    with pytest.raises(ValueError, match="PT_CHAOS"):
        faults.parse_chaos("42")
    with pytest.raises(ValueError, match="steps"):
        faults.parse_chaos("42:0")
    monkeypatch.setenv("PT_CHAOS", "9:32")
    specs = faults.chaos_from_env()
    assert specs == faults.chaos_schedule(9, 32)
    assert [s.point for s in faults.reset(",".join(specs))] \
        == [s.point for s in jfaults.reset(",".join(specs))]


@pytest.mark.parametrize("action", ["crash", "truncate"])
def test_crash_exits_53(tmp_path, action):
    target = tmp_path / "seg"
    target.write_bytes(b"x" * 64)
    code = ("from paddle_tpu_torch.testing import faults\n"
            f"faults.fire('wal.append', 'before', path={str(target)!r})\n"
            "print('survived')\n")
    env = {**os.environ,
           "PT_FAULTS": f"wal.append:before:1={action}",
           "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == faults.EXIT_CODE == 53, proc.stderr
    assert "survived" not in proc.stdout
    assert target.stat().st_size == (32 if action == "truncate" else 64)


def test_obs_gate(monkeypatch, tmp_path):
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.inference.server.wal import WriteAheadLog

    monkeypatch.delenv("PT_OBS", raising=False)
    obs.reset()
    assert obs.handle() is None and not obs.enabled()
    assert obs.configure("off") is None
    with pytest.raises(NotImplementedError, match="item 9"):
        obs.configure("on")
    with pytest.raises(ValueError, match="mode"):
        obs.configure("loud")
    monkeypatch.setenv("PT_OBS", "on")
    obs.reset()
    with pytest.raises(NotImplementedError, match="item 9"):
        obs.handle()
    # a producer asks the gate at construction: it fails at build
    with pytest.raises(NotImplementedError, match="item 9"):
        WriteAheadLog(str(tmp_path / "j"))
    monkeypatch.setenv("PT_OBS", "bogus")
    obs.reset()
    with pytest.raises(ValueError, match="PT_OBS"):
        obs.handle()
    monkeypatch.delenv("PT_OBS")
    obs.reset()
    assert obs.handle() is None
