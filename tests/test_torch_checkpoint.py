"""The port's checkpoint files, commit protocol and comm watchdog against
``paddle_tpu``'s.

As the reference's ``tests/test_checkpoint_faults.py``,
``tests/test_ckpt_checksum.py`` and ``tests/test_watchdog.py``, less the
multi-rank reshard and the launcher's KV roll call (ROADMAP.md Queue 1,
item 8):

- the format: the port writes the reference's files (names, ``.npy``
  bytes, bf16 as ``'<V2'``) and metadata JSON, and each package loads the
  other's committed checkpoint bit for bit (fp32, bf16, int64, 0-d);
- a crash (a subprocess, ``PT_FAULTS``) at each ``ckpt.*`` spec leaves
  the last committed step, which reloads bit for bit;
- a corrupt shard raises ``ChecksumError`` naming the file and the
  tensor, and a failed load leaves its targets as they were;
- keep-last-k, the async handle (non-daemon, its snapshot taken at the
  call, its error raised at the next save), the SIGTERM hook, and the
  commit barrier under the watchdog; the fault points hit for hit.
"""
import json
import os
import signal
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle  # noqa: F401  (conftest sets the 8-dev mesh)
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.ckpt_commit import \
    CheckpointManager as JaxManager
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch.distributed.checkpoint import (
    ChecksumError, _crc32_file, last_load_stats, last_save_stats,
    load_state_dict, save_state_dict,
)
from paddle_tpu_torch.distributed.ckpt_commit import (
    CheckpointManager, committed_steps, latest_step,
)
from paddle_tpu_torch.distributed.watchdog import CommWatchdog
from paddle_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


def _mixed(seed=0):
    """A train state's kinds of entries, as numpy (the reference's
    values: bf16 through ml_dtypes): fp32, bf16, int64 and 0-d."""
    rng = np.random.RandomState(seed)
    return {
        "params/llama.layers.0.mlp.up_proj.weight":
            rng.randn(8, 12).astype(ml_dtypes.bfloat16),
        "master/llama.layers.0.mlp.up_proj.weight":
            rng.randn(8, 12).astype(np.float32),
        "m/llama.norm.weight": rng.randn(12).astype(np.float32),
        "ids": rng.randint(-5, 1 << 40, (3, 4)).astype(np.int64),
        "t": np.asarray(7 + seed, np.int64),
        "scale": np.asarray(rng.randn(), np.float32),
    }


def _torch(state):
    """The same values as port tensors (bf16 from its bytes)."""
    out = {}
    for k, v in state.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _bits(t):
    """Raw bytes of a tensor or an array, whatever its dtype."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _zeros_torch(state):
    return {k: torch.zeros_like(v) for k, v in _torch(state).items()}


def _assert_bits(loaded, want):
    assert sorted(loaded) == sorted(want)
    for k in want:
        assert _bits(loaded[k]) == _bits(want[k]), k


def _files(path):
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


# -- the format, across packages ----------------------------------------------

def test_files_and_metadata_equal_the_reference(tmp_path):
    state = _mixed()
    save_state_dict(_torch(state), str(tmp_path / "port"))
    jckpt.save_state_dict(state, str(tmp_path / "ref"))
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(port) == sorted(ref)
    assert "params_llama.layers.0.mlp.up_proj.weight.0-None_0-None.r0.npy" \
        in port and "t.full.r0.npy" in port
    meta = "0.metadata.json"
    assert json.loads(port[meta]) == json.loads(ref[meta])
    assert json.loads(port[meta])["format"] == "paddle_tpu.dist_ckpt.v1"
    for name in port:
        assert port[name] == ref[name], name
    bf16 = port["params_llama.layers.0.mlp.up_proj.weight."
                "0-None_0-None.r0.npy"]
    assert b"'descr': '<V2'" in bf16[:128]


def test_port_loads_the_reference_s_commit(tmp_path):
    state = _mixed(1)
    JaxManager(str(tmp_path), world_size=1, rank=0).save(state, 4)
    target = _zeros_torch(state)
    assert CheckpointManager(str(tmp_path)).load(target) == 4
    _assert_bits(target, _torch(state))
    assert target["params/llama.layers.0.mlp.up_proj.weight"].dtype \
        == torch.bfloat16


def test_reference_loads_the_port_s_commit(tmp_path):
    state = _mixed(2)
    CheckpointManager(str(tmp_path)).save(_torch(state), 9)
    target = {k: np.zeros_like(v) for k, v in state.items()}
    assert JaxManager(str(tmp_path), world_size=1, rank=0).load(target) == 9
    for k, v in state.items():
        got = np.asarray(target[k])
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k


def test_port_loads_a_sharded_reference_checkpoint(tmp_path):
    """A tensor the reference wrote as eight shards (Shard(0) over its
    CPU mesh) loads whole, and a hole in its index is caught before any
    target is written."""
    import paddle_tpu.distributed as dist
    from paddle_tpu.distributed.auto_parallel import ProcessMesh, Shard

    mesh = ProcessMesh(shape=[8], dim_names=["mp"])
    want = np.arange(64, dtype=np.float32).reshape(8, 8)
    x = dist.shard_tensor(paddle.to_tensor(want), mesh, [Shard(0)])
    path = str(tmp_path / "d")
    jckpt.save_state_dict({"w": x}, path)
    target = {"w": torch.zeros(8, 8)}
    load_state_dict(target, path)
    assert torch.equal(target["w"], torch.from_numpy(want))
    assert last_load_stats().regions == 1
    meta_path = os.path.join(path, "0.metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert len(meta["tensors"]["w"]["shards"]) == 8
    del meta["tensors"]["w"]["shards"][3]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    target = {"w": torch.full((8, 8), 7.0)}
    with pytest.raises(ValueError, match="does not cover"):
        load_state_dict(target, path)
    assert torch.equal(target["w"], torch.full((8, 8), 7.0))


def test_load_fills_tensors_in_place_and_replaces_others(tmp_path):
    state = _mixed(3)
    path = str(tmp_path)
    save_state_dict(_torch(state), path)
    live = _zeros_torch(state)
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    target = dict(live, scale=None)
    load_state_dict(target, path)
    assert all(live[k].data_ptr() == p for k, p in ptrs.items())
    assert isinstance(target["scale"], torch.Tensor)
    _assert_bits(target, _torch(state))
    stats = last_load_stats()
    assert stats.peak_buffer_bytes == 8 * 12 * 4
    assert stats.total_read_bytes == sum(
        max(v.nbytes, v.dtype.itemsize) for v in state.values())


def test_save_stats_count_the_bytes(tmp_path):
    state = _mixed()
    save_state_dict(_torch(state), str(tmp_path))
    st = last_save_stats()
    assert st.files == len(state)
    assert st.bytes == sum(v.nbytes for v in state.values())
    assert min(st.snapshot_s, st.write_s, st.fsync_s, st.crc_s) >= 0.0


# -- checksums ----------------------------------------------------------------

def test_crc32_stamped_in_metadata_and_clean_roundtrip(tmp_path):
    path = str(tmp_path)
    state = _torch(_mixed())
    save_state_dict(state, path)
    with open(os.path.join(path, "0.metadata.json")) as f:
        meta = json.load(f)
    for entry in meta["tensors"].values():
        for shard in entry["shards"]:
            assert shard["crc32"] == _crc32_file(
                os.path.join(path, shard["file"]))
    target = {k: torch.zeros_like(v) for k, v in state.items()}
    load_state_dict(target, path)
    _assert_bits(target, state)


def test_corrupt_shard_caught_and_target_untouched(tmp_path, monkeypatch):
    """A bit flipped in a shard file right after it hit disk
    (``PT_FAULTS``, as a launcher would arm it) surfaces as
    ChecksumError at load, naming the file and the tensor, with the
    targets left untouched; ``verify=False`` reads the rot."""
    path = str(tmp_path)
    rng = np.random.RandomState(0)
    state = {"w": torch.from_numpy(rng.randn(64, 64).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(256).astype(np.float32))}
    monkeypatch.setenv("PT_FAULTS", "ckpt.shard_write:after:1=corrupt")
    faults.reset()
    save_state_dict(state, path)
    faults.disarm_all()
    target = {"w": torch.full((64, 64), 3.0), "b": torch.full((256,), 3.0)}
    with pytest.raises(ChecksumError, match=r"w\.0-None_0-None\.r0\.npy"
                       r".*tensor 'w'"):
        load_state_dict(target, path)
    assert torch.equal(target["w"], torch.full((64, 64), 3.0))
    assert torch.equal(target["b"], torch.full((256,), 3.0))
    load_state_dict(target, path, verify=False)
    assert not torch.equal(target["w"], state["w"])
    assert torch.equal(target["b"], state["b"])


def test_reference_catches_the_port_s_corrupt_shard(tmp_path):
    path = str(tmp_path)
    faults.arm("ckpt.shard_write", "after", 1, "corrupt")
    save_state_dict({"w": torch.randn(64, 64)}, path)
    with pytest.raises(jckpt.ChecksumError, match="tensor 'w'"):
        jckpt.load_state_dict({"w": np.zeros((64, 64), np.float32)}, path)


def test_load_missing_name_or_shape_leaves_state_untouched(tmp_path):
    path = str(tmp_path / "d")
    save_state_dict({"present": torch.ones(2, 2)}, path)
    target = {"present": torch.zeros(2, 2), "absent": torch.zeros(3)}
    with pytest.raises(KeyError, match="absent"):
        load_state_dict(target, path)
    assert torch.equal(target["present"], torch.zeros(2, 2))
    target = {"present": torch.zeros(4, 4)}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state_dict(target, path)
    assert torch.equal(target["present"], torch.zeros(4, 4))


def test_process_group_waits_for_item_8(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        save_state_dict({"w": torch.ones(1)}, str(tmp_path),
                        process_group=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        load_state_dict({"w": torch.ones(1)}, str(tmp_path),
                        process_group=object())


# -- crash safety: a real kill at every ckpt.* spec ---------------------------

def _state(step):
    rng = np.random.RandomState(step)
    return {"w": torch.from_numpy(rng.randn(4, 6).astype(np.float32)),
            "opt_m": torch.from_numpy(rng.randn(4, 6).astype(np.float32)),
            "opt_v": torch.from_numpy(rng.randn(4, 6).astype(np.float32))}


_CRASH_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from paddle_tpu_torch.distributed.ckpt_commit import CheckpointManager
from paddle_tpu_torch.testing import faults

root, spec = sys.argv[2], sys.argv[3]
rng = np.random.RandomState(2)
state = {k: torch.from_numpy(rng.randn(4, 6).astype(np.float32))
         for k in ("w", "opt_m", "opt_v")}
faults.reset(spec)
mgr = CheckpointManager(root, keep_last_k=None, world_size=1, rank=0)
mgr.save(state, 2)
print("SURVIVED")  # fault never fired -> parent fails the test
"""

#: the reference's specs (tests/test_checkpoint_faults.py)
_CKPT_FAULT_SPECS = [
    "ckpt.shard_write:before:1=crash",
    "ckpt.shard_write:after:2=crash",
    "ckpt.shard_write:after:1=truncate",
    "ckpt.metadata:before:1=crash",
    "ckpt.metadata:after:1=crash",
    "ckpt.commit:before:1=crash",
    "ckpt.commit:after:1=crash",  # renamed but COMMIT never written
    # commit fires with a DIRECTORY path: truncate must skip to the
    # hard kill, not die on open(IsADirectoryError)
    "ckpt.commit:before:1=truncate",
]


def _child_env():
    env = dict(os.environ)
    env.pop("PT_FAULTS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_ckpt_fault_point_is_covered():
    pts = {s.split(":")[0] for s in _CKPT_FAULT_SPECS}
    assert pts == {p for p in faults.registered_points()
                   if p.startswith("ckpt.")}


@pytest.mark.parametrize("spec", _CKPT_FAULT_SPECS)
def test_crash_mid_save_recovers_last_committed_step(tmp_path, spec):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_k=None)
    mgr.save(_state(1), 1)
    assert mgr.committed_steps() == [1]
    res = subprocess.run(
        [sys.executable, "-c", _CRASH_CHILD, REPO, root, spec],
        env=_child_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == faults.EXIT_CODE, (
        f"fault {spec} did not kill the child "
        f"(rc={res.returncode}):\n{res.stdout}\n{res.stderr}")
    assert "SURVIVED" not in res.stdout
    # only step 1 is committed and it reloads bit for bit, in either
    # package
    assert latest_step(root) == 1 and committed_steps(root) == [1]
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    assert CheckpointManager(root).load(loaded) == 1
    _assert_bits(loaded, _state(1))
    jloaded = {k: np.zeros((4, 6), np.float32) for k in loaded}
    assert JaxManager(root, world_size=1, rank=0).load(jloaded) == 1
    _assert_bits(jloaded, _state(1))
    step2 = os.path.join(root, "step-2")
    if os.path.isdir(step2):
        assert not os.path.exists(os.path.join(step2, "COMMIT"))


def test_uncommitted_dir_is_never_selected(tmp_path):
    root = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(root, "step-7"))
    with open(os.path.join(root, "step-7", "0.metadata.json"), "w") as f:
        json.dump({"tensors": {}}, f)
    assert latest_step(root) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(root).load({"w": torch.zeros(2, 2)})


@pytest.mark.parametrize("spec", ["ckpt.shard_write", "ckpt.metadata",
                                  "ckpt.commit"])
def test_points_hit_for_hit(tmp_path, spec):
    """Each package's commit of the same state hits every ckpt.* point
    (both phases) as many times."""
    hits = []
    for fm, mgr, state in (
            (faults, CheckpointManager(str(tmp_path / "p")),
             _torch(_mixed())),
            (jfaults, JaxManager(str(tmp_path / "r"), world_size=1,
                                 rank=0), _mixed())):
        specs = [fm.arm(spec, ph, "*", "delay", "0")
                 for ph in ("before", "after")]
        mgr.save(state, 1)
        hits.append([s.hits for s in specs])
    assert hits[0] == hits[1] and hits[0][0] >= 1


# -- the manager --------------------------------------------------------------

def test_keep_last_k_retention(tmp_path):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, keep_last_k=2)
    for step in range(1, 6):
        mgr.save(_state(step), step)
    assert mgr.committed_steps() == [4, 5]
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    assert mgr.load(loaded) == 5
    _assert_bits(loaded, _state(5))


def test_save_committed_step_is_noop(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 1).result()
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    mgr.load(loaded, step=1)
    _assert_bits(loaded, _state(1))


def test_defaults_are_one_process(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert (mgr.world_size, mgr.rank, mgr.coordinator_rank) == (1, 0, 0)


def test_aot_warmup_runs_after_every_load(tmp_path):
    calls = []
    mgr = CheckpointManager(str(tmp_path), aot_warmup=lambda: calls.append(1))
    mgr.save(_state(1), 1)
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    mgr.load(loaded)
    mgr.load(loaded, step=1)
    assert calls == [1, 1]
    # a failing hook never turns a good restore into a failed one
    bad = CheckpointManager(str(tmp_path), aot_warmup=lambda: 1 / 0)
    assert bad.load(loaded) == 1


def test_async_save_surfaces_worker_error(tmp_path):
    faults.arm("ckpt.shard_write", phase="before", nth=1, action="raise")
    h = save_state_dict({"w": torch.ones(3, 3)}, str(tmp_path / "d"),
                        async_save=True)
    with pytest.raises(faults.InjectedFault):
        h.result()
    assert h.done()


def test_async_save_handle_is_nondaemon_and_joinable(tmp_path):
    faults.arm("ckpt.metadata", phase="before", nth=1, action="delay",
               arg="0.2")
    h = save_state_dict({"w": torch.ones(3, 3)}, str(tmp_path / "d"),
                        async_save=True)
    assert not h._thread.daemon
    h.result(timeout=10)
    assert h.done()


def test_manager_async_save_and_overlap_guard(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    faults.arm("ckpt.metadata", phase="before", nth=1, action="delay",
               arg="0.3")
    h1 = mgr.save(_state(1), 1, async_save=True)
    mgr.save(_state(2), 2)          # joins (and checks) the first
    assert h1.done()
    assert mgr.committed_steps() == [1, 2]
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    mgr.load(loaded, step=2)
    _assert_bits(loaded, _state(2))


def test_manager_async_error_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    faults.arm("ckpt.shard_write", phase="before", nth=1, action="raise")
    mgr.save(_state(1), 1, async_save=True)
    with pytest.raises(faults.InjectedFault):
        mgr.save(_state(2), 2)
    assert mgr.committed_steps() == []


def test_async_save_snapshots_state_at_call_time(tmp_path):
    """Writing the tensors in place after save() returns must not reach
    the checkpoint: they are copied to the host at the call."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    faults.arm("ckpt.shard_write", phase="before", nth=1,
               action="delay", arg="0.2")
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    h = mgr.save({"w": w}, 1, async_save=True)
    w.fill_(-1.0)
    h.result()
    loaded = {"w": torch.zeros(4, 4)}
    mgr.load(loaded, step=1)
    assert torch.equal(loaded["w"],
                       torch.arange(16, dtype=torch.float32).reshape(4, 4))


def test_multirank_save_preserves_other_ranks_files(tmp_path):
    """Two ranks' managers over one root in one process: a late rank
    clearing its own leftovers keeps the other's files, and the commit
    indexes both."""
    root = str(tmp_path / "ckpt")
    r1 = CheckpointManager(root, world_size=2, rank=1, barrier_timeout=10.0)
    r0 = CheckpointManager(root, world_size=2, rank=0, barrier_timeout=10.0)
    a = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 100.0
    r1.save({"b": b}, 1)
    r0.save({"a": a}, 1)
    assert committed_steps(root) == [1]
    loaded = {"a": torch.zeros_like(a), "b": torch.zeros_like(b)}
    CheckpointManager(root, world_size=2, rank=0).load(loaded, step=1)
    assert torch.equal(loaded["a"], a) and torch.equal(loaded["b"], b)


def test_clear_rank_files_touches_only_own_rank(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), world_size=2, rank=0)
    tmp = mgr._tmp_dir(3)
    os.makedirs(tmp)
    mine = ["rank-0.done", "0.metadata.json", "w.0-2.r0.npy"]
    theirs = ["rank-1.done", "1.metadata.json", "w.2-4.r1.npy",
              "w.0-2.r10.npy"]
    for n in mine + theirs:
        with open(os.path.join(tmp, n), "w") as f:
            f.write("x")
    mgr._clear_rank_files(tmp)
    assert sorted(os.listdir(tmp)) == sorted(theirs)


_SIGTERM_CHILD = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from paddle_tpu_torch.distributed.ckpt_commit import CheckpointManager
from paddle_tpu_torch.testing import faults

root = sys.argv[2]

def state(step):
    rng = np.random.RandomState(step)
    return {k: torch.from_numpy(rng.randn(4, 6).astype(np.float32))
            for k in ("w", "opt_m", "opt_v")}

mgr = CheckpointManager(root, keep_last_k=None)
mgr.save(state(1), 1)
# a slow async save of step 2, so SIGTERM lands while it is in flight
faults.reset("ckpt.metadata:before:1=delay:0.8")
mgr.save(state(2), 2, async_save=True)
mgr.install_preemption_hook(lambda: state(3), lambda: 3)
print("READY", flush=True)
while True:
    time.sleep(0.05)
"""


def test_sigterm_preemption_commits_final_checkpoint(tmp_path):
    root = str(tmp_path / "ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD, REPO, root],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "READY" in line, line
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stderr.read()
    # the in-flight step-2 save finished AND the final step-3 committed
    assert committed_steps(root) == [1, 2, 3]
    loaded = {k: torch.zeros(4, 6) for k in ("w", "opt_m", "opt_v")}
    CheckpointManager(root).load(loaded)
    _assert_bits(loaded, _state(3))


# -- the watchdog and the commit barrier -------------------------------------

def _wait_fired(wd, deadline=3.0):
    t0 = time.time()
    while not wd.fired and time.time() - t0 < deadline:
        time.sleep(0.01)
    return wd.fired


def test_commit_barrier_times_out_naming_missing_ranks(tmp_path):
    wd = CommWatchdog(timeout=0.15, abort=False, world_size=2, rank=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), world_size=2, rank=0,
                            barrier_timeout=0.5, watchdog=wd)
    with pytest.raises(RuntimeError, match=r"missing done markers: \[1\]"):
        mgr.save({"w": torch.ones(2, 2)}, 1)
    fired = _wait_fired(wd)
    assert fired and fired[0][0] == "ckpt commit barrier step-1"
    assert mgr.committed_steps() == []


def test_watchdog_abort_false_records_diagnosis():
    wd = CommWatchdog(timeout=0.15, abort=False, world_size=2, rank=0)
    with wd.task("unit-test blocking wait"):
        time.sleep(0.4)
    fired = _wait_fired(wd)
    assert len(fired) == 1
    desc, diag = fired[0]
    assert desc == "unit-test blocking wait"
    assert "exceeded" in diag and "rank 0" in diag
    assert "expected world size 2" in diag


def test_watchdog_fast_operation_does_not_fire():
    wd = CommWatchdog(timeout=0.5, abort=False)
    with wd.task("quick op"):
        pass
    time.sleep(0.1)
    assert wd.fired == []


def test_watchdog_timeout_env_and_diagnosis_as_the_reference(monkeypatch):
    """``PADDLE_COMM_TIMEOUT`` and the launch env's world and rank; the
    roll call has no launcher to ask (item 8), so it returns None, as the
    reference's does without a reachable store, and the diagnosis is the
    reference's word for word."""
    from paddle_tpu.distributed.watchdog import CommWatchdog as JaxWatchdog

    monkeypatch.setenv("PADDLE_COMM_TIMEOUT", "12")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    wd, jwd = CommWatchdog(abort=False), JaxWatchdog(abort=False)
    assert wd.timeout == jwd.timeout == 12.0
    assert wd._registered_ranks() is None
    assert wd.diagnose("barrier", 13.0) == jwd.diagnose("barrier", 13.0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert wd._registered_ranks() is None
