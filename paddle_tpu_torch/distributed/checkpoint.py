"""Checkpoint files: one process's part of
``paddle_tpu/distributed/checkpoint.py``.

Each tensor of a flat ``{name: tensor}`` dict is written as one ``.npy``
file plus an index in ``{rank}.metadata.json``, in the reference's
format byte for byte (``"paddle_tpu.dist_ckpt.v1"``, the shard file
names ``_prepare_save`` forms, offsets, lengths, and the crc32 of each
file stamped after it lands), so either package loads the other's
checkpoints.  A whole tensor is the one shard whose index is all
``slice(None)``: the reference names its file
``{name}.0-None_0-None.r{rank}.npy`` (``full`` for a 0-d tensor).

bf16 needs no ``ml_dtypes``: the reference's ``.npy`` holds it as
two-byte void (header ``'<V2'``), and the port writes the same header
over the bytes of ``tensor.view(torch.int16)`` and reads them back
through ``.view(torch.bfloat16)``.

The load is shard-wise: the files are memory-mapped and only the bytes
each target needs are copied (``last_load_stats()`` gives the largest
buffer).  Names, shapes, coverage (an exact cell bitmap) and every
file's crc32 are checked before any target is written, so a failed load
leaves the targets as they were.

Not here (ROADMAP.md Queue 1, item 8): a target sharded over several
devices or processes, and ``process_group``: every target is one whole
tensor, filled in place (``copy_``) when it is a ``torch.Tensor``.

Crash safety is layered on top by ``ckpt_commit.CheckpointManager``;
this module gives the fault-point-instrumented writes (``ckpt.shard_write``,
``ckpt.metadata``) and an async save handle that re-raises its worker's
error.
"""
from __future__ import annotations

import bisect
import json
import os
import io
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..testing import faults

FORMAT = "paddle_tpu.dist_ckpt.v1"


class ChecksumError(ValueError):
    """A shard file's bytes no longer match the crc32 recorded in the
    checkpoint metadata at save time — silent bit rot (or tampering).
    Raised BEFORE any target tensor is mutated, naming shard + file."""


_CRC_CHUNK = 1 << 20


def _crc32_file(path):
    """Streaming crc32 of the whole file (header included) — constant
    ~1 MiB host allocation regardless of shard size."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _pool(n):
    """Threads for crc32 sums: ``zlib.crc32`` releases the GIL over large
    buffers, so files are summed side by side."""
    return ThreadPoolExecutor(max_workers=max(1, min(n, os.cpu_count() or 1,
                                                     8)))


# -- async save handle -------------------------------------------------------

class AsyncSaveHandle:
    """Handle for a background save.

    The worker runs on a NON-daemon thread (interpreter exit waits for
    the write to finish instead of tearing the file mid-write) and any
    exception is captured and re-raised from :meth:`result` — a failing
    shard write surfaces in the caller, it does not vanish with the
    thread.
    """

    def __init__(self, target, args=()):
        self._exc = None

        def _run():
            try:
                target(*args)
            except BaseException as e:  # re-raised in result()
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=False,
                                        name="paddle-tpu-ckpt-save")
        self._thread.start()

    def done(self):
        return not self._thread.is_alive()

    def result(self, timeout=None):
        """Wait for the save; re-raise the worker's exception if any."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"checkpoint save still running after {timeout}s")
        if self._exc is not None:
            raise self._exc

    # Thread-like aliases, as the reference keeps them
    def join(self, timeout=None):
        self.result(timeout)

    def is_alive(self):
        return self._thread.is_alive()


# -- save --------------------------------------------------------------------

class SaveStats:
    """Where one save's time went: ``snapshot_s`` (the copies to the
    host, device → host for CUDA tensors), and on the writer's side
    ``write_s`` (the bytes into the files), ``fsync_s``, ``crc_s`` (the
    crc32 sums, added over the threads that run them beside the writes)
    and ``crc_wait_s`` (the writer's wait for them); ``bytes`` is the
    array bytes written."""

    def __init__(self):
        self.snapshot_s = self.write_s = self.fsync_s = self.crc_s = 0.0
        self.crc_wait_s = 0.0
        self.bytes = 0
        self.files = 0


_last_save_stats = None


def last_save_stats():
    """Stats of the most recent ``_prepare_save`` (None before any);
    the writer fills its share as it runs."""
    return _last_save_stats


def _dtype_name(t):
    """The metadata's dtype: numpy's name, ``bfloat16`` for bf16."""
    return str(t.dtype).replace("torch.", "")


def _host_copy(value):
    """A host snapshot of one state value: a CPU tensor no later
    in-place write of the caller can reach."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(value, copy=True))


def _npy_parts(t):
    """(header bytes, array bytes) of a host tensor's ``.npy`` file as
    the reference's ``np.save`` writes it; bf16 as ``'<V2'``."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).numpy()
        header = {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(t.shape)}
    else:
        arr = t.numpy()
        header = np.lib.format.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    return buf.getvalue(), memoryview(arr.reshape(-1)).cast("B")


def _crc32_parts(parts):
    """(crc32, seconds) of a file's bytes from memory (header, then
    array): the crc a read back of the written file gives."""
    t0 = time.perf_counter()
    crc = zlib.crc32(parts[1], zlib.crc32(parts[0])) & 0xFFFFFFFF
    return crc, time.perf_counter() - t0


def _prepare_save(state_dict, path, rank=None):
    """Build one rank's write closure for ``state_dict`` -> ``path``.

    Runs EAGERLY: every tensor is copied to the host here (CUDA tensors
    device → host), so the closure holds a snapshot of the state at
    call time — handing it to a background thread cannot mix in values
    from later training steps.
    """
    global _last_save_stats
    os.makedirs(path, exist_ok=True)
    if rank is None:
        rank = 0
    stats = _last_save_stats = SaveStats()
    meta = {"format": FORMAT, "tensors": {}}
    work = []
    t0 = time.perf_counter()
    for name, value in state_dict.items():
        host = _host_copy(value)
        shape = list(host.shape)
        entry = {"global_shape": shape, "dtype": _dtype_name(host),
                 "shards": []}
        # one shard, index all slice(None): the reference's key
        # ((0, None), ...) and its file name
        key = [(0, None)] * len(shape)
        fname = (f"{name.replace('/', '_')}."
                 f"{'_'.join(f'{a}-{b}' for a, b in key) or 'full'}"
                 f".r{rank}.npy")
        shard_meta = {"file": fname, "offsets": [0] * len(shape),
                      "lengths": shape}
        entry["shards"].append(shard_meta)
        # shard_meta travels with the write job: the crc32 of the
        # on-disk bytes is stamped into it after the file lands, before
        # the (later) metadata write indexes it
        work.append((os.path.join(path, fname), host, shard_meta))
        meta["tensors"][name] = entry
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stats.snapshot_s = time.perf_counter() - t0

    meta_path = os.path.join(path, f"{rank}.metadata.json")

    def _write():
        parts = [_npy_parts(host) for _, host, _ in work]
        pool = _pool(len(work))
        try:
            crcs = [pool.submit(_crc32_parts, p) for p in parts]
            for (fpath, _, shard_meta), (head, data), crc in zip(
                    work, parts, crcs):
                faults.fire("ckpt.shard_write", "before", path=fpath)
                t1 = time.perf_counter()
                with open(fpath, "wb") as f:
                    f.write(head)
                    f.write(data)
                    f.flush()
                    t2 = time.perf_counter()
                    os.fsync(f.fileno())
                t3 = time.perf_counter()
                # the crc32 of the bytes written, stamped BEFORE the
                # after-phase fault point: a 'corrupt' fault there flips
                # a bit the crc does not cover — the bit rot a load must
                # catch
                shard_meta["crc32"], crc_s = crc.result()
                stats.crc_s += crc_s
                stats.write_s += t2 - t1
                stats.fsync_s += t3 - t2
                stats.crc_wait_s += time.perf_counter() - t3
                stats.bytes += data.nbytes
                stats.files += 1
                faults.fire("ckpt.shard_write", "after", path=fpath)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        # every rank writes its own metadata (it indexes this rank's
        # shards); load merges all *.metadata.json files
        faults.fire("ckpt.metadata", "before", path=meta_path)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fire("ckpt.metadata", "after", path=meta_path)

    return _write


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, async_save=False):
    """Write {name: tensor or array} as shard files + metadata.

    With ``async_save=True`` returns an :class:`AsyncSaveHandle`; call
    ``.result()`` to surface any write failure.  The tensors are copied
    to the host synchronously either way — only the file writes run on
    the background thread.  ``process_group`` is item 8's: passing one
    raises."""
    if process_group is not None:
        raise NotImplementedError(
            "save_state_dict(process_group=...) is not ported yet "
            "(ROADMAP.md Queue 1, item 8)")
    _write = _prepare_save(state_dict, path)
    if async_save:
        return AsyncSaveHandle(_write)
    _write()


# -- load --------------------------------------------------------------------

class LoadStats:
    """Host-allocation accounting for one ``load_state_dict`` call.

    ``peak_buffer_bytes`` is the largest single assembly buffer
    materialized; ``total_read_bytes`` the bytes assembled; ``seconds``
    the load's host wall time (checks, reads and the copies into the
    targets)."""

    def __init__(self):
        self.peak_buffer_bytes = 0
        self.total_read_bytes = 0
        self.regions = 0
        self.seconds = 0.0

    def record(self, nbytes):
        self.regions += 1
        self.total_read_bytes += nbytes
        self.peak_buffer_bytes = max(self.peak_buffer_bytes, nbytes)


_last_load_stats = None


def last_load_stats():
    """Stats of the most recent ``load_state_dict`` (None before any)."""
    return _last_load_stats


def _np_dtype(name):
    """The assembly buffer's numpy dtype: bf16 is held as int16 (its
    bytes), the reference's ``ml_dtypes`` type never needed."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


def _merge_metadata(path):
    metas = [f for f in os.listdir(path) if f.endswith("metadata.json")]
    if not metas:
        raise FileNotFoundError(f"no metadata.json under {path}")
    merged = {}
    for m in metas:
        with open(os.path.join(path, m)) as f:
            for name, entry in json.load(f)["tensors"].items():
                if name in merged:
                    # merge shard lists across ranks, dedup by offsets
                    seen = {tuple(s["offsets"])
                            for s in merged[name]["shards"]}
                    for s in entry["shards"]:
                        if tuple(s["offsets"]) not in seen:
                            merged[name]["shards"].append(s)
                            seen.add(tuple(s["offsets"]))
                else:
                    merged[name] = entry
    return merged


def _check_coverage(name, entry):
    """Verify the union of saved shard boxes covers the full global
    extent — BEFORE any target tensor is touched, so a checkpoint with a
    hole (e.g. a rank's shards lost) fails cleanly instead of filling
    part of the state with zeros."""
    gshape = entry["global_shape"]
    shards = entry["shards"]
    if not shards:
        raise ValueError(f"checkpoint entry '{name}' has no shards")
    if not gshape or int(np.prod(gshape)) == 0:
        return  # scalar / empty extent: any shard is full coverage
    ndim = len(gshape)
    # clip to the global extent and dedupe replicas, so neither overlap
    # nor out-of-range extents can ever inflate apparent coverage
    boxes = sorted({
        box for box in (
            tuple((max(0, min(o, g)), max(0, min(o + l, g)))
                  for o, l, g in zip(s["offsets"], s["lengths"], gshape))
            for s in shards)
        if all(lo < hi for lo, hi in box)})
    # coordinate compression: cells are the grid of all box edges; a
    # cell is covered iff a single box contains it wholly
    coords = []
    ncells = 1
    for d, g in enumerate(gshape):
        cs = sorted({0, g} | {b[d][0] for b in boxes}
                    | {b[d][1] for b in boxes})
        coords.append(cs)
        ncells *= len(cs) - 1
    dims = [len(c) - 1 for c in coords]

    def _uncovered(lo, hi):
        raise ValueError(
            f"checkpoint entry '{name}' does not cover region "
            f"{list(zip(lo, hi))} of global shape {gshape} — torn or "
            f"partial checkpoint?")

    if ncells <= (1 << 24):
        # exact: mark every cell each box covers; overlapping boxes just
        # mark twice, they can never mask a hole
        grid = np.zeros(dims, dtype=bool)
        for b in boxes:
            grid[tuple(slice(bisect.bisect_left(coords[d], b[d][0]),
                             bisect.bisect_left(coords[d], b[d][1]))
                       for d in range(ndim))] = True
        if not grid.all():
            cell = np.unravel_index(int(np.argmin(grid)), grid.shape)
            _uncovered([coords[d][i] for d, i in enumerate(cell)],
                       [coords[d][i + 1] for d, i in enumerate(cell)])
        return
    # astronomically many cells: deterministically sample cell midpoints
    # (evenly strided over the compressed grid) and test containment
    lows = np.array([[b[d][0] for d in range(ndim)] for b in boxes])
    highs = np.array([[b[d][1] for d in range(ndim)] for b in boxes])
    nsamples = max(1024, (1 << 26) // max(1, len(boxes)))
    stride = max(1, ncells // nsamples)
    for lin in range(0, ncells, stride):
        rem, cell = lin, []
        for n in reversed(dims):
            cell.append(rem % n)
            rem //= n
        cell.reverse()
        lo = np.array([coords[d][i] for d, i in enumerate(cell)])
        hi = np.array([coords[d][i + 1] for d, i in enumerate(cell)])
        if not np.any(np.all((lows <= lo) & (hi <= highs), axis=1)):
            _uncovered(lo.tolist(), hi.tolist())


def _read_region(path, entry, region, stats):
    """Assemble one rectangular region of a tensor from the shard files
    that intersect it.  Files are memory-mapped; only the intersection
    bytes are copied, so peak host allocation ≈ region bytes."""
    dtype = _np_dtype(entry["dtype"])
    shape = tuple(r.stop - r.start for r in region)
    buf = np.zeros(shape, dtype)
    stats.record(buf.nbytes if buf.nbytes else dtype.itemsize)
    for shard in entry["shards"]:
        offs, lens = shard["offsets"], shard["lengths"]
        inter = []
        empty = False
        for r, o, l in zip(region, offs, lens):
            lo, hi = max(r.start, o), min(r.stop, o + l)
            if lo >= hi:
                empty = True
                break
            inter.append((lo, hi))
        if empty and region:
            continue
        fpath = os.path.join(path, shard["file"])
        try:
            mm = np.load(fpath, mmap_mode="r", allow_pickle=False)
        except (ValueError, OSError):
            # some dtypes (or filesystems) refuse to mmap: read the file
            mm = np.load(fpath, allow_pickle=False)
        if not region:  # scalar
            buf[()] = np.asarray(mm).view(dtype).reshape(())
            del mm
            break
        src = tuple(slice(lo - o, hi - o)
                    for (lo, hi), o in zip(inter, offs))
        dst = tuple(slice(lo - r.start, hi - r.start)
                    for (lo, hi), r in zip(inter, region))
        piece = np.asarray(mm[src])
        if piece.dtype != dtype:
            # bf16 round-trips through .npy as raw void bytes ('V2'):
            # reinterpret instead of casting
            if piece.dtype.itemsize == dtype.itemsize:
                piece = piece.view(dtype)
            else:
                piece = piece.astype(dtype)
        buf[dst] = piece
        del mm
    return buf


def _to_tensor(buf, dtype_name):
    """A host tensor over the assembled buffer, bf16 from its bytes."""
    t = torch.from_numpy(buf)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _validate(state_dict, merged):
    """Every requested name must exist, match shape, and be fully
    covered by shards — checked before ANY tensor is mutated, so a
    failed load leaves ``state_dict`` untouched."""
    missing = [name for name in state_dict if name not in merged]
    if missing:
        raise KeyError(f"checkpoint missing tensors: {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")
    for name, target in state_dict.items():
        entry = merged[name]
        tshape = tuple(getattr(target, "shape", ()) or ())
        gshape = tuple(entry["global_shape"])
        if hasattr(target, "shape") and tshape != gshape:
            raise ValueError(
                f"shape mismatch for '{name}': checkpoint has "
                f"{list(gshape)}, target has {list(tshape)}")
        _check_coverage(name, entry)


def _verify_checksums(state_dict, merged, path):
    """Compare each referenced shard file's crc32 against the value
    recorded at save time.  Runs before ANY tensor is mutated, so a
    corrupt shard fails the load with the target state untouched.
    Shards without a recorded crc32 (pre-checksum checkpoints) are
    skipped.  Each file is read once (streaming, ~1 MiB buffer), files
    side by side on a few threads; the first mismatch in the reference's
    order is the one reported."""
    checks = [(name, shard) for name in state_dict
              for shard in merged[name]["shards"]
              if shard.get("crc32") is not None]
    files = list(dict.fromkeys(shard["file"] for _, shard in checks))
    with _pool(len(files)) as pool:
        seen = dict(zip(files, pool.map(
            lambda f: _crc32_file(os.path.join(path, f)), files)))
    for name, shard in checks:
        want, fname = int(shard["crc32"]), shard["file"]
        got = seen[fname]
        if got != want:
            raise ChecksumError(
                f"checkpoint shard file '{fname}' (tensor '{name}') "
                f"is corrupt: metadata crc32 {want:#010x} != "
                f"on-disk {got:#010x} — silent bit rot; no target "
                f"state was modified")


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, offload=False, verify=True):
    """Fill ``state_dict``'s entries from a checkpoint directory.

    A ``torch.Tensor`` target (any device, any dtype) is filled in place
    (``copy_``, a cast where the dtypes differ); any other entry is
    replaced by a CPU tensor of the checkpoint's dtype.  Names, shapes
    and coverage are validated, and with ``verify`` (default) every
    referenced file's crc32 checked (:class:`ChecksumError`), *before*
    anything is written — a failing load never half-applies."""
    global _last_load_stats
    if process_group is not None:
        raise NotImplementedError(
            "load_state_dict(process_group=...) is not ported yet "
            "(ROADMAP.md Queue 1, item 8)")
    t0 = time.perf_counter()
    merged = _merge_metadata(path)
    _validate(state_dict, merged)
    if verify:
        _verify_checksums(state_dict, merged, path)
    stats = LoadStats()
    for name, target in state_dict.items():
        entry = merged[name]
        region = tuple(slice(0, g) for g in entry["global_shape"])
        full = _to_tensor(_read_region(path, entry, region, stats),
                          entry["dtype"])
        if isinstance(target, torch.Tensor):
            with torch.no_grad():
                target.copy_(full)
        else:
            state_dict[name] = full
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stats.seconds = time.perf_counter() - t0
    _last_load_stats = stats
    return state_dict
