"""``io`` of the PyTorch port against ``paddle_tpu``.

Every batch equal bit for bit (values and dtypes) between the two
packages' loaders over the same datasets; samplers in the same order
from the same numpy seed (both draw from numpy's global RNG); the
worker pool's failures (a worker's exception, a timeout, a killed
worker) as the reference reports them, message text included
(counterparts of ``tests/test_dataloader_hardening.py:54-128``); the
``io.worker`` fault point hit for hit with the reference; counterparts
of ``tests/test_nn_optimizer.py:230-269``.  Loaders here name the CPU
(``places="cpu"``); the default is CUDA.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.io as jio
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.testing import faults as pfaults


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("PT_FAULTS", raising=False)
    jfaults.disarm_all()
    pfaults.disarm_all()
    yield
    jfaults.disarm_all()
    pfaults.disarm_all()


def _host(b):
    if isinstance(b, (list, tuple)):
        return [_host(x) for x in b]
    if isinstance(b, dict):
        return {k: _host(v) for k, v in b.items()}
    if isinstance(b, torch.Tensor):
        assert b.device.type == "cpu"
        return b.numpy()
    if hasattr(b, "_data"):
        return np.asarray(jnp.asarray(b._data))
    return b


def _equal(got, want):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


def _both(make_ds, seed=0, **kw):
    """Every batch of both packages' loaders from one numpy seed."""
    np.random.seed(seed)
    want = list(jio.DataLoader(make_ds(jio), **kw))
    np.random.seed(seed)
    got = list(pio.DataLoader(make_ds(pio), places="cpu", **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _equal(g, w)
    return got


def _xy(n=22):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.int64)
    return x, y


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=5, shuffle=True),
    dict(batch_size=3, shuffle=True, num_workers=2, timeout=60)],
    ids=["seq", "drop_last", "shuffle", "workers"])
def test_tensor_dataset_batches_equal(kw):
    x, y = _xy()
    _both(lambda io: io.TensorDataset([x, y]), **kw)


class _Dicts:
    def __init__(self, base):
        class D(base.Dataset):
            def __len__(self):
                return 10

            def __getitem__(self, i):
                return {"img": np.full((2, 2), i, np.float32),
                        "label": i % 3, "w": float(i) / 7}
        self.cls = D


def test_collate_dicts_and_numbers():
    _both(lambda io: _Dicts(io).cls(), batch_size=4)


def test_compose_concat_subset_datasets():
    x, y = _xy(12)

    def compose(io):
        return io.ComposeDataset([io.TensorDataset([x]),
                                  io.TensorDataset([y])])

    def concat(io):
        return io.ConcatDataset([io.TensorDataset([x[:5], y[:5]]),
                                 io.TensorDataset([x[5:], y[5:]])])

    def subset(io):
        return io.Subset(io.TensorDataset([x, y]), [3, 1, 4, 1, 5, 9, 2])

    for make in (compose, concat, subset):
        _both(make, batch_size=3)
    with pytest.raises(IndexError, match="out of range: 12 for length 12"):
        concat(pio)[12]
    assert concat(pio)[-1][1] == concat(jio)[-1][1] == 11


def test_random_split_same_subsets():
    x, y = _xy(20)
    np.random.seed(5)
    want = jio.random_split(jio.TensorDataset([x, y]), [0.7, 0.3])
    np.random.seed(5)
    got = pio.random_split(pio.TensorDataset([x, y]), [0.7, 0.3])
    assert [s.indices for s in got] == [s.indices for s in want]


def test_samplers_same_order_from_one_seed():
    x, _ = _xy(30)
    for make in (
            lambda io: io.RandomSampler(list(range(30))),
            lambda io: io.RandomSampler(list(range(30)), replacement=True,
                                        num_samples=12),
            lambda io: io.SubsetRandomSampler([2, 4, 6, 8, 10]),
            lambda io: io.WeightedRandomSampler(np.linspace(0.1, 1, 30), 9),
            lambda io: io.SequenceSampler(x),
            lambda io: io.BatchSampler(x, shuffle=True, batch_size=7),
            lambda io: io.DistributedBatchSampler(x, 4, shuffle=True),
            lambda io: io.DistributedBatchSampler(x, 4, drop_last=True)):
        np.random.seed(11)
        want = [list(make(jio)) for _ in range(2)]
        np.random.seed(11)
        got = [list(make(pio)) for _ in range(2)]
        assert got == want
        assert len(make(pio)) == len(make(jio))


def test_distributed_sampler_more_ranks_names_item_8():
    with pytest.raises(NotImplementedError, match="item 8"):
        pio.DistributedBatchSampler(list(range(8)), 2, num_replicas=2,
                                    rank=0)


def test_iterable_and_chain_datasets():
    def chain(io):
        class It(io.IterableDataset):
            def __init__(self, lo, hi):
                self.lo, self.hi = lo, hi

            def __iter__(self):
                for i in range(self.lo, self.hi):
                    yield np.full((2,), i, np.float32)
        return io.ChainDataset([It(0, 5), It(5, 11)])
    _both(chain, batch_size=4)
    loader = pio.DataLoader(chain(pio), batch_size=4, drop_last=True,
                            places="cpu")
    assert len(list(loader)) == 2
    with pytest.raises(TypeError):
        len(loader)


def test_default_device_is_cuda():
    x, y = _xy(4)
    if torch.cuda.is_available():
        b = next(iter(pio.DataLoader(pio.TensorDataset([x, y]),
                                     batch_size=2)))
        assert b[0].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pio.DataLoader(pio.TensorDataset([x, y]), batch_size=2)


def test_pack_sequences_names_item_9():
    with pytest.raises(NotImplementedError, match="item 9"):
        pio.pack_sequences([[1, 2]], 4)


# -- the worker pool: counterparts of tests/test_dataloader_hardening.py --------

class _ArrDataset(pio.Dataset):
    def __init__(self, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return np.full((3,), idx, np.float32)


class _BadIndexDataset(_ArrDataset):
    def __getitem__(self, idx):
        if idx == 7:
            raise ValueError("sample 7 is corrupt")
        return super().__getitem__(idx)


class _SlowIndexDataset(_ArrDataset):
    def __getitem__(self, idx):
        if idx == 5:
            time.sleep(2.0)
        return super().__getitem__(idx)


class _PidDataset(_ArrDataset):
    def __getitem__(self, idx):
        return np.asarray([os.getpid()], np.int64)


def _loader(ds, **kw):
    """A CPU loader; a worker that never answers fails the test within a
    minute instead of hanging it."""
    return pio.DataLoader(ds, places="cpu", **dict(dict(timeout=60), **kw))


def test_worker_exception_names_failing_batch_indices():
    loader = _loader(_BadIndexDataset(), batch_size=4, num_workers=2)
    with pytest.raises(pio.DataLoaderWorkerError) as ei:
        list(loader)
    assert 7 in ei.value.indices
    assert str(ei.value) == ("DataLoader worker raised ValueError: sample 7 "
                             "is corrupt while fetching batch indices "
                             "[4, 5, 6, 7]")
    assert isinstance(ei.value.__cause__, ValueError)


def test_timeout_honored_instead_of_hang():
    loader = _loader(_SlowIndexDataset(), batch_size=4, num_workers=2,
                     timeout=0.3)
    t0 = time.time()
    with pytest.raises(pio.DataLoaderWorkerError) as ei:
        list(loader)
    assert time.time() - t0 < 5.0
    assert ei.value.timed_out
    assert 5 in ei.value.indices
    assert str(ei.value) == ("DataLoader worker timed out while fetching "
                             "batch indices [4, 5, 6, 7]")


def test_worker_killed_mid_epoch_raises_named_error_not_hang():
    pfaults.reset("io.worker:before:2=crash")
    loader = _loader(_ArrDataset(n=32), batch_size=2, num_workers=2,
                     timeout=1.5)
    t0 = time.time()
    with pytest.raises(pio.DataLoaderWorkerError) as ei:
        list(loader)
    assert time.time() - t0 < 20.0
    assert ei.value.indices
    assert "batch indices" in str(ei.value)


def test_persistent_workers_reuse_pool_across_epochs():
    loader = _loader(_PidDataset(n=8), batch_size=2, num_workers=2,
                     persistent_workers=True)
    epoch1 = {int(b.numpy().ravel()[0]) for b in loader}
    pool1 = loader._pool
    assert pool1 is not None
    pool_pids = {p.pid for p in pool1._pool}
    epoch2 = {int(b.numpy().ravel()[0]) for b in loader}
    assert loader._pool is pool1
    assert {p.pid for p in pool1._pool} == pool_pids
    assert epoch1 <= pool_pids and epoch2 <= pool_pids
    del loader


def test_nonpersistent_loader_forks_fresh_pool_each_epoch():
    loader = _loader(_PidDataset(n=8), batch_size=2, num_workers=2)
    epoch1 = {int(b.numpy().ravel()[0]) for b in loader}
    epoch2 = {int(b.numpy().ravel()[0]) for b in loader}
    assert loader._pool is None
    assert epoch1.isdisjoint(epoch2)


def test_persistent_pool_replaced_after_worker_failure():
    loader = _loader(_BadIndexDataset(), batch_size=4, num_workers=2,
                     persistent_workers=True)
    with pytest.raises(pio.DataLoaderWorkerError):
        list(loader)
    assert loader._pool is None
    loader.dataset = _ArrDataset()
    assert len(list(loader)) == 6


def test_numpy_batches_from_workers_equal_tensor_batches():
    """A collate_fn that returns numpy arrays sends them down the pool's
    pipe (tensors go through shared memory); the parent's batches are
    the same tensors either way."""
    x, y = _xy()
    ds = pio.TensorDataset([x, y])

    def as_numpy(batch):
        return [t.numpy() for t in pio.default_collate_fn(batch)]

    runs = []
    for cf in (None, as_numpy):
        np.random.seed(2)
        runs.append(list(_loader(ds, batch_size=3, shuffle=True,
                                 num_workers=2, collate_fn=cf)))
    assert len(runs[0]) == len(runs[1]) == 8
    for a, b in zip(*runs):
        assert all(isinstance(t, torch.Tensor) for t in a + b)
        _equal(b, a)


def test_persistent_pool_replaced_when_dataset_changes():
    """A pool serves the dataset it forked with: a persistent loader
    given another dataset forks anew, and its batches are the new
    dataset's."""
    loader = _loader(_ArrDataset(n=8), batch_size=4, num_workers=2,
                     persistent_workers=True)
    assert [b[0, 0].item() for b in loader] == [0.0, 4.0]
    pool1 = loader._pool
    loader.dataset = _PidDataset(n=8)
    pids = {int(b.numpy().ravel()[0]) for b in loader}
    assert loader._pool is not pool1
    assert pids <= {p.pid for p in loader._pool._pool}
    del loader


def test_mp_iter_del_after_failed_init_is_silent():
    it = pio._MPWorkerIter.__new__(pio._MPWorkerIter)
    it.__del__()


@pytest.mark.parametrize("spec", ["io.worker:before:3=raise",
                                  "io.worker:after:2=raise",
                                  "io.worker:before:*=delay:0.01"])
def test_io_worker_fault_point_hit_for_hit(spec):
    """One worker takes every batch in order, so the armed hit falls on
    the same batch in both packages: the same indices in the error, or
    the same batches through a delay."""
    x, y = _xy(16)
    res = {}
    for name, io, fl in (("ref", jio, jfaults), ("port", pio, pfaults)):
        fl.reset(spec)
        kw = {} if io is jio else {"places": "cpu"}
        loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=3,
                               num_workers=1, timeout=60, **kw)
        try:
            res[name] = [_host(b) for b in loader]
        except io.DataLoaderWorkerError as e:
            res[name] = (e.indices, str(e))
        fl.disarm_all()
    if isinstance(res["ref"], tuple):
        assert res["port"] == res["ref"]
        assert "InjectedFault" in res["port"][1]
    else:
        assert len(res["port"]) == len(res["ref"]) == 6
        for g, w in zip(res["port"], res["ref"]):
            _equal(g, w)


# -- counterparts of tests/test_nn_optimizer.py:230-269 ------------------------

def test_dataloader():
    xs = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ys = torch.arange(10)
    loader = pio.DataLoader(pio.TensorDataset([xs, ys]), batch_size=4,
                            drop_last=False, places="cpu")
    batches = list(loader)
    assert len(batches) == 3
    xb, yb = batches[0]
    assert list(xb.shape) == [4, 2] and list(yb.shape) == [4]


def test_mnist_style_training_loop():
    """The minimum end-to-end slice: a small MLP classifier converges
    through the loader, Adam and the cross entropy."""
    rng = np.random.RandomState(1)
    n = 128
    x_np = rng.randn(n, 10).astype(np.float32)
    w = rng.randn(10, 3).astype(np.float32)
    labels = (x_np @ w).argmax(-1)
    gen = torch.Generator().manual_seed(1)
    model = pnn.Sequential(pnn.Linear(10, 32, device="cpu"),
                           pnn.ReLU(),
                           pnn.Linear(32, 3, device="cpu"))
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=gen)
    opt = popt.Adam(learning_rate=0.01, parameters=model.parameters())
    loader = pio.DataLoader(pio.TensorDataset([x_np, labels]),
                            batch_size=n, places="cpu")
    first = None
    for _ in range(60):
        for xb, yb in loader:
            loss = PF.cross_entropy(model(xb), yb)
            first = first if first is not None else loss.item()
            loss.backward()
            opt.step()
            opt.clear_grad()
    assert loss.item() < first * 0.5
    acc = (model(torch.from_numpy(x_np)).argmax(-1).numpy()
           == labels).mean()
    assert acc > 0.8
