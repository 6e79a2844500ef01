"""Datasets, samplers and the ``DataLoader``.  Counterpart of
``paddle_tpu/io/__init__.py``: ``Dataset``, ``IterableDataset``,
``TensorDataset``, ``ComposeDataset``, ``ChainDataset``,
``ConcatDataset``, ``Subset``, ``random_split``, the samplers,
``BatchSampler``, ``DistributedBatchSampler`` (one rank),
``default_collate_fn``, ``DataLoader`` and ``DataLoaderWorkerError``.

The random samplers draw from numpy's global RNG, as the reference's
do, so one ``np.random.seed`` gives both packages the same order.

``num_workers > 0`` forks a ``multiprocessing`` pool fed batch by batch,
with a prefetch of ``2 * num_workers`` batches, as the reference does;
the workers find the dataset in the memory they forked with, so a task
carries its indices only.
The loader's parent process may hold a CUDA context, so a worker never
touches CUDA: it fetches the samples and collates them on the host, with
one torch thread, into CPU tensors, which reach the parent through
shared memory (torch's pickling of its tensors for ``multiprocessing``;
numpy arrays, which a ``collate_fn`` may return, go down the pool's
pipe, 7x slower an epoch at 154 MB a batch: PERF.md); the parent moves
each batch to the loader's device (``places``; CUDA unless the caller
names the CPU, see ``device.resolve_device``).  A
worker that raises, or a batch that does not come within ``timeout``
seconds (a killed worker's never does), ends the epoch with a
``DataLoaderWorkerError`` naming the batch's indices; a broken
persistent pool is dropped and the next epoch forks a new one.  The
fault point ``io.worker`` fires before and after each fetch in the
worker (``testing/faults.py``).  There is no fallback: the loader never
drops to ``num_workers=0`` by itself.

``pack_sequences`` needs the reference's native core and raises
(ROADMAP.md Queue 1, item 9); a ``DistributedBatchSampler`` of more than
one rank raises (item 8).
"""
from __future__ import annotations

import bisect
import itertools
import multiprocessing as mp

import numpy as np
import torch

from ..device import resolve_device


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or CPU tensors."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Map-style datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self._offsets = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self._offsets.append(total)

    def __len__(self):
        return self._offsets[-1]

    def __getitem__(self, idx):
        n = len(self)
        orig = idx
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(
                f"ConcatDataset index out of range: {orig} for "
                f"length {n}")
        di = bisect.bisect_right(self._offsets, idx)
        prev = 0 if di == 0 else self._offsets[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions) over one permutation
    from numpy's global RNG."""
    total = len(dataset)
    if all(isinstance(v, float) for v in lengths):
        lengths = [int(round(total * v)) for v in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    perm = np.random.permutation(total).tolist()
    out = []
    offset = 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


# -- samplers ---------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A random permutation of a fixed index subset."""

    def __init__(self, indices):
        if len(indices) == 0:
            raise ValueError(
                "SubsetRandomSampler requires a non-empty indices")
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter(self.indices[i] for i in order)

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """The reference's per-rank sharding, as rank 0 of 1: the indices
    padded to a multiple of the ranks, shuffled by
    ``RandomState(epoch)``.  More than one rank raises (ROADMAP.md Queue
    1, item 8)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        num_replicas = 1 if num_replicas is None else num_replicas
        rank = 0 if rank is None else rank
        if num_replicas != 1:
            raise NotImplementedError(
                "DistributedBatchSampler over more than one rank is not "
                "ported yet (ROADMAP.md Queue 1, item 8)")
        if not (0 <= rank < num_replicas):
            raise ValueError(
                f"rank {rank} out of range for num_replicas "
                f"{num_replicas}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# -- collate and device transfer ----------------------------------------------

def default_collate_fn(batch):
    """Stack a list of samples into host (CPU) tensors: tensors and
    arrays stacked, numbers into one array, tuples and lists per field,
    dicts per key; anything else is returned as the list it is.  numpy
    dtypes are kept."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return [default_collate_fn(list(col)) for col in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch])
                for k in sample}
    return batch


def _map(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _to_device(device):
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x
    return move


class DataLoaderWorkerError(RuntimeError):
    """A pool worker failed (or timed out) while producing one batch;
    the message names the batch's indices."""

    def __init__(self, indices, cause, timed_out=False):
        self.indices = list(indices)
        self.timed_out = timed_out
        what = ("timed out" if timed_out
                else f"raised {type(cause).__name__}: {cause}")
        super().__init__(
            f"DataLoader worker {what} while fetching batch indices "
            f"{self.indices}")
        self.__cause__ = cause


#: {pool token: (dataset, collate_fn)} as they were when the pool
#: forked: a worker finds them here, in its copy of the parent's memory,
#: so a task carries its indices only (pickling the dataset with every
#: task, as the reference does, sends the whole dataset down a pipe per
#: batch).  A pool serves the dataset it forked with: a persistent pool
#: whose loader has been given another dataset or collate_fn since is
#: replaced (``DataLoader._acquire_pool``).
_FORKED = {}
_TOKENS = itertools.count()


def _worker_init():
    torch.set_num_threads(1)


def _worker_fn(token, indices):
    from ..testing import faults

    dataset, collate_fn = _FORKED[token]
    faults.fire("io.worker", "before")
    batch = [dataset[i] for i in indices]
    out = collate_fn(batch)
    faults.fire("io.worker", "after")
    return out


class _MPWorkerIter:
    """Index batches -> worker pool -> results in order (the reference's
    ``_MPWorkerIter``): the wait for each batch honours the loader's
    ``timeout``, a worker's exception or a timeout tears the pool down
    and raises ``DataLoaderWorkerError``, and with
    ``persistent_workers=True`` the pool is the loader's, reused across
    epochs."""

    def __init__(self, loader):
        self.loader = loader
        self.persistent = loader.persistent_workers
        self.pool = loader._acquire_pool()
        self.timeout = loader.timeout if loader.timeout else None
        self.batches = iter(loader.batch_sampler)
        self.pending = []  # (AsyncResult, indices)
        self.prefetch = max(2 * loader.num_workers, 2)
        self._move = _to_device(loader.device)
        self._finished = False
        self._prime()

    def _prime(self):
        for _ in range(self.prefetch):
            self._submit()

    def _submit(self):
        try:
            indices = next(self.batches)
        except StopIteration:
            return
        token = self.loader._tokens[id(self.pool)]
        self.pending.append(
            (self.pool.apply_async(_worker_fn, (token, indices)),
             list(indices)))

    def __next__(self):
        if not self.pending:
            self._finish()
            raise StopIteration
        result, indices = self.pending.pop(0)
        try:
            batch = result.get(self.timeout)
        except mp.TimeoutError as e:
            self._abort()
            raise DataLoaderWorkerError(indices, e, timed_out=True) \
                from e
        except Exception as e:
            self._abort()
            raise DataLoaderWorkerError(indices, e) from e
        self._submit()
        return _map(self._move, batch)

    def _finish(self):
        """Normal exhaustion: keep a persistent pool; close and join
        another here, at the end of its epoch (left to the garbage
        collector, its finalizer joins the workers wherever the
        collection happens to run)."""
        if self._finished:
            return
        self._finished = True
        if not self.persistent:
            self.pool.close()
            self.pool.join()
            self.loader._forget(self.pool)

    def _abort(self):
        """A worker died or hung: tear the pool down (a persistent loader
        forks a new one next epoch)."""
        self._finished = True
        try:
            self.pool.terminate()
        except Exception:
            pass
        self.loader._forget(self.pool)
        if self.persistent:
            self.loader._release_pool(self.pool)

    def __iter__(self):
        return self

    def __del__(self):
        # __init__ may have raised before these were set
        if getattr(self, "_finished", True) \
                or getattr(self, "persistent", True):
            return
        try:
            self.pool.terminate()
        except Exception:
            pass
        self.loader._forget(self.pool)


class DataLoader:
    """Batches of ``dataset`` on ``places`` (CUDA unless the caller names
    the CPU): in this process with ``num_workers=0``, else from a forked
    pool (the module docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if isinstance(places, (list, tuple)):
            places = places[0]
        self.device = resolve_device(places)
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.return_list = return_list
        self.timeout = timeout
        self.persistent_workers = persistent_workers
        self._pool = None
        self._tokens = {}       # id(pool) -> its _FORKED token
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _forked_state(self):
        return (self.dataset, self.collate_fn or default_collate_fn)

    def _new_pool(self):
        token = next(_TOKENS)
        _FORKED[token] = self._forked_state()
        try:
            pool = mp.get_context("fork").Pool(self.num_workers,
                                               initializer=_worker_init)
        except BaseException:
            del _FORKED[token]
            raise
        self._tokens[id(pool)] = token
        return pool

    def _forget(self, pool):
        """Drop the parent's reference for a pool that is gone."""
        _FORKED.pop(getattr(self, "_tokens", {}).pop(id(pool), None), None)

    def _acquire_pool(self):
        if not self.persistent_workers:
            return self._new_pool()
        if self._pool is not None:
            forked = _FORKED.get(self._tokens.get(id(self._pool)))
            if forked is None or any(
                    a is not b for a, b in zip(forked,
                                               self._forked_state())):
                # forked with another dataset or collate_fn
                pool, self._pool = self._pool, None
                pool.terminate()
                self._forget(pool)
        if self._pool is None:
            self._pool = self._new_pool()
        return self._pool

    def _release_pool(self, pool):
        """Drop a broken persistent pool so the next epoch forks anew."""
        if self._pool is pool:
            self._pool = None

    def __del__(self):
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            try:
                pool.terminate()
            except Exception:
                pass
            self._forget(pool)

    def __iter__(self):
        if self.batch_sampler is None:
            return self._iter_iterable()
        if self.num_workers > 0:
            return _MPWorkerIter(self)
        return self._iter_single()

    def _iter_single(self):
        cf = self.collate_fn or default_collate_fn
        move = _to_device(self.device)
        for indices in self.batch_sampler:
            yield _map(move, cf([self.dataset[i] for i in indices]))

    def _iter_iterable(self):
        cf = self.collate_fn or default_collate_fn
        move = _to_device(self.device)
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield _map(move, cf(batch))
                batch = []
        if batch and not self.drop_last:
            yield _map(move, cf(batch))

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


def get_worker_info():
    return None


def pack_sequences(docs, seq_len, pad=0, strategy="ffd"):
    raise NotImplementedError(
        "io.pack_sequences needs the native core, which is not ported yet "
        "(ROADMAP.md Queue 1, item 9)")
