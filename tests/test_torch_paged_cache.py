"""``PagedKVCache`` of the PyTorch port against ``paddle_tpu``'s.

The same sequence of operations (allocate, write_at, append, reserve,
free, gather_dense, attend) runs on both caches with the same numpy
inputs.  The host state must be EQUAL (page tables, lengths, the free
list) and the gathered K/V bit-equal (fp32 copies).  Decode attention
through ``attend`` agrees within atol 2e-5 (fp32 accumulation in
another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.paged import PagedKVCache as JaxCache
from paddle_tpu_torch.inference.paged import PagedKVCache as TorchCache

L, KV, D, PS = 2, 2, 8, 4
KW = dict(n_layers=L, n_kv_heads=KV, head_dim=D, page_size=PS,
          max_seqs=3, max_pages_per_seq=4)


def _pair(num_pages):
    return (JaxCache(num_pages=num_pages, dtype=jnp.float32, **KW),
            TorchCache(num_pages=num_pages, dtype=torch.float32,
                       device="cpu", **KW))


def _kv(rng, T):
    return (rng.randn(L, KV, T, D).astype(np.float32),
            rng.randn(L, KV, T, D).astype(np.float32))


def _assert_host_equal(jc, tc):
    np.testing.assert_array_equal(jc.page_table, tc.page_table)
    np.testing.assert_array_equal(jc.lengths, tc.lengths)
    assert jc._free == tc._free
    assert jc.free_slots == tc.free_slots


def _assert_gather_equal(jc, tc, seq):
    jk, jv = jc.gather_dense(seq)
    tk, tv = tc.gather_dense(seq)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def _both(jc, tc, op, *args):
    """Apply one operation to both caches with the same numpy args."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) and a.ndim == 4
             else a for a in args]
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray)
             and a.ndim == 4 else a for a in args]
    return getattr(jc, op)(*jargs), getattr(tc, op)(*targs)


def test_operation_sequence_matches_jax_cache():
    rng = np.random.RandomState(0)
    jc, tc = _pair(num_pages=12)
    s0, t0 = _both(jc, tc, "allocate")
    s1, t1 = _both(jc, tc, "allocate")
    assert (s0, s1) == (t0, t1)
    _both(jc, tc, "write_at", s0, *_kv(rng, 6), 0)          # mid-page end
    _both(jc, tc, "write_at", s0, *_kv(rng, 3), 6)          # crosses a page
    _both(jc, tc, "write_at", s1, *_kv(rng, 5), 0)
    _both(jc, tc, "append", [s0, s1], *_kv(rng, 2))
    _both(jc, tc, "reserve", [s0, s1], 3)
    _assert_host_equal(jc, tc)
    for s in (s0, s1):
        _assert_gather_equal(jc, tc, s)
    _both(jc, tc, "free", s0)
    s2, t2 = _both(jc, tc, "allocate")
    assert s2 == t2
    _both(jc, tc, "write_at", s2, *_kv(rng, 7), 0)
    _both(jc, tc, "append", [s1, s2], *_kv(rng, 2))
    _assert_host_equal(jc, tc)
    for s in (s1, s2):
        _assert_gather_equal(jc, tc, s)

    q = rng.randn(2, 4, D).astype(np.float32)                # H=4: GQA 2
    for layer in range(L):
        want = np.asarray(jc.attend(layer, jnp.asarray(q), [s1, s2]))
        got = tc.attend(layer, torch.from_numpy(q), [s1, s2]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_exhausted_reserve_mutates_nothing():
    rng = np.random.RandomState(1)
    jc, tc = _pair(num_pages=5)
    s0, _ = _both(jc, tc, "allocate")
    s1, _ = _both(jc, tc, "allocate")
    _both(jc, tc, "write_at", s0, *_kv(rng, 8), 0)           # 2 pages
    _both(jc, tc, "write_at", s1, *_kv(rng, 7), 0)           # 2 pages
    table, lengths, free = (tc.page_table.copy(), tc.lengths.copy(),
                            list(tc._free))
    # s0 needs 2 more pages and s1 1 more: 3 > the 1 free page; a
    # per-sequence loop would have given s0 the last page before failing
    for c in (jc, tc):
        with pytest.raises(RuntimeError, match="KV page pool exhausted"):
            c.reserve([s0, s1], [5, 5])
    np.testing.assert_array_equal(tc.page_table, table)
    np.testing.assert_array_equal(tc.lengths, lengths)
    assert tc._free == free
    _assert_host_equal(jc, tc)
    _both(jc, tc, "write_at", s1, *_kv(rng, 1), 7)           # fills page 2
    _both(jc, tc, "reserve", [s1], 1)                         # takes the last
    table, lengths, free = (tc.page_table.copy(), tc.lengths.copy(),
                            list(tc._free))
    pools = (tc.k_pages.clone(), tc.v_pages.clone())
    for c, k in ((jc, jnp.zeros((L, KV, 2, D))),
                 (tc, torch.zeros(L, KV, 2, D))):
        # s0 crosses into a third page: nothing is free any more
        with pytest.raises(RuntimeError, match="KV page pool exhausted"):
            c.append([s0, s1], k, k)
    np.testing.assert_array_equal(tc.page_table, table)
    np.testing.assert_array_equal(tc.lengths, lengths)
    assert tc._free == free
    assert torch.equal(tc.k_pages, pools[0])
    assert torch.equal(tc.v_pages, pools[1])
    _assert_host_equal(jc, tc)


def test_gather_dense_refuses_unset_slot():
    jc, tc = _pair(num_pages=8)
    for c in (jc, tc):
        s = c.allocate()
        c.lengths[s] = 3          # a length with no page behind it
        with pytest.raises(RuntimeError, match="unset"):
            c.gather_dense(s)
