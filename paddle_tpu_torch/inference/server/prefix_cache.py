"""Shared-prefix KV cache: radix tree over token-id page runs.

The RadixAttention insight (SGLang) married to vLLM-style block
sharing: at millions-of-users scale most prompts share long common
prefixes (system prompts, few-shot templates, multi-turn history), so
their KV pages should be computed once and attached by reference.

Structure: a radix tree whose nodes own PAGE-ALIGNED token spans (a
run of one or more full pages) plus the page ids holding their KV.
Children are keyed by the full first-page token tuple, so descending
one edge certifies an exact full-page match; divergence *inside* a
page is handled by a partial attach of that page — the consumer's
first write to it copy-on-writes (see ``PagedKVCache.make_writable``).

Ownership: the tree holds ONE refcount on every page it indexes, on
top of whatever slots reference it, so ``PagedKVCache.free`` on a
finished sequence leaves shared pages alive.  Eviction is LRU over
zero-refcount leaves — nodes whose pages nobody but the tree holds
(``page_refs == 1``) and that have no children — and is driven by the
pool's ``reclaimer`` hook whenever an allocation would otherwise
raise pool-exhausted.

Counterpart of ``paddle_tpu/inference/server/prefix_cache.py``: a copy
of the whole module, held by the port, which imports nothing of the JAX
package.  The tree is host-only; the pages it indexes live in the
port's :class:`~paddle_tpu_torch.inference.paged.PagedKVCache`.

Fault point: ``prefix.evict`` brackets one LRU leaf eviction
(``prefix.match`` fires in the scheduler's admission, ``prefix.cow`` in
the page pool's copy-on-write).
"""
from __future__ import annotations

import numpy as np

from ...testing import faults


class _Node:
    """One radix-tree node: a page-aligned token span and its pages.

    ``tokens`` is an int32 array of ``len(pages) * page_size`` token
    ids; ``children`` maps the first-page token tuple of each child
    span to the child node.  The root is a sentinel with an empty span.
    """

    __slots__ = ("tokens", "pages", "children", "parent", "last_access")

    def __init__(self, tokens, pages, parent, last_access):
        self.tokens = tokens
        self.pages = list(pages)
        self.children = {}
        self.parent = parent
        self.last_access = last_access

    def __repr__(self):
        return (f"_Node(pages={self.pages}, "
                f"children={len(self.children)})")


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.asarray(a[:n]) != np.asarray(b[:n])
    idx = int(np.argmax(neq))
    return n if not neq[idx] else idx


class PrefixCache:
    """Radix-tree prefix index over a :class:`PagedKVCache` page pool.

    ``on_evict(n_pages)`` (optional) is called after each eviction —
    the engine wires it to ``EngineMetrics.on_prefix_evict``.
    """

    def __init__(self, cache, on_evict=None):
        self.cache = cache
        self.ps = cache.page_size
        self.on_evict = on_evict
        self._clock = 0
        self.root = _Node(np.zeros((0,), np.int32), [], None, 0)
        # counters (monotonic; surfaced through EngineMetrics)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.evictions = 0           # nodes evicted

    def _key(self, tokens, page_idx=0):
        lo = page_idx * self.ps
        return tuple(int(t) for t in tokens[lo:lo + self.ps])

    # -- lookup ----------------------------------------------------------

    def match(self, token_ids):
        """Longest cached prefix of ``token_ids``: returns
        ``(n_tokens, page_ids)`` where the pages cover exactly
        ``n_tokens`` positions.  Full pages match whole; at the first
        divergence (or when the cap bites) at most one page is matched
        PARTIALLY — its trailing positions belong to another prompt and
        the first write to it will copy-on-write.

        The match is capped at ``len(token_ids) - 1``: the final prompt
        token is always recomputed so prefill still produces the
        first-token logits.
        """
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        limit = len(ids) - 1
        self._clock += 1
        self.lookups += 1
        node = self.root
        node.last_access = self._clock
        pos = 0
        pages: list = []
        while pos < limit:
            child = None
            if pos + self.ps <= len(ids):
                child = node.children.get(
                    tuple(int(t) for t in ids[pos:pos + self.ps]))
            if child is not None:
                child.last_access = self._clock
                done = False
                for j in range(len(child.pages)):
                    span = child.tokens[j * self.ps:(j + 1) * self.ps]
                    rest = ids[pos:]
                    if len(rest) - 1 >= self.ps \
                            and np.array_equal(span, rest[:self.ps]):
                        pages.append(child.pages[j])
                        pos += self.ps
                        continue
                    t = min(_common_prefix(span, rest), limit - pos)
                    if t > 0:
                        pages.append(child.pages[j])
                        pos += t
                    done = True
                    break
                if done:
                    break
                node = child
                continue
            # no exact full-page edge: try a partial first-page match
            best_t, best_child = 0, None
            for c in node.children.values():
                t = min(_common_prefix(c.tokens[:self.ps], ids[pos:]),
                        limit - pos)
                if t > best_t:
                    best_t, best_child = t, c
            if best_child is not None:
                best_child.last_access = self._clock
                pages.append(best_child.pages[0])
                pos += best_t
            break
        if pos:
            self.hits += 1
            self.hit_tokens += pos
        return pos, pages

    def match_len(self, token_ids) -> int:
        """Read-only affinity probe: how many leading tokens of
        ``token_ids`` this tree already holds.  Same walk as
        :meth:`match` but touches NOTHING — no LRU clock bump, no
        ``last_access``, no hit counters — so the cluster router can
        probe every replica per request without perturbing eviction
        order or hit-rate stats on the replicas that lose the vote."""
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        limit = len(ids) - 1
        node = self.root
        pos = 0
        while pos < limit:
            child = None
            if pos + self.ps <= len(ids):
                child = node.children.get(
                    tuple(int(t) for t in ids[pos:pos + self.ps]))
            if child is not None:
                done = False
                for j in range(len(child.pages)):
                    span = child.tokens[j * self.ps:(j + 1) * self.ps]
                    rest = ids[pos:]
                    if len(rest) - 1 >= self.ps \
                            and np.array_equal(span, rest[:self.ps]):
                        pos += self.ps
                        continue
                    t = min(_common_prefix(span, rest), limit - pos)
                    pos += t
                    done = True
                    break
                if done:
                    break
                node = child
                continue
            best_t = 0
            for c in node.children.values():
                t = min(_common_prefix(c.tokens[:self.ps], ids[pos:]),
                        limit - pos)
                if t > best_t:
                    best_t = t
            pos += best_t
            break
        return pos

    # -- insertion -------------------------------------------------------

    def insert(self, token_ids, page_row) -> int:
        """Publish a prefilled sequence's FULL pages into the tree.
        ``page_row`` is the sequence's page-table row (page id per
        slot).  Shares existing prefix nodes, splits a node when the
        new run diverges mid-run (always at a page boundary), and takes
        one tree reference on every newly indexed page.  Returns the
        number of pages added."""
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        n_full = len(ids) // self.ps
        if n_full == 0:
            return 0
        self._clock += 1
        self.root.last_access = self._clock
        node = self.root
        i = 0
        added = 0
        while i < n_full:
            key = tuple(int(t) for t in ids[i * self.ps:
                                            (i + 1) * self.ps])
            child = node.children.get(key)
            if child is None:
                pages = [int(page_row[j]) for j in range(i, n_full)]
                if any(p < 0 for p in pages):
                    raise AssertionError(
                        f"insert: unset page slot in {pages}")
                new = _Node(ids[i * self.ps:n_full * self.ps].copy(),
                            pages, node, self._clock)
                node.children[key] = new
                for pid in pages:
                    self.cache.page_refs[pid] += 1
                added = len(pages)
                break
            child.last_access = self._clock
            j = 1   # page 0 matched via the edge key
            while (j < len(child.pages) and i + j < n_full
                   and np.array_equal(
                       child.tokens[j * self.ps:(j + 1) * self.ps],
                       ids[(i + j) * self.ps:(i + j + 1) * self.ps])):
                j += 1
            i += j
            if j < len(child.pages):
                if i >= n_full:
                    break          # input exhausted mid-run: all shared
                self._split(child, j)
            node = child
        self.inserted_pages += added
        return added

    def _split(self, node, j):
        """Split ``node`` at page boundary ``j``: the node keeps its
        first ``j`` pages, a new child takes the rest (and the old
        children).  Pure restructuring — no refcount changes."""
        suffix = _Node(node.tokens[j * self.ps:], node.pages[j:],
                       node, node.last_access)
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        node.children = {self._key(suffix.tokens): suffix}
        node.tokens = node.tokens[:j * self.ps]
        node.pages = node.pages[:j]

    # -- eviction --------------------------------------------------------

    def _unpinned(self, node) -> bool:
        refs = self.cache.page_refs
        return all(refs[p] == 1 for p in node.pages)

    def _lru_unpinned_leaf(self):
        best = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.children or not self._unpinned(n):
                continue
            if best is None or n.last_access < best.last_access:
                best = n
        return best

    def evict(self, need: int) -> int:
        """LRU eviction: repeatedly drop the least-recently-used leaf
        whose pages only the tree holds, until ``need`` pages are freed
        or no candidate remains.  Never touches a page a live sequence
        references (those have refcount > 1).  Returns pages freed."""
        freed = 0
        while freed < need:
            victim = self._lru_unpinned_leaf()
            if victim is None:
                break
            faults.fire("prefix.evict", "before")
            del victim.parent.children[self._key(victim.tokens)]
            for pid in victim.pages:
                self.cache._deref(pid)
            n = len(victim.pages)
            freed += n
            self.evicted_pages += n
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(n)
            faults.fire("prefix.evict", "after")
        return freed

    def evictable_pages(self) -> int:
        """Pages eviction COULD free right now: the total over maximal
        fully-unpinned subtrees (a node is only reclaimable once all
        its descendants are).  Admission adds this to the free count —
        cached-but-cold pages are capacity, not commitment."""

        def walk(node):
            total = 0
            sub_full = True
            for c in node.children.values():
                f, t = walk(c)
                total += t
                sub_full = sub_full and f
            if node is self.root:
                return sub_full, total
            if sub_full and self._unpinned(node):
                return True, total + len(node.pages)
            return False, total

        return walk(self.root)[1]

    # -- introspection ---------------------------------------------------

    def pages(self) -> list:
        """Every page id the tree currently indexes (DFS order)."""
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.extend(n.pages)
            stack.extend(n.children.values())
        return out

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "indexed_pages": len(self.pages()),
        }


def check_pool_invariants(cache, prefix=None):
    """Refcount/COW invariant audit (tests call this after every
    scheduler step):

      * no page is both free and referenced; refcounts never negative
      * pages-with-refs + free pages == pool size (nothing leaked)
      * every page's refcount equals the number of active slot
        page-table rows referencing it, plus one if the prefix tree
        indexes it
      * the tree never indexes a page twice
    """
    refs = cache.page_refs
    free = cache._free
    if len(set(free)) != len(free):
        raise AssertionError(f"duplicate pages in free list: {free}")
    for pid in free:
        if refs[pid] != 0:
            raise AssertionError(
                f"page {pid} is on the free list with refcount "
                f"{refs[pid]} (free AND referenced)")
    if (refs < 0).any():
        bad = np.nonzero(refs < 0)[0]
        raise AssertionError(f"negative refcounts at pages {bad}")
    in_use = int((refs > 0).sum())
    if in_use + len(free) != cache.num_pages:
        raise AssertionError(
            f"page leak: {in_use} referenced + {len(free)} free != "
            f"pool {cache.num_pages}")
    expected = np.zeros((cache.num_pages,), np.int64)
    for s in range(cache.max_seqs):
        if cache._active[s]:
            for pid in cache.page_table[s]:
                if pid >= 0:
                    expected[pid] += 1
    if prefix is not None:
        tree_pages = prefix.pages()
        if len(set(tree_pages)) != len(tree_pages):
            raise AssertionError(
                f"tree indexes a page twice: {sorted(tree_pages)}")
        for pid in tree_pages:
            expected[pid] += 1
    if not (expected == refs).all():
        bad = np.nonzero(expected != refs)[0]
        raise AssertionError(
            f"refcount mismatch at pages {bad.tolist()}: "
            f"expected {expected[bad].tolist()}, "
            f"recorded {refs[bad].tolist()}")
