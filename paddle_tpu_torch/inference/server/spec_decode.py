"""Self-speculative decoding: n-gram / prompt-lookup drafting.

The serving TPOT floor below batch saturation is HBM bandwidth — every
decode step re-reads the whole model to produce ONE token per sequence.
Draft-and-verify [Leviathan et al., "Fast Inference from Transformers
via Speculative Decoding"] trades cheap FLOPs for those reads: guess
``k`` tokens, run ONE forward over the ``k+1``-token window, keep the
longest prefix the model agrees with.  Greedy acceptance (token match
against the argmax) makes the output stream bit-identical to plain
greedy decode by construction — position ``w`` is only committed when
positions ``< w`` fed the model exactly the tokens it would have
chosen itself.

The draft source here is the sequence's OWN history (prompt-lookup /
n-gram drafting, no second model): generated text constantly re-quotes
its prompt and itself — code, JSON, retrieval contexts, multi-turn
chatter — so matching the tail n-gram of ``prompt + generated`` against
an earlier occurrence and proposing the tokens that followed it is free
and surprisingly accurate on structured workloads.

:class:`NGramProposer` keeps one incrementally-maintained index per
request: ``index[n][ngram] -> position right after that n-gram's most
recent PREVIOUS occurrence``.  An n-gram is recorded only once a token
lands after it, so the tail n-gram (which has no continuation yet)
never matches itself.  Longest ``n`` wins at propose time.

:class:`SpecDecode` is the bundle the scheduler drives (mode + ``k`` +
proposer); built by the engine when ``PT_SPEC_DECODE=ngram``.

Counterpart of ``paddle_tpu/inference/server/spec_decode.py``: a copy of
the whole module, held by the port (host-only, numpy).

Env knobs::

    PT_SPEC_DECODE  off | ngram      (default off; bit-exact legacy)
    PT_SPEC_K       max draft tokens per step   (default 4)
    PT_SPEC_NGRAM   longest n-gram matched      (default 3)
"""
from __future__ import annotations

import os

import numpy as np


def spec_mode() -> str:
    """Validated ``PT_SPEC_DECODE`` value."""
    mode = os.environ.get("PT_SPEC_DECODE", "off").lower()
    if mode not in ("off", "ngram"):
        raise ValueError(
            f"PT_SPEC_DECODE={mode!r}: expected off|ngram")
    return mode


class NGramProposer:
    """Per-request prompt-lookup draft index, maintained incrementally.

    ``begin(rid, tokens)`` seeds from a full history (admission /
    re-admission after preemption rebuilds it from
    ``prompt + generated``, so preempted streams draft identically to
    never-preempted ones), ``extend(rid, tok)`` appends one accepted
    token, ``propose(rid, k)`` returns up to ``k`` continuation tokens.
    """

    def __init__(self, max_ngram=3, min_ngram=1):
        if max_ngram < min_ngram or min_ngram < 1:
            raise ValueError(
                f"need max_ngram >= min_ngram >= 1, got "
                f"{max_ngram}/{min_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self._tokens: dict = {}   # rid -> [int, ...]
        self._index: dict = {}    # rid -> {n: {ngram tuple: cont pos}}

    def begin(self, rid, tokens) -> None:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        self._tokens[rid] = []
        self._index[rid] = {n: {} for n in
                            range(self.min_ngram, self.max_ngram + 1)}
        for t in toks:
            self.extend(rid, t)

    def extend(self, rid, tok) -> None:
        """Append one token; index the n-grams it gives a continuation
        to.  The n-gram ENDING at the new token is deliberately not
        indexed yet — it has no continuation, and skipping it is what
        keeps the tail from matching itself at propose time."""
        toks = self._tokens[rid]
        idx = self._index[rid]
        p = len(toks)            # the new token's position
        toks.append(int(tok))
        for n in range(self.min_ngram, self.max_ngram + 1):
            if p >= n:
                idx[n][tuple(toks[p - n:p])] = p
        # an unbounded per-request index is fine at serving lengths
        # (max_len tokens x max_ngram entries); dropped at release

    def drop(self, rid) -> None:
        self._tokens.pop(rid, None)
        self._index.pop(rid, None)

    def propose(self, rid, k) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``rid``'s history, or an
        empty array when no earlier occurrence of the tail matches
        (the step then degrades to plain one-token decode)."""
        toks = self._tokens.get(rid)
        if toks is None or k <= 0:
            return np.zeros((0,), np.int32)
        L = len(toks)
        idx = self._index[rid]
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            pos = idx[n].get(tuple(toks[L - n:L]))
            if pos is not None:
                return np.asarray(toks[pos:pos + k], np.int32)
        return np.zeros((0,), np.int32)

    def history_len(self, rid) -> int:
        toks = self._tokens.get(rid)
        return 0 if toks is None else len(toks)


class SpecDecode:
    """Mode bundle the scheduler drives: draft budget + proposer.

    ``k`` is the max drafted tokens per sequence per step, so the
    verify window is ``k + 1`` wide and admission charges the
    worst-case ``k + 1`` token lookahead.
    """

    def __init__(self, k=None, max_ngram=None):
        if k is None:
            k = int(os.environ.get("PT_SPEC_K", "4"))
        if max_ngram is None:
            max_ngram = int(os.environ.get("PT_SPEC_NGRAM", "3"))
        if k < 1:
            raise ValueError(f"PT_SPEC_K must be >= 1, got {k}")
        self.k = int(k)
        self.proposer = NGramProposer(max_ngram=max_ngram)

    # -- scheduler lifecycle hooks --------------------------------------

    def on_running(self, req) -> None:
        """Request entered RUNNING (final prefill chunk landed): seed
        the draft index from prompt + everything generated so far
        (non-empty ``generated`` = resumed after preemption)."""
        history = np.concatenate(
            [np.asarray(req.prompt_ids, np.int32),
             np.asarray(req.generated, np.int32)])
        self.proposer.begin(req.rid, history)

    def on_token(self, req, tok) -> None:
        if req.rid in self.proposer._tokens:
            self.proposer.extend(req.rid, tok)

    def on_release(self, req) -> None:
        self.proposer.drop(req.rid)

    def propose(self, req, max_len=None) -> np.ndarray:
        cap = self.k if max_len is None else min(self.k, int(max_len))
        return self.proposer.propose(req.rid, cap)
