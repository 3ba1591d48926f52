"""Token-level masks from a character-level machine.

Reference parity: the PSE StructuringEngine's vocabulary indexing + logit
masking role (SURVEY.md §2.4). A token is allowed iff the machine accepts its
full decoded string from the current state. First-character bucketing keeps
per-step cost proportional to the plausible candidate set rather than the
vocabulary.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

ANY_CHAR = "\x00"  # FreeString sentinel: any non-control, non-quote char


class TokenMasker:
    def __init__(self, tokenizer, vocab_size: Optional[int] = None):
        """tokenizer: pie_tpu Tokenizer (or anything with .decode and
        .vocab_size)."""
        self.tokenizer = tokenizer
        self.vocab_size = vocab_size or tokenizer.vocab_size
        self.token_strs: list[Optional[str]] = []
        self.by_first: dict[str, list[int]] = {}
        self._build()

    def _build(self):
        decode = self.tokenizer.decode
        self.by_str: dict[str, int] = {}
        self._max_tok_len = 1
        for tid in range(self.vocab_size):
            try:
                s = decode([tid])
            except Exception:
                s = None
            if not s or "�" in s:
                # partial-UTF8 byte tokens and specials are never forced
                # into structured output (reference whitelists control
                # tokens separately)
                self.token_strs.append(None)
                continue
            self.token_strs.append(s)
            self.by_first.setdefault(s[0], []).append(tid)
            self.by_str.setdefault(s, tid)
            if len(s) > self._max_tok_len:
                self._max_tok_len = len(s)

    def encode_longest(self, s: str) -> list[int]:
        """Greedy longest-match tokenization of ``s`` over exact token
        strings; returns ids covering the longest encodable prefix of ``s``
        (stops at the first position where no token string matches). Used by
        the forced-run fast path: any tokenization of a character-forced run
        is accepted by the machine, so the canonical greedy one is emitted
        without a device step (reference multi_token_sampling=True,
        engine/inference_engine.py:40)."""
        out: list[int] = []
        i, n = 0, len(s)
        while i < n:
            for length in range(min(self._max_tok_len, n - i), 0, -1):
                tid = self.by_str.get(s[i:i + length])
                if tid is not None:
                    out.append(tid)
                    i += length
                    break
            else:
                break
        return out

    def candidates_for(self, allowed_chars: set) -> list[int]:
        out: list[int] = []
        expand_all = ANY_CHAR in allowed_chars
        if expand_all:
            for first, ids in self.by_first.items():
                out.extend(ids)
            return out
        for ch in allowed_chars:
            out.extend(self.by_first.get(ch, ()))
        return out

    def build_mask(
        self, machine, extra_allowed: Sequence[int] = ()
    ) -> np.ndarray:
        """Boolean [vocab_size] mask of tokens whose full string the machine
        accepts from its current state."""
        mask = np.zeros((self.vocab_size,), dtype=bool)
        allowed = machine.allowed_chars()
        for tid in self.candidates_for(allowed):
            s = self.token_strs[tid]
            if s is not None and machine.accepts_prefix(s):
                mask[tid] = True
        for tid in extra_allowed:
            if 0 <= tid < self.vocab_size:
                mask[tid] = True
        return mask
