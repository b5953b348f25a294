"""A small self-contained BPE tokenizer for the serving stack (a copy of
repro/serving/tokenizer.py, which imports no JAX either).

The engine's detokenizer seam (``Engine(detokenize=...)``) has so far been
fed the toy decimal renderer (``default_detokenize`` -> ``"{id} "``), which
means stop strings and streamed text never looked like real traffic.  This
module provides a real — if tiny — char-level BPE:

* **Pieces are valid ``str``** (char-level, not byte-level), so streamed
  text is always the concatenation of whole pieces and the request-side
  stop-string/holdback machinery operates on exactly the text a user sees.
  Multi-byte characters ("é", "—", "日") are single symbols, exercising the
  holdback path with pieces longer than one UTF-8 byte.
* **Deterministic training** on a corpus string: count adjacent symbol
  pairs, merge the most frequent (ties broken lexicographically), repeat
  until the target vocab size.  No randomness, no external deps.
* **JSON vocab files** (``save``/``load``) so the server and bench load
  the same vocabulary; ``trained()`` returns the embedded-corpus default.
* **Decimal fallback**: ``piece(id)`` renders out-of-vocab ids the way
  ``default_detokenize`` would, so a model emitting ids past the trained
  vocab still streams *something* and never crashes the detokenizer.

The default vocab is capped at 512 entries to match the smoke models'
``vocab=512`` — every id the tokenizer emits is a valid model token.
"""

from __future__ import annotations

import json
import string
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["BPETokenizer", "DEFAULT_CORPUS", "DEFAULT_VOCAB_SIZE"]

DEFAULT_VOCAB_SIZE = 512

# Small mixed corpus: enough English to learn useful merges, plus accented
# and CJK characters so multi-byte pieces exist in the default vocab.
DEFAULT_CORPUS = (
    "You are a helpful assistant. Answer the question concisely and "
    "truthfully. If you are unsure, say so. "
    "The quick brown fox jumps over the lazy dog. "
    "the model serves the request and the request streams the response "
    "to the user while the server batches the decode step. "
    "paged attention maps token positions to pages in the pool. "
    "speculative decoding drafts tokens and verifies them in parallel. "
    "prefix caching shares the system prompt across users. "
    "résumé café naïve touché — em dash, ellipsis… "
    "日本語のテキスト, 中文文本. "
    "0123456789 () [] {} <> != == -> the end.\n"
)


class BPETokenizer:
    """Char-level BPE: ``pieces`` (id -> string), ``merges`` (ranked pairs).

    ``encode`` is exact greedy BPE (always apply the lowest-rank merge
    present), which reproduces the training segmentation; ``decode`` is
    plain concatenation — the property the stop-string machinery relies
    on."""

    def __init__(self, pieces: Sequence[str], merges: Sequence[Tuple[str, str]]):
        self.pieces: List[str] = list(pieces)
        self.merges: List[Tuple[str, str]] = [tuple(m) for m in merges]
        self._id: Dict[str, int] = {p: i for i, p in enumerate(self.pieces)}
        if len(self._id) != len(self.pieces):
            raise ValueError("duplicate pieces in vocab")
        self._rank: Dict[Tuple[str, str], int] = {
            m: r for r, m in enumerate(self.merges)
        }

    # -- training -------------------------------------------------------------

    @classmethod
    def train(cls, corpus: str, vocab_size: int = DEFAULT_VOCAB_SIZE) -> "BPETokenizer":
        # base alphabet: corpus chars plus all printable ASCII, so encode()
        # never chokes on ordinary text the training corpus happened to miss
        symbols = sorted(set(corpus) | set(string.printable))
        if len(symbols) >= vocab_size:
            raise ValueError(
                f"corpus alphabet ({len(symbols)}) already >= vocab_size"
            )
        pieces = list(symbols)
        merges: List[Tuple[str, str]] = []
        seq = list(corpus)
        # cap piece length: without it a repeated corpus degenerately
        # merges into whole sentences, leaving a useless vocab
        max_piece = 12
        while len(pieces) < vocab_size:
            counts: Dict[Tuple[str, str], int] = {}
            for a, b in zip(seq, seq[1:]):
                if len(a) + len(b) <= max_piece:
                    counts[(a, b)] = counts.get((a, b), 0) + 1
            if not counts:
                break
            # most frequent pair; ties broken lexicographically for
            # determinism across python versions
            best = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
            if counts[best] < 2:
                break
            merges.append(best)
            pieces.append(best[0] + best[1])
            merged, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    merged.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    merged.append(seq[i])
                    i += 1
            seq = merged
        return cls(pieces, merges)

    _DEFAULT: "BPETokenizer" = None

    @classmethod
    def trained(cls) -> "BPETokenizer":
        """The default tokenizer (embedded corpus, vocab 512), cached.
        The corpus is repeated so pair counts stay >= 2 deep into training
        and the merge table actually approaches the vocab cap."""
        if cls._DEFAULT is None:
            cls._DEFAULT = cls.train(DEFAULT_CORPUS * 4, DEFAULT_VOCAB_SIZE)
        return cls._DEFAULT

    # -- persistence ------------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"pieces": self.pieces, "merges": [list(m) for m in self.merges]},
                f, ensure_ascii=False,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        return cls(blob["pieces"], [tuple(m) for m in blob["merges"]])

    # -- encode / decode ----------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        seq = list(text)
        unknown = [c for c in seq if c not in self._id]
        if unknown:
            raise ValueError(
                f"characters not in tokenizer alphabet: {sorted(set(unknown))!r}"
            )
        while len(seq) > 1:
            ranked = [
                (self._rank[p], i)
                for i, p in enumerate(zip(seq, seq[1:]))
                if p in self._rank
            ]
            if not ranked:
                break
            rank = min(ranked)[0]
            merged, i = [], 0
            while i < len(seq):
                if (
                    i + 1 < len(seq)
                    and self._rank.get((seq[i], seq[i + 1])) == rank
                ):
                    merged.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    merged.append(seq[i])
                    i += 1
            seq = merged
        return [self._id[p] for p in seq]

    def piece(self, token_id: int) -> str:
        """Detokenize one id — the ``Engine(detokenize=...)`` callable.
        Ids outside the vocab fall back to the toy decimal rendering, so a
        model sampling past the trained vocab still streams text."""
        if 0 <= token_id < len(self.pieces):
            return self.pieces[token_id]
        return f"{token_id} "

    def decode(self, ids: Iterable[int]) -> str:
        return "".join(self.piece(i) for i in ids)
