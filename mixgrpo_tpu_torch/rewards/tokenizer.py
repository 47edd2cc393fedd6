"""CLIP BPE tokenizer (offline, vocab file supplied like model weights).

A copy of mixgrpo_tpu/rewards/tokenizer.py (pure Python and numpy; the
port imports nothing of the JAX package).

The reference tokenizes through open_clip/clip package tokenizers
(hps_score.py get_tokenizer, clip_score.py:17 clip.tokenize), which bundle
the 16e6 BPE merges file.  This is a from-scratch implementation of the
same scheme: byte-level pre-encoding, lowercasing + whitespace cleanup,
the CLIP token regex, greedy BPE merges with the ``</w>`` word-end marker,
and <start_of_text>/<end_of_text> wrapping with pad-to-context.

``merges_path`` points at ``bpe_simple_vocab_16e6.txt.gz`` (or a plain
text copy) fetched alongside the model checkpoints at deploy time.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# CLIP's original pattern uses \p{L}/\p{N} (regex module); stdlib `re`
# equivalents via str.isalpha-range classes cover the same ASCII behavior
# and route other unicode through the byte fallback branch.
_PAT = re.compile(
    r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[0-9]|[^\s\w]+""",
    re.IGNORECASE | re.UNICODE,
)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class CLIPTokenizer:
    def __init__(self, merges_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1] if m]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_clean(text)):
            btok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(btok))
        return ids

    def __call__(self, texts: Sequence[str], truncate: bool = True) -> np.ndarray:
        """Tokenize to (B, context_length) int32 with SOT/EOT + zero pad."""
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > self.context_length:
                if not truncate:
                    raise ValueError(f"text too long: {t!r}")
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
