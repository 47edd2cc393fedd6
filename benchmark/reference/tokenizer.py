"""CLIP's byte-level BPE tokenizer in plain Python.

From OpenAI CLIP's ``simple_tokenizer.py``: text unescaped, whitespace
collapsed and lower-cased, split by CLIP's pattern, each piece's UTF-8
bytes mapped to printable characters, merged greedily by the merge table's
ranks with ``</w>`` closing each word; the vocabulary is the 256 byte
characters, the same with ``</w>``, the merges, then <start_of_text> and
<end_of_text>.  Ids are padded with zeros to the context.
"""

from __future__ import annotations

import html
import re

import numpy as np

PATTERN = re.compile(r"<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[0-9]"
                     r"|[^\s\w]+", re.IGNORECASE)


def byte_chars():
    keep = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    extra = [b for b in range(256) if b not in keep]
    chars = [chr(c) for c in keep] + [chr(256 + i) for i in range(len(extra))]
    return dict(zip(keep + extra, chars))


class Tokenizer:
    def __init__(self, merges_text: str, context: int = 77):
        merges = [tuple(line.split()) for line in merges_text.split("\n")[1:48895] if line]
        chars = list(byte_chars().values())
        vocab = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges] \
            + ["<start_of_text>", "<end_of_text>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bytes = byte_chars()
        self.context = context

    def _bpe(self, piece: str):
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def __call__(self, texts):
        out = np.zeros((len(texts), self.context), np.int64)
        for row, text in enumerate(texts):
            text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).lower()
            ids = [self.ids["<start_of_text>"]]
            for piece in PATTERN.findall(text):
                piece = "".join(self.bytes[b] for b in piece.encode("utf-8"))
                ids += [self.ids[t] for t in self._bpe(piece)]
            ids = ids[:self.context - 1] + [self.ids["<end_of_text>"]]
            out[row, :len(ids)] = ids
        return out
