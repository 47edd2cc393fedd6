"""A reader of HF ``tokenizer.json`` files: the T5 tokenizer (``tokenizer_2``),
ImageReward's BERT WordPiece tokenizer and the Llama-3 byte-level BPE
tokenizer of HunyuanVideo's text encoder.

The JAX package tokenizes T5 prompts with
``transformers.AutoTokenizer.from_pretrained(tokenizer_2)``
(mixgrpo_tpu/preprocess.py:125,141, sample.py:238,266) and ImageReward's
prompts with ``transformers.BertTokenizerFast.from_pretrained``
(mixgrpo_tpu/rewards/image_reward.py:125-128) and the llava-llama-3
prompts with ``transformers.AutoTokenizer``
(mixgrpo_tpu/models/hunyuan/text_encoder.py:163-179); the card's machine
has neither ``transformers``, ``tokenizers`` nor ``regex``, so the port reads
the file itself and runs the same pipeline, id for id:

  added tokens (split out of the raw text, or out of the normalized text
  for those marked ``normalized``) -> normalizer -> pre-tokenizer -> model
  -> truncation to ``max_length`` minus the template's special tokens ->
  post-processor -> padding.

Components taken (any other type, or an option that changes the pipeline
and is not handled here, raises ``ValueError`` naming it; no step is ever
skipped):

- normalizers: ``NFC``, ``NFD``, ``NFKC``, ``NFKD``, ``Lowercase``,
  ``Strip``, ``Replace`` (string or regex pattern), ``Precompiled`` (the
  sentencepiece char map of the released T5 file: a darts-clone double-array
  trie over UTF-8 bytes plus a blob of replacement strings; as in
  ``tokenizers``, a grapheme cluster shorter than 6 bytes is replaced by the
  value of its shortest prefix in the trie, else each character is looked
  up alone), ``BertNormalizer`` (control characters dropped and whitespace
  made a space, CJK ideographs spaced out, accents stripped by NFD and
  dropping nonspacing marks, lower-casing character by character) and
  ``Sequence``;
- pre-tokenizers: ``Whitespace`` (``\\w+|[^\\w\\s]+``), ``WhitespaceSplit``,
  ``Metaspace`` (``prepend_scheme`` "always" or "never", or the older
  ``add_prefix_space``; ``split``), ``BertPreTokenizer`` (split on
  whitespace, each punctuation character a piece of its own), ``Split``
  (Llama-3's pattern only, ``Isolated``, not inverted: Python's ``re`` has no
  ``\\p{...}``, so the pattern runs as a scanner over ``unicodedata``
  categories, ``\\p{L}`` as ``str.isalpha``, ``\\p{N}`` as Nd, Nl and No,
  ``\\s`` as Oniguruma's: tab to CR, NEL, Zs, Zl and Zp; the categories
  are Python's Unicode database, 15.0 on Python 3.12, so a letter assigned
  later splits otherwise than in ``tokenizers``), ``ByteLevel``
  (``use_regex`` and ``add_prefix_space`` off: each piece's UTF-8 bytes
  mapped to GPT-2's printable characters) and ``Sequence``;
- models: ``WordLevel``, ``Unigram`` (Viterbi over the scored pieces,
  ties to the earliest start; a character no piece covers becomes ``unk_id``
  scored ``min_score - 10``; runs of unknowns fuse into one) and
  ``WordPiece`` (greedy longest match from the left, continuations prefixed
  ``##``; a word with an unmatched rest, or over
  ``max_input_chars_per_word`` characters, becomes the unk token) and
  ``BPE`` (``ignore_merges``: a piece whole in the vocabulary is taken as
  is; else its characters merged pair by pair, the lowest-ranked pair first
  and the leftmost of equals; an unknown character becomes ``unk_token``,
  runs of them one with ``fuse_unk``, or is dropped without one; dropout,
  ``byte_fallback`` and subword affixes raise);
- post-processors: ``TemplateProcessing`` (single-sequence template),
  ``BertProcessing`` (``[CLS] ... [SEP]``), ``ByteLevel`` (offsets only: no
  change to the ids) and a ``Sequence`` of these holding one template.

``load_bert_tokenizer`` reads a directory's ``tokenizer.json``, or, where it
ships only ``vocab.txt`` (as ``bert-base-uncased``'s older layout does),
builds the pipeline ``BertTokenizerFast`` converts it to: BertNormalizer
(lower-casing per ``do_lower_case``, default on), BertPreTokenizer,
WordPiece with ``[UNK]`` and ``##``, and the ``[CLS] $A [SEP]`` template,
with the five special tokens as added tokens.  Every call pads to
``max_length`` and returns the attention mask beside the ids.

Grapheme clusters (used only by ``Precompiled``) follow a subset of Unicode
UAX #29: a base character with the combining marks, ZWJ sequences,
variation selectors and emoji modifiers after it, CR LF, and regional
indicator pairs.  ``tokenizer_config.json`` gives the pad token and the
special tokens that ``AutoTokenizer`` registers as added tokens.  An added
token missing from the model's vocabulary is numbered as ``tokenizers``
numbers it, whatever id the file gives: the vocabulary's size, or one past
the largest added id before it (Llama-3's specials follow its 128,000
regular tokens, so their ids are the file's).
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

K_UNK_PENALTY = 10.0


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


class _DoubleArray:
    """darts-clone's double-array trie as sentencepiece serializes it."""

    def __init__(self, units: np.ndarray):
        self.units = units

    def common_prefix_values(self, key: bytes) -> List[int]:
        """The values of every prefix of ``key`` in the trie, shortest first."""
        units = self.units
        offset = lambda u: (u >> 10) << ((u & (1 << 9)) >> 6)
        pos = offset(int(units[0]))
        out = []
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = int(units[pos])
            if (unit & ((1 << 31) | 0xFF)) != c:  # label
                break
            pos ^= offset(unit)
            if (unit >> 8) & 1:  # has leaf
                out.append(int(units[pos]) & ((1 << 31) - 1))
        return out


_EXTEND_CATS = {"Mn", "Me", "Mc"}


def _is_extend(ch: str) -> bool:
    cp = ord(ch)
    return (unicodedata.category(ch) in _EXTEND_CATS or cp == 0x200D
            or 0xFE00 <= cp <= 0xFE0F or 0x1F3FB <= cp <= 0x1F3FF
            or 0xE0020 <= cp <= 0xE007F)


def _graphemes(text: str) -> List[str]:
    """Extended grapheme clusters (the subset of UAX #29 named in the module
    docstring)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        if text[i] == "\r" and j < n and text[j] == "\n":
            j += 1
        elif 0x1F1E6 <= ord(text[i]) <= 0x1F1FF and j < n and 0x1F1E6 <= ord(text[j]) <= 0x1F1FF:
            j += 1
        else:
            while j < n and _is_extend(text[j]):
                # a ZWJ joins the next character to the cluster
                j += 2 if text[j] == "\u200d" and j + 1 < n else 1
        out.append(text[i:j])
        i = j
    return out


class _Precompiled:
    def __init__(self, charsmap_b64: str):
        blob = base64.b64decode(charsmap_b64)
        (trie_size,) = struct.unpack("<I", blob[:4])
        self.trie = _DoubleArray(np.frombuffer(blob[4:4 + trie_size], dtype="<u4"))
        self.normalized = blob[4 + trie_size:]

    def _transform(self, chunk: str) -> Optional[str]:
        vals = self.trie.common_prefix_values(chunk.encode("utf-8"))
        if not vals:
            return None
        end = self.normalized.index(b"\0", vals[0])
        return self.normalized[vals[0]:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        out = []
        for g in _graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self._transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self._transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
               (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(a <= cp <= b for a, b in _CJK_RANGES)


def _bert_normalizer(spec) -> callable:
    """``tokenizers``' BertNormalizer: clean text, space out CJK ideographs,
    strip accents (default: when lower-casing), lower-case per character."""
    clean, cjk = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def run(s: str) -> str:
        if clean:
            s = "".join(" " if ch in "\t\n\r" or ch.isspace() else ch for ch in s
                        if not (ord(ch) in (0, 0xFFFD) or (ch not in "\t\n\r" and
                                unicodedata.category(ch)[0] == "C")))
        if cjk:
            s = "".join(f" {ch} " if _is_cjk(ch) else ch for ch in s)
        if strip:
            s = "".join(ch for ch in unicodedata.normalize("NFD", s)
                        if unicodedata.category(ch) != "Mn")
        if lower:
            s = "".join(ch.lower() for ch in s)
        return s
    return run


def _normalizer(spec) -> callable:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            s = s.lstrip() if left else s
            return s.rstrip() if right else s
        return strip
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        if "Regex" in pat:
            rx = re.compile(pat["Regex"])
            return lambda s: rx.sub(lambda m: content, s)
        return lambda s: s.replace(pat["String"], content)
    if kind == "Precompiled":
        return _Precompiled(spec["precompiled_charsmap"])
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def run(s):
            for f in steps:
                s = f(s)
            return s
        return run
    raise ValueError(f"tokenizer.json: unknown normalizer type {kind!r}")


# ---------------------------------------------------------------------------
# pre-tokenizers: each maps a list of pieces to a list of pieces
# ---------------------------------------------------------------------------


def _is_word(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")


def _whitespace(piece: str) -> List[str]:
    """``\\w+|[^\\w\\s]+`` runs; whitespace between them is dropped."""
    out, cur, kind = [], [], None
    for ch in piece:
        k = "w" if _is_word(ch) else ("s" if ch.isspace() else "p")
        if k != kind and cur:
            if kind != "s":
                out.append("".join(cur))
            cur = []
        cur.append(ch)
        kind = k
    if cur and kind != "s":
        out.append("".join(cur))
    return out


def _is_bert_punct(ch: str) -> bool:
    return (ch.isascii() and not ch.isalnum() and ch.isprintable() and not ch.isspace()) \
        or unicodedata.category(ch)[0] == "P"


def _bert_split(piece: str) -> List[str]:
    """Split on whitespace; every punctuation character is a piece alone."""
    out, cur = [], []
    for ch in piece:
        if ch.isspace() or _is_bert_punct(ch):
            if cur:
                out.append("".join(cur))
                cur = []
            if not ch.isspace():
                out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


# Llama-3's Split pattern, the only one taken
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_CRLF = "\r\n"


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (``ByteLevel``)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch) in ("Nd", "Nl", "No")


def _is_space(ch: str) -> bool:
    """Oniguruma's Unicode ``\\s``."""
    return ch in "\t\n\x0b\x0c\r\x85" or unicodedata.category(ch) in ("Zs", "Zl", "Zp")


def _is_other(ch: str) -> bool:
    return not (_is_space(ch) or ch.isalpha() or _is_number(ch))


def _fold(ch: str) -> str:
    """Simple case folding, as ``(?i:...)`` compares characters."""
    return "s" if ch == "\u017f" else ch.lower()


def _llama3_match(text: str, i: int) -> int:
    """End of the match of ``LLAMA3_SPLIT`` at ``i`` (its alternatives tried
    in order, with the backtracking the regex does), or ``i`` for none."""
    n, c = len(text), text[i]
    if c == "'":  # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        for suf in _CONTRACTIONS:
            j = i + 1 + len(suf)
            if j <= n and all(_fold(a) == b for a, b in zip(text[i + 1:j], suf)):
                return j
    # [^\r\n\p{L}\p{N}]?\p{L}+
    j = i + 1 if (i + 1 < n and c not in _CRLF and not c.isalpha() and not _is_number(c)
                  and text[i + 1].isalpha()) else i
    if text[j].isalpha():
        while j < n and text[j].isalpha():
            j += 1
        return j
    if _is_number(c):  # \p{N}{1,3}
        j = i
        while j < min(n, i + 3) and _is_number(text[j]):
            j += 1
        return j
    j = i + 1 if c == " " else i  #  ?[^\s\p{L}\p{N}]+[\r\n]*
    if j < n and _is_other(text[j]):
        while j < n and _is_other(text[j]):
            j += 1
        while j < n and text[j] in _CRLF:
            j += 1
        return j
    if not _is_space(c):
        return i
    j = i
    while j < n and _is_space(text[j]):
        j += 1
    crlf = [k for k in range(i, j) if text[k] in _CRLF]
    if crlf:  # \s*[\r\n]+: the whitespace up to its last CR or LF
        return crlf[-1] + 1
    if j == n or j - i == 1:  # \s+(?!\S) at the end, else \s+
        return j
    return j - 1  # \s+(?!\S): all but the last, which the next piece takes


def _llama3_split(piece: str) -> List[str]:
    """``LLAMA3_SPLIT`` with ``Isolated`` behaviour: every match a piece of
    its own, and each unmatched stretch between."""
    out, gap, i = [], "", 0
    while i < len(piece):
        e = _llama3_match(piece, i)
        if e > i:
            if gap:
                out.append(gap)
                gap = ""
            out.append(piece[i:e])
            i = e
        else:
            gap += piece[i]
            i += 1
    if gap:
        out.append(gap)
    return out


def _pre_tokenizer(spec) -> callable:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Split":
        pat = spec.get("pattern", {})
        if pat.get("Regex") != LLAMA3_SPLIT or spec.get("behavior") != "Isolated" \
                or spec.get("invert"):
            raise ValueError(f"tokenizer.json: Split {pat}, behavior "
                             f"{spec.get('behavior')!r}, invert {spec.get('invert')!r} is "
                             "not handled here (only Llama-3's pattern, Isolated)")
        return lambda pieces: [w for p in pieces for w in _llama3_split(p)]
    if kind == "ByteLevel":
        if spec.get("use_regex", True) or spec.get("add_prefix_space", True):
            raise ValueError("tokenizer.json: ByteLevel pre_tokenizer with use_regex or "
                             "add_prefix_space is not handled here")
        enc = _bytes_to_unicode()
        return lambda pieces: ["".join(enc[b] for b in p.encode("utf-8")) for p in pieces]
    if kind == "BertPreTokenizer":
        return lambda pieces: [w for p in pieces for w in _bert_split(p)]
    if kind == "Whitespace":
        return lambda pieces: [w for p in pieces for w in _whitespace(p)]
    if kind == "WhitespaceSplit":
        return lambda pieces: [w for p in pieces for w in p.split()]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "never"):
            raise ValueError(f"tokenizer.json: Metaspace prepend_scheme {scheme!r} is not "
                             "handled here")
        split = spec.get("split", True)

        def meta(pieces):
            out = []
            for p in pieces:
                p = p.replace(" ", rep)
                if scheme == "always" and not p.startswith(rep):
                    p = rep + p
                out.extend(q for q in (re.split(f"(?={re.escape(rep)})", p) if split else [p])
                           if q)
            return out
        return meta
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces
        return run
    raise ValueError(f"tokenizer.json: unknown pre_tokenizer type {kind!r}")


# ---------------------------------------------------------------------------
# models: each maps one piece to ids
# ---------------------------------------------------------------------------


class _WordLevel:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def token_id(self, tok: str) -> Optional[int]:
        return self.vocab.get(tok)

    def __call__(self, piece: str) -> List[int]:
        if piece in self.vocab:
            return [self.vocab[piece]]
        if self.unk is None or self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {piece!r} is not in the vocab and there is no "
                             "unk token")
        return [self.vocab[self.unk]]


class _Unigram:
    def __init__(self, spec):
        if spec.get("byte_fallback"):
            raise ValueError("tokenizer.json: Unigram byte_fallback is not handled here")
        pieces = spec["vocab"]
        self.ids = {}
        for i, (p, _) in enumerate(pieces):
            self.ids.setdefault(p, i)
        self.scores = [float(s) for _, s in pieces]
        self.unk_id = spec.get("unk_id")
        self.min_score = min(self.scores)
        self.max_len = max(len(p) for p, _ in pieces)

    def token_id(self, tok: str) -> Optional[int]:
        return self.ids.get(tok)

    def __call__(self, piece: str) -> List[int]:
        n = len(piece)
        if n == 0:
            return []
        unk_score = self.min_score - K_UNK_PENALTY
        best = [None] * (n + 1)  # (score, start, id) of the best path ending here
        best[0] = (0.0, -1, -1)
        for s in range(n):
            if best[s] is None:
                continue
            base, single = best[s][0], False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                i = self.ids.get(piece[s:e])
                if i is None:
                    continue
                cand = base + self.scores[i]
                if best[e] is None or cand > best[e][0]:
                    best[e] = (cand, s, i)
                single |= e == s + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: {piece[s]!r} has no piece and no unk_id")
                cand = base + unk_score
                if best[s + 1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        # walk back; runs of unknown pieces fuse into one token
        toks: List[Tuple[str, bool]] = []
        e = n
        while e > 0:
            _, s, i = best[e]
            unk = i == self.unk_id
            if unk and toks and toks[-1][1]:
                toks[-1] = (piece[s:e] + toks[-1][0], True)
            else:
                toks.append((piece[s:e], unk))
            e = s
        return [self.ids.get(t, self.unk_id) if unk else self.ids[t]
                for t, unk in reversed(toks)]


class _WordPiece:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece: unk token {self.unk!r} is not in the vocab")

    def token_id(self, tok: str) -> Optional[int]:
        return self.vocab.get(tok)

    def __call__(self, piece: str) -> List[int]:
        if len(piece) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(piece):
            end = len(piece)
            while end > start:
                sub = piece[start:end] if start == 0 else self.prefix + piece[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    break
                end -= 1
            else:
                return [self.vocab[self.unk]]
            start = end
        return out


class _BPE:
    def __init__(self, spec):
        for opt in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                    "byte_fallback"):
            if spec.get(opt):
                raise ValueError(f"tokenizer.json: BPE {opt} is not handled here")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.ranks: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for r, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks.setdefault((self.vocab[a], self.vocab[b]), (r, self.vocab[a + b]))
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.ignore_merges = bool(spec.get("ignore_merges"))

    def token_id(self, tok: str) -> Optional[int]:
        return self.vocab.get(tok)

    def __call__(self, piece: str) -> List[int]:
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
        ids: List[int] = []
        unk_last = False
        for ch in piece:
            i = self.vocab.get(ch)
            if i is not None:
                ids.append(i)
                unk_last = False
            elif self.unk is not None:
                if not (self.fuse_unk and unk_last):
                    ids.append(self.vocab[self.unk])
                unk_last = True
        while len(ids) > 1:
            best = None  # (rank, position, merged id): the lowest rank, leftmost
            for k in range(len(ids) - 1):
                m = self.ranks.get((ids[k], ids[k + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], k, m[1])
            if best is None:
                break
            ids[best[1]:best[1] + 2] = [best[2]]
        return ids


def _model(spec):
    kind = spec.get("type")
    if kind == "BPE":
        return _BPE(spec)
    if kind == "WordPiece":
        return _WordPiece(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "Unigram":
        return _Unigram(spec)
    raise ValueError(f"tokenizer.json: unknown model type {kind!r}")


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class TokenizerJSON:
    """``tokenizer.json`` (+ ``tokenizer_config.json``) of a directory, called
    as ``AutoTokenizer`` is by ``preprocess.PromptEncoder``."""

    def __init__(self, directory: str, defaults: Optional[dict] = None):
        """``defaults``: tokenizer_config entries the directory's own file
        does not set (a tokenizer class's defaults, such as BERT's pad
        token)."""
        with open(os.path.join(directory, "tokenizer.json")) as f:
            spec = json.load(f)
        self._setup(spec, {**(defaults or {}), **_read_config(directory)})

    @classmethod
    def from_spec(cls, spec: dict, cfg: dict) -> "TokenizerJSON":
        tok = cls.__new__(cls)
        tok._setup(spec, cfg)
        return tok

    def _setup(self, spec: dict, cfg: dict):
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self._template(spec.get("post_processor"))
        if cfg.get("padding_side", "right") != "right":
            raise ValueError("tokenizer_config.json: padding_side "
                             f"{cfg['padding_side']!r} is not handled here")

        # added tokens: the file's, then the config's special tokens (which
        # AutoTokenizer registers the same way)
        # ``tokenizers`` numbers an added token that is not in the model's
        # vocabulary itself, whatever id the file gives: the vocabulary's size,
        # or one past the largest added id, as they are added in file order
        self.added: Dict[str, Tuple[int, bool]] = {}
        n_vocab = len(spec["model"]["vocab"])
        for t in spec.get("added_tokens", []):
            for opt in ("lstrip", "rstrip", "single_word"):
                if t.get(opt):
                    raise ValueError(f"tokenizer.json: added token {t['content']!r} has "
                                     f"{opt}, which is not handled here")
            i = self.model.token_id(t["content"])
            if i is None:
                i = max([n_vocab] + [j + 1 for j, _ in self.added.values()])
            self.added[t["content"]] = (i, bool(t.get("normalized", False)))
        for key in ("pad_token", "eos_token", "unk_token", "bos_token", "cls_token",
                    "sep_token", "mask_token"):
            tok = cfg.get(key)
            tok = tok.get("content") if isinstance(tok, dict) else tok
            if tok and tok not in self.added:
                i = self.model.token_id(tok)
                if i is None:
                    raise ValueError(f"tokenizer_config.json: {key} {tok!r} is not in the vocab")
                self.added[tok] = (i, False)
        pad = cfg.get("pad_token")
        pad = pad.get("content") if isinstance(pad, dict) else pad
        self.pad_id = self.added[pad][0] if pad else None

    def _template(self, spec):
        self.template: List = [("A", None)]
        if spec is None or spec.get("type") == "ByteLevel":  # ByteLevel: offsets only
            return
        if spec.get("type") == "Sequence":
            kept = [p for p in spec["processors"] if p.get("type") != "ByteLevel"]
            if len(kept) > 1:
                raise ValueError("tokenizer.json: a Sequence post_processor with more than "
                                 "one template is not handled here")
            return self._template(kept[0] if kept else None)
        if spec.get("type") == "BertProcessing":
            self.template = [("special", [spec["cls"][1]]), ("A", None),
                             ("special", [spec["sep"][1]])]
            return
        if spec.get("type") != "TemplateProcessing":
            raise ValueError(f"tokenizer.json: unknown post_processor type {spec.get('type')!r}")
        self.template = []
        for item in spec["single"]:
            if "Sequence" in item:
                self.template.append(("A", None))
            else:
                name = item["SpecialToken"]["id"]
                self.template.append(("special", list(spec["special_tokens"][name]["ids"])))

    @staticmethod
    def _split(parts, contents):
        """Split each unmatched (text, None) part on the added-token
        ``contents``, longest first; matches become (content, id)."""
        if not contents:
            return parts
        rx = re.compile("|".join(re.escape(c) for c in sorted(contents, key=len,
                                                                reverse=True)))
        out = []
        for text, tid in parts:
            if tid is not None:
                out.append((text, tid))
                continue
            pos = 0
            for m in rx.finditer(text):
                if m.start() > pos:
                    out.append((text[pos:m.start()], None))
                out.append((m.group(), contents[m.group()]))
                pos = m.end()
            if pos < len(text):
                out.append((text[pos:], None))
        return out

    def encode(self, text: str) -> List[int]:
        """Ids of ``text`` before truncation, post-processing and padding."""
        raw = {c: i for c, (i, norm) in self.added.items() if not norm}
        normed = {c: i for c, (i, norm) in self.added.items() if norm}
        ids: List[int] = []
        for part, tid in self._split([(text, None)], raw):
            if tid is not None:
                ids.append(tid)
                continue
            for sub, sid in self._split([(self.normalize(part), None)], normed):
                if sid is not None:
                    ids.append(sid)
                    continue
                for piece in self.pre_tokenize([sub]):
                    ids.extend(self.model(piece))
        return ids

    def n_special(self) -> int:
        return sum(len(ids) for kind, ids in self.template if kind == "special")

    def __call__(self, texts: Sequence[str], padding="max_length", truncation=True,
                 max_length: int = 512, return_tensors="np"):
        """``{"input_ids", "attention_mask"}``, (B, max_length) int64 each:
        each text truncated to ``max_length`` minus the template's special
        tokens, post-processed, then padded on the right with the pad token
        (``AutoTokenizer``'s order; only this call shape is taken); the mask
        is 1 on the ids that are not padding."""
        if padding != "max_length" or return_tensors != "np":
            raise ValueError(f"padding={padding!r}, return_tensors={return_tensors!r}: only "
                             "'max_length' and 'np' are handled here")
        out = np.full((len(texts), max_length), -1, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if truncation:
                ids = ids[:max(max_length - self.n_special(), 0)]
            full: List[int] = []
            for kind, sp in self.template:
                full.extend(ids if kind == "A" else sp)
            if len(full) > max_length:
                raise ValueError(f"{len(full)} ids > max_length {max_length} with truncation off")
            if len(full) < max_length and self.pad_id is None:
                raise ValueError("padding needs a pad token (tokenizer_config.json pad_token)")
            out[i, :len(full)] = full
            out[i, len(full):] = self.pad_id if len(full) < max_length else 0
            mask[i, :len(full)] = 1
        return {"input_ids": out, "attention_mask": mask}


def _read_config(directory: str) -> dict:
    path = os.path.join(directory, "tokenizer_config.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


BERT_SPECIALS = {"pad_token": "[PAD]", "unk_token": "[UNK]", "cls_token": "[CLS]",
                 "sep_token": "[SEP]", "mask_token": "[MASK]"}


def load_bert_tokenizer(directory: str) -> TokenizerJSON:
    """The BERT WordPiece tokenizer of ``directory``, as
    ``BertTokenizerFast.from_pretrained`` builds it: from its
    ``tokenizer.json``, else from its ``vocab.txt`` (one token per line, the
    line number its id) with ``bert-base-uncased``'s defaults; raises
    ``FileNotFoundError`` when it holds neither."""
    if os.path.exists(os.path.join(directory, "tokenizer.json")):
        return TokenizerJSON(directory, defaults=BERT_SPECIALS)
    path = os.path.join(directory, "vocab.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{directory!r} holds neither tokenizer.json nor vocab.txt")
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab.setdefault(line.rstrip("\n"), i)
    cfg = {**BERT_SPECIALS, **_read_config(directory)}
    lower = cfg.get("do_lower_case", True)
    specials = [cfg[k] for k in BERT_SPECIALS if cfg.get(k) in vocab]
    spec = {
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": cfg.get("tokenize_chinese_chars", True),
                       "strip_accents": cfg.get("strip_accents"), "lowercase": lower},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "model": {"type": "WordPiece", "vocab": vocab, "unk_token": cfg["unk_token"],
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100},
        "post_processor": {"type": "BertProcessing",
                           "cls": [cfg["cls_token"], vocab[cfg["cls_token"]]],
                           "sep": [cfg["sep_token"], vocab[cfg["sep_token"]]]},
        "added_tokens": [{"id": vocab[t], "content": t, "normalized": False}
                         for t in specials],
    }
    return TokenizerJSON.from_spec(spec, cfg)
