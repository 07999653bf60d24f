"""CLIP byte-level BPE tokenizer: port of ``siss_tpu/models/clip_bpe.py``.

The OpenAI CLIP byte-level BPE over an SD checkpoint's ``tokenizer/``
folder (``vocab.json`` and ``merges.txt``):

1. clean: drop control and invalid characters, map whitespace to " ",
   CJK ideographs to standalone words, NFC-normalise, lowercase and
   collapse runs of whitespace;
2. split into words as CLIP's pattern does (``_PAT`` of the JAX module):
   the two special tokens, the contractions ``'s 't 're 've 'm 'll 'd``,
   runs of letters, single numbers, runs of other non-space characters;
3. per word: UTF-8 bytes → printable symbols (GPT-2's ``bytes_to_unicode``
   table), then greedy lowest-rank BPE merges, with ``</w>`` on the last
   symbol;
4. vocabulary lookup (unknown pieces → ``<|endoftext|>``), wrapped in
   ``<|startoftext|>`` … ``<|endoftext|>``, truncated to ``max_length``
   keeping the final EOS, padded with the EOS id.

Step 2 needs no ``regex`` module: the JAX module compiles CLIP's pattern
with ``\\p{L}``/``\\p{N}`` classes under IGNORECASE, which the standard
``re`` lacks (its ``[^\\W\\d_]`` and ``\\d`` disagree with them on thousands
of code points). ``split_words`` scans the text once and classifies each
character by ``unicodedata.category``: ``L*`` letters, ``N*`` numbers. It
agrees with the pattern on every code point Python's Unicode database
assigns; U+0345 (a combining mark whose case fold is a letter) matches no
branch of the case-insensitive pattern and is skipped, as there.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_BOS = "<|startoftext|>"
_EOS = "<|endoftext|>"
# The pattern's literal branches, in its order: the first that matches wins.
_LITERALS = (_BOS, _EOS, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Characters that match no branch of the case-insensitive pattern. The
# control characters U+001C–U+001F are not whitespace to it either; the
# cleaning step drops them before the split.
_UNMATCHED = frozenset("\u0345")
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte↔printable-unicode table: the 188 printable
    latin-1 bytes map to themselves, the rest shift up past U+0100 so no
    BPE symbol is ever whitespace or control."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if cp in (0, 0xFFFD) or (cat in ("Cc", "Cf") and ch not in ("\t", "\n", "\r")):
            continue
        if _is_cjk(cp):
            # CJK characters become words of their own (each gets its own
            # </w>), as in transformers' CLIPTokenizer without ftfy
            out.extend((" ", ch, " "))
        else:
            out.append(" " if (ch in " \t\n\r" or cat == "Zs") else ch)
    text = unicodedata.normalize("NFC", "".join(out)).lower()
    return " ".join(text.split())


def _kind(ch: str) -> str:
    """"L" letter, "N" number, "P" other non-space, " " skipped."""
    cat = unicodedata.category(ch)
    if cat[0] == "L":
        return "L"
    if cat[0] == "N":
        return "N"
    if ch in _UNMATCHED or (ch.isspace() and ch not in _NOT_SPACE):
        return " "
    return "P"


def _literal_at(text: str, i: int) -> str:
    """The first of ``_LITERALS`` at ``text[i:]`` compared case-insensitively
    (simple case folding, so "ſ" matches "s"), or ""."""
    for lit in _LITERALS:
        seg = text[i:i + len(lit)]
        if len(seg) == len(lit) and all(
                c == l or (len(c.casefold()) == 1 and c.casefold() == l)
                for c, l in zip(seg, lit)):
            return seg
    return ""


def split_words(text: str) -> List[str]:
    """The words CLIP's pattern finds in ``text``, in order."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = _literal_at(text, i)
        if lit:
            words.append(lit)
            i += len(lit)
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind == " ":
            i = j
            continue
        if kind != "N":  # letters and other characters run; numbers stand alone
            while j < n and _kind(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


class _Encoding:
    """The two arrays of transformers' BatchEncoding that callers read."""

    def __init__(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        self.input_ids = input_ids
        self.attention_mask = attention_mask

    def __getitem__(self, key):
        return {"input_ids": self.input_ids, "attention_mask": self.attention_mask}[key]


class CLIPBPETokenizer:
    """``tok(texts, padding="max_length", max_length=77, truncation=True,
    return_tensors="np").input_ids``: int64 [len(texts), max_length]."""

    def __init__(self, vocab_file: str, merges_file: str, model_max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder.get(_BOS)
        self.eos_token_id = self.encoder.get(_EOS)
        self.unk_token_id = self.eos_token_id
        self.pad_token_id = self.eos_token_id
        self._cache: Dict[str, List[str]] = {_BOS: [_BOS], _EOS: [_EOS]}

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self._cache[token] = list(word)
        return list(word)

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in split_words(_clean(text)):
            sym = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            pieces.extend(self._bpe(sym))
        return pieces

    def encode(self, text: str, max_length: int, truncation: bool = True) -> List[int]:
        ids = [self.encoder.get(p, self.unk_token_id) for p in self.tokenize(text)]
        if truncation and len(ids) > max_length - 2:
            ids = ids[:max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, texts: Union[str, Sequence[str]], padding: str = "max_length",
                 max_length: int = None, truncation: bool = True,
                 return_tensors: str = "np") -> _Encoding:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows, masks = [], []
        for t in texts:
            ids = self.encode(t, max_length, truncation=truncation)
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            rows.append(ids)
            masks.append(mask)
        return _Encoding(np.asarray(rows, np.int64), np.asarray(masks, np.int64))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        decoder = {v: k for k, v in self.encoder.items()}
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        toks = [decoder.get(int(i), "") for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in (_BOS, _EOS)]
        text = "".join(toks)
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def load_native_clip_tokenizer(path: str) -> CLIPBPETokenizer:
    """From a directory holding ``vocab.json`` and ``merges.txt`` (every SD
    checkpoint's ``tokenizer/`` folder)."""
    return CLIPBPETokenizer(os.path.join(path, "vocab.json"),
                            os.path.join(path, "merges.txt"))
