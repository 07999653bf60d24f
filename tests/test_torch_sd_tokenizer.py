"""The port's CLIP tokenizer (``siss_tpu_torch/models/clip_bpe.py``) against
the JAX package's ``CLIPBPETokenizer``: the same ids, exactly, on the two
synthetic vocabularies the JAX tests build (a byte-level vocabulary with
merges, as in ``tests/test_clip_bpe_parity.py``, and a word-piece one
without byte fallback, as in ``tests/test_clip_tokenizer_path.py``), over
accents, CJK, superscripts and fractions, contractions, punctuation runs
and truncation at short lengths; then again in a subprocess where
``import regex`` fails, which the port never needs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from siss_tpu.models.clip_bpe import CLIPBPETokenizer as JaxTokenizer
from siss_tpu.models.clip_bpe import _PAT, bytes_to_unicode
from siss_tpu_torch.models.clip_bpe import CLIPBPETokenizer, split_words
from siss_tpu_torch.models.clip_text import load_clip_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "a photo of a cat",
    "A PHOTO OF A CAT",
    "  weird   spacing\tand\nnewlines  ",
    "the cat's photo",
    "it's, isn't; \"quoted\"!",
    "THEY'RE here, we've gone, I'm in, you'll see, he'd go",
    "café crème déjà",
    "naïve façade — em–dash…",
    "emoji 🎨🖼️ and 中文字",
    "x² + y³ = ½ of ¼",
    "123 456.789",
    "!!!???... --- ***",
    "!'s and ?'ll",
    "photo photo photo " * 30,
    "ingesting the cathode",
    "<|endoftext|>",
    "<|startoftext|>a cat<|endoftext|>",
    "it'ſ the ͅgreek",
    "",
]
LENGTHS = (77, 16, 8, 3)


def _byte_vocab():
    """The byte-level vocabulary: 256 byte symbols, each with </w>, merged
    tokens in merge order, then BOS/EOS (``test_clip_bpe_parity.py``)."""
    syms = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {}
    for s in syms:
        vocab[s] = len(vocab)
    for s in syms:
        vocab[s + "</w>"] = len(vocab)
    merges = ["p h", "ph o", "t o</w>", "pho t", "phot o</w>", "c a", "a t</w>", "ca t</w>",
              "o f</w>", "t h", "th e</w>", "i n", "in g</w>", "2 3</w>", "' s</w>", "e ́"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def _word_vocab():
    """Letters and word pieces only, no byte fallback
    (``test_clip_tokenizer_path.py``)."""
    words = ["cat", "dog", "a", "photo", "of", "the"]
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in words:
        for i in range(1, len(w) + 1):
            vocab.setdefault(w[:i] + ("</w>" if i == len(w) else ""), len(vocab))
        vocab.setdefault(w + "</w>", len(vocab))
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    merges = [f"{w[:i]} {w[i]}{'</w>' if i + 1 == len(w) else ''}"
              for w in words for i in range(1, len(w))]
    return vocab, merges


@pytest.fixture(scope="module", params=["bytes", "words"])
def vocab_dir(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"clip_{request.param}")
    vocab, merges = (_byte_vocab if request.param == "bytes" else _word_vocab)()
    with open(root / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(root / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(root)


def _jax_ids(vocab_dir):
    tok = JaxTokenizer(os.path.join(vocab_dir, "vocab.json"), os.path.join(vocab_dir, "merges.txt"))
    return {n: tok(TEXTS, max_length=n).input_ids.tolist() for n in LENGTHS}


def test_split_matches_clip_pattern():
    import regex

    pat = regex.compile(_PAT, regex.IGNORECASE)
    for text in TEXTS:
        assert split_words(text) == pat.findall(text), text


def test_ids_match_jax(vocab_dir):
    ours = load_clip_tokenizer(vocab_dir)
    assert isinstance(ours, CLIPBPETokenizer)
    theirs = JaxTokenizer(os.path.join(vocab_dir, "vocab.json"),
                          os.path.join(vocab_dir, "merges.txt"))
    assert (ours.bos_token_id, ours.eos_token_id) == (theirs.bos_token_id, theirs.eos_token_id)
    for n in LENGTHS:
        a, b = ours(TEXTS, max_length=n), theirs(TEXTS, max_length=n)
        np.testing.assert_array_equal(a.input_ids, b.input_ids, err_msg=f"max_length {n}")
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
        assert a.input_ids.dtype == np.int64 and a.input_ids.shape == (len(TEXTS), n)
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text), text
    ids = ours("a photo of the cat", max_length=16).input_ids[0]
    assert ours.decode(ids) == theirs.decode(ids)


def test_ids_match_jax_without_regex(vocab_dir):
    """The port's tokenizer in a process where ``import regex`` raises."""
    code = (
        "import json, sys\n"
        "sys.modules['regex'] = None\n"
        "from siss_tpu_torch.models.clip_text import load_clip_tokenizer\n"
        "try:\n"
        "    import regex\n"
        "    sys.exit('regex imported')\n"
        "except ImportError:\n"
        "    pass\n"
        f"tok = load_clip_tokenizer({vocab_dir!r})\n"
        f"texts = json.loads({json.dumps(json.dumps(TEXTS))})\n"
        f"ids = {{n: tok(texts, max_length=n).input_ids.tolist() for n in {LENGTHS!r}}}\n"
        "print(json.dumps(ids))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = {int(k): v for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}
    assert got == _jax_ids(vocab_dir)


def test_missing_files_give_no_tokenizer(tmp_path):
    assert load_clip_tokenizer(str(tmp_path / "nowhere")) is None
    assert load_clip_tokenizer(None) is None
