"""CLIP byte-pair-encoding tokenizer (parity with openai/CLIP SimpleTokenizer;
the port's own copy of tise_tpu/backbones/clip_tokenizer.py, pure Python).

Used by RP-COCO (RP_coco.py:70 ``clip.tokenize``) and PA (PA.py:35).  The BPE
merge table is data (``bpe_simple_vocab_16e6.txt.gz``, shipped with CLIP
weights) and is supplied by the user alongside the checkpoint.

Algorithm (the published tokenizer spec):
  * bytes<->unicode visible-codepoint mapping,
  * word-level regex split (contractions / letters / digits / other), with
    the ``regex`` module's Unicode classes where it is installed and an ``re``
    pattern that agrees with it on ASCII text where it is not,
  * per-word greedy lowest-rank BPE merges with an end-of-word marker,
  * context packed to 77 tokens: SOT ... EOT, zero padded; overlong inputs
    truncate with EOT kept in the last slot.

``SimpleTokenizer`` is a plain class, as in the JAX package: each instance
reads its merge table and keeps its own BPE cache.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77

try:  # CLIP's pattern uses \p classes from the `regex` module
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - fallback for ASCII captions
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[0-9]|[^\s\w]+""",
        _re.IGNORECASE,
    )


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a visible unicode char (reversible, BPE-safe)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


def basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Batch -> int32 [len(texts), context_length] (clip.tokenize parity:
        truncate keeps EOT in the last slot)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context_length:
                toks = toks[: context_length - 1] + [self.eot]
            out[i, : len(toks)] = toks
        return out
