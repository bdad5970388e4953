"""Question tokenization (host side, pure Python).

A copy of ``isubgvqa_tpu/data/tokenizer.py`` (pure Python; the port
keeps its own copy so it never imports the JAX package).

The reference tokenizes questions with HuggingFace's
``CLIPTokenizerFast`` (``datasets/gqa.py:81-83,253-258``), which needs
downloaded vocab assets.  This module provides:

* :class:`ClipBPETokenizer` — a self-contained CLIP byte-pair-encoding
  implementation used when local ``vocab.json``/``merges.txt`` files
  are supplied (token-id compatible with the reference's tokenizer);
* :class:`HashWordTokenizer` — a deterministic, dependency-free
  fallback mapping lowercased word/punctuation tokens into the same id
  space via a stable hash, for environments with no CLIP assets
  (tests, offline machines).

Both emit fixed-length ``(input_ids, attention_mask)`` pairs so every
batch of a bucket has one static shape; CLIP conventions are kept
(<|startoftext|> ... <|endoftext|>, pad with the eos id, mask 1 on real
tokens).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from typing import Optional, Sequence

import numpy as np

CLIP_VOCAB_SIZE = 49408
BOS_ID = 49406
EOS_ID = 49407

_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+",
    re.IGNORECASE,
)


class HashWordTokenizer:
    """Deterministic hash tokenizer into the CLIP id space.

    ids land in ``[0, vocab_size - 2)`` (bos/eos reserved at the top of
    the table), stable across runs/processes via md5.
    """

    def __init__(self, vocab_size: int = CLIP_VOCAB_SIZE, max_len: int = 32):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        self.pad_id = self.eos_id  # CLIP pads with <|endoftext|>
        # question-length bucket routing already encodes every question
        # once (route_to_buckets -> count_tokens); caching by text makes
        # collate-time tokenization a dict hit.  Callers never mutate
        # the returned list (__call__ always slices a copy).
        self.encode = functools.lru_cache(maxsize=1 << 18)(self._encode)

    @functools.lru_cache(maxsize=65536)
    def _token_id(self, token: str) -> int:
        h = int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "little")
        return h % (self.vocab_size - 2)

    def tokenize(self, text: str) -> list[str]:
        return _WORD_RE.findall(text.lower().strip())

    def _encode(self, text: str) -> list[int]:
        ids = [self.bos_id]
        ids += [self._token_id(t) for t in self.tokenize(text)]
        ids.append(self.eos_id)
        return ids

    def count_tokens(self, text: str) -> int:
        """Token count incl. bos/eos — used by question-length
        bucketing to route a sample to the smallest length cap."""
        return len(self.encode(text))

    def decode_token(self, token_id: int) -> str:
        """A token's text (a hash has no inverse: a placeholder)."""
        return f"<tok{token_id}>"

    def __call__(self, texts: Sequence[str], max_len: Optional[int] = None):
        """Batch encode → (input_ids [B, L], attention_mask [B, L])."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_len or self.max_len
        ids = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for b, t in enumerate(texts):
            enc = self.encode(t)[:L]
            if len(enc) == L:
                enc[-1] = self.eos_id
            ids[b, : len(enc)] = enc
            mask[b, : len(enc)] = 1
        return ids, mask


class ClipBPETokenizer(HashWordTokenizer):
    """Self-contained CLIP BPE; id-compatible with openai/clip when
    given the published ``vocab.json`` + ``merges.txt``."""

    def __init__(self, vocab_json: str, merges_txt: str, max_len: int = 32):
        super().__init__(CLIP_VOCAB_SIZE, max_len)
        with open(vocab_json, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_txt, encoding="utf-8") as f:
            merges = f.read().split("\n")[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache: dict[str, str] = {}
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        self.pad_id = self.eos_id

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def decode_token(self, token_id: int) -> str:
        return self.decoder.get(token_id, "<unk>").replace("</w>", "")

    def _encode(self, text: str) -> list[int]:
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids = [self.bos_id]
        for tok in _WORD_RE.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids += [self.encoder[t] for t in self._bpe(tok).split(" ")
                    if t in self.encoder]
        ids.append(self.eos_id)
        return ids


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def build_tokenizer(clip_dir: Optional[str] = None, max_len: int = 32,
                    vocab_size: int = CLIP_VOCAB_SIZE):
    """Prefer real CLIP BPE assets when present; otherwise hash fallback."""
    if clip_dir:
        vj = os.path.join(clip_dir, "vocab.json")
        mt = os.path.join(clip_dir, "merges.txt")
        if os.path.isfile(vj) and os.path.isfile(mt):
            return ClipBPETokenizer(vj, mt, max_len=max_len)
    return HashWordTokenizer(vocab_size=vocab_size, max_len=max_len)
