"""Tokenizers for the text tower.

A copy of ``audio_residual_tpu/utils/tokenizer.py`` (pure Python and numpy;
the port imports nothing of the JAX package). Three tiers, mirroring the
reference's tokenizer mux (`training/data.py:48-85` +
`clap_module/tokenizer.py`):

  * :class:`ByteLevelBPETokenizer` — RoBERTa/GPT-2 byte-level BPE from
    ``vocab.json`` + ``merges.txt``. Pads/truncates to 77 tokens with
    ``<s> ... </s>`` and an attention mask — the contract of
    ``RobertaTokenizer(padding="max_length", truncation=True, max_length=77)``
    (`hook.py:66-73`).
  * :class:`ClipBPETokenizer` — the CLIP ``SimpleTokenizer`` equivalent
    (`clap_module/tokenizer.py:68-180`), for ``tmodel="transformer"``; loads
    the gzip'd vocab file.
  * :class:`HashTokenizer` — deterministic fallback (hash words into the
    vocab range) for asset-free environments; NOT text-faithful, used by
    tests and random-weight pipelines only.

:func:`load_default_tokenizer` keeps the JAX package's order (env paths,
then ``transformers``, then :class:`HashTokenizer` with a warning), except
that it asks ``transformers`` for its local cache only: the port fetches
nothing.
"""

from __future__ import annotations

import gzip
import json
import os
from functools import lru_cache

import numpy as np

__all__ = ["ByteLevelBPETokenizer", "ClipBPETokenizer", "HashTokenizer", "load_default_tokenizer"]


@lru_cache()
def _bytes_to_unicode():
    """GPT-2's reversible byte<->unicode map (public algorithm)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
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


class _BPE:
    def __init__(self, merges: list[tuple[str, str]]):
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.cache: dict[str, tuple[str, ...]] = {}

    def __call__(self, token: str) -> tuple[str, ...]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if bigram not in self.ranks:
                break
            a, b = bigram
            new = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new.append(a + b)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
            pairs = _get_pairs(word) if len(word) > 1 else set()
        self.cache[token] = word
        return word


def _word_split(text: str):
    """GPT-2 pre-tokenization pattern (contractions / words / numbers /
    punctuation / whitespace), stdlib `regex`-free approximation via `re`."""
    import re

    pat = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+"
    )
    return pat.findall(text)


class ByteLevelBPETokenizer:
    """RoBERTa byte-level BPE from vocab.json + merges.txt files."""

    def __init__(self, vocab_path: str, merges_path: str, *, context_length: int = 77):
        with open(vocab_path) as f:
            self.vocab: dict[str, int] = json.load(f)
        with open(merges_path) as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        self.bpe = _BPE([m for m in merges if len(m) == 2])
        self.byte_map = _bytes_to_unicode()
        self.context_length = context_length
        self.bos = self.vocab.get("<s>", 0)
        self.eos = self.vocab.get("</s>", 2)
        self.pad = self.vocab.get("<pad>", 1)
        self.unk = self.vocab.get("<unk>", 3)

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in _word_split(text):
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            for piece in self.bpe(mapped):
                ids.append(self.vocab.get(piece, self.unk))
        return ids

    def __call__(self, texts: str | list[str]) -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        L = self.context_length
        input_ids = np.full((len(texts), L), self.pad, np.int64)
        mask = np.zeros((len(texts), L), np.int64)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: L - 2] + [self.eos]
            input_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


class ClipBPETokenizer:
    """CLIP SimpleTokenizer semantics (`clap_module/tokenizer.py:68-180`):
    lowercase + whitespace-normalise, byte-level BPE with ``</w>`` word-end
    markers, wrap in <start_of_text>/<end_of_text>, pad to 77."""

    def __init__(self, bpe_path: str, *, context_length: int = 77):
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_map = _bytes_to_unicode()
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.cache: dict[str, list[str]] = {}

    def _bpe_word(self, token: str) -> list[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            a, b = bigram
            new = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new.append(a + b)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        import re

        text = " ".join(text.lower().strip().split())
        ids = []
        for word in re.findall(r"[a-z]+|[0-9]|[^\sa-z0-9]+", text):
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder.get(p, 0) for p in self._bpe_word(mapped))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        L = self.context_length
        out = np.zeros((len(texts), L), np.int64)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: L - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic word-hash fallback — NOT text-faithful. For tests and
    random-weight pipelines where no vocab assets exist."""

    def __init__(self, vocab_size: int = 50265, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length

    def __call__(self, texts: str | list[str]) -> dict[str, np.ndarray]:
        import hashlib

        if isinstance(texts, str):
            texts = [texts]
        L = self.context_length
        input_ids = np.ones((len(texts), L), np.int64)  # pad id 1
        mask = np.zeros((len(texts), L), np.int64)
        for i, t in enumerate(texts):
            ids = [0]  # <s>
            for w in t.lower().split()[: L - 2]:
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                ids.append(4 + h % (self.vocab_size - 4))
            ids.append(2)  # </s>
            input_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


def load_default_tokenizer(context_length: int = 77):
    """Best-effort RoBERTa tokenizer: explicit env paths
    (``ROBERTA_VOCAB_JSON`` / ``ROBERTA_MERGES_TXT``) -> ``transformers``
    with ``roberta-base`` in its local cache -> HashTokenizer fallback (with
    a warning)."""
    vocab = os.environ.get("ROBERTA_VOCAB_JSON")
    merges = os.environ.get("ROBERTA_MERGES_TXT")
    if vocab and merges and os.path.exists(vocab) and os.path.exists(merges):
        return ByteLevelBPETokenizer(vocab, merges, context_length=context_length)
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("roberta-base", local_files_only=True)

        class _HF:
            context_length_ = context_length

            def __call__(self, texts):
                r = tok(
                    texts if isinstance(texts, list) else [texts],
                    padding="max_length", truncation=True,
                    max_length=context_length, return_tensors="np",
                )
                return {"input_ids": r["input_ids"], "attention_mask": r["attention_mask"]}

        return _HF()
    except Exception:
        import warnings

        warnings.warn(
            "No RoBERTa vocab assets available (set ROBERTA_VOCAB_JSON/"
            "ROBERTA_MERGES_TXT or install the HF cache); falling back to a "
            "non-faithful HashTokenizer."
        )
        return HashTokenizer(context_length=context_length)
