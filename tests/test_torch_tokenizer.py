"""The port's tokenizers (``audio_residual_tpu_torch/utils/tokenizer.py``)
held against the JAX package's: ids and masks equal exactly, on vocab,
merges and CLIP bpe files the tests write, and for ``HashTokenizer``; and
``load_default_tokenizer``'s order (env paths, then ``transformers`` from its
local cache, then ``HashTokenizer`` with a warning). No test reaches a
network: ``transformers`` is replaced by a stand-in or made unimportable.
"""

import gzip
import json
import sys
import types

import numpy as np
import pytest

from audio_residual_tpu.utils import tokenizer as j_tok
from audio_residual_tpu_torch.utils import tokenizer as t_tok

TEXTS = ["hello dog", "This is a sound of dog.", "hello hello world 42!", "café crème",
         "  spaces   and\ttabs ", "", "a b c d e f g h i j k l m n o p"]
MERGES = [("h", "e"), ("he", "l"), ("hel", "l"), ("hell", "o"), ("Ġ", "d"), ("Ġd", "o"),
          ("Ġdo", "g"), ("o", "u"), ("Ġ", "s"), ("Ġs", "ou"), ("Ġsou", "n"), ("Ġsoun", "d")]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """A byte-level vocab.json / merges.txt: the special tokens, every
    byte's character and the merges' products."""
    d = tmp_path_factory.mktemp("bpe")
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in t_tok._bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES))
    return str(d / "vocab.json"), str(d / "merges.txt")


@pytest.fixture(scope="module")
def clip_bpe(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "bpe_simple_vocab.txt.gz"
    merges = ["d o", "do g</w>", "s o", "so u", "sou n", "soun d</w>", "h e", "he l", "hel l",
              "hell o</w>", "i s</w>", "t h", "th is</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2", *merges]))
    return str(path)


def _equal(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("context_length", [77, 8])
def test_byte_level_bpe_matches_jax(bpe_files, context_length):
    j = j_tok.ByteLevelBPETokenizer(*bpe_files, context_length=context_length)
    t = t_tok.ByteLevelBPETokenizer(*bpe_files, context_length=context_length)
    _equal(t(TEXTS), j(TEXTS))
    _equal(t("hello dog"), j("hello dog"))
    assert t.encode("hello dog sound") == j.encode("hello dog sound")


def test_byte_level_bpe_merges_the_test_vocab(bpe_files):
    """The merges apply: "hello" and " dog" are one token each."""
    t = t_tok.ByteLevelBPETokenizer(*bpe_files)
    vocab = json.load(open(bpe_files[0]))
    assert t.encode("hello dog") == [vocab["hello"], vocab["Ġdog"]]


@pytest.mark.parametrize("context_length", [77, 6])
def test_clip_bpe_matches_jax(clip_bpe, context_length):
    j = j_tok.ClipBPETokenizer(clip_bpe, context_length=context_length)
    t = t_tok.ClipBPETokenizer(clip_bpe, context_length=context_length)
    got, ref = t(TEXTS), j(TEXTS)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    assert t.encode("This is a dog sound") == j.encode("This is a dog sound")
    # EOT is the vocab's largest id, so each row's argmax is its EOT
    assert (got.argmax(-1) == (got > 0).sum(-1) - 1).all()


@pytest.mark.parametrize("vocab_size,context_length", [(50265, 77), (1000, 16), (30522, 5)])
def test_hash_tokenizer_matches_jax(vocab_size, context_length):
    j = j_tok.HashTokenizer(vocab_size=vocab_size, context_length=context_length)
    t = t_tok.HashTokenizer(vocab_size=vocab_size, context_length=context_length)
    _equal(t(TEXTS), j(TEXTS))
    _equal(t("This is a sound of rain."), j("This is a sound of rain."))


def test_default_tokenizer_takes_the_env_paths_first(bpe_files, monkeypatch):
    monkeypatch.setenv("ROBERTA_VOCAB_JSON", bpe_files[0])
    monkeypatch.setenv("ROBERTA_MERGES_TXT", bpe_files[1])
    t, j = t_tok.load_default_tokenizer(12), j_tok.load_default_tokenizer(12)
    assert isinstance(t, t_tok.ByteLevelBPETokenizer)
    _equal(t(TEXTS), j(TEXTS))


def test_default_tokenizer_then_asks_transformers_for_its_cache(monkeypatch):
    """Without env paths it takes ``transformers`` (here a stand-in) and asks
    it for the local cache only."""
    calls = []

    class _Tok:
        def __call__(self, texts, **kw):
            calls.append(kw)
            return {"input_ids": np.full((len(texts), kw["max_length"]), 7),
                    "attention_mask": np.ones((len(texts), kw["max_length"]), np.int64)}

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(name, **kw):
            calls.append((name, kw))
            return _Tok()

    monkeypatch.delenv("ROBERTA_VOCAB_JSON", raising=False)
    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=AutoTokenizer))
    out = t_tok.load_default_tokenizer(9)("a dog")
    assert calls[0] == ("roberta-base", {"local_files_only": True})
    assert calls[1] == dict(padding="max_length", truncation=True, max_length=9,
                            return_tensors="np")
    assert out["input_ids"].shape == (1, 9)


def test_default_tokenizer_falls_back_to_hash_with_a_warning(monkeypatch):
    monkeypatch.delenv("ROBERTA_VOCAB_JSON", raising=False)
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises
    with pytest.warns(UserWarning, match="HashTokenizer"):
        t = t_tok.load_default_tokenizer(16)
    with pytest.warns(UserWarning, match="HashTokenizer"):
        j = j_tok.load_default_tokenizer(16)
    assert isinstance(t, t_tok.HashTokenizer) and t.context_length == 16
    _equal(t(TEXTS), j(TEXTS))
