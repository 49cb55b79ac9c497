"""CLIP byte-pair-encoding tokenizer (offline).

The port's own copy of the JAX package's tokenizer (that module imports
no JAX, but the port depends on nothing of the JAX package).
This standalone implementation of the standard CLIP BPE reads the same
``vocab.json`` + ``merges.txt`` files from a local checkpoint directory —
no network, no transformers dependency.

Algorithm: OpenAI CLIP's SimpleTokenizer scheme — byte-to-unicode mapping,
end-of-word ``</w>`` marker, greedy lowest-rank pair merging, then
``<|startoftext|> tokens <|endoftext|>`` framing padded to ``context_length``
with the end token (HF CLIPTokenizer pad_token for SD1.5).
"""

from __future__ import annotations

import functools
import html
import json
import os
from typing import Iterable, List, Sequence

import numpy as np

try:  # `regex` supports \p{L}; stdlib re does not
    import regex as re

    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        re.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    import re

    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
        re.IGNORECASE | re.UNICODE,
    )


@functools.lru_cache()
def _bytes_to_unicode():
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
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Sequence[str]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class CLIPTokenizer:
    """Offline CLIP BPE tokenizer.

    Args:
      vocab_path: path to ``vocab.json`` (token -> id)
      merges_path: path to ``merges.txt``
      context_length: max sequence length (77 for SD1.5)
    """

    def __init__(self, vocab_path: str, merges_path: str, context_length: int = 77):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line of HF merges.txt is a version header
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self.byte_encoder = _bytes_to_unicode()
        self.context_length = context_length
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self._cache = {}

    @classmethod
    def from_pretrained(cls, path: str, context_length: int = None) -> "CLIPTokenizer":
        """Load from a directory holding vocab.json + merges.txt (the HF
        tokenizer subfolder layout of an SD checkpoint).  Reads
        model_max_length from tokenizer_config.json when present."""
        if context_length is None:
            cfg_path = os.path.join(path, "tokenizer_config.json")
            context_length = 77
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    context_length = int(json.load(f).get("model_max_length", 77))
        return cls(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            context_length,
        )

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
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
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def add_tokens(self, tokens: List[str]) -> List[int]:
        """Register placeholder tokens (textual inversion); returns new ids.
        Added tokens are matched verbatim before BPE."""
        ids = []
        for t in tokens:
            if t in self.encoder:
                raise ValueError(f"token already exists: {t}")
            self.encoder[t] = len(self.encoder)
            self.decoder[self.encoder[t]] = t
            ids.append(self.encoder[t])
        self._added = getattr(self, "_added", set()) | set(tokens)
        return ids

    def encode(self, text: str) -> List[int]:
        """BPE ids without special tokens.  Added (textual-inversion)
        placeholder tokens are matched verbatim before BPE splitting."""
        added = getattr(self, "_added", set())
        segments = [(_clean(text), False)]
        if added:
            import re as _re

            pat = _re.compile(
                "(" + "|".join(_re.escape(t.lower()) for t in sorted(added, key=len, reverse=True)) + ")"
            )
            segments = [
                (seg, seg in {t.lower() for t in added})
                for seg in pat.split(_clean(text))
                if seg
            ]
        ids: List[int] = []
        lower_added = {t.lower(): t for t in added}
        for seg, is_added in segments:
            if is_added:
                ids.append(self.encoder[lower_added[seg]])
                continue
            for token in _PAT.findall(seg):
                token_bytes = token.encode("utf-8")
                mapped = "".join(self.byte_encoder[b] for b in token_bytes)
                ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return (
            raw.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def __call__(
        self,
        texts,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> np.ndarray:
        """Batch-tokenize to (B, L) int32 ids with BOS/EOS framing.

        padding='max_length' pads to context_length (pipeline behavior);
        'longest' pads to the longest sequence in the batch (training's
        behavior).
        """
        if isinstance(texts, str):
            texts = [texts]
        encoded = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[: self.context_length - 2]
            encoded.append([self.bos] + ids + [self.eos])
        if padding == "max_length":
            length = self.context_length
        elif padding == "longest":
            length = min(max(len(e) for e in encoded), self.context_length)
        else:
            raise ValueError(f"unknown padding mode: {padding}")
        out = np.full((len(encoded), length), self.eos, dtype=np.int32)
        for i, e in enumerate(encoded):
            out[i, : len(e)] = e[:length]
        return out


def make_test_tokenizer(tmpdir: str, vocab_words=("a", "cat", "dog")) -> CLIPTokenizer:
    """Build a miniature but fully functional tokenizer for unit tests."""
    byte_vocab = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(byte_vocab)}
    for c in byte_vocab:
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for w in vocab_words:
        # merge chars left to right: "c a" -> "ca", "ca t</w>" -> ...
        acc = w[0]
        for i, ch in enumerate(w[1:], start=2):
            tail = ch + ("</w>" if i == len(w) else "")
            merges.append((acc, tail))
            acc += tail
            if acc not in vocab:
                vocab[acc] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    vpath = os.path.join(tmpdir, "vocab.json")
    mpath = os.path.join(tmpdir, "merges.txt")
    with open(vpath, "w") as f:
        json.dump(vocab, f)
    with open(mpath, "w") as f:
        f.write("#version: test\n")
        f.write("\n".join(" ".join(m) for m in merges))
    with open(os.path.join(tmpdir, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 16}, f)
    return CLIPTokenizer(vpath, mpath, context_length=16)
