"""Seeded inputs: prompts, their token ids, condition images, clip batches.

The CLIP vocabulary is not shipped, so prompts are words of a numbered
vocabulary (``w<id>``) and ``WordTokenizer`` maps each word to its id, with
CLIP's start and end ids around them and end ids as padding, as the
program's tokenizer frames a prompt.  The benchmark hands the same
tokenizer, images and seeds to the program and to the reference.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# CLIP's last two ids are its start and end of text
_SPECIAL = 2


def rng(*keys: int) -> np.random.Generator:
    """A generator for ``keys`` (the run's seed first): any non-negative
    whole numbers, of any size."""
    return np.random.default_rng([int(k) for k in keys])


class WordTokenizer:
    """``tokenizer(texts, padding="max_length") -> (B, L) int32`` for
    prompts made of ``w<id>`` words."""

    def __init__(self, vocab_size: int, context_length: int):
        self.vocab_size, self.context_length = vocab_size, context_length
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def encode(self, text: str) -> List[int]:
        ids = [int(word[1:]) for word in text.split()]
        if any(not 0 <= i < self.vocab_size - _SPECIAL for i in ids):
            raise ValueError(f"word outside the vocabulary in {text!r}")
        return ids

    def __call__(self, texts, padding: str = "max_length", truncation: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.eos, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.bos] + self.encode(text)[: self.context_length - 2] + [self.eos]
            out[row, : len(ids)] = ids
        return out


def prompt(gen: np.random.Generator, words: Sequence[int], vocab_size: int) -> str:
    """A prompt of ``words[0]`` to ``words[1]`` words."""
    n = int(gen.integers(words[0], words[1] + 1))
    return " ".join(f"w{i}" for i in gen.integers(0, vocab_size - _SPECIAL, n))


def image(gen: np.random.Generator, height: int, width: int, cell: int = 32) -> np.ndarray:
    """A uint8 ``(H, W, 3)`` image: coarse colour blocks of ``cell`` pixels
    with fine noise on top, so that it has both structure and detail."""
    coarse = gen.random((-(-height // cell), -(-width // cell), 3), dtype=np.float32)
    base = np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:height, :width]
    noisy = 0.8 * base + 0.2 * gen.random((height, width, 3), dtype=np.float32)
    return np.clip(noisy * 255.0, 0, 255).round().astype(np.uint8)


def resample(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour ``size`` x ``size`` copy of an image (the IP-Adapter
    image of a request, at the image encoder's input size)."""
    h, w = img.shape[:2]
    return img[(np.arange(size) * h) // size][:, (np.arange(size) * w) // size].copy()
