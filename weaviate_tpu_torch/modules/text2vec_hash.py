"""text2vec-hash: self-contained deterministic text embedder.

The reference ships one vectorizer that needs no external model service:
text2vec-bigram (modules/text2vec-bigram/vectorizer/vectorizer.go builds
vectors from character-bigram statistics). This is our analog: signed
feature hashing of word unigrams/bigrams and character trigrams onto a
fixed-dim unit sphere. Deterministic, dependency-free, and
similarity-preserving (cosine of hashed vectors approximates Jaccard-ish
token overlap), so nearText / hybrid / moves work end-to-end without a
model sidecar — the same role bigram plays in the reference's test stack.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from weaviate_tpu_torch.modules.base import TextVectorizer

_WORD = re.compile(r"[a-z0-9]+")


def _features(text: str) -> list[str]:
    words = _WORD.findall(text.lower())
    feats = list(words)
    feats.extend(f"{a}_{b}" for a, b in zip(words, words[1:]))
    for w in words:
        padded = f"^{w}$"
        feats.extend(padded[i:i + 3] for i in range(len(padded) - 2))
    return feats


def _hash(feature: str, seed: int) -> int:
    h = hashlib.blake2b(feature.encode(), digest_size=8,
                        salt=seed.to_bytes(8, "little")).digest()
    return int.from_bytes(h, "little")


class HashVectorizer(TextVectorizer):
    name = "text2vec-hash"

    def __init__(self, dim: int = 256, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        dim = int(config.get("dimensions", self.dim))
        out = np.zeros((len(texts), dim), dtype=np.float32)
        for i, text in enumerate(texts):
            for feat in _features(text):
                h = _hash(feat, self.seed)
                idx = h % dim
                sign = 1.0 if (h >> 63) & 1 else -1.0
                out[i, idx] += sign
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out
