"""Stopword presets.

Reference: adapters/repos/db/inverted/stopwords/ (preset "en" ≈ Lucene's
english list; configurable additions/removals per class,
entities/models/StopwordConfig).
"""

from __future__ import annotations

_EN = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)

_PRESETS = {"en": _EN, "none": frozenset()}


class StopwordDetector:
    def __init__(self, preset: str = "en", additions=(), removals=()):
        base = _PRESETS.get(preset)
        if base is None:
            raise ValueError(f"unknown stopword preset {preset!r}")
        self._words = (set(base) | {w.lower() for w in additions}) - {
            w.lower() for w in removals
        }

    def is_stopword(self, token: str) -> bool:
        return token.lower() in self._words

    def filter(self, tokens: list[str]) -> list[str]:
        return [t for t in tokens if t.lower() not in self._words]
