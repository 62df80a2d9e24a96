"""Tokenizers.

Reference: entities/models tokenization enum + adapters/repos/db/inverted/
analyzer.go and helpers/tokenizer.go. Four modes with reference semantics:

- ``word``:       lowercase, split on any non-alphanumeric rune
- ``lowercase``:  lowercase, split on whitespace
- ``whitespace``: split on whitespace, case preserved
- ``field``:      trim whitespace, the whole value is one token
"""

from __future__ import annotations

import re

_NON_ALNUM = re.compile(r"[^0-9A-Za-zÀ-ɏЀ-ӿ一-鿿]+")

TOKENIZATIONS = ("word", "lowercase", "whitespace", "field")


def tokenize(text, tokenization: str = "word") -> list[str]:
    """Tokenize a text value (str or list of str)."""
    if isinstance(text, (list, tuple)):
        out: list[str] = []
        for t in text:
            out.extend(tokenize(t, tokenization))
        return out
    if text is None:
        return []
    text = str(text)
    if tokenization == "word":
        return [t for t in _NON_ALNUM.split(text.lower()) if t]
    if tokenization == "lowercase":
        return text.lower().split()
    if tokenization == "whitespace":
        return text.split()
    if tokenization == "field":
        t = text.strip()
        return [t] if t else []
    raise ValueError(f"unknown tokenization {tokenization!r}")
