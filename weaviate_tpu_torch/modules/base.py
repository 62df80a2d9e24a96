"""Module capability interfaces.

Reference: entities/modulecapabilities/*.go — a module declares capabilities
(Vectorizer, Searcher, AdditionalProperties, BackupBackend, ...) and the
provider dispatches on them (usecases/modules/modules.go:40). Here a module
subclasses the capability base matching what it provides; the provider
dispatches on isinstance.
"""

from __future__ import annotations

import numpy as np


class ModuleError(Exception):
    pass


class Module:
    """Base for all modules. ``name`` is the registry key used in
    VectorConfig.vectorizer / CollectionConfig.module_config."""

    name: str = ""

    def init(self, settings: dict | None = None) -> None:
        """Startup hook (reference: module Init at configure_api.go:403)."""

    def meta(self) -> dict:
        return {"name": self.name}


class TextVectorizer(Module):
    """text2vec-* capability (reference: modulecapabilities/vectorizer.go)."""

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        """Embed a batch of corpus texts -> [n, dim] float32."""
        raise NotImplementedError

    def vectorize_query(self, text: str, config: dict) -> np.ndarray:
        """Embed one query text; defaults to the corpus path (some APIs use
        a dedicated query model / input_type)."""
        return self.vectorize([text], config)[0]


class MediaVectorizer(Module):
    """multi2vec-* capability: embeds text and base64 media into one space."""

    media_kinds: tuple[str, ...] = ()

    def vectorize_media(self, kind: str, data_b64: str,
                        config: dict) -> np.ndarray:
        raise NotImplementedError

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        raise NotImplementedError

    def vectorize_query(self, text: str, config: dict) -> np.ndarray:
        return self.vectorize([text], config)[0]


class Reranker(Module):
    """reranker-* capability (reference: modules/reranker-*)."""

    def rerank(self, query: str, documents: list[str],
               config: dict) -> list[float]:
        raise NotImplementedError


class Generative(Module):
    """generative-* capability (reference: modules/generative-*)."""

    def generate(self, prompt: str, config: dict) -> str:
        raise NotImplementedError


class BackupBackend(Module):
    """backup-* capability (reference: modulecapabilities/backup.go:
    PutObject/GetObject/Initialize/HomeDir...)."""

    def put_file(self, backup_id: str, key: str, src_path: str) -> None:
        """Streamed upload; default buffers (override to stream)."""
        with open(src_path, "rb") as f:
            self.put(backup_id, key, f.read())

    def get_file(self, backup_id: str, key: str, dst_path: str) -> None:
        """Streamed download; default buffers (override to stream)."""
        import os

        data = self.get(backup_id, key)
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        with open(dst_path, "wb") as f:
            f.write(data)

    def initialize(self, backup_id: str) -> None:
        raise NotImplementedError

    def put(self, backup_id: str, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, backup_id: str, key: str) -> bytes:
        raise NotImplementedError

    def list(self, backup_id: str) -> list[str]:
        raise NotImplementedError

    def home_dir(self, backup_id: str) -> str:
        raise NotImplementedError


class QnA(Module):
    """qna-* capability (reference: modules/qna-{openai,transformers} —
    extractive question answering over a result's text)."""

    def answer(self, text: str, question: str, config: dict) -> dict:
        """-> {"answer": str|None, "certainty": float|None,
        "startPosition": int, "endPosition": int, "hasAnswer": bool}"""
        raise NotImplementedError


class NER(Module):
    """ner-transformers capability: token classification over a text."""

    def recognize(self, text: str, config: dict) -> list[dict]:
        """-> [{"entity", "word", "certainty", "startPosition",
        "endPosition"}]"""
        raise NotImplementedError


class Summarizer(Module):
    """sum-transformers capability: abstractive summaries of a text."""

    def summarize(self, text: str, config: dict) -> list[dict]:
        """-> [{"property", "result"}]"""
        raise NotImplementedError


class SpellCheck(Module):
    """text-spellcheck capability: check/correct query text."""

    def check(self, text: str, config: dict) -> dict:
        """-> {"originalText", "correctedText", "didYouMean",
        "numberOfCorrections"}"""
        raise NotImplementedError
