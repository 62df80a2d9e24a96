"""HTTP-backed modules: model inference stays in external services.

Reference architecture: every text2vec/generative/reranker module is a thin
HTTP client to a model sidecar or vendor API (e.g.
modules/text2vec-transformers/clients/transformers.go:71 POSTs to the
sidecar's /vectors/; modules/text2vec-openai calls api.openai.com). The
TPU engine itself never blocks on model inference — same two-plane split
the north star keeps.

All clients use stdlib urllib (no extra deps); API keys come from env vars
named like the reference's (OPENAI_APIKEY, COHERE_APIKEY, ...) or from
module settings.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np

from weaviate_tpu_torch.modules.base import (
    Generative,
    MediaVectorizer,
    ModuleError,
    Reranker,
    TextVectorizer,
)


def _post_json(url: str, payload: dict, headers: dict | None = None,
               timeout: float = 60.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")[:500]
        raise ModuleError(f"{url} -> HTTP {e.code}: {body}") from e
    except urllib.error.URLError as e:
        raise ModuleError(f"{url} unreachable: {e.reason}") from e


def _api_key(settings: dict, env_var: str) -> str:
    key = settings.get("apiKey") or os.environ.get(env_var, "")
    if not key:
        raise ModuleError(f"missing API key ({env_var})")
    return key


class TransformersVectorizer(TextVectorizer):
    """text2vec-transformers sidecar client (clients/transformers.go:71).
    Sidecar endpoints: POST {origin}/vectors/ {"text": ...} ->
    {"vector": [...]}; separate passage/query origins supported like
    TRANSFORMERS_PASSAGE_INFERENCE_API / _QUERY_."""

    name = "text2vec-transformers"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        base = settings.get("inferenceUrl") or os.environ.get(
            "TRANSFORMERS_INFERENCE_API", "http://localhost:8000")
        self.passage_url = settings.get("passageInferenceUrl") or os.environ.get(
            "TRANSFORMERS_PASSAGE_INFERENCE_API", base)
        self.query_url = settings.get("queryInferenceUrl") or os.environ.get(
            "TRANSFORMERS_QUERY_INFERENCE_API", base)

    def _embed(self, origin: str, text: str, config: dict) -> np.ndarray:
        out = _post_json(f"{origin.rstrip('/')}/vectors",
                         {"text": text, "config": {
                             "pooling_strategy":
                                 config.get("poolingStrategy", "masked_mean")}})
        return np.asarray(out["vector"], dtype=np.float32)

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        return np.stack([self._embed(self.passage_url, t, config)
                         for t in texts])

    def vectorize_query(self, text: str, config: dict) -> np.ndarray:
        return self._embed(self.query_url, text, config)


class OpenAIVectorizer(TextVectorizer):
    """text2vec-openai (modules/text2vec-openai/clients)."""

    name = "text2vec-openai"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("baseURL")
                         or os.environ.get("OPENAI_BASE_URL")
                         or "https://api.openai.com").rstrip("/")
        self.settings = settings

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        key = _api_key({**self.settings, **config}, "OPENAI_APIKEY")
        model = config.get("model", "text-embedding-3-small")
        out = _post_json(f"{self.base_url}/v1/embeddings",
                         {"input": texts, "model": model},
                         {"Authorization": f"Bearer {key}"})
        data = sorted(out["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)


class CohereVectorizer(TextVectorizer):
    """text2vec-cohere; uses input_type search_document/search_query."""

    name = "text2vec-cohere"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("baseURL")
                         or "https://api.cohere.ai").rstrip("/")
        self.settings = settings

    def _embed(self, texts: list[str], config: dict,
               input_type: str) -> np.ndarray:
        key = _api_key({**self.settings, **config}, "COHERE_APIKEY")
        out = _post_json(f"{self.base_url}/v1/embed",
                         {"texts": texts,
                          "model": config.get("model", "embed-english-v3.0"),
                          "input_type": input_type},
                         {"Authorization": f"Bearer {key}"})
        return np.asarray(out["embeddings"], dtype=np.float32)

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        return self._embed(texts, config, "search_document")

    def vectorize_query(self, text: str, config: dict) -> np.ndarray:
        return self._embed([text], config, "search_query")[0]


class HuggingFaceVectorizer(TextVectorizer):
    """text2vec-huggingface (inference API feature-extraction)."""

    name = "text2vec-huggingface"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("endpointURL")
                         or "https://api-inference.huggingface.co").rstrip("/")
        self.settings = settings

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        key = _api_key({**self.settings, **config}, "HUGGINGFACE_APIKEY")
        model = config.get("model", "sentence-transformers/all-MiniLM-L6-v2")
        out = _post_json(
            f"{self.base_url}/pipeline/feature-extraction/{model}",
            {"inputs": texts, "options": {"wait_for_model": True}},
            {"Authorization": f"Bearer {key}"})
        arr = np.asarray(out, dtype=np.float32)
        if arr.ndim == 3:  # token-level output: mean-pool
            arr = arr.mean(axis=1)
        return arr


class OllamaVectorizer(TextVectorizer):
    """text2vec-ollama (modules/text2vec-ollama): local model server."""

    name = "text2vec-ollama"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("apiEndpoint")
                         or "http://localhost:11434").rstrip("/")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        out = _post_json(f"{self.base_url}/api/embed",
                         {"model": config.get("model", "nomic-embed-text"),
                          "input": texts})
        return np.asarray(out["embeddings"], dtype=np.float32)


class ClipVectorizer(MediaVectorizer):
    """multi2vec-clip sidecar client (modules/multi2vec-clip/clients):
    POST /vectorize {"texts": [...], "images": [b64...]} ->
    {"textVectors": [...], "imageVectors": [...]}."""

    name = "multi2vec-clip"
    media_kinds = ("image",)

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("inferenceUrl") or os.environ.get(
            "CLIP_INFERENCE_API", "http://localhost:8000")).rstrip("/")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        out = _post_json(f"{self.base_url}/vectorize", {"texts": texts})
        return np.asarray(out["textVectors"], dtype=np.float32)

    def vectorize_media(self, kind: str, data_b64: str,
                        config: dict) -> np.ndarray:
        out = _post_json(f"{self.base_url}/vectorize",
                         {"images": [data_b64]})
        return np.asarray(out["imageVectors"][0], dtype=np.float32)


class TransformersReranker(Reranker):
    """reranker-transformers sidecar client: POST /rerank
    {"query", "documents"} -> {"scores": [{"document","score"}]}."""

    name = "reranker-transformers"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("inferenceUrl") or os.environ.get(
            "RERANKER_INFERENCE_API", "http://localhost:8000")).rstrip("/")

    def rerank(self, query: str, documents: list[str],
               config: dict) -> list[float]:
        out = _post_json(f"{self.base_url}/rerank",
                         {"query": query, "documents": documents})
        scores = out["scores"]
        if scores and isinstance(scores[0], dict):
            return [s["score"] for s in scores]
        return [float(s) for s in scores]


class CohereReranker(Reranker):
    name = "reranker-cohere"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("baseURL")
                         or "https://api.cohere.ai").rstrip("/")
        self.settings = settings

    def rerank(self, query: str, documents: list[str],
               config: dict) -> list[float]:
        key = _api_key({**self.settings, **config}, "COHERE_APIKEY")
        out = _post_json(f"{self.base_url}/v1/rerank",
                         {"query": query, "documents": documents,
                          "model": config.get("model", "rerank-english-v3.0")},
                         {"Authorization": f"Bearer {key}"})
        scores = [0.0] * len(documents)
        for r in out["results"]:
            scores[r["index"]] = r["relevance_score"]
        return scores


class OpenAIGenerative(Generative):
    name = "generative-openai"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("baseURL")
                         or os.environ.get("OPENAI_BASE_URL")
                         or "https://api.openai.com").rstrip("/")
        self.settings = settings

    def generate(self, prompt: str, config: dict) -> str:
        key = _api_key({**self.settings, **config}, "OPENAI_APIKEY")
        out = _post_json(f"{self.base_url}/v1/chat/completions",
                         {"model": config.get("model", "gpt-4o-mini"),
                          "messages": [{"role": "user", "content": prompt}],
                          "max_tokens": config.get("maxTokens", 1024)},
                         {"Authorization": f"Bearer {key}"})
        return out["choices"][0]["message"]["content"]


class OllamaGenerative(Generative):
    name = "generative-ollama"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("apiEndpoint")
                         or "http://localhost:11434").rstrip("/")

    def generate(self, prompt: str, config: dict) -> str:
        out = _post_json(f"{self.base_url}/api/generate",
                         {"model": config.get("model", "llama3"),
                          "prompt": prompt, "stream": False})
        return out["response"]


class CohereGenerative(Generative):
    name = "generative-cohere"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.base_url = (settings.get("baseURL")
                         or "https://api.cohere.ai").rstrip("/")
        self.settings = settings

    def generate(self, prompt: str, config: dict) -> str:
        key = _api_key({**self.settings, **config}, "COHERE_APIKEY")
        out = _post_json(f"{self.base_url}/v1/chat",
                         {"message": prompt,
                          "model": config.get("model", "command-r")},
                         {"Authorization": f"Bearer {key}"})
        return out["text"]
