"""Extended module roster: the rest of the reference's 38-module ecosystem.

Reference: modules/* — every entry is a thin HTTP client to a sidecar
container (contextionary, bind, img2vec-neural, qna/ner/sum-transformers,
gpt4all) or a vendor API (palm, aws, jinaai, voyageai, octoai, anyscale,
mistral). Module names, env-var names, and sidecar endpoint shapes follow
the reference so existing deployments' configuration carries over.
text2vec-bigram is self-contained (hashed character bigrams), like the
reference's dev-oriented bigram module.
"""

from __future__ import annotations

import os

import numpy as np

from weaviate_tpu_torch.modules.base import (
    Generative,
    MediaVectorizer,
    ModuleError,
    NER,
    QnA,
    Reranker,
    SpellCheck,
    Summarizer,
    TextVectorizer,
)
from weaviate_tpu_torch.modules.http_modules import _api_key, _post_json


def _origin(settings: dict, key: str, env_var: str, default: str) -> str:
    return (settings.get(key) or os.environ.get(env_var, default)).rstrip("/")


# ---- text2vec -------------------------------------------------------------


class ContextionaryVectorizer(TextVectorizer):
    """text2vec-contextionary sidecar (modules/text2vec-contextionary):
    POST {origin}/v1/vectorize {"text": ...} -> {"vector": [...]}."""

    name = "text2vec-contextionary"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "CONTEXTIONARY_URL", "http://localhost:9999")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        return np.stack([
            np.asarray(_post_json(f"{self.base}/v1/vectorize",
                                  {"text": t})["vector"], dtype=np.float32)
            for t in texts])


class PalmVectorizer(TextVectorizer):
    """text2vec-palm (Google Vertex embeddings API)."""

    name = "text2vec-palm"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        cfg = {**self.settings, **config}
        project = cfg.get("projectId")
        model = cfg.get("modelId", "textembedding-gecko@001")
        if not project:
            raise ModuleError("text2vec-palm needs moduleConfig.projectId")
        key = _api_key(cfg, "PALM_APIKEY")
        base = cfg.get("apiEndpoint",
                       "https://us-central1-aiplatform.googleapis.com")
        url = (f"{base}/v1/projects/{project}/locations/us-central1/"
               f"publishers/google/models/{model}:predict")
        out = _post_json(url, {"instances": [{"content": t} for t in texts]},
                         headers={"Authorization": f"Bearer {key}"})
        return np.asarray(
            [p["embeddings"]["values"] for p in out["predictions"]],
            dtype=np.float32)


class AWSVectorizer(TextVectorizer):
    """text2vec-aws. Real Bedrock needs SigV4 request signing; this client
    targets a pre-signed/proxy endpoint (AWS_BEDROCK_ENDPOINT) the way
    test rigs front Bedrock, and errors clearly otherwise."""

    name = "text2vec-aws"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        cfg = {**self.settings, **config}
        endpoint = cfg.get("endpoint") or os.environ.get(
            "AWS_BEDROCK_ENDPOINT", "")
        if not endpoint:
            raise ModuleError(
                "text2vec-aws needs an endpoint (moduleConfig.endpoint or "
                "AWS_BEDROCK_ENDPOINT; direct Bedrock access requires "
                "SigV4 signing this build does not perform)")
        model = cfg.get("model", "amazon.titan-embed-text-v1")
        out = [
            _post_json(f"{endpoint.rstrip('/')}/model/{model}/invoke",
                       {"inputText": t})["embedding"]
            for t in texts
        ]
        return np.asarray(out, dtype=np.float32)


class _SimpleEmbedAPI(TextVectorizer):
    """Shared shape: POST {base}/embeddings {model, input} ->
    {"data": [{"embedding": [...]}, ...]} (openai-compatible vendors)."""

    base_url = ""
    env_key = ""
    default_model = ""

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        cfg = {**self.settings, **config}
        key = _api_key(cfg, self.env_key)
        base = (cfg.get("baseURL") or self.base_url).rstrip("/")
        out = _post_json(f"{base}/embeddings",
                         {"model": cfg.get("model", self.default_model),
                          "input": texts},
                         headers={"Authorization": f"Bearer {key}"})
        return np.asarray([d["embedding"] for d in out["data"]],
                          dtype=np.float32)


class JinaAIVectorizer(_SimpleEmbedAPI):
    name = "text2vec-jinaai"
    base_url = "https://api.jina.ai/v1"
    env_key = "JINAAI_APIKEY"
    default_model = "jina-embeddings-v2-base-en"


class VoyageAIVectorizer(_SimpleEmbedAPI):
    name = "text2vec-voyageai"
    base_url = "https://api.voyageai.com/v1"
    env_key = "VOYAGEAI_APIKEY"
    default_model = "voyage-2"


class OctoAIVectorizer(_SimpleEmbedAPI):
    name = "text2vec-octoai"
    base_url = "https://text.octoai.run/v1"
    env_key = "OCTOAI_APIKEY"
    default_model = "thenlper/gte-large"


class GPT4AllVectorizer(TextVectorizer):
    """text2vec-gpt4all sidecar: POST {origin}/vectorize {"text": ...}."""

    name = "text2vec-gpt4all"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "GPT4ALL_INFERENCE_API", "http://localhost:8000")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        return np.stack([
            np.asarray(_post_json(f"{self.base}/vectorize",
                                  {"text": t})["vector"], dtype=np.float32)
            for t in texts])


class BigramVectorizer(TextVectorizer):
    """text2vec-bigram: self-contained hashed character-bigram embedding
    (reference: modules/text2vec-bigram, a dependency-free dev module)."""

    name = "text2vec-bigram"

    def init(self, settings: dict | None = None) -> None:
        self.dim = int((settings or {}).get("dim", 256))

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        dim = int(config.get("dim", self.dim))
        out = np.zeros((len(texts), dim), dtype=np.float32)
        for i, text in enumerate(texts):
            t = text.lower()
            for a, b in zip(t, t[1:]):
                out[i, (ord(a) * 31 + ord(b)) % dim] += 1.0
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out


# ---- multi2vec / img2vec --------------------------------------------------


class BindVectorizer(MediaVectorizer):
    """multi2vec-bind sidecar (ImageBind): one embedding space for text,
    image, audio, video (modules/multi2vec-bind/clients)."""

    name = "multi2vec-bind"
    media_kinds = ("image", "audio", "video", "thermal", "depth", "imu")

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "BIND_INFERENCE_API", "http://localhost:8000")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        out = _post_json(f"{self.base}/vectorize", {"texts": texts})
        return np.asarray(out["textVectors"], dtype=np.float32)

    def vectorize_media(self, kind: str, data_b64: str,
                        config: dict) -> np.ndarray:
        out = _post_json(f"{self.base}/vectorize", {f"{kind}s": [data_b64]})
        return np.asarray(out[f"{kind}Vectors"][0], dtype=np.float32)


class PalmMultiVectorizer(MediaVectorizer):
    """multi2vec-palm (Vertex multimodal embeddings)."""

    name = "multi2vec-palm"
    media_kinds = ("image", "video")

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def _predict(self, instance: dict, config: dict) -> dict:
        cfg = {**self.settings, **config}
        project = cfg.get("projectId")
        if not project:
            raise ModuleError("multi2vec-palm needs moduleConfig.projectId")
        key = _api_key(cfg, "PALM_APIKEY")
        base = cfg.get("apiEndpoint",
                       "https://us-central1-aiplatform.googleapis.com")
        model = cfg.get("modelId", "multimodalembedding@001")
        url = (f"{base}/v1/projects/{project}/locations/us-central1/"
               f"publishers/google/models/{model}:predict")
        out = _post_json(url, {"instances": [instance]},
                         headers={"Authorization": f"Bearer {key}"})
        return out["predictions"][0]

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        return np.stack([
            np.asarray(self._predict({"text": t}, config)["textEmbedding"],
                       dtype=np.float32) for t in texts])

    def vectorize_media(self, kind: str, data_b64: str,
                        config: dict) -> np.ndarray:
        key = {"image": ("image", "imageEmbedding"),
               "video": ("video", "videoEmbedding")}[kind]
        pred = self._predict({key[0]: {"bytesBase64Encoded": data_b64}},
                             config)
        return np.asarray(pred[key[1]], dtype=np.float32)


class Img2VecNeural(MediaVectorizer):
    """img2vec-neural sidecar: POST {origin}/vectors {"image": b64} ->
    {"vector": [...]} (modules/img2vec-neural/clients)."""

    name = "img2vec-neural"
    media_kinds = ("image",)

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "IMAGE_INFERENCE_API", "http://localhost:8000")

    def vectorize(self, texts: list[str], config: dict) -> np.ndarray:
        raise ModuleError("img2vec-neural embeds images only")

    def vectorize_media(self, kind: str, data_b64: str,
                        config: dict) -> np.ndarray:
        out = _post_json(f"{self.base}/vectors", {"image": data_b64})
        return np.asarray(out["vector"], dtype=np.float32)


# ---- generative -----------------------------------------------------------


class _OpenAICompatGenerative(Generative):
    """POST {base}/chat/completions, openai wire shape."""

    base_url = ""
    env_key = ""
    default_model = ""

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def generate(self, prompt: str, config: dict) -> str:
        cfg = {**self.settings, **config}
        key = _api_key(cfg, self.env_key)
        base = (cfg.get("baseURL") or self.base_url).rstrip("/")
        out = _post_json(
            f"{base}/chat/completions",
            {"model": cfg.get("model", self.default_model),
             "messages": [{"role": "user", "content": prompt}],
             "max_tokens": cfg.get("maxTokens", 1024)},
            headers={"Authorization": f"Bearer {key}"})
        return out["choices"][0]["message"]["content"]


class AnyscaleGenerative(_OpenAICompatGenerative):
    name = "generative-anyscale"
    base_url = "https://api.endpoints.anyscale.com/v1"
    env_key = "ANYSCALE_APIKEY"
    default_model = "meta-llama/Llama-2-70b-chat-hf"


class MistralGenerative(_OpenAICompatGenerative):
    name = "generative-mistral"
    base_url = "https://api.mistral.ai/v1"
    env_key = "MISTRAL_APIKEY"
    default_model = "open-mistral-7b"


class OctoAIGenerative(_OpenAICompatGenerative):
    name = "generative-octoai"
    base_url = "https://text.octoai.run/v1"
    env_key = "OCTOAI_APIKEY"
    default_model = "meta-llama-3-8b-instruct"


class PalmGenerative(Generative):
    name = "generative-palm"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def generate(self, prompt: str, config: dict) -> str:
        cfg = {**self.settings, **config}
        project = cfg.get("projectId")
        if not project:
            raise ModuleError("generative-palm needs moduleConfig.projectId")
        key = _api_key(cfg, "PALM_APIKEY")
        base = cfg.get("apiEndpoint",
                       "https://us-central1-aiplatform.googleapis.com")
        model = cfg.get("modelId", "chat-bison")
        url = (f"{base}/v1/projects/{project}/locations/us-central1/"
               f"publishers/google/models/{model}:predict")
        out = _post_json(
            url, {"instances": [{"messages": [
                {"author": "user", "content": prompt}]}]},
            headers={"Authorization": f"Bearer {key}"})
        return out["predictions"][0]["candidates"][0]["content"]


class AWSGenerative(Generative):
    name = "generative-aws"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def generate(self, prompt: str, config: dict) -> str:
        cfg = {**self.settings, **config}
        endpoint = cfg.get("endpoint") or os.environ.get(
            "AWS_BEDROCK_ENDPOINT", "")
        if not endpoint:
            raise ModuleError(
                "generative-aws needs an endpoint (moduleConfig.endpoint "
                "or AWS_BEDROCK_ENDPOINT)")
        model = cfg.get("model", "amazon.titan-text-express-v1")
        out = _post_json(f"{endpoint.rstrip('/')}/model/{model}/invoke",
                         {"inputText": prompt})
        return out.get("outputText") or out.get("results", [{}])[0].get(
            "outputText", "")


# ---- reranker --------------------------------------------------------------


class VoyageAIReranker(Reranker):
    name = "reranker-voyageai"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def rerank(self, query: str, documents: list[str],
               config: dict) -> list[float]:
        cfg = {**self.settings, **config}
        key = _api_key(cfg, "VOYAGEAI_APIKEY")
        base = (cfg.get("baseURL") or "https://api.voyageai.com/v1"
                ).rstrip("/")
        out = _post_json(f"{base}/rerank",
                         {"query": query, "documents": documents,
                          "model": cfg.get("model", "rerank-lite-1")},
                         headers={"Authorization": f"Bearer {key}"})
        scores = [0.0] * len(documents)
        for item in out.get("data", out.get("results", [])):
            scores[item["index"]] = item["relevance_score"]
        return scores


# ---- readers: qna / ner / sum / spellcheck ---------------------------------


class QnATransformers(QnA):
    """qna-transformers sidecar: POST {origin}/answers/
    {"text", "question"} -> {"answer", "certainty"}."""

    name = "qna-transformers"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "QNA_INFERENCE_API", "http://localhost:8000")

    def answer(self, text: str, question: str, config: dict) -> dict:
        out = _post_json(f"{self.base}/answers",
                         {"text": text, "question": question})
        ans = out.get("answer")
        start = text.find(ans) if ans else -1
        return {"answer": ans, "certainty": out.get("certainty"),
                "hasAnswer": bool(ans),
                "startPosition": max(start, 0),
                "endPosition": start + len(ans) if ans and start >= 0 else 0}


class QnAOpenAI(QnA):
    """qna-openai: answer extraction through a completion prompt
    (modules/qna-openai/clients — 'Please answer the question ...')."""

    name = "qna-openai"

    def init(self, settings: dict | None = None) -> None:
        self.settings = settings or {}

    def answer(self, text: str, question: str, config: dict) -> dict:
        cfg = {**self.settings, **config}
        key = _api_key(cfg, "OPENAI_APIKEY")
        base = (cfg.get("baseURL") or "https://api.openai.com/v1").rstrip("/")
        prompt = (
            "Please answer the question according to the text below. If "
            "the answer is not in the text say 'No answer'.\n\n"
            f"Text: {text}\n\nQuestion: {question}")
        out = _post_json(
            f"{base}/chat/completions",
            {"model": cfg.get("model", "gpt-3.5-turbo"),
             "messages": [{"role": "user", "content": prompt}]},
            headers={"Authorization": f"Bearer {key}"})
        ans = out["choices"][0]["message"]["content"].strip()
        has = ans.lower() not in ("no answer", "no answer.")
        start = text.find(ans) if has else -1
        return {"answer": ans if has else None, "certainty": None,
                "hasAnswer": has, "startPosition": max(start, 0),
                "endPosition": start + len(ans) if has and start >= 0 else 0}


class NERTransformers(NER):
    """ner-transformers sidecar: POST {origin}/ner/ {"text"} ->
    {"tokens": [...]}"""

    name = "ner-transformers"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "NER_INFERENCE_API", "http://localhost:8000")

    def recognize(self, text: str, config: dict) -> list[dict]:
        out = _post_json(f"{self.base}/ner", {"text": text})
        return [{
            "entity": t.get("entity"),
            "word": t.get("word"),
            "certainty": t.get("certainty", t.get("score")),
            "startPosition": t.get("startPosition", t.get("start", 0)),
            "endPosition": t.get("endPosition", t.get("end", 0)),
        } for t in out.get("tokens", [])]


class SumTransformers(Summarizer):
    """sum-transformers sidecar: POST {origin}/sum/ {"text"} ->
    {"summary": ...}"""

    name = "sum-transformers"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "SUM_INFERENCE_API", "http://localhost:8000")

    def summarize(self, text: str, config: dict) -> list[dict]:
        out = _post_json(f"{self.base}/sum", {"text": text})
        summary = out.get("summary")
        if isinstance(summary, list):
            return [{"property": s.get("property", ""),
                     "result": s.get("result", s.get("summary", ""))}
                    for s in summary]
        return [{"property": "", "result": summary or ""}]


class TextSpellCheck(SpellCheck):
    """text-spellcheck sidecar: POST {origin}/spellcheck/ {"text"} ->
    {"text", "changes": [...]}"""

    name = "text-spellcheck"

    def init(self, settings: dict | None = None) -> None:
        self.base = _origin(settings or {}, "inferenceUrl",
                            "SPELLCHECK_INFERENCE_API",
                            "http://localhost:8000")

    def check(self, text: str, config: dict) -> dict:
        out = _post_json(f"{self.base}/spellcheck", {"text": text})
        corrected = out.get("text", text)
        changes = out.get("changes", [])
        return {"originalText": text, "correctedText": corrected,
                "didYouMean": corrected if corrected != text else None,
                "numberOfCorrections": len(changes)}
