"""Module ecosystem (reference: usecases/modules provider + modules/*).

``default_provider(db)`` registers the self-contained modules plus every
HTTP-client module, mirroring registerModules at configure_api.go:158 —
enable-list via the ENABLE_MODULES env var handled by the config layer.
"""

from weaviate_tpu_torch.modules.base import (
    BackupBackend,
    Generative,
    MediaVectorizer,
    Module,
    ModuleError,
    Reranker,
    TextVectorizer,
)
from weaviate_tpu_torch.modules.provider import Provider, RefVectorizer
from weaviate_tpu_torch.modules.text2vec_hash import HashVectorizer


def default_provider(db=None, enabled: list[str] | None = None) -> Provider:
    from weaviate_tpu_torch.modules import backup_backends as bb
    from weaviate_tpu_torch.modules import http_modules as hm
    from weaviate_tpu_torch.modules import http_modules_extra as hx

    provider = Provider(db)
    mods = [
        HashVectorizer(),
        RefVectorizer(),
        # text2vec
        hm.TransformersVectorizer(),
        hm.OpenAIVectorizer(),
        hm.CohereVectorizer(),
        hm.HuggingFaceVectorizer(),
        hm.OllamaVectorizer(),
        hx.ContextionaryVectorizer(),
        hx.PalmVectorizer(),
        hx.AWSVectorizer(),
        hx.JinaAIVectorizer(),
        hx.VoyageAIVectorizer(),
        hx.OctoAIVectorizer(),
        hx.GPT4AllVectorizer(),
        hx.BigramVectorizer(),
        # multi2vec / img2vec
        hm.ClipVectorizer(),
        hx.BindVectorizer(),
        hx.PalmMultiVectorizer(),
        hx.Img2VecNeural(),
        # rerankers
        hm.TransformersReranker(),
        hm.CohereReranker(),
        hx.VoyageAIReranker(),
        # generative
        hm.OpenAIGenerative(),
        hm.OllamaGenerative(),
        hm.CohereGenerative(),
        hx.AnyscaleGenerative(),
        hx.MistralGenerative(),
        hx.OctoAIGenerative(),
        hx.PalmGenerative(),
        hx.AWSGenerative(),
        # readers
        hx.QnATransformers(),
        hx.QnAOpenAI(),
        hx.NERTransformers(),
        hx.SumTransformers(),
        hx.TextSpellCheck(),
        # backup backends
        bb.FilesystemBackend(),
        bb.S3Backend(),
        bb.GCSBackend(),
        bb.AzureBackend(),
    ]
    for mod in mods:
        if enabled is None or mod.name in enabled:
            provider.register(mod)
    return provider


__all__ = [
    "BackupBackend", "Generative", "HashVectorizer", "MediaVectorizer",
    "Module", "ModuleError", "Provider", "RefVectorizer", "Reranker",
    "TextVectorizer", "default_provider",
]
