"""Module provider: registry + dispatch during import and query.

Reference: usecases/modules/modules.go:40 (Provider), vectorizer dispatch
usecases/modules/vectorizer.go, nearText move semantics
usecases/modulecomponents/arguments/nearText/searcher_movements.go
(MoveTo: out = src*(1-w/2) + tgt*(w/2); MoveAwayFrom:
out = src + (w/2)*(src-tgt)).
"""

from __future__ import annotations

import re

import numpy as np

from weaviate_tpu_torch.modules.base import (
    BackupBackend,
    Generative,
    MediaVectorizer,
    ModuleError,
    Module,
    Reranker,
    TextVectorizer,
)
from weaviate_tpu_torch.modules.text_utils import object_corpus

_PROMPT_VAR = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)\}")


class Provider:
    """``db``: optional Database handle — needed only by modules that read
    other objects (ref2vec-centroid resolves referenced objects' vectors)."""

    def __init__(self, db=None):
        self.db = db
        self._modules: dict[str, Module] = {}

    def register(self, module: Module, settings: dict | None = None) -> "Provider":
        module.init(settings or {})
        if hasattr(module, "attach_db"):
            module.attach_db(self.db)
        self._modules[module.name] = module
        return self

    def get(self, name: str) -> Module | None:
        return self._modules.get(name)

    def names(self) -> list[str]:
        return sorted(self._modules)

    def meta(self) -> dict:
        return {name: mod.meta() for name, mod in sorted(self._modules.items())}

    # -- vectorize at import (usecases/modules/vectorizer.go) ----------------

    def vectorizer_for(self, config, vec_name: str = ""):
        vc = config.vector_config(vec_name)
        if vc is None or vc.vectorizer in ("", "none"):
            return None
        mod = self._modules.get(vc.vectorizer)
        if mod is None:
            raise ModuleError(f"vectorizer module {vc.vectorizer!r} of class "
                              f"{config.name} is not enabled")
        return mod

    def vectorize_batch(self, config, specs: list[dict]) -> None:
        """Fill missing vectors in batch-import specs, one batched embed
        call per named vector space (reference: BatchVectorizer)."""
        searchable = {p.name for p in config.properties
                      if p.data_type in ("text", "text[]")}
        for vc in config.vectors:
            if vc.vectorizer in ("", "none"):
                continue
            todo = []
            for spec in specs:
                if vc.name:
                    has = vc.name in (spec.get("vectors") or {})
                else:
                    has = spec.get("vector") is not None
                if not has:
                    todo.append(spec)
            if not todo:
                # every object supplied its own vector: no server-side
                # vectorization needed, so an unregistered module is fine
                continue
            mod = self.vectorizer_for(config, vc.name)
            if isinstance(mod, RefVectorizer):
                for spec in todo:
                    vec = mod.centroid(config, vc.module_config,
                                       spec.get("properties", {}))
                    if vec is not None:
                        self._store(spec, vc.name, vec)
                continue
            if isinstance(mod, MediaVectorizer):
                # multi2vec: combine text + blob-property embeddings per
                # object (reference: multi2vec-clip imageFields/textFields
                # weighted mean, modules/multi2vec-clip/vectorizer.go).
                # Unlike text2vec, the class name is NOT vectorized by
                # default — a constant text component would dilute every
                # media vector of the class toward the same point.
                mc = {"vectorizeClassName": False, **vc.module_config}
                blob_props = [p.name for p in config.properties
                              if p.data_type == "blob"]
                texts = [object_corpus(config.name,
                                       spec.get("properties", {}),
                                       mc, searchable)
                         for spec in todo]
                text_vecs: dict[int, np.ndarray] = {}
                nonempty = [i for i, t in enumerate(texts) if t.strip()]
                if nonempty:
                    # one batched sidecar call for all text components
                    embedded = mod.vectorize([texts[i] for i in nonempty],
                                             vc.module_config)
                    for i, v in zip(nonempty, embedded):
                        text_vecs[i] = np.asarray(v, dtype=np.float32)
                for idx, spec in enumerate(todo):
                    props = spec.get("properties", {})
                    parts = []
                    if idx in text_vecs:
                        parts.append(text_vecs[idx])
                    for pname in blob_props:
                        blob = props.get(pname)
                        if blob:
                            # blobs carry no media-type tag; embed with the
                            # module's primary kind (clip: "image")
                            parts.append(np.asarray(
                                mod.vectorize_media(mod.media_kinds[0],
                                                    blob, vc.module_config),
                                dtype=np.float32))
                    if parts:
                        self._store(spec, vc.name,
                                    np.mean(np.stack(parts), axis=0))
                continue
            texts = [object_corpus(config.name, spec.get("properties", {}),
                                   vc.module_config, searchable)
                     for spec in todo]
            vecs = mod.vectorize(texts, vc.module_config)
            for spec, vec in zip(todo, vecs):
                self._store(spec, vc.name, np.asarray(vec, dtype=np.float32))

    @staticmethod
    def _store(spec: dict, vec_name: str, vec: np.ndarray) -> None:
        if vec_name:
            if spec.get("vectors") is None:  # key may exist holding None
                spec["vectors"] = {}
            spec["vectors"][vec_name] = vec
        else:
            spec["vector"] = vec

    # -- query-time hooks ----------------------------------------------------

    def vectorize_query(self, config, text: str,
                        vec_name: str = "") -> np.ndarray:
        mod = self.vectorizer_for(config, vec_name)
        if mod is None:
            raise ModuleError(
                f"class {config.name} has no vectorizer module for "
                f"vector {vec_name!r}")
        vc = config.vector_config(vec_name)
        return np.asarray(mod.vectorize_query(text, vc.module_config),
                          dtype=np.float32)

    def vectorize_media(self, config, kind: str, data_b64: str,
                        vec_name: str = "") -> np.ndarray:
        mod = self.vectorizer_for(config, vec_name)
        if not isinstance(mod, MediaVectorizer) or \
                kind not in mod.media_kinds:
            raise ModuleError(f"class {config.name} has no multi2vec module "
                              f"supporting near{kind.capitalize()}")
        vc = config.vector_config(vec_name)
        return np.asarray(mod.vectorize_media(kind, data_b64,
                                              vc.module_config),
                          dtype=np.float32)

    def apply_moves(self, col, vec: np.ndarray, near_text,
                    vec_name: str = "") -> np.ndarray:
        """nearText moveTo/moveAwayFrom: targets are the centroid of the
        moved-to concepts and/or anchor objects, in the same (possibly
        named) vector space as the query itself."""
        vec = np.asarray(vec, dtype=np.float32)
        for which in ("move_to", "move_away"):
            if not near_text.HasField(which):
                continue
            move = getattr(near_text, which)
            targets = []
            for concept in move.concepts:
                targets.append(
                    self.vectorize_query(col.config, concept, vec_name))
            for uid in move.uuids:
                obj = col.get_object(uid)
                if obj is None:
                    continue
                anchor = (obj.vectors or {}).get(vec_name) if vec_name \
                    else obj.vector
                if anchor is not None:
                    targets.append(anchor)
            if not targets:
                continue
            target = np.mean(np.stack(targets), axis=0)
            w = float(move.force) * 0.5
            if which == "move_to":
                vec = vec * (1 - w) + target * w
            else:
                vec = vec + w * (vec - target)
        return vec

    def rerank(self, config, query: str, documents: list[str],
               module_name: str | None = None) -> list[float]:
        mod, settings = self._class_module(config, Reranker, "reranker-",
                                           module_name)
        return mod.rerank(query, documents, settings)

    def generate_single(self, config, prompt: str, props: dict,
                        module_name: str | None = None) -> str:
        """Single-result prompt: {propName} placeholders are replaced with
        the result's property values (reference: generative modules)."""
        mod, settings = self._class_module(config, Generative, "generative-",
                                           module_name)
        filled = _PROMPT_VAR.sub(
            lambda m: str(props.get(m.group(1), m.group(0))), prompt)
        return mod.generate(filled, settings)

    def generate_grouped(self, config, task: str, all_props: list[dict],
                         module_name: str | None = None) -> str:
        mod, settings = self._class_module(config, Generative, "generative-",
                                           module_name)
        import json

        prompt = f"{task}\n\n{json.dumps(all_props, default=str)}"
        return mod.generate(prompt, settings)

    def answer(self, config, text: str, question: str,
               module_name: str | None = None) -> dict:
        """qna-* extractive answer (reference: _additional{answer})."""
        from weaviate_tpu_torch.modules.base import QnA

        mod, settings = self._class_module(config, QnA, "qna-", module_name)
        return mod.answer(text, question, settings)

    def ner(self, config, text: str,
            module_name: str | None = None) -> list[dict]:
        from weaviate_tpu_torch.modules.base import NER

        mod, settings = self._class_module(config, NER, "ner-", module_name)
        return mod.recognize(text, settings)

    def summarize(self, config, text: str,
                  module_name: str | None = None) -> list[dict]:
        from weaviate_tpu_torch.modules.base import Summarizer

        mod, settings = self._class_module(config, Summarizer, "sum-",
                                           module_name)
        return mod.summarize(text, settings)

    def spellcheck(self, config, text: str,
                   module_name: str | None = None) -> dict:
        from weaviate_tpu_torch.modules.base import SpellCheck

        mod, settings = self._class_module(config, SpellCheck, "text-spell",
                                           module_name)
        return mod.check(text, settings)

    def backup_backend(self, name: str) -> BackupBackend:
        mod = self._modules.get(f"backup-{name}", self._modules.get(name))
        if not isinstance(mod, BackupBackend):
            raise ModuleError(f"backup backend {name!r} is not enabled")
        return mod

    def _class_module(self, config, kind, prefix: str,
                      module_name: str | None):
        """Resolve a generative/reranker module for a class: explicit name,
        else the class's module_config entry with the matching prefix."""
        if module_name is None:
            for key in config.module_config:
                if key.startswith(prefix) and key in self._modules:
                    module_name = key
                    break
        if module_name is None:
            # No class config: only a single registered module of this kind
            # is an unambiguous default. Never silently pick one of many —
            # that could route user data to an unintended external service.
            candidates = [key for key, mod in self._modules.items()
                          if isinstance(mod, kind)]
            if len(candidates) == 1:
                module_name = candidates[0]
        mod = self._modules.get(module_name) if module_name else None
        if not isinstance(mod, kind):
            raise ModuleError(
                f"class {config.name} has no {prefix.rstrip('-')} module "
                f"configured (set one in moduleConfig or pass an explicit "
                f"provider)")
        return mod, config.module_config.get(module_name, {})


def needs_vector(config, spec: dict) -> bool:
    """True if this import spec still requires server-side vectorization
    for any vectorizer-enabled vector space."""
    for vc in config.vectors:
        if vc.vectorizer in ("", "none"):
            continue
        if vc.name:
            if vc.name not in (spec.get("vectors") or {}):
                return True
        elif spec.get("vector") is None:
            return True
    return False


class RefVectorizer(Module):
    """ref2vec-centroid: the object's vector is the mean of the vectors of
    the objects it references (reference: modules/ref2vec-centroid —
    config: referenceProperties, method=mean)."""

    name = "ref2vec-centroid"

    def __init__(self):
        self.db = None

    def attach_db(self, db) -> None:
        self.db = db

    def centroid(self, config, module_config: dict,
                 properties: dict) -> np.ndarray | None:
        if self.db is None:
            raise ModuleError("ref2vec-centroid needs a database handle")
        ref_props = module_config.get("referenceProperties") or [
            p.name for p in config.properties if p.data_type == "cref"]
        vecs = []
        for prop in ref_props:
            for beacon in properties.get(prop) or []:
                uid, target = _parse_beacon(beacon)
                if uid is None:
                    continue
                for cname in ([target] if target else
                              self.db.list_collections()):
                    try:
                        obj = self.db.get_collection(cname).get_object(uid)
                    except KeyError:
                        continue
                    if obj is not None and obj.vector is not None:
                        vecs.append(obj.vector)
                        break
        if not vecs:
            return None
        return np.mean(np.stack(vecs), axis=0).astype(np.float32)


def _parse_beacon(ref) -> tuple[str | None, str | None]:
    """weaviate://localhost[/Class]/uuid -> (uuid, class|None)."""
    beacon = ref.get("beacon", "") if isinstance(ref, dict) else str(ref)
    parts = [p for p in beacon.split("/") if p]
    if len(parts) < 2:
        return None, None
    uid = parts[-1]
    target = parts[-2] if len(parts) >= 4 and parts[-2][0].isupper() else None
    return uid, target
