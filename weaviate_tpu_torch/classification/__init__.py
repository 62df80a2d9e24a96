"""Classification: assign property values from vector neighborhoods.

Reference: usecases/classification — POST /v1/classifications starts an
async job that classifies every object of a class missing the target
property, polled via GET /v1/classifications/{id}. Types:

- ``knn``           majority vote over the k nearest *labeled* objects of
                    the same class (classifier_knn.go); training set can
                    be narrowed with trainingSetWhere.
- ``zeroshot``      assign the nearest object of the target class — no
                    labeled examples needed, similarity between the source
                    object's vector and candidate label objects' vectors
                    (classifier_zeroshot.go).

Batched device re-design: instead of the reference's per-object kNN loop,
all unclassified vectors form one [B, d] query block scored against the
labeled/candidate corpus in a single chunked scan (ops.topk), so the
whole classification run is a handful of device calls.
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod
from collections import Counter

import numpy as np

RUNNING = "running"
COMPLETED = "completed"
FAILED = "failed"


class ClassificationError(Exception):
    pass


class ClassificationManager:
    def __init__(self, db, modules=None):
        self.db = db
        self.modules = modules
        self._lock = threading.Lock()
        self._jobs: dict[str, dict] = {}

    # -- API -----------------------------------------------------------------

    def start(self, class_name: str, classify_properties: list[str],
              based_on_properties: list[str] | None = None,
              kind: str = "knn", settings: dict | None = None,
              where=None, training_set_where=None,
              tenant: str | None = None,
              wait: bool = False) -> dict:
        """Returns the job descriptor (id + status), reference:
        handlers_classification.go → classification.Classifier.Schedule."""
        settings = settings or {}
        col = self.db.get_collection(class_name)  # KeyError → 404 upstream
        if col.config.multi_tenancy.enabled and not tenant:
            # never mix tenants' objects into one training set
            raise ClassificationError(
                "classification on a multi-tenant class requires a tenant")
        if kind == "text2vec-contextionary-contextual":
            kind = "contextual"  # reference TypeContextual (validation.go:24)
        if kind not in ("knn", "zeroshot", "contextual"):
            raise ClassificationError(f"unknown classification type {kind!r}")
        if not classify_properties:
            raise ClassificationError("classifyProperties must not be empty")
        for p in classify_properties:
            if col.config.property(p) is None:
                raise ClassificationError(
                    f"class {class_name} has no property {p!r}")
        if kind in ("zeroshot", "contextual") and \
                not settings.get("targetClass"):
            raise ClassificationError(
                f"{kind} needs settings.targetClass (the class whose "
                "objects are the candidate labels)")
        if kind == "contextual" and not based_on_properties:
            raise ClassificationError(
                "contextual classification needs basedOnProperties (the "
                "text whose words are TF-IDF ranked)")

        job_id = str(uuid_mod.uuid4())
        try:
            k_setting = int(settings.get("k", 3))
        except (TypeError, ValueError):
            raise ClassificationError(
                f"settings.k must be an integer, got {settings.get('k')!r}")
        job = {
            "id": job_id,
            "class": class_name,
            "classifyProperties": classify_properties,
            "basedOnProperties": based_on_properties or [],
            "type": kind,
            "settings": {**settings, "k": k_setting},
            "status": RUNNING,
            "error": None,
            "meta": {"started": time.time(), "count": 0,
                     "countSucceeded": 0, "countFailed": 0},
        }
        with self._lock:
            self._jobs[job_id] = job

        def work():
            try:
                if kind == "knn":
                    self._run_knn(col, job, where, training_set_where,
                                  tenant)
                elif kind == "contextual":
                    self._run_contextual(col, job, where, tenant)
                else:
                    self._run_zeroshot(col, job, where, tenant)
                job["status"] = COMPLETED
                job["meta"]["completed"] = time.time()
            except Exception as e:
                job["status"] = FAILED
                job["error"] = str(e)

        t = threading.Thread(target=work, daemon=True,
                             name=f"classification-{job_id[:8]}")
        t.start()
        if wait:
            t.join()
        return dict(job)

    def get(self, job_id: str) -> dict:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"classification {job_id!r} not found")
        return dict(job)

    # -- engines -------------------------------------------------------------

    def _split(self, col, props: list[str], source_where,
               training_where=None, tenant: str | None = None):
        """(unlabeled, labeled) object lists. labeled = every classify
        property present and non-empty. ``source_where`` narrows which
        objects get classified; ``training_where`` narrows the training
        set (reference: filters.sourceWhere / trainingSetWhere,
        usecases/classification/filters.go). Masks are evaluated
        PER SHARD — doc ids are per-shard counters, so one shard's mask
        must never be applied to another shard's objects."""
        from weaviate_tpu_torch.filters.filters import compute_allow_mask
        from weaviate_tpu_torch.storage.objects import StorageObject

        unlabeled, labeled = [], []
        # MT collections classify ONE tenant's shard; others span all local
        # shards (col._target_shards enforces the tenant requirement)
        for shard in col._target_shards(tenant):
            src_mask = train_mask = None
            if source_where is not None:
                src_mask = compute_allow_mask(source_where, shard._inverted,
                                              shard.doc_id_space)
            if training_where is not None:
                train_mask = compute_allow_mask(training_where,
                                                shard._inverted,
                                                shard.doc_id_space)

            def hit(mask, obj):
                return mask is None or (obj.doc_id < len(mask)
                                        and mask[obj.doc_id])

            for _key, raw in shard.objects.iter_items():
                obj = StorageObject.from_bytes(raw)
                if obj.vector is None:
                    continue
                has_all = all(obj.properties.get(p) not in (None, "", [])
                              for p in props)
                if has_all:
                    if hit(train_mask, obj):
                        labeled.append(obj)
                elif hit(src_mask, obj):
                    unlabeled.append(obj)
        return unlabeled, labeled

    @staticmethod
    def _unit(rows: list[np.ndarray]) -> np.ndarray:
        """Stack + L2-normalize: stored object vectors are RAW (the index
        normalizes on add, the object store does not), so cosine ranking
        here must normalize both sides itself."""
        m = np.stack(rows).astype(np.float32)
        norms = np.linalg.norm(m, axis=1, keepdims=True)
        return m / np.where(norms > 1e-30, norms, 1.0)

    def _run_knn(self, col, job, where, training_set_where,
                 tenant=None):
        from weaviate_tpu_torch.ops.topk import chunked_topk

        props = job["classifyProperties"]
        k = job["settings"]["k"]
        unlabeled, labeled = self._split(col, props, where,
                                         training_set_where, tenant)
        job["meta"]["count"] = len(unlabeled)
        if not unlabeled:
            return
        if not labeled:
            raise ClassificationError(
                "no labeled training objects (every object is missing the "
                "classify properties)")
        q = self._unit([o.vector for o in unlabeled])
        x = self._unit([o.vector for o in labeled])
        k_eff = min(k, len(labeled))
        # one batched scan: [B, d] x [N, d] -> [B, k] neighbor indices
        _, idx = chunked_topk(self._on_device(q), self._on_device(x), k=k_eff,
                              metric="cosine")
        idx = idx.cpu().numpy()
        for row, obj in enumerate(unlabeled):
            try:
                updates = {}
                for p in props:
                    votes = Counter()
                    for j in idx[row]:
                        if j < 0:
                            continue
                        v = labeled[int(j)].properties.get(p)
                        key = tuple(sorted(map(str, v))) \
                            if isinstance(v, list) else v
                        votes[key] += 1
                    if votes:
                        winner = votes.most_common(1)[0][0]
                        updates[p] = list(winner) \
                            if isinstance(winner, tuple) else winner
                self._apply(col, obj, updates, tenant)
                job["meta"]["countSucceeded"] += 1
            except Exception:
                job["meta"]["countFailed"] += 1

    def _run_contextual(self, col, job, where, tenant=None):
        """Contextual classification (reference TypeContextual:
        modules/text2vec-contextionary/classification/
        classifier_run_contextual.go + tf_idf.go): no training data.
        The basedOn words of the UNCLASSIFIED corpus are TF-IDF ranked;
        per object only the informative fraction (above
        ``tfidfCutoffPercentile``, default 50) forms a query that the
        class's vectorizer embeds, and the nearest target-class object by
        cosine wins. Falls back to the object's stored vector when no
        vectorizer module is configured."""
        import math

        from weaviate_tpu_torch.ops.topk import chunked_topk
        from weaviate_tpu_torch.text.tokenizer import tokenize

        props = job["classifyProperties"]
        based_on = job["basedOnProperties"]
        settings = job["settings"]
        cutoff = float(settings.get("tfidfCutoffPercentile", 50))
        target = self.db.get_collection(settings["targetClass"])
        candidates = [o for o in target.iter_objects()
                      if o.vector is not None]
        if not candidates:
            raise ClassificationError(
                f"target class {target.config.name} has no vectorized "
                "objects")
        unlabeled, _ = self._split(col, props, where, tenant=tenant)
        job["meta"]["count"] = len(unlabeled)
        if not unlabeled:
            return
        # corpus-wide document frequencies over the basedOn text
        docs_tokens = []
        df = Counter()
        for obj in unlabeled:
            text = " ".join(str(obj.properties.get(p, ""))
                            for p in based_on)
            toks = tokenize(text, "word")
            docs_tokens.append(toks)
            df.update(set(toks))
        n_docs = len(unlabeled)

        def query_text(toks: list[str]) -> str:
            if not toks:
                return ""
            tf = Counter(toks)
            scored = sorted(
                ((tf[w] / len(toks)) * math.log(1 + n_docs / df[w]), w)
                for w in tf)
            keep = max(1, int(len(scored) * (1 - cutoff / 100.0)))
            top = [w for _s, w in scored[-keep:]]
            # preserve original word order for the vectorizer
            top_set = set(top)
            return " ".join(w for w in toks if w in top_set)

        texts = [query_text(toks) for toks in docs_tokens]
        vecs: list = [None] * len(unlabeled)
        if self.modules is not None and any(texts):
            # vectorizer calls are HTTP round trips — run them
            # concurrently, not one serial call per object
            from concurrent.futures import ThreadPoolExecutor

            def embed(i):
                if not texts[i]:
                    return
                try:
                    vecs[i] = np.asarray(self.modules.vectorize_query(
                        col.config, texts[i], ""), dtype=np.float32)
                except Exception:
                    vecs[i] = None

            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(embed, range(len(unlabeled))))
        q_rows = []
        for obj, vec in zip(unlabeled, vecs):
            if vec is None:
                vec = obj.vector
            if vec is None:
                raise ClassificationError(
                    f"object {obj.uuid} has no vector and no vectorizer "
                    "module is configured")
            q_rows.append(np.asarray(vec, dtype=np.float32))
        q = self._unit(q_rows)
        x = self._unit([o.vector for o in candidates])
        _, idx = chunked_topk(self._on_device(q), self._on_device(x), k=1,
                              metric="cosine")
        idx = idx.cpu().numpy()
        self._assign_targets(col, job, unlabeled, candidates, target, idx,
                             props, tenant)

    def _assign_targets(self, col, job, unlabeled, candidates, target, idx,
                        props, tenant):
        """Write the chosen target per object (shared by zeroshot and
        contextual — beacon for cref props, label text otherwise)."""
        for row, obj in enumerate(unlabeled):
            try:
                best = candidates[int(idx[row, 0])]
                updates = {}
                for p in props:
                    prop_cfg = col.config.property(p)
                    if prop_cfg is not None and prop_cfg.data_type == "cref":
                        updates[p] = [{
                            "beacon": "weaviate://localhost/"
                                      f"{target.config.name}/{best.uuid}"}]
                    else:
                        label = next(
                            (v for v in best.properties.values()
                             if isinstance(v, str)), best.uuid)
                        updates[p] = label
                self._apply(col, obj, updates, tenant)
                job["meta"]["countSucceeded"] += 1
            except Exception:
                job["meta"]["countFailed"] += 1

    def _run_zeroshot(self, col, job, where, tenant=None):
        from weaviate_tpu_torch.ops.topk import chunked_topk

        props = job["classifyProperties"]
        target = self.db.get_collection(job["settings"]["targetClass"])
        candidates = [o for o in target.iter_objects()
                      if o.vector is not None]
        if not candidates:
            raise ClassificationError(
                f"target class {target.config.name} has no vectorized "
                "objects")
        unlabeled, _ = self._split(col, props, where, tenant=tenant)
        job["meta"]["count"] = len(unlabeled)
        if not unlabeled:
            return
        q = self._unit([o.vector for o in unlabeled])
        x = self._unit([o.vector for o in candidates])
        _, idx = chunked_topk(self._on_device(q), self._on_device(x), k=1,
                              metric="cosine")
        idx = idx.cpu().numpy()
        self._assign_targets(col, job, unlabeled, candidates, target, idx,
                             props, tenant)

    def _on_device(self, a: np.ndarray):
        """Host rows -> a tensor on the database's device (the scan
        runs there, as every search of the port does)."""
        import torch

        return torch.as_tensor(a, device=self.db.device)

    @staticmethod
    def _apply(col, obj, updates: dict, tenant=None) -> None:
        if not updates:
            return
        props = dict(obj.properties)
        props.update(updates)
        col.put_object(props, vector=obj.vector,
                       vectors=obj.vectors or None, uuid=obj.uuid,
                       tenant=tenant,
                       creation_time_ms=obj.creation_time_ms)
