"""The port's native host library (weaviate_tpu_torch/native.py over its
own copy of the C++ source, csrc/host/weaviate_native.cpp) against the
JAX package's native-library bindings, and against the port's own numpy
fallback (``WEAVIATE_TPU_NO_NATIVE=1``, run in a subprocess):

- every function and class on seeded inputs: the sorted-set algebra,
  membership, varint bytes, ``merge_topk_host``, ``analyze_batch`` (also
  against the Python tokenizer its callers fall back to),
  ``storobj_encode_batch`` (also against ``StorageObject.to_bytes``), the
  ``PostingsTable`` memtable and ``HnswNative`` search on a small graph;
- an import end to end: the same FiQA-shaped text objects through the
  port's ``Database(device="cpu")`` with the library and without it give
  identical hybrid, keyword and filtered answers, and identical objects,
  postings and doc-id buckets, equal to the JAX package's;
- the loader builds from the port's own source into build/torch_native/
  and never opens the JAX package's library.
"""

import ast
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

from weaviate_tpu import native as jnative
from weaviate_tpu_torch import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAVE_LIB = tnative.available()


def _no_native(code: str, *args) -> bytes:
    """Run ``code`` in a fresh interpreter with WEAVIATE_TPU_NO_NATIVE=1
    (the numpy fallback); returns its stdout."""
    env = dict(os.environ)
    env.update({"WEAVIATE_TPU_NO_NATIVE": "1", "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    out = subprocess.run([sys.executable, "-c", code, *args], capture_output=True,
                         timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr.decode(errors="replace")[-4000:]
    return out.stdout


@pytest.mark.parametrize("seed", range(4))
def test_sorted_set_algebra_matches(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a = np.unique(rng.integers(0, 500, rng.integers(0, 80))).astype(np.uint64)
        b = np.unique(rng.integers(0, 500, rng.integers(0, 80))).astype(np.uint64)
        for name in ("union_sorted", "difference_sorted", "intersect_sorted"):
            got = getattr(tnative, name)(a, b)
            want = getattr(jnative, name)(a, b)
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, want)


def test_varint_codec_matches():
    rng = np.random.default_rng(9)
    for n in (0, 1, 16, 17, 500):
        vals = np.unique(rng.integers(0, 1 << 40, n)).astype(np.uint64)
        enc = tnative.varint_encode(vals)
        assert enc == jnative.varint_encode(vals)
        np.testing.assert_array_equal(tnative.varint_decode(enc, len(vals)), vals)
    with pytest.raises(ValueError):
        tnative.varint_decode(tnative.varint_encode(np.arange(3, dtype=np.uint64)), 2)
    with pytest.raises(ValueError):  # past 32 bytes: the library's decoder
        tnative.varint_decode(tnative.varint_encode(np.arange(40, dtype=np.uint64)), 39)


def test_merge_topk_host_matches():
    rng = np.random.default_rng(2)
    d = np.sort(rng.standard_normal((3, 6)).astype(np.float32), axis=1)
    ids = rng.integers(0, 50, (3, 6))
    ids[1, 4:] = -1
    for k in (1, 5, 20):
        td, ti = tnative.merge_topk_host(d, ids, k)
        jd, ji = jnative.merge_topk_host(d, ids, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    # both packages build their library with g++ here, or neither does
    assert tnative.available() == jnative.available()


# -- every function on seeded inputs: the library, the JAX package's, numpy ---

# Executed in this process (the library) and in a subprocess with
# WEAVIATE_TPU_NO_NATIVE=1 (the numpy fallback): ``results(nat)`` calls
# every function with a numpy fallback on the same seeded inputs.
_RESULTS = r'''
import numpy as np

def results(nat):
    rng = np.random.default_rng(11)
    out = {"available": nat.available()}
    sets = []
    for _ in range(40):
        a = np.unique(rng.integers(0, 3000, rng.integers(0, 400))).astype(np.uint64)
        b = np.unique(rng.integers(0, 3000, rng.integers(0, 400))).astype(np.uint64)
        sets.append([nat.intersect_sorted(a, b).tolist(), nat.union_sorted(a, b).tolist(),
                     nat.difference_sorted(a, b).tolist()])
    out["sets"] = sets
    vals = rng.integers(-5, 4000, 5000)
    allow = np.unique(rng.integers(0, 4000, 700)).astype(np.uint64)
    out["membership"] = nat.membership(vals, allow).tolist()
    out["membership_empty"] = nat.membership(vals, np.empty(0, np.uint64)).tolist()
    blocks = [np.unique(rng.integers(0, 1 << 45, int(n))).astype(np.uint64)
              for n in rng.integers(0, 300, 30)]
    enc = nat.varint_encode_many(blocks)
    out["varint_many"] = enc
    out["varint"] = [nat.varint_encode(b) for b in blocks]
    out["varint_decoded"] = [nat.varint_decode(e, len(b)).tolist() for e, b in zip(enc, blocks)]
    d = np.sort(rng.standard_normal((5, 40)).astype(np.float32), axis=1)
    d[:, 10:14] = d[:, 10:11]  # ties across lists
    ids = rng.integers(0, 10_000, (5, 40))
    ids[2, 30:] = -1
    out["merge"] = [[a.tolist() for a in nat.merge_topk_host(d, ids, k)] for k in (1, 7, 100, 250)]
    return out
'''


def _results_of(nat):
    ns = {}
    exec(_RESULTS, ns)
    return ns["results"](nat)


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
def test_library_equals_jax_library_and_numpy_fallback():
    got = _results_of(tnative)
    assert got.pop("available") is True
    want = _results_of(jnative)
    assert want.pop("available") is True
    assert got == want
    fallback = pickle.loads(_no_native(
        _RESULTS + "\nimport pickle, sys\nfrom weaviate_tpu_torch import native\n"
        "sys.stdout.buffer.write(pickle.dumps(results(native)))\n"))
    assert fallback.pop("available") is False
    assert got == fallback


_TEXTS = ["The quick brown Fox, jumps over the lazy dog!", "", "   ",
          "rate-limit: 10/s; ARM64 vs x86_64 -- ok?", "a a a b b c", "  Field  Value ",
          "tab\tseparated\nlines\r\nhere", "UPPER lower MiXeD 123abc abc123"]


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
@pytest.mark.parametrize("tokenization", ["word", "lowercase", "whitespace", "field"])
def test_analyze_batch_equals_jax_and_the_python_tokenizer(tokenization):
    from weaviate_tpu_torch.text.tokenizer import tokenize

    rng = np.random.default_rng(3)
    vocab = ["alpha", "Beta", "gamma,", "delta.", "the", "of", "x-ray", "42", "A"]
    values = _TEXTS + [" ".join(rng.choice(vocab, rng.integers(0, 30)))
                       for _ in range(60)]
    got = tnative.analyze_batch(values, tokenization)
    want = jnative.analyze_batch(values, tokenization)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    # the Python tokenizer the import falls back to: the same terms, rows,
    # term frequencies and token counts
    terms, eoffs, rows, tfs, row_tokens = got
    py: dict = {}
    for r, v in enumerate(values):
        toks = tokenize(v, tokenization)
        assert row_tokens[r] == len(toks)
        for t in toks:
            py.setdefault(t.encode(), {}).setdefault(r, 0)
            py[t.encode()][r] += 1
    assert terms == sorted(py)
    for i, t in enumerate(terms):
        sl = slice(eoffs[i], eoffs[i + 1])
        assert dict(zip(rows[sl].tolist(), tfs[sl].tolist())) == py[t]
        assert rows[sl].tolist() == sorted(py[t])


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
def test_storobj_encode_batch_equals_jax_and_to_bytes():
    import msgpack

    from weaviate_tpu_torch.storage.objects import StorageObject

    rng = np.random.default_rng(5)
    n, dim = 37, 24
    objs = [StorageObject(uuid=f"{i:08x}-0000-4000-8000-{rng.integers(0, 1 << 40):012x}",
                          doc_id=1000 + i,
                          properties={"title": f"t{i}", "n": i, "tags": ["a", "b"][: i % 3],
                                      "f": float(i) / 3, "none": None},
                          vectors={"": rng.standard_normal(dim).astype(np.float32)},
                          creation_time_ms=1_700_000_000_000 + i,
                          last_update_time_ms=1_700_000_000_500 + 2 * i)
            for i in range(n)]
    args = ([o.uuid.encode() for o in objs],
            [msgpack.packb(o.properties, use_bin_type=True) for o in objs],
            np.stack([o.vectors[""] for o in objs]),
            np.array([o.doc_id for o in objs], dtype=np.int64),
            np.array([o.creation_time_ms for o in objs], dtype=np.int64),
            np.array([o.last_update_time_ms for o in objs], dtype=np.int64))
    got = tnative.storobj_encode_batch(*args)
    assert got == jnative.storobj_encode_batch(*args)
    assert got == [o.to_bytes() for o in objs]  # the per-object codec
    bad = (["not-a-uuid".encode()] + args[0][1:],) + args[1:]
    assert tnative.storobj_encode_batch(*bad) is None  # callers take the codec


def _postings_ops(nat, strategy, rng):
    """The same write sequence on a PostingsTable; returns every frame and
    the table's contents after each step."""
    t = nat.PostingsTable(strategy)
    seen = []
    keys = [f"k{i:03d}".encode() for i in range(40)]
    for step in range(12):
        ks = sorted(rng.choice(len(keys), rng.integers(1, 12), replace=False).tolist())
        counts = rng.integers(0, 9, len(ks))
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        docs = rng.integers(0, 500, int(offs[-1]))
        sel = [keys[k] for k in ks]
        if strategy == "map":
            if step % 4 == 3:
                t.map_delete(sel, offs, docs)
                frame = None
            else:
                frame = t.map_columns(sel, offs, docs, rng.integers(1, 9, len(docs)),
                                      rng.integers(1, 200, len(docs)), prefix=b"p|")
        else:
            frame = t.roar(sel, offs, docs.astype(np.uint64), is_del=step % 3 == 2,
                           prefix=b"r|")
        if step == 7:
            t.tomb(b"p|" + keys[ks[0]] if strategy == "map" else b"r|" + keys[ks[0]])
        seen.append((frame, t.packed_items(), t.packed_items(b"p|k010", b"r|k030"),
                     [t.get_packed(b"p|" + k) for k in keys[:5]], len(t), t.bytes))
    return seen


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
@pytest.mark.parametrize("strategy", ["map", "roaringset"])
def test_postings_table_equals_jax(strategy):
    got = _postings_ops(tnative, strategy, np.random.default_rng(8))
    want = _postings_ops(jnative, strategy, np.random.default_rng(8))
    assert got == want


def _hnsw_graph(nat, metric, rng):
    n, dim, m = 300, 16, 8
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    g = nat.HnswNative(dim, metric)
    g.reset(n)
    g.set_vectors(0, vecs)
    # layer 0: m nearest by l2 plus a ring; layer 1 on every tenth node
    d2 = ((vecs[:, None] - vecs[None]) ** 2).sum(-1)
    slots, layers, counts, neigh = [], [], [], []
    for s in range(n):
        nb = np.argsort(d2[s])[1:m + 1].tolist() + [(s + 1) % n]
        slots.append(s), layers.append(0), counts.append(len(nb)), neigh.extend(nb)
    g.set_links_batch(np.array(slots), np.array(layers), np.array(counts), np.array(neigh))
    top = np.arange(0, n, 10)
    for s in top:
        g.set_links(int(s), 1, top[top != s][:6])
    g.set_tombstones(rng.choice(n, 20, replace=False))
    return g, vecs


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_hnsw_native_search_equals_jax(metric):
    tg, vecs = _hnsw_graph(tnative, metric, np.random.default_rng(4))
    jg, _ = _hnsw_graph(jnative, metric, np.random.default_rng(4))
    rng = np.random.default_rng(6)
    allow = (rng.random(len(vecs)) > 0.3).astype(np.uint8)
    for q in rng.standard_normal((10, vecs.shape[1])).astype(np.float32):
        for kw in ({}, {"allow": allow}):
            td, ts = tg.search(q, 10, 40, 0, 1, **kw)
            jd, js = jg.search(q, 10, 40, 0, 1, **kw)
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(td, jd)
            assert len(ts) == 10
        ld, ls = tg.search_layer(q, 20, 0, np.array([0, 5]), np.array([1.0, 2.0], np.float32))
        jd, js = jg.search_layer(q, 20, 0, np.array([0, 5]), np.array([1.0, 2.0], np.float32))
        np.testing.assert_array_equal(ls, js)
        np.testing.assert_array_equal(ld, jd)


# -- an import end to end: with the library, without it, and the JAX package --

# ``run(pkg, root)`` imports FiQA-shaped text objects into a Database of
# package ``pkg`` with a fixed clock, asks hybrid, keyword and filtered
# vector queries, and returns the answers and every bucket's contents.
_E2E = r'''
import importlib, types
import numpy as np

DIM = 16

def _zipf_text(rng, words, n):
    vocab = ["the", "of", "and", "to", "a", "in", "is"] + [f"w{i}" for i in range(400)]
    p = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    toks = rng.choice(vocab, n, p=p / p.sum()).tolist()
    for i in range(0, n, 11):  # some capitals and punctuation for the tokenizer
        toks[i] = toks[i].capitalize() + ("," if i % 2 else ".")
    return " ".join(toks)

def objects(n=240):
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    out = []
    for i in range(n):
        text = _zipf_text(rng, None, int(rng.integers(60, 200)))
        if i % 50 == 7:
            text += " café naïve"  # non-ASCII: the Python tokenizer's path
        out.append({"uuid": f"00000000-0000-4000-8000-{i:012d}",
                    "properties": {"title": _zipf_text(rng, None, 6), "text": text,
                                   "n": i % 10},
                    "vector": vecs[i]})
    return out

def _canon(v):
    if isinstance(v, dict):
        return sorted((repr(k), _canon(x)) for k, x in v.items())
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    return v

def run(pkg, root):
    objmod = importlib.import_module(pkg + ".storage.objects")
    S = importlib.import_module(pkg + ".schema.config")
    Filter = importlib.import_module(pkg + ".filters").Filter
    Database = importlib.import_module(pkg + ".db").Database
    clock = objmod.time
    objmod.time = types.SimpleNamespace(time=lambda: 1_700_000_000.0)
    try:
        db = Database(root, **({"device": "cpu"} if pkg == "weaviate_tpu_torch" else {}))
        col = db.create_collection(S.CollectionConfig(
            name="FiQA",
            properties=[S.Property(name="title", data_type="text"),
                        S.Property(name="text", data_type="text"),
                        S.Property(name="n", data_type="int")],
            vectors=[S.VectorConfig(index=S.VectorIndexConfig(index_type="flat",
                                                              metric="cosine"))]))
        objs = objects()
        for s in range(0, len(objs), 64):
            res = col.batch_put(objs[s:s + 64])
            assert all(r["status"] == "SUCCESS" for r in res), res[0]
        # an update of a few objects takes the batched teardown
        col.batch_put([dict(o, properties=dict(o["properties"], n=99)) for o in objs[:5]])
        rng = np.random.default_rng(5)
        qv = rng.standard_normal((6, DIM)).astype(np.float32)
        where = Filter.where("n", "Equal", 0)
        answers = []
        for i, q in enumerate(["w1 w2 the", "w3 w17 of w40", "w5", "Of the W9"]):
            for fusion, alpha in (("relativeScore", 0.75), ("rankedFusion", 0.3)):
                for flt in (None, where):
                    r = col.hybrid(q, vector=qv[i], alpha=alpha, k=10, fusion=fusion,
                                   where=flt)
                    answers.append([(x.uuid, float(x.score)) for x in r])
            r = col.bm25(q, k=10)
            answers.append([(x.uuid, float(x.score)) for x in r])
        shard_name = next(iter(col.shards))
        for i in range(6):
            r = col.near_vector(qv[i], k=10, where=Filter.where("n", "GreaterThanEqual", 5),
                                include_objects=False)
            answers.append([x.uuid for x in r])
            # a doc-id allow list: the membership test over the slot table
            ids = np.arange(i, 250, 3 + i)
            r = col.near_vector(qv[i], k=10, allow_list_by_shard={shard_name: ids},
                                include_objects=False)
            answers.append([x.uuid for x in r])
        shard = next(iter(col.shards.values()))
        buckets = {b.name: _canon(list(b.iter_items())) for b in shard.store.buckets()}
        db.close()
    finally:
        objmod.time = clock
    return {"answers": answers, "buckets": buckets}
'''


def _e2e(pkg, root):
    ns = {}
    exec(_E2E, ns)
    return ns["run"](pkg, root)


@pytest.mark.skipif(not HAVE_LIB, reason="no g++: the library cannot be built")
def test_import_with_and_without_the_library_end_to_end(tmp_path, monkeypatch):
    from weaviate_tpu_torch.storage import kv as tkv
    from weaviate_tpu_torch.text import inverted as tinv

    # the library's branches run here: count them
    calls = {"analyze": 0, "encode": 0, "membership": 0}
    for name, key in (("analyze_batch", "analyze"), ("storobj_encode_batch", "encode"),
                      ("membership", "membership")):
        fn = getattr(tnative, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tnative, name, counted)
    got = _e2e("weaviate_tpu_torch", str(tmp_path / "lib"))
    assert min(calls.values()) > 0, calls
    assert tinv is not None and tkv.native is tnative
    fallback = pickle.loads(_no_native(
        _E2E + "\nimport pickle, sys\n"
        "from weaviate_tpu_torch import native\nassert not native.available()\n"
        "sys.stdout.buffer.write(pickle.dumps(run('weaviate_tpu_torch', sys.argv[1])))\n",
        str(tmp_path / "numpy")))
    assert got["answers"] == fallback["answers"]
    assert got["buckets"] == fallback["buckets"]
    assert {"objects", "docid", "inv_search", "inv_filter"} <= set(got["buckets"])
    # the JAX package writes the same objects, postings and doc-id buckets,
    # and gives the same filtered vector answers (the keyword and hybrid
    # answers of this Zipf corpus hold exact BM25 ties, which the two
    # packages may order differently: tests/test_torch_hybrid_slice.py holds
    # those on a tie-free corpus)
    want = _e2e("weaviate_tpu", str(tmp_path / "jax"))
    assert got["buckets"] == want["buckets"]
    n_vec = 12  # the last answers: where-filtered and doc-id allow-listed near_vector
    assert got["answers"][-n_vec:] == want["answers"][-n_vec:]


# -- the loader -------------------------------------------------------------------

def test_loader_builds_the_ports_own_source():
    """The port's loader compiles csrc/host/weaviate_native.cpp of the port
    into build/torch_native/ under a name that carries the source's hash,
    and its source never names the JAX package's library."""
    assert tnative.SRC == os.path.join(REPO, "weaviate_tpu_torch", "csrc", "host",
                                       "weaviate_native.cpp")
    assert tnative.BUILD_DIR == os.path.join(REPO, "build", "torch_native")
    path = tnative.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert re.fullmatch(r"weaviate_native-[0-9a-f]{12}\.so", os.path.basename(path))
    if HAVE_LIB:
        assert os.path.exists(path)
    # the copy is the JAX package's source but for its comments
    def code(p):
        return [ln for ln in open(p).read().splitlines() if not ln.lstrip().startswith("//")]
    assert code(tnative.SRC) == code(os.path.join(REPO, "csrc", "weaviate_native.cpp"))
    src = open(tnative.__file__).read()
    assert "weaviate_tpu/native" not in src.replace("(``weaviate_tpu/native``)", "")
    assert "libweaviate_native" not in src
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any(n.split(".")[0] == "weaviate_tpu" for n in names)


def test_dataplane_loader_builds_the_ports_own_source():
    """The data plane's loader (weaviate_tpu_torch/dataplane.py) compiles
    the port's csrc/host/dataplane.cpp into build/torch_native/ under a
    hashed name, linking the system libnghttp2.so.14; its source is the
    JAX package's but for its comments, and the loader never names the
    JAX package's library."""
    from weaviate_tpu_torch import dataplane as tdp

    host = os.path.join(REPO, "weaviate_tpu_torch", "csrc", "host")
    assert tdp.SRC == os.path.join(host, "dataplane.cpp")
    path = tdp.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert re.fullmatch(r"dataplane-[0-9a-f]{12}\.so", os.path.basename(path))
    assert "-l:libnghttp2.so.14" in tdp.LINK

    def code(p):
        return [ln for ln in open(p).read().splitlines() if not ln.lstrip().startswith("//")]
    assert code(tdp.SRC) == code(os.path.join(REPO, "csrc", "dataplane.cpp"))
    assert open(os.path.join(host, "nghttp2_abi.h")).read() == \
        open(os.path.join(REPO, "csrc", "nghttp2_abi.h")).read()
    if tdp.available():
        assert os.path.exists(path)
    src = open(tdp.__file__).read()
    assert "weaviate_tpu/native" not in src
    assert "libwvdataplane" not in src
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any(n.split(".")[0] == "weaviate_tpu" for n in names)
    # in a fresh process with the JAX package blocked, the plane maps the
    # port's library and never the JAX package's
    code_ = ("import sys; sys.modules['jax'] = None; sys.modules['weaviate_tpu'] = None\n"
             "from weaviate_tpu_torch import dataplane\n"
             "ok = dataplane.available()\n"
             "maps = open('/proc/self/maps').read()\n"
             "print(ok, dataplane.library_path() in maps, 'libwvdataplane' in maps)\n")
    env = dict(os.environ)
    env.pop("WEAVIATE_TPU_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", code_], capture_output=True, text=True,
                         timeout=600, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    ok = tdp.available()
    assert out.stdout.split() == [str(ok), str(ok), "False"]


def test_loader_opens_no_jax_library(tmp_path):
    """In a fresh process with the JAX package blocked, the port's library
    loads and the only native library mapped is the port's."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['weaviate_tpu'] = None\n"
            "from weaviate_tpu_torch import native\n"
            "ok = native.available()\n"
            "maps = open('/proc/self/maps').read()\n"
            "print(ok, native.library_path() in maps, 'libweaviate_native' in maps)\n")
    env = dict(os.environ)
    env.pop("WEAVIATE_TPU_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(HAVE_LIB), str(HAVE_LIB), "False"]


def test_no_native_env_takes_the_numpy_path():
    out = _no_native("from weaviate_tpu_torch import native\n"
                     "import numpy as np\n"
                     "assert native.storobj_encode_batch([], [], np.zeros((0, 4), np.float32),"
                     " np.zeros(0), np.zeros(0), np.zeros(0)) is None\n"
                     "assert native.analyze_batch(['a b'], 'word') is None\n"
                     "try:\n    native.PostingsTable('map')\nexcept RuntimeError:\n"
                     "    print('raised')\n"
                     "print(native.available())\n")
    assert out.decode().split() == ["raised", "False"]
