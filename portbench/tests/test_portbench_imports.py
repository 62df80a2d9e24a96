"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference and the generators import nothing of the program: each
import's top-level name compared whole (the port's name begins with the
JAX package's)."""

import ast
import os

from portbench.manifest import PKG

FORBIDDEN = {"jax", "jaxlib", "flax", "weaviate_tpu"}
PROGRAM = "weaviate_tpu_torch"
INDEPENDENT = ("reference", "data", "roofline", "control", "stats", "manifest")


def _modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _imports(path):
    return (m.split(".")[0] for m in _modules(path))


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(p, n) for p in _sources() for n in _imports(p) if n in FORBIDDEN}
    assert not found


def test_the_reference_and_generators_import_nothing_of_the_program():
    """Nor any module of the harness that does."""
    for name in INDEPENDENT:
        mods = set(_modules(os.path.join(PKG, name + ".py")))
        assert PROGRAM not in {m.split(".")[0] for m in mods}, name
        ours = {m.split(".")[1] for m in mods if m.startswith("portbench.")}
        assert ours <= set(INDEPENDENT), (name, ours)


def test_the_scan_compares_whole_names():
    import sys

    from portbench.run import forbidden_modules

    sys.modules["weaviate_tpu_torch_probe_name"] = sys
    try:
        assert "weaviate_tpu_torch_probe_name" not in forbidden_modules()
    finally:
        del sys.modules["weaviate_tpu_torch_probe_name"]
