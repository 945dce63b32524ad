"""What the harness and the references import, by the top-level name of
each module (the part before the first dot, compared whole): never JAX
or the JAX package; and the references import nothing of the port."""
import ast
import os

import pytest

from conftest import BENCH

NEVER = {"jax", "jaxlib", "flax", "parsec_tpu"}
PORT = "parsec_tpu_torch"


def _imports(path):
    """Top-level names of every module the file imports (relative
    imports resolve inside benchmark/)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(*dirs):
    for d in dirs:
        root = os.path.join(BENCH, d)
        for dirpath, _, names in os.walk(root):
            if "__pycache__" in dirpath or os.sep + "tests" in dirpath:
                continue
            for n in names:
                if n.endswith(".py"):
                    yield os.path.join(dirpath, n)


def test_nothing_imports_jax_or_the_jax_package():
    files = list(_files(".")) + [os.path.join(BENCH, "tests", n)
                                 for n in os.listdir(os.path.join(
                                     BENCH, "tests")) if n.endswith(".py")]
    assert files
    for path in files:
        bad = _imports(path) & NEVER
        assert not bad, (path, bad)


def test_the_port_name_is_not_the_jax_package_name():
    # the port's name begins with the JAX package's: only whole names
    # count
    assert PORT.split(".")[0] not in NEVER


@pytest.mark.parametrize("name", ["spotrf", "sgemm"])
def test_references_import_nothing_of_the_port(name):
    seen, todo = set(), [os.path.join(BENCH, "reference", name + ".py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        mods = _imports(path)
        assert PORT not in mods and not mods & NEVER, (path, mods)
        if "harness" in mods:
            # the harness modules a reference reaches count as its own
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.module and \
                        node.module.startswith("harness."):
                    todo.append(os.path.join(
                        BENCH, *node.module.split(".")) + ".py")
    assert len(seen) >= 2
