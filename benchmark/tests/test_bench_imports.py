"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: ``gpssim_tpu_torch`` is not ``gpssim_tpu``."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "gpssim_tpu"}


def sources(root):
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(HERE)))
def test_no_jax_anywhere(path):
    assert not set(imported(path)) & FORBIDDEN, path


@pytest.mark.parametrize(
    "path", sorted(sources(os.path.join(HERE, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    assert "gpssim_tpu_torch" not in set(imported(path)), path
