"""The PyTorch port stands alone: no module of ``mpi4jax_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, jaxlib or the JAX package, not even a
module of it that happens not to import JAX.  Checked on the source with
``ast``, so an import inside a function counts too."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "mpi4jax_tpu", "research"}
SOURCES = sorted((REPO / "mpi4jax_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _imported_top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"shallow_water.py", "sw_step.py", "halo.py", "flash.py",
            "longseq.py", "transformer.py", "transformer_decode.py",
            "chip_smoke.py"} <= names
    flash = {p.relative_to(REPO).as_posix() for p in SOURCES
             if p.name == "flash.py"}
    assert flash == {"mpi4jax_tpu_torch/kernels/flash.py",
                     "mpi4jax_tpu_torch/ops/flash.py"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [(line, name) for line, name in _imported_top_names(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_sees_forbidden_imports(tmp_path):
    # the exact-name comparison: mpi4jax_tpu_torch is allowed,
    # mpi4jax_tpu is not, wherever the import sits
    src = tmp_path / "m.py"
    src.write_text(
        "import mpi4jax_tpu_torch.ops\n"
        "def f():\n"
        "    from mpi4jax_tpu.ops import reductions\n"
        "    import jax.numpy as jnp\n"
        "    importlib.import_module('jaxlib.xla_client')\n"
    )
    names = [n for _, n in _imported_top_names(src)]
    assert names == ["mpi4jax_tpu_torch", "mpi4jax_tpu", "jax", "jaxlib"]
