"""The port imports nothing of JAX and nothing of the JAX package.

Every ``*.py`` of ``cosmos_predict2_tpu_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; every ``import`` / ``from ... import`` anywhere in it
(module level or inside a function) is checked against the forbidden
top-level names. ``cosmos_predict2_tpu_torch`` itself passes: the check is
on the exact top-level name.
"""

import ast
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cosmos_predict2_tpu"}
FILES = sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "cosmos_predict2_tpu_torch").rglob("*.py")] + ["chip_smoke.py"]
)


def imported_top_names(source: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_checker_sees_lazy_and_dotted_imports():
    src = "import os\ndef f():\n    from cosmos_predict2_tpu.utils import io\n    import jax.numpy as jnp\n"
    assert imported_top_names(src) & FORBIDDEN == {"cosmos_predict2_tpu", "jax"}
    assert not imported_top_names("from cosmos_predict2_tpu_torch.ops import rope\n") & FORBIDDEN


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    found = imported_top_names((REPO / path).read_text()) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


def test_every_port_module_is_checked():
    assert len(FILES) > 20 and "chip_smoke.py" in FILES
    assert all(os.path.exists(REPO / f) for f in FILES)
