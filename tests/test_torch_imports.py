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
    # the training callbacks and the modules that gained training steps
    assert {"cosmos_predict2_tpu_torch/callbacks/__init__.py", "cosmos_predict2_tpu_torch/callbacks/callbacks.py",
            "cosmos_predict2_tpu_torch/models/interactive.py", "cosmos_predict2_tpu_torch/models/wan_video2world.py",
            "cosmos_predict2_tpu_torch/models/edm.py", "cosmos_predict2_tpu_torch/models/action_conditioned.py",
            "cosmos_predict2_tpu_torch/training/trainer.py"} <= set(FILES)
    # the serving front end and the guardrails
    assert {f"cosmos_predict2_tpu_torch/{m}.py" for m in (
        "utils/validator", "utils/env_parsers", "utils/blocklist", "utils/retinaface", "utils/guardrails",
        "inference/serving", "inference/web_ui", "inference/api", "inference/cli")} <= set(FILES)
    # context parallelism
    assert {f"cosmos_predict2_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "launch", "mesh", "comm", "cp", "ring_attention", "halo_conv")} <= set(FILES)


def test_wandb_only_inside_the_metrics_logger():
    """wandb is on neither machine: the port imports it only inside
    WandbLogger's constructor (which falls back to a jsonl file), and
    chip_smoke.py not at all."""
    found = {path: imports_in_functions((REPO / path).read_text(), "wandb") for path in FILES}
    assert {path: f for path, f in found.items() if f} == {"cosmos_predict2_tpu_torch/callbacks/callbacks.py": ["__init__"]}


# transformers (tokenizers, HF modules) is not on the card's machine: the
# port's prompt encoders import it only inside the functions that tokenize
# or build an HF module, and chip_smoke.py not at all.
TRANSFORMERS_ALLOWED = {
    "cosmos_predict2_tpu_torch/text_encoders/text_encoder.py": {"tokenizer"},
    "cosmos_predict2_tpu_torch/text_encoders/t5.py": {"tokenize", "_load"},
}
TEXT_ENCODER_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "cosmos_predict2_tpu_torch" / "text_encoders")
                            .rglob("*.py"))


def transformers_imports(source: str) -> list:
    """The name of the function enclosing each ``transformers`` import (None:
    at module level)."""
    return imports_in_functions(source, "transformers")


def imports_in_functions(source: str, module: str) -> list:
    """The name of the function enclosing each import of ``module`` (None:
    at module level)."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                names = [child.module]
            if any(n.split(".")[0] == module for n in names):
                found.append(func)
            visit(child, func)

    visit(ast.parse(source), None)
    return found


def test_transformers_checker_sees_the_enclosing_function():
    src = "import transformers\nclass A:\n    def tok(self):\n        from transformers import AutoTokenizer\n"
    assert transformers_imports(src) == [None, "tok"]


@pytest.mark.parametrize("path", TEXT_ENCODER_FILES + ["chip_smoke.py"])
def test_transformers_only_where_prompts_are_tokenized(path):
    found = transformers_imports((REPO / path).read_text())
    allowed = TRANSFORMERS_ALLOWED.get(path, set())
    assert set(found) <= allowed, f"{path} imports transformers in {sorted(map(str, found))}"
    assert len(TEXT_ENCODER_FILES) == 10 and set(found) == allowed  # every allowed site is still the only one
