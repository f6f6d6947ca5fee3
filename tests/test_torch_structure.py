"""The port's structure, read from its sources: ``ops/cuda``'s modules
import one way (the card's facts and the weight cache at the bottom, in
``build``; K2's module imported only by K4 and K5), and every port test
module takes the one-thread fixture (``tests/torch_threads.py``)."""

import ast
from pathlib import Path

import pytest

from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.ops.cuda import window_attention as k2

from .torch_threads import one_cpu_thread  # noqa: F401

CUDA_DIR = Path(build.__file__).parent
PACKAGE = "audio_residual_tpu_torch.ops.cuda"
# ops/cuda's layers, bottom first: a module imports only from lower ones
LAYERS = {"build": 0, "autograd": 0, "tf32x3": 1, "gemm": 2, "frontend": 3, "qr": 3,
          "window_attention": 3, "ln_mlp": 3, "linear": 3, "wide_attention": 4, "swin_block": 4}
# the one import made at call time instead: K2's route to K5 from WIDE_MIN_C
AT_CALL = {("window_attention", "wide_attention")}
# defined in build alone
BUILD_NAMES = {"H100_SMS", "SMEM_LIMIT", "sm_count", "_stamp", "_derived", "derived",
               "store_dtype", "mxu_weights", "weight_map"}


def _tree(name: str) -> ast.Module:
    return ast.parse((CUDA_DIR / f"{name}.py").read_text())


def _imports(name: str) -> list[tuple[str, bool]]:
    """``(sibling module, imported at module level)`` for each import of a
    module of ``ops/cuda`` in ``ops/cuda/<name>.py``."""
    tree = _tree(name)
    top = {id(node) for node in tree.body}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:
                module = PACKAGE + (f".{module}" if module else "")
            if module == PACKAGE:
                mods = [a.name for a in node.names if a.name in LAYERS]
            elif module.startswith(PACKAGE + "."):
                mods = [module[len(PACKAGE) + 1:].split(".")[0]]
            else:
                continue
        elif isinstance(node, ast.Import):
            mods = [a.name[len(PACKAGE) + 1:].split(".")[0] for a in node.names
                    if a.name.startswith(PACKAGE + ".")]
        else:
            continue
        found += [(m, id(node) in top) for m in mods]
    return found


def test_every_ops_cuda_module_has_a_layer():
    assert {p.stem for p in CUDA_DIR.glob("*.py")} - {"__init__"} == set(LAYERS)


@pytest.mark.parametrize("name", list(LAYERS))
def test_ops_cuda_imports_point_one_way(name):
    for module, at_import in _imports(name):
        if at_import:
            assert LAYERS[module] < LAYERS[name], f"{name} imports {module}"
        else:
            assert (name, module) in AT_CALL, f"{name} imports {module} at call time"


def test_only_k4_and_k5_import_k2():
    importers = {name for name in LAYERS if name != "window_attention"
                 and any(m == "window_attention" for m, _ in _imports(name))}
    assert importers == {"swin_block", "wide_attention"}


@pytest.mark.parametrize("name", [n for n in LAYERS if n != "build"])
def test_card_facts_and_weight_cache_are_defined_in_build_alone(name):
    defined = set()
    for node in _tree(name).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            defined |= {t.id for t in targets if isinstance(t, ast.Name)}
    assert not defined & BUILD_NAMES


def test_k2_re_exports_none_of_builds_names():
    assert all(hasattr(build, n) for n in BUILD_NAMES)
    assert not [n for n in BUILD_NAMES if hasattr(k2, n)]


def test_every_port_test_module_takes_the_thread_fixture():
    tests = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert tests
    missing = [p.name for p in tests
               if "from .torch_threads import one_cpu_thread" not in p.read_text()]
    assert not missing
