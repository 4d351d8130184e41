"""PyTorch port: its surface against the JAX package's, by AST only.

For every ``.py`` file under ``src/repro/`` (one case each):

* the counterpart under ``src/repro_torch/`` exists;
* each public top-level name of the JAX file (a function, a class, an
  assigned name, an ``__all__`` entry) and each name that a JAX
  ``__init__.py`` re-exports is bound at the counterpart's top level
  (defined, assigned or imported), or is in the counterpart's
  ``__all__`` beside a module ``__getattr__`` that loads it on first use;
* each ``--flag`` that a JAX ``add_argument`` declares is declared in the
  counterpart too.

``EXCEPTIONS`` lists what the port does not carry, each with its reason;
an entry that the port carries after all fails its own test.  Neither
package is imported.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
JAX, PORT = SRC / "repro", SRC / "repro_torch"
JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))

_TILES = "the TPU kernel's tile sizes; the CUDA kernel picks its own"
EXCEPTIONS = {
    ("apps/axpy.py", "make_streams"): "renamed: apps/axpy.draw",
    ("kernels/hbm_blas/kernel.py", "fold_partials"):
        "moved: kernels/hbm_blas/ops.fold_partials",
    ("launch/shardings.py", "param_shardings"):
        "renamed: launch/shardings.param_specs",
    ("launch/plan.py", "HBM_PER_CHIP"):
        "a TPU's memory; make_plan takes it as an argument "
        "(REFERENCE_HBM_PER_CHIP)",
    ("models/transformer.py", "np_prod"): "a helper of param_count",
    ("models/shardctx.py", "shard"):
        "no activation constraints in the port (by design)",
    ("models/shardctx.py", "is_serve"):
        "no activation constraints in the port (by design)",
    ("models/shardctx.py", "clear"):
        "no activation constraints in the port (by design)",
    ("launch/hlo_analysis.py", "cpu_bf16_convert_bytes"):
        "XLA's CPU bf16 converts; the port's dry run records an eager step",
    ("models/layers.py", "Array"): "the jax.Array type alias",
    ("kernels/flash_attention/kernel.py", "DEFAULT_BLOCK_Q"): _TILES,
    ("kernels/flash_attention/kernel.py", "DEFAULT_BLOCK_K"): _TILES,
    ("kernels/flash_attention/kernel.py", "NEG_INF"):
        "the Pallas body's mask value",
    ("kernels/knn/kernel.py", "DEFAULT_BLOCK_Q"): _TILES,
    ("kernels/knn/kernel.py", "DEFAULT_BLOCK_N"): _TILES,
    ("kernels/knn/kernel.py", "BIG"): "the Pallas body's padding distance",
    ("kernels/systolic_matmul/kernel.py", "DEFAULT_BM"): _TILES,
    ("kernels/systolic_matmul/kernel.py", "DEFAULT_BN"): _TILES,
    ("kernels/systolic_matmul/kernel.py", "DEFAULT_BK"): _TILES,
}


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _targets(node) -> list:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _all_entries(tree: ast.Module) -> set:
    return {c.value for node in tree.body
            if isinstance(node, (ast.Assign, ast.AnnAssign))
            and "__all__" in _targets(node) and node.value is not None
            for c in ast.walk(node.value)
            if isinstance(c, ast.Constant) and isinstance(c.value, str)}


def public_names(tree: ast.Module, is_init: bool) -> set:
    """The JAX file's public top-level names, its ``__all__`` entries and,
    in an ``__init__.py``, what it re-exports."""
    names = set(_all_entries(tree))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
        elif is_init and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def bound_names(tree: ast.Module) -> set:
    """What the counterpart's top level binds, under ``if`` and ``try``
    too, plus its ``__all__`` when a module ``__getattr__`` loads names
    on first use."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)):
                names.update(_targets(node))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for handler in getattr(node, "handlers", ()):
                    visit(handler.body)
                visit(getattr(node, "finalbody", ()))

    visit(tree.body)
    if "__getattr__" in names:
        names |= _all_entries(tree)
    return names


def cli_flags(tree: ast.Module) -> set:
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
            for a in node.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)
            and a.value.startswith("--")}


def test_the_jax_package_is_scanned():
    assert len(JAX_FILES) >= 100
    assert {"net/smoke.py", "mem/smoke.py", "launch/__init__.py"} \
        <= set(JAX_FILES)


@pytest.mark.parametrize("rel", JAX_FILES)
def test_counterpart_carries_the_surface(rel):
    counterpart = PORT / rel
    assert counterpart.is_file(), f"src/repro_torch/{rel} is missing"
    jax_tree, port_tree = _parse(JAX / rel), _parse(counterpart)
    bound = bound_names(port_tree)
    missing = sorted(n for n in public_names(
        jax_tree, rel.endswith("__init__.py")) - bound
        if (rel, n) not in EXCEPTIONS)
    assert not missing, f"src/repro_torch/{rel} lacks {missing}"
    flags = sorted(cli_flags(jax_tree) - cli_flags(port_tree))
    assert not flags, f"src/repro_torch/{rel} lacks the flags {flags}"


@pytest.mark.parametrize("rel,name", sorted(EXCEPTIONS))
def test_each_exception_is_still_owed(rel, name):
    """An exception names a public JAX name the port does not bind."""
    assert name in public_names(_parse(JAX / rel),
                                rel.endswith("__init__.py"))
    assert name not in bound_names(_parse(PORT / rel))
