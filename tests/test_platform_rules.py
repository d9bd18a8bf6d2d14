"""Source rules of the GPU program, and the compile-cache rules.

The package, bench.py, chip_smoke.py and tools/ hold no TPU Pallas
import, no branch on a TPU backend, no ``interpret=`` computed from the
backend and no ``use_pallas`` / ``SMF_PLATFORM`` switch."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(
    [*ROOT.joinpath("sparse_matrix_with_flops_tpu").rglob("*.py")]
    + [*ROOT.joinpath("tools").glob("*.py")]
    + [ROOT / "bench.py", ROOT / "chip_smoke.py"]
)


def _trees():
    for p in SOURCES:
        yield p.relative_to(ROOT), ast.parse(p.read_text(), filename=str(p))


def _mentions_backend(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
            "default_backend",
            "platform",
        ):
            return True
        if isinstance(sub, ast.Name) and sub.id == "default_backend":
            return True
    return False


def _tpu_pallas_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith("jax.experimental.pallas.tpu"):
                yield node
            if node.module == "jax.experimental.pallas" and any(
                a.name == "tpu" for a in node.names
            ):
                yield node
        if isinstance(node, ast.Import) and any(
            a.name.startswith("jax.experimental.pallas.tpu")
            for a in node.names
        ):
            yield node


def _backend_interpret(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "interpret":
            if _mentions_backend(node.value):
                yield node


def _tpu_compares(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and any(
            isinstance(c, ast.Constant) and c.value == "tpu"
            for c in [node.left, *node.comparators]
        ):
            yield node


def _old_switches(tree):
    for node in ast.walk(tree):
        name = (
            node.id
            if isinstance(node, ast.Name)
            else node.arg
            if isinstance(node, (ast.arg, ast.keyword))
            else node.value
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            else None
        )
        if name in ("use_pallas", "_use_pallas_default", "SMF_PLATFORM"):
            yield node


RULES = {
    "tpu_pallas_import": _tpu_pallas_imports,
    "backend_computed_interpret": _backend_interpret,
    "tpu_backend_branch": _tpu_compares,
    "use_pallas_or_platform_override": _old_switches,
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_no_tpu_only_code(rule):
    hits = [
        f"{path}:{node.lineno}"
        for path, tree in _trees()
        for node in RULES[rule](tree)
    ]
    assert not hits, f"{rule}: {hits}"


def test_rules_catch_a_violation():
    bad = ast.parse(
        "from jax.experimental.pallas import tpu as pltpu\n"
        "f(x, interpret=jax.default_backend() != 'tpu')\n"
        "use_pallas = True\n"
    )
    assert all(list(rule(bad)) for rule in RULES.values())


# ---- compile cache ---------------------------------------------------------
@pytest.fixture
def config_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("SMF_NO_COMPILE_CACHE", raising=False)
    return calls


def test_compile_cache_defaults_to_fixed_repo_dir(config_updates):
    from sparse_matrix_with_flops_tpu.utils.timing import enable_compile_cache

    enable_compile_cache()
    assert (
        "jax_compilation_cache_dir",
        str(ROOT / ".jax_cache"),
    ) in config_updates


def test_compile_cache_env_dir_wins(config_updates, monkeypatch, tmp_path):
    from sparse_matrix_with_flops_tpu.utils.timing import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    enable_compile_cache()
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_can_be_disabled(config_updates, monkeypatch):
    from sparse_matrix_with_flops_tpu.utils.timing import enable_compile_cache

    monkeypatch.setenv("SMF_NO_COMPILE_CACHE", "1")
    enable_compile_cache()
    assert config_updates == []


def test_compile_cache_dir_is_ignored_by_git():
    lines = ROOT.joinpath(".gitignore").read_text().split()
    assert ".jax_cache/" in lines
