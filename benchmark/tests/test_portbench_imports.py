"""Nothing the benchmark runs imports JAX, flax or the JAX package, by whole
top-level module name (``audiolab_tpu_torch`` is not ``audiolab_tpu``), and
the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.ROOT)


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*parts):
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py") if "tests" not in p.parts)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "audiolab_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "audiolab_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert harness.forbidden_modules() == ["audiolab_tpu.models", "flax"]


def test_no_source_imports_jax_or_the_jax_package():
    for p in sources():
        bad = imported_tops(p) & set(harness.FORBIDDEN)
        assert not bad, f"{p}: imports {bad}"
        text = p.read_text()
        for name in ("chip_smoke", "bench.py", "audiolab_tpu/"):
            assert name not in text, f"{p} names {name}"


def test_references_import_nothing_of_the_port():
    for p in sources("reference"):
        assert "audiolab_tpu_torch" not in imported_tops(p), p
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from benchmark import harness\n"
            "for n in ('chain-bsroformer2-rvc48k', 'train-rvc48k'):\n"
            "    harness.load_module(harness.ROOT / 'reference' / n / 'reference.py', n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('audiolab_tpu_torch', 'audiolab_tpu', 'jax', 'flax')]\n"
            "assert not bad, bad\n") % str(BENCH.parent)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=BENCH.parent)


def test_a_run_loads_no_jax(tree):
    """The harness exits non-zero if a forbidden module is loaded after the
    window; the tiny cell's run exits 0."""
    import tiny

    assert tiny.result(tiny.run_cpu(tree, "tiny.chain"))["attempted"] >= 1
