"""No JAX anywhere in a run: the look at ``sys.modules`` compares whole
top-level names, and the reference imports nothing of JAX, of the JAX
package or of the program."""

import ast
import subprocess
import sys

from harness import runner, spec


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.serving", "jax_like", "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.forbidden_modules() == []
    for name, top in (("repro.models", "repro"), ("jaxlib.xla", "jaxlib"), ("jax", "jax"),
                      ("flax.linen", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in runner.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_reference_imports_neither_jax_nor_either_package():
    files = sorted((spec.ROOT / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & {"jax", "jaxlib", "flax", "repro", "repro_torch", "harness"}
        assert not bad, (f.name, bad)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in spec.ROOT.rglob("*.py"):
        assert not set(_imports(f)) & {"jax", "jaxlib", "flax", "repro"}, f


def test_a_run_loads_no_jax():
    """Everything a run imports, the program's serving and training entries
    included, in a fresh process."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(spec.ROOT)!r}, {str(spec.CHECKOUT / 'src')!r}]\n"
        "from harness import runner, spec\n"
        "import repro_torch.serving.engine, repro_torch.launch.train\n"
        "for name in ('granite-8b.batch', 'granite-8b.docqa', 'rwkv6-1.6b.train'):\n"
        "    cell = spec.find_cell(name)\n"
        "    cell.driver(); cell.reference()\n"
        "    [cell.reader(m.name) for m in cell.metrics]\n"
        "print(runner.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(spec.ROOT / "run.py"), "--workload",
                          "granite-8b.batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
