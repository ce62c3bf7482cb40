"""The import guard: the harness and the reference load neither JAX nor
the JAX package, and the reference loads nothing of the program."""

import ast
import subprocess
import sys

from bench_setup import BENCH, ROOT

TOP_LEVEL_BANNED = {"jax", "jaxlib", "flax", "crt_tpu"}


def _imports(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        if "tests" in f.relative_to(BENCH).parts:
            continue
        assert not set(_imports(f)) & TOP_LEVEL_BANNED, f


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        assert "crt_tpu_torch" not in set(_imports(f)), f


def test_loaded_modules_after_import():
    """In a fresh process: after importing the harness and the program,
    no banned top-level module; after importing the reference alone, no
    module of the program either."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference.render, reference.fit\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'crt_tpu_torch' not in tops, tops\n"
        "import run\n"
        "from harness import driver, spans, trace, roofline, faults\n"
        "import crt_tpu_torch.renderer, crt_tpu_torch.optim\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n"
        "print('ok')\n" % (str(ROOT), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


def test_the_guard_sees_whole_top_level_names():
    import run

    sys.modules.setdefault("crt_tpu_torch_like_name", sys)
    try:
        assert "crt_tpu" not in run.forbidden_modules()
    finally:
        sys.modules.pop("crt_tpu_torch_like_name", None)
