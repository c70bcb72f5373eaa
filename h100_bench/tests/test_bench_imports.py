"""No module of the benchmark imports JAX or the JAX package, comparing each
top-level module name whole; the references import nothing of the port."""

import ast
import os
import subprocess
import sys

from h100_bench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "mma_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _files():
    for base, dirs, files in os.walk(core.BENCH_DIR):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_file_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _files() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad
    # The port's name begins with the JAX package's: whole names differ.
    assert "mma_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_references_import_nothing_of_the_port():
    ref_dir = os.path.join(core.BENCH_DIR, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref_dir, f))}
            assert tops <= {"__future__", "typing", "numpy", "torch"}, (f, tops)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from h100_bench import core\n"
        "core.run_cell('node-large-train', 1, 0.1, False, 'cpu',\n"
        "              overrides={'config': {'num_nodes': 500, 'avg_deg': 4}})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (core.ROOT, FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(core.BENCH_DIR, "run.py"),
                          "--workload", "zinc-serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
