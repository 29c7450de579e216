"""Nothing the harness runs imports JAX or the JAX package: top-level
module names compared whole, so ``repro_torch`` passes and ``repro``
does not."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r'''
import importlib, importlib.abc, json, pkgutil, sys, tempfile
from pathlib import Path
BLOCKED = {"jax", "jaxlib", "flax", "repro"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [ROOT, ROOT + "/src"]
import bench
for m in pkgutil.walk_packages(bench.__path__, "bench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from bench.run import forbidden_modules, run_cell
from bench.tests.tiny import tiny_root
r = run_cell("splade.b512.k1000", 11, 0.2, False, device="cpu",
             root=tiny_root(Path(tempfile.mkdtemp())))
assert r["correct"], r["checks"]
top = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
print(json.dumps({"forbidden": forbidden_modules(), "top": top,
                  "repro_torch": "repro_torch" in sys.modules}))
'''


def test_harness_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()[-1]
    assert out == ('{"forbidden": [], "top": [], "repro_torch": true}')
