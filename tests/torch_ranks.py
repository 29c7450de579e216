"""Run a script in N processes that join one ``torch.distributed`` group.

Shared by the port's multi-rank tests (gloo on the CPU): each process gets
its rank and a ``FileStore`` path as ``argv[1:3]``, and prints one
``RESULT:<json>`` line."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def run_ranks(script: str, n: int, tmp_path, timeout: int = 120) -> list:
    """``script`` in ``n`` processes (argv: rank, a FileStore path), all
    started together, with only the port on the path; the parsed
    ``RESULT:`` line of each, in rank order."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = str(Path(tmp_path) / "store")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), store],
                              env=env, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT:")][0]
            outs.append(json.loads(line[len("RESULT:"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# Prepended to a rank script: refuse any import of jax or the JAX package.
BLOCK_JAX = '''
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
'''
