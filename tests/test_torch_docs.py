"""docs/API_torch.md, the PyTorch port's rendered API reference, is
generated from the live docstrings by docs/gen_api_torch.py; drift between
the code and the file fails here.  The generator runs in a fresh
interpreter in which jax and the JAX package cannot be imported."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_api_reference_not_stale():
    code = """
import runpy, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ltetrigger_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
sys.argv = ["gen_api_torch.py", "--check"]
try:
    runpy.run_path("docs/gen_api_torch.py", run_name="__main__")
except SystemExit as e:
    sys.exit(e.code)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "up to date" in r.stdout
