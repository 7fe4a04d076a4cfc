"""The port (opus_tpu_torch) never imports jax, not even transitively.

Checked in a fresh interpreter, because tests/conftest.py imports jax
into this one."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import opus_tpu_torch
names = ["opus_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    opus_tpu_torch.__path__, "opus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), "modules;", "jax modules:", bad)
sys.exit(1 if bad else 0)
"""


def test_torch_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jax modules: []" in proc.stdout


def test_torch_numpy_tables_import_no_jax():
    """The jax-free numpy modules of opus_tpu that the port imports."""
    probe = ("import sys\n"
             "import opus_tpu.celt.modes, opus_tpu.celt.tables, "
             "opus_tpu.celt.cwrs, opus_tpu.bitstream.range_coder\n"
             "sys.exit(1 if 'jax' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
