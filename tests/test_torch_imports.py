"""The PyTorch port and ``chip_smoke.py`` import nothing of JAX, ml_dtypes or
the JAX package: a subprocess refuses those imports with a hook, imports
every module of ``repro_torch`` and ``chip_smoke`` (without running it), and
checks that none of them was loaded."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"banned import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, sys.argv[1])
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("MODULES", " ".join(names))
print("IMPORTED", len(names))
"""

# the live operator's slice: the scheduler modules copied from the JAX
# package, the async checkpointer and the operator itself
OPERATOR_MODULES = {
    "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.stats",
    "repro_torch.obs.decisions", "repro_torch.core.job",
    "repro_torch.core.placement", "repro_torch.core.cluster",
    "repro_torch.core.policies", "repro_torch.core.metrics",
    "repro_torch.checkpoint.async_ckpt", "repro_torch.core.operator",
}


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 44, proc.stdout
    names = set(proc.stdout.split("MODULES")[1].split("IMPORTED")[0].split())
    assert OPERATOR_MODULES <= names, sorted(OPERATOR_MODULES - names)
