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

# the policy simulator's slice (paper C3): the simulator, its event queue and
# perf models, the autoscale policies and the rest of the flight recorder
SIMULATOR_MODULES = {
    "repro_torch.core", "repro_torch.core.events", "repro_torch.obs.profile",
    "repro_torch.obs.critical_path", "repro_torch.core.metrics",
    "repro_torch.core.perf_model", "repro_torch.core.simulator",
    "repro_torch.core.autoscale", "repro_torch.obs.audit",
    "repro_torch.obs.spans", "repro_torch.obs.timeline",
    "repro_torch.obs.watchdog", "repro_torch.obs",
}


# the cloud layer: node pools and the spot market, cost accounting, the
# node autoscaler, spot bidding and the cloud simulator
CLOUD_MODULES = {
    "repro_torch.cloud", "repro_torch.cloud.provider", "repro_torch.cloud.cost",
    "repro_torch.cloud.node_autoscaler", "repro_torch.cloud.bidding",
    "repro_torch.cloud.sim",
}

# the trace workloads: ingestion, synthetic generators, stats and replay
WORKLOAD_MODULES = {
    "repro_torch.workloads", "repro_torch.workloads.trace",
    "repro_torch.workloads.synthetic", "repro_torch.workloads.stats",
    "repro_torch.workloads.replay",
}


# the model families: the MoE layer and the configs of the dense, MoE and
# vlm-backbone archs
MODEL_MODULES = {
    "repro_torch.models.moe", "repro_torch.models.transformer",
    "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.configs.yi_9b",
    "repro_torch.configs.starcoder2_7b", "repro_torch.configs.minitron_4b",
    "repro_torch.configs.chameleon_34b",
}


# serving: the serve CLI and the analytic FLOP models
SERVE_MODULES = {"repro_torch.launch.serve", "repro_torch.utils",
                 "repro_torch.utils.flops"}

# multi-head latent attention: the blocked-attention twin and deepseek-v2
MLA_MODULES = {"repro_torch.kernels.blocked", "repro_torch.configs.deepseek_v2_236b"}

# the hybrid layout: jamba-v0.1-52b's config
HYBRID_MODULES = {"repro_torch.configs.jamba_v0_1_52b"}

# the encoder-decoder layout: seamless-m4t-large-v2's config and the data
# stream that carries its encoder frames
ENCDEC_MODULES = {"repro_torch.configs.seamless_m4t_large_v2",
                  "repro_torch.data", "repro_torch.data.pipeline"}


# sharding rules, cells, the dry-run and the H100 roofline
DRYRUN_MODULES = {"repro_torch.sharding", "repro_torch.sharding.specs",
                  "repro_torch.launch.mesh", "repro_torch.launch.cells",
                  "repro_torch.launch.dryrun", "repro_torch.utils.roofline",
                  "repro_torch.utils.memtrace"}

# the spans and counters of the training path
TRACING_MODULES = {"repro_torch.obs.device_spans"}

# the experts' ragged products
MOE_KERNEL_MODULES = {"repro_torch.kernels.moe_gemm"}


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 85, proc.stdout
    names = set(proc.stdout.split("MODULES")[1].split("IMPORTED")[0].split())
    assert OPERATOR_MODULES <= names, sorted(OPERATOR_MODULES - names)
    assert SIMULATOR_MODULES <= names, sorted(SIMULATOR_MODULES - names)
    assert CLOUD_MODULES <= names, sorted(CLOUD_MODULES - names)
    assert WORKLOAD_MODULES <= names, sorted(WORKLOAD_MODULES - names)
    assert MODEL_MODULES <= names, sorted(MODEL_MODULES - names)
    assert SERVE_MODULES <= names, sorted(SERVE_MODULES - names)
    assert MLA_MODULES <= names, sorted(MLA_MODULES - names)
    assert HYBRID_MODULES <= names, sorted(HYBRID_MODULES - names)
    assert ENCDEC_MODULES <= names, sorted(ENCDEC_MODULES - names)
    assert DRYRUN_MODULES <= names, sorted(DRYRUN_MODULES - names)
    assert TRACING_MODULES <= names, sorted(TRACING_MODULES - names)
    assert MOE_KERNEL_MODULES <= names, sorted(MOE_KERNEL_MODULES - names)
