"""``run.py`` refuses to run, and prints no result, without a card."""
import json
import os
import subprocess
import sys

from bench_cells import ROOT


def test_run_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "yi6b-d4.steady",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            pass


def test_an_unknown_workload_is_refused():
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "no-such-cell",
                           "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no workload" in proc.stderr
