"""chip_smoke.py's refusals and bench.py's peak table, on the CPU: both
need a GPU, and neither prints a result without one."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    r = _run(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU found" in r.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_peak_table_knows_the_h100_and_rejects_others():
    sys.path.insert(0, str(REPO))
    import bench

    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no bf16 peak"):
        bench.peak_bf16_flops("cpu")
