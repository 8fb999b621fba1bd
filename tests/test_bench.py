"""bench.py measures only on a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_bench_refuses_non_gpu_backend(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(REPO / "bench.py")], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["value"] is None
    assert "no GPU" in line["unit"]
