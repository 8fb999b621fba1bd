"""chip_smoke.py on the CPU: its device gate and its two comparators.

The GPU phases themselves run only on a GPU (``python chip_smoke.py``);
here the gate must refuse the CPU, and the oracle and golden comparators
must pass what is right and fail what is not.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_gate_refuses_cpu(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "[headline]" not in r.stdout, "rendered before the gate"
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def mosaic_render(tmp_path_factory):
    """A small Fast render over a 2x3-tile mosaic whose rays cross tiles."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.terrain.store import Terrain

    size = chip_smoke.Size(width=32, height=18, max_km=80.0, posts=121,
                           reach_lat=0.5, reach_lon=1.0, oracle_cols=8)
    folder = tmp_path_factory.mktemp("mosaic")
    grids = chip_smoke.write_mosaic(folder, size)
    terrain = Terrain.from_folder(folder)
    params = Config.from_dict(
        chip_smoke.view_config(size, folder)).into_params(terrain)
    hits = render_fast(params, terrain).hits
    valid, dist, elev = (np.asarray(a)[..., 0]
                         for a in (hits.valid, hits.distance, hits.elevation))
    assert valid.any()
    return size, grids, params, valid, dist, elev


@pytest.mark.parametrize("shift_m", [0.0, 1.0], ids=["render", "shifted"])
def test_oracle_comparator(mosaic_render, shift_m):
    size, grids, params, valid, dist, elev = mosaic_render
    assert len(grids) == 6
    cols = np.linspace(0, size.width - 1, size.oracle_cols).round()
    rep = chip_smoke.compare_with_oracle(
        valid, dist + np.float32(shift_m), elev, grids, params, size,
        cols.astype(int))
    assert rep["robust"] > 20
    assert chip_smoke.oracle_ok(rep) is (shift_m == 0.0), rep


@pytest.mark.parametrize("share_off", [0.0, 0.02],
                         ids=["identical", "two_percent_off_by_3"])
def test_golden_tolerance(share_off):
    from atm_raytracer_tpu.render.image import load_png_rgb

    golden = load_png_rgb(REPO / "tests" / "goldens" / "fast_plain.png")
    img = golden.astype(np.int16).reshape(-1, 3)
    n_off = int(round(share_off * img.shape[0]))
    idx = np.random.default_rng(0).permutation(img.shape[0])[:n_off]
    img[idx, 0] = np.where(img[idx, 0] > 252, img[idx, 0] - 3,
                           img[idx, 0] + 3)
    ok, frac_any, frac_big, worst = chip_smoke.golden_diff(
        golden, img.reshape(golden.shape).astype(np.uint8))
    assert ok is (share_off == 0.0)
    assert frac_big == frac_any == n_off / img.shape[0]
    assert worst == (3 if n_off else 0)
