"""End-to-end Fast-generator renders on synthetic terrain.

Oracles (SURVEY §4): horizon structure on a sphere vs flat Earth, sky/terrain
split, metadata round-trip, CLI drive.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from fixtures import make_terrain_folder

REPO = Path(__file__).resolve().parent.parent


def _write_config(tmp_path, terrain_folder, **over):
    cfg = {
        "scene": {"terrain_folder": str(terrain_folder)},
        "view": {
            "position": {
                "latitude": 49.5,
                "longitude": 21.5,
                "altitude": {"Relative": 30.0},
            },
            "frame": {
                "direction": 45.0,
                "fov": 20.0,
                "max_distance": 30000.0,
                "tilt": 0.0,
            },
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 100.0,
        "output": {
            "width": 64,
            "height": 48,
            "file": str(tmp_path / "out.png"),
        },
    }
    cfg.update(over)
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return p


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("terrain")
    return make_terrain_folder(d, tiles=((49, 21),), n=361)


def _render(tmp_path, terrain_dir, **over):
    from atm_raytracer_tpu.config import parse_config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.terrain.store import Terrain

    cfg_path = _write_config(tmp_path, terrain_dir, **over)
    config = parse_config(cfg_path)
    terrain = Terrain.from_folder(terrain_dir)
    params = config.into_params(terrain)
    return config, params, render_fast(params, terrain)


@pytest.fixture(scope="module")
def default_render(tmp_path_factory, terrain_dir):
    """One shared default-config render (+ its Terrain): five tests use the
    identical render, and this is the most expensive operation in the file
    on the 1-core host."""
    from atm_raytracer_tpu.terrain.store import Terrain

    tmp = tmp_path_factory.mktemp("e2e_default")
    config, params, result = _render(tmp, terrain_dir)
    return config, params, result, Terrain.from_folder(terrain_dir)


def test_fast_render_shape_and_sky(default_render):
    config, params, result, _ = default_render
    assert result.image.shape == (48, 64, 3)
    # top rows look at the sky (no hits); bottom rows hit terrain
    assert not result.hits.valid[0].any()
    assert result.hits.valid[-1].all()
    # sky color = Improved palette sky (0.23, 0.41, 0.55) → u8 trunc
    np.testing.assert_array_equal(
        result.image[0, 0], np.trunc(np.array([0.23, 0.41, 0.55]) * 255)
    )
    # hit distances grow toward the horizon (higher rows → farther)
    valid_rows = np.where(result.hits.valid[:, 32, 0])[0]
    d = result.hits.distance[valid_rows, 32, 0]
    assert (np.diff(d) <= 0).mean() > 0.9  # row index grows downward


def test_flat_earth_sees_farther(tmp_path, terrain_dir, default_render):
    # On a flat Earth there is no geometric horizon: the terrain fills rows
    # that are sky on the sphere (the tool's raison d'être, README.md:9-12).
    _, _, sphere, _ = default_render
    _, _, flat = _render(tmp_path, terrain_dir, earth_shape="FlatDistorted")
    assert flat.hits.valid[..., 0].sum() >= sphere.hits.valid[..., 0].sum()
    # the horizon row (first valid from top, center column) is higher on flat
    def horizon_row(res):
        col = res.hits.valid[:, 32, 0]
        assert col.any(), "center column has no terrain hits"
        return int(np.argmax(col))
    assert horizon_row(flat) <= horizon_row(sphere)


def test_hit_elevation_matches_terrain(default_render):
    _, params, result, terrain = default_render
    hits = result.hits
    ys, xs = np.where(hits.valid[..., 0])
    lat0, lon0, _ = result.observer
    sel = slice(0, len(ys), max(1, len(ys) // 50))
    for y, x in zip(ys[sel], xs[sel]):
        lat = lat0 + float(hits.dlat[y, x, 0])
        lon = lon0 + float(hits.dlon[y, x, 0])
        expect = terrain.get_elev_or0(lat, lon)
        got = float(hits.elevation[y, x, 0])
        # hit elevation is lerped between 100 m march samples; the terrain
        # between samples is smooth → couple-meter tolerance
        assert got == pytest.approx(expect, abs=8.0), (y, x)


def test_straight_vs_refracted_horizon(tmp_path, terrain_dir, default_render):
    _, _, refr, _ = default_render
    _, _, straight = _render(tmp_path, terrain_dir, straight_rays=True)
    # refraction extends the horizon: at least as many terrain pixels
    assert refr.hits.valid[..., 0].sum() >= straight.hits.valid[..., 0].sum()


def test_metadata_roundtrip(tmp_path, default_render):
    from atm_raytracer_tpu.meta.serialize import load_metadata, save_metadata
    from atm_raytracer_tpu.meta.viewer import _render_from_metadata, pixel_info

    config, params, result, _ = default_render
    meta_path = tmp_path / "meta.npz"
    save_metadata(meta_path, config, result)
    config2, result2 = load_metadata(meta_path)
    # re-rendered image identical to the original composite
    img2 = _render_from_metadata(config2, result2)
    np.testing.assert_array_equal(img2, result.image)
    # pixel info text renders
    info = pixel_info(config2, result2, 32, 40)
    assert "distance" in info and "azimuth" in info


def test_cli_gen(tmp_path, terrain_dir):
    cfg_path = _write_config(tmp_path, terrain_dir)
    out_png = tmp_path / "out.png"
    meta = tmp_path / "m.npz"
    import os
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_backend_optimization_level=1"}
    r = subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu.cli", "gen",
         "-c", str(cfg_path), "--output-meta", str(meta)],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr + r.stdout
    assert out_png.exists()
    assert meta.exists()
    # view headless
    r2 = subprocess.run(
        [sys.executable, "-m", "atm_raytracer_tpu.cli", "view", str(meta),
         "--pixel", "32", "40", "--save-image", str(tmp_path / "re.png")],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600,
    )
    assert r2.returncode == 0, r2.stderr + r2.stdout
    assert "View direction" in r2.stdout
    assert (tmp_path / "re.png").exists()


@pytest.mark.parametrize(
    "shape",
    [
        "SimpleSphere",
        {"Spherical": {"radius": 6371000.0}},
        {"Ellipsoid": {"a": 6378137.0, "b": 6356752.3}},
        "Wgs84",
        "AzimuthalEquidistant",
        "FlatDistorted",
        {"ObserverAe": {"projection_radius": 6371000.0}},
        "SimpleObserverAe",
    ],
)
def test_all_earth_models_render(tmp_path, terrain_dir, shape):
    """Every earth_shape variant (utils/earth_model/mod.rs:19-28) renders a
    sane frame: sky above, terrain below, hits on terrain."""
    config, params, result = _render(
        tmp_path, terrain_dir, earth_shape=shape,
        view={
            "position": {"latitude": 49.5, "longitude": 21.5,
                         "altitude": {"Relative": 30.0}},
            "frame": {"direction": 45.0, "fov": 20.0,
                      "max_distance": 20000.0, "tilt": 0.0},
            "coloring": {"Shading": {"water_level": -100.0}},
        },
    )
    valid = np.asarray(result.hits.valid)
    assert valid.any(), f"{shape}: no terrain hits"
    assert not valid[0].all(), f"{shape}: top row should have sky"
    assert valid[-1].all(), f"{shape}: bottom row should hit terrain"


def test_translucent_terrain_multi_hit(tmp_path, terrain_dir):
    """terrain_alpha < 1 (README.md:124-127): trace points keep multiple
    crossings and the compositor blends them toward the sky."""
    _, _, opaque = _render(tmp_path, terrain_dir)
    _, _, trans = _render(
        tmp_path, terrain_dir, scene={
            "terrain_folder": str(terrain_dir), "terrain_alpha": 0.3,
        },
    )
    v = np.asarray(trans.hits.valid)
    assert v.shape[-1] > 1, "translucent terrain should keep K > 1 hit slots"
    assert (v.sum(-1) > 1).any(), "some pixels should record several crossings"
    # ground pixels become a blend with sky -> strictly bluer than opaque
    img_o = np.asarray(opaque.image, int)
    img_t = np.asarray(trans.image, int)
    bottom_o = img_o[-10:].mean((0, 1))
    bottom_t = img_t[-10:].mean((0, 1))
    assert bottom_t[2] > bottom_o[2] + 10, "terrain should blend toward sky blue"


def test_progress_percent_lines(tmp_path, terrain_dir):
    """Per-percent progress during the march (fast.rs:78-87)."""
    from atm_raytracer_tpu.config import parse_config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.terrain.store import Terrain

    cfg_path = _write_config(tmp_path, terrain_dir)
    config = parse_config(cfg_path)
    terrain = Terrain.from_folder(terrain_dir)
    params = config.into_params(terrain)
    seen = []
    render_fast(params, terrain, progress=seen.append)
    assert seen, "no progress reported"
    assert max(seen) == 100
    assert all(0 <= p <= 100 for p in seen)
    # straight-ray mode has no march scan; still closes with 100
    import dataclasses
    params2 = dataclasses.replace(params, straight_rays=True)
    seen2 = []
    render_fast(params2, terrain, progress=seen2.append)
    assert seen2 and seen2[-1] == 100


def test_spherical_refracted_pipeline_matches_f64_oracle():
    """Absolute oracle for the HEADLINE physics: spherical Earth, US-76
    refraction. Re-derives the full pipeline in independent pure-numpy f64
    (fixtures.f64_sphere_refracted_oracle: f64 RK4 of the Fermat ODE with
    the exact atmosphere, navigation-formula great circles, bilinear
    sampling, crossing + lerp) and compares hits. Measured: 4 mm max
    distance error, 0.07 mm elevation, 100% hit agreement."""
    from fixtures import f64_sphere_refracted_oracle, tile_grid
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.terrain.store import Terrain, Tile
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.models import camera

    n = 241
    terrain = Terrain()
    terrain.add_tile(Tile(lat0=49, lon0=21, elev=tile_grid(49, 21, n)))
    cfg = Config.from_dict({
        "earth_shape": "SimpleSphere",
        "straight_rays": False,
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 50.0}},
                 "frame": {"direction": 70.0, "fov": 8.0,
                           "max_distance": 25000.0}},
        "simulation_step": 50.0,
        "output": {"width": 24, "height": 16},
    })
    params = cfg.into_params(terrain)
    res = render_fast(params, terrain)

    el = np.deg2rad(np.asarray(
        camera.fast_ray_elevations(24, 16, 8.0, 0.0), np.float64))
    az = np.deg2rad(np.asarray(
        camera.fast_ray_azimuths(24, 16, 8.0, 70.0), np.float64))
    has, dist, elev_hit, robust = f64_sphere_refracted_oracle(
        tile_grid(49, 21, n).astype(np.float64), 49.5, 21.5, 50.0,
        el, az, 50.0, 25000.0, params.atmosphere, params.wavelength,
        6371000.0)

    pv = np.asarray(res.hits.valid[..., 0])
    assert pv.sum() > 100
    assert (pv == has).mean() > 0.99
    robust &= pv
    assert robust.sum() > 100
    pd = np.asarray(res.hits.distance[..., 0])
    pe = np.asarray(res.hits.elevation[..., 0])
    assert np.abs(pd - dist)[robust].max() < 0.05
    assert np.abs(pe - elev_hit)[robust].max() < 0.005


def test_full_pipeline_matches_independent_f64_oracle():
    """Absolute end-to-end oracle: re-derive the whole Fast pipeline in
    independent pure-numpy f64 (fixtures.f64_flat_straight_oracle) and
    compare hits. The cross-generator tests catch relative drift; this
    pins the pipeline to first principles."""
    from fixtures import f64_flat_straight_oracle, tile_grid
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.terrain.store import Terrain, Tile
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.models import camera

    n = 241
    terrain = Terrain()
    terrain.add_tile(Tile(lat0=49, lon0=21, elev=tile_grid(49, 21, n)))
    cfg = Config.from_dict({
        "earth_shape": "FlatDistorted",
        "straight_rays": True,
        "view": {"position": {"latitude": 49.5, "longitude": 21.5,
                              "altitude": {"Relative": 30.0}},
                 "frame": {"direction": 70.0, "fov": 8.0,
                           "max_distance": 8000.0}},
        "simulation_step": 50.0,
        "output": {"width": 24, "height": 16},
    })
    res = render_fast(cfg.into_params(terrain), terrain)

    el = np.deg2rad(np.asarray(
        camera.fast_ray_elevations(24, 16, 8.0, 0.0), np.float64))
    az = np.deg2rad(np.asarray(
        camera.fast_ray_azimuths(24, 16, 8.0, 70.0), np.float64))
    has, dist, elev_hit, robust = f64_flat_straight_oracle(
        tile_grid(49, 21, n).astype(np.float64), 49.5, 21.5, 30.0,
        np.broadcast_to(el[:, None], (16, 24)),
        np.broadcast_to(az[None, :], (16, 24)),
        50.0, 8000.0,
    )
    pv = np.asarray(res.hits.valid[..., 0])
    assert pv.sum() > 100  # the scene is mostly terrain
    # knife-edge pixels (f32 vs f64 sign at a grazing crossing) may differ
    assert (pv == has).mean() > 0.99
    robust &= pv
    assert robust.sum() > 100
    pd = np.asarray(res.hits.distance[..., 0])
    pe = np.asarray(res.hits.elevation[..., 0])
    assert np.abs(pd - dist)[robust].max() < 0.05  # meters (measured 7 mm)
    assert np.abs(pe - elev_hit)[robust].max() < 0.01


def test_streamed_matches_plain(default_render, terrain_dir, tmp_path):
    """render_fast_streamed (banded dispatch + overlapped fetch) must render
    the exact frame of render_fast: banding along azimuth columns touches no
    numerics — the march is shared, columns are independent (fast.rs:27-44).
    """
    from atm_raytracer_tpu.generators.fast import render_fast_streamed

    config, params, plain, terrain = default_render
    pcts = []
    streamed = render_fast_streamed(
        params, terrain, bands=8, progress=pcts.append
    )
    np.testing.assert_array_equal(streamed.image, plain.image)
    for field in ("valid", "key", "distance", "elevation", "path_length",
                  "normal", "kind", "rgba", "dlat", "dlon"):
        np.testing.assert_array_equal(
            np.asarray(getattr(streamed.hits, field)),
            np.asarray(getattr(plain.hits, field)),
            err_msg=field,
        )
    # monotone per-band percent, closing at 100 (fast.rs:78-87 analog)
    assert pcts == sorted(pcts) and pcts[-1] == 100 and len(pcts) == 8


def test_streamed_band_fallbacks(default_render):
    """Odd widths pick the largest dividing band count; bands=1 still works."""
    from atm_raytracer_tpu.generators.fast import _largest_band_divisor

    assert _largest_band_divisor(1920, 8) == 8
    assert _largest_band_divisor(61, 8) == 1  # prime width: single band
    assert _largest_band_divisor(60, 8) == 6


def test_metadata_v2_fields_exact(tmp_path, default_render):
    """Format v2 (valid-slot compaction, meta/serialize.py) must reproduce
    every hit field EXACTLY on valid slots and canonical fillers elsewhere
    (key=+inf NO_HIT, 0 otherwise) — renders leave garbage-but-masked values
    in invalid slots, so only the valid entries are contractual."""
    import io

    from atm_raytracer_tpu.meta.serialize import load_metadata, save_metadata
    from atm_raytracer_tpu.ops.combine import NO_HIT

    config, params, result, _ = default_render
    meta_path = tmp_path / "meta_v2.npz"
    save_metadata(meta_path, config, result)
    _, r2 = load_metadata(meta_path)

    valid = np.asarray(result.hits.valid)
    np.testing.assert_array_equal(np.asarray(r2.hits.valid), valid)
    for field in ("key", "dlat", "dlon", "distance", "elevation",
                  "path_length", "kind"):
        orig = np.asarray(getattr(result.hits, field))
        got = np.asarray(getattr(r2.hits, field))
        np.testing.assert_array_equal(got[valid], orig[valid], err_msg=field)
    for field, d in (("normal", 3), ("rgba", 4)):
        orig = np.asarray(getattr(result.hits, field))
        got = np.asarray(getattr(r2.hits, field))
        np.testing.assert_array_equal(got[valid], orig[valid], err_msg=field)
        assert (got[~valid] == 0).all(), field
    assert np.isposinf(np.asarray(r2.hits.key)[~valid]).all()
    assert float(NO_HIT) == np.float32("inf")
    assert (np.asarray(r2.hits.distance)[~valid] == 0).all()


def test_metadata_v1_reader(tmp_path, default_render):
    """v1 artifacts (dense [H, W, K] planes) must stay readable after the
    v2 writer switch — users hold files written by earlier builds."""
    from atm_raytracer_tpu.meta.serialize import load_metadata, save_metadata
    from atm_raytracer_tpu.meta.viewer import _render_from_metadata

    config, params, result, _ = default_render
    hits = result.hits
    v1 = {
        n: np.asarray(getattr(hits, n))
        for n in ("valid", "key", "dlat", "dlon", "distance", "elevation",
                  "path_length", "normal", "kind", "rgba")
    }
    import yaml as _yaml

    path = tmp_path / "meta_v1.npz"
    np.savez_compressed(
        path,
        format_version=np.int64(1),
        config_yaml=np.frombuffer(
            _yaml.safe_dump(config.to_dict()).encode(), np.uint8
        ),
        observer=np.asarray(result.observer, np.float64),
        elevation_deg=np.asarray(result.elevation_deg, np.float64),
        azimuth_deg=np.asarray(result.azimuth_deg, np.float64),
        **v1,
    )
    config1, r1 = load_metadata(path)
    img = _render_from_metadata(config1, r1)
    np.testing.assert_array_equal(img, result.image)
