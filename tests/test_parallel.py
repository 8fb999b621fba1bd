"""Multi-chip sharding on the virtual 8-device CPU mesh.

Correctness bar: the sharded render is bit-identical to the single-chip one
(pure data parallelism, no cross-shard communication — SURVEY §5).
"""

import numpy as np
import pytest

from fixtures import make_terrain_folder


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.terrain.store import Terrain

    d = tmp_path_factory.mktemp("terrain_par")
    make_terrain_folder(d, tiles=((49, 21),), n=241)
    config = Config.from_dict(
        {
            "view": {
                "position": {
                    "latitude": 49.5,
                    "longitude": 21.5,
                    "altitude": {"Relative": 25.0},
                },
                "frame": {"direction": 30.0, "fov": 18.0, "max_distance": 8000.0},
            },
            "simulation_step": 100.0,
            "output": {"width": 72, "height": 40},  # W=72 not divisible by 8
        }
    )
    terrain = Terrain.from_folder(d)
    return config, terrain, config.into_params(terrain)


def test_sharded_matches_single_chip(setup):
    import jax

    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_fast_sharded

    config, terrain, params = setup
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    single = render_fast(params, terrain)
    mesh = make_mesh()
    sharded = render_fast_sharded(params, terrain, mesh)
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(sharded.hits.valid, single.hits.valid)
    np.testing.assert_allclose(
        sharded.hits.distance, single.hits.distance, atol=1e-3
    )


def test_sweep_frames_match_individual_renders(setup):
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    mesh = make_mesh()
    dirs = [0.0, 45.0, 90.0, 135.0, 180.0]  # 5 frames on 8 devices (padded)
    frames = render_sweep_sharded(params, terrain, mesh, dirs)
    assert frames.shape == (5, 40, 72, 3)
    # frame 1 must equal a fresh single render pointed at 45° (built from a
    # COPY — mutating the module-scoped fixture would rotate the camera for
    # every later test in this file)
    from atm_raytracer_tpu.config import Config

    d45 = config.to_dict()
    d45["view"]["frame"]["direction"] = 45.0
    params45 = Config.from_dict(d45).into_params(terrain)
    single = render_fast(params45, terrain)
    np.testing.assert_array_equal(frames[1], single.image)


def test_graft_entry_contract():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (48, 64, 3)
    g.dryrun_multichip(8)


def test_graft_entry_multichip_from_single_device_env(tmp_path):
    """dryrun_multichip(8) called in a process with ONE device must
    self-provision a virtual 8-CPU mesh via subprocess, not assert
    'need 8 devices, have 1'."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""  # one CPU device
    env.pop("_ATM_MULTICHIP_CHILD", None)
    proc = subprocess.run(
        [sys.executable, str(repo / "__graft_entry__.py"), "multichip", "8"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multichip OK on 8 devices" in proc.stdout


def test_sweep_with_per_frame_atmospheres(setup):
    """Refraction-profile parameter sweep (BASELINE configs[4]): per-frame
    atmospheres batch into one launch; a strong-inversion profile must bend
    rays down more than a convective one and match a single render."""
    import dataclasses

    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded
    from atm_raytracer_tpu.physics.atmosphere import (
        Atmosphere,
        AtmosphereDef,
        LinearFunction,
        us_76,
    )

    config, terrain, params = setup
    mesh = make_mesh()
    strong = AtmosphereDef(
        first_temperature_function=LinearFunction(0.02),  # inversion: bends down
        temperature_fixed_point=(0.0, 283.15),
    )
    weak = AtmosphereDef(
        first_temperature_function=LinearFunction(-0.03),  # convective
        temperature_fixed_point=(0.0, 293.15),
    )
    d0 = float(params.view.frame.direction)
    dirs = [d0, d0]
    frames = render_sweep_sharded(
        params, terrain, mesh, directions_deg=dirs,
        atmospheres=[strong, weak],
    )
    assert frames.shape[0] == 2
    assert (frames[0] != frames[1]).any(), "different profiles must differ"

    single = render_fast(
        dataclasses.replace(params, atmosphere=Atmosphere(strong)), terrain
    )
    # same atmosphere -> same frame, modulo the sweep's table-gather vs
    # poly-eval l(h) path (sub-millimeter ray differences can flip a pixel
    # at terrain grazing)
    diff = np.abs(frames[0].astype(int) - single.image.astype(int)).max(-1)
    assert (diff > 8).mean() < 0.01


def test_sweep_with_per_frame_altitudes(setup):
    """Per-frame observer altitude (drone ascent sweep): an elevated frame
    must equal a fresh single render at that absolute altitude (the shared
    refraction table is built at the sweep's max altitude and covers every
    frame's march identically)."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    d0 = float(params.view.frame.direction)
    alt0 = params.view.position.abs_altitude(terrain)
    frames = render_sweep_sharded(
        params, terrain, make_mesh(),
        directions_deg=[d0, d0],
        altitudes_m=[alt0, alt0 + 90.0],
    )
    assert (frames[0] != frames[1]).any(), "elevated frame must differ"
    d = config.to_dict()
    d["view"]["frame"]["direction"] = d0
    d["view"]["position"]["altitude"] = {"Absolute": float(alt0 + 90.0)}
    single = render_fast(Config.from_dict(d).into_params(terrain), terrain)
    np.testing.assert_array_equal(frames[1], single.image)


def test_sweep_with_per_frame_tilts(setup):
    """Per-frame camera tilt batches the [F, H] elevation grid with the
    frames; a tilted sweep frame must equal a fresh single render at that
    tilt (drone-style sweep: direction AND tilt vary per frame)."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    mesh = make_mesh()
    d0 = float(params.view.frame.direction)
    frames = render_sweep_sharded(
        params, terrain, mesh,
        directions_deg=[d0, d0, d0 + 90.0],
        tilts_deg=[0.0, 6.0, -4.0],
    )
    assert frames.shape[0] == 3
    assert (frames[0] != frames[1]).any(), "tilted frame must differ"

    d = config.to_dict()
    d["view"]["frame"]["direction"] = d0
    d["view"]["frame"]["tilt"] = 6.0
    single = render_fast(Config.from_dict(d).into_params(terrain), terrain)
    np.testing.assert_array_equal(frames[1], single.image)


def test_sweep_with_per_frame_fovs(setup):
    """Zoom sweep: per-frame fov re-fans both grids; a zoomed frame must
    equal a fresh single render at that fov."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    d0 = float(params.view.frame.direction)
    frames = render_sweep_sharded(
        params, terrain, make_mesh(),
        directions_deg=[d0, d0],
        fovs_deg=[18.0, 7.0],
    )
    assert (frames[0] != frames[1]).any(), "zoomed frame must differ"
    d = config.to_dict()
    d["view"]["frame"]["direction"] = d0
    d["view"]["frame"]["fov"] = 7.0
    single = render_fast(Config.from_dict(d).into_params(terrain), terrain)
    np.testing.assert_array_equal(frames[1], single.image)


def test_rectilinear_sharded_matches_single_chip(setup):
    """Row-sharded fused Rectilinear is bit-identical to single-chip."""
    from atm_raytracer_tpu.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu.parallel.mesh import (
        make_mesh,
        render_rectilinear_sharded,
    )

    config, terrain, params = setup  # H=40 = 8 devices x 5 rows
    single = render_rectilinear(params, terrain)
    sharded = render_rectilinear_sharded(params, terrain, make_mesh())
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.valid), np.asarray(single.hits.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.key), np.asarray(single.hits.key)
    )


def test_sharded_production_shape(setup):
    """1920×1080 over the 8-device mesh: realistic aspect ratio, 1080 rows
    (135/device), 1920 columns (240/device) — the shapes the driver's tiny
    dryrun can't see (VERDICT r2 weak #7). Short march keeps CPU cost sane;
    the sharding math (padding, shard extents, output gather) is identical
    at any march length."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_fast_sharded

    config, terrain, _ = setup
    d = config.to_dict()
    d["output"]["width"] = 1920
    d["output"]["height"] = 1080
    d["view"]["frame"]["fov"] = 40.0
    d["view"]["frame"]["max_distance"] = 3000.0
    params = Config.from_dict(d).into_params(terrain)
    single = render_fast(params, terrain)
    sharded = render_fast_sharded(params, terrain, make_mesh())
    assert sharded.image.shape == (1080, 1920, 3)
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(sharded.hits.valid, single.hits.valid)


def test_rectilinear_sharded_rows_not_divisible(setup):
    """Row-sharded Rectilinear with 1077 rows (not divisible by 8)."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu.parallel.mesh import (
        make_mesh, render_rectilinear_sharded,
    )

    config, terrain, _ = setup
    d = config.to_dict()
    d["output"]["width"] = 320
    d["output"]["height"] = 1077
    d["view"]["frame"]["fov"] = 30.0
    d["view"]["frame"]["max_distance"] = 3000.0
    params = Config.from_dict(d).into_params(terrain)
    single = render_rectilinear(params, terrain)
    sharded = render_rectilinear_sharded(params, terrain, make_mesh())
    assert sharded.image.shape == (1077, 320, 3)
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(sharded.hits.valid, single.hits.valid)


def test_tilted_object_sharded_matches_single_chip(setup):
    """Tilted + object + translucent Rectilinear over the mesh: the dense
    exact per-pixel program shards on the flattened pixel axis (no scene
    type is excluded from multi-chip). Single-chip render_rectilinear
    dispatches the same dense program for this config → bit-identical."""
    import numpy as np_
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators.rectilinear import render_rectilinear
    from atm_raytracer_tpu.parallel.mesh import (
        make_mesh, render_rectilinear_sharded,
    )

    config, terrain, _ = setup
    d = config.to_dict()
    d["output"]["width"] = 36  # P = 36*24 = 864 (not divisible by 8 rows)
    d["output"]["height"] = 24
    d["view"]["frame"]["tilt"] = 4.0
    d["view"]["frame"]["max_distance"] = 4000.0
    from fixtures import M_PER_DEG as m_per_deg
    d["scene"] = {"terrain_alpha": 0.85, "objects": [{
        "position": {
            "latitude": 49.5 + 700.0 / m_per_deg * np_.cos(np_.deg2rad(30.0)),
            "longitude": 21.5 + 700.0 / m_per_deg * np_.sin(np_.deg2rad(30.0))
            / np_.cos(np_.deg2rad(49.5)),
            "altitude": {"Relative": 0.0},
        },
        "color": {"r": 0.9, "g": 0.3, "b": 0.1, "a": 1.0},
        "shape": {"Cylinder": {"radius": 30.0, "height": 200.0}},
    }]}
    params = Config.from_dict(d).into_params(terrain)
    single = render_rectilinear(params, terrain)
    sharded = render_rectilinear_sharded(params, terrain, make_mesh())
    assert sharded.image.shape == (24, 36, 3)
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.valid), np.asarray(single.hits.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.key), np.asarray(single.hits.key)
    )
    kind = np.asarray(sharded.hits.kind)[np.asarray(sharded.hits.valid)]
    assert (kind == 1).any(), "no object hits in tilted sharded render"


def test_interpolating_sharded_matches_single_chip(setup):
    """Column-sharded snapped grid + row-sharded interpolation must be
    bit-identical to the single-chip Interpolating render (the padded grid
    columns are never referenced by any output pixel)."""
    from atm_raytracer_tpu.generators.interpolating import render_interpolating
    from atm_raytracer_tpu.parallel.mesh import (
        make_mesh, render_interpolating_sharded,
    )

    config, terrain, params = setup
    single = render_interpolating(params, terrain)
    sharded = render_interpolating_sharded(params, terrain, make_mesh())
    np.testing.assert_array_equal(sharded.image, single.image)
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.valid), np.asarray(single.hits.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.key), np.asarray(single.hits.key)
    )


def test_cli_shard_flag_matches_single_chip(setup, tmp_path):
    """`gen --shard` renders over all visible devices and produces the
    exact PNG of the single-chip run (CLI extension over the reference's
    single-node rayon surface)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    config, terrain, _ = setup
    d = config.to_dict()
    # the CLI resolves terrain_folder relative to cwd=tmp_path
    tdir = tmp_path / "terrain"
    tdir.mkdir()
    make_terrain_folder(tdir, tiles=((49, 21),), n=241)
    d.setdefault("scene", {})["terrain_folder"] = str(tdir)
    d.setdefault("output", {})["file"] = "single.png"
    import yaml

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(d))
    env = {**os.environ, "PYTHONPATH": str(repo), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                        "--xla_backend_optimization_level=1"}
    from PIL import Image

    for gen in ("Fast", "Rectilinear", "InterpolatingRectilinear"):
        # metadata parity is generator-independent plumbing; exercise it on
        # the Fast pair only to keep the 1-core suite wall bounded
        meta = ["--output-meta", f"meta_{gen}.npz"] if gen == "Fast" else []
        r1 = subprocess.run(
            [sys.executable, "-m", "atm_raytracer_tpu.cli", "gen",
             "-c", str(cfg), "--generator", gen,
             "--output", f"single_{gen}.png"] + meta,
            capture_output=True, text=True, cwd=tmp_path, env=env,
            timeout=600,
        )
        assert r1.returncode == 0, r1.stderr + r1.stdout
        meta_sh = (
            ["--output-meta", f"meta_{gen}_sharded.npz"] if meta else []
        )
        r2 = subprocess.run(
            [sys.executable, "-m", "atm_raytracer_tpu.cli", "gen",
             "-c", str(cfg), "--generator", gen,
             "--output", f"sharded_{gen}.png", "--shard"] + meta_sh,
            capture_output=True, text=True, cwd=tmp_path, env=env,
            timeout=600,
        )
        assert r2.returncode == 0, r2.stderr + r2.stdout
        assert "Sharding over 8 devices" in r2.stdout
        single = np.asarray(Image.open(tmp_path / f"single_{gen}.png"))
        sharded = np.asarray(Image.open(tmp_path / f"sharded_{gen}.png"))
        np.testing.assert_array_equal(sharded, single, err_msg=gen)
        if meta:
            from atm_raytracer_tpu.meta.serialize import load_metadata

            _, m1 = load_metadata(tmp_path / f"meta_{gen}.npz")
            _, m2 = load_metadata(tmp_path / f"meta_{gen}_sharded.npz")
            np.testing.assert_array_equal(m2.hits.valid, m1.hits.valid)
            np.testing.assert_array_equal(m2.hits.key, m1.hits.key)
            np.testing.assert_array_equal(m2.hits.rgba, m1.hits.rgba)
            np.testing.assert_array_equal(
                m2.elevation_deg, m1.elevation_deg
            )


def test_sharded_objects_match_single_chip(setup):
    """Column-sharded Fast WITH scene objects: the per-object column windows
    are static host tuples consumed inside the jitted core, so XLA SPMD
    partitions the merge cleanly — bit-identical to single-chip."""
    import numpy as np_
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_fast_sharded

    config, terrain, _ = setup
    d = config.to_dict()
    from fixtures import M_PER_DEG as m_per_deg
    d["scene"] = {"terrain_alpha": 0.8, "objects": [{
        "position": {
            "latitude": 49.5 + 900.0 / m_per_deg * np_.cos(np_.deg2rad(30.0)),
            "longitude": 21.5 + 900.0 / m_per_deg * np_.sin(np_.deg2rad(30.0))
            / np_.cos(np_.deg2rad(49.5)),
            "altitude": {"Relative": 0.0},
        },
        "color": {"r": 1.0, "g": 0.2, "b": 0.1, "a": 0.9},
        "shape": {"Cylinder": {"radius": 25.0, "height": 150.0}},
    }]}
    params = Config.from_dict(d).into_params(terrain)
    single = render_fast(params, terrain)
    sharded = render_fast_sharded(params, terrain, make_mesh())
    np.testing.assert_array_equal(
        np.asarray(sharded.image), np.asarray(single.image)
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.hits.valid), np.asarray(single.hits.valid)
    )
    kind = np.asarray(sharded.hits.kind)[np.asarray(sharded.hits.valid)]
    assert (kind == 1).any(), "no object hits in sharded render"


def test_sweep_return_hits_matches_single_render(setup):
    """return_hits=True yields per-frame HitBuffers bit-identical to a
    fresh single render of that frame (metadata workflows over sweeps)."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    mesh = make_mesh()
    dirs = [0.0, 90.0]
    frames, hits = render_sweep_sharded(
        params, terrain, mesh, dirs, return_hits=True
    )
    assert frames.shape == (2, 40, 72, 3)
    d90 = config.to_dict()
    d90["view"]["frame"]["direction"] = 90.0
    single = render_fast(Config.from_dict(d90).into_params(terrain), terrain)
    np.testing.assert_array_equal(frames[1], single.image)
    np.testing.assert_array_equal(
        np.asarray(hits.valid)[1], np.asarray(single.hits.valid)
    )
    np.testing.assert_array_equal(
        np.asarray(hits.distance)[1], np.asarray(single.hits.distance)
    )
    np.testing.assert_array_equal(
        np.asarray(hits.elevation)[1], np.asarray(single.hits.elevation)
    )


def test_sweep_valid_mode_and_compact_staging(setup):
    """return_hits="valid" + fetch_frames=False: the hit masks match the
    full-hits path, device-resident frames match the fetched ones, and the
    vmapped compact-frame pack reconstructs every frame bit-exactly (the
    sweep bench staging path)."""
    import jax
    import jax.numpy as jnp

    from atm_raytracer_tpu.meta.pack import (
        frame_base_rgb, pack_frame_compact, unpack_frame_compact,
    )
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    config, terrain, params = setup
    mesh = make_mesh()
    dirs = [0.0, 90.0]
    frames_h, hits = render_sweep_sharded(
        params, terrain, mesh, dirs, return_hits=True
    )
    frames_d, valid = render_sweep_sharded(
        params, terrain, mesh, dirs, return_hits="valid",
        fetch_frames=False,
    )
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(hits.valid))
    np.testing.assert_array_equal(np.asarray(frames_d), frames_h)

    bits, img_n, img_ei, img_ev, counts = jax.jit(
        jax.vmap(pack_frame_compact)
    )(jnp.asarray(valid), jnp.asarray(frames_d))
    sky = frame_base_rgb(params.coloring, params.view.fog_distance)
    words = np.asarray(bits)
    cts = np.asarray(counts)
    h, w = frames_h.shape[1], frames_h.shape[2]
    for f in range(len(dirs)):
        n = int(cts[f, 0])
        frame = unpack_frame_compact(
            words[f],
            [(np.asarray(img_n[f, c, :(n + 1) // 2]),
              np.asarray(img_ei[f, c, :cts[f, 1 + c]]),
              np.asarray(img_ev[f, c, :cts[f, 1 + c]]))
             for c in range(3)],
            sky, h, w, n,
        )
        np.testing.assert_array_equal(frame, frames_h[f])
