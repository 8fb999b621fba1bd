"""Golden-image regression suite (SURVEY §4).

The reference's de-facto validation is visual — rendered panoramas compared
against photographs (/root/reference/README.md:9-12). This rebuild replaces
that workflow with committed goldens: small CPU-rendered frames for all three
generators across four scene flavors, plus one annotated frame, compared
BIT-EXACT. This is the guard against all numeric paths drifting together —
the cross-generator parity tests compare paths against *each other* and
cannot see a collective drift.

Regeneration procedure (after an INTENDED output change):

    ATM_RAYTRACER_GOLDEN_REGEN=1 python -m pytest tests/test_golden.py -q

then inspect the changed PNGs under tests/goldens/ (git diff --stat plus a
visual look) and commit them together with the change that moved the output.
Goldens are rendered on the CPU backend (conftest forces it) so the suite is
deterministic for this environment; a backend/XLA upgrade that moves f32
codegen is expected to show up here and should be re-pinned consciously.
``chip_smoke.py`` compares the same scenes rendered on a GPU with these
goldens within a tolerance.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from fixtures import M_PER_DEG, make_terrain_folder

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
REGEN = bool(os.environ.get("ATM_RAYTRACER_GOLDEN_REGEN"))

LAT0, LON0 = 49.5, 21.5


def _object(dist_m, az_deg, shape, color, alt=("Relative", 0.0)):
    az = np.radians(az_deg)
    return {
        "position": {
            "latitude": LAT0 + dist_m * float(np.cos(az)) / M_PER_DEG,
            "longitude": LON0 + dist_m * float(np.sin(az)) / M_PER_DEG
            / float(np.cos(np.radians(LAT0))),
            "altitude": {alt[0]: alt[1]},
        },
        "color": color,
        "shape": shape,
    }


def _base_config(**over):
    cfg = {
        "scene": {"terrain_folder": "<set by fixture>"},
        "view": {
            "position": {
                "latitude": LAT0,
                "longitude": LON0,
                "altitude": {"Relative": 30.0},
            },
            "frame": {
                "direction": 45.0,
                "fov": 25.0,
                "max_distance": 25000.0,
                "tilt": 0.0,
            },
            "coloring": {"Shading": {"water_level": -100.0}},
        },
        "straight_rays": False,
        "simulation_step": 100.0,
        "output": {"width": 64, "height": 48, "file": "out.png"},
    }
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(cfg.get(key), dict):
            cfg[key].update(val)
        else:
            cfg[key] = val
    return cfg


# scene flavor -> config-dict overrides (applied over _base_config)
SCENES = {
    "plain": {},
    "objects": {
        "view": {
            "frame": {"direction": 0.0, "fov": 30.0, "max_distance": 8000.0},
        },
        "simulation_step": 50.0,
        "scene": {
            "objects": [
                _object(700.0, -4.0,
                        {"Cylinder": {"radius": 25.0, "height": 200.0}},
                        {"r": 0.1, "g": 0.2, "b": 0.9, "a": 0.6}),
                _object(1200.0, 3.0,
                        {"Cylinder": {"radius": 30.0, "height": 150.0}},
                        {"r": 0.9, "g": 0.1, "b": 0.1}),
                _object(2000.0, -1.0,
                        {"Cone": {"radius": 40.0, "height": 120.0}},
                        {"r": 0.1, "g": 0.8, "b": 0.2}),
            ],
        },
    },
    "translucent": {
        "scene": {"terrain_alpha": 0.65},
        "view": {"fog_distance": 15000.0},
    },
    "flat_straight": {
        "earth_shape": "FlatDistorted",
        "straight_rays": True,
        "view": {"coloring": {"Simple": {"water_level": -100.0}}},
    },
}

GENERATORS = ("Fast", "Rectilinear", "InterpolatingRectilinear")


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("terrain_golden")
    return make_terrain_folder(d, tiles=((49, 21),), n=181)


@pytest.fixture(scope="module")
def terrain(terrain_dir):
    from atm_raytracer_tpu.terrain.store import Terrain

    return Terrain.from_folder(terrain_dir)


def _render(generator, scene, terrain_dir, terrain):
    from atm_raytracer_tpu.config import Config

    cfg = _base_config(**SCENES[scene])
    cfg["scene"]["terrain_folder"] = str(terrain_dir)
    cfg["output"]["generator"] = generator
    params = Config.from_dict(cfg).into_params(terrain)

    if generator == "Fast":
        from atm_raytracer_tpu.generators import render_fast as render
    elif generator == "Rectilinear":
        from atm_raytracer_tpu.generators.rectilinear import (
            render_rectilinear as render,
        )
    else:
        from atm_raytracer_tpu.generators.interpolating import (
            render_interpolating as render,
        )
    return params, render(params, terrain)


def _check_golden(name, image_u8):
    """Compare against (or regenerate) tests/goldens/<name>.png bit-exact."""
    from PIL import Image

    image_u8 = np.asarray(image_u8, np.uint8)
    path = GOLDEN_DIR / f"{name}.png"
    if REGEN:
        GOLDEN_DIR.mkdir(exist_ok=True)
        Image.fromarray(image_u8, "RGB").save(path)
        pytest.skip(f"regenerated {path.name}")
    if not path.exists():
        pytest.fail(
            f"missing golden {path}; generate with "
            "ATM_RAYTRACER_GOLDEN_REGEN=1 python -m pytest tests/test_golden.py"
        )
    golden = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    if golden.shape != image_u8.shape or not np.array_equal(golden, image_u8):
        diff = (golden.astype(np.int16) - image_u8.astype(np.int16))
        npx = int((np.abs(diff).max(axis=-1) > 0).sum())
        pytest.fail(
            f"{path.name}: render drifted from golden — {npx} pixels differ "
            f"(max channel delta {np.abs(diff).max()}). If the change is "
            "intended, regenerate (see module docstring)."
        )


@pytest.mark.parametrize("generator", GENERATORS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_golden(generator, scene, terrain_dir, terrain):
    _, result = _render(generator, scene, terrain_dir, terrain)
    _check_golden(f"{generator.lower()}_{scene}", result.image)


def annotated_config(terrain_folder: str) -> dict:
    """The annotated golden frame: ticks + eye level + labels."""
    cfg = _base_config()
    cfg["scene"]["terrain_folder"] = terrain_folder
    cfg["output"].update({
        "width": 160, "height": 100,
        "ticks": [
            {"Multiple": {"bias": 0.0, "step": 10.0, "size": 10,
                          "labelled": True}},
            {"Multiple": {"bias": 0.0, "step": 2.0, "size": 5,
                          "labelled": False}},
        ],
        "vertical_ticks": [
            {"Multiple": {"bias": 0.0, "step": 2.0, "size": 10,
                          "labelled": True}},
        ],
        "show_eye_level": True,
    })
    return cfg


def test_golden_annotated(terrain_dir, terrain):
    """One annotated frame: ticks + eye-level + labels (renderer/mod.rs:39-365)."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.render.annotate import annotate_image

    params = Config.from_dict(
        annotated_config(str(terrain_dir))).into_params(terrain)

    from atm_raytracer_tpu.generators import render_fast

    result = render_fast(params, terrain)
    img = annotate_image(
        result.image, params, result.elevation_deg, result.azimuth_deg,
        result.observer[2],
    )
    _check_golden("fast_plain_annotated", img)
