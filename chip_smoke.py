#!/usr/bin/env python3
"""End-to-end check of the renderer on one GPU.

Drives the main path of ``gen`` through ``atm_raytracer_tpu.cli.main`` in
this one process (a second JAX process could not get the card's memory),
then checks what it produced. Phases, each printing its wall time:

1. device gate: JAX must see a GPU, or the script exits non-zero before
   anything renders;
2. headline ``gen``: 1920x1080, 200 km at 50 m steps, spherical Earth,
   US-76, refracted rays, on a synthetic 3" DTED mosaic of 1201-post tiles
   (+-2 deg x +-3 deg around 49.5 N 21.5 E); cold (compile + run) and warm;
3. ``view --pixel 960 540`` on the metadata the headline wrote;
4. oracle: the headline's hits against the float64 reference march in
   tests/fixtures.py, on every row of 48 columns spread over the frame;
5. golden scenes: the 13 committed CPU goldens (tests/goldens/) against the
   same scenes rendered on the GPU;
6. ``gen`` with the Rectilinear and InterpolatingRectilinear generators at
   the headline view, and an 8-object translucent scene at 1080p/100 km.

``--four`` runs only the four-GPU phase: ``gen --shard`` for every generator
and a sharded 8-direction sweep, each compared with the same view rendered
on one GPU.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; a failing phase exits non-zero without it.
Terrain and renders go to ``chip_smoke_out/`` beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "chip_smoke_out"

LAT0, LON0 = 49.5, 21.5

# Oracle tolerances for the headline (200 km, f32 on the device against an
# f64 RK4 march at 5 m substeps). See ORACLE_NOTE for the reasoning.
ORACLE_AGREE_MIN = 0.99
ORACLE_DIST_TOL_M = 0.25
ORACLE_ELEV_TOL_M = 0.025
ORACLE_NOTE = (
    "robust pixels (both segment ends >= 0.2 m from the terrain, so the "
    "ray-terrain gap closes by >= 0.4 m per 50 m step and an altitude "
    "error dh moves the crossing by <= 125 dh); the f32 march stays within "
    "~2 mm of the f64 one at 200 km and the key's f32 rounding at step "
    "4000 is 2.4 cm; the terrain's slope (< 0.1) scales that to elevation"
)

# Golden tolerance: the goldens are CPU renders; another backend's f32
# codegen (fusion order, FMA contraction, transcendentals) moves values by
# a few ulp, which after u8 truncation shows as +-1-2 counts, and a flipped
# crossing test at a silhouette changes a pixel outright.
GOLDEN_BIG_COUNTS = 2
GOLDEN_MAX_BIG = 0.01
GOLDEN_MAX_ANY = 0.05


@dataclasses.dataclass(frozen=True)
class Size:
    """Scale of one run; the script's own runs use the defaults."""

    width: int = 1920
    height: int = 1080
    max_km: float = 200.0
    step: float = 50.0
    posts: int = 1201
    reach_lat: float = 2.0
    reach_lon: float = 3.0
    objects_km: float = 100.0
    oracle_cols: int = 48
    sweep_width: int = 1280
    sweep_height: int = 720
    sweep_km: float = 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, what) -> None:
    """A phase's check; raises (``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gate():
    """Exit non-zero unless JAX's first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[gate] jax {jax.__version__}, {dev.device_kind}, "
        f"{len(jax.devices())} device(s)")
    return dev


# ---------------------------------------------------------------- helpers


def _tests_on_path():
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def mosaic_tiles(size: Size):
    """(lat0, lon0) of every 1-degree tile the headline view can reach."""
    la = range(math.floor(LAT0 - size.reach_lat),
               math.floor(LAT0 + size.reach_lat) + 1)
    lo = range(math.floor(LON0 - size.reach_lon),
               math.floor(LON0 + size.reach_lon) + 1)
    return [(a, b) for a in la for b in lo]


def write_mosaic(folder: Path, size: Size) -> dict:
    """Write the synthetic DTED mosaic; returns {(lat0, lon0): int16 grid}."""
    _tests_on_path()
    from fixtures import tile_grid

    from atm_raytracer_tpu.terrain import write_dted

    folder.mkdir(parents=True, exist_ok=True)
    grids = {}
    for la, lo in mosaic_tiles(size):
        grid = tile_grid(la, lo, size.posts)
        write_dted(folder / f"n{la}_e{lo}.dt2", la, lo, grid)
        grids[(la, lo)] = grid
    return grids


def ensure_native_loader() -> str:
    """Build the C++ tile loaders if g++ exists; name the loader in use."""
    from atm_raytracer_tpu.terrain import native

    if not native.available() and shutil.which("g++"):
        subprocess.run(
            ["sh", str(REPO / "atm_raytracer_tpu" / "native" / "build.sh")],
            check=True, capture_output=True,
        )
    return "native C++" if native.available() else "numpy"


def view_config(size: Size, terrain_dir: Path) -> dict:
    return {
        "scene": {"terrain_folder": str(terrain_dir)},
        "view": {
            "position": {"latitude": LAT0, "longitude": LON0,
                         "altitude": {"Relative": 100.0}},
            "frame": {"direction": 45.0, "fov": 40.0,
                      "max_distance": size.max_km * 1000.0},
        },
        "simulation_step": size.step,
        "output": {"width": size.width, "height": size.height},
    }


def objects_config(size: Size, terrain_dir: Path) -> dict:
    """8 cylinders and cones in front of the observer, translucent terrain."""
    m_per_deg = 111_194.9
    objects = []
    for i in range(8):
        dist = 1500.0 + 900.0 * i
        az = math.radians(40.0 + 1.5 * i)
        objects.append({
            "position": {
                "latitude": LAT0 + dist * math.cos(az) / m_per_deg,
                "longitude": LON0 + dist * math.sin(az) / m_per_deg
                / math.cos(math.radians(LAT0)),
                "altitude": {"Relative": 0.0},
            },
            "color": {"r": 0.9, "g": 0.1 * i, "b": 0.2, "a": 0.9},
            "shape": ({"Cylinder": {"radius": 30.0, "height": 200.0}}
                      if i % 2 == 0 else
                      {"Cone": {"radius": 40.0, "height": 150.0}}),
        })
    d = view_config(size, terrain_dir)
    d["view"]["frame"]["max_distance"] = size.objects_km * 1000.0
    d["scene"].update({"objects": objects, "terrain_alpha": 0.65})
    return d


def write_config(path: Path, cfg: dict) -> Path:
    # JSON is valid YAML: parse_config reads it as is
    path.write_text(json.dumps(cfg, indent=1))
    return path


_PERCENT = re.compile(r"^\d+\.\d+: (\d+)%\.\.\.$")


def run_cli(argv) -> str:
    """``cli.main(argv)`` in this process; echoes and returns its stdout."""
    from atm_raytracer_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    | {line}")
    if rc != 0:
        raise RuntimeError(f"cli.main{tuple(argv)} returned {rc}")
    return text


def gen(size: Size, cfg: Path, png: Path, meta: Path | None, *extra,
        size_flags: bool = True):
    argv = ["gen", "-c", cfg, "--output", png]
    if size_flags:
        argv += ["-w", size.width, "-h", size.height,
                 "-m", f"{size.max_km:g}", "--step", f"{size.step:g}"]
    if meta is not None:
        argv += ["--output-meta", meta]
    t0 = time.perf_counter()
    text = run_cli(argv + list(extra))
    return text, time.perf_counter() - t0


def percents(text: str):
    return [int(m.group(1)) for m in map(_PERCENT.match, text.splitlines())
            if m]


def load_hits(meta: Path):
    """(valid, key, distance, elevation) of hit slot 0, as numpy [H, W]."""
    from atm_raytracer_tpu.meta.serialize import load_metadata

    _, res = load_metadata(meta)
    h = res.hits
    return tuple(np.asarray(a)[..., 0]
                 for a in (h.valid, h.key, h.distance, h.elevation))


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------- oracle


def compare_with_oracle(valid, dist, elev, grids, params, size: Size,
                        cols, chunk: int = 8, alt_rel: float = 100.0):
    """Headline hits against the independent float64 reference.

    valid/dist/elev: [H, W] first-hit fields of the render. grids: the
    mosaic's {(lat0, lon0): posts}. Every row of the columns ``cols`` is
    compared. Returns a report dict; ``oracle_ok`` applies the tolerances.
    """
    _tests_on_path()
    from fixtures import (
        f64_march_spherical,
        f64_sphere_refracted_oracle,
        make_mosaic_bilin,
    )

    from atm_raytracer_tpu.models import camera

    frame = params.view.frame
    bilin = make_mosaic_bilin(
        {k: np.asarray(g, np.float64) for k, g in grids.items()})
    el = np.deg2rad(np.asarray(camera.fast_ray_elevations(
        size.width, size.height, frame.fov, frame.tilt), np.float64))
    az = np.deg2rad(np.asarray(camera.fast_ray_azimuths(
        size.width, size.height, frame.fov, frame.direction), np.float64))
    max_d = size.max_km * 1000.0
    radius = params.model.to_shape().radius
    alt0 = float(bilin(LAT0, LON0)) + alt_rel
    n = int(np.ceil(max_d / size.step))
    ray = f64_march_spherical(params.atmosphere, params.wavelength, alt0, el,
                              size.step, n, radius)
    cols = np.asarray(cols)
    n_px = agree = n_robust = 0
    dist_err = elev_err = 0.0
    for c0 in range(0, len(cols), chunk):
        cs = cols[c0:c0 + chunk]
        has, d_o, e_o, robust = f64_sphere_refracted_oracle(
            None, LAT0, LON0, alt_rel, el, az[cs], size.step, max_d,
            params.atmosphere, params.wavelength, radius,
            bilin=bilin, ray=ray)
        pv = np.asarray(valid[:, cs], bool)
        n_px += pv.size
        agree += int((pv == has).sum())
        rb = robust & pv
        n_robust += int(rb.sum())
        if rb.any():
            dist_err = max(dist_err,
                           float(np.abs(dist[:, cs] - d_o)[rb].max()))
            elev_err = max(elev_err,
                           float(np.abs(elev[:, cs] - e_o)[rb].max()))
    return {"pixels": n_px, "hit_agreement": agree / n_px,
            "robust": n_robust, "max_dist_err_m": dist_err,
            "max_elev_err_m": elev_err}


def oracle_ok(report) -> bool:
    return (report["hit_agreement"] >= ORACLE_AGREE_MIN
            and report["robust"] > 0
            and report["max_dist_err_m"] <= ORACLE_DIST_TOL_M
            and report["max_elev_err_m"] <= ORACLE_ELEV_TOL_M)


# ---------------------------------------------------------------- goldens


def golden_diff(golden, image):
    """(ok, share of pixels off at all, share off by > 2 counts, max diff)."""
    golden = np.asarray(golden, np.int16)
    image = np.asarray(image, np.int16)
    if golden.shape != image.shape:
        return False, 1.0, 1.0, 255
    pix = np.abs(golden - image).max(axis=-1)
    frac_any = float((pix > 0).mean())
    frac_big = float((pix > GOLDEN_BIG_COUNTS).mean())
    ok = frac_big <= GOLDEN_MAX_BIG and frac_any <= GOLDEN_MAX_ANY
    return ok, frac_any, frac_big, int(pix.max())


def render_goldens(work: Path):
    """Render the 13 golden scenes here; yields (name, image, golden)."""
    _tests_on_path()
    import test_golden as G
    from fixtures import make_terrain_folder

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.render.annotate import annotate_image
    from atm_raytracer_tpu.render.image import load_png_rgb
    from atm_raytracer_tpu.terrain.store import Terrain

    work.mkdir(parents=True, exist_ok=True)
    terrain_dir = make_terrain_folder(work, tiles=((49, 21),), n=181)
    terrain = Terrain.from_folder(terrain_dir)

    def golden(name):
        return load_png_rgb(G.GOLDEN_DIR / f"{name}.png")

    for gen_name in G.GENERATORS:
        for scene in G.SCENES:
            name = f"{gen_name.lower()}_{scene}"
            _, r = G._render(gen_name, scene, terrain_dir, terrain)
            yield name, np.asarray(r.image), golden(name)
    params = Config.from_dict(
        G.annotated_config(str(terrain_dir))).into_params(terrain)
    r = render_fast(params, terrain)
    img = annotate_image(r.image, params, r.elevation_deg, r.azimuth_deg,
                         r.observer[2])
    yield "fast_plain_annotated", img, golden("fast_plain_annotated")


def verify_goldens(work: Path) -> tuple[int, int, int]:
    """Print one line per golden scene; returns (passed, total, max diff)."""
    passed = total = worst = 0
    for name, img, gold in render_goldens(work):
        ok, f_any, f_big, mx = golden_diff(gold, img)
        total += 1
        passed += ok
        worst = max(worst, mx)
        log(f"    {name}: any={f_any:.4f} big={f_big:.4f} max={mx} "
            f"{'ok' if ok else 'FAIL'}")
    return passed, total, worst


# ---------------------------------------------------------------- phases


def phase_headline(size: Size, dev):
    from atm_raytracer_tpu.config import parse_config
    from atm_raytracer_tpu.generators.fast import terrain_bbox
    from atm_raytracer_tpu.terrain.store import Terrain

    terrain_dir = OUT / "terrain"
    shutil.rmtree(terrain_dir, ignore_errors=True)
    t0 = time.perf_counter()
    grids = write_mosaic(terrain_dir, size)
    loader = ensure_native_loader()
    log(f"[terrain] {len(grids)} DTED tiles of {size.posts}^2 posts written "
        f"in {time.perf_counter() - t0:.2f} s; loader: {loader}")

    cfg = write_config(OUT / "headline.json", view_config(size, terrain_dir))
    png, meta = OUT / "headline.png", OUT / "headline.npz"
    text, cold = gen(size, cfg, png, meta)
    _, warm = gen(size, cfg, png, meta)
    pct = percents(text)
    require(any(p < 100 for p in pct), f"in-scan percent lines: {pct}")
    require(png.stat().st_size > 0, "headline PNG written")
    log(f"[headline] gen {size.width}x{size.height} {size.max_km:g} km "
        f"{size.step:g} m: cold {cold:.2f} s, warm {warm:.2f} s, "
        f"{len(pct)} percent lines")

    terrain = Terrain.from_folder(terrain_dir)
    params = parse_config(cfg).into_params(terrain)
    pack = terrain.pack(*terrain_bbox(params))
    import jax

    pack_bytes = sum(int(x.nbytes) for x in jax.tree_util.tree_leaves(pack)
                     if hasattr(x, "nbytes"))
    log(f"[headline] packed mosaic {pack_bytes} B on device; "
        f"peak_bytes_in_use {peak_bytes(dev)}")
    return grids, params, meta


def phase_view(size: Size, meta: Path):
    x, y = size.width // 2, size.height // 2
    t0 = time.perf_counter()
    text = run_cli(["view", meta, "--pixel", x, y])
    require("View direction" in text, text)
    log(f"[view] --pixel {x} {y}: {time.perf_counter() - t0:.2f} s")


def phase_oracle(size: Size, grids, params, meta: Path):
    t0 = time.perf_counter()
    valid, _, dist, elev = load_hits(meta)
    cols = np.linspace(0, size.width - 1, size.oracle_cols).round()
    rep = compare_with_oracle(valid, dist, elev, grids, params, size,
                              cols.astype(int))
    log(f"[oracle] {json.dumps(rep)} in {time.perf_counter() - t0:.2f} s")
    log(f"[oracle] tolerance: agreement >= {ORACLE_AGREE_MIN}, distance <= "
        f"{ORACLE_DIST_TOL_M} m, elevation <= {ORACLE_ELEV_TOL_M} m on "
        f"{ORACLE_NOTE}")
    require(oracle_ok(rep), rep)


def phase_goldens():
    t0 = time.perf_counter()
    passed, total, worst = verify_goldens(OUT / "golden")
    log(f"[golden] {passed}/{total} scenes within tolerance, largest "
        f"channel difference {worst}, {time.perf_counter() - t0:.2f} s")
    require(total == 13 and passed == total, f"{passed}/{total} goldens")


def check_frame(meta: Path, what: str):
    valid, key, dist, _ = load_hits(meta)
    frac = float(valid.mean())
    require(0.05 < frac < 0.95, f"{what}: hit fraction {frac}")
    require(np.isfinite(key[valid]).all() and np.isfinite(dist[valid]).all(),
            f"{what}: finite hit keys and distances")
    return frac


def phase_generators(size: Size):
    terrain_dir = OUT / "terrain"
    cfg = OUT / "headline.json"
    for gen_name in ("Rectilinear", "InterpolatingRectilinear"):
        png, meta = OUT / f"{gen_name}.png", OUT / f"{gen_name}.npz"
        text, cold = gen(size, cfg, png, meta, "--generator", gen_name)
        _, warm = gen(size, cfg, png, meta, "--generator", gen_name)
        frac = check_frame(meta, gen_name)
        log(f"[{gen_name}] cold {cold:.2f} s, warm {warm:.2f} s "
            f"(compile ~{cold - warm:.2f} s), hit fraction {frac:.3f}, "
            f"{len(percents(text))} percent lines")
    cfg = write_config(OUT / "objects.json", objects_config(size, terrain_dir))
    png, meta = OUT / "objects.png", OUT / "objects.npz"
    _, cold = gen(size, cfg, png, meta, size_flags=False)
    _, warm = gen(size, cfg, png, meta, size_flags=False)
    frac = check_frame(meta, "objects")
    log(f"[objects] 8 frusta, terrain_alpha 0.65, {size.width}x{size.height} "
        f"{size.objects_km:g} km: cold {cold:.2f} s, warm {warm:.2f} s "
        f"(compile ~{cold - warm:.2f} s), hit fraction {frac:.3f}")


def phase_four(size: Size):
    """Sharded renders on four GPUs against the same views on one."""
    import jax

    devs = jax.devices()  # the gate has checked that devs[0] is a GPU
    require(len(devs) == 4, f"--four needs 4 devices, JAX sees {devs}")
    require(len({d.platform for d in devs}) == 1, devs)
    terrain_dir = OUT / "terrain"
    shutil.rmtree(terrain_dir, ignore_errors=True)
    write_mosaic(terrain_dir, size)
    log(f"[four] loader: {ensure_native_loader()}")
    cfg = write_config(OUT / "headline.json", view_config(size, terrain_dir))
    # a tilted Rectilinear frame is sharded through the dense per-pixel
    # program; on one device it takes the envelope-culled program unless
    # ATM_RAYTRACER_NO_CULL is set, so its one-device reference sets it
    cases = [("Fast", (), False), ("Rectilinear", (), False),
             ("Rectilinear", ("-i", "3"), True),
             ("InterpolatingRectilinear", (), False)]
    for gen_name, extra, dense in cases:
        tag = gen_name + ("_tilt3" if extra else "")
        args = ("--generator", gen_name) + extra
        one, four = OUT / f"{tag}_1.npz", OUT / f"{tag}_4.npz"
        if dense:
            os.environ["ATM_RAYTRACER_NO_CULL"] = "1"
        try:
            _, t1 = gen(size, cfg, OUT / f"{tag}_1.png", one, *args)
        finally:
            os.environ.pop("ATM_RAYTRACER_NO_CULL", None)
        text, t4 = gen(size, cfg, OUT / f"{tag}_4.png", four, *args,
                       "--shard")
        require("Sharding over 4 devices" in text, text)
        v1, k1, _, _ = load_hits(one)
        v4, k4, _, _ = load_hits(four)
        n_valid = int((v1 != v4).sum())
        both = v1 & v4
        n_key = int((k1[both] != k4[both]).sum())
        log(f"[four] {tag}: one GPU {t1:.2f} s, four {t4:.2f} s (cold); "
            f"hit masks differ at {n_valid} px, keys at {n_key} px")
        require(n_valid == 0 and n_key == 0, f"{tag}: sharded hits agree")

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded
    from atm_raytracer_tpu.terrain.store import Terrain

    terrain = Terrain.from_folder(terrain_dir)
    sw = dataclasses.replace(size, width=size.sweep_width,
                             height=size.sweep_height, max_km=size.sweep_km)
    d = view_config(sw, terrain_dir)
    d["view"]["frame"]["fov"] = 45.0
    params = Config.from_dict(d).into_params(terrain)
    dirs = [i * 45.0 for i in range(8)]
    frames = {}
    for n_dev in (1, 4):
        t0 = time.perf_counter()
        frames[n_dev] = np.asarray(render_sweep_sharded(
            params, terrain, make_mesh(devs[:n_dev]), directions_deg=dirs))
        log(f"[four] sweep of {len(dirs)} frames on {n_dev} GPU(s): "
            f"{time.perf_counter() - t0:.2f} s (cold)")
    n_px = int((frames[1] != frames[4]).any(-1).sum())
    log(f"[four] sweep frames differ at {n_px} px")
    require(n_px == 0, "sweep frames agree")
    for d_ in devs:
        log(f"[four] {d_}: peak_bytes_in_use {peak_bytes(d_)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding phase")
    args = ap.parse_args(argv)
    os.environ.setdefault("ATM_RAYTRACER_TRACEBACK", "1")
    dev = gate()
    OUT.mkdir(exist_ok=True)
    size = Size()
    t_all = time.perf_counter()
    if args.four:
        phase_four(size)
    else:
        grids, params, meta = phase_headline(size, dev)
        phase_view(size, meta)
        phase_oracle(size, grids, params, meta)
        phase_goldens()
        phase_generators(size)
    import jax

    log(f"[done] {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
