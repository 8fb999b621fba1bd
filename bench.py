#!/usr/bin/env python3
"""Benchmarks over the BASELINE.json config matrix.

Default (driver contract): ONE JSON line {"metric", "value", "unit",
"vs_baseline"} for the headline config — 1920×1080, 200 km, 50 m-step
refraction panorama on one chip (BASELINE configs[1], north-star ≤ 1 s).

``--all``: one JSON line per BASELINE config (small flat PR1 case, headline,
objects scene, 8192×2048 metadata frame, batched 360° sweep), headline LAST
so tail-parsers still see the driver metric. ``vs_baseline`` is always
(1 s target) / wall — >1 beats the ≤1 s/frame north-star bar.

Metric note: Mray-steps/sec counts the reference's cost model of
W·H·(max_distance/step) per-pixel march iterations (BASELINE.md). Walls are
measured by fetching the final u8 frame to host.

Runs only on a GPU: on any other backend it prints one JSON error line and
exits non-zero.

Terrain: synthetic analytic hills on a mosaic of 1201-post tiles built in
memory (the reference needs user-supplied USGS downloads; capability-
equivalent data path: same mosaic pack + device gathers).
"""

import argparse
import json
import math
import sys
import time

import numpy as np


def build_terrain(lat0, lon0, reach_deg_lat, reach_deg_lon, n_posts=1201):
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from fixtures import tile_grid
    from atm_raytracer_tpu.terrain.store import Terrain, Tile

    terrain = Terrain()
    for la in range(int(math.floor(lat0 - reach_deg_lat)), int(math.floor(lat0 + reach_deg_lat)) + 1):
        for lo in range(int(math.floor(lon0 - reach_deg_lon)), int(math.floor(lon0 + reach_deg_lon)) + 1):
            # integer-meter posts, like real DTED/SRTM tiles — the same
            # fixture grid the tests render
            terrain.add_tile(Tile(lat0=la, lon0=lo, elev=tile_grid(la, lo, n_posts)))
    return terrain


LAT0, LON0 = 49.5, 21.5
NORTH_STAR_WALL = 1.0  # BASELINE.json: ≤ 1 s per frame on one chip


def _view_dict(width, height, fov, max_distance, step, **extra):
    d = {
        "view": {
            "position": {
                "latitude": LAT0,
                "longitude": LON0,
                "altitude": {"Relative": 100.0},
            },
            "frame": {"direction": 45.0, "fov": fov, "max_distance": max_distance},
        },
        "simulation_step": step,
        "output": {"width": width, "height": height},
    }
    d.update(extra)
    return d


def _emit(metric, wall, width, height, max_distance, step, note="", frames=1):
    ray_steps = frames * width * height * (max_distance / step)
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(ray_steps / wall / 1e6, 2),
                "unit": (
                    f"Mray-steps/s ({note}wall={wall:.3f}s"
                    + (f" for {frames} frames" if frames > 1 else "")
                    + ")"
                ),
                "vs_baseline": round(NORTH_STAR_WALL / (wall / frames), 3),
            }
        ),
        flush=True,
    )


def _timed(fn, runs=3, pick=None):
    """Median wall over ``runs`` timed calls after one warmup.

    If ``pick`` is a list, the 0-based index (into the timed runs, warmup
    excluded) of the run whose wall is closest to the reported median is
    appended, so callers can pair per-run side stats (device/transfer
    shares) with the SAME run the reported wall comes from instead of
    mixing statistics across runs.
    """
    fn()  # warmup / compile
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    if pick is not None:
        pick.append(int(np.argmin([abs(t - med) for t in times])))
    return med


def bench_headline(terrain):
    """configs[1]: 1080p spherical refraction panorama — the driver metric.

    Uses the raw jitted Fast core with pack/table as ARGUMENTS (not
    captured constants) and per-run input perturbation, mirroring the
    reference cost model exactly.
    """
    import functools

    import jax
    import jax.numpy as jnp

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators.fast import (
        build_refraction_table,
        fast_core,
        terrain_bbox,
    )
    from atm_raytracer_tpu.models import camera

    width, height, max_distance, step = 1920, 1080, 200_000.0, 50.0
    config = Config.from_dict(_view_dict(width, height, 40.0, max_distance, step))
    params = config.into_params(terrain)
    alt0 = params.view.position.abs_altitude(terrain)

    elev_deg = camera.fast_ray_elevations(width, height, 40.0, 0.0)
    az_deg = camera.fast_ray_azimuths(width, height, 40.0, 45.0)
    lat_rng, lon_rng = terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = build_refraction_table(params, alt0)
    n_terr = int(math.ceil(max_distance / step))

    from atm_raytracer_tpu.generators.base import fetch_flat_many
    from atm_raytracer_tpu.meta.pack import (
        frame_base_rgb,
        pack_frame_compact,
        unpack_frame_compact,
    )

    core = functools.partial(
        fast_core,
        model=params.model, shape=params.model.to_shape(), straight=False,
        step=step, n_terr=n_terr, max_hits=1, lat0=LAT0, lon0=LON0,
        coloring=params.coloring, fog_distance=None, terrain_alpha=1.0,
    )

    # Two transports: the frame leaves the device raw (flat u8) or through
    # the lossless compact codec (meta/pack.py: bitmask + 4-bit channel
    # deltas; reconstruction bit-identical, pinned by
    # tests/test_meta_pack.py::test_frame_compact_roundtrip). Both
    # pipelines are measured; the better median is reported with the
    # chosen path in the note.
    def packed(pk, tb, el, az):
        image, hits = core(pk, tb, None, el, az, float(alt0))
        return pack_frame_compact(hits.valid, image)

    jit_packed = jax.jit(packed)
    jit_raw = jax.jit(
        lambda pk, tb, el, az:
        core(pk, tb, None, el, az, float(alt0))[0].reshape(-1)
    )
    sky = frame_base_rgb(params.coloring, None)
    el = jnp.asarray(elev_deg, jnp.float32)
    az = jnp.asarray(az_deg, jnp.float32)

    def run_compact(el_i):
        t0 = time.perf_counter()
        bits, img_n, img_ei, img_ev, counts = jit_packed(
            pack, table, el_i, az
        )
        # device completion first (device_get of the counts), then the
        # fetch
        n_px, *nes = (int(v) for v in jax.device_get(counts))
        t1 = time.perf_counter()
        segs = [bits]
        for c, ne in enumerate(nes):
            segs += [img_n[c, :(n_px + 1) // 2], img_ei[c, :ne],
                     img_ev[c, :ne]]
        outs = fetch_flat_many(segs)
        frame = unpack_frame_compact(
            outs[0],
            [tuple(outs[1 + 3 * c: 4 + 3 * c]) for c in range(3)],
            sky, height, width, n_px,
        )
        assert frame.shape == (height, width, 3)
        return time.perf_counter() - t0, t1 - t0

    def run_raw(el_i):
        t0 = time.perf_counter()
        out = jit_raw(pack, table, el_i, az)
        jax.device_get(out[0])
        t1 = time.perf_counter()
        frame = np.asarray(out).reshape(height, width, 3)
        assert frame.shape == (height, width, 3)
        return time.perf_counter() - t0, t1 - t0

    jax.device_get(jit_packed(pack, table, el, az)[4])  # warmup / compile
    np.asarray(jit_raw(pack, table, el, az))
    results = {}
    for name, fn in (("compact", run_compact), ("raw", run_raw)):
        times, dev_times = [], []
        for i in range(4):
            el_i = el + np.float32(1 + i) * np.float32(1e-7)
            w_t, d_t = fn(el_i)
            times.append(w_t)
            dev_times.append(d_t)
        results[name] = (float(np.median(times)),
                         float(np.median(dev_times)))
    choice = min(results, key=lambda k: results[k][0])
    wall, dev = results[choice]
    _emit("mray_steps_per_sec_per_chip", wall, width, height, max_distance,
          step, note=(f"1080p 200km 50m; device={dev:.3f}s "
                      f"transport={choice} "))


def bench_small_flat(terrain):
    """configs[0]: 640×480 flat-Earth --straight, single tile, step=100m."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast

    width, height, max_distance, step = 640, 480, 40_000.0, 100.0
    d = _view_dict(width, height, 30.0, max_distance, step,
                   earth_shape="FlatDistorted", straight_rays=True)
    params = Config.from_dict(d).into_params(terrain)
    wall = _timed(lambda: render_fast(params, terrain))
    _emit("small_flat_straight", wall, width, height, max_distance, step,
          note="640x480 flat straight ")


def bench_objects(terrain):
    """configs[2]: scene objects + translucent terrain compositing at full
    1080p/100 km scale. Static per-object column windows
    (ops.objects.object_col_windows) bound the candidate tensors to
    [H, W_window, seg_window], so the frame compiles and runs at size."""
    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast

    width, height, max_distance, step = 1920, 1080, 100_000.0, 50.0
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
            "shape": (
                {"Cylinder": {"radius": 30.0, "height": 200.0}}
                if i % 2 == 0 else
                {"Cone": {"radius": 40.0, "height": 150.0}}
            ),
        })
    d = _view_dict(width, height, 40.0, max_distance, step,
                   scene={"objects": objects, "terrain_alpha": 0.65})
    params = Config.from_dict(d).into_params(terrain)

    import jax

    from atm_raytracer_tpu.generators.base import fetch_flat_many
    from atm_raytracer_tpu.meta.pack import (
        frame_base_rgb,
        pack_frame_compact,
        unpack_frame_compact,
    )

    sky = frame_base_rgb(params.coloring, params.view.fog_distance)
    packer = jax.jit(pack_frame_compact)

    def run():
        t0 = time.perf_counter()
        r = render_fast(params, terrain, fetch_image=False)
        # lossless compact frame staging (meta/pack.py): hit-pixel RGB +
        # bitmask; no-hit pixels are the constant sky even on this
        # translucent-terrain scene (remainder blending only happens on
        # hit pixels)
        bits, img_n, img_ei, img_ev, counts = packer(r.hits.valid, r.image)
        n_px, *nes = (int(v) for v in jax.device_get(counts))
        t1 = time.perf_counter()
        segs = [bits]
        for c, ne in enumerate(nes):
            segs += [img_n[c, :(n_px + 1) // 2], img_ei[c, :ne],
                     img_ev[c, :ne]]
        outs = fetch_flat_many(segs)
        frame = unpack_frame_compact(
            outs[0],
            [tuple(outs[1 + 3 * c: 4 + 3 * c]) for c in range(3)],
            sky, height, width, n_px,
        )
        assert frame.shape == (height, width, 3)
        return t1 - t0, time.perf_counter() - t0

    run()  # warmup / compile
    pairs = [run() for _ in range(3)]
    dev = float(np.median([p[0] for p in pairs]))
    wall = float(np.median([p[1] for p in pairs]))
    _emit("objects_translucent", wall, width, height, max_distance, step,
          note=f"1080p objects alpha=0.65; device={dev:.3f}s ")


def bench_8k_metadata(terrain):
    """configs[3]: 8192×2048 wide-FoV multi-tile frame + per-pixel metadata.

    Metadata staging uses the SEPARABLE device-side pack (meta/pack.py):
    the Fast generator's hit lat/lon is fully determined by (column
    azimuth, key), so only the validity bitmask plus the valid slots' key
    (f32) + elevation (u16) cross the link — ~6 B per valid slot instead
    of 14 B per slot — and lat/lon re-derives host-side in f64 (tested to
    ~mm of the staged device values). The wall still includes that
    transfer (view-mode compatible); the JSON also reports the
    device-compute and transfer shares separately.
    """
    import jax

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators import render_fast
    from atm_raytracer_tpu.meta.pack import (
        fetch_viewer_fields_delta,
        frame_base_rgb,
    )

    width, height, max_distance, step = 8192, 2048, 150_000.0, 50.0
    params = Config.from_dict(
        _view_dict(width, height, 120.0, max_distance, step)
    ).into_params(terrain)

    per_run = []

    def run():
        stats = {}
        t0 = time.perf_counter()
        r = render_fast(params, terrain, fetch_image=False)
        # device completion before timing the transfers
        r.hits.key.block_until_ready()
        t1 = time.perf_counter()
        # delta-compact staging (meta/pack.py v3): validity bitmask +
        # i16-delta keys (1/256-step fixed point) + u16 elevation for valid
        # slots, and the FRAME compacted to hit pixels with i8-delta RGB —
        # sky pixels reconstruct from one constant. Decode is lazy, so
        # decode a pixel like the viewer's click path to prove the payload
        vf, img, pstats = fetch_viewer_fields_delta(
            r, params.model, step,
            frame_base_rgb(params.coloring, None),
        )
        assert img.shape == (height, width, 3)
        t2 = time.perf_counter()
        px = vf.pixel(height // 2, width // 2)
        assert px["key"].shape == (r.hits.key.shape[-1],)
        stats["device_s"] = round(t1 - t0, 3)
        stats["transfer_s"] = round(t2 - t1, 3)
        stats["staged_mb"] = round(pstats["staged_bytes"] / 1e6, 1)
        stats["link_mb_s"] = round(
            pstats["staged_bytes"] / 1e6 / max(t2 - t1, 1e-9), 1
        )
        stats["pixel_decode_s"] = round(time.perf_counter() - t2, 4)
        per_run.append(stats)

    pick = []
    wall = _timed(run, runs=2, pick=pick)
    shares = per_run[1 + pick[0]]  # per_run[0] is the warmup run
    _emit("wide_8k_metadata", wall, width, height, max_distance, step,
          note=(f"8192x2048 fov=120 +metadata; device={shares['device_s']}s "
                f"image+meta_transfer={shares['transfer_s']}s "
                f"staged_mb={shares['staged_mb']} "
                f"link_mb_s={shares['link_mb_s']} "
                f"pixel_decode={shares['pixel_decode_s']}s "))


def bench_sweep(terrain):
    """configs[4]: batched 360° azimuth sweep, one vmapped launch."""
    import jax

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.parallel.mesh import make_mesh, render_sweep_sharded

    from atm_raytracer_tpu.generators.base import fetch_flat_many
    from atm_raytracer_tpu.meta.pack import (
        frame_base_rgb,
        pack_frame_compact,
        unpack_frame_compact,
    )

    width, height, max_distance, step = 1280, 720, 100_000.0, 50.0
    params = Config.from_dict(
        _view_dict(width, height, 45.0, max_distance, step)
    ).into_params(terrain)
    mesh = make_mesh(jax.devices()[:1])
    dirs = [i * 45.0 for i in range(8)]
    per_run = []
    sky = frame_base_rgb(params.coloring, None)
    packer = jax.jit(jax.vmap(pack_frame_compact))

    def run():
        t0 = time.perf_counter()
        frames, valid = render_sweep_sharded(
            params, terrain, mesh, directions_deg=dirs,
            return_hits="valid", fetch_frames=False,
        )
        # frames leave the device compacted (hit-pixel RGB + bitmask; sky
        # is one constant — lossless, meta/pack.py). return_hits="valid"
        # keeps only
        # the masks (other hit fields DCE) and fetch_frames=False keeps
        # the frames device-resident for the pack.
        bits, img_n, img_ei, img_ev, counts = packer(valid, frames)
        # device completion first (device_get of the counts), then the fetch
        cts = np.asarray(jax.device_get(counts))  # [F, 4]
        per_run.append({"device_s": round(time.perf_counter() - t0, 3)})
        nf = len(dirs)
        segs = [bits]
        for f in range(nf):
            n_px = int(cts[f, 0])
            for c in range(3):
                ne = int(cts[f, 1 + c])
                segs += [img_n[f, c, :(n_px + 1) // 2],
                         img_ei[f, c, :ne], img_ev[f, c, :ne]]
        outs = fetch_flat_many(segs)
        words = outs[0].reshape(nf, -1)
        for f in range(nf):
            base = 1 + 9 * f
            frame = unpack_frame_compact(
                words[f],
                [tuple(outs[base + 3 * c: base + 3 * c + 3])
                 for c in range(3)],
                sky, height, width, int(cts[f, 0]),
            )
            assert frame.shape == (height, width, 3)

    pick = []
    wall = _timed(run, runs=2, pick=pick)
    shares = per_run[1 + pick[0]]  # per_run[0] is the warmup run
    _emit("sweep_360", wall, width, height, max_distance, step,
          note=f"8x720p 360deg sweep; device={shares['device_s']}s ",
          frames=len(dirs))


def bench_generator(terrain, gen: str):
    """Headline config (1080p/200 km/50 m) through a specific generator —
    the reference's generator speed-ordering claim (README.md:273-279),
    measured end to end (host orchestration + device + image fetch), with
    the device-compute share reported next to the wall."""
    import jax

    from atm_raytracer_tpu.config import Config
    from atm_raytracer_tpu.generators.base import fetch_flat

    width, height, max_distance, step = 1920, 1080, 200_000.0, 50.0
    params = Config.from_dict(
        _view_dict(width, height, 40.0, max_distance, step)
    ).into_params(terrain)
    if gen == "Fast":
        from atm_raytracer_tpu.generators import render_fast as render
    elif gen == "Rectilinear":
        from atm_raytracer_tpu.generators.rectilinear import (
            render_rectilinear as render,
        )
    else:
        from atm_raytracer_tpu.generators.interpolating import (
            render_interpolating as render,
        )

    def run():
        t0 = time.perf_counter()
        r = render(params, terrain, fetch_image=False)
        # device completion first, then the fetch
        r.image.block_until_ready()
        t1 = time.perf_counter()
        img = fetch_flat(r.image)[: height * width * 3]
        assert img.shape == (height * width * 3,)
        return t1 - t0, time.perf_counter() - t0

    run()  # warmup / compile
    pairs = [run() for _ in range(3)]
    dev = float(np.median([p[0] for p in pairs]))
    wall = float(np.median([p[1] for p in pairs]))
    _emit(f"generator_{gen}", wall, width, height, max_distance, step,
          note=f"{gen} 1080p 200km 50m; device={dev:.3f}s ")


def bench_verify():
    """--verify: render the 13 golden scenes on this GPU and compare them
    with the committed CPU goldens (chip_smoke.verify_goldens holds the
    tolerance)."""
    import pathlib

    import chip_smoke

    passed, total, worst = chip_smoke.verify_goldens(
        pathlib.Path(__file__).resolve().parent / "chip_smoke_out" / "golden"
    )
    failed = total - passed
    print(json.dumps({
        "metric": "golden_verify",
        "value": passed,
        "unit": (f"{passed}/{total} golden scenes within tolerance, largest "
                 f"channel difference {worst}"),
        "vs_baseline": 1.0 if not failed else 0.0,
    }), flush=True)
    return 1 if failed else 0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--all", action="store_true",
                        help="run the full BASELINE config matrix")
    parser.add_argument(
        "--generator",
        choices=["Fast", "Rectilinear", "InterpolatingRectilinear"],
        help="time ONE generator at the headline config and exit",
    )
    parser.add_argument(
        "--config",
        choices=["small_flat", "objects", "8k_metadata", "sweep", "headline"],
        help="run ONE BASELINE matrix config and exit",
    )
    parser.add_argument(
        "--verify", action="store_true",
        help="render the golden scenes on the attached backend and compare "
             "against the committed CPU goldens within tolerance",
    )
    args = parser.parse_args()

    import jax

    from atm_raytracer_tpu.cli import _enable_compilation_cache

    if jax.default_backend() != "gpu":
        print(json.dumps({
            "metric": "mray_steps_per_sec_per_chip", "value": None,
            "unit": f"FAILED: no GPU (JAX backend {jax.default_backend()!r})",
            "vs_baseline": None,
        }), flush=True)
        return 1
    _enable_compilation_cache()

    if args.verify:
        return bench_verify()

    terrain = build_terrain(LAT0, LON0, 2.0, 3.0)
    if args.generator:
        bench_generator(terrain, args.generator)
        return
    if args.config:
        {"small_flat": bench_small_flat, "objects": bench_objects,
         "8k_metadata": bench_8k_metadata, "sweep": bench_sweep,
         "headline": bench_headline}[args.config](terrain)
        return
    if args.all:
        # one failing config must not kill the matrix
        for fn in (bench_small_flat, bench_objects, bench_8k_metadata,
                   bench_sweep):
            try:
                fn(terrain)
            except Exception as e:  # noqa: BLE001 — report and continue
                print(json.dumps({
                    "metric": fn.__name__, "value": None,
                    "unit": f"FAILED: {type(e).__name__}: {str(e)[:120]}",
                    "vs_baseline": None,
                }), flush=True)
    # LAST: the driver parses the tail line — a headline failure must still
    # end with a legible JSON line, not a traceback
    try:
        bench_headline(terrain)
    except Exception as e:  # noqa: BLE001
        print(json.dumps({
            "metric": "mray_steps_per_sec_per_chip", "value": None,
            "unit": f"FAILED: {type(e).__name__}: {str(e)[:120]}",
            "vs_baseline": None,
        }), flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main() or 0)
