"""CLI: the reference's five subcommands with an identical flag surface.

Reference: src/main.rs:17-39 dispatching gen (src/generator/params.rs:531-676)
/ view (src/viewer/mod.rs) / output-atm / output-ray-paths /
output-elev-profile. Short flags are preserved, including ``-h`` meaning
height (gen) — use ``--help`` for help on those subcommands.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


# The checkout's own compile cache, used when JAX_COMPILATION_CACHE_DIR is
# unset. A fixed path: the cache is keyed by it, so a moving directory
# never hits.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_compilation_cache() -> str:
    """Persistent XLA compilation cache; returns its directory.

    The first render of a frame shape compiles; later invocations reuse
    the cache. JAX itself reads ``JAX_COMPILATION_CACHE_DIR`` when it is
    set, so only its absence needs a directory here.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)


def _add_gen_parser(subparsers):
    p = subparsers.add_parser("gen", help="Render a panorama", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-t", "--terrain", dest="terrain")
    p.add_argument("-l", "--lat", dest="lat", type=float)
    p.add_argument("-g", "--lon", dest="lon", type=float)
    p.add_argument("-a", "--alt", dest="alt", type=float)
    p.add_argument("-e", "--elev", dest="elev", type=float)
    p.add_argument("-d", "--dir", dest="dir", type=float)
    p.add_argument("-f", "--fov", dest="fov", type=float)
    p.add_argument("-i", "--tilt", dest="tilt", type=float)
    p.add_argument("-m", "--maxdist", dest="maxdist", type=float,
                   help="Cutoff distance in km (default: 150)")
    p.add_argument("--step", dest="step", type=float)
    p.add_argument("-R", "--radius", dest="radius", type=float,
                   help="Earth radius in km (conflicts with --flat)")
    p.add_argument("--flat", action="store_true")
    p.add_argument("-s", "--straight", action="store_true")
    p.add_argument("--output", dest="output")
    p.add_argument("--output-meta", dest="output_meta")
    p.add_argument("--meta-format", dest="meta_format",
                   choices=["native", "reference"], default="native",
                   help="Metadata artifact format: native npz (default) or "
                        "the reference binary's gzip(bincode(AllData)) "
                        "layout (src/generator/mod.rs:26-45)")
    p.add_argument("-w", "--width", dest="width", type=int)
    p.add_argument("-h", "--height", dest="height", type=int)
    p.add_argument("-c", "--config", dest="config")
    p.add_argument("--generator", dest="generator",
                   choices=["Fast", "Rectilinear", "InterpolatingRectilinear"],
                   help="Override the generator (also settable in YAML)")
    p.add_argument("--shard", action="store_true",
                   help="Shard the frame over all visible accelerator "
                        "devices (multi-chip; extension over the reference "
                        "CLI — the reference is single-node rayon)")
    p.set_defaults(func=run_gen)


def run_gen(args) -> int:
    from .config import Config, merge_cli, parse_config
    from .generators import render_fast
    from .meta.serialize import save_metadata
    from .render.annotate import annotate_image
    from .render.image import save_png
    from .terrain.store import Terrain

    config = parse_config(args.config) if args.config else Config()
    config = merge_cli(config, args)

    start = time.monotonic()

    def phase(msg):
        print(f"{time.monotonic() - start:.3f}: {msg}")

    terrain_folder = Path(os.getcwd()) / config.scene.terrain_folder
    phase(f"Using terrain data directory: {terrain_folder}")
    terrain = Terrain.from_folder(terrain_folder)
    params = config.into_params(terrain)

    gen = params.output.generator
    phase(f"Generating ({gen})...")

    def progress(pct):
        # per-percent progress counter, fast.rs:78-87 / rectilinear.rs:40-49
        phase(f"{pct}%...")

    shard = bool(getattr(args, "shard", False))
    if shard:
        import jax

        devices = jax.devices()
        if len(devices) < 2:
            phase(f"--shard: only {len(devices)} device visible; "
                  "rendering single-chip")
            shard = False
        else:
            phase(f"Sharding over {len(devices)} devices")

    if shard:
        from .parallel.mesh import (
            make_mesh,
            render_fast_sharded,
            render_interpolating_sharded,
            render_rectilinear_sharded,
        )

        mesh = make_mesh()
        if gen == "Fast":
            result = render_fast_sharded(params, terrain, mesh)
        elif gen == "InterpolatingRectilinear":
            result = render_interpolating_sharded(params, terrain, mesh)
        else:
            result = render_rectilinear_sharded(params, terrain, mesh)
        progress(100)
    elif gen == "Fast":
        from .generators.base import callbacks_supported

        if callbacks_supported():
            result = render_fast(params, terrain, progress=progress)
        else:
            # a backend without host callbacks: banded dispatch gives
            # monotone percent lines anyway — fast.rs:78-87 semantics
            from .generators.fast import render_fast_streamed

            result = render_fast_streamed(
                params, terrain,
                bands=int(os.environ.get("ATM_RAYTRACER_BANDS", "8")),
                progress=progress,
            )
    elif gen == "Rectilinear":
        from .generators.rectilinear import render_rectilinear

        result = render_rectilinear(params, terrain, progress=progress)
    elif gen == "InterpolatingRectilinear":
        from .generators.interpolating import render_interpolating

        result = render_interpolating(params, terrain, progress=progress)
    else:
        raise SystemExit(f"unknown generator {gen!r}")

    phase("Outputting image...")
    image = annotate_image(
        result.image, params, result.elevation_deg, result.azimuth_deg,
        result.observer[2],
    )
    save_png(image, Path(os.getcwd()) / params.output.file)

    if params.output.file_metadata:
        phase("Outputting metadata...")
        save_metadata(params.output.file_metadata, config, result,
                      fmt=getattr(args, "meta_format", "native"),
                      terrain=terrain)
    phase("Done.")
    return 0


def _add_view_parser(subparsers):
    p = subparsers.add_parser("view", help="View a metadata file")
    p.add_argument("input", help="Path to the metadata file")
    p.add_argument("--pixel", nargs=2, type=int, metavar=("X", "Y"),
                   help="Headless: print info for one pixel")
    p.add_argument("--save-image", dest="save_image",
                   help="Headless: write the re-rendered PNG here")
    p.set_defaults(func=run_view_cmd)


def run_view_cmd(args) -> int:
    from .meta.viewer import run_view

    pixel = tuple(args.pixel) if args.pixel else None
    return run_view(args.input, pixel=pixel, save_image=args.save_image)


def main(argv=None) -> int:
    _enable_compilation_cache()

    parser = argparse.ArgumentParser(
        prog="atm-raytracer",
        description="Atmospheric Panorama Raytracer (JAX, GPU)")
    subparsers = parser.add_subparsers(dest="subcommand", required=True)
    _add_gen_parser(subparsers)
    _add_view_parser(subparsers)

    from .tools import atm_printer, elev_profile, ray_path

    atm_printer.add_parser(subparsers)
    ray_path.add_parser(subparsers)
    elev_profile.add_parser(subparsers)

    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except Exception as e:  # main.rs:36-38 prints "ERROR: {}"
        if os.environ.get("ATM_RAYTRACER_TRACEBACK"):
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
