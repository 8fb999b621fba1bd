"""Metadata artifact: self-contained params + per-pixel trace points.

Replaces the reference's gzip(bincode(AllData{params, result})) artifact
(src/generator/mod.rs:20-45, decoded in src/viewer/mod.rs:12-34). The format
here is a compressed npz (zip+deflate) carrying the config as YAML plus the
hit buffers; like the reference's, it is enough to re-render and inspect the
image without terrain data or re-simulation (SURVEY §5 checkpoint/resume).
Byte format is explicitly NOT bincode-compatible — the capability
(round-trip of params + per-pixel trace points) is what is preserved.

Format v2 (current writer): VALID-SLOT COMPACTION, exact payloads. The dense
[H, W, K] hit planes are mostly empty (sky pixels; K slots per pixel with
typically ≤1 hit), so the device packs a u32 validity bitmask plus only the
valid slots' fields, compacted in flat C order — 41 B per valid slot +
P/8 bitmask bytes instead of 53 B per slot valid or not, a ~4-5× cut on
typical frames before deflate. Every stored value is the EXACT f32 the
render produced (no range coding): reloading reproduces the renderer's
composite bit-identically. ``distance`` is not stored — it is
``where(valid, key, 0)·step`` by construction everywhere (generators/fast.py,
ops/objects.py:595,1005), the identical f32 expression re-applied on load.
Invalid slots decode to canonical fillers (key=+inf NO_HIT, 0 elsewhere);
renders leave garbage-but-masked values there, and every consumer gates on
``valid``. v1 (dense planes) files remain readable.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..generators.base import HitBuffer, RenderResult

FORMAT_VERSION = 2


@jax.jit
def _pack_artifact(valid, key, dlat, dlon, elevation, path_length, normal,
                   kind, rgba):
    """Device-side valid-slot compaction of all artifact fields.

    Returns (bits u32 [ceil(P/32)], count i32, key/dlat/dlon/elev/plen f32
    [P], normal f32 [P,3], kind i32 [P], rgba f32 [P,4]) with valid entries
    compacted to the front; callers fetch only the first ``count`` rows
    (kind narrows to u8 host-side, so the device scatters only u32/f32).
    """
    vflat = valid.reshape(-1)
    p = vflat.shape[0]
    pos = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    idx = jnp.where(vflat, pos, p)  # invalid slots dropped by mode="drop"

    def compact(x):
        x = x.reshape((p,) + x.shape[valid.ndim:])
        return jnp.zeros((p,) + x.shape[1:], x.dtype).at[idx].set(
            x, mode="drop"
        )

    count = jnp.sum(vflat.astype(jnp.int32))
    pad = (-p) % 32
    vpad = jnp.concatenate(
        [vflat, jnp.zeros((pad,), bool)]
    ).reshape(-1, 32).astype(jnp.uint32)
    bits = jnp.sum(
        vpad << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1,
        dtype=jnp.uint32,
    )
    return (bits, count, compact(key), compact(dlat), compact(dlon),
            compact(elevation), compact(path_length), compact(normal),
            compact(kind), compact(rgba))


def save_metadata(path, config: Config, result: RenderResult,
                  fmt: str = "native", terrain=None) -> None:
    """Write the metadata artifact.

    ``fmt="native"`` (default): the npz format above. ``fmt="reference"``:
    gzip(bincode(AllData)) in the reference binary's layout
    (src/generator/mod.rs:26-45) via :mod:`.bincode` — the write-side
    inverse of the ``.dat`` reader, so artifacts round-trip through
    :func:`load_metadata` and follow the layout the Rust viewer decodes
    (the atmosphere segment is best-effort; see
    :func:`.bincode.encode_environment`). ``terrain`` is needed only for
    ``reference`` scenes with Relative-altitude objects (the reference
    serializes lowered absolute elevations, object/mod.rs:165-184).
    """
    if fmt == "reference":
        blob = _encode_reference(config, result, terrain)
        with open(path, "wb") as fh:
            fh.write(blob)
        return
    if fmt != "native":
        raise ValueError(f"unknown metadata format {fmt!r}")
    hits = result.hits
    # write to the EXACT filename the user gave (np.savez appends .npz to
    # string paths; the reference honors --output-meta verbatim)
    with open(path, "wb") as fh:
        _savez(fh, config, result, hits)


def reference_params_dict(config: Config, terrain=None) -> dict:
    """Lower a Config to the dict tree :func:`.bincode.encode_alldata`
    serializes — the shape of the reference's post-lowering ``Params``
    (params.rs:496-528): objects carry resolved absolute elevations,
    coloring carries the lowered world-frame light vector."""
    from .bincode import encode_environment

    objects = []
    for o in config.scene.objects:
        objects.append({
            "position": {
                "lat": o.position.latitude,
                "lon": o.position.longitude,
                "elev": o.position.abs_altitude(terrain)
                if o.position.altitude.kind == "Relative"
                else o.position.altitude.value,
            },
            "shape": (
                {"Frustum": {"r1": o.shape.r1, "r2": o.shape.r2,
                             "height": o.shape.height}}
                if o.shape.kind == "Frustum"
                else {"Billboard": {"width": o.shape.width,
                                    "height": o.shape.height,
                                    "texture_path": o.shape.texture_path}}
            ),
            "color": {"r": o.color.r, "g": o.color.g, "b": o.color.b,
                      "a": o.color.a},
        })
    frame, position = config.view.frame, config.view.position
    lowered = config.view.coloring.into_coloring(
        frame, position, config.earth_shape
    )
    if lowered.kind == "Simple":
        coloring = {"Simple": {"water_level": lowered.water_level,
                               "max_distance": lowered.max_distance}}
    else:
        coloring = {"Shading": {
            "water_level": lowered.water_level,
            "ambient_light": lowered.ambient_light,
            "light_dir_world": list(lowered.light_dir),
            "palette": lowered.palette,
        }}
    from ..config import atmosphere_def_to_dict

    shape = config.earth_shape.to_shape()
    return {
        "scene": {
            "terrain_folder": config.scene.terrain_folder,
            "objects": objects,
            "terrain_alpha": config.scene.terrain_alpha,
        },
        "view": {
            "position": {
                "latitude": position.latitude,
                "longitude": position.longitude,
                "altitude": {position.altitude.kind:
                             position.altitude.value},
            },
            "frame": {
                "direction": frame.direction, "tilt": frame.tilt,
                "fov": frame.fov, "max_distance": frame.max_distance,
            },
            "coloring": coloring,
            "fog_distance": config.view.fog_distance,
        },
        "model": config.earth_shape.to_config(),
        "env_raw": encode_environment(
            shape.radius, atmosphere_def_to_dict(config.atmosphere),
            config.wavelength,
        ),
        "straight_rays": config.straight_rays,
        "simulation_step": config.simulation_step,
        "output": config.output.to_config(),
    }


def _encode_reference(config: Config, result: RenderResult, terrain) -> bytes:
    from .bincode import encode_alldata

    params = reference_params_dict(config, terrain)
    elev = np.asarray(result.elevation_deg, np.float64)
    az = np.asarray(result.azimuth_deg, np.float64)
    h, w, _ = result.hits.valid.shape
    if elev.ndim == 1:  # Fast generator: separable angle grids
        elev = np.broadcast_to(elev[:, None], (h, w))
    if az.ndim == 1:
        az = np.broadcast_to(az[None, :], (h, w))
    return encode_alldata(params, elev, az, result.hits)


def _savez(fh, config, result, hits):
    import yaml

    from ..generators.base import fetch_flat_many

    (bits, count, key_c, dlat_c, dlon_c, el_c, pl_c, normal_c, kind_c,
     rgba_c) = _pack_artifact(
        jnp.asarray(hits.valid), jnp.asarray(hits.key),
        jnp.asarray(hits.dlat), jnp.asarray(hits.dlon),
        jnp.asarray(hits.elevation), jnp.asarray(hits.path_length),
        jnp.asarray(hits.normal), jnp.asarray(hits.kind),
        jnp.asarray(hits.rgba),
    )
    n = int(jax.device_get(count))
    # ONE shared-pool staging of the compact segments (pipelined transfers;
    # generators/base.py fetch notes)
    flats = fetch_flat_many(
        (bits, key_c[:n], dlat_c[:n], dlon_c[:n], el_c[:n], pl_c[:n],
         normal_c[:n], kind_c[:n], rgba_c[:n])
    )
    bits_h, key_h, dlat_h, dlon_h, el_h, pl_h, nrm_h, kind_h, rgba_h = flats

    np.savez_compressed(
        fh,
        format_version=np.int32(FORMAT_VERSION),
        config_yaml=np.frombuffer(
            yaml.safe_dump(config.to_dict()).encode(), dtype=np.uint8
        ),
        observer=np.asarray(result.observer, np.float64),
        elevation_deg=np.asarray(result.elevation_deg, np.float64),
        azimuth_deg=np.asarray(result.azimuth_deg, np.float64),
        shape=np.asarray(hits.valid.shape, np.int64),
        bits=bits_h.astype(np.uint32, copy=False),
        key=key_h.astype(np.float32, copy=False),
        dlat=dlat_h.astype(np.float32, copy=False),
        dlon=dlon_h.astype(np.float32, copy=False),
        elevation=el_h.astype(np.float32, copy=False),
        path_length=pl_h.astype(np.float32, copy=False),
        normal=nrm_h.reshape(n, 3).astype(np.float32, copy=False),
        kind=kind_h.astype(np.uint8, copy=False),
        rgba=rgba_h.reshape(n, 4).astype(np.float32, copy=False),
    )


def _unpack_v2(z, step: float) -> HitBuffer:
    """Host inverse of :func:`_pack_artifact`: bitmask → dense planes."""
    from ..ops.combine import NO_HIT

    shape = tuple(int(s) for s in z["shape"])
    p = int(np.prod(shape))
    bits = np.asarray(z["bits"], np.uint32)
    vflat = (
        (bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(-1)[:p]

    def expand(seg, fill, dtype, extra=()):
        out = np.full((p,) + extra, fill, dtype)
        out[vflat] = seg
        return out.reshape(shape + extra)

    key = expand(z["key"], NO_HIT, np.float32)
    return HitBuffer(
        valid=vflat.reshape(shape),
        key=key,
        dlat=expand(z["dlat"], 0, np.float32),
        dlon=expand(z["dlon"], 0, np.float32),
        # the device hit paths' exact expression (see module docstring)
        distance=(
            np.where(vflat.reshape(shape), key, np.float32(0.0))
            * np.float32(step)
        ).astype(np.float32),
        elevation=expand(z["elevation"], 0, np.float32),
        path_length=expand(z["path_length"], 0, np.float32),
        normal=expand(z["normal"], 0, np.float32, (3,)),
        kind=expand(z["kind"].astype(np.int32), 0, np.int32),
        rgba=expand(z["rgba"], 0, np.float32, (4,)),
    )


def load_metadata(path) -> Tuple[Config, RenderResult]:
    """Load a metadata artifact: native npz OR a reference bincode ``.dat``.

    The format is sniffed from the magic bytes — gzip (``\\x1f\\x8b``) or a
    raw (uncompressed) bincode blob routes through :mod:`.bincode`
    (decode_alldata handles both; generator/mod.rs:26-45); zip magic
    (``PK``) is our npz.
    """
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic != b"PK":  # npz is a zip archive; everything else is bincode
        return _load_bincode(path)
    import yaml

    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"metadata format v{version} is newer than supported")
        config = Config.from_dict(yaml.safe_load(bytes(z["config_yaml"]).decode()))
        if version >= 2:
            hits = _unpack_v2(z, float(config.simulation_step))
        else:  # v1: dense [H, W, K] planes stored verbatim
            hits = HitBuffer(
                valid=z["valid"],
                key=z["key"],
                dlat=z["dlat"],
                dlon=z["dlon"],
                distance=z["distance"],
                elevation=z["elevation"],
                path_length=z["path_length"],
                normal=z["normal"],
                kind=z["kind"],
                rgba=z["rgba"],
            )
        result = RenderResult(
            image=None,  # re-rendered by the viewer
            hits=hits,
            elevation_deg=z["elevation_deg"],
            azimuth_deg=z["azimuth_deg"],
            observer=tuple(z["observer"]),
        )
    return config, result


def _invert_light_dir(light, model, position: dict, direction_deg: float):
    """World light vector → (zenith_angle°, light_dir°) such that
    ConfColoring.into_coloring reproduces the vector exactly.

    The lowering (params.rs:240-258) is light = −front·sinZ·cosL +
    right·sinZ·sinL + up·cosZ in the observer's view basis, which inverts as
    Z = acos(light·up), L = atan2(light·right, −light·front).
    """
    import math as _math

    north, east, up = model.world_directions(
        position["latitude"], position["longitude"]
    )
    az = _math.radians(direction_deg)
    front = north * _math.cos(az) + east * _math.sin(az)
    right = east * _math.cos(az) - north * _math.sin(az)
    light = np.asarray(light, np.float64)
    light = light / np.linalg.norm(light)  # lowered vectors are unit (params.rs:257)
    zen = _math.degrees(_math.acos(float(np.clip(np.dot(light, up), -1, 1))))
    ldir = _math.degrees(
        _math.atan2(float(np.dot(light, right)), float(-np.dot(light, front)))
    )
    return zen, ldir


def _load_bincode(path) -> Tuple[Config, RenderResult]:
    """Reference-artifact load path (see meta/bincode.py for the layout)."""
    from ..models.earth import EarthModel
    from .bincode import decode_alldata

    with open(path, "rb") as fh:
        params, elev, az, hits = decode_alldata(fh.read())

    view = params["view"]
    coloring = view["coloring"]
    if "Shading" in coloring:
        s = coloring["Shading"]
        model = EarthModel.from_config(params["model"])
        zen, ldir = _invert_light_dir(
            s["light_dir_world"], model, view["position"],
            view["frame"]["direction"],
        )
        conf_coloring = {"Shading": {
            "water_level": s["water_level"],
            "ambient_light": s["ambient_light"],
            "light_zenith_angle": zen,
            "light_dir": ldir,
            "palette": s["palette"],
        }}
    else:
        conf_coloring = {"Simple": {
            "water_level": coloring["Simple"]["water_level"],
        }}

    objects = []
    for ob in params["scene"]["objects"]:
        objects.append({
            "position": {
                "latitude": ob["position"]["lat"],
                "longitude": ob["position"]["lon"],
                "altitude": {"Absolute": ob["position"]["elev"]},
            },
            "shape": ob["shape"],
            "color": ob["color"],
        })

    d = {
        "scene": {
            "terrain_folder": params["scene"]["terrain_folder"],
            "objects": objects,
            "terrain_alpha": params["scene"]["terrain_alpha"],
        },
        "view": {
            "position": view["position"],
            "frame": view["frame"],
            "coloring": conf_coloring,
        },
        # the atm-refraction Environment bytes are opaque (out-of-tree crate;
        # meta/bincode.py) — the viewer does not re-trace rays, so the
        # default US-76 stands in for display purposes only
        "earth_shape": params["model"],
        "straight_rays": params["straight_rays"],
        "simulation_step": params["simulation_step"],
        "output": params["output"],
    }
    if view.get("fog_distance") is not None:
        d["view"]["fog_distance"] = view["fog_distance"]
    config = Config.from_dict(d)

    pos = view["position"]
    ((alt_kind, alt_value),) = pos["altitude"].items()
    result = RenderResult(
        image=None,
        hits=hits,
        elevation_deg=elev,
        azimuth_deg=az,
        # Relative altitude needs terrain the artifact does not carry; the
        # reference viewer has the same limitation (unwrap_or(0.0))
        observer=(pos["latitude"], pos["longitude"], float(alt_value)),
    )
    return config, result
