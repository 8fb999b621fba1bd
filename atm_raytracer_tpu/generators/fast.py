"""Fast generator: the separable path×terrain tensor program.

Reference: src/generator/generators/fast.rs — pixel (x, y) maps to
azimuth(x) and elevation(y) independently (fast.rs:111-125), so one path
march per row and one terrain scan per column suffice (fast.rs:27-44), then a
W×H combine (fast.rs:52-92).

Device shape of the same idea:
  1. march all H row-rays in lockstep      → ray_h [H, N], path_len [H, N]
  2. geodesic + terrain gather per column  → terr [W, N], normals [W, N, 3]
  3. dense crossing-detection combine      → keys [H, W, K]
  4. field gathers at the keys             → HitBuffer
  5. coloring + compositing                → u8 image
Steps 1-5 are one jit program; the host only packs terrain tiles and builds
the refraction table.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..models import camera
from ..models.earth import EarthModel
from ..ops import combine
from ..ops.composite import composite
from ..physics.ray import EarthShape, RefractionTable, march_coarse, march_rays
from ..terrain.sample import sample_group, sample_terrain_data
from ..terrain.store import Terrain, TerrainPack
from .base import HitBuffer, RenderResult
from ..ops.objects import (
    ObjectSet,
    object_col_windows,
)


def terrain_bbox(params: Params) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Lat/lon box the render can touch: observer ± max_distance + margin."""
    lat0 = params.view.position.latitude
    lon0 = params.view.position.longitude
    # conservative meters-per-degree lower bound 90 km (covers flat models'
    # 111.1 km and high-latitude longitude shrink)
    d_deg = params.view.frame.max_distance / 90_000.0 + 0.1
    # longitude shrink at the MOST POLEWARD latitude the render can reach
    # (a fixed clamp under-sized the box past ~78° and tiles silently fell
    # back to elevation 0); past ~89.4° cover all longitudes
    lat_pole = min(abs(lat0) + d_deg, 90.0)
    coslat = max(0.01, math.cos(math.radians(lat_pole)))
    d_lon = min(d_deg / coslat, 180.0)
    return (lat0 - d_deg, lat0 + d_deg), (lon0 - d_lon, lon0 + d_lon)


_table_cache: dict = {}

# ObjectSet + column-window memo per Params object: repeat renders of one
# lowered Params (benchmarks, sweeps, viewer re-renders) skip the host
# geodesic scan and the device re-upload. Keyed by id() but guarded by a
# weakref identity check (CPython reuses freed addresses — the ADVICE r2
# stale-cache trap), and a weakref finalizer evicts dead entries. Inner key
# = the azimuth grid fingerprint + march length (the Fast camera and the
# Interpolating snapped grid differ).
import weakref

_objects_cache: dict = {}


def build_objects_cached(params, az_deg, n_terr: int):
    """(ObjectSet, col_windows) for params, memoized per Params + az grid."""
    if not params.objects:
        return None, None
    pid = id(params)
    entry = _objects_cache.get(pid)
    if entry is None or entry["ref"]() is not params:
        entry = {
            "ref": weakref.ref(
                params, lambda r, k=pid: _objects_cache.pop(k, None)
            ),
            "set": ObjectSet.build(params),
            "wins": {},
        }
        _objects_cache[pid] = entry
    az = np.asarray(az_deg)
    key = (az.shape[0], float(az[0]), float(az[-1]), n_terr)
    wins = entry["wins"].get(key)
    if wins is None:
        pos = params.view.position
        wins = object_col_windows(
            entry["set"], params.model, float(pos.latitude),
            float(pos.longitude), az, float(params.simulation_step), n_terr,
        )
        entry["wins"][key] = wins
    return entry["set"], wins


def build_refraction_table(params: Params, alt0: float) -> RefractionTable:
    """Size the l(h) table to cover every altitude the march can visit.

    Memoized per (atmosphere CONTENT, wavelength, range): repeat renders of
    the same lowered Params (benchmarks, sweeps, interactive sessions) skip
    the host-side f64 profile evaluation + device upload. Keyed on the
    hashable ``AtmosphereDef`` — not ``id(atmosphere)``, whose address
    CPython reuses after GC, which could silently serve a stale l(h) table
    to a different atmosphere in sequential multi-config sessions.
    """
    max_elev_deg = abs(params.view.frame.tilt) + params.view.frame.fov  # slack
    top = alt0 + math.tan(math.radians(min(max_elev_deg, 89.0))) * (
        params.view.frame.max_distance
    )
    h_hi = float(min(max(20_000.0, top * 1.1 + 1000.0), 90_000.0))
    key = (params.atmosphere_def, float(params.wavelength), h_hi)
    cached = _table_cache.get(key)
    if cached is None:
        cached = RefractionTable.build(
            params.atmosphere, params.wavelength, h_lo=-2000.0, h_hi=h_hi,
            dh=1.0,
        )
        while len(_table_cache) > 16:  # bound device-resident tables:
            # evict oldest (insertion order), not clear() — clearing would
            # defeat the memo exactly for multi-config sweep sessions
            _table_cache.pop(next(iter(_table_cache)))
        _table_cache[key] = cached
    return cached


def separable_hits(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    objects: Optional[ObjectSet],
    elev_deg: jnp.ndarray,  # [H]
    az_deg: jnp.ndarray,  # [W]
    alt0,
    *,
    model: EarthModel,
    shape: EarthShape,
    straight: bool,
    step: float,
    n_terr: int,
    max_hits: int,
    lat0: float,
    lon0: float,
    terrain_alpha: float,
    obj_windows=None,  # static per-object (col_lo, n) tuples; None = full W
    with_progress: bool = False,
    march=None,  # optional precomputed (ray_h [H,N], path_len [H,N])
    obj_hit_cap: Optional[int] = None,  # see _separable_hit_planes
) -> HitBuffer:
    """Hits on the separable (elevation-row × azimuth-column) product grid.

    Shared by the Fast generator (camera rows/columns) and the
    InterpolatingRectilinear generator (snapped angular grid).

    ``march``: a precomputed (ray_h, path_len) pair — the banded/streamed
    render marches ONCE and shares the row cache across column bands
    (exactly the reference's per-row path cache reuse, fast.rs:38-44).

    Scene-object frames route through the plane-first twin
    ``_separable_hit_planes`` — the object merge's slice/concat consumers
    drive XLA into padded K-minor layouts on any [H, W, K(,D)] tensor, so
    for those frames no such tensor may exist before the output stack."""
    if objects is not None:
        return _separable_hit_planes(
            pack, table, objects, elev_deg, az_deg, alt0,
            model=model, shape=shape, straight=straight, step=step,
            n_terr=n_terr, max_hits=max_hits, lat0=lat0, lon0=lon0,
            terrain_alpha=terrain_alpha, obj_windows=obj_windows,
            with_progress=with_progress, obj_hit_cap=obj_hit_cap,
        )
    # 1. path cache: [H, n_terr] ray altitudes at x = k*step (march n_terr-1
    # steps; sample 0 is the observer) — gen_path_cache utils.rs:136-174.
    # Coarse RK4 + Hermite dense output caps the sequential chain at ~500m
    # granularity (parity with fine-step: tests/test_ray.py).
    if march is not None:
        ray_h, path_len = march
    else:
        coarse = march_coarse(step)
        ray_h, path_len = march_rays(
            alt0, jnp.deg2rad(elev_deg.astype(jnp.float32)), step, n_terr - 1,
            shape, table, straight, coarse=coarse, progress=with_progress,
        )

    # 2. terrain cache: geodesic per column × march step — utils.rs:176-199.
    # Elevation + normal share the same 4 bilinear taps (gradient mode), so
    # computing normals here is nearly free vs. re-gathering at hit points.
    dists = jnp.arange(n_terr, dtype=jnp.float32) * jnp.float32(step)
    dlat, dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[:, None], dists[None, :]
    )  # [W, n_terr]
    terr_elev, terr_normal = sample_terrain_data(
        pack, model, dlat, dlon, lat0, lon0,
        paired=sample_group(pack, model, lat0, step, n_terr * step),
    )

    # 3. crossing segments [H, W, K] (int32). The chunked XLA combine fuses
    # into sign-test + integer min — the fractional hit position is a
    # per-PIXEL quantity reconstructed below, keeping division out of the
    # H·W·N hot cube.
    n_seg = n_terr - 1
    segs = combine.terrain_crossing_segments(
        ray_h, terr_elev, n_seg, max_hits
    )
    valid = segs < n_seg
    ks = jnp.where(valid, segs, 0)

    # 4. field gathers (TracingState::interpolate semantics, utils.rs:108-133)
    # — paired-endpoint gathers shared between prop reconstruction and the
    # field lerps (contiguous multi-channel rows amortize the random access).
    # The column stack carries only elevation + normal (4 ch → 8 per
    # pair-row); the hit's dlat/dlon are re-derived per PIXEL from
    # (column azimuth, key·step) with the SAME geodesic the [W, N] cache was
    # built from — evaluating the curve at the lerped distance instead of
    # lerping the curve's endpoints (agreement ~1e-5 m over a 50 m segment,
    # the viewer's separable pack already round-trips positions this way).
    stacked = jnp.concatenate(
        [terr_elev[..., None], terr_normal], axis=-1
    )  # [W, N, 4]
    c_lo, c_hi = combine.gather_column_pairs(stacked, ks)  # [H, W, K, 4] ×2
    ray_stack = jnp.stack([ray_h, path_len], axis=-1)  # [H, N, 2]
    r_lo, r_hi = combine.gather_ray_pairs(ray_stack, ks)
    d1 = r_lo[..., 0] - c_lo[..., 0]
    d2 = r_hi[..., 0] - c_hi[..., 0]
    denom = d1 - d2
    prop = d1 / jnp.where(denom == 0.0, 1.0, denom)  # utils.rs:232
    keys = jnp.where(valid, ks.astype(jnp.float32) + prop, combine.NO_HIT)
    safe_keys = jnp.where(valid, keys, 0.0)

    hit_stack = c_lo * (1.0 - prop[..., None]) + c_hi * prop[..., None]
    hit_elev = hit_stack[..., 0]
    hit_normal = hit_stack[..., 1:4]
    hit_plen = r_lo[..., 1] * (1.0 - prop) + r_hi[..., 1] * prop
    hit_dist = safe_keys * jnp.float32(step)  # dist is linear in the key
    hit_dlat, hit_dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[None, :, None], hit_dist
    )  # [H, W, K] each

    h_n, w_n = elev_deg.shape[0], az_deg.shape[0]
    rgba = jnp.zeros((h_n, w_n, max_hits, 4), jnp.float32)
    rgba = rgba.at[..., 3].set(jnp.float32(terrain_alpha))
    hits = HitBuffer(
        valid=valid,
        key=keys,
        dlat=hit_dlat,
        dlon=hit_dlon,
        distance=hit_dist,
        elevation=hit_elev,
        path_length=hit_plen,
        normal=hit_normal,
        kind=jnp.zeros((h_n, w_n, max_hits), jnp.int32),
        rgba=rgba,
    )

    return hits


def _separable_hit_planes(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    objects: ObjectSet,
    elev_deg: jnp.ndarray,  # [H]
    az_deg: jnp.ndarray,  # [W]
    alt0,
    *,
    model: EarthModel,
    shape: EarthShape,
    straight: bool,
    step: float,
    n_terr: int,
    max_hits: int,
    lat0: float,
    lon0: float,
    terrain_alpha: float,
    obj_windows,
    with_progress: bool = False,
    obj_hit_cap: Optional[int] = None,
) -> HitBuffer:
    """Plane-first separable hits for scene-object frames.

    Identical semantics to ``separable_hits``, different tensor shapes: the
    crossing segments transpose to K-leading behind an optimization_barrier,
    payload endpoint gathers run channel-major (ONE take producing
    [2C, H, W]), and every downstream value is a [H, W] plane — so the
    object merge's slice/concat consumers can never force padded K-minor
    layouts (see ``separable_hits`` for the measured failure mode).
    """
    from ..ops.objects import apply_objects_planes
    from ..ops.objects import _planes_to_hb, _PLANE_CHANNELS

    coarse = march_coarse(step)
    ray_h, path_len = march_rays(
        alt0, jnp.deg2rad(elev_deg.astype(jnp.float32)), step, n_terr - 1,
        shape, table, straight, coarse=coarse, progress=with_progress,
    )
    dists = jnp.arange(n_terr, dtype=jnp.float32) * jnp.float32(step)
    dlat, dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[:, None], dists[None, :]
    )  # [W, n_terr]
    terr_elev, terr_normal = sample_terrain_data(
        pack, model, dlat, dlon, lat0, lon0,
        paired=sample_group(pack, model, lat0, step, n_terr * step),
    )

    n_seg = n_terr - 1
    segs = combine.terrain_crossing_segments(ray_h, terr_elev, n_seg, max_hits)
    # K-leading behind a barrier: layout assignment then materializes the
    # scan result with (H, W) minor — per-slot plane slices are free
    segs_t = jax.lax.optimization_barrier(jnp.moveaxis(segs, -1, 0))

    h_n, w_n = elev_deg.shape[0], az_deg.shape[0]
    # adjacent-pair row tables: ONE 32 B / 16 B row read per (pixel, slot)
    # delivers all channels at both segment endpoints instead of one
    # single-element gather per channel; only elevation + normal ride the
    # gathered rows; the hit's dlat/dlon re-derives per pixel from
    # (column azimuth, key·step) exactly as in ``separable_hits``
    col_stack = jnp.concatenate(
        [terr_elev[..., None], terr_normal], axis=-1
    )  # [W, N, 4]
    col_pairs = jnp.concatenate(
        [col_stack[:, :-1, :], col_stack[:, 1:, :]], axis=-1
    ).reshape(-1, 8)  # [W·(N-1), 8] lo-channels then hi-channels
    ray_pairs = jnp.stack(
        [ray_h[:, :-1], path_len[:, :-1], ray_h[:, 1:], path_len[:, 1:]],
        axis=-1,
    ).reshape(-1, 4)  # [H·(N-1), 4]
    n_col = terr_elev.shape[1]
    n_ray = ray_h.shape[1]
    w_iota = jax.lax.broadcasted_iota(jnp.int32, (h_n, w_n), 1)
    h_iota = jax.lax.broadcasted_iota(jnp.int32, (h_n, w_n), 0)

    planes = {nm: [] for nm in ("key",) + _PLANE_CHANNELS}
    zero = jnp.zeros((h_n, w_n), jnp.float32)
    for k in range(max_hits):
        sk = segs_t[k]
        valid_k = sk < n_seg
        ks = jnp.clip(sk, 0, min(n_col, n_ray) - 2)
        # row gathers, transposed channel-leading behind a barrier so only
        # the clean [C, H, W] form materializes (a [H, W, 12]-minor tensor
        # under plane-slice consumers pads ~10× — see the docstring)
        row_c = jnp.take(col_pairs, w_iota * (n_col - 1) + ks, axis=0)
        gc = jax.lax.optimization_barrier(jnp.moveaxis(row_c, -1, 0))
        # [8, H, W]: channels (elev,n0,n1,n2) lo then hi
        row_r = jnp.take(ray_pairs, h_iota * (n_ray - 1) + ks, axis=0)
        gr = jax.lax.optimization_barrier(jnp.moveaxis(row_r, -1, 0))
        # [4, H, W]: (ray_h, path_len) lo then (ray_h, path_len) hi
        d1 = gr[0] - gc[0]
        d2 = gr[2] - gc[4]
        denom = d1 - d2
        prop = d1 / jnp.where(denom == 0.0, 1.0, denom)  # utils.rs:232
        keyf = ks.astype(jnp.float32) + prop
        lerp = lambda lo, hi: jnp.where(
            valid_k, lo * (1.0 - prop) + hi * prop, 0.0
        )
        hd_lat, hd_lon = model.geodesic_delta(
            lat0, lon0, az_deg.astype(jnp.float32)[None, :],
            jnp.where(valid_k, keyf * jnp.float32(step), 0.0),
        )
        planes["key"].append(jnp.where(valid_k, keyf, combine.NO_HIT))
        planes["dlat"].append(jnp.where(valid_k, hd_lat, 0.0))
        planes["dlon"].append(jnp.where(valid_k, hd_lon, 0.0))
        planes["elevation"].append(lerp(gc[0], gc[4]))
        planes["nx"].append(lerp(gc[1], gc[5]))
        planes["ny"].append(lerp(gc[2], gc[6]))
        planes["nz"].append(lerp(gc[3], gc[7]))
        planes["path_length"].append(lerp(gr[1], gr[3]))
        planes["distance"].append(
            jnp.where(valid_k, keyf * jnp.float32(step), 0.0)
        )
        planes["kind"].append(zero)
        planes["cr"].append(zero)
        planes["cg"].append(zero)
        planes["cb"].append(zero)
        planes["ca"].append(
            jnp.where(valid_k, jnp.float32(terrain_alpha), 0.0)
        )

    # Slot budget: a ray can only hit objects whose static column window
    # contains its column, so depth follows the deepest window overlap
    # (exact for scattered scenes). When >3 windows stack on one column the
    # default caps at 6 extra layers — compositing is visually saturated
    # past that for any alpha the grammar can express, but metadata depth
    # IS truncated there (the reference keeps all trace points); raise
    # ATM_RAYTRACER_OBJ_HIT_CAP when full depth matters more than the
    # plane-count compile/memory cost (14 channels × k_out planes).
    from ..ops.objects import max_window_overlap

    # resolved by render_fast and threaded through the jit as a STATIC arg
    # (an env read at trace time would be invisible to the jit cache key —
    # a raised cap after a same-shape render would silently reuse the old
    # compiled program); the env fallback covers direct callers
    cap = (obj_hit_cap if obj_hit_cap is not None
           else int(os.environ.get("ATM_RAYTRACER_OBJ_HIT_CAP", "6")))
    overlap = max_window_overlap(obj_windows, objects.n_objects)
    if 2 * overlap > max(cap, 2):
        # loud, host-side, once per cap value: the reference keeps ALL
        # trace points (utils.rs:241-279); our fixed-slot buffer drops the
        # deepest hits where >cap/2 object windows stack on one column
        import warnings

        warnings.warn(
            f"object metadata depth truncated: {overlap} object windows "
            f"overlap one column (needs {2 * overlap} slots) but "
            f"ATM_RAYTRACER_OBJ_HIT_CAP={cap}; hits beyond the cap are "
            "dropped from metadata (compositing is visually saturated by "
            "then). Raise ATM_RAYTRACER_OBJ_HIT_CAP to keep full depth.",
            stacklevel=2,
        )
    k_out = max_hits + min(2 * overlap, max(cap, 2))
    planes = apply_objects_planes(
        planes, objects, model, lat0, lon0, step,
        ray_h, path_len, dlat, dlon, obj_windows, k_out,
    )
    return _planes_to_hb(planes)


def fast_core(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    objects: Optional[ObjectSet],
    elev_deg: jnp.ndarray,  # [H]
    az_deg: jnp.ndarray,  # [W]
    alt0,
    light_dir=None,  # traced per-frame light override (batched sweeps)
    *,
    model: EarthModel,
    shape: EarthShape,
    straight: bool,
    step: float,
    n_terr: int,
    max_hits: int,
    lat0: float,
    lon0: float,
    coloring,
    fog_distance: Optional[float],
    terrain_alpha: float,
    obj_windows=None,
    with_progress: bool = False,
    march=None,
    obj_hit_cap=None,
):
    """The whole Fast pipeline as one traceable function (vmappable for
    batched sweeps, shardable for multi-chip)."""
    hits = separable_hits(
        pack, table, objects, elev_deg, az_deg, alt0,
        model=model, shape=shape, straight=straight, step=step, n_terr=n_terr,
        max_hits=max_hits, lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha,
        obj_windows=obj_windows, with_progress=with_progress, march=march,
        obj_hit_cap=obj_hit_cap,
    )
    image = composite(
        coloring,
        fog_distance,
        hits.valid,
        hits.rgba[..., 3],
        hits.distance,
        hits.elevation,
        hits.path_length,
        hits.normal,
        hits.kind,
        hits.rgba[..., :3],
        light_dir=light_dir,
    )
    return image, hits


_render_fast_device = functools.partial(
    jax.jit,
    static_argnames=(
        "model", "shape", "straight", "step", "n_terr", "max_hits", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha", "obj_windows",
        "with_progress", "obj_hit_cap",
    ),
)(fast_core)


def render_fast(params: Params, terrain: Terrain,
                max_hits: Optional[int] = None,
                progress=None, fetch_image: bool = True) -> RenderResult:
    """Full Fast-generator render from lowered Params (fast.rs:22-98).

    ``progress`` (if given) receives whole-percent completion values — the
    device analog of the reference's per-percent pixel counter (fast.rs:78-87),
    emitted from the march scan on callback-capable backends and always
    closed with a final 100.

    ``fetch_image=False`` leaves ``result.image`` device-resident (callers
    that want to time or overlap the device→host transfer separately fetch
    it themselves via ``base.fetch_flat``).
    """
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)

    elev_deg = camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    az_deg = camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)

    lat_rng, lon_rng = terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4

    objset, obj_windows = build_objects_cached(params, az_deg, n_terr)

    from .base import callbacks_supported, set_progress_sink

    with_progress = progress is not None and callbacks_supported()
    set_progress_sink(progress)
    try:
        image, hits = _render_fast_device(
            pack,
            table,
            objset,
            jnp.asarray(elev_deg, jnp.float32),
            jnp.asarray(az_deg, jnp.float32),
            float(alt0),
            model=params.model,
            shape=params.model.to_shape(),
            straight=params.straight_rays,
            step=float(params.simulation_step),
            n_terr=n_terr,
            max_hits=int(max_hits),
            lat0=float(pos.latitude),
            lon0=float(pos.longitude),
            coloring=params.coloring,
            fog_distance=params.view.fog_distance,
            terrain_alpha=float(params.terrain_alpha),
            obj_windows=obj_windows,
            with_progress=with_progress,
            obj_hit_cap=int(os.environ.get("ATM_RAYTRACER_OBJ_HIT_CAP", "6")),
        )
        # fetch FLAT (base.fetch_flat: one transfer, or overlapped slices
        # for big frames)
        from .base import fetch_flat

        image_host = (
            fetch_flat(image).reshape(image.shape) if fetch_image else image
        )
    finally:
        set_progress_sink(None)
    if progress is not None:
        progress(100)  # close the counter (straight-ray path has no scan)
    return RenderResult(
        image=image_host,
        # hits stay on device: fetching ~14 fields × H×W×K is pure transfer
        # cost unless metadata is requested (save_metadata np.asarrays them)
        hits=hits,
        elevation_deg=elev_deg,
        azimuth_deg=camera.wrap_azimuth_deg(az_deg),
        observer=(pos.latitude, pos.longitude, alt0),
    )


_march_device = functools.partial(
    jax.jit,
    static_argnames=("step", "n_steps", "shape", "straight", "coarse"),
)(march_rays)


def _largest_band_divisor(w: int, bands: int) -> int:
    for b in range(min(bands, w), 0, -1):
        if w % b == 0:
            return b
    return 1


def render_fast_streamed(
    params: Params,
    terrain: Terrain,
    bands: int = 8,
    max_hits: Optional[int] = None,
    progress=None,
) -> RenderResult:
    """Banded Fast render: march once, combine per column band, STREAM.

    The Fast generator is separable (fast.rs:27-44): the per-row path cache
    is column-independent, so the frame splits into contiguous azimuth bands
    that share one march. Each band is dispatched asynchronously and its
    image slice fetched from the overlap pool while later bands still
    compute — so the device→host transfer hides behind device time
    instead of following it, and ``progress`` gets a monotone
    per-band percent even on backends that reject host callbacks (the
    reference's per-percent counter, fast.rs:78-87, without
    jax.debug.callback).

    Output is bit-identical to :func:`render_fast` up to XLA program-shape
    codegen (same ops, two dispatches instead of one — pinned by
    tests/test_e2e_fast.py::test_streamed_matches_plain). Scene-object
    frames fall back to the single-dispatch path: their per-object column
    windows are static per band and would compile one program per band.
    """
    if params.objects:
        return render_fast(params, terrain, max_hits=max_hits,
                           progress=progress)

    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)

    elev_deg = camera.fast_ray_elevations(
        out.width, out.height, frame.fov, frame.tilt
    )
    az_deg = camera.fast_ray_azimuths(
        out.width, out.height, frame.fov, frame.direction
    )

    lat_rng, lon_rng = terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4

    w = out.width
    b = _largest_band_divisor(w, max(1, int(bands)))
    wb = w // b
    shape = params.model.to_shape()
    step = float(params.simulation_step)

    march = _march_device(
        float(alt0), jnp.deg2rad(jnp.asarray(elev_deg, jnp.float32)),
        step=step, n_steps=n_terr - 1, shape=shape, table=table,
        straight=params.straight_rays, coarse=march_coarse(step),
    )

    from .base import fetch_pool, submit_fetch

    # band frames cross the link through the NO-SYNC compact codec
    # (meta/pack.py::pack_frame_stream): static shapes mean the fetch
    # submits right after the dispatch with no count round-trip, at
    # ~1.6 B/pixel vs 3 B raw. Exceptions are capped; a band whose counts
    # overflow (adversarial inputs only) falls back to a raw fetch of its
    # still-device-resident frame. ATM_RAYTRACER_COMPACT_STREAM=0 opts out.
    compact = os.environ.get("ATM_RAYTRACER_COMPACT_STREAM", "1") != "0"
    exc_cap = 256
    if compact:
        from ..meta.pack import (
            frame_base_rgb,
            pack_frame_stream,
            unpack_frame_stream,
        )

        sky = frame_base_rgb(params.coloring, params.view.fog_distance)

    az32 = jnp.asarray(az_deg, jnp.float32)
    band_hits = []
    band_imgs = []
    outs = []
    futs = []
    ex = fetch_pool()
    try:
        for i in range(b):
            image_b, hits_b = _render_fast_device(
                pack, table, None,
                jnp.asarray(elev_deg, jnp.float32),
                az32[i * wb:(i + 1) * wb],
                float(alt0),
                model=params.model, shape=shape,
                straight=params.straight_rays, step=step, n_terr=n_terr,
                max_hits=int(max_hits), lat0=float(pos.latitude),
                lon0=float(pos.longitude), coloring=params.coloring,
                fog_distance=params.view.fog_distance,
                terrain_alpha=float(params.terrain_alpha),
                march=march,
            )
            band_hits.append(hits_b)
            band_imgs.append(image_b)
            # the fetch thread blocks inside np.asarray until THIS band's
            # program completes, while the host loop keeps dispatching the
            # rest — transfers pipeline against later bands' device compute
            if compact:
                o, f = submit_fetch(
                    ex, pack_frame_stream(hits_b.valid, image_b, exc_cap)
                )
            else:
                o, f = submit_fetch(ex, (image_b.reshape(-1),))
            outs.append(o)
            futs.append(f)
        for i, fs in enumerate(futs):
            for f in fs:
                f.result()
            if progress is not None:
                progress(int(round(100.0 * (i + 1) / b)))
    finally:
        ex.shutdown(wait=True)

    if compact:
        slabs = []
        for i, o in enumerate(outs):
            bits_h, n_h, ei_h, ev_h, cts_h = o
            fr = unpack_frame_stream(
                bits_h, n_h, ei_h, ev_h, cts_h, sky, out.height, wb, exc_cap
            )
            if fr is None:  # exception-cap overflow: raw fallback
                from .base import fetch_flat

                fr = fetch_flat(band_imgs[i]).reshape(out.height, wb, 3)
            slabs.append(fr)
        image_host = np.concatenate(slabs, axis=1)
    else:
        image_host = np.concatenate(
            [o[0].reshape(out.height, wb, 3) for o in outs], axis=1
        )
    # hits re-join on device (one concat per field); metadata consumers see
    # the identical [H, W, K] buffers render_fast produces
    hits = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=1), *band_hits
    )
    return RenderResult(
        image=image_host,
        hits=hits,
        elevation_deg=elev_deg,
        azimuth_deg=camera.wrap_azimuth_deg(az_deg),
        observer=(pos.latitude, pos.longitude, alt0),
    )
