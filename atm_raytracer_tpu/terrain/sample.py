"""Device-side terrain sampling: vectorized bilinear gather + surface normals.

Replaces the per-point host lookups of the reference hot path:
``Terrain::get_elev`` (terrain/mod.rs:120-126, geotiff.rs:61-100 bilinear) and
``find_normal`` (generators/utils.rs:15-40, central differences ±15 m in the
local ENU frame).

Positions arrive as f32 *deltas from the observer* (see models.earth); the
observer's absolute position enters through compile-time-constant floor/frac
parts, so tile-local coordinates keep full f32 precision.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax.numpy as jnp

from ..models.earth import EarthModel, NORMAL_DIFF
from .store import TerrainPack


def _locate(pack: TerrainPack, dlat, dlon, lat0: float, lon0: float):
    """Map observer-relative degrees to (validity, tile slot coords, cell
    indices, cell fractions, per-tile scales) — the shared prologue of every
    sampling path (plain quad, paired win4)."""
    lat0_floor = math.floor(lat0)
    lon0_floor = math.floor(lon0)
    a_lat = jnp.float32(lat0 - lat0_floor) + dlat  # tile-continuous coordinate
    a_lon = jnp.float32(lon0 - lon0_floor) + dlon
    cell_lat = jnp.floor(a_lat)
    cell_lon = jnp.floor(a_lon)
    local_lat = a_lat - cell_lat  # in [0, 1)
    local_lon = a_lon - cell_lon

    row_cell = cell_lat.astype(jnp.int32) + (lat0_floor - pack.lat_min)
    col_cell = cell_lon.astype(jnp.int32) + (lon0_floor - pack.lon_min)
    n_rows, n_cols = pack.n_rows, pack.n_cols
    valid = (
        (row_cell >= 0) & (row_cell < n_rows) & (col_cell >= 0) & (col_cell < n_cols)
    )
    row_c = jnp.clip(row_cell, 0, n_rows - 1)
    col_c = jnp.clip(col_cell, 0, n_cols - 1)
    # dense grid: tile slot is pure arithmetic (no index-table gather);
    # missing tiles are all-zero slots = the reference's 0.0 fallback
    t = row_c * n_cols + col_c

    if pack.uniform is not None:  # one tile shape → compile-time scales
        t_rows_m1 = jnp.float32(pack.uniform[0])
        t_cols_m1 = jnp.float32(pack.uniform[1])
    else:
        t_rows_m1 = pack.rows_m1[t]
        t_cols_m1 = pack.cols_m1[t]
    r = local_lat * t_rows_m1
    c = local_lon * t_cols_m1
    ri = jnp.minimum(jnp.floor(r), t_rows_m1 - 1.0).astype(jnp.int32)
    ci = jnp.minimum(jnp.floor(c), t_cols_m1 - 1.0).astype(jnp.int32)
    rf = r - ri.astype(jnp.float32)
    cf = c - ci.astype(jnp.float32)
    # raw (unclipped) tile cells ride along for the paired sampler: an
    # out-of-mosaic sample must root its shared window at the NEAREST
    # boundary post cell, not at the tile-clipped slot (whose in-next-tile
    # fraction would park the window a full tile away from a valid partner)
    return (valid, t, row_c, col_c, t_rows_m1, t_cols_m1, ri, ci, rf, cf,
            row_cell, col_cell)


def sample_elevation(
    pack: TerrainPack,
    dlat: jnp.ndarray,
    dlon: jnp.ndarray,
    lat0: float,
    lon0: float,
    with_gradient: bool = False,
    paired: bool | int = False,
):
    """Bilinear elevation at (lat0+dlat, lon0+dlon); missing tiles → 0.0.

    dlat/dlon: f32 arrays (any shape), degrees relative to the observer.
    lat0/lon0: observer absolute position (python floats, static).
    with_gradient: also return (dE/dlat, dE/dlon) in meters per degree — the
    exact gradient of the sampled bilinear patch, reusing the same 4 taps.
    paired: group size G (int ≥ 2, or True for G=2): G consecutive entries
    along the LAST axis span <2 post cells (caller must have checked
    ``sample_group``) — serve each group from ONE win4 gather row (1/G the
    launches, bit-identical taps).
    """
    group = 2 if paired is True else int(paired or 0)
    if group >= 2:
        return _sample_elevation_grouped(
            pack, dlat, dlon, lat0, lon0, with_gradient, group
        )
    (valid, t, row_c, col_c, t_rows_m1, t_cols_m1, ri, ci, rf, cf,
     _, _) = _locate(pack, dlat, dlon, lat0, lon0)
    s = pack.tile_s or pack.tiles.shape[1]
    base = t * (s * s) + ri * s + ci
    if pack.quad is not None:
        # one 8-byte-row gather delivers the whole 2×2 footprint (int16
        # posts packed into two int32 lanes; see TerrainPack quad layout)
        packed = jnp.take(pack.quad, base, axis=0)  # [..., 2]
        row0 = packed[..., 0]
        row1 = packed[..., 1]
        # sign-extending unpack: low lane via <<16 >>16 (arithmetic), high
        # lane via >>16
        e00 = ((row0 << 16) >> 16).astype(jnp.float32)
        e01 = (row0 >> 16).astype(jnp.float32)
        e10 = ((row1 << 16) >> 16).astype(jnp.float32)
        e11 = (row1 >> 16).astype(jnp.float32)
    else:
        flat = pack.tiles.reshape(-1)
        # tiles may be int16 (integer-meter terrain, half the gather bytes)
        e00 = jnp.take(flat, base).astype(jnp.float32)
        e10 = jnp.take(flat, base + s).astype(jnp.float32)
        e01 = jnp.take(flat, base + 1).astype(jnp.float32)
        e11 = jnp.take(flat, base + s + 1).astype(jnp.float32)
    return _combine_taps(
        e00, e01, e10, e11, rf, cf, valid, t_rows_m1, t_cols_m1, with_gradient
    )


def _combine_taps(e00, e01, e10, e11, rf, cf, valid, t_rows_m1, t_cols_m1,
                  with_gradient):
    """Bilinear value (+ exact patch gradient) from the four cell taps."""
    elev = (
        e00 * (1 - rf) * (1 - cf)
        + e10 * rf * (1 - cf)
        + e01 * (1 - rf) * cf
        + e11 * rf * cf
    )
    if not with_gradient:
        return jnp.where(valid, elev, 0.0)
    # d(elev)/d(row coord) and /d(col coord), scaled to per-degree
    de_dr = (e10 - e00) * (1 - cf) + (e11 - e01) * cf
    de_dc = (e01 - e00) * (1 - rf) + (e11 - e10) * rf
    de_dlat = de_dr * t_rows_m1
    de_dlon = de_dc * t_cols_m1
    zero = jnp.zeros_like(elev)
    return (
        jnp.where(valid, elev, 0.0),
        jnp.where(valid, de_dlat, zero),
        jnp.where(valid, de_dlon, zero),
    )


def sample_group(pack: TerrainPack, model: EarthModel, lat0: float,
                 step_m: float, max_dist_m: float, max_group: int = 6) -> int:
    """Static group size for the grouped win4 sampler: the largest G such
    that G consecutive samples ``step_m`` apart along any geodesic span
    <2 post cells on BOTH axes — the 4×4 win4 window then covers all G
    bilinear footprints (|Δfloor| ≤ ceil(Δu) ≤ 2 when Δu < 2 post units).
    Returns 1 when grouping is unavailable (no win4) or unsafe. Gather
    LAUNCHES, not bytes, bound the terrain stage, so larger G is a direct
    1/G cut of the [W, N] scan's gather cost (e.g. 50 m steps on 3" tiles:
    ~0.83 cells/step → G=3)."""
    if pack.win4 is None or pack.uniform is None:
        return 1
    rate_lat, rate_lon = model.max_deg_rates(lat0, max_dist_m)
    cells_lat = step_m * rate_lat * pack.uniform[0]  # posts per step, lat
    cells_lon = step_m * rate_lon * pack.uniform[1]
    cells = max(cells_lat, cells_lon)
    for g in range(max_group, 1, -1):
        if (g - 1) * cells < 1.98:
            return g
    return 1


def paired_step_ok(pack: TerrainPack, model: EarthModel, lat0: float,
                   step_m: float, max_dist_m: float) -> bool:
    """True when at least pair-of-2 grouping is safe (see sample_group)."""
    return sample_group(pack, model, lat0, step_m, max_dist_m) >= 2


def _sample_elevation_grouped(
    pack: TerrainPack,
    dlat: jnp.ndarray,
    dlon: jnp.ndarray,
    lat0: float,
    lon0: float,
    with_gradient: bool = False,
    group: int = 2,
):
    """``sample_elevation`` for grids whose LAST axis walks a geodesic in
    small steps (``sample_group``): each run of ``group`` consecutive
    samples shares ONE 32-byte win4 row — 1/G the gather launches of the
    quad path, with bit-identical taps (win4 is built from the same posts;
    an interior_seam of 0 certifies the global grid agrees with every
    tile-local cell).
    """
    (valid, t, row_c, col_c, t_rows_m1, t_cols_m1, ri, ci, rf, cf,
     row_cell, col_cell) = _locate(pack, dlat, dlon, lat0, lon0)
    nr_m1 = int(pack.uniform[0])
    nc_m1 = int(pack.uniform[1])
    GC = pack.g_cols
    GR = pack.n_rows * nr_m1 + 1
    # global post-grid cell root from the RAW tile cell, clipped to the
    # grid: identical to row_c·nr_m1+ri for every in-mosaic sample, and an
    # out-of-mosaic sample (masked to 0 downstream) lands on the nearest
    # boundary cell — within 2 posts of a valid pair partner, so the shared
    # 4×4 window still covers the partner's true footprint
    gi = jnp.clip(row_cell * nr_m1 + ri, 0, GR - 2)  # [.., N]
    gj = jnp.clip(col_cell * nc_m1 + ci, 0, GC - 2)

    n = dlat.shape[-1]
    g_n = int(group)
    pad = (-n) % g_n  # short tails repeat the last sample
    lead = dlat.shape[:-1]

    # the group axis must NEVER be a minor tensor dimension: [.., P, G]
    # forms drag every elementwise op into G-lane-minor layouts (measured
    # ~45 ms of relayout/broadcast at 1080p/200 km). Split each group into
    # G strided [.., P] planes instead, extract taps per element, and
    # interleave only the four final tap planes back to [.., N].
    def parts(x):
        if pad:
            x = jnp.concatenate([x] + [x[..., -1:]] * pad, axis=-1)
        return [x[..., g::g_n] for g in range(g_n)]

    gis = parts(gi)
    gjs = parts(gj)
    ai = functools.reduce(jnp.minimum, gis)
    aj = functools.reduce(jnp.minimum, gjs)
    ai = jnp.clip(ai, 0, GR - 4)
    aj = jnp.clip(aj, 0, GC - 4)
    rows = jnp.take(pack.win4, ai * GC + aj, axis=0)  # [.., P, 8]
    rows_pl = [rows[..., k] for k in range(8)]  # 8 × [.., P] lane planes
    ois = [jnp.clip(g_, 0, 2) for g_ in (x - ai for x in gis)]  # [.., P] 0..2
    ojs = [jnp.clip(g_, 0, 2) for g_ in (x - aj for x in gjs)]

    def tap_elem(oi_e, oj_e, a, b):
        # post (oi+a, oj+b) of one group element from the 4×4 row:
        # lane 2r+c2 holds cols (2c2, 2c2+1) of window row r
        r = oi_e + a
        c = oj_e + b
        lane = 2 * r + (c >> 1)  # [.., P] in 0..7
        word = rows_pl[0]
        for k in range(1, 8):
            word = jnp.where(lane == k, rows_pl[k], word)
        # sign-extending 16-bit unpack (same trick as the quad path)
        return jnp.where((c & 1) == 1, word >> 16, (word << 16) >> 16)

    def tap(a, b):
        vs = [tap_elem(ois[g], ojs[g], a, b) for g in range(g_n)]
        x = jnp.stack(vs, axis=-1).reshape(lead + (-1,))
        return (x[..., :n] if pad else x).astype(jnp.float32)

    e00 = tap(0, 0)
    e01 = tap(0, 1)
    e10 = tap(1, 0)
    e11 = tap(1, 1)
    return _combine_taps(
        e00, e01, e10, e11, rf, cf, valid, t_rows_m1, t_cols_m1, with_gradient
    )


def sample_terrain_data(
    pack: TerrainPack,
    model: EarthModel,
    dlat: jnp.ndarray,
    dlon: jnp.ndarray,
    lat0: float,
    lon0: float,
    normal_mode: str = "gradient",
    paired: bool | int = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Elevation + outward surface normal at each point.

    ``paired`` (gradient mode only; an int group size from ``sample_group``,
    or True for pairs) serves runs of G consecutive samples along the LAST
    axis from one win4 gather row each — bit-identical taps, 1/G launches.

    normal_mode:
      * "gradient" (default): normal from the exact gradient of the sampled
        bilinear terrain patch — reuses the elevation taps, zero extra
        gathers. This is the analytic limit of the reference's central
        difference as the arm length → 0 (the reference's ±15 m arms cost
        4 extra bilinear samples per point, 5× the gather traffic of the
        whole terrain stage).
      * "reference": the reference's find_normal (utils.rs:15-40) — central
        differences of elevation ±15 m N/S/E/W via closed-form angular
        offsets (models.earth.normal_offsets). Differs from "gradient" only
        where the arms straddle post-cell boundaries (a mild smoothing).

    Both compose the normal in the *global* cartesian frame via
    world_directions at the point: normal = normalize(vec_ew × vec_ns).
    Returns (elev [...], normal [..., 3]).
    """
    lat_abs = jnp.float32(lat0) + dlat
    lon_abs = jnp.float32(lon0) + dlon
    north, east, up = model.world_directions(lat_abs, lon_abs, xp=jnp)
    if normal_mode == "gradient":
        elev, de_dlat, de_dlon = sample_elevation(
            pack, dlat, dlon, lat0, lon0, with_gradient=True, paired=paired
        )
        # meters-per-degree along the model's meridian/parallel at this point
        off_lat, off_lon = model.normal_offsets(lat_abs)  # deg per NORMAL_DIFF m
        m_per_deg_lat = NORMAL_DIFF / off_lat
        m_per_deg_lon = NORMAL_DIFF / off_lon
        slope_n = de_dlat / m_per_deg_lat  # dz per meter north
        slope_e = de_dlon / m_per_deg_lon
        vec_ns = north + slope_n[..., None] * up
        vec_ew = east + slope_e[..., None] * up
    else:
        elev = sample_elevation(pack, dlat, dlon, lat0, lon0)
        off_lat, off_lon = model.normal_offsets(lat_abs)
        e_n = sample_elevation(pack, dlat + off_lat, dlon, lat0, lon0)
        e_s = sample_elevation(pack, dlat - off_lat, dlon, lat0, lon0)
        e_e = sample_elevation(pack, dlat, dlon + off_lon, lat0, lon0)
        e_w = sample_elevation(pack, dlat, dlon - off_lon, lat0, lon0)
        diff_ns = (e_n - e_s)[..., None]
        diff_ew = (e_e - e_w)[..., None]
        vec_ns = 2.0 * NORMAL_DIFF * north + diff_ns * up
        vec_ew = 2.0 * NORMAL_DIFF * east + diff_ew * up
    normal = jnp.cross(vec_ew, vec_ns)
    norm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    return elev, normal / jnp.maximum(norm, 1e-30)
