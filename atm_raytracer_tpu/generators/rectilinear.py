"""Rectilinear generator: exact pinhole lens, one ray + geodesic per pixel.

Reference: src/generator/generators/rectilinear.rs — per-pixel direction from
the Euler-rotated camera basis (rectilinear.rs:78-100), each pixel marching
its own ray and geodesic lazily (PathIterator, rectilinear.rs:118-186).
Slowest, exact (README.md:273-279).

Device shape, three regimes (all exact):

* tilt == 0, no objects (the common panorama case): with pitch = 0 the
  Euler chain R_z(yaw)·R_y(0) collapses the per-pixel azimuth to
  ``direction + atan2(x_off, z_focal)`` — EXACTLY constant along each image
  column — so the terrain scan is shared per column like the Fast
  generator, and ``fused_shared_core`` streams the per-pixel march straight
  into the crossing search (``physics.ray.march_scan``) without ever
  materializing the [H·W, N] ray grid. Scene-object frames use
  ``shared_column_core``, a row-chunked variant whose dense per-chunk ray
  grid feeds the object intersectors.

* tilt != 0, no objects, opaque terrain: the azimuth offset
  atan2(x, z·cos t − y·sin t) couples both pixel axes, so nothing is
  shareable — ``fused_culled_core`` keeps the exact per-azimuth sampling
  but cuts it ~100× with a conservative terrain-envelope cull (details on
  the function).

* everything else (tilted object/translucent scenes): ``pixelwise_hits``,
  the dense exact per-pixel program (the reference pays the same coupling
  on CPU). ``ATM_RAYTRACER_NO_CULL=1`` forces this path for verification.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..models import camera
from ..models.earth import EarthModel
from ..ops import combine
from ..ops.composite import composite
from ..ops.objects import ObjectSet, merge_hits, object_hits_pixelwise
from ..physics.ray import (
    EarthShape,
    RefractionTable,
    hermite_coeffs,
    hermite_plane,
    march_coarse,
    march_rays,
    march_scan,
    march_scan_light,
    rk4_window,
)
from ..terrain.sample import sample_elevation, sample_group, sample_terrain_data
from ..terrain.store import Terrain, TerrainPack
from .base import HitBuffer, RenderResult, callbacks_supported, fetch_flat
from .fast import build_refraction_table, terrain_bbox




def _endpoint_pair_terrain(pack, model, dl1, dn1, dl2, dn2, lat0, lon0,
                           paired: bool):
    """Terrain elev+normal at both crossing-segment endpoints in ONE call:
    the endpoints are one march step apart, so with ``paired`` each (lo, hi)
    pair rides a single win4 gather row instead of two quad gathers."""
    dls = jnp.stack([dl1, dl2], axis=-1)  # [..., 2] — pairs along last axis
    dns = jnp.stack([dn1, dn2], axis=-1)
    te, no = sample_terrain_data(pack, model, dls, dns, lat0, lon0,
                                 paired=paired)
    return te[..., 0], no[..., 0, :], te[..., 1], no[..., 1, :]


# ---------------------------------------------------------------------------
# tilt == 0, no scene objects: column-shared terrain, fully fused
# march+combine (the dense [H·W, N] ray grid is never materialized)
# ---------------------------------------------------------------------------


def fused_shared_core(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    elev_hw: Optional[jnp.ndarray],  # [H, W] radians, or None → on-device
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
    coloring,
    fog_distance: Optional[float],
    terrain_alpha: float,
    cam: Optional[tuple] = None,  # static (width, height, fov) when elev_hw is None
    row_sharding=None,  # static NamedSharding: shard pixel rows over a mesh
    with_progress: bool = False,
):
    """Whole tilt-0 Rectilinear pipeline, march and combine fused.

    ``physics.ray.march_scan`` streams each coarse-RK4 window's fine samples
    straight into the crossing search, so per-pixel ray altitudes live only
    as a [H, W, C+1] transient — HBM holds just the per-ray ODE state and
    the running best-K keys. The terrain scan is the Fast generator's shared
    per-column cache. Division (prop) runs only on the K selected candidates
    per window, never in the H·W·C cube (same economy as ops.combine).
    """
    n_seg = n_terr - 1
    # clamp exactly like march_scan_light does internally: for a march
    # shorter than one coarse window (n_seg < coarse) the post-scan
    # rk4_window re-expansion and all k0//coarse window bookkeeping must
    # use the SAME window size the scan integrated with, or the "bitwise
    # the fine values the scan saw" invariant breaks and the exact re-test
    # can reject a crossing the scan found
    coarse = max(1, min(march_coarse(step), n_seg))
    if elev_hw is None:
        # derive the pixel elevation grid ON device instead of uploading a
        # [H, W] f32 grid (models.camera note). Elevation is
        # yaw-independent, so direction=0 suffices.
        width, height, fov = cam
        elev_hw, _ = camera.rectilinear_ray_params_device(
            width, height, fov, 0.0, 0.0
        )
        if row_sharding is not None:
            # anchor the whole program's layout: rows over the mesh axis
            elev_hw = jax.lax.with_sharding_constraint(elev_hw, row_sharding)
    h_n, w_n = elev_hw.shape
    k = max_hits

    dists = jnp.arange(n_terr, dtype=jnp.float32) * jnp.float32(step)
    dlat, dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[:, None], dists[None, :]
    )  # [W, n_terr]
    terr_elev, terr_normal = sample_terrain_data(
        pack, model, dlat, dlon, lat0, lon0,
        paired=sample_group(pack, model, lat0, step, n_terr * step),
    )
    # gathered endpoint rows carry only elevation + normal (4 ch → 8 per
    # pair-row): the hit's dlat/dlon re-derives per PIXEL from (column azimuth,
    # key·step) with the same geodesic this cache was built from —
    # evaluating the curve at the lerped distance instead of lerping the
    # curve's endpoints (agreement ~1e-5 m over a 50 m segment; fast.py
    # separable_hits and the viewer's separable pack already do this)
    stacked = jnp.concatenate(
        [terr_elev[..., None], terr_normal], axis=-1
    )  # [W, N, 4]

    n_coarse = -(-n_seg // coarse)
    tpad = n_coarse * coarse + 1 - n_terr
    terr_pad = (
        jnp.pad(terr_elev, ((0, 0), (0, tpad)), constant_values=0.0)
        if tpad > 0 else terr_elev
    )
    stride = max(1, n_coarse // 32)

    def _progress_emit(k0, c):
        # clamp: a grouped march (group > 1) runs up to group-1
        # overshoot windows past n_coarse, whose k0 would report >100%
        frac = jnp.minimum(
            (k0.astype(jnp.float32) + c) / jnp.float32(n_coarse * coarse),
            jnp.float32(1.0),
        )
        w_i = k0 // coarse
        # always emit the FINAL window: when (n_coarse-1) is not a
        # multiple of stride the 100% line would otherwise never fire
        jax.lax.cond(
            (w_i % stride == 0) | (w_i == n_coarse - 1),
            lambda: jax.debug.callback(_emit_progress, frac, ordered=False),
            lambda: None,
        )

    if k == 1:
        # opaque fast path: the scan only answers "does this window contain
        # a sign change?" and captures the window-start ODE state of each
        # pixel's FIRST such window. Path length advances by RK4 quadrature
        # (march_scan_light), and the exact segment, prop and path length
        # come from ONE post-scan re-expansion of the captured window. The
        # fine chord machinery + per-segment bookkeeping inside the scan
        # cost more than the whole rest of the march (measured 0.41 s +
        # 0.3 s of a 2.2 s scan at 1080p/200 km). The crossing test streams
        # the fine samples plane by plane via hermite_plane (pass_nodes
        # contract): the [H, W, C+1] fine cube never reaches HBM — its
        # write+read was ~200 ms of a 1080p render — and the scan body's
        # whole window test fuses into one pass over the [P] node vectors.
        big_w = jnp.int32(n_coarse + 1)
        coeffs = hermite_coeffs(coarse)
        dxw = jnp.float32(step * coarse)

        def consumer(carry, k0, nodes, alive0):
            # the march runs on [H, W]-shaped state (march_scan_light is
            # shape-agnostic in pass_nodes mode): every plane op below is
            # natively 2-D, so no [P]↔[H, W] relayout copies appear in the
            # scan body (measured ~110 ms/render of in-loop data formatting
            # with flat state)
            best_w, s_h, s_v, s_p = carry
            h0, v0, h1, v1, p0 = nodes
            vdx = v0 * dxw
            v1dx = v1 * dxw
            t_sl = jax.lax.dynamic_slice(
                terr_pad, (0, k0), (w_n, coarse + 1)
            )
            # streamed min over segment products (hj - tj)·(hj1 - tj1):
            # bitwise the cube form's min (min is order-free; plane values
            # are hermite_window's, see hermite_plane)
            mn = None
            win_min = None
            d_prev = None
            for j in range(coarse + 1):
                hj = hermite_plane(h0, vdx, h1, v1dx, coeffs, j)  # [H, W]
                if j < coarse:
                    win_min = hj if j == 0 else jnp.minimum(win_min, hj)
                dj = hj - t_sl[:, j][None, :]
                if d_prev is not None:
                    pr = d_prev * dj
                    mn = pr if mn is None else jnp.minimum(mn, pr)
                d_prev = dj
            has = (
                (mn < 0.0)
                & alive0  # alive at window start
                & (best_w >= big_w)
            )
            # within-window death or the final window's padded tail can make
            # this a false positive — the post-scan exact test resolves both
            s_h = jnp.where(has, h0, s_h)
            s_v = jnp.where(has, v0, s_v)
            s_p = jnp.where(has, p0, s_p)
            best_w = jnp.where(has, jnp.int32(k0 // coarse), best_w)
            if with_progress:
                _progress_emit(k0, coarse)
            return (best_w, s_h, s_v, s_p), win_min

        z2 = jnp.zeros((h_n, w_n), jnp.float32)
        best_w, s_h, s_v, s_p = march_scan_light(
            alt0, elev_hw, step, n_seg, shape, table, straight,
            consumer,
            (jnp.full((h_n, w_n), big_w, jnp.int32), z2, z2, z2),
            coarse=coarse, pass_nodes=True,
        )
        # -- post: re-expand the captured window (bitwise the fine values
        # the scan saw: same hermite_plane expression, node states from the
        # identical-h/v rk4 re-step) and run the exact per-segment test as
        # [H, W] planes.
        valid_w = best_w < big_w
        bw = jnp.where(valid_w, best_w, 0)
        # all-[H, W] re-expansion: rk4_window is shape-agnostic, so the node
        # state never round-trips through a flat [P] form (each [P]↔[H, W]
        # reshape is a ~3 ms relayout copy at 1080p, ×17 planes)
        _, plen_fw, h1w, v1w = rk4_window(
            s_h, s_v, s_p, step, coarse, table, straight, shape.radius,
        )  # [H, W, C+1] path lengths + window-end node state
        s_vdx = s_v * dxw
        v1dxw = v1w * dxw
        h_pl = [
            hermite_plane(s_h, s_vdx, h1w, v1dxw, coeffs, j)
            for j in range(coarse + 1)
        ]  # (C+1)×[H, W] planes
        p_pl = jax.lax.optimization_barrier(
            jnp.moveaxis(plen_fw, -1, 0)
        )
        # window-aligned terrain rows: [W, n_coarse, C+1] built by pure
        # reshapes, fetched with ONE contiguous row-gather per pixel
        a_w = terr_pad[:, : n_coarse * coarse].reshape(w_n, n_coarse, coarse)
        b_w = terr_pad[:, coarse::coarse][:, :n_coarse, None]
        terr_win = jnp.concatenate([a_w, b_w], axis=-1).reshape(
            -1, coarse + 1
        )  # [W·n_coarse, C+1]
        col = jax.lax.broadcasted_iota(jnp.int32, (h_n, w_n), 1)
        rows = jnp.take(terr_win, col * n_coarse + bw, axis=0)
        t_pl = jax.lax.optimization_barrier(jnp.moveaxis(rows, -1, 0))
        # exact local test, unrolled over the C window segments
        kglob0 = bw * coarse  # [H, W] global index of window start
        found = jnp.zeros((h_n, w_n), bool)
        # death prefix matching ray_alive_mask / the reference's stop rule
        # (utils.rs:159-171: the first sub--1000 m sample is still recorded,
        # so the segment STARTING at it is tested): segment j dies only from
        # samples strictly before it — death before the window is alive0's
        # job at scan time
        dead = jnp.zeros((h_n, w_n), bool)
        d1s = z2
        d2s = z2
        pl1 = z2
        pl2 = z2
        j_star = jnp.zeros((h_n, w_n), jnp.float32)
        for j in range(coarse):
            d_lo = h_pl[j] - t_pl[j]
            d_hi = h_pl[j + 1] - t_pl[j + 1]
            cross = (
                (d_lo * d_hi < 0.0) & ~dead & (kglob0 + j < n_seg) & ~found
            )
            d1s = jnp.where(cross, d_lo, d1s)
            d2s = jnp.where(cross, d_hi, d2s)
            pl1 = jnp.where(cross, p_pl[j], pl1)
            pl2 = jnp.where(cross, p_pl[j + 1], pl2)
            j_star = jnp.where(cross, jnp.float32(j), j_star)
            found = found | cross
            dead = dead | (h_pl[j] < jnp.float32(-1000.0))
        valid1 = valid_w & found
        denom = d1s - d2s
        prop = d1s / jnp.where(denom == 0.0, 1.0, denom)  # utils.rs:232
        key = jnp.where(
            valid1, kglob0.astype(jnp.float32) + j_star + prop,
            combine.NO_HIT,
        )[..., None]
        plh = (pl1 * (1.0 - prop) + pl2 * prop)[..., None]
    else:
        def consumer(carry, k0, h_f, plen_f, alive):
            key, plh = carry  # [H, W, K] float keys / hit path lengths
            c = h_f.shape[1] - 1
            hw = h_f.reshape(h_n, w_n, c + 1)
            plw = plen_f.reshape(h_n, w_n, c + 1)
            t_sl = jax.lax.dynamic_slice(terr_pad, (0, k0), (w_n, c + 1))
            d = hw - t_sl[None, :, :]  # one cube pass; ends are views
            d1 = d[..., :-1]
            d2 = d[..., 1:]
            seg = jax.lax.broadcasted_iota(jnp.int32, (1, 1, c), 2) + k0
            crossing = (
                (d1 * d2 < 0.0) & alive.reshape(h_n, w_n, c) & (seg < n_seg)
            )
            cand = jnp.where(crossing, seg, combine.NO_HIT_SEG)
            # k_smallest + one-hot multiply-sum payload extraction instead
            # of take_along_axis gathers ×n_coarse inside the scan;
            # candidate segment ids are unique within a window, so the
            # payload at a selected id is exactly Σ field·[cand == id] —
            # elementwise arithmetic.
            cmin = combine.k_smallest(cand, k)
            ohf = (
                (cand[..., None, :] == cmin[..., :, None])
                & crossing[..., None, :]
            ).astype(jnp.float32)  # [H, W, K, C]
            sel = lambda x: jnp.sum(x[..., None, :] * ohf, axis=-1)
            d1s = sel(d1)
            d2s = sel(d2)
            pl1 = sel(plw[..., :-1])
            pl2 = sel(plw[..., 1:])
            denom = d1s - d2s
            prop = d1s / jnp.where(denom == 0.0, 1.0, denom)  # utils.rs:232
            found = cmin < combine.NO_HIT_SEG
            keyc = jnp.where(
                found, cmin.astype(jnp.float32) + prop, combine.NO_HIT
            )
            plc = pl1 * (1.0 - prop) + pl2 * prop
            # merge with the carry: keys are globally unique per pixel
            # (disjoint windows), so the same one-hot trick re-pairs the
            # path lengths with the merged top-k keys; the inf slots all
            # carry payload 0 so their duplicate matches are harmless.
            all_k = jnp.concatenate([key, keyc], axis=-1)
            all_p = jnp.concatenate([plh, plc], axis=-1)
            key = combine.merge_sorted_k(key, keyc, k)
            oh2 = (all_k[..., None, :] == key[..., :, None]).astype(
                jnp.float32
            )  # [H, W, K, 2K]
            matches = jnp.sum(oh2, axis=-1)
            plh = jnp.sum(all_p[..., None, :] * oh2, axis=-1) / jnp.maximum(
                matches, 1.0
            )
            if with_progress:
                _progress_emit(k0, c)
            return key, plh

        key0 = jnp.full((h_n, w_n, k), combine.NO_HIT)
        plh0 = jnp.zeros((h_n, w_n, k), jnp.float32)
        key, plh = march_scan(
            alt0, elev_hw.reshape(-1), step, n_seg, shape, table, straight,
            consumer, (key0, plh0), coarse=coarse,
        )

    valid = jnp.isfinite(key)
    safe = jnp.where(valid, key, 0.0)
    ks = jnp.floor(safe).astype(jnp.int32)
    prop = safe - ks.astype(jnp.float32)
    if k == 1:
        # channel-plane reconstruction: ONE 32 B pair-row gather per pixel,
        # transposed channel-leading (the [H, W, K, D] form costs ~4× here)
        col_pairs = jnp.concatenate(
            [stacked[:, :-1, :], stacked[:, 1:, :]], axis=-1
        ).reshape(-1, 8)  # [W·(N-1), 8]
        w_iota = jax.lax.broadcasted_iota(jnp.int32, (h_n, w_n), 1)
        base = w_iota * (n_terr - 1) + jnp.clip(ks[..., 0], 0, n_terr - 2)
        g = jax.lax.optimization_barrier(
            jnp.moveaxis(jnp.take(col_pairs, base, axis=0), -1, 0)
        )  # [8, H, W]: (elev,n0,n1,n2) lo then hi
        pr = prop[..., 0]
        pl_ = lambda lo, hi: (lo * (1.0 - pr) + hi * pr)[..., None]
        hit_elev = pl_(g[0], g[4])
        hit_normal = jnp.stack(
            [pl_(g[1], g[5])[..., 0], pl_(g[2], g[6])[..., 0],
             pl_(g[3], g[7])[..., 0]],
            axis=-1,
        )[..., None, :]
    else:
        c_lo, c_hi = combine.gather_column_pairs(stacked, ks)  # [H, W, K, 4]
        hit_stack = c_lo * (1.0 - prop[..., None]) + c_hi * prop[..., None]
        hit_elev = hit_stack[..., 0]
        hit_normal = hit_stack[..., 1:4]
    # hit positions re-derived on the column geodesic at the lerped distance
    # (tilt == 0 ⇒ azimuth is constant along each image column)
    hit_dlat, hit_dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[None, :, None],
        safe * jnp.float32(step),
    )  # [H, W, K]
    rgba = jnp.zeros((h_n, w_n, k, 4), jnp.float32)
    rgba = rgba.at[..., 3].set(jnp.float32(terrain_alpha))
    hits = HitBuffer(
        valid=valid,
        key=key,
        dlat=hit_dlat,
        dlon=hit_dlon,
        distance=safe * jnp.float32(step),
        elevation=hit_elev,
        path_length=plh,
        normal=hit_normal,
        kind=jnp.zeros((h_n, w_n, k), jnp.int32),
        rgba=rgba,
    )
    image = composite(
        coloring, fog_distance,
        hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
        hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
    )
    return image.reshape(-1), hits


_fused_shared_device = functools.partial(
    jax.jit,
    static_argnames=(
        "model", "shape", "straight", "step", "n_terr", "max_hits", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha", "cam",
        "row_sharding", "with_progress",
    ),
)(fused_shared_core)


# ---------------------------------------------------------------------------
# tilt == 0 with scene objects: column-shared terrain, row-chunked scan
# (object intersection consumes the dense per-chunk ray grid)
# ---------------------------------------------------------------------------


def shared_column_core(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    objects: Optional[ObjectSet],
    elev_chunks: jnp.ndarray,  # [n_chunks, R, W] radians
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
    coloring,
    fog_distance: Optional[float],
    terrain_alpha: float,
    with_progress: bool = False,
):
    """Whole tilt-0 Rectilinear pipeline as one traceable function.

    Returns (images [n_chunks, R·W, 3] u8, hits HitBuffer [n_chunks, R·W, K]).
    """
    n_seg = n_terr - 1
    coarse = march_coarse(step)
    n_chunks, r_n, w_n = elev_chunks.shape
    rw = r_n * w_n

    # shared per-column terrain cache — identical to the Fast generator's
    # step 2 (utils.rs:176-199): one geodesic + one gather row per column.
    dists = jnp.arange(n_terr, dtype=jnp.float32) * jnp.float32(step)
    dlat, dlon = model.geodesic_delta(
        lat0, lon0, az_deg.astype(jnp.float32)[:, None], dists[None, :]
    )  # [W, n_terr]
    terr_elev, terr_normal = sample_terrain_data(
        pack, model, dlat, dlon, lat0, lon0,
        paired=sample_group(pack, model, lat0, step, n_terr * step),
    )
    # elevation + normal only in each gathered pair-row;
    # hit dlat/dlon re-derives per pixel from (column azimuth, key·step) —
    # see the fused_shared_core note
    stacked = jnp.concatenate(
        [terr_elev[..., None], terr_normal], axis=-1
    )  # [W, N, 4]
    az_flat = jnp.broadcast_to(
        az_deg.astype(jnp.float32)[None, :], (r_n, w_n)
    ).reshape(-1)

    def chunk_fn(c, elev_rw):
        ray_h, path_len = march_rays(
            alt0, elev_rw.reshape(-1), step, n_seg, shape, table, straight,
            coarse=coarse,
        )  # [R·W, n_terr]
        segs = combine.aligned_crossing_segments(
            ray_h.reshape(r_n, w_n, n_terr), terr_elev, n_seg, max_hits
        )  # [R, W, K]
        valid = segs < n_seg
        ks = jnp.where(valid, segs, 0)

        # field reconstruction at the K crossings (utils.rs:108-133 semantics,
        # same paired-endpoint gathers as generators/fast.py step 4)
        c_lo, c_hi = combine.gather_column_pairs(stacked, ks)  # [R, W, K, 4]
        ray_stack = jnp.stack([ray_h, path_len], axis=-1)  # [R·W, N, 2]
        r_lo, r_hi = combine.gather_ray_pairs(
            ray_stack, ks.reshape(rw, max_hits)
        )
        r_lo = r_lo.reshape(r_n, w_n, max_hits, 2)
        r_hi = r_hi.reshape(r_n, w_n, max_hits, 2)
        d1 = r_lo[..., 0] - c_lo[..., 0]
        d2 = r_hi[..., 0] - c_hi[..., 0]
        denom = d1 - d2
        prop = d1 / jnp.where(denom == 0.0, 1.0, denom)  # utils.rs:232
        keys = jnp.where(valid, ks.astype(jnp.float32) + prop, combine.NO_HIT)
        safe_keys = jnp.where(valid, keys, 0.0)

        hit_stack = c_lo * (1.0 - prop[..., None]) + c_hi * prop[..., None]
        hit_dlat, hit_dlon = model.geodesic_delta(
            lat0, lon0, az_deg.astype(jnp.float32)[None, :, None],
            safe_keys * jnp.float32(step),
        )  # [R, W, K]
        rgba = jnp.zeros((r_n, w_n, max_hits, 4), jnp.float32)
        rgba = rgba.at[..., 3].set(jnp.float32(terrain_alpha))
        hits = HitBuffer(
            valid=valid.reshape(rw, max_hits),
            key=keys.reshape(rw, max_hits),
            dlat=hit_dlat.reshape(rw, max_hits),
            dlon=hit_dlon.reshape(rw, max_hits),
            distance=(safe_keys * jnp.float32(step)).reshape(rw, max_hits),
            elevation=hit_stack[..., 0].reshape(rw, max_hits),
            path_length=(
                r_lo[..., 1] * (1.0 - prop) + r_hi[..., 1] * prop
            ).reshape(rw, max_hits),
            normal=hit_stack[..., 1:4].reshape(rw, max_hits, 3),
            kind=jnp.zeros((rw, max_hits), jnp.int32),
            rgba=rgba.reshape(rw, max_hits, 4),
        )
        if objects is not None:
            obj_hits = object_hits_pixelwise(
                objects, model, lat0, lon0, step, n_terr,
                ray_h, path_len, az_flat,
            )
            hits = merge_hits(hits, obj_hits, max_hits + obj_hits.key.shape[-1])
        image = composite(
            coloring, fog_distance,
            hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
            hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
        )
        if with_progress:
            jax.debug.callback(_emit_progress, (c + 1) / n_chunks, ordered=False)
        return c + 1, (image, hits)

    _, (images, hits) = jax.lax.scan(
        chunk_fn, jnp.int32(0), elev_chunks
    )
    return images, hits


_shared_column_device = functools.partial(
    jax.jit,
    static_argnames=(
        "model", "shape", "straight", "step", "n_terr", "max_hits", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha", "with_progress",
    ),
)(shared_column_core)


# progress sink: shared with the Fast/Interpolating generators (base.py);
# the reporter is installed per render call via set_progress_sink.
from .base import _emit_progress, set_progress_sink  # noqa: E402


# ---------------------------------------------------------------------------
# tilt != 0, no objects, opaque terrain: two-phase envelope-culled exact path
# ---------------------------------------------------------------------------


def fused_culled_core(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    alt0,
    *,
    cam: tuple,  # static (width, height, fov, tilt, direction)
    model: EarthModel,
    shape: EarthShape,
    straight: bool,
    step: float,
    n_terr: int,
    lat0: float,
    lon0: float,
    coloring,
    fog_distance: Optional[float],
    terrain_alpha: float,
    m_cand: int = 4,
    block_windows: int = 4,
):
    """Exact tilted-pinhole Rectilinear without per-pixel dense sampling.

    A tilted camera couples azimuth to both pixel axes (rectilinear.rs:
    78-100), so nothing is shared between pixels and the naive exact program
    samples terrain H·W·N times (~8×10⁹ gathers at 1080p — minutes). This
    path keeps the result EXACT while sampling ~100× less:

    1. envelope: terrain on a dense azimuth grid (2 columns per pixel
       column), reduced to per-(azimuth-interval, distance-block) min/max
       bounds, widened by a slack that covers any azimuth inside the
       interval: slack = G·d·δa with G the mosaic's bilinear Lipschitz
       bound (``TerrainPack.grad_bound``) and d·δa the geodesic spread —
       a CONSERVATIVE bound, so culling can never drop a real crossing.
    2. candidate capture: one ``march_scan`` pass per round carries each
       pixel's block-window ray min/max; a block whose ray range overlaps
       its envelope range writes the block-start ODE state (h, h', path
       length, death flag) into the pixel's next free candidate slot —
       pure where/compare writes, no gathers inside the scan.
    3. exact test: candidate blocks re-integrate from their captured states
       (``rk4_window`` — bitwise the same values the full march produces)
       and sample terrain at each pixel's EXACT azimuth only there
       (P·M·(B+1) gathers instead of P·N).
    4. rounds: a ``lax.while_loop`` repeats 2-3 with the next ``m_cand``
       candidate blocks for pixels that have candidates left but no hit —
       the exactness backstop for grazing rays with many envelope overlaps.

    Opaque terrain only (first crossing); translucent or object scenes use
    the dense per-pixel path.
    """
    width, height, fov, tilt, direction = cam
    n_seg = n_terr - 1
    # clamp like the scans do internally (see fused_shared_core): block
    # bookkeeping must use the window size the scan integrates with
    coarse = max(1, min(march_coarse(step), n_seg))
    b_len = block_windows * coarse  # segments per block
    nb = -(-n_seg // b_len)
    n_march = nb * b_len  # march through whole blocks; masks trim the tail
    p_n = width * height
    m = m_cand
    radius = shape.radius
    # every terrain sampling below walks geodesics in `step` increments
    # along the last axis (envelope grid, per-candidate fine windows, hit
    # endpoint pairs) — one static gate covers them all (the endpoint
    # helper's 2-wide last axis uses plain pairs)
    grp = sample_group(pack, model, lat0, step, (n_march + 1) * step)
    pair_ok = grp >= 2

    elev_hw, dirr_hw = camera.rectilinear_ray_params_device(
        width, height, fov, tilt, direction
    )
    elev = elev_hw.reshape(-1)
    # unwrap the atan2 azimuth about the camera direction: a view straddling
    # the ±180° seam must NOT span ~360° in the envelope grid (d_az and the
    # Lipschitz slack would blow up and nothing would cull)
    az_raw = jnp.rad2deg(dirr_hw.reshape(-1))  # [P] degrees in (-180, 180]
    az_off = jnp.mod(az_raw - jnp.float32(direction) + 180.0, 360.0) - 180.0
    az_px = jnp.float32(direction) + az_off

    # -- phase 1: conservative envelope ------------------------------------
    n_env = 2 * width  # two envelope columns per pixel column
    az_lo = jnp.min(az_px)
    span = jnp.maximum(jnp.max(az_px) - az_lo, 1e-7)
    d_az = span / (n_env - 1)
    az_grid = az_lo + jnp.arange(n_env, dtype=jnp.float32) * d_az
    dists = jnp.arange(n_march + 1, dtype=jnp.float32) * jnp.float32(step)
    env_dl, env_dn = model.geodesic_delta(
        lat0, lon0, az_grid[:, None], dists[None, :]
    )
    env = sample_elevation(
        pack, env_dl, env_dn, lat0, lon0, paired=grp
    )  # [A, n_march+1]
    seg_hi = jnp.maximum(env[:, :-1], env[:, 1:]).reshape(n_env, nb, b_len)
    seg_lo = jnp.minimum(env[:, :-1], env[:, 1:]).reshape(n_env, nb, b_len)
    blk_hi = seg_hi.max(-1)  # [A, nb]
    blk_lo = seg_lo.min(-1)
    int_hi = jnp.maximum(blk_hi[:-1], blk_hi[1:])  # [A-1, nb]
    int_lo = jnp.minimum(blk_lo[:-1], blk_lo[1:])
    d_far = (jnp.arange(nb, dtype=jnp.float32) + 1.0) * jnp.float32(b_len * step)
    slack = (
        jnp.float32(pack.grad_bound) * d_far * jnp.deg2rad(d_az) * 1.1
        + 1.0 + jnp.float32(pack.seam_jump)
    )  # [nb]; ×1.1 geodesic-spread margin, +1 m absolute safety,
    # + the mosaic's max tile-seam step (no gradient bound covers a step)
    env_hi = int_hi + slack[None, :]
    env_lo = int_lo - slack[None, :]
    j_px = jnp.clip(
        jnp.floor((az_px - az_lo) / d_az).astype(jnp.int32), 0, n_env - 2
    )
    env_hi_p = jnp.take(env_hi, j_px, axis=0)  # [P, nb] — one gather launch
    env_lo_p = jnp.take(env_lo, j_px, axis=0)

    # -- phases 2-4 --------------------------------------------------------
    slot_iota = jnp.arange(m, dtype=jnp.int32)[None, :]

    def capture_round(skip):
        """One march pass: capture candidate blocks skip..skip+m-1."""

        def consumer(user, k0, h_f, plen_f, alive, v):
            (bh, bv, bp, bd, rmin, rmax, cnt, s_h, s_v, s_p, s_d, s_b) = user
            w_idx = k0 // coarse
            at_start = (w_idx % block_windows) == 0
            bh = jnp.where(at_start, h_f[:, 0], bh)
            bv = jnp.where(at_start, v, bv)
            bp = jnp.where(at_start, plen_f[:, 0], bp)
            bd = jnp.where(at_start, ~alive[:, 0], bd)
            wmin = jnp.min(h_f, axis=-1)
            wmax = jnp.max(h_f, axis=-1)
            rmin = jnp.where(at_start, wmin, jnp.minimum(rmin, wmin))
            rmax = jnp.where(at_start, wmax, jnp.maximum(rmax, wmax))
            at_end = (w_idx % block_windows) == (block_windows - 1)
            b = w_idx // block_windows
            e_hi = jax.lax.dynamic_slice(env_hi_p, (0, b), (p_n, 1))[:, 0]
            e_lo = jax.lax.dynamic_slice(env_lo_p, (0, b), (p_n, 1))[:, 0]
            cand = (
                at_end & (rmin <= e_hi) & (rmax >= e_lo) & ~bd
                & (b * b_len < n_seg)
            )
            slot = (cnt - skip)[:, None]
            wm = cand[:, None] & (slot_iota == slot)
            s_h = jnp.where(wm, bh[:, None], s_h)
            s_v = jnp.where(wm, bv[:, None], s_v)
            s_p = jnp.where(wm, bp[:, None], s_p)
            s_d = jnp.where(wm, bd[:, None], s_d)
            s_b = jnp.where(wm, b, s_b)
            cnt = cnt + cand.astype(jnp.int32)
            return (bh, bv, bp, bd, rmin, rmax, cnt, s_h, s_v, s_p, s_d, s_b)

        z = jnp.zeros((p_n,), jnp.float32)
        zb = jnp.zeros((p_n,), bool)
        zi = jnp.zeros((p_n,), jnp.int32)
        zm = jnp.zeros((p_n, m), jnp.float32)
        init = (
            z, z, z, zb, z, z, zi,
            zm, zm, zm, jnp.zeros((p_n, m), bool),
            jnp.full((p_n, m), nb, jnp.int32),
        )
        out = march_scan(
            alt0, elev, step, n_march, shape, table, straight,
            consumer, init, coarse=coarse, with_slope=True,
        )
        (_, _, _, _, _, _, cnt, s_h, s_v, s_p, s_d, s_b) = out
        return cnt, s_h, s_v, s_p, s_d, s_b

    def exact_test(s_h, s_v, s_p, s_d, s_b):
        """Re-integrate candidate blocks; exact terrain at pixel azimuths."""
        h = s_h.reshape(-1)
        v = s_v.reshape(-1)
        pl = s_p.reshape(-1)
        parts_h = [h[:, None]]
        parts_p = [pl[:, None]]
        for _ in range(block_windows):
            h_f, plen_f, h, v = rk4_window(
                h, v, pl, step, coarse, table, straight, radius
            )
            parts_h.append(h_f[:, 1:])
            parts_p.append(plen_f[:, 1:])
            pl = plen_f[:, -1]
        h_fine = jnp.concatenate(parts_h, axis=-1).reshape(p_n, m, b_len + 1)
        p_fine = jnp.concatenate(parts_p, axis=-1).reshape(p_n, m, b_len + 1)
        # death rule inside the block (prefix over samples < segment index)
        dead_loc = h_fine[..., :-1] < jnp.float32(-1000.0)
        pref = jnp.cumsum(dead_loc.astype(jnp.int32), axis=-1)
        no_prior = jnp.concatenate(
            [jnp.zeros_like(pref[..., :1]), pref[..., :-1]], axis=-1
        )
        alive = ~s_d[..., None] & (no_prior == 0)

        local = jnp.arange(b_len + 1, dtype=jnp.float32)
        d = (
            s_b[..., None].astype(jnp.float32) * (b_len * step)
            + local[None, None, :] * jnp.float32(step)
        )  # [P, M, B+1]
        dl, dn = model.geodesic_delta(lat0, lon0, az_px[:, None, None], d)
        te = sample_elevation(
            pack, dl, dn, lat0, lon0, paired=grp
        )  # [P, M, B+1]
        dd = h_fine - te
        d1 = dd[..., :-1]
        d2 = dd[..., 1:]
        seg = (
            s_b[..., None] * b_len
            + jnp.arange(b_len, dtype=jnp.int32)[None, None, :]
        )
        crossing = (
            (d1 * d2 < 0.0) & alive & (seg < n_seg) & (s_b[..., None] < nb)
        )
        cand = jnp.where(crossing, seg, combine.NO_HIT_SEG).reshape(p_n, -1)
        cmin = jnp.min(cand, axis=-1, keepdims=True)  # [P, 1]
        ohf = ((cand == cmin) & (cand < combine.NO_HIT_SEG)).astype(jnp.float32)
        sel = lambda x: jnp.sum(x.reshape(p_n, -1) * ohf, axis=-1, keepdims=True)
        d1s = sel(d1)
        d2s = sel(d2)
        pl1 = sel(p_fine[..., :-1])
        pl2 = sel(p_fine[..., 1:])
        denom = d1s - d2s
        prop = d1s / jnp.where(denom == 0.0, 1.0, denom)
        found = cmin < combine.NO_HIT_SEG
        keyc = jnp.where(found, cmin.astype(jnp.float32) + prop, combine.NO_HIT)
        plc = pl1 * (1.0 - prop) + pl2 * prop
        return keyc, plc

    def round_body(state):
        skip, key, plh, _ = state
        cnt, s_h, s_v, s_p, s_d, s_b = capture_round(skip)
        keyc, plc = exact_test(s_h, s_v, s_p, s_d, s_b)
        better = keyc < key
        return (
            skip + m,
            jnp.where(better, keyc, key),
            jnp.where(better, plc, plh),
            cnt,
        )

    def round_cond(state):
        skip, key, _, cnt = state
        return jnp.any(jnp.isinf(key[:, 0]) & (cnt > skip)) & (skip < nb)

    state0 = (
        jnp.int32(0),
        jnp.full((p_n, 1), combine.NO_HIT),
        jnp.zeros((p_n, 1), jnp.float32),
        jnp.full((p_n,), nb, jnp.int32),  # "assume more" → first round runs
    )
    _, key, plh, _ = jax.lax.while_loop(round_cond, round_body, state0)

    # -- hit-field reconstruction at the found keys (legacy-path semantics) -
    valid = jnp.isfinite(key)
    safe = jnp.where(valid, key, 0.0)
    kf = jnp.floor(safe)
    prop = safe - kf
    dl1, dn1 = model.geodesic_delta(lat0, lon0, az_px[:, None], kf * step)
    dl2, dn2 = model.geodesic_delta(
        lat0, lon0, az_px[:, None], (kf + 1.0) * step
    )
    te1, no1, te2, no2 = _endpoint_pair_terrain(
        pack, model, dl1, dn1, dl2, dn2, lat0, lon0, pair_ok
    )
    lerp = lambda a, b: a * (1.0 - prop) + b * prop
    hits = HitBuffer(
        valid=valid,
        key=key,
        dlat=lerp(dl1, dl2),
        dlon=lerp(dn1, dn2),
        distance=safe * jnp.float32(step),
        elevation=lerp(te1, te2),
        path_length=plh,
        normal=no1 * (1.0 - prop[..., None]) + no2 * prop[..., None],
        kind=jnp.zeros(key.shape, jnp.int32),
        rgba=jnp.zeros(key.shape + (4,), jnp.float32)
        .at[..., 3]
        .set(jnp.float32(terrain_alpha)),
    )
    image = composite(
        coloring, fog_distance,
        hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
        hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
    )
    return image.reshape(-1), hits


_fused_culled_device = functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "model", "shape", "straight", "step", "n_terr", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha", "m_cand",
        "block_windows",
    ),
)(fused_culled_core)


# ---------------------------------------------------------------------------
# tilt != 0: exact per-pixel geodesics (no sharing possible)
# ---------------------------------------------------------------------------


def pixelwise_hits(
    pack: TerrainPack,
    table: Optional[RefractionTable],
    objects: Optional[ObjectSet],
    elev_rad: jnp.ndarray,  # [P]
    dir_deg: jnp.ndarray,  # [P]
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
    seg_chunk: int = 512,
) -> HitBuffer:
    """Hits for P independent (elevation, azimuth) rays."""
    p_n = elev_rad.shape[0]
    n_seg = n_terr - 1
    coarse = march_coarse(step)
    grp = sample_group(pack, model, lat0, step, n_terr * step)
    pair_ok = grp >= 2
    ray_h, path_len = march_rays(
        alt0, elev_rad, step, n_seg, shape, table, straight, coarse=coarse
    )  # [P, n_terr]
    alive = combine.ray_alive_mask(ray_h)  # [P, n_seg]

    n_chunks = -(-n_seg // seg_chunk)
    pad_to = n_chunks * seg_chunk + 1
    ray_h_p = jnp.pad(ray_h, ((0, 0), (0, pad_to - n_terr)), constant_values=-1e9)
    alive_p = jnp.pad(alive, ((0, 0), (0, pad_to - n_seg)), constant_values=False)
    dir_col = dir_deg[:, None]

    def chunk_body(keys, c):
        k0 = c * seg_chunk
        dists = (jnp.arange(seg_chunk + 1, dtype=jnp.float32) + k0.astype(jnp.float32)) * step
        dl, dn = model.geodesic_delta(lat0, lon0, dir_col, dists[None, :])
        te = sample_elevation(pack, dl, dn, lat0, lon0, paired=grp)  # [P, C+1]
        rh = jax.lax.dynamic_slice(ray_h_p, (0, k0), (p_n, seg_chunk + 1))
        al = jax.lax.dynamic_slice(alive_p, (0, k0), (p_n, seg_chunk))
        d1 = rh[:, :-1] - te[:, :-1]
        d2 = rh[:, 1:] - te[:, 1:]
        seg_idx = (
            jax.lax.broadcasted_iota(jnp.float32, (1, seg_chunk), 1)
            + k0.astype(jnp.float32)
        )
        in_range = seg_idx < n_seg
        crossing = (d1 * d2 < 0.0) & al & in_range
        prop = d1 / (d1 - d2)
        cand = jnp.where(crossing, seg_idx + prop, combine.NO_HIT)
        if max_hits == 1:
            keys = jnp.minimum(keys, jnp.min(cand, axis=-1, keepdims=True))
        else:
            keys = combine.merge_sorted_k(
                keys, combine.k_smallest(cand, max_hits), max_hits
            )
        return keys, None

    keys0 = jnp.full((p_n, max_hits), combine.NO_HIT)
    keys, _ = jax.lax.scan(chunk_body, keys0, jnp.arange(n_chunks))
    valid = jnp.isfinite(keys)
    safe = jnp.where(valid, keys, 0.0)

    # hit-field reconstruction at the K crossings only
    k = jnp.floor(safe)
    prop = safe - k
    d_lo = k * step
    d_hi = (k + 1.0) * step
    dl1, dn1 = model.geodesic_delta(lat0, lon0, dir_col, d_lo)
    dl2, dn2 = model.geodesic_delta(lat0, lon0, dir_col, d_hi)
    te1, no1, te2, no2 = _endpoint_pair_terrain(
        pack, model, dl1, dn1, dl2, dn2, lat0, lon0, pair_ok
    )
    lerp = lambda a, b: a * (1.0 - prop) + b * prop
    lerp_v = lambda a, b: a * (1.0 - prop[..., None]) + b * prop[..., None]
    hits = HitBuffer(
        valid=valid,
        key=keys,
        dlat=lerp(dl1, dl2),
        dlon=lerp(dn1, dn2),
        distance=safe * jnp.float32(step),
        elevation=lerp(te1, te2),
        path_length=combine.gather_ray_field(path_len, safe),
        normal=lerp_v(no1, no2),
        kind=jnp.zeros(keys.shape, jnp.int32),
        rgba=jnp.zeros(keys.shape + (4,), jnp.float32)
        .at[..., 3]
        .set(jnp.float32(terrain_alpha)),
    )
    if objects is not None:
        obj_hits = object_hits_pixelwise(
            objects, model, lat0, lon0, step, n_terr,
            ray_h, path_len, dir_deg,
        )
        hits = merge_hits(hits, obj_hits, max_hits + obj_hits.key.shape[-1])
    return hits


def rectilinear_core(
    pack, table, objects, elev_rad, dir_deg, alt0, *,
    model, shape, straight, step, n_terr, max_hits, lat0, lon0,
    coloring, fog_distance, terrain_alpha,
):
    hits = pixelwise_hits(
        pack, table, objects, elev_rad, dir_deg, alt0,
        model=model, shape=shape, straight=straight, step=step, n_terr=n_terr,
        max_hits=max_hits, lat0=lat0, lon0=lon0, terrain_alpha=terrain_alpha,
    )
    image = composite(
        coloring, fog_distance,
        hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
        hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
    )
    return image, hits


_rectilinear_chunk = functools.partial(
    jax.jit,
    static_argnames=(
        "model", "shape", "straight", "step", "n_terr", "max_hits", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha",
    ),
)(rectilinear_core)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def _auto_chunk_rows(width: int, height: int, n_terr: int) -> int:
    """Row-chunk size bounding the dense per-chunk march at ~1 GB f32."""
    budget = int(os.environ.get("ATM_RAYTRACER_RECT_CHUNK_ELEMS", str(250_000_000)))
    r = max(1, budget // max(1, width * n_terr))
    return int(min(height, r))


def render_rectilinear(
    params: Params, terrain: Terrain, max_hits: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    progress: Optional[Callable[[int], None]] = None,
    fetch_image: bool = True,
) -> RenderResult:
    """Full Rectilinear render (rectilinear.rs:24-60), row-chunked.

    ``progress`` (if given) receives whole-percent completion values, the
    device analog of the reference's per-percent pixel counter
    (rectilinear.rs:40-49).

    ``fetch_image=False`` leaves ``result.image`` device-resident in the
    path's native FLAT [H*W*3]-leading u8 layout (possibly padded past
    H*W*3; callers fetch via ``base.fetch_flat``, slice to H*W*3, and
    reshape to (H, W, 3) themselves).
    """
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)

    elev_rad, dir_rad = camera.rectilinear_ray_params(
        out.width, out.height, frame.fov, frame.tilt, frame.direction
    )  # [H, W]
    lat_rng, lon_rng = terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4
    objset = ObjectSet.build(params) if params.objects else None
    h, w = out.height, out.width

    static_kwargs = dict(
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
    )

    if frame.tilt == 0.0:
        az_col = camera.rectilinear_column_azimuths(
            w, frame.fov, frame.direction
        )  # [W]
        az_dev = jnp.asarray(az_col, jnp.float32)

        with_progress = progress is not None and callbacks_supported()
        set_progress_sink(progress)
        try:
            if objset is None:
                image_flat, hits = _fused_shared_device(
                    pack, table,
                    None,  # elevation grid derived on device (no upload)
                    az_dev,
                    float(alt0),
                    cam=(w, h, float(frame.fov)),
                    with_progress=with_progress,
                    **static_kwargs,
                )
                image = (
                    fetch_flat(image_flat)[: h * w * 3].reshape(h, w, 3)
                    if fetch_image else image_flat
                )
            else:
                r_rows = chunk_rows or _auto_chunk_rows(w, h, n_terr)
                n_chunks = -(-h // r_rows)
                pad_rows = n_chunks * r_rows - h
                elev_p = np.concatenate(
                    [elev_rad, np.broadcast_to(elev_rad[-1:], (pad_rows, w))],
                    axis=0,
                ) if pad_rows else elev_rad
                elev_chunks = jnp.asarray(
                    elev_p.reshape(n_chunks, r_rows, w), jnp.float32
                )
                images, hits = _shared_column_device(
                    pack, table, objset,
                    elev_chunks,
                    az_dev,
                    float(alt0),
                    with_progress=with_progress,
                    **static_kwargs,
                )
                image = (
                    fetch_flat(images)[: h * w * 3].reshape(h, w, 3)
                    if fetch_image else images.reshape(-1)
                )
                hits = jax.tree.map(
                    lambda x: x.reshape(
                        (n_chunks * r_rows * w,) + x.shape[2:]
                    )[: h * w].reshape((h, w) + x.shape[2:]),
                    hits,
                )
        finally:
            set_progress_sink(None)
        if progress is not None and not with_progress:
            progress(100)  # backend rejects host callbacks; report completion
    elif (objset is None and max_hits == 1
          and not os.environ.get("ATM_RAYTRACER_NO_CULL")):
        # tilted pinhole, opaque terrain: two-phase envelope-culled exact path
        image_flat, hits = _fused_culled_device(
            pack, table, float(alt0),
            cam=(w, h, float(frame.fov), float(frame.tilt),
                 float(frame.direction)),
            model=params.model,
            shape=params.model.to_shape(),
            straight=params.straight_rays,
            step=float(params.simulation_step),
            n_terr=n_terr,
            lat0=float(pos.latitude),
            lon0=float(pos.longitude),
            coloring=params.coloring,
            fog_distance=params.view.fog_distance,
            terrain_alpha=float(params.terrain_alpha),
        )
        image = (
            fetch_flat(image_flat)[: h * w * 3].reshape(h, w, 3)
            if fetch_image else image_flat
        )
        hits = jax.tree.map(
            lambda x: x.reshape((h, w) + x.shape[1:]), hits
        )
        if progress is not None:
            progress(100)
    else:
        r_rows = chunk_rows or 64
        elev_flat = jnp.asarray(elev_rad.reshape(-1), jnp.float32)
        dir_flat = jnp.asarray(np.rad2deg(dir_rad).reshape(-1), jnp.float32)
        p_total = h * w
        chunk = r_rows * w
        pad = (-p_total) % chunk
        if pad:
            elev_flat = jnp.concatenate([elev_flat, jnp.zeros((pad,), jnp.float32)])
            dir_flat = jnp.concatenate([dir_flat, jnp.zeros((pad,), jnp.float32)])

        images = []
        hit_parts = []
        n_chunks = (p_total + pad) // chunk
        for i, c0 in enumerate(range(0, p_total + pad, chunk)):
            img_c, hits_c = _rectilinear_chunk(
                pack, table, objset,
                jax.lax.dynamic_slice(elev_flat, (c0,), (chunk,)),
                jax.lax.dynamic_slice(dir_flat, (c0,), (chunk,)),
                float(alt0),
                **static_kwargs,
            )
            images.append(img_c)
            hit_parts.append(hits_c)
            if progress is not None:
                img_c.block_until_ready()
                progress(int((i + 1) * 100 / n_chunks))

        # concatenate on DEVICE; only the final u8 image crosses to host (hit
        # buffers stay device-resident — see generators.fast note)
        image_flat = jnp.concatenate(images, axis=0)[:p_total].reshape(-1)
        image = (
            fetch_flat(image_flat).reshape(h, w, 3)
            if fetch_image else image_flat
        )
        hits = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0)[:p_total].reshape(
                (h, w) + xs[0].shape[1:]
            ),
            *hit_parts,
        )
    return RenderResult(
        image=image,
        hits=hits,
        elevation_deg=np.rad2deg(elev_rad),
        azimuth_deg=np.rad2deg(dir_rad),
        observer=(pos.latitude, pos.longitude, alt0),
    )
