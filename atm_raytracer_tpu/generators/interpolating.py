"""InterpolatingRectilinear generator: snapped angular grid + 16-case interp.

Reference: src/generator/generators/interpolating_rectilinear.rs — a
rectilinear camera whose pixels are snapped to an (elevation, direction) grid
with step = 1.5 × the minimum per-pixel angular delta (gen_fov_data,
:453-522); grid pixels are memoized behind RwLock HashMaps (:26-108) and each
output pixel bilinearly interpolates its 4 grid corners' trace points with a
16-case presence match (:183-418).

Device re-shape (SURVEY §2b mechanism 3): the data-dependent memoization becomes
dedup-then-dense — the needed grid indices form a contiguous range, so the
whole grid is computed densely with the same separable machinery as the Fast
generator (one march per grid row, one terrain scan per grid column), then
the interpolation runs as masked vectorized arithmetic over output pixels.

Documented tolerance decisions vs the reference:
* trace-point grouping (collect_trace_points, :213-243) assigns an entry to
  the group of its first matching earlier entry instead of scanning groups in
  creation order — identical except for degenerate scenes with ≥3 mutually
  step-close groups;
* per-pixel output slots are capped at 2×K_grid (the reference's Vec is
  unbounded).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..models import camera
from ..ops.composite import composite
from ..ops.objects import ObjectSet
from ..terrain.store import Terrain
from .base import HitBuffer, RenderResult, fetch_flat
from .fast import build_refraction_table, separable_hits, terrain_bbox

SCALE = 1.5  # interpolating_rectilinear.rs:454
SEQUENCE = ((0, 0), (0, 1), (1, 0), (1, 1))  # :183


def gen_fov_data(width, height, fov, tilt, direction):
    """(ray_elev [H,W], ray_dir [H,W] radians, min_elev_step, min_dir_step).

    Transcribes gen_fov_data (:453-522): column-wise minimum elevation deltas
    and row-wise direction deltas, clamped below by fov_rad/width/3, times 1.5.
    """
    elev, dirr = camera.rectilinear_ray_params(width, height, fov, tilt, direction)
    # unwrap the atan2 direction about the camera: a view straddling the
    # ±180° seam must NOT make the snapped grid span ~360° of azimuth
    # (fused_culled_core unwraps the same seam; azimuth is periodic, so the
    # corner angles gj·min_ds stay physically identical mod 360°)
    dir_rad = math.radians(direction)
    dirr = dir_rad + np.mod(dirr - dir_rad + np.pi, 2.0 * np.pi) - np.pi
    min_diff = math.radians(fov) / width / 3.0

    dl_e = np.abs(np.diff(elev, axis=0))
    dl_e = np.maximum(dl_e, min_diff)
    min_elev_step = float(dl_e.min()) * SCALE if height > 1 else min_diff * SCALE

    dl_d = np.abs(np.diff(dirr, axis=1))
    dl_d = np.where(dl_d > 2 * np.pi, dl_d - 2 * np.pi, dl_d)
    dl_d = np.maximum(dl_d, min_diff)
    min_dir_step = float(dl_d.min()) * SCALE if width > 1 else min_diff * SCALE

    return elev, dirr, min_elev_step, min_dir_step


# ---------------------------------------------------------------------------
# 16-case interpolation in corner-WEIGHT space
# ---------------------------------------------------------------------------
#
# TracePoint::interpolate (generators/mod.rs:32-44) and the class-aware
# PixelColor::interpolate (mod.rs:68-78) special-case mixed-kind pairs — but
# a trace-point GROUP can never mix kinds (collect_trace_points :213-243
# groups only entries of equal kind), so within a group every reference lerp
# chain is a plain LINEAR combination of the ≤4 corner values. Each of the
# 16 presence cases (interpolating_rectilinear.rs:267-393) therefore reduces
# to one scalar weight per corner; the full TracePoint never needs to be
# threaded through the case tree. This is the flat tensor program that
# replaced the per-group bundle loop (it was ~30× the arithmetic).


def _interp_weights(present: jnp.ndarray, rem_e: jnp.ndarray, rem_d: jnp.ndarray):
    """Per-pixel corner weights for the 16-case presence match.

    present: [4, ...] bool in SEQUENCE order (e00, e01, e10, e11);
    rem_e/rem_d: [...] fractional positions. Returns (ok [...], w [4, ...])
    with w summing to 1 where ok.

    The corner axis LEADS (not trails), so all per-corner planes keep
    [H, W] minor.
    """
    re, rd = rem_e, rem_d
    one = jnp.ones_like(re)
    zero = jnp.zeros_like(re)
    true = jnp.ones_like(re, bool)

    def w4(w00=None, w01=None, w10=None, w11=None):
        return jnp.stack(
            [zero if w is None else w for w in (w00, w01, w10, w11)], axis=0
        )

    def two_adjacent(ia, ib, r_elev, r_dir):
        # :339-350 — valid iff r_elev < 0.5; lerp a→b by r_dir
        kw = {ia: 1.0 - r_dir, ib: r_dir}
        return (r_elev < 0.5), w4(**{f"w{k}": v for k, v in kw.items()})

    def two_diagonal(ia, ib, r_elev, r_dir):
        # :352-364
        ok = ~(((r_elev >= 0.5) & (r_dir < 0.5)) | ((r_elev < 0.5) & (r_dir >= 0.5)))
        denom = r_elev * r_dir + (1.0 - r_elev) * (1.0 - r_dir)
        coeff = r_elev * r_dir / jnp.maximum(denom, 1e-30)
        kw = {ia: 1.0 - coeff, ib: coeff}
        return ok, w4(**{f"w{k}": v for k, v in kw.items()})

    def three(ia, ib, ic, r_elev, r_dir):
        # :366-380 — lerp(lerp(a, b, r_dir), c, t), t = r_elev(1−r_dir)/s
        ok = ~((r_elev >= 0.5) & (r_dir >= 0.5))
        s = 1.0 - r_elev + r_elev * (1.0 - r_dir)
        t = r_elev * (1.0 - r_dir) / jnp.maximum(s, 1e-30)
        kw = {ia: (1.0 - r_dir) * (1.0 - t), ib: r_dir * (1.0 - t), ic: t}
        return ok, w4(**{f"w{k}": v for k, v in kw.items()})

    def four():
        # :333 — bilinear
        return true, w4(
            (1.0 - rd) * (1.0 - re), rd * (1.0 - re), (1.0 - rd) * re, rd * re
        )

    # presence-combination table, index = p00 + 2·p01 + 4·p10 + 8·p11
    # (corner ids: 00="00", 01="01", 10="10", 11="11")
    cases = [
        (jnp.zeros_like(re, bool), w4()),                        # none
        ((re < 0.5) & (rd < 0.5), w4(w00=one)),                  # e00 (:275-281)
        ((re < 0.5) & (rd >= 0.5), w4(w01=one)),                 # e01
        two_adjacent("00", "01", re, rd),                        # e00+e01 (:303)
        ((re >= 0.5) & (rd < 0.5), w4(w10=one)),                 # e10
        two_adjacent("00", "10", rd, re),                        # e00+e10 (:306)
        two_diagonal("01", "10", re, 1.0 - rd),                  # e01+e10 (:312)
        three("00", "01", "10", re, rd),                         # e00+e01+e10 (:321)
        ((re >= 0.5) & (rd >= 0.5), w4(w11=one)),                # e11
        two_diagonal("00", "11", re, rd),                        # e00+e11 (:309)
        two_adjacent("01", "11", 1.0 - rd, re),                  # e01+e11 (:315)
        three("01", "00", "11", re, 1.0 - rd),                   # e00+e01+e11 (:324)
        two_adjacent("10", "11", 1.0 - re, rd),                  # e10+e11 (:318)
        three("00", "11", "10", 1.0 - re, rd),                   # e00+e10+e11 (:327)
        three("11", "10", "01", 1.0 - re, 1.0 - rd),             # e01+e10+e11 (:330)
        four(),                                                  # all (:333)
    ]

    p = present.astype(jnp.int32)
    idx = p[0] + 2 * p[1] + 4 * p[2] + 8 * p[3]
    ok = jnp.zeros_like(re, bool)
    w = w4()
    for code, (c_ok, c_w) in enumerate(cases):
        m = idx == code
        ok = jnp.where(m, c_ok, ok)
        w = jnp.where(m[None], c_w, w)
    return ok, w


# entry counts up to this use the unrolled pairwise grouping (a flat graph
# of [H, W] plane ops — fastest at the benched plain-scene sizes, E = 4);
# above it the same math runs as three fori_loops over the entry axis, or the
# O(E²) unroll emits tens of thousands of HLO ops (E = 32 for an object
# scene's K = 8 grid) and XLA's backend blows up superlinearly — measured
# >30 min CPU cold compiles for a 64×48 frame.
_GROUP_UNROLL_MAX_E = 8


def _group_slot_ranks(ent_valid, dist, kind, step_size):
    """Trace-point grouping + slot ranking (collect_trace_points, :213-243).

    Inputs are [E, H, W] entry planes in corner-major creation order; the
    result is each entry's OUTPUT SLOT rank: groups (same-kind entries within
    one simulation step of any earlier member, reference semantics) ranked
    ascending by (min member distance, creation gid). Two implementations of
    identical math — unrolled plane ops for small E, fori_loops over the
    entry axis for large E (compile-size, see _GROUP_UNROLL_MAX_E) — pinned
    bit-identical by tests/test_interpolating.py::test_group_ranks_loop_parity
    (every op is an exact select/min/compare: no reassociation error).
    """
    if ent_valid.shape[0] <= _GROUP_UNROLL_MAX_E:
        return _group_slot_ranks_unrolled(ent_valid, dist, kind, step_size)
    return _group_slot_ranks_loop(ent_valid, dist, kind, step_size)


def _group_slot_ranks_unrolled(ent_valid, dist, kind, step_size):
    e_n, h_n, w_n = ent_valid.shape
    dist_key = jnp.where(ent_valid, dist, jnp.inf)
    d_list = [dist_key[i] for i in range(e_n)]
    k_list = [kind[i] for i in range(e_n)]
    v_list = [ent_valid[i] for i in range(e_n)]
    big_gid = jnp.float32(e_n + 1)  # > any real gid; min-identity
    gid_l, head_l = [], []
    next_gid = jnp.zeros((h_n, w_n), jnp.float32)
    for i in range(e_n):
        best = jnp.full((h_n, w_n), big_gid)
        for j in range(i):
            match = (
                v_list[i] & v_list[j]
                & (k_list[i] == k_list[j])
                & (jnp.abs(d_list[i] - d_list[j]) < step_size)
            )
            best = jnp.where(match, jnp.minimum(best, gid_l[j]), best)
        head = v_list[i] & (best >= big_gid)
        gid_l.append(jnp.where(head, next_gid, best))
        head_l.append(head)
        next_gid = next_gid + head.astype(jnp.float32)
    # slot ordering: rank groups by (min member distance, gid) ascending
    gmd_l = []  # per entry: its group's minimum distance
    for i in range(e_n):
        gmd = d_list[i]
        for j in range(e_n):
            if j == i:
                continue
            same = v_list[i] & v_list[j] & (gid_l[i] == gid_l[j])
            gmd = jnp.where(same, jnp.minimum(gmd, d_list[j]), gmd)
        gmd_l.append(gmd)
    rank_l = []
    for i in range(e_n):
        r = jnp.zeros((h_n, w_n), jnp.float32)
        for j in range(e_n):
            ahead = head_l[j] & (
                (gmd_l[j] < gmd_l[i])
                | ((gmd_l[j] == gmd_l[i]) & (gid_l[j] < gid_l[i]))
            )
            r = r + ahead.astype(jnp.float32)
        rank_l.append(r)
    return jnp.stack(rank_l, axis=0).astype(jnp.int32)


def _group_slot_ranks_loop(ent_valid, dist, kind, step_size):
    e_n = ent_valid.shape[0]
    dist_key = jnp.where(ent_valid, dist, jnp.inf)
    big_gid = jnp.float32(e_n + 1)
    jidx = jnp.arange(e_n, dtype=jnp.int32)[:, None, None]

    def row(x, i):  # [H, W] slice of an [E, H, W] plane stack
        return jax.lax.dynamic_index_in_dim(x, i, 0, keepdims=False)

    # pass 1 (sequential by construction): entry i joins the min gid over
    # matching EARLIER entries, else heads a new group. Rows ≥ i of `gid`
    # still hold the big_gid init but are masked off by jidx < i.
    def assign(i, carry):
        gid, head, next_gid = carry
        v_i, d_i, k_i = row(ent_valid, i), row(dist_key, i), row(kind, i)
        match = (
            v_i[None] & ent_valid & (kind == k_i[None])
            & (jnp.abs(dist_key - d_i[None]) < step_size)
            & (jidx < i)
        )
        best = jnp.min(jnp.where(match, gid, big_gid), axis=0)
        is_head = v_i & (best >= big_gid)
        gid = jax.lax.dynamic_update_index_in_dim(
            gid, jnp.where(is_head, next_gid, best), i, 0
        )
        head = jax.lax.dynamic_update_index_in_dim(head, is_head, i, 0)
        return gid, head, next_gid + is_head.astype(jnp.float32)

    gid, head, _ = jax.lax.fori_loop(
        0, e_n, assign,
        (
            jnp.full(ent_valid.shape, big_gid),
            jnp.zeros(ent_valid.shape, bool),
            jnp.zeros(ent_valid.shape[1:], jnp.float32),
        ),
    )

    # pass 2: per entry, its group's minimum member distance (j == i folds
    # into the running min as min(d_i, d_i) — identical to skipping it)
    def group_min(j, gmd):
        v_j, d_j, g_j = row(ent_valid, j), row(dist_key, j), row(gid, j)
        same = ent_valid & v_j[None] & (gid == g_j[None])
        return jnp.where(same, jnp.minimum(gmd, d_j[None]), gmd)

    gmd = jax.lax.fori_loop(0, e_n, group_min, dist_key)

    # pass 3: rank = number of group heads strictly ahead by
    # (min distance, creation gid)
    def count_ahead(j, r):
        h_j, m_j, g_j = row(head, j), row(gmd, j), row(gid, j)
        ahead = h_j[None] & (
            (m_j[None] < gmd) | ((m_j[None] == gmd) & (g_j[None] < gid))
        )
        return r + ahead.astype(jnp.float32)

    rank = jax.lax.fori_loop(
        0, e_n, count_ahead, jnp.zeros(ent_valid.shape, jnp.float32)
    )
    return rank.astype(jnp.int32)


def _interpolate_pixels(grid: HitBuffer, gi, gj, rem_e, rem_d, step_size,
                        k_out: int, has_objects: bool = True) -> HitBuffer:
    """Per-output-pixel corner gather + grouping + interpolation.

    grid: HitBuffer [H', W', K]; gi/gj: [H, W] corner indices into the grid;
    rem_e/rem_d: [H, W] fractional positions. ``has_objects=False`` packs
    only the nine non-constant channels into the corner-gather rows (see
    below) — outputs are identical either way.

    Grouping is the reference's collect_trace_points (:213-243) EXACTLY:
    entries iterate in corner-major creation order (SEQUENCE corners, each
    corner's slots ascending), and each entry joins the FIRST existing group
    (lowest id) containing ANY member of the same kind within one simulation
    step, else opens a new group. An other-kind entry interleaved between two
    close same-kind entries therefore never splits their group. E = 4·K is
    tiny, so the membership test runs as an unrolled O(E²) pairwise pass of
    [H, W] compare/select planes — no sorts, no gathers. Output slots order
    groups ascending by their minimum distance (the front-to-back order the
    compositor needs; the reference emits creation order, which only differs
    when corner hit distances interleave non-monotonically — documented in
    PARITY.md).
    """
    hp, wp, kg = grid.valid.shape
    h_n, w_n = gi.shape
    e_n = 4 * kg  # entries per pixel, corner-major (SEQUENCE), slot ascending

    # -- corner fetch: TWO packed row gathers, not 4 corners × 9 fields ------
    # Every channel of every slot of a grid cell is packed into one
    # contiguous row, rows of horizontally-ADJACENT cells are concatenated
    # (the 4 corners are two adjacent pairs), and one gather per corner row
    # delivers everything instead of 36 separate jnp.takes. A no-object
    # scene drops the five channels that are then compile-time constants
    # (kind = 0, rgba = [0,0,0,terrain_alpha]): 14 → 9 channels per row;
    # the constants are re-broadcast below and fold into the weight
    # arithmetic.
    if has_objects:
        _CH = ("valid", "dlat", "dlon", "distance", "elevation",
               "path_length", "nx", "ny", "nz", "kind", "cr", "cg", "cb",
               "ca")
    else:
        _CH = ("valid", "dlat", "dlon", "distance", "elevation",
               "path_length", "nx", "ny", "nz")
    n_ch = len(_CH)
    comp = [
        grid.valid.astype(jnp.float32), grid.dlat, grid.dlon, grid.distance,
        grid.elevation, grid.path_length,
        grid.normal[..., 0], grid.normal[..., 1], grid.normal[..., 2],
    ]
    if has_objects:
        comp += [
            grid.kind.astype(jnp.float32),
            grid.rgba[..., 0], grid.rgba[..., 1], grid.rgba[..., 2],
            grid.rgba[..., 3],
        ]
    packed = jnp.stack(comp, axis=-1).reshape(hp, wp, kg * n_ch)
    pair = jnp.concatenate([packed[:, :-1], packed[:, 1:]], axis=-1).reshape(
        hp * (wp - 1), 2 * kg * n_ch
    )
    col = jnp.clip(gj, 0, wp - 2)
    idx_t = jnp.clip(gi, 0, hp - 1) * (wp - 1) + col
    idx_b = jnp.clip(gi + 1, 0, hp - 1) * (wp - 1) + col
    # channel-leading behind a barrier: the raw gather output [H, W, C] has
    # the tiny channel axis minor; per-channel plane slices of that layout
    # pad ~30× (see fast._separable_hit_planes for the measured failure)
    top = jax.lax.optimization_barrier(
        jnp.moveaxis(jnp.take(pair, idx_t, axis=0), -1, 0)
    )  # [2·kg·n_ch, H, W] — corners (0,0) then (0,1)
    bot = jax.lax.optimization_barrier(
        jnp.moveaxis(jnp.take(pair, idx_b, axis=0), -1, 0)
    )  # corners (1,0) then (1,1)

    # entries as [E, H, W] per channel, corner-major (SEQUENCE), slot
    # ascending — the entry axis LEADS so every op below tiles on [H, W]
    def entry_planes(name):
        f = _CH.index(name)
        planes = []
        for src, half in ((top, 0), (top, 1), (bot, 0), (bot, 1)):
            for s in range(kg):
                planes.append(src[half * kg * n_ch + s * n_ch + f])
        return jnp.stack(planes, axis=0)

    ent = {name: entry_planes(name) for name in _CH if name != "valid"}
    if not has_objects:
        # constants for terrain-only scenes (fast.py builds every slot's
        # rgba as [0, 0, 0, terrain_alpha] and kind as 0 regardless of
        # validity, and invalid entries never reach a group): broadcast,
        # never gathered nor materialized
        zero = jnp.broadcast_to(
            jnp.float32(0.0), (e_n, h_n, w_n)
        )
        ent["kind"] = zero
        ent["cr"] = ent["cg"] = ent["cb"] = zero
        ent["ca"] = jnp.broadcast_to(grid.rgba[0, 0, 0, 3], (e_n, h_n, w_n))
    in_grid = (
        (gi >= 0) & (gi + 1 < hp) & (gj >= 0) & (gj + 1 < wp)
    )
    ent_valid = (entry_planes("valid") > 0.5) & in_grid[None]

    # -- grouping: exact collect_trace_points (:213-243) ---------------------
    # Pairwise same-kind closeness in corner-major entry order; entry i
    # joins min gid over matching earlier entries, else opens a new group.
    gid = _group_slot_ranks(
        ent_valid, ent["distance"], ent["kind"], step_size
    )  # [E, H, W] slot rank

    # -- per output slot g (nearest k_out groups): last-entry-per-corner
    #    selection (match_sequence :245-265) + weight-space interpolation ----
    slot_valid, slot_fields = [], []
    for g in range(k_out):
        member = ent_valid & (gid == g)  # [E, H, W]
        m4 = member.reshape(4, kg, h_n, w_n)
        present = m4.any(1)  # [4, H, W]
        # one-hot of the LAST member per corner ("later entries overwrite")
        suffix = jnp.flip(jnp.cumsum(jnp.flip(m4, 1), axis=1), 1)
        onehot = (m4 & (suffix == 1)).astype(jnp.float32)  # [4, kg, H, W]

        def corner_val(x):
            if x.ndim == 3:
                return (x.reshape(4, kg, h_n, w_n) * onehot).sum(1)
            d = x.shape[-1]
            return (
                x.reshape(4, kg, h_n, w_n, d) * onehot[..., None]
            ).sum(1)  # [4, H, W, D]

        ok, w = _interp_weights(present, rem_e, rem_d)
        valid_g = present.any(0) & ok

        out = {}
        for name in ("dlat", "dlon", "distance", "elevation", "path_length",
                     "nx", "ny", "nz", "cr", "cg", "cb", "ca"):
            out[name] = (corner_val(ent[name]) * w).sum(0)
        # kinds are equal across the group — take any present corner's
        kind4 = corner_val(ent["kind"])
        out["kind"] = jnp.max(
            jnp.where(present, kind4, 0.0), axis=0
        ).astype(jnp.int32)
        slot_valid.append(valid_g)
        slot_fields.append(out)

    valid_out = jnp.stack(slot_valid, axis=-1)  # [H, W, k_out]
    tp = {
        kf: jnp.stack([s[kf] for s in slot_fields], axis=2)
        for kf in slot_fields[0]
    }
    # key honors the HitBuffer contract (base.py: march sort position
    # k + prop, so distance ≈ key·step) — meta/pack derives viewer distance
    # from it; a slot-rank key would silently corrupt staged metadata.
    # Interpolated slots ascend in distance (groups are emitted ascending
    # by min distance), so key stays ascending as required.
    return HitBuffer(
        valid=valid_out,
        key=jnp.where(
            valid_out, tp["distance"] / jnp.float32(step_size), jnp.inf
        ),
        dlat=tp["dlat"],
        dlon=tp["dlon"],
        distance=tp["distance"],
        elevation=tp["elevation"],
        path_length=tp["path_length"],
        normal=jnp.stack([tp["nx"], tp["ny"], tp["nz"]], axis=-1),
        kind=tp["kind"],
        rgba=jnp.stack([tp["cr"], tp["cg"], tp["cb"], tp["ca"]], axis=-1),
    )


def interpolating_core(
    pack, table, objects, grid_elev_deg, grid_az_deg, alt0, *,
    cam, min_es, min_ds, i_min, j_min,
    model, shape, straight, step, n_terr, max_hits, lat0, lon0,
    coloring, fog_distance, terrain_alpha, obj_windows=None,
    with_progress=False, row_sharding=None,
):
    # per-pixel grid coordinates are derived ON device from the (static)
    # camera parameters — uploading four [H, W] arrays through the host link
    # costs more than the whole render (models.camera note)
    width, height, fov, tilt, direction = cam
    elev, dirr = camera.rectilinear_ray_params_device(
        width, height, fov, tilt, direction
    )
    # unwrap about the camera direction — must mirror gen_fov_data's host
    # unwrap exactly or gi/gj land outside the host-derived grid extents
    dir_rad = jnp.float32(math.radians(direction))
    pi = jnp.float32(math.pi)
    dirr = dir_rad + jnp.mod(dirr - dir_rad + pi, 2.0 * pi) - pi
    ei_f = elev / jnp.float32(min_es)
    dj_f = dirr / jnp.float32(min_ds)
    gi_abs = jnp.floor(ei_f)
    gj_abs = jnp.floor(dj_f)
    gi = gi_abs.astype(jnp.int32) - i_min
    gj = gj_abs.astype(jnp.int32) - j_min
    rem_e = ei_f - gi_abs
    rem_d = dj_f - gj_abs
    if row_sharding is not None:
        # multi-chip: the snapped GRID computes column-sharded (from the
        # sharded grid_az_deg input); the per-output-pixel interpolation
        # partitions by image rows — XLA SPMD inserts the one all-gather of
        # the modest [He, We] grid planes at this seam
        gi, gj, rem_e, rem_d = (
            jax.lax.with_sharding_constraint(x, row_sharding)
            for x in (gi, gj, rem_e, rem_d)
        )

    # grid slot count vs OUTPUT slot count are different knobs: an opaque
    # no-object scene puts at most ONE trace point in any grid cell, so a
    # second grid slot is always-invalid ballast that doubles the packed
    # corner-gather rows. k_out keeps the full
    # 2·max_hits so the 4 corner-major groups still all fit: outputs are
    # bit-identical (invalid entries never join groups).
    grid_hits = (
        1 if (objects is None and terrain_alpha >= 1.0) else max_hits
    )
    grid = separable_hits(
        pack, table, objects, grid_elev_deg, grid_az_deg, alt0,
        model=model, shape=shape, straight=straight, step=step, n_terr=n_terr,
        max_hits=grid_hits, lat0=lat0, lon0=lon0,
        terrain_alpha=terrain_alpha,
        obj_windows=obj_windows, with_progress=with_progress,
    )
    hits = _interpolate_pixels(
        grid, gi, gj, rem_e, rem_d, step, 2 * max_hits,
        has_objects=objects is not None,
    )
    image = composite(
        coloring, fog_distance,
        hits.valid, hits.rgba[..., 3], hits.distance, hits.elevation,
        hits.path_length, hits.normal, hits.kind, hits.rgba[..., :3],
    )
    return image.reshape(-1), hits


_interp_device = functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "min_es", "min_ds", "i_min", "j_min",
        "model", "shape", "straight", "step", "n_terr", "max_hits", "lat0",
        "lon0", "coloring", "fog_distance", "terrain_alpha", "obj_windows",
        "with_progress", "row_sharding",
    ),
)(interpolating_core)


@functools.lru_cache(maxsize=8)
def _camera_grids(width, height, fov, tilt, direction):
    """Camera-only host geometry: snapped-grid extents + output angles.

    ~0.45 s of f64 numpy at 1080p (gen_fov_data + the 4-corner bilinear of
    ResultPixel angles, :408-415) that depends on nothing but the camera —
    cached so repeated renders pay it once.
    """
    elev, dirr, min_es, min_ds = gen_fov_data(width, height, fov, tilt, direction)
    ei_f = elev / min_es
    dj_f = dirr / min_ds
    gi_abs = np.floor(ei_f).astype(np.int64)
    gj_abs = np.floor(dj_f).astype(np.int64)
    rem_e = ei_f - gi_abs
    rem_d = dj_f - gj_abs
    # widen the grid one cell each way: the device recomputes the pixel
    # angles in f32 (interpolating_core), and a boundary pixel's floor may
    # land one cell past the host-f64 extremes
    i_min, i_max = int(gi_abs.min()) - 1, int(gi_abs.max()) + 2
    j_min, j_max = int(gj_abs.min()) - 1, int(gj_abs.max()) + 2
    grid_elev_deg = np.rad2deg(np.arange(i_min, i_max + 1) * min_es)
    grid_az_deg = np.rad2deg(np.arange(j_min, j_max + 1) * min_ds)

    # ResultPixel angles: bilinear of the 4 corner grid angles (:408-415)
    corner_e = (gi_abs[..., None] + np.array([0, 0, 1, 1])) * min_es
    corner_d = (gj_abs[..., None] + np.array([0, 1, 0, 1])) * min_ds
    wts = np.stack(
        [
            (1 - rem_e) * (1 - rem_d),
            (1 - rem_e) * rem_d,
            rem_e * (1 - rem_d),
            rem_e * rem_d,
        ],
        axis=-1,
    )
    elev_out = np.rad2deg((corner_e * wts).sum(-1))
    az_out = camera.wrap_azimuth_deg(np.rad2deg((corner_d * wts).sum(-1)))
    return min_es, min_ds, i_min, j_min, grid_elev_deg, grid_az_deg, elev_out, az_out


def render_interpolating(
    params: Params, terrain: Terrain, max_hits: Optional[int] = None,
    progress=None, mesh=None, fetch_image: bool = True,
) -> RenderResult:
    """Full InterpolatingRectilinear render (:110-161).

    ``progress`` (if given) receives whole-percent completion values — the
    device analog of the reference's per-percent pixel counter
    (interpolating_rectilinear.rs:141-150), emitted from the grid march scan
    on callback-capable backends and always closed with a final 100.

    ``fetch_image=False`` leaves ``result.image`` device-resident in the
    core's native FLAT [H*W*3] u8 layout (callers that want to time or
    overlap the device→host transfer fetch it via ``base.fetch_flat`` and
    reshape to (H, W, 3) themselves).

    ``mesh`` (if given) runs multi-chip: the snapped grid computes with its
    azimuth COLUMNS sharded (exactly like the Fast frame) and the
    per-output-pixel interpolation partitions by image ROWS, with one
    in-program all-gather of the grid planes between — bit-identical to
    single-chip (the grid's padded extra columns are never referenced).
    """
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)

    (min_es, min_ds, i_min, j_min, grid_elev_deg, grid_az_deg,
     elev_out, az_out) = _camera_grids(
        out.width, out.height, float(frame.fov), float(frame.tilt),
        float(frame.direction),
    )

    row_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        n_dev = mesh.devices.size
        padn = (-grid_az_deg.shape[0]) % n_dev
        if padn:  # continue the snapped progression; extra columns render
            # but no output pixel's gj ever points at them
            n0 = grid_az_deg.shape[0]
            grid_az_deg = np.concatenate([
                grid_az_deg,
                np.rad2deg(np.arange(j_min + n0, j_min + n0 + padn) * min_ds),
            ])
        col_sharding = NamedSharding(mesh, P(axis))
        repl = NamedSharding(mesh, P())
        row_sharding = NamedSharding(mesh, P(axis, None))

    lat_rng, lon_rng = terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 2 if params.terrain_alpha >= 1.0 else 4
    from .fast import build_objects_cached

    objset, obj_windows = build_objects_cached(
        params, grid_az_deg, n_terr
    )

    grid_elev_dev = jnp.asarray(grid_elev_deg, jnp.float32)
    grid_az_dev = jnp.asarray(grid_az_deg, jnp.float32)
    if mesh is not None:
        pack = jax.device_put(pack, repl)
        table = jax.device_put(table, repl)
        objset = jax.device_put(objset, repl) if objset is not None else None
        grid_elev_dev = jax.device_put(grid_elev_dev, repl)
        grid_az_dev = jax.device_put(grid_az_dev, col_sharding)

    from .base import callbacks_supported, set_progress_sink

    with_progress = progress is not None and callbacks_supported()
    set_progress_sink(progress)
    try:  # finally clears the module sink even if the device call raises
        image, hits = _interp_device(
            pack, table, objset,
            grid_elev_dev,
            grid_az_dev,
            float(alt0),
            cam=(out.width, out.height, float(frame.fov), float(frame.tilt),
                 float(frame.direction)),
            min_es=float(min_es),
            min_ds=float(min_ds),
            i_min=i_min,
            j_min=j_min,
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
            row_sharding=row_sharding,
        )
        # flat fetch: [H, W, 3] u8 de-tiles on device otherwise (the core
        # returns the frame pre-flattened)
        image_host = (
            fetch_flat(image).reshape(out.height, out.width, 3)
            if fetch_image else image
        )
    finally:
        set_progress_sink(None)
    if progress is not None:
        progress(100)  # close the counter (straight-ray path has no scan)

    return RenderResult(
        image=image_host,
        hits=hits,  # device-resident; see generators.fast note
        elevation_deg=elev_out,
        azimuth_deg=az_out,
        observer=(pos.latitude, pos.longitude, alt0),
    )
