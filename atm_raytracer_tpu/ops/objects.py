"""Scene objects: frustum + billboard intersection, culling, hit merging.

Re-implements the reference's ``Object`` trait (src/object/mod.rs:217-226)
and its two impls — analytic segment-vs-cone-frustum (src/object/frustum.rs)
and textured billboard (src/object/billboard.rs) — as dense vmapped segment
tests over culled candidate windows.

Reference control flow being replaced: per terrain point, ``objects_close``
collects indices of objects whose cartesian distance² < 2·(r+step)²
(frustum.rs:103-114, billboard.rs:68-78, gathered in utils.rs:71-89); per
march segment, each close object's ``check_collision`` runs on the segment
endpoints (utils.rs:241-279). Here each object gets a static
(column-window × step-window) around its culling region, every (ray ×
window-segment) test runs in lockstep, and per-pixel results reduce to the K
earliest hits.

The column windows (``object_col_windows``) are computed on HOST per render
from the model's own f64 geodesics: only azimuth columns whose geodesic
passes within the culling radius participate, so the per-object candidate
tensors are [H, W_window, seg_window] instead of [H, W, seg_window] — the
memory bound that lets 1080p-class object scenes compile — and each object
merges into just its window of the frame's hit buffer.

Geometry runs in each object's local ENU frame (models.earth.enu_rel):
mm-accurate in f32 within culling radii, and the frame's up vector IS the
reference's ``v = world_directions(...).2`` (frustum.rs:31-34). Normals are
rotated back to global cartesian with the object's host-precomputed basis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.earth import EarthModel
from .combine import NO_HIT
from ..physics.ray import DEATH_ALTITUDE
from ..generators.base import HitBuffer


def _materialize(x: jnp.ndarray) -> jnp.ndarray:
    """Backend-proof materialization point for a hot intermediate.

    On the GPU an ``optimization_barrier`` stops XLA from rematerializing
    the producer chain into every consumer: XLA's GPU pipeline honours the
    barrier (the objects scene of chip_smoke.py runs it). The XLA *CPU*
    pipeline strips
    barriers, then re-fuses the trig-heavy ``enu_rel`` chain into each of
    the ~1500 downstream merge references (minutes of runtime at tiny test
    shapes). Sorts are never treated as fusible elementwise ops, so on CPU
    the tensor is routed through an identity sort instead: a key-value sort
    along the last axis keyed on an already-sorted iota returns ``x``
    bit-identically but forces a real buffer. (A singleton-axis sort would
    not do — the algebraic simplifier strips trivial sorts.)
    """
    if jax.default_backend() != "cpu":
        return jax.lax.optimization_barrier(x)
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    _, out = jax.lax.sort((idx, x), dimension=x.ndim - 1, num_keys=1)
    return out


def local_normals_to_global(n_loc: jnp.ndarray, basis: jnp.ndarray):
    """Rotate [..., 3] local (east, north, up) normals to global cartesian
    with an object's ``basis`` [3, 3] (rows = east, north, up).

    HIGHEST precision: on the GPU a float32 contraction may otherwise run
    in TF32, which keeps about three decimal digits."""
    return jnp.einsum("...c,cd->...d", n_loc, basis,
                      precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ObjectSet:
    """Host-built, device-resident object arrays (one entry per object)."""

    kind: jnp.ndarray  # [n] int32: 0 frustum, 1 billboard
    dlat: jnp.ndarray  # [n] f32 relative to observer
    dlon: jnp.ndarray
    elev: jnp.ndarray  # [n] absolute altitude of the object base
    r1: jnp.ndarray
    r2: jnp.ndarray
    height: jnp.ndarray
    width: jnp.ndarray
    rgba: jnp.ndarray  # [n, 4]
    basis: jnp.ndarray  # [n, 3, 3] rows = (east, north, up) global cartesian
    tex_id: jnp.ndarray  # [n] int32, -1 = untextured
    textures: jnp.ndarray  # [T, TH, TW, 4] f32 atlas (T ≥ 1)
    tex_hw: jnp.ndarray  # [T, 2] f32 true (h, w) of each texture
    cull_r2: jnp.ndarray  # [n] culling radius², includes sim step
    # static python metadata
    n_objects: int
    seg_window: int  # march-steps window (covers the culling chord)
    kinds_static: tuple  # per-object kind (0 frustum / 1 billboard), static
    # host-side per-object (lat, lon, elev, cull_radius_m) for window
    # planning (object_col_windows); static floats, part of the jit key
    host_meta: tuple = ()

    def tree_flatten(self):
        children = (
            self.kind, self.dlat, self.dlon, self.elev, self.r1, self.r2,
            self.height, self.width, self.rgba, self.basis, self.tex_id,
            self.textures, self.tex_hw, self.cull_r2,
        )
        return children, (self.n_objects, self.seg_window, self.kinds_static,
                          self.host_meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, n_objects=aux[0], seg_window=aux[1],
                   kinds_static=aux[2], host_meta=aux[3])

    @staticmethod
    def build(params) -> Optional["ObjectSet"]:
        objs = params.objects
        if not objs:
            return None
        lat0 = params.view.position.latitude
        lon0 = params.view.position.longitude
        step = params.simulation_step
        n = len(objs)
        kind = np.zeros(n, np.int32)
        dlat = np.zeros(n, np.float32)
        dlon = np.zeros(n, np.float32)
        elev = np.zeros(n, np.float32)
        r1 = np.zeros(n, np.float32)
        r2 = np.zeros(n, np.float32)
        height = np.zeros(n, np.float32)
        width = np.zeros(n, np.float32)
        rgba = np.zeros((n, 4), np.float32)
        basis = np.zeros((n, 3, 3), np.float32)
        tex_id = np.full(n, -1, np.int32)
        cull_r2 = np.zeros(n, np.float32)
        textures: List[np.ndarray] = []
        for i, o in enumerate(objs):
            kind[i] = 0 if o.kind == "Frustum" else 1
            dlat[i] = o.lat - lat0
            dlon[i] = o.lon - lon0
            elev[i] = o.elev
            r1[i], r2[i] = o.r1, o.r2
            height[i] = o.height
            width[i] = o.width
            rgba[i] = (o.color.r, o.color.g, o.color.b, o.color.a)
            north, east, up = params.model.world_directions(o.lat, o.lon)
            basis[i] = np.stack([east, north, up])
            if o.kind == "Frustum":
                r = max(o.r1, o.r2)
                cull_r2[i] = 2.0 * (r + step) ** 2  # frustum.rs:113
            else:
                cull_r2[i] = 2.0 * (o.width + step) ** 2  # billboard.rs:77
            if o.texture is not None:
                tex_id[i] = len(textures)
                textures.append(o.texture.astype(np.float32))
        if textures:
            th = max(t.shape[0] for t in textures)
            tw = max(t.shape[1] for t in textures)
            atlas = np.zeros((len(textures), th, tw, 4), np.float32)
            tex_hw = np.zeros((len(textures), 2), np.float32)
            for t_i, t in enumerate(textures):
                atlas[t_i, : t.shape[0], : t.shape[1]] = t
                tex_hw[t_i] = (t.shape[0], t.shape[1])
        else:
            atlas = np.zeros((1, 2, 2, 4), np.float32)
            tex_hw = np.ones((1, 2), np.float32) * 2
        # window of march segments covering the culling chord: the close
        # region along a ray is at most 2·cull_radius long. The cap only
        # bounds candidate-tensor memory for pathological giants (>12 km
        # culling radius at 50 m steps); within it the window always covers
        # the full chord — the reference tests every close segment
        # (utils.rs:241-250) and a short window would silently drop hits.
        max_chord = 2.0 * math.sqrt(float(cull_r2.max()))
        want = max(4, math.ceil(max_chord / step) + 3)
        seg_window = int(min(512, want))
        if want > seg_window:
            print(
                f"WARNING: object culling window truncated to {seg_window} "
                f"of {want} march steps — intersections beyond "
                f"{seg_window * step:.0f} m into the culling region of the "
                "largest object will be missed"
            )
        host_meta = tuple(
            (float(o.lat), float(o.lon), float(o.elev),
             float(math.sqrt(cull_r2[i])))
            for i, o in enumerate(objs)
        )
        return ObjectSet(
            kind=jnp.asarray(kind), dlat=jnp.asarray(dlat), dlon=jnp.asarray(dlon),
            elev=jnp.asarray(elev), r1=jnp.asarray(r1), r2=jnp.asarray(r2),
            height=jnp.asarray(height), width=jnp.asarray(width),
            rgba=jnp.asarray(rgba), basis=jnp.asarray(basis),
            tex_id=jnp.asarray(tex_id), textures=jnp.asarray(atlas),
            tex_hw=jnp.asarray(tex_hw), cull_r2=jnp.asarray(cull_r2),
            n_objects=n, seg_window=seg_window,
            kinds_static=tuple(int(k) for k in kind),
            host_meta=host_meta,
        )


def ray_death_index(ray_h: jnp.ndarray) -> jnp.ndarray:
    """First sub-DEATH_ALTITUDE march index per ray, n_path if none ([H] f32).

    Segment k participates in object tests iff k <= this index — the
    reference's path cache ends one element after the first dead sample
    (utils.rs:159-171), so its object loop never sees later segments.
    """
    n_path = ray_h.shape[1]
    dead_r = ray_h < jnp.float32(DEATH_ALTITUDE)  # [H, N]
    return jnp.where(
        dead_r.any(1), jnp.argmax(dead_r, 1), n_path
    ).astype(jnp.float32)


def object_col_windows(
    objects: ObjectSet,
    model: EarthModel,
    lat0: float,
    lon0: float,
    az_deg: np.ndarray,
    step: float,
    n_terr: int,
    stride: int = 2,
    pad: int = 2,
) -> tuple:
    """Static per-object azimuth-column windows for the separable generators.

    For each object, the columns whose geodesic ray passes within its culling
    radius (``is_close``, frustum.rs:103-114) — everything outside can never
    intersect, so the device program only builds candidate tensors over the
    window. Computed with the model's own host-f64 geodesics
    (``coords_at_dist_host``) at ``stride`` march-steps of along-track
    resolution, widened by the between-sample movement bound (stride·step)
    plus ``pad`` columns — conservative for every earth model.

    Returns a tuple of (col_lo, n_cols) per object; n_cols = 0 means the
    object is out of view for this azimuth grid.
    """
    az = np.asarray(az_deg, np.float64)
    w = az.shape[0]
    dists = np.arange(1, max(n_terr, 2), stride, np.float64) * step  # [D]
    glat, glon = model.coords_at_dist_host(lat0, lon0, az[:, None], dists[None, :])
    # cartesian at elevation 0: raising both the geodesic point and the
    # object by the object's altitude changes their separation by at most
    # |p−c|·elev/R — negligible at culling-radius scales (see margin)
    p = model.as_cartesian(glat, glon, np.zeros_like(glat))  # [W, D, 3]
    meta = np.asarray(
        [(m[0], m[1], m[3]) for m in objects.host_meta], np.float64
    )  # [n] (lat, lon, cull_r)
    c = model.as_cartesian(meta[:, 0], meta[:, 1], np.zeros(len(meta)))  # [n, 3]
    # one vectorized pass over all objects: [n, W] min distance² over D,
    # via |p|² + |c|² − 2 p·c (the p·c term is one BLAS matmul)
    p2 = (p * p).sum(-1)  # [W, D]
    c2 = (c * c).sum(-1)  # [n]
    pc = p.reshape(-1, 3) @ c.T  # [W·D, n]
    d2 = (
        (p2.reshape(-1, 1) + c2[None, :] - 2.0 * pc)
        .reshape(w, -1, len(meta)).min(axis=1).T
    )
    rr = meta[:, 2] + stride * step + 1.0
    windows = []
    for oi in range(len(meta)):
        idx = np.nonzero(d2[oi] < rr[oi] * rr[oi])[0]
        if idx.size == 0:
            windows.append((0, 0))
            continue
        lo = max(0, int(idx[0]) - pad)
        hi = min(w - 1, int(idx[-1]) + pad)
        windows.append((lo, hi - lo + 1))
    return tuple(windows)


def pad_hit_slots(hb: HitBuffer, k: int) -> HitBuffer:
    """Widen a hit buffer to k slots; new slots are invalid (+inf keys)."""
    k0 = hb.k_slots
    if k0 == k:
        return hb
    base = hb.valid.ndim

    def pad(x, fill=0):
        ax = x.ndim - 1 if x.ndim == base else x.ndim - 2
        pads = [(0, 0)] * x.ndim
        pads[ax] = (0, k - k0)
        return jnp.pad(x, pads, constant_values=fill)

    return HitBuffer(
        valid=pad(hb.valid, False), key=pad(hb.key, NO_HIT),
        dlat=pad(hb.dlat), dlon=pad(hb.dlon), distance=pad(hb.distance),
        elevation=pad(hb.elevation), path_length=pad(hb.path_length),
        normal=pad(hb.normal), kind=pad(hb.kind), rgba=pad(hb.rgba),
    )


def _sample_texture(textures, tex_hw, tex_id, u, v):
    """Bilinear RGBA texture sample (object/mod.rs:89-118).

    u ∈ [0,1] across width, v ∈ [0,1] bottom→top; image rows are top-first.
    """
    t = jnp.maximum(tex_id, 0)
    th = tex_hw[t, 0]
    tw = tex_hw[t, 1]
    x = u * tw - 0.5
    x1 = jnp.clip(jnp.floor(x), 0.0, tw - 2.0)
    y = (1.0 - v) * th - 0.5
    y1 = jnp.clip(jnp.floor(y), 0.0, th - 2.0)
    px = (x - x1)[..., None]
    py = (y - y1)[..., None]
    ix = x1.astype(jnp.int32)
    iy = y1.astype(jnp.int32)
    tt, hh, ww, _ = textures.shape
    flat = textures.reshape(-1, 4)
    base = t * (hh * ww) + iy * ww + ix
    p00 = jnp.take(flat, base, axis=0)
    p01 = jnp.take(flat, base + ww, axis=0)
    p10 = jnp.take(flat, base + 1, axis=0)
    p11 = jnp.take(flat, base + ww + 1, axis=0)
    return (
        p00 * (1 - px) * (1 - py)
        + p01 * (1 - px) * py
        + p10 * px * (1 - py)
        + p11 * px * py
    )


def _frustum_hits(p1, p2, r1, r2, height):
    """Segment-vs-frustum (frustum.rs:17-101) in the object frame (v = ẑ).

    p1, p2: [..., 3]. Returns (props [..., 4], normals [..., 4, 3],
    valid [..., 4]): two side roots + bottom/top caps.
    """
    w = p2 - p1
    wsq = (w * w).sum(-1)
    p1sq = (p1 * p1).sum(-1)
    p1v = p1[..., 2]
    p1w = (p1 * w).sum(-1)
    wv = w[..., 2]
    aa = (r2 - r1) / height
    aa1 = 1.0 + aa * aa
    a = wsq - wv * wv * aa1
    b = 2.0 * (p1w - wv * (p1v * aa1 + aa * r1))
    c = p1sq - p1v * p1v * aa1 - r1 * r1 - 2.0 * aa * r1 * p1v
    delta = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    safe_a = jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    x1 = (-b - sq) / (2.0 * safe_a)
    x2 = (-b + sq) / (2.0 * safe_a)
    lo = jnp.where(a < 0.0, x2, x1)  # frustum.rs:56
    hi = jnp.where(a < 0.0, x1, x2)

    def side(x):
        inter = p1 + w * x[..., None]
        h = inter[..., 2]
        ok = (delta >= 0.0) & (x >= 0.0) & (x < 1.0) & (h >= 0.0) & (h < height)
        outward = inter - h[..., None] * jnp.array([0.0, 0.0, 1.0])
        olen = jnp.sqrt((outward * outward).sum(-1))
        outward = outward / jnp.maximum(olen, 1e-30)[..., None]
        ang = jnp.arctan2(r1 - r2, height)
        normal = outward * jnp.cos(ang) + jnp.array([0.0, 0.0, 1.0]) * jnp.sin(ang)
        return x, normal, ok

    def cap(h_cap, r_cap, n_sign):
        safe_wv = jnp.where(jnp.abs(wv) < 1e-12, 1e-12, wv)
        x = (h_cap - p1v) / safe_wv
        out = p1 + w * x[..., None] - h_cap * jnp.array([0.0, 0.0, 1.0])
        d = (out * out).sum(-1)
        ok = (d < r_cap * r_cap) & (x >= 0.0) & (x < 1.0)
        normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]) * n_sign, out.shape)
        return x, normal, ok

    xs1, n1, ok1 = side(lo)
    xs2, n2, ok2 = side(hi)
    xc1, nc1, okc1 = cap(0.0, r1, -1.0)
    xc2, nc2, okc2 = cap(height, r2, 1.0)
    props = jnp.stack([xs1, xs2, xc1, xc2], axis=-1)
    normals = jnp.stack([n1, n2, nc1, nc2], axis=-2)
    valid = jnp.stack([ok1, ok2, okc1, okc2], axis=-1)
    return props, normals, valid


def _billboard_hit(p1, p2, width, height):
    """Segment-vs-billboard (billboard.rs:17-66): upright rectangle always
    facing the ray. Returns (prop, normal [...,3], u, v, valid)."""
    ray = p2 - p1
    up = jnp.array([0.0, 0.0, 1.0])
    right = jnp.cross(ray, jnp.broadcast_to(up, ray.shape))
    rlen = jnp.sqrt((right * right).sum(-1))
    right = right / jnp.maximum(rlen, 1e-30)[..., None]
    front = jnp.cross(right, jnp.broadcast_to(up, right.shape))
    denom = (ray * front).sum(-1)
    safe = jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
    prop = -(p1 * front).sum(-1) / safe
    inter = p1 + ray * prop[..., None]
    y = inter[..., 2]
    x = (inter * right).sum(-1)
    ok = (
        (prop >= 0.0) & (prop < 1.0)
        & (y >= 0.0) & (y < height)
        & (x >= -width / 2.0) & (x < width / 2.0)
    )
    u = (x + width / 2.0) / width
    v = y / height
    return prop, front, u, v, ok


def _object_window_planes(
    objects: ObjectSet,
    oi: int,
    model: EarthModel,
    lat0: float,
    lon0: float,
    step: float,
    ray_h: jnp.ndarray,  # [H, N]
    path_len: jnp.ndarray,  # [H, N]
    dlat: jnp.ndarray,  # [Wo, N] terrain-cache geodesic (column window)
    dlon: jnp.ndarray,  # [Wo, N]
    k_per_object: int,
) -> dict:
    """One object's hits over its column window (per-object-index form).

    Thin wrapper over :func:`_object_window_planes_core` — kept as the
    reference implementation for the unrolled merge path
    (``_apply_objects_planes_unrolled``) that the bucketed-scan production
    path is parity-tested against.
    """
    scal = _ObjScalars(
        dlat=objects.dlat[oi], dlon=objects.dlon[oi], elev=objects.elev[oi],
        r1=objects.r1[oi], r2=objects.r2[oi], height=objects.height[oi],
        width=objects.width[oi], rgba=objects.rgba[oi],
        basis=objects.basis[oi], tex_id=objects.tex_id[oi],
        cull_r2=objects.cull_r2[oi],
    )
    return _object_window_planes_core(
        scal, objects.kinds_static[oi], objects.textures, objects.tex_hw,
        model, lat0, lon0, step, ray_h, path_len, dlat, dlon,
        k_per_object, objects.seg_window,
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _ObjScalars:
    """One object's traced parameters (or a stacked [G, ...] batch of them:
    the bucketed ``lax.scan`` over a window-width bucket scans its leaves)."""

    dlat: jnp.ndarray
    dlon: jnp.ndarray
    elev: jnp.ndarray
    r1: jnp.ndarray
    r2: jnp.ndarray
    height: jnp.ndarray
    width: jnp.ndarray
    rgba: jnp.ndarray  # [4] (or [G, 4])
    basis: jnp.ndarray  # [3, 3] (or [G, 3, 3])
    tex_id: jnp.ndarray
    cull_r2: jnp.ndarray

    def tree_flatten(self):
        return (self.dlat, self.dlon, self.elev, self.r1, self.r2,
                self.height, self.width, self.rgba, self.basis, self.tex_id,
                self.cull_r2), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _object_window_planes_core(
    scal: _ObjScalars,
    kind_static: int,
    textures: jnp.ndarray,
    tex_hw: jnp.ndarray,
    model: EarthModel,
    lat0: float,
    lon0: float,
    step: float,
    ray_h: jnp.ndarray,  # [H, N]
    path_len: jnp.ndarray,  # [H, N]
    dlat: jnp.ndarray,  # [Wo, N] terrain-cache geodesic (column window)
    dlon: jnp.ndarray,  # [Wo, N]
    k_per_object: int,
    kw: int,  # seg_window
    death_idx: Optional[jnp.ndarray] = None,  # [H] precomputed (scan hoist)
) -> dict:
    """One object's hits over its column window of the separable grid.

    Finds per column the first march step inside the culling radius
    (utils.rs:74-80 semantics), tests a static window of ``kw`` segments
    from there for every row-ray, and keeps the ``k_per_object`` earliest
    hits per pixel. Returns a plane dict {channel: [Kp planes of [H, Wo]]}
    (see _PLANE_CHANNELS). All object parameters arrive as traced scalars
    (``scal``) so the bucketed scan can feed a different object each
    iteration through ONE compiled body.
    """
    h_n, n_path = ray_h.shape
    w_n, n_t = dlat.shape

    o_dlat = scal.dlat
    o_dlon = scal.dlon
    o_elev = scal.elev
    # culling: horizontal distance² at the object's altitude
    # (frustum.rs:103-114): enu of terrain points w/ elev = object elev
    rel = model.enu_rel(
        dlat, dlon, jnp.broadcast_to(o_elev, dlat.shape),
        o_dlat, o_dlon, o_elev, lat0,
    )  # [Wo, N, 3]
    d2 = (rel * rel).sum(-1)
    close = d2 < scal.cull_r2  # [Wo, N]
    any_close = close.any(axis=1)
    first_k = jnp.where(any_close, jnp.argmax(close, axis=1), n_t)
    # window starts one step early (segment (k-1, k) also sees the object
    # via its far end — utils.rs:241-250 checks old OR new point)
    k_lo = jnp.clip(first_k - 1, 0, max(n_t - kw - 1, 0))  # [Wo]

    # gather window geodesic points per column: [Wo, kw+1]
    offs = jnp.arange(kw + 1)
    k_idx = jnp.minimum(k_lo[:, None] + offs[None, :], n_t - 1)
    g_dlat = jnp.take_along_axis(dlat, k_idx, axis=1)
    g_dlon = jnp.take_along_axis(dlon, k_idx, axis=1)
    g_close = jnp.take_along_axis(close, k_idx, axis=1)
    # ray altitude at the window steps: ONE take of ray_h's columns at
    # the [Wo·(kw+1)] window indices — never broadcast the [H, W, N] cube
    # (a broadcast+take_along there cost ~10× the whole object pass)
    rh = jnp.take(
        ray_h, jnp.minimum(k_idx.reshape(-1), n_path - 1), axis=1
    ).reshape(h_n, w_n, kw + 1)
    p = model.enu_rel(
        jnp.broadcast_to(g_dlat[None], rh.shape),
        jnp.broadcast_to(g_dlon[None], rh.shape),
        rh,
        o_dlat, o_dlon, o_elev, lat0,
    )  # [H, Wo, kw+1, 3]
    # materialize: without the barrier XLA remats this trig-heavy chain
    # into every consumer of the intersection math (~8× recompute, was
    # 13.9 s of a 14.5 s objects frame in one fused loop)
    p = _materialize(p)
    p1 = p[..., :-1, :]
    p2 = p[..., 1:, :]
    # segment eligible if either end close (utils.rs:241-250)
    seg_close = g_close[..., :-1] | g_close[..., 1:]  # [Wo, kw]
    seg_k = (k_idx[:, :-1]).astype(jnp.float32)  # [Wo, kw] global seg idx
    # ray-death rule (utils.rs:159-171): the path cache ends one element
    # after the first sub--1000 m sample, so objects past that point are
    # never tested — segment k participates iff k <= first-death index
    # (exactly combine.ray_alive_mask's prefix semantics)
    if death_idx is None:
        death_idx = ray_death_index(ray_h)  # [H]
    seg_alive = seg_k[None, :, :] <= death_idx[:, None, None]  # [H, Wo, kw]

    is_frustum = kind_static == 0
    if is_frustum:
        props, normals_loc, valid = _frustum_hits(
            p1, p2, scal.r1, scal.r2, scal.height
        )  # [..., kw, 4], [..., kw, 4, 3]
        rgba = jnp.broadcast_to(scal.rgba, props.shape + (4,))
    else:
        prop, front, u, v, ok = _billboard_hit(
            p1, p2, scal.width, scal.height
        )
        texed = _sample_texture(textures, tex_hw, scal.tex_id, u, v)
        has_tex = scal.tex_id >= 0
        rgba1 = jnp.where(has_tex, texed, jnp.broadcast_to(scal.rgba, texed.shape))
        props = prop[..., None]
        normals_loc = front[..., None, :]
        valid = ok[..., None]
        rgba = rgba1[..., None, :]

    valid = valid & (seg_close[None, :, :] & seg_alive)[..., None]
    # skip fully transparent texels (utils.rs:258-259)
    valid = valid & (rgba[..., 3] > 0.0)
    keys = jnp.where(
        valid, seg_k[None, :, :, None] + jnp.clip(props, 0.0, 0.999999), NO_HIT
    )  # [H, Wo, kw, n_sub]
    keys_flat = keys.reshape(h_n, w_n, -1)
    normals_flat = normals_loc.reshape(h_n, w_n, -1, 3)
    rgba_flat = rgba.reshape(h_n, w_n, -1, 4)

    # Kp earliest hits as PLANES: successive masked mins + equality one-hot
    # payload extraction — no top_k (full sort), no take_along_axis
    # (per-lane gathers), no [H, Wo, Kp, D] tensors (layout poison; see
    # _PLANE_CHANNELS). Duplicate equal keys average, like merge_hits.
    from .combine import gather_column_field, gather_ray_field

    b = scal.basis  # rows = (east, north, up) global cartesian
    planes = {nm: [] for nm in ("key",) + _PLANE_CHANNELS}
    cur = keys_flat
    for k in range(k_per_object):
        m = jnp.min(cur, axis=-1)  # [H, Wo]
        if k + 1 < k_per_object:
            cur = jnp.where(cur <= m[..., None], NO_HIT, cur)
        vk = jnp.isfinite(m)
        z = lambda x: jnp.where(vk, x, 0.0)
        eqf = ((keys_flat == m[..., None]) & jnp.isfinite(keys_flat)).astype(
            jnp.float32
        )
        inv_cnt = 1.0 / jnp.maximum(eqf.sum(-1), 1.0)
        nloc = [
            jnp.sum(normals_flat[..., d] * eqf, -1) * inv_cnt for d in range(3)
        ]
        safe = jnp.where(vk, m, 0.0)
        planes["key"].append(jnp.where(vk, m, NO_HIT))
        planes["dlat"].append(z(gather_column_field(dlat, safe)))
        planes["dlon"].append(z(gather_column_field(dlon, safe)))
        planes["distance"].append(safe * jnp.float32(step))
        # TracePoint fields at the hit (utils.rs:261-273): lat/lon/dist/
        # path_length lerped along the march; elevation = RAY elevation.
        planes["elevation"].append(z(gather_ray_field(ray_h, safe)))
        planes["path_length"].append(z(gather_ray_field(path_len, safe)))
        for d, nm in enumerate(("nx", "ny", "nz")):
            planes[nm].append(
                z(nloc[0] * b[0, d] + nloc[1] * b[1, d] + nloc[2] * b[2, d])
            )
        planes["kind"].append(vk.astype(jnp.float32))
        for d, nm in enumerate(("cr", "cg", "cb", "ca")):
            planes[nm].append(z(jnp.sum(rgba_flat[..., d] * eqf, -1) * inv_cnt))
    return planes


# plane-list form of a hit buffer: every (field, slot) is its own 2-D
# [H, W] plane. Small trailing dims (K = 2-10, D = 3-4) under
# slice/concat/merge consumers push XLA into K-minor layouts; unrolling K
# and D into python lists of big 2-D planes keeps every op on [H, W]
# planes.
_PLANE_CHANNELS = (
    "dlat", "dlon", "distance", "elevation", "path_length", "kind",
    "nx", "ny", "nz", "cr", "cg", "cb", "ca",
)


def _planes_to_hb(planes: dict) -> HitBuffer:
    # NOTE (CPU): XLA CPU fuses the whole upstream merge arithmetic into the
    # per-slot output-stack kernels (~1450 HLO ops each) and LLVM -O3 then
    # needs tens of minutes per kernel; optimization_barrier does NOT help —
    # the CPU pipeline strips barriers. The fix is the backend flag
    # --xla_backend_optimization_level=1 (set by tests/conftest.py and the
    # CLI's CPU mode), which compiles the same kernels in seconds.
    key = jnp.stack(planes["key"], axis=-1)
    k = len(planes["key"])
    normal = jnp.stack(
        [jnp.stack([planes[nm][i] for nm in ("nx", "ny", "nz")], axis=-1)
         for i in range(k)],
        axis=-2,
    )
    rgba = jnp.stack(
        [jnp.stack([planes[nm][i] for nm in ("cr", "cg", "cb", "ca")], axis=-1)
         for i in range(k)],
        axis=-2,
    )
    stk = lambda nm: jnp.stack(planes[nm], axis=-1)
    return HitBuffer(
        valid=jnp.isfinite(key),
        key=key,
        dlat=stk("dlat"),
        dlon=stk("dlon"),
        distance=stk("distance"),
        elevation=stk("elevation"),
        path_length=stk("path_length"),
        normal=normal,
        kind=jnp.rint(stk("kind")).astype(jnp.int32),
        rgba=rgba,
    )


def _merge_planes(a: dict, b: dict, k_out: int) -> dict:
    """Keep the k_out earliest keys of two plane-sets (same merge semantics
    as ``merge_hits``: successive masked mins + equality-match payload
    extraction — pure elementwise [H, W] arithmetic, no gathers, no
    dot_generals, no small-minor-dim tensors)."""
    keys = a["key"] + b["key"]
    cur = list(keys)
    sel = []
    for s in range(k_out):
        m = cur[0]
        for c in cur[1:]:
            m = jnp.minimum(m, c)
        sel.append(m)
        if s + 1 < k_out:
            cur = [jnp.where(c <= m, NO_HIT, c) for c in cur]
    out = {"key": sel}
    eq = [[(keys[i] == sel[s]).astype(jnp.float32) for i in range(len(keys))]
          for s in range(k_out)]
    inv_match = [
        1.0 / jnp.maximum(sum(eq[s][1:], eq[s][0]), 1.0) for s in range(k_out)
    ]
    for nm in _PLANE_CHANNELS:
        vals = a[nm] + b[nm]
        out[nm] = [
            sum((vals[i] * eq[s][i] for i in range(1, len(vals))),
                vals[0] * eq[s][0]) * inv_match[s]
            for s in range(k_out)
        ]
    return out


def _pad_planes(planes: dict, k_out: int) -> dict:
    """Widen a plane dict to k_out slots (new slots invalid / zero)."""
    shape2 = planes["key"][0].shape
    n_pad = k_out - len(planes["key"])
    planes = dict(planes)
    planes["key"] = list(planes["key"]) + [jnp.full(shape2, NO_HIT)] * n_pad
    zero = jnp.zeros(shape2, jnp.float32)
    for nm in _PLANE_CHANNELS:
        planes[nm] = list(planes[nm]) + [zero] * n_pad
    return planes


def _obj_scalars_at(objects: ObjectSet, idx) -> _ObjScalars:
    """Slice/stack an ObjectSet's traced parameters at object index/indices."""
    return _ObjScalars(
        dlat=objects.dlat[idx], dlon=objects.dlon[idx], elev=objects.elev[idx],
        r1=objects.r1[idx], r2=objects.r2[idx], height=objects.height[idx],
        width=objects.width[idx], rgba=objects.rgba[idx],
        basis=objects.basis[idx], tex_id=objects.tex_id[idx],
        cull_r2=objects.cull_r2[idx],
    )


def apply_objects_planes(
    planes: dict,  # {channel: [K planes of [H, W]]} terrain hits
    objects: ObjectSet,
    model: EarthModel,
    lat0: float,
    lon0: float,
    step: float,
    ray_h: jnp.ndarray,  # [H, N]
    path_len: jnp.ndarray,  # [H, N]
    dlat: jnp.ndarray,  # [W, N]
    dlon: jnp.ndarray,  # [W, N]
    col_windows,  # static tuple of per-object (lo, n), or None = full width
    k_out: int,
    k_per_object: int = 2,
) -> dict:
    """Merge every object's hits into the frame's hit planes — bucketed scan.

    Semantics of :func:`_apply_objects_planes_unrolled` (the reference
    implementation it is parity-tested against), different compilation
    shape: objects are grouped into buckets of identical (kind,
    padded-window-width) and each bucket runs as ONE ``lax.scan`` whose
    body handles one object — per-object parameters and window starts are
    scan inputs, the full plane set is the carry, and the window write-back
    is a traced dynamic_update_slice. An 8-object scene that previously
    unrolled into 8 distinct intersection+merge programs (tens of
    thousands of HLO ops, >600 s to compile cold) now compiles 1-3 small
    scan bodies.

    Window padding is semantically free: culling (``close``) is computed
    from the geodesic inside the body, so padded columns contribute no
    hits, and merging a no-hit object window into the carry is bit-exact
    identity (invalid keys are +inf with zero payload). Window starts are
    clamped to ``W − padded_width`` so the padded window always covers the
    true one.
    """
    w_n = dlat.shape[0]
    if col_windows is None:
        col_windows = ((0, w_n),) * objects.n_objects
    planes = _pad_planes(planes, k_out)
    death_idx = ray_death_index(ray_h)  # object-independent: hoisted

    # bucket objects by (kind, padded window width): each bucket is one
    # compiled scan body. Widths round up to the next power of two (floor
    # 32) so nearby window sizes share a program.
    buckets: dict = {}
    for oi in range(objects.n_objects):
        lo, wn = col_windows[oi]
        if wn == 0:
            continue
        wp = max(32, 1 << (wn - 1).bit_length())
        wp = min(wp, w_n)
        key = (objects.kinds_static[oi], wp)
        buckets.setdefault(key, []).append((oi, min(lo, w_n - wp)))

    for (kind, wp), members in sorted(buckets.items()):
        order = [oi for oi, _ in members]
        lo_arr = jnp.asarray([lo for _, lo in members], jnp.int32)
        scal = _obj_scalars_at(objects, np.asarray(order))

        def body(carry, xs, _kind=kind, _wp=wp):
            sc, lo = xs
            dl = jax.lax.dynamic_slice_in_dim(dlat, lo, _wp, axis=0)
            dn = jax.lax.dynamic_slice_in_dim(dlon, lo, _wp, axis=0)
            obj_planes = _object_window_planes_core(
                sc, _kind, objects.textures, objects.tex_hw, model,
                lat0, lon0, step, ray_h, path_len, dl, dn,
                k_per_object, objects.seg_window, death_idx=death_idx,
            )
            win = {
                nm: [jax.lax.dynamic_slice_in_dim(p, lo, _wp, axis=1)
                     for p in ps]
                for nm, ps in carry.items()
            }
            merged = _merge_planes(win, obj_planes, k_out)
            out = {
                nm: [jax.lax.dynamic_update_slice_in_dim(p, m, lo, axis=1)
                     for p, m in zip(ps, merged[nm])]
                for nm, ps in carry.items()
            }
            return out, None

        if len(members) == 1:
            planes, _ = body(planes, (jax.tree.map(lambda x: x[0], scal),
                                      lo_arr[0]))
        else:
            planes, _ = jax.lax.scan(body, planes, (scal, lo_arr))
        # Buffer boundary between buckets — same role as _materialize in the
        # unrolled oracle: without it XLA CPU re-fuses each bucket's whole
        # intersection+merge chain into every later bucket's window slices
        # and the final per-slot output stacks, and both fusion-pass compile
        # time and runtime go exponential in bucket count (the mixed
        # billboard+frustum scene of tests/test_reference_config.py stalled
        # >50 min in compile; with boundaries it compiles in seconds). A
        # lax.scan materializes its carry, but single-member buckets call
        # the body directly, and even scan results re-fuse forward on CPU.
        planes = {nm: [_materialize(p) for p in ps]
                  for nm, ps in planes.items()}
    return planes


def _apply_objects_planes_unrolled(
    planes: dict,
    objects: ObjectSet,
    model: EarthModel,
    lat0: float,
    lon0: float,
    step: float,
    ray_h: jnp.ndarray,
    path_len: jnp.ndarray,
    dlat: jnp.ndarray,
    dlon: jnp.ndarray,
    col_windows,
    k_out: int,
    k_per_object: int = 2,
) -> dict:
    """Reference unrolled merge (one program per object) — parity oracle.

    The terrain planes widen to ``k_out`` slots; each object then computes
    its window-plane hits and merges into just its column window. The heavy
    candidate tensors never span the full frame width, and the merge is
    pure 2-D elementwise arithmetic (see _PLANE_CHANNELS note). Sequential
    merges keep the k_out earliest hits per pixel, so overlapping windows
    compose correctly.
    """
    w_n = dlat.shape[0]
    if col_windows is None:
        col_windows = ((0, w_n),) * objects.n_objects
    planes = _pad_planes(planes, k_out)

    for oi in range(objects.n_objects):
        lo, wn = col_windows[oi]
        if wn == 0:
            continue
        obj_planes = _object_window_planes(
            objects, oi, model, lat0, lon0, step, ray_h, path_len,
            jax.lax.slice_in_dim(dlat, lo, lo + wn, axis=0),
            jax.lax.slice_in_dim(dlon, lo, lo + wn, axis=0),
            k_per_object,
        )
        win = {
            nm: [jax.lax.slice_in_dim(p, lo, lo + wn, axis=1) for p in ps]
            for nm, ps in planes.items()
        }
        merged = _merge_planes(win, obj_planes, k_out)
        # write the merged window back with ONE dynamic_update_slice per
        # plane — the previous concat(slice, merged, slice) form nested one
        # level per object across ~k_out·14 planes, and XLA's CPU simplifier
        # goes superlinear on those chains (a 3-object 120×80 frame took
        # >25 min to COMPILE; DUS chains compile in seconds). The updated
        # planes then pass through _materialize: XLA CPU otherwise re-fuses
        # each object's merge into every later object's consumers, so both
        # runtime and compile go EXPONENTIAL in object count (measured on a
        # 120×80/3-object frame: >6× per added object, 88 s compile +
        # >270 s run; with the buffer boundary the whole frame is seconds).
        # On the GPU this is an optimization_barrier — the same boundary
        # that was already load-bearing for the window-point tensor above.
        planes = {
            nm: [
                _materialize(
                    jax.lax.dynamic_update_slice_in_dim(p, m, lo, axis=1)
                )
                for p, m in zip(ps, merged[nm])
            ]
            for nm, ps in planes.items()
        }
    return planes


def max_window_overlap(col_windows, n_objects: int) -> int:
    """Deepest static column-window overlap: the most objects any single
    azimuth column can see. A ray can only hit objects whose window
    contains its column, so this bounds per-pixel object-hit depth."""
    if col_windows is None:
        return n_objects
    events = []
    for lo, wn in col_windows:
        if wn:
            events.append((lo, 1))
            events.append((lo + wn, -1))
    deepest = cur = 0
    for _, delta in sorted(events):
        cur += delta
        deepest = max(deepest, cur)
    return deepest


def object_hits_pixelwise(
    objects: ObjectSet,
    model: EarthModel,
    lat0: float,
    lon0: float,
    step: float,
    n_terr: int,
    ray_h: jnp.ndarray,  # [P, n_terr] per-pixel ray altitudes
    path_len: jnp.ndarray,  # [P, n_terr]
    dir_deg: jnp.ndarray,  # [P] per-pixel azimuth (degrees)
    k_per_object: int = 2,
) -> HitBuffer:
    """Object hits for P independent rays (Rectilinear generator).

    Same semantics as object_hits_fast, but each pixel owns its geodesic:
    the culling window start is found by a coarse closed-form distance scan
    (the object's along-track window is tiny, so the scan runs at 4× the
    march step), then ``seg_window`` segments are tested exactly.
    """
    p_n, n_path = ray_h.shape
    stride = 4
    # the coarse scan (with its stride·step margin) can flag up to `margin`
    # before the true close region, so the exact window spans the margin on
    # both sides plus the close-region chord
    kw = objects.seg_window + 2 * stride + 2
    dir_col = dir_deg[:, None]
    # object-independent coarse-scan geodesic: one evaluation for the scene
    n_coarse = -(-n_terr // stride)
    dists_c = (jnp.arange(n_coarse, dtype=jnp.float32) * stride) * step
    dl_c, dn_c = model.geodesic_delta(lat0, lon0, dir_col, dists_c[None, :])
    # ray-death rule, as in _object_window_planes
    dead_r = ray_h < jnp.float32(DEATH_ALTITUDE)  # [P, n_terr]
    death_idx = jnp.where(
        dead_r.any(1), jnp.argmax(dead_r, 1), n_path
    ).astype(jnp.float32)  # [P]

    parts = []
    for oi in range(objects.n_objects):
        o_dlat = objects.dlat[oi]
        o_dlon = objects.dlon[oi]
        o_elev = objects.elev[oi]
        rel_c = model.enu_rel(
            dl_c, dn_c, jnp.broadcast_to(o_elev, dl_c.shape),
            o_dlat, o_dlon, o_elev, lat0,
        )
        # widen the coarse test so a stride can't step over the close region
        margin = jnp.float32(stride * step)
        d2_c = rel_c[..., 0] ** 2 + rel_c[..., 1] ** 2 + rel_c[..., 2] ** 2
        close_c = d2_c < (jnp.sqrt(objects.cull_r2[oi]) + margin) ** 2
        any_close = close_c.any(axis=1)
        first_c = jnp.where(any_close, jnp.argmax(close_c, axis=1), n_coarse)
        k_lo = jnp.clip(first_c * stride - stride - 1, 0, max(n_terr - kw - 1, 0))

        offs = jnp.arange(kw + 1)
        k_idx = jnp.minimum(k_lo[:, None] + offs[None, :], n_terr - 1)  # [P, kw+1]
        dists_w = k_idx.astype(jnp.float32) * step
        dl_w, dn_w = model.geodesic_delta(lat0, lon0, dir_col, dists_w)
        rh = jnp.take_along_axis(ray_h, k_idx, axis=1)  # [P, kw+1]
        p = model.enu_rel(dl_w, dn_w, rh, o_dlat, o_dlon, o_elev, lat0)
        p1, p2 = p[..., :-1, :], p[..., 1:, :]
        # exact culling at the window points (terrain-point test at obj elev)
        rel_w = model.enu_rel(
            dl_w, dn_w, jnp.broadcast_to(o_elev, dl_w.shape),
            o_dlat, o_dlon, o_elev, lat0,
        )
        d2_w = (rel_w * rel_w).sum(-1)
        g_close = d2_w < objects.cull_r2[oi]
        seg_close = g_close[..., :-1] | g_close[..., 1:]
        seg_k = k_idx[:, :-1].astype(jnp.float32)

        if objects.kinds_static[oi] == 0:
            props, normals_loc, valid = _frustum_hits(
                p1, p2, objects.r1[oi], objects.r2[oi], objects.height[oi]
            )  # [P, kw, 4]
            rgba = jnp.broadcast_to(objects.rgba[oi], props.shape + (4,))
        else:
            prop, front, u, v, ok = _billboard_hit(
                p1, p2, objects.width[oi], objects.height[oi]
            )
            texed = _sample_texture(
                objects.textures, objects.tex_hw, objects.tex_id[oi], u, v
            )
            has_tex = objects.tex_id[oi] >= 0
            rgba1 = jnp.where(
                has_tex, texed, jnp.broadcast_to(objects.rgba[oi], texed.shape)
            )
            props = prop[..., None]
            normals_loc = front[..., None, :]
            valid = ok[..., None]
            rgba = rgba1[..., None, :]

        seg_alive = seg_k <= death_idx[:, None]  # [P, kw]
        valid = valid & (seg_close & seg_alive)[..., None] & (rgba[..., 3] > 0.0)
        keys = jnp.where(
            valid, seg_k[..., None] + jnp.clip(props, 0.0, 0.999999), NO_HIT
        ).reshape(p_n, -1)
        neg_top, top_idx = jax.lax.top_k(-keys, k_per_object)
        sel_keys = -neg_top
        flat_n = keys.shape[-1]
        sel_norm_loc = jnp.take_along_axis(
            normals_loc.reshape(p_n, flat_n, 3), top_idx[..., None], axis=1
        )
        sel_rgba = jnp.take_along_axis(
            rgba.reshape(p_n, flat_n, 4), top_idx[..., None], axis=1
        )
        sel_valid = jnp.isfinite(sel_keys)
        sel_norm = local_normals_to_global(sel_norm_loc, objects.basis[oi])

        from .combine import gather_ray_field

        safe = jnp.where(sel_valid, sel_keys, 0.0)
        kk = jnp.floor(safe)
        pp = safe - kk
        dl1, dn1 = model.geodesic_delta(lat0, lon0, dir_col, kk * step)
        dl2, dn2 = model.geodesic_delta(lat0, lon0, dir_col, (kk + 1.0) * step)
        hb = HitBuffer(
            valid=sel_valid,
            key=sel_keys,
            dlat=dl1 * (1 - pp) + dl2 * pp,
            dlon=dn1 * (1 - pp) + dn2 * pp,
            distance=safe * jnp.float32(step),
            elevation=gather_ray_field(ray_h, safe),
            path_length=gather_ray_field(path_len, safe),
            normal=sel_norm,
            kind=jnp.ones(sel_keys.shape, jnp.int32),
            rgba=sel_rgba,
        )
        parts.append(hb)
    return concat_hits(parts)  # caller's merge_hits orders the union


def concat_hits(parts) -> HitBuffer:
    """Concatenate hit buffers along the slot axis (NO ordering)."""
    import jax

    return jax.tree.map(
        lambda *xs: jnp.concatenate(
            xs, axis=-2 if xs[0].ndim == parts[0].valid.ndim + 1 else -1
        ),
        *parts,
    )


def merge_hits(a: HitBuffer, b: HitBuffer, k_out: int) -> HitBuffer:
    """Merge two hit buffers (shape [..., K(,D)]), keep k_out earliest by key.

    Sort-free: instead of argsort + per-field take_along_axis gathers
    chained per scene object, the k_out keys come from successive masked
    mins (combine.k_smallest; inputs need NOT be pre-sorted) and every
    payload field re-pairs by equality one-hot multiply-sum — elementwise
    arithmetic.
    Duplicate +inf keys carry zero payload and are guarded by the match
    count; duplicate finite keys (two surfaces at the exact same float key)
    average, where the old argsort picked one arbitrarily.
    """
    from .combine import k_smallest

    def cat(x, y, vec=False):
        return jnp.concatenate([x, y], axis=-2 if vec else -1)

    keys_all = jnp.where(cat(a.valid, b.valid), cat(a.key, b.key), NO_HIT)
    skeys = k_smallest(keys_all, k_out)  # [..., k_out]
    oh = (keys_all[..., None, :] == skeys[..., :, None]).astype(jnp.float32)
    matches = jnp.maximum(oh.sum(-1), 1.0)  # [..., k_out]

    def pick(xa, xb):
        return jnp.sum(cat(xa, xb)[..., None, :] * oh, axis=-1) / matches

    def pick_vec(xa, xb):
        # per-channel multiply+sum — NEVER an einsum: a batched K_out×K_all
        # dot_general per pixel pads its tiny contraction onto the 128×128
        # MXU (~20× padded FLOPs, pathological compile times at 1080p)
        return jnp.stack(
            [pick(xa[..., d], xb[..., d]) for d in range(xa.shape[-1])],
            axis=-1,
        )

    return HitBuffer(
        valid=jnp.isfinite(skeys),
        key=skeys,
        dlat=pick(a.dlat, b.dlat),
        dlon=pick(a.dlon, b.dlon),
        distance=pick(a.distance, b.distance),
        elevation=pick(a.elevation, b.elevation),
        path_length=pick(a.path_length, b.path_length),
        normal=pick_vec(a.normal, b.normal),
        kind=jnp.rint(
            pick(a.kind.astype(jnp.float32), b.kind.astype(jnp.float32))
        ).astype(jnp.int32),
        rgba=pick_vec(a.rgba, b.rgba),
    )
