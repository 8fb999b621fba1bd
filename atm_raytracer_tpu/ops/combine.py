"""Crossing-detection combine: path tensor × terrain tensor → hit keys.

THE hot loop of the reference, re-shaped for the device. The reference
marches each pixel's ray through ``get_single_pixel`` with early exit
(src/generator/generators/utils.rs:201-289): per segment k, a terrain
crossing exists iff diff1·diff2 < 0 with diff = ray_elev − terrain_elev at
the segment ends, hit position lerped by prop = diff1/(diff1−diff2)
(utils.rs:220-240).

Here the Fast generator's separability (fast.rs:27-57) becomes a rank-1 dense
program: ray altitudes [H, N+1] (one row per elevation angle) and terrain
elevations [W, N] (one row per azimuth column) combine into per-pixel
crossing *keys*: key = k + prop ∈ [0, N), +inf where no crossing. Early exit
becomes a min-reduction (first crossing) or a running top-K merge
(translucent terrain, terrain_alpha < 1 — README.md:124-127).

Memory: the [H, W, C] diff cube is never materialized globally — segments are
processed in chunks of C inside a ``lax.scan`` so XLA fuses
broadcast−compare−reduce per chunk.

The reference's path-death rule (gen_path_cache stops one element after
h < −1000, utils.rs:159-171) is applied via a per-ray "dead" prefix mask:
segment k of ray h participates iff no j < k had ray_h[h, j] < −1000.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from ..physics.ray import DEATH_ALTITUDE  # utils.rs:167

NO_HIT = np.float32(np.inf)
NO_HIT_SEG = np.int32(2**30)  # integer sentinel (segment index form)


def ray_alive_mask(ray_h: jnp.ndarray) -> jnp.ndarray:
    """alive[h, k] = segment k of ray h is marched (no earlier death).

    ray_h: [H, N+1]; returns [H, N] bool for segments k = 0..N-1.
    """
    dead = ray_h < DEATH_ALTITUDE  # [H, N+1]
    # segment k participates iff no j < k is dead ⇒ prefix-or over j<k
    prefix = jnp.cumsum(dead[:, :-1].astype(jnp.int32), axis=1)
    no_prior = jnp.concatenate(
        [jnp.zeros((ray_h.shape[0], 1), jnp.int32), prefix[:, :-1]], axis=1
    )
    return no_prior == 0


def k_smallest(cand: jnp.ndarray, k: int) -> jnp.ndarray:
    """K smallest of cand[..., C], ascending, by K successive masked mins.

    ``lax.top_k`` is a per-row sort; inside the combine's segment-chunk
    scan K passes of min-reduce + mask are cheaper elementwise arithmetic
    (K is 2-4). Duplicate sentinel values collapse to the
    sentinel, which is exactly right for NO_HIT/NO_HIT_SEG.
    """
    outs = []
    cur = cand
    for i in range(k):
        m = jnp.min(cur, axis=-1)
        outs.append(m)
        if i + 1 < k:
            sentinel = jnp.asarray(NO_HIT if cand.dtype.kind == "f" else NO_HIT_SEG,
                                   cand.dtype)
            cur = jnp.where(cur <= m[..., None], sentinel, cur)
    return jnp.stack(outs, axis=-1)


def merge_sorted_k(a: jnp.ndarray, b: jnp.ndarray, k: int) -> jnp.ndarray:
    """K smallest of two ASCENDING [..., K] key lists via a bitonic merge.

    Concatenating an ascending list with a reversed ascending list gives a
    bitonic sequence; log2(2K) compare-exchange stages sort it — a few
    elementwise min/max ops instead of the full sort ``lax.top_k`` costs.
    """
    kp = 1 << (k - 1).bit_length()  # pad K to a power of two
    sentinel = jnp.asarray(NO_HIT if a.dtype.kind == "f" else NO_HIT_SEG, a.dtype)
    if kp != k:
        padding = [(0, 0)] * (a.ndim - 1) + [(0, kp - k)]
        a = jnp.pad(a, padding, constant_values=sentinel)
        b = jnp.pad(b, padding, constant_values=sentinel)
    seq = jnp.concatenate([a, jnp.flip(b, axis=-1)], axis=-1)  # bitonic
    n = 2 * kp
    span = kp
    lead = seq.shape[:-1]
    while span >= 1:
        x = seq.reshape(lead + (n // (2 * span), 2, span))
        lo = jnp.minimum(x[..., 0, :], x[..., 1, :])
        hi = jnp.maximum(x[..., 0, :], x[..., 1, :])
        seq = jnp.stack([lo, hi], axis=-2).reshape(lead + (n,))
        span //= 2
    return seq[..., :k]


@functools.partial(jax.jit, static_argnames=("n_seg", "max_hits", "chunk"))
def terrain_crossing_segments(
    ray_h: jnp.ndarray,
    terr_elev: jnp.ndarray,
    n_seg: int,
    max_hits: int = 1,
    chunk: int = 256,
) -> jnp.ndarray:
    """First ``max_hits`` terrain-crossing SEGMENT INDICES per pixel.

    Args:
      ray_h: [H, N+1] ray altitudes at x = k*step.
      terr_elev: [W, N_t] terrain elevations at the same x grid (N_t ≥ n_seg+1).
      n_seg: number of segments to test (reference: N_t − 1).
      max_hits: K slots (1 for opaque terrain — the common fast path).

    Returns int32 [H, W, max_hits] ascending; NO_HIT_SEG = no crossing.

    The hot cube only computes the sign test and an integer min — the
    fractional position ``prop = d1/(d1−d2)`` (utils.rs:232) is a per-PIXEL
    quantity, reconstructed by the caller from the two segment-end values it
    gathers anyway. That keeps the division and float-iota arithmetic out of
    the H·W·N loop (~8×10⁹ lanes at 1080p/200 km).
    """
    h_n = ray_h.shape[0]
    w_n = terr_elev.shape[0]
    alive = ray_alive_mask(ray_h)  # [H, N]

    n_chunks = -(-n_seg // chunk)
    pad = n_chunks * chunk + 1 - ray_h.shape[1]
    if pad > 0:
        ray_h = jnp.pad(ray_h, ((0, 0), (0, pad)), constant_values=-1e9)
        alive = jnp.pad(alive, ((0, 0), (0, pad)), constant_values=False)
    tpad = n_chunks * chunk + 1 - terr_elev.shape[1]
    if tpad > 0:
        terr_elev = jnp.pad(terr_elev, ((0, 0), (0, tpad)), constant_values=0.0)

    seg_valid_tail = (
        jax.lax.broadcasted_iota(jnp.int32, (n_chunks, chunk), 0) * chunk
        + jax.lax.broadcasted_iota(jnp.int32, (n_chunks, chunk), 1)
    ) < n_seg  # [n_chunks, chunk]

    def chunk_body(carry, c):
        keys = carry  # [H, W, K] int32
        k0 = c * chunk
        # segment ends: k0..k0+chunk and k0+1..k0+chunk+1
        r1 = jax.lax.dynamic_slice(ray_h, (0, k0), (h_n, chunk))  # [H, C]
        r2 = jax.lax.dynamic_slice(ray_h, (0, k0 + 1), (h_n, chunk))
        t1 = jax.lax.dynamic_slice(terr_elev, (0, k0), (w_n, chunk))  # [W, C]
        t2 = jax.lax.dynamic_slice(terr_elev, (0, k0 + 1), (w_n, chunk))
        al = jax.lax.dynamic_slice(alive, (0, k0), (h_n, chunk))  # [H, C]
        valid_tail = seg_valid_tail[c]  # [C]

        d1 = r1[:, None, :] - t1[None, :, :]  # [H, W, C]
        d2 = r2[:, None, :] - t2[None, :, :]
        crossing = (d1 * d2 < 0.0) & al[:, None, :] & valid_tail[None, None, :]
        seg_idx = (
            jax.lax.broadcasted_iota(jnp.int32, (1, 1, chunk), 2) + k0
        )
        cand = jnp.where(crossing, seg_idx, NO_HIT_SEG)  # [H, W, C] int32
        if max_hits == 1:
            new = jnp.minimum(keys[..., 0], jnp.min(cand, axis=-1))
            keys = new[..., None]
        else:
            keys = merge_sorted_k(keys, k_smallest(cand, max_hits), max_hits)
        return keys, None

    keys0 = jnp.full((h_n, w_n, max_hits), NO_HIT_SEG, jnp.int32)
    with jax.named_scope("combine"):
        keys, _ = jax.lax.scan(chunk_body, keys0, jnp.arange(n_chunks))
    return keys


@functools.partial(jax.jit, static_argnames=("n_seg", "max_hits", "chunk"))
def aligned_crossing_segments(
    ray_h: jnp.ndarray,
    terr_elev: jnp.ndarray,
    n_seg: int,
    max_hits: int = 1,
    chunk: int = 512,
) -> jnp.ndarray:
    """Crossing segments when ray rows are ALIGNED with terrain columns.

    The Rectilinear generator at tilt = 0 has a per-pixel ray but a
    per-COLUMN azimuth (rectilinear.rs:78-100 with pitch = 0 reduces the
    per-pixel direction to ``direction + atan2(x, z)``), so pixel (r, w)
    tests its own ray against column w's shared terrain scan — elementwise
    in w, not the [H, W] outer product of ``terrain_crossing_segments``.

    Args:
      ray_h: [R, W, N+1] ray altitudes (R rows of the current row-chunk).
      terr_elev: [W, N_t] terrain elevations on the same x grid.
      n_seg: segments to test.
      max_hits: K slots.

    Returns int32 [R, W, max_hits] ascending; NO_HIT_SEG = no crossing.
    """
    r_n, w_n, n_samp = ray_h.shape
    alive = ray_alive_mask(ray_h.reshape(r_n * w_n, n_samp)).reshape(
        r_n, w_n, n_samp - 1
    )

    n_chunks = -(-n_seg // chunk)
    pad = n_chunks * chunk + 1 - n_samp
    if pad > 0:
        ray_h = jnp.pad(ray_h, ((0, 0), (0, 0), (0, pad)), constant_values=-1e9)
        alive = jnp.pad(alive, ((0, 0), (0, 0), (0, pad)), constant_values=False)
    tpad = n_chunks * chunk + 1 - terr_elev.shape[1]
    if tpad > 0:
        terr_elev = jnp.pad(terr_elev, ((0, 0), (0, tpad)), constant_values=0.0)

    seg_valid_tail = (
        jax.lax.broadcasted_iota(jnp.int32, (n_chunks, chunk), 0) * chunk
        + jax.lax.broadcasted_iota(jnp.int32, (n_chunks, chunk), 1)
    ) < n_seg

    def chunk_body(keys, c):
        k0 = c * chunk
        r1 = jax.lax.dynamic_slice(ray_h, (0, 0, k0), (r_n, w_n, chunk))
        r2 = jax.lax.dynamic_slice(ray_h, (0, 0, k0 + 1), (r_n, w_n, chunk))
        t1 = jax.lax.dynamic_slice(terr_elev, (0, k0), (w_n, chunk))
        t2 = jax.lax.dynamic_slice(terr_elev, (0, k0 + 1), (w_n, chunk))
        al = jax.lax.dynamic_slice(alive, (0, 0, k0), (r_n, w_n, chunk))
        d1 = r1 - t1[None, :, :]
        d2 = r2 - t2[None, :, :]
        crossing = (d1 * d2 < 0.0) & al & seg_valid_tail[c][None, None, :]
        seg_idx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, chunk), 2) + k0
        cand = jnp.where(crossing, seg_idx, NO_HIT_SEG)
        if max_hits == 1:
            keys = jnp.minimum(keys[..., 0], jnp.min(cand, axis=-1))[..., None]
        else:
            keys = merge_sorted_k(keys, k_smallest(cand, max_hits), max_hits)
        return keys, None

    keys0 = jnp.full((r_n, w_n, max_hits), NO_HIT_SEG, jnp.int32)
    keys, _ = jax.lax.scan(chunk_body, keys0, jnp.arange(n_chunks))
    return keys


def terrain_crossing_keys(
    ray_h: jnp.ndarray,
    terr_elev: jnp.ndarray,
    n_seg: int,
    max_hits: int = 1,
    chunk: int = 256,
) -> jnp.ndarray:
    """Float crossing keys k + prop ([H, W, K], inf = no hit).

    Convenience wrapper over ``terrain_crossing_segments`` + per-pixel prop
    reconstruction (kept for tests and callers that want the key directly).
    """
    segs = terrain_crossing_segments(ray_h, terr_elev, n_seg, max_hits, chunk)
    valid = segs < n_seg
    ks = jnp.where(valid, segs, 0)
    prop = crossing_prop(ray_h, terr_elev, ks)
    return jnp.where(valid, ks.astype(jnp.float32) + prop, NO_HIT)


def crossing_prop(
    ray_h: jnp.ndarray,  # [H, N+1]
    terr_elev: jnp.ndarray,  # [W, N_t]
    ks: jnp.ndarray,  # [H, W, K] int32 segment indices (already masked safe)
) -> jnp.ndarray:
    """prop = d1/(d1−d2) at the given segments (utils.rs:232), per pixel."""
    r1, r2 = gather_ray_pairs(ray_h, ks)
    t1, t2 = gather_column_pairs(terr_elev[:, : ray_h.shape[1]], ks)
    d1 = r1 - t1
    d2 = r2 - t2
    denom = d1 - d2
    return d1 / jnp.where(denom == 0.0, 1.0, denom)


def _gather_pairs(field: jnp.ndarray, axis_iota: int, ki: jnp.ndarray):
    """Both segment-end values of ``field`` rows at integer segments ``ki``.

    field: [R, N(,D)] per-row sequences; ki: [...] int32 with the row index
    given by ``broadcasted_iota(axis_iota)`` over ki's shape. Adjacent-pair
    layout puts both endpoints in one contiguous-row gather. Returns
    (lo, hi) shaped ki(+D).
    """
    n = field.shape[1]
    r = jax.lax.broadcasted_iota(jnp.int32, ki.shape, axis_iota)
    base = r * (n - 1) + jnp.clip(ki, 0, n - 2)
    if field.ndim == 3:
        d = field.shape[2]
        pairs = jnp.concatenate(
            [field[:, :-1, :], field[:, 1:, :]], axis=-1
        ).reshape(-1, 2 * d)
        row = jnp.take(pairs, base, axis=0)  # [..., 2D]
        return row[..., :d], row[..., d:]
    pairs = jnp.stack([field[:, :-1], field[:, 1:]], axis=-1).reshape(-1, 2)
    row = jnp.take(pairs, base, axis=0)
    return row[..., 0], row[..., 1]


def gather_ray_pairs(field: jnp.ndarray, ki: jnp.ndarray):
    """(lo, hi) of a per-ray field [H, N+1(,D)] at segments ki [H, W, K]."""
    return _gather_pairs(field, 0, ki)


def gather_column_pairs(field: jnp.ndarray, ki: jnp.ndarray):
    """(lo, hi) of a per-column field [W, N_t(,D)] at segments ki [H, W, K]."""
    return _gather_pairs(field, 1, ki)


def gather_ray_field(field: jnp.ndarray, h_idx_keys: jnp.ndarray) -> jnp.ndarray:
    """Lerp a per-ray field [H, N+1] at float keys [H, W, K] (k + prop)."""
    k = jnp.floor(h_idx_keys)
    prop = h_idx_keys - k
    lo, hi = _gather_pairs(field, 0, k.astype(jnp.int32))
    return lo * (1.0 - prop) + hi * prop


def gather_column_field(field: jnp.ndarray, keys: jnp.ndarray) -> jnp.ndarray:
    """Lerp a per-column field [W, N_t(,D)] at float keys [H, W, K]."""
    k = jnp.floor(keys)
    prop = keys - k
    lo, hi = _gather_pairs(field, 1, k.astype(jnp.int32))
    if field.ndim == 3:
        prop = prop[..., None]
    return lo * (1.0 - prop) + hi * prop
