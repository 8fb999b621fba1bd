"""Device-side metadata packing: compact staged transfer for viewer fields.

The viewer-facing per-pixel metadata (distance, elevation, lat/lon — see
src/viewer/app.rs:112-176) is staged from device to host. Four separate f32
[H, W, K] fetches cost 16 B/pixel-slot through a bandwidth-limited link; this
pack cuts that to 14 B across four flat 1-D segments whose host decode is
zero-copy views + one fused multiply-add per field:

* ``key`` — f32, exact, fetched as-is. ``distance`` is derived on host as
  ``where(isfinite(key), key, 0) * step`` — the identical f32 expression the
  device hit path uses (generators/fast.py), so it round-trips bit-exactly;
  validity is ``isfinite(key)`` (invalid slots carry the +inf sentinel).
* ``dlat``/``dlon`` — range-coded to 2^24 levels (f32 compute bounds the
  usable level count) carried as u32: error ≤ range·2^-22 incl. f32
  round-off ≈ 6.4e-7° for a 2.7°-wide footprint ≈ 7 cm — below the
  viewer's 0.01″ (~0.3 m) DMS display step.
* ``elevation`` — u16 range-coded against the frame's device min/max:
  error ≤ range·2^-15 incl. f32 round-off (4.6 cm for 1.5 km of relief;
  27 cm for Everest-scale 9 km — at or below the viewer's 0.1 m display
  step for any frame under ~3 km of relief).

Each segment is a flat 1-D array of its natural dtype, fetched as is (no
u8 byte-plane relayouts or device-side bitcast/interleave programs).
Decoding is lazy (:class:`ViewerFields`): like the reference
viewer, which deserializes the artifact once and formats a trace point only
when a pixel is selected (viewer/app.rs:112-176), per-pixel queries decode
O(K) values and full-frame arrays materialize only on first use.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

if hasattr(np, "bitwise_count"):
    _popcount = np.bitwise_count
else:  # NumPy < 2.0 (pyproject declares no floor): unpackbits fallback
    def _popcount(a):
        arr = np.atleast_1d(np.ascontiguousarray(a, dtype=np.uint32))
        bits = np.unpackbits(arr.view(np.uint8)).reshape(arr.size, 32)
        return bits.sum(axis=-1, dtype=np.int64).reshape(np.shape(a))

_LEVELS = float(1 << 24)  # usable quantization levels (f32-round bounded)


def _range_code(v, lo, hi, levels):
    scale = (levels - 1.0) / jnp.maximum(hi - lo, 1e-30)
    return jnp.round((v - lo) * scale).astype(jnp.uint32)


@jax.jit
def pack_viewer_fields(key, dlat, dlon, elevation):
    """[H, W, K] fields → (key f32 [P], dlat u32 [P], dlon u32 [P],
    elevation u16 [P], ranges [6] f32), P = H·W·K — 14 B/pixel-slot total.
    """
    valid = jnp.isfinite(key)

    def rng(v):
        big = jnp.float32(3.4e38)
        lo = jnp.min(jnp.where(valid, v, big))
        hi = jnp.max(jnp.where(valid, v, -big))
        ok = jnp.any(valid)
        return jnp.where(ok, lo, 0.0), jnp.where(ok, hi, 0.0)

    la_lo, la_hi = rng(dlat)
    lo_lo, lo_hi = rng(dlon)
    el_lo, el_hi = rng(elevation)

    la = _range_code(jnp.where(valid, dlat, la_lo), la_lo, la_hi, _LEVELS)
    lo = _range_code(jnp.where(valid, dlon, lo_lo), lo_lo, lo_hi, _LEVELS)
    el = _range_code(
        jnp.where(valid, elevation, el_lo), el_lo, el_hi, 65536.0
    ).astype(jnp.uint16)

    ranges = jnp.stack([la_lo, la_hi, lo_lo, lo_hi, el_lo, el_hi])
    return (key.reshape(-1), la.reshape(-1), lo.reshape(-1),
            el.reshape(-1), ranges)


def _decode(q_f32, lo, hi, levels):
    """Fused single-pass f32 dequantization lo + q·(hi-lo)/(levels-1).

    The scale is computed in f64 then applied in one f32 multiply-add; for
    q ≤ 2^24 (exact in f32) the result error is ≤ 1 f32 ulp of the exact
    dequantized value — inside the documented range·2^-22 / range·2^-15
    bands, which already budget f32 round-off.
    """
    scale = np.float32(float(hi - lo) / (levels - 1.0))
    return q_f32 * scale + np.float32(lo)


class ViewerFields:
    """Host-side staged viewer metadata with lazy decoding.

    Mirrors the reference viewer's artifact lifecycle: the staged payload
    lands once (four compact segments), full-frame arrays are decoded on
    first access, and :meth:`pixel` decodes a single pixel's K slots in
    O(K) the way app.rs:112-176 formats only the selected pixel.

    Iterating/destructuring yields ``(valid, key, distance, dlat, dlon,
    elevation)`` as [H, W, K] arrays for compatibility with the eager API.
    """

    def __init__(self, key: np.ndarray, la: np.ndarray, lo: np.ndarray,
                 el: np.ndarray, ranges: np.ndarray,
                 shape: Tuple[int, ...], step: float):
        p = int(np.prod(shape))
        self._key_flat = np.asarray(key, np.float32).reshape(-1)
        self._la_flat = np.asarray(la, np.uint32).reshape(-1)
        self._lo_flat = np.asarray(lo, np.uint32).reshape(-1)
        self._el_flat = np.asarray(el, np.uint16).reshape(-1)
        for seg in (self._key_flat, self._la_flat, self._lo_flat,
                    self._el_flat):
            if seg.size != p:
                raise ValueError(f"segment size {seg.size} != P={p}")
        self.ranges = np.asarray(ranges, np.float64)
        self.shape = tuple(shape)
        self.step = float(step)
        self._p = p
        self._cache: dict = {}

    @property
    def nbytes(self) -> int:
        """Staged payload size (14 B per pixel-slot)."""
        return (self._key_flat.nbytes + self._la_flat.nbytes
                + self._lo_flat.nbytes + self._el_flat.nbytes)

    # -- full-frame lazy arrays -------------------------------------------
    def _get(self, name, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    @property
    def key(self):
        return self._get("key", lambda: self._key_flat.reshape(self.shape))

    @property
    def valid(self):
        return self._get("valid", lambda: np.isfinite(self.key))

    @property
    def distance(self):
        # identical f32 expression to the device hit path → bit-exact
        return self._get(
            "distance",
            lambda: (
                np.where(self.valid, self.key, np.float32(0.0))
                * np.float32(self.step)
            ).astype(np.float32),
        )

    @property
    def dlat(self):
        la_lo, la_hi = self.ranges[0], self.ranges[1]
        return self._get(
            "dlat",
            lambda: _decode(
                self._la_flat.astype(np.float32), la_lo, la_hi, _LEVELS
            ).reshape(self.shape),
        )

    @property
    def dlon(self):
        lo_lo, lo_hi = self.ranges[2], self.ranges[3]
        return self._get(
            "dlon",
            lambda: _decode(
                self._lo_flat.astype(np.float32), lo_lo, lo_hi, _LEVELS
            ).reshape(self.shape),
        )

    @property
    def elevation(self):
        el_lo, el_hi = self.ranges[4], self.ranges[5]
        return self._get(
            "elevation",
            lambda: _decode(
                self._el_flat.astype(np.float32), el_lo, el_hi, 65536.0
            ).reshape(self.shape),
        )

    # -- O(K) single-pixel decode (viewer click path) ---------------------
    def pixel(self, y: int, x: int):
        """Decode one pixel's slots → dict of [K] arrays."""
        h, w = self.shape[0], self.shape[1]
        k = self._p // (h * w)
        base = (y * w + x) * k
        sl = slice(base, base + k)
        key = self._key_flat[sl]
        valid = np.isfinite(key)
        la_lo, la_hi, lo_lo, lo_hi, el_lo, el_hi = self.ranges
        return {
            "valid": valid,
            "key": key,
            "distance": (
                np.where(valid, key, np.float32(0.0)) * np.float32(self.step)
            ).astype(np.float32),
            "dlat": _decode(
                self._la_flat[sl].astype(np.float32), la_lo, la_hi, _LEVELS
            ),
            "dlon": _decode(
                self._lo_flat[sl].astype(np.float32), lo_lo, lo_hi, _LEVELS
            ),
            "elevation": _decode(
                self._el_flat[sl].astype(np.float32), el_lo, el_hi, 65536.0
            ),
        }

    # -- eager-API compatibility ------------------------------------------
    def __iter__(self):
        return iter(
            (self.valid, self.key, self.distance, self.dlat, self.dlon,
             self.elevation)
        )


def unpack_viewer_fields(
    key, la, lo, el, ranges: np.ndarray, shape: Tuple[int, ...], step: float,
):
    """Host inverse of :func:`pack_viewer_fields` (eager).

    Returns (valid, key, distance, dlat, dlon, elevation) as [H, W, K]
    numpy arrays; ``distance`` reproduces the device expression bit-exactly.
    """
    return tuple(ViewerFields(key, la, lo, el, ranges, shape, step))


@jax.jit
def pack_viewer_fields_separable(key, elevation):
    """Separable pack for Fast-generator hits: ~6 B per VALID slot.

    The Fast generator is separable: a hit's (dlat, dlon) is the lerp of
    consecutive column-geodesic samples at ``prop = key - floor(key)``
    (generators/fast.py:219-221), fully determined by (column azimuth, key).
    Staging therefore carries only ``key`` (f32, exact — distance and
    validity derive from it) and range-coded elevation (u16), stream-
    compacted to valid slots behind a u32 validity bitmask; lat/lon deltas
    are re-derived host-side in f64 by :class:`ViewerFieldsSeparable` using
    the same endpoint-lerp the device applied, so their error vs the staged
    device values is the device f32 geodesic band (≤6 cm over 200 km,
    models/earth.py geodesic_delta) — tighter than the 2^24-level coding of
    :func:`pack_viewer_fields`.

    Returns (bits u32 [ceil(P/32)], key_c f32 [P], el_c u16 [P],
    el_ranges f32 [2], count i32) with valid entries compacted to the front
    of key_c/el_c in flat C order; the host fetches only the first
    ``count`` of each. Precondition: hits whose positions lie on the
    per-column geodesic (Fast terrain hits) — callers must not use it for
    object scenes or non-separable generators.
    """
    valid = jnp.isfinite(key)
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(valid, elevation, big))
    hi = jnp.max(jnp.where(valid, elevation, -big))
    ok = jnp.any(valid)
    el_lo = jnp.where(ok, lo, 0.0)
    el_hi = jnp.where(ok, hi, 0.0)
    el = _range_code(
        jnp.where(valid, elevation, el_lo), el_lo, el_hi, 65536.0
    ).astype(jnp.uint16)

    vflat = valid.reshape(-1)
    p = vflat.shape[0]
    pos = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    idx = jnp.where(vflat, pos, p)  # invalid slots dropped by mode="drop"
    key_c = jnp.zeros((p,), jnp.float32).at[idx].set(
        key.reshape(-1), mode="drop"
    )
    el_c = jnp.zeros((p,), jnp.uint16).at[idx].set(
        el.reshape(-1), mode="drop"
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
    return bits, key_c, el_c, jnp.stack([el_lo, el_hi]), count


class ViewerFieldsSeparable:
    """Host container for the separable pack: lat/lon derived, not staged.

    Same lazy surface as :class:`ViewerFields` (full-frame properties,
    O(K)+O(1) ``pixel`` decode after a one-time index build, destructuring
    iterator), but ``dlat``/``dlon`` are recomputed in f64 from
    (column azimuth, key) with the device's endpoint-lerp semantics:
    ``lerp(geodesic(az, floor(k)·step), geodesic(az, ceil(k)·step), frac)``
    via ``model.coords_at_dist_host`` — see pack_viewer_fields_separable.
    """

    def __init__(self, bits: np.ndarray, key_c: np.ndarray,
                 el_c: np.ndarray, el_ranges: np.ndarray,
                 shape: Tuple[int, ...], step: float,
                 model, lat0: float, lon0: float, az_deg: np.ndarray):
        p = int(np.prod(shape))
        self._bits = np.asarray(bits, np.uint32).reshape(-1)
        if self._bits.size != (p + 31) // 32:
            raise ValueError(
                f"bitmask words {self._bits.size} != ceil(P/32) for P={p}"
            )
        self._key_c = np.asarray(key_c, np.float32).reshape(-1)
        self._el_c = np.asarray(el_c, np.uint16).reshape(-1)
        self.el_ranges = np.asarray(el_ranges, np.float64)
        self.shape = tuple(shape)
        self.step = float(step)
        self.model = model
        self.lat0 = float(lat0)
        self.lon0 = float(lon0)
        self.az_deg = np.asarray(az_deg, np.float64).reshape(-1)
        if self.az_deg.size != self.shape[1]:
            raise ValueError("az_deg must have one entry per column")
        self._p = p
        self._cache: dict = {}

    @property
    def nbytes(self) -> int:
        """Staged payload (bitmask + compacted key/elevation segments)."""
        return self._bits.nbytes + self._key_c.nbytes + self._el_c.nbytes

    def _get(self, name, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    # -- index machinery ----------------------------------------------------
    @property
    def valid(self):
        def make():
            w = self._bits.shape[0]
            v = (
                (self._bits[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).reshape(w * 32)[: self._p]
            return v.reshape(self.shape)

        return self._get("valid", make)

    @property
    def _positions(self):
        # flat slot -> compact index (valid slots only); int32 cumsum keeps
        # the index table at 4 B/slot
        return self._get(
            "_positions",
            lambda: np.cumsum(
                self.valid.reshape(-1), dtype=np.int32
            ) - 1,
        )

    @property
    def _count(self) -> int:
        return self._get(
            "_count", lambda: int(self.valid.reshape(-1).sum())
        )

    # -- full-frame lazy arrays ----------------------------------------------
    @property
    def key(self):
        def make():
            out = np.full(self._p, np.inf, np.float32)
            out[self.valid.reshape(-1)] = self._key_c[: self._count]
            return out.reshape(self.shape)

        return self._get("key", make)

    @property
    def distance(self):
        # identical f32 expression to the device hit path → bit-exact
        return self._get(
            "distance",
            lambda: (
                np.where(self.valid, self.key, np.float32(0.0))
                * np.float32(self.step)
            ).astype(np.float32),
        )

    @property
    def elevation(self):
        el_lo, el_hi = self.el_ranges[0], self.el_ranges[1]

        def make():
            out = np.full(self._p, np.float32(el_lo), np.float32)
            out[self.valid.reshape(-1)] = _decode(
                self._el_c[: self._count].astype(np.float32),
                el_lo, el_hi, 65536.0,
            )
            return out.reshape(self.shape)

        return self._get("elevation", make)

    def _derive_latlon(self, keys: np.ndarray, cols: np.ndarray):
        """f64 (dlat, dlon) for valid keys in columns ``cols`` (flat arrays).

        Replicates the device lerp between consecutive geodesic samples
        (generators/fast.py:219-221): endpoints at floor/ceil of the key,
        weights = fractional part. dlon wraps into (-180, 180] so frames
        straddling the antimeridian stay observer-relative.
        """
        k = np.floor(keys.astype(np.float64))
        frac = keys.astype(np.float64) - k
        az = self.az_deg[cols]
        la1, lo1 = self.model.coords_at_dist_host(
            self.lat0, self.lon0, az, k * self.step
        )
        la2, lo2 = self.model.coords_at_dist_host(
            self.lat0, self.lon0, az, (k + 1.0) * self.step
        )
        dlat = (la1 - self.lat0) * (1.0 - frac) + (la2 - self.lat0) * frac

        def wrap(x):
            return (x + 180.0) % 360.0 - 180.0

        dlon = wrap(lo1 - self.lon0) * (1.0 - frac) + wrap(
            lo2 - self.lon0
        ) * frac
        return dlat, dlon

    def _latlon_full(self):
        def make():
            vflat = self.valid.reshape(-1)
            idx = np.nonzero(vflat)[0]
            k = self.shape[2] if len(self.shape) > 2 else 1
            cols = (idx // k) % self.shape[1]
            dlat = np.zeros(self._p, np.float64)
            dlon = np.zeros(self._p, np.float64)
            if idx.size:
                dla, dlo = self._derive_latlon(self._key_c[: idx.size], cols)
                dlat[idx] = dla
                dlon[idx] = dlo
            return dlat.reshape(self.shape), dlon.reshape(self.shape)

        return self._get("_latlon", make)

    @property
    def dlat(self):
        return self._latlon_full()[0]

    @property
    def dlon(self):
        return self._latlon_full()[1]

    # -- O(K) single-pixel decode (viewer click path) ------------------------
    def _rank(self, base: int) -> int:
        """Valid slots strictly before flat slot ``base`` (bitmask popcount).

        O(base/32) word popcount — the viewer's click path must not pay the
        full-frame cumsum index (~1 s at 8K×2 K) for one pixel.
        """
        wq, r = divmod(base, 32)
        c = int(_popcount(self._bits[:wq]).sum(dtype=np.int64))
        if r:
            tail = self._bits[wq] & np.uint32((1 << r) - 1)
            c += int(_popcount(tail))
        return c

    def pixel(self, y: int, x: int):
        """Decode one pixel's slots → dict of [K] arrays."""
        h, w = self.shape[0], self.shape[1]
        k = self._p // (h * w)
        base = (y * w + x) * k
        if "_positions" in self._cache:
            vflat = self.valid.reshape(-1)[base: base + k]
            pos = self._positions[base: base + k]
        else:
            sl = np.arange(base, base + k)
            vflat = (
                (self._bits[sl >> 5] >> (sl & 31).astype(np.uint32)) & 1
            ).astype(bool)
            # exclusive running rank within the pixel window, offset by the
            # rank of everything before it
            pos = self._rank(base) + np.cumsum(vflat, dtype=np.int32) - 1
        key = np.full(k, np.inf, np.float32)
        el = np.zeros(k, np.float32)
        el_lo, el_hi = self.el_ranges[0], self.el_ranges[1]
        if vflat.any():
            key[vflat] = self._key_c[pos[vflat]]
            el[vflat] = _decode(
                self._el_c[pos[vflat]].astype(np.float32),
                el_lo, el_hi, 65536.0,
            )
        el[~vflat] = np.float32(el_lo)
        dlat = np.zeros(k, np.float64)
        dlon = np.zeros(k, np.float64)
        if vflat.any():
            dla, dlo = self._derive_latlon(
                key[vflat], np.full(int(vflat.sum()), x, np.int64)
            )
            dlat[vflat] = dla
            dlon[vflat] = dlo
        return {
            "valid": vflat,
            "key": key,
            "distance": (
                np.where(vflat, key, np.float32(0.0)) * np.float32(self.step)
            ).astype(np.float32),
            "dlat": dlat,
            "dlon": dlon,
            "elevation": el,
        }

    def __iter__(self):
        return iter(
            (self.valid, self.key, self.distance, self.dlat, self.dlon,
             self.elevation)
        )


def fetch_viewer_fields_separable(result, model, step: float, co_fetch=()):
    """Device→host staging of Fast-generator viewer metadata, compacted.

    ``result``: a RenderResult from render_fast (separable [W] azimuth
    grid, device-resident hits, NO scene objects — object hit positions
    are not on the column geodesic). Transfers the u32 validity bitmask
    plus only the VALID slots' key (f32) + elevation (u16): ~6 B per valid
    slot + P/8 bitmask bytes, vs 14 B per slot (valid or not) for
    :func:`fetch_viewer_fields`. Sky-dominated frames cut the payload
    2-4x on top of the dropped lat/lon segments.

    ``co_fetch``: extra device arrays (e.g. the rendered image) staged
    through the SAME overlap pool as the metadata segments — and
    SUBMITTED FIRST, before the pack is even dispatched, so the co-fetch
    bytes move while the device runs the compaction and the host waits on
    the count sync, instead of the two paying back to back.
    Returns the ViewerFieldsSeparable alone when ``co_fetch`` is empty,
    else ``(vf, [flat extras...])``.
    """
    import jax as _jax

    from ..generators.base import fetch_pool, submit_fetch

    hits = result.hits
    az = np.asarray(result.azimuth_deg)
    if az.ndim != 1 or az.size != hits.key.shape[1]:
        raise ValueError(
            "fetch_viewer_fields_separable needs a separable [W] azimuth "
            "grid (Fast generator)"
        )
    co_fetch = tuple(co_fetch)
    ex = fetch_pool()
    try:
        co_outs, co_futs = submit_fetch(ex, co_fetch)
        bits, key_c, el_c, ranges, count = pack_viewer_fields_separable(
            jnp.asarray(hits.key), jnp.asarray(hits.elevation)
        )
        n = int(_jax.device_get(count))
        meta_outs, meta_futs = submit_fetch(ex, (bits, key_c[:n], el_c[:n]))
        for f in meta_futs + co_futs:
            f.result()
    finally:
        ex.shutdown(wait=True)
    fetched = list(meta_outs) + list(co_outs)
    bits_h, key_h, el_h = fetched[:3]
    lat0, lon0 = float(result.observer[0]), float(result.observer[1])
    vf = ViewerFieldsSeparable(
        bits_h, key_h, el_h, np.asarray(ranges),
        tuple(hits.key.shape), step, model, lat0, lon0, az,
    )
    return (vf, fetched[3:]) if co_fetch else vf


_KEY_QUANT = 256.0  # 1/256 march-step key fixed point (delta pack):
# distance quantum = step/256 (0.195 m at 50 m steps) and derived lat/lon
# error ≤ ~0.2 m — both under the viewer's display steps (0.001 km
# distance, 0.01" ≈ 0.31 m DMS). The delta pack trades the separable
# pack's bit-exact f32 keys for ~2x fewer key bytes inside those bands.


def _delta_encode(x_i32, count, limit: int, clip_dtype):
    """Compact-stream delta coding with an exception side-channel.

    ``x_i32`` [P] i32: compacted values (garbage past ``count``).
    Returns (d_small clip_dtype [P], exc_idx u32 [P], exc_val i32 [P],
    n_exc i32): d[i] = x[i] - x[i-1] (d[0] = x[0]); entries with
    |d| > limit are zeroed in d_small and appended (stream index, true
    delta) to the exception arrays, compacted to the front. Host decode is
    one fused pass: d = d_small.astype(i64); d[exc_idx] = exc_val;
    x = cumsum(d) — exact for any input, with the byte cost of the narrow
    dtype plus 8 B per exception.
    """
    p = x_i32.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), x_i32[:-1]])
    d = x_i32 - prev
    inside = jax.lax.broadcasted_iota(jnp.int32, (p,), 0) < count
    big = (jnp.abs(d) > limit) & inside
    d_small = jnp.where(big, 0, jnp.where(inside, d, 0)).astype(clip_dtype)
    epos = jnp.cumsum(big.astype(jnp.int32)) - 1
    eidx = jnp.where(big, epos, p)
    iota = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    exc_idx = jnp.zeros((p,), jnp.uint32).at[eidx].set(
        iota.astype(jnp.uint32), mode="drop"
    )
    exc_val = jnp.zeros((p,), jnp.int32).at[eidx].set(d, mode="drop")
    return d_small, exc_idx, exc_val, jnp.sum(big.astype(jnp.int32))


def _delta_encode4(x_i32, count):
    """Nibble (4-bit) variant of :func:`_delta_encode`: deltas clip to
    [-8, 7] with |d| > 7 riding the exception channel, and two deltas pack
    per byte (biased by +8). Measured overflow rates on the 8K scene:
    image channels 0.00 %, elevation 0.24 % — the byte halving is nearly
    free there. Returns (nibbles u8 [ceil(P/2)], exc_idx, exc_val,
    n_exc); fetch ``nibbles[:(n + 1) // 2]``.
    """
    p = x_i32.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), x_i32[:-1]])
    d = x_i32 - prev
    inside = jax.lax.broadcasted_iota(jnp.int32, (p,), 0) < count
    big = ((d > 7) | (d < -8)) & inside
    d_small = jnp.where(big | ~inside, 0, d)
    enc = d_small + 8  # [0, 15]
    if p % 2:
        enc = jnp.concatenate([enc, jnp.zeros((1,), jnp.int32)])
    pairs = enc.reshape(-1, 2)
    nibbles = (pairs[:, 0] | (pairs[:, 1] << 4)).astype(jnp.uint8)
    epos = jnp.cumsum(big.astype(jnp.int32)) - 1
    eidx = jnp.where(big, epos, p)
    iota = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    exc_idx = jnp.zeros((p,), jnp.uint32).at[eidx].set(
        iota.astype(jnp.uint32), mode="drop"
    )
    exc_val = jnp.zeros((p,), jnp.int32).at[eidx].set(d, mode="drop")
    return nibbles, exc_idx, exc_val, jnp.sum(big.astype(jnp.int32))


def _delta_decode4(nibbles, n, exc_idx, exc_val):
    """Host inverse of :func:`_delta_encode4` for a stream of ``n``."""
    b = np.asarray(nibbles, np.uint8)
    d = np.empty(b.size * 2, np.int64)
    d[0::2] = (b & 15).astype(np.int64) - 8
    d[1::2] = (b >> 4).astype(np.int64) - 8
    d = d[:n]
    if exc_idx.size:
        d[np.asarray(exc_idx, np.int64)] = exc_val
    return np.cumsum(d)


def _compact_scatter(vflat, values, dtype):
    """Scatter-compact ``values`` (flat [P]) to the front where vflat."""
    p = vflat.shape[0]
    pos = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    idx = jnp.where(vflat, pos, p)
    return jnp.zeros((p,), dtype).at[idx].set(
        values.astype(dtype), mode="drop"
    )


@jax.jit
def pack_viewer_fields_delta(key, elevation, image):
    """Delta pack v3: the separable pack's payload, delta-coded, plus the
    frame itself compacted to hit pixels.

    Per valid slot: key as i8 stream-delta of the 1/256 fixed point
    (``_KEY_QUANT``; 1 B vs 4 B f32) and elevation as a 4-bit
    stream-delta of the same u16 range code
    :func:`pack_viewer_fields_separable` uses (0.5 B vs 2 B; the cumsum
    decode reconstructs the identical u16s, so it still decodes
    bit-equal). Per HIT pixel: the u8 RGB frame compacted to hit pixels
    and 4-bit delta coded per channel (1.5 B/px vs 3 B) — valid-free
    pixels are the frame's constant sky/fog base color
    (renderer/mod.rs:395-411), so the reconstruction is bit-exact from
    the validity bitmask + one host-supplied RGB constant. Stream-
    adjacent entries are row-major neighbors whose values move slowly —
    measured on the 8K bench scene: key deltas overflow i8 0.04 % of the
    time, elevation deltas overflow 4 bits 0.24 %, image channel deltas
    0.00 % — and every overflow rides the exception side-channel exactly,
    so the coding is lossless for ANY input at a bounded byte cost
    (8 B/overflow). Callers must pass Fast-generator frames without
    scene objects (object hit positions are off the column geodesic);
    K-slot pixels reconstruct as hit iff ANY slot is valid.

    Returns (bits, key_d i8, key_exc_idx u32, key_exc_val i32,
    el_n u8 nibbles, el_exc_idx u32, el_exc_val i32, el_ranges f32 [2],
    img_n u8 [3, ceil(Ppx/2)] nibbles, img_exc_idx u32 [3, Ppx],
    img_exc_val i32 [3, Ppx], counts i32 [7] = (n_valid, n_px, n_key_exc,
    n_el_exc, n_r_exc, n_g_exc, n_b_exc)).
    """
    valid = jnp.isfinite(key)
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(valid, elevation, big))
    hi = jnp.max(jnp.where(valid, elevation, -big))
    ok = jnp.any(valid)
    el_lo = jnp.where(ok, lo, 0.0)
    el_hi = jnp.where(ok, hi, 0.0)
    el = _range_code(
        jnp.where(valid, elevation, el_lo), el_lo, el_hi, 65536.0
    ).astype(jnp.uint16)

    vflat = valid.reshape(-1)
    p = vflat.shape[0]
    count = jnp.sum(vflat.astype(jnp.int32))
    q = jnp.where(
        valid, jnp.round(key * jnp.float32(_KEY_QUANT)), 0.0
    ).astype(jnp.int32)
    q_c = _compact_scatter(vflat, q.reshape(-1), jnp.int32)
    el_c = _compact_scatter(
        vflat, el.reshape(-1).astype(jnp.int32), jnp.int32
    )
    key_d, kexc_i, kexc_v, n_kexc = _delta_encode(
        q_c, count, 127, jnp.int8
    )
    el_n, eexc_i, eexc_v, n_eexc = _delta_encode4(el_c, count)

    pad = (-p) % 32
    vpad = jnp.concatenate(
        [vflat, jnp.zeros((pad,), bool)]
    ).reshape(-1, 32).astype(jnp.uint32)
    bits = jnp.sum(
        vpad << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1,
        dtype=jnp.uint32,
    )

    pv = valid.reshape(valid.shape[0] * valid.shape[1], -1).any(-1)
    n_px = jnp.sum(pv.astype(jnp.int32))
    img_flat = image.reshape(-1, 3).astype(jnp.int32)
    img_ns, img_eis, img_evs, img_counts = [], [], [], []
    for c in range(3):
        x_c = _compact_scatter(pv, img_flat[:, c], jnp.int32)
        nb, ei, ev, ne = _delta_encode4(x_c, n_px)
        img_ns.append(nb)
        img_eis.append(ei)
        img_evs.append(ev)
        img_counts.append(ne)
    counts = jnp.stack(
        [count, n_px, n_kexc, n_eexc] + img_counts
    ).astype(jnp.int32)
    return (bits, key_d, kexc_i, kexc_v, el_n, eexc_i, eexc_v,
            jnp.stack([el_lo, el_hi]), jnp.stack(img_ns),
            jnp.stack(img_eis), jnp.stack(img_evs), counts)


def _delta_decode(d_small, exc_idx, exc_val):
    d = d_small.astype(np.int64)
    if exc_idx.size:
        d[exc_idx.astype(np.int64)] = exc_val
    return np.cumsum(d)


def pack_frame_compact(valid, image):
    """Lossless device-side frame compaction for link-limited fetches.

    ``valid`` [H, W, K] hit mask, ``image`` [H, W, 3] u8. Pixels with no
    valid slot are the frame's constant no-hit color
    (:func:`frame_base_rgb`; renderer/mod.rs:395-411), so only hit pixels
    need to cross the link, and those ship as per-channel 4-bit
    stream-deltas (shading moves slowly pixel-to-pixel; overflows ride an
    exact exception side-channel, :func:`_delta_encode4`):
    bits u32 [ceil(HW/32)] + ~1.5 B per hit pixel, vs 3 B for every
    pixel — ~4× fewer bytes on a half-sky frame, reconstructed
    bit-exactly by :func:`unpack_frame_compact`. Lossless for ANY
    composited frame: no-hit pixels are exactly ``trunc(def255)`` — the
    constant sky/fog base — regardless of translucency (partial-alpha
    remainders only occur on hit pixels, ops/composite.py:64-71).

    This is :func:`pack_frame_stream` with an UNCAPPED exception channel
    (callers slice the exceptions to the fetched counts, so the decode
    never overflows). Returns (bits u32, img_n u8 [3, ceil(HW/2)]
    nibbles, img_ei u32 [3, HW], img_ev i32 [3, HW], counts i32 [4] =
    (n_px, ne_r, ne_g, ne_b)); fetch ``img_n[c, :(n_px+1)//2]`` plus the
    per-channel exception slices.
    """
    return pack_frame_stream(
        valid, image, valid.shape[0] * valid.shape[1]
    )


def unpack_frame_compact(bits, channels, sky_rgb, h: int, w: int,
                         n_px: int):
    """Host inverse of :func:`pack_frame_compact` → [H, W, 3] u8.

    ``channels``: three (nibbles, exc_idx, exc_val) triples. unpackbits
    over the LE u32 words + ONE stacked scatter (~2× faster than
    per-channel boolean indexing; this runs inside the headline bench
    wall)."""
    hw = h * w
    bits = np.ascontiguousarray(np.asarray(bits, np.uint32).reshape(-1))
    pv = np.unpackbits(
        bits.view(np.uint8), bitorder="little"
    )[:hw].astype(bool)
    image = np.empty((hw, 3), np.uint8)
    image[:] = np.asarray(sky_rgb, np.uint8)
    image[pv] = np.stack(
        [_delta_decode4(nb, n_px, ei, ev).astype(np.uint8)
         for nb, ei, ev in channels],
        axis=-1,
    )
    return image.reshape(h, w, 3)


@functools.partial(jax.jit, static_argnames=("exc_cap",))
def pack_frame_stream(valid, image, exc_cap: int):
    """No-sync variant of :func:`pack_frame_compact` for PIPELINED fetches.

    Every output has a STATIC shape, so a caller dispatching many bands
    (generators/fast.py::render_fast_streamed) can submit the fetch
    immediately without a count round-trip between dispatch and transfer:
    nibble streams cover ALL pixel slots (entries beyond the compact count
    encode zero deltas and are sliced off at decode), and the exception
    arrays are capped at ``exc_cap`` — ``counts`` reports the TRUE
    exception numbers, so a decoder seeing ``ne > exc_cap`` knows the
    band is unreconstructable and re-fetches raw (measured rates are
    ~0.00 % of pixels on rendered frames; the cap exists for adversarial
    inputs, not expected ones). Byte cost ~1.6 B/pixel flat vs 3 B raw —
    less than :func:`pack_frame_compact`'s ~1.5 B/HIT pixel only when
    frames are hit-dominated, but with zero sync.

    Returns (bits u32, img_n u8 [3, ceil(HW/2)], img_ei u32 [3, exc_cap],
    img_ev i32 [3, exc_cap], counts i32 [4] = (n_px, ne_r, ne_g, ne_b)).
    """
    hw = valid.shape[0] * valid.shape[1]
    pv = valid.reshape(hw, -1).any(-1)
    n_px = jnp.sum(pv.astype(jnp.int32))
    img_flat = image.reshape(-1, 3).astype(jnp.int32)
    # ONE scatter compacts all three channels (packed 8-bit fields in an
    # i32 lane) — scatters dominate the pack's device time, and the
    # per-channel compact arrays then peel off elementwise
    packed_rgb = (img_flat[:, 0] | (img_flat[:, 1] << 8)
                  | (img_flat[:, 2] << 16))
    x_rgb = _compact_scatter(pv, packed_rgb, jnp.int32)
    nibbles, eis, evs, nes = [], [], [], []
    for c in range(3):
        x_c = (x_rgb >> (8 * c)) & 255
        nb, ei, ev, ne = _delta_encode4(x_c, n_px)
        nibbles.append(nb)
        eis.append(ei[:exc_cap])
        evs.append(ev[:exc_cap])
        nes.append(ne)
    pad = (-hw) % 32
    vpad = jnp.concatenate(
        [pv, jnp.zeros((pad,), bool)]
    ).reshape(-1, 32).astype(jnp.uint32)
    bits = jnp.sum(
        vpad << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1,
        dtype=jnp.uint32,
    )
    return (bits, jnp.stack(nibbles), jnp.stack(eis), jnp.stack(evs),
            jnp.stack([n_px] + nes).astype(jnp.int32))


def unpack_frame_stream(bits, img_n, img_ei, img_ev, counts, sky_rgb,
                        h: int, w: int, exc_cap: int):
    """Host inverse of :func:`pack_frame_stream` → [H, W, 3] u8, or
    ``None`` when any channel overflowed ``exc_cap`` (caller re-fetches
    the raw frame)."""
    counts = np.asarray(counts)
    n_px = int(counts[0])
    if int(counts[1:].max(initial=0)) > exc_cap:
        return None
    img_n = np.asarray(img_n)
    img_ei = np.asarray(img_ei).reshape(3, -1)
    img_ev = np.asarray(img_ev).reshape(3, -1)
    return unpack_frame_compact(
        bits,
        [(img_n.reshape(3, -1)[c], img_ei[c, : int(counts[1 + c])],
          img_ev[c, : int(counts[1 + c])]) for c in range(3)],
        sky_rgb, h, w, n_px,
    )


def frame_base_rgb(coloring, fog_distance) -> np.ndarray:
    """The composited frame's constant no-hit color as u8 (the value
    ``ops.composite.composite`` writes where no slot is valid): the
    coloring's sky, or the fog base when fog is configured
    (renderer/mod.rs:395-411). This is the ``sky_rgb`` argument of
    :func:`fetch_viewer_fields_delta`."""
    from ..ops.coloring import fog_color, sky_color

    base = fog_color() if fog_distance is not None else sky_color(coloring)
    return np.trunc(np.asarray(base) * 255.0).astype(np.uint8)


def fetch_viewer_fields_delta(result, model, step: float, sky_rgb,
                              co_fetch=()):
    """Device→host staging via the delta pack (v3) — metadata AND frame.

    Same contract as :func:`fetch_viewer_fields_separable` (Fast
    generator, no scene objects) plus: the no-hit region of the frame must
    be the single constant color ``sky_rgb`` (u8 triple — the coloring's
    sky, or the fog base when fog fills the sky; callers with
    partial-translucency remainders must use the separable pack).

    Returns ``(vf, image, stats)``: a :class:`ViewerFieldsSeparable` whose
    keys carry the 1/256-step fixed point (distance/lat-lon inside the
    display-precision bands documented at ``_KEY_QUANT``), the
    reconstructed [H, W, 3] u8 frame, and a stats dict with the actual
    staged byte count (``vf.nbytes`` reports the decoded container, not
    the link payload). ``co_fetch`` arrays ride the same overlap pool.
    """
    import jax as _jax

    from ..generators.base import fetch_pool, submit_fetch

    hits = result.hits
    az = np.asarray(result.azimuth_deg)
    if az.ndim != 1 or az.size != hits.key.shape[1]:
        raise ValueError(
            "fetch_viewer_fields_delta needs a separable [W] azimuth grid "
            "(Fast generator)"
        )
    h, w = hits.key.shape[0], hits.key.shape[1]
    co_fetch = tuple(co_fetch)
    ex = fetch_pool()
    try:
        co_outs, co_futs = submit_fetch(ex, co_fetch)
        (bits, key_d, kexc_i, kexc_v, el_n, eexc_i, eexc_v, el_ranges,
         img_n, img_ei, img_ev, counts) = pack_viewer_fields_delta(
            jnp.asarray(hits.key), jnp.asarray(hits.elevation),
            jnp.asarray(result.image),
        )
        (n, n_px, n_kexc, n_eexc, n_r, n_g, n_b) = (
            int(v) for v in _jax.device_get(counts)
        )
        segs = [bits, key_d[:n], kexc_i[:n_kexc], kexc_v[:n_kexc],
                el_n[:(n + 1) // 2], eexc_i[:n_eexc], eexc_v[:n_eexc]]
        for c, ne in enumerate((n_r, n_g, n_b)):
            segs += [img_n[c, :(n_px + 1) // 2], img_ei[c, :ne],
                     img_ev[c, :ne]]
        meta_outs, meta_futs = submit_fetch(ex, segs)
        for f in meta_futs + co_futs:
            f.result()
    finally:
        ex.shutdown(wait=True)
    (bits_h, key_d_h, kexc_i_h, kexc_v_h, el_n_h, eexc_i_h, eexc_v_h,
     rn_h, rei_h, rev_h, gn_h, gei_h, gev_h, bn_h, bei_h, bev_h) = meta_outs
    staged = sum(int(s.nbytes) for s in meta_outs)

    q = _delta_decode(key_d_h, kexc_i_h, kexc_v_h)
    key_c = (q.astype(np.float64) / _KEY_QUANT).astype(np.float32)
    el_h = _delta_decode4(el_n_h, n, eexc_i_h, eexc_v_h).astype(np.uint16)
    lat0, lon0 = float(result.observer[0]), float(result.observer[1])
    vf = ViewerFieldsSeparable(
        bits_h, key_c, el_h, np.asarray(el_ranges),
        tuple(hits.key.shape), step, model, lat0, lon0, az,
    )

    image = np.empty((h * w, 3), np.uint8)
    image[:] = np.asarray(sky_rgb, np.uint8)
    pv = vf.valid.reshape(h * w, -1).any(-1)
    for c, (nb, ei, ev) in enumerate(
        ((rn_h, rei_h, rev_h), (gn_h, gei_h, gev_h), (bn_h, bei_h, bev_h))
    ):
        image[pv, c] = _delta_decode4(nb, n_px, ei, ev).astype(np.uint8)
    image = image.reshape(h, w, 3)
    stats = {
        "staged_bytes": staged,
        "n_valid": int(n),
        "n_hit_px": int(n_px),
        "n_exceptions": int(n_kexc + n_eexc + n_r + n_g + n_b),
    }
    return (vf, image, stats) if not co_fetch else (
        vf, image, stats, list(co_outs)
    )


def fetch_viewer_fields(hits, step: float) -> ViewerFields:
    """Device→host staging of the viewer metadata via the fused pack.

    ``hits``: a HitBuffer with device-resident arrays. Four flat segment
    transfers totalling 14 B / pixel-slot (vs 16 B for four raw f32
    fetches), decoded lazily by the returned :class:`ViewerFields`.
    """
    from ..generators.base import fetch_flat_many

    key, la, lo, el, ranges = pack_viewer_fields(
        jnp.asarray(hits.key), jnp.asarray(hits.dlat),
        jnp.asarray(hits.dlon), jnp.asarray(hits.elevation),
    )
    key_h, la_h, lo_h, el_h = fetch_flat_many((key, la, lo, el))
    return ViewerFields(
        key_h, la_h, lo_h, el_h,
        np.asarray(ranges), tuple(hits.key.shape), step,
    )
