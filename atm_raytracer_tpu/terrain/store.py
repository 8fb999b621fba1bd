"""Tile store: lazy host-side tile registry + device mosaic packing.

Mirrors the reference's ``Terrain`` (src/terrain/mod.rs:55-127): a map from
(floor(lat), floor(lon)) to a 1°×1° tile, scanned from a folder, loaded
lazily on first elevation query. DTED tiles are keyed by their header origin
(mod.rs:85-98); GeoTIFF tiles by their ``N49E021`` filename (mod.rs:100-111).
Files that parse as neither raise, like mod.rs:113-118.

The device-side representation (``TerrainPack``) replaces the reference's
``RwLock`` lazy-load dance: tiles inside a render's reach are loaded eagerly
on host and stacked into one device-resident [T, S, S] array plus a small
integer tile index map — dedupe-before-compute instead of lock-guarded
memoization (SURVEY §2b).
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import dted, geotiff, native


@dataclasses.dataclass
class Tile:
    """One 1°×1° tile: south-first rows, inclusive edges.

    elev[i, j] = post at (lat0 + i/(n_lat-1), lon0 + j/(n_lon-1)).
    """

    lat0: int
    lon0: int
    elev: np.ndarray  # [n_lat, n_lon] float32, row 0 = south

    def get_elev(self, lat: float, lon: float) -> Optional[float]:
        """Bilinear sample (geotiff.rs:61-100 semantics incl. edge clamp)."""
        if not (self.lat0 <= lat <= self.lat0 + 1 and self.lon0 <= lon <= self.lon0 + 1):
            return None
        n_lat, n_lon = self.elev.shape
        r = (lat - self.lat0) * (n_lat - 1)
        c = (lon - self.lon0) * (n_lon - 1)
        ri = min(int(r), n_lat - 2)
        ci = min(int(c), n_lon - 2)
        rf, cf = r - ri, c - ci
        e = self.elev
        return float(
            e[ri, ci] * (1 - rf) * (1 - cf)
            + e[ri + 1, ci] * rf * (1 - cf)
            + e[ri, ci + 1] * (1 - rf) * cf
            + e[ri + 1, ci + 1] * rf * cf
        )


def _load_tile(path: Path, lat0: int, lon0: int) -> Tile:
    if native.available():
        info = native.probe(path)
        if info is not None:
            _, _, n_lat, n_lon = info
            res = native.load_batch([path], n_lat, n_lon)
            if res is not None and res[2][0] == 0:
                return Tile(lat0=lat0, lon0=lon0, elev=res[0][0])
    if native.gtif_available():
        info = native.gtif_probe(path)
        if info is not None:
            rows, cols = info
            res = native.gtif_load_batch([path], rows, cols)
            if res is not None and res[1][0] == 0:
                # native decode emits south-first rows already
                return Tile(lat0=lat0, lon0=lon0, elev=res[0][0])
    try:
        hdr, elev = dted.read_dted(path)
        return Tile(lat0=lat0, lon0=lon0, elev=elev)
    except ValueError:
        pass
    img = geotiff.read_geotiff(path)  # north-first rows
    return Tile(lat0=lat0, lon0=lon0, elev=img[::-1].copy())


class Terrain:
    """Folder-scanned tile registry with lazy host loading."""

    def __init__(self):
        self._paths: Dict[Tuple[int, int], Path] = {}
        self._loaded: Dict[Tuple[int, int], Tile] = {}
        self._pack_cache: Dict[tuple, "TerrainPack"] = {}

    @staticmethod
    def from_folder(folder) -> "Terrain":
        t = Terrain()
        folder = Path(folder)
        files = 0
        for p in sorted(folder.iterdir()):
            if p.is_dir():
                continue
            files += 1
            t.buffer_file(p)
        print(f"Detected {files} terrain files")
        return t

    def add_tile(self, tile: Tile) -> None:
        """Register an in-memory tile (synthetic terrain, benchmarks).

        Drops memoized device mosaics: the pack cache keys on tile KEYS,
        so replacing a tile's content under an unchanged key would
        otherwise serve the previous elevations on the next render.
        """
        self._loaded[(tile.lat0, tile.lon0)] = tile
        self._pack_cache.clear()

    def buffer_file(self, path) -> None:
        path = Path(path)
        try:
            hdr = dted.read_dted_header(path)
            key = (int(math.floor(hdr.origin_lat)), int(math.floor(hdr.origin_lon)))
            self._paths[key] = path
            return
        except (ValueError, OSError):
            pass
        coords = geotiff.coords_from_name(path)
        if coords is not None:
            self._paths[coords] = path
            return
        raise ValueError(f"Could not buffer terrain file {path}")

    @property
    def keys(self):
        return set(self._paths) | set(self._loaded)

    def _tile(self, key: Tuple[int, int]) -> Optional[Tile]:
        if key in self._loaded:
            return self._loaded[key]
        path = self._paths.get(key)
        if path is None:
            return None
        print(f"Lazy loading terrain file: {path}")
        tile = _load_tile(path, key[0], key[1])
        self._loaded[key] = tile
        return tile

    def preload(self, keys) -> None:
        """Batch-load not-yet-loaded tiles through the native loaders.

        Groups tiles by format and decodes each group with ONE threaded
        native call (one worker per tile, native/dted_loader.cpp +
        native/geotiff_loader.cpp) — a mosaic of dozens of tiles parses at
        disk speed instead of serial-Python speed. Tiles the native loaders
        don't cover fall back to the lazy per-tile path transparently.
        """
        missing = [k for k in keys if k not in self._loaded and k in self._paths]
        if len(missing) < 2:
            return
        dted_group = []  # (key, path, rows, cols)
        gtif_group = []
        if native.available():
            for k in missing:
                info = native.probe(self._paths[k])
                if info is not None:
                    dted_group.append((k, self._paths[k], info[2], info[3]))
        if native.gtif_available():
            taken = {g[0] for g in dted_group}
            for k in missing:
                if k in taken:
                    continue
                info = native.gtif_probe(self._paths[k])
                if info is not None:
                    gtif_group.append((k, self._paths[k], info[0], info[1]))
        for group, kind in ((dted_group, "dted"), (gtif_group, "gtif")):
            if not group:
                continue
            rows = max(g[2] for g in group)
            cols = max(g[3] for g in group)
            paths = [g[1] for g in group]
            if kind == "dted":
                res = native.load_batch(paths, rows, cols)
                arrs, status = (res[0], res[2]) if res is not None else (None, None)
            else:
                res = native.gtif_load_batch(paths, rows, cols)
                arrs, status = res if res is not None else (None, None)
            if arrs is None:
                continue
            for (k, path, nr, nc), arr, st in zip(group, arrs, status):
                if st == 0:
                    print(f"Lazy loading terrain file: {path}")
                    self._loaded[k] = Tile(
                        lat0=k[0], lon0=k[1], elev=arr[:nr, :nc].copy()
                    )

    def get_elev(self, lat: float, lon: float) -> Optional[float]:
        """Host bilinear elevation (terrain/mod.rs:120-126)."""
        key = (int(math.floor(lat)), int(math.floor(lon)))
        tile = self._tile(key)
        if tile is None:
            return None
        return tile.get_elev(lat, lon)

    def get_elev_or0(self, lat: float, lon: float) -> float:
        e = self.get_elev(lat, lon)
        return 0.0 if e is None else e

    # -- device packing -------------------------------------------------------

    def pack(
        self,
        lat_range: Tuple[float, float],
        lon_range: Tuple[float, float],
    ) -> "TerrainPack":
        """Load every tile intersecting the lat/lon box and stack for device.

        The box should cover observer ± max_distance (plus the normal-sampling
        arm). Tiles are padded to the max post count; per-tile scale factors
        keep mixed resolutions exact.
        """
        lat_lo = int(math.floor(lat_range[0]))
        lat_hi = int(math.floor(lat_range[1]))
        lon_lo = int(math.floor(lon_range[0]))
        lon_hi = int(math.floor(lon_range[1]))
        keys = [
            (la, lo)
            for la in range(lat_lo, lat_hi + 1)
            for lo in range(lon_lo, lon_hi + 1)
            if (la, lo) in self._paths or (la, lo) in self._loaded
        ]
        # memoize: repeat renders/sweeps must reuse the device-resident
        # mosaic (re-uploading hundreds of MB per call dwarfs the render)
        cache_key = (lat_lo, lat_hi, lon_lo, lon_hi, tuple(keys))
        cached = self._pack_cache.get(cache_key)
        if cached is not None:
            return cached
        self.preload(keys)
        tiles = [self._tile(k) for k in keys]
        # dense grid over the PRESENT tiles' bounding box: slot (r, c) =
        # r * n_cols + c, missing tiles stay all-zero (the reference's
        # missing-tile fallback IS elevation 0.0 — utils.rs:28-31,84 — so no
        # per-point tile-index table is needed on device; tile lookup is
        # pure integer arithmetic, saving a 3rd full-size gather per sample)
        if keys:
            lat_lo = min(k[0] for k in keys)
            lat_hi = max(k[0] for k in keys)
            lon_lo = min(k[1] for k in keys)
            lon_hi = max(k[1] for k in keys)
        n_lats = lat_hi - lat_lo + 1
        n_lons = lon_hi - lon_lo + 1
        if tiles:
            s = max(max(t.elev.shape) for t in tiles)
        else:
            s = 2
        # integer-meter tiles (all DTED, most GeoTIFF) pack as int16 —
        # halves gather bytes on device with zero precision loss
        int_exact = all(
            np.all(t.elev == np.round(t.elev))
            and t.elev.min() >= -32768 and t.elev.max() < 32768
            for t in tiles
        ) if tiles else False
        dtype = np.int16 if int_exact else np.float32
        stack = np.zeros((n_lats * n_lons, s, s), dtype)
        rows_m1 = np.ones((n_lats * n_lons,), np.float32)
        cols_m1 = np.ones((n_lats * n_lons,), np.float32)
        shapes = {t.elev.shape for t in tiles}
        grad_bound = 0.0  # mosaic Lipschitz bound, meters elev per meter
        from ..models.earth import DEGREE_DISTANCE

        for k, t in zip(keys, tiles):
            slot = (k[0] - lat_lo) * n_lons + (k[1] - lon_lo)
            nr, nc = t.elev.shape
            stack[slot, :nr, :nc] = t.elev
            rows_m1[slot] = nr - 1
            cols_m1[slot] = nc - 1
            # bilinear |∇| ≤ sqrt(gx² + gy²) with per-axis worst post diffs;
            # used by the culled rectilinear's conservative terrain envelope
            e = t.elev.astype(np.float32)
            sp_lat = DEGREE_DISTANCE / max(nr - 1, 1)
            sp_lon = (
                DEGREE_DISTANCE * max(0.1, math.cos(math.radians(k[0] + 0.5)))
                / max(nc - 1, 1)
            )
            gy = float(np.abs(np.diff(e, axis=0)).max(initial=0.0)) / sp_lat
            gx = float(np.abs(np.diff(e, axis=1)).max(initial=0.0)) / sp_lon
            grad_bound = max(grad_bound, math.hypot(gx, gy))
        # mosaic seam discontinuities: the sampled field STEPS at tile
        # boundaries when a missing cell (all-zero slot, the reference's 0.0
        # fallback) abuts real elevation, or when adjacent tiles disagree on
        # their shared edge posts. No finite Lipschitz bound covers a step,
        # so the culled rectilinear's envelope adds this jump as an absolute
        # slack term. Only seams inside the REQUESTED box matter — the
        # caller promises queries stay within it.
        tile_by_key = dict(zip(keys, tiles))
        seam_jump = 0.0

        def _edge(key, side):
            t = tile_by_key.get(key)
            if t is None:
                return np.zeros(2, np.float32)
            e = t.elev
            return {
                "n": e[-1, :], "s": e[0, :], "e": e[:, -1], "w": e[:, 0]
            }[side].astype(np.float32)

        def _jump(ea, eb):
            # the max |difference| of two piecewise-linear edges is attained
            # at a breakpoint of EITHER edge — sampling only the finer grid
            # misses extrema at the coarser edge's own posts and would
            # under-estimate this (required-conservative) envelope slack
            xa = np.linspace(0.0, 1.0, len(ea))
            xb = np.linspace(0.0, 1.0, len(eb))
            xs = np.union1d(xa, xb)
            da = np.interp(xs, xa, ea)
            db = np.interp(xs, xb, eb)
            return float(np.abs(da - db).max(initial=0.0))

        req_lat = range(int(math.floor(lat_range[0])), int(math.floor(lat_range[1])) + 1)
        req_lon = range(int(math.floor(lon_range[0])), int(math.floor(lon_range[1])) + 1)
        for la in req_lat:
            for lo in req_lon:
                if (la, lo + 1) in tile_by_key or (la, lo) in tile_by_key:
                    if lo + 1 in req_lon:
                        seam_jump = max(
                            seam_jump,
                            _jump(_edge((la, lo), "e"), _edge((la, lo + 1), "w")),
                        )
                if (la + 1, lo) in tile_by_key or (la, lo) in tile_by_key:
                    if la + 1 in req_lat:
                        seam_jump = max(
                            seam_jump,
                            _jump(_edge((la, lo), "n"), _edge((la + 1, lo), "s")),
                        )
        # win4 bit-parity cares only about seams INTERIOR to the pack's slot
        # grid: samples past the mosaic edge are masked invalid → 0.0 in both
        # the quad and win4 paths (see terrain/sample.py _locate `valid`), so
        # the requested-box seam_jump above — which includes the step to the
        # 0.0 fallback PAST the loaded tiles and is therefore > 0 for any
        # view whose bbox overhangs the mosaic (i.e. most renders) — must not
        # gate the paired sampler. A missing slot INSIDE the grid still
        # contributes its zero edges here and keeps win4 off: the one-cell
        # strip next to a present tile would otherwise tap that tile's real
        # boundary posts through the global grid where the per-slot quad path
        # (and the reference's 0.0 fallback, utils.rs:28-31) reads zeros.
        interior_seam = 0.0
        for la in range(lat_lo, lat_hi + 1):
            for lo in range(lon_lo, lon_hi + 1):
                if lo + 1 <= lon_hi:
                    interior_seam = max(
                        interior_seam,
                        _jump(_edge((la, lo), "e"), _edge((la, lo + 1), "w")),
                    )
                if la + 1 <= lat_hi:
                    interior_seam = max(
                        interior_seam,
                        _jump(_edge((la, lo), "n"), _edge((la + 1, lo), "s")),
                    )
        uniform = None
        if len(shapes) == 1:
            (nr, nc), = shapes
            uniform = (float(nr - 1), float(nc - 1))
        elif not shapes:
            uniform = (1.0, 1.0)
        quad = None
        tiles_dev = stack
        if dtype == np.int16:
            # quad-pack: quad[t, r, c] holds the full 2×2 bilinear footprint
            # rooted at (r, c) as two int32 lanes —
            #   lane 0 = (e[r,   c+1] << 16) | u16(e[r,   c])
            #   lane 1 = (e[r+1, c+1] << 16) | u16(e[r+1, c])
            # so one 8-byte-row gather replaces four scalar taps. Last
            # row/col lanes
            # pair with zeros and are never addressed (ri ≤ rows−2).
            u = stack.astype(np.uint16).astype(np.uint32)
            right = np.zeros_like(u)
            right[:, :, :-1] = u[:, :, 1:]
            row = (right << 16) | u  # [T, S, S] u32: (e[r,c+1], e[r,c])
            down = np.zeros_like(row)
            down[:, :-1, :] = row[:, 1:, :]
            # flat [T·S·S, 2] (NOT [T, S, S, 2]): the gather consumes
            # flat rows, so the jit argument needs no relayout
            quad = jnp.asarray(
                np.stack([row, down], axis=-1).astype(np.int32).reshape(-1, 2)
            )  # [T·S·S, 2]
            # the quad pack fully supersedes the raw tiles on device; keep
            # only a [T, 1, 1] stub (tile size travels via aux `tile_s`)
            tiles_dev = stack[:, :1, :1]
        win4 = None
        g_cols = 0
        n_posts_global = 0
        if quad is not None and uniform is not None and interior_seam == 0.0:
            nr = int(uniform[0]) + 1
            nc = int(uniform[1]) + 1
            n_posts_global = (n_lats * (nr - 1) + 1) * (n_lons * (nc - 1) + 1)
        if (
            n_posts_global
            and nr >= 4 and nc >= 4
            and n_posts_global
            <= int(os.environ.get("ATM_RAYTRACER_WIN4_MAX_POSTS", "60000000"))
        ):
            # win4: one 32-byte row per GLOBAL post = the 4×4 post window
            # rooted there, so the paired sampler (terrain/sample.py)
            # serves TWO consecutive march samples from ONE gather row,
            # halving the gathers of the [W, N] terrain stage.
            # Exists only when the pack is INTERIOR-seam-consistent
            # (interior_seam == 0 certifies every shared edge post inside
            # the slot grid agrees — including the zero edges a missing
            # interior slot contributes), so the global post grid is
            # well-defined and win4 taps are bit-identical to the per-tile
            # quad taps. The broader requested-box seam_jump deliberately
            # does NOT gate win4: views whose bbox overhangs the mosaic
            # make it > 0 via the 0.0 fallback past the loaded tiles, but
            # those samples are masked invalid in both paths (see the
            # overhang rationale above interior_seam).
            GR = n_lats * (nr - 1) + 1
            GC = n_lons * (nc - 1) + 1
            g = np.zeros((GR, GC), np.int16)
            for k, t in zip(keys, tiles):
                r0 = (k[0] - lat_lo) * (nr - 1)
                c0 = (k[1] - lon_lo) * (nc - 1)
                g[r0:r0 + nr, c0:c0 + nc] = t.elev
            # build the 8-lane row pack ON DEVICE (the host grid uploads as
            # 2 B/post; a host-built win4 would upload 32 B/post):
            # lane 2r+c2 = (g[+r, +2c2+1] << 16) | g[+r, +2c2]
            gd = jnp.asarray(g).astype(jnp.uint32) & jnp.uint32(0xFFFF)

            def _sh(dr, dc):
                return jnp.pad(
                    gd[dr:, dc:], ((0, dr), (0, dc)), constant_values=0
                )

            lanes = [
                (_sh(r, 2 * c2 + 1) << 16) | _sh(r, 2 * c2)
                for r in range(4)
                for c2 in range(2)
            ]
            win4 = jnp.stack(lanes, axis=-1).astype(jnp.int32).reshape(-1, 8)
            g_cols = GC
        result = TerrainPack(
            tiles=jnp.asarray(tiles_dev),
            tile_s=s,
            rows_m1=jnp.asarray(rows_m1),
            cols_m1=jnp.asarray(cols_m1),
            lat_min=lat_lo,
            lon_min=lon_lo,
            n_rows=n_lats,
            n_cols=n_lons,
            uniform=uniform,
            quad=quad,
            win4=win4,
            g_cols=g_cols,
            grad_bound=round(grad_bound, 6),
            seam_jump=round(seam_jump, 3),
        )
        self._pack_cache[cache_key] = result
        return result


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TerrainPack:
    """Device mosaic: dense [n_rows*n_cols, S, S] tile grid.

    Slot (r, c) = r * n_cols + c covers the 1°×1° cell at
    (lat_min + r, lon_min + c); missing tiles are all-zero slots (elevation
    0.0 = the reference's missing-tile fallback). ``uniform`` carries the
    (rows−1, cols−1) post counts as compile-time floats when every tile
    shares one shape — the overwhelmingly common case — so sampling needs no
    per-point scale-factor gathers.
    """

    tiles: jnp.ndarray  # [T, S, S] int16/f32, or a [T, 1, 1] stub when quad set
    rows_m1: jnp.ndarray  # [n_rows*n_cols] f32 (mixed-resolution fallback)
    cols_m1: jnp.ndarray  # [n_rows*n_cols] f32
    lat_min: int  # static: floor latitude of grid row 0
    lon_min: int
    n_rows: int  # static
    n_cols: int  # static
    uniform: Optional[Tuple[float, float]]  # static (rows−1, cols−1) or None
    quad: Optional[jnp.ndarray] = None  # [T·S·S, 2] int32 2×2-footprint pack
    # [GR·GC, 8] int32 4×4-post-window pack over the GLOBAL post grid
    # (seam-consistent uniform int16 mosaics only); lane 2r+c2 holds posts
    # (+r, +2c2) | (+r, +2c2+1). Serves the paired sampler.
    win4: Optional[jnp.ndarray] = None
    g_cols: int = 0  # static global post-grid column count (win4 row stride)
    tile_s: int = 0  # static padded tile side S (tiles may be a stub)
    # static mosaic Lipschitz bound |∇elev| (m/m) — sizes the conservative
    # slack of the culled rectilinear's azimuth-interval terrain envelope
    grad_bound: float = 0.0
    # static max step discontinuity (m) across tile seams inside the
    # requested box (missing cells vs real elevation, mismatched edges) —
    # added as ABSOLUTE envelope slack because no gradient bound covers a step
    seam_jump: float = 0.0

    def tree_flatten(self):
        return (
            (self.tiles, self.rows_m1, self.cols_m1, self.quad, self.win4),
            (self.lat_min, self.lon_min, self.n_rows, self.n_cols,
             self.uniform, self.tile_s, self.grad_bound, self.seam_jump,
             self.g_cols),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(
            children[0], children[1], children[2],
            lat_min=aux[0], lon_min=aux[1], n_rows=aux[2], n_cols=aux[3],
            uniform=aux[4], quad=children[3], win4=children[4],
            tile_s=aux[5], grad_bound=aux[6], seam_jump=aux[7],
            g_cols=aux[8],
        )
