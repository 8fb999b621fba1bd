"""Hit buffers: the dense fixed-K replacement for Vec<TracePoint>.

The reference's per-pixel output is ``ResultPixel{elevation_angle, azimuth,
trace_points: Vec<TracePoint>}`` with ``TracePoint{lat, lon, distance,
elevation, path_length, normal, color}`` (generators/mod.rs:14-44). On the device
the variable-length vectors become K fixed slots per pixel with validity
masks (SURVEY §7 "hard parts"), sorted ascending by march position; slots
beyond the pixel's hit count are invalid.

``kind``: 0 = PixelColor::Terrain(alpha), 1 = PixelColor::Rgba(color)
(generators/mod.rs:46-80). ``rgba[..., 3]`` stores the alpha for both kinds.
Positions are observer-relative degrees (see models.earth); absolute lat/lon
are reconstructed on host when writing metadata.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HitBuffer:
    valid: jnp.ndarray  # [H, W, K] bool
    key: jnp.ndarray  # [H, W, K] f32 march sort position (k + prop)
    dlat: jnp.ndarray  # [H, W, K] degrees from observer
    dlon: jnp.ndarray
    distance: jnp.ndarray  # [H, W, K] meters (x at hit)
    elevation: jnp.ndarray  # terrain elev (terrain hits) / ray elev (objects)
    path_length: jnp.ndarray
    normal: jnp.ndarray  # [H, W, K, 3]
    kind: jnp.ndarray  # [H, W, K] int32: 0 terrain / 1 rgba
    rgba: jnp.ndarray  # [H, W, K, 4]

    def tree_flatten(self):
        return (
            (self.valid, self.key, self.dlat, self.dlon, self.distance,
             self.elevation, self.path_length, self.normal, self.kind, self.rgba),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def k_slots(self) -> int:
        return self.valid.shape[-1]


@dataclasses.dataclass
class RenderResult:
    """One rendered frame: image + hit buffers + the angle grids.

    elevation_deg [H] / azimuth_deg [W] for the Fast generator (separable);
    rectilinear generators carry full [H, W] grids.
    """

    image: np.ndarray  # [H, W, 3] uint8 (pre-annotation)
    hits: HitBuffer
    elevation_deg: np.ndarray  # [H] or [H, W]
    azimuth_deg: np.ndarray  # [W] or [H, W]
    observer: tuple  # (lat0, lon0, alt_abs)


# Overlapped fetch: arrays of 32 MB or more leave the device as 16 MB
# slices from 8 threads, so several device-to-host copies are in flight
# at once and per-request latency overlaps. Whether this beats one plain
# transfer on a local PCIe host has not been measured.
_FETCH_OVERLAP_MIN_BYTES = 32 * 1024 * 1024
_FETCH_CHUNK_BYTES = 16 * 1024 * 1024
_FETCH_THREADS = 8


def fetch_flat(arr, chunk_bytes: int = 0) -> np.ndarray:
    """Device→host fetch of an array, flattened, with overlapped slices.

    The flat view slices along one axis whatever the array's rank
    ([H, W, 3] u8 frames, [H, W, K] hit planes). Arrays under 32 MB go as
    one transfer; larger ones are
    sliced into 16 MB chunks fetched from a small thread pool — each
    worker issues an independent device→host request, so transfers
    pipeline instead of serializing behind one stream.
    ``chunk_bytes > 0`` forces that slice size single-threaded (tests,
    and hosts where peak staging memory matters more than wall time).
    """
    if isinstance(arr, np.ndarray):
        return arr.reshape(-1)
    flat = arr.reshape(-1)
    n = int(flat.shape[0])
    itemsize = max(1, flat.dtype.itemsize)
    nbytes = n * itemsize
    if chunk_bytes:
        per = int(chunk_bytes) // itemsize
        if n <= per or per < 1:
            return np.asarray(flat)
        out = np.empty(n, np.dtype(flat.dtype.name))
        for a in range(0, n, per):
            b = min(a + per, n)
            out[a:b] = np.asarray(flat[a:b])
        return out
    if nbytes < _FETCH_OVERLAP_MIN_BYTES:
        return np.asarray(flat)
    # one copy of the chunk/pool machinery: the overlapped path IS the
    # single-array case of fetch_flat_many
    return fetch_flat_many([flat])[0]


def _build_fetch_units(arrays):
    """Split arrays into (out, a, b, src) chunk units; host arrays pass through."""
    units = []  # (out_buffer, dst_start, dst_stop, src_array)
    outs: list = []
    for arr in arrays:
        if isinstance(arr, np.ndarray):
            outs.append(arr.reshape(-1))
            continue
        flat = arr.reshape(-1)
        n = int(flat.shape[0])
        per = max(1, _FETCH_CHUNK_BYTES // max(1, flat.dtype.itemsize))
        out = np.empty(n, np.dtype(flat.dtype.name))
        outs.append(out)
        for a in range(0, n, per):
            units.append((out, a, min(a + per, n), flat))
    return outs, units


def _grab_unit(u):
    out, a, b, flat = u
    out[a:b] = np.asarray(flat if (a == 0 and b == out.size) else flat[a:b])


def fetch_flat_many(arrays) -> list:
    """Fetch several arrays flat with ONE shared overlap pool.

    ``fetch_flat`` in a loop serializes whole arrays behind each other, and
    arrays under the 32 MB threshold never overlap at all (the common case:
    a 1080p frame's four ~8 MB viewer-metadata segments). Here every
    (array, slice) unit of work across all inputs feeds one thread pool, so
    small arrays pipeline against each other and big ones still split.
    Host numpy inputs pass through untouched.
    """
    outs, units = _build_fetch_units(arrays)
    if len(units) == 1:
        _grab_unit(units[0])
        return outs
    if units:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(_FETCH_THREADS) as ex:
            list(ex.map(_grab_unit, units))
    return outs


def fetch_pool():
    """Overlap pool for PHASED fetches: submit some arrays, run device work,
    submit more, then join — early transfers hide later device compute
    (e.g. the 8K frame streams while the metadata pack runs). Caller owns
    shutdown; pair with :func:`submit_fetch`."""
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(_FETCH_THREADS)


def submit_fetch(ex, arrays):
    """Queue arrays on a :func:`fetch_pool` executor without blocking.

    Returns (outs, futures): ``outs`` are the destination flat buffers
    (host inputs pass through), valid only after every future resolves.
    """
    outs, units = _build_fetch_units(arrays)
    return outs, [ex.submit(_grab_unit, u) for u in units]


# ---------------------------------------------------------------------------
# per-percent progress (fast.rs:78-87, rectilinear.rs:40-49,
# interpolating_rectilinear.rs:141-150): the reference's AtomicUsize pixel
# counter becomes a host callback fired from inside the device scan. The sink
# is module-level so the traced jax.debug.callback closure stays a stable
# hashable (per-render closures would recompile every call).
# ---------------------------------------------------------------------------

_progress_sink = None


def set_progress_sink(sink):
    """Install the host progress reporter; returns the previous sink."""
    global _progress_sink
    prev = _progress_sink
    _progress_sink = sink
    return prev


def _emit_progress(frac) -> None:
    sink = _progress_sink
    if sink is not None:
        sink(int(round(float(frac) * 100.0)))


def scan_progress_emit(i, n: int, stride: int) -> None:
    """Emit (i+1)/n as a percent line from inside a traced scan body.

    Emits every ``stride`` iterations AND at the final iteration (so 100%
    always fires even when n-1 is not a stride multiple).
    """
    frac = (i.astype(jnp.float32) + 1.0) / jnp.float32(n)
    jax.lax.cond(
        (i % stride == 0) | (i == n - 1),
        lambda: jax.debug.callback(_emit_progress, frac, ordered=False),
        lambda: None,
    )


@functools.lru_cache(maxsize=None)
def callbacks_supported() -> bool:
    """Whether jax.debug.callback works on the active backend.

    A PJRT backend may reject host send/recv callbacks outright;
    in-program progress reporting must then degrade to end-of-render.
    Probed once with a trivial jitted program.
    """
    try:
        def fn(x):
            jax.debug.callback(lambda v: None, x, ordered=False)
            return x + 1.0

        np.asarray(jax.jit(fn)(jnp.float32(0.0)))
        return True
    except Exception:
        return False
