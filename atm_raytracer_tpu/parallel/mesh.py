"""Multi-chip scaling: column-sharded frames + frame-sharded batched sweeps.

The reference's parallelism is rayon work-stealing over pixels on one node
(SURVEY §2b); the honest multi-chip analog is pure data parallelism over ICI:

* ``render_fast_sharded`` — one frame, azimuth columns sharded across the
  mesh. The terrain tensor [W, N], the combine [H, W] and all hit gathers
  partition cleanly on W; the path tensor [H, N] and the terrain mosaic are
  replicated (tiles are ~MBs; replication is cheap at panorama scales,
  SURVEY §5). Zero cross-shard communication except the output gather.
* ``render_rectilinear_sharded`` — image ROWS sharded through the fused
  tilt-0 program; tilted or object scenes fall through to
  ``render_rectilinear_pixelwise_sharded``, the dense exact per-pixel
  program with the flattened pixel axis sharded (every scene type has a
  multi-chip path).
* ``render_sweep_sharded`` — a batched 360° sweep (BASELINE configs[4]):
  frames vary by direction/tilt/altitude, vmapped into one launch and
  sharded frame-wise (data parallelism) across the mesh.

Both are expressed with ``jax.sharding.NamedSharding`` constraints and rely
on XLA SPMD to insert any collectives — no hand-written communication.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Params
from ..generators import fast as fast_mod
from ..generators.base import fetch_flat
from ..generators.base import RenderResult
from ..models import camera
from ..ops.objects import ObjectSet
from ..terrain.store import Terrain


def make_mesh(devices: Optional[Sequence] = None, axis: str = "x") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def _pad_to_multiple(arr: np.ndarray, mult: int):
    w = arr.shape[0]
    pad = (-w) % mult
    if pad:
        arr = np.concatenate([arr, arr[-1] + np.arange(1, pad + 1) * 1e-4])
    return arr, w


def render_fast_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Mesh,
    max_hits: Optional[int] = None,
) -> RenderResult:
    """Fast render with azimuth columns sharded over the mesh axis."""
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    elev_deg = camera.fast_ray_elevations(out.width, out.height, frame.fov, frame.tilt)
    az_deg = camera.fast_ray_azimuths(out.width, out.height, frame.fov, frame.direction)
    az_padded, true_w = _pad_to_multiple(az_deg.astype(np.float32), n_dev)

    lat_rng, lon_rng = fast_mod.terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = fast_mod.build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4
    objset, obj_windows = fast_mod.build_objects_cached(
        params, az_padded, n_terr
    )

    col_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    pack_r = jax.device_put(pack, repl)
    table_r = jax.device_put(table, repl)
    obj_r = jax.device_put(objset, repl) if objset is not None else None
    elev_r = jax.device_put(jnp.asarray(elev_deg, jnp.float32), repl)
    az_s = jax.device_put(jnp.asarray(az_padded), col_sharding)

    # the module-level jitted core (same cache render_fast hits) — a fresh
    # jit-wrapped closure here would recompile the whole pipeline per call
    image, hits = fast_mod._render_fast_device(
        pack_r, table_r, obj_r, elev_r, az_s, float(alt0),
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
    )

    image = (
        fetch_flat(image).reshape(image.shape)[:, :true_w]
    )  # flat fetch: [H, W, 3] u8 de-tiles on device otherwise
    hits = jax.tree.map(lambda x: x[:, :true_w], hits)  # device-resident
    return RenderResult(
        image=image,
        hits=hits,
        elevation_deg=elev_deg,
        azimuth_deg=camera.wrap_azimuth_deg(az_deg),
        observer=(pos.latitude, pos.longitude, alt0),
    )


def render_sweep_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Mesh,
    directions_deg: Sequence[float],
    altitudes_m: Optional[Sequence[float]] = None,
    atmospheres: Optional[Sequence] = None,
    tilts_deg: Optional[Sequence[float]] = None,
    fovs_deg: Optional[Sequence[float]] = None,
    max_hits: Optional[int] = None,
    return_hits=False,  # False | True | "valid" (hit masks only)
    fetch_frames: bool = True,
):
    """Batched sweep: F frames over (direction, tilt, fov, altitude,
    atmosphere), frame-sharded (BASELINE configs[4]: azimuth/altitude/
    refraction-profile parameter sweeps in one vmapped launch).

    atmospheres: optional per-frame ``AtmosphereDef``s; their l(h) tables
    stack into a [F, n] batch (the compiled-polynomial form is per-table
    static, so batched sweeps use the table-gather march path).
    tilts_deg / fovs_deg: optional per-frame camera tilt / field of view
    (zoom sweeps); the per-row elevation grid becomes a frame-sharded
    [F, H] batch.

    Returns images [F, H, W, 3] uint8. With ``return_hits=True`` also
    returns the per-frame HitBuffer batch ([F, H, W, K] leaves,
    DEVICE-resident and frame-sharded — fetch selectively; staging all
    frames' metadata through the host link costs more than the render).
    ``return_hits="valid"`` returns only the [F, H, W, K] hit masks (XLA
    dead-code-eliminates the other hit fields — the compact-frame staging
    path, meta/pack.py). ``fetch_frames=False`` leaves the images
    device-resident so callers can stage them compacted instead of
    paying the raw flat fetch here.
    """
    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt_base = pos.abs_altitude(terrain)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    dirs = np.asarray(list(directions_deg), np.float32)
    f = len(dirs)
    if altitudes_m is None:
        alts = np.full(f, alt_base, np.float32)
    else:
        alts = np.asarray(list(altitudes_m), np.float32)
        assert len(alts) == f
    pad = (-f) % n_dev
    if pad:
        dirs = np.concatenate([dirs, np.repeat(dirs[-1:], pad)])
        alts = np.concatenate([alts, np.repeat(alts[-1:], pad)])

    def _per_frame(vals, name):
        assert len(vals) == f, f"one {name} per frame"
        v = np.asarray(list(vals), np.float32)
        return np.concatenate([v, np.repeat(v[-1:], pad)]) if pad else v

    if tilts_deg is None and fovs_deg is None:
        elev_frames = None  # replicated [H] grid at the params tilt/fov
        elev_deg = camera.fast_ray_elevations(
            out.width, out.height, frame.fov, frame.tilt
        )
    else:
        tilts = (np.full(f + pad, frame.tilt, np.float32)
                 if tilts_deg is None else _per_frame(tilts_deg, "tilt"))
        fovs = (np.full(f + pad, frame.fov, np.float32)
                if fovs_deg is None else _per_frame(fovs_deg, "fov"))
        elev_frames = np.stack([
            camera.fast_ray_elevations(out.width, out.height, float(fv),
                                       float(t))
            for fv, t in zip(fovs, tilts)
        ]).astype(np.float32)  # [F, H]
        elev_deg = None  # per-frame grids; the replicated [H] row is unused
    if fovs_deg is None:
        az_rel = camera.fast_ray_azimuths(out.width, out.height, frame.fov, 0.0)
        az_frames = dirs[:, None] + az_rel[None, :].astype(np.float32)  # [F, W]
    else:  # per-frame fov: each frame gets its own azimuth fan
        az_frames = np.stack([
            d + camera.fast_ray_azimuths(out.width, out.height, float(fv), 0.0)
            for d, fv in zip(dirs, fovs)
        ]).astype(np.float32)  # [F, W]

    # terrain_bbox is omnidirectional (observer ± reach) and sizes the
    # longitude extent at the most poleward reachable latitude — a local
    # cos(lat0) copy here under-covered poleward-looking sweeps
    lat_rng, lon_rng = fast_mod.terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table_axes = None
    if atmospheres is None:
        table = fast_mod.build_refraction_table(params, float(alts.max()))
    else:
        assert len(atmospheres) == f, "one AtmosphereDef per frame"
        import dataclasses as _dc2

        from ..physics.atmosphere import Atmosphere
        from ..physics.ray import RefractionTable

        tables = [
            fast_mod.build_refraction_table(
                _dc2.replace(params, atmosphere=Atmosphere(a),
                             atmosphere_def=a),
                float(alts.max()),
            )
            for a in atmospheres
        ]
        if pad:
            tables.extend([tables[-1]] * pad)
        n_min = min(int(t.values.shape[0]) for t in tables)
        table = RefractionTable(
            h0=tables[0].h0,
            inv_dh=tables[0].inv_dh,
            values=jnp.stack([t.values[:n_min] for t in tables]),
            pairs=jnp.stack([t.pairs[: n_min - 1] for t in tables]),
            poly=None,  # per-frame polys aren't batchable (static aux)
        )
        table_axes = RefractionTable(
            h0=None, inv_dh=None, values=0, pairs=0, poly=None
        )
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4
    objset = ObjectSet.build(params) if params.objects else None

    # per-frame light vector: the Shading light direction is anchored to the
    # view direction (params.rs:252-258), so each sweep frame gets its own.
    import dataclasses as _dc

    lights = []
    for d in dirs:
        frame_d = _dc.replace(frame, direction=float(d))
        col = params.view.coloring.into_coloring(frame_d, pos, params.model)
        lights.append(col.light_dir if col.light_dir is not None else (0.0, 0.0, 1.0))
    lights = np.asarray(lights, np.float32)  # [F, 3]

    frames_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    az_dev = jax.device_put(jnp.asarray(az_frames), frames_sharding)
    alt_dev = jax.device_put(jnp.asarray(alts), frames_sharding)
    light_dev = jax.device_put(jnp.asarray(lights), frames_sharding)
    pack_r = jax.device_put(pack, repl)
    if table_axes is None:
        table_r = jax.device_put(table, repl)
    else:  # frame-batched tables shard with the frames
        import dataclasses as _dc3

        table_r = _dc3.replace(
            table,
            h0=jax.device_put(table.h0, repl),
            inv_dh=jax.device_put(table.inv_dh, repl),
            values=jax.device_put(table.values, frames_sharding),
            pairs=jax.device_put(table.pairs, frames_sharding),
        )
    obj_r = jax.device_put(objset, repl) if objset is not None else None
    if elev_frames is None:
        elev_r = jax.device_put(jnp.asarray(elev_deg, jnp.float32), repl)
    else:  # per-frame tilt: [F, H] grid shards with the frames
        elev_r = jax.device_put(jnp.asarray(elev_frames), frames_sharding)
    images, hits = _sweep_device(
        pack_r, table_r, obj_r, elev_r, az_dev, alt_dev, light_dev,
        batched_table=table_axes is not None,
        batched_elev=elev_frames is not None,
        with_hits=("valid" if return_hits == "valid" else bool(return_hits)),
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
    if fetch_frames:
        # flat fetch (u8 frames de-tile on device otherwise), host reshape
        frames = fetch_flat(images).reshape(images.shape)[:f]
    else:
        frames = images[:f]  # device-resident: caller stages/fetches
    if not return_hits:
        return frames
    hits = jax.tree.map(lambda x: x[:f], hits)  # drop mesh padding frames
    return frames, hits


# module-level jit (NOT a per-call closure: a fresh jit wrapper every sweep
# would recompile every time); pack/table as ARGUMENTS, not captures —
# captured device arrays would embed as HLO constants at lowering
@functools.partial(
    jax.jit,
    static_argnames=(
        "batched_table", "batched_elev", "with_hits", "model", "shape",
        "straight", "n_terr", "step", "max_hits", "lat0", "lon0", "coloring",
        "fog_distance", "terrain_alpha",
    ),
)
def _sweep_device(pack, table, objset, elev_deg, az_frames, alts, lights,
                  batched_table=False, batched_elev=False, with_hits=False,
                  **statics):
    def one_frame(tab, elev_row, az_row, alt, light):
        image, hits = fast_mod.fast_core(
            pack, tab, objset, elev_row, az_row, alt, light_dir=light,
            **statics,
        )
        if with_hits == "valid":
            # compact-frame staging needs only the hit mask; XLA DCEs the
            # other 13 per-frame hit fields
            return image, hits.valid
        return image, hits

    if batched_table:
        from ..physics.ray import RefractionTable

        tab_axes = RefractionTable(h0=None, inv_dh=None, values=0, pairs=0,
                                   poly=None)
    else:
        tab_axes = None
    elev_axes = 0 if batched_elev else None
    images, hits = jax.vmap(one_frame, in_axes=(tab_axes, elev_axes, 0, 0, 0))(
        table, elev_deg, az_frames, alts, lights
    )
    # when hits aren't requested, drop them INSIDE the jit so XLA
    # dead-code-eliminates the per-frame hit materialization
    return images, (hits if with_hits else None)


def render_interpolating_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Mesh,
    max_hits: Optional[int] = None,
) -> RenderResult:
    """InterpolatingRectilinear over the mesh: the snapped grid computes
    column-sharded (Fast-style) and the per-pixel interpolation partitions
    by image rows, with one in-program all-gather of the grid planes at the
    seam (generators.interpolating.render_interpolating's ``mesh`` mode).
    """
    from ..generators.interpolating import render_interpolating

    return render_interpolating(params, terrain, max_hits=max_hits, mesh=mesh)


def render_rectilinear_pixelwise_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Mesh,
    max_hits: Optional[int] = None,
    chunk_rows: Optional[int] = None,
) -> RenderResult:
    """Tilted / object Rectilinear: dense exact per-pixel program, the
    flattened pixel axis sharded over the mesh.

    A tilted pinhole couples azimuth to both pixel axes (rectilinear.rs:
    78-100), so nothing is column-shareable — but every pixel's march is
    fully independent (the reference rayons over all pixels regardless of
    scene, rectilinear.rs:32-37), which makes the dense program pure data
    parallelism over P = H·W rays: elementwise on P end to end (march,
    crossing scan, object tests, composite), zero cross-shard communication
    except the output gather. Memory per device is bounded the same way the
    single-chip dense path bounds it: a host loop over row chunks, each
    chunk's [P_chunk, n_terr] march cube split 1/n_dev per device.

    Exactness: this is the ground-truth dense program (the one the culled
    tilted path is parity-tested against), so outputs are bit-identical to
    the single-chip dense render.
    """
    from ..generators import rectilinear as rect_mod

    out = params.output
    frame = params.view.frame
    pos = params.view.position
    alt0 = pos.abs_altitude(terrain)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    h, w = out.height, out.width

    elev_rad, dir_rad = camera.rectilinear_ray_params(
        w, h, frame.fov, frame.tilt, frame.direction
    )  # [H, W]
    lat_rng, lon_rng = fast_mod.terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = fast_mod.build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4
    objset = ObjectSet.build(params) if params.objects else None

    statics = dict(
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

    repl = NamedSharding(mesh, P())
    pix = NamedSharding(mesh, P(axis))
    pack_r = jax.device_put(pack, repl)
    table_r = jax.device_put(table, repl)
    obj_r = jax.device_put(objset, repl) if objset is not None else None

    p_total = h * w
    rows = chunk_rows or rect_mod._auto_chunk_rows(w, h, n_terr)
    chunk = rows * w
    chunk += (-chunk) % n_dev  # every shard gets an equal slice
    pad = (-p_total) % chunk
    elev_flat = np.zeros(p_total + pad, np.float32)
    dir_flat = np.zeros(p_total + pad, np.float32)
    elev_flat[:p_total] = elev_rad.reshape(-1)
    dir_flat[:p_total] = np.rad2deg(dir_rad).reshape(-1)

    images, hit_parts = [], []
    for c0 in range(0, p_total + pad, chunk):
        el = jax.device_put(jnp.asarray(elev_flat[c0:c0 + chunk]), pix)
        dr = jax.device_put(jnp.asarray(dir_flat[c0:c0 + chunk]), pix)
        img_c, hits_c = rect_mod._rectilinear_chunk(
            pack_r, table_r, obj_r, el, dr, float(alt0), **statics
        )
        images.append(img_c)
        hit_parts.append(hits_c)

    image = (
        fetch_flat(jnp.concatenate(images, axis=0)[:p_total])
        .reshape(h, w, 3)
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


def render_rectilinear_sharded(
    params: Params,
    terrain: Terrain,
    mesh: Mesh,
    max_hits: Optional[int] = None,
) -> RenderResult:
    """Rectilinear over the mesh: fused ROW sharding when tilt == 0 with no
    objects; otherwise the dense exact program with the flattened PIXEL
    axis sharded (``render_rectilinear_pixelwise_sharded``).

    The fused march+combine (generators.rectilinear.fused_shared_core) is
    elementwise per pixel row — every pixel marches its own ray against the
    replicated per-column terrain cache — so row sharding partitions the ODE
    state, the window cubes and the running top-K cleanly, with zero
    cross-shard communication except the output gather. The per-column
    terrain cache is recomputed per device (7.7 M gathers — far cheaper than
    an all-gather of the [W, N, 6] stack over ICI at panorama scales).
    """
    from ..generators import rectilinear as rect_mod

    out = params.output
    frame = params.view.frame
    pos = params.view.position
    if frame.tilt != 0.0 or params.objects:
        return render_rectilinear_pixelwise_sharded(
            params, terrain, mesh, max_hits
        )
    alt0 = pos.abs_altitude(terrain)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    h, w = out.height, out.width

    elev_rad, dir_rad = camera.rectilinear_ray_params(
        out.width, out.height, frame.fov, frame.tilt, frame.direction
    )
    az_col = camera.rectilinear_column_azimuths(w, frame.fov, frame.direction)

    lat_rng, lon_rng = fast_mod.terrain_bbox(params)
    pack = terrain.pack(lat_rng, lon_rng)
    table = fast_mod.build_refraction_table(params, alt0)
    n_terr = int(math.ceil(frame.max_distance / params.simulation_step))
    if max_hits is None:
        max_hits = 1 if params.terrain_alpha >= 1.0 else 4

    repl = NamedSharding(mesh, P())
    row_sharding = NamedSharding(mesh, P(axis, None))

    image_flat, hits = rect_mod._fused_shared_device(
        jax.device_put(pack, repl),
        jax.device_put(table, repl),
        None,  # elevation grid derived on device, row-sharded in-program
        jax.device_put(jnp.asarray(az_col, jnp.float32), repl),
        float(alt0),
        cam=(w, h, float(frame.fov)),
        row_sharding=row_sharding,
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
        with_progress=False,
    )
    image = fetch_flat(image_flat)[: h * w * 3].reshape(h, w, 3)
    hits = jax.tree.map(lambda a: a[:h], hits)  # drop padded rows
    return RenderResult(
        image=image,
        hits=hits,
        elevation_deg=np.rad2deg(elev_rad),
        azimuth_deg=np.rad2deg(dir_rad),
        observer=(pos.latitude, pos.longitude, alt0),
    )
