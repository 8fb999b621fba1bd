"""Synthetic terrain fixtures shared by tests and benchmarks.

The reference has no fixtures (SURVEY §4); these generate deterministic
analytic landscapes written as real DTED / GeoTIFF files so the whole
parser → store → device-gather path is exercised.
"""

from __future__ import annotations

import numpy as np

from atm_raytracer_tpu.terrain import write_dted, write_geotiff


# spherical meters per degree of latitude (R = 6371 km): pi*R/180
M_PER_DEG = 111_194.9


def analytic_hills(lat, lon, base_lat=49.0, base_lon=21.0):
    """Smooth deterministic landscape, meters; works on arrays (degrees)."""
    la = np.asarray(lat, np.float64) - base_lat
    lo = np.asarray(lon, np.float64) - base_lon
    return (
        300.0
        + 250.0 * np.sin(2 * np.pi * la * 3.0) * np.cos(2 * np.pi * lo * 2.0)
        + 120.0 * np.sin(2 * np.pi * (la * 7.0 + lo * 5.0))
    )


def tile_grid(lat0: int, lon0: int, n: int):
    """Post grid (inclusive edges) of analytic_hills over a 1-degree tile."""
    lats = lat0 + np.arange(n) / (n - 1)
    lons = lon0 + np.arange(n) / (n - 1)
    grid = analytic_hills(lats[:, None], lons[None, :])
    return np.round(grid).astype(np.int16)  # integer meters, like real tiles


def make_terrain_folder(tmpdir, tiles=((49, 21),), n: int = 121, fmt: str = "dted"):
    """Write synthetic tiles into tmpdir; returns the folder path."""
    for lat0, lon0 in tiles:
        grid = tile_grid(lat0, lon0, n)  # [n_lat, n_lon], row 0 = south
        if fmt == "dted":
            write_dted(tmpdir / f"n{lat0}_e{lon0}.dt2", lat0, lon0, grid)
        elif fmt == "geotiff":
            name = (
                f"{'N' if lat0 >= 0 else 'S'}{abs(lat0):02d}"
                f"{'E' if lon0 >= 0 else 'W'}{abs(lon0):03d}.tif"
            )
            write_geotiff(tmpdir / name, grid[::-1])  # north-up image rows
        else:
            raise ValueError(fmt)
    return tmpdir


FLAT_DEG = 10_000_000.0 / 90.0  # flat-model meters per degree (mod.rs:12)


def make_bilin(grid, la0, lo0):
    """f64 bilinear sampler over one 1° tile's inclusive post grid
    (geotiff.rs:61-100 semantics incl. edge clamp)."""
    n = grid.shape[0]

    def bilin(lat, lon):
        u = np.clip((np.asarray(lat) - la0) * (n - 1), 0, n - 1)
        v = np.clip((np.asarray(lon) - lo0) * (n - 1), 0, n - 1)
        i0 = np.minimum(np.floor(u).astype(int), n - 2)
        j0 = np.minimum(np.floor(v).astype(int), n - 2)
        fu, fv = u - i0, v - j0
        return ((grid[i0, j0] * (1 - fu) + grid[i0 + 1, j0] * fu) * (1 - fv)
                + (grid[i0, j0 + 1] * (1 - fu)
                   + grid[i0 + 1, j0 + 1] * fu) * fv)

    return bilin


def make_mosaic_bilin(grids):
    """f64 bilinear sampler over a mosaic of 1° tiles.

    grids: {(lat0, lon0): inclusive post grid}. Each sample reads the tile
    at (floor(lat), floor(lon)) with ``make_bilin``'s semantics; samples in
    no tile read 0, the device mosaic's fill outside its tiles.
    """
    samplers = {k: make_bilin(g, *k) for k, g in grids.items()}

    def bilin(lat, lon):
        lat, lon = np.broadcast_arrays(np.asarray(lat, np.float64),
                                       np.asarray(lon, np.float64))
        la = np.floor(lat).astype(int)
        lo = np.floor(lon).astype(int)
        out = np.zeros(lat.shape, np.float64)
        for (a, b), f in samplers.items():
            m = (la == a) & (lo == b)
            if m.any():
                out[m] = f(lat[m], lon[m])
        return out

    return bilin


def _first_crossing(diff, terr, step, margin):
    """Crossing test + hit lerp (utils.rs:220-240) over the last axis.

    Returns (has_hit, distance, hit_elevation, robust); ``robust`` masks
    crossings whose endpoint margins exceed ``margin`` meters (knife edges
    where f32 and f64 may disagree on the sign)."""
    cross = (diff[..., :-1] * diff[..., 1:]) < 0
    first = np.argmax(cross, axis=-1)
    has = cross.any(-1)
    d0 = np.take_along_axis(diff[..., :-1], first[..., None], -1)[..., 0]
    d1 = np.take_along_axis(diff[..., 1:], first[..., None], -1)[..., 0]
    prop = d0 / (d0 - d1)
    dist = (first + prop) * step
    t0 = np.take_along_axis(terr[..., :-1], first[..., None], -1)[..., 0]
    t1 = np.take_along_axis(terr[..., 1:], first[..., None], -1)[..., 0]
    elev_hit = t0 + (t1 - t0) * prop
    robust = has & (np.minimum(np.abs(d0), np.abs(d1)) > margin)
    return has, dist, elev_hit, robust


def f64_flat_straight_oracle(grid, lat0, lon0, alt_rel, el_rad, az_rad,
                             step, max_distance):
    """Independent f64 re-derivation of the flat straight-ray pipeline.

    grid: [n, n] f64 tile posts (inclusive edges over the 1° tile at
    (floor(lat0), floor(lon0))). el_rad/az_rad broadcast together to the
    pixel grid. Returns (has_hit, distance, hit_elevation, robust).

    Mirrors from first principles: the FlatDistorted chart
    (directional_calc.rs:41-48), straight flat rays h = h0 + x·tan(e),
    bilinear tile sampling (geotiff.rs:61-100), the crossing test and hit
    lerp (utils.rs:220-240).
    """
    bilin = make_bilin(grid, int(np.floor(lat0)), int(np.floor(lon0)))
    alt0 = bilin(lat0, lon0) + alt_rel
    n_terr = int(np.ceil(max_distance / step))
    x = np.arange(n_terr + 1) * step
    el = np.asarray(el_rad, np.float64)
    az = np.asarray(az_rad, np.float64)
    lat_s = lat0 + np.cos(az)[..., None] * x / FLAT_DEG
    lon_s = (lon0 + np.sin(az)[..., None] * x / FLAT_DEG
             / np.cos(np.deg2rad(lat0)))
    terr = bilin(lat_s, lon_s)
    ray = alt0 + np.tan(el)[..., None] * x
    return _first_crossing(ray - terr, terr, step, margin=0.05)


def f64_march_spherical(atm, wavelength, h0, elev_rad, step, n, radius,
                        substeps=10):
    """Independent f64 RK4 integration of the spherical refraction ODE.

    The ODE re-derived from Fermat's principle for a stratified atmosphere
    over a sphere (the physics behind atm-refraction's cast_ray_stepper,
    utils.rs:142-171), with u = 1 + h/R and l(h) = d(ln n)/dh:

        h'' = l(h)·(u² + h'²) + (u² + 2·h'²)/(u·R)
        h'(0) = (1 + h0/R)·tan(e)     (dh per unit surface arc)

    Integrated at dx = step/substeps in f64 with the EXACT l(h) from the
    host atmosphere (no table, no Chebyshev fit). Returns h at the step
    grid: [len(elev_rad), n+1].
    """
    elev_rad = np.asarray(elev_rad, np.float64)
    h = np.full(elev_rad.shape, float(h0), np.float64)
    v = (1.0 + h / radius) * np.tan(elev_rad)
    out = np.empty(elev_rad.shape + (n + 1,), np.float64)
    out[..., 0] = h
    dx = step / substeps

    def acc(h, v):
        l = atm.dlnn_dh(h, wavelength)
        u = 1.0 + h / radius
        return l * (u * u + v * v) + (u * u + 2.0 * v * v) / (u * radius)

    for k in range(n):
        for _ in range(substeps):
            k1v = acc(h, v)
            k1h = v
            k2h = v + 0.5 * dx * k1v
            k2v = acc(h + 0.5 * dx * k1h, k2h)
            k3h = v + 0.5 * dx * k2v
            k3v = acc(h + 0.5 * dx * k2h, k3h)
            k4h = v + dx * k3v
            k4v = acc(h + dx * k3h, k4h)
            h = h + dx / 6.0 * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
            v = v + dx / 6.0 * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
        out[..., k + 1] = h
    return out


def f64_sphere_refracted_oracle(grid, lat0, lon0, alt_rel, el_rad, az_rad,
                                step, max_distance, atm, wavelength,
                                radius, margin=0.2, bilin=None, ray=None):
    """Independent f64 re-derivation of the SPHERICAL REFRACTED pipeline
    (the headline physics): f64 RK4 ray march with the exact atmosphere,
    great-circle geodesics by the standard navigation formula (an
    independent algebraic route from the rotation form the package uses),
    bilinear tile sampling, crossing + lerp.

    el_rad: [H] per-row elevations; az_rad: [W] per-column azimuths (the
    Fast generator's separable camera, fast.rs:111-125). Returns
    (has_hit, distance, hit_elevation, robust) of shape [H, W].

    ``bilin`` replaces the single-tile sampler over ``grid`` (a mosaic:
    ``make_mosaic_bilin``); ``ray`` is a precomputed
    ``f64_march_spherical`` result for ``el_rad``, so column chunks of one
    frame share one march.
    """
    if bilin is None:
        bilin = make_bilin(grid, int(np.floor(lat0)), int(np.floor(lon0)))
    alt0 = float(bilin(lat0, lon0)) + alt_rel
    n = int(np.ceil(max_distance / step))
    x = np.arange(n + 1) * step

    # great circle: lat2 = asin(sin la·cos δ + cos la·sin δ·cos az)
    la, lo = np.deg2rad(lat0), np.deg2rad(lon0)
    az = np.asarray(az_rad, np.float64)[:, None]
    delta = x[None, :] / radius
    sin_la2 = (np.sin(la) * np.cos(delta)
               + np.cos(la) * np.sin(delta) * np.cos(az))
    lat_s = np.arcsin(sin_la2)
    lon_s = lo + np.arctan2(np.sin(az) * np.sin(delta) * np.cos(la),
                            np.cos(delta) - np.sin(la) * sin_la2)
    terr = bilin(np.rad2deg(lat_s), np.rad2deg(lon_s))  # [W, n+1]

    if ray is None:
        ray = f64_march_spherical(atm, wavelength, alt0, el_rad, step, n,
                                  radius)  # [H, n+1]
    diff = ray[:, None, :] - terr[None, :, :]  # [H, W, n+1]
    return _first_crossing(diff, np.broadcast_to(terr[None], diff.shape),
                           step, margin=margin)
