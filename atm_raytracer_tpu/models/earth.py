"""Earth models: geometry services for 8 model variants.

Re-implements (device-first) the reference's ``EarthModel``
(src/utils/earth_model/mod.rs:19-145) and its geodesic calculators
(src/utils/earth_model/directional_calc.rs):

* ``world_directions(lat, lon)`` — local (north, east, up) basis
  (mod.rs:31-57);
* ``as_cartesian(coords)`` — geodetic → global cartesian (mod.rs:59-93),
  host-side f64 (used for light-direction construction and object placement);
* ``to_shape()`` — reduction to the physics shape: ellipsoid → mean-radius
  sphere (2a+b)/3, flat family → Flat (mod.rs:95-112);
* ``coords_at_dist`` — geodesic point at (azimuth, distance): great-circle
  rotation / Vincenty direct / azimuthal-equidistant line / lat-scaled flat
  (directional_calc.rs:9-185).

Device-first redesign notes (vs the reference's trait objects + f64):

* Model kind is config-static, so dispatch is plain Python at trace time —
  no ``lax.switch`` needed.
* Device math is float32. Absolute f32 lat/lon quantizes to ~4e-6 deg
  (~0.5 m), so the device pipeline represents positions as **deltas from the
  observer** (``geodesic_delta`` returns (dlat, dlon) in degrees), computed
  with cancellation-free forms (2·sin²(σ/2) instead of 1−cos σ, cross-product
  longitude differences, …): delta precision is ~1e-7 relative, i.e. ~cm over
  200 km. This includes the ellipsoid: ``_vincenty_delta_device`` is a
  cancellation-free (dlat, dlon) decomposition of Vincenty direct, ≤6 cm vs
  the host f64 path over 200 km (tests/test_earth.py). The host f64 path
  remains the oracle and is used for object placement and diagnostics.
* Object-local positions use ``enu_rel`` — the exact difference
  ``as_cartesian(P) − as_cartesian(O)`` expressed in O's (east, north, up)
  basis via small-quantity identities, so f32 keeps mm precision for points
  within the object-culling radius.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..physics.ray import EarthShape, FLAT

DEGREE_DISTANCE = 10_000_000.0 / 90.0  # flat-model meters per degree (mod.rs:12)
EARTH_R = 6_371_000.0
WGS84_A = 6_378_137.0
WGS84_B = 6_356_752.314245

# Central-difference arm for terrain normals (utils.rs:16).
NORMAL_DIFF = 15.0

_SPHERICAL_KINDS = ("SimpleSphere", "Spherical", "Ellipsoid", "Wgs84")
_FLAT_KINDS = ("AzimuthalEquidistant", "FlatDistorted", "ObserverAe", "SimpleObserverAe")


@dataclasses.dataclass(frozen=True)
class EarthModel:
    """One of the 8 reference variants (mod.rs:19-28).

    kind: SimpleSphere | Spherical | Ellipsoid | Wgs84 | AzimuthalEquidistant
          | FlatDistorted | ObserverAe | SimpleObserverAe
    """

    kind: str
    radius: Optional[float] = None  # Spherical / ObserverAe (proj_radius)
    a: Optional[float] = None  # Ellipsoid
    b: Optional[float] = None

    # -- construction / config ------------------------------------------------

    @staticmethod
    def from_config(value) -> "EarthModel":
        """Parse the YAML ``earth_shape`` value (README.md:181-209)."""
        if isinstance(value, str):
            if value in ("SimpleSphere", "AzimuthalEquidistant", "FlatDistorted",
                         "SimpleObserverAe", "Wgs84"):
                return EarthModel(kind=value)
            raise ValueError(f"unknown earth_shape {value!r}")
        if isinstance(value, dict) and len(value) == 1:
            (kind, body), = value.items()
            if kind == "Spherical":
                return EarthModel(kind="Spherical", radius=float(body["radius"]))
            if kind == "ObserverAe":
                # The reference's serde field is `proj_radius` (mod.rs:26);
                # its README documents `projection_radius` (README.md:189).
                # Accept both so real reference configs AND README-derived
                # ones load.
                if "proj_radius" in body:
                    return EarthModel(kind="ObserverAe", radius=float(body["proj_radius"]))
                return EarthModel(
                    kind="ObserverAe", radius=float(body["projection_radius"])
                )
            if kind == "Ellipsoid":
                return EarthModel(kind="Ellipsoid", a=float(body["a"]), b=float(body["b"]))
        raise ValueError(f"invalid earth_shape config: {value!r}")

    def to_config(self):
        if self.kind == "Spherical":
            return {"Spherical": {"radius": self.radius}}
        if self.kind == "ObserverAe":
            # Emit the reference binary's serde spelling (mod.rs:26).
            return {"ObserverAe": {"proj_radius": self.radius}}
        if self.kind == "Ellipsoid":
            return {"Ellipsoid": {"a": self.a, "b": self.b}}
        return self.kind

    # -- canonicalization ------------------------------------------------------

    def _canonical(self) -> "EarthModel":
        """Resolve the Simple*/Wgs84 aliases (mod.rs:64-71,97-103,132-143)."""
        if self.kind == "SimpleSphere":
            return EarthModel(kind="Spherical", radius=EARTH_R)
        if self.kind == "SimpleObserverAe":
            return EarthModel(kind="ObserverAe", radius=EARTH_R)
        if self.kind == "Wgs84":
            return EarthModel(kind="Ellipsoid", a=WGS84_A, b=WGS84_B)
        return self

    @property
    def is_flat_family(self) -> bool:
        return self.kind in _FLAT_KINDS

    def to_shape(self) -> EarthShape:
        """Physics shape (mod.rs:95-112): ellipsoid → sphere of (2a+b)/3."""
        m = self._canonical()
        if m.kind == "Spherical":
            return EarthShape(m.radius)
        if m.kind == "Ellipsoid":
            return EarthShape((2.0 * m.a + m.b) / 3.0)
        return FLAT

    def distance_radius(self) -> Optional[float]:
        """Radius used for geodesic distances (None = not spherical-distance).

        Note ObserverAe uses *spherical* distances with proj_radius even
        though its physics shape is Flat (mod.rs:127-130).
        """
        m = self._canonical()
        if m.kind in ("Spherical", "ObserverAe"):
            return m.radius
        return None

    # -- local basis ------------------------------------------------------------

    def world_directions(self, lat, lon, xp=np):
        """(north, east, up) unit vectors at (lat, lon) degrees (mod.rs:31-57).

        Flat family: AE-plane directions (north toward the pole, z up).
        Works with numpy (host f64) or jax.numpy (device f32) via ``xp``.
        Returns three arrays of shape lat.shape + (3,).
        """
        lat = xp.asarray(lat)
        lon = xp.asarray(lon)
        lon_r = xp.deg2rad(lon)
        sinlon, coslon = xp.sin(lon_r), xp.cos(lon_r)
        if self.is_flat_family:
            zero = xp.zeros_like(sinlon)
            one = xp.ones_like(sinlon)
            north = xp.stack([-coslon, -sinlon, zero], axis=-1)
            east = xp.stack([-sinlon, coslon, zero], axis=-1)
            up = xp.stack([zero, zero, one], axis=-1)
            return north, east, up
        lat_r = xp.deg2rad(lat)
        sinlat, coslat = xp.sin(lat_r), xp.cos(lat_r)
        up = xp.stack([coslat * coslon, coslat * sinlon, sinlat], axis=-1)
        north = xp.stack([-sinlat * coslon, -sinlat * sinlon, coslat], axis=-1)
        east = xp.stack([-sinlon, coslon, xp.zeros_like(sinlon)], axis=-1)
        return north, east, up

    # -- cartesian (host, f64) ---------------------------------------------------

    def as_cartesian(self, lat, lon, elev):
        """Geodetic → global cartesian, host-side float64 (mod.rs:59-93)."""
        m = self._canonical()
        lat = np.asarray(lat, np.float64)
        lon = np.asarray(lon, np.float64)
        elev = np.asarray(elev, np.float64)
        if m.kind == "Spherical":
            r = m.radius + elev
            la, lo = np.deg2rad(lat), np.deg2rad(lon)
            return np.stack(
                [r * np.cos(la) * np.cos(lo), r * np.cos(la) * np.sin(lo),
                 r * np.sin(la)], axis=-1)
        if m.kind == "Ellipsoid":
            a, b = m.a, m.b
            e2 = 1.0 - (b * b) / (a * a)
            la, lo = np.deg2rad(lat), np.deg2rad(lon)
            n = a / np.sqrt(1.0 - e2 * np.sin(la) ** 2)
            return np.stack(
                [(n + elev) * np.cos(la) * np.cos(lo),
                 (n + elev) * np.cos(la) * np.sin(lo),
                 (n * (1.0 - e2) + elev) * np.sin(la)], axis=-1)
        # flat family: azimuthal-equidistant plane (mod.rs:82-91)
        r = (90.0 - lat) * DEGREE_DISTANCE
        lo = np.deg2rad(lon)
        return np.stack([r * np.cos(lo), r * np.sin(lo), elev], axis=-1)

    # -- geodesics: host f64 reference implementation -----------------------------

    def coords_at_dist_host(self, lat0: float, lon0: float, az_deg, dist):
        """(lat, lon) at `dist` meters along azimuth, host f64 (vectorized).

        Mirrors directional_calc.rs; used for diagnostics (elev-profile),
        object placement, and as the oracle for the device delta forms.
        """
        m = self._canonical()
        az = np.deg2rad(np.asarray(az_deg, np.float64))
        dist = np.asarray(dist, np.float64)
        if m.kind == "FlatDistorted":  # directional_calc.rs:41-48
            dlat = np.cos(az) * dist / DEGREE_DISTANCE
            dlon = np.sin(az) * dist / DEGREE_DISTANCE / np.cos(np.deg2rad(lat0))
            return lat0 + dlat, lon0 + dlon
        if m.kind == "AzimuthalEquidistant":  # directional_calc.rs:20-28
            pos = self.as_cartesian(lat0, lon0, 0.0)
            north, east, _ = self.world_directions(lat0, lon0)
            dir_v = north * np.cos(az)[..., None] + east * np.sin(az)[..., None]
            p2 = pos + dir_v * dist[..., None]
            lon = np.rad2deg(np.arctan2(p2[..., 1], p2[..., 0]))
            r = np.hypot(p2[..., 0], p2[..., 1])
            return 90.0 - r / DEGREE_DISTANCE, lon
        if m.kind in ("Spherical", "ObserverAe"):  # directional_calc.rs:71-86
            north, east, up = self.world_directions(lat0, lon0)
            # the spherical basis regardless of flat-family (ObserverAe uses
            # SphericalCalc, which builds spherical_directions itself)
            la, lo = np.deg2rad(lat0), np.deg2rad(lon0)
            pos = np.array([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)])
            dirn = np.array([-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo), np.cos(la)])
            dire = np.array([-np.sin(lo), np.cos(lo), 0.0])
            d = dirn * np.cos(az)[..., None] + dire * np.sin(az)[..., None]
            ang = dist / m.radius
            f = pos * np.cos(ang)[..., None] + d * np.sin(ang)[..., None]
            return (np.rad2deg(np.arcsin(f[..., 2])),
                    np.rad2deg(np.arctan2(f[..., 1], f[..., 0])))
        # Ellipsoid: Vincenty direct (directional_calc.rs:103-185)
        return _vincenty_direct(m.a, m.b, lat0, lon0, az, dist, np)

    # -- geodesics: device f32 delta form -----------------------------------------

    def geodesic_delta(self, lat0: float, lon0: float, az_deg, dist):
        """Device geodesic: (dlat, dlon) degrees from the observer, float32.

        az_deg / dist broadcast together. All four calculators — Spherical,
        AE, FlatDistorted and Ellipsoid (``_vincenty_delta_device``) — use
        cancellation-free delta forms: ≤6 cm over 200 km in f32
        (tests/test_earth.py::test_geodesic_delta_device_precision).
        """
        m = self._canonical()
        az = jnp.deg2rad(jnp.asarray(az_deg, jnp.float32))
        dist = jnp.asarray(dist, jnp.float32)
        if m.kind == "FlatDistorted":
            dlat = jnp.cos(az) * dist / DEGREE_DISTANCE
            dlon = jnp.sin(az) * dist / DEGREE_DISTANCE / np.cos(np.deg2rad(lat0))
            return dlat, dlon
        if m.kind == "AzimuthalEquidistant":
            # pos = (r0, 0) in a frame rotated so lon0 = 0; dir per world basis:
            # north = -radial, east = +tangential.
            r0 = np.float32((90.0 - lat0) * DEGREE_DISTANCE)
            dxr = -jnp.cos(az) * dist  # radial displacement
            dxt = jnp.sin(az) * dist  # tangential displacement
            r2 = jnp.sqrt((r0 + dxr) ** 2 + dxt**2)
            # dr computed cancellation-free: r2^2 - r0^2 = 2 r0 dxr + dxr^2 + dxt^2
            dr = (2.0 * r0 * dxr + dxr * dxr + dxt * dxt) / (r2 + r0)
            dlat = -dr / DEGREE_DISTANCE
            dlon = jnp.rad2deg(jnp.arctan2(dxt, r0 + dxr))
            return dlat, dlon
        if m.kind in ("Spherical", "ObserverAe"):
            return _sphere_delta_device(m.radius, lat0, lon0, az, dist)
        # Ellipsoid: Vincenty in cancellation-free delta form (~cm, like the
        # other models).
        return _vincenty_delta_device(m.a, m.b, lat0, az, dist)

    def max_deg_rates(self, lat0: float, max_dist: float):
        """Conservative bounds on |d(dlat)/dd| and |d(dlon)/dd| (deg per
        meter of ground distance) along ANY geodesic of ``geodesic_delta``
        within ``max_dist`` of the observer.

        Sizes the static gate of the paired terrain sampler (two march
        samples per gather row need both samples' bilinear cells inside one
        4×4 post window). Returns (inf, inf) when no finite bound exists
        (e.g. the path can reach a pole where meridians converge).
        """
        import math as _m

        inf = float("inf")
        m = self._canonical()
        if m.kind == "FlatDistorted":
            return (1.0 / DEGREE_DISTANCE,
                    1.0 / (DEGREE_DISTANCE * _m.cos(_m.radians(lat0))))
        if m.kind == "AzimuthalEquidistant":
            # dlon = atan2 about the pole: rate ≤ (180/π)/r_min
            r0 = (90.0 - lat0) * DEGREE_DISTANCE
            r_min = r0 - max_dist
            if r_min <= 1.0:
                return (inf, inf)
            return (1.0 / DEGREE_DISTANCE, _m.degrees(1.0) / r_min)
        if m.kind in ("Spherical", "ObserverAe"):
            lat_reach = abs(lat0) + _m.degrees(max_dist / m.radius)
            if lat_reach >= 89.9:
                return (inf, inf)
            rate = _m.degrees(1.0) / m.radius
            return (rate, rate / _m.cos(_m.radians(lat_reach)))
        # Ellipsoid: min curvature radii bound the angular rates; the
        # meridian radius is smallest at the equator (a(1−e²)), the prime
        # vertical is ≥ b. 2% slack covers the f32 delta form.
        e2 = 1.0 - (m.b * m.b) / (m.a * m.a)
        lat_reach = abs(lat0) + _m.degrees(max_dist / m.b)
        if lat_reach >= 89.9:
            return (inf, inf)
        rate_lat = 1.02 * _m.degrees(1.0) / (m.a * (1.0 - e2))
        rate_lon = 1.02 * _m.degrees(1.0) / (m.b * _m.cos(_m.radians(lat_reach)))
        return (rate_lat, rate_lon)

    # -- normal-sampling offsets ---------------------------------------------------

    def normal_offsets(self, lat):
        """(dlat_north, dlon_east) degrees for a NORMAL_DIFF-meter move.

        Closed small-displacement forms of ``coords_at_dist_calc(.., 0/90°)
        .coords_at_dist(±15)`` (utils.rs:15-27): moving 15 m is ~2.4e-6 rad,
        where the full geodesic formulas reduce to meridian/parallel steps
        (error O(d²/R) ≈ 3.5e-5 m — far below terrain resolution). ``lat`` may
        be a jnp array (device) or numpy.
        """
        m = self._canonical()
        xp = jnp if isinstance(lat, jnp.ndarray) else np
        lat_r = xp.deg2rad(lat)
        d = NORMAL_DIFF
        if m.kind == "FlatDistorted":
            dlat = d / DEGREE_DISTANCE + xp.zeros_like(lat)
            dlon = d / DEGREE_DISTANCE / xp.cos(lat_r)
            return dlat, dlon
        if m.kind == "AzimuthalEquidistant":
            r = (90.0 - lat) * DEGREE_DISTANCE
            dlat = d / DEGREE_DISTANCE + xp.zeros_like(lat)
            dlon = xp.rad2deg(d / r)
            return dlat, dlon
        if m.kind in ("Spherical", "ObserverAe"):
            dlat = xp.rad2deg(d / m.radius) + xp.zeros_like(lat)
            dlon = xp.rad2deg(d / m.radius) / xp.cos(lat_r)
            return dlat, dlon
        # Ellipsoid: meridian / prime-vertical curvature radii.
        a, b = m.a, m.b
        e2 = 1.0 - (b * b) / (a * a)
        s2 = xp.sin(lat_r) ** 2
        mrad = a * (1.0 - e2) / (1.0 - e2 * s2) ** 1.5
        nrad = a / xp.sqrt(1.0 - e2 * s2)
        return xp.rad2deg(d / mrad), xp.rad2deg(d / (nrad * xp.cos(lat_r)))

    # -- object-local positions ------------------------------------------------------

    def enu_rel(self, dlat_p, dlon_p, elev_p, dlat_o, dlon_o, elev_o, lat0, obs_lat_lon=None):
        """as_cartesian(P) − as_cartesian(O), expressed in O's (east, north, up).

        All lat/lon arguments are observer-relative degrees (device f32);
        ``lat0`` is the observer's absolute latitude (Python float). Exact up
        to O(d³/R²) for separations d; mm-accurate inside culling radii.

        For the spherical family this equals the exact global difference
        rotated into O's ENU basis. Flat family: the AE-plane difference
        (mod.rs:82-91) in O's (east, north, up) = (tangential, −radial, z).
        Ellipsoid: spherical formula with local curvature radii (documented
        approximation; exact ellipsoidal difference differs by O(e²·d²/R)).
        Returns (..., 3) array [east, north, up] — note v ≡ up ≡ z-axis.
        """
        xp = jnp
        m = self._canonical()
        if m.is_flat_family:
            # AE-plane cartesian is shared by the whole flat family.
            # north = -(r_p cosΔλ − r_o) expanded cancellation-free:
            #        = -dr + (r_o + dr)·2sin²(Δλ/2)
            r_o = (90.0 - (lat0 + dlat_o)) * DEGREE_DISTANCE
            dr = -(dlat_p - dlat_o) * DEGREE_DISTANCE
            dlon_r = xp.deg2rad(dlon_p - dlon_o)
            r_p = r_o + dr
            east = r_p * xp.sin(dlon_r)
            north = -dr + r_p * 2.0 * xp.sin(dlon_r * 0.5) ** 2
            up = elev_p - elev_o
            return xp.stack([east, north, up], axis=-1)
        # spherical family
        if m.kind == "Ellipsoid":
            radius = (2.0 * m.a + m.b) / 3.0  # local sphere approximation
        else:
            radius = m.radius
        lat_o_abs = lat0 + dlat_o  # absolute degrees; trig of O(1) values is fine
        lo = xp.deg2rad(lat_o_abs)
        sin_o, cos_o = xp.sin(lo), xp.cos(lo)
        dlat_r = xp.deg2rad(dlat_p - dlat_o)
        dlon_r = xp.deg2rad(dlon_p - dlon_o)
        lat_p_abs = lat0 + dlat_p
        lp = xp.deg2rad(lat_p_abs)
        sin_p, cos_p = xp.sin(lp), xp.cos(lp)
        r_p = radius + elev_p
        r_o = radius + elev_o
        # unit radial of P in O's ENU, small-quantity forms:
        two_s2_lon = 2.0 * xp.sin(dlon_r * 0.5) ** 2  # = 1 - cos(dlon)
        u_e = cos_p * xp.sin(dlon_r)
        u_n = xp.sin(dlat_r) + cos_p * sin_o * two_s2_lon
        u_u_m1 = -2.0 * xp.sin(dlat_r * 0.5) ** 2 - cos_p * cos_o * two_s2_lon
        east = r_p * u_e
        north = r_p * u_n
        up = (elev_p - elev_o) + r_p * u_u_m1
        return xp.stack([east, north, up], axis=-1)


def _sphere_delta_device(radius, lat0, lon0, az, dist):
    """Great-circle rotation in cancellation-free delta form, f32.

    Derivation: with z = sin(lat), the rotated point has
      z' = z0 cos σ + cos(lat0) sin σ cos(az),   σ = dist / R.
    Using 1 − cos σ = 2 sin²(σ/2):
      Δz = −2 z0 sin²(σ/2) + cos(lat0) sin σ cos az,
      sin(dlat) = c0 Δz + z0 c0 ε / (1 + √(1−ε)),   ε = (2 z0 + Δz) Δz / c0²
    (from sin(lat−lat0) = z' c0 − √(1−z'²) z0 expanded around z0), and
      sin-like(dlon): tan(dlon) = sin σ sin az / (cos... ) — computed from the
    rotated vector expressed in the observer's (radial, north, east) frame,
    where the longitude delta has an exact small-angle form:
      dlon = atan2(sin σ sin az, cos(lat0) cos σ − sin(lat0) sin σ cos az) / ...
    more precisely, with components in the observer frame:
      x' (radial) = cos σ, n' = sin σ cos az, e' = sin σ sin az
    the new longitude relative to lon0 satisfies
      tan(dlon) = e' / (c0 x' − s0 n')  — no cancellation (denominator ~c0).
    """
    la0 = np.deg2rad(np.float64(lat0))
    z0 = np.float32(np.sin(la0))
    c0 = np.float32(np.cos(la0))
    sigma = dist / np.float32(radius)
    sin_s = jnp.sin(sigma)
    two_s2 = 2.0 * jnp.sin(sigma * 0.5) ** 2  # = 1 - cos(sigma)
    cos_az = jnp.cos(az)
    sin_az = jnp.sin(az)

    dz = -z0 * two_s2 + c0 * sin_s * cos_az
    eps = (2.0 * z0 + dz) * dz / (c0 * c0)
    # guard: near poles c0→0; clamp eps into valid sqrt domain
    eps = jnp.clip(eps, -1.0, None)
    sin_dlat = c0 * dz + z0 * c0 * eps / (1.0 + jnp.sqrt(jnp.maximum(1.0 - eps, 0.0)))
    dlat = jnp.rad2deg(jnp.arcsin(jnp.clip(sin_dlat, -1.0, 1.0)))

    e_comp = sin_s * sin_az
    denom = c0 * (1.0 - two_s2) - z0 * sin_s * cos_az
    dlon = jnp.rad2deg(jnp.arctan2(e_comp, denom))
    return dlat, dlon


def _vincenty_delta_device(a, b, lat0, az, dist, iters: int = 12):
    """Vincenty direct in cancellation-free (dlat, dlon) delta form, f32.

    Matches `_vincenty_direct` (directional_calc.rs:103-185) analytically but
    never forms an absolute latitude/longitude on device, so f32 keeps ~cm
    precision over 200 km instead of the ~0.5 m quantization of
    absolute-minus-start.

    Decomposition: with U the reduced latitude (tan U = (1−f) tan φ),
      dφ = dU + [δ(U₂) − δ(U₁)],   δ(U) ≡ φ(U) − U
                                        = atan( f sinU cosU / (1 − f cos²U) )
    (exact identity from φ = atan(tanU/(1−f)) and the atan difference
    formula — δ is O(f), pole-safe, and evaluated without cancellation).
    dU comes from the auxiliary-sphere rotation
      sin U₂ = sinU₁ cosσ + cosU₁ sinσ cosα₁,
    which is literally the spherical-delta problem — the same
    1−cosσ = 2sin²(σ/2) expansion as `_sphere_delta_device` applies.
    dlon = the Vincenty longitude difference L, which the formula already
    produces as a delta (never add lon0 on device).
    """
    f = (a - b) / a
    u1 = float(np.arctan((1.0 - f) * np.tan(np.deg2rad(np.float64(lat0)))))
    z0 = np.float32(np.sin(u1))
    c0 = np.float32(np.cos(u1))
    tan_u1 = np.float32(np.tan(u1))
    delta1 = np.float32(
        np.arctan(f * np.sin(u1) * np.cos(u1) / (1.0 - f * np.cos(u1) ** 2))
    )
    f32 = np.float32

    cos_az = jnp.cos(az)
    sin_az = jnp.sin(az)
    sig1 = jnp.arctan2(tan_u1, cos_az)
    sin_alfa = c0 * sin_az
    cos2 = 1.0 - sin_alfa**2
    u2c = cos2 * f32((a * a - b * b) / (b * b))
    cap_a = 1.0 + u2c / 256.0 * (64.0 + u2c * (-12.0 + 5.0 * u2c))
    cap_b = u2c / 512.0 * (128.0 + u2c * (-64.0 + 37.0 * u2c))
    cap_c = f32(f / 16.0) * cos2 * (4.0 + f32(f) * (4.0 - 3.0 * cos2))

    base = dist / f32(b) / cap_a
    sig = base
    for _ in range(iters):
        sigm = 2.0 * sig1 + sig
        dsig = cap_b * jnp.sin(sig) * (
            jnp.cos(sigm)
            + cap_b / 4.0 * jnp.cos(sig) * (-1.0 + 2.0 * jnp.cos(sigm) ** 2)
        )
        sig = base + dsig

    sin_s = jnp.sin(sig)
    cos_s = jnp.cos(sig)
    two_s2 = 2.0 * jnp.sin(sig * 0.5) ** 2  # = 1 − cos σ
    # ΔsinU = sinU₂ − sinU₁, then sin(dU) via the _sphere_delta_device algebra
    dz = -z0 * two_s2 + c0 * sin_s * cos_az
    eps = (2.0 * z0 + dz) * dz / (c0 * c0)
    eps = jnp.clip(eps, -1.0, None)
    sin_du = c0 * dz + z0 * c0 * eps / (
        1.0 + jnp.sqrt(jnp.maximum(1.0 - eps, 0.0))
    )
    du = jnp.arcsin(jnp.clip(sin_du, -1.0, 1.0))
    u2_abs = f32(u1) + du
    delta2 = jnp.arctan(
        f32(f) * jnp.sin(u2_abs) * jnp.cos(u2_abs)
        / (1.0 - f32(f) * jnp.cos(u2_abs) ** 2)
    )
    dlat = du + (delta2 - delta1)

    sigm = 2.0 * sig1 + sig
    lam = jnp.arctan(sin_s * sin_az / (c0 * cos_s - z0 * sin_s * cos_az))
    dl = lam - (1.0 - cap_c) * f32(f) * sin_alfa * (
        sig
        + cap_c * sin_s * (
            jnp.cos(sigm) + cap_c * cos_s * (-1.0 + 2.0 * jnp.cos(sigm) ** 2)
        )
    )
    return jnp.rad2deg(dlat), jnp.rad2deg(dl)


def _vincenty_direct(a, b, lat0, lon0, az_rad, dist, xp, iters: int = 12):
    """Vincenty direct problem (directional_calc.rs:103-185, NOAA inverse.pdf).

    The reference iterates to 1e-10 (directional_calc.rs:136-153); on device a
    fixed ``iters`` count replaces the data-dependent loop (converges in 3-4).
    Works with numpy f64 (host oracle) or jnp f32 (device).
    """
    f = (a - b) / a
    lat_r = xp.deg2rad(xp.asarray(lat0, xp.float64 if xp is np else jnp.float32))
    red_lat = xp.arctan((1.0 - f) * xp.tan(lat_r))
    sig1 = xp.arctan2(xp.tan(red_lat), xp.cos(az_rad))
    alfa = xp.arcsin(xp.cos(red_lat) * xp.sin(az_rad))
    cos2 = xp.cos(alfa) ** 2
    u2 = cos2 * (a * a - b * b) / (b * b)
    cap_a = 1.0 + u2 / 256.0 * (64.0 + u2 * (-12.0 + 5.0 * u2))
    cap_b = u2 / 512.0 * (128.0 + u2 * (-64.0 + 37.0 * u2))
    cap_c = f / 16.0 * cos2 * (4.0 + f * (4.0 - 3.0 * cos2))

    base = dist / b / cap_a
    sig = base
    for _ in range(iters):
        sigm = 2.0 * sig1 + sig
        dsig = cap_b * xp.sin(sig) * (
            xp.cos(sigm) + cap_b / 4.0 * xp.cos(sig) * (-1.0 + 2.0 * xp.cos(sigm) ** 2)
        )
        sig = base + dsig

    sigm = 2.0 * sig1 + sig
    sr, cr = xp.sin(red_lat), xp.cos(red_lat)
    ss, cs = xp.sin(sig), xp.cos(sig)
    ca1 = xp.cos(az_rad)
    lat2 = xp.arctan(
        (sr * cs + cr * ss * ca1)
        / ((1.0 - f) * xp.sqrt(xp.sin(alfa) ** 2 + (sr * ss - cr * cs * ca1) ** 2))
    )
    lam = xp.arctan(ss * xp.sin(az_rad) / (cr * cs - sr * ss * ca1))
    dl = lam - (1.0 - cap_c) * f * xp.sin(alfa) * (
        sig + cap_c * ss * (xp.cos(sigm) + cap_c * cs * (-1.0 + 2.0 * xp.cos(sigm) ** 2))
    )
    return xp.rad2deg(lat2), lon0 + xp.rad2deg(dl)
