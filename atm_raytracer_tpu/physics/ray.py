"""Batched fixed-step ray marching of the atmospheric-refraction ODE.

Re-implements the propagation half of the ``atm-refraction`` crate:
``Environment::cast_ray_stepper(alt, elev_rad, straight)`` with
``set_step_size(step)`` yielding ``RayState{x, h, dh}`` (reference call sites
src/generator/generators/utils.rs:142-171, src/ray_path.rs:71-95), for
``EarthShape::{Flat, Spherical{radius}}``.

Instead of a per-ray iterator, all rays march in lockstep: a ``lax.scan`` over
N fixed steps carrying state vectors of shape [B] (one lane per ray). The
x-coordinate advances by exactly ``step`` per iteration, so it never needs to
be materialized — ``x_k = k * step``.

Coordinates and ODE (derived from Fermat's principle for a stratified
atmosphere; see tests/test_ray.py for the analytic oracles):

* Flat shape: x = horizontal distance, h = altitude.
      h'' = l(h) (1 + h'^2),          l(h) = d(ln n)/dh
  straight rays: h'' = 0 (exact straight line).
* Spherical shape of radius R: x = arc length along the r=R surface
  (this matches the reference's path-length correction ``calc_dist``
  src/generator/generators/utils.rs:42-53, which scales dx by (h+R)/R),
  h = altitude above the surface. With u = 1 + h/R:
      h'' = l(h) (u^2 + h'^2) + (u^2 + 2 h'^2) / (u R)
  straight rays drop the l(h) term (a straight chord expressed in curved
  coordinates — validated against the closed-form line-vs-circle geometry).

Initial conditions for elevation angle e (radians, from the local horizontal):
  flat:      h' = tan(e)
  spherical: h' = (1 + h0/R) tan(e)   (dh per unit *surface* arc)

Integrator: classic RK4 with fixed step dx = simulation_step, matching the
reference's accuracy knob (README.md:219-222). l(h) comes from a uniform-grid
lookup table (f32) built on host from the f64 atmosphere (~10k entries for a
10 km altitude span at 1 m spacing).

Path length: accumulated exactly like the reference's ``calc_dist``
(utils.rs:42-53): flat sqrt(dx²+dh²); spherical scales dx by (h_avg+R)/R.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .atmosphere import Atmosphere

DEATH_ALTITUDE = -1000.0  # path-death rule threshold (utils.rs:167)


@dataclasses.dataclass(frozen=True)
class EarthShape:
    """Physics shape: flat or sphere (``EarthShape`` in the reference crate,
    produced by ``EarthModel::to_shape`` src/utils/earth_model/mod.rs:95-112)."""

    radius: Optional[float]  # None = Flat

    @property
    def is_flat(self) -> bool:
        return self.radius is None


FLAT = EarthShape(None)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RefractionTable:
    """Uniform-grid table of l(h) = d(ln n)/dh, device-resident (f32).

    ``h0 + i*dh`` for i in [0, n). Queries clamp to the table range (the
    atmosphere model extends smoothly; rays below h0 or above the top use the
    boundary value — choose the range generously via ``build``).
    """

    h0: jnp.ndarray  # scalar f32
    inv_dh: jnp.ndarray  # scalar f32
    values: jnp.ndarray  # [n] f32
    pairs: jnp.ndarray  # [n-1, 2] f32: (values[i], values[i+1]) — one-take lerp
    # gather-free compiled form: l(h) as piecewise Chebyshev polynomials,
    # split at the atmosphere's own discontinuities (STATIC aux — nested
    # tuples of floats — so it bakes into jit programs as constants).
    # None when the profile resists a compact fit (then the table gathers).
    poly: Optional[Tuple] = None  # ((h_lo, h_hi, (c0, c1, ...)), ...)

    def tree_flatten(self):
        return (
            (self.h0, self.inv_dh, self.values, self.pairs),
            (self.poly,),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, poly=aux[0])

    @staticmethod
    def build(
        atm: Atmosphere,
        wavelength: float,
        h_lo: float = -2000.0,
        h_hi: float = 20000.0,
        dh: float = 1.0,
    ) -> "RefractionTable":
        hs = np.arange(h_lo, h_hi + dh, dh, dtype=np.float64)
        vals64 = atm.dlnn_dh(hs, wavelength)
        vals = vals64.astype(np.float32)
        pairs = np.stack([vals[:-1], vals[1:]], axis=-1)
        return RefractionTable(
            h0=jnp.float32(h_lo),
            inv_dh=jnp.float32(1.0 / dh),
            values=jnp.asarray(vals),
            pairs=jnp.asarray(pairs),
            poly=_fit_piecewise_cheb(vals64, h_lo, dh),
        )

    def lookup(self, h: jnp.ndarray) -> jnp.ndarray:
        """Linear interpolation of l(h); clamps outside the grid.

        Both cell ends come from ONE gather of the adjacent-pair table —
        gather launches, not bytes, bound the march's inner loop.
        """
        t = (h - self.h0) * self.inv_dh
        n = self.values.shape[0]
        t = jnp.clip(t, 0.0, float(n - 1))
        # clamp the base index to n-2 (not via the float clip: for large n
        # the f32 "n - 1 - eps" rounds back up to n - 1, and the i+1 tap
        # would gather out of bounds — NaN under jnp.take's fill mode)
        i = jnp.minimum(jnp.floor(t).astype(jnp.int32), n - 2)
        f = t - i.astype(t.dtype)
        row = jnp.take(self.pairs, i, axis=0)  # [..., 2]
        return row[..., 0] * (1.0 - f) + row[..., 1] * f

CHEB_DEG = 6


def _fit_piecewise_cheb(
    vals: np.ndarray,
    h_lo: float,
    dh: float,
    cum_tol: float = 2e-8,
    max_segments: int = 24,
) -> Optional[Tuple]:
    """Compile the l(h) table into piecewise Chebyshev polynomials.

    Segments split first at detected jump discontinuities (l(h) genuinely
    JUMPS at lapse-rate boundaries — e.g. the US-76 tropopause — because
    dT/dh enters it directly), then bisect recursively until each fits to
    tolerance. The acceptance criterion is the error the *ODE* feels: l
    enters the march through its integral along the ray (the slope picks up
    ∫l dh), so the cumulative-integral deviation |∫(fit−l)dh| is bounded by
    ``cum_tol`` (dimensionless slope; 2e-8 keeps even grazing rays within
    centimeters over 200 km).

    Returns ((h_start, h_end, coeffs), ...) with coeffs a (CHEB_DEG+1)-tuple
    of floats, or None if the profile needs more than ``max_segments``
    pieces (evaluation cost then favors the gather path anyway).
    """
    from numpy.polynomial import chebyshev as C

    vals = np.asarray(vals, np.float64)
    n = vals.shape[0]
    hs = h_lo + np.arange(n) * dh
    dv = np.abs(np.diff(vals))
    med = np.median(dv)
    jumps = np.where((dv > 10.0 * med) & (dv > 1e-11))[0] + 1
    bounds = [0] + [int(j) for j in jumps] + [n]

    def fit(a: int, b: int):
        """Fit vals[a:b]; returns full-degree coeffs or None."""
        if b - a == 1:  # single sample (e.g. the table-top edge): constant
            return np.array([vals[a]] + [0.0] * CHEB_DEG)
        deg = min(CHEB_DEG, b - a - 1)
        x = np.linspace(-1.0, 1.0, b - a)
        c = C.chebfit(x, vals[a:b], deg)
        err = C.chebval(x, c) - vals[a:b]
        if np.max(np.abs(np.cumsum(err))) * dh > cum_tol:
            return None
        return np.concatenate([c, np.zeros(CHEB_DEG + 1 - len(c))])

    segments = []
    stack = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)][::-1]
    while stack:
        a, b = stack.pop()
        if len(segments) + len(stack) >= max_segments:
            return None
        c = fit(a, b)
        if c is None:
            if b - a < 4:
                return None
            mid = (a + b) // 2
            stack.extend([(mid, b), (a, mid)])
            continue
        segments.append(
            (float(hs[a]), float(hs[b - 1]), tuple(float(v) for v in c))
        )
    return tuple(segments)


def eval_l_poly(poly: Tuple, h: jnp.ndarray) -> jnp.ndarray:
    """Evaluate piecewise-Chebyshev l(h) — elementwise math, zero gathers.

    The coefficients are compile-time constants. Queries clamp to the
    fitted range, matching ``lookup``'s clamp semantics.
    """
    h = jnp.clip(h, poly[0][0], poly[-1][1])
    out = jnp.zeros_like(h)
    for k, (lo, hi, coeffs) in enumerate(poly):
        # zero-width segments exist (single-sample edge pieces)
        t = jnp.clip((h - lo) / max(hi - lo, 1e-30) * 2.0 - 1.0, -1.0, 1.0)
        # Clenshaw recurrence
        b1 = jnp.zeros_like(t)
        b2 = jnp.zeros_like(t)
        for c in coeffs[:0:-1]:
            b1, b2 = c + 2.0 * t * b1 - b2, b1
        val = coeffs[0] + t * b1 - b2
        if k == len(poly) - 1:
            mask = h >= lo
        else:
            mask = (h >= lo) & (h < poly[k + 1][0])
        out = jnp.where(mask, val, out)
    return out


def _acceleration(
    h: jnp.ndarray,
    v: jnp.ndarray,
    table: Optional[RefractionTable],
    radius: Optional[float],
    straight: bool,
    l_pre: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """h'' per the module-docstring ODE. table=None or straight ⇒ no bending.

    l_pre: optional precomputed l(h) (batched-lookup fast path in the march).
    """
    if radius is None:
        if straight or table is None:
            return jnp.zeros_like(h)
        l = table.lookup(h) if l_pre is None else l_pre
        return l * (1.0 + v * v)
    inv_r = 1.0 / radius
    u = 1.0 + h * inv_r
    geom = (u * u + 2.0 * v * v) / u * inv_r
    if straight or table is None:
        return geom
    l = table.lookup(h) if l_pre is None else l_pre
    return l * (u * u + v * v) + geom


def _rk4_step(h, v, dx, table, radius, straight):
    """One classic RK4 step of the ray ODE on state vectors (h, h').

    ONE batched l(h) eval per step: stage altitudes are predicted from the
    carried slope (h + 0.5·dx·v, h + dx·v). The true stage arguments differ
    by O(dx²·h'') ≈ centimeters, and l(h) enters multiplied by small
    curvature terms, so the induced error is far below the integrator
    tolerance, and the table path gathers once per step instead of four
    times.
    """
    bend = table is not None and not straight
    if bend:
        hq = jnp.stack([h, h + (0.5 * dx) * v, h + dx * v], axis=0)
        if table.poly is not None:
            ls = eval_l_poly(table.poly, hq)
        else:
            ls = table.lookup(hq)
        l1, l2, l4 = ls[0], ls[1], ls[2]
    else:
        l1 = l2 = l4 = None
    k1v = _acceleration(h, v, table, radius, straight, l_pre=l1)
    k1h = v
    k2h = v + 0.5 * dx * k1v
    k2v = _acceleration(h + 0.5 * dx * k1h, k2h, table, radius,
                        straight, l_pre=l2)
    k3h = v + 0.5 * dx * k2v
    k3v = _acceleration(h + 0.5 * dx * k2h, k3h, table, radius,
                        straight, l_pre=l2)
    k4h = v + dx * k3v
    k4v = _acceleration(h + dx * k3h, k4h, table, radius, straight,
                        l_pre=l4)
    h_new = h + dx / 6.0 * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
    v_new = v + dx / 6.0 * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return h_new, v_new


# Scan shape on the GPU: coarse windows per march_scan* iteration
# (Rectilinear) and the unroll of march_rays' scan (Fast,
# InterpolatingRectilinear). Timed warm at the 1080p/200 km headline on an
# H100 80GB HBM3 at 700 W: Fast 15.2 ms with unroll 8 against 17.1 ms with
# 1; Rectilinear 39.1-40.5 ms with group 8 against 43.2-44.7 ms with 1. On
# the CPU (tests) both stay 1: there they only add compile time.
GPU_SCAN_GROUP = 8
GPU_MARCH_UNROLL = 8


def _scan_group() -> int:
    return GPU_SCAN_GROUP if jax.default_backend() == "gpu" else 1


def march_coarse(step: float) -> int:
    """Coarse RK4 window length in march steps (~800 m of ground distance).

    THE one copy of the heuristic: every generator must integrate with the
    same window or cross-generator bit-parity breaks. Override with
    ATM_RAYTRACER_MARCH_COARSE.
    """
    import os

    return int(os.environ.get("ATM_RAYTRACER_MARCH_COARSE", "0")) or max(
        1, int(800.0 // step)
    )


def rk4_window(h, v, plen, step, coarse, table, straight, radius):
    """One coarse RK4 step + Hermite dense output + calc_dist path lengths.

    Returns (h_f [..., C+1], plen_f [..., C+1], h1, v1): exactly the values
    a ``march_scan`` window produces from the same (h, v, plen) state —
    bitwise reproducible, so captured window states can be re-expanded later
    (the culled Rectilinear re-integrates candidate blocks this way). State
    may have any shape (flat [B] or [H, W] planes — the fused Rectilinear's
    post-scan stays 2-D to avoid [P]↔[H, W] relayout copies).
    """
    dx = jnp.float32(step * coarse)
    dxf = jnp.float32(step)
    h1, v1 = _rk4_step(h, v, dx, table, radius, straight)
    # the ONE Hermite dense-output implementation (bitwise contract: callers
    # re-expand captured windows via either entry point)
    h_f = hermite_window(h, v, h1, v1, dx, coarse)  # [..., C+1]
    dh = h_f[..., 1:] - h_f[..., :-1]
    if radius is None:
        seg_len = jnp.sqrt(dxf * dxf + dh * dh)
    else:
        dx_eff = dxf * ((h_f[..., 1:] + h_f[..., :-1]) * 0.5 + radius) / radius
        seg_len = jnp.sqrt(dx_eff * dx_eff + dh * dh)
    plen_f = jnp.concatenate(
        [plen[..., None], plen[..., None] + jnp.cumsum(seg_len, axis=-1)],
        axis=-1,
    )
    return h_f, plen_f, h1, v1


def _path_speed(h, v, radius):
    """dP/dx — the smooth integrand of the reference's chord-sum path
    length (utils.rs:42-53): flat √(1+h'²); spherical √(((h+R)/R)² + h'²).
    The 50 m chord sum and the true arc differ by (h''·dx)²·dx/24 ≈ 1e-10 m
    per segment, so integrating P with the march's own RK4 stages stays
    micrometers from the reference semantics over 200 km."""
    if radius is None:
        return jnp.sqrt(1.0 + v * v)
    u = 1.0 + h / radius
    return jnp.sqrt(u * u + v * v)


def _rk4_step_quad(h, v, p, dx, table, radius, straight):
    """One RK4 step carrying (h, h', path_length) — P via the embedded
    4th-order quadrature over the same stages (no fine-grid chord sums)."""
    bend = table is not None and not straight
    if bend:
        hq = jnp.stack([h, h + (0.5 * dx) * v, h + dx * v], axis=0)
        if table.poly is not None:
            ls = eval_l_poly(table.poly, hq)
        else:
            ls = table.lookup(hq)
        l1, l2, l4 = ls[0], ls[1], ls[2]
    else:
        l1 = l2 = l4 = None
    k1v = _acceleration(h, v, table, radius, straight, l_pre=l1)
    k1h = v
    k2h = v + 0.5 * dx * k1v
    k2v = _acceleration(h + 0.5 * dx * k1h, k2h, table, radius,
                        straight, l_pre=l2)
    k3h = v + 0.5 * dx * k2v
    k3v = _acceleration(h + 0.5 * dx * k2h, k3h, table, radius,
                        straight, l_pre=l2)
    k4h = v + dx * k3v
    k4v = _acceleration(h + dx * k3h, k4h, table, radius, straight,
                        l_pre=l4)
    f1 = _path_speed(h, k1h, radius)
    f2 = _path_speed(h + 0.5 * dx * k1h, k2h, radius)
    f3 = _path_speed(h + 0.5 * dx * k2h, k3h, radius)
    f4 = _path_speed(h + dx * k3h, k4h, radius)
    h_new = h + dx / 6.0 * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
    v_new = v + dx / 6.0 * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    p_new = p + dx / 6.0 * (f1 + 2.0 * f2 + 2.0 * f3 + f4)
    return h_new, v_new, p_new


def hermite_coeffs(coarse):
    """The [C+1] Hermite basis vectors shared by every dense-output form.

    ONE copy of the basis arithmetic: ``hermite_window`` (the [B, C+1]
    cube form) and ``hermite_plane`` (the per-sample [B] plane form) both
    index these exact folded constants, so the two evaluation orders
    produce bitwise-identical fine samples — the invariant the fused
    Rectilinear's scan-time test vs post-scan re-expansion relies on.
    """
    t = jnp.arange(coarse + 1, dtype=jnp.float32) / jnp.float32(coarse)
    t2 = t * t
    t3 = t2 * t
    b00 = 2.0 * t3 - 3.0 * t2 + 1.0
    b10 = t3 - 2.0 * t2 + t
    b01 = -2.0 * t3 + 3.0 * t2
    b11 = t3 - t2
    return b00, b10, b01, b11


def hermite_plane(h, vdx, h1, v1dx, coeffs, j):
    """ONE fine Hermite sample [B] (index ``j`` of the window) from node
    states, with ``vdx = v·dx_window`` / ``v1dx = v1·dx_window`` hoisted.

    Same multiply/add association as ``hermite_window``'s element [i, j],
    so the values are bitwise those of the cube form — but evaluating
    plane by plane lets a consumer stream the crossing test without the
    [B, C+1] cube ever reaching HBM (the cube write+read was ~200 ms of a
    1080p Rectilinear render)."""
    b00, b10, b01, b11 = coeffs
    return b00[j] * h + b10[j] * vdx + b01[j] * h1 + b11[j] * v1dx


def hermite_window(h, v, h1, v1, dx_window, coarse):
    """Fine Hermite samples [..., C+1] of one coarse window from its node
    states (any leading shape) — the same dense output rk4_window produces."""
    b00, b10, b01, b11 = hermite_coeffs(coarse)  # [C+1] each, broadcast last
    return (
        b00 * h[..., None] + b10 * (v * dx_window)[..., None]
        + b01 * h1[..., None] + b11 * (v1 * dx_window)[..., None]
    )


def march_scan_light(
    alt: jnp.ndarray,
    elev_rad: jnp.ndarray,
    step: float,
    n_steps: int,
    shape: EarthShape,
    table: Optional[RefractionTable],
    straight: bool,
    consumer,
    init_carry,
    coarse: int = 1,
    group: int = 0,
    pass_nodes: bool = False,
):
    """Fused march WITHOUT the fine path-length machinery.

    The fine chord cumsum of ``march_scan`` costs more than the whole rest
    of the march (measured 0.41 s of 0.68 s at 1080p/200 km); here path
    length advances by the 4th-order RK4 quadrature of dP/dx instead
    (``_rk4_step_quad`` — micrometer-equivalent, see ``_path_speed``), and
    the consumer receives the window-START state so it can re-expand any
    window exactly later:

        carry = consumer(carry, k0, h_f, alive0, (h0, v0, p0))

    * ``h_f`` — [B, C+1] fine Hermite altitudes at k0..k0+C;
    * ``alive0`` — [B] bool: ray not dead BEFORE the window start. The
      per-segment death prefix of ``march_scan`` is a cumsum per window —
      measured 0.21 s of a 0.67 s scan at 1080p/200 km — and consumers of
      this light scan re-resolve within-window death exactly when they
      re-expand the window, so only the window-level flag is kept.
    * ``(h0, v0, p0)`` — [B] ODE state and path length at the window start.

    ``pass_nodes=True`` switches to the zero-cube contract:

        carry, win_min = consumer(carry, k0, (h0, v0, h1, v1, p0), alive0)

    The consumer gets BOTH window node states and evaluates whatever fine
    samples it needs via ``hermite_plane`` (bitwise the ``h_f`` values), so
    the [B, C+1] cube never materializes in HBM; it must return
    ``win_min`` = the minimum of its fine altitudes at j = 0..C-1 (the
    ``h_f[:, :-1]`` min — exact, min is order-free), from which the scan
    maintains the death flag. In this mode ``elev_rad`` may have ANY shape
    (everything is elementwise): pass it [H, W] so the consumer's plane
    math runs natively 2-D with no [B]↔[H, W] relayouts in the scan body.

    Returns the final consumer carry.
    """
    elev_rad = jnp.asarray(elev_rad, jnp.float32)
    alt = jnp.broadcast_to(jnp.asarray(alt, jnp.float32), elev_rad.shape)
    v0 = initial_slope(alt, elev_rad, shape)
    radius = shape.radius
    coarse = max(1, min(int(coarse), n_steps))
    n_coarse = -(-n_steps // coarse)
    if group <= 0:
        group = _scan_group()
    group = max(1, min(int(group), n_coarse))
    n_outer = -(-n_coarse // group)
    dx = jnp.float32(step * coarse)

    def body(carry, i):
        h, v, p, dead, user = carry
        for g in range(group):
            k0 = (i * group + g) * coarse
            h1, v1, p1 = _rk4_step_quad(h, v, p, dx, table, radius, straight)
            if pass_nodes:
                user, win_min = consumer(user, k0, (h, v, h1, v1, p), ~dead)
            else:
                h_f = hermite_window(h, v, h1, v1, dx, coarse)
                user = consumer(user, k0, h_f, ~dead, (h, v, p))
                win_min = jnp.min(h_f[:, :-1], axis=-1)
            dead = dead | (win_min < jnp.float32(DEATH_ALTITUDE))
            h, v, p = h1, v1, p1
        return (h, v, p, dead, user), None

    carry0 = (
        alt, v0,
        jnp.zeros(alt.shape, jnp.float32),
        jnp.zeros(alt.shape, bool),
        init_carry,
    )
    (_, _, _, _, user), _ = jax.lax.scan(
        body, carry0, jnp.arange(n_outer)
    )
    return user


def march_scan(
    alt: jnp.ndarray,
    elev_rad: jnp.ndarray,
    step: float,
    n_steps: int,
    shape: EarthShape,
    table: Optional[RefractionTable],
    straight: bool,
    consumer,
    init_carry,
    coarse: int = 1,
    with_slope: bool = False,
    group: int = 0,
):
    """Fused fixed-step march: stream Hermite fine-grid windows to a consumer.

    Unlike ``march_rays`` this never materializes the [B, N] dense altitude
    grid (33 GB at 1080p/200 km — the HBM wall of a per-pixel generator).
    Each ``lax.scan`` iteration advances one coarse RK4 step and immediately
    hands the consumer that window's fine samples:

        carry = consumer(carry, k0, h_f, plen_f, alive)

    * ``k0`` — traced int32, global fine index of the window start (multiple
      of ``coarse``);
    * ``h_f`` / ``plen_f`` — [B, C+1] fine altitudes / cumulative path
      lengths at indices k0..k0+C (windows overlap by one sample; dense
      output is the same value+slope cubic Hermite as ``march_rays``, path
      length the same calc_dist cumsum — utils.rs:42-53);
    * ``alive`` — [B, C]: segment j participates iff no sample with global
      index < k0+j fell below DEATH_ALTITUDE (the path-death rule,
      utils.rs:159-171; identical semantics to ops.combine.ray_alive_mask).

    Integrates ceil(n_steps/coarse)·coarse steps — the consumer masks the
    tail (k0 + j >= n_steps). With ``with_slope`` the consumer receives the
    window-start ODE slope as a sixth argument (``consumer(carry, k0, h_f,
    plen_f, alive, v)``) — enough state to re-integrate any window later
    (the culled Rectilinear captures candidate-block states this way).

    ``group`` packs that many coarse windows into ONE scan iteration (the
    consumer still sees per-window calls): a long scan of small fused
    kernels pays per-iteration loop overhead, so grouping cuts the
    sequential iteration count ~G× at ~G× trace size. 0 = auto
    (``GPU_SCAN_GROUP`` on the GPU, 1 elsewhere).

    Returns the final consumer carry.
    """
    elev_rad = jnp.asarray(elev_rad, jnp.float32)
    alt = jnp.broadcast_to(jnp.asarray(alt, jnp.float32), elev_rad.shape)
    v0 = initial_slope(alt, elev_rad, shape)
    radius = shape.radius
    coarse = max(1, min(int(coarse), n_steps))
    n_coarse = -(-n_steps // coarse)
    if group <= 0:
        group = _scan_group()
    group = max(1, min(int(group), n_coarse))
    n_outer = -(-n_coarse // group)

    def body(carry, i):
        h, v, plen, dead, user = carry
        for g in range(group):
            k0 = (i * group + g) * coarse
            h_f, plen_f, h1, v1 = rk4_window(
                h, v, plen, step, coarse, table, straight, radius
            )
            dead_local = h_f[:, :-1] < jnp.float32(DEATH_ALTITUDE)
            pref = jnp.cumsum(dead_local.astype(jnp.int32), axis=-1)
            no_prior = jnp.concatenate(
                [jnp.zeros_like(pref[:, :1]), pref[:, :-1]], axis=-1
            )
            alive = (~dead)[:, None] & (no_prior == 0)
            if with_slope:
                user = consumer(user, k0, h_f, plen_f, alive, v)
            else:
                user = consumer(user, k0, h_f, plen_f, alive)
            dead = dead | (pref[:, -1] > 0)
            h, v, plen = h1, v1, plen_f[:, -1]
        return (h, v, plen, dead, user), None

    carry0 = (
        alt, v0,
        jnp.zeros(alt.shape, jnp.float32),
        jnp.zeros(alt.shape, bool),
        init_carry,
    )
    (_, _, _, _, user), _ = jax.lax.scan(
        body, carry0, jnp.arange(n_outer)
    )
    return user


def initial_slope(
    alt: jnp.ndarray, elev_rad: jnp.ndarray, shape: EarthShape
) -> jnp.ndarray:
    """dh/dx at x=0 for a ray launched at ``elev_rad`` above local horizontal."""
    t = jnp.tan(elev_rad)
    if shape.is_flat:
        return t
    return (1.0 + alt / shape.radius) * t


def _straight_dense(
    alt: jnp.ndarray,  # [B]
    elev_rad: jnp.ndarray,  # [B]
    step: float,
    n_steps: int,
    shape: EarthShape,
) -> jnp.ndarray:
    """Closed-form straight-ray altitudes [N+1, B] — no integration at all.

    Flat: h = h0 + tan(e)·x. Sphere: the chord's polar equation gives
    r(φ) = (R+h0)·cos(e)/cos(e+φ) with φ = x/R (x = surface arc length);
    past e+φ = 90° the chord recedes to infinity — clamped to a huge
    altitude so crossing detection sees open sky.
    """
    x = jnp.arange(n_steps + 1, dtype=jnp.float32)[:, None] * jnp.float32(step)
    if shape.is_flat:
        return alt[None, :] + jnp.tan(elev_rad)[None, :] * x
    r = jnp.float32(shape.radius)
    phi = x / r
    c = jnp.cos(elev_rad + phi)  # [N+1, B]
    # cancellation-free form of r0·cos(e)/cos(e+φ) − R in f32:
    #   h = h0 + r0·(cos e − cos(e+φ))/cos(e+φ),
    #   cos e − cos(e+φ) = 2·sin(e+φ/2)·sin(φ/2)
    # keeps every factor O(h−h0) instead of O(R) (f32 eps at R is ~0.5 m)
    num = 2.0 * jnp.sin(elev_rad + 0.5 * phi) * jnp.sin(0.5 * phi)
    h = alt[None, :] + (r + alt)[None, :] * num / jnp.where(c <= 1e-9, 1.0, c)
    return jnp.where(c <= 1e-9, jnp.float32(1e9), h)


def march_rays(
    alt: jnp.ndarray,
    elev_rad: jnp.ndarray,
    step: float,
    n_steps: int,
    shape: EarthShape,
    table: Optional[RefractionTable],
    straight: bool,
    with_path_length: bool = True,
    coarse: int = 1,
    progress: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """March a batch of rays N fixed steps; returns (h, path_length).

    ``progress=True`` emits per-percent lines from the scan body via
    ``generators.base.scan_progress_emit`` (callback-capable backends only —
    callers gate on ``callbacks_supported()``).

    Args:
      alt: scalar or [B] starting altitude(s), meters.
      elev_rad: [B] launch elevation angles (radians above local horizontal).
      step: x-advance per iteration, meters (``simulation_step``).
      n_steps: number of steps N; outputs have N+1 samples (k=0 included).
      shape: flat or spherical Earth.
      table: refraction table (ignored when ``straight``).
      straight: bypass refraction (``--straight``, README.md:216-218).
      coarse: sequential-depth reduction factor. 1 = classic fixed-step RK4
        (the reference's stepper semantics). C > 1 integrates RK4 at C·step
        and fills the fine grid by cubic Hermite dense output — the scan
        carries (h, h') so the interpolant matches value AND slope at every
        node; the ODE solution is polynomial-smooth between atmosphere-layer
        kinks, so the fine-grid error is far below the integrator's own
        tolerance (validated in tests/test_ray.py::test_coarse_march_parity).
        Cuts the sequential chain N → N/C.

    Returns:
      h:        [B, N+1] ray altitude at x = k*step.
      path_len: [B, N+1] cumulative path length (reference utils.rs:42-53
                semantics), or zeros if with_path_length=False.

    Mirrors gen_path_cache (src/generator/generators/utils.rs:136-174) minus
    the early-exit (dense lockstep marching; callers mask instead).
    """
    elev_rad = jnp.asarray(elev_rad, jnp.float32)
    alt = jnp.broadcast_to(jnp.asarray(alt, jnp.float32), elev_rad.shape)
    v0 = initial_slope(alt, elev_rad, shape)
    radius = shape.radius
    coarse = max(1, min(int(coarse), n_steps))
    n_coarse = -(-n_steps // coarse)
    dx = jnp.float32(step * coarse)

    bend = table is not None and not straight
    if not bend:
        # straight rays have closed forms — no integration, no scan
        h_fine = _straight_dense(alt, elev_rad, step, n_steps, shape)
        return _finish_march(h_fine, step, radius, with_path_length)

    stride = max(1, n_coarse // 32)

    def body(carry, i):
        h, v = carry
        h_new, v_new = _rk4_step(h, v, dx, table, radius, straight)
        if progress:
            from ..generators.base import scan_progress_emit

            scan_progress_emit(i, n_coarse, stride)
        return (h_new, v_new), (h_new, v_new)

    # the per-iteration state is a few [B] vectors, so loop overhead
    # matters; the GPU unrolls by GPU_MARCH_UNROLL.
    # xs stays None when progress is off so the HLO — and the persistent
    # compile cache entry — is identical to a march without the hook.
    xs = jnp.arange(n_coarse, dtype=jnp.int32) if progress else None
    unroll = (min(GPU_MARCH_UNROLL, n_coarse)
              if jax.default_backend() == "gpu" else 1)
    with jax.named_scope("march"):
        (_, _), (hs, vs) = jax.lax.scan(
            body, (alt, v0), xs, length=None if progress else n_coarse,
            unroll=unroll,
        )
    h_nodes = jnp.concatenate([alt[None], hs], axis=0)  # [Nc+1, B]
    v_nodes = jnp.concatenate([v0[None], vs], axis=0)

    if coarse == 1:
        h_fine = h_nodes[: n_steps + 1]  # [N+1, B]
    else:
        # cubic Hermite dense output per coarse segment: t in [0, 1)
        t = jnp.arange(coarse, dtype=jnp.float32)[:, None, None] / jnp.float32(
            coarse
        )  # [C, 1, 1]
        t2 = t * t
        t3 = t2 * t
        h00 = 2.0 * t3 - 3.0 * t2 + 1.0
        h10 = t3 - 2.0 * t2 + t
        h01 = -2.0 * t3 + 3.0 * t2
        h11 = t3 - t2
        hl = h_nodes[:-1][None]  # [1, Nc, B]
        hr = h_nodes[1:][None]
        vl = v_nodes[:-1][None] * dx
        vr = v_nodes[1:][None] * dx
        seg = h00 * hl + h10 * vl + h01 * hr + h11 * vr  # [C, Nc, B]
        h_fine = jnp.concatenate(
            [seg.transpose(1, 0, 2).reshape(-1, seg.shape[2]), h_nodes[-1:]],
            axis=0,
        )[: n_steps + 1]  # [N+1, B]

    return _finish_march(h_fine, step, radius, with_path_length)


def _finish_march(h_fine, step, radius, with_path_length):
    """[N+1, B] fine altitudes → ([B, N+1] h, [B, N+1] path length)."""
    h_out = jnp.moveaxis(h_fine, 0, 1)  # [B, N+1]
    if not with_path_length:
        return h_out, jnp.zeros_like(h_out)
    # cumulative path length over the FINE grid — same per-step formula as
    # the reference's calc_dist (utils.rs:42-53), now a vectorized cumsum
    dxf = jnp.float32(step)
    dh = h_out[..., 1:] - h_out[..., :-1]
    if radius is None:
        seg_len = jnp.sqrt(dxf * dxf + dh * dh)
    else:
        dx_eff = dxf * ((h_out[..., 1:] + h_out[..., :-1]) * 0.5 + radius) / radius
        seg_len = jnp.sqrt(dx_eff * dx_eff + dh * dh)
    p_out = jnp.concatenate(
        [jnp.zeros(h_out.shape[:-1] + (1,), jnp.float32),
         jnp.cumsum(seg_len, axis=-1)],
        axis=-1,
    )
    return h_out, p_out
