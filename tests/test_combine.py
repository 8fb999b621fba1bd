"""Crossing-detection combine: XLA semantics against a brute-force loop."""

import numpy as np
import pytest
import jax.numpy as jnp

from atm_raytracer_tpu.ops import combine


def brute_force_keys(ray_h, terr, n_seg, max_hits):
    """Direct transcription of get_single_pixel's crossing loop
    (utils.rs:211-240) including the h<-1000 path truncation."""
    h_n, w_n = ray_h.shape[0], terr.shape[0]
    out = np.full((h_n, w_n, max_hits), np.inf, np.float32)
    for hi in range(h_n):
        # path truncation: segments stop after the first dead sample
        dead = np.where(ray_h[hi] < -1000.0)[0]
        last_seg = n_seg if len(dead) == 0 else min(int(dead[0]), n_seg - 1)
        for wi in range(w_n):
            found = []
            for k in range(last_seg + 1 if len(dead) else n_seg):
                if k >= n_seg:
                    break
                d1 = ray_h[hi, k] - terr[wi, k]
                d2 = ray_h[hi, k + 1] - terr[wi, k + 1]
                if d1 * d2 < 0.0:
                    found.append(k + d1 / (d1 - d2))
                    if len(found) == max_hits:
                        break
            out[hi, wi, : len(found)] = found
    return out


@pytest.fixture(scope="module")
def fan():
    rng = np.random.RandomState(42)
    h_n, w_n, n = 6, 7, 50
    # rays: descending-ish lines + noise; terrain: rolling hills
    elev0 = 120.0
    slopes = np.linspace(-3.0, 1.0, h_n)
    ray = elev0 + slopes[:, None] * np.arange(n + 1)[None, :]
    terr = 100.0 + 30.0 * np.sin(np.arange(n + 1) / 5.0)[None, :] + rng.uniform(
        -5, 5, (w_n, n + 1)
    )
    return ray.astype(np.float32), terr.astype(np.float32), n


def test_xla_first_crossing_matches_brute_force(fan):
    ray, terr, n = fan
    keys = np.asarray(combine.terrain_crossing_keys(ray, terr, n, 1, chunk=16))
    expect = brute_force_keys(ray, terr, n, 1)
    np.testing.assert_allclose(keys, expect, rtol=1e-5, atol=1e-5)


def test_xla_multi_hit_matches_brute_force(fan):
    ray, terr, n = fan
    keys = np.asarray(combine.terrain_crossing_keys(ray, terr, n, 3, chunk=16))
    expect = brute_force_keys(ray, terr, n, 3)
    np.testing.assert_allclose(keys, expect, rtol=1e-5, atol=1e-5)


def test_path_death_truncates(fan):
    # a ray that dives below -1000 stops producing crossings afterward
    n = 50
    ray = np.full((1, n + 1), 10.0, np.float32)
    ray[0, 10:] = -2000.0  # dead from sample 10
    ray[0, 20:] = 50.0  # resurfaces — must NOT count (reference stopped)
    terr = np.zeros((1, n + 1), np.float32)
    keys = np.asarray(combine.terrain_crossing_keys(ray, terr, n, 2, chunk=16))
    # exactly one crossing: the dive at segment 9
    assert np.isfinite(keys[0, 0, 0])
    assert 9.0 <= keys[0, 0, 0] < 10.0
    assert not np.isfinite(keys[0, 0, 1])


def test_gathers_lerp(fan):
    ray, terr, n = fan
    keys = combine.terrain_crossing_keys(ray, terr, n, 1, chunk=16)
    safe = jnp.where(jnp.isfinite(keys), keys, 0.0)
    te = np.asarray(combine.gather_column_field(jnp.asarray(terr), safe))
    re = np.asarray(combine.gather_ray_field(jnp.asarray(ray), safe))
    valid = np.isfinite(np.asarray(keys))
    # at a terrain crossing the lerped ray and terrain elevations agree
    np.testing.assert_allclose(te[valid], re[valid], atol=1e-3)


def test_k_smallest_matches_sort():
    import jax.numpy as jnp
    from atm_raytracer_tpu.ops.combine import NO_HIT_SEG, k_smallest

    rng = np.random.default_rng(3)
    # unique candidate ids + sentinel duplicates, like a combine chunk
    cand = rng.permutation(np.arange(64))[None].repeat(5, 0).astype(np.int32)
    cand[cand % 3 == 0] = NO_HIT_SEG
    for k in (1, 2, 3, 4):
        got = np.asarray(k_smallest(jnp.asarray(cand), k))
        want = np.sort(cand, axis=-1)[:, :k]
        np.testing.assert_array_equal(got, want)


def test_merge_sorted_k_matches_sort():
    import jax.numpy as jnp
    from atm_raytracer_tpu.ops.combine import NO_HIT, merge_sorted_k

    rng = np.random.default_rng(4)
    for k in (1, 2, 3, 4):
        a = np.sort(rng.uniform(0, 100, (7, k)), -1).astype(np.float32)
        b = np.sort(rng.uniform(0, 100, (7, k)), -1).astype(np.float32)
        a[0, -1:] = NO_HIT  # sentinel tails
        b[1] = NO_HIT
        got = np.asarray(merge_sorted_k(jnp.asarray(a), jnp.asarray(b), k))
        want = np.sort(np.concatenate([a, b], -1), -1)[:, :k]
        np.testing.assert_array_equal(got, want)
