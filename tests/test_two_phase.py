"""Soundness of the two-phase interval classifier (ops/two_phase.py).

The classifier must be conservative against EXACT arithmetic on the
fp32 feature inputs (float64 ground truth here): reduced-precision
matmuls plus the documented error margins may never reject a truly
accepted candidate, never certify a truly rejected one, and certain
candidates' t intervals must bracket the exact t. ray_verdict's
non-ambiguous winners must equal the exact strict-closest winner.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raycore.accel.dense import ray_features, _featurize_tris
from raycore.ops import two_phase
from raycore.ops.two_phase import EDGE_EPS, classify, ray_verdict

FEAT = 16


def _features(rng, n_rays, n_tris, near_edge=False):
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    o[:, 2] = 3.0
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    if near_edge:
        # Triangles whose edges pass very close to ray hit points:
        # build them THROUGH the ray's t~2.5 point with tiny offsets.
        hit = o[rng.integers(0, n_rays, n_tris)] \
            + 2.5 * d[rng.integers(0, n_rays, n_tris)]
        v0 = (hit + rng.normal(scale=1e-4, size=(n_tris, 3))).astype(
            np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    v1, v2 = v0 + e1, v0 + e2
    phi = np.asarray(ray_features(jnp.asarray(o), jnp.asarray(d)))
    psi = np.asarray(_featurize_tris(jnp.asarray(v0), jnp.asarray(v1),
                                     jnp.asarray(v2)))   # (T, 16, 4)
    # cluster layout: [det xC | udet xC | vdet xC | tdet xC]
    feats = psi.transpose(1, 2, 0).reshape(FEAT, 4 * n_tris)
    return phi, feats


def _simulate(phi, feats, mode):
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    mm = lambda a, b: np.asarray(
        jnp.einsum("rf,fc->rc", a, b, preferred_element_type=jnp.float32))
    if mode == "bf16":
        q = mm(bf(phi), bf(feats))
        eps = two_phase.EPS_BF16
    else:
        ah, bh = bf(phi), bf(feats)
        al = bf(jnp.asarray(phi) - ah)
        bl = bf(jnp.asarray(feats) - bh)
        q = mm(ah, bh) + mm(ah, bl) + mm(al, bh)
        eps = two_phase.EPS_BF16X3
    s = mm(bf(np.abs(phi)), bf(np.abs(feats)))
    return q, s, eps


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["bf16", "bf16x3"])
@pytest.mark.parametrize("near_edge", [False, True])
def test_classify_sound(rng, mode, near_edge):
    R, C = 256, 64
    phi, feats = _features(rng, R, C, near_edge)
    t_min = np.zeros((R, 1), np.float32)
    t_max = np.full((R, 1), np.inf, np.float32)

    # float64 ground truth on the same fp32 inputs.
    q64 = phi.astype(np.float64) @ feats.astype(np.float64)
    det = q64[:, 0 * C:1 * C]
    u = q64[:, 1 * C:2 * C] / det
    v = q64[:, 2 * C:3 * C] / det
    t = q64[:, 3 * C:4 * C] / det
    e = EDGE_EPS
    acc = ((u >= -e) & (u <= 1 + e) & (v >= -e) & (u + v <= 1 + e)
           & (t >= t_min) & (t <= t_max) & (det != 0.0))

    q, s, eps = _simulate(phi, feats, mode)
    certain, possible, t_lo, t_hi = (
        np.asarray(x) for x in classify(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(t_min),
            jnp.asarray(t_max), C, eps=eps))

    # 1. No truly-accepted candidate may be rejected.
    assert not np.any(acc & ~possible), "sound rejection violated"
    # 2. Every certain candidate is truly accepted.
    assert not np.any(certain & ~acc), "unsound certainty"
    # 3. Certain t intervals bracket the exact t.
    ct = certain & acc
    assert np.all(t_lo[ct] <= t[ct] + 1e-12)
    assert np.all(t_hi[ct] >= t[ct] - 1e-12)
    # Sanity: on well-separated geometry most candidates must decide.
    if not near_edge:
        decided = (~possible) | certain
        assert decided.mean() > (0.2 if mode == "bf16" else 0.9)


@pytest.mark.parametrize("mode", ["bf16x3"])
def test_ray_verdict_matches_exact_winner(rng, mode):
    R, C = 512, 96
    phi, feats = _features(rng, R, C)
    t_min = np.zeros((R, 1), np.float32)
    t_max = np.full((R, 1), np.inf, np.float32)
    q64 = phi.astype(np.float64) @ feats.astype(np.float64)
    det = q64[:, 0 * C:1 * C]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = q64[:, 1 * C:2 * C] / det
        v = q64[:, 2 * C:3 * C] / det
        t = q64[:, 3 * C:4 * C] / det
    e = EDGE_EPS
    acc = ((u >= -e) & (u <= 1 + e) & (v >= -e) & (u + v <= 1 + e)
           & (t >= t_min) & (t <= t_max) & (det != 0.0))
    t_acc = np.where(acc, t, np.inf)
    exact_best = np.argmin(t_acc, axis=1)
    exact_hit = np.isfinite(t_acc[np.arange(R), exact_best])

    q, s, eps = _simulate(phi, feats, mode)
    certain, possible, t_lo, t_hi = classify(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(t_min),
        jnp.asarray(t_max), C, eps=eps)
    ids = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (R, C))
    ub, winner, amb = (np.asarray(x) for x in ray_verdict(
        certain, possible, t_lo, t_hi, ids))

    ok = ~amb
    # Non-ambiguous rays: winner identity equals the exact winner
    # (or both agree it's a miss).
    w = ok & exact_hit
    assert np.array_equal(winner[w], exact_best[w])
    assert not np.any(ok & ~exact_hit & (winner >= 0))
    # The verdict must decide a healthy majority on random geometry.
    assert ok.mean() > 0.9
