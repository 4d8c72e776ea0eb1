"""Two-phase precision sweep: interval classification for the bf16 pass.

VERDICT r3 task 2: replace the 6-pass fp32-exact (HIGHEST) candidate
matmul with a 1-pass bf16 (DEFAULT) matmul plus per-candidate error
intervals, re-evaluating exactly only the candidates that the intervals
cannot decide. This module is the PURE-JAX implementation of the
interval logic; no engine uses it yet (the sweep kernels run exact fp32
FMAs), and tests/test_two_phase.py checks its margins.

## Margin argument (strict-closest preservation)

The engines' exact semantics is the FEATURIZED Möller–Trumbore with a
fp32-exact matmul (HIGHEST, 6-pass) and EDGE_EPS acceptance slack,
followed by an exact scalar recomputation of the winner
(accel/dense.py::finalize_hits_exact). "Strict closest" means: the
(prim, instance) identity selected must equal the identity the HIGHEST
sweep selects. The bf16 pass preserves this by proving, per candidate,
either CERTAIN (accepted, with a t interval), REJECTED (provably fails
an acceptance test), or POSSIBLE (undecidable); a ray's winner identity
is certain iff its best CERTAIN candidate's t upper bound beats every
other candidate's t lower bound. All other rays are re-evaluated with
the exact HIGHEST pipeline, so no approximation ever reaches a result.

Error bound: the kernel computes Q' = phi @ F with DEFAULT precision —
each fp32 operand is rounded to bf16 (relative error <= 2^-9 per
operand under round-to-nearest; <= 2^-8 under truncation),
products accumulate in fp32 (<= 13 ulp_32 per output over the 13
nonzero feature terms). For output column j,

    |Q'[i,j] - Q[i,j]| <= S[i,j] * EPS_BF16,
    S[i,j] = sum_k |phi[i,k]| * |F[k,j]|   (the magnitude-sum matmul),

with EPS_BF16 = 2^-7 covering: two-sided bf16 input rounding under
either rounding mode (2*2^-8 + 2^-16), fp32 accumulation (13*2^-23
relative to S), the bf16 error of computing S itself the same way
(S' >= S * (1 - 2^-7.6), folded in), and the HIGHEST pass's own
deviation from exact fp32 (< 2^-20 relative to S). 2^-7 = 0.78% of the
magnitude sum is a ~2x safety factor over the worst-case sum of those
terms (~0.42%).

Interval tests: with D = det' +/- E_det, U = udet' +/- E_u, etc., each
acceptance condition (u >= -e, u <= 1+e, v >= -e, u+v <= 1+e,
t in [tmin, tmax], all multiplied through by |det| with sign sigma) is
evaluated at interval endpoints, treating the coupled quantities as
independent — a superset of the true joint range, hence conservative in
both directions: "certainly true" and "certainly false" verdicts are
sound, everything else is POSSIBLE. A candidate whose det interval
contains 0 is always POSSIBLE (sign unknown).

Reference hot-loop semantics being preserved:
fast_intersect_triangle, /root/reference/src/instanced-bvh.jl:1756-1797.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

EPS_BF16 = 2.0 ** -7       # 1-pass bf16 (DEFAULT): see margin argument
# 3-pass split-operand scheme: a = bf16(a) + bf16(a - bf16(a)) keeps ~16
# mantissa bits per operand; the three bf16 passes a_h@b_h + a_h@b_l +
# a_l@b_h drop only a_l@b_l (<= 2^-18 |a||b|) and the representation
# tails (<= 2^-16.4 |a||b|), plus f32 accumulation — 2^-14 is a ~2.5x
# safety factor over the worst-case sum.
EPS_BF16X3 = 2.0 ** -14
EDGE_EPS = 1e-5            # featurized acceptance slack (pallas_dense)


def classify(q, s, t_min, t_max, C: int, edge_eps: float = EDGE_EPS,
             eps: float = EPS_BF16):
    """Classify candidates from the bf16 matmul outputs.

    Args:
      q: (..., 4*C) approximate [det | udet | vdet | tdet] blocks.
      s: (..., 4*C) magnitude sums (|phi| @ |F|), same layout.
      t_min, t_max: (..., 1) per-ray range.
      C: candidates per block.

    Returns (certain, possible, t_lo, t_hi):
      certain: (..., C) bool — provably accepted; [t_lo, t_hi] brackets
        its exact t.
      possible: (..., C) bool — not provably rejected (includes certain).
      t_lo, t_hi: (..., C) f32 — conservative t interval; for
        non-certain possibles t_lo still lower-bounds any true hit t
        (−inf when the det sign is unknown).
    """
    det = q[..., 0 * C:1 * C]
    udet = q[..., 1 * C:2 * C]
    vdet = q[..., 2 * C:3 * C]
    tdet = q[..., 3 * C:4 * C]
    E_d = s[..., 0 * C:1 * C] * eps
    E_u = s[..., 1 * C:2 * C] * eps
    E_v = s[..., 2 * C:3 * C] * eps
    E_t = s[..., 3 * C:4 * C] * eps

    s_ok = jnp.abs(det) > E_d
    sig = jnp.sign(det)
    a = jnp.maximum(jnp.abs(det) - E_d, 0.0)      # |det| lower bound
    b = jnp.abs(det) + E_d                        # |det| upper bound

    e = edge_eps

    def cond(x_mid, E_x, lo_coef, hi_coef=None):
        """sigma*xdet >= lo_coef*|det| certainty; hi_coef for <= tests."""
        x1 = sig * x_mid - E_x
        x2 = sig * x_mid + E_x
        if hi_coef is None:
            # x >= lo_coef * |det|, lo_coef scalar or (...,1) array
            lo_hi = jnp.maximum(lo_coef * a, lo_coef * b)
            lo_lo = jnp.minimum(lo_coef * a, lo_coef * b)
            return x1 >= lo_hi, x2 < lo_lo        # (true_c, false_c)
        hi_hi = jnp.maximum(hi_coef * a, hi_coef * b)
        hi_lo = jnp.minimum(hi_coef * a, hi_coef * b)
        return x2 <= hi_lo, x1 > hi_hi

    c1t, c1f = cond(udet, E_u, -e)                     # u >= -e
    c2t, c2f = cond(udet, E_u, None, 1.0 + e)          # u <= 1+e
    c3t, c3f = cond(vdet, E_v, -e)                     # v >= -e
    c4t, c4f = cond(udet + vdet, E_u + E_v, None, 1.0 + e)  # u+v <= 1+e
    c5t, c5f = cond(tdet, E_t, t_min)                  # t >= tmin
    c6t, c6f = cond(tdet, E_t, None, t_max)            # t <= tmax

    certain = s_ok & c1t & c2t & c3t & c4t & c5t & c6t
    rejected = s_ok & (c1f | c2f | c3f | c4f | c5f | c6f)
    possible = ~rejected

    # t = (sigma*tdet) / |det| interval by endpoint division.
    y1 = sig * tdet - E_t
    y2 = sig * tdet + E_t
    t_lo = jnp.where(y1 >= 0.0, y1 / b, y1 / a)
    t_hi = jnp.where(y2 <= 0.0, y2 / b, y2 / a)
    t_lo = jnp.where(s_ok, t_lo, -jnp.inf)
    t_hi = jnp.where(s_ok, t_hi, jnp.inf)
    # a == 0 with y >= 0: y/a = inf/nan — force the conservative value.
    t_lo = jnp.where(jnp.isnan(t_lo), -jnp.inf, t_lo)
    t_hi = jnp.where(jnp.isnan(t_hi), jnp.inf, t_hi)
    return certain, possible, t_lo, t_hi


@partial(jax.jit, static_argnames=("C",))
def classify_block(phi, feats, t_min, t_max, C: int):
    """Reference path: bf16 (DEFAULT) matmuls + classify, for a
    (R, FEAT) ray block against one (FEAT, 4*C) feature block. The
    Pallas kernel computes exactly this per block row."""
    q = jax.lax.dot_general(phi, feats, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.DEFAULT)
    s = jax.lax.dot_general(jnp.abs(phi), jnp.abs(feats),
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.DEFAULT)
    return classify(q, s, t_min[:, None], t_max[:, None], C)


def ray_verdict(certain, possible, t_lo, t_hi, key_pair):
    """Per-ray ambiguity from per-candidate classifications.

    Args (all (R, N) over a ray's N candidates, any layout):
      key_pair: int32 candidate ids (for winner identity).
    Returns (ub, winner, ambiguous):
      ub: (R,) best certain t upper bound (+inf if no certain hit).
      winner: (R,) candidate id of the best certain hit (-1 none).
      ambiguous: (R,) bool — exact re-evaluation required: some OTHER
        candidate's t_lo (possible or certain) undercuts ub, or a
        possible candidate exists while no certain one does.
    """
    hi = jnp.where(certain, t_hi, jnp.inf)
    ub = jnp.min(hi, axis=-1)
    win_slot = jnp.argmin(hi, axis=-1)
    has_certain = jnp.isfinite(ub)
    winner = jnp.where(
        has_certain,
        jnp.take_along_axis(key_pair, win_slot[..., None], -1)[..., 0], -1)
    lo = jnp.where(possible, jnp.maximum(t_lo, 0.0), jnp.inf)
    # Exclude the winner slot itself from the threat scan.
    slots = jnp.arange(key_pair.shape[-1])
    lo_excl = jnp.where(
        has_certain[..., None] & (slots == win_slot[..., None]), jnp.inf, lo)
    threat = jnp.min(lo_excl, axis=-1)
    ambiguous = jnp.where(has_certain, threat < ub, jnp.isfinite(threat))
    return ub, winner, ambiguous
