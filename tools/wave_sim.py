"""W-wave prune simulation — sizing input for generalizing the regroup
engine's passes=2 pruning to k-nearest-first waves (round-4 architecture
decision, VERDICT r3 "Next round" #2b).

Simulates EXACTLY the engine's subgroup-granularity wave machine at the
current operating point (G rays share a candidate list at cluster
granularity cs): wave i sweeps each subgroup's i-th nearest candidate
cluster (by conservative slab entry, min over the subgroup's rays — the
same bound `refine_pairs` computes), all G rays test all cs triangles of
that cluster with the featurized Möller–Trumbore arithmetic, then the
remaining candidates are pruned against ub = max over the subgroup's
rays of best-t (the same conservative bound `_stage1_pruned` uses).

Reported cost per ray = cs * (waves_done + survivors(W)) triangles —
what a W-wave engine sweeps — vs the unordered count (the passes=1
engine) and the per-subgroup ordered floor.
Decides how many waves are worth building.

Usage: JAX_PLATFORMS=cpu python tools/wave_sim.py [scene] [n_tris] [n_sample]
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = os.environ.get("RAYCORE_STATS_PLATFORM", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raycore as rc
from raycore.accel.dense import build_dense, ray_features, FEAT
from candidate_stats import zorder_rays
from ray1_census import entry_vs_bounds, exact_t_hit

EDGE_EPS = 1e-5
WAVES = (1, 2, 3, 4, 6, 8)


@jax.jit
def _subgroup_wave(Eg, best, phi, feats, t_min):
    """One wave: each subgroup tests its nearest untested cluster with
    all G rays. Eg (S, K) subgroup entry bounds; best (S*G,) per-ray.
    Returns (Eg with swept cluster marked inf, best, did (S,) bool)."""
    S, K = Eg.shape
    G = best.shape[0] // S
    cid = jnp.argmin(Eg, axis=1)                       # (S,)
    e_sel = jnp.take_along_axis(Eg, cid[:, None], axis=1)[:, 0]
    blocks = jnp.take(feats, cid, axis=0)              # (S, FEAT, 4C)
    phi_s = phi.reshape(S, G, FEAT)
    q = jnp.einsum("sgf,sfq->sgq", phi_s, blocks)      # (S, G, 4C)
    C = q.shape[2] // 4
    qs = q.reshape(S, G, 4, C)
    det, udet, vdet, tdet = (qs[:, :, 0], qs[:, :, 1], qs[:, :, 2],
                             qs[:, :, 3])
    r = 1.0 / det
    u, v, t = udet * r, vdet * r, tdet * r
    e = EDGE_EPS
    tm = t_min.reshape(S, G)
    ok = (u >= -e) & (u <= 1 + e) & (v >= -e) & (u + v <= 1 + e) \
        & (t >= tm[:, :, None]) & (t <= best.reshape(S, G)[:, :, None])
    tc = jnp.min(jnp.where(ok, t, jnp.inf), axis=2).reshape(-1)  # (S*G,)
    did = jnp.isfinite(e_sel)                          # subgroup had one
    didr = jnp.repeat(did, G)
    best = jnp.where(didr & (tc < best), tc, best)
    Eg = Eg.at[jnp.arange(S), cid].set(jnp.inf)
    return Eg, best, did


def main():
    scene_kind = sys.argv[1] if len(sys.argv) > 1 else "blobby"
    n_tris = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    n_sample = int(sys.argv[3]) if len(sys.argv) > 3 else 65_536
    G = int(os.environ.get("WAVE_SIM_G", "32"))
    nt = int(np.sqrt(n_tris / 2))
    if scene_kind == "blobby":
        mesh = rc.blobby_mesh(n_theta=nt, n_phi=nt)
    else:
        mesh = rc.displaced_grid_mesh(n=nt, extent=2.0, amplitude=0.35)
    print(f"scene={scene_kind} tris={mesh.vertices.shape[0]} "
          f"sample={n_sample} G={G}", flush=True)
    t0 = time.time()
    scene = build_dense(mesh, cluster_size=128, sub_chunks=4)
    jax.block_until_ready(scene.tri_feats)
    cs = scene.cluster_size
    K = scene.n_clusters
    print(f"build {time.time() - t0:.1f}s K={K}", flush=True)

    SUB = scene.sub_chunks
    feats = scene.tri_feats.reshape(-1, FEAT, SUB, 4, cs // SUB) \
        .transpose(0, 1, 3, 2, 4).reshape(-1, FEAT, 4 * cs)

    o_all, d_all = zorder_rays(1_048_576)
    R = o_all.shape[0]
    CHUNK = 2048
    n_chunks = n_sample // CHUNK
    stride = R // (CHUNK * n_chunks) * CHUNK

    # acc[W] = [sum waves_done (subgroup-clusters), sum survivors]
    acc = {W: [0, 0] for W in WAVES}
    unord = ordered = 0
    n_done = 0
    n_sub_done = 0
    for ci in range(n_chunks):
        lo = ci * stride
        o = o_all[lo:lo + CHUNK]
        d = d_all[lo:lo + CHUNK]
        S = CHUNK // G
        E = entry_vs_bounds(o, d, scene.cluster_min, scene.cluster_max)
        t_hit = exact_t_hit(scene, o, d, E)
        Eg = E.reshape(S, G, K).min(axis=1)             # (S, K)
        unord += int(jnp.sum(jnp.isfinite(Eg)))
        th = t_hit.reshape(S, G).max(axis=1)
        ordered += int(jnp.sum(jnp.isfinite(Eg) & (Eg <= th[:, None])))

        phi = ray_features(o, d)
        t_min = jnp.zeros((CHUNK,))
        best = jnp.full((CHUNK,), jnp.inf)
        Ew = Eg
        waves_done = jnp.zeros((S,), jnp.int32)
        for w in range(1, max(WAVES) + 1):
            Ew, best, did = _subgroup_wave(Ew, best, phi, t_min=t_min,
                                           feats=feats)
            waves_done = waves_done + did.astype(jnp.int32)
            if w in acc:
                ub = best.reshape(S, G).max(axis=1)
                surv = jnp.sum(jnp.isfinite(Ew) & (Ew <= ub[:, None]))
                acc[w][0] += int(jnp.sum(waves_done))
                acc[w][1] += int(surv)
        n_done += CHUNK
        n_sub_done += S
        if ci % 8 == 7:
            print(f"  chunk {ci + 1}/{n_chunks} ({time.time() - t0:.0f}s)",
                  flush=True)

    per_ray = lambda clusters: clusters * cs / n_sub_done
    print(f"\nG={G} cs={cs}  tris/ray: unordered={per_ray(unord):.0f} "
          f"(passes=1 engine)  ordered-floor={per_ray(ordered):.0f}")
    print(f"{'W':>3} {'waves':>7} {'surv':>7} {'total tris/ray':>14} "
          f"{'vs passes=1':>11}")
    for W in WAVES:
        wv, sv = acc[W]
        tot = per_ray(wv + sv)
        print(f"{W:3d} {per_ray(wv):7.0f} {per_ray(sv):7.0f} "
              f"{tot:14.0f} {per_ray(unord) / max(tot, 1e-9):10.2f}x")
    print("\ntotal = cs x (waves swept + survivors after prune): the "
          "candidate volume a W-wave engine sweeps. Each wave also costs "
          "a dispatch + grouping round.")


if __name__ == "__main__":
    main()
