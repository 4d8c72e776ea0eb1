"""Analysis layer, collision, renderer, and MultiTypeSet tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.scene.tlas import TLAS
from raycore.analysis import kernels as ak
from raycore.analysis.collision import collide_instances, collide_instances_any
from raycore.collections import multitypeset as mts
from raycore.render.wavefront import WavefrontRenderer, RenderConfig
from raycore.render.scenes import example_scene


def sphere_scene(radius=1.0):
    mgr = TLAS()
    h = mgr.push(rc.sphere_mesh(radius=radius, n_theta=16, n_phi=32), None)
    return mgr, h


# ---------------------------------------------------------------------------
# Ray grid / centroid / illumination
# ---------------------------------------------------------------------------

def test_generate_ray_grid_covers_scene():
    mgr, _ = sphere_scene()
    scene = mgr.sync()
    origins = np.asarray(ak.generate_ray_grid(scene, jnp.array([0.0, 0, -1.0]), 16))
    assert origins.shape == (16, 16, 3)
    # Grid plane is behind the scene along the view direction (-z => above).
    assert origins[..., 2].min() > 1.0


def test_hits_from_grid_and_centroid():
    mgr, _ = sphere_scene()
    scene = mgr.sync()
    hits, centroid = ak.get_centroid(scene, jnp.array([0.0, 0, -1.0]),
                                     grid_size=32, tile_size=1024)
    h = np.asarray(hits.hit)
    assert 0.3 < h.mean() < 0.85   # disk fraction of padded grid
    c = np.asarray(centroid)
    # Visible cap centroid: x,y ~ 0, z > 0 (viewed from +z).
    assert abs(c[0]) < 0.1 and abs(c[1]) < 0.1 and c[2] > 0.3


def test_illumination_counts():
    mgr, _ = sphere_scene()
    scene = mgr.sync()
    n_bins = int(scene.prims.metadata.shape[0])
    illum = np.asarray(ak.get_illumination(
        scene, jnp.array([0.0, 0, -1.0]), grid_size=64, n_bins=n_bins,
        tile_size=1024))
    assert illum.sum() > 0
    # Rays come from +z: lit triangles are predominantly upward-facing
    # (grazing silhouette hits allow slight negatives).
    v = np.asarray(scene.prims.vertices)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(nrm, axis=-1)
    nz = nrm[:, 2] / np.where(ln > 0, ln, 1.0)
    meta = np.asarray(scene.prims.metadata)
    lit_tris = np.isin(meta.astype(np.int64), np.nonzero(illum > 0)[0]) & (ln > 0)
    assert nz[lit_tris].mean() > 0.2
    # Total counts equal total hits in the grid.
    hits = ak.hits_from_grid(scene, jnp.array([0.0, 0, -1.0]), grid_size=64,
                             tile_size=1024)
    assert illum.sum() == pytest.approx(float(np.asarray(hits.hit).sum()))


def test_view_factors_symmetry_tendency():
    # Two parallel unit quads facing each other.
    mgr = TLAS()
    a = rc.plane_mesh(center=(0, 0, 0), u=(1, 0, 0), v=(0, 1, 0))
    b = rc.plane_mesh(center=(0, 0, 1.0), u=(1, 0, 0), v=(0, 1, 0))
    a = a.replace(metadata=jnp.asarray([0, 1], jnp.uint32))
    b = b.replace(metadata=jnp.asarray([2, 3], jnp.uint32))
    mgr.push(a, None)
    mgr.push(b, None)
    scene = mgr.sync()
    tris = jax.tree_util.tree_map(
        lambda x, y: jnp.concatenate([x, y]), a, b)
    vf = np.asarray(ak.view_factors(scene, tris, jax.random.PRNGKey(0),
                                    rays_per_triangle=512, n_bins=4,
                                    ray_batch=128, tile_size=1024))
    assert vf.shape == (4, 4)
    assert np.all(np.diag(vf) == 0)          # self-hits excluded
    # Quad A's triangles see quad B's (upper-right block nonzero).
    assert vf[:2, 2:].sum() > 0
    # Each source fired 512 rays; hits can't exceed that.
    assert vf.max() <= 512


# ---------------------------------------------------------------------------
# Collision
# ---------------------------------------------------------------------------

def test_collide_instances_pairs():
    mgr = TLAS()
    s = rc.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    tr = lambda x: np.array([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    mgr.push(s, tr(0.0))    # 0 overlaps 1
    mgr.push(s, tr(1.5))    # 1 overlaps 0 and 2
    mgr.push(s, tr(3.0))    # 2 overlaps 1
    mgr.push(s, tr(10.0))   # 3 isolated
    scene = mgr.sync()
    res = collide_instances(scene)
    pairs = {tuple(p) for p in np.asarray(res.contacts)[:res.num_contacts]}
    assert pairs == {(0, 1), (1, 2)}
    assert res.num_contacts == 2


def test_collide_instances_none():
    mgr = TLAS()
    s = rc.sphere_mesh(radius=0.5, n_theta=8, n_phi=16)
    for k in range(3):
        t = np.eye(3, 4, dtype=np.float32)
        t[0, 3] = 5.0 * k
        mgr.push(s, t)
    res = collide_instances(mgr.sync())
    assert res.num_contacts == 0


def test_collide_instances_any():
    mgr = TLAS()
    s = rc.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    h1 = mgr.push(s, None)
    t = np.eye(3, 4, dtype=np.float32); t[0, 3] = 1.0
    h2 = mgr.push(s, t)
    t2 = np.eye(3, 4, dtype=np.float32); t2[0, 3] = 9.0
    h3 = mgr.push(s, t2)
    assert collide_instances_any(mgr, h1, h2)
    assert not collide_instances_any(mgr, h1, h3)


# ---------------------------------------------------------------------------
# MultiTypeSet
# ---------------------------------------------------------------------------

def test_multitypeset_push_dispatch():
    s = mts.MultiTypeSet()
    k1 = s.push({"albedo": 0.8, "sigma": 1.0}, "matte")
    k2 = s.push({"eta": 1.5, "k": 2.0}, "metal")
    k3 = s.push({"albedo": 0.3, "sigma": 0.5}, "matte")
    assert s.n_slots == 2 and len(s) == 3
    st = s.get_static()
    fns = [lambda row: row["albedo"] * 2.0,        # matte
           lambda row: row["eta"] + row["k"]]      # metal
    assert float(mts.with_index(fns, st, k1)) == pytest.approx(1.6)
    assert float(mts.with_index(fns, st, k2)) == pytest.approx(3.5)
    assert float(mts.with_index(fns, st, k3)) == pytest.approx(0.6)


def test_multitypeset_update_and_invalid_noop():
    s = mts.MultiTypeSet()
    k = s.push({"v": 1.0}, "a")
    s.update(k, {"v": 5.0})
    st = s.get_static()
    assert float(mts.with_index([lambda r: r["v"]], st, k)) == 5.0
    # Invalid key update is a no-op (reference regression,
    # test/test_multitypeset.jl:45-61).
    s.update(mts.SetKey(*mts.INVALID_KEY), {"v": 9.0})
    st2 = s.get_static()
    assert float(mts.with_index([lambda r: r["v"]], st2, k)) == 5.0
    assert bool(mts.is_invalid(mts.SetKey(-1, -1)))
    assert not bool(mts.is_invalid(k))


def test_multitypeset_textures():
    s = mts.MultiTypeSet()
    tex = np.linspace(0, 1, 16, dtype=np.float32).reshape(4, 4)
    k = s.push({"scale": 2.0, "tex": tex}, "textured")
    st = s.get_static()

    def make_sampler(pool):
        def sample_mat(row):
            uv = jnp.array([0.9, 0.9], jnp.float32)
            t = mts.sample_nearest(pool, row["tex"], uv)
            return t[0] * row["scale"]
        return sample_mat

    val = float(mts.with_index([make_sampler(st.textures)], st, k))
    assert val == pytest.approx(2.0 * tex[3, 3], rel=1e-5)
    # update! reuses the texture slot for same-shape data.
    s.update(k, {"scale": 2.0, "tex": tex * 0.5})
    st2 = s.get_static()
    val2 = float(mts.with_index([make_sampler(st2.textures)], st2, k))
    assert val2 == pytest.approx(tex[3, 3], rel=1e-5)
    assert st2.textures.records.shape == st.textures.records.shape


def test_multitypeset_batched_keys():
    s = mts.MultiTypeSet()
    for v in (1.0, 2.0, 3.0):
        s.push({"v": v}, "a")
    for w in (10.0, 20.0):
        s.push({"w": w}, "b")
    st = s.get_static()
    keys = jnp.asarray([[0, 0], [1, 1], [0, 2]], jnp.int32)
    f = jax.vmap(lambda k: mts.with_index(
        [lambda r: r["v"], lambda r: r["w"]], st, k))
    np.testing.assert_allclose(np.asarray(f(keys)), [1.0, 20.0, 3.0])


# ---------------------------------------------------------------------------
# Wavefront renderer
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_wavefront_render_smoke():
    scene, materials, lights, camera = example_scene()
    r = WavefrontRenderer(scene, materials, lights, camera,
                          RenderConfig(width=64, height=48, spp=1,
                                       tile_size=1024))
    img = np.asarray(r.render(jax.random.PRNGKey(1)))
    assert img.shape == (48, 64, 3)
    assert np.all(img >= 0) and np.all(img <= 1)
    # Scene is actually visible: decent hit coverage and color variation.
    assert img.std() > 0.02
    bg = np.array([0.05, 0.07, 0.12])
    fg = np.abs(img - bg).sum(-1) > 0.05
    assert fg.mean() > 0.3


def test_wavefront_staged_matches_single_jit():
    """render_staged hoists the three traversal queries out of the frame
    jit (so dispatch can pick the sweep engines) — the math must
    stay identical to the single-jit render_step."""
    from raycore.render.wavefront import render_staged, render_step
    scene, materials, lights, camera = example_scene()
    cfg = RenderConfig(width=48, height=32, spp=1, tile_size=1024)
    key = jax.random.PRNGKey(3)
    a = np.asarray(render_step(scene, materials, lights, camera, key, cfg))
    b = np.asarray(render_staged(scene, materials, lights, camera, key,
                                 cfg))
    np.testing.assert_allclose(a, b, atol=3e-5)


def test_wavefront_staged_pipelined_matches():
    """pipelined=True (deferred whole-frame query chain, one validation
    sync at frame end) must be bit-identical to the per-query staged
    frame: deferral removes host syncs, never changes the math."""
    from raycore.render.wavefront import render_staged
    scene, materials, lights, camera = example_scene()
    cfg = RenderConfig(width=48, height=32, spp=1, tile_size=1024)
    key = jax.random.PRNGKey(3)
    a = np.asarray(render_staged(scene, materials, lights, camera, key,
                                 cfg))
    b = np.asarray(render_staged(scene, materials, lights, camera, key,
                                 cfg, pipelined=True))
    np.testing.assert_array_equal(a, b)


def test_dispatch_routes_warm_regroup(monkeypatch):
    """VERDICT r2 item 4: once the regrouped engine is warm for a
    (scene, shape) — via rc.prewarm or a previous direct query —
    dispatch must auto-route matching big queries to it, with results
    identical to the worklist engine."""
    from raycore.accel import dispatch as disp
    from raycore.accel.dense import build_dense
    from raycore.ops.pallas_regroup import has_warm_capacity
    import raycore as rc_
    mesh = rc_.displaced_grid_mesh(n=24, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=64)
    n = 45 * 45
    monkeypatch.setattr(disp, "REGROUP_MIN_RAYS", n)
    xs = jnp.linspace(-0.9, 0.9, 45)
    X, Y = jnp.meshgrid(xs, xs, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, 2.0)], -1).reshape(-1, 3)
    rays = rc_.Ray.create(o=o, d=jnp.broadcast_to(
        jnp.asarray([0.0, 0, -1.0]), o.shape))
    assert not has_warm_capacity(scene, n)
    cold = disp.scene_closest_hit(scene, rays)        # worklist engine
    rc_.prewarm(scene, n, engine="regroup")
    assert has_warm_capacity(scene, n)
    warm = disp.scene_closest_hit(scene, rays)        # regrouped engine
    np.testing.assert_array_equal(np.asarray(cold.hit),
                                  np.asarray(warm.hit))
    m = np.asarray(cold.hit)
    np.testing.assert_allclose(np.asarray(warm.t)[m],
                               np.asarray(cold.t)[m], rtol=1e-5, atol=1e-6)


def test_warm_capacity_survives_process_restart(monkeypatch, tmp_path):
    """VERDICT r3 task 7: capacity hints persist next to the compile
    cache, so a FRESH process (simulated here by clearing the in-memory
    caches) still routes query 1 to the fast engine and the fused path
    uses the persisted capacity predictions."""
    from raycore.accel.dense import build_dense
    from raycore.ops import capacity_store, pallas_regroup as pr
    import raycore as rc_
    monkeypatch.setenv("RAYCORE_CAPACITY_DIR", str(tmp_path))
    monkeypatch.setattr(capacity_store, "_LOADED", None)
    mesh = rc_.displaced_grid_mesh(n=24, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=64)
    n = 45 * 45
    assert not pr.has_warm_capacity(scene, n)
    rc_.prewarm(scene, n, engine="regroup")
    assert pr.has_warm_capacity(scene, n)
    # "Process restart": wipe RAM caches + the store's loaded copy, and
    # rebuild the scene so even the weakref identity is fresh.
    pr._CAPACITY_CACHE.clear()
    monkeypatch.setattr(capacity_store, "_LOADED", None)
    scene2 = build_dense(mesh, cluster_size=64)
    assert pr.has_warm_capacity(scene2, n)
    # And the adopted hints drive a correct warm query.
    xs = jnp.linspace(-0.9, 0.9, 45)
    X, Y = jnp.meshgrid(xs, xs, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, 2.0)], -1).reshape(-1, 3)
    rays = rc_.Ray.create(o=o, d=jnp.broadcast_to(
        jnp.asarray([0.0, 0, -1.0]), o.shape))
    warm = pr.closest_hit_regrouped(scene2, rays, tile=2048, passes=1)
    from raycore.accel.brute import closest_hit_brute
    ref = closest_hit_brute(mesh, rays)
    np.testing.assert_array_equal(np.asarray(warm.hit),
                                  np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(warm.t)[m],
                               np.asarray(ref.t)[m], rtol=1e-5, atol=1e-6)
    # Disabling persistence turns disk adoption off.
    pr._CAPACITY_CACHE.clear()
    monkeypatch.setenv("RAYCORE_PERSIST_CAPACITY", "0")
    monkeypatch.setattr(capacity_store, "_LOADED", None)
    assert not pr.has_warm_capacity(scene2, n)


def test_dispatch_routes_warm_multiwave_scene(monkeypatch):
    """The r5a cold-routing rc=1 class: on a scene whose passes="auto"
    resolves to the ordered multiwave, rc.prewarm warms the MULTIWAVE
    capacity key — a warmth probe at the has_warm_capacity default
    (passes=1) misses it. Dispatch must probe the auto-resolved key
    first (accel/dispatch.py) and route the query to the regrouped
    engine, with results matching the brute oracle."""
    from raycore.accel import dispatch as disp
    from raycore.accel.brute import closest_hit_brute
    from raycore.accel.dense import build_dense
    from raycore.ops import pallas_regroup as pr
    import raycore as rc_
    mesh = rc_.blobby_mesh(n_theta=72, n_phi=72)
    scene = build_dense(mesh, cluster_size=64)
    if pr.auto_passes(scene) == 1:         # guard: need a multiwave scene
        import pytest
        pytest.skip("blobby generator no longer auto-routes to multiwave")
    n = 45 * 45
    monkeypatch.setattr(disp, "REGROUP_MIN_RAYS", n)
    rc_.prewarm(scene, n, engine="regroup")
    # The asymmetry that broke the r5a cold-routing proof: the multiwave
    # key is warm, the passes=1 key is not.
    assert pr.has_warm_capacity(scene, n, passes="auto")
    assert not pr.has_warm_capacity(scene, n, passes=1)
    calls = []
    orig = pr.closest_hit_regrouped

    def spy(*a, **kw):
        calls.append(kw.get("passes"))
        return orig(*a, **kw)

    monkeypatch.setattr(pr, "closest_hit_regrouped", spy)
    xs = jnp.linspace(-0.9, 0.9, 45)
    X, Y = jnp.meshgrid(xs, xs, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, 2.0)], -1).reshape(-1, 3)
    rays = rc_.Ray.create(o=o, d=jnp.broadcast_to(
        jnp.asarray([0.0, 0, -1.0]), o.shape))
    got = disp.scene_closest_hit(scene, rays)
    assert calls == ["auto"], calls        # routed to the warm multiwave
    ref = closest_hit_brute(mesh, rays)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-6)


def test_wavefront_reflection_roughness_jitter():
    """Parity with the reference's generate_reflection_rays! roughness
    jitter (docs/src/wavefront-renderer.jl:457-459): with the SAME key,
    raising the metallic material's roughness must change the reflected
    region (pre-fix, roughness had no effect anywhere in the pipeline),
    and roughness=0 must stay a perfect mirror (key-independent)."""
    scene, materials, lights, camera = example_scene()
    cfg = RenderConfig(width=64, height=48, spp=1, tile_size=1024)
    key = jax.random.PRNGKey(7)

    def render_with_roughness(rf, k=key):
        m = materials.replace(
            roughness=materials.roughness.at[4].set(rf))
        return np.asarray(WavefrontRenderer(scene, m, lights, camera,
                                            cfg).render(k))
    mirror = render_with_roughness(0.0)
    rough = render_with_roughness(0.8)
    assert np.abs(mirror - rough).max() > 0.02
    # Mirror reflections don't consume randomness: a different key only
    # moves the sub-pixel sample jitter, not the reflection directions.
    mirror_b = render_with_roughness(0.0, jax.random.PRNGKey(8))
    rough_b = render_with_roughness(0.8, jax.random.PRNGKey(8))
    assert np.abs(mirror - mirror_b).mean() < np.abs(rough - rough_b).mean() + 1e-6


def test_multitypeset_inline_vector_fields():
    """1D vector fields stay inline as (cap, K) columns — the reference's
    inline StaticArrays (maybe_convert_field, src/multitypeset.jl:281-324);
    only ndim>=2 arrays become textures."""
    s = mts.MultiTypeSet()
    k1 = s.push({"albedo": np.array([0.8, 0.2, 0.1], np.float32),
                 "sigma": 1.0}, "matte")
    k2 = s.push({"tint": [0.9, 0.8, 0.7]}, "mirror")   # list works too
    k3 = s.push({"albedo": np.array([0.1, 0.2, 0.3], np.float32),
                 "sigma": 0.0}, "matte")
    st = s.get_static()
    fns = [lambda r: r["albedo"] * 2.0, lambda r: jnp.asarray(r["tint"])]
    np.testing.assert_allclose(
        np.asarray(mts.with_index(fns, st, k1)), [1.6, 0.4, 0.2], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mts.with_index(fns, st, k2)), [0.9, 0.8, 0.7], rtol=1e-6)
    # update keeps vectors inline
    s.update(k3, {"albedo": np.array([1.0, 1.0, 1.0], np.float32),
                  "sigma": 2.0})
    st2 = s.get_static()
    np.testing.assert_allclose(
        np.asarray(mts.with_index(fns, st2, k3)), [2.0, 2.0, 2.0], rtol=1e-6)
