"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8).

Checks: sharded eval == single-device eval; sharded train step ==
single-device train step (grad all-reduce correctness); halo-exchanged
spatial filters == single-device kernels bit-for-bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reflectance_filtering.models.networks import (
    NetworkConfig, init_network)
from reflectance_filtering.train.loop import (
    LossConfig, make_optimizer, make_train_step)
from reflectance_filtering.parallel.mesh import (
    make_mesh, make_sharded_train_step, eval_dataset_sharded,
    replicate, shard_batch, pad_to_multiple)
from reflectance_filtering.parallel.spatial import (
    sharded_box_filter, sharded_joint_bilateral)
from reflectance_filtering.ops.boxfilter import box_filter
from reflectance_filtering.ops.bilateral import joint_bilateral_filter
from test_whdr import make_blob, random_comps


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh(8)


@pytest.fixture(scope="module")
def cfg():
    return NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                         num_filters_log=3, kernel_pad=0,
                         rs_est_mode="rDirectly")


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n, h, w = 16, 24, 24
    images = rng.rand(n, h, w, 3).astype(np.float32) * 0.8 + 0.1
    comps = np.stack([make_blob(random_comps(rng, 10))
                      for _ in range(n)]).astype(np.float32)
    return {"images": images, "comparisons": comps}


def test_pad_to_multiple():
    x = np.arange(10)[:, None]
    p, n = pad_to_multiple(x, 8)
    assert p.shape[0] == 16 and n == 10
    np.testing.assert_array_equal(p[10:], np.repeat(x[-1:], 6, axis=0))


def test_sharded_eval_matches_single_device(mesh8, cfg, data):
    from reflectance_filtering.losses.whdr import whdr
    params = init_network(jax.random.PRNGKey(0), cfg)
    mean_s, per_image = eval_dataset_sharded(params, data, cfg, mesh8)

    # single-device reference
    from reflectance_filtering.train.predict import make_predict_fn
    fn = make_predict_fn(cfg)
    res = fn(params, jnp.asarray(data["images"]))
    refl = np.asarray(res["reflectance"])
    expected = [float(whdr(jnp.asarray(refl[b]),
                           jnp.asarray(data["comparisons"][b])))
                for b in range(16)]
    np.testing.assert_allclose(per_image, expected, atol=1e-6)
    assert abs(mean_s - np.mean(expected)) < 1e-6


def test_sharded_train_step_matches_single_device(mesh8, cfg, data):
    lcfg = LossConfig()
    params = init_network(jax.random.PRNGKey(0), cfg)
    opt = make_optimizer("ADAM", 1e-3)
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(7)

    single = make_train_step(cfg, lcfg, opt)
    p1, o1, m1 = single(params, opt_state,
                        jnp.asarray(data["images"]),
                        jnp.asarray(data["comparisons"]), key)

    sharded = make_sharded_train_step(cfg, lcfg, opt, mesh8)
    pr = replicate(params, mesh8)
    orr = replicate(opt_state, mesh8)
    p2, o2, m2 = sharded(pr, orr,
                         shard_batch(jnp.asarray(data["images"]), mesh8),
                         shard_batch(jnp.asarray(data["comparisons"]),
                                     mesh8),
                         replicate(key, mesh8))
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    assert abs(float(m1["loss_whdr_hinge"]) -
               float(m2["loss_whdr_hinge"])) < 1e-6


def test_sharded_box_filter_matches_local(mesh8):
    rng = np.random.RandomState(1)
    x = (rng.rand(32, 64, 3) * 255).astype(np.float32)  # 8 columns/shard
    got = np.asarray(sharded_box_filter(jnp.asarray(x), 3, mesh8))
    exp = np.asarray(box_filter(jnp.asarray(x), 3, border="reflect101"))
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-3)


def test_sharded_bilateral_matches_local(mesh8):
    rng = np.random.RandomState(2)
    joint = (rng.rand(24, 64, 3) * 255).astype(np.float32)
    src = (rng.rand(24, 64, 3) * 255).astype(np.float32)
    # radius small enough for 8-col shards: sigma_space=2 -> r=3
    got = np.asarray(sharded_joint_bilateral(
        jnp.asarray(joint), jnp.asarray(src), mesh8,
        sigma_color=20.0, sigma_space=2.0))
    exp = np.asarray(joint_bilateral_filter(joint, src, -1, 20.0, 2.0))
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-3)


def test_sharded_guided_filter_matches_local(mesh8):
    from reflectance_filtering.ops.guided import guided_filter
    from reflectance_filtering.parallel.spatial import (
        sharded_guided_filter)
    rng = np.random.RandomState(4)
    guide = (rng.rand(24, 64, 3) * 255).astype(np.float32)
    src = (rng.rand(24, 64) * 255).astype(np.float32)
    # halo 2r = 6 < 8 columns/shard
    got = np.asarray(sharded_guided_filter(
        jnp.asarray(guide), jnp.asarray(src), 3, 9.0, mesh8))
    exp = np.asarray(guided_filter(jnp.asarray(guide), jnp.asarray(src),
                                   3, 9.0))
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=5e-3)


def test_sharded_bilateral_self_guided_fast_kernels(mesh8, triton_interpret):
    """The sharded SELF-GUIDED bilateral (src=None) runs the Triton
    kernel per shard and matches the single-device oracle: the
    BF(CNN,CNN) -r.png case (a gray plane standing for 3 equal channels)
    and cv2.bilateralFilter's colour-self case."""
    rng = np.random.RandomState(8)
    gray = np.floor(rng.rand(16, 64) * 256).astype(np.float32)
    got_g = np.asarray(sharded_joint_bilateral(
        jnp.asarray(gray[..., None]), None, mesh8, sigma_color=20.0,
        sigma_space=2.0, joint_reps=3))[..., 0]
    rep3 = np.repeat(gray[..., None], 3, -1)
    exp_g = np.asarray(joint_bilateral_filter(rep3, rep3, -1, 20.0,
                                              2.0))[..., 0]
    np.testing.assert_allclose(got_g, exp_g, rtol=1e-4, atol=0.05)

    col = np.floor(rng.rand(16, 64, 3) * 256).astype(np.float32)
    got_c = np.asarray(sharded_joint_bilateral(
        jnp.asarray(col), None, mesh8, sigma_color=20.0, sigma_space=2.0))
    exp_c = np.asarray(joint_bilateral_filter(col, col, -1, 20.0, 2.0))
    np.testing.assert_allclose(got_c, exp_c, rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("cj,cs", [(3, 1), (1, 3), (3, 3)])
def test_sharded_joint_bilateral_triton_per_shard(mesh8, triton_interpret,
                                                  cj, cs):
    """joint != src through the Triton kernel in every shard (halo r=3
    on 8-column shards) equals the single-device reference."""
    rng = np.random.RandomState(10 + cj + cs)
    joint = np.floor(rng.rand(16, 64, cj) * 256).astype(np.float32)
    src = np.floor(rng.rand(16, 64, cs) * 256).astype(np.float32)
    got = np.asarray(sharded_joint_bilateral(
        jnp.asarray(joint), jnp.asarray(src), mesh8, sigma_color=20.0,
        sigma_space=2.0))
    exp = np.asarray(joint_bilateral_filter(joint, src, -1, 20.0, 2.0))
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=0.05)


def test_sharded_guided_iterated_matches_local(mesh8):
    """8-device sharded 3x-GF chain == the single-device chain at the
    PRODUCT radius (r=45; VERDICT r4 item 3).  One halo exchange of
    iterations*2r = 270 columns, 320 columns/shard."""
    from reflectance_filtering.ops.guided import guided_filter_iterated
    from reflectance_filtering.parallel.spatial import (
        sharded_guided_filter_iterated)
    rng = np.random.RandomState(6)
    h, w, r, iters = 64, 2560, 45, 3
    guide = np.floor(rng.rand(h, w, 3) * 256).astype(np.float32)
    src = np.floor(rng.rand(h, w) * 256).astype(np.float32)
    got = np.asarray(sharded_guided_filter_iterated(
        jnp.asarray(guide), jnp.asarray(src), r, 3.0, iters, mesh8))
    exp = np.asarray(guided_filter_iterated(
        jnp.asarray(guide), jnp.asarray(src), r, 3.0, iters))
    # float op order differs (per-shard vs whole-row box accumulation):
    # values agree to ~1e-3 on 0-255 data; a handful of pixels (<0.01%,
    # observed 8/163840) straddle a rint .5 boundary by that epsilon
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=0.05)
    d = np.abs(np.rint(np.clip(got, 0, 255)) - np.rint(np.clip(exp, 0, 255)))
    assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())


def test_sharded_guided_iterated_narrow_shards_raise(mesh8):
    from reflectance_filtering.parallel.spatial import (
        sharded_guided_filter_iterated)
    guide = jnp.zeros((16, 256, 3))   # 32 cols/shard < 3*2*45
    src = jnp.zeros((16, 256))
    with pytest.raises(ValueError, match="too narrow"):
        sharded_guided_filter_iterated(guide, src, 45, 3.0, 3, mesh8)


def test_score_whdr_per_image_matches_host_loop(data):
    """The product eval path (predict_and_score) scores WHDR as one
    sharded device program; values must match the per-image host loop it
    replaced (helper:565-583)."""
    from reflectance_filtering.losses.whdr import whdr
    from reflectance_filtering.train.predict import score_whdr_per_image

    rng = np.random.RandomState(3)
    n = 11  # not a multiple of 8: exercises the pad+crop path
    refl = rng.rand(n, 24, 24, 1).astype(np.float32)
    comps = data["comparisons"][:n]

    got = score_whdr_per_image(refl, comps, delta=0.1)
    want = np.array([float(whdr(jnp.asarray(refl[b]),
                                jnp.asarray(comps[b]), 0.1))
                     for b in range(n)])
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_predict_batched_sharded_matches_unsharded(mesh8, cfg):
    """predict_batched shards each batch across the mesh; outputs must be
    identical to a single-device run of the same jitted program."""
    from jax.sharding import Mesh
    from reflectance_filtering.train.predict import (
        make_predict_fn, predict_batched)

    rng = np.random.RandomState(1)
    params = init_network(jax.random.PRNGKey(0), cfg)
    images = rng.rand(13, 24, 24, 3).astype(np.float32)
    fn = make_predict_fn(cfg)

    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    out_1 = predict_batched(fn, params, images, batch_size=4, mesh=mesh1)
    out_8 = predict_batched(fn, params, images, batch_size=4, mesh=mesh8)
    for k in out_1:
        np.testing.assert_allclose(out_8[k], out_1[k], atol=1e-6)


def test_sharded_wrappers_narrow_shards_raise(mesh8):
    """Every halo-exchange wrapper must reject too-narrow shards with a
    clear message (not an opaque concatenate-shape mismatch)."""
    from reflectance_filtering.parallel.spatial import (
        sharded_joint_bilateral, sharded_box_filter)
    img = jnp.zeros((16, 8 * 16, 3), jnp.float32)  # 16 cols/shard
    with pytest.raises(ValueError, match="too narrow"):
        # radius 33 at the product sigmas >> 16-col shards
        sharded_joint_bilateral(img, img, mesh8, -1, 20.0, 22.0)
    with pytest.raises(ValueError, match="too narrow"):
        sharded_box_filter(img, 20, mesh8)
    with pytest.raises(ValueError, match="divisible"):
        sharded_box_filter(jnp.zeros((16, 100, 3), jnp.float32), 2,
                           mesh8)


def test_eval_dataset_sharded_chunked_matches_whole(mesh8, cfg, data):
    params = init_network(jax.random.PRNGKey(0), cfg)
    mean_w, per_w = eval_dataset_sharded(params, data, cfg, mesh8)
    # batch_size=1 -> chunks of 8 images; pad rows of the ragged final
    # chunk are masked on device
    sub = {"images": data["images"][:13],
           "comparisons": data["comparisons"][:13]}
    mean_c, per_c = eval_dataset_sharded(params, sub, cfg, mesh8,
                                         batch_size=1)
    np.testing.assert_allclose(per_c, per_w[:13], atol=1e-6)
    assert abs(mean_c - np.mean(per_w[:13])) < 1e-6
