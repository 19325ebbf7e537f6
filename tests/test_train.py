"""Training subsystem tests: description codec, checkpointing, monitors,
and a small end-to-end fit + eval on synthetic data."""
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reflectance_filtering.models.networks import (
    NetworkConfig, init_network)
from reflectance_filtering.train.description import (
    get_description, parse_description)
from reflectance_filtering.train.checkpoint import (
    Checkpointer, load_checkpoint, save_checkpoint)
from reflectance_filtering.train.loop import (
    LossConfig, compute_losses, fit, make_optimizer)
from reflectance_filtering.train.monitors import (
    CombineLosses, JsonlLogger, RunningAverage)
from reflectance_filtering.train.predict import (
    make_predict_fn, predict_and_score, predict_batched)
from test_whdr import make_blob, random_comps


def _args(**kw):
    defaults = dict(networkType="convStaticSkipLayers", numLayers=5,
                    num_filters_log=5, kernel_pad=0, dilation=1,
                    use_batch_normalization=0, RS_est_mode="rDirectly",
                    whdr_delta_margin_ratio_dense="0.1_0.05_1.0_1",
                    loss_scale_whdr=10.0, loss_scale_lambert=0,
                    height=256, width=256, dataset="iiw",
                    solverType="ADAM", base_lr=0.001,
                    comparisonsType="comparisons")
    defaults.update(kw)
    return types.SimpleNamespace(**defaults)


def test_description_matches_reference_example():
    """The README/SURVEY example string must reproduce exactly."""
    net_params, desc = get_description(_args())
    assert desc == ("convStaticSkipLayers_n5_f32_k1_d1_bn0_rDirectly_"
                    "wdm0.1_0.05_1.0_1_loss[w1.0E+01,l0]_ADAM0.001_"
                    "comparisons_h256w256iiw")


def test_description_roundtrip():
    args = _args(numLayers=3, num_filters_log=4, kernel_pad=1,
                 RS_est_mode="rRelMax")
    _, desc = get_description(args)
    parsed = parse_description(desc + "_barrista_iter_2000.npz")
    assert parsed["networkType"] == "convStaticSkipLayers"
    assert parsed["numLayers"] == 3
    assert parsed["num_filters_log"] == 4
    assert parsed["kernel_pad"] == 1
    assert parsed["RS_est_mode"] == "rRelMax"
    assert parsed["whdr_delta_margin_ratio_dense"] == "0.1_0.05_1.0_1"
    assert parsed["iterations"] == 2000
    # data/solver params recovered too (beyond the reference's parse):
    # without them a predict run at a non-default training size loads
    # the wrong-resolution val blob
    assert parsed["height"] == 256 and parsed["width"] == 256
    assert parsed["dataset"] == "iiw"
    assert parsed["comparisonsType"] == "comparisons"
    assert parsed["solverType"] == "ADAM"
    assert parsed["base_lr"] == 0.001


def test_description_roundtrip_nondefault_size():
    args = _args(numLayers=2, num_filters_log=4, kernel_pad=1,
                 RS_est_mode="rRelMax", height=32, width=48,
                 solverType="SGD", base_lr=0.01)
    _, desc = get_description(args)
    parsed = parse_description(desc + "_barrista_iter_16.npz")
    assert parsed["height"] == 32 and parsed["width"] == 48
    assert parsed["solverType"] == "SGD" and parsed["base_lr"] == 0.01


def test_checkpoint_roundtrip(tmp_path):
    cfg = NetworkConfig(network_type="convStatic", num_layers=2,
                        num_filters_log=3, kernel_pad=1,
                        rs_est_mode="rRelMax")
    params = init_network(jax.random.PRNGKey(0), cfg)
    opt = make_optimizer("ADAM", 1e-3)
    opt_state = opt.init(params)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, opt_state, {"iterations": 42})
    template = init_network(jax.random.PRNGKey(1), cfg)
    p2, o2, meta = load_checkpoint(path, template, opt.init(template))
    assert meta["iterations"] == 42
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(jax.tree_util.tree_leaves(o2)) == len(
        jax.tree_util.tree_leaves(opt_state))


def test_checkpointer_interval_naming(tmp_path):
    cfg = NetworkConfig(network_type="convStatic", num_layers=1,
                        num_filters_log=2, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    ck = Checkpointer(str(tmp_path), "desc", interval=40)
    assert ck.maybe_save(20, params) is None
    p = ck.maybe_save(40, params)
    assert p.endswith("desc_barrista_iter_40.npz")
    assert ck.maybe_save(40, params) is None  # double-save prevented
    ck.maybe_save(60, params, finalize=True)
    assert ck.highest_iteration() == 60


def test_combine_losses_and_running_average():
    cl = CombineLosses(10.0, 2.0)
    m = cl(0, {"loss_whdr_hinge": 0.5, "loss_lambert": 0.25})
    assert m["loss_combined"] == 10.0 * 0.5 + 2.0 * 0.25
    ra = RunningAverage(train_size=40, batch_size=10)  # 4 slots
    for step, v in enumerate([0.4, 0.2, np.nan, 0.6]):
        m = ra(step, {"whdr_original": v})
    assert abs(m["running_average"] - np.nanmean([0.4, 0.2, np.nan, 0.6])) \
        < 1e-9


def test_jsonl_logger_nonfinite_metrics_stay_valid_json(tmp_path):
    """A diverged step (NaN/inf loss) must not corrupt the jsonl artifact:
    json.dumps would emit bare NaN/Infinity tokens that strict parsers
    reject; the logger serializes them as null."""
    lg = JsonlLogger(str(tmp_path), "t")
    lg(0, {"loss": float("nan"), "lr": 0.1, "extra": float("inf"),
           "skipme": "string"})
    lg(1, {"loss": 0.5})
    lg.close()
    lines = open(lg.path).read().splitlines()
    recs = [json.loads(l, parse_constant=lambda s: pytest.fail(
        "non-strict token {} in jsonl".format(s))) for l in lines]
    assert recs[0] == {"step": 0, "loss": None, "lr": 0.1, "extra": None}
    assert recs[1] == {"step": 1, "loss": 0.5}


@pytest.fixture(scope="module")
def tiny_data():
    rng = np.random.RandomState(0)
    n, h, w = 6, 24, 24
    images = (rng.rand(n, h, w, 3).astype(np.float32) * 0.8 + 0.1)
    comps = np.stack([make_blob(random_comps(rng, 12)) for _ in range(n)])
    return {"images": images, "comparisons": comps.astype(np.float32)}


def test_compute_losses_flagship(tiny_data):
    cfg = NetworkConfig()  # flagship: skip layers, rDirectly
    lcfg = LossConfig()
    params = init_network(jax.random.PRNGKey(0), cfg)
    total, metrics = compute_losses(
        params, jnp.asarray(tiny_data["images"][:2]),
        jnp.asarray(tiny_data["comparisons"][:2]), cfg, lcfg)
    assert float(total) >= 0
    assert "loss_whdr_hinge" in metrics and "whdr_original" in metrics
    # rDirectly: no boundary losses wired (networks.py:256)
    assert "loss_boundaries_reflectance" not in metrics


def test_compute_losses_rrelmax_has_boundaries(tiny_data):
    cfg = NetworkConfig(network_type="convStatic", num_layers=2,
                        num_filters_log=3, kernel_pad=1,
                        rs_est_mode="rRelMax")
    lcfg = LossConfig()
    params = init_network(jax.random.PRNGKey(0), cfg)
    total, metrics = compute_losses(
        params, jnp.asarray(tiny_data["images"][:2]),
        jnp.asarray(tiny_data["comparisons"][:2]), cfg, lcfg)
    assert "loss_boundaries_reflectance" in metrics
    assert "loss_boundaries_shading" in metrics


def test_compute_losses_rs_has_lambert(tiny_data):
    cfg = NetworkConfig(network_type="convStatic", num_layers=1,
                        num_filters_log=3, kernel_pad=1, rs_est_mode="RS")
    lcfg = LossConfig(loss_scale_lambert=1.0)
    params = init_network(jax.random.PRNGKey(0), cfg)
    total, metrics = compute_losses(
        params, jnp.asarray(tiny_data["images"][:2]),
        jnp.asarray(tiny_data["comparisons"][:2]), cfg, lcfg)
    assert "loss_lambert" in metrics


def test_fit_end_to_end_reduces_loss(tiny_data, tmp_path):
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    lcfg = LossConfig()
    losses = []

    def track(step, samples, metrics):
        losses.append(metrics["loss_whdr_hinge"])

    ck = Checkpointer(str(tmp_path), "d", interval=8)
    state = fit(cfg, lcfg, tiny_data, iterations=48, batch_size=4,
                base_lr=0.01, random_seed=0, checkpointer=ck,
                progress=track)
    assert state.samples == 48
    assert len(losses) == 12
    # training should make progress on average
    assert np.mean(losses[-3:]) <= np.mean(losses[:3]) + 1e-6
    assert ck.highest_iteration() == 48


def test_predict_and_score_artifacts(tiny_data, tmp_path):
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    results_dir = str(tmp_path)
    score = predict_and_score(tiny_data, params, cfg, results_dir, "desc",
                              batch_size=4)
    assert 0 <= score <= 100
    n = tiny_data["images"].shape[0]
    score_file = os.path.join(results_dir, "scores",
                              "desc_imgs{}.txt".format(n))
    assert os.path.isfile(score_file)
    assert os.path.isfile(os.path.join(results_dir, "framerates",
                                       "desc_imgs{}.txt".format(n)))
    # score cache: re-reads the file instead of recomputing
    with open(score_file, "w") as f:
        f.write("12.5")
    assert predict_and_score(tiny_data, params, cfg, results_dir,
                             "desc") == 12.5


def test_bn_train_step_folds_running_stats(tiny_data):
    """With use_batch_normalization, the train step must EMA-fold the batch
    statistics into the bn params (caffe BatchNorm moving average,
    moving_average_fraction=0.999) without letting Adam touch them."""
    from reflectance_filtering.models.networks import (
        BN_MOMENTUM, apply_network)
    from reflectance_filtering.train.loop import make_train_step

    # convStaticSkipLayers: the reference honors the BN flag only for
    # the skip-layer/cascade families (convStatic hardcodes it off,
    # networks.py:560 — init_network now mirrors that)
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=1,
                        rs_est_mode="rRelMax", use_batch_normalization=True)
    lcfg = LossConfig()
    params = init_network(jax.random.PRNGKey(0), cfg)
    assert "bn0" in params
    opt = make_optimizer("ADAM", 1e-3)
    opt_state = opt.init(params)
    step = make_train_step(cfg, lcfg, opt)
    images = jnp.asarray(tiny_data["images"][:4])
    comps = jnp.asarray(tiny_data["comparisons"][:4])
    p2, _, metrics = step(params, opt_state, images, comps,
                          jax.random.PRNGKey(1))
    # scalar-only metrics for the host logger; no pytrees leak out
    assert all(np.ndim(v) == 0 for v in metrics.values())
    # the fresh batch stats of layer 0 come from the raw conv0 output
    blobs = apply_network(params, images, cfg, train=True)
    batch_mean = blobs["__bn_stats__"]["bn0"]["mean"]
    expect = BN_MOMENTUM * params["bn0"]["mean"] \
        + (1 - BN_MOMENTUM) * batch_mean
    np.testing.assert_allclose(np.asarray(p2["bn0"]["mean"]),
                               np.asarray(expect), rtol=1e-5)
    assert not np.allclose(np.asarray(p2["bn0"]["mean"]), 0.0)


def test_bn_eval_uses_running_stats(tiny_data):
    """train=False must normalize with the stored running stats (caffe TEST
    phase), so different eval batches see the same normalization."""
    from reflectance_filtering.models.networks import batch_norm
    params = {"mean": jnp.asarray([1.0, -2.0]),
              "var": jnp.asarray([4.0, 0.25])}
    x = jnp.asarray(np.random.RandomState(0).rand(2, 3, 3, 2), jnp.float32)
    y, stats = batch_norm(params, x, train=False)
    np.testing.assert_allclose(
        np.asarray(y),
        np.asarray((x - params["mean"])
                   / np.sqrt(np.asarray(params["var"]) + 1e-5)),
        rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(stats["mean"]),
                                  np.asarray(params["mean"]))


def test_whdr_metric_reads_metric_comparisons(tiny_data):
    """whdr_original is always wired to the plain 'comparisons' blob even
    when the hinge trains on 'augmented' (reference networks.py:243-254)."""
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    lcfg = LossConfig()
    params = init_network(jax.random.PRNGKey(0), cfg)
    images = jnp.asarray(tiny_data["images"][:2])
    comps = jnp.asarray(tiny_data["comparisons"][:2])
    rng = np.random.RandomState(7)
    other = jnp.asarray(np.stack(
        [make_blob(random_comps(rng, 9)) for _ in range(2)]), jnp.float32)
    _, m_same = compute_losses(params, images, comps, cfg, lcfg)
    _, m_other = compute_losses(params, images, comps, cfg, lcfg,
                                metric_comparisons=other)
    # hinge identical (same training blob), metric follows the metric blob
    np.testing.assert_allclose(float(m_same["loss_whdr_hinge"]),
                               float(m_other["loss_whdr_hinge"]), rtol=1e-6)
    assert float(m_same["whdr_original"]) != float(m_other["whdr_original"])


def test_cascade_rdirectly_falls_back_to_rrelmax(tiny_data):
    """cascadeSkipLayers + rDirectly: the reference recover layer has no
    rDirectly mode and warns+falls back to rRelMax
    (recover_reflectance_shading_layer.py:104-109), so level 0 must still
    emit a 3-channel reflectance for the level-1 trunk."""
    from reflectance_filtering.models.networks import apply_network
    cfg = NetworkConfig(network_type="cascadeSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    blobs = apply_network(params, jnp.asarray(tiny_data["images"][:2]),
                          cfg, train=True)
    assert blobs["reflectance_level0"].shape[-1] == 3
    assert "RS_est" in blobs


def test_matmul_precision_context_restores():
    from reflectance_filtering.models import networks as N
    assert N._matmul_precision == jax.lax.Precision.HIGHEST
    with N.matmul_precision("default"):
        assert N._matmul_precision == jax.lax.Precision.DEFAULT
        with N.matmul_precision("high"):
            assert N._matmul_precision == jax.lax.Precision.HIGH
        assert N._matmul_precision == jax.lax.Precision.DEFAULT
    assert N._matmul_precision == jax.lax.Precision.HIGHEST


def test_conv2d_1x1_dot_matches_conv_path(rng):
    """The 1x1-as-dot lowering must agree with the general conv path."""
    from reflectance_filtering.models.networks import conv2d
    k = rng.randn(1, 1, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    x = jnp.asarray(rng.rand(2, 6, 9, 5).astype(np.float32))
    got = conv2d({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, x,
                 pad=0)
    exp = jax.lax.conv_general_dilated(
        x, jnp.asarray(k), window_strides=(1, 1), padding=[(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["rRelMax", "sRelNorm", "rAbs", "RS"])
def test_recover_gradients_match_finite_difference(mode, rng):
    """JAX autodiff through the R/S recovery interpreters vs numeric
    gradients — the check the reference's hand-derived backward never had
    (recover_reflectance_shading_layer.py:206-244)."""
    from reflectance_filtering.models.networks import head_channels
    from reflectance_filtering.models.recover import (
        recover_reflectance_shading)
    c = head_channels(mode)
    est = rng.rand(1, 4, 4, c).astype(np.float32) + 0.5
    img = jnp.asarray(rng.rand(1, 4, 4, 3).astype(np.float32) + 0.2)

    def f(e):
        r, s = recover_reflectance_shading(e, img, mode)
        return jnp.sum(r * r) + jnp.sum(s)

    g = np.asarray(jax.grad(f)(jnp.asarray(est)))
    eps = 1e-3
    for idx in [(0, 0, 0, 0), (0, 2, 3, c - 1), (0, 3, 1, c // 2)]:
        ep = est.copy(); ep[idx] += eps
        em = est.copy(); em[idx] -= eps
        num = (float(f(jnp.asarray(ep))) - float(f(jnp.asarray(em)))) \
            / (2 * eps)
        np.testing.assert_allclose(g[idx], num, rtol=2e-2, atol=2e-3,
                                   err_msg="{} {}".format(mode, idx))


def test_predict_batched_pads_tail(tiny_data):
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    fn = make_predict_fn(cfg)
    out = predict_batched(fn, params, tiny_data["images"], batch_size=4)
    assert out["reflectance"].shape[0] == tiny_data["images"].shape[0]


def test_conv_static_hardcodes_bn_off():
    """convStatic / convStaticWithSigmoid ignore --use_batch_normalization
    (the reference sets do_batch_normalization = False locally,
    networks.py:560, :641) — they must not grow bn params the reference
    could never have."""
    for t in ("convStatic", "convStaticWithSigmoid"):
        cfg = NetworkConfig(network_type=t, num_layers=2,
                            num_filters_log=3, kernel_pad=1,
                            rs_est_mode="rRelMax",
                            use_batch_normalization=True)
        params = init_network(jax.random.PRNGKey(0), cfg)
        assert not any(k.startswith("bn") for k in params), sorted(params)


def test_fit_chunked_matches_per_step_trainer(tiny_data, monkeypatch):
    """The scan-chunked device-resident trainer must reproduce the
    per-step trainer exactly: same batches (dynamic_slice of the
    wrap-padded set vs elementwise modulo), same per-step RNG, same
    optimizer trajectory."""
    from reflectance_filtering.train import loop as L
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    lcfg = LossConfig()
    st_chunked = fit(cfg, lcfg, tiny_data, iterations=40, batch_size=4,
                     base_lr=0.01, random_seed=7)
    monkeypatch.setattr(L, "DEVICE_FEED_SHARE", 0)  # the per-step path
    st_step = fit(cfg, lcfg, tiny_data, iterations=40, batch_size=4,
                  base_lr=0.01, random_seed=7)
    la = jax.tree_util.tree_leaves(st_chunked.params)
    lb = jax.tree_util.tree_leaves(st_step.params)
    assert len(la) == len(lb)
    for va, vb in zip(la, lb):
        np.testing.assert_allclose(np.asarray(va), np.asarray(vb),
                                   rtol=2e-5, atol=1e-7)


def test_fit_dataset_smaller_than_batch_wraps(tiny_data):
    """n < batch_size uses the per-step trainer (the wrap-padded slice
    is only equivalent for n >= batch_size) and cycles correctly."""
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=1,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    small = {"images": tiny_data["images"][:3],
             "comparisons": tiny_data["comparisons"][:3]}
    st = fit(cfg, LossConfig(), small, iterations=20, batch_size=4,
             base_lr=0.01, random_seed=1)
    assert st.samples == 20
    assert all(np.isfinite(np.asarray(l)).all()
               for l in jax.tree_util.tree_leaves(st.params))


def test_fit_live_val_whdr(tiny_data, tmp_path):
    """Live validation WHDR (reference: interleaved test phase +
    progressbar 'Test' field): val_fn runs at every checkpoint save and
    the value rides the metric stream of subsequent steps."""
    from reflectance_filtering.train.loop import make_val_whdr_fn

    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    # val split with a size that is NOT a batch multiple (exercises the
    # wrap-pad + mask)
    val = {"images": tiny_data["images"][:5],
           "comparisons": tiny_data["comparisons"][:5]}
    val_fn = make_val_whdr_fn(cfg, val, batch_size=4)
    seen = []
    evals = []

    def spy(params):
        v = val_fn(params)
        evals.append(v)
        return v

    def track(step, samples, metrics):
        seen.append((step, metrics.get("val_whdr")))

    ck = Checkpointer(str(tmp_path), "d", interval=16)
    fit(cfg, LossConfig(), tiny_data, iterations=48, batch_size=4,
        base_lr=0.01, random_seed=0, checkpointer=ck, progress=track,
        val_fn=spy)
    # checkpoints at 16/32/48 samples -> three evals
    assert len(evals) == 3
    assert all(0.0 <= v <= 1.0 for v in evals)
    # steps strictly after the first checkpoint carry val_whdr; the ones
    # before it don't
    before = [v for s, v in seen if s < 4]
    after = [v for s, v in seen if s >= 5]
    assert all(v is None for v in before)
    assert after and all(v is not None for v in after)
    assert after[0] == evals[0]


def test_make_val_whdr_matches_direct_whdr(tiny_data):
    """The scan-batched evaluator equals a direct per-image computation
    (pad rows masked out)."""
    from reflectance_filtering.train.loop import make_val_whdr_fn
    from reflectance_filtering.losses.whdr import whdr_per_image
    from reflectance_filtering.models.networks import apply_network

    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(1), cfg)
    val = {"images": tiny_data["images"][:5],
           "comparisons": tiny_data["comparisons"][:5]}
    got = make_val_whdr_fn(cfg, val, batch_size=2)(params)
    blobs = apply_network(params, jnp.asarray(val["images"]), cfg,
                          train=False)
    refl = jax.nn.relu(blobs["RS_est"])
    exp = float(jnp.mean(whdr_per_image(
        refl, jnp.asarray(val["comparisons"]), 0.1)))
    assert got == pytest.approx(exp, rel=1e-5, abs=1e-6)


def test_checkpointer_crossing_rule(tmp_path):
    """would_save with prev fires on interval-boundary CROSSINGS, so a
    resume whose batch size walks off the old sample grid still
    snapshots (plain modulo never fires at base + k*new_bs there)."""
    cfg = NetworkConfig(network_type="convStatic", num_layers=1,
                        num_filters_log=2, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    ck = Checkpointer(str(tmp_path), "desc", interval=40)
    # back-compat exact-multiple rule without prev
    assert ck.would_save(40) and not ck.would_save(50)
    # crossing rule
    assert ck.would_save(50, prev=18)        # crosses 40
    assert not ck.would_save(30, prev=18)    # no boundary in (18, 30]
    assert ck.would_save(80, prev=79)        # exact multiple still fires
    assert not ck.would_save(81, prev=80)    # boundary already behind
    p = ck.maybe_save(50, params, prev=18)
    assert p and p.endswith("desc_barrista_iter_50.npz")


def test_parse_description_extensionless_checkpoint_name():
    """A checkpoint name passed WITHOUT its extension must not be
    truncated at the dot inside the lr digits ('ADAM0.001')."""
    args = _args()
    _, desc = get_description(args)
    parsed = parse_description(desc + "_barrista_iter_10000")
    assert parsed["iterations"] == 10000
    assert parsed["networkType"] == args.networkType
    assert parsed["base_lr"] == args.base_lr
    assert parsed["height"] == 256 and parsed["dataset"] == "iiw"


def test_predict_and_score_tolerates_poisoned_cache(tiny_data, tmp_path):
    """An interrupted eval can leave an empty scores/*.txt; the next run
    must recompute instead of crashing on float('')."""
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(0), cfg)
    results_dir = str(tmp_path)
    n = tiny_data["images"].shape[0]
    os.makedirs(os.path.join(results_dir, "scores"))
    score_file = os.path.join(results_dir, "scores",
                              "desc_imgs{}.txt".format(n))
    with open(score_file, "w"):
        pass  # empty (killed mid-write)
    score = predict_and_score(tiny_data, params, cfg, results_dir, "desc",
                              batch_size=4)
    assert 0 <= score <= 100
    with open(score_file) as f:  # cache was repaired by the recompute
        assert float(f.readline()) == score


def test_make_val_whdr_host_fed_fallback(tiny_data, monkeypatch):
    """A val split over the HBM budget falls back to host-fed batches
    with the same value (up to reduction-order last bits)."""
    from reflectance_filtering.train import loop as L

    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=2,
                        num_filters_log=3, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(1), cfg)
    val = {"images": tiny_data["images"][:5],
           "comparisons": tiny_data["comparisons"][:5]}
    resident = L.make_val_whdr_fn(cfg, val, batch_size=2)(params)
    monkeypatch.setattr(L, "VAL_FEED_SHARE", 0)
    hosted = L.make_val_whdr_fn(cfg, val, batch_size=2)(params)
    assert hosted == pytest.approx(resident, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("stats,share,want", [
    ({"bytes_limit": 80 * 1024 ** 3}, 0.5, 40 * 1024 ** 3),
    ({"bytes_limit": 8000}, 0.125, 1000),
    (None, 0.5, 8 * 1024 ** 3),          # the CPU reports no stats
    ({"bytes_in_use": 5}, 0.125, 2 * 1024 ** 3),
    ({"bytes_limit": 8000}, 0, 0)])
def test_feed_budget_is_a_share_of_the_device_limit(monkeypatch, stats,
                                                    share, want):
    """fit()'s feed caps are shares of the device's bytes_limit, or of the
    stated host budget where the backend reports none."""
    from reflectance_filtering.train import loop as L

    class _Device:
        def memory_stats(self):
            return stats

    monkeypatch.setattr(L.jax, "devices", lambda: [_Device()])
    assert L.HOST_MEMORY_BUDGET_BYTES == 16 * 1024 ** 3
    assert L._feed_budget(share) == want
