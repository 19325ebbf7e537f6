"""WHDR / hinge loss tests against direct loop-based oracles.

The oracles re-state the reference layer math (whdr_layer.py:253-287,
whdr_hinge_loss_layer.py:126-230) as plain Python loops, written
independently of the vectorized implementation.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from reflectance_filtering.losses.whdr import (
    whdr, whdr_batch, whdr_hinge, whdr_hinge_batch, parse_wdm_string, EPS)
from reflectance_filtering.losses.losses import boundary_loss, lambert_loss

K = 40  # padded comparison capacity for tests


def make_blob(comps, k=K):
    """Build the reference's padded [K+1, 6] blob
    (createNumpyArrayWithComparisonsForIIW.py:616-649)."""
    blob = np.full((k + 1, 6), np.nan, np.float32)
    for i, c in enumerate(comps):
        blob[i] = c
    blob[k, 0] = len(comps)
    blob[k, 1] = 12345.0  # file name
    blob[k, 2] = 0
    return blob


def random_comps(rng, n, darker_choices=(0, 1, 2)):
    comps = []
    for _ in range(n):
        comps.append([rng.rand(), rng.rand(), rng.rand(), rng.rand(),
                      rng.choice(darker_choices), rng.rand()])
    return comps


def _lightness(r):
    if len(r) == 3:
        return max(EPS, np.mean(r))
    return max(EPS, float(r[0]))


def oracle_whdr(refl_hwc, blob, h, w, delta=0.1):
    """whdr_layer.py:253-287 as a loop (reflectance HWC here)."""
    num = int(blob[-1, 0])
    error_sum = weight_sum = 0.0
    for c in range(num):
        x1 = int(blob[c, 0] * w); y1 = int(blob[c, 1] * h)
        x2 = int(blob[c, 2] * w); y2 = int(blob[c, 3] * h)
        darker = int(blob[c, 4]); weight = blob[c, 5]
        l1 = _lightness(refl_hwc[y1, x1])
        l2 = _lightness(refl_hwc[y2, x2])
        if l2 / l1 > 1 + delta:
            alg = 1
        elif l1 / l2 > 1 + delta:
            alg = 2
        else:
            alg = 0
        if darker != alg:
            error_sum += weight
        weight_sum += weight
    return error_sum / weight_sum if weight_sum else 0.0


def oracle_hinge(refl_hwc, blob, h, w, delta=0.1, margin=0.05,
                 ratio=1.0, eval_dense=1):
    """whdr_hinge_loss_layer.py:126-230 forward as a loop."""
    num = int(blob[-1, 0])
    if not eval_dense and num > 300:
        num = 1
    if ratio < 1.0:
        num = int(np.ceil(ratio * num))
    error_sum = weight_sum = 0.0
    for c in range(num):
        x1 = int(blob[c, 0] * w); y1 = int(blob[c, 1] * h)
        x2 = int(blob[c, 2] * w); y2 = int(blob[c, 3] * h)
        darker = int(blob[c, 4]); weight = blob[c, 5]
        l1 = _lightness(refl_hwc[y1, x1])
        l2 = _lightness(refl_hwc[y2, x2])
        y = l1 / l2
        if darker == 1:
            border = 1 / (1 + delta + margin)
            loss_y = max(0.0, y - border)
        elif darker == 2:
            border = 1 + delta + margin
            loss_y = max(0.0, border - y)
        else:
            if margin <= delta:
                br = 1 + delta - margin
                if y > br:
                    loss_y = y - br
                else:
                    bl = 1 / br
                    loss_y = max(0.0, bl - y)
            else:
                border = 1 + delta - margin
                loss_y = max(1 / border - y, y - border)
        error_sum += weight * loss_y
        weight_sum += weight
    return error_sum / weight_sum if weight_sum else 0.0


@pytest.mark.parametrize("channels", [1, 3])
def test_whdr_matches_oracle(channels, rng):
    h, w = 24, 31
    refl = rng.rand(h, w, channels).astype(np.float32) + 0.05
    blob = make_blob(random_comps(rng, 25))
    got = float(whdr(jnp.asarray(refl), jnp.asarray(blob)))
    exp = oracle_whdr(refl, blob, h, w)
    assert abs(got - exp) < 1e-6


def test_whdr_zero_comparisons(rng):
    refl = rng.rand(8, 8, 3).astype(np.float32)
    blob = make_blob([])
    assert float(whdr(jnp.asarray(refl), jnp.asarray(blob))) == 0.0


def test_whdr_batch_mean(rng):
    h, w = 16, 16
    refl = rng.rand(3, h, w, 3).astype(np.float32) + 0.05
    blobs = np.stack([make_blob(random_comps(rng, n)) for n in (5, 17, 0)])
    got = float(whdr_batch(jnp.asarray(refl), jnp.asarray(blobs)))
    exp = np.mean([oracle_whdr(refl[b], blobs[b], h, w) for b in range(3)])
    assert abs(got - exp) < 1e-6


@pytest.mark.parametrize("delta,margin", [(0.1, 0.05), (0.1, 0.0),
                                          (0.12, 0.08), (0.05, 0.08)])
def test_hinge_matches_oracle(delta, margin, rng):
    h, w = 20, 25
    refl = rng.rand(h, w, 3).astype(np.float32) + 0.05
    blob = make_blob(random_comps(rng, 30))
    got = float(whdr_hinge(jnp.asarray(refl), jnp.asarray(blob),
                           delta, margin))
    exp = oracle_hinge(refl, blob, h, w, delta, margin)
    assert abs(got - exp) < 1e-5


def test_hinge_ratio_subsampling(rng):
    h, w = 20, 20
    refl = rng.rand(h, w, 3).astype(np.float32) + 0.05
    blob = make_blob(random_comps(rng, 30))
    got = float(whdr_hinge(jnp.asarray(refl), jnp.asarray(blob),
                           ratio=0.5))
    exp = oracle_hinge(refl, blob, h, w, ratio=0.5)
    assert abs(got - exp) < 1e-5


def test_hinge_dense_skip(rng):
    """eval_dense=0 and n>300 -> only first comparison evaluated."""
    h, w = 20, 20
    k = 350
    refl = rng.rand(h, w, 3).astype(np.float32) + 0.05
    blob = make_blob(random_comps(rng, 320), k=k)
    got = float(whdr_hinge(jnp.asarray(refl), jnp.asarray(blob),
                           eval_dense=False))
    exp = oracle_hinge(refl, blob, h, w, eval_dense=0)
    assert abs(got - exp) < 1e-5


def test_hinge_gradient_matches_finite_difference(rng):
    h, w = 10, 12
    refl = (rng.rand(h, w, 3).astype(np.float32) + 0.1)
    blob = jnp.asarray(make_blob(random_comps(rng, 12)))

    f = lambda r: whdr_hinge(r, blob)
    g = jax.grad(f)(jnp.asarray(refl))
    # central differences on a few random entries
    eps = 1e-3
    for _ in range(10):
        i, j, c = rng.randint(h), rng.randint(w), rng.randint(3)
        d = np.zeros_like(refl)
        d[i, j, c] = eps
        fd = (float(f(jnp.asarray(refl + d))) -
              float(f(jnp.asarray(refl - d)))) / (2 * eps)
        assert abs(float(g[i, j, c]) - fd) < 1e-3, (i, j, c)


def test_hinge_gradient_matches_reference_formula(rng):
    """Hand gradient of whdr_hinge_loss_layer.py:164-230 for one comparison."""
    h, w = 8, 8
    refl = rng.rand(h, w, 3).astype(np.float32) + 0.2
    # one comparison, darker=1, chosen to be in the active hinge region
    x1, y1, x2, y2 = 2, 3, 5, 6
    refl[y1, x1] = 0.9  # L1 bright -> y = L1/L2 large -> active
    refl[y2, x2] = 0.3
    weight = 0.7
    blob = make_blob([[x1 / w, y1 / h, x2 / w, y2 / h, 1, weight]])

    g = jax.grad(lambda r: whdr_hinge(r, jnp.asarray(blob)))(
        jnp.asarray(refl))
    g = np.asarray(g)

    L1 = max(EPS, refl[y1, x1].mean())
    L2 = max(EPS, refl[y2, x2].mean())
    dldy = 1.0  # active region, darker=1
    dydL1 = 1.0 / L2
    dydL2 = -(L1 / L2) / L2
    dLdR = 1.0 / 3.0
    expected1 = weight * dldy * dydL1 * dLdR / weight
    expected2 = weight * dldy * dydL2 * dLdR / weight
    np.testing.assert_allclose(g[y1, x1], expected1, rtol=1e-4)
    np.testing.assert_allclose(g[y2, x2], expected2, rtol=1e-4)
    # gradient elsewhere is zero
    mask = np.ones((h, w), bool)
    mask[y1, x1] = mask[y2, x2] = False
    assert np.abs(g[mask]).max() == 0.0


def test_parse_wdm_string():
    assert parse_wdm_string("0.1_0.05_1.0_1") == (0.1, 0.05, 1.0, True)
    assert parse_wdm_string("") == (0.1, 0.0, 1.0, True)
    with pytest.raises(ValueError):
        parse_wdm_string("0.1_0.05")


def test_hinge_batch(rng):
    h, w = 12, 12
    refl = rng.rand(2, h, w, 3).astype(np.float32) + 0.05
    blobs = np.stack([make_blob(random_comps(rng, 9)),
                      make_blob(random_comps(rng, 14))])
    got = float(whdr_hinge_batch(jnp.asarray(refl), jnp.asarray(blobs)))
    exp = np.mean([oracle_hinge(refl[b], blobs[b], h, w) for b in range(2)])
    assert abs(got - exp) < 1e-5


# ---------------------------------------------------------------------------
# boundary / lambert losses
# ---------------------------------------------------------------------------

def test_boundary_loss_l1_matches_reference(rng):
    rgb = (rng.rand(2, 8, 8, 3).astype(np.float32) - 0.25) * 2  # in [-0.5,1.5]
    got = float(boundary_loss(jnp.asarray(rgb), "L1"))
    intensity = rgb.mean(axis=-1)
    loss = np.zeros_like(intensity)
    loss[intensity < 0] = -intensity[intensity < 0]
    loss[intensity > 1] = intensity[intensity > 1] - 1
    assert abs(got - loss.mean()) < 1e-6


def test_boundary_loss_l2_matches_reference(rng):
    rgb = (rng.rand(2, 8, 8, 3).astype(np.float32) - 0.25) * 2
    got = float(boundary_loss(jnp.asarray(rgb), "L2"))
    intensity = rgb.mean(axis=-1)
    loss = np.zeros_like(intensity)
    loss[intensity < 0] = intensity[intensity < 0] ** 2
    loss[intensity > 1] = (intensity[intensity > 1] - 1) ** 2
    assert abs(got - loss.mean()) < 1e-6


def test_boundary_loss_gradient_tiled_third(rng):
    """Reference backprop tiles diff/3 to RGB (boundary_loss_layer.py:78)."""
    rgb = np.full((1, 4, 4, 3), 1.5, np.float32)
    g = np.asarray(jax.grad(lambda x: boundary_loss(x, "L1"))(
        jnp.asarray(rgb)))
    np.testing.assert_allclose(g, 1.0 / (4 * 4 * 1) / 3, rtol=1e-6)


def test_lambert_loss_euclidean_semantics(rng):
    r = rng.rand(3, 5, 5, 3).astype(np.float32)
    s = rng.rand(3, 5, 5, 3).astype(np.float32)
    i = rng.rand(3, 5, 5, 3).astype(np.float32)
    got = float(lambert_loss(jnp.asarray(r), jnp.asarray(s), jnp.asarray(i)))
    exp = np.sum((r * s - i) ** 2) / (2 * 3)
    assert abs(got - exp) < 1e-4


def test_ratio_subsample_count_matches_reference_float64():
    """The subsample count must be int(np.ceil(ratio * n)) in float64
    (whdr_hinge_loss_layer.py:139) — a float32 in-graph ceil overshoots
    by one on ~120 (ratio, n) pairs (e.g. 0.6*25 -> 16, f64 gives 15)."""
    import jax.numpy as jnp

    from reflectance_filtering.losses.whdr import _ratio_ceil

    n = np.arange(1182)
    for ratio in [0.1, 0.25, 0.3, 0.5, 0.6, 0.7, 0.9]:
        got = np.asarray(_ratio_ceil(jnp.asarray(n), ratio, 1181))
        exp = np.ceil(ratio * n.astype(np.float64)).astype(np.int32)
        np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# host-side evaluation selection (the augmented K=60k fast path)
# ---------------------------------------------------------------------------

def _rand_blob(rng, b, k, num):
    blob = np.full((b, k + 1, 6), np.nan, np.float32)
    for i in range(b):
        blob[i, :num, 0:4] = rng.rand(num, 4)
        blob[i, :num, 4] = rng.randint(0, 3, num)
        blob[i, :num, 5] = 0.1 + rng.rand(num)
        blob[i, k, 0] = num
        blob[i, k, 1] = 100 + i
        blob[i, k, 2] = 0
    return blob


def test_host_select_uncapped_is_identity_loss():
    """num <= cap: selection is the deterministic prefix, so the compact
    blob gives the EXACT full-blob hinge loss."""
    from reflectance_filtering.losses.whdr import (
        select_comparisons_host, whdr_hinge_batch)
    rng = np.random.RandomState(0)
    refl = jnp.asarray(rng.rand(2, 8, 9, 1).astype(np.float32))
    blob = _rand_blob(rng, 2, 40, 25)
    compact = select_comparisons_host(blob, 1.0, True,
                                      np.random.RandomState(1), cap=30)
    full = float(whdr_hinge_batch(refl, jnp.asarray(blob)))
    comp = float(whdr_hinge_batch(refl, jnp.asarray(compact)))
    assert full == comp


def test_host_select_cap_matches_manual_weighted_mean():
    """num > cap: the compact-blob loss equals the weighted mean over
    exactly the selected rows (and the selection is a uniform
    no-replacement draw from the first num_eval rows)."""
    from reflectance_filtering.losses.whdr import (
        select_comparisons_host, whdr_hinge_batch)
    rng = np.random.RandomState(3)
    refl = jnp.asarray(rng.rand(1, 8, 9, 1).astype(np.float32))
    blob = _rand_blob(rng, 1, 60, 50)
    compact = select_comparisons_host(blob, 1.0, True,
                                      np.random.RandomState(7), cap=20)
    assert compact.shape == (1, 21, 6)
    assert compact[0, 20, 0] == 20
    # every selected row is one of the first 50 originals
    orig = {tuple(r) for r in blob[0, :50].tolist()}
    assert all(tuple(r) in orig for r in compact[0, :20].tolist())
    # loss equals the masked full-blob loss for the SAME selection:
    # rebuild the full blob keeping only the selected rows
    kept = {tuple(r) for r in compact[0, :20].tolist()}
    masked = blob.copy()
    for j in range(50):
        if tuple(blob[0, j].tolist()) not in kept:
            masked[0, j, 5] = 0.0  # zero weight drops it from the mean
    got = float(whdr_hinge_batch(refl, jnp.asarray(compact)))
    exp = float(whdr_hinge_batch(refl, jnp.asarray(masked)))
    np.testing.assert_allclose(got, exp, rtol=2e-6)


def test_host_select_applies_dense_skip_and_ratio():
    from reflectance_filtering.losses.whdr import (
        select_comparisons_host, DENSE_SKIP_THRESHOLD)
    rng = np.random.RandomState(5)
    blob = _rand_blob(rng, 1, 400, DENSE_SKIP_THRESHOLD + 50)
    out = select_comparisons_host(blob, 1.0, False,
                                  np.random.RandomState(0), cap=500)
    assert out[0, 500, 0] == 1  # dense-skip: one comparison only
    out2 = select_comparisons_host(blob, 0.5, True,
                                   np.random.RandomState(0), cap=500)
    assert out2[0, 500, 0] == int(np.ceil(0.5 * (DENSE_SKIP_THRESHOLD
                                                 + 50)))


def test_fit_host_select_path_runs_and_is_deterministic():
    """An oversized blob (K > 1500) routes fit() through the host-side
    selection + compact-feed trainer; same seed => identical params."""
    from reflectance_filtering.models.networks import NetworkConfig
    from reflectance_filtering.train.loop import LossConfig, fit
    rng = np.random.RandomState(2)
    k = 1520
    X = {"images": rng.rand(4, 16, 16, 3).astype(np.float32),
         "augmented": _rand_blob(rng, 4, k, 1510),
         "comparisons": _rand_blob(rng, 4, 30, 12)}
    cfg = NetworkConfig(num_layers=2, num_filters_log=2)
    kwargs = dict(iterations=4, batch_size=2, random_seed=11,
                  comparisons_type="augmented")
    s1 = fit(cfg, LossConfig(), X, **kwargs)
    s2 = fit(cfg, LossConfig(), X, **kwargs)
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
