"""Data builder/loader tests on synthetic IIW-style fixtures.

The Floyd–Warshall oracle below is the reference's sequential triple loop
(createNumpyArrayWithComparisonsForIIW.py:536-613) restated; the vectorized
builder version must agree exactly (same RandomState for the pruning draw).
"""
import json
import os

import numpy as np
import pytest

from reflectance_filtering.data import builder as B
from reflectance_filtering.data.loader import get_data


# ---------------------------------------------------------------------------
# synthetic IIW fixture
# ---------------------------------------------------------------------------

def _write_iiw_file(folder, file_id, rng, n_points=6, n_comps=8, size=(32, 40)):
    import cv2
    h, w = size
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    cv2.imwrite(os.path.join(folder, file_id + ".png"), img[:, :, ::-1])
    points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
               "opaque": True} for i in range(n_points)]
    comps = []
    for _ in range(n_comps):
        p1, p2 = rng.choice(n_points, 2, replace=False)
        comps.append({"point1": int(p1), "point2": int(p2),
                      "darker": rng.choice(["1", "2", "E"]),
                      "darker_score": float(rng.rand())})
    with open(os.path.join(folder, file_id + ".json"), "w") as f:
        json.dump({"intrinsic_points": points,
                   "intrinsic_comparisons": comps}, f)
    return img


@pytest.fixture(scope="module")
def iiw_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("iiw"))
    rng = np.random.RandomState(11)
    ids = ["100", "101", "102", "103", "104", "105"]
    for fid in ids:
        _write_iiw_file(d, fid, rng)
    return d, ids


# ---------------------------------------------------------------------------
# packing format
# ---------------------------------------------------------------------------

def test_comparisons_to_matrix_layout():
    points = {1: [0.25, 0.5, True], 2: [0.75, 0.1, True]}
    comps = [(1, 2, 2, 0.9)]
    blob = B.comparisons_to_matrix(comps, "118495", points, 10)
    assert blob.shape == (11, 6)
    np.testing.assert_array_equal(blob[0], [0.25, 0.5, 0.75, 0.1, 2, 0.9])
    assert np.isnan(blob[1:10]).all()
    assert blob[10, 0] == 1
    assert blob[10, 1] == 118495.0
    assert blob[10, 2] == 0


def test_build_and_load_roundtrip(iiw_dir, tmp_path):
    d, ids = iiw_dir
    out = B.build_dataset(d, ids[:3], str(tmp_path / "mini"),
                          height=16, width=16, verbose=False)
    assert os.path.isfile(out["sRGB"]) and os.path.isfile(out["linear"])

    with np.load(out["sRGB"]) as npz:
        assert npz["images"].shape == (3, 3, 16, 16)
        assert npz["comparisons"].shape == (3, B.MAX_NUM_COMPARISONS + 1, 1, 6)
        assert npz["images"].min() >= B.FLOOR
        # metadata rows carry file ids
        assert npz["comparisons"][0, -1, 0, 1] == float(ids[0])

    # linear variant is srgb_to_rgb of the sRGB one (floored)
    from reflectance_filtering.utils.image import srgb_to_rgb
    with np.load(out["sRGB"]) as a, np.load(out["linear"]) as b:
        np.testing.assert_allclose(
            b["images"], np.maximum(srgb_to_rgb(a["images"]), B.FLOOR),
            rtol=1e-10)


def test_loader_layout(iiw_dir, tmp_path):
    d, ids = iiw_dir
    dsdir = tmp_path / "lmdbs" / "iiw"
    dsdir.mkdir(parents=True)
    B.build_dataset(d, ids[:2], str(dsdir / "dummy_train"),
                    height=16, width=16, verbose=False)
    data = get_data("iiw", "dummy_train_16_16_linear",
                    root=str(tmp_path / "lmdbs"))
    assert data["images"].shape == (2, 16, 16, 3)
    assert data["images"].dtype == np.float32
    assert data["comparisons"].shape == (2, B.MAX_NUM_COMPARISONS + 1, 6)


def test_loader_missing_file(tmp_path):
    with pytest.raises(IOError):
        get_data("iiw", "nope", root=str(tmp_path))


def test_loaded_comparisons_work_with_whdr(iiw_dir, tmp_path):
    """The packed blob flows directly into the WHDR op."""
    import jax.numpy as jnp
    from reflectance_filtering.losses.whdr import whdr

    d, ids = iiw_dir
    dsdir = tmp_path / "l" / "iiw"
    dsdir.mkdir(parents=True)
    B.build_dataset(d, ids[:2], str(dsdir / "t"), height=16, width=16,
                    verbose=False)
    data = get_data("iiw", "t_16_16_linear", root=str(tmp_path / "l"))
    v = whdr(jnp.asarray(data["images"][0]),
             jnp.asarray(data["comparisons"][0]))
    assert 0.0 <= float(v) <= 1.0


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

def test_narihira_three_way_split():
    files = [str(i) for i in range(20)]
    train, val, test = B.narihira_split_three(files)
    assert test == [str(i) for i in range(20) if i % 5 == 0]
    assert val == [str(i) for i in range(20) if i % 5 and i % 10 == 6]
    assert len(train) + len(val) + len(test) == 20
    assert set(train).isdisjoint(val) and set(train).isdisjoint(test)


def test_big_train_mini_val_split():
    files = [str(i) for i in range(200)]
    train, val, test = B.big_train_mini_val_split(files)
    assert len(test) == 40
    assert val == ["6", "106"]
    assert len(train) == 158


def test_two_way_split():
    files = [str(i) for i in range(10)]
    train, test = B.narihira_split_two(files)
    assert test == ["0", "5"]
    assert len(train) == 8


# ---------------------------------------------------------------------------
# augmentation: unify / consolidate / warshall
# ---------------------------------------------------------------------------

def test_unify_semantics():
    comps = [(1, 2, 0, 0.5), (3, 4, 1, 0.7), (5, 6, 2, 0.9)]
    u = B.unify(comps)
    assert (1, 2, 0, 0.5) in u and (2, 1, 0, 0.5) in u
    assert (4, 3, 2, 0.7) in u          # a<b -> flipped to '<'
    assert (5, 6, 2, 0.9) in u


def test_consolidate_nan_propagation(rng):
    assert np.isnan(B.consolidate(np.nan, rng.rand()))
    assert np.isnan(B.consolidate(rng.rand(), np.nan))
    assert np.isnan(B.consolidate(np.nan, np.nan))
    assert np.isfinite(B.consolidate(rng.rand(), rng.rand()))
    assert B.consolidate(0.3, 0.8) == 0.3


def _oracle_warshall(a, method="min", seed=0):
    """Reference sequential triple loop (createNumpy...:536-613)."""
    rng = np.random.RandomState(seed)
    n = a.shape[1]
    for k in range(n):
        for i in range(n):
            for j in range(n):
                if i != j:
                    wik, wkj, wij = a[1, i, k], a[1, k, j], a[1, i, j]
                    wij_new = B.consolidate(wik, wkj, method)
                    if np.isfinite(wij_new) and \
                            (np.isnan(wij) or wij < wij_new):
                        if a[0, i, k] == a[0, k, j]:
                            a[0, i, j] = a[0, i, k]
                        else:
                            a[0, i, j] = 2
                        a[1, i, j] = wij_new
    for i in range(n):
        for j in range(n):
            if (a[0, i, j] == 2 and a[0, j, i] == 2) or \
                    (a[0, i, j] == 2 and a[0, j, i] == 0) or \
                    (a[0, i, j] == 0 and a[0, j, i] == 2):
                if a[1, i, j] > a[1, j, i]:
                    a[:, j, i] = np.nan
                else:
                    a[:, i, j] = np.nan
            if a[0, i, j] == 0 and a[0, j, i] == 0:
                if rng.rand() > 0.5:
                    a[:, j, i] = np.nan
                else:
                    a[:, i, j] = np.nan
    return a


def _random_relation_matrix(rng, n=7, density=0.3):
    a = np.full((2, n, n), np.nan)
    for i in range(n):
        for j in range(n):
            if i != j and rng.rand() < density:
                a[0, i, j] = rng.choice([0, 2])
                a[1, i, j] = rng.rand()
    return a


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_warshall_matches_sequential_oracle(seed):
    rng = np.random.RandomState(seed)
    a = _random_relation_matrix(rng, n=7)
    got = B.warshall(a.copy(), rng=np.random.RandomState(99))
    exp = _oracle_warshall(a.copy(), seed=99)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])


def test_augment_adds_transitive_edges():
    # 1 < 2 < 3 should imply 1 < 3 in the hull (as (3,1,'<') one-way form)
    comps = [(1, 2, 1, 0.9), (2, 3, 1, 0.8)]  # darker=1: first is darker
    aug = B.augment(comps, rng=np.random.RandomState(0))
    # unify: darker=1 -> (2,1,2), (3,2,2); closure adds (3,1,2) w=min=0.8
    assert any(a == 3 and b == 1 and r == 2 for a, b, r, _ in aug)
    w = [w for a, b, r, w in aug if a == 3 and b == 1][0]
    assert w == 0.8


def test_parallel_build_matches_sequential(iiw_dir, tmp_path):
    """workers>1 is race-free AND bit-identical to the sequential build
    for comparisons-only datasets (no RNG consumed) — unlike the
    reference's multiprocessing path, which it documents as corrupting
    output (README.md:104)."""
    d, ids = iiw_dir
    B.build_dataset(d, ids, str(tmp_path / "seq"), height=16, width=20,
                    seed=3, verbose=False)
    B.build_dataset(d, ids, str(tmp_path / "par"), height=16, width=20,
                    seed=3, verbose=False, workers=3)
    for variant in ("sRGB", "linear"):
        a = np.load(str(tmp_path / "seq_16_20_{}.npz".format(variant)))
        b = np.load(str(tmp_path / "par_16_20_{}.npz".format(variant)))
        for key in ("images", "comparisons", "augmented"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_parallel_augmented_build_deterministic(iiw_dir, tmp_path):
    """Augmented parallel builds use pre-drawn per-file seeds: any
    worker count and any scheduling give the same bytes for a seed."""
    d, ids = iiw_dir
    B.build_dataset(d, ids[:3], str(tmp_path / "a"), height=16, width=20,
                    augment_data=True, seed=5, verbose=False, workers=2)
    B.build_dataset(d, ids[:3], str(tmp_path / "b"), height=16, width=20,
                    augment_data=True, seed=5, verbose=False, workers=3)
    a = np.load(str(tmp_path / "a_16_20_sRGB.npz"))
    b = np.load(str(tmp_path / "b_16_20_sRGB.npz"))
    for key in ("images", "comparisons", "augmented"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert np.isfinite(a["augmented"][:, :, 0, 4]).sum() > 0
