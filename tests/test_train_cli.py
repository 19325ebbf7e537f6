"""End-to-end test of the train CLI on synthetic data (CPU mesh)."""
import json
import os
import shutil

import numpy as np
import pytest

from reflectance_filtering.data import builder as B
from reflectance_filtering.train.monitors import JsonlLogger, vis_square


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import cv2
    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(5)
    for fid in range(100, 120):
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(raw / "{}.png".format(fid)), img)
        points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
                   "opaque": True} for i in range(6)]
        comps = []
        for _ in range(6):
            a, b = rng.choice(6, 2, replace=False)
            comps.append({"point1": int(a), "point2": int(b),
                          "darker": str(rng.choice(["1", "2", "E"])),
                          "darker_score": float(rng.rand())})
        with open(str(raw / "{}.json".format(fid)), "w") as f:
            json.dump({"intrinsic_points": points,
                       "intrinsic_comparisons": comps}, f)

    lmdbs = tmp_path_factory.mktemp("lmdbs")
    (lmdbs / "iiw").mkdir()
    names = B.sorted_file_list(str(raw))
    train, val, test = B.narihira_split_three(names)
    for split, stem in ((train, "trainValTest_train"),
                        (val, "trainValTest_val"),
                        (test, "trainValTest_test")):
        B.build_dataset(str(raw), split, str(lmdbs / "iiw" / stem),
                        height=32, width=32, verbose=False)
    return str(lmdbs)


def test_fit_lifecycle(dataset, tmp_path):
    from reflectance_filtering.cli.train import main
    results_root = str(tmp_path / "results")
    main(["--stage=fit", "--iterations=16", "--batch_size=4",
          "--checkpoint_interval=8", "--networkType=convStaticSkipLayers",
          "--numLayers=2", "--num_filters_log=3", "--kernel_pad=0",
          "--RS_est_mode=rDirectly", "--height=32", "--width=32",
          "--experiment=t1", "--random_seed=0",
          "--data_root", dataset, "--results_root", results_root])

    exp = os.path.join(results_root, "t1")
    snaps = os.listdir(os.path.join(exp, "snapshots"))
    assert any("_barrista_iter_8.npz" in s for s in snaps)
    assert any("_barrista_iter_16.npz" in s for s in snaps)
    progs = os.listdir(os.path.join(exp, "progressions"))
    assert len(progs) == 1
    with open(os.path.join(exp, "progressions", progs[0])) as f:
        data = json.load(f)
    assert [e["NumIters"] for e in data["test"]] == [8, 16]
    assert os.listdir(os.path.join(exp, "scores"))
    assert os.listdir(os.path.join(exp, "framerates"))
    logs = os.listdir(os.path.join(exp, "logs"))
    assert len(logs) == 1
    with open(os.path.join(exp, "logs", logs[0])) as f:
        lines = [json.loads(l) for l in f]
    assert len(lines) == 4  # 16 samples / batch 4
    assert "loss_whdr_hinge" in lines[0]
    # networks dir records the architecture config + drawn layer DAG
    nets = os.listdir(os.path.join(exp, "networks"))
    assert any(f.endswith(".json") for f in nets)
    assert any(f.endswith(".png") for f in nets)


def test_checkpoint_interval_rounds_to_batch_multiple(dataset, tmp_path):
    """Snapshots happen on batch boundaries: an interval of 6 with batch 4
    must round down to 4 (the reference asserted multiples instead,
    extend_monitoring.py:84-86)."""
    from reflectance_filtering.cli.train import main
    results_root = str(tmp_path / "results")
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=6", "--networkType=convStaticSkipLayers",
          "--numLayers=1", "--num_filters_log=2", "--kernel_pad=0",
          "--RS_est_mode=rDirectly", "--height=32", "--width=32",
          "--experiment=ck", "--random_seed=0",
          "--data_root", dataset, "--results_root", results_root])
    snaps = os.listdir(os.path.join(results_root, "ck", "snapshots"))
    iters = sorted(int(s.rsplit("_", 1)[1].split(".")[0]) for s in snaps)
    assert iters == [4, 8]


def test_predict_decompose_from_checkpoint(dataset, tmp_path):
    import cv2
    from reflectance_filtering.cli.train import main
    results_root = str(tmp_path / "results")
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=8", "--networkType=convStaticSkipLayers",
          "--numLayers=2", "--num_filters_log=3", "--kernel_pad=0",
          "--RS_est_mode=rDirectly", "--height=32", "--width=32",
          "--experiment=t2", "--random_seed=0",
          "--data_root", dataset, "--results_root", results_root])
    exp = os.path.join(results_root, "t2")
    snap = [s for s in os.listdir(os.path.join(exp, "snapshots"))
            if s.endswith("_8.npz")][0]

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    cv2.imwrite(str(img_dir / "a.png"),
                (rng.rand(20, 20, 3) * 255).astype(np.uint8))

    main(["--stage=predict", "--height=32", "--width=32",
          "--predictCaffemodel", os.path.join(exp, "snapshots", snap),
          "--decompose", str(img_dir),
          "--experiment=t2", "--data_root", dataset,
          "--results_root", results_root])
    assert os.path.isfile(os.path.join(exp, "decompositions_linear",
                                       "a-r.png"))
    assert os.path.isfile(os.path.join(exp, "decompositions_sRGB",
                                       "a-s.png"))
    # 0command.txt audit log
    assert os.path.isfile(os.path.join(exp, "decompositions_linear",
                                       "0command.txt"))


def test_predict_without_size_flags_uses_checkpoint_size(dataset, tmp_path):
    """Predict-and-score with NO --height/--width: the sizes come from
    the checkpoint filename (round-5 fix — previously the val blob
    loaded at the 256x256 default and the run died)."""
    from reflectance_filtering.cli.train import main
    results_root = str(tmp_path / "results")
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=8", "--networkType=convStaticSkipLayers",
          "--numLayers=1", "--num_filters_log=2", "--kernel_pad=0",
          "--RS_est_mode=rDirectly", "--height=32", "--width=32",
          "--experiment=t3", "--random_seed=0",
          "--data_root", dataset, "--results_root", results_root])
    exp = os.path.join(results_root, "t3")
    snap = [s for s in os.listdir(os.path.join(exp, "snapshots"))
            if s.endswith("_8.npz")][0]
    main(["--stage=predict",
          "--predictCaffemodel", os.path.join(exp, "snapshots", snap),
          "--experiment=t3", "--data_root", dataset,
          "--results_root", results_root])
    scores = os.listdir(os.path.join(exp, "scores"))
    assert any(snap.replace(".npz", "") in s for s in scores)


def test_predict_decompose_accepts_raw_caffemodel_name(tmp_path,
                                                        seeded_caffemodel):
    """The reference's learned_weights.caffemodel has no config-encoding
    name; predict must not crash on the parse — network args come from
    the CLI flags (the reference contract for .caffemodel inputs), and
    a decompose-only run needs no dataset at all."""
    import cv2
    from reflectance_filtering.cli.train import main
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    cv2.imwrite(str(img_dir / "b.png"),
                (rng.rand(20, 20, 3) * 255).astype(np.uint8))
    results_root = str(tmp_path / "results")
    weights = str(tmp_path / "learned_weights.caffemodel")
    shutil.copy(seeded_caffemodel, weights)
    main(["--stage=predict",
          "--predictCaffemodel", weights,
          "--networkType=convStaticSkipLayers", "--numLayers=5",
          "--num_filters_log=5", "--kernel_pad=0",
          "--RS_est_mode=rDirectly",
          "--decompose", str(img_dir),
          "--experiment=cm", "--data_root", str(tmp_path / "nodata"),
          "--results_root", results_root])
    exp = os.path.join(results_root, "cm")
    assert os.path.isfile(os.path.join(exp, "decompositions_linear",
                                       "b-r.png"))


def test_resume_matches_uninterrupted(dataset, tmp_path):
    """startOver=0 resume: train(8)+resume-to-16 must equal train(16) —
    params, optimizer state, data cursor, and RNG stream all continue."""
    import jax
    from reflectance_filtering.cli.train import main
    from reflectance_filtering.cli.train import net_config_from_args
    from reflectance_filtering.train.checkpoint import load_checkpoint
    from reflectance_filtering.models.networks import init_network

    common = ["--batch_size=4", "--checkpoint_interval=8",
              "--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--random_seed=0", "--data_root", dataset]

    root_a = str(tmp_path / "a")
    main(["--stage=fit", "--iterations=16", "--experiment=full",
          "--results_root", root_a] + common)

    root_b = str(tmp_path / "b")
    main(["--stage=fit", "--iterations=8", "--experiment=res",
          "--results_root", root_b] + common)
    main(["--stage=fit", "--iterations=16", "--startOver=0",
          "--experiment=res", "--results_root", root_b] + common)

    def final_params(root, exp):
        snapdir = os.path.join(root, exp, "snapshots")
        snap = [s for s in os.listdir(snapdir) if s.endswith("_16.npz")][0]
        cfg_args = type("A", (), dict(
            networkType="convStaticSkipLayers", numLayers=1,
            num_filters_log=2, kernel_pad=0, dilation=1,
            use_batch_normalization=0, RS_est_mode="rDirectly"))
        template = init_network(jax.random.PRNGKey(0),
                                net_config_from_args(cfg_args))
        p, _, _ = load_checkpoint(os.path.join(snapdir, snap), template)
        return p

    pa = final_params(root_a, "full")
    pb = final_params(root_b, "res")
    for la, lb in zip(jax.tree_util.tree_leaves(pa),
                      jax.tree_util.tree_leaves(pb)):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb),
                                   rtol=0, atol=1e-6)


def test_resume_skips_when_complete(dataset, tmp_path, capsys):
    """startOver=0 with a snapshot >= iterations skips training (the old
    eval-only behavior is preserved)."""
    from reflectance_filtering.cli.train import main
    root = str(tmp_path / "r")
    common = ["--batch_size=4", "--checkpoint_interval=8",
              "--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--random_seed=0", "--data_root", dataset,
              "--results_root", root, "--experiment=done"]
    main(["--stage=fit", "--iterations=8"] + common)
    main(["--stage=fit", "--iterations=8", "--startOver=0"] + common)
    assert "skipping training" in capsys.readouterr().out


def test_resume_skip_with_different_batch_size(dataset, tmp_path):
    """Resume-complete with changed --batch_size: the expected final
    checkpoint (iterations//bs*bs) was never written by the first run;
    the eval must fall back to the snapshots that exist instead of
    crashing with FileNotFoundError."""
    import os

    from reflectance_filtering.cli.train import main
    root = str(tmp_path / "r")
    common = ["--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--random_seed=0", "--data_root", dataset,
              "--results_root", root, "--experiment=resk"]
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=8"] + common)
    # 8//3*3 = 6: no such snapshot; must evaluate the existing iter-8 one
    main(["--stage=fit", "--iterations=8", "--batch_size=3",
          "--checkpoint_interval=8", "--startOver=0"] + common)
    scores = os.listdir(os.path.join(root, "resk", "scores"))
    assert any("iter_8" in s for s in scores)


def test_iterations_below_batch_size_raises(dataset, tmp_path):
    """iterations < batch_size would run zero steps and then crash on a
    missing checkpoint; it must fail loudly up front instead."""
    from reflectance_filtering.cli.train import main
    with pytest.raises(ValueError, match="batch_size"):
        main(["--stage=fit", "--iterations=2", "--batch_size=4",
              "--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--experiment=bad", "--random_seed=0",
              "--data_root", dataset,
              "--results_root", str(tmp_path / "x")])


def test_sintel_dataset_fails_loudly(dataset, tmp_path):
    """The reference's sintel mode silently trains on nothing (its WHDR
    layers never read the albedos bottom); we raise instead."""
    from reflectance_filtering.cli.train import main
    for ds in ("sintel", "mixed"):
        with pytest.raises(NotImplementedError, match="albedo"):
            main(["--stage=fit", "--iterations=8", "--batch_size=4",
                  "--dataset={}".format(ds),
                  "--networkType=convStaticSkipLayers", "--numLayers=1",
                  "--num_filters_log=2", "--kernel_pad=0",
                  "--RS_est_mode=rDirectly", "--height=32", "--width=32",
                  "--experiment=sin", "--random_seed=0",
                  "--data_root", dataset,
                  "--results_root", str(tmp_path / "s")])


def test_jsonl_logger(tmp_path):
    lg = JsonlLogger(str(tmp_path), "x")
    lg(0, {"loss": 1.5, "name": "skip-me"})
    lg(1, {"loss": 1.0})
    lg.close()
    with open(lg.path) as f:
        lines = [json.loads(l) for l in f]
    assert lines == [{"step": 0, "loss": 1.5}, {"step": 1, "loss": 1.0}]


def test_vis_square_shape():
    data = np.random.RandomState(0).rand(10, 5, 5)
    out = vis_square(data)
    assert out.shape == (4 * 6, 4 * 6)  # ceil(sqrt(10))=4 tiles + pads
    assert out.min() >= 0 and out.max() <= 1


def test_filter_visualizations_written(dataset, tmp_path):
    """The images/ artifact dir gets a vis_square filter grid per
    checkpoint (the reference created the dir but left its _vis_square
    helper unwired)."""
    from reflectance_filtering.cli.train import main
    results_root = str(tmp_path / "results")
    main(["--stage=fit", "--iterations=8", "--batch_size=4",
          "--checkpoint_interval=4", "--networkType=convStaticSkipLayers",
          "--numLayers=1", "--num_filters_log=2", "--kernel_pad=0",
          "--RS_est_mode=rDirectly", "--height=32", "--width=32",
          "--experiment=viz", "--random_seed=0",
          "--data_root", dataset, "--results_root", results_root])
    imgs = os.listdir(os.path.join(results_root, "viz", "images"))
    assert any(i.startswith("filters_iter_") for i in imgs)


def test_resume_with_different_batch_size_evals_real_snapshots(
        dataset, tmp_path):
    """A --startOver=0 resume with a new batch_size produces snapshot
    sample counts off the old grid; the post-fit eval sweep must target
    the snapshots that actually exist, not an arithmetic grid."""
    from reflectance_filtering.cli.train import main
    common = ["--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--random_seed=0", "--data_root", dataset]
    root = str(tmp_path / "rb")
    main(["--stage=fit", "--iterations=12", "--batch_size=4",
          "--checkpoint_interval=8", "--experiment=rb",
          "--results_root", root] + common)
    # resume with batch_size=6: samples go 12 -> 18 -> 24 (never a
    # multiple of the old interval grid except by luck)
    main(["--stage=fit", "--iterations=24", "--batch_size=6",
          "--checkpoint_interval=12", "--startOver=0",
          "--experiment=rb", "--results_root", root] + common)
    import json as _json
    prog = os.path.join(root, "rb", "progressions")
    data = _json.load(open(os.path.join(
        prog, sorted(os.listdir(prog))[-1])))
    evaluated = {e["NumIters"] for e in data["test"]}
    snaps = {int(f.rsplit("_", 1)[1][:-4])
             for f in os.listdir(os.path.join(root, "rb", "snapshots"))}
    assert evaluated, "eval sweep produced no entries"
    assert evaluated <= snaps  # only real snapshots were evaluated


def test_resume_off_grid_batch_size_still_snapshots(dataset, tmp_path):
    """The review scenario: resume with a batch size whose sample counts
    never hit the interval grid (base=12, bs=5 -> 17, 22, 27; old
    modulo rule wrote NO intermediate snapshot until finalize)."""
    from reflectance_filtering.cli.train import main
    common = ["--networkType=convStaticSkipLayers", "--numLayers=1",
              "--num_filters_log=2", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--height=32", "--width=32",
              "--random_seed=0", "--data_root", dataset]
    root = str(tmp_path / "og")
    main(["--stage=fit", "--iterations=12", "--batch_size=4",
          "--checkpoint_interval=12", "--experiment=og",
          "--results_root", root] + common)
    main(["--stage=fit", "--iterations=27", "--batch_size=5",
          "--checkpoint_interval=5", "--startOver=0",
          "--experiment=og", "--results_root", root] + common)
    snaps = {int(f.rsplit("_", 1)[1][:-4])
             for f in os.listdir(os.path.join(root, "og", "snapshots"))}
    # every resumed step crosses a 5-boundary: 17, 22 intermediate
    # (off-grid!) plus the finalize at 27
    assert {17, 22, 27} <= snaps, snaps


def test_predict_stage_without_checkpoint_fails_loudly(dataset, tmp_path):
    """--stage=predict with no --predictCaffemodel used to be a silent
    no-op (exit 0, nothing predicted)."""
    from reflectance_filtering.cli.train import main
    with pytest.raises(ValueError, match="predictCaffemodel"):
        main(["--stage=predict", "--experiment=np",
              "--results_root", str(tmp_path / "np"),
              "--height=32", "--width=32", "--data_root", dataset])
