#!/usr/bin/env python
"""Smoke run of the reflectance pipeline on one NVIDIA GPU.

    python chip_smoke.py               every one-card phase, on one card
    python chip_smoke.py --four-cards  the paths that span the host's cards
                                       (run on four), each against its
                                       one-card result

Drives the program through the entry points a user calls, at the flagship
model's full width (convStaticSkipLayers, 3->32x5->160->1) with seeded
stand-in weights written to and parsed from a caffemodel, and checks what
comes out against the plain references:

  1. device: JAX must run on a GPU (else exit 2, no result line);
  2. decompose: 16 seeded 256x256 PNGs through decompose_images, one
     through decompose_image; the Triton CNN kernel against the XLA
     float32 reference at 32x256x256 and on a 2160x3840 frame (<= 1 u8
     level and max |d| <= REFERENCE_ATOL on the float output), and the
     written -r.png bytes against a float64 numpy forward;
  3. filter CLI: bilateral c20 s22 (gray-self on -r.png, colour-self on a
     photo, joint (photo, -r.png)) and guided (r=45 eps=3, r=3 eps=45)
     against the plain references; the bilateral kernel against the
     reference on every image at 32x256x256 and on a 2160x3840 frame;
     the 3x guided chain on a 2160x3840 frame;
  4. WHDR: whdr_batch at K=1,181 against the Bell scorer;
  5. training: cli.train --stage=fit at the reference flags (5 layers,
     32 filters, batch 20) on a seeded IIW-style dataset written with
     numpy, then --stage=predict on the snapshot.

Timings, parity maxima and the card's name and power limit go on earlier
lines; the last line is one JSON object, {"ok": true, "device": {...}}.
Any failed phase exits 1.
"""
import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
H = W = 256
FRAME_4K = (2160, 3840)
FRAME_8K = (4320, 7680)
K_COMPS = 1181
TRITON_CALL = "__gpu$xla.gpu.triton"


def log(*parts):
    print(*parts, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def max_u8_diff(a, b):
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .max())


def timed(fn, *args, reps=3):
    """Median wall time of fn(*args) after a warm-up call, in ms."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * sorted(ts)[len(ts) // 2]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def seeded_photos(rng, n, h, w):
    """uint8 BGR images with a natural (1/f) spectrum."""
    from reflectance_filtering.utils.testimages import pink_noise
    return np.stack([np.stack([pink_noise(rng, h, w) for _ in range(3)], -1)
                     for _ in range(n)]).astype(np.uint8)


def phase_decompose(ctx):
    import jax
    import jax.numpy as jnp
    from reflectance_filtering.cli.decompose import (
        ReflectanceCNN, decompose_image, decompose_images)
    from reflectance_filtering.models.caffe_io import parse_caffemodel
    from reflectance_filtering.models.networks import (
        _reflectance_from_bgr_u8_reference, reflectance_from_bgr_u8)
    from reflectance_filtering.ops.cnn_triton import REFERENCE_ATOL
    from reflectance_filtering.utils import image as iu
    from reflectance_filtering.utils.testimages import flagship_forward64

    rng = np.random.RandomState(SEED)
    photos = seeded_photos(rng, 16, H, W)
    src_dir = os.path.join(ctx["work"], "photos")
    out_dir = os.path.join(ctx["work"], "decomposed")
    one_dir = os.path.join(ctx["work"], "decomposed_one")
    for d in (src_dir, out_dir, one_dir):
        os.makedirs(d)
    paths = []
    for i, img in enumerate(photos):
        paths.append(os.path.join(src_dir, "p%02d.png" % i))
        iu.imwrite(paths[-1], img)
    net = ReflectanceCNN(ctx["weights"])
    t0 = time.perf_counter()
    grays = decompose_images(paths, out_dir, net=net, batch_size=16)
    t_batch = time.perf_counter() - t0
    check(len(grays) == 16, "decompose_images returned %d images"
          % len(grays))
    for p in paths:
        base = os.path.splitext(os.path.basename(p))[0]
        for suffix in ("-r.png", "-r_colorized.png", "-s_colorized.png"):
            check(os.path.isfile(os.path.join(out_dir, base + suffix)),
                  "missing " + base + suffix)
    one = decompose_image(paths[3], one_dir, net)
    check(max_u8_diff(np.floor(one * 255), np.floor(grays[paths[3]] * 255))
          <= 1, "decompose_image disagrees with decompose_images")

    # the written -r.png bytes against a float64 forward off the blobs
    raw = parse_caffemodel(ctx["weights"])
    written = np.stack([iu.imread(os.path.join(
        out_dir, "p%02d-r.png" % i))[..., 0] for i in range(16)])
    want = np.floor(flagship_forward64(raw, photos) * 255.0)
    d_png = max_u8_diff(written, want)
    check(d_png <= 1, "-r.png vs float64 forward: %d levels" % d_png)
    log("  decompose_images 16x%dx%d: %.2f s (compile included); "
        "-r.png vs float64 forward: max %d level" % (H, W, t_batch, d_png))

    # the product forward (Triton kernel) vs the XLA float32 reference
    params = net.params
    product = jax.jit(lambda x: reflectance_from_bgr_u8(params, x))
    reference = jax.jit(lambda x: _reflectance_from_bgr_u8_reference(
        params, x))
    small = jnp.zeros((2, 3, 64, 64), jnp.uint8)
    check(TRITON_CALL in product.lower(small).as_text(),
          "the product CNN has no Triton call in its HLO")
    for n, (h, w) in ((32, (H, W)), (1, FRAME_4K)):
        x = jax.device_put(rng.randint(0, 256, (n, 3, h, w), np.uint8))
        got, exp = product(x), reference(x)
        d = max_u8_diff(jnp.floor(got * 255), jnp.floor(exp * 255))
        check(d <= 1, "CNN kernel vs reference at %s: %d levels"
              % ((n, h, w), d))
        # a TF32 dot passes the byte gate; the float bound catches it
        fd = float(jnp.abs(got - exp).max())
        check(fd <= REFERENCE_ATOL, "CNN kernel vs reference at %s: max "
              "|d| %.3g > %g" % ((n, h, w), fd, REFERENCE_ATOL))
        check(bool(jnp.isfinite(got).all()), "non-finite CNN output")
        log("  CNN %dx%dx%d: kernel %.3f ms, XLA reference %.3f ms, "
            "max %d level, max |d| %.3g" % (n, h, w, timed(product, x),
                                             timed(reference, x), d, fd))
    ctx["photos"], ctx["paths"], ctx["decomposed"] = photos, paths, out_dir


def phase_filters(ctx):
    import jax
    import jax.numpy as jnp
    from reflectance_filtering.cli import filter as filter_cli
    from reflectance_filtering.ops.bilateral import (
        _bilateral_planar_reference, bilateral_planar,
        joint_bilateral_filter)
    from reflectance_filtering.ops.guided import guided_filter_iterated
    from reflectance_filtering.utils import image as iu
    from reflectance_filtering.utils.testimages import guided_filter64

    if "decomposed" not in ctx:
        raise RuntimeError("needs the decompose phase's outputs")
    out = os.path.join(ctx["work"], "filtered")
    os.makedirs(out)
    r_png = os.path.join(ctx["decomposed"], "p00-r.png")
    photo = ctx["paths"][1]
    r3, ph = iu.imread(r_png), iu.imread(photo)
    check(bool((r3 == r3[..., :1]).all()), "-r.png is not gray")

    def run_cli(kind, filename_in, guidance_in, sc, ss):
        filter_cli.main(["--filter_type=" + kind, "--sigma_color=%g" % sc,
                         "--sigma_spatial=%g" % ss, "--filename_in",
                         filename_in, "--guidance_in", guidance_in,
                         "--path_out", out])
        base = os.path.splitext(os.path.basename(filename_in))[0]
        return iu.imread(os.path.join(out, "%s_%s_c%ss%s.png" % (
            base, kind, float(sc), float(ss))))

    reference_bf = jax.jit(lambda j, s: joint_bilateral_filter(
        j, s, -1, 20.0, 22.0))
    for name, src_path, guide_path, src, guide in (
            ("gray-self", r_png, r_png, r3, r3),
            ("colour-self", photo, photo, ph, ph),
            ("joint(photo, -r.png)", r_png, photo, r3, ph)):
        got = run_cli("bilateral", src_path, guide_path, 20, 22)
        want = np.clip(np.rint(np.asarray(reference_bf(
            guide.astype(np.float32), src.astype(np.float32)))), 0, 255)
        d = max_u8_diff(got, want)
        check(d <= 1, "bilateral %s vs reference: %d levels" % (name, d))
        log("  filter CLI bilateral c20 s22 %s: max %d level vs the plain "
            "reference" % (name, d))

    # the CLI maps guided sigma_spatial -> radius, sigma_color -> eps
    for sc, ss in ((3, 45), (45, 3)):
        got = run_cli("guided", r_png, photo, sc, ss)
        want = np.clip(np.rint(guided_filter64(ph, r3[..., 0], ss,
                                               float(sc))), 0, 255)
        d = max_u8_diff(got[..., 0], want)
        check(d <= 1, "guided c%d s%d vs float64 reference: %d levels"
              % (sc, ss, d))
        log("  filter CLI guided c%d s%d (r=%d, eps=%d): max %d level vs "
            "float64" % (sc, ss, ss, sc, d))

    # the kernel itself vs the reference at the bench sizes
    rng = np.random.RandomState(SEED + 1)
    product = jax.jit(lambda j: bilateral_planar(j, None, -1, 20.0, 22.0,
                                                 joint_reps=3))
    reference = jax.jit(lambda j: _bilateral_planar_reference(
        j, None, -1, 20.0, 22.0, 3))
    check(TRITON_CALL in product.lower(
        jnp.zeros((1, 1, 64, 64))).as_text(),
        "the product bilateral has no Triton call in its HLO")
    for n, (h, w) in ((32, (H, W)), (1, FRAME_4K)):
        x = jax.device_put(rng.randint(0, 256, (n, 1, h, w)).astype(
            np.float32))
        got = np.rint(np.asarray(product(x)))
        want = np.rint(np.asarray(reference(x)))
        check(got.shape == want.shape == (n, 1, h, w),
              "bilateral output shape %s" % (got.shape,))
        d = max_u8_diff(got, want)
        check(d <= 1, "bilateral kernel vs reference at %s: %d levels"
              % ((n, h, w), d))
        log("  bilateral gray-self %dx%dx%d: kernel %.2f ms, XLA reference "
            "%.2f ms, max %d level over all %d images" % (
                n, h, w, timed(product, x), timed(reference, x, reps=1), d,
                n))

    # the 3x guided chain on a 4K frame; float64 check on a corner whose
    # window (3 x 2r = 270 px) never reaches the crop's own far edges
    g = jax.device_put(rng.randint(0, 256, (1, 3) + FRAME_4K).astype(
        np.float32))
    s = jax.device_put(rng.randint(0, 256, (1, 1) + FRAME_4K).astype(
        np.float32))
    chain = jax.jit(lambda a, b: guided_filter_iterated(a, b, 45, 3.0, 3,
                                                        planar=True))
    q = np.asarray(chain(g, s))
    check(q.shape == (1, 1) + FRAME_4K and np.isfinite(q).all(),
          "3x GF chain output")
    crop, keep = 600, 330
    gc = np.moveaxis(np.asarray(g)[0, :, :crop, :crop], 0, -1)
    ref = np.asarray(s)[0, 0, :crop, :crop]
    for _ in range(3):
        ref = guided_filter64(gc, ref, 45, 3.0)
    d = max_u8_diff(np.rint(q[0, 0, :keep, :keep]),
                    np.rint(ref[:keep, :keep]))
    check(d <= 1, "3x GF chain vs float64: %d levels" % d)
    log("  3x guided r45 e3 on %dx%d: %.2f ms, corner vs float64 max "
        "%d level" % (FRAME_4K + (timed(chain, g, s), d)))


def bell_judgments(rng, k):
    points = [{"id": i, "x": float(rng.rand()), "y": float(rng.rand()),
               "opaque": True} for i in range(400)]
    comps = []
    for _ in range(k):
        a, b = rng.choice(400, 2, replace=False)
        comps.append({"point1": int(a), "point2": int(b),
                      "darker": str(rng.choice(["1", "2", "E"])),
                      "darker_score": float(rng.rand() + 0.05)})
    return {"intrinsic_points": points, "intrinsic_comparisons": comps}


def packed_blob(judg):
    comps = judg["intrinsic_comparisons"]
    pts = {p["id"]: p for p in judg["intrinsic_points"]}
    blob = np.full((len(comps) + 1, 6), np.nan, np.float32)
    for i, c in enumerate(comps):
        p1, p2 = pts[c["point1"]], pts[c["point2"]]
        blob[i] = [p1["x"], p1["y"], p2["x"], p2["y"],
                   {"1": 1, "2": 2, "E": 0}[c["darker"]], c["darker_score"]]
    blob[-1, :3] = [len(comps), 1.0, 0]
    return blob


def phase_whdr(ctx):
    import jax
    import jax.numpy as jnp
    from reflectance_filtering.cli.decompose import ReflectanceCNN
    from reflectance_filtering.losses.bell import compute_whdr
    from reflectance_filtering.losses.whdr import whdr_batch

    rng = np.random.RandomState(SEED + 2)
    photos = ctx.get("photos")
    if photos is None:
        photos = seeded_photos(rng, 16, H, W)
    refl = ReflectanceCNN(ctx["weights"]).reflectance_batch(photos)[..., None]
    judgs = [bell_judgments(rng, K_COMPS) for _ in range(len(refl))]
    blobs = jnp.asarray(np.stack([packed_blob(j) for j in judgs]))
    score = jax.jit(whdr_batch)
    got = float(score(jnp.asarray(refl), blobs))
    want = float(np.mean([compute_whdr(r, j) for r, j in zip(refl, judgs)]))
    check(abs(got - want) <= 1e-3, "WHDR %.6f vs Bell %.6f" % (got, want))
    log("  whdr_batch %dx%dx%d K=%d: %.6f, Bell scorer %.6f (|d| %.2e), "
        "%.3f ms" % (len(refl), H, W, K_COMPS, got, want, abs(got - want),
                     timed(score, jnp.asarray(refl), blobs)))


def write_dataset(root, rng, n_train=40, n_val=20):
    """IIW-style .npz shards as data/builder.py writes them (images NCHW
    linear, comparisons [N, K+1, 1, 6] NaN-padded with a metadata row)."""
    from reflectance_filtering.data.builder import FLOOR
    from reflectance_filtering.utils.image import srgb_to_rgb
    os.makedirs(os.path.join(root, "iiw"))
    for name, n in (("trainValTest_train", n_train),
                    ("trainValTest_val", n_val)):
        srgb = seeded_photos(rng, n, H, W)[..., ::-1] / 255.0
        images = np.maximum(srgb_to_rgb(srgb), FLOOR).astype(np.float32)
        comps = np.full((n, K_COMPS + 1, 1, 6), np.nan, np.float32)
        for i in range(n):
            k = rng.randint(K_COMPS // 2, K_COMPS + 1)
            comps[i, :k, 0] = packed_blob(bell_judgments(rng, k))[:k]
            comps[i, K_COMPS, 0, :3] = [k, 1000 + i, 0]
        np.savez(os.path.join(root, "iiw", "%s_%d_%d_linear.npz"
                              % (name, H, W)),
                 images=np.ascontiguousarray(np.moveaxis(images, -1, 1)),
                 comparisons=comps)


def phase_train(ctx):
    from reflectance_filtering.cli import train as train_cli

    rng = np.random.RandomState(SEED + 3)
    data, results = (os.path.join(ctx["work"], d)
                     for d in ("data", "results"))
    write_dataset(data, rng)
    batch, steps = 20, 30
    common = ["--networkType=convStaticSkipLayers", "--numLayers=5",
              "--num_filters_log=5", "--kernel_pad=0",
              "--RS_est_mode=rDirectly", "--batch_size=%d" % batch,
              "--height=%d" % H, "--width=%d" % W, "--random_seed=0",
              "--experiment=smoke", "--data_root", data,
              "--results_root", results]
    t0 = time.perf_counter()
    train_cli.main(["--stage=fit", "--iterations=%d" % (batch * steps),
                    "--checkpoint_interval=%d" % (batch * steps // 2)]
                   + common)
    t_fit = time.perf_counter() - t0
    exp = os.path.join(results, "smoke")
    logs = [os.path.join(exp, "logs", f)
            for f in os.listdir(os.path.join(exp, "logs"))]
    with open(logs[0]) as f:
        lines = [json.loads(line) for line in f]
    losses = [line["loss_whdr_hinge"] for line in lines]
    check(len(losses) == steps, "%d logged steps" % len(losses))
    check(all(v is not None and np.isfinite(v) for v in losses),
          "non-finite training loss")
    snaps = sorted(f for f in os.listdir(os.path.join(exp, "snapshots"))
                   if f.endswith("_iter_%d.npz" % (batch * steps)))
    check(snaps, "no final snapshot")
    t0 = time.perf_counter()
    train_cli.main(["--stage=predict", "--predictCaffemodel",
                    os.path.join(exp, "snapshots", snaps[0])] + common)
    scores = os.listdir(os.path.join(exp, "scores"))
    check(scores, "predict wrote no score")
    log("  fit %d steps of batch %d at %dx%d: %.1f s (compile included), "
        "hinge loss %.4f -> %.4f; predict %.1f s, %d score files"
        % (steps, batch, H, W, t_fit, losses[0], losses[-1],
           time.perf_counter() - t0, len(scores)))


def phase_four_cards(ctx):
    """The paths that shard over all local devices, each against the same
    work on one card."""
    import jax
    import jax.numpy as jnp
    from reflectance_filtering.models.networks import (NetworkConfig,
                                                       init_network)
    from reflectance_filtering.ops.bilateral import bilateral_planar
    from reflectance_filtering.ops.guided import guided_filter_iterated
    from reflectance_filtering.parallel.mesh import (
        make_mesh, make_sharded_train_step, replicate, shard_batch)
    from reflectance_filtering.parallel.spatial import (
        sharded_guided_filter_iterated, sharded_joint_bilateral)
    from reflectance_filtering.train.loop import (LossConfig, make_optimizer,
                                                  make_train_step)
    from reflectance_filtering.train.predict import (make_predict_fn,
                                                     predict_batched,
                                                     score_whdr_per_image)

    n_dev = jax.device_count()
    check(n_dev == 4, "--four-cards needs 4 devices, found %d" % n_dev)
    mesh4, mesh1 = make_mesh(), make_mesh(1)
    rng = np.random.RandomState(SEED + 4)
    cfg = NetworkConfig(network_type="convStaticSkipLayers", num_layers=5,
                        num_filters_log=5, kernel_pad=0,
                        rs_est_mode="rDirectly")
    params = init_network(jax.random.PRNGKey(SEED), cfg)

    images = rng.rand(40, H, W, 3).astype(np.float32)
    fn = make_predict_fn(cfg)
    t0 = time.perf_counter()
    out4 = predict_batched(fn, params, images, batch_size=20)
    t4 = time.perf_counter() - t0
    out1 = predict_batched(fn, params, images, batch_size=20, mesh=mesh1)
    d = float(np.abs(out4["reflectance"] - out1["reflectance"]).max())
    check(d <= 1e-5, "predict_batched 4 vs 1 card: %g" % d)
    comps = np.stack([packed_blob(bell_judgments(rng, K_COMPS))
                      for _ in range(40)])
    w4 = score_whdr_per_image(out4["reflectance"], comps)
    w1 = score_whdr_per_image(out4["reflectance"], comps, mesh=mesh1)
    check(np.array_equal(w4, w1), "score_whdr_per_image 4 vs 1 card")
    log("  predict_batched 40x%dx%d on 4 cards: %.2f s, max |d| %.2e vs 1 "
        "card; score_whdr_per_image equal" % (H, W, t4, d))

    lcfg, opt = LossConfig(), make_optimizer("ADAM", 1e-3)
    imgs = rng.rand(20, H, W, 3).astype(np.float32)
    cmp = jnp.asarray(comps[:20])
    step4 = make_sharded_train_step(cfg, lcfg, opt, mesh4)
    step1 = make_train_step(cfg, lcfg, opt)
    p4, o4 = replicate(params, mesh4), replicate(opt.init(params), mesh4)
    p1, o1 = params, opt.init(params)
    for i in range(5):
        key = jax.random.PRNGKey(i)
        p4, o4, m4 = step4(p4, o4, shard_batch(jnp.asarray(imgs), mesh4),
                           shard_batch(cmp, mesh4), replicate(key, mesh4))
        p1, o1, m1 = step1(p1, o1, jnp.asarray(imgs), cmp, key)
    dp = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(p4), jax.tree_util.tree_leaves(p1)))
    check(dp <= 1e-4, "sharded train step params drift %g" % dp)
    log("  make_sharded_train_step 5 steps batch 20: max |param d| %.2e vs "
        "1 card, loss %.4f vs %.4f" % (dp, float(m4["loss_whdr_hinge"]),
                                       float(m1["loss_whdr_hinge"])))

    guide = jnp.asarray(rng.randint(0, 256, FRAME_8K + (3,)).astype(
        np.float32))
    src = jnp.asarray(rng.randint(0, 256, FRAME_8K).astype(np.float32))
    t0 = time.perf_counter()
    q4 = np.asarray(sharded_guided_filter_iterated(guide, src, 45, 3.0, 3,
                                                   mesh4))
    t4 = time.perf_counter() - t0
    q1 = np.asarray(jax.jit(lambda g, s: guided_filter_iterated(
        g, s, 45, 3.0, 3))(guide, src))
    d = max_u8_diff(np.rint(q4), np.rint(q1))
    check(d <= 1, "sharded 3x GF 8K vs 1 card: %d levels" % d)
    log("  sharded_guided_filter_iterated 8K on 4 cards: %.2f s (compile "
        "included), max %d level vs 1 card" % (t4, d))

    gray = src[..., None]
    t0 = time.perf_counter()
    b4 = np.asarray(sharded_joint_bilateral(gray, None, mesh4, -1, 20.0,
                                            22.0, joint_reps=3))[..., 0]
    t4 = time.perf_counter() - t0
    b1 = np.asarray(bilateral_planar(jnp.moveaxis(gray, -1, 0)[None], None,
                                     -1, 20.0, 22.0, joint_reps=3))[0, 0]
    d = max_u8_diff(np.rint(b4), np.rint(b1))
    check(d <= 1, "sharded bilateral 8K vs 1 card: %d levels" % d)
    log("  sharded_joint_bilateral gray-self 8K on 4 cards: %.2f s (compile "
        "included), max %d level vs 1 card" % (t4, d))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the paths that span four cards")
    args = ap.parse_args(argv)

    from reflectance_filtering.utils.device import card_line, device_record
    device = device_record()
    if device["platform"] != "gpu":
        print("no accelerator: JAX runs on %r; this smoke run needs an "
              "NVIDIA GPU" % device["platform"], file=sys.stderr)
        return 2
    log("card:", card_line())
    log("device:", json.dumps(device))

    from reflectance_filtering.models.caffe_io import write_seeded_caffemodel
    from reflectance_filtering.utils.compile_cache import (
        enable_persistent_compilation_cache)
    log("compile cache:", enable_persistent_compilation_cache())

    phases = ([("four_cards", phase_four_cards)] if args.four_cards else
              [("decompose", phase_decompose), ("filters", phase_filters),
               ("whdr", phase_whdr), ("train", phase_train)])
    failed = []
    with tempfile.TemporaryDirectory() as work:
        ctx = {"work": work, "weights": write_seeded_caffemodel(
            os.path.join(work, "seeded.caffemodel"), SEED)}
        for name, phase in phases:
            t0 = time.perf_counter()
            try:
                phase(ctx)
            except Exception:  # noqa: BLE001 — report every phase
                traceback.print_exc()
                failed.append(name)
                log("phase %s: FAILED (%.1f s)" % (
                    name, time.perf_counter() - t0))
            else:
                log("phase %s: ok (%.1f s)" % (name,
                                               time.perf_counter() - t0))
    if failed:
        log("failed phases:", ", ".join(failed))
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
