#!/usr/bin/env python
"""Benchmark of the reflectance pipeline on one NVIDIA GPU.

    python bench.py              stage throughputs (one JSON line)
    python bench.py --gate       parity gate only (also runs on the CPU)
    python bench.py --kernels    each Triton kernel, and the pipelines it
                                 serves, against the plain references that
                                 XLA compiles (one JSON line)
    --profile DIR                also trace one BF and one GF pipeline step
    --weights PATH               a trained caffemodel (default: seeded
                                 stand-in weights at the reference shapes,
                                 drawn from --seed)

Headline (BASELINE.json config 2/5): the paper's flagship filtered result
BF(CNN, CNN) as one device pipeline — uint8 BGR batch -> linear ->
reflectance CNN -> imwrite byte path (floor(r*255)) -> joint bilateral
(sigma_color=20, sigma_space=22, OpenCV semantics) -> WHDR against packed
IIW-style comparisons — in megapixels per second.  Reference stack: 0.693 s
per 0.37 MP image = 0.5 MP/s (README.md:84-85, BASELINE.md).

Timing: jitted programs on device-resident inputs; one warm-up call
(compilation), then the median of several calls, each ended by
block_until_ready, in this one process.  Every record names the device
(platform, kind, count) and the card (name, power limit); the measurement
modes refuse to run anywhere but on a GPU.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

BATCH = 32
H = W = 256
MP = BATCH * H * W / 1e6
FRAME_4K = (2160, 3840)
FRAME_8K = (4320, 7680)
BASELINE_MPS = 0.5  # reference BF(CNN,CNN): ~0.37 MP / 0.693 s
K_COMPS = 1181  # real IIW blob row count (createNumpy...:83)
_HEADLINE = ("BF(CNN,CNN) end-to-end megapixels/sec "
             "(CNN+u8-write+joint-bilateral c20 s22+WHDR)")


def _time(fn, *args, reps=5):
    """(median seconds, spread) of ``fn(*args)`` after a warm-up call;
    spread = (max - min) / median over the timed calls."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2]
    return med, (ts[-1] - ts[0]) / med


def _u8(rng, *shape):
    return np.floor(rng.rand(*shape) * 256).astype(np.uint8)


def _weights_path(args, tmp):
    if args.weights:
        return args.weights
    from reflectance_filtering.models.caffe_io import write_seeded_caffemodel
    return write_seeded_caffemodel(os.path.join(tmp, "seeded.caffemodel"),
                                   args.seed)


def _params(path):
    from reflectance_filtering.models.caffe_io import load_reference_weights
    from reflectance_filtering.models.networks import (
        reference_params_from_caffe)
    return reference_params_from_caffe(load_reference_weights(path))


def _record_device(rec):
    from reflectance_filtering.utils.device import card_line, device_record
    rec["device"] = device_record()
    rec["card"] = card_line() if rec["device"]["platform"] == "gpu" else None
    return rec


# ---------------------------------------------------------------------------
# parity gate
# ---------------------------------------------------------------------------

def run_gate(weights_path):
    """Golden inputs through the product dispatch (the Triton kernels on
    the GPU); every uint8 output within 1 level of its anchor and every
    |dWHDR| <= 0.001.

    Anchors: guided — the committed independent C++-transcription
    fixtures (tests/fixtures/guided_golden.npz); bilateral gray-self (the
    BF(CNN,CNN) -r.png case) — the cv2.bilateralFilter binary on a
    sin-grating and a 1/f pink-noise image (where OpenCV is not installed,
    the plain XLA reference ops.bilateral.joint_bilateral_filter); CNN — a
    float64 numpy forward off the caffemodel blobs.  WHDR deltas score ours and the oracle's
    output with the exact Bell WHDR against a 47k-row synthetic blob (at
    K=1181 one flipped comparison moves WHDR by ~0.085%, the order of the
    criterion itself).  The approximate grid quality point (ss=8, sr=6)
    is gated on WHDR only.  Returns (ok, diffs)."""
    from reflectance_filtering.cli.decompose import ReflectanceCNN
    from reflectance_filtering.losses.whdr import whdr as whdr_exact
    from reflectance_filtering.models.caffe_io import parse_caffemodel
    from reflectance_filtering.ops.bilateral import (
        joint_bilateral_filter, joint_bilateral_filter_u8)
    from reflectance_filtering.ops.bilateral_grid import bilateral_grid_u8
    from reflectance_filtering.ops.guided import guided_filter_u8
    from reflectance_filtering.utils.testimages import (
        flagship_forward64, make_synthetic_comps, pink_noise)
    diffs = {}
    comps = jax.device_put(make_synthetic_comps(11, 40 * K_COMPS))
    score = jax.jit(lambda img: whdr_exact(img, comps))

    def whdr_u8(img):
        a = np.asarray(img, np.float32) / 255.0
        return float(score(jnp.asarray(a if a.ndim == 3 else a[..., None])))

    def whdr_delta(key, ours, oracle):
        diffs["whdr_delta_" + key] = abs(whdr_u8(ours) - whdr_u8(oracle))

    def max_diff(a, b):
        return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
                   .max())

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "fixtures", "guided_golden.npz")
    with np.load(fix) as z:
        g = {k: z[k] for k in z.files}
    for tag, key, kind in [("r3_e3", "small", "color"),
                           ("r45_e3", "big", "color"),
                           ("r52_e7", "big", "color"),
                           ("r45_e3", "big", "colorsrc"),
                           ("r45_e3", "big", "gray")]:
        radius = int(tag.split("_")[0][1:])
        eps = float(tag.split("_e")[1])
        guide = g["img_{}_guide_{}".format(
            key, "gray" if kind == "gray" else "color")]
        src = guide if kind == "colorsrc" else g["img_{}_src".format(key)]
        got = guided_filter_u8(guide, src, radius, eps)
        exp = g["out_{}_{}".format(tag, kind)]
        diffs["gf_{}_{}".format(tag, kind)] = max_diff(got, exp)
        if (tag, key, kind) == ("r45_e3", "big", "color"):
            whdr_delta("gf_r45_e3", got, exp)

    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    gray = np.clip(120 + 70 * np.sin(xx / 14.0) * np.cos(yy / 10.0)
                   + 12 * rng.rand(96, 128), 0, 255).astype(np.uint8)
    pink = pink_noise(rng, 96, 128).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None

    def bf_anchor(img):
        if cv2 is not None:
            return cv2.bilateralFilter(img, -1, 20.0, 22.0)
        f = jnp.asarray(img, jnp.float32)
        return np.clip(np.rint(np.asarray(joint_bilateral_filter(
            f, f, -1, 20.0, 22.0))), 0, 255).astype(np.uint8)

    anchor = "cv2" if cv2 is not None else "xla_reference"
    for name, img in (("grating", gray), ("pink", pink)):
        rep3 = np.repeat(img[..., None], 3, axis=-1)
        got = joint_bilateral_filter_u8(rep3, rep3, -1, 20.0, 22.0)
        exp = bf_anchor(rep3)
        diffs["bf_gray_self_{}_vs_{}".format(name, anchor)] = max_diff(got,
                                                                      exp)
        whdr_delta("bf_" + name, got, exp)
        whdr_delta("grid_quality_" + name,
                   bilateral_grid_u8(rep3, rep3, 20.0, 22.0, ss=8, sr=6),
                   exp)

    img = np.stack([gray, np.roll(gray, 7, 0), np.roll(gray, 5, 1)], -1)
    got = np.floor(ReflectanceCNN(weights_path).reflectance_intensity(img)
                   * 255.0)
    exp = np.floor(flagship_forward64(parse_caffemodel(weights_path), img)
                   * 255.0)
    diffs["cnn_r_png"] = max_diff(got, exp)
    whdr_delta("cnn", got, exp)

    ok = all((d <= 0.001 if k.startswith("whdr_delta_") else d <= 1)
             for k, d in diffs.items())
    return ok, diffs


# ---------------------------------------------------------------------------
# stage throughputs
# ---------------------------------------------------------------------------

def _pipelines(params, comps):
    """The pipeline stages as jitted programs on planar uint8 BGR
    batches, built under the current kernel/reference choice."""
    from reflectance_filtering.losses.whdr import whdr_batch
    from reflectance_filtering.models.networks import reflectance_from_bgr_u8
    from reflectance_filtering.ops.bilateral import bilateral_planar
    from reflectance_filtering.ops.guided import guided_filter_planar

    def cnn(x):
        return reflectance_from_bgr_u8(params, x)

    def r_u8(x):
        # imwrite byte path: sigmoid < 1 never triggers the percentile
        # normalize, so the CLI writes floor(r*255)
        return jnp.floor(cnn(x) * 255.0)[:, None]

    def bf(x):
        # -r.png decodes to 3 identical channels (joint_reps=3)
        filt = bilateral_planar(r_u8(x), None, -1, 20.0, 22.0, joint_reps=3)
        return whdr_batch(jnp.moveaxis(filt, 1, -1) / 255.0, comps)

    def gf(x):
        guide = x[:, ::-1].astype(jnp.float32)
        filt = guided_filter_planar(guide, r_u8(x), 45, 3.0)
        return whdr_batch(jnp.moveaxis(filt, 1, -1) / 255.0, comps)

    return {"cnn": jax.jit(cnn), "bf_pipeline": jax.jit(bf),
            "gf_pipeline": jax.jit(gf)}


def _run(params, profile_dir=None):
    from reflectance_filtering.models.networks import (NetworkConfig,
                                                       init_network)
    from reflectance_filtering.ops.bilateral import bilateral_planar
    from reflectance_filtering.ops.bilateral_grid import bilateral_grid_gray
    from reflectance_filtering.ops.guided import guided_filter_iterated
    from reflectance_filtering.train.loop import (LossConfig, compute_losses,
                                                  make_optimizer)
    from reflectance_filtering.utils.testimages import make_synthetic_comps
    import optax

    rng = np.random.RandomState(0)
    imgs = jax.device_put(_u8(rng, BATCH, 3, H, W))
    comps = jax.device_put(make_synthetic_comps(1, K_COMPS, batch=BATCH))
    times, spreads, errors = {}, {}, {}

    def stage(name, fn, *args, reps=5):
        try:
            times[name], spreads[name] = _time(fn, *args, reps=reps)
        except Exception as err:  # noqa: BLE001 — report, keep measuring
            errors[name] = repr(err)[:500]
            print("bench stage %s FAILED: %r" % (name, err), file=sys.stderr)

    pipes = _pipelines(params, comps)
    for name in ("cnn", "gf_pipeline", "bf_pipeline"):
        stage(name, pipes[name], imgs)
    if profile_dir:
        from reflectance_filtering.utils.profiling import device_trace
        with device_trace(profile_dir):
            jax.block_until_ready(pipes["bf_pipeline"](imgs))
            jax.block_until_ready(pipes["gf_pipeline"](imgs))
        print("wrote device trace to", profile_dir, file=sys.stderr)

    photos = jax.device_put(_u8(rng, 8, 3, H, W).astype(np.float32))
    refl = jax.device_put(_u8(rng, 8, 1, H, W).astype(np.float32))
    stage("bf_color_self", jax.jit(
        lambda x: bilateral_planar(x, None, -1, 20.0, 22.0)), photos)
    stage("bf_joint_photo", jax.jit(
        lambda j, s: bilateral_planar(j, s, -1, 20.0, 22.0)), photos, refl)

    gj = jax.device_put(_u8(rng, BATCH, H, W).astype(np.float32))
    gs = jax.device_put(_u8(rng, BATCH, 1, H, W).astype(np.float32))
    for name, ss, sr in (("bf_grid", None, None), ("bf_grid_fast", 16, 10),
                         ("bf_grid_quality", 8, 6)):
        stage(name, jax.jit(lambda j, s, ss=ss, sr=sr: bilateral_grid_gray(
            j, s, 20.0 / 3.0, 22.0, ss=ss, sr=sr)), gj, gs)

    chain = jax.jit(lambda g, s: guided_filter_iterated(g, s, 45, 3.0, 3,
                                                        planar=True))
    for name, (fh, fw) in (("gf_3x_4k", FRAME_4K), ("gf_3x_8k", FRAME_8K)):
        g = jax.device_put(_u8(rng, 1, 3, fh, fw).astype(np.float32))
        s = jax.device_put(_u8(rng, 1, 1, fh, fw).astype(np.float32))
        stage(name, chain, g, s)
        g.delete()
        s.delete()

    tcfg, tl = NetworkConfig(), LossConfig()
    tparams = init_network(jax.random.PRNGKey(0), tcfg)
    topt = make_optimizer("ADAM", 1e-3)
    tb = 20
    timgs = jax.device_put(rng.rand(tb, H, W, 3).astype(np.float32))
    tcomps = jax.device_put(np.asarray(comps)[:tb])

    @jax.jit
    def train_step(p, o, im, c):
        (_, _), g = jax.value_and_grad(
            lambda pp: compute_losses(pp, im, c, tcfg, tl,
                                      jax.random.PRNGKey(0), train=True),
            has_aux=True)(p)
        up, o = topt.update(g, o, p)
        return optax.apply_updates(p, up), o

    stage("train_step", train_step, tparams, topt.init(tparams), timgs,
          tcomps, reps=10)

    def mps(name, mp):
        return mp / times[name] if name in times else None

    bf_mps = mps("bf_pipeline", MP)
    return {
        "metric": _HEADLINE, "value": bf_mps, "unit": "MP/s",
        "vs_baseline": bf_mps / BASELINE_MPS if bf_mps else None,
        "gf_pipeline_mps": mps("gf_pipeline", MP),
        "cnn_decompose_mps": mps("cnn", MP),
        "bf_color_self_mps": mps("bf_color_self", 8 * H * W / 1e6),
        "bf_joint_photo_mps": mps("bf_joint_photo", 8 * H * W / 1e6),
        "bf_grid_approx_mps": mps("bf_grid", MP),
        "bf_grid_fast_mps": mps("bf_grid_fast", MP),
        "bf_grid_quality_mps": mps("bf_grid_quality", MP),
        "gf_3x_4k_mps": mps("gf_3x_4k", FRAME_4K[0] * FRAME_4K[1] / 1e6),
        "gf_3x_8k_mps": mps("gf_3x_8k", FRAME_8K[0] * FRAME_8K[1] / 1e6),
        "train_imgs_per_s": (tb / times["train_step"]
                             if "train_step" in times else None),
        "stage_seconds": times, "timing_spread": spreads,
        "batch": BATCH, "resolution": [H, W],
        "whdr_comparisons_per_image": K_COMPS, "errors": errors,
    }


# ---------------------------------------------------------------------------
# kernels against the plain references
# ---------------------------------------------------------------------------

def _hlo_has_triton(fn, *args):
    return "__gpu$xla.gpu.triton" in jax.jit(fn).lower(*args).as_text()


def run_kernels(params):
    """Each Triton kernel and the pipeline stages it serves, timed against
    what XLA makes of the plain float32 reference (HIGHEST precision), on
    batch 32x256x256 and one 2160x3840 frame, with the parity of each
    kernel's output bytes against the reference."""
    from reflectance_filtering.models.networks import (
        _reflectance_from_bgr_u8_reference, reflectance_from_bgr_u8)
    from reflectance_filtering.ops.backend import references_only
    from reflectance_filtering.ops.bilateral import (
        _bilateral_planar_reference, bilateral_planar)
    from reflectance_filtering.ops.bilateral_triton import bilateral_triton
    from reflectance_filtering.ops.cnn_triton import reflectance_cnn_triton
    from reflectance_filtering.utils.testimages import make_synthetic_comps

    rng = np.random.RandomState(1)
    out = {}
    shapes = {"b32_256": (BATCH, H, W), "frame_4k": (1,) + FRAME_4K}

    def compare(name, kernel, reference, args, to_u8, reps):
        k_s, k_spread = _time(kernel, *args, reps=reps)
        x_s, x_spread = _time(reference, *args, reps=reps)
        got, exp = kernel(*args), reference(*args)
        d = np.abs(np.asarray(to_u8(got), np.int64)
                   - np.asarray(to_u8(exp), np.int64))
        out[name] = {"kernel_ms": 1e3 * k_s, "xla_ms": 1e3 * x_s,
                     "speedup": x_s / k_s, "kernel_spread": k_spread,
                     "xla_spread": x_spread, "max_u8_diff": int(d.max()),
                     "frac_u8_diff": float((d > 0).mean()),
                     "max_abs_diff": float(jnp.abs(got - exp).max())}

    def r_png(r):
        return jnp.floor(r * 255.0)

    def u8_out(q):
        return jnp.clip(jnp.rint(q), 0, 255)

    cnn_k = jax.jit(lambda x: reflectance_cnn_triton(params, x))
    cnn_x = jax.jit(lambda x: _reflectance_from_bgr_u8_reference(params, x))
    bf_k = jax.jit(lambda j: bilateral_triton(j, None, -1, 20.0, 22.0,
                                              joint_reps=3))
    bf_x = jax.jit(lambda j: _bilateral_planar_reference(
        j, None, -1, 20.0, 22.0, 3))
    bfj_k = jax.jit(lambda j, s: bilateral_triton(j, s, -1, 20.0, 22.0))
    bfj_x = jax.jit(lambda j, s: _bilateral_planar_reference(
        j, s, -1, 20.0, 22.0, 1))
    for tag, (n, h, w) in shapes.items():
        x = jax.device_put(_u8(rng, n, 3, h, w))
        compare("cnn_" + tag, cnn_k, cnn_x, (x,), r_png, 20)
        gray = jax.device_put(_u8(rng, n, 1, h, w).astype(np.float32))
        compare("bf_gray_self_" + tag, bf_k, bf_x, (gray,), u8_out, 3)
        photo = jax.device_put(_u8(rng, n, 3, h, w).astype(np.float32))
        compare("bf_joint_photo_" + tag, bfj_k, bfj_x, (photo, gray),
                u8_out, 3)

    # end to end: the same pipelines built with the kernels and without
    imgs = jax.device_put(_u8(rng, BATCH, 3, H, W))
    comps = jax.device_put(make_synthetic_comps(1, K_COMPS, batch=BATCH))
    with_k = _pipelines(params, comps)
    with references_only():
        without = _pipelines(params, comps)
        for fn in without.values():
            jax.block_until_ready(fn(imgs))   # trace under the switch
    for name in ("cnn", "bf_pipeline", "gf_pipeline"):
        k_s, _ = _time(with_k[name], imgs, reps=5)
        x_s, _ = _time(without[name], imgs, reps=3)
        out["e2e_" + name] = {"kernel_ms": 1e3 * k_s, "xla_ms": 1e3 * x_s,
                              "speedup": x_s / k_s}
    small = jnp.zeros((2, 3, 64, 64), jnp.uint8)
    hlo = {"cnn": _hlo_has_triton(
               lambda v: reflectance_from_bgr_u8(params, v), small),
           "bilateral": _hlo_has_triton(
               lambda v: bilateral_planar(v, None, -1, 20.0, 22.0,
                                          joint_reps=3),
               small[:, :1].astype(jnp.float32))}
    return {"mode": "kernels", "kernels": out, "product_hlo_has_triton": hlo}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from reflectance_filtering.utils.compile_cache import (
        enable_persistent_compilation_cache)
    from reflectance_filtering.utils.device import require_gpu
    enable_persistent_compilation_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = _weights_path(args, tmp)
        if args.gate:
            ok, diffs = run_gate(path)
            print(json.dumps(_record_device(
                {"parity_ok": ok, "parity_max_diffs": diffs})))
            return 0 if ok else 1
        require_gpu()
        params = _params(path)
        if args.kernels:
            from reflectance_filtering.ops.cnn_triton import REFERENCE_ATOL
            rec = run_kernels(params)
            ok = all(v.get("max_u8_diff", 0) <= 1
                     for v in rec["kernels"].values())
            # the CNN's float output also holds its precision (no TF32)
            ok = ok and all(v["max_abs_diff"] <= REFERENCE_ATOL
                            for k, v in rec["kernels"].items()
                            if k.startswith("cnn_"))
            ok = ok and all(rec["product_hlo_has_triton"].values())
        else:
            rec = _run(params, args.profile)
            rec["parity_ok"], rec["parity_max_diffs"] = run_gate(path)
            ok = rec["parity_ok"] and not rec["errors"]
    print(json.dumps(_record_device(rec)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
