"""Prediction, evaluation and the decompose family.

Rebuild of the predict half of train_with_barrista_helper.py:

  * ``predict_and_score`` (helper:490-583): batched forward over a
    validation set, WHDR eval, score caching in ``scores/*.txt`` (values
    < 100 returned without recompute), frame rate persisted to
    ``framerates/*.txt``, sentinel score 100 on failure.
  * ``decompose_single_image_in_full_size`` (helper:753-805): full-res
    decompose of one image, six outputs (linear + sRGB of -r, -s, -RS_est),
    float*255 truncation write (helper:665-686).
  * ``decompose_numpy`` (helper:711-750): decompose an .npz twice (input
    as linear and as sRGB), write ``*_decomposed.npz``.
  * ``decompose_movie`` (helper:1027-1060) + baselines (helper:998-1024):
    per-frame sRGB->linear in, batched decomposition, combined triptych and
    separate -r/-s mp4 outputs, rgbMean/rgbNorm baseline videos.

Unlike the reference (which rebuilds the whole net per image/movie,
helper:757-759), the jitted forward is reused and only retraces per new
(H, W).  Batched prediction pads the batch to fixed shapes for one compiled
program.
"""
from __future__ import annotations

import functools as _functools
import os
import timeit
import traceback
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.networks import NetworkConfig, apply_network
from ..models.recover import recover_reflectance_shading
from ..losses.whdr import whdr_per_image
from ..utils import image as iu
from ..utils.image import srgb_to_rgb, rgb_to_srgb, rgb_uint8_to_linear

EPS = np.float32(np.finfo(np.float32).eps)


def percent(num) -> str:
    """helper:442-444."""
    return "{:.2f}%".format(num * 100)


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

def make_predict_fn(net_cfg: NetworkConfig):
    """Jitted (params, images NHWC) -> (RS_est, reflectance, shading)."""

    @jax.jit
    def predict(params, images):
        blobs = apply_network(params, images, net_cfg, train=False)
        mode = net_cfg.rs_est_mode.split("-")[0]
        if mode == "rDirectly":
            refl = jax.nn.relu(blobs["RS_est"])
            shad = refl
        else:
            refl, shad = recover_reflectance_shading(
                blobs["RS_est"], images, net_cfg.rs_est_mode)
        out = {"RS_est": blobs["RS_est"], "reflectance": refl,
               "shading": shad}
        if "reflectance_level0" in blobs:
            out["reflectance_level0"] = blobs["reflectance_level0"]
        return out

    return predict


def predict_batched(predict_fn, params, images: np.ndarray,
                    batch_size: int = 32, mesh=None
                    ) -> Dict[str, np.ndarray]:
    """Run prediction over [N,H,W,3] in fixed-size batches (pad the tail).

    Data-parallel by default: each batch is sharded across all local
    devices (params replicated), so the product eval path rides the mesh —
    on one chip this degenerates to plain batching.  SURVEY.md §5.8."""
    from ..parallel.mesh import (make_mesh, pad_to_multiple, replicate,
                                 shard_batch)

    if mesh is None:
        mesh = make_mesh()
    n_dev = len(mesh.devices.flatten())
    batch_size = -(-batch_size // n_dev) * n_dev
    params_r = replicate(params, mesh)

    n = images.shape[0]
    outs: Dict[str, List[np.ndarray]] = {}
    for start in range(0, n, batch_size):
        chunk, take = pad_to_multiple(images[start:start + batch_size],
                                      batch_size)
        res = predict_fn(params_r, shard_batch(jnp.asarray(chunk), mesh))
        for k, v in res.items():
            outs.setdefault(k, []).append(np.asarray(v[:take]))
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}


@_functools.lru_cache(maxsize=8)
def _whdr_program(delta: float, spec):
    """jit-compiled sharded WHDR, cached per (delta, sharding) — a fresh
    jit(partial(...)) per call would recompile for every checkpoint
    evaluated (the post-fit sweep calls this once per snapshot, and
    compiles cost seconds each)."""
    return jax.jit(_functools.partial(whdr_per_image, delta=delta),
                   in_shardings=(spec, spec), out_shardings=spec)


def score_whdr_per_image(reflectances: np.ndarray, comps: np.ndarray,
                         delta: float = 0.1, mesh=None) -> np.ndarray:
    """Per-image WHDR over a whole prediction set as ONE device program,
    batch axis sharded across all local devices (replaces the reference's
    per-image host loop, helper:565-583)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import make_mesh, pad_to_multiple, shard_batch

    if mesh is None:
        mesh = make_mesh()
    n_dev = len(mesh.devices.flatten())
    r_p, n = pad_to_multiple(np.asarray(reflectances, np.float32), n_dev)
    c_p, _ = pad_to_multiple(np.asarray(comps, np.float32), n_dev)
    spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    fn = _whdr_program(float(delta), spec)
    out = fn(shard_batch(jnp.asarray(r_p), mesh),
             shard_batch(jnp.asarray(c_p), mesh))
    return np.asarray(out)[:n]


# ---------------------------------------------------------------------------
# scoring with artifact contract
# ---------------------------------------------------------------------------

def predict_and_score(X_val: Dict, params, net_cfg: NetworkConfig,
                      results_dir: str, description: str,
                      delta: float = 0.1,
                      batch_size: int = 32,
                      predict_fn=None) -> float:
    """Score a checkpoint on a validation set; returns WHDR in percent.

    Artifact contract (helper:498-583): score cache file
    ``scores/{description}_imgs{N}.txt`` (<100 -> reuse), frame rate to
    ``framerates/...txt``, sentinel 100 on prediction failure.

    Device-parallel end to end: the forward runs through the
    mesh-sharded ``predict_batched`` and the WHDR through
    ``score_whdr_per_image`` (one sharded program over the whole set) —
    the reference's per-image host loop (helper:565-583) is gone; on a
    single chip both degenerate to plain device batching.
    """
    num_images = X_val["images"].shape[0]
    description = description + "_imgs{}".format(num_images)
    score_filename = os.path.join(results_dir, "scores",
                                  description + ".txt")
    if os.path.isfile(score_filename):
        try:
            with open(score_filename) as f:
                result = float(f.readline())
        except ValueError:
            # an interrupted eval can leave an empty/garbled cache file;
            # treat it as a miss and recompute (helper:511-521 guards the
            # sentinel the same defensive way)
            result = 100.0
        if result < 100:
            return result

    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)

    start = timeit.default_timer()
    try:
        results = predict_batched(predict_fn, params,
                                  np.asarray(X_val["images"], np.float32),
                                  batch_size)
    except Exception:
        traceback.print_exc()
        print("Prediction was not possible, returning 100 as default!")
        return 100
    prediction_time = timeit.default_timer() - start
    rate = num_images / prediction_time
    print("Predicting", num_images, "images took", prediction_time,
          "seconds, i.e.,", prediction_time / num_images, "per image and",
          rate, "images per second.")

    os.makedirs(os.path.join(results_dir, "framerates"), exist_ok=True)
    with open(os.path.join(results_dir, "framerates",
                           description + ".txt"), "w") as f:
        f.write(str(rate))

    reflectances = results["reflectance"]
    comps = np.asarray(X_val["comparisons"], np.float32)
    whdrs = score_whdr_per_image(reflectances, comps, delta)
    mean_whdr = float(np.mean(whdrs))
    score = mean_whdr * 100

    print("WHDR on learned reflectance for:", description)
    print("WHDRs:",
          "\t min", percent(float(np.min(whdrs))),
          "\t max", percent(float(np.max(whdrs))),
          "\t median", percent(float(np.median(whdrs))),
          "\t mean", percent(mean_whdr))

    os.makedirs(os.path.join(results_dir, "scores"), exist_ok=True)
    # atomic publish (like checkpoint.py): a kill mid-write must not
    # leave an empty cache file that poisons every later run
    tmp = score_filename + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(score))
    os.replace(tmp, score_filename)
    return score


# ---------------------------------------------------------------------------
# decompose family
# ---------------------------------------------------------------------------

def is_image(filename):
    """helper:586-589."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["jpg", "png", "ppm", "tiff"]


def is_movie(filename):
    """helper:592-595."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["mp4", "avi"]


def is_numpy(filename):
    """helper:598-601."""
    ext = os.path.splitext(filename)[1][1:].strip().lower()
    return ext in ["npz"]


def _read_img_linear_hwc(full_path: str) -> np.ndarray:
    """helper:653-662 (minus the NCHW transpose — NHWC on device)."""
    try:
        img = iu.imread(full_path)
    except IOError as err:
        raise IOError("Could not read {}".format(full_path)) from err
    return rgb_uint8_to_linear(img[:, :, ::-1])


def _save_img(full_path: str, img_hwc: np.ndarray,
              scale2Max: bool = False, convert2sRGB: bool = False):
    """helper:665-686: RGB->BGR, optional max-scale / sRGB encode, write
    img*255 as float, which OpenCV converts to uint8 with saturating
    round-half-to-even (done here explicitly)."""
    img = np.array(img_hwc, copy=True)
    img = img[:, :, ::-1] if img.ndim == 3 else img
    if scale2Max:
        img = img / np.max(img)
    if convert2sRGB:
        img = rgb_to_srgb(img)
    iu.write_u8(full_path, np.clip(np.rint(img * 255), 0, 255).astype(
        np.uint8))


def _write_decomposition(results_dir: str, orig: str, reflectance,
                         shading, rs_est):
    """helper:776-805: 6 outputs (linear + sRGB) under results_dir."""
    fmt = ".png"
    for sub, srgb in (("decompositions_linear", False),
                      ("decompositions_sRGB", True)):
        os.makedirs(os.path.join(results_dir, sub), exist_ok=True)
        _save_img(os.path.join(results_dir, sub, orig + "-r" + fmt),
                  reflectance, convert2sRGB=srgb)
        _save_img(os.path.join(results_dir, sub, orig + "-s" + fmt),
                  shading, convert2sRGB=srgb)
        _save_img(os.path.join(results_dir, sub, orig + "-RS_est" + fmt),
                  rs_est, convert2sRGB=srgb)


def decompose_single_image_in_full_size(img_path: str, params,
                                        net_cfg: NetworkConfig,
                                        results_dir: str,
                                        predict_fn=None):
    """helper:753-805: full-res decompose, 6 outputs (linear + sRGB)."""
    img = _read_img_linear_hwc(img_path)
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    res = predict_fn(params, jnp.asarray(img[None]))
    # splitext, not [:-4]: is_image accepts .tiff, which the reference's
    # 4-char strip (helper:766) would mangle to 'name.-r.png'
    _write_decomposition(results_dir,
                         os.path.splitext(os.path.basename(img_path))[0],
                         np.asarray(res["reflectance"][0]),
                         np.asarray(res["shading"][0]),
                         np.asarray(res["RS_est"][0]))


def decompose_images_batched(paths: Sequence[str], params,
                             net_cfg: NetworkConfig, results_dir: str,
                             predict_fn=None, batch_size: int = 16):
    """Batched multi-image decompose — the rebuild's replacement for the
    reference's per-file loop that rebuilt the whole net per image
    (helper:757-760, SURVEY.md §3.4).  Images are grouped by (H, W) so
    each group runs through one jitted program in device batches; reads
    go through the native thread-pool decoder (bit-exact PNG parity with
    the cv2 path, data/native_loader.read_images_rgb) and keep per-file
    error containment.  Returns the list of successfully decomposed
    paths."""
    from ..data.native_loader import read_images_rgb

    raw, failed = read_images_rgb(paths)
    for p in failed:
        print("Decomposing file", p, "was not possible")
    groups: Dict = {}
    for p, rgb in raw:
        # helper:653-662 linearization, minus the cv2 BGR round-trip
        img = rgb_uint8_to_linear(rgb)
        groups.setdefault(img.shape[:2], []).append((p, img))
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    done = []
    for items in groups.values():
        for s in range(0, len(items), batch_size):
            chunk = items[s:s + batch_size]
            # per-chunk containment, like the reference's per-file loop
            # (helper:410-435): one unpredictable group (device OOM on
            # an 8K frame, a shape the net can't run) must not abort the
            # remaining groups/movies/npz files
            try:
                batch = np.stack([im for _, im in chunk])
                res = predict_fn(params, jnp.asarray(batch))
                refl = np.asarray(res["reflectance"])
                shad = np.asarray(res["shading"])
                rs = np.asarray(res["RS_est"])
            except Exception:
                print("Decomposing files", [p for p, _ in chunk],
                      "was not possible")
                traceback.print_exc()
                continue
            for i, (p, _) in enumerate(chunk):
                _write_decomposition(
                    results_dir,
                    os.path.splitext(os.path.basename(p))[0],
                    refl[i], shad[i], rs[i])
                done.append(p)
    return done


def decompose_numpy(npz_path: str, params, net_cfg: NetworkConfig,
                    predict_fn=None, batch_size: int = 16):
    """helper:711-750: decompose an npz twice (as-linear and as-sRGB)."""
    with np.load(npz_path) as npz:
        images = npz["images"]  # [N, H, W, C] uint8-style 0-255

    input_as_is = (images / 255.0).astype(np.float32)
    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)

    res1 = predict_batched(predict_fn, params, input_as_is, batch_size)
    linear = srgb_to_rgb(input_as_is).astype(np.float32)
    res2 = predict_batched(predict_fn, params, linear, batch_size)

    np.savez_compressed(
        npz_path[:-4] + "_decomposed.npz",
        images=images,
        R_back_to_sRGB=rgb_to_srgb(res2["reflectance"]),
        S_back_to_sRGB=rgb_to_srgb(res2["shading"]),
        r_back_to_sRGB=rgb_to_srgb(res2["RS_est"]),
        R_from_input=res1["reflectance"],
        S_from_input=res1["shading"],
        r_from_input=res1["RS_est"],
    )
    return npz_path[:-4] + "_decomposed.npz"


# ---- movies (helper:870-1060) --------------------------------------------

def load_movie(filename: str):
    """helper:870-904: frames as [N,H,W,3] linear float32 + (w, h, fps)."""
    import cv2

    cap = cv2.VideoCapture(filename)
    if not cap.isOpened():
        raise IOError("Could not open movie {}".format(filename))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        srgb = frame[:, :, ::-1] / 255.0
        frames.append(srgb_to_rgb(srgb).astype(np.float32))
    cap.release()
    return np.asarray(frames), [width, height, fps]


def _frame_to_bgr_u8(frame_hwc: np.ndarray) -> np.ndarray:
    """helper:621-632: linear -> sRGB, clip 0-1, *255, uint8, RGB->BGR.

    Grayscale (1-channel, e.g. rDirectly reflectance) is replicated to RGB
    (the reference's _color helper, helper:649-650)."""
    if frame_hwc.shape[-1] == 1:
        frame_hwc = np.repeat(frame_hwc, 3, axis=-1)
    srgb = rgb_to_srgb(frame_hwc)
    u8 = (np.clip(srgb, 0, 1) * 255).astype("u1")
    return u8[:, :, ::-1]


def _open_writer(name: str, width: int, height: int, fps: float):
    import cv2

    writer = cv2.VideoWriter(name, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps if fps and fps > 0 else 25.0,
                             (width, height), True)
    if not writer.isOpened():
        raise IOError("Could not open video writer for {}".format(name))
    return writer


def save_movie_combined(filename: str, image, reflectance, shading, stats):
    """helper:920-951: [img | R | S] triptych video."""
    width, height, fps = stats
    name = filename[:-4] + "-combined" + filename[-4:]
    writer = _open_writer(name, 3 * width, height, fps)
    for i in range(image.shape[0]):
        frame = np.concatenate([_frame_to_bgr_u8(image[i]),
                                _frame_to_bgr_u8(reflectance[i]),
                                _frame_to_bgr_u8(shading[i])], axis=1)
        writer.write(frame)
    writer.release()
    return name


def save_movie_separate(filename: str, image, reflectance, shading, stats):
    """helper:954-995: separate -r and -s videos."""
    width, height, fps = stats
    names = []
    for suffix, blob in (("-r", reflectance), ("-s", shading)):
        name = filename[:-4] + suffix + filename[-4:]
        writer = _open_writer(name, width, height, fps)
        for i in range(blob.shape[0]):
            writer.write(_frame_to_bgr_u8(blob[i]))
        writer.release()
        names.append(name)
    return names


def save_movie_baseline(filename: str, image, stats):
    """helper:998-1024: rgbMean and rgbNorm baseline decompositions."""
    outputs = []
    for tag, norm in (("rgbMean",
                       lambda f: np.maximum(f.sum(-1, keepdims=True) / 3,
                                            EPS)),
                      ("rgbNorm",
                       lambda f: np.maximum(
                           np.linalg.norm(f, axis=-1, keepdims=True), EPS))):
        refl = []
        shad = []
        for i in range(image.shape[0]):
            inten = norm(image[i])
            refl.append(image[i] / inten)
            shad.append(np.broadcast_to(inten, image[i].shape))
        base = filename[:-4] + "-baseline_" + tag + filename[-4:]
        outputs.append(save_movie_combined(base, image,
                                           np.asarray(refl),
                                           np.asarray(shad), stats))
    return outputs


def decompose_movie(movie_path: str, params, net_cfg: NetworkConfig,
                    results_dir: str, predict_fn=None,
                    batch_size: int = 8):
    """helper:1027-1060: baselines + CNN decomposition videos."""
    images, stats = load_movie(movie_path)
    orig = os.path.basename(movie_path)[:-4]
    out_dir = os.path.join(results_dir, "decompositions_sRGB")
    os.makedirs(out_dir, exist_ok=True)
    full_path = os.path.join(out_dir, orig + ".mp4")

    save_movie_baseline(full_path, images, stats)

    if predict_fn is None:
        predict_fn = make_predict_fn(net_cfg)
    start = timeit.default_timer()
    res = predict_batched(predict_fn, params, images, batch_size)
    dt = timeit.default_timer() - start
    n = images.shape[0]
    print("Predicting", n, "frames took", dt, "seconds, i.e.,",
          dt / n, "per frame and", n / dt, "fps.")

    refl, shad = res["reflectance"], res["shading"]
    save_movie_combined(full_path, images, refl, shad, stats)
    save_movie_separate(full_path, images, refl, shad, stats)
    return full_path


def decompose_files(files: Sequence[str], params, net_cfg: NetworkConfig,
                    results_dir: str, batch_size: int = 16):
    """File dispatch with per-file error containment (helper:410-435).

    Images go through the shape-grouped batched path; movies and npz
    archives are handled per file."""
    predict_fn = make_predict_fn(net_cfg)
    images = [f for f in files if is_image(f)]
    if images:
        try:
            decompose_images_batched(images, params, net_cfg, results_dir,
                                     predict_fn, batch_size)
        except Exception:
            print("Decomposing the image batch was not possible")
            traceback.print_exc()
    for f in files:
        try:
            if is_image(f):
                pass  # handled by the batched path above
            elif is_movie(f):
                decompose_movie(f, params, net_cfg, results_dir, predict_fn,
                                batch_size)
            elif is_numpy(f):
                decompose_numpy(f, params, net_cfg, predict_fn, batch_size)
            else:
                print("\nFile", f, "neither recognized as image, nor movie")
        except Exception:
            print("Decomposing file", f, "was not possible")
            traceback.print_exc()
