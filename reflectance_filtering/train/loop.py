"""Training loop: one jitted XLA program per step.

The reference's training step is a C++ solver loop that calls back into
Python layers per batch (SURVEY.md §3.3 — the structural bottleneck).  Here
forward (network trunk -> R/S recovery -> losses), backward (autodiff) and
the optimizer update are a single compiled function; the host only feeds
batches and observes scalar metrics.

Loss graph wiring mirrors training/networks.py:222-301:
  * whdr hinge on the configured comparisons type, weight loss_scale_whdr
  * exact WHDR as a 0-weight 'accuracy' blob
  * boundary losses on reflectance+shading when loss_scale_boundaries01 != 0
    and RS_est_mode != rDirectly
  * lambert (EuclideanLoss of R*S vs I) when RS_est_mode == 'RS'
  * cascadeSkipLayers adds the level-0 hinge + WHDR
    (networks.py:995-1024)

Solver semantics follow _get_solver (train_with_barrista_helper.py:447-460):
ADAM (caffe defaults b1=.9 b2=.999 eps=1e-8) or plain SGD, base_lr flag.
Batches cycle through the training set in order (barrista's cycling data
monitor behavior); ``iterations`` counts samples, like the reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.networks import NetworkConfig, apply_network, init_network
from ..models.recover import recover_reflectance_shading
from ..losses.whdr import whdr_batch, whdr_hinge_batch, parse_wdm_string
from ..losses.losses import boundary_loss, lambert_loss


@dataclasses.dataclass
class LossConfig:
    """Loss-shaping flags (train_with_barrista.py:172-295)."""
    loss_scale_whdr: float = 10.0
    loss_scale_lambert: float = 0.0
    loss_scale_boundaries01: float = 0.1
    shading_unary_type: str = "L1_0.5"      # first two chars pick the norm
    whdr_delta_margin_ratio_dense: str = "0.1_0.05_1.0_1"

    @property
    def boundary_norm(self) -> str:
        return self.shading_unary_type[:2]

    @property
    def wdm(self):
        return parse_wdm_string(self.whdr_delta_margin_ratio_dense)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0          # optimizer steps taken
    samples: int = 0       # samples processed (the reference's 'iter')


# Device-residency caps for fit()'s feeds, as shares of the memory the
# device gives JAX (memory_stats()["bytes_limit"]): half for the
# whole-dataset training feed, an eighth for the live-validation split
# pinned by make_val_whdr_fn; the rest stays for params, activations and
# compiler scratch.  The CPU backend reports no limit, so there the shares
# apply to a stated host budget.  A share of 0 forces the host-fed path.
DEVICE_FEED_SHARE = 0.5
VAL_FEED_SHARE = 0.125
HOST_MEMORY_BUDGET_BYTES = 16 * 1024 ** 3


def _feed_budget(share: float) -> int:
    """Bytes a feed may pin on the device."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit") or HOST_MEMORY_BUDGET_BYTES
    return int(limit * share)

# Steps per jitted scan chunk in fit()'s device-resident trainer.  Large
# enough to amortize the per-dispatch host round trip, small enough that
# checkpoint-boundary remainder chunks stay few (one compile per
# distinct length).
TRAIN_CHUNK_STEPS = 32


def _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                 batch_size: int):
    """Host-side fan-out of one completed scan chunk: ONE device sync
    for the stacked metrics, then per-step callback delivery in order."""
    step0, k, samples0, stacked, st = pending
    host = {key: np.asarray(v) for key, v in stacked.items()}
    for j in range(k):
        fan_out_metrics(step0 + j, samples0 + (j + 1) * batch_size,
                        {key: float(a[j]) for key, a in host.items()
                         if a.ndim == 1})
    maybe_checkpoint(st)


def make_val_whdr_fn(net_cfg: NetworkConfig, X_val: Dict,
                     batch_size: int = 20) -> Optional[Callable]:
    """Live validation metric for fit(): mean exact WHDR (delta 0.1 —
    the metric layer's pinned delta) of the val split under the current
    params.

    Realizes the reference's interleaved test phase: it schedules a test
    net alongside training (train_with_barrista_helper.py:286-294) and
    shows a live 'Test' WHDR field in the progressbar
    (extend_monitoring.py:326-360).  Here the whole split is
    device-resident and the sweep is ONE jitted scan, so an eval costs a
    single device program instead of the reference's per-batch Python
    callbacks.

    Returns ``params -> float`` (WHDR fraction), or None for an empty
    split.

    The split is pinned in device memory for the whole fit only when it
    fits a budget (VAL_FEED_SHARE of the device — the training feed
    separately budgets up to DEVICE_FEED_SHARE, and both plus
    params/activations must share the card); larger splits fall back to
    a host-fed per-batch eval, slower per checkpoint but never OOMing
    the run.
    """
    from ..losses.whdr import whdr_per_image
    images = np.asarray(X_val["images"], np.float32)
    comps = np.asarray(X_val["comparisons"], np.float32)
    n = images.shape[0]
    if n == 0:
        return None
    bs = min(batch_size, n)
    pad = (-n) % bs
    if pad:  # wrap-pad to a batch multiple; padded rows masked below
        images = np.concatenate([images, images[:pad]], axis=0)
        comps = np.concatenate([comps, comps[:pad]], axis=0)
    nb = images.shape[0] // bs
    mode = net_cfg.rs_est_mode.split("-")[0]

    def _batch_whdr(params, im, cp):
        blobs = apply_network(params, im, net_cfg, train=False)
        if mode == "rDirectly":
            refl = jax.nn.relu(blobs["RS_est"])
        else:
            refl, _ = recover_reflectance_shading(
                blobs["RS_est"], im, net_cfg.rs_est_mode)
        return whdr_per_image(refl, cp, 0.1)

    if images.nbytes + comps.nbytes <= _feed_budget(VAL_FEED_SHARE):
        im_d = jnp.asarray(images.reshape((nb, bs) + images.shape[1:]))
        cp_d = jnp.asarray(comps.reshape((nb, bs) + comps.shape[1:]))

        @jax.jit
        def _eval(params):
            def body(carry, xs):
                im, cp = xs
                return carry, _batch_whdr(params, im, cp)
            _, w = jax.lax.scan(body, jnp.float32(0.0), (im_d, cp_d))
            return jnp.mean(w.reshape(-1)[:n])

        def val_whdr(params) -> float:
            return float(_eval(params))
    else:
        im_h = images.reshape((nb, bs) + images.shape[1:])
        cp_h = comps.reshape((nb, bs) + comps.shape[1:])
        batch_eval = jax.jit(_batch_whdr)

        def val_whdr(params) -> float:
            ws = np.concatenate([np.asarray(batch_eval(params, im_h[i],
                                                       cp_h[i]))
                                 for i in range(nb)])
            return float(np.mean(ws[:n]))

    return val_whdr


def make_optimizer(solver_type: str = "ADAM", base_lr: float = 0.001):
    """helper:447-460."""
    if solver_type in ("SGD", "sgd"):
        return optax.sgd(base_lr)
    if solver_type in ("ADAM", "Adam", "adam"):
        return optax.adam(base_lr, b1=0.9, b2=0.999, eps=1e-8)
    raise ValueError("solverType not known: {}".format(solver_type))


def compute_losses(params, images, comparisons, net_cfg: NetworkConfig,
                   loss_cfg: LossConfig, key=None, train: bool = True,
                   metric_comparisons=None, preselected: bool = False
                   ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Forward + full loss graph.  images NHWC, comparisons [B,K+1,6].

    ``comparisons`` drives the hinge loss (the configured comparisonsType);
    ``metric_comparisons`` (default: same blob) drives the 0-weight
    whdr_original accuracy — the reference always wires the metric to the
    plain 'comparisons' blob even when training on 'augmented'
    (networks.py:243-254).

    ``preselected``: the blob already went through host-side evaluation
    selection (losses.whdr.select_comparisons_host) — the hinge must not
    re-apply dense-skip/ratio/cap, only the prefix mask.
    """
    if metric_comparisons is None:
        metric_comparisons = comparisons
    delta, margin, ratio, eval_dense = loss_cfg.wdm
    if preselected:
        ratio, eval_dense = 1.0, True
    blobs = apply_network(params, images, net_cfg, train=train)
    bn_stats = blobs.get("__bn_stats__", {})
    mode = net_cfg.rs_est_mode.split("-")[0]
    if mode == "rDirectly":
        reflectance = jax.nn.relu(blobs["RS_est"])
        shading = reflectance
    else:
        reflectance, shading = recover_reflectance_shading(
            blobs["RS_est"], images, net_cfg.rs_est_mode)

    metrics: Dict[str, jnp.ndarray] = {}
    if bn_stats:
        metrics["bn_stats"] = jax.lax.stop_gradient(bn_stats)
    total = jnp.float32(0.0)

    hinge = whdr_hinge_batch(reflectance, comparisons, delta, margin,
                             ratio, eval_dense, key)
    metrics["loss_whdr_hinge"] = hinge
    total = total + loss_cfg.loss_scale_whdr * hinge

    # The reference pins the metric layer's delta to 0.1 regardless of the
    # hinge's wdm string (networks.py wires WhdrLayer with param_str '0.1');
    # only the hinge uses the configured delta.
    metrics["whdr_original"] = jax.lax.stop_gradient(
        whdr_batch(reflectance, metric_comparisons, 0.1))

    if loss_cfg.loss_scale_boundaries01 and mode != "rDirectly":
        br = boundary_loss(reflectance, loss_cfg.boundary_norm)
        bs = boundary_loss(shading, loss_cfg.boundary_norm)
        metrics["loss_boundaries_reflectance"] = br
        metrics["loss_boundaries_shading"] = bs
        total = total + loss_cfg.loss_scale_boundaries01 * (br + bs)

    if mode == "RS":
        lam = lambert_loss(reflectance, shading, images)
        metrics["loss_lambert"] = lam
        total = total + loss_cfg.loss_scale_lambert * lam

    if net_cfg.network_type == "cascadeSkipLayers":
        refl0 = blobs["reflectance_level0"]
        hinge0 = whdr_hinge_batch(refl0, comparisons, delta, margin,
                                  ratio, eval_dense, key)
        metrics["loss_whdr_hinge_level0"] = hinge0
        total = total + loss_cfg.loss_scale_whdr * hinge0
        metrics["whdr_original_level0"] = jax.lax.stop_gradient(
            whdr_batch(refl0, metric_comparisons, 0.1))

    metrics["loss_total"] = total
    return total, metrics


def _make_step_body(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                    optimizer, preselected: bool = False) -> Callable:
    """Pure (un-jitted) step body shared by the per-step and the
    scan-chunked trainers: forward + autodiff backward + optax update
    (+ BatchNorm running-stat EMA)."""
    from ..models.networks import update_bn_stats

    def loss_fn(params, images, comparisons, metric_comparisons, key):
        return compute_losses(params, images, comparisons, net_cfg,
                              loss_cfg, key, train=True,
                              metric_comparisons=metric_comparisons,
                              preselected=preselected)

    def body(params, opt_state, images, comparisons, metric_comparisons,
             key):
        (_, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, images, comparisons,
                                   metric_comparisons, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        bn_stats = metrics.pop("bn_stats", None)
        if bn_stats:
            params = update_bn_stats(params, bn_stats)
        return params, opt_state, metrics

    return body


def make_train_step(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                    optimizer, preselected: bool = False) -> Callable:
    """Build the jitted step — one XLA program.

    Signature: (params, opt_state, images, comparisons, key,
    metric_comparisons=None) -> (params, opt_state, metrics)."""
    _step = jax.jit(_make_step_body(net_cfg, loss_cfg, optimizer,
                                    preselected))

    def step(params, opt_state, images, comparisons, key,
             metric_comparisons=None):
        if metric_comparisons is None:
            metric_comparisons = comparisons
        return _step(params, opt_state, images, comparisons,
                     metric_comparisons, key)

    return step


def make_train_chunk(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                     optimizer, images_v, comps_v, metric_v,
                     batch_size: int) -> Callable:
    """Scan-chunked trainer over a DEVICE-RESIDENT dataset
    (``images_v``/``comps_v``/``metric_v`` wrap-padded by batch_size-1
    rows; the true dataset length is rows - (batch_size-1)).

    Runs ``k`` consecutive steps inside one jitted lax.scan and returns
    per-step metrics stacked along axis 0 — the host syncs once per
    chunk instead of once per step (each readback is a full device
    round trip, which costs more than a small step).
    Per-step values, batch order (sequential cycling, helper:286), and
    per-step RNG (fold_in(root, global_step)) are identical to the
    per-step trainer.

    Signature: chunk(params, opt_state, root_key, step0, cursor0, k)
    -> (params, opt_state, stacked_metrics); step0/cursor0 are traced
    (one compile per distinct k).
    """
    body = _make_step_body(net_cfg, loss_cfg, optimizer)
    # inputs arrive WRAP-PADDED by batch_size-1 rows (fit() pads on the
    # host): sequential cycling makes every batch a contiguous row
    # range, so each batch is ONE dynamic_slice instead of a jnp.take
    # row gather inside the scan
    n = images_v.shape[0] - (batch_size - 1)

    @functools.partial(jax.jit, static_argnames=("k",))
    def chunk(params, opt_state, root_key, step0, cursor0, k: int):
        def scan_body(carry, s):
            params, opt_state = carry
            start = (cursor0 + s * batch_size) % n
            b_images = jax.lax.dynamic_slice_in_dim(
                images_v, start, batch_size, 0)
            b_comps = jax.lax.dynamic_slice_in_dim(
                comps_v, start, batch_size, 0)
            b_metric = jax.lax.dynamic_slice_in_dim(
                metric_v, start, batch_size, 0)
            key = jax.random.fold_in(root_key, step0 + s)
            params, opt_state, metrics = body(
                params, opt_state, b_images, b_comps, b_metric, key)
            return (params, opt_state), metrics

        (params, opt_state), stacked = jax.lax.scan(
            scan_body, (params, opt_state),
            jnp.arange(k, dtype=jnp.int32))
        return params, opt_state, stacked

    return chunk


def fit(net_cfg: NetworkConfig, loss_cfg: LossConfig, X: Dict,
        iterations: int, batch_size: int,
        solver_type: str = "ADAM", base_lr: float = 0.001,
        random_seed: int = -1,
        comparisons_type: str = "comparisons",
        init_params=None, init_opt_state=None, base_samples: int = 0,
        callbacks=(), checkpointer=None,
        progress: Optional[Callable] = None,
        on_checkpoint: Optional[Callable] = None,
        val_fn: Optional[Callable] = None) -> TrainState:
    """Train for ``iterations`` samples (the reference's unit, helper:286).

    X: {'images' [N,H,W,3], 'comparisons' [N,K+1,6][, 'augmented']} — the
    loader's NHWC layout.  Batches cycle sequentially.  Returns TrainState.

    Resume: pass ``init_params``/``init_opt_state`` from a checkpoint plus
    ``base_samples`` (the checkpoint's sample counter); the data cursor,
    checkpoint numbering, and per-step RNG continue where the original run
    left off — per-step keys are ``fold_in(root, global_step)``, so
    fit(n) == resume-at-k + fit(n-k) exactly for the same seed.
    """
    seed = random_seed if random_seed >= 0 else np.random.randint(2 ** 31)
    root_key = jax.random.PRNGKey(seed)

    if init_params is None:
        params = init_network(jax.random.fold_in(root_key, 2 ** 31 - 1),
                              net_cfg)
    else:
        params = init_params

    optimizer = make_optimizer(solver_type, base_lr)
    opt_state = (optimizer.init(params) if init_opt_state is None
                 else init_opt_state)

    images = np.asarray(X["images"], np.float32)
    comps = np.asarray(X[comparisons_type], np.float32)
    # the whdr_original metric always reads the plain comparisons blob
    # (networks.py:243-254), even when training on 'augmented'
    metric_comps = np.asarray(X["comparisons"], np.float32)
    n = images.shape[0]

    # Oversized hinge blobs (augmented, K=60,049 > the 1500 cap): the
    # evaluation selection moves HOST-side (select_comparisons_host) and
    # the device sees a compact [B, 1501, 6] blob per step — removing
    # the 60k-row device gather, the double-argsort cap rank, and ~98%
    # of the per-step comparison-feed bytes.  The reference also selects
    # host-side (np.random.choice, whdr_hinge_loss_layer.py:142-148).
    from ..losses.whdr import (MAX_EVALUATED_COMPARISONS,
                               select_comparisons_host)
    host_select = comps.shape[1] - 1 > MAX_EVALUATED_COMPARISONS
    step_fn = make_train_step(net_cfg, loss_cfg, optimizer,
                              preselected=host_select)
    _, _, sel_ratio, sel_dense = loss_cfg.wdm

    base_steps = base_samples // batch_size
    state = TrainState(params, opt_state, base_steps, base_samples)
    num_steps = (iterations - base_samples) // batch_size
    cursor = base_samples % n

    # Device-resident feeding: a per-step host->device copy of a ~16 MB
    # batch costs as much as a small step.  Upload the whole set once
    # when it fits its budget of device memory and slice batches on
    # device; 'augmented' IIW blobs (~9 GB with images) with
    # host-side selection fall back to per-step feeding.
    # metric_comps is the SAME array as comps unless training on
    # 'augmented' — count and upload shared blobs once
    shared_metric = metric_comps is comps
    feed_bytes = images.nbytes + comps.nbytes + (
        0 if shared_metric else metric_comps.nbytes)
    # n >= batch_size keeps the wrap-pad slice equivalent to the
    # per-step path's elementwise modulo (smaller sets would clamp
    # silently); tiny debug sets use the per-step trainer instead
    feed_budget = _feed_budget(DEVICE_FEED_SHARE)
    on_device = (feed_bytes <= feed_budget
                 and n >= batch_size and num_steps > 0
                 and not host_select)

    # wrap-pad by batch_size-1 rows on the HOST so every sequential
    # batch is one contiguous dynamic_slice on device, then upload
    # exactly one copy (padding on device would briefly hold both
    # the original and the padded buffer in device memory)
    def _wrap_pad(a):
        if batch_size > 1:
            a = np.concatenate([a, a[:batch_size - 1]], axis=0)
        return jnp.asarray(a)

    if on_device:
        images_v = _wrap_pad(images)
        comps_v = _wrap_pad(comps)
        metric_v = comps_v if shared_metric else _wrap_pad(metric_comps)

    # host-select runs make the step device-cheap again, but the 9 GB
    # augmented blob still pins the COMPACT comps to per-step host
    # feeding; images + the plain metric blob are small — keep those
    # device-resident when they fit so the per-step transfer is just the
    # ~0.7 MB compact blob
    half_resident = (host_select and num_steps > 0 and n >= batch_size
                     and images.nbytes + metric_comps.nbytes
                     <= feed_budget)
    if half_resident:
        images_d = _wrap_pad(images)
        metric_d = _wrap_pad(metric_comps)

    # live validation (reference: interleaved test phase + progressbar
    # 'Test' field): evaluated at every checkpoint save, carried into
    # the metric stream of all subsequent steps — the callbacks (jsonl
    # log) and ProgressPrinter pick 'val_whdr' up from there.  Eval uses
    # no RNG and reads nothing the trainer mutates, so batch order,
    # per-step keys and resume equivalence are untouched.
    last_val = [None]

    def fan_out_metrics(s_global, samples, host_metrics):
        if last_val[0] is not None:
            host_metrics.setdefault("val_whdr", last_val[0])
        # callbacks see the GLOBAL step so a resumed run keeps the step
        # sequence monotonic (JsonlLogger records / print cadence)
        for cb in callbacks:  # each: (step, metrics) -> metrics | None
            out = cb(s_global, host_metrics)
            if isinstance(out, dict):
                host_metrics = out
        if progress is not None:
            progress(s_global, samples, host_metrics)

    def on_saved(st):
        """Checkpoint-time side effects (shared by the in-loop saves
        and the finalize save): live val WHDR + the user callback."""
        if val_fn is not None:
            last_val[0] = val_fn(st.params)
            print("Validation WHDR at iteration {}: {:.2f}"
                  .format(st.samples, 100.0 * last_val[0]))
        if on_checkpoint is not None:
            on_checkpoint(st.samples, st.params)

    def maybe_checkpoint(st):
        if checkpointer is not None:
            # crossing-based rule (prev = the step before): keeps saving
            # on resumes whose batch size differs from the run that laid
            # down the original sample grid
            saved = checkpointer.maybe_save(st.samples, st.params,
                                            st.opt_state,
                                            prev=st.samples - batch_size)
            if saved:
                on_saved(st)

    if on_device and num_steps > 0:
        # Scan-chunked trainer: k steps per device program, one host
        # sync per chunk (stacked per-step metrics), chunk boundaries
        # aligned so every checkpoint step is the LAST step of its chunk
        # (params are only materialized at chunk ends).  Values, batch
        # order, per-step RNG and callback order are identical to the
        # per-step trainer (gate: the resume-equivalence tests).
        chunk_fn = make_train_chunk(net_cfg, loss_cfg, optimizer,
                                    images_v, comps_v, metric_v,
                                    batch_size)

        def chunk_len(s):
            limit = min(s + TRAIN_CHUNK_STEPS, num_steps)
            if checkpointer is not None:
                for j in range(s, limit):
                    if checkpointer.would_save(
                            base_samples + (j + 1) * batch_size,
                            prev=base_samples + j * batch_size):
                        return j - s + 1
            return limit - s

        pending = None    # (step0, k, samples0, stacked_metrics, state)
        s = 0
        while s < num_steps:
            k = chunk_len(s)
            params, opt_state, stacked = chunk_fn(
                state.params, state.opt_state, root_key,
                base_steps + s, (base_samples + s * batch_size) % n, k)
            state = TrainState(params, opt_state, base_steps + s + k,
                               base_samples + (s + k) * batch_size)
            if pending is not None:
                _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                             batch_size)
            pending = (base_steps + s, k,
                       base_samples + s * batch_size, stacked, state)
            s += k
        if pending is not None:
            _drain_chunk(pending, fan_out_metrics, maybe_checkpoint,
                         batch_size)
    else:
        # Per-step trainer (host-fed datasets).  The host fan-out for
        # step s (float() readbacks = device sync) runs after step s+1
        # is DISPATCHED, so monitor work overlaps device compute.
        pending = None
        for s in range(num_steps):
            start = cursor
            idx = (cursor + np.arange(batch_size)) % n
            cursor = (cursor + batch_size) % n
            step_key = jax.random.fold_in(root_key, base_steps + s)
            if host_select:
                # selection keyed by the GLOBAL step: deterministic and
                # resume-stable, like the device path's fold_in key
                sel_rng = np.random.RandomState(
                    np.array([seed & 0x7fffffff, base_steps + s],
                             dtype=np.uint32))
                b_comps = jnp.asarray(select_comparisons_host(
                    comps[idx], sel_ratio, sel_dense, sel_rng))
            else:
                b_comps = jnp.asarray(comps[idx])
            if half_resident:
                b_images = jax.lax.dynamic_slice_in_dim(
                    images_d, start, batch_size, 0)
                b_metric = jax.lax.dynamic_slice_in_dim(
                    metric_d, start, batch_size, 0)
            else:
                b_images = jnp.asarray(images[idx])
                b_metric = jnp.asarray(metric_comps[idx])
            params, opt_state, metrics = step_fn(
                state.params, state.opt_state, b_images, b_comps,
                step_key, b_metric)
            state = TrainState(params, opt_state, base_steps + s + 1,
                               base_samples + (s + 1) * batch_size)
            if pending is not None:
                s_g, st, mets = pending
                fan_out_metrics(s_g, st.samples,
                                {k: float(v) for k, v in mets.items()
                                 if np.ndim(v) == 0})
                maybe_checkpoint(st)
            pending = (base_steps + s, state, metrics)
        if pending is not None:
            s_g, st, mets = pending
            fan_out_metrics(s_g, st.samples,
                            {k: float(v) for k, v in mets.items()
                             if np.ndim(v) == 0})
            maybe_checkpoint(st)
    if checkpointer is not None and num_steps > 0:
        saved = checkpointer.maybe_save(state.samples, state.params,
                                        state.opt_state, finalize=True)
        if saved:
            on_saved(state)
    return state
