"""Device-mesh parallelism: data-parallel batched eval and training.

The reference is strictly single-GPU (caffe.set_mode_gpu(), helper:143;
SURVEY.md §2.4 records zero distributed machinery).  This rebuild makes
whole-test-set evaluation and training data-parallel over a
``jax.sharding.Mesh``:

  * batch axis 'data' sharded across devices, params replicated;
  * XLA inserts the cross-device collectives (grad psum, metric pmean)
    from the sharding annotations alone — no hand-written NCCL/MPI
    analogue, as laid out in SURVEY.md §5.8;
  * spatial sharding of huge single frames lives in parallel/spatial.py.

Everything works identically on the cards of one host (collectives go
through NCCL over NVLink) and on the CPU simulation mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N).
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.networks import NetworkConfig, apply_network
from ..models.recover import recover_reflectance_shading
from ..train.loop import LossConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices=None) -> Mesh:
    """1-D device mesh over the first n devices (default: all).  An
    explicit device list overrides jax.devices()."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
    """Join a multi-process job: jax.distributed.initialize + global mesh
    over all processes' devices (SURVEY.md §5.8).  Pass the coordinator
    address (``host:port``), process count and this process's id; nothing
    is auto-detected.  Returns the global mesh; data-parallel eval shards
    batches across processes."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return make_mesh()


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. params) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_batch(x, mesh: Mesh, axis: str = "data"):
    """Shard the leading (batch) axis across the mesh.

    Single-process form: ``x`` is the full global batch and this process
    can address every mesh device.  In a multi-host job each process
    only holds its local slice — use shard_batch_multihost instead
    (device_put of a global array onto non-addressable devices raises).
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(x, sharding)


def shard_batch_multihost(local_x, mesh: Mesh, axis: str = "data"):
    """Assemble a globally-sharded batch from each process's LOCAL slice.

    In a multi-process job (initialize_multihost) every process loads
    1/process_count of the dataset; this stitches those slices into one
    global jax.Array
    sharded on the batch axis — the multi-host twin of shard_batch.
    Processes must pass equal-sized slices ordered by process_id (the
    global batch is the process_id-ordered concatenation).  Works
    unchanged (and is equivalent to shard_batch) when process_count==1.
    """
    local_x = np.asarray(local_x)
    sharding = NamedSharding(mesh, P(axis))
    global_shape = ((local_x.shape[0] * jax.process_count(),)
                    + local_x.shape[1:])
    return jax.make_array_from_process_local_data(sharding, local_x,
                                                  global_shape)


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple (repeat last element); returns
    (padded, original_n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)
    return x, n


def make_sharded_eval(net_cfg: NetworkConfig, mesh: Mesh,
                      delta: float = 0.1, axis: str = "data"):
    """Build a jitted data-parallel evaluator.

    Returns eval_fn(params, images [N,H,W,3], comparisons [N,K+1,6],
    valid [N] float 0/1) -> (mean_whdr scalar, per_image_whdr [N]).
    N must divide by mesh size (use pad_to_multiple; mark the pad rows
    0 in ``valid`` — the mean is masked on device, so pad duplicates
    cannot bias it).  The mean reduction is the pmean of SURVEY.md §5.8
    expressed through shardings.
    """
    from ..losses.whdr import whdr_per_image

    batch_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def _eval(params, images, comparisons, valid):
        blobs = apply_network(params, images, net_cfg, train=False)
        mode = net_cfg.rs_est_mode.split("-")[0]
        if mode == "rDirectly":
            refl = jax.nn.relu(blobs["RS_est"])
        else:
            refl, _ = recover_reflectance_shading(
                blobs["RS_est"], images, net_cfg.rs_est_mode)
        # whdr_per_image: the flat-gather batched program (a vmapped
        # scalar whdr re-creates the per-image gather shape that
        # losses/whdr.py deliberately abandoned as pathologically slow
        # to compile)
        per_image = whdr_per_image(refl, comparisons, delta)
        mean = jnp.sum(per_image * valid) / jnp.sum(valid)
        return mean, per_image

    return jax.jit(_eval,
                   in_shardings=(rep, batch_sharding, batch_sharding,
                                 batch_sharding),
                   out_shardings=(rep, batch_sharding))


def make_sharded_train_step(net_cfg: NetworkConfig, loss_cfg: LossConfig,
                            optimizer, mesh: Mesh, axis: str = "data",
                            preselected: bool = False):
    """Build the data-parallel jitted train step.

    Params/opt-state replicated, batch sharded on 'data'; XLA inserts the
    gradient all-reduce.  Signature matches train.loop.make_train_step's
    step: (params, opt_state, images, comparisons, key,
    metric_comparisons=None) -> (params, opt_state, metrics) — the step
    body is the SAME _make_step_body the single-device trainer jits, so
    augmented-comparisons training keeps the whdr_original metric wired
    to the plain comparisons blob (networks.py:243-254).  ``preselected``
    mirrors make_train_step: set it when feeding host-compacted blobs
    (select_comparisons_host) so dense-skip/ratio/cap selection is not
    re-applied on device.
    """
    from ..train.loop import _make_step_body

    batch_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    _step = jax.jit(
        _make_step_body(net_cfg, loss_cfg, optimizer,
                        preselected=preselected),
        in_shardings=(rep, rep, batch_sharding, batch_sharding,
                      batch_sharding, rep),
        out_shardings=(rep, rep, rep))

    def step(params, opt_state, images, comparisons, key,
             metric_comparisons=None):
        if metric_comparisons is None:
            metric_comparisons = comparisons
        return _step(params, opt_state, images, comparisons,
                     metric_comparisons, key)

    return step


# jit caches by function identity, so rebuilding the evaluator closure
# per call would recompile every time (seconds per compile); cache per
# logical config instead.  Insertion-ordered
# dict: evict the OLDEST entry past the cap (clearing everything would
# throw away hot compiled evaluators with it).
_EVAL_CACHE: Dict = {}


def _cached_sharded_eval(net_cfg: NetworkConfig, mesh: Mesh, delta: float):
    key = (net_cfg, mesh, float(delta))  # NetworkConfig is frozen/hashable
    fn = _EVAL_CACHE.get(key)
    if fn is None:
        fn = make_sharded_eval(net_cfg, mesh, delta)
        if len(_EVAL_CACHE) > 16:
            _EVAL_CACHE.pop(next(iter(_EVAL_CACHE)))
        _EVAL_CACHE[key] = fn
    return fn


def eval_dataset_sharded(params, X: Dict, net_cfg: NetworkConfig,
                         mesh: Mesh, delta: float = 0.1,
                         batch_size: Optional[int] = None):
    """Data-parallel WHDR over a whole dataset dict; returns (mean, [N]).

    ``batch_size`` (per device) chunks the sweep into programs of
    batch_size * n_devices images — bounding HBM residency for splits
    too large to evaluate as one batch.  None evaluates the whole set
    in a single program (fastest when it fits)."""
    n_dev = len(mesh.devices.flatten())
    images = np.asarray(X["images"], np.float32)
    comps = np.asarray(X["comparisons"], np.float32)
    n = images.shape[0]

    eval_fn = _cached_sharded_eval(net_cfg, mesh, delta)
    params_r = replicate(params, mesh)

    # chunk must divide by the mesh so every slice pads to a shardable
    # length; batch_size=None = one whole-set program (padded to n_dev)
    chunk = (-(-n // n_dev) * n_dev if batch_size is None
             else batch_size * n_dev)
    outs = []
    for s in range(0, n, chunk):
        im, _ = pad_to_multiple(images[s:s + chunk], chunk)
        cp, k = pad_to_multiple(comps[s:s + chunk], chunk)
        valid = np.zeros(im.shape[0], np.float32)
        valid[:k] = 1.0
        _, per_image = eval_fn(params_r,
                               shard_batch(jnp.asarray(im), mesh),
                               shard_batch(jnp.asarray(cp), mesh),
                               shard_batch(jnp.asarray(valid), mesh))
        outs.append(np.asarray(per_image)[:k])
    per_image = np.concatenate(outs)
    return float(np.mean(per_image)), per_image
