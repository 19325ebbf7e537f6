"""Training / prediction CLI — rebuild of training/train_with_barrista.py +
the fit/predict orchestration of train_with_barrista_helper.py.

Same flag set (train_with_barrista.py:124-314), same results tree
(images logs networks progressions scores framerates snapshots
decompositions_linear decompositions_sRGB, :319-331), same 0command.txt
audit log (:333-346), same experiment lifecycle: fit -> final + per
checkpoint validation WHDR -> progressions/*.json (helper:300-364);
predict -> hyperparameters recovered from the checkpoint filename
(helper:369-392) -> batch scoring or per-file decompose (helper:396-436).

New flag (documented deviation): --data_root points at the dataset folder
(the reference hardcodes ~/LMDBs, data_handling.py:40-42; default is the
same, so reference-style setups work unchanged), and --results_root
replaces the hardcoded ~/Results (train_with_barrista.py:319-321).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import timeit

import numpy as np

from ..data.loader import get_data
from ..models.networks import NetworkConfig
from ..train.checkpoint import Checkpointer, load_checkpoint
from ..train.description import get_description, parse_description
from ..train.loop import LossConfig, fit
from ..train.monitors import (CombineLosses, JsonlLogger, ProgressPrinter,
                              RunningAverage)
from ..train.predict import decompose_files, make_predict_fn, predict_and_score
from ..models.networks import init_network
import jax

FLAGS_FIT = ["fit", "f", "train"]
FLAGS_PREDICT = ["predict", "p", "test", "val"]

RESULT_SUBDIRS = ["images", "logs", "networks", "progressions", "scores",
                  "framerates", "snapshots", "decompositions_linear",
                  "decompositions_sRGB"]


def build_parser():
    parser = argparse.ArgumentParser(
        description="Parses the arguments and then runs the appropriate mode.")
    add = parser.add_argument
    add("--stage", "-s", dest="stage", help="fit or predict")
    add("--iterations", "-i", type=int,
        help="number of iterations to train or with which trained iteration "
             "to predict")
    add("--solver", dest="solverType", default="ADAM", help="ADAM or SGD")
    add("--base_lr", "-lr", dest="base_lr", type=float, default=0.001)
    add("--comparisonsType", "-comp", dest="comparisonsType",
        default="comparisons", choices=["comparisons", "augmented"])
    add("--networkType", "-net", dest="networkType",
        default="convStaticWithSigmoid",
        choices=["uNet", "simpleConvolutionsRelu", "convStatic",
                 "convIncreasing", "convStaticWithSigmoid",
                 "convStaticSkipLayers", "cascadeSkipLayers"])
    add("--loss_scale_whdr", type=float, default=10)
    add("--loss_scale_lambert", type=float, default=0.0)
    add("--shading_unary_type", default="L1_0.5")
    add("--loss_scale_boundaries01", type=float, default=0.1)
    add("--batch_size", "-b", dest="batch_size", type=int, default=20)
    add("--predictCaffemodel", "-pcm", dest="predictCaffemodel", default=None,
        help="to directly predict for a certain checkpoint")
    # default None so predict mode can tell "user said 256" from "user
    # said nothing" (an explicit flag beats the checkpoint-name parse;
    # the reference default 256 is applied in fit_predict_net)
    add("--height", type=int, default=None)
    add("--width", type=int, default=None)
    add("--startOver", type=int, default=1)
    add("--alwaysComputeShadingLosses", type=int, default=0)
    add("--numLayers", dest="numLayers", type=int, default=2)
    add("--RS_est_mode", "-RS", dest="RS_est_mode", default="rRelMax",
        choices=["sAbs", "S", "rAbs", "R", "RS",
                 "rRelNorm", "rRelMean", "rRelY", "rRelMax",
                 "sRelNorm", "sRelMean", "sRelY", "sRelMax", "rDirectly"])
    add("--kernel_pad", type=int, default=1)
    add("--num_filters_log", type=int, default=4)
    add("--use_batch_normalization", type=int, default=0)
    add("--checkpoint_interval", type=int, default=1000)
    add("--experiment", "-exp", dest="experiment_name", default="tmp")
    add("--random_seed", type=int, default=-1)
    add("--dataset", default="iiw",
        choices=["iiw", "sintel", "mixed", "nonsense"])
    add("--sRGB_linear", default="linear", choices=["sRGB", "linear"])
    add("--whdr_delta_margin_ratio_dense", default="0.1_0.05_1.0_1")
    add("--test", type=int, default=0)
    add("--dilation", type=int, default=1)
    add("--matmul_precision", default="highest",
        choices=["default", "high", "highest"],
        help="matmul precision for training convs (training has no "
             "bitwise parity contract; 'default' lets the device use its "
             "fastest reduced-precision mode, e.g. TF32)")
    add("--decompose", action="append",
        help="decompose images in a folder or a video")
    # framework additions (defaults match the reference's hardcoded paths)
    add("--data_root", default=os.path.join(os.path.expanduser("~"), "LMDBs"))
    add("--results_root",
        default=os.path.join(os.path.expanduser("~"), "Results"))
    add("--profile_dir", default=None,
        help="write an XLA-level device trace of the fit stage here "
             "(open with xprof / tensorboard --logdir)")
    return parser


def net_config_from_args(args) -> NetworkConfig:
    return NetworkConfig(
        network_type=args.networkType,
        num_layers=args.numLayers,
        num_filters_log=args.num_filters_log,
        kernel_pad=args.kernel_pad,
        dilation=args.dilation,
        use_batch_normalization=bool(args.use_batch_normalization),
        rs_est_mode=args.RS_est_mode,
    )


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        loss_scale_whdr=args.loss_scale_whdr,
        loss_scale_lambert=args.loss_scale_lambert,
        loss_scale_boundaries01=args.loss_scale_boundaries01,
        shading_unary_type=args.shading_unary_type,
        whdr_delta_margin_ratio_dense=args.whdr_delta_margin_ratio_dense,
    )


def _existing_snapshots(snapshot_dir: str, description: str):
    """Sorted sample counts of on-disk snapshots for a description."""
    pat = re.compile(re.escape(description) + r"_barrista_iter_(\d+)\.npz$")
    if not os.path.isdir(snapshot_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(snapshot_dir)
                  for m in [pat.match(f)] if m)


def fit_predict_net(args, results_dir: str):
    """The experiment lifecycle (helper:141-439)."""
    if args.stage in FLAGS_PREDICT and not args.predictCaffemodel:
        # without a checkpoint the predict stage would fall through every
        # branch and exit 0 having predicted/decomposed NOTHING (the
        # reference crashes on parsing a None filename, helper:369-375 —
        # fail with an actionable message instead)
        raise ValueError(
            "--stage=predict requires --predictCaffemodel "
            "(the checkpoint to predict with)")
    if args.stage in FLAGS_PREDICT and args.predictCaffemodel:
        # recover hyperparameters from the checkpoint filename FIRST
        # (helper:369-392), so the description, the val-data resolution
        # and the network config all match the checkpoint — parsing
        # after the data load (as the reference orders it) makes a
        # predict run fail on a missing default-resolution val blob
        # even when the checkpoint encodes a different size (found by
        # the round-5 on-chip fit->predict drive at h32w32)
        try:
            parsed = parse_description(
                os.path.basename(args.predictCaffemodel))
        except (ValueError, IndexError):
            # e.g. the raw reference 'learned_weights.caffemodel' —
            # _load_params_any accepts it, but its name encodes no
            # config; keep the CLI args
            parsed = {}
            print("Checkpoint name encodes no config; using CLI args.")
        for k, v in parsed.items():
            if k in ("height", "width") and getattr(args, k) is not None:
                continue  # an explicit CLI size beats the checkpoint's
                # (the net is fully convolutional: scoring a different
                # resolution than it was trained at is a valid ask)
            setattr(args, k, v)
        if parsed:
            print("Inferred parameters:", parsed)
    # the reference's defaults, applied only where nothing was given
    # explicitly and the checkpoint name supplied nothing
    if args.height is None:
        args.height = 256
    if args.width is None:
        args.width = 256
    net_params, description = get_description(args)
    snapshot_dir = os.path.join(results_dir, "snapshots")
    additional_info = "_{}_{}_{}".format(args.height, args.width,
                                         args.sRGB_linear)

    def getData(desc):
        return get_data(args.dataset, desc + additional_info,
                        args.comparisonsType, root=args.data_root)

    if args.stage not in FLAGS_FIT + FLAGS_PREDICT:
        raise ValueError(
            "stage '{}' is currently not implemented!".format(args.stage))

    if args.dataset in ("sintel", "mixed"):
        # The reference's sintel path is vestigial: it loads 'albedos'
        # (data_handling.py:68-69) and wires them as a third bottom into
        # both WHDR layers (networks.py:227-245), but the layers never
        # read bottom[2] — _get_comparisons_from_bottom uses only the
        # comparisons blob and get_comparisons_from_blob's
        # ground_truth_albedo parameter is accepted and ignored
        # (whdr_layer.py:201-242).  With sintel's empty comparisons the
        # hinge returns 0 with zero gradient, i.e. the reference silently
        # trains on nothing.  Fail loudly instead of mis-training.
        raise NotImplementedError(
            "--dataset={} is not supported: the reference never shipped "
            "the albedo-to-comparisons generation its sintel mode needs "
            "(its WHDR layers ignore the albedos bottom), so training "
            "would silently optimize nothing. Use --dataset=iiw.".format(
                args.dataset))

    print("Descriptive string:", description)
    net_cfg = net_config_from_args(args)
    loss_cfg = loss_config_from_args(args)

    # record the network architecture: config JSON + drawn layer DAG
    # (the reference draws the caffe graph next to the prototxt,
    # networks.py:148-152)
    os.makedirs(os.path.join(results_dir, "networks"), exist_ok=True)
    with open(os.path.join(results_dir, "networks",
                           net_params + ".json"), "w") as f:
        json.dump({"network_config": net_cfg.__dict__,
                   "loss_config": loss_cfg.__dict__}, f, indent=2)
    try:
        from ..models.draw import render_network_graph
        render_network_graph(net_cfg, os.path.join(
            results_dir, "networks", net_params + ".png"))
    except Exception as err:  # noqa: BLE001 — an artifact, not the run
        print("network graph rendering failed:", repr(err),
              file=sys.stderr)

    iterations = args.iterations
    if iterations is None:
        if args.stage in FLAGS_FIT:
            raise ValueError("Number of iterations was not set!")
        iterations = 1

    # data selection (helper:192-217)
    # the training blob loads LAZILY: a --startOver=0 re-invocation whose
    # checkpoint already covers the requested iterations never touches it
    # (the augmented IIW blob is ~9 GB)
    # a decompose-only predict never touches the dataset: a trained
    # checkpoint must be usable to decompose arbitrary photos on a
    # machine that has no IIW blobs at all
    decompose_only = (args.stage in FLAGS_PREDICT and args.decompose)
    load_X = None
    X_val = None
    if not args.test:
        if args.stage in FLAGS_FIT:
            load_X = lambda: getData("trainValTest_train")  # noqa: E731
        if not decompose_only:
            X_val = getData("trainValTest_val")
    else:
        if args.stage in FLAGS_FIT:
            load_X = lambda: getData("bigTrainMiniValTest_train")  # noqa
            X_val = getData("bigTrainMiniValTest_val")
        elif args.stage in FLAGS_PREDICT and not decompose_only:
            X_val = getData("trainValTest_test")

    if args.stage in FLAGS_FIT:
        if iterations < args.batch_size:
            raise ValueError(
                "iterations ({}) < batch_size ({}): zero training steps "
                "would run and no checkpoint would exist to evaluate".format(
                    iterations, args.batch_size))
        # snapshots can only happen on batch boundaries: round the interval
        # down to a batch multiple (the reference asserted this instead,
        # extend_monitoring.py:84-86)
        checkpoint_interval = min(args.checkpoint_interval, iterations)
        effective = max(args.batch_size,
                        (checkpoint_interval // args.batch_size)
                        * args.batch_size)
        if effective != checkpoint_interval:
            print("checkpoint_interval", checkpoint_interval,
                  "is not a multiple of batch_size; using", effective)
        checkpoint_interval = effective
        print("Checkpointing every", checkpoint_interval, "iterations.")
        checkptr = Checkpointer(snapshot_dir, description,
                                checkpoint_interval)

        # startOver=1: train from scratch (optionally warm-started from
        # --predictCaffemodel weights, helper:281-284).  startOver=0:
        # resume from the highest existing snapshot — params, optimizer
        # state, data cursor, and RNG stream all continue (the realized
        # version of the reference's dead _load_highest_iteration,
        # helper:463-487); if the snapshot already covers the requested
        # iterations, training is skipped and only the evaluation runs.
        init_params = None
        init_opt_state = None
        base_samples = 0
        run_training = True
        if args.startOver:
            if args.predictCaffemodel:
                print("Load initial weights from:", args.predictCaffemodel)
                init_params = _load_params_any(args.predictCaffemodel,
                                               net_cfg)
        else:
            base_samples = checkptr.highest_iteration()
            if base_samples == 0:
                print("No previously trained net found, "
                      "starting from scratch.")
            elif base_samples >= iterations:
                print("Found checkpoint at iteration", base_samples,
                      ">= requested", iterations, "- skipping training.")
                run_training = False
            else:
                cpath = checkptr.path(base_samples)
                template = init_network(jax.random.PRNGKey(0), net_cfg)
                from ..train.loop import make_optimizer
                opt_template = make_optimizer(
                    args.solverType, args.base_lr).init(template)
                init_params, init_opt_state, _ = load_checkpoint(
                    cpath, template, opt_template)
                if init_opt_state is None:
                    raise ValueError(
                        "checkpoint {} has no optimizer state; cannot "
                        "resume (was it written by an old version?)".format(
                            cpath))
                print("Continuing from iteration", base_samples,
                      "with file", cpath)

        if run_training:
            X = load_X()
            callbacks = [CombineLosses(args.loss_scale_whdr,
                                       args.loss_scale_lambert),
                         RunningAverage(X["images"].shape[0],
                                        args.batch_size),
                         JsonlLogger(os.path.join(results_dir, "logs"),
                                     description + "_" + str(iterations))]
            progress = ProgressPrinter(iterations, args.loss_scale_whdr,
                                       args.loss_scale_boundaries01,
                                       args.loss_scale_lambert)
            start_train = timeit.default_timer()
            print("Starting the training for", iterations, "iterations.")
            sys.stdout.flush()
            from ..models.networks import matmul_precision
            from ..train.monitors import FilterVisualizer
            import contextlib
            trace_ctx = contextlib.nullcontext()
            if args.profile_dir:
                from ..utils.profiling import device_trace
                trace_ctx = device_trace(args.profile_dir)
            # live val WHDR at every checkpoint (the reference's
            # interleaved test phase, helper:286-294)
            from ..train.loop import make_val_whdr_fn
            val_fn = (make_val_whdr_fn(net_cfg, X_val, args.batch_size)
                      if X_val is not None else None)
            with matmul_precision(args.matmul_precision), trace_ctx:
                fit(net_cfg, loss_cfg, X, iterations, args.batch_size,
                    args.solverType, args.base_lr, args.random_seed,
                    args.comparisonsType, init_params=init_params,
                    init_opt_state=init_opt_state,
                    base_samples=base_samples,
                    callbacks=callbacks, checkpointer=checkptr,
                    progress=progress,
                    on_checkpoint=FilterVisualizer(results_dir),
                    val_fn=val_fn)
            training_time = timeit.default_timer() - start_train
            print("Total training time is", training_time)

        # evaluate final + all intermediate checkpoints (helper:300-364)
        predict_fn = make_predict_fn(net_cfg)
        template = init_network(jax.random.PRNGKey(0), net_cfg)

        def eval_checkpoint(samples):
            cname = "{}_barrista_iter_{}.npz".format(description, samples)
            cpath = os.path.join(snapshot_dir, cname)
            params, _, _ = load_checkpoint(cpath, template)
            return predict_and_score(
                X_val, params, net_cfg, results_dir,
                cname[:-4], batch_size=args.batch_size,
                predict_fn=predict_fn)

        if run_training:
            # evaluate the snapshots that were actually written (plus any
            # from earlier runs of the same description).  Deriving the
            # grid arithmetically from the CURRENT batch_size breaks on a
            # --startOver=0 resume with a different batch size: samples
            # counts like base+32k never hit the old multiples, and the
            # sweep would request files that were never written.
            intermediates = sorted(
                set(checkptr.created)
                | set(_existing_snapshots(snapshot_dir, description)))
            final_samples = intermediates[-1]
        else:
            # training skipped (already complete): the expected
            # iteration grid may not match what a previous run with
            # different --iterations/--batch_size wrote — evaluate the
            # snapshots that actually exist
            intermediates = _existing_snapshots(snapshot_dir, description)
            if not intermediates:
                raise FileNotFoundError(
                    "no snapshots found in {} for description {}".format(
                        snapshot_dir, description))
            final_samples = intermediates[-1]

        print("Now predict data from val and evaluate the WHDR on it.")
        score = eval_checkpoint(final_samples)

        print("Test all intermediate caffemodels.")
        json_val = []
        scores = []
        for i in intermediates:
            val_score = eval_checkpoint(i)
            json_val.append({"NumIters": i, "WHDR": val_score})
            scores.append(val_score)
            print("Ran iteration", i, "of", iterations,
                  "with validation score", val_score)
            sys.stdout.flush()

        os.makedirs(os.path.join(results_dir, "progressions"), exist_ok=True)
        with open(os.path.join(results_dir, "progressions",
                               "barrista_" + description + ".json"),
                  "w") as f:
            json.dump({"test": json_val, "train": []}, f)
        print("Final score in % (the best one):")
        print(min(scores) if scores else score)

    if args.predictCaffemodel and args.stage in FLAGS_PREDICT:
        # hyperparameters were already recovered from the checkpoint
        # filename at the top of this function (before the data load),
        # so the net_cfg built above is already the checkpoint's
        ckpt_abs = args.predictCaffemodel
        params = _load_params_any(ckpt_abs, net_cfg)

        if args.decompose:
            print("Decompose input")
            files = []
            for entry in args.decompose:
                if os.path.isfile(entry):
                    files.append(entry)
                elif os.path.isdir(entry):
                    for f in sorted(os.listdir(entry)):
                        files.append(os.path.join(entry, f))
                else:
                    print(entry, "is neither a file nor folder")
            decompose_files(files, params, net_cfg, results_dir,
                            batch_size=args.batch_size)
        elif X_val is not None:
            predict_and_score(X_val, params, net_cfg, results_dir,
                              os.path.splitext(
                                  os.path.basename(ckpt_abs))[0],
                              batch_size=args.batch_size)


def _load_params_any(path: str, net_cfg: NetworkConfig):
    """Load params from a framework .npz checkpoint or a .caffemodel."""
    if path.endswith(".caffemodel"):
        from ..models.caffe_io import load_reference_weights
        from ..models.networks import reference_params_from_caffe
        return reference_params_from_caffe(load_reference_weights(path))
    template = init_network(jax.random.PRNGKey(0), net_cfg)
    params, _, _ = load_checkpoint(path, template)
    return params


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    print("Arguments:")
    print(vars(args))
    # persistent XLA cache: re-runs of the same config (incl. resume)
    # reload the scan-chunked fit step from disk instead of recompiling
    from ..utils.compile_cache import enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    results_dir = os.path.join(args.results_root, args.experiment_name)
    for d in RESULT_SUBDIRS:
        os.makedirs(os.path.join(results_dir, d), exist_ok=True)

    if args.decompose:
        # 0command.txt audit log (train_with_barrista.py:333-346)
        filename = os.path.join(results_dir, "decompositions_linear",
                                "0command.txt")
        with open(filename, "a") as command:
            for a in (argv if argv is not None else sys.argv):
                command.write(a + " ")
            command.write("\n")
        shutil.copy(filename, os.path.join(results_dir,
                                           "decompositions_sRGB",
                                           "0command.txt"))

    fit_predict_net(args, results_dir)


if __name__ == "__main__":
    main()
