"""AOT export of the flagship forward for serving (jax.export).

A serving process should not need this repo's Python graph-construction
code (or a caffemodel parse) at startup: ``export_flagship`` serializes
the batched-production forward — uint8 BGR [B, 3, H, W] planar in,
reflectance intensity [B, H, W] out, the exact pipeline
``cli.decompose.decompose_images`` runs (weights baked in as constants) —
as a version-checked StableHLO artifact (``jax.export``).  A consumer calls
``load_flagship(path)`` and gets a plain callable; only jax and the
artifact file are needed.

The reference has no serving story at all (its CLI rebuilds a caffe.Net
per image, decompose_with_trained_CNN.py:100-106); this is the compiled
equivalent of shipping a frozen prototxt+caffemodel pair
(network_definition.prototxt — SURVEY C7).

Build an artifact:
    python -m reflectance_filtering.utils.serving \
        --out flagship_b16_256.rfx --batch 16 --height 256 --width 256

The artifact is platform-tagged (default: cuda).  A 'cuda' artifact
embeds the Triton kernels (fused CNN, bilateral) as Triton custom calls,
which jax.export does not guarantee stable across JAX versions: serve it
with the JAX version that built it.  Exporting needs no device, so a
'cuda' artifact can be built on any host.  Other platforms get the plain
XLA forward.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
from jax import export as jax_export

from ..ops import backend

_TRITON_CALL = "__gpu$xla.gpu.triton"


def _flagship_fn(weights_path=None):
    """The batched-production forward with weights closed over as
    constants (they bake into the artifact): the product dispatch of
    ``reflectance_from_bgr_u8``, traced under ``backend.kernels_for`` so
    a 'cuda' artifact holds the fused Triton kernel and any other the
    plain XLA forward.  uint8 planar BGR in."""
    from ..models.caffe_io import load_reference_weights
    from ..models.networks import (reference_params_from_caffe,
                                   reflectance_from_bgr_u8)

    params = reference_params_from_caffe(
        load_reference_weights(weights_path))

    def forward(img_bgr_u8_planar):
        return reflectance_from_bgr_u8(params, img_bgr_u8_planar)
    return forward


def _pipeline_fn(kind: str, weights_path=None):
    """'cnn' -> reflectance map; 'bf' -> BF(CNN,CNN) c20 s22; 'gf' ->
    GF(CNN, image) r45 e3 — the paper's flagship filtered configs
    (README.md:34,58), end to end from the uint8 planar BGR batch to
    the filtered reflectance [B, H, W].  Filter outputs go through the
    product's uint8 byte path (clip(rint(q), 0, 255) — the CLI's write
    contract, ops/bilateral.py / ops/guided.py), returned as
    uint8-VALUED float32; 'cnn' returns the raw intensity in (0, 1)."""
    cnn = _flagship_fn(weights_path)
    if kind == "cnn":
        return cnn

    def pipeline(img_bgr_u8_planar):
        refl = cnn(img_bgr_u8_planar)
        # the -r.png byte path: floor(r*255) (sigmoid < 1 never triggers
        # the percentile normalize — image_utils.py:60-92)
        r_u8 = jnp.floor(refl * 255.0)[:, None]
        if kind == "bf":
            # -r.png decodes to 3 identical channels (joint_reps=3)
            from ..ops.bilateral import bilateral_planar
            q = bilateral_planar(r_u8, None, -1, 20.0, 22.0, joint_reps=3)
        elif kind == "gf":
            # guidance = the original photo (RGB planar, 0-255)
            from ..ops.guided import guided_filter_planar
            guide = img_bgr_u8_planar[:, ::-1].astype(jnp.float32)
            q = guided_filter_planar(guide, r_u8, 45, 3.0)
        else:
            raise ValueError("unknown pipeline '{}'".format(kind))
        # the product's uint8 write path: GF overshoots [0,255] (q =
        # a*I + b is unbounded), so a consumer casting raw floats to
        # uint8 would wrap around
        return jnp.clip(jnp.round(q[:, 0]), 0.0, 255.0)

    return pipeline


def export_flagship(path: str, batch: int, height: int, width: int,
                    platforms=("cuda",), pipeline: str = "cnn",
                    symbolic: bool = False, weights_path=None) -> int:
    """Serialize a flagship pipeline; returns the artifact size in
    bytes.  Input spec: uint8 [batch, 3, height, width] planar BGR
    (what the native batch decoder produces after the host-side
    moveaxis).  pipeline: 'cnn' (reflectance map), 'bf' (BF(CNN,CNN)
    c20 s22) or 'gf' (GF(CNN, image) r45 e3).

    symbolic=True exports ONE any-shape artifact (symbolic batch/H/W —
    the compiled form of the reference's fully-convolutional
    reshape-per-image trick, decompose_with_trained_CNN.py:86-87).
    Only pipeline='cnn' and only the XLA forward: the kernels' grids are
    computed from concrete shapes, so the fast fixed-shape artifacts and
    the flexible symbolic one are complementary — serve the common
    shapes from fixed artifacts, the long tail from the symbolic one."""
    platforms = tuple(p.strip() for p in platforms if p.strip())
    if not platforms:
        raise ValueError("no lowering platforms given")
    if "cuda" in platforms and len(platforms) > 1:
        # the cuda artifact embeds Triton kernels, which lower only for
        # cuda — a combined artifact would fail (or ship the slow XLA
        # forward to the GPUs); export per platform
        raise ValueError("export 'cuda' separately from other platforms "
                         "(the Triton kernels lower only for cuda)")
    if symbolic:
        if pipeline != "cnn":
            raise ValueError("symbolic export supports pipeline='cnn' "
                             "only (filter kernels need static shapes)")
        scope = jax_export.SymbolicScope()
        b, h, w = jax_export.symbolic_shape("b, h, w", scope=scope)
        spec = jax.ShapeDtypeStruct((b, 3, h, w), jnp.uint8)
    else:
        spec = jax.ShapeDtypeStruct((batch, 3, height, width), jnp.uint8)
    fn = _pipeline_fn(pipeline, weights_path)
    checks = [jax_export.DisabledSafetyCheck.custom_call(_TRITON_CALL)]
    # the kernels' grids are computed from concrete shapes: a symbolic
    # artifact takes the references whatever the platform
    choice = (backend.references_only() if symbolic
              else backend.kernels_for(platforms))
    with choice:
        exp = jax_export.export(jax.jit(fn), platforms=platforms,
                                disabled_checks=checks)(spec)
    blob = exp.serialize()
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load_flagship(path: str):
    """Deserialize an exported artifact -> callable
    (uint8 [B,3,H,W] planar BGR -> reflectance [B,H,W] float32)."""
    with open(path, "rb") as f:
        exp = jax_export.deserialize(f.read())
    return exp.call


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export the flagship reflectance forward as a "
                    "serving artifact (jax.export / StableHLO).")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--platforms", default="cuda",
                   help="comma-separated lowering platforms")
    p.add_argument("--pipeline", default="cnn",
                   choices=("cnn", "bf", "gf"),
                   help="cnn = reflectance map; bf = BF(CNN,CNN) c20 "
                        "s22; gf = GF(CNN, image) r45 e3")
    p.add_argument("--weights", default=None,
                   help="the trained caffemodel (default: "
                        "learned_weights.caffemodel in the checkout's root)")
    p.add_argument("--symbolic", action="store_true",
                   help="one any-shape artifact (cnn only, XLA forward)")
    args = p.parse_args(argv)
    n = export_flagship(args.out, args.batch, args.height, args.width,
                        platforms=tuple(args.platforms.split(",")),
                        pipeline=args.pipeline, symbolic=args.symbolic,
                        weights_path=args.weights)
    print("wrote", args.out, "({} bytes, platforms: {}, pipeline: {})"
          .format(n, args.platforms, args.pipeline))


if __name__ == "__main__":
    main()
