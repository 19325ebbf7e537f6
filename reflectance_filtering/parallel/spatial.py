"""Spatial sharding with halo exchange — huge single frames across cards.

The image-domain analogue of context/sequence parallelism (SURVEY.md §5.7):
a 4K+ frame is sharded along its width across the mesh; windowed filters
need ``halo`` neighbor columns, exchanged with ``jax.lax.ppermute`` inside
``shard_map`` (XLA hands the permutes to NCCL over NVLink).  Global reflect-101
borders are synthesized locally on the edge shards (a shard always owns
more than ``halo`` columns), so results are bit-identical to the
single-device kernels — verified in tests.

Halo widths: bilateral needs r (one windowed pass); the guided filter's
two box-filter stages compose to an effective 2r receptive field.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.bilateral import opencv_bilateral_params


def _exchange_halos_w(local, halo: int, axis_name: str,
                      border: str = "reflect101"):
    """Assemble [left_halo | local | right_halo] along axis 1 (width).

    local: [H, W_shard, C].  Neighbor columns travel via ppermute; the
    outermost shards synthesize global-border columns from their own data
    (border='reflect101': ...c b | a b c; border='reflect'/symmetric:
    ...b a | a b c — matching the kernel being lifted).
    """
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)

    right_edge = local[:, -halo:]   # sent rightward (becomes left halo)
    left_edge = local[:, :halo]     # sent leftward (becomes right halo)

    # ring permutes (wrap-around values are discarded at the edges)
    from_left = jax.lax.ppermute(
        right_edge, axis_name,
        [(i, (i + 1) % n) for i in range(n)])
    from_right = jax.lax.ppermute(
        left_edge, axis_name,
        [(i, (i - 1) % n) for i in range(n)])

    if border == "reflect101":
        # global column -k maps to column k
        reflect_left = local[:, 1:halo + 1][:, ::-1]
        reflect_right = local[:, -halo - 1:-1][:, ::-1]
    elif border == "reflect":
        # symmetric: global column -k maps to column k-1
        reflect_left = local[:, :halo][:, ::-1]
        reflect_right = local[:, -halo:][:, ::-1]
    else:
        raise ValueError("unknown border {}".format(border))

    left = jnp.where(idx == 0, reflect_left, from_left)
    right = jnp.where(idx == n - 1, reflect_right, from_right)
    return jnp.concatenate([left, local, right], axis=1)


def sharded_apply_overlap(fn: Callable, halo: int, mesh: Mesh,
                          axis: str = "data", border: str = "reflect101"):
    """Lift a local windowed op into a width-sharded op with halo exchange.

    fn maps ([H, W_shard + 2*halo, C], ...) -> [H, W_shard + 2*halo, C']
    (shape-preserving along W); the wrapper returns the cropped local
    region.  All array arguments are sharded on width.
    """

    if halo < 0:
        raise ValueError("halo must be >= 0, got {}".format(halo))

    def local_fn(*arrays):
        if halo == 0:         # [:, -0:] / [:, :-0] would mis-slice
            return fn(*arrays)
        haloed = [_exchange_halos_w(a, halo, axis, border) for a in arrays]
        out = fn(*haloed)
        return out[:, halo:-halo]

    w_shard = P(None, axis, None)

    def wrapper(*arrays):
        # validate the shard geometry HERE with a clear message — too
        # narrow a shard would otherwise surface as an opaque
        # concatenate-shape mismatch inside _exchange_halos_w's traced
        # border synthesis
        n_shards = mesh.shape[axis]
        w = arrays[0].shape[1]
        if w % n_shards:
            raise ValueError(
                "W = {} not divisible by the mesh size {}".format(
                    w, n_shards))
        need = halo + 1 if border == "reflect101" else halo
        if halo and w // n_shards < need:
            raise ValueError(
                "W/mesh = {} < {} — shards too narrow to synthesize the "
                "halo-{} {} border (use fewer shards)".format(
                    w // n_shards, need, halo, border))
        specs = tuple(w_shard for _ in arrays)
        # check_vma=False: the wrapped kernels create fresh (unvarying)
        # scan carries internally, which the varying-axis checker rejects
        return shard_map(local_fn, mesh=mesh, in_specs=specs,
                         out_specs=w_shard, check_vma=False)(*arrays)

    return wrapper


def sharded_box_filter(x, radius: int, mesh: Mesh, axis: str = "data",
                       border: str = "reflect101"):
    """Width-sharded box filter (halo = radius).  x: [H, W, C] with W
    divisible by the mesh size and W/mesh >= radius+1."""
    from ..ops.boxfilter import box_filter

    # Run the normal kernel on the haloed block: its own width padding only
    # influences output columns within `radius` of the block edge, all of
    # which lie in the cropped halo — interior results are exact.
    def local(block):
        return box_filter(block, radius, border=border, normalize=True)

    return sharded_apply_overlap(local, radius, mesh, axis, border)(x)


def sharded_joint_bilateral(joint, src, mesh: Mesh, d: int = -1,
                            sigma_color: float = 20.0,
                            sigma_space: float = 22.0,
                            axis: str = "data", joint_reps: int = 1):
    """Width-sharded joint bilateral filter, bit-compatible with the
    single-device product filter (ops.bilateral.bilateral_planar: the
    Triton kernel on the GPU, the plain reference on the CPU).

    joint: [H, W, Cj] (Cj in {1, 3}); src: [H, W, Cs] (Cs in {1, 3}) or
    None to filter ``joint`` by itself; ``joint_reps`` as for
    bilateral_planar.  W divisible by the mesh size; W/mesh > radius.
    OpenCV bilateral borders are reflect-101."""
    from ..ops.bilateral import bilateral_planar

    radius, _, _, _ = opencv_bilateral_params(d, sigma_color, sigma_space)

    def planar(blk):                                     # [1, C, H, Wb]
        return jnp.moveaxis(blk, -1, 0)[None]

    def local(joint_blk, src_blk=None):
        out = bilateral_planar(planar(joint_blk),
                               None if src_blk is None else planar(src_blk),
                               d, sigma_color, sigma_space,
                               joint_reps=joint_reps)
        return jnp.moveaxis(out[0], 0, -1)

    arrays = (joint,) if src is None else (joint, src)
    return sharded_apply_overlap(local, radius, mesh, axis,
                                 "reflect101")(*arrays)


def sharded_guided_filter(guide, src, radius: int, eps, mesh: Mesh,
                          axis: str = "data"):
    """Width-sharded guided filter, matching ops.guided.guided_filter.

    guide [H, W, 3] or [H, W]; src [H, W, C] or [H, W].  Halo is 2*radius
    (means of a,b compose two box passes); OpenCV guidedFilter borders are
    BORDER_REFLECT (symmetric).  W divisible by mesh size and
    W/mesh >= 2*radius + 1.
    """
    from ..ops.guided import guided_filter

    gray_guide = guide.ndim == 2
    squeeze = src.ndim == 2
    guide3 = guide[..., None] if gray_guide else guide
    src3 = src[..., None] if squeeze else src

    def local(guide_blk, src_blk):
        g = guide_blk[..., 0] if gray_guide else guide_blk
        return guided_filter(g, src_blk, radius, eps)

    out = sharded_apply_overlap(local, 2 * radius, mesh, axis,
                                "reflect")(guide3, src3)
    return out[..., 0] if squeeze else out


def sharded_guided_filter_iterated(guide, src, radius: int, eps,
                                   iterations: int, mesh: Mesh,
                                   axis: str = "data"):
    """Width-sharded Zoran-style iterated GF chain — the flagship
    big-frame capability (BASELINE config 4: 3x GF on 4K+) across cards.

    ONE halo exchange of ``iterations * 2 * radius`` columns, then each
    shard runs the whole chain locally and crops.  Per-iteration
    re-exchange would move 3x fewer columns per hop but pay
    ``iterations`` ppermute latencies; the single wide halo keeps the
    per-shard compute identical to the single-card chain.

    Correctness of the single exchange: one GF has a 2r receptive
    field, so block-local reflect padding corrupts at most 2r columns
    per iteration; after n iterations the corruption reaches exactly
    the n*2r columns the crop removes.  At global borders the box-at-
    mirrored-position identity makes the synthesized reflect halo
    reproduce the whole chain's border behavior (each iteration's
    intermediate q is itself reflect-symmetric about the global edge).

    guide [H, W, 3] or [H, W]; src [H, W, C] or [H, W]; W divisible by
    the mesh size and W/mesh >= iterations * 2 * radius (the edge
    shards synthesize the global reflect border from their own
    columns).  Reference use-case: full-size decompose + 3x GF chain,
    the reference's training/train_with_barrista_helper.py:753 +
    README.md:88."""
    halo = 2 * radius * iterations
    n_shards = mesh.shape[axis]
    w_shard = guide.shape[1] // n_shards
    if w_shard < halo:
        raise ValueError(
            "W/mesh = {} < iterations*2*radius = {} — shards too narrow "
            "to carry the chain's halo (use fewer shards or fewer "
            "iterations per exchange)".format(w_shard, halo))

    gray_guide = guide.ndim == 2
    squeeze = src.ndim == 2
    guide3 = guide[..., None] if gray_guide else guide
    src3 = src[..., None] if squeeze else src

    from ..ops.guided import guided_filter

    def local(guide_blk, src_blk):
        g = guide_blk[..., 0] if gray_guide else guide_blk
        q = src_blk
        for _ in range(iterations):
            q = guided_filter(g, q, radius, eps)
        return q

    out = sharded_apply_overlap(local, halo, mesh, axis,
                                "reflect")(guide3, src3)
    return out[..., 0] if squeeze else out
