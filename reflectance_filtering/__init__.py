"""reflectance_filtering — intrinsic image decomposition on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
tnestmeyer/reflectance-filtering (CVPR'17 "Reflectance Adaptive Filtering
Improves Intrinsic Image Estimation"):

  * the direct-reflectance-prediction CNN (per-pixel MLP, 1x1 convs) and all
    seven training architectures (reference: training/networks.py),
  * joint-bilateral and guided reflectance filtering with OpenCV-compatible
    semantics (reference: filter_reflectance.py) as XLA programs and
    Pallas kernels on the Triton route (NVIDIA GPUs),
  * WHDR metric + WHDR hinge loss (reference: training/layers/*.py) as
    vectorized, autodiff-able jnp ops,
  * the full train/predict/decompose experiment pipeline (reference:
    training/train_with_barrista*.py) on optax/orbax,
  * the IIW dataset builder (reference:
    training/createNumpyArrayWithComparisonsForIIW.py),
  * data-parallel batched evaluation over a jax.sharding.Mesh.

Everything on the compute path runs as a single XLA program per step; the
reference's Python<->C++ per-layer round trips do not exist here.
"""

__version__ = "0.1.0"
