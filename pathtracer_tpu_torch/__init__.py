"""PyTorch / CUDA port of the regen path tracer (`pathtracer_tpu`).

The port mirrors the JAX package's module paths. It covers the fused
megakernel main path: a dense, identity-transform scene with a projective
thin-lens camera, a constant environment and 1x1 textures, rendered by
`renderer.persistent.render_regen`. On a CUDA tensor every kernel of that
path is a hand-written CUDA kernel (`kernels/csrc/`), built with `nvcc` at
first use; on a CPU tensor each kernel wrapper runs its plain PyTorch twin.

Importing the package builds and loads nothing.
"""
