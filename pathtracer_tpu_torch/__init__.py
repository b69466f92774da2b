"""PyTorch / CUDA port of the spectral renderer `pathtracer_tpu`.

The port mirrors the JAX package's module paths. It covers the megakernel
main path: a dense, identity-transform scene of up to 8192 prims with a
projective thin-lens camera and a constant, Sun or HDR environment,
rendered by `renderer.persistent.render_regen` through the fused round or
the two-program round, and light tracing of the same scenes by
`renderer.splatted.render_splatted` through the LT round
(`kernels/lt_mega.py`). Every other identity-transform scene takes the
integrators without round kernels: `render_regen` the regen integrator
(`integrator/pt_regen.py`), `render_splatted` the light-tracing wavefront
(`integrator/lt.py:lt_trace`); bidirectional path tracing is
`renderer.bdpt_renderer.render_bdpt` (`integrator/bdpt.py`). Their
closest-hit and shadow queries are the dense sweep kernels
(`kernels/csrc/dense_sweep.cu`). On a CUDA tensor every kernel of those
paths is a hand-written CUDA kernel (`kernels/csrc/`), built with `nvcc` at
first use; on a CPU tensor each kernel wrapper runs its plain PyTorch twin.

Importing the package builds and loads nothing.
"""
