from pathtracer_tpu_torch.integrator.pt import PTSettings  # noqa: F401
