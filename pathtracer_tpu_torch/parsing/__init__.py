from pathtracer_tpu_torch.parsing.builder import SceneBuilder  # noqa: F401
