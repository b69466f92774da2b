from pathtracer_tpu_torch.textures.texture import Textures  # noqa: F401
