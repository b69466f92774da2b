from pathtracer_tpu_torch.camera.projective import (  # noqa: F401
    ProjectiveCamera,
    camera_from_numpy,
    make_projective_camera,
)
