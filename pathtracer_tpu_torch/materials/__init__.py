from pathtracer_tpu_torch.materials.tables import (  # noqa: F401
    MAT_DIFFUSE_LIGHT,
    MAT_GGX,
    MAT_LAMBERTIAN,
    MAT_PASSTHROUGH,
    MAT_SHARP_LIGHT,
    SIDE_DUAL,
    SIDE_FORWARD,
    SIDE_REVERSE,
    Materials,
)
