from pathtracer_tpu_torch.geometry.soa import (  # noqa: F401
    PRIM_DISK,
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    HitRecord,
    Primitives,
    intersect_any_dense,
    intersect_dense,
)
