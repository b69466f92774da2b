from pathtracer_tpu_torch.tonemap.io_exr import write_exr  # noqa: F401
from pathtracer_tpu_torch.tonemap.io_png import write_png  # noqa: F401
from pathtracer_tpu_torch.tonemap.tonemap import (  # noqa: F401
    Clamp,
    Reinhard0,
    Reinhard0x3,
    Reinhard1,
    Reinhard1x3,
    rec709_oetf,
    rec2020_oetf,
    sRGB_oetf,
    tonemap_to_rgb,
)
