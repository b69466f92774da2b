from pathtracer_tpu_torch.mediums.tables import (
    MED_HG,
    MED_RAYLEIGH,
    MED_VACUUM,
    Mediums,
)

__all__ = ["Mediums", "MED_VACUUM", "MED_HG", "MED_RAYLEIGH"]
