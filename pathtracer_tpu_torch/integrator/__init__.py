from pathtracer_tpu_torch.integrator.pt import PTSettings
from pathtracer_tpu_torch.integrator.pt_regen import pt_trace_regen
from pathtracer_tpu_torch.integrator.lt import LTSettings, lt_trace
from pathtracer_tpu_torch.integrator.bdpt import BDPTSettings, bdpt_trace

__all__ = [
    "PTSettings",
    "pt_trace_regen",
    "LTSettings",
    "lt_trace",
    "BDPTSettings",
    "bdpt_trace",
]
