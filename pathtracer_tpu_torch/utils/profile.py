"""Ray-count profiling (counterpart of `utils/profile.py`).

The renderer keeps one [5] counter vector in this slot order on the device
and converts it to a `Profile` after a host fetch.
"""

from __future__ import annotations

import dataclasses

N_COUNTERS = 5
CAMERA_RAYS, BOUNCE_RAYS, SHADOW_RAYS, LIGHT_RAYS, ENV_HITS = range(N_COUNTERS)


@dataclasses.dataclass
class Profile:
    camera_rays: int = 0
    bounce_rays: int = 0
    shadow_rays: int = 0
    light_rays: int = 0
    env_hits: int = 0

    def add_device_counts(self, counts):
        c = [int(round(float(x))) for x in counts]
        self.camera_rays += c[CAMERA_RAYS]
        self.bounce_rays += c[BOUNCE_RAYS]
        self.shadow_rays += c[SHADOW_RAYS]
        self.light_rays += c[LIGHT_RAYS]
        self.env_hits += c[ENV_HITS]
        return self

    @property
    def total_rays(self):
        return self.camera_rays + self.bounce_rays + self.shadow_rays + self.light_rays
