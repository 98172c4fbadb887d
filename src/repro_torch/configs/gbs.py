"""GBS presets of the paper's experiments (Tables 1-3, Figs. 9-12), copied
from the JAX package's ``repro.configs.gbs``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GBSPreset:
    name: str
    n_sites: int          # M
    chi: int              # bond dimension
    d: int                # physical dimension (Fock cutoff)
    n_samples: int        # N
    asp: float            # actual squeezed photons (Table 1)


JIUZHANG2 = GBSPreset("jiuzhang2", 144, 10_000, 4, 10_000_000, 1.62)
JIUZHANG3_H = GBSPreset("jiuzhang3-h", 144, 10_000, 4, 10_000_000, 3.56)
B_M216_H = GBSPreset("b-m216-h", 216, 10_000, 4, 10_000_000, 6.54)
B_M288 = GBSPreset("b-m288", 288, 10_000, 4, 10_000_000, 10.69)
M8176 = GBSPreset("m8176", 8_176, 10_000, 3, 10_000_000, 8.82)

PRESETS = {p.name: p for p in
           [JIUZHANG2, JIUZHANG3_H, B_M216_H, B_M288, M8176]}
