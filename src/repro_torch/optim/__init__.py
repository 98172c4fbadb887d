"""Optimizers, the LR schedule and int8 gradient compression
(``repro.optim``'s counterparts)."""
from repro_torch.optim.optimizers import (adamw, adafactor, OptState,
                                          optimizer_for)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.compression import int8_compress, int8_decompress
