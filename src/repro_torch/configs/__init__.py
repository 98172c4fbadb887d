"""Architecture registry and assigned input shapes.

Every ported ``<arch>.py`` exports ``CONFIG`` (the published config, copied
value for value from ``repro.configs``) and ``SMOKE`` (a reduced
same-family config for CPU tests).  The port runs every architecture of
``ARCHS``: the dense, MoE, SSM, hybrid, encoder-decoder and VLM families.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

ARCHS = [
    "zamba2-7b", "qwen1.5-4b", "deepseek-7b", "starcoder2-15b",
    "granite-3-2b", "llama-3.2-vision-11b", "whisper-small", "mamba2-1.3b",
    "kimi-k2-1t-a32b", "deepseek-v3-671b",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _mod(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch × shape) is a defined cell (long_500k needs
    sub-quadratic attention)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch — 500k decode skipped "
                       "(DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """Stand-ins for every model input of this cell: empty tensors on
    ``device`` (the meta device by default; fake tensors when made under a
    ``FakeTensorMode``), tokens int32 as the reference's."""
    import torch

    B, S = shape.global_batch, shape.seq_len

    def t(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    spec = {"tokens": t((B, 1 if shape.kind == "decode" else S),
                        torch.int32)}
    if shape.kind == "train":
        spec["labels"] = t((B, S), torch.int32)
    if cfg.family == "encdec":
        key = "enc_out" if shape.kind == "decode" else "frames"
        spec[key] = t((B, cfg.enc_len, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        spec["patches"] = t((B, cfg.n_patches, cfg.d_model), cfg.dtype)
    return spec
