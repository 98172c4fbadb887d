"""Config-driven model assembly: the dense and MoE families.

Mirrors ``repro.models.transformer`` for ``family="dense"`` ([attn +
swiglu] × L: qwen, deepseek-7b, starcoder2, granite) and ``family="moe"``
([attn | MLA + MoE] × L: kimi-k2, deepseek-v3).  ``ModelConfig`` carries
every field of the reference so that all configs copy verbatim.
Parameters are a :class:`Transformer` module whose leaves keep the
reference's names and shapes (``params["layers"][l]["attn"]["wq"]``,
``params["layers"][l]["moe"]["shared"]["gate"]``; the reference stacks
layers on axis 0, here they are an ``nn.ModuleList``).  Layers run as a
Python loop: the reference's scan and remat are training concerns.

Logits stay in the model's dtype (``x @ unembed``), so a greedy argmax
breaks ties as the reference's does, at the first index.  The decode path
carries a KV cache (or MLA's latent cache), the LM analogue of the FastMPS
left environment; it is written in place.  Every other family raises
``NotImplementedError`` naming its ROADMAP row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.common import (embed_init, mlp_apply, mlp_init,
                                       rms_norm)

PORTED_FAMILIES = ("dense", "moe")
# ROADMAP.md §1 row of each family still to port
_FAMILY_ROW = {"ssm": 16, "hybrid": 16, "encdec": 17, "vlm": 17}


def require_ported(family: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP row of a family the
    port does not run yet."""
    if family not in PORTED_FAMILIES:
        row = _FAMILY_ROW.get(family)
        where = f"ROADMAP.md §1 row {row}" if row else "unknown family"
        raise NotImplementedError(
            f"model family {family!r} is not ported yet ({where}); the port "
            f"runs {', '.join(map(repr, PORTED_FAMILIES))}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    qkv_bias: bool = False
    mlp_style: str = "swiglu"
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    use_mla: bool = False
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head: int = 64
    attn_every: int = 6
    # encdec / vlm
    n_enc_layers: int = 0
    enc_len: int = 1500
    cross_attn_every: int = 0
    n_patches: int = 1600
    # numerics
    dtype: Any = torch.bfloat16
    remat_policy: str = "dots"
    remat_block: int = 0
    rope_theta: float = 10000.0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def attn_cfg(self, causal: bool = True, rope: bool = True) -> A.AttnConfig:
        return A.AttnConfig(self.d_model, self.n_heads, self.n_kv_heads,
                            self.hd, self.qkv_bias, rope, self.rope_theta,
                            causal)

    def mla_cfg(self) -> A.MLAConfig:
        return A.MLAConfig(self.d_model, self.n_heads, head_dim=self.hd,
                           rope_head_dim=64, q_lora_rank=1536,
                           kv_lora_rank=512)

    def moe_cfg(self) -> MOE.MoEConfig:
        return MOE.MoEConfig(self.d_model, self.d_ff, self.n_experts,
                             self.top_k, self.n_shared_experts,
                             self.capacity_factor)

    @property
    def has_attn(self) -> bool:
        return self.family != "ssm"

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts (embedding included once)."""
        dm, dff, hd = self.d_model, self.d_ff, self.hd
        attn = dm * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.use_mla:
            attn = dm * 1536 + 1536 * self.n_heads * (hd + 64) \
                + dm * (512 + 64) + 512 * self.n_heads * hd * 2 \
                + self.n_heads * hd * dm
        mlp = 3 * dm * dff if self.mlp_style == "swiglu" else 2 * dm * dff
        per_layer_dense = attn + mlp
        emb = self.vocab * dm * 2
        if self.family == "dense":
            total = self.n_layers * per_layer_dense + emb
            return total, total
        if self.family == "moe":
            experts = self.n_experts * 3 * dm * dff
            shared = self.n_shared_experts * 3 * dm * dff
            router = dm * self.n_experts
            per = attn + experts + shared + router
            total = self.n_layers * per + emb
            act = self.n_layers * (attn + (self.top_k + self.n_shared_experts)
                                   * 3 * dm * dff + router) + emb
            return total, act
        if self.family in ("ssm", "hybrid"):
            # the reference's Mamba2Config(d_model, ssm_state, ssm_head):
            # expand 2, one B/C group
            heads = 2 * dm // self.ssm_head
            d_inner = heads * self.ssm_head
            per = dm * (2 * d_inner + 2 * self.ssm_state + heads) \
                + d_inner * dm
            total = self.n_layers * per + emb
            if self.family == "hybrid":
                total += attn + mlp    # one shared block
            return total, total
        if self.family == "encdec":
            total = (self.n_layers * (2 * attn + mlp)
                     + self.n_enc_layers * (attn + mlp) + emb)
            return total, total
        if self.family == "vlm":
            n_cross = self.n_layers // self.cross_attn_every
            total = self.n_layers * per_layer_dense + n_cross * attn + emb
            return total, total
        raise ValueError(self.family)


# ===========================================================================
# Parameters
# ===========================================================================

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _param_dict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in tree.items()})


class DenseBlock(nn.Module):
    """One layer's weights: ``attn``, ``mlp`` (``nn.ParameterDict``s),
    ``ln1``, ``ln2``; indexable by name as the reference's dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        self.attn = _param_dict(tree["attn"])
        self.mlp = _param_dict(tree["mlp"])
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])

    def __getitem__(self, name: str):
        return getattr(self, name)


class MoEWeights(nn.Module):
    """``router`` (fp32), ``gate``, ``up``, ``down`` and, with shared
    experts, ``shared`` (an ``nn.ParameterDict``); indexable by name."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("router", "gate", "up", "down"):
            setattr(self, name, _param(tree[name]))
        if "shared" in tree:
            self.shared = _param_dict(tree["shared"])

    def __getitem__(self, name: str):
        return getattr(self, name)


class MoEBlock(nn.Module):
    """One MoE layer's weights: ``attn`` (GQA or MLA weights), ``moe``
    (:class:`MoEWeights`), ``ln1``, ``ln2``."""

    def __init__(self, tree: dict):
        super().__init__()
        self.attn = _param_dict(tree["attn"])
        self.moe = MoEWeights(tree["moe"])
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])

    def __getitem__(self, name: str):
        return getattr(self, name)


_BLOCK = {"dense": DenseBlock, "moe": MoEBlock}


class Transformer(nn.Module):
    """``embed`` (V, dm), ``ln_f`` (dm,), ``unembed`` (dm, V) and
    ``layers``, from a nested dict of tensors (see :func:`init_params` and
    ``convert.lm_params_from_arrays``)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        require_ported(cfg.family)
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.ln_f = _param(tree["ln_f"])
        self.unembed = _param(tree["unembed"])
        block = _BLOCK[cfg.family]
        self.layers = nn.ModuleList(block(lp) for lp in tree["layers"])

    def __getitem__(self, name: str):
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(seed: int, cfg: ModelConfig,
                device: DeviceLike = None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (the card unless ``"cpu"`` is asked for).  The draws follow
    the reference's initialisers but not ``jax.random``'s bits."""
    require_ported(cfg.family)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, dm = cfg.dtype, cfg.d_model

    def ones():
        return torch.ones((dm,), dtype=dt, device=dev)

    def layer():
        if cfg.family == "dense":
            return {"attn": A.attn_init(gen, cfg.attn_cfg(), dt, dev),
                    "mlp": mlp_init(gen, dm, cfg.d_ff, dt, cfg.mlp_style,
                                    dev),
                    "ln1": ones(), "ln2": ones()}
        attn = (A.mla_init(gen, cfg.mla_cfg(), dt, dev) if cfg.use_mla
                else A.attn_init(gen, cfg.attn_cfg(), dt, dev))
        return {"attn": attn, "moe": MOE.moe_init(gen, cfg.moe_cfg(), dt, dev),
                "ln1": ones(), "ln2": ones()}

    tree = {"embed": embed_init(gen, cfg.vocab, dm, dt, dev), "ln_f": ones()}
    tree["layers"] = [layer() for _ in range(cfg.n_layers)]
    tree["unembed"] = embed_init(gen, cfg.vocab, dm, dt, dev).T.contiguous()
    return Transformer(cfg, tree)


# ===========================================================================
# Forward (prefill) and decode
# ===========================================================================

def _dense_block(lp, x, cfg: ModelConfig, positions, cache=None,
                 kernels: str = "auto"):
    h, new_cache = A.attn_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                cfg.attn_cfg(), positions, cache,
                                kernels=kernels)
    x = x + h
    x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]), cfg.mlp_style)
    return x, new_cache


def _moe_block(lp, x, cfg: ModelConfig, positions, cache=None,
               kernels: str = "auto"):
    """Attention (MLA, plain; or GQA through the flash dispatch) then the
    MoE layer.  Returns (x, new_cache, aux)."""
    if cfg.use_mla:
        h, new_cache = A.mla_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                   cfg.mla_cfg(), positions, cache)
    else:
        h, new_cache = A.attn_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                    cfg.attn_cfg(), positions, cache,
                                    kernels=kernels)
    x = x + h
    y, aux = MOE.moe_apply(lp["moe"], rms_norm(x, lp["ln2"]), cfg.moe_cfg())
    return x + y, new_cache, aux


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, kernels: str = "auto",
            layer_aux: Optional[list] = None):
    """Full-sequence forward (prefill).  tokens (B, S) → (logits (B, S, V)
    in the model's dtype, aux loss: the sum of the MoE layers' ``lb_loss``,
    0 for a dense model).  GQA attention goes through the flash kernel's
    dispatch (``kernels``).  ``layer_aux``, a list, receives each MoE
    layer's aux dict (``lb_loss``, ``drop_frac``, ``expert_ids``)."""
    require_ported(cfg.family)
    _, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)[None, :]
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        if cfg.family == "moe":
            x, _, aux = _moe_block(lp, x, cfg, positions, kernels=kernels)
            aux_acc = aux_acc + aux["lb_loss"]
            if layer_aux is not None:
                layer_aux.append(aux)
        else:
            x, _ = _dense_block(lp, x, cfg, positions, kernels=kernels)
    x = rms_norm(x, params["ln_f"])
    logits = x @ params["unembed"]
    return logits, aux_acc


class DecodeState(NamedTuple):
    caches: Any              # {"k", "v"}: (L, B, cache_len, KVH, Dh) each;
    #                          MLA: {"latent"}: (L, B, cache_len, 512 + 64)
    position: torch.Tensor   # () int32, or (B,) int32: one per row


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = None) -> DecodeState:
    require_ported(cfg.family)
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.family == "moe" and cfg.use_mla:
        m = cfg.mla_cfg()
        caches = {"latent": torch.zeros(
            (L, batch, cache_len, m.kv_lora_rank + m.rope_head_dim),
            dtype=cfg.dtype, device=dev)}
    else:
        shape = (L, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        caches = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    return DecodeState(caches, torch.zeros((), dtype=torch.int32,
                                           device=dev))


def decode_step(params: Transformer, tokens: torch.Tensor,
                state: DecodeState, cfg: ModelConfig,
                extra: Optional[dict] = None,
                layer_aux: Optional[list] = None):
    """One decode step: tokens (B, 1) → (logits (B, 1, V), new state).
    ``state.position`` is one position for the batch or one per row; the
    caches of ``state`` are updated in place and returned in the new
    state.  ``layer_aux`` as :func:`forward`'s."""
    require_ported(cfg.family)
    b = tokens.shape[0]
    x = params["embed"][tokens]
    pos = state.position
    positions = (pos.expand(b) if pos.ndim == 0 else pos)[:, None]
    mla = cfg.family == "moe" and cfg.use_mla
    for layer, lp in enumerate(params["layers"]):
        if mla:
            cache = A.MLACache(state.caches["latent"][layer], pos)
        else:
            cache = A.KVCache(state.caches["k"][layer],
                              state.caches["v"][layer], pos)
        if cfg.family == "moe":
            x, _, aux = _moe_block(lp, x, cfg, positions, cache)
            if layer_aux is not None:
                layer_aux.append(aux)
        else:
            x, _ = _dense_block(lp, x, cfg, positions, cache)
    x = rms_norm(x, params["ln_f"])
    logits = x @ params["unembed"]
    return logits, DecodeState(state.caches, pos + 1)
