"""Config-driven model assembly: one code path, the six families.

Mirrors ``repro.models.transformer`` for ``family="dense"`` ([attn +
swiglu] × L: qwen, deepseek-7b, starcoder2, granite), ``family="moe"``
([attn | MLA + MoE] × L: kimi-k2, deepseek-v3), ``family="ssm"``
([mamba2] × L: mamba2-1.3b), ``family="hybrid"`` ([mamba2] × L with one
*shared* attention + MLP block applied after every ``attn_every``-th
layer: zamba2-7b), ``family="encdec"`` (whisper: an encoder [attn + gelu
MLP] × Lₑ over stub frame embeddings, a decoder [causal attn + cross-attn
+ gelu MLP] × L, learned positions, no rope) and ``family="vlm"``
(llama-3.2-vision: a dense stack with a cross-attention to stub patch
embeddings after every ``cross_attn_every``-th layer).  ``ModelConfig``
carries every field of the reference so that all configs copy verbatim.
Parameters are a :class:`Transformer` module whose leaves keep the
reference's names and shapes (``params["layers"][l]["attn"]["wq"]``,
``params["layers"][l]["moe"]["shared"]["gate"]``,
``params["layers"][l]["mamba"]["w_in"]``, ``params["shared_attn"]["ln1"]``,
``params["layers"][l]["cross"]["wk"]``, ``params["cross_layers"][c]["wq"]``;
the reference stacks layers on axis 0, here they are an
``nn.ModuleList``; :meth:`Transformer.ref_leaves` gives the reference's
stacked view of them).  Layers run as a Python loop; a forward that
records a graph runs them under the config's remat policy.

Logits stay in the model's dtype (``x @ unembed``), so a greedy argmax
breaks ties as the reference's does, at the first index.  The decode path
carries a KV cache (MLA's latent cache; the SSM state (L, B, H, P, N) in
fp32, and for the hybrid one KV cache per shared-attention application),
the LM analogue of the FastMPS left environment; it is written in place.
rope's tables are made once a forward or decode step and serve every
layer.  Every full-sequence and every cross-attention goes through the
flash kernel's dispatch (``kernels``), decode's cross-attention too (one
query row against the encoder's or the patches' keys); ``flash=False``
takes the reference's default ``_sdpa`` route instead (training's).

The encdec and vlm decode steps take ``extra["enc_out"]`` (``encode``'s
output) or ``extra["patches"]`` and recompute the cross K/V from it every
step, as the reference does (it keeps no cross cache).  The VLM's decode
runs its cross layers in the reference's decode order: all dense layers
first, then the cross layers in a row, which differs from its forward
(cross after every ``cross_attn_every``-th layer); so a VLM decode does
not reproduce its prefill, in the reference or here.

A rank of a mesh (every family) holds its tiles of the weights
(``launch.steps.shard_params``: a :class:`Transformer` whose
``shardings`` are the resolved specs of :func:`param_specs`) and, with the
mesh declared (``common.set_mesh_axes(..., mesh=mesh)``), its forward,
``encode`` and decode step run on them with a ``common.TPLayout``'s
collectives (the forward's differentiable: the train step's backward
gives a rank its tiles' gradients, and ``remat_block`` blocks recompute
sharded layers): the vocabulary-parallel embedding and logits, FSDP tiles
gathered over the data axes before use, the attention and MLP as
``attention`` and ``common.mlp_apply`` split them (whisper's encoder,
decoder and cross attention and the VLM's cross layers too, a
cross-attention's K/V from the rank's rows of ``enc_out`` or the patches;
heads the model axis does not divide run whole), the MoE layer expert
parallel (``moe.moe_apply``) and MLA over its heads, a Mamba2 layer on its
heads (``mamba2.mamba2_apply``; decode on its heads' tile of the SSM
state), the hybrid's shared block as a dense layer (its FSDP tiles
gathered at each use), on 16×16 the model-whole FSDP tiles of a layer read
by their rows (:func:`_row_split`); :func:`greedy` picks a token over a
split vocabulary.  With no mesh declared both are the one-device code.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core import collectives as C
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.core.tree import Leaf
from repro_torch.models.common import (MODEL, PartitionSpec, RowShard,
                                       RowTile, TPLayout, embed_init,
                                       mesh_context, mlp_apply, mlp_init,
                                       mlp_specs, model_enter, model_psum,
                                       remat, block_remat, rms_norm,
                                       rope_tables, spec)

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
STACKED = ("layers", "enc_layers", "cross_layers")   # the reference's stacks
DEC_POSITIONS = 32768            # rows of whisper's learned decoder positions


def require_ported(family: str) -> None:
    """Raise ``ValueError`` for a family that is none of the reference's
    six."""
    if family not in PORTED_FAMILIES:
        raise ValueError(
            f"unknown model family {family!r}; the port runs "
            f"{', '.join(map(repr, PORTED_FAMILIES))}")


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

    def ssm_cfg(self) -> M2.Mamba2Config:
        return M2.Mamba2Config(self.d_model, self.ssm_state, self.ssm_head)

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
            c = self.ssm_cfg()
            per = dm * (2 * c.d_inner + 2 * c.n_groups * c.d_state + c.heads) \
                + c.d_inner * dm
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
    """A weight, made without ``requires_grad``: prefill and serving record
    no graph.  ``launch.steps.loss_and_grads`` (the train step's backward)
    turns it on for its own backward and off again."""
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


class SSMBlock(nn.Module):
    """One Mamba2 layer's weights: ``mamba`` (``w_in``, ``w_out``, ``A_log``,
    ``D``, ``dt_bias``, ``norm_g``; an ``nn.ParameterDict``) and ``ln``."""

    def __init__(self, tree: dict):
        super().__init__()
        self.mamba = _param_dict(tree["mamba"])
        self.ln = _param(tree["ln"])

    def __getitem__(self, name: str):
        return getattr(self, name)


class EncDecBlock(nn.Module):
    """One whisper decoder layer's weights: ``self`` and ``cross``
    attention (``nn.ParameterDict``s), ``mlp`` (gelu, with biases),
    ``ln1``, ``ln2``, ``ln3``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("self", "cross", "mlp"):
            setattr(self, name, _param_dict(tree[name]))
        for name in ("ln1", "ln2", "ln3"):
            setattr(self, name, _param(tree[name]))

    def __getitem__(self, name: str):
        return getattr(self, name)


_BLOCK = {"dense": DenseBlock, "moe": MoEBlock, "ssm": SSMBlock,
          "hybrid": SSMBlock, "encdec": EncDecBlock, "vlm": DenseBlock}


class Transformer(nn.Module):
    """``embed`` (V, dm), ``ln_f`` (dm,), ``unembed`` (dm, V), ``layers``;
    for the hybrid ``shared_attn`` (a :class:`DenseBlock`); for encdec
    ``enc_layers`` (:class:`DenseBlock`s with the gelu MLP), ``enc_ln_f``
    (dm,), ``enc_pos`` (enc_len, dm) and ``dec_pos`` (32768, dm); for the
    VLM ``cross_layers`` (one ``nn.ParameterDict`` of attention weights a
    cross layer) and ``ln_cross`` (n_cross, dm); from a nested dict of
    tensors (see :func:`init_params` and
    ``convert.lm_params_from_arrays``)."""

    def __init__(self, cfg: ModelConfig, tree: dict, shardings=None):
        super().__init__()
        require_ported(cfg.family)
        self.cfg = cfg
        # a sharded rank's leaves are tiles under these resolved specs (by
        # ``ref_leaves`` path; ``launch.steps.shard_params``); None: whole
        self.shardings = shardings
        self.embed = _param(tree["embed"])
        self.ln_f = _param(tree["ln_f"])
        self.unembed = _param(tree["unembed"])
        block = _BLOCK[cfg.family]
        self.layers = nn.ModuleList(block(lp) for lp in tree["layers"])
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(tree["shared_attn"])
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                DenseBlock(lp) for lp in tree["enc_layers"])
            for name in ("enc_ln_f", "enc_pos", "dec_pos"):
                setattr(self, name, _param(tree[name]))
        if cfg.family == "vlm":
            self.cross_layers = nn.ModuleList(
                _param_dict(cp) for cp in tree.get("cross_layers", ()))
            self.ln_cross = _param(tree["ln_cross"])

    def __getitem__(self, name: str):
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def ref_leaves(self) -> dict[str, Leaf]:
        """The reference's parameter leaves by path (``"embed"``,
        ``"layers/attn/wq"``, ``"layers/moe/shared/gate"``,
        ``"shared_attn/ln1"``, ``"cross_layers/wq"``, ``"ln_cross"``), in
        its flattening order (dict keys sorted at every level).  A stacked
        leaf (under ``layers``, ``enc_layers`` or ``cross_layers``) holds
        the tensor of each layer, the rows of the reference's array."""
        groups: dict[tuple, list] = {}
        for name, p in self.named_parameters():       # layers in order
            parts = name.split(".")
            if parts[0] in STACKED:
                del parts[1]                          # the layer's index
            groups.setdefault(tuple(parts), []).append(p)
        return {"/".join(key): Leaf(group, key[0] in STACKED)
                for key, group in sorted(groups.items())}


def params_from_leaves(cfg: ModelConfig, leaves: dict,
                       shardings: Optional[dict] = None) -> Transformer:
    """A :class:`Transformer` from its reference leaves by path (a
    :class:`Leaf` each, as :meth:`Transformer.ref_leaves` gives them: a
    stacked leaf's tensors are its layers' rows)."""
    tree: dict = {}
    for path, leaf in leaves.items():
        head, *rest = path.split("/")
        if not leaf.stacked:
            node = tree
            for k in [head, *rest][:-1]:
                node = node.setdefault(k, {})
            node[path.split("/")[-1]] = leaf.tensors[0]
            continue
        rows = tree.setdefault(head, [{} for _ in leaf.tensors])
        for row, t in zip(rows, leaf.tensors):
            node = row
            for k in rest[:-1]:
                node = node.setdefault(k, {})
            node[rest[-1]] = t
    return Transformer(cfg, tree, shardings)


def param_specs(cfg: ModelConfig) -> dict[str, PartitionSpec]:
    """The logical specs of the weights (the reference's ``init_params``
    second output), keyed as :meth:`Transformer.ref_leaves` is: embed
    split on the vocabulary, unembed on its columns, each layer's
    attention and MLP as ``attention.attn_specs`` and ``common.mlp_specs``
    with a leading None for the stacked layer axis, the norms whole; an MoE
    layer's attention (``attention.mla_specs`` with MLA) and its experts as
    ``moe.moe_specs`` (the reference's ``_layer_init_moe``); a Mamba2 layer
    as ``mamba2.mamba2_specs`` and the hybrid's shared block as a dense
    layer's, without the stacked axis (the reference's ``init_params``);
    whisper's encoder and decoder layers (their attention as
    ``attention.attn_specs``, the gelu MLP's ``b_up`` on d_ff and ``b_down``
    whole) and the VLM's stacked cross layers likewise, the position
    tables, ``enc_ln_f`` and ``ln_cross`` whole."""
    out = {"embed": spec(MODEL, None), "ln_f": spec(None),
           "unembed": spec(None, MODEL)}

    def stacked(stack: str, layer: dict) -> None:
        out.update({f"{stack}/{k}": spec(None, *v) for k, v in layer.items()})

    attn = A.attn_specs(_noncausal_cfg(cfg))
    if cfg.family in ("ssm", "hybrid"):
        layer = {f"mamba/{k}": v
                 for k, v in M2.mamba2_specs(cfg.ssm_cfg()).items()}
        layer["ln"] = spec(None)
        if cfg.family == "hybrid":
            out.update({f"shared_attn/{k}": v
                        for k, v in _dense_specs(cfg).items()})
    elif cfg.family == "encdec":
        mlp = {f"mlp/{k}": v for k, v in mlp_specs("gelu").items()}
        stacked("enc_layers", {**{f"attn/{k}": v for k, v in attn.items()},
                               **mlp, "ln1": spec(None), "ln2": spec(None)})
        layer = {f"{part}/{k}": v for part in ("self", "cross")
                 for k, v in attn.items()}
        layer.update(mlp)
        layer.update({n: spec(None) for n in ("ln1", "ln2", "ln3")})
        out.update({"enc_ln_f": spec(None), "enc_pos": spec(None, None),
                    "dec_pos": spec(None, None)})
    else:
        layer = _dense_specs(cfg)
        if cfg.family == "vlm":
            if cfg.n_layers // cfg.cross_attn_every:   # an empty stack: no
                stacked("cross_layers", attn)          # leaf
            out["ln_cross"] = spec(None, None)
    stacked("layers", layer)
    return dict(sorted(out.items()))


def _dense_specs(cfg: ModelConfig) -> dict[str, PartitionSpec]:
    """A dense or MoE layer's specs by path under the layer."""
    attn = (A.mla_specs() if cfg.use_mla else A.attn_specs(cfg.attn_cfg()))
    layer = {f"attn/{k}": v for k, v in attn.items()}
    if cfg.family == "moe":
        for k, v in MOE.moe_specs(cfg.moe_cfg()).items():
            if isinstance(v, dict):
                layer.update({f"moe/{k}/{n}": w for n, w in v.items()})
            else:
                layer[f"moe/{k}"] = v
    else:
        layer.update({f"mlp/{k}": v
                      for k, v in mlp_specs(cfg.mlp_style).items()})
    layer.update({"ln1": spec(None), "ln2": spec(None)})
    return layer


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

    def attn():
        return A.attn_init(gen, cfg.attn_cfg(), dt, dev)

    def dense_block(style=cfg.mlp_style):
        return {"attn": attn(),
                "mlp": mlp_init(gen, dm, cfg.d_ff, dt, style, dev),
                "ln1": ones(), "ln2": ones()}

    def layer():
        if cfg.family in ("ssm", "hybrid"):
            return {"mamba": M2.mamba2_init(gen, cfg.ssm_cfg(), dt, dev),
                    "ln": ones()}
        if cfg.family in ("dense", "vlm"):
            return dense_block()
        if cfg.family == "encdec":
            return {"self": attn(), "cross": attn(),
                    "mlp": mlp_init(gen, dm, cfg.d_ff, dt, "gelu", dev),
                    "ln1": ones(), "ln2": ones(), "ln3": ones()}
        return {"attn": (A.mla_init(gen, cfg.mla_cfg(), dt, dev)
                         if cfg.use_mla else attn()),
                "moe": MOE.moe_init(gen, cfg.moe_cfg(), dt, dev),
                "ln1": ones(), "ln2": ones()}

    tree = {"embed": embed_init(gen, cfg.vocab, dm, dt, dev), "ln_f": ones()}
    tree["layers"] = [layer() for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        tree["shared_attn"] = dense_block()
    if cfg.family == "encdec":
        tree["enc_layers"] = [dense_block("gelu")
                              for _ in range(cfg.n_enc_layers)]
        tree["enc_ln_f"] = ones()
        tree["enc_pos"] = embed_init(gen, cfg.enc_len, dm, dt, dev)
        tree["dec_pos"] = embed_init(gen, DEC_POSITIONS, dm, dt, dev)
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        tree["cross_layers"] = [attn() for _ in range(n_cross)]
        tree["ln_cross"] = torch.ones((n_cross, dm), dtype=dt, device=dev)
    tree["unembed"] = embed_init(gen, cfg.vocab, dm, dt, dev).T.contiguous()
    return Transformer(cfg, tree)


# ===========================================================================
# Forward (prefill) and decode
# ===========================================================================

def _dense_block(lp, x, cfg: ModelConfig, positions, cache=None,
                 kernels: str = "auto", rope=None, flash: bool = True,
                 tp: Optional[TPLayout] = None):
    h, new_cache = A.attn_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                cfg.attn_cfg(), positions, cache,
                                kernels=kernels, rope=rope, flash=flash,
                                tp=tp)
    x = x + h
    x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln2"]), cfg.mlp_style,
                      tp=tp)
    return x, new_cache


def _moe_block(lp, x, cfg: ModelConfig, positions, cache=None,
               kernels: str = "auto", rope=None, flash: bool = True,
               tp: Optional[TPLayout] = None):
    """Attention (MLA, plain; or GQA through the flash dispatch) then the
    MoE layer, on a sharded rank's tiles with ``tp``.  Returns (x,
    new_cache, aux)."""
    if cfg.use_mla:
        h, new_cache = A.mla_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                   cfg.mla_cfg(), positions, cache,
                                   rope=rope, tp=tp)
    else:
        h, new_cache = A.attn_apply(lp["attn"], rms_norm(x, lp["ln1"]),
                                    cfg.attn_cfg(), positions, cache,
                                    kernels=kernels, rope=rope, flash=flash,
                                    tp=tp)
    x = x + h
    y, aux = MOE.moe_apply(lp["moe"], rms_norm(x, lp["ln2"]), cfg.moe_cfg(),
                           tp=tp)
    return x + y, new_cache, aux


def _noncausal_cfg(cfg: ModelConfig) -> A.AttnConfig:
    """The attention of whisper's encoder and of every cross layer: no
    causal mask, no rope."""
    return cfg.attn_cfg(causal=False, rope=False)


def _encdec_block(lp, x, cfg: ModelConfig, positions, enc_out, cache=None,
                  kernels: str = "auto", flash: bool = True,
                  tp: Optional[TPLayout] = None):
    """A whisper decoder layer: causal self-attention (the KV cache in
    decode), cross-attention to ``enc_out``, the gelu MLP; on a sharded
    rank's tiles with ``tp``."""
    h, new_cache = A.attn_apply(lp["self"], rms_norm(x, lp["ln1"]),
                                cfg.attn_cfg(causal=True, rope=False),
                                positions, cache, kernels=kernels,
                                flash=flash, tp=tp)
    x = x + h
    h, _ = A.attn_apply(lp["cross"], rms_norm(x, lp["ln2"]),
                        _noncausal_cfg(cfg), positions, kv_input=enc_out,
                        kernels=kernels, flash=flash, tp=tp)
    x = x + h
    x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["ln3"]), "gelu", tp=tp)
    return x, new_cache


def _cross_layer(params: "Transformer", ci: int, x, cfg: ModelConfig,
                 patches, kernels: str = "auto", flash: bool = True,
                 tp: Optional[TPLayout] = None, mode: str = "prefill"):
    """The VLM's cross layer ``ci``: x + cross-attention of rms_norm(x,
    ln_cross[ci]) to ``patches``; on a sharded rank (``tp``) its tiles as
    a ``mode`` step reads them (:func:`_rank_block`)."""
    cp, ln = params["cross_layers"][ci], params["ln_cross"]
    if tp is not None:
        cp = _rank_block(params, cp, "cross_layers/", mode)
        ln = _rank_leaf(params, "ln_cross", ln, False)
    h, _ = A.attn_apply(cp, rms_norm(x, ln[ci]), _noncausal_cfg(cfg),
                        kv_input=patches, kernels=kernels, flash=flash,
                        tp=tp)
    return x + h


def _rope(cfg: ModelConfig, positions, context: Optional[int] = None,
          offset: int = 0):
    """rope's tables for every attention layer of a step (None for the SSM
    and encoder-decoder families, which turn nothing).  MLA: the pair for q
    at ``positions`` and k at the context positions, ``arange(offset,
    offset + context)`` in decode (the rows of this rank's cache), its
    rope dims at the default θ as ``mla_apply`` turns them."""
    if cfg.family in ("ssm", "encdec"):
        return None
    if not cfg.use_mla:
        return rope_tables(positions, cfg.hd, cfg.rope_theta)
    dr = cfg.mla_cfg().rope_head_dim
    q = rope_tables(positions, dr)
    if context is None:
        return q, q
    return q, rope_tables(torch.arange(offset, offset + context,
                                       device=positions.device)[None, :], dr)


def _is_attn(cfg: ModelConfig, layer: int) -> bool:
    """Whether the hybrid's shared block runs after Mamba layer ``layer``."""
    return layer % cfg.attn_every == cfg.attn_every - 1


def _is_cross(cfg: ModelConfig, layer: int) -> bool:
    """Whether the VLM's cross layer ``layer // cross_attn_every`` runs
    after dense layer ``layer`` in the forward."""
    return layer % cfg.cross_attn_every == cfg.cross_attn_every - 1


def _recording(params: Transformer) -> bool:
    """Whether this forward records a graph for a backward."""
    return torch.is_grad_enabled() and params["embed"].requires_grad


def _layer_fn(params: Transformer, cfg: ModelConfig, positions, rope,
              extra: dict, kernels: str, flash: bool,
              tp: Optional[TPLayout] = None):
    """The body of layer ``layer`` of the forward: (x, layer) → (x, aux),
    aux the MoE layer's aux dict (None for the other families).  On a
    sharded rank (``tp``) the layer's weights are its tiles, FSDP's
    gathered inside the body (so a recompute gathers them again)."""
    mode = "train" if _recording(params) else "prefill"

    def body(x, layer):
        if tp is not None:
            lp = _rank_layer(params, layer, mode)
        else:
            lp = params["layers"][layer]
        if cfg.family == "moe":
            x, _, aux = _moe_block(lp, x, cfg, positions, kernels=kernels,
                                   rope=rope, flash=flash, tp=tp)
            return x, aux
        if cfg.family in ("ssm", "hybrid"):
            h, _ = M2.mamba2_apply(lp["mamba"], rms_norm(x, lp["ln"]),
                                   cfg.ssm_cfg(), tp=tp)
            x = x + h
            if cfg.family == "hybrid" and _is_attn(cfg, layer):
                x, _ = _dense_block(_shared(params, tp), x, cfg, positions,
                                    kernels=kernels, rope=rope, flash=flash,
                                    tp=tp)
        elif cfg.family == "encdec":
            x, _ = _encdec_block(lp, x, cfg, positions, extra["enc_out"],
                                 kernels=kernels, flash=flash, tp=tp)
        else:
            x, _ = _dense_block(lp, x, cfg, positions, kernels=kernels,
                                rope=rope, flash=flash, tp=tp)
            if cfg.family == "vlm" and _is_cross(cfg, layer):
                x = _cross_layer(params, layer // cfg.cross_attn_every, x,
                                 cfg, extra["patches"], kernels, flash, tp,
                                 mode)
        return x, None
    return body


def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[dict] = None, kernels: str = "auto",
            layer_aux: Optional[list] = None, flash: bool = True):
    """Full-sequence forward (prefill).  tokens (B, S) → (logits (B, S, V)
    in the model's dtype, aux loss: the sum of the MoE layers' ``lb_loss``,
    0 for the other families).  On a sharded rank (a mesh declared): its
    batch rows, logits (B_l, S, V_l) over its vocabulary columns (all of
    them when unembed is whole).  ``extra``: ``{"frames": (B, T, dm)}`` for
    encdec (the stub frontend's frame embeddings, run through
    :func:`encode`), ``{"patches": (B, n_patches, dm)}`` for the VLM.
    GQA attention (the hybrid's shared block, the encoder and every
    cross-attention too) goes through the flash kernel's dispatch
    (``kernels``), or with ``flash=False`` through the reference's default
    ``_sdpa``.  ``layer_aux``, a list, receives each MoE layer's aux
    dict (``lb_loss``, ``drop_frac``, ``expert_ids``).

    When it records a graph (grad mode on, the weights requiring grad), the
    layers run under ``cfg.remat_policy`` (``common.remat``) and, for the
    dense family with ``cfg.remat_block = k``, in checkpointed blocks of k
    layers, as the reference's ``_scan_blocks``; otherwise no remat."""
    require_ported(cfg.family)
    tp = _tp_layout(params, cfg)
    extra = dict(extra or {})
    _, s = tokens.shape
    x = params["embed"][tokens] if tp is None else _embed_tp(params, tokens,
                                                             tp)
    positions = torch.arange(s, device=x.device)[None, :]
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    rope = _rope(cfg, positions)
    recording = _recording(params)
    if cfg.family == "encdec":
        extra["enc_out"] = encode(params, extra["frames"], cfg,
                                  kernels=kernels, flash=flash)
        x = x + _whole(params, "dec_pos", tp)[:s]
    body = _layer_fn(params, cfg, positions, rope, extra, kernels, flash, tp)
    layer_fn = remat(body, cfg.remat_policy if recording else "none")
    k = cfg.remat_block if recording and cfg.family == "dense" else 0
    if k:
        if cfg.n_layers % k:
            raise ValueError(f"remat_block {k} does not divide "
                             f"{cfg.n_layers} layers")

        def block(first, x):
            for layer in range(first, first + k):
                x, _ = layer_fn(x, layer)
            return x
        for first in range(0, cfg.n_layers, k):
            weights = [t for layer in range(first, first + k)
                       for t in params["layers"][layer].parameters()]
            x = block_remat(functools.partial(block, first), x, weights)
    else:
        for layer in range(cfg.n_layers):
            x, aux = layer_fn(x, layer)
            if aux is not None:
                aux_acc = aux_acc + aux["lb_loss"]
                if layer_aux is not None:
                    layer_aux.append(aux)
    if tp is not None:
        return _logits_tp(params, x, tp), aux_acc
    x = rms_norm(x, params["ln_f"])
    logits = x @ params["unembed"]
    return logits, aux_acc


def encode(params: Transformer, frames: torch.Tensor, cfg: ModelConfig,
           kernels: str = "auto", flash: bool = True) -> torch.Tensor:
    """Whisper's encoder on the stub frontend's frame embeddings frames
    (B, T, dm), T ≤ enc_len: learned positions, then [non-causal rope-free
    attention through the flash dispatch (``_sdpa`` with ``flash=False``)
    + gelu MLP] × Lₑ, then ``enc_ln_f``; each layer under
    ``cfg.remat_policy`` when it records a graph.  Returns enc_out (B, T,
    dm).  On a sharded rank (a mesh declared): its rows of the frames, each
    layer on its tiles (FSDP's gathered inside the layer's body)."""
    tp = _tp_layout(params, cfg)
    mode = "train" if _recording(params) else "prefill"

    def body(e, layer):
        lp = params["enc_layers"][layer]
        if tp is not None:
            lp = _rank_block(params, lp, "enc_layers/", mode)
        h, _ = A.attn_apply(lp["attn"], rms_norm(e, lp["ln1"]),
                            _noncausal_cfg(cfg), kernels=kernels,
                            flash=flash, tp=tp)
        e = e + h
        return e + mlp_apply(lp["mlp"], rms_norm(e, lp["ln2"]), "gelu",
                             tp=tp)

    layer_fn = remat(body, cfg.remat_policy if mode == "train" else "none")
    e = frames + _whole(params, "enc_pos", tp)[:frames.shape[1]]
    for layer in range(cfg.n_enc_layers):
        e = layer_fn(e, layer)
    return rms_norm(e, _whole(params, "enc_ln_f", tp))


class DecodeState(NamedTuple):
    caches: Any              # {"k", "v"}: (L, B, cache_len, KVH, Dh) each
    #                          (dense, MoE, encdec: the decoder's self-
    #                          attention, vlm: its dense layers);
    #                          MLA: {"latent"}: (L, B, cache_len, 512 + 64);
    #                          SSM: {"state"}: (L, B, H, P, N) fp32; hybrid:
    #                          "state" and "k", "v" of (n_attn, B, …)
    position: torch.Tensor   # () int32, or (B,) int32: one per row
    # a sharded rank's caches are tiles under these specs (by cache name,
    # ``launch.steps.cache_shardings``); None: whole
    shardings: Any = None


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device: DeviceLike = None) -> DecodeState:
    require_ported(cfg.family)
    dev = resolve_device(device)
    L = cfg.n_layers
    caches = {}
    n_kv = L                     # layers that keep a KV cache
    if cfg.family in ("ssm", "hybrid"):
        c = cfg.ssm_cfg()
        caches["state"] = torch.zeros(
            (L, batch, c.heads, c.d_head, c.d_state), dtype=torch.float32,
            device=dev)
        # the hybrid: one KV cache per application of the shared block
        n_kv = max(1, L // cfg.attn_every) if cfg.family == "hybrid" else 0
    if cfg.family == "moe" and cfg.use_mla:
        m = cfg.mla_cfg()
        caches["latent"] = torch.zeros(
            (L, batch, cache_len, m.kv_lora_rank + m.rope_head_dim),
            dtype=cfg.dtype, device=dev)
    elif n_kv:
        shape = (n_kv, batch, cache_len, cfg.n_kv_heads, cfg.hd)
        caches["k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        caches["v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return DecodeState(caches, torch.zeros((), dtype=torch.int32,
                                           device=dev))


def decode_step(params: Transformer, tokens: torch.Tensor,
                state: DecodeState, cfg: ModelConfig,
                extra: Optional[dict] = None,
                layer_aux: Optional[list] = None, kernels: str = "auto"):
    """One decode step: tokens (B, 1) → (logits (B, 1, V), new state).
    ``state.position`` is one position for the batch or one per row; the
    caches of ``state`` are updated in place and returned in the new
    state.  ``extra``: ``{"enc_out": encode(...)}`` for encdec,
    ``{"patches": ...}`` for the VLM; their cross-attention goes through
    the flash kernel's dispatch (``kernels``) at one query row, the self-
    attention reads the cache with the plain ``_sdpa``.  The VLM runs its
    dense layers, then its cross layers in a row, as the reference's
    decode does.  ``layer_aux`` as :func:`forward`'s."""
    require_ported(cfg.family)
    tp = _tp_layout(params, cfg, state)
    extra = extra or {}
    if tp is not None:
        return _decode_step_tp(params, tokens, state, cfg, tp, extra,
                               layer_aux, kernels)
    b = tokens.shape[0]
    x = params["embed"][tokens]
    pos = state.position
    positions = (pos.expand(b) if pos.ndim == 0 else pos)[:, None]
    caches = state.caches
    rope = _rope(cfg, positions, caches["latent"].shape[2]
                 if "latent" in caches else None)
    if cfg.family == "encdec":   # clamped into the table, as dynamic_slice
        dec_pos = params["dec_pos"]
        x = x + dec_pos[positions.clamp(0, dec_pos.shape[0] - 1).long()]
    ssm = cfg.family in ("ssm", "hybrid")
    conv = x.new_zeros((b, 1)) if ssm else None   # SSMState's placeholder
    for layer, lp in enumerate(params["layers"]):
        if ssm:
            x = _ssm_decode_layer(params, lp, layer, x, caches, conv, cfg,
                                  None, positions, pos, rope)
        elif cfg.family == "moe":
            cache = (A.MLACache(caches["latent"][layer], pos) if cfg.use_mla
                     else A.KVCache(caches["k"][layer], caches["v"][layer],
                                    pos))
            x, _, aux = _moe_block(lp, x, cfg, positions, cache, rope=rope)
            if layer_aux is not None:
                layer_aux.append(aux)
        elif cfg.family == "encdec":
            x, _ = _encdec_block(
                lp, x, cfg, positions, extra["enc_out"],
                A.KVCache(caches["k"][layer], caches["v"][layer], pos),
                kernels=kernels)
        else:
            x, _ = _dense_block(
                lp, x, cfg, positions,
                A.KVCache(caches["k"][layer], caches["v"][layer], pos),
                rope=rope)
    if cfg.family == "vlm":
        for ci in range(len(params["cross_layers"])):
            x = _cross_layer(params, ci, x, cfg, extra["patches"], kernels)
    x = rms_norm(x, params["ln_f"])
    logits = x @ params["unembed"]
    return logits, DecodeState(state.caches, pos + 1)


# ===========================================================================
# A sharded rank: tiles of the weights under their resolved specs, the
# collectives XLA's partitioner inserts for the reference's
# (``common.TPLayout``)
# ===========================================================================

# each family's attention and MLP weights by path prefix (the others: a
# layer's ``attn/`` and ``mlp/``): the hybrid's shared block, whisper's
# encoder and decoder layers, the VLM's layers and cross layers
_ATTN_PATHS = {
    "hybrid": (("shared_attn/attn/",), ("shared_attn/mlp/",)),
    "encdec": (("enc_layers/attn/", "layers/self/", "layers/cross/"),
               ("enc_layers/mlp/", "layers/mlp/")),
    "vlm": (("layers/attn/", "cross_layers/"), ("layers/mlp/",)),
}


def _tp_layout(params: Transformer, cfg: ModelConfig,
               state: Optional[DecodeState] = None) -> Optional[TPLayout]:
    """This rank's :class:`TPLayout` when a mesh is declared
    (``common.set_mesh_axes(..., mesh=...)``), else None."""
    ctx = mesh_context()
    if ctx is None:
        return None
    sh = params.shardings
    if sh is None:
        raise ValueError("a declared mesh needs a sharded rank's weights "
                         "(launch.steps.shard_params)")
    m = ctx["model"]
    mesh = ctx["mesh"]
    group = mesh.group(m)
    daxes = ctx["data"]
    data = mesh.group(daxes if len(daxes) > 1 else daxes[0])
    cache = None
    sts = state.shardings if state is not None else None
    if sts is not None and "latent" in sts:
        cache = "length" if sts["latent"][2] == m else None
    elif sts is not None and "k" in sts:
        k = sts["k"]
        cache = "heads" if k[3] == m else "length" if k[2] == m else None
    mla, moe = cfg.use_mla, cfg.family == "moe"
    ssm = cfg.family in ("ssm", "hybrid")

    def split(path: str, dim: int) -> bool:
        """Whether dim ``dim`` of the (unstacked) weight is on the model
        axis."""
        stacked = path.split("/")[0] in STACKED
        return sh[path][dim + stacked] == m

    def one(paths, dim: int) -> bool:
        """The split of dim ``dim``, the same in each of ``paths`` that the
        weights hold (each attention or MLP of a family has one shape)."""
        splits = {split(p, dim) for p in paths if p in sh}
        if len(splits) > 1:
            raise NotImplementedError(f"{cfg.name}: {paths} split apart")
        return bool(splits) and splits.pop()

    attn, mlp = _ATTN_PATHS.get(cfg.family, (("layers/attn/",),
                                             ("layers/mlp/",)))
    ffn = (("layers/moe/shared/gate",) if moe else
           tuple(p + ("gate" if cfg.mlp_style == "swiglu" else "up")
                 for p in mlp))
    heads_ssm = ssm and one(["layers/mamba/w_in"], 1)
    # the SSM state's tile: the rank's heads, or whole (launch.steps)
    state_heads = (state is not None and "state" in state.caches
                   and state.caches["state"].shape[2] < cfg.ssm_cfg().heads)
    if ssm and (heads_ssm and not one(["layers/mamba/w_out"], 0)
                or state_heads and not heads_ssm):
        raise NotImplementedError(f"{cfg.name}: w_in, w_out and the SSM "
                                  "state split apart")
    return TPLayout(
        group, C.axis_size(group), C.axis_index(group),
        heads=one([p + ("wq_b" if mla else "wq") for p in attn], 1),
        kv_heads=not mla and one([p + "wk" for p in attn], 1),
        ffn=one(ffn, 1), cache=cache,
        experts=moe and one(["layers/moe/gate"], 0),
        data=data if C.axis_size(data) > 1 else None,
        ssm=heads_ssm, state=state_heads)


def _rank_leaf(params: Transformer, path: str, t: torch.Tensor,
               stacked: bool) -> torch.Tensor:
    """A tile with its FSDP dims (those over the data axes) all-gathered:
    the rank's tile under the model axis alone.  Its gradient is summed
    over the data axes and scattered back to the tile."""
    ctx = mesh_context()
    dims = params.shardings[path][1 if stacked else 0:]
    for d, ax in enumerate(dims):
        if ax is not None and ax != ctx["model"]:
            group = ctx["mesh"].group(ax)
            if C.axis_size(group) > 1:
                t = C.gather_forward(t, group, dim=d)
    return t


# the weights whole on the model axis that a step reads by their rows: a
# decode step a layer's (RowTile), the train step's backward the 2-D ones
# (RowShard; kimi-k2's wk, wv enter the attention sliced to a rank's KV
# heads); the VLM's cross wk, wv project 1600 patches a row, and XLA gathers
# them as FSDP tiles
_ROW_LEAVES = {"decode": ("layers/attn/wq_a", "layers/attn/wkv_a",
                          "layers/attn/wk", "layers/attn/wv",
                          "layers/moe/router"),
               "train": ("layers/attn/wq_a", "layers/attn/wkv_a",
                         "layers/moe/router")}


def _row_split(params: Transformer, name: str, t: torch.Tensor,
               mode: str):
    """Stacked weight ``name`` (its ``ref_leaves`` path) as a ``mode``
    (``"decode"`` or ``"train"``; none in ``"prefill"``) step reads it when
    it is whole on the model axis and FSDP splits its rows over a data axis
    as large as the model axis (the 16×16 mesh), as XLA partitions the
    reference's; else None.  Rank (d, m) holds rows tile d.  In decode (:class:`RowTile`) it
    sends it to rank (m, d), whose model coordinate is d (a transpose of
    the mesh, one collective-permute), and each rank contracts its model
    coordinate's slice of the input with the tile it received, the
    products summed over the model axis: no rank gathers the weight.  In
    the train step (:class:`RowShard`) the forward gathers the weight and
    the backward computes only the rows of the rank's model coordinate of
    its gradient (the model axis' copies split the work), summed over the
    data axis and sent across the transpose."""
    if name not in _ROW_LEAVES.get(mode, ()):
        return None
    ctx = mesh_context()
    dims = params.shardings[name][1:]
    mesh, m = ctx["mesh"], ctx["model"]
    ax = dims[0]
    if (not isinstance(ax, str) or ax == m
            or any(a is not None for a in dims[1:])
            or mesh.axis_names != (ax, m)):
        return None
    p = mesh.shape[m]
    if p == 1 or mesh.shape[ax] != p:
        return None
    pairs = tuple((d * p + j, j * p + d) for d in range(p) for j in range(p))
    model = mesh.group(m)
    if mode == "train":
        return RowShard(t, C.axis_index(model), model, mesh.group(ax), pairs)
    tile = C.ppermute(t, dist.group.WORLD, list(pairs))
    return RowTile(tile, C.axis_index(model), model)


def _rank_layer(params: Transformer, layer: int, mode: str = "prefill"):
    """Layer ``layer``'s weights as the block reads them, FSDP tiles
    gathered (the module itself when none is); in a ``"decode"`` step, or
    in a ``"train"`` step's forward (one that records a graph), the
    weights whole on the model axis that FSDP splits on their rows are
    read by their rows (:func:`_row_split`)."""
    return _rank_block(params, params["layers"][layer], "layers/", mode)


def _shared(params: Transformer, tp: Optional[TPLayout]):
    """The hybrid's shared block: on a sharded rank as :func:`_rank_layer`
    gives a layer, its FSDP tiles gathered at each use."""
    if tp is None:
        return params["shared_attn"]
    return _rank_block(params, params["shared_attn"], "shared_attn/", None)


def _rank_block(params: Transformer, block: nn.Module, prefix: str,
                mode: Optional[str]):
    """``block``'s weights (those under ``prefix``: a stack's layer, or the
    hybrid's shared block) as :func:`_rank_layer` gives a layer's."""
    stacked = prefix.rstrip("/") in STACKED
    ctx = mesh_context()
    if all(ax in (None, ctx["model"]) for path, sp in params.shardings.items()
           if path.startswith(prefix) for ax in sp):
        return block
    out: dict = {}
    for name, t in block.named_parameters():
        *head, last = name.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        path = "/".join(name.split("."))
        split = (_row_split(params, prefix + path, t, mode) if stacked
                 else None)
        node[last] = (split if split is not None else
                      _rank_leaf(params, prefix + path, t, stacked))
    return out


def _whole(params: Transformer, path: str, tp: Optional[TPLayout]):
    """Top-level weight ``path``; on a sharded rank its tile with the FSDP
    dims gathered (:func:`_rank_leaf`)."""
    t = params[path]
    return t if tp is None else _rank_leaf(params, path, t, False)


def _vocab_split(params: Transformer, path: str, dim: int) -> bool:
    return params.shardings[path][dim] == mesh_context()["model"]


def _embed_tp(params: Transformer, tokens: torch.Tensor,
              tp: TPLayout) -> torch.Tensor:
    """The embedding gather; over a vocabulary split on the model axis each
    rank gathers its rows (zeros elsewhere), summed over the axis."""
    w = _rank_leaf(params, "embed", params["embed"], False)
    if not _vocab_split(params, "embed", 0):
        return w[tokens]
    v_l = w.shape[0]
    local = tokens - tp.rank * v_l
    mine = (local >= 0) & (local < v_l)
    x = w[local.clamp(0, v_l - 1)].masked_fill(~mine[..., None], 0)
    return model_psum(x, tp)


def _logits_tp(params: Transformer, x: torch.Tensor,
               tp: TPLayout) -> torch.Tensor:
    """Final norm and unembedding: this rank's vocabulary columns when
    unembed is split on them."""
    x = rms_norm(x, _rank_leaf(params, "ln_f", params["ln_f"], False))
    if _vocab_split(params, "unembed", 1):
        x = model_enter(x, tp)
    return x @ _rank_leaf(params, "unembed", params["unembed"], False)


def vocab_layout(params: Transformer, cfg: ModelConfig) -> Optional[TPLayout]:
    """The :class:`TPLayout` whose ranks each hold a part of the forward's
    logits (its vocabulary columns: unembed split on the model axis), or
    None when every rank holds all of them (one device, or a vocabulary
    the model axis does not divide)."""
    tp = _tp_layout(params, cfg)
    if tp is None or not _vocab_split(params, "unembed", 1):
        return None
    return tp


def _decode_step_tp(params: Transformer, tokens: torch.Tensor,
                    state: DecodeState, cfg: ModelConfig, tp: TPLayout,
                    extra: dict, layer_aux: Optional[list] = None,
                    kernels: str = "auto"):
    """:func:`decode_step` on a sharded rank: its rows of the batch (and of
    ``enc_out`` or the patches) and its tiles of the KV caches or of MLA's
    latent cache (written in place); logits as :func:`forward`'s on a
    sharded rank."""
    b = tokens.shape[0]
    x = _embed_tp(params, tokens, tp)
    pos = state.position
    positions = (pos.expand(b) if pos.ndim == 0 else pos)[:, None]
    caches = state.caches
    if cfg.family == "encdec":   # clamped into the table, as dynamic_slice
        dec_pos = _whole(params, "dec_pos", tp)
        x = x + dec_pos[positions.clamp(0, dec_pos.shape[0] - 1).long()]
    if "latent" in caches:             # k turns at this rank's cache rows
        t_l = caches["latent"].shape[2]
        off = tp.rank * t_l if tp.cache == "length" else 0
        rope = _rope(cfg, positions, t_l, off)
    else:
        rope = _rope(cfg, positions)
    ssm = cfg.family in ("ssm", "hybrid")
    conv = x.new_zeros((b, 1)) if ssm else None   # SSMState's placeholder
    for layer in range(cfg.n_layers):
        lp = _rank_layer(params, layer, "decode")
        if ssm:
            x = _ssm_decode_layer(params, lp, layer, x, caches, conv, cfg,
                                  tp, positions, pos, rope)
            continue
        if cfg.family == "moe":
            cache = (A.MLACache(caches["latent"][layer], pos) if cfg.use_mla
                     else A.KVCache(caches["k"][layer], caches["v"][layer],
                                    pos))
            x, _, aux = _moe_block(lp, x, cfg, positions, cache, rope=rope,
                                   tp=tp)
            if layer_aux is not None:
                layer_aux.append(aux)
            continue
        cache = A.KVCache(caches["k"][layer], caches["v"][layer], pos)
        if cfg.family == "encdec":
            x, _ = _encdec_block(lp, x, cfg, positions, extra["enc_out"],
                                 cache, kernels=kernels, tp=tp)
        else:
            x, _ = _dense_block(lp, x, cfg, positions, cache, rope=rope,
                                tp=tp)
    if cfg.family == "vlm":
        for ci in range(len(params["cross_layers"])):
            x = _cross_layer(params, ci, x, cfg, extra["patches"], kernels,
                             tp=tp, mode="decode")
    return (_logits_tp(params, x, tp),
            DecodeState(caches, pos + 1, state.shardings))


def _ssm_decode_layer(params: Transformer, lp, layer: int, x, caches, conv,
                      cfg: ModelConfig, tp: Optional[TPLayout], positions,
                      pos, rope):
    """The decode of Mamba2 layer ``layer`` (its SSM state written in
    place) and, after the hybrid's attention layers, the shared block on
    this application's KV cache (the attention layers before it).  On a
    sharded rank (``tp``): the rank's heads of the state (its tile, or its
    heads of a whole state) and of the KV cache."""
    st = caches["state"][layer]
    if tp is not None and tp.ssm and not tp.state:
        h_l = cfg.ssm_cfg().heads // tp.size
        st = st[:, tp.rank * h_l:(tp.rank + 1) * h_l]
    h, new = M2.mamba2_apply(lp["mamba"], rms_norm(x, lp["ln"]),
                             cfg.ssm_cfg(), M2.SSMState(st, conv), tp=tp)
    st.copy_(new.state)
    x = x + h
    if cfg.family == "hybrid" and _is_attn(cfg, layer):
        ci = min(layer // cfg.attn_every, caches["k"].shape[0] - 1)
        x, _ = _dense_block(_shared(params, tp), x, cfg, positions,
                            A.KVCache(caches["k"][ci], caches["v"][ci], pos),
                            rope=rope, tp=tp)
    return x


def greedy(params: Transformer, logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit, logits (B, V).  On a sharded
    rank whose logits are its vocabulary columns: each rank's largest value
    and its index, all-gathered over the model axis, the first largest of
    them (so ties go to the lowest index, as one device's argmax)."""
    ctx = mesh_context()
    if ctx is None or not _vocab_split(params, "unembed", 1):
        return torch.argmax(logits, dim=-1)
    group = ctx["mesh"].group(ctx["model"])
    idx = torch.argmax(logits, dim=-1)
    val = torch.take_along_dim(logits, idx[:, None], dim=-1)[:, 0]
    idx = idx + C.axis_index(group) * logits.shape[-1]
    vals = C.all_gather(val[None], group)            # (p, B)
    idxs = C.all_gather(idx[None], group)
    best = torch.argmax(vals, dim=0)
    return torch.take_along_dim(idxs, best[None], dim=0)[0]

