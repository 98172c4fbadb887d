"""Initialisers, primitive layers and the sharding vocabulary shared by the
model zoo.

Mirrors ``repro.models.common`` (its ``remat`` too).  Its sharding helpers
(``DATA``, ``MODEL``, ``spec``, ``set_mesh_axes``, ``clear_mesh_axes``,
``batch_sharded``, ``shard_hint``, ``resolve_specs``) are here with a
partition-spec type of the port's own (:class:`PartitionSpec`, a tuple).
The reference constrains one controller's activations; the port runs SPMD,
so a rank's activations are its batch shard already and ``batch_sharded``
and ``shard_hint`` return their input.  ``set_mesh_axes(..., mesh=...)``
makes the forward and decode step of a rank that holds
tiles (``launch.steps.shard_params``) issue their collectives over ``mesh``
(:class:`TPLayout`; differentiable: :func:`model_psum`,
:func:`model_enter`, and :func:`softmax_xent` over a split vocabulary);
with no mesh set they are the one-device code.
Casts happen where the reference casts: :func:`rms_norm` reduces in fp32, casts to x's dtype,
then multiplies by γ in that dtype; :func:`apply_rope` rotates split
halves in fp32 and casts back, its angles' sin and cos with the
reference's bits (:func:`sin_cos`);
:func:`silu` rounds bf16 where the reference's sigmoid does, and
:func:`gelu` where its tanh-GELU does.
Initialisers draw from a ``torch.Generator`` (their bits differ from
``jax.random``'s; weights are carried across with ``convert``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import collectives as C


# ---------------------------------------------------------------------------
# Sharding vocabulary: the reference's logical specs, resolved by
# ``launch.steps`` to the mesh's axes.  DATA stands for the data-like axes
# (("pod", "data") or ("data",)); MODEL is the model axis.
# ---------------------------------------------------------------------------

DATA = "__data__"
MODEL = "model"


class PartitionSpec(tuple):
    """A leaf's sharding, one entry a dim: None (replicated), a mesh axis
    name, or a tuple of names (their flattened line, major axis first);
    trailing dims left out are replicated.  The port's counterpart of
    ``jax.sharding.PartitionSpec``: a plain tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec(*axes) -> PartitionSpec:
    return PartitionSpec(*axes)


class PartSplit(str):
    """A mesh axis name (a ``str`` equal to it) for a fused dim made of
    ``parts``: a rank's tile of that dim is its 1/p of each part, in the
    parts' order, not a contiguous 1/p of the dim (Mamba2's ``w_in``
    columns [x | z | B | C | dt]: a rank's x, z and dt are its heads').
    The tile has the bytes of the contiguous one; ``launch.steps`` cuts
    and joins it."""

    def __new__(cls, axis: str, parts):
        out = super().__new__(cls, axis)
        out.parts = tuple(parts)
        return out

    def __getnewargs__(self):
        return str(self), self.parts


_MESH_CTX: dict = {"data": None, "model": None, "mesh": None}


def set_mesh_axes(data_axes, model_axis: str = "model", mesh=None) -> None:
    """Declare the mesh axes (the reference's call), and with ``mesh`` (a
    ``launch.mesh.Mesh``) the mesh whose groups a sharded rank's forward
    and decode step run their collectives on.  Tests and single-device
    runs leave it unset."""
    _MESH_CTX["data"] = tuple(data_axes) if data_axes else None
    _MESH_CTX["model"] = model_axis
    _MESH_CTX["mesh"] = mesh


def clear_mesh_axes() -> None:
    _MESH_CTX.update(data=None, model=None, mesh=None)


def mesh_context() -> Optional[dict]:
    """``{"data", "model", "mesh"}`` when a mesh was declared with
    :func:`set_mesh_axes`, else None (the one-device code)."""
    return dict(_MESH_CTX) if _MESH_CTX["mesh"] is not None else None


def batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """The reference's batch constraint: a rank's activations are its batch
    shard already."""
    return x


def shard_hint(x: torch.Tensor, *logical) -> torch.Tensor:
    """The reference's per-dim constraint: nothing to do on a rank."""
    del logical
    return x


def resolve_specs(tree: Any, data_axes: tuple[str, ...]) -> Any:
    """Rewrite DATA placeholders for the concrete mesh, in a dict, list or
    tuple of :class:`PartitionSpec` (a spec is a leaf)."""
    if isinstance(tree, PartitionSpec):
        d = tuple(data_axes)
        return PartitionSpec(*((d if len(d) > 1 else d[0]) if ax == DATA
                               else ax for ax in tree))
    if isinstance(tree, dict):
        return {k: resolve_specs(v, data_axes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(resolve_specs(v, data_axes) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """How a sharded rank's dense block is split over the model axis: the
    axis' process ``group`` (``size`` ranks, this one ``rank``) and which
    weights it splits (Megatron's column and row parallel layers, as XLA
    partitions the reference's specs):

    * ``heads``: wq, bq on the heads (column parallel) and wo on its rows;
      wo's partial products are summed over the group;
    * ``kv_heads``: wk, wv, bk, bv on the KV heads.  When the heads are
      split and the KV heads are not, a rank projects only the KV heads its
      query heads read;
    * ``ffn``: gate and up on d_ff (column parallel), down on its rows,
      summed over the group;
    * ``cache``: decode's KV cache, split on its ``"heads"`` or its
      ``"length"`` (softmax's max and sum and the output summed over the
      group), or None (whole);
    * ``experts``: an MoE layer's gate, up and down on the expert axis
      (``moe.moe_apply``: the rank's experts, the result summed over the
      group); with MLA, ``heads`` is wq_b, wk_b and wv_b on the heads and
      wo on its rows (``attention.mla_apply``);
    * ``data``: the process group of the data axes when they hold more than
      one rank (an MoE layer's global-batch sums), else None;
    * ``ssm``: a Mamba2 block on the rank's heads (``mamba2.mamba2_apply``:
      its part of each of ``w_in``'s parts, ``w_out`` on its rows, the
      gated norm's sum over d_inner and the output summed over the group);
    * ``state``: decode's SSM state is the rank's heads (else whole: the
      rank reads and writes its heads of it)."""
    group: Any
    size: int
    rank: int
    heads: bool = False
    kv_heads: bool = False
    ffn: bool = False
    cache: Optional[str] = None
    experts: bool = False
    data: Any = None
    ssm: bool = False
    state: bool = False


class RowTile(NamedTuple):
    """A replicated weight read by its tile of rows: rows [index·n,
    (index + 1)·n) of it, n = ``tile.shape[0]``, on the rank whose
    coordinate on the model axis (``group``) is ``index``.  A product with
    it (:func:`project_rows`) contracts the rank's slice of the input and
    sums the partial products over the group."""
    tile: torch.Tensor
    index: int
    group: Any


class RowShard(NamedTuple):
    """A weight whole on the model axis whose rows FSDP splits over a data
    axis as large as the model axis: this rank's ``tile`` (rows of its
    data coordinate), the ``data`` and ``model`` groups, this rank's model
    coordinate ``index`` and the world ``pairs`` of the mesh's transpose
    ((d, m) → (m, d)).  A product with it (:func:`project_rows`) gathers
    the weight over the data axis; its backward computes the weight's
    gradient only on the rows of the rank's model coordinate, sums them
    over the data axis and sends them across the transpose, so each rank
    receives its tile's gradient summed over the data axis (the work of
    the model axis' copies is split among them, as XLA partitions it)."""
    tile: torch.Tensor
    index: int
    model: Any
    data: Any
    pairs: tuple


class _RowShardProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tile, w):
        whole = C.all_gather(tile, w.data, dim=0)
        ctx.w = w
        ctx.save_for_backward(x, whole)
        return x @ whole

    @staticmethod
    def backward(ctx, g):
        x, whole = ctx.saved_tensors
        w = ctx.w
        dx = g @ whole.T
        n = w.tile.shape[0]
        rows = x[..., w.index * n:(w.index + 1) * n].reshape(-1, n)
        part = rows.T @ g.reshape(-1, g.shape[-1])
        dtile = C.ppermute(C.psum(part, w.data), dist.group.WORLD,
                           list(w.pairs))
        return dx, dtile, None


def project_rows(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a weight ``w`` (dm, N), or for a :class:`RowTile` of one
    (x's columns of the tile's rows times the tile, in fp32, summed over
    the model axis and rounded once to the product's dtype), or for a
    :class:`RowShard` of one (differentiable)."""
    if isinstance(w, RowShard):
        return _RowShardProduct.apply(x, w.tile, w)
    if not isinstance(w, RowTile):
        return x @ w
    n = w.tile.shape[0]
    part = x[..., w.index * n:(w.index + 1) * n].float() @ w.tile.float()
    return C.psum(part, w.group).to(torch.result_type(x, w.tile))


def model_psum(x: torch.Tensor, tp: Optional[TPLayout]) -> torch.Tensor:
    """Σ of the group's partial ``x`` (an all-reduce; its gradient passed
    through), or ``x`` on one device."""
    if tp is None or tp.size == 1:
        return x
    return C.psum_forward(x, tp.group)


def model_enter(x: torch.Tensor, tp: Optional[TPLayout]) -> torch.Tensor:
    """A replicated ``x`` (or weight) that enters computations split over
    the model axis: ``x`` itself, its gradient summed over the group (each
    rank's is the part of its tiles), or ``x`` on one device."""
    if tp is None or tp.size == 1:
        return x
    return C.psum_backward(x, tp.group)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device=None) -> torch.Tensor:
    """U(−1/√in, 1/√in) of shape (in_dim, out_dim)."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=gen, dtype=torch.float32,
                   device=device)
    return (w * (2 * scale) - scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device=None) -> torch.Tensor:
    """N(0, 0.02²) of shape (vocab, dim)."""
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x).  In bf16, σ(x) = 1/(1 + exp(−x)) with a bf16 rounding after
    each op, as the reference's ``jax.nn.sigmoid`` computes it on the CPU
    (XLA expands ``logistic`` so); a one-step rounding differs from it on
    about a third of bf16 inputs, and a one-ulp difference can flip an MoE
    route downstream."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def swiglu(x, w_gate, w_up, w_down):
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


_GELU_BF16 = tuple(float(torch.tensor(v, dtype=torch.bfloat16))
                   for v in (math.sqrt(2 / math.pi), 0.044715))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, x/2·(1 + tanh(√(2/π)·(x + 0.044715·
    x³))).  In bf16 op by op with bf16 constants, a bf16 rounding after
    each op, as the reference's ``jax.nn.gelu(approximate=True)`` computes
    it on the CPU (jitted or not): so it gives the reference's bits on
    every bf16 input of magnitude 2⁻¹²⁵ or more (below it XLA's CPU
    backend flushes the subnormal products to ±0).  ``F.gelu`` rounds once
    and differs on about 3 % of bf16 inputs.  The constants are Python
    floats holding their bf16 values: no tensor is made on the device (the
    dry run's fake CUDA tensors would make a real one)."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    c, k = _GELU_BF16
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))



def gelu_mlp(x, w_up, b_up, w_down, b_down):
    return gelu(x @ w_up + b_up) @ w_down + b_down


def mlp_specs(style: str = "swiglu") -> dict:
    """The MLP's logical specs by weight name (the reference's
    ``mlp_init``): the up projections column parallel, down row parallel."""
    if style == "swiglu":
        return {"gate": spec(None, MODEL), "up": spec(None, MODEL),
                "down": spec(MODEL, None)}
    return {"up": spec(None, MODEL), "b_up": spec(MODEL),
            "down": spec(MODEL, None), "b_down": spec(None)}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             style: str = "swiglu", device=None) -> dict:
    """The MLP's weights by name, shapes as the reference's."""
    if style == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
                "up": dense_init(gen, d_model, d_ff, dtype, device),
                "down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"up": dense_init(gen, d_model, d_ff, dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "down": dense_init(gen, d_ff, d_model, dtype, device),
            "b_down": torch.zeros((d_model,), dtype=dtype, device=device)}


def mlp_apply(params, x, style: str = "swiglu",
              tp: Optional[TPLayout] = None):
    """The MLP; with ``tp.ffn`` this rank's columns of d_ff (and of the
    gelu MLP's ``b_up``), the down projection's partial products summed
    over the model axis, the whole ``b_down`` added once after the sum."""
    if tp is not None and tp.ffn:
        x = model_enter(x, tp)
        if style == "swiglu":
            return model_psum(swiglu(x, params["gate"], params["up"],
                                     params["down"]), tp)
        h = gelu(x @ params["up"] + params["b_up"]) @ params["down"]
        return model_psum(h, tp) + params["b_down"]
    if style == "swiglu":
        return swiglu(x, params["gate"], params["up"], params["down"])
    return gelu_mlp(x, params["up"], params["b_up"], params["down"],
                    params["b_down"])


# glibc's sinf/cosf (sysdeps/ieee754/flt-32/s_sincosf.h), the functions
# XLA's CPU backend calls for fp32 sin and cos: a double-precision
# polynomial after a reduction by π/2 (one multiply-subtract below 120,
# 4/π to 192 bits above), rounded to fp32 once.
_SINCOS_SIGN = (1.0, -1.0, -1.0, 1.0)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")      # 2/π · 2²⁴
_HPI = float.fromhex("0x1.921FB54442D18p0")             # π/2
_PI63 = float.fromhex("0x1.921FB54442D18p-62")          # π · 2⁻⁶³
_COS_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (                                           # 4/π, 8 new bits each
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)


def _cached(fn):
    """``functools.lru_cache`` of ``fn``, bypassed under a fake-tensor mode
    (the dry run): a fake tensor must not outlive its mode in the cache."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def call(*args):
        from torch._guards import active_fake_mode
        return fn(*args) if active_fake_mode() is not None else cached(*args)
    return call


@_cached
def _sincos_tables(device: torch.device):
    """4/π's words and the quadrants' signs on ``device``, copied once:
    made on the host and copied (on the CPU too), so the dry run's counter
    sees the same ops on the card and on the CPU; under its fake tensors
    ``torch.tensor(data, device=card)`` would take real memory on the
    card."""
    return (torch.tensor(_INV_PIO4, dtype=torch.int64).to(device, copy=True),
            torch.tensor(_SINCOS_SIGN, dtype=torch.float64).to(device,
                                                              copy=True))


def _reduce_large(bits: torch.Tensor):
    """|y| ≥ 120 from its fp32 bits (int64, sign cleared) → (r, n): y − n·π/2
    = r in double, n mod 4, by glibc's 32 × 96-bit fixed-point product with
    4/π, its 64-bit sums split at bit 32 so that no int64 overflows."""
    tab = _sincos_tables(bits.device)[0]
    idx = (bits >> 26) & 15
    xi = ((bits & 0xffffff) | 0x800000) << ((bits >> 23) & 7)      # < 2³¹
    r0 = (xi * tab[idx]) & 0xffffffff
    r1 = xi * tab[idx + 4]
    low = (xi * tab[idx + 8] >> 32) + (r1 & 0xffffffff)
    high = (r0 + (r1 >> 32) + (low >> 32) + (1 << 29)) & 0xffffffff
    res = ((high & 0x3fffffff) << 32) + (low & 0xffffffff) - (1 << 61)
    return res.to(torch.float64) * _PI63, high >> 30


def sin_cos(y: torch.Tensor):
    """fp32 (sin y, cos y) with the bits of glibc's ``sinf``/``cosf``, which
    XLA's CPU backend calls: the reference's ``jnp.sin``/``jnp.cos``.  Plain
    fp64 tensor ops, so the card gives the CPU's bits (glibc's FMA build may
    round its double sum otherwise in rare cases: 1 of 11.2 M rope angles).
    ``torch.sin``/``torch.cos`` differ from it on ≈ 5 % of rope angles.
    Finite ``y`` only."""
    bits = y.float().view(torch.int32).to(torch.int64) & 0xffffffff
    top = (bits >> 20) & 0x7ff               # glibc's abstop12 thresholds
    small, mid, tiny = top < 1012, top < 1071, top < 920   # 0.75, 120, 2⁻¹²
    x = y.double()
    n_mid = (torch.trunc(x * _HPI_INV).to(torch.int64) + 0x800000) >> 24
    r_large, n_large = _reduce_large(bits & 0x7fffffff)
    n = torch.where(small, 0, torch.where(mid, n_mid, n_large))
    r = torch.where(small, x, torch.where(mid, x - n_mid.double() * _HPI,
                                          r_large))
    quad = torch.where(mid, n, n + (bits >> 31)) & 3
    xs = r * _sincos_tables(y.device)[1][quad]
    x2 = r * r
    x3 = xs * x2
    s = (xs + x3 * _SIN_S[0]) + (x3 * x2) * (_SIN_S[1] + x2 * _SIN_S[2])
    c0, c1, c2, c3, c4 = _COS_C
    x4 = x2 * x2
    c = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    c = torch.where((quad & 2) != 0, -c, c)  # glibc's second table: −cos
    odd = (n & 1) == 1
    sin = torch.where(odd, c, s).float()
    cos = torch.where(odd, s, c).float()
    return (torch.where(tiny, y, sin),
            torch.where(tiny, torch.ones_like(sin), cos))


@_cached
def rope_inv_freq(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """1/θ^(2i/Dh) (Dh/2,) fp32 with the reference's bits: the exponent in
    fp32, the power in fp64 rounded to fp32 (XLA's fp32 ``pow`` on the CPU),
    the reciprocal in fp32.  Computed on the host, so every device gets the
    same bits (torch's fp32 ``pow`` is one ulp off at Dh = 112)."""
    e = np.arange(0, dh, 2, dtype=np.float32) / np.float32(dh)
    p = np.power(np.float64(theta), e.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(1.0) / p).to(device, copy=True)


def rope_tables(positions: torch.Tensor, dh: int, theta: float = 10000.0):
    """(cos, sin), each (..., S, 1, Dh/2) fp32, for positions (..., S): the
    angles pos·inv in fp32 as the reference's, then :func:`sin_cos`.  One
    pair serves every layer and both q and k of a step."""
    ang = positions[..., None].to(torch.float32) * rope_inv_freq(
        dh, float(theta), positions.device)
    sin, cos = sin_cos(ang)
    return cos[..., None, :], sin[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, tables=None) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) integer.  Rotates split halves
    (not interleaved pairs) in fp32 and casts back to x's dtype.
    ``tables``: :func:`rope_tables` of these positions, if already made."""
    cos, sin = tables or rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 tp: Optional[TPLayout] = None) -> torch.Tensor:
    """Mean next-token cross entropy.  logits (B, S, V), labels (B, S).
    With ``tp`` the logits are this rank's columns of a vocabulary split
    over the model axis (rank k's are [k·V, (k + 1)·V)): the max over the
    group (no gradient, as logsumexp's), Σexp summed over it, and the
    label's logit from the rank that holds it."""
    logits, labels = logits.float(), labels.long()
    if tp is None or tp.size == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None],
                                    dim=-1)[..., 0]
    else:
        v_l = logits.shape[-1]
        m = C.pmax(logits.detach().amax(dim=-1, keepdim=True), tp.group)
        z = C.psum_forward(torch.exp(logits - m).sum(dim=-1), tp.group)
        logz = torch.log(z) + m[..., 0]
        local = labels - tp.rank * v_l
        mine = (local >= 0) & (local < v_l)
        gold = torch.take_along_dim(logits, local.clamp(0, v_l - 1)[..., None],
                                    dim=-1)[..., 0]
        gold = C.psum_forward(torch.where(mine, gold, 0.0), tp.group)
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Remat policy
# ---------------------------------------------------------------------------

def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the weight projections
    (``x @ w`` reaches ``aten.mm``: a product without batch dims, as
    ``checkpoint_dots_with_no_batch_dims`` keeps) and recompute the rest,
    the attention scores (``aten.bmm``) among them."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str = "nothing"):
    """``fn`` under activation checkpointing (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` policies:
    ``"nothing"`` saves only fn's inputs, ``"dots"`` also the weight
    projections' outputs, ``"none"`` is fn itself."""
    if policy == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if policy == "nothing":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_weight_products))
    raise ValueError(policy)


class _BlockRecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, x, *weights):
        ctx.fn, ctx.weights = fn, weights
        ctx.save_for_backward(x)
        return fn(x)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        x = x.detach().requires_grad_(x.requires_grad)
        wrt = [t for t in (x, *ctx.weights) if t.requires_grad]
        with torch.enable_grad():
            y = ctx.fn(x)
        grads = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None
                        for t in (x, *ctx.weights)))


def block_remat(fn, x: torch.Tensor, weights) -> torch.Tensor:
    """``fn(x)`` for a block of layers whose ``weights`` it reads, as the
    reference's ``remat(block, "nothing")`` over its inner per-layer
    remat: the forward runs without a graph and keeps only ``x``; the
    backward runs ``fn`` again (its layers under their own policy, so the
    recomputed block saves what that policy saves) and differentiates it.
    A nested ``torch.utils.checkpoint`` would keep the inner policy's
    saved products across the outer one and stop its recompute early."""
    return _BlockRecompute.apply(fn, x, *weights)
