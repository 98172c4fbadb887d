"""Forward flash attention: a Hopper kernel beside its plain version.

``flash_attention(q, k, v, causal)`` with the reference's public layout:
q (B, S, H, Dh), k/v (B, T, KVH, Dh), out (B, S, H, Dh) in q's dtype; H a
multiple of KVH (grouped-query attention, KV head ``h // (H // KVH)``).
Scores, softmax and the accumulation are fp32; masked scores are −1e30, as
the reference kernel's.  For bf16 inputs the unnormalised weights
exp(s − max) are rounded to bf16 before P·V, as the reference kernel's
``p.astype(v.dtype)``, and divided by the fp32 sum of the unrounded weights.

:func:`flash_attention` launches the CUDA kernel of
``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the source's header
says how the design differs) for CUDA tensors, and takes its plain version,
:func:`flash_attention_plain`, only for tensors on the CPU.

``LAUNCHES`` counts kernel launches; ``reset_launches`` sets it to 0.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}

NEG_INF = -1e30
HEAD_DIMS = (64, 112, 128)       # 112: kimi-k2's head (7168 / 64)

_ENTRY = {torch.bfloat16: "fastmps_flash_attention_bf16",
          torch.float32: "fastmps_flash_attention_f32"}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def refuse_graph(q, k, v) -> None:
    """Raise where a graph would run through the kernel or its plain
    version: neither has a backward (the kernel writes its output through
    ctypes, the plain version computes in place), and a silent cut would
    leave q, k, v and the projections before them without a gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward; train on the reference's "
            "default attention route: models.transformer.forward(..., "
            "flash=False) (attention._sdpa), as launch.steps."
            "make_train_step does")


def flash_attention_plain(q, k, v, causal: bool = True):
    """The same function in plain PyTorch: fp32 scores from the inputs, the
    −1e30 mask; fp32 softmax times fp32 V for fp32 inputs; for bf16 inputs
    the weights exp(s − rowmax) rounded to bf16, times V, over their fp32
    sum.  Cast to q's dtype.  Materialises the (B, KVH, g, S, T) scores
    once: the weights are computed over them in place, so it refuses a
    graph (:func:`refuse_graph`)."""
    refuse_graph(q, k, v)
    scores = _scores(q, k, causal)
    b, s, h, dh = q.shape
    if q.dtype == torch.float32:
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    else:
        p = scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
        l = p.sum(dim=-1)
        l = torch.where(l > 0, l, 1.0).permute(0, 3, 1, 2)[..., None]
        p.copy_(p.to(v.dtype))                  # rounded to bf16, in place
        out = torch.einsum("bkgst,btkd->bskgd", p, v.float()) / l
    return out.reshape(b, s, h, dh).to(q.dtype)


def _scores(q, k, causal: bool):
    """fp32 scores (B, KVH, g, S, T), scaled and masked with −1e30."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()).mul_(
        1.0 / math.sqrt(dh))
    if causal:
        above = torch.ones((s, t), dtype=torch.bool,
                           device=q.device).triu_(1)
        scores.masked_fill_(above, NEG_INF)
    return scores


def rounding_bound(q, k, v, causal: bool = True):
    """Elementwise bound (fp32, q's shape) on |kernel − plain| for bf16
    inputs.

    Both round each weight w = exp(s − m) to bf16 (unit roundoff 2⁻⁸), the
    kernel relative to its running max and the plain version relative to
    the final one, so a weight may differ by 2·2⁻⁸·w and the output by
    2⁻⁷·A before its own rounding, with A = Σ_t w_t·|v_t| / Σ_t w_t.  The
    fp32 sums over T keys (products exact, ≤ 2 roundings of 2⁻²⁴ a term, in
    each version) and exp2 of log2(e)-scaled scores add (T·2⁻²² + 2⁻¹⁴)·A.
    Rounding both outputs to bf16 adds 2⁻⁷·|o| (o the plain fp32 output).
    """
    scores = _scores(q, k, causal)
    b, s, h, dh = q.shape
    t = k.shape[1]
    w = torch.softmax(scores, dim=-1)
    a = torch.einsum("bkgst,btkd->bskgd", w, v.float().abs())
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float()).abs()
    coef = 2.0 ** -7 * (1 + 2.0 ** -8) + t * 2.0 ** -22 + 2.0 ** -14
    return (coef * a + 2.0 ** -7 * o).reshape(b, s, h, dh)


def flash_attention(q, k, v, causal: bool = True):
    """The kernel: q, k, v all bf16 or all fp32, contiguous, Dh in
    ``HEAD_DIMS`` (another head dim raises: there is no fallback) →
    out as :func:`flash_attention_plain` (bf16: within
    :func:`rounding_bound`).  One block per (b·h, query tile) walks the key
    tiles in order; bf16 on the tensor cores, fp32 on the FMA units.
    Under a graph (grad mode on, q, k or v requiring grad) it raises
    ``RuntimeError`` (:func:`refuse_graph`)."""
    refuse_graph(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    name = "flash_attention"
    if q.dtype not in _ENTRY:
        raise TypeError(f"{name}: dtype {q.dtype} not supported; have "
                        f"{sorted(str(d) for d in _ENTRY)}")
    _build.check_operands(name, q.device, {"q": (q, q.dtype),
                                           "k": (k, q.dtype),
                                           "v": (v, q.dtype)})
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (B, S, H, Dh) and k/v "
                         f"(B, T, KVH, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (H must be a multiple "
                         "of KVH)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if b * h > 65535 or q.numel() >= 2 ** 31 or k.numel() >= 2 ** 31:
        raise ValueError(f"{name}: sizes exceed the kernel's grid")
    if q.dtype == torch.bfloat16:       # the kernel copies 16-byte chunks
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(_ENTRY[q.dtype], (q, k, v, out),
                  (b, s, t, h, kvh, dh, int(causal)), q.device, name,
                  source="flash_attention")
    _build.count_launch(LAUNCHES, name)
    return out
