"""Train, prefill and serve step factories for the LM stack, and the
sharding policy.

Mirrors ``repro.launch.steps``.  Sharding policy (per leaf, as the
reference's):
  1. Resolve the model's logical specs (DATA placeholders → the mesh's
     data-like axes; ``models.transformer.param_specs``).
  2. Divisibility guard: a dim that its axes do not divide is replicated
     (qwen1.5-4b's 20 heads on a model axis of 16).
  3. FSDP: above 8 GB of bf16 weights, a leaf not data-sharded gets its
     largest divisible dim sharded over the data axes.
Decode caches: batch over the data axes; KV heads over "model" when they
divide, else the cache's length.  The SSM state (L, B, H, P, N) is a 5-D
cache to the policy, its d_head P over "model"; a rank's tile of it is
its heads instead (:func:`shard_state`): the same bytes, and a decode
step on the rank's heads needs no collective for the state.

A spec is a ``models.common.PartitionSpec``; the port has no
``NamedSharding``, so the ``*_shardings`` functions return specs (by
``Transformer.ref_leaves`` path for the weights, by name for a batch and
the caches).  A rank of a mesh holds its tile of each leaf under its spec
(:func:`shard_params`, :func:`shard_batch`, :func:`shard_state`, on real
or fake tensors; a batch's ``frames``, ``enc_out`` and ``patches`` split
on their rows as the tokens), and with ``common.set_mesh_axes(...,
mesh=mesh)`` every family's prefill and serve steps run on those tiles
with their collectives, and so does the
train step, on the tiles of the weights and of the optimizer state
(:func:`opt_state_shardings`, :func:`shard_opt_state`).  A checkpoint
holds whole leaves: :func:`unshard_params` and :func:`unshard_opt_state`
gather them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import collectives as C
from repro_torch.core.tree import Leaf
from repro_torch.launch.mesh import data_axis_names
from repro_torch.models import transformer as T
from repro_torch.models.common import (PartitionSpec, PartSplit,
                                       mesh_context, resolve_specs,
                                       softmax_xent)
from repro_torch.optim import optimizers as O


# ---------------------------------------------------------------------------
# Sharding policy
# ---------------------------------------------------------------------------

def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        out = 1
        for a in ax:
            out *= mesh.shape[a]
        return out
    return mesh.shape[ax]


def guard_divisibility(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """``spec`` with every dim its axes do not divide replicated, padded
    with None to ``shape``'s rank."""
    out = []
    for i, ax in enumerate(spec):
        if ax is not None and (i >= len(shape)
                               or shape[i] % _axis_size(mesh, ax)):
            out.append(None)
        else:
            out.append(ax)
    while len(out) < len(shape):
        out.append(None)
    return PartitionSpec(*out)


def apply_fsdp(spec: PartitionSpec, shape, mesh,
               data_axes) -> PartitionSpec:
    """Shard the largest unsharded divisible dim over the data axes."""
    if any(ax is not None and (ax in data_axes or (
            isinstance(ax, (tuple, list)) and set(ax) & set(data_axes)))
           for ax in spec):
        return spec                       # already data-sharded
    dsize = 1
    for a in data_axes:
        dsize *= mesh.shape[a]
    cands = [i for i, ax in enumerate(spec)
             if ax is None and shape[i] % dsize == 0]
    if not cands:
        return spec
    best = max(cands, key=lambda i: shape[i])
    out = list(spec)
    out[best] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return PartitionSpec(*out)


def param_shardings(mesh, params, specs: dict, fsdp: bool) -> dict:
    """Each weight's spec on ``mesh`` by ``ref_leaves`` path: ``params`` a
    :class:`Transformer` (fake tensors will do: :func:`abstract_params`)
    or a dict of shapes by path."""
    data_axes = data_axis_names(mesh)
    specs = resolve_specs(specs, data_axes)
    shapes = (params if isinstance(params, dict) else
              {k: leaf.shape for k, leaf in params.ref_leaves().items()})

    def leaf(shape, spec):
        spec = guard_divisibility(spec, shape, mesh)
        if fsdp:
            spec = apply_fsdp(spec, shape, mesh, data_axes)
        return spec

    return {k: leaf(tuple(shapes[k]), specs[k]) for k in specs}


def batch_shardings(mesh, batch: dict) -> dict:
    """A batch's specs by name: dim 0 over the data axes when they divide
    it (``batch``: tensors or shapes by name)."""
    data_axes = data_axis_names(mesh)
    dspec = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]

    def leaf(shape):
        spec = [None] * len(shape)
        if shape and shape[0] % _axis_size(mesh, dspec) == 0:
            spec[0] = dspec
        return PartitionSpec(*spec)

    return {k: leaf(tuple(v.shape if hasattr(v, "shape") else v))
            for k, v in batch.items()}


def opt_state_shardings(mesh, opt_state, params_shardings: dict):
    """The optimizer state's specs, mirroring the weights' (the reference's
    rule): adamw's ``m``/``v`` (and adafactor's unfactored ``v``) take the
    weight's spec; adafactor's ``vr`` drops its last dim, ``vc`` its
    second-to-last, each guarded; the step is replicated.  ``opt_state``:
    an ``optim.OptState`` (fake tensors will do), the specs an
    ``OptState`` of ``{path: {name: spec}}``."""
    inner = {}
    for path, st in opt_state.inner.items():
        psh = params_shardings[path]
        out = {}
        for k, leaf in st.items():
            if k in ("m", "v"):
                out[k] = psh
                continue
            spec = list(psh) + [None] * (len(leaf.shape) + 1 - len(psh))
            s = spec[:-1] if k == "vr" else spec[:-2] + spec[-1:]
            out[k] = guard_divisibility(PartitionSpec(*s), leaf.shape, mesh)
        inner[path] = out
    return O.OptState(PartitionSpec(), inner)


def cache_shardings(mesh, cfg: T.ModelConfig, caches: dict) -> dict:
    """The decode caches' specs by name (stacked (L, B, T, kvh?, dh?)):
    batch over the data axes; a KV cache's heads over "model" when they
    divide, else its length; MLA's latent cache on its length."""
    del cfg
    data_axes = data_axis_names(mesh)
    dspec = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    msize = mesh.shape["model"]
    dsize = _axis_size(mesh, dspec)

    def leaf(shape):
        if len(shape) == 0:
            return PartitionSpec()
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dsize == 0:
            spec[1] = dspec                       # batch
        if len(shape) == 5:                       # (L, B, T, kvh, dh) KV
            if shape[3] % msize == 0:
                spec[3] = "model"                 # kv heads
            elif shape[2] % msize == 0:
                spec[2] = "model"                 # cache length
        elif len(shape) == 4:                     # (L, B, T, latent) MLA
            if shape[2] % msize == 0:
                spec[2] = "model"
        return PartitionSpec(*spec)

    return {k: leaf(tuple(v.shape if hasattr(v, "shape") else v))
            for k, v in caches.items()}


# ---------------------------------------------------------------------------
# A rank's tiles
# ---------------------------------------------------------------------------

def _coords(mesh, spec: PartitionSpec, shape) -> list:
    """(dim, start, width) of this rank's tile of a leaf of ``shape``
    under ``spec``: its coordinate on each dim's axes (a tuple of axes
    counted on their flattened line, major axis first)."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = _axis_size(mesh, ax)
        w = shape[d] // n
        out.append((d, C.axis_index(mesh.group(ax)) * w, w))
    return out


def _parts(spec: PartitionSpec, stacked: bool = False) -> dict:
    """{dim of a row: the part widths} of the dims that a
    ``common.PartSplit`` splits."""
    return {d - stacked: ax.parts for d, ax in enumerate(spec)
            if isinstance(ax, PartSplit)}


def _part_cut(t: torch.Tensor, d: int, widths, index: int,
              n: int) -> torch.Tensor:
    """Rank ``index`` of ``n``'s 1/n of each part of dim ``d``, in order."""
    cuts, start = [], 0
    for w in widths:
        if w % n:
            raise ValueError(f"a part of {w} does not split over {n} ranks")
        cuts.append(t.narrow(d, start + index * (w // n), w // n))
        start += w
    return torch.cat(cuts, dim=d)


def _part_join(t: torch.Tensor, d: int, widths, n: int) -> torch.Tensor:
    """The whole dim ``d`` from the ``n`` ranks' :func:`_part_cut` tiles
    laid side by side in rank order: each part's pieces in rank order."""
    pieces = [tile.split([w // n for w in widths], dim=d)
              for tile in t.chunk(n, dim=d)]
    return torch.cat([pieces[r][i] for i in range(len(widths))
                      for r in range(n)], dim=d)


def _tile(t: torch.Tensor, coords, parts=None) -> torch.Tensor:
    """The tile a fresh tensor of its own (a fake tile's storage is the
    tile's size, not the whole leaf's); a tile that is the whole tensor
    (every dim on axes of one rank) is the tensor itself, not a copy, so a
    rank of a 1 × 1 mesh holds its weights once.  ``parts``: {dim: part
    widths} of the dims cut part by part (:func:`_part_cut`)."""
    if all(w == t.shape[d] for d, _, w in coords):
        return t
    parts = parts or {}
    for d, start, w in coords:
        if d in parts:
            t = _part_cut(t, d, parts[d], start // w, t.shape[d] // w)
        else:
            t = t.narrow(d, start, w)
    return t.clone(memory_format=torch.contiguous_format)


HELD_WHOLE_MAX = 1 << 20    # bytes of a leaf whose split layer axis a rank
#                             holds whole (replicated over that axis)


def _held(spec: PartitionSpec, leaf: Leaf, path: str) -> PartitionSpec:
    """The spec as a rank holds the leaf: a stacked leaf's layer axis is
    never split.  FSDP splits it only where no other dim divides, as the
    smoke configs' ``norm_g`` (L, d_inner) on a data axis of 2; a rank
    then holds every layer's tile, replicated over that axis, which only
    a leaf of at most ``HELD_WHOLE_MAX`` bytes may do: a larger one raises
    rather than hold more bytes a device than the policy's."""
    if not (leaf.stacked and spec and spec[0] is not None):
        return spec
    size = sum(t.numel() * t.element_size() for t in leaf.tensors)
    if size > HELD_WHOLE_MAX:
        raise NotImplementedError(f"{path}: a split layer axis ({spec}) on "
                                  f"a leaf of {size} bytes")
    return PartitionSpec(None, *spec[1:])


def shard_params(params: T.Transformer, shardings: dict,
                 mesh) -> T.Transformer:
    """This rank's tiles of ``params`` (whole weights; fake ones give the
    dry run's fake tiles) under ``shardings`` (:func:`param_shardings`), a
    :class:`Transformer` that remembers them as the rank holds them (its
    ``shardings``: :func:`_held`)."""
    leaves = params.ref_leaves()
    held = {path: _held(shardings[path], leaf, path)
            for path, leaf in leaves.items()}
    return T.params_from_leaves(
        params.cfg, {path: _tile_leaf(leaf, held[path], mesh, path)
                     for path, leaf in leaves.items()}, held)


def shard_opt_state(opt_state, shardings, mesh):
    """This rank's tiles of a whole optimizer state under ``shardings``
    (:func:`opt_state_shardings`); the step is replicated."""
    inner = {path: {k: _tile_leaf(leaf, shardings.inner[path][k], mesh,
                                  path)
                    for k, leaf in st.items()}
             for path, st in opt_state.inner.items()}
    return O.OptState(opt_state.step, inner)


def _tile_leaf(leaf: Leaf, spec: PartitionSpec, mesh, path: str) -> Leaf:
    spec = _held(spec, leaf, path)
    coords = _coords(mesh, spec, leaf.shape)
    if leaf.stacked:
        coords = [(d - 1, s0, w) for d, s0, w in coords]
    parts = _parts(spec, leaf.stacked)
    return Leaf([_tile(t, coords, parts) for t in leaf.tensors],
                leaf.stacked)


def _untile_leaf(leaf: Leaf, spec: PartitionSpec, mesh) -> Leaf:
    """A leaf's tiles all-gathered over the axes of ``spec`` into the whole
    leaf (every rank of the mesh takes part), a dim cut part by part
    joined in the parts' order."""
    dims = spec[1:] if leaf.stacked else spec

    def whole(t):
        for d, ax in enumerate(dims):
            if ax is not None:
                t = C.all_gather(t, mesh.group(ax), dim=d)
                if isinstance(ax, PartSplit):
                    t = _part_join(t, d, ax.parts, _axis_size(mesh, ax))
        return t
    return Leaf([whole(t) for t in leaf.tensors], leaf.stacked)


def unshard_params(params: T.Transformer, mesh) -> T.Transformer:
    """The whole weights from every rank's tiles (:func:`shard_params`'
    inverse; a collective over the mesh)."""
    leaves = {path: _untile_leaf(leaf, params.shardings[path], mesh)
              for path, leaf in params.ref_leaves().items()}
    return T.params_from_leaves(params.cfg, leaves)


def unshard_opt_state(opt_state, shardings, mesh):
    """The whole optimizer state from every rank's tiles
    (:func:`shard_opt_state`'s inverse)."""
    inner = {path: {k: _untile_leaf(leaf, shardings.inner[path][k], mesh)
                    for k, leaf in st.items()}
             for path, st in opt_state.inner.items()}
    return O.OptState(opt_state.step, inner)


def shard_batch(batch: dict, shardings: dict, mesh) -> dict:
    """This rank's rows of each batch tensor."""
    return {k: _tile(v, _coords(mesh, shardings[k], v.shape))
            for k, v in batch.items()}


def _heads_split(name: str, spec: PartitionSpec, shape,
                 mesh) -> PartitionSpec:
    """A cache's spec as its tile is cut: the SSM state's (``"state"``, (L,
    B, H, P, N)) split of P read as a split of H (whole where the model
    axis does not divide the heads: every rank runs them all), the others'
    as given."""
    if name != "state" or spec[3] is None:
        return spec
    heads = spec[3] if shape[2] % _axis_size(mesh, spec[3]) == 0 else None
    return PartitionSpec(*spec[:2], heads, None, *spec[4:])


def shard_state(state: T.DecodeState, shardings: dict,
                mesh) -> T.DecodeState:
    """This rank's tiles of a whole decode state's caches under
    ``shardings`` (:func:`cache_shardings`), carried in the state; the SSM
    state's tile is the rank's heads (its spec's split of P taken as a
    split of H: the same bytes)."""
    caches = {k: _tile(v, _coords(mesh, _heads_split(k, shardings[k],
                                                     v.shape, mesh),
                                  v.shape))
              for k, v in state.caches.items()}
    return T.DecodeState(caches, state.position, shardings)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def loss_and_grads(params: T.Transformer, batch: dict, cfg: T.ModelConfig,
                   aux_weight: float = 0.01):
    """The train step's backward: (loss, aux, grads), grads by reference
    leaf path (``params.ref_leaves()``), each a list of the rows'
    gradients in the weights' dtypes.  The loss is ``softmax_xent(logits,
    labels) + aux_weight·aux``; the forward takes the reference's default
    attention route (``_sdpa``, ``flash=False``: the flash kernel has no
    backward) under ``cfg.remat_policy``, with ``frames``/``patches`` from
    the batch.  The weights require grad for this backward alone.

    On a sharded rank (a mesh declared): its tiles' gradients of its rows'
    loss (the cross entropy over a vocabulary split on the model axis when
    unembed is), each FSDP tile's summed over the data axes; the train
    step averages them over the data axes."""
    extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
    leaves = params.ref_leaves()
    flat = [t for leaf in leaves.values() for t in leaf.tensors]
    try:
        with torch.enable_grad():
            params.requires_grad_(True)
            logits, aux = T.forward(params, batch["tokens"], cfg, extra,
                                    flash=False)
            loss = softmax_xent(logits, batch["labels"],
                                tp=T.vocab_layout(params, cfg))
            del logits
            grads = torch.autograd.grad(loss + aux_weight * aux, flat,
                                        allow_unused=True)
    finally:
        params.requires_grad_(False)
    rows = iter(torch.zeros_like(t) if g is None else g
                for t, g in zip(flat, grads))
    by_leaf = {path: [next(rows) for _ in leaf.tensors]
               for path, leaf in leaves.items()}
    return loss.detach(), aux.detach(), by_leaf


def _data_mean(params: T.Transformer, loss, aux, grads: dict, ctx: dict):
    """The global batch's loss (the mean of the data shards') and the
    gradients averaged over the data axes: a leaf replicated over them
    all-reduced (fp32, one collective a leaf), an FSDP leaf, already summed
    and scattered by its gather's backward, divided.  aux is the global
    batch's already (an MoE layer sums its router statistics over the data
    axes, ``moe.moe_apply``), and so is its part of each gradient once
    averaged (those sums' backward sums the cotangents,
    ``collectives.psum_shared``): neither is averaged again."""
    daxes = ctx["data"]
    group = ctx["mesh"].group(daxes if len(daxes) > 1 else daxes[0])
    p = C.axis_size(group)
    if p == 1:
        return loss, aux, grads
    loss = C.psum(loss, group) / p
    out = {}
    for path, rows in grads.items():
        if any(ax not in (None, ctx["model"]) for ax in params.shardings[path]):
            out[path] = [g / p for g in rows]
            continue
        flat = C.psum(torch.cat([g.reshape(-1).float() for g in rows]),
                      group) / p
        out[path] = [f.view_as(g).to(g.dtype) for f, g in
                     zip(flat.split([g.numel() for g in rows]), rows)]
    return loss, aux, out


def _gnorm(params: T.Transformer, grads: dict, ctx: Optional[dict]):
    """√Σ of every leaf's fp32 gradient squared.  On a mesh each rank sums
    its tiles, a leaf's weighted by the share of the mesh that holds that
    tile (1 over its number of copies), and the sums are summed over every
    rank: no replicated tile counts twice."""
    weight = dict.fromkeys(grads, 1.0)
    world = 1
    if ctx is not None:
        shape = ctx["mesh"].shape
        for n in shape.values():
            world *= n
        for path in grads:
            split = 1
            for ax in params.shardings[path]:
                for a in (() if ax is None else
                          (ax,) if isinstance(ax, str) else ax):
                    split *= shape[a]
            weight[path] = split / world
    # an expert stack's squares a few experts at a time (its fp32 copy is
    # 15 GB at deepseek-v3's width)
    total = sum(torch.sum(torch.square(g[part].float())) * weight[path]
                for path, rows in grads.items() for g in rows
                for part in O.expert_pieces(g))
    if world > 1:
        total = C.psum(total, dist.group.WORLD)
    return torch.sqrt(total)


def make_train_step(cfg: T.ModelConfig, optimizer, aux_weight: float = 0.01,
                    grad_compression_axis: Optional[str] = None):
    """(params, opt_state, batch) → (params, opt_state, metrics), the
    parameters and the optimizer state updated in place (the reference
    donates them).  Gradients from :func:`loss_and_grads`.  metrics:
    ``loss`` (the cross entropy), ``aux`` and ``gnorm`` = √Σ over every
    leaf of its fp32 gradient squared, 0-d fp32 tensors.
    ``grad_compression_axis`` is accepted and unused, as in the
    reference.

    On a sharded rank (a mesh declared, the weights and the state its
    tiles: :func:`shard_params`, :func:`shard_opt_state`) it computes the
    one-device step of the global batch: the loss and aux the mean of the
    data shards', the gradients averaged over the data axes, gnorm over
    the whole mesh, each rank updating its tiles."""
    del grad_compression_axis

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(params, batch, cfg, aux_weight)
        ctx = mesh_context()
        if ctx is not None:
            loss, aux, grads = _data_mean(params, loss, aux, grads, ctx)
        gnorm = _gnorm(params, grads, ctx)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "aux": aux, "gnorm": gnorm}
    return train_step


def make_prefill_step(cfg: T.ModelConfig, kernels: str = "auto",
                      flash: bool = True):
    """(params, batch) → last-position logits (B, V).  ``batch`` holds
    ``tokens`` and, for encdec and the VLM, ``frames`` or ``patches`` (the
    stub frontends' embeddings).  Full-sequence and cross attention (the
    hybrid's shared block, whisper's encoder too) go through the flash
    kernel's dispatch (``kernels``), or with ``flash=False`` the
    reference's default ``_sdpa``.  On a sharded rank: its rows and its
    vocabulary columns."""
    def prefill(params, batch):
        extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
        logits, _ = T.forward(params, batch["tokens"], cfg, extra,
                              kernels=kernels, flash=flash)
        return logits[:, -1, :]
    return prefill


def make_serve_step(cfg: T.ModelConfig, kernels: str = "auto"):
    """One decode token: (params, batch, state) → (next_tokens (B, 1)
    int32, state).  Greedy: the first index of the largest logit.
    ``batch`` holds ``tokens`` and, for encdec and the VLM, ``enc_out``
    (``models.transformer.encode``'s output) or ``patches``; their
    cross-attention goes through the flash kernel's dispatch
    (``kernels``: the kernel on the card, its plain version with
    ``"torch"``)."""
    def serve_step(params, batch, state: T.DecodeState):
        extra = {k: batch[k] for k in ("enc_out", "patches") if k in batch}
        logits, new_state = T.decode_step(params, batch["tokens"], state, cfg,
                                          extra, kernels=kernels)
        nxt = T.greedy(params, logits[:, -1, :]).to(torch.int32)[:, None]
        return nxt, new_state
    return serve_step


# ---------------------------------------------------------------------------
# Abstract state builders (the dry run: fake tensors, no storage)
# ---------------------------------------------------------------------------

def abstract_params(cfg: T.ModelConfig, device=None):
    """(params, specs): ``init_params``' weights, on fake tensors when
    called under a ``FakeTensorMode`` (shapes and dtypes only), and
    :func:`models.transformer.param_specs`."""
    return T.init_params(0, cfg, device=device), T.param_specs(cfg)


def abstract_state(cfg: T.ModelConfig, optimizer, shape_kind: str,
                   batch: int, seq: int, device=None):
    """(params, specs, extra) as the reference's: extra the optimizer's
    state (``optimizer.init``) for ``"train"``, the decode state for
    ``"decode"``, None for ``"prefill"``; on fake tensors when called under
    a ``FakeTensorMode``."""
    params, specs = abstract_params(cfg, device)
    if shape_kind == "train":
        return params, specs, optimizer.init(params)
    if shape_kind == "decode":
        return params, specs, T.init_decode_state(cfg, batch, seq,
                                                  device=device)
    return params, specs, None
