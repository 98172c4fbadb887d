"""Optimizers over the reference's parameter leaves (no library optimizer).

* ``adamw``      — the trainer for the archs of at most 100 B parameters.
* ``adafactor``  — a factored second moment: the state of a matrix is
  O(rows + cols) instead of O(rows·cols), the only optimizer whose state
  fits the trillion-parameter MoEs.

Each is an ``(init, update)`` pair over a tree whose leaves are the
reference's (``core.tree``): a model is taken through its ``ref_leaves()``,
so ``layers/attn/wq`` is one leaf of L rows although the port keeps one
tensor a layer.  That matters to adafactor, whose math sees the stacked
leaf: ``_factored`` tests the stacked rank (a layer's (dm,) norm is an (L,
dm) leaf and is factored across the layer axis, its ``vc`` a mean over the
layers), and the update clip ``rms_u`` is one RMS over the whole stacked
leaf.  adamw is elementwise.  Both work a layer at a time: ``rms_u`` is a
sum of per-layer sums, and each layer's update is computed again after it
rather than held, so no stacked copy of a gradient is made.

The state (:class:`OptState`) holds, per leaf path, the reference's state
arrays as :class:`~repro_torch.core.tree.Leaf` s: per-layer rows where the
reference's array has the layer axis first (adamw's ``m``/``v``,
adafactor's ``vr``, and ``vc`` of a leaf whose rows are matrices), one
tensor where it has not (``vc`` of a stacked vector leaf, (dm,)).  So it
converts to and from the reference's ``OptState`` shapes
(``convert.opt_state_from_arrays``).  ``update`` writes the parameters and
the state in place (the reference donates both) and returns them.

On a sharded rank (a model whose ``shardings`` are set, its mesh declared
with ``models.common.set_mesh_axes``) the parameters, gradients and state
are the rank's tiles (``launch.steps.shard_opt_state``).  adamw needs
nothing more; adafactor's reductions over a split dim (the means of g²
over the last two dims, ``vr``'s mean, ``rms_u``) sum over that dim's
axes (:class:`_Split`; an MoE expert leaf's over the model axis its
experts are split on too), so every rank updates its tiles as one device
would update the whole leaf.  adafactor takes an expert stack (E, dm, df)
a few experts at a time (:func:`expert_pieces`): its fp32 temporaries are
then a piece's, at most ``PIECE_BYTES``, not the 15 GB of one deepseek-v3
expert leaf's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import collectives as C
from repro_torch.core.tree import Leaf
from repro_torch.models.common import mesh_context


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    inner: dict              # leaf path → {state name → Leaf}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[dict, OptState, Any], tuple[Any, OptState]]
    name: str = ""


def param_leaves(params) -> dict[str, Leaf]:
    """A model's (``ref_leaves()``) or a dict's leaves by path."""
    if hasattr(params, "ref_leaves"):
        return params.ref_leaves()
    return dict(params)


def _zeros(leaf: Leaf, drop: int | None = None) -> Leaf:
    """fp32 zeros shaped as the leaf's rows, with the row dim ``drop``
    (−1 or −2 of the reference's shape) left out."""
    def z(t):
        shape = list(t.shape)
        if drop is not None:
            del shape[drop]
        return torch.zeros(shape, dtype=torch.float32, device=t.device)
    return Leaf([z(t) for t in leaf.tensors], leaf.stacked)


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _step_of(state: OptState) -> tuple[torch.Tensor, torch.Tensor]:
    step = state.step + 1
    return step, step.to(torch.float32)


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        leaves = param_leaves(params)
        return OptState(torch.zeros((), dtype=torch.int32),
                        {path: {"m": _zeros(leaf), "v": _zeros(leaf)}
                         for path, leaf in leaves.items()})

    @torch.no_grad()
    def update(grads, state, params):
        step, t = _step_of(state)
        leaves = param_leaves(params)
        lr_t, c1, c2 = _on_device(leaves, _lr_at(lr, step), 1 - b1 ** t,
                                  1 - b2 ** t)
        for path, leaf in leaves.items():
            s = state.inner[path]
            for p, g, m, v in zip(leaf.tensors, grads[path],
                                  s["m"].tensors, s["v"].tensors):
                g = g.float()
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                upd = (m / c1) / (torch.sqrt(v / c2) + eps) \
                    + weight_decay * p.float()
                p.copy_(p.float() - lr_t * upd)
        return params, OptState(step, state.inner)

    return Optimizer(init, update, "adamw")


def _on_device(leaves: dict, *xs):
    """The step's scalars (the step lives on the host) copied once to the
    weights' device, a Python number as it is.  Copied on the CPU too, so
    the dry run's counter sees the same ops on either device."""
    dev = next(iter(leaves.values())).tensors[0].device
    return tuple(x.to(dev, copy=True) if isinstance(x, torch.Tensor) else x
                 for x in xs)


class _Split:
    """How a leaf is split over the declared mesh: the process group and
    size of each of its reference dims (None where the dim is whole).  A
    model without ``shardings``, or no mesh declared: nothing is split."""

    def __init__(self, params, path: str):
        ctx = mesh_context()
        spec = getattr(params, "shardings", None)
        spec = spec[path] if ctx is not None and spec is not None else ()
        self.dims = []
        for ax in spec:
            group = None if ax is None else ctx["mesh"].group(ax)
            n = 1 if group is None else C.axis_size(group)
            self.dims.append((group, n) if n > 1 else None)

    def _dim(self, d: int):
        return self.dims[d] if self.dims else None

    def mean(self, x: torch.Tensor, dim: int, ref: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
        """The whole leaf's mean over ``dim`` of ``x`` (a row of it, or of
        its state), which is the leaf's reference dim ``ref`` (by default
        ``dim``; both < 0, counted from the last)."""
        split = self._dim(dim if ref is None else ref)
        if split is None:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        return self.mean_of(torch.sum(x, dim=dim, keepdim=keepdim),
                            x.shape[dim], dim if ref is None else ref)

    def mean_of(self, total: torch.Tensor, size: int,
                ref: int) -> torch.Tensor:
        """The whole leaf's mean from this rank's sum ``total`` over
        ``size`` elements of reference dim ``ref``: summed over that dim's
        axes when it is split."""
        split = self._dim(ref)
        if split is None:
            return total / size
        group, n = split
        return C.psum(total, group) / (size * n)

    def size(self) -> int:
        """How many tiles the leaf is cut into."""
        out = 1
        for split in self.dims:
            out *= 1 if split is None else split[1]
        return out

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's tile summed over every split dim."""
        for split in self.dims:
            if split is not None:
                x = C.psum(x, split[0])
        return x


PIECE_BYTES = 1 << 30    # the most fp32 bytes of an expert stack at once


def expert_pieces(g: torch.Tensor) -> list:
    """Slices of a row's leading dim: an expert stack (E, dm, df) whose
    fp32 copy is larger than ``PIECE_BYTES`` a few experts at a time (18
    of deepseek-v3's 256 × 7168 × 2048, 15 GB whole), so that adafactor's
    and gnorm's fp32 temporaries are a piece's; any other row whole (an
    attention weight (dm, heads, dh) too)."""
    per = 4 * g[0].numel() if g.ndim >= 3 else 0
    if per * g.shape[0] <= PIECE_BYTES:
        return [slice(None)]
    n = max(1, PIECE_BYTES // per)
    return [slice(i, i + n) for i in range(0, g.shape[0], n)]


def adafactor(lr: float | Callable = 1e-2, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), factored over the last two dims of
    every leaf of reference rank ≥ 2."""
    def _factored(leaf: Leaf) -> bool:
        return len(leaf.shape) >= 2

    def init(params):
        def leaf_state(leaf):
            if not _factored(leaf):
                return {"v": _zeros(leaf)}
            if leaf.stacked and leaf.tensors[0].ndim == 1:
                # (L, n): vc (n,) is shared by the rows
                t = leaf.tensors[0]
                return {"vr": _zeros(leaf, -1),
                        "vc": Leaf([torch.zeros(t.shape, dtype=torch.float32,
                                                device=t.device)], False)}
            return {"vr": _zeros(leaf, -1), "vc": _zeros(leaf, -2)}
        leaves = param_leaves(params)
        return OptState(torch.zeros((), dtype=torch.int32),
                        {path: leaf_state(leaf)
                         for path, leaf in leaves.items()})

    @torch.no_grad()
    def update(grads, state, params):
        step, t = _step_of(state)
        leaves = param_leaves(params)
        beta, lr_t = _on_device(leaves, 1.0 - t ** -decay, _lr_at(lr, step))
        for path, leaf in leaves.items():
            _update_leaf(leaf, grads[path], state.inner[path], beta, lr_t,
                         _Split(params, path))
        return params, OptState(step, state.inner)

    def _update_leaf(leaf, grads, s, beta, lr_t, split):
        rows = list(zip(leaf.tensors, grads))

        def g2(g):
            g = g.float()
            return g, g * g + eps

        if not _factored(leaf):
            for (_, g), v in zip(rows, s["v"].tensors):
                g, sq = g2(g)
                v.copy_(beta * v + (1 - beta) * sq)

            def u_of(i, g, part=slice(None)):       # rows of rank < 2
                return g.float() * torch.rsqrt(s["v"].tensors[i] + eps)
        elif leaf.stacked and leaf.tensors[0].ndim == 1:
            # vr (L,): a row's mean; vc (n,): the mean over the rows; rfac
            # relative to the mean of vr over the rows
            vc = s["vc"].tensors[0]
            col = torch.zeros_like(vc)
            for (_, g), vr in zip(rows, s["vr"].tensors):
                g, sq = g2(g)
                vr.copy_(beta * vr + (1 - beta) * split.mean(sq, -1))
                col += sq
            vc.copy_(beta * vc + (1 - beta) * (col / len(rows)))
            vr_mean = torch.stack(s["vr"].tensors).mean()

            def u_of(i, g, part=slice(None)):       # rows of rank 1
                rfac = s["vr"].tensors[i] / vr_mean
                return g.float() * torch.rsqrt(rfac * vc + eps)
        else:
            for (_, g), vr, vc in zip(rows, s["vr"].tensors,
                                      s["vc"].tensors):
                # g² a piece at a time (an expert stack's few experts), its
                # sums over the last two dims put together, then the means
                rs, cs = [], []
                for part in expert_pieces(g):
                    sq = g2(g[part])[1]
                    rs.append(torch.sum(sq, dim=-1))
                    cs.append(torch.sum(sq, dim=-2))
                del sq        # not held through the update's temporaries
                rs, cs = ((torch.cat(t) if len(t) > 1 else t[0])
                          for t in (rs, cs))
                vr.copy_(beta * vr + (1 - beta) * split.mean_of(
                    rs, g.shape[-1], -1))
                vc.copy_(beta * vc + (1 - beta) * split.mean_of(
                    cs, g.shape[-2], -2))

            # vr's last dim is the leaf's second-to-last
            rfacs = [(vr / split.mean(vr, -1, ref=-2, keepdim=True))[..., None]
                     for vr in s["vr"].tensors]

            def u_of(i, g, part=slice(None)):
                vc = s["vc"].tensors[i][part]
                return g[part].float() * torch.rsqrt(
                    rfacs[i][part] * vc[..., None, :] + eps)

        # one RMS over the whole leaf, from per-row sums (an expert stack's
        # from its pieces'); then each row's update again, clipped
        total = split.total(sum(torch.sum(torch.square(u_of(i, g, part)))
                                for i, (_, g) in enumerate(rows)
                                for part in expert_pieces(g)))
        count = sum(g.numel() for _, g in rows) * split.size()
        rms_u = torch.sqrt(total / count + eps)
        clip = torch.clamp(rms_u / clip_threshold, min=1.0)
        for i, (p, g) in enumerate(rows):
            for part in expert_pieces(g):
                u = u_of(i, g, part) / clip
                newp = p[part].float() - lr_t * u
                if weight_decay:
                    newp = newp - lr_t * weight_decay * p[part].float()
                p[part].copy_(newp)

    return Optimizer(init, update, "adafactor")


def optimizer_for(cfg, lr=None) -> Optimizer:
    """The reference's policy: adafactor for models above 100 B parameters
    (its state must fit the device memory), adamw for the rest."""
    total, _ = cfg.param_count()
    if total > 100e9:
        return adafactor(lr or 1e-2)
    return adamw(lr or 3e-4)
