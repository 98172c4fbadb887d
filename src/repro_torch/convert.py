"""Weights carried across: numpy arrays (e.g. a JAX MPS or LM parameter
tree) → the port's MPS or model.

Parity tests build every MPS and every LM in the JAX package and hand it
over through numpy, so both packages run the very same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mps import MPS
from repro_torch.device import DeviceLike, resolve_device


def tensor_from_array(a, device: DeviceLike = None, *,
                      view_as: torch.dtype | None = None) -> torch.Tensor:
    """Copy an array-like (numpy, or anything ``np.asarray`` takes,
    complex128 and ``ml_dtypes.bfloat16`` included) into a tensor on
    ``device``.  ``view_as=torch.bfloat16`` reads a uint16 array as bf16
    bits, the form the JAX package's checkpoints and Γ stores keep."""
    a = np.array(a, copy=True)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: move the bits
        a, view_as = a.view(np.uint16), torch.bfloat16
    if view_as is not None:
        if a.dtype != np.uint16 or view_as != torch.bfloat16:
            raise ValueError(f"view_as={view_as} reads uint16 bf16 bits; "
                             f"got a {a.dtype} array")
        return torch.from_numpy(a).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 comes out as its uint16
    bits (numpy has no bf16: ``.view(ml_dtypes.bfloat16)`` reads them)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy()
    return t.numpy().copy()


def mps_from_arrays(gammas, lambdas, semantics: str = "linear",
                    device: DeviceLike = None, *,
                    gammas_view_as: torch.dtype | None = None) -> MPS:
    """``gammas (M, χ, χ, d)``, ``lambdas (M, χ)`` arrays → ``MPS``; a bf16
    Γ comes as ``ml_dtypes.bfloat16`` or as uint16 bits with
    ``gammas_view_as=torch.bfloat16``."""
    if semantics not in ("linear", "born"):
        raise ValueError(f"semantics must be 'linear' or 'born', "
                         f"got {semantics!r}")
    g = tensor_from_array(gammas, device, view_as=gammas_view_as)
    lam = tensor_from_array(lambdas, device)
    if g.ndim != 4 or lam.shape != g.shape[:2]:
        raise ValueError(f"expected gammas (M, χ, χ, d) and lambdas (M, χ); "
                         f"got {tuple(g.shape)} and {tuple(lam.shape)}")
    return MPS(g, lam, semantics)


def lm_params_from_arrays(tree, cfg, device: DeviceLike = None):
    """The reference's LM parameter tree (``repro.models.transformer.
    init_params`` output as numpy arrays: a dict with ``embed``, ``ln_f``,
    ``unembed``, ``layers`` stacked on axis 0; for the hybrid
    ``shared_attn``; for encdec ``enc_layers`` stacked, ``enc_ln_f``,
    ``enc_pos``, ``dec_pos``; for the VLM ``cross_layers`` stacked and
    ``ln_cross``) → a port
    :class:`~repro_torch.models.transformer.Transformer` with the same
    weights, for every family (nested dicts such as MoE's ``shared`` MLP,
    a layer's ``mamba`` weights or a decoder layer's ``self`` and
    ``cross`` attention are taken as they are; every leaf keeps its dtype,
    the fp32 router and the SSM's fp32 ``A_log``, ``D`` and ``dt_bias``
    too)."""
    from repro_torch.models.transformer import Transformer

    dev = resolve_device(device)

    def leaf(a):
        return tensor_from_array(a, dev)

    def layer(node, i=None):
        """The ``i``-th layer of a stacked subtree, or, with no ``i``, an
        unstacked one whole."""
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return leaf(node if i is None else node[i])

    def stack(node, name, want):
        """The layers of a stacked subtree, counted by its leaf ``name``
        and held to the config's ``want``."""
        n = len(node[name])
        if n != want:
            raise ValueError(f"tree has {n} layers, config {want}")
        return [layer(node, i) for i in range(n)]

    layers = tree["layers"]
    out = {"embed": leaf(tree["embed"]), "ln_f": leaf(tree["ln_f"]),
           "unembed": leaf(tree["unembed"]),
           "layers": stack(layers, "ln1" if "ln1" in layers else "ln",
                           cfg.n_layers)}
    if "shared_attn" in tree:
        out["shared_attn"] = layer(tree["shared_attn"])
    if "enc_layers" in tree:
        out["enc_layers"] = stack(tree["enc_layers"], "ln1",
                                  cfg.n_enc_layers)
        for name in ("enc_ln_f", "enc_pos", "dec_pos"):
            out[name] = leaf(tree[name])
    if "cross_layers" in tree:
        out["cross_layers"] = stack(tree["cross_layers"], "wq",
                                    cfg.n_layers // cfg.cross_attn_every)
        out["ln_cross"] = leaf(tree["ln_cross"])
    return Transformer(cfg, out)


def _nest(flat: dict) -> dict:
    """{"a/b/c": x} → {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for path, value in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return out


def _at(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def lm_arrays_from_params(params) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: a port model → the
    reference's parameter tree as numpy arrays, every stacked leaf
    stacked on axis 0 again (bf16 as ``ml_dtypes.bfloat16``)."""
    import ml_dtypes

    def arr(leaf):
        a = array_from_tensor(leaf.full())
        return a.view(ml_dtypes.bfloat16) if leaf.dtype == torch.bfloat16 \
            else a
    return _nest({path: arr(leaf)
                  for path, leaf in params.ref_leaves().items()})


def _rows(name: str, leaf) -> bool:
    """Whether the state array ``name`` of ``leaf`` is kept a row a layer
    (the layer axis first), as ``optim.optimizers`` keeps it."""
    return leaf.stacked and not (name == "vc" and leaf.tensors[0].ndim == 1)


def opt_state_from_arrays(state, params, device: DeviceLike = None):
    """The reference's ``OptState`` as numpy (``step`` and ``inner``: per
    leaf of the parameter tree a dict of ``m``/``v`` or ``vr``/``vc``/``v``
    arrays) → the port's ``optim.OptState`` for ``params`` (a model or a
    dict of ``core.tree.Leaf`` s), each array split into rows where the
    port keeps rows."""
    from repro_torch.core.tree import Leaf
    from repro_torch.optim.optimizers import OptState, param_leaves

    dev = resolve_device(device)
    step, inner = state
    out = {}
    for path, leaf in param_leaves(params).items():
        out[path] = {}
        for name, a in _at(inner, path).items():
            t = tensor_from_array(a, dev)
            out[path][name] = (Leaf(list(t.unbind(0)), True)
                               if _rows(name, leaf) else Leaf([t], False))
    return OptState(tensor_from_array(np.asarray(step, np.int32), dev), out)


def opt_state_to_arrays(state) -> tuple:
    """The inverse of :func:`opt_state_from_arrays`: (step, inner) as
    numpy, shaped as the reference's ``OptState``."""
    inner = {f"{path}/{name}": array_from_tensor(leaf.full())
             for path, names in state.inner.items()
             for name, leaf in names.items()}
    return array_from_tensor(state.step), _nest(inner)
