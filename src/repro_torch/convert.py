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
