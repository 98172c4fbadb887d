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


def tensor_from_array(a, device: DeviceLike = None) -> torch.Tensor:
    """Copy an array-like (numpy, or anything ``np.asarray`` takes,
    complex128 and bfloat16 included) into a tensor on ``device``."""
    a = np.array(a, copy=True)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def mps_from_arrays(gammas, lambdas, semantics: str = "linear",
                    device: DeviceLike = None) -> MPS:
    """``gammas (M, χ, χ, d)``, ``lambdas (M, χ)`` arrays → ``MPS``."""
    if semantics not in ("linear", "born"):
        raise ValueError(f"semantics must be 'linear' or 'born', "
                         f"got {semantics!r}")
    g = tensor_from_array(gammas, device)
    lam = tensor_from_array(lambdas, device)
    if g.ndim != 4 or lam.shape != g.shape[:2]:
        raise ValueError(f"expected gammas (M, χ, χ, d) and lambdas (M, χ); "
                         f"got {tuple(g.shape)} and {tuple(lam.shape)}")
    return MPS(g, lam, semantics)


def lm_params_from_arrays(tree, cfg, device: DeviceLike = None):
    """The reference's LM parameter tree (``repro.models.transformer.
    init_params`` output as numpy arrays: a dict with ``embed``, ``ln_f``,
    ``unembed`` and ``layers``, layers stacked on axis 0) → a port
    :class:`~repro_torch.models.transformer.Transformer` with the same
    weights, for the dense family."""
    from repro_torch.models.transformer import Transformer

    dev = resolve_device(device)

    def leaf(a):
        return tensor_from_array(a, dev)

    layers = tree["layers"]
    n = len(layers["ln1"])
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    per_layer = [{"attn": {k: leaf(v[i]) for k, v in layers["attn"].items()},
                  "mlp": {k: leaf(v[i]) for k, v in layers["mlp"].items()},
                  "ln1": leaf(layers["ln1"][i]),
                  "ln2": leaf(layers["ln2"][i])} for i in range(n)]
    return Transformer(cfg, {"embed": leaf(tree["embed"]),
                             "ln_f": leaf(tree["ln_f"]),
                             "unembed": leaf(tree["unembed"]),
                             "layers": per_layer})
