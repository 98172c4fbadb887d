"""FastMPS on PyTorch and CUDA: the chain sampler ported to NVIDIA Hopper.

The package mirrors ``repro`` module for module.  It imports ``torch`` and
numpy only; the JAX package is the reference the port is tested against and
is never imported from here.

Entry points (``api.SamplingSession``, ``launch.sample``) run on the CUDA
device unless the caller passes ``device="cpu"``; without a GPU and without
that request they raise (see :mod:`repro_torch.device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
