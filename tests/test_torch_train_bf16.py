"""The port's bf16 training gradients and its bf16 ``_sdpa``-route forward
against the JAX package run op by op (``jax.disable_jit()``), for the 10
smoke archs.  Kept apart from ``test_torch_train.py`` (whose helpers and
tolerances it uses; see its docstring) because the reference's op-by-op
backward is slow: one ``loadfile`` unit each stays near two minutes.
"""
import jax
import pytest
torch = pytest.importorskip("torch")

from test_torch_train import (ARCHS, GRAD_TOL, _batch,  # noqa: E402
                              _hold_grads, _jax_loss_and_grads, _models,
                              hold_sdpa_forward)
from repro_torch.launch import steps  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_bf16(arch):
    """bf16 loss, aux and gradients against the reference op by op."""
    jcfg, jparams, cfg, params = _models(arch, "bf16")
    jb, tb = _batch(cfg, "bf16")
    with jax.disable_jit():
        loss, aux, want = _jax_loss_and_grads(jcfg, jparams, jb)
    tloss, taux, grads = steps.loss_and_grads(params, tb, cfg)
    assert float(tloss) == pytest.approx(loss, rel=1e-5)
    assert float(taux) == pytest.approx(aux, rel=1e-5, abs=1e-7)
    assert all(g.dtype == cfg.dtype or g.dtype == torch.float32
               for rows in grads.values() for g in rows)
    _hold_grads(params, grads, want, GRAD_TOL["bf16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sdpa_route_matches_reference_forward_bf16(arch):
    hold_sdpa_forward(arch, "bf16")
