"""The port's Mamba2 block (``repro_torch.models.mamba2``, plain PyTorch on
the CPU) against the JAX package's on the same weights: the chunked
prefill, the decode step, the SSD core and the init.

The weights come from the reference's ``mamba2_init``; ``A_log``, ``D``,
``dt_bias`` and ``norm_g`` are then redrawn from a seeded numpy generator
(``D = 1`` and ``dt_bias = 0`` would hide a dropped term).  A chunk of 4 at
S = 12, 10 and 7 runs three chunks, chunks of 2 and chunks of 1, so that
the inter-chunk recurrence runs more than once.  Tolerances, relative to
the largest |output|: fp32 1e-5 (the two frameworks sum in other orders);
bf16 3e-2 (both round every activation to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import mamba2 as jax_M2
from repro_torch import convert
from repro_torch.models import mamba2 as M2

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 3e-2}
CFG = {1: M2.Mamba2Config(d_model=32, d_state=8, d_head=8, chunk=4),
       2: M2.Mamba2Config(d_model=32, d_state=8, d_head=8, n_groups=2,
                          chunk=4)}


def _jcfg(cfg):
    return jax_M2.Mamba2Config(**dataclasses.asdict(cfg))


def _params(groups: int, prec: str, seed: int = 0, big_dt: bool = False):
    """(reference params, port params) on the same perturbed weights."""
    cfg = CFG[groups]
    jdt, _ = DTYPES[prec]
    jparams, _ = jax_M2.mamba2_init(jax.random.key(seed), _jcfg(cfg), jdt)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(seed + 11)
    h = cfg.heads
    tree["A_log"] = (tree["A_log"] + 0.3 * rng.normal(size=h)).astype(
        np.float32)
    tree["D"] = (1 + 0.5 * rng.normal(size=h)).astype(np.float32)
    tree["dt_bias"] = (0.5 * rng.normal(size=h) + (40 if big_dt else 0)
                       ).astype(np.float32)
    tree["norm_g"] = (1 + 0.2 * rng.normal(size=cfg.d_inner)).astype(
        tree["norm_g"].dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = {k: convert.tensor_from_array(v, "cpu") for k, v in tree.items()}
    return jparams, params


def _x(cfg, prec, b, s, seed=3):
    jdt, tdt = DTYPES[prec]
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, prec: str, tol=None):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= (tol or TOL[prec]), (err, tol or TOL[prec])


@pytest.mark.parametrize("s", [12, 10, 7])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_prefill_matches(prec, groups, s):
    """The chunked prefill at S = 12, 10, 7 under chunk 4: chunks of 4, 2
    and 1 (a prime S walks L down to 1)."""
    cfg = CFG[groups]
    jparams, params = _params(groups, prec)
    jx, x = _x(cfg, prec, 2, s)
    want, wstate = jax_M2.mamba2_apply(jparams, jx, _jcfg(cfg))
    got, state = M2.mamba2_apply(params, x, cfg)
    assert wstate is None and state is None
    assert got.dtype == x.dtype
    _close(got, want, prec)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_decode_matches(prec, groups):
    """Token by token from a zero state: every step's output and the
    final fp32 state."""
    cfg = CFG[groups]
    jparams, params = _params(groups, prec)
    jx, x = _x(cfg, prec, 3, 6, seed=5)
    jst = jax_M2.init_ssm_state(3, _jcfg(cfg), jx.dtype)
    st = M2.init_ssm_state(3, cfg, x.dtype, "cpu")
    assert st.state.shape == jst.state.shape == (3, cfg.heads, cfg.d_head,
                                                 cfg.d_state)
    assert st.state.dtype == torch.float32 and st.conv.shape == (3, 1)
    for t in range(6):
        want, jst = jax_M2.mamba2_apply(jparams, jx[:, t:t + 1], _jcfg(cfg),
                                        jst)
        got, st = M2.mamba2_apply(params, x[:, t:t + 1], cfg, st)
        _close(got, want, prec)
    _close(st.state, jst.state, "fp32")


@pytest.mark.parametrize("s", [12, 10, 7])
def test_ssd_core_matches(s):
    """``_ssd_chunked`` alone in fp32: y and the final state."""
    cfg = CFG[2]
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, cfg.heads, cfg.d_head, 2, cfg.d_state
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=h).astype(np.float32)
    bb = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, g, n)).astype(np.float32)
    want_y, want_st = jax_M2._ssd_chunked(*map(jnp.asarray, (x, dt, a, bb,
                                                             cc)),
                                          _jcfg(cfg))
    got_y, got_st = M2._ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb,
                                                            cc)), cfg)
    _close(got_y, want_y, "fp32")
    _close(got_st, want_st, "fp32")


@pytest.mark.parametrize("s", [12, 10, 7])
def test_chunked_prefill_equals_the_step_recurrence(s):
    """The port against itself in fp32: the chunked prefill's output and
    final state equal those of S decode steps (the recurrence the chunks
    reorder)."""
    cfg = CFG[1]
    _, params = _params(1, "fp32", seed=2)
    _, x = _x(cfg, "fp32", 2, s, seed=s)
    full, _ = M2.mamba2_apply(params, x, cfg)
    st = M2.init_ssm_state(2, cfg, x.dtype, "cpu")
    outs = []
    for t in range(s):
        y, st = M2.mamba2_apply(params, x[:, t:t + 1], cfg, st)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=1e-5,
                               atol=1e-5 * full.abs().max().item())
    a = -torch.exp(params["A_log"])
    z = x @ params["w_in"]
    xi, _, b, c, dtr = M2._split_proj(z, cfg)
    dt = torch.logaddexp(dtr + params["dt_bias"], torch.zeros(()))
    _, final = M2._ssd_chunked(xi.reshape(2, s, cfg.heads, cfg.d_head), dt,
                               a, b.reshape(2, s, 1, cfg.d_state),
                               c.reshape(2, s, 1, cfg.d_state), cfg)
    torch.testing.assert_close(final, st.state, rtol=1e-5,
                               atol=1e-5 * st.state.abs().max().item())


def test_masked_decays_overflow_without_nan():
    """A large dt makes exp(cum_i − cum_j) overflow on the acausal entries;
    the double where keeps them out (a product with the mask would give
    inf · 0 = NaN), as the reference's."""
    cfg = CFG[1]
    jparams, params = _params(1, "fp32", big_dt=True)
    jx, x = _x(cfg, "fp32", 2, 12)
    got, _ = M2.mamba2_apply(params, x, cfg)
    want, _ = jax_M2.mamba2_apply(jparams, jx, _jcfg(cfg))
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want, "fp32")


def test_softplus_is_logaddexp():
    """dt = logaddexp(x, 0), the formula of ``jax.nn.softplus``, which
    torch's ``softplus`` (log1p(exp(x)) up to 20, x above) does not
    follow: within two ulps of the reference's fp32 (the two libraries'
    exp and log1p round apart) and equal to it more often than
    ``F.softplus``."""
    xs = np.linspace(-30.0, 30.0, 60001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    got = torch.logaddexp(torch.from_numpy(xs), torch.zeros(())).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    other = torch.nn.functional.softplus(torch.from_numpy(xs)).numpy()
    assert (got != want).sum() < (other != want).sum()


def test_decode_takes_one_token():
    cfg = CFG[1]
    _, params = _params(1, "fp32")
    _, x = _x(cfg, "fp32", 2, 3)
    with pytest.raises(ValueError, match="one token"):
        M2.mamba2_apply(params, x, cfg, M2.init_ssm_state(2, cfg, x.dtype,
                                                         "cpu"))


@pytest.mark.parametrize("groups", [1, 2])
def test_init_and_split_match_the_reference(groups):
    """``mamba2_init``: the reference's names, shapes and dtypes and its
    D, dt_bias and norm_g values, A_log within an ulp (the two libraries'
    fp32 linspace and log round apart); ``_split_proj``'s five widths."""
    cfg = CFG[groups]
    jparams, _ = jax_M2.mamba2_init(jax.random.key(0), _jcfg(cfg),
                                    jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = M2.mamba2_init(gen, cfg, torch.bfloat16, "cpu")
    assert sorted(params) == sorted(jparams)
    for name, w in jparams.items():
        assert tuple(params[name].shape) == w.shape, name
        want_dt = torch.bfloat16 if w.dtype == jnp.bfloat16 else \
            torch.float32
        assert params[name].dtype == want_dt, name
        if name not in ("w_in", "w_out"):      # A_log: linspace and log
            np.testing.assert_allclose(           # round apart by an ulp
                params[name].float().numpy(),
                np.asarray(jnp.asarray(w, jnp.float32)),
                rtol=1e-6 if name == "A_log" else 0)
    z = torch.zeros((2, 3, params["w_in"].shape[1]))
    jz = jnp.zeros(z.shape)
    for got, want in zip(M2._split_proj(z, cfg),
                         jax_M2._split_proj(jz, _jcfg(cfg))):
        assert tuple(got.shape) == want.shape
    assert cfg.heads == 2 * cfg.d_model // cfg.d_head
    assert cfg.d_inner == cfg.heads * cfg.d_head
