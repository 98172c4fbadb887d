"""The port's site step (plain PyTorch on the CPU) against three JAX
references on the same env, Γ, λ, u: the ``xla`` cells and the ``ref.py``
oracle on every shape, and the fused Pallas kernels in interpret mode (as
``tests/test_site_step.py`` runs them) on one awkward shape per semantics,
precision and scaling mode (interpret mode is the slow reference).

Tolerance: samples equal; env and dlog ``rtol=1e-12, atol=1e-14`` in fp64
and ``rtol=1e-5, atol=1e-6`` in fp32 — the two packages sum the contraction
in different orders, so env agrees to rounding, not bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import precision as jax_precision
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import ref as jax_ref
from repro.kernels import site_impls as jax_impls
from repro.kernels import site_step as jax_site_step
from repro_torch.kernels import ops, ref, site_step

SHAPES = [(8, 4, 3), (37, 13, 5), (64, 32, 2)]
PALLAS_SHAPE = (37, 13, 5)        # N not a multiple of the 8-row block
TOL = {"fp64": dict(rtol=1e-12, atol=1e-14), "fp32": dict(rtol=1e-5, atol=1e-6)}
REAL = {"fp64": np.float64, "fp32": np.float32}
CPLX = {"fp64": np.complex128, "fp32": np.complex64}


def _operands(semantics, prec, n, chi, d, seed=0):
    """numpy operands from a seed: linear non-negative, Born complex."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n).astype(REAL[prec])
    if semantics == "linear":
        env = rng.uniform(size=(n, chi)).astype(REAL[prec])
        gamma = rng.uniform(size=(chi, chi, d)).astype(REAL[prec])
        lam = rng.uniform(size=chi).astype(REAL[prec])
    else:
        env = (rng.normal(size=(n, chi))
               + 1j * rng.normal(size=(n, chi))).astype(CPLX[prec])
        gamma = (rng.normal(size=(chi, chi, d))
                 + 1j * rng.normal(size=(chi, chi, d))).astype(CPLX[prec])
        lam = (rng.uniform(size=chi) + 0.5).astype(REAL[prec])
    return env, gamma, lam, u


def _pallas(semantics, scaling, env, gamma, lam, u):
    """The fused Pallas kernel in interpret mode; ``global`` rescaled
    outside, as the Pallas dispatch cell does."""
    n, chi = env.shape
    cfg = jax_dispatch._heuristic("site_step", n, chi, chi, 3, 8, 1)
    blocks = dict(bn=min(cfg.bn, 8) if n % 8 == 0 else n, br=cfg.br,
                  bl=cfg.bl)
    kern = (jax_site_step.site_step_linear if semantics == "linear"
            else jax_site_step.site_step_born)
    fused = scaling if scaling != "global" else "none"
    e, s, dl = kern(jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam),
                    jnp.asarray(u), scaling=fused, interpret=True, **blocks)
    if scaling == "global":
        e, dl = jax_precision.rescale(e, "global")
    return e, s, dl


def _jax_ref(semantics, scaling, env, gamma, lam, u):
    args = [jnp.asarray(a) for a in (env, gamma, lam, u)]
    if scaling == "global":
        e, s, _ = jax_ref.site_step_ref(*args, semantics, scaling="none")
        e, dl = jax_precision.rescale(e, "global")
        return e, s, dl
    return jax_ref.site_step_ref(*args, semantics, scaling=scaling)


def _port(semantics, scaling, t_args):
    """The port's public site step (plain cell) → numpy."""
    out = ops.site_step(*t_args[:3], t_args[3][:, None], kernels="torch",
                        semantics=semantics, scaling=scaling)
    return [x.numpy() for x in out]


def _assert_same(got, want, prec):
    e_g, s_g, d_g = (np.asarray(x) for x in got)
    e_w, s_w, d_w = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(s_g, s_w)
    assert e_g.shape == e_w.shape and e_g.dtype == e_w.dtype
    np.testing.assert_allclose(e_g, e_w, **TOL[prec])
    np.testing.assert_allclose(d_g, d_w, **TOL[prec])


@pytest.mark.parametrize("n,chi,d", SHAPES)
@pytest.mark.parametrize("scaling", ["none", "per_sample", "global"])
@pytest.mark.parametrize("prec", ["fp64", "fp32"])
@pytest.mark.parametrize("semantics", ["linear", "born"])
def test_site_step_matches_jax(semantics, prec, scaling, n, chi, d):
    env, gamma, lam, u = _operands(semantics, prec, n, chi, d)
    t_args = [torch.from_numpy(a) for a in (env, gamma, lam, u)]
    got = _port(semantics, scaling, t_args)

    xla = (jax_impls.site_step_linear_xla if semantics == "linear"
           else jax_impls.site_step_born_xla)
    want_xla = xla(jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam),
                   jnp.asarray(u)[:, None], scaling=scaling,
                   compute_dtype=None)
    _assert_same(got, want_xla, prec)
    _assert_same(got, _jax_ref(semantics, scaling, env, gamma, lam, u), prec)

    # the port's own oracle, and the CUDA wrapper's CPU branch (its plain
    # version) where the fused kernel takes the scaling mode
    if scaling != "global":
        _assert_same([x.numpy() for x in ref.site_step_ref(
            *t_args, semantics, scaling=scaling)], want_xla, prec)
        wrapper = (site_step.site_step_linear if semantics == "linear"
                   else site_step.site_step_born)
        _assert_same([x.numpy() for x in wrapper(*t_args, scaling=scaling)],
                     want_xla, prec)


@pytest.mark.parametrize("scaling", ["none", "per_sample", "global"])
@pytest.mark.parametrize("prec", ["fp64", "fp32"])
@pytest.mark.parametrize("semantics", ["linear", "born"])
def test_site_step_matches_pallas_interpret(semantics, prec, scaling):
    env, gamma, lam, u = _operands(semantics, prec, *PALLAS_SHAPE)
    got = _port(semantics, scaling,
                [torch.from_numpy(a) for a in (env, gamma, lam, u)])
    _assert_same(got, _pallas(semantics, scaling, env, gamma, lam, u), prec)


def test_wrapper_rejects_global_scaling():
    env, gamma, lam, u = (torch.from_numpy(a)
                          for a in _operands("linear", "fp64", 8, 4, 3))
    for fn in (site_step.site_step_linear, site_step.site_step_born):
        with pytest.raises(ValueError, match="scaling"):
            fn(env, gamma, lam, u, scaling="global")


def test_draw_edge_rows():
    """Zero rows draw uniformly, negative probs clip to 0, and u is compared
    with a strict '>' against the CDF — as draw_from_uniform does."""
    probs = np.array([[0.0, 0.0, 0.0, 0.0],
                      [-1.0, 2.0, 0.0, 2.0],
                      [1.0, 1.0, 1.0, 1.0],
                      [1.0, 1.0, 1.0, 1.0]])
    u = np.array([[0.6], [0.5], [0.25], [0.9999]])
    got = site_step.draw_from_uniform(torch.from_numpy(probs),
                                      torch.from_numpy(u)).numpy()
    want = np.asarray(jax_impls.draw_from_uniform(jnp.asarray(probs),
                                                  jnp.asarray(u)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [2, 1, 0, 3])
