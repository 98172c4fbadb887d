"""The tensor-parallel stages of the port (plain PyTorch on the CPU) against
the JAX package on the same operands: ``contract_measure``, ``measure`` and
``collapse`` against the JAX ``xla`` cells and the Pallas kernels in
interpret mode, and the ``ref.py`` oracles and ``ops`` entry points against
theirs.  Bond shards are ragged: L ≠ R, and N is not a multiple of 8 except
at the one shape the Pallas kernels' blocks need.

Tolerance: ``rtol=1e-12, atol=1e-14`` in fp64 and ``rtol=1e-5, atol=1e-6``
in fp32, atol relative to the largest magnitude — the packages sum in other
orders; under bf16 inputs (``compute_dtype``), within 1e-5 of the largest
magnitude (fp32 sums of the same bf16-exact products).  Samples and zero
rows are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import collapse_select as jax_cs
from repro.kernels import contract_measure as jax_cm
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels import site_impls as jax_impls
from repro.kernels import site_step as jax_ss
from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels import ops, ref, site_impls
from repro_torch.kernels import site_step as SS
from repro_torch.kernels.dispatch import get_site_op

SHAPES = [(16, 8, 24, 3), (37, 13, 29, 5), (9, 40, 6, 4)]   # (N, L, R, d)
PALLAS_SHAPE = (16, 8, 24, 3)          # multiples of the 8-row blocks
TOL = {"fp64": dict(rtol=1e-12, atol=1e-14), "fp32": dict(rtol=1e-5, atol=1e-6)}
REAL = {"fp64": np.float64, "fp32": np.float32}
CPLX = {"fp64": np.complex128, "fp32": np.complex64}


def _operands(prec, n, chi_l, chi_r, d, seed=0, born=False):
    rng = np.random.default_rng(seed)
    if born:
        env = (rng.normal(size=(n, chi_l))
               + 1j * rng.normal(size=(n, chi_l))).astype(CPLX[prec])
        gamma = (rng.normal(size=(chi_l, chi_r, d))
                 + 1j * rng.normal(size=(chi_l, chi_r, d))).astype(CPLX[prec])
    else:
        env = rng.uniform(size=(n, chi_l)).astype(REAL[prec])
        gamma = rng.uniform(size=(chi_l, chi_r, d)).astype(REAL[prec])
    lam = (rng.uniform(size=chi_r) + 0.5).astype(REAL[prec])
    samples = rng.integers(0, d, size=n)
    samples[0] = -1                     # outside [0, d): a zero row
    samples[-1] = d
    return env, gamma, lam, samples.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, prec):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               **TOL[prec])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prec", ["fp64", "fp32"])
@pytest.mark.parametrize("semantics", ["linear", "born"])
def test_contract_measure_matches_xla(semantics, prec, shape):
    env, gamma, lam, _ = _operands(prec, *shape, born=semantics == "born")
    t_w, p_w = jax_impls.contract_measure_xla(
        jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam),
        semantics=semantics, compute_dtype=None)
    t_g, p_g = get_site_op("contract_measure", semantics, "torch")(
        _t(env), _t(gamma), _t(lam), semantics=semantics, compute_dtype=None)
    _close(t_g, t_w, prec)
    _close(p_g, p_w, prec)
    if semantics == "linear":             # the wrapper on the CPU: plain
        before = dict(CM.LAUNCHES)
        t_k, p_k = CM.contract_measure(_t(env), _t(gamma), _t(lam))
        assert CM.LAUNCHES == before
        assert torch.equal(t_k, t_g) and torch.equal(p_k, p_g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prec", ["fp64", "fp32"])
def test_measure_matches_xla(prec, shape):
    n, chi_l, _, d = shape
    env, _, _, _ = _operands(prec, *shape)
    w = np.random.default_rng(1).uniform(size=(chi_l, d)).astype(REAL[prec])
    want = jax_impls.measure_xla(jnp.asarray(env), jnp.asarray(w),
                                 compute_dtype=None)
    got = site_impls.measure_torch(_t(env), _t(w), compute_dtype=None)
    _close(got, want, prec)
    assert torch.equal(SS.measure_probs(_t(env), _t(w)), got)
    # W is built in fp32 and meets an fp64 env by promotion, as in JAX
    w32 = w.astype(np.float32)
    want = jax_impls.measure_xla(jnp.asarray(env), jnp.asarray(w32),
                                 compute_dtype=None)
    got = site_impls.measure_torch(_t(env), _t(w32), compute_dtype=None)
    assert got.numpy().dtype == np.asarray(want).dtype
    _close(got, want, prec)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("prec", ["fp64", "fp32"])
def test_collapse_matches_xla(prec, shape):
    env, gamma, _, samples = _operands(prec, *shape)
    want = jax_impls.collapse_xla(jnp.asarray(env), jnp.asarray(gamma),
                                  jnp.asarray(samples), compute_dtype=None)
    got = site_impls.collapse_torch(_t(env), _t(gamma), _t(samples),
                                    compute_dtype=None)
    _close(got, want, prec)
    assert (got[0] == 0).all() and (got[-1] == 0).all()
    assert torch.equal(CS.collapse_select(_t(env), _t(gamma), _t(samples)),
                       got)
    lam = _operands(prec, *shape)[2]
    _close(CS.measure_weights(_t(gamma), _t(lam)),
           jax_cs.measure_weights(jnp.asarray(gamma), jnp.asarray(lam)), prec)


@pytest.mark.parametrize("prec", ["fp64", "fp32"])
def test_stages_match_pallas_interpret(prec):
    """The Pallas kernels in interpret mode (as the JAX package's tests run
    them on the CPU) at one shape that their 8-row blocks divide."""
    n, chi_l, chi_r, d = PALLAS_SHAPE
    env, gamma, lam, samples = _operands(prec, *PALLAS_SHAPE, seed=3)
    samples = np.clip(samples, 0, d - 1)
    e, g, l_ = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    t_w, p_w = jax_cm.contract_measure(e, g, l_, bn=8, br=8, bl=8,
                                       interpret=True)
    t_g, p_g = CM.contract_measure_plain(_t(env), _t(gamma), _t(lam))
    _close(t_g, t_w, prec)
    _close(p_g, p_w, prec)
    w = np.asarray(jax_cs.measure_weights(g, l_))
    want = jax_ss.measure_probs(e, jnp.asarray(w), bn=8, bl=8,
                                interpret=True)
    _close(SS.measure_first_plain(_t(env), _t(w)), want, prec)
    want = jax_cs.collapse_select(e, g, jnp.asarray(samples), bn=8, br=8,
                                  bl=8, interpret=True)
    _close(CS.collapse_select_plain(_t(env), _t(gamma), _t(samples)), want,
           prec)


@pytest.mark.parametrize("prec", ["fp64", "fp32"])
def test_oracles_and_ops_match_jax(prec):
    n, chi_l, chi_r, d = SHAPES[1]
    env, gamma, lam, samples = _operands(prec, *SHAPES[1], seed=5)
    valid = np.clip(samples, 0, d - 1)
    e, g, l_ = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    t_w, p_w = jax_ref.contract_measure_ref(e, g, l_)
    t_g, p_g = ref.contract_measure_ref(_t(env), _t(gamma), _t(lam))
    _close(t_g, t_w, prec)
    _close(p_g, p_w, prec)
    _close(ref.collapse_rescale_ref(t_g, _t(valid)),
           jax_ref.collapse_rescale_ref(t_w, jnp.asarray(valid)), prec)
    _close(ref.collapse_select_ref(_t(env), _t(gamma), _t(valid)),
           jax_ref.collapse_select_ref(e, g, jnp.asarray(valid)), prec)
    _close(ref.measure_first_probs_ref(_t(env), _t(gamma), _t(lam)),
           jax_ref.measure_first_probs_ref(e, g, l_), prec)
    # the ops entry points route to the plain cells on the CPU
    t_o, p_o = ops.contract_measure(_t(env), _t(gamma), _t(lam))
    t_j, p_j = jax_ops.contract_measure(e, g, l_, kernels="xla")
    _close(t_o, t_j, prec)
    _close(p_o, p_j, prec)
    _close(ops.collapse_rescale(_t(env), _t(gamma), _t(samples)),
           jax_ops.collapse_rescale(e, g, jnp.asarray(samples),
                                    kernels="xla"), prec)
    with pytest.raises(ValueError, match="cuda"):
        ops.contract_measure(_t(env), _t(gamma), _t(lam), kernels="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.collapse_rescale(_t(env), _t(gamma), _t(samples), kernels="cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gamma_dtype", ["fp32", "bf16", "fp64"])
def test_bf16_stages_on_bond_shards_match_xla(gamma_dtype, shape):
    """The three TP stages under ``compute_dtype=bf16`` on ragged shards:
    an fp32 env beside an fp32 Γ (mxu_bf16) or a bf16 Γ (store_bf16), or
    an fp64 env and Γ; the stage output dtypes are the JAX cells'."""
    prec = "fp64" if gamma_dtype == "fp64" else "fp32"
    env, gamma, lam, samples = _operands(prec, *shape, seed=7)
    w = np.random.default_rng(2).uniform(size=(shape[1], shape[3])).astype(
        np.float32)
    e, g, l_ = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    te, tg = _t(env), _t(gamma)
    if gamma_dtype == "bf16":
        g = g.astype(jnp.bfloat16)
        tg = tg.to(torch.bfloat16)
    bf, tbf = jnp.bfloat16, torch.bfloat16
    pairs = [
        (get_site_op("contract_measure", "linear", "torch")(
            te, tg, _t(lam), semantics="linear", compute_dtype=tbf),
         jax_impls.contract_measure_xla(e, g, l_, semantics="linear",
                                        compute_dtype=bf)),
        ((site_impls.measure_torch(te, _t(w), compute_dtype=tbf),),
         (jax_impls.measure_xla(e, jnp.asarray(w), compute_dtype=bf),)),
        ((site_impls.collapse_torch(te, tg, _t(samples),
                                    compute_dtype=tbf),),
         (jax_impls.collapse_xla(e, g, jnp.asarray(samples),
                                 compute_dtype=bf),))]
    for gots, wants in pairs:
        for got, want in zip(gots, wants):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.double().numpy() / scale,
                                       want.astype(np.float64) / scale,
                                       rtol=0, atol=1e-5)
