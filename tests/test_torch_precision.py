"""The bf16 precision tiers of the linear walk (``mxu_bf16``: bf16 GEMM
inputs, fp32 sums on an fp32 chain; ``store_bf16``: the same on a Γ stored
in bf16) against the JAX package's xla cells and, where they take the mode,
its Pallas kernels in interpret mode; the chain builders, conversions and
guards that come with them.

Output dtypes, per stage, of the JAX package's xla cells under each
environment/Γ pair and ``compute_dtype`` (Λ is fp32 beside an fp32 or bf16
Γ and fp64 beside an fp64 one; W, the measure-first operator, is fp32).
The port is held to the same table (``TABLE`` below):

    ======================  ===========  ===========  ===========
    env + Γ                 fp32 + fp32  fp32 + bf16  fp64 + fp64
    compute_dtype           None  bf16   None  bf16   None  bf16
    ======================  ====  =====  ====  =====  ====  =====
    contract temp           fp32  fp32   fp32  fp32   fp64  fp64
    seq probs, uniforms     fp32  fp32   fp32  fp32   fp64  fp64
    site_step env', dlog    fp32  fp32   fp32  fp32   fp64  fp64
    TP contract_measure     fp32  fp32   fp32  fp32   fp64  fp64
    measure (env·W)         fp32  fp32   fp32  fp32   fp64  fp32
    collapse env'           fp32  fp32   fp32  fp32   fp64  fp32
    ======================  ====  =====  ====  =====  ====  =====

With bf16 inputs the fp64 environment is rounded through fp32, as torch and
XLA round it; the fp32 sums are cast back to fp64 where the table says
fp64.  (The JAX package's Pallas site step sums that corner in fp64; the
port follows its xla cell.)

Tolerances: samples identical; under bf16 inputs, temp, probs and env'
within 1e-5 of each row's largest |value| and ``log_scale``/dlog within
1e-5 (both packages sum the same bf16-exact products in fp32, in other
orders); without, fp32 within 1e-5 and fp64 within 1e-12 of the row's
largest |value|.  The Born builder draws the JAX package's uniforms bit
for bit, but erfinv and LAPACK's QR round otherwise than XLA's: Γ within
1e-13 (complex128) and 1e-5 (complex64) of the JAX chain's, whose entries
are at most 1 in magnitude.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import api as jax_api
from repro.core import mps as JM
from repro.core import precision as jax_precision
from repro.core import sampler as jax_sampler
from repro.kernels import collapse_select as jax_cs
from repro.kernels import contract_measure as jax_cm
from repro.kernels import site_impls as jax_impls
from repro.kernels import site_step as jax_ss
from repro_torch import api, convert
from repro_torch.core import mps as M
from repro_torch.core import precision, prng
from repro_torch.core import sampler as S
from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels import ref, site_impls
from repro_torch.kernels import site_step as SS
from repro_torch.kernels.dispatch import get_site_op

BF16_TOL = 1e-5
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
PAIRS = {"fp32+fp32": ("float32", "float32"),
         "fp32+bf16": ("float32", "bfloat16"),
         "fp64+fp64": ("float64", "float64")}
COMPUTE = {"none": None, "bf16": "bfloat16"}
# (stage → dtype) per (pair, compute): the module docstring's table
_F32, _F64 = "float32", "float64"
TABLE = {}
for _pair, (_env, _g) in PAIRS.items():
    for _c in COMPUTE:
        _wide = _F64 if _env == _F64 else _F32
        _meas = _F32 if _c == "bf16" else _wide
        TABLE[_pair, _c] = {"temp": _wide, "probs": _wide, "env": _wide,
                            "dlog": _wide, "cm_temp": _wide,
                            "cm_probs": _wide, "measure": _meas,
                            "collapse": _meas}
SHAPES = [(16, 8, 8, 3), (37, 13, 13, 5), (24, 40, 40, 4)]   # (N, L, R, d)


def _jdt(name):
    return None if name is None else getattr(jnp, name)


def _tdt(name):
    return None if name is None else getattr(torch, name)


def _operands(pair, n, chi_l, chi_r, d, seed=0):
    """numpy env, Γ (bf16 as ml_dtypes), Λ, W, samples and u for one pair."""
    env_t, g_t = PAIRS[pair]
    rng = np.random.default_rng(seed)
    env = rng.uniform(size=(n, chi_l)).astype(env_t)
    gamma = rng.uniform(size=(chi_l, chi_r, d)).astype(
        np.float32 if g_t == "bfloat16" else g_t)
    if g_t == "bfloat16":
        gamma = gamma.astype(ml_dtypes.bfloat16)
    lam = (rng.uniform(size=chi_r) + 0.5).astype(env_t)
    w = rng.uniform(size=(chi_l, d)).astype(np.float32)
    samples = rng.integers(0, d, size=n).astype(np.int32)
    samples[0], samples[-1] = -1, d       # outside [0, d): zero rows
    return env, gamma, lam, w, samples, rng.uniform(size=n)


def _t(a):
    return convert.tensor_from_array(a, "cpu")


def _close_rows(got, want, tol):
    """|got − want| within tol of each row's largest |want| (first axis)."""
    got, want = got.double().numpy(), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).reshape(len(want), -1).max(axis=1)
    scale = scale.reshape((-1,) + (1,) * (want.ndim - 1))
    assert (np.abs(got - want) <= tol * scale).all(), \
        np.abs(got - want).max()


def _stage_outputs(pair, compute, shape, seed=0):
    """{stage: (port tensor, reference array)} for one cell."""
    env, gamma, lam, w, samples, u = _operands(pair, *shape, seed=seed)
    jc, tc = _jdt(COMPUTE[compute]), _tdt(COMPUTE[compute])
    je, jg, jl = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    te, tg, tl = _t(env), _t(gamma), _t(lam)
    out = {}
    u_dt = jax_impls.site_probs_dtype(je, jg, jl, "linear", jc)
    assert str(site_impls.site_probs_dtype(te, tg, tl, "linear", tc)
               ).split(".")[1] == jnp.dtype(u_dt).name
    uu = u.astype(u_dt)[:, None]
    je2, js, jd = jax_impls.site_step_linear_xla(
        je, jg, jl, jnp.asarray(uu), scaling="per_sample", compute_dtype=jc)
    te2, ts, td = get_site_op("site_step", "linear", "torch")(
        te, tg, tl, _t(uu), scaling="per_sample", compute_dtype=tc)
    out.update(env=(te2, je2), dlog=(td, jd), samples=(ts, js))
    out["temp"] = (SS.contract_plain(te, tg, tc),
                   jax_impls._contract_site(je, jg, jc, "linear"))
    out["probs"] = (SS.linear_probs_plain(out["temp"][0], tl),
                    jax_impls.measure_probs_xla(out["temp"][1], jl, "linear"))
    jt, jp = jax_impls.contract_measure_xla(je, jg, jl, semantics="linear",
                                            compute_dtype=jc)
    tt, tp = get_site_op("contract_measure", "linear", "torch")(
        te, tg, tl, semantics="linear", compute_dtype=tc)
    out.update(cm_temp=(tt, jt), cm_probs=(tp, jp))
    out["measure"] = (
        get_site_op("measure", "linear", "torch")(te, _t(w),
                                                   compute_dtype=tc),
        jax_impls.measure_xla(je, jnp.asarray(w), compute_dtype=jc))
    out["collapse"] = (
        get_site_op("collapse", "linear", "torch")(te, tg, _t(samples),
                                                    compute_dtype=tc),
        jax_impls.collapse_xla(je, jg, jnp.asarray(samples),
                               compute_dtype=jc))
    return out


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_stage_dtypes_follow_the_table(pair, compute):
    for stage, (got, want) in _stage_outputs(pair, compute,
                                             SHAPES[0]).items():
        if stage == "samples":
            continue
        assert jnp.dtype(want.dtype).name == TABLE[pair, compute][stage], \
            stage
        assert str(got.dtype).split(".")[1] == TABLE[pair, compute][stage], \
            stage


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_stages_match_xla(pair, compute, shape):
    outs = _stage_outputs(pair, compute, shape, seed=sum(shape))
    env_t = PAIRS[pair][0]
    tol = BF16_TOL if compute == "bf16" else TOL[_tdt(env_t)]
    for stage, (got, want) in outs.items():
        if stage == "samples":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        elif stage == "dlog":
            np.testing.assert_allclose(got.double().numpy(),
                                       np.asarray(want, dtype=np.float64),
                                       rtol=0, atol=tol)
        else:
            _close_rows(got, want, tol)
    collapse = outs["collapse"][0]
    assert (collapse[0] == 0).all() and (collapse[-1] == 0).all()


@pytest.mark.parametrize("pair", ["fp32+fp32", "fp32+bf16"])
def test_stages_match_pallas_interpret(pair):
    """The JAX package's Pallas kernels in interpret mode under bf16
    inputs, at a shape their 8-row blocks divide: the site step with
    ``compute_dtype``, and contract_measure, measure_probs and
    collapse_select on pre-cast bf16 operands, as its pallas cells call
    them."""
    n, chi_l, chi_r, d = 16, 8, 8, 3
    env, gamma, lam, w, samples, u = _operands(pair, n, chi_l, chi_r, d,
                                               seed=11)
    samples = np.clip(samples, 0, d - 1)
    bf = jnp.bfloat16
    je, jg, jl = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    te, tg, tl = _t(env), _t(gamma), _t(lam)
    u32 = u.astype(np.float32)
    je2, js, jd = jax_ss.site_step_linear(je, jg, jl, jnp.asarray(u32),
                                          bn=8, br=8, bl=8,
                                          compute_dtype=bf, interpret=True)
    te2, ts, td = SS.site_step_linear(te, tg, tl, _t(u32),
                                      compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close_rows(te2, je2, BF16_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=BF16_TOL)
    jt, jp = jax_cm.contract_measure(je.astype(bf), jg.astype(bf), jl,
                                     bn=8, br=8, bl=8, interpret=True)
    tt, tp = CM.contract_measure(te, tg, tl, torch.bfloat16)
    _close_rows(tt, jt, BF16_TOL)
    _close_rows(tp, jp, BF16_TOL)
    want = jax_ss.measure_probs(je, jnp.asarray(w), bn=8, bl=8,
                                compute_dtype=bf, interpret=True)
    _close_rows(SS.measure_probs(te, _t(w), torch.bfloat16), want, BF16_TOL)
    want = jax_cs.collapse_select(je.astype(bf), jg.astype(bf),
                                  jnp.asarray(samples), bn=8, br=8, bl=8,
                                  interpret=True)
    _close_rows(CS.collapse_select(te, tg, _t(samples), torch.bfloat16),
                want, BF16_TOL)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bf16_oracles_match_xla(pair):
    """The port's ``kernels/ref.py`` oracles under bf16 inputs against the
    JAX package's xla cells (the contraction, its measurement, the
    measure-first probs, the collapse and the whole site step)."""
    env, gamma, lam, _, samples, u = _operands(pair, 24, 40, 40, 4, seed=9)
    valid = np.clip(samples, 0, 3)
    bf, tbf = jnp.bfloat16, torch.bfloat16
    je, jg, jl = jnp.asarray(env), jnp.asarray(gamma), jnp.asarray(lam)
    te, tg, tl = _t(env), _t(gamma), _t(lam)
    jt, jp = jax_impls.contract_measure_xla(je, jg, jl, semantics="linear",
                                            compute_dtype=bf)
    tt, tp = ref.contract_measure_ref(te, tg, tl, tbf)
    _close_rows(tt, jt, BF16_TOL)
    _close_rows(tp, jp, BF16_TOL)
    w = jnp.einsum("lrs,r->ls", jg.astype(jnp.float32), jl.astype(jnp.float32))
    _close_rows(ref.measure_first_probs_ref(te, tg, tl, tbf),
                jax_impls.measure_xla(je, w, compute_dtype=bf), BF16_TOL)
    _close_rows(ref.collapse_select_ref(te, tg, _t(valid), tbf),
                jax_impls.collapse_xla(je, jg, jnp.asarray(valid),
                                       compute_dtype=bf), BF16_TOL)
    uu = u.astype(env.dtype)
    je2, js, jd = jax_impls.site_step_linear_xla(
        je, jg, jl, jnp.asarray(uu)[:, None], scaling="per_sample",
        compute_dtype=bf)
    te2, ts, td = ref.site_step_ref(te, tg, tl, _t(uu),
                                    compute_dtype=tbf)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close_rows(te2, je2, BF16_TOL)
    np.testing.assert_allclose(td.double().numpy(),
                               np.asarray(jd, np.float64), rtol=0,
                               atol=BF16_TOL)


# ---------------------------------------------------------------------------
# Whole walks through the session (seq) and the core sampler
# ---------------------------------------------------------------------------

def _chains(tier, seed=0, shape=(6, 8, 3)):
    """(JAX chain, port chain) of one tier, built in fp64 by the JAX
    builder and cast as the tier stores it (Γ bf16 and Λ fp32 for
    store_bf16)."""
    base = JM.gbs_like_mps(jax.random.key(seed), *shape)
    storage = precision.POLICIES[tier][0]
    if tier == "store_bf16":
        jm = JM.MPS(base.gammas.astype(jnp.bfloat16),
                    base.lambdas.astype(jnp.float32), "linear")
    else:
        jm = base.astype(getattr(jnp, str(storage).split(".")[1]))
    pm = convert.mps_from_arrays(np.asarray(jm.gammas),
                                 np.asarray(jm.lambdas), device="cpu")
    return jm, pm


TIERS = {"mxu_bf16": torch.bfloat16, "store_bf16": torch.bfloat16,
         "fp64_bf16_inputs": torch.bfloat16}


def _tier_chains(tier, seed=0, shape=(6, 8, 3)):
    if tier == "fp64_bf16_inputs":
        jm = JM.gbs_like_mps(jax.random.key(seed), *shape)
        return jm, convert.mps_from_arrays(np.asarray(jm.gammas),
                                           np.asarray(jm.lambdas),
                                           device="cpu")
    return _chains(tier, seed, shape)


@pytest.mark.parametrize("micro", [None, 16])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("tier", list(TIERS))
def test_session_seq_walk_matches_jax(tier, seed, micro):
    """``SamplingSession(compute_dtype=bf16)`` draws the JAX session's
    samples (scheme seq, its xla cells), whole and micro-batched."""
    jm, pm = _tier_chains(tier, seed)
    n = 48
    jcfg = jax_api.SamplerConfig(scheme="seq", kernels="xla",
                                 compute_dtype=jnp.bfloat16,
                                 micro_batch=micro)
    with jax_api.SamplingSession(jm, jcfg) as js:
        want = js.sample(n, jax.random.key(seed + 1))
    cfg = api.SamplerConfig(scheme="seq", kernels="torch",
                            compute_dtype=TIERS[tier], micro_batch=micro)
    with api.SamplingSession(pm, cfg, device="cpu") as s:
        got = s.sample(n, prng.key(seed + 1))
    assert got.shape == want.shape == (n, jm.n_sites)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("tier", list(TIERS))
def test_walk_log_scale_and_env_match_jax(tier):
    jm, pm = _tier_chains(tier, 3, (8, 16, 4))
    n = 64
    jcfg = jax_sampler.SamplerConfig(kernels="xla",
                                     compute_dtype=jnp.bfloat16)
    want = jax_sampler.sample_chain(
        jm, jax_sampler.init_state(jm, n, jax.random.key(4), jcfg), jcfg)
    cfg = S.SamplerConfig(kernels="torch", compute_dtype=torch.bfloat16)
    got = S.sample_chain(pm, S.init_state(pm, n, prng.key(4), cfg), cfg)
    np.testing.assert_array_equal(got.samples.numpy(),
                                  np.asarray(want.samples))
    assert str(got.state.env.dtype).split(".")[1] == \
        jnp.dtype(want.state.env.dtype).name
    np.testing.assert_allclose(got.state.log_scale.double().numpy(),
                               np.asarray(want.state.log_scale, np.float64),
                               rtol=0, atol=BF16_TOL)
    _close_rows(got.state.env, want.state.env, BF16_TOL)


def test_pallas_site_step_walk_matches_port():
    """The JAX package's Pallas site step (interpret mode) on the mxu_bf16
    chain draws the port's samples."""
    jm, pm = _chains("mxu_bf16", 2, (4, 8, 3))
    jcfg = jax_sampler.SamplerConfig(kernels="pallas",
                                     compute_dtype=jnp.bfloat16)
    want = jax_sampler.sample_chain(
        jm, jax_sampler.init_state(jm, 16, jax.random.key(9), jcfg), jcfg)
    cfg = S.SamplerConfig(kernels="torch", compute_dtype=torch.bfloat16)
    got = S.sample_chain(pm, S.init_state(pm, 16, prng.key(9), cfg), cfg)
    np.testing.assert_array_equal(got.samples.numpy(),
                                  np.asarray(want.samples))


# ---------------------------------------------------------------------------
# Born chains: compute_dtype applies to linear only
# ---------------------------------------------------------------------------

def test_born_seq_ignores_compute_dtype(born_mps_6x4):
    pm = convert.mps_from_arrays(np.asarray(born_mps_6x4.gammas),
                                 np.asarray(born_mps_6x4.lambdas), "born",
                                 device="cpu")
    jcfg = jax_api.SamplerConfig(scheme="seq", kernels="xla",
                                 compute_dtype=jnp.bfloat16)
    with jax_api.SamplingSession(born_mps_6x4, jcfg) as js:
        want = js.sample(32, jax.random.key(2))
    outs = []
    for compute in (None, torch.bfloat16):
        cfg = api.SamplerConfig(scheme="seq", kernels="torch",
                                compute_dtype=compute)
        with api.SamplingSession(pm, cfg, device="cpu") as s:
            outs.append(s.sample(32, prng.key(2)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], np.asarray(want))


def _mesh(p1, p2):
    return SimpleNamespace(shape={"data": p1, "model": p2},
                           axis_names=("data", "model"),
                           device=torch.device("cpu"))


@pytest.mark.parametrize("scheme", ["tp_single", "tp_double"])
def test_born_tp_with_compute_dtype_raises(scheme):
    """The JAX package casts a complex env to bf16 here, dropping its
    imaginary part; the port refuses, at plan time and in the stage."""
    born = M.random_born_mps(prng.key(0), 4, 4, 2, device="cpu")
    cfg = api.SamplerConfig(scheme=scheme, compute_dtype=torch.bfloat16)
    session = api.SamplingSession(born, cfg, device="cpu", mesh=_mesh(1, 2))
    with pytest.raises(ValueError, match="imaginary"):
        session.plan(8)
    env = torch.ones((3, 4), dtype=torch.complex128)
    with pytest.raises(ValueError, match="imaginary"):
        site_impls.contract_parallel(env, born.gammas[0], torch.bfloat16)


@pytest.mark.parametrize("compute", [torch.float16, torch.float32])
def test_compute_dtypes_other_than_bf16_raise(compute):
    session = api.SamplingSession(M.random_linear_mps(prng.key(0), 3, 4, 2,
                                                      device="cpu"),
                                  api.SamplerConfig(compute_dtype=compute),
                                  device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        session.plan(8)
    with pytest.raises(ValueError, match="compute_dtype"):
        SS.site_step_linear(torch.ones(2, 3), torch.ones(3, 3, 2),
                            torch.ones(3), torch.zeros(2),
                            compute_dtype=compute)


def test_wrappers_on_the_cpu_take_the_plain_bf16_versions():
    env, gamma, lam, w, samples, u = _operands("fp32+bf16", 9, 6, 6, 3)
    te, tg, tl = _t(env), _t(gamma), _t(lam)
    before = {**SS.LAUNCHES, **CM.LAUNCHES, **CS.LAUNCHES}
    bf = torch.bfloat16
    got = SS.site_step_linear(te, tg, tl, _t(u.astype(np.float32)),
                              compute_dtype=bf)
    want = SS.site_step_linear_plain(te, tg, tl, _t(u.astype(np.float32)),
                                     compute_dtype=bf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(CM.contract_measure(te, tg, tl, bf)[0],
                       CM.contract_measure_plain(te, tg, tl, bf)[0])
    assert torch.equal(CS.collapse_select(te, tg, _t(samples), bf),
                       CS.collapse_select_plain(te, tg, _t(samples), bf))
    assert torch.equal(SS.measure_probs(te, _t(w), bf),
                       SS.measure_first_plain(te, _t(w), bf))
    assert {**SS.LAUNCHES, **CM.LAUNCHES, **CS.LAUNCHES} == before


# ---------------------------------------------------------------------------
# Policies, rounding, conversion, builders
# ---------------------------------------------------------------------------

def test_policies_are_the_jax_packages():
    assert list(precision.POLICIES) == list(jax_precision.POLICIES)
    for name, dts in precision.POLICIES.items():
        want = tuple(jnp.dtype(d).name for d in jax_precision.POLICIES[name])
        assert tuple(str(d).split(".")[1] for d in dts) == want


@pytest.mark.parametrize("policy", ["fp64", "fp32", "mxu_bf16",
                                    "store_bf16"])
def test_gemm_matches_jax(policy):
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(7, 33)), rng.normal(size=(33, 5))
    want = jax_precision.gemm(jnp.asarray(a), jnp.asarray(b), policy)
    got = precision.gemm(torch.from_numpy(a), torch.from_numpy(b), policy)
    assert str(got.dtype).split(".")[1] == jnp.dtype(want.dtype).name
    _close_rows(got, want, 1e-12 if policy == "fp64" else 1e-6)


def test_fp64_rounds_to_bf16_through_fp32():
    """1 + 2⁻⁸ + 2⁻⁴⁰ is a tie once rounded to fp32 and goes to 1.0 (even);
    rounded in one step it would be 1.0078125.  torch and XLA both round
    through fp32, and so does the port (the kernels too)."""
    x = np.array([1 + 2 ** -8 + 2 ** -40, -(1 + 2 ** -8 + 2 ** -40)])
    got = precision.rounded(torch.from_numpy(x), torch.bfloat16)
    want = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1.0, -1.0]


def test_bf16_chain_converts_both_ways():
    jm, pm = _chains("store_bf16", 1, (3, 5, 2))
    bits = np.asarray(jm.gammas).view(np.uint16)
    assert pm.gammas.dtype == torch.bfloat16
    assert pm.lambdas.dtype == torch.float32
    from_bits = convert.mps_from_arrays(bits, np.asarray(jm.lambdas),
                                        device="cpu",
                                        gammas_view_as=torch.bfloat16)
    assert torch.equal(from_bits.gammas, pm.gammas)
    g, lam = (convert.array_from_tensor(t) for t in (pm.gammas, pm.lambdas))
    np.testing.assert_array_equal(g, bits)
    back = jnp.asarray(g.view(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16), bits)
    np.testing.assert_array_equal(lam, np.asarray(jm.lambdas))
    with pytest.raises(ValueError, match="uint16"):
        convert.tensor_from_array(np.zeros(3, np.float32), "cpu",
                                  view_as=torch.bfloat16)


def test_cast_to_bf16_keeps_lambda_fp32():
    m = M.random_linear_mps(prng.key(0), 3, 4, 2, device="cpu")
    half = m.to(dtype=torch.bfloat16)
    assert half.gammas.dtype == torch.bfloat16
    assert half.lambdas.dtype == torch.float32
    assert torch.equal(half.lambdas, m.lambdas.to(torch.float32))
    assert torch.equal(half.gammas, m.gammas.to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(4, 8, 2), (3, 16, 3)])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_born_builder_matches_jax(dtype, shape):
    want = JM.random_born_mps(jax.random.key(2), *shape,
                              dtype=getattr(jnp, dtype))
    got = M.random_born_mps(prng.key(2), *shape, dtype=getattr(torch, dtype),
                            device="cpu")
    tol = 1e-13 if dtype == "complex128" else 1e-5
    np.testing.assert_allclose(got.gammas.numpy(), np.asarray(want.gammas),
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(got.lambdas.numpy(),
                                  np.asarray(want.lambdas))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_uniform_range_and_normal_match_jax(dtype):
    key = jax.random.key(11)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype))
    want = jax.random.uniform(key, (3000,), getattr(jnp, dtype), lo, 1.0)
    got = prng.uniform(prng.key(11), (3000,), getattr(torch, dtype),
                       minval=float(lo), maxval=1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.random.normal(key, (3000,), getattr(jnp, dtype))
    got = prng.normal(prng.key(11), (3000,), getattr(torch, dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12 if dtype == "float64" else 1e-5,
                               atol=1e-12 if dtype == "float64" else 1e-5)
