"""The slice as a whole: the port's ``SamplingSession`` (plain PyTorch cells
on the CPU) against the JAX package's ``SamplingSession(scheme="seq",
kernels="xla")`` on the same chains (``tests/conftest.py`` fixtures carried
across through ``repro_torch.convert``) and the same seeds.

Samples must be equal; ``log_scale`` and the per-site stats agree to
``rtol=1e-12`` (the contraction is summed in another order).
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import api as jax_api
from repro.core import mps as jax_mps_oracles
from repro.core import sampler as jax_sampler
from repro.runtime.elastic import WorkQueue as JaxWorkQueue
from repro_torch import api
from repro_torch.convert import mps_from_arrays
from repro_torch.core import mps as M
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.runtime.elastic import WorkQueue

FIXTURES = ["linear_mps_small", "linear_mps_10x6", "born_mps_6x4"]
SEEDS = [0, 1, 7]
N = 48


def _port(jax_mps):
    return mps_from_arrays(np.asarray(jax_mps.gammas),
                           np.asarray(jax_mps.lambdas), jax_mps.semantics,
                           device="cpu")


def _jax_session(jax_mps, **kw):
    return jax_api.SamplingSession(
        jax_mps, jax_api.SamplerConfig(scheme="seq", kernels="xla", **kw))


def _session(mps, **kw):
    return api.SamplingSession(
        mps, api.SamplerConfig(scheme="seq", kernels="torch", **kw),
        device="cpu")


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("seed", SEEDS)
def test_session_sample_matches_jax(request, fixture, seed):
    jax_mps = request.getfixturevalue(fixture)
    with _jax_session(jax_mps) as js:
        want = js.sample(N, jax.random.key(seed))
    with _session(_port(jax_mps)) as s:
        got = s.sample(N, prng.key(seed))
    assert got.shape == want.shape == (N, jax_mps.n_sites)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_sample_chain_log_scale_and_stats(request, fixture):
    jax_mps = request.getfixturevalue(fixture)
    key = jax.random.key(3)
    jcfg = jax_sampler.SamplerConfig(semantics=jax_mps.semantics,
                                     kernels="xla")
    want = jax_sampler.sample_chain(
        jax_mps, jax_sampler.init_state(jax_mps, N, key, jcfg), jcfg)
    mps = _port(jax_mps)
    cfg = S.SamplerConfig(semantics=mps.semantics, kernels="torch")
    got = S.sample_chain(mps, S.init_state(mps, N, prng.key(3), cfg), cfg)
    np.testing.assert_array_equal(got.samples.numpy(),
                                  np.asarray(want.samples))
    np.testing.assert_allclose(got.state.log_scale.numpy(),
                               np.asarray(want.state.log_scale), rtol=1e-12)
    np.testing.assert_allclose(got.state.env.numpy(),
                               np.asarray(want.state.env), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(got.site_stats.numpy(),
                               np.asarray(want.site_stats), rtol=1e-12)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_micro_batch_matches_jax(request, fixture):
    jax_mps = request.getfixturevalue(fixture)
    with _jax_session(jax_mps, micro_batch=16) as js:
        want = js.sample(N, jax.random.key(1))
    with _session(_port(jax_mps), micro_batch=16) as s:
        got = s.sample(N, prng.key(1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_resume_from_site_3_is_the_uninterrupted_walk(request, fixture):
    mps = _port(request.getfixturevalue(fixture))
    cfg = S.SamplerConfig(semantics=mps.semantics, kernels="torch")
    key = prng.key(7)
    full = S.sample_chain(mps, S.init_state(mps, N, key, cfg), cfg)
    head = S.sample_chain(type(mps)(mps.gammas[:3], mps.lambdas[:3],
                                    mps.semantics),
                          S.init_state(mps, N, key, cfg), cfg)
    tail = S.sample_resumable(mps, head.state, 3, cfg)
    np.testing.assert_array_equal(
        np.concatenate([head.samples.numpy(), tail.samples.numpy()]),
        full.samples.numpy())
    np.testing.assert_array_equal(tail.state.log_scale.numpy(),
                                  full.state.log_scale.numpy())


def test_random_builders_structure():
    """The port's builders keep the JAX builders' invariants: stochastic
    linear rows, right-canonical Born sites, a vacuum boost at the edges."""
    lin = M.random_linear_mps(prng.key(0), 3, 5, 2, device="cpu")
    np.testing.assert_allclose(lin.gammas.sum(dim=(2, 3)).numpy(), 1.0,
                               rtol=1e-12)
    assert (lin.lambdas >= 1).all() and (lin.lambdas < 2).all()
    born = M.random_born_mps(prng.key(0), 3, 5, 2, device="cpu")
    for g in born.gammas:
        a = g.reshape(5, 10)
        np.testing.assert_allclose((a @ a.conj().T).numpy(), np.eye(5),
                                   atol=1e-12)
    gbs = M.gbs_like_mps(prng.key(1), 5, 4, 3, device="cpu")
    np.testing.assert_allclose(gbs.gammas.sum(dim=(2, 3)).numpy(), 1.0,
                               rtol=1e-12)
    vacuum = gbs.gammas[..., 0].sum(dim=(1, 2))
    assert vacuum[0] > vacuum[2] and vacuum[4] > vacuum[2]


@pytest.mark.parametrize("fixture", ["linear_mps_small", "born_mps_6x4"])
def test_exact_oracles_match_jax(request, fixture):
    jax_mps = request.getfixturevalue(fixture)
    mps = _port(jax_mps)
    np.testing.assert_allclose(M.enumerate_probabilities(mps),
                               jax_mps_oracles.enumerate_probabilities(jax_mps),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(M.exact_site_marginals(mps),
                               jax_mps_oracles.exact_site_marginals(jax_mps),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_run_queue_matches_jax(request, fixture):
    jax_mps = request.getfixturevalue(fixture)
    with _jax_session(jax_mps) as js:
        want = js.run_queue(JaxWorkQueue(3), 16, jax.random.key(5))
    with _session(_port(jax_mps)) as s:
        got = s.run_queue(WorkQueue(3), 16, prng.key(5))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for b in range(3):
        np.testing.assert_array_equal(got[b], want[b])
