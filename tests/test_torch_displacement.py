"""The port's displacement operator (paper §3.4.1) against the JAX package:
each function of ``core/displacement.py``, the plain version of the
``displacement_expm`` kernel against the reference's Pallas kernel in
interpret mode and its oracle, μ = 0, the cached coefficient tables, the
kernel's sums (real polynomials in −|μ|² from ``horner_table``, evaluated
here as the CUDA kernel does), and the ``ops`` entry point (the complex
entry's plain version) against the reference's.

Tolerances.  The factors and tables: ``rtol=1e-12`` (the packages build
μ^m otherwise: repeated products here, a complex power there).  D(μ) is a
sum of terms up to ~500 times larger than the result at d = 16 (they
cancel in the truncation corner), so in fp64 its differences are bounded
by ``1e-12`` times the summed magnitudes ``e^{−|μ|²/2}·(|L|@|U|)``
elementwise; in fp32 by ``atol=3e-5·d`` (the reference test's bound for its
fp32 kernel against the fp64 oracle).  ``displacement_exact`` is held at
``rtol=1e-12`` against ``scipy.linalg.expm`` and at ``atol=1e-9`` against
the reference, whose ``jax.scipy.linalg.expm`` differs from both by up to
2.8e-10 on these draws at d = 16 (against 40-digit mpmath at |μ| ≈ 1.2–1.9:
the reference off by up to 1.1e-11, torch's ``matrix_exp`` and scipy's
within 2e-15).
"""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
torch = pytest.importorskip("torch")

from repro.core import displacement as jax_D
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.displacement_expm import _coeff_table as jax_coeff_table
from repro.kernels.displacement_expm import displacement_expm as jax_kernel
from repro_torch.core import displacement as D
from repro_torch.kernels import displacement_expm as DE
from repro_torch.kernels import ops, ref

DS = [3, 4, 8, 16]


def _mu(n, scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    mu = scale * rng.normal(size=n) + 1j * scale * rng.normal(size=n)
    mu[0] = 0.0
    return mu.astype(np.complex128)


def _summed(mu, d):
    """e^{−|μ|²/2}·(|L| @ |U|): the magnitudes each entry of D(μ) sums."""
    t = torch.from_numpy(np.asarray(mu, np.complex128))
    lower = D.exp_mu_adag(t, d).abs()
    upper = D.exp_neg_mustar_a(t, d).abs()
    pref = torch.exp(-0.5 * t.abs() ** 2)[:, None, None]
    return (pref * (lower @ upper)).numpy()


def _close_summed(got, want, mu, d, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.abs(got - np.asarray(want))
    bound = rtol * _summed(mu, d)
    assert np.all(err <= bound), float((err - bound).max())


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14 * scale)


@pytest.mark.parametrize("d", DS)
def test_ladder_ops_and_coefficients(d):
    a, adag = D.ladder_ops(d)
    ja, jadag = jax_D.ladder_ops(d)
    _close(a, ja)
    _close(adag, jadag)
    m, c = D._tri_factor_log_coeffs(d, torch.float64)
    jm, jc = jax_D._tri_factor_log_coeffs(d, jnp.float64)
    _close(m, jm)
    _close(c, jc)
    _close(DE.coeff_table(d), jc)


@pytest.mark.parametrize("d", DS)
def test_triangular_factors(d):
    mu = _mu(32, seed=d)
    _close(D.exp_mu_adag(torch.from_numpy(mu), d),
           jax_D.exp_mu_adag(jnp.asarray(mu), d))
    _close(D.exp_neg_mustar_a(torch.from_numpy(mu), d),
           jax_D.exp_neg_mustar_a(jnp.asarray(mu), d))


@pytest.mark.parametrize("correction", [False, True])
@pytest.mark.parametrize("d", DS)
def test_zassenhaus_and_exact(d, correction):
    mu = _mu(32, scale=0.6, seed=10 + d)
    got = D.displacement_zassenhaus(torch.from_numpy(mu), d,
                                    correction=correction)
    _close_summed(got, jax_D.displacement_zassenhaus(jnp.asarray(mu), d,
                                                     correction=correction),
                  mu, d)
    exact = D.displacement_exact(torch.from_numpy(mu), d).numpy()
    a = np.diag(np.sqrt(np.arange(1, d)), 1)
    for i in range(len(mu)):
        gen = mu[i] * a.T - np.conj(mu[i]) * a
        np.testing.assert_allclose(exact[i], scipy.linalg.expm(gen),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(exact, jax_D.displacement_exact(
        jnp.asarray(mu), d), rtol=0, atol=1e-9)


@pytest.mark.parametrize("method", ["zassenhaus", "exact"])
def test_displace_env(method):
    rng = np.random.default_rng(3)
    env = rng.uniform(size=(8, 5, 6))
    mu = _mu(8, scale=0.2, seed=4)
    got = D.displace_env(torch.from_numpy(env), torch.from_numpy(mu), 6,
                         method=method)
    assert got.shape == (8, 5, 6) and got.dtype == torch.complex128
    want = jax_D.displace_env(jnp.asarray(env), jnp.asarray(mu), 6,
                              method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 if method == "exact" else 1e-14)
    with pytest.raises(ValueError):
        D.displace_env(torch.from_numpy(env), torch.from_numpy(mu), 6,
                       method="pade")


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_kernel_against_pallas_and_oracle(d, dtype):
    """The plain version in the inputs' precision against the reference's
    Pallas kernel (interpret mode, the inputs' precision) and its oracle
    (complex128, cast back), |μ| up to ~1.5."""
    rng = np.random.default_rng(d)
    mre = (0.5 * rng.normal(size=128)).astype(dtype)
    mim = (0.5 * rng.normal(size=128)).astype(dtype)
    got_re, got_im = DE.displacement_expm(torch.from_numpy(mre),
                                          torch.from_numpy(mim), d)
    assert got_re.dtype == torch.from_numpy(mre).dtype
    pal = jax_kernel(jnp.asarray(mre), jnp.asarray(mim), d, bb=128,
                     interpret=True)
    orc = jax_ref.displacement_zassenhaus_ref(jnp.asarray(mre),
                                              jnp.asarray(mim), d)
    mine = ref.displacement_zassenhaus_ref(torch.from_numpy(mre),
                                           torch.from_numpy(mim), d)
    mu = mre.astype(np.float64) + 1j * mim.astype(np.float64)
    for want in (pal, orc, mine):
        for g, w in zip((got_re, got_im), want):
            if dtype == np.float32:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=3e-5 * d)
            else:
                _close_summed(g, w, mu, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mu_zero_is_identity(dtype):
    z = torch.zeros(4, dtype=dtype)
    for d in (1, 5, 16):
        ore, oim = DE.displacement_expm(z, z, d)
        assert torch.equal(ore, torch.eye(d, dtype=dtype).expand(4, d, d))
        assert torch.equal(oim, torch.zeros_like(oim))
    eye = D.displacement_zassenhaus(torch.zeros(2, dtype=torch.complex128), 7)
    assert torch.equal(eye, torch.eye(7, dtype=torch.complex128).expand(
        2, 7, 7))


def test_d_above_16_raises():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="d=17"):
        DE.displacement_expm(z, z, 17)


def test_ops_displacement_matrices_on_cpu():
    """``auto`` on the CPU is the plain cell; it agrees with the
    reference's ``use_kernel=False`` path; ``cuda`` raises."""
    mu = _mu(128, scale=0.3, seed=9)
    t = torch.from_numpy(mu)
    before = ops.launch_counts()["displacement_expm"]
    got = ops.displacement_matrices(t, 6)
    assert got.dtype == torch.complex128 and got.shape == (128, 6, 6)
    assert ops.launch_counts()["displacement_expm"] == before
    assert torch.equal(got, ops.displacement_matrices(t, 6, kernels="torch"))
    _close(got, jax_ops.displacement_matrices(jnp.asarray(mu), 6,
                                              use_kernel=False))
    with pytest.raises(ValueError, match="cuda"):
        ops.displacement_matrices(t, 6, kernels="cuda")


@pytest.mark.parametrize("d", [1, *DS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coefficient_tables_are_cached(d, dtype):
    """c[j, m] (float64, exp of a sum of three lgammas) within 1e-15
    (relative) of its exact value √(j!/m!)/(j−m)! and of the reference's
    table (scipy's gammaln) for d ≤ 8, and within 1e-14 at d = 16: exp
    carries the error of its argument into c, the rounding of log c (up to
    13 in magnitude) and, in the reference, gammaln's own error (up to
    3.6e-15 of log(n!) at these n) in each term: 2.4e-15 from exact here,
    5.4e-15 from the reference.  The same tensor on a second call, in each
    dtype (the float64 table cast); the kernel's table of c[j, m]·c[k, m]
    once for all d, cached the same way."""
    got = DE.coeff_table(d, dtype)
    assert got is DE.coeff_table(d, dtype, "cpu")
    assert got.dtype == dtype and got.shape == (d, d)
    assert torch.equal(got, DE.coeff_table(d).to(dtype))
    f = math.factorial
    exact = np.array([[math.sqrt(Fraction(f(j), f(m))) / f(j - m) if j >= m
                       else 0.0 for m in range(d)] for j in range(d)])
    tol = 1e-15 if d <= 8 else 1e-14
    np.testing.assert_allclose(DE.coeff_table(d).numpy(), exact, rtol=tol,
                               atol=0)
    np.testing.assert_allclose(DE.coeff_table(d).numpy(),
                               jax_coeff_table(d)[1], rtol=tol, atol=0)
    q = DE.horner_table(dtype)
    assert q is DE.horner_table(dtype, torch.device("cpu"))
    assert q.shape == (DE.horner_offset(DE.MAX_D, 0),) and q.dtype == dtype
    c = DE.coeff_table(DE.MAX_D)
    for j, k in ((d - 1, 0), (d - 1, d - 1), (DE.MAX_D - 1, DE.MAX_D - 2)):
        start = DE.horner_offset(j, k)
        np.testing.assert_array_equal(
            q[start:start + k + 1].numpy(),
            (c[j, :k + 1] * c[k, :k + 1]).to(dtype).numpy())


def _kernel_sums(mre, mim, d):
    """D(μ) as the CUDA kernel sums it: pref·z^{|j−k|}·Q_jk(−|μ|²), Q by
    Horner from ``horner_table``, z = μ below the diagonal and −μ* above
    it, pref·μ^p as repeated products (float64)."""
    q = DE.horner_table().tolist()
    x = -(mre * mre + mim * mim)
    w = [np.exp(-0.5 * (mre * mre + mim * mim)) + 0j]
    for _ in range(1, d):
        w.append(w[-1] * (mre + 1j * mim))
    out = np.zeros((len(mre), d, d), np.complex128)
    for j in range(d):
        for k in range(d):
            hi, lo = max(j, k), min(j, k)
            coef = q[DE.horner_offset(hi, lo):][:lo + 1]
            acc = np.full(len(mre), coef[0])
            for a in coef[1:]:
                acc = acc * x + a
            p = hi - lo
            z = w[p] if j >= k else (-1) ** p * np.conj(w[p])
            out[:, j, k] = acc * z
    return out


@pytest.mark.parametrize("d", DS)
def test_kernel_sums_match_pallas(d):
    """The kernel's form of the sums, with its table, against the
    reference's Pallas kernel (interpret mode) within 1e-12 of the summed
    magnitudes, and μ = 0 → I exactly."""
    mu = _mu(256, scale=0.6, seed=20 + d)
    got = _kernel_sums(mu.real.copy(), mu.imag.copy(), d)
    pre, pim = jax_kernel(jnp.asarray(mu.real), jnp.asarray(mu.imag), d,
                          bb=128, interpret=True)
    _close_summed(got.real, pre, mu, d)
    _close_summed(got.imag, pim, mu, d)
    assert np.array_equal(got[0], np.eye(d))


@pytest.mark.parametrize("d", DS)
def test_least_summed_magnitude_is_the_diagonal_or_the_corner(d):
    """The kernel forms a sample as the plain version does when its least
    summed magnitude e^{−|μ|²/2}·(|L| @ |U|) is below the smallest normal
    number, and finds that least one at (0, 0) (e^{−|μ|²/2}) or at the
    corner (d − 1, 0) (e^{−|μ|²/2}·|μ|^{d−1}·c[d−1, 0]): so it is, for
    |μ| from 10⁻³ to 20."""
    rng = np.random.default_rng(d)
    r = np.exp(rng.uniform(np.log(1e-3), np.log(20.0), 512))
    mu = r * np.exp(1j * rng.uniform(0, 2 * np.pi, r.size))
    summed = _summed(mu, d)
    pref = np.exp(-0.5 * r * r)
    corner = pref * r ** (d - 1) * DE.coeff_table(d)[d - 1, 0].item()
    np.testing.assert_allclose(summed.min(axis=(1, 2)),
                               np.minimum(pref, corner), rtol=1e-12)


@pytest.mark.parametrize("b", [1, 3, 257])
@pytest.mark.parametrize("d", [1, 4, 16])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_entry_plain_matches_pallas(dtype, d, b):
    """``ops.displacement_matrices(kernels="torch")``, the complex entry's
    plain version, against the reference's
    ``ops.displacement_matrices(use_kernel=True)`` (its Pallas kernel in
    interpret mode) in the input's precision."""
    mu = (0.8 * _mu(b, seed=b + d)).astype(dtype)
    got = ops.displacement_matrices(torch.from_numpy(mu), d, kernels="torch")
    assert got.dtype == torch.from_numpy(mu).dtype and got.shape == (b, d, d)
    assert torch.equal(got, DE.displacement_expm_complex_plain(
        torch.from_numpy(mu), d))
    want = np.asarray(jax_ops.displacement_matrices(jnp.asarray(mu), d,
                                                    use_kernel=True))
    assert want.dtype == mu.dtype
    if dtype == np.complex64:
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5 * d)
    else:
        _close_summed(got.real, want.real, mu, d)
        _close_summed(got.imag, want.imag, mu, d)


# the four ranges of |μ| where D(μ)'s sums reach below the smallest normal
# number, as the tile sweep reports them (PERF.md §6): (dtype, low, high,
# log-uniform)
SUBNORMAL_RANGES = [(torch.float32, 1e-3, 1e-2, True),
                (torch.float32, 13.2, 14.2, False),
                (torch.float64, 1e-22, 1e-19, True),
                (torch.float64, 37.7, 38.5, False)]


def _subnormal_mu(real, lo, hi, log, b, seed):
    rng = np.random.default_rng(seed)
    r = (np.exp(rng.uniform(np.log(lo), np.log(hi), b)) if log
         else rng.uniform(lo, hi, b))
    phi = rng.uniform(0, 2 * np.pi, b)
    return (torch.from_numpy(a).to(real)
            for a in (r * np.cos(phi), r * np.sin(phi)))


@pytest.mark.parametrize("real,lo,hi,log", SUBNORMAL_RANGES,
                         ids=[f"{r}-{lo}-{hi}".replace("torch.", "")
                              for r, lo, hi, _ in SUBNORMAL_RANGES])
def test_check_rounding_holds_the_plain_version(real, lo, hi, log):
    """``check_rounding``'s rule for elements whose exact value is below the
    smallest normal number holds the plain version itself in the four
    ranges (the subnormal elements stand up to 3.3·10⁵ spacings from the
    exact value in fp32 at |μ| ≈ 14, 7·10¹³ in fp64 at |μ| ≈ 38, where
    e^{−|μ|²/2} is subnormal); moving one subnormal element by its whole
    allowance, or a normal one by twice the bound, fails it."""
    mre, mim = _subnormal_mu(real, lo, hi, log, 2 ** 11, seed=3)
    plain = DE.displacement_expm_plain(mre, mim, 16)
    res = DE.check_rounding(plain, plain, mre, mim, 16)
    assert res["beyond_bound"] == res["beyond_spacings"] == 0, res
    assert res["subnormal_elements"] > 0
    exact = DE.exact_values(mre, mim, 16)
    small = (exact[0].abs() < torch.finfo(real).smallest_normal)
    i = small.flatten().nonzero()[0].item()
    bad = plain[0].clone()
    bad.view(-1)[i] = torch.finfo(real).smallest_normal
    res = DE.check_rounding((bad, plain[1]), plain, mre, mim, 16)
    assert res["beyond_spacings"] >= 1


def test_check_rounding_holds_normal_elements_to_the_bound():
    mre, mim = _subnormal_mu(torch.float64, 0.1, 1.5, False, 64, seed=4)
    plain = DE.displacement_expm_plain(mre, mim, 4)
    bound = DE.rounding_bound(mre, mim, 4)
    near = plain[0] + 0.5 * bound
    far = plain[0] + 2 * bound
    ok = DE.check_rounding((near, plain[1]), plain, mre, mim, 4)
    assert ok["beyond_bound"] == 0 and 0.4 < ok["of_bound"] < 0.6
    assert DE.check_rounding((far, plain[1]), plain, mre, mim,
                             4)["beyond_bound"] > 0
