"""The bf16 operands of the wgmma GEMMs against the JAX package (CPU).

The bf16 entries of ``site_step_linear`` and ``contract_measure`` round
their GEMM operands into device memory before TMA copies them into shared
memory (TMA neither converts nor gathers): env in the bucket sort's order
(the collapse) or as it lies (contract_measure), Γ as a bf16 copy, and Γ's
bf16 planes P[s, l, r] (the collapse's B, written by the W pass).  Each
row is padded with zeros to a whole 16 bytes, a row stride TMA takes.
Their plain versions, ``site_step.bf16_rows_plain`` and
``site_step.bf16_planes_plain`` (and ``site_step.bucket_plain``, the
bucket sort's order, rows of no outcome in [0, d) last), are what the card
tests hold the passes to; here they are held bit for bit against the JAX package's rounding of
the same numpy inputs (``astype(jnp.bfloat16)``; fp64 rounds through fp32
there, as in the port), with the padding and the row order.  Then the GEMMs
of the prepared operands, summed in fp64 (the bf16 products are exact),
against the JAX package's Pallas ``contract_measure`` and
``collapse_select`` on bf16 operands in interpret mode, within
``site_step.bf16_gemm_bound`` (fp32 sums in another order).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import collapse_select as jax_cs
from repro.kernels import contract_measure as jax_cm
from repro_torch import convert
from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels import site_step as K

DTYPES = {"fp32": np.float32, "fp64": np.float64, "bf16": ml_dtypes.bfloat16}


def _bits_torch(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _bits_jax(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.uint16)


def _array(dtype, shape, seed):
    """Seeded values over many binades, both signs, and a few exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * np.exp2(rng.integers(-20, 20, size=shape))
    x.flat[::7] = 1 + 2.0 ** -8            # a tie: rounds to even (1.0)
    x.flat[::11] = 1 + 2.0 ** -8 + 2.0 ** -40   # fp64: through fp32, to 1.0
    return x.astype(np.float32).astype(DTYPES[dtype]) if dtype == "bf16" \
        else x.astype(DTYPES[dtype])


@pytest.mark.parametrize("k,want", [(1, 8), (8, 8), (13, 16), (2500, 2504),
                                    (10_000, 10_000), (40_000, 40_000)])
def test_padded_rows_are_whole_16_bytes(k, want):
    assert K.padded(k) == want


@pytest.mark.parametrize("order", ["as_it_lies", "bucket"])
@pytest.mark.parametrize("shape", [(1, 5), (8, 16), (13, 29), (37, 130)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_rows_match_jax_rounding(dtype, shape, order):
    """env (or Γ as a matrix) rounded to bf16 in rows of padded(K), zeros
    past K; in bucket order row m is the input's row perm[m]."""
    x = _array(dtype, shape, seed=shape[0] * 131 + shape[1])
    rows, k = shape
    perm = None
    if order == "bucket":          # the stable sort of the rows by outcome
        samples = np.random.default_rng(rows).integers(0, 4, size=rows)
        perm = torch.from_numpy(np.argsort(samples, kind="stable"))
    got = K.bf16_rows_plain(convert.tensor_from_array(x, "cpu"), perm)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, K.padded(k))
    want = _bits_jax(x if perm is None else x[perm.numpy()])
    np.testing.assert_array_equal(_bits_torch(got[:, :k]), want)
    assert (got[:, k:] == 0).all() and not got[:, k:].signbit().any()


@pytest.mark.parametrize("shape", [(5, 8, 1), (7, 16, 3), (13, 29, 5),
                                   (4, 130, 16)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_planes_match_jax_rounding(dtype, shape):
    """P[s, l, r] = bf16(Γ[l, r, s]) in planes (d, L, padded(R)), zeros
    past R."""
    g = _array(dtype, shape, seed=sum(shape))
    chi_l, chi_r, d = shape
    got = K.bf16_planes_plain(convert.tensor_from_array(g, "cpu"))
    assert got.dtype == torch.bfloat16
    assert got.shape == (d, chi_l, K.padded(chi_r))
    want = _bits_jax(g)                                  # (L, R, d)
    for s in range(d):
        np.testing.assert_array_equal(_bits_torch(got[s, :, :chi_r]),
                                      want[:, :, s])
    assert (got[:, :, chi_r:] == 0).all()


@pytest.mark.parametrize("prep", ["rows", "planes"])
def test_fp64_rounds_through_fp32(prep):
    """1 + 2⁻⁸ + 2⁻⁴⁰ rounds to fp32's tie 1 + 2⁻⁸ and then to 1.0 (even),
    as XLA rounds it; rounding once would give 1.0078125."""
    x = np.full((3, 4, 2), 1 + 2.0 ** -8 + 2.0 ** -40)
    t = convert.tensor_from_array(x, "cpu")
    got = (K.bf16_rows_plain(t.reshape(3, 8)) if prep == "rows"
           else K.bf16_planes_plain(t))
    assert float(got.float().max()) == 1.0
    assert _bits_jax(x).max() == _bits_torch(got).max()


PAIRS = {"fp32+fp32": (np.float32, np.float32),
         "fp32+bf16": (np.float32, ml_dtypes.bfloat16),
         "fp64+fp64": (np.float64, np.float64)}


def _operands(pair, n, chi_l, chi_r, d, seed):
    te, tg = PAIRS[pair]
    rng = np.random.default_rng(seed)
    env = rng.uniform(size=(n, chi_l)).astype(te)
    gamma = rng.uniform(size=(chi_l, chi_r, d)).astype(np.float32).astype(tg)
    lam = (rng.uniform(size=chi_r) + 0.5).astype(te)
    samples = rng.integers(0, d, size=n).astype(np.int32)
    return env, gamma, lam, samples


def _within(got, want, bound):
    diff = (got - torch.from_numpy(np.asarray(want, dtype=np.float64))).abs()
    assert (diff <= bound).all(), (diff / bound).max().item()


@pytest.mark.parametrize("shape", [(16, 8, 8, 3), (24, 16, 24, 4)])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_prepared_gemms_match_jax_kernels(pair, shape):
    """contract_measure's GEMM on env16 and Γ's bf16 copy, and the grouped
    collapse on env16 in bucket order and plane s_n, against the JAX
    package's Pallas kernels on bf16 operands (interpret mode)."""
    n, chi_l, chi_r, d = shape
    env, gamma, lam, samples = _operands(pair, *shape, seed=sum(shape))
    te, tg = (convert.tensor_from_array(a, "cpu") for a in (env, gamma))
    bf = jnp.bfloat16
    je, jg = jnp.asarray(env).astype(bf), jnp.asarray(gamma).astype(bf)
    bound = K.bf16_gemm_bound(te, tg.reshape(chi_l, chi_r * d))

    env16 = K.bf16_rows_plain(te).double()
    g16 = K.bf16_rows_plain(tg.reshape(chi_l, chi_r * d)).double()
    temp = env16[:, :chi_l] @ g16[:chi_l, :chi_r * d]
    jt, _ = jax_cm.contract_measure(je, jg, jnp.asarray(lam), bn=8, br=8,
                                    bl=8, interpret=True)
    _within(temp, np.asarray(jt).reshape(n, -1), bound)

    s = torch.from_numpy(samples).long()
    perm = torch.sort(s, stable=True).indices
    sorted16 = K.bf16_rows_plain(te, perm).double()
    planes = K.bf16_planes_plain(tg).double()
    out = torch.zeros((n, chi_r), dtype=torch.float64)
    for m, row in enumerate(perm.tolist()):     # row m of the sorted env
        out[row] = sorted16[m, :chi_l] @ planes[s[row], :, :chi_r]
    want = jax_cs.collapse_select(je, jg, jnp.asarray(samples), bn=8, br=8,
                                  bl=8, interpret=True)
    _within(out, want, torch.take_along_dim(
        bound.reshape(n, chi_r, d), s[:, None, None], dim=2)[:, :, 0])


@pytest.mark.parametrize("case,copy", [("bf16", False), ("fp32", True),
                                       ("bf16_odd_row", True),
                                       ("bf16_off_16_bytes", True)])
def test_contract_scratch_reads_an_aligned_bf16_gamma_as_it_lies(case, copy):
    """contract_measure's bf16 entry copies Γ to bf16 unless it is bf16
    with rows of a multiple of 8 elements at a 16-byte aligned address."""
    env = torch.zeros((5, 12), dtype=torch.float32)
    r, d = (3, 3) if case == "bf16_odd_row" else (4, 2)
    store = torch.zeros(12 * r * d + 1,
                        dtype=torch.float32 if case == "fp32"
                        else torch.bfloat16)
    gamma = (store[1:] if case == "bf16_off_16_bytes" else
             store[:-1]).view(12, r, d)
    env16, g16 = CM.gemm_scratch(env, gamma)
    assert env16.dtype == torch.bfloat16 and env16.shape == (5, 16)
    if copy:
        assert g16.dtype == torch.bfloat16
        assert g16.shape == (12, K.padded(r * d))
    else:
        assert g16 is None


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_linear_scratch(compute_dtype):
    """W, perm and meta; under bf16 inputs also env16 and the planes."""
    got = K.linear_scratch(37, 13, 29, 5, torch.float32, "cpu",
                           compute_dtype)
    shapes = [(t.shape, t.dtype) for t in got]
    want = [((13, 5), torch.float32), ((37,), torch.int32),
            ((16,), torch.int32)]
    if compute_dtype is not None:
        want += [((37, 16), torch.bfloat16), ((5, 13, 32), torch.bfloat16)]
    assert shapes == want


def test_bucket_order_puts_rows_of_no_group_last():
    """Stable by outcome, then the rows whose outcome is outside [0, d) in
    their order: a permutation of all the rows (group 2 empty)."""
    samples = torch.tensor([3, -1, 0, 4, 1, 0, 3, 9, 1, -7, 0])
    got = K.bucket_plain(samples, 4)
    assert got.dtype == torch.int32
    assert got.tolist() == [2, 5, 10, 4, 8, 0, 6, 1, 3, 7, 9]


@pytest.mark.parametrize("shape", [(16, 8, 8, 3), (40, 24, 16, 5),
                                   (24, 16, 24, 4)])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_prepared_collapse_matches_jax_with_rows_of_no_group(pair, shape):
    """collapse_select's bf16 entry on its prepared operands (env in bucket
    order, Γ's planes): rows of each group by plane s, the rows of no
    outcome (−1 and d) zero, one group empty, against the JAX package's
    Pallas ``collapse_select`` on bf16 operands (interpret mode) within
    ``bf16_gemm_bound``; those rows exactly zero in both."""
    n, chi_l, chi_r, d = shape
    env, gamma, _, samples = _operands(pair, *shape, seed=7 * n + d)
    samples[samples == 1] = 0                   # group 1 empty
    samples[::5] = -1
    samples[3::7] = d
    te, tg = (convert.tensor_from_array(a, "cpu") for a in (env, gamma))
    s = torch.from_numpy(samples).long()
    perm = K.bucket_plain(s, d)
    sorted16 = K.bf16_rows_plain(te, perm).double()
    planes = K.bf16_planes_plain(tg).double()
    out = torch.zeros((n, chi_r), dtype=torch.float64)
    for m, row in enumerate(perm.tolist()):
        if 0 <= s[row] < d:
            out[row] = sorted16[m, :chi_l] @ planes[s[row], :, :chi_r]
    bf = jnp.bfloat16
    want = np.asarray(jax_cs.collapse_select(
        jnp.asarray(env).astype(bf), jnp.asarray(gamma).astype(bf),
        jnp.asarray(samples), bn=8, br=8, bl=8, interpret=True))
    none = (s < 0) | (s >= d)
    assert none.any() and (want[none.numpy()] == 0).all()
    bound = K.bf16_gemm_bound(te, tg.reshape(chi_l, chi_r * d))
    _within(out, want, torch.take_along_dim(
        bound.reshape(n, chi_r, d), s.clamp(0, d - 1)[:, None, None],
        dim=2)[:, :, 0])
    assert (out[none] == 0).all()


def test_collapse_scratch():
    """collapse_select's bf16 operands: env in bucket order (N, padded(L))
    and Γ's planes (d, L, padded(R)), bf16."""
    got = CS.bf16_scratch(37, 13, 29, 5, "cpu")
    assert [(t.shape, t.dtype) for t in got] == [
        ((37, 16), torch.bfloat16), ((5, 13, 32), torch.bfloat16)]
