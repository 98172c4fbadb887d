"""rope with the reference's bits: the port's ``models.common`` against
``repro.models.common`` on the CPU.

The reference computes, in fp32, inv = 1/θ^(2i/Dh) (XLA's ``pow``: the
fp64 power rounded to fp32 at every head dim the configs use), the angles
pos·inv, and ``jnp.cos``/``jnp.sin``, which XLA's CPU backend computes
with glibc's ``cosf``/``sinf``.  The port takes the power in fp64 on the
host (``rope_inv_freq``) and runs glibc's algorithm in fp64 tensor ops
(``sin_cos``), so the card gives the same bits as the CPU.  Counts are held
at what was measured: torch's own fp32 ``cos``/``sin`` differ from the
reference's on ≈ 5 % of these angles, and its fp32 ``pow`` in one entry of
56 at Dh = 112.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import common as jax_C
from repro_torch.models import common as C

HEAD_DIMS = (16, 64, 112, 128)
CPU = torch.device("cpu")


def _jax_inv(dh, theta=10000.0):
    return np.asarray(1.0 / (theta ** (jnp.arange(0, dh, 2,
                                                  dtype=jnp.float32) / dh)))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_inv_freq_has_the_reference_bits(dh, theta):
    got = C.rope_inv_freq(dh, theta, CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jax_inv(dh, theta))


def test_torch_pow_is_an_ulp_off_at_dh_112():
    """Why the power is taken on the host: torch's fp32 ``pow`` rounds one
    entry of 56 otherwise at Dh = 112 (kimi-k2's and zamba2's head)."""
    e = torch.arange(0, 112, 2, dtype=torch.float32) / 112
    assert int(((1.0 / 10000.0 ** e).numpy() != _jax_inv(112)).sum()) == 1


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_sin_cos_of_rope_angles(dh):
    """Positions 0–4095 (above 120 rad glibc's reduction by 4/π to 192
    bits runs): no mismatch, where torch's fp32 sin/cos miss on ≈ 5 %."""
    ang = torch.arange(4096, dtype=torch.float32)[:, None] * \
        C.rope_inv_freq(dh, 10000.0, CPU)
    sin, cos = C.sin_cos(ang)
    a = ang.numpy()
    want_sin, want_cos = np.asarray(jnp.sin(a)), np.asarray(jnp.cos(a))
    assert sin.dtype == cos.dtype == torch.float32
    assert int((sin.numpy() != want_sin).sum()) == 0
    assert int((cos.numpy() != want_cos).sum()) == 0
    other = (torch.cos(ang).numpy() != want_cos).mean()
    assert 0.04 < other < 0.06


# (low, high, draws) → (sin, cos) mismatches measured
RANGES = {(-200.0, 200.0, 1_000_000): (1, 1), (-1e6, 1e6, 200_000): (0, 0),
          (-1e-3, 1e-3, 100_000): (0, 0)}


@pytest.mark.parametrize("span", list(RANGES))
def test_sin_cos_over_ranges(span):
    """Negative, tiny (below 2⁻¹² sin is y and cos 1), mid and large
    arguments; the one sin and one cos mismatch of 10⁶ are double
    roundings: glibc's FMA build sums its polynomial with fused
    multiply-adds."""
    low, high, n = span
    a = np.random.default_rng(n).uniform(low, high, n).astype(np.float32)
    sin, cos = C.sin_cos(torch.from_numpy(a))
    want_sin, want_cos = RANGES[span]
    assert int((sin.numpy() != np.asarray(jnp.sin(a))).sum()) <= want_sin
    assert int((cos.numpy() != np.asarray(jnp.cos(a))).sum()) <= want_cos


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("dh", (64, 112, 128))
def test_apply_rope_has_the_reference_bits(dh, prec):
    """The rotated q (1, 4096, 8, Dh) equal bit for bit (before the repair
    5.5–6.9 % of fp32 outputs and up to 0.26 % of bf16 ones differed)."""
    dt = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}[prec]
    x = np.random.default_rng(dh).normal(size=(1, 4096, 8, dh)).astype(
        np.float32)
    want = jax_C.apply_rope(jnp.asarray(x).astype(dt[0]),
                            jnp.arange(4096)[None])
    got = C.apply_rope(torch.from_numpy(x).to(dt[1]),
                       torch.arange(4096)[None])
    assert got.dtype == dt[1]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_rope_tables_are_shared():
    """Tables made once serve q and k alike, per-row positions included."""
    pos = torch.tensor([[3], [70]])
    x = torch.randn((2, 1, 4, 112))
    tables = C.rope_tables(pos, 112)
    assert tables[0].shape == tables[1].shape == (2, 1, 1, 56)
    assert torch.equal(C.apply_rope(x, pos, tables=tables),
                       C.apply_rope(x, pos))
