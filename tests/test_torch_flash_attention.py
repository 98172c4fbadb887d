"""The plain version of the port's flash-attention kernel (PyTorch on the
CPU) against the JAX package's Pallas kernel in interpret mode and its
oracle, at the reference test's four cases (GQA, MHA, non-causal, MQA),
kimi-k2's head (Dh = 112, 8 query heads a KV head) and the non-causal
shapes of cross-attention (S = 1, S ≠ T, T off the 64-key tile), in fp32
and bf16;
the port's oracle against the reference's; and the dispatch on CPU
tensors.

Tolerances: fp32 ``atol=3e-6`` (the reference test's, for its kernel
against the same oracle); bf16 ``atol=3e-2`` against the fp32 oracle on the
unrounded inputs (the reference's bf16 test), and against the reference's
bf16 kernel.  Both the reference kernel and the port round the unnormalised
weights to bf16 before P·V (the reference relative to the running max of
its key blocks, the port's plain version relative to the final max), so
the bf16 plain version is also held to the Pallas kernel within
``flash_attention.rounding_bound``: one bf16 rounding of each weight in
each, the fp32 sums, and one output rounding (its docstring derives it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

CASES = [(2, 64, 4, 2, 32, True), (1, 128, 4, 4, 16, True),
         (2, 64, 8, 2, 32, False), (1, 64, 6, 1, 64, True),
         (1, 64, 8, 1, 112, True)]
IDS = ["gqa", "mha", "noncausal", "mqa", "kimi-dh112"]


def _qkv(b, s, h, kvh, dh, t=None, seed=0):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, t, kvh, dh)).astype(np.float32),
            rng.normal(size=(b, t, kvh, dh)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("b,s,h,kvh,dh,causal", CASES, ids=IDS)
def test_fp32_matches_pallas_interpret_and_oracle(b, s, h, kvh, dh, causal):
    q, k, v = _qkv(b, s, h, kvh, dh)
    got = FA.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, dh)
    pal = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, bq=32, bk=32, interpret=True)
    orc = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    for want in (pal, orc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)
    mine = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(mine.numpy(), np.asarray(orc), atol=3e-6)


@pytest.mark.parametrize("b,s,h,kvh,dh,causal", CASES, ids=IDS)
def test_bf16_matches_pallas_interpret_and_oracle(b, s, h, kvh, dh, causal):
    q, k, v = _qkv(b, s, h, kvh, dh, seed=1)
    bf = [_t(a, torch.bfloat16) for a in (q, k, v)]
    got = FA.flash_attention(*bf, causal=causal)
    assert got.dtype == torch.bfloat16
    jbf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    pal = jax_flash(*jbf, causal=causal, bq=32, bk=32, interpret=True)
    orc = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
    for want in (pal, orc):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("b,s,h,kvh,dh,causal", CASES, ids=IDS)
def test_bf16_rounded_weights_match_pallas_interpret(b, s, h, kvh, dh,
                                                     causal):
    """32-key blocks: the Pallas kernel rounds each block's weights relative
    to its running max, as the CUDA kernel's 64-key tiles do."""
    q, k, v = _qkv(b, s, h, kvh, dh, seed=3)
    _within_rounding_bound(q, k, v, causal, block=32)


@pytest.mark.parametrize("s,t,causal,block", [
    (64, 96, True, 32), (96, 64, False, 32), (77, 130, True, None),
    (130, 77, False, None)])
def test_bf16_ragged_matches_pallas_interpret(s, t, causal, block):
    """S ≠ T, in 32-key blocks and (lengths not multiples of 32) as one
    block, which rounds relative to the final max as the plain version."""
    q, k, v = _qkv(1, s, 6, 2, 64, t=t, seed=4)
    _within_rounding_bound(q, k, v, causal, block=block)


def _within_rounding_bound(q, k, v, causal, block):
    bf = [_t(a, torch.bfloat16) for a in (q, k, v)]
    got = FA.flash_attention_plain(*bf, causal=causal)
    sizes = {} if block is None else dict(bq=block, bk=block)
    pal = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=causal, interpret=True, **sizes)
    bound = FA.rounding_bound(*bf, causal=causal)
    diff = (got.float() - torch.from_numpy(np.asarray(pal, np.float32))).abs()
    assert bool((diff <= bound).all()), (diff / bound).max().item()


@pytest.mark.parametrize("s,t,causal", [(100, 100, True), (77, 130, True),
                                        (130, 77, False)])
def test_ragged_lengths_match_oracle(s, t, causal):
    """Lengths that are not multiples of the kernel's 64-row tiles, and
    S ≠ T (the causal mask then starts at the top-left, as the reference's)."""
    q, k, v = _qkv(1, s, 6, 2, 64, t=t, seed=2)
    got = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    want = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,t,h,kvh", [(1, 130, 6, 2), (1, 64, 4, 4),
                                       (130, 130, 6, 2), (77, 130, 6, 2)],
                         ids=["decode-gqa", "decode-mha", "full-gqa",
                              "cross-gqa"])
def test_cross_shapes_match_pallas_interpret_and_oracle(s, t, h, kvh, dtype):
    """The non-causal shapes of cross-attention and of whisper's encoder:
    one query row (a decode step's cross-attention), T not a multiple of
    the kernel's 64-key tile, S ≠ T, GQA.  fp32 within 3e-6 of the Pallas
    kernel (its blocks whole sequences here) and the oracle; bf16 within
    ``rounding_bound`` of the Pallas kernel and 3e-2 of the fp32 oracle."""
    q, k, v = _qkv(2, s, h, kvh, 64, t=t, seed=s + t + h)
    orc = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=False)
    if dtype == "fp32":
        got = FA.flash_attention(_t(q), _t(k), _t(v), causal=False)
        pal = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, interpret=True)
        for want in (pal, orc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=3e-6)
        return
    _within_rounding_bound(q, k, v, False, block=None)
    got = FA.flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                             causal=False)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(orc),
                               atol=3e-2)


def test_dispatch_on_cpu_tensors():
    q, k, v = (_t(a) for a in _qkv(1, 64, 4, 2, 64))
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out, FA.flash_attention_plain(q, k, v))
    assert torch.equal(out, ops.flash_attention(q, k, v, kernels="torch"))
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="cuda"):
        ops.flash_attention(q, k, v, kernels="cuda")
