"""The port's MoE layer and MLA (plain PyTorch on the CPU) against the JAX
package's on the same weights: ``repro.models.moe`` builds them
(``moe_init`` on a jax key), ``repro.models.attention.mla_init`` the MLA
weights, and the port receives them through numpy; inputs are seeded numpy
draws handed to both.

* the reference's seven MoE properties (``tests/test_moe.py``), each held
  against the reference's own outputs: one expert = its MLP, no drops at
  cf 8, drops counted at cf 0.05 (the same ``drop_frac``), ``_capacity``
  over a grid of (S, E, k, cf) with S = 1 and 4096 at deepseek-v3's E, the
  gates normalised and applied, the shared expert added, ``lb_loss``;
* the combine at top_k ≥ 3 in bf16: on these inputs the port's output is
  the reference's bit for bit (its terms added in ascending expert order
  from zero, as the reference's scatter over expert-major slots adds
  them); the test holds it to the bf16 tolerance and to that equality;
* ties in top-k go to the lower index, as ``jax.lax.top_k``'s, and equal
  router logits route and drop as the reference's;
* MLA prefill, and decode with a scalar and with per-row cache lengths
  against ``mla_apply`` run one row at a time with each row's scalar.

The reference's ``moe_apply`` runs under ``jit`` (compiled once a config;
its ``drop_frac``, a mean, then rounds to ±3e-8 where it is 0 op by op, so
the port's is held to 0 and the two to 1e-7), and so does ``mla_apply``.
Tolerances, relative to the largest |output|: fp32 1e-5, bf16 3e-2
(``tests/test_torch_lm.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import attention as jax_A
from repro.models import moe as jax_MOE
from repro_torch import convert
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.common import mlp_apply

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 3e-2}
PRECS = ["fp32", "bf16"]


def _cfgs(**kw):
    """(reference, port) configs; the tests share one base config and one
    input shape (2, 16, 16) where they can, so that the reference's ops,
    compiled one by one, are compiled once."""
    base = dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                capacity_factor=8.0, n_shared=1)
    base.update(kw)
    return (jax_MOE.MoEConfig(**base),
            MOE.MoEConfig(**base))


def _weights(jcfg, prec, seed=0):
    """(reference params, port params) on the same weights."""
    jdt, _ = DTYPES[prec]
    jparams, _ = jax_MOE.moe_init(jax.random.key(seed), jcfg, jdt)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, _to_port(tree)


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    return convert.tensor_from_array(tree, "cpu")


def _x(shape, prec, seed):
    jdt, _ = DTYPES[prec]
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(a).astype(jdt)
    return jx, convert.tensor_from_array(np.asarray(jx), "cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, prec):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    assert err <= TOL[prec], (err, TOL[prec])


_REF = jax.jit(jax_MOE.moe_apply, static_argnums=2)
_MLA = jax.jit(jax_A.mla_apply, static_argnums=2)


def _both(jparams, params, jx, x, jcfg, cfg):
    want, waux = _REF(jparams, jx, jcfg)
    got, aux = MOE.moe_apply(params, x, cfg)
    return got, aux, want, waux


# ---------------------------------------------------------------------------
# the reference's seven properties, against the reference's outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECS)
def test_single_expert_equals_dense_mlp(prec):
    jcfg, cfg = _cfgs(n_experts=1, top_k=1, n_shared=0)
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 1)
    got, aux, want, waux = _both(jparams, params, jx, x, jcfg, cfg)
    _close(got, want, prec)
    mlp = {n: params[n][0] for n in ("gate", "up", "down")}
    _close(got, mlp_apply(mlp, x.reshape(32, 16)).reshape(2, 16, 16), prec)
    assert float(aux["drop_frac"]) == 0.0
    assert float(waux["drop_frac"]) == pytest.approx(0.0, abs=1e-7)


@pytest.mark.parametrize("prec", PRECS)
def test_no_drops_with_ample_capacity(prec):
    jcfg, cfg = _cfgs(capacity_factor=8.0)
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 2)
    got, aux, want, waux = _both(jparams, params, jx, x, jcfg, cfg)
    _close(got, want, prec)
    assert float(aux["drop_frac"]) == 0.0
    assert float(waux["drop_frac"]) == pytest.approx(0.0, abs=1e-7)


@pytest.mark.parametrize("prec", PRECS)
def test_capacity_drops_counted(prec):
    """cf 0.05: overflow goes to the sink; the port drops the very slots
    the reference drops (the same drop_frac, the same outputs)."""
    jcfg, cfg = _cfgs(capacity_factor=0.05)
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 3)
    got, aux, want, waux = _both(jparams, params, jx, x, jcfg, cfg)
    assert float(aux["drop_frac"]) > 0.0
    assert float(aux["drop_frac"]) == pytest.approx(
        float(waux["drop_frac"]), abs=1e-7)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, prec)


CAPACITY_GRID = [(s, e, k, cf) for s in (1, 2, 16, 100, 4096)
                 for e, k in ((256, 8), (384, 8), (8, 2))
                 for cf in (0.05, 1.25, 8.0)]


@pytest.mark.parametrize("s,e,k,cf", CAPACITY_GRID)
def test_capacity_matches_reference(s, e, k, cf):
    jcfg, cfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    got = MOE._capacity(s, cfg)
    assert got == jax_MOE._capacity(s, jcfg)
    assert got >= 1 and (got < 8 or got % 8 == 0)
    if (s, e, k, cf) == (1, 256, 8, 1.25):
        assert got == 1                   # decode: never 8× padded


@pytest.mark.parametrize("prec", PRECS)
def test_gate_weights_normalized_and_applied(prec):
    """Doubling expert 0's down-projection moves the output of the tokens
    routed to it, in the port as in the reference; the gates of a token
    sum to 1."""
    jcfg, cfg = _cfgs()
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 4)
    got, _, want, _ = _both(jparams, params, jx, x, jcfg, cfg)
    _close(got, want, prec)
    jparams2 = dict(jparams, down=jparams["down"].at[0].multiply(2.0))
    params2 = dict(params, down=params["down"].clone())
    params2["down"][0] *= 2.0
    got2, _, want2, _ = _both(jparams2, params2, jx, x, jcfg, cfg)
    _close(got2, want2, prec)
    assert not np.allclose(_np(got), _np(got2))
    logits = x.float() @ params["router"]
    gates, eids = MOE.top_k_lower_first(torch.softmax(logits, -1), 2)
    assert bool((eids == 0).any())
    norm = gates / gates.sum(-1, keepdim=True)
    np.testing.assert_allclose(norm.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("prec", PRECS)
def test_shared_expert_added(prec):
    jcfg, cfg = _cfgs(n_shared=1)
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 5)
    got, _, want, _ = _both(jparams, params, jx, x, jcfg, cfg)
    _close(got, want, prec)
    zero = {k: (torch.zeros_like(v) if k in ("gate", "up", "down") else v)
            for k, v in params.items()}
    jzero = {k: (jnp.zeros_like(v) if k in ("gate", "up", "down") else v)
             for k, v in jparams.items()}
    got0, _, want0, _ = _both(jzero, zero, jx, x, jcfg, cfg)
    _close(got0, want0, prec)
    shared = mlp_apply(params["shared"], x.reshape(32, 16)).reshape(2, 16,
                                                                    16)
    _close(got0, shared, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_lb_loss_matches(prec):
    jcfg, cfg = _cfgs()
    jparams, params = _weights(jcfg, prec)
    jx, x = _x((2, 16, 16), prec, 6)
    _, aux, _, waux = _both(jparams, params, jx, x, jcfg, cfg)
    lb = float(aux["lb_loss"])
    assert lb == pytest.approx(float(waux["lb_loss"]), rel=1e-5)
    assert 0.0 < lb < 4 * cfg.n_experts
    assert aux["lb_loss"].dtype == aux["drop_frac"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the combine, and ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,e,cf", [(3, 8, 8.0), (3, 8, 0.5), (4, 8, 8.0),
                                    (8, 16, 0.5)])
def test_combine_at_top_k_3_and_more_in_bf16(k, e, cf):
    """Each token's k terms summed in bf16 in ascending expert order from
    zero: within the bf16 tolerance of the reference, and on these inputs
    equal to it bit for bit (with drops at cf 0.5 too)."""
    jcfg, cfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    jparams, params = _weights(jcfg, "bf16", seed=k)
    jx, x = _x((2, 16, 16), "bf16", 10 + k)
    got, aux, want, waux = _both(jparams, params, jx, x, jcfg, cfg)
    _close(got, want, "bf16")
    assert float(aux["drop_frac"]) == pytest.approx(
        float(waux["drop_frac"]), abs=1e-7)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_combine_is_deterministic():
    """Two calls give the same bits (no atomics on any device)."""
    jcfg, cfg = _cfgs(n_experts=8, top_k=4)
    _, params = _weights(jcfg, "bf16")
    _, x = _x((2, 16, 16), "bf16", 7)
    a, _ = MOE.moe_apply(params, x, cfg)
    b, _ = MOE.moe_apply(params, x, cfg)
    assert torch.equal(a, b)


TIES = [np.array([0.25, 0.25, 0.25, 0.25]),
        np.array([0.1, 0.3, 0.3, 0.1, 0.2]),
        np.array([0.0, 0.5, 0.0, 0.5, 0.0, 0.0]),
        np.array([0.2] * 5)]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("probs", TIES, ids=["uniform4", "pairs", "zeros",
                                             "uniform5"])
def test_top_k_ties_go_to_the_lower_index(probs, k):
    rows = np.stack([probs, probs[::-1].copy()]).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
    gv, gi = MOE.top_k_lower_first(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_equal_router_logits_route_as_the_reference(cf):
    """A zero router gives every expert the same probability: each token
    goes to experts 0..k-1, and the stable position sort decides which
    tokens overflow; the same output and drop_frac as the reference."""
    jcfg, cfg = _cfgs(n_experts=8, top_k=3, capacity_factor=cf)
    jparams, params = _weights(jcfg, "bf16")
    jparams = dict(jparams, router=jnp.zeros_like(jparams["router"]))
    params = dict(params, router=torch.zeros_like(params["router"]))
    jx, x = _x((2, 16, 16), "bf16", 8)
    got, aux, want, waux = _both(jparams, params, jx, x, jcfg, cfg)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert float(aux["drop_frac"]) == pytest.approx(
        float(waux["drop_frac"]), abs=1e-7)
    if cf < 8:
        assert float(aux["drop_frac"]) > 0


def test_port_init_shapes_and_router_dtype():
    cfg = MOE.MoEConfig(16, 32, 4, 2, n_shared=2)
    gen = torch.Generator().manual_seed(0)
    p = MOE.moe_init(gen, cfg, torch.bfloat16, "cpu")
    assert p["router"].shape == (16, 4) and p["router"].dtype == torch.float32
    assert p["gate"].shape == p["up"].shape == (4, 16, 32)
    assert p["down"].shape == (4, 32, 16)
    assert p["shared"]["gate"].shape == (16, 64)
    assert p["shared"]["down"].shape == (64, 16)
    assert all(v.dtype == torch.bfloat16 for n, v in p.items()
               if n in ("gate", "up", "down"))
    q = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    assert torch.equal(p["gate"], q["gate"])


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla(prec, seed=0):
    jdt, _ = DTYPES[prec]
    jcfg = jax_A.MLAConfig(32, 4, head_dim=16, rope_head_dim=8,
                           q_lora_rank=24, kv_lora_rank=20)
    cfg = A.MLAConfig(32, 4, head_dim=16, rope_head_dim=8, q_lora_rank=24,
                      kv_lora_rank=20)
    jparams, _ = jax_A.mla_init(jax.random.key(seed), jcfg, jdt)
    params = _to_port(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def test_mla_defaults_and_shapes():
    cfg = A.MLAConfig(7168, 128)
    want = jax_A.MLAConfig(7168, 128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    small = A.MLAConfig(32, 4, head_dim=16, rope_head_dim=8, q_lora_rank=24,
                        kv_lora_rank=20)
    p = A.mla_init(torch.Generator().manual_seed(0), small, torch.float32)
    _, jparams, _, _ = _mla("fp32")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    cache = A.init_mla_cache(3, 10, small, torch.bfloat16)
    assert cache.latent.shape == (3, 10, 28)
    assert cache.latent.dtype == torch.bfloat16 and int(cache.length) == 0


@pytest.mark.parametrize("prec", PRECS)
def test_mla_prefill_matches(prec):
    jcfg, jparams, cfg, params = _mla(prec)
    jx, x = _x((2, 12, 32), prec, 20)
    want, wc = _MLA(jparams, jx, jcfg)
    got, c = A.mla_apply(params, x, cfg)
    assert wc is None and c is None
    _close(got, want, prec)


def _prefilled_cache(jcfg, cfg, prec, b, t, seed):
    """A latent cache (B, T, r + dr) of random contents, in both packages."""
    jdt, _ = DTYPES[prec]
    a = np.random.default_rng(seed).normal(
        size=(b, t, cfg.kv_lora_rank + cfg.rope_head_dim)).astype(np.float32)
    jl = jnp.asarray(a).astype(jdt)
    return jl, convert.tensor_from_array(np.asarray(jl), "cpu")


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("length", [0, 3, 9])
def test_mla_decode_scalar_length(prec, length):
    jcfg, jparams, cfg, params = _mla(prec)
    jl, tl = _prefilled_cache(jcfg, cfg, prec, 2, 10, 21)
    jx, x = _x((2, 1, 32), prec, 22)
    pos = np.full((2, 1), length, np.int32)
    want, wc = _MLA(jparams, jx, jcfg, jnp.asarray(pos),
                               jax_A.MLACache(jl, jnp.int32(length)))
    cache = A.MLACache(tl, torch.tensor(length, dtype=torch.int32))
    got, c = A.mla_apply(params, x, cfg, torch.from_numpy(pos).long(), cache)
    _close(got, want, prec)
    assert c.latent is tl                       # written in place
    np.testing.assert_array_equal(_np(c.latent), _np(wc.latent))
    assert int(c.length) == int(wc.length) == length + 1


@pytest.mark.parametrize("prec", PRECS)
def test_mla_decode_per_row_lengths(prec):
    """Lengths (B,) = 0, 3, 9 and 10 (a full cache: the write clamps to the
    last row, as ``dynamic_update_slice`` clamps): each row equals the
    reference run on that row alone with its scalar length."""
    jcfg, jparams, cfg, params = _mla(prec)
    lengths = np.array([0, 3, 9, 10], np.int32)
    b, t = len(lengths), 10
    jl, tl = _prefilled_cache(jcfg, cfg, prec, b, t, 23)
    jx, x = _x((b, 1, 32), prec, 24)
    pos = torch.from_numpy(lengths[:, None]).long()
    got, c = A.mla_apply(params, x, cfg, pos,
                         A.MLACache(tl, torch.from_numpy(lengths)))
    for r, n in enumerate(lengths):
        want, wc = _MLA(
            jparams, jx[r:r + 1], jcfg, jnp.asarray([[n]], jnp.int32),
            jax_A.MLACache(jl[r:r + 1], jnp.int32(n)))
        _close(got[r:r + 1], want, prec)
        np.testing.assert_array_equal(_np(c.latent[r:r + 1]),
                                      _np(wc.latent))
    np.testing.assert_array_equal(c.length.numpy(), lengths + 1)
