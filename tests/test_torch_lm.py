"""The port's dense LM stack (plain PyTorch on the CPU) against the JAX
package on the same weights: ``forward`` (prefill) and ``decode_step``
logits, the prefill and serve steps, and ``serve()``'s tokens, for the
``granite-smoke`` (GQA, g = 4) and ``qwen-smoke`` (QKV bias, KVH = H)
configs in fp32 and bf16.

The reference builds the weights (``init_params``); its norms and biases are
then redrawn from a numpy generator so that every multiply is exercised, and
the port receives the same tree through ``convert.lm_params_from_arrays``.
The reference runs with ``USE_FLASH = False`` (its flash kernel cannot run
compiled on the CPU): its prefill attention is ``_sdpa``, the port's the
flash kernel's plain version.

Tolerances, on logits relative to their largest magnitude: fp32 1e-5 (the
two frameworks sum in other orders); bf16 3e-2 (the reference rounds
scores to bf16 before the softmax, the port's flash path does not, and
both round every activation to bf16).  Greedy tokens are exact in fp32 and
bf16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.launch import serve_lm as jax_serve
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_T
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm, steps
from repro_torch.models import transformer as T

ARCHS = ["granite-3-2b", "qwen1.5-4b"]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 3e-2}
DENSE = ["granite-3-2b", "qwen1.5-4b", "deepseek-7b", "starcoder2-15b"]


@functools.lru_cache(maxsize=None)
def _models(arch: str, prec: str):
    """(reference config, reference params, port config, port params)."""
    jdt, tdt = DTYPES[prec]
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), dtype=jdt)
    jparams, _ = jax_T.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(7)
    layers = tree["layers"]
    for name in ("ln1", "ln2"):
        a = layers[name]
        layers[name] = (1 + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
    tree["ln_f"] = (1 + 0.2 * rng.normal(size=tree["ln_f"].shape)).astype(
        tree["ln_f"].dtype)
    for name in ("bq", "bk", "bv"):
        if name in layers["attn"]:
            a = layers["attn"][name]
            layers["attn"][name] = (0.3 * rng.normal(size=a.shape)).astype(
                a.dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    return jcfg, jparams, cfg, convert.lm_params_from_arrays(tree, cfg, "cpu")


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s),
                                                dtype=np.int32)


def _close(got: torch.Tensor, want, prec: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[prec], (err, TOL[prec])


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, prec):
    jcfg, jparams, cfg, params = _models(arch, prec)
    toks = _tokens(cfg, 2, 16)
    want, _ = jax_T.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(params, torch.from_numpy(toks).long(), cfg)
    assert got.dtype == cfg.dtype and got.shape == (2, 16, cfg.vocab)
    assert float(aux) == 0.0
    _close(got, want, prec)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match(arch, prec):
    jcfg, jparams, cfg, params = _models(arch, prec)
    b, s = 2, 6
    toks = _tokens(cfg, b, s, seed=5)
    jstate = jax_T.init_decode_state(jcfg, b, s + 1)
    state = T.init_decode_state(cfg, b, s + 1, device="cpu")
    for t in range(s):
        step = toks[:, t:t + 1]
        want, jstate = jax_T.decode_step(jparams, jnp.asarray(step), jstate,
                                         jcfg)
        got, state = T.decode_step(params, torch.from_numpy(step).long(),
                                   state, cfg)
        _close(got, want, prec)
    assert int(state.position) == s


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, prec):
    """Step-by-step decode (plain ``_sdpa``) gives the full forward's
    logits (flash dispatch) at every position: argmax agreement > 0.9 as
    the reference's test, and the logits within the tolerance."""
    _, _, cfg, params = _models(arch, prec)
    b, s = 2, 6
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=9)).long()
    full, _ = T.forward(params, toks, cfg)
    state = T.init_decode_state(cfg, b, s + 1, device="cpu")
    outs = []
    for t in range(s):
        logits, state = T.decode_step(params, toks[:, t:t + 1], state, cfg)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    assert agree > 0.9, agree
    _close(dec, full.float().numpy(), prec)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match(arch, prec):
    jcfg, jparams, cfg, params = _models(arch, prec)
    toks = _tokens(cfg, 3, 8, seed=11)
    want = jax_steps.make_prefill_step(jcfg)(jparams,
                                             {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    got = steps.make_prefill_step(cfg)(params, batch)
    assert got.shape == (3, cfg.vocab)
    _close(got, want, prec)
    first = toks[:, :1]
    jnxt, jstate = jax_steps.make_serve_step(jcfg)(
        jparams, {"tokens": jnp.asarray(first)},
        jax_T.init_decode_state(jcfg, 3, 8))
    nxt, state = steps.make_serve_step(cfg)(
        params, {"tokens": torch.from_numpy(first).long()},
        T.init_decode_state(cfg, 3, 8, device="cpu"))
    assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert int(state.position) == int(jstate.position) == 1


def _serve_prompts(cfg):
    """The prompts of tests/test_serve_lm.py."""
    rng = np.random.default_rng(1)
    return [(int(t), int(n)) for t, n in
            zip(rng.integers(0, cfg.vocab, 10), rng.integers(2, 9, 10))]


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_serve_tokens_match_reference(prec):
    jcfg, jparams, cfg, params = _models("granite-3-2b", prec)
    prompts = _serve_prompts(cfg)
    want = jax_serve.serve(jcfg, jparams, prompts, batch=3, max_new=8,
                           cache_len=16, verbose=False)
    got = serve_lm.serve(cfg, params, prompts, batch=3, max_new=8,
                         cache_len=16, verbose=False)
    assert sorted(got) == list(range(10))
    assert got == want


def test_serve_finish_rules():
    """EOS and a full cache end requests exactly as in the reference."""
    jcfg, jparams, cfg, params = _models("granite-3-2b", "fp32")
    prompts = _serve_prompts(cfg)
    eos = serve_lm.serve(cfg, params, prompts, batch=3, max_new=8,
                         cache_len=16, verbose=False)[0][0]
    for kw in (dict(cache_len=6), dict(eos=eos, cache_len=16)):
        want = jax_serve.serve(jcfg, jparams, prompts, batch=4, max_new=8,
                               verbose=False, **kw)
        got = serve_lm.serve(cfg, params, prompts, batch=4, max_new=8,
                             verbose=False, **kw)
        assert got == want


def test_slot_isolation():
    """A refilled slot does not see the previous request's cache."""
    _, _, cfg, params = _models("granite-3-2b", "bf16")
    alone = serve_lm.serve(cfg, params, [(7, 6)], batch=1, max_new=6,
                           cache_len=16, verbose=False)
    packed = serve_lm.serve(cfg, params, [(3, 2), (7, 6)], batch=1,
                            max_new=6, cache_len=16, verbose=False)
    assert alone[0] == packed[1]


def test_forward_goes_through_the_flash_dispatch(monkeypatch):
    """Prefill attention is the flash kernel's dispatch, one call per layer;
    ``kernels="cuda"`` on CPU tensors raises."""
    _, _, cfg, params = _models("granite-3-2b", "fp32")
    calls = []
    real = ops.FA.flash_attention_plain
    monkeypatch.setattr(ops.FA, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(_tokens(cfg, 1, 8)).long()
    T.forward(params, toks, cfg)
    assert len(calls) == cfg.n_layers
    with pytest.raises(ValueError, match="cuda"):
        T.forward(params, toks, cfg, kernels="cuda")


@pytest.mark.parametrize("arch", DENSE)
def test_configs_copied_value_for_value(arch):
    for getter in ("get_config", "get_smoke_config"):
        want = getattr(jax_configs, getter)(arch)
        got = getattr(configs, getter)(arch)
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.bfloat16
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_param_count_and_cells_match(arch):
    """Every architecture's count, through a port ModelConfig with the
    reference's field values, and its cell support."""
    want = jax_configs.get_config(arch)
    fields = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    got = T.ModelConfig(**dict(fields, dtype=torch.bfloat16))
    assert got.param_count() == want.param_count()
    for name, shape in configs.SHAPES.items():
        assert (configs.cell_supported(got, shape)
                == jax_configs.cell_supported(want,
                                              jax_configs.SHAPES[name]))


def test_unported_families_raise():
    for arch in ("mamba2-1.3b", "deepseek-v3-671b", "whisper-small",
                 "zamba2-7b", "llama-3.2-vision-11b", "kimi-k2-1t-a32b"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 row"):
            configs.get_smoke_config(arch)
    moe = dataclasses.replace(configs.get_smoke_config("granite-3-2b"),
                              family="moe")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 row 15"):
        T.init_params(0, moe, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 row"):
        T.init_decode_state(dataclasses.replace(moe, family="ssm"), 1, 4,
                            device="cpu")


def test_port_init_is_seeded_and_shaped():
    cfg = configs.get_smoke_config("qwen1.5-4b")
    a = T.init_params(0, cfg, device="cpu")
    b = T.init_params(0, cfg, device="cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert x.dtype == torch.bfloat16 and not x.requires_grad
    lp = a["layers"][0]
    assert lp["attn"]["wq"].shape == (64, 4, 16)
    assert lp["attn"]["wo"].shape == (4, 16, 64)
    assert lp["attn"]["bk"].shape == (4, 16)
    assert a["unembed"].shape == (64, cfg.vocab)
    total = sum(p.numel() for p in a.parameters())
    assert total == cfg.param_count()[0] + 2 * cfg.n_layers * 64 + 64 \
        + cfg.n_layers * (4 + 4 + 4) * 16
