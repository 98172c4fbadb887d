"""The port's LM stack (plain PyTorch on the CPU) against the JAX package
on the same weights: ``forward`` (prefill) and ``decode_step`` logits, the
prefill and serve steps, and ``serve()``'s tokens, for the
``granite-smoke`` (GQA, g = 4) and ``qwen-smoke`` (QKV bias, KVH = H)
dense configs, the MoE ``kimi-smoke`` (GQA, 8 experts top-2 + 1 shared)
and ``dsv3-smoke`` (MLA) configs, the SSM ``mamba2-smoke`` and the hybrid
``zamba2-smoke`` (4 Mamba2 layers, the shared attention block after
layers 1 and 3), in fp32 and bf16.

The reference builds the weights (``init_params``); its norms and biases
(and the SSM's A_log, D, dt_bias and norm_g) are then redrawn from a numpy
generator so that every multiply is exercised, and the port receives the
same tree through ``convert.lm_params_from_arrays``.
The reference runs with ``USE_FLASH = False`` (its flash kernel cannot run
compiled on the CPU): its prefill attention is ``_sdpa``, the port's the
flash kernel's plain version.

The MoE configs (and zamba2's shared attention: the reference's ``_sdpa``
rounds its scores to bf16, the port's flash path does not) are run
against the reference's flash path.  The MoE configs route each token to
its top-k experts, and a one-ulp bf16
difference upstream can swap two experts whose router probabilities
nearly tie; such a token's logits then move by far more than a rounding.
So for them the reference runs as the port computes, op by op: its
attention through its Pallas flash kernel in interpret mode (the prefill
path it takes on its TPU; the port's plain flash version gives its bits),
and in bf16 outside ``jit`` (under ``jit`` XLA's CPU compiler drops some
bf16 round trips: on the forward test's input its jitted kimi-smoke logits
differ from its op-by-op ones by 0.23 of their scale, a swapped route).
The port's bf16 SwiGLU rounds its sigmoid as the reference's does
(``models.common.silu``), and its rope has the reference's bits
(``models.common.sin_cos``, ``tests/test_torch_rope.py``).  On these inputs
no route differs; over 2048 tokens a few do, from the sum order of the
bf16 products (:func:`test_route_swap_rate`).

Tolerances, on logits relative to their largest magnitude: fp32 1e-5 (the
two frameworks sum in other orders); bf16 3e-2 (the reference rounds
scores to bf16 before the softmax, the port's flash path does not, and
both round every activation to bf16).  Greedy tokens are exact in fp32 and
bf16.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.launch import serve_lm as jax_serve
from repro.kernels import flash_attention as jax_FA
from repro.launch import steps as jax_steps
from repro.models import attention as jax_A
from repro.models import transformer as jax_T
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm, steps
from repro_torch.models import transformer as T

MOE = ["kimi-k2-1t-a32b", "deepseek-v3-671b"]
SSM = ["mamba2-1.3b", "zamba2-7b"]
# the reference's prefill attention through its flash kernel, op by op
FLASH_REF = [*MOE, "zamba2-7b"]
ARCHS = ["granite-3-2b", "qwen1.5-4b", *MOE, *SSM]
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

    def redraw(node, name, centre, spread):
        a = node[name]
        node[name] = (centre + spread * rng.normal(size=a.shape)).astype(
            a.dtype)

    layers = tree["layers"]
    for name in ("ln1", "ln2", "ln"):
        if name in layers:
            redraw(layers, name, 1, 0.2)
    redraw(tree, "ln_f", 1, 0.2)
    for name in ("bq", "bk", "bv"):
        if name in layers.get("attn", {}):
            redraw(layers["attn"], name, 0, 0.3)
    if "mamba" in layers:        # D = 1 and dt_bias = 0 would hide a term
        mamba = layers["mamba"]
        mamba["A_log"] = (mamba["A_log"] + 0.3 * rng.normal(
            size=mamba["A_log"].shape)).astype(np.float32)
        redraw(mamba, "D", 1, 0.5)
        redraw(mamba, "dt_bias", 0, 0.5)
        redraw(mamba, "norm_g", 1, 0.2)
    if "shared_attn" in tree:
        for name in ("ln1", "ln2"):
            redraw(tree["shared_attn"], name, 1, 0.2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    return jcfg, jparams, cfg, convert.lm_params_from_arrays(tree, cfg, "cpu")


@contextlib.contextmanager
def _reference_run(arch: str, prec: str):
    """How the reference runs for ``arch`` in these tests (see the module
    docstring): as it is for the dense archs and mamba2; for the MoE archs
    and zamba2 its attention through its flash kernel in interpret mode
    and, in bf16, op by op."""
    if arch not in FLASH_REF:
        yield
        return
    saved = jax_A.USE_FLASH, jax_FA.flash_attention
    jax_A.USE_FLASH = True
    jax_FA.flash_attention = functools.partial(saved[1], interpret=True)
    try:
        with jax.disable_jit() if prec == "bf16" else contextlib.nullcontext():
            yield
    finally:
        jax_A.USE_FLASH, jax_FA.flash_attention = saved


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
    with _reference_run(arch, prec):
        want, waux = jax_T.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(params, torch.from_numpy(toks).long(), cfg)
    assert got.dtype == cfg.dtype and got.shape == (2, 16, cfg.vocab)
    assert aux.dtype == torch.float32
    if arch in MOE:             # the sum of the layers' lb_loss
        assert float(aux) == pytest.approx(float(waux), rel=TOL[prec])
    else:
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
    assert sorted(state.caches) == sorted(jstate.caches)
    for t in range(s):
        step = toks[:, t:t + 1]
        with _reference_run(arch, prec):
            want, jstate = jax_T.decode_step(jparams, jnp.asarray(step),
                                             jstate, jcfg)
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
    with _reference_run(arch, prec):
        want = jax_steps.make_prefill_step(jcfg)(
            jparams, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    got = steps.make_prefill_step(cfg)(params, batch)
    assert got.shape == (3, cfg.vocab)
    _close(got, want, prec)
    first = toks[:, :1]
    with _reference_run(arch, prec):
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
@pytest.mark.parametrize("arch", ["granite-3-2b", *MOE, *SSM])
def test_serve_tokens_match_reference(arch, prec):
    """The MoE archs: the port decodes the batch with per-row positions,
    the reference one row at a time (vmap); MoE capacity is counted per
    row, so each row routes alike in both.  (The reference's jitted step
    gives other bf16 tokens on one request of each MoE arch here: a route
    swapped by its compiler's dropped bf16 round trips, see the module
    docstring.)"""
    jcfg, jparams, cfg, params = _models(arch, prec)
    prompts = _serve_prompts(cfg)
    with _reference_run(arch, prec):
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


@pytest.mark.parametrize("arch", DENSE + MOE + SSM)
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


@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_moe_and_mla_configs_match(arch):
    """``moe_cfg`` and ``mla_cfg`` of every architecture, field for field
    (the router's dtype: fp32 in both)."""
    want = jax_configs.get_config(arch)
    fields = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    got = T.ModelConfig(**dict(fields, dtype=torch.bfloat16))
    for name in ("moe_cfg", "mla_cfg"):
        g, w = getattr(got, name)(), getattr(want, name)()
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name == "router_dtype":
                assert a == torch.float32 and jnp.dtype(b) == jnp.float32
            else:
                assert a == b, (name, f.name)


@pytest.mark.parametrize("arch", MOE)
def test_port_moe_init_is_seeded_and_shaped(arch):
    """The port's seeded init: the reference's names and shapes, the
    router in fp32, every other weight in the model's dtype, and the
    parameter count of ``param_count`` plus the norms."""
    cfg = configs.get_smoke_config(arch)
    a = T.init_params(0, cfg, device="cpu")
    b = T.init_params(0, cfg, device="cpu")
    jcfg, jparams, _, _ = _models(arch, "bf16")
    want = {"/".join(str(getattr(k, "key", k)) for k in path): v.shape[1:]
            for path, v in jax.tree_util.tree_flatten_with_path(
                jparams["layers"])[0]}
    lp = a["layers"][0]
    got = {name: tuple(p.shape) for name, p in lp.named_parameters()}
    got = {k.replace(".", "/"): v for k, v in got.items()}
    assert got == {k: tuple(v) for k, v in want.items()}
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert not x.requires_grad
        assert x.dtype == (torch.float32 if name.endswith("router")
                           else torch.bfloat16), name
    total = sum(p.numel() for p in a.parameters())
    assert total == cfg.param_count()[0] + 2 * cfg.n_layers * cfg.d_model \
        + cfg.d_model


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_dispatch_and_layer_aux(arch, monkeypatch):
    """kimi-k2's prefill attention goes through the flash dispatch once a
    layer, deepseek-v3's MLA never; ``layer_aux`` gets each layer's
    ``lb_loss`` (their sum is the aux), ``drop_frac`` and routes, and
    ``decode_step`` fills it as the forward does."""
    _, _, cfg, params = _models(arch, "fp32")
    calls = []
    real = ops.FA.flash_attention_plain
    monkeypatch.setattr(ops.FA, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    layer_aux = []
    _, aux = T.forward(params, toks, cfg, layer_aux=layer_aux)
    assert len(calls) == (0 if cfg.use_mla else cfg.n_layers)
    assert len(layer_aux) == cfg.n_layers
    assert float(aux) == pytest.approx(
        sum(float(a["lb_loss"]) for a in layer_aux), rel=1e-6)
    for a in layer_aux:
        assert float(a["drop_frac"]) == 0.0
        assert a["expert_ids"].shape == (2, 8, cfg.top_k)
    state = T.init_decode_state(cfg, 2, 4, device="cpu")
    if cfg.use_mla:
        assert list(state.caches) == ["latent"]
        assert state.caches["latent"].shape == (cfg.n_layers, 2, 4, 512 + 64)
    step_aux = []
    T.decode_step(params, toks[:, :1], state, cfg, layer_aux=step_aux)
    assert [a["expert_ids"].shape for a in step_aux] == \
        [(2, 1, cfg.top_k)] * cfg.n_layers


@pytest.mark.parametrize("arch", SSM)
def test_port_ssm_init_is_seeded_and_shaped(arch):
    """The port's seeded init for mamba2 and zamba2: the reference's names
    and shapes a layer (and the hybrid's shared block), A_log, D and
    dt_bias in fp32, every other weight in the model's dtype, and the
    parameter count of ``param_count`` plus the norms and the SSM's
    per-head vectors."""
    cfg = configs.get_smoke_config(arch)
    a = T.init_params(0, cfg, device="cpu")
    b = T.init_params(0, cfg, device="cpu")
    _, jparams, _, _ = _models(arch, "bf16")

    def shapes(tree, lead):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                tuple(v.shape[lead:])
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def named(module):
        return {k.replace(".", "/"): tuple(p.shape)
                for k, p in module.named_parameters()}

    assert named(a["layers"][0]) == shapes(jparams["layers"], 1)
    if cfg.family == "hybrid":
        assert named(a["shared_attn"]) == shapes(jparams["shared_attn"], 0)
    else:
        assert not hasattr(a, "shared_attn")
    fp32 = ("A_log", "D", "dt_bias")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert not x.requires_grad
        assert x.dtype == (torch.float32 if name.endswith(fp32)
                           else torch.bfloat16), name
    heads = cfg.ssm_cfg().heads
    extra = cfg.n_layers * (cfg.d_model + cfg.ssm_cfg().d_inner
                            + 3 * heads) + cfg.d_model
    if cfg.family == "hybrid":
        extra += 2 * cfg.d_model
    total = sum(p.numel() for p in a.parameters())
    assert total == cfg.param_count()[0] + extra


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_mamba2_forward_over_three_chunks(prec, monkeypatch):
    """mamba2-smoke at S = 300: three chunks of 100 under the default chunk
    of 128, so the inter-chunk loop carries state through the model.

    In fp32 one token of this input (row 1, position 87) cancels: each
    package's logits there lie 7–8e-6 of the scale off the exact ones, in
    opposite directions, 1.5e-5 apart.  So both are held to the exact
    forward (the port's own in fp64: every fp32 cast made fp64) within the
    fp32 tolerance, and to each other within twice it.  bf16: the port
    against the reference within the bf16 tolerance."""
    jcfg, jparams, cfg, params = _models("mamba2-1.3b", prec)
    assert cfg.ssm_cfg().chunk == 128
    toks = _tokens(cfg, 2, 300, seed=13)
    with _reference_run("mamba2-1.3b", prec):
        want, _ = jax_T.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = T.forward(params, torch.from_numpy(toks).long(), cfg)
    assert float(aux) == 0.0
    if prec == "bf16":
        _close(got, want, prec)
        return
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  jparams)
    c64 = dataclasses.replace(cfg, dtype=torch.float64)
    p64 = convert.lm_params_from_arrays(tree, c64, "cpu")
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    exact, _ = T.forward(p64, torch.from_numpy(toks).long(), c64)
    monkeypatch.undo()
    assert exact.dtype == torch.float64
    _close(got, exact.numpy(), prec)
    _close(torch.from_numpy(np.array(want)), exact.numpy(), prec)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 2 * TOL[prec], err


@pytest.mark.parametrize("arch", SSM)
def test_ssm_dispatch_and_decode_caches(arch, monkeypatch):
    """mamba2 runs no attention; zamba2's shared block goes through the
    flash dispatch once per application (after layers 1 and 3 of 4 at
    ``attn_every`` 2); the decode caches are the reference's: the fp32
    state (L, B, H, P, N) and, for the hybrid, one KV cache per
    application, each written only by its own application."""
    jcfg, _, cfg, params = _models(arch, "fp32")
    calls = []
    real = ops.FA.flash_attention_plain
    monkeypatch.setattr(ops.FA, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    T.forward(params, toks, cfg)
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert len(calls) == n_attn
    state = T.init_decode_state(cfg, 2, 5, device="cpu")
    jstate = jax_T.init_decode_state(jcfg, 2, 5)
    for name, buf in state.caches.items():
        assert tuple(buf.shape) == jstate.caches[name].shape, name
    c = cfg.ssm_cfg()
    assert state.caches["state"].shape == (cfg.n_layers, 2, c.heads,
                                           c.d_head, c.d_state)
    assert state.caches["state"].dtype == torch.float32
    _, state = T.decode_step(params, toks[:, :1], state, cfg)
    assert bool((state.caches["state"] != 0).any(-1).any(-1).all())
    if n_attn:
        written = state.caches["k"][:, :, 0].abs().sum((1, 2, 3))
        assert bool((written > 0).all()) and len(written) == n_attn
        assert not bool(state.caches["k"][:, :, 1:].any())


@pytest.mark.parametrize("arch", SSM)
def test_serve_cli_runs_the_ssm_archs(arch, capsys):
    serve_lm.main(["--arch", arch, "--device", "cpu", "--requests", "6",
                   "--batch", "3", "--max-new", "6", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "served 6 requests" in out and "request lengths" in out


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_the_moe_archs(arch, capsys):
    serve_lm.main(["--arch", arch, "--device", "cpu", "--requests", "6",
                   "--batch", "3", "--max-new", "6", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "served 6 requests" in out and "request lengths" in out


def test_unported_families_raise():
    """Every family is ported: whisper and the VLM load and build; a family
    that is none of the reference's six still raises."""
    for arch in ("whisper-small", "llama-3.2-vision-11b"):
        cfg = configs.get_smoke_config(arch)
        assert cfg.family in T.PORTED_FAMILIES
        assert configs.get_config(arch).family == cfg.family
        T.init_params(0, cfg, device="cpu")
    unknown = dataclasses.replace(configs.get_smoke_config("granite-3-2b"),
                                  family="retnet")
    with pytest.raises(ValueError, match="unknown model family 'retnet'"):
        T.init_params(0, unknown, device="cpu")
    with pytest.raises(ValueError, match="unknown model family 'retnet'"):
        T.init_decode_state(unknown, 1, 4, device="cpu")


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


# the tokens whose route differs from the reference's in some layer, over
# ROUTE_SEEDS × 4 × 64 tokens (measured, before the rope repair and after)
ROUTE_SEEDS = range(8)
ROUTE_SWAPS = {"kimi-k2-1t-a32b": 5, "deepseek-v3-671b": 5}


@pytest.mark.parametrize("arch", MOE)
def test_route_swap_rate(arch, monkeypatch):
    """Near ties: the share of bf16 tokens that some MoE layer routes to
    another expert set than the reference's (run op by op, its attention
    through its flash kernel), held at what was measured: 5 of 2048 for
    each arch.  rope has the reference's bits, so the swaps come from the
    fp32 sum order of the bf16 products upstream of the router (x @ W:
    0.4 % of a projection's elements a bf16 ulp apart) and of rms_norm's
    mean."""
    jcfg, jparams, cfg, params = _models(arch, "bf16")
    real = jax.lax.top_k
    routes = []

    def recording_top_k(x, k):
        out = real(x, k)
        routes.append(np.sort(np.asarray(out[1]), -1))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    swapped = total = 0
    for seed in ROUTE_SEEDS:
        toks = _tokens(cfg, 4, 64, seed=seed)
        routes.clear()
        with _reference_run(arch, "bf16"):
            jax_T.forward(jparams, jnp.asarray(toks), jcfg)
        layer_aux = []
        T.forward(params, torch.from_numpy(toks).long(), cfg,
                  layer_aux=layer_aux)
        assert len(routes) == len(layer_aux) == cfg.n_layers
        other = np.zeros(toks.shape, bool)
        for want, aux in zip(routes, layer_aux):
            got = np.sort(aux["expert_ids"].numpy(), -1)
            other |= (got != want).any(-1)
        swapped += int(other.sum())
        total += toks.size
    assert total == 2048
    assert swapped <= ROUTE_SWAPS[arch], (swapped, total)
