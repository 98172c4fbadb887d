"""The port's encoder-decoder and VLM families (plain PyTorch on the CPU)
against the JAX package on the same weights: ``whisper-smoke`` (an encoder
of 2 layers over 32 stub frames, a decoder of 2 layers with cross-attention,
the gelu MLP with biases, learned positions) and ``llama-vision-smoke`` (4
dense layers, GQA 4/2, a cross layer to 16 stub patches after layers 1 and
3), in fp32 and bf16: ``encode``, ``forward``, ``decode_step`` with
``enc_out`` / ``patches``, the prefill and serve steps, cross
``attn_apply`` alone, the bf16 gelu, the weights' conversion, and the
flash dispatch's launches a path.

The reference builds the weights (``init_params``); its norms and the gelu
MLP's biases are then redrawn from a numpy generator so that every multiply
and add is exercised, and the port receives the same tree through
``convert.lm_params_from_arrays``.  The reference runs its full-sequence
and cross attention through its Pallas flash kernel in interpret mode (the
path its TPU takes; at these sizes its blocks are whole sequences) and, in
bf16, op by op (``jax.disable_jit()``), as ``tests/test_torch_lm.py`` runs
the MoE and hybrid archs.

The VLM's decode runs its cross layers after all the dense layers, as the
reference's ``decode_step`` does, while its forward runs one after every
second layer: the port's decode is held to the reference's decode, and
:func:`test_reference_vlm_decode_differs_from_its_forward` states that the
reference's own decode and forward differ.

Tolerances, on outputs relative to their largest magnitude: fp32 1e-5 (the
two frameworks sum in other orders; these inputs read at most 7e-7); bf16
3e-2 (as the dense tests: both round every activation to bf16, in sums of
other orders; op by op, most of these bf16 comparisons are bit for bit, the
largest reads 8.2e-3, and the jitted reference reads up to 1.3e-2).  Greedy tokens
are exact in fp32 and bf16.  The bf16 gelu is the reference's bit for bit
on every bf16 input of magnitude 2⁻¹²⁵ or more (below it XLA's CPU backend
flushes the subnormal products to ±0).
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
from repro.kernels import flash_attention as jax_FA
from repro.launch import serve_lm as jax_serve
from repro.launch import steps as jax_steps
from repro.models import attention as jax_A
from repro.models import common as jax_C
from repro.models import transformer as jax_T
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_lm, steps
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T

ARCHS = ["whisper-small", "llama-3.2-vision-11b"]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 3e-2}
PRECS = list(DTYPES)


@functools.lru_cache(maxsize=None)
def _models(arch: str, prec: str):
    """(reference config, reference params, port config, port params)."""
    jdt, tdt = DTYPES[prec]
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), dtype=jdt)
    jparams, _ = jax_T.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(17)

    def redraw(node, name, centre, spread):
        a = node[name]
        node[name] = (centre + spread * rng.normal(size=a.shape)).astype(
            a.dtype)

    stacks = [tree["layers"]] + [tree[k] for k in ("enc_layers",)
                                 if k in tree]
    for layers in stacks:
        for name in ("ln1", "ln2", "ln3"):
            if name in layers:
                redraw(layers, name, 1, 0.2)
        if "b_up" in layers["mlp"]:            # gelu's biases are zeros
            redraw(layers["mlp"], "b_up", 0, 0.3)
            redraw(layers["mlp"], "b_down", 0, 0.3)
    for name in ("ln_f", "enc_ln_f", "ln_cross"):
        if name in tree:
            redraw(tree, name, 1, 0.2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    return jcfg, jparams, cfg, convert.lm_params_from_arrays(tree, cfg, "cpu")


@contextlib.contextmanager
def _reference_run(prec: str):
    """The reference's attention through its Pallas flash kernel in
    interpret mode and, in bf16, op by op."""
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


def _both(a, jdt):
    """An fp32 numpy array in the model's dtype in both packages, the same
    bits: (jax array, tensor)."""
    j = jnp.asarray(a, jdt)
    return j, convert.tensor_from_array(np.asarray(j), "cpu")


def _frontend(jcfg, b, seed=11):
    """The stub frontend's embeddings: frames (encdec) or patches (vlm),
    N(0, 1) from a numpy generator.  Returns (key, jax array, tensor)."""
    key, n = (("frames", jcfg.enc_len) if jcfg.family == "encdec"
              else ("patches", jcfg.n_patches))
    a = np.random.default_rng(seed).normal(size=(b, n, jcfg.d_model))
    return (key, *_both(a.astype(np.float32), jcfg.dtype))


def _close(got: torch.Tensor, want, prec: str) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= TOL[prec], (err, TOL[prec])
    return err


@functools.lru_cache(maxsize=None)
def _decode_extra(arch, prec, b):
    """The decode steps' extra in both packages: whisper's ``enc_out``
    (the reference's ``encode`` of the frames, carried over bit for bit,
    so the decode is held alone) or the VLM's patches."""
    jcfg, jparams, _, _ = _models(arch, prec)
    key, jx, tx = _frontend(jcfg, b)
    if key == "patches":
        return {key: jx}, {key: tx}
    with _reference_run(prec):
        enc = jax_T.encode(jparams, jx, jcfg)
    return ({"enc_out": enc},
            {"enc_out": convert.tensor_from_array(np.asarray(enc), "cpu")})


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copied_value_for_value(arch):
    for getter in ("get_config", "get_smoke_config"):
        want = getattr(jax_configs, getter)(arch)
        got = getattr(configs, getter)(arch)
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.bfloat16
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("prec", PRECS)
def test_encode_matches(prec):
    jcfg, jparams, cfg, params = _models("whisper-small", prec)
    _, jx, tx = _frontend(jcfg, 2)
    with _reference_run(prec):
        want = jax_T.encode(jparams, jx, jcfg)
    got = T.encode(params, tx, cfg)
    assert got.dtype == cfg.dtype and got.shape == (2, cfg.enc_len,
                                                    cfg.d_model)
    _close(got, want, prec)
    # fewer frames than enc_len: the first rows of the positions
    with _reference_run(prec):
        want = jax_T.encode(jparams, jx[:, :20], jcfg)
    _close(T.encode(params, tx[:, :20], cfg), want, prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch, prec):
    jcfg, jparams, cfg, params = _models(arch, prec)
    toks = _tokens(cfg, 2, 12)
    key, jx, tx = _frontend(jcfg, 2)
    with _reference_run(prec):
        want, waux = jax_T.forward(jparams, jnp.asarray(toks), jcfg,
                                   {key: jx})
    got, aux = T.forward(params, torch.from_numpy(toks).long(), cfg,
                         {key: tx})
    assert got.dtype == cfg.dtype and got.shape == (2, 12, cfg.vocab)
    assert float(aux) == float(waux) == 0.0
    _close(got, want, prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match(arch, prec):
    """Six decode steps against the reference's ``decode_step`` with the
    same ``enc_out`` / patches (the VLM in the reference's decode order)."""
    jcfg, jparams, cfg, params = _models(arch, prec)
    b, s = 2, 6
    toks = _tokens(cfg, b, s, seed=5)
    jextra, extra = _decode_extra(arch, prec, b)
    jstate = jax_T.init_decode_state(jcfg, b, s + 1)
    state = T.init_decode_state(cfg, b, s + 1, device="cpu")
    assert sorted(state.caches) == sorted(jstate.caches) == ["k", "v"]
    for name, buf in state.caches.items():
        assert tuple(buf.shape) == jstate.caches[name].shape
    for t in range(s):
        step = toks[:, t:t + 1]
        with _reference_run(prec):
            want, jstate = jax_T.decode_step(jparams, jnp.asarray(step),
                                             jstate, jcfg, jextra)
        got, state = T.decode_step(params, torch.from_numpy(step).long(),
                                   state, cfg, extra)
        _close(got, want, prec)
    assert int(state.position) == s


@pytest.mark.parametrize("prec", PRECS)
def test_whisper_decode_matches_its_forward(prec):
    """Step-by-step decode on ``encode``'s output gives the forward's
    logits at every position (the reference's own criterion: argmax
    agreement > 0.9), within the tolerance."""
    jcfg, _, cfg, params = _models("whisper-small", prec)
    b, s = 2, 6
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=9)).long()
    _, _, frames = _frontend(jcfg, b)
    full, _ = T.forward(params, toks, cfg, {"frames": frames})
    extra = {"enc_out": T.encode(params, frames, cfg)}
    state = T.init_decode_state(cfg, b, s + 1, device="cpu")
    outs = []
    for t in range(s):
        logits, state = T.decode_step(params, toks[:, t:t + 1], state, cfg,
                                      extra)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    assert (dec.argmax(-1) == full.argmax(-1)).float().mean().item() > 0.9
    _close(dec, full.float().numpy(), prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match(arch, prec):
    """``make_prefill_step`` with ``frames`` / ``patches`` in the batch,
    then four greedy ``make_serve_step`` tokens with ``enc_out`` /
    ``patches``, each fed back: the same tokens as the reference's."""
    jcfg, jparams, cfg, params = _models(arch, prec)
    b = 2
    toks = _tokens(cfg, b, 8, seed=11)
    key, jx, tx = _frontend(jcfg, b)
    with _reference_run(prec):
        want = jax_steps.make_prefill_step(jcfg)(
            jparams, {"tokens": jnp.asarray(toks), key: jx})
    got = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks).long(), key: tx})
    assert got.shape == (b, cfg.vocab)
    _close(got, want, prec)

    jextra, extra = _decode_extra(arch, prec, b)
    jstate = jax_T.init_decode_state(jcfg, b, 8)
    state = T.init_decode_state(cfg, b, 8, device="cpu")
    jnxt = jnp.asarray(toks[:, :1])
    nxt = torch.from_numpy(toks[:, :1]).long()
    jstep, step = jax_steps.make_serve_step(jcfg), steps.make_serve_step(cfg)
    for _ in range(4):
        with _reference_run(prec):
            jnxt, jstate = jstep(jparams, {"tokens": jnxt, **jextra}, jstate)
        nxt, state = step(params, {"tokens": nxt.long(), **extra}, state)
        assert nxt.dtype == torch.int32 and nxt.shape == (b, 1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    assert int(state.position) == int(jstate.position) == 4


@pytest.mark.parametrize("prec", PRECS)
def test_whisper_decode_positions_clamp_into_the_table(prec):
    """A decode step at a position past the 32768 learned positions reads
    the last row, as the reference's ``dynamic_slice_in_dim`` clamps."""
    jcfg, jparams, cfg, params = _models("whisper-small", prec)
    b = 2
    jextra, extra = _decode_extra("whisper-small", prec, b)
    toks = _tokens(cfg, b, 1, seed=21)
    for pos in (T.DEC_POSITIONS - 1, T.DEC_POSITIONS + 5):
        jstate = jax_T.init_decode_state(jcfg, b, 4)._replace(
            position=jnp.asarray(pos, jnp.int32))
        state = T.init_decode_state(cfg, b, 4, device="cpu")._replace(
            position=torch.tensor(pos, dtype=torch.int32))
        with _reference_run(prec):
            want, _ = jax_T.decode_step(jparams, jnp.asarray(toks), jstate,
                                        jcfg, jextra)
        got, _ = T.decode_step(params, torch.from_numpy(toks).long(), state,
                               cfg, extra)
        _close(got, want, prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("s,t,h,kvh", [(5, 13, 4, 2), (1, 16, 6, 3),
                                       (12, 7, 4, 4)])
def test_cross_attn_apply_matches(s, t, h, kvh, prec):
    """``attn_apply`` with ``kv_input`` alone, S ≠ T, GQA, rope and QKV bias
    configured (cross-attention turns nothing and masks nothing), against
    the reference's; a cache passed beside ``kv_input`` is neither read nor
    written, and none is returned."""
    jdt, tdt = DTYPES[prec]
    dm, dh = 32, 16
    cfg = A.AttnConfig(dm, h, kvh, dh, qkv_bias=True, rope=True,
                       causal=True)
    jcfg = jax_A.AttnConfig(dm, h, kvh, dh, qkv_bias=True, rope=True,
                            causal=True)
    jp, _ = jax_A.attn_init(jax.random.key(4), jcfg, jdt)
    rng = np.random.default_rng(s * t + h)
    jp = {k: (jnp.asarray(0.3 * rng.normal(size=v.shape), jdt)
              if k.startswith("b") else v) for k, v in jp.items()}
    params = {k: convert.tensor_from_array(np.asarray(v), "cpu")
              for k, v in jp.items()}
    jx, x = _both(rng.normal(size=(2, s, dm)).astype(np.float32), jdt)
    jkv, kv = _both(rng.normal(size=(2, t, dm)).astype(np.float32), jdt)
    with _reference_run(prec):
        want, _ = jax_A.attn_apply(jp, jx, jcfg, kv_input=jkv)
    got, new = A.attn_apply(params, x, cfg, kv_input=kv)
    assert new is None and got.shape == (2, s, dm) and got.dtype == tdt
    _close(got, want, prec)
    cache = A.init_kv_cache(2, 4, cfg, tdt, "cpu")
    again, new = A.attn_apply(params, x, cfg, cache=cache, kv_input=kv)
    assert new is None and torch.equal(again, got)
    assert not cache.k.any() and not cache.v.any()


def _bf16_all():
    """Every finite bf16 value below 10⁴ in magnitude: (jax, torch)."""
    bits = np.arange(2 ** 16, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    x = x[torch.isfinite(x.float()) & (x.float().abs() < 1e4)]
    j = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    return j, x


def test_bf16_gelu_is_the_references_bit_for_bit():
    """``common.gelu`` on every bf16 input against ``jax.nn.gelu(
    approximate=True)`` jitted and op by op: equal on |x| ≥ 2⁻¹²⁵; below
    it the reference flushes the subnormal products to ±0.  (``F.gelu``,
    one rounding, differs on about 3 % of the inputs.)"""
    jx, x = _bf16_all()
    got = C.gelu(x)
    bits = got.view(torch.int16).numpy()
    for ctx in (contextlib.nullcontext(), jax.disable_jit()):
        with ctx:
            want = np.asarray(jax.nn.gelu(jx, approximate=True))
        wbits = want.view(np.int16)
        normal = x.float().abs().numpy() >= 2.0 ** -125
        np.testing.assert_array_equal(bits[normal], wbits[normal])
        assert not want[~normal].astype(np.float32).any()
    one_rounding = torch.nn.functional.gelu(x, approximate="tanh")
    assert (one_rounding != got).float().mean().item() > 0.02


@pytest.mark.parametrize("prec", PRECS)
def test_gelu_mlp_matches(prec):
    """The gelu MLP with biases: bit for bit in bf16 (op by op in the
    reference; both products sum K = 64 and 128 bf16-exact terms in fp32,
    rounded once), within 1e-6 of the scale in fp32."""
    jdt, _ = DTYPES[prec]
    rng = np.random.default_rng(23)
    arrs = [rng.normal(size=shape).astype(np.float32) * sc for shape, sc in
            (((4, 9, 64), 1.0), ((64, 128), 0.125), ((128,), 0.3),
             ((128, 64), 0.09), ((64,), 0.3))]
    pairs = [_both(a, jdt) for a in arrs]
    with jax.disable_jit() if prec == "bf16" else contextlib.nullcontext():
        want = np.asarray(jax_C.gelu_mlp(*(j for j, _ in pairs)), np.float32)
    got = C.gelu_mlp(*(t for _, t in pairs)).float().numpy()
    if prec == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    """Every leaf of the reference's tree comes back from the port's
    parameters with its name, shape, dtype and bits: the stacked layers
    (a decoder layer's ``self`` / ``cross``, the encoder's, the VLM's
    cross layers) one entry a layer."""
    _, jparams, _, params = _models(arch, "bf16")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    stacked = {"layers", "enc_layers", "cross_layers"}
    seen = 0
    for path, want in flat:
        names = [str(getattr(k, "key", k)) for k in path]
        want = np.asarray(want)
        if names[0] in stacked:
            for i in range(want.shape[0]):
                node = params[names[0]][i]
                for n in names[1:]:
                    node = node[n]
                got = convert.array_from_tensor(node)
                np.testing.assert_array_equal(got, want[i].view(got.dtype))
                seen += 1
        else:
            got = convert.array_from_tensor(params[names[0]])
            np.testing.assert_array_equal(got, want.view(got.dtype))
            seen += 1
    assert seen == sum(1 for _ in params.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_is_seeded_and_shaped(arch):
    """The port's seeded init: the reference's names and shapes (a layer's
    and each top-level leaf's), every weight in the model's dtype, and
    ``param_count`` plus the norms, biases and position tables."""
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

    for stack in ("layers", "enc_layers", "cross_layers"):
        if stack in jparams:
            want = shapes(jparams[stack], 1)
            assert all(named(lp) == want for lp in a[stack]), stack
    for name, leaf in jparams.items():
        if not isinstance(leaf, dict):
            assert tuple(a[name].shape) == leaf.shape, name
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
        assert x.dtype == torch.bfloat16 and not x.requires_grad
    dm, total = cfg.d_model, sum(p.numel() for p in a.parameters())
    if cfg.family == "encdec":
        extra = (cfg.n_layers * (3 * dm + cfg.d_ff + dm)
                 + cfg.n_enc_layers * (2 * dm + cfg.d_ff + dm) + dm
                 + (cfg.enc_len + T.DEC_POSITIONS) * dm)
    else:
        extra = (2 * cfg.n_layers + cfg.n_layers // cfg.cross_attn_every)*dm
    assert total == cfg.param_count()[0] + extra + dm


def test_flash_dispatch_launches_a_path(monkeypatch):
    """Every full-sequence and cross attention goes through the flash
    dispatch: whisper's prefill once an encoder layer and twice a decoder
    layer, ``encode`` once a layer, a decode step once a decoder layer
    (its cross-attention; the self-attention reads the cache); the VLM's
    prefill once a layer and once a cross layer, a decode step once a
    cross layer.  ``kernels="cuda"`` on CPU tensors raises."""
    calls = []
    real = ops.FA.flash_attention_plain
    monkeypatch.setattr(ops.FA, "flash_attention_plain",
                        lambda *a, **k: calls.append(k["causal"])
                        or real(*a, **k))

    def count(fn):
        calls.clear()
        fn()
        return len(calls), sum(calls)

    for arch in ARCHS:
        jcfg, _, cfg, params = _models(arch, "fp32")
        key, _, tx = _frontend(jcfg, 2)
        toks = torch.from_numpy(_tokens(cfg, 2, 8)).long()
        state = T.init_decode_state(cfg, 2, 4, device="cpu")
        n_cross = (cfg.n_layers if cfg.family == "encdec"
                   else cfg.n_layers // cfg.cross_attn_every)
        if cfg.family == "encdec":
            assert count(lambda: T.encode(params, tx, cfg)) == (
                cfg.n_enc_layers, 0)
            extra = {"enc_out": T.encode(params, tx, cfg)}
            prefill = (cfg.n_enc_layers + 2 * cfg.n_layers, cfg.n_layers)
        else:
            extra = {key: tx}
            prefill = (cfg.n_layers + n_cross, cfg.n_layers)
        assert count(lambda: T.forward(params, toks, cfg, {key: tx})) == \
            prefill
        assert count(lambda: T.decode_step(params, toks[:, :1], state, cfg,
                                           extra)) == (n_cross, 0)
        with pytest.raises(ValueError, match="cuda"):
            T.forward(params, toks, cfg, {key: tx}, kernels="cuda")
        with pytest.raises(ValueError, match="cuda"):
            T.decode_step(params, toks[:, :1], state, cfg, extra,
                          kernels="cuda")


@pytest.mark.parametrize("prec", ["fp32"])
def test_reference_vlm_decode_differs_from_its_forward(prec):
    """A fact of the reference: its VLM decode runs all dense layers, then
    all cross layers, while its forward runs a cross layer after every
    ``cross_attn_every``-th dense layer; so its own decode does not give
    its forward's logits (its ``test_decode_matches_prefill`` leaves the
    VLM out).  The port's decode follows the reference's decode."""
    jcfg, jparams, cfg, params = _models("llama-3.2-vision-11b", prec)
    b, s = 2, 4
    toks = _tokens(cfg, b, s, seed=9)
    _, jx, tx = _frontend(jcfg, b)
    with _reference_run(prec):
        full, _ = jax_T.forward(jparams, jnp.asarray(toks), jcfg,
                                {"patches": jx})
    jstate = jax_T.init_decode_state(jcfg, b, s + 1)
    state = T.init_decode_state(cfg, b, s + 1, device="cpu")
    outs, mine = [], []
    for t in range(s):
        with _reference_run(prec):
            logits, jstate = jax_T.decode_step(
                jparams, jnp.asarray(toks[:, t:t + 1]), jstate, jcfg,
                {"patches": jx})
        outs.append(np.asarray(logits[:, 0]))
        got, state = T.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]).long(), state, cfg, {"patches": tx})
        mine.append(got[:, 0])
    dec, full = np.stack(outs, 1), np.asarray(full)
    assert np.abs(dec - full).max() / np.abs(full).max() > 100 * TOL[prec]
    _close(torch.stack(mine, 1), dec, prec)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_encdec_and_vlm(arch):
    """``serve()`` and its CLI refuse both families before the first step,
    naming ``make_serve_step`` and the input the step needs; the
    reference's ``serve()`` fails there with a ``KeyError``."""
    jcfg, jparams, cfg, params = _models(arch, "fp32")
    need = "enc_out" if cfg.family == "encdec" else "patches"
    with pytest.raises(ValueError, match=rf"make_serve_step.*{need}|"
                       rf"{need}.*make_serve_step"):
        serve_lm.serve(cfg, params, [1, 2], batch=2, max_new=2, cache_len=4,
                       verbose=False)
    with pytest.raises(ValueError, match="make_serve_step"):
        serve_lm.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--batch", "2", "--max-new", "2"])
    with pytest.raises(KeyError, match=need):
        jax_serve.serve(jcfg, jparams, [1, 2], batch=2, max_new=2,
                        cache_len=4, verbose=False)

