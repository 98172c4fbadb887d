"""The port's training (plain PyTorch on the CPU) against the JAX package on
the same weights and batches: ``launch.steps.make_train_step`` and its
gradients for the 10 smoke archs, the attention route it takes, remat, the
CLI's restart-exact resume, and the refusals around it (the CLI on several
ranks: ``test_torch_train_sharded.py``).

The reference builds the weights (``init_params``); its norms, biases and
the SSM's A_log, D, dt_bias and norm_g are then redrawn from a numpy
generator, and the port receives the same tree through
``convert.lm_params_from_arrays``.  The reference runs on its default
attention route (``USE_FLASH = False``: ``_sdpa``), the route its
``make_train_step`` takes; the port's train step takes the same route
(``forward(..., flash=False)``).

Tolerances:

* fp32: loss, aux and gnorm within rtol 1e-5 (the second step's loss and
  gnorm 1e-4: see below); each leaf's gradient within 1e-4 of that leaf's
  largest |g| (measured ≤ 1e-5: the two frameworks sum in other orders).
  After two adamw steps (lr 1e-3): adamw divides m by √v, so a gradient's
  relative error becomes the update's.  An element whose |g| is above 1e-2
  of its leaf's largest (``BIG``) has a relative error ≤ 1e-2 and is held to
  2·1e-2·lr (``PARAM_TOL``, two steps); a gradient a rounding away from 0
  may move its element by up to lr a step in either package, so every
  element is held to 2·lr a step (measured: one w_in element of zamba2
  6e-4 apart, which moves the second step's gnorm by 2.4e-5).
* bf16 (``test_torch_train_bf16.py``): the reference op by op
  (``jax.disable_jit()``; under ``jit`` XLA's CPU compiler drops bf16
  round trips, as ``test_torch_lm.py`` says).  loss within rtol 1e-5 (the
  forwards round alike: measured ≤ 2e-7); each leaf's gradient within
  4e-2 of its largest |g| (measured ≤ 2.8e-2): both packages round every
  backward op to bf16, but they reduce the sums of a weight's gradient
  over the batch and sequence in other orders, a few bf16 ulps (2⁻⁸
  relative) at the leaf's largest element.
* the ``_sdpa`` route's forward against the reference's default forward
  (op by op in bf16): fp32 1e-5, bf16 1e-2 of the logits' scale (measured
  ≤ 6e-3, most archs 0 or 2e-7), where the flash route
  (``test_torch_lm.py``) needs 3e-2.
"""
import collections
import contextlib
import dataclasses
import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_T
from repro.models.common import softmax_xent as jax_xent
from repro.optim import optimizers as jax_O
from repro_torch import configs, convert
from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers, schedule

ARCHS = configs.ARCHS
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LR = 1e-3
GRAD_TOL = {"fp32": 1e-4, "bf16": 4e-2}
FWD_TOL = {"fp32": 1e-5, "bf16": 1e-2}


@functools.lru_cache(maxsize=None)
def _tree(arch: str, prec: str, replace: tuple = ()):
    """(reference config, the reference's weights as numpy, port config);
    ``replace``: (field, value) pairs changed in both smoke configs."""
    jdt, tdt = DTYPES[prec]
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), dtype=jdt,
                               **dict(replace))
    jparams, _ = jax_T.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(23)

    def redraw(node, name, centre, spread):
        if name in node:
            a = node[name]
            node[name] = (centre + spread * rng.normal(size=a.shape)).astype(
                a.dtype)

    for key in ("layers", "enc_layers", "shared_attn"):
        node = tree.get(key, {})
        for name in ("ln", "ln1", "ln2", "ln3"):
            redraw(node, name, 1, 0.2)
        for name in ("bq", "bk", "bv"):
            redraw(node.get("attn", {}), name, 0, 0.3)
        for name in ("b_up", "b_down"):
            redraw(node.get("mlp", {}), name, 0, 0.3)
        if "mamba" in node:
            m = node["mamba"]
            m["A_log"] = (m["A_log"] + 0.3 * rng.normal(
                size=m["A_log"].shape)).astype(np.float32)
            redraw(m, "D", 1, 0.5)
            redraw(m, "dt_bias", 0, 0.5)
            redraw(m, "norm_g", 1, 0.2)
    for name in ("ln_f", "enc_ln_f", "ln_cross"):
        redraw(tree, name, 1, 0.2)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt,
                              **dict(replace))
    return jcfg, tree, cfg


def _models(arch: str, prec: str):
    """Fresh (reference config, reference params, port config, port
    params) with the same weights (the steps write the port's in place)."""
    jcfg, tree, cfg = _tree(arch, prec)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg,
            convert.lm_params_from_arrays(tree, cfg, "cpu"))


def _batch(cfg, prec: str, b: int = 2, s: int = 16, seed: int = 1):
    """One batch in both packages with the same bits: tokens and labels
    from the synthetic stream, frames/patches N(0, 1) from numpy in the
    model's dtype."""
    jdt = DTYPES[prec][0]
    tb = synthetic_token_stream(seed, cfg.vocab, b, s)(0)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    key, n = {"encdec": ("frames", cfg.enc_len),
              "vlm": ("patches", cfg.n_patches)}.get(cfg.family, (None, 0))
    if key:
        a = np.random.default_rng(seed).normal(size=(b, n, cfg.d_model))
        jb[key] = jnp.asarray(a.astype(np.float32), jdt)
        tb[key] = convert.tensor_from_array(np.asarray(jb[key]), "cpu")
    return jb, tb


def _jax_loss_and_grads(jcfg, jparams, jb):
    """The reference's train-step loss and gradients (its loss_fn)."""
    extra = {k: jb[k] for k in ("frames", "patches") if k in jb}

    def loss_fn(p):
        logits, aux = jax_T.forward(p, jb["tokens"], jcfg, extra)
        loss = jax_xent(logits, jb["labels"])
        return loss + 0.01 * aux, (loss, aux)

    grads, (loss, aux) = jax.grad(loss_fn, has_aux=True)(jparams)
    flat = {jax.tree_util.keystr(kp, simple=True, separator="/"): np.asarray(
        g.astype(jnp.float32))
        for kp, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), float(aux), flat


def _full(rows, leaf) -> np.ndarray:
    t = torch.stack(list(rows)) if leaf.stacked else rows[0]
    return t.float().numpy()


def _hold_grads(params, grads, want: dict, tol: float) -> float:
    """Each leaf's gradient within ``tol`` of its largest |g|; returns the
    worst ratio."""
    worst = 0.0
    leaves = params.ref_leaves()
    assert sorted(grads) == sorted(want)
    for path, rows in grads.items():
        got, w = _full(rows, leaves[path]), want[path]
        assert got.shape == w.shape, path
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(got - w).max()) / scale
        assert err <= tol, (path, err, tol)
        worst = max(worst, err)
    return worst


def _leaf_arrays(params) -> dict:
    return {path: _full(leaf.tensors, leaf)
            for path, leaf in params.ref_leaves().items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_fp32(arch):
    """Two adamw steps of ``make_train_step`` against the reference's
    (jitted) on the same batch: metrics, each leaf's gradient, and the
    parameters after both steps."""
    jcfg, jparams, cfg, params = _models(arch, "fp32")
    jb, tb = _batch(cfg, "fp32")
    loss, aux, want = _jax_loss_and_grads(jcfg, jparams, jb)
    tloss, taux, grads = steps.loss_and_grads(params, tb, cfg)
    assert float(tloss) == pytest.approx(loss, rel=1e-5)
    assert float(taux) == pytest.approx(aux, rel=1e-5, abs=1e-7)
    _hold_grads(params, grads, want, GRAD_TOL["fp32"])
    big = {p: np.abs(g) > BIG * (np.abs(g).max() or 1.0)
           for p, g in want.items()}

    jstep = jax.jit(jax_steps.make_train_step(jcfg, jax_O.adamw(LR)))
    jstate = jax_O.adamw(LR).init(jparams)
    opt = optimizers.adamw(LR)
    step, state = steps.make_train_step(cfg, opt), opt.init(params)
    for rel in (1e-5, STEP2_TOL):
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        params, state, m = step(params, state, tb)
        for name in ("loss", "gnorm"):
            assert float(m[name]) == pytest.approx(float(jm[name]),
                                                   rel=rel), name
    got = _leaf_arrays(params)
    for kp, w in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        path = jax.tree_util.keystr(kp, simple=True, separator="/")
        d = np.abs(got[path] - np.asarray(w))
        assert d.max() <= 2 * 2 * LR, (path, float(d.max()))
        if big[path].any():
            assert d[big[path]].max() <= PARAM_TOL, (path,
                                                     float(d[big[path]].max()))


BIG = 1e-2                                 # of a leaf's largest |g|
PARAM_TOL = 2 * GRAD_TOL["fp32"] / BIG * LR
STEP2_TOL = 1e-4


def hold_sdpa_forward(arch: str, prec: str) -> None:
    """``forward(..., flash=False)`` against the reference's default forward
    (``_sdpa``; op by op in bf16), tighter than the flash route's 3e-2."""
    jcfg, jparams, cfg, params = _models(arch, prec)
    jb, tb = _batch(cfg, prec)
    extra = {k: jb[k] for k in ("frames", "patches") if k in jb}
    ctx = jax.disable_jit() if prec == "bf16" else contextlib.nullcontext()
    with ctx:
        want, waux = jax_T.forward(jparams, jb["tokens"], jcfg, extra)
    got, aux = T.forward(params, tb["tokens"], cfg,
                         {k: tb[k] for k in extra}, flash=False)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= FWD_TOL[prec], err
    assert float(aux) == pytest.approx(float(waux), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_sdpa_route_matches_reference_forward(arch):
    hold_sdpa_forward(arch, "fp32")


def _grads(cfg, params, tb):
    _, _, grads = steps.loss_and_grads(params, tb, cfg)
    return {p: torch.stack([g for g in rows]) for p, rows in grads.items()}


@pytest.mark.parametrize("arch", ["granite-3-2b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_remat_gives_the_same_gradients(arch):
    """Remat ``"none"``, ``"nothing"``, ``"dots"`` (and for the dense family
    ``remat_block`` 1 and 2) recompute the same ops: the gradients are the
    same bits."""
    _, _, cfg, params = _models(arch, "bf16")
    _, tb = _batch(cfg, "bf16")
    variants = [dataclasses.replace(cfg, remat_policy=p)
                for p in ("none", "nothing", "dots")]
    if cfg.family == "dense":
        variants += [dataclasses.replace(cfg, remat_policy="dots",
                                         remat_block=k) for k in (1, 2)]
    want = _grads(variants[0], params, tb)
    for c in variants[1:]:
        got = _grads(c, params, tb)
        for path in want:
            assert torch.equal(got[path], want[path]), (c.remat_policy,
                                                        c.remat_block, path)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say():
    """In the backward, ``"nothing"`` recomputes the forward's weight
    products (``aten.mm``) and ``"dots"`` keeps them (the backward runs
    the mms that no remat runs) but recomputes the attention scores
    (``aten.bmm``), which no remat keeps."""
    _, _, cfg, params = _models("granite-3-2b", "fp32")
    _, tb = _batch(cfg, "fp32")

    def backward_ops(policy):
        c = dataclasses.replace(cfg, remat_policy=policy)
        params.requires_grad_(True)
        try:
            logits, _ = T.forward(params, tb["tokens"], c, flash=False)
            flat = list(params.parameters())
            with _OpCount() as ops_:
                torch.autograd.grad(logits.float().square().mean(), flat)
        finally:
            params.requires_grad_(False)
        mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
        return ops_.counts[mm], ops_.counts[bmm]

    none, dots, nothing = (backward_ops(p) for p in ("none", "dots",
                                                     "nothing"))
    assert dots[0] == none[0] < nothing[0]
    assert none[1] < dots[1] == nothing[1]


def test_mini_lm_training_loss_decreases():
    """The reference's training contract: 30 adamw steps on one fixed
    synthetic batch drop the loss below 0.7 of its start."""
    cfg = configs.get_smoke_config("granite-3-2b")
    params = T.init_params(0, cfg, device="cpu")
    opt = optimizers.adamw(schedule.cosine_schedule(3e-3, warmup=5,
                                                    total=30))
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    batch = synthetic_token_stream(seed=0, vocab=cfg.vocab, batch=4,
                                   seq=16)(0)
    losses = []
    for _ in range(30):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.7 * losses[0], losses[::10]


def _digests(root: str) -> dict:
    d = os.path.join(root, sorted(os.listdir(root))[-1])
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()
                              ).hexdigest()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small"])
def test_cli_resume_is_restart_exact(arch, tmp_path, capsys):
    """``--smoke --device cpu --steps 20``: a run stopped after step 10
    (``--stop-at 10``, after its checkpoint), resumed with the same flags,
    writes the step-20 checkpoint of an uninterrupted run, bit for bit."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "8", "--ckpt-every", "10", "--steps", "20"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = train_cli.main(argv + ["--ckpt-dir", a])
    train_cli.main(argv + ["--ckpt-dir", b, "--stop-at", "10"])
    assert sorted(os.listdir(b)) == ["step_00000010"]
    resumed = train_cli.main(argv + ["--ckpt-dir", b])
    assert "resumed from step 10" in capsys.readouterr().out
    assert resumed == full
    assert _digests(a) == _digests(b)
    assert sorted(os.listdir(a)) == ["step_00000010", "step_00000020"]


def test_cli_targets_the_card(monkeypatch):
    """Without ``--device`` the CLI trains on the card, and raises when
    there is none: no silent move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])


def test_flash_route_refuses_a_graph():
    """The flash kernel's wrapper and its plain version raise under a graph
    instead of cutting it; without one they run as before."""
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    k = torch.randn(1, 8, 2, 64)
    for fn in (FA.flash_attention, FA.flash_attention_plain,
               ops.flash_attention):
        with pytest.raises(RuntimeError, match="flash=False"):
            fn(q, k, k)
        with torch.no_grad():
            fn(q, k, k)
    _, _, cfg, params = _models("granite-3-2b", "fp32")
    _, tb = _batch(cfg, "fp32")
    params.requires_grad_(True)
    try:
        with pytest.raises(RuntimeError, match="no backward"):
            T.forward(params, tb["tokens"], cfg)
    finally:
        params.requires_grad_(False)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small"])
def test_serving_records_no_graph(arch):
    """After a train step the weights no longer require grad, and the
    prefill and serve steps record no graph."""
    _, _, cfg, params = _models(arch, "fp32")
    _, tb = _batch(cfg, "fp32")
    opt = optimizers.adamw(LR)
    params, _, _ = steps.make_train_step(cfg, opt)(params, opt.init(params),
                                                   tb)
    assert not any(p.requires_grad for p in params.parameters())
    extra = {k: tb[k] for k in ("frames", "patches") if k in tb}
    last = steps.make_prefill_step(cfg)(params, {"tokens": tb["tokens"],
                                                 **extra})
    assert last.grad_fn is None and not last.requires_grad
    state = T.init_decode_state(cfg, 2, 4, device="cpu")
    if "frames" in extra:
        extra = {"enc_out": T.encode(params, extra["frames"], cfg)}
    nxt, _ = steps.make_serve_step(cfg)(params, {"tokens": tb["tokens"][
        :, :1], **extra}, state)
    assert nxt.grad_fn is None
