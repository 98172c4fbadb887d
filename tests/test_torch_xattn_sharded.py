"""The encoder-decoder and VLM families on a sharded rank (ROADMAP §1 row
22: whisper's encoder and decoder layers and the VLM's dense and cross
layers over the model axis, a cross-attention's K/V projected from the
rank's rows of ``enc_out`` or the patches, the gelu MLP's ``b_up`` on d_ff
and its whole ``b_down`` added once after the sum) on 4 gloo ranks,
against the one-device port and the reference.

The reference builds ``whisper-smoke`` (4 heads of 16, an encoder of 2
layers over 32 frames, d_ff 128) and ``llama-vision-smoke`` (4 dense
layers, GQA 4/2, a cross layer to 16 patches after layers 1 and 3), their
norms and gelu biases redrawn (``test_torch_train._tree``), and the ranks
receive the tree through ``convert.lm_params_from_arrays``.  Each rank
takes its tiles under the policy on a ("data", "model") mesh of 2 × 2 and
of 1 × 4, each also with FSDP forced, and runs ``make_prefill_step``
(frames or patches in the batch; the flash dispatch's plain route),
``forward`` (``_sdpa``), ``encode`` (whisper), ``STEPS`` decode steps
(the reference's ``enc_out`` or the patches, batch-sharded) and as many
greedy tokens through ``make_serve_step``; ``unshard_params`` gives back
every leaf of the three stacks (``layers``, ``enc_layers``,
``cross_layers``) bit for bit.  On 1 × 4 the VLM's 2 KV heads are whole
and a rank projects the one its query head reads (in its cross layers
too).  ``whisper-heads2`` (fp32: whisper-smoke with 2 heads of 32, built
alike in both packages) runs its attention whole on 1 × 4 (the model axis
does not divide its heads, as whisper's 12 on 16) beside a split MLP and
vocabulary, its decode cache split on its length.  The test puts each
result back together from the ranks' shards by their mesh coordinates;
the reference's ``forward``, ``encode`` and ``decode_step`` run on the
same inputs here (its attention through its flash kernel in interpret
mode and, in bf16, op by op, as ``test_torch_xattn`` runs it).

Training: one adamw step of each case in fp32 on every mesh (± FSDP)
against the one-device port step (loss and gnorm, each gradient put
together from the ranks' tiles, the weights after the step) and, on 2 × 2,
against the reference's loss function and jitted ``make_train_step``.

Tolerances: fp32 within 1e-5 of the largest magnitude (logits, enc_out,
loss, gnorm, each leaf's gradient of its largest |g|; measured ≤ 5.4e-7
for the results, ≤ 8.9e-7 for the gradients against the reference's),
the weights after a step within adam's 2·lr and those of a large gradient
within ``PARAM_TOL`` of the reference's.  bf16 logits end to end within
3e-2, the dense and MoE sharded tests' bound (measured ≤ 1.2e-2 against
one device, ≤ 1.1e-2 against the reference), greedy tokens where the top
two logits are further apart than it.  Each block of the prefill (the
encoder's and decoder's layers, the VLM's dense and cross layers), fed
the one-device path's input (teacher forced), is held on every rank
within ``BLOCK_BF16`` = 4 bf16 ulps (4·2⁻⁸) of the largest |output| of
the one-device block: the output x + h is rounded once to bf16, and a
rank's h differs from one device's by the roundings of its partial
products (each no larger than h here) before their sum over the model
axis, about an ulp each (measured ≤ 8.8e-3).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_train import (BIG, LR, PARAM_TOL, _batch,  # noqa: E402
                              _jax_loss_and_grads, _tree)
from test_torch_xattn import _reference_run  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import optimizers as jax_O  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = {"fp32": 1e-5, "bf16": 3e-2}
BLOCK_BF16 = 4 * 2 ** -8         # a bf16 block's output (module docstring)
MESHES = ("2x2", "1x4")
TAGS = [f"{m}{f}" for m in MESHES for f in ("", "-fsdp")]
B, S, STEPS, CACHE = 4, 8, 3, 16
ARCHS = ("whisper-small", "llama-3.2-vision-11b")
# whisper with 2 heads of 32: the model axis of 4 does not divide them
HEADS2 = "whisper-heads2"
NAMES = {a: (a, ()) for a in ARCHS}
NAMES[HEADS2] = (ARCHS[0], (("n_heads", 2), ("n_kv_heads", 2)))
CASES = [(a, p) for a in ARCHS for p in TOL] + [(HEADS2, "fp32")]

_RANK = textwrap.dedent("""
    import dataclasses, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch import configs, convert
    from repro_torch.core.tree import Leaf
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import data_axis_names, device_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.common import (clear_mesh_axes, mlp_apply,
                                           rms_norm, set_mesh_axes)
    from repro_torch.optim import optimizers as O

    with open(work + "/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    meshes = {"2x2": device_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": device_mesh((1, 4), ("data", "model"), "cpu")}
    out = {}

    def arrays(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def whole(cfg, rp, mesh, leaves=None):
        if leaves is not None:
            rp = T.params_from_leaves(cfg, leaves, rp.shardings)
        back = steps.unshard_params(rp, mesh).ref_leaves()
        return {p: arrays(leaf.full()) for p, leaf in back.items()}

    def err(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    def run(tag, params, cfg, toks, front, dec, shard=None):
        one_params = params
        key = "frames" if cfg.family == "encdec" else "patches"
        batch = {"tokens": toks, key: front}
        extra = {"enc_out" if cfg.family == "encdec" else "patches": dec}
        prefill = steps.make_prefill_step(cfg, kernels="torch")
        serve = steps.make_serve_step(cfg)
        state = T.init_decode_state(cfg, toks.shape[0], %(cache)d,
                                    device="cpu")
        if shard is not None:
            mesh, fsdp = shard
            sh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                       fsdp)
            rp = steps.shard_params(params, sh, mesh)
            back = whole(cfg, rp, mesh)
            out[tag + "/roundtrip"] = np.array(all(
                np.array_equal(back[p], arrays(leaf.full()))
                for p, leaf in params.ref_leaves().items()))
            out[tag + "/stacks"] = np.array(sorted({
                p.split("/")[0] for p, leaf in rp.ref_leaves().items()
                if leaf.stacked}))
            params = rp
            batch = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            extra = steps.shard_batch(
                extra, steps.batch_shardings(mesh, extra), mesh)
            state = steps.shard_state(
                state, steps.cache_shardings(mesh, cfg, state.caches), mesh)
            tp = T._tp_layout(params, cfg, state)
            out[tag + "/coords"] = np.array([
                dist.get_rank(mesh.group("data")),
                dist.get_rank(mesh.group("model")),
                int(sh["unembed"][1] == "model")])
            out[tag + "/layout"] = np.array(
                [tp.heads, tp.kv_heads, tp.ffn,
                 {"heads": 1, "length": 2}.get(tp.cache, 0)])
            out[tag + "/cache_shape"] = np.array(state.caches["k"].shape)
        out[tag + "/prefill"] = prefill(params, batch)
        logits, _ = T.forward(params, batch["tokens"], cfg,
                              {key: batch[key]}, flash=False)
        out[tag + "/forward"] = logits
        if cfg.family == "encdec":
            out[tag + "/encode"] = T.encode(params, batch["frames"], cfg)
        for j in range(%(steps)d):
            tj = batch["tokens"][:, j:j + 1]
            copy = state._replace(caches={k: v.clone()
                                          for k, v in state.caches.items()})
            logits, _ = T.decode_step(params, tj, copy, cfg, extra)
            nxt, state = serve(params, {"tokens": tj, **extra}, state)
            out[f"{tag}/decode{j}"] = logits[:, 0]
            out[f"{tag}/next{j}"] = nxt[:, 0]
        if shard is not None and cfg.dtype == torch.bfloat16:
            blocks(tag, one_params, params, cfg, toks, front, mesh)

    def blocks(tag, params, rp, cfg, toks, front, mesh):
        # teacher forced: each block of the prefill on the rank's batch rows
        # of the one-device path's input, against the one-device block
        (b, s), p1 = toks.shape, mesh.shape["data"]
        d = dist.get_rank(mesh.group("data"))
        rows = slice(d * b // p1, (d + 1) * b // p1)
        tp = T._tp_layout(rp, cfg)
        positions = torch.arange(s)[None, :]
        nc = T._noncausal_cfg(cfg)
        errs = []
        x = params["embed"][toks]
        if cfg.family == "encdec":
            e = front + params["enc_pos"][:front.shape[1]]
            for layer in range(cfg.n_enc_layers):
                lp = params["enc_layers"][layer]
                rl = T._rank_block(rp, rp["enc_layers"][layer],
                                   "enc_layers/", "prefill")
                h, _ = A.attn_apply(lp["attn"], rms_norm(e, lp["ln1"]), nc,
                                    kernels="torch")
                e1 = e + h
                y = e1 + mlp_apply(lp["mlp"], rms_norm(e1, lp["ln2"]), "gelu")
                h, _ = A.attn_apply(rl["attn"], rms_norm(e[rows], rl["ln1"]),
                                    nc, kernels="torch", tp=tp)
                e1 = e[rows] + h
                y_r = e1 + mlp_apply(rl["mlp"], rms_norm(e1, rl["ln2"]),
                                     "gelu", tp=tp)
                errs.append(err(y_r, y[rows]))
                e = y
            enc = rms_norm(e, params["enc_ln_f"])
            x = x + params["dec_pos"][:s]
        for layer in range(cfg.n_layers):
            lp, rl = params["layers"][layer], T._rank_layer(rp, layer)
            if cfg.family == "encdec":
                y, _ = T._encdec_block(lp, x, cfg, positions, enc,
                                       kernels="torch")
                y_r, _ = T._encdec_block(rl, x[rows], cfg, positions,
                                         enc[rows], kernels="torch", tp=tp)
            else:
                y, _ = T._dense_block(lp, x, cfg, positions,
                                      kernels="torch")
                y_r, _ = T._dense_block(rl, x[rows], cfg, positions,
                                        kernels="torch", tp=tp)
            errs.append(err(y_r, y[rows]))
            x = y
            if cfg.family == "vlm" and T._is_cross(cfg, layer):
                ci = layer // cfg.cross_attn_every
                y = T._cross_layer(params, ci, x, cfg, front, "torch")
                y_r = T._cross_layer(rp, ci, x[rows], cfg, front[rows],
                                     "torch", tp=tp)
                errs.append(err(y_r, y[rows]))
                x = y
        out[tag + "/blocks"] = np.array(errs)

    def tensor(a, cfg):
        return torch.from_numpy(a).to(cfg.dtype)

    toks = torch.from_numpy(inputs["tokens"]).long()
    for name, prec in inputs["cases"]:
        arch, replace = inputs["names"][name]
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype=dtypes[prec], **dict(replace))
        pre = f"{name}/{prec}"
        params = convert.lm_params_from_arrays(inputs["trees"][pre], cfg,
                                               "cpu")
        front = tensor(inputs["front"][pre], cfg)
        dec = tensor(inputs["dec"][pre], cfg)
        run(pre + "/one", params, cfg, toks, front, dec)
        for mname, mesh in meshes.items():
            for fsdp in (False, True):
                tag = f"{pre}/{mname}{'-fsdp' if fsdp else ''}"
                set_mesh_axes(data_axis_names(mesh), mesh=mesh)
                try:
                    run(tag, params, cfg, toks, front, dec, (mesh, fsdp))
                finally:
                    clear_mesh_axes()

    # training: one adamw step on one device, then on each mesh
    for name in inputs["train"]:
        arch, replace = inputs["names"][name]
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype=torch.float32, **dict(replace))
        tree = inputs["train_trees"][name]
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["batch"][name].items()}
        opt = O.adamw(%(lr)r)
        params = convert.lm_params_from_arrays(tree, cfg, "cpu")
        params, _, m = steps.make_train_step(cfg, opt)(
            params, opt.init(params), batch)
        for k, v in m.items():
            out[f"{name}/train/one/{k}"] = v.numpy()
        for p, leaf in params.ref_leaves().items():
            out[f"{name}/train/one/w/{p}"] = arrays(leaf.full())
        for tag in inputs["train_tags"]:
            mesh = meshes[tag[:3]]
            params = convert.lm_params_from_arrays(tree, cfg, "cpu")
            set_mesh_axes(data_axis_names(mesh), mesh=mesh)
            try:
                sh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                           tag.endswith("fsdp"))
                osh = steps.opt_state_shardings(mesh, opt.init(params), sh)
                state = steps.shard_opt_state(opt.init(params), osh, mesh)
                params = steps.shard_params(params, sh, mesh)
                local = steps.shard_batch(
                    batch, steps.batch_shardings(mesh, batch), mesh)
                loss, aux, g = steps.loss_and_grads(params, local, cfg)
                _, _, g = steps._data_mean(params, loss, aux, g,
                                           steps.mesh_context())
                leaves = params.ref_leaves()
                grads = whole(cfg, params, mesh, {
                    p: Leaf(g[p], leaf.stacked) for p, leaf in leaves.items()})
                for p, a in grads.items():
                    out[f"{name}/train/{tag}/g/{p}"] = a
                params, state, m = steps.make_train_step(cfg, opt)(
                    params, state, local)
                for k, v in m.items():
                    out[f"{name}/train/{tag}/{rank}/{k}"] = v.numpy()
                for p, a in whole(cfg, params, mesh).items():
                    out[f"{name}/train/{tag}/w/{p}"] = a
            finally:
                clear_mesh_axes()

    np.savez(f"{work}/rank{rank}.npz",
             **{k: (arrays(v) if hasattr(v, "numpy") else v)
                for k, v in out.items()})
    dist.destroy_process_group()
""") % {"steps": STEPS, "cache": CACHE, "lr": LR}


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(name: str, prec: str):
    """(reference config, the weights as numpy, the frontend's frames or
    patches, the decode steps' ``enc_out`` or patches, both in the model's
    dtype as fp32 numpy, the reference's results)."""
    arch, replace = NAMES[name]
    jcfg, tree, _ = _tree(arch, prec, replace)
    jparams = _jparams(tree)
    n = jcfg.enc_len if jcfg.family == "encdec" else jcfg.n_patches
    a = np.random.default_rng(11).normal(size=(B, n, jcfg.d_model))
    front = jnp.asarray(a.astype(np.float32), jcfg.dtype)
    toks = _TOKENS
    ref = {}
    with _reference_run(prec):
        if jcfg.family == "encdec":
            enc = jax_T.encode(jparams, front, jcfg)
            ref["encode"] = np.asarray(jnp.asarray(enc, jnp.float32))
            extra, dec = {"frames": front}, {"enc_out": enc}
        else:
            extra = dec = {"patches": front}
        logits, _ = jax_T.forward(jparams, jnp.asarray(toks), jcfg, extra)
        ref["forward"] = np.asarray(jnp.asarray(logits, jnp.float32))
        state = jax_T.init_decode_state(jcfg, B, CACHE)
        for j in range(STEPS):
            logits, state = jax_T.decode_step(
                jparams, jnp.asarray(toks[:, j:j + 1]), state, jcfg, dec)
            ref[f"decode{j}"] = np.asarray(jnp.asarray(logits[:, 0],
                                                       jnp.float32))
    as32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return tree, as32(front), as32(next(iter(dec.values()))), ref


_TOKENS = np.random.default_rng(7).integers(0, 128, size=(B, S),
                                            dtype=np.int32)
TRAIN = [a for a in NAMES]
TRAIN_TAGS = TAGS
REF_TRAIN = [(a, t) for a in ARCHS for t in ("2x2", "2x2-fsdp")]


def _reference_train(name: str, tree: dict, jb: dict):
    """The reference's jitted ``make_train_step`` (adamw, lr ``LR``), one
    step from the carried-over weights: (metrics, the weights after it by
    path, the step's gradients)."""
    arch, replace = NAMES[name]
    jcfg = _tree(arch, "fp32", replace)[0]
    params = _jparams(tree)
    _, _, grads = _jax_loss_and_grads(jcfg, params, jb)
    opt = jax_O.adamw(LR)
    params, _, m = jax.jit(jax_steps.make_train_step(jcfg, opt))(
        params, opt.init(params), jb)
    flat = {jax.tree_util.keystr(kp, simple=True, separator="/"):
            np.asarray(w) for kp, w in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return {k: float(v) for k, v in m.items()}, flat, grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' saved results, the reference's results by case, the
    reference's training by arch); the reference runs while the ranks
    do."""
    work = tmp_path_factory.mktemp("xattn_sharded")
    trees, front, dec, ref = {}, {}, {}, {}
    for name, prec in CASES:
        pre = f"{name}/{prec}"
        trees[pre], front[pre], dec[pre], ref[pre] = _inputs(name, prec)
    train_trees, batches, jbs = {}, {}, {}
    for name in TRAIN:
        arch, replace = NAMES[name]
        jcfg, train_trees[name], cfg = _tree(arch, "fp32", replace)
        jbs[name], tb = _batch(cfg, "fp32", b=B, s=S)
        batches[name] = {k: v.numpy() for k, v in tb.items()}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "names": NAMES, "trees": trees,
                     "tokens": _TOKENS, "front": front, "dec": dec,
                     "train": TRAIN, "train_tags": TRAIN_TAGS,
                     "train_trees": train_trees, "batch": batches}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        ref_train = {a: _reference_train(a, train_trees[a], jbs[a])
                     for a in ARCHS}
        for r, proc in enumerate(procs):
            try:
                log, _ = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} did not finish in {TIMEOUT} s")
            assert proc.returncode == 0, f"rank {r} failed:\n{log[-5000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(4)], ref,
            ref_train)


def _whole(ranks, tag, what):
    """A result put back together from the ranks' shards: rows by the data
    coordinate, vocabulary columns by the model coordinate when unembed is
    split on them (the model ranks' copies of anything else must be
    equal)."""
    coords = {}
    for r in ranks:
        d, m, split = (int(x) for x in r[tag + "/coords"])
        coords[(d, m)] = r[f"{tag}/{what}"]
    p1 = max(d for d, _ in coords) + 1
    p2 = max(m for _, m in coords) + 1
    logits = what in ("prefill", "forward") or what.startswith("decode")
    rows = []
    for d in range(p1):
        if split and logits:
            rows.append(np.concatenate([coords[(d, m)] for m in range(p2)],
                                       axis=-1))
        else:
            for m in range(1, p2):
                np.testing.assert_array_equal(coords[(d, m)], coords[(d, 0)])
            rows.append(coords[(d, 0)])
    return np.concatenate(rows, axis=0)


def _err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _greedy(results, pre, tag, j, want, tol) -> int:
    """The sharded greedy tokens of decode step ``j`` against ``want``'s
    argmax where its top two logits are further apart than ``tol`` of
    its scale; the number of such rows."""
    nxt = _whole(results, f"{pre}/{tag}", f"next{j}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol * np.abs(want).max()
    np.testing.assert_array_equal(nxt[clear], np.argmax(want, -1)[clear])
    return int(clear.sum())


def _layout(name: str, tag: str) -> tuple:
    """(heads, kv_heads, ffn split, the KV cache split: 1 heads, 2 length)
    of a rank, and its KV cache tile's shape (L, B_l, T_l, KVH_l, Dh)."""
    arch, replace = NAMES[name]
    h = dict(replace).get("n_heads", 4)
    kvh = dict(replace).get("n_kv_heads", 4 if arch == ARCHS[0] else 2)
    p1, p2 = (int(n) for n in tag[:3].split("x"))
    heads, kv = h % p2 == 0, kvh % p2 == 0
    layers = 2 if arch == ARCHS[0] else 4
    shape = (layers, B // p1, CACHE if kv else CACHE // p2,
             kvh // p2 if kv else kvh, 64 // h)
    return (int(heads), int(kv), 1, 1 if kv else 2), shape


PARAMS = [(a, p, t) for a, p in CASES for t in TAGS]
IDS = [f"{a.split('-')[0]}{'-heads2' if a == HEADS2 else ''}-{p}-{t}"
       .replace("llama", "vlm") for a, p, t in PARAMS]


@pytest.mark.parametrize("name,prec,tag", PARAMS, ids=IDS)
def test_sharded_prefill_matches_one_device(ranks, name, prec, tag):
    """The prefill step's last-position logits, the forward's logits of
    every position and whisper's ``encode`` (bf16: each block of the
    prefill on the one-device path's input, every rank's); each rank's
    layout and KV cache tile, and its tiles give back every leaf of the
    three stacks bit for bit."""
    results = ranks[0]
    one = results[0]
    pre = f"{name}/{prec}"
    whats = [("forward", (B, S, 128)), ("prefill", (B, 128))]
    if NAMES[name][0] == ARCHS[0]:
        whats.append(("encode", (B, 32, 64)))
    for what, shape in whats:
        want = one[f"{pre}/one/{what}"]
        got = _whole(results, f"{pre}/{tag}", what)
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        assert _err(got, want) <= TOL[prec], what
    layout, shape = _layout(name, tag)
    stacks = (["cross_layers", "layers"] if NAMES[name][0] == ARCHS[1]
              else ["enc_layers", "layers"])
    for r in results:
        if prec == "bf16":
            errs = r[f"{pre}/{tag}/blocks"]
            assert errs.shape == ((2 + 2,) if name == ARCHS[0] else (4 + 2,))
            assert errs.max() <= BLOCK_BF16, errs
        assert tuple(r[f"{pre}/{tag}/layout"]) == layout
        assert tuple(r[f"{pre}/{tag}/cache_shape"]) == shape
        assert list(r[f"{pre}/{tag}/stacks"]) == stacks
        assert bool(r[f"{pre}/{tag}/roundtrip"])


@pytest.mark.parametrize("name,prec,tag", PARAMS, ids=IDS)
def test_sharded_decode_matches_one_device(ranks, name, prec, tag):
    """Each decode step's logits (the reference's ``enc_out`` or the
    patches, batch-sharded) and greedy tokens through ``make_serve_step``
    (the largest logit over the ranks' vocabulary columns; in bf16 those of
    the rows whose top two logits are further apart than the bound)."""
    results = ranks[0]
    one = results[0]
    pre = f"{name}/{prec}"
    held = 0
    for j in range(STEPS):
        want = one[f"{pre}/one/decode{j}"]
        got = _whole(results, f"{pre}/{tag}", f"decode{j}")
        assert got.shape == want.shape == (B, 128)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(one[f"{pre}/one/next{j}"],
                                      np.argmax(want, -1))
        assert _err(got, want) <= TOL[prec], j
        held += _greedy(results, pre, tag, j, want, TOL[prec])
    assert held > 0


@pytest.mark.parametrize("name,prec,tag", PARAMS, ids=IDS)
def test_sharded_matches_the_reference(ranks, name, prec, tag):
    """The sharded forward's, ``encode``'s and decode steps' results
    against the reference's on the same weights and inputs, and the greedy
    tokens against the reference's argmax where its top two logits are
    further apart than the bound."""
    results, ref = ranks[0], ranks[1][f"{name}/{prec}"]
    for what in ("forward", "encode", *(f"decode{j}" for j in range(STEPS))):
        if what not in ref:
            continue
        got = _whole(results, f"{name}/{prec}/{tag}", what)
        assert _err(got, ref[what]) <= TOL[prec], what
        if what.startswith("decode"):
            _greedy(results, f"{name}/{prec}", tag, int(what[6:]), ref[what],
                    TOL[prec])


TRAIN_PARAMS = [(a, t) for a in TRAIN for t in TRAIN_TAGS]
TRAIN_IDS = [f"{a.split('-')[0]}{'-heads2' if a == HEADS2 else ''}-{t}"
             .replace("llama", "vlm") for a, t in TRAIN_PARAMS]


@pytest.mark.parametrize("name,tag", TRAIN_PARAMS, ids=TRAIN_IDS)
def test_sharded_train_matches_one_device(ranks, name, tag):
    """One adamw step in fp32: loss, aux and gnorm on every rank within
    1e-5 of the one-device step's, each gradient put together from the
    ranks' tiles within 1e-5 of its leaf's largest |g| (the one-device
    gradients are the reference's within ``test_sharded_train_matches_the
    _reference``'s bound), the weights after the step within adam's 2·lr,
    those of a large gradient within 1e-5 of their leaf's largest."""
    results = ranks[0]
    one = results[0]
    pre = f"{name}/train"
    for k in ("loss", "aux", "gnorm"):
        want = float(one[f"{pre}/one/{k}"])
        for r, res in enumerate(results):
            got = float(res[f"{pre}/{tag}/{r}/{k}"])
            assert abs(got - want) <= TOL["fp32"] * abs(want), (k, r)
    paths = [k[len(f"{pre}/one/w/"):] for k in one
             if k.startswith(f"{pre}/one/w/")]
    assert any(p.startswith(("enc_layers/", "cross_layers/"))
               for p in paths)
    for path in paths:
        want = one[f"{pre}/one/w/{path}"]
        got = one[f"{pre}/{tag}/w/{path}"]
        assert got.shape == want.shape, path
        d = np.abs(got - want)
        assert d.max() <= 2 * LR, (path, float(d.max()))
        g = np.abs(one[f"{pre}/{tag}/g/{path}"])
        big = g > BIG * (g.max() or 1.0)
        if big.any():
            scale = float(np.abs(want).max()) or 1.0
            assert d[big].max() / scale <= TOL["fp32"], path


@pytest.mark.parametrize("name,tag", REF_TRAIN,
                         ids=[f"{a.split('-')[0]}-{t}".replace("llama", "vlm")
                              for a, t in REF_TRAIN])
def test_sharded_train_matches_the_reference(ranks, name, tag):
    """fp32 on 2 × 2 against the reference on one device: the loss and
    gnorm within 1e-5, each gradient put together from the ranks' tiles
    within 1e-5 of its leaf's largest |g| (the encoder's and the cross
    layers' among them), the weights after the step within 2·lr, those of
    a large gradient within ``PARAM_TOL``."""
    results, (metrics, weights, grads) = ranks[0], ranks[2][name]
    one = results[0]
    pre = f"{name}/train/{tag}"
    for k in ("loss", "gnorm"):
        for r, res in enumerate(results):
            got = float(res[f"{pre}/{r}/{k}"])
            assert got == pytest.approx(metrics[k], rel=TOL["fp32"]), (k, r)
    assert any(p.startswith(("enc_layers/", "cross_layers/"))
               for p in grads)
    for path, want in grads.items():
        got = one[f"{pre}/g/{path}"]
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max()) / (
            float(np.abs(want).max()) or 1.0)
        assert err <= TOL["fp32"], (path, err)
    for path, want in weights.items():
        got = one[f"{pre}/w/{path}"]
        d = np.abs(got - want)
        assert d.max() <= 2 * LR, (path, float(d.max()))
        g = np.abs(grads[path])
        big = g > BIG * (g.max() or 1.0)
        if big.any():
            assert d[big].max() <= PARAM_TOL, (path, float(d[big].max()))
