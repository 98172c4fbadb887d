"""The SSM and hybrid families on a sharded rank (ROADMAP §1 row 22: a
Mamba2 layer on the rank's heads, ``mamba2.mamba2_apply`` with
``tp.ssm``; the hybrid's shared attention + MLP block over its heads and
d_ff, its FSDP tiles gathered at each use) on 4 gloo ranks, against the
one-device port and the reference.

The reference builds ``mamba2-smoke`` (8 heads of 16, ``w_in``'s 296
columns: x 128, z 128, B 16, C 16, dt 8) and ``zamba2-smoke`` (the same
Mamba2 layers, 4 attention heads, d_ff 128, the shared block after every
second layer), their norms, D, dt_bias and A_log redrawn
(``test_torch_lm._models``), and the ranks receive the tree through
``convert.lm_params_from_arrays``.  Each rank takes its tiles under the
policy on a ("data", "model") mesh of 2 × 2 and of 1 × 4 (``w_in`` cut
into the rank's 1/p of each of its five parts, the SSM state into the
rank's heads though its spec splits d_head, the reference's), each also
with FSDP forced, and runs ``make_prefill_step`` (the flash dispatch's
plain route), ``forward`` (``_sdpa``) and ``STEPS`` decode steps through
``make_serve_step``; ``unshard_params`` gives back every leaf of the
tree, ``w_in`` in the reference's column order, bit for bit.
``mamba2-heads2`` (fp32: mamba2-smoke with 2 heads of 64) runs the block
whole on the 1 × 4 mesh, whose model axis does not divide its heads
(``w_in`` whole, ``w_out`` split on its rows, the state whole).  The test
puts each result back together from the ranks' shards by their mesh
coordinates; the reference's ``forward`` and ``decode_step`` run on the
same tokens here (zamba2's attention through its flash kernel in
interpret mode and, in bf16, op by op, as ``test_torch_lm`` runs it).

Training: two adamw steps of each smoke arch in fp32 on 2 × 2 (± FSDP:
on 2 × 2 FSDP would split the layer axis of ``norm_g``, which a rank
holds whole, ``steps._held``) against the one-device port step and the
reference's jitted ``make_train_step`` on one device, the first step's
gradients (the shared block's summed over its uses) against the
reference's loss function, and mamba2-heads2's on 1 × 4 against the
one-device step.  The ranks then run ``launch/train.py
--model-parallel 2`` for both archs; this process runs the one-rank
runs.

Tolerances: fp32 logits within 1e-5 of the largest magnitude, as
``test_torch_moe_sharded``; bf16 within the dense and MoE sharded tests'
3e-2 (a rank's partial products are rounded before their sums over the
model axis), greedy tokens held where the top two logits are further
apart than the bound.  zamba2-smoke's stack amplifies every bf16 path's
roundings: on the same bf16 weights, the one-device port's logits lie up
to 4.0e-2 from exact arithmetic (the fp32 forward of those weights), the
reference's up to 3.7e-2 and the sharded ones up to 3.7e-2, so that two
bf16 paths part by up to 5.9e-2 (the sharded and the one-device port's
forward at one token).  Its bf16 logits end to end are held within
``HYBRID_BF16`` = 8e-2, twice the largest distance of a bf16 path from
exact arithmetic, and its greedy tokens where the top two logits are
further apart than that.  Its bf16 path is also held block by block:
each Mamba2 block and each application of the shared block, fed the
one-device path's input (teacher forced), in prefill and in each decode
step (each path on its own state and KV caches), within 3e-2 of the
one-device block's output (measured: ≤ 2.2e-2 in prefill and ≤ 2.6e-2
in decode for zamba2, ≤ 9.0e-3 for mamba2, whose logits end to end part
by ≤ 1.1e-2; a block is as far from exact arithmetic sharded as on one
device).  The bf16 checks of every block of
both archs run on every rank.

Training as ``test_torch_train_sharded`` holds it (fp32: the metrics
within 1e-5 of one device's; the weights within adam's 2·lr a step, those
of a large gradient within ``PARAM_TOL`` of the reference's; the
gradients within ``GRAD_TOL`` of each leaf's largest |g|).  The CLI runs
two steps, its final metrics those of the weights after one update,
within 1e-5: adam moves an element whose gradient is near its eps by up
to lr either way, and by the third step of zamba2-smoke at lr 1e-3 the
two runs' gnorm part by 1.2e-5.
"""
import contextlib
import dataclasses
import io
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

from test_torch_lm import SSM, _models, _reference_run  # noqa: E402
from test_torch_train import (BIG, GRAD_TOL, LR, PARAM_TOL,  # noqa: E402
                              STEP2_TOL, _batch, _jax_loss_and_grads, _tree)
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.optim import optimizers as jax_O  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = {"fp32": 1e-5, "bf16": 3e-2}
# zamba2-smoke's bf16 logits end to end: a bf16 path lies up to 4.0e-2 from
# exact arithmetic (the module docstring), so two part by at most twice that
HYBRID_BF16 = 8e-2
MESHES = ("2x2", "1x4")
TAGS = [f"{m}{f}" for m in MESHES for f in ("", "-fsdp")]
B, S, STEPS, CACHE = 4, 8, 3, 16
TRAIN_STEPS = 2
CLI_ARGV = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "8",
            "--steps", "2", "--lr", str(LR)]

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
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import data_axis_names, device_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import transformer as T
    from repro_torch.models.common import (clear_mesh_axes, rms_norm,
                                           set_mesh_axes)
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
        # a sharded rank's leaves (or ``leaves`` laid out as its weights)
        # gathered into the whole leaves, by path
        if leaves is not None:
            rp = T.params_from_leaves(cfg, leaves, rp.shardings)
        back = steps.unshard_params(rp, mesh).ref_leaves()
        return {p: arrays(leaf.full()) for p, leaf in back.items()}

    def run(tag, params, cfg, toks, shard=None):
        one_params = params
        batch = {"tokens": toks}
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
            params = rp
            batch = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            state = steps.shard_state(
                state, steps.cache_shardings(mesh, cfg, state.caches), mesh)
            out[tag + "/coords"] = np.array([
                dist.get_rank(mesh.group("data")),
                dist.get_rank(mesh.group("model")),
                int(sh["unembed"][1] == "model")])
            out[tag + "/state_shape"] = np.array(state.caches["state"].shape)
        out[tag + "/prefill"] = prefill(params, batch)
        logits, _ = T.forward(params, batch["tokens"], cfg, flash=False)
        out[tag + "/forward"] = logits
        for j in range(%(steps)d):
            tj = batch["tokens"][:, j:j + 1]
            copy = state._replace(caches={k: v.clone()
                                          for k, v in state.caches.items()})
            logits, _ = T.decode_step(params, tj, copy, cfg)
            nxt, state = serve(params, {"tokens": tj}, state)
            out[f"{tag}/decode{j}"] = logits[:, 0]
            out[f"{tag}/next{j}"] = nxt[:, 0]
        if shard is not None and cfg.dtype == torch.bfloat16:
            blocks(tag, one_params, params, cfg, toks, mesh, state)

    def err(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    def blocks(tag, params, rp, cfg, toks, mesh, sharded):
        # teacher forced: each block of the rank (its batch rows) on the
        # one-device path's input, against the one-device block; prefill,
        # then decode steps, each path on its own state and caches
        scfg, (b, s) = cfg.ssm_cfg(), toks.shape
        p1 = mesh.shape["data"]
        d = dist.get_rank(mesh.group("data"))
        rows = slice(d * b // p1, (d + 1) * b // p1)
        tp = T._tp_layout(rp, cfg)
        positions = torch.arange(s)[None, :]
        errs = []
        x = params["embed"][toks]
        for layer in range(cfg.n_layers):
            lp, rl = params["layers"][layer], T._rank_layer(rp, layer)
            xn = rms_norm(x, lp["ln"])
            h, _ = M2.mamba2_apply(lp["mamba"], xn, scfg)
            h_r, _ = M2.mamba2_apply(rl["mamba"], xn[rows], scfg, tp=tp)
            errs.append(err(h_r, h[rows]))
            x = x + h
            if T._is_attn(cfg, layer):
                y, _ = T._dense_block(params["shared_attn"], x, cfg,
                                      positions, kernels="torch")
                y_r, _ = T._dense_block(T._shared(rp, tp), x[rows], cfg,
                                        positions, kernels="torch", tp=tp)
                errs.append(err(y_r - x[rows], y[rows] - x[rows]))
                x = y
        out[tag + "/blocks_prefill"] = np.array(errs)
        whole = T.init_decode_state(cfg, b, %(cache)d, device="cpu").caches
        mine = {k: v.zero_() for k, v in sharded.caches.items()}
        tp = T._tp_layout(rp, cfg, sharded)
        conv = torch.zeros((b, 1), dtype=cfg.dtype)
        errs = []
        for j in range(%(steps)d):
            pos = torch.tensor(j, dtype=torch.int32)
            x = params["embed"][toks[:, j:j + 1]]
            for layer in range(cfg.n_layers):
                lp, rl = params["layers"][layer], T._rank_layer(rp, layer,
                                                                "decode")
                xn = rms_norm(x, lp["ln"])
                st = whole["state"][layer]
                h, new = M2.mamba2_apply(lp["mamba"], xn, scfg,
                                         M2.SSMState(st, conv))
                st.copy_(new.state)
                st = mine["state"][layer]
                h_r, new = M2.mamba2_apply(rl["mamba"], xn[rows], scfg,
                                           M2.SSMState(st, conv[rows]),
                                           tp=tp)
                st.copy_(new.state)
                errs.append(err(h_r, h[rows]))
                x = x + h
                if T._is_attn(cfg, layer):
                    ci = layer // cfg.attn_every
                    y, _ = T._dense_block(
                        params["shared_attn"], x, cfg, pos.view(1, 1),
                        A.KVCache(whole["k"][ci], whole["v"][ci], pos))
                    y_r, _ = T._dense_block(
                        T._shared(rp, tp), x[rows], cfg, pos.view(1, 1),
                        A.KVCache(mine["k"][ci], mine["v"][ci], pos), tp=tp)
                    errs.append(err(y_r - x[rows], y[rows] - x[rows]))
                    x = y
        out[tag + "/blocks_decode"] = np.array(errs)

    toks = torch.from_numpy(inputs["tokens"]).long()
    for name, prec in inputs["cases"]:
        arch, replace = inputs["names"][name]
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype=dtypes[prec], **replace)
        params = convert.lm_params_from_arrays(
            inputs["trees"][f"{name}/{prec}"], cfg, "cpu")
        run(f"{name}/{prec}/one", params, cfg, toks)
        for mname, mesh in meshes.items():
            for fsdp in (False, True):
                tag = f"{name}/{prec}/{mname}{'-fsdp' if fsdp else ''}"
                set_mesh_axes(data_axis_names(mesh), mesh=mesh)
                try:
                    run(tag, params, cfg, toks, (mesh, fsdp))
                finally:
                    clear_mesh_axes()

    # training: one device, then its meshes (with FSDP forced too)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    for name, tags in inputs["train"]:
        arch, replace = inputs["names"][name]
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype=torch.float32, **replace)
        tree = inputs["train_trees"][name]
        params = convert.lm_params_from_arrays(tree, cfg, "cpu")
        opt = O.adamw(%(lr)r)
        step, state = steps.make_train_step(cfg, opt), opt.init(params)
        for j in range(%(train_steps)d):
            params, state, m = step(params, state, batch)
            for k, v in m.items():
                out[f"{name}/train/one/{k}{j}"] = v.numpy()
        for p, leaf in params.ref_leaves().items():
            out[f"{name}/train/one/w/{p}"] = arrays(leaf.full())
        for tag in tags:
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
                # the first step's gradients as the step computes them
                loss, aux, g = steps.loss_and_grads(params, local, cfg)
                _, _, g = steps._data_mean(params, loss, aux, g,
                                           steps.mesh_context())
                leaves = params.ref_leaves()
                grads = whole(cfg, params, mesh, {
                    p: Leaf(g[p], leaf.stacked) for p, leaf in leaves.items()})
                for p, a in grads.items():
                    out[f"{name}/train/{tag}/g/{p}"] = a
                step = steps.make_train_step(cfg, opt)
                for j in range(%(train_steps)d):
                    params, state, m = step(params, state, local)
                    for k, v in m.items():
                        out[f"{name}/train/{tag}/{rank}/{k}{j}"] = v.numpy()
                for p, a in whole(cfg, params, mesh).items():
                    out[f"{name}/train/{tag}/w/{p}"] = a
            finally:
                clear_mesh_axes()

    # the train CLI, --model-parallel 2
    cli = {}
    smoke = configs.get_smoke_config
    configs.get_smoke_config = lambda a: dataclasses.replace(
        smoke(a), dtype=torch.float32)
    for arch in inputs["cli_archs"]:
        cli[arch] = train.main(["--arch", arch, *inputs["cli_argv"],
                                "--model-parallel", "2"])
    if rank == 0:
        with open(work + "/cli.pkl", "wb") as f:
            pickle.dump(cli, f)
    np.savez(f"{work}/rank{rank}.npz",
             **{k: (arrays(v) if hasattr(v, "numpy") else v)
                for k, v in out.items()})
    dist.destroy_process_group()
""") % {"steps": STEPS, "cache": CACHE, "lr": LR,
        "train_steps": TRAIN_STEPS}

HYBRID = "zamba2-7b"
# heads of 64, 2 of them: the model axis of 4 does not divide them (w_in's
# 290 columns whole, every rank runs both heads, w_out split on its rows)
HEADS2 = "mamba2-heads2"
NAMES = {a: (a, {}) for a in SSM}
NAMES[HEADS2] = (SSM[0], {"ssm_head": 64})
CASES = [(a, p) for a in SSM for p in TOL] + [(HEADS2, "fp32")]
TRAIN = [(a, t) for a in SSM for t in ("2x2", "2x2-fsdp")] + [(HEADS2,
                                                                 "1x4")]


def _reference(arch: str, prec: str, toks: np.ndarray) -> dict:
    """The reference's forward logits and its decode steps' logits."""
    jcfg, jparams, _, _ = _models(arch, prec)
    out = {}
    with _reference_run(arch, prec):
        logits, _ = jax_T.forward(jparams, jnp.asarray(toks), jcfg)
        out["forward"] = np.asarray(jnp.asarray(logits, jnp.float32))
        state = jax_T.init_decode_state(jcfg, B, CACHE)
        for j in range(STEPS):
            logits, state = jax_T.decode_step(
                jparams, jnp.asarray(toks[:, j:j + 1]), state, jcfg)
            out[f"decode{j}"] = np.asarray(jnp.asarray(logits[:, 0],
                                                       jnp.float32))
    return out


def _reference_train(arch: str, tree: dict, batch: dict):
    """The reference's jitted ``make_train_step`` (adamw, lr ``LR``) over
    ``TRAIN_STEPS`` steps from the carried-over weights: (metrics by step,
    the weights after them by path, the first step's gradients)."""
    jcfg = _tree(arch, "fp32")[0]
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    _, _, grads = _jax_loss_and_grads(jcfg, params, batch)
    opt = jax_O.adamw(LR)
    state = opt.init(params)
    step = jax.jit(jax_steps.make_train_step(jcfg, opt))
    metrics = []
    for _ in range(TRAIN_STEPS):
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {jax.tree_util.keystr(kp, simple=True, separator="/"):
            np.asarray(w) for kp, w in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return metrics, flat, grads


def _cli_one_rank() -> dict:
    """``launch/train.py`` on one rank, fp32 smoke configs: {arch:
    (metrics, printed output)}."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as train_cli
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        smoke = configs.get_smoke_config
        mp.setattr(configs, "get_smoke_config", lambda a: dataclasses
                   .replace(smoke(a), dtype=torch.float32))
        for arch in SSM:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                m = train_cli.main(["--arch", arch, *CLI_ARGV])
            runs[arch] = (m, buf.getvalue())
    return runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' saved results, the reference's logits by case, the
    reference's training by arch, the CLI's runs: 4 ranks' metrics by arch
    and the one-rank runs); the reference and the one-rank runs go on
    while the ranks do."""
    work = tmp_path_factory.mktemp("ssm_sharded")
    toks = np.random.default_rng(11).integers(0, 128, size=(B, S),
                                              dtype=np.int32)
    trees = {f"{a}/{p}": jax.tree_util.tree_map(np.asarray,
                                                _models(a, p)[1])
             for a, p in CASES if a in SSM}
    heads2 = _tree(SSM[0], "fp32", tuple(NAMES[HEADS2][1].items()))[1]
    trees[f"{HEADS2}/fp32"] = heads2
    train_trees = {a: _tree(a, "fp32")[1] for a in SSM}
    train_trees[HEADS2] = heads2
    jb, tb = _batch(_tree(SSM[0], "fp32")[2], "fp32", b=4, s=8)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "names": NAMES, "trees": trees,
                     "tokens": toks, "train_trees": train_trees,
                     "train": [(n, [t for m, t in TRAIN if m == n])
                               for n in NAMES],
                     "batch": {k: v.numpy() for k, v in tb.items()},
                     "cli_archs": SSM, "cli_argv": CLI_ARGV}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        ref = {f"{a}/{p}": _reference(a, p, toks) for a, p in CASES
               if a in SSM}
        ref_train = {a: _reference_train(a, train_trees[a], jb) for a in SSM}
        one_rank = _cli_one_rank()
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
    with open(work / "cli.pkl", "rb") as f:
        cli = pickle.load(f)
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(4)], ref,
            ref_train, (cli, one_rank))


def _whole(ranks, tag, what):
    """A result put back together from the ranks' shards: rows by the data
    coordinate, vocabulary columns by the model coordinate when unembed is
    split on them (a token a row by the data coordinate alone; the model
    ranks' copies must be equal)."""
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
            for m in range(1, p2):       # replicated over "model"
                np.testing.assert_array_equal(coords[(d, m)], coords[(d, 0)])
            rows.append(coords[(d, 0)])
    return np.concatenate(rows, axis=0)


def _err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tol(arch: str, prec: str) -> float:
    """The logits' bound end to end (the hybrid's in bf16: ``HYBRID_BF16``,
    see the module docstring)."""
    return HYBRID_BF16 if (arch, prec) == (HYBRID, "bf16") else TOL[prec]


def _greedy(results, arch, prec, tag, j, want) -> int:
    """The sharded greedy tokens of decode step ``j`` against ``want``'s
    argmax where its top two logits are further apart than the bound;
    the number of such rows."""
    nxt = _whole(results, f"{arch}/{prec}/{tag}", f"next{j}")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > _tol(arch, prec) * np.abs(want).max()
    if prec == "fp32":
        assert clear.all()
    np.testing.assert_array_equal(nxt[clear], np.argmax(want, -1)[clear])
    return int(clear.sum())


def _state_shape(name: str, tag: str) -> tuple:
    """A rank's SSM state tile: (L, B_l, its heads, P, N), the heads whole
    where the model axis does not divide them."""
    arch, replace = NAMES[name]
    p1, p2 = (int(n) for n in tag[:3].split("x"))
    head = replace.get("ssm_head", 16)
    heads = 2 * 64 // head
    layers = 2 if arch.startswith("mamba2") else 4
    return (layers, B // p1, heads // p2 if heads % p2 == 0 else heads,
            head, 16)


PARAMS = [(a, p, t) for a, p in CASES for t in TAGS]
IDS = [f"{a.split('-')[0]}{'-heads2' if a == HEADS2 else ''}-{p}-{t}"
       for a, p, t in PARAMS]


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_prefill_matches_one_device(ranks, arch, prec, tag):
    """The prefill step's last-position logits and the forward's logits of
    every position (the hybrid's in bf16: each block's output on the
    one-device path's input, every rank's); each rank's SSM state tile is
    its heads (B_l, H/p, P, N) per layer (all of them where the model axis
    does not divide them), and its tiles give back the whole tree bit for
    bit."""
    results = ranks[0]
    one = results[0]
    pre = f"{arch}/{prec}"
    for what, shape in (("forward", (B, S, 128)), ("prefill", (B, 128))):
        want = one[f"{pre}/one/{what}"]
        got = _whole(results, f"{pre}/{tag}", what)
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        assert _err(got, want) <= _tol(arch, prec), what
    for r in results:
        if prec == "bf16":
            errs = r[f"{pre}/{tag}/blocks_prefill"]
            layers = _state_shape(arch, tag)[0]
            assert errs.shape == (layers + (layers // 2) * (arch == HYBRID),)
            assert errs.max() <= TOL[prec], errs
        assert tuple(r[f"{pre}/{tag}/state_shape"]) == _state_shape(arch,
                                                                    tag)
        assert bool(r[f"{pre}/{tag}/roundtrip"])


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_decode_matches_one_device(ranks, arch, prec, tag):
    """Each decode step's logits and greedy tokens (``make_serve_step``:
    the largest logit over the ranks' vocabulary columns; in bf16 the
    tokens of the rows whose top two logits are further apart than the
    bound; the hybrid's in bf16: each block's decode steps on the
    one-device path's input, every rank's)."""
    results = ranks[0]
    one = results[0]
    pre = f"{arch}/{prec}"
    held = 0
    for j in range(STEPS):
        want = one[f"{pre}/one/decode{j}"]
        got = _whole(results, f"{pre}/{tag}", f"decode{j}")
        assert got.shape == want.shape == (B, 128)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(one[f"{pre}/one/next{j}"],
                                      np.argmax(want, -1))
        assert _err(got, want) <= _tol(arch, prec), j
        held += _greedy(results, arch, prec, tag, j, want)
    assert held > 0
    if prec == "bf16":
        for r in results:
            errs = r[f"{pre}/{tag}/blocks_decode"]
            assert errs.max() <= TOL[prec], errs


E2E = [c for c in PARAMS if c[0] in SSM]


@pytest.mark.parametrize("arch,prec,tag", E2E,
                         ids=[IDS[PARAMS.index(c)] for c in E2E])
def test_sharded_matches_the_reference(ranks, arch, prec, tag):
    """The sharded forward's and decode steps' logits against the
    reference's ``forward`` and ``decode_step`` on the same weights and
    tokens (``test_torch_lm``'s bounds), and the greedy tokens against the
    reference's argmax where its top two logits are further apart than the
    bound (the hybrid's in bf16: ``HYBRID_BF16``)."""
    results, ref = ranks[0], ranks[1]
    want = ref[f"{arch}/{prec}"]
    got = _whole(results, f"{arch}/{prec}/{tag}", "forward")
    assert _err(got, want["forward"]) <= _tol(arch, prec)
    for j in range(STEPS):
        w = want[f"decode{j}"]
        got = _whole(results, f"{arch}/{prec}/{tag}", f"decode{j}")
        assert _err(got, w) <= _tol(arch, prec), j
        _greedy(results, arch, prec, tag, j, w)


TRAIN_IDS = [f"{a.split('-')[0]}{'-heads2' if a == HEADS2 else ''}-{t}"
             for a, t in TRAIN]


@pytest.mark.parametrize("arch,tag", TRAIN, ids=TRAIN_IDS)
def test_sharded_train_matches_one_device(ranks, arch, tag):
    """Each step's loss, aux and gnorm on every rank, and the weights put
    together from the ranks' tiles after both steps, against the
    one-device port step (fp32: the metrics within 1e-5; the weights
    within adam's 2·lr a step, those of a large first-step gradient within
    1e-5 of their leaf's largest)."""
    results = ranks[0]
    one = results[0]
    pre = f"{arch}/train"
    for j in range(TRAIN_STEPS):
        for k in ("loss", "aux", "gnorm"):
            want = float(one[f"{pre}/one/{k}{j}"])
            for r, res in enumerate(results):
                got = float(res[f"{pre}/{tag}/{r}/{k}{j}"])
                assert abs(got - want) <= TOL["fp32"] * abs(want), (k, j, r)
    paths = [k[len(f"{pre}/one/w/"):] for k in one
             if k.startswith(f"{pre}/one/w/")]
    assert any(p.startswith("layers/mamba/w_in") for p in paths)
    for path in paths:
        want = one[f"{pre}/one/w/{path}"]
        got = one[f"{pre}/{tag}/w/{path}"]
        assert got.shape == want.shape, path
        d = np.abs(got - want)
        assert d.max() <= 2 * TRAIN_STEPS * LR, (path, float(d.max()))
        g = np.abs(one[f"{pre}/{tag}/g/{path}"])
        big = g > BIG * (g.max() or 1.0)
        if big.any():
            scale = float(np.abs(want).max()) or 1.0
            assert d[big].max() / scale <= TOL["fp32"], path


REF_TRAIN = [c for c in TRAIN if c[0] in SSM]


@pytest.mark.parametrize("arch,tag", REF_TRAIN,
                         ids=[TRAIN_IDS[TRAIN.index(c)] for c in REF_TRAIN])
def test_sharded_train_matches_the_reference(ranks, arch, tag):
    """fp32 on 2 × 2 against the reference's ``make_train_step`` on one
    device: each step's metrics (the loss and gnorm within 1e-5, then
    ``STEP2_TOL``), the first step's gradients put together from the
    ranks' tiles (within ``GRAD_TOL`` of each leaf's largest |g|; the
    hybrid's shared block summed over its uses) and the weights after two
    steps (within 2·lr a step, those of a large gradient within
    ``PARAM_TOL``)."""
    results, (metrics, weights, grads) = ranks[0], ranks[2][arch]
    one = results[0]
    pre = f"{arch}/train/{tag}"
    for j, (rel, m) in enumerate(zip((1e-5, STEP2_TOL), metrics)):
        for k in ("loss", "gnorm"):
            for r, res in enumerate(results):
                got = float(res[f"{pre}/{r}/{k}{j}"])
                assert got == pytest.approx(m[k], rel=rel), (k, j, r)
    if arch.startswith("zamba2"):
        assert any(p.startswith("shared_attn/") for p in grads)
    for path, want in grads.items():
        got = one[f"{pre}/g/{path}"]
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max()) / (
            float(np.abs(want).max()) or 1.0)
        assert err <= GRAD_TOL["fp32"], (path, err)
    for path, want in weights.items():
        got = one[f"{pre}/w/{path}"]
        d = np.abs(got - want)
        assert d.max() <= 2 * TRAIN_STEPS * LR, (path, float(d.max()))
        g = np.abs(grads[path])
        big = g > BIG * (g.max() or 1.0)
        if big.any():
            assert d[big].max() <= PARAM_TOL, (path, float(d[big].max()))


@pytest.mark.parametrize("arch", SSM)
def test_cli_on_four_ranks_matches_one_rank(ranks, arch):
    """``launch/train.py --model-parallel 2`` on 4 gloo ranks (a 2 × 2
    mesh) ends with the one-rank run's metrics (fp32, within 1e-5)."""
    cli, one_rank = ranks[3]
    m, out = one_rank[arch]
    assert "mesh: {'data': 1, 'model': 1}" in out
    for k in ("loss", "aux", "gnorm"):
        assert cli[arch][k] == pytest.approx(m[k], rel=TOL["fp32"],
                                             abs=1e-7), k


def test_held_layer_axis_is_bounded():
    """A stacked leaf whose layer axis the policy splits is held whole on
    a rank (its layer axis replicated) only up to ``HELD_WHOLE_MAX``
    bytes; a larger one raises instead of holding more bytes a device than
    the policy's."""
    import torch
    from repro_torch.core.tree import Leaf
    from repro_torch.launch import steps
    from repro_torch.models.common import PartitionSpec

    spec = PartitionSpec("data", "model")
    small = Leaf([torch.empty((4, 8), device="meta")] * 2, True)
    assert steps._held(spec, small, "small") == PartitionSpec(None, "model")
    assert steps._held(spec, Leaf(small.tensors, False), "flat") == spec
    rows = steps.HELD_WHOLE_MAX // 4 // 2 + 1          # fp32, 2 layers
    big = Leaf([torch.empty((rows,), device="meta")] * 2, True)
    with pytest.raises(NotImplementedError, match="split layer axis"):
        steps._held(PartitionSpec("data", None), big, "big")
