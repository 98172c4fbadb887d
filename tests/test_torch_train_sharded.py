"""The dense family's sharded train step (``launch.steps.make_train_step``
on a rank's tiles, ``opt_state_shardings``/``shard_opt_state``, the
differentiable collectives of ``core.collectives``, the cross entropy over
a split vocabulary) on 4 gloo ranks against the one-device port step, and
one case against the reference's ``make_train_step``.

Each rank builds the same whole weights (the reference's, carried over
with ``convert.lm_params_from_arrays`` from the tree
``test_torch_train._tree`` draws, its norms and biases redrawn), takes its tiles of them, of the optimizer state and of
the (B = 4, S = 8) batch on a ("data", "model") mesh of 2 × 2 (heads, KV
heads, d_ff and the vocabulary split on the model axis) and of 1 × 4 (the
KV heads whole, each shared by two ranks that each project it for their
query heads), each also with FSDP forced, and runs two steps with the mesh
declared.  Besides: qwen's smoke config with 6 heads of 16 (the model axis
of 4 does not divide them: every rank runs the attention whole; on 2 × 2 it
does, biases split too), adafactor forced on 2 × 2 (its ``vr``/``vc`` are
tiles and its means and ``rms_u`` sum over the split dims), and remat
(``"dots"`` in blocks of one layer, ``"nothing"`` in a block of two) over
sharded layers whose bodies issue collectives.  Each rank saves its tiles
with their offsets in the whole leaf; the test cuts the one-device step's
leaves by those offsets.

Tolerances: fp32 within 1e-5 of the largest magnitude (a metric's own, a
leaf's largest element; a second moment's (``v``, ``vr``, ``vc``: g²)
square root, in the gradient's units), bf16 within
``test_torch_train_bf16.py``'s 4e-2 (the partial products are rounded to
bf16 before their sum over the model axis).  adamw's fp32 weights as in
``test_torch_train.py``: adam's first step moves an element by lr·g/(|g| +
eps), so an element whose gradient is near eps, or a rounding away from 0
(a k bias has none in exact arithmetic), moves by up to lr a step either
way in each run: every element is held to 2·lr a step, and those whose
first-step |g| is above ``BIG`` of their leaf's largest to 1e-5 (qwen's 6
heads measured 2e-5 and 5.3e-5 of the leaf's largest on wq over all
elements; granite's cases ≤ 6.8e-6 over all).  Against the reference
(fp32, 2 × 2): ``test_torch_train.py``'s bounds for its one-device step.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_train import (BIG, GRAD_TOL, LR,  # noqa: E402
                              PARAM_TOL, STEP2_TOL, _batch,
                              _jax_loss_and_grads, _tree)
from repro.launch import steps as jax_steps  # noqa: E402
from repro.optim import optimizers as jax_O  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
MOE = ("kimi-k2-1t-a32b", "deepseek-v3-671b")
TOL = {"fp32": 1e-5, "bf16": 4e-2}
STEPS = 2
HEADS6 = {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}


def _case(name, prec="fp32", mesh="2x2", fsdp=False, arch="granite-3-2b",
          opt="adamw", replace=None):
    return {"name": name, "prec": prec, "mesh": mesh, "fsdp": fsdp,
            "arch": arch, "opt": opt, "replace": replace or {}}


CASES = ([_case(f"{p}-{m}{'-fsdp' if f else ''}", p, m, f)
          for p in TOL for m in ("2x2", "1x4") for f in (False, True)]
         + [_case(f"heads6-{m}", mesh=m, arch="qwen1.5-4b", replace=HEADS6)
            for m in ("1x4", "2x2")]
         + [_case(f"adafactor-2x2{'-fsdp' if f else ''}", fsdp=f,
                  opt="adafactor") for f in (False, True)]
         + [_case("remat-dots-2x2-fsdp", fsdp=True,
                  replace={"remat_policy": "dots", "remat_block": 1}),
            _case("remat-nothing-1x4",  mesh="1x4",
                  replace={"remat_policy": "nothing", "remat_block": 2})]
         + [_case(f"moe-{a.split('-')[0]}-{m}{'-fsdp' if f else ''}", mesh=m,
                  fsdp=f, arch=a, opt="adafactor")
            for a in MOE for m in ("2x2", "1x4") for f in (False, True)])
# the MoE case held against the reference's step: the batch split over the
# data axis (the global lb_loss), FSDP (the router read as a RowShard)
MOE_REF = "moe-deepseek-2x2-fsdp"
SECOND_MOMENTS = ("v", "vr", "vc")

_RANK = textwrap.dedent("""
    import dataclasses, json, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch import configs, convert
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import data_axis_names, device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
    from repro_torch.optim import optimizers as O

    cases = json.load(open(work + "/cases.json"))
    with open(work + "/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    meshes = {"2x2": device_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": device_mesh((1, 4), ("data", "model"), "cpu")}
    LR = %(lr)r

    def setup(case):
        cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                                  dtype=dtypes[case["prec"]],
                                  **case["replace"])
        params = convert.lm_params_from_arrays(inputs["tree"][case["name"]],
                                               cfg, "cpu")
        opt = O.adamw(LR) if case["opt"] == "adamw" else O.adafactor()
        return cfg, params, opt

    def arrays(leaf):
        t = leaf.full()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    out = {}
    for case in cases:
        c = case["name"]
        cfg, params, opt = setup(case)
        if rank == 0:
            _, _, grads = steps.loss_and_grads(params, batch, cfg)
            for path, rows in grads.items():
                out[f"{c}/one/g/{path}"] = arrays(
                    params.ref_leaves()[path]._replace(tensors=rows))
        step, state = steps.make_train_step(cfg, opt), opt.init(params)
        for j in range(%(steps)d):
            params, state, m = step(params, state, batch)
            for k, v in m.items():
                out[f"{c}/one/{k}{j}"] = v.numpy()
        if rank == 0:
            for path, leaf in params.ref_leaves().items():
                out[f"{c}/one/w/{path}"] = arrays(leaf)
            for path, st in state.inner.items():
                for k, leaf in st.items():
                    out[f"{c}/one/{k}/{path}"] = arrays(leaf)

        cfg, params, opt = setup(case)
        mesh = meshes[case["mesh"]]
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        try:
            sh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                       case["fsdp"])
            osh = steps.opt_state_shardings(mesh, opt.init(params), sh)
            state = steps.shard_opt_state(opt.init(params), osh, mesh)
            params = steps.shard_params(params, sh, mesh)
            local = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            if c == %(moe_ref)r:
                # the first step's gradients and metrics, as the step
                # computes them (the data mean of the ranks')
                loss, aux, g = steps.loss_and_grads(params, local, cfg)
                loss, aux, g = steps._data_mean(
                    params, loss, aux, g, steps.mesh_context())
                out[f"{c}/{rank}/ref_aux"] = aux.numpy()
                for path, rows in g.items():
                    out[f"{c}/{rank}/g/{path}"] = arrays(
                        params.ref_leaves()[path]._replace(tensors=rows))
            step = steps.make_train_step(cfg, opt)
            for j in range(%(steps)d):
                params, state, m = step(params, state, local)
                for k, v in m.items():
                    out[f"{c}/{rank}/{k}{j}"] = v.numpy()
            leaves = params.ref_leaves()
            tiles = [("w", path, leaf, sh[path])
                     for path, leaf in leaves.items()]
            tiles += [(k, path, leaf, osh.inner[path][k])
                      for path, st in state.inner.items()
                      for k, leaf in st.items()]
            for kind, path, leaf, spec in tiles:
                whole = list(leaf.shape)
                for d, ax in enumerate(spec):
                    if ax is not None:
                        whole[d] *= mesh.shape[ax] if isinstance(ax, str) \\
                            else int(np.prod([mesh.shape[a] for a in ax]))
                out[f"{c}/{rank}/{kind}/{path}"] = arrays(leaf)
                out[f"{c}/{rank}/{kind}@/{path}"] = np.array(
                    [[d, s0, w] for d, s0, w in
                     steps._coords(mesh, spec, whole)]).reshape(-1, 3)
        finally:
            clear_mesh_axes()
    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""") % {"steps": STEPS, "lr": LR, "moe_ref": MOE_REF}


def _reference(tree, batch):
    """The reference's jitted ``make_train_step`` (adamw, lr ``LR``) over
    ``STEPS`` steps from the carried-over weights: (metrics by step, the
    weights after them as numpy by path, the first step's gradients)."""
    import jax.numpy as jnp
    from repro import configs as jax_configs
    import dataclasses

    jcfg = dataclasses.replace(
        jax_configs.get_smoke_config("granite-3-2b"), dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    _, _, grads = _jax_loss_and_grads(jcfg, params, batch)
    opt = jax_O.adamw(LR)
    state = opt.init(params)
    step = jax.jit(jax_steps.make_train_step(jcfg, opt))
    metrics = []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {jax.tree_util.keystr(kp, simple=True, separator="/"):
            np.asarray(w) for kp, w in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return metrics, flat, grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' saved results, the reference's (metrics, weights)); the
    reference steps while the ranks run."""
    work = tmp_path_factory.mktemp("train_sharded")
    trees = {c["name"]: _tree(c["arch"], c["prec"],
                              tuple(sorted(c["replace"].items())))[1]
             for c in CASES}
    cfg = _tree("granite-3-2b", "fp32")[2]
    jb, tb = _batch(cfg, "fp32", b=4, s=8)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"tree": trees, "batch": {k: v.numpy() for k, v in
                                              tb.items()}}, f)
    (work / "cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        ref = _reference(trees["fp32-2x2"], jb)
        arch = next(c["arch"] for c in CASES if c["name"] == MOE_REF)
        jcfg = _tree(arch, "fp32")[0]
        ref_moe = _jax_loss_and_grads(
            jcfg, jax.tree_util.tree_map(jax.numpy.asarray, trees[MOE_REF]),
            jb)
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
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(4)],
            ref, ref_moe)


def _tile(whole: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    index = [slice(None)] * whole.ndim
    for d, s0, w in offsets:
        index[d] = slice(s0, s0 + w)
    return whole[tuple(index)]


def _kinds(rank: dict, case: str) -> list:
    """(kind, path) of every tile a rank saved for ``case`` after the steps
    (not ``MOE_REF``'s first-step gradients, kind ``g``)."""
    pre = f"{case}/0/"
    return sorted(tuple(k[len(pre):].split("/", 1)) for k in rank
                  if k.startswith(pre) and "/" in k[len(pre):]
                  and k[len(pre):].split("/", 1)[0] != "g"
                  and "@" not in k[len(pre):].split("/", 1)[0])


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_train_matches_one_device(ranks, case):
    """Each step's loss, aux and gnorm on every rank, and every rank's tile
    of each weight and of each optimizer-state leaf after both steps,
    against the one-device port step on the same weights and batch."""
    results = ranks[0]
    c, tol = case["name"], TOL[case["prec"]]
    one = results[0]
    for j in range(STEPS):
        for k in ("loss", "aux", "gnorm"):
            want = float(one[f"{c}/one/{k}{j}"])
            for r, res in enumerate(results):
                got = float(res[f"{c}/{r}/{k}{j}"])
                assert abs(got - want) <= tol * abs(want), (k, j, r, got,
                                                            want)
    kinds = _kinds(one, c)
    adam = case["opt"] == "adamw" and case["prec"] == "fp32"
    names = {"adamw": {"w", "m", "v"}, "adafactor": {"w", "vr", "vc", "v"}}
    assert {k for k, _ in kinds} == names[case["opt"]]
    for kind, path in kinds:
        # a second moment holds g²: its square root is held, in g's units
        f = np.sqrt if kind in SECOND_MOMENTS else np.asarray
        whole = f(one[f"{c}/one/{kind}/{path}"])
        scale = float(np.abs(whole).max()) or 1.0
        for r, res in enumerate(results):
            got = f(res[f"{c}/{r}/{kind}/{path}"])
            want = _tile(whole, res[f"{c}/{r}/{kind}@/{path}"])
            assert got.shape == want.shape, (kind, path, r)
            d = np.abs(got - want)
            if kind == "w" and adam:
                # adam moves an element of a gradient near its eps or a
                # rounding from 0 by up to lr a step either way
                assert d.max() <= 2 * STEPS * LR, (path, r, float(d.max()))
                g = np.abs(_tile(one[f"{c}/one/g/{path}"],
                                 res[f"{c}/{r}/w@/{path}"]))
                d = d[g > BIG * float(np.abs(one[f"{c}/one/g/{path}"]).max())]
                if not d.size:
                    continue
            err = float(d.max()) / scale
            assert err <= tol, (kind, path, r, err)


def _assemble(results: list, case: str, kind: str, path: str) -> np.ndarray:
    """A leaf put together from the ranks' tiles by their offsets; tiles
    that several ranks hold must agree bit for bit."""
    first = results[0][f"{case}/0/{kind}/{path}"]
    shape = list(first.shape)
    parts = {}
    for r, res in enumerate(results):
        offs = res[f"{case}/{r}/{kind}@/{path}"]
        for d, s0, w in offs:
            shape[d] = max(shape[d], s0 + w)
        key = tuple(map(tuple, offs))
        tile = res[f"{case}/{r}/{kind}/{path}"]
        if key in parts:
            np.testing.assert_array_equal(tile, parts[key])
        parts[key] = tile
    whole = np.full(shape, np.nan, dtype=first.dtype)
    for offs, tile in parts.items():
        index = [slice(None)] * len(shape)
        for d, s0, w in offs:
            index[d] = slice(s0, s0 + w)
        whole[tuple(index)] = tile
    assert not np.isnan(whole).any(), (kind, path)
    return whole


def test_sharded_train_matches_the_reference(ranks):
    """fp32 on 2 × 2: each step's metrics and the weights put together
    from the ranks' tiles after two steps against the reference's jitted
    ``make_train_step`` on the same weights (``test_torch_train``'s
    bounds: the loss and gnorm within 1e-5, then 1e-4; every element
    within 2·lr a step, those of a large gradient within ``PARAM_TOL``)."""
    results, (metrics, weights, grads), _ = ranks
    case = "fp32-2x2"
    for j, (rel, m) in enumerate(zip((1e-5, STEP2_TOL), metrics)):
        for k in ("loss", "gnorm"):
            for r, res in enumerate(results):
                got = float(res[f"{case}/{r}/{k}{j}"])
                assert got == pytest.approx(m[k], rel=rel), (k, j, r)
    for path, want in weights.items():
        got = _assemble(results, case, "w", path)
        assert got.shape == want.shape, path
        d = np.abs(got - want)
        assert d.max() <= 2 * STEPS * LR, (path, float(d.max()))
        g = np.abs(grads[path])
        big = g > BIG * (g.max() or 1.0)
        if big.any():
            assert d[big].max() <= PARAM_TOL, (path, float(d[big].max()))


def test_sharded_moe_step_matches_the_reference(ranks):
    """``MOE_REF`` (dsv3-smoke, fp32, 2 × 2 with FSDP: the batch split over
    the data axis, the experts over the model axis, the router FSDP-split
    on its rows and read as a ``RowShard``): the first step's aux (the
    global batch's ``lb_loss``, summed over the layers) and the router's
    gradient, put together from the ranks' tiles, against the reference's
    ``make_train_step`` loss function on one device
    (``test_torch_train``'s bounds: aux within 1e-5, each leaf's gradient
    within 1e-4 of its largest |g|); every other leaf's gradient too."""
    results, _, (_, aux, grads) = ranks
    for r, res in enumerate(results):
        got = float(res[f"{MOE_REF}/{r}/ref_aux"])
        assert got == pytest.approx(aux, rel=1e-5), (r, got, aux)
    assert any("router" in path for path in grads)
    # a gradient's tile lies where its weight's does
    tiles = [{**res, **{k.replace("/w@/", "/g@/"): v for k, v in res.items()
                        if k.startswith(f"{MOE_REF}/") and "/w@/" in k}}
             for res in results]
    for path, want in grads.items():
        got = _assemble(tiles, MOE_REF, "g", path)
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max()) / (
            float(np.abs(want).max()) or 1.0)
        assert err <= GRAD_TOL["fp32"], (path, err)


# ---------------------------------------------------------------------------
# The CLI on 4 gloo ranks (``--model-parallel 2``) against one rank, and
# resumes across world sizes
# ---------------------------------------------------------------------------

CLI_ARGV = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "8", "--steps", "10", "--ckpt-every",
            "5", "--lr", str(LR)]
CLI_STOP = 5
MOE_CLI = ["--arch", "deepseek-v3-671b"]      # given after CLI_ARGV's arch
# an encoder-decoder arch, one step (its checkpoint written after it)
WHISPER_CLI = ["--arch", "whisper-small", "--smoke", "--device", "cpu",
               "--batch", "4", "--seq", "8", "--steps", "1", "--ckpt-every",
               "1", "--lr", str(LR)]
# adam's first step moves an element of a gradient near its eps by up to lr
# either way, and the next steps' gradients follow: dsv3-smoke's wq_a ends
# 10 steps with its m 1.2e-4 of its largest apart, 8.0e-5 after 2 steps
# (the first step's gradients agree within 2.4e-7 of each leaf's largest)
MOE_STATE_TOL = 3e-4

_CLI_RANK = textwrap.dedent("""
    import dataclasses, json, sys, traceback
    import torch
    import torch.distributed as dist
    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch import configs
    from repro_torch.launch import train
    smoke = configs.get_smoke_config
    configs.get_smoke_config = lambda a: dataclasses.replace(
        smoke(a), dtype=torch.float32)
    out = {}
    for name, argv in json.load(open(work + "/runs.json")):
        print(f"== {name}", flush=True)
        try:
            out[name] = train.main(argv)
        except ValueError as e:
            out[name] = {"error": str(e)}
    json.dump(out, open(f"{work}/cli{rank}.json", "w"))
    dist.destroy_process_group()
""")


def _fp32_smoke(monkeypatch):
    import dataclasses
    import torch
    from repro_torch import configs
    smoke = configs.get_smoke_config
    monkeypatch.setattr(configs, "get_smoke_config", lambda a: dataclasses
                        .replace(smoke(a), dtype=torch.float32))


def _printed(out: str) -> dict:
    """{step: (loss, gnorm)} of the printed step lines."""
    rows = {}
    for line in out.splitlines():
        f = line.split()
        if f[:1] == ["step"]:
            rows[int(f[1])] = (float(f[3]), float(f[5]))
    return rows


def _ckpt(root: Path) -> dict:
    from repro_torch.checkpoint import store
    d = root / f"step_{store.latest_step(str(root)):08d}"
    man = json.loads((d / "manifest.json").read_text())
    return {e["path"]: np.load(d / e["file"]) for e in man["leaves"]}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The runs: A one rank uninterrupted; B 4 ranks uninterrupted; C 4
    ranks stopped after step 5, resumed on one; D one rank stopped after
    step 5, resumed on 4; E whisper-small on 4 ranks; F deepseek-v3's
    smoke config (MLA, the MoE layer) on one rank and G the same on 4
    ranks.  Returns ({run: (rank 0's metrics, printed output)}, work
    dir)."""
    from repro_torch.launch import train as train_cli
    work = tmp_path_factory.mktemp("train_cli")
    mp = pytest.MonkeyPatch()
    _fp32_smoke(mp)
    runs = {}
    try:
        import contextlib
        import io

        def one(name, *more, argv=CLI_ARGV):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                m = train_cli.main(argv + ["--ckpt-dir", str(work / name),
                                           *more])
            runs.setdefault(name, []).append((m, buf.getvalue()))

        one("A")
        one("D", "--stop-at", str(CLI_STOP))
        one("F", *MOE_CLI)
        one("E1", argv=WHISPER_CLI)
        jobs = [["B", CLI_ARGV + ["--ckpt-dir", str(work / "B"),
                                  "--model-parallel", "2"]],
                ["C", CLI_ARGV + ["--ckpt-dir", str(work / "C"),
                                  "--model-parallel", "2", "--stop-at",
                                  str(CLI_STOP)]],
                ["D", CLI_ARGV + ["--ckpt-dir", str(work / "D"),
                                  "--model-parallel", "2"]],
                ["E", WHISPER_CLI + ["--ckpt-dir", str(work / "E"),
                                     "--model-parallel", "2"]],
                ["G", CLI_ARGV + MOE_CLI + ["--ckpt-dir", str(work / "G"),
                                            "--model-parallel", "2"]]]
        (work / "runs.json").write_text(json.dumps(jobs))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _CLI_RANK,
                                   str(work), str(r)], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(4)]
        logs = []
        for r, proc in enumerate(procs):
            try:
                log, _ = proc.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                for p in procs:
                    p.kill()
                pytest.fail(f"rank {r} did not finish in {TIMEOUT} s")
            assert proc.returncode == 0, f"rank {r} failed:\n{log[-5000:]}"
            logs.append(log)
        done = json.loads((work / "cli0.json").read_text())
        parts = logs[0].split("== ")[1:]
        for name, part in zip([j[0] for j in jobs], parts):
            assert part.startswith(name)
            runs.setdefault(name, []).append((done[name], part))
        for r in range(1, 4):
            assert "step" not in logs[r], f"rank {r} printed"
        one("C")
    finally:
        mp.undo()
    return runs, work


def _close(got: dict, want: dict) -> None:
    for k in ("loss", "aux", "gnorm"):
        assert got[k] == pytest.approx(want[k], rel=TOL["fp32"], abs=1e-7), k


def _ckpt_close(a: dict, b: dict, state_tol: float = TOL["fp32"]) -> None:
    """Two final checkpoints (the weights under ``0/``, adamw's state under
    ``1/``): the step equal, ``m`` and √``v`` within ``state_tol`` of their
    leaf's largest (1e-5; measured ≤ 2.3e-6), the weights within adam's
    2·lr a step (measured ≤ 2.1e-5 of their leaf's largest)."""
    assert sorted(a) == sorted(b)
    for path in a:
        x, y = a[path].astype(np.float64), b[path].astype(np.float64)
        if path.startswith("0/"):
            assert np.abs(x - y).max() <= 2 * 10 * LR, path
            continue
        if path.endswith("/v"):
            x, y = np.sqrt(x), np.sqrt(y)
        err = np.abs(x - y).max() / (np.abs(y).max() or 1.0)
        assert err <= state_tol, (path, float(err))


def test_cli_on_four_ranks_matches_one_rank(cli):
    """``--model-parallel 2`` on 4 gloo ranks (a 2 × 2 mesh): rank 0
    alone prints, the printed losses and gnorms are the one-rank run's
    (to their printed digits) and the final metrics within the fp32 bound;
    the checkpoint holds whole leaves, the reference's format."""
    runs, work = cli
    (a, out_a), = runs["A"]
    (b, out_b), = runs["B"]
    assert "mesh: {'data': 2, 'model': 2}" in out_b
    assert "mesh: {'data': 1, 'model': 1}" in out_a
    _close(b, a)
    pa, pb = _printed(out_a), _printed(out_b)
    assert sorted(pa) == sorted(pb) == [1, 10]
    for step in pa:
        assert abs(pa[step][0] - pb[step][0]) <= 1.5e-4
        assert abs(pa[step][1] - pb[step][1]) <= 1.5e-3
    ca, cb = _ckpt(work / "A"), _ckpt(work / "B")
    assert {k: v.shape for k, v in ca.items()} == \
        {k: v.shape for k, v in cb.items()}
    _ckpt_close(cb, ca)


@pytest.mark.parametrize("run", ["C", "D"])
def test_cli_resumes_across_world_sizes(cli, run):
    """C: a 4-rank run's step-5 checkpoint resumed on one rank; D: a
    one-rank run's resumed on 4; each ends as the uninterrupted one-rank
    run does, within the fp32 bound."""
    runs, work = cli
    (a, _), = runs["A"]
    (_, first), (m, out) = runs[run]
    assert "resumed" not in first
    assert f"resumed from step {CLI_STOP}" in out
    _close(m, a)
    _ckpt_close(_ckpt(work / run), _ckpt(work / "A"))


def test_cli_moe_on_four_ranks_matches_one_rank(cli):
    """A MoE arch (dsv3-smoke) through ``--model-parallel 2`` on 4 gloo
    ranks (its 8 experts 4 a rank, the batch split over the data axis):
    the printed steps and final metrics, aux among them, are the one-rank
    run's, and so is the checkpoint (its adamw state within
    ``MOE_STATE_TOL``)."""
    runs, work = cli
    (f, out_f), = runs["F"]
    (g, out_g), = runs["G"]
    assert "family: moe" in out_g and "mesh: {'data': 2, 'model': 2}" in out_g
    assert f["aux"] > 0
    _close(g, f)
    pf, pg = _printed(out_f), _printed(out_g)
    assert sorted(pf) == sorted(pg) == [1, 10]
    for step in pf:
        assert abs(pf[step][0] - pg[step][0]) <= 1.5e-4
        assert abs(pf[step][1] - pg[step][1]) <= 1.5e-3
    _ckpt_close(_ckpt(work / "G"), _ckpt(work / "F"), MOE_STATE_TOL)


def test_cli_refuses_a_sharded_non_dense_arch(cli):
    """whisper-smoke (an encoder-decoder arch, whose sharded train step
    ROADMAP §1 row 22 ports) through ``--model-parallel 2`` on 4 gloo ranks
    (a 2 × 2 mesh; its frames split over the data axis): one step, the
    printed loss and gnorm, the final metrics and the checkpoint are the
    one-rank run's (E1) within the CLI tests' bounds."""
    runs, work = cli
    (e1, out1), = runs["E1"]
    (e, out), = runs["E"]
    assert "error" not in e
    assert "family: encdec" in out and "mesh: {'data': 2, 'model': 2}" in out
    assert "mesh: {'data': 1, 'model': 1}" in out1
    _close(e, e1)
    p1, p = _printed(out1), _printed(out)
    assert sorted(p1) == sorted(p) == [1]
    assert abs(p1[1][0] - p[1][0]) <= 1.5e-4
    assert abs(p1[1][1] - p[1][1]) <= 1.5e-3
    _ckpt_close(_ckpt(work / "E"), _ckpt(work / "E1"))
