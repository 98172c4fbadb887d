"""The MoE family's sharded prefill and decode (ROADMAP §1 row 22: the
expert-parallel ``moe.moe_apply``, MLA split over its heads, kimi-k2's GQA
on ``attention._attn_apply_tp``) on 4 gloo ranks, against the one-device
port and the reference.

The reference builds ``kimi-smoke`` (GQA, 4 heads over 2 KV heads) and
``dsv3-smoke`` (MLA, 4 heads) with 8 experts top-2 and a shared expert
(``test_torch_lm._models``: its norms redrawn) and the ranks receive the
tree through ``convert.lm_params_from_arrays``.  Each rank takes its tiles
under the policy on a ("data", "model") mesh of 2 × 2 (4 experts a rank,
the batch split over the data axis: the router statistics of
``lb_loss`` and ``drop_frac`` are summed over it) and of 1 × 4 (2 experts
a rank; kimi's KV heads whole, its cache and MLA's latent cache split on
their length), each also with FSDP forced (on 2 × 2 the router and MLA's
wq_a, wkv_a (kimi's wk, wv) FSDP-split on their rows are read in decode as
``transformer._row_tile`` reads them), and runs ``make_prefill_step``,
``forward`` with ``layer_aux`` and ``STEPS`` decode steps through
``make_serve_step``.  The test puts each result back together from the
ranks' shards by their mesh coordinates; the reference's ``forward`` and
``decode_step`` run on the same tokens here (its attention through its
flash kernel in interpret mode, op by op in bf16, as ``test_torch_lm``
runs it).

Tolerances: fp32 logits within 1e-5 of the largest magnitude, ``lb_loss``
and ``drop_frac`` of every layer within 1e-6 of one device's, and every
route equal (bf16: ``drop_frac`` the same where the routes are, ``lb_loss``
within 3e-2).  bf16: a rank's partial sums (the combine of its experts, the
attention's output) are rounded before their sum over the model axis, so
a near tie of the router can route a token otherwise than one device
does; the routes that differ are counted and held to the allowance of
``test_torch_lm.py::test_route_swap_rate`` (5 of 2048 tokens, at least
one), and the logits are held to 3e-2 on the tokens every layer routed
alike (and no earlier token of their row routed otherwise).
"""
import math
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

from test_torch_lm import (MOE, ROUTE_SWAPS, _models,  # noqa: E402
                           _reference_run)
from repro.models import transformer as jax_T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TOL = {"fp32": 1e-5, "bf16": 3e-2}
AUX_TOL = 1e-6
MESHES = ("2x2", "1x4")
TAGS = [f"{m}{f}" for m in MESHES for f in ("", "-fsdp")]
B, S, STEPS, CACHE = 4, 8, 3, 16

_RANK = textwrap.dedent("""
    import dataclasses, pickle, sys
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

    with open(work + "/inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    meshes = {"2x2": device_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": device_mesh((1, 4), ("data", "model"), "cpu")}
    out = {}

    def run(tag, params, cfg, toks, shard=None):
        # prefill, forward's layer aux, decode steps; shard: (mesh, fsdp)
        batch = {"tokens": toks}
        prefill = steps.make_prefill_step(cfg, kernels="torch", flash=False)
        serve = steps.make_serve_step(cfg)
        whole = T.init_decode_state(cfg, toks.shape[0], %(cache)d,
                                    device="cpu")
        state = whole
        if shard is not None:
            mesh, fsdp = shard
            sh = steps.param_shardings(mesh, params, T.param_specs(cfg),
                                       fsdp)
            params = steps.shard_params(params, sh, mesh)
            batch = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            state = steps.shard_state(
                whole, steps.cache_shardings(mesh, cfg, whole.caches), mesh)
            out[tag + "/coords"] = torch.tensor([
                dist.get_rank(mesh.group("data")),
                dist.get_rank(mesh.group("model")),
                int(sh["unembed"][1] == "model")])
        out[tag + "/prefill"] = prefill(params, batch)
        layer_aux = []
        logits, aux = T.forward(params, batch["tokens"], cfg,
                                layer_aux=layer_aux, flash=False)
        out[tag + "/forward"] = logits
        out[tag + "/aux"] = aux
        for i, a in enumerate(layer_aux):
            for k in ("lb_loss", "drop_frac", "expert_ids"):
                out[f"{tag}/fwd{i}/{k}"] = a[k]
        for j in range(%(steps)d):
            tj = batch["tokens"][:, j:j + 1]
            copy = state._replace(caches={k: v.clone()
                                          for k, v in state.caches.items()})
            step_aux = []
            logits, _ = T.decode_step(params, tj, copy, cfg,
                                      layer_aux=step_aux)
            nxt, state = serve(params, {"tokens": tj}, state)
            out[f"{tag}/decode{j}"] = logits[:, 0]
            out[f"{tag}/next{j}"] = nxt[:, 0]
            for i, a in enumerate(step_aux):
                for k in ("lb_loss", "drop_frac", "expert_ids"):
                    out[f"{tag}/dec{j}/{i}/{k}"] = a[k]

    for arch, prec in inputs["cases"]:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype=dtypes[prec])
        params = convert.lm_params_from_arrays(
            inputs["trees"][f"{arch}/{prec}"], cfg, "cpu")
        toks = torch.from_numpy(inputs["tokens"]).long()
        run(f"{arch}/{prec}/one", params, cfg, toks)
        for name, mesh in meshes.items():
            for fsdp in (False, True):
                tag = f"{arch}/{prec}/{name}{'-fsdp' if fsdp else ''}"
                set_mesh_axes(data_axis_names(mesh), mesh=mesh)
                try:
                    run(tag, params, cfg, toks, (mesh, fsdp))
                finally:
                    clear_mesh_axes()
    np.savez(f"{work}/rank{rank}.npz",
             **{k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in out.items()})
    dist.destroy_process_group()
""") % {"steps": STEPS, "cache": CACHE}

CASES = [(a, p) for a in MOE for p in TOL]


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' saved results, the reference's logits by case); the
    reference runs while the ranks do."""
    work = tmp_path_factory.mktemp("moe_sharded")
    toks = np.random.default_rng(11).integers(0, 128, size=(B, S),
                                              dtype=np.int32)
    trees = {f"{a}/{p}": jax.tree_util.tree_map(np.asarray,
                                                _models(a, p)[1])
             for a, p in CASES}
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "trees": trees, "tokens": toks}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        ref = {f"{a}/{p}": _reference(a, p, toks) for a, p in CASES}
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
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)], ref


def _whole(ranks, tag, what):
    """A result put back together from the ranks' shards: rows by the data
    coordinate, vocabulary columns by the model coordinate when unembed is
    split on them (a token a row, or a route, by the data coordinate
    alone; the model ranks' copies must be equal)."""
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
    if coords[(0, 0)].ndim == 0:         # a global scalar: alike everywhere
        for r in rows[1:]:
            np.testing.assert_array_equal(r, rows[0])
        return rows[0]
    return np.concatenate(rows, axis=0)


def _err(got, want, keep=None) -> float:
    d = np.abs(got - want)
    if keep is not None:
        d = d[keep]
    return float(d.max() / np.abs(want).max()) if d.size else 0.0


def _routed_otherwise(one, ranks, arch, prec, tag):
    """(B, S) tokens of the forward some layer routed otherwise than one
    device, and (STEPS, B) decode tokens the same."""
    cfg_layers = 2
    fwd = np.zeros((B, S), bool)
    dec = np.zeros((STEPS, B), bool)
    for i in range(cfg_layers):
        got = _whole(ranks, f"{arch}/{prec}/{tag}", f"fwd{i}/expert_ids")
        want = one[f"{arch}/{prec}/one/fwd{i}/expert_ids"]
        fwd |= (np.sort(got, -1) != np.sort(want, -1)).any(-1)
        for j in range(STEPS):
            got = _whole(ranks, f"{arch}/{prec}/{tag}",
                         f"dec{j}/{i}/expert_ids")
            want = one[f"{arch}/{prec}/one/dec{j}/{i}/expert_ids"]
            dec[j] |= (np.sort(got, -1) != np.sort(want, -1)).any((-1, -2))
    return fwd, dec


def _allowance(arch: str, n: int) -> int:
    return max(1, math.ceil(ROUTE_SWAPS[arch] * n / 2048))


PARAMS = [(a, p, t) for a, p in CASES for t in TAGS]
IDS = [f"{a.split('-')[0]}-{p}-{t}" for a, p, t in PARAMS]


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_prefill_matches_one_device(ranks, arch, prec, tag):
    """The prefill step's last-position logits and the forward's logits of
    every position; in bf16 on the tokens routed alike."""
    results, _ = ranks
    one = results[0]
    fwd, _ = _routed_otherwise(one, results, arch, prec, tag)
    if prec == "fp32":
        assert not fwd.any()
    assert fwd.sum() <= _allowance(arch, fwd.size)
    # a token's state reaches the later tokens of its row
    alike = ~np.maximum.accumulate(fwd, axis=1)
    want = one[f"{arch}/{prec}/one/forward"]
    got = _whole(results, f"{arch}/{prec}/{tag}", "forward")
    assert got.shape == want.shape == (B, S, 128)
    assert _err(got, want, alike) <= TOL[prec]
    want = one[f"{arch}/{prec}/one/prefill"]
    got = _whole(results, f"{arch}/{prec}/{tag}", "prefill")
    assert got.shape == want.shape == (B, 128)
    assert _err(got, want, alike[:, -1]) <= TOL[prec]


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_decode_matches_one_device(ranks, arch, prec, tag):
    """Each decode step's logits and greedy tokens (``make_serve_step``:
    the largest logit over the ranks' vocabulary columns); in bf16 on the
    rows whose tokens so far were routed alike and whose top two logits
    are further apart than the bound."""
    results, _ = ranks
    one = results[0]
    _, dec = _routed_otherwise(one, results, arch, prec, tag)
    if prec == "fp32":
        assert not dec.any()
    assert dec.sum() <= _allowance(arch, dec.size)
    alike = ~np.maximum.accumulate(dec, axis=0)
    for j in range(STEPS):
        want = one[f"{arch}/{prec}/one/decode{j}"]
        got = _whole(results, f"{arch}/{prec}/{tag}", f"decode{j}")
        assert got.shape == want.shape == (B, 128)
        assert _err(got, want, alike[j]) <= TOL[prec], j
        nxt = _whole(results, f"{arch}/{prec}/{tag}", f"next{j}")
        np.testing.assert_array_equal(one[f"{arch}/{prec}/one/next{j}"],
                                      np.argmax(want, -1))
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = alike[j] & ((top2[:, 1] - top2[:, 0])
                            > TOL[prec] * np.abs(want).max())
        if prec == "fp32":
            assert clear.all()
        np.testing.assert_array_equal(nxt[clear], np.argmax(want, -1)[clear])


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_aux_is_the_global_batch(ranks, arch, prec, tag):
    """Every layer's ``lb_loss`` and ``drop_frac`` in the forward and in
    each decode step, and the forward's aux (their sum), on every rank:
    the global batch's (equal on every rank), within 1e-6 of one device's
    in fp32; in bf16, where no route differs, ``drop_frac`` within 1e-6
    and ``lb_loss`` within 3e-2 (its router probabilities read an x that
    one device rounds otherwise)."""
    results, _ = ranks
    one = results[0]
    fwd, dec = _routed_otherwise(one, results, arch, prec, tag)
    pre = f"{arch}/{prec}"
    keys = [("aux", not fwd.any())]
    for i in range(2):
        keys += [(f"fwd{i}/{k}", not fwd.any())
                 for k in ("lb_loss", "drop_frac")]
        keys += [(f"dec{j}/{i}/{k}", not dec[j].any())
                 for j in range(STEPS) for k in ("lb_loss", "drop_frac")]
    for key, held in keys:
        got = _whole(results, f"{pre}/{tag}", key)
        assert got.shape == ()
        if held:
            want = float(one[f"{pre}/one/{key}"])
            # bf16: the router reads x one device rounds otherwise
            tol = (TOL[prec] if prec == "bf16" and "drop_frac" not in key
                   else AUX_TOL)
            assert abs(float(got) - want) <= tol * max(1.0, abs(want)), key


@pytest.mark.parametrize("arch,prec,tag", PARAMS, ids=IDS)
def test_sharded_matches_the_reference(ranks, arch, prec, tag):
    """The sharded forward's and decode steps' logits against the
    reference's ``forward`` and ``decode_step`` on the same weights and
    tokens (``test_torch_lm``'s bounds; in bf16 on the tokens routed
    alike with one device, whose routes are the reference's on these
    inputs)."""
    results, ref = ranks
    one = results[0]
    fwd, dec = _routed_otherwise(one, results, arch, prec, tag)
    want = ref[f"{arch}/{prec}"]
    got = _whole(results, f"{arch}/{prec}/{tag}", "forward")
    assert _err(got, want["forward"],
                ~np.maximum.accumulate(fwd, axis=1)) <= TOL[prec]
    alike = ~np.maximum.accumulate(dec, axis=0)
    for j in range(STEPS):
        got = _whole(results, f"{arch}/{prec}/{tag}", f"decode{j}")
        assert _err(got, want[f"decode{j}"], alike[j]) <= TOL[prec], j
