"""The dense family's sharded prefill and decode (``launch.steps``'
sharding policy, ``models.common.TPLayout``) on 4 gloo ranks against the
one-device port.

Each rank builds granite's smoke config from one seed (whole weights, the
same on every rank), takes its tiles under the policy
(``steps.shard_params``, ``shard_batch``, ``shard_state``) on a
("data", "model") mesh of 2 × 2 (heads, KV heads, d_ff and the vocabulary
split on the model axis; the KV cache on its heads) and of 1 × 4 (the KV
heads whole: prefill projects only those its query heads read, decode
reads a cache split on its length with every query head), each also with
FSDP forced (every weight's largest free dim over the data axes, gathered
before use), and runs ``make_prefill_step`` and two decode steps with the
mesh declared (``common.set_mesh_axes(..., mesh=mesh)``).  The test puts
each result back together from the ranks' shards by their mesh
coordinates.

Tolerances: fp32 within 1e-5 of the one-device logits' largest
magnitude; bf16 within ``tests/test_torch_lm.py``'s 3e-2 (the partial
products are rounded to bf16 before their sum over the model axis).
Greedy tokens: equal in fp32, and in bf16 wherever the one-device top two
logits are further apart than that bound.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 200
TOL = {"fp32": 1e-5, "bf16": 3e-2}
MESHES = ("2x2", "1x4")
TAGS = [f"{m}{f}" for m in MESHES for f in ("", "-fsdp")]
STEPS = 2

_RANK = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import data_axis_names, device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes

    out = {}
    meshes = {"2x2": device_mesh((2, 2), ("data", "model"), "cpu"),
              "1x4": device_mesh((1, 4), ("data", "model"), "cpu")}
    for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(configs.get_smoke_config("granite-3-2b"),
                                  dtype=dt)
        params = T.init_params(0, cfg, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, size=(4, 8))).long()
        batch = {"tokens": toks}
        prefill = steps.make_prefill_step(cfg, kernels="torch", flash=False)
        serve = steps.make_serve_step(cfg)
        out[f"{prec}/one/prefill"] = prefill(params, batch)
        st = T.init_decode_state(cfg, 4, 16, device="cpu")
        for j in range(%(steps)d):
            logits, st = T.decode_step(params, toks[:, j:j + 1], st, cfg)
            out[f"{prec}/one/decode{j}"] = logits[:, 0]
        for name, mesh in meshes.items():
            for fsdp in (False, True):
                tag = f"{prec}/{name}{'-fsdp' if fsdp else ''}"
                set_mesh_axes(data_axis_names(mesh), mesh=mesh)
                try:
                    sh = steps.param_shardings(mesh, params,
                                               T.param_specs(cfg), fsdp)
                    rp = steps.shard_params(params, sh, mesh)
                    local = steps.shard_batch(
                        batch, steps.batch_shardings(mesh, batch), mesh)
                    out[tag + "/prefill"] = prefill(rp, local)
                    whole = T.init_decode_state(cfg, 4, 16, device="cpu")
                    st = steps.shard_state(
                        whole, steps.cache_shardings(mesh, cfg, whole.caches),
                        mesh)
                    for j in range(%(steps)d):
                        tj = local["tokens"][:, j:j + 1]
                        copy = st._replace(caches={
                            k: v.clone() for k, v in st.caches.items()})
                        logits, _ = T.decode_step(rp, tj, copy, cfg)
                        nxt, st = serve(rp, {"tokens": tj}, st)
                        out[f"{tag}/decode{j}"] = logits[:, 0]
                        out[f"{tag}/next{j}"] = nxt[:, 0]
                    out[tag + "/coords"] = torch.tensor([
                        dist.get_rank(mesh.group("data")),
                        dist.get_rank(mesh.group("model")),
                        int(sh["unembed"][1] == "model")])
                finally:
                    clear_mesh_axes()
    np.savez(f"{work}/rank{rank}.npz",
             **{k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in out.items()})
    dist.destroy_process_group()
""") % {"steps": STEPS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("lm_sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for r, proc in enumerate(procs):
        try:
            log, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"rank {r} did not finish in {TIMEOUT} s")
        assert proc.returncode == 0, f"rank {r} failed:\n{log[-5000:]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


def _whole(ranks, tag, what):
    """A result put back together from the ranks' shards: rows by the data
    coordinate, vocabulary columns by the model coordinate when unembed is
    split on them (a token a row by the data coordinate alone)."""
    coords = {}
    for r in ranks:
        d, m, split = (int(x) for x in r[tag + "/coords"])
        coords[(d, m)] = r[f"{tag}/{what}"]
    p1 = max(d for d, _ in coords) + 1
    p2 = max(m for _, m in coords) + 1
    rows = []
    for d in range(p1):
        if split and not what.startswith("next"):
            rows.append(np.concatenate([coords[(d, m)] for m in range(p2)],
                                       axis=-1))
        else:
            for m in range(1, p2):       # replicated over "model"
                np.testing.assert_array_equal(coords[(d, m)], coords[(d, 0)])
            rows.append(coords[(d, 0)])
    return np.concatenate(rows, axis=0)


def _err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


CASES = [(p, t) for p in TOL for t in TAGS]


@pytest.mark.parametrize("prec,tag", CASES)
def test_sharded_prefill_matches_one_device(ranks, prec, tag):
    want = ranks[0][f"{prec}/one/prefill"]
    got = _whole(ranks, f"{prec}/{tag}", "prefill")
    assert got.shape == want.shape == (4, 128)
    assert _err(got, want) <= TOL[prec]


@pytest.mark.parametrize("prec,tag", CASES)
def test_sharded_decode_matches_one_device(ranks, prec, tag):
    for j in range(STEPS):
        want = ranks[0][f"{prec}/one/decode{j}"]
        got = _whole(ranks, f"{prec}/{tag}", f"decode{j}")
        assert got.shape == want.shape
        assert _err(got, want) <= TOL[prec], j


@pytest.mark.parametrize("prec,tag", CASES)
def test_sharded_greedy_tokens(ranks, prec, tag):
    """``make_serve_step``'s tokens: the largest logit over the ranks'
    vocabulary columns, ties to the lowest index."""
    for j in range(STEPS):
        logits = ranks[0][f"{prec}/one/decode{j}"]
        got = _whole(ranks, f"{prec}/{tag}", f"next{j}")
        want = np.argmax(logits, axis=-1)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > TOL[prec] * np.abs(logits).max()
        if prec == "fp32":
            assert clear.all()
        np.testing.assert_array_equal(got[clear], want[clear])
