"""The dry run's LM cells of the dense family (ROADMAP §1 rows 19b and 21)
and the sharding policy, against the JAX package's.

The reference runs in one subprocess with 512 placeholder CPU devices (its
``launch/dryrun.py`` sets ``XLA_FLAGS`` on import).  On jax 0.9.0
``jax.make_mesh`` makes Explicit axes by default, and ``lower_cell`` then
raises ``ShardingTypeError`` at the embedding gather: the child builds the
production meshes with Auto axes instead (``make_production_mesh``
swapped), as the reference's mesh had them when it was written.  It gives:

* ``steps.param_shardings`` (with ``guard_divisibility`` and
  ``apply_fsdp``), ``batch_shardings`` and ``cache_shardings`` for the 4
  dense archs at full and smoke size, FSDP off and on, on 16×16 and
  2×16×16;
* ``steps.opt_state_shardings`` of adamw's and adafactor's state (its
  ``vr``/``vc`` the weight's spec less a dim) under both weight policies;
* ``lower_cell`` + ``analyze_cell`` for prefill_32k and decode_32k of the
  4 smoke configs and granite-3-2b at full size on both meshes, and
  ``run_cell``'s long_500k record;
* the train_4k cells of the 4 smoke configs on 16×16 and of granite-3-2b
  at full size with ``remat_block`` 0 and 4.

The port counts the same cells in this process (``launch.dryrun.run_cell``
on fake tensors) while the child runs.  FLOPs a device, the arguments'
bytes and MODEL_FLOPS must be equal; the collectives' kinds and counts
equal too, less one known difference: where the query heads split over
the model axis and the KV heads do not (granite-3-2b: 32 and 8 on 16), a
decode step's cache is split on its length and XLA gathers the queries and
sums the attention's output in two collectives each (over the model axis
seen as 2 × 8), one more all-gather and one more all-reduce a layer than
the port's one each (PERF.md §6).  A train cell's FLOPs a device,
arguments and MODEL_FLOPS are equal too; its collectives are all-reduces
on both sides, the port's held to their count by hand
(``_train_all_reduces``) and XLA's recorded beside them (PERF.md §6):
XLA sums the data-parallel gradient of each layer inside its
backward loop and combines the rest into tuples, the port issues one
all-reduce a leaf at the end, and under ``"dots"`` it issues wo's
all-reduce again in the recompute.

The MoE family (ROADMAP §1 row 22): kimi-k2-1t-a32b and deepseek-v3-671b
at full width with ``n_layers`` cut to ``MOE_LAYERS`` (2) alike in both
packages (the "cut" size; the reference lowers them in 2–7 s a cell),
prefill_32k and decode_32k on both meshes and train_4k on 16×16 (adamw:
at 2 layers neither is above 100 B parameters), and their policy (FSDP
on: both hold more than 8 GB of bf16 weights) at the cut and the smoke
sizes.  FLOPs a device, the arguments and MODEL_FLOPS are equal; the
port's collectives are held to a hand count (:func:`_moe_collectives`),
XLA's prefill and decode counts to the port's with each difference by
its cause (:func:`_xla_from_port`), its train counts to those recorded
(``XLA_TRAIN``; their causes in PERF.md §6).  long_500k is skipped
for both, as the reference skips a full-attention arch.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("granite-3-2b", "qwen1.5-4b", "deepseek-7b", "starcoder2-15b")
MOE = ("kimi-k2-1t-a32b", "deepseek-v3-671b")
MOE_LAYERS = 2                   # the "cut" size: full width, 2 layers
SHAPES = ("prefill_32k", "decode_32k")
MESHES = ("single", "multi")
CELLS = ([("smoke", a, s, m) for a in DENSE for s in SHAPES for m in MESHES]
         + [("full", "granite-3-2b", s, m) for s in SHAPES for m in MESHES])
TRAIN = ([("smoke", a, 0) for a in DENSE]
         + [("full", "granite-3-2b", rb) for rb in (0, 4)])
MOE_CELLS = [("cut", a, s, m) for a in MOE for s in SHAPES for m in MESHES]
MOE_TRAIN = [("cut", a, 0) for a in MOE]
POLICY = ([(size, a, m) for size in ("full", "smoke") for a in DENSE
           for m in MESHES]
          + [(size, a, m) for size in ("cut", "smoke") for a in MOE
             for m in MESHES])

REFERENCE = """
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
from repro import configs
from repro.launch import dryrun as D, steps
from repro.launch import hloanalysis as H

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

D.make_production_mesh = auto_mesh
cells, policy = json.loads(sys.argv[2]), json.loads(sys.argv[3])
train = json.loads(sys.argv[4])
full = configs.get_config
get = {"full": full, "smoke": configs.get_smoke_config,
       "cut": lambda a: dataclasses.replace(full(a),
                                            n_layers=int(sys.argv[5]))}

def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]

def paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in p): spec(v.spec) for p, v in flat}

out = {"policy": {}, "cells": {}}
for size, arch, mk in policy:
    cfg = get[size](arch)
    mesh = auto_mesh(multi_pod=mk == "multi")
    params, specs = steps.abstract_params(cfg)
    rec = {f"fsdp={f}": paths(steps.param_shardings(mesh, params, specs, f))
           for f in (False, True)}
    for s in ("prefill_32k", "decode_32k"):
        rec[s] = paths(steps.batch_shardings(
            mesh, configs.input_specs(cfg, configs.SHAPES[s])))
    st = jax.eval_shape(lambda: D.T.init_decode_state(cfg, 128, 32768))
    rec["cache"] = paths(steps.cache_shardings(mesh, cfg, st.caches))
    for name in ("adamw", "adafactor"):
        opt = getattr(D.optimizers, name)()
        opt_sds = jax.eval_shape(opt.init, params)
        for f in (False, True):
            psh = steps.param_shardings(mesh, params, specs, f)
            rec[f"{name}-fsdp={f}"] = paths(
                steps.opt_state_shardings(mesh, opt_sds, psh))
    out["policy"][f"{size}-{arch}-{mk}"] = rec
for size, arch, s, mk in cells:
    configs.get_config = D.configs.get_config = get[size]
    compiled, meta = D.lower_cell(arch, s, mk == "multi")
    r = D.analyze_cell(compiled, meta)
    out["cells"][f"{size}-{arch}-{s}-{mk}"] = {
        "flops": r["hlo"]["flops_per_device"],
        "n_collectives": r["hlo"]["n_collectives"],
        "arguments": r["bytes_per_device"]["arguments"],
        "model_flops": r["model_flops"], "n_chips": r["n_chips"]}
    del compiled
for size, arch, rb in train:
    configs.get_config = D.configs.get_config = get[size]
    compiled, meta = D.lower_cell(arch, "train_4k", False, rb)
    r = D.analyze_cell(compiled, meta)
    out["cells"][f"{size}-{arch}-train_4k-rb{rb}"] = {
        "flops": r["hlo"]["flops_per_device"],
        "n_collectives": r["hlo"]["n_collectives"],
        "arguments": r["bytes_per_device"]["arguments"],
        "model_flops": r["model_flops"], "n_chips": r["n_chips"]}
    del compiled
for mk in ("single", "multi"):
    out["cells"][f"long_500k-{mk}"] = D.run_cell(
        "granite-3-2b", "long_500k", mk, force=True, out_root=sys.argv[1])
print(json.dumps(out))
"""


_FULL = configs.get_config
_config = {"full": _FULL, "smoke": configs.get_smoke_config,
           "cut": lambda a: dataclasses.replace(_FULL(a),
                                                n_layers=MOE_LAYERS)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's results, the port's cell records), the port's
    counted here while the reference's child runs."""
    work = tmp_path_factory.mktemp("dryrun_lm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(work),
         json.dumps(CELLS + MOE_CELLS), json.dumps(POLICY),
         json.dumps(TRAIN + MOE_TRAIN), str(MOE_LAYERS)], env=env,
        cwd=ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for size, arch, s, mk in CELLS + MOE_CELLS:
            with pytest.MonkeyPatch.context() as mp:
                if size != "full":
                    mp.setattr(configs, "get_config", _config[size])
                port[f"{size}-{arch}-{s}-{mk}"] = DR.run_cell(
                    arch, s, mk, force=True, out_root=str(work / size),
                    device="cpu")
        for size, arch, rb in TRAIN + MOE_TRAIN:
            with pytest.MonkeyPatch.context() as mp:
                if size != "full":
                    mp.setattr(configs, "get_config", _config[size])
                port[f"{size}-{arch}-train_4k-rb{rb}"] = DR.run_cell(
                    arch, "train_4k", "single", force=True,
                    out_root=str(work / size), remat_block=rb, device="cpu")
        for mk in MESHES:
            port[f"long_500k-{mk}"] = DR.run_cell(
                "granite-3-2b", "long_500k", mk, force=True,
                out_root=str(work / "full"), device="cpu")
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), port


def _xla_splits(arch: str, size: str, shape: str) -> int:
    """One more all-gather and all-reduce a layer in XLA's decode step when
    the query heads split over the model axis of 16 and the KV heads do
    not (see the module docstring)."""
    cfg = _config[size](arch)
    if shape == "decode_32k" and cfg.n_heads % 16 == 0 \
            and cfg.n_kv_heads % 16:
        return cfg.n_layers
    return 0


@pytest.mark.parametrize("size,arch,shape,mk", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_lm_cell_against_the_reference(both, size, arch, shape, mk):
    ref, port = both
    key = f"{size}-{arch}-{shape}-{mk}"
    want, got = ref["cells"][key], port[key]
    assert "error" not in got, got.get("traceback")
    h = got["hlo"]
    assert h["flops_per_device"] == want["flops"]
    assert got["bytes_per_device"]["arguments"] == want["arguments"]
    assert (got["model_flops"], got["n_chips"]) == (want["model_flops"],
                                                    want["n_chips"])
    split = _xla_splits(arch, size, shape)
    expect = {k: int(v) - (split if k in ("all-gather", "all-reduce")
                           else 0)
              for k, v in want["n_collectives"].items()}
    assert h["n_collectives"] == {k: v for k, v in expect.items() if v}
    assert "end_gathers" not in h


def _train_all_reduces(cfg, rb: int) -> int:
    """The port's all-reduces of one train step on 16×16 (no FSDP): the
    forward's psums (the split embedding, wo's and down's, the split
    vocabulary's max, Σexp and label logit), those the recompute issues
    again (wo's under ``"dots"``: the layer's recompute stops before
    down's; a block of ``rb`` layers the forward's again), the backward's
    (the attention's and the MLP's input, a KV weight that ranks project
    in part, the logits' input), and at the end one a weight leaf for the
    data mean, one for loss and aux, one for gnorm."""
    p = 16
    heads, ffn, vocab = (cfg.n_heads % p == 0, cfg.d_ff % p == 0,
                         cfg.vocab % p == 0)
    kv_part = heads and cfg.n_kv_heads % p != 0
    per_fwd = heads + ffn
    fwd = vocab + cfg.n_layers * per_fwd + 3 * vocab
    again = cfg.n_layers * (heads if cfg.remat_policy == "dots" else 0)
    if rb:
        again += cfg.n_layers * per_fwd
    kv_w = (4 if cfg.qkv_bias else 2) * kv_part
    bwd = cfg.n_layers * (heads + ffn + kv_w) + vocab
    leaves = len(T.param_specs(cfg))
    return fwd + again + bwd + leaves + 1 + 1


@pytest.mark.parametrize("size,arch,rb", TRAIN,
                         ids=[f"{s}-{a}-rb{rb}" for s, a, rb in TRAIN])
def test_train_cell_against_the_reference(both, size, arch, rb):
    """train_4k on 16×16: FLOPs a device (forward, recompute, backward),
    the arguments (the weights', adamw's state's and the batch's tiles)
    and MODEL_FLOPS equal to ``lower_cell``'s; all-reduces only, on both
    sides, the port's its hand count."""
    ref, port = both
    key = f"{size}-{arch}-train_4k-rb{rb}"
    want, got = ref["cells"][key], port[key]
    assert "error" not in got, got.get("traceback")
    h = got["hlo"]
    assert h["flops_per_device"] == want["flops"]
    assert got["bytes_per_device"]["arguments"] == want["arguments"]
    assert (got["model_flops"], got["n_chips"]) == (want["model_flops"],
                                                    want["n_chips"])
    assert set(h["n_collectives"]) == set(want["n_collectives"]) == \
        {"all-reduce"}
    cfg = _config[size](arch)
    assert h["n_collectives"]["all-reduce"] == _train_all_reduces(cfg, rb)
    assert got["bytes_per_device"]["outputs"] == 12     # loss, aux, gnorm


# XLA's collectives in the reference's MoE train cells (``lower_cell`` with
# Auto axes on jax 0.9.0, 2 layers at full width), beside the port's (the
# prefill and decode cells' are derived from the port's by their causes,
# :func:`_xla_from_port`)
XLA_TRAIN = {
    "kimi-k2-1t-a32b": {"all-gather": 70, "collective-permute": 23,
                        "all-reduce": 30, "all-to-all": 2},
    "deepseek-v3-671b": {"all-gather": 78, "collective-permute": 35,
                         "all-reduce": 25, "all-to-all": 2},
}


def _xla_from_port(cfg, shape: str, mk: str, port: dict) -> dict:
    """XLA's collectives in a MoE prefill or decode cell, from the port's,
    each difference by its cause (a layer's, × L, then the step's):

    1. the combine: the reference's ``shard_hint(weighted, "data")``
       leaves the slot buffer's dims past the batch whole, so XLA gathers
       the (B, E·C, D) buffer over the model axis and scatter-adds on
       every rank (+1 all-gather), where the port sums its experts' terms
       and all-reduces (B, S, D) (−1 all-reduce); in 16×16 decode XLA
       also all-reduces the scatter's rows (+1 all-reduce);
    2. the router statistics: XLA gathers the probabilities (B, S, E) over
       the data axes (+1 all-gather), the port sums 2E + 1 numbers over
       them (−1 all-reduce);
    3. the dispatch: the reference's sink slot makes E·C + 1 slots, which
       the model axis does not divide; XLA moves 15 slots' token ids,
       rows and gates to the next rank (+3 collective-permutes);
    4. on 16×16 an FSDP tile whole on the model axis is moved across the
       mesh's transpose (+1 collective-permute each: MLA's wq_a, wkv_a
       and the router; GQA's router in prefill, its wk, wv and router in
       decode); the port's decode moves them too, but its rank 0 lies on
       the transpose's diagonal and keeps its own tile, and its prefill
       gathers them over the data axis (the same all-gather);
    5. 16×16 decode: XLA sums the three row-split products in one
       all-reduce, the port in three (−2 all-reduces);
    6. decode: XLA gathers the activations over the data axes for wo and
       the shared expert's down (their FSDP-split weights stay put; the
       same count of all-gathers) and returns the rows with an all-to-all
       (+2 all-to-alls);
    7. GQA decode with the cache split on its length: XLA gathers q and
       sums the output in two stages over the model axis seen as 2 × 8
       (+1 all-gather, +1 all-reduce), as in granite's decode;
    8. the step: XLA gathers the token ids over the data axes (in two
       stages on 2×16×16: +1 all-gather there) and moves them across the
       transpose (+1 collective-permute), and returns the embedding's
       rows with an all-to-all (+1); the port gathers the embedding's
       FSDP tile (the same count)."""
    L, mla = cfg.n_layers, cfg.use_mla
    single, decode = mk == "single", shape == "decode_32k"
    out = {k: port.get(k, 0) for k in ("all-gather", "all-reduce")}
    out["collective-permute"] = out["all-to-all"] = 0
    out["all-gather"] += 2 * L                              # 1, 2
    out["all-reduce"] += (-2 + (decode and single)) * L     # 1, 2
    out["collective-permute"] += 3 * L                      # 3
    if single:                                              # 4
        out["collective-permute"] += (3 if mla or decode else 1) * L
    if decode and single:                                   # 5
        out["all-reduce"] -= 2 * L
    if decode:                                              # 6
        out["all-to-all"] += 2 * L
    if decode and not mla:                                  # 7
        out["all-gather"] += L
        out["all-reduce"] += L
    out["all-gather"] += not single                         # 8
    out["collective-permute"] += 1
    out["all-to-all"] += 1
    return out


def _moe_collectives(cfg, shape: str, mk: str) -> dict:
    """The port's collectives in a MoE cell (FSDP on: every leaf's tile
    gathered over the data axes), by hand.  A layer has ``n`` weight
    leaves (MLA 6 or GQA 4 attention weights, router, gate, up, down, the
    shared expert's 3, 2 norms).  Its forward all-reduces wo's, the
    combine's and the shared expert's partial products and the router
    statistics over the data axes (4).  Outside the layers: the embedding's
    and the final norm's and unembedding's gathers (3), the split
    embedding's sum (1); decode's greedy token gathers value and index
    (2).  On 16×16 three model-whole weights FSDP splits on their rows
    (MLA's wq_a, wkv_a or GQA's wk, wv, and the router) are read by their
    rows in decode (``transformer._row_tile``: a transpose permute that
    rank 0, on the mesh's diagonal, keeps to itself, and an all-reduce of
    the products instead of a gather); in training the 2-D ones (MLA 3,
    GQA the router) gather as before and reduce their gradient with an
    all-reduce over the data axis (and the same permute) instead of a
    reduce-scatter.  Decode with the cache split on its length gathers the
    query heads (MLA: q_nope, q_rope, wk_b and wv_b) and sums softmax's
    max, sum and output (3).  train_4k under ``"dots"`` recomputes each
    layer's gathers and its 4 all-reduces; the backward sums the
    gradients of the tensors that enter split weights (MLA: q_a and the
    latent, GQA: x and the two KV weights a rank projects in part; the
    experts' x and gate weights, the shared expert's x: 5), the router
    statistics' cotangent (1) and the RowShards' gradients; then the
    loss' split-vocabulary max, Σexp, label logit and its input's
    gradient (4), the loss' data mean and gnorm (2)."""
    mla = cfg.use_mla
    n = (6 if mla else 4) + 4 + 3 * (cfg.n_shared_experts > 0) + 2
    L = cfg.n_layers
    single = mk == "single"
    if shape == "prefill_32k":
        return {"all-gather": n * L + 3, "all-reduce": 4 * L + 1}
    if shape == "decode_32k":
        rows = 3 if single else 0
        split = 4 if mla else 1
        return {"all-gather": (n - rows + split) * L + 5,
                "all-reduce": (rows + 3 + 4) * L + 1}
    shard = 3 if mla else 1
    bwd = 5 + 1 + shard + (0 if mla else 1)
    return {"all-gather": 2 * n * L + 3, "reduce-scatter": (n - shard) * L + 3,
            "all-reduce": (8 + bwd) * L + 7}


MOE_KEYS = ([f"{size}-{a}-{s}-{m}" for size, a, s, m in MOE_CELLS]
            + [f"{size}-{a}-train_4k-rb0" for size, a, _ in MOE_TRAIN])


@pytest.mark.parametrize("key", MOE_KEYS)
def test_moe_cell_against_the_reference(both, key):
    """A MoE cell at full width, 2 layers in both packages: FLOPs a device,
    the arguments' bytes and MODEL_FLOPS equal to ``lower_cell``'s; the
    port's collectives its hand count (:func:`_moe_collectives`), XLA's
    the port's with each difference by its cause (:func:`_xla_from_port`)
    or, for train_4k, those recorded in ``XLA_TRAIN``."""
    ref, port = both
    want, got = ref["cells"][key], port[key]
    assert "error" not in got, got.get("traceback")
    h = got["hlo"]
    assert h["flops_per_device"] == want["flops"]
    assert got["bytes_per_device"]["arguments"] == want["arguments"]
    assert (got["model_flops"], got["n_chips"]) == (want["model_flops"],
                                                    want["n_chips"])
    arch = next(a for a in MOE if key.startswith(f"cut-{a}-"))
    shape = key[len(f"cut-{arch}-"):].split("-")[0]
    mk = "single" if shape == "train_4k" else key.rsplit("-", 1)[1]
    cfg = _config["cut"](arch)
    assert h["n_collectives"] == _moe_collectives(cfg, shape, mk)
    xla = {k: int(v) for k, v in want["n_collectives"].items()}
    if shape == "train_4k":
        assert xla == XLA_TRAIN[arch]
        assert got["bytes_per_device"]["outputs"] == 12  # loss, aux, gnorm
    else:
        assert xla == _xla_from_port(cfg, shape, mk, h["n_collectives"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_long_500k_is_skipped(arch, tmp_path):
    """long_500k is not a cell of a full-attention arch, as the reference
    decides (``configs.cell_supported``): both MoE archs' records say
    skipped, with the reference's reason."""
    for mk in MESHES:
        r = DR.run_cell(arch, "long_500k", mk, out_root=str(tmp_path),
                        device="cpu")
        assert r == {"arch": arch, "shape": "long_500k",
                     "mesh": "2x16x16" if mk == "multi" else "16x16",
                     "skipped": "pure full-attention arch — 500k decode "
                                "skipped (DESIGN.md)"}


@pytest.mark.parametrize("mk", MESHES)
def test_long_500k_is_skipped_as_the_reference_skips_it(both, mk):
    ref, port = both
    assert port[f"long_500k-{mk}"] == ref["cells"][f"long_500k-{mk}"]
    assert "skipped" in port[f"long_500k-{mk}"]


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


@pytest.mark.parametrize("size,arch,mk", POLICY,
                         ids=["-".join(c) for c in POLICY])
def test_policy_against_the_reference(both, size, arch, mk):
    """param_shardings (FSDP off and on), batch_shardings of the prefill
    and decode inputs and cache_shardings of the decode state: the
    reference's specs, leaf for leaf."""
    want = both[0]["policy"][f"{size}-{arch}-{mk}"]
    cfg = _config[size](arch)
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=mk == "multi", device="cpu")
    try:
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
            caches = T.init_decode_state(cfg, 128, 32768,
                                         device="cpu").caches
        for fsdp in (False, True):
            got = steps.param_shardings(mesh, params, specs, fsdp)
            assert {k: _spec(v) for k, v in got.items()} == \
                want[f"fsdp={fsdp}"]
        for s in SHAPES:
            got = steps.batch_shardings(
                mesh, configs.input_specs(cfg, configs.SHAPES[s]))
            assert {k: _spec(v) for k, v in got.items()} == want[s]
        got = steps.cache_shardings(mesh, cfg, caches)
        assert {k: _spec(v) for k, v in got.items()} == want["cache"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("size,arch,mk", POLICY,
                         ids=["-".join(c) for c in POLICY])
def test_opt_state_policy_against_the_reference(both, size, arch, mk):
    """opt_state_shardings of adamw's and adafactor's state on fake
    tensors, under the weights' specs with FSDP off and on: the
    reference's, leaf for leaf ("step" and "inner/<weight>/<state>")."""
    want = both[0]["policy"][f"{size}-{arch}-{mk}"]
    cfg = _config[size](arch)
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=mk == "multi", device="cpu")
    try:
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
            states = {name: getattr(O, name)().init(params)
                      for name in ("adamw", "adafactor")}
        for name, state in states.items():
            for fsdp in (False, True):
                psh = steps.param_shardings(mesh, params, specs, fsdp)
                got = steps.opt_state_shardings(mesh, state, psh)
                flat = {"step": _spec(got.step)}
                flat.update({f"inner/{path}/{k}": _spec(v)
                             for path, st in got.inner.items()
                             for k, v in st.items()})
                assert flat == want[f"{name}-fsdp={fsdp}"], (name, fsdp)
    finally:
        dist.destroy_process_group()


def test_rank_tiles_on_fake_tensors():
    """A rank's tiles under the resolved specs, cut from fake weights into
    storages of their own size: granite-3-2b at full size on 16×16 keeps
    its 8 KV heads and its vocabulary of 49155 whole (neither divides by
    16) and splits the heads, d_ff, the batch and the cache's length."""
    mesh = make_production_mesh(device="cpu")
    try:
        cfg = configs.get_config("granite-3-2b")
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
            sh = steps.param_shardings(mesh, params, specs, fsdp=False)
            tiles = steps.shard_params(params, sh, mesh).ref_leaves()
            batch = configs.input_specs(cfg, configs.SHAPES["decode_32k"],
                                        device="cpu")
            local = steps.shard_batch(
                batch, steps.batch_shardings(mesh, batch), mesh)
            whole = T.init_decode_state(cfg, 128, 32768, device="cpu")
            state = steps.shard_state(
                whole, steps.cache_shardings(mesh, cfg, whole.caches), mesh)
        assert tiles["layers/attn/wq"].shape == (40, 2048, 2, 64)
        assert tiles["layers/attn/wk"].shape == (40, 2048, 8, 64)
        assert tiles["layers/attn/wo"].shape == (40, 2, 64, 2048)
        assert tiles["layers/mlp/down"].shape == (40, 512, 2048)
        assert tiles["embed"].shape == (49155, 2048)
        wq = tiles["layers/attn/wq"].tensors[0]
        assert wq.untyped_storage().nbytes() == 2048 * 2 * 64 * 2
        assert local["tokens"].shape == (8, 1)
        assert state.caches["k"].shape == (40, 8, 2048, 8, 64)
        assert state.shardings["k"] == (None, "data", "model", None, None)
    finally:
        dist.destroy_process_group()


def test_the_one_device_path_is_untouched():
    """With no mesh declared the forward is the one-device code: weights
    without shardings run, and a mesh declared for weights that are not a
    rank's tiles is refused."""
    from repro_torch.models.common import clear_mesh_axes, set_mesh_axes

    cfg = configs.get_smoke_config("granite-3-2b")
    params = T.init_params(0, cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    logits, _ = T.forward(params, toks, cfg, kernels="torch")
    assert logits.shape == (1, 4, cfg.vocab) and params.shardings is None
    set_mesh_axes(("data",), mesh=object())
    try:
        with pytest.raises(ValueError, match="shard_params"):
            T.forward(params, toks, cfg, kernels="torch")
    finally:
        clear_mesh_axes()
