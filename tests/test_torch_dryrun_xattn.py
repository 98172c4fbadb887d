"""The dry run's LM cells of the encoder-decoder and VLM families (ROADMAP
§1 row 22) and their sharding policy, against the JAX package's.

As ``tests/test_torch_dryrun_ssm.py`` does, the reference runs in one
subprocess with 512 placeholder CPU devices and the production meshes
built with Auto axes.  It gives ``param_shardings`` (FSDP off and on),
``batch_shardings``, ``cache_shardings`` and ``opt_state_shardings`` of
whisper-small and llama-3.2-vision-11b at full and smoke size on both
meshes, and ``lower_cell`` + ``analyze_cell`` of:

* whisper-small at full size: prefill_32k and decode_32k on 16×16 and
  2×16×16, train_4k on 16×16;
* llama-3.2-vision-11b at full width cut to ``VLM_LAYERS`` (10) layers
  alike in both packages (2 cross layers; 3.3 B parameters, FSDP off):
  the same five cells;
* llama-3.2-vision-11b at full depth (40 layers, FSDP on): decode_32k on
  16×16.

The port counts the same cells in this process (``launch.dryrun.run_cell``
on fake tensors) while the child runs, and the cut VLM's prefill and train
cells again with its cross layers never applied (``cross_attn_every``
10⁶): the difference is the cross applications' FLOPs as the port counts
them.

* Arguments a device and MODEL_FLOPS are equal in every cell.  whisper's
  decode step reads no encoder weight; ``jax.jit`` leaves those out of
  its arguments (``keep_unused=False``), and so does the port's count
  (``dryrun._UNREAD``).
* FLOPs a device are equal in whisper's cells and in the VLM's decode
  cells: its 12 heads, whole on a model axis of 16, run whole on every
  rank in both, its MLP split on d_ff; the VLM's cross K/V weights, whole
  on the model axis and FSDP-split on their rows at full depth, are
  gathered, not read by their rows, in both.  One cause parts the VLM's
  prefill and train cells, counted (:func:`_xla_from_port`): the reference
  runs each cross layer under ``lax.cond`` inside the layer scan and
  ``analyze_cell`` counts a conditional's branch whether it is taken or
  not, so XLA's FLOPs are the port's plus (L − L // cross_attn_every)
  cross applications.
* The port's collectives are held to a hand count
  (:func:`_port_collectives`); XLA's are recorded (``XLA_COLLECTIVES``),
  their differences' causes in PERF.md §6.
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

from repro import configs as jax_configs
from repro_torch import configs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps
from repro_torch.launch.mesh import data_axis_names, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
from repro_torch.optim import optimizers as O

ROOT = Path(__file__).resolve().parents[1]
WHISPER, VLM = "whisper-small", "llama-3.2-vision-11b"
VLM_LAYERS = 10                  # the "cut" size: full width, 10 layers
NO_CROSS = 10 ** 6               # a cross_attn_every that never applies one
SHAPES = ("prefill_32k", "decode_32k")
MESHES = ("single", "multi")
CELLS = ([("full", WHISPER, s, m) for s in SHAPES for m in MESHES]
         + [("full", WHISPER, "train_4k", "single")]
         + [("cut", VLM, s, m) for s in SHAPES for m in MESHES]
         + [("cut", VLM, "train_4k", "single"),
            ("full", VLM, "decode_32k", "single")])
POLICY = [(size, a, m) for size in ("full", "smoke") for a in (WHISPER, VLM)
          for m in MESHES]

# XLA's collectives in the reference's cells (``lower_cell`` with Auto axes
# on jax 0.9.0), beside the port's hand count (their causes: PERF.md §6)
XLA_COLLECTIVES = {
    f"full-{WHISPER}-prefill_32k-single": {"all-reduce": 24},
    f"full-{WHISPER}-prefill_32k-multi": {"all-reduce": 24},
    f"full-{WHISPER}-decode_32k-single": {"all-reduce": 48},
    f"full-{WHISPER}-decode_32k-multi": {"all-reduce": 48},
    f"full-{WHISPER}-train_4k-single": {"all-reduce": 74},
    f"cut-{VLM}-prefill_32k-single": {"all-reduce": 31},
    f"cut-{VLM}-prefill_32k-multi": {"all-reduce": 31},
    f"cut-{VLM}-decode_32k-single": {"all-reduce": 63, "all-gather": 22},
    f"cut-{VLM}-decode_32k-multi": {"all-reduce": 63, "all-gather": 22},
    f"cut-{VLM}-train_4k-single": {"all-reduce": 119},
    f"full-{VLM}-decode_32k-single": {"all-gather": 405, "all-reduce": 289,
                                      "all-to-all": 89,
                                      "collective-permute": 81},
}

REFERENCE = """
import dataclasses, json, sys
import jax
from jax.sharding import AxisType
from repro import configs
from repro.launch import dryrun as D, steps

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

D.make_production_mesh = auto_mesh
cells, policy = json.loads(sys.argv[1]), json.loads(sys.argv[2])
layers = int(sys.argv[3])
full = configs.get_config
get = {"full": full, "smoke": configs.get_smoke_config,
       "cut": lambda a: dataclasses.replace(full(a), n_layers=layers)}

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
    for s in ("train_4k", "prefill_32k", "decode_32k"):
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
print(json.dumps(out))
"""

_FULL = configs.get_config
_config = {"full": _FULL, "smoke": configs.get_smoke_config,
           "cut": lambda a: dataclasses.replace(_FULL(a), n_layers=VLM_LAYERS)}


def _count(work: Path, size: str, arch: str, shape: str, mk: str,
           **replace) -> dict:
    """The port's record of one cell, the config of ``size`` with
    ``replace``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "get_config", lambda a: dataclasses.replace(
            _config[size](a), **replace))
        return DR.run_cell(arch, shape, mk, force=True,
                           out_root=str(work / size), device="cpu")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's results, the port's records, the port's cut VLM
    prefill and train records with no cross layer applied), the port's
    counted here while the reference's child runs."""
    work = tmp_path_factory.mktemp("dryrun_xattn")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS),
         json.dumps(POLICY), str(VLM_LAYERS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port, bare = {}, {}
        for size, arch, s, mk in CELLS:
            key = f"{size}-{arch}-{s}-{mk}"
            port[key] = _count(work, size, arch, s, mk)
            if size == "cut" and s != "decode_32k":
                bare[key] = _count(work / "bare", size, arch, s, mk,
                                   cross_attn_every=NO_CROSS)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), port, bare


def _xla_from_port(cfg, key: str, port: dict, bare: dict) -> float:
    """XLA's FLOPs a device from the port's: with the cross layers counted
    in every layer (one application's FLOPs: the port's cell less the same
    cell with no cross layer applied, over its L // cross_attn_every
    applications) in the VLM's prefill and train cells."""
    flops = port[key]["hlo"]["flops_per_device"]
    if key in bare:
        n = cfg.n_layers // cfg.cross_attn_every
        once = (flops - bare[key]["hlo"]["flops_per_device"]) / n
        flops += (cfg.n_layers - n) * once
    return flops


def _fsdp_leaves(cfg, prefix: str) -> int:
    """How many leaves under ``prefix`` FSDP splits over the data axes on
    16×16 (each is gathered at every use)."""
    mesh = make_production_mesh(device="cpu")
    try:
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
        sh = steps.param_shardings(mesh, params, specs, True)
    finally:
        dist.destroy_process_group()
    return sum(any(ax not in (None, "model") for ax in sp)
               for path, sp in sh.items() if path.startswith(prefix))


def _port_collectives(cfg, shape: str) -> dict:
    """The port's collectives in a cell, by hand, on a model axis of 16.

    whisper-small: its 12 heads and vocabulary of 51865 whole, d_ff split.
    A prefill all-reduces each gelu MLP's products (Lₑ + L); a decode step
    reads its self-attention's cache split on its length (softmax's max,
    sum and output summed: 3 a layer) beside the MLP's (1); train_4k adds
    the backward's sum of each MLP input's gradient (Lₑ + L; under
    ``"dots"`` no all-reduce is recomputed: each feeds only its layer's
    output) and, at the end, one all-reduce a leaf (the data mean), one
    for the loss and one for gnorm.

    llama-3.2-vision-11b: 32 query heads split, 8 KV heads whole, d_ff and
    the vocabulary of 128256 split.  A prefill all-reduces a dense layer's
    wo and down products (2) and a cross layer's wo (1), and sums the split
    embedding's rows (1).  A decode step gathers the query heads over the
    model axis and reads the cache split on its length (1 all-gather, 3
    all-reduces) beside wo's and down's; greedy gathers value and index
    (2).  At full depth FSDP gathers each data-split leaf at each use (a
    dense layer's, a cross layer's and ``ln_cross`` at each of them, the
    embedding, final norm and unembedding) but for a dense layer's wk and
    wv, read by their rows (an all-reduce of the products each).
    train_4k's backward sums the gradients of each attention's input and
    of the wk and wv a rank projects in part (3; a cross layer's patches
    need none), of each MLP input (1) and of the logits' input (1); the
    loss over the split vocabulary all-reduces its max, Σexp and label
    logit (3); under ``"dots"`` the recompute issues a dense layer's wo
    all-reduce again, and down's before a cross layer; then the data mean,
    loss and gnorm as whisper's."""
    L, train = cfg.n_layers, shape == "train_4k"
    leaves = len(T.param_specs(cfg))
    if cfg.family == "encdec":
        mlps = cfg.n_enc_layers + L
        if shape == "prefill_32k":
            return {"all-reduce": mlps}
        if shape == "decode_32k":
            return {"all-reduce": 4 * L}
        return {"all-reduce": 2 * mlps + leaves + 2}
    n = L // cfg.cross_attn_every
    fwd = 2 * L + n + 1
    if shape == "prefill_32k":
        return {"all-reduce": fwd}
    if train:
        bwd = 4 * L + 3 * n + 1
        return {"all-reduce": fwd + bwd + 3 + (L + n) + leaves + 2}
    fsdp = cfg.param_count()[0] * 2 > 8e9
    rows = 2 if fsdp else 0
    gathers = 0
    if fsdp:
        gathers = ((_fsdp_leaves(cfg, "layers/") - rows) * L
                   + (_fsdp_leaves(cfg, "cross_layers/") + 1) * n
                   + sum(_fsdp_leaves(cfg, p)
                         for p in ("embed", "ln_f", "unembed")))
    return {"all-gather": L + 2 + gathers,
            "all-reduce": (5 + rows) * L + n + 1}


@pytest.mark.parametrize("size,arch,shape,mk", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_cell_against_the_reference(both, size, arch, shape, mk):
    """Arguments a device and MODEL_FLOPS equal to ``lower_cell``'s, FLOPs
    a device equal to XLA's less its counted difference, the port's
    collectives its hand count and XLA's those recorded."""
    ref, port, bare = both
    key = f"{size}-{arch}-{shape}-{mk}"
    want, got = ref["cells"][key], port[key]
    assert "error" not in got, got.get("traceback")
    assert got["bytes_per_device"]["arguments"] == want["arguments"]
    assert (got["model_flops"], got["n_chips"]) == (want["model_flops"],
                                                    want["n_chips"])
    cfg = _config[size](arch)
    assert _xla_from_port(cfg, key, port, bare) == want["flops"]
    if arch == WHISPER or shape == "decode_32k":
        assert got["hlo"]["flops_per_device"] == want["flops"]
    assert got["hlo"]["n_collectives"] == _port_collectives(cfg, shape)
    xla = {k: int(v) for k, v in want["n_collectives"].items()}
    assert xla == XLA_COLLECTIVES[key]
    if shape == "train_4k":
        assert got["bytes_per_device"]["outputs"] == 12  # loss, aux, gnorm


def test_xla_counts_the_cross_layers_in_every_layer(both):
    """The reference's cut VLM prefill all-reduces a cross layer's wo
    products in every layer (its ``lax.cond`` branch, lowered in each
    scan step): the port's count plus L − L // cross_attn_every; the
    port's FLOPs move with the applications."""
    ref, port, bare = both
    cfg = _config["cut"](VLM)
    n = cfg.n_layers // cfg.cross_attn_every
    for mk in MESHES:
        key = f"cut-{VLM}-prefill_32k-{mk}"
        xla = ref["cells"][key]["n_collectives"]["all-reduce"]
        assert xla == port[key]["hlo"]["n_collectives"]["all-reduce"] \
            + cfg.n_layers - n
        assert port[key]["hlo"]["flops_per_device"] \
            > bare[key]["hlo"]["flops_per_device"]


@pytest.mark.parametrize("size,arch,mk", POLICY,
                         ids=["-".join(c) for c in POLICY])
def test_policy_against_the_reference(both, size, arch, mk):
    """param_shardings (FSDP off and on), batch_shardings of every cell's
    inputs (``frames``, ``enc_out``, ``patches`` among them),
    cache_shardings of the decode state and opt_state_shardings of adamw's
    and adafactor's state: the reference's specs, leaf for leaf (the
    encoder's, the decoder's and the cross layers' stacks)."""
    want = both[0]["policy"][f"{size}-{arch}-{mk}"]
    cfg = _config[size](arch)
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=mk == "multi", device="cpu")
    try:
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
            caches = T.init_decode_state(cfg, 128, 32768,
                                         device="cpu").caches
            states = {name: getattr(O, name)().init(params)
                      for name in ("adamw", "adafactor")}
        for fsdp in (False, True):
            got = steps.param_shardings(mesh, params, specs, fsdp)
            assert {k: _spec(v) for k, v in got.items()} == \
                want[f"fsdp={fsdp}"]
        for s in ("train_4k", *SHAPES):
            got = steps.batch_shardings(
                mesh, configs.input_specs(cfg, configs.SHAPES[s]))
            assert {k: _spec(v) for k, v in got.items()} == want[s]
        got = steps.cache_shardings(mesh, cfg, caches)
        assert {k: _spec(v) for k, v in got.items()} == want["cache"]
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


def _spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_long_500k_is_skipped(arch, tmp_path):
    """long_500k is not a cell of a full-attention arch, as the reference
    decides (``configs.cell_supported``): both archs' records say skipped,
    with the reference's reason."""
    _, why = jax_configs.cell_supported(jax_configs.get_config(arch),
                                        jax_configs.SHAPES["long_500k"])
    for mk in MESHES:
        r = DR.run_cell(arch, "long_500k", mk, out_root=str(tmp_path),
                        device="cpu")
        assert r == {"arch": arch, "shape": "long_500k",
                     "mesh": "2x16x16" if mk == "multi" else "16x16",
                     "skipped": why}


def test_rank_tiles_and_layout_at_full_width():
    """A rank's tiles on 16×16 (fake tensors): whisper-small's attention
    whole (12 heads on 16) and its MLP split on d_ff, its vocabulary whole,
    its decode cache split on its length; the VLM at full depth with FSDP:
    the cross layers' wk and wv (8, 4096, 8, 128) whole on the model axis,
    their rows split over the data axis, and its cache split on its
    length."""
    for arch, fsdp in ((WHISPER, False), (VLM, True)):
        cfg = configs.get_config(arch)
        mesh = make_production_mesh(device="cpu")
        try:
            with FakeTensorMode():
                params, specs = steps.abstract_params(cfg, device="cpu")
                sh = steps.param_shardings(mesh, params, specs, fsdp)
                tiles = steps.shard_params(params, sh, mesh)
                whole = T.init_decode_state(cfg, 128, 32768, device="cpu")
                state = steps.shard_state(
                    whole, steps.cache_shardings(mesh, cfg, whole.caches),
                    mesh)
                leaves = tiles.ref_leaves()
            if arch == WHISPER:
                assert leaves["layers/self/wq"].shape == (12, 768, 12, 64)
                assert leaves["enc_layers/attn/wo"].shape == (12, 12, 64,
                                                              768)
                assert leaves["layers/mlp/up"].shape == (12, 768, 192)
                assert leaves["layers/mlp/b_up"].shape == (12, 192)
                assert leaves["layers/mlp/b_down"].shape == (12, 768)
                assert leaves["unembed"].shape == (768, 51865)
                assert state.caches["k"].shape == (12, 8, 2048, 12, 64)
            else:
                assert sh["cross_layers/wk"] == (None, "data", None, None)
                assert leaves["cross_layers/wk"].shape == (8, 256, 8, 128)
                assert leaves["cross_layers/wq"].shape == (8, 256, 2, 128)
                assert leaves["ln_cross"].shape == (8, 256)
                assert state.caches["k"].shape == (40, 8, 2048, 8, 128)
            set_mesh_axes(data_axis_names(mesh), mesh=mesh)
            tp = T._tp_layout(tiles, cfg, state)
            assert (tp.heads, tp.kv_heads, tp.ffn, tp.cache) == (
                arch == VLM, False, True, "length")
        finally:
            clear_mesh_axes()
            dist.destroy_process_group()
