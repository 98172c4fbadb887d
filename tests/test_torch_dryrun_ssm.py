"""The dry run's LM cells of the SSM and hybrid families (ROADMAP §1 row
22) and their sharding policy, against the JAX package's.

As ``tests/test_torch_dryrun_lm.py`` does, the reference runs in one
subprocess with 512 placeholder CPU devices and the production meshes
built with Auto axes (on jax 0.9.0 ``jax.make_mesh``'s Explicit axes make
``lower_cell`` raise).  It gives ``param_shardings`` (FSDP off and on),
``batch_shardings``, ``cache_shardings`` and ``opt_state_shardings`` of
mamba2-1.3b and zamba2-7b at full and smoke size on both meshes, and
``lower_cell`` + ``analyze_cell`` of:

* mamba2-1.3b at full size: prefill_32k, decode_32k and long_500k on
  16×16 and 2×16×16, train_4k on 16×16;
* zamba2-7b at full width cut to ``HYBRID_LAYERS`` (6) layers alike in
  both packages (one application of the shared block; FSDP off, below
  8 GB): the same seven cells;
* zamba2-7b at full depth (81 layers, FSDP on): decode_32k on 16×16;
* the cut zamba2's prefill_32k with ``attn_every`` 3 and 100, whose
  FLOPs are those of ``attn_every`` 6 (:func:`test_xla_counts_the_shared_block_in_every_layer`).

The port counts the same cells in this process (``launch.dryrun.run_cell``
on fake tensors) while the child runs, and the hybrid's cells again with
the shared block never applied (``attn_every`` 10⁶): the difference is one
application's FLOPs as the port counts them.

* Arguments a device and MODEL_FLOPS are equal in every cell.
* FLOPs a device are equal in mamba2's prefill and decode cells.  Two
  causes part the others, each counted (:func:`_xla_from_port`):
  1. XLA counts the hybrid's shared block in every layer: the reference
     runs it under ``lax.cond`` inside the layer scan, and ``analyze_cell``
     counts a conditional's branch whether it is taken or not; the model
     runs it L // attn_every times.  XLA's FLOPs are the port's plus (L −
     L // attn_every) applications.
  2. In a train cell XLA differentiates each of the SSD's three
     multi-operand einsums (``y_intra``, the chunk states, ``y_inter``)
     through a ``dot_general`` that gives the cotangent of a (B, nc, L,
     H) operand by contracting d_head (2·B_l·S·H_l·P FLOPs each): its
     forward multiplies that operand into a (…, P) one with no
     contraction, which PyTorch's einsum does with a ``mul``, whose
     backward is a ``mul`` and a sum.  Three a layer.
* The port's collectives are held to a hand count (:func:`_port_collectives`);
  XLA's are recorded (``XLA_COLLECTIVES``), their causes in PERF.md §6:
  XLA reshards between the fused projection's contiguous column tile, the
  heads and the state's d_head split with collective-permutes (53 a mamba2
  layer in prefill), which the port, cutting ``w_in`` by its parts and
  the state by its heads, does not make.
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
SSM, HYBRID = "mamba2-1.3b", "zamba2-7b"
HYBRID_LAYERS = 6                # the "cut" size: full width, 6 layers
NO_SHARED = 10 ** 6              # an attn_every that never applies it
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")
CELLS = ([("full", SSM, s, m) for s in SHAPES for m in MESHES]
         + [("full", SSM, "train_4k", "single")]
         + [("cut", HYBRID, s, m) for s in SHAPES for m in MESHES]
         + [("cut", HYBRID, "train_4k", "single"),
            ("full", HYBRID, "decode_32k", "single")])
POLICY = [(size, a, m) for size in ("full", "smoke") for a in (SSM, HYBRID)
          for m in MESHES]
ATTN_EVERY = (3, 100)            # the reference's cut prefill again

# XLA's collectives in the reference's cells (``lower_cell`` with Auto axes
# on jax 0.9.0), beside the port's hand count (their causes: PERF.md §6)
XLA_COLLECTIVES = {
    f"full-{SSM}-prefill_32k-single": {"collective-permute": 2544,
                                       "all-gather": 96, "all-reduce": 96},
    f"full-{SSM}-prefill_32k-multi": {"collective-permute": 2544,
                                      "all-gather": 96, "all-reduce": 96},
    f"full-{SSM}-decode_32k-single": {"collective-permute": 2544,
                                      "all-gather": 192, "all-to-all": 144,
                                      "all-reduce": 96},
    f"full-{SSM}-decode_32k-multi": {"collective-permute": 2544,
                                     "all-gather": 192, "all-to-all": 144,
                                     "all-reduce": 96},
    f"full-{SSM}-long_500k-single": {"collective-permute": 2592,
                                     "all-gather": 240, "all-to-all": 48,
                                     "all-reduce": 96},
    f"full-{SSM}-long_500k-multi": {"collective-permute": 2592,
                                    "all-gather": 240, "all-to-all": 48,
                                    "all-reduce": 96},
    f"full-{SSM}-train_4k-single": {"collective-permute": 5088,
                                    "all-gather": 192, "all-reduce": 290,
                                    "all-to-all": 288},
    f"cut-{HYBRID}-prefill_32k-single": {"all-reduce": 25,
                                         "collective-permute": 306,
                                         "all-gather": 12},
    f"cut-{HYBRID}-prefill_32k-multi": {"all-reduce": 25,
                                        "collective-permute": 306,
                                        "all-gather": 12},
    f"cut-{HYBRID}-decode_32k-single": {"all-reduce": 25,
                                        "collective-permute": 306,
                                        "all-gather": 26, "all-to-all": 18},
    f"cut-{HYBRID}-decode_32k-multi": {"all-reduce": 25,
                                       "collective-permute": 306,
                                       "all-gather": 26, "all-to-all": 18},
    f"cut-{HYBRID}-long_500k-single": {"all-reduce": 25,
                                       "collective-permute": 312,
                                       "all-gather": 32, "all-to-all": 6},
    f"cut-{HYBRID}-long_500k-multi": {"all-reduce": 25,
                                      "collective-permute": 312,
                                      "all-gather": 32, "all-to-all": 6},
    f"cut-{HYBRID}-train_4k-single": {"all-reduce": 74,
                                      "collective-permute": 612,
                                      "all-gather": 24, "all-to-all": 36},
    f"full-{HYBRID}-decode_32k-single": {"all-gather": 1382,
                                         "all-reduce": 325,
                                         "all-to-all": 487,
                                         "collective-permute": 4294},
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
layers, attn_every = int(sys.argv[3]), json.loads(sys.argv[4])
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

def record(compiled, meta):
    r = D.analyze_cell(compiled, meta)
    return {"flops": r["hlo"]["flops_per_device"],
            "n_collectives": r["hlo"]["n_collectives"],
            "arguments": r["bytes_per_device"]["arguments"],
            "model_flops": r["model_flops"], "n_chips": r["n_chips"]}

out = {"policy": {}, "cells": {}}
for size, arch, mk in policy:
    cfg = get[size](arch)
    mesh = auto_mesh(multi_pod=mk == "multi")
    params, specs = steps.abstract_params(cfg)
    rec = {f"fsdp={f}": paths(steps.param_shardings(mesh, params, specs, f))
           for f in (False, True)}
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
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
    out["cells"][f"{size}-{arch}-{s}-{mk}"] = record(compiled, meta)
    del compiled
for ae in attn_every:
    configs.get_config = D.configs.get_config = (
        lambda a, ae=ae: dataclasses.replace(get["cut"](a), attn_every=ae))
    compiled, meta = D.lower_cell("zamba2-7b", "prefill_32k", False)
    out["cells"][f"cut-zamba2-7b-prefill_32k-single-ae{ae}"] = record(
        compiled, meta)
    del compiled
print(json.dumps(out))
"""

_FULL = configs.get_config
_config = {"full": _FULL, "smoke": configs.get_smoke_config,
           "cut": lambda a: dataclasses.replace(_FULL(a),
                                                n_layers=HYBRID_LAYERS)}


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
    """(the reference's results, the port's records, the port's hybrid
    records with the shared block never applied), the port's counted here
    while the reference's child runs."""
    work = tmp_path_factory.mktemp("dryrun_ssm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CELLS),
         json.dumps(POLICY), str(HYBRID_LAYERS), json.dumps(ATTN_EVERY)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port, bare = {}, {}
        for size, arch, s, mk in CELLS:
            key = f"{size}-{arch}-{s}-{mk}"
            port[key] = _count(work, size, arch, s, mk)
            if arch == HYBRID:
                bare[key] = _count(work / "bare", size, arch, s, mk,
                                   attn_every=NO_SHARED)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), port, bare


def _shape_of(key: str) -> str:
    return next(s for s in (*SHAPES, "train_4k") if f"-{s}-" in key)


def _xla_from_port(cfg, key: str, port: dict, bare: dict) -> float:
    """XLA's FLOPs a device from the port's, by the two causes of the
    module docstring: (1) the hybrid's shared block counted in every layer
    (one application's FLOPs: the port's cell less the same cell with the
    block never applied, over its L // attn_every applications); (2) in a
    train cell, three dots a layer of 2·B_l·S·H_l·P FLOPs."""
    flops = port[key]["hlo"]["flops_per_device"]
    L = cfg.n_layers
    if cfg.family == "hybrid":
        n = L // cfg.attn_every
        once = (flops - bare[key]["hlo"]["flops_per_device"]) / n
        flops += (L - n) * once
    if _shape_of(key) == "train_4k":
        shape = configs.SHAPES["train_4k"]
        b_l = shape.global_batch // 16               # 16×16's data axis
        h_l = cfg.ssm_cfg().heads // 16
        flops += L * 3 * 2 * b_l * shape.seq_len * h_l * cfg.ssm_head
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
    """The port's collectives in a cell, by hand.  A Mamba2 layer gathers
    B and C over the model axis (1 all-gather) and all-reduces the norm's
    means (the ranks' means summed) and ``w_out``'s products (2); an
    application of the hybrid's shared block all-reduces ``wo``'s and
    ``down``'s products (2; its heads, KV heads and d_ff split, its KV
    cache on its heads in decode: nothing more); a vocabulary split on the model axis (zamba2's
    32000, not mamba2's 50280) sums the embedding's rows (1) and decode's
    greedy token gathers value and index (2).  FSDP (full-depth zamba2)
    gathers each data-split leaf at each use: a layer's, an application's
    and the embedding's, final norm's and unembedding's.  train_4k under
    ``"dots"``: the recompute gathers B and C and all-reduces the norm's
    sum again in every layer, and in a layer that applies the shared block
    ``w_out``'s and ``wo``'s all-reduces too (the recompute runs on into
    the block); the backward reduce-scatters B's and C's gradient (1 a
    layer), all-reduces the gradients of the block's input and of the
    three per-head vectors' slices and the norm's sum's cotangent (5 a
    layer), of the shared block's attention and MLP inputs (2 an
    application) and, with a split vocabulary, of the logits' input (1);
    the loss over a split vocabulary all-reduces its max, Σexp and label
    logit (3); at the end one all-reduce a leaf (the data mean), one for
    loss and aux, one for gnorm."""
    L = cfg.n_layers
    n = L // cfg.attn_every if cfg.family == "hybrid" else 0
    vocab = cfg.vocab % 16 == 0
    fsdp = cfg.param_count()[0] * 2 > 8e9
    layer_g = _fsdp_leaves(cfg, "layers/") if fsdp else 0
    shared_g = _fsdp_leaves(cfg, "shared_attn/") if fsdp else 0
    outer_g = (_fsdp_leaves(cfg, "embed") + _fsdp_leaves(cfg, "ln_f")
               + _fsdp_leaves(cfg, "unembed")) if fsdp else 0
    ag = L * (1 + layer_g) + n * shared_g + outer_g
    ar = 2 * L + 2 * n + vocab
    if shape in ("prefill_32k", "decode_32k", "long_500k"):
        return {"all-gather": ag + (2 * vocab if shape != "prefill_32k"
                                    else 0), "all-reduce": ar}
    assert not fsdp
    again = L + 2 * n
    bwd = 5 * L + 2 * n + vocab
    leaves = len(T.param_specs(cfg))
    return {"all-gather": 2 * ag, "reduce-scatter": L,
            "all-reduce": ar + 3 * vocab + again + bwd + leaves + 2}


@pytest.mark.parametrize("size,arch,shape,mk", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_cell_against_the_reference(both, size, arch, shape, mk):
    """Arguments a device and MODEL_FLOPS equal to ``lower_cell``'s, FLOPs
    a device equal to XLA's less its two counted differences, the port's
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
    if arch == SSM and shape != "train_4k":
        assert got["hlo"]["flops_per_device"] == want["flops"]
    assert got["hlo"]["n_collectives"] == _port_collectives(cfg, shape)
    xla = {k: int(v) for k, v in want["n_collectives"].items()}
    assert xla == XLA_COLLECTIVES[key]
    if shape == "train_4k":
        assert got["bytes_per_device"]["outputs"] == 12  # loss, aux, gnorm


def test_xla_counts_the_shared_block_in_every_layer(both):
    """The reference's cut zamba2 prefill_32k lowers to the same FLOPs a
    device with ``attn_every`` 3, 6 and 100 (2, 1 and 0 applications of
    the shared block in 6 layers): ``analyze_cell`` counts the
    ``lax.cond`` branch in every layer.  The port's count moves with the
    applications."""
    ref, port, bare = both
    key = f"cut-{HYBRID}-prefill_32k-single"
    flops = ref["cells"][key]["flops"]
    for ae in ATTN_EVERY:
        assert ref["cells"][f"{key}-ae{ae}"]["flops"] == flops
    assert port[key]["hlo"]["flops_per_device"] \
        > bare[key]["hlo"]["flops_per_device"]


@pytest.mark.parametrize("size,arch,mk", POLICY,
                         ids=["-".join(c) for c in POLICY])
def test_policy_against_the_reference(both, size, arch, mk):
    """param_shardings (FSDP off and on), batch_shardings of every cell's
    inputs, cache_shardings of the decode state (the SSM state's d_head on
    the model axis) and opt_state_shardings of adamw's and adafactor's
    state: the reference's specs, leaf for leaf."""
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


def test_rank_tiles_cut_w_in_by_its_parts():
    """A rank's tiles of mamba2-1.3b on 16×16 (fake tensors): ``w_in``'s
    tile holds the rank's 256 + 256 + 8 + 8 + 4 = 532 columns, the
    reference's contiguous tile's bytes, and the SSM state's tile its 4 of
    64 heads, though the spec splits d_head (its bytes again); the
    vocabulary of 50280 stays whole."""
    mesh = make_production_mesh(device="cpu")
    try:
        cfg = configs.get_config(SSM)
        with FakeTensorMode():
            params, specs = steps.abstract_params(cfg, device="cpu")
            sh = steps.param_shardings(mesh, params, specs, fsdp=False)
            tiles = steps.shard_params(params, sh, mesh).ref_leaves()
            whole = T.init_decode_state(cfg, 128, 32768, device="cpu")
            state = steps.shard_state(
                whole, steps.cache_shardings(mesh, cfg, whole.caches), mesh)
        assert tiles["layers/mamba/w_in"].shape == (48, 2048, 532)
        assert tiles["layers/mamba/w_out"].shape == (48, 256, 2048)
        assert tiles["layers/mamba/norm_g"].shape == (48, 256)
        assert tiles["layers/mamba/A_log"].shape == (48, 64)
        assert tiles["embed"].shape == (50280, 2048)
        w_in = tiles["layers/mamba/w_in"].tensors[0]
        assert w_in.untyped_storage().nbytes() == 2048 * 532 * 2
        assert state.shardings["state"] == (None, "data", None, "model",
                                            None)
        assert state.caches["state"].shape == (48, 8, 4, 64, 128)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_cells_give_records(arch, tmp_path, monkeypatch, capsys):
    """``--arch`` of an SSM or hybrid arch writes a record a shape and mesh
    with no error (its smoke config): train_4k, prefill_32k, decode_32k
    and long_500k, which these archs support; the report reads them."""
    from repro_torch.launch import report
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    assert DR.main(["--arch", arch, "--device", "cpu", "--out",
                    str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8 and all(" ok " in ln for ln in lines), lines
    for shape in ("train_4k", *SHAPES):
        for m in MESHES:
            r = json.loads((tmp_path / f"{arch}__{shape}__{m}.json")
                           .read_text())
            assert "error" not in r and r["hlo"]["flops_per_device"] > 0
    report.main(["--dir", str(tmp_path), "--kind", "dryrun"])
    assert capsys.readouterr().out.count(f"| {arch} | ") == 8
