"""The dry run's LM cells of the dense family (ROADMAP §1 row 19b) and the
sharding policy, against the JAX package's.

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
* ``lower_cell`` + ``analyze_cell`` for prefill_32k and decode_32k of the
  4 smoke configs and granite-3-2b at full size on both meshes, and
  ``run_cell``'s long_500k record.

The port counts the same cells in this process (``launch.dryrun.run_cell``
on fake tensors) while the child runs.  FLOPs a device, the arguments'
bytes and MODEL_FLOPS must be equal; the collectives' kinds and counts
equal too, less one known difference: where the query heads split over
the model axis and the KV heads do not (granite-3-2b: 32 and 8 on 16), a
decode step's cache is split on its length and XLA gathers the queries and
sums the attention's output in two collectives each (over the model axis
seen as 2 × 8), one more all-gather and one more all-reduce a layer than
the port's one each (PERF.md §6, PR 31).
"""
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

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("granite-3-2b", "qwen1.5-4b", "deepseek-7b", "starcoder2-15b")
SHAPES = ("prefill_32k", "decode_32k")
MESHES = ("single", "multi")
CELLS = ([("smoke", a, s, m) for a in DENSE for s in SHAPES for m in MESHES]
         + [("full", "granite-3-2b", s, m) for s in SHAPES for m in MESHES])
POLICY = [(size, a, m) for size in ("full", "smoke") for a in DENSE
          for m in MESHES]

REFERENCE = """
import json, sys
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
get = {"full": configs.get_config, "smoke": configs.get_smoke_config}

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
for mk in ("single", "multi"):
    out["cells"][f"long_500k-{mk}"] = D.run_cell(
        "granite-3-2b", "long_500k", mk, force=True, out_root=sys.argv[1])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's results, the port's cell records), the port's
    counted here while the reference's child runs."""
    work = tmp_path_factory.mktemp("dryrun_lm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(work), json.dumps(CELLS),
         json.dumps(POLICY)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for size, arch, s, mk in CELLS:
            with pytest.MonkeyPatch.context() as mp:
                if size == "smoke":
                    mp.setattr(configs, "get_config",
                               configs.get_smoke_config)
                port[f"{size}-{arch}-{s}-{mk}"] = DR.run_cell(
                    arch, s, mk, force=True, out_root=str(work / size),
                    device="cpu")
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
    cfg = (configs.get_smoke_config if size == "smoke"
           else configs.get_config)(arch)
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
    cfg = (configs.get_smoke_config if size == "smoke"
           else configs.get_config)(arch)
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
