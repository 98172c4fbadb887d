"""The port's GBS dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``run_gbs_cell``, its production meshes over a fake process
group, its keys under fake tensors, and ``launch/report.py``.  The LM
cells are ``tests/test_torch_dryrun_lm.py``.

The reference runs in a subprocess: its import sets ``XLA_FLAGS`` (512
placeholder devices) before jax starts, and ``tests/conftest.py`` has
already started jax here.  Both walk a tiny preset (4 sites, χ 64, d 4,
16 samples a data shard) on the 16×16 and 2×16×16 meshes.
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
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.launch import report as ref_report
from repro_torch import configs
from repro_torch.configs import gbs
from repro_torch.core import prng
from repro_torch.launch import dryrun as DR
from repro_torch.launch import report
from repro_torch.launch.mesh import (data_axis_names, data_parallel_size,
                                     make_production_mesh)

ROOT = Path(__file__).resolve().parents[1]
TINY = gbs.GBSPreset("tiny", 4, 64, 4, 4096, 1.0)
MICRO = 16
CELLS = [(s, mk, opt) for s in DR.SCHEMES for mk in ("single", "multi")
         for opt in (False, True)]

REFERENCE = """
import json, sys
from repro.configs import gbs
from repro.launch import dryrun as D
gbs.PRESETS["tiny"] = gbs.GBSPreset("tiny", 4, 64, 4, 4096, 1.0)
out = {}
for scheme in ("dp", "tp_single", "tp_double"):
    for mk in ("single", "multi"):
        for opt in (False, True):
            out[f"{scheme}-{mk}-{opt}"] = D.run_gbs_cell(
                "tiny", scheme, mk, force=True, out_root=sys.argv[1],
                micro_batch=16, optimized=opt)
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dryrun")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                          env=_env(), cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(gbs.PRESETS, "tiny", TINY)
    assert not dist.is_initialized()


def _port_cell(scheme, mk, opt, out):
    r = DR.run_gbs_cell("tiny", scheme, mk, force=True, out_root=str(out),
                        micro_batch=MICRO, optimized=opt, device="cpu")
    assert "error" not in r, r.get("traceback")
    assert not dist.is_initialized()          # the fake group ended with it
    return r


def _ring(g):
    return (g - 1) / g


def _hand_wire(scheme, opt):
    """Per-kind wire bytes of the chain: n = 16 samples a shard, χ = 64,
    d = 4, M = 4, p₂ = 16; probs (n, d), pmax (n, 1) and log_scale (n,)
    fp32, the wire dtype bf16 with ``--gbs-opt``.  The walk keeps its
    result sharded, so nothing else crosses the wire."""
    n, chi, d, m, p2 = MICRO, 64, 4, 4, 16
    w = 2 if opt else 4
    chain = {}
    if scheme == "tp_single":
        chain["all-reduce"] = m * 2 * (n * d * 4 + n * 4) * _ring(p2)
        chain["reduce-scatter"] = m * n * (chi // p2) * w * (p2 - 1)
    elif scheme == "tp_double":
        chain["all-reduce"] = (m // 2 * 2 * (n * chi * d * w + n * d * 4
                                             + n * 4) * _ring(p2))
    return chain


@pytest.mark.parametrize("scheme,mk,opt", CELLS,
                         ids=[f"{s}-{mk}-{'opt' if o else 'plain'}"
                              for s, mk, o in CELLS])
def test_gbs_cell_against_the_reference(reference, tiny, tmp_path, scheme,
                                        mk, opt):
    """FLOPs within 0.1% of the reference (and equal to the closed form);
    dp's and tp_single's collectives are the reference's kinds and counts,
    tp_double's the port's own; wire bytes to a hand count; no all-gather
    ends the walk (its result stays sharded, as the reference's
    ``out_specs`` keep it)."""
    want = reference[f"{scheme}-{mk}-{opt}"]
    got = _port_cell(scheme, mk, opt, tmp_path)
    h, rh = got["hlo"], want["hlo"]
    assert h["flops_per_device"] == pytest.approx(rh["flops_per_device"],
                                                  rel=1e-3)
    assert h["flops_per_device"] == DR.gbs_flops(TINY, scheme, opt, MICRO)
    assert (got["n_chips"], got["n_samples"], got["model_flops"]) == (
        want["n_chips"], want["n_samples"], want["model_flops"])

    assert h["end_gathers"] == {"n": 0, "wire_bytes": 0}
    chain = h["n_collectives"]
    if scheme == "tp_double":
        # XLA's jit gets Γ whole and reshards the even sites to their
        # right-bond tiles with one all-to-all; a port rank's arguments
        # are its tiles already
        assert chain == {"all-reduce": 6}
        assert rh["n_collectives"] == {"all-reduce": 6.0, "all-to-all": 1.0}
    else:
        assert chain == rh["n_collectives"]

    wire = _hand_wire(scheme, opt)
    assert h["per_collective"] == pytest.approx(wire, rel=1e-12)
    assert h["collective_wire_bytes_per_device"] == pytest.approx(
        sum(wire.values()), rel=1e-12)
    # every group of the 16×16 and 2×16×16 meshes spans several nodes
    assert h["wire_bytes_by_link"]["nvlink"] == 0.0
    assert "upcast_bytes_per_device" not in h
    assert "t_memory_tpu_adj_s" not in got["roofline"]
    assert set(got) >= set(want) - {"traceback"}
    assert got["bytes_per_device"]["aliased"] == 0


@pytest.mark.parametrize("scheme,opt", [(s, o) for s in DR.SCHEMES
                                        for o in (False, True)])
def test_tp_ranks_hold_their_tiles(tiny, tmp_path, scheme, opt):
    """A rank's arguments are Γ whole under dp and 1/p₂ of it under TP (its
    tiles; Λ whole in both), and it returns its shard: its samples (n, M),
    int64."""
    r = _port_cell(scheme, "single", opt, tmp_path)
    gamma = 4 * 64 * 64 * 4 * (2 if opt else 4)
    lam = 4 * 64 * 4
    args = r["bytes_per_device"]["arguments"]
    assert args == (gamma if scheme == "dp" else gamma // 16) + lam
    assert r["bytes_per_device"]["outputs"] == MICRO * 4 * 8


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_production_mesh_groups(multi):
    """The mesh over a fake group of 256 or 512 ranks, this process rank 0:
    the data axes' flattened line, and the line of every axis (dp)."""
    assert not dist.is_initialized()
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    try:
        n = 512 if multi else 256
        assert dist.get_backend() == "fake" and dist.get_world_size() == n
        assert mesh.axis_names == (("pod", "data", "model") if multi
                                   else ("data", "model"))
        assert data_axis_names(mesh) == mesh.axis_names[:-1]
        assert data_parallel_size(mesh) == n // 16
        every = mesh.group(mesh.axis_names)
        assert (dist.get_world_size(every), dist.get_rank(every)) == (n, 0)
        data = mesh.group(data_axis_names(mesh))
        assert dist.get_world_size(data) == n // 16
        assert dist.get_process_group_ranks(data) == list(range(0, n, 16))
        assert dist.get_world_size(mesh.group("model")) == 16
    finally:
        dist.destroy_process_group()


def test_production_mesh_never_joins_a_real_group(tiny, tmp_path):
    """With a default group up, the mesh refuses and the cell records the
    refusal; the real group is left as it was."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group exists"):
            make_production_mesh(device="cpu")
        r = DR.run_gbs_cell("tiny", "dp", "single", force=True,
                            out_root=str(tmp_path), micro_batch=MICRO,
                            device="cpu")
        assert "process group exists" in r["error"]
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


ALLOCATES = """
import json, resource, sys
from repro_torch import configs
from repro_torch.configs import gbs
from repro_torch.launch import dryrun as D
gbs.PRESETS["wide"] = gbs.GBSPreset("wide", 2, 8192, 4, 1, 1.0)
D.run_gbs_cell("wide", "tp_single", "single", force=True,
               out_root=sys.argv[1], micro_batch=2, device="cpu")
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
r = D.run_gbs_cell("wide", sys.argv[2], "single", force=True,
                   out_root=sys.argv[1], micro_batch=64, device="cpu")
grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
print(json.dumps({"grew_kib": grew, "error": r.get("error"),
                  "peak": r["bytes_per_device"]["peak_estimate"]}))
"""


@pytest.mark.parametrize("scheme", ["dp", "tp_double"])
def test_the_dry_run_allocates_nothing(tmp_path, scheme):
    """A cell whose arrays would take over 100 MB (χ = 8192: Γ alone is
    2.1 GB whole and 134 MB in a TP rank's tiles; dp's env 16384 × 8192
    fp32 537 MB) leaves the process's peak RSS within 16 MB of where a
    warm-up cell left it."""
    proc = subprocess.run([sys.executable, "-c", ALLOCATES, str(tmp_path),
                           scheme], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["error"] is None
    assert r["peak"] > 100e6
    assert r["grew_kib"] * 1024 < 16e6


def test_keys_stay_real_under_fake_tensors():
    """Key derivation runs with the fake mode unset (the words are read on
    the host at every site); the draws are fake.  Outside the mode the
    functions are the plain ones."""
    k = prng.key(7)
    want = (prng.fold_in(k, 3), prng.split(k, 4), prng.split(k, 4)[2])
    with FakeTensorMode():
        got = (prng.fold_in(prng.key(7), 3), prng.split(k, 4),
               prng.split_at(k, 4, 2))
        sub = prng.fold_in(got[2], 5)
        u = prng.uniform(sub, (6, 1), dtype=torch.float32)
    for g, w in zip(got, want):
        assert not isinstance(g, FakeTensor)
        assert torch.equal(g, w)
    assert torch.equal(sub, prng.fold_in(prng.split(k, 4)[2], 5))
    assert isinstance(u, FakeTensor) and u.shape == (6, 1)


def test_cli_writes_the_cells_and_report_reads_them(tiny, tmp_path,
                                                    monkeypatch, capsys):
    """``--gbs --mesh single`` writes a JSON a scheme, ``--gbs-opt`` three
    more; the report's roofline table has a row each."""
    monkeypatch.setattr(DR, "PRESETS", ("tiny",))
    for flag in ("--gbs", "--gbs-opt"):
        assert DR.main([flag, "--mesh", "single", "--preset", "tiny",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all(" ok " in ln for ln in lines)
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(f"gbs-tiny__{s}{o}__single.json"
                           for s in DR.SCHEMES for o in ("", "_opt"))
    report.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out.splitlines()
    assert len(table) == 2 + 6
    assert all(row.startswith("| gbs-tiny | ") for row in table[2:])


@pytest.mark.parametrize("flags,row", [
    (["--arch", "llama-3.2-vision-11b"], "row 22"),
    (["--arch", "whisper-small"], "row 22")])
def test_lm_cells_are_row_19b(flags, row, tmp_path, monkeypatch, capsys):
    """Rows 19b, 21 and 22 port every family's cells: ``--arch`` of the
    last two (the encoder-decoder and VLM, ``row`` 22's last part) writes a
    record a shape and mesh with no error (its smoke config: train_4k,
    prefill_32k and decode_32k, and long_500k's skip record, as the
    reference skips a full-attention arch); the report reads them."""
    del row
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    assert DR.main([*flags, "--device", "cpu", "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8, lines
    assert sum(" ok " in ln for ln in lines) == 6, lines
    assert sum(" SKIP " in ln for ln in lines) == 2, lines
    arch = flags[1]
    for shape in DR.LM_SHAPES:
        for m in ("single", "multi"):
            r = json.loads((tmp_path / f"{arch}__{shape}__{m}.json")
                           .read_text())
            assert "error" not in r
            assert ("skipped" in r) == (shape == "long_500k")
    report.main(["--dir", str(tmp_path), "--kind", "dryrun"])
    assert capsys.readouterr().out.count(f"| {arch} | ") == 8


@pytest.mark.parametrize("rb", [0, 4])
def test_train_cells_give_records(rb, tmp_path, monkeypatch, capsys):
    """``--shape train_4k`` (and ``--remat-block 4``) write a record a
    mesh and no error: granite's smoke config at 4 layers (so that a block
    of 4 divides them); the report reads them."""
    smoke = configs.get_smoke_config("granite-3-2b")
    monkeypatch.setattr(configs, "get_config", lambda a: dataclasses.replace(
        smoke, n_layers=4))
    flags = ["--arch", "granite-3-2b", "--shape", "train_4k", "--device",
             "cpu", "--out", str(tmp_path)]
    assert DR.main(flags + (["--remat-block", str(rb)] if rb else [])) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(" ok " in ln for ln in lines), lines
    rb_tag = f"__rb{rb}" if rb else ""
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == [f"granite-3-2b__train_4k{rb_tag}__{m}.json"
                     for m in ("multi", "single")]
    for name in names:
        r = json.loads((tmp_path / name).read_text())
        assert r["hlo"]["flops_per_device"] > 0
        assert r["bytes_per_device"]["outputs"] == 12
    report.main(["--dir", str(tmp_path)])           # the 16×16 roofline
    assert capsys.readouterr().out.count("| granite-3-2b | train_4k") == 1
    report.main(["--dir", str(tmp_path), "--kind", "dryrun"])
    assert capsys.readouterr().out.count("| granite-3-2b | train_4k") == 2


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_moe_cells_give_records(arch, tmp_path, monkeypatch, capsys):
    """``--arch`` of a MoE arch writes a record a shape and mesh: train_4k,
    prefill_32k and decode_32k with no error (its smoke config: 8 experts,
    MLA for deepseek-v3), long_500k skipped as the reference skips a
    full-attention arch; the report reads them."""
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)
    assert DR.main(["--arch", arch, "--device", "cpu", "--out",
                    str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8, lines
    assert sum(" ok " in ln for ln in lines) == 6
    assert sum(" SKIP " in ln and "long_500k" in ln for ln in lines) == 2
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for m in ("single", "multi"):
            r = json.loads((tmp_path / f"{arch}__{shape}__{m}.json")
                           .read_text())
            assert "error" not in r and r["hlo"]["flops_per_device"] > 0
    report.main(["--dir", str(tmp_path), "--kind", "dryrun"])
    assert capsys.readouterr().out.count(f"| {arch} | ") == 8


def _rows():
    ok = {"arch": "gbs-b-m288", "shape": "tp_single", "mesh": "16x16",
          "n_chips": 256, "compile_s": 17.3,
          "bytes_per_device": {"peak_estimate": 469000390656},
          "hlo": {"flops_per_device": 59076771840000.0,
                  "collective_wire_bytes_per_device": 47034040320.0,
                  "n_collectives": {"all-reduce": 576, "reduce-scatter": 288,
                                    "all-gather": 4}},
          "roofline": {"t_compute_s": 0.0597, "t_memory_s": 0.2548,
                       "t_collective_s": 0.9407, "bottleneck": "collective",
                       "model_flops": 1.50994944e16,
                       "hlo_flops": 1.512365359104e16,
                       "useful_ratio": 0.9984}}
    multi = dict(ok, mesh="2x16x16", n_chips=512)
    fail = {"arch": "gbs-m8176", "shape": "dp", "mesh": "16x16",
            "error": "RuntimeError: boom"}
    skip = {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "16x16",
            "skipped": "not supported"}
    return [ok, multi, fail, skip]


def test_report_tables_on_fixture_jsons(tmp_path):
    """Both tables, read back from JSON files, are the JAX package's
    report over the same rows (the roofline header names the counted
    FLOPs)."""
    for i, r in enumerate(_rows()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    rows = report.load(str(tmp_path))
    assert rows == _rows()
    assert report.dryrun_table(rows) == ref_report.dryrun_table(rows)
    assert report.dryrun_table(rows, "2x16x16").splitlines()[2] == (
        "| gbs-b-m288 | tp_single | 2x16x16 | 512 | ok | 469.0GB "
        "| 5.91e+13 | 47.0GB | 868 | 17s |")
    roof = report.roofline_table(rows)
    assert roof.replace("counted FLOPs", "HLO_FLOPs") == \
        ref_report.roofline_table(rows)
    assert roof.splitlines()[2:] == [
        "| gbs-b-m288 | tp_single | 59.7ms | 254.8ms | 940.7ms "
        "| **collective** | 1.51e+16 | 1.51e+16 | 1.00 |"]
