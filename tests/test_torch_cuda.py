"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU these tests skip (a CUDA kernel has
no interpret mode).  On a machine with one, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which this file does
not need.)

TF32 is turned off, so fp32 products stay full fp32.  Tolerances as
``tests/test_torch_site_step.py``, atol relative to the largest |env|.
Under bf16 inputs each stage is held elementwise to its rounding bound
(``site_step.bf16_gemm_bound``, ``site_step_bf16_bounds``: fp32 sums of
the same bf16-exact products in two orders), and a draw may differ only
where the uniform lies within the CDF's bound of a boundary.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import api
from repro_torch.core import mps as M
from repro_torch.core import prng
from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels import site_impls as SI
from repro_torch.kernels import site_step as K

pytestmark = pytest.mark.cuda

TOL = {torch.float64: dict(rtol=1e-12, atol=1e-14),
       torch.float32: dict(rtol=1e-5, atol=1e-6)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(semantics, real, n, chi, d, device):
    rng = np.random.default_rng(n * chi + d)
    npr = np.float64 if real == torch.float64 else np.float32
    u = rng.uniform(size=n).astype(npr)
    if semantics == "linear":
        arrs = [rng.uniform(size=(n, chi)), rng.uniform(size=(chi, chi, d)),
                rng.uniform(size=chi)]
        arrs = [a.astype(npr) for a in arrs]
    else:
        npc = np.complex128 if real == torch.float64 else np.complex64
        arrs = [(rng.normal(size=(n, chi))
                 + 1j * rng.normal(size=(n, chi))).astype(npc),
                (rng.normal(size=(chi, chi, d))
                 + 1j * rng.normal(size=(chi, chi, d))).astype(npc),
                (rng.uniform(size=chi) + 0.5).astype(npr)]
    return [torch.from_numpy(a).to(device) for a in (*arrs, u)]


@pytest.mark.parametrize("n,chi,d", [(8, 4, 3), (37, 13, 5), (64, 32, 2),
                                     (300, 130, 4)])
@pytest.mark.parametrize("scaling", ["none", "per_sample", "global"])
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
@pytest.mark.parametrize("semantics", ["linear", "born"])
def test_kernel_matches_plain(card, semantics, real, scaling, n, chi, d):
    env, gamma, lam, u = _operands(semantics, real, n, chi, d, card)
    kernel, plain = ((SI.site_step_linear_cuda, SI.site_step_linear_torch)
                     if semantics == "linear"
                     else (SI.site_step_born_cuda, SI.site_step_born_torch))
    before = dict(K.LAUNCHES)
    kw = dict(scaling=scaling, compute_dtype=None)
    e_k, s_k, d_k = kernel(env, gamma, lam, u[:, None], **kw)
    e_p, s_p, d_p = plain(env, gamma, lam, u[:, None], **kw)
    torch.cuda.synchronize()
    name = f"site_step_{semantics}"
    assert K.LAUNCHES[name] == before[name] + 1
    assert torch.equal(s_k, s_p)
    scale = max(1.0, e_p.abs().max().item())
    assert torch.allclose(e_k / scale, e_p / scale, **TOL[real])
    assert torch.allclose(d_k, d_p, **TOL[real])


@pytest.mark.parametrize("semantics", ["linear", "born"])
def test_session_walk_on_the_card(card, semantics):
    build = (M.random_linear_mps if semantics == "linear"
             else M.random_born_mps)
    mps = build(prng.key(0), 6, 40, 3, device=card)
    outs = {}
    for kernels in ("cuda", "torch"):
        with api.SamplingSession(mps, api.SamplerConfig(kernels=kernels),
                                 device=card) as s:
            outs[kernels] = s.sample(256, prng.key(3))
    np.testing.assert_array_equal(outs["cuda"], outs["torch"])


# ---------------------------------------------------------------------------
# The tensor-parallel stages: bond shards, L ≠ R, d up to MAX_D = 16
# ---------------------------------------------------------------------------

TP_SHAPES = [(8, 4, 6, 3), (37, 13, 29, 5), (300, 130, 65, 4),
             (65, 64, 128, 16), (1, 1, 1, 1)]


def _tp_operands(real, n, chi_l, chi_r, d, device):
    rng = np.random.default_rng(n + 7 * chi_l + 31 * chi_r + d)
    npr = np.float64 if real == torch.float64 else np.float32
    arrs = [rng.uniform(size=(n, chi_l)), rng.uniform(size=(chi_l, chi_r, d)),
            rng.uniform(size=chi_r), rng.uniform(size=(chi_l, d))]
    return [torch.from_numpy(a.astype(npr)).to(device) for a in arrs]


def _close(got, want, real):
    scale = max(1.0, want.abs().max().item())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.allclose(got / scale, want / scale, **TOL[real])


@pytest.mark.parametrize("n,chi_l,chi_r,d", TP_SHAPES)
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_contract_measure_kernel(card, real, n, chi_l, chi_r, d):
    from repro_torch.kernels import contract_measure as CM

    env, gamma, lam, _ = _tp_operands(real, n, chi_l, chi_r, d, card)
    before = CM.LAUNCHES["contract_measure"]
    temp, probs = CM.contract_measure(env, gamma, lam)
    t_p, p_p = CM.contract_measure_plain(env, gamma, lam)
    torch.cuda.synchronize()
    assert CM.LAUNCHES["contract_measure"] == before + 1
    _close(temp, t_p, real)
    _close(probs, p_p, real)


@pytest.mark.parametrize("shape", ["left", "right"])
def test_contract_measure_f64_at_a_shard_shape(card, shape):
    """The fp64 tensor-core GEMM at the p₂ = 4 shard shapes of χ = 10⁴
    with d = 4 (N = 1024; left: L = 2500 → R = 10⁴, right: the reverse)."""
    from repro_torch.kernels import contract_measure as CM

    n, (chi_l, chi_r) = 1024, ((2500, 10_000) if shape == "left"
                               else (10_000, 2500))
    gen = torch.Generator(device=card).manual_seed(chi_l)
    env = torch.rand((n, chi_l), generator=gen, device=card,
                     dtype=torch.float64)
    gamma = torch.rand((chi_l, chi_r, 4), generator=gen, device=card,
                       dtype=torch.float64)
    lam = torch.rand(chi_r, generator=gen, device=card, dtype=torch.float64)
    temp, probs = CM.contract_measure(env, gamma, lam)
    t_p, p_p = CM.contract_measure_plain(env, gamma, lam)
    torch.cuda.synchronize()
    _close(temp, t_p, torch.float64)
    _close(probs, p_p, torch.float64)


def test_contract_measure_f64_unaligned_operands(card):
    """env and Γ 8 bytes into their storage: the kernel copies one word at
    a time instead of two, with the same result."""
    from repro_torch.kernels import contract_measure as CM

    env, gamma, lam, _ = _tp_operands(torch.float64, 300, 130, 65, 4, card)
    moved = []
    for x in (env, gamma):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0
        moved.append(y)
    got = CM.contract_measure(*moved, lam)
    want = CM.contract_measure(env, gamma, lam)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,chi_l,chi_r,d", TP_SHAPES)
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_measure_probs_kernel(card, real, n, chi_l, chi_r, d):
    env, _, _, w = _tp_operands(real, n, chi_l, chi_r, d, card)
    before = K.LAUNCHES["measure_probs"]
    probs = K.measure_probs(env, w)
    want = K.measure_first_plain(env, w)
    torch.cuda.synchronize()
    assert K.LAUNCHES["measure_probs"] == before + 1
    _close(probs, want, real)


@pytest.mark.parametrize("present", ["all", "some"])
@pytest.mark.parametrize("n,chi_l,chi_r,d", TP_SHAPES)
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_collapse_select_kernel(card, real, n, chi_l, chi_r, d, present):
    """Every outcome drawn, or only some (rows outside [0, d) come out
    zero, as with the plain version's masks)."""
    from repro_torch.kernels import collapse_select as CS

    env, gamma, _, _ = _tp_operands(real, n, chi_l, chi_r, d, card)
    samples = torch.arange(n, device=card) % d
    if present == "some":
        samples = samples.clamp(max=max(0, d - 2))
        samples[::7] = d                     # outside [0, d)
        samples[1::11] = -1
    before = CS.LAUNCHES["collapse_select"]
    got = CS.collapse_select(env, gamma, samples)
    want = CS.collapse_select_plain(env, gamma, samples)
    torch.cuda.synchronize()
    assert CS.LAUNCHES["collapse_select"] == before + 1
    _close(got, want, real)


# ---------------------------------------------------------------------------
# The Born step's complex128 GEMM on the fp64 tensor cores, and measure_probs
# with many rows a block: shapes that cut every tile edge (N, R·d and L off
# the block, column and k tiles; L odd; d from 1 to 16; operands that start
# off their storage)
# ---------------------------------------------------------------------------

def _born_operands(n, chi_l, chi_r, d, device):
    rng = np.random.default_rng(n + 7 * chi_l + 31 * chi_r + d)
    env = rng.normal(size=(n, chi_l)) + 1j * rng.normal(size=(n, chi_l))
    gamma = (rng.normal(size=(chi_l, chi_r, d))
             + 1j * rng.normal(size=(chi_l, chi_r, d)))
    lam = rng.uniform(size=chi_r) + 0.5
    u = rng.uniform(size=n)
    return [torch.from_numpy(a).to(device) for a in (env, gamma, lam, u)]


def _born_temp(env, gamma, lam, u, chi_l, d):
    """The complex128 entry's temp = env · Γ (its contraction), launched
    through the C entry on the tensors' own pointers (which may lie off
    16 bytes, where no complex128 tensor can)."""
    from repro_torch.kernels import _build

    n, chi_r, dev = u.shape[0], lam.shape[0], u.device
    temp = torch.empty((n, chi_r, d), dtype=torch.complex128, device=dev)
    outs = (torch.empty((n, chi_r), dtype=torch.complex128, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float64, device=dev))
    _build.launch("fastmps_site_step_born_c128",
                  (env, gamma, lam, u, *outs, temp), (n, chi_l, chi_r, d, 1),
                  dev, "site_step_born")
    return temp


BORN_EDGES = [(65, 37, 29, 3), (129, 9, 13, 16), (7, 1, 5, 1),
              (300, 130, 130, 4), (64, 64, 32, 2), (1, 3, 1, 1)]


@pytest.mark.parametrize("n,chi_l,chi_r,d", BORN_EDGES
                         + [(67, 37, 29, d) for d in range(1, 17)])
def test_born_c128_kernel_at_tile_edges(card, n, chi_l, chi_r, d):
    """The site step against ``site_step_born_plain``, and its whole temp
    against the plain contraction, fp64 tolerances."""
    env, gamma, lam, u = _born_operands(n, chi_l, chi_r, d, card)
    before = K.LAUNCHES["site_step_born"]
    e_k, s_k, d_k = K.site_step_born(env, gamma, lam, u)
    e_p, s_p, d_p = K.site_step_born_plain(env, gamma, lam, u)
    torch.cuda.synchronize()
    assert K.LAUNCHES["site_step_born"] == before + 1
    assert torch.equal(s_k, s_p)
    _close(e_k, e_p, torch.float64)
    _close(d_k, d_p, torch.float64)
    _close(_born_temp(env, gamma, lam, u, chi_l, d),
           K.contract_plain(env, gamma), torch.float64)


def test_born_c128_operands_off_their_storage(card):
    """env and Γ as views one element into their storage (16-byte aligned:
    the 16-byte copies), and as fp64 words one word in (8-byte aligned, which
    no complex128 tensor can be: the 8-byte copies): the same bits."""
    env, gamma, lam, u = _born_operands(67, 37, 29, 5, card)
    views = []
    for x in (env, gamma):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        views.append(y)
    want = K.site_step_born(env, gamma, lam, u)
    got = K.site_step_born(*views, lam, u)
    words = []
    for x in (env, gamma):
        buf = torch.empty(2 * x.numel() + 1, dtype=torch.float64, device=card)
        y = buf[1:]
        y.copy_(torch.view_as_real(x).flatten())
        assert y.data_ptr() % 16 == 8
        words.append(y)
    temp = _born_temp(env, gamma, lam, u, 37, 5)
    temp_words = _born_temp(*words, lam, u, 37, 5)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(torch.view_as_real(temp_words),
                       torch.view_as_real(temp))


# ---------------------------------------------------------------------------
# The fp64 grouped collapse on the fp64 tensor cores (collapse_f64_kernel),
# in collapse_select and in the linear step: outcome groups of 0 and 1 rows
# and of 65, 129 and 257 rows (one row past 64 and past one and two 128-row
# tiles, so spread over two and three tiles), N off the row tile, R off the
# 64-column tile, L odd (8-byte env copies) and off the 16-deep k step,
# d = 1 (Γ's columns contiguous: 16-byte copies) and d = 16
# ---------------------------------------------------------------------------

# (n, chi_l, chi_r, d, rows of the first groups; the rest go to the others)
COLLAPSE_EDGES = [(300, 130, 130, 4, (0, 1, 129)),
                  (420, 37, 29, 4, (0, 1, 257)),
                  (200, 48, 70, 3, (65, 0)),
                  (150, 64, 64, 1, ()), (150, 37, 29, 1, ()),
                  (300, 130, 65, 16, (0, 1, 129)), (1, 3, 1, 2, (0,))]


def _collapse_samples(n, d, counts, device):
    """Outcomes in a shuffled order with ``counts`` rows in the first
    groups and the other rows spread over the rest."""
    sizes = list(counts) + [0] * (d - len(counts))
    for i in range(n - sum(counts)):
        sizes[len(counts) + i % (d - len(counts))] += 1
    drawn = np.random.default_rng(n + d).permutation(
        np.repeat(np.arange(d), sizes))
    return torch.from_numpy(drawn).to(device)


def _forced_linear(env, gamma, samples):
    """env and Γ kept only where l ≡ s (mod d) for env's row outcome s and
    Γ's outcome s, so that a row's probs are positive at its outcome alone
    and every draw gives it."""
    d = gamma.shape[2]
    l_mod = torch.arange(env.shape[1], device=env.device) % d
    e = env * (l_mod[None, :] == samples[:, None])
    g = gamma * (l_mod[:, None] == torch.arange(d, device=env.device)
                 )[:, None, :]
    return e, g


@pytest.mark.parametrize("n,chi_l,chi_r,d,counts", COLLAPSE_EDGES)
def test_collapse_f64_at_tile_edges(card, n, chi_l, chi_r, d, counts):
    """collapse_select on given outcomes, and the linear step on operands
    that force its draws to the same outcomes, against their plain
    versions (fp64 tolerances); the draws equal the forced outcomes."""
    env, gamma, lam, _ = _tp_operands(torch.float64, n, chi_l, chi_r, d, card)
    samples = _collapse_samples(n, d, counts, card)
    before = CS.LAUNCHES["collapse_select"]
    got = CS.collapse_select(env, gamma, samples)
    _close(got, CS.collapse_select_plain(env, gamma, samples), torch.float64)
    assert CS.LAUNCHES["collapse_select"] == before + 1
    e, g = _forced_linear(env, gamma, samples)
    u = torch.rand(n, dtype=torch.float64, device=card) * 0.98 + 0.01
    e_k, s_k, d_k = K.site_step_linear(e, g, lam, u)
    e_p, s_p, d_p = K.site_step_linear_plain(e, g, lam, u)
    torch.cuda.synchronize()
    assert torch.equal(s_k, samples) and torch.equal(s_p, samples)
    _close(e_k, e_p, torch.float64)
    _close(d_k, d_p, torch.float64)


@pytest.mark.parametrize("d", [1, 4])
def test_collapse_f64_operands_off_their_storage(card, d):
    """env and Γ 8 bytes into their storage: the kernel copies them a word
    at a time (at d = 1 Γ too), with the same bits."""
    env, gamma, lam, _ = _tp_operands(torch.float64, 300, 130, 66, d, card)
    u = torch.rand(300, dtype=torch.float64, device=card)
    samples = _collapse_samples(300, d, (), card)
    moved = []
    for x in (env, gamma):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0
        moved.append(y)
    pairs = [(CS.collapse_select(*moved, samples),
              CS.collapse_select(env, gamma, samples))]
    pairs += zip(K.site_step_linear(*moved, lam, u),
                 K.site_step_linear(env, gamma, lam, u))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got, want)


def test_fp64_collapse_runs_on_the_tensor_cores(card):
    """torch.profiler lists collapse_f64_kernel for fp64 and no fp64 FMA
    collapse; fp32 keeps collapse_kernel<float>."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for dt in (torch.float64, torch.float32):
        env, gamma, lam, _ = _tp_operands(dt, 300, 130, 65, 4, card)
        u = torch.rand(300, dtype=dt, device=card)
        samples = _collapse_samples(300, 4, (), card)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K.site_step_linear(env, gamma, lam, u)
            CS.collapse_select(env, gamma, samples)
            torch.cuda.synchronize()
        names[dt] = [ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
    f64 = [x for x in names[torch.float64] if "collapse" in x]
    f32 = [x for x in names[torch.float32] if "collapse" in x]
    assert f64 and all("collapse_f64_kernel" in x for x in f64)
    assert f32 and all("collapse_kernel<float>" in x for x in f32)


MEASURE_ENTRIES = {"fp64": (torch.float64, None),
                   "fp32": (torch.float32, None),
                   "bf16 fp32": (torch.float32, torch.bfloat16),
                   "bf16 fp64": (torch.float64, torch.bfloat16)}


@pytest.mark.parametrize("chi_l", [1283, 2500])
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("n", [1, 37, 1027])
@pytest.mark.parametrize("entry", list(MEASURE_ENTRIES))
def test_measure_probs_many_rows_a_block(card, entry, n, d, chi_l):
    """Odd L (one element a load) and L = 2500 (16-byte loads), over more
    than one W chunk; N off the block's rows.  fp32/fp64: the fp64
    tolerances; bf16 inputs: ``bf16_gemm_bound``."""
    dt, cdt = MEASURE_ENTRIES[entry]
    gen = torch.Generator(device=card).manual_seed(n + chi_l + d)
    env = torch.rand((n, chi_l), generator=gen, device=card,
                     dtype=torch.float64).to(dt)
    w = torch.rand((chi_l, d), generator=gen, device=card,
                   dtype=torch.float64).to(dt)
    name = "measure_probs" + ("" if cdt is None else "_bf16")
    before = K.LAUNCHES[name]
    got = K.measure_probs(env, w, cdt)
    want = K.measure_first_plain(env, w, cdt)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    if cdt is None:
        _close(got, want, dt)
    else:
        _within(got, want, K.bf16_gemm_bound(env, w))


def test_parallel_walks_on_the_card(card, tmp_path):
    """dp, tp_single (with measure-first) and tp_double through the session
    on a one-rank NCCL mesh: the kernels' samples equal the plain ones."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, card)
        mps = M.random_linear_mps(prng.key(0), 6, 40, 3, device=card)
        for scheme, mf in (("dp", False), ("tp_single", False),
                           ("tp_single", True), ("tp_double", False)):
            outs = {}
            for kernels in ("cuda", "torch"):
                ops.reset_launches()
                cfg = api.SamplerConfig(kernels=kernels, scheme=scheme,
                                        measure_first=mf)
                with api.SamplingSession(mps, cfg, mesh=mesh) as s:
                    outs[kernels] = s.sample(128, prng.key(3))
            assert sum(ops.launch_counts().values()) == 0   # torch ran last
            np.testing.assert_array_equal(outs["cuda"], outs["torch"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The streamed read path: GammaStore.get_segment_on_device
# ---------------------------------------------------------------------------

SEGMENT_STORES = {"bf16-fp64": (torch.bfloat16, torch.float64),
                  "bf16-fp32": (torch.bfloat16, torch.float32),
                  "fp64": (torch.float64, torch.float64),
                  "fp32": (torch.float32, torch.float32),
                  "c128": (torch.complex128, torch.complex128)}


def _bits(t):
    return t.detach().cpu().contiguous().numpy().tobytes()


@pytest.mark.parametrize("pin", [True, False])
@pytest.mark.parametrize("chi", [None, 7, 1])
@pytest.mark.parametrize("kind", sorted(SEGMENT_STORES))
def test_segment_on_device_is_the_host_decode(card, tmp_path, kind, chi,
                                              pin):
    """Pinned (or pageable) reads, the copy stream and the upcast on the
    card give, bit for bit, an independent decode of what was written:
    ``bf16_bits`` upcast for a bf16 store, the values cast to the storage
    dtype for an identity store, both cut to the stage's χ."""
    from repro_torch.data.gamma_store import GammaStore, bf16_bits

    storage, compute = SEGMENT_STORES[kind]
    rng = np.random.default_rng(7)
    m, c_full, d = 5, 12, 3
    g = rng.standard_normal((m, c_full, c_full, d)) * 10.0 ** rng.integers(
        -40, 3, (m, c_full, c_full, d))
    if storage.is_complex:
        g = g + 1j * rng.standard_normal(g.shape)
    lam = rng.random((m, c_full))
    with GammaStore(str(tmp_path), storage, compute) as store:
        for i in range(m):
            store.put(i, torch.from_numpy(g[i]), torch.from_numpy(lam[i]))
        store.pin_memory = pin
        seg = store.get_segment_on_device(1, 3, card, chi=chi)
        torch.cuda.current_stream(card).wait_event(seg["ready"])
        c = c_full if chi is None else chi
        assert seg["gammas"].shape == (3, c, c, d)
        assert seg["gammas"].dtype == compute and seg["gammas"].is_cuda
        for j in range(3):
            src = torch.from_numpy(g[1 + j])
            want = (bf16_bits(src).view(torch.bfloat16)
                    if storage == torch.bfloat16 else src.to(storage))
            assert _bits(seg["gammas"][j]) == _bits(
                want[:c, :c, :].to(compute))
            assert _bits(seg["lambdas"][j]) == _bits(
                torch.from_numpy(lam[1 + j, :c]))
        assert seg["bytes"] == 3 * (c * c * d * storage.itemsize + c * 8)


@pytest.mark.parametrize("tile", [("tp_single", 3, 2), ("tp_double", 3, 1),
                                  ("tp_double", 1, 0)])
@pytest.mark.parametrize("chi", [None, 6])
@pytest.mark.parametrize("kind", ["bf16-fp64", "fp32"])
def test_segment_tile_on_the_card(card, tmp_path, kind, chi, tile):
    """A TP rank's tiles of a segment, cut on the host and copied alone to
    the card (``get_segment_on_device(tile=...)``, and a payload's), equal
    bit for bit the tiles ``parallel.shard_chain`` cuts from the host
    decode."""
    from repro_torch.core import parallel as PP
    from repro_torch.core.mps import MPS
    from repro_torch.data.gamma_store import GammaStore, payload_on_device

    storage, compute = SEGMENT_STORES[kind]
    rng = np.random.default_rng(8)
    m, c_full, d = 6, 12, 3
    with GammaStore(str(tmp_path), storage, compute) as store:
        for i in range(m):
            store.put(i, torch.from_numpy(rng.standard_normal(
                (c_full, c_full, d))), torch.from_numpy(rng.random(c_full)))
        g, lam = store.get_segment(2, 4, prefetch_next_segment=False)
        c = c_full if chi is None else chi
        want = PP.shard_chain(MPS(g[:, :c, :c].contiguous(), lam[:, :c]),
                              *tile)
        for seg in (store.get_segment_on_device(2, 4, card, chi=chi,
                                                tile=tile),
                    payload_on_device(store.get_segment_raw(2, 4), card,
                                      chi=chi, tile=tile,
                                      stream=store.copy_stream(card))):
            torch.cuda.current_stream(card).wait_event(seg["ready"])
            assert seg["gammas"].is_cuda
            assert _bits(seg["gammas"]) == _bits(want.gammas)
            assert _bits(seg["lambdas"]) == _bits(want.lambdas)
            if tile[0] == "tp_double":
                assert _bits(seg["gammas_right"]) == _bits(
                    want.gammas_right)
            else:
                assert seg["gammas_right"] is None


@pytest.mark.parametrize("profile", [None, (4, 8, 24, 24, 24, 8, 8, 4)])
def test_streamed_walk_on_the_card(card, tmp_path, profile):
    """The streamed seq walk from a bf16 store, flat and with a χ-profile
    (the env cut and padded between stages): the kernel walk's samples are
    the plain cells', env and log_scale within TOL, and the linear step
    launches once a site."""
    from repro_torch.core import sampler as S
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.engine import StreamingEngine, StreamPlan
    from repro_torch.kernels import ops

    mps = M.random_linear_mps(prng.key(5), 8, 24, 3, device=card)
    with GammaStore(str(tmp_path), torch.bfloat16, torch.float64) as store:
        store.write_mps(mps)
        out = {}
        for kernels in ("cuda", "torch"):
            ops.reset_launches()
            eng = StreamingEngine(store, config=S.SamplerConfig(
                kernels=kernels), plan=StreamPlan(segment_len=3),
                chi_profile=profile, device=card)
            samples = eng.sample(96, prng.key(6))
            out[kernels] = (samples, eng.state, ops.launch_counts(),
                            eng.stats["max_live_segments"])
            eng.close(close_store=False)
    assert out["cuda"][2]["site_step_linear"] == 8
    assert out["cuda"][3] <= 2
    np.testing.assert_array_equal(out["cuda"][0], out["torch"][0])
    for f in ("env", "log_scale"):
        torch.testing.assert_close(getattr(out["cuda"][1], f),
                                   getattr(out["torch"][1], f),
                                   **TOL[torch.float64])


@pytest.mark.parametrize("clamp", [None, {1: 0, 3: 1}],
                         ids=["unclamped", "clamped"])
def test_fp32_walk_of_a_store_with_an_fp64_lambda(card, tmp_path, clamp):
    """A store keeps Λ in the dtype it was written in, so a path opened
    with the default fp32 compute dtype (as the gateway opens one) hands
    the kernels an fp64 Λ (and fp64 uniforms) beside an fp32 env; they
    take both in env's dtype, as the Pallas kernels cast Λ: the streamed
    walk runs on the kernels, one launch a site, and equals the in-memory
    kernel walk of the same decoded chain."""
    from repro_torch import api
    from repro_torch.core.mps import MPS
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.kernels import ops

    mps = M.random_linear_mps(prng.key(7), 6, 24, 3, device=card)
    with GammaStore(str(tmp_path), torch.bfloat16, torch.float64) as store:
        store.write_mps(mps)
    cfg = dict(kernels="cuda", clamp=clamp)
    ops.reset_launches()
    with api.SamplingSession(str(tmp_path), api.SamplerConfig(
            backend="streamed", segment_len=2, **cfg), device=card) as s:
        got = s.sample(64, prng.key(8))
    kernel = "contract_measure" if clamp else "site_step_linear"
    assert ops.launch_counts()[kernel] == 6
    with GammaStore(str(tmp_path), torch.bfloat16, torch.float32) as store:
        g, lam = store.get_segment(0, 6)
    assert (g.dtype, lam.dtype) == (torch.float32, torch.float64)
    chain = MPS(g.to(card), lam.to(card))
    with api.SamplingSession(chain, api.SamplerConfig(**cfg),
                             device=card) as s:
        np.testing.assert_array_equal(got, s.sample(64, prng.key(8)))


# ---------------------------------------------------------------------------
# The displacement and flash-attention kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", list(range(1, 17)))
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_displacement_kernel(card, real, d):
    """|μ| up to 1.5 and μ = 0 (→ I exactly), held by
    ``displacement_expm.check_rounding``: an element whose exact value is a
    normal number within ``rounding_bound`` of the plain version (8·d·ε
    times the summed magnitudes of the cancelling terms), one below the
    smallest normal number within its stated subnormal spacings of the
    exact value, in both versions."""
    from repro_torch.kernels import displacement_expm as DE

    rng = np.random.default_rng(d)
    r = 1.5 * np.sqrt(rng.uniform(size=1003))
    phi = rng.uniform(0, 2 * np.pi, size=1003)
    r[0] = 0.0
    mre, mim = (torch.from_numpy(a).to(real).to(card)
                for a in (r * np.cos(phi), r * np.sin(phi)))
    before = DE.LAUNCHES["displacement_expm"]
    got = DE.displacement_expm(mre, mim, d)
    want = DE.displacement_expm_plain(mre, mim, d)
    torch.cuda.synchronize()
    assert DE.LAUNCHES["displacement_expm"] == before + 1
    for g in got:
        assert g.dtype == real and g.shape == (1003, d, d)
    res = DE.check_rounding(got, want, mre, mim, d)
    assert res["beyond_bound"] == res["beyond_spacings"] == 0, res
    assert torch.equal(got[0][0], torch.eye(d, dtype=real, device=card))
    assert torch.equal(got[1][0], torch.zeros((d, d), dtype=real,
                                              device=card))


def _disp_mu(b, dtype, device, seed):
    """b complex μ's with |μ| ≤ 1.5, μ[0] = 0."""
    rng = np.random.default_rng(seed)
    r = 1.5 * np.sqrt(rng.uniform(size=b))
    r[0] = 0.0
    mu = r * np.exp(1j * rng.uniform(0, 2 * np.pi, size=b))
    return torch.from_numpy(mu).to(dtype).to(device)


@pytest.mark.parametrize("b", [1, 127, 129, 1003])
@pytest.mark.parametrize("d", [1, 3, 4, 5, 16])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_displacement_complex_entry(card, dtype, d, b):
    """The complex entry (μ and D(μ) interleaved, as the complex tensors
    lie) gives the planes entry's bits (one kernel, two layouts), meets
    the rounding check against the plain version, and D(0) = I, for B off the
    block's 128 samples; ``ops.displacement_matrices`` goes through it,
    one launch a call.  Held by ``displacement_expm.check_rounding``."""
    from repro_torch.kernels import displacement_expm as DE
    from repro_torch.kernels import ops

    mu = _disp_mu(b, dtype, card, seed=b + d)
    mre, mim = mu.real.contiguous(), mu.imag.contiguous()
    before = DE.LAUNCHES["displacement_expm"]
    got = DE.displacement_expm_complex(mu, d)
    via_ops = ops.displacement_matrices(mu, d)
    planes = DE.displacement_expm(mre, mim, d)
    plain = DE.displacement_expm_complex_plain(mu, d)
    torch.cuda.synchronize()
    assert DE.LAUNCHES["displacement_expm"] == before + 3
    assert got.dtype == dtype and got.shape == (b, d, d)
    bits = torch.view_as_real(got).view(torch.uint8)
    assert torch.equal(bits, torch.view_as_real(via_ops).view(torch.uint8))
    assert torch.equal(bits, torch.view_as_real(torch.complex(*planes))
                       .view(torch.uint8))
    res = DE.check_rounding((got.real, got.imag), (plain.real, plain.imag),
                            mre, mim, d)
    assert res["beyond_bound"] == res["beyond_spacings"] == 0, res
    assert torch.equal(got[0], torch.eye(d, dtype=dtype, device=card))


# |μ| where a sample's least summed magnitude falls below the smallest
# normal number at d = 16: the corner (tiny |μ|) and e^{−|μ|²/2} (large |μ|)
_BELOW_NORMAL = {torch.float32: ((1e-3, 1e-2), (13.2, 14.2)),
                 torch.float64: ((1e-22, 1e-19), (37.7, 38.5))}


@pytest.mark.parametrize("d", [2, 4, 16])
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
def test_displacement_sums_below_the_smallest_normal(card, real, d):
    """Samples whose sums reach below the dtype's smallest normal number,
    where the kernel forms the elements as the plain version does (tiny
    |μ|, log-uniform, and |μ| where e^{−|μ|²/2} is subnormal), mixed with
    ordinary ones (|μ| ≤ 1.5) in every warp: both entries meet
    ``displacement_expm.check_rounding`` and give the same bits."""
    from repro_torch.kernels import displacement_expm as DE

    rng = np.random.default_rng(40 + d)
    (t0, t1), (h0, h1) = _BELOW_NORMAL[real]
    r = np.concatenate([np.exp(rng.uniform(np.log(t0), np.log(t1), 400)),
                        rng.uniform(h0, h1, 300),
                        1.5 * np.sqrt(rng.uniform(size=303))])
    r = rng.permutation(r)
    phi = rng.uniform(0, 2 * np.pi, size=r.size)
    mre, mim = (torch.from_numpy(a).to(real).to(card)
                for a in (r * np.cos(phi), r * np.sin(phi)))
    got = DE.displacement_expm(mre, mim, d)
    joined = DE.displacement_expm_complex(torch.complex(mre, mim), d)
    want = DE.displacement_expm_plain(mre, mim, d)
    torch.cuda.synchronize()
    res = DE.check_rounding(got, want, mre, mim, d)
    assert res["beyond_bound"] == res["beyond_spacings"] == 0, res
    assert torch.equal(torch.view_as_real(joined).view(torch.uint8),
                       torch.view_as_real(torch.complex(*got))
                       .view(torch.uint8))


# the four ranges of |μ| where D(μ)'s sums reach below the smallest normal
# number, as the tile sweep reports them (PERF.md §6): (dtype, low, high,
# log-uniform)
SUBNORMAL_RANGES = [(torch.float32, 1e-3, 1e-2, True),
                (torch.float32, 13.2, 14.2, False),
                (torch.float64, 1e-22, 1e-19, True),
                (torch.float64, 37.7, 38.5, False)]


def subnormal_mu(real, lo, hi, log, device, b=2 ** 16, seed=0):
    """b draws of μ with |μ| in [lo, hi] (log-uniform or uniform) and a
    uniform phase."""
    rng = np.random.default_rng(seed)
    r = (np.exp(rng.uniform(np.log(lo), np.log(hi), b)) if log
         else rng.uniform(lo, hi, b))
    phi = rng.uniform(0, 2 * np.pi, b)
    return (torch.from_numpy(a).to(real).to(device)
            for a in (r * np.cos(phi), r * np.sin(phi)))


@pytest.mark.parametrize("real,lo,hi,log", SUBNORMAL_RANGES,
                         ids=[f"{r}-{lo}-{hi}".replace("torch.", "")
                              for r, lo, hi, _ in SUBNORMAL_RANGES])
def test_displacement_subnormal_ranges(card, real, lo, hi, log):
    """2¹⁶ draws at d = 16 in each range where D(μ)'s sums reach below the
    smallest normal number: ``check_rounding`` holds both versions; an
    element beyond the relative bound whose exact value is normal is a
    fault of the kernel."""
    from repro_torch.kernels import displacement_expm as DE

    mre, mim = subnormal_mu(real, lo, hi, log, card)
    got = DE.displacement_expm(mre, mim, 16)
    want = DE.displacement_expm_plain(mre, mim, 16)
    torch.cuda.synchronize()
    res = DE.check_rounding(got, want, mre, mim, 16)
    assert res["beyond_bound"] == res["beyond_spacings"] == 0, res


def _flash_close(got, want, qkv, causal):
    """fp32: 1e-5 of the largest |out|.  bf16: within
    ``flash_attention.rounding_bound``: the kernel rounds the weights to
    bf16 relative to its running max, the plain version relative to the
    final max, so they differ by up to two bf16 roundings of each weight
    (2⁻⁷·Σ w|v| / Σ w), the fp32 sums, and one rounding of the output."""
    from repro_torch.kernels import flash_attention as FA

    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if want.dtype == torch.float32:
        assert (g - w).abs().max().item() <= 1e-5 * max(1.0, w.abs().max())
    else:
        bound = FA.rounding_bound(*qkv, causal=causal)
        assert bool(((g - w).abs() <= bound).all())


def _flash_operands(dtype, b, s, t, kvh, g, dh, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype).to(device)
            for shape in ((b, s, kvh * g, dh), (b, t, kvh, dh),
                          (b, t, kvh, dh))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4, 6])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel(card, dtype, dh, g, causal):
    """Ragged lengths (S = 200, T = 200 causal; S = 130, T = 77 not)."""
    from repro_torch.kernels import flash_attention as FA

    s, t = (200, 200) if causal else (130, 77)
    q, k, v = _flash_operands(dtype, 2, s, t, 2, g, dh, card, dh + g)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    _flash_close(got, want, (q, k, v), causal)


@pytest.mark.parametrize("s,t", [(100, 100), (77, 130), (130, 77)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4, 6])
@pytest.mark.parametrize("dh", [64, 112, 128])
def test_flash_attention_bf16_ragged(card, dh, g, causal, s, t):
    """The tensor-core kernel on lengths that are not multiples of its
    query and key tiles, S = T and S ≠ T, within the rounding bound."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(torch.bfloat16, 1, s, t, 2, g, dh, card,
                              s + t + dh + g)
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    _flash_close(got, want, (q, k, v), causal)


def test_flash_attention_bf16_unaligned_operands(card):
    """Operands that start 2 bytes into their storage: the wrapper hands
    the kernel 16-byte aligned copies."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(torch.bfloat16, 1, 70, 90, 2, 3, 64, card, 9)
    moved = []
    for x in (q, k, v):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0 and y.is_contiguous()
        moved.append(y)
    got = FA.flash_attention(*moved, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, FA.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_at_kimi_head_dim(card, dtype, causal):
    """kimi-k2's head: Dh = 112 (7168 / 64), 8 query heads a KV head, 8
    KV heads, on a sequence of 5 query tiles and a ragged end."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(dtype, 2, 300, 300, 8, 8, 112, card,
                              112 + causal)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    _flash_close(got, want, (q, k, v), causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_at_zamba2_head_dim(card, dtype, causal):
    """zamba2's shared attention: Dh = 112 (3584 / 32) with KVH = H = 32,
    a GQA group of one, on 5 query tiles and a ragged end."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(dtype, 2, 300, 300, 32, 1, 112, card,
                              1120 + causal)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    _flash_close(got, want, (q, k, v), causal)


# (b, s, t, h, kvh, dh, causal): whisper-small's encoder, decoder self-
# and cross-attention and decode cross-attention; llama-3.2-vision-11b's
# self- and cross-attention and decode cross-attention (B cut to 2 or 1)
XATTN_SHAPES = [(1, 1500, 1500, 12, 12, 64, False),
                (2, 448, 448, 12, 12, 64, True),
                (2, 448, 1500, 12, 12, 64, False),
                (8, 1, 1500, 12, 12, 64, False),
                (1, 4096, 4096, 32, 8, 128, True),
                (1, 4096, 1600, 32, 8, 128, False),
                (8, 1, 1600, 32, 8, 128, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,t,h,kvh,dh,causal", XATTN_SHAPES)
def test_flash_attention_at_the_cross_attention_shapes(card, dtype, b, s, t,
                                                       h, kvh, dh, causal):
    """The shapes of the encoder-decoder and VLM paths: T a multiple of
    neither 64 nor 128 without the causal mask, T ≠ S, GQA 4 non-causal,
    and S = 1 (one query tile with 63 or more dead rows)."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _flash_operands(dtype, b, s, t, kvh, h // kvh, dh, card,
                              s + t + h)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    assert bool(torch.isfinite(got.float()).all())
    _flash_close(got, want, (q, k, v), causal)


@pytest.mark.parametrize("dh", [32, 96, 120])
def test_flash_attention_raises_for_a_head_dim_it_lacks(card, dh):
    """No fallback to the plain version on the card."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    q, k, v = _flash_operands(torch.bfloat16, 1, 16, 16, 2, 2, dh, card, 1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("kernel", [
    "flash_attention", "contract_measure", "site_step_born", "measure_probs",
    "collapse_select", "site_step_linear", "displacement_expm",
    *(f"{k}_bf16 {pair}" for k in ("contract_measure", "site_step_linear",
                                   "collapse_select")
      for pair in ("fp32+fp32", "fp32+bf16", "fp64+fp64"))])
def test_tensor_core_kernels_repeat_bit_for_bit(card, kernel):
    """No atomics and a fixed order of every sum: two calls, same bits."""
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import flash_attention as FA

    if kernel.startswith("contract_measure_bf16"):
        env, gamma, lam, _ = _bf16_operands(kernel.split()[1], 300, 1000,
                                            130, 4, card)
        outs = [CM.contract_measure(env, gamma, lam, torch.bfloat16)
                for _ in range(2)]
    elif kernel.startswith("collapse_select_bf16"):
        env, gamma, _, _ = _bf16_operands(kernel.split()[1], 300, 600, 520,
                                          4, card)
        samples = _collapse_samples(300, 4, (0, 1, 129), card)
        samples[::9] = -1
        outs = [(CS.collapse_select(env, gamma, samples, torch.bfloat16),)
                for _ in range(2)]
    elif kernel == "displacement_expm":
        from repro_torch.kernels import displacement_expm as DE

        mu = _disp_mu(1003, torch.complex128, card, seed=3)
        outs = [(DE.displacement_expm_complex(mu, 16),
                 *DE.displacement_expm(mu.real.contiguous(),
                                       mu.imag.contiguous(), 4))
                for _ in range(2)]
    elif kernel.startswith("site_step_linear_bf16"):
        ops = _bf16_operands(kernel.split()[1], 300, 600, 600, 4, card)
        outs = [K.site_step_linear(*ops, compute_dtype=torch.bfloat16)
                for _ in range(2)]
    elif kernel == "flash_attention":
        q, k, v = _flash_operands(torch.bfloat16, 2, 333, 333, 2, 4, 64,
                                  card, 5)
        first = FA.flash_attention(q, k, v, causal=True)
        second = FA.flash_attention(q, k, v, causal=True)
        outs = [(first,), (second,)]
    elif kernel == "contract_measure":
        env, gamma, lam, _ = _tp_operands(torch.float64, 300, 130, 65, 4,
                                          card)
        outs = [CM.contract_measure(env, gamma, lam) for _ in range(2)]
    elif kernel == "site_step_born":
        ops = _born_operands(300, 130, 130, 4, card)
        outs = [(*K.site_step_born(*ops), _born_temp(*ops, 130, 4))
                for _ in range(2)]
    elif kernel == "measure_probs":
        env, _, _, w = _tp_operands(torch.float64, 1027, 2500, 1, 4, card)
        outs = [(K.measure_probs(env, w),) for _ in range(2)]
    elif kernel == "collapse_select":
        env, gamma, _, _ = _tp_operands(torch.float64, 300, 130, 65, 4, card)
        samples = _collapse_samples(300, 4, (0, 1, 129), card)
        outs = [(CS.collapse_select(env, gamma, samples),) for _ in range(2)]
    else:
        ops = _operands("linear", torch.float64, 300, 130, 4, card)
        outs = [K.site_step_linear(*ops) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_lm_prefill_runs_the_flash_kernel(card):
    """A smoke-size prefill through the model launches the flash kernel once
    per layer and agrees with the plain attention."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = configs.get_smoke_config("granite-3-2b")
    cfg = dataclasses.replace(cfg, d_model=512)       # head_dim 64
    params = T.init_params(0, cfg, card)
    toks = torch.randint(0, cfg.vocab, (2, 100), device=card)
    ops.reset_launches()
    got, _ = T.forward(params, toks, cfg, kernels="auto")
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want, _ = T.forward(params, toks, cfg, kernels="torch")
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() <= 3e-2


def test_moe_apply_on_the_card_repeats_bit_for_bit(card):
    """``moe_apply`` at a small width on the card, twice: the same bits
    (the combine adds each token's terms in a fixed order, no atomics),
    drops included; and within the bf16 tolerance of the CPU's."""
    from repro_torch.models import moe as MOE

    cfg = MOE.MoEConfig(256, 128, 16, 4, n_shared=1, capacity_factor=0.5)
    gen = torch.Generator(device=card).manual_seed(0)
    params = MOE.moe_init(gen, cfg, torch.bfloat16, card)
    x = torch.randn((4, 64, 256), generator=gen, device=card).to(
        torch.bfloat16)
    y1, a1 = MOE.moe_apply(params, x, cfg)
    y2, a2 = MOE.moe_apply(params, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and float(a1["drop_frac"]) > 0
    assert torch.equal(a1["expert_ids"], a2["expert_ids"])
    cpu = {k: (v.cpu() if torch.is_tensor(v)
               else {n: w.cpu() for n, w in v.items()})
           for k, v in params.items()}
    y0, a0 = MOE.moe_apply(cpu, x.cpu(), cfg)
    same = (a0["expert_ids"] == a1["expert_ids"].cpu()).all(-1)
    err = ((y1.cpu().float() - y0.float()).abs().amax(-1)[same].max()
           / y0.float().abs().max())
    assert err.item() <= 3e-2


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_moe_lm_on_the_card(card, arch):
    """A smoke-width MoE model on the card: kimi-k2's prefill launches the
    flash kernel at Dh = 112 once a layer (deepseek-v3's MLA none); in
    fp32 (where no route swaps on a rounding) the logits agree with the
    plain attention's; in bf16 ``serve()`` gives the same tokens twice."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as T

    cfg = configs.get_smoke_config(arch)
    if not cfg.use_mla:
        cfg = dataclasses.replace(cfg, d_model=448)   # head_dim 112
    toks = torch.randint(0, cfg.vocab, (2, 100), device=card)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_params(0, f32, card)
    ops.reset_launches()
    got, _ = T.forward(params, toks, f32, kernels="auto")
    assert ops.launch_counts()["flash_attention"] == (
        0 if cfg.use_mla else cfg.n_layers)
    want, _ = T.forward(params, toks, f32, kernels="torch")
    torch.cuda.synchronize()
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4
    params = T.init_params(0, cfg, card)
    prompts = [(int(t), 6) for t in range(7)]
    first = serve_lm.serve(cfg, params, prompts, 3, 6, 16, verbose=False)
    again = serve_lm.serve(cfg, params, prompts, 3, 6, 16, verbose=False)
    assert first == again and sorted(first) == list(range(7))


def test_rope_on_the_card_has_the_cpu_bits(card):
    """``sin_cos`` runs glibc's algorithm in fp64 tensor ops: the card's
    rope tables equal the CPU's bit for bit (and so the reference's)."""
    from repro_torch.models import common as C

    for dh in (16, 64, 112, 128):
        pos = torch.arange(8192)[None]
        cos, sin = C.rope_tables(pos.to(card), dh)
        want_cos, want_sin = C.rope_tables(pos, dh)
        assert torch.equal(cos.cpu(), want_cos) and torch.equal(sin.cpu(),
                                                                want_sin)


def test_mamba2_on_the_card(card):
    """``mamba2_apply`` in fp32 at a small width on the card: the chunked
    prefill (S = 300: chunks of 100) and its final state against 300
    decode steps, and both against the CPU's."""
    from repro_torch.models import mamba2 as M2

    cfg = M2.Mamba2Config(d_model=128, d_state=32, d_head=32)
    gen = torch.Generator().manual_seed(0)
    params = M2.mamba2_init(gen, cfg, torch.float32, "cpu")
    params["dt_bias"] = torch.randn(cfg.heads, generator=gen) * 0.5
    params["D"] = 1 + torch.randn(cfg.heads, generator=gen) * 0.5
    x = torch.randn((2, 300, cfg.d_model), generator=gen)
    want, _ = M2.mamba2_apply(params, x, cfg)
    on = {k: v.to(card) for k, v in params.items()}
    got, _ = M2.mamba2_apply(on, x.to(card), cfg)
    st = M2.init_ssm_state(2, cfg, torch.float32, card)
    steps = []
    for t in range(300):
        y, st = M2.mamba2_apply(on, x[:, t:t + 1].to(card), cfg, st)
        steps.append(y)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * scale
    assert (torch.cat(steps, 1) - got).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-1.3b"])
def test_ssm_lm_on_the_card(card, arch):
    """A narrow SSM model on the card: zamba2's shared block at Dh = 112
    (d_model 448, 4 heads, 4 layers) launches the flash kernel once per
    application (after layers 1 and 3), mamba2 none; in fp32 the logits
    agree with the plain attention's; in bf16 ``serve()`` gives the same
    tokens twice."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as T

    cfg = configs.get_smoke_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, d_model=448)   # head_dim 112
        assert cfg.hd == 112 and cfg.n_kv_heads == cfg.n_heads
    toks = torch.randint(0, cfg.vocab, (2, 100), device=card)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = T.init_params(0, f32, card)
    ops.reset_launches()
    got, _ = T.forward(params, toks, f32, kernels="auto")
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert ops.launch_counts()["flash_attention"] == n_attn
    want, _ = T.forward(params, toks, f32, kernels="torch")
    torch.cuda.synchronize()
    err = (got - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-4
    params = T.init_params(0, cfg, card)
    prompts = [(int(t), 6) for t in range(7)]
    first = serve_lm.serve(cfg, params, prompts, 3, 6, 16, verbose=False)
    again = serve_lm.serve(cfg, params, prompts, 3, 6, 16, verbose=False)
    assert first == again and sorted(first) == list(range(7))


# ---------------------------------------------------------------------------
# bf16 inputs (compute_dtype): env and Γ fp32 (mxu_bf16), env fp32 with a
# bf16 Γ (store_bf16), or both fp64
# ---------------------------------------------------------------------------

BF16_PAIRS = {"fp32+fp32": (torch.float32, torch.float32),
              "fp32+bf16": (torch.float32, torch.bfloat16),
              "fp64+fp64": (torch.float64, torch.float64)}


def _bf16_operands(pair, n, chi_l, chi_r, d, device):
    te, tg = BF16_PAIRS[pair]
    gen = torch.Generator(device=device).manual_seed(n + 7 * chi_l + chi_r)
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    return (torch.rand((n, chi_l), **f64).to(te),
            torch.rand((chi_l, chi_r, d), **f64).to(tg),
            (torch.rand(chi_r, **f64) + 0.5).to(te),
            torch.rand(n, **f64).to(te))


def _within(got, want, bound):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert ((got.double() - want.double()).abs() <= bound).all(), \
        ((got.double() - want.double()).abs() / bound).max().item()


# (1024, 512, 4) and (1024, 2000, 4): TMA-aligned rows, several k stages
# and column tiles of the wgmma collapse
@pytest.mark.parametrize("n,chi,d", [(8, 4, 3), (37, 13, 5), (300, 130, 4),
                                     (200, 256, 16), (1024, 512, 4),
                                     (1024, 2000, 4)])
@pytest.mark.parametrize("scaling", ["none", "per_sample"])
@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_site_step_kernel(card, pair, scaling, n, chi, d):
    env, gamma, lam, u = _bf16_operands(pair, n, chi, chi, d, card)
    _bf16_site_step_within_bounds(env, gamma, lam, u, scaling)


@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_site_step_groups_of_a_few_rows(card, pair):
    """Outcome groups of 1000, 12, 8 and 4 rows (forced by operands whose
    probs are positive at one outcome a row): the wgmma collapse's tiles of
    a few rows, each stored to its own rows of env'."""
    env, gamma, lam, u = _bf16_operands(pair, 1024, 520, 520, 4, card)
    samples = _collapse_samples(1024, 4, (1000, 12, 8), card)
    env, gamma = _forced_linear(env, gamma, samples)
    s_k = _bf16_site_step_within_bounds(env, gamma, lam, u, "per_sample")
    assert torch.equal(s_k, samples)


def _bf16_site_step_within_bounds(env, gamma, lam, u, scaling):
    """The bf16 site step against its plain version: draws alike but where
    the uniform lies within the CDF's rounding bound of a boundary, env' and
    dlog of the rows drawn alike within their bounds; returns the draws."""
    before = K.LAUNCHES["site_step_linear_bf16"]
    e_k, s_k, d_k = K.site_step_linear(env, gamma, lam, u, scaling,
                                       torch.bfloat16)
    e_p, s_p, d_p = K.site_step_linear_plain(env, gamma, lam, u, scaling,
                                             torch.bfloat16)
    torch.cuda.synchronize()
    assert K.LAUNCHES["site_step_linear_bf16"] == before + 1
    pb, tb = K.site_step_bf16_bounds(env, gamma, lam)
    probs = torch.einsum("nrs,r->ns", K.contract_plain(env, gamma,
                                                       torch.bfloat16).double(),
                         lam.double())
    flip = (s_k != s_p).nonzero().flatten()
    cdf_bound = 2 * pb.sum(dim=1) / probs.sum(dim=1)
    assert (K.draw_margin(probs, u)[flip] <= cdf_bound[flip]).all()
    keep = s_k == s_p
    tb_s = torch.take_along_dim(tb, s_p[:, None, None], dim=2)[:, :, 0]
    if scaling == "per_sample":       # both divided by their own row max
        m = (torch.take_along_dim(K.contract_plain(env, gamma,
                                                   torch.bfloat16),
                                  s_p[:, None, None], dim=2)[:, :, 0]
             .double().abs().amax(dim=1, keepdim=True))
        env_bound = 2 * tb_s.amax(dim=1, keepdim=True) / m + 2.0 ** -23
        # log10 in fp32 is within 2 ulp in each version
        dlog_bound = (2 * tb_s.amax(dim=1) / m[:, 0]
                      + 2.0 ** -20 * (m[:, 0].log10().abs() + 1))
    else:
        env_bound, dlog_bound = tb_s, torch.zeros_like(tb_s[:, 0])
    _within(e_k[keep], e_p[keep], env_bound[keep])
    _within(d_k[keep], d_p[keep], dlog_bound[keep])
    return s_k


@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_operands_prepared_on_the_card(card, pair):
    """The preparation passes of the two wgmma entries against their plain
    versions, bit for bit: env in bucket order and Γ's planes (the site
    step), env and Γ's copy (contract_measure; a bf16 Γ with 16-byte rows is
    read as it lies)."""
    from repro_torch.kernels import _build

    n, chi, d = 300, 130, 4
    env, gamma, lam, u = _bf16_operands(pair, n, chi, chi, d, card)
    scratch = K.linear_scratch(n, chi, chi, d, env.dtype, card,
                               torch.bfloat16)
    K._launch(K._LINEAR_BF16_ENTRY[(env.dtype, gamma.dtype)], env, gamma,
              lam, u, scratch, n, chi, chi, d, "per_sample",
              "site_step_linear_bf16")
    _, perm, _, env16, planes = scratch
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(n, dtype=torch.int32, device=card))
    assert torch.equal(env16.view(torch.int16),
                       K.bf16_rows_plain(env, perm).view(torch.int16))
    assert torch.equal(planes.view(torch.int16),
                       K.bf16_planes_plain(gamma).view(torch.int16))
    for chi_r in (65, 130):    # R·d 260 is copied; 520, a bf16 Γ as it lies
        g = gamma[:, :chi_r].contiguous()
        env16, g16 = CM.gemm_scratch(env, g)
        temp = torch.empty((n, chi_r, d), dtype=env.dtype, device=card)
        probs = torch.empty((n, d), dtype=env.dtype, device=card)
        _build.launch(CM._BF16_ENTRY[(env.dtype, g.dtype)],
                      (env, g, lam[:chi_r].contiguous(), temp, probs, env16,
                       g16), (n, chi, chi_r, d), card, "contract_measure_bf16")
        torch.cuda.synchronize()
        assert torch.equal(env16.view(torch.int16),
                           K.bf16_rows_plain(env).view(torch.int16))
        assert (g16 is None) == (g.dtype == torch.bfloat16 and chi_r == 130)
        if g16 is not None:
            assert torch.equal(g16.view(torch.int16), K.bf16_rows_plain(
                g.reshape(chi, chi_r * d)).view(torch.int16))


# beside TP_SHAPES, the TMA-aligned path over several k stages and column
# tiles, and 10⁴-wide slices of the p₂ = 4 shard shapes
@pytest.mark.parametrize("n,chi_l,chi_r,d", TP_SHAPES + [
    (1024, 512, 640, 4), (256, 2500, 10_000, 4), (256, 10_000, 2500, 4)])
@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_tp_kernels(card, pair, n, chi_l, chi_r, d):
    env, gamma, lam, _ = _bf16_operands(pair, n, chi_l, chi_r, d, card)
    bf = torch.bfloat16
    before = {**CM.LAUNCHES, **CS.LAUNCHES, **K.LAUNCHES}
    t_k, p_k = CM.contract_measure(env, gamma, lam, bf)
    t_p, p_p = CM.contract_measure_plain(env, gamma, lam, bf)
    tb = K.bf16_gemm_bound(env, gamma.reshape(chi_l, chi_r * d)).reshape(
        n, chi_r, d)
    _within(t_k, t_p, tb)
    eps = 2.0 ** -24 if env.dtype == torch.float32 else 2.0 ** -53
    _within(p_k, p_p, torch.einsum(
        "nrs,r->ns", tb + 2 * chi_r * eps * t_p.double().abs(),
        lam.double()))
    gen = torch.Generator(device=card).manual_seed(n)
    samples = torch.randint(0, d, (n,), generator=gen, device=card)
    samples[0] = -1 if n > 1 else samples[0]
    o_k = CS.collapse_select(env, gamma, samples, bf)
    o_p = CS.collapse_select_plain(env, gamma, samples, bf)
    _within(o_k, o_p, torch.take_along_dim(
        tb, samples.clamp(0, d - 1)[:, None, None], dim=2)[:, :, 0])
    if gamma.dtype == env.dtype:
        w = torch.rand((chi_l, d), generator=gen, device=card,
                       dtype=torch.float64).to(env.dtype)
        _within(K.measure_probs(env, w, bf), K.measure_first_plain(env, w, bf),
                K.bf16_gemm_bound(env, w))
    torch.cuda.synchronize()
    after = {**CM.LAUNCHES, **CS.LAUNCHES, **K.LAUNCHES}
    for name in ("contract_measure_bf16", "collapse_select_bf16"):
        assert after[name] == before[name] + 1, name
    assert after["measure_probs_bf16"] == before["measure_probs_bf16"] + int(
        gamma.dtype == env.dtype)


@pytest.mark.parametrize("n,chi_l,chi_r,d,counts", COLLAPSE_EDGES)
@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_collapse_select_at_tile_edges(card, pair, n, chi_l, chi_r, d,
                                            counts):
    """collapse_select's bf16 entry on the wgmma collapse at the fp64
    collapse's tile edges (groups of 0 and 1 rows, and of 65, 129 and 257
    spread over two and three 128-row tiles; N, L, R off the tiles; d = 1
    and 16), with rows of no outcome (−1 and d): within the bound of the
    plain version, those rows exactly zero, one launch."""
    env, gamma, _, _ = _bf16_operands(pair, n, chi_l, chi_r, d, card)
    samples = _collapse_samples(n, d, counts, card)
    if n > 2:
        samples[1], samples[-1] = -1, d
    before = CS.LAUNCHES["collapse_select_bf16"]
    got = CS.collapse_select(env, gamma, samples, torch.bfloat16)
    want = CS.collapse_select_plain(env, gamma, samples, torch.bfloat16)
    torch.cuda.synchronize()
    assert CS.LAUNCHES["collapse_select_bf16"] == before + 1
    tb = K.bf16_gemm_bound(env, gamma.reshape(chi_l, chi_r * d)).reshape(
        n, chi_r, d)
    _within(got, want, torch.take_along_dim(
        tb, samples.clamp(0, d - 1)[:, None, None], dim=2)[:, :, 0])
    none = (samples < 0) | (samples >= d)
    assert bool((got[none] == 0).all())


@pytest.mark.parametrize("pair", list(BF16_PAIRS))
def test_bf16_collapse_operands_prepared_on_the_card(card, pair):
    """collapse_select's bf16 entry writes its operands as their plain
    versions give them, bit for bit: perm in the bucket order (rows of no
    outcome last), env rounded in that order, Γ's planes; torch.profiler
    lists its kernels (planes pass, bucket sort, zeroed rows, env16, the
    wgmma collapse) and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    n, chi_l, chi_r, d = 300, 130, 65, 4
    env, gamma, _, _ = _bf16_operands(pair, n, chi_l, chi_r, d, card)
    samples = _collapse_samples(n, d, (0, 1, 129), card)
    samples[::7] = -1
    s32 = samples.to(torch.int32)
    out = torch.empty((n, chi_r), dtype=torch.float32, device=card)
    perm = torch.empty(n, dtype=torch.int32, device=card)
    meta = torch.empty(3 * d + 1, dtype=torch.int32, device=card)
    env16, planes = CS.bf16_scratch(n, chi_l, chi_r, d, card)
    _build.launch(CS._BF16_ENTRY[(env.dtype, gamma.dtype)],
                  (env, gamma, s32, out, perm, meta, env16, planes),
                  (n, chi_l, chi_r, d), card, "collapse_select_bf16")
    torch.cuda.synchronize()
    want_perm = K.bucket_plain(samples, d)
    assert torch.equal(perm, want_perm)
    assert meta[:d].tolist() == torch.bincount(
        samples[samples >= 0], minlength=d).tolist()
    assert torch.equal(env16.view(torch.int16),
                       K.bf16_rows_plain(env, want_perm).view(torch.int16))
    assert torch.equal(planes.view(torch.int16),
                       K.bf16_planes_plain(gamma).view(torch.int16))
    kernels = ("weights_planes_kernel", "bucket_kernel", "zero_rows_kernel",
               "bf16_rows_kernel", "wgmma_bf16_kernel")
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # late in a long process torch.profiler may leave a window's
            # first launch out (PERF.md §7): let that be a PyTorch kernel's
            torch.ones(1, device=card).add_(1)
            CS.collapse_select(env, gamma, samples, torch.bfloat16)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        # a window that lists none of a kernel's launches is taken again,
        # as chip_smoke.breakdown_of does; the counts are held on a window
        # that lists each kernel
        if all(any(k in x for x in names) for k in kernels):
            break
    for kernel in kernels:
        assert sum(kernel in x for x in names) == 1, (kernel, names)
    assert len(names) == 5 + sum("at::" in x or "elementwise" in x
                                 for x in names), names


def test_bf16_kernels_round_fp64_through_fp32(card):
    """1 + 2⁻⁸ + 2⁻⁴⁰ rounds to fp32's tie 1 + 2⁻⁸ and then to 1.0 (even),
    as torch and XLA round it; one rounding would give 1.0078125."""
    x = torch.full((4, 16), 1 + 2 ** -8 + 2 ** -40, dtype=torch.float64,
                   device=card)
    ones = torch.ones((16, 16, 2), dtype=torch.float64, device=card)
    lam = torch.ones(16, dtype=torch.float64, device=card)
    temp, _ = CM.contract_measure(x, ones, lam, torch.bfloat16)
    assert (temp == 16.0).all()
    probs = K.measure_probs(x, ones[:, :, 0].contiguous(), torch.bfloat16)
    assert (probs == 16.0).all()


@pytest.mark.parametrize("tier", ["mxu_bf16", "store_bf16"])
@pytest.mark.parametrize("scheme", ["seq", "tp_single", "tp_single_mf"])
def test_bf16_walks_on_the_card(card, tier, scheme, tmp_path):
    """Each tier's walk with the kernels, site by site, against the plain
    cells run from the kernel walk's own env: the same samples.  (Left to
    run on their own, the two walks' envs differ in the last fp32 bits, and
    where that moves a bf16 rounding of env the later draws may differ.)
    The session walk launches each kernel once a site and draws the kernel
    walk's samples."""
    import torch.distributed as dist

    from repro_torch.core import parallel as PP
    from repro_torch.core import sampler as S
    from repro_torch.core.mps import MPS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    bf, n, sites = torch.bfloat16, 256, 6
    mps = M.random_linear_mps(prng.key(1), sites, 64, 3, dtype=torch.float32,
                              device=card)
    if tier == "store_bf16":
        mps = mps.to(dtype=bf)
    key, tp = prng.key(3), scheme != "seq"
    pc = PP.ParallelConfig(scheme="tp_single",
                           measure_first=scheme.endswith("_mf"))
    if tp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, card) if tp else None
        ops.reset_launches()
        cfg = api.SamplerConfig(kernels="cuda", scheme="tp_single" if tp
                                else "seq", measure_first=pc.measure_first,
                                compute_dtype=bf)
        with api.SamplingSession(mps, cfg, device=card, mesh=mesh) as s:
            walked = s.sample(n, key)
        counts = ops.launch_counts()
        names = (("site_step_linear",) if not tp else
                 ("measure_probs", "collapse_select") if pc.measure_first
                 else ("contract_measure",))
        assert {k: counts[k + "_bf16"] for k in names} == dict.fromkeys(
            names, sites)

        def step(kernels, env, ls, i):
            c = S.SamplerConfig(kernels=kernels, compute_dtype=bf)
            if not tp:
                st, (smp, _) = S.site_step(
                    S.SamplerState(env, key, ls),
                    (mps.gammas[i], mps.lambdas[i], i), c)
                return smp, st.env, st.log_scale
            smp, env, ls = PP.sample_segment(
                mesh, MPS(mps.gammas[i:i + 1], mps.lambdas[i:i + 1]), env,
                key, i, pc, c, log_scale=ls)
            return smp[0], env, ls

        env = PP.segment_env_init(n, 64, mps.gammas.dtype, card)
        ls = torch.zeros(n, device=card)
        drawn = []
        for i in range(sites):
            s_p = step("torch", env, ls, i)[0]
            s_k, env, ls = step("cuda", env, ls, i)
            np.testing.assert_array_equal(s_k.cpu().numpy(),
                                          s_p.cpu().numpy())
            drawn.append(s_k)
        np.testing.assert_array_equal(torch.stack(drawn).T.cpu().numpy(),
                                      walked)
    finally:
        if tp:
            dist.destroy_process_group()


@pytest.mark.parametrize("tier", ["mxu_bf16", "store_bf16"])
def test_bf16_tp_double_is_tp_single_on_one_rank(card, tier, tmp_path):
    """On a 1 × 1 mesh tp_double's half-sites are tp_single's sites (the
    collectives copy), so its kernel walk repeats tp_single's bit for bit,
    with ``contract_measure``'s bf16 entry launched once a site."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    mps = M.random_linear_mps(prng.key(2), 6, 64, 3, dtype=torch.float32,
                              device=card)
    if tier == "store_bf16":
        mps = mps.to(dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh, outs = make_mesh(1, card), {}
        for scheme in ("tp_single", "tp_double"):
            ops.reset_launches()
            cfg = api.SamplerConfig(kernels="cuda", scheme=scheme,
                                    compute_dtype=torch.bfloat16)
            with api.SamplingSession(mps, cfg, mesh=mesh) as s:
                outs[scheme] = s.sample(256, prng.key(4))
            assert ops.launch_counts()["contract_measure_bf16"] == 6
        np.testing.assert_array_equal(outs["tp_double"], outs["tp_single"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The clamped walk: kernel 3 on every linear clamped site (last in the file:
# the torch.profiler windows above list every launch when they run first,
# PERF.md §7)
# ---------------------------------------------------------------------------

CLAMP_SHAPES = [(1, 13, 3), (37, 130, 3), (301, 257, 4), (64, 32, 2)]


def _clamp_arrays(kind, n_sites, n, d):
    from repro_torch.workloads import clamp as WC

    spec = ({1: 0, 3: d - 1} if kind == "scalar"
            else {2: [(7 * i) % d for i in range(n)]})
    return WC.segment_clamp_arrays(WC.clamp_map(WC.normalize_clamp(spec)),
                                   0, n_sites, n)


@pytest.mark.parametrize("n,chi,d", CLAMP_SHAPES)
@pytest.mark.parametrize("real", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["scalar", "per_sample"])
@pytest.mark.parametrize("micro", [None, 1])
def test_clamped_walk_on_the_card(card, kind, real, n, chi, d, micro):
    """``clamped_segment`` with the kernels against its plain walk: the
    same samples, the clamp held, env, log_scale and log_prob within TOL;
    ``contract_measure`` launched once a site, the fused step never."""
    from repro_torch.core import clamped as CL
    from repro_torch.core import sampler as S
    from repro_torch.kernels import ops

    sites = 5
    mps = M.random_linear_mps(prng.key(n + chi), sites, chi, d, dtype=real,
                              device=card)
    mask, vals = _clamp_arrays(kind, sites, n, d)
    out = {}
    for kernels in ("cuda", "torch"):
        cfg = S.SamplerConfig(kernels=kernels)
        st = S.init_state(mps, n, prng.key(4), cfg)
        ops.reset_launches()
        out[kernels] = CL.clamped_segment(
            mps.gammas, mps.lambdas, st.env, st.key, 0, mask, vals, cfg,
            log_scale=st.log_scale, micro_batch=micro)
        torch.cuda.synchronize()
        out[kernels + "/launches"] = ops.launch_counts()
    per_walk = sites * (n if micro else 1)
    assert out["cuda/launches"]["contract_measure"] == per_walk
    assert out["cuda/launches"]["site_step_linear"] == 0
    assert sum(out["torch/launches"].values()) == 0
    got, want = out["cuda"], out["torch"]
    assert torch.equal(got[0], want[0])
    assert (got[0].cpu().numpy()[mask] == vals[mask]).all()
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, real)
    assert torch.isfinite(got[3]).all() and (got[3] < 0).all()


def test_clamped_sessions_on_the_card(card, tmp_path):
    """Clamped session walks on the card, kernels against plain cells: seq
    in memory and streamed, dp, tp_single (± measure_first) and tp_double
    (the dp walk) on a one-rank NCCL mesh, Born seq; an empty clamp gives
    the unclamped walk.  The seq walks draw on the key and the mesh walks
    on the shard key ``split(key, 1)[0]``, so each group shares one
    result."""
    import torch.distributed as dist

    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    clamp = {1: 2, 4: 0}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, card)
        mps = M.random_linear_mps(prng.key(0), 6, 40, 3, device=card)
        with GammaStore(str(tmp_path / "gamma"), torch.float64,
                        torch.float64) as store:
            store.write_mps(mps)
            cells = [(mps, "seq", False, None), (store, "seq", False, None),
                     (mps, "dp", False, mesh), (store, "dp", False, mesh),
                     (mps, "tp_single", False, mesh),
                     (mps, "tp_single", True, mesh),
                     (mps, "tp_double", False, mesh)]
            first = {}
            for source, scheme, mf, m in cells:
                outs = {}
                for kernels in ("cuda", "torch"):
                    ops.reset_launches()
                    cfg = api.SamplerConfig(kernels=kernels, scheme=scheme,
                                            measure_first=mf, clamp=clamp,
                                            segment_len=2)
                    with api.SamplingSession(source, cfg, device=card,
                                             mesh=m) as s:
                        outs[kernels] = (s.sample(128, prng.key(3)),
                                         s.stats["log_prob"])
                    torch.cuda.synchronize()
                    outs[kernels + "/launches"] = ops.launch_counts()
                assert outs["cuda/launches"]["contract_measure"] == 6
                assert sum(outs["torch/launches"].values()) == 0
                np.testing.assert_array_equal(outs["cuda"][0],
                                              outs["torch"][0])
                np.testing.assert_allclose(outs["cuda"][1], outs["torch"][1],
                                           **TOL[torch.float64])
                assert (outs["cuda"][0][:, 1] == 2).all()
                group = first.setdefault(scheme == "seq", outs["cuda"][0])
                np.testing.assert_array_equal(outs["cuda"][0], group)
        for m, scheme in ((None, "seq"), (mesh, "dp")):
            with api.SamplingSession(mps, api.SamplerConfig(
                    scheme=scheme, clamp={}), device=card, mesh=m) as s:
                empty = s.sample(128, prng.key(3))
                assert "log_prob" not in s.stats
            with api.SamplingSession(mps, api.SamplerConfig(scheme=scheme),
                                     device=card, mesh=m) as s:
                np.testing.assert_array_equal(empty, s.sample(128,
                                                              prng.key(3)))
    finally:
        dist.destroy_process_group()
    born = M.random_born_mps(prng.key(1), 5, 24, 3, device=card)
    outs = {}
    for kernels in ("cuda", "torch"):
        with api.SamplingSession(born, api.SamplerConfig(
                kernels=kernels, clamp={0: 1, 3: 2}), device=card) as s:
            outs[kernels] = (s.sample(64, prng.key(2)), s.stats["log_prob"])
    np.testing.assert_array_equal(outs["cuda"][0], outs["torch"][0])
    np.testing.assert_allclose(outs["cuda"][1], outs["torch"][1],
                               **TOL[torch.float64])
    assert (outs["cuda"][0][:, 3] == 2).all()


# ---------------------------------------------------------------------------
# the service and cluster runtimes on the card
# ---------------------------------------------------------------------------

def _service_chain(card):
    return M.random_linear_mps(prng.key(3), 6, 64, 3, dtype=torch.float64,
                               device=card)


def test_thread_lanes_on_the_card(card):
    """Two thread lanes share the card's stream and the launch counters: a
    4-batch job equals the one-shot kernel walks on the batch keys, and
    every launch is counted once."""
    from repro_torch.api.service import batch_key
    from repro_torch.kernels import ops

    mps, key = _service_chain(card), prng.key(5)
    cfg = api.SamplerConfig(kernels="cuda")
    with api.SamplingSession(mps, cfg, device=card) as s:
        refs = [s.sample(64, batch_key(key, b, 4)) for b in range(4)]
    ops.reset_launches()
    # no straggler reclaim: a duplicated batch would launch twice
    with api.SamplingService(workers=2, straggler_k=None, device=card) as svc:
        out = svc.submit(mps, cfg, n_samples=256, key=key,
                         macro_batches=4).result(timeout=300)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out, np.concatenate(refs))
    assert ops.launch_counts()["site_step_linear"] == 4 * mps.n_sites


def test_fleet_worker_walks_on_the_card(card, tmp_path):
    """A fleet worker process walks on the card (its launches reported in
    the result header) and gives the in-process walk's samples."""
    from repro_torch.data.gamma_store import GammaStore

    mps, key = _service_chain(card), prng.key(8)
    with GammaStore(str(tmp_path), torch.float64, torch.float64) as st:
        st.write_mps(mps)
        cfg = api.SamplerConfig(segment_len=2)
        with api.SamplingSession(st, cfg, device=card) as s:
            want = s.sample(64, key)
        pool = api.WorkerPool()
        with api.SamplingService(workers=1, pool=pool) as svc:
            h = svc.submit(st, cfg, n_samples=64, key=key)
            got = h.result(timeout=300)
            stats = h.stats[0]
        pool.close()
    np.testing.assert_array_equal(got, want)
    assert stats["launches"] == {"site_step_linear": mps.n_sites}


_GLOO_RANK = """
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import api
from repro_torch.core import prng
from repro_torch.data.gamma_store import GammaStore
from repro_torch.kernels import ops
rank, root, out, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "fs"), 2),
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=300))
rt = api.TorchMultiHostRuntime()
with GammaStore(root, torch.bfloat16, torch.float64) as st, \\
        api.SamplingSession(st, api.SamplerConfig(
            backend="streamed", runtime=rt, segment_len=2),
            device="cuda:0") as s:
    ops.reset_launches()
    with api.SamplingService(workers=1) as svc:
        h = svc.submit(s, n_samples=2 * n, key=prng.key(0), macro_batches=2,
                       checkpoint_root=os.path.join(out, f"ck{rank}"))
        blocks = dict(h.stream(timeout=300))
        segs = h.stats[1]["segments"]
    torch.cuda.synchronize()
    for b, blk in blocks.items():
        np.save(os.path.join(out, f"rank{rank}_{b}.npy"), blk)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": {k: v for k, v in ops.launch_counts().items()
                                if v}, "resumed_segments": segs}, f)
dist.barrier()
rt.close()
dist.destroy_process_group()
"""


def test_broadcast_plane_on_the_card(card, tmp_path):
    """``runtime="multihost"`` on 2 gloo processes sharing the card, one
    pipelined 2-batch job on a one-lane service each: batch 1 resumes
    from an unclean stop at different boundaries (sites 4 and 2), and
    every block equals the local kernel walk, each process launching the
    site step once a site it walked."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.api.service import batch_checkpoint_dir, batch_key
    from repro_torch.data.gamma_store import GammaStore

    mps, n = _service_chain(card), 64
    root, out = str(tmp_path / "store"), tmp_path / "out"
    out.mkdir()
    keys = [batch_key(prng.key(0), b, 2) for b in (0, 1)]
    with GammaStore(root, torch.bfloat16, torch.float64) as st:
        st.write_mps(mps)
        cfg = api.SamplerConfig(segment_len=2)
        with api.SamplingSession(st, cfg, device=card) as s:
            want = [s.sample(n, k) for k in keys]
        for rank, cut in ((0, 4), (1, 2)):
            ck = batch_checkpoint_dir(str(out / f"ck{rank}"), 1)
            with api.SamplingSession(st, cfg, device=card) as s:
                s.sample(n, keys[1], checkpoint_dir=ck)
            for f in os.listdir(ck):            # the stop after ``cut``
                if f.startswith("site_") and f.endswith(".npz") and \
                        int(f[len("site_"):-len(".npz")]) > cut:
                    os.remove(os.path.join(ck, f))
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r),
                               root, str(out), str(n)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    for r in (0, 1):
        for b in (0, 1):
            np.testing.assert_array_equal(
                np.load(out / f"rank{r}_{b}.npy"), want[b])
        rec = json.loads((out / f"rank{r}.json").read_text())
        assert rec["resumed_segments"] == 2                # sites 2..6
        assert rec["launches"] == {"site_step_linear": mps.n_sites + 4}

@pytest.mark.parametrize("vocab", [1, 128, 49155, 2 ** 31 - 1])
def test_randint_and_token_stream_on_the_card(card, vocab):
    """``prng.randint`` and the synthetic token stream give the CPU's bits
    on the card."""
    from repro_torch.data.tokens import synthetic_token_stream

    for seed, step in ((0, 0), (7, 123)):
        want = synthetic_token_stream(seed, vocab, 3, 257)(step)
        got = synthetic_token_stream(seed, vocab, 3, 257, card)(step)
        for k in want:
            assert got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), want[k])
    assert torch.equal(prng.randint(prng.key(5), (4, 1000), -9, 2 ** 31 - 1,
                                    card).cpu(),
                       prng.randint(prng.key(5), (4, 1000), -9, 2 ** 31 - 1))


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-1.3b",
                                  "whisper-small"])
def test_train_step_on_the_card(card, arch):
    """One fp32 ``make_train_step`` of the smoke config on the card against
    the same step on the CPU from the same weights and batch: loss and
    gnorm within rtol 1e-5, each leaf's gradient within 1e-4 of its
    largest |g|; the updated weights within lr·1e-2 where |g| is above
    1e-2 of its leaf's largest, within 2·lr elsewhere (adamw divides m by
    √v: a gradient a rounding away from 0 may move its weight by lr
    either way; the CPU tests' rule); the flash kernel is not launched."""
    import copy

    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.train import stub_inputs
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype=torch.float32, remat_policy="dots")
    cpu = T.init_params(0, cfg, "cpu")
    gpu = copy.deepcopy(cpu).to(card)
    batch = {**synthetic_token_stream(3, cfg.vocab, 2, 16)(0),
             **stub_inputs(cfg, 2, 0, "cpu")}
    out = {}
    ops.reset_launches()
    for where, params in (("cpu", cpu), ("card", gpu)):
        _, _, grads = steps.loss_and_grads(
            params, {k: v.to(params.device) for k, v in batch.items()}, cfg)
        opt = optimizers.adamw(1e-3)
        _, _, m = steps.make_train_step(cfg, opt)(
            params, opt.init(params),
            {k: v.to(params.device) for k, v in batch.items()})
        out[where] = (grads, m)
    assert ops.launch_counts()["flash_attention"] == 0
    for name in ("loss", "gnorm"):
        assert float(out["card"][1][name]) == pytest.approx(
            float(out["cpu"][1][name]), rel=1e-5)
    for path, rows in out["cpu"][0].items():
        want = torch.stack(rows)
        got = torch.stack(out["card"][0][path]).cpu()
        scale = float(want.abs().max()) or 1.0
        assert float((got - want).abs().max()) <= 1e-4 * scale, path
    for (path, a), (_, b) in zip(cpu.ref_leaves().items(),
                                 gpu.ref_leaves().items()):
        g = torch.stack(out["cpu"][0][path]).abs()
        d = (b.full().cpu() - a.full()).abs().reshape(g.shape)
        assert float(d.max()) <= 2e-3, path
        big = g > 1e-2 * g.max()
        assert not big.any() or float(d[big].max()) <= 1e-5, path
