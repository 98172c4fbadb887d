"""The port's optimizers, LR schedule, int8 gradient compression, ``randint``,
synthetic token stream and checkpoint store against the JAX package on the
same numpy inputs (CPU).

The optimizers run over the reference's leaves: a stacked leaf is the list
of its rows (``core.tree.Leaf``), so adafactor's ``_factored``, ``vr``/
``vc`` and update clip see the stacked array as the reference's do.  The
state starts from the reference's after one step (nonzero moments),
carried over with ``convert.opt_state_from_arrays``; three more steps
follow in each package.  Tolerances: parameters and state within rtol
1e-6 (fp32) and one bf16 ulp (bf16 leaves: an update that lands near a
rounding boundary rounds either way); the schedule within rtol 1e-6;
everything else bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import store as jax_store  # noqa: E402
from repro.data.tokens import synthetic_token_stream as jax_stream  # noqa
from repro.optim import compression as jax_C  # noqa: E402
from repro.optim import optimizers as jax_O  # noqa: E402
from repro.optim import schedule as jax_S  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.tree import Leaf  # noqa: E402
from repro_torch.data.tokens import synthetic_token_stream  # noqa: E402
from repro_torch.optim import compression as C  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.optim import schedule as S  # noqa: E402
from repro_torch.runtime.faults import CorruptSegment  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, E, DM, DFF, V = 3, 4, 8, 6, 10


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 20), (5, 5)])
def test_cosine_schedule(warmup, total):
    want = jax_S.cosine_schedule(2e-3, warmup, total)
    got = S.cosine_schedule(2e-3, warmup, total)
    for step in range(total + 6):
        w, g = np.float32(want(step)), got(step)
        assert g.dtype == torch.float32
        assert float(g) == pytest.approx(float(w), rel=1e-6, abs=0), step


def _ref_tree(seed: int) -> dict:
    """fp32 and bf16 leaves, a stacked (L, dm) norm, a stacked (L, E, dm,
    dff) expert leaf, a stacked (L, dm, dff) matrix, unstacked (V, dm) and
    (dm,) leaves."""
    rng = np.random.default_rng(seed)

    def a(*shape, dt=np.float32):
        return rng.normal(size=shape).astype(np.float32).astype(dt)
    return {"embed": a(V, DM, dt=ml_dtypes.bfloat16),
            "ln_f": a(DM),
            "layers": {"ln1": a(L, DM, dt=ml_dtypes.bfloat16),
                       "experts": a(L, E, DM, DFF),
                       "w": a(L, DM, DFF, dt=ml_dtypes.bfloat16)}}


def _port(tree: dict) -> dict:
    """The reference's numpy tree as the port's leaves by path."""
    out = {}
    for path, arr in [("embed", tree["embed"]), ("ln_f", tree["ln_f"])]:
        out[path] = Leaf([convert.tensor_from_array(arr, "cpu")], False)
    for name, arr in sorted(tree["layers"].items()):
        t = convert.tensor_from_array(arr, "cpu")
        out[f"layers/{name}"] = Leaf([r.clone() for r in t.unbind(0)], True)
    return dict(sorted(out.items()))


def _grads(port: dict, seed: int):
    rng = np.random.default_rng(seed)
    ref, tgrads = {}, {}
    for path, leaf in port.items():
        g = rng.normal(size=leaf.shape).astype(np.float32)
        g[..., 0] *= 1e-3                      # uneven rows and columns
        arr = g.astype(ml_dtypes.bfloat16) if leaf.dtype == torch.bfloat16 \
            else g
        t = convert.tensor_from_array(arr, "cpu")
        tgrads[path] = list(t.unbind(0)) if leaf.stacked else [t]
        node, *rest = path.split("/")
        if rest:
            ref.setdefault(node, {})[rest[0]] = jnp.asarray(arr)
        else:
            ref[node] = jnp.asarray(arr)
    return ref, tgrads


def _hold(got: np.ndarray, want: np.ndarray, what: str):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == ml_dtypes.bfloat16:
        g = got.view(ml_dtypes.bfloat16).astype(np.float32)
        w = want.astype(np.float32)
        ulp = np.abs(w) * 2.0 ** -7
        assert (np.abs(g - w) <= ulp + 1e-30).all(), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=what)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_over_stacked_leaves(name):
    make_j, make_t = getattr(jax_O, name), getattr(O, name)
    kw = {"weight_decay": 0.1} if name == "adafactor" else {}
    jopt = make_j(jax_S.cosine_schedule(1e-2, 1, 5), **kw)
    topt = make_t(S.cosine_schedule(1e-2, 1, 5), **kw)
    tree = _ref_tree(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    g0, _ = _grads(_port(tree), 100)
    jparams, jstate = jopt.update(g0, jstate, jparams)

    params = _port(jax.tree_util.tree_map(np.asarray, jparams))
    arrays = (np.asarray(jstate.step),
              jax.tree_util.tree_map(np.asarray, jstate.inner))
    state = convert.opt_state_from_arrays(arrays, params, "cpu")
    if name == "adafactor":     # the stacked norm's factors: (L,) and (dm,)
        assert state.inner["layers/ln1"]["vr"].shape == (L,)
        assert state.inner["layers/ln1"]["vc"].shape == (DM,)
        assert state.inner["layers/experts"]["vc"].shape == (L, E, DFF)
    for step in range(3):
        jg, tg = _grads(params, 200 + step)
        jparams, jstate = jopt.update(jg, jstate, jparams)
        params, state = topt.update(tg, state, params)
    assert int(state.step) == int(jstate.step) == 4
    got_step, got_inner = convert.opt_state_to_arrays(state)
    assert got_step.dtype == np.int32 and int(got_step) == 4
    want_inner = jax.tree_util.tree_map(np.asarray, jstate.inner)
    assert (jax.tree_util.tree_structure(got_inner)
            == jax.tree_util.tree_structure(want_inner))
    for (kp, w), g in zip(
            jax.tree_util.tree_flatten_with_path(want_inner)[0],
            jax.tree_util.tree_leaves(got_inner)):
        _hold(g, w, jax.tree_util.keystr(kp))
    for path, leaf in params.items():
        _hold(convert.array_from_tensor(leaf.full()),
              np.asarray(_at(jparams, path)), path)


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def test_optimizer_for_every_config():
    for arch in configs.ARCHS:
        want = jax_O.optimizer_for(jax_configs.get_config(arch)).name
        assert O.optimizer_for(configs.get_config(arch)).name == want, arch
    assert {O.optimizer_for(configs.get_config(a)).name
            for a in configs.ARCHS} == {"adamw", "adafactor"}


@pytest.mark.parametrize("n", [1, 255, 256, 700, 1024])
def test_int8_roundtrip_bit_for_bit(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 3
    if n >= 512:
        x[256:512] = 0                          # an all-zero block
    jq, js = jax_C.int8_compress(jnp.asarray(x))
    q, s = C.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    shape = (n,) if n % 2 else (2, n // 2)
    jd = jax_C.int8_decompress(jq, js, shape, jnp.bfloat16)
    d = C.int8_decompress(q, s, shape, torch.bfloat16)
    np.testing.assert_array_equal(convert.array_from_tensor(d),
                                  np.asarray(jd).view(np.uint16))


def test_compressed_psum_one_rank():
    """One member: the reference's single-axis case (``vmap`` over an axis
    of size 1) and the port's over a one-rank gloo group."""
    x = np.random.default_rng(5).normal(size=(3, 300)).astype(np.float32)
    want = jax.vmap(lambda v: jax_C.compressed_psum(v, "i"),
                    axis_name="i")(jnp.asarray(x)[None])[0]
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        got = C.compressed_psum(torch.from_numpy(x), dist.group.WORLD)
    finally:
        if made:
            dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_RANK = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.optim.compression import compressed_psum
    rank, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2)
    x = np.random.default_rng(rank).normal(size=(5, 130)).astype(np.float32)
    x *= 10.0 ** rank
    y = compressed_psum(torch.from_numpy(x), dist.group.WORLD)
    np.save(out, y.numpy())
    dist.destroy_process_group()
""")


def test_compressed_psum_two_gloo_ranks(tmp_path):
    """Two gloo ranks against the formula in numpy: each block requantised
    to the ranks' largest scale, summed as integers."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npy")], env=env) for r in range(2)]
    assert [p.wait(timeout=150) for p in procs] == [0, 0]
    xs = [np.random.default_rng(r).normal(size=(5, 130)).astype(np.float32)
          * np.float32(10.0 ** r) for r in range(2)]

    def compress(x):
        flat = np.pad(x.reshape(-1), (0, (-x.size) % 256)).reshape(-1, 256)
        scale = np.abs(flat).max(axis=1, keepdims=True) / np.float32(127)
        q = np.round(flat / np.where(scale > 0, scale, 1)).astype(np.int8)
        return q, scale
    qs = [compress(x) for x in xs]
    gmax = np.maximum(qs[0][1], qs[1][1])
    acc = sum(np.round(q.astype(np.float32) * s / np.where(gmax > 0, gmax, 1)
                       * np.float32(127)).astype(np.int32) for q, s in qs)
    want = (acc.astype(np.float32) * gmax / np.float32(127)).reshape(-1)[
        :xs[0].size].reshape(xs[0].shape)
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      want)


@pytest.mark.parametrize("vocab", [1, 128, 49155, 2 ** 31 - 1])
def test_randint_and_token_stream_bit_for_bit(vocab):
    for seed in (0, 1, 12345):
        for step in (0, 1, 999):
            for batch, seq in ((1, 1), (3, 17), (4, 64)):
                want = jax_stream(seed, vocab, batch, seq)(step)
                got = synthetic_token_stream(seed, vocab, batch, seq)(step)
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  np.asarray(want[k]))
    for lo, hi in ((-7, 9), (-2 ** 31, 2 ** 31 - 1), (5, 5), (9, -3)):
        want = jax.random.randint(jax.random.key(vocab % 1000), (257,), lo,
                                  hi, jnp.int32)
        got = prng.randint(prng.key(vocab % 1000), (257,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ckpt_tree(seed: int):
    """(reference tree, port tree) with the same bits: bf16, fp32 and int32
    leaves, stacked and not."""
    ref = _ref_tree(seed)
    ref["count"] = np.arange(6, dtype=np.int32).reshape(2, 3) * (seed + 1)
    port = _port({k: v for k, v in ref.items() if k != "count"})
    port["count"] = Leaf([torch.from_numpy(ref["count"].copy())], False)
    return ref, port


def test_store_round_trip_prune_and_faults(tmp_path):
    root = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(root, _ckpt_tree(0)[1])
    assert store.latest_step(root) is None
    for step in range(1, 6):
        store.save_checkpoint(root, step, _ckpt_tree(step)[1],
                              {"note": step})
    assert sorted(os.listdir(root)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    assert store.latest_step(root) == 5
    template = _ckpt_tree(0)[1]
    _, step, extra = store.load_checkpoint(root, template)
    assert (step, extra) == (5, {"note": 5})
    want = _ckpt_tree(5)[1]
    for path in want:
        assert torch.equal(template[path].full(), want[path].full()), path
    _, step, _ = store.load_checkpoint(root, template, step=3)
    assert step == 3 and torch.equal(template["count"].full(),
                                     _ckpt_tree(3)[1]["count"].full())
    d = os.path.join(root, "step_00000005")
    f = os.path.join(d, "layers__w.npy")
    data = bytearray(open(f, "rb").read())
    data[-3] ^= 0x10
    open(f, "wb").write(bytes(data))
    with pytest.raises(CorruptSegment, match="digest mismatch"):
        store.load_checkpoint(root, template)


def test_store_across_packages(tmp_path):
    """A checkpoint written by either package loads in the other, bit for
    bit, and both write the same manifest."""
    ref, port = _ckpt_tree(7)
    jtree = jax.tree_util.tree_map(jnp.asarray, ref)
    jax_store.save_checkpoint(str(tmp_path / "j"), 2, jtree)
    store.save_checkpoint(str(tmp_path / "t"), 2, port)
    mj, mt = (json.load(open(tmp_path / d / "step_00000002" /
                             "manifest.json")) for d in ("j", "t"))
    assert mj == mt

    template = _ckpt_tree(0)[1]
    store.load_checkpoint(str(tmp_path / "j"), template)
    for path in port:
        assert torch.equal(template[path].full(), port[path].full()), path
    jtemplate = jax.tree_util.tree_map(jnp.asarray, _ckpt_tree(0)[0])
    back, step, _ = jax_store.load_checkpoint(str(tmp_path / "t"), jtemplate)
    assert step == 2
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                          jax.tree_util.tree_leaves(back)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(
            np.asarray(g).view(np.uint8), np.asarray(w).view(np.uint8),
            err_msg=jax.tree_util.keystr(kp))


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_arrays_round_trip(arch):
    """``convert.lm_arrays_from_params`` inverts ``lm_params_from_arrays``
    bit for bit: the reference's stacked tree back, every leaf's dtype and
    shape, for every family."""
    from repro.models import transformer as jax_T

    jparams, _ = jax_T.init_params(jax.random.key(1),
                                   jax_configs.get_smoke_config(arch))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = convert.lm_arrays_from_params(convert.lm_params_from_arrays(
        tree, configs.get_smoke_config(arch), "cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                          jax.tree_util.tree_leaves(back)):
        assert g.dtype == w.dtype and g.shape == w.shape, kp
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=jax.tree_util.keystr(kp))


def test_adafactor_takes_an_expert_stack_in_pieces(monkeypatch):
    """An expert stack (E, dm, df) whose fp32 copy is above
    ``PIECE_BYTES`` is updated a few experts at a time
    (``optimizers.expert_pieces``: its g² sums, rms_u and update a piece at
    a time; gnorm too): two adafactor steps give the whole stack's weights
    and state within rtol 1e-6 (rms_u sums its pieces in another order);
    an attention leaf (dm, heads, dh) is never cut, bit for bit."""
    from repro_torch.launch import steps as psteps

    gen = torch.Generator().manual_seed(5)

    def rows(*shape):
        return [torch.randn(shape, generator=gen) for _ in range(2)]

    weights = {"layers/moe/gate": rows(8, 16, 12),
               "layers/attn/wq": rows(16, 4, 8)}
    grads = {p: rows(*ts[0].shape) for p, ts in weights.items()}
    opt = O.adafactor()

    def run(piece_bytes):
        monkeypatch.setattr(O, "PIECE_BYTES", piece_bytes)
        params = {p: Leaf([t.clone() for t in ts], True)
                  for p, ts in weights.items()}
        state = opt.init(params)
        for _ in range(2):
            params, state = opt.update(grads, state, params)
        return params, state, float(psteps._gnorm(None, grads, None))

    whole = run(1 << 30)
    cut = run(4 * 16 * 12 * 3)                       # 3 experts a piece
    assert O.expert_pieces(grads["layers/moe/gate"][0]) == [
        slice(0, 3), slice(3, 6), slice(6, 9)]
    assert O.expert_pieces(grads["layers/attn/wq"][0]) == [slice(None)]
    for path in weights:
        for a, b in zip(whole[0][path].tensors, cut[0][path].tensors):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        for k, leaf in whole[1].inner[path].items():
            for a, b in zip(leaf.tensors, cut[1].inner[path][k].tensors):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                           err_msg=(path, k))
    for a, b in zip(whole[0]["layers/attn/wq"].tensors,
                    cut[0]["layers/attn/wq"].tensors):
        assert torch.equal(a, b)
    assert cut[2] == pytest.approx(whole[2], rel=1e-6)
