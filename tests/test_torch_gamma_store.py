"""The port's Γ store (``repro_torch.data.gamma_store``) against the JAX
package's (``repro.data.gamma_store``): one on-disk format.

* A store written by either package reads in the other: the same
  ``digest()``, decoded values equal bit for bit (fp32 and fp64 Γ with bf16
  storage, and identity storage), and the two packages write the same bf16
  bits for the same Γ — fp64 values just off bf16 midpoints and at the
  edge of fp32's normal range included.
* A torn npz, a flipped byte and a segment payload whose crc does not match
  each raise ``CorruptSegment``; a digest manifest catches a rewritten site.
* One read per site along a walk; the prefetch slot never reads twice.
* A bf16 store of a complex (Born) chain raises ``ValueError``.
"""
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mps as JM  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.data.gamma_store import decode_segment as j_decode  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.data import gamma_store as GS  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.runtime.faults import CorruptSegment  # noqa: E402

_T = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp64": torch.float64,
      "c128": torch.complex128}
_J = {"bf16": jnp.bfloat16, "fp32": jnp.float32, "fp64": jnp.float64,
      "c128": jnp.complex128}


def _midpoint_gammas(shape, seed=0) -> np.ndarray:
    """fp64 values at, and one fp64 ulp either side of, midpoints between
    neighbouring bf16 values (positive, as Γ is), with some near fp32's
    smallest normal number."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    bits = rng.integers(0x0080, 0x7F7F, size=n, dtype=np.uint16)
    lo = bits.view(ml_dtypes.bfloat16).astype(np.float64)
    hi = (bits + 1).view(ml_dtypes.bfloat16).astype(np.float64)
    mid = (lo + hi) / 2
    out = np.where(rng.integers(0, 3, n) == 0, mid,
                   np.where(rng.integers(0, 2, n) == 0,
                            np.nextafter(mid, np.inf),
                            np.nextafter(mid, -np.inf)))
    tiny = 2.0 ** -126
    edge = rng.integers(0, 8, n) == 0
    out[edge] = tiny * (1 - rng.uniform(0, 2 ** -22, edge.sum()))
    return out.reshape(shape)


CHAINS = {"linear": lambda: JM.random_linear_mps(jax.random.key(0), 5, 6, 3),
          "midpoints": None, "born": lambda: JM.random_born_mps(
              jax.random.key(1), 4, 4, 2)}


def _chain(name, dtype):
    if name == "midpoints":
        g = _midpoint_gammas((4, 8, 8, 3)).astype(dtype)
        lam = np.random.default_rng(1).uniform(1, 2, (4, 8)).astype(dtype)
        return g, lam
    m = CHAINS[name]()
    return np.asarray(m.gammas).astype(dtype), np.asarray(m.lambdas)


def _write(pkg, root, storage, compute, g, lam):
    if pkg == "jax":
        with JStore(root, storage_dtype=_J[storage],
                    compute_dtype=_J[compute]) as st:
            for i in range(g.shape[0]):
                st.put(i, g[i], lam[i])
    else:
        with GammaStore(root, storage_dtype=_T[storage],
                        compute_dtype=_T[compute]) as st:
            for i in range(g.shape[0]):
                st.put(i, torch.from_numpy(g[i]), lam[i])


CELLS = [("linear", "fp64", "bf16", "fp64"),
         ("linear", "fp32", "bf16", "fp32"),
         ("midpoints", "fp64", "bf16", "fp64"),
         ("midpoints", "fp32", "bf16", "fp32"),
         ("linear", "fp64", "fp64", "fp64"),
         ("linear", "fp32", "fp32", "fp32"),
         ("linear", "fp64", "fp32", "fp32"),
         ("born", "c128", "c128", "c128")]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("chain,gdtype,storage,compute", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_stores_read_across_packages(tmp_path, writer, chain, gdtype,
                                     storage, compute):
    np_dtype = {"fp64": np.float64, "fp32": np.float32,
                "c128": np.complex128}[gdtype]
    g, lam = _chain(chain, np_dtype)
    _write(writer, str(tmp_path), storage, compute, g, lam)
    with JStore(str(tmp_path), storage_dtype=_J[storage],
                compute_dtype=_J[compute]) as js, \
            GammaStore(str(tmp_path), storage_dtype=_T[storage],
                       compute_dtype=_T[compute]) as ts:
        assert ts.digest() == js.digest()
        assert ts.n_sites == js.n_sites == g.shape[0]
        assert ts.meta(0) == js.meta(0)
        jg, jl = js.get_segment(0, js.n_sites)
        tg, tl = ts.get_segment(0, ts.n_sites)
        jg = np.asarray(jg)
        assert tg.numpy().dtype == jg.dtype
        np.testing.assert_array_equal(tg.numpy().view(np.uint8),
                                      jg.view(np.uint8))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        # one site at a time, and a χ-sliced segment on the CPU
        for i in range(ts.n_sites):
            np.testing.assert_array_equal(ts.get(i)[0].numpy(), jg[i])
        part = ts.get_segment_on_device(1, 2, "cpu", chi=3)
        np.testing.assert_array_equal(part["gammas"].numpy(),
                                      jg[1:3, :3, :3])
        np.testing.assert_array_equal(part["lambdas"].numpy(),
                                      np.asarray(jl)[1:3, :3])


@pytest.mark.parametrize("chain,gdtype", [("midpoints", np.float64),
                                          ("midpoints", np.float32),
                                          ("linear", np.float64)])
def test_both_packages_write_the_same_bf16_bits(tmp_path, chain, gdtype):
    g, lam = _chain(chain, gdtype)
    _write("jax", str(tmp_path / "jax"), "bf16", "fp32", g, lam)
    _write("port", str(tmp_path / "port"), "bf16", "fp32", g, lam)
    for i in range(g.shape[0]):
        name = GS.site_filename(i)
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bf16_rounding_equals_jax_on_its_hard_cases():
    """Values where one rounding and two differ, where XLA flushes an fp32
    result that is tiny, the range's ends, signs and zeros."""
    tiny = 2.0 ** -126
    x = np.concatenate([
        _midpoint_gammas((20_000,), seed=3),
        -_midpoint_gammas((20_000,), seed=4),
        np.random.default_rng(5).normal(size=20_000),
        tiny * np.array([1, 1 - 2 ** -24, 1 - 2 ** -25, 1 - 2 ** -26,
                         (1 - 2 ** -25) * (1 + 2 ** -50),
                         (1 - 2 ** -25) * (1 - 2 ** -50), 2 ** -10, 0.5]),
        np.array([0.0, -0.0, 1e-300, 5e-324, 3.3895e38, 3.3897e38, 3.4e38,
                  3.5e38, -1e39, np.inf, -np.inf, 1.0, -2.0])])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = GS.bf16_bits(torch.from_numpy(x)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    with np.errstate(over="ignore"):                # beyond fp32: ±inf
        x32 = x.astype(np.float32)
    want = np.asarray(jnp.asarray(x32).astype(jnp.bfloat16)).view(np.uint16)
    got = GS.bf16_bits(torch.from_numpy(x32)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert torch.isnan(GS.bf16_bits(torch.tensor([np.nan])).view(
        torch.bfloat16)).all()


def test_bf16_store_of_a_complex_chain_raises(tmp_path):
    g, lam = _chain("born", np.complex128)
    with GammaStore(str(tmp_path), storage_dtype=torch.bfloat16) as st:
        with pytest.raises(ValueError, match="imaginary"):
            st.put(0, torch.from_numpy(g[0]), lam[0])
        assert st.n_sites == 0


def _store(tmp_path, storage="bf16", compute="fp64", n=4):
    g, lam = _chain("linear", np.float64)
    _write("port", str(tmp_path), storage, compute, g[:n], lam[:n])
    return GammaStore(str(tmp_path), storage_dtype=_T[storage],
                      compute_dtype=_T[compute])


def test_a_torn_npz_raises_corrupt_segment(tmp_path):
    st = _store(tmp_path)
    path = tmp_path / GS.site_filename(2)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(CorruptSegment, match="site 2") as e:
        st.get(2)
    assert e.value.fault.kind == "corruption" and e.value.fault.site == 2
    assert (tmp_path / (GS.site_filename(2) + ".quarantine")).exists()
    assert not path.exists() and st.quarantined_sites == 1
    st.close()


def test_a_flipped_byte_fails_the_crc(tmp_path):
    st = _store(tmp_path)
    path = tmp_path / GS.site_filename(1)
    data = bytearray(path.read_bytes())
    info = zipfile.ZipFile(path).getinfo("gamma.npy")
    data[info.header_offset + 200] ^= 0x10         # inside Γ's bytes
    path.write_bytes(bytes(data))
    with pytest.raises(CorruptSegment, match="CRC"):
        st.get_segment(0, 4)
    st.close()


def test_a_payload_with_a_wrong_crc_raises(tmp_path):
    st = _store(tmp_path)
    payload = st.get_segment_raw(1, 2)
    g, lam = GS.decode_segment(payload)
    jg, jl = j_decode(dict(payload, storage_dtype=jnp.bfloat16,
                           compute_dtype=jnp.float64))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(lam.numpy(), jl)
    bad = dict(payload, gamma=payload["gamma"].copy())
    bad["gamma"].reshape(-1)[5] ^= 1
    with pytest.raises(CorruptSegment, match="checksum") as e:
        GS.decode_segment(bad)
    assert e.value.fault.site == 1
    st.close()


def test_the_manifest_catches_a_rewritten_site(tmp_path):
    st = _store(tmp_path)
    st.write_digest_manifest()
    assert st.verify_sites() == []
    with JStore(str(tmp_path)) as js:
        assert js.manifest_leaves() == st.manifest_leaves()
    g, lam = _chain("linear", np.float64)
    st.put(3, torch.from_numpy(g[3] * 2), lam[3])   # valid npz, other bytes
    st.verify = True
    with pytest.raises(CorruptSegment, match="digest"):
        st.get(3)
    assert st.verified_reads == 0
    st.get(0, prefetch_next=False)
    assert st.verified_reads == 1
    st.close()


def test_prefetch_reads_each_site_once(tmp_path):
    st = _store(tmp_path)
    st.prefetch_segment(0, 4)
    for i in range(4):
        st.get(i, prefetch_next=False)
    st.get_segment(0, 2, prefetch_next_segment=False)
    assert st.payload_reads == 6
    assert not st._prefetched and not st._inflight
    per_site = 6 * 6 * 3 * 2 + 6 * 8               # bf16 Γ + fp64 Λ bytes
    assert st.io_bytes == 6 * per_site
    st.close()


def test_write_mps_and_meta(tmp_path):
    jm = JM.random_linear_mps(jax.random.key(0), 3, 4, 2)
    mps = mps_from_arrays(np.asarray(jm.gammas), np.asarray(jm.lambdas),
                          device="cpu")
    with GammaStore(str(tmp_path), torch.float64, torch.float64) as st:
        st.write_mps(mps)
        assert (st.n_sites, st.meta(1)) == (3, (4, 4, 2))
        d0 = st.digest()
        st.put(1, mps.gammas[0], mps.lambdas[0])
        assert st.digest() != d0
    with pytest.raises(ValueError, match="storage dtype"):
        GammaStore(str(tmp_path), storage_dtype=torch.float16)
    assert os.path.exists(tmp_path / GS.site_filename(2))
