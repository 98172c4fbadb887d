"""The port's threefry PRNG is bit-exact with ``jax.random`` (default impl
``threefry2x32``, partitionable), for key / fold_in / split / uniform."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import prng

SEEDS = [0, 1, 2 ** 31 + 5, 2 ** 32 - 1]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    np.testing.assert_array_equal(_data(jax.random.key(1)), [0, 1])


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k, t = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(t.numpy(), _data(k))
    for data in (0, 3, 2 ** 31 - 1):
        np.testing.assert_array_equal(prng.fold_in(t, data).numpy(),
                                      _data(jax.random.fold_in(k, data)))
    # chained fold_in: the macro-batch key folded again per site
    kc, tc = k, t
    for data in (5, 0, 17, 123456):
        kc, tc = jax.random.fold_in(kc, data), prng.fold_in(tc, data)
        np.testing.assert_array_equal(tc.numpy(), _data(kc))
    for num in (1, 2, 7):
        np.testing.assert_array_equal(prng.split(t, num).numpy(),
                                      _data(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 128, 1000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bits(seed, n, dtype):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 2), 9)
    t = prng.fold_in(prng.fold_in(prng.key(seed), 2), 9)
    want = np.asarray(jax.random.uniform(k, (n, 1), dtype=jnp.dtype(dtype)))
    got = prng.uniform(t, (n, 1), dtype=getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
