"""The port's Threefry-2x32 (`repro_torch.core.prng`) against `jax.random`.

Keys are compared as their two uint32 words and draws as float32 bits:
all bitwise, at jax's defaults (64-bit types off, partitionable
Threefry).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 1, 5, 61, 2 ** 31 - 1)
ROWS = (1, 30, 100, 101, 2400)


def words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  words(jax.random.PRNGKey(seed)))


def test_prng_key_batched_and_traced_int32_plus_one():
    """The fleet keys by ``PRNGKey(int32(seed) + 1)`` inside `jit`; at
    2³¹−1 the int32 sum wraps."""
    traced = jax.jit(lambda s: jax.random.PRNGKey(
        jnp.asarray(s, jnp.int32) + 1))
    want = np.stack([words(traced(s)) for s in SEEDS])
    np.testing.assert_array_equal(
        prng.prng_key([s + 1 for s in SEEDS]).numpy(), want)


@pytest.mark.parametrize("n", (2, 4, 16))
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, n):
    got = prng.split(prng.prng_key(seed), n).numpy()
    np.testing.assert_array_equal(
        got, words(jax.random.split(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    data = np.array([0, 1, 2, 99, 150, 899, 4096, 65535, 69999, 70000])
    key = jax.random.PRNGKey(seed)
    want = np.stack([words(jax.random.fold_in(key, int(d))) for d in data])
    got = prng.fold_in(prng.prng_key(seed), torch.as_tensor(data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_in_over_a_whole_range_of_events():
    """Every event index a phase or month can take, batched over keys."""
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    data = np.arange(0, 70001, 7)
    want = np.asarray(jax.vmap(lambda k: jax.vmap(
        lambda d: jax.random.fold_in(k, d))(data))(keys)).astype(np.int64)
    got = prng.fold_in(torch.as_tensor(np.array(keys), dtype=torch.int64)
                       [:, None], torch.as_tensor(data)[None, :])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, R):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.uniform(key, (R,)))
    got = prng.uniform(prng.fold_in(prng.prng_key(seed), 3), R).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_a_longer_draw_starts_with_the_shorter_one():
    keys = prng.split(prng.prng_key(5), 4)
    long = prng.uniform(keys, 2400)
    for R in ROWS:
        assert torch.equal(long[..., :R], prng.uniform(keys, R))


def test_batched_uniform_equals_one_key_at_a_time():
    """The MC's [E, N, R] pass against jax, key by key."""
    keys = prng.fold_in(prng.split(prng.prng_key(11), 3)[None],
                        torch.arange(5)[:, None])              # [5, 3, 2]
    got = prng.uniform(keys, 30).numpy()
    for idx in np.ndindex(5, 3):
        k = jax.random.wrap_key_data(
            jnp.asarray(keys[idx].numpy().astype(np.uint32)))
        assert got[idx].tobytes() == \
            np.asarray(jax.random.uniform(k, (30,))).tobytes()
