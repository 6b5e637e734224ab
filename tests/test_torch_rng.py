"""The port's threefry RNG against jax.random: bit-exact.

Every random decision of a render goes through these functions, so a
single differing bit would send a pixel down another path.  Keys, ids,
bounces and decisions come from numpy.random.default_rng."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingrenderer_tpu.sampling import rng as jrng
from raytracingrenderer_tpu_torch.sampling import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -5]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _tuple(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert trng.PRNGKey(seed) == _tuple(_jkey(seed))


def test_threefry_matches_jax():
    from jax.extend.random import threefry_2x32
    g = np.random.default_rng(0)
    for _ in range(8):
        key = g.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x = g.integers(0, 2**32, 2 * 513, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(x)))
        y0, y1 = trng.threefry2x32(
            (int(key[0]), int(key[1])),
            torch.from_numpy(x[:513].astype(np.int64)),
            torch.from_numpy(x[513:].astype(np.int64)))
        got = np.concatenate([y0.numpy(), y1.numpy()]).astype(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_fold_in_spp_and_decision_keys():
    g = np.random.default_rng(1)
    for seed in SEEDS:
        jk, tk = _jkey(seed), trng.PRNGKey(seed)
        for data in g.integers(0, 2**32, 6, dtype=np.uint64):
            assert trng.fold_in(tk, int(data)) == _tuple(
                jax.random.fold_in(jk, np.uint32(data)))
        for s in (0, 1, 31, 1000):
            js, ts = jrng.spp_key(jk, s), trng.spp_key(tk, s)
            assert ts == _tuple(js)
            for bounce in (0, 3, 5):
                for dec in (0, jrng.RR, jrng.LIGHT_AUX, 15):
                    assert trng.decision_key(ts, bounce, dec) == _tuple(
                        jrng.decision_key(js, bounce, dec))


@pytest.mark.parametrize("shape", [(1,), (777,), (4096,), (3, 5)])
def test_uniform_bit_exact(shape):
    for seed in (0, 12345):
        for s in (0, 6):
            jk = jrng.spp_key(_jkey(seed), s)
            tk = trng.spp_key(trng.PRNGKey(seed), s)
            for bounce, dec in ((0, jrng.PIXEL_JITTER_X),
                                (0, jrng.PIXEL_JITTER_Y), (4, 9)):
                want = np.asarray(jrng.uniform(jk, bounce, dec, shape))
                got = trng.uniform(tk, bounce, dec, shape).numpy()
                assert got.dtype == np.float32 and got.shape == shape
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))


def test_uniform_ids_bit_exact():
    g = np.random.default_rng(2)
    ids = np.concatenate([
        np.arange(1024, dtype=np.uint32),
        g.integers(0, 2**32, 1001, dtype=np.uint64).astype(np.uint32)])
    for seed in (0, 3, 2**31 - 1):
        for s in (0, 5):
            jk = jrng.spp_key(_jkey(seed), s)
            tk = trng.spp_key(trng.PRNGKey(seed), s)
            for bounce in range(6):
                for dec in range(jrng._NUM_DECISIONS):
                    want = np.asarray(jrng.uniform_ids(jk, bounce, dec,
                                                       jnp.asarray(ids)))
                    got = trng.uniform_ids(
                        tk, bounce, dec,
                        torch.from_numpy(ids.astype(np.int64))).numpy()
                    np.testing.assert_array_equal(got.view(np.uint32),
                                                  want.view(np.uint32))
                    assert (got >= 0.0).all() and (got < 1.0).all()


def test_decision_ids_match():
    names = [n for n in dir(jrng) if n.isupper()]
    assert names
    for n in names:
        assert getattr(trng, n) == getattr(jrng, n), n
