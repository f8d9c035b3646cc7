"""K1 plain twin: the port's threefry against `jax.random` on the CPU.

Keys, splits, fold_in, bits and uniform draws must be bit-identical;
exponential draws go through log1p, whose float32 result may differ from
XLA's by a couple of ULP.
"""

import jax
import numpy as np
import pytest
import torch

from cpr_tpu_torch import kernels
from cpr_tpu_torch import random as rnd


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def tkey(seed):
    return rnd.PRNGKey(seed, device="cpu")


def words(t):
    return rnd.to_numpy_words(t) if t.dtype == torch.int32 else t.numpy()


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**32 - 1, 2**32 + 7,
                                  2**40 + 3, -1, -5])
def test_prngkey(seed):
    np.testing.assert_array_equal(words(tkey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [2, 4, 131])
def test_split(n):
    for seed in (0, 3, 2**32 - 1):
        np.testing.assert_array_equal(
            words(rnd.split(tkey(seed), n)),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)))
    # a batch of keys splits like vmap(split)
    jk = jax.random.split(jax.random.PRNGKey(9), 5)
    np.testing.assert_array_equal(
        words(rnd.split(rnd.split(tkey(9), 5), n)),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(jk)))


@pytest.mark.parametrize("data", [0, 1, 7, 2**31, 2**32 - 1])
def test_fold_in(data):
    np.testing.assert_array_equal(
        words(rnd.fold_in(tkey(4), data)),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(4), data)))


def test_scalar_and_batched_draws():
    jk = jax.random.split(jax.random.PRNGKey(0), 50)
    tk = rnd.split(tkey(0), 50)
    for jf, tf in ((jax.random.bits, rnd.bits),
                   (jax.random.uniform, rnd.uniform)):
        np.testing.assert_array_equal(words(tf(tk)),
                                      np.asarray(jax.vmap(jf)(jk)))
        np.testing.assert_array_equal(
            words(tf(tk, (3, 4))),
            np.asarray(jax.vmap(lambda k: jf(k, (3, 4)))(jk)))
        np.testing.assert_array_equal(
            words(tf(tkey(1), (300,))),
            np.asarray(jf(jax.random.PRNGKey(1), (300,))))
    e = rnd.exponential(tk, (3, 4)).numpy()
    ej = np.asarray(jax.vmap(lambda k: jax.random.exponential(k, (3, 4)))(jk))
    assert e.dtype == np.float32 and e.shape == ej.shape
    assert ulps(e, ej) <= 2
    assert ulps(rnd.exponential(tk).numpy(),
                jax.vmap(jax.random.exponential)(jk)) <= 2


def test_plain_modes_agree_with_public_surface():
    k = tkey(5)
    bits = rnd.threefry_plain(k, 8, 0, rnd.MODE_BITS)
    np.testing.assert_array_equal(
        rnd.threefry_plain(k, 8, 0, rnd.MODE_UNIFORM).numpy(),
        rnd.uniform_of_bits(bits).numpy())
    assert torch.equal(rnd.bits(k, (8,)), bits)
    assert (rnd.uniform(k, (1000,)) < 1).all()
    assert (rnd.uniform(k, (1000,)) >= 0).all()


def test_cpu_keys_never_launch_the_kernel():
    before = dict(kernels.launches)
    rnd.split(tkey(0), 8)
    rnd.uniform(tkey(0), (4,))
    assert kernels.launches == before


def test_key_validation():
    with pytest.raises(ValueError, match="int32"):
        rnd.split(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        rnd.split(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threefry(torch.zeros((1, 2), dtype=torch.int32), 2, 0, 0)


def test_numpy_word_roundtrip():
    w = np.array([[0, 2**32 - 1], [2**31, 7]], dtype=np.uint32)
    t = rnd.from_numpy_words(w, device="cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(rnd.to_numpy_words(t), w)


@pytest.mark.parametrize("seed", [0, 9, -3, 2**40 + 11])
def test_float64_draws_match_jax_x64(seed):
    """The netsim's 64-bit mode: keys of int64 seeds, float64 uniform
    draws bit for bit (the top 52 bits of (x0 << 32) | x1), exponential
    through log1p within a few ULP."""
    with jax.enable_x64(True):
        jk = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(jk, (7, 33), dtype=jax.numpy.float64))
        uc = np.asarray(jax.random.uniform(jk, (40,), minval=1e-12,
                                           maxval=1.0,
                                           dtype=jax.numpy.float64))
        e = np.asarray(jax.random.exponential(jk, (300,),
                                              dtype=jax.numpy.float64))
        ks = np.asarray(jax.random.split(jk, 3))
    tk = rnd.PRNGKey(seed, device="cpu", x64=True)
    np.testing.assert_array_equal(words(tk), np.asarray(jk))
    np.testing.assert_array_equal(words(rnd.split(tk, 3)), ks)
    got = rnd.uniform(tk, (7, 33), dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), u)
    np.testing.assert_array_equal(
        rnd.uniform(tk, (40,), 1e-12, 1.0, dtype=torch.float64).numpy(), uc)
    np.testing.assert_allclose(
        rnd.exponential(tk, (300,), dtype=torch.float64).numpy(), e,
        rtol=1e-13, atol=0)
    plain = rnd.threefry_plain(tk, 300, 0, rnd.MODE_EXPONENTIAL64)
    np.testing.assert_array_equal(
        plain.numpy(), rnd.exponential(tk, (300,), dtype=torch.float64).numpy())
