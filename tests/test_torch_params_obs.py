"""Port parity of params.py and obs.py against cpr_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu import obs as jobs
from cpr_tpu import params as jparams
from cpr_tpu_torch import convert
from cpr_tpu_torch import obs as tobs
from cpr_tpu_torch import params as tparams

BAD_PARAMS = [
    dict(alpha=float("nan"), gamma=0.5, max_steps=8),
    dict(alpha=0.3, gamma=float("nan"), max_steps=8),
    dict(alpha=0.3, gamma=0.5, activation_delay=float("nan"), max_steps=8),
    dict(alpha=-0.1, gamma=0.5, max_steps=8),
    dict(alpha=1.1, gamma=0.5, max_steps=8),
    dict(alpha=0.3, gamma=-0.1, max_steps=8),
    dict(alpha=0.3, gamma=1.5, max_steps=8),
    dict(alpha=0.3, gamma=0.5, activation_delay=0.0, max_steps=8),
    dict(alpha=0.3, gamma=0.5),
    dict(alpha=0.3, gamma=1.0, max_steps=8),
    dict(alpha=0.3, gamma=0.5, defenders=0, max_steps=8),
    dict(alpha=0.3, gamma=0.5, max_steps=0),
    dict(alpha=0.3, gamma=0.5, max_progress=0.0),
    dict(alpha=0.3, gamma=0.5, max_time=-1.0),
]

GOOD_PARAMS = [
    dict(alpha=0.35, gamma=0.5, max_steps=2016),
    dict(alpha=0.1, gamma=0.9, max_progress=100.0),
    dict(alpha=1.0, gamma=0.0, defenders=7, activation_delay=600.0,
         max_time=3.5),
    dict(alpha=0.333, gamma=0.25, max_steps=5, max_progress=4.0,
         max_time=1e6),
]


@pytest.mark.parametrize("kw", BAD_PARAMS)
def test_make_params_errors(kw):
    with pytest.raises(jparams.ParameterError) as jerr:
        jparams.make_params(**kw)
    with pytest.raises(tparams.ParameterError) as terr:
        tparams.make_params(**kw)
    assert str(terr.value) == str(jerr.value)
    assert issubclass(tparams.ParameterError, ValueError)


def _np(p, fields):
    return {f: np.asarray(getattr(p, f)) for f in fields}


@pytest.mark.parametrize("kw", GOOD_PARAMS)
def test_make_params_values(kw):
    want = _np(jparams.make_params(**kw), tparams.FIELDS)
    got = _np(tparams.make_params(**kw), tparams.FIELDS)
    for f in tparams.FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # float32 alpha/gamma: the Bernoulli comparisons happen in float32
    assert got["alpha"].dtype == np.float32


def test_stack_params_and_numpy_crossing():
    want = jparams.stack_params(GOOD_PARAMS)
    got = tparams.stack_params(GOOD_PARAMS)
    for f in tparams.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
        assert getattr(got, f).shape == (len(GOOD_PARAMS),)
    back = convert.params_from_numpy(_np(want, tparams.FIELDS))
    for f in tparams.FIELDS:
        assert torch.equal(getattr(back, f), getattr(got, f))
    assert back.max_steps.dtype == torch.int32


FIELD_SPECS = [("uint", 1), ("uint", 3), ("int", 1), ("int", 2),
               ("discrete", 1), ("bool", 1)]


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("kind,scale", FIELD_SPECS)
def test_field_encode_decode(kind, scale, unit):
    jf = jobs.Field("x", kind, scale=scale, n=2 if kind != "discrete" else 3)
    tf = tobs.Field("x", kind, scale=scale, n=jf.n)
    rng = np.random.default_rng(0)
    if kind == "uint":
        xs = rng.integers(0, 500, 256)
    elif kind == "int":
        xs = rng.integers(-500, 500, 256)
    elif kind == "discrete":
        xs = rng.integers(0, 3, 256)
    else:
        xs = rng.integers(0, 2, 256)
    xs = xs.astype(np.int32)
    want = np.asarray(jobs.field_to_float(jf, jnp.asarray(xs), unit))
    got = tobs.field_to_float(tf, torch.from_numpy(xs), unit).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dec_want = np.asarray(jobs.field_of_float(jf, jnp.asarray(want), unit))
    dec_got = tobs.field_of_float(tf, torch.from_numpy(want.copy()), unit).numpy()
    np.testing.assert_array_equal(dec_got, dec_want)


@pytest.mark.parametrize("unit", [True, False])
def test_encode_and_low_high(unit):
    from cpr_tpu.envs.nakamoto import OBS_FIELDS as JF
    from cpr_tpu_torch.envs.nakamoto import OBS_FIELDS as TF
    rng = np.random.default_rng(1)
    a, h = (rng.integers(0, 60, 100).astype(np.int32) for _ in range(2))
    ev = rng.integers(0, 2, 100).astype(np.int32)
    vals = (h, a, a - h, ev)
    want = np.asarray(jobs.encode(JF, tuple(map(jnp.asarray, vals)), unit))
    got = tobs.encode(TF, tuple(map(torch.from_numpy, vals)), unit).numpy()
    assert got.shape == (100, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for g, w in zip(tobs.low_high(TF, unit), jobs.low_high(JF, unit)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tobs.encode(TF, vals[:3], unit)


# Unit observations round-trip through 2/pi*atan and round(tan(pi/2 v)).
# Measured on XLA:CPU (jax 0.9.0) and torch's CPU kernels alike: exact for
# non-negative counts below 1763 and signed values of magnitude below 1696;
# the first failures are exactly there. The stream kernels compute the
# scripted policies from the integer (a, h), which equals the reference's
# decode of the observation while a and h stay below 1763.
UINT_EXACT, INT_EXACT = 1763, 1696


def _roundtrip(mod, field, xs, asarr):
    return np.asarray(mod.field_of_float(
        field, mod.field_to_float(field, asarr(xs), True), True)
    ).astype(np.int64)


@pytest.mark.parametrize("kind,bound", [("uint", UINT_EXACT),
                                        ("int", INT_EXACT)])
def test_unit_roundtrip_boundary(kind, bound):
    lo = 0 if kind == "uint" else -bound - 1
    xs = np.arange(lo, bound + 1, dtype=np.int32)
    for mod, asarr in ((jobs, jnp.asarray), (tobs, torch.from_numpy)):
        got = _roundtrip(mod, mod.Field("x", kind), xs, asarr)
        bad = np.abs(xs[got != xs])
        assert bad.min() == bound, (mod.__name__, bad.min())
