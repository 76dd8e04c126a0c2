"""The stage-function ops the expression body lowers, against the reference.

Each case of ``tests/test_torch_expr.py`` that takes an op the port
lowers since the rounding, library and index ops (floor ... fmod,
remainder, integer casts, argmax / argmin, pow, rsqrt, sigmoid, erf, sin,
cos) has a jnp twin here: the same arithmetic written with ``jnp`` as a
user of the JAX package writes it, as stage "s" of the same small
pipeline built with the JAX package's DSL and run through its oracle
(``repro.core.algorithms.execute_reference``). The port's plain version
(the eager torch function, which the kernel equals: bit for bit, or 4
ULP for the library functions) must equal it by the oracle comparison of
``tests/test_torch_stencil.py``: bitwise, else 32 ULP at the array's
scale.

Where eager PyTorch and jnp differ, the port follows eager PyTorch (its
plain version); each difference is stated by a test below:

* ``sign``: torch computes ``(0 < x) - (x < 0)``, so sign(NaN) is 0 and
  sign(-0.0) is +0.0; ``jnp.sign`` gives NaN and -0.0;
* a float cast to an integer: eager PyTorch on the CPU gives INT_MIN for
  a NaN and for a value out of range (the x86 conversion; on CUDA a NaN
  gives 0 and the value saturates), ``astype`` in XLA gives 0 for a NaN
  and saturates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as jax_algorithms
from repro.core.dsl import Pipeline as JaxPipeline
from repro_torch.kernels import stencil_pipeline as sp
from test_torch_expr import (CASES, _b, _first, _one, _pos, _v8, case_frames,
                             case_pipeline)
from test_torch_nan import assert_oracle_close


def _argmax_argmin(w):
    a = w["a"]
    flat = jnp.maximum(a, 0.5).reshape(*a.shape[:-2], 9)
    return (jnp.argmax(a, -1).astype(jnp.float32)[..., 1]
            + 3.0 * jnp.argmin(a, -2)[..., 0]
            + 9.0 * jnp.argmax(flat, -1)
            + 81.0 * jnp.argmin(jnp.minimum(a, 0.5), -1,
                                keepdims=True)[..., 2, 0]
            + (jnp.argmax(a, -1)[..., 0] == 2).astype(jnp.float32) * 243
            + jnp.argmin(a, -2).astype(jnp.float32)[..., 1] * 729)


# case -> its jnp twin (the JAX package has no int64 without x64: the
# twin's casts are int32, equal on these values)
TWINS = {
    "rounding": lambda w: (
        jnp.floor(_v8(w)) + 2 * jnp.ceil(_v8(w)) + 4 * jnp.trunc(_v8(w))
        + 8 * jnp.round(_v8(w)) + (_v8(w) - jnp.trunc(_v8(w)))
        + 16 * jnp.sign(_v8(w))
        + jnp.round(jnp.floor(_v8(w) * 2) / 2) * 32
        + jnp.sign(_b(w) - 0.5)),
    "fmod_remainder": lambda w: (
        jnp.fmod(_v8(w), _b(w) + 0.25) + jnp.fmod(_v8(w), 1.5) * 2
        + jnp.remainder(_v8(w), -(_b(w) + 0.25)) * 4
        + jnp.remainder(_v8(w), 1.5) * 8
        + jnp.remainder(_v8(w), -1.5) * 16
        + jnp.remainder(3.0, _b(w) + 0.25) * 32),
    "int_casts": lambda w: (
        _v8(w).astype(jnp.int32).astype(jnp.float32)
        + 2 * _v8(w).astype(jnp.int32).astype(jnp.float32)
        + (_v8(w).astype(jnp.int32)
           == (_b(w) * 4).astype(jnp.int32)).astype(jnp.float32)
        + _v8(w).astype(jnp.int32) * 0.5
        + (_b(w) > 0.5).astype(jnp.int32).astype(jnp.float32) * 4),
    "argmax_argmin": _argmax_argmin,
    "pow_exact": lambda w: (
        _pos(w) ** 2 + _pos(w) ** 3 * 2 + _pos(w) ** -1 * 4
        + _pos(w) ** -2 * 8 + _pos(w) ** 0 * 16 + _pos(w) ** 1 * 32
        + jnp.power(_pos(w), 3.0)),
    "rsqrt_sigmoid_erf_pow": lambda w: (
        jax.lax.rsqrt(_pos(w)) + jax.nn.sigmoid(_v8(w))
        + jax.lax.erf(_v8(w)) + _pos(w) ** 0.5 + _pos(w) ** -0.5
        + _pos(w) ** 1.7 + jnp.power(_pos(w), _one(w)) + 2.0 ** _v8(w)),
    "sin_cos": lambda w: (jnp.sin(_one(w) * 16.0 - 8.0)
                          + jnp.cos(_b(w) * 16.0 - 8.0)),
    "sin_cos_large": lambda w: (jnp.sin(_one(w) * 16384.0 - 8192.0)
                                + jnp.cos(_b(w) * 16384.0 - 8192.0)),
}


def jax_case_pipeline(name, fn, shapes):
    """:func:`test_torch_expr.case_pipeline` in the JAX package: a
    producer stage per window key (key i the input pixel i columns
    away), then stage "s" of ``fn``."""
    p = JaxPipeline(f"case-{name}")
    x = p.input("in")
    reads = []
    for i, (k, (st, sh, sw)) in enumerate(shapes.items()):
        src = p.stage(k, [(x, 1, i + 1)], _first)
        reads.append((src, sh, sw))
    p.output("out", [(p.stage("s", reads, fn), 1, 1)])
    return p.build()


def reference(name, fn, shapes, x):
    dag = jax_case_pipeline(name, fn, shapes)
    run = jax.jit(lambda img: jax_algorithms.execute_reference(
        dag, {"in": img})["out"])
    return np.stack([np.asarray(run(f)) for f in x])


def test_every_new_op_case_has_a_twin():
    assert set(TWINS) <= set(CASES)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_plain_version_equals_the_jnp_twin(name):
    """The case's eager torch function (the plain version) over seeded
    frames at a scalar and a vector width equals its jnp twin through
    the reference's oracle."""
    fn, shapes, _ = CASES[name]
    dag = case_pipeline(name)
    for seed, (h, w) in enumerate([(13, 53), (12, 64)]):
        x, _ = case_frames(dag, 2, h, w, seed)
        got = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
        assert_oracle_close(got.numpy(),
                            reference(name, TWINS[name], shapes, x))


SIGN_SHAPES = {"a": (1, 1, 1)}


def test_sign_of_nan_and_of_negative_zero_differ_from_the_reference():
    """torch.sign(NaN) is 0 and torch.sign(-0.0) is +0.0, where jnp.sign
    gives NaN and -0.0; elsewhere the two agree."""
    dag = case_pipeline("sign", lambda w: torch.sign(_one(w) - 0.5),
                        SIGN_SHAPES)
    x, _ = case_frames(dag, 1, 13, 53, 3)
    x.reshape(-1)[::11] = np.nan
    x.reshape(-1)[5::11] = 0.5                     # 0.5 - 0.5 = +0.0
    got = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
    got = got.numpy()
    exp = reference("sign", lambda w: jnp.sign(_one(w) - 0.5), SIGN_SHAPES,
                    x)
    nan = np.isnan(exp)
    assert nan.any() and not np.isnan(got).any()
    assert (got[nan] == 0).all()
    np.testing.assert_array_equal(got[~nan], exp[~nan])
    # -0.0 itself (no frame above gives one: 0.5 - 0.5 is +0.0)
    t = torch.sign(torch.tensor([-0.0]))
    j = np.asarray(jnp.sign(jnp.array([-0.0], jnp.float32)))
    assert t.numpy().view(np.int32)[0] == 0
    assert j.view(np.int32)[0] == np.float32(-0.0).view(np.int32)


def test_integer_casts_of_nan_and_out_of_range_differ_from_the_reference():
    """A float cast to int32: eager PyTorch on the CPU gives INT_MIN for a
    NaN and for values out of range, XLA gives 0 for a NaN and
    saturates; in range both truncate."""
    fn = (lambda w: (_one(w) * 8.0 - 4.0).int().float())
    dag = case_pipeline("cast", fn, SIGN_SHAPES)
    x, _ = case_frames(dag, 1, 13, 53, 4)
    x.reshape(-1)[::11] = np.nan
    x.reshape(-1)[3::11] = 5e8                     # 8 x 5e8 - 4 > 2^31
    got = sp.stencil_pipeline_plain(dag, {"in": torch.from_numpy(x)})
    got = got.numpy()
    exp = reference("cast", lambda w: (_one(w) * 8.0 - 4.0).astype(
        jnp.int32).astype(jnp.float32), SIGN_SHAPES, x)
    first = case_pipeline("first", _first, SIGN_SHAPES)
    pix = sp.stencil_pipeline_plain(first, {"in": torch.from_numpy(x)})
    pix = pix.numpy()
    nan, big = np.isnan(pix), pix == np.float32(5e8)
    assert nan.any() and big.any()
    assert (got[nan | big] == np.float32(-2 ** 31)).all()
    assert (exp[nan] == 0).all() and (exp[big] == np.float32(2 ** 31)).all()
    rest = ~(nan | big)
    np.testing.assert_array_equal(got[rest], exp[rest])
