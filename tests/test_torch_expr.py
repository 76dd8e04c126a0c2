"""Stage functions lowered (core/expr.py) and compiled into the kernel.

Each case is a torch window function. It must lower
(``expr.lower_stage``); its instructions run in torch
(:func:`run_instructions`, the lowering alone) must equal the function;
and, as stage "s" of a small pipeline (:func:`case_pipeline`), its
generated body (``kernels/expr_codegen.py``) compiled into the kernel
for the host under the shim of ``tests/test_torch_kernel_host.py`` must
equal the function run eagerly (the plain version) on seeded frames. Equal means bit for bit, or within
4 ULP at the array's scale for sums and means (eager PyTorch adds in its
own order), exp, log and tanh (libraries differ in the last place) and a
float32 ``torch.sqrt`` (the CPU's eager root is not always correctly
rounded). Every aten op that lowers and every instruction (each a rule
of the generator) is covered by some case; ``tests/test_torch_cuda.py`` runs the same
cases on the card. Then every refusal: an op that does not lower, an op
that mixes pixels, value-dependent control flow, float64 and integer
values, more windows, registers, instructions or constants than the
kernel takes, each a ValueError that names the pipeline, the stage and,
where there is one, the op. The bare forms of the registered pipelines
lower every stage.
"""
import operator
import sys
import threading

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core import algorithms, expr
from repro_torch.core.dag import Edge, window_keys
from repro_torch.core.dsl import Pipeline
from repro_torch.imaging import PlanCache
from repro_torch.kernels import _build, expr_codegen
from repro_torch.kernels import stencil_pipeline as sp
from test_torch_kernel_host import generic_pipeline
from test_torch_kernel_host import host_kernel  # noqa: F401  (fixture)

aten = torch.ops.aten
W3 = torch.tensor(np.random.RandomState(1).randn(3, 3).astype(np.float32))
MASK = torch.tensor([[True, False, True]])


def _one(w):
    return w["a"][..., 0, 0]


def _b(w):
    return w["b"][..., 0, 0]


# name -> (fn, {key: (st, sh, sw)}, bounded)
CASES = {
    "arith": (lambda w: _one(w) + _b(w) - _one(w) * _b(w)
              / (_b(w) + 2.0), {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "scalars": (lambda w: aten.div.Scalar(aten.mul.Scalar(aten.sub.Scalar(
        aten.add.Scalar(_one(w), 0.3), 0.1), 3), 7.0) + (1.0 - _b(w))
        + torch.rsub(_one(w), _b(w)) + _one(w) * 0.7 - 2 / (_b(w) + 3),
        {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "unary": (lambda w: torch.sqrt(torch.abs(-_one(w))) + _one(w) ** 2
              + _b(w) ** 1, {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "min_max_clamp": (lambda w: torch.maximum(_one(w), _b(w))
                      - torch.minimum(_one(w), _b(w))
                      + _one(w).clamp(0.2, 0.7) + _one(w).clamp(max=0.4)
                      + torch.clamp(_b(w), _one(w) * 0.5, _one(w))
                      + torch.clamp_min(_b(w), 0.5)
                      + torch.clamp_max(_b(w), 0.5)
                      + aten.clamp_min.Tensor(_b(w), _one(w))
                      + aten.clamp_max.Tensor(_b(w), _one(w)),
                      {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "compare_where": (lambda w: torch.where(_one(w) < _b(w), _one(w), 0.5)
                      + torch.where(_one(w) <= 0.5, 1.0, _b(w))
                      + torch.where(_one(w) > 0.1, 2.0, 3.0)
                      + torch.where(_one(w) >= _b(w), _one(w), _b(w))
                      + (_one(w) == _one(w)).float() + (_b(w) != 0.25)
                      + aten.lt.Scalar(_b(w), 0.5)
                      + aten.le.Tensor(_b(w), _one(w))
                      + aten.gt.Tensor(_b(w), _one(w))
                      + aten.ge.Scalar(_b(w), 0.5)
                      + aten.eq.Scalar(_b(w), 0.5)
                      + aten.ne.Tensor(_b(w), _one(w)),
                      {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "logic": (lambda w: torch.where(
        ((_one(w) > 0.3) & (_b(w) < 0.6)) | ~(_one(w) > 0.8)
        | torch.logical_and(_one(w) > 0.5, torch.logical_not(_b(w) > 0.5))
        | torch.logical_or(_one(w) < 0.1, _b(w) < 0.1)
        | _one(w).bool(), _one(w), -_b(w)),
        {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "reduce_exact": (lambda w: w["a"].amax((-2, -1)) - w["a"].amin(-1)[
        ..., 1] + w["a"].max(-2).values[..., 2]
        + w["a"].min(dim=-1, keepdim=True).values[..., 0, 0]
        + w["a"].amax(-1, keepdim=True)[..., 2, 0],
        {"a": (1, 3, 3)}, False),
    "reduce_sum": (lambda w: w["a"].sum((-2, -1)) - w["a"].mean(-1)[..., 0]
                   + w["a"].sum(-2, keepdim=True)[..., 0, 1],
                   {"a": (1, 3, 4)}, True),
    "transcendental": (lambda w: torch.exp(_one(w)) + torch.log(_b(w) + 0.5)
                       + torch.tanh(_one(w) - _b(w)),
                       {"a": (1, 1, 1), "b": (1, 1, 1)}, True),
    "views": (lambda w: w["a"][..., 1:, ::2].amax((-2, -1))
              + w["a"].unsqueeze(-1)[..., 0, 1, 0]
              + w["a"][..., :1, :].squeeze(-2)[..., 1]
              + w["a"][..., :1, :1].squeeze()
              + w["a"].reshape(*w["a"].shape[:-2], -1)[..., 4]
              + w["a"].flatten(-2)[..., 5]
              + w["a"].permute(*range(w["a"].dim() - 2), -1, -2)[..., 0, 2]
              + w["a"].transpose(-2, -1)[..., 1, 0]
              + w["a"][..., :1, :].expand(*w["a"].shape[:-2], 2, 3)[
                  ..., 1, 2]
              + w["a"].unbind(-1)[2][..., 1]
              + torch.cat([w["a"], w["a"][..., :1, :]], -2)[..., 3, 1]
              + torch.stack([w["a"][..., 0, 0], w["a"][..., 2, 2]],
                            -1)[..., 1]
              + w["a"].clone().detach().contiguous()[..., 1, 1]
              + w["a"].transpose(-2, -1).reshape(*w["a"].shape[:-2], 9)[
                  ..., 7]
              + w["a"][..., :1, :1].squeeze((-2, -1))
              + aten.alias(w["a"])[..., 2, 0],
              {"a": (1, 3, 3)}, False),
    # the captured tensors follow the windows to their device, as a
    # function that also runs eagerly on the card must
    "constants": (lambda w: (w["a"] * W3.to(w["a"].device)).amax((-2, -1))
                  + torch.where(MASK.to(w["a"].device), w["a"][..., 1:2, :],
                                0.0).amin((-2, -1))
                  + torch.full((), 0.25) + torch.zeros(3)[1]
                  + (torch.tensor([0.5, 1.5]).to(w["a"].device)
                     * w["a"][..., 0, :2]).sum(-1)
                  + torch.ones(1, 1)[0, 0] + torch.full_like(_one(w), 2.0)
                  + torch.zeros_like(_one(w)) * _one(w)
                  + torch.ones_like(_one(w)),
                  {"a": (1, 3, 3)}, False),
    "float64_root": (lambda w: torch.sqrt(
        (_one(w) * 3.0).to(torch.float64)).to(torch.float32)
        + _b(w).double().float(), {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "temporal": (lambda w: w["a"][..., -1, 0, 0] - 0.5 * w["a"][..., 0, 0, 0]
                 + w["a"].select(-3, 1)[..., 0, 0] * w["b"][..., 2, 1, 0]
                 - w["b"].amax((-3, -2, -1)),
                 {"a": (3, 1, 1), "b": (4, 2, 1)}, False),
    "temporal_mean": (lambda w: w["a"].mean((-3, -2, -1)),
                      {"a": (4, 2, 2)}, True),
    "constant_result": (lambda w: torch.zeros_like(_one(w)) + 0.5,
                        {"a": (1, 1, 1)}, False),
    # a result that is a constant itself: one copy instruction
    "constant_copy": (lambda w: torch.full_like(_one(w), 0.25),
                      {"a": (1, 1, 1)}, False),
    # rounding to integers, exact everywhere: values in [-4, 4) (a 0.5
    # pixel gives 0) and exact halves for round's ties to even
    "rounding": (lambda w: torch.floor(_v8(w)) + 2 * torch.ceil(_v8(w))
                 + 4 * torch.trunc(_v8(w)) + 8 * torch.round(_v8(w))
                 + torch.frac(_v8(w)) + 16 * torch.sign(_v8(w))
                 + torch.round(torch.floor(_v8(w) * 2) / 2) * 32
                 + torch.sgn(_b(w) - 0.5),
                 {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    "fmod_remainder": (lambda w: torch.fmod(_v8(w), _b(w) + 0.25)
                       + torch.fmod(_v8(w), 1.5) * 2
                       + torch.remainder(_v8(w), -(_b(w) + 0.25)) * 4
                       + (_v8(w) % 1.5) * 8 + torch.remainder(_v8(w), -1.5)
                       * 16 + (3.0 % (_b(w) + 0.25)) * 32,
                       {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    # float -> int -> float (a truncation) and integers compared or read
    # as float32
    "int_casts": (lambda w: _v8(w).to(torch.int32).float()
                  + 2 * _v8(w).long().float()
                  + (_v8(w).int() == _b(w).mul(4).int()).float()
                  + _v8(w).int() * 0.5 + (_b(w) > 0.5).int().float() * 4,
                  {"a": (1, 1, 1), "b": (1, 1, 1)}, False),
    # window indices as float32: the first index on a tie (a window of
    # 0.5 floors ties often), a NaN's index (test_max_and_min_pass_a_nan_on)
    "argmax_argmin": (lambda w: w["a"].argmax(-1).float()[..., 1]
                      + 3.0 * w["a"].argmin(-2)[..., 0]
                      + 9.0 * torch.maximum(w["a"], torch.tensor(0.5))
                      .flatten(-2).argmax(-1)
                      + 81.0 * torch.minimum(w["a"], torch.tensor(0.5))
                      .argmin(-1, keepdim=True)[..., 2, 0]
                      + (w["a"].max(-1).indices[..., 0] == 2).float() * 243
                      + w["a"].min(dim=-2).indices.float()[..., 1] * 729,
                      {"a": (1, 3, 3)}, False),
    # exponents eager PyTorch multiplies or divides for: exact
    "pow_exact": (lambda w: _pos(w) ** 2 + _pos(w) ** 3 * 2
                  + _pos(w) ** -1 * 4 + _pos(w) ** -2 * 8
                  + _pos(w) ** 0 * 16 + _pos(w) ** 1 * 32
                  + torch.pow(_pos(w), 3.0), {"b": (1, 1, 1)}, False),
    # the libraries' functions (4 ULP): rsqrt, sigmoid, erf, powf (an
    # exponent of 0.5 is eager's sqrt: the CPU's root is not always
    # correctly rounded)
    "rsqrt_sigmoid_erf_pow": (lambda w: torch.rsqrt(_pos(w))
                              + torch.sigmoid(_v8(w)) + torch.erf(_v8(w))
                              + _pos(w) ** 0.5 + _pos(w) ** -0.5
                              + _pos(w) ** 1.7 + torch.pow(_pos(w), _one(w))
                              + 2.0 ** _v8(w),
                              {"a": (1, 1, 1), "b": (1, 1, 1)}, True),
    # sin and cos over [-8, 8): the bound's argument range (a power-of-two
    # scale, so every library sees the same argument)
    "sin_cos": (lambda w: torch.sin(_one(w) * 16.0 - 8.0)
                + torch.cos(_b(w) * 16.0 - 8.0),
                {"a": (1, 1, 1), "b": (1, 1, 1)}, True),
    # and over [-8192, 8192): the libraries' argument reduction
    "sin_cos_large": (lambda w: torch.sin(_one(w) * 16384.0 - 8192.0)
                      + torch.cos(_b(w) * 16384.0 - 8192.0),
                      {"a": (1, 1, 1), "b": (1, 1, 1)}, True),
}


def _v8(w):
    """The pixel of window "a" mapped onto [-4, 4)."""
    return _one(w) * 8.0 - 4.0


def _pos(w):
    """The pixel of window "b" mapped onto [0.25, 1.25)."""
    return _b(w) + 0.25
# cases that divide by a number (a Python scalar): eager PyTorch on CUDA
# multiplies by its float32 reciprocal, the kernel divides (within 1 ULP
# of the quotient, core/expr.py)
DIVIDES_BY_A_NUMBER = {"scalars"}
# cases with a float32 torch.sqrt: eager PyTorch on the CPU does not
# always round it correctly (1 ULP off for about 0.6% of inputs on an
# AVX-512 build); the kernel's root is correctly rounded, as eager CUDA's
CPU_SQRT = {"unary"}


def _edges(shapes):
    return [Edge(producer=k, consumer="s", st=st, sh=sh, sw=sw)
            for k, (st, sh, sw) in shapes.items()]


def _first(w):
    (win,) = w.values()
    return win[..., 0, 0]


def case_pipeline(name, fn=None, shapes=None):
    """Case ``name`` (or ``fn`` over windows ``shapes``) as stage "s" of
    a pipeline over one input "in": a producer stage per window key, key i
    the input pixel i columns away (element 0 of a 1 x (i + 1) window), so
    the keys hold different pixels; a temporal window reads its producer's
    frame ring."""
    if fn is None:
        fn, shapes, _ = CASES[name]
    p = Pipeline(f"case-{name}")
    x = p.input("in")
    reads = []
    for i, (k, (st, sh, sw)) in enumerate(shapes.items()):
        src = p.stage(k, [(x, 1, i + 1)], _first)
        reads.append((src, st, sh, sw) if st > 1 else (src, sh, sw))
    p.output("out", [(p.stage("s", reads, fn), 1, 1)])
    return p.build()


def case_frames(dag, b, h, w, seed):
    """(frames, frame-ring states) for ``dag``: seeded, every 7th pixel
    0.5 (ties with the cases' constants)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w).astype(np.float32)
    x.reshape(-1)[::7] = 0.5
    depths = dag.temporal_depths()
    states = [rng.rand(depths[p] - 1, h, w).astype(np.float32)
              for p in sorted(depths, key=dag.topo_order.index)]
    return x, states


def case_plain(dag, prog, x, states):
    """The plain version (the eager functions) over ``x`` and
    ``states``, torch tensors on one device."""
    inputs = {"in": x}
    out, _ = sp.video_pipeline_plain(dag, {
        **inputs, **sp.tap_feeds(dag, inputs, dict(zip(prog.states, states)),
                                 x.shape[0])})
    return out


# (rows per step, prefetch depth) of the case runs
CASE_STEPS = [(1, 1), (8, 1), (3, 2)]


def _windows(shapes, seed):
    rng = np.random.RandomState(seed)
    wins = {}
    for k, (st, sh, sw) in shapes.items():
        shape = (4, 5) + ((st,) if st > 1 else ()) + (sh, sw)
        a = rng.rand(*shape).astype(np.float32)
        a.flat[::7] = 0.5                  # ties with the constants
        wins[k] = torch.from_numpy(a)
    return wins


def run_instructions(ex: expr.StageExpr, wins) -> torch.Tensor:
    """``ex``'s instructions run in torch, elementwise over whole windows,
    one rounding per instruction: a check of the lowering alone (the
    instruction list against the function it came from) that needs no
    compiler. Its library functions (exp, log, tanh, rsqrt, sin, cos, erf,
    pow) are torch's own, so the kernel's case bodies are checked by the
    kernel tests, not here. ``wins`` maps
    window keys to (..., [st,] sh, sw) float32 tensors in the order of
    ``ex.operands``."""
    w = list(wins.values())
    consts = [torch.tensor(c, dtype=torch.float32) for c in ex.consts]
    regs: dict[int, torch.Tensor] = {}

    def src(x):
        return regs[int(x)] if x >= 0 else consts[~int(x)]

    def flag(b):
        return b.to(torch.float32)
    binary = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
              "div": torch.div, "max": torch.maximum, "min": torch.minimum,
              "lt": lambda a, b: flag(a < b), "le": lambda a, b: flag(a <= b),
              "gt": lambda a, b: flag(a > b), "ge": lambda a, b: flag(a >= b),
              "eq": lambda a, b: flag(a == b), "ne": lambda a, b: flag(a != b),
              "and": lambda a, b: flag((a != 0) & (b != 0)),
              "or": lambda a, b: flag((a != 0) | (b != 0))}
    binary.update({
        "fmod": torch.fmod, "pow": torch.pow,
        "take_max": lambda a, b: flag((a > b) | (a.isnan() & ~b.isnan())),
        "take_min": lambda a, b: flag((a < b) | (a.isnan() & ~b.isnan()))})
    unary = {"copy": lambda a: a, "neg": torch.neg, "abs": torch.abs,
             # float64 gives the correctly rounded root, as __fsqrt_rn
             "sqrt": lambda a: torch.sqrt(a.double()).float(),
             "exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
             "not": lambda a: flag(a == 0), "floor": torch.floor,
             "ceil": torch.ceil, "trunc": torch.trunc, "round": torch.round,
             "rsqrt": torch.rsqrt, "sin": torch.sin, "cos": torch.cos,
             "erf": torch.erf,
             "toi32": lambda a: a.to(torch.int32).float(),
             "toi64": lambda a: a.to(torch.int64).float()}
    for word, a, b, c in ex.code.tolist():
        op, dst = expr.XOPS[word & 255], word >> 8
        if op == "load":
            j, dt = a & 255, a >> 8
            st = ex.operands[j][1]
            v = w[j][..., dt, b, c] if st > 1 else w[j][..., b, c]
        elif op == "where":
            v = torch.where(src(a) != 0, src(b), src(c))
        elif op in unary:
            v = unary[op](src(a))
        else:
            v = binary[op](src(a), src(b))
        regs[dst] = v
    return regs[int(ex.code[-1, 0]) >> 8]


def _traced_ops(fn, shapes) -> set:
    keys = list(shapes)
    args = [torch.zeros((2, 3) + ((st,) if st > 1 else ()) + (sh, sw))
            for st, sh, sw in shapes.values()]
    gm = make_fx(lambda *xs: fn(dict(zip(keys, xs))), tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*args)
    return {n.target for n in gm.graph.nodes if n.op == "call_function"
            and n.target is not operator.getitem}


def assert_bounded(got, exp, ulp=4):
    got, exp = got.numpy(), exp.numpy()
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=0,
                               atol=ulp * np.spacing(np.abs(exp).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_lowered_instructions_equal_the_eager_function(host_kernel, name):
    """The case through the expression body under the host shim, at a
    scalar and a vector width, R = 1, 3, 8, depths 1 and 2 (the grown
    slots poisoned), batches of 2 (1 for a temporal window on a computed
    stage), equals the eager function."""
    fn, shapes, bounded = CASES[name]
    ex = expr.lower_stage("p", "s", fn, _edges(shapes))
    assert ex.code.dtype == np.int32 and ex.code.shape[1] == 4
    assert 0 < ex.n_regs <= expr.MAX_REGS
    dag = case_pipeline(name)
    b = 1 if dag.temporal_depths() else 2
    for seed, (h, w) in enumerate([(13, 53), (12, 1920)]):
        x, states = case_frames(dag, b, h, w, seed)
        for r, depth in CASE_STEPS:
            prog = sp.build_program(dag, h, w, r, frames=b, target_ctas=64,
                                    prefetch_depth=depth,
                                    poison_prefetch=depth > 1)
            assert set(prog.exprs) == {n for n, st in dag.stages.items()
                                       if st.fn is not None}
            got = host_kernel(prog, x, states)
            got = torch.from_numpy(got[0] if prog.frame_outs else got)
            exp = case_plain(dag, prog, torch.from_numpy(x),
                             [torch.from_numpy(a) for a in states])
            where = (name, (h, w), r, depth)
            if bounded or name in CPU_SQRT:
                assert_bounded(got, exp)
            else:
                assert torch.equal(got, exp), where


@pytest.mark.parametrize("name", sorted(CASES))
def test_instruction_list_equals_the_eager_function(name):
    """The lowering alone: the case's instructions run in torch over
    seeded windows equal the eager function."""
    fn, shapes, bounded = CASES[name]
    ex = expr.lower_stage("p", "s", fn, _edges(shapes))
    for seed in range(3):
        wins = _windows(shapes, seed)
        exp = fn(wins)
        got = run_instructions(ex, wins)
        assert got.dtype == torch.float32
        if bounded or name in CPU_SQRT:
            assert_bounded(got.expand_as(exp), exp)
        else:
            assert torch.equal(got.expand_as(exp), exp), name


def test_every_instruction_is_covered():
    """The cases use every instruction, so each rule of the generator
    runs in the tests above and on the card."""
    used = set()
    for fn, shapes, _ in CASES.values():
        ex = expr.lower_stage("p", "s", fn, _edges(shapes))
        used |= {expr.XOPS[w & 255] for w in ex.code[:, 0]}
    assert used == set(expr.XOPS), sorted(set(expr.XOPS) - used)


def _all_ops(w):
    """Every instruction but a constant's copy in one stage function."""
    u, v = _one(w), _b(w)
    keep = ((u < v) & (u <= 0.75)) | ~(u == v) & (v != 0.5) \
        | (u * v > 0.25) & (u >= 0.5) | ~(u > 0.9)
    exact = torch.where(keep, -(u / (v + 1.0)), torch.abs(u - v)) \
        + torch.maximum(u, v) - torch.minimum(u, v) \
        + torch.sqrt((u + 1.0).to(torch.float64)).to(torch.float32)
    x8, pair = u * 8.0 - 4.0, torch.stack([u, v], -1)
    exact = exact + torch.floor(x8) + torch.ceil(x8) + torch.trunc(x8) \
        + torch.round(x8) + torch.fmod(x8, v + 0.25) \
        + pair.argmax(-1) + pair.argmin(-1) * 2.0 \
        + x8.int().float() + x8.long().float()
    return exact + torch.exp(u) + torch.log(v + 0.5) + torch.tanh(u - v) \
        + torch.rsqrt(v + 0.25) + torch.sin(x8) + torch.cos(x8) \
        + torch.erf(x8) + (v + 0.25) ** 1.7


def all_ops_pipeline():
    """Producers "a" and "b" (a pixel and its neighbour), a stage of
    :func:`_all_ops` and a constant stage (a copy) added to it."""
    p = Pipeline("all-ops")
    x = p.input("in")
    a = p.stage("a", [(x, 1, 1)], _first)
    b = p.stage("b", [(x, 1, 2)], _first)
    k = p.stage("k", [(x, 1, 1)],
                lambda w: torch.full_like(w["in"][..., 0, 0], 0.25))
    s = p.stage("s", [(a, 1, 1), (b, 1, 1)], _all_ops)
    o = p.stage("o", [(s, 1, 1), (k, 1, 1)],
                lambda w: w["s"][..., 0, 0] + w["k"][..., 0, 0])
    p.output("out", [(o, 1, 1)])
    return p.build()


def test_instruction_codes_match_the_kernel(host_kernel):
    """Every instruction of ``expr.XOPS`` has a rule of the generator (a
    load reads a window), and one program that uses all of them compiles
    into the kernel under the shim and equals the eager function (within
    4 ULP: exp, log and tanh are the C library's)."""
    assert set(expr_codegen.RULES) | {"load"} == set(expr.XOPS)
    dag = all_ops_pipeline()
    x, _ = case_frames(dag, 2, 13, 53, 5)
    prog = sp.build_program(dag, 13, 53, 3, frames=2)
    used = {expr.XOPS[w & 255] for ex in prog.exprs.values()
            for w in ex.code[:, 0]}
    assert used == set(expr.XOPS), sorted(set(expr.XOPS) - used)
    got = torch.from_numpy(host_kernel(prog, x))
    assert_bounded(got, case_plain(dag, prog, torch.from_numpy(x), []))


NAN_FNS = {
    "maximum": lambda w: torch.maximum(w["a"][..., 0, 0], _b(w)),
    "minimum": lambda w: torch.minimum(_b(w), w["a"][..., 1, 1]),
    "clamp": lambda w: _b(w).clamp(0.2, 0.7),
    "amax": lambda w: w["a"].amax((-2, -1)),
    "amin": lambda w: w["a"].amin((-2, -1)),
    "compare_where": lambda w: torch.where(_b(w) > 0.5, _b(w), -_b(w)),
    # the index of the first NaN, as torch.argmax / argmin give it
    "argmax": lambda w: w["a"].flatten(-2).argmax(-1).float(),
    "argmin": lambda w: w["a"].argmin(-1).float()[..., 2],
    # eager PyTorch's rules: sign(NaN) is 0 (jnp.sign gives NaN), x ** 0
    # is 1, floor and remainder pass it on
    "sign_pow0": lambda w: torch.sign(_b(w)) + _b(w) ** 0 * 2,
    "rounding": lambda w: torch.floor(_b(w)) + torch.remainder(_b(w), 0.3),
    # a NaN cast to an integer: the device's own cast, as eager PyTorch
    # takes it there (the CPU's gives INT_MIN, CUDA's 0)
    "int_cast": lambda w: _b(w).int().float() + _b(w).long().float(),
}


NAN_SHAPES = {"a": (1, 3, 3), "b": (1, 1, 1)}
# the cases whose result is never NaN
NAN_FREE = {"argmax", "argmin", "sign_pow0", "int_cast"}


@pytest.mark.parametrize("op", sorted(NAN_FNS))
def test_max_and_min_pass_a_nan_on(host_kernel, op):
    """maximum, minimum, clamp, amax and amin give NaN where an operand
    is NaN, as eager PyTorch does; comparisons and where see a NaN as
    eager PyTorch does; argmax and argmin give the first NaN's index;
    sign, pow, floor, remainder and integer casts follow eager PyTorch's
    rules for a NaN."""
    dag = case_pipeline(f"nan-{op}", NAN_FNS[op], NAN_SHAPES)
    x, _ = case_frames(dag, 2, 13, 53, 0)
    x.reshape(-1)[::31] = np.nan
    prog = sp.build_program(dag, 13, 53, 8, frames=2)
    got = host_kernel(prog, x)
    exp = case_plain(dag, prog, torch.from_numpy(x), []).numpy()
    if op in NAN_FREE:
        assert not np.isnan(exp).any()
    else:
        assert 0 < np.isnan(exp).sum() < exp.size
    np.testing.assert_array_equal(got, exp)


def test_registered_payloads_lower():
    """Each payload's eager function lowers within the kernel's limits
    (the bare forms the kernel runs, held against the payload forms bit
    for bit in ``tests/test_torch_kernel_host.py``)."""
    dags = [f() for f in {**algorithms.ALGORITHMS,
                          **algorithms.VIDEO_ALGORITHMS}.values()]
    seen = set()
    p = Pipeline("ident")
    p.output("out", [(p.stage("i", [(p.input("in"), 1, 1)],
                              algorithms.identity_fn), 1, 1)])
    dags.append(p.build())
    for dag in dags:
        for name in dag.topo_order:
            fn = dag.stages[name].fn
            if fn is None:
                continue
            ex = expr.lower_stage(dag.name, name, fn.eager,
                                  dag.in_edges(name))
            assert len(ex.code) <= expr.MAX_INSTRS
            assert ex.n_regs <= expr.MAX_REGS
            seen.add(fn.op)
    assert seen == set(sp._ARITY)


def test_bare_pipelines_lower_every_computed_stage():
    for f in {**algorithms.ALGORITHMS, **algorithms.VIDEO_ALGORITHMS}.values():
        dag = expr.bare_pipeline(f())
        prog = sp.build_program(dag, 16, 24, 8)
        computed = {n for n, s in dag.stages.items() if s.fn is not None}
        assert set(prog.exprs) == computed
        rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
        kinds = [sp.KINDS[r[sp.S_KIND]]
                 for r in rows[:int(prog.table[sp.H_NSTAGES])]]
        assert kinds.count("expr") == len(computed)
        assert int(prog.table[sp.H_EXPR]) == 1
        # each stage's row names its generated body, which the
        # program's fragment holds
        expr_rows = [r for r in rows[:int(prog.table[sp.H_NSTAGES])]
                     if sp.KINDS[r[sp.S_KIND]] == "expr"]
        for r, ex in zip(expr_rows, prog.exprs.values()):
            assert r[sp.S_XID] == expr_codegen.stage_id(ex)
            assert f"case {r[sp.S_XID]}: {expr_codegen.function_name(ex)}" \
                in prog.source
        # a payload program has no expression stage and no fragment
        plain = sp.build_program(f(), 16, 24, 8)
        assert int(plain.table[sp.H_EXPR]) == 0 and not plain.exprs
        assert plain.source == ""


def test_launch_work_counts_the_lowered_operations():
    """A bare pipeline moves the payload form's bytes, and its operations
    are its lowered functions' per pixel."""
    for name in ("unsharp-m", "canny-s", "tbackground-t"):
        dag = (algorithms.ALGORITHMS.get(name)
               or algorithms.VIDEO_ALGORITHMS[name])()
        bare = sp.build_program(expr.bare_pipeline(dag), 16, 24, 8)
        pay = sp.build_program(dag, 16, 24, 8)
        nb, ob = sp.launch_work(bare, 2)
        assert nb == sp.launch_work(pay, 2)[0]
        assert ob == sum(e.ops for e in bare.exprs.values()) * 2 * 16 * 24


def _pipeline(fn, reads=((1, 1, 1),), name="p"):
    p = Pipeline(name)
    x = p.input("in")
    refs = [x]
    for i in range(len(reads) - 1):
        refs.append(p.stage(f"c{i}", [(x, 1, 1)], algorithms.identity_fn))
    y = p.stage("s", [(r, *shape) for r, shape in zip(refs, reads)], fn)
    p.output("out", [(y, 1, 1)])
    return p.build()


def _right_deep(w):
    """70 elements summed innermost first: all live at once."""
    vals = [w["in"][..., 0, i] for i in range(70)]
    acc = vals[-1]
    for v in reversed(vals[:-1]):
        acc = v + acc
    return acc


_TAPS = np.random.RandomState(2).rand(16, 17).astype(np.float32)
_LUT = torch.tensor([0.25, 0.5, 0.75])
REFUSALS = {
    "unsupported_op": (lambda w: torch.atan(w["in"][..., 0, 0]),
                       ((1, 1, 1),), "aten.atan"),
    "sum_of_everything": (lambda w: w["in"].sum() + w["in"][..., 0, 0],
                          ((1, 1, 1),), "aten.sum.default"),
    "reduce_a_pixel_axis": (lambda w: w["in"].mean(0)[..., 0, 0],
                            ((1, 1, 1),), "mixes pixels"),
    "index_a_pixel_axis": (lambda w: w["in"][0][..., 0, 0],
                           ((1, 1, 1),), "mixes pixels"),
    "reshape_across_pixels": (lambda w: w["in"].reshape(6, 1)[..., 0],
                              ((1, 1, 1),), "mixes pixels"),
    # (2, 3) pixels broadcast onto a (2, 3) window: the trace allows it
    "broadcast_across_pixels": (lambda w: (w["in"] * w["in"][..., 0, 0])
                                .amax((-2, -1)), ((1, 2, 3),),
                                "different ranks"),
    "control_flow": (lambda w: w["in"][..., 0, 0] if w["in"].max() > 0
                     else -w["in"][..., 0, 0], ((1, 1, 1),), "control flow"),
    "float64": (lambda w: (w["in"][..., 0, 0].double() * 2).float(),
                ((1, 1, 1),), "float64"),
    # integer arithmetic: an index plus an integer is an int64 tensor
    "integer": (lambda w: w["in"][..., 0, 0]
                + (w["in"].argmax(-1)[..., 0] + 1),
                ((1, 1, 3),), "integer arithmetic"),
    "integer_conversion": (lambda w: w["in"][..., 0, 0].int().long()
                           .float(), ((1, 1, 1),),
                           "between integer types"),
    "index_over_every_axis": (lambda w: w["in"][..., 0, 0]
                              + w["in"].argmax().float(), ((1, 1, 3),),
                              "mixes pixels"),
    # a lookup table indexed by a tensor, a cumulative op
    "lookup_table": (lambda w: _LUT[w["in"].argmax(-1)[..., 0]],
                     ((1, 1, 3),), "aten.index"),
    "cumulative": (lambda w: w["in"].cumsum(-1)[..., 0, 2], ((1, 1, 3),),
                   "aten.cumsum"),
    "returns_bool": (lambda w: w["in"][..., 0, 0] > 0.5, ((1, 1, 1),),
                     "non-float32"),
    "returns_a_window": (lambda w: w["in"][..., 0, :], ((1, 1, 3),),
                         "not one value per pixel"),
    "too_many_windows": (lambda w: sum(v[..., 0, 0] for v in w.values()),
                         ((1, 1, 1),) * 4, f"exceed the kernel's "
                                           f"{expr.MAX_SRC}"),
    "too_many_registers": (_right_deep, ((1, 1, 70),), "registers"),
    "too_many_instructions": (lambda w: w["in"].sum((-2, -1)),
                              ((1, 40, 40),), "instructions"),
    "too_many_constants": (algorithms.conv_fn(_TAPS).eager,
                           ((1, 16, 17),), "constants"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_name_the_stage_and_the_op(name):
    fn, reads, what = REFUSALS[name]
    dag = _pipeline(fn, reads, name=f"refuse-{name}")
    with pytest.raises(ValueError, match=f"refuse-{name}/s") as e:
        sp.build_program(dag, 8, 48, 1)
    assert what in str(e.value), str(e.value)
    # the executor factory refuses it too, on the CPU as on the card
    with pytest.raises(ValueError, match=f"refuse-{name}/s"):
        sp.make_executor(dag, 8, 48, device="cpu")


def test_constants_fill_the_programs_table():
    """Constants of every expression stage share the kernel's table of
    MAX_WTS floats; a program over it is refused by build_program."""
    taps = np.random.RandomState(3).rand(12, 12).astype(np.float32)
    p = Pipeline("wide")
    x = p.input("in")
    a = p.stage("a", [(x, 12, 12)], algorithms.conv_fn(taps).eager)
    b = p.stage("b", [(a, 12, 12)], algorithms.conv_fn(taps * 2).eager)
    p.output("out", [(b, 1, 1)])
    with pytest.raises(ValueError, match="constants exceed"):
        sp.build_program(p.build(), 32, 64, 1)


def test_lowering_is_cached_per_function_and_windows():
    fn = CASES["arith"][0]
    a = expr.lower_stage("p", "s", fn, _edges(CASES["arith"][1]))
    b = expr.lower_stage("q", "t", fn, _edges(CASES["arith"][1]))
    assert a.code is b.code
    assert not a.code.flags.writeable


# sha256 of the registered pipelines' stage and constant tables at 1080p
# (R 1 and 8, depths 1 and 2, B=4): the expression route adds fields and
# op codes that payload programs never set, so their tables stay as the
# payload kernel has read them since its redesign, byte for byte
PAYLOAD_TABLES_SHA256 = \
    "83731fd7210dec39533b5b6d1c9b16b48ace5e5fbfa853be4bcd48aea71a7090"


def test_payload_tables_are_unchanged_by_the_expression_route():
    import hashlib

    from repro_torch.core import compile_pipeline
    h = hashlib.sha256()
    for name in sorted({**algorithms.ALGORITHMS,
                        **algorithms.VIDEO_ALGORITHMS}):
        dag = (algorithms.ALGORITHMS.get(name)
               or algorithms.VIDEO_ALGORITHMS[name])()
        plan = compile_pipeline(dag, 1920)
        for r in (1, 8):
            for d in (1, 2):
                p = sp.build_program(dag, 1080, 1920, r, frames=4,
                                     alloc_buffers=plan.alloc.buffers,
                                     prefetch_depth=d)
                h.update(p.table.tobytes())
                h.update(p.wts.tobytes())
    assert h.hexdigest() == PAYLOAD_TABLES_SHA256


def test_lowering_from_many_threads():
    """Executors built on many threads at once lower their stages in
    turns (a trace patches module state): every thread's program equals
    the one built alone."""
    names = sorted(algorithms.ALGORITHMS)
    want = {n: sp.build_program(expr.bare_pipeline(
        algorithms.ALGORITHMS[n]()), 16, 24, 8).source for n in names}
    errors, got = [], {}

    def build(i):
        name = names[i % len(names)]
        try:
            # a fresh DAG: new closures, so each thread traces anew
            dag = expr.bare_pipeline(algorithms.ALGORITHMS[name]())
            got[i] = (name, sp.build_program(dag, 16, 24, 8).source)
        except Exception as e:            # reported below
            errors.append(repr(e))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=build, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(got) == 16
    for name, source in got.values():
        assert source == want[name]


def conv_pipeline(taps, name="conv"):
    """A 3x3 correlation with ``taps`` as a stage function of the user's
    (the payload's eager function): its taps are the stage's constants."""
    p = Pipeline(name)
    c = p.stage("c", [(p.input("in"), 3, 3)], algorithms.conv_fn(taps).eager)
    p.output("out", [(c, 1, 1)])
    return p.build()


TAPS = [np.random.RandomState(s).randn(3, 3).astype(np.float32)
        for s in (30, 31)]


def test_other_constants_share_the_fragment_and_the_library(host_kernel):
    """Two programs that differ only in their stages' constants have one
    fragment, one table and one library key; the constants reach the
    kernel through the constant table, so each equals its own eager
    function under the shim."""
    progs = [sp.build_program(conv_pipeline(t), 13, 53, 3, frames=2)
             for t in TAPS]
    a, b = progs
    assert a.source == b.source and a.source
    assert np.array_equal(a.table, b.table)
    assert not np.array_equal(a.wts, b.wts)
    assert a.library_spec.name == b.library_spec.name
    assert _build.expr_library(a.source, False, False).path \
        == _build.expr_library(b.source, False, False).path
    x, _ = case_frames(progs[0].dag, 2, 13, 53, 6)
    for prog in progs:
        exp = case_plain(prog.dag, prog, torch.from_numpy(x), [])
        assert torch.equal(torch.from_numpy(host_kernel(prog, x)), exp)


def test_a_changed_instruction_changes_the_key():
    """A stage function with one instruction changed gets another id,
    another fragment and another library; so does another
    instantiation of the same fragment (depth 2)."""
    shapes = {"a": (1, 1, 1), "b": (1, 1, 1)}
    add, sub = (case_pipeline(n, fn, shapes) for n, fn in (
        ("add", lambda w: _one(w) + _b(w)),
        ("sub", lambda w: _one(w) - _b(w))))
    pa, pb = (sp.build_program(d, 13, 53, 3) for d in (add, sub))
    ia, ib = (expr_codegen.stage_id(p.exprs["s"]) for p in (pa, pb))
    assert ia != ib
    assert expr_codegen.function_name(pa.exprs["s"]) \
        != expr_codegen.function_name(pb.exprs["s"])
    assert pa.source != pb.source
    assert pa.library_spec.name != pb.library_spec.name
    deep = sp.build_program(add, 13, 53, 3, prefetch_depth=2)
    assert deep.source == pa.source
    assert deep.library_spec.name != pa.library_spec.name


def two_stage_pipeline():
    """Two expression stages of other shapes in one program: a gradient
    magnitude over a 3x3 window and a threshold of it."""
    def grad(w):
        win = w["in"]
        gx = win[..., 1, 2] - win[..., 1, 0]
        gy = win[..., 2, 1] - win[..., 0, 1]
        return gx * gx + gy * gy

    def thresh(w):
        g = w["g"][..., 0, 0]
        return torch.where(g > 0.2, g, 0.0)
    p = Pipeline("two-stages")
    g = p.stage("g", [(p.input("in"), 3, 3)], grad)
    t = p.stage("t", [(g, 1, 1)], thresh)
    p.output("out", [(t, 1, 1)])
    return p.build()


def test_two_expression_stages_dispatch_each_to_its_own_function(
        host_kernel):
    """Each expression stage's row names its own generated function, the
    fragment dispatches each id to it, and the program equals the eager
    functions under the shim."""
    dag = two_stage_pipeline()
    prog = sp.build_program(dag, 13, 53, 3, frames=2)
    rows = prog.table[sp.HDR:].reshape(-1, sp.STAGE_INTS)
    ids = {}
    for i, name in enumerate(("in", "g", "t")):
        if name in prog.exprs:
            ex = prog.exprs[name]
            assert rows[i][sp.S_KIND] == sp.KINDS.index("expr")
            assert rows[i][sp.S_XID] == expr_codegen.stage_id(ex)
            ids[name] = (int(rows[i][sp.S_XID]),
                         expr_codegen.function_name(ex))
    assert len(ids) == 2 and len(set(ids.values())) == 2
    for i, fn in ids.values():
        assert f"case {i}: {fn}<kTemporal>(c, S);" in prog.source
        assert prog.source.count(f"void {fn}(") == 1
    x, _ = case_frames(dag, 2, 13, 53, 7)
    exp = case_plain(dag, prog, torch.from_numpy(x), [])
    assert torch.equal(torch.from_numpy(host_kernel(prog, x)), exp)


def test_payload_programs_launch_from_the_shared_library():
    """A payload program has no fragment and launches from the shared
    library; its bare form from a library of its own."""
    for f in {**algorithms.ALGORITHMS, **algorithms.VIDEO_ALGORITHMS}.values():
        pay = sp.build_program(f(), 16, 24, 8)
        bare = sp.build_program(expr.bare_pipeline(f()), 16, 24, 8)
        assert pay.source == "" and not pay.exprs
        assert pay.library_spec.name == "stencil_pipeline"
        assert bare.library_spec.name.startswith("stencil_expr-")


@pytest.mark.parametrize("name", ["harris-m", "canny-s", "tdenoise-t",
                                  "generic", "tgeneric"])
@pytest.mark.parametrize("bare", [False, True])
def test_a_dags_libraries_are_its_programs_libraries(name, bare):
    """What ``prebuild`` builds at a pipeline's first use is exactly the
    set of libraries its programs launch from, at any shape, R, batch
    and depth: the shared one for a payload DAG, the program's own at
    depth 1 and at prefetch depth for one with an expression stage."""
    dag = generic_pipeline(name == "tgeneric") if "generic" in name else (
        algorithms.ALGORITHMS.get(name) or algorithms.VIDEO_ALGORITHMS[name])()
    if bare:
        dag = expr.bare_pipeline(dag)
    want = {lib.name for lib in sp.dag_libraries(dag)}
    got = {sp.build_program(dag, h, w, r, frames=f, prefetch_depth=d
                            ).library_spec.name
           for h, w, r, f in ((16, 24, 1, 1), (37, 53, 8, 3))
           for d in (1, 2)}
    assert got == want
    assert len(want) == (2 if bare else 1)


def test_a_failed_build_is_kept_and_raised_by_the_load(monkeypatch,
                                                       tmp_path):
    """``prebuild`` raises nothing; a library whose build failed raises
    nvcc's output where the program's library is loaded or built, and
    nvcc does not run for it again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_FAILED", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    ran = []

    def failing(lib):
        ran.append(lib.name)
        return 0.25, f"nvcc failed for {lib.name}: no such intrinsic"
    monkeypatch.setattr(_build, "_compile", failing)
    dag = two_stage_pipeline()
    seconds = sp.prebuild(dag)
    assert sorted(seconds) == sorted(ran) \
        == sorted(lib.name for lib in sp.dag_libraries(dag))

    def no_nvcc(lib):
        raise AssertionError(f"nvcc ran again for {lib.name}")
    monkeypatch.setattr(_build, "_compile", no_nvcc)
    prog = sp.build_program(dag, 13, 53, 3)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        sp.library(prog)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        sp.build_libraries([prog])
    assert sp.prebuild(dag) == {}


def test_prebuild_leaves_a_refusal_to_build_program(monkeypatch):
    """A stage that does not lower: ``prebuild`` builds nothing and
    raises nothing; ``build_program`` raises the refusal."""
    def no_nvcc(lib):
        raise AssertionError(f"nvcc ran for {lib.name}")
    monkeypatch.setattr(_build, "_compile", no_nvcc)
    fn, reads, what = REFUSALS["integer"]
    dag = _pipeline(fn, reads, name="refused")
    assert sp.prebuild(dag) == {}
    with pytest.raises(ValueError, match=f"refused/s.*{what}"):
        sp.build_program(dag, 13, 53, 3)


def test_plan_cache_on_the_cpu_builds_no_library(monkeypatch):
    """Only a cache on the card builds a pipeline's libraries when it
    first meets it."""
    def no_nvcc(lib):
        raise AssertionError(f"nvcc ran for {lib.name}")
    monkeypatch.setattr(_build, "_compile", no_nvcc)
    dag = two_stage_pipeline()
    cache = PlanCache(pipelines={dag.name: lambda: dag}, device="cpu")
    assert cache.dag_for(dag.name) is cache.dag_for(dag.name)
    assert cache.stats.exec_compile_s == 0


def HOST_EXPR_DAGS():
    """The expression stages the host-compiled kernel runs here."""
    return [case_pipeline(n) for n in CASES] + [
        case_pipeline(f"nan-{op}", NAN_FNS[op], NAN_SHAPES)
        for op in NAN_FNS] + [all_ops_pipeline(), two_stage_pipeline()] + [
        conv_pipeline(t) for t in TAPS]
