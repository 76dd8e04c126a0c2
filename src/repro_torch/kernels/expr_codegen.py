"""Lowered stage functions written out as CUDA C++ for the fused kernel.

The TPU kernel traces a stage's jnp function into its body and compiles
it with the pipeline (``repro/kernels/stencil_pipeline.py``, ``val =
st.fn(wins)``). The port does the same on Hopper: a stage whose function
is no built-in payload is lowered on the host to a
:class:`~repro_torch.core.expr.StageExpr` (straight-line float32
instructions over the elements of its windows), and :func:`expr_source`
writes each distinct lowered stage as one ``__device__`` function that a
program's own library includes into ``csrc/stencil_pipeline.cu`` at its
``STENCIL_EXPR`` hook (``kernels/_build.py`` builds and caches it).

Each function has the shape of the kernel's payload window bodies
(``stage_conv``, ``stage_stmean``): the stage's constants read once from
its slice of the constant table, then per column a sliding
``Window<sh, sw>`` in registers for every (operand, time index) the
stage loads from, initialised before row 0 and pushed once a row; each
instruction becomes one ``const float`` local (SSA: ``nvcc`` allocates
the registers) with the intrinsic that rounds as the eager op does; the
last one goes to ``Sink::put``. The constants are not in the source, so
stages that differ only in constants (user thresholds, fuzz seeds) share
a function, and programs that differ only in them share a library.

A function is named by a hash of its structure — the instructions, the
operand windows' shapes and the number of constants — and the kernel
finds it by the stage's ``S_XID`` field, the hash's low 31 bits
(:func:`stage_id`), so one fragment serves every program whose stages it
holds.
"""
from __future__ import annotations

import hashlib
from typing import Iterable

import numpy as np

from repro_torch.core.expr import XOPS, StageExpr

# instruction -> C++ expression over its operands a, b, c; "load" reads a
# window element
RULES = {
    "copy": "{a}",
    "add": "__fadd_rn({a}, {b})",
    "sub": "__fsub_rn({a}, {b})",
    "mul": "__fmul_rn({a}, {b})",
    "div": "__fdiv_rn({a}, {b})",
    "max": "max_nan({a}, {b})",
    "min": "min_nan({a}, {b})",
    "neg": "-{a}",
    "abs": "fabsf({a})",
    "sqrt": "__fsqrt_rn({a})",
    "exp": "expf({a})",
    "log": "logf({a})",
    "tanh": "tanhf({a})",
    "lt": "{a} < {b} ? 1.f : 0.f",
    "le": "{a} <= {b} ? 1.f : 0.f",
    "gt": "{a} > {b} ? 1.f : 0.f",
    "ge": "{a} >= {b} ? 1.f : 0.f",
    "eq": "{a} == {b} ? 1.f : 0.f",
    "ne": "{a} != {b} ? 1.f : 0.f",
    "where": "{a} != 0.f ? {b} : {c}",
    "and": "{a} != 0.f && {b} != 0.f ? 1.f : 0.f",
    "or": "{a} != 0.f || {b} != 0.f ? 1.f : 0.f",
    "not": "{a} == 0.f ? 1.f : 0.f",
    "floor": "floorf({a})",
    "ceil": "ceilf({a})",
    "trunc": "truncf({a})",
    "round": "rintf({a})",              # half to even, as torch.round
    "fmod": "fmodf({a}, {b})",
    "rsqrt": "rsqrtf({a})",
    "sin": "sinf({a})",
    "cos": "cosf({a})",
    "erf": "erff({a})",
    "pow": "powf({a}, {b})",
    # an argmax / argmin step: x beats the best so far if larger (smaller)
    # or a NaN where the best is not, so ties keep the first index
    "take_max": "{a} > {b} || ({a} != {a} && {b} == {b}) ? 1.f : 0.f",
    "take_min": "{a} < {b} || ({a} != {a} && {b} == {b}) ? 1.f : 0.f",
    # float -> int -> float, the cast eager PyTorch takes on the device
    "toi32": "static_cast<float>(static_cast<int>({a}))",
    "toi64": "static_cast<float>(static_cast<long long>({a}))",
}
_ARITY = {op: sum(f"{{{x}}}" in r for x in "abc")
          for op, r in RULES.items()}


def _structure(ex: StageExpr) -> bytes:
    """What a generated function depends on: the instructions, the
    operand windows' shapes (not their producers) and the number of
    constants (not their values)."""
    shapes = [(st, sh, sw) for _, st, sh, sw in ex.operands]
    return (np.ascontiguousarray(ex.code, dtype="<i4").tobytes()
            + repr((shapes, len(ex.consts))).encode())


def _digest(ex: StageExpr) -> str:
    return hashlib.sha256(_structure(ex)).hexdigest()


def stage_id(ex: StageExpr) -> int:
    """The id of ``ex``'s generated function, as the stage table's
    ``S_XID`` holds it: its structure hash's low 31 bits."""
    return int(_digest(ex)[:8], 16) & 0x7FFFFFFF


def function_name(ex: StageExpr) -> str:
    return f"expr_{_digest(ex)[:16]}"


def _function(ex: StageExpr) -> str:
    """``ex`` as one ``__device__`` function template over kTemporal."""
    words = ex.code
    shapes = [(st, sh, sw) for _, st, sh, sw in ex.operands]
    n_consts = len(ex.consts)
    name = function_name(ex)
    wins = sorted({(int(a) & 255, int(a) >> 8) for w0, a, _, _ in words
                   if XOPS[w0 & 255] == "load"})
    value: dict[int, str] = {}       # register -> the local that holds it

    def src(x: int) -> str:
        return value[int(x)] if x >= 0 else f"k{~int(x)}"
    body = []
    for k, (w0, a, b, c) in enumerate(words.tolist()):
        op, dst = XOPS[w0 & 255], w0 >> 8
        if op == "load":
            rhs = f"w{a & 255}_{a >> 8}.v[{b}][{c}]"
        else:
            ops = dict(zip("abc", (src(x) for x in (a, b, c)[:_ARITY[op]])))
            rhs = RULES[op].format(**ops)
        body.append(f"      const float x{k} = {rhs};")
        value[dst] = f"x{k}"
    shown = ", ".join(f"{st}x{sh}x{sw}" for st, sh, sw in shapes)
    lines = [
        f"// {len(words)} instructions over windows ({shown}), "
        f"{n_consts} constants",
        "template <bool kTemporal>",
        f"__device__ __forceinline__ void {name}(const Ctx& c, "
        "const int* S) {",
        "  const float* wt = c.P->wts + S[S_WOFF];",
        *(f"  const float k{i} = wt[{i}];" for i in range(n_consts)),
        "  for (int lc = c.tid; lc < c.ncols; lc += c.nt) {",
        "    Sink out = sink<kTemporal>(c, S, lc);",
    ]
    for j, dt in wins:
        _, sh, sw = shapes[j]
        lines += [f"    Cursor u{j}_{dt} = cursor(c, S[S_SRC + {j}] + {dt}, "
                  f"{sh - 1});",
                  f"    Window<{sh}, {sw}> w{j}_{dt};",
                  f"    w{j}_{dt}.init(c, u{j}_{dt}, lc);"]
    lines.append("    for (int i = 0; i < c.R; ++i) {")
    lines += [f"      w{j}_{dt}.push(c, u{j}_{dt}, lc);" for j, dt in wins]
    lines += body
    lines += [f"      out.put(c, i, x{len(words) - 1});", "    }", "  }",
              "}", ""]
    return "\n".join(lines)


def expr_source(stage_exprs: Iterable[StageExpr]) -> str:
    """The fragment for the ``STENCIL_EXPR`` hook: one function per
    distinct lowered stage of ``stage_exprs`` (ordered by id, so the
    same set of stages gives the same text) and the dispatcher
    ``stage_generated<kTemporal>(c, S)`` on ``S[S_XID]``. Raises
    ValueError if two distinct stages share an id."""
    funcs: dict[int, StageExpr] = {}
    for ex in stage_exprs:
        i = stage_id(ex)
        if i in funcs and function_name(funcs[i]) != function_name(ex):
            raise ValueError(f"stage ids collide: {function_name(ex)} and "
                             f"{function_name(funcs[i])} share {i}")
        funcs.setdefault(i, ex)
    order = sorted(funcs)
    parts = [f"// Generated by repro_torch/kernels/expr_codegen.py: "
             f"{len(order)} lowered stage functions.", ""]
    parts += [_function(funcs[i]) for i in order]
    parts += ["template <bool kTemporal>",
              "__device__ __forceinline__ void stage_generated(const Ctx& c, "
              "const int* S) {",
              "  switch (S[S_XID]) {",
              *(f"    case {i}: {function_name(funcs[i])}<kTemporal>(c, S); "
                f"break;" for i in order),
              "    default: break;",
              "  }",
              "}", ""]
    return "\n".join(parts)
