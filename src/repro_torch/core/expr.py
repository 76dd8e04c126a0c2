"""User-written stage functions lowered to a per-pixel program.

A stage's ``fn`` in the DSL is any torch window function: it maps
{key: window} to one value per pixel (``core/dag.py``). The fused kernel
cannot run Python, so a stage whose ``fn`` is not a built-in
:class:`~repro_torch.core.algorithms.Payload` is traced once on the host
and lowered to a :class:`StageExpr`: a straight-line list of float32
scalar instructions over the elements of its windows. The StageExpr is
the intermediate form: ``kernels/expr_codegen.py`` writes it out as a
CUDA function, compiled into the program's own library of the kernel
(``csrc/stencil_pipeline.cu``) at the program's first use on the card,
as Pallas compiles a stage's traced function into the TPU kernel. So a
pipeline with such a stage costs one ``nvcc`` build (cached on disk by
content hash); one compiled kernel serves every pipeline of built-in
payloads only.

Tracing. ``make_fx`` records the aten ops of ``fn`` on fake CPU tensors.
Each window has shape (2, 3, [st,] sh, sw): a leading (2, 3) block of
pixels, so that an op that mixes pixels (a reduction or an index over a
leading axis, a reduction over every axis, a reshape across them) shows
in the trace and is refused. Value-dependent Python control flow cannot
trace on fake tensors and is refused too.

Lowering. Every traced value becomes an array of scalar nodes, one per
element of its per-pixel (trailing) shape: a window element, a float32
constant, or an operation on other nodes. Elementwise ops broadcast over
the elements, ``select`` and ``slice`` index the array, and a reduction
folds its elements in row-major order (``acc = x0; acc = op(acc, x1)``).
The nodes reachable from the result are scheduled depth first (each
window element loaded just before its first use) and given registers by
a linear scan. These aten ops lower (:func:`lowerable_ops`):

  * arithmetic: add, sub, rsub, mul, div (true division), reciprocal,
    neg, abs, sqrt, exp, log, tanh, maximum, minimum, clamp, clamp_min,
    clamp_max;
  * rounding: floor, ceil, trunc, round (half to even), frac (x -
    trunc(x)), sign and sgn ((0 < x) - (x < 0), eager PyTorch's), fmod,
    and remainder (fmod, then + b where it is not 0 and its sign is not
    b's, eager PyTorch's formula; Tensor, Scalar and Scalar_Tensor);
  * the libraries' functions: rsqrt, sigmoid (1 / (1 + exp(-x)), eager
    PyTorch's order), sin, cos, erf, and pow: Tensor_Tensor and Scalar
    (a number base) take powf; a number exponent takes eager PyTorch's
    cases, 0 (ones, a NaN base too), 1 (a copy), 2 and 3 (x * x, x * x *
    x), -1 and -2 (1 / x, 1 / (x * x)), 0.5 and -0.5 (sqrt, rsqrt), and
    powf of the exponent rounded to float32 for any other;
  * comparisons (lt, le, gt, ge, eq, ne) and where; logical and, or and
    not (and bitwise ones on bool);
  * reductions over window axes: amax, amin, max.dim / min.dim (values
    and indices), sum, mean, and argmax / argmin over one window axis:
    the first index of the largest (smallest) element, a NaN's first,
    as eager PyTorch and jnp give it;
  * integers: window indices and casts of a float32 value to int32 or
    int64 (a truncation, the device's own cast), read where torch turns
    them into float32 (``.float()``, a comparison, arithmetic with a
    float); an op that gives an integer tensor from them (integer
    arithmetic) does not lower, nor does a cast between integer types;
  * views over window axes: select, slice, unsqueeze, squeeze, view,
    reshape, permute, transpose, expand, unbind, cat, stack;
  * constants: Python scalars and float32 or bool tensors the function
    captures or builds (scalar_tensor, full, zeros_like, ...);
  * float64 only as ``x.to(float64).sqrt().to(float32)``, the correctly
    rounded float32 root that ``algorithms._sqrt_rn`` takes.

Any other aten op raises ValueError naming the pipeline, the stage and
the op; so do indexing by a tensor (a lookup table), cumulative ops and
a reduction or an index over every axis. Each instruction counts as one
operation of the launch's work (a sin as one, sigmoid as its four).
Numerics: a Python scalar is rounded to float32 first, as eager PyTorch
does for a float32 tensor; each instruction rounds once, so the kernel
equals the eager function bit for bit (rounding, fmod, remainder, the
casts and the indices too), with these exceptions:

  * sum and mean: eager PyTorch adds in its own order, and on CUDA takes
    a mean as the sum times the float32 reciprocal of the count;
  * exp, log, tanh, rsqrt, sigmoid, sin, cos, erf and powf: the CUDA
    library's, which differ from the CPU's by a few ULP (4 at the
    array's scale is the bound the tests hold, for sin and cos over
    [-8, 8) and [-8192, 8192));
  * division by a number (a Python scalar or a 0-d CPU tensor): eager
    PyTorch on CUDA multiplies by the number's float32 reciprocal, the
    kernel divides, correctly rounded, as eager PyTorch on the CPU does.
    The two differ by at most 1 ULP of the quotient;
  * sqrt (and pow 0.5): eager float32 torch.sqrt on the CPU is not
    always correctly rounded (1 ULP off at times); the kernel's root is,
    as eager CUDA's;
  * pow -2: eager PyTorch divides 1.0 in float64 by x * x and rounds to
    float32, the kernel divides in float32: the two round differently
    only where the float64 quotient lies on a float32 halfway point.

max, min, clamp, amax and amin pass a NaN on, as eager PyTorch does
(``max_nan`` / ``min_nan``: one PTX max.NaN / min.NaN on the card, whose
NaN is the canonical one rather than the operand's). Where eager
PyTorch and the reference's jnp differ, the kernel follows eager
PyTorch, its plain version: sign(NaN) is 0 and sign(-0.0) is +0.0
(jnp.sign gives NaN and -0.0); a NaN or out-of-range value cast to an
integer is the device's cast (INT_MIN on the CPU; 0 for a NaN and
saturation on CUDA), where XLA gives 0 and saturates.
"""
from __future__ import annotations

import dataclasses
import functools
import operator
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from .dag import Edge, PipelineDAG, window_keys

# instruction op codes (kernels/expr_codegen.py has a rule for each). An
# instruction is four int32 words: op | dst << 8, then operands a, b, c.
# "load" reads window element (dt, dy, dx) of operand j (a = j | dt << 8,
# b = dy, c = dx); every other operand is a register (>= 0) or a
# constant of the stage (~k: constant k).
XOPS = ("load", "copy", "add", "sub", "mul", "div", "max", "min", "neg",
        "abs", "sqrt", "exp", "log", "tanh", "lt", "le", "gt", "ge", "eq",
        "ne", "where", "and", "or", "not", "floor", "ceil", "trunc",
        "round", "fmod", "rsqrt", "sin", "cos", "erf", "pow", "take_max",
        "take_min", "toi32", "toi64")
# instructions that are no float32 operation of the stage's arithmetic
_FREE = ("load", "copy", "where")

# limits of one stage: values live at once (the registers of the linear
# scan), instructions, constants (the kernel's float32 table,
# stencil_pipeline.MAX_WTS, holds every stage's), windows (MAX_SRC)
MAX_REGS, MAX_INSTRS, MAX_CONSTS, MAX_SRC = 64, 1024, 256, 3

# the leading block of pixels every traced window carries
_PIXELS = (2, 3)

# make_fx patches module state for the length of a trace, so traces from
# executors built on several threads at once take turns
_TRACE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True, eq=False)
class StageExpr:
    """A stage function lowered for the kernel's expression body.

    ``operands`` are the windows in window-key order, (producer, st, sh,
    sw) each; ``code`` the (n, 4) int32 instructions (the result is the
    last one's destination register); ``consts`` the float32 constants the
    instructions name by ~k; ``n_regs`` the registers they use; ``ops``
    the float32 operations per output pixel (every instruction but loads,
    copies and selects)."""
    operands: tuple[tuple[str, int, int, int], ...]
    code: np.ndarray
    consts: tuple[float, ...]
    n_regs: int
    ops: int


def _f32(x) -> float:
    return float(np.float32(x))


class _Refused(Exception):
    """A lowering refusal; :func:`lower_stage` adds the stage's name."""


@dataclasses.dataclass
class _V:
    """A traced value: node ids over its per-pixel shape. ``lead``: the
    tensor's shape is (2, 3) + arr.shape (it varies by pixel), else
    arr.shape (a constant). ``kind``: "f" float32, "b" bool (0 / 1), "d" a
    float64 copy of float32 nodes, "s" the float64 root of such a copy,
    "i" integers (int32 or int64 window indices and float-to-int casts,
    held as the float32 of their value: read where torch converts them to
    float32, as in a comparison, a ``.float()`` or a sum with a float)."""
    arr: np.ndarray
    lead: bool
    kind: str = "f"

    def __post_init__(self):
        if not isinstance(self.arr, np.ndarray):  # an element indexed out
            arr = np.empty((), dtype=object)
            arr[()] = self.arr
            self.arr = arr


class _Graph:
    """Scalar nodes, shared by structure: ("load", j, dt, dy, dx),
    ("const", float32 bits) or (op, *operand ids)."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self._memo: dict[tuple, int] = {}

    def node(self, key: tuple) -> int:
        i = self._memo.get(key)
        if i is None:
            i = self._memo[key] = len(self.nodes)
            self.nodes.append(key)
        return i

    def const(self, x) -> int:
        bits = int(np.float32(x).view(np.int32))
        return self.node(("const", bits))


def _objs(shape, fill) -> np.ndarray:
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        arr[idx] = fill(idx)
    return arr


class _Lowering:
    """Traced values to scalar nodes: the helpers the rules share."""

    def __init__(self):
        self.g = _Graph()

    # ---------------------------------------------------------- values
    def scalar(self, x) -> _V:
        if isinstance(x, bool):
            return _V(_objs((), lambda _: self.g.const(float(x))), False, "b")
        if isinstance(x, (int, float)):
            return _V(_objs((), lambda _: self.g.const(_f32(x))), False)
        raise _Refused(f"argument {x!r} is neither a tensor nor a number")

    def val(self, a) -> _V:
        return a if isinstance(a, _V) else self.scalar(a)

    def tensor_const(self, t: torch.Tensor) -> _V:
        if t.dtype not in (torch.float32, torch.bool):
            raise _Refused(f"a {t.dtype} constant (float32 and bool only)")
        a = t.detach().cpu().numpy()
        kind = "b" if t.dtype == torch.bool else "f"
        return _V(_objs(a.shape, lambda i: self.g.const(float(a[i]))), False,
                  kind)

    def full(self, like: _V | None, shape, fill) -> _V:
        kind = "b" if isinstance(fill, bool) else "f"
        if like is not None:
            shape, lead = like.arr.shape, like.lead
        else:
            shape, lead = tuple(shape), False
        c = self.g.const(_f32(fill))
        return _V(_objs(shape, lambda _: c), lead, kind)

    @staticmethod
    def check_float(*vs: _V) -> None:
        for v in vs:
            if v.kind in ("d", "s"):
                raise _Refused("float64 outside x.to(float64).sqrt()"
                               ".to(float32)")

    def broadcast(self, vs: Sequence[_V]) -> tuple[list[np.ndarray], bool]:
        """The operands' node arrays broadcast over one per-pixel shape,
        and whether the result varies by pixel. A value that varies by
        pixel aligns its pixel axes with every other's; a constant may not
        reach them."""
        self.check_float(*vs)
        lead = [v for v in vs if v.lead]
        if not lead:
            return list(np.broadcast_arrays(*[v.arr for v in vs])), False
        nd = lead[0].arr.ndim
        if any(v.arr.ndim != nd for v in lead):
            raise _Refused("a broadcast of pixel values of different ranks "
                           "(it mixes pixels)")
        arrs = []
        for v in vs:
            a = v.arr
            if not v.lead and a.ndim > nd:
                if any(s != 1 for s in a.shape[:a.ndim - nd]):
                    raise _Refused("a constant broadcast across pixels")
                a = a.reshape(a.shape[a.ndim - nd:])
            arrs.append(a)
        return list(np.broadcast_arrays(*arrs)), True

    def elementwise(self, op: str, *args, kind: str = "f") -> _V:
        vs = [self.val(a) for a in args]
        arrs, lead = self.broadcast(vs)
        out = _objs(arrs[0].shape, lambda i: self.g.node(
            (op, *(a[i] for a in arrs))))
        return _V(out, lead, kind)

    # ------------------------------------------------------------ axes
    @staticmethod
    def axis(v: _V, dim: int, extra: int = 0) -> int:
        """Axis of ``v.arr`` for tensor dim ``dim`` (of a tensor of
        rank + ``extra``); refuses a pixel axis."""
        full = v.arr.ndim + (2 if v.lead else 0) + extra
        if not -full <= dim < full:
            raise _Refused(f"dim {dim} out of range")
        dim %= full
        if v.lead:
            if dim < 2:
                raise _Refused(f"an op over pixel axis {dim} (it mixes "
                               f"pixels)")
            dim -= 2
        return dim

    def reduce(self, op: str, v: _V, dims, keepdim: bool,
               mean: bool = False) -> _V:
        self.check_float(v)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            raise _Refused("a reduction over every axis (it mixes pixels)")
        dims = [dims] if isinstance(dims, int) else list(dims)
        axes = sorted({self.axis(v, d) for d in dims})
        keep = [a for a in range(v.arr.ndim) if a not in axes]
        moved = np.transpose(v.arr, keep + axes)
        n = int(np.prod([v.arr.shape[a] for a in axes]))
        flat = moved.reshape(moved.shape[:len(keep)] + (n,))

        def fold(idx):
            elems = flat[idx]
            acc = elems[0]
            for e in elems[1:]:
                acc = self.g.node((op, acc, e))
            if mean:
                acc = self.g.node(("div", acc, self.g.const(float(n))))
            return acc
        out = _objs(flat.shape[:-1], fold)
        if keepdim:
            shape = list(v.arr.shape)
            for a in axes:
                shape[a] = 1
            out = out.reshape(shape)
        return _V(out, v.lead)

    def arg_fold(self, take: str, v: _V, dim: int, keepdim: bool) -> _V:
        """Indices (kind "i") of the first largest (``take_max``) or
        smallest (``take_min``) element along window axis ``dim``, a NaN
        first, as torch.argmax / argmin give them: per element after the
        first, ``t = take(x, best)``, then ``best`` and the index move to
        it where ``t``."""
        self.check_float(v)
        ax = self.axis(v, dim)
        moved = np.moveaxis(v.arr, ax, -1)

        def fold(idx):
            elems = moved[idx]
            best, at = elems[0], self.g.const(0.0)
            for k, e in enumerate(elems[1:], 1):
                t = self.g.node((take, e, best))
                best = self.g.node(("where", t, e, best))
                at = self.g.node(("where", t, self.g.const(float(k)), at))
            return at
        out = _objs(moved.shape[:-1], fold)
        if keepdim:
            out = np.expand_dims(out, ax)
        return _V(out, v.lead, "i")

    def view(self, v: _V, shape: Sequence[int]) -> _V:
        """``v`` reshaped to the traced tensor shape ``shape``."""
        shape = tuple(int(s) for s in shape)
        if v.lead:
            if shape[:2] != _PIXELS:
                raise _Refused(f"a reshape to {shape} (it mixes pixels)")
            shape = shape[2:]
        return _V(v.arr.reshape(shape), v.lead, v.kind)


def _meta_shape(node) -> tuple[int, ...] | None:
    val = node.meta.get("val")
    return tuple(val.shape) if isinstance(val, torch.Tensor) else None


def _meta_dtype(node):
    val = node.meta.get("val")
    return val.dtype if isinstance(val, torch.Tensor) else None


def _rules():
    """{aten overload: rule(lowering, node, args, kwargs) -> value}."""
    aten = torch.ops.aten
    R: dict = {}

    def binary(op, kind="f", swap=False):
        def rule(L, n, a, kw):
            if kw.get("alpha", 1) != 1:
                raise _Refused("alpha other than 1")
            x, y = (a[1], a[0]) if swap else (a[0], a[1])
            return L.elementwise(op, x, y, kind=kind)
        return rule

    for name, op in (("add", "add"), ("sub", "sub"), ("mul", "mul"),
                     ("div", "div")):
        for ov in ("Tensor", "Scalar"):
            R[getattr(getattr(aten, name), ov)] = binary(op)
    R[aten.rsub.Scalar] = R[aten.rsub.Tensor] = binary("sub", swap=True)
    R[aten.maximum.default] = binary("max")
    R[aten.minimum.default] = binary("min")
    for name in ("lt", "le", "gt", "ge", "eq", "ne"):
        for ov in ("Tensor", "Scalar"):
            R[getattr(getattr(aten, name), ov)] = binary(name, kind="b")
    for name, op in (("logical_and", "and"), ("logical_or", "or"),
                     ("bitwise_and", "and"), ("bitwise_or", "or")):
        R[getattr(aten, name).default if name.startswith("logical")
          else getattr(aten, name).Tensor] = binary(op, kind="b")

    def unary(op):
        return lambda L, n, a, kw: L.elementwise(op, a[0])
    for name in ("neg", "abs", "exp", "log", "tanh", "floor", "ceil",
                 "trunc", "round", "rsqrt", "sin", "cos", "erf"):
        R[getattr(aten, name).default] = unary(name)
    # c / x traces as reciprocal(x) * c; eager PyTorch divides 1 by x
    R[aten.reciprocal.default] = \
        lambda L, n, a, kw: L.elementwise("div", 1.0, a[0])
    # eager PyTorch's own formulas: x - trunc(x); (0 < x) - (x < 0), so
    # sign(NaN) is 0; 1 / (1 + exp(-x))
    R[aten.frac.default] = lambda L, n, a, kw: L.elementwise(
        "sub", a[0], L.elementwise("trunc", a[0]))
    R[aten.sign.default] = R[aten.sgn.default] = \
        lambda L, n, a, kw: L.elementwise(
            "sub", L.elementwise("gt", a[0], 0.0, kind="b"),
            L.elementwise("lt", a[0], 0.0, kind="b"))
    R[aten.sigmoid.default] = lambda L, n, a, kw: L.elementwise(
        "div", 1.0, L.elementwise("add", 1.0, L.elementwise(
            "exp", L.elementwise("neg", a[0]))))
    R[aten.fmod.Tensor] = R[aten.fmod.Scalar] = binary("fmod")

    def remainder(L, n, a, kw):
        """fmod, then + b where it is not 0 and its sign is not b's."""
        x, y = a[0], a[1]
        m = L.elementwise("fmod", x, y)
        flip = L.elementwise("and", L.elementwise("ne", m, 0.0, kind="b"),
                             L.elementwise(
                                 "ne", L.elementwise("lt", y, 0.0, kind="b"),
                                 L.elementwise("lt", m, 0.0, kind="b"),
                                 kind="b"), kind="b")
        return L.elementwise("where", flip, L.elementwise("add", m, y), m)
    for ov in ("Tensor", "Scalar", "Scalar_Tensor"):
        R[getattr(aten.remainder, ov)] = remainder

    def logical_not(L, n, a, kw):
        return L.elementwise("not", a[0], kind="b")
    R[aten.logical_not.default] = logical_not

    def bitwise_not(L, n, a, kw):
        if a[0].kind != "b":
            raise _Refused("bitwise_not of a non-bool")
        return logical_not(L, n, a, kw)
    R[aten.bitwise_not.default] = bitwise_not

    def sqrt(L, n, a, kw):
        x = a[0]
        if x.kind == "d":               # the float64 route of _sqrt_rn
            return _V(x.arr, x.lead, "s")
        return L.elementwise("sqrt", x)
    R[aten.sqrt.default] = sqrt

    def pow_(L, n, a, kw):
        """Eager PyTorch's cases of a number exponent: 0 fills ones (a
        NaN base too), 1 copies, 2, 3, -1 and -2 multiply and divide, 0.5
        and -0.5 take sqrt and rsqrt; any other exponent, rounded to
        float32, takes powf."""
        x, e = a[0], a[1]
        if isinstance(e, bool) or not isinstance(e, (int, float)):
            raise _Refused(f"pow with exponent {e!r}")
        if e == 0:
            L.check_float(x)
            return L.full(x, None, 1.0)
        if e == 1:
            L.check_float(x)
            return x
        if e == 0.5:
            return L.elementwise("sqrt", x)
        if e == -0.5:
            return L.elementwise("rsqrt", x)
        if e == -1:
            return L.elementwise("div", 1.0, x)
        if e in (2, 3, -2):
            sq = L.elementwise("mul", x, x)
            if e == 3:
                return L.elementwise("mul", sq, x)
            return L.elementwise("div", 1.0, sq) if e == -2 else sq
        return L.elementwise("pow", x, e)
    R[aten.pow.Tensor_Scalar] = pow_
    R[aten.pow.Tensor_Tensor] = binary("pow")
    R[aten.pow.Scalar] = binary("pow")

    def clamp(L, n, a, kw):
        lo = a[1] if len(a) > 1 else kw.get("min")
        hi = a[2] if len(a) > 2 else kw.get("max")
        v = a[0]
        if lo is not None:
            v = L.elementwise("max", v, lo)
        if hi is not None:
            v = L.elementwise("min", v, hi)
        return v
    R[aten.clamp.default] = R[aten.clamp.Tensor] = clamp
    R[aten.clamp_min.default] = R[aten.clamp_min.Tensor] = \
        lambda L, n, a, kw: L.elementwise("max", a[0], a[1])
    R[aten.clamp_max.default] = R[aten.clamp_max.Tensor] = \
        lambda L, n, a, kw: L.elementwise("min", a[0], a[1])

    def where(L, n, a, kw):
        kind = "b" if _meta_dtype(n) == torch.bool else "f"
        return L.elementwise("where", a[0], a[1], a[2], kind=kind)
    R[aten.where.self] = where

    def reduction(op, mean=False):
        def rule(L, n, a, kw):
            dims = a[1] if len(a) > 1 else kw.get("dim")
            keep = a[2] if len(a) > 2 else kw.get("keepdim", False)
            if kw.get("dtype") not in (None, torch.float32):
                raise _Refused(f"a reduction to {kw['dtype']}")
            return L.reduce(op, a[0], dims, keep, mean)
        return rule
    R[aten.amax.default] = reduction("max")
    R[aten.amin.default] = reduction("min")
    R[aten.sum.dim_IntList] = reduction("add")
    R[aten.mean.dim] = reduction("add", mean=True)

    def maxmin_dim(op):
        def rule(L, n, a, kw):
            keep = a[2] if len(a) > 2 else kw.get("keepdim", False)
            return (L.reduce(op, a[0], a[1], keep),
                    L.arg_fold(f"take_{op}", a[0], a[1], keep))
        return rule
    R[aten.max.dim] = maxmin_dim("max")
    R[aten.min.dim] = maxmin_dim("min")

    def arg_reduce(take):
        def rule(L, n, a, kw):
            dim = a[1] if len(a) > 1 else kw.get("dim")
            keep = a[2] if len(a) > 2 else kw.get("keepdim", False)
            if dim is None:
                raise _Refused("an index over every axis (it mixes pixels)")
            return L.arg_fold(take, a[0], dim, keep)
        return rule
    R[aten.argmax.default] = arg_reduce("take_max")
    R[aten.argmin.default] = arg_reduce("take_min")

    # ---- views
    def select(L, n, a, kw):
        v = a[0]
        ax = L.axis(v, a[1])
        return _V(np.take(v.arr, a[2], axis=ax), v.lead, v.kind)
    R[aten.select.int] = select

    def slice_(L, n, a, kw):
        v = a[0]
        dim = a[1] if len(a) > 1 else 0
        start = a[2] if len(a) > 2 else None
        end = a[3] if len(a) > 3 else None
        step = a[4] if len(a) > 4 else 1
        ax = L.axis(v, dim)
        idx = [slice(None)] * v.arr.ndim
        idx[ax] = slice(start, end, step)
        return _V(v.arr[tuple(idx)], v.lead, v.kind)
    R[aten.slice.Tensor] = slice_

    def reshape(L, n, a, kw):
        return L.view(a[0], _meta_shape(n))
    for op in (aten.view.default, aten._unsafe_view.default,
               aten.squeeze.default):
        R[op] = reshape

    def unsqueeze(L, n, a, kw):
        L.axis(a[0], a[1], extra=1)
        return reshape(L, n, a, kw)
    R[aten.unsqueeze.default] = unsqueeze

    def squeeze(L, n, a, kw):
        for d in [a[1]] if isinstance(a[1], int) else a[1]:
            L.axis(a[0], d)
        return reshape(L, n, a, kw)
    R[aten.squeeze.dim] = R[aten.squeeze.dims] = squeeze

    def expand(L, n, a, kw):
        v, shape = a[0], _meta_shape(n)
        if v.lead:
            if len(shape) != v.arr.ndim + 2:
                raise _Refused("an expand that adds axes before the "
                               "pixel axes")
            shape = shape[2:]
        arr = v.arr.reshape((1,) * (len(shape) - v.arr.ndim) + v.arr.shape)
        return _V(np.broadcast_to(arr, shape), v.lead, v.kind)
    R[aten.expand.default] = expand

    def permute(L, n, a, kw):
        v, dims = a[0], list(a[1])
        if v.lead:
            full = v.arr.ndim + 2
            if [d % full for d in dims[:2]] != [0, 1]:
                raise _Refused("a permute of pixel axes")
            dims = dims[2:]
        return _V(np.transpose(v.arr, [L.axis(v, d) for d in dims]),
                  v.lead, v.kind)
    R[aten.permute.default] = permute

    def transpose(L, n, a, kw):
        v = a[0]
        x, y = L.axis(v, a[1]), L.axis(v, a[2])
        return _V(np.swapaxes(v.arr, x, y), v.lead, v.kind)
    R[aten.transpose.int] = transpose

    def unbind(L, n, a, kw):
        v = a[0]
        ax = L.axis(v, a[1] if len(a) > 1 else 0)
        return tuple(_V(np.take(v.arr, i, axis=ax), v.lead, v.kind)
                     for i in range(v.arr.shape[ax]))
    R[aten.unbind.int] = unbind

    def cat(L, n, a, kw, stack=False):
        vs = list(a[0])
        dim = a[1] if len(a) > 1 else kw.get("dim", 0)
        if len({(v.lead, v.kind) for v in vs}) != 1:
            raise _Refused("a cat of pixel values and constants")
        ax = L.axis(vs[0], dim, extra=int(stack))
        arrs = [np.expand_dims(v.arr, ax) if stack else v.arr for v in vs]
        return _V(np.concatenate(arrs, axis=ax), vs[0].lead, vs[0].kind)
    R[aten.cat.default] = cat
    R[aten.stack.default] = lambda L, n, a, kw: cat(L, n, a, kw, stack=True)

    def same(L, n, a, kw):
        return a[0]
    for op in (aten.alias.default, aten.clone.default, aten.detach.default,
               aten.lift_fresh_copy.default):
        R[op] = same

    def to_copy(L, n, a, kw):
        v = a[0]
        dt = kw.get("dtype", _meta_dtype(n))
        if dt == torch.float64:
            if v.kind != "f":
                raise _Refused(f"a {v.kind!r} value to float64")
            return _V(v.arr, v.lead, "d")
        if dt == torch.float32:
            if v.kind == "s":                  # the correctly rounded root
                return _V(_objs(v.arr.shape, lambda i: L.g.node(
                    ("sqrt", v.arr[i]))), v.lead)
            if v.kind in ("d", "f", "b", "i"):
                return _V(v.arr, v.lead, "f")
        if dt == torch.bool and v.kind in ("f", "b", "i"):
            return L.elementwise("ne", v, 0.0, kind="b")
        if dt in _INTS:
            if v.kind == "f":                  # truncation, as C casts
                return L.elementwise(_INTS[dt], v, kind="i")
            if v.kind == "b":
                return _V(v.arr, v.lead, "i")
            if v.kind == "i":
                raise _Refused("a conversion between integer types")
        raise _Refused(f"a conversion to {dt}")
    R[aten._to_copy.default] = to_copy

    # ---- constants
    def scalar_tensor(L, n, a, kw):
        return L.full(None, (), a[0])
    R[aten.scalar_tensor.default] = scalar_tensor
    R[aten.full.default] = lambda L, n, a, kw: L.full(None, a[0], a[1])
    R[aten.zeros.default] = lambda L, n, a, kw: L.full(None, a[0], 0.0)
    R[aten.ones.default] = lambda L, n, a, kw: L.full(None, a[0], 1.0)
    R[aten.full_like.default] = lambda L, n, a, kw: L.full(a[0], None, a[1])
    R[aten.zeros_like.default] = lambda L, n, a, kw: L.full(a[0], None, 0.0)
    R[aten.ones_like.default] = lambda L, n, a, kw: L.full(a[0], None, 1.0)
    return R


_RULES = _rules()

# integer dtypes: the instruction that casts a float32 value to each
_INTS = {torch.int32: "toi32", torch.int64: "toi64"}


# the aten ops that may give an integer tensor: window indices, casts and
# views (integer arithmetic is refused)
_aten = torch.ops.aten
_INDEX_OPS = frozenset((
    _aten.argmax.default, _aten.argmin.default, _aten._to_copy.default,
    _aten.select.int, _aten.slice.Tensor, _aten.view.default,
    _aten._unsafe_view.default, _aten.squeeze.default, _aten.squeeze.dim,
    _aten.squeeze.dims, _aten.unsqueeze.default, _aten.expand.default,
    _aten.permute.default, _aten.transpose.int, _aten.unbind.int,
    _aten.cat.default, _aten.stack.default, _aten.alias.default,
    _aten.clone.default, _aten.detach.default))


def lowerable_ops() -> tuple[str, ...]:
    """Names of the aten overloads that lower, sorted."""
    return tuple(sorted(str(op) for op in _RULES))


def _trace(fn: Callable, keys: Sequence[str],
           windows: Sequence[tuple[int, int, int]]) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    def flat(*wins):
        return fn(dict(zip(keys, wins)))
    args = [torch.zeros(_PIXELS + ((st,) if st > 1 else ()) + (sh, sw))
            for st, sh, sw in windows]
    return make_fx(flat, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def _needed(gm: torch.fx.GraphModule) -> set:
    """The graph's nodes the output depends on."""
    out = next(n for n in gm.graph.nodes if n.op == "output")
    seen, todo = set(), [out]
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        todo.extend(n.all_input_nodes)
    return seen


def _lower_graph(gm: torch.fx.GraphModule,
                 windows: Sequence[tuple[int, int, int]]
                 ) -> tuple[np.ndarray, tuple[float, ...], int, int]:
    L = _Lowering()
    env: dict = {}
    result = None
    # operand j of the stage is the graph's placeholder j
    operand = {n: j for j, n in enumerate(
        n for n in gm.graph.nodes if n.op == "placeholder")}

    def arg(x):
        if isinstance(x, torch.fx.Node):
            return env[x]
        if isinstance(x, (list, tuple)):
            return type(x)(arg(y) for y in x)
        return x
    needed = _needed(gm)
    for n in gm.graph.nodes:
        if n not in needed:
            continue
        if n.op == "placeholder":
            j = operand[n]
            st, sh, sw = windows[j]
            shape = ((st,) if st > 1 else ()) + (sh, sw)

            def load(idx, j=j, st=st):
                dt, dy, dx = idx if st > 1 else (0, *idx)
                return L.g.node(("load", j, dt, dy, dx))
            env[n] = _V(_objs(shape, load), True)
        elif n.op == "get_attr":
            env[n] = L.tensor_const(getattr(gm, n.target))
        elif n.op == "call_function":
            if n.target is operator.getitem:
                env[n] = env[n.args[0]][n.args[1]]
                continue
            rule = _RULES.get(n.target)
            if rule is None:
                raise _Refused(f"aten op {n.target} does not lower")
            dt = _meta_dtype(n)
            if dt in _INTS:
                if n.target not in _INDEX_OPS:
                    raise _Refused(f"aten op {n.target} gives {dt}: "
                                   f"integer arithmetic does not lower "
                                   f"(indices and float-to-int casts do, "
                                   f"read as float32 or compared)")
            elif dt not in (torch.float32, torch.bool, None) and not (
                    dt == torch.float64 and n.target in (
                        torch.ops.aten._to_copy.default,
                        torch.ops.aten.sqrt.default)):
                raise _Refused(f"aten op {n.target} gives {dt} (float32 "
                               f"and bool only)")
            try:
                env[n] = rule(L, n, arg(n.args), arg(dict(n.kwargs)))
            except _Refused as e:
                raise _Refused(f"aten op {n.target}: {e}") from None
            v = env[n]
            shape = _meta_shape(n)
            if isinstance(v, _V) and shape is not None:
                got = (_PIXELS if v.lead else ()) + v.arr.shape
                if got != shape:
                    raise _Refused(f"aten op {n.target}: lowered to shape "
                                   f"{got}, traced {shape}")
        elif n.op == "output":
            result = arg(n.args[0])
        else:
            raise _Refused(f"graph node {n.op} {n.target} does not lower")
    if not isinstance(result, _V):
        raise _Refused(f"the function returns {type(result).__name__}, not "
                       f"one tensor")
    if not result.lead or result.arr.shape != ():
        full = (_PIXELS if result.lead else ()) + result.arr.shape
        raise _Refused(f"the function returns shape {full}, not one value "
                       f"per pixel")
    if result.kind != "f":
        raise _Refused("the function returns a non-float32 value")
    return _schedule(L.g, int(result.arr[()]))


def _schedule(g: _Graph, root: int
              ) -> tuple[np.ndarray, tuple[float, ...], int, int]:
    """Instructions, constants, registers and float32 operations of the
    nodes ``root`` depends on: depth-first order (operands first, in
    order), registers by linear scan, constants as operands."""
    order: list[int] = []
    done: set[int] = set()
    stack = [(root, False)]
    while stack:
        i, expanded = stack.pop()
        if i in done:
            continue
        key = g.nodes[i]
        if key[0] == "const":
            continue
        if expanded or key[0] == "load":
            done.add(i)
            order.append(i)
            continue
        stack.append((i, True))
        for a in reversed(key[1:]):
            if a not in done:
                stack.append((a, False))
    if g.nodes[root][0] == "const":              # a constant result
        root = g.node(("copy", root))
        order.append(root)
    consts: dict[int, int] = {}

    def operand(i):
        key = g.nodes[i]
        if key[0] == "const":
            return ~consts.setdefault(i, len(consts))
        return reg[i]
    last = {}
    for k, i in enumerate(order):
        if g.nodes[i][0] != "load":
            for a in g.nodes[i][1:]:
                last[a] = k
    last[root] = len(order)
    reg: dict[int, int] = {}
    free: list[int] = []
    n_regs = 0
    code = np.zeros((len(order), 4), np.int32)
    ops = 0
    for k, i in enumerate(order):
        key = g.nodes[i]
        if key[0] == "load":
            _, jj, dt, dy, dx = key
            words = [jj | dt << 8, dy, dx]
        else:
            words = [operand(a) for a in key[1:]]
            for a in set(key[1:]):
                if last.get(a) == k and a in reg:
                    free.append(reg[a])
            ops += key[0] not in _FREE
        if free:
            free.sort(reverse=True)
            reg[i] = free.pop()
        else:
            reg[i] = n_regs
            n_regs += 1
        code[k, 0] = XOPS.index(key[0]) | reg[i] << 8
        code[k, 1:1 + len(words)] = words
    vals = sorted(consts, key=consts.get)
    const_vals = tuple(float(np.int32(g.nodes[i][1]).view(np.float32))
                       for i in vals)
    code.setflags(write=False)
    return code, const_vals, n_regs, ops


@functools.lru_cache(maxsize=512)
def _lower_cached(fn: Callable, keys: tuple[str, ...],
                  windows: tuple[tuple[int, int, int], ...]):
    try:
        with _TRACE_LOCK:
            gm = _trace(fn, keys, windows)
    except Exception as e:       # a trace failure of the user's function
        raise _Refused(f"the function does not trace on fake tensors "
                       f"({type(e).__name__}: {str(e).splitlines()[0]}); "
                       f"value-dependent Python control flow does not "
                       f"lower") from None
    return _lower_graph(gm, windows)


def lower_stage(pipeline: str, name: str, fn: Callable,
                ins: Sequence[Edge]) -> StageExpr:
    """Lower stage ``name`` of ``pipeline`` — its function ``fn`` over the
    in-edges ``ins`` (window-key order) — to a :class:`StageExpr`.
    Raises ValueError, naming the pipeline, the stage and the op, for a
    function that does not lower or exceeds the limits."""
    where = f"{pipeline}/{name}"
    if len(ins) > MAX_SRC:
        raise ValueError(f"{where}: {len(ins)} windows exceed the kernel's "
                         f"{MAX_SRC}")
    keys = tuple(window_keys(ins))
    windows = tuple((e.st, e.sh, e.sw) for e in ins)
    try:
        code, consts, n_regs, ops = _lower_cached(fn, keys, windows)
    except _Refused as e:
        raise ValueError(f"{where}: {e}") from None
    for what, n, cap in (("registers", n_regs, MAX_REGS),
                         ("instructions", len(code), MAX_INSTRS),
                         ("constants", len(consts), MAX_CONSTS)):
        if n > cap:
            raise ValueError(f"{where}: the stage function needs {n} "
                             f"{what}, over the expression body's {cap}")
    return StageExpr(operands=tuple((e.producer, e.st, e.sh, e.sw)
                                    for e in ins),
                     code=code, consts=consts, n_regs=n_regs, ops=ops)


def bare_pipeline(dag: PipelineDAG) -> PipelineDAG:
    """``dag`` with every built-in payload replaced by its own eager
    function, so that every computed stage lowers to the expression body
    (the same pixels as the payload ops, bit for bit)."""
    from .algorithms import Payload
    stages = [dataclasses.replace(s, fn=s.fn.eager)
              if isinstance(s.fn, Payload) else s
              for s in dag.stages.values()]
    return PipelineDAG(dag.name, stages, dag.edges)

