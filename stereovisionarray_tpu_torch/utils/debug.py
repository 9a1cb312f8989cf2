"""Numeric-safety and determinism harness (twin of
``stereovisionarray_tpu/utils/debug.py``).

* :func:`checked` raises at the first op that makes a NaN out of inputs that
  had none, or that divides by zero, and names the op, instead of letting the
  NaN poison the stages after it (the reference's ``checkify.float_checks``);
* :func:`assert_deterministic` runs a function again (and any variants of
  it) and demands bit-identical results, the property the golden tests rely
  on;
* :func:`find_nonfinite` maps each floating leaf of a state tree that holds
  NaN or Inf to its count, under the key string ``jax.tree_util.keystr``
  gives the same leaf (``['a']``, ``[0]``, ``.depth``).

Trees are nested tuples, lists, dicts (walked in sorted key order, as JAX
walks them), NamedTuples and dataclasses; None holds no leaf; anything else
is a leaf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["FloatCheckError", "assert_deterministic", "checked", "find_nonfinite",
           "leaves_with_paths"]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _sorted_keys(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError:  # keys of mixed types keep their order
        return list(d)


def leaves_with_paths(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key string, leaf) for every leaf of `tree`, in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in _sorted_keys(tree):
            yield from leaves_with_paths(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_paths(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_paths(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------- #
class FloatCheckError(FloatingPointError):
    """An op under :func:`checked` made a NaN or divided by zero."""


# ops whose second operand (the first for reciprocal) divides
_DIVISIONS = frozenset({"div", "div_", "true_divide", "true_divide_", "floor_divide",
                        "floor_divide_", "remainder", "remainder_", "fmod", "fmod_"})
_RECIPROCALS = frozenset({"reciprocal", "reciprocal_"})


def _has_nan(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and x.numel() > 0 and bool(torch.isnan(x).any())
    return isinstance(x, float) and x != x


def _has_zero(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.numel() > 0 and bool((x == 0).any())
    return isinstance(x, (int, float)) and x == 0


class _FloatChecks(TorchDispatchMode):
    def __init__(self, errors) -> None:
        super().__init__()
        self.errors = errors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if "div" in self.errors and (name in _DIVISIONS or name in _RECIPROCALS):
            divisor = args[0] if name in _RECIPROCALS else args[1]
            if _has_zero(divisor):
                raise FloatCheckError(f"division by zero in {func}")
        nan_in = "nan" in self.errors and any(
            _has_nan(a) for _, a in leaves_with_paths((args, kwargs)))
        out = func(*args, **kwargs)
        if "nan" in self.errors and not nan_in and any(
                _has_nan(o) for _, o in leaves_with_paths(out)):
            raise FloatCheckError(f"NaN generated by {func}")
        return out


def checked(fn: Callable, errors: Optional[Sequence[str]] = None) -> Callable:
    """Wrap `fn` so that the first op that makes a NaN from inputs without
    one, or that divides by zero, raises :class:`FloatCheckError` naming the
    op (``errors``: a subset of ``("nan", "div")``, both by default).
    Out-of-range indexing raises in PyTorch already.

    Every op under the wrapper is checked as it runs, by a
    ``TorchDispatchMode`` that reads each op's inputs and outputs back to the
    host: on the card every op waits for the stream. It is a debugging tool.

    >>> safe = checked(two_view_disparity)        # doctest: +SKIP
    >>> out = safe(left, right)  # raises on an internal NaN  # doctest: +SKIP
    """
    kinds = frozenset(("nan", "div") if errors is None else errors)
    unknown = kinds - {"nan", "div"}
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; expected 'nan' and/or 'div'")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks(kinds):
            return fn(*args, **kwargs)

    wrapper.__name__ = f"checked_{getattr(fn, '__name__', 'fn')}"
    return wrapper


def assert_deterministic(
    fn: Callable,
    *args: Any,
    runs: int = 2,
    variants: Optional[Sequence[Callable[[], Any]]] = None,
) -> Any:
    """Run `fn(*args)` `runs` times (plus once per `variant` thunk) and assert
    that every result is BIT-identical to the first (NaNs equal to NaNs).
    Returns the first result.

    variants: zero-argument callables computing the same thing another way
    (e.g. the same pipeline with another backend)."""
    first = fn(*args)
    ref = [(p, _host(leaf)) for p, leaf in leaves_with_paths(first)]

    def compare(result, label):
        got = [(p, _host(leaf)) for p, leaf in leaves_with_paths(result)]
        if [p for p, _ in got] != [p for p, _ in ref]:
            raise AssertionError(f"nondeterministic result ({label}): tree "
                                 f"{[p for p, _ in got]} vs {[p for p, _ in ref]}")
        for i, ((path, a), (_, b)) in enumerate(zip(ref, got)):
            nan = np.issubdtype(a.dtype, np.inexact) and np.issubdtype(b.dtype, np.inexact)
            if not np.array_equal(a, b, equal_nan=nan):
                diff = int(np.sum(a != b)) if a.shape == b.shape else a.size
                wide = (np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
                        if a.shape == b.shape else "shape")
                raise AssertionError(
                    f"nondeterministic result ({label}): leaf {i} {path or '(root)'} "
                    f"differs in {diff} elements (max abs diff {wide})")

    for r in range(1, runs):
        compare(fn(*args), f"run {r}")
    for i, thunk in enumerate(variants or []):
        compare(thunk(), f"variant {i}")
    return first


def find_nonfinite(tree: Any) -> dict:
    """Map leaf path -> count of non-finite values over the floating leaves,
    for the post-mortem of a poisoned pipeline state (empty: all finite)."""
    out = {}
    for path, leaf in leaves_with_paths(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            bad = int((~np.isfinite(arr)).sum())
            if bad:
                out[path] = bad
    return out
