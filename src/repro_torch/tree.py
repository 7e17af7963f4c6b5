"""Trees of tensors in the JAX package's layout, without JAX.

A checkpoint of the JAX package is a flattened pytree: leaves in JAX's
order (dict keys sorted, a NamedTuple's fields in their order), each named
by its path (``"params/layers/attn/wq"``, ``"opt/.m/embed"``: a NamedTuple
field's path entry prints as ``.field``).  :func:`flatten_with_paths` walks
dicts, NamedTuples, lists and tuples the same way, so the port writes and
reads the same leaves under the same names.

The JAX package stacks each layer's parameter over a leading L axis; the
port keeps one tensor per layer.  A :class:`Stacked` leaf holds the L
tensors of one such JAX leaf and stands for their stack: it is stacked
only on the host (:func:`host_array`), never on the card.

bf16 has no numpy dtype without ``ml_dtypes``; on the host a bf16 tensor
is its raw 2-byte values (numpy void ``V2``), which is also how ``np.save``
stores the JAX package's bf16 arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

#: numpy dtype holding bf16 bits on the host
BF16_HOST = np.dtype("V2")


class Stacked(tuple):
    """The per-layer tensors (same shape and dtype) of one JAX leaf that
    stacks them over a leading layer axis."""

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self),) + tuple(self[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    @property
    def device(self) -> torch.device:
        return self[0].device


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """(path string, leaf) in JAX's leaf order.  A leaf is anything but a
    dict, NamedTuple, list or tuple; a :class:`Stacked` is one leaf; None
    holds no leaf."""
    out: list[tuple[str, Any]] = []

    def walk(node: Any, path: tuple[str, ...]) -> None:
        if node is None:
            return
        if isinstance(node, Stacked):
            out.append(("/".join(path), node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_namedtuple(node):
            for name in node._fields:
                walk(getattr(node, name), path + ("." + name,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def unflatten(like: Any, leaves: list[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in JAX's order."""
    it: Iterator[Any] = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, Stacked):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, n))
                                for n in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    return unflatten(tree, [fn(v) for _, v in flatten_with_paths(tree)])


def dtype_name(leaf: Any) -> str:
    """The leaf's dtype as the JAX package's manifest names it; raw
    2-byte values (:data:`BF16_HOST`) are bf16."""
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return "bfloat16" if np.dtype(dt) == BF16_HOST else str(np.dtype(dt))


def _host_view(t: torch.Tensor) -> torch.Tensor:
    """A host tensor's values as a dtype numpy has (bf16 as int16 bits)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _numpy(t: torch.Tensor) -> np.ndarray:
    a = _host_view(t).numpy()
    return a.view(BF16_HOST) if t.dtype == torch.bfloat16 else a


def host_array(leaf: Any) -> np.ndarray:
    """A leaf as one host array of its own: a tensor copied, a
    :class:`Stacked` leaf copied layer by layer into its slice of one
    array, bf16 as raw 2-byte values (:data:`BF16_HOST`)."""
    if isinstance(leaf, Stacked):
        first = leaf[0]
        out = torch.empty(leaf.shape, dtype=first.dtype)
        view = _host_view(out)
        with torch.no_grad():
            for i, t in enumerate(leaf):
                view[i].copy_(_host_view(t.detach()))
        return _numpy(out)
    if isinstance(leaf, torch.Tensor):
        # always a copy: a training step updates the parameters in place
        host = torch.empty(leaf.shape, dtype=leaf.dtype)
        _host_view(host).copy_(_host_view(leaf.detach()))
        return _numpy(host)
    return np.asarray(leaf)


def from_host(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A host array written by :func:`host_array` (or ``np.load`` of the
    JAX package's shard, or an ``ml_dtypes`` bf16 array) as a CPU tensor
    of the manifest's dtype, sharing the array's memory where it can."""
    bf16 = arr.dtype.kind == "V" or arr.dtype.name == "bfloat16"
    if bf16:
        if dtype_str != "bfloat16" or arr.dtype.itemsize != 2:
            raise TypeError(f"no torch dtype for raw {arr.dtype} values "
                            f"named {dtype_str!r}")
        arr = np.ascontiguousarray(arr).view(np.int16)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if bf16 else t
