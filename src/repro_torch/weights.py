"""Parameters and optimizer state to and from the JAX package's trees.

:func:`from_jax_params` takes the JAX model's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``; this module imports no JAX)
and builds the port's :class:`~repro_torch.models.lm.LM` with the same
values: layer-stacked leaves (leading L axis, for ``jax.lax.scan``) are
split per layer, bf16 arrays keep their bits.  Dense trees carry
``layers.{attn.{wq,wk,wv,wo}, mlp.{w_gate,w_up,w_down}, ln1, ln2}``, SSM
trees ``layers.{ln, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w,
out_proj}``.

:func:`to_jax_params` is its inverse (numpy leaves, bf16 as raw 2-byte
values, :data:`repro_torch.tree.BF16_HOST`); :func:`jax_tree` lays any
per-parameter list (parameters, AdamW's master and moments) out as the
JAX tree with :class:`~repro_torch.tree.Stacked` leaves, the layout of a
checkpoint; :func:`from_jax_tree` reads such a tree back into a list in
the parameters' order.  The port's parameter ``layers.3.attn.wq`` is
layer 3 of the JAX leaf ``layers/attn/wq``; every other name is its own
leaf.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.blocks import (MAMBA_PARAMS, AttnParams, DenseLayer, MambaLayer,
                            MlpParams)
from .models.config import ModelConfig
from .models.lm import LM, _check_family
from .optim.adamw import AdamWState
from .tree import Stacked, host_array, map_leaves


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``; bf16 (``ml_dtypes``'
    bfloat16, or raw 2-byte values) keeps its 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _dense_layers(lay: Mapping[str, Any], L: int,
                  dev: torch.device) -> list[DenseLayer]:
    a, m = lay["attn"], lay["mlp"]
    return [DenseLayer(
        AttnParams(*(_tensor(a[n][i], dev) for n in ("wq", "wk", "wv", "wo"))),
        MlpParams(*(_tensor(m[n][i], dev) for n in ("w_gate", "w_up",
                                                     "w_down"))),
        _tensor(lay["ln1"][i], dev), _tensor(lay["ln2"][i], dev))
        for i in range(L)]


def _mamba_layers(lay: Mapping[str, Any], L: int,
                  dev: torch.device) -> list[MambaLayer]:
    return [MambaLayer(*(_tensor(lay[n][i], dev) for n in MAMBA_PARAMS))
            for i in range(L)]


def from_jax_params(np_tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device | str | None = None,
                    trainable: bool = False) -> LM:
    """The JAX LM's parameters (numpy leaves) as the port's module, on
    ``device`` (the card unless ``"cpu"`` is asked for); ``trainable``
    parameters require gradients."""
    _check_family(cfg)
    dev = resolve_device(device)
    lay = np_tree["layers"]
    L = cfg.n_layers
    ssm = cfg.family == "ssm"
    first = ("ln", lay["ln"]) if ssm else ("ln1", lay["ln1"])
    if np.shape(first[1])[0] != L:
        raise ValueError(f"layers.{first[0]} stacks {np.shape(first[1])[0]} "
                         f"layers, config has {L}")
    layers = (_mamba_layers if ssm else _dense_layers)(lay, L, dev)
    head = None if cfg.tie_embeddings else _tensor(np_tree["lm_head"], dev)
    return LM(_tensor(np_tree["embed"], dev), layers,
              _tensor(np_tree["final_norm"], dev),
              head).requires_grad_(trainable)


def param_names(lm: LM) -> list[str]:
    """The module's parameter names, in ``lm.parameters()`` order."""
    return [n for n, _ in lm.named_parameters()]


def jax_tree(values: Sequence[Any], names: Sequence[str]) -> dict:
    """One value per parameter (in ``names``' order) as the JAX package's
    nested dict: the L layers' values of one layer parameter become one
    :class:`~repro_torch.tree.Stacked` leaf."""
    tree: dict = {}
    stacks: dict[tuple[str, ...], dict[int, Any]] = {}
    for name, v in zip(names, values, strict=True):
        parts = name.split(".")
        if parts[0] == "layers":
            stacks.setdefault(("layers",) + tuple(parts[2:]), {})[
                int(parts[1])] = v
            continue
        _put(tree, tuple(parts), v)
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)}")
        _put(tree, path, Stacked(by_layer[i] for i in range(len(by_layer))))
    return tree


def _put(tree: dict, path: tuple[str, ...], v: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = v


def from_jax_tree(tree: Mapping[str, Any], names: Sequence[str]) -> list:
    """The inverse of :func:`jax_tree`: one value per name, in order; a
    stacked leaf (a :class:`~repro_torch.tree.Stacked` or an array with a
    leading layer axis) gives layer i to ``layers.i.*``."""
    out = []
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            node = tree
            for key in ("layers",) + tuple(parts[2:]):
                node = node[key]
            out.append(node[int(parts[1])])
        else:
            node = tree
            for key in parts:
                node = node[key]
            out.append(node)
    return out


def to_jax_params(lm: LM) -> dict:
    """The port's parameters as the JAX package's numpy tree (layers
    stacked on the host, bf16 as raw 2-byte values)."""
    return map_leaves(host_array,
                      jax_tree(list(lm.parameters()), param_names(lm)))


def opt_state_tree(state: AdamWState, names: Sequence[str]) -> AdamWState:
    """AdamW's state with its master and moments laid out as JAX trees
    (:func:`jax_tree`): the checkpoint's ``opt`` layout."""
    return AdamWState(step=state.step,
                      **{f: jax_tree(getattr(state, f), names)
                         for f in ("master", "m", "v")})


def opt_state_from_tree(tree: Any, names: Sequence[str]) -> AdamWState:
    """The inverse of :func:`opt_state_tree` (any object with ``step``,
    ``master``, ``m`` and ``v``): lists in ``names``' order."""
    return AdamWState(step=tree.step,
                      **{f: from_jax_tree(getattr(tree, f), names)
                         for f in ("master", "m", "v")})


def to_jax_opt_state(state: AdamWState, lm: LM) -> AdamWState:
    """AdamW's state as the JAX package's ``AdamWState`` layout, numpy
    leaves (the step a () int32 array)."""
    return map_leaves(host_array, opt_state_tree(state, param_names(lm)))


def from_jax_opt_state(np_state: Any, lm: LM, *,
                       device: torch.device | str | None = None
                       ) -> AdamWState:
    """The JAX package's ``AdamWState`` (numpy leaves) as the port's, in
    ``lm``'s parameter order, on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    on_dev = map_leaves(lambda a: _tensor(a, dev), np_state)
    return opt_state_from_tree(on_dev, param_names(lm))
