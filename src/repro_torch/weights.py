"""Parameters and optimizer state to and from the JAX package's trees.

:func:`from_jax_params` takes the JAX model's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``; this module imports no JAX)
and builds the port's :class:`~repro_torch.models.lm.LM` with the same
values: layer-stacked leaves (leading L axis, for ``jax.lax.scan``) are
split per layer, bf16 arrays keep their bits.  Dense trees carry
``layers.{attn.{wq,wk,wv,wo}, mlp.{w_gate,w_up,w_down}, ln1, ln2}``, MoE
trees the same with ``moe.{router,w_gate,w_up,w_down}`` (the router f32)
in place of ``mlp``, SSM trees ``layers.{ln, in_proj, conv_w, conv_b,
A_log, D, dt_bias, norm_w, out_proj}``, hybrid trees the SSM layers and
one unstacked dense layer ``shared_attn``; a VLM's tree adds
``projector.{w1,w2}``.  An enc-dec tree (:class:`~repro_torch.models.
encdec.EncDec`) stacks two layer lists, ``enc_layers`` (dense layers) and
``dec_layers`` (``attn``, ``cross``, ``mlp``, ``ln1``-``ln3``), beside
``embed``, ``enc_norm``, ``final_norm``, ``lm_head`` and ``frame_proj``.

:func:`shard_params` gives one rank of a serving mesh its shards, from
such a tree or from a whole ``LM`` or ``EncDec``; :func:`init_sharded`
draws them from a seed as ``ModelApi.init`` does, holding no more than one
layer whole.
Given a ``CodesignPlan`` both cut a training mesh's blocks instead
(``sharding.rank_spec``: FSDP's data entries where the plan asks for
them).

:func:`to_jax_params` is its inverse (numpy leaves, bf16 as raw 2-byte
values, :data:`repro_torch.tree.BF16_HOST`); :func:`jax_tree` lays any
per-parameter list (parameters, AdamW's master and moments) out as the
JAX tree with :class:`~repro_torch.tree.Stacked` leaves, the layout of a
checkpoint; :func:`from_jax_tree` reads such a tree back into a list in
the parameters' order.  The port's parameter ``layers.3.attn.wq`` is
layer 3 of the JAX leaf ``layers/attn/wq`` (so are ``enc_layers.*`` and
``dec_layers.*`` of theirs); every other name is its own leaf.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.blocks import (MAMBA_PARAMS, MOE_PARAMS, AttnParams, DenseLayer,
                            MambaLayer, MlpParams, MoeLayer, MoeParams,
                            _param)
from .models.config import ModelConfig
from .models.encdec import DecLayer, EncDec
from .models.lm import LM, Projector, _check_family
from .optim.adamw import AdamWState
from .parallel.sharding import plan_fsdp, rank_spec, shard_tensor
from .tree import (Stacked, flatten_with_paths, host_array, map_leaves,
                   unflatten)


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


def _dense_layer(lay: Mapping[str, Any], dev: torch.device,
                 i: int | None = None) -> DenseLayer:
    """A dense layer's subtree as a ``DenseLayer``: layer ``i`` of stacked
    leaves, or the leaves themselves when ``i`` is None (``shared_attn``)."""
    at = (lambda a: a) if i is None else (lambda a: a[i])
    a, m = lay["attn"], lay["mlp"]
    return DenseLayer(
        AttnParams(*(_tensor(at(a[n]), dev)
                     for n in ("wq", "wk", "wv", "wo"))),
        MlpParams(*(_tensor(at(m[n]), dev)
                    for n in ("w_gate", "w_up", "w_down"))),
        _tensor(at(lay["ln1"]), dev), _tensor(at(lay["ln2"]), dev))


def _attn(a: Mapping[str, Any], dev: torch.device, i: int) -> AttnParams:
    return AttnParams(*(_tensor(a[n][i], dev)
                        for n in ("wq", "wk", "wv", "wo")))


def _dense_layers(lay: Mapping[str, Any], L: int,
                  dev: torch.device) -> list[DenseLayer]:
    return [_dense_layer(lay, dev, i) for i in range(L)]


def _dec_layers(lay: Mapping[str, Any], L: int,
                dev: torch.device) -> list[DecLayer]:
    m = lay["mlp"]
    return [DecLayer(
        _attn(lay["attn"], dev, i), _attn(lay["cross"], dev, i),
        MlpParams(*(_tensor(m[n][i], dev)
                    for n in ("w_gate", "w_up", "w_down"))),
        *(_tensor(lay[n][i], dev) for n in ("ln1", "ln2", "ln3")))
        for i in range(L)]


def _n_stacked(lay: Mapping[str, Any], key: str, name: str, L: int) -> None:
    n = np.shape(lay[name])[0]
    if n != L:
        raise ValueError(f"{key}.{name} stacks {n} layers, config has {L}")


def _moe_layers(lay: Mapping[str, Any], L: int,
                dev: torch.device) -> list[MoeLayer]:
    m = lay["moe"]
    return [MoeLayer(
        _attn(lay["attn"], dev, i),
        MoeParams(*(_tensor(m[n][i], dev) for n in MOE_PARAMS)),
        _tensor(lay["ln1"][i], dev), _tensor(lay["ln2"][i], dev))
        for i in range(L)]


def _mamba_layers(lay: Mapping[str, Any], L: int,
                  dev: torch.device) -> list[MambaLayer]:
    return [MambaLayer(*(_tensor(lay[n][i], dev) for n in MAMBA_PARAMS))
            for i in range(L)]


def from_jax_params(np_tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device | str | None = None,
                    trainable: bool = False) -> LM | EncDec:
    """The JAX model's parameters (numpy leaves) as the port's module, on
    ``device`` (the card unless ``"cpu"`` is asked for); ``trainable``
    parameters require gradients."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        enc, dec = np_tree["enc_layers"], np_tree["dec_layers"]
        _n_stacked(enc, "enc_layers", "ln1", cfg.enc_layers)
        _n_stacked(dec, "dec_layers", "ln1", cfg.n_layers)
        t = lambda name: _tensor(np_tree[name], dev)
        return EncDec(t("embed"), _dense_layers(enc, cfg.enc_layers, dev),
                      _dec_layers(dec, cfg.n_layers, dev), t("enc_norm"),
                      t("final_norm"), t("lm_head"),
                      t("frame_proj")).requires_grad_(trainable)
    _check_family(cfg)
    lay = np_tree["layers"]
    L = cfg.n_layers
    ssm = cfg.family in ("ssm", "hybrid")
    _n_stacked(lay, "layers", "ln" if ssm else "ln1", L)
    build_layers = (_mamba_layers if ssm else
                    _moe_layers if cfg.family == "moe" else _dense_layers)
    layers = build_layers(lay, L, dev)
    head = None if cfg.tie_embeddings else _tensor(np_tree["lm_head"], dev)
    shared = (_dense_layer(np_tree["shared_attn"], dev)
              if cfg.family == "hybrid" else None)
    projector = (Projector(*(_tensor(np_tree["projector"][n], dev)
                             for n in ("w1", "w2")))
                 if cfg.frontend else None)
    return LM(_tensor(np_tree["embed"], dev), layers,
              _tensor(np_tree["final_norm"], dev), head, shared,
              projector).requires_grad_(trainable)


#: the names of layer-stacked parameter lists (a leading L axis in JAX)
STACKED = ("layers", "enc_layers", "dec_layers")


def param_spec(name: str, shape: tuple[int, ...], cfg: ModelConfig, mesh,
               plan=None) -> tuple:
    """What this rank holds of parameter ``name`` (a port name or a JAX
    path; a stacked leaf's leading layer dim stays whole): a serving
    mesh's block without a plan, a training mesh's under ``plan``
    (``sharding.rank_spec``)."""
    return rank_spec(name, tuple(shape), cfg, mesh,
                     fsdp=plan is not None and plan_fsdp(plan))


def _shard_leaf(name: str, a, cfg: ModelConfig, mesh, plan=None):
    """``a``'s block on this rank (:func:`param_spec`)."""
    spec = param_spec(name, tuple(a.shape), cfg, mesh, plan)
    return a if not any(spec) else shard_tensor(a, spec, mesh)


def shard_params(src: Any, cfg: ModelConfig, mesh, *,
                 device: torch.device | str | None = None, plan=None,
                 trainable: bool = False) -> LM | EncDec:
    """This rank's ``LM`` (or ``EncDec``): every parameter cut to the block
    :func:`param_spec` gives the rank (a serving mesh's without a plan, a
    training mesh's under ``plan``).  ``src`` is the JAX model's parameter
    tree (numpy leaves: each leaf is cut first, then built on ``device``
    by :func:`from_jax_params`), or a whole model, whose tensors the
    result views (no copy; a head-wise Mamba2 leaf is copied,
    ``sharding.shard_tensor``).  ``trainable`` shards require gradients."""
    if isinstance(src, (LM, EncDec)):
        memo = {id(p): _param(_shard_leaf(n, p.data, cfg, mesh, plan))
                for n, p in src.named_parameters()}
        return copy.deepcopy(src, memo).requires_grad_(trainable)
    return from_jax_params(unflatten(src, [
        _shard_leaf(path, np.asarray(a), cfg, mesh, plan)
        for path, a in flatten_with_paths(src)]), cfg, device=device,
        trainable=trainable)


def init_sharded(cfg: ModelConfig, seed: int, mesh, *,
                 device: torch.device | str | None = None, plan=None,
                 trainable: bool = False) -> LM | EncDec:
    """This rank's shards (:func:`param_spec`) of the parameters
    ``ModelApi.init(seed)`` draws on ``device`` (the same generator, the
    same draws): each parameter is cut to its block as it is drawn
    (``init_lm(keep=...)``, ``init_encdec(keep=...)``), so the rank holds
    its shards and at most one layer whole, never the model."""
    from .models.api import build
    dev = resolve_device(device)

    def keep(name, t):
        out = _shard_leaf(name, t, cfg, mesh, plan)
        return out if out is t else out.clone()
    return build(cfg).init(seed, device=dev, keep=keep, trainable=trainable)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's whole shape by port name, from an init on the
    ``meta`` device (no memory)."""
    from .models.encdec import init_encdec
    from .models.lm import init_lm
    init = init_encdec if cfg.family == "encdec" else init_lm
    lm = init(cfg, generator=torch.Generator(), device="meta")
    return {n: tuple(p.shape) for n, p in lm.named_parameters()}


def param_names(lm: LM | EncDec) -> list[str]:
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
        if parts[0] in STACKED:
            stacks.setdefault((parts[0],) + tuple(parts[2:]), {})[
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
    leading layer axis) gives layer i to ``layers.i.*`` (and to
    ``enc_layers.i.*``, ``dec_layers.i.*``)."""
    out = []
    for name in names:
        parts = name.split(".")
        if parts[0] in STACKED:
            node = tree
            for key in (parts[0],) + tuple(parts[2:]):
                node = node[key]
            out.append(node[int(parts[1])])
        else:
            node = tree
            for key in parts:
                node = node[key]
            out.append(node)
    return out


def to_jax_params(lm: LM | EncDec) -> dict:
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
