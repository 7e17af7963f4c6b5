"""Sharding rules: parameter names -> partition specs, and a rank's shard.

The JAX package's rules (MaxText-style, resolved against the production
mesh), copied rule for rule:

* batch over the data axes ``("pod", "data")`` / ``("data",)``,
* attention heads / FFN hidden / experts / vocab over ``"model"`` (TP/EP),
* the *other* weight dim additionally over ``"data"`` (FSDP / ZeRO-3) when
  ``fsdp=True``,
* every rule checks divisibility and drops an axis that does not divide.

A spec is a tuple with one entry per dim, as a ``PartitionSpec`` is: an
axis name, a tuple of axis names, or None.  The rules key on the JAX
package's tree path (``layers/attn/wq``); :func:`jax_path` gives it for a
port parameter name (``layers.3.attn.wq``, one layer of the stacked leaf).
A leaf's trailing dims take the rule, so the port's per-layer tensor takes
the stacked leaf's spec without its leading layer entry.

The rules read only ``mesh.shape`` (a dict of axis sizes) and
``mesh.axis_names``; a :class:`repro_torch.launch.mesh.Mesh` made with
``Mesh.abstract`` serves where no world exists.

:func:`shard_tensor` cuts this rank's contiguous block out of a full
tensor.  What a rank holds (:func:`rank_spec`) is the rule table's spec,
with FSDP's ``"data"`` entries on a training mesh whose plan shards that
way (the JAX package's ``param_shardings(..., fsdp=)``), and with one
change: a head is never split.  Where the table would cut the heads'
``H * hd`` dim at a point inside a head (``_fit`` checks only that
``H * hd`` divides), the rank holds that weight whole over the model axis
and computes it whole, with the same values.  A Mamba2 layer's weights
take a head-wise layout (:class:`Segments`, :func:`rank_spec`) in place of
the table's contiguous cuts, and an enc-dec's ``frame_proj`` is held whole
over the model axis.  The AdamW master and moments take their parameter's
spec.  A :class:`NamedSharding` (a mesh
and a spec) is one leaf of a tree of shardings, as the JAX class of that
name is (``load_checkpoint``'s ``shardings=``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

from repro_torch.models.config import ModelConfig

#: the layer-stacked parameter lists (a leading L axis in the JAX tree)
STACKED = ("layers", "enc_layers", "dec_layers")

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry for a dim made of consecutive segments (whole sizes
    ``sizes``): the segments with ``split`` set are cut over ``axis``, rank
    ``i`` holding block ``i`` of each, and the others are held whole on
    every rank.  A rank's block of the dim is its share of each segment,
    in segment order.  The head-wise layout of a Mamba2 projection: the
    rank holds its heads' columns of z, x and dt, and all of B and C."""

    axis: str
    sizes: tuple[int, ...]
    split: tuple[bool, ...]

    def whole(self) -> int:
        return sum(self.sizes)

    def widths(self, n: int) -> list[int]:
        """Each segment's width in one rank's block, over ``n`` ranks."""
        for size, cut in zip(self.sizes, self.split):
            if cut and size % n:
                raise ValueError(f"segment {size} does not split over "
                                 f"{self.axis} ({n})")
        return [size // n if cut else size
                for size, cut in zip(self.sizes, self.split)]

    def index(self, i: int, n: int) -> list[int]:
        """The positions in the whole dim of rank ``i``'s block."""
        out, lo = [], 0
        for size, cut, w in zip(self.sizes, self.split, self.widths(n)):
            start = lo + (i * w if cut else 0)
            out += range(start, start + w)
            lo += size
        return out

    def join(self, blocks, dim: int):
        """The whole dim from the ranks' blocks (in rank order) along
        ``dim``: each split segment's blocks in rank order, each whole
        segment rank 0's copy."""
        import torch
        pieces, lo = [], 0
        for cut, w in zip(self.split, self.widths(len(blocks))):
            pieces += [b.narrow(dim, lo, w) for b in
                       (blocks if cut else blocks[:1])]
            lo += w
        return torch.cat(pieces, dim)


def batch_axes_of(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _fit(mesh, shape: tuple[int, ...], want: tuple) -> Spec:
    """Drop axes that don't divide their dim."""
    out = []
    for dim, axis in zip(shape, want):
        if axis is None:
            out.append(None)
            continue
        size = _axis_size(mesh, axis)
        out.append(axis if (size > 1 and dim % size == 0) else None)
    return tuple(out)


def _spec_for(path: str, shape: tuple[int, ...], cfg: ModelConfig, mesh, *,
              fsdp: bool, ep: bool) -> Spec:
    """Rule table keyed on the trailing parameter name."""
    d = "data" if fsdp else None
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""
    nd = len(shape)

    def tail(*axes):
        """Right-align axes against shape (stacked-L leading dims -> None)."""
        want = [None] * (nd - len(axes)) + list(axes)
        return _fit(mesh, shape, tuple(want))

    if name == "embed":
        return tail("model", d)
    if name == "lm_head":
        return tail(d, "model")
    if name in ("wq", "wk", "wv"):
        return tail(d, "model")
    if name == "wo":
        return tail("model", d)
    if parent == "moe" or (parent in ("", "moe") and name == "router"):
        if name == "router":
            return tail(d, None)
        if name in ("w_gate", "w_up"):
            return tail("model", d, None) if ep else tail(None, d, "model")
        if name == "w_down":
            return tail("model", None, d) if ep else tail(None, "model", d)
    if name in ("w_gate", "w_up"):
        return tail(d, "model")
    if name == "w_down":
        return tail("model", d)
    if name == "in_proj":
        return tail(d, "model")
    if name == "out_proj":
        return tail("model", d)
    if name == "conv_w":
        return tail(None, "model")
    if name in ("conv_b", "A_log", "D", "dt_bias", "norm_w"):
        return tail("model")
    if name in ("w1",):       # projector
        return tail(d, "model")
    if name in ("w2",):
        return tail("model", d)
    if name == "frame_proj":
        return tail(d, "model")
    # norms / scalars / step counters
    return (None,) * nd


def jax_path(name: str) -> str:
    """The JAX tree path of a port parameter name: ``layers.3.attn.wq`` ->
    ``layers/attn/wq`` (layer 3 of the stacked leaf)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def _ep(cfg: ModelConfig, mesh) -> bool:
    return bool(cfg.moe and cfg.moe.n_experts % mesh.shape["model"] == 0)


def param_specs(shapes: Mapping[str, tuple[int, ...]], cfg: ModelConfig,
                mesh, *, fsdp: bool = True) -> dict[str, Spec]:
    """The spec of every parameter (or any state whose entries mirror the
    parameters, e.g. Adam moments), by port name: ``shapes`` maps each
    name to its shape (``{n: p.shape for n, p in lm.named_parameters()}``)."""
    ep = _ep(cfg, mesh)
    return {n: _spec_for(jax_path(n), tuple(s), cfg, mesh, fsdp=fsdp, ep=ep)
            for n, s in shapes.items()}


def param_shardings(shapes: Mapping[str, tuple[int, ...]], cfg: ModelConfig,
                    mesh, *, fsdp: bool = True) -> dict[str, tuple]:
    """Where each parameter's block lies on this rank of ``mesh``: the
    slices of the full tensor under :func:`param_specs` (what a JAX
    ``NamedSharding`` resolves to on one device)."""
    specs = param_specs(shapes, cfg, mesh, fsdp=fsdp)
    return {n: shard_slices(tuple(shapes[n]), specs[n], mesh) for n in specs}


def state_shardings(state: Any, names: list[str], cfg: ModelConfig, mesh,
                    *, fsdp: bool = True) -> Any:
    """Specs for an ``AdamWState``: its master, m and v lists mirror the
    parameters (``names``, in ``lm.parameters()`` order), so each entry
    takes its parameter's spec; the step counter is replicated."""
    from repro_torch.optim.adamw import AdamWState
    out = {}
    for field in ("master", "m", "v"):
        shapes = {n: tuple(t.shape) for n, t in zip(names, getattr(state,
                                                                   field))}
        specs = param_specs(shapes, cfg, mesh, fsdp=fsdp)
        out[field] = [specs[n] for n in names]
    return AdamWState(step=(), **out)


def batch_specs(batch: Mapping[str, Any], mesh) -> dict[str, Spec]:
    """Batch entries: the leading dim over the data axes."""
    axes = batch_axes_of(mesh)
    return {k: (axes,) + (None,) * (len(v.shape) - 1)
            for k, v in batch.items()}


def _heads_whole(path: str, cfg: ModelConfig, mesh) -> bool:
    """Whether an attention weight is held whole over the model axis (no
    head split, module docstring): ``wq`` / ``wo`` unless the query heads
    divide the model axis, ``wk`` / ``wv`` unless the query and the KV
    heads both do."""
    leaf = path.split("/")[-1]
    if leaf not in ("wq", "wk", "wv", "wo"):
        return False
    m = mesh.shape["model"]
    split = m > 1 and cfg.n_heads % m == 0
    if leaf in ("wk", "wv"):
        split = split and cfg.n_kv_heads % m == 0
    return not split


def plan_fsdp(plan) -> bool:
    """Whether a ``CodesignPlan`` shards the weights over the data axis
    too (the JAX package's ``fsdp=plan.sharding in ("fsdp",
    "fsdp_tp")``)."""
    return plan.sharding in ("fsdp", "fsdp_tp")


def rank_spec(name: str, shape: tuple[int, ...], cfg: ModelConfig, mesh,
              *, fsdp: bool = False) -> Spec:
    """What a rank of ``mesh`` holds of parameter ``name`` (a port name, or
    a JAX tree path: its trailing dims take the rule; on a training mesh
    also of its AdamW master and moments): the rule table's spec, with
    FSDP's ``"data"`` entries when ``fsdp``.  Its ``"model"`` entries
    stand whatever the plan (a model axis of 1 drops them, as ``_fit``
    does), but a head is never split: an attention weight that
    :func:`_heads_whole` names keeps only its ``"data"`` entry."""
    path = jax_path(name)
    spec = _spec_for(path, tuple(shape), cfg, mesh, fsdp=fsdp,
                     ep=_ep(cfg, mesh))
    leaf = path.split("/")[-1]
    if _heads_whole(path, cfg, mesh) or leaf == "frame_proj":
        spec = tuple(None if a == "model" else a for a in spec)
    if cfg.ssm is not None and leaf in _MAMBA_HEAD_LEAVES:
        spec = _head_wise(leaf, spec, cfg, mesh)
    return spec


#: a Mamba2 layer's weights that follow its SSD heads
_MAMBA_HEAD_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D",
                      "dt_bias", "norm_w", "out_proj")


def _head_wise(leaf: str, spec: Spec, cfg: ModelConfig, mesh) -> Spec:
    """A Mamba2 leaf's spec under the head-wise layout: the table's
    ``"model"`` entries give way to the rank's heads.  ``in_proj``'s
    columns are [z | x | B | C | dt] and ``conv_w`` / ``conv_b``'s channels
    [x | B | C]: the rank holds its heads' columns of z, x and dt and all
    of B and C (:class:`Segments`); ``A_log``, ``D``, ``dt_bias`` and
    ``norm_w`` split by head, ``out_proj``'s rows too.  Where the heads do
    not divide the model axis the rank holds every head.  Data entries
    stand."""
    spec = [None if a == "model" else a for a in spec]
    m = mesh.shape["model"]
    if m == 1 or cfg.ssm_heads % m:
        return tuple(spec)
    di, gn, H = cfg.d_inner, 2 * cfg.ssm.n_groups * cfg.ssm.d_state, \
        cfg.ssm_heads
    if leaf == "in_proj":
        spec[-1] = Segments("model", (di, di, gn, H),
                            (True, True, False, True))
    elif leaf in ("conv_w", "conv_b"):
        spec[-1] = Segments("model", (di, gn), (True, False))
    elif leaf == "out_proj":
        spec[-2] = "model"
    else:
        spec[-1] = "model"
    return tuple(spec)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes a spec splits over, in the order its entries name
    them."""
    out: list[str] = []
    for a in spec:
        if isinstance(a, Segments):
            a = a.axis
        out += [] if a is None else [a] if isinstance(a, str) else list(a)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf of a tree of shardings: the block of a whole leaf that this
    rank of ``mesh`` holds under ``spec`` (a stacked leaf's spec has a
    leading None for its layer axis)."""

    mesh: Any = dataclasses.field(compare=False, repr=False)
    spec: Spec = ()

    def slices(self, shape: tuple[int, ...]) -> tuple[slice, ...]:
        return shard_slices(tuple(shape), self.spec, self.mesh)


def shard_slices(shape: tuple[int, ...], spec: Spec, mesh) -> tuple:
    """This rank's block of a tensor of ``shape`` under ``spec``: a slice
    per dim, or for a :class:`Segments` dim the list of its positions."""
    out: list = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis is None:
            out.append(slice(None))
            continue
        if isinstance(axis, Segments):
            if dim != axis.whole():
                raise ValueError(f"dim {dim} is not the segments' "
                                 f"{axis.whole()}")
            out.append(axis.index(mesh.axis_index(axis.axis),
                                  mesh.axis_size(axis.axis)))
            continue
        n = mesh.axis_size(axis)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axis} ({n})")
        size = dim // n
        i = mesh.axis_index(axis)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def unshard(t, spec: Spec, mesh):
    """The inverse of :func:`shard_tensor`: the whole tensor of which ``t``
    is this rank's block under ``spec``, gathered dim by dim over each
    split dim's axes.  Every rank of ``mesh`` calls it (collectives)."""
    from repro_torch.parallel.collectives import all_gather
    for dim, axis in enumerate(spec):
        if isinstance(axis, Segments):
            n = mesh.axis_size(axis.axis)
            t = axis.join(all_gather(t, mesh, axis.axis, dim).chunk(n, dim),
                          dim)
        elif axis is not None:
            t = all_gather(t, mesh, axis, dim)
    return t


def norm_weight(spec: Spec, mesh, device=None):
    """The weights of a block's squared entries in the global gradient
    norm (``optim.adamw.clip_by_global_norm``'s ``norm_weights``): None
    unless a dim is a :class:`Segments` one, whose whole segments, held
    alike by every rank of its axis, weigh one over that axis's size
    there, so that their sum over the axis counts them once."""
    import torch
    for dim, a in enumerate(spec):
        if isinstance(a, Segments):
            n = mesh.axis_size(a.axis)
            w = torch.cat([torch.full((width,), 1.0 if cut else 1.0 / n,
                                      device=device)
                           for cut, width in zip(a.split, a.widths(n))])
            return w.reshape((-1,) + (1,) * (len(spec) - 1 - dim))
    return None


def whole_shape(shape: tuple[int, ...], spec: Spec, mesh) -> tuple:
    """The whole tensor's shape of which a block of ``shape`` is a rank's
    under ``spec``."""
    return tuple(a.whole() if isinstance(a, Segments) else
                 n * mesh.axis_size(a) if a is not None else n
                 for n, a in zip(shape, tuple(spec) + (None,) * len(shape)))


def shard_tensor(full, spec: Spec, mesh):
    """This rank's block of ``full`` (a tensor or an array) under ``spec``:
    along each sharded dim, block ``i`` of ``n``, where ``i`` is the rank's
    index along the dim's axes (of each split segment of a
    :class:`Segments` dim).  A view where ``full`` allows: not with
    segments, which copy."""
    return full[shard_slices(tuple(full.shape), spec, mesh)]
