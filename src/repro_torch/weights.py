"""Parameters from the JAX package's tree.

:func:`from_jax_params` takes the JAX model's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``; this module imports no JAX)
and builds the port's :class:`~repro_torch.models.lm.LM` with the same
values: layer-stacked leaves (leading L axis, for ``jax.lax.scan``) are
split per layer, bf16 arrays keep their bits.  Dense trees carry
``layers.{attn.{wq,wk,wv,wo}, mlp.{w_gate,w_up,w_down}, ln1, ln2}``, SSM
trees ``layers.{ln, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_w,
out_proj}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.blocks import (MAMBA_PARAMS, AttnParams, DenseLayer, MambaLayer,
                            MlpParams)
from .models.config import ModelConfig
from .models.lm import LM, _check_family


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same 16 bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
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
                    device: torch.device | str | None = None) -> LM:
    """The JAX LM's parameters (numpy leaves) as the port's module, on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
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
              _tensor(np_tree["final_norm"], dev), head)
