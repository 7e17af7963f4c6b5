"""The port's configuration copies equal the JAX package's, field by field,
and its framework-free core copies plan exactly as the originals do."""

import dataclasses

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import list_archs as jlist_archs
from repro.core import basin as jbasin
from repro.core import planner as jplanner

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import basin, planner

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "repro-100m", "mamba2-1.3b", "gemma3-1b",
         "zamba2-1.2b", "qwen3-moe-30b-a3b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2", "phi3-mini-3.8b", "mixtral-8x22b",
         "mistral-large-123b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_equal_reference(arch, smoke):
    got = get_smoke_config(arch) if smoke else get_config(arch)
    want = jget_smoke(arch) if smoke else jget_config(arch)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("hd", "q_dim", "kv_dim", "d_inner", "ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.layer_windows() == want.layer_windows()
    assert got.layer_kinds() == want.layer_kinds()
    assert got.param_count() == want.param_count()


def test_smollm_full_width():
    cfg = get_config("smollm-360m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (32, 960, 15, 5, 64, 2560, 49152)
    assert cfg.n_heads // cfg.n_kv_heads == 3


def test_registry_lists_only_ported_archs():
    """Every config of the JAX package's registry is ported, in its order,
    and a name outside it raises."""
    assert list_archs() == jlist_archs()
    assert sorted(list_archs()) == sorted(ARCHS)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


BASINS = ["checkpoint_basin", "decode_stream_basin", "paper_basin",
          "tpu_input_basin", "mirrored_checkpoint_basin"]


@pytest.mark.parametrize("name", BASINS)
@pytest.mark.parametrize("placement", ["host", "accel"])
def test_planner_copy_plans_as_reference(name, placement):
    kw = dict(stages=("pull", "push"), checksum=True,
              checksum_placement=placement, path="auto")
    got = planner.plan_transfer(getattr(basin, name)(), 64 * 1024, **kw)
    want = jplanner.plan_transfer(getattr(jbasin, name)(), 64 * 1024, **kw)
    assert got.describe() == want.describe()
    assert repr(got.hops) == repr(want.hops)
    assert got.planned_bytes_per_s == want.planned_bytes_per_s
