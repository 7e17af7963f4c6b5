"""The port's input pipeline against the JAX package's, on the CPU.

The sources must yield the same batches byte for byte for the same seed
(they are the same numpy code), and ``InputPipeline`` must deliver the same
batch sequence, with and without online replanning, since batch order is
training determinism.  Bit-exact throughout: nothing here computes in
floating point except the bf16 cast of stub embeddings, which both
packages round to nearest even.  ``card_input_basin`` is checked tier by
tier against the figures it names.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe

from repro_torch.configs import get_smoke_config
from repro_torch.core.basin import (GBPS, H100_HBM_GBPS, HOST_DDR5_GBPS,
                                    PCIE5_X16_GBPS, card_input_basin,
                                    tpu_input_basin)
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.data import pipeline as pipe

torch.set_num_threads(1)

#: (arch, overrides): the two ported families, and a frontend variant
#: whose batches carry f32 stub embeddings (cast to bf16 by _decode)
CASES = [("smollm-360m", {}), ("mamba2-1.3b", {}),
         ("smollm-360m", {"frontend": "patch", "frontend_len": 8})]


def _cfgs(arch, overrides):
    return (dataclasses.replace(jget_smoke(arch), **overrides),
            dataclasses.replace(get_smoke_config(arch), **overrides))


def _bytes(v) -> bytes:
    if isinstance(v, torch.Tensor):
        v = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
        v = v.numpy()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(np.shape(a[k])) == tuple(np.shape(b[k])), k
        assert _bytes(a[k]) == _bytes(b[k]), k


@pytest.mark.parametrize("arch,overrides", CASES)
@pytest.mark.parametrize("host_index", [0, 1])
def test_synthetic_source_equals_reference(arch, overrides, host_index):
    jcfg, cfg = _cfgs(arch, overrides)
    kw = dict(global_batch=4, seq_len=24, seed=11, host_index=host_index,
              host_count=2)
    want = list(jpipe.SyntheticTokenSource(jcfg, jpipe.PipelineConfig(**kw),
                                           n_batches=5))
    got = list(pipe.SyntheticTokenSource(cfg, pipe.PipelineConfig(**kw),
                                         n_batches=5))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_source_equals_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 256, 5000).astype(dtype).tofile(path)
    jcfg, cfg = _cfgs("smollm-360m", {})
    kw = dict(global_batch=4, seq_len=32, host_index=1, host_count=2)
    want = list(jpipe.FileTokenSource(str(path), jcfg,
                                      jpipe.PipelineConfig(**kw), dtype))
    got = list(pipe.FileTokenSource(str(path), cfg,
                                    pipe.PipelineConfig(**kw), dtype))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("arch,overrides", CASES)
@pytest.mark.parametrize("replan", [0, 3])
def test_pipeline_delivers_the_reference_sequence(arch, overrides, replan):
    """Decoded host batches (``to_device=False``) equal the reference's,
    in order, also while the plan is revised online every 3 batches."""
    jcfg, cfg = _cfgs(arch, overrides)
    kw = dict(global_batch=2, seq_len=16, seed=7, replan_every_items=replan)
    jp = jpipe.InputPipeline(
        jpipe.SyntheticTokenSource(jcfg, jpipe.PipelineConfig(**kw),
                                   n_batches=10), to_device=False)
    tp = pipe.InputPipeline(
        pipe.SyntheticTokenSource(cfg, pipe.PipelineConfig(**kw),
                                  n_batches=10), to_device=False,
        telemetry=TelemetryRegistry())
    plan0 = tp.plan
    want, got = list(jp), list(tp)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        _same(a, b)
    if overrides:
        assert got[0]["extra_embeds"].dtype == torch.bfloat16
    assert (tp.plan is not plan0) == bool(replan)
    assert tp.reports()[0].items == 10


def test_pipeline_places_batches_on_the_cpu_when_asked():
    _, cfg = _cfgs("smollm-360m", {})
    pc = pipe.PipelineConfig(global_batch=2, seq_len=8, seed=1)
    want = list(pipe.SyntheticTokenSource(cfg, pc, n_batches=3))
    got = list(pipe.InputPipeline(pipe.SyntheticTokenSource(cfg, pc,
                                                            n_batches=3),
                                  device="cpu",
                                  telemetry=TelemetryRegistry()))
    for a, b in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in a.values())
        _same(a, b)


def test_pipeline_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    _, cfg = _cfgs("smollm-360m", {})
    pc = pipe.PipelineConfig(global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.InputPipeline(pipe.SyntheticTokenSource(cfg, pc, n_batches=1))


def test_fan_in_delivers_every_shard_batch():
    _, cfg = _cfgs("smollm-360m", {})
    srcs = [pipe.SyntheticTokenSource(
        cfg, pipe.PipelineConfig(2, 8, seed=s), n_batches=4) for s in (1, 2)]
    want = sorted(_bytes(b["tokens"]) for s in srcs for b in s)
    p = pipe.InputPipeline(srcs, to_device=False,
                           telemetry=TelemetryRegistry())
    assert sorted(_bytes(b["tokens"]) for b in p) == want
    assert {r.name for r in p.reports()} >= {"shard-0/pull", "shard-1/pull"}


def test_card_input_basin_tiers_and_bottleneck():
    b = card_input_basin()
    assert [t.name for t in b.tiers] == ["dataset-store", "host-burst-buffer",
                                         "pcie", "hbm"]
    rates = {t.name: t.bandwidth_bytes_per_s for t in b.tiers}
    assert rates["pcie"] == PCIE5_X16_GBPS * GBPS == pytest.approx(63.0e9,
                                                                   rel=1e-3)
    assert rates["hbm"] == H100_HBM_GBPS * GBPS == 3.35e12
    assert rates["host-burst-buffer"] == HOST_DDR5_GBPS * GBPS
    # the dataset store keeps the reference's model of storage
    ref = tpu_input_basin().tiers[0]
    assert (b.tiers[0].bandwidth_bytes_per_s, b.tiers[0].jitter_s,
            b.tiers[0].latency_s) == (ref.bandwidth_bytes_per_s,
                                      ref.jitter_s, ref.latency_s)
    assert b.bottleneck().element == "dataset-store"
    slow = card_input_basin(host_copy_gbps=2.0)
    assert slow.tier("host-burst-buffer").bandwidth_bytes_per_s == 2.0 * GBPS
    assert slow.bottleneck().element == "host-burst-buffer"
    with pytest.raises(ValueError):
        card_input_basin(host_copy_gbps=0)
    # the copied TPU basin is left as it is (its HBM is a v5e figure)
    assert tpu_input_basin().tier("hbm").bandwidth_bytes_per_s == \
        819.0 * 8 * GBPS
