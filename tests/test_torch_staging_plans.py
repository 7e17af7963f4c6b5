"""The port's plans priced with the card's own speeds, on the CPU.

``card_host_basin`` models the H100's staging path (HBM, PCIe Gen5 x16,
pinned or pageable host memory) beside the copied ``checkpoint_basin``
(host RAM to NVMe), whose parity tests stay as they are.  A ``Server``
prices its decode stream from the steps it has timed, and before the first
from a measured H100 step time, not the copied default of 2.0 ms.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import basin, planner
from repro_torch.core.basin import GBPS, TierKind, card_host_basin
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.launch.serve import H100_DECODE_STEP_MS, Server

torch.set_num_threads(1)


def test_card_host_basin_tiers():
    pinned = card_host_basin()
    assert [(t.name, t.kind) for t in pinned.tiers] == [
        ("hbm", TierKind.SOURCE), ("pcie", TierKind.CHANNEL),
        ("host-pinned", TierKind.SINK)]
    rates = [t.bandwidth_bytes_per_s for t in pinned.tiers]
    assert rates == pytest.approx([3.35e12, 63.0e9, 307.2e9], rel=1e-3)
    # into pinned memory the link is the narrowest tier
    assert pinned.bottleneck().element == "pcie"

    pageable = card_host_basin(pageable_gbps=40.0)
    assert pageable.tiers[-1].name == "host-pageable"
    assert pageable.tiers[-1].bandwidth_bytes_per_s == 40.0 * GBPS
    assert pageable.bottleneck().element == "host-pageable"
    assert [t.name for t in pageable.tiers[:2]] == ["hbm", "pcie"]
    with pytest.raises(ValueError):
        card_host_basin(pageable_gbps=0.0)


@pytest.mark.parametrize("rate", [64e9, 2.5e12])
def test_card_host_plan_takes_the_measured_digest_rate(rate):
    """An accel-placed checksum on the new basin: the plan carries the
    digest rate it was given, not the copied 64e9 default."""
    plan = planner.plan_transfer(card_host_basin(pageable_gbps=20.0),
                                 item_bytes=412_160, stages=("kv-stage",),
                                 checksum=True, checksum_placement="accel",
                                 accel_digest_bytes_per_s=rate)
    default = planner.plan_transfer(basin.checkpoint_basin(),
                                    item_bytes=412_160, stages=("kv-stage",),
                                    checksum=True,
                                    checksum_placement="accel")
    hop = plan.hops[0]
    assert hop.digest_bytes_per_s == rate
    assert default.hops[0].digest_bytes_per_s == planner.ACCEL_DIGEST_BYTES_PER_S


def _server(arch: str) -> Server:
    s = Server(get_smoke_config(arch), device="cpu", max_len=20,
               telemetry=TelemetryRegistry())
    s.load(0)
    return s


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b", "gemma3-1b",
                                  "zamba2-1.2b", "qwen3-moe-30b-a3b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2", "phi3-mini-3.8b",
                                  "mistral-large-123b", "mixtral-8x22b"])
def test_server_prices_its_first_stream_at_the_measured_h100_step(arch):
    server = _server(arch)
    step = H100_DECODE_STEP_MS[arch]
    assert step > 2.0
    assert server.decode_step_ms() == step
    assert server.stream_basin().tiers[0].latency_s == pytest.approx(
        step / 1e3)
    assert server.fanout_basin(2).tiers[0].latency_s == pytest.approx(
        step / 1e3)


def test_server_stream_basin_follows_its_observed_step_time():
    server = _server("smollm-360m")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, server.cfg.vocab, (2, 12), dtype=np.int32)}
    server.generate(batch, 5)
    assert len(server.step_ms) == 4 and all(t > 0 for t in server.step_ms)
    mean = sum(server.step_ms) / 4
    assert server.decode_step_ms() == pytest.approx(mean)
    assert server.stream_basin().tiers[0].latency_s == pytest.approx(
        mean / 1e3)
    assert server.fanout_basin(3).tiers[0].latency_s == pytest.approx(
        mean / 1e3)
    # a second request moves the estimate with the steps it adds
    server.generate(batch, 3)
    assert len(server.step_ms) == 6
    assert server.decode_step_ms() == pytest.approx(
        sum(server.step_ms) / 6)
