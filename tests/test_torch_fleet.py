"""The port's fleet arbiter (``repro_torch.core.fleet``) against the JAX
package's, on the CPU.

Both arbiters are driven with the same basins and the same sequence of
``admit`` / ``release`` / ``rebalance`` / ``element_died`` /
``element_recovered`` / ``probe_element``: grants must be equal exactly
(the same float arithmetic in the same order), and statuses, reasons and
``stats()`` rows equal.  The random fleets are those of
``test_fleet_properties.py`` (rebuilt here: the test folders are not
packages), seeds 0..63 in order; the port is held to parity with the
reference, not to the release-monotonicity property, which the reference
breaks on some seeds and the port's copy breaks on the same ones.

The mover's ``fleet=`` option runs on a virtual clock (a counter the sink
advances), so the time-averaged grant is exact arithmetic; no wall-clock
rate is asserted.
"""

import dataclasses
import json
import random
import threading

import pytest
import torch

from repro.core import basin as jbasin
from repro.core.fleet import FleetArbiter as JArbiter

from repro_torch.core import basin as pbasin
from repro_torch.core.fleet import (DEAD_ELEMENT_BYTES_PER_S,
                                    DEFAULT_CLASSES,
                                    RECOVERY_PROBE_BYTES_PER_S, FleetArbiter)
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.telemetry import TelemetryRegistry

torch.set_num_threads(1)

GBPS, MIB = pbasin.GBPS, pbasin.MIB
BOTH = {"ref": (jbasin, JArbiter), "port": (pbasin, FleetArbiter)}
#: release-monotonicity slack of the reference's property test
TOL = 1e-6


def _fanout_basin(mod, rng: random.Random):
    """``test_fleet_properties._fanout_basin`` over ``mod``'s basin types."""
    g = lambda lo, hi: rng.uniform(lo, hi) * GBPS
    tiers = [
        mod.Tier("src", mod.TierKind.SOURCE, g(20, 200)),
        mod.Tier("east", mod.TierKind.CHANNEL, g(10, 100)),
        mod.Tier("west", mod.TierKind.CHANNEL, g(10, 100)),
        mod.Tier("dst", mod.TierKind.SINK, g(20, 200)),
    ]
    links = [
        mod.Link("src", "east", None),
        mod.Link("src", "west", None),
        mod.Link("east", "dst", g(5, 100), rtt_s=rng.choice([0.0, 0.002])),
        mod.Link("west", "dst", g(5, 100), rtt_s=rng.choice([0.0, 0.002])),
    ]
    return mod.DrainageBasin(tiers, links)


def _random_fleet(which: str, seed: int):
    """``test_fleet_properties._random_fleet`` in package ``which``."""
    mod, Arbiter = BOTH[which]
    rng = random.Random(seed)
    basin = _fanout_basin(mod, rng)
    arb = Arbiter(basin)
    paths = basin.paths()
    admitted = []
    for i in range(rng.randint(2, 6)):
        path = rng.choice([None] + paths)
        qos = rng.choice(["interactive", "priority", "bulk", "scavenger"])
        floor = 0.0
        if rng.random() < 0.4:
            cap = min(t.bandwidth_bytes_per_s for t in basin.tiers)
            floor = rng.uniform(0.0, 0.4) * cap
        adm = arb.admit(f"m{i}", 1 * MIB, qos=qos, path=path,
                        min_bytes_per_s=floor, queue=False,
                        stages=("move",))
        if adm.status == "admitted":
            admitted.append(adm)
    return basin, arb, admitted


def _release_victim(which: str, seed: int):
    """The property test's release step: grants before and after freeing
    the seed's victim (None when fewer than two members were admitted)."""
    _, arb, admitted = _random_fleet(which, seed)
    if len(admitted) < 2:
        return None
    victim = random.Random(seed ^ 0x5EED).choice(admitted)
    before = arb.grants()
    victim.release()
    return victim.name, before, arb.grants()


def _lowered(before: dict, after: dict) -> dict:
    """Survivors whose grant a peer's release lowered, as in the property
    test: name -> (before, after)."""
    return {n: (before[n], r) for n, r in after.items()
            if r < before[n] * (1.0 - TOL)}


def _oversubscribed(basin, arb) -> dict:
    """The elements whose members' grants sum above their rate, as the
    property test charges them: element -> (load, rate)."""
    grants = arb.grants()
    out = {}
    for t in basin.tiers:
        load = sum(grants[n] for n, m in arb._members.items()
                   if t.name in m.crosses_tiers)
        if load > t.bandwidth_bytes_per_s * (1.0 + TOL):
            out[t.name] = (load, t.bandwidth_bytes_per_s)
    for l in basin.links:
        load = sum(grants[n] for n, m in arb._members.items()
                   if (l.src, l.dst) in m.crosses_links)
        if load > l.bandwidth_bytes_per_s * (1.0 + TOL):
            out[(l.src, l.dst)] = (load, l.bandwidth_bytes_per_s)
    return out


# ---------------------------------------------------------------------------
# the arbiter: parity with the reference
# ---------------------------------------------------------------------------


def _snapshot(arb, adms: dict) -> dict:
    return {
        "grants": arb.grants(),
        "status": {n: (a.status, a.reason, a.shed) for n, a in adms.items()},
        "stats": arb.stats(),
        "fairness": arb.weighted_fairness(),
        "plans": {n: (a.plan.planned_bytes_per_s,
                      a.plan.rate_cap_bytes_per_s)
                  for n, a in adms.items() if a.plan is not None},
        "tiers": {t.name: t.bandwidth_bytes_per_s for t in arb.basin.tiers},
    }


def _script(which: str, seed: int) -> list:
    """One scripted fleet life: floors, pinned paths, a queued ask, a
    rejected one, releases with promotion, a capacity loss that sheds, an
    element death, a failed and a clean recovery probe, and recovery.
    Returns the snapshot after every step."""
    mod, Arbiter = BOTH[which]
    basin = _fanout_basin(mod, random.Random(seed))
    reg = TelemetryRegistry() if which == "port" else None
    arb = Arbiter(basin, telemetry=reg)
    paths = basin.paths()
    line = min(t.bandwidth_bytes_per_s for t in basin.tiers)
    adms: dict = {}
    snaps = []

    def admit(name, **kw):
        adms[name] = arb.admit(name, 1 * MIB, stages=("move",), **kw)
        snaps.append(_snapshot(arb, adms))

    admit("ckpt", qos="bulk", min_bytes_per_s=0.2 * line)
    admit("kv", qos="interactive", path=paths[0])
    admit("shard", qos="scavenger", path=paths[-1])
    admit("late", qos="priority", min_bytes_per_s=0.9 * line)
    admit("never", qos="priority", min_bytes_per_s=0.9 * line, queue=False)
    admit("huge", qos="bulk", min_bytes_per_s=10 * line)
    for step in (lambda: adms["kv"].release(),
                 lambda: arb.rebalance(basin=basin.replace_tiers(
                     [dataclasses.replace(t, bandwidth_bytes_per_s=0.3
                                          * t.bandwidth_bytes_per_s)
                      if t.name == "src" else t for t in basin.tiers])),
                 lambda: arb.rebalance(basin=basin),
                 lambda: arb.element_died("east"),
                 lambda: arb.element_died("east"),
                 lambda: arb.probe_element("east", 10.0),
                 lambda: arb.probe_element("east",
                                           10 * RECOVERY_PROBE_BYTES_PER_S),
                 lambda: arb.element_died("west"),
                 lambda: arb.element_recovered("west"),
                 lambda: adms["ckpt"].release(),
                 lambda: adms["late"].release(),
                 lambda: adms["shard"].release()):
        step()
        snaps.append(_snapshot(arb, adms))
    if reg is not None:
        # every membership change published a fleet row to the port's
        # telemetry, the last one the empty fleet
        assert json.loads(reg.to_json())["fleet"]["live"] == 0
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_scripted_fleet_matches_reference(seed):
    ref, port = _script("ref", seed), _script("port", seed)
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"step {i}"
    # the script reaches every state it is meant to
    statuses = {s for snap in port for s, _, _ in snap["status"].values()}
    assert statuses >= {"admitted", "queued", "rejected"}
    assert any(t == DEAD_ELEMENT_BYTES_PER_S
               for snap in port for t in snap["tiers"].values())
    assert port[-1]["grants"] == {}


def test_port_publishes_fleet_rows_to_its_telemetry():
    reg = TelemetryRegistry()
    arb = FleetArbiter(_fanout_basin(pbasin, random.Random(0)),
                       telemetry=reg)
    a = arb.admit("a", MIB, qos="interactive", stages=("move",))
    arb.admit("b", MIB, qos="bulk", stages=("move",))
    fleet = json.loads(reg.to_json())["fleet"]
    assert fleet["live"] == 2
    assert fleet["classes"]["interactive"]["weight"] == \
        DEFAULT_CLASSES["interactive"]
    a.release()
    assert json.loads(reg.to_json())["fleet"]["live"] == 1


@pytest.mark.parametrize("seed", range(64))
def test_random_fleet_matches_reference(seed):
    """The property file's random fleet, seed by seed: the same members
    admitted with the same grants and plans, the same loads on every
    element, the same grants after the victim's release, and a failed
    admission that leaves the live fleet byte-identical in both."""
    jb, jarb, jadm = _random_fleet("ref", seed)
    pb, parb, padm = _random_fleet("port", seed)
    assert [a.name for a in padm] == [a.name for a in jadm]
    assert parb.grants() == jarb.grants()
    assert parb.stats() == jarb.stats()
    for a, b in zip(padm, jadm):
        assert a.plan.planned_bytes_per_s == b.plan.planned_bytes_per_s
    # conservation: the same elements oversubscribed by the same loads
    # (none on most seeds; the reference breaks it on some, see below)
    assert _oversubscribed(pb, parb) == _oversubscribed(jb, jarb)
    assert _release_victim("port", seed) == _release_victim("ref", seed)
    line = min(t.bandwidth_bytes_per_s for t in pb.tiers)
    for arb in (parb, jarb):
        before = arb.grants()
        greedy = arb.admit("greedy", MIB, qos="scavenger",
                           min_bytes_per_s=0.95 * line, stages=("move",))
        assert greedy.status in ("queued", "rejected")
        assert arb.grants() == before
        greedy.release()
        assert arb.grants() == before


def test_release_fault_is_shared_with_reference():
    """``test_release_never_lowers_a_survivor`` fails on the reference for
    some seeds: a peer's release lowers a survivor's grant.  The first
    such seed is found in order from 0, and the port's copy lowers the
    same survivors to the same grants (a fault shared, not repaired)."""
    for seed in range(2000):
        got = _release_victim("ref", seed)
        if got is not None and _lowered(got[1], got[2]):
            break
    else:
        pytest.fail("no seed below 2000 breaks the reference's property")
    victim, before, after = got
    assert _release_victim("port", seed) == (victim, before, after)
    lowered = _lowered(before, after)
    assert lowered and all(a < b for b, a in lowered.values())


def test_conservation_fault_is_shared_with_reference():
    """``test_every_shared_element_conserves_rate`` fails on the reference
    for some seeds: members' grants on an element sum above its rate.  The
    first such seed from 0, and the port's copy oversubscribes the same
    elements by the same loads."""
    for seed in range(2000):
        jb, jarb, _ = _random_fleet("ref", seed)
        over = _oversubscribed(jb, jarb)
        if over:
            break
    else:
        pytest.fail("no seed below 2000 breaks the reference's property")
    pb, parb, _ = _random_fleet("port", seed)
    assert _oversubscribed(pb, parb) == over


# ---------------------------------------------------------------------------
# the mover's fleet= option
# ---------------------------------------------------------------------------


def _channel_basin(rtt_s=0.005):
    L = 100 * GBPS
    return pbasin.DrainageBasin(
        [pbasin.Tier("src", pbasin.TierKind.SOURCE, 2 * L),
         pbasin.Tier("dst", pbasin.TierKind.SINK, 2 * L)],
        [pbasin.Link("src", "dst", L, rtt_s=rtt_s)])


def test_mover_refuses_a_non_admitted_handle():
    L = 100 * GBPS
    arb = FleetArbiter(_channel_basin())
    a = arb.admit("a", MIB, qos="interactive", stages=("move",))
    queued = arb.admit("q", MIB, qos="bulk", min_bytes_per_s=0.9 * L,
                       stages=("move",))
    assert queued.status == "queued"
    mover = UnifiedDataMover(MoverConfig(checksum=False))
    with pytest.raises(ValueError, match="queued"):
        mover.bulk_transfer(iter([b"\0" * 64]), lambda _: None,
                            transforms=[("move", lambda x: x)],
                            fleet=queued)
    with pytest.raises(ValueError, match="replan_every_items"):
        mover.bulk_transfer(iter([b"\0" * 64]), lambda _: None,
                            transforms=[("move", lambda x: x)], fleet=a,
                            replan_every_items=4)
    assert arb.grants() == {"a": a.granted_bytes_per_s}


class _Clock:
    """A virtual clock the sink advances by one second per item."""

    def __init__(self):
        self.t = 0.0
        self.lock = threading.Lock()

    def __call__(self) -> float:
        with self.lock:
            return self.t

    def tick(self) -> None:
        with self.lock:
            self.t += 1.0


@pytest.mark.parametrize("checksum", [False, True])
def test_fleet_bound_transfer_rebalances_mid_stream(checksum):
    """Member A runs alone at the whole line; at its 8th delivery a peer
    B admits.  The arbiter pushes A's reduced grant through the mover's
    zero-drain applier (A counts a replan), A's promise is the grant's
    time average over the virtual clock, and completion releases A."""
    clock = _Clock()
    arb = FleetArbiter(_channel_basin(), clock=clock)
    a = arb.admit("A", MIB, qos="interactive", stages=("move",))
    full = a.granted_bytes_per_s
    items = [bytes([i]) * 1024 for i in range(24)]
    got, peer = [], {}

    def sink(item):
        got.append(item)
        if len(got) == 8:
            peer["b"] = arb.admit("B", MIB, qos="bulk", stages=("move",))
        clock.tick()

    mover = UnifiedDataMover(MoverConfig(checksum=checksum), clock=clock)
    rep = mover.bulk_transfer(iter(items), sink,
                              transforms=[("move", lambda x: x)], fleet=a)
    assert got == items
    assert rep.replans >= 1
    shared = full * DEFAULT_CLASSES["interactive"] / (
        DEFAULT_CLASSES["interactive"] + DEFAULT_CLASSES["bulk"])
    # the grant stepped from the whole line to A's weighted share at t=7
    # (the 8th delivery's time); the transfer ended at t=24
    assert rep.planned_bytes_per_s == pytest.approx(
        (7 * full + 17 * shared) / 24, rel=1e-12)
    assert arb.grants() == {"B": full}
    assert a.granted_bytes_per_s == 0.0
    peer["b"].release()
    assert arb.grants() == {}


def test_fleet_bound_transfer_releases_on_failure():
    arb = FleetArbiter(_channel_basin())
    a = arb.admit("A", MIB, qos="bulk", stages=("move",))

    def sink(item):
        raise RuntimeError("sink died")

    with pytest.raises(RuntimeError, match="sink died"):
        UnifiedDataMover(MoverConfig(checksum=False)).bulk_transfer(
            iter([b"x" * 64] * 4), sink,
            transforms=[("move", lambda x: x)], fleet=a)
    assert arb.grants() == {}


def test_fleet_bound_parallel_transfer_rebalances_and_releases():
    """A split transfer down both branches of a fan-out basin under a
    fleet grant: a peer admitted mid-stream re-grants the running
    branches in place, and completion releases the share."""
    basin = _fanout_basin(pbasin, random.Random(3))
    arb = FleetArbiter(basin)
    a = arb.admit("A", MIB, qos="interactive", stages=("deliver",))
    assert len(a.plan.branches) == 2
    items = [bytes([i]) * 512 for i in range(32)]
    got, peer = [], {}
    lock = threading.Lock()

    def sink(item):
        with lock:
            got.append(item)
            if len(got) == 8:
                peer["b"] = arb.admit("B", MIB, qos="bulk",
                                      stages=("deliver",))

    rep = UnifiedDataMover(MoverConfig(checksum=True)).parallel_transfer(
        iter(items), sink, mode="split",
        transforms={b.branch_id: [("deliver", lambda x: x)]
                    for b in a.plan.branches}, fleet=a)
    assert sorted(got) == sorted(items)
    assert rep.items == len(items)
    assert rep.replans >= 1
    assert set(arb.grants()) == {"B"}
    peer["b"].release()
    assert arb.grants() == {}
