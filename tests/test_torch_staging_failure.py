"""A stage that raises ends a multi-stage transfer with an error, not a hang.

The recipe: ``MoverConfig(staging_capacity=2, staging_workers=1,
checksum=False, device="cpu")``, ``bulk_transfer`` over 4 float tensors of
4096 values with ``transforms=[("id", lambda x: x * 1), ("boom", f)]``
where ``f`` raises.  The ``boom`` stage's worker dies on the first item.
Its downstream buffer closes, so the caller's drain ends; but nothing
drained the ``id`` stage's buffer any more, so once that buffer was full
the ``id`` worker blocked in ``BurstBuffer.put`` for good, and the caller
blocked in ``Pipeline.join`` behind it.

The JAX package's copy (``repro.core.staging.Stage._run_worker``) still
hangs on this recipe, with the same stacks: a worker of the ``id`` stage
in ``BurstBuffer.put``, the caller in ``StagePipeline.join``.  It is not
run here: a hung thread would stay in the shared test worker.  The port
repairs its own copy: a stage that stops early (its worker raised, or its
own buffer was closed under it) closes the buffer it reads from, so the
stage upstream ends in ``BufferClosed`` and ``join`` re-raises the failure
as ``RuntimeError: stage boom failed``.

Each case runs the transfer in a daemon thread joined with a bound of a
few seconds: a hang fails the test instead of stalling the run.

A sink that raises must also stop every thread the transfer started: the
stage workers of a bulk transfer, and under ``parallel_transfer`` the
dispatcher, each branch's stage workers and the per-branch drains into
the merge buffer (whose ``merge.put`` nobody reads once the caller's loop
has left).  The port aborts the pipeline before the sink's error leaves
the transfer; the JAX package's mover leaves those threads blocked.
"""

import threading
import time

import pytest
import torch

from repro_torch.core.basin import checkpoint_basin, decode_fanout_basin
from repro_torch.core.integrity import compress_transform
from repro_torch.core.mover import MoverConfig, UnifiedDataMover
from repro_torch.core.planner import plan_transfer

torch.set_num_threads(1)

#: seconds the transfer may take before it counts as hung (it fails within
#: milliseconds when it does not hang)
JOIN_BOUND_S = 10.0


def _boom(_item):
    raise ValueError("boom")


def _run(transforms, n_items: int = 4, batch_items: int = 1) -> BaseException:
    """The recipe's transfer in a daemon thread; returns what it raised."""
    mover = UnifiedDataMover(MoverConfig(staging_capacity=2,
                                         staging_workers=1, checksum=False,
                                         device="cpu"))
    items = [torch.full((4096,), float(i)) for i in range(n_items)]
    got: list = []
    raised: list[BaseException] = []

    def body():
        try:
            mover.bulk_transfer(iter(items), got.append,
                                transforms=transforms,
                                batch_items=batch_items)
        except BaseException as e:      # noqa: BLE001 - handed to the test
            raised.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_BOUND_S)
    assert not t.is_alive(), (f"the transfer hung: still running after "
                              f"{JOIN_BOUND_S} s")
    assert raised, "the transfer returned although a stage raised"
    return raised[0]


@pytest.mark.parametrize("batch_items", [1, 2])
@pytest.mark.parametrize("first", ["id", "compress"])
def test_a_raising_stage_ends_the_transfer_with_its_error(first,
                                                          batch_items):
    """Per item (``put``) and in slabs of two (``put_many``, the
    ``_step_batch`` path) alike."""
    head = (("id", lambda x: x * 1) if first == "id"
            else ("compress", compress_transform()))
    err = _run([head, ("boom", _boom)], batch_items=batch_items)
    assert isinstance(err, RuntimeError)
    assert "stage boom failed" in str(err)


def test_a_raising_middle_stage_also_stops_the_stages_before_it():
    """Three stages: the closure runs up the chain, one stage at a time
    (a stage whose own buffer was closed under it closes its upstream)."""
    err = _run([("id", lambda x: x * 1), ("twice", lambda x: x * 2),
                ("boom", _boom)], n_items=8)
    assert isinstance(err, RuntimeError)
    assert "stage boom failed" in str(err)


@pytest.mark.parametrize("drain_per_segment", [False, True])
def test_a_raising_sink_stops_the_stage_workers(drain_per_segment):
    """A sink that raises ends the transfer with its error, and the stage
    workers, blocked on buffers nobody drains any more, end too instead of
    holding the rest of the source's items for good (the JAX package's
    mover leaves them blocked, with the same stacks as above)."""
    mover = UnifiedDataMover(MoverConfig(staging_capacity=2,
                                         staging_workers=1, checksum=False,
                                         device="cpu"))
    items = [torch.full((4096,), float(i)) for i in range(16)]
    before = set(threading.enumerate())
    delivered = []

    def sink(item):
        if len(delivered) == 3:
            raise OSError("client went away")
        delivered.append(item)

    # with a plan and a replan cadence the transfer runs in segments of 8
    # items (torn down and rebuilt at each) or, live, revises in place
    plan = plan_transfer(checkpoint_basin(), item_bytes=items[0].nbytes,
                         stages=("id", "twice"))
    with pytest.raises(OSError, match="client went away"):
        mover.bulk_transfer(iter(items), sink,
                            transforms=[("id", lambda x: x * 1),
                                        ("twice", lambda x: x * 2)],
                            plan=plan, replan_every_items=8,
                            drain_per_segment=drain_per_segment,
                            capacity=2, workers=1)
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(JOIN_BOUND_S)
    assert not [t.name for t in left if t.is_alive()]


#: (mode, route) of the parallel path's dispatch: a mirror deals every item
#: down every branch; a split deals each to one branch, or lets the
#: branches steal from one shared intake
PARALLEL_ROUTES = [("mirror", "deal"), ("split", "deal"), ("split", "steal")]


@pytest.mark.parametrize("per_branch_sinks", [False, True],
                         ids=["shared-sink", "per-branch-sinks"])
@pytest.mark.parametrize("drain_per_segment", [False, True],
                         ids=["live", "segmented"])
@pytest.mark.parametrize("mode,route", PARALLEL_ROUTES,
                         ids=[f"{m}-{r}" for m, r in PARALLEL_ROUTES])
def test_a_raising_sink_stops_every_parallel_thread(mode, route,
                                                    drain_per_segment,
                                                    per_branch_sinks):
    """``parallel_transfer`` without the drainer pool, its sink raising on
    the third delivery: the sink's error leaves the transfer, and every
    thread the transfer started (the dispatcher, the branches' stage
    workers, the per-branch drains into the merge) ends.  The JAX
    package's mover leaves the drains blocked in ``merge.put`` and the
    stage workers and the dispatcher blocked behind them, since nothing
    reads the merge once the caller's drain loop has left."""
    mover = UnifiedDataMover(MoverConfig(staging_capacity=2,
                                         staging_workers=1, checksum=False,
                                         device="cpu"))
    items = [torch.full((1024,), float(i)) for i in range(64)]
    plan = plan_transfer(decode_fanout_basin(2), item_bytes=items[0].nbytes,
                         stages=("token-stream",), ordered=True, path="auto")
    calls = [0]

    def raising(item):
        calls[0] += 1
        if calls[0] == 3:
            raise OSError("client went away")

    if per_branch_sinks:
        # the first client fails; the second would take everything
        sink = {plan.branches[0].branch_id: raising,
                plan.branches[1].branch_id: lambda item: None}
    else:
        sink = raising
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="client went away"):
        mover.parallel_transfer(iter(items), sink, plan=plan, mode=mode,
                                route=route, capacity=2, workers=1,
                                replan_every_items=32,
                                drain_per_segment=drain_per_segment)
    deadline = time.monotonic() + JOIN_BOUND_S
    left = [t for t in threading.enumerate() if t not in before]
    for t in left:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]
