"""The port's roofline and co-design model (``repro_torch.core.fidelity``,
``repro_torch.core.codesign``) against the JAX package's, on the CPU.

``predict``, ``enumerate_plans``, ``rank_plans`` and ``roofline`` are
copies: on the same inputs their results are equal exactly, under the JAX
package's ``TPU_V5E`` and under the port's ``H100_SXM``.

The counting pass (``count_step``) replaces the JAX package's HLO walk
(``analyze_hlo_text``).  Both count FLOPs of matrix products only, 2 x M x
N x K each (``FlopCounterMode``'s rules; the walk's ``dot``).  Tolerance of
the port's count of one train step against the walk of the reference's
jitted step, same smoke config, same batch:
- the dense decoder, remat none or full: equal (rtol 1e-12).  The same
  products run, and each framework's remat recomputes the same forward
  products once in the backward.
- mamba2: within 2% (seen: 1.43% below, 77,070,336 against 78,184,448).
  The reference writes the depthwise conv as an einsum (``bswc,wc->bsc``)
  that XLA lowers to a dot, counted; the port computes it as an
  elementwise product and a sum, which counts no FLOPs: 163,840 FLOPs a
  pass a layer at this size, 1,310,720 over the forward, the recompute and
  the two gradients of 2 layers.  The forwards differ by exactly that
  term; in the backward the port counts 196,608 more, where the gradients
  of the three-operand SSD einsums decompose into other products.
Bytes are not compared: XLA fuses, and the walk counts fusion boundaries,
where the port counts every operation's inputs and outputs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core import codesign as jcodesign
from repro.core import fidelity as jfidelity
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models.api import build as jbuild
from repro.optim.adamw import adamw_init as jadamw_init

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import codesign, fidelity
from repro_torch.core.fidelity import H100_SXM, TPU_V5E, StepCost, count_step
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build
from repro_torch.optim.adamw import adamw_init

torch.set_num_threads(1)

ARCHS = ("smollm-360m", "repro-100m", "mamba2-1.3b")
SPECS = {"tpu-v5e": TPU_V5E, "h100-sxm": H100_SXM}
#: (n_chips, dp, tp, pods) meshes the model is asked about
MESHES = [(1, 1, 1, 1), (8, 8, 1, 1), (8, 2, 4, 1), (256, 16, 16, 1),
          (512, 16, 16, 2)]


def _jhw(hw):
    """The JAX package's HardwareSpec with the port's spec's values."""
    return jfidelity.HardwareSpec(**dataclasses.asdict(hw))


def _workloads(arch, batch=8, seq=512):
    return (codesign.workload_from_config(get_config(arch), batch, seq),
            jcodesign.workload_from_config(jget_config(arch), batch, seq))


def _jplan(plan):
    return jcodesign.CodesignPlan(**dataclasses.asdict(plan))


def test_h100_spec_is_the_data_sheet():
    assert H100_SXM.peak_flops == 989e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_SXM.hbm_bytes == 80e9
    assert H100_SXM.ici_bandwidth == 50e9
    # the copied default is the JAX package's chip, field for field
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(
        jfidelity.TPU_V5E)


@pytest.mark.parametrize("arch", ARCHS)
def test_workload_from_config_matches_reference(arch):
    mine, ref = _workloads(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_enumerate_plans_matches_reference(multi_pod):
    mine = codesign.enumerate_plans(multi_pod=multi_pod)
    ref = jcodesign.enumerate_plans(multi_pod=multi_pod)
    assert [dataclasses.asdict(p) for p in mine] == \
        [dataclasses.asdict(p) for p in ref]
    assert [p.describe() for p in mine] == [p.describe() for p in ref]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_predict_matches_reference(arch, spec):
    hw = SPECS[spec]
    mine, ref = _workloads(arch)
    for n, dp, tp, pods in MESHES:
        for plan in codesign.enumerate_plans(multi_pod=pods > 1):
            got = codesign.predict(mine, plan, n_chips=n, dp=dp, tp=tp,
                                   pods=pods, hw=hw)
            want = jcodesign.predict(ref, _jplan(plan), n_chips=n, dp=dp,
                                     tp=tp, pods=pods, hw=_jhw(hw))
            for f in ("t_compute", "t_memory", "t_collective",
                      "hbm_bytes_needed", "fits", "step_time_s",
                      "dominant"):
                assert getattr(got, f) == getattr(want, f), (plan, f)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_plans_matches_reference(arch, spec):
    hw = SPECS[spec]
    mine, ref = _workloads(arch)
    for n, dp, tp, pods in MESHES:
        got = codesign.rank_plans(mine, n_chips=n, dp=dp, tp=tp, pods=pods,
                                  hw=hw)
        want = jcodesign.rank_plans(ref, n_chips=n, dp=dp, tp=tp,
                                    pods=pods, hw=_jhw(hw))
        assert [(dataclasses.asdict(p.plan), p.step_time_s, p.fits)
                for p in got] == \
            [(dataclasses.asdict(p.plan), p.step_time_s, p.fits)
             for p in want]


def test_defaults_stay_the_reference_chip():
    """Without ``hw`` the copies price the JAX package's TPU v5e, as the
    reference does; the port's one-card H100 prediction is another
    number."""
    mine, ref = _workloads("smollm-360m")
    plan = codesign.CodesignPlan(sharding="dp", microbatches=1,
                                 remat="full")
    kw = dict(n_chips=1, dp=1, tp=1)
    tpu = codesign.predict(mine, plan, **kw)
    assert tpu.step_time_s == jcodesign.predict(ref, _jplan(plan),
                                                **kw).step_time_s
    h100 = codesign.predict(mine, plan, hw=H100_SXM, **kw)
    assert h100.t_compute == pytest.approx(tpu.t_compute * 197e12 / 989e12,
                                           rel=1e-12)
    assert h100.fits and h100.dominant == "compute"


def _costs():
    fields = dict(flops=3.1e15, bytes_accessed=7.7e12,
                  collective_bytes=2.5e10, collective_link_bytes=4.1e10,
                  collective_by_type={"all-reduce": 2.0e10,
                                      "all-gather": 5e9},
                  collective_count={"all-reduce": 12, "all-gather": 3},
                  flops_by_op={"dot": 3.1e15},
                  flashable_bytes=1.5e12, flashable_flops=4e14,
                  bytes_by_op={"fusion": 7.7e12}, num_partitions=8,
                  unknown_trip_counts=1)
    return StepCost(**fields), jfidelity.HloCost(**fields)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("flash", [None, 4.0e12])
def test_roofline_matches_reference(spec, flash):
    hw = SPECS[spec]
    mine, ref = _costs()
    kw = dict(label="cell", model_flops=fidelity.model_flops_dense(
        409_007_040, 4096), memory_per_device_bytes=1.2e10,
        flash_ideal_bytes_global=flash)
    got = fidelity.roofline(mine, hw=hw, **kw)
    want = jfidelity.roofline(ref, hw=_jhw(hw), **kw)
    assert got.to_json() == want.to_json()
    assert got.summary() == want.summary()
    assert got.fidelity_gap == want.fidelity_gap
    # the default hardware is the reference's, too
    assert fidelity.roofline(mine).to_json() == \
        jfidelity.roofline(ref).to_json()


def test_model_flops_dense_matches_reference():
    for backward in (True, False):
        assert fidelity.model_flops_dense(409_007_040, 4096,
                                          backward=backward) == \
            jfidelity.model_flops_dense(409_007_040, 4096,
                                        backward=backward)


# ---------------------------------------------------------------------------
# the counting pass
# ---------------------------------------------------------------------------


def test_count_step_counting_rules():
    """A product counts 2 x M x N x K FLOPs and the bytes of its inputs
    and output; a view moves nothing; an elementwise op counts bytes and
    no FLOPs."""
    a, b = torch.ones(16, 32), torch.ones(32, 8)

    def fn():
        c = a @ b.T.T                       # two views, one product
        return (c * 2.0).sum()

    out, cost = count_step(fn)
    assert float(out) == 2.0 * 16 * 8 * 32
    assert cost.flops == 2 * 16 * 8 * 32
    assert cost.flops_by_op == {"aten.mm": 2 * 16 * 8 * 32}
    mm = (16 * 32 + 32 * 8 + 16 * 8) * 4
    mul = (16 * 8 * 4) * 2          # tensor in and out (2.0 is no tensor)
    assert cost.bytes_by_op["aten.mm"] == mm
    assert cost.bytes_by_op["aten.mul"] == mul
    assert "aten.t" not in cost.bytes_by_op
    assert cost.bytes_accessed == sum(cost.bytes_by_op.values())
    assert cost.collective_bytes == 0 and cost.num_partitions == 1


B, S = 4, 32


@pytest.mark.parametrize("arch,remat,rtol", [
    ("smollm-360m", "none", 1e-12), ("smollm-360m", "full", 1e-12),
    ("mamba2-1.3b", "full", 0.02)])
def test_count_step_flops_match_reference_hlo(arch, remat, rtol):
    """One train step (forward, backward, AdamW) at smoke width, 2
    layers: the port's counted FLOPs against ``analyze_hlo_text`` of the
    reference's compiled step (tolerances in the module docstring)."""
    jcfg = dataclasses.replace(jget_smoke(arch), n_layers=2, remat=remat)
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2,
                              remat=remat)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    batch = {"tokens": tokens, "labels": tokens}

    api = jbuild(jcfg)
    jstep, *_ = jsteps.make_train_step(
        api, make_host_mesh(),
        jcodesign.CodesignPlan(microbatches=1, remat=remat))
    params = api.init(jax.random.PRNGKey(0))
    hlo = jstep.lower(params, jadamw_init(params), batch).compile().as_text()
    want = jfidelity.analyze_hlo_text(hlo)

    papi = build(cfg)
    lm = papi.init(0, device="cpu", trainable=True)
    step, _ = make_train_step(papi)
    _, got = count_step(step, lm, adamw_init(lm.parameters()),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.flops == pytest.approx(want.flops, rel=rtol)
    # every product of the step is a matrix product, at least 6 N T
    assert got.flops >= fidelity.model_flops_dense(
        cfg.param_count() - cfg.vocab * cfg.d_model, B * S)
    assert set(got.flops_by_op) <= {"aten.mm", "aten.bmm", "aten.addmm"}
