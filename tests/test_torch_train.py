"""The port's training path against the JAX package's, on the CPU.

AdamW and its schedule, the loss, the train step (grads and the updated
parameters, with 1 and 2 microbatches) and ``Trainer.run`` (a 10-step loss
trajectory, plain and through an injected failure) from the same weights
and the same seeded batches.  Smoke configs cut to 2 layers.

Tolerances, each from what differs between the two:
- AdamW on the same grads: the same f32 operations in the same order, but
  the global norm sums squares in another order, so values agree to a few
  f32 ulps (rtol 2e-6, atol 1e-9).
- Cross entropy on the same logits: f32 logsumexp in another order
  (rtol 1e-6).
- In f32, the loss, grads and update of one step: f32 sums in another
  order through 2 layers; grads agree to about 1e-6 of each leaf's
  largest magnitude (measured up to 1.2e-6), so 5e-6 of it; the loss to
  rtol 1e-6.  Adam's first step moves a weight by about lr * g / (|g| +
  1e-8), so where |g| is within a few orders of 1e-8 a grad error of 1e-9
  moves the update by a visible share of lr: the updated master is held to
  atol 1e-6 where |g| >= 1e-5; m = 0.1 g and v = 0.05 g^2 everywhere, to
  the share of the grads' error they carry (5e-7 of the leaf's largest
  |g|, and of its square).
- In bf16 (as the trainer runs): the frameworks round the activations to
  bf16 at different places; one loss agrees to 2e-4 of its value.  A
  10-step trajectory at lr 1e-2, where each step's update can flip on
  near-zero grads, agrees to 0.01 absolute (losses near 6; the largest
  drift seen was 0.0040), and its final f32 master to 5% of the mean
  distance training moved it (seen: 1.4%).  Planted faults read as
  failures: skipping every update after the restore drifts the losses by
  0.0113 and the master by 31% of its move; a constant lr in place of
  warmup-cosine, by 0.064 and 48%.  At the trainer's default lr of 3e-4
  the skipped updates drift the losses by only 0.0024, which is why the
  test trains at 1e-2.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core.codesign import CodesignPlan as JPlan
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokenSource as JSource
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.launch.train import Trainer as JTrainer
from repro.models.api import build as jbuild
from repro.models.blocks import ShardCtx as JShardCtx
from repro.models.common import cross_entropy_loss as jce
from repro.optim import adamw as jadamw

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokenSource
from repro_torch.kernels import build as kbuild
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import Trainer
from repro_torch.models.api import build
from repro_torch.models.blocks import ShardCtx
from repro_torch.models.common import cross_entropy_loss
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, map_leaves
from repro_torch.weights import (from_jax_params, jax_tree, param_names,
                                 to_jax_params)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-360m", "mamba2-1.3b")
B, S = 4, 32
LR = dict(lr_peak=1e-2, warmup=2, total_steps=10)


def _cfgs(arch):
    return (dataclasses.replace(jget_smoke(arch), n_layers=2),
            dataclasses.replace(get_smoke_config(arch), n_layers=2))


def _f32(a):
    """Any numpy leaf (bf16 as ml_dtypes or raw 2-byte values) as f32."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    want = np.asarray(jadamw.warmup_cosine(jnp.asarray(steps), peak_lr=3e-4,
                                           warmup=7, total=30))
    got = adamw.warmup_cosine(_t(steps), peak_lr=3e-4, warmup=7,
                              total=30).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


def test_adamw_matches_reference_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": ((4, 8), jnp.bfloat16), "b": ((8,), jnp.float32),
              "c": ((3, 5, 2), jnp.bfloat16)}
    jp = {k: jnp.asarray(rng.standard_normal(s), dt)
          for k, (s, dt) in shapes.items()}
    names = sorted(shapes)                       # JAX's leaf order
    tp = [_t(np.asarray(jp[k]).view(np.int16)).view(torch.bfloat16)
          if jp[k].dtype == jnp.bfloat16 else _t(np.asarray(jp[k]))
          for k in names]
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for i in range(3):
        jg = {k: (jnp.asarray(rng.standard_normal(jp[k].shape) * 3.0,
                              jp[k].dtype)) for k in names}
        tg = [torch.from_numpy(_f32(jg[k])).to(tp[j].dtype)
              for j, k in enumerate(names)]
        jlr = jadamw.warmup_cosine(js.step + 1, peak_lr=1e-2, warmup=2,
                                   total=10)
        tlr = adamw.warmup_cosine(ts.step + 1, peak_lr=1e-2, warmup=2,
                                  total=10)
        jp, js, jm = jadamw.adamw_update(jg, js, jp, lr=jlr)
        tp, ts, tm = adamw.adamw_update(tg, ts, tp, lr=tlr)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        for f in ("master", "m", "v"):
            for j, k in enumerate(names):
                np.testing.assert_allclose(
                    getattr(ts, f)[j].numpy(), np.asarray(getattr(js, f)[k]),
                    rtol=2e-6, atol=1e-9, err_msg=f"{f}/{k} step {i + 1}")
        for j, k in enumerate(names):
            assert tp[j].dtype == (torch.bfloat16 if jp[k].dtype ==
                                   jnp.bfloat16 else torch.float32)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask)))
    got = float(cross_entropy_loss(_t(logits), _t(labels),
                                   None if mask is None else _t(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference_step(arch: str, f32: bool, microbatches: int):
    """JAX params, batch, loss, grads and one make_train_step update."""
    jcfg, _ = _cfgs(arch)
    api = jbuild(jcfg)
    params = api.init(jax.random.PRNGKey(0))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    np_params = jax.tree.map(np.asarray, params)
    loss_fn = lambda p, b: api.loss(p, b, JShardCtx())
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch)
    step, *_ = jsteps.make_train_step(api, make_host_mesh(),
                                      JPlan(microbatches=microbatches), **LR)
    copy = lambda t: jax.tree.map(lambda a: jnp.array(a, copy=True), t)
    new_params, new_state, metrics = step(
        copy(params), jadamw.adamw_init(copy(params)), batch)
    return (np_params, batch, float(loss), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new_params),
            jax.tree.map(np.asarray, new_state),
            {k: float(v) for k, v in metrics.items()})


def _np_tree(values, names):
    """Per-parameter f32 tensors as the JAX tree of arrays, layers stacked."""
    return map_leaves(lambda v: np.stack(v) if isinstance(v, tuple) else v,
                      jax_tree([v.detach().numpy() for v in values], names))


def _port(arch, np_params):
    _, cfg = _cfgs(arch)
    lm = from_jax_params(np_params, cfg, device="cpu", trainable=True)
    return cfg, lm


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_lm_loss_matches_reference(arch, f32):
    np_params, batch, want, *_ = _reference_step(arch, f32, 1)
    cfg, lm = _port(arch, np_params)
    loss, aux = build(cfg).loss(lm, {k: _t(v) for k, v in batch.items()},
                                ShardCtx(impl="ref"))
    np.testing.assert_allclose(loss.item(), want,
                               rtol=1e-6 if f32 else 2e-4)
    assert aux["ce"].item() == loss.item()
    assert float(aux["load_balance"]) == float(aux["router_z"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    np_params, batch, _, jgrads, *_ = _reference_step(arch, True, 1)
    cfg, lm = _port(arch, np_params)
    loss, _ = build(cfg).loss(lm, {k: _t(v) for k, v in batch.items()},
                              ShardCtx(impl="ref"))
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    got = dict(flatten_with_paths(_np_tree(grads, param_names(lm))))
    for path, want in flatten_with_paths(jgrads):
        scale = np.abs(want).max()
        assert np.abs(got[path] - want).max() <= 5e-6 * scale, path


@pytest.mark.parametrize("arch,microbatches", [
    ("smollm-360m", 1), ("smollm-360m", 2), ("mamba2-1.3b", 1),
    ("mamba2-1.3b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    (np_params, batch, _, jgrads, jnew, jstate,
     jmetrics) = _reference_step(arch, True, microbatches)
    cfg, lm = _port(arch, np_params)
    step, ctx = make_train_step(build(cfg), microbatches=microbatches, **LR)
    assert ctx.impl == "ref"
    lm, state, metrics = step(lm, adamw.adamw_init(lm.parameters()),
                              {k: _t(v) for k, v in batch.items()})
    assert int(state.step) == int(jstate.step) == 1
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=2e-6, err_msg=k)
    names = param_names(lm)
    grads = dict(flatten_with_paths(jgrads))
    sure = {p: np.abs(g) >= 1e-5 for p, g in grads.items()}
    for f in ("master", "m", "v"):
        got = dict(flatten_with_paths(_np_tree(getattr(state, f), names)))
        for path, want in flatten_with_paths(getattr(jstate, f)):
            # m = 0.1 g and v = 0.05 g^2 carry the grads' 5e-6 of scale
            scale = np.abs(grads[path]).max()
            keep, atol = {"master": (sure[path], 1e-6),
                          "m": (slice(None), 5e-7 * scale),
                          "v": (slice(None), 5e-7 * scale ** 2)}[f]
            np.testing.assert_allclose(got[path][keep], want[keep],
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{f} {path}")
    got = dict(flatten_with_paths(to_jax_params(lm)))
    for path, want in flatten_with_paths(jnew):
        keep = sure[path]
        np.testing.assert_allclose(got[path][keep], want[keep], rtol=1e-5,
                                   atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# Trainer.run against the reference Trainer
# ---------------------------------------------------------------------------


class _JTrainer(JTrainer):
    """The reference Trainer, finishing an in-flight save before it
    restores, as the port's does: otherwise the step the failure path
    restores (or whether it finds a checkpoint at all) depends on the save
    thread's timing."""

    def try_restore(self):
        if self.ckpt is not None:
            self.ckpt.wait()
        return super().try_restore()


@functools.lru_cache(maxsize=None)
def _reference_run(inject: int):
    jcfg = dataclasses.replace(jget_smoke("repro-100m"), n_layers=2)
    with tempfile.TemporaryDirectory() as d:
        t = _JTrainer(jcfg, make_host_mesh(), ckpt_dir=d, ckpt_every=4,
                     total_steps=10, lr=LR["lr_peak"])
        t.init_state(0)
        np_params = jax.tree.map(np.asarray, t.params)
        log = t.run(JSource(jcfg, JPipelineConfig(2, 32, seed=3),
                            n_batches=20), 10, inject_failure_at=inject)
        master = jax.tree.map(np.asarray, t.opt_state.master)
    return np_params, [(r["step"], r["loss"]) for r in log], master


@pytest.mark.parametrize("inject", [-1, 6], ids=["plain", "injected"])
def test_trainer_trajectory_matches_reference(inject, tmp_path):
    np_params, want, jmaster = _reference_run(inject)
    cfg = dataclasses.replace(get_smoke_config("repro-100m"), n_layers=2)
    t = Trainer(cfg, device="cpu", ckpt_dir=str(tmp_path), ckpt_every=4,
                total_steps=10, lr=LR["lr_peak"])
    t.params = from_jax_params(np_params, cfg, device="cpu", trainable=True)
    t.opt_state = adamw.adamw_init(t.params.parameters())
    log = t.run(SyntheticTokenSource(cfg, PipelineConfig(2, 32, seed=3),
                                     n_batches=20), 10,
                inject_failure_at=inject)
    assert [r["step"] for r in log] == [s for s, _ in want]
    if inject >= 0:          # restored to step 4 after 6 steps
        assert [s for s, _ in want] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    np.testing.assert_allclose([r["loss"] for r in log],
                               [l for _, l in want], rtol=0, atol=0.01)
    assert all(np.isfinite(r["wall_s"]) and r["input_stall_s"] >= 0
               for r in log)
    got = dict(flatten_with_paths(
        _np_tree(t.opt_state.master, param_names(t.params))))
    init = dict(flatten_with_paths(np_params))
    drift = np.mean([np.abs(got[p] - w).mean()
                     for p, w in flatten_with_paths(jmaster)])
    moved = np.mean([np.abs(w - init[p].astype(np.float32)).mean()
                     for p, w in flatten_with_paths(jmaster)])
    assert drift <= 0.05 * moved, (drift, moved)


def test_trainer_restores_the_newest_checkpoint(tmp_path):
    """A second trainer resumes where the first stopped, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("repro-100m"), n_layers=2)
    src = lambda: SyntheticTokenSource(cfg, PipelineConfig(2, 16, seed=1),
                                       n_batches=8)
    t1 = Trainer(cfg, device="cpu", ckpt_dir=str(tmp_path), ckpt_every=2,
                 total_steps=4)
    t1.init_state(0)
    t1.run(src(), 3)
    t2 = Trainer(cfg, device="cpu", ckpt_dir=str(tmp_path), total_steps=4)
    t2.init_state(5)
    assert t2.try_restore() and t2.step_idx == 3
    for a, b in zip(t1.params.parameters(), t2.params.parameters()):
        assert torch.equal(a, b)
    for f in ("master", "m", "v"):
        for a, b in zip(getattr(t1.opt_state, f), getattr(t2.opt_state, f)):
            assert torch.equal(a, b)
    assert int(t2.opt_state.step) == 3


# ---------------------------------------------------------------------------
# The entry point, and the kernels' refusal of gradients
# ---------------------------------------------------------------------------


def test_cpu_train_smoke_resumes(tmp_path):
    """The CLI trains on the CPU when asked, resumes from its checkpoint
    on a second run, and loads neither JAX nor the JAX package."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['train'] + sys.argv[1:]\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "print('LOADED', [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes')])\n")
    args = ["--arch", "repro-100m", "--smoke", "--device", "cpu", "--steps",
            "4", "--global-batch", "2", "--seq-len", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    outs = [subprocess.run([sys.executable, "-c", code, *args],
                           capture_output=True, text=True, env=env,
                           timeout=300) for _ in range(2)]
    for res in outs:
        assert res.returncode == 0, res.stderr
        assert "LOADED []" in res.stdout
    assert "resumed" not in outs[0].stdout
    assert "[train] resumed from step 4" in outs[1].stdout


def test_kernel_routes_refuse_inputs_that_require_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        kbuild.refuse_grad("flash_attention", torch.zeros(2), x)
    with torch.no_grad():
        kbuild.refuse_grad("flash_attention", x)
    kbuild.refuse_grad("ssd_scan", torch.zeros(2), x.detach())


def test_trainer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_smoke_config("repro-100m"))
