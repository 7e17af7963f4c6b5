"""The numerical design of the tensor-core SSD kernel, on the CPU.

``ref.ssd_scan_split_ref`` is the kernel's arithmetic in plain PyTorch:
chunk by chunk with the f32 state carried across chunks, every product
over bf16 factors with f32 sums, and the three f32 factors (W in W.x, the
state in C.state, wdt x in the state update) cut into a hi and a lo bf16
part at the places the kernel cuts them.  On the same seeded numpy inputs
it agrees with the JAX oracle ``ssd_chunked`` and the Pallas kernel in
interpret mode within the tolerance the kernel is held to on the card
(``SSD_TOL`` of ``chip_smoke.py``: y within 1e-3 of its largest magnitude
plus 8e-3 relative, the final state within 1e-4 of its largest magnitude
plus 1e-3 relative).  One bf16 part alone, the rounding a plain bf16
tensor-core product would make, misses the state's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_bhsd as jax_ssd_scan
from repro.models import ssm as jssm

from repro_torch.kernels import ref

torch.set_num_threads(1)

SSD_TOL = {"y": dict(atol_share=1e-3, rtol=8e-3),
           "state": dict(atol_share=1e-4, rtol=1e-3)}


def _inputs(G, seed, *, B=2, H=4, S=128, P=16, N=32):
    """Kernel-layout inputs as the model makes them, f32 numpy: x, B, C
    rounded to bf16 values, dt the softplus of a projection plus a
    per-head bias (0.001..0.3), A = -(1..16)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    x = bf(rng.standard_normal((B, H, S, P)))
    raw = rng.standard_normal((B, H, S)).astype(np.float32) * 0.5
    bias = np.linspace(-7.0, -1.5, H, dtype=np.float32)[None, :, None]
    dt = np.log1p(np.exp(raw + bias)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm = bf(rng.standard_normal((B, G, S, N)))
    Cm = bf(rng.standard_normal((B, G, S, N)))
    return x, dt, A, Bm, Cm


def _misses(got, want, atol_share, rtol) -> int:
    """How many elements of ``got`` lie outside the tolerance."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = atol_share * np.abs(want).max()
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


def _oracle(x, dt, A, Bm, Cm, chunk):
    """The JAX oracle in the model's layout, back in the kernel's."""
    jy, js = jssm.ssd_chunked(
        jnp.asarray(x.transpose(0, 2, 1, 3)), jnp.asarray(dt.transpose(0, 2, 1)),
        jnp.asarray(A), jnp.asarray(Bm.transpose(0, 2, 1, 3)),
        jnp.asarray(Cm.transpose(0, 2, 1, 3)), chunk)
    return np.asarray(jy).transpose(0, 2, 1, 3), np.asarray(js)


@pytest.mark.parametrize("G", [1, 2])
def test_split_arithmetic_matches_oracle_and_pallas(G):
    """Four chunks of 32, so the state carries three times; f32 outputs
    (the inputs are bf16 values, so the kernel sees the same factors)."""
    ins = _inputs(G, seed=G)
    y, state = ref.ssd_scan_split_ref(*(torch.from_numpy(a) for a in ins),
                                      chunk=32)
    assert y.shape == (2, 4, 128, 16) and state.shape == (2, 4, 16, 32)
    jy, js = _oracle(*ins, 32)
    pallas = np.asarray(jax_ssd_scan(*(jnp.asarray(a) for a in ins),
                                     chunk=32, interpret=True))
    for want in (jy, pallas):
        assert _misses(y.numpy(), want, **SSD_TOL["y"]) == 0
    assert _misses(state.numpy(), js, **SSD_TOL["state"]) == 0
    # and the port's own plain version, which the kernel is checked with
    py, ps = ref.ssd_scan_ref(*(torch.from_numpy(a) for a in ins), chunk=32)
    assert _misses(y.numpy(), py.numpy(), **SSD_TOL["y"]) == 0
    assert _misses(state.numpy(), ps.numpy(), **SSD_TOL["state"]) == 0


@pytest.mark.parametrize("G", [1, 2])
def test_split_arithmetic_in_bf16_matches_pallas(G):
    """bf16 x, B, C in and y out, as the model runs the kernel."""
    x, dt, A, Bm, Cm = _inputs(G, seed=10 + G)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y, _ = ref.ssd_scan_split_ref(bf(x), torch.from_numpy(dt),
                                  torch.from_numpy(A), bf(Bm), bf(Cm),
                                  chunk=32)
    assert y.dtype == torch.bfloat16
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    pallas = jax_ssd_scan(jbf(x), jnp.asarray(dt), jnp.asarray(A), jbf(Bm),
                          jbf(Cm), chunk=32, interpret=True)
    assert _misses(y.float().numpy(), np.asarray(pallas, np.float32),
                   **SSD_TOL["y"]) == 0


def test_one_bf16_part_misses_the_state_tolerance():
    """At the kernel's widths (P 64, N 128), the state update's factor
    wdt x rounded once to bf16 moves the final state outside its
    tolerance; the hi + lo pair holds it."""
    ins = [torch.from_numpy(a) for a in _inputs(1, seed=0, B=1, H=2,
                                                   P=64, N=128)]
    _, want = ref.ssd_scan_ref(*ins, chunk=32)
    _, two = ref.ssd_scan_split_ref(*ins, chunk=32, parts=2)
    _, one = ref.ssd_scan_split_ref(*ins, chunk=32, parts=1)
    assert _misses(two.numpy(), want.numpy(), **SSD_TOL["state"]) == 0
    assert _misses(one.numpy(), want.numpy(), **SSD_TOL["state"]) > 100


def test_bf16_parts_sum_back_to_the_value():
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32)) * 10.0 ** torch.linspace(-3, 3, 4096)
    hi, lo = ref.bf16_parts(v)
    assert torch.equal(hi, v.to(torch.bfloat16).float())
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -16
    (one,) = ref.bf16_parts(v, parts=1)
    assert float(((one - v).abs() / v.abs()).max()) > 2.0 ** -12
