"""The port's error feedback against the JAX package's.

``repro_torch.optim.compression`` keeps each step's int8 quantization
residual and adds it to the next step's gradient, over a list of tensors.
The same seeded numpy gradients go through the JAX package's
``error_feedback_step`` (un-jitted, so its ``max|x| / 127`` is the IEEE
division the port does; see ``tests/test_torch_quantize.py``) and the
port's, step after step.

There is no tolerance: what is sent and the residuals carried are compared
bit for bit.  On the CPU the round trip runs the plain quantize and
dequantize; ``tests/test_torch_cuda.py`` holds the card's round trip,
through the kernels, to it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcompression

from repro_torch.optim import compression

torch.set_num_threads(1)

#: gradient shapes: a matrix, a vector, one not a whole number of blocks,
#: one of a single value
SHAPES = [(64, 96), (1024,), (3, 7, 13), (1,)]


def _grads(seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * rng.uniform(1e-4, 1e2)).astype(
        np.float32) for s in SHAPES]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_bit_exact_with_reference(dtype):
    for g in _grads(3):
        t = torch.from_numpy(g)
        j = jnp.asarray(g)
        if dtype == "bfloat16":
            t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
        got = compression.compress_decompress(t)
        want = jcompression.compress_decompress(j)
        assert got.dtype == t.dtype and got.shape == t.shape
        np.testing.assert_array_equal(_bits(got.float().numpy()),
                                      _bits(np.asarray(want, np.float32)))


def test_error_feedback_init_is_zero_f32_per_parameter():
    params = [torch.ones(s, dtype=torch.bfloat16) for s in SHAPES]
    state = compression.error_feedback_init(params)
    assert [tuple(r.shape) for r in state.residual] == SHAPES
    assert all(r.dtype == torch.float32 and not r.any()
               for r in state.residual)


@pytest.mark.parametrize("block", [256, 64])
def test_error_feedback_bit_exact_over_steps(block):
    """Five steps: what is sent and the residuals, each step, equal the
    reference's bit for bit; the residual is never zero after the first
    step (the feedback is exercised)."""
    state = compression.error_feedback_init(
        [torch.zeros(s) for s in SHAPES])
    jstate = jcompression.error_feedback_init(
        [jnp.zeros(s, jnp.float32) for s in SHAPES])
    for step in range(5):
        grads = _grads(100 + step)
        sent, state = compression.error_feedback_step(
            [torch.from_numpy(g) for g in grads], state, block)
        jsent, jstate = jcompression.error_feedback_step(
            [jnp.asarray(g) for g in grads], jstate, block)
        for got, want in zip(sent, jsent, strict=True):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        for got, want in zip(state.residual, jstate.residual, strict=True):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        assert any(r.abs().max() > 0 for r in state.residual)


def test_error_feedback_carries_what_was_not_sent():
    """sent + residual is the corrected gradient, exactly, and the
    residual stays within half a quantization step of each block."""
    grads = [torch.from_numpy(g) for g in _grads(7)]
    state = compression.error_feedback_init(grads)
    sent, state = compression.error_feedback_step(grads, state)
    for g, s, r in zip(grads, sent, state.residual):
        assert torch.equal(s + r, g)
        flat = torch.nn.functional.pad(g.reshape(-1),
                                       (0, (-g.numel()) % 256))
        half = flat.reshape(-1, 256).abs().amax(1) / 127 / 2
        bound = half.repeat_interleave(256)[:g.numel()].reshape(g.shape)
        assert bool((r.abs() <= bound * (1 + 1e-6)).all())
