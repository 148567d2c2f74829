"""The port's compensated prefix sum (kernel K5's plain version, which the
port runs on the CPU) against the JAX reference's ``cumsum_ds``: the same
f32 inputs, made from a seed with numpy, must give the same bits.  The
reference's bits come from ``jax.lax.associative_scan``'s recursion tree,
so lengths that exercise its odd and even halves and its short base cases
are all here."""
import jax
import numpy as np
import pytest
import torch

from kai_scheduler_tpu.utils.numerics import cumsum_ds as ref_cumsum_ds
from kai_scheduler_tpu_torch.utils import numerics as NU
from jax_executables import release_jax_executables  # noqa: F401

_ref = jax.jit(ref_cumsum_ds)

LENGTHS = (0, 1, 2, 3, 7, 1000, 50_000)
#: one column, the resource axis, and the victim solver's Q*R table
#: (6 queues x 3 resources)
WIDTHS = (1, 3, 18)


def _values(rng, shape):
    """Magnitudes from 1e-3 to 1e9, both signs: f32 sums round."""
    mag = rng.uniform(1, 10, shape) * 10 ** rng.uniform(-3, 9, shape)
    return (mag * rng.choice([-1, 1], shape)).astype(np.float32)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("length", LENGTHS)
def test_cumsum_ds_bit_equal(length, width):
    for seed in range(3):
        x = _values(np.random.default_rng(seed), (length, width))
        want = np.asarray(_ref(x))
        got = NU.cumsum_ds(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert got.numpy().tobytes() == want.tobytes(), seed


def test_cumsum_ds_trailing_axes_and_axis():
    """A [U, Q, R] table scans along axis 0 as U x (Q*R) columns; a scan
    along another axis moves that axis first."""
    x = _values(np.random.default_rng(5), (257, 6, 3))
    want = np.asarray(_ref(x))
    assert NU.cumsum_ds(torch.from_numpy(x)).numpy().tobytes() == \
        want.tobytes()
    xt = np.ascontiguousarray(np.moveaxis(x, 0, 1))
    want_t = np.asarray(jax.jit(lambda a: ref_cumsum_ds(a, axis=1))(xt))
    got_t = NU.cumsum_ds(torch.from_numpy(xt), axis=1)
    assert got_t.numpy().tobytes() == want_t.tobytes()


def test_cumsum_ds_is_not_a_plain_scan():
    """The compensated scan differs from a plain f32 cumulative sum on
    these values — what makes the recursion order worth matching."""
    x = _values(np.random.default_rng(0), (1000, 3))
    got = NU.cumsum_ds(torch.from_numpy(x)).numpy()
    plain = np.cumsum(x, axis=0, dtype=np.float32)
    assert got.tobytes() != plain.tobytes()


#: (lanes, nodes, columns): the allocate chunk's axis-0 cumulatives over
#: lanes — [B, N, R] node claims, [B, N, D] device claims, [B, Q, R] queue
#: deltas — at widths on both sides of one block (16) and of one level of
#: block totals (256)
LANE_SHAPES = ((8, 50, 3), (20, 7, 3), (33, 5, 8), (64, 40, 3),
               (256, 40, 8), (300, 4, 3))


@pytest.mark.parametrize("shape", LANE_SHAPES)
def test_cumsum_blocked_matches_jnp_cumsum_over_lanes(shape):
    """``jnp.cumsum(x, axis=0)`` of a 3-D array on XLA:CPU adds in the same
    blocks of 16 as the 1-D case (fitted again for the per-task path's
    dense accept): sparse fractional claims, where a left-to-right scan
    differs in the last bit."""
    rng = np.random.default_rng(shape[0])
    v = rng.choice(np.array([0.3, 0.7, 0.5, 0.1, 1 / 3, 2.7], np.float32),
                   size=shape)
    x = np.where(rng.random(shape) < 0.6, v, 0).astype(np.float32) \
        * rng.random(shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.numpy.cumsum(a, axis=0))(x))
    got = NU.cumsum_blocked(torch.from_numpy(x), 0).numpy()
    assert want.tobytes() == got.tobytes()
    if shape[0] > NU.SCAN_BLOCK:
        seq = NU._cumsum_seq(torch.from_numpy(x)).numpy()
        assert seq.tobytes() != want.tobytes()
