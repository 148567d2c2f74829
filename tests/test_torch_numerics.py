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
