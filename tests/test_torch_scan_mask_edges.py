"""K5 (``cumsum_ds``) and K12 (``affinity_mask``) at the shapes their card
kernels' designs must survive: the port's plain versions against the
reference on the seeded edge inputs of
``kai_scheduler_tpu_torch.state.kernel_edges`` (which the card tests and
``chip_smoke.py`` run through the kernels).

K5: ``kai_scheduler_tpu.utils.numerics.cumsum_ds`` against
``cumsum_ds_plain`` (and the wrapper, which takes it on the CPU) around
K5's 256-row tile and its 256-tile chunk of roots, at 216,001 rows, at
column counts that are no multiple of its 8-column group and on a
``[U, Q, R]`` table.  K12: ``valid & ~anti_forbid_nodes &
attract_allow_nodes`` of the reference (``ops/allocate.py:171``, ``:232``)
against ``affinity_mask_plain`` at 37, 48 and 100 nodes.  Every output is
bit-equal (tolerance 0).

The reference's ``cumsum_ds`` runs under ``jax.jit``, and eagerly for a
one-row table: there XLA folds the final ``s + e`` into ``s`` (``e`` is
then the constant zero), so a one-row ``-0.0`` comes back as ``-0.0``
under jit and as ``+0.0`` eagerly, as in the port; at every length above
one, jit adds the zero too.  The victim solver's tables have the padded
running-pod count as rows (a multiple of 8).
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.ops.allocate as RA
from kai_scheduler_tpu.utils import numerics as RN
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.state import kernel_edges as KE
from kai_scheduler_tpu_torch.utils import numerics as NU

_ref_cumsum_ds = jax.jit(RN.cumsum_ds, static_argnames=("axis",))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(KE.K5_CASES))
def test_cumsum_ds_edges_bit_equal(case):
    x = KE.k5_case(case)
    ref = RN.cumsum_ds if x.shape[0] == 1 else _ref_cumsum_ds
    want = _bits(ref(jnp.asarray(x), axis=0))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(_bits(NU.cumsum_ds_plain(t).numpy()), want)
    np.testing.assert_array_equal(_bits(NU.cumsum_ds(t).numpy()), want)
    assert np.isfinite(want.view(np.float32)).all()
    # the edges the kernel's tiles turn on are present
    U, tail = KE.K5_CASES[case]
    assert x.shape == (U,) + tail
    assert (x.view(np.int32) == np.int32(-2 ** 31)).any()   # -0.0


def _ref_state(c: dict):
    """The reference's view of a K12 case: the node and gang fields its
    affinity gates read, as JAX arrays."""
    nodes = types.SimpleNamespace(
        valid=jnp.asarray(c["valid"]), topology=jnp.asarray(c["topology"]),
        n=c["valid"].shape[0])
    gangs = types.SimpleNamespace(**{
        k: jnp.asarray(c[k]) for k in ("anti_avoids", "attract_needs",
                                       "anti_term_level", "attract_static")})
    return types.SimpleNamespace(nodes=nodes, gangs=gangs)


@pytest.mark.parametrize("case", list(KE.K12_CASES))
def test_affinity_mask_edges_bit_equal(case):
    c = KE.k12_case(case)
    ref = _ref_state(c)
    dom_ref, ta = RA.anti_domain_tables(ref)
    used, cand = jnp.asarray(c["anti_used"]), jnp.asarray(c["cand"])
    want = ref.nodes.valid & ~RA.anti_forbid_nodes(ref, used, dom_ref, cand)
    if c["attract"]:
        want = want & RA.attract_allow_nodes(ref, used, dom_ref, cand)
    st, used_t, dom, cand_t, attract = KE.k12_inputs(case)
    np.testing.assert_array_equal(dom.numpy(), np.asarray(dom_ref))
    assert ta == KE.K12_TERMS
    got = A.affinity_mask_plain(st, used_t, dom, cand_t, attract=attract)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(A.affinity_mask(st, used_t, dom, cand_t,
                                          attract=attract).numpy(),
                          got.numpy())
    # the edges the kernel's node vectors and slot lists turn on
    N, B, _ = KE.K12_CASES[case]
    assert got.shape == (B, N)
    assert not c["valid"].all() and (c["topology"] < 0).any()
    assert (~got.numpy()).any() and got.numpy().any()
