"""PyTorch port, 35-mode SATD: the port's plain `satd_all_modes` /
`predict_all_modes_mm` (what a CPU tensor gets, and what the CUDA kernel
is held equal to on the card) against the JAX matmul path AND the Pallas
kernel in interpret mode. Integers: equal."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import intra as j_intra, intra_mm as j_mm
from hevc_tpu_torch.ops import intra as t_intra, intra_mm as t_mm

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Drop the XLA programs this module compiled once it is done: the
    test process is shared with the rest of the suite and memory is tight."""
    yield
    jax.clear_caches()
    gc.collect()


def _inputs(n, B, seed):
    rng = np.random.RandomState(seed)
    r_u = rng.randint(0, 256, (B, 4 * n + 1)).astype(np.int32)
    r_u[0] = 0
    r_u[0, 2 * n + 1] = 255    # negative VER/HOR edge sums before the clip
    r_u[1] = 255
    r_u[1, 2 * n] = 0
    orig = rng.randint(0, 256, (B, n, n)).astype(np.int32)
    return r_u, orig


@pytest.mark.parametrize("n", [4, 8, 16])
def test_satd_all_modes_equal(n):
    B = 70                     # deliberately not a multiple of any tile
    r_u, orig = _inputs(n, B, 3 * n + 1)
    tr_u = torch.from_numpy(r_u)
    tr_f = t_intra.filter_refs(tr_u)
    jr_u = jnp.asarray(r_u)
    jr_f = j_intra.filter_refs(jr_u)
    np.testing.assert_array_equal(tr_f.numpy(), np.asarray(jr_f))

    launches = t_mm.launches
    got = t_mm.satd_all_modes(tr_u, tr_f, torch.from_numpy(orig), n)
    assert t_mm.launches == launches          # CPU tensor: no kernel launch
    assert got.dtype == torch.int32 and got.shape == (B, 35)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(j_mm.satd_all_modes(jr_u, jr_f, jnp.asarray(orig), n)))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(j_mm._satd_all_modes_pallas(
            jr_u, jr_f, jnp.asarray(orig), n, component="luma", bit_depth=8,
            interpret=True)))
    # first minimum on ties, like jnp.argmin
    np.testing.assert_array_equal(
        torch.argmin(got, dim=1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(got.numpy()), axis=1)))


@pytest.mark.parametrize("component", ["luma", "chroma"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_predict_all_modes_mm_equal(n, component):
    r_u, _ = _inputs(n, 13, n)
    tr_u = torch.from_numpy(r_u)
    tr_f = t_intra.filter_refs(tr_u)
    got = t_mm.predict_all_modes_mm(tr_u, tr_f, n, component=component)
    want = j_mm.predict_all_modes_mm(jnp.asarray(r_u),
                                     jnp.asarray(tr_f.numpy()), n,
                                     component=component)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(t_mm._tables(n, component), j_mm._tables(n, component)):
        np.testing.assert_array_equal(a, b)


def test_cuda_wrapper_rejects_bad_operands():
    """Operand checks run before any launch; a CPU tensor never reaches
    the CUDA wrapper through satd_all_modes, so call it directly."""
    n, B = 8, 4
    r = torch.zeros((B, 4 * n + 1), dtype=torch.int32)
    o = torch.zeros((B, n, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        t_mm._satd_all_modes_cuda(r, r, o, 32, component="luma", bit_depth=8)
    with pytest.raises(ValueError):   # not on a CUDA device
        t_mm._satd_all_modes_cuda(r, r, o, n, component="luma", bit_depth=8)
