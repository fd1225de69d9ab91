"""PyTorch port, ETH-CNN: the shipped checkpoint and a seeded random
parameter set through `eth_cnn.apply` (JAX, all three early-exit modes),
`apply_numpy` and the port's `EthCnn` on the CPU.

Tolerance: atol 1e-5 in float32 — the 2688-wide products are summed in
another order by each backend. The gates derived from the probabilities
must be equal on this content."""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.models import eth_cnn as j_cnn, hcpm as j_hcpm
from hevc_tpu_torch.models import eth_cnn as t_cnn, hcpm as t_hcpm

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    """Drop the XLA programs this module compiled once it is done: the
    test process is shared with the rest of the suite and memory is tight."""
    yield
    jax.clear_caches()
    gc.collect()


NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_cnn_qp30~35.npz")


def _shipped():
    with np.load(NPZ) as z:
        return {k: z[k] for k in z.files}


def _random(seed=3):
    rng = np.random.RandomState(seed)
    return {k: (0.1 * np.clip(rng.randn(*s), -2, 2)).astype(np.float32)
            for k, s in t_cnn.param_shapes().items()}


def _ctus(seed):
    f = synth_frame(256, 128, seed=seed)
    y = f.y.reshape(2, 64, 4, 64).transpose(0, 2, 1, 3).reshape(8, 64, 64)
    flat = np.full((1, 64, 64), 77, np.uint8)       # closes the l64 gate
    return np.concatenate([y, flat])


@pytest.mark.parametrize("early_exit", ["ctu", "batch", "none"])
@pytest.mark.parametrize("which", ["shipped", "random"])
def test_eth_cnn_matches_jax(which, early_exit):
    params = _shipped() if which == "shipped" else _random()
    luma = _ctus(5)
    qp = np.full(luma.shape[0], 32.0, np.float32)
    model = t_cnn.EthCnn.from_numpy(params, device="cpu")
    got = t_cnn.apply(model, torch.from_numpy(luma), torch.from_numpy(qp),
                      early_exit=early_exit).numpy()
    want = np.asarray(j_cnn.apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(luma),
        jnp.asarray(qp), early_exit=early_exit))
    assert got.shape == (luma.shape[0], 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if early_exit == "batch":
        np.testing.assert_allclose(
            got, j_cnn.apply_numpy(params, luma, qp), atol=1e-5, rtol=0)
    for g, w in zip(t_hcpm.split_gates(torch.from_numpy(got),
                                       t_hcpm.DEFAULT_AI),
                    j_hcpm.split_gates(want, j_hcpm.DEFAULT_AI)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_load_npz_and_bands():
    model = t_cnn.load_npz(NPZ, device="cpu")
    for k, v in _shipped().items():
        np.testing.assert_array_equal(model.params[k].numpy(), v)
    from hevc_tpu.train.train_cnn import band_for_qp
    for qp in (20, 24, 25, 29, 30, 32, 34, 35, 51):
        assert t_cnn.band_for_qp(qp) == band_for_qp(qp)
    bad = _shipped()
    del bad["l16_fc3_b"]
    with pytest.raises(KeyError):
        t_cnn.EthCnn.from_numpy(bad, device="cpu")


def test_no_cpu_fallback_without_a_card():
    """device=None means the card: with none present the entry points
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    with pytest.raises(RuntimeError):
        t_cnn.load_npz(NPZ)
    with pytest.raises(RuntimeError):
        AIEncoder(EncoderConfig(64, 64))
