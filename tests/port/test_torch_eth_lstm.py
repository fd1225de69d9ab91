"""PyTorch port, ETH-LSTM: `hevc_tpu_torch.models.eth_lstm` on the CPU
against the JAX `hevc_tpu.models.eth_lstm` with the shipped checkpoint
(models/eth_lstm_qp30~35.npz) and with parameters from the JAX
`init_params`, carried across as numpy.

Tolerance: atol 1e-5 in float32 on probabilities and state — the
2688-wide products are summed in another order by each backend. The
split gates derived from the probabilities must be equal on this
content."""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.models import eth_lstm as j_lstm, hcpm as j_hcpm
from hevc_tpu_torch.models import eth_lstm as t_lstm, hcpm as t_hcpm

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


NPZ = os.path.join(os.path.dirname(__file__), "..", "..", "models",
                   "eth_lstm_qp30~35.npz")
THR = t_hcpm.DEFAULT_LDP


def _shipped():
    with np.load(NPZ) as z:
        return {k: z[k] for k in z.files}


def _init(seed):
    """Random parameters from the JAX package's own init, as numpy (one
    compiled program: op by op it compiles each of its 48 draws)."""
    return {k: np.asarray(v) for k, v in
            jax.jit(j_lstm.init_params)(jax.random.PRNGKey(seed)).items()}


def _residues(seed, B=10):
    """Residue patches around 128: zero residue (closes the gates), small
    and large noise, and a moving-edge pattern."""
    rng = np.random.RandomState(seed)
    r = np.full((B, 64, 64), 128, np.int32)
    r[1:4] += rng.randint(-6, 7, (3, 64, 64))
    r[4:7] += rng.randint(-60, 61, (3, 64, 64))
    r[7:, :, 20:28] += 90
    r[7:] += rng.randint(-3, 4, (B - 7, 64, 64))
    return np.clip(r, 0, 255).astype(np.uint8)


def _gates_equal(got, want):
    for g, w in zip(t_hcpm.split_gates(got, THR),
                    j_hcpm.split_gates(np.asarray(want), j_hcpm.DEFAULT_LDP)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("early_exit", ["ctu", "batch", "none"])
def test_step_matches_jax_shipped(early_exit):
    """Three steps with the state carried, both sides from zero."""
    params = _shipped()
    model = t_lstm.EthLstm.from_numpy(params, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    B = 10
    qp = np.full(B, 32.0, np.float32)
    st_t = t_lstm.zero_state(B, device="cpu")
    st_j = j_lstm.zero_state(B)
    for t in range(3):
        resi = _residues(t)
        fig = np.full(B, (t + 1) % 4, np.int32)
        p_t, st_t = t_lstm.step(model, torch.from_numpy(resi),
                                torch.from_numpy(qp), torch.from_numpy(fig),
                                st_t, thr_l1=THR.l1_lower,
                                thr_l2=THR.l2_lower, early_exit=early_exit)
        p_j, st_j = j_lstm.step_jit(jp, jnp.asarray(resi), jnp.asarray(qp),
                                    jnp.asarray(fig), st_j, THR.l1_lower,
                                    THR.l2_lower, early_exit=early_exit)
        assert p_t.shape == (B, 21) and p_t.dtype == torch.float32
        assert st_t.shape == (B, 2, 448)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j),
                                   atol=1e-5, rtol=0)
        _gates_equal(p_t, p_j)


def test_resi_features_matches_jax():
    params = _init(4)
    model = t_lstm.EthLstm.from_numpy(params, device="cpu")
    resi = _residues(5)
    got = t_lstm.resi_features(model, torch.from_numpy(resi)).numpy()
    want = np.asarray(jax.jit(j_lstm.resi_features)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(resi)))
    assert got.shape == (10, 448)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_apply_sequence_matches_stepwise_and_jax():
    params = _init(1)
    model = t_lstm.EthLstm.from_numpy(params, device="cpu")
    rng = np.random.RandomState(1)
    T, B = 4, 3
    resi = rng.randint(0, 256, (T, B, 64, 64)).astype(np.uint8)
    qp = np.full((T, B), 27.0, np.float32)
    fig = np.tile(np.arange(T)[:, None] % 4, (1, B)).astype(np.int32)
    seq = t_lstm.apply_sequence(model, torch.from_numpy(resi),
                                torch.from_numpy(qp), torch.from_numpy(fig))
    assert seq.shape == (T, B, 21)
    st = t_lstm.zero_state(B, device="cpu")
    for t in range(T):
        p, st = t_lstm.step(model, torch.from_numpy(resi[t]),
                            torch.from_numpy(qp[t]), torch.from_numpy(fig[t]),
                            st, early_exit="none")
        np.testing.assert_array_equal(p.numpy(), seq[t].numpy())
    want = jax.jit(j_lstm.apply_sequence)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(resi),
        jnp.asarray(qp), jnp.asarray(fig))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cell_clip():
    """A cell state far outside +-5 is clipped after the update, on both
    sides alike."""
    params = _shipped()
    model = t_lstm.EthLstm.from_numpy(params, device="cpu")
    B = 4
    st = np.zeros((B, 2, 448), np.float32)
    st[:, 0] = np.where(np.arange(448) % 2, 40.0, -40.0)
    resi = _residues(7)[:B]
    qp = np.full(B, 32.0, np.float32)
    fig = np.array([0, 1, 2, 3], np.int32)
    _, got = t_lstm.step(model, torch.from_numpy(resi), torch.from_numpy(qp),
                         torch.from_numpy(fig), torch.from_numpy(st))
    _, want = j_lstm.step_jit({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(resi), jnp.asarray(qp),
                              jnp.asarray(fig), jnp.asarray(st))
    c = got.numpy()[:, 0]
    assert np.abs(c).max() == t_lstm.CELL_CLIP
    assert (np.abs(c) == t_lstm.CELL_CLIP).mean() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_from_numpy_load_npz_and_errors():
    model = t_lstm.load_npz(NPZ, device="cpu")
    shipped = _shipped()
    assert set(model.params.keys()) == set(shipped) and len(shipped) == 42
    for k, v in shipped.items():
        np.testing.assert_array_equal(model.params[k].numpy(), v)
    assert {k: tuple(v.shape) for k, v in _init(0).items()} == \
        t_lstm.param_shapes()
    bad = dict(shipped)
    del bad["l32_lstm_b"]
    with pytest.raises(KeyError):
        t_lstm.EthLstm.from_numpy(bad, device="cpu")
    bad = dict(shipped, l64_fc2_w=np.zeros((68, 48), np.float32))
    with pytest.raises(ValueError):
        t_lstm.EthLstm.from_numpy(bad, device="cpu")
    with pytest.raises(ValueError):
        t_lstm.step(model, torch.full((1, 64, 64), 128), torch.ones(1),
                    torch.zeros(1, dtype=torch.int32),
                    t_lstm.zero_state(1, device="cpu"), early_exit="frame")


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_lstm.load_npz(NPZ)
    with pytest.raises(RuntimeError):
        t_lstm.zero_state(2)


# ------------------------------- the port's twins of tests/test_eth_lstm.py

def test_step_shapes_and_state_evolution():
    model = t_lstm.EthLstm.from_numpy(_init(0), device="cpu")
    rng = np.random.RandomState(0)
    B = 4
    resi = torch.from_numpy(rng.randint(0, 256, (B, 64, 64)).astype(np.uint8))
    qp = torch.full((B,), 32.0)
    fig = torch.tensor([1, 2, 3, 1], dtype=torch.int32)
    st = t_lstm.zero_state(B, device="cpu")
    probs, st1 = t_lstm.step(model, resi, qp, fig, st)
    assert probs.shape == (B, 21)
    assert st1.shape == (B, 2, 448)
    assert not np.allclose(st1.numpy(), 0.0)
    # state carries: same input with evolved state gives different output
    probs2, st2 = t_lstm.step(model, resi, qp, fig, st1)
    assert not np.allclose(probs.numpy(), probs2.numpy())
    assert np.abs(st2.numpy()[:, 0]).max() <= t_lstm.CELL_CLIP + 1e-5


def test_sequence_rollout_matches_stepwise():
    model = t_lstm.EthLstm.from_numpy(_init(1), device="cpu")
    rng = np.random.RandomState(1)
    T, B = 5, 3
    resi = rng.randint(0, 256, (T, B, 64, 64)).astype(np.uint8)
    qp = np.full((T, B), 27.0, np.float32)
    fig = np.tile(np.arange(T)[:, None] % 4, (1, B)).astype(np.int32)
    seq = t_lstm.apply_sequence(model, torch.from_numpy(resi),
                                torch.from_numpy(qp),
                                torch.from_numpy(fig)).numpy()
    st = t_lstm.zero_state(B, device="cpu")
    for t in range(T):
        p, st = t_lstm.step(model, torch.from_numpy(resi[t]),
                            torch.from_numpy(qp[t]), torch.from_numpy(fig[t]),
                            st, early_exit="none")
        np.testing.assert_allclose(p.numpy(), seq[t], rtol=1e-5, atol=1e-6)
