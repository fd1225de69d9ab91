"""PyTorch port, the 35-mode SATD kernel's own source: `csrc/satd35.cu`
built as plain C++ with g++ (the threads of a block become a loop) and
held equal to the plain version `satd_all_modes_plain`, which
`test_torch_intra_mm.py` holds to the JAX package and its Pallas kernel.
Integers: equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from hevc_tpu_torch.ops import intra, intra_mm

from tests.port.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's source built once for the CPU."""
    return intra_mm.load_host_build(
        str(tmp_path_factory.mktemp("satd35") / "libsatd35_host.so"))


def _inputs(n, B, seed):
    """Refs (unfiltered, filtered) and originals from a numpy seed; nodes
    0 and 1 make the VER/HOR edge sums negative before the clip."""
    rng = np.random.RandomState(seed)
    r_u = rng.randint(0, 256, (B, 4 * n + 1)).astype(np.int32)
    r_u[0] = 0
    r_u[0, 2 * n + 1] = 255
    r_u[1] = 255
    r_u[1, 2 * n] = 0
    orig = rng.randint(0, 256, (B, n, n)).astype(np.int32)
    r_u = torch.from_numpy(r_u)
    return r_u, intra.filter_refs(r_u).contiguous(), torch.from_numpy(orig)


@pytest.mark.parametrize("B", [70, 33])
@pytest.mark.parametrize("component", ["luma", "chroma"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_host_build_equals_plain(host_lib, n, component, B):
    """Every mode of every node, a ragged last block of 6 or 1 nodes."""
    r_u, r_f, orig = _inputs(n, B, 5 * n + B)
    got = intra_mm.run(host_lib, r_u, r_f, orig, n, component=component)
    want = intra_mm.satd_all_modes_plain(r_u, r_f, orig, n,
                                         component=component)
    assert got.dtype == torch.int32 and got.shape == (B, 35)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("n", [4, 8, 16])
def test_host_build_is_zero_at_each_modes_own_prediction(host_lib, n):
    """Node m's original is the plain prediction of mode m: the kernel's
    SATD at [m, m] is 0, so every sample of every mode's prediction is
    the plain version's; everywhere else the two versions agree."""
    r_u, r_f, _ = _inputs(n, 35, 11 * n)
    preds = intra_mm.predict_all_modes_mm(r_u, r_f, n)
    orig = preds[torch.arange(35), torch.arange(35)].contiguous()
    got = intra_mm.run(host_lib, r_u, r_f, orig, n)
    assert (torch.diagonal(got) == 0).all()
    np.testing.assert_array_equal(
        got.numpy(), intra_mm.satd_all_modes_plain(r_u, r_f, orig, n).numpy())


@pytest.mark.parametrize("what", ["n", "dtype", "shape", "layout"])
def test_run_refuses_what_the_kernel_does_not_take(host_lib, what):
    n, B = 8, 4
    r = torch.zeros((B, 4 * n + 1), dtype=torch.int32)
    o = torch.zeros((B, n, n), dtype=torch.int32)
    args, err = [r, r, o], ValueError
    if what == "n":
        n = 32
    elif what == "dtype":
        args[2], err = o.to(torch.int16), TypeError
    elif what == "shape":
        args[1] = r[:, :-1].contiguous()
    else:
        args[2] = o.transpose(1, 2)
    with pytest.raises(err):
        intra_mm.run(host_lib, *args, n)
