"""PyTorch port, the whole-frame reconstruction kernel's host side and
arithmetic: step tables against the JAX package's, the kernel's
predictor and transforms (NumPy mirrors) against the tensor ops, the
batched entry point on the CPU against the sequential NumPy golden
encoder, and the kernel's own source — built as plain C++, the threads of
a block as a loop — against the plain PyTorch version. All comparisons
are of integers and exact (tolerance 0)."""

import functools
import gc

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.core.yuv import pad_frame
from hevc_tpu.entropy import headers as j_headers
from hevc_tpu.ops import transforms as j_transforms
from hevc_tpu.pipeline import golden, recon_pallas
from hevc_tpu_torch.ops import intra as t_intra, transforms as t_transforms
from hevc_tpu_torch.pipeline import bench_hooks, recon as t_recon
from hevc_tpu_torch.pipeline import recon_kernel as rk

from tests.test_e2e_bitstream import synth_frame
from tests.port.torch_threads import one_torch_thread  # noqa: F401

PLANES = ("recon_y", "recon_cb", "recon_cr", "coef_y", "coef_cb", "coef_cr")
CASES = [(w, h, qp, rdoq) for (w, h) in ((128, 64), (96, 80))
         for qp in (22, 37) for rdoq in (True, False)]


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_programs():
    yield
    jax.clear_caches()
    gc.collect()


# ---------------------------------------------------------------------------
# NumPy mirrors of the kernel's arithmetic: the predictor of
# `predict_sample` (taps from the mode's angle, no table) and the int32
# transform path (matrix = rows of the 32-point DCT, the kernel's shifts)
# ---------------------------------------------------------------------------

def angular_taps(mode: int, n: int):
    """(idx0, idx1, fact) [n, n] of an angular mode, computed from the
    mode's angle the way `predict_sample` of the kernel does."""
    angle = t_intra.INTRA_ANGLES[mode]
    vert = mode >= 18
    y, x = np.mgrid[0:n, 0:n]
    u, v = (x, y) if vert else (y, x)
    t = (v + 1) * angle
    fact = t & 31
    k1 = u + (t >> 5) + 1

    def main_ref(k):
        inv = t_intra.INV_ANGLES.get(mode, 0)
        j = ((k * inv + 128) >> 8) - 1
        pos = 2 * n + k if vert else 2 * n - k
        neg = 2 * n - 1 - j if vert else 2 * n + 1 + j
        return np.where(k >= 0, pos, neg)

    ia = main_ref(k1)
    ib = np.where(fact != 0, main_ref(k1 + 1), ia)
    return ia.astype(np.int32), ib.astype(np.int32), fact.astype(np.int32)


def predict_np(r, mode: int, n: int, component: str = "luma"):
    """One TU's prediction [n, n] from substituted (and, where the mode
    asks, filtered) references r [4n+1], in the kernel's arithmetic."""
    r = np.asarray(r, np.int64)
    log2n = n.bit_length() - 1
    edge = component == "luma" and n < 32
    left = r[:2 * n][::-1]                       # left[j] = r[2n-1-j]
    top = r[2 * n + 1:]
    corner = r[2 * n]
    y, x = np.mgrid[0:n, 0:n]
    if mode == 0:
        return ((n - 1 - x) * left[y] + (x + 1) * top[n]
                + (n - 1 - y) * top[x] + (y + 1) * left[n] + n) >> (log2n + 1)
    if mode == 1:
        dc = (top[:n].sum() + left[:n].sum() + n) >> (log2n + 1)
        out = np.full((n, n), dc, np.int64)
        if edge:
            out[0, :] = (top[:n] + 3 * dc + 2) >> 2
            out[:, 0] = (left[:n] + 3 * dc + 2) >> 2
            out[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
        return out
    ia, ib, fact = angular_taps(mode, n)
    out = ((32 - fact) * r[ia] + fact * r[ib] + 16) >> 5
    if edge and mode == 26:
        out[:, 0] = np.clip(top[0] + ((left[:n] - corner) >> 1), 0, 255)
    if edge and mode == 10:
        out[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1), 0, 255)
    return out


def _matrix_np(n: int, use_dst: bool):
    if use_dst:
        return t_transforms.dst_matrix().astype(np.int64)
    return t_transforms.dct_matrix(32)[::32 // n, :n].astype(np.int64)


def forward_np(resi, use_dst=False):
    """Forward transform of one [n, n] residual block in the kernel's
    int32 arithmetic: columns with shift log2n - 1, rows with log2n + 6."""
    x = np.asarray(resi, np.int64)
    n = x.shape[-1]
    log2n = n.bit_length() - 1
    t = _matrix_np(n, use_dst)
    s1, s2 = log2n - 1, log2n + 6
    b = (t @ x + (1 << (s1 - 1))) >> s1
    out = (b @ t.T + (1 << (s2 - 1))) >> s2
    assert np.abs(out).max(initial=0) < 2 ** 31
    return out.astype(np.int32)


def inverse_np(coef, use_dst=False):
    """Inverse transform of one [n, n] block of dequantized coefficients
    in the kernel's arithmetic: shifts 7 and 12, a 16-bit clip after each."""
    c = np.asarray(coef, np.int64)
    t = _matrix_np(c.shape[-1], use_dst)
    b = np.clip((t.T @ c + 64) >> 7, -32768, 32767)
    return np.clip((b @ t + 2048) >> 12, -32768, 32767).astype(np.int32)


def test_step_tables_equal_the_reference():
    lu, ch = rk.luma_steps(), rk.chroma_steps()
    assert lu.shape == (344, 8) and ch.shape == (88, 8)   # 2 x 88 = 176 TBs
    assert rk.STEP_ROWS == {"luma": 344, "chroma": 88}
    np.testing.assert_array_equal(lu, recon_pallas._luma_steps())
    np.testing.assert_array_equal(ch, recon_pallas._chroma_steps())
    np.testing.assert_array_equal(rk.node_table(), t_recon.node_table())


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("component", ["luma", "chroma"])
def test_kernel_predictor_equals_predict_selected_modes(component, n):
    """Taps computed from the mode's angle, planar, DC and the luma edges,
    the way the kernel computes them, for all 35 modes."""
    rng = np.random.RandomState(10 * n + len(component))
    r = rng.randint(0, 256, (35, 4 * n + 1)).astype(np.int32)
    r[3] = 255
    r[4] = 0
    modes = np.arange(35)
    want = t_intra.predict_selected_modes(
        torch.as_tensor(r), torch.as_tensor(modes), n,
        component=component).numpy()
    for m in modes:
        np.testing.assert_array_equal(
            predict_np(r[m], int(m), n, component), want[m], f"mode {m}")
        if m >= 2:
            for got, ref in zip(angular_taps(int(m), n),
                                t_intra._angular_tables(int(m), n)):
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,use_dst", [(4, True), (4, False), (8, False),
                                       (16, False), (32, False)])
def test_kernel_transforms_equal_ops_transforms(n, use_dst):
    """The int32 transform path with the kernel's shifts and its matrix
    (rows of the 32-point one) against the tensor ops of both packages."""
    rng = np.random.RandomState(n + use_dst)
    resi = rng.randint(-255, 256, (6, n, n)).astype(np.int32)
    resi[0] = 255
    resi[1] = -255
    coef = t_transforms.forward_transform(torch.as_tensor(resi),
                                          use_dst=use_dst).numpy()
    np.testing.assert_array_equal(
        coef, j_transforms.forward_transform_np(resi, use_dst=use_dst))
    deq = np.clip(coef * 3, -32768, 32767)
    deq[2] = rng.choice([-32768, 32767], (n, n))
    back = t_transforms.inverse_transform(torch.as_tensor(deq),
                                          use_dst=use_dst).numpy()
    np.testing.assert_array_equal(
        back, j_transforms.inverse_transform_np(deq, use_dst=use_dst))
    for i in range(6):
        np.testing.assert_array_equal(forward_np(resi[i], use_dst), coef[i])
        np.testing.assert_array_equal(inverse_np(deq[i], use_dst), back[i])


def uniform_decisions(pad_w, pad_h, depth, nxn, seed):
    """Decisions of one depth everywhere (raised where a CU would cross
    the frame edge), NxN on every 8x8 CU if `nxn`, seeded random modes:
    every TU of a plane has one size, so each instance of the kernel's TU
    body (`code_tu<S, N, DST>`) is reached on its own."""
    rng = np.random.RandomState(seed)
    h8, w8 = pad_h // 8, pad_w // 8
    d8 = np.full((h8, w8), depth, np.int32)
    for y in range(h8):
        for x in range(w8):
            while True:
                s = 8 >> d8[y, x]
                if (x // s + 1) * s <= w8 and (y // s + 1) * s <= h8:
                    break
                d8[y, x] += 1
    m4 = np.zeros((2 * h8, 2 * w8), np.int32)
    for y in range(h8):
        for x in range(w8):
            s = 8 >> d8[y, x]
            if x % s == 0 and y % s == 0:
                m4[2 * y:2 * (y + s), 2 * x:2 * (x + s)] = rng.randint(0, 35)
    nxn8 = (d8 == 3) & nxn
    for y, x in zip(*np.nonzero(nxn8)):
        m4[2 * y:2 * y + 2, 2 * x:2 * x + 2] = rng.randint(0, 35, (2, 2))
    return d8, m4[::2, ::2].copy(), m4, nxn8


def _stack_case(cfg, pfs, dec, qp, rdoq):
    """The batched tensors of frames and decisions, and the plain result."""
    stack = lambda xs, dt: torch.as_tensor(np.stack(xs)).to(dt).contiguous()
    args = (stack([p.y for p in pfs], torch.uint8),
            stack([p.cb for p in pfs], torch.uint8),
            stack([p.cr for p in pfs], torch.uint8),
            stack([d[0] for d in dec], torch.int32),
            stack([d[2] for d in dec], torch.int32),
            stack([d[3] for d in dec], torch.bool))
    kw = dict(qp=qp, pad_w=cfg.pad_width, pad_h=cfg.pad_height, rdoq=rdoq)
    t_recon.batches = 0
    plain = t_recon.encode_frame_planes_batched(*args, **kw, device="cpu")
    assert t_recon.batches > 0          # CPU tensors: the plain version
    return args, kw, plain


@functools.lru_cache(maxsize=None)
def _case(w, h, qp, rdoq):
    """Two seeded frames with seeded legal decisions (mixed depths, forced
    boundary splits, NxN), their batched tensors and the plain result."""
    cfg = j_headers.EncoderConfig(width=w, height=h, qp=qp, rdoq=rdoq)
    pw, ph = cfg.pad_width, cfg.pad_height
    pfs = [pad_frame(synth_frame(w, h, seed=w + qp + f), pw, ph)
           for f in range(2)]
    dec = [bench_hooks.random_legal_decisions(pw, ph, h + qp + f)
           for f in range(2)]
    args, kw, plain = _stack_case(cfg, pfs, dec, qp, rdoq)
    return cfg, pfs, dec, args, kw, plain


@pytest.mark.parametrize("w,h,qp,rdoq", CASES)
def test_batched_entry_on_cpu_equals_golden(w, h, qp, rdoq):
    cfg, pfs, dec, _, _, plain = _case(w, h, qp, rdoq)
    assert plain.recon_y.dtype == torch.uint8
    assert plain.coef_y.dtype == torch.int16
    assert plain.recon_y.shape == (2, cfg.pad_height, cfg.pad_width)
    for f in range(2):
        d8, m8, m4, nxn = dec[f]
        assert nxn.any() and len(np.unique(d8)) >= 3
        gdec, grec = golden.GoldenEncoder(cfg).encode_frame(
            pfs[f], d8, m8, modes4=m4, nxn8=nxn)
        for name, want in zip(PLANES, (grec.y, grec.cb, grec.cr,
                                       gdec["coef_y"], gdec["coef_cb"],
                                       gdec["coef_cr"])):
            np.testing.assert_array_equal(
                getattr(plain, name)[f].numpy(), want, f"{name} frame {f}")
    assert int(plain.coef_y.ne(0).sum()) > 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel's source built for the CPU with g++."""
    return rk.load_host_build(
        str(tmp_path_factory.mktemp("recon_frame") / "librecon_host.so"))


@pytest.mark.parametrize("w,h,qp,rdoq", CASES)
def test_kernel_source_built_for_the_cpu_equals_plain(host_lib, w, h, qp,
                                                      rdoq):
    """Every TU step of `csrc/recon_frame.cu` (references, availability,
    substitution, filter, prediction, transforms, RDOQ, write-back) on the
    wavefront schedule of its launcher, against the plain version."""
    cfg, _, _, args, kw, plain = _case(w, h, qp, rdoq)
    launches = rk.launches
    got, made = rk.run(host_lib, *args, **kw, stream=None)
    # one launch per wavefront diagonal covers Y, Cb and Cr
    assert made == cfg.ctus_x + 2 * (cfg.ctus_y - 1)
    assert rk.launches == launches      # only the CUDA wrapper counts
    for name, g in zip(PLANES, got):
        want = getattr(plain, name)
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g.numpy(), want.numpy(), name)


UNIFORM = [(w, h, depth, nxn, qp, rdoq) for (w, h) in ((128, 64), (96, 80))
           for (depth, nxn) in ((1, False), (2, False), (3, False), (3, True))
           for (qp, rdoq) in ((22, True), (37, False))]


@pytest.mark.parametrize("w,h,depth,nxn,qp,rdoq", UNIFORM)
def test_kernel_source_on_uniform_depth_equals_plain(host_lib, w, h, depth,
                                                     nxn, qp, rdoq):
    """One TU size per plane (32/16, 16/8, 8/4 or, under NxN, 4/4 for
    luma/chroma; the partial CTUs of 96x80 raise the depth at the edge),
    so that each TU body instance of the source is held to the plain
    version on its own, on all six planes, with RDOQ on and off."""
    cfg = j_headers.EncoderConfig(width=w, height=h, qp=qp, rdoq=rdoq)
    pw, ph = cfg.pad_width, cfg.pad_height
    pfs = [pad_frame(synth_frame(w, h, seed=depth + f), pw, ph)
           for f in range(2)]
    dec = [uniform_decisions(pw, ph, depth, nxn, 10 * depth + f)
           for f in range(2)]
    assert all((d[0] >= depth).all() and d[3].any() == nxn for d in dec)
    args, kw, plain = _stack_case(cfg, pfs, dec, qp, rdoq)
    got, made = rk.run(host_lib, *args, **kw, stream=None)
    assert made == cfg.ctus_x + 2 * (cfg.ctus_y - 1)
    for name, g in zip(PLANES, got):
        np.testing.assert_array_equal(g.numpy(), getattr(plain, name).numpy(),
                                      name)
    assert int(plain.coef_y.ne(0).sum()) > 0


def test_component_groups_run_apart(host_lib):
    """`components` selects the planes of each launch (Y; Cb and Cr; all
    three): each selection makes one launch per diagonal and leaves the
    other planes zero."""
    cfg, _, _, args, kw, plain = _case(96, 80, 37, True)
    n_diag = cfg.ctus_x + 2 * (cfg.ctus_y - 1)
    luma, made_y = rk.run(host_lib, *args, **kw, stream=None,
                          components=("luma",))
    chroma, made_c = rk.run(host_lib, *args, **kw, stream=None,
                            components=("chroma",))
    both, made = rk.run(host_lib, *args, **kw, stream=None,
                        components=("chroma", "luma"))
    assert made_y == made_c == made == n_diag
    for i in (0, 3):
        assert torch.equal(luma[i], plain[i]) and not chroma[i].any()
    for i in (1, 2, 4, 5):
        assert torch.equal(chroma[i], plain[i]) and not luma[i].any()
    for i in range(6):
        assert torch.equal(both[i], plain[i])
    with pytest.raises(ValueError):
        rk.run(host_lib, *args, **kw, stream=None, components=("cb",))


@pytest.mark.parametrize("what", ["dtype", "shape", "layout", "qp", "cpu",
                                  "steps"])
def test_wrapper_refuses_what_the_kernel_does_not_take(host_lib, what,
                                                       monkeypatch):
    _, _, _, args, kw, _ = _case(96, 80, 37, True)
    args = list(args)
    if what == "cpu":
        # the CUDA wrapper takes CUDA tensors only; there is no fallback
        with pytest.raises(ValueError):
            rk.encode_frame_planes_cuda(*args, **kw)
        return
    if what == "steps":
        # a step table longer than the kernel's leaf list is refused before
        # the launch, not reported as a CUDA error
        steps_y, steps_c, t32, dst4 = rk._tables_t(args[0].device)
        monkeypatch.setattr(rk, "_tables_t", lambda dev: (
            torch.cat([steps_y, steps_y[:1]]), steps_c, t32, dst4))
        with pytest.raises(ValueError, match="luma step table"):
            rk.run(host_lib, *args, **kw, stream=None)
        return
    if what == "dtype":
        args[3] = args[3].to(torch.int64)
        err = TypeError
    elif what == "shape":
        args[4] = args[4][:, :-1].contiguous()
        err = ValueError
    elif what == "layout":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    else:
        kw = dict(kw, qp=52)
        err = ValueError
    with pytest.raises(err):
        rk.run(host_lib, *args, **kw, stream=None)


@pytest.mark.slow
def test_batched_plain_equals_pallas_interpret():
    """The TPU kernel itself, in Pallas interpret mode (minutes on a
    CPU): one 64x64 CTU, two frames."""
    cfg, _, _, args, kw, plain = _case(64, 64, 32, True)
    ref = recon_pallas.encode_frame_planes_pallas(
        *(a.numpy() for a in args), qp=32, pad_w=64, pad_h=64, rdoq=True,
        interpret=True)
    for name in PLANES:
        np.testing.assert_array_equal(getattr(plain, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
