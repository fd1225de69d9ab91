"""Benchmark entry points, the HM baselines they are compared with,
synthetic content and work counts for the port's drives and smoke runs.

The HM baselines are seconds per frame of the in-repo HM-16.5 encoder
(`tools/hm/TAppEncoderStatic`) on the benchmark's own content, timed once
on the GPU machine's host by `measure_hm_baseline(force=True)` and
`measure_hm_ldp_baseline(force=True)` and cached in the port's own file,
`HM_BASELINE_CACHE`. The benchmarks only read the cache (a missing cache
or key raises); they never run HM.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np

from ..core.yuv import Frame, write_yuv420

_MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                       "models")
#: the shipped ETH-CNN checkpoint of the QP 30..35 band
WEIGHTS_QP32 = os.path.join(_MODELS, "eth_cnn_qp30~35.npz")
#: the port's HM timing cache (JSON), written only by the measure_* calls
HM_BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "hm_baseline.json")


def synth_structured(n_frames=2, seed=7, width=1920, height=1080):
    """Natural-ish content: smooth gradients + textured regions + a
    moving high-contrast block — the CU tree is non-trivial and
    compressible, unlike uniform noise. At the default size this is the
    1080p clip of `synth_1080p_structured`."""
    rng = np.random.RandomState(seed)
    h, w = height, width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = rng.randint(-24, 25, (h, w)).astype(np.float32)
    tex_mask = ((xx // 64 + yy // 64) % 2).astype(np.float32)
    frames = []
    for t in range(n_frames):
        y = (90 + 60 * np.sin((xx - 2 * t) / 53.0) * np.cos(yy / 37.0)
             + tex * tex_mask)
        x0 = (30 + 3 * t) % (w - 40)
        y = y.copy()
        y[40:72, x0:x0 + 32] = 210
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 118, np.uint8)
        cr = np.clip(128 + tex[::2, ::2] / 4, 0, 255).astype(np.uint8)
        frames.append(Frame(y, cb, cr))
    return frames


def synth_1080p_structured(n_frames=2, seed=7):
    return synth_structured(n_frames, seed, 1920, 1080)


def synth_shear(n_frames, width, height, seed=5):
    """Content on which the P search takes rectangular PUs and older
    references (modelled on the JAX tests' `shear_clip`): a static
    textured picture whose upper band moves right and lower band left by
    3 samples a frame, the band edge at 32 rows into a CTU row, the left
    quarter also moving down by 2, and on the right quarter a texture
    that moves with the picture and alternates between two patterns
    from frame to frame, so that there the picture two back matches
    better than the previous one."""
    rng = np.random.RandomState(seed)
    h, w = height, width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 100 + 50 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
    tex = rng.randint(-15, 16, (h, w)).astype(np.float32)
    flicker = rng.randint(-20, 21, (2, h, w - 3 * w // 4)
                          ).astype(np.float32)
    edge = h // 2 // 64 * 64 + 32
    out = []
    for t in range(n_frames):
        y = base + tex
        y[:, 3 * w // 4:] += flicker[t % 2]
        y[:edge] = np.roll(y[:edge], 3 * t, axis=1)
        y[edge:] = np.roll(y[edge:], -3 * t, axis=1)
        y[:, :w // 4] = np.roll(y[:, :w // 4], 2 * t, axis=0)
        y = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 120, np.uint8)
        cr = np.full((h // 2, w // 2), 135, np.uint8)
        out.append(Frame(y, cb, cr))
    return out


def random_legal_decisions(pad_w, pad_h, seed):
    """Seeded random but legal decisions for a coded frame of pad_w x
    pad_h: (depth8, modes8, modes4, nxn8) host arrays with all four
    depths (raised where a CU would cross the frame edge), all 35 modes,
    and NxN 8x8 CUs with a mode per 4x4 PU. What the reconstruction is
    held to on content the search would never pick."""
    rng = np.random.RandomState(seed)
    h8, w8 = pad_h // 8, pad_w // 8
    H8, W8 = -(-h8 // 8) * 8, -(-w8 // 8) * 8
    d8 = np.zeros((H8, W8), np.int32)
    for i, (cy, cx) in enumerate(np.ndindex(H8 // 8, W8 // 8)):
        if i % 3 == 1:
            continue                      # one 64x64 CU (where it fits)
        for (qy, qx) in np.ndindex(2, 2):   # per 32x32: depth 1, or 2/3 mix
            y0, x0 = cy * 8 + qy * 4, cx * 8 + qx * 4
            if rng.rand() < 0.3:
                d8[y0:y0 + 4, x0:x0 + 4] = 1
            else:
                d8[y0:y0 + 4, x0:x0 + 4] = np.repeat(np.repeat(
                    rng.randint(2, 4, (2, 2)), 2, 0), 2, 1)
    # a CU must lie inside the frame: raise the depth until it does
    for y in range(h8):
        for x in range(w8):
            while True:
                s = 8 >> d8[y, x]
                if (x // s + 1) * s <= w8 and (y // s + 1) * s <= h8:
                    break
                d8[y, x] += 1
    d8 = d8[:h8, :w8]
    m8 = np.zeros((h8, w8), np.int32)
    for y in range(h8):
        for x in range(w8):
            s = 8 >> d8[y, x]
            if x % s == 0 and y % s == 0:
                m8[y:y + s, x:x + s] = rng.randint(0, 35)
    m4 = np.repeat(np.repeat(m8, 2, 0), 2, 1)
    nxn = (d8 == 3) & (rng.rand(h8, w8) < 0.35)
    for y, x in zip(*np.nonzero(nxn)):
        m4[2 * y:2 * y + 2, 2 * x:2 * x + 2] = rng.randint(0, 35, (2, 2))
    return d8, m4[::2, ::2].copy(), m4, nxn


def recon_work(depth8, nxn8, rdoq=True):
    """(bytes, integer operations) the reconstruction of frames with
    these decisions needs, for a roofline bound. depth8 / nxn8: host
    arrays [F, pad_h/8, pad_w/8].

    Bytes: per luma pixel 1.5 of original read, 1.5 of reconstruction and
    3 of int16 levels written (4:2:0), plus the decisions (depth8 and nxn8
    per 8x8, modes4 per 4x4). Operations per sample of a TU of size n:
    about 6 for the prediction taps, 4n multiply-adds for the two forward
    and two inverse transform stages, and about 55 for quantisation with
    three RDOQ candidate costs and dequantisation (12 without RDOQ). The
    TU sizes are those of these decisions: 32 under a 64 or 32 CU, else
    the CU size, 4 under an NxN CU; chroma half of that, at least 4."""
    depth8 = np.asarray(depth8)
    nxn8 = np.asarray(nxn8, bool)
    units = depth8.size
    nbytes = units * 64 * 6.0 + units * (4 + 1 + 4 * 4)
    n_luma = np.minimum(64 >> depth8, 32)
    n_luma = np.where(nxn8, 4, n_luma)
    n_chroma = np.maximum(np.minimum(64 >> depth8, 32) // 2, 4)
    per_sample = 6 + (55 if rdoq else 12)
    ops = float((64 * (per_sample + 4 * n_luma)).sum()
                + (32 * (per_sample + 4 * n_chroma)).sum())
    return nbytes, ops


def recon_tu_step_us(device, reps=10):
    """Microseconds per TU step of the reconstruction kernel on the card,
    by component ("luma", "chroma") and TU size ("32" ... "4").

    A 64x1024 frame is 16 CTUs that depend on each other (16 launches of
    one block); with one depth (and NxN flag) everywhere each CTU codes one
    TU size. The time of the kernel on one component (CUDA events, `reps`
    frame batches after a warm-up) over 16 x TUs per CTU: the launch and
    the CTU's set-up included."""
    import torch

    from . import recon_kernel

    w, h, ctus = 64, 1024, 16
    rng = np.random.RandomState(3)
    t = lambda a: torch.as_tensor(a).to(device)
    ys = t(rng.randint(0, 256, (1, h, w)).astype(np.uint8))
    cbs = t(rng.randint(0, 256, (1, h // 2, w // 2)).astype(np.uint8))
    crs = t(rng.randint(0, 256, (1, h // 2, w // 2)).astype(np.uint8))
    m4 = t(rng.randint(0, 35, (1, h // 4, w // 4)).astype(np.int32))
    out = {"luma": {}, "chroma": {}}
    # (depth, NxN) -> luma TU size, chroma TU size, TUs per CTU and plane
    for depth, nxn, n_y, n_c, tus_y, tus_c in (
            (1, False, 32, 16, 4, 4), (2, False, 16, 8, 16, 16),
            (3, False, 8, 4, 64, 64), (3, True, 4, None, 256, None)):
        d8 = torch.full((1, h // 8, w // 8), depth, dtype=torch.int32,
                        device=device)
        nx = torch.full((1, h // 8, w // 8), nxn, dtype=torch.bool,
                        device=device)
        for comp, n, tus in (("luma", n_y, tus_y), ("chroma", n_c, tus_c)):
            if n is None:
                continue
            run = lambda: recon_kernel.encode_frame_planes_cuda(
                ys, cbs, crs, d8, m4, nx, qp=32, pad_w=w, pad_h=h,
                components=(comp,))
            run()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                run()
            t1.record()
            torch.cuda.synchronize()
            out[comp][str(n)] = t0.elapsed_time(t1) / reps * 1e3 / (ctus * tus)
    return out


def read_hm_baseline():
    """The port's HM baseline cache (a dict). Never encodes; a missing
    file raises."""
    with open(HM_BASELINE_CACHE) as f:
        return json.load(f)


def hm_seconds_per_frame(key):
    """One entry of the cache; a missing key raises, naming the call that
    measures it."""
    base = read_hm_baseline()
    if key not in base:
        raise KeyError(f"{key} is not in {HM_BASELINE_CACHE}: time HM with "
                       "measure_hm_baseline(force=True) / "
                       "measure_hm_ldp_baseline(force=True) on this host")
    return base[key]


def _host_cpu():
    """The host CPU as /proc/cpuinfo names it (Linux), or None: the model
    name with the vendor, family and model numbers (a virtual machine may
    report the name as "unknown")."""
    if not os.path.exists("/proc/cpuinfo"):
        return None
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name')} ({info.get('vendor_id')} family "
            f"{info.get('cpu family')} model {info.get('model')}, "
            f"{os.cpu_count()} CPUs)")


def _time_hm(cfg_text, frames, timeout):
    """Seconds of one HM encode of `frames` with this cfg text."""
    from ..evaltools.hm import ENCODER
    with tempfile.TemporaryDirectory() as td:
        write_yuv420(os.path.join(td, "in.yuv"), frames)
        with open(os.path.join(td, "enc.cfg"), "w") as f:
            f.write(cfg_text)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [ENCODER, "-c", "enc.cfg", "-i", "in.yuv", "-b", "str.bin"],
            cwd=td, capture_output=True, text=True, timeout=timeout)
        dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"HM encoder failed:\n{proc.stderr}")
    return dt


def _measure(key, n_key, cfg_fn, n_frames, force, timeout, width, height):
    """Time HM once on the structured clip (QP 32) unless the cache
    already holds `key`; merge the result into the cache."""
    base = {}
    if os.path.exists(HM_BASELINE_CACHE):
        base = read_hm_baseline()
    if key in base and not force:
        return base
    frames = synth_structured(n_frames, 7, width, height)
    dt = _time_hm(cfg_fn(width, height, 32, n_frames), frames, timeout)
    base.update({key: dt / n_frames, n_key: n_frames,
                 "host_cpu": _host_cpu()})
    with open(HM_BASELINE_CACHE, "w") as f:
        json.dump(base, f, indent=1)
    return base


def measure_hm_baseline(n_frames=2, force=False, timeout=3600, width=1920,
                        height=1080):
    """HM All-Intra seconds per frame of the structured clip at QP 32
    (`train.labels.hm_intra_cfg`: SAO and deblocking on), on this host,
    cached under `hm_seconds_per_frame_{height}p_ai_qp32`."""
    from ..train.labels import hm_intra_cfg
    return _measure(f"hm_seconds_per_frame_{height}p_ai_qp32", "n_frames",
                    hm_intra_cfg, n_frames, force, timeout, width, height)


def measure_hm_ldp_baseline(n_frames=4, force=False, timeout=7200,
                            width=1920, height=1080):
    """HM Low-Delay-P seconds per frame of the structured clip at QP 32
    (`train.labels.hm_ldp_cfg`), on this host, cached under
    `hm_seconds_per_frame_{height}p_ldp_qp32`."""
    from ..train.labels import hm_ldp_cfg
    return _measure(f"hm_seconds_per_frame_{height}p_ldp_qp32",
                    "ldp_n_frames", hm_ldp_cfg, n_frames, force, timeout,
                    width, height)


def load_trained_lstm(qp=32):
    """The shipped ETH-LSTM checkpoint of `qp`'s band as the dict of NumPy
    arrays `LDPEncoder(lstm_params=)` takes (a missing file raises)."""
    from ..models.eth_cnn import band_for_qp
    with np.load(os.path.join(_MODELS,
                              f"eth_lstm_{band_for_qp(qp)}.npz")) as z:
        return {k: z[k] for k in z.files}


def bench_encode_ldp_1080p(n_frames=16, warm=3):
    """Low-Delay-P 1080p throughput on the card: the default
    `LDPEncoder(cfg)` (CU tree, rectangular PUs, four references) gated by
    the shipped ETH-LSTM at QP 32, on the structured clip, sequential per
    frame as the inter dependency demands, after a warm encode of `warm`
    frames. `vs_baseline` = frames/s x HM's cached LDP seconds per frame."""
    import torch

    from ..entropy import headers
    from ..ops import intra_mm
    from . import recon, recon_kernel
    from .pframe import LDPEncoder

    cfg = headers.EncoderConfig(width=1920, height=1080, qp=32, num_refs=4)
    hm_spf = hm_seconds_per_frame("hm_seconds_per_frame_1080p_ldp_qp32")
    enc = LDPEncoder(cfg, lstm_params=load_trained_lstm(cfg.qp))
    frames = synth_1080p_structured(n_frames)
    enc.encode(frames[:warm], with_hash_sei=False)
    torch.cuda.synchronize()

    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    t0 = time.perf_counter()
    stream, _ = enc.encode(frames, with_hash_sei=False)
    dt = time.perf_counter() - t0
    fps = n_frames / dt
    return {
        "metric": "ldp_encode_1080p",
        "value": fps,
        "unit": "frames/s/chip",
        "vs_baseline": fps * hm_spf,
        "gated": True,
        "stream_bytes": len(stream),
        "detail": {"n_frames": n_frames, "warm": warm, "wall_s": dt,
                   "hm_seconds_per_frame": hm_spf,
                   "satd35_launches": intra_mm.launches,
                   "recon_frame_launches": recon_kernel.launches,
                   "plain_recon_batches": recon.batches,
                   "device": torch.cuda.get_device_name(0)},
    }


def bench_encode_1080p(n_frames=48, chunk=24, decide_chunk=4):
    """Full-pipeline All-Intra 1080p benchmark on the card; returns the
    dictionary `bench_torch.py` prints.

    Uses the frame-batched pipeline (`parallel/frames.FrameParallelAI`)
    with the shipped ETH-CNN at QP 32 on structured synthetic content: the
    reconstruction runs over `chunk` frames at once (its chain of
    dependent launches costs about the same for 1 and for 24 frames),
    the decide stage in sub-batches of `decide_chunk` inside each chunk.
    One chunk is encoded first as a warm-up (kernel builds, host tables).
    `vs_baseline` = frames/s x HM's cached All-Intra seconds per frame
    (`HM_BASELINE_CACHE`; HM's cfg filters, this path does not)."""
    import torch

    from ..entropy import headers
    from ..models import eth_cnn
    from ..ops import intra_mm
    from ..parallel import frames as pframes
    from . import recon, recon_kernel

    cfg = headers.EncoderConfig(width=1920, height=1080, qp=32)
    hm_spf = hm_seconds_per_frame("hm_seconds_per_frame_1080p_ai_qp32")
    enc = pframes.FrameParallelAI(cfg, cnn=eth_cnn.load_npz(WEIGHTS_QP32),
                                  decide_chunk=decide_chunk)
    frames = synth_1080p_structured(n_frames)
    enc.encode(frames[:chunk], with_hash_sei=False)      # warm-up (1 chunk)
    torch.cuda.synchronize()

    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    t0 = time.perf_counter()
    stream, stats = enc.encode(frames, with_hash_sei=False, chunk=chunk)
    dt = time.perf_counter() - t0
    return {
        "metric": "ai_encode_1080p",
        "value": n_frames / dt,
        "unit": "frames/s/chip",
        "vs_baseline": n_frames / dt * hm_spf,
        "detail": {**stats, "n_frames": n_frames, "chunk": chunk,
                   "decide_chunk": decide_chunk, "wall_s": dt,
                   "satd35_launches": intra_mm.launches,
                   "recon_frame_launches": recon_kernel.launches,
                   "plain_recon_batches": recon.batches,
                   "weights": "trained", "content": "structured",
                   "device": torch.cuda.get_device_name(0)},
        "stream_bytes": len(stream),
    }
