#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card at the shapes the
encoder gives it (the 35-mode SATD kernel at its three 1080p batches, at
the benchmark's decide sub-batches and, luma and chroma, at a ragged
batch, with the registers, spills and shared memory of both kernels; the
reconstruction kernel on random legal decisions at 416x240 and on the
encoder's own decisions at 1080p), drives the main paths with the trained
ETH-CNN at QP 32 on 1080p frames — `AIEncoder.encode` frame by frame and
the frame-batched `FrameParallelAI.encode`, whose streams must be the same
bytes — runs the 1080p benchmark at a reduced depth, checks the stream
with the HM reference decoder, drives `AIEncoder.encode` with deblocking
and SAO on at 1080p (times of the filter stage per frame, its device
kernels, HM decode) and under a `RateController` at 416x240 (the card's
streams and QPs equal to the CPU's), drives the Low-Delay-P predictor
chain (`LDPPipeline.run`: motion search, MC, residue, ETH-LSTM) on eight
1080p frames (its P-frames timed stage by stage) and against the same
chain on the CPU, encodes the eight 1080p frames as a Low-Delay-P stream
through the flat-tree `LDPEncoder` (an IDR, then one 64x64 inter CU per
CTU; HM decode; the first three frames again with deblocking and SAO)
and holds its filtered 416x240 stream equal to the CPU's, encodes them
again through the ETH-LSTM-gated CU-tree `LDPEncoder(tree="full",
rect_pu=False)` (quadtree inter search with merge/skip and intra-in-P,
which runs the SATD kernel twice per P-frame; HM decode; its P-frames
timed by stage; the shares of CUs by size and mode; the first three
frames again with deblocking and SAO) and holds its 416x240 stream equal
to the CPU's, then drives the JAX encoder's default operating point,
`LDPEncoder(cfg)` with rectangular PUs and four references, on eight
1080p frames of a clip whose bands move in opposite directions (HM
decode; both rectangular shapes and references other than the newest
must be chosen; the first three frames again with deblocking and SAO)
and against the CPU at 416x240, and under a picture-level
`RateController` on the structured 1080p clip (HM decode) and against
the CPU at 416x240, then drives the command-line encoder
(`hevc_tpu_torch.apps.encoder.main`) on HM cfg files it writes: low-delay
B on the eight shear frames (GOP 4 of B pictures, four references,
filters on, ETH-LSTM; HM decodes the file with B slices and matching MD5)
and All-Intra on two structured frames (filters on, ETH-CNN), holds a
416x240 low-delay B stream made on the card equal to the CPU's, runs the
port's own decoder on the card over three 416x240 streams (equal to the
encoder's recons and to HM's output) and the 1080p B stream, drives the
TU-wavefront reconstruction backend at 1080p (`AIEncoder` and
`FrameParallelAI` with `recon_backend="tu"`: streams equal to the K2
streams at `nxn=False`, HM decode, the reconstruction timed and traced)
and the golden backend at 416x240 (stream equal to K2's), compares the
port's CU-depth labels of a 1080p frame with HM's, sweeps
`evaltools.bdrate.compare` over QP 22/27/32/37 on two 1080p frames
against HM (HM decodes the port's stream of each QP), runs the LDP
benchmark `bench_encode_ldp_1080p`, and prints the HM baseline cache both
benchmarks read their `vs_baseline` from, and prints one JSON object per
phase. The last line is
`{"ok": true, "device": {...}}`; any failed phase ends the run with a
non-zero exit code and no such line. Without a CUDA device it fails at
once.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "models", "eth_cnn_qp30~35.npz")
LSTM_WEIGHTS = os.path.join(ROOT, "models", "eth_lstm_qp30~35.npz")
HM_DECODER = os.path.join(ROOT, "tools", "hm", "TAppDecoderStatic")

# Published peaks of one H100 SXM: device memory 3.35 TB/s; 33.5e12
# integer lane-instructions/s = 132 SMs x 4 sub-partitions x 32 lanes x
# 1.98 GHz (one warp instruction per sub-partition and clock, the rate of
# 67 TFLOP/s float32 counted in instructions). Integer adds reach it only
# spread over two 16-lane pipes, the ALU (IADD3, LEA, IABS, SHF) and the
# float32 pipe's integer half (IMAD, IMAD.IADD), as nvcc spreads K1's
# (its SASS, read once by hand: PERF.md); either pipe alone gives half.
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 33.5e12

CTUS_X_1080P, CTUS_Y_1080P = 30, 17
N_CTU_1080P = CTUS_X_1080P * CTUS_Y_1080P
#: K2's launches per frame batch: one per wavefront diagonal
#: d = ctu_x + 2 * ctu_y, each covering Y, Cb and Cr
RECON_LAUNCHES_1080P = CTUS_X_1080P + 2 * (CTUS_Y_1080P - 1)
#: K1's three launches per 1080p frame: n -> batch of nodes (the
#: benchmark's decide sub-batches of 4 frames are 4 times these)
SHAPES_1080P = {16: N_CTU_1080P * 16, 8: N_CTU_1080P * 64,
                4: N_CTU_1080P * 256}


#: the script's start, for the `t_s` (seconds since the start) of each
#: phase line
T_START = time.perf_counter()


def say(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` launches (CUDA events,
    after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def satd_inputs(n, B, seed, device):
    """Substituted refs (unfiltered + filtered) and originals from a
    numpy seed, 8-bit range."""
    from hevc_tpu_torch.ops import intra
    rng = np.random.RandomState(seed)
    r_u = torch.as_tensor(rng.randint(0, 256, (B, 4 * n + 1)).astype(np.int32),
                          device=device)
    orig = torch.as_tensor(rng.randint(0, 256, (B, n, n)).astype(np.int32),
                           device=device)
    return r_u, intra.filter_refs(r_u).contiguous(), orig


def satd_ops_per_node(n):
    """Integer instructions one node needs over its 35 modes. Forming each
    predicted sample and its difference from the original: an angular
    sample with a fraction takes two tap multiply-adds and one fused shift
    and difference (3), one whose row (column) has fraction 0 the
    difference alone (1), DC the difference (1), planar a step of each of
    its two ramps, their sum and the fused shift and difference (4). Then
    per element one add or subtract for each of the log2(k*k) butterfly
    stages, the absolute value, and half an add to accumulate (an IADD3
    takes two absolute values)."""
    from hevc_tpu_torch.ops.intra import INTRA_ANGLES
    k = 4 if n == 4 else 8
    pred = n * n * (4 + 1) + sum(
        n * (3 if (j + 1) * INTRA_ANGLES[m] & 31 else 1)
        for m in range(2, 35) for j in range(n))
    return pred + 35 * n * n * (np.log2(k * k) + 1.5)


def satd_bound_ms(n, B):
    """Least time for one launch: the larger of bytes over the memory rate
    and integer instructions (`satd_ops_per_node`) over the issue rate.
    Also the bound as first stated, which counted 4 + 2 log2(k*k)
    instructions per sample (two per element and stage, the shift and the
    difference apart): (bound, bound_by, first bound)."""
    k = 4 if n == 4 else 8
    nbytes = B * (2 * (4 * n + 1) + n * n) * 4 + B * 35 * 4
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = B * satd_ops_per_node(n) / PEAK_INT_OPS_S * 1e3
    t_first = (B * 35 * n * n * (4 + 2 * np.log2(k * k))
               / PEAK_INT_OPS_S * 1e3)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, t_first))


def ptxas_usage(log):
    """{kernel function: registers, stack and spill bytes, shared memory}
    from the output of an `nvcc -Xptxas -v` build; K1's instances are
    named by their node size."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            m = re.search(r"satd35_kernelILi(\d+)EE", fn)
            fn = f"satd35 n={m.group(1)}" if m else fn
            continue
        if fn is None:
            continue
        r = usage.setdefault(fn, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            r.update(stack_bytes=int(m.group(1)),
                     spill_store_bytes=int(m.group(2)),
                     spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            r["shared_bytes"] = int(m.group(1))
    return usage


def check_kernel(device):
    """K1 against its plain version on the card, tolerance 0: luma at the
    three 1080p F = 1 batches and at the benchmark's decide sub-batches
    (x4), luma and chroma at a ragged batch of 70; timed at the F = 1 and
    x4 batches. Returns the per-n record and the largest difference."""
    from hevc_tpu_torch.ops import intra_mm
    per_n = {}
    max_err = 0
    for n, B in SHAPES_1080P.items():
        for b, comp, seed in ((B, "luma", 100 + n), (4 * B, "luma", 300 + n),
                              (70, "luma", 200 + n), (70, "chroma", 400 + n)):
            r_u, r_f, orig = satd_inputs(n, b, seed, device)
            got = intra_mm.satd_all_modes(r_u, r_f, orig, n, component=comp)
            torch.cuda.synchronize()
            want = intra_mm.satd_all_modes_plain(r_u, r_f, orig, n,
                                                 component=comp)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if got.shape != (b, 35) or got.dtype != torch.int32 or err != 0:
                fail(f"satd35 n={n} B={b} {comp}: differs from the plain "
                     f"version (max abs err {err})")
            del got, want
        rec = {}
        for key, b in (("F1", B), ("decide4", 4 * B)):
            r_u, r_f, orig = satd_inputs(n, b, 100 + n, device)
            ms = time_ms(lambda: intra_mm.satd_all_modes(r_u, r_f, orig, n),
                         20)
            bound, by, first = satd_bound_ms(n, b)
            rec[key] = {"B": b, "kernel_ms": ms, "bound_ms": bound,
                        "bound_by": by, "bound_ms_first_stated": first}
            if key == "F1":
                rec[key]["plain_ms"] = time_ms(
                    lambda: intra_mm.satd_all_modes_plain(r_u, r_f, orig, n),
                    3)
        per_n[str(n)] = {**rec["F1"], "decide4": rec["decide4"]}
        say({"phase": "satd35_vs_plain", "n": n,
             "equal_at": {"luma": [B, 4 * B, 70], "chroma": [70]},
             "equal": True, "tolerance": 0, **per_n[str(n)]})
    return per_n, max_err


def planes_equal(got, want):
    """Names of the planes of two FramePlanes that differ, and the
    largest absolute difference."""
    bad, err = [], 0
    for name, g, w in zip(want._fields, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            bad.append(name)
            continue
        d = int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
        err = max(err, d)
        if d:
            bad.append(name)
    return bad, err


def check_recon_small(device):
    """K2 against its plain version on seeded random legal decisions (all
    four depths, all 35 modes, NxN) at 416x240, three frames."""
    from hevc_tpu_torch.core.yuv import pad_frame
    from hevc_tpu_torch.pipeline import bench_hooks, recon, recon_kernel
    w, h, F = 416, 240, 3
    max_err = 0
    for qp in (22, 37):
        frames = [pad_frame(f, w, h)
                  for f in bench_hooks.synth_structured(F, qp, w, h)]
        dec = [bench_hooks.random_legal_decisions(w, h, 10 * qp + f)
               for f in range(F)]
        stack = lambda xs: torch.as_tensor(np.stack(xs)).to(device)
        args = (stack([f.y for f in frames]), stack([f.cb for f in frames]),
                stack([f.cr for f in frames]),
                stack([d[0] for d in dec]).to(torch.int32),
                stack([d[2] for d in dec]).to(torch.int32),
                stack([d[3] for d in dec]))
        for rdoq in (True, False):
            kw = dict(qp=qp, pad_w=w, pad_h=h, rdoq=rdoq)
            recon_kernel.launches = 0
            got = recon.encode_frame_planes_batched(*args, **kw)
            torch.cuda.synchronize()
            launches = recon_kernel.launches
            want = recon.encode_frame_planes_plain_batched(*args, **kw,
                                                           device=device)
            bad, err = planes_equal(got, want)
            max_err = max(max_err, err)
            if bad or launches != 7 + 2 * 3:
                fail(f"recon_frame 416x240 qp={qp} rdoq={rdoq}: planes {bad} "
                     f"differ from the plain version (max abs err {err}), "
                     f"{launches} launches")
            say({"phase": "recon_vs_plain", "size": "416x240", "frames": F,
                 "decisions": "random legal", "qp": qp, "rdoq": rdoq,
                 "planes_equal": 6, "tolerance": 0, "launches": launches,
                 "nonzero_levels": int(want.coef_y.ne(0).sum())})
    return max_err


def recon_kernel_times(args, kw, reps=5):
    """Milliseconds of K2 for one frame batch: the luma plane alone, the
    chroma planes alone, and all three as the encoder launches them."""
    from hevc_tpu_torch.pipeline import recon_kernel
    out = {}
    for key, comps in (("luma_ms", ("luma",)), ("chroma_ms", ("chroma",)),
                       ("ms", ("luma", "chroma"))):
        out[key] = time_ms(lambda: recon_kernel.encode_frame_planes_cuda(
            *args, **kw, components=comps), reps)
    return out


def encode(frames, cnn, w, h, device=None, rate_control=None, **cfg_kw):
    """AIEncoder.encode at QP 32 (cfg_kw: deblock, sao). Returns (stream,
    recons, stats, wall s); the encoder's per-picture QPs go into stats
    as `frame_qps`."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    enc = AIEncoder(EncoderConfig(w, h, qp=32, **cfg_kw), cnn=cnn,
                    device=device)
    t0 = time.perf_counter()
    stream, recons, stats = enc.encode(frames, with_hash_sei=True,
                                       rate_control=rate_control)
    torch.cuda.synchronize()
    return (stream, recons, {**stats, "frame_qps": enc.frame_qps},
            time.perf_counter() - t0)


def hm_decode_file(bs, rec, of):
    """HM on a bitstream file: rc 0 and no MD5 mismatch, or the smoke
    fails. Returns the decoder's log."""
    try:
        proc = subprocess.run([HM_DECODER, "-b", bs, "-o", rec],
                              capture_output=True, text=True, timeout=600)
    except OSError as e:
        fail(f"the HM decoder cannot be executed: {e}")
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or "mismatch" in log.lower():
        fail(f"{of}: HM decode rc={proc.returncode}:\n{log[-2000:]}")
    return log


def hm_check(stream, recons, w, h, of):
    """Decode with the HM reference decoder: rc 0, MD5 SEI matches,
    decoded YUV equals the encoder's reconstructions. A decoder that
    cannot run fails the smoke like a mismatch. `of` names the stream."""
    from hevc_tpu_torch.core.yuv import read_yuv420
    with tempfile.TemporaryDirectory() as tmp:
        bs, rec = os.path.join(tmp, "str.bin"), os.path.join(tmp, "rec.yuv")
        with open(bs, "wb") as f:
            f.write(stream)
        hm_decode_file(bs, rec, of)
        dec = read_yuv420(rec, w, h)
        if len(dec) != len(recons):
            fail(f"HM decoded {len(dec)} frames, encoder made {len(recons)}")
        for d, r in zip(dec, recons):
            for a, b in ((d.y, r.y), (d.cb, r.cb), (d.cr, r.cr)):
                if not np.array_equal(a, b):
                    fail("HM-decoded picture differs from the encoder's recon")
    say({"phase": "hm_decode", "of": of, "size": f"{w}x{h}", "rc": 0,
         "md5_sei": "match", "frames": len(recons),
         "decoded_equals_recon": True})


def filter_stage(planes, depth8, origs, qp, times):
    """The encoder's filter stage (`AIEncoder.reconstruct` after K2) on
    the device planes of one frame: deblocking, SAO statistics (ending in
    their one copy to the host), the host decision and the apply, each
    between two synchronises; their milliseconds go into `times`.
    Returns the filtered planes and the SAO parameters."""
    from hevc_tpu_torch.ops import deblock, sao
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    y, cb, cr = deblock.deblock_frame(*planes, depth8, qp)
    mark()
    stats = sao.frame_stats(*origs, y, cb, cr)
    mark()
    params = sao.decide_frame(stats, qp)
    mark()
    out = sao.apply_frame(y, cb, cr, params)
    mark()
    for i, key in enumerate(("deblock_ms", "sao_stats_ms", "sao_decide_ms",
                             "sao_apply_ms")):
        times[key] = (marks[i + 1] - marks[i]) * 1e3
    times["total_ms"] = (marks[-1] - marks[0]) * 1e3
    return out, params


def device_counts(prof):
    """(kernels, copies and fills, device-busy ms of both) in a finished
    `torch.profiler` trace."""
    from torch.autograd import DeviceType
    kernels = copies = busy_us = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
        dev_us = getattr(e, "self_device_time_total", None)
        busy_us += e.self_cuda_time_total if dev_us is None else dev_us
    return kernels, copies, busy_us / 1e3


def device_kernels(fn, host=True):
    """(kernels, copies and fills, device-busy ms of both) the device ran
    for fn(), from a `torch.profiler` trace; host=False traces the
    device's activity alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as p:
        fn()
        torch.cuda.synchronize()
    return device_counts(p)


def device_kernels_by_stage(fn):
    """fn(stage_done) runs stages, each ending in stage_done(name).
    Returns {name: (kernels, copies and fills, device-busy ms)} of each
    stage, one `torch.profiler` trace per stage."""
    from torch.profiler import ProfilerActivity, profile
    out, traces = {}, []

    def begin():
        torch.cuda.synchronize()
        traces.append(profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]))
        traces[-1].start()

    def stage_done(name):
        torch.cuda.synchronize()
        traces[-1].stop()
        out[name] = device_counts(traces[-1])
        begin()

    begin()
    fn(stage_done)
    traces[-1].stop()
    return out


def check_filters_1080p(frames, cnn, device, reps=5):
    """Deblocking and SAO on at 1080p through `AIEncoder.encode` (both
    kernels counted, HM decode), the same frames unfiltered beside it,
    and the filter stage of each frame timed part by part after a
    warm-up (the median of `reps` runs per part: the host's clock moves
    between runs). Returns the kernels' launches on this path."""
    from hevc_tpu_torch.core.yuv import pad_frame, psnr
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.pipeline import recon, recon_kernel
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    cfg = EncoderConfig(1920, 1080, qp=32, deblock=True, sao=True)
    s_unf, r_unf, _, _ = encode(frames, cnn, 1920, 1080)
    torch.cuda.synchronize()
    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    s_f, r_f, st_f, wall = encode(frames, cnn, 1920, 1080, deblock=True,
                                  sao=True)
    launches = {"satd35": intra_mm.launches,
                "recon_frame": recon_kernel.launches}
    plain_batches = recon.batches
    if (launches["satd35"] != 3 * len(frames)
            or launches["recon_frame"] != RECON_LAUNCHES_1080P * len(frames)
            or plain_batches != 0):
        fail(f"filters_1080p: launches {launches}, plain recon batches "
             f"{plain_batches}")
    hm_check(s_f, r_f, 1920, 1080, "filters_1080p")

    enc = AIEncoder(cfg, cnn=cnn)
    per_frame, types = [], np.zeros((2, 3), np.int64)
    for i, f in enumerate(frames):
        pf = pad_frame(f, cfg.pad_width, cfg.pad_height)
        d8, _, m4, nxn = enc.decide_frame_full(pf.y, None, pf.cb, pf.cr)
        planes = recon.encode_frame_planes_batched(
            *(np.asarray(a)[None] for a in (pf.y, pf.cb, pf.cr, d8, m4, nxn)),
            qp=32, pad_w=cfg.pad_width, pad_h=cfg.pad_height, rdoq=True)
        stage_args = ([p[0] for p in planes[:3]],
                      torch.as_tensor(d8, device=device),
                      [torch.as_tensor(a, device=device)
                       for a in (pf.y, pf.cb, pf.cr)], 32)
        if i == 0:
            filter_stage(*stage_args, {})                  # warm-up
        runs = [{} for _ in range(reps)]
        for times in runs:
            out, params = filter_stage(*stage_args, times)
        per_frame.append({k: float(np.median([t[k] for t in runs]))
                          for k in runs[0]})
        got = [p.to(torch.uint8).cpu().numpy() for p in out]
        want = (r_f[i].y, r_f[i].cb, r_f[i].cr)
        if not all(np.array_equal(g[:x.shape[0], :x.shape[1]], x)
                   for g, x in zip(got, want)):
            fail("filters_1080p: the timed filter stage gives another picture "
                 "than AIEncoder.encode returned")
        for c in (0, 1):                               # luma, chroma
            types[c] += np.bincount(params.type_idx[c], minlength=3)
    kernels, copies, busy_ms = device_kernels(
        lambda: filter_stage(*stage_args, {}))
    if kernels == 0:
        fail("filters_1080p: the profiler saw no device kernel in the "
             "filter stage")
    mean = {k: float(np.mean([t[k] for t in per_frame]))
            for k in per_frame[0]}
    psnr_of = lambda rs: float(np.mean([psnr(r.y, f.y)
                                        for r, f in zip(rs, frames)]))
    share = lambda c: dict(zip(("none", "band", "edge"),
                               (types[c] / types[c].sum()).tolist()))
    say({"phase": "filters_1080p", "frames": len(frames), "qp": 32,
         "deblock": True, "sao": True, "bytes": len(s_f),
         "psnr_y": psnr_of(r_f), "unfiltered_bytes": len(s_unf),
         "unfiltered_psnr_y": psnr_of(r_unf), "wall_s": wall,
         "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"],
         "plain_recon_batches": plain_batches, **st_f,
         "filter_stage_runs_per_frame": reps,
         "filter_stage_ms_per_frame": per_frame,
         "filter_stage_ms_mean": mean,
         "filter_stage_device_kernels": kernels,
         "filter_stage_device_busy_ms": busy_ms,
         "filter_stage_copies_and_fills": copies,
         "sao_ctu_type_share": {"luma": share(0), "chroma": share(1)}})
    return launches


def check_filters_small(small, cnn, cnn_cpu):
    """Deblocking and SAO on at 416x240: the card's stream equals the one
    made on the CPU (a different SAO decision would show here)."""
    s_card, _, _, _ = encode(small, cnn, 416, 240, deblock=True, sao=True)
    s_cpu, _, _, _ = encode(small, cnn_cpu, 416, 240, device="cpu",
                            deblock=True, sao=True)
    if s_card != s_cpu:
        fail("filters_card_vs_cpu_stream: the card's filtered stream differs "
             "from the CPU's")
    say({"phase": "filters_card_vs_cpu_stream", "size": "416x240",
         "frames": len(small), "deblock": True, "sao": True,
         "bytes": len(s_card), "identical": True})


def check_rate_control(cnn, cnn_cpu):
    """Four 416x240 frames (deblocking and SAO on) under a RateController
    whose target moves the QP: the card's stream and per-picture QPs equal
    the CPU's, and HM decodes the stream. Returns the kernels' launches
    on this path."""
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.pipeline import bench_hooks, ratectrl, recon
    from hevc_tpu_torch.pipeline import recon_kernel
    frames = bench_hooks.synth_structured(4, 7, 416, 240)
    rc_kw = dict(target_bps=1_000_000, fps=30, width=416, height=240,
                 n_frames=len(frames), init_qp=32)
    torch.cuda.synchronize()
    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    s_card, r_card, st, wall = encode(
        frames, cnn, 416, 240, rate_control=ratectrl.RateController(**rc_kw),
        deblock=True, sao=True)
    launches = {"satd35": intra_mm.launches,
                "recon_frame": recon_kernel.launches}
    if (launches["satd35"] != 3 * len(frames)
            or launches["recon_frame"] != 13 * len(frames)
            or recon.batches != 0):
        fail(f"rate_control: launches {launches}, plain recon batches "
             f"{recon.batches}")
    s_cpu, _, st_cpu, _ = encode(
        frames, cnn_cpu, 416, 240, device="cpu",
        rate_control=ratectrl.RateController(**rc_kw), deblock=True,
        sao=True)
    qps = st["frame_qps"]
    if len(set(qps)) < 2:
        fail(f"rate_control: the QP did not move ({qps})")
    if qps != st_cpu["frame_qps"] or s_card != s_cpu:
        fail(f"rate_control: card QPs {qps} / CPU QPs {st_cpu['frame_qps']}, "
             f"streams equal: {s_card == s_cpu}")
    hm_check(s_card, r_card, 416, 240, "rate_control")
    say({"phase": "rate_control", "size": "416x240", "frames": len(frames),
         "target_bps": rc_kw["target_bps"], "fps": rc_kw["fps"],
         "frame_qps": qps, "qps_equal_to_cpu": True,
         "stream_identical_to_cpu": True, "bytes": len(s_card),
         "wall_s": wall, "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"]})
    return launches


def ldp_lstm_params():
    with np.load(LSTM_WEIGHTS) as z:
        return {k: z[k] for k in z.files}


def ldp_p_frame(pipe, cur, prev, poc, times):
    """One P-frame of `LDPPipeline.run` (`LDPPipeline.p_frame`) on device
    planes, a synchronise where each of its stages ends; their
    milliseconds go into `times`. Returns what `p_frame` returns."""
    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def stage_done(name):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        times[f"{name}_ms"] = (marks[-1] - marks[-2]) * 1e3

    out = pipe.p_frame(cur, prev, poc, stage_done=stage_done)
    times["total_ms"] = (marks[-1] - marks[0]) * 1e3
    return out


def gate_class_shares(hcpms):
    """Share of HCPM nodes per split-gate class at each level, over the
    P-frames' [B, 21] HCPMs (DEFAULT_LDP thresholds)."""
    from hevc_tpu_torch.models import hcpm as hcpm_lib
    cur, split = hcpm_lib.split_gates(torch.as_tensor(np.stack(hcpms)),
                                      hcpm_lib.DEFAULT_LDP)
    out = {}
    for lvl, sl in (("64", slice(0, 1)), ("32", slice(1, 5)),
                    ("16", slice(5, 21))):
        c, s = cur[..., sl].reshape(-1), split[..., sl].reshape(-1)
        n = c.numel()
        out[lvl] = {"split_only": float((~c & s).sum()) / n,
                    "current_only": float((c & ~s).sum()) / n,
                    "both": float((c & s).sum()) / n}
    return out


def check_ldp_1080p(reps=3):
    """The Low-Delay-P predictor chain at 1080p: `LDPPipeline.run` over
    eight frames on the card with the shipped ETH-LSTM (shapes, ranges,
    MVs, state moving), then each P-frame through `LDPPipeline.p_frame`
    again with its stages timed (integer search, quarter-pel sweep, MC
    and residue, LSTM step; the median of `reps` runs per warm stage)
    and held equal to what `run` returned, and one P-frame's device
    kernels per stage. Returns the frames and the record of POC 1 for
    the card-vs-CPU check."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline import bench_hooks, ldp
    # pad_align=64: whole CTUs, as the LDP encoder codes them
    cfg = EncoderConfig(1920, 1080, qp=32, pad_align=64)
    params = ldp_lstm_params()
    frames = bench_hooks.synth_1080p_structured(n_frames=8)
    pipe = ldp.LDPPipeline(cfg, lstm_params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_ctu = cfg.ctus_x * cfg.ctus_y
    bound = 4 * 8 + 3
    for rec in out[1:]:
        h = rec["hcpm"]
        if (h.shape != (n_ctu, 21) or not np.isfinite(h).all()
                or h.min() < 0 or h.max() > 1):
            fail(f"ldp_predictor_1080p: POC {rec['poc']} HCPM shape "
                 f"{h.shape}, range [{h.min()}, {h.max()}]")
        if (rec["resi_y"].shape != (cfg.pad_height, cfg.pad_width)
                or rec["resi_cb"].shape != (cfg.pad_height // 2,
                                            cfg.pad_width // 2)
                or rec["resi_cr"].shape != rec["resi_cb"].shape):
            fail("ldp_predictor_1080p: residue planes of the wrong shape")
        if np.abs(rec["mv_q"]).max() > bound:
            fail(f"ldp_predictor_1080p: |mv_q| above {bound}")
    if any(np.array_equal(a["hcpm"], b["hcpm"])
           for a, b in zip(out[1:], out[2:])):
        fail("ldp_predictor_1080p: the HCPM did not move from step to step")
    # the same run warm, from a reset predictor: the same records
    pipe.predictor.reset()
    t0 = time.perf_counter()
    again = pipe.run(frames)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    if not all(np.array_equal(a[k], b[k]) for a, b in zip(out[1:], again[1:])
               for k in ("resi_y", "mv_q")) or not all(
            np.allclose(a["hcpm"], b["hcpm"], atol=1e-6, rtol=0)
            for a, b in zip(out[1:], again[1:])):
        fail("ldp_predictor_1080p: a second run after reset() differs")

    # the same P-frames stage by stage, from a reset predictor
    pipe.predictor.reset()
    planes = [pipe._to_device(f) for f in frames]
    w, h = cfg.pad_width, cfg.pad_height
    dims = {"resi_y": (w, h, 64), "resi_cb": (w // 2, h // 2, 32),
            "resi_cr": (w // 2, h // 2, 32)}
    per_frame = []
    for poc in range(1, len(frames)):
        runs = [{} for _ in range(reps if poc > 1 else 1)]
        state = pipe.predictor.state
        for times in runs:
            pipe.predictor.state = state
            got = ldp_p_frame(pipe, planes[poc], planes[poc - 1], poc, times)
        want = out[poc]
        for k, g in zip(dims, got[:3]):
            if not np.array_equal(ldp.tiles_to_plane(g, *dims[k]), want[k]):
                fail(f"ldp_predictor_1080p: the staged {k} of POC {poc} "
                     "differs from LDPPipeline.run's")
        if (not np.array_equal(got[3].cpu().numpy(), want["mv_q"])
                or not np.allclose(got[4].cpu().numpy(), want["hcpm"],
                                   atol=1e-6, rtol=0)):
            fail(f"ldp_predictor_1080p: the staged MVs or HCPM of POC {poc} "
                 "differ from LDPPipeline.run's")
        if poc > 1:                                   # warm frames
            per_frame.append({k: float(np.median([t[k] for t in runs]))
                              for k in runs[0]})
    stages = device_kernels_by_stage(
        lambda stage_done: pipe.p_frame(planes[7], planes[6], 7,
                                        stage_done=stage_done))
    kernels, copies, busy_ms = (sum(v[i] for v in stages.values())
                                for i in range(3))
    if kernels == 0:
        fail("ldp_predictor_1080p: the profiler saw no device kernel")
    mvs = np.stack([r["mv_q"] for r in out[1:]])
    say({"phase": "ldp_predictor_1080p", "frames": len(frames),
         "p_frames": len(frames) - 1, "size": "1920x1080",
         "padded": f"{cfg.pad_width}x{cfg.pad_height}", "qp": cfg.qp,
         "ctus": n_ctu, "lstm": os.path.basename(LSTM_WEIGHTS),
         "run_wall_s": wall, "warm_run_wall_s": warm_wall,
         "warm_run_s_per_p_frame": warm_wall / (len(frames) - 1),
         "peak_device_bytes": peak,
         "stage_runs_per_frame": reps,
         "p_frame_ms_warm": per_frame,
         "p_frame_ms_mean": {k: float(np.mean([t[k] for t in per_frame]))
                             for k in per_frame[0]},
         "p_frame_device_kernels": kernels,
         "p_frame_copies_and_fills": copies,
         "p_frame_device_busy_ms": busy_ms,
         "p_frame_by_stage": {k: {"device_kernels": v[0],
                                  "copies_and_fills": v[1],
                                  "device_busy_ms": v[2]}
                              for k, v in stages.items()},
         "zero_mv_share": float((mvs == 0).all(-1).mean()),
         "max_abs_mv_q": int(np.abs(mvs).max()),
         "gate_class_share": gate_class_shares([r["hcpm"]
                                                for r in out[1:]]),
         "staged_equal_to_run": True})
    return frames, out[1]


def check_ldp_card_vs_cpu(frames_1080p, first_p_1080p):
    """The card's LDP chain against the same chain on the CPU: six
    416x240 frames, frames 2 and 3 with a flat 96x96 region around the
    CTU at (128, 64), so every search candidate of that CTU ties in
    P-frame 3; and the first P-frame at 1080p. Residue planes and MVs
    equal, HCPM within atol 1e-5, split gates equal."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.models import hcpm as hcpm_lib
    from hevc_tpu_torch.pipeline import bench_hooks, ldp
    params = ldp_lstm_params()
    small = bench_hooks.synth_structured(6, 11, 416, 240)
    for f in small[2:4]:
        f.y[48:144, 112:208] = 100
    max_err = 0.0
    cases = []
    for size, frames, card in (
            ((416, 240), small, None),
            ((1920, 1080), frames_1080p[:2], [{"poc": 0}, first_p_1080p])):
        cfg = EncoderConfig(*size, qp=32, pad_align=64)
        if card is None:
            card = ldp.LDPPipeline(cfg, lstm_params=params).run(frames)
        cpu = ldp.LDPPipeline(cfg, lstm_params=params,
                              device="cpu").run(frames)
        for a, b in zip(card[1:], cpu[1:]):
            for k in ("resi_y", "resi_cb", "resi_cr", "mv_q"):
                if not np.array_equal(a[k], b[k]):
                    fail(f"ldp_card_vs_cpu {size}: {k} of POC {a['poc']} "
                         "differs from the CPU's")
            max_err = max(max_err, float(np.abs(a["hcpm"] - b["hcpm"]).max()))
            gates = [hcpm_lib.split_gates(torch.as_tensor(r["hcpm"]),
                                          hcpm_lib.DEFAULT_LDP)
                     for r in (a, b)]
            if max_err > 1e-5 or not all(torch.equal(x, y)
                                         for x, y in zip(*gates)):
                fail(f"ldp_card_vs_cpu {size}: HCPM of POC {a['poc']} off "
                     f"by {max_err} or its split gates differ")
        cases.append({"size": f"{size[0]}x{size[1]}",
                      "p_frames": len(frames) - 1})
        if size == (416, 240):
            tie = tuple(card[3]["mv_q"][1 * cfg.ctus_x + 2])
            if tie != (-35, -35):
                fail(f"ldp_card_vs_cpu: the flat CTU's MV is {tie}, not the "
                     "first of the tied candidates (-35, -35)")
    say({"phase": "ldp_card_vs_cpu", "cases": cases,
         "residues_and_mvs_equal": True, "hcpm_max_abs_err": max_err,
         "hcpm_tolerance": 1e-5, "split_gates_equal": True,
         "flat_ctu_mv_q": [-35, -35]})


def ldp_encoder(w, h, cnn, device=None, **cfg_kw):
    """The flat-tree, P-only `LDPEncoder` at QP 32 (cfg_kw: deblock, sao)."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.pframe import LDPEncoder
    return LDPEncoder(EncoderConfig(w, h, qp=32, **cfg_kw), cnn=cnn,
                      tree="flat", device=device)


def kernel_launches():
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.pipeline import recon_kernel
    return {"satd35": intra_mm.launches,
            "recon_frame": recon_kernel.launches}


def reset_launches():
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.pipeline import recon, recon_kernel
    intra_mm.launches = recon_kernel.launches = recon.batches = 0


def check_ldp_launches(launches, of):
    """The flat LDP path runs both kernels through its IDR only: 3 SATD
    launches (one per node size) and 62 reconstruction launches."""
    from hevc_tpu_torch.pipeline import recon
    if launches != {"satd35": 3, "recon_frame": RECON_LAUNCHES_1080P}:
        fail(f"{of}: kernel launches {launches}, expected 3 satd35 and "
             f"{RECON_LAUNCHES_1080P} recon_frame (the IDR)")
    if recon.batches != 0:
        fail(f"{of}: the IDR went through the plain reconstruction")


def ldp_psnr_check(frames, recons, of):
    """PSNR-Y of each frame, above the 28 dB the AI path is held to."""
    from hevc_tpu_torch.core.yuv import psnr
    out = [float(psnr(r.y, f.y)) for f, r in zip(frames, recons)]
    for r in recons:
        if r.y.shape != frames[0].y.shape or r.cb.shape != frames[0].cb.shape:
            fail(f"{of}: a recon has the wrong shape")
    if not all(np.isfinite(p) and p > 28.0 for p in out):
        fail(f"{of}: PSNR-Y per frame {out} is not sane")
    return out


def flat_p_frame_stages(enc, pf, prev, qp, reps=3):
    """`encode_p_frame_device` of one P-frame with a synchronise where
    each of its stages ends (search, quarter sweep, MC, transform):
    the median milliseconds of each over `reps` runs, and each stage's
    device kernels, copies and busy time from one trace per stage."""
    from hevc_tpu_torch.pipeline.pframe import encode_p_frame_device
    cur = enc._upload(pf)
    kw = dict(qp=qp, pad_w=enc.cfg.pad_width, pad_h=enc.cfg.pad_height)
    runs = []
    for _ in range(reps):
        times = {}
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def stage_done(name):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            times[f"{name}_ms"] = (marks[-1] - marks[-2]) * 1e3

        encode_p_frame_device(*cur, *prev, **kw, stage_done=stage_done)
        runs.append(times)
    traced = device_kernels_by_stage(
        lambda stage_done: encode_p_frame_device(*cur, *prev, **kw,
                                                 stage_done=stage_done))
    return ({k: float(np.median([t[k] for t in runs])) for k in runs[0]},
            {k: {"device_kernels": v[0], "copies_and_fills": v[1],
                 "device_busy_ms": v[2]} for k, v in traced.items()})


def check_ldp_flat_1080p(frames, cnn):
    """The port's first Low-Delay-P stream: eight 1080p frames through
    `LDPEncoder(tree="flat").encode` (an IDR, then one 64x64 inter CU per
    CTU; GOP QP offsets; filters off), HM decode, both kernels counted
    (the IDR's), each P-frame's `_encode_flat` timed, one warm P-frame's
    device kernels, copies and peak memory, its device part stage by
    stage, the whole run's peak memory.
    Returns the kernels' launches on this path."""
    enc = ldp_encoder(1920, 1080, cnn)
    p_frames, last, encode_flat = [], [], enc._encode_flat

    def timed(pf, prev, poc, qp, times):
        t0 = time.perf_counter()
        out = encode_flat(pf, prev, poc, qp, times)
        p_frames.append({"poc": poc, "wall_ms": (time.perf_counter() - t0)
                         * 1e3, **{k[:-2] + "_ms": v * 1e3
                                   for k, v in times.items()}})
        last[:] = [pf, prev, poc, qp]
        return out

    enc._encode_flat = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    stats = enc.last_stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    check_ldp_launches(launches, "ldp_flat_1080p")
    psnrs = ldp_psnr_check(frames, recons, "ldp_flat_1080p")
    if enc.frame_qps != [32, 35, 34, 35, 33, 35, 34, 35]:
        fail(f"ldp_flat_1080p: frame QPs {enc.frame_qps}")
    hm_check(stream, recons, 1920, 1080, "ldp_flat_1080p")
    # one warm P-frame again: its peak device memory above what stays
    # resident (the encoder's CNN, the reference picture), then its trace
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encode_flat(*last)
    p_peak = torch.cuda.max_memory_allocated() - resident
    kernels, copies, busy_ms = device_kernels(lambda: encode_flat(*last))
    if kernels == 0:
        fail("ldp_flat_1080p: the profiler saw no device kernel")
    stage_ms, by_stage = flat_p_frame_stages(enc, last[0], last[1], last[3])
    warm = p_frames[1:]
    say({"phase": "ldp_flat_1080p", "frames": len(frames),
         "size": "1920x1080",
         "padded": f"{enc.cfg.pad_width}x{enc.cfg.pad_height}",
         "tree": "flat", "cnn": os.path.basename(WEIGHTS),
         "frame_qps": enc.frame_qps, "bytes": len(stream),
         "psnr_y": psnrs, "wall_s": wall, **stats,
         "p_frame_ms": p_frames,
         "warm_p_frame_median_ms": {
             k: float(np.median([t[k] for t in warm]))
             for k in ("wall_ms", "decide_ms", "recon_ms", "entropy_ms")},
         "p_frame_device_kernels": kernels,
         "p_frame_copies_and_fills": copies,
         "p_frame_device_busy_ms": busy_ms,
         "p_frame_device_stage_ms": stage_ms,
         "p_frame_device_by_stage": by_stage,
         "peak_device_bytes": peak,
         "p_frame_peak_device_bytes_above_resident": p_peak,
         "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"]})
    return launches


def check_ldp_flat_filters_1080p(frames, cnn):
    """The first three 1080p frames through the flat `LDPEncoder` with
    deblocking and SAO on: HM decode, the IDR's kernel launches."""
    enc = ldp_encoder(1920, 1080, cnn, deblock=True, sao=True)
    reset_launches()
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    stats = enc.last_stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    check_ldp_launches(launches, "ldp_flat_filters_1080p")
    psnrs = ldp_psnr_check(frames, recons, "ldp_flat_filters_1080p")
    hm_check(stream, recons, 1920, 1080, "ldp_flat_filters_1080p")
    say({"phase": "ldp_flat_filters_1080p", "frames": len(frames),
         "deblock": True, "sao": True, "frame_qps": enc.frame_qps,
         "bytes": len(stream), "psnr_y": psnrs, "wall_s": wall, **stats,
         "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"]})
    return launches


def check_ldp_flat_card_vs_cpu(cnn, cnn_cpu):
    """The card's flat LDP stream against the CPU's: four 416x240 frames
    (448x256 coded), filters on, a flat 96x96 region in frames 1 and 2
    whose CTU ties every search candidate in P-frame 2."""
    from hevc_tpu_torch.pipeline import bench_hooks
    frames = bench_hooks.synth_structured(4, 13, 416, 240)
    for f in frames[1:3]:
        f.y[48:144, 112:208] = 100
    out = {}
    for dev, net in (("cuda", cnn), ("cpu", cnn_cpu)):
        enc = ldp_encoder(416, 240, net, device=dev, deblock=True, sao=True)
        out[dev] = enc.encode(frames)[:2] + (enc.frame_qps,)
    if out["cuda"][0] != out["cpu"][0] or out["cuda"][2] != out["cpu"][2]:
        fail("ldp_flat_card_vs_cpu: the card's stream differs from the CPU's")
    say({"phase": "ldp_flat_card_vs_cpu", "size": "416x240",
         "padded": "448x256", "frames": len(frames), "deblock": True,
         "sao": True, "frame_qps": out["cuda"][2],
         "bytes": len(out["cuda"][0]), "identical": True})


def full_encoder(w, h, cnn, device=None, **cfg_kw):
    """`LDPEncoder(tree="full", rect_pu=False)` at QP 32 gated by the
    shipped ETH-LSTM (cfg_kw: deblock, sao)."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.pframe import LDPEncoder
    return LDPEncoder(EncoderConfig(w, h, qp=32, **cfg_kw), cnn=cnn,
                      lstm_params=ldp_lstm_params(), tree="full",
                      rect_pu=False, device=device)


def check_full_launches(launches, p_frames, of):
    """The full-tree LDP path: the IDR's 3 SATD and 62 reconstruction
    launches, then 2 SATD launches per P-frame (intra-in-P's 16x16 and
    8x8 nodes), none through the plain reconstruction."""
    from hevc_tpu_torch.pipeline import recon
    want = {"satd35": 3 + 2 * p_frames, "recon_frame": RECON_LAUNCHES_1080P}
    if launches != want:
        fail(f"{of}: kernel launches {launches}, expected {want}")
    if recon.batches != 0:
        fail(f"{of}: the IDR went through the plain reconstruction")


def record_searches(enc):
    """Wrap enc.finish_p_frame: keep each P-frame's depth, CU mode, PU
    partition and reference index maps (device tensors). Returns the list
    they go in."""
    seen, finish = [], enc.finish_p_frame

    def wrapped(pf, cur, res, *a, **k):
        seen.append((res.depth8, res.mode8, res.part8, res.ref8))
        return finish(pf, cur, res, *a, **k)

    enc.finish_p_frame = wrapped
    return seen


def cu_shares(seen):
    """Shares of the P-frames' CUs by depth and by mode (a CU at depth d
    covers (8 >> d)^2 of the 8x8 units)."""
    from hevc_tpu_torch.pipeline import psearch
    by_depth = np.zeros(4)
    by_mode = np.zeros(4)
    for d8, m8, *_ in seen:
        d8, m8 = d8.cpu().numpy(), m8.cpu().numpy()
        for d in range(4):
            at = d8 == d
            by_depth[d] += at.sum() / (8 >> d) ** 2
            for m in range(4):
                by_mode[m] += (at & (m8 == m)).sum() / (8 >> d) ** 2
    n = by_depth.sum()
    names = {psearch.AMVP: "amvp", psearch.MERGE: "merge",
             psearch.SKIP: "skip", psearch.INTRA: "intra"}
    return ({str(64 >> d): by_depth[d] / n for d in range(4)},
            {names[m]: by_mode[m] / n for m in range(4)}, int(n))


def pu_ref_shares(seen):
    """Shares of the P-frames' CUs by PU shape, and of their inter 8x8
    units by reference index; the 8x8 units of each rectangular shape and
    of references other than the newest."""
    from hevc_tpu_torch.pipeline import psearch
    by_part, by_ref = np.zeros(3), {}
    units = {"2NxN": 0, "Nx2N": 0, "ref_above_0": 0}
    for d8, m8, p8, r8 in seen:
        d8, m8, p8, r8 = (x.cpu().numpy() for x in (d8, m8, p8, r8))
        cu_part = 1.0 / (8 >> d8) ** 2      # each unit's part of its CU
        for k in range(3):
            by_part[k] += cu_part[p8 == k].sum()
        refs, counts = np.unique(r8[m8 != psearch.INTRA], return_counts=True)
        for r, c in zip(refs, counts):
            by_ref[int(r)] = by_ref.get(int(r), 0) + int(c)
        units["2NxN"] += int((p8 == 1).sum())
        units["Nx2N"] += int((p8 == 2).sum())
        units["ref_above_0"] += int((r8 > 0).sum())
    n_inter = max(sum(by_ref.values()), 1)
    return ({k: by_part[i] / by_part.sum()
             for i, k in enumerate(("2Nx2N", "2NxN", "Nx2N"))},
            {str(r): c / n_inter for r, c in sorted(by_ref.items())}, units)


def slice_bytes(stream):
    """Bytes of each slice NAL unit (one per picture) of an Annex-B
    stream, start codes left out."""
    starts = [m.end() for m in re.finditer(b"\x00\x00\x01", stream)]
    out = []
    for a, b in zip(starts, starts[1:] + [len(stream) + 3]):
        nal = stream[a:b - 3].rstrip(b"\x00")
        if (nal[0] >> 1) & 0x3F < 32:          # VCL NAL unit types
            out.append(len(nal))
    return out


def full_tree_run(enc, frames, of, rate_control=None):
    """`enc.encode(frames)` of a CU-tree `LDPEncoder` at 1080p: HM decode,
    both kernels counted (K1 twice per P-frame through intra-in-P), each
    P-frame timed by stage (pre-encode + LSTM step, search, finish,
    coder), the shares of CUs by depth and mode, the run's peak memory,
    then one warm P-frame's device kernels, busy time and peak memory
    above what stays resident. Returns (the record to print, launches,
    the searches seen)."""
    seen = record_searches(enc)
    p_frames, last, encode_full = [], [], enc._encode_full

    def timed(pf, dpb, poc, qp, times):
        t0 = time.perf_counter()
        out = encode_full(pf, dpb, poc, qp, times)
        p_frames.append({"poc": poc, "wall_ms": (time.perf_counter() - t0)
                         * 1e3, **{k[:-2] + "_ms": v * 1e3
                                   for k, v in times.items()}})
        last[:] = [pf, dpb, poc, qp]
        return out

    enc._encode_full = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames, rate_control=rate_control)
    stats = enc.last_stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = kernel_launches()
    check_full_launches(launches, len(frames) - 1, of)
    psnrs = ldp_psnr_check(frames, recons, of)
    hm_check(stream, recons, 1920, 1080, of)
    by_depth, by_mode, n_cu = cu_shares(seen)
    # one warm P-frame again: its peak device memory above what stays
    # resident (the networks, the reference pictures), its device work
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encode_full(*last)
    p_peak = torch.cuda.max_memory_allocated() - resident
    kernels, copies, busy_ms = device_kernels(lambda: encode_full(*last))
    if kernels == 0:
        fail(f"{of}: the profiler saw no device kernel")
    warm = p_frames[1:]
    record = {
        "phase": of, "frames": len(frames), "size": "1920x1080",
        "padded": f"{enc.cfg.pad_width}x{enc.cfg.pad_height}",
        "tree": "full", "rect_pu": enc.rect_pu,
        "num_refs": enc.cfg.num_refs, "cnn": os.path.basename(WEIGHTS),
        "lstm": os.path.basename(LSTM_WEIGHTS),
        "frame_qps": enc.frame_qps, "bytes": len(stream),
        "slice_bytes": slice_bytes(stream), "psnr_y": psnrs,
        "wall_s": wall, **stats, "p_frame_ms": p_frames,
        "warm_p_frame_median_ms": {
            k: float(np.median([t[k] for t in warm]))
            for k in ("wall_ms", "predict_ms", "search_ms", "recon_ms",
                      "entropy_ms")},
        "p_frame_device_kernels": kernels,
        "p_frame_copies_and_fills": copies,
        "p_frame_device_busy_ms": busy_ms,
        "peak_device_bytes": peak,
        "p_frame_peak_device_bytes_above_resident": p_peak,
        "p_frame_cus": n_cu, "cu_share_by_size": by_depth,
        "cu_share_by_mode": by_mode,
        "satd35_launches": launches["satd35"],
        "recon_frame_launches": launches["recon_frame"]}
    return record, launches, seen


def check_ldp_full_1080p(frames, cnn):
    """Eight 1080p frames through the ETH-LSTM-gated CU-tree
    `LDPEncoder(tree="full", rect_pu=False)` (filters off), as
    `full_tree_run` sets out. Returns the kernels' launches on this
    path."""
    record, launches, _ = full_tree_run(full_encoder(1920, 1080, cnn),
                                        frames, "ldp_full_1080p")
    if record["frame_qps"] != [32, 35, 34, 35, 33, 35, 34, 35]:
        fail(f"ldp_full_1080p: frame QPs {record['frame_qps']}")
    say(record)
    return launches


def check_ldp_full_filters_1080p(frames, cnn, make=None,
                                 of="ldp_full_filters_1080p"):
    """The first three 1080p frames through the full tree (`make`, default
    `full_encoder`) with deblocking and SAO on: HM decode, the kernels'
    launches."""
    enc = (make or full_encoder)(1920, 1080, cnn, deblock=True, sao=True)
    reset_launches()
    t0 = time.perf_counter()
    stream, recons = enc.encode(frames)
    stats = enc.last_stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    check_full_launches(launches, len(frames) - 1, of)
    psnrs = ldp_psnr_check(frames, recons, of)
    hm_check(stream, recons, 1920, 1080, of)
    say({"phase": of, "frames": len(frames), "rect_pu": enc.rect_pu,
         "num_refs": enc.cfg.num_refs, "deblock": True, "sao": True,
         "frame_qps": enc.frame_qps, "bytes": len(stream),
         "slice_bytes": slice_bytes(stream), "psnr_y": psnrs, "wall_s": wall,
         **stats, "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"]})
    return launches


def check_ldp_full_card_vs_cpu(cnn, cnn_cpu):
    """The card's full-tree stream against the CPU's: four 416x240
    frames (448x256 coded), ETH-LSTM-gated, a noise patch that appears in
    frame 2 and a flat block new in frame 3 (intra CUs). Fails unless
    some CU was intra, some merged or skipped, and some split."""
    from hevc_tpu_torch.pipeline import bench_hooks, psearch
    frames = bench_hooks.synth_structured(4, 17, 416, 240)
    rng = np.random.RandomState(17)
    frames[2].y[64:128, 192:256] = rng.randint(0, 256, (64, 64))
    frames[3].y[64:128, 192:256] = np.roll(frames[2].y[64:128, 192:256], 2, 1)
    frames[3].y[144:176, 32:64] = 235
    out = {}
    for dev, net in (("cuda", cnn), ("cpu", cnn_cpu)):
        enc = full_encoder(416, 240, net, device=dev)
        seen = record_searches(enc)
        out[dev] = enc.encode(frames)[:2] + (enc.frame_qps, seen)
    if out["cuda"][0] != out["cpu"][0] or out["cuda"][2] != out["cpu"][2]:
        fail("ldp_full_card_vs_cpu: the card's stream differs from the CPU's")
    seen = [(d.cpu().numpy(), m.cpu().numpy()) for d, m, *_ in out["cuda"][3]]
    intra = sum(int((m == psearch.INTRA).sum()) for _, m in seen)
    merged = sum(int(np.isin(m, (psearch.MERGE, psearch.SKIP)).sum())
                 for _, m in seen)
    split = sum(int((d > 0).sum()) for d, _ in seen)
    if not (intra and merged and split):
        fail(f"ldp_full_card_vs_cpu: 8x8 units intra {intra}, merged or "
             f"skipped {merged}, in split CUs {split}: a branch was not "
             "exercised")
    say({"phase": "ldp_full_card_vs_cpu", "size": "416x240",
         "padded": "448x256", "frames": len(frames), "lstm": True,
         "frame_qps": out["cuda"][2], "bytes": len(out["cuda"][0]),
         "identical": True, "units_intra": intra,
         "units_merge_or_skip": merged, "units_in_split_cus": split})


def rect_encoder(w, h, cnn, device=None, num_refs=4, slice_mode="P",
                 **cfg_kw):
    """The JAX encoder's default operating point: `LDPEncoder(cfg)` with
    `tree="full"`, `rect_pu=True` and `cfg.num_refs` references at QP 32,
    gated by the shipped ETH-LSTM (cfg_kw: deblock, sao), P slices or,
    with slice_mode="B", low-delay B."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.pframe import LDPEncoder
    return LDPEncoder(EncoderConfig(w, h, qp=32, num_refs=num_refs,
                                    **cfg_kw),
                      cnn=cnn, lstm_params=ldp_lstm_params(),
                      slice_mode=slice_mode, device=device)


def check_rect_exercised(seen, of):
    """Both rectangular PU shapes and a reference other than the newest
    were chosen somewhere in `seen`. Returns the shares and counts."""
    by_part, by_ref, units = pu_ref_shares(seen)
    if not (units["2NxN"] and units["Nx2N"] and units["ref_above_0"]):
        fail(f"{of}: 8x8 units in 2NxN CUs {units['2NxN']}, in Nx2N CUs "
             f"{units['Nx2N']}, with refIdx > 0 {units['ref_above_0']}: a "
             "branch was not exercised")
    return {"cu_share_by_pu_shape": by_part,
            "inter_unit_share_by_ref_idx": by_ref, "units": units}


def check_ldp_rect_1080p(frames, cnn):
    """Eight 1080p frames of the shear clip through the JAX encoder's
    default operating point, `LDPEncoder(cfg)` with rectangular PUs and
    four references, ETH-LSTM-gated, filters off, as `full_tree_run`
    sets out; fails unless both rectangular shapes and a reference other
    than the newest were chosen. Returns the kernels' launches."""
    record, launches, seen = full_tree_run(rect_encoder(1920, 1080, cnn),
                                           frames, "ldp_rect_1080p")
    if record["frame_qps"] != [32, 35, 34, 35, 33, 35, 34, 35]:
        fail(f"ldp_rect_1080p: frame QPs {record['frame_qps']}")
    say({**record, **check_rect_exercised(seen, "ldp_rect_1080p")})
    return launches


def check_ldp_rect_card_vs_cpu(cnn, cnn_cpu):
    """The card's stream of the default operating point against the
    CPU's: four 416x240 frames of the shear clip (448x256 coded), two
    references, ETH-LSTM-gated, deblocking and SAO on. Fails unless both
    rectangular shapes and a reference other than the newest were
    chosen."""
    from hevc_tpu_torch.pipeline import bench_hooks
    frames = bench_hooks.synth_shear(4, 416, 240)
    out = {}
    for dev, net in (("cuda", cnn), ("cpu", cnn_cpu)):
        enc = rect_encoder(416, 240, net, device=dev, num_refs=2,
                           deblock=True, sao=True)
        seen = record_searches(enc)
        out[dev] = enc.encode(frames)[:2] + (enc.frame_qps, seen)
    if out["cuda"][0] != out["cpu"][0] or out["cuda"][2] != out["cpu"][2]:
        fail("ldp_rect_card_vs_cpu: the card's stream differs from the CPU's")
    say({"phase": "ldp_rect_card_vs_cpu", "size": "416x240",
         "padded": "448x256", "frames": len(frames), "num_refs": 2,
         "lstm": True, "deblock": True, "sao": True,
         "frame_qps": out["cuda"][2], "bytes": len(out["cuda"][0]),
         "identical": True,
         **check_rect_exercised(out["cuda"][3], "ldp_rect_card_vs_cpu")})
    return out["cuda"][:2]


def rc_moves(qps, init_qp, of):
    """Fails unless the controller's QP left `init_qp` in two pictures."""
    if sum(q != init_qp for q in qps) < 2:
        fail(f"{of}: the QP did not move ({qps})")


def check_ldp_rc_1080p(frames, cnn, target_bps=10_000_000):
    """The eight structured 1080p frames through the default operating
    point under a picture-level RateController: as `full_tree_run` sets
    out (HM decode included), the QP moving. Returns the kernels'
    launches."""
    from hevc_tpu_torch.pipeline.ratectrl import RateController
    rc = RateController(target_bps, 30, 1920, 1080, len(frames), init_qp=32)
    record, launches, _ = full_tree_run(rect_encoder(1920, 1080, cnn),
                                        frames, "ldp_rc_1080p",
                                        rate_control=rc)
    rc_moves(record["frame_qps"], 32, "ldp_rc_1080p")
    say({**record, "target_bps": target_bps, "fps": 30,
         "target_bits": target_bps * len(frames) / 30,
         "bits": 8 * record["bytes"],
         "slice_bits_target_per_picture": target_bps / 30})
    return launches


def check_ldp_rc_card_vs_cpu(cnn, cnn_cpu, target_bps=500_000):
    """The default operating point under a RateController on four
    416x240 structured frames (448x256 coded): the card's stream and QPs
    equal the CPU's, the QP moves."""
    from hevc_tpu_torch.pipeline import bench_hooks
    from hevc_tpu_torch.pipeline.ratectrl import RateController
    frames = bench_hooks.synth_structured(4, 19, 416, 240)
    out = {}
    for dev, net in (("cuda", cnn), ("cpu", cnn_cpu)):
        enc = rect_encoder(416, 240, net, device=dev)
        rc = RateController(target_bps, 30, 416, 240, len(frames),
                            init_qp=32)
        out[dev] = enc.encode(frames, rate_control=rc)[0], enc.frame_qps
    if out["cuda"] != out["cpu"]:
        fail(f"ldp_rc_card_vs_cpu: card QPs {out['cuda'][1]}, CPU QPs "
             f"{out['cpu'][1]}, streams equal "
             f"{out['cuda'][0] == out['cpu'][0]}")
    rc_moves(out["cuda"][1], 32, "ldp_rc_card_vs_cpu")
    say({"phase": "ldp_rc_card_vs_cpu", "size": "416x240",
         "padded": "448x256", "frames": len(frames), "num_refs": 4,
         "target_bps": target_bps, "fps": 30, "frame_qps": out["cuda"][1],
         "bytes": len(out["cuda"][0]), "identical": True})


def write_cfg(path, opts):
    with open(path, "w") as f:
        for k, v in opts.items():
            f.write(f"{k:<24}: {v}\n")


#: GOP rows of the LDB cfg: HM's encoder_lowdelay_main.cfg operating
#: point, every row a B picture, QP offsets 3, 2, 3, 1, four active
#: references
LDB_GOP = {
    "Frame1": "B 1 3 0.4624 0 0 0 4 4 -1 -5 -9 -13 0",
    "Frame2": "B 2 2 0.4624 0 0 0 4 4 -1 -2 -6 -10 1 -1 5 1 1 1 0 1",
    "Frame3": "B 3 3 0.4624 0 0 0 4 4 -1 -3 -7 -11 1 -1 5 0 1 1 1 1",
    "Frame4": "B 4 1 0.578 0 0 0 4 4 -1 -4 -8 -12 1 -1 5 0 1 1 1 1",
}


def run_encoder_app(tmp, frames, mode_cfg, extra_args, of):
    """`hevc_tpu_torch.apps.encoder.main` on the card over `frames`
    written as a 4:2:0 YUV file, with a source cfg and `mode_cfg` (both
    written here). Returns (stream, recon frames read back from the
    app's recon file, its stdout lines, the wall seconds of main(), the
    encoder object, the kernels' launches, the bitstream and recon
    paths)."""
    import contextlib
    import io
    from hevc_tpu_torch.apps import encoder as app
    from hevc_tpu_torch.core.yuv import read_yuv420, write_yuv420
    from hevc_tpu_torch.pipeline import pframe
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    h, w = frames[0].y.shape
    yuv, bs, rec = (os.path.join(tmp, f"{of}.{e}")
                    for e in ("yuv", "bin", "rec.yuv"))
    write_yuv420(yuv, frames)
    src, mode = os.path.join(tmp, "src.cfg"), os.path.join(tmp, "mode.cfg")
    write_cfg(src, {"InputFile": yuv, "InputBitDepth": 8,
                    "InputChromaFormat": 420, "FrameRate": 30,
                    "FrameSkip": 0, "SourceWidth": w, "SourceHeight": h,
                    "FramesToBeEncoded": len(frames), "Level": 4.1})
    write_cfg(mode, {"BitstreamFile": bs, "ReconFile": rec,
                     "MaxCUWidth": 64, "MaxCUHeight": 64,
                     "MaxPartitionDepth": 4, "QP": 32, "RDOQ": 1,
                     "LoopFilterDisable": 0, "SAO": 1, **mode_cfg})
    made = []
    encodes = {cls: cls.encode for cls in (pframe.LDPEncoder, AIEncoder)}

    def keep(fn):
        def encode(self, *a, **k):
            made.append(self)
            return fn(self, *a, **k)
        return encode

    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        for cls, fn in encodes.items():
            cls.encode = keep(fn)
        with contextlib.redirect_stdout(out):
            rc = app.main(["-c", src, "-c", mode, *extra_args])
    finally:
        for cls, fn in encodes.items():
            cls.encode = fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    if rc != 0 or len(made) != 1:
        fail(f"{of}: the encoder app returned {rc}")
    with open(bs, "rb") as f:
        stream = f.read()
    return (stream, read_yuv420(rec, w, h), out.getvalue().splitlines(),
            wall, made[0], launches, bs, rec)


def check_app_log(lines, frames, slice_type, of):
    """The app's log: one `POC n ( X-SLICE, QP q )` line per picture, the
    IDR an I slice and every other picture `slice_type`, then SUMMARY."""
    pocs = [re.match(r"POC\s+(\d+) \( ([IPB])-SLICE, QP\s*(\d+) \)", ln)
            for ln in lines if ln.startswith("POC")]
    types = [m.group(2) for m in pocs if m]
    want = ["I"] + [slice_type] * (len(frames) - 1)
    if types != want or not lines[-1].startswith("SUMMARY:"):
        fail(f"{of}: the app's log reads slice types {types}, expected "
             f"{want}, last line {lines[-1]!r}")
    return [int(m.group(3)) for m in pocs]


def check_hm_of_app(bs, rec, recons, w, h, of, slice_type):
    """HM decodes the app's bitstream file with matching MD5, names the
    first picture an I slice and every later one a `slice_type` slice (in
    output order), and its output equals the app's recon file. Returns
    HM's seconds."""
    from hevc_tpu_torch.core.yuv import read_yuv420
    t0 = time.perf_counter()
    out = bs + ".hm.yuv"
    log = hm_decode_file(bs, out, of)
    hm_s = time.perf_counter() - t0
    hm_types = re.findall(r"POC\s+\d+\s+TId:\s*\d+\s*\(\s*([IPB])-SLICE",
                          log)
    want = ["I"] + [slice_type] * (len(recons) - 1)
    if hm_types != want:
        fail(f"{of}: HM's log reads slice types {hm_types}, expected {want}")
    dec = read_yuv420(out, w, h)
    with open(out, "rb") as f1, open(rec, "rb") as f2:
        if f1.read() != f2.read() or len(dec) != len(recons):
            fail(f"{of}: HM's output differs from the app's recon file")
    return hm_s


def check_app_ldb_1080p(frames):
    """Eight 1080p frames of the shear clip through the encoder app in
    LDB mode on the card (GOP 4, every row B, four references, QP 32,
    deblocking, SAO and RDOQ on, the shipped ETH-LSTM): HM decodes the
    bitstream file with matching MD5 and B slices at POC 1-7, its output
    equals the app's recon file, K1 runs 17 times and K2 62 times. Prints
    bytes, PSNR-Y, the app's time and the wall time of each picture.
    Returns (stream, recons, launches)."""
    of = "app_ldb_1080p"
    h, w = frames[0].y.shape
    with tempfile.TemporaryDirectory() as tmp:
        stream, recons, lines, wall, enc, launches, bs, rec = \
            run_encoder_app(tmp, frames, {"IntraPeriod": -1, "GOPSize": 4,
                                          "DecodingRefreshType": 0,
                                          **LDB_GOP},
                            ["--lstm", LSTM_WEIGHTS], of)
        qps = check_app_log(lines, frames, "B", of)
        check_full_launches(launches, len(frames) - 1, of)
        if enc.slice_mode != "B" or enc.cfg.num_refs != 4:
            fail(f"{of}: the app built slice_mode={enc.slice_mode}, "
                 f"num_refs={enc.cfg.num_refs}")
        psnrs = ldp_psnr_check(frames, recons, of)
        hm_s = check_hm_of_app(bs, rec, recons, w, h, of, "B")
    frame_ms = [t * 1e3 for t in enc.frame_s]
    say({"phase": of, "frames": len(frames), "size": f"{w}x{h}",
         "mode": "ldb", "gop": 4, "num_refs": 4,
         "deblock": True, "sao": True, "lstm": True, "frame_qps": qps,
         "bytes": len(stream), "slice_bytes": slice_bytes(stream),
         "psnr_y": psnrs, "app_wall_s": wall,
         "summary": lines[-1], "frame_ms": frame_ms,
         "warm_b_frame_ms_median": float(np.median(frame_ms[2:])),
         **enc.last_stats, "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"],
         "hm_decode_s": hm_s, "hm_md5": "match",
         "hm_slice_types": "I, then B at POC 1-7",
         "hm_output_equals_recon_file": True})
    return stream, recons, launches


def check_app_ai_1080p(frames):
    """Two 1080p frames of the structured clip through the encoder app in
    AI mode on the card (IntraPeriod 1, deblocking and SAO on, the
    trained ETH-CNN): HM decodes with matching MD5 and equals the recon
    file; K1 runs 3 and K2 62 times per frame. Returns the launches."""
    of = "app_ai_1080p"
    h, w = frames[0].y.shape
    with tempfile.TemporaryDirectory() as tmp:
        stream, recons, lines, wall, enc, launches, bs, rec = \
            run_encoder_app(tmp, frames, {"IntraPeriod": 1, "GOPSize": 1},
                            ["--cnn", WEIGHTS], of)
        check_app_log(lines, frames, "I", of)
        want = {"satd35": 3 * len(frames),
                "recon_frame": RECON_LAUNCHES_1080P * len(frames)}
        if launches != want:
            fail(f"{of}: kernel launches {launches}, expected {want}")
        if not (enc.cfg.deblock and enc.cfg.sao and enc.cnn is not None):
            fail(f"{of}: the app did not build the filtered, CNN-gated "
                 "AIEncoder")
        psnrs = ldp_psnr_check(frames, recons, of)
        hm_s = check_hm_of_app(bs, rec, recons, w, h, of, "I")
    say({"phase": of, "frames": len(frames), "size": f"{w}x{h}",
         "mode": "ai", "deblock": True, "sao": True, "cnn": True,
         "bytes": len(stream), "psnr_y": psnrs, "app_wall_s": wall,
         "s_per_frame": wall / len(frames), "summary": lines[-1],
         "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"],
         "hm_decode_s": hm_s, "hm_md5": "match",
         "hm_output_equals_recon_file": True})
    return launches


def check_ldb_card_vs_cpu(cnn, cnn_cpu):
    """Low-delay B, card against CPU: four 416x240 frames of the shear
    clip (448x256 coded), two references, rectangular PUs,
    ETH-LSTM-gated, deblocking and SAO on, `slice_mode="B"`: the same
    bytes. Returns the card's (stream, recons)."""
    from hevc_tpu_torch.pipeline import bench_hooks
    frames = bench_hooks.synth_shear(4, 416, 240)
    out = {}
    for dev, net in (("cuda", cnn), ("cpu", cnn_cpu)):
        enc = rect_encoder(416, 240, net, device=dev, num_refs=2,
                           slice_mode="B", deblock=True, sao=True)
        out[dev] = enc.encode(frames)
    if out["cuda"][0] != out["cpu"][0]:
        fail("ldb_card_vs_cpu: the card's B stream differs from the CPU's")
    hm_check(out["cuda"][0], out["cuda"][1], 416, 240, "ldb_card_vs_cpu")
    say({"phase": "ldb_card_vs_cpu", "size": "416x240", "padded": "448x256",
         "frames": len(frames), "num_refs": 2, "slice_mode": "B",
         "lstm": True, "deblock": True, "sao": True,
         "bytes": len(out["cuda"][0]), "identical": True})
    return out["cuda"]


def check_decoder_card(streams, big):
    """The port's decoder on the card: every stream of `streams` ({name:
    (stream, recons, w, h)}) decodes with every MD5 hash OK into the
    encoder's reconstructions and HM's output; then the 1080p LDB stream
    `big` once, timed."""
    from hevc_tpu_torch.core.yuv import read_yuv420
    from hevc_tpu_torch.decoder import decode_annexb
    rec = {}
    for name, (stream, recons, w, h) in streams.items():
        t0 = time.perf_counter()
        res = decode_annexb(stream)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if res.hash_ok != [True] * len(recons):
            fail(f"decoder_card {name}: hashes {res.hash_ok}")
        with tempfile.TemporaryDirectory() as tmp:
            bs, out = os.path.join(tmp, "s.bin"), os.path.join(tmp, "o.yuv")
            with open(bs, "wb") as f:
                f.write(stream)
            hm_decode_file(bs, out, f"decoder_card {name}")
            hm = read_yuv420(out, w, h)
        for d, r, m in zip(res.frames, recons, hm):
            for p in ("y", "cb", "cr"):
                if not (np.array_equal(getattr(d, p), getattr(r, p))
                        and np.array_equal(getattr(d, p), getattr(m, p))):
                    fail(f"decoder_card {name}: a decoded picture differs "
                         "from the encoder's recon or HM's output")
        rec[name] = {"size": f"{w}x{h}", "frames": len(recons),
                     "bytes": len(stream), "s": sec,
                     "s_per_frame": sec / len(recons)}
    stream, recons = big
    t0 = time.perf_counter()
    res = decode_annexb(stream)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if res.hash_ok != [True] * len(recons) or not all(
            np.array_equal(getattr(d, p), getattr(r, p))
            for d, r in zip(res.frames, recons) for p in ("y", "cb", "cr")):
        fail(f"decoder_card app_ldb_1080p: hashes {res.hash_ok}, or a "
             "decoded picture differs from the encoder's recon")
    h, w = recons[0].y.shape
    rec["app_ldb_1080p"] = {"size": f"{w}x{h}", "frames": len(recons),
                            "bytes": len(stream), "s": sec,
                            "s_per_frame": sec / len(recons)}
    say({"phase": "decoder_card", "hash_ok": "all", "equals_recons": True,
         "equals_hm": "416x240 streams", "streams": rec})


def expect_launches(got, want, of):
    """Fail unless the kernel launch counts `got` equal `want`, and the
    plain reconstruction ran no batch."""
    from hevc_tpu_torch.pipeline import recon
    if got != want or recon.batches != 0:
        fail(f"{of}: launches {got} (plain recon batches {recon.batches}), "
             f"expected {want}")


def tu_schedule_stats(depth8s):
    """(levels, (step, size class) pairs that run, padded steps) of the
    TU backend's schedule of frames with these depth maps, stacked as
    FrameParallelAI stacks them."""
    from hevc_tpu_torch.pipeline import recon_tu
    stacked = recon_tu.stack_schedules(
        [recon_tu.build_schedule(d)[0] for d in depth8s])
    active = np.stack([stacked[s8][1].any(axis=(0, 2)) for s8 in (1, 2, 4)])
    return (int(np.nonzero(active.any(0))[0].max()) + 1, int(active.sum()),
            active.shape[1])


def check_recon_tu_1080p(frames, cnn):
    """The TU-wavefront backend (`recon_tu`, plain PyTorch) at 1080p: two
    frames through `AIEncoder(recon_backend="tu")` and the eight through
    `FrameParallelAI(recon_backend="tu")`, each stream equal to the K2
    stream of the same encoder at `nxn=False`, HM decode with MD5; K1
    twice per decide call (node sizes 16 and 8: NxN is off), K2 never;
    then one frame's TU reconstruction traced (its ms per frame is the
    encode's `recon_s`)."""
    import dataclasses

    from hevc_tpu_torch.core.yuv import pad_frame
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.parallel.frames import FrameParallelAI
    from hevc_tpu_torch.pipeline import recon_tu
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    cfg = EncoderConfig(1920, 1080, qp=32)
    cfg0 = dataclasses.replace(cfg, nxn=False)
    out = {"phase": "recon_tu_1080p", "qp": 32, "nxn": False}
    ai_auto = AIEncoder(cfg0, cnn=cnn).encode(frames[:2])
    fp_auto = FrameParallelAI(cfg0, cnn=cnn, decide_chunk=2).encode(
        frames, chunk=4)[0]

    reset_launches()
    enc = AIEncoder(cfg, cnn=cnn, recon_backend="tu")
    t0 = time.perf_counter()
    stream, recons, stats = enc.encode(frames[:2])
    torch.cuda.synchronize()
    out["aiencoder"] = {"frames": 2, "bytes": len(stream),
                        "wall_s": time.perf_counter() - t0, **stats}
    ai_launches = kernel_launches()
    expect_launches(ai_launches, {"satd35": 2 * 2, "recon_frame": 0},
                    "recon_tu_1080p AIEncoder")
    if stream != ai_auto[0]:
        fail("recon_tu_1080p: AIEncoder's TU stream differs from its K2 "
             "stream at nxn=False")
    hm_check(stream, recons, 1920, 1080, "recon_tu_1080p AIEncoder")

    reset_launches()
    penc = FrameParallelAI(cfg, cnn=cnn, decide_chunk=2, recon_backend="tu")
    t0 = time.perf_counter()
    pstream, pstats = penc.encode(frames, chunk=4)
    torch.cuda.synchronize()
    fp_launches = kernel_launches()
    want_k1 = sum((md >= 2) + (md >= 3) for md, _ in penc.decide_batches)
    expect_launches(fp_launches, {"satd35": want_k1, "recon_frame": 0},
                    "recon_tu_1080p FrameParallelAI")
    if want_k1 != 2 * len(penc.decide_batches):
        fail(f"recon_tu_1080p: decide batches {penc.decide_batches}")
    if pstream != fp_auto:
        fail("recon_tu_1080p: FrameParallelAI's TU stream differs from its "
             "K2 stream at nxn=False")
    with tempfile.TemporaryDirectory() as tmp:
        bs = os.path.join(tmp, "s.bin")
        with open(bs, "wb") as f:
            f.write(pstream)
        hm_decode_file(bs, os.path.join(tmp, "r.yuv"),
                       "recon_tu_1080p FrameParallelAI")
    out["frameparallel"] = {
        "frames": len(frames), "chunk": 4, "decide_chunk": 2,
        "bytes": len(pstream), "wall_s": time.perf_counter() - t0,
        "decide_batches": penc.decide_batches, **pstats}

    # the reconstruction of one frame traced (device activity only: a
    # trace of the host's operators too would hold millions of events)
    pf = pad_frame(frames[0], cfg.pad_width, cfg.pad_height)
    d8, m8 = enc.decide_frame(pf.y, None, pf.cb, pf.cr)
    kernels, copies, busy = device_kernels(
        lambda: recon_tu.reconstruct_tu(pf.y, pf.cb, pf.cr, d8, m8, qp=32,
                                        pad_w=cfg.pad_width,
                                        pad_h=cfg.pad_height),
        host=False)
    if kernels == 0:
        fail("recon_tu_1080p: the trace holds no device kernel")
    levels, pairs, padded = tu_schedule_stats([d8])
    out["reconstruction"] = {
        "ms_per_frame_in_encode": stats["recon_s"] / 2 * 1e3,
        "levels": levels, "step_class_pairs": pairs,
        "padded_steps": padded, "device_kernels": kernels,
        "copies_fills": copies, "device_busy_ms": busy,
        "frameparallel_device_ms_per_frame":
            pstats["device_s"] / len(frames) * 1e3}
    out.update(satd35_launches=fp_launches["satd35"],
               recon_frame_launches=0, streams_equal_k2=True,
               hm_md5="match")
    say(out)
    return ai_launches, fp_launches


def check_golden_card(small, s_kernel, cnn):
    """`AIEncoder(recon_backend="golden")` at 416x240, the decide on the
    card, the host NumPy reconstruction: the K2 stream's bytes."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    reset_launches()
    enc = AIEncoder(EncoderConfig(416, 240, qp=32), cnn=cnn,
                    recon_backend="golden")
    t0 = time.perf_counter()
    stream, _, stats = enc.encode(small)
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    expect_launches(launches, {"satd35": 3 * len(small), "recon_frame": 0},
                    "golden_card")
    if stream != s_kernel:
        fail("golden_card: the golden backend's stream differs from K2's")
    say({"phase": "golden_card", "size": "416x240", "frames": len(small),
         "bytes": len(stream), "equals_k2_stream": True, "wall_s": wall,
         "s_per_frame": wall / len(small), **stats,
         "satd35_launches": launches["satd35"], "recon_frame_launches": 0})
    return launches


def check_labels_1080p(frame):
    """CU-depth labels of one structured 1080p frame from HM (full RDO,
    the in-repo encoder) and from the port's ungated search on the card
    (K1 3, K2 0): shapes, depth shares and the share of the 16x16 units
    they share where the two agree."""
    from hevc_tpu_torch.train import labels
    t0 = time.perf_counter()
    hm_lab = labels.extract_labels_hm([frame], 32, 1920, 1080)
    t_hm = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    own = labels.extract_labels_own([frame], 32, 1920, 1080)
    t_own = time.perf_counter() - t0
    launches = kernel_launches()
    expect_launches(launches, {"satd35": 3, "recon_frame": 0}, "labels_1080p")
    if hm_lab.shape != (1, 67, 120) or own.shape != (1, 68, 120):
        fail(f"labels_1080p: shapes {hm_lab.shape} (HM), {own.shape} (own)")
    if hm_lab.max() > 3 or own.max() > 3:
        fail("labels_1080p: a depth above 3")
    common = own[:, :67]
    share = lambda a: [float(np.mean(a == d)) for d in range(4)]
    say({"phase": "labels_1080p", "qp": 32, "hm_shape": list(hm_lab.shape),
         "own_shape": list(own.shape), "hm_s": t_hm, "own_s": t_own,
         "agreement": float(np.mean(common == hm_lab)),
         "within_one": float(np.mean(np.abs(common.astype(int)
                                            - hm_lab.astype(int)) <= 1)),
         "hm_depth_shares": share(hm_lab), "own_depth_shares": share(common),
         "satd35_launches": launches["satd35"], "recon_frame_launches": 0})
    return launches


def check_bdrate_1080p(frames, cnn):
    """`bdrate.compare` on two structured 1080p frames at QP 22/27/32/37
    (ETH-CNN qp30~35 for every QP, deblocking on), against HM; then HM
    decodes the port's stream of each QP (made again with the MD5 SEI)."""
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.evaltools import bdrate
    from hevc_tpu_torch.pipeline.ai import AIEncoder
    qps = (22, 27, 32, 37)
    reset_launches()
    out = bdrate.compare(frames, 1920, 1080, qps, cnn=cnn)
    launches = kernel_launches()
    n = len(qps) * len(frames)
    expect_launches(launches, {"satd35": 3 * n,
                               "recon_frame": RECON_LAUNCHES_1080P * n},
                    "bdrate_1080p")
    if not (np.isfinite(out["bd_rate_vs_hm"])
            and np.isfinite(out["speedup_vs_hm"])):
        fail(f"bdrate_1080p: not finite: {out}")
    for qp in qps:
        cfg = EncoderConfig(1920, 1080, qp=qp, deblock=True)
        stream, recons, _ = AIEncoder(cfg, cnn=cnn).encode(frames)
        hm_check(stream, recons, 1920, 1080, f"bdrate_1080p qp {qp}")
    say({"phase": "bdrate_1080p", "frames": len(frames), "content":
         "synth_1080p_structured", "weights": "eth_cnn_qp30~35 for every QP",
         "ours_cfg": "deblock on, sao off", "hm_cfg": "hm_intra_cfg",
         **out, "hm_decodes_each_qp": True,
         "satd35_launches": launches["satd35"],
         "recon_frame_launches": launches["recon_frame"]})
    return launches


def check_ldp_bench_1080p():
    """`bench_encode_ldp_1080p()`: 16 structured frames through the
    default `LDPEncoder(cfg, num_refs=4)` with the shipped ETH-LSTM after a
    warm encode of 3; K1 3 (the IDR) + 2 per P-frame, K2 62 (the IDR)."""
    from hevc_tpu_torch.pipeline import bench_hooks
    res = bench_hooks.bench_encode_ldp_1080p()
    d = res["detail"]
    launches = {"satd35": d["satd35_launches"],
                "recon_frame": d["recon_frame_launches"]}
    expect_launches(launches, {"satd35": 3 + 2 * (d["n_frames"] - 1),
                               "recon_frame": RECON_LAUNCHES_1080P},
                    "ldp_bench_1080p")
    if not (isinstance(res["vs_baseline"], float) and res["vs_baseline"] > 0):
        fail(f"ldp_bench_1080p: vs_baseline {res['vs_baseline']}")
    say({"phase": "ldp_bench_1080p", **res})
    return launches


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    smi = nvidia_smi_line()
    say({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    device = torch.device("cuda")

    import hevc_tpu_torch  # noqa: F401  (sets TF32 off)
    from hevc_tpu_torch import cuda_build, native
    from hevc_tpu_torch.core.yuv import pad_frame, psnr
    from hevc_tpu_torch.entropy.headers import EncoderConfig
    from hevc_tpu_torch.models import eth_cnn
    from hevc_tpu_torch.ops import intra_mm
    from hevc_tpu_torch.parallel.frames import FrameParallelAI
    from hevc_tpu_torch.pipeline import bench_hooks, recon, recon_kernel
    from hevc_tpu_torch.pipeline.ai import AIEncoder

    # 2. build (from the sources of this checkout, nothing kept from
    # before; one nvcc per kernel source, both started together)
    for so in (intra_mm._SO, recon_kernel._SO, native._SO):
        if os.path.exists(so):
            os.remove(so)
    t0 = time.perf_counter()
    # `-Xptxas -v` only reports registers, spills and shared memory
    src, so, extra = recon_kernel.build_job()
    jobs = [(intra_mm._CSRC, intra_mm._SO, ("-Xptxas", "-v")),
            (src, so, (*extra, "-Xptxas", "-v"))]
    logs = cuda_build.build_all(jobs)
    intra_mm.load_kernel()
    recon_kernel.load_kernel()
    t_kernel = time.perf_counter() - t0
    native.load()
    say({"phase": "build", "kernels_nvcc_s": t_kernel,
         "native_entropy_gxx_s": time.perf_counter() - t0 - t_kernel,
         "commands": [" ".join(cuda_build.nvcc_command(*job))
                      for job in jobs]})
    usage = {fn: r for log in logs.values()
             for fn, r in ptxas_usage(log).items()}
    say({"phase": "kernel_resources", "per_function": usage})

    # 3. each kernel against its plain version on the card
    per_n, max_err = check_kernel(device)
    recon_err = check_recon_small(device)

    # 4. first main path: eight 1080p frames, one at a time, through
    # AIEncoder.encode (the reconstruction kernel with a frame batch of 1)
    cnn = eth_cnn.load_npz(WEIGHTS)
    cfg = EncoderConfig(1920, 1080, qp=32)
    frames = bench_hooks.synth_1080p_structured(n_frames=8)
    torch.cuda.synchronize()
    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    stream, recons, stats, wall = encode(frames, cnn, 1920, 1080)
    ai_launches = {"satd35": intra_mm.launches,
                   "recon_frame": recon_kernel.launches}
    if ai_launches["satd35"] != 3 * len(frames):
        fail(f"satd35 launched {ai_launches['satd35']} times for "
             f"{len(frames)} frames, expected 3 per frame")
    if ai_launches["recon_frame"] != RECON_LAUNCHES_1080P * len(frames):
        fail(f"recon_frame launched {ai_launches['recon_frame']} times for "
             f"{len(frames)} frames, expected {RECON_LAUNCHES_1080P} each")
    if recon.batches != 0:
        fail("AIEncoder.encode went through the plain reconstruction")
    psnr_y = float(psnr(recons[0].y, frames[0].y))
    for r in recons:
        if r.y.shape != (1080, 1920) or r.cb.shape != (540, 960):
            fail("recon has the wrong shape")
    if not (np.isfinite(psnr_y) and psnr_y > 28.0):
        fail(f"PSNR-Y {psnr_y} is not sane")
    say({"phase": "encode_1080p", "frames": len(frames), "qp": 32,
         "bytes": len(stream), "psnr_y": psnr_y, "wall_s": wall,
         "s_per_frame": wall / len(frames),
         "satd35_launches": ai_launches["satd35"],
         "recon_frame_launches": ai_launches["recon_frame"],
         "plain_recon_batches": recon.batches, **stats})

    # 5. K2 against its plain version on the encoder's own decisions at
    # 1080p (the plain version runs once: thousands of small launches),
    # and K2's times at frame batches of 1 and 8
    enc = AIEncoder(cfg, cnn=cnn)
    pfs = [pad_frame(f, cfg.pad_width, cfg.pad_height) for f in frames]
    dec = [enc.decide_frame_full(p.y, None, p.cb, p.cr) for p in pfs]
    stack = lambda xs: torch.as_tensor(np.stack(xs)).to(device)
    args8 = (stack([p.y for p in pfs]), stack([p.cb for p in pfs]),
             stack([p.cr for p in pfs]), stack([d[0] for d in dec]),
             stack([d[2] for d in dec]), stack([d[3] for d in dec]))
    args1 = tuple(a[:1].contiguous() for a in args8)
    kw = dict(qp=32, pad_w=cfg.pad_width, pad_h=cfg.pad_height, rdoq=True)
    got = recon.encode_frame_planes_batched(*args1, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = recon.encode_frame_planes_plain_batched(*args1, **kw,
                                                   device=device)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad, err = planes_equal(got, want)
    recon_err = max(recon_err, err)
    if bad:
        fail(f"recon_frame 1080p: planes {bad} differ from the plain "
             f"version (max abs err {err})")
    if not np.array_equal(got.recon_y[0].cpu().numpy()[:1080], recons[0].y):
        fail("recon_frame 1080p: not the reconstruction AIEncoder returned")
    k2 = {"F1": recon_kernel_times(args1, kw),
          "F8": recon_kernel_times(args8, kw)}
    for key, a in (("F1", args1), ("F8", args8)):
        nbytes, ops = bench_hooks.recon_work(a[3].cpu().numpy(),
                                             a[5].cpu().numpy())
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_INT_OPS_S * 1e3
        k2[key].update(bytes=nbytes, operations=ops,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       ms_per_frame=k2[key]["ms"] / a[0].shape[0])
    say({"phase": "recon_vs_plain", "size": "1920x1080", "frames": 1,
         "decisions": "the encoder's own", "qp": 32, "rdoq": True,
         "planes_equal": 6, "tolerance": 0, "plain_ms": plain_ms,
         "plain_batches": recon.batches, **{f"kernel_{k}": v
                                            for k, v in k2.items()}})
    # K2's time per TU step by component and TU size (uniform depth, 16
    # dependent CTUs; launch and CTU set-up included)
    tu_us = bench_hooks.recon_tu_step_us(device)
    say({"phase": "recon_tu_step_us", **tu_us})

    # 6. second main path: the same eight frames through the frame-batched
    # FrameParallelAI.encode, groups of 4, decide sub-batches of 2
    penc = FrameParallelAI(cfg, cnn=cnn, decide_chunk=2)
    torch.cuda.synchronize()
    intra_mm.launches = recon_kernel.launches = recon.batches = 0
    t0 = time.perf_counter()
    pstream, pstats = penc.encode(frames, with_hash_sei=True, chunk=4)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    fp_launches = {"satd35": intra_mm.launches,
                   "recon_frame": recon_kernel.launches}
    # per decide sub-batch K1 runs for node sizes 16, 8 and 4 where the
    # sub-batch's max depth reaches them; K2 once per group of 4 frames
    want_k1 = sum((md >= 2) + (md >= 3) + (md == 3 and cfg.nxn)
                  for md, _ in penc.decide_batches)
    if fp_launches["satd35"] != want_k1 or want_k1 != 3 * 4:
        fail(f"frames_1080p: satd35 launched {fp_launches['satd35']} times, "
             f"expected 3 for each of 4 decide sub-batches "
             f"({penc.decide_batches})")
    if fp_launches["recon_frame"] != 2 * RECON_LAUNCHES_1080P:
        fail(f"frames_1080p: recon_frame launched "
             f"{fp_launches['recon_frame']} times, expected "
             f"{RECON_LAUNCHES_1080P} for each of 2 groups")
    if recon.batches != 0:
        fail("FrameParallelAI.encode went through the plain reconstruction")
    if pstream != stream:
        fail("frames_1080p: FrameParallelAI's stream differs from AIEncoder's")
    say({"phase": "frames_1080p", "frames": len(frames), "chunk": 4,
         "decide_chunk": 2, "qp": 32, "bytes": len(pstream),
         "identical_to_AIEncoder": True, "psnr_y": psnr_y, "wall_s": pwall,
         "frames_per_s": len(frames) / pwall,
         "decide_batches": penc.decide_batches,
         "satd35_launches": fp_launches["satd35"],
         "recon_frame_launches": fp_launches["recon_frame"],
         "recon_frame_launches_formula":
             "groups * (ctus_x + 2 * (ctus_y - 1)) = 2 * 62",
         "plain_recon_batches": recon.batches, **pstats})

    # 7. the benchmark at a reduced depth (bench_torch.py runs 48 / 24 / 4)
    bench_ai = bench_hooks.bench_encode_1080p(n_frames=16, chunk=8,
                                             decide_chunk=4)
    if not (isinstance(bench_ai["vs_baseline"], float)
            and bench_ai["vs_baseline"] > 0):
        fail(f"bench_encode_1080p: vs_baseline {bench_ai['vs_baseline']}")
    say({"phase": "bench_encode_1080p", **bench_ai})

    # 8. kernel path vs plain path, same frames at 416x240: same bytes.
    # Both kernels are swapped for their plain versions, this check only.
    small = bench_hooks.synth_structured(2, 7, 416, 240)
    s_kernel, _, _, _ = encode(small, cnn, 416, 240)
    satd_fn = intra_mm.satd_all_modes
    recon_fn = recon_kernel.encode_frame_planes_cuda
    intra_mm.satd_all_modes = intra_mm.satd_all_modes_plain
    recon_kernel.encode_frame_planes_cuda = (
        lambda *a, **k: recon.encode_frame_planes_plain_batched(
            *a, **k, device=device))
    recon.batches = 0
    try:
        s_plain, _, _, _ = encode(small, cnn, 416, 240)
    finally:
        intra_mm.satd_all_modes = satd_fn
        recon_kernel.encode_frame_planes_cuda = recon_fn
    if recon.batches == 0:
        fail("416x240: the plain-path run did not reach the plain recon")
    if s_kernel != s_plain:
        fail("416x240: the kernel-path stream differs from the plain-path one")
    say({"phase": "kernel_vs_plain_stream", "size": "416x240", "frames": 2,
         "bytes": len(s_kernel), "identical": True,
         "swapped": ["satd35", "recon_frame"]})
    # ... and against the same encoder run on the CPU (asked for explicitly):
    # the float RD costs must not tip a decision between host and card
    cnn_cpu = eth_cnn.load_npz(WEIGHTS, device="cpu")
    s_cpu, _, _, _ = encode(small, cnn_cpu, 416, 240, device="cpu")
    if s_kernel != s_cpu:
        fail("416x240: the card's stream differs from the CPU's")
    say({"phase": "card_vs_cpu_stream", "size": "416x240", "frames": 2,
         "identical": True})

    # 9. conformance: the stream both main paths made
    hm_check(stream, recons, 1920, 1080, "encode_1080p")

    # 10. the in-loop filters: 1080p through AIEncoder.encode with
    # deblocking and SAO (the first two frames), then card vs CPU at
    # 416x240; 11. picture-level rate control, card vs CPU, HM decode
    filt_launches = check_filters_1080p(frames[:2], cnn, device)
    check_filters_small(small, cnn, cnn_cpu)
    rc_launches = check_rate_control(cnn, cnn_cpu)

    # 12. the Low-Delay-P predictor chain: eight 1080p frames through
    # LDPPipeline.run, its P-frames timed stage by stage; then the card's
    # chain against the CPU's at 416x240 and on the first 1080p P-frame
    ldp_frames, ldp_first = check_ldp_1080p()
    check_ldp_card_vs_cpu(ldp_frames, ldp_first)

    # 13. the flat-tree LDPEncoder: the eight 1080p frames (HM decode),
    # the first three with deblocking and SAO (HM decode), and the card's
    # filtered stream against the CPU's at 416x240
    ldp_launches = check_ldp_flat_1080p(ldp_frames, cnn)
    ldp_filt_launches = check_ldp_flat_filters_1080p(ldp_frames[:3], cnn)
    check_ldp_flat_card_vs_cpu(cnn, cnn_cpu)

    # 14. the ETH-LSTM-gated CU-tree LDPEncoder: the eight 1080p frames
    # (HM decode), the first three with deblocking and SAO (HM decode),
    # and the card's stream against the CPU's at 416x240
    full_launches = check_ldp_full_1080p(ldp_frames, cnn)
    full_filt_launches = check_ldp_full_filters_1080p(ldp_frames[:3], cnn)
    check_ldp_full_card_vs_cpu(cnn, cnn_cpu)

    # 15. the JAX encoder's default LDPEncoder(cfg): rectangular PUs, four
    # references, ETH-LSTM-gated, on eight 1080p frames of the shear clip
    # (HM decode), the first three with deblocking and SAO (HM decode),
    # the card's 416x240 stream against the CPU's; then under a
    # picture-level RateController on the structured clip (HM decode),
    # and card against CPU at 416x240
    shear = bench_hooks.synth_shear(8, 1920, 1080)
    rect_launches = check_ldp_rect_1080p(shear, cnn)
    rect_filt_launches = check_ldp_full_filters_1080p(
        shear[:3], cnn, rect_encoder, "ldp_rect_filters_1080p")
    rect_small = check_ldp_rect_card_vs_cpu(cnn, cnn_cpu)
    rc_ldp_launches = check_ldp_rc_1080p(ldp_frames, cnn)
    check_ldp_rc_card_vs_cpu(cnn, cnn_cpu)

    # 16. the CLI apps and the port's decoder: the encoder app in LDB mode
    # on the eight 1080p shear frames and in AI mode on two structured
    # 1080p frames (HM decodes the files), low-delay B card against CPU
    # at 416x240, and the port's decoder on the card over three 416x240
    # streams (LDB, filtered AI, filtered rectangular LDP with two
    # references) and the 1080p LDB stream
    ldb_stream, ldb_recons, app_ldb_launches = check_app_ldb_1080p(shear)
    app_ai_launches = check_app_ai_1080p(frames[:2])
    ldb_small = check_ldb_card_vs_cpu(cnn, cnn_cpu)
    ai_small = encode(small, cnn, 416, 240, deblock=True, sao=True)[:2]
    check_decoder_card({"ldb_card_vs_cpu": (*ldb_small, 416, 240),
                        "ai_filtered": (*ai_small, 416, 240),
                        "ldp_rect_card_vs_cpu": (*rect_small, 416, 240)},
                       (ldb_stream, ldb_recons))

    # 17. the All-Intra backends, labels, BD-rate and the HM baselines:
    # the TU-wavefront backend at 1080p (AIEncoder and FrameParallelAI,
    # streams equal to K2's at nxn=False, HM decode), the golden backend
    # at 416x240 with the decide on the card, own vs HM labels of one
    # 1080p frame, the BD-rate sweep against HM on two 1080p frames, the
    # LDP benchmark, and the HM cache both benchmarks read
    tu_ai_launches, tu_fp_launches = check_recon_tu_1080p(frames, cnn)
    golden_launches = check_golden_card(small, s_kernel, cnn)
    label_launches = check_labels_1080p(frames[0])
    bd_launches = check_bdrate_1080p(frames[:2], cnn)
    ldp_bench_launches = check_ldp_bench_1080p()
    say({"phase": "hm_baseline", "cache": os.path.relpath(
        bench_hooks.HM_BASELINE_CACHE, ROOT),
         **bench_hooks.read_hm_baseline(),
         "bench_encode_1080p_frames": bench_ai["detail"]["n_frames"],
         "bench_encode_1080p_frames_per_s": bench_ai["value"],
         "bench_encode_1080p_vs_baseline": bench_ai["vs_baseline"]})

    # 18. the kernels of the main paths. satd35: times are sums over the
    # three launches of one 1080p frame. recon_frame: one 1080p frame
    # (frame batch of 1), the 8-frame batch beside it. `launches` is the
    # count from the frame-batched path; both paths are in launches_by_path.
    tot = lambda key: sum(v[key] for v in per_n.values())
    ops_bound = all(v["bound_by"] == "operations" for v in per_n.values())
    by_path = lambda name: {
        "AIEncoder.encode": ai_launches[name],
        "FrameParallelAI.encode": fp_launches[name],
        "AIEncoder.encode deblock+sao 1080p": filt_launches[name],
        "AIEncoder.encode rate_control 416x240": rc_launches[name],
        "LDPEncoder.encode flat 1080p": ldp_launches[name],
        "LDPEncoder.encode flat deblock+sao 1080p": ldp_filt_launches[name],
        "LDPEncoder.encode full 1080p": full_launches[name],
        "LDPEncoder.encode full deblock+sao 1080p": full_filt_launches[name],
        "LDPEncoder.encode rect 4 refs 1080p": rect_launches[name],
        "LDPEncoder.encode rect 4 refs deblock+sao 1080p":
            rect_filt_launches[name],
        "LDPEncoder.encode rect 4 refs rate_control 1080p":
            rc_ldp_launches[name],
        "apps.encoder ldb 1080p": app_ldb_launches[name],
        "apps.encoder ai deblock+sao 1080p": app_ai_launches[name],
        "AIEncoder.encode recon_backend=tu 1080p": tu_ai_launches[name],
        "FrameParallelAI.encode recon_backend=tu 1080p":
            tu_fp_launches[name],
        "AIEncoder.encode recon_backend=golden 416x240":
            golden_launches[name],
        "train.labels.extract_labels_own 1080p": label_launches[name],
        "evaltools.bdrate.compare 1080p 4 QPs": bd_launches[name],
        "bench_encode_ldp_1080p": ldp_bench_launches[name]}
    regs = lambda k1: {
        fn: {k: r.get(k) for k in ("registers", "spill_store_bytes",
                                   "spill_load_bytes")}
        for fn, r in usage.items() if fn.startswith("satd35") == k1}
    say({"kernels": [{
        "name": "satd35", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/satd35.cu",
        "replaces": "hevc_tpu/ops/intra_mm.py:243",
        "replaces_function":
            "hevc_tpu/ops/intra_mm.py::_satd_all_modes_pallas",
        "launches": fp_launches["satd35"],
        "launches_by_path": by_path("satd35"),
        "max_abs_err": max_err, "equal_to_plain": True,
        "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
        "bound_ms": tot("bound_ms"),
        "bound_by": "operations" if ops_bound else "bytes",
        "bound_ms_first_stated": tot("bound_ms_first_stated"),
        "library_ms": None, "per_n": per_n,
        "registers_spills": regs(True)}, {
        "name": "recon_frame", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/recon_frame.cu",
        "replaces": "hevc_tpu/pipeline/recon_pallas.py:443",
        "replaces_function":
            "hevc_tpu/pipeline/recon_pallas.py::_build_component_call",
        "launches": fp_launches["recon_frame"],
        "launches_by_path": by_path("recon_frame"),
        "launches_per_frame_batch": RECON_LAUNCHES_1080P,
        "max_abs_err": recon_err, "equal_to_plain": True,
        "ms": k2["F1"]["ms"], "luma_ms": k2["F1"]["luma_ms"],
        "chroma_ms": k2["F1"]["chroma_ms"], "plain_ms": plain_ms,
        "bound_ms": k2["F1"]["bound_ms"], "bound_by": k2["F1"]["bound_by"],
        "library_ms": None, "tu_step_us": tu_us, "per_frame_batch": k2,
        "registers_spills": regs(False)}]})
    print(nvidia_smi_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
