"""Equivalents of the reference's App/utils tools.

Reference counterparts (one per section below):
  * annexBbytecount.cpp:120-180   — per-NAL Annex-B byte statistics
  * convert_NtoMbit_YCbCr.cpp     — YUV bit-depth conversion
  * BitrateTargeting/ExtractBitrates.cpp — per-GOP bitrate extraction
    from encoder logs
  * BitrateTargeting/GuessLambdaModifiers.cpp — iterative lambda-
    modifier search to hit target bitrates

These are host-side utilities (pure NumPy / text processing): the
reference implements them against HM's TLibDecoder/TLibVideoIO; ours sit
on the same Annex-B layout written by entropy/bitstream.py. The NAL
classification uses HEVC nal_unit_type semantics ((byte0 >> 1) & 0x3f,
VCL = 0..31) — the reference util still used the H.264 rule (byte0 &
0x1f), which misclassifies HEVC streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# annexBbytecount
# ---------------------------------------------------------------------------

@dataclass
class AnnexBStats:
    leading_zero_8bits: int = 0
    zero_byte: int = 0
    start_code_prefix: int = 0
    nal_bytes: int = 0
    trailing_zero_8bits: int = 0

    def __iadd__(self, o):
        self.leading_zero_8bits += o.leading_zero_8bits
        self.zero_byte += o.zero_byte
        self.start_code_prefix += o.start_code_prefix
        self.nal_bytes += o.nal_bytes
        self.trailing_zero_8bits += o.trailing_zero_8bits
        return self


def split_annexb(data: bytes):
    """[(stats, nal_payload_bytes)] for every NAL unit in an Annex-B
    stream (B.2.2 byte-stream NAL unit syntax; accounting matches HM
    byteStreamNALUnit — validated against annexBbytecount.cpp's
    self-test vectors in tests/test_app_utils.py).

    Zero-run accounting: a start code consumes the final 3 bytes of its
    zero run as zero_byte (when the run >= 3) + 2-byte prefix + 0x01;
    surplus zeros go to leading_zero_8bits (first NAL) or to the
    previous NAL's trailing_zero_8bits. At EOF, runs of >= 3 zeros are
    trailing_zero_8bits; shorter runs stay in the payload."""
    n = len(data)
    out = []
    i = 0
    # zeros before the first start code
    z0 = 0
    while z0 < n and data[z0] == 0:
        z0 += 1
    if z0 >= n:
        if n:
            out.append((AnnexBStats(leading_zero_8bits=n), b""))
        return out
    if data[z0] != 1 or z0 < 2:
        # no valid start code at stream head: HM would scan forward;
        # treat everything up to a real start code as leading zeros is
        # out of scope — our own streams always start with 0x000001.
        raise ValueError("stream does not start with an Annex-B "
                         "start code")
    st = AnnexBStats()
    if z0 >= 3:
        st.leading_zero_8bits = z0 - 3
        st.zero_byte = 1
    st.start_code_prefix = 3
    i = z0 + 1

    while True:
        # payload extends to the next start code (a zero run of >= 2
        # followed by 0x01) or EOF
        j = i
        nxt = None   # (payload_end, zero_run)
        while j < n:
            if data[j] == 0:
                k = j
                while k < n and data[k] == 0:
                    k += 1
                if k < n and data[k] == 1 and k - j >= 2:
                    nxt = (j, k - j)
                    break
                j = k + 1 if k < n else k
            else:
                j += 1
        if nxt is None:
            payload = data[i:]
            t = 0
            while t < len(payload) and payload[-1 - t] == 0:
                t += 1
            if t >= 3:
                st.nal_bytes = len(payload) - t
                st.trailing_zero_8bits = t
            else:
                st.nal_bytes = len(payload)
            out.append((st, bytes(payload[:st.nal_bytes])))
            return out
        pend, zrun = nxt
        st.nal_bytes = pend - i
        st.trailing_zero_8bits = max(0, zrun - 3)
        out.append((st, bytes(data[i:i + st.nal_bytes])))
        st = AnnexBStats()
        if zrun >= 3:
            st.zero_byte = 1
        st.start_code_prefix = 3
        i = pend + zrun + 1


def annexb_bytecount(data: bytes) -> Dict[str, AnnexBStats]:
    """Aggregate stats by NAL class (counterpart of the annexBbytecount
    summary): 'total', 'vcl' (HEVC types 0..31), 'filler' (38), 'other'.
    """
    total = AnnexBStats()
    vcl = AnnexBStats()
    filler = AnnexBStats()
    other = AnnexBStats()
    for st, payload in split_annexb(data):
        total += st
        if not payload:
            continue
        t = (payload[0] >> 1) & 0x3F
        if t <= 31:
            vcl += st
        elif t == 38:   # FD_NUT
            filler += st
        else:
            other += st
    return {"total": total, "vcl": vcl, "filler": filler, "other": other}


# ---------------------------------------------------------------------------
# convert_NtoMbit_YCbCr
# ---------------------------------------------------------------------------

def convert_bitdepth(in_path: str, out_path: str, width: int, height: int,
                     bitdepth_in: int = 8, bitdepth_out: int = 8,
                     num_frames: int = -1, skip: int = 0,
                     chroma: str = "420"):
    """Planar YCbCr bit-depth conversion (convert_NtoMbit_YCbCr.cpp):
    up-shift is a plain left shift, down-shift rounds to nearest
    (TVideoIOYuv scale semantics). Returns frames converted."""
    cdiv = {"400": None, "420": 2, "422": (2, 1), "444": 1}[chroma]
    ysize = width * height
    if chroma == "400":
        csize = 0
    elif chroma == "420":
        csize = (width // 2) * (height // 2)
    elif chroma == "422":
        csize = (width // 2) * height
    else:
        csize = ysize
    in_dt = np.uint8 if bitdepth_in <= 8 else np.dtype("<u2")
    out_dt = np.uint8 if bitdepth_out <= 8 else np.dtype("<u2")
    per_frame = (ysize + 2 * csize)
    delta = bitdepth_out - bitdepth_in

    def conv(a):
        a = a.astype(np.int32)
        if delta >= 0:
            a = a << delta
        else:
            a = (a + (1 << (-delta - 1))) >> (-delta)
        return np.clip(a, 0, (1 << bitdepth_out) - 1).astype(out_dt)

    done = 0
    frame_bytes = per_frame * np.dtype(in_dt).itemsize
    with open(in_path, "rb") as fi, open(out_path, "wb") as fo:
        fi.seek(skip * frame_bytes, 0)
        while num_frames < 0 or done < num_frames:
            raw = fi.read(frame_bytes)
            if len(raw) < frame_bytes:
                break
            a = np.frombuffer(raw, dtype=in_dt)
            fo.write(conv(a).tobytes())
            done += 1
    return done


# ---------------------------------------------------------------------------
# BitrateTargeting: ExtractBitrates + GuessLambdaModifiers
# ---------------------------------------------------------------------------

def extract_bitrates(log_text: str, gop_size: int = 4,
                     fps: float = 30.0) -> List[float]:
    """Per-GOP-position average bitrates (kbps) from encoder log lines
    of the form 'POC  n ... ) <bits> bits' (our CLI and HM both print
    them; counterpart of ExtractBitrates.cpp)."""
    import re
    bits_by_pos: Dict[int, List[int]] = {}
    for m in re.finditer(r"POC\s+(\d+).*?(\d+)\s+bits", log_text):
        poc, bits = int(m.group(1)), int(m.group(2))
        if poc == 0:
            continue   # intra frame: not part of the GOP targeting
        pos = (poc - 1) % gop_size
        bits_by_pos.setdefault(pos, []).append(bits)
    out = []
    for pos in range(gop_size):
        v = bits_by_pos.get(pos, [])
        out.append(float(np.mean(v)) * fps / 1000.0 if v else 0.0)
    return out


def guess_lambda_modifiers(encode_fn: Callable[[Sequence[float]],
                                               Sequence[float]],
                           targets: Sequence[float],
                           initial: Sequence[float] = None,
                           max_iters: int = 10,
                           tolerance: float = 0.05) -> List[float]:
    """Iterative per-GOP-position lambda-modifier search
    (GuessLambdaModifiers.cpp): adjust each position's lambda modifier
    until its measured bitrate is within `tolerance` of the target,
    using the log-domain secant/proportional update the reference uses
    (bitrate is ~monotone decreasing in lambda).

    encode_fn(modifiers) -> measured per-position bitrates.
    Returns the final modifier list.
    """
    n = len(targets)
    mods = list(initial) if initial is not None else [1.0] * n
    prev = None
    for _ in range(max_iters):
        rates = list(encode_fn(mods))
        ok = all(t <= 0 or abs(r - t) / t <= tolerance
                 for r, t in zip(rates, targets))
        if ok:
            break
        new = []
        for i, (r, t) in enumerate(zip(rates, targets)):
            if t <= 0 or r <= 0:
                new.append(mods[i])
                continue
            if prev is not None and prev[0][i] != mods[i] and \
                    prev[1][i] > 0 and prev[1][i] != r:
                # secant step in (log lambda, log rate)
                dlr = np.log(r) - np.log(prev[1][i])
                dll = np.log(mods[i]) - np.log(prev[0][i])
                slope = dlr / dll if abs(dll) > 1e-9 else -1.0
                if slope >= 0:
                    slope = -1.0
                step = (np.log(t) - np.log(r)) / slope
            else:
                # proportional first step: rate ~ lambda^-1 heuristic
                step = -(np.log(t) - np.log(r))
            step = float(np.clip(step, -1.5, 1.5))
            new.append(float(np.clip(mods[i] * np.exp(step), 0.05, 20.0)))
        prev = (mods, rates)
        mods = new
    return mods


def main(argv=None):
    """CLI: annexb stats / bit-depth conversion."""
    import argparse
    ap = argparse.ArgumentParser(prog="hevc_tpu.apps.utils")
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("annexb", help="Annex-B byte statistics")
    a.add_argument("bitstream")
    c = sub.add_parser("convert", help="YUV bit-depth conversion")
    c.add_argument("-i", required=True)
    c.add_argument("-o", required=True)
    c.add_argument("--width", type=int, required=True)
    c.add_argument("--height", type=int, required=True)
    c.add_argument("--input-bitdepth", type=int, default=8)
    c.add_argument("--output-bitdepth", type=int, default=8)
    c.add_argument("--frames", type=int, default=-1)
    c.add_argument("--skip", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "annexb":
        with open(args.bitstream, "rb") as f:
            stats = annexb_bytecount(f.read())
        for k, st in stats.items():
            print(f"{k}: nal_bytes={st.nal_bytes} "
                  f"start_code={st.start_code_prefix} "
                  f"zero_byte={st.zero_byte} "
                  f"leading_zeros={st.leading_zero_8bits} "
                  f"trailing_zeros={st.trailing_zero_8bits}")
        return 0
    n = convert_bitdepth(args.i, args.o, args.width, args.height,
                         args.input_bitdepth, args.output_bitdepth,
                         args.frames, args.skip)
    print(f"converted {n} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
