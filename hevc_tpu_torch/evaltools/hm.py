"""HM-16.5 interop: drive the reference decoder/encoder binaries as
conformance and baseline oracles (tools/hm/, built by
tools/build_hm.sh)."""

from __future__ import annotations

import os
import subprocess

HM_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tools", "hm")
DECODER = os.path.abspath(os.path.join(HM_DIR, "TAppDecoderStatic"))
ENCODER = os.path.abspath(os.path.join(HM_DIR, "TAppEncoderStatic"))


def decoder_available() -> bool:
    return os.path.exists(DECODER)


def decode(bitstream_path: str, rec_path: str, timeout: int = 120):
    """Run the reference decoder; returns (returncode, stdout+stderr)."""
    proc = subprocess.run(
        [DECODER, "-b", bitstream_path, "-o", rec_path],
        capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def decode_bytes(bitstream: bytes, tmpdir: str, timeout: int = 120):
    """Decode an in-memory Annex-B stream; returns (rc, log, rec_path)."""
    bs = os.path.join(tmpdir, "str.bin")
    rec = os.path.join(tmpdir, "rec.yuv")
    with open(bs, "wb") as f:
        f.write(bitstream)
    rc, log = decode(bs, rec, timeout)
    return rc, log, rec
