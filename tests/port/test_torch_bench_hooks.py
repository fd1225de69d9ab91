"""PyTorch port, the HM baselines and bench hooks (`pipeline/bench_hooks`):
`read_hm_baseline` reads the port's own cache (timed on the GPU machine's
host), a missing cache or key raises — also in both benchmarks, before
any encode; `measure_hm_baseline` / `measure_hm_ldp_baseline` write and
merge a cache (redirected here to a temporary file, at 64x64, so that the
committed cache is never written); `load_trained_lstm` is the shipped
checkpoint."""

import json
import os

import numpy as np
import pytest

from hevc_tpu.evaltools import hm
from hevc_tpu_torch.pipeline import bench_hooks

from tests.port.torch_threads import one_torch_thread  # noqa: F401

MODELS = os.path.join(os.path.dirname(__file__), "..", "..", "models")
KEYS = ("hm_seconds_per_frame_1080p_ai_qp32",
        "hm_seconds_per_frame_1080p_ldp_qp32")


def test_read_committed_cache():
    path = os.path.join(os.path.dirname(bench_hooks.__file__),
                        "hm_baseline.json")
    assert os.path.abspath(bench_hooks.HM_BASELINE_CACHE) == \
        os.path.abspath(path)
    base = bench_hooks.read_hm_baseline()
    for key in KEYS:
        assert base[key] > 0
        assert bench_hooks.hm_seconds_per_frame(key) == base[key]
    assert base["n_frames"] == 2 and base["ldp_n_frames"] == 4
    assert isinstance(base["host_cpu"], str)


@pytest.mark.parametrize("bench", ["bench_encode_1080p",
                                   "bench_encode_ldp_1080p"])
def test_missing_cache_or_key_raises(tmp_path, monkeypatch, bench):
    path = tmp_path / "hm_baseline.json"
    monkeypatch.setattr(bench_hooks, "HM_BASELINE_CACHE", str(path))
    with pytest.raises(FileNotFoundError):
        bench_hooks.read_hm_baseline()
    with pytest.raises(FileNotFoundError):
        getattr(bench_hooks, bench)()
    path.write_text(json.dumps({"n_frames": 2}))
    with pytest.raises(KeyError, match="measure_hm"):
        bench_hooks.hm_seconds_per_frame(KEYS[0])
    with pytest.raises(KeyError, match="_qp32"):
        getattr(bench_hooks, bench)()


def test_measure_writes_and_merges_a_redirected_cache(tmp_path,
                                                      monkeypatch):
    if not os.path.exists(hm.ENCODER):
        pytest.skip("HM encoder binary missing")
    committed = open(bench_hooks.HM_BASELINE_CACHE).read()
    path = tmp_path / "hm_baseline.json"
    monkeypatch.setattr(bench_hooks, "HM_BASELINE_CACHE", str(path))
    ai = bench_hooks.measure_hm_baseline(n_frames=2, force=True, width=64,
                                         height=64)
    assert ai["hm_seconds_per_frame_64p_ai_qp32"] > 0
    assert ai["n_frames"] == 2
    assert json.loads(path.read_text()) == ai
    # not forced: read back, no encode
    assert bench_hooks.measure_hm_baseline(width=64, height=64) == ai
    both = bench_hooks.measure_hm_ldp_baseline(n_frames=4, force=True,
                                               width=64, height=64)
    assert both["hm_seconds_per_frame_64p_ldp_qp32"] > 0
    assert both["ldp_n_frames"] == 4
    assert both["hm_seconds_per_frame_64p_ai_qp32"] == \
        ai["hm_seconds_per_frame_64p_ai_qp32"]
    assert bench_hooks.read_hm_baseline() == both
    monkeypatch.undo()
    assert open(bench_hooks.HM_BASELINE_CACHE).read() == committed


def test_load_trained_lstm_is_the_shipped_checkpoint(tmp_path,
                                                     monkeypatch):
    got = bench_hooks.load_trained_lstm(32)
    with np.load(os.path.join(MODELS, "eth_lstm_qp30~35.npz")) as z:
        assert sorted(got) == sorted(z.files)
        for k in z.files:
            np.testing.assert_array_equal(got[k], z[k])
    other = bench_hooks.load_trained_lstm(22)        # the qp20~25 band
    assert other.keys() == got.keys()
    assert any(not np.array_equal(other[k], got[k]) for k in got)
    monkeypatch.setattr(bench_hooks, "_MODELS", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        bench_hooks.load_trained_lstm(32)
