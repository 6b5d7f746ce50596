"""The metrics' arithmetic on hand-worked shapes, the trace's reduction on
made-up events, and the result's line."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchkit import flops, spec as S
from benchkit.peaks import H100_SXM, peaks_for
from benchkit.trace import WINDOW, TraceSummary

H100 = "NVIDIA H100 80GB HBM3"


def test_encoder_flops_by_hand():
    # transformer, L 2, D 4, FFN 8, one layer: a position costs QKV 2*3*16 + logits and
    # values 2*2*2*4 + output 2*16 + FFN 2*2*4*8 = 288; two positions, out_proj 2*16
    t = {"architecture": "transformer", "max_len": 2, "dim": 4, "ffn_dim": 8, "n_layers": 1,
         "n_negatives": 3}
    assert flops.encoder_flops(t) == 608
    # GRU, L 2, D 2, H 3: a step 2*2*9 + 2*3*9 = 90; out_proj 2*3*2
    g = {"architecture": "gru", "max_len": 2, "dim": 2, "hidden": 3, "n_negatives": 1}
    assert flops.encoder_flops(g) == 192
    assert flops.score_flops(g, 10) == 40


def test_published_shapes():
    bench = S.load_spec()
    # SASRec: 2 layers x 20 positions x (3*8192 + 5120 + 8192 + 65536), out_proj 8192
    assert flops.encoder_flops(S.config(bench, "sasrec")) == 4_145_152
    # GRU4Rec: 20 steps x (2*64*384 + 2*128*384) + 2*128*64
    assert flops.encoder_flops(S.config(bench, "gru4rec")) == 2_965_504


class FakeTrace:
    def __init__(self, window_s=1.0, busy_s=0.5, ranges=None, counts=None):
        self.window_s, self.busy_s = window_s, busy_s
        self._ranges, self._counts = ranges or {}, counts or {}

    def device_seconds_in(self, name):
        return self._ranges.get(name)

    def range_count(self, name):
        return self._counts.get(name, 0)


def test_readers_by_hand():
    bench = S.load_spec()
    sas = S.config(bench, "sasrec")
    rd = lambda name: S.load_module("metrics", name).read  # noqa: E731
    ctx = {"config": sas, "device_name": H100, "trace": FakeTrace(2.0, 1.5)}
    assert rd("device_idle_share.serve")(ctx) == pytest.approx(25.0)
    ctx.update(trace=FakeTrace(window_s=0.5, ranges={"bench::topk": 0.002}),
               topk_rows=[4096, 100], model_sessions_traced=4196)
    n, d = sas["n_aids"], 64
    bound = 2 * 4096 * n * d / 989e12 + max(2 * 100 * n * d / 989e12, 2 * n * d / 3.35e12)
    assert rd("topk_roofline_share")(ctx) == pytest.approx(100 * bound / 0.002)
    work = 4196 * (flops.encoder_flops(sas) + 2 * n * d)
    assert rd("serve_mfu")(ctx) == pytest.approx(100 * work / 0.5 / 989e12)
    # an unknown card has no peaks: nothing is read, not a share of the H100's
    ctx["device_name"] = "NVIDIA A100-SXM4-80GB"
    assert rd("serve_mfu")(ctx) is None and rd("topk_roofline_share")(ctx) is None
    assert rd("serve_mfu")({"trace": None, "device_name": H100}) is None


def test_peaks():
    assert peaks_for(H100) is H100_SXM and peaks_for("Tesla T4") is None


class Ev:
    def __init__(self, name, start, dur, tid=1, corr=0, linked=0, dev=False, ann=False):
        self._v = (name, start, dur, tid, corr, linked, dev, ann)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def duration_ns(self): return self._v[2]
    def start_thread_id(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[7]

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._v[6] else d.CPU


def test_trace_reduction():
    events = [
        Ev(WINDOW, 0, 1000, ann=True),
        Ev("bench::topk", 100, 100, ann=True),
        Ev("aten::mm", 110, 50),
        Ev("cudaLaunchKernel", 120, 10, corr=7),
        Ev("cudaLaunchKernel", 300, 10, corr=8),
        Ev("aten::sort", 500, 300),
        Ev("k1", 150, 200, corr=7, linked=3, dev=True),
        Ev("k2", 250, 150, corr=8, linked=7, dev=True),  # overlaps k1
        Ev("k3", 900, 200, corr=99, dev=True),  # runs past the window
        Ev(WINDOW, 0, 1000, dev=True, ann=True),  # the range drawn on the device
    ]
    t = TraceSummary(events)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx((400 - 150 + 1000 - 900) / 1e9)
    assert t.device_seconds_in("bench::topk") == pytest.approx(200 / 1e9)  # k1 only
    assert t.device_seconds_in("nothing") is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(200 / 1e9)]
    idle = dict((n, v) for n, v in b["idle_gaps"])
    # gaps: [0, 150) at 75 (no host op), [400, 900) at 650 (aten::sort)
    assert idle == {"host python": pytest.approx(150 / 1e9), "aten::sort": pytest.approx(500 / 1e9)}


def test_result_line_keys_and_order():
    from run import assemble

    res = {"checks": {"model_gap": 0.5, "recency_gap": math.inf}, "failed": 0, "attempted": 12,
           "memory_peak_bytes": 123, "notes": ["note"], "layer": {}}
    out, lines = assemble(res, {"setup_s": {"value": 1.0, "unit": "s"}},
                          {"model_gap": 1.0, "recency_gap": 1e-4}, H100, 1, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is False and out["checks"]["recency_gap"]["value"] == "inf"
    assert out["device"] == {"platform": "gpu", "kind": H100, "count": 1,
                             "memory_peak_bytes": 123}
    assert lines[0] == "note" and lines[-1].startswith("check recency_gap inf limit")
    res["checks"]["recency_gap"] = 0.0
    out, _ = assemble(res, {}, {"model_gap": 1.0, "recency_gap": 1e-4}, H100, 1, True)
    assert out["correct"] is True and "breakdown" not in out
    res["layer"] = {"trace": SimpleNamespace(busy_s=1.0, window_s=2.0,
                                             breakdown=lambda: {"device_ops": []})}
    out, _ = assemble(res, {}, {"model_gap": 1.0}, H100, 1, True)
    assert out["device"]["busy_s"] == 1.0 and list(out)[-1] == "checks"


def test_list_comparisons_by_hand():
    from reference import compare

    # scores 0..9 (std 3.03); the best four are ids 9, 8, 7, 6
    scores = torch.arange(10, dtype=torch.float32)
    unit = float(scores.double().std())
    assert compare.model_gap([[9, 8, 7, 6]], scores) == 0.0
    assert compare.misranked([[9, 8, 7, 6]], scores) == (0, 4)
    # 6 for 7 at rank 2 is one short; reversed, every pair is off
    assert compare.model_gap([[9, 8, 6, 5]], scores) == pytest.approx(1 / unit)
    assert compare.misranked([[9, 8, 6, 7]], scores) == (2, 4)
    assert compare.misranked([[6, 7, 8, 9], [9, 8, 7, 6]], scores) == (4, 8)
    # a repeated or out-of-range id makes the list invalid
    assert compare.model_gap([[9, 9, 7, 6]], scores) == math.inf
    assert compare.misranked([[9, 8, 7, 10]], scores) == (4, 4)
