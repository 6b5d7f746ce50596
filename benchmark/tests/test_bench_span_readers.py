"""The readers of the program's spans on a hand-made trace: two serving
calls on the window's thread, one stray span on another thread, and a
trace from a program that opens no span."""

import pytest
import torch

from benchkit import flops, spec as S
from benchkit.trace import WINDOW, TraceSummary

H100 = "NVIDIA H100 80GB HBM3"
NAMES = ("route_ms.serve", "pack_ms.serve", "encode_roofline_share", "retriever_build_ms.serve")


class Ev:
    def __init__(self, name, start, dur, tid=1, corr=0, dev=False, ann=False):
        self._v = (name, start, dur, tid, corr, dev, ann)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def duration_ns(self): return self._v[2]
    def start_thread_id(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def is_user_annotation(self): return self._v[6]

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._v[5] else d.CPU


def _span(name, start, dur, tid=1):
    return Ev(name, start, dur, tid=tid, ann=True)


def _window(*events):
    return TraceSummary([_span(WINDOW, 0, 100_000), *events])


SPANS = _window(
    _span("otto::serve", 1_000, 40_000), _span("otto::serve", 50_000, 40_000),
    _span("otto::serve.route", 1_000, 5_000), _span("otto::serve.route", 50_000, 3_000),
    _span("otto::sessions.select", 7_000, 2_000), _span("otto::sessions.pack", 9_000, 1_000),
    _span("otto::sessions.pack", 10_000, 500),  # the upload after the pack
    _span("otto::sessions.select", 60_000, 2_000, tid=2),  # another thread: not counted
    _span("otto::encode", 11_000, 9_000),
    Ev("cudaLaunchKernel", 12_000, 100, corr=7), Ev("gemm", 13_000, 4_000, corr=7, dev=True),
    _span("otto::retrieval.build", 21_000, 4_000),
    Ev("cudaLaunchKernel", 22_000, 100, corr=8), Ev("copy", 23_000, 6_000, corr=8, dev=True),
    Ev("cudaLaunchKernel", 30_000, 100, corr=9), Ev("k1", 31_000, 9_000, corr=9, dev=True),
)


def _read(name, trace, sessions=4096):
    cfg = S.config(S.load_spec(), "sasrec")
    return S.load_module("metrics", name).read({"config": cfg, "device_name": H100,
                                                "trace": trace,
                                                "model_sessions_traced": sessions})


def test_span_readers_by_hand():
    assert _read("route_ms.serve", SPANS) == pytest.approx((5_000 + 3_000) / 1e6 / 2)
    assert _read("pack_ms.serve", SPANS) == pytest.approx((2_000 + 1_000 + 500) / 1e6 / 2)
    work = 4096 * flops.encoder_flops(S.config(S.load_spec(), "sasrec"))
    assert _read("encode_roofline_share", SPANS) == pytest.approx(100 * work / 4e-6 / 67e12)
    assert _read("retriever_build_ms.serve", SPANS) == pytest.approx(1e3 * 6e-6 / 2)


def test_span_readers_read_nothing_without_spans():
    # the parent program: no otto:: span, only the benchmark's own ranges
    plain = _window(_span("bench::topk", 1_000, 5_000),
                    Ev("cudaLaunchKernel", 2_000, 100, corr=7),
                    Ev("k1", 3_000, 4_000, corr=7, dev=True))
    assert all(_read(n, plain) is None for n in NAMES)
    assert all(_read(n, None) is None for n in NAMES)
    # no model-route session, or a card without peaks: no encoder share
    assert _read("encode_roofline_share", SPANS, sessions=0) is None
    ctx = {"config": {}, "device_name": "Tesla T4", "trace": SPANS, "model_sessions_traced": 1}
    assert S.load_module("metrics", "encode_roofline_share").read(ctx) is None
