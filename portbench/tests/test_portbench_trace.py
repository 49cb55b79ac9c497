"""The device-trace arithmetic on synthetic traces: the union of
overlapping kernel intervals, the idle share and its gaps, the families'
time, the categories."""

import pytest

from portbench import readers, trace

SPAN = trace.SPAN_PREFIX + "request"


def chrome(kernels, spans=(), ops=(), op_cat="cpu_op"):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d, "args": {"stream": s}}
              for n, ts, d, s in kernels]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d} for n, ts, d in spans]
    events += [{"ph": "X", "cat": op_cat, "name": n, "ts": ts, "dur": d} for n, ts, d in ops]
    return {"traceEvents": events}


def test_union_merges_overlaps_and_drops_empty():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (8, 8), (6, 9)]) == [(0, 4), (5, 9)]
    assert trace.union([]) == []


def test_busy_counts_overlapping_streams_once():
    # two streams overlap on [20, 30): busy 40 of a 100 us slice
    t = trace.parse(chrome([("gemm_a", 10, 20, 7), ("softmax_b", 20, 20, 13), ("k", 70, 10, 7),
                            ("outside", 150, 10, 7)], spans=[(SPAN, 0, 100)]), "request")
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.wall_s() == pytest.approx(100e-6)
    # the idle share is of an untraced unit's wall time, not of the traced
    # slice's, which the profiler lengthens
    assert readers.idle_pct({"trace": t, "traced_units": 1, "unit_s": 50e-6}) == pytest.approx(20.0)
    assert readers.idle_pct({"trace": t, "traced_units": 1, "unit_s": None}) is None
    # sums of kernel time would have read 60 of 100 (and below 0 with more overlap)
    assert sum(k.dur for k in t.in_slices()) == 50


def test_idle_gaps_longest_first_named_by_span_and_host_op():
    t = trace.parse(chrome([("a", 10, 10, 7), ("b", 50, 10, 7)], spans=[(SPAN, 0, 100)],
                           ops=[("aten::copy_", 60, 40), ("aten::to", 25, 5)]), "request")
    gaps = t.idle_gaps()
    assert [round(g * 1e6) for _, g in gaps] == [40, 30, 10]
    assert gaps[0][0] == "request: aten::copy_" and gaps[1][0] == "request: aten::to"
    assert gaps[2][0] == "request"


def test_device_only_trace_takes_its_extent_and_the_host_wall():
    # a card's trace holds no host operators and no spans: the slice runs
    # from the first recorded event to the last, the wall is the host clock's
    t = trace.parse(chrome([("a", 20, 10, 7), ("b", 60, 10, 7), ("late", 90, 5, 7)],
                           ops=[("cudaLaunchKernel", 10, 2), ("cudaFree", 35, 20)], op_cat="cuda_runtime"),
                    "request", host_wall_s=2e-4)
    assert t.slices == [(10, 95)]
    assert t.wall_s() == pytest.approx(2e-4)
    assert t.busy_s() == pytest.approx(25e-6)
    gaps = t.idle_gaps()
    assert [round(g * 1e6) for _, g in gaps] == [30, 20, 10]
    assert [name for name, _ in gaps] == ["cudaFree", "host work between CUDA calls", "cudaLaunchKernel"]


def test_families_categories_and_step_stream():
    kernels = [("flash_fwd_wgmma_kernel<...>", 0, 4, 9), ("elementwise_kernel", 4, 2, 9),
               ("int8_conv3x3_wgmma_kernel", 6, 3, 9), ("vectorized_elementwise", 20, 5, 7),
               ("reduce_kernel", 25, 1, 7)]
    t = trace.parse(chrome(kernels, spans=[(SPAN, 0, 30)]), "request")
    assert t.family_s(("flash_fwd",)) == pytest.approx(4e-6)
    cats = t.by_category()
    assert cats["flash_attention (K1)"] == pytest.approx(4e-6)
    assert cats["int8 3x3 conv"] == pytest.approx(3e-6)
    assert cats["reduction / norm / softmax"] == pytest.approx(1e-6)
    # the decode's stream (7) holds the last kernel; steps ran on stream 9
    ctx = {"trace": t, "steps": 2, "traced_units": 1}
    assert readers.step_stream_category_ms(ctx, trace.ELEMENTWISE) == pytest.approx(1e3 * 2e-6 / 2)
    assert readers.category_ms(ctx, trace.ELEMENTWISE) == pytest.approx(1e3 * 8e-6)


def test_breakdown_shape():
    t = trace.parse(chrome([("gemm", 0, 5, 7)], spans=[(SPAN, 0, 10)]), "request")
    b = trace.breakdown(t)
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"] == [["matmul", pytest.approx(5e-6)]]
    assert len(b["idle_gaps"]) == 1 and b["idle_gaps"][0][1] == pytest.approx(5e-6)


def test_roofline_share_and_silence():
    from portbench import work

    site = work.Site("attention", bq=1, nq=1024, bkv=1, nk=1024, c=64, module="attn1")
    peaks = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e15, "int8_ops": 2e12}
    t = trace.parse(chrome([("flash_fwd_kernel", 0, 1000, 7)], spans=[(SPAN, 0, 2000)]), "request")
    ctx = {"trace": t, "traced_units": 1, "work": [([site], 2)], "peaks": peaks}
    # 2 launches x 268 MFLOP at 1 TFLOP/s = 537 us of bound in 1000 us
    assert readers.roofline(ctx, "flash_attention") == pytest.approx(100 * 2 * site.ops / 1e12 / 1e-3)
    # a family with no kernel in the trace reads nothing, never 0
    assert readers.roofline(ctx, "temporal_attention") is None
    assert readers.roofline(dict(ctx, trace=None), "flash_attention") is None
