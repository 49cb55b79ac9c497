"""The readers of the program's spans and counters (``metrics/*.py`` over
``i2v_adapter_tpu_torch.utils.tracing``): nothing to read gives None; a
``--trace 1`` rehearsal of each cell gives a value.  The CPU path has no
``empty_cache`` span and no device allocator: those two readers are held
to a ring written by hand, and the decode's allocation counter is planted
in the rehearsal."""

import pytest

from portbench import run
from portbench.tests.common import run_in_process

SERVE_SPANS = ("inputs_ms.serve", "empty_cache_ms.serve", "finish_ms.serve", "decode_allocs.serve")
TRAIN_SPANS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train")


@pytest.fixture
def tracing():
    from i2v_adapter_tpu_torch.utils import tracing

    tracing.clear()
    yield tracing
    tracing.enable(False)
    tracing.clear()


@pytest.mark.parametrize("name", SERVE_SPANS + TRAIN_SPANS)
def test_no_spans_no_value(tracing, name):
    assert run.reader(name)({"requests": [{}]}) is None


def _request(tracing, allocs, detail=False):
    tracing.enable(detail)
    with tracing.span("request"):
        for name in ("inputs", "prep", "empty_cache", "decode", "finish"):
            with tracing.span(name) as s:
                pass
            if name == "decode":
                s.counters["num_device_alloc"] = allocs


def test_serving_readers_skip_the_warm_up_and_the_profiled_request(tracing):
    for allocs, detail in ((99, False), (4, False), (6, False), (99, True)):
        _request(tracing, allocs, detail)
    ctx = {"requests": [{}, {}]}
    assert run.reader("decode_allocs.serve")(ctx) == 5.0
    for name in SERVE_SPANS[:3]:
        assert run.reader(name)(ctx) > 0
    assert run.reader("inputs_ms.serve")({"requests": [{}]}) is None  # a request the ring lacks
    tracing.roots("request")[2].find("empty_cache")[0].name = "other"
    assert run.reader("empty_cache_ms.serve")(ctx) is None  # a request without the span


def test_training_readers_average_the_window_after_the_warm_up_cycle(tracing):
    def micro_step(forward_ms, update, detail=False):
        tracing.enable(detail)
        with tracing.span("micro_step", update=update):
            for name in ("draws", "conditioning", "forward", "backward", "optimizer"):
                with tracing.span(name) as s:
                    pass
                s._device_ms = forward_ms if name == "forward" else 1.0

    # a cycle of two: the warm-up cycle, two window cycles, the profiled one
    for ms, update in ((99, False), (99, True), (2, False), (4, True), (6, False), (8, True)):
        micro_step(ms, update)
    micro_step(99, False, detail=True)
    assert run.reader("forward_ms.train")({}) == 5.0
    assert run.reader("optimizer_ms.train")({}) == run.reader("backward_ms.train")({}) == 1.0
    tracing.roots("micro_step")[3].find("forward")[0]._device_ms = None  # not timed (yet)
    assert run.reader("forward_ms.train")({}) is None


def test_rehearsals_read_every_new_metric(tracing, capsys, monkeypatch):
    real = tracing._counters
    seen = []

    def planted(groups):  # the CPU has no device allocator: count decodes instead
        out = real(groups)
        if "alloc" in groups:
            seen.append(1)
            out["num_device_alloc"] = len(seen)
        return out

    monkeypatch.setattr(tracing, "_counters", planted)
    metrics = run_in_process("serve256_clip", capsys, trace=1)["metrics"]
    assert {"inputs_ms.serve", "finish_ms.serve", "decode_allocs.serve"} <= set(metrics)
    assert metrics["decode_allocs.serve"]["value"] == 1.0
    assert "empty_cache_ms.serve" not in metrics  # no empty_cache() on the CPU
    tracing.clear()
    metrics = run_in_process("train256_b8", capsys, trace=1)["metrics"]
    assert set(TRAIN_SPANS) <= set(metrics) and all(metrics[n]["value"] > 0 for n in TRAIN_SPANS)
