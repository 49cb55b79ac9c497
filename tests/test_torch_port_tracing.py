"""The port's span recorder (``utils.tracing``) at tiny sizes on the CPU:
nesting, root ids and the ring's bound; the phase level's promise (no CUDA
event, no allocator read unless a span asks for it); the serving call's,
the train step's and the daemon job's span trees, and the pipeline's
``last_timings`` / ``last_dispatch`` as views of the request's spans; one
clock with ``torch.profiler``'s exported trace; ``tools/profile_step.py``'s
placement of device gaps under spans.  One case needs a CUDA card.  No JAX.
"""

import json
import time

import numpy as np
import pytest
import torch

from i2v_adapter_tpu_torch import config as C
from i2v_adapter_tpu_torch.pipelines import serve
from i2v_adapter_tpu_torch.tools.profile_step import device_idle
from i2v_adapter_tpu_torch.training import make_train_step
from i2v_adapter_tpu_torch.utils import tracing
from i2v_adapter_tpu_torch.utils.random_init import random_pipeline, random_train_batch, random_train_state

SIZE = 16


@pytest.fixture(autouse=True)
def fresh_ring():
    """An empty ring, detail off, one torch thread (tiny shapes; several
    test workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    tracing.enable(False)
    yield
    tracing.enable(False)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipe():
    pc = C.PipelineConfig(num_frames=2, height=SIZE, width=SIZE, num_inference_steps=4, blur_sigma=1.0,
                          dtype="float32", int8_conv=False)
    return random_pipeline(C.tiny_test_config(), pc, "cpu", seed=3)


def _image(seed=2):
    return np.random.default_rng(seed).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)


def _children(root, parent):
    return [s for s in root.unit if s.parent == parent.id]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_spans_nest_share_their_root_and_the_ring_is_bounded():
    with tracing.span("a") as a:
        with tracing.span("b") as b:
            with tracing.span("c") as c:
                pass
        with tracing.span("d") as d:
            pass
    with tracing.span("e") as e:
        pass
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id, a.id)
    assert a.root == b.root == c.root == d.root == a.id and e.root == e.id != a.id
    assert a.unit == [c, b, d] and b.unit == [c] and a.find("c") == [c] and all(_inside(s, a) for s in a.unit)
    assert tracing.roots("a") == [a] and not a.detail
    with pytest.raises(KeyError):
        with tracing.span("f") as f:
            raise KeyError
    assert not f.ok and list(tracing._ring)[-1] is f
    for i in range(tracing.RING_SPANS + 3):
        with tracing.span("g"):
            pass
    kept = list(tracing._ring)
    assert len(kept) == tracing.RING_SPANS and a not in kept and kept[-1].name == "g"


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1

    def record(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.5


def test_phase_level_makes_no_event_and_reads_the_allocator_only_where_asked(monkeypatch):
    reads = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda *a: reads.append(1) or {"num_device_alloc": len(reads)})
    _Event.made = 0
    with tracing.span("phase") as phase:
        with tracing.span("inner"):
            pass
    assert _Event.made == 0 and not reads and phase.device_ms is None and not phase.counters
    with tracing.span("decode", counters=("alloc",)) as decode:
        pass
    assert _Event.made == 0 and len(reads) == 2
    assert decode.counters == {"num_device_alloc": 1, "num_device_free": 0, "num_alloc_retries": 0}
    with tracing.span("scan_step", device_ms=True) as step:
        pass
    assert _Event.made == 2 and step.device_ms == 1.5
    tracing.enable()
    with tracing.span("detailed") as detailed:
        pass
    assert _Event.made == 4 and len(reads) == 4 and detailed.detail and detailed.device_ms == 1.5


@pytest.mark.parametrize("dispatch", ["scan", "stepwise"])
def test_serving_call_span_tree_and_its_views(pipe, dispatch):
    pipe("a cat", condition_image=_image(), seed=1, dispatch=dispatch)
    (root,) = tracing.roots("request")
    phases = _children(root, root)
    assert [s.name for s in phases] == ["inputs", "prep", "denoise", "decode", "finish"]
    assert all(_inside(s, root) for s in root.unit) and all(s.ok for s in root.unit)
    prep, denoise = phases[1], phases[2]
    assert [s.name for s in _children(root, prep)] == ["text_encoder", "image_encoder", "vae_encode", "prior"]
    steps = root.find("step")
    assert len(steps) == 3 and all(s.parent == denoise.id for s in steps)
    assert [s.start_ns for s in phases] == sorted(s.start_ns for s in phases)
    assert pipe.last_timings == {"prep_ms": prep.ms, "step_ms": [s.ms for s in steps],
                                 "decode_ms": phases[3].ms}
    assert pipe.last_dispatch["dispatch"] == root.attrs["dispatch"] == dispatch
    if dispatch == "scan":
        assert pipe.last_dispatch["capture_ms"] == [] and "graph_cache" in denoise.attrs
    # the phases cover the request: its own time is what lies between them
    assert sum(s.ms for s in phases) <= root.ms < sum(s.ms for s in phases) + 50


def test_train_step_phases():
    mc, tc = C.tiny_test_config(), C.TrainConfig(train_batch_size=1, num_frames=2, resolution=SIZE)
    state = random_train_state(mc, tc, "cpu")
    step_fn = make_train_step(mc, tc, device="cpu")
    step_fn(state, random_train_batch(mc, tc, "cpu"))
    (root,) = tracing.roots("micro_step")
    phases = _children(root, root)
    assert [s.name for s in phases] == ["draws", "conditioning", "forward", "backward", "optimizer"]
    # the phases are timed on the device in every call, detail or not (the
    # host clock stands for the device on the CPU); the root is not
    assert all(_inside(s, root) for s in root.unit) and all(s.device_ms is not None for s in phases)
    assert not root.detail and root.device_ms is None
    assert root.attrs["update"] == (tc.gradient_accumulation_steps <= 1)


def test_a_failed_request_leaves_the_views_of_the_last_one(pipe):
    pipe.last_timings, pipe.last_dispatch = {"step_ms": [1.0]}, {"dispatch": "scan"}
    with pytest.raises(ValueError):
        pipe("a cat", condition_image=_image(), output_type="bogus")
    (root,) = tracing.roots("request")
    assert not root.ok and [s.name for s in root.unit] == ["inputs"]
    assert pipe.last_timings == {"step_ms": [1.0]} and pipe.last_dispatch == {"dispatch": "scan"}


def test_daemon_job_record_carries_its_spans(pipe, tmp_path):
    from PIL import Image

    path = str(tmp_path / "cond.png")
    Image.fromarray(_image(4)).save(path)
    rec = serve.process_request(pipe, {"prompt": "a cat", "image": path, "format": "npy"},
                                str(tmp_path / "job"))
    (job,) = tracing.roots("job")
    assert rec["ok"] and rec["span_root"] == job.id
    assert [s.name for s in _children(job, job)] == ["load", "request", "export"]
    assert {"job", "load", "request", "export", "inputs", "prep", "denoise", "decode", "finish"} <= set(
        rec["spans_ms"])
    assert rec["spans_ms"]["job"] == round(job.ms, 3)
    # the pipeline's views hold inside the job too
    (request,) = job.find("request")
    assert pipe.last_timings["decode_ms"] == request.find("decode")[0].ms and len(pipe.last_timings["step_ms"]) == 3


def test_a_span_and_the_profiler_trace_share_one_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer") as outer:
            time.sleep(0.003)
            with record_function("inner_op"):
                time.sleep(0.002)
            time.sleep(0.003)
    assert outer.detail  # the profiler turns detail on
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    tracing.export_chrome(path, merge=path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("cat") == "program" and e["name"] == "outer"]
    (op,) = [e for e in events if e.get("name") == "inner_op" and e.get("cat") != "program"]
    assert span["args"]["id"] == outer.id
    assert span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]


def test_profile_step_places_device_gaps_under_spans():
    class Part:
        id, name = 1, "part"

    def program(name, sid, ts, dur):
        return {"cat": "program", "name": name, "ts": ts, "dur": dur, "args": {"id": sid, "root": 1}}

    events = [program("part", 1, 0, 100), program("forward", 2, 0, 50), program("backward", 3, 50, 50),
              {"cat": "kernel", "ts": 5, "dur": 35}, {"cat": "kernel", "ts": 45, "dur": 10},
              {"cat": "gpu_memcpy", "ts": 60, "dur": 30}]
    got = device_idle(events, Part)
    assert got["busy_ms"] == pytest.approx(0.075)
    # 0-5 and 40-45 under forward, 55-60 and 90-100 under backward
    assert got["idle_under_ms"] == pytest.approx({"forward": 0.010, "backward": 0.015})
    events[4] = {"cat": "kernel", "ts": 52, "dur": 3}  # the gap 40-52: its middle under forward
    assert device_idle(events, Part)["idle_under_ms"] == pytest.approx({"forward": 0.017, "backward": 0.015})


@pytest.mark.gpu
def test_detail_times_a_kernel_launch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from i2v_adapter_tpu_torch.ops import _build
    from i2v_adapter_tpu_torch.ops import attention as A

    try:
        _build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    dev = torch.device("cuda", 0)
    q, k, v = (torch.randn(2, 1024, 2, 64, device=dev, dtype=torch.bfloat16) for _ in range(3))
    A.flash_attention(q, k, v)  # built and warm
    torch.cuda.synchronize()
    with tracing.span("phase") as phase:
        A.flash_attention(q, k, v)
    tracing.enable()
    with tracing.span("detailed") as detailed:
        A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert phase.device_ms is None and not phase.counters
    assert detailed.counters.get("flash_attention") == 1 and 0 < detailed.device_ms
