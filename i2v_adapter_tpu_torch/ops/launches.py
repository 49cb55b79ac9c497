"""The kernel wrappers' launch counters, read and moved together.

Each wrapper counts its launches on its own ``launches`` attribute (K1 and
K3 ``attention.flash_attention`` / ``flash_attention_bwd``, K2
``attention.temporal_attention_cs``, K4 ``conv3x3.conv3x3_kernel``, K7
``profile_int8_dense.int8_matmul``, the int8 conv
``int8.int8_conv3x3_kernel``, its weight quantiser ``int8.quantize_weights``
and the GroupNorm kernel ``norms.group_norm_fused``, one count per call of
its two launches).  A CUDA graph records a wrapper's launch once,
at capture, where nothing runs, and runs it at every replay: the scan
dispatch takes a capture's counts back (``restore``) and adds them at each
replay (``add``), so the counts stay the launches that ran: ``capture``
and ``replay`` do both, for the collectives' call count
(``parallel.collectives.calls``, under the key ``"collectives"``) too.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


def _wrappers():
    from i2v_adapter_tpu_torch.ops import attention, conv3x3, int8, norms, profile_int8_dense

    return (attention.flash_attention, attention.flash_attention_bwd, attention.temporal_attention_cs,
            conv3x3.conv3x3_kernel, profile_int8_dense.int8_matmul, int8.int8_conv3x3_kernel,
            int8.quantize_weights, norms.group_norm_fused)


def snapshot() -> Dict[str, int]:
    """Every counted wrapper's launches so far, by wrapper name."""
    return {w.__name__: w.launches for w in _wrappers()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a ``snapshot``)."""
    return {name: n - before[name] for name, n in snapshot().items()}


def reset() -> None:
    for w in _wrappers():
        w.launches = 0


def restore(counts: Dict[str, int]) -> None:
    for w in _wrappers():
        w.launches = counts[w.__name__]


def add(delta: Dict[str, int]) -> None:
    for w in _wrappers():
        w.launches += delta.get(w.__name__, 0)


def capture(body: Callable[[], None], pool=None) -> Tuple["torch.cuda.CUDAGraph", Dict[str, int]]:
    """Capture ``body()`` into a CUDA graph on the current stream (in
    ``pool``, another graph's memory pool, when given); returns the graph
    and the launches it recorded, which are not counted now (nothing ran)
    but at each ``replay``.  A failed capture raises."""
    import torch

    from i2v_adapter_tpu_torch.parallel import collectives

    before, calls = snapshot(), collectives.calls
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool)
    try:
        body()
    finally:
        graph.capture_end()
    counts = dict(since(before), collectives=collectives.calls - calls)
    restore(before)
    collectives.calls = calls
    return graph, counts


def replay(graph: "torch.cuda.CUDAGraph", counts: Dict[str, int]) -> None:
    """Run a captured graph and count its launches (and collectives)."""
    from i2v_adapter_tpu_torch.parallel import collectives

    graph.replay()
    add(counts)
    collectives.calls += counts.get("collectives", 0)
