"""The collective audit of serving and training over a mesh (the JAX
package's ``parallel/audit.py``).

The JAX audit compiles the sharded step and parses the collectives GSPMD
put into its HLO.  The port states its collectives itself, so it counts
them: ``parallel.collectives.recording()`` around one denoise step or
train step gives a ``CollectiveOp`` per call (a train step's backward
calls included), ``summarize`` aggregates them in the JAX audit's shape
(count, output bytes and the ring model's wire bytes per device, per kind;
on the cards also the measured ms), and ``collectives_per_unet_eval`` /
``collectives_per_decode`` / ``collectives_per_train_step`` say from the
config (and, for a train step, the state's placement) what the count must
be.
"""

from __future__ import annotations

from typing import Dict, Sequence

# the JAX audit's kind names, and the adjoints' (parallel.collectives)
ALL_GATHER, ALL_TO_ALL, ALL_REDUCE, BROADCAST = "all-gather", "all-to-all", "all-reduce", "collective-broadcast"
REDUCE_SCATTER, REDUCE = "reduce-scatter", "reduce"
# the backward pass's collective for each forward one
ADJOINT = {ALL_GATHER: REDUCE_SCATTER, ALL_TO_ALL: ALL_TO_ALL, ALL_REDUCE: ALL_REDUCE, BROADCAST: REDUCE}


def wire_bytes(kind: str, out_bytes: int, n: int) -> int:
    """Bytes one rank moves for a collective of ``out_bytes`` output over
    ``n`` ranks under the ring algorithms (the JAX audit's model):
    all-gather receives ``out (n-1)/n``, all-reduce moves ``2 out (n-1)/n``,
    a reduce-scatter (whose output is one block) ``out (n-1)``, all-to-all,
    broadcast and reduce move ``out (n-1)/n``."""
    if n <= 1:
        return 0
    if kind == ALL_REDUCE:
        return int(2 * out_bytes * (n - 1) / n)
    if kind == REDUCE_SCATTER:
        return int(out_bytes * (n - 1))
    return int(out_bytes * (n - 1) / n)


def summarize(ops: Sequence) -> Dict:
    """Counts, output bytes, wire bytes per device and ms, per kind and in
    all; ms is None where the calls were not timed on a card."""
    timed = bool(ops) and all(op.ms is not None for op in ops)
    by_kind: Dict[str, Dict] = {}
    total_wire = 0
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "out_bytes": 0, "wire_bytes_per_device": 0,
                                         "ms": 0.0 if timed else None})
        w = op.wire_bytes_per_device()
        d["count"] += 1
        d["out_bytes"] += op.out_bytes
        d["wire_bytes_per_device"] += w
        if timed:
            d["ms"] += op.ms
        total_wire += w
    return {"by_kind": by_kind, "total_ops": len(ops), "wire_bytes_per_device": total_wire,
            "ms": sum(d["ms"] for d in by_kind.values()) if timed else None}


def time_collectives(ops: Sequence, device, iters: int = 10) -> None:
    """Set each recorded op's ``ms``: its collective issued again alone on
    the cards (``collectives.reissue``), ``iters`` calls captured in a CUDA
    graph after two warm-up calls, the graph's replay timed between CUDA
    events, as the replayed step runs them (no host time between calls).
    The replay's first call also waits out the ranks' skew at its start,
    spread over the ``iters`` calls.  Ops of one kind, shape, dtype and
    group are timed once.  Every rank must call this with the same list
    (the ranks' lists name their own groups in the same order)."""
    import torch
    import torch.distributed as dist

    from i2v_adapter_tpu_torch.parallel.collectives import reissue

    timed: dict = {}
    for op in ops:
        key = (op.kind, op.shape, op.dtype, tuple(dist.get_process_group_ranks(op.group)))
        if key not in timed:
            call = reissue(op, device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    call()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(iters):
                    call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            timed[key] = start.elapsed_time(end) / iters
            del graph
        op.ms = timed[key]


def top_ops(ops: Sequence, n: int = 40) -> list:
    """The ``n`` calls that move the most bytes per device."""
    rows = [{"kind": op.kind, "bytes": op.out_bytes, "group": op.group_size, "wire_per_dev": op.wire_bytes_per_device(),
             "shape": list(op.shape), "dtype": op.dtype, "ms": op.ms} for op in ops]
    return sorted(rows, key=lambda r: -r["wire_per_dev"])[:n]


def _add(counts: Dict[str, int], kind: str, n: int) -> None:
    if n:
        counts[kind] = counts.get(kind, 0) + n


def collectives_per_unet_eval(ucfg, mesh_shape: Dict[str, int], rows: int, frames: int, latent: int,
                              cross_frame: bool, int8: bool, cached: bool = False,
                              gather_eps: bool = True) -> Dict[str, int]:
    """The collectives one rank issues for one UNet evaluation of ``rows``
    clips x ``frames`` frames at ``latent`` x ``latent`` latents over a mesh
    of ``mesh_shape`` sizes (``cached``: mid and up only, ``encoder_cache``'s
    second step): clips split over ``data`` where they divide, frames over
    ``seq`` where they divide (what the pipeline decides).

    Per transformer block: a ``to_out`` all-reduce over ``tensor`` per
    attention (attn1, the adapter when cross-frame, attn2) when the heads
    split, the first frame's broadcast over ``seq`` when frames split and
    the adapter runs.  Per motion module with frames split: the GroupNorm's
    two all-reduces, then an all-to-all pair where its tokens split, else an
    all-gather of K and of V per attention (two); its two ``to_out``
    all-reduces when the motion heads split.  Per int8 conv, its scale's
    all-reduce over the evaluation's shards.  At the end the eps gathered
    over each split axis (``gather_eps``; a train step keeps its slab)."""
    d, t, s = mesh_shape["data"], mesh_shape["tensor"], mesh_shape["seq"]
    d_split, s_split = d > 1 and rows % d == 0, s > 1 and frames % s == 0
    tp_spatial = t > 1 and ucfg.num_attention_heads % t == 0
    tp_motion = t > 1 and ucfg.motion_num_attention_heads % t == 0
    adapter = ucfg.use_i2v_adapter and cross_frame
    counts: Dict[str, int] = {}
    n = ucfg.num_blocks

    def site(tokens: int, layers: int, has_attn: bool, motion: bool) -> None:
        if has_attn:
            blocks = layers * ucfg.transformer_layers_per_block
            _add(counts, ALL_REDUCE, blocks * (2 + adapter) * tp_spatial)
            _add(counts, BROADCAST, blocks * (adapter and s_split))
        if motion:
            if s_split:
                _add(counts, ALL_REDUCE, 2 * layers)
                if tokens % s == 0:
                    _add(counts, ALL_TO_ALL, 2 * layers)
                else:
                    _add(counts, ALL_GATHER, 4 * layers)
            _add(counts, ALL_REDUCE, 2 * layers * tp_motion)

    for i in range(0 if cached else n):
        site((latent >> i) ** 2, ucfg.layers_per_block, ucfg.down_block_has_attention[i], ucfg.use_motion_modules)
    site((latent >> (n - 1)) ** 2, 1, True, ucfg.use_motion_modules and ucfg.use_motion_mid_block)
    for i in range(n):
        site((latent >> (n - 1 - i)) ** 2, ucfg.layers_per_block + 1, ucfg.up_block_has_attention[i],
             ucfg.use_motion_modules)
    if int8 and (d_split or s_split):
        resnets = (0 if cached else n * ucfg.layers_per_block) + 2 + n * (ucfg.layers_per_block + 1)
        _add(counts, ALL_REDUCE, 2 * resnets + (n - 1) + (0 if cached else n - 1))
    if gather_eps:
        _add(counts, ALL_GATHER, int(d_split) + int(s_split))
    return counts


def collectives_per_decode(vcfg, mesh_shape: Dict[str, int], frames: int, int8: bool) -> Dict[str, int]:
    """The collectives of one whole decode of ``frames`` frames: split over
    ``data`` x ``seq`` where they divide, one all-reduce per int8 decoder
    conv (the mid block's and up blocks' resnets and the upsamplers) and
    the frames' gather."""
    g = mesh_shape["data"] * mesh_shape["seq"]
    counts: Dict[str, int] = {}
    if g == 1 or frames % g:
        return counts
    if int8:
        blocks = len(vcfg.block_out_channels)
        _add(counts, ALL_REDUCE, 4 + blocks * (vcfg.layers_per_block + 1) * 2 + blocks - 1)
    _add(counts, ALL_GATHER, 1)
    return counts


def collectives_per_train_step(ucfg, mesh_shape: Dict[str, int], tcfg, rows: int, frames: int, latent: int,
                               zero_counts: Dict[str, int] = None) -> Dict[str, int]:
    """The collectives one rank issues for one AdamW train step of ``rows``
    clips x ``frames`` frames (the global batch) at ``latent`` x ``latent``
    latents over a ``(data, fsdp, tensor, seq)`` mesh, the state placed as
    ``zero_counts`` (``Zero.counts``) says:

    * the forward: the UNet's sites as in ``collectives_per_unet_eval``
      (the clips over ``data`` x ``fsdp``, the frames over ``seq``, the
      heads over ``tensor``, no eps gathered), all of them inside the Down
      / Mid / Up blocks, so ``gradient_checkpointing`` issues them again in
      the recompute;
    * the backward: each forward site's adjoint (``ADJOINT``) but for the
      first transformer block's first-frame broadcast, whose input comes
      before any trainable and carries no gradient, and but for the
      row-parallel ``to_out`` all-reduces (identity backward); under
      ``tensor`` an all-reduce per column-parallel input that carries a
      gradient: per transformer block attn1's, the adapter's two (its
      queries' and its first frame's) and attn2's, the first block's attn2
      alone; per motion module its two attentions';
    * ZeRO: a flat all-gather per group of a UNet block's ``fsdp``-split
      weights per block forward (and per recompute), per group of a
      tower's split weights, and a reduce-scatter per trainable group
      (``parallel.zero``);
    * the sums: the trainables' gradients (one flat all-reduce over
      ``data`` x ``seq`` for the ``fsdp`` blocks and one over ``data`` x
      ``fsdp`` x ``seq`` for the rest, each where its group has more than
      one rank and it has leaves), the loss (over ``data`` x ``fsdp`` x
      ``seq``), and the gradient's squared norm over ``fsdp`` and over
      ``tensor`` where blocks are split over them (once: the clip reuses
      the metric's; a step that applies an accumulated gradient, under
      ``gradient_accumulation_steps > 1``, adds the accumulation's norm)."""
    d, f, t, s = (mesh_shape[a] for a in ("data", "fsdp", "tensor", "seq"))
    i2v = tcfg.train_mode == "i2v"
    adapter = i2v and ucfg.use_i2v_adapter
    shape = {"data": d * f, "fsdp": 1, "tensor": t, "seq": s if i2v else 1}
    eval_args = (rows, frames if i2v else 1, latent)
    forward = collectives_per_unet_eval(ucfg, shape, *eval_args, cross_frame=i2v, int8=False, gather_eps=False)
    sites = collectives_per_unet_eval(ucfg, dict(shape, tensor=1), *eval_args, cross_frame=i2v, int8=False,
                                      gather_eps=False)
    counts: Dict[str, int] = {}
    for kind, n in forward.items():
        _add(counts, kind, n * (2 if tcfg.gradient_checkpointing else 1))
    for kind, n in sites.items():  # the row-parallel all-reduces have no adjoint
        first = 1 if (kind == BROADCAST and ucfg.down_block_has_attention[0]) else 0
        _add(counts, ADJOINT[kind], n - first)
    if t > 1:
        n = ucfg.num_blocks
        layers = ([(ucfg.layers_per_block, ucfg.down_block_has_attention[i]) for i in range(n)]
                  + [(1, True)] + [(ucfg.layers_per_block + 1, ucfg.up_block_has_attention[i]) for i in range(n)])
        motion = ([ucfg.use_motion_modules] * n + [ucfg.use_motion_modules and ucfg.use_motion_mid_block]
                  + [ucfg.use_motion_modules] * n)
        blocks = sum(k * ucfg.transformer_layers_per_block for k, attn in layers if attn)
        if ucfg.num_attention_heads % t == 0 and blocks:
            per_block = 2 + 2 * adapter
            _add(counts, ALL_REDUCE, blocks * per_block - (per_block - 1 if adapter else 0))
        if ucfg.motion_num_attention_heads % t == 0:
            _add(counts, ALL_REDUCE, 2 * sum(k for (k, _), m in zip(layers, motion) if m))
    z = zero_counts or {"unit_gathers": 0, "block_gathers": 0, "tower_gathers": 0, "reduce_scatters": 0,
                        "fsdp_trainables": 0, "tensor_trainables": 0, "trainables": 1}
    _add(counts, ALL_GATHER, z["unit_gathers"] + z["tower_gathers"]
         + (z["block_gathers"] if tcfg.gradient_checkpointing else 0))
    _add(counts, REDUCE_SCATTER, z["reduce_scatters"])
    fsdp_blocks, rest = z["fsdp_trainables"] > 0, z["fsdp_trainables"] < z["trainables"]
    tensor_blocks = z.get("tensor_trainables", 0) > 0
    _add(counts, ALL_REDUCE, int(fsdp_blocks and d * s > 1) + int(rest and d * f * s > 1) + int(d * f * s > 1)
         + int(fsdp_blocks and f > 1) + int(tensor_blocks and t > 1))
    return counts
