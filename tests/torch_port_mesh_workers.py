"""Rank workers of ``tests/test_torch_port_mesh.py``.

Each function runs on every rank of a gloo group that
``i2v_adapter_tpu_torch.parallel.launch.run_ranks`` spawned on the CPU.  A
spawned process imports the module that holds its target, so this one
imports no JAX: the test feeds numpy inputs in and holds the results
against the JAX package in its own process.
"""

from __future__ import annotations

import pickle

import torch

from i2v_adapter_tpu_torch.config import MeshConfig
from i2v_adapter_tpu_torch.parallel import collectives
from i2v_adapter_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, create_mesh, gather, shard
from i2v_adapter_tpu_torch.parallel.spmd import attention_spmd

MESHES = {"2,1,2": MeshConfig(data=2, fsdp=1, tensor=1, seq=2), "1,2,2": MeshConfig(data=1, fsdp=1, tensor=2, seq=2)}


def _slab(x: torch.Tensor, mesh, clips: int, frames: int) -> torch.Tensor:
    """This rank's block of a clip-major frame-minor dim 0 (``clips`` x
    ``frames`` rows): clips over data, frames over seq."""
    v = x.reshape((clips, frames) + tuple(x.shape[1:]))
    v = shard(shard(v, 0, mesh, DATA_AXIS), 1, mesh, SEQ_AXIS)
    return v.reshape((-1,) + tuple(x.shape[1:]))


def _unslab(y: torch.Tensor, mesh, clips: int, frames: int) -> torch.Tensor:
    d, s = mesh.size(DATA_AXIS), mesh.size(SEQ_AXIS)
    v = y.reshape((clips // d, frames // s) + tuple(y.shape[1:]))
    v = gather(gather(v, 1, mesh, SEQ_AXIS), 0, mesh, DATA_AXIS)
    return v.reshape((-1,) + tuple(y.shape[1:]))


def _flash_case(mesh, q, k, v, clips: int, frames: int, kv_repeat: int):
    """``spmd_flash_attention`` on this rank's slab (heads over tensor);
    the gathered output."""
    from i2v_adapter_tpu_torch.ops.attention import dot_product_attention
    from i2v_adapter_tpu_torch.parallel.spmd import spmd_flash_attention

    heads = lambda t: shard(t, 2, mesh, TENSOR_AXIS)  # noqa: E731
    ql = heads(_slab(q, mesh, clips, frames))
    if kv_repeat == 1:
        kl, vl = (heads(_slab(t, mesh, clips, frames)) for t in (k, v))
    else:  # one K/V entry per clip, replicated over seq
        kl, vl = (heads(shard(t, 0, mesh, DATA_AXIS)) for t in (k, v))
    with attention_spmd(mesh, frames=frames) as ctx:
        out = spmd_flash_attention(
            lambda a, b, c, r: dot_product_attention(a, b, c, kv_repeat=r, impl="kernel"), ql, kl, vl,
            kv_repeat, ctx)
    return _unslab(gather(out, 2, mesh, TENSOR_AXIS), mesh, clips, frames)


def _temporal_case(mesh, q, k, v, heads: int):
    """``spmd_temporal_attention`` on ``(B, F, S, C)``: token-sharded where
    S splits over seq, else frame-sharded (K/V gathered); C (head-major)
    over tensor."""
    from i2v_adapter_tpu_torch.ops.attention import temporal_attention
    from i2v_adapter_tpu_torch.parallel.spmd import spmd_temporal_attention

    s, t = mesh.size(SEQ_AXIS), mesh.size(TENSOR_AXIS)
    tokens = q.shape[2] % s == 0
    dim = 2 if tokens else 1

    def local(x):
        return shard(shard(shard(x, 0, mesh, DATA_AXIS), dim, mesh, SEQ_AXIS), 3, mesh, TENSOR_AXIS)

    with attention_spmd(mesh, frames=q.shape[1], layout="tokens" if tokens else "frames") as ctx:
        out = spmd_temporal_attention(
            lambda a, b, c, h: temporal_attention(a, b, c, heads=h, impl="kernel"),
            local(q), local(k), local(v), heads // t, ctx)
    return gather(gather(gather(out, 3, mesh, TENSOR_AXIS), dim, mesh, SEQ_AXIS), 0, mesh, DATA_AXIS)


def _motion_norm_case(mesh, x, groups: int, weight, bias):
    """``motion_group_norm`` of ``(B, F, S, C)`` with frames over seq."""
    from i2v_adapter_tpu_torch.parallel.spmd import motion_group_norm

    b, f, n, c = x.shape
    xl = shard(shard(x, 0, mesh, DATA_AXIS), 1, mesh, SEQ_AXIS)
    with attention_spmd(mesh, frames=f):
        y = motion_group_norm(xl.reshape(xl.shape[0], -1, c), groups, 1e-6, weight, bias)
    return gather(gather(y.reshape(xl.shape), 1, mesh, SEQ_AXIS), 0, mesh, DATA_AXIS)


def _conv_case(mesh, x, kernel, bias, clips: int, frames: int):
    """The 3x3 conv (and K4's fused GroupNorm + SiLU + conv) on this rank's
    slab of a (B*F, H, W, C) evaluation, weights whole."""
    from i2v_adapter_tpu_torch.ops.conv3x3 import conv3x3, gn_silu_conv3x3

    xl = _slab(x, mesh, clips, frames)
    a, s = torch.ones(xl.shape[0], x.shape[-1]) * 0.5, torch.full((xl.shape[0], x.shape[-1]), 0.1)
    return (_unslab(conv3x3(xl, kernel, bias), mesh, clips, frames),
            _unslab(gn_silu_conv3x3(xl, a, s, kernel, bias), mesh, clips, frames))


def module_checks(inputs: dict) -> dict:
    """The spmd functions at each mesh of ``MESHES`` on ``inputs`` (numpy);
    every rank returns the gathered outputs."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for name, config in MESHES.items():
        mesh = create_mesh(config, device="cpu")
        out[f"flash_self/{name}"] = _flash_case(mesh, t["q"], t["k"], t["v"], 2, 4, 1)
        out[f"flash_cross/{name}"] = _flash_case(mesh, t["q"], t["k1"], t["v1"], 2, 4, 4)
        out[f"flash_multiclip/{name}"] = _flash_case(mesh, t["qm"], t["km"], t["vm"], 4, 4, 4)
        out[f"temporal_tokens/{name}"] = _temporal_case(mesh, t["tq"], t["tk"], t["tv"], 4)
        out[f"temporal_frames/{name}"] = _temporal_case(mesh, t["fq"], t["fk"], t["fv"], 4)
        out[f"motion_norm/{name}"] = _motion_norm_case(mesh, t["gx"], 8, t["gw"], t["gb"])
        out[f"conv/{name}"], out[f"gn_conv/{name}"] = _conv_case(mesh, t["cx"], t["ck"], t["cb"], 2, 2)
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# the pipeline over the mesh
# ---------------------------------------------------------------------------


def _pipeline(params_path: str, pipe_kwargs: dict, int8: bool):
    import tempfile

    from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer

    with open(params_path, "rb") as f:
        params = pickle.load(f)
    cfg = tiny_test_config()
    cfg = cfg.replace(unet=cfg.unet.replace(flash_static_max=0.0))
    with tempfile.TemporaryDirectory() as tmp:
        tok = make_test_tokenizer(tmp)
    return I2VAdapterPipeline(cfg, params, tok, PipelineConfig(**pipe_kwargs, int8_conv=int8), device="cpu")


def _clip(pipe, inputs: dict, dispatch: str, steps: int, guidance: float):
    """Denoise + decode from fed consts and starting latents, as
    ``tests/test_torch_port_pipeline.py`` drives the parts."""
    b, f, lat = inputs["latents0"].shape[:3]
    size = lat * pipe.config.vae.spatial_scale_factor
    parts = pipe._build_parts(b, f, size, size, steps, 1.0, guidance, True, True)
    consts = tuple(torch.from_numpy(inputs[k]) for k in ("cond_latents", "text_states", "image_embeds"))
    latents = torch.from_numpy(inputs["latents0"])
    with torch.no_grad():
        loop = pipe._denoise if dispatch == "stepwise" else pipe._denoise_scan
        latents = loop(parts, consts, latents, 1, len(parts[3]))
        return parts[2](consts, latents).numpy()


def pipeline_checks(params_path: str, pipe_kwargs: dict, inputs: dict, steps: int, guidance: float) -> dict:
    """The tiny pipeline (exact convs, fp32) over each mesh of ``MESHES``,
    both dispatches, from the fed ``inputs``; then the audit: one step's
    and one decode's collectives recorded at (2,1,2) under int8, with the
    int8 scales of every site teacher-forced."""
    from i2v_adapter_tpu_torch.parallel.audit import summarize

    pipe = _pipeline(params_path, pipe_kwargs, int8=False)
    out = {"unmeshed": _clip(pipe, inputs, "stepwise", steps, guidance)}
    for name, config in MESHES.items():
        pipe.enable_mesh(create_mesh(config, device="cpu"))
        for dispatch in ("stepwise", "scan"):
            out[f"{name}/{dispatch}"] = _clip(pipe, inputs, dispatch, steps, guidance)
        pipe.disable_mesh()
    out["unmeshed_again"] = _clip(pipe, inputs, "stepwise", steps, guidance)
    # 12 frames past the tiny motion cap of 8: anchored windows of 7 + 1
    # frames (split over seq) after a first window of 7 (whole)
    b, _, lat = inputs["latents0"].shape[:3]
    tiled = dict(inputs, latents0=torch.randn((b, 12, lat, lat, 4), generator=torch.Generator().manual_seed(5))
                 .numpy())
    out["tiled/unmeshed"] = _clip(pipe, tiled, "stepwise", steps, guidance)
    pipe.enable_mesh(create_mesh(MESHES["2,1,2"], device="cpu"))
    out["tiled/2,1,2"] = _clip(pipe, tiled, "scan", steps, guidance)
    pipe.disable_mesh()

    pipe = _pipeline(params_path, pipe_kwargs, int8=True)
    out["int8_scales"] = _int8_scales(pipe, inputs, guidance)
    mesh = create_mesh(MESHES["2,1,2"], device="cpu")
    pipe.enable_mesh(mesh)
    b, f, lat = inputs["latents0"].shape[:3]
    size = lat * pipe.config.vae.spatial_scale_factor
    _, step, decode, ts, prev, _ = pipe._build_parts(b, f, size, size, steps, 1.0, guidance, True, True)
    consts = tuple(torch.from_numpy(inputs[k]) for k in ("cond_latents", "text_states", "image_embeds"))
    with torch.no_grad(), collectives.recording() as step_ops:
        latents = step(consts, torch.from_numpy(inputs["latents0"]), ts[0], prev[0])
    with torch.no_grad(), collectives.recording() as decode_ops:
        decode(consts, latents)
    out["audit"] = {"step": summarize(step_ops), "decode": summarize(decode_ops), "mesh": dict(mesh.shape)}
    return out


def _int8_scales(pipe, inputs: dict, guidance: float) -> dict:
    """Every int8 site's activation scale of one unmeshed UNet evaluation
    and one decode, and the same sites' scales on this rank's slab of the
    recorded input inside the (2,1,2) mesh's layout (teacher-forced: each
    site gets the unmeshed input, split): equal bit for bit."""
    from i2v_adapter_tpu_torch.models import layers
    from i2v_adapter_tpu_torch.ops.int8 import activation_scale

    seen = []
    real = layers.int8_conv

    def record(x, *args, **kwargs):
        seen.append(x.detach().clone())
        return real(x, *args, **kwargs)

    b, f, lat = inputs["latents0"].shape[:3]
    size = lat * pipe.config.vae.spatial_scale_factor
    _, step, decode, ts, prev, _ = pipe._build_parts(b, f, size, size, 1, 1.0, guidance, True, True)
    consts = tuple(torch.from_numpy(inputs[k]) for k in ("cond_latents", "text_states", "image_embeds"))
    layers.int8_conv = record
    try:
        with torch.no_grad():
            step(consts, torch.from_numpy(inputs["latents0"]), ts[0], prev[0])
            unet_sites = len(seen)
            decode(consts, torch.from_numpy(inputs["latents0"]))
    finally:
        layers.int8_conv = real
    mesh = create_mesh(MESHES["2,1,2"], device="cpu")
    whole, meshed = [], []
    for i, x in enumerate(seen):
        whole.append(float(activation_scale(x)))
        if i < unet_sites:  # (2 b) x f rows: clips over data, frames over seq
            with attention_spmd(mesh, frames=f):
                meshed.append(float(activation_scale(_slab(x, mesh, 2 * b, f))))
        else:  # the decoder's b x f frames over data x seq
            with attention_spmd(mesh):
                meshed.append(float(activation_scale(shard(x, 0, mesh, (DATA_AXIS, SEQ_AXIS)))))
    return {"whole": whole, "meshed": meshed, "unet_sites": unet_sites}


def all_checks(module_inputs: dict, params_path: str, pipe_kwargs: dict, pipe_inputs: dict, steps: int,
               guidance: float) -> dict:
    """``module_checks`` and ``pipeline_checks`` in one spawn."""
    return {"modules": module_checks(module_inputs),
            **pipeline_checks(params_path, pipe_kwargs, pipe_inputs, steps, guidance)}
