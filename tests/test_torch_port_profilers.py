"""The port's profilers (``ops/trace_unet.py``, ``ops/profile_unet.py``,
``ops/profile_motion.py``, ``ops/tune.py``) on the CPU at the tiny config:
each tool's ``main`` with ``--device cpu`` prints its records and the
closing line, and reports no device time; without ``--device`` each refuses
to run on a machine with no card.  ``trace_unet``'s attribution: on the
CPU run every work item is charged to a module and the sums equal the
total; on a synthetic trace in the card's layout (kernels joined to their
CUDA runtime launches by correlation id, nested module ranges) each kernel
goes to the innermost module open at its launch, and one launched outside
every module to the outside bucket.  The categoriser shared with
``tools/profile_step.py``, case by case.  No JAX.
"""

import json

import pytest
import torch

from i2v_adapter_tpu_torch.config import I2VModelConfig, tiny_test_config
from i2v_adapter_tpu_torch.ops import profile_motion, profile_unet, trace_unet, tune
from i2v_adapter_tpu_torch.tools.profile_step import category
from tests.torch_port_common import one_torch_thread  # noqa: F401

SMALL = ["--device", "cpu", "--size", "16", "--frames", "2"]


def _cfg():
    cfg = tiny_test_config()
    return cfg.replace(unet=cfg.unet.replace(flash_static_max=0.0))


def _records(capsys, tool):
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "cpu (plain math, no device times)"
    records = [json.loads(line) for line in lines[:-1]]
    assert records and all(r["tool"] == tool for r in records)
    return records


def test_trace_unet_on_cpu(capsys):
    assert trace_unet.main(SMALL + ["--top", "5"], model_config=_cfg()) == 0
    records = {r["result"]: r for r in _records(capsys, "trace_unet")}
    assert set(records) == {"summary", "by_module_kind", "top_modules", "elementwise"}
    summary = records["summary"]
    assert summary["unit"] == "host_ms" and summary["idle_share"] is None and summary["profiler_kernel_ms"] is None
    assert summary["work_items"] > 100 and summary["int8"]
    total = summary["total_ms"]
    assert total > 0 and summary["module_sum_ms"] == pytest.approx(total)
    assert sum(summary["by_category_ms"].values()) == pytest.approx(total)
    assert sum(records["by_module_kind"]["ms"].values()) == pytest.approx(total)
    # the UNet's own forward runs inside its range: nothing outside
    assert summary["outside_ms"] == 0.0
    kinds = records["by_module_kind"]["ms"]
    assert {"ResnetBlock2D", "Attention", "TemporalSelfAttention", "GroupNorm"} <= set(kinds)
    assert len(records["top_modules"]["ms"]) == 5
    elementwise = records["elementwise"]
    assert sum(elementwise["by_module_kind_ms"].values()) == pytest.approx(elementwise["total_ms"])


def test_attribution_on_a_card_trace():
    """Two nested module ranges on the launching thread; kernels joined to
    their launches by correlation id; a copy launched outside every range;
    a kernel whose launch the trace lacks."""
    prefix = trace_unet.PREFIX
    events = [
        {"ph": "X", "cat": "user_annotation", "name": prefix + "unet", "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": prefix + "unet.block", "tid": 1, "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": prefix + "unet.block.norm", "tid": 1, "ts": 12.0,
         "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "tid": 1, "ts": 0.0, "dur": 300.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 13.0, "dur": 1.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 20.0, "dur": 1.0,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": 60.0, "dur": 1.0,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "tid": 1, "ts": 150.0, "dur": 1.0,
         "args": {"correlation": 10}},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel", "tid": 7, "ts": 200.0,
         "dur": 2000.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_wgmma_kernel", "tid": 7, "ts": 300.0, "dur": 500.0,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "tid": 7, "ts": 900.0, "dur": 250.0,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "tid": 7, "ts": 1200.0, "dur": 50.0,
         "args": {"correlation": 10}},
        {"ph": "X", "cat": "kernel", "name": "reduce_kernel", "tid": 7, "ts": 1300.0, "dur": 25.0,
         "args": {"correlation": 99}},
    ]
    got = trace_unet.attribute({"traceEvents": events}, on_card=True)
    assert got == [("vectorized_elementwise_kernel", 2.0, "unet.block.norm"),
                   ("flash_fwd_wgmma_kernel", 0.5, "unet.block"), ("sm90_xmma_gemm_bf16", 0.25, "unet"),
                   ("Memcpy DtoD", 0.05, trace_unet.OUTSIDE), ("reduce_kernel", 0.025, trace_unet.OUTSIDE)]
    kinds = {"unet": "VideoUNet", "unet.block": "ResnetBlock2D", "unet.block.norm": "GroupNorm"}
    tables = trace_unet.summarise(got, kinds, top=10)
    assert tables["total_ms"] == pytest.approx(2.825) and tables["module_sum_ms"] == pytest.approx(2.825)
    assert tables["outside_ms"] == pytest.approx(0.075)
    assert tables["by_module_kind_ms"] == pytest.approx(
        {"GroupNorm": 2.0, "ResnetBlock2D": 0.5, "VideoUNet": 0.25, trace_unet.OUTSIDE: 0.075})
    assert tables["elementwise_by_module_kind_ms"] == {"GroupNorm": 2.0}
    assert tables["by_category_ms"]["flash_attention (K1)"] == 0.5


@pytest.mark.parametrize("name, want", [
    ("void flash_fwd_wgmma_kernel<64, 40, true>(Params)", "flash_attention (K1)"),
    ("temporal_mma_kernel", "temporal_attention_cs (K2)"),
    ("flash_bwd_dkv_kernel", "flash_attention_bwd (K3)"),
    ("int8_conv3x3_kernel<128>", "int8 3x3 conv"),
    ("int8_quantize_weights_grouped", "int8 weight quantiser"),
    ("int8_mm_wgmma_kernel", "int8_matmul (K7)"),
    ("conv3x3_wgmma_kernel", "conv3x3_kernel (K4)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "convolution"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("void at::native::reduce_kernel<512, 1>", "reduction / norm / softmax"),
    ("void at::native::vectorized_elementwise_kernel<4, silu>", "elementwise / other"),
])
def test_categoriser(name, want):
    assert category(name) == want


def test_profile_unet_on_cpu(capsys):
    assert profile_unet.main(SMALL + ["--evals", "2"], model_config=_cfg()) == 0
    records = _records(capsys, "profile_unet")
    assert [r["variant"] for r in records] == ["full", "no_motion_modules", "no_i2v_adapter", "unet_2d_only",
                                               "convs_only", "resnets_k4", "attention_sdpa"]
    for r in records:
        assert r["per_eval_ms"] is None and r["finite"] and r["shape"] == [2, 2, 8, 8, 4]
        assert set(r["launches_per_eval"].values()) == {0}


def test_profile_unet_sdpa_yardstick_matches_the_plain_attention():
    """The ``attention_sdpa`` variant's swapped entry points compute what
    the model's own attention computes (exact softmax), and are put back."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.models import attention as MA
    from i2v_adapter_tpu_torch.utils.random_init import randomize_

    ucfg = _cfg().unet
    unet = randomize_(VideoUNet(ucfg, device="cpu"), 0).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2, 16, 16, 4, generator=g)  # 256 tokens: the K1 route
    text = torch.randn(2, 7, ucfg.cross_attention_dim, generator=g)
    img = torch.randn(2, ucfg.image_embed_dim, generator=g)
    with torch.no_grad():
        want = unet(x, torch.full((2,), 501.0), text, img, enable_cross_frame_attn=True)
        with profile_unet.sdpa_attention():
            assert MA.dot_product_attention is profile_unet._sdpa_dot_product
            got = unet(x, torch.full((2,), 501.0), text, img, enable_cross_frame_attn=True)
    assert MA.dot_product_attention is not profile_unet._sdpa_dot_product
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_profile_motion_on_cpu(capsys):
    assert profile_motion.main(SMALL + ["--iters", "2", "--decode-slices", "1,2"], model_config=_cfg()) == 0
    records = _records(capsys, "profile_motion")
    cfg = _cfg()
    levels = profile_motion.sites(cfg, 16)
    assert levels == [(8 >> i, c) for i, c in enumerate(cfg.unet.block_out_channels)]
    # SD1.5 at 512 px: the JAX tool's SITES
    assert profile_motion.sites(I2VModelConfig(), 512) == [(64, 320), (32, 640), (16, 1280), (8, 1280)]
    blocks = [r for r in records if r["variant"] != "vae_decode"]
    assert len(blocks) == 7 * len(levels)
    assert all(r["ms"] is None and r["finite"] for r in records)
    decodes = [r for r in records if r["variant"] == "vae_decode"]
    assert [r["decode_slice"] for r in decodes] == [1, 2] and all(r["shape"] == [2, 16, 16, 3] for r in decodes)


def test_tune_on_cpu(capsys):
    assert tune.main(["--device", "cpu"]) == 0
    records = _records(capsys, "tune")
    assert [(r["site"], r["layout"]) for r in records] == [(s[0], lay) for s in tune.SITES for lay in tune.LAYOUTS]
    assert all(r["ok"] and r["k1_launched"] and r["k1_ms"] is None and r["sdpa_ms"] is None for r in records)


@pytest.mark.parametrize("tool", [trace_unet, profile_unet, profile_motion, tune])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Asked for no device, a tool runs on the card and raises without one:
    it never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
