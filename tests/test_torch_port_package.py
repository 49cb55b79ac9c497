"""Rules of the PyTorch port package, checked on the CPU.

* the config tree equals the JAX package's (defaults, tiny, validation);
* no module of the port (nor chip_smoke.py) imports jax, flax or the JAX
  package, and the port calls no SDPA and no torch.compile;
* entry points default to CUDA and raise without it unless device="cpu";
* kernel wrappers take their plain versions on CPU tensors and count no
  launch; the weight carrier is strict;
* chip_smoke.py fails without a card and alone, and its CPU rehearsal runs.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "i2v_adapter_tpu_torch"


@pytest.mark.parametrize("name", ["I2VModelConfig", "PipelineConfig", "tiny_test_config"])
def test_config_tree_matches_jax(name):
    assert getattr(pconfig, name)().to_dict() == getattr(jconfig, name)().to_dict()


@pytest.mark.parametrize("cls,kwargs", [
    ("VideoUNetConfig", dict(ip_variant="bogus")),
    ("VideoUNetConfig", dict(down_block_has_attention=(True,))),
    ("PipelineConfig", dict(frame_similarity_sample_ratio=0.0)),
    ("PipelineConfig", dict(cfg_cutoff=1.5)),
])
def test_config_validation_matches_jax(cls, kwargs):
    for mod in (pconfig, jconfig):
        with pytest.raises(ValueError):
            getattr(mod, cls)(**kwargs)


def test_config_json_round_trip():
    cfg = pconfig.tiny_test_config()
    assert pconfig.I2VModelConfig.from_dict(cfg.to_dict()) == cfg


def _package_sources():
    """The package's .py files, not what was built or unpacked under build/."""
    return sorted(p for p in PKG.rglob("*.py") if "build" not in p.relative_to(PKG).parts)


def _port_sources():
    return _package_sources() + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "i2v_adapter_tpu"), f"{path.name} imports {mod}"


def test_port_uses_no_library_attention_or_compile():
    for path in _package_sources():
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


def test_kernel_sources_present():
    for name in ("flash_attention", "flash_attention_bwd", "temporal_attention"):
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        assert "Replaces: i2v_adapter_tpu/ops/attention.py::" in src
        assert "What bounds it here" in src


@pytest.mark.parametrize("build", [
    lambda: resolve_device(None),
    lambda: VideoUNet(pconfig.tiny_test_config().unet),
    lambda: AutoencoderKL(pconfig.tiny_test_config().vae),
    lambda: CLIPTextEncoder(pconfig.tiny_test_config().text_encoder),
    lambda: CLIPVisionEncoder(pconfig.tiny_test_config().image_encoder),
    lambda: I2VAdapterPipeline(pconfig.tiny_test_config(), {}, None,
                               pconfig.PipelineConfig(int8_conv=False)),
], ids=["resolve_device", "VideoUNet", "AutoencoderKL", "CLIPText", "CLIPVision", "pipeline"])
def test_entry_points_need_cuda_unless_cpu(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_explicit_cpu_device_works():
    unet = VideoUNet(pconfig.tiny_test_config().unet, device="cpu")
    assert next(unet.parameters()).device.type == "cpu"


def test_pipeline_refuses_int8_conv():
    with pytest.raises(NotImplementedError, match="int8"):
        I2VAdapterPipeline(pconfig.tiny_test_config(), {}, None, pconfig.PipelineConfig(), device="cpu")


def test_wrappers_take_plain_path_on_cpu():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 130, 2, 8, generator=g) for _ in range(3))
    A.reset_launch_counts()
    got = A.flash_attention(q, k[:2], v[:2], kv_repeat=2)
    want = A.xla_attention(q, k[:2], v[:2], kv_repeat=2)
    torch.testing.assert_close(got, want)
    x = torch.randn(2, 4, 130, 16, generator=g)
    torch.testing.assert_close(A.temporal_attention_cs(x, x, x, 2), A.temporal_attention_plain(x, x, x, 2))
    assert A.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                 "temporal_attention_cs": 0}


def _tiny_text_params():
    cfg = pconfig.tiny_test_config().text_encoder
    m = CLIPTextEncoder(cfg, device="cpu")
    tree = {}
    for name, p in m.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if leaf == "weight" and p.ndim == 2 and path and path[-1] != "token_embedding":
            node["kernel"] = p.detach().numpy().T
        elif leaf == "weight" and path and path[-1] == "token_embedding":
            node["embedding"] = p.detach().numpy()
        elif leaf == "weight":
            node["scale"] = p.detach().numpy()
        else:
            node[leaf] = p.detach().numpy()
    return cfg, tree


def test_load_flax_params_round_trip_and_strictness():
    cfg, tree = _tiny_text_params()
    target = CLIPTextEncoder(cfg, device="cpu")
    load_flax_params(target, {"params": tree})
    ids = torch.arange(16)[None]
    src = CLIPTextEncoder(cfg, device="cpu")
    load_flax_params(src, tree)
    torch.testing.assert_close(target(ids), src(ids))

    missing = {k: v for k, v in tree.items() if k != "final_layer_norm"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(CLIPTextEncoder(cfg, device="cpu"), missing)
    extra = dict(tree, bogus={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_flax_params(CLIPTextEncoder(cfg, device="cpu"), extra)
    bad = dict(tree, final_layer_norm={"scale": np.ones(3, np.float32),
                                       "bias": np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(CLIPTextEncoder(cfg, device="cpu"), bad)


def test_launch_count_derivation_matches_the_model(monkeypatch):
    """chip_smoke's per-eval launch counts equal the wrapper calls of a
    real (tiny) UNet evaluation under the auto dispatch."""
    calls = {"flash": 0, "temporal": 0}
    flash, temporal = A.flash_attention, A.temporal_attention_cs

    def count_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def count_temporal(*a, **k):
        calls["temporal"] += 1
        return temporal(*a, **k)

    monkeypatch.setattr(A, "flash_attention", count_flash)
    monkeypatch.setattr(A, "temporal_attention_cs", count_temporal)
    ucfg = pconfig.tiny_test_config().unet
    unet = VideoUNet(ucfg, device="cpu")
    with torch.no_grad():
        unet(torch.zeros(2, 3, 16, 16, 4), 10.0, torch.zeros(2, 5, 16), torch.zeros(2, 8),
             enable_cross_frame_attn=True)
    assert (calls["flash"], calls["temporal"]) == chip_smoke.launches_per_unet_eval(ucfg, 16, True)
    assert chip_smoke.launches_per_unet_eval(pconfig.VideoUNetConfig(), 64, True) == (30, 30)


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"], cwd=tmp_path,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_rehearsal_runs(capsys):
    assert chip_smoke.main(["--rehearse"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == '{"ok": true, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}'
