"""The benchmark's operation and byte counts against counts made another
way: ``torch.utils.flop_counter`` over the reference modules at a tiny
configuration (shape-only, on the meta device), and hand counts of each
kernel family at small shapes."""

import importlib
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.reference import model as ref_model

HERE = Path(__file__).resolve().parents[1]
TINY = json.loads((HERE / "rehearse.json").read_text())["model"]
SERVE = json.loads((HERE / "configs" / "i2v_sd15_serve.json").read_text())["model"]


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("latent,frames,clips", [(8, 4, 2), (16, 3, 1)])
def test_unet_evaluation_ops_match_flop_counter(latent, frames, clips):
    m = ref_model.build(TINY)
    u = TINY["unet"]
    ctx = TINY["text_encoder"]["max_position_embeddings"]
    fn = lambda: m["unet"](meta(clips, frames, latent, latent, u["in_channels"]), meta(clips),  # noqa: E731
                           meta(clips, ctx, u["cross_attention_dim"]), meta(clips, u["image_embed_dim"]))
    assert work.total_ops(work.unet_sites(u, latent, frames, clips, ctx)) == counted(fn)


def test_vae_and_towers_ops_match_flop_counter():
    m = ref_model.build(TINY)
    v, t, i = TINY["vae"], TINY["text_encoder"], TINY["image_encoder"]
    size, frames = 32, 3
    lat = size // 2 ** (len(v["block_out_channels"]) - 1)
    assert work.total_ops(work.vae_encoder_sites(v, size, frames)) == counted(
        lambda: m["vae"].encode(meta(frames, size, size, 3), meta(frames, lat, lat, v["latent_channels"])))
    assert work.total_ops(work.vae_decoder_sites(v, lat, frames)) == counted(
        lambda: m["vae"].decode(meta(frames, lat, lat, v["latent_channels"])))
    n = t["max_position_embeddings"]
    ids = torch.zeros((2, n), dtype=torch.long, device="meta")
    assert work.total_ops(work.clip_sites(t, 2, n)) == counted(lambda: m["text_encoder"](ids))
    tokens = (i["image_size"] // i["patch_size"]) ** 2 + 1
    assert work.total_ops(work.clip_sites(i, 1, tokens, patch=i["patch_size"], projection=i["projection_dim"])) \
        == counted(lambda: m["image_encoder"](meta(1, i["image_size"], i["image_size"], 3)))


def test_unet_ops_at_full_width():
    """One CFG-doubled 512 px 16-frame evaluation at SD1.5 width: 40.3
    TFLOP, counted shape-only on the meta device; the self-attention
    products at 4096 tokens are 4 x 32 x 4096^2 x 320 each."""
    m = ref_model.build(SERVE)
    u = SERVE["unet"]
    sites = work.unet_sites(u, 64, 16, 2, 77, int8=True)
    fn = lambda: m["unet"](meta(2, 16, 64, 64, 4), meta(2), meta(2, 77, 768), meta(2, u["image_embed_dim"]))  # noqa: E731
    assert work.total_ops(sites) == counted(fn)
    assert 40.29e12 < work.total_ops(sites) < 40.31e12
    attn1 = [s for s in sites if s.module == "attn1" and s.kind == "attention" and s.nk == 4096]
    assert len(attn1) == 5 and attn1[0].ops == 4 * 32 * 4096 * 4096 * 320


def family(name):
    return importlib.import_module(f"portbench.kernels.{name}")


def test_flash_attention_hand_counts():
    k1 = family("flash_attention")
    # 8 frames of 256 tokens, 64 channels: the self-attention and the
    # adapter's attention to the first frame of each of 2 clips
    self_attn = work.Site("attention", bq=8, nq=256, bkv=8, nk=256, c=64, module="attn1")
    adapter = work.Site("attention", bq=8, nq=256, bkv=2, nk=256, c=64, module="i2v_adapter")
    assert k1.work(self_attn) == (4 * 8 * 256 * 256 * 64, 2 * (2 * 8 * 256 * 64 + 2 * 8 * 256 * 64))
    assert k1.work(adapter) == (4 * 8 * 256 * 256 * 64, 2 * (2 * 8 * 256 * 64 + 2 * 2 * 256 * 64))
    # short keys and the temporal, VAE and CLIP products are not K1's
    assert k1.work(work.Site("attention", bq=8, nq=256, bkv=8, nk=77, c=64, module="attn2")) is None
    assert k1.work(work.Site("attention", bq=8, nq=256, bkv=8, nk=256, c=64, module="vae_attn")) is None


def test_flash_attention_bwd_hand_counts():
    k3 = family("flash_attention_bwd")
    site = work.Site("attention_bwd", bq=4, nq=1024, bkv=4, nk=1024, c=40, module="attn1")
    q = 4 * 1024 * 40
    assert k3.work(site) == (8 * 4 * 1024 * 1024 * 40, 2 * 5 * q + 2 * 3 * q)
    assert k3.work(work.Site("attention_bwd", bq=4, nq=256, bkv=4, nk=256, c=40, module="attn1")) is None
    assert k3.work(work.Site("attention", bq=4, nq=1024, bkv=4, nk=1024, c=40, module="attn1")) is None


def test_temporal_attention_hand_counts():
    k2 = family("temporal_attention")
    site = work.Site("attention", bq=2 * 256, nq=16, bkv=2 * 256, nk=16, c=320, axis="temporal", res=16)
    assert k2.work(site) == (4 * 512 * 16 * 16 * 320, 2 * 4 * 512 * 16 * 320)
    assert k2.work(work.Site("attention", bq=2 * 64, nq=16, bkv=2 * 64, nk=16, c=320, axis="temporal",
                             res=8)) is None


def test_int8_families_hand_counts():
    conv, mm = family("int8_conv"), family("int8_matmul")
    # 32 frames of 16 x 16 pixels, 64 -> 128 channels
    site = work.Site("conv", m=32 * 256, k=9 * 64, n=128, int8=True, stride=1)
    assert conv.work(site) == (2 * 32 * 256 * 576 * 128, 2 * 32 * 256 * 64 + 576 * 128 + 2 * 32 * 256 * 128)
    assert mm.work(site) is None
    down = work.Site("conv", m=32 * 64, k=9 * 64, n=64, int8=True, stride=2)
    assert mm.work(down) == (2 * 32 * 64 * 576 * 64, 32 * 64 * 576 + 576 * 64 + 2 * 32 * 64 * 64)
    assert conv.work(work.Site("conv", m=10, k=9, n=4)) is None


def test_serving_launches_match_the_programs_tables():
    """The frozen launch tables at SD1.5 width: K1 and K2 30 a 512 px
    evaluation, 20 at 256 px; the int8 conv 47 an evaluation and 31 a
    decode; K7 3 an evaluation (``PERF.md``, the kernels table)."""
    for latent, attn in ((64, 30), (32, 20)):
        parts = work.serve_request_sites(SERVE, {"height": latent * 8, "width": latent * 8, "frames": 16,
                                                 "int8": True})
        n = lambda name, part: sum(family(name).work(s) is not None for s in parts[part])  # noqa: E731
        assert n("flash_attention", "step") == attn and n("temporal_attention", "step") == attn
        assert n("int8_conv", "step") == 47 and n("int8_conv", "decode") == 31
        assert n("int8_matmul", "step") == 3 and n("int8_matmul", "decode") == 0


def test_training_backward_sites():
    """K3 runs at the 1024-key sites after the first adapter: 9 at 256 px
    (the first block's self-attention has no gradient), as the program's
    ``launches_per_train_step`` counts."""
    fwd = work.unet_sites(SERVE["unet"], 32, 16, 8, 77)
    bwd = work.backward(fwd, ("i2v_adapter_q", "i2v_adapter_out"))
    assert sum(family("flash_attention_bwd").work(s) is not None for s in bwd) == 9
    wgrad = [s for s in bwd if s.module.startswith("wgrad:")]
    assert len(wgrad) == 2 * 16  # to_q and to_out of the 16 transformer blocks
    assert not any(s.module.endswith("attn2_ctx") for s in bwd)
