"""The work one Stable Video Diffusion request needs, from the published
shapes (``configs/svd_xt_serve.json``): every matmul, convolution and
attention product of the CLIP image tower, the VAE encode of the condition
image, one CFG-doubled UNet evaluation (a request makes ``steps`` of them)
and the temporal decode, as ``work.Site`` records (an operation is a
multiply or an add).  Latents need not be square: a level's sites carry
its height and width.  Norms, activations, the blends and the Euler update
are not counted.  The cross-attention to the one image token counts what
its function needs: the value and output projections of the token.

Site conventions beside ``work.py``'s: the (3, 1, 1) frame convolutions are
``conv`` sites with ``k = 3 Cin`` (``module="temporal_conv"``); the frame
attention is an ``attention`` site with ``axis="temporal"``, ``bq = B S``
rows of ``nq = F`` frames, and ``m`` holding S, the positions per frame
(``kernels/temporal_attention_svd.py`` selects by it).
"""

from __future__ import annotations

from typing import Dict, List

from portbench import work
from portbench.work import Site


def _lin(m, k, n, module):
    return Site("linear", m=m, k=k, n=n, module=module)


def _conv(pixels, cin, cout, ksize=3, stride=1, module=""):
    return Site("conv", m=pixels, k=ksize * ksize * cin, n=cout, stride=stride, module=module)


def _resnet(sites, images, px, cin, cout, temb):
    sites.append(_conv(images * px, cin, cout, module="resnet"))
    if temb:
        sites.append(_lin(images, temb, cout, "resnet"))
    sites.append(_conv(images * px, cout, cout, module="resnet"))
    if cin != cout:
        sites.append(_conv(images * px, cin, cout, ksize=1, module="resnet"))


def _st_resnet(sites, images, px, cin, cout, temb):
    """A spatial resnet per frame and the temporal resnet over the clip."""
    _resnet(sites, images, px, cin, cout, temb)
    sites += [Site("conv", m=images * px, k=3 * cout, n=cout, module="temporal_conv")] * 2
    if temb:
        sites.append(_lin(images, temb, cout, "temporal_resnet"))


def _transformer(sites, clips, frames, px, ch, ctx_dim):
    t, n = clips * frames, px
    sites += [_lin(t * n, ch, ch, "proj")] * 2 + [_lin(frames, ch, 4 * ch, "pos"), _lin(frames, 4 * ch, ch, "pos")]
    sites += [_lin(t * n, ch, ch, "attn1")] * 4
    sites.append(Site("attention", bq=t, nq=n, bkv=t, nk=n, c=ch, axis="spatial", module="attn1"))
    sites += [_lin(t, ctx_dim, ch, "attn2"), _lin(t, ch, ch, "attn2")]
    sites += [_lin(t * n, ch, 8 * ch, "ff"), _lin(t * n, 4 * ch, ch, "ff")]
    sites += [_lin(t * n, ch, 8 * ch, "temporal_ff"), _lin(t * n, 4 * ch, ch, "temporal_ff")] * 2
    sites += [_lin(t * n, ch, ch, "temporal_attn1")] * 4
    sites.append(Site("attention", m=n, bq=clips * n, nq=frames, bkv=clips * n, nk=frames, c=ch, axis="temporal",
                      module="temporal_attn1"))
    sites += [_lin(clips, ctx_dim, ch, "temporal_attn2"), _lin(clips, ch, ch, "temporal_attn2")]


def unet_sites(ucfg: dict, h: int, w: int, frames: int, clips: int) -> List[Site]:
    """One evaluation of ``clips`` clips of ``frames`` frames on ``h`` x
    ``w`` latents."""
    ch, n, layers = ucfg["block_out_channels"], len(ucfg["block_out_channels"]), ucfg["layers_per_block"]
    t, temb, ctx = clips * frames, ch[0] * 4, ucfg["cross_attention_dim"]
    sites = [_lin(clips, ch[0], temb, "time"), _lin(clips, temb, temb, "time"),
             _lin(clips, ucfg["projection_class_embeddings_input_dim"], temb, "time"), _lin(clips, temb, temb, "time"),
             _conv(t * h * w, ucfg["in_channels"], ch[0], module="conv_in")]
    skips, cin = [ch[0]], ch[0]
    for i in range(n):
        px = (h >> i) * (w >> i)
        for _ in range(layers):
            _st_resnet(sites, t, px, cin, ch[i], temb)
            cin = ch[i]
            if ucfg["down_block_has_attention"][i]:
                _transformer(sites, clips, frames, px, ch[i], ctx)
            skips.append(ch[i])
        if i < n - 1:
            sites.append(_conv(t * (h >> (i + 1)) * (w >> (i + 1)), ch[i], ch[i], stride=2, module="down"))
            skips.append(ch[i])
    px = (h >> (n - 1)) * (w >> (n - 1))
    _st_resnet(sites, t, px, ch[-1], ch[-1], temb)
    _transformer(sites, clips, frames, px, ch[-1], ctx)
    _st_resnet(sites, t, px, ch[-1], ch[-1], temb)
    x_ch = ch[-1]
    for i, out in enumerate(reversed(ch)):
        level = n - 1 - i
        px = (h >> level) * (w >> level)
        for _ in range(layers + 1):
            _st_resnet(sites, t, px, x_ch + skips.pop(), out, temb)
            x_ch = out
            if ucfg["up_block_has_attention"][i]:
                _transformer(sites, clips, frames, px, out, ctx)
        if i < n - 1:
            sites.append(_conv(t * (h >> (level - 1)) * (w >> (level - 1)), out, out, module="up"))
    sites.append(_conv(t * h * w, ch[0], ucfg["out_channels"], module="conv_out"))
    return sites


def _vae_mid(sites, images, px, c, temporal):
    (_st_resnet if temporal else _resnet)(sites, images, px, c, c, 0)
    sites += [_lin(images * px, c, c, "vae_attn")] * 4
    sites.append(Site("attention", bq=images, nq=px, bkv=images, nk=px, c=c, axis="spatial", module="vae_attn"))
    (_st_resnet if temporal else _resnet)(sites, images, px, c, c, 0)


def encoder_sites(vcfg: dict, height: int, width: int) -> List[Site]:
    """The VAE encode of one ``height`` x ``width`` image (quant conv
    included)."""
    ch, g = vcfg["block_out_channels"], vcfg["layers_per_block"]
    sites = [_conv(height * width, vcfg["in_channels"], ch[0], module="conv_in")]
    cin, h, w = ch[0], height, width
    for i, c in enumerate(ch):
        for _ in range(g):
            _resnet(sites, 1, h * w, cin, c, 0)
            cin = c
        if i < len(ch) - 1:
            h, w = h // 2, w // 2
            sites.append(_conv(h * w, c, c, stride=2, module="down"))
    _vae_mid(sites, 1, h * w, ch[-1], False)
    lc2 = 2 * vcfg["latent_channels"]
    return sites + [_conv(h * w, ch[-1], lc2, module="conv_out"), _conv(h * w, lc2, lc2, ksize=1, module="quant")]


def decoder_sites(vcfg: dict, h: int, w: int, frames: int) -> List[Site]:
    """The temporal decode of ``frames`` latents of ``h`` x ``w`` (one
    chunk: the frames decode together)."""
    rev, g = tuple(reversed(vcfg["block_out_channels"])), vcfg["layers_per_block"]
    sites = [_conv(frames * h * w, vcfg["latent_channels"], rev[0], module="conv_in")]
    _vae_mid(sites, frames, h * w, rev[0], True)
    cin = rev[0]
    for i, c in enumerate(rev):
        px = (h << i) * (w << i)
        for _ in range(g + 1):
            _st_resnet(sites, frames, px, cin, c, 0)
            cin = c
        if i < len(rev) - 1:
            sites.append(_conv(frames * 4 * px, c, c, module="up"))
    px = (h << (len(rev) - 1)) * (w << (len(rev) - 1))
    out = vcfg["out_channels"]
    return sites + [_conv(frames * px, rev[-1], out, module="conv_out"),
                    Site("conv", m=frames * px, k=3 * out, n=out, module="temporal_conv")]


def request_work(model_cfg: dict, traffic: dict) -> list:
    """``[(sites, count)]`` of one request: the prep once, the UNet
    evaluation per step, each decode chunk once."""
    vcfg, icfg = model_cfg["vae"], model_cfg["image_encoder"]
    sf = 2 ** (len(vcfg["block_out_channels"]) - 1)
    h, w, frames = traffic["height"] // sf, traffic["width"] // sf, traffic["frames"]
    prep = work.clip_sites(icfg, 1, (icfg["image_size"] // icfg["patch_size"]) ** 2 + 1, patch=icfg["patch_size"],
                           projection=icfg["projection_dim"])
    prep += encoder_sites(vcfg, traffic["height"], traffic["width"])
    chunks: Dict[int, int] = {}
    for i in range(0, frames, traffic["decode_chunk"]):
        n = min(traffic["decode_chunk"], frames - i)
        chunks[n] = chunks.get(n, 0) + 1
    return [(prep, 1), (unet_sites(model_cfg["unet"], h, w, frames, 2), traffic["steps"])] + \
        [(decoder_sites(vcfg, h, w, n), count) for n, count in sorted(chunks.items())]
