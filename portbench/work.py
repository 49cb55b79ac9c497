"""The work the model needs, computed from the configuration's shapes.

The benchmark's own frozen copy of the program's launch tables
(``chip_smoke.py``: ``launches_per_unet_eval``, ``_resnet_conv_sites``,
``int8_unet_sites``, ``int8_downsample_sites``, ``int8_decoder_sites``,
``launches_per_train_step``) and of the operation counts behind its
``bound_ms``, so that a later change to the program cannot move the
yardstick.  An operation is a multiply or an add: a matmul of (M, K) by
(K, N) is 2 M K N.  Only matmuls, convolutions and attention products are
counted; norms, activations and the DDIM update are not.

``unet_sites`` walks one VideoUNet evaluation and returns every product
with its shape; the kernel families (``kernels/*.py``) select their sites
from it, and ``total_ops`` sums it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class Site:
    """One product of an evaluation.  ``kind``: ``linear`` (M, K, N),
    ``conv`` (M output pixels, K = kh kw Cin, N = Cout, ``int8`` when the
    serving default runs it in int8, ``stride``), ``attention`` (``bq``
    query rows of ``nq`` tokens against ``bkv`` key rows of ``nk`` tokens,
    ``c`` channels; ``spatial`` or ``temporal``)."""

    kind: str
    m: int = 0
    k: int = 0
    n: int = 0
    int8: bool = False
    stride: int = 1
    bq: int = 0
    nq: int = 0
    bkv: int = 0
    nk: int = 0
    c: int = 0
    axis: str = ""
    res: int = 0
    module: str = ""

    @property
    def ops(self) -> int:
        if self.kind == "attention":
            return 4 * self.bq * self.nq * self.nk * self.c
        if self.kind == "attention_bwd":  # dV, dP, dQ, dK from the saved probabilities
            return 8 * self.bq * self.nq * self.nk * self.c
        return 2 * self.m * self.k * self.n


def _linear(m, k, n, module=""):
    return Site("linear", m=m, k=k, n=n, module=module)


def _conv(pixels, cin, cout, ksize=3, int8=False, stride=1, res=0, module=""):
    return Site("conv", m=pixels, k=ksize * ksize * cin, n=cout, int8=int8, stride=stride, res=res,
                module=module)


def _resnet(sites, t, r, cin, cout, temb, int8):
    sites.append(_conv(t * r * r, cin, cout, int8=int8, res=r, module="resnet"))
    if temb:
        sites.append(_linear(t, temb, cout, "resnet"))
    sites.append(_conv(t * r * r, cout, cout, int8=int8, res=r, module="resnet"))
    if cin != cout:
        sites.append(_conv(t * r * r, cin, cout, ksize=1, res=r, module="resnet"))


def _spatial(sites, ucfg, b, f, r, ch, cross_frame, ctx_text, ip_tokens):
    t, n = b * f, r * r
    cx = ucfg["cross_attention_dim"]
    sites += [_linear(t * n, ch, ch, "proj")] * 2
    for _ in range(ucfg["transformer_layers_per_block"]):
        sites += [_linear(t * n, ch, ch, "attn1")] * 4
        sites.append(Site("attention", bq=t, nq=n, bkv=t, nk=n, c=ch, axis="spatial",
                          res=r, module="attn1"))
        if ucfg["use_i2v_adapter"] and cross_frame:
            sites += [_linear(t * n, ch, ch, "i2v_adapter_q"), _linear(b * n, ch, ch, "i2v_adapter_kv"),
                      _linear(b * n, ch, ch, "i2v_adapter_kv"), _linear(t * n, ch, ch, "i2v_adapter_out")]
            sites.append(Site("attention", bq=t, nq=n, bkv=b, nk=n, c=ch, axis="spatial",
                              res=r, module="i2v_adapter"))
        sites += [_linear(t * n, ch, ch, "attn2")] * 2 + [_linear(t * ctx_text, cx, ch, "attn2_ctx")] * 2
        sites.append(Site("attention", bq=t, nq=n, bkv=t, nk=ctx_text, c=ch, axis="spatial",
                          res=r, module="attn2"))
        if ip_tokens:
            sites += [_linear(t * ip_tokens, cx, ch, "attn2_ctx")] * 2
            sites.append(Site("attention", bq=t, nq=n, bkv=t, nk=ip_tokens, c=ch,
                              axis="spatial", res=r, module="attn2_ip"))
        sites += [_linear(t * n, ch, 8 * ch, "ff"), _linear(t * n, 4 * ch, ch, "ff")]


def _motion(sites, ucfg, b, f, r, ch):
    t, n = b * f, r * r
    sites += [_linear(t * n, ch, ch, "motion_proj")] * 2
    for _ in range(2):
        sites += [_linear(t * n, ch, ch, "motion_attn")] * 4
        sites.append(Site("attention", bq=b * n, nq=f, bkv=b * n, nk=f, c=ch, axis="temporal",
                          res=r, module="motion_attn"))
    sites += [_linear(t * n, ch, 8 * ch, "motion_ff"), _linear(t * n, 4 * ch, ch, "motion_ff")]


def unet_sites(ucfg: dict, latent: int, frames: int, clips: int, ctx_text: int,
               cross_frame: bool = True, int8: bool = False) -> List[Site]:
    """Every product of one evaluation of ``clips`` clips of ``frames``
    frames on ``latent`` x ``latent`` latents (a CFG step has two clips a
    request); ``ctx_text`` text tokens; ``int8`` marks the serving
    default's int8 convs."""
    ch, nblocks, layers = ucfg["block_out_channels"], len(ucfg["block_out_channels"]), ucfg["layers_per_block"]
    b, f = clips, frames
    t = b * f
    temb = ch[0] * 4
    ip = ucfg["ip_num_tokens"] if ucfg["use_ip_adapter"] else 0
    motion = ucfg["use_motion_modules"]
    sites = [_linear(b, ch[0], temb, "time"), _linear(b, temb, temb, "time")]
    if ip:
        sites.append(_linear(b, ucfg["image_embed_dim"], ip * ucfg["cross_attention_dim"], "ip_proj"))
    sites.append(_conv(t * latent * latent, ucfg["in_channels"], ch[0], res=latent, module="conv_in"))
    skips, cin = [ch[0]], ch[0]
    for i in range(nblocks):
        r = latent >> i
        for j in range(layers):
            _resnet(sites, t, r, cin if j == 0 else ch[i], ch[i], temb, int8)
            if ucfg["down_block_has_attention"][i]:
                _spatial(sites, ucfg, b, f, r, ch[i], cross_frame, ctx_text, ip)
            if motion:
                _motion(sites, ucfg, b, f, r, ch[i])
            skips.append(ch[i])
        if i < nblocks - 1:
            sites.append(_conv(t * (r // 2) ** 2, ch[i], ch[i], int8=int8, stride=2, res=r, module="down"))
            skips.append(ch[i])
        cin = ch[i]
    r = latent >> (nblocks - 1)
    _resnet(sites, t, r, ch[-1], ch[-1], temb, int8)
    _spatial(sites, ucfg, b, f, r, ch[-1], cross_frame, ctx_text, ip)
    if motion and ucfg["use_motion_mid_block"]:
        _motion(sites, ucfg, b, f, r, ch[-1])
    _resnet(sites, t, r, ch[-1], ch[-1], temb, int8)
    x_ch = ch[-1]
    for i, out in enumerate(reversed(ch)):
        r = latent >> (nblocks - 1 - i)
        for j in range(layers + 1):
            _resnet(sites, t, r, (x_ch if j == 0 else out) + skips.pop(), out, temb, int8)
            if ucfg["up_block_has_attention"][i]:
                _spatial(sites, ucfg, b, f, r, out, cross_frame, ctx_text, ip)
            if motion:
                _motion(sites, ucfg, b, f, r, out)
        if i < nblocks - 1:
            sites.append(_conv(t * (2 * r) ** 2, out, out, int8=int8, res=2 * r, module="up"))
        x_ch = out
    sites.append(_conv(t * latent * latent, ch[0], ucfg["out_channels"], res=latent, module="conv_out"))
    return sites


def vae_decoder_sites(vcfg: dict, latent: int, frames: int, int8: bool = False) -> List[Site]:
    """Every product of decoding ``frames`` latents of ``latent`` x
    ``latent`` (post-quant conv included)."""
    rev, g = tuple(reversed(vcfg["block_out_channels"])), vcfg["layers_per_block"]
    lc = vcfg["latent_channels"]
    px = frames * latent * latent
    sites = [_conv(px, lc, lc, ksize=1, module="post_quant"), _conv(px, lc, rev[0], res=latent, module="conv_in")]
    _vae_mid(sites, frames, latent, rev[0], int8)
    cin = rev[0]
    for i, c in enumerate(rev):
        r = latent << i
        for _ in range(g + 1):
            _resnet(sites, frames, r, cin, c, 0, int8)
            cin = c
        if i < len(rev) - 1:
            sites.append(_conv(frames * (2 * r) ** 2, c, c, int8=int8, res=2 * r, module="up"))
    r = latent << (len(rev) - 1)
    sites.append(_conv(frames * r * r, rev[-1], vcfg["out_channels"], res=r, module="conv_out"))
    return sites


def _vae_mid(sites, frames, r, c, int8):
    _resnet(sites, frames, r, c, c, 0, int8)
    n = r * r
    sites += [_linear(frames * n, c, c, "vae_attn")] * 4
    sites.append(Site("attention", bq=frames, nq=n, bkv=frames, nk=n, c=c, axis="spatial", res=r,
                      module="vae_attn"))
    _resnet(sites, frames, r, c, c, 0, int8)


def vae_encoder_sites(vcfg: dict, size: int, images: int) -> List[Site]:
    """Every product of encoding ``images`` images of ``size`` pixels
    (quant conv included)."""
    ch, g = vcfg["block_out_channels"], vcfg["layers_per_block"]
    sites = [_conv(images * size * size, vcfg["in_channels"], ch[0], res=size, module="conv_in")]
    cin, r = ch[0], size
    for i, c in enumerate(ch):
        for _ in range(g):
            _resnet(sites, images, r, cin, c, 0, False)
            cin = c
        if i < len(ch) - 1:
            r //= 2
            sites.append(_conv(images * r * r, c, c, stride=2, res=2 * r, module="down"))
    _vae_mid(sites, images, r, ch[-1], False)
    lc2 = 2 * vcfg["latent_channels"]
    sites += [_conv(images * r * r, ch[-1], lc2, res=r, module="conv_out"),
              _conv(images * r * r, lc2, lc2, ksize=1, module="quant")]
    return sites


def clip_sites(cfg: dict, seqs: int, tokens: int, patch: Optional[int] = None,
               projection: Optional[int] = None) -> List[Site]:
    """A CLIP tower over ``seqs`` sequences of ``tokens`` tokens; ``patch``
    adds the vision tower's patch embedding (``tokens - 1`` patches) and
    ``projection`` its class-token projection."""
    hd, inter = cfg["hidden_size"], cfg["intermediate_size"]
    sites = []
    if patch:
        sites.append(_conv(seqs * (tokens - 1), 3, hd, ksize=patch, module="patch"))
    for _ in range(cfg["num_hidden_layers"]):
        sites += [_linear(seqs * tokens, hd, hd, "clip_attn")] * 4
        sites.append(Site("attention", bq=seqs, nq=tokens, bkv=seqs, nk=tokens, c=hd,
                          axis="spatial", module="clip_attn"))
        sites += [_linear(seqs * tokens, hd, inter, "clip_mlp"), _linear(seqs * tokens, inter, hd, "clip_mlp")]
    if projection:
        sites.append(_linear(seqs, hd, projection, "projection"))
    return sites


def backward(fwd: List[Site], trainable: Sequence[str]) -> List[Site]:
    """The backward's products for the forward ``fwd`` when only the
    products of the ``trainable`` modules carry weights that train: the
    input gradient of every product after the first trainable one, except
    the key and value projections of the text and image context, which
    see no gradient (an attention's backward is twice its forward); and
    the weight gradients of the trainable products.  Activation
    checkpointing's recompute is not counted: it is not work the model
    needs."""
    first = next((i for i, s in enumerate(fwd) if s.module in trainable), len(fwd))
    out = []
    for s in fwd[first:]:
        if s.module == "attn2_ctx":
            continue
        if s.kind == "attention":
            out.append(replace(s, kind="attention_bwd"))
        else:
            out.append(replace(s, module="dgrad:" + s.module))
    out += [replace(s, module="wgrad:" + s.module) for s in fwd if s.module in trainable]
    return out


def total_ops(sites) -> int:
    return sum(s.ops for s in sites)


def serve_request_sites(model_cfg: dict, req: dict) -> dict:
    """The products of one serving request, by part: ``prep`` (text and
    vision towers, the condition image's encode), ``step`` (one CFG-doubled
    UNet evaluation; the request makes ``steps`` of them) and ``decode``."""
    ucfg, vcfg = model_cfg["unet"], model_cfg["vae"]
    sf = 2 ** (len(vcfg["block_out_channels"]) - 1)
    latent, frames = req["height"] // sf, req["frames"]
    ctx = model_cfg["text_encoder"]["max_position_embeddings"]
    icfg = model_cfg["image_encoder"]
    prep = clip_sites(model_cfg["text_encoder"], 2, ctx)
    if ucfg["use_ip_adapter"]:
        prep += clip_sites(icfg, 1, (icfg["image_size"] // icfg["patch_size"]) ** 2 + 1, patch=icfg["patch_size"],
                           projection=icfg["projection_dim"])
    prep += vae_encoder_sites(vcfg, req["height"], 1)
    return {"prep": prep,
            "step": unet_sites(ucfg, latent, frames, 2, ctx, True, req["int8"]),
            "decode": vae_decoder_sites(vcfg, latent, frames, req["int8"])}

