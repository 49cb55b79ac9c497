"""Offline caption -> CLIP text-embedding encoder (the JAX package's
``tools/encode_text.py``): one prompt per line in, one ``text_embeds.npy``
(N, 77, hidden) fp16 out.

Run: ``python -m i2v_adapter_tpu_torch.tools.encode_text --caption_file
F --text_encoder_path DIR --tokenizer_path DIR --output_path OUT.npy`` (on
the GPU; ``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)


@torch.no_grad()
def encode_text(argv=None, model_config=None):
    """The command line.  ``model_config`` (an ``I2VModelConfig``; default
    SD1.5) is for callers that encode with another text tower from code."""
    p = argparse.ArgumentParser()
    p.add_argument("--caption_file", required=True)
    p.add_argument("--text_encoder_path", required=True)
    p.add_argument("--tokenizer_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)

    from i2v_adapter_tpu_torch.config import CLIPTextConfig
    from i2v_adapter_tpu_torch.device import resolve_device
    from i2v_adapter_tpu_torch.models.clip import CLIPTextEncoder
    from i2v_adapter_tpu_torch.utils import convert
    from i2v_adapter_tpu_torch.utils.tokenizer import CLIPTokenizer

    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = model_config.text_encoder if model_config is not None else CLIPTextConfig()
    weights = glob.glob(os.path.join(args.text_encoder_path, "*.safetensors"))
    weights += glob.glob(os.path.join(args.text_encoder_path, "*.bin"))
    enc = CLIPTextEncoder(cfg, device=dev).eval()
    convert.load_flax_params(enc, convert.convert_clip_text(convert.load_state_dict(weights[0]), cfg))
    tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer_path)

    with open(args.caption_file) as f:
        prompts = [line.rstrip("\n") for line in f]
    out = []
    for i in range(0, len(prompts), args.batch_size):
        ids = tokenizer(prompts[i: i + args.batch_size], padding="max_length")
        out.append(enc(torch.from_numpy(np.asarray(ids)).to(dev)).cpu().numpy())
    np.save(args.output_path, np.concatenate(out).astype(np.float16))
    logger.info("encoded %d prompts -> %s", len(prompts), args.output_path)


if __name__ == "__main__":
    encode_text()
