"""Numerical-parity harness against a reference stack (the JAX package's
``tools/parity.py``).

1. ``compare``: given two ``.npy`` / ``.npz`` outputs of the same inputs
   and noise (a reference's and this package's), print the PSNR per frame
   and the worst error; passes above 35 dB.
2. ``golden``: where ``diffusers`` is installed, decode one latent with its
   ``AutoencoderKL`` and with this package's on the converted weights, both
   on the current CUDA device (``--device cpu`` for the CPU), and print the
   error.  Without ``diffusers`` it says so and returns 3.

Usage:
  python -m i2v_adapter_tpu_torch.tools.parity compare ref.npy ours.npy
  python -m i2v_adapter_tpu_torch.tools.parity golden --pretrained_model_path DIR
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 2.0) -> float:
    """PSNR in dB; the default peak 2.0 is the [-1, 1] image range."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak**2 / mse)


def compare(ref_path: str, ours_path: str, peak: float = 2.0) -> int:
    """0 when the worst frame is above 35 dB, 1 below, 2 on a shape mismatch."""
    ref = np.load(ref_path)
    ours = np.load(ours_path)
    if isinstance(ref, np.lib.npyio.NpzFile):
        ref = ref[ref.files[0]]
    if isinstance(ours, np.lib.npyio.NpzFile):
        ours = ours[ours.files[0]]
    if ref.shape != ours.shape:
        print(f"SHAPE MISMATCH: {ref.shape} vs {ours.shape}")
        return 2
    # per-frame PSNR over the leading frame axes of a video-shaped array
    if ref.ndim >= 4:
        frames = ref.reshape((-1,) + ref.shape[-3:])
        ours_f = ours.reshape((-1,) + ours.shape[-3:])
        values = [psnr(a, b, peak) for a, b in zip(frames, ours_f)]
        for i, v in enumerate(values):
            print(f"frame {i:3d}: {v:7.2f} dB")
        worst = min(values)
    else:
        worst = psnr(ref, ours, peak)
    print(f"worst-frame PSNR: {worst:.2f} dB  max |err|: {float(np.max(np.abs(ref - ours))):.3e}")
    print("PASS (>35 dB)" if worst > 35.0 else "FAIL (<=35 dB)")
    return 0 if worst > 35.0 else 1


def golden(pretrained: str, device=None) -> int:
    try:
        import diffusers  # noqa: F401
    except ImportError as e:
        print(f"golden mode needs diffusers in the environment: {e}")
        print("(compare mode needs only numpy; the key maps are tested against the "
              "JAX package's in tests/test_torch_port_convert.py)")
        return 3

    import torch
    from diffusers import AutoencoderKL as ReferenceVAE

    from i2v_adapter_tpu_torch.config import VAEConfig
    from i2v_adapter_tpu_torch.device import resolve_device
    from i2v_adapter_tpu_torch.models.vae import AutoencoderKL
    from i2v_adapter_tpu_torch.utils import convert

    dev = resolve_device(device)
    ref = ReferenceVAE.from_pretrained(pretrained, subfolder="vae")
    sd = {k: v.float().numpy() for k, v in ref.state_dict().items()}
    ref = ref.float().to(dev)
    cfg = VAEConfig()
    vae = AutoencoderKL(cfg, device=dev)
    convert.load_flax_params(vae, convert.convert_vae(sd, cfg))
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 4, 8, 8)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = ref.decode(z).sample.cpu().numpy()
        got = vae.decode(z.permute(0, 2, 3, 1).contiguous()).cpu().numpy().transpose(0, 3, 1, 2)
    print("vae.decode max err:", float(np.max(np.abs(got - want))))
    print("vae.decode PSNR:", psnr(got, want))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("compare")
    c.add_argument("ref")
    c.add_argument("ours")
    c.add_argument("--peak", type=float, default=2.0)
    g = sub.add_parser("golden")
    g.add_argument("--pretrained_model_path", required=True)
    g.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)
    if args.mode == "compare":
        return compare(args.ref, args.ours, args.peak)
    return golden(args.pretrained_model_path, args.device)


if __name__ == "__main__":
    sys.exit(main())
