"""Train a ~35M-param dense LM for a few hundred steps on the synthetic
stream with the PyTorch port (counterpart of examples/train_small.py): data
-> remat'd forward -> AdamW -> checkpoint, end to end, on the card by
default or on the CPU with --device cpu.

The synthetic corpus is an order-1 permutation chain with 5% noise, so the
achievable loss floor is printed alongside; the model should close most of
the gap from ln(V) toward it. Checkpoints are in the JAX package's format:
examples/train_small.py resumes from them, and this script from its.

`--arch NAME` trains a registered arch's smoke config in f32 in place of
the demo model: every family trains (hybrid zamba2-7b, ssm xlstm-1.3b and
enc-dec seamless-m4t-large-v2 included).

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 300] [--device cpu]
      PYTHONPATH=src python examples/train_small_torch.py --arch xlstm-1.3b --device cpu
"""

import argparse
import dataclasses
import math

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models.common import resolve_device
from repro_torch.training import AdamWConfig, DataConfig, train_loop

CFG = ModelConfig(
    name="demo-35m",
    family="dense",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=2048,
    rope_theta=1e4,
    activation="silu",
    dtype="float32",
    vocab_pad_multiple=64,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--arch", default=None, choices=sorted(list_configs()),
                    help="a registered arch's smoke config (f32) instead of the demo model")
    args = ap.parse_args()

    cfg = CFG if args.arch is None else dataclasses.replace(
        get_config(args.arch, smoke=True), dtype="float32")
    model = build_model(cfg, RuntimeFlags(remat=True))
    params = model.init(seed=0, device=resolve_device(args.device))
    n = sum(p.numel() for p in params.parameters())
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch)
    print(f"model: {cfg.name} ({cfg.family}), {n/1e6:.1f}M params on {args.device} | "
          f"uniform loss {math.log(cfg.vocab_size):.3f} | achievable floor "
          f"{dc.loss_floor:.3f}")
    _, hist = train_loop(
        model, dc,
        AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        n_steps=args.steps, log_every=20,
        ckpt_dir=args.ckpt_dir, ckpt_every=100, params=params,
    )
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"(floor {dc.loss_floor:.3f})")


if __name__ == "__main__":
    main()
