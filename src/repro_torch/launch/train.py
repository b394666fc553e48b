"""Training entry point (counterpart of `repro/launch/train.py`, plus `--device`).

Smoke mode (default): the arch's reduced config in float32, real
optimization on the synthetic stream, remat on. `--full-size` takes the full
config in its own dtype (llama2-7b's 32 layers need ~81 GB of weights,
gradients and moments: more than one 80 GB card). Every registered arch
trains: enc-dec archs take the hashed one-hot of the stream's tokens as
encoder frames and the labels as decoder tokens, as the reference's loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from ..configs import get_config, list_configs
from ..models import RuntimeFlags, build_model
from ..models.common import resolve_device
from ..training import AdamWConfig, DataConfig, train_loop


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b", choices=sorted(list_configs()))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (needs a card that holds it)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full_size)
    if not args.full_size:
        cfg = dataclasses.replace(cfg, dtype="float32")
    device = resolve_device(args.device)
    model = build_model(cfg, RuntimeFlags(remat=True))
    print(f"[train] {args.arch} ({cfg.family}) L={cfg.n_layers} d={cfg.d_model} "
          f"on {device.type}")
    _, hist = train_loop(
        model,
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   batch_size=args.batch),
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps),
        n_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        params=model.init(seed=0, device=device),
    )
    print(f"[train] done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
