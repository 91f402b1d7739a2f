"""End-to-end training example: train a granite-family model for a
few dozen steps (reduced by default; `--full-100m` trains a ~100M-param
qwen3-family model).

The port of `examples/train_lm.py` through the port's `launch/train.py`
(on the card in bf16, on the CPU in float32).  Checkpoints go to
`--ckpt-dir`, by default a temporary directory removed at the end.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_lm --full-100m
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import registry as reg
from repro_torch.launch.train import main as train_main


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        if args.full_100m:
            # ~100M params: 12L x 768d qwen3-family, a few hundred steps
            reg.ARCHS["qwen3-100m"] = reg.ARCHS["qwen3-4b"].replace(
                n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                head_dim=64, d_ff=2048, vocab=32000)
            reg._ALIASES["qwen3-100m"] = "qwen3-100m"
            argv = ["--arch", "qwen3-100m", "--steps", str(args.steps or 300),
                    "--batch", "8", "--seq", "512", "--ckpt-dir", ckpt_dir,
                    "--ckpt-every", "100"]
        else:
            argv = ["--arch", "granite-3-2b", "--reduced",
                    "--steps", str(args.steps or 60), "--batch", "8",
                    "--seq", "64", "--ckpt-dir", ckpt_dir,
                    "--ckpt-every", "30", "--lr", "3e-3"]
        loss = train_main(argv + ["--device", args.device])
    print(f"example finished; final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
