"""Batched language-model serving: the slot-based engine with recycling.

The port of `examples/serve_lm.py`: reduced qwen3-4b through the port's
`launch/serve.py` (on the card in bf16, on the CPU in float32).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    done = serve_main(["--arch", "qwen3-4b", "--reduced", "--requests", "6",
                       "--slots", "3", "--prompt-len", "8", "--max-new", "8",
                       "--cache-len", "64", "--device", args.device])
    return {"requests": len(done),
            "new_tokens": sum(len(r.out) for r in done),
            "outputs": {r.uid: [int(t) for t in r.out] for r in done}}


if __name__ == "__main__":
    main()
