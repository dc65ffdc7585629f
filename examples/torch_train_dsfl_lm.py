"""DS-FL training of a decoder LM on synthetic domain-skewed token streams,
on the PyTorch port (``examples/train_dsfl_lm.py`` with the same flags,
plus ``--device``), through ``repro_torch.launch.train``: qwen1.5-4b, K
clients exchanging per-token distributions on a shared open batch, the
teacher on K1 and the distillation term on K3/K4 on the card.

``--smoke`` cuts the model to its smoke config at batch 4 and seq 64 (CPU
sized); without it the full-width model trains at batch 8, seq 512.

  PYTHONPATH=src python examples/torch_train_dsfl_lm.py --smoke --steps 30
  PYTHONPATH=src python examples/torch_train_dsfl_lm.py --smoke --steps 2 \\
      --device cpu
"""
import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    argv = ["--arch", "qwen1.5-4b", "--mode", "dsfl",
            "--clients", str(args.clients), "--steps", str(args.steps),
            "--device", args.device]
    if args.smoke:
        argv += ["--smoke", "--batch", "4", "--seq", "64", "--lr", "3e-3"]
    else:
        argv += ["--batch", "8", "--seq", "512", "--lr", "1e-3"]
    train_mod.main(argv)


if __name__ == "__main__":
    main()
