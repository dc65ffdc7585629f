"""Batched-request serving on the PyTorch port (``examples/serve_batched.py``
with the same flags, plus ``--device``): prompts are admitted through an
`AdmissionQueue` into the slot-based continuous-batching `ServeEngine`
(ring-buffer KV caches for the dense family, O(1) SSM state for Mamba),
at the architecture's smoke config, through ``repro_torch.launch.serve
--smoke``.

``--decode-chunk d`` runs d decode steps per host sync and
``--batch-insert`` admits a same-bucket prompt group through one batched
prefill; both are token-identical to the step-at-a-time defaults.

  PYTHONPATH=src python examples/torch_serve_batched.py        # the card
  PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-2.7b \\
      --decode-chunk 8 --batch-insert --device cpu
"""
import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="decode steps per host sync (1 = per token)")
    ap.add_argument("--batch-insert", action="store_true",
                    help="one batched prefill per same-bucket group")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    argv = ["--arch", args.arch, "--smoke",
            "--batch", str(args.batch), "--prompt-len", "32",
            "--gen", str(args.gen),
            "--decode-chunk", str(args.decode_chunk),
            "--device", args.device]
    if args.batch_insert:
        argv.append("--batch-insert")
    serve_mod.main(argv)


if __name__ == "__main__":
    main()
