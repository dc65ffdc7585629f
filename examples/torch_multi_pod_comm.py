"""The paper's headline claim across processes, on the PyTorch port (the
twin of ``examples/multi_pod_comm.py``): the cross-pod collective bytes of
one DS-FL round against one FedAvg round, with the federated clients on
the "pod" ranks of a ``torch.distributed`` world, one client a rank.

The bytes are what the ranks' collectives returned, read from the
collectives log (`repro_torch.launch.collectives`), per rank, summed by
kind (`launch.roofline.cross_pod_bytes`): DS-FL all-gathers the bf16
upload stack, K*B*S*V*2 bytes (with ``--topk k`` the (f32 value, int32
index) pairs, K*B*S*k*8), and the round's K f32 losses; FedAvg
all-reduces every parameter as f32 (4 bytes a parameter) and gathers the
losses.  `CommModel`'s count beside them is the paper's: K uploads and one
broadcast of the encoded payload (fp16 distributions, top-k pairs, or the
f32 parameters).

  PYTHONPATH=src python examples/torch_multi_pod_comm.py      # the card
  PYTHONPATH=src python examples/torch_multi_pod_comm.py --smoke \\
      --device cpu --world 2 --backend gloo
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.comm import CommModel, fmt_bytes
from repro_torch.launch import dist
from repro_torch.launch.pod_check import DrillSpec, rank_main
from repro_torch.launch.roofline import collective_bytes, cross_pod_bytes
from repro_torch.models.base import param_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--topk", type=int, default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="gloo",
                    help="gloo lets the ranks share one card")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config at batch 2, seq 32")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.seq = 2, 32
    spec = DrillSpec(arch=args.arch, smoke=args.smoke, clients=args.world,
                     batch=args.batch, seq=args.seq, device=args.device,
                     topk=args.topk, use_kernel=args.device == "cuda",
                     cases=("dsfl", "fedavg"), fingerprint=True)
    ranks = dist.spawn(rank_main, args.world, spec, backend=args.backend)
    cfg = spec.config()
    n_params = _params(cfg)
    comm = CommModel(n_clients=args.world, n_classes=cfg.vocab,
                     n_params=n_params, open_batch=args.batch * args.seq)
    model = {"dsfl": (comm.dsfl_topk_round(args.topk) if args.topk
                      else comm.dsfl_fp16_round()),
             "fedavg": comm.fl_round()}
    print(f"{cfg.name}: {n_params:,} params a client, {args.world} pod "
          f"ranks ({args.backend} on {args.device}), open batch "
          f"{args.batch} x {args.seq} tokens, vocab {cfg.vocab}"
          + (f", top-{args.topk}" if args.topk else ""))
    results = {}
    for name in ("dsfl", "fedavg"):
        log = ranks[0][name]["log"]
        coll, total = cross_pod_bytes(log), collective_bytes(log)
        results[name] = sum(coll.values())
        print(f"{name + '_round':14s} CROSS-POD bytes/rank: "
              f"{fmt_bytes(sum(coll.values()))}  (all collectives: "
              f"{fmt_bytes(sum(total.values()))})  breakdown: "
              f"{ {k: fmt_bytes(v) for k, v in coll.items()} }  "
              f"CommModel (K uploads + 1 broadcast): "
              f"{fmt_bytes(model[name])}", flush=True)
    d, f = results["dsfl"], results["fedavg"]
    print(f"\nDS-FL round moves {f / d:.1f}x fewer cross-pod bytes than "
          f"FedAvg over {args.world} ranks" if f > d else
          f"\nNOTE: model small / open batch large: DS-FL={fmt_bytes(d)} "
          f"vs FedAvg={fmt_bytes(f)} (try --topk 32)")


def _params(cfg) -> int:
    """One client's parameter count, counted under fake tensors."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import model_init
    with FakeTensorMode():
        return param_count(model_init(cfg, torch.Generator(), "cpu"))


if __name__ == "__main__":
    main()
