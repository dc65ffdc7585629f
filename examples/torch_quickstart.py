"""DS-FL quickstart on the PyTorch port (``examples/quickstart.py`` with
the same flags, plus ``--device``): 10 clients with non-IID private digit
data collaborate by exchanging logits on a shared unlabeled open set
(never parameters).

The same three lines run any algorithm of the port:

    algo  = DSFLAlgorithm(apply_fn, hp, use_kernel=True)
    eng   = FedEngine(algo, make_eval_fn(...))
    state = eng.run(eng.init(model_init, task), task)

On the card "4. Aggregation" runs the hand-written CUDA kernel K1 (ERA)
or K2 (``--aggregation weighted_era``); with ``--device cpu`` the same call
takes the kernels' plain PyTorch versions.  ``eng.run(...,
chunk_rounds=k)`` runs k rounds a chunk with one host sync a chunk, the
same bits as one round at a time (``--chunk-rounds``; with eval the chunk
sets the log cadence, so every logged round is scored).

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --fast --device cpu
"""
import argparse
import sys

from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.comm import CommModel, fmt_bytes
from repro_torch.core.engine import FedEngine, make_eval_fn
from repro_torch.core.protocol import DSFLConfig
from repro_torch.core.wire import TopKCodec
from repro_torch.data.pipeline import build_image_task
from repro_torch.models.base import param_count
from repro_torch.models.smallnets import apply_mnist_cnn, init_mnist_cnn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--aggregation", default="era",
                    choices=["era", "sa", "weighted_era"])
    ap.add_argument("--chunk-rounds", type=int, default=1,
                    help="rounds a chunk, one host sync a chunk (the same "
                         "bits as one round at a time)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    K = 4 if args.fast else args.clients
    rounds = 3 if args.fast else args.rounds
    dev = args.device
    task = build_image_task(seed=0, K=K,
                            n_private=(640 if args.fast else 3000),
                            n_open=(320 if args.fast else 1500),
                            n_test=(320 if args.fast else 1000),
                            distribution="non_iid", device=dev)

    def init(gen):
        return init_mnist_cnn(gen, image_hw=16, widths=(8, 16), fc=32,
                              device=dev)

    hp = DSFLConfig(rounds=rounds, local_epochs=2, distill_epochs=2,
                    batch_size=40, open_batch=min(320, task.open_x.shape[0]),
                    aggregation=args.aggregation)
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True, device=dev)
    eng = FedEngine(algo, make_eval_fn(apply_mnist_cnn, task.x_test,
                                       task.y_test))
    state = eng.init(init, task)
    # eval syncs with the host each logged round, so the log cadence rides
    # the chunk (with the default --chunk-rounds 1, every round)
    chunk = max(1, min(args.chunk_rounds, rounds))
    state = eng.run(state, task, chunk_rounds=chunk, log_every=chunk)

    wg, sg = algo.eval_params(state)
    n_params = param_count(wg) + param_count(sg)
    cm = CommModel(K, task.n_classes, n_params, hp.open_batch)
    dsfl_bytes = eng.measured_round_bytes(state, task)   # measured on the wire
    topk_bytes = FedEngine(algo, codec=TopKCodec(k=3, n_classes=task.n_classes)
                           ).measured_round_bytes(state, task)
    print(f"\nmodel: {n_params:,} params | {K} clients | "
          f"aggregation={hp.aggregation} | device={algo.device}")
    print(f"per-round comm  FL(FedAvg): {fmt_bytes(cm.fl_round())}   "
          f"DS-FL: {fmt_bytes(dsfl_bytes)}  "
          f"({cm.fl_round() / dsfl_bytes:.0f}x reduction; "
          f"top-3 codec: {fmt_bytes(topk_bytes)})")
    if dsfl_bytes != cm.dsfl_round():
        raise AssertionError(f"measured {dsfl_bytes} B a round, CommModel "
                             f"{cm.dsfl_round()}")
    for h in eng.history:
        print(f"round {h['round']:3d}  server acc {h['test_acc']:.3f}  "
              f"teacher entropy {h['global_entropy']:.3f}")
    ok = eng.history[-1]["test_acc"] > (0.25 if args.fast else 0.5)
    print("OK" if ok else "UNDERTRAINED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
