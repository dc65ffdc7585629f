"""DS-FL on a simulated mobile fleet, from 100 devices to a million, on the
PyTorch port (``examples/sim_stragglers.py`` with the same flags, plus
``--device``).

Small fleets run the dense `SimRunner` path: 10% participation a round,
lognormal link rates, a straggler deadline, accuracy against *virtual
wallclock* and measured cumulative bytes, all through the unchanged
`FedEngine` round.  ``--chunk`` runs the planned chunk path (sync
participation planned a chunk ahead, the chunk's scalars crossing to the
host once); ``active_budget="auto"`` computes only the scheduler's budget
of client lanes; ``--dense`` forces the full-stack masked round.

Large fleets (K >= 10000, or ``--cohort``) take the cohort path, where
nothing is O(K) a round: the scheduler draws cohorts as id arrays, client
state lives on the host in a `ClientStore` keyed by global id (made
lazily), private data comes from a per-id `SyntheticProvider`, and the
engine runs its ordinary rounds over a slab.  The headline run:

  PYTHONPATH=src python examples/torch_sim_stragglers.py --clients 1000000 \\
      --fraction 1e-4

  PYTHONPATH=src python examples/torch_sim_stragglers.py --fast --device cpu
"""
import argparse
import sys

from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.cohort import ClientStore
from repro_torch.core.comm import fmt_bytes
from repro_torch.core.engine import FedEngine, make_eval_fn
from repro_torch.core.protocol import DSFLConfig
from repro_torch.data.pipeline import SyntheticProvider, build_image_task
from repro_torch.launch import platform
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp
from repro_torch.obs import cli as obs_cli
from repro_torch.sim import (ClientPopulation, CohortRunner, SimRunner,
                             SyncScheduler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--clients", type=int, default=100,
                    help="fleet size K (a million works: see --cohort)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--participation", type=float, default=0.1)
    ap.add_argument("--fraction", type=float, default=None,
                    help="participation fraction per round (the paper's "
                         "C; alias of --participation, wins if both given)")
    ap.add_argument("--deadline", type=float, default=20.0)
    ap.add_argument("--chunk", type=int, default=4,
                    help="rounds per engine chunk (1 = the per-round loop; "
                         "bitwise identical on the CPU)")
    ap.add_argument("--dense", action="store_true",
                    help="force the dense masked round (compute all K "
                         "clients) instead of the participation-sparse "
                         "plane")
    ap.add_argument("--cohort", action="store_true",
                    help="force the cohort path (automatic for K >= 10000)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    obs_cli.add_args(ap)   # --trace out.jsonl / --metrics out.json
    platform.add_args(ap)  # --platform-preset fp32-deterministic, ...
    args = ap.parse_args(argv)
    platform.from_args(args)
    with obs_cli.session(args):
        return run(args)


def run(args):
    K = 20 if args.fast else args.clients
    rounds = 3 if args.fast else args.rounds
    fraction = (args.participation if args.fraction is None
                else args.fraction)
    use_cohort = (args.cohort or K >= 10000) and not args.dense
    dev = args.device

    hp = DSFLConfig(rounds=rounds, local_epochs=1, distill_epochs=1,
                    batch_size=20, open_batch=200, aggregation="era")
    algo = DSFLAlgorithm(apply_tiny_mlp, hp, device=dev)

    def init(gen):
        return init_tiny_mlp(gen, device=dev)

    # a heterogeneous mobile fleet: lognormal compute and uplink, 10x
    # downlink, availability in [0.6, 1.0]; stragglers past the deadline are
    # admitted into the NEXT round with staleness-decayed weight
    pop = ClientPopulation.lognormal(seed=0, K=K, compute_median=5.0,
                                     compute_sigma=0.8, uplink_median=2e4,
                                     uplink_sigma=1.0,
                                     availability=(0.6, 1.0))
    sched = SyncScheduler(pop, fraction=fraction, deadline=args.deadline,
                          straggler="admit", sampler="available")
    chunk = max(1, min(args.chunk, rounds))

    if use_cohort:
        prov = SyntheticProvider(seed=0, n_clients=K, n_per_client=20,
                                 n_open=200, n_test=300, device=dev)
        eng = FedEngine(algo, make_eval_fn(apply_tiny_mlp, prov.x_test,
                                           prov.y_test))
        store = ClientStore(
            lambda ids: algo.init_cohort(hp.seed, init, ids, K), device=dev)
        runner = CohortRunner(engine=eng, scheduler=sched, provider=prov,
                              store=store, seed=0)
        runner.run(algo.init_server(hp.seed, init), rounds=rounds,
                   chunk_rounds=chunk, log_every=chunk)
        mode = (f"cohort rounds: <= {sched.active_budget} of {K} clients "
                f"resident per round")
    else:
        task = build_image_task(seed=0, K=K, n_private=20 * K, n_open=200,
                                n_test=300, distribution="non_iid",
                                device=dev)
        eng = FedEngine(algo, make_eval_fn(apply_tiny_mlp, task.x_test,
                                           task.y_test))
        runner = SimRunner(eng, sched, seed=0)
        state = eng.init(init, task)
        # eval needs a host sync, so it rides the chunk cadence
        runner.run(state, task, rounds=rounds, chunk_rounds=chunk,
                   log_every=chunk,
                   active_budget=None if args.dense else "auto")
        budget = sched.active_budget
        mode = ("dense masked rounds" if args.dense or budget >= K else
                f"sparse rounds: {budget}/{K} client lanes computed")

    print(f"\n{K} clients, {fraction:.2%} participation/round, "
          f"deadline {args.deadline:.0f}s, {mode}, on {dev}")
    for rec in runner.history:
        acc = (f"acc {rec['test_acc']:.3f}" if "test_acc" in rec
               else "acc   ----")   # evals land at chunk boundaries
        resident = (f"  resident {fmt_bytes(rec['resident_bytes'])}"
                    if "resident_bytes" in rec else "")
        print(f"round {rec['round']:3d}  vt {rec['t_cum']:9.1f}s  "
              f"{acc}  "
              f"{rec['participants']:4d} clients "
              f"({rec['dropped']} late, "
              f"stale {rec['mean_staleness']:.2f})  "
              f"cum {fmt_bytes(rec['cum_bytes'])}{resident}")
    if use_cohort:
        print(f"client state resident on host: "
              f"{fmt_bytes(runner.resident_bytes())} "
              f"({len(runner.store)} of {K} clients ever touched); "
              f"peak device slab {fmt_bytes(runner.peak_slab_bytes)}")
    t = runner.history.series("t_cum")
    ok = all(b > a for a, b in zip(t, t[1:])) and len(t) == rounds
    print("OK" if ok else "BROKEN CLOCK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
