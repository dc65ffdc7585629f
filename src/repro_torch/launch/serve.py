"""Serving driver over `repro_torch.serve` (mirrors
``repro/launch/serve.py``): continuous-batching greedy decode with the
O(1) SSM state (mamba2-2.7b, the default) or a ring-buffer KV cache (the
dense family, e.g. ``--arch qwen1.5-4b``).

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve               # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b

The default path drives `ServeEngine` (slot-based continuous batching).
``--decode-chunk d`` runs d decode steps per host sync and
``--batch-insert`` admits same-bucket request groups through one batched
prefill — both token-identical to the step-at-a-time defaults.
``--lockstep`` runs the whole-batch baseline — one prefill, all requests
decoding in lockstep — which the tests hold the engine to.  The VLM
(phi-3-vision-4.2b) and the encoder-decoder (whisper-small) take that
path, as in the reference: their requests carry random patch features or
frame embeddings (`launch.train.extra_inputs`), which the engine's slots
do not hold; a VLM's decode starts after its prompt and its patches.
On the card a Mamba prefill's within-chunk SSD blocks run K5; attention
is plain PyTorch.
Weights are random, drawn from ``--seed`` on the chosen device.
``--trace out.jsonl`` / ``--metrics out.json`` record the run (`obs.cli`).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, list_archs
from ..device import generator, resolve_device
from ..models.api import model_decode_step, model_init, model_prefill
from ..obs import cli as obs_cli
from ..serve import AdmissionQueue, ServeEngine
from .train import extra_inputs


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch: dict, gen: int, seq_budget: int):
    """Lockstep greedy generation (whole batch prefilled and decoded
    together).  Returns (tokens (B, gen), per-step seconds); the first
    entry of the times list is the warm-up step — report on times[1:]."""
    B, S0 = batch["tokens"].shape
    device = batch["tokens"].device
    logits, cache = model_prefill(cfg, params, batch, seq_budget)
    tok = torch.argmax(logits, dim=-1)
    out, times = [tok], []
    pos0 = S0 + (cfg.n_patches if cfg.arch_type == "vlm" else 0)
    for i in range(gen - 1):
        t0 = time.perf_counter()
        logits, cache = model_decode_step(cfg, params, cache, tok, pos0 + i)
        _sync(device)
        times.append(time.perf_counter() - t0)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, 1), times


def steady_ms_per_step(times) -> float:
    """Mean decode ms/step excluding the first (warm-up) step."""
    steady = times[1:] if len(times) > 1 else times
    return 1e3 * sum(steady) / max(len(steady), 1)


def serve_continuous(cfg, params, prompts, gen: int, seq_budget: int, *,
                     decode_chunk: int = 1, batch_insert: bool = False):
    """The same workload through the continuous-batching engine: each
    prompt is a request; slots = number of requests so everything is
    admitted immediately.  Returns (responses by id, list of (seconds,
    decode steps) per step call)."""
    engine = ServeEngine(cfg, params, slots=len(prompts),
                         seq_budget=seq_budget,
                         device=params["embed/tok"].device)
    queue = AdmissionQueue(buckets=engine.buckets)
    # one clock for the whole request lifecycle (arrival/admission/steps)
    t0 = time.perf_counter()
    for toks in prompts:
        queue.submit(toks, gen, now=time.perf_counter() - t0)
    if batch_insert:
        while True:
            reqs = queue.admit(time.perf_counter() - t0,
                               len(engine.free_slots()), group=True)
            if not reqs:
                break
            engine.insert_batch(reqs, time.perf_counter() - t0)
    else:
        for req in queue.admit(time.perf_counter() - t0,
                               len(engine.free_slots())):
            engine.insert(req, time.perf_counter() - t0)
    times = []
    while engine.n_active:
        before = engine.n_steps
        ts = time.perf_counter()
        engine.step(time.perf_counter() - t0, decode_chunk=decode_chunk)
        times.append((time.perf_counter() - ts, engine.n_steps - before))
    by_id = {r.id: r for r in engine.pop_completed()}
    return [by_id[i] for i in sorted(by_id)], times


def steady_ms_per_decode_step(timed_steps) -> float:
    """Mean decode ms per accounted step from ``serve_continuous`` timing
    pairs, excluding the first (warm-up) step call."""
    steady = timed_steps[1:] if len(timed_steps) > 1 else timed_steps
    n = sum(k for _, k in steady)
    return 1e3 * sum(dt for dt, _ in steady) / max(n, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lockstep", action="store_true",
                    help="whole-batch baseline path")
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="run this many decode steps per host sync "
                         "(token-identical)")
    ap.add_argument("--batch-insert", action="store_true",
                    help="admit same-bucket request groups through one "
                         "batched prefill (token-identical)")
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    obs_cli.add_args(ap)
    args = ap.parse_args(argv)
    with obs_cli.session(args):
        run(args)


def run(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    params = model_init(cfg, generator(device, args.seed), device)
    gen = generator(device, args.seed + 1)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    seq_budget = args.prompt_len + args.gen + \
        (cfg.n_patches if cfg.arch_type == "vlm" else 0)

    if args.lockstep or cfg.arch_type in ("vlm", "audio"):
        batch = {"tokens": tokens}
        batch.update(extra_inputs(cfg, args.batch, gen))
        toks, times = serve(cfg, params, batch, args.gen, seq_budget)
        print(f"[lockstep] generated {tuple(toks.shape)} tokens on "
              f"{device}; decode {steady_ms_per_step(times):.1f} ms/step")
        print(toks[0].tolist())
        return

    prompts = [tuple(row) for row in tokens.cpu().tolist()]
    responses, times = serve_continuous(
        cfg, params, prompts, args.gen, seq_budget,
        decode_chunk=args.decode_chunk, batch_insert=args.batch_insert)
    n_tok = sum(len(r.tokens) for r in responses)
    print(f"[continuous] {len(responses)} requests, {n_tok} tokens on "
          f"{device}; decode {steady_ms_per_decode_step(times):.1f} ms/step "
          f"over {len(times)} step calls (chunk={args.decode_chunk}, "
          f"batch_insert={args.batch_insert}, "
          f"weights v{responses[0].weights_version})")
    print(list(responses[0].tokens))


if __name__ == "__main__":
    main()
