#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

The paths: the federated rounds (DS-FL dense, masked,
participation-sparse and two-level, FD and FedAvg), DS-FL rounds of the
paper's F-MNIST CNN, Reuters DNN and IMDb LSTM, the federation
simulator and the million-client cohort plane, serving mamba2-2.7b at full
width (its SSD kernel K5 runs on the tensor cores), serving qwen1.5-4b at
full width (the dense family: attention and MLPs in plain PyTorch, no
kernel of K1-K5 on its path), training mamba2-2.7b and qwen1.5-4b at
full width with LLM-scale DS-FL and FedAvg (K1/K2, K3/K4 and, for Mamba,
K5 on its path; qwen1.5-4b's 151,936-class rows take K1/K2's wide-row
route), serving the MoE models llama4-scout and llama4-maverick at full
width (the MoE FFN in plain PyTorch, no kernel on the path) and Jamba at
its smoke width (K5), hot-swapping a serving qwen1.5-4b from its live
DS-FL federation (K1, K3/K4), driving that server with the load
generator, and serving and training the modality families at full width:
phi-3-vision-4.2b (patch features through a projector) and whisper-small
(an encoder-decoder), each trained with DS-FL (K1, K3/K4 at their
vocabularies of 32,064 and 51,865), training llama4-scout at full width and
2 of its 48 layers with LLM-scale DS-FL and FedAvg (K1 on the wide-row
route and K3/K4 at 202,048 classes), and running the examples' torch
twins, holding the dry run's fake traces to real runs, and decoding
phi3-medium-14b under tensor parallelism.  K1-K5 run as the
``torch.library`` ops of `repro_torch.kernels.library`.  Phases, in
order; any failure exits non-zero and prints no result:

 1. device   the card's name and power limit, torch and CUDA versions; the
             ``fp32`` platform preset (`launch.platform`): TF32 off for
             matmuls and convolutions, so float32 means float32.
 2. build    the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
             one process per source, all started together), timed, with
             ptxas's report.
 3. kernels  each kernel against its plain PyTorch version on the card:
             K1/K2 (ERA, weighted ERA and its weighted mean) at every timed
             shape, at K in (1, 3) x N in (1, 13, 100) x C in (2, 10, 46, 151,
             32768) in f32 and bf16, zero-weight clients of +-1e30 rows
             (bitwise), two launches bitwise equal, the wrappers' refusals,
             and K2's weighted mean on the edge shards of (7, 13, 10) in 3
             edges, two of them not 16-byte aligned; the wide-row route
             (rows past a block's shared memory) at K in (1, 3) x N in (1,
             13, 100) x C in (58081, 100352, 151936, 256000) in f32 (atol
             1e-6) and bf16 (5e-3), flat and peaked rows, zero-weight
             clients of +-1e30 rows (bitwise) and two launches bitwise
             equal at C = 151936;
             K3/K4 (distillation loss and gradient) at the round's
             distillation batch (100, 10) f32, at (333, 50001) f32 (no row
             16-byte aligned), at (2048, 151936) bf16 (the vocabulary of
             configs/qwen1_5_4b.py) and at the LLM round's (1024, 50280)
             bf16, K3 with its launch plan, two launches
             bitwise equal, its float64 error within twice the plain
             version's at those shapes and at one long row, views at row
             offsets, bf16 rows of V = 8k + 1 and short rows, and a
             misaligned plan refused without a launch; the autograd route's
             peak memory at
             (2048, 151936) bf16; K5 (the
             SSD within-chunk block) at the serving prefill's (M, Q, H, P, G,
             N) = (32, 256, 80, 64, 1, 128), at Q = 1, at a ragged Q = 100,
             at G > 1 shapes with ragged P and N, at a head slice that does
             not divide H/G and at rows that are not 16-byte aligned, atol =
             rtol = 1e-4; its shared memory as the wrapper's plan computes it;
             its error against float64 at unit-normal B and C no more than
             twice the plain version's.
 4. timing   CUDA events over >= 100 launches after a warm-up, for each
             kernel and its plain version; for K1-K5 also the device time
             from a CUDA graph of 100 launches (the stream timing measures
             the host's launch rate at small shapes), hot (one input, kept
             in the L2 cache where it fits) and cold (cycling over copies
             larger together than the L2 cache), K1/K2 at the round's (100,
             1000, 10), (100, 1000, 46) and (10, 256, 32768) f32, on the
             wide-row route K1 and K2 at (2, 1024, 151936) bf16 (qwen1.5-4b's
             uploads), K1 at (2, 1024, 256000) bf16 and K2's weighted mean
             at (2, 1024, 151936) f32, K3/K4 at
             their four shapes, K5 at the prefill's and at the LLM round's
             (8, 128, 80, 64, 1, 128).  The bound is the larger of the
             bytes moved over 3.35 TB/s and the operations over the card's
             rate for their type (H100 SXM data sheet): 67 TFLOP/s for fp32
             outside the tensor cores, 495 TFLOP/s for TF32 products, which
             K5 runs three of per fp32 product (3xTF32); K5 also prints its
             earlier bound with every operation at the fp32 rate.  For K3
             also the library call ``F.cross_entropy(z, t,
             reduction="none")`` as a yardstick, timed the same three ways;
             for K4 the backward of ``F.cross_entropy(z, t)`` (its forward
             outside the timed window), which computes K4's function; and
             for K2's weighted mean
             ``torch.mv(p.view(K, N*C).t(), w)`` (no single PyTorch call
             computes K1, K2 with its softmax or K5).
 5. slice    the federated round plane at full width: the paper's MNIST
             CNN (582,218 trainable parameters, 582,410 with BatchNorm
             state), K=100 clients, ``build_image_task(0, K=100,
             n_private=20_000, n_open=10_000, n_test=2_000, "non_iid")``,
             each config's defaults, every round through ``FedEngine.run``:
             with ``DSFLAlgorithm(use_kernel=True)`` 2 ERA rounds, 1
             weighted-ERA round, 1 masked round with half the clients
             present (injected draws), the same round from the same state
             and draws participation-sparse (``active_budget=50``) twice
             (the first call at 50 lanes, then warm; the two runs are also
             compared with each other), 1 two-level ERA round
             (``agg_edges=4``); then 2 rounds each of ``FedAvgAlgorithm``
             and ``FDAlgorithm``.  Launch counts are zeroed just before the
             rounds and read just after; each round's own launches are held
             to what its path takes (K1 once a dense ERA round, K2 once a
             weighted, masked or sparse round and 4 times the two-level
             round, FD and FedAvg none).  The masked and sparse rounds run
             under torch's deterministic algorithms (``deterministic``): with
             the default ones the sparse round was 1.3e-6 from the masked one
             in one run of this script and 3.5e-4 (past the limit) in
             another, and it was not bitwise equal to itself.  The
             sparse rounds are held to the masked one: the aggregation
             weights and the 50 absent clients' leaves bitwise, the rest
             within CARD_VS_CPU_ATOL/RTOL.  The
             round never reaches K3/K4 (its distillation calls the plain
             loss, as the JAX reference's does), so a side check then zeroes
             the counts again and runs the distillation loss of the final
             state through ``losses.distill_xent(use_kernel=True)``; its
             counts are ``side_check_launches``.  Then the two-level teacher
             against the flat weighted-ERA teacher on the same uploads
             (atol 1e-6), and ``FedEngine.measured_round_bytes`` of DS-FL,
             FD and FedAvg, which must equal ``CommModel``'s.  Then one more
             ERA round, timed in the two halves the algorithm splits it
             into.
 6. card vs CPU  rounds from the same weights and draws on the card
             (kernels, float32, PyTorch's own convolutions in place of
             cuDNN's, see ``native_convs``) and on the CPU (plain versions,
             float64), compared leaf by leaf: K=4, full-width CNN, 1 local
             and 1 distillation epoch; an ERA round, a sparse ERA round (2
             of 4 clients, budget 2) and a FedAvg round.  The CPU's float32
             round is printed beside them.
    paper models  the paper's other three models at full width, each
             through ``FedEngine.run`` with ``DSFLAlgorithm(use_kernel=True)``
             and ``DSFLConfig``'s defaults (ERA at T = 0.1, 5 + 5 epochs,
             batch 100, |o_r| = 1000, SGD; fmnist_cnn at lr 0.01, where 0.1
             diverges, see PAPER_MODELS), PAPER_ROUNDS (1) each:
             ``fmnist_cnn`` (2,759,976 values) at K=100 on
             ``build_image_task(0, K=100, n_private=20_000, n_open=10_000,
             n_test=2_000, "non_iid", hw=28)``, K1 at (100, 1000, 10);
             ``reuters_dnn`` (5,194,670) at K=10 on ``make_bow`` documents
             (8,000 private dealt by ``partition.dirichlet`` at alpha 0.5,
             2,000 open, 1,000 test; vocabulary 10,000, 46 classes), K1 at
             (10, 1000, 46); ``imdb_lstm`` (648,386) at K=10 on
             ``make_token_lm`` sequences of 80 tokens over 20,000 words with
             two domains as the label (10,000 private, 5,000 of each
             domain, dealt 9:1 by ``partition.ratio_non_iid``; 5,000 open,
             1,000 test), K1 at (10, 1000, 2).  Launch counts are zeroed
             before each model's rounds and read after (K1 once a round,
             nothing else); one ``paper models <name> {...}`` line each
             with the values, seconds of the first and later rounds, peak
             memory, test accuracy, launches and the measured DS-FL and
             FedAvg bytes a round, held equal to ``CommModel``'s.  Then each
             model's DS-FL round at K=2 on small data on the card
             (deterministic algorithms, native convolutions) against the
             CPU's float64 round, leaf by leaf, as phase 6.
    sim      the simulator at full width (``mnist_cnn`` at paper width,
             examples/sim_stragglers.py's lognormal fleet, ``SyncScheduler(
             fraction, deadline=20, straggler="admit", sampler="available")``),
             launch counts zeroed before each SIM_ROUNDS-round run (4) and
             read after it (K2 once a round, nothing else): (a) ``SimRunner`` at K=100 on
             ``build_image_task(0, K=100, n_private=20_000, n_open=10_000,
             n_test=2_000, "non_iid")``, ``DSFLConfig()`` with 4 rounds,
             fraction 0.1 (budget 20), ``active_budget="auto"``, chunks of 2
             (SIM_CHUNK) with ``log_every=2``, under deterministic algorithms: fused,
             one round at a time and pipelined (``overlap=True``), and
             resumed after chunk 1 from a checkpoint into a fresh engine and
             runner; plans, virtual clock and bytes equal exactly, leaves
             within CARD_VS_CPU_ATOL/RTOL; seconds a round and a chunk, peak
             memory. (c) at K=100, ``CohortRunner`` over ``ArrayProvider``
             and ``SimRunner`` given the same plans, 4 rounds (one slab of
             80 lanes), leaves within the tolerance through the plain
             aggregation; K2 on each round's slab stack and on its dense
             stack, each within 1e-6 of its plain version and the two
             teachers within 1e-6. (b) ``CohortRunner`` at K=1,000,000 and
             fraction 1e-4 (budget 200, slabs of 400 lanes) over
             ``SyntheticProvider(n_per_client=20, n_open=200, n_test=300,
             hw=28)``, 1 + 1 epochs, batch 20, open batch 200, 4 rounds in
             chunks of 2, saved after chunk 1 and loaded into a fresh
             engine, runner and store; resident and slab bytes, touched
             clients and the host seconds of each span (plan, gather with
             its lazy inits, provider, scatter, engine chunk); K2 on round
             0's (400, 200, 10) slab against its participants' stack, as in
             (c). (d) keyed
             permutations and open batches bitwise equal on the card and
             the CPU; a K=4 cohort round on the card (native
             convolutions, as phase 6) against the CPU's float64 round.
             (e) ``torch.profiler``
             over the second chunk of (b), the card's activities only (as
             every trace here): host time, the card's busy time (the union
             of its activities) and idle share, top kernels (with the
             host's ops recorded too, turning the trace into events took
             over a minute; (a)'s resumed chunk is no longer profiled:
             reading its trace took about two minutes).
 7. serve    the serving path: mamba2-2.7b at the config's widths and its 64
             layers in bf16 (2,702,579,200 values from the port's seeded
             init on the card) through ``ServeEngine(slots=8,
             seq_budget=2112, buckets=(256, 1024, 2048))``: four
             2048-token prompts through one
             ``insert_batch``, prompts of 1024, 1030, 256 and 40 tokens
             through ``insert`` (the 1030 and 40 force 6 and 39 tail tokens
             through decode), 32 new tokens each, decoding with
             ``decode_chunk=1`` first, then ``decode_chunk=8``.  Launch
             counts are zeroed just before the first insert and read after
             the last step: K5 must show 64 launches per prefill shot (one
             per Mamba layer), K1-K4 none.  Prints prefill ms per shot,
             decode ms per step, generated tokens per second, peak device
             memory and K5's share of the (4, 2048) prefill.
    trace    after that window, a ``torch.profiler`` trace of one (4,
             2048) prefill shot and of decode steps (d=1 and d=4), the
             card's activities only: host time, device time, idle share
             and the top kernels by device time.
 8. routes   the same weights widened to float32, at all 64 layers, and the
             same (4, 2048) prefill through K5 and through its plain
             version patched in: last-token logits, the decode cache and
             the greedy first tokens, held to ``ROUTE_RTOL``; the plain
             route with a 1% fault in the SSD core must fail that check.
 9. LM card vs CPU  mamba2-2.7b at full width and depth 2 in float32, the
             same weights on the card (K5) and on the CPU (plain versions):
             one (1, 512) prefill and 8 decode steps, logits and every cache
             leaf compared.
    serve qwen1.5-4b  (a) qwen1.5-4b at the config's widths and its 40
             layers in bf16 (3,561,413,120 values from the port's seeded
             init, asserted; the tied embedding scaled by d_model^-1/2,
             see ``scale_embedding``) through phase 7's engine and window, with
             ``decode_chunk=1`` first, then 16: launch counts zeroed just
             before the first insert and read after the last step, K1-K5
             all 0; a ``serve qwen1.5-4b`` line with prefill ms a shot,
             decode ms a step at 8 slots, tokens/s, peak device memory
             and the ring buffers' bytes (asserted 6,920,601,600); requests
             of 1030, 1024 and 40 tokens served again, each alone in an
             engine of the same 8 slots, must give the window's greedy
             tokens; then phase 7's trace of this model; the port's
             chunked attention at the (4, 2048) shot's per-layer shape
             (4, 2048, 20, 128) bf16 causal beside
             ``F.scaled_dot_product_attention`` (a yardstick, never called
             by the engine); (b) the card against the CPU in float32 at
             full width and depth 2, as phase 9: qwen1.5-4b, a (1, 512)
             prefill and 8 decode steps; phi3-medium-14b (40 heads over 10
             KV heads) with a 120-token sliding window and ring, a (1,
             128) prefill and 4 decode steps that each overwrite the
             ring's oldest slot.
10. llm      LLM-scale training, `repro_torch.launch.train`'s code path
             (``setup``, ``run_rounds``, ``run_local``) at mamba2-2.7b's
             full width and 64 layers, bf16, K = 2 clients, batch 8, seq
             128, open batch 8, the kernels on (``use_kernel``): DS-FL ERA 2
             rounds, DS-FL ``--topk 8`` 1 round, DS-FL ``--participation
             0.5`` through ``SimRunner`` (one dense masked round, one
             participation-sparse), FedAvg 2 rounds, ``local`` 2 steps.  Each
             run is one window with the launch counts zeroed before and read
             after, held to exactly what its path takes (K5 64 a client's
             prediction and 64 a measured payload, K1 a dense teacher, K2 a
             masked or sparse one, K3/K4 a client step; FedAvg and local
             none); one ``llm`` JSON line a run with the seconds of the first
             round and of the rest, peak memory, losses and the measured
             bytes a round, held equal to ``CommModel``'s (FP16, top-k, and
             FedAvg's f32 parameters).  Then K1-K5 against their plain
             versions at this path's shapes (K3/K4 also f32 logits against
             the bf16 teacher), the route check at full width in f32 (see
             LLM_ROUTE_LAYERS), and a smoke-config DS-FL and FedAvg round on
             the card against the CPU.
    llm qwen1.5-4b  the same five windows at qwen1.5-4b's full width and 40
             layers (3,561,413,120 values a client, asserted; the tied
             embedding scaled as in phase "serve qwen1.5-4b"): K1 3 / 1 / 0
             and K2 0 / 0 / 2 in the DS-FL windows, K3/K4 one a client
             step, K5 0; bytes held to ``CommModel`` (FP16 933,494,784 B,
             top-k 196,608, FedAvg 42,736,957,440); a profiled client
             step; K1-K4 at its (2, 1024, 151936) and (1024, 151936)
             shapes; the route check in f32 at 12 layers (no prediction
             leg: a dense forward runs no kernel); its smoke config's
             DS-FL and FedAvg rounds on the card against the CPU.
    moe      (a) llama4-scout-17b-a16e at its full widths (d 5120, 40
             heads of 128 over 8 KV heads, 16 experts top-1 of d_ff 8192,
             vocabulary 202,048), 12 of its 48 layers (MOE_SCOUT_LAYERS:
             a layer is 4.15 GB), bf16, seeded, the embedding scaled,
             through phase 7's engine and window (launch counts zeroed
             before the first insert and read after the last step: no
             kernel on this path), then the window once more with every
             MoE FFN's dropped (token, choice) pairs counted in the (4,
             2048) shot, the single inserts and decode (each slot's
             token routed as a group of its own, as the reference's vmap
             over the slots does), and phase 7's trace of it; (b)
             llama4-maverick-400b-a17b at its full widths and one block (a
             dense layer and a layer of 128 experts), the same window and
             drop counts; (c) one MoE FFN at scout's full width in float32
             on 512 tokens, card against CPU: expert, rank and keep equal
             except where the router's top-two gap is under 1e-5 (counted
             and printed), the output within 1e-4 + 1e-4 |x| in every group
             whose routes agree; scout's and maverick's smoke configs
             through one ServeEngine run on the card and on the CPU,
             tokens equal; (d) jamba-1.5-large-398b's smoke config (a
             full-width block is 88 GB), a (1, 64) prefill and 8 decode
             steps on the card (K5 in its 14 Mamba sub-layers, held to
             exactly 14 launches) against the CPU, logits and every cache
             leaf within CARD_VS_CPU_ATOL/RTOL.
    hot swap qwen1.5-4b served at full width (phase 7's engine, the
             embedding scaled) while `repro_torch.launch.train`'s DS-FL
             federation of it (phase "llm qwen1.5-4b"'s settings, K = 2)
             runs 2 rounds with ``serve.attach``: a request served before
             carries version 0, one after version 2; the served weights
             are bitwise ``eval_params`` of the final state and share no
             storage with the trainer; the window's launches held to K1 2,
             K3/K4 4; swap latencies and the window's peak printed.
    loadgen  ``serve.run_load`` on the first of those weights' 40 layers
             (a fresh engine of phase 7's shape each run) with ``LoadSpec(n_requests=32, rate=4.0,
             prompt_len=(4, 48), max_new=(4, 16), vocab=151936, seed=0)``,
             with the defaults, ``decode_chunk=8`` and
             ``batch_insert=True``: every request's tokens equal across the
             three; completed and shed, latency and TTFT p50/p99 (virtual)
             and tokens per wall second printed; no kernel launched.
    modality (a) phi-3-vision-4.2b at full width (32 layers, d 3072, 32
             heads of 96, vocabulary 32,064; 3,732,016,128 values asserted)
             and (b) whisper-small (12 encoder and 12 decoder layers, d
             768, 1,500 frames; 263,318,784 values), bf16, seeded, the tied
             embedding scaled, each through `launch.serve.serve` (the
             lockstep path both launchers take for these families): 4
             requests of 576 patches and 512 tokens, 32 new, or of 1,500
             frames and 64 tokens, 64 new; prefill (and whisper's encoder)
             timed twice, decode ms a step, peak; no kernel launched; then
             whisper in f32 at full width: a prefill of 64 tokens and 16
             teacher-forced decode steps within 1e-4 of the largest
             teacher-forced logit (the prefill fills the decoder's rings,
             ROADMAP deviation 16; decoding from empty rings, the
             reference's prefill, is printed and must fail that check);
             (c) each model through `launch.train`'s windows at K = 2,
             batch 8, seq 128 (phi-3-vision's sequences 576 + 128
             positions): DS-FL ERA 2 rounds (K1 2, K3/K4 4, nothing else)
             and FedAvg 1 round (none), bytes a round held to `CommModel`
             (FP16 197,001,216 / 318,658,560; FedAvg 44,784,193,536 /
             3,159,825,408); (d) K1/K2 at (2, 1024, 32064) and (2, 1024,
             51865) bf16 and K3/K4 at (1024, 32064) and (1024, 51865) bf16
             against their plain versions (K3 also against float64) and
             timed as phase 4's rows, then `llm_kernel_checks` at each
             vocabulary; (e) both smoke configs' DS-FL and FedAvg rounds
             on the card against the CPU, and their lockstep serve tokens
             equal on both.
    moe train (a) llama4-scout-17b-a16e at its full widths and 2 of its
             48 layers (5,187,036,160 values a client asserted; two
             client stacks, the fresh stack and a client's gradients leave
             no room for a third layer, see MOE_TRAIN_LAYERS), bf16, the
             embedding scaled, through `launch.train`'s windows at K = 2,
             batch 8, seq 128 (``train.get_config`` cut to that depth):
             DS-FL ERA 2 rounds (K1 2, K3/K4 4, nothing else; the line
             adds the share of (token, choice) pairs dropped by capacity
             in client 0's forward, ``model_flops`` of one client step by
             `launch.roofline`, the aten products of one client step
             counted by ``torch.utils.flop_counter`` and the step's
             `Roofline`), a profiled client step, and FedAvg 1 round (none);
             bytes a round held to `CommModel` and to 1,241,382,912 /
             62,244,433,920; (b) K1 at (2, 1024, 202048) bf16 and K3/K4 at
             (1024, 202048) bf16 against their plain versions (K3 also
             against float64), timed as phase 4's rows, and
             `llm_kernel_checks` at that vocabulary; (c) the smoke configs
             of llama4-scout, llama4-maverick and jamba (a full-width
             block of maverick is 34.8 GB and of Jamba 88 GB): a DS-FL and
             a FedAvg round on the card against the CPU, launches held (K1
             1, K3/K4 2, K5 28 for Jamba's prediction leg).
    pod      the federated client axis over torch.distributed ranks:
             qwen1.5-4b at full width and 40 layers, K = 2, batch 8, seq
             128, the embedding scaled, under ``fp32-deterministic``,
             through `launch.pod_check`'s cases chained (2 ERA rounds, a
             top-k 8 round, a participation-0.5 sparse round, a FedAvg
             round): (a) world 1 over NCCL in this process, the engine
             over `make_client_mesh(2)` bitwise the engine without a mesh
             (every lane of every leaf fingerprinted on the card, history,
             launches; K1 on the all-gathered stack); (b) world 2 over
             gloo, one client a rank, both ranks on this card, at 1 of
             the 40 layers (POD_LAYERS_B), each rank's lane bitwise the
             one-process client at that depth; per case and rank the
             seconds a round, peak, the collectives log's bytes by kind
             (held to the closed forms) and K1-K4 launches.
    tp       tensor parallelism over "model" and FSDP over "data"
             (`launch.tp`) at full width, K = 2, batch 8, seq 128, the
             embedding scaled, world 2 over gloo with both ranks on this
             card, the runs of TP_SPAWNS: phi3-medium-14b on (1, 1, 2)
             (`make_smoke_mesh(multi_pod=True)`) in f32 at 1 of the 40
             layers (2 ERA rounds, a top-k 8 round, a FedAvg round, each
             from the init) and (1, 2, 1) in f32 at 1 layer (a FedAvg
             round); mamba2-2.7b on (1, 1, 2) in f32 at 4 of the 64
             layers (the same cases; 40 heads a rank, K5 at (8, 128, 40,
             64, 1, 128) in each prediction), Jamba's smoke config (an
             ERA round; 4 groups a rank), phi-3-vision-4.2b on (1, 1, 2)
             in f32 at 1 of its 32 layers (the same cases; 16 heads a
             rank, the projector's columns split and gathered) and
             whisper-small in f32 at 2 + 2 of its 12 + 12 layers on (1,
             1, 2) (the same cases; 6 heads a rank in the encoder, the
             decoder's self- and cross-attention) and on (1, 2, 1) (an ERA
             round, a FedAvg round; FSDP of `enc/` and `dec/`, 4
             sequences and their frames a data rank); each rank's
             slices and losses held against the one-process run (atol
             1e-4 after two rounds, 1e-5 after one, losses also rtol
             1e-6), each
             one-process leaf shown to move past that bound (lr TP_LR),
             and the check shown to fail on a FedAvg round with one
             rank's slice of `pod_check.fault_leaf` 1% off before it
             (phi3's ``w_down``, mamba2's ``w_out``, phi-3-vision's
             ``patch_proj/w``, whisper's ``dec/mlp/w_down``); phi3 on (1,
             1, 2) in bf16 at 1 layer, mamba2 at 4, llama4-scout in bf16
             at 1 of its 48 layers (8 experts a rank), phi-3-vision at 1
             and whisper at 4 + 4: seconds a round and
             peak a rank; every run's bytes a rank by axis held to
             `tp.round_bytes`, K1 once a DS-FL round, K3/K4 once a
             client step, K5 once a Mamba layer a prediction; one scout
             MoE FFN at full width in f32 (1,024 tokens in groups of 256,
             forward and backward) on (1, 1, 2), each rank held to one
             process within 1e-5 of each tensor's largest magnitude, the
             dropped choices equal, a 1% fault in rank 1's expert
             ``w_down`` slice caught; each spawn's seconds.
    dryrun   the dry run's counters held to the card: qwen1.5-4b at
             `launch.train`'s defaults (K = 2, batch 8, seq 128, its 40
             layers, bf16, the embedding scaled) through its ``local``
             step, a DS-FL client step (K3/K4) and a DS-FL ERA round (K1,
             K3/K4), and mamba2-2.7b's prediction pass (K5 64 times), each
             fake-traced on the card's device (`launch.specs`,
             `launch.costs`; traced at 2 and 3 blocks and extrapolated,
             `launch.dryrun.extrapolate`) and run for real under the same
             counters, each window's arguments made just before it and
             freed after: FLOPs, bytes, arguments, live peak and op calls
             equal exactly, op calls equal to the launches, the trace's
             temporaries (its peak less its arguments) within 10% of what
             ``max_memory_allocated`` rose by over the arguments after
             ``reset_peak_memory_stats``;
             each record's `Roofline` beside the measured seconds (not
             held: host-bound); the ops' host cost a call beyond their
             launch functions; then the dry run's phi3-medium-14b x
             decode_32k x 16 x 16 record from ``python -m
             repro_torch.launch.dryrun`` in a child process (a fake world
             of 256), which must be ``ok``.
    tp decode the decode step under tensor parallelism
             (`launch.decode_check`): phi3-medium-14b, mamba2-2.7b and
             whisper-small at full width, 4 layers in f32 (whisper 4 +
             4), the embedding scaled, a start token and 16 greedy tokens
             from an empty cache (whisper's holding the cross keys and
             values of 1,500 seeded frames), world 2 over gloo on this
             card: phi3 and whisper on (1, 1, 2) at batch 8 (heads split
             40 / 2 and 10 / 2; 12 / 2, the cross cache's too) and on (1,
             2, 1) without FSDP at batch 1 (the ring's window split over
             "data"; whisper's 1,500 cross positions too), mamba2 on (1,
             1, 2) at batch 8 (the mixer's heads, its state and conv
             windows split), every rank's tokens equal and logits
             within 1e-5 of the largest one-process logit, bytes a step
             by axis equal to
             `tp.decode_bytes`, ms a step and the peak a rank printed; a
             1% fault in rank 1's ``wo`` slice, in its value ring, in
             its SSM state and in whisper's cross values must fail the
             check.
    examples the examples' torch twins on the card, each its own process:
             ``examples/torch_quickstart.py --fast`` (must end ``OK``),
             ``examples/torch_serve_batched.py``,
             ``examples/torch_train_dsfl_lm.py --smoke --steps 2``; a
             non-zero exit fails the script.
11. the ``{"kernels": [...]}`` line (launches on each path, ``wide``
             timing rows for K1/K2, ``llm_qwen_launches``,
             ``paper_models_launches`` by model, ``moe_serve_launches``,
             ``jamba_smoke_launches``, ``hot_swap_launches``,
             ``loadgen_launches``, ``modality_launches`` by model and
             window, ``modality`` timing rows for K1-K4,
             ``moe_train_launches`` by window, ``moe_smoke_launches`` by
             model, ``moe_train`` timing rows for K1, K3 and K4,
             ``pod_launches``: phase "pod" (a)'s run over the mesh,
             ``tp_launches``: phase "tp"'s bf16 runs by arch, rank 0;
             ``dryrun_launches`` by window and ``op_host_us``: phase
             "dryrun"; ``tp_decode_launches``: phase "tp decode", rank 0's by
             mesh),
             the card's line, and the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# torch's switches as named presets, and the card's published peaks and
# the least time of a call (NVIDIA's data sheet for the H100 SXM)
from repro_torch.launch import platform  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOPS, HBM_BYTES_PER_S, L2_BYTES, bound_ms)

TIMING_ITERS = 100
CARD_VS_CPU_ATOL, CARD_VS_CPU_RTOL = 2e-4, 1e-3
# the kernels the image DS-FL round launches; K3/K4 sit behind
# losses.distill_xent(use_kernel=True), which that round does not call
ON_MAIN_PATH = ("era_sharpen", "weighted_era_sharpen")
SERVE_KERNELS = ("ssd_chunk",)      # what the serving path launches
# K3/K4's main path: the KD term of the LLM rounds (phase "llm"), which
# also launches K1, K2 and K5 (their counts there are ``llm_launches``)
LLM_KERNELS = ("distill_loss_fwd", "distill_loss_bwd")
# K1/K2 timing shapes (K, N, C) f32: the DS-FL round's (MNIST and F-MNIST),
# 46 classes at K=100 and at reuters_dnn's K=10, imdb_lstm's 2 classes at
# K=10, and the edge of the kernel's regime (C = 32k), beyond the L2 cache
ERA_SHAPES = ((100, 1000, 10), (100, 1000, 46), (10, 1000, 46),
              (10, 1000, 2), (10, 256, 32768))
# K1/K2's wide-row route (rows of more than SMEM_BYTES / 4 = 58,080 f32
# values): the classes it is checked at (the first past the narrow route,
# phi3's, qwen1.5's and gemma's vocabularies), and its timing shapes: the
# LLM round's uploads of qwen1.5-4b (K1 and K2) and of gemma's vocabulary
# (K1) in bf16, and K2's weighted mean at qwen's in f32
WIDE_C = (58_081, 100_352, 151_936, 256_000)
WIDE_TIMING = (((2, 1024, 151_936), torch.bfloat16,
                ("era_sharpen", "weighted_era_sharpen")),
               ((2, 1024, 256_000), torch.bfloat16, ("era_sharpen",)),
               ((2, 1024, 151_936), torch.float32, ("weighted_mean",)))
# K3/K4 shapes (N, V, dtype): the round's distillation batch, a ragged f32
# vocabulary (rows not 16-byte aligned), qwen1.5-4b's vocabulary in bf16,
# and the LLM round's KD term (batch 8 x seq 128 tokens, mamba2-2.7b's
# vocabulary, bf16)
K3_SHAPES = ((100, 10, torch.float32), (333, 50_001, torch.float32),
             (2048, 151_936, torch.bfloat16), (1024, 50_280, torch.bfloat16))
K3_MAIN = K3_SHAPES[3]      # K3/K4's main path: the LLM round's KD term
K5_TOL = 1e-4                       # the reference's (tests/test_kernels.py)
K5_MAIN = (32, 256, 80, 64, 1, 128)  # (M, Q, H, P, G, N) of a (4, 2048) prefill
K5_SHAPES = (("main path (4, 2048) prefill", K5_MAIN),
             ("bucket-1 prefill, Q=1", (4, 1, 80, 64, 1, 128)),
             ("ragged Q=100", (3, 100, 80, 64, 1, 128)),
             ("G>1, ragged P and N", (5, 77, 12, 40, 3, 24)),
             ("G>1, two P tiles, three Q tiles", (2, 130, 8, 96, 2, 64)),
             ("head slices of 16 and 4, N=20, P=40, Q=130",
              (24, 130, 20, 40, 1, 20)),
             ("rows not 16-byte aligned, P=37, N=13", (3, 70, 6, 37, 2, 13)),
             ("a rank's heads: mamba2-2.7b's prediction at 'model' 2",
              (8, 128, 40, 64, 1, 128)),
             ("a rank's groups: Jamba's prediction at 'model' 2",
              (8, 128, 128, 64, 4, 128)))
# K5 at a rank's heads of mamba2-2.7b's prediction (batch 8 x seq 128) over
# "model" = 2, phase "tp"'s shape: timed beside LLM_K5
TP_K5 = K5_SHAPES[-2][1]
# Kernel route vs plain route at full width and depth, in float32.  The two
# routes differ only in the order of the SSD core's f32 sums, about 1e-6 of
# its values.  In bf16 every layer rounds that onto a bf16 step (2^-8) where
# a value sits near a rounding boundary, and 64 layers carry those steps:
# a comparison there cannot tell a rounding-order difference from a
# percent-level fault.  In float32 there is no such step, so each tensor
# (logits and every cache leaf) is held to ROUTE_RTOL of its largest
# magnitude, and the run shows the check has the power it claims: the plain
# route with every SSD core output times (1 +- ROUTE_FAULT) at random must
# land outside it.  A greedy token may differ only where the plain route's
# top-2 margin is below twice the largest logit difference.
ROUTE_RTOL = 1e-4
ROUTE_FAULT = 1e-2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a):
    print(*a, flush=True)


def time_ms(fn, iters=TIMING_ITERS, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.cache
def _capture_stream():
    return torch.cuda.Stream()


def graph_ms(fns, launches=TIMING_ITERS, replays=10) -> float:
    """Device time of one call: ``launches`` calls captured in a CUDA graph,
    replayed after a warm-up, timed with events, so the host's launch rate
    is out of the number.  ``fns`` is one callable, or a list whose calls
    take turns (launch i calls ``fns[i % len(fns)]``, each at least once a
    replay): given calls on distinct copies of an input larger together
    than the L2 cache, each call finds its input cold in device memory."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    launches = max(launches, len(fns))
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up's stream, where a backward yardstick's forward
    # ran (autograd runs a backward op on its forward op's stream)
    with torch.cuda.graph(graph, stream=side):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def cold_copies(*ts) -> list:
    """At least 13 distinct copies of the tensors ``ts`` (a tuple a copy),
    and more than twice the L2 cache (50 MB) together, so a call cycling
    over them reads each one from device memory."""
    nbytes = sum(t.numel() * t.element_size() for t in ts)
    n = max(13, -(-2 * L2_BYTES // nbytes))
    return [tuple(t.clone() for t in ts) for _ in range(n)]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(out, exp, atol, rtol) -> bool:
    return bool(torch.allclose(out.float(), exp.float(), atol=atol, rtol=rtol))


def check(name, out, exp, atol, rtol=0.0):
    torch.cuda.synchronize()
    err = max_err(out, exp)
    ok = close(out, exp, atol, rtol)
    say(f"check {name}: max_abs_err={err:.3e} atol={atol} rtol={rtol} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases --
def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    platform.apply("fp32")
    say("platform preset fp32: tf32 off for matmul and cudnn (float32 runs "
        "in float32)")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    say(f"build: {len(logs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas[{name}] {line.strip()}")


def _probs(shape, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 2
    return torch.softmax(x, dim=-1).to(dtype)


def _zt(N, V, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = (torch.randn((N, V), generator=g, device="cuda") * 4).to(dtype)
    t = torch.softmax(torch.randn((N, V), generator=g, device="cuda"),
                      dim=-1).to(dtype)
    return z, t


def _weights(K, seed, zeros=(0,)):
    w = torch.rand((K,), generator=torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    w[list(zeros)] = 0.0
    return w / w.sum()


def era_calls(es, p, w, T=0.1):
    """The three functions of K1/K2 on (p, w): name -> (kernel call, plain
    call)."""
    return {
        "era_sharpen": (lambda: es.era_sharpen(p, T),
                        lambda: es.era_sharpen_plain(p, T)),
        "weighted_era_sharpen": (
            lambda: es.weighted_era_sharpen(p, w, T),
            lambda: es.weighted_era_sharpen_plain(p, w, T)),
        "weighted_mean": (
            lambda: es.weighted_era_sharpen(p, w, sharpen=False),
            lambda: es.weighted_era_sharpen_plain(p, w, sharpen=False))}


def era_timing(es, K, N, C, seed, dtype=torch.float32,
               names=("era_sharpen", "weighted_era_sharpen", "weighted_mean")):
    """K1, K2 and K2's weighted mean (``names`` of them) at (K, N, C) in
    ``dtype`` (``es`` the module of ``kernels/era_sharpen.py`` of the tree
    under test): each checked against its plain version at atol 1e-6 (f32)
    or 5e-3 (bf16), then timed by stream events (``ms``, the
    host's launch rate at small shapes), by a CUDA graph on one input
    (``graph_ms``, hot: the input stays in the L2 cache) and by a CUDA graph
    cycling over copies larger together than the L2 cache (``graph_cold_ms``,
    what the bound is about).  The weighted mean also times its one-call
    yardstick ``torch.mv(p.view(K, N*C).t(), w)`` the same three ways, and
    K1's row the graph time of zeroing the (N, C) output (``fill_graph_ms``:
    what the smallest kernel costs a launch in a graph)."""
    p = _probs((K, N, C), seed, dtype)
    w = _weights(K, seed + 1)
    copies = [c for (c,) in cold_copies(p)]
    elt = p.element_size()
    atol = 1e-6 if dtype == torch.float32 else 5e-3
    n_in, n_out = K * N * C * elt, N * C * 4
    bounds = {"era_sharpen": bound_ms(n_in + n_out,
                                      K * N * C + 5 * N * C),
              "weighted_era_sharpen": bound_ms(n_in + K * 4 + n_out,
                                            2 * K * N * C + 5 * N * C),
              "weighted_mean": bound_ms(n_in + K * 4 + n_out,
                                        2 * K * N * C)}
    rows = {}
    dname = str(dtype).removeprefix("torch.")
    for name, (kern, plain) in era_calls(es, p, w).items():
        if name not in names:
            continue
        err = check(f"{name} {(K, N, C)} {dname}", kern(), plain(), atol)
        cold = [era_calls(es, c, w)[name][0] for c in copies]
        b, by = bounds[name]
        rows[name] = dict(
            source="src/repro_torch/csrc/era_sharpen.cu",
            replaces="src/repro/kernels/era_sharpen.py:" +
            ("68" if name == "era_sharpen" else "113"),
            max_abs_err=err, ms=time_ms(kern), graph_ms=graph_ms(kern),
            graph_cold_ms=graph_ms(cold), plain_ms=time_ms(plain),
            bound_ms=b, bound_by=by, library_ms=None, shape=[K, N, C],
            dtype=dname, cold_copies=len(copies),
            plan=str(es.launch_plan(K, N, C, dtype)))
    # the floor of a launch in a graph: the smallest kernel on the output
    if "era_sharpen" in rows:
        fill = torch.empty((N, C), device="cuda")
        rows["era_sharpen"]["fill_graph_ms"] = graph_ms(fill.zero_)
        del fill
    if "weighted_mean" in rows and dtype == torch.float32:
        lib = lambda q: (lambda: torch.mv(q.view(K, N * C).t(), w))
        rows["weighted_mean"].update(
            library_ms=time_ms(lib(p)), library_graph_ms=graph_ms(lib(p)),
            library_graph_cold_ms=graph_ms([lib(c) for c in copies]))
    del copies
    torch.cuda.empty_cache()
    return rows


def check_era(es):
    """K1/K2 against their plain versions (phase 3): every K in (1, 3), N in
    (1, 13, 100) (ragged tail tiles) and C in (2, 10, 46, 151, 32768), f32 at
    atol 1e-6 and bf16 at 5e-3 (C = 151 in bf16 takes 2-byte loads: its
    rows are not 4-byte aligned); zero-weight clients of +-1e30 rows change
    no bit of K2 or of its weighted mean, also spread over the client
    slices at the round's shape; K2 and its weighted mean at the cohort
    plane's slab shapes, (80, 1000, 10) with 60 lanes of weight 0 and (800,
    200, 10) with 600, at atol 1e-6; two launches on one input give the
    same bits; the wrappers raise, launching nothing, on what the kernel does not
    take."""
    from repro_torch.kernels import _build
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 5e-3)):
        for C in (2, 10, 46, 151, 32768):
            worst = 0.0
            for K in (1, 3):
                for N in (1, 13, 100):
                    p = _probs((K, N, C), K * N + C, dtype)
                    for name, (kern, plain) in era_calls(
                            es, p, _weights(K, N, zeros=())).items():
                        out, exp = kern(), plain()
                        torch.cuda.synchronize()
                        err = max_err(out, exp)
                        worst = max(worst, err)
                        if out.shape != (N, C) or not close(out, exp, atol, 0):
                            fail(f"{name} {(K, N, C)} {dtype}: max_abs_err "
                                 f"{err:.3e} above {atol}")
            plan = es.launch_plan(3, 100, C, dtype)
            say(f"check K1/K2/weighted mean, K in (1, 3), N in (1, 13, 100),"
                f" C={C} {dtype}: max_abs_err={worst:.3e} atol={atol} ok "
                f"(plan at K=3, N=100: {plan})")
    for shape, zeros in (((4, 9, 12), (0, 3)),
                         ((100, 1000, 10), (0, 5, 6, 7, 50, 99))):
        p = _probs(shape, 4)
        garbage = p.clone()
        for i, z in enumerate(zeros):
            garbage[z] = 1e30 if i % 2 == 0 else -1e30
        w = _weights(shape[0], 5, zeros)
        for name in ("weighted_era_sharpen", "weighted_mean"):
            a = era_calls(es, p, w)[name][0]()
            b = era_calls(es, garbage, w)[name][0]()
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name} {shape}: a zero-weight client of +-1e30 rows "
                     f"changed the output bits")
        say(f"check K2 and weighted mean {shape}, clients {zeros} of weight "
            f"0 holding +-1e30: output bitwise equal ok")
    # the cohort plane's K2 shapes: slabs whose absent lanes carry weight 0,
    # sim (c)'s 80 lanes with 20 live and sim (b)'s 800 with 200 live
    for (K, N, C), live in (((80, 1000, 10), 20), ((800, 200, 10), 200)):
        p = _probs((K, N, C), K)
        zeros = [k for k in range(K) if k % (K // live)]
        w = _weights(K, K + 1, zeros)
        for name in ("weighted_era_sharpen", "weighted_mean"):
            kern, plain = era_calls(es, p, w)[name]
            check(f"{name} {(K, N, C)} f32, {len(zeros)} lanes of weight 0 "
                  f"(plan {es.launch_plan(K, N, C)})", kern(), plain(), 1e-6)
    p, w = _probs((100, 1000, 10), 6), _weights(100, 7)
    for name, (kern, _) in era_calls(es, p, w).items():
        a, b = kern(), kern()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"{name}: two launches on one input differ")
    say("check K1/K2/weighted mean (100,1000,10): two launches bitwise equal ok")
    before = dict(_build.LAUNCHES)
    refused = (("float64", lambda: es.era_sharpen(p.double(), 0.1)),
               ("not contiguous", lambda: es.era_sharpen(p.transpose(1, 2),
                                                         0.1)),
               ("weights (99,)", lambda: es.weighted_era_sharpen(p, w[:99])),
               ("float64 weights", lambda: es.weighted_era_sharpen(
                   p, w.double())))
    for what, call in refused:
        try:
            call()
        except ValueError:
            continue
        fail(f"K1/K2: the wrapper took {what} instead of raising")
    if dict(_build.LAUNCHES) != before:
        fail("K1/K2: a refused call launched a kernel")
    say(f"check K1/K2 wrappers raise, launching nothing: "
        f"{', '.join(w for w, _ in refused)} ok")
    # two-level ERA's edge partials are K2's weighted mean on row-offset
    # views: at (7, 13, 10) in 3 edges the shards 3 and 5 clients in start
    # 8 bytes past a 16-byte boundary and must take narrower loads
    from repro_torch.core.hierarchy import edge_shards
    p, w = _probs((7, 13, 10), 14), _weights(7, 15)
    aligns = []
    for start, end in edge_shards(7, 3):
        shard, ws = p[start:end], w[start:end].contiguous()
        ptr = shard.data_ptr()
        aligns.append(min(ptr & -ptr, 256))
        check(f"weighted mean on edge shard [{start}, {end}) of (7, 13, 10) "
              f"f32, pointer {aligns[-1]}-byte aligned, plan "
              f"{es.launch_plan(end - start, 13, 10, torch.float32, aligns[-1])}",
              es.weighted_era_sharpen(shard, ws, sharpen=False),
              es.weighted_era_sharpen_plain(shard, ws, sharpen=False), 1e-6)
    if min(aligns) >= 16:
        fail("K2 edge shards: no shard started off a 16-byte boundary")
    check_era_wide(es)


def _peaked(shape, seed, dtype=torch.float32):
    """Probabilities with one class of 0.9 a row that every client agrees
    on (the rest 0.1 of `_probs`), so the T = 0.1 softmax over a
    vocabulary-wide row is not flat (its largest value about 0.05 at C =
    151,936) and atol 1e-6 is a check of the values."""
    K, N, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    hot = torch.randint(0, C, (N,), generator=g, device="cuda")
    p = 0.1 * _probs(shape, seed)
    p[:, torch.arange(N, device="cuda"), hot] += 0.9
    return p.to(dtype)


def check_era_wide(es):
    """K1/K2 on the wide-row route (phase 3): C in WIDE_C, each past what a
    block's shared memory holds (the first of them the wrapper refused
    before the route), K in (1, 3) x N in (1, 13, 100), f32 at atol 1e-6
    and bf16 at 5e-3, on `_probs`'s rows and on `_peaked`'s; at C =
    151,936 zero-weight clients of +-1e30 rows change no bit of K2 or of
    its weighted mean, and two launches give the same bits."""
    if WIDE_C[0] != es.SMEM_BYTES // 4 + 1:
        fail(f"wide route: the first checked C {WIDE_C[0]} is not the first "
             f"past the narrow route, {es.SMEM_BYTES // 4 + 1}")
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 5e-3)):
        for C in WIDE_C:
            worst, top = 0.0, 0.0
            for K in (1, 3):
                for N in (1, 13, 100):
                    if not es.launch_plan(K, N, C, dtype).wide:
                        fail(f"K1/K2 {(K, N, C)} {dtype}: not the wide route")
                    for make in (_probs, _peaked):
                        p = make((K, N, C), K * N + C, dtype)
                        for name, (kern, plain) in era_calls(
                                es, p, _weights(K, N, zeros=())).items():
                            out, exp = kern(), plain()
                            torch.cuda.synchronize()
                            err = max_err(out, exp)
                            worst = max(worst, err)
                            if name != "weighted_mean":
                                top = max(top, float(exp.max()))
                            if (out.shape != (N, C)
                                    or not close(out, exp, atol, 0)):
                                fail(f"{name} wide {(K, N, C)} {dtype} "
                                     f"({make.__name__}): max_abs_err "
                                     f"{err:.3e} above {atol}")
                        del p
            say(f"check K1/K2/weighted mean wide route, K in (1, 3), N in "
                f"(1, 13, 100), C={C} {dtype}, flat and peaked rows (largest"
                f" sharpened value {top:.3g}): max_abs_err={worst:.3e} atol={atol} ok "
                f"(plan at K=3, N=100: {es.launch_plan(3, 100, C, dtype)})")
    C = 151_936
    for dtype in (torch.float32, torch.bfloat16):
        p = _peaked((3, 13, C), 8, dtype)
        garbage = p.clone()
        garbage[0], garbage[2] = 1e30, -1e30
        w = _weights(3, 9, (0, 2))
        for name in ("weighted_era_sharpen", "weighted_mean"):
            kern = era_calls(es, p, w)[name][0]
            a, b = kern(), kern()
            c = era_calls(es, garbage, w)[name][0]()
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name} wide (3, 13, {C}) {dtype}: two launches differ")
            if not torch.equal(a, c):
                fail(f"{name} wide (3, 13, {C}) {dtype}: a zero-weight "
                     f"client of +-1e30 rows changed the output bits")
        a, b = es.era_sharpen(p, 0.1), es.era_sharpen(p, 0.1)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"era_sharpen wide (3, 13, {C}) {dtype}: two launches differ")
        say(f"check K2 and weighted mean wide (3, 13, {C}) {dtype}, clients "
            f"(0, 2) of weight 0 holding +-1e30: output bitwise equal; K1, K2"
            f" and weighted mean: two launches bitwise equal ok")
        del p, garbage
    torch.cuda.empty_cache()


def k3_plan(dl, z, t):
    """The launch plan K3's wrapper picks for (z, t), or None for a tree
    whose K3 takes no plan."""
    if not hasattr(dl, "launch_plan"):
        return None
    from repro_torch.kernels import _build
    return dl.launch_plan(*z.shape, z.dtype, dl.pointer_align(z, t),
                          _build.sm_count(z.device))


def k3_timing(dl, N, V, dtype, seed, atol):
    """K3 at (N, V) (``dl`` the module of ``kernels/distill_loss.py`` of the
    tree under test): checked against its plain version at ``atol`` and
    rtol 1e-3, its error against float64 measured beside the plain
    version's (``float64_err``, ``plain_float64_err``; the caller holds
    the one to twice the other), two launches bitwise equal, then timed by
    stream events
    (``ms``), by a CUDA graph on one input (``graph_ms``, hot where it fits
    the L2 cache) and by a CUDA graph cycling over copies larger together
    than the L2 cache (``graph_cold_ms``, what the bound is about); the
    library call ``F.cross_entropy(z, t, reduction="none")`` the same three
    ways.  Returns the record and (z, t, plain logZ, the cold copies)."""
    import torch.nn.functional as F
    z, t = _zt(N, V, seed, dtype)
    label = f"({N},{V}) {str(dtype).replace('torch.', '')}"
    plan = k3_plan(dl, z, t)
    loss, logz = dl.distill_loss_fwd(z, t)
    ploss, plogz = dl.distill_loss_fwd_plain(z, t)
    err = max(check(f"K3 distill_loss_fwd {label}", loss, ploss, atol, 1e-3),
              check(f"K3 logZ {label}", logz, plogz, atol, 1e-3))
    del ploss
    ek, ep = k3_float64_error(dl, z, t, label)
    again = dl.distill_loss_fwd(z, t)
    torch.cuda.synchronize()
    if not (torch.equal(loss, again[0]) and torch.equal(logz, again[1])):
        fail(f"K3 {label}: two launches on one input differ")
    say(f"check K3 {label}: two launches bitwise equal ok (plan {plan})")
    pairs = cold_copies(z, t)
    nv = N * V
    b, by = bound_ms(2 * nv * z.element_size() + 2 * N * 4, 6 * nv)
    k3 = lambda z_, t_: (lambda: dl.distill_loss_fwd(z_, t_))
    lib = lambda z_, t_: (lambda: F.cross_entropy(z_, t_, reduction="none"))
    rec = dict(max_abs_err=err, ms=time_ms(k3(z, t)),
               graph_ms=graph_ms(k3(z, t)),
               graph_cold_ms=graph_ms([k3(*p) for p in pairs]),
               plain_ms=time_ms(lambda: dl.distill_loss_fwd_plain(z, t)),
               bound_ms=b, bound_by=by, library_ms=time_ms(lib(z, t)),
               library_graph_ms=graph_ms(lib(z, t)),
               library_graph_cold_ms=graph_ms([lib(*p) for p in pairs]),
               shape=[N, V], dtype=label.split()[-1], cold_copies=len(pairs),
               plan=None if plan is None else str(plan), float64_err=ek,
               plain_float64_err=ep)
    return rec, (z, t, plogz, pairs)


def _loss_float64(z, t):
    z, t = z.double(), t.double()
    m = z.amax(dim=-1, keepdim=True)
    lz = (m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True)))[:, 0]
    return t.sum(dim=-1) * lz - (t * z).sum(dim=-1), lz


def k3_float64_error(dl, z, t, label):
    """K3's and the plain version's largest error in loss and logZ against
    float64, printed; K3's may be at most twice the plain version's.  That
    catches an element left out of a row (a head, a tail, a vector: about
    16/V on the loss), which atol 1e-4, rtol 1e-3 alone passes
    (tests/test_torch_distill_plan.py)."""
    exact = _loss_float64(z, t)
    errs = []
    for out in (dl.distill_loss_fwd(z, t), dl.distill_loss_fwd_plain(z, t)):
        errs.append(max(float((o.double() - e).abs().max())
                        for o, e in zip(out, exact)))
    del exact
    say(f"K3 {label} error against float64: kernel {errs[0]:.3e}, plain "
        f"{errs[1]:.3e} (at most twice: "
        f"{'ok' if errs[0] <= 2 * errs[1] else 'FAIL'})")
    return errs


def check_k3_edges(dl):
    """K3 at rows the main shapes do not reach, each against its plain
    version and against float64 (at most twice the plain version's error):
    one row of 151,936 values; three of 50,001; views at row offsets (V
    odd: no row starts on 16 bytes; t shares z's phase); bf16 rows of V =
    8k + 1; short rows.  Then a plan whose 16-byte loads the pointers do
    not allow, given to the C entry, is refused without a launch, and the
    wrapper's own plan for those pointers is right."""
    from repro_torch.kernels import _build
    cases = []
    for N, V, dtype, off in ((1, 151_936, torch.float32, 0),
                             (3, 50_001, torch.float32, 0),
                             (37, 4097, torch.float32, 1),
                             (64, 50_001, torch.float32, 3),
                             (16, 151_937, torch.bfloat16, 1),
                             (40, 1025, torch.bfloat16, 5),
                             (100, 64, torch.float32, 1),
                             (9, 1, torch.float32, 1)):
        zb, tb = _zt(N + off, V, 12, dtype)
        z, t = zb[off:], tb[off:]
        label = f"({N},{V}) {str(dtype).replace('torch.', '')} {off} rows in"
        loss, logz = dl.distill_loss_fwd(z, t)
        ploss, plogz = dl.distill_loss_fwd_plain(z, t)
        atol = 1e-4 if dtype == torch.float32 else 2e-2
        check(f"K3 {label}, plan {k3_plan(dl, z, t)}",
              torch.stack([loss, logz]), torch.stack([ploss, plogz]), atol,
              1e-3)
        ek, ep = k3_float64_error(dl, z, t, label)
        if ek > 2 * ep:
            fail(f"K3 {label}: float64 error above twice the plain version's")
        cases.append((N, V))
    z, _ = _zt(64, 4097, 13, torch.float32)
    tb = torch.softmax(torch.randn(64 * 4097 + 1, device="cuda"), 0)
    t = tb[1:].view(64, 4097)                # 4 bytes off z's phase
    plan = dl.launch_plan(64, 4097)          # 16-byte loads
    loss = torch.full((64,), 7.0, device="cuda")
    logz = torch.full((64,), 7.0, device="cuda")
    before = dict(_build.LAUNCHES)
    err = dl._lib().distill_loss_fwd(
        _build.ptr(z), _build.ptr(t), _build.ptr(loss), _build.ptr(logz), 64,
        4097, 0, *plan.args(), _build.stream_of(z))
    torch.cuda.synchronize()
    if err == 0:
        fail("K3: a plan of 16-byte loads on pointers 4 bytes apart ran")
    if not (bool((loss == 7.0).all()) and bool((logz == 7.0).all())):
        fail("K3: a refused plan wrote its outputs")
    if dict(_build.LAUNCHES) != before:
        fail("K3: a refused plan counted a launch")
    label = f"(64,4097) t 4 bytes off, plan {k3_plan(dl, z, t)}"
    check(f"K3 {label}", dl.distill_loss_fwd(z, t)[0],
          dl.distill_loss_fwd_plain(z, t)[0], 1e-4, 1e-3)
    ek, ep = k3_float64_error(dl, z, t, label)
    if ek > 2 * ep:
        fail(f"K3 {label}: float64 error above twice the plain version's")
    say(f"check K3 edges: {cases} and views at row offsets, against the "
        "plain version and float64; a misaligned plan refused without a "
        "launch ok")


def distill_autograd_peak(ops, z, t) -> int:
    """Device memory the autograd route (K3 forward, K4 backward, through
    ``ops.distill_loss_2d``) takes above its inputs, the gradient
    included."""
    zr = z.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.distill_loss_2d.apply(zr, t).backward()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def dz_tol(N, dtype):
    """K4's tolerance: the reference's 1e-6 in f32; in bf16 every |dz| is at
    most 1/N, so atol 1e-6/N, and rtol 1e-2 for one bf16 step (2^-7)."""
    return (1e-6, 0.0) if dtype == torch.float32 else (1e-6 / N, 1e-2)


def ce_backward_timing(z, t, pairs, tol):
    """K4's library yardstick: the backward of ``F.cross_entropy(z, t)``
    with probability targets (mean over rows), which computes (softmax(z)
    * sum(t) - t) * g / N, K4's function.  Its forward runs outside the
    timed window (once an input, on the stream the graphs capture on) and
    the backward is timed alone, by stream events, from a graph on one
    input and from a graph cycling over ``pairs``; its gradient's distance
    from K4's plain version is reported beside K4's tolerance ``tol``."""
    import torch.nn.functional as F
    from repro_torch.kernels import distill_loss as dl
    side = _capture_stream()

    def backward_of(z_, t_):
        zr = z_.detach().requires_grad_(True)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loss = F.cross_entropy(zr, t_)
        torch.cuda.current_stream().wait_stream(side)
        return lambda: torch.autograd.grad(loss, zr, retain_graph=True)[0]

    one = backward_of(z, t)
    _, plogz = dl.distill_loss_fwd_plain(z, t)
    exp = dl.distill_loss_bwd_plain(
        z, t, plogz, t.float().sum(-1),
        torch.full((1,), 1.0 / z.shape[0], device="cuda"))
    got = one()
    torch.cuda.synchronize()
    err = max_err(got, exp)
    say(f"check K4's yardstick F.cross_entropy backward {tuple(z.shape)} "
        f"{z.dtype}: max_abs_err={err:.3e} from K4's plain version "
        f"({'within' if close(got, exp, *tol) else 'outside'} K4's "
        f"tolerance {tol})")
    del got, exp, plogz
    rec = dict(library_ms=time_ms(one), library_graph_ms=graph_ms(one),
               library_max_abs_err=err)
    cold = [backward_of(*p) for p in pairs]
    rec["library_graph_cold_ms"] = graph_ms(cold)
    del cold, one
    return rec


def k34_timing(dl, N, V, dtype, seed, atol_f, tol_b):
    """K3 (`k3_timing`, its float64 error held to twice the plain
    version's) and K4 at (N, V) in ``dtype``: K4 checked against its plain
    version at ``tol_b`` (which must not pass a zeroed dz), then timed as
    K3, with the backward of ``F.cross_entropy`` as its yardstick.
    Returns the two records."""
    fwd, (z, t, plogz, pairs) = k3_timing(dl, N, V, dtype, seed, atol_f)
    label = f"({N},{V}) {fwd['dtype']}"
    if fwd["float64_err"] > 2 * fwd["plain_float64_err"]:
        fail(f"K3 {label}: float64 error above twice the plain version's")
    tmass = t.float().sum(-1)
    gscale = torch.full((1,), 1.0 / N, device="cuda")
    dz_plain = dl.distill_loss_bwd_plain(z, t, plogz, tmass, gscale)
    eb = check(f"K4 distill_loss_bwd {label}",
               dl.distill_loss_bwd(z, t, plogz, tmass, gscale), dz_plain,
               *tol_b)
    if close(torch.zeros_like(dz_plain), dz_plain, *tol_b):
        fail(f"K4 {label}: the tolerance would pass a zeroed dz")
    del dz_plain
    bb, byb = bound_ms(3 * N * V * z.element_size() + 2 * N * 4 + 4,
                       5 * N * V)
    k4 = lambda z_, t_: (lambda: dl.distill_loss_bwd(z_, t_, plogz, tmass,
                                                     gscale))
    bwd = dict(max_abs_err=eb, ms=time_ms(k4(z, t)),
               graph_ms=graph_ms(k4(z, t)),
               graph_cold_ms=graph_ms([k4(*p) for p in pairs]),
               plain_ms=time_ms(lambda: dl.distill_loss_bwd_plain(
                   z, t, plogz, tmass, gscale)),
               bound_ms=bb, bound_by=byb,
               shape=[N, V], dtype=fwd["dtype"], cold_copies=len(pairs))
    bwd.update(ce_backward_timing(z, t, pairs, tol_b))
    del pairs
    torch.cuda.empty_cache()
    return fwd, bwd


def say_timing(name, r):
    """One ``timing`` line of a kernel's record."""
    say(f"timing {name} {r['shape']} {r['dtype']}: ms={r['ms']:.5f} " +
        "".join(f"{k}={r[k]:.5f} ({r['bound_ms'] / r[k]:.1%} of the "
                f"bound) " for k in ("graph_ms", "graph_cold_ms")
                if k in r) +
        f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
        f"({r['bound_by']}) library_ms={r['library_ms']}" +
        "".join(f" {k}={r[k]:.5f}" for k in ("library_graph_ms",
                                              "library_graph_cold_ms",
                                              "fill_graph_ms")
                if k in r))


def phase_kernels_and_timing():
    """Checks (phase 3) and timings (phase 4) of K1-K4.  Returns one record
    per kernel at the main path's shape, plus extra timing rows."""
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import era_sharpen as es
    from repro_torch.kernels import ops

    recs, extra = {}, []

    # K1 / K2 ---------------------------------------------------------------
    check_era(es)
    for i, shape in enumerate(ERA_SHAPES):
        rows = era_timing(es, *shape, seed=1 + i)
        if i == 0:
            recs["era_sharpen"] = rows["era_sharpen"]
            recs["weighted_era_sharpen"] = dict(
                rows["weighted_era_sharpen"],
                weighted_mean=rows["weighted_mean"])
            extra.append(dict(name="weighted_mean", **rows["weighted_mean"]))
        else:
            extra += [dict(name=k, **r) for k, r in rows.items()]
    wide = []
    for i, (shape, dtype, names) in enumerate(WIDE_TIMING):
        rows = era_timing(es, *shape, seed=11 + i, dtype=dtype, names=names)
        wide += [dict(name=k, **r) for k, r in rows.items()]
    for r in wide:
        key = ("weighted_era_sharpen" if r["name"] == "weighted_mean"
               else r["name"])
        recs[key].setdefault("wide", []).append(r)
    extra += wide

    # K3 / K4 ---------------------------------------------------------------
    for i, (N_, V_, dt) in enumerate(K3_SHAPES):
        atol_f = 1e-4 if dt == torch.float32 else 2e-2
        f_, b_ = k34_timing(dl, N_, V_, dt, 5 + i, atol_f, dz_tol(N_, dt))
        if (N_, V_, dt) == K3_MAIN:
            recs["distill_loss_fwd"] = dict(
                source="src/repro_torch/csrc/distill_loss.cu",
                replaces="src/repro/kernels/distill_loss.py:74", **f_)
            recs["distill_loss_bwd"] = dict(
                source="src/repro_torch/csrc/distill_loss.cu",
                replaces="src/repro/kernels/distill_loss.py:98", **b_)
        else:
            extra += [dict(name="distill_loss_fwd", **f_),
                      dict(name="distill_loss_bwd", **b_)]
    check_k3_edges(dl)
    z, t = _zt(*K3_SHAPES[2][:2], 9, K3_SHAPES[2][2])
    peak = distill_autograd_peak(ops, z, t)
    say(f"K3/K4 autograd route (ops.distill_loss_2d) {tuple(z.shape)} "
        f"{t.dtype}: peak {peak} B above its inputs")
    recs["distill_loss_fwd"]["autograd_peak_bytes"] = peak
    del z, t
    torch.cuda.empty_cache()
    for name, r in list(recs.items()) + [(e["name"], e) for e in extra]:
        say_timing(name, r)
    # the yardsticks' cuBLAS calls leave a workspace on each stream they ran
    # on; free them (where this torch exposes it), so the rounds' peak memory
    # counts the port alone
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    return recs, extra


def _ssd_inputs(M, Q, H, P, G, N, seed, bc_scale=None, dtype=torch.float32):
    """K5's inputs on the card: x normal; dt = softplus(normal) and dA =
    -0.3 dt, as the reference's kernel tests draw them; B and C normal times
    ``bc_scale``, by default N^-1/4, so the scores C.B have unit variance at
    every N (the reference's tests, at N <= 16, have scores of variance N;
    the model's own scores are about 0.1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    s = N ** -0.25 if bc_scale is None else bc_scale
    x = rn(M, Q, H, P)
    dt = torch.nn.functional.softplus(rn(M, Q, H))
    out = x, dt, -0.3 * dt, rn(M, Q, G, N) * s, rn(M, Q, G, N) * s
    return tuple(t.to(dtype) for t in out)


def _ssd_float64(x, dt, dA, Bm, Cm):
    """K5's function in float64, head by head (the oracle of the accuracy
    report)."""
    x, dt, dA, Bm, Cm = (t.double() for t in (x, dt, dA, Bm, Cm))
    H, G, Q = x.shape[2], Bm.shape[2], x.shape[1]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    y = torch.empty_like(x)
    for h in range(H):
        g = h // (H // G)
        cum = torch.cumsum(dA[:, :, h], dim=1)                    # (M, Q)
        L = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
            ~causal, float("-inf")))
        W = torch.einsum("mqn,mkn->mqk", Cm[:, :, g], Bm[:, :, g]) * L \
            * dt[:, None, :, h]
        y[:, :, h] = torch.einsum("mqk,mkp->mqp", W, x[:, :, h])
    return y


def k5_bound(M, Q, H, P, G, N):
    """Bytes: x, dt, dA, B, C read once and y written once.  Operations:
    the scores C.B are shared by the H/G heads of a group, so per (chunk,
    group) the causal pairs i >= j each take N multiply-adds for them; per
    (chunk, head) each pair takes P multiply-adds for the product with x
    (products), and four operations for exp(cum_i - cum_j), dt and the
    scaling, plus the cumsum (elementwise).  The products held to fp32
    accuracy on the tensor cores take three TF32 products each (3xTF32).
    Returns that bound, what bounds it, and the bound with every operation
    at the fp32 rate outside the tensor cores."""
    nbytes = 4 * (2 * M * Q * H * P + 2 * M * Q * H + 2 * M * Q * G * N)
    pairs = Q * (Q + 1) // 2
    products = M * pairs * 2 * (G * N + H * P)
    elementwise = M * H * (pairs * 4 + Q)
    b, by = bound_ms(nbytes, elementwise, 3 * products)
    return b, by, bound_ms(nbytes, products + elementwise)[0]


def phase_k5():
    """K5 against its plain version at the serving path's shapes (phase 3)
    and its timing at the (4, 2048) prefill's shape (phase 4)."""
    from repro_torch.kernels import ssd_chunk as ssd
    lib = ssd._lib()
    err_main = 0.0
    for i, (label, shape) in enumerate(K5_SHAPES):
        M, Q, H, P, G, N = shape
        plan = ssd.launch_plan(M, Q, H, G, N, torch.cuda.get_device_properties(
            0).multi_processor_count)
        smem = lib.ssd_chunk_smem_bytes(Q, N, plan.heads_per_block)
        say(f"K5 plan {shape}: {plan}; kernel's shared memory {smem} B")
        if smem != plan.smem_bytes:
            fail(f"K5 {label}: the kernel needs {smem} B of shared memory, "
                 f"the wrapper's plan {plan.smem_bytes}")
        args = _ssd_inputs(*shape, seed=20 + i)
        out, exp = ssd.ssd_chunk(*args), ssd.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            fail(f"K5 {label}: non-finite output")
        err = check(f"K5 ssd_chunk {label} {shape} f32", out, exp, K5_TOL,
                    K5_TOL)
        if i == 0:
            err_main = err
            if close(torch.zeros_like(exp), exp, K5_TOL, K5_TOL):
                fail("K5: the tolerance would pass a zeroed y")
    # accuracy at unit-normal B and C (scores of std sqrt(N) = 11.3), where
    # fp32 rounding in any order reaches 1e-4: both versions against float64
    raw = _ssd_inputs(*K5_MAIN, seed=21, bc_scale=1.0)
    exact = _ssd_float64(*raw)
    e_k = float((ssd.ssd_chunk(*raw).double() - exact).abs().max())
    e_p = float((ssd.ssd_chunk_plain(*raw).double() - exact).abs().max())
    say(f"accuracy K5 {K5_MAIN} at unit-normal B, C (max |y| "
        f"{float(exact.abs().max()):.4g}): largest error against float64 "
        f"{e_k:.3e} (kernel), {e_p:.3e} (plain version)")
    if not e_k <= 2 * e_p:
        fail(f"K5: error against float64 {e_k:.3e}, above twice the plain "
             f"version's {e_p:.3e}")
    del raw, exact
    def timed(shape, seed):
        """Stream events, a graph on one input and a graph cycling over
        copies larger together than the L2 cache."""
        args = _ssd_inputs(*shape, seed=seed)
        b, by, b32 = k5_bound(*shape)
        k5 = lambda a: (lambda: ssd.ssd_chunk(*a))
        copies = cold_copies(*args)
        r = dict(ms=time_ms(k5(args)), graph_ms=graph_ms(k5(args)),
                 graph_cold_ms=graph_ms([k5(c) for c in copies]),
                 plain_ms=time_ms(lambda: ssd.ssd_chunk_plain(*args),
                                  iters=20),
                 bound_ms=b, bound_by=by, fp32_bound_ms=b32, library_ms=None,
                 shape=list(shape), dtype="float32", cold_copies=len(copies))
        del copies
        say(f"timing ssd_chunk {r['shape']} float32: ms={r['ms']:.5f} " +
            "".join(f"{k}={r[k]:.5f} ({b / r[k]:.1%} of the bound) "
                    for k in ("graph_ms", "graph_cold_ms")) +
            f"plain_ms={r['plain_ms']:.5f} bound_ms={b:.5f} ({by}; "
            f"{b / r['ms']:.1%} of it) fp32_bound_ms={b32:.5f} (every "
            f"operation at the fp32 rate; {b32 / r['ms']:.1%} of it) "
            f"library_ms=none (no single PyTorch call computes it)")
        torch.cuda.empty_cache()
        return r

    rec = dict(source="src/repro_torch/csrc/ssd_chunk.cu",
               replaces="src/repro/kernels/ssd_chunk.py:48",
               max_abs_err=err_main, float64_err=e_k, float64_err_plain=e_p,
               **timed(K5_MAIN, 20))
    # the LLM round's prediction: one client's open batch, Q = seq = 128
    rec["llm_shape_timing"] = timed(LLM_K5, 22)
    # the same on a rank's 40 of the 80 heads (phase "tp")
    rec["tp_rank_shape_timing"] = timed(TP_K5, 23)
    return rec


def _serving_model(arch: str, n_values: int):
    """``arch`` at its full widths and depth in its dtype, seeded on the
    card; its parameter count must be ``n_values``."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models.api import model_init
    from repro_torch.models.base import param_count
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = model_init(cfg, generator("cuda", 0), "cuda")
    torch.cuda.synchronize()
    n = param_count(params)
    if cfg.arch_type == "ssm":
        shape = (f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
                 f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    else:
        shape = (f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads} KV "
                 f"heads, d_ff {cfg.d_ff} ({cfg.act}), " +
                 (f"RoPE theta {cfg.rope_theta:g}" if cfg.pos_embed == "rope"
                  else f"{cfg.pos_embed} positions") +
                 f", QKV bias {cfg.qkv_bias}")
        if cfg.arch_type == "vlm":
            shape += f", {cfg.n_patches} patches"
        if cfg.arch_type == "audio":
            shape += (f", {cfg.enc_layers} encoder layers over "
                      f"{cfg.n_audio_frames} frames")
    say(f"serve: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} layers, "
        f"{shape}, vocab {cfg.vocab}, {cfg.dtype}: {n} values, "
        f"{sum(v.numel() * v.element_size() for v in params.values())} bytes,"
        f" seeded init in {time.perf_counter() - t0:.1f} s")
    if n != n_values:
        fail(f"{arch} parameter count {n}, expected {n_values}")
    return cfg, params


SERVE_PROMPTS = (2048, 2048, 2048, 2048, 1024, 1030, 256, 40)
SERVE_NEW, SERVE_D1_STEPS = 32, 16
SERVE_ENGINE = dict(slots=8, seq_budget=2112, buckets=(256, 1024, 2048))
QWEN_VALUES = 3_561_413_120         # the reference's init_lm of qwen1.5-4b
QWEN_KV_BYTES = 6_920_601_600       # k and v: 40 x 8 x 2112 x 20 x 128 bf16
# requests of the qwen window served again alone: 1030 tokens (1024
# prefilled, 6 forced through decode), 1024, and 40 (bucket 1, 39 forced)
QWEN_ALONE = (5, 4, 7)


def serve_prompts(vocab):
    """The serving window's prompts (SERVE_PROMPTS long), seeded."""
    g = torch.Generator().manual_seed(5)
    return [tuple(torch.randint(0, vocab, (n,), generator=g).tolist())
            for n in SERVE_PROMPTS]


def _serve_drain(eng, chunk, times=None):
    """Step ``eng`` until it is empty: decode_chunk 1 for the first
    SERVE_D1_STEPS steps, then ``chunk``; the d=1 calls' seconds go to
    ``times``."""
    steps = 0
    while eng.n_active:
        d = 1 if steps < SERVE_D1_STEPS else chunk
        before = eng.n_steps
        t0 = time.perf_counter()
        eng.step(now=float(steps), decode_chunk=d)
        if d == 1 and times is not None:
            times.append(time.perf_counter() - t0)
        steps += eng.n_steps - before


def phase_serve(smi, cfg, params, k5_ms=None, chunk=8, label="serve",
                alone=()):
    """The serving path at full width through ``ServeEngine`` (phase 7 for
    mamba2-2.7b; phase "serve qwen1.5-4b" (a)).  K5 must launch once a
    Mamba layer a prefill shot, nothing else anywhere.  ``alone``: request
    ids served again, each the only request in an engine of the same slots
    (the same decode shapes, so the same kernels), whose greedy tokens must
    equal the window's."""
    from repro_torch.kernels import _build
    from repro_torch.serve import Request, ServeEngine
    dev = params["embed/tok"].device
    prompts = serve_prompts(cfg.vocab)
    reqs = [Request(id=i, tokens=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    eng = ServeEngine(cfg, params, **SERVE_ENGINE, device=dev)
    # warm-up outside the window: cuBLAS handles and the first GEMMs
    eng.insert(Request(id=-1, tokens=prompts[6], max_new_tokens=1))
    eng.pop_completed()
    eng.reset()
    torch.cuda.synchronize()

    shots, t_shot = [], time.perf_counter
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    shots_before = eng.n_prefill_shots
    _build.reset_launches()                       # the serving path's window
    t_start = t_shot()
    t0 = t_shot()
    eng.insert_batch(reqs[:4], now=0.0)
    torch.cuda.synchronize()
    shots.append(("insert_batch 4 x 2048", t_shot() - t0))
    for req in reqs[4:]:
        t0 = t_shot()
        eng.insert(req, now=0.0)
        torch.cuda.synchronize()
        n = eng.prefill_len(req.prompt_len)
        shots.append((f"insert {req.prompt_len} (prefill 1 x {n})",
                      t_shot() - t0))
    t_decode = t_shot()
    d1_times = []
    _serve_drain(eng, chunk, d1_times)
    torch.cuda.synchronize()
    t_end = t_shot()
    launches = dict(_build.LAUNCHES)              # end of the window
    peak = torch.cuda.max_memory_allocated()
    done = {r.id: r for r in eng.pop_completed()}
    say(f"launches in the {label} window: {json.dumps(launches)}")

    if sorted(done) != list(range(len(reqs))):
        fail(f"{label}: completed {sorted(done)} of {len(reqs)} requests")
    for r in done.values():
        if len(r.tokens) != SERVE_NEW or not all(0 <= t < cfg.vocab
                                                 for t in r.tokens):
            fail(f"{label}: request {r.id} returned {r.tokens}")
    for k, v in eng.cache.items():
        if not bool(torch.isfinite(v.float()).all()):
            fail(f"{label}: cache leaf {k} is not finite")
    shots_n = eng.n_prefill_shots - shots_before
    if shots_n != 5:
        fail(f"{label}: {shots_n} prefill shots in the window, expected 5")
    k5_want = cfg.n_layers * shots_n if cfg.arch_type == "ssm" else 0
    if launches["ssd_chunk"] != k5_want:
        fail(f"{label}: K5 launched {launches['ssd_chunk']} times in "
             f"{shots_n} prefill shots, not {k5_want}")
    for name in ("era_sharpen", "weighted_era_sharpen", "distill_loss_fwd",
                 "distill_loss_bwd"):
        if launches[name]:
            fail(f"{label}: {name} was launched on the serving path")
    n_gen = sum(len(r.tokens) for r in done.values())
    big_shot = shots[0][1]
    steady = d1_times[1:]
    cache_bytes = sum(v.numel() * v.element_size()
                      for v in eng.cache.values())
    rec = dict(
        device=smi, arch=cfg.name, prompts=list(SERVE_PROMPTS),
        max_new_tokens=SERVE_NEW,
        prefill_shots={k: v * 1e3 for k, v in shots},
        prefill_shots_unit="ms",
        decode_ms_per_step_d1=1e3 * sum(steady) / len(steady),
        decode_steps=eng.n_steps, host_syncs=eng.n_dispatches,
        decode_seconds=t_end - t_decode,
        generated_tokens=n_gen,
        generated_tokens_per_s_decode=n_gen / (t_end - t_decode),
        generated_tokens_per_s_end_to_end=n_gen / (t_end - t_start),
        max_memory_allocated=peak, cache_bytes=cache_bytes,
        launches=launches)
    chunk_s = (t_end - t_decode) - sum(d1_times)
    chunk_steps = eng.n_steps - len(d1_times)
    rec[f"decode_ms_per_step_d{chunk}"] = 1e3 * chunk_s / max(chunk_steps, 1)
    for k, v in shots:
        say(f"{label} [{smi}]: prefill {k}: {v * 1e3:.3f} ms")
    say(f"{label} [{smi}]: decode at 8 slots: "
        f"{rec['decode_ms_per_step_d1']:.3f} ms/step (decode_chunk=1, "
        f"{len(steady)} steady steps), "
        f"{rec[f'decode_ms_per_step_d{chunk}']:.3f} ms/step (decode_chunk="
        f"{chunk}, {chunk_steps} steps)")
    say(f"{label} [{smi}]: {n_gen} generated tokens: "
        f"{rec['generated_tokens_per_s_decode']:.1f} tokens/s over the decode"
        f" phase, {rec['generated_tokens_per_s_end_to_end']:.1f} tokens/s "
        f"from the first insert to the last token")
    say(f"{label} [{smi}]: peak device memory {peak} B; decode cache "
        f"{cache_bytes} B")
    if k5_ms is not None:
        rec["k5_ms_at_main_shape"] = k5_ms
        rec["k5_share_of_4x2048_prefill"] = (k5_ms * cfg.n_layers / 1e3
                                             / big_shot)
        say(f"{label} [{smi}]: K5 share of the (4, 2048) prefill: "
            f"{k5_ms:.4f} ms x {cfg.n_layers} / {big_shot * 1e3:.3f} ms = "
            f"{rec['k5_share_of_4x2048_prefill']:.1%}")
    del eng
    for rid in alone:
        solo = ServeEngine(cfg, params, **SERVE_ENGINE, device=dev)
        solo.insert(reqs[rid])
        _serve_drain(solo, chunk)
        (r,) = solo.pop_completed()
        del solo
        if r.tokens != done[rid].tokens:
            fail(f"{label}: request {rid} ({reqs[rid].prompt_len} tokens) "
                 f"alone gave {r.tokens}, in the window {done[rid].tokens}")
        say(f"{label}: request {rid} ({reqs[rid].prompt_len} tokens) alone "
            f"in an 8-slot engine: the window's {len(r.tokens)} greedy tokens"
            f" ({len(set(r.tokens))} distinct)")
    rec["alone_equal"] = [reqs[rid].prompt_len for rid in alone]
    say(f"{label} " + json.dumps(rec))
    return launches, prompts[:4], rec


def _trace_summary(prof):
    """(device ms, kernels, queue-full markers, top 8 (name, count, device
    ms)) of a profile.  The device time is the sum of the kernels' own
    durations (one stream, so they do not overlap); the profiler's "Command
    Buffer Full" markers (the host waiting on a full launch queue) are
    counted apart.  The top list attributes each kernel to the op that
    launched it, and the port's own kernels (csrc/*.cu, in anonymous
    namespaces) by their own name."""
    from torch.autograd import DeviceType
    full = sum(e.name == "Command Buffer Full" for e in prof.events())
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name != "Command Buffer Full"]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    own = {}
    for e in kernels:
        if e.name.startswith("(anonymous namespace)::"):
            name = e.name.split("::")[1].split("(")[0]
        elif ops:
            continue
        else:                           # no host ops recorded: by kernel
            name = e.name
        c, t = own.get(name, (0, 0.0))
        own[name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    ops += [(k, c, t) for k, (c, t) in own.items()]
    return dev_ms, len(kernels), full, sorted(ops, key=lambda r: -r[2])[:8]


def phase_trace(smi, cfg, params, prompts, label="trace"):
    """Where the serving time goes (after a serving window): a
    ``torch.profiler`` trace of one (4, 2048) prefill shot, 4 decode steps
    at 8 slots with decode_chunk=1, and one chunk of 4; for each, the host
    time, the device time the profiler saw, the idle share and the top
    kernels by device time.  Only the card's activities are recorded: with
    the host's ops too, turning the three traces into events took most of
    the phase's 40 s."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, **SERVE_ENGINE,
                      device=params["embed/tok"].device)
    reqs = [Request(id=i, tokens=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng.insert_batch(reqs)                        # warm: same shapes again
    eng.reset()
    parts = (("prefill 4 x 2048", lambda: eng.insert_batch(reqs)),
             ("4 decode steps, d=1", lambda: [eng.step() for _ in range(4)]),
             ("1 chunk of 4 steps, d=4", lambda: eng.step(decode_chunk=4)))
    out = {}
    for name, fn in parts:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms, n_kernels, n_full, tops = _trace_summary(prof)
        out[name] = dict(
            host_ms=host_ms, device_ms=dev_ms, device_kernels=n_kernels,
            launch_queue_full_markers=n_full,
            idle_share=1 - dev_ms / host_ms if host_ms else None,
            top=[(k[:60], c, t) for k, c, t in tops])
        say(f"{label} [{smi}]: {name}: host {host_ms:.3f} ms, device "
            f"{dev_ms:.3f} ms in {n_kernels} kernels (profiled; idle share "
            f"{out[name]['idle_share']:.1%}; {n_full} launch-queue-full "
            f"markers); top by device ms: " +
            "; ".join(f"{k} x{c} {t:.3f}" for k, c, t in out[name]["top"]))
    if out["prefill 4 x 2048"]["device_ms"] == 0.0:
        say(f"{label}: the profiler saw no device time on this machine")
    say(f"{label} " + json.dumps(out))
    return out


def phase_routes(smi, cfg, params, prompts):
    """The (4, 2048) prefill of the serving weights widened to float32,
    through K5, through its plain version, and through the plain version
    with a 1% fault (phase 8)."""
    from unittest import mock

    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.models.api import model_prefill
    cfg = cfg.replace(dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(9)

    def faulty_plain(*a):
        y = ssd.ssd_chunk_plain(*a)
        sign = torch.randint(0, 2, y.shape, generator=g, device="cuda") * 2 - 1
        return y * (1 + ROUTE_FAULT * sign)

    routes = {"kernel": ssd.ssd_chunk, "plain": ssd.ssd_chunk_plain,
              "1% fault": faulty_plain}
    toks = torch.tensor(prompts, device="cuda")
    out = {}
    for route, fn in routes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(ssd, "ssd_chunk", fn):
            logits, cache = model_prefill(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        say(f"routes [{smi}]: (4, 2048) float32 prefill, {route} route: "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        if not bool(torch.isfinite(logits).all()):
            fail(f"routes: {route} logits are not finite")
        out[route] = dict(cache, logits=logits)
    kern, base, fault = out["kernel"], out["plain"], out["1% fault"]
    report = {k: dict(diff=max_err(kern[k], base[k]),
                      fault=max_err(fault[k], base[k]),
                      max_abs=float(base[k].abs().max())) for k in base}
    lk, lp = kern["logits"], base["logits"]
    top2 = torch.topk(lp, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = torch.argmax(lk, -1) == torch.argmax(lp, -1)
    say(f"routes [{smi}]: float32, 64 layers, largest difference from the "
        f"plain route (kernel route; 1% fault; largest magnitude): " +
        ", ".join(f"{k} {r['diff']:.4g} ({r['fault']:.4g}; {r['max_abs']:.4g})"
                  for k, r in report.items()) +
        f"; greedy first tokens agree {int(agree.sum())}/{agree.numel()} "
        f"(top-2 margins {[round(float(x), 4) for x in margin]}); tolerance "
        f"{ROUTE_RTOL} of the largest magnitude")
    for k, r in report.items():
        if r["diff"] > ROUTE_RTOL * r["max_abs"]:
            fail(f"routes: {k} differ by {r['diff']:.4g}, above {ROUTE_RTOL} "
                 f"of {r['max_abs']:.4g}")
    if all(r["fault"] <= ROUTE_RTOL * r["max_abs"] for r in report.values()):
        fail(f"routes: a {ROUTE_FAULT:.0%} fault in the SSD core passes the "
             f"tolerance, so the check cannot see one")
    decided = margin > 2 * report["logits"]["diff"]
    if bool((decided & ~agree).any()):
        fail("routes: a greedy first token differs where the top-2 margin "
             "exceeds twice the largest logit difference")


def lm_card_vs_cpu(smi, cfg, S, steps, seq_len=None, label="lm card vs cpu",
                   scaled=False):
    """``cfg`` (float32) from one seeded CPU init on the card and on the
    CPU: a (1, S) prefill (ring buffers of ``seq_len``) and ``steps``
    decode steps, the logits and every cache leaf compared after each at
    CARD_VS_CPU_ATOL / RTOL.  The decode step writes its cache in place, so
    each step's cache is cloned before the next.  ``scaled``: the
    embedding scaled as `scale_embedding` does."""
    from repro_torch.models.api import (model_decode_step, model_init,
                                        model_prefill)
    params = model_init(cfg, torch.Generator().manual_seed(1), "cpu")
    if scaled:
        scale_embedding(cfg, params)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, S + steps), generator=g)
    runs = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        t = toks.to(device)
        t0 = time.perf_counter()
        logits, cache = model_prefill(cfg, p, {"tokens": t[:, :S]}, seq_len)
        snap = lambda lg, c: (lg.to("cpu", copy=True),
                              {k: v.to("cpu", copy=True) for k, v in c.items()})
        seen = [snap(logits, cache)]
        for i in range(steps):
            logits, cache = model_decode_step(cfg, p, cache, t[:, S + i],
                                              S + i)
            seen.append(snap(logits, cache))
        say(f"{label}: {device} prefill + {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        runs[device] = seen
        del p, cache
    worst = 0.0
    for step, ((la, ca), (lb, cb)) in enumerate(zip(runs["cuda"],
                                                    runs["cpu"])):
        for name, a, b in [("logits", la, lb)] + [(k, ca[k], cb[k])
                                                  for k in cb]:
            worst = max(worst, max_err(a, b))
            if not close(a, b, CARD_VS_CPU_ATOL, CARD_VS_CPU_RTOL):
                fail(f"{label}: step {step} {name} differs by "
                     f"{max_err(a, b):.3e}")
    say(f"{label} [{smi}]: {cfg.name} d_model {cfg.d_model}, depth "
        f"{cfg.n_layers}, float32: logits and every cache leaf agree after "
        f"the (1, {S}) prefill and each of {steps} decode steps (max diff "
        f"{worst:.3e}; atol {CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL})")
    return worst


def phase_lm_card_vs_cpu(smi):
    """mamba2-2.7b at full width, depth 2, float32: one (1, 512) prefill and
    8 decode steps on the card (K5) and on the CPU (phase 9)."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b").replace(n_layers=2, dtype="float32")
    lm_card_vs_cpu(smi, cfg, 512, 8)


def scale_embedding(cfg, params):
    """Scale the dense family's tied unit-normal embedding by
    d_model^-1/2 in place, as a trained model's rows are (phase "llm"'s
    route check does the same).  At unit scale the residual stream is the
    input token's embedding: greedy decoding repeats one token, so the
    window's comparison with requests served alone is weak, and logits of
    order +-200 come out of d_model-long f32 sums whose rounding (5e-4 at
    d_model 5120) breaks CARD_VS_CPU_ATOL where a logit sits near zero.
    Scaled, logits are of order 1 and every layer moves the residual
    stream."""
    params["embed/tok"].mul_(cfg.d_model ** -0.5)


# the window that phi3-medium-14b's card-vs-CPU copy slides over: its (1,
# 128) prefill keeps the last 120 keys rolled by 128 % 120, and each of its
# 4 decode steps writes over the ring's oldest slot
PHI3_WINDOW = 120


def sdpa_yardstick(smi, B=4, S=2048, H=20, hd=128):
    """The port's chunked attention at the (4, 2048) shot's per-layer shape
    (4, 2048, 20, 128) bf16, causal, with the prefill's chunks of 1024,
    beside ``F.scaled_dot_product_attention`` on the same inputs (a
    yardstick for a later PR; the engine never calls it).  Bound: the
    causal half of the two products' operations at 989 TFLOP/s (bf16 on
    the tensor cores) against q, k, v and the output once over 3.35 TB/s."""
    import torch.nn.functional as F

    from repro_torch.models.attention import flash_attention
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    port = lambda: flash_attention(q, k, v, causal=True, q_chunk=1024,
                                   kv_chunk=1024)
    lib = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    err = max_err(port(), lib())
    if not err <= 3e-2:             # a few bf16 steps of outputs below 1
        fail(f"sdpa yardstick: the port's attention is {err:.3e} from SDPA")
    port_ms, lib_ms = time_ms(port, iters=20), time_ms(lib, iters=20)
    flops = 2 * 2 * B * H * S * S * hd / 2
    nbytes = 4 * B * S * H * hd * 2
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(device=smi, shape=[B, S, H, hd], dtype="bfloat16",
               causal=True, port_chunked_ms=port_ms, sdpa_ms=lib_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=err, speedup_sdpa=port_ms / lib_ms)
    say(f"sdpa yardstick [{smi}]: (4, 2048, 20, 128) bf16 causal: the port's"
        f" chunked attention {port_ms:.3f} ms, F.scaled_dot_product_attention"
        f" {lib_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); max diff {err:.3e}")
    say("sdpa yardstick " + json.dumps(rec))
    return rec


def phase_serve_qwen(smi):
    """Phase "serve qwen1.5-4b": (a) the serving window at full width and
    depth, its trace, and three of its requests alone; the attention
    yardstick; (b) the card against the CPU in float32 at depth 2 and full
    width, qwen1.5-4b and phi3-medium-14b (grouped-query heads, its ring
    wrapped under a sliding window).  (a) and (b) scale the embedding
    (`scale_embedding`)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg, params = _serving_model("qwen1.5-4b", QWEN_VALUES)
    scale_embedding(cfg, params)
    launches, prompts, rec = phase_serve(smi, cfg, params, chunk=16,
                                         label="serve qwen1.5-4b",
                                         alone=QWEN_ALONE)
    if rec["cache_bytes"] != QWEN_KV_BYTES:
        fail(f"serve qwen1.5-4b: ring buffers of {rec['cache_bytes']} B, "
             f"expected {QWEN_KV_BYTES}")
    phase_trace(smi, cfg, params, prompts, label="trace qwen1.5-4b")
    del params
    torch.cuda.empty_cache()
    sdpa_yardstick(smi)
    t1 = time.perf_counter()
    qwen = get_config("qwen1.5-4b").replace(n_layers=2, dtype="float32")
    lm_card_vs_cpu(smi, qwen, 512, 8, label="qwen1.5-4b card vs cpu",
                   scaled=True)
    phi3 = get_config("phi3-medium-14b").replace(
        n_layers=2, dtype="float32", sliding_window=PHI3_WINDOW)
    lm_card_vs_cpu(smi, phi3, 128, 4, seq_len=PHI3_WINDOW,
                   label="phi3-medium-14b card vs cpu", scaled=True)
    torch.cuda.empty_cache()
    say(f"serve qwen1.5-4b: phase took {time.perf_counter() - t0:.1f} s "
        f"((b) {time.perf_counter() - t1:.1f} s)")
    return launches


def _paper_cnn(device):
    from repro_torch.models.smallnets import init_mnist_cnn
    return functools.partial(init_mnist_cnn, image_hw=28, widths=(32, 64),
                             fc=512, device=device)


def _round_draws(seed, K, hp, n_k, n_open, device="cuda"):
    """One DS-FL round's randomness, keyed on ``seed`` (`core.prng`), to
    hand two runs of the same round."""
    from repro_torch.core import prng
    from repro_torch.core.algorithms import RoundDraws
    bs_d = min(hp.batch_size, hp.open_batch)
    ids = torch.arange(K, device=device)
    return RoundDraws(
        o_idx=prng.permutation(seed, 0, "open", 0, n_open, device)[
            :hp.open_batch],
        update_perms=prng.epoch_perms(seed, 0, "update", ids, hp.local_epochs,
                                      n_k, hp.batch_size),
        distill_perms=prng.epoch_perms(seed, 0, "distill", ids,
                                       hp.distill_epochs, hp.open_batch, bs_d),
        server_perms=prng.epoch_perms(seed, 0, "server", ids[:1],
                                      hp.distill_epochs, hp.open_batch,
                                      bs_d)[0])


def timed_round(eng, state, task, kind, **run_kw):
    """One round through ``eng.run``, on the host clock around a
    synchronize: its history record with the seconds, the peak device
    memory and each kernel's launches in the round.  Fails on a metric
    that is not finite."""
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = eng.run(state, task, rounds=1, **run_kw)
    torch.cuda.synchronize()
    rec = dict(eng.history[-1], kind=kind, seconds=time.perf_counter() - t0,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches={k: _build.LAUNCHES[k] - before[k]
                         for k in _build.LAUNCHES})
    say("round " + json.dumps(rec))
    for key, v in rec.items():
        if isinstance(v, float) and not torch.isfinite(torch.tensor(v)):
            fail(f"round {rec['round']} ({kind}): {key} is not finite")
    return state, rec


def _leaves(state):
    return {f"{part}.{f}.{k}": v for part in ("clients", "server")
            for f, tree in vars(getattr(state, part)).items()
            for k, v in tree.items()}


def compare_sparse(pre, masked, sparse, mask):
    """The sparse round against the dense masked round from the same state
    ``pre`` and draws, both run under ``deterministic``.  Bitwise: the
    aggregation weights and every leaf of the absent clients (their state
    before the round).  Within CARD_VS_CPU_ATOL/RTOL: every other leaf and
    the scalar metrics (the m-lane convolutions may run other cuDNN
    algorithms than the K-lane ones).  Returns the largest difference and
    whether all was bitwise."""
    (ms, mm), (ss, sm) = masked, sparse
    if not torch.equal(mm["agg_weights"], sm["agg_weights"]):
        fail("sparse round: the aggregation weights differ from the masked "
             "round's")
    absent = (mask[0] == 0).nonzero()[:, 0]
    a, b, p0 = _leaves(ms), _leaves(ss), _leaves(pre)
    worst, bitwise = 0.0, True
    for k, v in a.items():
        if k.startswith("clients.") and not (
                torch.equal(b[k][absent], p0[k][absent])
                and torch.equal(v[absent], p0[k][absent])):
            fail(f"sparse round: an absent client's {k} changed")
        worst = max(worst, max_err(b[k], v))
        bitwise &= torch.equal(b[k], v)
        if not close(b[k], v, CARD_VS_CPU_ATOL, CARD_VS_CPU_RTOL):
            fail(f"sparse round: {k} differs from the masked round's by "
                 f"{max_err(b[k], v):.3e}")
    for key, v in mm.items():
        if v.ndim == 0:
            d = abs(float(sm[key]) - float(v))
            worst = max(worst, d)
            bitwise &= float(sm[key]) == float(v)
            if d > CARD_VS_CPU_ATOL + CARD_VS_CPU_RTOL * abs(float(v)):
                fail(f"sparse round: metric {key} {float(sm[key])} vs "
                     f"{float(v)}")
    return worst, bitwise


def phase_slice(smi):
    """The DS-FL path at full width (phase 5).  Returns the engine, the
    final DS-FL state, the task, the main path's launches and the side
    check's."""
    from torch.func import vmap

    from repro_torch.core import aggregation
    from repro_torch.core.algorithms import (DSFLAlgorithm, FDAlgorithm,
                                             FDConfig, FedAvgAlgorithm,
                                             FedAvgConfig)
    from repro_torch.core.client import predict_probs
    from repro_torch.core.comm import CommModel
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.hierarchy import hierarchical_weighted_era
    from repro_torch.core.losses import distill_xent
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import build_image_task
    from repro_torch.kernels import _build
    from repro_torch.models.smallnets import apply_mnist_cnn, param_count

    K, EDGES, BUDGET = 100, 4, 50
    hp = DSFLConfig(rounds=2)
    say(f"slice: mnist_cnn 28x28 widths (32, 64) fc 512, K={K}, {hp}")
    task = build_image_task(0, K=K, n_private=20_000, n_open=10_000,
                            n_test=2_000, distribution="non_iid", hw=28,
                            device="cuda")
    eval_fn = make_eval_fn(apply_mnist_cnn, task.x_test, task.y_test)
    algo_era = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True)
    algo_w = DSFLAlgorithm(apply_mnist_cnn,
                           dataclasses.replace(hp, aggregation="weighted_era"),
                           use_kernel=True)
    algo_tree = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True,
                              agg_edges=EDGES)
    eng = FedEngine(algo_era, eval_fn)
    state = eng.init(_paper_cnn("cuda"), task)
    wg, sg = state.server.params, state.server.model_state
    n_train, n_all = param_count(wg), param_count(wg, sg)
    say(f"parameters: {n_train} trainable, {n_all} with BatchNorm state")
    if (n_train, n_all) != (582_218, 582_410):
        fail(f"mnist_cnn parameter count {n_train}/{n_all}")
    half = torch.zeros((1, K), device="cuda")
    half[0, ::2] = 1.0
    masked_kw = dict(ctx_plan={"mask": half}, draws=[_round_draws(
        11, K, hp, task.x_clients.shape[1], task.open_x.shape[0])])
    recs = []

    def dsfl_round(algo, st, kind, **kw):
        eng.algo = algo
        st, rec = timed_round(eng, st, task, kind, **kw)
        recs.append(rec)
        return st, dict(eng.last_metrics)

    torch.cuda.synchronize()
    _build.reset_launches()                       # the main path's window
    for kind, algo in (("era", algo_era), ("era", algo_era),
                       ("weighted_era", algo_w)):
        state, _ = dsfl_round(algo, state, kind)
    pre = state
    with deterministic():              # rounds held to each other, bit for bit
        masked = dsfl_round(algo_era, pre, "era masked 50/100", **masked_kw)
        sparse = [dsfl_round(algo_era, pre, f"era sparse 50/100, budget "
                             f"{BUDGET} ({tag})", active_budget=BUDGET,
                             **masked_kw)
                  for tag in ("first call at 50 lanes", "warm")]
    state, _ = dsfl_round(algo_tree, masked[0],
                          f"era two-level, {EDGES} edges")
    baselines = {}
    for kind, algo in (("fedavg", FedAvgAlgorithm(apply_mnist_cnn,
                                                  FedAvgConfig())),
                       ("fd", FDAlgorithm(apply_mnist_cnn, FDConfig()))):
        b_eng = FedEngine(algo, eval_fn)
        st = b_eng.init(_paper_cnn("cuda"), task)
        for _ in range(2):
            st, rec = timed_round(b_eng, st, task, kind)
            recs.append(rec)
        baselines[kind] = (b_eng, st)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)              # end of the main path's window
    say(f"launches in the main path's window: {json.dumps(launches)}")
    eng.algo = algo_era

    for rec in recs:
        kind = rec["kind"]
        want = ({} if kind in ("fedavg", "fd") else
                {"weighted_era_sharpen": EDGES}
                if kind.startswith("era two-level") else
                {"era_sharpen": 1} if kind == "era" else
                {"weighted_era_sharpen": 1})
        for name, count in rec["launches"].items():
            if count != want.get(name, 0):
                fail(f"round {rec['round']} ({kind}) launched {name} {count} "
                     f"times, expected {want.get(name, 0)}")
    for name in ON_MAIN_PATH:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")

    # the sparse round against the masked one: same state, same draws
    for (st, m), rec in zip(sparse, recs[4:6]):
        worst, bitwise = compare_sparse(pre, masked, (st, m), half)
        say(f"sparse vs masked [{smi}] ({rec['kind']}): agg_weights and the "
            f"{K - BUDGET} absent clients' leaves bitwise; largest difference "
            f"{worst:.3e} ({'bitwise' if bitwise else 'not bitwise'}; atol "
            f"{CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL}); "
            f"{rec['seconds']:.3f} s, peak {rec['max_memory_allocated']} B against the masked "
            f"round's {recs[3]['seconds']:.3f} s, peak "
            f"{recs[3]['max_memory_allocated']} B")
    a, b = _leaves(sparse[0][0]), _leaves(sparse[1][0])
    same = all(torch.equal(a[k], b[k]) for k in a)
    say(f"sparse round run twice [{smi}]: largest difference between the two "
        f"runs {max(max_err(a[k], b[k]) for k in a):.3e} "
        f"({'bitwise' if same else 'not bitwise'}; both under torch's "
        f"deterministic algorithms, at {BUDGET} lanes)")
    for kind in ("fedavg", "fd"):
        rs = [r for r in recs if r["kind"] == kind]
        say(f"{kind} [{smi}]: " + "; ".join(
            f"round {r['round']} {r['seconds']:.3f} s, peak "
            f"{r['max_memory_allocated']} B, update_loss "
            f"{r['update_loss']:.4f}, test_acc {r['test_acc']:.4f}"
            for r in rs) + "; no kernel launched")

    # side check, its own window: the distillation loss of the final state on
    # the kernel path (K3/K4), the server model's logits on one distillation
    # batch against the sharpened mean of the clients' predictions
    xo = task.open_x[:hp.batch_size]
    probs = vmap(lambda w, s: predict_probs(apply_mnist_cnn, w, s, xo))(
        state.clients.params, state.clients.model_state)
    teacher = aggregation.era(probs, hp.temperature)
    logits = apply_mnist_cnn(state.server.params, state.server.model_state,
                             xo, True)[0].detach().requires_grad_(True)
    torch.cuda.synchronize()
    _build.reset_launches()
    loss_k = distill_xent(logits, teacher, use_kernel=True)
    (g_k,) = torch.autograd.grad(loss_k, logits)
    torch.cuda.synchronize()
    side = dict(_build.LAUNCHES)
    loss_p = distill_xent(logits, teacher)
    (g_p,) = torch.autograd.grad(loss_p, logits)
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    say(f"side check, distill loss of the final state: kernel {lk:.6f} plain "
        f"{lp:.6f}; grad max_abs_err {max_err(g_k, g_p):.3e}; launches "
        f"{json.dumps(side)}")
    if not (abs(lk - lp) <= 1e-4 + 1e-3 * abs(lp)
            and max_err(g_k, g_p) <= 1e-5):
        fail("distillation loss on the kernel path disagrees with the plain loss")
    for name in ("distill_loss_fwd", "distill_loss_bwd"):
        if side[name] == 0:
            fail(f"kernel {name} was not launched by the side check")

    # the two-level teacher (K2's weighted mean on each edge's view, the
    # server's sum and sharpen) against the flat weighted ERA teacher (K2
    # fused), on the same full-width uploads
    xo = task.open_x[masked_kw["draws"][0].o_idx]
    up = vmap(lambda w, s: predict_probs(apply_mnist_cnn, w, s, xo))(
        state.clients.params, state.clients.model_state)
    ones = torch.ones((K,), device="cuda")
    check(f"two-level ERA teacher, {EDGES} edges, uploads {tuple(up.shape)}",
          hierarchical_weighted_era(up, ones, hp.temperature, EDGES, True),
          aggregation.weighted_era(up, ones, hp.temperature, True), 1e-6)

    # measured wire bytes against the analytic CommModel
    cm = CommModel(K, task.n_classes, n_all, hp.open_batch)
    measured = {"dsfl": FedEngine(algo_era).measured_round_bytes(state, task)}
    for kind, (b_eng, st) in baselines.items():
        measured[kind] = b_eng.measured_round_bytes(st, task)
    analytic = {"dsfl": cm.dsfl_round(), "fd": cm.fd_round(),
                "fedavg": cm.fl_round()}
    say(f"wire bytes per round at K={K}, measured (analytic): " + ", ".join(
        f"{k} {measured[k]} ({analytic[k]})" for k in analytic) +
        f"; DS-FL / FedAvg = {measured['dsfl'] / measured['fedavg']:.5f}, a "
        f"{1 - measured['dsfl'] / measured['fedavg']:.2%} cut")
    if measured != analytic:
        fail(f"measured wire bytes {measured} differ from CommModel's "
             f"{analytic}")
    return eng, state, task, launches, side


def phase_legs(eng, state, task):
    """Where one more ERA round's time goes, split where the algorithm splits
    it: ``round_start`` (1. update, 2. prediction) and ``round_finish``
    (3-5. aggregation through K1, 6/6'. client and server distillation),
    each on the host clock around a synchronize.  Runs after the launch-count
    windows closed."""
    from repro_torch.core.engine import open_batch
    algo = eng.algo
    if algo.hp.aggregation != "era":
        fail(f"legs: expected the ERA algorithm, got {algo.hp.aggregation}")
    r = eng.rounds_done
    ctx = eng.make_ctx(task, o_idx=open_batch(
        algo.hp.seed, r, task.open_x.shape[0], algo.hp.open_batch, "cuda"))
    legs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        legs[name] = time.perf_counter() - t0
        return out

    inflight = timed("round_start (update, predict)",
                     lambda: algo.round_start(state, ctx, r))
    timed("round_finish (aggregate, distill clients and server)",
          lambda: algo.round_finish(state, ctx, inflight, r))
    total = sum(legs.values())
    say("legs " + json.dumps({k: {"seconds": v, "share": v / total}
                              for k, v in legs.items()}))


def _widen(tree: dict) -> dict:
    """A state's floating leaves in float64 (integer leaves as they are)."""
    return {k: v.double() if v.is_floating_point() else v
            for k, v in tree.items()}


def phase_card_vs_cpu(smi):
    """Rounds from the same weights and draws on the card (kernels, float32,
    deterministic algorithms) and on the CPU (plain versions), compared leaf
    by leaf (phase 6): K=4 at full width, 1 local (and 1 distillation)
    epoch; an ERA round, a sparse ERA round (clients 0 and 3 of 4, budget 2)
    and a FedAvg round.  The card's convolutions run natively
    (`native_convs`).  The CPU runs each round in float64 and the card is
    held to that within CARD_VS_CPU_ATOL/RTOL: client 1's local update is
    ill-conditioned (its float32 result moves 4e-5 from float64 on the CPU
    alone, 1e-7 on the other clients), so a float32 CPU reference carries
    its own rounding error, up to 2.7e-4 after the round, and more on
    another CPU.  The CPU's float32 round is run too and its distance from
    float64 printed beside the card's."""
    from repro_torch import convert
    from repro_torch.core.algorithms import (DSFLAlgorithm, FedAvgAlgorithm,
                                             FedAvgConfig)
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import FederatedImageTask, build_image_task
    from repro_torch.models.smallnets import apply_mnist_cnn

    K = 4
    hp = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1,
                    batch_size=100, open_batch=200)
    cpu_task = build_image_task(1, K=K, n_private=800, n_open=400, n_test=200,
                                distribution="non_iid", hw=28, device="cpu")
    gen = torch.Generator().manual_seed(7)
    init = _paper_cnn("cpu")
    models = [init(gen) for _ in range(K + 1)]
    n_k = cpu_task.x_clients.shape[1]
    draws = [_round_draws(7, K, hp, n_k, 400, "cpu")]
    sparse_kw = dict(ctx_plan={"mask": torch.tensor([[1.0, 0.0, 0.0, 1.0]])},
                     active_budget=2)
    runs = (("cuda", torch.float32), ("cpu", torch.float64),
            ("cpu", torch.float32))
    for case, kw in (("era", {}), ("sparse 2/4, budget 2", sparse_kw),
                     ("fedavg", {})):
        results = {}
        for device, dtype in runs:
            wide = (lambda x: x.double()) if dtype == torch.float64 else \
                (lambda x: x)
            task = FederatedImageTask(*(t.to(device) for t in (
                wide(cpu_task.x_clients), cpu_task.y_clients,
                wide(cpu_task.open_x), wide(cpu_task.x_test),
                cpu_task.y_test)), cpu_task.n_classes)
            mv = lambda d: {k: v.to(device) for k, v in (
                _widen(d) if dtype == torch.float64 else d).items()}
            stack = lambda i: mv({k: torch.stack([m[i][k] for m in models[1:]])
                                  for k in models[0][i]})
            if case == "fedavg":
                algo = FedAvgAlgorithm(apply_mnist_cnn, FedAvgConfig(
                    rounds=1, local_epochs=1, batch_size=100), device=device)
                start = algo.init_from(mv(models[0][0]), mv(models[0][1]))
            else:
                algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True,
                                     device=device)
                start = algo.init_from(stack(0), stack(1), mv(models[0][0]),
                                       mv(models[0][1]))
            eng = FedEngine(algo, make_eval_fn(apply_mnist_cnn, task.x_test,
                                               task.y_test))
            t0 = time.perf_counter()
            with deterministic(), native_convs():
                state = eng.run(start, task, draws=draws, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            say(f"card vs cpu ({case}): {device} {dtype} round in "
                f"{time.perf_counter() - t0:.2f} s")
            results[(device, dtype)] = (convert.round_state_to_numpy(state),
                                        eng.history[-1])
        (sc, hc), (sp, h_cpu), (s32, _) = (results[r] for r in runs)
        worst = worst_32 = ratio = 0.0
        for part in sc:
            for field in sc[part]:
                a = convert.flatten_tree(sc[part][field])
                b = convert.flatten_tree(sp[part][field])
                c = convert.flatten_tree(s32[part][field])
                for k in b:
                    if not b[k].size:
                        continue
                    ta, tb = (torch.from_numpy(x).double() for x in (a[k], b[k]))
                    d = (ta - tb).abs()
                    worst = max(worst, float(d.max()))
                    ratio = max(ratio, float((d / (CARD_VS_CPU_ATOL +
                                                   CARD_VS_CPU_RTOL *
                                                   tb.abs())).max()))
                    worst_32 = max(worst_32, float(abs(c[k] - b[k]).max()))
                    if not torch.allclose(ta, tb, atol=CARD_VS_CPU_ATOL,
                                          rtol=CARD_VS_CPU_RTOL):
                        fail(f"card vs cpu ({case}): {part}.{field}.{k} "
                             f"differs from the float64 round by "
                             f"{float(d.max()):.3e}")
        for key, v in h_cpu.items():
            tol = (1.0 / 200 + 1e-6) if key == "test_acc" else \
                CARD_VS_CPU_ATOL + CARD_VS_CPU_RTOL * abs(v)
            if abs(hc[key] - v) > tol:
                fail(f"card vs cpu ({case}): metric {key} {hc[key]} vs {v}")
        say(f"card vs cpu [{smi}] ({case}): state leaves and metrics agree "
            f"with the CPU's float64 round (max leaf diff {worst:.3e}, "
            f"{ratio:.3f} of the limit; atol {CARD_VS_CPU_ATOL}, rtol "
            f"{CARD_VS_CPU_RTOL}; test_acc within 1/200; the CPU's float32 "
            f"round is {worst_32:.3e} from it): cuda {json.dumps(hc)}")


# ------------------------------------------------------------- phase "sim" --
# 4 rounds in chunks of 2 (8 in chunks of 4 until the script ran past its
# 1200 s on a slow host): (a)'s three runs and its resumed one, and (b)'s
# two chunks, the second under the profiler, all take half the time
SIM_K, SIM_ROUNDS, SIM_CHUNK = 100, 4, 2
# (c) holds the cohort plane's leaves to the dense rounds' with the plain
# aggregation: K2's launch plan (its client slices) depends on the lane
# count, so a slab of 80 lanes and the dense stack of 100 sum in other
# orders, and training carries that last-bit difference past
# CARD_VS_CPU_ATOL/RTOL within 2 rounds (8.3e-4 on a BatchNorm mean;
# PERF.md §6).  `check_k2_slab` measures that difference on the
# rounds' own K2 inputs.
C_ROUNDS = 4
COHORT_K, COHORT_FRACTION = 1_000_000, 1e-4


def _fleet(K):
    """examples/sim_stragglers.py's fleet and its sync scheduler."""
    from repro_torch.sim import ClientPopulation, SyncScheduler
    pop = ClientPopulation.lognormal(seed=0, K=K, compute_median=5.0,
                                     compute_sigma=0.8, uplink_median=2e4,
                                     uplink_sigma=1.0, availability=(0.6, 1.0))
    return pop


def _recording(sched, name):
    """``sched`` with each plan it makes appended to ``sched.<name>``."""
    setattr(sched, name, [])
    inner = getattr(sched, "next_round" if name == "plans" else "next_cohort")

    def wrapped(*a, **kw):
        plan = inner(*a, **kw)
        getattr(sched, name).append(plan)
        return plan

    setattr(sched, "next_round" if name == "plans" else "next_cohort",
            wrapped)
    return sched


class _Replay:
    """A plannable sync scheduler that hands `SimRunner` the dense form of
    recorded cohort plans, so the dense rounds get exactly the plans the
    cohort rounds ran (cohort draws differ from ``next_round``'s)."""
    plannable, idealized = True, False

    def __init__(self, cohorts, population, active_budget):
        from repro_torch.sim import VirtualClock
        self.cohorts, self.population = list(cohorts), population
        self.active_budget, self.clock = active_budget, VirtualClock()

    def next_round(self, rng, up_bytes, down_bytes):
        from repro_torch.sim import RoundPlan
        p, K = self.cohorts.pop(0), self.population.n_clients
        dropped = np.zeros(K, bool)
        dropped[p.dropped_ids] = True
        self.clock.now = p.t_end
        return RoundPlan(p.dense_mask(K), p.dense_staleness(K), p.t_start,
                         p.t_end, dropped)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's, and the index ops'
    sorted scatter in place of atomics) for runs held to each other: with
    the default ones a round differs from itself from run to run, and 8
    rounds of training carried that past CARD_VS_CPU_ATOL/RTOL (4.5e-4 on
    a BatchNorm bias; PERF.md §6): the ``deterministic`` platform preset
    for the scope of the block, every switch put back after it."""
    prev = platform.snapshot()
    platform.apply(platform.PRESETS["deterministic"])
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        platform.restore(prev)


@contextlib.contextmanager
def native_convs():
    """PyTorch's own CUDA convolutions in place of cuDNN's, for the card's
    rounds held to the CPU's float64 round (phase 6, sim (d)).  cuDNN picks
    an algorithm per shape by its heuristics, and client 1's
    ill-conditioned local update (tools/round_spread.py) amplifies that
    algorithm's float32 rounding: with the same code, phase 6's ERA round
    landed 7.8e-5 from float64 in some runs of this script and 5.8e-4 (past
    the limit) in others, where the native convolutions land 1.4e-6 from it
    every time (PERF.md §6).  Phase 5's rounds and sim (a)-(c) keep cuDNN."""
    cudnn = torch.backends.cudnn
    prev = cudnn.enabled
    cudnn.enabled = False
    try:
        yield
    finally:
        cudnn.enabled = prev


def _busy_ms(prof) -> float:
    """The card's busy time in a profile: the union of its activities'
    intervals (kernels, and copies, which a pageable transfer runs beside
    the kernels), without the profiler's own buffer events."""
    from torch.autograd import DeviceType
    own = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in own)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _spans(path) -> dict:
    """Each span name's host seconds, one entry a span, in a JSONL trace."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "span":
                out.setdefault(rec["name"], []).append(rec["dur_us"] / 1e6)
    return dict(sorted(out.items()))


def _largest(a, b) -> float:
    """The largest leaf difference between two states."""
    from repro_torch.checkpoint import named_leaves
    return max((max_err(x, y) for (_, x), (_, y) in
                zip(named_leaves(a), named_leaves(b)) if x.numel()),
               default=0.0)


def _share_of_limit(a, b, atol=CARD_VS_CPU_ATOL, rtol=CARD_VS_CPU_RTOL):
    """The largest |a - b| / (atol + rtol |b|) over two states' leaves: how
    close a comparison came to its limit (1.0)."""
    from repro_torch.checkpoint import named_leaves
    return max((float(((x.cpu().double() - y.cpu().double()).abs() /
                       (atol + rtol * y.cpu().double().abs())).max())
                for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b))
                if x.numel()), default=0.0)


def _compare_leaves(what, a, b, atol=CARD_VS_CPU_ATOL, rtol=CARD_VS_CPU_RTOL):
    """Every leaf of two states (or two leaf lists) on the host within
    atol + rtol |b|; returns the largest difference."""
    from repro_torch.checkpoint import named_leaves
    la = a if isinstance(a, list) else named_leaves(a)
    lb = b if isinstance(b, list) else named_leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        fail(f"{what}: the two states hold different leaves")
    worst = 0.0
    for (name, x), (_, y) in zip(la, lb):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.numel():
            worst = max(worst, max_err(x, y))
        if not close(x, y, atol, rtol):
            fail(f"{what}: {name} differs by {max_err(x, y):.3e}")
    return worst


def _books(runner, sched) -> dict:
    """What a simulation must reproduce exactly: the plans, the virtual
    clock and the byte ledger."""
    recs = [{k: r[k] for k in ("round", "t_round", "t_cum", "participants",
                               "dropped", "mean_staleness", "cum_bytes")}
            for r in runner.history]
    masks = [p.mask.tolist() if hasattr(p, "mask") else p.ids.tolist()
             for p in getattr(sched, "plans", getattr(sched, "cohorts", []))]
    return {"records": recs, "plans": masks, "clock": sched.clock.now,
            "cum_bytes": runner.cum_bytes}


class _TeacherInputs:
    """Keeps copies of the (probs, weights) the rounds of ``algo`` hand
    their "4. Aggregation" (`DSFLAlgorithm._teacher`), ``limit`` calls at
    most: K2's inputs on the path, for `check_k2_slab`."""

    def __init__(self, algo, limit):
        self.calls, inner = [], algo._teacher

        def wrapped(probs, weights):
            if len(self.calls) < limit:
                self.calls.append((probs.detach().clone(),
                                   weights.detach().clone()))
            return inner(probs, weights)

        object.__setattr__(algo, "_teacher", wrapped)   # a frozen dataclass


def check_k2_slab(what, slab, dense, temperature):
    """K2 on a round's slab stack (a cohort's lanes, the absent ones of
    weight 0) against K2 on the same round's dense stack: each against its
    plain version at atol 1e-6, and the two teachers within 1e-6 of each
    other (the launch plans differ with the lane count, so the fp32 sums
    run in other orders).  Returns the teachers' largest difference."""
    from repro_torch.core.aggregation import _normalize_weights
    from repro_torch.kernels import era_sharpen as es
    outs = []
    for name, (p, w) in (("slab", slab), ("dense", dense)):
        wn = _normalize_weights(w).contiguous()
        K, N, C = p.shape
        out = es.weighted_era_sharpen(p, wn, temperature)
        check(f"K2 {what}, {name} stack {(K, N, C)} ({int((w > 0).sum())} "
              f"lanes of weight > 0, plan {es.launch_plan(K, N, C)})", out,
              es.weighted_era_sharpen_plain(p, wn, temperature), 1e-6)
        outs.append(out)
    err = max_err(*outs)
    if not close(outs[0], outs[1], 1e-6, 0.0):
        fail(f"K2 {what}: the slab's teacher is {err:.3e} from the dense "
             f"stack's, above 1e-6")
    return err


def _profiled(label, fn, smi, out, phase="sim (e)"):
    """``fn()`` under ``torch.profiler`` (phase "sim" (e), phase "llm"):
    host time, the card's summed and busy time, idle share and top kernels
    into ``out[label]``.  Returns ``fn()`` and the host seconds.  Only the
    card's activities are recorded (the top list names kernels, not the
    ops that launched them): turning a host trace of a cohort chunk into
    events took over a minute of the script."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, n_kernels, n_full, tops = _trace_summary(prof)
    busy = _busy_ms(prof)
    rec = out[label] = dict(
        host_ms=host_ms, device_ms=dev_ms, busy_ms=busy,
        device_kernels=n_kernels, launch_queue_full_markers=n_full,
        idle_share=1 - busy / host_ms if host_ms else None,
        top=[(k[:60], c, t) for k, c, t in tops])
    say(f"{phase} trace [{smi}]: {label}: host {host_ms:.3f} ms; device "
        f"activities {dev_ms:.3f} ms summed in {n_kernels} (copies "
        f"included), busy {busy:.3f} ms as their union (profiled; idle "
        f"share {rec['idle_share']:.1%}); top by device ms: " +
        "; ".join(f"{k} x{c} {t:.3f}" for k, c, t in rec["top"]))
    return res, host_ms / 1e3


def phase_sim(smi, tmp):
    """The simulator and the cohort plane at full width (phase "sim"):
    (a) `SimRunner` at K=100 on the paper's data, 4 rounds in chunks of 2,
    against the loop, the pipelined schedule and a save/resume; (c) the
    cohort plane against the dense rounds at K=100, and K2 on its slab
    stacks against K2 on the dense ones; (b) `CohortRunner` at K=1,000,000
    and 0.01% participation, with a save and a load after its first chunk,
    and K2 on its slab stack against the participants' stack; (d) keyed
    draws and a K=4 cohort round card vs CPU; (e) the profiler over the
    second chunk of (b).  Returns the kernels' launches in the
    SIM_ROUNDS-round runs."""
    from repro_torch.core import prng
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.cohort import ClientStore
    from repro_torch.core.engine import FedEngine, make_eval_fn, open_batch
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import (ArrayProvider, SyntheticProvider,
                                           build_image_task)
    from repro_torch.kernels import _build
    from repro_torch.models.smallnets import apply_mnist_cnn
    from repro_torch.obs import trace as obs
    from repro_torch.sim import CohortRunner, SimRunner, SyncScheduler

    init = _paper_cnn("cuda")
    sim_launches, profiles, t_part = {}, {}, time.perf_counter()

    def part_done(name):
        nonlocal t_part
        say(f"sim: {name} took {time.perf_counter() - t_part:.1f} s")
        t_part = time.perf_counter()

    # (a) SimRunner, K=100, the paper's data
    task = build_image_task(0, K=SIM_K, n_private=20_000, n_open=10_000,
                            n_test=2_000, distribution="non_iid", hw=28,
                            device="cuda")
    hp = DSFLConfig(rounds=SIM_ROUNDS)
    eval_fn = make_eval_fn(apply_mnist_cnn, task.x_test, task.y_test)
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True)
    pop = _fleet(SIM_K)

    def sim_runner():
        sched = _recording(SyncScheduler(pop, fraction=0.1, deadline=20.0,
                                         straggler="admit",
                                         sampler="available"), "plans")
        return SimRunner(FedEngine(algo, eval_fn), sched, seed=0), sched

    state0 = FedEngine(algo).init(init, task)
    say(f"sim (a): SimRunner, mnist_cnn at paper width, K={SIM_K}, "
        f"fraction 0.1, deadline 20 s, stragglers admitted, budget "
        f"{sim_runner()[1].active_budget}, {SIM_ROUNDS} rounds, {hp}")
    part_done("(a) set-up")
    runs = {}
    for name, kw in (("fused", dict(chunk_rounds=SIM_CHUNK)),
                     ("loop", dict(chunk_rounds=1)),
                     ("overlap", dict(chunk_rounds=SIM_CHUNK, overlap=True))):
        runner, sched = sim_runner()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()                   # this run's window
        t0 = time.perf_counter()
        trace = tmp / f"sim_a_{len(runs)}.jsonl"
        with deterministic(), obs.trace_to(str(trace)):
            st = runner.run(state0, task, rounds=SIM_ROUNDS,
                            log_every=SIM_CHUNK, active_budget="auto", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        spans = _spans(trace)
        steps = spans.get("engine.chunk", spans.get("engine.round", []))
        launches = dict(_build.LAUNCHES)
        runs[name] = (st, runner, sched)
        sim_launches[f"(a) {name}"] = launches
        accs = [r.get("test_acc") for r in runner.history if "test_acc" in r]
        say(f"sim (a) {name} [{smi}] (deterministic algorithms): "
            f"{SIM_ROUNDS} rounds in {secs:.3f} s "
            f"({secs / SIM_ROUNDS:.3f} s a round); engine "
            f"{'chunks' if 'engine.chunk' in spans else 'rounds'} "
            f"{[round(x, 4) for x in steps]} s; "
            f"peak {torch.cuda.max_memory_allocated()} B; participants "
            f"{[r['participants'] for r in runner.history]}; virtual clock "
            f"{sched.clock.now:.3f} s; cum_bytes {runner.cum_bytes}; test_acc "
            f"{accs}; launches {json.dumps(launches)}")
        if launches["weighted_era_sharpen"] != SIM_ROUNDS or \
                launches["era_sharpen"] != 0 or \
                any(v for k, v in launches.items()
                    if k not in ("weighted_era_sharpen", "era_sharpen")):
            fail(f"sim (a) {name}: launches {launches}, expected K2 "
                 f"{SIM_ROUNDS} and nothing else")
    want = _books(runs["fused"][1], runs["fused"][2])
    for name in ("loop", "overlap"):
        if _books(runs[name][1], runs[name][2]) != want:
            fail(f"sim (a): the {name} run's plans, clock or bytes differ from "
                 f"the fused run's")
        worst = _compare_leaves(f"sim (a) {name} vs fused", runs[name][0],
                                runs["fused"][0])
        say(f"sim (a) {name} vs fused [{smi}] (deterministic algorithms): "
            f"plans, virtual clock and cum_bytes equal; largest leaf "
            f"difference {worst:.3e} (atol {CARD_VS_CPU_ATOL}, rtol "
            f"{CARD_VS_CPU_RTOL})")
    part_done("(a) fused, loop and overlap runs")

    # (a) resumed: chunk 1, save, a fresh engine and runner load, chunk 2
    # (not profiled: reading a 4-round chunk's trace took about two minutes;
    # (e) profiles (b)'s chunk)
    path = str(tmp / "sim_a.ckpt")
    runner, sched = sim_runner()
    with deterministic():
        half = runner.run(state0, task, rounds=SIM_CHUNK,
                          chunk_rounds=SIM_CHUNK, log_every=SIM_CHUNK)
        runner.save_state(path, half)
        runner2, sched2 = sim_runner()
        sched2.plans = list(sched.plans)
        st = runner2.load_state(path, state0)
        if runner2.engine.rounds_done != SIM_CHUNK:
            fail(f"sim (a) resume: rounds_done {runner2.engine.rounds_done}")
        st = runner2.run(st, task, rounds=SIM_ROUNDS - SIM_CHUNK,
                         chunk_rounds=SIM_CHUNK, log_every=SIM_CHUNK)
    if _books(runner2, sched2) != want:
        fail("sim (a) resume: plans, clock or bytes differ from the "
             "uninterrupted run's")
    worst = _compare_leaves("sim (a) resumed vs fused", st, runs["fused"][0])
    say(f"sim (a) resumed after chunk 1 [{smi}]: plans, virtual clock and "
        f"cum_bytes equal to the uninterrupted run; largest leaf difference "
        f"{worst:.3e}; checkpoint {os.path.getsize(path)} B")
    del runs, half, st
    part_done("(a) resumed run")

    # (c) the cohort plane against the dense rounds, the same plans, through
    # the plain aggregation; then K2 on each round's slab and dense stacks
    from repro_torch.checkpoint import named_leaves
    c_algo, d_algo = (DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=False)
                      for _ in range(2))
    c_in, d_in = _TeacherInputs(c_algo, C_ROUNDS), _TeacherInputs(d_algo,
                                                                  C_ROUNDS)
    c_sched = _recording(SyncScheduler(pop, fraction=0.1, deadline=20.0,
                                       straggler="admit",
                                       sampler="available"), "cohorts")
    store = ClientStore(lambda ids: c_algo.init_cohort(
        hp.seed, init, ids, SIM_K))
    c_runner = CohortRunner(FedEngine(c_algo, eval_fn), c_sched,
                            ArrayProvider(task), store=store)
    d_sched = _Replay([], pop, c_sched.active_budget)
    d_runner = SimRunner(FedEngine(d_algo, eval_fn), d_sched)
    with deterministic():
        c_st = c_runner.run(c_algo.init_server(hp.seed, init),
                            rounds=C_ROUNDS, chunk_rounds=C_ROUNDS,
                            log_every=C_ROUNDS)
        d_sched.cohorts = list(c_sched.cohorts)
        d_st = d_runner.run(state0, task, rounds=C_ROUNDS,
                            chunk_rounds=C_ROUNDS, log_every=C_ROUNDS)
    if d_sched.clock.now != c_sched.clock.now or \
            d_runner.cum_bytes != c_runner.cum_bytes or \
            [r["participants"] for r in d_runner.history] != \
            [r["participants"] for r in c_runner.history]:
        fail("sim (c): the dense run's clock, bytes or participants "
             "differ from the cohort run's")
    ids = store.ids()
    rows = named_leaves(c_st.server) + [
        (n, torch.stack([store._rows[int(i)][j] for i in ids]))
        for j, (n, _) in enumerate(named_leaves(d_st.clients))]
    dense_rows = named_leaves(d_st.server) + [
        (n, v[torch.as_tensor(ids, device=v.device)].cpu())
        for n, v in named_leaves(d_st.clients)]
    worst = _compare_leaves("sim (c) cohort vs dense", rows, dense_rows)
    say(f"sim (c) cohort vs dense at K={SIM_K} through the plain "
        f"aggregation [{smi}] (deterministic algorithms): the same "
        f"{C_ROUNDS} plans (one slab of {C_ROUNDS * c_sched.active_budget} "
        f"lanes), clock and bytes; the server and the {len(ids)} stored "
        f"clients within atol {CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL} "
        f"(largest difference {worst:.3e}"
        f"{', bitwise' if worst == 0.0 else ''})")
    if len(c_in.calls) != C_ROUNDS or len(d_in.calls) != C_ROUNDS:
        fail(f"sim (c): {len(c_in.calls)} and {len(d_in.calls)} aggregations "
             f"recorded, expected {C_ROUNDS} each")
    k2_slab = [check_k2_slab(f"sim (c) round {r}", c, d, hp.temperature)
               for r, (c, d) in enumerate(zip(c_in.calls, d_in.calls))]
    say(f"sim (c) K2 on the slab stacks against K2 on the dense stacks of "
        f"the same {C_ROUNDS} rounds [{smi}]: teachers within 1e-6 (largest "
        f"differences {[f'{e:.3e}' for e in k2_slab]})")
    del c_st, d_st, store, state0, c_in, d_in
    torch.cuda.empty_cache()
    part_done("(c)")

    # (b) CohortRunner, K=1,000,000 at 0.01% participation; chunk 2 under
    # the profiler (e)
    hp_b = DSFLConfig(rounds=SIM_ROUNDS, local_epochs=1, distill_epochs=1,
                      batch_size=20, open_batch=200, aggregation="era")
    algo_b = DSFLAlgorithm(apply_mnist_cnn, hp_b, use_kernel=True)
    b_in = _TeacherInputs(algo_b, 1)
    pop_b = _fleet(COHORT_K)
    prov = SyntheticProvider(0, COHORT_K, n_per_client=20, n_open=200,
                             n_test=300, hw=28)
    eval_b = make_eval_fn(apply_mnist_cnn, prov.x_test, prov.y_test)

    def cohort_runner():
        sched = SyncScheduler(pop_b, fraction=COHORT_FRACTION, deadline=20.0,
                              straggler="admit", sampler="available")
        store = ClientStore(lambda ids: algo_b.init_cohort(
            hp_b.seed, init, ids, COHORT_K))
        return CohortRunner(FedEngine(algo_b, eval_b), sched, prov,
                            store=store), sched

    b_runner, b_sched = cohort_runner()
    S = min(COHORT_K, SIM_CHUNK * b_sched.active_budget)
    say(f"sim (b): CohortRunner, mnist_cnn at paper width, K={COHORT_K}, "
        f"fraction {COHORT_FRACTION}, budget {b_sched.active_budget}, slabs "
        f"of {S} lanes, SyntheticProvider(n_per_client=20, n_open=200, "
        f"n_test=300, hw=28), {hp_b}")
    part_done("(b) set-up")
    trace_path = tmp / "sim_b.jsonl"
    b_path = str(tmp / "sim_b.ckpt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()                       # this run's window
    t0 = time.perf_counter()
    with obs.trace_to(str(trace_path)):
        st_b = b_runner.run(algo_b.init_server(hp_b.seed, init),
                            rounds=SIM_CHUNK, chunk_rounds=SIM_CHUNK,
                            log_every=SIM_CHUNK)
        torch.cuda.synchronize()
        t_chunk1 = time.perf_counter() - t0
        t1 = time.perf_counter()
        b_runner.save_state(b_path, st_b)
        b_runner2, b_sched2 = cohort_runner()
        st_b2 = b_runner2.load_state(b_path, algo_b.init_server(hp_b.seed,
                                                                init))
        t_ckpt = time.perf_counter() - t1
        if (b_sched2.clock.now != b_sched.clock.now
                or b_runner2.engine.rounds_done != SIM_CHUNK
                or b_runner2.cum_bytes != b_runner.cum_bytes
                or b_runner2.resident_bytes() != b_runner.resident_bytes()
                or not all(torch.equal(x, y) for i in b_runner.store.ids()
                           for x, y in zip(b_runner.store._rows[int(i)],
                                           b_runner2.store._rows[int(i)]))):
            fail("sim (b): the loaded runner's clock, rounds, bytes or "
                 "store differ from the saved one's")
        st_b2, t_chunk2 = _profiled(
            f"(b) chunk 2, {SIM_ROUNDS - SIM_CHUNK} rounds, K={COHORT_K:,}",
            lambda: b_runner2.run(st_b2, rounds=SIM_ROUNDS - SIM_CHUNK,
                                  chunk_rounds=SIM_CHUNK,
                                  log_every=SIM_CHUNK), smi, profiles)
    launches = dict(_build.LAUNCHES)
    sim_launches["(b) cohort"] = launches
    spans = _spans(trace_path)
    if launches["weighted_era_sharpen"] != SIM_ROUNDS or \
            launches["era_sharpen"] != 0:
        fail(f"sim (b): launches {launches}, expected K2 {SIM_ROUNDS}, K1 0")
    recs = b_runner2.history.records
    if len(recs) != SIM_ROUNDS or any(
            not all(torch.isfinite(torch.tensor(float(v))).item()
                    for v in r.values() if isinstance(v, (int, float)))
            for r in recs):
        fail(f"sim (b): {len(recs)} records or a value that is not finite")
    t = [r["t_cum"] for r in recs]
    if not all(b > a for a, b in zip(t, t[1:])):
        fail(f"sim (b): the virtual clock does not advance: {t}")
    say(f"sim (b) [{smi}]: chunk 1 {t_chunk1:.3f} s, save + load "
        f"{t_ckpt:.3f} s (store file {os.path.getsize(b_path + '.store')} B), "
        f"chunk 2 {t_chunk2:.3f} s (under the profiler); peak device memory "
        f"{torch.cuda.max_memory_allocated()} B; resident_bytes "
        f"{b_runner2.resident_bytes()} for {len(b_runner2.store)} touched "
        f"clients of {COHORT_K}; peak_slab_bytes {b_runner2.peak_slab_bytes}; "
        f"participants {[r['participants'] for r in recs]}; test_acc "
        f"{[r['test_acc'] for r in recs if 'test_acc' in r]}; virtual clock "
        f"{b_sched2.clock.now:.3f} s; cum_bytes {b_runner2.cum_bytes}; "
        f"launches {json.dumps(launches)}")
    say("sim (b) host spans " + json.dumps(
        {k: {"seconds": sum(v), "count": len(v), "each": v}
         for k, v in spans.items()}))
    # K2 on round 0's slab against the participants' lanes alone
    (p, w), = b_in.calls
    live = w > 0
    err = check_k2_slab("sim (b) round 0", (p, w),
                        (p[live].contiguous(), w[live]), hp_b.temperature)
    say(f"sim (b) K2 on the {tuple(p.shape)} slab stack against K2 on its "
        f"{int(live.sum())} participants' stack [{smi}]: teachers within "
        f"1e-6 (largest difference {err:.3e})")
    del b_in, p, w
    part_done("(b)")

    # (d) card against CPU: keyed draws bitwise, a K=4 cohort round
    for r in (0, 7):
        ids = torch.arange(SIM_K)
        for dev_ids in (ids, ids.cuda()):
            p = prng.epoch_perms(0, r, "update", dev_ids, 5, 200, 100)
            o = open_batch(0, r, 10_000, 1_000, dev_ids.device)
            if dev_ids.is_cuda:
                pc, oc = p.cpu(), o.cpu()
            else:
                pp, op = p, o
        if not (torch.equal(pc, pp) and torch.equal(oc, op)):
            fail(f"sim (d): keyed draws of round {r} differ on the card")
    say("sim (d): keyed update permutations (100 clients x 5 epochs x 200) "
        "and the open batch (1000 of 10000) bitwise equal on the card and "
        "the CPU, rounds 0 and 7")
    hp_d = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1,
                      batch_size=100, open_batch=200)
    cpu_task = build_image_task(1, K=4, n_private=800, n_open=400, n_test=200,
                                distribution="non_iid", hw=28, device="cpu")
    cohort = [0, 2, 3]
    cpu_algo = DSFLAlgorithm(apply_mnist_cnn, hp_d, device="cpu")
    server = cpu_algo.init_server(0, _paper_cnn("cpu")).server
    clients = cpu_algo.init_cohort(0, _paper_cnn("cpu"), cohort, 4)
    results = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64),
                          ("cpu", torch.float32)):
        a = DSFLAlgorithm(apply_mnist_cnn, hp_d, use_kernel=True,
                          device=device)
        wide = (lambda x: x.double()) if dtype == torch.float64 else \
            (lambda x: x)
        prov_d = ArrayProvider(type(cpu_task)(*(
            x.to(device) for x in (wide(cpu_task.x_clients),
                                   cpu_task.y_clients, wide(cpu_task.open_x),
                                   wide(cpu_task.x_test), cpu_task.y_test)),
            cpu_task.n_classes))
        mv = lambda t: {k: v.to(device) for k, v in (
            _widen(t) if dtype == torch.float64 else t).items()}
        start = a.init_from(mv(clients.params), mv(clients.model_state),
                            mv(server.params), mv(server.model_state))
        eng = FedEngine(a)
        with deterministic(), native_convs():
            st = eng.run(start, prov_d.slab(cohort), rounds=1,
                         ctx_plan={"mask": torch.tensor([[1.0, 0.0, 1.0]])},
                         cohort=torch.tensor(cohort, device=device),
                         population=4)
        results[(device, dtype)] = (st, eng.history[-1])
    # held to the CPU's float64 round, as phase 6's rounds are
    card, exact, cpu32 = (results[k][0] for k in results)
    worst = _compare_leaves("sim (d) cohort round card vs cpu float64",
                            card, exact)
    say(f"sim (d) K=4 cohort round (ids {cohort}, one absent) card vs the "
        f"CPU's float64 round [{smi}]: every leaf within atol "
        f"{CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL} (largest difference "
        f"{worst:.3e}, {_share_of_limit(card, exact):.3f} of the limit; the "
        f"CPU's float32 round is "
        f"{_largest(cpu32, exact):.3e} from it), keyed draws")
    part_done("(d)")
    say("sim trace " + json.dumps(profiles))
    return sim_launches


# --------------------------------------------------- phase "paper models" --
# The paper's other three models (§4.1), each at full width through one
# DS-FL ERA configuration: (name, K, C, trainable values, all values, the
# learning rate of the update and the distillation).  K is the paper's
# (benchmarks/comm_cost.py:12-17); K1 aggregates (K, |o_r| = 1000, C).
# fmnist_cnn trains at 0.01, not the defaults' 0.1: at 0.1 its local update
# diverges (on the card, a first round's update loss of 83.9 and a NaN
# distillation loss), as the reference's does on the same data.  The
# card-vs-CPU round takes the same rates: at 0.1 fmnist_cnn's small round
# heads off too, and float32 rounding then grows past CARD_VS_CPU_ATOL/RTOL
# on its own (the CPU's float32 round strays that far from its float64
# round; the check prints that distance).
PAPER_MODELS = (("fmnist_cnn", 100, 10, 2_759_080, 2_759_976, 0.01),
                ("reuters_dnn", 10, 46, 5_193_390, 5_194_670, 0.1),
                ("imdb_lstm", 10, 2, 648_386, 648_386, 0.1))
PAPER_LR = {name: lr for name, *_, lr in PAPER_MODELS}
# one round each (two until the script ran past its 1200 s on a slow
# host; the second round took as long as the first)
PAPER_ROUNDS = 1
IMDB_SEQ = 80          # the maxlen of Keras' imdb_lstm.py example


def bow_task(seed, K, n_private, n_open, n_test, device, alpha=0.5,
             vocab=10_000, n_classes=46):
    """The Reuters stand-in: ``make_bow`` documents (one topic table for
    the private, open and test sets), the private set dealt to K clients
    by ``partition.dirichlet(alpha)`` (equal stacks cut to the smallest
    client's share)."""
    from repro_torch.data import partition, synthetic
    from repro_torch.data.pipeline import FederatedImageTask
    from repro_torch.device import generator
    gen = generator(device, seed)
    x, y = synthetic.make_bow(gen, n_private + n_open + n_test, n_classes,
                              vocab)
    xp, yp = x[:n_private], y[:n_private]
    idx = partition.dirichlet(gen, yp, K, alpha, n_classes)
    return FederatedImageTask(xp[idx], yp[idx], x[n_private:-n_test],
                              x[-n_test:], y[-n_test:], n_classes)


def imdb_task(seed, K, n_private, n_open, n_test, device, seq=IMDB_SEQ,
              vocab=20_000):
    """The IMDb stand-in: ``make_token_lm`` sequences of two domains, the
    domain as the binary label.  ``partition.ratio_non_iid`` deals
    ``n_private // K`` a client, 9:1 one way or the other, so it needs
    exactly half of each label: the private set is the first
    ``n_private / 2`` sequences of each domain from a larger draw."""
    from repro_torch.data import partition, synthetic
    from repro_torch.data.pipeline import FederatedImageTask
    from repro_torch.device import generator
    gen = generator(device, seed)
    toks, dom = synthetic.make_token_lm(gen, n_private * 11 // 10 + 200, seq,
                                        vocab, n_domains=2)
    keep = torch.cat([(dom == d).nonzero()[:n_private // 2, 0]
                      for d in (0, 1)]).sort().values
    xp, yp = toks[keep], dom[keep]
    counts = torch.bincount(yp, minlength=2).tolist()
    if counts != [n_private // 2] * 2:
        fail(f"imdb task: private labels {counts}, need {n_private // 2} each")
    idx = partition.ratio_non_iid(gen, yp, K, 0.9)
    open_x, _ = synthetic.make_token_lm(gen, n_open, seq, vocab, n_domains=2)
    x_test, y_test = synthetic.make_token_lm(gen, n_test, seq, vocab,
                                             n_domains=2)
    return FederatedImageTask(xp[idx], yp[idx], open_x, x_test, y_test, 2)


def paper_task(name, K, device, small=False):
    """The phase's task of ``name`` on ``device``: the full one, or (small)
    the card-vs-CPU check's, K=2 and 100 private samples a client."""
    from repro_torch.data.pipeline import build_image_task
    if name == "fmnist_cnn":
        sizes = (200, 200, 100) if small else (20_000, 10_000, 2_000)
        return build_image_task(0, K, *sizes, distribution="non_iid", hw=28,
                                device=device)
    if name == "reuters_dnn":
        return bow_task(0, K, *((600, 200, 100) if small else
                                (8_000, 2_000, 1_000)), device)
    return imdb_task(0, K, *((200, 200, 100) if small else
                             (10_000, 5_000, 1_000)), device)


def paper_card_vs_cpu(smi, name):
    """One DS-FL ERA round of ``name`` at full width, K=2, learning rate
    PAPER_LR, from the same weights and draws on the card (K1, float32,
    deterministic algorithms, native convolutions) and on the CPU in
    float64: every leaf within CARD_VS_CPU_ATOL/RTOL and the metrics as
    phase 6 holds them; the CPU's float32 round is printed beside.
    Returns the largest difference."""
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import FederatedImageTask
    from repro_torch.models.smallnets import make_smallnet
    K = 2
    lr = PAPER_LR[name]
    hp = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1,
                    batch_size=50, open_batch=100, lr=lr, lr_distill=lr)
    net = make_smallnet(name, device="cpu")
    cpu_task = paper_task(name, K, "cpu", small=True)
    gen = torch.Generator().manual_seed(7)
    models = [net.init(gen) for _ in range(K + 1)]
    draws = [_round_draws(7, K, hp, cpu_task.y_clients.shape[1],
                          cpu_task.open_x.shape[0], "cpu")]
    results = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64),
                          ("cpu", torch.float32)):
        f64 = dtype == torch.float64
        mv = lambda d: {k: v.to(device) for k, v in (
            _widen(d) if f64 else d).items()}
        task = FederatedImageTask(*(
            (t.double() if f64 and t.is_floating_point() else t).to(device)
            for t in (cpu_task.x_clients, cpu_task.y_clients, cpu_task.open_x,
                      cpu_task.x_test, cpu_task.y_test)), cpu_task.n_classes)
        stack = lambda i: mv({k: torch.stack([m[i][k] for m in models[1:]])
                              for k in models[0][i]})
        algo = DSFLAlgorithm(net.apply, hp, use_kernel=True, device=device)
        eng = FedEngine(algo, make_eval_fn(net.apply, task.x_test,
                                           task.y_test))
        with deterministic(), native_convs():
            st = eng.run(algo.init_from(stack(0), stack(1), mv(models[0][0]),
                                        mv(models[0][1])),
                         task, draws=draws)
        results[(device, dtype)] = (st, eng.history[-1])
    (card, h_card), (exact, h_cpu), (cpu32, _) = results.values()
    worst = _compare_leaves(f"paper models {name} card vs cpu float64",
                            card, exact)
    n_test = cpu_task.y_test.shape[0]
    for key, v in h_cpu.items():
        tol = (1.0 / n_test + 1e-6) if key == "test_acc" else \
            CARD_VS_CPU_ATOL + CARD_VS_CPU_RTOL * abs(v)
        if abs(h_card[key] - v) > tol:
            fail(f"paper models {name} card vs cpu: metric {key} "
                 f"{h_card[key]} vs {v}")
    say(f"paper models {name} card vs cpu [{smi}]: K={K}, one DS-FL ERA "
        f"round at full width, lr {lr}, every leaf within atol "
        f"{CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL} of the CPU's float64 "
        f"round (largest "
        f"difference {worst:.3e}, {_share_of_limit(card, exact):.3f} of the "
        f"limit; the CPU's float32 round is {_largest(cpu32, exact):.3e} "
        f"from it), metrics too: cuda {json.dumps(h_card)}")
    return worst


def phase_paper_models(smi):
    """The paper's F-MNIST CNN, Reuters DNN and IMDb LSTM at full width
    (phase "paper models"): PAPER_ROUNDS DS-FL ERA rounds each through
    ``FedEngine.run`` with ``DSFLAlgorithm(use_kernel=True)`` and
    ``DSFLConfig``'s defaults but the learning rate (PAPER_MODELS), the
    launch counts zeroed before each model's rounds and read after (K1
    once a round, nothing else); the measured bytes a round against
    ``CommModel``'s, DS-FL and FedAvg; then each model's round on the card
    against the CPU's float64 round.  Returns each kernel's launches by
    model."""
    from repro_torch.core.algorithms import (DSFLAlgorithm, FedAvgAlgorithm,
                                             FedAvgConfig)
    from repro_torch.core.comm import CommModel
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.kernels import _build
    from repro_torch.models.smallnets import make_smallnet, param_count
    t_phase = time.perf_counter()
    launches = {}
    for name, K, C, n_train_want, n_all_want, lr in PAPER_MODELS:
        hp = DSFLConfig(rounds=PAPER_ROUNDS, lr=lr, lr_distill=lr)
        t_model = time.perf_counter()
        net = make_smallnet(name, device="cuda")
        task = paper_task(name, K, "cuda")
        torch.cuda.synchronize()
        t_data = time.perf_counter() - t_model
        algo = DSFLAlgorithm(net.apply, hp, use_kernel=True)
        eng = FedEngine(algo, make_eval_fn(net.apply, task.x_test,
                                           task.y_test))
        state = eng.init(net.init, task)
        wg, sg = state.server.params, state.server.model_state
        n_train, n_all = param_count(wg), param_count(wg, sg)
        if (n_train, n_all) != (n_train_want, n_all_want):
            fail(f"{name}: {n_train} trainable / {n_all} values, expected "
                 f"{n_train_want} / {n_all_want}")
        torch.cuda.synchronize()
        _build.reset_launches()                   # this model's window
        recs = []
        for r in range(PAPER_ROUNDS):
            state, rec = timed_round(eng, state, task, f"{name} era")
            recs.append(rec)
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)    # end of the window
        want = {"era_sharpen": PAPER_ROUNDS}
        for k, v in launches[name].items():
            if v != want.get(k, 0):
                fail(f"{name}: {k} launched {v} times in {PAPER_ROUNDS} "
                     f"rounds, expected {want.get(k, 0)}")
        cm = CommModel(K, C, n_all, hp.open_batch)
        measured = {"dsfl": eng.measured_round_bytes(state, task)}
        fa = FedAvgAlgorithm(net.apply, FedAvgConfig())
        measured["fedavg"] = FedEngine(fa).measured_round_bytes(
            fa.init_from(wg, sg), task)
        analytic = {"dsfl": cm.dsfl_round(), "fedavg": cm.fl_round()}
        if measured != analytic:
            fail(f"{name}: measured bytes {measured} differ from CommModel's "
                 f"{analytic}")
        first, later = recs[0], recs[1:]
        say(f"paper models {name} " + json.dumps(dict(
            K=K, lr=lr, k1_shape=[K, hp.open_batch, C], private_per_client=int(
                task.y_clients.shape[1]), values=n_all, trainable=n_train,
            data_seconds=t_data, first_round_seconds=first["seconds"],
            later_round_seconds=[r["seconds"] for r in later],
            peak_bytes=max(r["max_memory_allocated"] for r in recs),
            test_acc=[r["test_acc"] for r in recs],
            update_loss=[r["update_loss"] for r in recs],
            launches={k: v for k, v in launches[name].items() if v},
            dsfl_bytes=measured["dsfl"], fedavg_bytes=measured["fedavg"],
            dsfl_over_fedavg=measured["dsfl"] / measured["fedavg"])) +
            f" [{smi}]")
        del eng, state, task, algo
        torch.cuda.empty_cache()
    for name, *_ in PAPER_MODELS:
        paper_card_vs_cpu(smi, name)
    say(f"paper models: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase llm ----
LLM_K, LLM_B, LLM_S, LLM_V = 2, 8, 128, 50_280
LLM_N = LLM_B * LLM_S                  # rows of the teacher and the KD term
LLM_K5 = (LLM_B, LLM_S, 80, 64, 1, 128)  # a client's prediction, Q = seq
# The route check: a DS-FL round at full width in float32, depth cut to
# LLM_ROUTE_LAYERS (the input state, both routes' results and a client's
# f32 gradients at 64 layers, 4 x 21.6 GB, would not fit in 80 GB), split
# at the wire as the round is.  (a) The prediction leg: each client's
# open-batch logits through K5 and through the model's differentiable SSD
# block, held to ROUTE_RTOL of their largest magnitude, as the serving
# route check holds its logits; the plain route with a seeded 1% fault in
# the SSD core must land outside.  The uploads are bf16 (the reference's
# wire type), where a logit difference of 1e-6 flips a value on a
# rounding boundary by one step, and sharpening (T = 0.1) amplifies a flip
# tenfold: so (b) and (c) take the kernel route's uploads, the same
# inputs on both routes.  (b) The f32 teacher through K1 and through the
# plain ERA, and the KD loss and its gradient on client 0's logits through
# K3/K4 and through autograd of the plain loss, each held to
# LLM_ROUTE_RTOL (the plain K4 and autograd already differ by 3e-5 of the
# largest gradient on the CPU); a 1% fault in the teacher and in the
# gradient must land outside.  (c)
# The rest of the round (teacher, hybrid steps) through the kernels and
# through the plain route: the loss and every leaf's update (new minus
# old, where the routes differ; the parameters would hide it) within
# LLM_ROUND_RTOL of their largest magnitude.  That is a composition check
# only: the CPU's plain versions and autograd already leave 2e-4 of a
# leaf's largest update between the routes (the C projection's), and a 1%
# teacher fault moves the updates by just 4e-4 to 1.6e-3 of it, so no
# tolerance tells the two apart there; (b) is where each kernel's check
# has its power.
LLM_ROUTE_LAYERS = 16
LLM_ROUTE_RTOL = 1e-3
LLM_ROUND_RTOL = 1e-2
# Phase "llm qwen1.5-4b": the same windows and checks for the dense family.
# Its route check runs 12 of the 40 layers in f32 (a client's 5.4 GB; the
# stack, both routes' updates and a client's gradients about 50 GB) and has
# no prediction leg (no kernel in a dense forward).
QWEN_V = 151_936
QWEN_ROUTE_LAYERS = 12


def _llm_window(body):
    """``body()`` with the launch counts zeroed just before and read just
    after, the peak device memory reset, on the host clock around a
    synchronize."""
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = body()
    torch.cuda.synchronize()
    return out, dict(seconds=time.perf_counter() - t0,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     launches=dict(_build.LAUNCHES))


def _llm_expect(name, launches, want):
    """Each kernel's launches in a window against what its path takes."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        fail(f"{name}: launches {launches}, the path takes {full}")


def fed_window(smi, label, base, vocab, n_params, per_window, name, argv,
               schedule, want, extra=None):
    """One window of the LLM trainer: a federation set up from the CLI's
    flags ``base + argv`` (``train.setup``) and its rounds
    (``train.run_rounds``; ``schedule`` is a list of (rounds,
    active_budget)), with the launch counts zeroed before and read after,
    held to ``want``; its bytes to `CommModel`, ``n_params`` a client and
    finite losses.  ``extra(fed, rec)``, run after the window, returns
    more values for the line.  Prints an ``{label} [...] {...}`` line,
    records the launches in ``per_window[name]`` and returns the
    federation."""
    from repro_torch.core.comm import CommModel
    from repro_torch.launch import train
    args = train.parse_args(base + argv)

    def body():
        fed = train.setup(args)
        recs = []
        for n, budget in schedule:
            recs += train.run_rounds(fed, n, active_budget=budget)
        return fed, recs

    (fed, recs), w = _llm_window(body)
    n = fed.params_per_client
    cm = CommModel(LLM_K, vocab, n, open_batch=LLM_N)
    expect = {"fp16": cm.dsfl_fp16_round(),
              "topk": cm.dsfl_topk_round(args.topk or 0),
              "dense_f32": cm.fl_round()}[fed.engine.codec.name]
    losses = [r["loss"] for r in recs]
    rec = dict(run=name, rounds=len(recs),
               seconds_first_round=recs[0]["seconds"],
               seconds_later_rounds=[r["seconds"] for r in recs[1:]],
               losses=losses, exchange_bytes=fed.exchange_bytes,
               comm_model_bytes=expect,
               fedavg_fp32_bytes=cm.fl_round(),
               participants=[r.get("participants", LLM_K) for r in recs],
               params_per_client=n, **w)
    if extra is not None:
        rec.update(extra(fed, rec))
    say(f"{label} [{smi}] " + json.dumps(rec))
    if n != n_params:
        fail(f"{label} {name}: {n} parameters a client, expected "
             f"{n_params}")
    if not all(np.isfinite(losses)):
        fail(f"{label} {name}: a loss is not finite: {losses}")
    if fed.exchange_bytes != expect:
        fail(f"{label} {name}: measured {fed.exchange_bytes} B a round, "
             f"CommModel {expect}")
    _llm_expect(f"{label} {name}", w["launches"], want)
    per_window[name] = w["launches"]
    return fed


def llm_windows(smi, label, arch, vocab, n_params, k5, teacher_note,
                era_rounds=3):
    """The LLM trainer's five windows through `repro_torch.launch.train`'s
    code path (``parse_args``, ``setup``, ``run_rounds``, ``run_local``) at
    ``arch``'s full width, K = 2, batch 8, seq 128 (phases "llm" and "llm
    qwen1.5-4b"): DS-FL ERA ``era_rounds`` rounds (then `llm_step_trace`),
    top-k 8 1 round, participation 0.5 (dense masked, then sparse), FedAvg 2 rounds,
    ``local`` 2 steps.  Each window is held to exactly the launches its
    path takes (``k5`` a prediction: 64 a Mamba layer stack, 0 for the
    dense family; K1 a dense teacher, K2 a weighted one, K3/K4 a client
    step), its bytes to `CommModel`, ``n_params`` a client and finite
    losses.  Returns each window's launches."""
    from repro_torch.launch import train
    base = ["--arch", arch, "--clients", str(LLM_K), "--batch", str(LLM_B),
            "--seq", str(LLM_S)]
    per_window = {}
    fed_rounds = functools.partial(fed_window, smi, label, base, vocab,
                                   n_params, per_window)

    # DS-FL ERA: K5 for each client's prediction and for the measured
    # payload, K1 once a round, K3/K4 once a client step
    n = era_rounds
    fed = fed_rounds("dsfl era", ["--mode", "dsfl"], [(n, "auto")],
                     dict(ssd_chunk=k5 * (1 + n * LLM_K), era_sharpen=n,
                          distill_loss_fwd=n * LLM_K,
                          distill_loss_bwd=n * LLM_K))
    llm_step_trace(smi, fed, label, teacher_note)
    del fed
    fed_rounds("dsfl topk 8", ["--mode", "dsfl", "--topk", "8"], [(1, "auto")],
               dict(ssd_chunk=k5 * (1 + LLM_K), era_sharpen=1,
                    distill_loss_fwd=LLM_K, distill_loss_bwd=LLM_K))
    # participation 0.5 through SimRunner: the first round dense masked
    # (both clients predict and step, the absent one's step is dropped), the
    # second participation-sparse (one lane); K2 for both teachers; K5 also
    # for the engine's and the runner's measured payloads
    fed = fed_rounds("dsfl participation 0.5",
                     ["--mode", "dsfl", "--participation", "0.5"],
                     [(1, None), (1, "auto")],
                     dict(ssd_chunk=k5 * (2 + LLM_K + 1),
                          weighted_era_sharpen=2,
                          distill_loss_fwd=LLM_K + 1,
                          distill_loss_bwd=LLM_K + 1))
    del fed
    fed = fed_rounds("fedavg", ["--mode", "fedavg"], [(2, "auto")], {})
    for k, v in fed.state.clients.params.items():
        if not torch.equal(v[0], v[1]):
            fail(f"{label} fedavg: clients differ at {k} after the broadcast")
    del fed
    local, w = _llm_window(lambda: train.run_local(train.parse_args(
        base + ["--mode", "local", "--steps", "2"])))
    rec = dict(run="local", steps=len(local),
               seconds_first_step=local[0]["seconds"],
               seconds_later_steps=[r["seconds"] for r in local[1:]],
               losses=[r["loss"] for r in local], **w)
    say(f"{label} [{smi}] " + json.dumps(rec))
    if not all(np.isfinite(rec["losses"])):
        fail(f"{label} local: a loss is not finite: {rec['losses']}")
    _llm_expect(f"{label} local", w["launches"], {})
    per_window["local"] = w["launches"]
    torch.cuda.empty_cache()
    return per_window


def _totals(per_window):
    return {k: sum(w[k] for w in per_window.values())
            for k in next(iter(per_window.values()))}


def phase_llm(smi):
    """LLM-scale DS-FL and FedAvg training of mamba2-2.7b at full width
    through `repro_torch.launch.train`'s code path (phase "llm")."""
    t_phase = time.perf_counter()
    # 2 ERA rounds, not 3: the script passed 700 s when phase "llm
    # qwen1.5-4b" joined it (714.7 s on an H100 80GB HBM3 at 700 W)
    per_window = llm_windows(smi, "llm", "mamba2-2.7b", LLM_V,
                             2_702_579_200, 64,
                             "2 predictions through K5, the teacher "
                             "through K1", era_rounds=2)
    checks = llm_kernel_checks(LLM_V, with_k5=True)
    llm_route_check(smi, "mamba2-2.7b", LLM_ROUTE_LAYERS)
    llm_card_vs_cpu(smi, "mamba2-2.7b")
    say(f"llm: phase took {time.perf_counter() - t_phase:.1f} s")
    return _totals(per_window), per_window, checks


def phase_llm_qwen(smi):
    """Phase "llm qwen1.5-4b": the dense family's LLM training, qwen1.5-4b
    at full width and depth through the trainer's windows (the seeded
    embedding scaled as `scale_embedding` does), K1/K2 on the wide-row
    route and K3/K4 at its shapes, the route check in f32 at a cut depth,
    and its smoke config's rounds on the card against the CPU."""
    from unittest import mock

    from repro_torch.launch import train
    from repro_torch.models.api import model_init
    t_phase = time.perf_counter()

    def scaled_init(cfg, gen, device):
        params = model_init(cfg, gen, device)
        scale_embedding(cfg, params)
        return params

    with mock.patch.object(train, "model_init", scaled_init):
        per_window = llm_windows(smi, "llm qwen1.5-4b", "qwen1.5-4b",
                                 QWEN_V, QWEN_VALUES, 0,
                                 "2 predictions, the teacher through K1 "
                                 "on the wide-row route")
    t_checks = time.perf_counter()
    checks = llm_kernel_checks(QWEN_V, with_k5=False, label="llm qwen1.5-4b")
    llm_route_check(smi, "qwen1.5-4b", QWEN_ROUTE_LAYERS)
    llm_card_vs_cpu(smi, "qwen1.5-4b")
    say(f"llm qwen1.5-4b: phase took {time.perf_counter() - t_phase:.1f} s "
        f"(checks {time.perf_counter() - t_checks:.1f} s)")
    return _totals(per_window), per_window, checks


def llm_step_trace(smi, fed, label="llm", teacher_note=""):
    """Where a round's time goes, outside the windows: the round's
    uploads and teacher, then client 0's hybrid step timed alone and once
    more under the profiler (host time, the card's busy time, idle share,
    top kernels).  A round is two predictions and two such steps; profiling a
    whole round (about 132,000 device activities) costs the profiler's own
    processing over 100 s."""
    from repro_torch.core import llm_dsfl
    hp, st, task = fed.engine.algo.hp, fed.state.clients.params, fed.task
    t0 = time.perf_counter()
    (probs,) = llm_dsfl.dsfl_exchange(fed.cfg, st, task.open_x, hp)
    teacher = llm_dsfl._aggregate_teacher(probs, hp, None)
    torch.cuda.synchronize()
    t_ex = time.perf_counter() - t0
    step = lambda: llm_dsfl.dsfl_client_step(
        fed.cfg, llm_dsfl.client(st, 0), llm_dsfl.client(task.x_clients, 0),
        task.open_x, teacher, hp)
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    trace = {}
    _profiled("dsfl client 0 hybrid step", step, smi, trace, phase=label)
    say(f"{label} trace [{smi}]: exchange ({teacher_note}) {t_ex:.3f} s; "
        f"client 0's hybrid step {t_step:.3f} s unprofiled; " +
        json.dumps(trace))


def llm_kernel_checks(V, with_k5, label="llm"):
    """K1-K5 against their plain versions at the shapes the LLM path
    launches them at: K1 and K2 on the (2, 1024, V) bf16 upload stack (K2
    with client 1 at weight 0), K1 also on the f32 stack the top-k round
    densifies its uploads into, K3/K4 on (1024, V) bf16 logits and teacher
    and, through ``ops.distill_loss``, on f32 logits against the bf16
    teacher (the smoke configs and the route check), and with ``with_k5``
    K5 at the prediction's (8, 128, 80, 64, 1, 128)."""
    from repro_torch.core.aggregation import topk_compress
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import era_sharpen as es
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd
    out = {"ssd_chunk": None}
    p = torch.softmax(torch.randn((LLM_K, LLM_N, V), generator=torch.
                                  Generator(device="cuda").manual_seed(31),
                                  device="cuda") * 4, -1).to(torch.bfloat16)
    w = torch.tensor([1.0, 0.0], device="cuda")
    # the top-k round densifies its uploads into an f32 stack (mostly
    # exact zeros) before K1: the same kernel's f32 instantiation
    tv, ti = topk_compress(p, 8)
    dense = torch.zeros(p.shape, dtype=torch.float32, device="cuda").scatter(
        -1, ti.long(), tv.float())
    out["era_sharpen"] = max(
        check(f"K1 {label} {tuple(p.shape)} bf16", es.era_sharpen(p, 0.1),
              es.era_sharpen_plain(p, 0.1), 1e-6),
        check(f"K1 {label} {tuple(p.shape)} f32, top-8 densified",
              es.era_sharpen(dense, 0.1), es.era_sharpen_plain(dense, 0.1),
              1e-6))
    del tv, ti, dense
    out["weighted_era_sharpen"] = check(
        f"K2 {label} {tuple(p.shape)} bf16, client 1 at weight 0",
        es.weighted_era_sharpen(p, w, 0.1),
        es.weighted_era_sharpen_plain(p, w, 0.1), 1e-6)
    del p
    z, t = _zt(LLM_N, V, 32, torch.bfloat16)
    loss, logz = dl.distill_loss_fwd(z, t)
    ploss, plogz = dl.distill_loss_fwd_plain(z, t)
    out["distill_loss_fwd"] = max(
        check(f"K3 {label} ({LLM_N}, {V}) bf16 loss", loss, ploss, 2e-2),
        check(f"K3 {label} ({LLM_N}, {V}) bf16 logZ", logz, plogz, 2e-2))
    tmass = t.float().sum(-1)
    gscale = torch.full((1,), 1.0 / LLM_N, device="cuda")
    out["distill_loss_bwd"] = check(
        f"K4 {label} ({LLM_N}, {V}) bf16",
        dl.distill_loss_bwd(z, t, plogz, tmass, gscale),
        dl.distill_loss_bwd_plain(z, t, plogz, tmass, gscale), 1e-6 / LLM_N,
        1e-2)
    # f32 logits, bf16 teacher: the wrapper widens the teacher (exact)
    zf = z.float().requires_grad_(True)
    lk = ops.distill_loss(zf, t)
    (gk,) = torch.autograd.grad(lk, zf)
    zp = z.float().requires_grad_(True)
    lp = dl.distill_loss_fwd_plain(zp, t.float())[0].mean()
    (gp,) = torch.autograd.grad(lp, zp)
    check(f"K3 {label} f32 logits, bf16 teacher ({LLM_N}, {V}) loss",
          lk.detach(), lp.detach(), 1e-4)
    # against autograd of the plain loss, whose logsumexp rounds otherwise:
    # |dz| <= 1/N, so 4e-6/N and 1e-5 of the value (tests/test_torch_cuda.py)
    check(f"K4 {label} f32 logits, bf16 teacher ({LLM_N}, {V}) dz", gk, gp,
          4e-6 / LLM_N, 1e-5)
    del z, t, zf, zp, gk, gp
    torch.cuda.empty_cache()
    if not with_k5:
        return out
    args = _ssd_inputs(*LLM_K5, seed=33)
    plan = ssd.launch_plan(*LLM_K5[:3], *LLM_K5[4:],
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    say(f"K5 plan {LLM_K5}: {plan}; kernel's shared memory "
        f"{ssd._lib().ssd_chunk_smem_bytes(LLM_S, 128, plan.heads_per_block)}"
        f" B")
    out["ssd_chunk"] = check(f"K5 llm {LLM_K5} f32", ssd.ssd_chunk(*args),
                             ssd.ssd_chunk_plain(*args), K5_TOL, K5_TOL)
    torch.cuda.empty_cache()
    return out


def _route_report(what, kern, base, fault, rtol, label="llm routes"):
    """Kernel route against plain route, and the faulty plain route
    against the plain route, each relative to the plain route's largest
    magnitude; fails unless the first is inside ``rtol`` and the second
    outside."""
    scale = float(base.abs().max())
    diff, ferr = max_err(kern, base), max_err(fault, base)
    say(f"{label} {what}: kernel route {diff:.4g}, 1% fault {ferr:.4g} "
        f"from the plain route; largest magnitude {scale:.4g}; tolerance "
        f"{rtol} of it")
    if diff > rtol * scale:
        fail(f"{label}: {what} differs by {diff:.4g}, above {rtol} of "
             f"{scale:.4g}")
    if ferr <= rtol * scale:
        fail(f"{label}: a 1% fault in {what} passes the tolerance, so "
             f"the check cannot see one")
    return diff / scale


def llm_route_check(smi, arch, layers, leg_rtol=LLM_ROUTE_RTOL):
    """The kernel route against the plain route at ``arch``'s full width in
    float32 and ``layers`` of its depth (see LLM_ROUTE_LAYERS), each kernel
    leg of (b) held to ``leg_rtol``; the prediction leg (a) only where K5
    runs in it (Mamba)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.core import llm_dsfl
    from repro_torch.core.losses import softmax_xent
    from repro_torch.core.llm_algorithms import stack_init
    from repro_torch.data.pipeline import build_lm_task
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models.api import model_init, model_logits
    t_check = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=layers, dtype="float32")
    label = "llm routes" if arch == "mamba2-2.7b" else f"llm {arch} routes"
    task = build_lm_task(0, LLM_K, LLM_B, LLM_S, cfg.vocab, device="cuda")
    st = stack_init(0, lambda g: model_init(cfg, g, "cuda"), LLM_K, "cuda")
    # The seeded init's tied embedding is unit-normal, which puts the full
    # width's logits near +-900: there every softmax is one-hot in f32 and
    # both routes agree bitwise whatever they compute.  Scaled by
    # d_model^-1/2 the logits are O(1), so the softmax, the teacher and the
    # KD gradient are dense and the comparison has something to compare.
    st["embed/tok"] = st["embed/tok"] * cfg.d_model ** -0.5
    g = torch.Generator(device="cuda").manual_seed(11)
    jitter = lambda t: t * (1 + ROUTE_FAULT * (torch.randint(
        0, 2, t.shape, generator=g, device="cuda") * 2 - 1))
    rel = {}

    # (a) the prediction leg
    real_local = ssm._chunk_local
    with torch.no_grad():
        for k in range(LLM_K if cfg.arch_type == "ssm" else 0):
            p = llm_dsfl.client(st, k)
            logits = {}
            for route, uk, fn in (("kernel", True, real_local),
                                  ("plain", False, real_local),
                                  ("fault", False, lambda *a: jitter(
                                      real_local(*a)))):
                with mock.patch.object(ssm, "_chunk_local", fn):
                    logits[route] = model_logits(cfg, p, task.open_x,
                                                 use_ssd_kernel=uk)[0]
            rel[f"logits {k}"] = _route_report(
                f"client {k}'s open-batch logits (the prediction leg, K5)",
                logits["kernel"], logits["plain"], logits["fault"],
                ROUTE_RTOL, label)
            del logits
    # (b) the teacher (K1) and the KD term (K3/K4) on the same uploads
    hp_k = llm_dsfl.LLMDsflHP(lr=3e-3, use_kernel=True)
    hp_p = llm_dsfl.LLMDsflHP(lr=3e-3)
    (probs,) = llm_dsfl.dsfl_exchange(cfg, st, task.open_x, hp_k)
    t_plain = llm_dsfl._aggregate(probs, hp_p, None)
    rel["teacher"] = _route_report(
        "the f32 teacher (K1)", llm_dsfl._aggregate(probs, hp_k, None),
        t_plain, jitter(t_plain), leg_rtol, label)
    teacher = t_plain.to(torch.bfloat16)
    with torch.no_grad():
        z0 = model_logits(cfg, llm_dsfl.client(st, 0), task.open_x,
                          use_ssd_kernel=False)[0]
    grads = {}
    for route, fn in (("kernel", ops.distill_loss), ("plain", softmax_xent)):
        z = z0.detach().clone().requires_grad_(True)
        loss = fn(z, teacher)
        grads[route] = (loss.detach().reshape(1),
                        torch.autograd.grad(loss, z)[0])
    rel["kd loss"] = _route_report(
        "the KD loss (K3)", grads["kernel"][0], grads["plain"][0],
        grads["plain"][0] * (1 + ROUTE_FAULT), leg_rtol, label)
    rel["kd grad"] = _route_report(
        "the KD gradient (K4)", grads["kernel"][1], grads["plain"][1],
        jitter(grads["plain"][1]), leg_rtol, label)
    del grads, z0, t_plain, teacher
    # (c) the rest of the round on the same uploads
    upd = {}
    for route, hp in (("kernel", hp_k), ("plain", hp_p)):
        new, loss = llm_dsfl.dsfl_round_finish(cfg, st, task.x_clients,
                                               task.open_x, (probs,), hp)
        upd[route] = dict({k: new[k].float() - st[k].float() for k in st},
                          loss=loss.reshape(1))
        del new
    torch.cuda.synchronize()
    worst = ("", 0.0)
    for k, base in upd["plain"].items():
        scale = float(base.abs().max())
        r = max_err(upd["kernel"][k], base) / max(scale, 1e-30)
        worst = max(worst, (k, r), key=lambda kv: kv[1])
        if r > LLM_ROUND_RTOL:
            fail(f"{label}: the round's {k} differs by {r:.3e} of its "
                 f"largest magnitude {scale:.4g}, above {LLM_ROUND_RTOL}")
    say(f"{label} [{smi}]: f32, {layers} layers at full width, "
        f"K={LLM_K}: kernel route vs plain route relative to the largest "
        f"magnitude: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) +
        f"; the round's loss and {len(st)} leaves' updates at most "
        f"{worst[1]:.3e} ({worst[0]}; tolerance {LLM_ROUND_RTOL}); "
        f"loss {float(upd['kernel']['loss']):.6f} vs "
        f"{float(upd['plain']['loss']):.6f}; "
        f"{time.perf_counter() - t_check:.1f} s")
    del upd, st, probs
    torch.cuda.empty_cache()


def llm_smoke_rounds(device, arch="mamba2-2.7b"):
    """One DS-FL round (``use_kernel`` on: the kernels on the card, their
    plain versions on the CPU) and one FedAvg round of ``arch``'s smoke
    config (K=2, batch 2, seq 32) on ``device``, from weights and data made
    on the CPU from seed 0 (a VLM's patches and an audio model's frames
    from `launch.train.extra_inputs`): [(params, loss), (params, loss)].
    Shared with tests/test_torch_cuda.py."""
    from repro_torch.configs import get_config
    from repro_torch.core.llm_algorithms import stack_init
    from repro_torch.core.llm_dsfl import (LLMDsflHP, dsfl_round_step,
                                           fedavg_round_step)
    from repro_torch.data.pipeline import build_lm_task
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models.api import model_init
    cfg = get_config(arch).smoke()
    task = build_lm_task(0, 2, 2, 32, cfg.vocab, device="cpu",
                         extras_fn=lambda b, g: extra_inputs(cfg, b, g))
    st = stack_init(0, lambda g: model_init(cfg, g, "cpu"), 2, "cpu")
    mv = lambda t: {k: v.to(device) for k, v in t.items()}
    return [dsfl_round_step(cfg, mv(st), mv(task.x_clients),
                            mv(task.open_x), LLMDsflHP(lr=5e-3,
                                                       use_kernel=True)),
            fedavg_round_step(cfg, mv(st), mv(task.x_clients), 1e-3)]


def llm_card_vs_cpu(smi, arch="mamba2-2.7b", label=None):
    """`llm_smoke_rounds` on the card against the same rounds on the CPU,
    leaf by leaf and in the loss."""
    runs = {d: [dict(p, loss=l.reshape(1))
                for p, l in llm_smoke_rounds(d, arch)]
            for d in ("cuda", "cpu")}
    label = label or ("llm" if arch == "mamba2-2.7b" else f"llm {arch}")
    worst = 0.0
    for kind, a, b in zip(("dsfl", "fedavg"), runs["cuda"], runs["cpu"]):
        for k in b:
            worst = max(worst, max_err(a[k].cpu(), b[k]))
            if not close(a[k].cpu(), b[k], CARD_VS_CPU_ATOL, CARD_VS_CPU_RTOL):
                fail(f"{label} card vs cpu: {kind} {k} differs by "
                     f"{max_err(a[k].cpu(), b[k]):.3e}")
    say(f"{label} card vs cpu [{smi}]: {arch}'s smoke config (f32), K=2: "
        f"a DS-FL round (kernels vs plain versions) and a FedAvg round agree "
        f"leaf by leaf and in the loss (max diff {worst:.3e}; atol "
        f"{CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL})")


# ------------------------------------------------------------ phase "moe" --
# (a) llama4-scout-17b-a16e at its full widths, depth cut from 48 to
# MOE_SCOUT_LAYERS (a layer is 4.15 GB in bf16: 16 experts of 3 x 5120 x
# 8192); (b) llama4-maverick-400b-a17b at its full widths and one block (a
# dense layer and a layer of 128 experts, 32.7 GB).  (c) one MoE FFN at
# scout's full width in float32 on MOE_ROUTE_TOKENS tokens, card against
# CPU: the routes equal except where the router's top-two gap is under
# MOE_ROUTE_GAP, the output within MOE_ROUTE_TOL where a group's routes all
# agree; scout and maverick smoke configs through a whole ServeEngine run,
# tokens equal; (d) jamba-1.5-large-398b's smoke config (a full-width
# block is 88 GB), prefill and decode with K5 in its Mamba sub-layers.
MOE_SCOUT_LAYERS = 12
MOE_MAVERICK_LAYERS = 2
MOE_ROUTE_TOKENS = 512
MOE_ROUTE_GAP = 1e-5
MOE_ROUTE_TOL = dict(atol=1e-4, rtol=1e-4)
JAMBA_SMOKE_K5 = 14         # one a Mamba sub-layer: 7 of 8, 2 blocks


def _moe_serving_model(arch, n_layers):
    """``arch`` at its full widths and ``n_layers``, bf16, seeded on the
    card, the tied embedding scaled as `scale_embedding` does."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models.api import model_init
    from repro_torch.models.base import param_count
    cfg = get_config(arch).replace(n_layers=n_layers)
    t0 = time.perf_counter()
    params = model_init(cfg, generator("cuda", 0), "cuda")
    scale_embedding(cfg, params)
    torch.cuda.synchronize()
    say(f"serve: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, pattern {cfg.pattern}, "
        f"{cfg.n_heads} heads of {cfg.hd} over {cfg.n_kv_heads} KV heads, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, "
        f"capacity factor {cfg.capacity_factor}, groups of "
        f"{cfg.moe_group_size}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"{param_count(params)} values, "
        f"{sum(v.numel() * v.element_size() for v in params.values())} "
        f"bytes, seeded init in {time.perf_counter() - t0:.1f} s")
    return cfg, params


@contextlib.contextmanager
def counted_drops():
    """`moe.route` patched to append each MoE FFN call's (routed (token,
    choice) pairs, dropped ones as a device tensor) to the list it
    yields, in call order."""
    from unittest import mock

    from repro_torch.models import moe
    calls, route = [], moe.route

    def counting(p, c, xg):
        out = route(p, c, xg)
        calls.append((out[3].numel(), (~out[3]).sum()))
        return out

    with mock.patch.object(moe, "route", counting):
        yield calls


def drop_summary(calls) -> dict:
    """Routed and dropped pairs of `counted_drops`' calls, the dropped
    share in all and each call's."""
    routed = sum(n for n, _ in calls)
    dropped = sum(int(d) for _, d in calls)
    return dict(routed=routed, dropped=dropped,
                share=dropped / max(routed, 1),
                per_call=[int(d) / n for n, d in calls])


def moe_drops(smi, cfg, params, label):
    """The serving window once more (outside its timing), with every MoE
    FFN's routed and dropped (token, choice) pairs counted on the device:
    in the (4, 2048) shot, in the four single inserts' shots and in decode
    (each slot's token a group of its own, as the reference's vmap over
    the slots routes it)."""
    from repro_torch.serve import Request, ServeEngine
    reqs = [Request(id=i, tokens=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(serve_prompts(cfg.vocab))]
    eng = ServeEngine(cfg, params, **SERVE_ENGINE, device="cuda")
    with counted_drops() as shot:
        eng.insert_batch(reqs[:4])
    with counted_drops() as inserts:
        for r in reqs[4:]:
            eng.insert(r)
    with counted_drops() as decode:
        _serve_drain(eng, 8)
    del eng
    out = {k: drop_summary(c) for k, c in (("shot", shot),
                                           ("inserts", inserts),
                                           ("decode", decode))}
    out["shot_per_layer"] = out["shot"]["per_call"]
    for k in ("shot", "inserts", "decode"):
        del out[k]["per_call"]
    say(f"{label} [{smi}]: (token, choice) pairs dropped by capacity: " +
        "; ".join(f"{k} {v['dropped']} of {v['routed']} ({v['share']:.2%})"
                  for k, v in out.items() if k != "shot_per_layer") +
        "; the shot's MoE layers in order: " +
        ", ".join(f"{x:.1%}" for x in out["shot_per_layer"]))
    return out


def moe_layer_timing(smi, cfg, params, label):
    """One MoE FFN of ``params``' first block at the (4, 2048) shot's and
    the 8-slot decode step's token counts (decode: groups of one token),
    in parts, on CUDA events: the router (`moe.route`), the one-hot
    dispatch and combine tensors (`moe.dispatch`), the two one-hot einsums
    that move tokens into and out of the experts' buffers, and the three
    expert products with the activation; beside the whole `moe.moe_ffn`.
    Inputs are seeded normal activations, so these routes are not the
    model's; the einsums' shapes do not depend on the routes."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models.transformer import _block
    from repro_torch.models.layers import sub
    p = sub(_block(params, 0), f"s{len(cfg.pattern) - 1}_ffn")
    g = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for shape, gs_cfg in (((4, 2048), cfg), ((8, 1), cfg.replace(
            moe_group_size=1))):
        x = torch.randn(shape + (cfg.d_model,), generator=g, device="cuda",
                        dtype=cfg.cdtype)
        gs = min(gs_cfg.moe_group_size, shape[0] * shape[1])
        C = moe.capacity(gs_cfg, gs)
        xg = x.reshape(-1, gs, cfg.d_model)
        r = moe.route(p, gs_cfg, xg)
        disp, comb = moe.dispatch(*r[:4], cfg.n_experts, C, x.dtype)
        xin = torch.einsum("gsec,gsd->egcd", disp, xg)

        def experts():
            h = (F.silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"]))
                 * torch.einsum("egcd,edf->egcf", xin, p["w_up"]))
            return torch.einsum("egcf,efd->egcd", h, p["w_down"])

        eout = experts()
        parts = {
            "route": lambda: moe.route(p, gs_cfg, xg),
            "dispatch tensors": lambda: moe.dispatch(*r[:4], cfg.n_experts,
                                                     C, x.dtype),
            "one-hot einsums": lambda: (
                torch.einsum("gsec,gsd->egcd", disp, xg),
                torch.einsum("gsec,egcd->gsd", comb, eout)),
            "expert products": experts,
            "moe_ffn": lambda: moe.moe_ffn(p, gs_cfg, x)}
        ms = {k: time_ms(fn, iters=10, warmup=2) for k, fn in parts.items()}
        rows = cfg.n_experts * xg.shape[0] * C
        ms["expert rows"] = rows
        out[f"{shape[0]}x{shape[1]}"] = ms
        say(f"{label} moe layer [{smi}]: {shape[0]} x {shape[1]} tokens "
            f"(groups of {gs}, capacity {C}, {rows} expert rows): " +
            ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()
                      if k != "expert rows") +
            f"; the one-hot einsums {ms['one-hot einsums'] / ms['moe_ffn']:.1%}"
            f" and the router with the dispatch tensors "
            f"{(ms['route'] + ms['dispatch tensors']) / ms['moe_ffn']:.1%} "
            f"of moe_ffn")
    say(f"{label} moe layer " + json.dumps(out))
    return out


def moe_route_check(smi):
    """(c) One MoE FFN at llama4-scout's full width in float32 (8.05 GB of
    experts) on MOE_ROUTE_TOKENS tokens, the same weights and tokens on
    the card and on the CPU: expert, rank and keep equal except where the
    router's top-two gap is under MOE_ROUTE_GAP; the output and the
    load-balance loss within MOE_ROUTE_TOL in every group whose routes all
    agree."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import moe
    cfg = get_config("llama4-scout-17b-a16e").replace(dtype="float32")
    p = moe.init_moe(generator("cuda", 3), cfg, "cuda")
    x = torch.randn((2, MOE_ROUTE_TOKENS // 2, cfg.d_model),
                    generator=generator("cuda", 4), device="cuda")
    gs = min(cfg.moe_group_size, MOE_ROUTE_TOKENS)
    runs, secs = {}, {}
    for device in ("cuda", "cpu"):
        pd = {k: v.to(device) for k, v in p.items()}
        xd = x.to(device)
        t0 = time.perf_counter()
        r = moe.route(pd, cfg, xd.reshape(-1, gs, cfg.d_model))
        y, aux = moe.moe_ffn(pd, cfg, xd)
        if device == "cuda":
            torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
        runs[device] = [t.cpu() for t in (*r[:4], y, aux)]
        del pd
    (_, ci, cr, ck, cy, ca), (_, hi, hr, hk, hy, ha) = runs["cuda"], \
        runs["cpu"]
    gates = torch.softmax(x.cpu().reshape(-1, gs, cfg.d_model)
                          @ p["router"].cpu(), dim=-1)
    top2 = torch.topk(gates, 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < MOE_ROUTE_GAP
    same = ((ci == hi) & (cr == hr) & (ck == hk)).all(dim=-1)
    if bool((~same & ~near).any()):
        fail(f"moe (c): {int((~same & ~near).sum())} tokens routed "
             f"differently on the card with a top-two gap >= {MOE_ROUTE_GAP}")
    agree = same.all(dim=-1)                       # (G,) groups
    yg, hg = cy.reshape(-1, gs, cfg.d_model), hy.reshape(-1, gs, cfg.d_model)
    err = max_err(yg[agree], hg[agree]) if bool(agree.any()) else None
    if err is not None and not close(yg[agree], hg[agree], **MOE_ROUTE_TOL):
        fail(f"moe (c): outputs differ by {err:.3e}")
    if bool(agree.all()) and not close(ca, ha, **MOE_ROUTE_TOL):
        fail(f"moe (c): aux {float(ca)} on the card, {float(ha)} on the CPU")
    rec = dict(device=smi, arch=cfg.name, tokens=MOE_ROUTE_TOKENS,
               group_size=gs, capacity=moe.capacity(cfg, gs),
               near_ties=int(near.sum()), routes_differ=int((~same).sum()),
               groups_compared=int(agree.sum()), groups=int(agree.numel()),
               kept=int(hk.sum()), choices=int(hk.numel()),
               out_max_abs_err=err, out_max_abs=float(hy.abs().max()),
               aux_card=float(ca), aux_cpu=float(ha),
               seconds_card=secs["cuda"], seconds_cpu=secs["cpu"],
               tolerance=MOE_ROUTE_TOL)
    say(f"moe (c) [{smi}]: {cfg.name} MoE FFN, d {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, {cfg.n_experts} experts, float32, "
        f"{MOE_ROUTE_TOKENS} tokens: routes differ at {rec['routes_differ']}"
        f" tokens, {rec['near_ties']} top-two gaps under {MOE_ROUTE_GAP}; "
        f"{rec['kept']} of {rec['choices']} choices kept; output max diff "
        f"{err} over {rec['groups_compared']} of {rec['groups']} groups "
        f"(largest |out| {rec['out_max_abs']:.4g}; atol/rtol "
        f"{MOE_ROUTE_TOL['atol']}); aux {rec['aux_card']:.6f} / "
        f"{rec['aux_cpu']:.6f}")
    say("moe (c) " + json.dumps(rec))
    return rec


def moe_serve_card_vs_cpu(smi, arch):
    """(c) ``arch``'s smoke config (float32, the embedding scaled) through
    one ServeEngine run on the card and on the CPU: four prompts (9, 10,
    17 and 30 tokens; the first two in one ``insert_batch``), 8 new tokens
    each, decode_chunk 1 then 4; the greedy tokens must be equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_init
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config(arch).smoke()
    params = model_init(cfg, torch.Generator().manual_seed(1), "cpu")
    scale_embedding(cfg, params)
    g = torch.Generator().manual_seed(6)
    reqs = [Request(id=i, tokens=tuple(torch.randint(
        0, cfg.vocab, (n,), generator=g).tolist()), max_new_tokens=8)
        for i, n in enumerate((9, 10, 17, 30))]
    out = {}
    for device in ("cuda", "cpu"):
        eng = ServeEngine(cfg, {k: v.to(device) for k, v in params.items()},
                          slots=4, seq_budget=64, buckets=(8, 16),
                          device=device)
        eng.insert_batch(reqs[:2])
        eng.step()
        eng.insert(reqs[2])
        eng.step()
        eng.insert(reqs[3])
        steps = 0
        while eng.n_active:
            eng.step(decode_chunk=1 if steps < 4 else 4)
            steps += 1
        out[device] = {r.id: r.tokens for r in eng.pop_completed()}
    if out["cuda"] != out["cpu"]:
        fail(f"moe (c) {arch}: the card served {out['cuda']}, the CPU "
             f"{out['cpu']}")
    distinct = len({t for v in out["cpu"].values() for t in v})
    say(f"moe (c) [{smi}]: {arch} smoke config (d {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_experts} experts top-{cfg.top_k}), "
        f"float32: ServeEngine tokens equal on the card and the CPU "
        f"({len(out['cpu'])} requests, {distinct} distinct tokens)")


def phase_moe(smi):
    """Phase "moe": (a) llama4-scout and (b) llama4-maverick served at full
    width through phase 7's engine and window (launch counts zeroed before
    the first insert and read after the last step: no kernel on this
    path), their drop shares and (scout) a traced shot; (c) the card
    against the CPU; (d) Jamba's smoke config with K5.  Returns the
    launches of each path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    launches = {}
    for arch, layers, short in (
            ("llama4-scout-17b-a16e", MOE_SCOUT_LAYERS, "llama4-scout"),
            ("llama4-maverick-400b-a17b", MOE_MAVERICK_LAYERS,
             "llama4-maverick")):
        cfg, params = _moe_serving_model(arch, layers)
        label = f"serve {short}"
        launches[short], prompts, rec = phase_serve(smi, cfg, params,
                                                    label=label)
        moe_drops(smi, cfg, params, label)
        moe_layer_timing(smi, cfg, params, label)
        if short == "llama4-scout":
            phase_trace(smi, cfg, params, prompts, label=f"trace {short}")
        del params
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    moe_route_check(smi)
    torch.cuda.empty_cache()
    for arch in ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"):
        moe_serve_card_vs_cpu(smi, arch)
    jamba = get_config("jamba-1.5-large-398b").smoke()
    _build.reset_launches()
    lm_card_vs_cpu(smi, jamba, 64, 8, label="moe (d) jamba smoke card vs cpu",
                   scaled=True)
    torch.cuda.synchronize()
    launches["jamba smoke"] = dict(_build.LAUNCHES)
    _llm_expect("moe (d) jamba smoke", launches["jamba smoke"],
                dict(ssd_chunk=JAMBA_SMOKE_K5))
    say(f"moe (d): jamba smoke launches {json.dumps(launches['jamba smoke'])}")
    say(f"moe: phase took {time.perf_counter() - t0:.1f} s ((c) and (d) "
        f"{time.perf_counter() - t_c:.1f} s)")
    return launches


# ------------------------------------------------------- phase "hot swap" --
# qwen1.5-4b served at full width (phase "serve qwen1.5-4b"'s engine) while
# `repro_torch.launch.train`'s DS-FL federation of it (phase "llm
# qwen1.5-4b"'s settings, K = 2) runs HOT_SWAP_ROUNDS rounds with
# `serve.attach`: K1 (wide-row route) once a round, K3/K4 once a client
# step.  Then phase "loadgen" drives the first LOADGEN_LAYERS of those
# weights' 40 layers with LOADGEN_SPEC: its decode is host-bound (about 557
# steps a run, three runs), and at 40 layers the phase took 152-212 s of
# the script, which passed 1000 s once phase "modality" joined it (1004 s
# on an H100 80GB HBM3 at 700 W); at 20 layers it took 69-108 s, and the
# script reached 1114.9 s on a slow host once phase "pod" joined it; at 10
# it took 38.0-38.7 s and the script 963.9 s once phase "tp" joined it;
# at 5 it took 26.3 s and the script 1153.0 s on a slow host once phases
# "dryrun" and "tp decode" joined it; at 3 it took 15.5 s and the script
# 1105.4 s on a slow host.
HOT_SWAP_ROUNDS = 2
LOADGEN_LAYERS = 1
LOADGEN_SPEC = dict(n_requests=32, rate=4.0, prompt_len=(4, 48),
                    max_new=(4, 16), vocab=QWEN_V, seed=0)


def phase_hot_swap(smi):
    """Phase "hot swap": a request before the run carries version 0, one
    after it version HOT_SWAP_ROUNDS; the served weights are bitwise
    ``algo.eval_params`` of the final state.  Returns (the window's
    launches, the served params)."""
    from unittest import mock

    from repro_torch.launch import train
    from repro_torch.models.api import model_init
    from repro_torch.serve import Request, ServeEngine, attach
    t0 = time.perf_counter()
    cfg, params = _serving_model("qwen1.5-4b", QWEN_VALUES)
    scale_embedding(cfg, params)
    srv = ServeEngine(cfg, params, **SERVE_ENGINE, device="cuda")
    prompt = serve_prompts(cfg.vocab)[6]           # 256 tokens, one shot

    def serve_one(rid):
        srv.insert(Request(id=rid, tokens=prompt, max_new_tokens=8))
        _serve_drain(srv, 8)
        (r,) = srv.pop_completed()
        return r

    before = serve_one(0)

    def scaled_init(cfg_, gen, device):
        p = model_init(cfg_, gen, device)
        scale_embedding(cfg_, p)
        return p

    args = train.parse_args(["--arch", "qwen1.5-4b", "--clients", str(LLM_K),
                             "--batch", str(LLM_B), "--seq", str(LLM_S),
                             "--mode", "dsfl"])
    with mock.patch.object(train, "model_init", scaled_init):
        fed = train.setup(args)
    algo = fed.engine.algo
    sync = attach(fed.engine, srv, algo)
    recs, w = _llm_window(lambda: train.run_rounds(fed, HOT_SWAP_ROUNDS))
    after = serve_one(1)
    want, _ = algo.eval_params(fed.state)
    differ = [k for k, v in want.items() if not torch.equal(srv.params[k], v)]
    alias = [k for k, v in srv.params.items()
             if v.data_ptr() == fed.state.clients.params[k].data_ptr()]
    # the copy alone: a swap's timer starts when eval_params returns, while
    # the device may still be computing the mean it launched
    torch.cuda.synchronize()
    t_copy = time.perf_counter()
    srv.swap_weights(want, version=srv.version)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t_copy
    rec = dict(device=smi, arch=cfg.name, rounds=HOT_SWAP_ROUNDS,
               round_seconds=[r["seconds"] for r in recs],
               losses=[r["loss"] for r in recs],
               swap_log=sync.swap_log, version_before=before.weights_version,
               version_after=after.weights_version,
               tokens_changed=before.tokens != after.tokens,
               serve_version=srv.version, copy_only_s=t_copy, **w)
    say(f"hot swap [{smi}] " + json.dumps(rec))
    if [r for r, _ in sync.swap_log] != list(range(1, HOT_SWAP_ROUNDS + 1)):
        fail(f"hot swap: swaps at rounds {sync.swap_log}")
    if (before.weights_version, after.weights_version) != (0,
                                                           HOT_SWAP_ROUNDS):
        fail(f"hot swap: versions {before.weights_version} before and "
             f"{after.weights_version} after the run")
    if differ or alias:
        fail(f"hot swap: served weights differ from eval_params at "
             f"{differ[:3]}, share storage with the trainer at {alias[:3]}")
    if not all(np.isfinite(rec["losses"])):
        fail(f"hot swap: a loss is not finite: {rec['losses']}")
    _llm_expect("hot swap", w["launches"], dict(
        era_sharpen=HOT_SWAP_ROUNDS, distill_loss_fwd=HOT_SWAP_ROUNDS * LLM_K,
        distill_loss_bwd=HOT_SWAP_ROUNDS * LLM_K))
    nbytes = lambda t: sum(v.numel() * v.element_size() for v in t.values())
    say(f"hot swap [{smi}]: swap latencies " +
        ", ".join(f"round {r}: {dt * 1e3:.3f} ms" for r, dt in sync.swap_log)
        + f" (the in-place copy of synchronized weights alone "
        f"{t_copy * 1e3:.3f} ms); window peak {w['peak_bytes']} B (the trainer, "
        f"{nbytes(params)} B of served weights, {nbytes(srv.cache)} B of "
        f"rings); versions 0 -> {after.weights_version}; served weights "
        f"bitwise eval_params")
    del fed, srv, want
    torch.cuda.empty_cache()
    say(f"hot swap: phase took {time.perf_counter() - t0:.1f} s")
    return w["launches"], cfg, params


def phase_loadgen(smi, cfg, params):
    """Phase "loadgen": `serve.run_load` on the first LOADGEN_LAYERS layers
    of the hot-swapped qwen1.5-4b weights (views; phase 7's engine, a fresh
    one each run) with LOADGEN_SPEC,
    three ways: the defaults, ``decode_chunk=8`` and ``batch_insert=True``.
    Every request must get the same tokens each way (the paths are
    token-identical) and the same requests complete and shed.  Prints each
    virtual summary and the tokens per wall second."""
    from repro_torch.kernels import _build
    from repro_torch.serve import (AdmissionQueue, LoadSpec, ServeEngine,
                                   run_load)
    t0 = time.perf_counter()
    cfg = cfg.replace(n_layers=LOADGEN_LAYERS)
    params = {k: v[:LOADGEN_LAYERS] if k.startswith("blocks/") else v
              for k, v in params.items()}
    spec = LoadSpec(**LOADGEN_SPEC)
    runs = {}
    _build.reset_launches()
    for name, kw in (("defaults", {}), ("decode_chunk=8",
                                        dict(decode_chunk=8)),
                     ("batch_insert", dict(batch_insert=True))):
        eng = ServeEngine(cfg, params, **SERVE_ENGINE, device="cuda")
        q = AdmissionQueue(buckets=SERVE_ENGINE["buckets"])
        torch.cuda.synchronize()
        rep = run_load(eng, q, spec, **kw)
        del eng
        runs[name] = rep
        summary = {k: v for k, v in rep.items() if k != "responses"}
        say(f"loadgen {name} [{smi}] " + json.dumps(summary))
        say(f"loadgen {name} [{smi}]: {rep['completed']} completed, "
            f"{rep['shed']} shed; latency p50 {rep['latency_p50_s']:.4f} / "
            f"p99 {rep['latency_p99_s']:.4f} s, TTFT p50 "
            f"{rep['ttft_p50_s']:.4f} / p99 {rep['ttft_p99_s']:.4f} s "
            f"(virtual); {rep['throughput_tok_per_wall_s']:.1f} tokens per "
            f"wall second ({rep['tokens']} tokens in {rep['wall_s']:.2f} s, "
            f"{rep['decode_steps']} decode steps, {rep['decode_dispatches']} "
            f"dispatches, {rep['prefill_shots']} prefill shots)")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    _llm_expect("loadgen", launches, {})
    tokens = {k: {r.id: (r.tokens, r.shed) for r in v["responses"]}
              for k, v in runs.items()}
    for name, rep in runs.items():
        if tokens[name] != tokens["defaults"]:
            fail(f"loadgen: {name} served other tokens than the defaults")
        for k in ("completed", "shed", "tokens"):
            if rep[k] != runs["defaults"][k]:
                fail(f"loadgen: {name} {k} {rep[k]}, defaults "
                     f"{runs['defaults'][k]}")
    say(f"loadgen: every request's tokens equal across the three runs; "
        f"phase took {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------- phase "modality" --
# The VLM (phi-3-vision-4.2b: phi3-mini with 576 patch features prepended
# through its projector) and the encoder-decoder (whisper-small: 1,500
# frame embeddings through its encoder) at full width, bf16, seeded, the
# tied embedding scaled as `scale_embedding` does.  Each model: (a)/(b)
# `launch.serve.serve` (lockstep, the path both launchers take for these
# families) of MODALITY_B requests; (c) `launch.train`'s DS-FL ERA window
# of MODALITY_ERA_ROUNDS rounds and FedAvg window of 1 round at K = 2,
# batch 8, seq 128 (phi-3-vision's sequences 576 + 128 positions), bytes
# held to the values below (`CommModel`'s: FP16 3 x 1024 x V x 2, FedAvg
# 3 x params x 4); (d) K1-K4 at the teachers' (2, 1024, V) and the KD
# terms' (1024, V) bf16; (e) the smoke configs' rounds and lockstep serve
# on the card against the CPU.  whisper's prefill then decode is held in
# f32 at full width to its teacher-forced decoder (ROADMAP, deviation 16).
MODALITY = {
    "phi-3-vision-4.2b": dict(values=3_732_016_128, vocab=32_064, prompt=512,
                              new=32, fp16_bytes=197_001_216,
                              fedavg_bytes=44_784_193_536),
    "whisper-small": dict(values=263_318_784, vocab=51_865, prompt=64,
                          new=64, fp16_bytes=318_658_560,
                          fedavg_bytes=3_159_825_408)}
MODALITY_B = 4
MODALITY_ERA_ROUNDS = 2
MODALITY_F32_PROMPT, MODALITY_F32_STEPS = 64, 16
MODALITY_F32_RTOL = 1e-4            # of the teacher-forced logits' largest


def _modality_batch(cfg, B, S, seed, device="cuda"):
    """B prompts of S tokens and the model's stub inputs
    (`launch.train.extra_inputs`), drawn from one seeded generator."""
    from repro_torch.launch.train import extra_inputs
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=device)}
    batch.update(extra_inputs(cfg, B, g))
    return batch


def _clock_ms(fn, n=2) -> list:
    """Host milliseconds of ``fn()`` over a synchronized device, ``n``
    times (the first call apart from the warm ones)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        del r
    return out


def modality_serve(smi, arch):
    """(a)/(b): ``arch`` at full width through `launch.serve.serve`:
    MODALITY_B requests of its prompt (and 576 patches or 1,500 frames),
    its new tokens each.  The prefill (and whisper's encoder alone) is
    timed twice before; the launch counts are zeroed just before the serve
    and read after it (no kernel on this path).  Returns (the launches,
    cfg, params)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as lserve
    from repro_torch.models import encdec
    from repro_torch.models.api import model_prefill
    spec = MODALITY[arch]
    cfg, params = _serving_model(arch, spec["values"])
    scale_embedding(cfg, params)
    batch = _modality_batch(cfg, MODALITY_B, spec["prompt"], 21)
    extra = cfg.n_patches if cfg.arch_type == "vlm" else 0
    budget = spec["prompt"] + spec["new"] + extra
    rec = dict(device=smi, arch=arch, requests=MODALITY_B,
               prompt=spec["prompt"], new_tokens=spec["new"],
               seq_budget=budget)
    with torch.no_grad():
        if cfg.arch_type == "audio":
            rec["encode_ms"] = _clock_ms(
                lambda: encdec.encode(cfg, params, batch["frames"]))
        rec["prefill_ms"] = _clock_ms(
            lambda: model_prefill(cfg, params, batch, budget))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    toks, times = lserve.serve(cfg, params, batch, spec["new"], budget)
    torch.cuda.synchronize()
    rec["serve_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    step_ms = lserve.steady_ms_per_step(times)
    rec.update(decode_ms_per_step=step_ms,
               decode_tokens_per_s=MODALITY_B * 1e3 / step_ms,
               peak_bytes=torch.cuda.max_memory_allocated(),
               distinct_tokens=len(set(toks.flatten().tolist())),
               launches=launches)
    say(f"modality serve {arch} [{smi}] " + json.dumps(rec))
    if tuple(toks.shape) != (MODALITY_B, spec["new"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"modality serve {arch}: tokens {tuple(toks.shape)} out of "
             f"the vocabulary")
    _llm_expect(f"modality serve {arch}", launches, {})
    enc = (f"encode {rec['encode_ms'][1]:.1f} ms (first "
           f"{rec['encode_ms'][0]:.1f}), " if "encode_ms" in rec else "")
    say(f"modality serve {arch} [{smi}]: {MODALITY_B} requests of "
        f"{spec['prompt']} tokens" +
        (f" and {cfg.n_patches} patches" if extra else
         f" and {cfg.n_audio_frames} frames") +
        f": {enc}prefill {rec['prefill_ms'][1]:.1f} ms (first "
        f"{rec['prefill_ms'][0]:.1f}), decode {step_ms:.2f} ms a step "
        f"({rec['decode_tokens_per_s']:.1f} tokens/s), peak "
        f"{rec['peak_bytes']} B; no kernel launched")
    return launches, cfg, params


def whisper_f32_check(smi, params):
    """(b) deviation 16 on the card: whisper-small at full width in
    float32, a prefill of MODALITY_F32_PROMPT tokens then
    MODALITY_F32_STEPS teacher-forced decode steps, each step's logits
    within MODALITY_F32_RTOL of the largest teacher-forced logit; beside
    it, the first step decoded from empty rings (the reference's prefill)
    is printed, which the check must catch."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import model_decode_step, model_prefill
    cfg = get_config("whisper-small").replace(dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    S0, n = MODALITY_F32_PROMPT, MODALITY_F32_STEPS
    batch = _modality_batch(cfg, 2, S0 + n, 22)
    toks, frames = batch["tokens"], batch["frames"]
    with torch.no_grad():
        enc = encdec.encode(cfg, p32, frames)
        full = encdec.decoder_logits(cfg, p32, toks, enc)
        logits, cache = model_prefill(
            cfg, p32, {"tokens": toks[:, :S0], "frames": frames}, S0 + n)
        errs = [max_err(logits, full[:, S0 - 1])]
        for i in range(n):
            logits, cache = model_decode_step(cfg, p32, cache,
                                              toks[:, S0 + i], S0 + i)
            errs.append(max_err(logits, full[:, S0 + i]))
        empty = encdec.init_encdec_cache(cfg, p32, 2, S0 + n, enc)
        lg_empty, _ = encdec.encdec_decode_step(cfg, p32, empty, toks[:, S0],
                                                S0)
        err_empty = max_err(lg_empty, full[:, S0])
    top = float(full.abs().max())
    limit = MODALITY_F32_RTOL * top
    say(f"modality (b) whisper-small f32 [{smi}]: prefill of {S0} then {n} "
        f"decode steps against the teacher-forced decoder: max diff "
        f"{max(errs):.3e} (limit {limit:.3e}, {MODALITY_F32_RTOL} of the "
        f"largest logit {top:.4g}); decoding from empty rings instead (the "
        f"reference's audio prefill) is {err_empty:.4g} off")
    if max(errs) > limit:
        fail(f"modality (b): whisper prefill+decode {max(errs):.3e} from "
             f"the teacher-forced decoder, limit {limit:.3e}")
    if err_empty <= limit:
        fail("modality (b): decoding from empty rings passes the check")
    del p32, enc, full, cache, empty
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs), limit=limit, empty_rings_err=err_empty)


def modality_train(smi, arch):
    """(c) `launch.train`'s DS-FL ERA window (MODALITY_ERA_ROUNDS rounds;
    K1 a round, K3/K4 a client step, nothing else) and FedAvg window (1
    round, no kernel) of ``arch`` at full width, the embedding scaled;
    bytes a round held to `CommModel` and to MODALITY's values."""
    from unittest import mock

    from repro_torch.launch import train
    from repro_torch.models.api import model_init
    spec = MODALITY[arch]
    base = ["--arch", arch, "--clients", str(LLM_K), "--batch", str(LLM_B),
            "--seq", str(LLM_S)]
    per_window = {}
    window = functools.partial(fed_window, smi, f"modality {arch}", base,
                               spec["vocab"], spec["values"], per_window)

    def scaled_init(cfg, gen, device):
        params = model_init(cfg, gen, device)
        scale_embedding(cfg, params)
        return params

    n = MODALITY_ERA_ROUNDS
    with mock.patch.object(train, "model_init", scaled_init):
        fed = window("dsfl era", ["--mode", "dsfl"], [(n, "auto")],
                     dict(era_sharpen=n, distill_loss_fwd=n * LLM_K,
                          distill_loss_bwd=n * LLM_K))
        dsfl_bytes = fed.exchange_bytes
        del fed
        fed = window("fedavg", ["--mode", "fedavg"], [(1, "auto")], {})
        fedavg_bytes = fed.exchange_bytes
        for k, v in fed.state.clients.params.items():
            if not torch.equal(v[0], v[1]):
                fail(f"modality {arch} fedavg: clients differ at {k}")
        del fed
    torch.cuda.empty_cache()
    if (dsfl_bytes, fedavg_bytes) != (spec["fp16_bytes"],
                                      spec["fedavg_bytes"]):
        fail(f"modality {arch}: bytes a round {dsfl_bytes} / "
             f"{fedavg_bytes}, expected {spec['fp16_bytes']} / "
             f"{spec['fedavg_bytes']}")
    return per_window


def vocab_kernel_rows(smi, label, V, seed, era_names, **tags):
    """K1/K2 (``era_names`` of `era_timing`) at (2, 1024, V) bf16 and K3/K4
    at (1024, V) bf16: checked against their plain versions (K3 also
    against float64), timed as phase 4's rows (``tags`` and the card added
    to each); then `llm_kernel_checks` at V (K1 on the top-8 densified f32
    stack, K2 with a client at weight 0, K3/K4 on f32 logits).  Returns
    each kernel's row and each checked kernel's largest error."""
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import era_sharpen as es
    bf16 = torch.bfloat16
    era = era_timing(es, LLM_K, LLM_N, V, seed=seed, dtype=bf16,
                     names=era_names)
    fwd, bwd = k34_timing(dl, LLM_N, V, bf16, seed + 2, 2e-2,
                          dz_tol(LLM_N, bf16))
    rows = {}
    for name, r in list(era.items()) + [("distill_loss_fwd", fwd),
                                        ("distill_loss_bwd", bwd)]:
        rows[name] = dict(r, **tags, device=smi)
        say_timing(name, rows[name])
    errs = {name: r["max_abs_err"] for name, r in rows.items()}
    for name, e in llm_kernel_checks(V, with_k5=False, label=label).items():
        if e is not None:
            errs[name] = max(errs.get(name, 0.0), e)
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()
    return rows, errs


def modality_kernel_timing(smi):
    """(d) `vocab_kernel_rows` of K1, K2, K3 and K4 at both vocabularies.
    Returns each kernel's rows and largest error."""
    rows = {k: [] for k in ("era_sharpen", "weighted_era_sharpen",
                            "distill_loss_fwd", "distill_loss_bwd")}
    errs = dict.fromkeys(rows, 0.0)
    for i, (arch, spec) in enumerate(MODALITY.items()):
        r, e = vocab_kernel_rows(smi, f"modality {arch}", spec["vocab"],
                                 41 + i, ("era_sharpen",
                                          "weighted_era_sharpen"), arch=arch)
        for name in rows:
            rows[name].append(r[name])
            errs[name] = max(errs[name], e[name])
    return rows, errs


def modality_serve_card_vs_cpu(smi, arch):
    """(e) ``arch``'s smoke config (float32, the embedding scaled) through
    `launch.serve.serve` on the card and on the CPU: 3 prompts of 9 tokens
    with their stub inputs, 8 new tokens each; the tokens must be
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lserve
    from repro_torch.models.api import model_init
    cfg = get_config(arch).smoke()
    params = model_init(cfg, torch.Generator().manual_seed(1), "cpu")
    scale_embedding(cfg, params)
    batch = _modality_batch(cfg, 3, 9, 7, device="cpu")
    budget = 9 + 8 + (cfg.n_patches if cfg.arch_type == "vlm" else 0)
    out = {}
    for device in ("cuda", "cpu"):
        mv = lambda t: {k: v.to(device) for k, v in t.items()}
        out[device] = lserve.serve(cfg, mv(params), mv(batch), 8,
                                   budget)[0].cpu()
    if not torch.equal(out["cuda"], out["cpu"]):
        fail(f"modality (e) {arch}: lockstep serve gave {out['cuda']} on "
             f"the card, {out['cpu']} on the CPU")
    say(f"modality (e) [{smi}]: {arch} smoke config (d {cfg.d_model}, "
        f"{cfg.n_layers} layers), float32: lockstep serve tokens equal on "
        f"the card and the CPU ({len(set(out['cpu'].flatten().tolist()))} "
        f"distinct tokens)")


def phase_modality(smi):
    """Phase "modality": (a) phi-3-vision-4.2b and (b) whisper-small
    served at full width (whisper also in f32, `whisper_f32_check`), (c)
    each trained through `launch.train`'s windows, (d) K1-K4 at their
    training shapes, (e) the smoke configs on the card against the CPU.
    Returns the launches of each model's path by window, and (d)'s rows
    and errors."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    launches, secs = {}, {}
    for arch in MODALITY:
        t = time.perf_counter()
        serve_launches, cfg, params = modality_serve(smi, arch)
        if cfg.arch_type == "audio":
            whisper_f32_check(smi, params)
        del params
        torch.cuda.empty_cache()
        launches[arch] = dict(serve=serve_launches, **modality_train(smi,
                                                                     arch))
        secs[arch] = time.perf_counter() - t
    t = time.perf_counter()
    rows, errs = modality_kernel_timing(smi)
    secs["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    for arch in MODALITY:
        _build.reset_launches()
        llm_card_vs_cpu(smi, arch, label=f"modality (e) {arch}")
        torch.cuda.synchronize()
        _llm_expect(f"modality (e) {arch} rounds", dict(_build.LAUNCHES),
                    dict(era_sharpen=1, distill_loss_fwd=LLM_K,
                         distill_loss_bwd=LLM_K))
        modality_serve_card_vs_cpu(smi, arch)
    secs["card vs cpu"] = time.perf_counter() - t
    say(f"modality: phase took {time.perf_counter() - t0:.1f} s (" +
        ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return launches, rows, errs


# ----------------------------------------------------- phase "moe train" --
# LLM training of the MoE family on the card: llama4-scout-17b-a16e at its
# full widths through `launch.train`'s windows (K = 2, batch 8, seq 128),
# depth cut to MOE_TRAIN_LAYERS.  By the config a layer holds 2,076,272,640
# values (16 experts of 3 x 5120 x 8192, attention, router) and the tied
# embedding 1,034,485,760: at 2 layers a client is 10,374,451,200 bytes in
# bf16.  A DS-FL window holds two client stacks, the fresh stack the steps
# write, one client's gradients and the teacher rows, and FedAvg's mean its
# f32 partials besides: about 6 client copies (qwen1.5-4b's windows peaked
# at 40.3 and 42.8 GB for 7.1 GB clients), 62 GB at 2 layers and 87 GB at
# 3 (at 2 the windows peaked at 59.9 and 65.4 GB on an H100 80GB HBM3 at
# 700 W).  Its teacher rows of 202,048 classes take K1's wide-row route and
# K3/K4's widest rows.  Then K1, K3 and K4 at those rows checked and timed;
# the MoE smoke configs' rounds on the card against the CPU (Jamba's with
# K5 in its prediction leg, a full-width block of maverick being 34.8 GB
# and of Jamba 88 GB).
MOE_TRAIN_ARCH = "llama4-scout-17b-a16e"
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_VALUES = 5_187_036_160
MOE_V = 202_048
MOE_FP16_BYTES = 1_241_382_912       # 1024 x 202,048 x 2 B x 3
MOE_FEDAVG_BYTES = 62_244_433_920    # 5,187,036,160 x 4 B x 3
MOE_ERA_ROUNDS = 2
MOE_SMOKE = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
             "jamba-1.5-large-398b")


def moe_train_drops(fed):
    """Client 0's forward (no gradients) on its private batch and on the
    open batch, every MoE FFN's routed and dropped (token, choice) pairs
    counted (`drop_summary`; ``per_call``: each layer, private batch
    first)."""
    from repro_torch.core import llm_dsfl
    from repro_torch.models.api import model_logits
    params = llm_dsfl.client(fed.state.clients.params, 0)
    with torch.no_grad(), counted_drops() as calls:
        for batch in (llm_dsfl.client(fed.task.x_clients, 0),
                      fed.task.open_x):
            model_logits(fed.cfg, params, batch)
    return drop_summary(calls)


def moe_train_report(fed, rec):
    """What the scout DS-FL line adds: the dropped share (`moe_train_drops`),
    the useful FLOPs of one client step by `launch.roofline`
    (``model_flops``: 6 x active parameters x tokens, batch 8 x seq 128),
    the aten products one client step runs on the card counted by
    ``torch.utils.flop_counter`` (``counted_flops``: K3/K4 are ctypes calls
    and count nothing), their ratio, and the step's roofline from those
    FLOPs at the bf16 rate and the client's bytes read and written once."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import llm_dsfl
    from repro_torch.launch.roofline import Roofline, model_flops_estimate
    hp, st, task = fed.engine.algo.hp, fed.state.clients.params, fed.task
    drops = moe_train_drops(fed)
    (probs,) = llm_dsfl.dsfl_exchange(fed.cfg, st, task.open_x, hp)
    teacher = llm_dsfl._aggregate_teacher(probs, hp, None)
    del probs
    with FlopCounterMode(display=False) as fc:
        new, _ = llm_dsfl.dsfl_client_step(
            fed.cfg, llm_dsfl.client(st, 0),
            llm_dsfl.client(task.x_clients, 0), task.open_x, teacher, hp)
    del new, teacher
    torch.cuda.empty_cache()
    counted = float(fc.get_total_flops())
    model = model_flops_estimate(fed.cfg, InputShape("client step", LLM_S,
                                                     LLM_B, "train"))
    client_bytes = sum(v[0].numel() * v.element_size() for v in st.values())
    roof = Roofline.from_terms(
        arch=fed.cfg.name, shape=f"batch {LLM_B} x seq {LLM_S}",
        step="dsfl client step", flops=counted,
        bytes_accessed=2 * client_bytes, model_flops=model,
        peak_mem_bytes=rec["peak_bytes"], arg_bytes=client_bytes)
    return dict(dropped=drops, model_flops=model, counted_flops=counted,
                counted_over_model=counted / model, roofline=roof.to_dict())


def moe_train(smi):
    """llama4-scout at full width and MOE_TRAIN_LAYERS through
    `launch.train`'s DS-FL ERA window (MOE_ERA_ROUNDS rounds: K1 a round,
    K3/K4 a client step, nothing else; the line adds `moe_train_report`),
    a profiled client step, and its FedAvg window (1 round, no kernel);
    `train.get_config` cut to that depth and the seeded embedding scaled,
    bytes a round held to `CommModel` and to the literal values."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.api import model_init
    label = "moe train llama4-scout"
    base = ["--arch", MOE_TRAIN_ARCH, "--clients", str(LLM_K), "--batch",
            str(LLM_B), "--seq", str(LLM_S)]
    per_window = {}
    window = functools.partial(fed_window, smi, label, base, MOE_V,
                               MOE_TRAIN_VALUES, per_window)

    def scaled_init(cfg, gen, device):
        params = model_init(cfg, gen, device)
        scale_embedding(cfg, params)
        return params

    n = MOE_ERA_ROUNDS
    with mock.patch.object(train, "model_init", scaled_init), \
            mock.patch.object(train, "get_config", lambda arch: get_config(
                arch).replace(n_layers=MOE_TRAIN_LAYERS)):
        fed = window("dsfl era", ["--mode", "dsfl"], [(n, "auto")],
                     dict(era_sharpen=n, distill_loss_fwd=n * LLM_K,
                          distill_loss_bwd=n * LLM_K), extra=moe_train_report)
        dsfl_bytes = fed.exchange_bytes
        llm_step_trace(smi, fed, label, "2 predictions, the teacher through "
                       "K1 on the wide-row route")
        del fed
        torch.cuda.empty_cache()
        fed = window("fedavg", ["--mode", "fedavg"], [(1, "auto")], {})
        fedavg_bytes = fed.exchange_bytes
        for k, v in fed.state.clients.params.items():
            if not torch.equal(v[0], v[1]):
                fail(f"{label} fedavg: clients differ at {k}")
        del fed
    torch.cuda.empty_cache()
    if (dsfl_bytes, fedavg_bytes) != (MOE_FP16_BYTES, MOE_FEDAVG_BYTES):
        fail(f"{label}: bytes a round {dsfl_bytes} / {fedavg_bytes}, "
             f"expected {MOE_FP16_BYTES} / {MOE_FEDAVG_BYTES}")
    return per_window


def phase_moe_train(smi):
    """Phase "moe train": `moe_train`; K1, K3 and K4 at scout's
    (2, 1024, 202048) and (1024, 202048) bf16 rows (`vocab_kernel_rows`);
    each MoE smoke config's DS-FL and FedAvg rounds on the card against
    the CPU (`llm_card_vs_cpu`), launches held (K1 1, K3/K4 2, K5 one a
    Mamba sub-layer of each client's prediction).  Returns the launches of
    the windows and the smoke rounds, the timing rows and the errors."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    launches = moe_train(smi)
    t_k = time.perf_counter()
    rows, errs = vocab_kernel_rows(smi, "moe train", MOE_V, 51,
                                   ("era_sharpen",), arch=MOE_TRAIN_ARCH)
    t_c = time.perf_counter()
    smoke = {}
    for arch in MOE_SMOKE:
        cfg = get_config(arch).smoke()
        k5 = LLM_K * cfg.n_blocks * sum(m == "mamba" for m, _ in cfg.pattern)
        _build.reset_launches()
        llm_card_vs_cpu(smi, arch, label=f"moe train (c) {arch}")
        torch.cuda.synchronize()
        smoke[arch] = dict(_build.LAUNCHES)
        _llm_expect(f"moe train (c) {arch} rounds", smoke[arch],
                    dict(era_sharpen=1, distill_loss_fwd=LLM_K,
                         distill_loss_bwd=LLM_K, ssd_chunk=k5))
    say(f"moe train: phase took {time.perf_counter() - t0:.1f} s (windows "
        f"{t_k - t0:.1f} s, kernels {t_c - t_k:.1f} s, card vs cpu "
        f"{time.perf_counter() - t_c:.1f} s)")
    return launches, smoke, rows, errs


# ------------------------------------------------------------ phase "pod" --
# The federated client axis over torch.distributed ranks (`launch.mesh`,
# `launch.collectives`, the pod path of `core.llm_dsfl`) at qwen1.5-4b's
# full width, `launch.train`'s defaults (K = 2, batch 8, seq 128, lr 3e-3,
# ERA T = 0.1), the embedding scaled, through `launch.pod_check`'s cases
# chained in POD_CASES' order: 2 ERA rounds, a top-k 8 round, a
# participation-0.5 sparse round (client 1 absent, budget 1) and a FedAvg
# round, under the ``fp32-deterministic`` preset (default algorithms do not
# reproduce a card round).  (a) World 1 over NCCL in this process: the
# engine over `make_client_mesh(2)` = (1, 1, 1) against the engine without
# a mesh, case by case, every lane of every leaf fingerprinted on the card
# (`pod_check.fingerprint`: the int64 sum of its bit patterns and its
# float64 sum), history and launches equal; the log holds the all-gathered
# upload stack K1 sharpens.  (b) World 2 over gloo, one client a rank, both
# ranks on this card (NCCL refuses two ranks on one device; gloo moves the
# CUDA tensors through host memory): rank r's lane fingerprints equal the
# one-process lane r at (b)'s depth.  Two processes time-slice one card, so
# (b)'s seconds say nothing about scaling.
POD_CASES = ("era", "topk", "sparse", "fedavg")
POD_ROUNDS = {"era": 2, "topk": 1, "sparse": 1, "fedavg": 1}
POD_PRESET = "fp32-deterministic"
# (b) at 1 of the 40 layers: at full depth it fit (33.2 GB a rank) but
# took 50-63 s, FedAvg's 14.2 GB of f32 through gloo's host staging 20-26 s
# of it, and the script passed 900 s (955.1-975.0 s on an H100 80GB HBM3 at
# 700 W); at 20 layers (b) took 57.2 s on a slow host, where the script
# took 1114.9 s; at 4 layers 37.0 s, the script 1153.0 s on a slow host
# once phases "dryrun" and "tp decode" joined it; at 2 layers 35.2 s, the
# script 1105.4 s on a slow host.  Its one-process fingerprints are taken
# at the same depth
POD_LAYERS_B = 1


def _pod_spec(**kw):
    from repro_torch.launch.pod_check import DrillSpec
    return DrillSpec(**{**dict(
        arch="qwen1.5-4b", smoke=False, clients=LLM_K, batch=LLM_B,
        seq=LLM_S, lr=3e-3, device="cuda", use_kernel=True,
        scale_embedding=True, cases=POD_CASES, chain=True,
        fingerprint=True), **kw})


def _pod_line(rec, case) -> dict:
    from repro_torch.launch.roofline import collective_bytes, cross_pod_bytes
    return dict(seconds_a_round=rec["seconds"] / POD_ROUNDS[case],
                peak_bytes=rec["peak_bytes"],
                losses=[h["loss"] for h in rec["history"]],
                collective_bytes=collective_bytes(rec["log"]),
                cross_pod_bytes=cross_pod_bytes(rec["log"]),
                launches={k: v for k, v in rec["launches"].items()
                          if k != "ssd_chunk"})


def _pod_expected_bytes(case, n_params) -> dict:
    """The closed forms: DS-FL's upload stack K*B*S*V*2 (top-k's pairs
    K*B*S*k*8) and the K f32 losses a round; FedAvg 4 bytes a parameter."""
    losses = 4 * LLM_K * POD_ROUNDS[case]
    if case == "fedavg":
        return {"all-gather": losses, "all-reduce": 4 * n_params}
    per_round = (LLM_K * LLM_N * 8 * 8 if case == "topk"
                 else LLM_K * LLM_N * QWEN_V * 2)
    return {"all-gather": per_round * POD_ROUNDS[case] + losses}


def _pod_compare(label, one, got_lane, cases=POD_CASES):
    """Every case's lane fingerprints bitwise; ``got_lane(case, leaf, k)``
    gives the fingerprint held against one-process lane k."""
    for case in cases:
        for leaf, lanes in one[case]["params"].items():
            for k, want in enumerate(lanes):
                got = got_lane(case, leaf, k)
                if got != want:
                    fail(f"{label} {case}: client {k}'s {leaf} fingerprint "
                         f"{got} != one process {want}")


def phase_pod(smi):
    from repro_torch.launch import dist
    from repro_torch.launch import pod_check
    from repro_torch.launch.mesh import axis_sizes, make_client_mesh
    t_phase = time.perf_counter()
    spec = _pod_spec()
    cfg = spec.config()
    (ROOT / "build").mkdir(exist_ok=True)
    prev = platform.snapshot()
    platform.apply(POD_PRESET)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dist.init_rank(0, 1, "nccl", os.path.join(tmp, "store"))
            try:
                t0 = time.perf_counter()
                one = pod_check.run_cases(spec)
                t_one = time.perf_counter() - t0
                torch.cuda.empty_cache()
                mesh = make_client_mesh(LLM_K, device=spec.device)
                t0 = time.perf_counter()
                pod = pod_check.run_cases(spec, mesh)
                t_pod = time.perf_counter() - t0
            finally:
                dist.close()
    finally:
        platform.restore(prev)
    torch.cuda.empty_cache()
    n_params = _fake_param_count(cfg)
    say(f"pod (a) [{smi}]: {cfg.name} d {cfg.d_model}, {cfg.n_layers} "
        f"layers, {n_params} values a client; mesh "
        f"{axis_sizes(mesh)} over NCCL (world 1); one process {t_one:.1f} s, "
        f"over the mesh {t_pod:.1f} s (init and fingerprints included)")
    if n_params != QWEN_VALUES:
        fail(f"pod: {n_params} values a client, expected {QWEN_VALUES}")
    for case in POD_CASES:
        a, b = one[case], pod[case]
        if a["history"] != b["history"] or a["launches"] != b["launches"]:
            fail(f"pod (a) {case}: history {b['history']} / launches "
                 f"{b['launches']} over the mesh, {a['history']} / "
                 f"{a['launches']} without")
        line = _pod_line(b, case)
        want = _pod_expected_bytes(case, n_params)
        if line["collective_bytes"] != want:
            fail(f"pod (a) {case}: collective bytes "
                 f"{line['collective_bytes']} != closed form {want}")
        say(f"pod (a) {case} [{smi}]: " + json.dumps(dict(
            line, mesh_free_seconds_a_round=a["seconds"] / POD_ROUNDS[case],
            mesh_free_peak_bytes=a["peak_bytes"])))
    _pod_compare("pod (a)", one,
                 lambda case, leaf, k: pod[case]["params"][leaf][k])
    if pod["era"]["launches"]["era_sharpen"] != POD_ROUNDS["era"]:
        fail(f"pod (a): K1 launched {pod['era']['launches']['era_sharpen']} "
             f"times in 2 ERA rounds on the gathered stack")
    say(f"pod (a): every lane of every leaf bitwise the mesh-free engine "
        f"after each of {', '.join(POD_CASES)}")
    launches = {k: sum(pod[c]["launches"][k] for c in POD_CASES)
                for k in pod["era"]["launches"]}
    # (b): two ranks on this card, against one process at their depth
    spec_b = dataclasses.replace(spec, n_layers=POD_LAYERS_B)
    n_params_b = _fake_param_count(spec_b.config())
    t0 = time.perf_counter()
    prev = platform.snapshot()
    platform.apply(POD_PRESET)
    try:
        one = pod_check.run_cases(spec_b)
    finally:
        platform.restore(prev)
    torch.cuda.empty_cache()
    # its two ranks run in phase "tp"'s first spawn, before its runs
    pending = dict(one=one, n_params=n_params_b, n_layers=cfg.n_layers,
                   t_one=time.perf_counter() - t0,
                   program=(pod_check.rank_main, (dataclasses.replace(
                       spec_b, preset=POD_PRESET),)))
    say(f"pod: phase took {time.perf_counter() - t_phase:.1f} s, (b)'s "
        f"ranks not included")
    return launches, pending


def pod_b_report(smi, pending, ranks, t_ranks):
    """Phase "pod" (b): each rank's lane (``ranks``, rank 0's first, from
    phase "tp"'s first spawn) against the one-process run."""
    one, n_params_b = pending["one"], pending["n_params"]
    for r, rank in enumerate(ranks):
        for case in POD_CASES:
            if rank[case]["history"] != one[case]["history"]:
                fail(f"pod (b) rank {r} {case}: history "
                     f"{rank[case]['history']} != {one[case]['history']}")
            line = _pod_line(rank[case], case)
            want = _pod_expected_bytes(case, n_params_b)
            if line["cross_pod_bytes"] != want:
                fail(f"pod (b) rank {r} {case}: cross-pod bytes "
                     f"{line['cross_pod_bytes']} != closed form {want}")
            say(f"pod (b) rank {r} {case} [{smi}] (two ranks time-slice "
                f"one card: the seconds measure nothing about scaling): "
                + json.dumps(line))
    _pod_compare("pod (b)", one,
                 lambda case, leaf, k: ranks[k][case]["params"][leaf][0])
    say(f"pod (b): world 2 over gloo on one card, {POD_LAYERS_B} of "
        f"{pending['n_layers']} layers: rank r's lane bitwise the "
        f"one-process client r after each case; the one-process run took "
        f"{pending['t_one']:.1f} s, the ranks ran first in phase \"tp\"'s "
        f"first spawn ({t_ranks:.1f} s, spawn included)")


# ------------------------------------------------------------- phase "tp" --
# Tensor parallelism over "model" and FSDP over "data" (`launch.tp`) at
# full width, `launch.train`'s defaults (K = 2, batch 8, seq 128, ERA T =
# 0.1; lr TP_LR), the embedding scaled, over a world of 2 ranks over gloo,
# both on this card (as phase "pod" (b)), on the meshes (1, 1, 2)
# (`make_smoke_mesh(multi_pod=True)`: each client's leaves split over
# "model") and (1, 2, 1) (FSDP: each leaf's d_model dimension over
# "data", each data rank on 4 of the 8 sequences).  The dense family:
# phi3-medium-14b (d 5120, 40/10 heads, d_ff 17920, vocabulary 100,352);
# the Mamba2 mixer: mamba2-2.7b (d_inner 5120, 80 heads of 64, one group
# of B and C, vocabulary 50,280: 40 heads a rank, K5 at (8, 128, 40, 64,
# 1, 128) in each prediction); the MoE FFN: llama4-scout (16 experts of
# d_ff 8192, vocabulary 202,048: 8 experts a rank); Jamba's `.smoke()`
# (8 groups of one head, 4 a rank; K5 with 4 groups; batch 2, seq 32).
# TP_SPAWNS lists the
# spawns: each runs the one-process cases its held runs compare against
# (f32, ``fp32-deterministic``, each case from the init, at each depth
# its runs take; their leaves stay on the card, where the ranks read
# them), then its runs.  A run is
# "held" (every rank's slices and losses against the one-process run at
# tests/test_torch_dense_train.py's bounds: atol 1e-4 after the 2 ERA
# rounds, 1e-5 after 1 round, losses also at rtol 1e-6), "fault" (the
# same round with rank FAULT_RANK's slice of `pod_check.fault_leaf` 1%
# off before it: the check must fail) or "timed" (bf16: seconds a round
# and peak a rank; two ranks time-slice one card and gloo stages every
# collective through host memory, so the seconds say nothing of
# scaling).  Every leaf of a one-process case must move by more than the
# tolerance, so the held check can see a round that went wrong.  Held in
# every run: bytes a rank by axis equal to `tp.round_bytes`; K1 once a
# DS-FL round, K3/K4 once a client step, K5 once a Mamba layer a
# prediction.  A phi3 case's leaves at 4 layers in f32 are 15 GB and two
# ranks' ERA rounds peaked at 30.4 GB each (on an H100 80GB HBM3 at 700 W),
# so no spawn could hold two such cases.  phi3 runs at 1 layer, where a
# case's leaves are 6.8 GB and a rank's peak 15.2 GB (FSDP's FedAvg), so
# its three cases' leaves and two ranks fit one spawn (phase "pod" (b)'s
# ranks run first in it): a spawn costs 17-25 s, most of it processes
# starting, and the script ran past its 1200 s on a slow host with phi3
# at 4 layers in three spawns (at 2 layers in two, phase "tp" took 166.3
# s with "pod" (b) and "tp decode" folded in; H100 80GB HBM3, 700 W).
# FSDP moves
# each pass's gathered leaves through gloo (at one layer a DS-FL round
# took 33.2 s in bf16, a FedAvg round 19.9-27.5 s in f32, on an H100 80GB
# HBM3 at 700 W): its one run here is a held FedAvg round at one layer;
# tools/pod_cards.py (e) holds FSDP's DS-FL rounds at 4 layers over NCCL.
# A scout client at one layer is 4.15e9 values (16.6 GB in f32): its
# rounds here are bf16 and timed (the dry run puts a rank's DS-FL round at
# 21.4 GB), and its held check is one MoE FFN at full width (TP_MOE_FFN).
# The VLM: phi-3-vision-4.2b (d 3072, 32 heads of 96: 16 a rank, 576
# patches through the projector, whose columns are split and gathered,
# vocabulary 32,064 split) at 1 of its 32 layers, held and timed.  The
# encoder-decoder: whisper-small (d 768, 12 heads of 64: 6 a rank in the
# encoder, the decoder's self- and cross-attention, d_ff 3072, 1,500
# frames, vocabulary 51,865 whole on "model") at 2 + 2 layers held on (1,
# 1, 2) and with FSDP on (1, 2, 1) (one ERA round), and at 4 + 4 timed.
# Their depths are cut for the phase's time: gloo moved their all-reduces
# at about 0.55 GB/s, so phi-3-vision's (8 x (576 + 128)) rows took 7.7 s
# an f32 ERA round at 2 layers, whisper's (8 x 1,500) frames 6.8 s at 4 +
# 4 and 12.4 s in bf16 at 12 + 12 (H100 80GB HBM3, 700 W): at those
# depths their runs alone took 75.3 and 115.7 s.  tools/pod_cards.py (i)
# and (j) run phi-3-vision at 32 layers and whisper at 12 + 12 across
# cards.
TP_ARCH = "phi3-medium-14b"
TP_MAMBA = "mamba2-2.7b"
TP_SCOUT = "llama4-scout-17b-a16e"
TP_JAMBA = "jamba-1.5-large-398b"
TP_VLM = "phi-3-vision-4.2b"
TP_WHISPER = "whisper-small"
# 10 times `launch.train`'s 3e-3: every leaf must move past the bound, and
# at 3e-3 2 ERA rounds move phi3's ``wq`` by less than 1e-4 and a FedAvg
# round the norm scales by less than 1e-5 (tools/tp_movement.py).  The
# Mamba2 mixer's ``dt_bias`` and ``a_log`` move least (softplus' slope at
# dt of 1e-3..1e-1): mamba2-2.7b's 2 f32 ERA rounds at 4 layers move them
# 1.6e-5 at 3e-2, 5.2e-5 at 1e-1, 9.1e-5 at 2e-1, past 1e-4 at 3e-1 (the
# loss 22.64 -> 14.60; H100 80GB HBM3, 700 W).  Jamba's smoke config runs
# at batch 2, seq 32 (TP_BATCH): at 8 x 128 tokens (and at 4 x 64) the
# ranks and one process differ by rounding in the router's input, which
# flips near-tied top-k choices (the losses differ by 1e-4, ``cw_x`` by
# 2.2e-5 after a round at lr 1e-1); at 2 x 32 the worst leaf is 7.3e-6 at
# 1e-1 and its least moved 1.1e-4, so at 5e-2 3.6e-6 against 5.4e-5
# phi-3-vision at 3e-2: at 1e-2 2 f32 ERA rounds at 1 layer move its
# ``final_norm/scale`` 8.2e-5 (at 3e-2 past 1e-4); whisper at 3e-2: 2 ERA
# rounds at 2 + 2 move ``dec/n2/scale`` 1.29e-4 (at 4 + 4 8.2e-5, at 12 +
# 12 1.7e-5: deeper stacks need more, tools/pod_cards.py (j) 5e-1)
# (tools/tp_movement.py; H100 80GB HBM3, 700 W)
TP_LR = {TP_ARCH: 3e-2, TP_MAMBA: 3e-1, TP_SCOUT: 3e-2, TP_JAMBA: 5e-2,
         TP_VLM: 3e-2, TP_WHISPER: 3e-2}
TP_BATCH = {TP_JAMBA: (2, 32)}           # (batch, seq); else LLM_B, LLM_S
# the runs of each spawn: (arch, mesh, dtype, layers (None: the smoke
# config), cases, role)
TP_SPAWNS = (
    ((TP_ARCH, (1, 1, 2), "float32", 1, ("era", "topk", "fedavg"), "held"),
     (TP_ARCH, (1, 2, 1), "float32", 1, ("fedavg",), "held"),
     (TP_ARCH, (1, 1, 2), "float32", 1, ("fedavg",), "fault"),
     (TP_ARCH, (1, 1, 2), "bfloat16", 1, ("era", "topk", "fedavg"),
      "timed"),
     (TP_VLM, (1, 1, 2), "float32", 1, ("era", "topk", "fedavg"), "held"),
     (TP_VLM, (1, 1, 2), "float32", 1, ("fedavg",), "fault"),
     (TP_VLM, (1, 1, 2), "bfloat16", 1, ("era", "fedavg"), "timed")),
    ((TP_MAMBA, (1, 1, 2), "float32", 4, ("era", "topk", "fedavg"), "held"),
     (TP_MAMBA, (1, 1, 2), "float32", 4, ("fedavg",), "fault"),
     (TP_MAMBA, (1, 1, 2), "bfloat16", 4, ("era", "fedavg"), "timed"),
     (TP_JAMBA, (1, 1, 2), "float32", None, ("dsfl",), "held"),
     (TP_SCOUT, (1, 1, 2), "bfloat16", 1, ("era", "fedavg"), "timed"),
     (TP_WHISPER, (1, 1, 2), "float32", 2, ("era", "topk", "fedavg"),
      "held"),
     (TP_WHISPER, (1, 1, 2), "float32", 2, ("fedavg",), "fault"),
     (TP_WHISPER, (1, 2, 1), "float32", 2, ("dsfl", "fedavg"), "held"),
     (TP_WHISPER, (1, 1, 2), "bfloat16", 4, ("era", "fedavg"), "timed")),
)
TP_TOL = {1: 1e-5, 2: 1e-4}
TP_PRESET = "fp32-deterministic"
# K1 / K3 / K4 a rank a round of each kind: K = 2 lanes a rank
TP_LAUNCHES = {"dsfl": (1, 2, 2), "fedavg": (0, 0, 0)}
# one MoE FFN of scout at full width, f32, 1,024 tokens in groups of 256,
# forward and backward, on (1, 1, 2) (runs in TP_SPAWNS' scout spawn, each
# rank first making the one-process FFN itself from the seed): each rank's
# output, aux, gradients of its slices and of the tokens within
# TP_MOE_RTOL of each tensor's largest one-process magnitude, the dropped
# choices equal, and a 1% fault in rank 1's expert ``w_down`` slice caught
TP_MOE_FFN = dict(arch=TP_SCOUT, tokens=1024, group=256, device="cuda")
TP_MOE_RTOL = 1e-5


def _tp_spec(arch, mesh, dtype, layers, cases, role):
    from repro_torch.launch.pod_check import DrillSpec
    batch, seq = TP_BATCH.get(arch, (LLM_B, LLM_S))
    return DrillSpec(
        arch=arch, smoke=layers is None, clients=LLM_K, batch=batch,
        seq=seq, lr=TP_LR[arch], device="cuda", use_kernel=True,
        scale_embedding=layers is not None, fingerprint=True,
        mesh_shape=mesh, n_layers=layers, cases=cases,
        preset=None if role == "timed" else TP_PRESET,
        overrides=(("dtype", dtype),) if dtype != "bfloat16" else (),
        fault=role == "fault")


def _tp_one(runs, smi) -> dict:
    """The one-process runs of the held and fault runs' cases, one an
    (arch, depth): {(arch, layers): {case: its record, the leaves under
    "values"}}; fails unless each leaf moved by more than the case's
    tolerance."""
    from repro_torch.launch import pod_check
    by_depth = {}
    for run in runs:
        if run[5] != "timed":
            by_depth.setdefault(run[:1] + run[3:4], []).append(
                _tp_spec(*run))
    out = {}
    for key, held in by_depth.items():
        cases = tuple(dict.fromkeys(c for s in held for c in s.cases))
        ref = dataclasses.replace(held[0], mesh_shape=None, fault=False,
                                  cases=cases, keep_values=cases)
        if any(s.config() != ref.config() for s in held):
            fail("tp: the held runs of a depth must share one config")
        prev = platform.snapshot()
        platform.apply(TP_PRESET)
        try:
            one = out[key] = pod_check.run_cases(ref)
        finally:
            platform.restore(prev)
        torch.cuda.empty_cache()
        for case, rec in one.items():
            tol = TP_TOL[pod_check.CASES[case][1]]
            least = min(rec["moved"], key=rec["moved"].get)
            say(f"tp one process {key[0]} f32 {key[1] or 'smoke'} layers "
                f"{case} [{smi}]: " + json.dumps(dict(
                    seconds=rec["seconds"], tol=tol,
                    losses=[h["loss"] for h in rec["history"]],
                    launches={k: v for k, v in rec["launches"].items() if v},
                    least_moved_leaf=least, moved=rec["moved"])))
            if not rec["moved"][least] > tol:
                fail(f"tp one process {key[0]} {case}: {least} moved "
                     f"{rec['moved'][least]}, within the tolerance {tol}: "
                     f"the held check could not see it go wrong")
    return out


def _mamba_layers(cfg) -> int:
    return cfg.n_blocks * sum(m == "mamba" for m, _ in cfg.pattern)


def _tp_check(label, spec, role, rank_recs, one, smi) -> dict:
    """Bytes and launches of every case on every rank; a held run's
    slices and losses against the one-process run, a fault run's slices
    shown out of bounds; one line each.  Returns rank 0's launches summed
    over the cases."""
    from repro_torch.launch import pod_check, tp
    from repro_torch.launch.roofline import axis_bytes
    cfg = spec.config()
    fault_leaf = pod_check.fault_leaf(cfg)
    for case in spec.cases:
        kind, rounds, _, hp_kw, _, _ = pod_check.CASES[case]
        want = tp.merge((tp.round_bytes(
            cfg, spec.mesh_shape, clients=LLM_K, batch=spec.batch,
            seq=spec.seq, mode=kind, lanes_run=LLM_K,
            topk=hp_kw.get("topk")), rounds))
        tol = TP_TOL[rounds]
        worst = []
        for r, recs in enumerate(rank_recs):
            rec = recs[case]
            line = dict(seconds_a_round=rec["seconds"] / rounds,
                        peak_bytes=rec["peak_bytes"],
                        bytes_by_axis=axis_bytes(rec["log"]),
                        losses=[h["loss"] for h in rec["history"]],
                        launches=rec["launches"])
            if "max_abs" in rec:
                leaf = max(rec["max_abs"], key=rec["max_abs"].get)
                worst.append(rec["max_abs"][leaf])
                line.update(tol=tol, worst_leaf=leaf,
                            max_abs=rec["max_abs"][leaf],
                            fault_leaf=fault_leaf,
                            fault_leaf_max_abs=rec["max_abs"][fault_leaf],
                            one_process_losses=[
                                h["loss"] for h in one[case]["history"]])
            say(f"{label} rank {r} {case} [{smi}]: " + json.dumps(line))
            if line["bytes_by_axis"] != want:
                fail(f"{label} rank {r} {case}: bytes {line['bytes_by_axis']}"
                     f" != closed form {want}")
            got = tuple(rec["launches"][k] for k in (
                "era_sharpen", "distill_loss_fwd", "distill_loss_bwd",
                "ssd_chunk"))
            k5 = LLM_K * _mamba_layers(cfg) if kind == "dsfl" else 0
            if got != tuple(n * rounds for n in TP_LAUNCHES[kind] + (k5,)):
                fail(f"{label} rank {r} {case}: K1/K3/K4/K5 launched {got} "
                     f"in {rounds} rounds, {TP_LAUNCHES[kind] + (k5,)} a "
                     f"round expected")
            if role != "held":
                continue
            if line["max_abs"] > tol:
                fail(f"{label} rank {r} {case}: {line['worst_leaf']} "
                     f"{line['max_abs']} from the one-process run, past "
                     f"{tol}")
            ref_losses = line["one_process_losses"]
            if len(ref_losses) != len(line["losses"]) or any(
                    abs(a - b) > tol + 1e-6 * abs(b)
                    for a, b in zip(line["losses"], ref_losses)):
                fail(f"{label} rank {r} {case}: losses {line['losses']} "
                     f"against the one-process {ref_losses} (atol {tol}, "
                     f"rtol 1e-6)")
        if role == "fault" and not max(worst) > tol:
            fail(f"{label} {case}: rank {pod_check.FAULT_RANK}'s "
                 f"{fault_leaf} slice 1% off before the round leaves every "
                 f"rank within {tol} of the one-process run")
    return {k: sum(rank_recs[0][c]["launches"][k] for c in spec.cases)
            for k in rank_recs[0][spec.cases[0]]["launches"]}


def _tp_moe_ffn_check(spec, recs, smi) -> None:
    """Each rank's MoE FFN against the one process it ran first (held)
    and the fault run (caught), one line a rank and run."""
    from repro_torch.launch.roofline import axis_bytes
    cfg = spec.config()
    rows = spec.tokens
    e = torch.empty((), dtype=cfg.cdtype).element_size()
    want = {"model": {"all-reduce": 2 * rows * cfg.d_model * e
                      + rows * cfg.top_k * 4}}
    for role, i in (("held", 0), ("fault", 1)):
        rel = []
        for r, rec in enumerate(recs):
            got = rec[i]
            worst = max(got["max_abs"], key=lambda k: got["max_abs"][k]
                        / max(got["max_ref"][k], 1e-30))
            rel.append(got["max_abs"][worst] / got["max_ref"][worst])
            say(f"tp moe ffn {role} {TP_SCOUT} f32 rank {r} [{smi}]: "
                + json.dumps(dict(
                    tokens=spec.tokens, group=spec.group,
                    experts_a_rank=got["experts"], seconds=got["seconds"],
                    one_process_seconds=got["one_process_seconds"],
                    dropped=got["dropped"],
                    one_process_dropped=got["one_process_dropped"],
                    of_choices=rows * cfg.top_k,
                    bytes_by_axis=axis_bytes(got["log"]), worst=worst,
                    rel_err=rel[-1], rtol=TP_MOE_RTOL,
                    max_abs=got["max_abs"])))
            if got["dropped"] != got["one_process_dropped"]:
                fail(f"tp moe ffn rank {r}: {got['dropped']} choices "
                     f"dropped, one process {got['one_process_dropped']}")
            if axis_bytes(got["log"]) != want:
                fail(f"tp moe ffn rank {r}: bytes {axis_bytes(got['log'])}"
                     f" != {want}")
            if not got["ep"]:
                fail("tp moe ffn: the plan does not split the experts")
            if role == "held" and rel[-1] > TP_MOE_RTOL:
                fail(f"tp moe ffn rank {r}: {worst} {rel[-1]} of its "
                     f"largest magnitude from one process, past "
                     f"{TP_MOE_RTOL}")
        if role == "fault" and not max(rel) > TP_MOE_RTOL:
            fail("tp moe ffn: rank 1's expert w_down slice 1% off passed "
                 "the check")


def phase_tp(smi, first=None, last=None):
    """Phase "tp": the spawns of TP_SPAWNS.  ``first`` and ``last``, each
    a rank program (function, arguments), run on the same two ranks,
    ``first`` before the first spawn's runs and ``last`` after the last
    spawn's, which saves each its own spawn (a process's start takes most
    of a spawn's overhead).  Returns the bf16 runs' launches by arch, and
    for ``first`` and ``last`` each rank's result (rank 0's first) and the
    seconds of the spawn it ran in."""
    from repro_torch.launch import dist, pod_check
    from repro_torch.launch.mesh import smoke_mesh_shape
    t_phase = time.perf_counter()
    if smoke_mesh_shape(2, multi_pod=True) != (1, 1, 2):
        fail(f"tp: make_smoke_mesh(multi_pod=True) at world 2 is "
             f"{smoke_mesh_shape(2, multi_pod=True)}")
    launches, extra = {}, {}
    for n_spawn, runs in enumerate(TP_SPAWNS):
        t_spawn = time.perf_counter()
        t0 = time.perf_counter()
        ones = _tp_one(runs, smi)
        moe = (pod_check.MoEFFNSpec(**TP_MOE_FFN)
               if any(run[0] == TP_SCOUT for run in runs) else None)
        t_one = time.perf_counter() - t0
        specs = tuple(_tp_spec(*run) for run in runs)
        compares = tuple(None if run[5] == "timed" else
                         {c: ones[run[:1] + run[3:4]][c]["values"]
                          for c in run[4]} for run in runs)
        # the MoE FFN first: each rank makes its one-process reference
        # (16 GB of leaves and gradients) before its rounds start
        before = (first,) if n_spawn == 0 and first is not None else ()
        after = ((last,) if n_spawn == len(TP_SPAWNS) - 1
                 and last is not None else ())
        programs = before + (() if moe is None else tuple(
            (pod_check.moe_ffn_rank, (dataclasses.replace(moe, fault=f),))
            for f in (False, True)))
        i_main = len(programs)
        programs += ((pod_check.rank_main_many, (specs, compares)),) + after
        t0 = time.perf_counter()
        out = dist.spawn(dist.rank_programs, 2, programs, backend="gloo")
        t_ranks = time.perf_counter() - t0
        ranks = [rk[i_main] for rk in out]
        if before:
            extra["first"] = ([rk[0] for rk in out], t_ranks)
        if after:
            extra["last"] = ([rk[-1] for rk in out], t_ranks)
        # the leaves shared with the ranks go with every reference to them
        del programs, compares
        for one in ones.values():
            for rec in one.values():
                rec.pop("values")
        # the spawn's shared leaves are freed once the ranks let them go
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        archs = sorted({run[0] for run in runs})
        say(f"tp [{smi}]: {', '.join(archs)} at full width (Jamba smoke), "
            f"K = {LLM_K}, (batch, seq) "
            f"{[TP_BATCH.get(a, (LLM_B, LLM_S)) for a in archs]}, lr "
            f"{[TP_LR[a] for a in archs]}; one process {t_one:.1f} s; "
            f"world 2 over gloo on this card, {len(runs)} runs: "
            f"{t_ranks:.1f} s (spawn included); this process then holds "
            f"{torch.cuda.memory_allocated()} B, reserves "
            f"{torch.cuda.memory_reserved()} B")
        for i, (spec, run) in enumerate(zip(specs, runs)):
            arch, mesh, dtype, layers, _, role = run
            label = (f"tp {role} {arch} {mesh} {dtype} {layers or 'smoke'} "
                     f"layers" +
                     (" (two ranks time-slice one card: the seconds measure"
                      " nothing about scaling)" if role == "timed" else ""))
            got = _tp_check(label, spec, role, [rk[i] for rk in ranks],
                            ones.get(run[:1] + run[3:4], {}), smi)
            if role == "timed":
                launches[arch] = got
        if moe is not None:
            _tp_moe_ffn_check(moe, [rk[len(before):i_main] for rk in out],
                              smi)
        say(f"tp spawn {n_spawn} ({', '.join(archs)}) took "
            f"{time.perf_counter() - t_spawn:.1f} s; phase so far "
            f"{time.perf_counter() - t_phase:.1f} s")
    say(f"tp: every leaf moved past the tolerance, every held rank's "
        f"slices and losses within the bounds of the one-process run, the "
        f"1% faults caught (phi3 w_down, mamba2 w_out, scout's expert "
        f"w_down, phi-3-vision's patch_proj/w, whisper's dec/mlp/w_down), "
        f"bytes a rank by axis equal to the closed forms; phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return launches, extra.get("first"), extra.get("last")


# ------------------------------------------------------- phase "dryrun" --
# The single-card windows fake-traced (`launch.costs` over `launch.specs`'
# fake tensors on the card's device) and held to the same calls run for
# real: qwen1.5-4b at `launch.train`'s defaults (K = 2, batch 8, seq 128,
# its 40 layers, bf16) and mamba2-2.7b's prediction pass (64 layers, K5).
# Each fake record is traced at 2 and 3 blocks and extrapolated to the
# full depth (`launch.dryrun.extrapolate`, exact on the CPU tests; a full
# 40-layer trace of the ERA round takes about 90 s of host time).
DRYRUN_PEAK_RTOL = 0.10
# PERF.md §5's peaks of the trainer's windows (model init, both stacks and
# the engine's state included), for scale beside the one-call peaks here
PERF_PEAKS = {"local": 22_999_360_000, "dsfl era round": 40_305_361_920}
DRYRUN_RECORD = ("phi3-medium-14b", "decode_32k", "_chip_smoke")
OP_HOST_ITERS = 300


def _dryrun_steps(cfg) -> dict:
    """{window: its step} of ``cfg``'s family: the dense trainer's local
    step, DS-FL ERA round and client step, or the prediction pass."""
    from repro_torch.core.llm_dsfl import (LLMDsflHP, dsfl_client_step,
                                           dsfl_round_step,
                                           predict_open_probs, sgd_train_step)
    hp = LLMDsflHP(lr=3e-3, use_kernel=True)
    if cfg.arch_type != "dense":
        return {"mamba prediction": lambda p, o: predict_open_probs(
            cfg, p, o, use_kernel=True)}
    return {"local": lambda p, b: sgd_train_step(cfg, p, b, hp.lr),
            "dsfl era round": lambda s, pv, o: dsfl_round_step(
                cfg, s, pv, o, hp),
            "dsfl client step": lambda p, pv, o, t: dsfl_client_step(
                cfg, p, pv, o, t, hp)}


def _dryrun_inputs(cfg, name, device, fake_mode=None, seed=0) -> tuple:
    """Window ``name``'s arguments at ``cfg``'s depth: fake stand-ins
    under ``fake_mode``, else seeded tensors on ``device`` (the embedding
    scaled, tokens int32 as the stand-ins), made for this window alone."""
    from repro_torch.launch import specs
    from repro_torch.models.api import model_init
    era = name == "dsfl era round"
    if fake_mode is not None:
        kw = dict(device=device, mode=fake_mode)
        params = specs.params_struct(cfg, n_clients=LLM_K if era else 1,
                                     **kw)
        tokens = lambda lead=(): specs.batch_struct(cfg, LLM_B, LLM_S,
                                                    lead=lead, **kw)
        teacher = lambda: specs.teacher_struct(cfg, LLM_B, LLM_S, **kw)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model_init(cfg, gen, device)
        if cfg.arch_type == "dense":
            with torch.no_grad():
                scale_embedding(cfg, params)
        if era:
            params = {k: v[None].expand((LLM_K,) + tuple(v.shape))
                      .contiguous() for k, v in params.items()}
        tokens = lambda lead=(): {"tokens": torch.randint(
            0, cfg.vocab, lead + (LLM_B, LLM_S), generator=gen,
            device=device, dtype=torch.int32)}
        teacher = lambda: torch.softmax(torch.randn(
            (LLM_B, LLM_S, cfg.eff_vocab), generator=gen, device=device),
            -1).to(torch.bfloat16)
    if era:
        return params, tokens((LLM_K,)), tokens()
    if name == "dsfl client step":
        batch = tokens()
        return params, batch, batch, teacher()
    return params, tokens()


def _fake_records(cfg) -> dict:
    """{window: its `launch.costs` record at ``cfg``'s depth},
    extrapolated from fake traces at 2 and 3 blocks."""
    from repro_torch.launch import costs, dryrun, specs
    recs = {}
    na, nb = dryrun.EXTRAPOLATE_FROM
    for n in (na, nb):
        mode = specs.fake_mode()
        small = dryrun.reduced(cfg, n)
        for name, step in _dryrun_steps(small).items():
            args = _dryrun_inputs(small, name, "cuda", mode)
            with mode, costs.count(*args) as rec:
                step(*args)
            recs.setdefault(name, []).append(rec)
    return {k: dryrun.extrapolate(a, b, na, nb, cfg.n_blocks)
            for k, (a, b) in recs.items()}


def _window_model_flops(cfg, name) -> float:
    """6 N D of the window's gradient passes plus 2 N D of its forward
    passes (`launch.roofline.model_flops_estimate`)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.roofline import model_flops_estimate
    grad_seqs, fwd_seqs = {"local": (LLM_B, 0),
                           "dsfl client step": (2 * LLM_B, 0),
                           "dsfl era round": (2 * LLM_K * LLM_B, LLM_K * LLM_B),
                           "mamba prediction": (0, LLM_B)}[name]
    est = lambda kind, b: model_flops_estimate(
        cfg, InputShape(kind, LLM_S, b, kind)) if b else 0.0
    return est("train", grad_seqs) + est("prefill", fwd_seqs)


def dryrun_windows(smi, arch, fakes) -> dict:
    """Each window of ``arch`` run for real on the card under
    `launch.costs`, its arguments made just before it and freed after,
    held to its fake record: FLOPs, bytes, arguments and the live peak
    exactly, op calls exactly and equal to `_build.LAUNCHES`, and the
    trace's temporaries (its peak less its arguments) within
    DRYRUN_PEAK_RTOL of what ``max_memory_allocated`` rose by over the
    arguments; one line each with the record's `Roofline` beside the
    measured seconds.  Returns each window's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import costs
    from repro_torch.launch.roofline import Roofline
    cfg = get_config(arch)
    out = {}
    for name, step in _dryrun_steps(cfg).items():
        fake = fakes[name]
        torch.cuda.empty_cache()
        args = _dryrun_inputs(cfg, name, "cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        with costs.count(*args, sites=False) as real:
            res = step(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del res, args
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        temps, rise = fake.peak_bytes - fake.arg_bytes, peak - before
        rl = Roofline.build(arch=arch, shape=f"b{LLM_B}xs{LLM_S}",
                            mesh_name="1", step=name, costs=fake,
                            mesh_shape={"card": 1},
                            model_flops=_window_model_flops(cfg, name))
        line = dict(seconds=seconds, fake=fake.to_dict(),
                    real=real.to_dict(), launches=launches,
                    predicted_temporaries=temps, measured_rise=rise,
                    temporaries_gap=(temps - rise) / rise,
                    held_before=before, max_memory_allocated=peak,
                    roofline=rl.to_dict())
        if name in PERF_PEAKS:
            line["perf_md_window_peak"] = PERF_PEAKS[name]
        say(f"dryrun {arch} {name} [{smi}]: " + json.dumps(line))
        for key in ("flops", "bytes", "arg_bytes", "peak_bytes"):
            if getattr(fake, key) != getattr(real, key):
                fail(f"dryrun {arch} {name}: fake {key} {getattr(fake, key)}"
                     f" != real {getattr(real, key)}")
        if not (fake.ops == real.ops == launches):
            fail(f"dryrun {arch} {name}: op calls fake {fake.ops}, real "
                 f"{real.ops}, launched {launches}")
        if abs(temps - rise) > DRYRUN_PEAK_RTOL * rise:
            fail(f"dryrun {arch} {name}: predicted temporaries {temps} B, "
                 f"max_memory_allocated rose {rise} B over the arguments")
        out[name] = launches
    return out


def op_host_cost(smi) -> dict:
    """Host microseconds a call of each `kernels.library` op beyond its
    launch function, at a small shape (the launch itself timed alone; no
    synchronize between calls)."""
    from repro_torch.kernels import distill_loss as tdl
    from repro_torch.kernels import era_sharpen as tes
    from repro_torch.kernels import ssd_chunk as tssd
    dev = torch.device("cuda")
    p = _probs((2, 8, 16), 3).to(dev)
    w = torch.full((2,), 0.5, device=dev)
    z, t = _zt(8, 64, 4, torch.float32)
    z, t = z.to(dev), t.to(dev)
    rows = torch.ones((8,), device=dev)
    g = torch.full((1,), 0.125, device=dev)
    x = _ssd_inputs(2, 16, 4, 8, 1, 8, 5)
    pairs = {
        "era_sharpen": (lambda: torch.ops.repro_torch.era_sharpen(p, 0.1),
                        lambda: tes.launch_era_sharpen(p, 0.1)),
        "weighted_era_sharpen": (
            lambda: torch.ops.repro_torch.weighted_era_sharpen(p, w, 0.1,
                                                               True),
            lambda: tes.launch_weighted_era_sharpen(p, w, 0.1, True)),
        "distill_loss_fwd": (
            lambda: torch.ops.repro_torch.distill_loss_fwd(z, t),
            lambda: tdl.launch_distill_loss_fwd(z, t)),
        "distill_loss_bwd": (
            lambda: torch.ops.repro_torch.distill_loss_bwd(z, t, rows, rows,
                                                           g),
            lambda: tdl.launch_distill_loss_bwd(z, t, rows, rows, g)),
        "ssd_chunk": (lambda: torch.ops.repro_torch.ssd_chunk(*x),
                      lambda: tssd.launch_ssd_chunk(*x))}

    def host_us(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_HOST_ITERS):
            fn()
        us = (time.perf_counter() - t0) / OP_HOST_ITERS * 1e6
        torch.cuda.synchronize()
        return us
    out = {}
    for name, (op, launch) in pairs.items():
        a, b, a2, b2 = host_us(op), host_us(launch), host_us(op), \
            host_us(launch)
        out[name] = dict(op_us=min(a, a2), launch_us=min(b, b2),
                         op_extra_us=min(a, a2) - min(b, b2))
    say(f"op host cost [{smi}]: " + json.dumps(out))
    return out


def phase_dryrun(smi):
    """Phase "dryrun": the single-card windows' fake records against their
    real runs (`dryrun_windows`), the ops' host cost, and one
    production-mesh record of the dry run (phi3-medium-14b x decode_32k x
    16 x 16) in a child process on a fake world of 256."""
    t_phase = time.perf_counter()
    # the production-mesh record traces on the host (fake tensors), so it
    # runs beside the windows
    arch_r, shape_r, tag = DRYRUN_RECORD
    from repro_torch.launch import dryrun
    path = ROOT / dryrun.RESULTS_DIR / f"{arch_r}_{shape_r}_16x16{tag}.json"
    path.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [q for q in [os.environ.get("PYTHONPATH")]
                               if q]))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_r,
         "--shape", shape_r, "--mesh", "single", "--tag", tag], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    launches = {}
    try:
        from repro_torch.configs import get_config
        for arch in ("qwen1.5-4b", "mamba2-2.7b"):
            t0 = time.perf_counter()
            fakes = _fake_records(get_config(arch))
            say(f"dryrun {arch}: fake traces at 2 and 3 blocks took "
                f"{time.perf_counter() - t0:.1f} s")
            launches.update(dryrun_windows(smi, arch, fakes))
            torch.cuda.empty_cache()
        say(f"dryrun: qwen1.5-4b's trainer windows peaked at "
            f"{PERF_PEAKS['local']} B (local) and "
            f"{PERF_PEAKS['dsfl era round']} B (ERA) in PERF.md §5: those "
            f"windows hold the model's init, both client stacks and the "
            f"engine's state besides one call's arguments and temporaries, "
            f"which is all a step's peak here counts")
        host = op_host_cost(smi)
        try:
            out, err = child.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            fail(f"dryrun record {arch_r} x {shape_r}: no exit within 300 s")
    finally:
        if child.poll() is None:      # a failed check: stop the child too
            child.kill()
            child.wait()
    rec = json.loads(path.read_text()) if path.exists() else {}
    say(f"dryrun record {arch_r} x {shape_r} x 16x16 [{smi}]: rc "
        f"{child.returncode} by {time.perf_counter() - t_phase:.1f} s; " +
        json.dumps({k: v for k, v in rec.items() if k != "trace"}))
    if child.returncode != 0 or rec.get("status") != "ok":
        fail(f"dryrun record {arch_r} x {shape_r}: {rec.get('status')} "
             f"{rec.get('error')} {out[-1000:]} {err[-2000:]}")
    say(f"dryrun: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, host


# --------------------------------------------------- phase "tp decode" --
# phi3-medium-14b, mamba2-2.7b and whisper-small at full width, 4 layers
# in f32 (whisper: 4 + 4), the embedding scaled: a start token and 16
# greedy tokens from an empty cache (whisper's holding the cross keys and
# values of 1,500 seeded frames), world 2 over gloo on this card, held to
# one process (`launch.decode_check`): phi3 on (1, 1, 2) at batch 8
# splits the heads (40 / 2 and 10 / 2), on (1, 2, 1) without FSDP at
# batch 1 the ring's window over "data"; mamba2 on (1, 1, 2) at batch 8
# the mixer's heads (its state's 80 / 2, its conv windows' channels and
# B/C columns); whisper on (1, 1, 2) at batch 8 the heads of its rings
# and its cross cache (12 / 2), on (1, 2, 1) without FSDP at batch 1 its
# rings' window and the cross cache's 1,500 encoder positions over
# "data" (each step merging the ranks' partial softmaxes); a 1% fault in
# rank 1's ``wo`` slice, in its value ring, in its SSM state and in its
# cross values must be caught.  (arch, mesh, fsdp, batch, fault)
TP_DECODE = ((TP_ARCH, (1, 1, 2), True, 8, "wo"),
             (TP_ARCH, (1, 2, 1), False, 1, "ring"),
             (TP_MAMBA, (1, 1, 2), True, 8, "state"),
             (TP_WHISPER, (1, 1, 2), True, 8, "cross_v"),
             (TP_WHISPER, (1, 2, 1), False, 1, "cross_v"))
TP_DECODE_RTOL = 1e-5


def tp_decode_prepare():
    """Phase "tp decode"'s one-process greedy runs, and its rank program,
    which runs in phase "tp"'s last spawn: (cases, their one-process
    records, the program)."""
    import dataclasses as dc_
    from repro_torch.launch import decode_check as dc
    base = dc.DecodeSpec(arch=TP_ARCH, smoke=False, n_layers=4,
                         overrides=(("dtype", "float32"),), steps=16,
                         scale_embedding=True)
    cases = [dc_.replace(base, arch=a, mesh_shape=m, fsdp=f, batch=b)
             for a, m, f, b, _ in TP_DECODE]
    ones = []
    for spec in cases:
        params = dc.init_params(spec, "cuda")
        ones.append(dc.greedy(spec, params, "cuda"))
        del params
        torch.cuda.empty_cache()
    # each case beside its fault run: the ranks make each model once
    runs = tuple(r for c, (*_, f) in zip(cases, TP_DECODE)
                 for r in (c, dc_.replace(c, fault=f)))
    return cases, ones, (dc.rank_main, (runs, "cuda"))


def tp_decode_report(smi, cases, ones, ranks, t_ranks):
    """Phase "tp decode": each rank's records of `tp_decode_prepare`'s
    program (``ranks``, rank 0's first) against the one-process runs."""
    from repro_torch.launch import decode_check as dc
    from repro_torch.launch import tp
    t_phase = time.perf_counter()
    for i, spec in enumerate(cases):
        want = tp.decode_bytes(spec.config(), spec.mesh_shape,
                               batch=spec.batch, window=spec.seq_len,
                               fsdp=spec.fsdp)
        one = ones[i]
        for r in range(2):
            rec, bad = ranks[r][2 * i], ranks[r][2 * i + 1]
            held = dc.compare(rec, one, TP_DECODE_RTOL)
            faulted = dc.compare(bad, one, TP_DECODE_RTOL)
            median = lambda ms: sorted(ms)[len(ms) // 2]
            line = dict(arch=spec.arch, mesh=spec.mesh_shape, fsdp=spec.fsdp,
                        batch=spec.batch, held=held, fault=faulted,
                        step_bytes=rec["step_bytes"], closed_form=want,
                        ms_a_step_median=median(rec["ms_a_step"]),
                        ms_a_step_range=[min(rec["ms_a_step"]),
                                         max(rec["ms_a_step"])],
                        one_process_ms_a_step_median=median(
                            one["ms_a_step"]),
                        peak_bytes=rec["peak_bytes"])
            line["launches"] = {k: v for k, v in rec["launches"].items()
                                if v}
            say(f"tp decode rank {r} [{smi}]: " + json.dumps(line))
            if not held["ok"]:
                fail(f"tp decode {spec.mesh_shape} rank {r}: {held}")
            if rec["step_bytes"] != want:
                fail(f"tp decode {spec.mesh_shape} rank {r}: bytes "
                     f"{rec['step_bytes']} != closed form {want}")
        if all(dc.compare(ranks[r][2 * i + 1], one,
                          TP_DECODE_RTOL)["ok"] for r in range(2)):
            fail(f"tp decode {spec.arch} {spec.mesh_shape}: rank 1's 1% "
                 f"{TP_DECODE[i][4]} fault passed the check")
    say(f"tp decode: {TP_ARCH}, {TP_MAMBA} and {TP_WHISPER} at full "
        f"width, 4 layers f32 (whisper 4 + 4), 16 greedy "
        f"tokens; world 2 over gloo on this card, after phase \"tp\"'s "
        f"runs in its last spawn ({t_ranks:.1f} s, spawn included); tokens "
        f"and logits of every rank within {TP_DECODE_RTOL} of the largest logit of one process, bytes equal "
        f"to tp.decode_bytes, the faults caught; checks took "
        f"{time.perf_counter() - t_phase:.1f} s")
    # rank 0's launches of each held case, counted from zero just before
    # its decode (`decode_check.run_rank`)
    return {f"{spec.arch} {spec.mesh_shape}": ranks[0][2 * i]["launches"]
            for i, spec in enumerate(cases)}


def _fake_param_count(cfg) -> int:
    """One client's parameter count, the model made under fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import model_init
    with FakeTensorMode():
        return sum(v.numel() for v in
                   model_init(cfg, torch.Generator(), "cpu").values())


# ------------------------------------------------------ phase "examples" --
# The examples' torch twins on the card, each its own process (the kernels
# built above are reused from the build directory): (script, arguments,
# the text its output must hold).
EXAMPLES = (("torch_quickstart.py", ("--fast",), "\nOK\n"),
            ("torch_serve_batched.py", (), "[continuous] 4 requests"),
            ("torch_train_dsfl_lm.py", ("--smoke", "--steps", "2"),
             "round   1  loss"))


def start_examples():
    """Each of EXAMPLES on the card, each its own process, started at once
    and left to run beside phase "tp" (their models are small; most of
    their time is the interpreter's and torch's start).  Returns the
    processes and the clock they started at; `finish_examples` reads them,
    and they are killed if the script ends first."""
    import atexit
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    procs = []
    for script, args, want in EXAMPLES:
        # files, not pipes: nothing reads them until phase "examples"
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((script, args, want, (out, err), subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script), *args],
            cwd=ROOT, env=env, stdout=out, stderr=err, text=True)))
    atexit.register(lambda: [p.kill() for *_, p in procs
                             if p.poll() is None])
    return procs, t0


def finish_examples(smi, started):
    """Phase "examples": fails on a non-zero exit code or a missing
    expected line (the quickstart's final ``OK``)."""
    procs, t_phase = started
    for script, args, want, files, proc in procs:
        try:
            proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            for *_, p in procs:
                p.kill()
            fail(f"examples {script}: no exit within 300 s")
        for f in files:
            f.seek(0)
        out, err = (f.read() for f in files)
        tail = out.strip().splitlines()[-4:]
        say(f"examples {script} {' '.join(args)} [{smi}]: rc "
            f"{proc.returncode} by {time.perf_counter() - t_phase:.1f} s "
            f"from its start; " + " | ".join(tail))
        if proc.returncode != 0 or want not in out + "\n":
            for *_, p in procs:
                p.kill()
            fail(f"examples {script}: rc {proc.returncode}, expected "
                 f"{want!r}; stderr: {err[-2000:]}")
    say(f"examples: all three exited by "
        f"{time.perf_counter() - t_phase:.1f} s from their start")


PHASE_SECONDS = {}


@contextlib.contextmanager
def clocked(name):
    """Adds the seconds of the block to ``PHASE_SECONDS[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script needs one NVIDIA GPU")
    t_start = time.perf_counter()
    smi = phase_device()
    with clocked("build"):
        phase_build()
    with clocked("kernels and timing"):
        recs, _ = phase_kernels_and_timing()
    with clocked("k5"):
        recs["ssd_chunk"] = phase_k5()
    with clocked("slice, legs"):
        eng, state, task, launches, side = phase_slice(smi)
        phase_legs(eng, state, task)
        del eng, state, task
    with clocked("card vs cpu"):
        phase_card_vs_cpu(smi)
        torch.cuda.empty_cache()
    with clocked("paper models"):
        paper_launches = phase_paper_models(smi)
        torch.cuda.empty_cache()
    with clocked("sim"):
        t_sim = time.perf_counter()
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            sim_launches = phase_sim(smi, Path(tmp))
        say(f"sim: phase took {time.perf_counter() - t_sim:.1f} s")
        torch.cuda.empty_cache()
    with clocked("serve"):
        cfg, params = _serving_model("mamba2-2.7b", 2_702_579_200)
        serve_launches, prompts, _ = phase_serve(smi, cfg, params,
                                                 recs["ssd_chunk"]["ms"])
    with clocked("trace"):
        phase_trace(smi, cfg, params, prompts)
    with clocked("routes"):
        wide = {k: v.float() for k, v in params.items()}
        del params
        torch.cuda.empty_cache()
        phase_routes(smi, cfg, wide, prompts)
        del wide
        torch.cuda.empty_cache()
    with clocked("lm card vs cpu"):
        phase_lm_card_vs_cpu(smi)
        torch.cuda.empty_cache()
    with clocked("serve qwen1.5-4b"):
        qwen_launches = phase_serve_qwen(smi)
    with clocked("llm"):
        llm_launches, llm_runs, llm_errs = phase_llm(smi)
        torch.cuda.empty_cache()
    with clocked("llm qwen1.5-4b"):
        _, qwen_runs, qwen_errs = phase_llm_qwen(smi)
        torch.cuda.empty_cache()
    with clocked("moe"):
        moe_launches = phase_moe(smi)
    with clocked("hot swap"):
        swap_launches, qcfg, qparams = phase_hot_swap(smi)
    with clocked("loadgen"):
        loadgen_launches = phase_loadgen(smi, qcfg, qparams)
        del qparams, qcfg
        torch.cuda.empty_cache()
    with clocked("modality"):
        modality_launches, modality_rows, modality_errs = phase_modality(smi)
        torch.cuda.empty_cache()
    with clocked("moe train"):
        moe_windows, moe_smoke, moe_rows, moe_errs = phase_moe_train(smi)
        torch.cuda.empty_cache()
    with clocked("pod"):
        pod_launches, pod_b = phase_pod(smi)
        torch.cuda.empty_cache()
    with clocked("tp decode"):
        decode_cases, decode_ones, decode_program = tp_decode_prepare()
    # the examples run beside phase "tp" (their own processes; small
    # models): phase "examples" reads them after phase "dryrun"
    examples = start_examples()
    with clocked("tp"):
        tp_launches, pod_ranks, decode_ranks = phase_tp(
            smi, first=pod_b["program"], last=decode_program)
        del pod_b["program"], decode_program
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    with clocked("pod"):
        pod_b_report(smi, pod_b, *pod_ranks)
    with clocked("tp decode"):
        tp_decode_launches = tp_decode_report(smi, decode_cases, decode_ones,
                                              *decode_ranks)
    with clocked("dryrun"):
        dryrun_launches, op_host = phase_dryrun(smi)
        torch.cuda.empty_cache()
    with clocked("examples"):
        finish_examples(smi, examples)
    kernels = []
    for name, r in recs.items():
        serving, llm = name in SERVE_KERNELS, name in LLM_KERNELS
        kernels.append(dict(
            name=name, route="cuda",
            launches=(serve_launches if serving else llm_launches if llm
                      else launches)[name],
            path=("serve mamba2-2.7b" if serving else "llm training" if llm
                  else "federated rounds"),
            on_main_path=serving or llm or name in ON_MAIN_PATH,
            serve_qwen_launches=qwen_launches[name],
            side_check_launches=side[name],
            sim_launches={run: v[name] for run, v in sim_launches.items()},
            llm_launches={run: v[name] for run, v in llm_runs.items()},
            llm_qwen_launches={run: v[name] for run, v in qwen_runs.items()},
            paper_models_launches={m: v[name]
                                   for m, v in paper_launches.items()},
            moe_serve_launches={k: v[name] for k, v in moe_launches.items()
                                if k != "jamba smoke"},
            jamba_smoke_launches=moe_launches["jamba smoke"][name],
            hot_swap_launches=swap_launches[name],
            loadgen_launches=loadgen_launches[name],
            modality_launches={
                arch: {run: v[name] for run, v in windows.items()}
                for arch, windows in modality_launches.items()},
            modality=modality_rows.get(name, []),
            modality_max_abs_err=modality_errs.get(name),
            moe_train_launches={run: v[name]
                                for run, v in moe_windows.items()},
            moe_smoke_launches={a: v[name] for a, v in moe_smoke.items()},
            moe_train=[moe_rows[name]] if name in moe_rows else [],
            moe_train_max_abs_err=moe_errs.get(name),
            pod_launches=pod_launches[name],
            tp_launches={a: v[name] for a, v in tp_launches.items()},
            dryrun_launches={w: v.get(name, 0)
                             for w, v in dryrun_launches.items()},
            tp_decode_launches={m: v[name]
                                for m, v in tp_decode_launches.items()},
            op_host_us=op_host[name],
            llm_max_abs_err=llm_errs[name],
            llm_qwen_max_abs_err=qwen_errs[name], check="pass", **r))
    say("phase seconds " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
