#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (mtamrecommender_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. card and build: the nvidia-smi name and power limit, then every
     kernel built from csrc/ (one nvcc per source, all at once), and the
     registers and spill bytes ptxas gives gru_scan_kernel's
     instantiations (those at u=128 printed), the two kernels of
     fused_readout's "gemm" design, the four of fused_readout_bwd's,
     scatter_add's columns_sum, the attention forward's tile, hop and
     blocked designs and the chain readout pair's staged and blocked
     designs;
  2. kernels against their plain PyTorch twins on the card, at the
     shapes the serving path gives them (B = 1, 16, 256, L=50,
     u=d=128; attention Tk=50 and Tk=1024), in f32 and bf16, with, at
     B=256, the kernel's time, the twin's time, the least time the card
     could take (bound) and, where one PyTorch call computes the same
     function, that call's time; fused_attention at Tq = 1 (MTAM's
     serving hops) in all five modes (a rate-0.5 mask in the drop
     modes) at Tk = 1, 17, 50, 64 and d = 16, 128 in its "hop" design (a
     block a batch row, the rows by bulk copies into shared memory):
     two launches the same bits, within KERNEL_TOL of the twin and
     within 1e-5 / 2e-3 (f32 / bf16) of the largest |out| from the
     "query" design forced (a block a query row), at Tk=50, d=128 both
     timed in turns (hop, query, query, hop: event ms, the profiler's
     device ms, the host ms a call) with the hop design's shared memory
     a block and blocks an SM; past 64 keys its "blocked" design (a block
     a batch row, the rows in 64-key blocks through a ring of
     shared-memory slots by bulk copies, the f32 scores in a strip) at
     Tk = 65, 150, 255, 256, 257, 1024 x d = 16, 128 x B = 1, 16, 64
     (B = 1, 16, 256 at Tk = 1024), ragged key lengths with a row of
     length 0, held the same way, timed in turns with the query design
     at Tk=150, B=64 and Tk=1024, B=256 (d=128) in the plain, time and
     tisas modes beside the twin, the bound and, in plain and tisas,
     scaled_dot_product_attention; gru_scan in each mode in its default
     "sliced" design, the same bits twice, with the earlier "unit_column"
     design forced and held beside it and timed on the same inputs in
     turns (default, unit_column, unit_column, default);
  2b. the training step's kernels the same way: gru_scan_bwd in each
     mode at B = 1, 16, 256 (ragged lengths, a row of length 0), the
     same bits twice, with the earlier four-product design forced and held
     beside it and timed on the same inputs in turns (default, four,
     four, default), and the profiler's split of the default design's
     device time among its kernels; dtable at the step's four table shapes
     with the ids of a gathered training batch, the same bits twice
     (torch.zeros + index_add_ timed beside it: each one's event-timed
     ms, its device time per call from the profiler, the flush left out,
     and its host time per call, which tell the host's launch cost from
     device work; in f32, row 0 of each table, the padding id's, against
     an f64 index_add_ of the same cotangents, for the kernel and for
     the CPU's f32 index_add_, also with every padded position's
     cotangent one vector, as the step's L2 term gives them);
  2c. the self-attention training kernels the same way: the forward's
     plain_drop and tisas_drop modes (a rate-0.5 mask) and
     fused_attention_bwd in all five modes, at B = 1, 16, 256 with
     Tq = Tk = 50 and with Tq = 1, Tk = 1024, and the forward's plain,
     time and tisas modes at Tq = Tk = 50; two backward launches on the
     same inputs must give the same bits; at Tq = Tk = 50 the forward
     takes its "tile" design (a block a batch row; at Tq = 1, Tk = 1024
     the drop modes' "blocked" design, held and timed the same way): two
     launches the same bits, and within 1e-5 / 2e-3 (f32 / bf16) of the
     largest |out| from the twin and from its "query" design forced (a
     block a query row), both timed in turns at B = 256 (tile, query, query,
     tile: event ms, the profiler's device ms) with the tile design's
     host time a call; the backward
     takes its "tile" design (a block a batch row), held also against
     its "rows" design forced (the same bits twice) and, in time mode at
     B = 256, with its gate sums in chunks of 128 rows (the same bits);
     at Tq = 1 its rows design; timed at B = 256, Tq = Tk = 50, the
     backward's two designs in turns (tile, rows, rows, tile) with the
     profiler's split of each by launch and the tile design's host time
     a call (scaled_dot_product_attention forward + backward beside the
     plain and tisas backward); then both kernels' "wide" designs (past
     64 keys: a block 16 query rows of a batch row over an f32 score
     strip; the backward a query pass, a key pass and in time mode the
     gate sums) in all five modes and both dtypes at B = 1, 16, 64 x Tq =
     Tk = 65, 256, 1024 (d=128; and B=16 at d=16), ragged key lengths
     with a row of length 0 and a full row, a rate-0.5 mask in the drop
     modes: each within 1e-5 / 2e-3 (f32 / bf16) of its design twin's
     largest |out| and within KERNEL_TOL of its plain twin, the same bits
     twice; timed at B=64, Tq = Tk = 256 in turns with the query and rows
     designs forced (wide, old, old, wide: event ms, the profiler's device
     ms, the host ms a call, the backward's split by launch) and at Tq =
     Tk = 1024 each once by events, beside the plain twins, the bound and
     scaled_dot_product_attention (forward; forward + backward) in the
     plain and tisas modes;
  2d. the long-history kernels the same way: fused_readout and
     fused_readout_bwd at B = 1, 16, 64 x L = 256, 512, 1024 in f32 and
     bf16 (scalar and positional gate rows, ragged key lengths, one row
     with no live key, one masked query) and at the slice's B=64, L=512
     with every key live; each in its default "gemm" design and with the
     earlier "rows" design forced, each the same bits twice, timed on the
     slice's shape in turns (gemm, rows, rows, gemm) with the profiler's
     split of the gemm design's launches (the forward's two, the
     backward's five); the forward also timed so at B = 1 and 16 (L=512,
     every key live) and held at d = 32 and 64 (B=16, L=256), on inputs
     of a generator of its own, and its workspace's bytes printed;
     gru_scan and gru_scan_bwd at B=64, L=512
     (the forward as in phase 2, the backward as in phase 2b);
     dtable on phase 6's four tables with the ids of its first batch, as
     in phase 2b; then the widths no kernel is built for, which the
     wrappers pad, each against its twin at the native width, the same
     bits twice and one launch a call: gru_scan and gru_scan_bwd at u =
     16 and 48, dtable and scatter_add at d = 16, 48, 96, fused_readout
     and fused_readout_bwd (gemm designs, the live width beside the
     padded one) at d = 16, 48, 96;
  2f. the chain readout's kernels the same way: readout_chain and
     readout_chain_bwd at B = 1, 16, 256 x L = 50 and B = 1, 16, 64 x L
     = 150, 255 (d=128, 3 hops) and at B=16, L=50 with d = 16 and 64, in
     f32 and bf16 (positional and scalar wo2 rows, ragged key lengths,
     one row with no live key and no score gradient, one masked query),
     each in the design the wrapper must pick ("staged" at L=50,
     "blocked" at L = 150 and 255), two launches of each bit-equal, and
     the "rows" design forced beside it, held and bit-equal the same way;
     both timed at phase 4's shape (B=256, L=50, every key live) and at
     phase 14's (B=64, L=150, every key live), each design pair in turns
     (picked, rows, rows, picked) by events, by the profiler's device
     time and its split by launch, and by the host time a call, with the
     per-row kernels' shared memory a block and blocks an SM; then the
     same at ONE hop (NARM+'s and NARM++'s readout: B = 1, 16 at d=128
     and B=16 at d=16, ragged; phase 4's shape timed, "@L50h1"); then
     phase 15's readouts at L=150 with positional wo2 rows, B = 1, 16,
     64 (d=128, ragged) at 3, 1 and 6 hops (MTAM_with_T_SeqRec's
     preset), phase 14's shape timed ("@L150pos", "@L150h1",
     "@L150h6");
  3. the serving slice: Recommender.recommend at full width (MTAM d=128,
     3 hops, L=50, the ml-1m catalog, k=50) for B = 1, 16, 256 in bf16
     and f32 compute, with launch counts per scoring call, scores held
     against the same Recommender on the CPU (the plain twins), and the
     time per request batch (1 gru_scan + 3 fused_attention[time] in the
     hop design a call, none in the query design); at B = 256 the scoring
     call's device busy time and event ms in turns with the attention
     forward forced to its query design (hop, query, query, hop); then
     the same at num_units 16 for B = 16 (the GRU scan padded to 32
     units);
  4. the training slice: bench.py's MTAM step (B=256, L=50, d=128, 3
     hops, 4832 users, 3706 items, 18 categories, tables padded to 128
     rows, adam clipped to 1.0) on 4096 rows made from seed 0 and held
     on the card: one step's loss and every gradient leaf against the
     CPU in f32 and bf16, five f32 steps against the CPU (the losses of
     the card's own run; the parameters after each step taken from the
     CPU's parameters and Adam state before it), launch counts
     per step (1 gru_scan, 1 gru_scan_bwd, 4 dtable, 1 readout_chain, 1
     readout_chain_bwd, both in the staged design, 0 fused_attention),
     and the time per step, examples/s and device idle share in bf16 and
     f32 (phase 2f holds and times the chain pair's rows designs); then
     one step at num_units 16 against the CPU in f32 and bf16 (the GRU
     pair and dtable padded);
  5. the self-attention slice on the same data and catalog, 3 blocks,
     1 head: Time_Aware_Self_Attention_Model's step as phase 4 checks
     MTAM's (3 fused_attention[time] + 3 fused_attention_bwd[time] + 4
     dtable launches a step); SASrec's and TiSAS's step in f32 and bf16
     against the CPU with masks drawn on the CPU and injected on both
     sides (3 [*_drop] forward + 3 backward launches a step, the
     backward's tile design, never its rows design), then timed with the
     card's own generator drawing the masks (3 fused_attention launches
     a step in the tile design and none in the query design); and
     Recommender.recommend for each of the three at B = 16 in bf16
     against the CPU (3 tile-design forward launches a call; MTAM's Tq =
     1 hops in phase 3 take the hop design);
  6. MTAM over long histories (benchmarks/long_history_bench.py's run:
     d=128, 3 hops, 1 head, the scalar gate, tables padded to 128 rows,
     adam clipped to 1.0, L=512, B=64, 100 users, 2000 items, 18
     categories) on 2048 rows of its Markov-walk data made from seed 0:
     one step's loss and every gradient leaf against the CPU in f32 and
     bf16, five f32 steps against the CPU as in phase 4, the step timed
     in bf16 and f32 (1 gru_scan, 1 gru_scan_bwd, 4 dtable, 1
     fused_readout, 1 fused_readout_bwd, 0 fused_attention launches a
     step), and Recommender.recommend at L=512 for B = 1, 16, 64 in
     bf16 and f32 against the CPU (1 gru_scan + 1 fused_readout a call),
     the scoring call at B = 64 timed in turns with fused_readout forced
     to the rows design (default, rows, rows, default);
  2e. (run after 2d) past 1024 keys: gru_scan and gru_scan_bwd (tgru)
     at B=64, L=2048, every row full, as in phase 2d (each twin run once
     to check and once to time); fused_attention_blockwise in each
     mode against its twin in f32 and bf16 at Tq = 1 (B = 1, 16, 64 x
     Tk = 1025, 2048, 4096), Tq = Tk = 2048 (B = 1, 16, 64), ragged
     key lengths (a row with no live key, a full row, one ending inside
     the first 512-key block) and two ragged tiles (B=3, Tq=Tk=1100,
     key lengths 0, 1100, 1037; B=2, Tq=Tk=4096, 4096 and 2600); at Tq
     = 1 every case takes the split design (each row's keys in 256-key
     splits, a block each, then a merge), at Tq = Tk bf16 the
     tensor-core design and f32 the register-tiled design (each: the
     same bits twice; the SIMT design forced and checked beside it; at
     Tq = 1 rows 1, 2 and B-1 also alone, bit-equal to themselves in
     the batch); timed at B = 64, Tk = 2048, every key live (Tq = Tk:
     the tiled design and the SIMT design, forced, in both dtypes; Tq =
     1: the split design and the SIMT design in turns, the profiler's
     split of the two launches, and splits of 128, 256 and 512 keys in
     turns) beside scaled_dot_product_attention for plain and tisas;
     dtable at the L=2048 cell's 131,072 ids a table (the user table's
     64), as in phase 2b; gather and scatter_add against their twins at
     those ids and at phase 4's ids, the same bits twice, timed beside
     index_select and index_add_; gather in its default "vector" design
     also torch.equal to its twin and to the earlier "warp_row" design
     forced, ids below 0 and past V giving zero rows in both, both timed
     in turns (vector, warp_row, warp_row, vector) by events and the
     host's clock, with the profiler's device time a call of each and of
     index_select from rounds of the same turns; then gather at d = 16,
     64, 256 and 6 ("warp_row") in both dtypes, the library's design and
     grid rules equal to the wrapper's; scatter_add in its default "columns"
     design also torch.equal to its twin and to the earlier "segments" design
     forced, both timed in turns (columns, segments, segments, columns)
     with the profiler's device time a call and split by kernel, and
     index_add_'s device time; at L=2048 first on 131,072 ids over 3
     rows (a chain longer than any table's), whose chain time an add
     gives each table's chain floor;
  7. past 1024 keys at the slice's configuration (phase 6's cell at
     L=2048, 256 rows of its data): Recommender.recommend for MTAM,
     SASrec, TiSAS and Time_Aware_SA at B = 1, 16, 64 in bf16 and f32
     (MTAM: 1 gru_scan + 3 fused_attention_blockwise_split[time] a call,
     the split design at Tq = 1; the others 3 a call in their mode, the
     tensor-core design (fused_attention_blockwise_mma) in bf16, the
     register-tiled design (fused_attention_blockwise_regtile) in f32),
     scores against the CPU
     at B = 2 (the CPU's time at L=2048 sets that size); MTAM's scoring
     call at B = 64 timed in turns with gru_scan forced to the unit_column
     design (default, unit_column, unit_column, default), and at B = 1
     and 64 in turns with the blockwise kernel forced to the SIMT design
     (default, simt, simt, default);
     Time_Aware_SA's and MTAM's step: one step against the CPU at B = 2
     (in bf16 the scalar gates' gradients reported, not held), 3 steps
     after 1 warm-up timed at B = 64 in bf16 and f32 with its peak
     memory (Time_Aware_SA: 3
     blockwise[time] (mma in bf16, regtile in f32) + 3 dense_bwd[time] +
     4 dtable a step, no
     fused_attention_bwd; MTAM: 1 gru_scan + 1 gru_scan_bwd + 4 dtable,
     its readout in plain PyTorch, no attention, readout or chain kernel);
     SASrec's and TiSAS's at dropout 0.5 (CPU masks injected; 3
     dense_fwd a step and no attention kernel), timed in bf16; and
     behavior_embedding(gather=embedding_kernel.gather) forward and
     backward on the cell's first batch against take_dtable (4 gather +
     4 scatter_add launches), timed in turns with scatter_add's and then
     gather's earlier design forced;
  8. a trained model from disk, on phase 4's cell in bf16 and f32
     (train.checkpoint, train.evaluate, serve.from_checkpoint,
     serve.main; the checkpoints in a temporary directory, removed
     afterwards): 6 unbroken make_train_step steps against 3 steps, a
     Checkpointer save, a restore (apply_load_type "full") into a
     fresh model on the card and 3 more steps, parameters, Adam mu / nu
     and losses torch.equal; "fine_tune" (the saved parameters, Adam
     zero, step 0) and the card's checkpoint restored on the CPU
     (parameters and Adam state equal); evaluate_dataset from the
     6-step checkpoint on the card and on the CPU over
     make_train_arrays(meta, 3000, seed=1) in batches of
     train.test_batch_size (2,048: two, the second 952 live rows and
     its pad slots): every HR@k / NDCG@k within EVAL_ATOL (0.005 f32,
     0.02 bf16) of the CPU's, in f32 at least EVAL_RANKS_EQUAL (99 %)
     of the live rows' ranks equal (bf16: reported), the first batch's
     scores within SLICE_TOL of the largest |score|, an eval batch's
     event ms and device busy ms and the profiler's launches (1
     gru_scan_kernel + 3 attn_fwd_hop_kernel a batch); then
     Recommender.from_checkpoint on the card, recommend k=50 at B=16
     with the same ids as a Recommender of the in-memory model; then
     python -m mtamrecommender_tpu_torch.serve in a subprocess on 4
     request lines (an empty history, one of 2L events, two with k
     given) answering as in-process recommend line by line (the same
     ids, scores within 1e-5), and each request's host ms in-process.
     Launches, counted from 0 around each part: 12 steps (1 gru_scan
     + 1 gru_scan_bwd + 4 dtable + 1 readout_chain + 1
     readout_chain_bwd a step), 2 eval batches and 1 recommend call (1
     gru_scan + 3 fused_attention_hop[time] each).
  9. the rest of the registry, on phase 4's cell at 3 hops
     (ZOO_MODELS: Gru4Rec, Vallina_Gru4Rec, T_SeqRec, T_GRU,
     MTAM_no_time_aware_rnn, MTAM_via_rnn, MTAM_with_T_SeqRec,
     MTAM_via_T_GRU, MTAM_hybird, MTAM_no_time_aware_att, NARM, NARM+,
     NARM++, LSTUR, LSTUR_time_rnn, STAMP, pistrec, bpr): each one
     step's loss and every gradient leaf against the CPU at B=64 in f32
     and bf16 (phase 4's tolerances; the plain readout's dropout masks
     and bpr's negative item drawn on the CPU and injected on both
     sides) with the step's launches (1 gru_scan + 1 gru_scan_bwd in
     the model's mode, dtable once a table the loss reaches, 1
     readout_chain + 1 readout_chain_bwd where the model reads out in
     the time kind, 3 fused_attention[time] + 3 fused_attention_bwd[time]
     where it self-attends), 3 timed make_superstep steps after 1
     warm-up at B=256 in bf16 (ms a step, examples/s, idle
     share), recommend k=50 at B=16 against the CPU (SLICE_TOL) and at
     B=256 timed (1 gru_scan, the readout's hops in the hop design of
     its kind, 3 fused_attention[time] where it self-attends, a call);
     launches on each first-time path (ZOO_GROUP_KERNELS: the plain
     readout's hops, the chain pair at one hop, the GRU pair from a
     user's row, PISTRec's self-attention pair);
     MTAM_with_T_SeqRec at its preset's 6 hops
     (MTAM_with_T_SeqRecb6_yoochoose): one step against the CPU at
     B=256, 3 timed bf16 steps, recommend at B=256 against the CPU and timed
     (6 hops a call); bidirectional_gru_net at B=16, L=50, u=128
     against the CPU, the output and every gradient (2 gru_scan[plain]
     + 2 gru_scan_bwd[plain]); MTAM_hybird (the concat head) from disk:
     2 steps, a Checkpointer save, Recommender.from_checkpoint on the
     card giving the in-memory model's ids at B=16, and
     evaluate_dataset over one batch of 2,048 held-out rows against the
     CPU within EVAL_ATOL; FPMC (no kernel) at ml-1m's catalog: 5
     sbpr_steps at B=256 against the CPU, score_all, train_fpmc for one
     epoch on the card and evaluate against the CPU;
  10. the command line end to end, from a log: synthetic_timed at its
     default size (2,000 users, 3,600 items; ~76,000 training rows);
     the native builder (g++ at first use) and the Python builder timed
     on it, their rows equal as a multiset; `cli.main` in process to
     step 120 at the default widths (MTAM d=128, 3 hops, L=50, B=256,
     test batch 2,048) in bf16, evaluation and checkpoints every 40
     steps: the native builder ran, finite losses, evaluations at steps
     0, 40, 80 and 120, hr@10 above 10/3,600, and the launches counted
     from 0 around it exactly 120 x (1 gru_scan + 1 gru_scan_bwd + 4
     dtable + 1 readout_chain + 1 readout_chain_bwd) + each evaluation
     batch's 1 gru_scan + 3 fused_attention_hop[time]; `python -m
     mtamrecommender_tpu_torch` in a subprocess to step 80, then again
     with train.load_type=full to 120: it logs "resuming at step 80" and
     its final parameters, Adam state and best equal the in-process
     run's (torch.equal); SASrec at dropout 0.5 through the Trainer
     (steps_per_call 4), 3 + 3 steps resumed mid-epoch equal to 6; 6
     steps of the Trainer's host path (batch_iterator +
     prefetch_to_device) equal to its device-resident path's; 10
     f32 Trainer steps on the card, each loss within TRAJ_LOSS_RTOL of
     the CPU's from the same parameters; the fit's bf16 step timed (steps
     a second, the profiler's idle share), one evaluation pass, and the
     command's seconds from launch to its first step.  The runs live in
     the ignored build/phase10/, removed afterwards.
     `python3 chip_smoke.py --only 10` builds and runs phase 10 alone.
  11. multi-head attention and the last single-device modules, on phase
     4's cell at num_heads = 2 (d=128, 64 a head; the attention and
     readout kernels take one head, so the attention takes the dense
     route, `dense_fwd`, as the JAX package takes its jnp path): MTAM's
     step against the CPU at B=64 in f32 and bf16 (1 gru_scan + 1
     gru_scan_bwd + 4 dtable, no attention, readout or chain kernel), 8
     timed steps after 2 warm-up at B=256 in bf16 and f32, recommend
     k=50 at B=16 against the CPU and at B=256 (1 gru_scan + 3
     dense_fwd[time] a call); Time_Aware_SA, SASrec and TiSAS one step
     each against the CPU in f32 and bf16 (SASrec's and TiSAS's [B, 2,
     L, L] masks drawn on the CPU and injected on both sides; 3
     dense_fwd in the model's mode + 4 dtable a step), then 8 timed bf16
     steps; MTAM at L=512, B=16 (phase 6's cell) one f32 step against
     the CPU (no fused_readout launch) and recommend at B=16 against the
     CPU; PISTRec one f32 step against the CPU; the phase's MTAM from
     disk (2 steps, a Checkpointer save, figures.heatmap_arrays of
     Recommender.from_checkpoint on the card and the CPU within 1e-5,
     the item tables equal); the five layer helpers on CUDA tensors
     against the CPU within 1e-6 (output and input gradient).
     `python3 chip_smoke.py --only 11` builds and runs phase 11 alone.
  12. parallel/ on torch.distributed (`run_phase12`): 4 spawned ranks (a
     FileStore under the ignored build/phase12/; NCCL where each rank
     has its own card, gloo where they share one, printed with whether
     the collectives go through host memory) and `python -m
     torch.distributed.run --nproc_per_node 2 -m mtamrecommender_tpu_torch
     --model_parallel 2` on phase 10's log (6 steps) start; while they
     set up, (a) the reference, one rank on a 1-rank NCCL group, mesh
     1x1, in this process, on phase 4's cell (L=50) and phase 6's
     (L=512); then the ranks run (b) 2 ranks, mesh 2x1 (data parallel),
     (c) 2 ranks, mesh 1x2, row-sharded tables, the psum and the a2a
     engine, (d) 4 ranks, mesh 2x2, the default engine (gspmd, which
     runs psum), (e) 2 ranks, mesh 1x2, key-axis context parallelism on
     phase 6's cell; each: one step's loss (f32 within 1e-5 relative,
     bf16 2e-2) and every gradient leaf, gathered, against (a)'s from the
     same parameters and global batch (f32 within TRAIN_TOL, bf16 as
     phase 4 holds the card against the CPU; in (e) the scalar gates'
     bf16 gradients reported, not held, as phase 7 reports them), one
     sharded f32 step's launches on each rank exactly (the L=50 step: 1
     gru_scan + 1 gru_scan_bwd + 4 dtable + 1 readout_chain + 1
     readout_chain_bwd; the CP step: the GRU pair + 4 dtable, no readout
     kernel), the sharded evaluation at B=2,048 equal to (a)'s (the CP
     run within one row's share a metric), and 8 timed bf16 steps of the
     Trainer's superstep after 2 warm-up: ms a step, each rank's busy ms
     and idle share, the collectives' device ms from the profiler; a
     2-rank Trainer fitted to step 6 against one fitted to 3, saved,
     restored and fitted on to 6 (parameters and Adam moments
     torch.equal).  `python3 chip_smoke.py --only 12` builds and runs
     phase 12 alone.
  13. the self-attention models at the JAX package's L=256 run
     (benchmarks/long_history_bench.py --seq_len 256: phase 6's cell at
     L=256, B=64, d=128, 3 blocks, 1 head, the scalar gate, 2,000 items,
     2,048 rows of markov_long_arrays from seed 0): Time_Aware_SA, SASrec
     and TiSAS (the last two at dropout 0.5) one step's loss and every
     gradient leaf against the CPU in f32 and bf16 at B=16 (masks drawn on
     the CPU and injected on both sides), the launches of a step exactly
     (3 fused_attention + 3 fused_attention_bwd, all in the wide design,
     + 4 dtable; no query, rows or dense launch), each f32 leaf allowed
     the CPU's own gap between the plain twins' summation order and the
     wide twins' and its distance from a float64 CPU step printed for the
     card and both orders, for Time_Aware_SA the wide backward's gate
     terms on the card's own inputs held to float64 and its gate sums to
     the exact sum of its terms (`gate_terms_check`), 10 steps timed at B=64
     in bf16 and f32 with the device idle share, and
     Recommender.recommend at B = 1, 16, 64 in bf16 and f32 against the
     CPU at each B (3 wide forward launches of the base mode a call).
     `python3 chip_smoke.py --only 13` builds and runs phase 13 alone.
  14. MTAM at the reference's attention cap, L=150
     (benchmarks/long_history_bench.py --seq_len 150: phase 6's cell at
     L=150, B=64, d=128, 3 hops, 1 head, the scalar gate, 2,000 items,
     2,048 rows of markov_long_arrays from seed 0): one step's loss and
     every gradient leaf against the CPU in f32 and bf16 at B=16, the
     launches of a step exactly (1 gru_scan + 1 gru_scan_bwd, 1
     readout_chain + 1 readout_chain_bwd both in the blocked design, 4
     dtable; no rows-design, fused_readout or fused_attention launch),
     5 steps timed at B=64 in bf16 and f32 with the device idle share;
     fused_attention at Tq=1, Tk=150 (the serving hops: time mode, and
     the plain mode with scaled_dot_product_attention beside it) against
     its twin at B = 1, 16, 64 in the blocked design (the same bits twice,
     the query design forced beside it), timed at B=64 in turns with the
     query design (event, device, host ms of both) with its shared
     memory a block and blocks an SM; Recommender.recommend at B = 1,
     16, 64 in bf16 and f32 against the CPU at each B for MTAM (1
     gru_scan + 3 fused_attention[time] in the blocked design a call,
     none in the query design) and for MTAM_no_time_aware_att, the
     plain-kind readout (1 gru_scan + 3 fused_attention[plain] in the
     blocked design a call).
     `python3 chip_smoke.py --only 14` builds and runs phase 14 alone.
  15. the registry at the reference's cap: phase 14's data at the JAX
     package's default (positional) decay gate, d=128, 3 hops or blocks
     (MTAM_with_T_SeqRec 6, the NARM family 1), for every registry
     model whose kernels take another design at L=150 than at L=50
     (`models_at_cap`, printed: MTAM and its five ablations, the NARM
     family, pistrec and the three self-attention models): one step's
     loss and every gradient leaf against the CPU in f32 and bf16 at
     B=16 (phase 14's tolerances; dropout masks drawn on the CPU and
     injected on both sides; the CPU's ReLUs, the chain twins' query
     ReLU too, on the card's side where an input is within RELU_KINK_EPS
     eps of 0 relative to its tensor: `relu_sides`), the
     launches of a step exactly (the chain pair blocked, the
     self-attention pair wide; no rows, query or dense launch), 3 steps
     timed at B=64 in bf16 with the device idle share, and
     Recommender.recommend at B = 1, 16, 64 in bf16 and f32 against the
     CPU at each B (the Tq = 1 hops in the blocked design, 1, 3 or 6 a
     call); then PISTRec's other pistrec_types one f32 step and
     recommend at B=16 each.  `python3 chip_smoke.py --only 15` builds
     and runs phase 15 alone.
The line before the last is {"kernels": [...]}, one entry per kernel, mode
and main-path shape (the attention kernels at Tq=1, Tk=50 as "@Tq1", at
Tq=Tk=50 as "@Tq50" and, in their wide designs, at B=64, Tq=Tk=256 as
"@L256" with the query or rows design's times on the same inputs in
turns beside them, and the blocked forward at Tq=1, Tk=150 as
"@L150Tq1" with the query design's times beside it;
the chain readout's pair at MTAM's L=50 step
as "@L50", at one hop as "@L50h1" and at MTAM's L=150 step (B=64) as
"@L150", with positional wo2 rows as "@L150pos" and at 1 and 6 hops as
"@L150h1" and "@L150h6" (phase 15's launches); the readout, GRU and
dtable kernels at B=64,
L=512 as "@L512"; the blockwise kernel at B=64, Tq=Tk=2048, the GRU
kernels at B=64, L=2048 and
dtable and the gather / scatter-add pair at L=2048 as "@L2048" (dtable's
entries also carry "device_ms" and "library_device_ms", gru_scan_bwd's
"four_product_ms", the four-product design on the same inputs, and "passes_ms",
the default design's device time by kernel, fused_attention_bwd's at
Tq=Tk=50 "rows_ms", "rows_device_ms" and "rows_passes_ms", the rows
design on the same inputs in turns, beside the tile design's
"device_ms" and "passes_ms", fused_attention's at Tq=Tk=50 (tile) and
at Tq=1, Tk=50 (hop) "design", "device_ms", "query_ms" and
"query_device_ms", the query design on the same inputs in turns,
gru_scan's "unit_column_ms",
the unit_column design on the same inputs, fused_readout's and
fused_readout_bwd's "rows_ms", the rows design on the same inputs, and
"passes_ms", scatter_add's "segments_ms" and "segments_device_ms", PR
5's design on the same inputs in turns, "device_ms", "library_device_ms"
and "passes_ms", gather's "design", "device_ms", "library_device_ms",
"warp_row_ms" and "warp_row_device_ms", the warp_row design on the same
inputs in turns), the
blockwise kernel's
tiled designs as "fused_attention_blockwise_mma[<mode>]@L2048" (bf16)
and "fused_attention_blockwise_regtile[<mode>]@L2048" (f32), each with
the SIMT design's time on the same inputs beside it ("simt_ms"), the
blockwise kernel's split design at MTAM's Tq=1 hops as
"fused_attention_blockwise_split[<mode>]@L2048Tq1" with the SIMT
design's time beside it, "simt_ms", and "passes_ms"); the last line
is {"ok": true,
"device": {...}}.  A full report is written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 FMA units; bf16 tensor cores
# kernel vs plain twin on the card: max |diff| / max |output|
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the attention forward's tile design at Tq = Tk = 50 vs its twin and vs
# the query design forced, and its hop design at Tq = 1 vs the query
# design forced: max |diff| / max |output|
TILE_FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# card vs CPU scores: max |diff| / max |score| over the catalog
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

DEVICE = "cuda"

# kernel -> (its source, the TPU kernel body it replaces)
KERNEL_FILES = {
    "gru_scan": ("mtamrecommender_tpu_torch/csrc/gru_scan.cu",
                 "mtamrecommender_tpu/ops/pallas/gru_kernel.py:64"),
    # the hop design, the main path's at Tq = 1, Tk = 50 (the "@Tq50"
    # entries name the tile design's source; each row its own design's,
    # FWD_SOURCES)
    "fused_attention": ("mtamrecommender_tpu_torch/csrc/fused_attention_hop.cu",
                        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:60"),
    "gru_scan_bwd": ("mtamrecommender_tpu_torch/csrc/gru_scan_bwd.cu",
                     "mtamrecommender_tpu/ops/pallas/gru_kernel.py:174"),
    "dtable": ("mtamrecommender_tpu_torch/csrc/embedding_dtable.cu",
               "mtamrecommender_tpu/ops/pallas/embedding_kernel.py:174"),
    # the tile design, the main path's at Tq = Tk = 50 (the rows design,
    # fused_attention_bwd.cu, takes Tq = 1, Tk = 1024: by_dtype's
    # "*_tq1_tk1024" rows)
    "fused_attention_bwd": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_bwd_tile.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:325"),
    "fused_readout": ("mtamrecommender_tpu_torch/csrc/fused_readout.cu",
                      "mtamrecommender_tpu/ops/pallas/readout_kernel.py:115"),
    "fused_readout_bwd": (
        "mtamrecommender_tpu_torch/csrc/fused_readout_bwd.cu",
        "mtamrecommender_tpu/ops/pallas/readout_kernel.py:138"),
    "fused_attention_blockwise": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_blockwise.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:134"),
    # the same kernel's tensor-core design (bf16, Tq > 1)
    "fused_attention_blockwise_mma": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_blockwise.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:134"),
    # and its register-tiled design (f32, Tq > 1)
    "fused_attention_blockwise_regtile": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_blockwise.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:134"),
    # and its split design (Tq = 1: each row's keys across blocks, merged)
    "fused_attention_blockwise_split": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_blockwise.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:134"),
    "gather": ("mtamrecommender_tpu_torch/csrc/embedding_gather.cu",
               "mtamrecommender_tpu/ops/pallas/embedding_kernel.py:33"),
    "scatter_add": ("mtamrecommender_tpu_torch/csrc/embedding_gather.cu",
                    "mtamrecommender_tpu/ops/pallas/embedding_kernel.py:74"),
    "readout_chain": (
        "mtamrecommender_tpu_torch/csrc/readout_chain.cu",
        "mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py:103"),
    "readout_chain_bwd": (
        "mtamrecommender_tpu_torch/csrc/readout_chain_bwd.cu",
        "mtamrecommender_tpu/ops/pallas/readout_chain_kernel.py:131"),
}
FWD_TILE_SOURCE = "mtamrecommender_tpu_torch/csrc/fused_attention_tile.cu"
# the single-tile forward's source by design (`attention_fwd_design`)
FWD_SOURCES = {"tile": FWD_TILE_SOURCE,
               "hop": "mtamrecommender_tpu_torch/csrc/fused_attention_hop.cu",
               "blocked":
                   "mtamrecommender_tpu_torch/csrc/fused_attention_blocked.cu",
               "wide": "mtamrecommender_tpu_torch/csrc/fused_attention_wide.cu",
               "query": "mtamrecommender_tpu_torch/csrc/fused_attention.cu"}
BWD_WIDE_SOURCE = "mtamrecommender_tpu_torch/csrc/fused_attention_bwd_wide.cu"
# the wide designs' kernels by library: the forward's <type, mode, drop>,
# the backward's query pass <type, mode, drop> and key pass <type>
WIDE_KERNELS = {"fused_attention_wide": ("attn_fwd_wide_kernel",),
                "fused_attention_bwd_wide": ("attn_bwd_wide_query_kernel",
                                             "attn_bwd_wide_key_kernel")}
# phase 2c's wide shapes, (B, Tq = Tk, d): every B at d=128, B=16 at d=16;
# timed at B=64 and the lengths of WIDE_TIMED (L256 is phase 13's cell)
WIDE_CASES = (tuple((bs, t, 128) for t in (65, 256, 1024)
                    for bs in (1, 16, 64))
              + tuple((16, t, 16) for t in (65, 256, 1024)))
WIDE_TIMED = (256, 1024)
# the forward hop design's kernel, its template arguments <type, mode, drop>
FWD_HOP_KERNELS = ("attn_fwd_hop_kernel",)
# the hop design's (Tk, d) in phase 2 (Tk=50, d=128: MTAM's serving hops,
# timed; d=16: the narrow width phase 3 also serves)
HOP_SHAPES = tuple((tk, d) for tk in (1, 17, 50, 64) for d in (16, 128))
# the forward blocked design's kernel, its template arguments <type, mode,
# drop>
FWD_BLOCKED_KERNELS = ("attn_fwd_blocked_kernel",)
# the blocked design's (Tk, d) in phase 2: each side of a 64-key block,
# of 256 keys (the chain pair's cap) and 1024 (the design's), at d = 16
# and 128; at B = 1, 16, 64 (B = 256 at Tk=1024), timed at Tk=150, B=64
# (MTAM's serving hops at L=150) and at Tk=1024, B=256 (the plain-kind
# readout's longest) in the serving modes
BLOCKED_SHAPES = tuple((tk, d) for tk in (65, 150, 255, 256, 257, 1024)
                       for d in (16, 128))
BLOCKED_TIMED = {150: 64, 1024: 256}      # Tk -> the timed B (d=128)
# the forward tile design's kernels (bf16, f32), their template arguments
# <mode, drop>
FWD_TILE_KERNELS = ("attn_fwd_tile_mma_kernel", "attn_fwd_tile_fma_kernel")
SERVING_MODES = ("plain", "time", "tisas")   # the forward modes phase 2 holds
SELF_ATTENTION = {"SASrec": "plain_drop",
                  "Time_Aware_Self_Attention_Model": "time",
                  "Ti_Self_Attention_Model": "tisas_drop"}
# the training step (bench.py's MTAM cell): card vs CPU, per gradient
# leaf, max |diff| / max |CPU f32 leaf|; in bf16 the CPU's own bf16-vs-f32
# gap is allowed on top (see PERF.md)
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAJ_LOSS_RTOL = 1e-4        # five f32 steps: each loss, relative
# five f32 steps, each from the CPU's parameters and Adam state: the
# parameters after it (lr 1e-3), per leaf
TRAJ_PARAM_ATOL = 2e-4
TRAIN_BATCH, TRAIN_ROWS = 256, 4096


def make_histories(rng, n, items, cats, max_len):
    """Synthetic (item, category, unix_seconds) histories of 5..max_len-1
    events (the generator of benchmarks/serve_bench.py)."""
    out = []
    base = 1_700_000_000
    for _ in range(n):
        hist_len = int(rng.randint(5, max_len))
        t = base + np.cumsum(rng.randint(60, 86400, hist_len))
        out.append([(int(rng.randint(1, items + 1)),
                     int(rng.randint(1, cats + 1)), float(tt))
                    for tt in t])
    return out, [float(t[-1] + 3600)] * n


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


class Timer:
    """Mean ms per call from CUDA events, each call after an L2 flush
    (the 50 MB L2 would otherwise hold the inputs between calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters

    def _profiled(self, fn, iters, warmup):
        """The device kernels ``fn`` launches over ``iters`` calls, each
        after the L2 flush, as (key, device us a call) from torch.profiler's
        averages, the flush's own kernel (the uint8 fill) left out.  A
        kernel's time a call is the mean of its recorded launches times
        its launches a call (its record count over ``iters``, rounded):
        in a long process the profiler drops some records (and a kernel
        with fewer records than half of ``iters`` is a stray of an
        earlier call).  None where it records no device time or a
        kernel's count is no near multiple of ``iters``, after two
        tries."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            rows = []
            for e in prof.key_averages():
                if (not str(getattr(e, "device_type", "")).endswith("CUDA")
                        or e.key.startswith("Activity Buffer")
                        or "FillFunctor<unsigned char>" in e.key
                        or not e.count):
                    continue
                per_call = round(e.count / iters)
                if per_call < 1:      # a stray record of an earlier call
                    continue
                if abs(e.count / iters - per_call) > 0.25:
                    rows = None
                    break
                rows.append((e.key, getattr(e, "self_device_time_total", 0)
                             / e.count * per_call))
            if rows and sum(t for _, t in rows) > 0:
                return rows
        return None

    def device(self, fn, iters=20, warmup=3):
        """Device time per call from torch.profiler (`_profiled`): the
        kernels ``fn`` launches, each call after the same L2 flush as
        __call__, the flush's own kernel left out; None where the
        profiler gives none."""
        rows = self._profiled(fn, iters, warmup)
        return None if rows is None else sum(t for _, t in rows) / 1e3

    def passes(self, fn, iters=5, warmup=2):
        """Device time per call of each kernel ``fn`` launches, by kernel
        function name, from torch.profiler (`_profiled`); {} where the
        profiler gives none."""
        split = {}
        for key, per_call in self._profiled(fn, iters, warmup) or ():
            found = re.search(r"::(\w+)[<(]", key)
            name = found.group(1) if found else key[:60]
            split[name] = split.get(name, 0.0) + per_call / 1e3
        return split

    def host(self, fn, iters=200, warmup=3):
        """Host time per call, ms: ``iters`` calls issued back to back
        with no synchronisation inside the loop (the card keeps up)."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / iters * 1e3


def ptxas_counts(log, kernel):
    """(instantiation, registers, spill store bytes, spill load bytes)
    for each instantiation of ``kernel`` in an nvcc -Xptxas -v log, its
    template arguments read from the mangled name (``f`` is float,
    ``13__nv_bfloat16`` bf16, then the integer and bool arguments; a
    kernel whose first argument is no type gets no type in its name)."""
    rows, name, spill = [], None, None
    for ln in log.splitlines():
        found = re.search(r"Function properties for (\S+)", ln)
        if found:
            name, spill = found.group(1), None
            continue
        if name is None or f"{len(kernel)}{kernel}I" not in name:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        if found:
            spill = (int(found.group(1)), int(found.group(2)))
        found = re.search(r"Used (\d+) registers", ln)
        if found:
            args = name.split(f"{len(kernel)}{kernel}I", 1)[1]
            dtype = ("bf16" if args.startswith("13__nv_bfloat16") else
                     "f32" if args.startswith("f") else None)
            ints = re.findall(r"L[ib](\d+)E", args.split("EEv", 1)[0])
            rows.append((f"{kernel}<{', '.join(([dtype] if dtype else []) + ints)}>",
                         int(found.group(1)), *(spill or (None, None))))
            name = None
    return rows


def rel_err(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


# ------------------------------------------------------------ phase 2

def gru_inputs(torch, gen, mode, dtype, B=256, L=50, u=128):
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    lengths = torch.randint(0, L + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, L], dtype=torch.int32)[:B]
    return (rand(B, L, 2 * u, scale=0.8), rand(B, L, u, scale=0.8),
            rand(B, L, u, scale=0.5), rand(B, L, u, scale=0.5).abs(),
            lengths, rand(B, u, scale=0.5),
            rand(u, 2 * u, scale=1 / math.sqrt(u)),
            rand(u, u, scale=1 / math.sqrt(u)),
            rand(2 * u, scale=0.1), rand(u, scale=0.1),
            rand(4, u, scale=0.5))


def gru_bound(mode, args, dtype_name):
    """Least time for the work these inputs need: alive steps' inputs read
    once, the weights and h0 read once, the whole output written once,
    and 2*u*3u FLOPs per alive step."""
    gx, lengths = args[0], args[4]
    B, L, u2 = gx.shape
    u = u2 // 2
    es = gx.element_size()
    steps = int(lengths.clamp(0, L).sum().item())
    per_step = (2 * u + u + (0 if mode == "plain" else 2 * u)) * es
    nbytes = (steps * per_step + B * 4 + B * u * es + 3 * u * u * es
              + 7 * u * es + B * L * u * 4)
    flops = steps * 2 * u * 3 * u
    return _bound(nbytes, flops, dtype_name)


def check_gru_fwd(torch, gk, mode, args, dname):
    """gru_scan on the card against its twin: the default design (two
    launches, the same bits twice) and the earlier unit_column design forced,
    each within KERNEL_TOL, every output past a row's length exactly 0.
    Returns (max |diff|, max rel, ok, same bits twice, the forced design's
    max rel)."""
    want = gk.gru_scan_plain(mode, *args)
    got = gk.gru_scan(mode, *args)
    again = gk.gru_scan(mode, *args)
    column = gk._launch(mode, *args, _design="unit_column")
    dead = torch.arange(args[0].shape[1], device=DEVICE)[None, :] \
        >= args[4][:, None]
    err, rel, ok = _agree(got, want, dname, dead)
    _, column_rel, column_ok = _agree(column, want, dname, dead)
    same = torch.equal(got, again)
    return err, rel, ok and column_ok and same, same, column_rel


def time_gru_fwd(timer, gk, mode, args, iters):
    """The default design and the unit_column design on the same inputs,
    in turns (default, unit_column, unit_column, default)."""
    run = lambda: gk.gru_scan(mode, *args)  # noqa: E731
    column = lambda: gk._launch(  # noqa: E731
        mode, *args, _design="unit_column")
    a, b1, b2, a2 = (timer(run, iters), timer(column, iters),
                     timer(column, iters), timer(run, iters))
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "unit_column_ms": (b1 + b2) / 2,
            "unit_column_ms_repeats": [b1, b2]}


def att_inputs(torch, gen, dtype, B=256, Tq=1, Tk=50, d=128):
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    hours = 470_000.0 + torch.rand(B, Tk, generator=gen, device=DEVICE) * 5000
    t_k = hours.sort(dim=1).values.to(dtype)
    # self-attention (Tq = Tk) reads the keys' hours; a readout query sits
    # an hour after its last key
    t_q = t_k if Tq == Tk else (hours.max(dim=1, keepdim=True).values
                                + 1.0).expand(B, Tq).contiguous().to(dtype)
    key_len = torch.randint(1, Tk + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    key_len[:2] = torch.tensor([0, Tk], dtype=torch.int32)[:B]
    gate = [rand(Tq, Tk, scale=0.3) for _ in range(5)]
    return (rand(B, Tq, d).relu(), rand(B, Tk, d).relu(), rand(B, Tk, d).relu(),
            t_q, t_k, rand(B, Tq, d, scale=0.3), rand(B, Tk, d), *gate,
            key_len)


def weighted_pairs(args, dm=None):
    """(query, key) pairs the weighted sum reads: each live key (every
    key of a row with none live), and of those only the ones a dropout
    mask keeps.  Returns (all of them, those in rows with a live key)."""
    import torch

    k, key_len = args[1], args[-1]
    Tq, Tk = args[0].shape[1], k.shape[1]
    live = key_len.clamp(0, Tk)
    span = live.masked_fill(live == 0, Tk)
    col = torch.arange(Tk, device=k.device)
    reads = (col[None, None, :] < span[:, None, None]).expand(-1, Tq, -1)
    if dm is not None:
        reads = reads & (dm > 0)
    per_row = reads.sum(dim=(1, 2))
    return int(per_row.sum().item()), int(per_row[live > 0].sum().item())


def att_bound(mode, args, dtype_name, dm=None):
    """Least time: q (and tqw, t_q) read once; for each live key its k
    row (and rawk row, t_k) and its v row read once (all Tk v rows for a
    row with no live key); the gate params and the dropout mask once;
    the output written; 2d FLOPs per product per live (query, key) pair,
    the weighted sum's only for the pairs the mask keeps."""
    q, k, key_len = args[0], args[1], args[-1]
    B, Tq, d = q.shape
    Tk = k.shape[1]
    es = q.element_size()
    mode = mode.replace("_drop", "")
    live = key_len.clamp(0, Tk)
    n_live = int(live.sum().item())
    n_v = int(live.masked_fill(live == 0, Tk).sum().item())
    timed = mode != "plain"
    rows_q = (2 if mode == "time" else 1) * B * Tq * d * es
    keys = n_live * (d * es * (2 if mode == "time" else 1)
                     + (es if timed else 0))
    nbytes = (rows_q + (B * Tq * es if timed else 0) + keys + n_v * d * es
              + (5 * Tq * Tk * es if mode == "time" else 0) + B * 4
              + (B * Tq * Tk * 4 if dm is not None else 0)
              + B * Tq * d * 4)
    flops = (Tq * n_live * 2 * d * (2 if mode == "time" else 1)
             + weighted_pairs(args, dm)[0] * 2 * d)
    return _bound(nbytes, flops, dtype_name)


def att_library(torch, mode, args, g=None):
    """The one PyTorch call that computes a mode, where there is one:
    scaled_dot_product_attention takes the plain mode's key mask, and the
    tisas mode's interval bias, as an additive mask (built here, outside
    the timed call).  The time mode multiplies the scores by a gate inside
    the softmax, and the drop modes apply an injected mask after it,
    which no library call takes, so they have none.  With the cotangent
    ``g``: the forward and torch.autograd.grad of q, k and v ("fwd+bwd",
    since the backward kernel recomputes the forward too)."""
    if mode not in ("plain", "tisas"):
        return None
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, k, v, t_q, t_k, key_len = *args[:5], args[-1]
    d = q.shape[-1]
    col = torch.arange(k.shape[1], device=DEVICE)
    if mode == "tisas":
        bias = torch.log1p((t_q.float()[:, :, None]
                            - t_k.float()[:, None, :]).abs()) / math.sqrt(d)
    else:
        bias = torch.zeros(q.shape[0], q.shape[1], k.shape[1], device=DEVICE)
    bias = bias.masked_fill(col[None, None, :] >= key_len[:, None, None],
                            -(2.0 ** 32) + 1.0).to(q.dtype)
    if g is None:
        return lambda: sdpa(q, k, v, attn_mask=bias)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    cot = g.to(q.dtype)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves, attn_mask=bias), leaves, cot)
    return fwd_bwd


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _agree(got, want, dname, dead=None):
    """(max |diff|, max |diff| / max |want|, within the tolerance); outputs
    at `dead` positions must be exactly 0."""
    err, rel = rel_err(got, want)
    ok = bool(got.isfinite().all()) and rel <= KERNEL_TOL[dname]
    if dead is not None:
        ok = ok and not got[dead].any().item()
    return err, rel, ok


def check_tq1_attention(torch, ak, timer, iters, failures, gen, mode,
                        dtype):
    """fused_attention at Tq = 1 in one mode and dtype
    (`check_attention_fwd`) at B = 1, 16, 256 for each (Tk, d) of
    HOP_SHAPES, the hop design's, and at B = 1, 16, 64 (1, 16, 256 at Tk
    = 1024) for each of BLOCKED_SHAPES, the blocked design's; timed at B
    = 256, Tk=50, d=128 (MTAM's serving hops at L=50) and, in the plain,
    time and tisas modes, at BLOCKED_TIMED's shapes (d=128; MTAM's serving
    hops at L=150 and the plain-kind readout's longest), each design and
    the query design forced in turns (`time_attention_fwd`).  Returns
    {row key: row}: the row at Tk=50, d=128 under the dtype's name, at
    Tk=1024, d=128 under "<dtype>_tk1024", the others under
    "<dtype>_tk<Tk>_d<d>"."""
    from mtamrecommender_tpu_torch.ops import layers

    dname = str(dtype).replace("torch.", "")
    rows = {}
    for tk, d in HOP_SHAPES + BLOCKED_SHAPES:
        batches = (1, 16, 256) if tk <= ak.HOP_KEYS or tk == 1024 \
            else (1, 16, 64)
        fwd = {"err": 0.0, "rel": 0.0, "ok": True}
        for bs in batches:
            args = att_inputs(torch, gen, dtype, B=bs, Tk=tk, d=d)
            dm = (layers.draw_drop_mask(gen, bs, 1, tk, 0.5, DEVICE)
                  if mode.endswith("_drop") else None)
            fwd = check_attention_fwd(torch, ak, mode, args, dm, dname, fwd)
        design = ak.attention_fwd_design(dtype, 1, tk, d)
        row = {"max_abs_err": fwd["err"], "rel_err": fwd["rel"],
               "tol": KERNEL_TOL[dname], "ok": fwd["ok"], "design": design,
               "source": FWD_SOURCES[design], "Tk": tk, "d": d,
               "batches": list(batches),
               **{k: v for k, v in fwd.items()
                  if k not in ("err", "rel", "ok")}}
        # the last batch is the timed one (B=256 at Tk = 50 and 1024, 64
        # at Tk=150)
        timed = (tk, d) == (50, 128) or (
            d == 128 and tk in BLOCKED_TIMED and mode in SERVING_MODES)
        if timed:
            row.update(**time_attention_fwd(timer, ak, mode, args, dm,
                                            iters),
                       B=batches[-1],
                       plain_ms=timer(lambda: ak.fused_attention_plain(
                           mode, *args, dm), max(iters // 10, 3)),
                       **att_bound(mode, args, dname, dm))
            library = att_library(torch, mode, args)
            if library is not None:
                row["library_ms"] = timer(library, iters)
                row["library_max_abs_err"] = rel_err(
                    library(), ak.fused_attention_plain(mode, *args))[0]
            if design == "hop":
                row.update(hop_tol=TILE_FWD_TOL[dname],
                           **fwd_hop_occupancy(ak, mode, dname, tk, d))
            elif design == "blocked":
                row.update(blocked_tol=TILE_FWD_TOL[dname],
                           **fwd_blocked_occupancy(ak, mode, dname, tk, d))
        key = (dname if (tk, d) == (50, 128) else
               f"{dname}_tk{tk}" if (tk, d) == (1024, 128)
               else f"{dname}_tk{tk}_d{d}")
        rows[key] = row
        if timed or not fwd["ok"]:
            print(f"fused_attention {mode:10s} Tq=1 Tk={tk:<5d}d={d:<4d}"
                  f"{dname:9s} {design} max_abs_err={fwd['err']:.3e} "
                  f"rel={fwd['rel']:.3e} vs_query_rel="
                  f"{row.get(f'{design}_vs_query_rel_err')} same_bits="
                  f"{row.get('same_bits_twice')} B={row.get('B')} ms="
                  f"{row.get('ms')} device_ms={row.get('device_ms')} host_ms="
                  f"{row.get('host_ms')} query_ms={row.get('query_ms')} "
                  f"query_device_ms={row.get('query_device_ms')} "
                  f"query_host_ms={row.get('query_host_ms')} plain_ms="
                  f"{row.get('plain_ms')} bound_ms={row.get('bound_ms')} "
                  f"library_ms={row.get('library_ms')} smem_bytes="
                  f"{row.get('smem_bytes')} blocks_per_sm="
                  f"{row.get('blocks_per_sm')} "
                  f"{'ok' if fwd['ok'] else 'FAIL'}", flush=True)
        if not fwd["ok"]:
            failures.append(f"fused_attention {mode} Tq=1 Tk={tk} d={d} "
                            f"{dname}: {row}")
    for design in ("hop", "blocked"):
        took = [r for r in rows.values() if r["design"] == design]
        print(f"fused_attention {mode:10s} Tq=1 {dname:9s} {design} design "
              f"over {len(took)} shapes: worst rel "
              f"{max(r['rel_err'] for r in took):.3e}, vs query "
              f"{max(r[f'{design}_vs_query_rel_err'] for r in took):.3e}, "
              f"same bits {all(r['same_bits_twice'] for r in took)}",
              flush=True)
    return rows


def check_kernels(torch, timer, iters, failures):
    """Each kernel mode against its plain twin at the request batches of
    the slice (B = 1, 16, 256); timed at B = 256."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in gk.MODES:
            err = rel = column_rel = 0.0
            ok = same = True
            for bs in (1, 16, 256):
                args = gru_inputs(torch, gen, mode, dtype, B=bs)
                e, r, o, sm, cr = check_gru_fwd(torch, gk, mode, args, dname)
                err, rel, column_rel = (max(err, e), max(rel, r),
                                        max(column_rel, cr))
                ok, same = ok and o, same and sm
            row = {"max_abs_err": err, "rel_err": rel,
                   "unit_column_rel_err": column_rel,
                   "same_bits_twice": same, "tol": KERNEL_TOL[dname],
                   "ok": ok, **time_gru_fwd(timer, gk, mode, args, iters),
                   "plain_ms": timer(lambda: gk.gru_scan_plain(mode, *args),
                                     max(iters // 10, 3)),
                   **gru_bound(mode, args, dname)}
            entries.setdefault(("gru_scan", mode, None), {})[dname] = row
            print(f"gru_scan {mode:8s} {dname:9s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (unit_column {column_rel:.3e}) same_bits="
                  f"{same} ms={row['ms']:.4f} unit_column_ms="
                  f"{row['unit_column_ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"gru_scan {mode} {dname}: rel err {rel:.3e}, "
                                f"unit_column {column_rel:.3e}, same bits "
                                f"{same}")
        for mode in ak.MODES:
            entries.setdefault(("fused_attention", mode, "Tq1"), {}).update(
                check_tq1_attention(torch, ak, timer, iters, failures, gen,
                                    mode, dtype))
    return entries


# ------------------------------------------------------------ phase 3

SERVING_META = (6040, 3706, 18, 50)      # the ml-1m catalog, L=50


def serve_mtam(torch, iters, failures, meta, overrides, batches, want, tag,
               turns_batch=None):
    """Recommender.recommend for MTAM at full width (d=128, 3 hops, 1 head,
    k=50; ``overrides`` on the config) for each request batch size in
    ``batches``, in bf16 and f32 compute: the launches of one call,
    counted from 0, against ``want``; the scores against the same
    Recommender on the CPU (the plain twins) over the catalog's columns;
    the time per request batch; at ``turns_batch`` also the scoring
    call's event ms and device busy ms in turns with the attention
    forward forced to its query design (`forced_design`; hop, query,
    query, hop), launches not counted.  Returns (rows, the calls'
    launches)."""
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.models.mtam import init_mtam
    from mtamrecommender_tpu_torch.serve import Recommender

    rows, launches = [], {}
    vocab = meta.item_vocab
    for dname in ("bfloat16", "float32"):
        cfg = ExperimentConfig().with_overrides(**{
            "model.experiment_type": "MTAM", "model.num_units": 128,
            "model.num_blocks": 3, "model.num_heads": 1,
            "model.dropout": 0.0, "model.use_pallas": True,
            "model.pallas_scope": "all", "model.compute_dtype": dname,
            "data.max_seq_len": meta.max_seq_len, **overrides})
        model = init_mtam(torch.Generator().manual_seed(0), cfg.model, meta)
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        for bs in batches:
            hists, req = make_histories(np.random.RandomState(bs), bs,
                                        meta.item_count, meta.category_count,
                                        meta.max_seq_len)
            if bs > 1:
                hists[1] = []                  # an empty history
            # --- the main path: counts from 0 around one recommend call
            _reset_counts()
            recs = rec.recommend(hists, req, k=50)
            torch.cuda.synchronize()
            got = _counts()
            _add_launches(launches, got)
            launches_ok = got == want
            shape_ok = len(recs) == bs and all(len(r) == 50 for r in recs) \
                and all(math.isfinite(s) for r in recs for _, s in r)
            # --- scores against the CPU plain path
            batch = rec.batch_from_histories(hists, req)
            batch_cpu = rec_cpu.batch_from_histories(hists, req)
            with torch.no_grad():
                s_gpu = scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                        batch, vocab).cpu()
                s_cpu = scores_for_eval(rec_cpu.model_def, rec_cpu._model_c,
                                        cfg.model, batch_cpu, vocab)
            finite = bool(torch.isfinite(s_gpu).all())
            # a padded table's columns past the catalog hold -2^32+1
            err, rel = rel_err(s_gpu[:, :vocab], s_cpu[:, :vocab])
            tol_abs = SLICE_TOL[dname] * s_cpu[:, :vocab].abs().max().item()
            top_gpu = torch.topk(s_gpu, 50, dim=1).indices
            kth_cpu = torch.topk(s_cpu, 50, dim=1).values[:, -1:]
            # an id only the card ranks in the top 50 must score within the
            # tolerance of the CPU's 50th score
            picked = torch.gather(s_cpu, 1, top_gpu)
            topk_ok = bool((picked >= kth_cpu - tol_abs).all())
            ok = (launches_ok and shape_ok and finite and topk_ok
                  and rel <= SLICE_TOL[dname])
            # --- time per request batch
            recommend_ms = _host_ms(torch, lambda: rec.recommend(
                hists, req, k=50), iters)
            fetch = min(50 + meta.max_seq_len, vocab)
            score_ms = _event_ms(torch, lambda: rec._score_impl(batch, fetch),
                                 iters)
            busy = _device_busy(torch, lambda: rec._score_impl(batch, fetch))
            if bs == turns_batch:
                score = lambda: rec._score_impl(batch, fetch)  # noqa: E731
                turns = []
                for turn in ("hop", "query", "query", "hop"):
                    with (forced_design("fused_attention") if turn == "query"
                          else contextlib.nullcontext()):
                        turns.append({
                            "fused_attention": turn,
                            "score_topk_ms": _event_ms(torch, score, iters),
                            "device_busy_ms": _device_busy(
                                torch, score)["device_busy_ms"]})
                print(f"{tag} {dname:9s} B={bs} in turns (fused_attention "
                      "hop, query, query, hop): score_topk_ms="
                      f"{[t['score_topk_ms'] for t in turns]} device_busy_ms="
                      f"{[t['device_busy_ms'] for t in turns]}", flush=True)
            row = {"compute_dtype": dname, "batch": bs, "k": 50,
                   "seq_len": meta.max_seq_len,
                   "launches_per_call": got, "launches_ok": launches_ok,
                   "max_abs_score_err": err, "rel_score_err": rel,
                   "tol": SLICE_TOL[dname], "topk_ok": topk_ok,
                   "recommend_ms": recommend_ms, "score_topk_ms": score_ms,
                   **busy, "idle_share": (None if busy["device_busy_ms"] is None
                                          else 1 - busy["device_busy_ms"]
                                          / score_ms),
                   **({"attention_fwd_in_turns": turns}
                      if bs == turns_batch else {}),
                   "ok": ok}
            rows.append(row)
            fired = {k: {m: n for m, n in v.items() if n}
                     for k, v in got.items()}
            print(f"{tag} {dname:9s} B={bs:<4d} L={meta.max_seq_len} "
                  f"launches={ {k: v for k, v in fired.items() if v} } "
                  f"max_abs_score_err={err:.3e} rel={rel:.3e} "
                  f"topk_ok={topk_ok} recommend_ms={recommend_ms:.3f} "
                  f"score_topk_ms={score_ms:.3f} device_busy_ms="
                  f"{busy['device_busy_ms']} {'ok' if ok else 'FAIL'}",
                  flush=True)
            for name, ms in busy["top_kernels"]:
                print(f"    {ms:9.4f} ms  {name[:90]}", flush=True)
            if not ok:
                failures.append(f"{tag} {dname} B={bs}: {row}")
    return rows, launches


def run_slice(torch, iters, failures, num_units=128):
    """Phase 3: MTAM serving at L=50 (1 gru_scan + 3 fused_attention[time]
    launches a call in the hop design, none in the query design, no
    fused_readout), at B = 256 also in turns with the query design forced;
    at ``num_units`` 16 (the width __graft_entry__.py's smoke trains MTAM
    at, which the GRU pair is not built for) for B=16 only."""
    from mtamrecommender_tpu_torch.types import DatasetMeta

    want = _want_counts(0)
    want["gru_scan"]["tgru"] = 1
    # the hops: Tq = 1, Tk = 50, the forward's hop design (d = 128 and 16)
    want["fused_attention"]["time"] = 3
    want["fused_attention_hop"]["time"] = 3
    if num_units != 128:
        return serve_mtam(torch, iters, failures, DatasetMeta(*SERVING_META),
                          {"model.num_units": num_units}, (16,), want,
                          f"slice u={num_units}")
    return serve_mtam(torch, iters, failures, DatasetMeta(*SERVING_META), {},
                      (1, 16, 256), want, "slice", turns_batch=256)


def _host_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _device_busy(torch, fn):
    """Device time of one call, summed over its kernels, from
    torch.profiler; None where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3)
               for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    kernels = sorted((k for k in kernels if k[1] > 0), key=lambda k: -k[1])
    total = sum(ms for _, ms in kernels)
    return {"device_busy_ms": total if total > 0 else None,
            "top_kernels": kernels[:8]}


def _event_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 2b

def gru_bwd_bound(mode, args, dtype_name):
    """Least time for the backward these inputs need: for each alive step
    g, h_prev and the step's inputs read once; h0 and the weights once;
    every cotangent written once; 18*u^2 FLOPs per alive step (the
    recomputed forward 6u^2, dh's two products 6u^2, the weight
    gradients 6u^2)."""
    gx, lengths = args[0], args[4]
    B, L, u2 = gx.shape
    u = u2 // 2
    es = gx.element_size()
    steps = int(lengths.clamp(0, L).sum().item())
    per_step = 8 * u + (2 * u + u + (0 if mode == "plain" else 2 * u)) * es
    nbytes = (steps * per_step + B * 4 + B * u * es + 3 * u * u * es
              + 7 * u * es + B * L * 5 * u * 4 + B * u * 4
              + (3 * u * u + 7 * u) * 4)
    return _bound(nbytes, steps * 18 * u * u, dtype_name)


def dtable_bound(ct, ids, vocab):
    """ct and ids read once, the table written once; one f32 add per
    element of ct, at the f32 rate."""
    n, d = ct.shape
    nbytes = n * d * ct.element_size() + 4 * n + vocab * d * ct.element_size()
    return _bound(nbytes, n * d, "float32")


def check_gru_bwd(torch, gk, mode, g, outs, args, dname):
    """gru_scan_bwd on the card against its twin: the default design
    (two launches, the same bits twice) and the four-product design
    forced, all ten outputs within KERNEL_TOL of the twin.  Returns
    (max |diff|, max rel, ok, same bits twice, the forced design's max
    rel)."""
    want = gk.gru_scan_bwd_plain(mode, g, outs, *args)
    got = gk.gru_scan_bwd(mode, g, outs, *args)
    again = gk.gru_scan_bwd(mode, g, outs, *args)
    four = gk._launch_bwd(mode, g, outs, *args, _design="four_product")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    err = rel = four_rel = 0.0
    ok = same
    for a, f, w in zip(got, four, want):
        e, r, o = _agree(a, w, dname)
        _, fr, fo = _agree(f, w, dname)
        err, rel, four_rel = max(err, e), max(rel, r), max(four_rel, fr)
        ok = ok and o and fo
    return err, rel, ok, same, four_rel


def time_gru_bwd(timer, gk, mode, g, outs, args, iters):
    """The default design and the four-product design on the same
    inputs, in turns (default, four, four, default), and the profiler's
    split of the default design's device time among its kernels."""
    run = lambda: gk.gru_scan_bwd(mode, g, outs, *args)  # noqa: E731
    four = lambda: gk._launch_bwd(  # noqa: E731
        mode, g, outs, *args, _design="four_product")
    a, b1, b2, a2 = (timer(run, iters), timer(four, iters),
                     timer(four, iters), timer(run, iters))
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "four_product_ms": (b1 + b2) / 2,
            "four_product_ms_repeats": [b1, b2],
            "passes_ms": timer.passes(run)}


def check_train_kernels(torch, timer, iters, failures, tables):
    """The training step's two new kernels against their plain twins:
    gru_scan_bwd in each mode at B = 1, 16, 256, and dtable at the step's
    four table shapes with ids from a gathered batch (``tables``: name ->
    (ids, vocab)); timed at B = 256."""
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in gk.MODES:
            err = rel = four_rel = 0.0
            ok = same = True
            for bs in (1, 16, 256):
                args = gru_inputs(torch, gen, mode, dtype, B=bs)
                if bs == 1:
                    args[4].fill_(args[0].shape[1])   # one full-length row
                with torch.no_grad():
                    outs = gk.gru_scan(mode, *args)
                g = torch.randn(outs.shape, generator=gen, device=DEVICE)
                e, r, o, sm, fr = check_gru_bwd(torch, gk, mode, g, outs,
                                                args, dname)
                err, rel, four_rel = max(err, e), max(rel, r), max(four_rel,
                                                                   fr)
                ok, same = ok and o, same and sm
            row = {"max_abs_err": err, "rel_err": rel,
                   "four_product_rel_err": four_rel, "same_bits_twice": same,
                   "tol": KERNEL_TOL[dname], "ok": ok,
                   **time_gru_bwd(timer, gk, mode, g, outs, args, iters),
                   "plain_ms": timer(
                       lambda: gk.gru_scan_bwd_plain(mode, g, outs, *args),
                       max(iters // 10, 3)),
                   **gru_bwd_bound(mode, args, dname)}
            entries.setdefault(("gru_scan_bwd", mode, None), {})[dname] = row
            print(f"gru_scan_bwd {mode:8s} {dname:9s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (four_product {four_rel:.3e}) same_bits="
                  f"{same} ms={row['ms']:.4f} four_product_ms="
                  f"{row['four_product_ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) passes={row['passes_ms']} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"gru_scan_bwd {mode} {dname}: rel err "
                                f"{rel:.3e}, four_product {four_rel:.3e}, "
                                f"same bits {same}")
        entries.setdefault(("dtable", None, None), {})[dname] = check_dtable(
            torch, timer, iters, failures, gen, dtype, tables, "L=50")
    return entries


def dtable_row0(torch, ct, ids, vocab, got):
    """Row 0 of an f32 table gradient (the padding id's, the hottest row)
    against an f64 index_add_ of the same cotangents on the card: the
    kernel's error (``got``, its output) and the CPU's f32 index_add_'s,
    each as max |diff| over row 0 and over row 0's largest |value|.  Then
    the same with every cotangent at id 0 one vector, as the step's L2
    term gives the padded positions (each the same 2 * lambda * row)."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    ids64 = ids.long()
    out = {"n_ids": int((ids == 0).sum().item())}
    same = ct.clone()
    same[ids == 0] = ct[0]
    for tag, c, kernel in (("random", ct, got),
                           ("one_vector", same, ek.dtable(same, ids, vocab))):
        ref = torch.zeros((vocab, c.shape[1]), dtype=torch.float64,
                          device=DEVICE).index_add_(0, ids64, c.double())[0]
        cpu = torch.zeros((vocab, c.shape[1])).index_add_(
            0, ids64.cpu(), c.cpu())[0].double().to(DEVICE)
        scale = max(ref.abs().max().item(), 1e-300)
        for who, row in (("kernel", kernel[0].double()), ("cpu_f32", cpu)):
            err = (row - ref).abs().max().item()
            out[f"{tag}_{who}_abs_err"] = err
            out[f"{tag}_{who}_rel_err"] = err / scale
    return out


def check_dtable(torch, timer, iters, failures, gen, dtype, tables, tag):
    """dtable against its plain twin (and index_add_ timed beside it) on
    each of a step's four tables with its ids (``tables``: name -> (ids,
    padded vocab)) and a random cotangent; two launches must give the
    same bits.  Each table's row has the event-timed ms of the kernel and
    of index_add_ (torch.zeros + index_add_, ``library_ms``), their
    device time from the profiler (``device_ms``, ``library_device_ms``:
    kernel time per call, the flush left out) and their host time per
    call (``host_ms``, ``library_host_ms``), which tell the host's launch
    cost from the device's work.  Returns the entry row, headed by the
    item table."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    dname = str(dtype).replace("torch.", "")
    shapes = {}
    for table, (ids, vocab) in tables.items():
        ct = torch.randn((ids.shape[0], 128), generator=gen,
                         device=DEVICE).to(dtype)
        got = ek.dtable(ct, ids, vocab)
        want = ek.dtable_plain(ct, ids, vocab)
        err, rel, ok = _agree(got, want, dname)
        again = ek.dtable(ct, ids, vocab)
        ok = ok and bool(torch.equal(got, again))   # same bits each run
        ids64 = ids.long()
        run = lambda: ek.dtable(ct, ids, vocab)  # noqa: E731
        library = lambda: torch.zeros(  # noqa: E731
            (vocab, 128), dtype=dtype, device=DEVICE).index_add_(
                0, ids64, ct)
        shapes[table] = {
            "n": int(ids.shape[0]), "vocab": vocab,
            "chunk": ek.dtable_plan(*ct.shape, vocab)[0],
            "max_abs_err": err, "rel_err": rel, "ok": ok,
            "ms": timer(run, iters),
            "plain_ms": timer(lambda: ek.dtable_plain(ct, ids, vocab),
                              iters),
            "library_ms": timer(library, iters),
            "device_ms": timer.device(run),
            "library_device_ms": timer.device(library),
            "host_ms": timer.host(run),
            "library_host_ms": timer.host(library),
            **dtable_bound(ct, ids, vocab)}
        r = shapes[table]
        if dtype == torch.float32:
            r["row0_f64"] = dtable_row0(torch, ct, ids, vocab, got)
        print(f"dtable {tag} {table:11s} n={r['n']:<6d} V={vocab:<5d} "
              f"{dname:9s} max_abs_err={err:.3e} rel={rel:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"index_add_ms={r['library_ms']:.4f} device_ms="
              f"{r['device_ms']} index_add_device_ms="
              f"{r['library_device_ms']} host_ms={r['host_ms']:.4f} "
              f"index_add_host_ms={r['library_host_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if "row0_f64" in r:
            print(f"    row 0 (padding id, {r['row0_f64']['n_ids']} ids) vs "
                  f"f64: {r['row0_f64']}", flush=True)
        if not ok:
            failures.append(f"dtable {tag} {table} {dname}: rel err "
                            f"{rel:.3e} or not reproducible")
    head = shapes["item_table"]
    return {**{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "device_ms", "library_device_ms",
                                    "bound_ms", "bound_by")},
            "library_call": "index_add_",
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "rel_err": max(r["rel_err"] for r in shapes.values()),
            "tol": KERNEL_TOL[dname],
            "ok": all(r["ok"] for r in shapes.values()), "by_table": shapes}


# ------------------------------------------------------------ phase 2c

def att_bwd_bound(mode, args, dm, dtype_name):
    """Least time for the backward these inputs need: g, q (and tqw, t_q)
    read once; for each live key its k and v rows (and rawk row, t_k);
    the gate params, key_len and the mask once; the f32 outputs written
    once: dq, dk and dv, and in time mode dtqw, drawk and the five gate
    gradients (the output depends on those inputs in time mode only).
    2d FLOPs per product per live (query, key) pair:
    the recomputed QK^T (and tqw.rawk in time mode), dq and dk (and dtqw,
    drawk in time mode); dv and g V^T only for the pairs the weighted
    sum reads (`weighted_pairs`: a row with no live key needs only dv,
    and a dropped pair neither)."""
    q, k, key_len = args[0], args[1], args[-1]
    B, Tq, d = q.shape
    Tk = k.shape[1]
    es = q.element_size()
    base = mode.replace("_drop", "")
    n_live = int(key_len.clamp(0, Tk).sum().item())
    timed = base != "plain"
    time_mode = base == "time"
    nbytes = (B * Tq * d * 4                                  # g
              + B * Tq * d * es * (2 if time_mode else 1)     # q, tqw
              + (B * Tq * es if timed else 0)                 # t_q
              + n_live * (d * es * (3 if time_mode else 2)
                          + (es if timed else 0))             # k, v, rawk, t_k
              + (5 * Tq * Tk * es if time_mode else 0) + B * 4
              + (B * Tq * Tk * 4 if dm is not None else 0)
              + B * Tq * d * 4 * (2 if time_mode else 1)       # dq, dtqw
              + B * Tk * d * 4 * (3 if time_mode else 2)       # dk, dv, drawk
              + (5 * Tq * Tk * 4 if time_mode else 0))         # gate grads
    products = (2 if time_mode else 1) + 2 + (2 if time_mode else 0)
    # dv over every read pair; g V^T over the read pairs of live rows
    reads, live_reads = weighted_pairs(args, dm)
    flops = 2 * d * (Tq * n_live * products + reads + live_reads)
    return _bound(nbytes, flops, dtype_name)


def check_attention_bwd(torch, ak, mode, g, args, dm, dname, acc):
    """fused_attention_bwd on the card against its twin: the design the
    wrapper picks (two launches, the same bits twice) and, where that is
    the tile design, the rows design forced (two launches, the same bits
    twice), each within KERNEL_TOL of the twin, and the tile design
    against the rows design; in time mode at B = 256, the tile design
    with its gate sums in chunks of 128 rows, the same bits as one chunk.
    Folds the worst of them into ``acc``."""
    got = ak.fused_attention_bwd(mode, g, *args, dm)
    again = ak.fused_attention_bwd(mode, g, *args, dm)
    want = ak.fused_attention_bwd_plain(mode, g, *args, dm)
    # outside time mode dtqw, drawk and the gate gradients are None, on
    # the card and in the twin
    outputs = 10 if mode == "time" else 3
    runs = [got, again, want]
    tile = ak.attention_bwd_design(args[0].dtype, args[0].shape[1],
                                   args[1].shape[1], args[0].shape[2]) \
        == "tile"
    if tile:
        rows = ak._launch_bwd(mode, g, *args, dm, _design="rows")
        rows_again = ak._launch_bwd(mode, g, *args, dm, _design="rows")
        runs += [rows, rows_again]
    shaped = all([t is not None for t in outs]
                 == [i < outputs for i in range(10)] for outs in runs)
    same = shaped and all(torch.equal(a, b)
                          for a, b in zip(got[:outputs], again[:outputs]))
    out = dict(acc)
    out["ok"] = out["ok"] and shaped
    for a, b in zip(got[:outputs], want[:outputs]):
        e, r, o = _agree(a, b, dname)
        out.update(err=max(out["err"], e), rel=max(out["rel"], r),
                   ok=out["ok"] and o)
    if tile:
        same_rows = all(torch.equal(a, b) for a, b in
                        zip(rows[:outputs], rows_again[:outputs]))
        rows_rel = tile_rows_rel = 0.0
        for a, r, w in zip(got[:outputs], rows[:outputs], want[:outputs]):
            _, x, o1 = _agree(r, w, dname)
            _, y, o2 = _agree(a, r, dname)
            rows_rel, tile_rows_rel = max(rows_rel, x), max(tile_rows_rel, y)
            out["ok"] = out["ok"] and o1 and o2
        out["rows_rel_err"] = max(out.get("rows_rel_err", 0.0), rows_rel)
        out["tile_vs_rows_rel_err"] = max(out.get("tile_vs_rows_rel_err",
                                                  0.0), tile_rows_rel)
        out["rows_same_bits_twice"] = (out.get("rows_same_bits_twice", True)
                                       and same_rows)
        out["ok"] = out["ok"] and same_rows
        if mode == "time" and args[0].shape[0] == 256:
            chunked = ak._launch_bwd(mode, g, *args, dm, _chunk_rows=128)
            out["chunked_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(got, chunked))
            out["ok"] = out["ok"] and out["chunked_same_bits"]
    out["same"] = same
    return out


def time_attention_bwd(timer, ak, mode, g, args, dm, iters):
    """The backward's time: where the wrapper picks the tile design, it
    and the rows design forced on the same inputs in turns (tile, rows,
    rows, tile), with the profiler's device time of each by launch."""
    run = lambda: ak.fused_attention_bwd(mode, g, *args, dm)  # noqa: E731
    if ak.attention_bwd_design(args[0].dtype, args[0].shape[1],
                               args[1].shape[1], args[0].shape[2]) != "tile":
        return {"ms": timer(run, iters)}
    rows = lambda: ak._launch_bwd(  # noqa: E731
        mode, g, *args, dm, _design="rows")
    a, b1, b2, a2 = (timer(run, iters), timer(rows, iters),
                     timer(rows, iters), timer(run, iters))
    passes, rows_passes = timer.passes(run), timer.passes(rows)
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "rows_ms": (b1 + b2) / 2, "rows_ms_repeats": [b1, b2],
            "passes_ms": passes, "rows_passes_ms": rows_passes,
            "device_ms": sum(passes.values()) if passes else None,
            "rows_device_ms": (sum(rows_passes.values()) if rows_passes
                               else None),
            "host_ms": timer.host(run)}


def check_attention_fwd(torch, ak, mode, args, dm, dname, acc):
    """fused_attention on the card against its twin, within KERNEL_TOL, in
    the design the wrapper picks; where that is not the query design,
    also two launches the same bits, and within TILE_FWD_TOL of the query
    design forced (itself within KERNEL_TOL of the twin), the tile design
    also within TILE_FWD_TOL of the twin.  Folds the worst of
    them into ``acc`` (keys "<design>_rel_err", "<design>_vs_query_rel_err",
    "query_rel_err", "same_bits_twice")."""
    got = ak.fused_attention(mode, *args, dm)
    want = ak.fused_attention_plain(mode, *args, dm)
    e, r, o = _agree(got, want, dname)
    out = dict(acc, err=max(acc["err"], e), rel=max(acc["rel"], r),
               ok=acc["ok"] and o)
    q, k = args[0], args[1]
    design = ak.attention_fwd_design(q.dtype, q.shape[1], k.shape[1],
                                     q.shape[2])
    if design == "query":
        return out
    again = ak.fused_attention(mode, *args, dm)
    query = ak._launch(mode, *args, dm, _design="query")
    _, query_rel, query_ok = _agree(query, want, dname)
    design_rel = rel_err(got, want)[1]
    vs_query_rel = rel_err(got, query)[1]
    same = torch.equal(got, again)
    for key, x in ((f"{design}_rel_err", design_rel),
                   (f"{design}_vs_query_rel_err", vs_query_rel),
                   ("query_rel_err", query_rel)):
        out[key] = max(out.get(key, 0.0), x)
    out["same_bits_twice"] = out.get("same_bits_twice", True) and same
    out["ok"] = (out["ok"] and same and query_ok
                 and vs_query_rel <= TILE_FWD_TOL[dname]
                 and (design != "tile"
                      or design_rel <= TILE_FWD_TOL[dname]))
    return out


def time_attention_fwd(timer, ak, mode, args, dm, iters):
    """The forward's time: where the wrapper picks the tile, hop, blocked
    or wide design, it and the query design (forced, `forced_design`)
    through the same entry point on the same inputs in turns (picked,
    query, query, picked), by CUDA events and by the profiler's device
    time, with each one's host time a call."""
    run = lambda: ak.fused_attention(mode, *args, dm)  # noqa: E731
    q, k = args[0], args[1]
    if ak.attention_fwd_design(q.dtype, q.shape[1], k.shape[1],
                               q.shape[2]) == "query":
        return {"ms": timer(run, iters)}

    def query(measure):
        with forced_design("fused_attention"):
            return measure(run)

    a, b1, b2, a2 = (timer(run, iters), query(lambda f: timer(f, iters)),
                     query(lambda f: timer(f, iters)), timer(run, iters))
    d, e1, e2, d2 = (timer.device(run), query(timer.device),
                     query(timer.device), timer.device(run))
    mean = lambda x, y: None if None in (x, y) else (x + y) / 2  # noqa: E731
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "query_ms": (b1 + b2) / 2, "query_ms_repeats": [b1, b2],
            "device_ms": mean(d, d2), "device_ms_repeats": [d, d2],
            "query_device_ms": mean(e1, e2),
            "query_device_ms_repeats": [e1, e2],
            "host_ms": timer.host(run), "query_host_ms": query(timer.host)}


def fwd_tile_occupancy(ak, mode, dtype, d=128):
    """The forward tile design's shared memory a block (bytes) and blocks
    an SM (the occupancy calculator's) for a mode and dtype at width d."""
    lib = ak._tile_library()
    mode_id, is_bf16 = ak.MODES.index(mode), int(dtype == "bfloat16")
    return {"smem_bytes": lib.fused_attention_tile_smem_bytes(
                mode_id, is_bf16, d),
            "blocks_per_sm": lib.fused_attention_tile_blocks_per_sm(
                mode_id, is_bf16, d, 0)}


def fwd_hop_occupancy(ak, mode, dtype, tk=50, d=128):
    """The forward hop design's shared memory a block (bytes) and blocks
    an SM (the occupancy calculator's) for a mode and dtype at (Tk, d)."""
    lib = ak._hop_library()
    mode_id, is_bf16 = ak.MODES.index(mode), int(dtype == "bfloat16")
    return {"smem_bytes": lib.fused_attention_hop_smem_bytes(
                mode_id, is_bf16, tk, d),
            "blocks_per_sm": lib.fused_attention_hop_blocks_per_sm(
                mode_id, is_bf16, tk, d, 0)}


def fwd_blocked_occupancy(ak, mode, dtype, tk=150, d=128):
    """The forward blocked design's shared memory a block (bytes) and
    blocks an SM (the occupancy calculator's) for a mode and dtype at (Tk,
    d)."""
    lib = ak._blocked_library()
    mode_id, is_bf16 = ak.MODES.index(mode), int(dtype == "bfloat16")
    return {"smem_bytes": lib.fused_attention_blocked_smem_bytes(
                mode_id, is_bf16, tk, d),
            "blocks_per_sm": lib.fused_attention_blocked_blocks_per_sm(
                mode_id, is_bf16, tk, d, 0)}


def check_attention_training(torch, timer, iters, failures):
    """The self-attention training kernels against their plain twins:
    the forward's drop modes and its other modes at Tq = Tk = 50, the
    backward in every mode, at B = 1, 16, 256 and at Tq = 1, Tk = 1024;
    two backward launches must give the same bits; at Tq = Tk = 50 the
    forward's tile design also against its query design forced
    (`check_attention_fwd`) and the backward's tile design against its
    rows design forced (`check_attention_bwd`); timed at B = 256, each
    one's two designs in turns (`time_attention_fwd`,
    `time_attention_bwd`)."""
    from mtamrecommender_tpu_torch.ops import layers
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(2468)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in ak.MODES:
            drop = mode.endswith("_drop")
            for tq, tk in ((50, 50), (1, 1024)):
                check_fwd = drop or tq > 1     # phase 2 holds Tq = 1
                fwd = {"err": 0.0, "rel": 0.0, "ok": True}
                bwd = {"err": 0.0, "rel": 0.0, "ok": True}
                same = True
                for bs in (1, 16, 256):
                    args = att_inputs(torch, gen, dtype, B=bs, Tq=tq, Tk=tk)
                    dm = (layers.draw_drop_mask(gen, bs, tq, tk, 0.5, DEVICE)
                          if drop else None)
                    if check_fwd:
                        fwd = check_attention_fwd(torch, ak, mode, args, dm,
                                                  dname, fwd)
                    g = torch.randn(args[0].shape, generator=gen,
                                    device=DEVICE)
                    bwd = check_attention_bwd(torch, ak, mode, g, args, dm,
                                              dname, bwd)
                    same = same and bwd.pop("same")
                key = dname if tq > 1 else f"{dname}_tq1_tk1024"
                tag = f"Tq={tq} Tk={tk}"
                if check_fwd:
                    design = ak.attention_fwd_design(dtype, tq, tk, 128)
                    row = {"max_abs_err": fwd["err"], "rel_err": fwd["rel"],
                           "tol": KERNEL_TOL[dname], "ok": fwd["ok"],
                           "design": design,
                           **{k: v for k, v in fwd.items()
                              if k not in ("err", "rel", "ok")},
                           **time_attention_fwd(timer, ak, mode, args, dm,
                                                iters),
                           "plain_ms": timer(lambda: ak.fused_attention_plain(
                               mode, *args, dm), max(iters // 10, 3)),
                           **att_bound(mode, args, dname, dm)}
                    if design == "tile":
                        row.update(source=FWD_TILE_SOURCE,
                                   tile_tol=TILE_FWD_TOL[dname],
                                   **fwd_tile_occupancy(ak, mode, dname))
                    elif design == "blocked":
                        row.update(source=FWD_SOURCES[design],
                                   blocked_tol=TILE_FWD_TOL[dname],
                                   **fwd_blocked_occupancy(ak, mode, dname,
                                                           tk))
                    library = att_library(torch, mode, args)
                    if library is not None:
                        row["library_ms"] = timer(library, iters)
                    entries.setdefault(("fused_attention", mode, "Tq50"),
                                       {})[key] = row
                    print(f"fused_attention {mode:10s} {tag:15s} {dname:9s} "
                          f"{design} max_abs_err={fwd['err']:.3e} "
                          f"rel={fwd['rel']:.3e} tile_rel="
                          f"{row.get('tile_rel_err')} tile_vs_query_rel="
                          f"{row.get('tile_vs_query_rel_err')} same_bits="
                          f"{row.get('same_bits_twice')} ms={row['ms']:.4f} "
                          f"device_ms={row.get('device_ms')} query_ms="
                          f"{row.get('query_ms')} query_device_ms="
                          f"{row.get('query_device_ms')} host_ms="
                          f"{row.get('host_ms')} plain_ms="
                          f"{row['plain_ms']:.4f} bound_ms="
                          f"{row['bound_ms']:.4f} library_ms="
                          f"{row.get('library_ms')} smem_bytes="
                          f"{row.get('smem_bytes')} blocks_per_sm="
                          f"{row.get('blocks_per_sm')} "
                          f"{'ok' if fwd['ok'] else 'FAIL'}", flush=True)
                    if not fwd["ok"]:
                        tile = {k: v for k, v in fwd.items()
                                if k.endswith(("rel_err", "twice"))}
                        failures.append(f"fused_attention {mode} {tag} "
                                        f"{dname}: rel err {fwd['rel']:.3e}, "
                                        f"tile design {tile}")
                row = {"max_abs_err": bwd["err"], "rel_err": bwd["rel"],
                       "tol": KERNEL_TOL[dname], "ok": bwd["ok"] and same,
                       "same_bits_twice": same,
                       "design": ak.attention_bwd_design(dtype, tq, tk, 128),
                       **{k: v for k, v in bwd.items()
                          if k not in ("err", "rel", "ok")},
                       **time_attention_bwd(timer, ak, mode, g, args, dm,
                                            iters),
                       "plain_ms": timer(lambda: ak.fused_attention_bwd_plain(
                           mode, g, *args, dm), max(iters // 10, 3)),
                       **att_bwd_bound(mode, args, dm, dname)}
                library = att_library(torch, mode, args, g)
                if library is not None:
                    row["library_ms"] = timer(library, iters)
                    row["library_call"] = ("scaled_dot_product_attention "
                                           "fwd+bwd")
                entries.setdefault(("fused_attention_bwd", mode, "Tq50"),
                                   {})[key] = row
                print(f"fused_attention_bwd {mode:10s} {tag:15s} {dname:9s} "
                      f"{row['design']} max_abs_err={bwd['err']:.3e} "
                      f"rel={bwd['rel']:.3e} same_bits={same} ms="
                      f"{row['ms']:.4f} device_ms={row.get('device_ms')} "
                      f"rows_ms={row.get('rows_ms')} rows_device_ms="
                      f"{row.get('rows_device_ms')} plain_ms="
                      f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                      f"({row['bound_by']}) library_ms="
                      f"{row.get('library_ms')} "
                      f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
                for what in ("passes_ms", "rows_passes_ms"):
                    if what in row:
                        print(f"    {what}: {json.dumps(row[what])}",
                              flush=True)
                if not row["ok"]:
                    failures.append(f"fused_attention_bwd {mode} {tag} "
                                    f"{dname}: rel err {bwd['rel']:.3e}, "
                                    f"same bits {same}")
    return entries


def check_wide_pair(torch, ak, mode, args, dm, g, dname, acc):
    """Both wide kernels on one input (`attention_fwd_design` and
    `attention_bwd_design` give "wide"): two launches of each, the same
    bits; each within TILE_FWD_TOL of its design-shaped twin
    (`_wide_fwd_design_plain`, `_wide_design_plain`) and within
    KERNEL_TOL of its plain twin; finite.  Folds the worst into ``acc``
    {"fwd": {...}, "bwd": {...}}."""
    q, k = args[0], args[1]
    shape = (q.dtype, q.shape[1], k.shape[1], q.shape[2])
    picked = (ak.attention_fwd_design(*shape), ak.attention_bwd_design(*shape))
    out = {kind: dict(acc[kind]) for kind in ("fwd", "bwd")}
    got = ak.fused_attention(mode, *args, dm)
    again = ak.fused_attention(mode, *args, dm)
    grads = ak.fused_attention_bwd(mode, g, *args, dm)
    grads2 = ak.fused_attention_bwd(mode, g, *args, dm)
    n = 10 if mode == "time" else 3
    runs = {"fwd": ([got], [again], [ak._wide_fwd_design_plain(mode, *args,
                                                               dm)],
                    [ak.fused_attention_plain(mode, *args, dm)]),
            "bwd": (grads[:n], grads2[:n],
                    ak._wide_design_plain(mode, g, *args, dm)[:n],
                    ak.fused_attention_bwd_plain(mode, g, *args, dm)[:n])}
    for kind, (first, second, twin, plain) in runs.items():
        o = out[kind]
        for a, b, t, p in zip(first, second, twin, plain):
            err, rel = rel_err(a, t)
            o["err"], o["rel"] = max(o["err"], err), max(o["rel"], rel)
            o["plain_rel"] = max(o["plain_rel"], rel_err(a, p)[1])
            o["same"] = o["same"] and bool(torch.equal(a, b))
            o["finite"] = o["finite"] and bool(a.isfinite().all())
        o["ok"] = (o["ok"] and o["same"] and o["finite"]
                   and o["rel"] <= TILE_FWD_TOL[dname]
                   and o["plain_rel"] <= KERNEL_TOL[dname]
                   and picked == ("wide", "wide"))
    return out


def time_wide(torch, timer, ak, mode, args, dm, g, iters, full=True):
    """The wide pair at one shape: each kernel and its earlier design
    forced (the query forward, the rows backward: `forced_design`) through
    the same entry point on the same inputs, by CUDA events, with the
    plain twin's time, the bound and scaled_dot_product_attention
    (forward; forward + backward) in the plain and tisas modes.  With
    ``full`` (the main path's L=256) in turns (wide, old, old, wide), also
    by the profiler's device time, with each one's host time a call and
    the wide backward's split by launch; else (L=1024) each timed once.
    Returns {"fwd": row, "bwd": row}."""
    dname = str(args[0].dtype).replace("torch.", "")
    rows = {}
    for kind, kname, run, plain, bound, old in (
            ("fwd", "fused_attention",
             lambda: ak.fused_attention(mode, *args, dm),
             lambda: ak.fused_attention_plain(mode, *args, dm),
             att_bound(mode, args, dname, dm), "query"),
            ("bwd", "fused_attention_bwd",
             lambda: ak.fused_attention_bwd(mode, g, *args, dm),
             lambda: ak.fused_attention_bwd_plain(mode, g, *args, dm),
             att_bwd_bound(mode, args, dm, dname), "rows")):
        def forced(measure, kname=kname, run=run):
            with forced_design(kname):
                return measure(run)
        old_timed = lambda f: timer(f, max(iters // 5, 3))  # noqa: E731
        row = {"design": "wide", "plain_ms": timer(plain, 3 if full else 1,
                                                   warmup=1), **bound}
        if full:
            device = lambda f: timer.device(f, iters=5)  # noqa: E731
            a, b1, b2, a2 = (timer(run, iters), forced(old_timed),
                             forced(old_timed), timer(run, iters))
            d, e1, e2, d2 = (device(run), forced(device), forced(device),
                             device(run))
            mean = lambda x, y: None if None in (x, y) else (x + y) / 2  # noqa: E731
            row.update({"ms": (a + a2) / 2, "ms_repeats": [a, a2],
                        f"{old}_ms": (b1 + b2) / 2,
                        f"{old}_ms_repeats": [b1, b2],
                        "device_ms": mean(d, d2), "device_ms_repeats": [d, d2],
                        f"{old}_device_ms": mean(e1, e2),
                        f"{old}_device_ms_repeats": [e1, e2],
                        "host_ms": timer.host(run, iters=50),
                        f"{old}_host_ms": forced(
                            lambda f: timer.host(f, iters=10))})
            if kind == "bwd":
                row["passes_ms"] = timer.passes(run)
        else:
            row.update({"ms": timer(run, iters), f"{old}_ms": forced(old_timed),
                        "device_ms": None, "host_ms": None})
        library = att_library(torch, mode, args,
                              g if kind == "bwd" else None)
        if library is not None:
            row["library_ms"] = timer(library, iters)
            row["library_call"] = ("scaled_dot_product_attention"
                                   + (" fwd+bwd" if kind == "bwd" else ""))
        rows[kind] = row
    return rows


def wide_occupancy(ak, mode, dname, tk, d=128):
    """The wide kernels' shared memory a block (bytes) at (Tk, d): the
    forward's and its blocks an SM, the backward's query and key passes'."""
    lib, blib = ak._wide_library(), ak._bwd_wide_library()
    mode_id, is_bf16 = ak.MODES.index(mode), int(dname == "bfloat16")
    return {"smem_bytes": lib.fused_attention_wide_smem_bytes(
                mode_id, is_bf16, tk, d),
            "blocks_per_sm": lib.fused_attention_wide_blocks_per_sm(
                mode_id, is_bf16, tk, d, 0),
            "bwd_query_smem_bytes": blib.fused_attention_bwd_wide_smem_bytes(
                mode_id, is_bf16, tk, d, 0),
            "bwd_key_smem_bytes": blib.fused_attention_bwd_wide_smem_bytes(
                mode_id, is_bf16, tk, d, 1)}


def check_attention_wide(torch, timer, iters, failures):
    """The wide pair (the single-tile forward and backward past 64 keys)
    against their twins at WIDE_CASES in every mode and both dtypes
    (`check_wide_pair`; `att_inputs`' ragged key lengths with a row of
    length 0 and a full row, a rate-0.5 mask in the drop modes), then
    timed at B=64 and Tq = Tk of WIDE_TIMED with every key of `att_inputs`
    (`time_wide`).  Returns (kernels-line entries at L=256, the timed rows
    by length)."""
    from mtamrecommender_tpu_torch.ops import layers
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(1357)
    entries, timed = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in ak.MODES:
            drop = mode.endswith("_drop")
            start = {"err": 0.0, "rel": 0.0, "plain_rel": 0.0, "same": True,
                     "finite": True, "ok": True}
            acc = {"fwd": dict(start), "bwd": dict(start)}
            for bs, t, d in WIDE_CASES:
                args = att_inputs(torch, gen, dtype, B=bs, Tq=t, Tk=t, d=d)
                dm = (layers.draw_drop_mask(gen, bs, t, t, 0.5, DEVICE)
                      if drop else None)
                g = torch.randn(args[0].shape, generator=gen, device=DEVICE)
                acc = check_wide_pair(torch, ak, mode, args, dm, g, dname,
                                      acc)
                del args, dm, g
            for kind in ("fwd", "bwd"):
                a = acc[kind]
                print(f"fused_attention{'_bwd' if kind == 'bwd' else ''} "
                      f"{mode:10s} {dname:9s} wide Tq=Tk in (65, 256, 1024) "
                      f"max_abs_err={a['err']:.3e} rel={a['rel']:.3e} "
                      f"(tol {TILE_FWD_TOL[dname]}) plain_rel="
                      f"{a['plain_rel']:.3e} same_bits={a['same']} "
                      f"{'ok' if a['ok'] else 'FAIL'}", flush=True)
                if not a["ok"]:
                    failures.append(f"wide {kind} {mode} {dname}: {a}")
            for t in WIDE_TIMED:
                args = att_inputs(torch, gen, dtype, B=64, Tq=t, Tk=t)
                dm = (layers.draw_drop_mask(gen, 64, t, t, 0.5, DEVICE)
                      if drop else None)
                g = torch.randn(args[0].shape, generator=gen, device=DEVICE)
                rows = time_wide(torch, timer, ak, mode, args, dm, g,
                                 iters if t == 256 else max(iters // 5, 3),
                                 full=t == 256)
                occupancy = wide_occupancy(ak, mode, dname, t)
                for kind, row in rows.items():
                    a = acc[kind]
                    row.update(max_abs_err=a["err"], rel_err=a["rel"],
                               plain_rel_err=a["plain_rel"],
                               tol=TILE_FWD_TOL[dname], ok=a["ok"],
                               same_bits_twice=a["same"],
                               source=(FWD_SOURCES["wide"] if kind == "fwd"
                                       else BWD_WIDE_SOURCE), **occupancy)
                    old = "query" if kind == "fwd" else "rows"
                    print(f"fused_attention{'_bwd' if kind == 'bwd' else ''} "
                          f"{mode:10s} B=64 Tq=Tk={t} {dname:9s} wide ms="
                          f"{row['ms']:.4f} device_ms={row['device_ms']} "
                          f"{old}_ms={row[f'{old}_ms']:.4f} {old}_device_ms="
                          f"{row.get(f'{old}_device_ms')} host_ms="
                          f"{row['host_ms']} plain_ms="
                          f"{row['plain_ms']:.4f} bound_ms="
                          f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                          f"library_ms={row.get('library_ms')} smem="
                          f"{occupancy}", flush=True)
                    if "passes_ms" in row:
                        print(f"    passes_ms: {json.dumps(row['passes_ms'])}",
                              flush=True)
                    kname = ("fused_attention" if kind == "fwd"
                             else "fused_attention_bwd")
                    timed.setdefault(f"L{t}", {}).setdefault(
                        f"{kname}[{mode}]", {})[dname] = row
                    if t == 256:
                        entries.setdefault((kname, mode, "L256"),
                                           {})[dname] = row
                del args, dm, g
    return entries, timed


# ------------------------------------------------------------ phase 2d

READOUT_BATCHES, READOUT_KEYS = (1, 16, 64), (256, 512, 1024)
# the kernels of fused_readout's "gemm" design, in launch order (the
# projection is readout_gemm.cuh's, which the backward shares)
READOUT_FWD_GEMM_KERNELS = ("readout_proj_kernel", "readout_fwd_chain_kernel")
# the kernels of fused_readout_bwd's "gemm" design, in launch order (the
# fifth launch is the reduce kernel both designs share)
READOUT_BWD_GEMM_KERNELS = ("readout_proj_kernel",
                            "readout_bwd_chain_kernel",
                            "readout_bwd_dmem_kernel", "readout_bwd_dw_kernel")
# fused_readout's designs timed in turns at L=512 beside the slice's B=64,
# and checked at the widths below 128 (B=16, L=256)
READOUT_FWD_TIMED_BATCHES = (1, 16)
READOUT_FWD_WIDTHS = (32, 64)


def readout_inputs(torch, gen, dtype, B, L, d=128, n=3, gate="scalar",
                   full=False):
    """The fused readout's operands: memory and query as the long-history
    slice gives them (relu-free embeddings and a GRU state), logdt from
    sorted hour stamps, stacked per-hop weights at glorot scale, and gate
    rows (constant along L for scalar gates).  Unless ``full``: ragged
    key lengths (the first row full, the third empty from B = 16 on) and
    the second row's query masked."""
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    hours = 470_000.0 + torch.rand(B, L, generator=gen, device=DEVICE) * 5000
    t_k = hours.sort(dim=1).values
    logdt = torch.log1p((t_k[:, -1:] + 1.0 - t_k).abs()).contiguous()
    key_len = torch.full((B,), L, dtype=torch.int32, device=DEVICE)
    qmask = torch.ones(B, device=DEVICE)
    if not full:
        key_len = torch.randint(1, L + 1, (B,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        key_len[0] = L
        if B >= 16:
            key_len[2] = 0
        if B > 1:
            qmask[1] = 0.0

    def gate_row():
        if gate == "scalar":
            return (torch.randn(n, 1, generator=gen, device=DEVICE) * 0.3
                    ).expand(n, L).contiguous()
        return torch.randn(n, L, generator=gen, device=DEVICE) * 0.3

    w = d ** -0.5
    return (rand(B, L, d), rand(B, d), logdt, key_len, qmask,
            rand(n, d, d, scale=w), rand(n, d, scale=0.1),
            rand(n, d, d, scale=w), rand(n, d, scale=0.1),
            rand(n, d, d, scale=w), rand(n, d, scale=0.1),
            rand(n, d, d, scale=0.3 * w),
            *(gate_row() for _ in range(5)),
            (1.0 + rand(n, d, scale=0.1).float()).to(dtype),
            rand(n, d, scale=0.1))


def _readout_keys(key_len, L):
    """(live keys, reached keys) summed over the rows: a row's scores
    need its live keys' K, its weighted sum the V of the keys its
    weights reach (all L where none is live)."""
    live = key_len.clamp(0, L)
    return (int(live.sum().item()),
            int(live.masked_fill(live == 0, L).sum().item()))


def _readout_in_bytes(args, n_span):
    mem = args[0]
    B, L, d = mem.shape
    n = args[5].shape[0]
    es = mem.element_size()
    return (n_span * d * es + B * d * es + B * L * 4 + B * 8
            + (4 * n * d * d + 5 * n * d) * es + 5 * n * L * 4)


def readout_bound(args, dtype_name):
    """Least time for the forward these inputs need: the memory rows the
    weights reach, the query, logdt, key_len and qmask, the weights,
    biases, LN params and gate rows read once, the f32 output written;
    per hop 2d^2 FLOPs per live key (K) and per reached key (V), 4d^2 per
    row (q, u), 2d per live key twice (q.K, u.mem) and per reached key
    once (the weighted sum)."""
    mem = args[0]
    B, L, d = mem.shape
    n = args[5].shape[0]
    n_live, n_span = _readout_keys(args[3], L)
    flops = n * (2 * d * d * (n_live + n_span) + 4 * B * d * d
                 + 2 * d * (2 * n_live + n_span))
    return _bound(_readout_in_bytes(args, n_span) + B * d * 4, flops,
                  dtype_name)


def readout_bwd_bound(args, dtype_name):
    """Least time for the backward these inputs need: g and the forward's
    inputs read once, the 16 f32 cotangents written once; per hop the
    forward's K and V again (its intermediates are not inputs), dmem's
    two products and dWk's and dWv's (2d^2 FLOPs each per live key for K,
    per reached key for V), 12d^2 per row (q, u and their four transposed
    products), and 2d per live key four times (q.K, u.mem, du, dq) and
    per reached key twice (o, do.V)."""
    mem = args[0]
    B, L, d = mem.shape
    n = args[5].shape[0]
    n_live, n_span = _readout_keys(args[3], L)
    flops = n * (6 * d * d * (n_live + n_span) + 12 * B * d * d
                 + 2 * d * (4 * n_live + 2 * n_span))
    out = (B * L * d + B * d + 4 * n * d * d + 5 * n * d + 5 * n * L) * 4
    return _bound(_readout_in_bytes(args, n_span) + B * d * 4 + out, flops,
                  dtype_name)


def check_readout_fwd(torch, rk, args, dname):
    """fused_readout on the card against its twin: the default "gemm"
    design (two launches through the entry point, the same bits twice)
    and the earlier "rows" design forced (two launches, the same bits
    twice), each within KERNEL_TOL of the twin.  Returns (max |diff|, max
    rel, ok, same bits twice (gemm, rows), the forced design's max rel)."""
    want = rk.fused_readout_plain(*args)
    got = rk.fused_readout(*args)
    again = rk.fused_readout(*args)
    rows = rk._launch(args, _design="rows")
    rows_again = rk._launch(args, _design="rows")
    same = (torch.equal(got, again), torch.equal(rows, rows_again))
    err, rel, ok = _agree(got, want, dname)
    _, rows_rel, rows_ok = _agree(rows, want, dname)
    return err, rel, ok and rows_ok and all(same), same, rows_rel


def time_readout_fwd(timer, rk, args, iters):
    """The default design and the rows design on the same inputs, in
    turns (gemm, rows, rows, gemm), and the profiler's split of the
    default design's device time between its two launches."""
    run = lambda: rk.fused_readout(*args)  # noqa: E731
    rows = lambda: rk._launch(args, _design="rows")  # noqa: E731
    a, b1, b2, a2 = (timer(run, iters), timer(rows, iters),
                     timer(rows, iters), timer(run, iters))
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "rows_ms": (b1 + b2) / 2, "rows_ms_repeats": [b1, b2],
            "passes_ms": timer.passes(run)}


def readout_fwd_more(torch, timer, rk, dtype, dname, iters, failures):
    """fused_readout beyond phase 2d's cases, on inputs of a generator of
    its own (the other checks' inputs stay as they were): both designs
    timed in turns at L=512, every key live, for the smaller request
    batches (READOUT_FWD_TIMED_BATCHES), and both held against the twin
    at d = 32 and 64 (B=16, L=256, ragged keys)."""
    gen = torch.Generator(device=DEVICE).manual_seed(2468)
    out = {"by_batch": {}, "by_width": {}}
    for bs in READOUT_FWD_TIMED_BATCHES:
        args = readout_inputs(torch, gen, dtype, bs, LONG_L, full=True)
        e, r, ok, same, rows_rel = check_readout_fwd(torch, rk, args, dname)
        row = {"max_abs_err": e, "rel_err": r, "rows_rel_err": rows_rel,
               "same_bits_twice": same[0], "rows_same_bits_twice": same[1],
               "ok": ok, **time_readout_fwd(timer, rk, args, iters),
               **readout_bound(args, dname)}
        out["by_batch"][bs] = row
        print(f"fused_readout B={bs:<3d} L={LONG_L} {dname:9s} rel={r:.3e} "
              f"(rows {rows_rel:.3e}) ms={row['ms']:.4f} rows_ms="
              f"{row['rows_ms']:.4f} bound_ms={row['bound_ms']:.4f} passes="
              f"{row['passes_ms']} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"fused_readout B={bs} {dname}: rel {r:.3e}, "
                            f"rows rel {rows_rel:.3e}, same bits {same}")
    for d in READOUT_FWD_WIDTHS:
        args = readout_inputs(torch, gen, dtype, 16, 256, d=d,
                              gate="positional")
        e, r, ok, same, rows_rel = check_readout_fwd(torch, rk, args, dname)
        out["by_width"][d] = {"max_abs_err": e, "rel_err": r,
                              "rows_rel_err": rows_rel, "same_bits": same,
                              "ok": ok}
        print(f"fused_readout B=16  L=256   d={d:<4d} {dname:9s} rel={r:.3e} "
              f"(rows {rows_rel:.3e}) same_bits gemm/rows={same[0]}/"
              f"{same[1]} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"fused_readout d={d} {dname}: rel {r:.3e}, "
                            f"rows rel {rows_rel:.3e}, same bits {same}")
    return out


# widths no kernel is built for, which the wrappers pad (the GRU pair to
# a multiple of 32, the table gradients to one of 32, 64, 128, 256, the
# fused readout to one of 32, 64, 128 with the live width beside it)
WIDTH_FAULT_UNITS = (16, 48)
WIDTH_FAULT_DIMS = (16, 48, 96)


def check_width_fault(torch, failures):
    """The kernels at widths they are not built for, each against its
    plain twin at the native width, in f32 and bf16: gru_scan and
    gru_scan_bwd (tgru, B=16, L=50, ragged lengths) at u = 16 and 48;
    dtable and scatter_add (2,000 ids into 500 rows) and fused_readout and
    fused_readout_bwd in their gemm designs (B=16, L=256, ragged keys, a
    row with no live key, a masked query) at d = 16, 48 and 96; each the
    same bits twice, and each call one launch of its kernel."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as rk

    gen = torch.Generator(device=DEVICE).manual_seed(4242)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        cases = []
        for u in WIDTH_FAULT_UNITS:
            args = gru_inputs(torch, gen, "tgru", dtype, B=16, L=50, u=u)
            g = torch.randn((16, 50, u), generator=gen, device=DEVICE)
            outs = gk.gru_scan_plain("tgru", *args)
            cases += [
                ("gru_scan", u, lambda a=args: gk.gru_scan("tgru", *a),
                 lambda a=args: gk.gru_scan_plain("tgru", *a)),
                ("gru_scan_bwd", u,
                 lambda a=args, g=g, o=outs: gk.gru_scan_bwd("tgru", g, o,
                                                             *a),
                 lambda a=args, g=g, o=outs: gk.gru_scan_bwd_plain(
                     "tgru", g, o, *a))]
        for d in WIDTH_FAULT_DIMS:
            ids = torch.randint(0, 500, (2000,), generator=gen,
                                device=DEVICE, dtype=torch.int32)
            ct = torch.randn((2000, d), generator=gen, device=DEVICE
                             ).to(dtype)
            args = readout_inputs(torch, gen, dtype, 16, 256, d=d,
                                  gate="positional")
            g = torch.randn((16, d), generator=gen, device=DEVICE)
            cases += [
                ("dtable", d, lambda c=ct, i=ids: ek.dtable(c, i, 500),
                 lambda c=ct, i=ids: ek.dtable_plain(c, i, 500)),
                ("scatter_add", d,
                 lambda c=ct, i=ids: ek.scatter_add(c, i, 500),
                 lambda c=ct, i=ids: ek.scatter_add_plain(c, i, 500)),
                ("fused_readout", d, lambda a=args: rk.fused_readout(*a),
                 lambda a=args: rk.fused_readout_plain(*a)),
                ("fused_readout_bwd", d,
                 lambda a=args, g=g: rk.fused_readout_bwd(g, *a),
                 lambda a=args, g=g: rk.fused_readout_bwd_plain(g, *a))]
        for kname, width, run, plain in cases:
            _reset_counts()
            got, again = run(), run()
            torch.cuda.synchronize()
            launched = sum(_counts()[kname].values())
            want = plain()
            if isinstance(got, torch.Tensor):
                got, again, want = (got,), (again,), (want,)
            rel = max(rel_err(a, w)[1] for a, w in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (rel <= KERNEL_TOL[dname] and same and launched == 2
                  and all(bool(a.isfinite().all()) for a in got))
            out.append({"kernel": kname, "width": width, "dtype": dname,
                        "rel_err": rel, "tol": KERNEL_TOL[dname],
                        "same_bits_twice": same, "launches": launched,
                        "ok": ok})
            print(f"width fault {kname:17s} width={width:<3d} {dname:9s} "
                  f"rel={rel:.3e} same_bits={same} launches={launched} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"width fault {kname} width {width} {dname}"
                                f": rel {rel:.3e}, same bits {same}, "
                                f"launches {launched}")
    return out


def check_readout_bwd(torch, rk, g, args, dname):
    """fused_readout_bwd on the card against its twin: the default "gemm"
    design (two launches through the entry point, the same bits twice)
    and the earlier "rows" design forced (two launches, the same bits
    twice), all 16 outputs of each within KERNEL_TOL of the twin.
    Returns (max |diff|, max rel, ok, same bits twice (gemm, rows), the
    forced design's max rel)."""
    want = rk.fused_readout_bwd_plain(g, *args)
    got = rk.fused_readout_bwd(g, *args)
    again = rk.fused_readout_bwd(g, *args)
    rows = rk._launch_bwd(g, args, _design="rows")
    rows_again = rk._launch_bwd(g, args, _design="rows")
    same = (all(torch.equal(a, b) for a, b in zip(got, again)),
            all(torch.equal(a, b) for a, b in zip(rows, rows_again)))
    err = rel = rows_rel = 0.0
    ok = all(same)
    for a, r, w in zip(got, rows, want):
        e, x, o = _agree(a, w, dname)
        _, rx, ro = _agree(r, w, dname)
        err, rel, rows_rel = max(err, e), max(rel, x), max(rows_rel, rx)
        ok = ok and o and ro
    return err, rel, ok, same, rows_rel


def time_readout_bwd(timer, rk, g, args, iters):
    """The default design and the rows design on the same inputs, in
    turns (gemm, rows, rows, gemm), and the profiler's split of the
    default design's device time among its five launches."""
    run = lambda: rk.fused_readout_bwd(g, *args)  # noqa: E731
    rows = lambda: rk._launch_bwd(g, args, _design="rows")  # noqa: E731
    a, b1, b2, a2 = (timer(run, iters), timer(rows, iters),
                     timer(rows, iters), timer(run, iters))
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "rows_ms": (b1 + b2) / 2, "rows_ms_repeats": [b1, b2],
            "passes_ms": timer.passes(run)}


def check_gru_long(torch, timer, gen, dtype, L, iters, plain_iters,
                   failures):
    """gru_scan and gru_scan_bwd (tgru) at B=64 and length L, every row
    full: each against its twin once (each kernel's two designs as
    check_gru_fwd and check_gru_bwd hold them), the kernels timed over
    ``iters`` calls (each kernel's two designs in turns) and the twins over
    ``plain_iters`` calls after the checking call (0: not timed)."""
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    dname = str(dtype).replace("torch.", "")
    args = gru_inputs(torch, gen, "tgru", dtype, B=LONG_BATCH, L=L)
    args[4].fill_(L)
    with torch.no_grad():
        outs = gk.gru_scan("tgru", *args)
    g = torch.randn(outs.shape, generator=gen, device=DEVICE)
    t0 = time.perf_counter()
    err, rel, ok, same, column_rel = check_gru_fwd(torch, gk, "tgru", args,
                                                   dname)
    fwd_check_s = time.perf_counter() - t0
    plain = lambda fn: (timer(fn, plain_iters, warmup=0)  # noqa: E731
                        if plain_iters else "not timed")
    rows = {"gru_scan": {
        "max_abs_err": err, "rel_err": rel,
        "unit_column_rel_err": column_rel, "same_bits_twice": same,
        "tol": KERNEL_TOL[dname], "ok": ok,
        **time_gru_fwd(timer, gk, "tgru", args, iters),
        "plain_ms": plain(lambda: gk.gru_scan_plain("tgru", *args)),
        "plain_check_s": fwd_check_s, **gru_bound("tgru", args, dname)}}
    t0 = time.perf_counter()
    err, rel, ok, same, four_rel = check_gru_bwd(torch, gk, "tgru", g, outs,
                                                 args, dname)
    rows["gru_scan_bwd"] = {
        "max_abs_err": err, "rel_err": rel,
        "four_product_rel_err": four_rel, "same_bits_twice": same,
        "tol": KERNEL_TOL[dname], "ok": ok,
        **time_gru_bwd(timer, gk, "tgru", g, outs, args, iters),
        "plain_ms": plain(lambda: gk.gru_scan_bwd_plain("tgru", g, outs,
                                                        *args)),
        "plain_check_s": time.perf_counter() - t0,
        **gru_bwd_bound("tgru", args, dname)}
    for kname, row in rows.items():
        plain_ms = row["plain_ms"]
        print(f"{kname} tgru B=64 L={L} {dname:9s} max_abs_err="
              f"{row['max_abs_err']:.3e} rel={row['rel_err']:.3e} ms="
              f"{row['ms']:.4f} ({row['ms'] / L * 1e3:.3f} us a step) "
              f"unit_column_ms={row.get('unit_column_ms')} "
              f"four_product_ms={row.get('four_product_ms')} plain_ms="
              f"{plain_ms} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) passes={row.get('passes_ms')} "
              f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
        if not row["ok"]:
            failures.append(f"{kname} tgru L={L} {dname}: rel err "
                            f"{row['rel_err']:.3e}, unit_column "
                            f"{row.get('unit_column_rel_err')}, four_product "
                            f"{row.get('four_product_rel_err')}, same bits "
                            f"{row.get('same_bits_twice')}")
    return rows


def check_readout_kernels(torch, timer, iters, failures, tables):
    """The long-history kernels against their plain twins: fused_readout
    and fused_readout_bwd at B = 1, 16, 64 x L = 256, 512, 1024 (scalar
    gates at L = 512, positional at the others; ragged keys, one masked
    query), and on the slice's own shape (B=64, L=512, every key live,
    scalar gates); the backward in each case in its "gemm" design and
    with the "rows" design forced (check_readout_bwd), both timed on the
    slice's shape in turns; gru_scan and gru_scan_bwd at B=64, L=512;
    dtable on the slice's four tables with the ids of its first batch
    (``tables``, as check_train_kernels takes them)."""
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as rk

    gen = torch.Generator(device=DEVICE).manual_seed(1357)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        fwd = {"err": 0.0, "rel": 0.0, "ok": True, "rows_rel": 0.0}
        bwd = {"err": 0.0, "rel": 0.0, "ok": True, "rows_rel": 0.0}
        same = [True, True]           # the same bits twice: gemm, rows
        fwd_same = [True, True]
        cases = [(bs, L, "scalar" if L == LONG_L else "positional", False)
                 for L in READOUT_KEYS for bs in READOUT_BATCHES]
        for bs, L, gate, full in cases + [(LONG_BATCH, LONG_L, "scalar",
                                           True)]:
            args = readout_inputs(torch, gen, dtype, bs, L, gate=gate,
                                  full=full)
            e, r, o, twice, rows_rel = check_readout_fwd(torch, rk, args,
                                                         dname)
            fwd_same = [fwd_same[0] and twice[0], fwd_same[1] and twice[1]]
            fwd = {"err": max(fwd["err"], e), "rel": max(fwd["rel"], r),
                   "ok": fwd["ok"] and o,
                   "rows_rel": max(fwd["rows_rel"], rows_rel)}
            fwd_print = (f"fwd rel={r:.3e} (rows {rows_rel:.3e}) same_bits "
                         f"gemm/rows={twice[0]}/{twice[1]}")
            g = torch.randn((bs, 128), generator=gen, device=DEVICE)
            e, r, o, twice, rows_rel = check_readout_bwd(torch, rk, g, args,
                                                         dname)
            same = [same[0] and twice[0], same[1] and twice[1]]
            bwd = {"err": max(bwd["err"], e), "rel": max(bwd["rel"], r),
                   "ok": bwd["ok"] and o,
                   "rows_rel": max(bwd["rows_rel"], rows_rel)}
            print(f"fused_readout(+bwd) B={bs:<3d} L={L:<5d} {gate:10s}"
                  f" {dname:9s} {fwd_print}; bwd rel={r:.3e} (rows "
                  f"{rows_rel:.3e}) same_bits gemm/rows={twice[0]}/"
                  f"{twice[1]}", flush=True)
        # args and g are the slice's shape now
        ws = rk._library().fused_readout_workspace_bytes(
            LONG_BATCH, LONG_L, 128, 3, int(dtype == torch.bfloat16), 0)
        print(f"fused_readout gemm workspace B={LONG_BATCH} L={LONG_L} "
              f"d=128 3 hops {dname}: {ws} bytes ({ws / 1e6:.1f} MB)",
              flush=True)
        rows = {
            "fused_readout": {
                "max_abs_err": fwd["err"], "rel_err": fwd["rel"],
                "rows_rel_err": fwd["rows_rel"], "tol": KERNEL_TOL[dname],
                "ok": fwd["ok"] and all(fwd_same),
                "same_bits_twice": fwd_same[0],
                "rows_same_bits_twice": fwd_same[1], "workspace_bytes": ws,
                **time_readout_fwd(timer, rk, args, iters),
                "plain_ms": timer(lambda: rk.fused_readout_plain(*args),
                                  max(iters // 10, 3)),
                **readout_bound(args, dname)},
            "fused_readout_bwd": {
                "max_abs_err": bwd["err"], "rel_err": bwd["rel"],
                "rows_rel_err": bwd["rows_rel"],
                "tol": KERNEL_TOL[dname], "ok": bwd["ok"] and all(same),
                "same_bits_twice": same[0], "rows_same_bits_twice": same[1],
                **time_readout_bwd(timer, rk, g, args, iters),
                "plain_ms": timer(lambda: rk.fused_readout_bwd_plain(
                    g, *args), max(iters // 10, 3)),
                **readout_bwd_bound(args, dname)}}
        for kname, row in rows.items():
            entries.setdefault((kname, None, "L512"), {})[dname] = row
            print(f"{kname} B=64 L=512 {dname:9s} max_abs_err="
                  f"{row['max_abs_err']:.3e} rel={row['rel_err']:.3e} ms="
                  f"{row['ms']:.4f} rows_ms={row.get('rows_ms')} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) passes={row.get('passes_ms')} "
                  f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
            if not row["ok"]:
                failures.append(f"{kname} {dname}: rel err {row['rel_err']:.3e}"
                                f", same bits {same} / {fwd_same}")
        # the forward's designs at the smaller batches and widths
        rows["fused_readout"].update(readout_fwd_more(
            torch, timer, rk, dtype, dname, iters, failures))
        # the T-GRU scan and its backward at the slice's length
        for kname, row in check_gru_long(torch, timer, gen, dtype, LONG_L,
                                         max(iters // 10, 3), 3,
                                         failures).items():
            entries.setdefault((kname, "tgru", "L512"), {})[dname] = row
        entries.setdefault(("dtable", None, "L512"), {})[dname] = \
            check_dtable(torch, timer, iters, failures, gen, dtype, tables,
                         "L=512")
    return entries


# ------------------------------------------------------------ phase 4

def make_train_arrays(meta, n, seed=0):
    """n packed training rows: a numpy copy of __graft_entry__._make_batch
    (same draws, same order) without the JAX arrays."""
    rng = np.random.RandomState(seed)
    L = meta.max_seq_len
    seq_len = rng.randint(2, L + 1, n).astype(np.int32)
    items = np.zeros((n, L), np.int32)
    cats = np.zeros((n, L), np.int32)
    times = np.zeros((n, L), np.float32)
    for b in range(n):
        k = int(seq_len[b])
        items[b, :k] = rng.randint(1, meta.item_count + 1, k)
        items[b, k - 1] = meta.item_count + 1
        cats[b, :k] = rng.randint(1, meta.category_count + 1, k)
        cats[b, k - 1] = meta.category_count + 1
        times[b, :k] = np.sort(rng.rand(k).astype(np.float32) * 1000)
    tl = np.zeros((n, L), np.float32)
    tn = np.zeros((n, L), np.float32)
    pos = np.zeros((n, L), np.int32)
    for b in range(n):
        k = int(seq_len[b])
        tl[b, 1:k] = times[b, 1:k] - times[b, :k - 1]
        tn[b, :k] = times[b, k - 1] - times[b, :k]
        pos[b, :k] = np.arange(k)
    return dict(
        user_id=rng.randint(1, meta.user_count + 1, n).astype(np.int32),
        items=items, cats=cats, times=times, time_last=tl, time_now=tn,
        positions=pos,
        target_id=rng.randint(1, meta.item_count + 1, n).astype(np.int32),
        target_cat=rng.randint(1, meta.category_count + 1, n).astype(np.int32),
        target_time=(times.max(1) + 1).astype(np.float32), seq_len=seq_len)


def train_cfg(dname, name="MTAM"):
    """The training cell's configuration for model ``name``: d=128, 3
    hops or blocks, 1 head, the default dropout (0.5: SASrec and TiSAS
    drop attention weights, MTAM and the time-aware SA model draw
    nothing)."""
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides(**{
        "model.experiment_type": name, "model.num_units": 128,
        "model.num_blocks": 3, "model.vocab_pad_multiple": 128,
        "model.compute_dtype": dname, "model.use_pallas": True,
        "model.pallas_scope": "gru" if name == "MTAM" else "all",
        "data.max_seq_len": 50, "train.train_batch_size": TRAIN_BATCH})


def step_tables(setup, batch=None):
    """The step's four lookups: table -> (the flat int32 ids of ``batch``,
    the setup's first batch by default, and the padded vocab); and, per
    table, whether every id of the dataset lies in [0, vocab), checked on
    the card (the dtable kernel does not check)."""
    from mtamrecommender_tpu_torch.ops.embedding import pad_vocab

    m = setup.meta
    batch = setup.batch if batch is None else batch
    tables, in_range = {}, {}
    for table, field, vocab in (
            ("user_table", "user_id", m.user_vocab),
            ("item_table", "items", m.item_vocab),
            ("cat_table", "cats", m.category_vocab),
            ("pos_table", "positions", m.position_vocab)):
        v = pad_vocab(vocab, 128)
        ids = getattr(batch, field).reshape(-1).contiguous()
        tables[table] = (ids, v)
        col = getattr(setup.data, field)
        in_range[table] = bool(((col >= 0) & (col < v)).all())
    return tables, in_range


class TrainSetup:
    """The training cell: bench.py's MTAM configuration, 4096 rows from
    make_train_arrays on the card and on the CPU, one epoch order."""

    batch_size = TRAIN_BATCH

    @staticmethod
    def cfg(dname, name="MTAM"):
        return train_cfg(dname, name)

    def __init__(self, torch):
        from mtamrecommender_tpu_torch.data.device_data import (epoch_order,
                                                                 gather_batch,
                                                                 to_device)
        from mtamrecommender_tpu_torch.types import DatasetMeta

        self.meta = DatasetMeta(user_count=4832, item_count=3706,
                                category_count=18, max_seq_len=50)
        arrays = make_train_arrays(self.meta, TRAIN_ROWS, seed=0)
        self.data = to_device(arrays)               # CUDA: the default
        self.data_cpu = to_device(arrays, device="cpu")
        epochs = [epoch_order(TRAIN_ROWS, TRAIN_BATCH,
                              np.random.RandomState(e))[0] for e in range(3)]
        self.order_np = np.concatenate(epochs)
        self.order = torch.tensor(self.order_np, device=DEVICE)
        self.order_cpu = torch.tensor(self.order_np)
        self.batch = gather_batch(self.data, self.order, 0, TRAIN_BATCH)
        self.batch_cpu = gather_batch(self.data_cpu, self.order_cpu, 0,
                                      TRAIN_BATCH)
        self.tables, self.ids_in_range = step_tables(self)

    def model(self, torch, cfg, device):
        from mtamrecommender_tpu_torch.models.registry import get_model
        return get_model(cfg.model.experiment_type).init(
            torch.Generator().manual_seed(0), cfg.model,
            self.meta).to(device)


class NarrowSetup:
    """Phase 4's cell (its data, batch and tables) at model.num_units 16:
    the width __graft_entry__.py's smoke trains MTAM at, padded by the
    wrappers of the GRU pair and dtable."""

    batch_size = TRAIN_BATCH
    model = TrainSetup.model

    def __init__(self, setup):
        self.meta, self.batch, self.batch_cpu = (setup.meta, setup.batch,
                                                 setup.batch_cpu)

    @staticmethod
    def cfg(dname, name="MTAM"):
        return train_cfg(dname, name).with_overrides(
            **{"model.num_units": 16})


def _loss_grads(torch, cfg, model, batch, vocab, drop_masks=None,
                neg_id=None):
    """One step's loss and gradients; ``drop_masks``, where given, are
    the forward's masks in block (or hop) order (its mask source), and
    ``neg_id`` the bpr loss's negative item."""
    from mtamrecommender_tpu_torch.models.base import compute_loss
    from mtamrecommender_tpu_torch.models.registry import get_model

    model.zero_grad(set_to_none=True)
    source = None if drop_masks is None else iter(drop_masks)
    metrics = compute_loss(get_model(cfg.model.experiment_type), model,
                           cfg.model, batch, vocab, gen=source,
                           neg_id=neg_id)
    metrics["loss"].backward()
    # a parameter the loss does not reach (Vallina_Gru4Rec's behavior
    # projection) has no grad: zeros, as the train step takes it; f64
    # gradients (`float64_twins`) stay f64, the others come back in f32
    return ({k: v.item() for k, v in metrics.items()},
            {n: (p.grad.detach().cpu().to(torch.promote_types(
                p.grad.dtype, torch.float32)) if p.grad is not None
                 else torch.zeros(p.shape))
             for n, p in model.named_parameters()})


def _counts():
    """Every wrapper's launches since the last `_reset_counts`, by kernel
    and mode (the kernels without modes under their own name); and the
    calls of the attention's dense route (`dense_fwd`, `dense_bwd`: plain
    PyTorch, no kernel)."""
    gk, ak, ek, rk, rc = _kernel_modules()
    return {"gru_scan": dict(gk.launches), "gru_scan_bwd": dict(gk.bwd_launches),
            "fused_attention": dict(ak.launches),
            "fused_attention_hop": dict(ak.fwd_hop_launches),
            "fused_attention_blocked": dict(ak.fwd_blocked_launches),
            "fused_attention_wide": dict(ak.fwd_wide_launches),
            "fused_attention_query": dict(ak.fwd_query_launches),
            "fused_attention_bwd": dict(ak.bwd_launches),
            "fused_attention_bwd_wide": dict(ak.bwd_wide_launches),
            "fused_attention_bwd_rows": dict(ak.bwd_rows_launches),
            "fused_attention_blockwise": dict(ak.blockwise_launches),
            "fused_attention_blockwise_mma": dict(ak.blockwise_mma_launches),
            "fused_attention_blockwise_regtile": dict(
                ak.blockwise_regtile_launches),
            "fused_attention_blockwise_split": dict(
                ak.blockwise_split_launches),
            "dense_fwd": dict(ak.dense_fwd), "dense_bwd": dict(ak.dense_bwd),
            "dtable": dict(ek.launches),
            "gather": {"gather": ek.gather_launches["gather"]},
            "gather_warp_row": {
                "gather_warp_row": ek.gather_launches["gather_warp_row"]},
            "scatter_add": {"scatter_add": ek.gather_launches["scatter_add"]},
            "fused_readout": {"fused_readout": rk.launches},
            "fused_readout_bwd": {"fused_readout_bwd": rk.bwd_launches},
            "readout_chain": {"readout_chain": rc.launches},
            "readout_chain_blocked": {
                "readout_chain_blocked": rc.blocked_launches},
            "readout_chain_rows": {"readout_chain_rows": rc.rows_launches},
            "readout_chain_bwd": {"readout_chain_bwd": rc.bwd_launches},
            "readout_chain_bwd_blocked": {
                "readout_chain_bwd_blocked": rc.bwd_blocked_launches},
            "readout_chain_bwd_rows": {
                "readout_chain_bwd_rows": rc.bwd_rows_launches}}


def _reset_counts():
    gk, ak, ek, rk, rc = _kernel_modules()
    for counts in (gk.launches, gk.bwd_launches, ak.launches,
                   ak.fwd_hop_launches, ak.fwd_blocked_launches,
                   ak.fwd_wide_launches,
                   ak.fwd_query_launches, ak.bwd_launches,
                   ak.bwd_wide_launches, ak.bwd_rows_launches,
                   ak.blockwise_launches,
                   ak.blockwise_mma_launches, ak.blockwise_regtile_launches,
                   ak.blockwise_split_launches, ak.dense_fwd, ak.dense_bwd,
                   ek.launches, ek.gather_launches):
        for m in counts:
            counts[m] = 0
    rk.launches = rk.bwd_launches = 0
    rc.launches = rc.blocked_launches = rc.rows_launches = 0
    rc.bwd_launches = rc.bwd_blocked_launches = rc.bwd_rows_launches = 0


def _want_counts(steps, gru=None, attention=None, blocks=3, readout=False,
                 dense_fwd=None, dense_bwd=None, chain=False):
    """Launches after ``steps`` training steps: 4 dtable a step; the GRU
    scan and its backward once a step in mode ``gru``; the attention
    forward and backward ``blocks`` times a step in mode ``attention``
    (at Tq = Tk = 50: the forward's hop, wide and query designs and the
    backward's wide and rows designs never; callers past 64 keys add the
    wide designs' launches);
    the fused readout and its backward once a step with ``readout``, the
    chain readout's pair with ``chain`` (the blocked and rows designs
    never: at L=50 both take the staged design; phase 14's L=150 adds
    the blocked design's); the dense route's
    forward and
    backward ``blocks`` times a step in the modes given; no blockwise
    launch (the callers that expect one add it)."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gru_counts = {m: steps * int(m == gru) for m in gk.MODES}
    att = {m: steps * blocks * int(m == attention) for m in ak.MODES}
    per = lambda modes, mode: {m: steps * blocks * int(m == mode)  # noqa: E731
                               for m in modes}
    return {"gru_scan": gru_counts, "gru_scan_bwd": dict(gru_counts),
            "fused_attention": att,
            # the main path takes the forward's hop design at Tq = 1, Tk
            # <= 64 and its blocked design at Tq = 1, 64 < Tk <= 1024
            # only (`attention_fwd_design`), which callers add, and its
            # query design never
            "fused_attention_hop": dict.fromkeys(ak.MODES, 0),
            "fused_attention_blocked": dict.fromkeys(ak.MODES, 0),
            "fused_attention_wide": dict.fromkeys(ak.MODES, 0),
            "fused_attention_query": dict.fromkeys(ak.MODES, 0),
            "fused_attention_bwd": dict(att),
            "fused_attention_bwd_wide": dict.fromkeys(ak.MODES, 0),
            # the main path never takes the backward's rows design at
            # Tq = Tk = 50 (`attention_bwd_design`: "tile")
            "fused_attention_bwd_rows": dict.fromkeys(ak.MODES, 0),
            "fused_attention_blockwise": dict.fromkeys(ak.BLOCKWISE_MODES, 0),
            "fused_attention_blockwise_mma": dict.fromkeys(
                ak.BLOCKWISE_MODES, 0),
            "fused_attention_blockwise_regtile": dict.fromkeys(
                ak.BLOCKWISE_MODES, 0),
            "fused_attention_blockwise_split": dict.fromkeys(
                ak.BLOCKWISE_MODES, 0),
            "dense_fwd": per(ak.MODES, dense_fwd),
            "dense_bwd": per(ak.MODES, dense_bwd),
            "dtable": {"dtable": 4 * steps},
            "gather": {"gather": 0}, "gather_warp_row": {"gather_warp_row": 0},
            "scatter_add": {"scatter_add": 0},
            "fused_readout": {"fused_readout": steps * int(readout)},
            "fused_readout_bwd": {"fused_readout_bwd": steps * int(readout)},
            "readout_chain": {"readout_chain": steps * int(chain)},
            "readout_chain_blocked": {"readout_chain_blocked": 0},
            "readout_chain_rows": {"readout_chain_rows": 0},
            "readout_chain_bwd": {"readout_chain_bwd": steps * int(chain)},
            "readout_chain_bwd_blocked": {"readout_chain_bwd_blocked": 0},
            "readout_chain_bwd_rows": {"readout_chain_bwd_rows": 0}}


def _kernel_modules():
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as rc
    from mtamrecommender_tpu_torch.ops.kernels import readout_kernel as rk
    return gk, ak, ek, rk, rc


def one_step_check(torch, setup, failures, name, want, drop_masks=None,
                   hold_bf16_scalars=True, neg_id=None,
                   dtypes=("float32", "bfloat16"), cpu_order=None,
                   relu_kinks=False):
    """One step's loss and every gradient leaf on the card against the
    CPU (the plain twins), in each of ``dtypes`` (f32 first: bf16 is held
    against it too), and the step's launches against ``want``.
    ``cpu_order``, where given, is a context manager under which the CPU
    sums in the kernels' order (their design twins): the f32 CPU step is
    run again under it, and each f32 leaf is allowed, on top of the
    tolerance, the CPU's own gap between the two orders (a scalar gate's
    sum of B*L*L cancelling terms moves that much with the order alone;
    the bf16 rule already allows the CPU's bf16-vs-f32 gap).  The f32
    step is then also computed in float64 (`float64_step`), and each f32
    leaf's distance from it, relative to its largest |value|, is printed
    and reported for the card and for both CPU orders; that is not held.
    With ``relu_kinks`` the card's step runs first and the CPU's step
    takes a ReLU on the card's side of its kink (`relu_sides`): an
    element whose sign differs from the card's by no more than the
    step type's rounding gets the card's subgradient.  A step fails
    where a sign differs farther from 0 than that, or where more than
    ceil(elements * eps) elements were moved.
    ``drop_masks``: CPU masks, one per block (or
    readout hop), injected on both sides; ``neg_id``: the bpr loss's
    negative item, likewise.  Without ``hold_bf16_scalars`` the bf16 gradients of
    scalar leaves (the scalar decay gates) are reported, not held: at
    L=2048 each is a sum of B*L*L terms that cancel, which bf16 rounding
    leaves noise on either device (PERF.md, PR 5); f32 holds them."""
    vocab = setup.meta.item_vocab
    on_card = None if drop_masks is None else [m.to(DEVICE)
                                                for m in drop_masks]
    report, cpu32 = {}, None
    for dname in dtypes:
        cfg = setup.cfg(dname, name)
        dtype = getattr(torch, dname)
        sides = {"ops": [], "chain": []} if relu_kinks else None
        _reset_counts()
        with relu_sides(sides, dtype, record=True):
            m_gpu, g_gpu = _loss_grads(
                torch, cfg, setup.model(torch, cfg, DEVICE), setup.batch,
                vocab, on_card, None if neg_id is None else neg_id.to(DEVICE))
        torch.cuda.synchronize()
        counts = _counts()
        with relu_sides(sides, dtype) as kinks:
            m_cpu, g_cpu = _loss_grads(
                torch, cfg, setup.model(torch, cfg, "cpu"), setup.batch_cpu,
                vocab, drop_masks, neg_id)
        order_gap, from_f64 = {}, {}
        if dname == "float32":
            cpu32 = g_cpu
            if cpu_order is not None:
                with cpu_order():
                    _, g_alt = _loss_grads(
                        torch, cfg, setup.model(torch, cfg, "cpu"),
                        setup.batch_cpu, vocab, drop_masks, neg_id)
                order_gap = {leaf: (g_alt[leaf] - g).abs().max().item()
                             for leaf, g in g_cpu.items()}
                g64 = float64_step(torch, setup, cfg, drop_masks, neg_id)
                for leaf, g in g_gpu.items():
                    scale = max(g_cpu[leaf].abs().max().item(), 1e-30)
                    far = {k: (x.double().cpu() - g64[leaf]).abs().max().item()
                           / scale for k, x in (("card", g),
                                                ("plain", g_cpu[leaf]),
                                                ("wide", g_alt[leaf]))}
                    far["no_farther"] = far["card"] <= max(far["plain"],
                                                           far["wide"])
                    from_f64[leaf] = far
        worst, worst_leaf, ok = 0.0, None, True
        by_leaf, reported_only = {}, []
        for leaf, g in g_gpu.items():
            scale = max(cpu32[leaf].abs().max().item(), 1e-30)
            diff = (g - g_cpu[leaf]).abs().max().item()
            by_leaf[leaf] = diff / scale
            allowed = TRAIN_TOL[dname] * scale + order_gap.get(leaf, 0.0)
            if dname == "bfloat16":
                allowed += (g_cpu[leaf] - cpu32[leaf]).abs().max().item()
            finite = bool(torch.isfinite(g).all())
            if dname == "bfloat16" and g.dim() == 0 and not hold_bf16_scalars:
                reported_only.append(leaf)
                ok = ok and finite
                continue
            ok = ok and finite and diff <= allowed
            if diff / scale > worst:
                worst, worst_leaf = diff / scale, leaf
        loss_rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                    for k in m_cpu}
        ok = ok and max(loss_rel.values()) <= TRAIN_TOL[dname] \
            and counts == want(1, dname)
        report[f"one_step_{dname}"] = {
            "loss_gpu": m_gpu, "loss_cpu": m_cpu, "loss_rel_err": loss_rel,
            "worst_grad_rel_err": worst, "worst_leaf": worst_leaf,
            "grad_rel_err_by_leaf": by_leaf, "reported_only": reported_only,
            "cpu_bf16_vs_f32_by_leaf": (
                {leaf: (g_cpu[leaf] - cpu32[leaf]).abs().max().item()
                 / max(cpu32[leaf].abs().max().item(), 1e-30)
                 for leaf in reported_only}),
            "cpu_order_gap_by_leaf": {
                leaf: gap / max(cpu32[leaf].abs().max().item(), 1e-30)
                for leaf, gap in order_gap.items() if gap},
            "launches": counts, "ok": ok}
        if relu_kinks:
            cap = math.ceil(kinks["elements"] * torch.finfo(dtype).eps)
            kinks_ok = kinks["far"] == 0 and kinks["flipped"] <= cap
            ok = ok and kinks_ok
            report[f"one_step_{dname}"].update(
                ok=ok, relu_elements=kinks["elements"],
                relu_kinks_taken_from_the_card=kinks["flipped"],
                relu_kinks_cap=cap,
                relu_farthest_kink_in_eps=kinks["farthest"],
                relu_signs_differing_past_the_kink=kinks["far"])
            print(f"    relu {name} {dname}: {kinks['flipped']} of "
                  f"{kinks['elements']} elements took the card's side "
                  f"(cap {cap}, farthest {kinks['farthest']:.2f} eps of "
                  f"the tensor's max), {kinks['far']} differ past the kink "
                  f"{'ok' if kinks_ok else 'FAIL'}", flush=True)
        if from_f64:
            report[f"one_step_{dname}"].update(
                f64_distance_by_leaf=from_f64,
                card_no_farther_from_f64_on_every_leaf=all(
                    far["no_farther"] for far in from_f64.values()))
            for leaf, far in from_f64.items():
                print(f"    f64 {name} {leaf:32s} card={far['card']:.3e} "
                      f"plain={far['plain']:.3e} wide={far['wide']:.3e} "
                      f"cpu_err={by_leaf[leaf]:.3e}"
                      f"{'' if far['no_farther'] else ' card farther'}",
                      flush=True)
        print(f"train {name} L={setup.meta.max_seq_len} one step {dname:9s} "
              f"loss gpu="
              f"{m_gpu['loss']:.6f} cpu={m_cpu['loss']:.6f} worst grad rel "
              f"err={worst:.3e} ({worst_leaf}) launches={counts} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"training {name} one step {dname}: "
                            f"{report[f'one_step_{dname}']}")
    return report


# the modules whose ReLUs run outside the kernels (plain PyTorch)
RELU_MODULES = ("ops.attention", "ops.embedding", "ops.time_gru",
                "models.hybrid")
# a ReLU input within this many eps of the step's type, times its
# tensor's largest |value|, is at the kink: the devices' roundings can
# put it on either side
RELU_KINK_EPS = 8


@contextlib.contextmanager
def relu_sides(sides, dtype, record=False):
    """Within the block each ReLU keeps the sign pattern of its input on
    the recording device, at its kink only.  With ``record`` (the card's
    step), ``sides`` {"ops": [], "chain": []} gets, in call order, the
    pattern of each ReLU of RELU_MODULES (``torch.relu`` there) and, per
    readout_chain call, each hop's pattern of the query projection the
    kernel applies its ReLU to, relu(cur_c Wq + bq), from the hop inputs
    it returns.  Else (the CPU's step) those ReLUs meet the recorded
    patterns in the same order, the chain twins' query ReLU
    (``torch.relu`` in readout_chain_kernel: each hop in the forward,
    then again from the last hop in the backward) too.  An element whose
    sign differs from the card's takes the card's side where its |value|
    is within RELU_KINK_EPS eps of ``dtype`` times the tensor's largest
    |value|, and keeps its own elsewhere.  The block yields {"elements",
    "flipped", "far", "farthest"}: the ReLU elements seen, those moved,
    those whose sign differs past the kink, and the largest |value| a
    moved element had in those units.  A call whose shape differs from
    the recorded one, or a count of calls other than the recorded ones
    (for the chain one a hop in the forward and again in each backward
    the card launched), raises ValueError.  With ``sides`` None
    nothing changes."""
    import importlib

    import torch

    from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as rc

    seen = {"elements": 0, "flipped": 0, "far": 0, "farthest": 0.0}
    if sides is None:
        yield seen
        return
    ops_calls, chain_calls = iter(sides["ops"]), []
    eps = torch.finfo(dtype).eps

    def taken(x, side):
        """The sign each element of x takes (True: positive)."""
        if side.shape != x.shape:
            raise ValueError(f"relu_sides: the devices' ReLUs differ: "
                             f"{tuple(side.shape)} vs {tuple(x.shape)}")
        pos = x > 0
        differ = pos != side
        unit = eps * x.detach().abs().max().float().clamp_min(1e-30)
        dist = x.detach().abs().float() / unit
        near = differ & (dist <= RELU_KINK_EPS)
        seen["elements"] += x.numel()
        seen["flipped"] += int(near.sum())
        seen["far"] += int((differ & ~near).sum())
        if near.any():
            seen["farthest"] = max(seen["farthest"], dist[near].max().item())
        return torch.where(near, side, pos)

    def relu(x):
        if record:
            sides["ops"].append((x > 0).to("cpu"))
            return torch.relu(x)
        return x * taken(x, next(ops_calls)).to(x.dtype)

    def chain_relu(x):
        # the forward twin's hops 0 .. n-1, then the backward's n-1 .. 0;
        # q > 0 exactly where the side taken is positive (the backward's
        # mask)
        hops = sides["chain"][0]
        k = len(chain_calls)
        chain_calls.append(k)
        if k >= len(hops) * (1 + sides["chain_bwd"]):
            raise ValueError(f"relu_sides: more query ReLUs in the chain "
                             f"twins than {len(hops)} a pass of the card's")
        side = hops[k if k < len(hops) else 2 * len(hops) - 1 - k]
        return torch.where(taken(x, side),
                           x.abs().clamp_min(torch.finfo(x.dtype).tiny),
                           torch.zeros_like(x))

    def chain_bwd(*args):
        sides["chain_bwd"] += 1
        return launch_bwd(*args)

    def chain(*args):
        out, curs = launch(*args)
        wq, bq, dt = args[8], args[9], args[3].dtype
        sides["chain"].append([
            (curs[i].to(dt).float().cpu() @ wq[i].float().cpu()
             + bq[i].float().cpu()) > 0 for i in range(curs.shape[0])])
        return out, curs

    class Torch:
        """torch, but its relu."""

        def __init__(self, fn):
            self.relu = fn

        def __getattr__(self, attr):
            return getattr(torch, attr)

    mods = [importlib.import_module(f"mtamrecommender_tpu_torch.{m}")
            for m in RELU_MODULES]
    launch, launch_bwd = rc.readout_chain, rc.readout_chain_bwd
    for m in mods:
        m.torch = Torch(relu)
    if record:
        sides["chain_bwd"] = 0
        rc.readout_chain, rc.readout_chain_bwd = chain, chain_bwd
    elif sides["chain"]:
        if len(sides["chain"]) != 1:
            raise ValueError("relu_sides: one readout_chain call a step")
        rc.torch = Torch(chain_relu)
    try:
        yield seen
    finally:
        for m in mods + [rc]:
            m.torch = torch
        rc.readout_chain, rc.readout_chain_bwd = launch, launch_bwd
    if not record:
        left = sum(1 for _ in ops_calls)
        hops = len(sides["chain"][0]) if sides["chain"] else 0
        if left or len(chain_calls) != hops * (1 + sides["chain_bwd"]):
            raise ValueError(f"relu_sides: the CPU's step left {left} of the "
                             f"card's ReLUs and made {len(chain_calls)} "
                             f"query ReLUs in the chain twins for {hops} "
                             f"hops")


@contextlib.contextmanager
def float64_twins():
    """Within the block the CPU path runs in float64 where its twins fix
    f32 inside themselves: the attention middle is `reference_middle`
    under autograd in f64 (for `fused_attention_vjp`) and the table
    lookups plain indexing (for `take_dtable`, whose `dtable` twin sums
    in f32).  The main path is untouched outside the block."""
    import torch

    from mtamrecommender_tpu_torch.ops import embedding
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    vjp, take = ak.fused_attention_vjp, embedding.take_dtable

    def middle(mode, *args):
        return ak.reference_middle(mode, *args, dtype=torch.float64)

    ak.fused_attention_vjp = middle
    embedding.take_dtable = lambda table, ids: table[ids.long()]
    try:
        yield
    finally:
        ak.fused_attention_vjp, embedding.take_dtable = vjp, take


def float64_step(torch, setup, cfg, drop_masks=None, neg_id=None):
    """The f32 step's gradients computed in float64 on the CPU: the
    setup's model and first batch cast to f64, under `float64_twins`."""
    from mtamrecommender_tpu_torch.models.base import cast_floats

    model = setup.model(torch, cfg, "cpu").double()
    with float64_twins():
        _, grads = _loss_grads(torch, cfg, model,
                               cast_floats(setup.batch_cpu, torch.float64),
                               setup.meta.item_vocab, drop_masks, neg_id)
    return grads


def five_steps_check(torch, setup, failures, name):
    """Five f32 make_superstep steps on the card against the CPU, which
    takes them one at a time.  The card runs the five on its own: each
    loss within TRAJ_LOSS_RTOL of the CPU's.  Then it takes each step
    again from the CPU's parameters and Adam state before that step:
    every parameter leaf after it within TRAJ_PARAM_ATOL of the CPU's.
    The free run's parameter gap is reported, not held (PERF.md, PR 4)."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.trainer import (AdamState,
                                                         make_optimizer,
                                                         make_superstep)

    cfg = setup.cfg("float32", name)
    opt = make_optimizer(cfg.train)

    def run_on(device):
        return make_superstep(get_model(name), cfg, opt, setup.meta.item_vocab,
                              setup.batch_size, device=device)

    def params(model):
        return {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}

    # the CPU: parameters before each step and after the last; the
    # update replaces the Adam state's tensors, so each state stays
    model, run = setup.model(torch, cfg, "cpu"), run_on("cpu")
    state, snaps, states, losses_cpu = opt.init(model), [], [], []
    for k in range(5):
        snaps.append(params(model))
        states.append(state)
        state, stacked = run(model, state, setup.data_cpu, setup.order_cpu,
                             k, 1)
        losses_cpu.append(stacked["loss"][0].item())
    snaps.append(params(model))
    losses_cpu = torch.tensor(losses_cpu)

    model, run = setup.model(torch, cfg, DEVICE), run_on(DEVICE)
    _, stacked = run(model, opt.init(model), setup.data, setup.order, 0, 5)
    losses = stacked["loss"].cpu()
    loss_err = ((losses - losses_cpu).abs() / losses_cpu.abs()).max().item()
    free = {n: (p - snaps[5][n]).abs().max().item()
            for n, p in params(model).items()}
    free_worst = max(free, key=free.get)
    gap, worst = 0.0, None
    for k in range(5):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snaps[k][n])
        st = states[k]
        run(model, AdamState(st.count,
                             {n: t.to(DEVICE) for n, t in st.mu.items()},
                             {n: t.to(DEVICE) for n, t in st.nu.items()}),
            setup.data, setup.order, k, 1)
        for n, p in params(model).items():
            g = (p - snaps[k + 1][n]).abs().max().item()
            if worst is None or g > gap:
                gap, worst = g, (n, k)
    ok = loss_err <= TRAJ_LOSS_RTOL and gap <= TRAJ_PARAM_ATOL \
        and bool(torch.isfinite(losses).all())
    report = {"losses_gpu": losses.tolist(), "losses_cpu": losses_cpu.tolist(),
              "loss_rel_err": loss_err, "param_max_abs_err": gap,
              "worst_leaf": worst[0], "worst_step": worst[1],
              "free_run_param_max_abs_err": free[free_worst],
              "free_run_worst_leaf": free_worst, "ok": ok}
    print(f"train {name} L={setup.meta.max_seq_len} five f32 steps "
          f"losses={losses.tolist()} loss rel err={loss_err:.3e} param max "
          f"abs err from the CPU's state={gap:.3e} ({worst[0]}, step "
          f"{worst[1]}); free run {free[free_worst]:.3e} ({free_worst}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"training {name} trajectory: {report}")
    return report


def timed_steps(torch, setup, failures, name, want, main_launches,
                steps=20, warm=3, dtypes=("bfloat16", "float32")):
    """The main path: ``steps`` make_superstep steps per dtype after
    ``warm`` warm-up steps, the launch counts from 0 around them (added
    to ``main_launches``), CUDA events around them, the peak memory they
    allocate, then the profiler's device time over 3 more steps.  Masks,
    where the model drops, come from the step's own generator on the
    card.  The setup's order must hold warm + steps + 3 steps."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                         make_superstep)
    report = {}
    for dname in dtypes:
        cfg = setup.cfg(dname, name)
        model = setup.model(torch, cfg, DEVICE)
        opt = make_optimizer(cfg.train)
        run = make_superstep(get_model(name), cfg, opt, setup.meta.item_vocab,
                             setup.batch_size)
        state, _ = run(model, opt.init(model), setup.data, setup.order, 0,
                       warm)
        torch.cuda.synchronize()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, stacked = run(model, state, setup.data, setup.order, warm,
                             steps)
        end.record()
        end.synchronize()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        ms = start.elapsed_time(end) / steps
        _add_launches(main_launches, counts)
        busy = _device_busy(torch, lambda: run(
            model, state, setup.data, setup.order, warm + steps, 3))
        busy_ms = (None if busy["device_busy_ms"] is None
                   else busy["device_busy_ms"] / 3)
        losses = stacked["loss"].cpu()
        ok = counts == want(steps, dname) and bool(
            torch.isfinite(losses).all())
        report[f"timed_{dname}"] = {
            "steps": steps, "ms_per_step": ms,
            "examples_per_s": setup.batch_size / ms * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / ms,
            "peak_memory_bytes": peak,
            "top_kernels": busy["top_kernels"][:5], "launches": counts,
            "losses": losses.tolist(), "ok": ok}
        r = report[f"timed_{dname}"]
        print(f"train {name} {dname:9s} B={setup.batch_size} L="
              f"{setup.meta.max_seq_len} ms/step={ms:.3f} "
              f"examples/s={r['examples_per_s']:.1f} device busy ms/step="
              f"{busy_ms} idle_share={r['idle_share']} peak_mem_GiB="
              f"{peak / 2 ** 30:.3f} launches/{steps} "
              f"steps={counts} {'ok' if ok else 'FAIL'}", flush=True)
        for kname, kms in busy["top_kernels"][:5]:
            print(f"    {kms / 3:9.4f} ms/step  {kname[:90]}", flush=True)
        if not ok:
            failures.append(f"training {name} timed {dname}: launches "
                            f"{counts}")
    return report


# a kernel's earlier design, forced for comparison: the module of
# ops/kernels, its launch function that takes ``_design``, and the design
EARLIER = {"gru_scan_bwd": ("gru_kernel", "_launch_bwd", "four_product"),
           "gru_scan": ("gru_kernel", "_launch", "unit_column"),
           "fused_readout_bwd": ("readout_kernel", "_launch_bwd", "rows"),
           "fused_readout": ("readout_kernel", "_launch", "rows"),
           "fused_attention_blockwise": ("attention_kernel",
                                         "_launch_blockwise", "simt"),
           "scatter_add": ("embedding_kernel", "scatter_add", "segments"),
           "gather": ("embedding_kernel", "gather_rows", "warp_row"),
           "fused_attention_bwd": ("attention_kernel", "_launch_bwd",
                                   "rows"),
           "fused_attention": ("attention_kernel", "_launch", "query"),
           "readout_chain_bwd": ("readout_chain_kernel", "_launch_bwd",
                                 "rows"),
           "readout_chain": ("readout_chain_kernel", "_launch", "rows")}


@contextlib.contextmanager
def forced_design(kernel):
    """Within the block, every launch of ``kernel`` (a key of EARLIER)
    takes its earlier design; the main path never does."""
    import functools
    import importlib

    module, attr, design = EARLIER[kernel]
    mod = importlib.import_module(
        f"mtamrecommender_tpu_torch.ops.kernels.{module}")
    launch = getattr(mod, attr)
    setattr(mod, attr, functools.partial(launch, _design=design))
    try:
        yield
    finally:
        setattr(mod, attr, launch)




UNMODED = ("dtable", "gather", "gather_warp_row", "scatter_add",
           "fused_readout", "fused_readout_bwd", "readout_chain",
           "readout_chain_blocked", "readout_chain_rows",
           "readout_chain_bwd", "readout_chain_bwd_blocked",
           "readout_chain_bwd_rows")


def _add_launches(main_launches, counts):
    for kname, by_mode in counts.items():
        for mode, n in by_mode.items():
            mode = None if kname in UNMODED else mode
            per = main_launches.setdefault(kname, {})
            per[mode] = per.get(mode, 0) + n






def run_training(torch, setup, failures):
    """Phase 4: MTAM's step (its readout through the chain pair), one
    step and five f32 steps against the CPU, then timed in bf16 and f32.
    (Phase 2f holds and times the chain pair's rows designs forced.)"""
    report = {"ids_in_range": setup.ids_in_range}
    if not all(report["ids_in_range"].values()):
        failures.append(f"training ids out of range: {report['ids_in_range']}")
    want = lambda steps, dname: _want_counts(  # noqa: E731
        steps, gru="tgru", chain=True)
    report.update(one_step_check(torch, setup, failures, "MTAM", want))
    report["five_steps_float32"] = five_steps_check(torch, setup, failures,
                                                    "MTAM")
    main_launches = {}
    report.update(timed_steps(torch, setup, failures, "MTAM", want,
                              main_launches))
    return report, main_launches


# ------------------------------------------------------------ phase 5

def run_self_attention(torch, setup, failures):
    """Phase 5: the three self-attention models on phase 4's data.
    Time_Aware_SA as phase 4 checks MTAM; SASrec and TiSAS one step in
    f32 and bf16 with masks drawn on the CPU and injected on both sides,
    then timed with the card's generator; Recommender.recommend for each
    at B = 16 in bf16 against the CPU.  (Phase 2c holds and times the
    attention pair's earlier designs forced.)"""
    from mtamrecommender_tpu_torch.ops import layers

    report, main_launches = {}, {}
    L = setup.meta.max_seq_len
    for name, mode in SELF_ATTENTION.items():
        want = lambda steps, dname, m=mode: _want_counts(  # noqa: E731
            steps, attention=m)
        masks = None
        if mode.endswith("_drop"):
            cpu_gen = torch.Generator().manual_seed(99)
            masks = [layers.draw_drop_mask(cpu_gen, TRAIN_BATCH, L, L, 0.5,
                                           "cpu") for _ in range(3)]
        rep = one_step_check(torch, setup, failures, name, want, masks)
        if masks is None:
            rep["five_steps_float32"] = five_steps_check(torch, setup,
                                                         failures, name)
        rep.update(timed_steps(torch, setup, failures, name, want,
                               main_launches))
        report[name] = rep
    serving, serve_launches = serve_self_attention(torch, setup, failures)
    report["serving"] = serving
    _add_launches(main_launches, serve_launches)
    return report, main_launches


def serve_self_attention(torch, setup, failures):
    """Recommender.recommend for each self-attention model at B = 16 in
    bf16 (the serving config), launch counts around the call (3 forward
    launches of the model's mode, in the tile design; no backward), then
    its scores against the same Recommender on the CPU."""
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.serve import Recommender

    meta, rows = setup.meta, {}
    total = {}
    hists, req = make_histories(np.random.RandomState(16), 16,
                                meta.item_count, meta.category_count,
                                meta.max_seq_len)
    hists[1] = []                                 # an empty history
    for name, mode in SELF_ATTENTION.items():
        cfg = train_cfg("bfloat16", name)
        model = setup.model(torch, cfg, "cpu")
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        _reset_counts()
        recs = rec.recommend(hists, req, k=50)
        torch.cuda.synchronize()
        counts = _counts()
        _add_launches(total, counts)
        base = mode.replace("_drop", "")
        want = _want_counts(0)
        want["fused_attention"][base] = 3
        batch = rec.batch_from_histories(hists, req)
        with torch.no_grad():
            s_gpu = scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                    batch, meta.item_vocab).cpu()
            s_cpu = scores_for_eval(rec_cpu.model_def, rec_cpu._model_c,
                                    cfg.model,
                                    rec_cpu.batch_from_histories(hists, req),
                                    meta.item_vocab)
        # the catalog's columns only: the table is padded to 128 rows, and
        # the padded columns' -2^32+1 would swamp the largest |score|
        vocab = meta.item_vocab
        err, rel = rel_err(s_gpu[:, :vocab], s_cpu[:, :vocab])
        ok = (counts == want and rel <= SLICE_TOL["bfloat16"]
              and bool(torch.isfinite(s_gpu).all())
              and all(len(r) == 50 for r in recs))
        rows[name] = {"launches": counts, "max_abs_score_err": err,
                      "rel_score_err": rel, "tol": SLICE_TOL["bfloat16"],
                      "ok": ok}
        print(f"serve {name} bf16 B=16 launches={counts['fused_attention']} "
              f"max_abs_score_err={err:.3e} rel={rel:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"serving {name}: {rows[name]}")
    return rows, total


# ------------------------------------------------------------ phase 6

LONG_BATCH, LONG_ROWS, LONG_L = 64, 2048, 512
LONG_META = (100, 2000, 18, LONG_L)          # users, items, categories, L


def markov_long_arrays(n_rows, L, items, cats, seed=0):
    """A numpy copy of benchmarks/long_history_bench.markov_long_batchset
    (same draws, same order): every row a full history of L-1 events of a
    sparse random walk over the items (each item has 3 successors), hour
    gaps set by the item, then the mask slot; the target is the walk's
    next step."""
    rng = np.random.RandomState(seed)
    succ = rng.randint(1, items + 1, size=(items + 1, 3))
    gaps = rng.randint(1, 48, size=items + 1).astype(np.float32)
    item_cat = rng.randint(1, cats + 1, size=items + 2).astype(np.int32)
    seq = np.zeros((n_rows, L), np.int32)
    times = np.zeros((n_rows, L), np.float32)
    target = np.zeros((n_rows,), np.int32)
    seq_len = np.full((n_rows,), L, np.int32)
    for r in range(n_rows):
        cur = rng.randint(1, items + 1)
        t = float(rng.randint(0, 1000))
        for i in range(L - 1):
            seq[r, i] = cur
            times[r, i] = t
            cur = succ[cur, rng.randint(3)]
            t += gaps[seq[r, i]]
        target[r] = cur
        seq[r, L - 1] = items + 1                   # mask token
        times[r, L - 1] = t
    cats_arr = item_cat[seq]
    cats_arr[:, L - 1] = cats + 1
    tl = np.zeros_like(times)
    tl[:, 1:] = times[:, 1:] - times[:, :-1]
    tn = times[:, -1:] - times
    pos = np.tile(np.arange(L, dtype=np.int32), (n_rows, 1))
    return dict(user_id=rng.randint(1, 100, n_rows).astype(np.int32),
                items=seq, cats=cats_arr, times=times, time_last=tl,
                time_now=tn, positions=pos, target_id=target,
                target_cat=item_cat[target],
                target_time=times[:, -1].astype(np.float32), seq_len=seq_len)


LONG_OVERRIDES = {"model.time_gate_mode": "scalar",
                  "model.vocab_pad_multiple": 128}


def long_cfg(dname, name="MTAM", L=LONG_L):
    """The long-history cell (benchmarks/long_history_bench.py:113-125):
    MTAM (or ``name``), d=128, 3 hops or blocks, 1 head, the scalar decay
    gate, tables padded to 128 rows, adam (lr 1e-3) clipped to 1.0, the
    default dropout (0.5: SASrec and TiSAS drop attention weights),
    L=512 (or ``L``), B=64."""
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides(**{
        "model.experiment_type": name, "model.num_units": 128,
        "model.num_blocks": 3, "model.num_heads": 1,
        "model.compute_dtype": dname, "model.use_pallas": True,
        "data.max_seq_len": L, "train.train_batch_size": LONG_BATCH,
        **LONG_OVERRIDES})


class LongSetup:
    """The long-history cell: 2048 rows of markov_long_arrays (seed 0) on
    the card and on the CPU, three epoch orders."""

    batch_size = LONG_BATCH
    model = TrainSetup.model

    @staticmethod
    def cfg(dname, name="MTAM"):
        return long_cfg(dname, name)

    def __init__(self, torch):
        from mtamrecommender_tpu_torch.data.device_data import (epoch_order,
                                                                 gather_batch,
                                                                 to_device)
        from mtamrecommender_tpu_torch.types import DatasetMeta

        self.meta = DatasetMeta(*LONG_META)
        arrays = markov_long_arrays(LONG_ROWS, LONG_L, self.meta.item_count,
                                    self.meta.category_count, seed=0)
        self.data = to_device(arrays)               # CUDA: the default
        self.data_cpu = to_device(arrays, device="cpu")
        epochs = [epoch_order(LONG_ROWS, LONG_BATCH,
                              np.random.RandomState(e))[0] for e in range(3)]
        order = np.concatenate(epochs)
        self.order = torch.tensor(order, device=DEVICE)
        self.order_cpu = torch.tensor(order)
        self.batch = gather_batch(self.data, self.order, 0, LONG_BATCH)
        self.batch_cpu = gather_batch(self.data_cpu, self.order_cpu, 0,
                                      LONG_BATCH)
        self.tables, self.ids_in_range = step_tables(self)


def run_long_history(torch, setup, failures):
    """Phase 6: MTAM over long histories.  One step's loss and every
    gradient leaf, and five f32 steps, against the CPU; the step timed in
    bf16 and f32 (1 gru_scan, 1 gru_scan_bwd, 4 dtable, 1 fused_readout,
    1 fused_readout_bwd and no fused_attention launch a step); then
    Recommender.recommend at B = 1, 16, 64 against the CPU (1 gru_scan +
    1 fused_readout a call), the scoring call timed in turns with
    fused_readout forced to its rows design.  (Phase 2d holds and times
    the readout and GRU kernels' earlier designs forced.)"""
    report = {"ids_in_range": setup.ids_in_range}
    if not all(report["ids_in_range"].values()):
        failures.append("long-history ids out of range: "
                        f"{report['ids_in_range']}")
    want = lambda steps, dname: _want_counts(  # noqa: E731
        steps, gru="tgru", readout=True)
    report.update(one_step_check(torch, setup, failures, "MTAM", want))
    report["five_steps_float32"] = five_steps_check(torch, setup, failures,
                                                    "MTAM")
    launches = {}
    report.update(timed_steps(torch, setup, failures, "MTAM", want,
                              launches))
    want_call = _want_counts(0)
    want_call["gru_scan"]["tgru"] = 1
    want_call["fused_readout"]["fused_readout"] = 1
    report["serving"], serve_launches = serve_mtam(
        torch, 10, failures, setup.meta, LONG_OVERRIDES,
        (1, 16, LONG_BATCH), want_call, "long-history serve")
    _add_launches(launches, serve_launches)
    report["serving_in_turns"] = score_in_turns(
        torch, setup, kernel="fused_readout", batch_size=LONG_BATCH)
    return report, launches


# ------------------------------------------------------------ phase 2e

XL_L = 2048                  # the slice past 1024 keys
XL_BLOCKWISE_CASES = ([(bs, 1, tk) for tk in (1025, 2048, 4096)
                       for bs in (1, 16, 64)]
                      + [(bs, XL_L, XL_L) for bs in (1, 16, 64)])
# ragged 64-query tiles and 512-key blocks: (B, Tq = Tk, key lengths)
TILED_RAGGED_CASES = ((3, 1100, (0, 1100, 1037)), (2, 4096, (4096, 2600)))


def xl_att_inputs(torch, gen, dtype, B, Tq, Tk):
    """`att_inputs` with, from B = 3 on, a third row whose live keys end
    inside the first 512-key block (rows 0 and 1: no live key, all)."""
    args = att_inputs(torch, gen, dtype, B=B, Tq=Tq, Tk=Tk)
    if B > 2:
        args[-1][2] = min(300, Tk)
    return args


# the split design's keys a split, probed in turns at B=64, Tk=2048
SPLIT_PROBE = (128, 256, 512)


def _row_alone(args, r):
    """The blockwise operands of batch row r alone (the [Tq, Tk] gate
    parameters are shared by every row)."""
    return [a if 7 <= i <= 11 else a[r:r + 1] for i, a in enumerate(args)]


def time_split(timer, ak, mode, args, iters):
    """At Tq = 1: the split design and the SIMT design, forced, on the
    same inputs in turns (split, simt, simt, split), the profiler's split
    of the split design's device time between its two kernels, and its
    keys a split probed at SPLIT_PROBE in turns (each length twice)."""
    split = lambda: ak.fused_attention_blockwise(mode, *args)  # noqa: E731
    simt = lambda: ak._launch_blockwise(  # noqa: E731
        mode, *args, _design="simt")
    a, b1, b2, a2 = (timer(split, iters), timer(simt, iters),
                     timer(simt, iters), timer(split, iters))
    probe = {n: [] for n in SPLIT_PROBE}
    for _ in range(2):
        for n in SPLIT_PROBE:
            probe[n].append(timer(lambda: ak._launch_blockwise(
                mode, *args, _split=n), iters))
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "simt_ms": (b1 + b2) / 2, "simt_ms_repeats": [b1, b2],
            "passes_ms": timer.passes(split),
            "split_keys": ak.SPLIT_KEYS,
            "split_keys_probe_ms": probe}


def check_blockwise(torch, timer, iters, failures):
    """fused_attention_blockwise in each mode against its plain twin, f32
    and bf16, at Tq = 1 (B = 1, 16, 64 x Tk = 1025, 2048, 4096), Tq = Tk
    = 2048 (B = 1, 16, 64), ragged key lengths, and at the ragged tiles
    of TILED_RAGGED_CASES.  At Tq = 1 every case takes the split design,
    at Tq = Tk bf16 the tensor-core design and f32 the register-tiled
    design: there each case runs twice (the same bits), and the SIMT
    design, forced, is held against the twin beside it; at Tq = 1 rows
    1, 2 and B-1 of each batch also run alone and must give the bits they
    give in the batch.  Timed at B = 64, Tk = 2048 with every key live
    for Tq = Tk (the self-attention blocks: the tiled design and the SIMT
    design, forced) and Tq = 1 (MTAM's hops: the split design and the
    SIMT design in turns, `time_split`), with
    scaled_dot_product_attention beside the plain and tisas modes."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(8642)
    entries = {}
    cases = ([(bs, tq, tk, None) for bs, tq, tk in XL_BLOCKWISE_CASES]
             + [(bs, tk, tk, lens) for bs, tk, lens in TILED_RAGGED_CASES])
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in ak.BLOCKWISE_MODES:
            # per design: max |diff|, max rel, within the tolerance
            agree = {name: [0.0, 0.0, True]
                     for name in ak.BLOCKWISE_DESIGNS}
            same = {}            # per design other than simt: same bits
            tiled, alone_same = None, True
            for bs, tq, tk, lens in cases:
                args = xl_att_inputs(torch, gen, dtype, bs, tq, tk)
                if lens is not None:
                    args[-1].copy_(torch.tensor(lens, dtype=torch.int32))
                design = ak.blockwise_design(dtype, tq, args[0].shape[-1])
                got = ak.fused_attention_blockwise(mode, *args)
                runs = [(design, got)]
                if design in ("mma", "regtile"):
                    tiled = design
                if design != "simt":
                    same[design] = same.get(design, True) and bool(
                        torch.equal(got, ak.fused_attention_blockwise(
                            mode, *args)))
                    runs.append(("simt", ak._launch_blockwise(
                        mode, *args, _design="simt")))
                if design == "split":
                    for r in sorted({1, 2, bs - 1} & set(range(1, bs))):
                        one = ak.fused_attention_blockwise(
                            mode, *_row_alone(args, r))
                        alone_same = alone_same and bool(
                            torch.equal(one[0], got[r]))
                want = ak.fused_attention_blockwise_plain(mode, *args)
                for name, out in runs:
                    e, r, o = _agree(out, want, dname)
                    a = agree[name]
                    a[0], a[1], a[2] = max(a[0], e), max(a[1], r), a[2] and o
                del args, got, runs, want
            for name, (err, rel, ok) in agree.items():
                if name not in ("simt", "split", tiled):
                    continue
                tail = (f" same_bits={same[name]}" if name in same else "")
                if name == "split":
                    tail += f" row_alone_same_bits={alone_same}"
                print(f"fused_attention_blockwise {mode:6s} {dname:9s} "
                      f"{name:7s} max_abs_err={err:.3e} rel={rel:.3e}{tail} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"fused_attention_blockwise {mode} "
                                    f"{dname} {name}: rel err {rel:.3e}")
            for name, twice in same.items():
                if not twice:
                    failures.append(f"fused_attention_blockwise {mode} "
                                    f"{dname} {name}: two launches gave "
                                    "different bits")
            if not alone_same:
                failures.append(f"fused_attention_blockwise {mode} {dname} "
                                "split: a row alone gave other bits than "
                                "in its batch")
            rows = {}
            for tq in (XL_L, 1):
                # every key live, as in the cell's training rows
                args = att_inputs(torch, gen, dtype, B=XL_BATCH, Tq=tq,
                                  Tk=XL_L)
                args[-1].fill_(XL_L)
                design = ak.blockwise_design(dtype, tq, args[0].shape[-1])
                err, rel, ok = agree[design]
                row = {"max_abs_err": err, "rel_err": rel,
                       "tol": KERNEL_TOL[dname], "ok": ok, "Tq": tq,
                       "design": design,
                       "plain_ms": timer(
                           lambda: ak.fused_attention_blockwise_plain(
                               mode, *args), 3, warmup=1),
                       **att_bound(mode, args, dname)}
                if design == "split":
                    row.update(time_split(timer, ak, mode, args, iters))
                    row["same_bits_twice"] = same[design]
                    row["row_alone_same_bits"] = alone_same
                    row["ok"] = ok and same[design] and alone_same
                else:
                    row["ms"] = timer(lambda: ak.fused_attention_blockwise(
                        mode, *args), iters)
                if design not in ("simt", "split"):
                    row["same_bits_twice"] = same[design]
                    row["ok"] = ok and same[design]
                    row["simt_ms"] = timer(lambda: ak._launch_blockwise(
                        mode, *args, _design="simt"), iters)
                library = att_library(torch, mode, args)
                if library is not None:
                    row["library_ms"] = timer(library, iters)
                    row["library_call"] = "scaled_dot_product_attention"
                    del library
                rows[tq] = row
                print(f"fused_attention_blockwise {mode:6s} B={XL_BATCH} "
                      f"Tq={tq:<5d}Tk={XL_L} {dname:9s} {design:7s} ms="
                      f"{row['ms']:.4f} simt_ms={row.get('simt_ms')} "
                      f"plain_ms={row['plain_ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"library_ms={row.get('library_ms')} "
                      f"passes={row.get('passes_ms')} split_keys_probe_ms="
                      f"{row.get('split_keys_probe_ms')}", flush=True)
                del args
            full = rows[XL_L]
            if full["design"] != "simt":
                # the SIMT design's row: its own agreement and forced time
                err, rel, ok = agree["simt"]
                simt = {k: v for k, v in full.items()
                        if k not in ("simt_ms", "same_bits_twice")}
                simt.update(max_abs_err=err, rel_err=rel, ok=ok,
                            design="simt", ms=full["simt_ms"])
                entries[(f"fused_attention_blockwise_{full['design']}",
                         mode, "L2048")] = {dname: full}
                full = simt
            entries.setdefault(("fused_attention_blockwise", mode, "L2048"),
                               {})[dname] = full
            # Tq = 1: MTAM's hops in time mode (their main path), the
            # split design's row with the SIMT design's time beside it
            entries.setdefault(("fused_attention_blockwise_split", mode,
                                "L2048Tq1"), {})[dname] = rows[1]
    return entries


def gather_bound(table, ids):
    """The table rows the ids name read once, the ids read once, the
    output written once; no arithmetic."""
    d = table.shape[1]
    es = table.element_size()
    rows = int(ids.unique().numel())
    n = ids.shape[0]
    return _bound(rows * d * es + 4 * n + n * d * es, 0, "float32")


HOT_ROWS = (131072, 3, 128)   # ids, the rows they name, the padded vocab


def check_gather(torch, timer, iters, failures, gen, dtype, tables, tag,
                 ns_per_add=None):
    """gather_rows (`check_gather_table`) and scatter_add against their
    plain twins on each of a step's four tables with its ids (``tables``:
    name -> (ids, padded vocab)), a random table and cotangent.
    scatter_add as `check_scatter` holds it, each table's chain floor
    at ``ns_per_add``; without it, first the hot-row case (HOT_ROWS: a
    chain longer than any table's), whose chain warp's time an add is
    then taken (its row's "chain_ns_per_add").  Returns the two entry
    rows, each headed by the item table."""
    dname = str(dtype).replace("torch.", "")
    shapes = {"gather": {}, "scatter_add": {}}
    if ns_per_add is None:
        n, rows, vocab = HOT_ROWS
        ids = torch.randint(0, rows, (n,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
        r = shapes["scatter_add"]["hot_rows"] = check_scatter(
            torch, timer, iters, failures, gen, dtype, ids, vocab,
            f"{tag} hot_rows", None)
        ns_per_add = r["passes_ms"].get("columns_sum", 0) * 1e6 / r["max_run"]
        r["chain_ns_per_add"] = ns_per_add
        r["chain_floor_ms"] = r["max_run"] * ns_per_add / 1e6
    for table, (ids, vocab) in tables.items():
        tab = torch.randn((vocab, 128), generator=gen, device=DEVICE).to(dtype)
        shapes["gather"][table] = check_gather_table(
            torch, timer, iters, failures, tab, ids, f"{tag} {table}")
        shapes["scatter_add"][table] = check_scatter(
            torch, timer, iters, failures, gen, dtype, ids, vocab,
            f"{tag} {table}", ns_per_add)
    out = {}
    for kname, by_table in shapes.items():
        head = by_table["item_table"]
        out[kname] = {
            **{k: head[k] for k in ("design", "ms", "plain_ms", "library_ms",
                                    "device_ms", "library_device_ms",
                                    "host_ms", "warp_row_ms",
                                    "warp_row_device_ms",
                                    "warp_row_host_ms",
                                    "segments_ms", "segments_device_ms",
                                    "bound_ms", "bound_by") if k in head},
            "library_call": ("index_select" if kname == "gather"
                             else "index_add_"),
            "max_abs_err": max(r["max_abs_err"] for r in by_table.values()),
            "rel_err": max(r["rel_err"] for r in by_table.values()),
            "tol": KERNEL_TOL[dname],
            "ok": all(r["ok"] for r in by_table.values()),
            "by_table": by_table}
    return out


def _gather_masked_plain(ek, tab, ids):
    """gather_plain with a zero row for each id outside [0, V): what both
    gather designs write on the card."""
    vocab = tab.shape[0]
    want = ek.gather_plain(tab, ids.clamp(0, vocab - 1))
    want[(ids < 0) | (ids >= vocab)] = 0
    return want


def _gather_bad_ids(ids, vocab):
    """``ids`` with every 7th id below 0 and every 11th (from the 4th) at
    or past ``vocab``."""
    bad = ids.clone()
    bad[::7] = -1 - ids[::7]
    bad[3::11] = vocab + ids[3::11]
    return bad


def check_gather_table(torch, timer, iters, failures, tab, ids, tag):
    """gather_rows on one table with ``ids`` in its default design
    ("vector" at d=128): torch.equal to gather_plain, to itself twice and
    to the earlier "warp_row" design forced (``_design="warp_row"``);
    with ids below 0 and at or past V (`_gather_bad_ids`) both designs
    torch.equal to the twin with those rows zero.  The two designs timed
    in turns (vector, warp_row, warp_row, vector: ``ms`` and ``host_ms``
    the first and last, ``warp_row_ms`` and ``warp_row_host_ms`` the
    middle two, ``in_turns`` all four), CUDA events after the L2 flush
    and the host's time a call; the device time a call from one profiler
    window in which every round runs the same turns and index_select,
    each call after the flush, split by kernel (``device_ms``,
    ``warp_row_device_ms``, ``library_device_ms``); index_select's event
    ms (``library_ms``) beside them; ``seconds`` the check's wall time."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    t0 = time.perf_counter()
    dname = str(tab.dtype).replace("torch.", "")
    vocab = tab.shape[0]
    ids64 = ids.long()
    design = ek.gather_design(tab.shape[1] * tab.element_size())
    run = lambda: ek.gather_rows(tab, ids)  # noqa: E731
    old = lambda: ek.gather_rows(tab, ids, _design="warp_row")  # noqa: E731
    plain = lambda: ek.gather_plain(tab, ids)  # noqa: E731
    library = lambda: torch.index_select(tab, 0, ids64)  # noqa: E731
    got, again, forced, want = run(), run(), old(), plain()
    err, rel, ok = _agree(got, want, dname)
    bad = _gather_bad_ids(ids, vocab)
    want_bad = _gather_masked_plain(ek, tab, bad)
    equal = {"plain": bool(torch.equal(got, want)),
             "twice": bool(torch.equal(got, again)),
             "warp_row": bool(torch.equal(got, forced)),
             "invalid_ids": bool(torch.equal(ek.gather_rows(tab, bad),
                                             want_bad)),
             "invalid_ids_warp_row": bool(torch.equal(
                 ek.gather_rows(tab, bad, _design="warp_row"), want_bad))}
    ok = ok and all(equal.values())
    turns = [(d, timer(fn, iters), timer.host(fn))
             for d, fn in (("vector", run), ("warp_row", old),
                           ("warp_row", old), ("vector", run))]

    def in_turns():
        # each call after the flush (the window's own flush precedes the
        # first); the flush's fill is left out of the split
        for fn in (run, old, old, run):
            fn()
            timer.flush.zero_()
        library()

    split = timer.passes(in_turns, iters=20)
    vec, row = split.pop("gather_vector_kernel", None), \
        split.pop("gather_kernel", None)
    r = {"n": int(ids.shape[0]), "vocab": vocab, "design": design,
         "max_abs_err": err, "rel_err": rel, "same_bits_twice": equal["twice"],
         "equal": equal, "ok": ok,
         "ms": (turns[0][1] + turns[3][1]) / 2,
         "warp_row_ms": (turns[1][1] + turns[2][1]) / 2,
         "host_ms": (turns[0][2] + turns[3][2]) / 2,
         "warp_row_host_ms": (turns[1][2] + turns[2][2]) / 2,
         "in_turns": turns,
         "device_ms": None if vec is None else vec / 2,
         "warp_row_device_ms": None if row is None else row / 2,
         "library_device_ms": sum(split.values()) if split else None,
         "library_kernels": sorted(split),
         "plain_ms": timer(plain, 2, warmup=1),
         "library_ms": timer(library, iters), **gather_bound(tab, ids)}
    r["seconds"] = time.perf_counter() - t0
    print(f"gather {tag:22s} n={r['n']:<6d} V={vocab:<5d} {dname:9s} "
          f"design={design} max_abs_err={err:.3e} equal={equal} in turns "
          f"(vector, warp_row, warp_row, vector) ms="
          f"{[round(t[1], 4) for t in turns]} host_ms="
          f"{[round(t[2], 4) for t in turns]} device_ms={r['device_ms']} "
          f"warp_row_device_ms={r['warp_row_device_ms']} index_select ms="
          f"{r['library_ms']:.4f} device_ms={r['library_device_ms']} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"gather {tag} {dname}: rel err {rel:.3e}, equal "
                        f"{equal}")
    return r


GATHER_WIDTHS = (16, 64, 256, 6)     # d = 6: rows of 12 / 24 bytes
GATHER_WIDTH_NS = (1, 33, 4099)


def check_gather_widths(torch, failures):
    """gather_rows at d = 16, 64, 256 ("vector") and 6 ("warp_row") in
    both dtypes, n = 1, 33, 4,099 ids over 1,000 rows with ids below 0
    and past V: torch.equal to the twin with those rows zero, the same
    bits twice, and (in the vector design) to "warp_row" forced; one
    launch a call; the library's gather_design and gather_vector_blocks
    equal to the wrapper's gather_design and gather_grid (on this card's
    SMs and on 132)."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    lib = ek._gather_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEVICE).manual_seed(4242)
    vocab, out = 1000, []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for d in GATHER_WIDTHS:
            rows = []
            tab = torch.randn((vocab, d), generator=gen, device=DEVICE).to(dtype)
            row_bytes = d * tab.element_size()
            design = ek.gather_design(row_bytes)
            plan_ok = (ek.GATHER_DESIGNS[lib.gather_design(row_bytes)]
                       == design)
            for n in GATHER_WIDTH_NS:
                plan_ok = plan_ok and all(
                    lib.gather_vector_blocks(n, row_bytes, m)
                    == ek.gather_grid(n, row_bytes, m) for m in (sms, 132))
                ids = _gather_bad_ids(torch.randint(
                    0, vocab, (n,), generator=gen, device=DEVICE,
                    dtype=torch.int32), vocab)
                want = _gather_masked_plain(ek, tab, ids)
                _reset_counts()
                got, again = ek.gather_rows(tab, ids), ek.gather_rows(tab, ids)
                torch.cuda.synchronize()
                launched = _counts()["gather"]["gather"]
                equal = {"plain": bool(torch.equal(got, want)),
                         "twice": bool(torch.equal(got, again))}
                if design == "vector":
                    equal["warp_row"] = bool(torch.equal(
                        got, ek.gather_rows(tab, ids, _design="warp_row")))
                ok = plan_ok and all(equal.values()) and launched == 2
                rows.append({"d": d, "dtype": dname, "n": n,
                             "design": design, "plan_agrees": plan_ok,
                             "equal": equal, "launches": launched, "ok": ok})
                if not ok:
                    failures.append(f"gather d={d} {dname} n={n} {design}: "
                                    f"plan agrees {plan_ok}, equal {equal}, "
                                    f"launches {launched}")
            out += rows
            print(f"gather widths d={d:<3d} {dname:9s} design={design} "
                  f"n={GATHER_WIDTH_NS} plan agrees={plan_ok} "
                  f"{'ok' if all(r['ok'] for r in rows) else 'FAIL'}",
                  flush=True)
    return out


def check_scatter(torch, timer, iters, failures, gen, dtype, ids, vocab,
                  tag, ns_per_add):
    """scatter_add on ``ids`` and a random cotangent (d=128) in its
    default "columns" design: within KERNEL_TOL of scatter_add_plain and
    torch.equal to it, the same bits twice, and torch.equal to the
    earlier "segments" design forced (``_design="segments"``); the wrapper's
    workspace sizes equal to the kernel's (scatter_workspace_bytes).
    Both designs timed in turns (columns, segments, segments, columns:
    ``ms`` the first and last, ``segments_ms`` the middle two,
    ``in_turns`` all four), their device time a call (``device_ms``,
    ``segments_device_ms``) and split by kernel (``passes_ms``,
    ``segments_passes_ms``, and each split's total) from the profiler,
    and torch.zeros + index_add_ the same ways (``library_ms``,
    ``library_device_ms``).
    The chain floor: the longest run's ids times ``ns_per_add`` (the
    hot-row case's chain warp time an add, measured in this run)."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    dname = str(dtype).replace("torch.", "")
    n = ids.shape[0]
    ct = torch.randn((n, 128), generator=gen, device=DEVICE).to(dtype)
    ids64 = ids.long()
    run = lambda: ek.scatter_add(ct, ids, vocab)  # noqa: E731
    old = lambda: ek.scatter_add(ct, ids, vocab,  # noqa: E731
                                 _design="segments")
    plain = lambda: ek.scatter_add_plain(ct, ids, vocab)  # noqa: E731
    library = lambda: torch.zeros(  # noqa: E731
        (vocab, 128), dtype=dtype, device=DEVICE).index_add_(0, ids64, ct)
    got, again, forced, want = run(), run(), old(), plain()
    err, rel, ok = _agree(got, want, dname)
    same = bool(torch.equal(got, again))
    equal = {"plain": bool(torch.equal(got, want)),
             "segments": bool(torch.equal(got, forced))}
    # the wrapper's workspace plans against the kernel's own layout
    lib = ek._gather_library()
    route, _, ws_bytes = ek.scatter_plan(n, 128, vocab)
    ws_ok = (lib.scatter_workspace_bytes(
        n, vocab, ek.SCATTER_ROUTES.index(route)) == ws_bytes
        and lib.scatter_workspace_bytes(n, vocab, 2)
        == ek._segments_bytes(n, vocab))
    ok = ok and same and all(equal.values()) and ws_ok
    turns = [timer(run, iters), timer(old, iters), timer(old, iters),
             timer(run, iters)]
    max_run = int(torch.bincount(ids64, minlength=vocab).max().item()) \
        if n else 0
    r = {"n": n, "vocab": vocab, "route": route, "max_run": max_run,
         "max_abs_err": err, "rel_err": rel, "same_bits_twice": same,
         "equal": equal, "workspace_agrees": ws_ok, "ok": ok,
         "ms": (turns[0] + turns[3]) / 2,
         "segments_ms": (turns[1] + turns[2]) / 2, "in_turns": turns,
         # the twin's steps are one per occurrence rank: a long run
         # takes seconds, so it is timed once there, and not at all on
         # the hot rows
         "plain_ms": (timer(plain, 2, warmup=1) if max_run < 1000
                      else timer(plain, 1, warmup=0) if max_run < 20000
                      else None),
         "library_ms": timer(library, iters),
         "device_ms": timer.device(run),
         "segments_device_ms": timer.device(old),
         "library_device_ms": timer.device(library),
         "passes_ms": timer.passes(run),
         "segments_passes_ms": timer.passes(old),
         **dtable_bound(ct, ids, vocab)}
    # the split's total beside device_ms: two profiler windows
    r["passes_total_ms"] = sum(r["passes_ms"].values())
    r["segments_passes_total_ms"] = sum(r["segments_passes_ms"].values())
    if ns_per_add is not None:
        r["chain_floor_ms"] = max_run * ns_per_add / 1e6
    print(f"scatter_add {tag:22s} n={n:<6d} V={vocab:<5d} {dname:9s} "
          f"route={r['route']} longest run={max_run} max_abs_err={err:.3e} "
          f"rel={rel:.3e} same_bits={same} equal={equal} in turns "
          f"(columns, segments, segments, columns) ms="
          f"{[round(t, 4) for t in turns]} device_ms={r['device_ms']} "
          f"segments_device_ms={r['segments_device_ms']} index_add_ms="
          f"{r['library_ms']:.4f} index_add_device_ms="
          f"{r['library_device_ms']} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']}) chain_floor_ms={r.get('chain_floor_ms')} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"    passes_ms {r['passes_ms']} (total "
          f"{r['passes_total_ms']:.4f}) segments_passes_ms "
          f"{r['segments_passes_ms']} (total "
          f"{r['segments_passes_total_ms']:.4f})", flush=True)
    if not ok:
        failures.append(f"scatter_add {tag} {dname}: rel err {rel:.3e}, "
                        f"same bits {same}, equal {equal}, workspace "
                        f"plan agrees {ws_ok}")
    return r


def check_xl_kernels(torch, timer, iters, failures, xl_tables, l50_tables):
    """Phase 2e: the blockwise attention kernel, the T-GRU pair at B=64,
    L=2048, dtable at the L=2048 cell's ids, and the gather / scatter-add
    pair at those ids and at phase 4's."""
    entries = check_blockwise(torch, timer, 10, failures)
    gen = torch.Generator(device=DEVICE).manual_seed(9753)
    iters //= 2     # the lookups' timed calls (phase 2b's and 2d's half)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        # the T-GRU pair over MTAM's 2048 steps (phase 7's shape); each
        # twin checked once and timed twice more
        for kname, row in check_gru_long(torch, timer, gen, dtype, XL_L, 10,
                                         1, failures).items():
            entries.setdefault((kname, "tgru", "L2048"), {})[dname] = row
        entries.setdefault(("dtable", None, "L2048"), {})[dname] = \
            check_dtable(torch, timer, iters, failures, gen, dtype,
                         xl_tables, "L=2048")
        ns_per_add = None   # the hot-row case's, at L=2048 first
        for tables, tag in ((xl_tables, "L=2048"), (l50_tables, "L=50")):
            rows = check_gather(torch, timer, iters, failures, gen, dtype,
                                tables, tag, ns_per_add)
            if ns_per_add is None:
                ns_per_add = rows["scatter_add"]["by_table"]["hot_rows"][
                    "chain_ns_per_add"]
            key = dname if tag == "L=2048" else f"{dname}_L50"
            for kname, row in rows.items():
                entries.setdefault((kname, None, "L2048"), {})[key] = row
    return entries


# ------------------------------------------------------------ phase 2f

# (B, L, d): the staged design's L=50 (with the narrow widths) and the
# blocked design's L=150 (phase 14's cell) and L=255
CHAIN_CASES = ([(bs, 50, 128) for bs in (1, 16, 256)]
               + [(16, 50, 16), (16, 50, 64)]
               + [(bs, L, 128) for L in (150, 255) for bs in (1, 16, 64)])
# one hop (NARM+'s and NARM++'s training readout): (B, L, d, every key
# live); phase 4's shape is added
CHAIN_ONE_HOP_CASES = ((1, 50, 128, False), (16, 50, 128, False),
                       (16, 50, 16, False))
# phase 15's readouts at the reference's cap, L=150 with positional wo2
# rows: (B, L, d, every key live); phase 14's shape is added
CHAIN_CAP_CASES = tuple((bs, 150, 128, False) for bs in (1, 16, 64))
# the groups phase 2f holds: (hops, cases, the kernels line's shape, the
# timed (B, L), the wo2 rows: "positional", "scalar", or None for
# positional at L=50, d=128 and scalar elsewhere)
CHAIN_GROUPS = (
    (3, tuple((bs, L, d, False) for bs, L, d in CHAIN_CASES if L <= 64),
     "L50", (TRAIN_BATCH, 50), None),
    (1, CHAIN_ONE_HOP_CASES, "L50h1", (TRAIN_BATCH, 50), None),
    (3, tuple((bs, L, d, False) for bs, L, d in CHAIN_CASES if L > 64),
     "L150", (64, 150), "scalar"),
    # the positional gate at L=150 (MTAM and the time-readout models of
    # phase 15), then NARM+'s / NARM++'s one hop and
    # MTAM_with_T_SeqRec's six hops there
    (3, CHAIN_CAP_CASES, "L150pos", (64, 150), "positional"),
    (1, CHAIN_CAP_CASES, "L150h1", (64, 150), "positional"),
    (6, CHAIN_CAP_CASES, "L150h6", (64, 150), "positional"))
# the staged and blocked designs' templated kernels (phase 1's ptxas
# lines)
CHAIN_FWD_STAGED_KERNELS = ("chain_fwd_staged_kernel",
                            "chain_fwd_blocked_kernel")
CHAIN_BWD_STAGED_KERNELS = ("chain_bwd_query_kernel",
                            "chain_bwd_staged_kernel",
                            "chain_bwd_blocked_kernel")


def chain_inputs(torch, gen, dtype, B, L, d=128, n=3, gate="positional",
                 full=False):
    """The chain readout's operands as MTAM's training step gives them:
    relu'd K and V, the content-time precursor and the decay half of the
    gate at the projections' scale, per-hop weights at glorot scale, wo2
    rows (constant along L for a scalar gate).  Unless ``full``: ragged
    key lengths (the first row full, the third with no live key from
    B = 16 on) and the second row's query masked."""
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    key_len = torch.full((B,), L, dtype=torch.int32, device=DEVICE)
    qz = torch.ones(B, device=DEVICE)
    if not full:
        key_len = torch.randint(1, L + 1, (B,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
        key_len[0] = L
        if B >= 16:
            key_len[2] = 0
        if B > 1:
            qz[1] = 0.0
    if gate == "scalar":
        wo2 = (torch.randn(n, 1, generator=gen, device=DEVICE) * 0.3
               ).expand(n, L).contiguous().to(dtype)
    else:
        wo2 = rand(n, L, scale=0.3)
    return (rand(B, 1, d), key_len, qz, rand(n, B, L, d, scale=0.5).relu(),
            rand(n, B, L, d, scale=0.5).relu(), rand(n, B, L, d, scale=0.3),
            rand(n, B, L, scale=0.5), wo2, rand(n, d, d, scale=d ** -0.5),
            rand(n, d, scale=0.1), (1.0 + rand(n, d, scale=0.1).float()
                                    ).to(dtype), rand(n, d, scale=0.1))


def chain_bound(args, dtype_name):
    """Least time for the forward these inputs need: dec, key_len and qz
    read once; per hop the K and tprec rows and gate_part of the live
    keys and the V rows the weights reach; wo2 and the hop params once;
    out and the f32 hop-input chain written once.  Per hop 2d^2 FLOPs per
    row (q) and 2d per live key twice (q.K, cur.tprec) and per reached
    key once (the weighted sum)."""
    k = args[3]
    n, B, L, d = k.shape
    es = k.element_size()
    n_live, n_span = _readout_keys(args[1], L)
    nbytes = (B * d * es + B * 8
              + n * ((2 * n_live + n_span) * d * es + n_live * es)
              + n * (L + d * d + 3 * d) * es + B * d * es + n * B * d * 4)
    flops = n * (2 * B * d * d + 2 * d * (2 * n_live + n_span))
    return _bound(nbytes, flops, dtype_name)


def chain_bwd_bound(args, dtype_name):
    """Least time for the backward these inputs need: g, key_len, qz and
    the f32 hop-input chain read once, and the forward's reads (live
    keys' K, tprec and gate_part, reached keys' V, wo2, the hop params);
    every cotangent written once (ddec, dk, dv, dt, dgp in the inputs'
    type over all L keys, the f32 parameter sums).  Per hop 6d^2 FLOPs
    per row (the recomputed q, dq_pre Wq^T, cur_c^T dq_pre), the
    forward's 2d per live key twice and per reached key once again, and
    the backward's 2d per live key for dw, dcur's tprec sum and dq, d
    each for dk and dt, d per reached key for dv."""
    k = args[3]
    n, B, L, d = k.shape
    es = k.element_size()
    n_live, n_span = _readout_keys(args[1], L)
    nbytes = (B * d * es + B * 8 + n * B * d * 4
              + n * ((2 * n_live + n_span) * d * es + n_live * es)
              + n * (L + d * d + 3 * d) * es
              + B * d * es + n * B * L * (3 * d + 1) * es
              + n * (L + d * d + 3 * d) * 4)
    flops = n * (6 * B * d * d + 2 * d * (2 * n_live + n_span)
                 + 2 * d * 3 * n_live + 2 * d * n_live + d * n_span)
    return _bound(nbytes, flops, dtype_name)


def _chain_want_design(L, d):
    """The design the wrapper must pick at (L, d): "staged" up to 64
    keys, "blocked" past, at d a multiple of 16; "rows" else."""
    if d % 16:
        return "rows"
    return "staged" if L <= 64 else "blocked"


def check_chain_fwd(torch, rc, args, dname):
    """readout_chain on the card against its twin: the design the wrapper
    picks (it must be `_chain_want_design`'s), two launches the same bits
    (out and curs); where that is the staged or blocked design, also the
    rows design forced on the same inputs, held the same way, and the two
    designs against each other.  Returns (design, curs, {err, rel, ok,
    same, rows_rel, vs_rows_rel, rows_same})."""
    k = args[3]
    design = rc.chain_fwd_design(k.dtype, k.shape[2], k.shape[3])
    want = rc.readout_chain_plain(*args)

    def hold(got, ref):
        err = rel = 0.0
        ok = True
        for a, b in zip(got, ref):
            e, r, o = _agree(a, b, dname)
            err, rel, ok = max(err, e), max(rel, r), ok and o
        return err, rel, ok

    got = rc.readout_chain(*args)
    again = rc.readout_chain(*args)
    err, rel, ok = hold(got, want)
    out = {"err": err, "rel": rel,
           "ok": ok and design == _chain_want_design(*k.shape[2:]),
           "same": all(torch.equal(a, b) for a, b in zip(got, again))}
    if design != "rows":
        rows = rc._launch(args, _design="rows")
        rows_again = rc._launch(args, _design="rows")
        _, out["rows_rel"], rows_ok = hold(rows, want)
        _, out["vs_rows_rel"], both_ok = hold(got, rows)
        out["rows_same"] = all(torch.equal(a, b)
                               for a, b in zip(rows, rows_again))
        out["ok"] = out["ok"] and rows_ok and both_ok and out["rows_same"]
    return design, got[1], out


def time_chain_fwd(timer, rc, args, iters):
    """The forward's time at a timed shape (phase 4's, phase 14's): the
    design the wrapper picks (staged, blocked) and the rows design forced
    on the same inputs in turns (picked, rows, rows, picked), both
    through `_launch` (`_in_turns`), and the host time of a public call
    (`readout_chain`, its operand checks too)."""
    run = lambda: rc._launch(args)  # noqa: E731
    rows = lambda: rc._launch(args, _design="rows")  # noqa: E731
    return {**_in_turns(timer, run, rows, iters),
            "call_host_ms": timer.host(lambda: rc.readout_chain(*args))}


def _in_turns(timer, run, rows, iters):
    """``run`` (the picked design) and ``rows`` (the rows design forced),
    both through the same launch function, in turns (run, rows, rows,
    run) by CUDA events and by the profiler's device time, then each
    one's split by kernel and host time a call."""
    a, b1, b2, a2 = (timer(run, iters), timer(rows, iters),
                     timer(rows, iters), timer(run, iters))
    d, e1, e2, d2 = (timer.device(run), timer.device(rows),
                     timer.device(rows), timer.device(run))
    mean = lambda x, y: None if None in (x, y) else (x + y) / 2  # noqa: E731
    return {"ms": (a + a2) / 2, "ms_repeats": [a, a2],
            "rows_ms": (b1 + b2) / 2, "rows_ms_repeats": [b1, b2],
            "device_ms": mean(d, d2), "device_ms_repeats": [d, d2],
            "rows_device_ms": mean(e1, e2), "rows_device_ms_repeats": [e1, e2],
            "passes_ms": timer.passes(run),
            "rows_passes_ms": timer.passes(rows),
            "host_ms": timer.host(run), "rows_host_ms": timer.host(rows)}


def check_chain_bwd(torch, rc, g, args, curs, dname):
    """readout_chain_bwd on the card against its twin: the design the
    wrapper picks (it must be `_chain_want_design`'s), two launches the
    same bits, every score-side cotangent (dk, dt, dgp) of a row with no
    live key exactly 0; where that is the staged or blocked design, also
    the rows design forced on the same inputs, held the same way, and the
    two designs against each other.  Returns (design, {err, rel, ok,
    same, rows_rel, vs_rows_rel, rows_same})."""
    k = args[3]
    design = rc.chain_bwd_design(k.dtype, k.shape[2], k.shape[3])
    want = rc.readout_chain_bwd_plain(g, *args[1:], curs)
    dead = torch.nonzero(args[1] == 0).flatten()

    def hold(got, ref):
        err = rel = 0.0
        ok = True
        for i, (a, b) in enumerate(zip(got, ref)):
            # dk, dt, dgp: no score gradient in a row with no live key
            e, r, o = _agree(a, b, dname, (slice(None), dead)
                             if ref is want and i in (1, 3, 4)
                             and dead.numel() else None)
            err, rel, ok = max(err, e), max(rel, r), ok and o
        return err, rel, ok

    got = rc.readout_chain_bwd(g, *args[1:], curs)
    again = rc.readout_chain_bwd(g, *args[1:], curs)
    err, rel, ok = hold(got, want)
    out = {"err": err, "rel": rel,
           "ok": ok and design == _chain_want_design(*k.shape[2:]),
           "same": all(torch.equal(a, b) for a, b in zip(got, again))}
    if design != "rows":
        rows = rc._launch_bwd(g, args[1:], curs, _design="rows")
        rows_again = rc._launch_bwd(g, args[1:], curs, _design="rows")
        _, out["rows_rel"], rows_ok = hold(rows, want)
        _, out["vs_rows_rel"], both_ok = hold(got, rows)
        out["rows_same"] = all(torch.equal(a, b)
                               for a, b in zip(rows, rows_again))
        out["ok"] = out["ok"] and rows_ok and both_ok and out["rows_same"]
    return design, out


def time_chain_bwd(timer, rc, g, args, curs, iters):
    """The backward's time at a timed shape: the design the wrapper picks
    and the rows design forced on the same inputs in turns (picked, rows,
    rows, picked), both through `_launch_bwd` (`_in_turns`; each one's
    split by kernel, staged and blocked: the query pass, the per-row
    kernel, the batch sums, dwq; rows: the rows kernel, the batch sums),
    and the host time of a public call (`readout_chain_bwd`, its operand
    checks too)."""
    run = lambda: rc._launch_bwd(g, args[1:], curs)  # noqa: E731
    rows = lambda: rc._launch_bwd(  # noqa: E731
        g, args[1:], curs, _design="rows")
    return {**_in_turns(timer, run, rows, iters),
            "call_host_ms": timer.host(
                lambda: rc.readout_chain_bwd(g, *args[1:], curs))}


def chain_occupancy(rc, dname, bwd, L=50, d=128):
    """The chain forward's (``bwd`` False) or backward's per-row kernel's
    shared memory a block (bytes, static and dynamic) and blocks an SM
    (the occupancy calculator's) at (L, d) in dtype ``dname``, in the
    design picked there (staged or blocked)."""
    is_bf16 = int(dname == "bfloat16")
    design = _chain_want_design(L, d)
    lib = rc._bwd_library() if bwd else rc._library()
    prefix = f"readout_chain{'_bwd' if bwd else ''}_{design}"
    return {"smem_bytes": getattr(lib, f"{prefix}_smem_bytes")(is_bf16, L, d),
            "blocks_per_sm": getattr(lib, f"{prefix}_blocks_per_sm")(
                is_bf16, L, d, 0)}


def check_chain_kernels(torch, timer, iters, failures):
    """Phase 2f: readout_chain and readout_chain_bwd against their plain
    twins in f32 and bf16 at each of CHAIN_GROUPS: CHAIN_CASES at 3 hops
    (positional wo2 rows at L=50, d=128, scalar elsewhere), ONE hop at
    CHAIN_ONE_HOP_CASES (NARM+'s and NARM++'s readout at L=50), and
    CHAIN_CAP_CASES (L=150, positional wo2 rows: phase 15's readouts) at
    3, 1 and 6 hops (MTAM_with_T_SeqRec's preset); ragged keys, one row
    with no live key from B=16 on, one masked query; each in the design
    the wrapper must pick ("staged" at L=50, "blocked" at L=150 and 255),
    two launches of each bit-equal, and the rows design forced beside it,
    held and bit-equal the same way: the forward's output and hop-input
    chain (`check_chain_fwd`), the backward's ten cotangents from the
    kernel's chain, every score-side cotangent of a row with no live key
    exactly 0 (`check_chain_bwd`); timed, with the twins beside them, at
    phase 4's shape (B=256, L=50, d=128, every key live; 3 hops:
    ``@L50``, 1 hop: ``@L50h1``) and at phase 14's (B=64, L=150, every key
    live: ``@L150`` scalar, ``@L150pos`` positional, ``@L150h1`` and
    ``@L150h6``), each kernel's picked and rows designs in turns with
    the profiler's split by kernel (`time_chain_fwd`, `time_chain_bwd`)
    and its per-row kernel's shared memory and blocks an SM."""
    from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as rc

    gen = torch.Generator(device=DEVICE).manual_seed(97531)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for hops, cases, shape, (t_batch, t_len), wo2 in CHAIN_GROUPS:
            fwd = {"err": 0.0, "rel": 0.0, "ok": True, "same": True,
                   "rows_rel": 0.0, "vs_rows_rel": 0.0, "rows_same": True}
            bwd = dict(fwd)
            for bs, L, d, full in cases + ((t_batch, t_len, 128, True),):
                gate = wo2 or ("positional" if L == 50 and d == 128
                               else "scalar")
                args = chain_inputs(torch, gen, dtype, bs, L, d, n=hops,
                                    gate=gate, full=full)
                fwd_design, curs, fgot = check_chain_fwd(torch, rc, args,
                                                         dname)
                fwd = _merge_chain(fwd, fgot)
                g = torch.randn((bs, d), generator=gen,
                                device=DEVICE).to(dtype)
                design, got = check_chain_bwd(torch, rc, g, args, curs,
                                              dname)
                bwd = _merge_chain(bwd, got)
                for what, x, dz in (("fwd", fgot, fwd_design),
                                    ("bwd", got, design)):
                    rows_part = (f" rows rel={x['rows_rel']:.3e} "
                                 f"{dz}-rows rel={x['vs_rows_rel']:.3e} "
                                 f"rows_same_bits={x['rows_same']}"
                                 if "rows_rel" in x else "")
                    print(f"readout_chain {what} n={hops} B={bs:<3d} "
                          f"L={L:<3d} d={d:<3d} {gate:10s} {dname:9s} "
                          f"design={dz:7s} rel={x['rel']:.3e} "
                          f"same_bits={x['same']}{rows_part} "
                          f"{'ok' if x['ok'] else 'FAIL'}", flush=True)
            # args, g and curs are the timed shape now, every key live
            rows = _chain_rows(torch, timer, rc, dtype, dname, args, g,
                               curs, fwd, bwd, iters)
            for kname, row in rows.items():
                entries.setdefault((kname, None, shape), {})[dname] = row
                extra = "".join(
                    f" {k}={row[k]:.4f}" if isinstance(row.get(k), float)
                    else f" {k}={row[k]}" for k in (
                        "design", "device_ms", "host_ms", "call_host_ms",
                        "rows_ms", "rows_device_ms",
                        "rows_host_ms", "passes_ms", "rows_passes_ms",
                        "smem_bytes", "blocks_per_sm") if k in row)
                print(f"{kname} n={hops} B={t_batch} L={t_len} {dname:9s} "
                      f"max_abs_err={row['max_abs_err']:.3e} rel="
                      f"{row['rel_err']:.3e} ms={row['ms']:.4f} plain_ms="
                      f"{row['plain_ms']:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} ({row['bound_by']}){extra} "
                      f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
                if not row["ok"]:
                    failures.append(f"{kname} {hops} hops {shape} {dname}: "
                                    f"rel err {row['rel_err']:.3e}, same "
                                    f"bits {row['same_bits_twice']}, rows "
                                    f"design {row['rows_rel_err']:.3e} "
                                    f"{row['rows_same_bits_twice']}")
    return entries


def _chain_rows(torch, timer, rc, dtype, dname, args, g, curs, fwd, bwd,
                iters):
    """The kernels line's rows of the chain pair at a timed shape
    (``args``, ``g``, ``curs``: phase 4's or phase 14's), with the worst
    figures of the checks before (``fwd``, ``bwd``)."""
    L = args[3].shape[2]
    return {
        "readout_chain": {
            "design": rc.chain_fwd_design(dtype, L, 128),
            "max_abs_err": fwd["err"], "rel_err": fwd["rel"],
            "tol": KERNEL_TOL[dname], "ok": fwd["ok"] and fwd["same"],
            "same_bits_twice": fwd["same"],
            "rows_rel_err": fwd["rows_rel"],
            "vs_rows_rel_err": fwd["vs_rows_rel"],
            "rows_same_bits_twice": fwd["rows_same"],
            **time_chain_fwd(timer, rc, args, iters),
            **chain_occupancy(rc, dname, bwd=False, L=L),
            "plain_ms": timer(lambda: rc.readout_chain_plain(*args),
                              max(iters // 10, 3)),
            **chain_bound(args, dname)},
        "readout_chain_bwd": {
            "design": rc.chain_bwd_design(dtype, L, 128),
            "max_abs_err": bwd["err"], "rel_err": bwd["rel"],
            "tol": KERNEL_TOL[dname], "ok": bwd["ok"] and bwd["same"],
            "same_bits_twice": bwd["same"],
            "rows_rel_err": bwd["rows_rel"],
            "vs_rows_rel_err": bwd["vs_rows_rel"],
            "rows_same_bits_twice": bwd["rows_same"],
            **time_chain_bwd(timer, rc, g, args, curs, iters),
            **chain_occupancy(rc, dname, bwd=True, L=L),
            "plain_ms": timer(lambda: rc.readout_chain_bwd_plain(
                g, *args[1:], curs), max(iters // 10, 3)),
            **chain_bwd_bound(args, dname)}}


def _merge_chain(acc, got):
    """The worst of `check_chain_fwd`'s or `check_chain_bwd`'s figures so
    far (``acc``) and one case's (``got``)."""
    return {"err": max(acc["err"], got["err"]),
            "rel": max(acc["rel"], got["rel"]),
            "ok": acc["ok"] and got["ok"],
            "same": acc["same"] and got["same"],
            "rows_rel": max(acc["rows_rel"], got.get("rows_rel", 0.0)),
            "vs_rows_rel": max(acc["vs_rows_rel"],
                               got.get("vs_rows_rel", 0.0)),
            "rows_same": acc["rows_same"] and got.get("rows_same", True)}


# ------------------------------------------------------------ phase 7

XL_BATCH, XL_ROWS, XL_SMALL = 64, 256, 2
XL_META = (100, 2000, 18, XL_L)              # users, items, categories, L
# the four models and the blockwise mode each serves with
XL_MODELS = {"MTAM": "time", "SASrec": "plain",
             "Ti_Self_Attention_Model": "tisas",
             "Time_Aware_Self_Attention_Model": "time"}


def _blockwise_count(dname, tq):
    """The counter a blockwise launch at L=2048 adds to: self-attention
    (Tq = Tk) takes the tensor-core design in bf16 and the register-tiled
    design in f32, MTAM's hops (Tq = 1) the split design."""
    if tq == 1:
        return "fused_attention_blockwise_split"
    return ("fused_attention_blockwise_mma" if dname == "bfloat16"
            else "fused_attention_blockwise_regtile")


class XLSetup:
    """The slice past 1024 keys: the long-history cell
    (benchmarks/long_history_bench.py's run) at L=2048, 256 rows of its
    Markov-walk data (seed 0; the bench's 2048 rows cut to 256: the walk
    is built by a Python loop, ~4 M steps at 2048 rows) on the card and on
    the CPU, three epoch orders.  ``batch`` and ``batch_cpu`` are the
    first XL_SMALL rows, the size the CPU comparisons can afford at this
    length; ``tables`` hold the first full batch's ids."""

    batch_size = XL_BATCH
    model = TrainSetup.model

    @staticmethod
    def cfg(dname, name="MTAM"):
        return long_cfg(dname, name, L=XL_L)

    def __init__(self, torch):
        from mtamrecommender_tpu_torch.data.device_data import (epoch_order,
                                                                 gather_batch,
                                                                 to_device)
        from mtamrecommender_tpu_torch.types import DatasetMeta

        self.meta = DatasetMeta(*XL_META)
        arrays = markov_long_arrays(XL_ROWS, XL_L, self.meta.item_count,
                                    self.meta.category_count, seed=0)
        self.data = to_device(arrays)               # CUDA: the default
        self.data_cpu = to_device(arrays, device="cpu")
        epochs = [epoch_order(XL_ROWS, XL_BATCH,
                              np.random.RandomState(e))[0] for e in range(3)]
        order = np.concatenate(epochs)
        self.order = torch.tensor(order, device=DEVICE)
        self.order_cpu = torch.tensor(order)
        self.full = gather_batch(self.data, self.order, 0, XL_BATCH)
        self.tables, self.ids_in_range = step_tables(self, self.full)
        self.batch = gather_batch(self.data, self.order, 0, XL_SMALL)
        self.batch_cpu = gather_batch(self.data_cpu, self.order_cpu, 0,
                                      XL_SMALL)


def serve_xl(torch, failures, setup, name, want, main_launches,
             held_at_each=False, batches=(1, 16, XL_BATCH),
             dtypes=("bfloat16", "float32")):
    """Recommender.recommend for ``name`` at the setup's L (phase 7's
    2048; phase 13's 256; phases 14-15's 150) for B in ``batches`` in
    each of ``dtypes``: the launches of one call, counted from 0, against
    ``want(dtype name)`` (added to ``main_launches``), and the time per
    request batch; the scores against the same Recommender on the CPU at
    B = XL_SMALL (the CPU's time at L=2048 sets that size), or with
    ``held_at_each`` at each B."""
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.serve import Recommender

    meta, vocab, rows = setup.meta, setup.meta.item_vocab, []
    L = meta.max_seq_len

    def against_cpu(rec, rec_cpu, cfg, dname, hists, req):
        """(max |diff|, rel, top-k ok, all ok) of the scores."""
        with torch.no_grad():
            s_gpu = scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                    rec.batch_from_histories(hists, req),
                                    vocab).cpu()
            s_cpu = scores_for_eval(rec_cpu.model_def, rec_cpu._model_c,
                                    cfg.model,
                                    rec_cpu.batch_from_histories(hists, req),
                                    vocab)
        err, rel = rel_err(s_gpu[:, :vocab], s_cpu[:, :vocab])
        tol_abs = SLICE_TOL[dname] * s_cpu[:, :vocab].abs().max().item()
        picked = torch.gather(s_cpu, 1, torch.topk(s_gpu, 50, dim=1).indices)
        topk_ok = bool((picked >= torch.topk(s_cpu, 50, dim=1).values[:, -1:]
                        - tol_abs).all())
        return err, rel, topk_ok, (bool(torch.isfinite(s_gpu).all())
                                   and topk_ok and rel <= SLICE_TOL[dname])

    hists2, req2 = make_histories(np.random.RandomState(XL_SMALL), XL_SMALL,
                                  meta.item_count, meta.category_count, L)
    for dname in dtypes:
        cfg = setup.cfg(dname, name)
        model = setup.model(torch, cfg, "cpu")
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        if not held_at_each:
            err, rel, topk_ok, scores_ok = against_cpu(rec, rec_cpu, cfg,
                                                       dname, hists2, req2)
            print(f"serve {name} L={L} {dname:9s} B={XL_SMALL} against the "
                  f"CPU: max_abs_score_err={err:.3e} rel={rel:.3e} "
                  f"topk_ok={topk_ok} {'ok' if scores_ok else 'FAIL'}",
                  flush=True)
            if not scores_ok:
                failures.append(f"serve {name} L={L} {dname}: rel score "
                                f"err {rel:.3e}, top-k {topk_ok}")
        for bs in batches:
            hists, req = make_histories(np.random.RandomState(bs), bs,
                                        meta.item_count, meta.category_count,
                                        L)
            if bs > 1:
                hists[1] = []                  # an empty history
            _reset_counts()
            recs = rec.recommend(hists, req, k=50)
            torch.cuda.synchronize()
            got = _counts()
            _add_launches(main_launches, got)
            ok = (got == want(dname) and len(recs) == bs
                  and all(len(r) == 50 for r in recs)
                  and all(math.isfinite(s) for r in recs for _, s in r))
            if held_at_each:
                err, rel, topk_ok, scores_ok = against_cpu(
                    rec, rec_cpu, cfg, dname, hists, req)
                held = {"max_abs_score_err": err, "rel_score_err": rel,
                        "topk_ok": topk_ok}
            else:
                held = {"max_abs_score_err_b2": err, "rel_score_err_b2": rel,
                        "topk_ok_b2": topk_ok}
            batch = rec.batch_from_histories(hists, req)
            fetch = min(50 + L, vocab)
            recommend_ms = _host_ms(torch, lambda: rec.recommend(
                hists, req, k=50), 3)
            score_ms = _event_ms(torch, lambda: rec._score_impl(batch, fetch),
                                 3)
            busy = _device_busy(torch, lambda: rec._score_impl(batch, fetch))
            row = {"model": name, "compute_dtype": dname, "batch": bs,
                   "k": 50, "seq_len": L, "launches_per_call": got,
                   "launches_ok": got == want(dname), **held,
                   "tol": SLICE_TOL[dname],
                   "recommend_ms": recommend_ms, "score_topk_ms": score_ms,
                   **busy, "idle_share": (None if busy["device_busy_ms"] is None
                                          else 1 - busy["device_busy_ms"]
                                          / score_ms),
                   "ok": ok and scores_ok}
            rows.append(row)
            fired = {k: {m: n for m, n in v.items() if n}
                     for k, v in got.items()}
            print(f"serve {name} L={L} {dname:9s} B={bs:<3d} launches="
                  f"{ {k: v for k, v in fired.items() if v} } recommend_ms="
                  f"{recommend_ms:.3f} score_topk_ms={score_ms:.3f} "
                  f"device_busy_ms={busy['device_busy_ms']}"
                  + (f" max_abs_score_err={err:.3e} rel={rel:.3e} topk_ok="
                     f"{topk_ok}" if held_at_each else "")
                  + f" {'ok' if row['ok'] else 'FAIL'}", flush=True)
            for kname, kms in busy["top_kernels"][:4]:
                print(f"    {kms:9.4f} ms  {kname[:90]}", flush=True)
            if not row["ok"]:
                failures.append(f"serve {name} L={L} {dname} B={bs}: "
                                f"launches {got}, scores {held}")
    return rows


def score_in_turns(torch, setup, name="MTAM", kernel="gru_scan",
                   batch_size=XL_BATCH):
    """``name``'s scoring call at the setup's L and B=``batch_size`` (from
    B = 2 on an empty history in it)
    in bf16 and f32, timed in turns with ``kernel`` forced to its earlier
    design (EARLIER; default, earlier, earlier, default): CUDA events over
    5 calls and the profiler's device time of one.  Not a main-path run:
    its launches are not counted."""
    from mtamrecommender_tpu_torch.serve import Recommender

    meta = setup.meta
    design = EARLIER[kernel][2]
    hists, req = make_histories(np.random.RandomState(batch_size),
                                batch_size, meta.item_count,
                                meta.category_count, meta.max_seq_len)
    if batch_size > 1:
        hists[1] = []
    fetch = min(50 + meta.max_seq_len, meta.item_vocab)
    rows = {}
    for dname in ("bfloat16", "float32"):
        cfg = setup.cfg(dname, name)
        rec = Recommender(cfg, meta, setup.model(torch, cfg, DEVICE),
                          device=DEVICE)
        batch = rec.batch_from_histories(hists, req)
        score = lambda: rec._score_impl(batch, fetch)  # noqa: E731
        rows[dname] = []
        for turn in ("default", design, design, "default"):
            with (forced_design(kernel) if turn == design
                  else contextlib.nullcontext()):
                ms = _event_ms(torch, score, 5)
                busy = _device_busy(torch, score)["device_busy_ms"]
            rows[dname].append({kernel: turn, "score_topk_ms": ms,
                                "device_busy_ms": busy})
        print(f"serve {name} L={meta.max_seq_len} {dname:9s} B={batch_size}"
              f" in turns ({kernel} default, {design}, {design}, default): "
              f"score_topk_ms={[r['score_topk_ms'] for r in rows[dname]]} "
              f"device_busy_ms={[r['device_busy_ms'] for r in rows[dname]]}",
              flush=True)
    return rows


def check_gather_seam(torch, setup, failures, main_launches):
    """behavior_embedding(gather=embedding_kernel.gather) forward and
    backward on the cell's first batch (B=64, f32) against its default
    lookup, take_dtable, on the card: the same rows, and each table's
    gradient (rounded after every add there, summed in f32 here) within
    KERNEL_TOL; 4 gather + 4 scatter_add launches and no dtable.  Then
    timed in turns with the earlier scatter_add design (`seam_in_turns`)."""
    from mtamrecommender_tpu_torch.ops.embedding import behavior_embedding
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    model = setup.model(torch, setup.cfg("float32"), DEVICE)
    w = torch.randn((XL_BATCH, XL_L, 128), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(5))
    outs, grads = [], []
    for gather in (None, ek.gather):
        emb = copy.deepcopy(model.embedding)
        _reset_counts()
        e = behavior_embedding(emb, setup.full, gather=gather)
        ((e.behavior_emb * w).sum()
         + sum(x.square().sum() for x in (e.user_emb, e.item_emb,
                                          e.cat_emb))).backward()
        torch.cuda.synchronize()
        counts = _counts()
        outs.append(e)
        grads.append({n: p.grad for n, p in emb.named_parameters()})
    _add_launches(main_launches, counts)
    in_turns = seam_in_turns(torch, setup, model, w)
    same_rows = all(torch.equal(a, b) for a, b in zip(*outs))
    rel = {n: rel_err(grads[1][n], g)[1] for n, g in grads[0].items()}
    launches_ok = (counts["gather"]["gather"] == 4
                   and counts["gather_warp_row"]["gather_warp_row"] == 0
                   and counts["scatter_add"]["scatter_add"] == 4
                   and counts["dtable"]["dtable"] == 0)
    ok = same_rows and launches_ok and max(rel.values()) <= \
        KERNEL_TOL["float32"]
    print(f"behavior_embedding(gather=) B={XL_BATCH} L={XL_L} f32 same rows="
          f"{same_rows} grad rel err {rel} launches gather="
          f"{counts['gather']} scatter_add={counts['scatter_add']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"behavior_embedding(gather=): same rows {same_rows}"
                        f", grad rel err {rel}, launches {counts}")
    return {"same_rows": same_rows, "grad_rel_err": rel,
            "launches": counts, "ok": ok, "seam_in_turns": in_turns}


def seam_in_turns(torch, setup, model, w, iters=10):
    """The seam's forward and backward (as check_gather_seam runs it, f32)
    timed in turns with scatter_add forced to its earlier segments design
    and then with gather forced to its earlier warp_row design (default,
    segments, segments, default, warp_row, warp_row, default): CUDA-event
    ms a call after the L2 flush and the profiler's device ms a call.
    Not counted as main-path launches."""
    from mtamrecommender_tpu_torch.ops.embedding import behavior_embedding
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek

    emb = copy.deepcopy(model.embedding)
    params = list(emb.parameters())

    def step():
        e = behavior_embedding(emb, setup.full, gather=ek.gather)
        loss = ((e.behavior_emb * w).sum()
                + sum(x.square().sum() for x in (e.user_emb, e.item_emb,
                                                 e.cat_emb)))
        return torch.autograd.grad(loss, params)

    timer = Timer(torch)
    rows = []
    turns = ("default", "segments", "segments", "default", "warp_row",
             "warp_row", "default")
    for turn in turns:
        with (forced_design("scatter_add") if turn == "segments"
              else forced_design("gather") if turn == "warp_row"
              else contextlib.nullcontext()):
            rows.append({"design": turn, "ms": timer(step, iters),
                         "device_ms": timer.device(step, iters)})
    print(f"behavior_embedding(gather=) fwd+bwd B={XL_BATCH} L={XL_L} f32 "
          f"in turns {turns}: ms={[round(r['ms'], 4) for r in rows]} "
          f"device_ms={[r['device_ms'] for r in rows]}", flush=True)
    return rows


def run_xl_history(torch, setup, failures):
    """Phase 7: past 1024 keys, at L=2048.  Recommender.recommend for the
    four models (MTAM: 1 gru_scan + 3 fused_attention_blockwise[time] a
    call; each self-attention model 3 blockwise launches in its mode, the
    tensor-core design in bf16 and the register-tiled design in f32, as
    `_blockwise_count` names them);
    Time_Aware_SA's step (one step against the CPU at B = XL_SMALL; timed
    at B = 64 in bf16 and f32: 3 blockwise[time] + 3 dense_bwd[time] + 4
    dtable a step); MTAM's the same way (1 gru_scan + 1 gru_scan_bwd + 4
    dtable a step); SASrec's and TiSAS's at dropout 0.5 (CPU masks
    injected; 3 dense_fwd a step, no attention kernel; timed in bf16);
    the gather seam.  Returns (report, launches by main-path shape:
    "L2048Tq1" MTAM's serving and training, "L2048" the self-attention
    blocks and the lookups)."""
    from mtamrecommender_tpu_torch.ops import layers

    report = {"ids_in_range": setup.ids_in_range, "serving": {},
              "training": {}}
    if not all(setup.ids_in_range.values()):
        failures.append(f"L={XL_L} ids out of range: {setup.ids_in_range}")
    hops, blocks = {}, {}
    for name, mode in XL_MODELS.items():
        def want(dname, name=name, mode=mode):
            # MTAM's hops: Tq = 1, the split design in both dtypes
            tq = 1 if name == "MTAM" else XL_L
            counts = _want_counts(0)
            counts[_blockwise_count(dname, tq)][mode] = 3
            if name == "MTAM":
                counts["gru_scan"]["tgru"] = 1
            return counts
        report["serving"][name] = serve_xl(
            torch, failures, setup, name, want,
            hops if name == "MTAM" else blocks)
    report["mtam_serving_in_turns"] = score_in_turns(torch, setup)
    # the hops' split design against the SIMT design, forced
    report["mtam_serving_blockwise_in_turns"] = {
        bs: score_in_turns(torch, setup, kernel="fused_attention_blockwise",
                           batch_size=bs) for bs in (1, XL_BATCH)}
    name = "Time_Aware_Self_Attention_Model"

    def want(steps, dname):
        counts = _want_counts(steps, dense_bwd="time")
        counts[_blockwise_count(dname, XL_L)]["time"] = 3 * steps
        return counts

    rep = one_step_check(torch, setup, failures, name, want,
                         hold_bf16_scalars=False)
    rep.update(timed_steps(torch, setup, failures, name, want, blocks,
                           steps=3, warm=1))
    report["training"][name] = rep
    # MTAM: the readout in plain PyTorch (single_query_readout), the GRU
    # scan and its backward over 2048 steps
    want = lambda steps, dname: _want_counts(steps, gru="tgru")  # noqa: E731
    rep = one_step_check(torch, setup, failures, "MTAM", want,
                         hold_bf16_scalars=False)
    rep.update(timed_steps(torch, setup, failures, "MTAM", want, hops,
                           steps=3, warm=1))
    report["training"]["MTAM"] = rep
    for name, mode in (("SASrec", "plain_drop"),
                       ("Ti_Self_Attention_Model", "tisas_drop")):
        want = lambda steps, dname, m=mode: _want_counts(  # noqa: E731
            steps, dense_fwd=m)
        cpu_gen = torch.Generator().manual_seed(99)
        masks = [layers.draw_drop_mask(cpu_gen, XL_SMALL, XL_L, XL_L, 0.5,
                                       "cpu") for _ in range(3)]
        rep = one_step_check(torch, setup, failures, name, want, masks)
        rep.update(timed_steps(torch, setup, failures, name, want, blocks,
                               steps=3, warm=1, dtypes=("bfloat16",)))
        report["training"][name] = rep
    report["gather_seam"] = check_gather_seam(torch, setup, failures, blocks)
    return report, {"L2048Tq1": hops, "L2048": blocks}


# ------------------------------------------------------------ phase 8

# held-out rows for phase 8's evaluation: make_train_arrays(meta, 3000,
# seed=1), two batches of train.test_batch_size (2,048; the second 952
# live rows and 1,096 pad slots)
EVAL_ROWS = 3000
# card vs CPU from the same checkpoint: every HR@k / NDCG@k within
# EVAL_ATOL; in f32 at least EVAL_RANKS_EQUAL of the live rows' ranks equal
EVAL_ATOL = {"float32": 0.005, "bfloat16": 0.02}
EVAL_RANKS_EQUAL = 0.99
# serve.main's answers against in-process recommend (scores rounded to 5
# places by main)
SERVE_MAIN_ATOL = 1e-5


def _params_differ(torch, a, b):
    """The names of the parameters of models ``a`` and ``b`` whose
    values differ (compared on the CPU, bit for bit)."""
    pb = dict(b.named_parameters())
    return [n for n, p in a.named_parameters()
            if not torch.equal(p.detach().cpu(), pb[n].detach().cpu())]


def _adam_differ(torch, a, b):
    """The Adam leaves (``mu.<name>``, ``nu.<name>``) that differ, and
    ``count`` where the counts do."""
    bad = [] if a.count == b.count else ["count"]
    for key in ("mu", "nu"):
        mb = getattr(b, key)
        bad += [f"{key}.{n}" for n, t in getattr(a, key).items()
                if not torch.equal(t.cpu(), mb[n].cpu())]
    return bad


def _kernel_launches(torch, fn):
    """The profiler's launch count of each CUDA kernel ``fn`` launches in
    one call, by kernel function name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.count:
            found = re.search(r"(\w+_kernel)\b", e.key)
            name = found.group(1) if found else e.key[:60]
            counts[name] = counts.get(name, 0) + e.count
    return counts


def _resume_check(torch, setup, cfg, dname, ckpt_dir, failures):
    """6 unbroken steps against 3 steps, a save, a restore (`full`) into
    a fresh model on the card and 3 more steps; `fine_tune` and a restore
    on the CPU from the same step.  Returns (report, the resumed
    TrainState after 6 steps, the launches of the 12 steps)."""
    from mtamrecommender_tpu_torch.data.device_data import gather_batch
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.checkpoint import (Checkpointer,
                                                            apply_load_type)
    from mtamrecommender_tpu_torch.train.trainer import (TrainState,
                                                         make_optimizer,
                                                         make_train_step)

    vocab, bs = setup.meta.item_vocab, setup.batch_size
    opt = make_optimizer(cfg.train)

    def fresh(device, seed=1):
        model = get_model("MTAM").init(torch.Generator().manual_seed(seed),
                                       cfg.model, setup.meta).to(device)
        return TrainState(model, opt.init(model), 0)

    def steps(model, state, start, n):
        step = make_train_step(get_model("MTAM"), cfg, opt, vocab,
                               device=DEVICE)
        losses = []
        for k in range(start, start + n):
            state, m = step(model, state,
                            gather_batch(setup.data, setup.order, k, bs))
            losses.append(m["loss"])
        return state, torch.stack(losses).cpu()

    _reset_counts()
    unbroken = setup.model(torch, cfg, DEVICE)
    st_a, losses_a = steps(unbroken, opt.init(unbroken), 0, 6)
    first = setup.model(torch, cfg, DEVICE)
    st_b, losses_b = steps(first, opt.init(first), 0, 3)
    ckpt = Checkpointer(ckpt_dir)
    t0 = time.perf_counter()
    ckpt.save(TrainState(first, st_b, 3))
    save_s = time.perf_counter() - t0
    full = cfg.with_overrides(**{"train.load_type": "full"})
    t0 = time.perf_counter()
    resumed = apply_load_type(full.train, fresh(DEVICE), ckpt_dir)
    restore_s = time.perf_counter() - t0
    st_c, losses_c = steps(resumed.model, resumed.opt_state, 3, 3)
    torch.cuda.synchronize()
    launches = _counts()
    params_differ = _params_differ(torch, resumed.model, unbroken)
    adam_differ = _adam_differ(torch, st_c, st_a)
    losses_equal = torch.equal(torch.cat([losses_b, losses_c]), losses_a)
    # fine_tune: the step-3 parameters, Adam zero, step 0
    tune = cfg.with_overrides(**{"train.load_type": "fine_tune",
                                 "train.fine_tune_load_path": ckpt_dir})
    tuned = apply_load_type(tune.train, fresh(DEVICE, 2), "unused",
                            optimizer_init=opt.init)
    tune_ok = (tuned.step == 0 and tuned.opt_state.count == 0
               and not _params_differ(torch, tuned.model, first)
               and not any(bool(t.any()) for key in ("mu", "nu")
                           for t in getattr(tuned.opt_state, key).values()))
    # the card's checkpoint restored on the CPU
    on_cpu = ckpt.restore(fresh("cpu"))
    cpu_ok = (on_cpu.step == 3
              and next(on_cpu.model.parameters()).device.type == "cpu"
              and not _params_differ(torch, on_cpu.model, first)
              and not _adam_differ(torch, on_cpu.opt_state, st_b))
    # the resumed run, saved for evaluation and serving
    ckpt.save(TrainState(resumed.model, st_c, 6))
    ok = (not params_differ and not adam_differ and losses_equal
          and resumed.step == 3 and tune_ok and cpu_ok
          and ckpt.all_steps() == [3, 6]
          and launches == _want_counts(12, gru="tgru", chain=True))
    report = {"params_differ": params_differ, "adam_differ": adam_differ,
              "losses_equal": losses_equal, "losses": losses_a.tolist(),
              "fine_tune_ok": tune_ok, "restored_on_cpu_ok": cpu_ok,
              "save_s": save_s, "restore_s": restore_s,
              "launches_12_steps": launches, "ok": ok}
    print(f"disk {dname:9s} resume: 3 + save/restore + 3 steps vs 6 "
          f"unbroken: params differ {params_differ} adam differ "
          f"{adam_differ} losses equal {losses_equal}; fine_tune {tune_ok}; "
          f"restored on the CPU {cpu_ok}; save {save_s:.3f} s restore "
          f"{restore_s:.3f} s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"from disk {dname} resume: {report}")
    return report, TrainState(resumed.model, st_c, 6), launches


def _eval_check(torch, setup, cfg, dname, ckpt_dir, eval_data, failures):
    """evaluate_dataset on the card and on the CPU from the latest step
    of ``ckpt_dir``: metrics, ranks and the first batch's scores against
    the CPU's, the eval batch timed.  Returns (report, launches)."""
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
    from mtamrecommender_tpu_torch.train.evaluate import (eval_batches,
                                                          evaluate_dataset,
                                                          make_eval_step,
                                                          ranks_from_scores)
    from mtamrecommender_tpu_torch.train.trainer import TrainState

    vocab, bs = setup.meta.item_vocab, cfg.train.test_batch_size
    ckpt = Checkpointer(ckpt_dir)
    models = {dev: ckpt.restore(TrainState(setup.model(torch, cfg, dev),
                                           None)).model
              for dev in (DEVICE, "cpu")}
    step = make_eval_step(get_model("MTAM"), cfg.model, valid_vocab=vocab)
    _reset_counts()
    t0 = time.perf_counter()
    metrics_gpu = evaluate_dataset(step, models[DEVICE],
                                   eval_batches(eval_data[DEVICE], bs))
    eval_s = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    metrics_cpu = evaluate_dataset(step, models["cpu"],
                                   eval_batches(eval_data["cpu"], bs))
    cpu_eval_s = time.perf_counter() - t0
    metric_err = {k: abs(metrics_gpu[k] - metrics_cpu[k])
                  for k in metrics_cpu}
    # ranks of the live rows, and the first batch's scores
    casts = {dev: step.cast(m) for dev, m in models.items()}
    same, live, score_rel, finite = 0, 0, 0.0, True
    batches = {dev: list(eval_batches(eval_data[dev], bs))
               for dev in (DEVICE, "cpu")}
    for i, ((_, bg), (_, bc)) in enumerate(zip(batches[DEVICE],
                                               batches["cpu"])):
        with torch.no_grad():
            sg = scores_for_eval(step.model_def, casts[DEVICE], cfg.model,
                                 bg, vocab)
            sc = scores_for_eval(step.model_def, casts["cpu"], cfg.model,
                                 bc, vocab)
        mask = bc.valid > 0
        rg = ranks_from_scores(sg, bg.target_id).cpu()
        rc = ranks_from_scores(sc, bc.target_id)
        same += int((rg[mask] == rc[mask]).sum())
        live += int(mask.sum())
        if i == 0:
            sg = sg.cpu()
            finite = bool(torch.isfinite(sg[:, :vocab]).all())
            score_err, score_rel = rel_err(sg[:, :vocab], sc[:, :vocab])
    ranks_equal = same / live
    batch0 = batches[DEVICE][0][1]
    run = lambda: step(casts[DEVICE], batch0)  # noqa: E731
    event_ms = _event_ms(torch, run, 10)
    busy = _device_busy(torch, run)
    profiled = _kernel_launches(torch, run)
    gru = profiled.get("gru_scan_kernel", 0)
    hop = profiled.get("attn_fwd_hop_kernel", 0)
    want = _want_counts(0)
    want["gru_scan"]["tgru"] = 2
    want["fused_attention"]["time"] = 6
    want["fused_attention_hop"]["time"] = 6
    ok = (max(metric_err.values()) <= EVAL_ATOL[dname] and finite
          and score_rel <= SLICE_TOL[dname]
          and (dname != "float32" or ranks_equal >= EVAL_RANKS_EQUAL)
          and launches == want and gru == 1 and hop == 3
          and len(batches[DEVICE]) == 2
          and int(batches[DEVICE][1][1].valid.sum()) == EVAL_ROWS - bs)
    report = {"metrics_gpu": metrics_gpu, "metrics_cpu": metrics_cpu,
              "metric_abs_err": metric_err, "tol": EVAL_ATOL[dname],
              "ranks_equal": ranks_equal, "live_rows": live,
              "first_batch_max_abs_score_err": score_err,
              "first_batch_rel_score_err": score_rel,
              "eval_batch": bs, "eval_batch_event_ms": event_ms,
              "eval_batch_device_busy_ms": busy["device_busy_ms"],
              "idle_share": (None if busy["device_busy_ms"] is None
                             else 1 - busy["device_busy_ms"] / event_ms),
              "top_kernels": busy["top_kernels"][:5],
              "profiler_launches_per_batch": profiled,
              "evaluate_dataset_s": eval_s, "cpu_evaluate_dataset_s":
                  cpu_eval_s, "launches": launches, "ok": ok}
    print(f"disk {dname:9s} eval B={bs} x2 ({EVAL_ROWS} rows): "
          + " ".join(f"{k}={v:.4f}" for k, v in metrics_gpu.items())
          + f" | max metric err vs CPU {max(metric_err.values()):.2e} ranks "
          f"equal {ranks_equal:.4f} first batch rel score err "
          f"{score_rel:.2e}; eval batch event_ms={event_ms:.3f} device_"
          f"busy_ms={busy['device_busy_ms']} profiler launches gru_scan="
          f"{gru} hop={hop}; evaluate_dataset {eval_s:.3f} s (CPU "
          f"{cpu_eval_s:.1f} s) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"from disk {dname} evaluation: {report}")
    return report, launches


def _serve_main_lines(setup, cfg, ckpt_dir, requests):
    """serve.main in a subprocess (``python -m
    mtamrecommender_tpu_torch.serve``) on ``requests``, with the flags
    that give ``cfg``'s model: (its answers, its wall seconds, its return
    code and stderr's tail)."""
    m = setup.meta
    argv = [sys.executable, "-m", "mtamrecommender_tpu_torch.serve",
            "--checkpoint", ckpt_dir, "--items", str(m.item_count),
            "--users", str(m.user_count), "--categories",
            str(m.category_count), "--max_seq_len", str(m.max_seq_len),
            "--num_units", str(cfg.model.num_units), "--num_blocks",
            str(cfg.model.num_blocks), "--device", DEVICE,
            "--set", f"model.vocab_pad_multiple="
                     f"{cfg.model.vocab_pad_multiple}",
            "--set", f'model.compute_dtype="{cfg.model.compute_dtype}"']
    t0 = time.perf_counter()
    res = subprocess.run(argv, input="".join(json.dumps(r) + "\n"
                                             for r in requests),
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    answers = [json.loads(line) for line in res.stdout.splitlines()
               if line.startswith("{")]
    return answers, seconds, res.returncode, res.stderr[-2000:]


def _serve_check(torch, setup, cfg, dname, ckpt_dir, in_memory, failures):
    """Recommender.from_checkpoint on the card against a Recommender of
    the in-memory model (k=50, B=16: the same ids), then serve.main in a
    subprocess against in-process recommend, line by line.  Returns
    (report, launches of the from-disk recommend call)."""
    from mtamrecommender_tpu_torch.serve import Recommender

    m = setup.meta
    rec = Recommender.from_checkpoint(cfg, m, ckpt_dir, device=DEVICE)
    hists, req = make_histories(np.random.RandomState(88), 16, m.item_count,
                                m.category_count, m.max_seq_len)
    hists[1] = []
    _reset_counts()
    got = rec.recommend(hists, req, k=50)
    torch.cuda.synchronize()
    launches = _counts()
    want = Recommender(cfg, m, in_memory, device=DEVICE).recommend(
        hists, req, k=50)
    ids_equal = [[i for i, _ in r] for r in got] == \
        [[i for i, _ in r] for r in want]
    # serve.main: an empty history, one longer than L-1, two others
    rng = np.random.RandomState(89)
    t = 1_700_000_000 + np.cumsum(rng.randint(60, 86400, 2 * m.max_seq_len))
    long_h = [[int(rng.randint(1, m.item_count + 1)),
               int(rng.randint(1, m.category_count + 1)), float(tt)]
              for tt in t]
    requests = [{"history": [], "request_time": req[0], "user_id": 7},
                {"history": long_h, "request_time": float(t[-1] + 3600),
                 "user_id": 3},
                {"history": [list(e) for e in hists[2]],
                 "request_time": req[2], "k": 5},
                {"history": [list(e) for e in hists[3]],
                 "request_time": req[3], "user_id": 11, "k": 20}]
    answers, main_s, rc, err = _serve_main_lines(setup, cfg, ckpt_dir,
                                                 requests)
    in_process, host_ms = [], []
    for r in requests:
        args = ([[tuple(e) for e in r["history"]]], [r["request_time"]])
        kw = dict(k=int(r.get("k", 10)), user_ids=[int(r.get("user_id", 0))])
        in_process.append(rec.recommend(*args, **kw)[0])
        host_ms.append(_host_ms(torch, lambda: rec.recommend(*args, **kw),
                                10))
    lines_ok = rc == 0 and len(answers) == len(requests)
    worst = 0.0
    for a, w in zip(answers, in_process):
        lines_ok = lines_ok and a["items"] == [i for i, _ in w]
        if a["items"] == [i for i, _ in w]:
            worst = max([worst] + [abs(s - ws) for s, (_, ws)
                                   in zip(a["scores"], w)])
    lines_ok = lines_ok and worst <= SERVE_MAIN_ATOL
    want_launches = _want_counts(0)
    want_launches["gru_scan"]["tgru"] = 1
    want_launches["fused_attention"]["time"] = 3
    want_launches["fused_attention_hop"]["time"] = 3
    ok = ids_equal and lines_ok and launches == want_launches \
        and len(requests[1]["history"]) > m.max_seq_len - 1
    report = {"from_checkpoint_ids_equal": ids_equal,
              "serve_main_rc": rc, "serve_main_answers": len(answers),
              "serve_main_max_abs_score_err": worst,
              "serve_main_wall_s": main_s,
              "request_host_ms": host_ms, "launches": launches,
              "serve_main_stderr_tail": err if rc else "", "ok": ok}
    print(f"disk {dname:9s} serve: from_checkpoint k=50 B=16 ids equal "
          f"{ids_equal}; serve.main subprocess rc={rc} {len(answers)} "
          f"answers, max |score - in-process| {worst:.2e}, wall "
          f"{main_s:.1f} s; per-request host ms "
          f"{[round(x, 3) for x in host_ms]} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append(f"from disk {dname} serving: {report}")
    return report, launches


def run_from_disk(torch, setup, failures):
    """Phase 8: a trained model from disk, on phase 4's cell (B=256,
    bf16 and f32): resume bit for bit, evaluate on the card and on the
    CPU from one checkpoint, serve from it in-process and through
    serve.main in a subprocess.  The checkpoints live in a temporary
    directory, removed afterwards.  Returns (report, the main path's
    launches: 12 training steps, 2 eval batches and one recommend call a
    dtype)."""
    import shutil
    import tempfile

    from mtamrecommender_tpu_torch.data.device_data import to_device

    arrays = make_train_arrays(setup.meta, EVAL_ROWS, seed=1)
    eval_data = {dev: to_device(arrays, device=dev)
                 for dev in (DEVICE, "cpu")}
    report, launches = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for dname in ("bfloat16", "float32"):
            cfg = setup.cfg(dname)
            ckpt_dir = os.path.join(root, dname)
            resume, state, got = _resume_check(torch, setup, cfg, dname,
                                               ckpt_dir, failures)
            _add_launches(launches, got)
            evaluation, got = _eval_check(torch, setup, cfg, dname, ckpt_dir,
                                          eval_data, failures)
            _add_launches(launches, got)
            serving, got = _serve_check(torch, setup, cfg, dname, ckpt_dir,
                                        state.model, failures)
            _add_launches(launches, got)
            report[dname] = {"resume": resume, "evaluate": evaluation,
                             "serve": serving}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report, launches


# ------------------------------------------------------------ phase 9

class ZooModel(NamedTuple):
    """A zoo model's paths on phase 4's cell: the GRU pair's mode (None:
    no GRU), the Tq=1 readout's attention kind (None: no readout) and
    hops (None: the cell's), the mode of its self-attention blocks in
    training (at Tq = Tk = L, the cell's count; None: it does not
    self-attend), whether its GRU starts from the user's embedding, and
    the tables its loss reaches (dtable launches a step)."""
    gru: Optional[str]
    att: Optional[str] = None
    hops: Optional[int] = None
    self_att: Optional[str] = None
    h0: bool = False
    tables: int = 4


# every registry model but the MTAM and self-attention models (phases
# 4-5), which phase 9 trains, serves and holds against the CPU
ZOO_MODELS = {"Gru4Rec": ZooModel("plain"),
              "Vallina_Gru4Rec": ZooModel("plain"),
              "T_SeqRec": ZooModel("tseqrec"), "T_GRU": ZooModel("tseqrec"),
              "MTAM_no_time_aware_rnn": ZooModel("plain", "time"),
              "MTAM_via_rnn": ZooModel("plain", "time"),
              "MTAM_with_T_SeqRec": ZooModel("tseqrec", "time"),
              "MTAM_via_T_GRU": ZooModel("tgru", "time"),
              "MTAM_hybird": ZooModel("tgru", "time"),
              "MTAM_no_time_aware_att": ZooModel("tgru", "plain"),
              "NARM": ZooModel("plain", "plain", hops=1),
              "NARM+": ZooModel("plain", "time", hops=1),
              "NARM++": ZooModel("tgru", "time", hops=1),
              "LSTUR": ZooModel("plain", h0=True),
              "LSTUR_time_rnn": ZooModel("tseqrec", h0=True),
              "STAMP": ZooModel(None),
              "pistrec": ZooModel("tseqrec", "time", self_att="time"),
              "bpr": ZooModel(None, tables=2)}
# the paths phase 9 must show launches on, each a group of zoo models:
# (group, kernel, mode)
ZOO_GROUP_KERNELS = (("plain_readout", "fused_attention_hop", "plain"),
                     ("one_hop", "readout_chain", None),
                     ("one_hop", "readout_chain_bwd", None),
                     ("h0", "gru_scan", "plain"),
                     ("h0", "gru_scan_bwd", "plain"),
                     ("h0", "gru_scan_bwd", "tseqrec"),
                     ("self_attention", "fused_attention", "time"),
                     ("self_attention", "fused_attention_bwd", "time"))
BPR_NEGATIVE = 1234          # the one-step check's injected negative item
ZOO_CHECK_BATCH = 64         # the one-step check against the CPU
# MTAM_with_T_SeqRecb6_yoochoose's hops (mtamrecommender_tpu/config.py)
ZOO_PRESET = ("MTAM_with_T_SeqRec", 6)
ZOO_EVAL_ROWS = 2048         # one batch of train.test_batch_size
ZOO_TIMED_STEPS = 3          # timed make_superstep steps a model, in bf16


def _zoo_groups(spec):
    """The groups of ZOO_GROUP_KERNELS a model belongs to."""
    return ([g for g, member in (
        ("plain_readout", spec.att == "plain"),
        ("one_hop", spec.att == "time" and spec.hops == 1),
        ("h0", spec.h0), ("self_attention", spec.self_att)) if member])


class ZooSetup:
    """Phase 4's cell (its data, order and catalog) for the zoo models:
    ``hops`` readout hops, the one-step check on the first ``batch``
    rows of phase 4's first batch."""

    model = TrainSetup.model

    def __init__(self, setup, batch, hops=3):
        from mtamrecommender_tpu_torch.data.device_data import gather_batch

        self.meta, self.data, self.data_cpu = (setup.meta, setup.data,
                                               setup.data_cpu)
        self.order, self.order_cpu = setup.order, setup.order_cpu
        self.batch_size, self.hops = TRAIN_BATCH, hops
        self.batch = gather_batch(setup.data, setup.order, 0, batch)
        self.batch_cpu = gather_batch(setup.data_cpu, setup.order_cpu, 0,
                                      batch)

    def cfg(self, dname, name="MTAM"):
        return train_cfg(dname, name).with_overrides(
            **{"model.num_blocks": self.hops})


def _zoo_want(spec, hops=3):
    """Launches of ``steps`` training steps (the GRU pair in its mode,
    dtable once a table the loss reaches, the chain pair where the model
    reads out in the time kind, the attention pair ``hops`` times where
    it self-attends; the plain readout trains in plain PyTorch) and of
    one serving call or eval batch (1 gru_scan, the readout's hops in the
    hop design of its kind, ``hops`` self-attention forwards)."""
    n = spec.hops or hops

    def train(steps, dname=None):
        want = _want_counts(steps, gru=spec.gru, attention=spec.self_att,
                            blocks=hops, chain=spec.att == "time")
        want["dtable"]["dtable"] = spec.tables * steps
        return want

    serve = _want_counts(0)
    if spec.gru:
        serve["gru_scan"][spec.gru] = 1
    if spec.att:
        serve["fused_attention"][spec.att] += n
        serve["fused_attention_hop"][spec.att] += n
    if spec.self_att:
        serve["fused_attention"][spec.self_att.replace("_drop", "")] += hops
    return train, serve


def _zoo_sources(torch, setup, name, spec):
    """The one-step check's injected draws: CPU masks f32 [B, 1, L], one a
    plain readout hop at the cell's dropout, or [B, L, L], one a
    self-attention block that drops; bpr's negative item."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.ops.layers import draw_drop_mask

    kw = {}
    b, L = setup.batch_cpu.items.shape
    rate = setup.cfg("float32", name).model.dropout
    if spec.att == "plain":
        gen = torch.Generator().manual_seed(26)
        kw["drop_masks"] = [draw_drop_mask(gen, b, 1, L, rate, "cpu")
                            for _ in range(spec.hops or setup.hops)]
    if spec.self_att and spec.self_att.endswith("_drop"):
        gen = torch.Generator().manual_seed(99)
        kw["drop_masks"] = [draw_drop_mask(gen, b, L, L, rate, "cpu")
                            for _ in range(setup.hops)]
    if get_model(name).output_mode == "bpr":
        kw["neg_id"] = torch.tensor([BPR_NEGATIVE], dtype=torch.int32)
    return kw


def serve_zoo(torch, setup, failures, name, want, check_batches=(16,),
              timed_batch=256, iters=5):
    """Recommender.recommend for model ``name`` (k=50) in bf16 and f32,
    each request with a user id (LSTUR starts its GRU from the user's
    row, BPRMF scores it): at each of ``check_batches`` the launches of
    one call against ``want`` and the scores against the same
    Recommender on the CPU within SLICE_TOL; at ``timed_batch`` the
    launches of one call, the host ms a call and the scoring step's
    event and device busy ms.  Returns (rows, the calls' launches)."""
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.serve import Recommender

    meta, rows, total = setup.meta, {}, {}
    vocab = meta.item_vocab
    for dname in ("bfloat16", "float32"):
        cfg = setup.cfg(dname, name)
        model = setup.model(torch, cfg, "cpu")
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        for bs in sorted(set(check_batches) | {timed_batch}):
            hists, req = make_histories(np.random.RandomState(bs), bs,
                                        meta.item_count, meta.category_count,
                                        meta.max_seq_len)
            hists[1] = []                             # an empty history
            users = np.random.RandomState(bs + 1).randint(
                1, meta.user_count + 1, bs).tolist()
            _reset_counts()
            recs = rec.recommend(hists, req, user_ids=users, k=50)
            torch.cuda.synchronize()
            counts = _counts()
            _add_launches(total, counts)
            row = {"launches": counts}
            ok = counts == want and all(len(r) == 50 for r in recs)
            if bs in check_batches:
                with torch.no_grad():
                    s_gpu = scores_for_eval(
                        rec.model_def, rec._model_c, cfg.model,
                        rec.batch_from_histories(hists, req, users),
                        vocab).cpu()
                    s_cpu = scores_for_eval(
                        rec_cpu.model_def, rec_cpu._model_c, cfg.model,
                        rec_cpu.batch_from_histories(hists, req, users),
                        vocab)
                err, rel = rel_err(s_gpu[:, :vocab], s_cpu[:, :vocab])
                row.update(max_abs_score_err=err, rel_score_err=rel,
                           tol=SLICE_TOL[dname])
                ok = ok and rel <= SLICE_TOL[dname] and bool(
                    torch.isfinite(s_gpu).all())
            if bs == timed_batch:
                batch = rec.batch_from_histories(hists, req, users)
                fetch = min(50 + meta.max_seq_len, vocab)
                score = lambda: rec._score_impl(batch, fetch)  # noqa: E731
                row["recommend_ms"] = _host_ms(torch, lambda: rec.recommend(
                    hists, req, user_ids=users, k=50), iters)
                row["score_topk_ms"] = _event_ms(torch, score, iters)
                busy = _device_busy(torch, score)
                row.update(busy)
                row["idle_share"] = (None if busy["device_busy_ms"] is None
                                     else 1 - busy["device_busy_ms"]
                                     / row["score_topk_ms"])
            row["ok"] = ok
            rows[f"{dname}_B{bs}"] = row
            print(f"zoo serve {name} {dname:9s} B={bs:<3d} "
                  f"rel_score_err={row.get('rel_score_err')} "
                  f"recommend_ms={row.get('recommend_ms')} score_topk_ms="
                  f"{row.get('score_topk_ms')} device_busy_ms="
                  f"{row.get('device_busy_ms')} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"zoo serving {name} {dname} B={bs}: {row}")
    return rows, total


def check_bidirectional(torch, failures):
    """bidirectional_gru_net at B=16, L=50, u=128 on the card against the
    CPU, f32 and bf16: the output and every gradient (inputs and both
    GRUs' parameters) of sum(out * cotangent) within KERNEL_TOL of the
    CPU's largest |value|, and 2 gru_scan[plain] + 2 gru_scan_bwd[plain]
    launches.  No model of either package calls it: held as a module."""
    from mtamrecommender_tpu_torch.ops import time_gru

    B, L, u = 16, 50, 128
    gen = torch.Generator().manual_seed(25)
    params = time_gru.init_bidirectional_gru(gen, u, u)
    x = torch.randn(B, L, u, generator=gen)
    cot = torch.randn(B, L, 2 * u, generator=gen)
    lengths = torch.randint(0, L + 1, (B,), generator=gen)
    lengths[0], lengths[1] = 0, L
    want = _want_counts(0)
    want["gru_scan"]["plain"] = 2
    want["gru_scan_bwd"]["plain"] = 2
    report = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        runs = {}
        for dev in ("cpu", DEVICE):
            module = time_gru.BidirectionalGRU(
                {k: {n: t.clone() for n, t in v.items()}
                 for k, v in params.items()}).to(dev).to(dt)
            xin = x.clone().to(dev).requires_grad_(True)
            _reset_counts()
            out = time_gru.bidirectional_gru_net(
                module, xin.to(dt), lengths.to(dev)).float()
            (out * cot.to(dev)).sum().backward()
            if dev == DEVICE:
                torch.cuda.synchronize()
                launches = _counts()
            runs[dev] = {"out": out.detach().cpu(), "inputs": xin.grad.cpu(),
                         **{n: p.grad.float().cpu()
                            for n, p in module.named_parameters()}}
        errs = {k: rel_err(runs[DEVICE][k], v)[1]
                for k, v in runs["cpu"].items()}
        worst = max(errs, key=errs.get)
        ok = errs[worst] <= KERNEL_TOL[dname] and launches == want and all(
            bool(torch.isfinite(t).all()) for t in runs[DEVICE].values())
        report[dname] = {"rel_err": errs, "launches": launches, "ok": ok}
        print(f"zoo bidirectional_gru_net {dname:9s} B={B} L={L} u={u}: "
              f"worst rel err {errs[worst]:.3e} ({worst}) launches "
              f"gru_scan={launches['gru_scan']} gru_scan_bwd="
              f"{launches['gru_scan_bwd']} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"bidirectional_gru_net {dname}: {report[dname]}")
    return report


def hybird_from_disk(torch, setup, failures):
    """MTAM_hybird (the concat head) from disk, bf16 and f32: two
    make_train_step steps on the card, a Checkpointer save,
    Recommender.from_checkpoint on the card, recommend k=50 at B=16 with
    the in-memory model's ids; then evaluate_dataset from the checkpoint
    over one batch of 2,048 held-out rows on the card and on the CPU,
    every metric within EVAL_ATOL.  The checkpoints live in a temporary
    directory, removed afterwards.  Returns (report, launches)."""
    import shutil
    import tempfile

    from mtamrecommender_tpu_torch.data.device_data import (gather_batch,
                                                             to_device)
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.serve import Recommender
    from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
    from mtamrecommender_tpu_torch.train.evaluate import (eval_batches,
                                                          evaluate_dataset,
                                                          make_eval_step)
    from mtamrecommender_tpu_torch.train.trainer import (TrainState,
                                                         make_optimizer,
                                                         make_train_step)

    name = "MTAM_hybird"
    train_want, serve_want = _zoo_want(ZOO_MODELS[name])
    m, vocab = setup.meta, setup.meta.item_vocab
    arrays = make_train_arrays(m, ZOO_EVAL_ROWS, seed=1)
    eval_data = {dev: to_device(arrays, device=dev)
                 for dev in (DEVICE, "cpu")}
    hists, req = make_histories(np.random.RandomState(99), 16, m.item_count,
                                m.category_count, m.max_seq_len)
    hists[1] = []
    report, total = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        for dname in ("bfloat16", "float32"):
            cfg = train_cfg(dname, name)
            ckpt_dir = os.path.join(root, dname)
            opt = make_optimizer(cfg.train)
            step = make_train_step(get_model(name), cfg, opt, vocab,
                                   device=DEVICE)
            model = setup.model(torch, cfg, DEVICE)
            state = opt.init(model)
            _reset_counts()
            losses = []
            for k in range(2):
                state, metrics = step(model, state, gather_batch(
                    setup.data, setup.order, k, TRAIN_BATCH))
                losses.append(metrics["loss"].item())
            got = _counts()
            _add_launches(total, got)
            train_ok = got == train_want(2) and all(map(math.isfinite,
                                                        losses))
            Checkpointer(ckpt_dir).save(TrainState(model, state, 2))
            rec = Recommender.from_checkpoint(cfg, m, ckpt_dir,
                                              device=DEVICE)
            _reset_counts()
            from_disk = rec.recommend(hists, req, k=50)
            torch.cuda.synchronize()
            serve_launches = _counts()
            _add_launches(total, serve_launches)
            in_memory = Recommender(cfg, m, model, device=DEVICE).recommend(
                hists, req, k=50)
            ids_equal = [[i for i, _ in r] for r in from_disk] == \
                [[i for i, _ in r] for r in in_memory]
            serve_ok = ids_equal and serve_launches == serve_want
            restored = {dev: Recommender.from_checkpoint(
                cfg, m, ckpt_dir, device=dev).model for dev in (DEVICE, "cpu")}
            ev = make_eval_step(get_model(name), cfg.model, valid_vocab=vocab)
            _reset_counts()
            metrics_gpu = evaluate_dataset(ev, restored[DEVICE], eval_batches(
                eval_data[DEVICE], cfg.train.test_batch_size))
            got = _counts()
            _add_launches(total, got)
            metrics_cpu = evaluate_dataset(ev, restored["cpu"], eval_batches(
                eval_data["cpu"], cfg.train.test_batch_size))
            metric_err = {k: abs(metrics_gpu[k] - metrics_cpu[k])
                          for k in metrics_cpu}
            eval_ok = (max(metric_err.values()) <= EVAL_ATOL[dname]
                       and got == serve_want
                       and cfg.train.test_batch_size == ZOO_EVAL_ROWS)
            ok = train_ok and serve_ok and eval_ok
            report[dname] = {"losses": losses, "train_ok": train_ok,
                             "from_checkpoint_ids_equal": ids_equal,
                             "recommend_launches": serve_launches,
                             "eval_launches": got, "serve_ok": serve_ok,
                             "metrics_gpu": metrics_gpu,
                             "metrics_cpu": metrics_cpu,
                             "metric_abs_err": metric_err,
                             "tol": EVAL_ATOL[dname], "ok": ok}
            print(f"zoo disk {name} {dname:9s}: 2 steps losses {losses}; "
                  f"from_checkpoint k=50 B=16 ids equal {ids_equal}; eval "
                  f"B={ZOO_EVAL_ROWS} max metric err vs CPU "
                  f"{max(metric_err.values()):.2e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"zoo from disk {name} {dname}: "
                                f"{report[dname]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report, total


def zoo_model(torch, setup, failures, name, spec):
    """One zoo model on the cell: one step's loss and every gradient leaf
    against the CPU (f32 and bf16, draws injected: `_zoo_sources`) with
    its launches, ZOO_TIMED_STEPS timed make_superstep steps at B=256 in
    bf16 after one warm-up step, and recommend at B=16 against the CPU and at B=256 timed.  Returns
    (report, the launches of the timed steps and the serving calls)."""
    train_want, serve_want = _zoo_want(spec)
    launches = {}
    rep = one_step_check(torch, setup, failures, name, train_want,
                         **_zoo_sources(torch, setup, name, spec))
    rep.update(timed_steps(torch, setup, failures, name, train_want,
                           launches, steps=ZOO_TIMED_STEPS, warm=1,
                           dtypes=("bfloat16",)))
    rep["serving"], got = serve_zoo(torch, setup, failures, name,
                                    serve_want)
    _add_launches(launches, got)
    return rep, launches


def run_zoo(torch, setup, failures):
    """Phase 9: the registry's models but MTAM and the self-attention
    models (ZOO_MODELS) on phase 4's cell at 3 hops (`zoo_model`);
    MTAM_with_T_SeqRec at its preset's 6 hops (one step against the CPU
    at B=256, 3 timed bf16 steps, recommend at B=256 against the CPU and
    timed); bidirectional_gru_net as a module; MTAM_hybird from disk;
    FPMC.  Returns (report, the main paths' launches, the launches of
    each group of ZOO_GROUP_KERNELS)."""
    report, launches = {}, {}
    groups = {group: {} for group, _, _ in ZOO_GROUP_KERNELS}
    three = ZooSetup(setup, ZOO_CHECK_BATCH)
    for name, spec in ZOO_MODELS.items():
        report[name], got = zoo_model(torch, three, failures, name, spec)
        _add_launches(launches, got)
        for group in _zoo_groups(spec):
            _add_launches(groups[group], got)
    name, hops = ZOO_PRESET
    six = ZooSetup(setup, TRAIN_BATCH, hops=hops)
    train_want, serve_want = _zoo_want(ZOO_MODELS[name], hops)
    rep = one_step_check(torch, six, failures, name, train_want)
    rep.update(timed_steps(torch, six, failures, name, train_want, launches,
                           steps=ZOO_TIMED_STEPS, warm=1,
                           dtypes=("bfloat16",)))
    rep["serving"], got = serve_zoo(torch, six, failures, name, serve_want,
                                    check_batches=(TRAIN_BATCH,))
    _add_launches(launches, got)
    report[f"{name}@{hops}hops"] = rep
    report["bidirectional_gru_net"] = check_bidirectional(torch, failures)
    report["hybird_from_disk"], got = hybird_from_disk(torch, setup,
                                                       failures)
    _add_launches(launches, got)
    report["fpmc"] = check_fpmc(torch, failures)
    return report, launches, groups


FPMC_CELL = (6040, 3706, 32)    # ml-1m's users and items, n_factor
FPMC_BATCH, FPMC_STEPS, FPMC_TUPLES = 256, 5, 4096


def fpmc_tuples(n, seed, n_user, n_item):
    """``n`` (user, item, basket) tuples: each user walks the catalog
    i -> i + 1 from a random start, the basket the 1-3 items before."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        u, start, k = (int(rng.randint(n_user)), int(rng.randint(n_item)),
                       int(rng.randint(1, 4)))
        basket = [(start + j) % n_item for j in range(k)]
        out.append((u, (start + k) % n_item, basket))
    return out


def check_fpmc(torch, failures):
    """FPMC at ml-1m's catalog (6,040 users, 3,706 items, 32 factors):
    FPMC_STEPS sbpr_steps at B=256 on the card and on the CPU from the
    same tables and batches, each step's loss and the four tables after
    the last within KERNEL_TOL (f32); score_all against the CPU; then
    `train_fpmc` on the card for one epoch over FPMC_TUPLES tuples and
    `evaluate` on 1,024 held-out tuples, the accuracy and MRR of the
    trained tables on the card within EVAL_ATOL of the CPU's.  FPMC runs
    no kernel: this holds the model, not a kernel, on the card."""
    from mtamrecommender_tpu_torch.models import fpmc

    n_user, n_item, n_factor = FPMC_CELL
    cfg = fpmc.FPMCConfig(n_user=n_user, n_item=n_item, n_factor=n_factor)
    tr = fpmc_tuples(FPMC_TUPLES, 0, n_user, n_item)
    te = fpmc_tuples(1024, 1, n_user, n_item)
    models = {dev: fpmc.init_fpmc(torch.Generator().manual_seed(26),
                                  cfg).to(dev) for dev in ("cpu", DEVICE)}
    rng = np.random.RandomState(3)
    losses = {"cpu": [], DEVICE: []}
    step_ms = []
    for _ in range(FPMC_STEPS):
        sel = rng.randint(0, len(tr), FPMC_BATCH)
        u, i, basket, mask = fpmc.pack_batch(tr, sel, 50)
        j = rng.randint(0, n_item, FPMC_BATCH).astype(np.int32)
        for dev, model in models.items():
            args = [torch.from_numpy(a).to(dev) for a in
                    (u, i, j, basket, mask)]
            t0 = time.perf_counter()
            loss = fpmc.sbpr_step(model, *args, learn_rate=cfg.learn_rate,
                                  regular=cfg.regular)
            losses[dev].append(loss.item())
            if dev == DEVICE:
                step_ms.append((time.perf_counter() - t0) * 1e3)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(losses[DEVICE], losses["cpu"]))
    table_err = max((getattr(models[DEVICE], n).detach().cpu()
                     - getattr(models["cpu"], n).detach()).abs().max().item()
                    for n in fpmc.TABLES)
    u, _, basket, mask = fpmc.pack_batch(te, np.arange(256), 50)
    with torch.no_grad():
        s_cpu = fpmc.score_all(models["cpu"], *(torch.from_numpy(a) for a in
                                                (u, basket, mask)))
        s_gpu = fpmc.score_all(models[DEVICE], *(
            torch.from_numpy(a).to(DEVICE) for a in (u, basket, mask))).cpu()
    _, score_rel = rel_err(s_gpu, s_cpu)
    t0 = time.perf_counter()
    trained, (acc, mrr) = fpmc.train_fpmc(cfg, tr, te, n_epoch=1,
                                          neg_batch_size=2,
                                          batch_size=FPMC_BATCH,
                                          device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    acc_cpu, mrr_cpu = fpmc.evaluate(trained.to("cpu"), te)
    ok = (loss_rel <= KERNEL_TOL["float32"]
          and table_err <= KERNEL_TOL["float32"]
          and score_rel <= KERNEL_TOL["float32"]
          and abs(acc - acc_cpu) <= EVAL_ATOL["float32"]
          and abs(mrr - mrr_cpu) <= EVAL_ATOL["float32"]
          and all(math.isfinite(x) for x in losses[DEVICE]))
    report = {"losses_gpu": losses[DEVICE], "losses_cpu": losses["cpu"],
              "loss_rel_err": loss_rel, "table_max_abs_err": table_err,
              "score_rel_err": score_rel, "sbpr_step_host_ms": step_ms,
              "train_fpmc_s": train_s, "acc_mrr_gpu": [acc, mrr],
              "acc_mrr_cpu": [acc_cpu, mrr_cpu], "ok": ok}
    print(f"zoo FPMC users={n_user} items={n_item} f={n_factor} "
          f"B={FPMC_BATCH}: {FPMC_STEPS} steps loss rel err {loss_rel:.3e} "
          f"tables max abs err {table_err:.3e} scores rel err "
          f"{score_rel:.3e}; train_fpmc 1 epoch {train_s:.2f} s, acc / MRR "
          f"{acc:.4f} / {mrr:.4f} (CPU {acc_cpu:.4f} / {mrr_cpu:.4f}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"FPMC: {report}")
    return report


# ------------------------------------------------------------ report

# ------------------------------------------------------------ phase 10

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# the runs' working directory: under the checkout's ignored build/,
# emptied first and removed afterwards
LOG_RUN_DIR = os.path.join(REPO_ROOT, "build", "phase10")
LOG_STEPS, LOG_RESUME_AT, LOG_EVAL_FREQ = 120, 80, 40
# the command line of phase 10's runs: synthetic_timed at its default
# size, MTAM at the default widths (d=128, 3 hops, L=50, B=256, test
# batch 2,048), evaluation and checkpoints every 40 steps, bf16
LOG_ARGS = ["--type", "synthetic_timed", "--experiment_type", "MTAM",
            "--set", f"train.eval_freq={LOG_EVAL_FREQ}",
            "--set", f"train.save_freq={LOG_EVAL_FREQ}",
            "--set", "train.steps_per_call=1",
            "--set", "model.compute_dtype=bfloat16",
            "--data_root", "data", "--run_root", "runs"]
LOG_CPU_STEPS = 10           # f32 Trainer steps against the CPU
LOG_TIMED_STEPS = 40         # the fit's step function, profiled
LOG_FIELDS = ("user_id", "items", "cats", "times", "time_last", "time_now",
              "positions", "target_id", "target_cat", "target_time",
              "seq_len")


def _log_cfg(**over):
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides(**{
        "data.dataset": "synthetic_timed", **over})


def _sorted_rows(ds):
    """The packed rows as one sorted array of raw bytes (a multiset)."""
    n = len(ds)
    raw = np.concatenate([np.ascontiguousarray(getattr(ds, f)).reshape(
        n, -1).view(np.uint8) for f in LOG_FIELDS], axis=1)
    return np.sort(np.ascontiguousarray(raw).view(
        np.dtype((np.void, raw.shape[1]))).reshape(-1))


def log_builders(failures):
    """Phase 10, part 1: the log, then both example builders on it (host
    seconds each); the native builder's rows must equal the Python
    builder's as a multiset.  Returns (report, (train, test))."""
    from mtamrecommender_tpu_torch.data import (fastprep, ingest, pipeline,
                                                prepare)

    cfg = _log_cfg()
    t0 = time.perf_counter()
    log = ingest.load_origin_data(cfg.data)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fastprep._load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, test, _ = fastprep.build_packed(log, cfg.data)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = prepare.prepare_examples(log, cfg.data)
    py_train = pipeline.pack_examples(prepared.train_set, prepared.meta)
    py_test = pipeline.pack_examples(prepared.test_set, prepared.meta)
    python_s = time.perf_counter() - t0
    same = all(np.array_equal(_sorted_rows(a), _sorted_rows(b))
               for a, b in ((train, py_train), (test, py_test)))
    report = {"events": len(log), "train_rows": len(train),
              "test_rows": len(test), "generate_s": gen_s,
              "native_build_s": build_s, "native_s": native_s,
              "python_s": python_s, "same_rows": same}
    print(f"from a log: {len(log)} events -> {len(train)} train / "
          f"{len(test)} test rows; generate {gen_s:.2f} s, g++ "
          f"{build_s:.2f} s, native builder {native_s:.3f} s, Python "
          f"builder {python_s:.2f} s, rows {'equal' if same else 'DIFFER'}",
          flush=True)
    if not same:
        failures.append("phase 10: the native builder's rows differ from "
                        "the Python builder's")
    return report, (train, test)


def _nonzero(counts):
    return {k: {m: n for m, n in v.items() if n} for k, v in counts.items()
            if any(v.values())}


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


class _LogLines:
    """Collects the messages of the port's run logger."""

    def __init__(self):
        import logging
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())
        self.logger = logging.getLogger("mtamrec_torch")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def _ckpt_state(torch, cfg, meta, ckpt_dir, step):
    """The checkpoint of ``step`` under ``ckpt_dir`` on the card, and its
    cursor."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
    from mtamrecommender_tpu_torch.train.trainer import (TrainState,
                                                         make_optimizer)

    model = get_model("MTAM").init(torch.Generator().manual_seed(0),
                                   cfg.model, meta).to(DEVICE)
    template = TrainState(model, make_optimizer(cfg.train).init(model), 0)
    return Checkpointer(ckpt_dir).restore(template, step=step,
                                          with_cursor=True)


def _states_equal(torch, a, b):
    from mtamrecommender_tpu_torch.train.trainer import moments

    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    params = all(torch.equal(pa[n], pb[n]) for n in pa)
    opt = a.opt_state.count == b.opt_state.count and all(
        torch.equal(t, moments(b.opt_state)[key][n])
        for key, m in moments(a.opt_state).items() for n, t in m.items())
    return params, opt


def log_cli_runs(torch, failures, data):
    """Phase 10, parts 2-3: `cli.main` in process to LOG_STEPS (the
    launches counted from 0 around it), then the same command as a
    subprocess to LOG_RESUME_AT and again with load_type=full to
    LOG_STEPS.  Returns (report, the in-process run's launches)."""
    from mtamrecommender_tpu_torch import cli

    report = {}
    meta, test_rows = data[0].meta, len(data[1])
    run = ["--version", "p10", "--max_steps", str(LOG_STEPS)]
    cwd = os.getcwd()
    os.chdir(LOG_RUN_DIR)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        with _LogLines() as logged:
            rc = cli.main(LOG_ARGS + run)
        report["in_process_s"] = time.perf_counter() - t0
        counts = _counts()
    finally:
        os.chdir(cwd)
    run_name = "synthetic_timed_MTAM_p10"
    events = _events(os.path.join(LOG_RUN_DIR, "runs", run_name,
                                  "events.jsonl"))
    losses = [e["train_loss"] for e in events if "train_loss" in e]
    evals = [e for e in events if "hr@10" in e]
    eval_steps = [e["step"] for e in evals]
    # each evaluation pass: ceil(test rows / 2,048) batches of 1 gru_scan
    # + 3 fused_attention_hop[time]
    batches = len(evals) * -(-test_rows // 2048)
    want = _want_counts(LOG_STEPS, gru="tgru", chain=True)
    want["gru_scan"]["tgru"] += batches
    want["fused_attention"]["time"] += 3 * batches
    want["fused_attention_hop"]["time"] += 3 * batches
    hr10 = evals[-1]["hr@10"] if evals else float("nan")
    native = any(m.startswith("examples (native builder)")
                 for m in logged.lines)
    # steady steps a second: display records 10 steps apart with no
    # evaluation between them (the eval at step s follows its display)
    stamps = {e["step"]: e["time"] for e in events if "train_loss" in e}
    gaps = [stamps[s] - stamps[s - 10] for s in stamps
            if s - 10 in stamps and (s - 10) % LOG_EVAL_FREQ != 0]
    steady = 10 / sorted(gaps)[len(gaps) // 2] if gaps else None
    ok = (rc == 0 and native and counts == want and len(losses) ==
          LOG_STEPS // 10 and all(math.isfinite(x) for x in losses)
          and sorted(set(eval_steps)) == [0, 40, 80, 120]
          and hr10 > 10 / 3600)
    report.update({"rc": rc, "native_builder": native, "losses": losses,
                   "eval_steps": eval_steps, "hr@10": hr10,
                   "ndcg@10": evals[-1]["ndcg@10"] if evals else None,
                   "eval_batches": batches, "launches": counts,
                   "steady_steps_per_s": steady, "ok": ok})
    print(f"from a log: cli.main to step {LOG_STEPS} in "
          f"{report['in_process_s']:.1f} s, native builder {native}, "
          f"evals at {eval_steps}, hr@10 {hr10:.4f} ndcg@10 "
          f"{report['ndcg@10']}, steady {steady} steps/s, launches "
          f"{_nonzero(counts)} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 10 cli run: {report}; launches "
                        f"{_nonzero(counts)}, want {_nonzero(want)}")

    # the same command as a user starts it: to step 80, then resumed
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mtamrecommender_tpu_torch"] + LOG_ARGS + [
        "--version", "p10r"]
    procs = []
    for extra in (["--max_steps", str(LOG_RESUME_AT)],
                  ["--max_steps", str(LOG_STEPS), "--set",
                   "train.load_type=full"]):
        t0 = time.time()
        proc = subprocess.run(cmd + extra, cwd=LOG_RUN_DIR, env=env,
                              capture_output=True, text=True, timeout=600)
        procs.append((proc, t0, time.time() - t0))
    events = _events(os.path.join(LOG_RUN_DIR, "runs",
                                  "synthetic_timed_MTAM_p10r",
                                  "events.jsonl"))
    first_eval = next(e["time"] for e in events if "hr@10" in e)
    resumed = f"resuming at step {LOG_RESUME_AT}" in procs[1][0].stderr
    cfg = _log_cfg(**{"model.compute_dtype": "bfloat16"})
    ckpt = os.path.join(LOG_RUN_DIR, "data", "check_point")
    a, cur_a = _ckpt_state(torch, cfg, meta, os.path.join(ckpt, run_name),
                           LOG_STEPS)
    b, cur_b = _ckpt_state(torch, cfg, meta, os.path.join(
        ckpt, "synthetic_timed_MTAM_p10r"), LOG_STEPS)
    params_eq, opt_eq = _states_equal(torch, a, b)
    best_eq = cur_a["best"] == cur_b["best"]
    ok = (all(p.returncode == 0 for p, _, _ in procs) and resumed
          and params_eq and opt_eq and best_eq)
    report["resume"] = {
        "rcs": [p.returncode for p, _, _ in procs],
        "wall_s": [s for _, _, s in procs],
        "start_to_first_step_s": first_eval - procs[0][1],
        "logged_resume": resumed, "params_equal": params_eq,
        "opt_state_equal": opt_eq, "best_equal": best_eq, "ok": ok}
    print(f"from a log: python -m mtamrecommender_tpu_torch to step "
          f"{LOG_RESUME_AT} in {procs[0][2]:.1f} s (first step "
          f"{report['resume']['start_to_first_step_s']:.1f} s after "
          f"launch), resumed to {LOG_STEPS} in {procs[1][2]:.1f} s: logged "
          f"resume {resumed}, parameters equal {params_eq}, Adam state "
          f"equal {opt_eq}, best equal {best_eq} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 10 resume: {report['resume']}; stderr "
                        f"{[p.stderr[-2000:] for p, _, _ in procs]}")
    return report, counts


def _log_trainer(torch, name, cfg, data, tag, device=DEVICE, **kw):
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.trainer import Trainer

    train, test = data
    return Trainer(cfg=cfg, model=get_model(name), train_data=train,
                   test_data=test, run_dir=os.path.join(LOG_RUN_DIR, tag),
                   device=device, **kw)


def log_trainer_checks(torch, failures, data):
    """Phase 10, parts 4-6: SASrec at dropout 0.5 resumed mid-epoch
    through the Trainer (3 + 3 steps against 6, steps_per_call 4); 6
    steps of the host path (prefetch_to_device) against the
    device-resident path, bit for bit; 10 f32 Trainer steps against the
    CPU's, each loss within
    TRAJ_LOSS_RTOL; the fit's step function timed (steps a second, the
    device's idle share from the profiler) and one evaluation pass."""
    from mtamrecommender_tpu_torch.data import device_data as dd
    from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer

    report = {}
    cfg = _log_cfg(**{"model.experiment_type": "SASrec",
                      "model.compute_dtype": "bfloat16",
                      "model.dropout": 0.5, "train.steps_per_call": 4,
                      "train.eval_freq": 10 ** 6})
    full = _log_trainer(torch, "SASrec", cfg, data, "sas_full").fit(
        max_steps=6)
    ck = Checkpointer(os.path.join(LOG_RUN_DIR, "sas_ck"))
    _log_trainer(torch, "SASrec", cfg, data, "sas_a").fit(
        max_steps=3, checkpointer=ck)
    t_b = _log_trainer(torch, "SASrec", cfg, data, "sas_b")
    restored, cursor = ck.restore(t_b.init_state(), with_cursor=True)
    start_epoch, skip = t_b.resume_from_cursor(cursor, restored)
    resumed = t_b.fit(restored, max_steps=6, start_epoch=start_epoch,
                      skip_steps=skip)
    params_eq, opt_eq = _states_equal(torch, full, resumed)
    ok = params_eq and opt_eq and (start_epoch, skip) == (0, 3)
    report["dropout_resume"] = {"params_equal": params_eq,
                                "opt_state_equal": opt_eq, "ok": ok}
    print(f"from a log: SASrec dropout 0.5, 3 + 3 Trainer steps against 6 "
          f"(steps_per_call 4): parameters equal {params_eq}, Adam state "
          f"equal {opt_eq} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 10 dropout resume: {report}")

    # the host path (batch_iterator + prefetch_to_device: pinned copies
    # on a side stream) against the device-resident path, MTAM in bf16
    cfg = _log_cfg(**{"model.compute_dtype": "bfloat16",
                      "train.eval_freq": 10 ** 6})
    fits = [_log_trainer(torch, "MTAM", cfg, data, f"host_{resident}",
                         device_resident=resident).fit(max_steps=6)
            for resident in (True, False)]
    params_eq, opt_eq = _states_equal(torch, *fits)
    ok = params_eq and opt_eq
    report["host_path"] = {"params_equal": params_eq,
                           "opt_state_equal": opt_eq, "ok": ok}
    print(f"from a log: 6 Trainer steps through batch_iterator + "
          f"prefetch_to_device against the device-resident path: "
          f"parameters equal {params_eq}, Adam state equal {opt_eq} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 10 host path: {report['host_path']}")

    # f32, the same initial parameters (a CPU generator) on both sides
    cfg = _log_cfg(**{"train.display_freq": 1, "train.eval_freq": 10 ** 6})
    losses = {}
    for device in (DEVICE, "cpu"):
        t = _log_trainer(torch, "MTAM", cfg, data, f"f32_{device}",
                         device=device)
        t.fit(max_steps=LOG_CPU_STEPS)
        losses[device] = [e["train_loss"] for e in _events(os.path.join(
            LOG_RUN_DIR, f"f32_{device}", "events.jsonl"))
            if "train_loss" in e]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[DEVICE],
                                                  losses["cpu"]))
    ok = len(losses[DEVICE]) == LOG_CPU_STEPS and err <= TRAJ_LOSS_RTOL
    report["against_cpu"] = {"losses_gpu": losses[DEVICE],
                             "losses_cpu": losses["cpu"], "loss_rel_err": err,
                             "ok": ok}
    print(f"from a log: {LOG_CPU_STEPS} f32 Trainer steps against the CPU: "
          f"loss rel err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 10 against the CPU: {report['against_cpu']}")

    # the fit's step function (the device-resident step) in bf16, timed
    # and profiled; then one evaluation pass
    cfg = _log_cfg(**{"model.compute_dtype": "bfloat16"})
    t = _log_trainer(torch, "MTAM", cfg, data, "timed")
    state = t.init_state()
    t._device_data = dd.to_device(t.train_data, t.device)
    order_np, n_steps = dd.epoch_order(len(t.train_data),
                                       cfg.train.train_batch_size, t.np_rng)
    order = torch.as_tensor(order_np, device=t.device)

    def steps(lo, n):
        for i in range(lo, lo + n):
            state.opt_state, _ = t.device_train_step(
                state.model, state.opt_state, t._device_data, order, i)

    steps(0, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(5, LOG_TIMED_STEPS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / LOG_TIMED_STEPS
    busy = _device_busy(torch, lambda: steps(5 + LOG_TIMED_STEPS,
                                             LOG_TIMED_STEPS))
    busy_ms = (None if busy["device_busy_ms"] is None
               else busy["device_busy_ms"] / LOG_TIMED_STEPS)
    t.evaluate(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.evaluate(state)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    report["timed"] = {
        "steps": LOG_TIMED_STEPS, "ms_per_step": wall_ms,
        "steps_per_s": 1e3 / wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "top_kernels": busy["top_kernels"][:5], "eval_pass_ms": eval_ms,
        "test_rows": len(t.test_data)}
    print(f"from a log: the fit's bf16 step {wall_ms:.3f} ms "
          f"({1e3 / wall_ms:.1f} steps/s), device busy {busy_ms} ms/step, "
          f"idle share {report['timed']['idle_share']}; one evaluation "
          f"pass ({len(t.test_data)} rows) {eval_ms:.1f} ms", flush=True)
    return report


def run_from_log(torch, failures):
    """Phase 10: the command line end to end from a generated log.
    Returns (report, the in-process cli run's launches)."""
    import shutil

    shutil.rmtree(LOG_RUN_DIR, ignore_errors=True)
    os.makedirs(LOG_RUN_DIR)
    try:
        report, data = log_builders(failures)
        runs, launches = log_cli_runs(torch, failures, data)
        report["cli"] = runs
        report.update(log_trainer_checks(torch, failures, data))
    finally:
        shutil.rmtree(LOG_RUN_DIR, ignore_errors=True)
    return report, launches


def _run_from_log_phase(torch, failures):
    """Phase 10 and the check that its main path launched MTAM's kernels;
    returns (report, the launches by kernel and mode)."""
    from_log, counts = run_from_log(torch, failures)
    launches = {}
    _add_launches(launches, counts)
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None), ("readout_chain", None),
                        ("readout_chain_bwd", None),
                        ("fused_attention_hop", "time")):
        if launches.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "command line's path")
    return from_log, launches


# ------------------------------------------------------------ phase 11

HEADS = 2                  # phase 11's head count: d = 128, 64 a head
HEADS_TIMED_STEPS = 8      # timed make_superstep steps a model and dtype
HEADS_LONG_BATCH = 16      # MTAM at L=512: the rows held against the CPU
HEADS_DISK_ROWS = 4        # the figures' test batch
HEADS_DISK_TOL = 1e-5      # the heatmaps, card vs CPU, absolute
HELPER_TOL = 1e-6          # the layer helpers, card vs CPU, relative
# the self-attention models and their dense-route mode at HEADS heads:
# SASrec and TiSAS at the cell's dropout 0.5, masks [B, h, L, L]
HEADS_SELF_ATTENTION = {"Time_Aware_Self_Attention_Model": "time",
                        "SASrec": "plain_drop",
                        "Ti_Self_Attention_Model": "tisas_drop"}


class HeadsSetup(ZooSetup):
    """Phase 4's cell (its data, order and catalog) at HEADS heads, the
    one-step checks on the first ``batch`` rows of phase 4's first
    batch."""

    def cfg(self, dname, name="MTAM"):
        return super().cfg(dname, name).with_overrides(
            **{"model.num_heads": HEADS})


class LongHeadsSetup:
    """Phase 6's cell at HEADS heads, its first HEADS_LONG_BATCH rows."""

    model = TrainSetup.model

    def __init__(self, long_setup):
        from mtamrecommender_tpu_torch.data.device_data import gather_batch

        self.meta = long_setup.meta
        self.batch = gather_batch(long_setup.data, long_setup.order, 0,
                                  HEADS_LONG_BATCH)
        self.batch_cpu = gather_batch(long_setup.data_cpu,
                                      long_setup.order_cpu, 0,
                                      HEADS_LONG_BATCH)

    @staticmethod
    def cfg(dname, name="MTAM"):
        return long_cfg(dname, name).with_overrides(
            **{"model.num_heads": HEADS})


def _heads_call_want():
    """One MTAM scoring call at HEADS heads: 1 gru_scan, then the three
    hops on the dense route, no attention kernel."""
    want = _want_counts(0)
    want["gru_scan"]["tgru"] = 1
    want["dense_fwd"]["time"] = 3
    return want


def heads_mtam(torch, setup, failures, launches):
    """MTAM at HEADS heads on phase 4's cell: one step against the CPU in
    f32 and bf16 (1 gru_scan + 1 gru_scan_bwd + 4 dtable, no attention,
    readout or chain kernel), HEADS_TIMED_STEPS timed steps in each, and
    recommend at B = 16 against the CPU and at B = 256 timed."""
    want = lambda steps, dname: _want_counts(steps, gru="tgru")  # noqa: E731
    rep = one_step_check(torch, setup, failures, "MTAM", want)
    rep.update(timed_steps(torch, setup, failures, "MTAM", want, launches,
                           steps=HEADS_TIMED_STEPS, warm=2))
    rep["serving"], got = serve_mtam(
        torch, 5, failures, setup.meta,
        {"model.num_heads": HEADS, "model.vocab_pad_multiple": 128},
        (16, TRAIN_BATCH), _heads_call_want(), f"heads={HEADS} serve")
    _add_launches(launches, got)
    return rep


def heads_self_attention(torch, setup, failures, launches):
    """The three self-attention models at HEADS heads: one step each
    against the CPU in f32 and bf16 (SASrec's and TiSAS's [B, h, L, L]
    masks drawn on the CPU and injected on both sides; 3 dense_fwd in
    the model's mode and 4 dtable a step, no attention kernel), then
    HEADS_TIMED_STEPS timed bf16 steps with the card's generator."""
    from mtamrecommender_tpu_torch.ops import layers

    report = {}
    b, L = setup.batch_cpu.items.shape
    for name, mode in HEADS_SELF_ATTENTION.items():
        want = lambda steps, dname, m=mode: _want_counts(  # noqa: E731
            steps, dense_fwd=m)
        masks = None
        if mode.endswith("_drop"):
            gen = torch.Generator().manual_seed(111)
            masks = [layers.draw_drop_mask(gen, b, L, L, 0.5, "cpu",
                                           num_heads=HEADS)
                     for _ in range(3)]
        rep = one_step_check(torch, setup, failures, name, want, masks)
        rep.update(timed_steps(torch, setup, failures, name, want, launches,
                               steps=HEADS_TIMED_STEPS, warm=2,
                               dtypes=("bfloat16",)))
        report[name] = rep
    return report


def heads_long(torch, long_setup, failures, launches):
    """MTAM at HEADS heads on phase 6's cell (L=512, the scalar gate), B
    = 16, f32: one step against the CPU with no fused_readout or
    fused_readout_bwd launch (256 to 1024 keys leave the readout kernels
    at h > 1), then recommend at B = 16 against the CPU."""
    setup = LongHeadsSetup(long_setup)
    want = lambda steps, dname: _want_counts(steps, gru="tgru")  # noqa: E731
    rep = one_step_check(torch, setup, failures, "MTAM", want,
                         dtypes=("float32",))
    rep["serving"], got = serve_mtam(
        torch, 3, failures, setup.meta,
        {"model.num_heads": HEADS, **LONG_OVERRIDES}, (HEADS_LONG_BATCH,),
        _heads_call_want(), f"heads={HEADS} L={LONG_L} serve")
    _add_launches(launches, got)
    return rep


def heads_from_disk(torch, setup, failures, launches):
    """The phase's MTAM from disk: 2 f32 make_superstep steps on the card,
    a Checkpointer save, then the figures' path up to its arrays
    (`figures.heatmap_arrays` of a Recommender.from_checkpoint) on the
    card and on the CPU: the heatmaps of a HEADS_DISK_ROWS-row test batch
    within HEADS_DISK_TOL, the item tables equal.  The t-SNE and the PNGs
    are host work the CPU tests hold (no sklearn or matplotlib here)."""
    import shutil
    import tempfile

    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.serve import Recommender
    from mtamrecommender_tpu_torch.train.checkpoint import Checkpointer
    from mtamrecommender_tpu_torch.train.trainer import (TrainState,
                                                         make_optimizer,
                                                         make_superstep)
    from mtamrecommender_tpu_torch.utils import figures

    cfg = setup.cfg("float32")
    model = setup.model(torch, cfg, DEVICE)
    opt = make_optimizer(cfg.train)
    run = make_superstep(get_model("MTAM"), cfg, opt, setup.meta.item_vocab,
                         setup.batch_size)
    _reset_counts()
    run(model, opt.init(model), setup.data, setup.order, 0, 2)
    torch.cuda.synchronize()
    steps = _counts()
    _add_launches(launches, steps)
    rows = type(setup.batch_cpu)(*(t[:HEADS_DISK_ROWS]
                                   for t in setup.batch_cpu))
    root = tempfile.mkdtemp(prefix="chip_smoke_heads_")
    try:
        Checkpointer(root).save(TrainState(model, None, 2))
        heat, table = {}, {}
        for dev in (DEVICE, "cpu"):
            rec = Recommender.from_checkpoint(cfg, setup.meta, root,
                                              device=dev)
            heat[dev] = figures.heatmap_arrays(rec, rows, HEADS_DISK_ROWS)
            table[dev] = rec.model.embedding.item_table.detach().cpu()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    err = max(float(np.abs(a - b).max())
              for a, b in zip(heat[DEVICE], heat["cpu"]))
    ok = (len(heat[DEVICE]) == HEADS_DISK_ROWS and err <= HEADS_DISK_TOL
          and torch.equal(table[DEVICE], table["cpu"])
          and steps == _want_counts(2, gru="tgru")
          and all(np.isfinite(h).all() for h in heat[DEVICE]))
    report = {"heatmap_max_abs_err": err, "tol": HEADS_DISK_TOL,
              "heatmap_shapes": [list(h.shape) for h in heat[DEVICE]],
              "launches_2_steps": steps, "ok": ok}
    print(f"heads={HEADS} from disk: heatmaps "
          f"{report['heatmap_shapes']} card vs CPU max abs err {err:.3e}, "
          f"item tables equal {torch.equal(table[DEVICE], table['cpu'])} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"heads from disk: {report}")
    return report


def heads_layer_helpers(torch, failures):
    """The five layer helpers on CUDA tensors against the CPU (B=256,
    L=50, d=128, lengths 1 to L): the output and the input's gradient of
    sum(out * cotangent), each within HELPER_TOL of the CPU's largest
    |value|."""
    from mtamrecommender_tpu_torch.ops import layers

    gen = torch.Generator().manual_seed(28)
    B, L, D = TRAIN_BATCH, 50, 128
    x = torch.randn(B, L, D, generator=gen)
    lengths = torch.randint(1, L + 1, (B,), generator=gen)
    lengths[0] = L
    alpha = torch.rand(D, generator=gen)
    helpers = {
        "sequential_average_pooling":
            lambda x, a, n: layers.sequential_average_pooling(x, n),
        "sequential_max_pooling":
            lambda x, a, n: layers.sequential_max_pooling(x, n),
        "prelu": lambda x, a, n: layers.prelu(x, a),
        "dice": lambda x, a, n: layers.dice(x, a),
        "gelu": lambda x, a, n: layers.gelu(x)}
    report = {}
    for name, fn in helpers.items():
        runs = {}
        for dev in ("cpu", DEVICE):
            xin = x.detach().clone().to(dev).requires_grad_(True)
            out = fn(xin, alpha.to(dev), lengths.to(dev))
            cot = torch.randn(out.shape, generator=torch.Generator(
            ).manual_seed(29)).to(dev)
            (out * cot).sum().backward()
            runs[dev] = (out.detach().cpu(), xin.grad.cpu())
        errs = [rel_err(got, want)[1]
                for got, want in zip(runs[DEVICE], runs["cpu"])]
        ok = max(errs) <= HELPER_TOL and all(
            bool(torch.isfinite(t).all()) for t in runs[DEVICE])
        report[name] = {"out_rel_err": errs[0], "grad_rel_err": errs[1],
                        "ok": ok}
        print(f"layer helper {name:26s} card vs CPU rel err out "
              f"{errs[0]:.3e} grad {errs[1]:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"layer helper {name}: {report[name]}")
    return report


def run_heads(torch, setup, long_setup, failures):
    """Phase 11: multi-head attention and the last single-device modules
    on the card.  Returns (report, the L=50 main path's launches, the
    L=512 part's launches)."""
    heads = HeadsSetup(setup, ZOO_CHECK_BATCH)
    report, launches, long_launches = {}, {}, {}
    t0 = time.perf_counter()
    report["MTAM"] = heads_mtam(torch, heads, failures, launches)
    report["self_attention"] = heads_self_attention(torch, heads, failures,
                                                    launches)
    report["MTAM@L512"] = heads_long(torch, long_setup, failures,
                                     long_launches)
    want = lambda steps, dname: _want_counts(  # noqa: E731
        steps, gru="tseqrec", dense_fwd="time")
    report["pistrec"] = one_step_check(torch, heads, failures, "pistrec",
                                       want, dtypes=("float32",))
    report["from_disk"] = heads_from_disk(torch, heads, failures, launches)
    report["layer_helpers"] = heads_layer_helpers(torch, failures)
    report["seconds"] = time.perf_counter() - t0
    fired = {k: {str(m): n for m, n in v.items() if n}
             for k, v in launches.items()}
    print(f"heads={HEADS} main path launches (L=50): "
          f"{ {k: v for k, v in fired.items() if v} }", flush=True)
    return report, launches, long_launches


def _run_heads_phase(torch, setup, long_setup, failures):
    """Phase 11 and the check that its main path ran the GRU pair and
    dtable, and no attention, readout or chain kernel (at h > 1 the
    attention takes the dense route, as in the JAX package)."""
    report, launches, long_launches = run_heads(torch, setup, long_setup,
                                                failures)
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None)):
        if launches.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "multi-head path")
    if launches.get("dense_fwd", {}).get("time", 0) == 0:
        failures.append("the multi-head path never took the dense route")
    for counts in (launches, long_launches):
        for kname in ("fused_attention", "fused_attention_bwd",
                      "fused_attention_blockwise", "fused_readout",
                      "fused_readout_bwd", "readout_chain",
                      "readout_chain_bwd"):
            if any(counts.get(kname, {}).values()):
                failures.append(f"{kname} was launched on the multi-head "
                                f"path: {counts[kname]}")
    return report, launches, long_launches


# ------------------------------------------------------------ phase 12

# the ranks' directory (their file store, results and runs): under the
# checkout's ignored build/, emptied first and removed afterwards
PHASE12_DIR = os.path.join(REPO_ROOT, "build", "phase12")
P12_WORLD = 4                # ranks spawned; the 2-rank runs use 0 and 1
P12_TIMED, P12_WARM = 8, 2   # timed bf16 steps a run, after warm-up steps
P12_EVAL_ROWS = 2048         # the sharded evaluation's batch
P12_EP = {"mesh.model_axis_size": 2, "mesh.shard_embeddings": True}
# each run: (label, ranks, mesh overrides, cell); run (a), the reference,
# is one rank with no overrides, in the parent
P12_RUNS = (("b_2x1", 2, {}, "L50"),
            ("c_1x2_psum", 2, {**P12_EP, "mesh.embedding_engine": "psum"},
             "L50"),
            ("c_1x2_a2a", 2, {**P12_EP, "mesh.embedding_engine": "a2a"},
             "L50"),
            ("d_2x2", 4, P12_EP, "L50"),
            ("e_1x2_cp", 2, {**P12_EP, "mesh.context_parallel": True},
             "L512"))
P12_TRAINER = {"train.eval_freq": 3, "train.save_freq": 3}
P12_TRAINER_ROWS = (1024, 256)    # train, test rows of the Trainer run
P12_CLI_STEPS = 6


def _p12_cfg(cell, dname, over):
    base = train_cfg(dname) if cell == "L50" else long_cfg(dname)
    return base.with_overrides(**over) if over else base


def _p12_want(cell, mesh_over):
    """A step's launches on a rank: the GRU pair, 4 dtable, and MTAM's
    training readout, the chain pair at L=50 and the fused readout pair
    at L=512; under CP (key-sharded hops in plain PyTorch) no readout
    kernel."""
    if cell == "L50":
        return _want_counts(1, gru="tgru", chain=True)
    return _want_counts(1, gru="tgru",
                        readout="mesh.context_parallel" not in mesh_over)


def _p12_eval_batch(torch, setup):
    """The sharded evaluation's batch: the cell's first P12_EVAL_ROWS
    rows."""
    from mtamrecommender_tpu_torch.data.device_data import gather_batch
    order = torch.arange(P12_EVAL_ROWS, dtype=torch.int32,
                         device=setup.data.seq_len.device)
    return gather_batch(setup.data, order, 0, P12_EVAL_ROWS)


def _p12_placed(torch, setup, cfg, mesh):
    from mtamrecommender_tpu_torch.parallel import sharding
    return sharding.place_params(mesh, cfg.mesh,
                                 setup.model(torch, cfg, DEVICE))


def _p12_checks(torch, setup, cell, over, mesh, eval_batch):
    """A run's checks on this rank's part: one step's loss and gradients
    (summed over the data group, the table shards gathered; rank 0 keeps
    them) in f32 and bf16; one sharded f32 step's launches counted from
    0; the sharded evaluation of the stepped model at B=2,048."""
    from mtamrecommender_tpu_torch.models.base import compute_loss
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.parallel import dist_trainer as dt
    from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib
    from mtamrecommender_tpu_torch.parallel import sharding

    mdef, vocab = get_model("MTAM"), setup.meta.item_vocab
    data_group = mesh.group(mesh.data_axis_name)
    out = {}
    for dname in ("float32", "bfloat16"):
        cfg = _p12_cfg(cell, dname, over)
        model = _p12_placed(torch, setup, cfg, mesh)
        local = sharding.place_batch(mesh, cfg.mesh, setup.batch)
        with dt._engine_scope(mesh, cfg):
            m = compute_loss(mdef, model, cfg.model, local, vocab)
        m["loss"].backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        dt._sum_over(grads, data_group)
        grads = sharding.gather_tensors(mesh, cfg.mesh, grads)
        loss = mesh_lib.all_reduce_(m["loss"].detach().clone(), data_group)
        out[dname] = {"loss": loss.item(),
                      "grads": ({n: g.float().cpu() for n, g in grads.items()}
                                if mesh.rank == 0 else None)}
    cfg = _p12_cfg(cell, "float32", over)
    model = _p12_placed(torch, setup, cfg, mesh)
    opt = dt.make_sharded_optimizer(cfg, mesh)
    step = dt.make_sharded_train_step(mdef, cfg, opt, mesh, vocab)
    state = opt.init(model)
    torch.cuda.synchronize()
    _reset_counts()
    state, m = step(model, state, setup.batch)
    torch.cuda.synchronize()
    out["launches"] = _counts()
    out["step_loss"] = m["loss"].item()
    ev = dt.make_sharded_eval_step(mdef, cfg, mesh, valid_vocab=vocab)
    out["eval"] = {k: v.item() for k, v in
                   ev(ev.cast(model), eval_batch).items()}
    return out


def _p12_timed(torch, setup, cell, over, mesh):
    """P12_TIMED bf16 steps of the sharded superstep (the Trainer's) after
    P12_WARM (CUDA events), then 2 under the profiler: ms a step, this rank's
    busy ms and idle share, and the device ms of the collectives'
    kernels and copies (NCCL kernels; gloo moves CUDA tensors through
    host memory by copies)."""
    from torch.profiler import ProfilerActivity, profile

    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.parallel import dist_trainer as dt

    cfg = _p12_cfg(cell, "bfloat16", over)
    model = _p12_placed(torch, setup, cfg, mesh)
    opt = dt.make_sharded_optimizer(cfg, mesh)
    run = dt.make_sharded_superstep(get_model("MTAM"), cfg, opt, mesh,
                                    setup.meta.item_vocab, setup.batch_size)
    state, _ = run(model, opt.init(model), setup.data, setup.order, 0,
                   P12_WARM)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, stacked = run(model, state, setup.data, setup.order, P12_WARM,
                         P12_TIMED)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / P12_TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(model, state, setup.data, setup.order, P12_WARM + P12_TIMED, 2)
        torch.cuda.synchronize()
    busy = coll = 0.0
    for e in prof.key_averages():
        on_dev = getattr(e, "self_device_time_total", 0) / 1e3
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy += on_dev
            key = e.key.lower()
            coll += on_dev if ("nccl" in key or "memcpy" in key) else 0.0
    busy /= 2
    return {"ms_per_step": ms, "device_busy_ms_per_step": busy or None,
            "idle_share": 1 - busy / ms if busy else None,
            "collective_device_ms_per_step": coll / 2,
            "losses_finite": bool(torch.isfinite(stacked["loss"]).all())}


def _p12_sub_mesh(cfg_mesh, n, rank):
    """The mesh of ranks 0..n-1 of the world (None on the others).  Every
    rank makes every group (``new_group`` is collective over the world)."""
    import torch.distributed as dist

    from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib

    ref = mesh_lib.build_mesh(cfg_mesh, n, 0)
    mesh = mesh_lib.build_mesh(cfg_mesh, n, rank) if rank < n else None
    for axis in (ref.model_axis_name, ref.data_axis_name):
        if ref.axis_size(axis) <= 1:
            continue
        for ranks in mesh_lib.group_lists(ref, axis):
            group = dist.new_group(ranks)
            if mesh is not None and rank in ranks:
                mesh.groups[axis] = group
    return mesh


def _p12_trainer(torch, setup, mesh, where):
    """A 2-rank Trainer (mesh 1x2, row-sharded tables, f32) fitted to
    step 6 unbroken, and fitted to step 3, saved, restored by a fresh
    Trainer (apply_load_type "full" with the cursor) and fitted on to 6:
    whether the two runs' gathered parameters and Adam moments are
    equal."""
    from mtamrecommender_tpu_torch.data.pipeline import PackedDataset
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.parallel import sharding
    from mtamrecommender_tpu_torch.train.checkpoint import (Checkpointer,
                                                            apply_load_type)
    from mtamrecommender_tpu_torch.train.trainer import Trainer

    cfg = train_cfg("float32").with_overrides(**P12_EP, **P12_TRAINER)
    train, test = (PackedDataset(**make_train_arrays(setup.meta, n, seed=s),
                                 meta=setup.meta)
                   for n, s in zip(P12_TRAINER_ROWS, (3, 4)))

    def trainer(tag):
        return Trainer(cfg=cfg, model=get_model("MTAM"), train_data=train,
                       test_data=test, run_dir=os.path.join(where, tag),
                       mesh=mesh)

    def final(t, state):
        return (sharding.gather_params(mesh, cfg.mesh, state.model),
                sharding.gather_opt_state(t.placement, state.opt_state,
                                          state.model))

    t = trainer("unbroken")
    state = t.fit(t.init_state(), max_steps=6, checkpointer=Checkpointer(
        os.path.join(where, "ckpt_a"), placement=t.placement))
    unbroken = final(t, state)
    ckpt_dir = os.path.join(where, "ckpt_b")
    t = trainer("broken")
    t.fit(t.init_state(), max_steps=3, checkpointer=Checkpointer(
        ckpt_dir, placement=t.placement))
    t = trainer("resumed")
    state, cursor = apply_load_type(
        cfg.with_overrides(**{"train.load_type": "full"}).train,
        t.init_state(), ckpt_dir, optimizer_init=t.optimizer.init,
        with_cursor=True, placement=t.placement)
    restored_step = state.step
    start_epoch, skip = t.resume_from_cursor(cursor, state)
    state = t.fit(state, max_steps=6, checkpointer=Checkpointer(
        ckpt_dir, placement=t.placement), start_epoch=start_epoch,
        skip_steps=skip)
    resumed = final(t, state)
    params_eq = all(torch.equal(unbroken[0][n], resumed[0][n])
                    for n in unbroken[0])
    opt_eq = all(torch.equal(a[n], b[n])
                 for a, b in zip(unbroken[1][1:], resumed[1][1:])
                 for n in a)
    return {"restored_step": restored_step, "skip_steps": skip,
            "final_step": state.step, "params_equal": params_eq,
            "adam_equal": opt_eq}


def _p12_warm(torch, setup):
    """A rank's first-call costs (library loads, cuBLAS, the profiler)
    off the clock: one bf16 forward and backward of the L=50 cell, under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mtamrecommender_tpu_torch.models.base import compute_loss
    from mtamrecommender_tpu_torch.models.registry import get_model

    cfg = _p12_cfg("L50", "bfloat16", {})
    model = setup.model(torch, cfg, DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        compute_loss(get_model("MTAM"), model, cfg.model, setup.batch,
                     setup.meta.item_vocab)["loss"].backward()
        torch.cuda.synchronize()


def _p12_rank(rank, world, backend, where):
    """One spawned rank of phase 12: its setup and a warm-up step (no
    collective), then, once the parent's reference is done (the file
    ``<where>/go``), every run of P12_RUNS it belongs to and the Trainer
    run on ranks 0 and 1; results to ``<where>/out_<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from mtamrecommender_tpu_torch.parallel import dist_trainer as dt
    from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    os.chdir(where)          # the Trainer's log files land here
    dt.initialize_distributed(backend, f"file://{os.path.join(where, 'store')}",
                              world, rank)
    t0 = time.perf_counter()
    setups = {"L50": TrainSetup(torch), "L512": LongSetup(torch)}
    evals = {k: _p12_eval_batch(torch, s) for k, s in setups.items()}
    _p12_warm(torch, setups["L50"])
    results = {"setup_s": time.perf_counter() - t0}
    while not os.path.exists(os.path.join(where, "go")):
        time.sleep(0.05)
    dist.barrier()

    def done(what, seconds):
        if rank == 0:
            print(f"phase 12 rank 0: {what} in {seconds:.1f} s", flush=True)

    done("setup and warm-up", results["setup_s"])
    for label, n, over, cell in P12_RUNS:
        t0 = time.perf_counter()
        mesh = _p12_sub_mesh(_p12_cfg(cell, "float32", over).mesh, n, rank)
        if mesh is not None:
            before = dict(mesh_lib.collective_calls)
            res = _p12_checks(torch, setups[cell], cell, over, mesh,
                              evals[cell])
            res["timed"] = _p12_timed(torch, setups[cell], cell, over, mesh)
            res["collectives"] = {k: v - before[k] for k, v in
                                  mesh_lib.collective_calls.items()}
            res["seconds"] = time.perf_counter() - t0
            results[label] = res
            done(label, res["seconds"])
        dist.barrier()
    t0 = time.perf_counter()
    mesh = _p12_sub_mesh(_p12_cfg("L50", "float32", P12_EP).mesh, 2, rank)
    if mesh is not None:
        results["trainer"] = _p12_trainer(torch, setups["L50"], mesh,
                                          os.path.join(where, "trainer"))
        results["trainer"]["seconds"] = time.perf_counter() - t0
        done("trainer", results["trainer"]["seconds"])
    dist.barrier()
    torch.save(results, os.path.join(where, f"out_{rank}.pt"))
    dist.destroy_process_group()


def _p12_leaves(got, ref, dname, hold_bf16_scalars):
    """A run's gathered gradients against the reference's: f32 each
    leaf's max |diff| over the reference's largest |value|, within
    TRAIN_TOL; bf16 as phase 4 holds the card against the CPU: within
    TRAIN_TOL of the reference's f32 scale plus the reference's own bf16
    gap to its f32 leaf.  Without ``hold_bf16_scalars`` the bf16
    gradients of scalar leaves (the scalar decay gates) are reported, not
    held, as phase 7 reports them: each is a sum over the batch's keys
    whose terms cancel, which the key-sharded hops take in bf16 and the
    fused readout kernel in f32.  Returns (worst rel err, its leaf, ok,
    the scalar leaves only reported)."""
    worst, worst_leaf, ok, reported = 0.0, None, True, {}
    for leaf, want in ref[dname]["grads"].items():
        g = got[dname]["grads"][leaf]
        scale = max(ref["float32"]["grads"][leaf].abs().max().item(), 1e-30)
        diff = (g - want).abs().max().item()
        allowed = TRAIN_TOL[dname] * scale
        if dname == "bfloat16":
            allowed += (want - ref["float32"]["grads"][leaf]).abs().max(
            ).item()
        finite = bool(g.isfinite().all())
        if dname == "bfloat16" and g.dim() == 0 and not hold_bf16_scalars:
            reported[leaf] = diff / scale
            ok = ok and finite
            continue
        ok = ok and finite and diff <= allowed
        if diff / scale > worst:
            worst, worst_leaf = diff / scale, leaf
    return worst, worst_leaf, ok, reported


def _p12_check(label, n, over, cell, ref, outs, failures):
    """A run's results on its ranks against the reference run's."""
    row = {"ranks": n, "mesh_over": over, "cell": cell, "per_rank": []}
    want = _p12_want(cell, over)
    ok = True
    chief = outs[0][label]
    for dname in ("float32", "bfloat16"):
        loss_rel = abs(chief[dname]["loss"] - ref[dname]["loss"]) / abs(
            ref[dname]["loss"])
        worst, leaf, good, reported = _p12_leaves(
            chief, ref, dname, "mesh.context_parallel" not in over)
        good = good and loss_rel <= (1e-5 if dname == "float32" else 2e-2)
        row[dname] = {"loss": chief[dname]["loss"], "loss_rel_err": loss_rel,
                      "worst_leaf_rel_err": worst, "worst_leaf": leaf,
                      "reported_only": reported, "ok": good}
        ok = ok and good
    for out in outs[:n]:
        got = out[label]
        launches_ok = got["launches"] == want
        # the CP run's scores come from the key-sharded hops in plain
        # PyTorch, the reference's from the fused readout kernel: there a
        # metric may move by one row's share
        eval_ok = got["eval"] == ref["eval"] or (
            "mesh.context_parallel" in over and all(
                abs(v - ref["eval"][k]) <= 1 / P12_EVAL_ROWS
                for k, v in got["eval"].items()))
        row["per_rank"].append({
            "launches": _nonzero(got["launches"]), "launches_ok": launches_ok,
            "eval": got["eval"], "eval_equal": got["eval"] == ref["eval"],
            "eval_ok": eval_ok, "step_loss": got["step_loss"],
            "timed": got["timed"], "collectives": got["collectives"],
            "seconds": got["seconds"]})
        ok = ok and launches_ok and eval_ok and got["timed"]["losses_finite"]
    row["ok"] = ok
    t = [p["timed"] for p in row["per_rank"]]
    print(f"phase 12 ({label}) {n} ranks {cell}: f32 loss rel err "
          f"{row['float32']['loss_rel_err']:.2e} worst leaf "
          f"{row['float32']['worst_leaf_rel_err']:.2e} "
          f"({row['float32']['worst_leaf']}); bf16 loss rel err "
          f"{row['bfloat16']['loss_rel_err']:.2e} worst leaf "
          f"{row['bfloat16']['worst_leaf_rel_err']:.2e} "
          f"({row['bfloat16']['worst_leaf']}; scalar gates reported, not "
          f"held: {row['bfloat16']['reported_only'] or 'none'}); "
          f"launches/step/rank "
          f"{row['per_rank'][0]['launches']} exact "
          f"{all(p['launches_ok'] for p in row['per_rank'])}; eval equal "
          f"{[p['eval_equal'] for p in row['per_rank']]} (hr@10 "
          f"{chief['eval']['hr@10']:.4f}); bf16 ms/step by rank "
          f"{[round(x['ms_per_step'], 3) for x in t]}, busy ms "
          f"{[x['device_busy_ms_per_step'] for x in t]}, idle "
          f"{[x['idle_share'] for x in t]}, collectives device ms "
          f"{[round(x['collective_device_ms_per_step'], 3) for x in t]}; "
          f"{chief['collectives']} collectives a rank "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 12 ({label}): "
                        f"{json.dumps(row, default=str)[:3000]}")
    return row


def _p12_cli_start(backend):
    """Start ``python -m torch.distributed.run --nproc_per_node 2 -m
    mtamrecommender_tpu_torch --model_parallel 2`` on phase 10's log
    (synthetic_timed at its default size), P12_CLI_STEPS steps."""
    where = os.path.join(PHASE12_DIR, "cli")
    os.makedirs(where)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mtamrecommender_tpu_torch",
           "--model_parallel", "2", "--dist_backend", backend, *LOG_ARGS,
           "--version", "p12", "--max_steps", str(P12_CLI_STEPS)]
    with open(os.path.join(where, "cli.log"), "w") as out:
        proc = subprocess.Popen(cmd, cwd=where, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, time.perf_counter(), backend, where


def _p12_cli_finish(started, failures):
    proc, t0, backend, where = started
    proc.wait(timeout=300)
    wall = time.perf_counter() - t0
    with open(os.path.join(where, "cli.log")) as f:
        log = f.read()
    ckpt = os.path.join(where, "data", "check_point",
                        "synthetic_timed_MTAM_p12")
    saved = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    ok = (proc.returncode == 0
          and log.count("mesh: {'data': 1, 'model': 2}") == 1
          and log.count(f"done at step {P12_CLI_STEPS}") == 1
          and saved == [str(P12_CLI_STEPS)])
    print(f"phase 12 cli: torch.distributed.run 2 ranks --model_parallel 2 "
          f"--dist_backend {backend}: rc {proc.returncode} in {wall:.1f} s "
          f"(beside the reference's checks), checkpoints {saved} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"phase 12 cli: rc {proc.returncode}: {log[-3000:]}")
    return {"rc": proc.returncode, "wall_s": wall, "checkpoints": saved,
            "ok": ok}


def _p12_reference(torch, setups, failures, cli):
    """Run (a): one rank on a 1-rank NCCL group, mesh 1x1, each cell:
    the checks beside the command line's run, then, once it is done, the
    timed steps."""
    import torch.distributed as dist

    from mtamrecommender_tpu_torch.config import MeshConfig
    from mtamrecommender_tpu_torch.parallel import mesh as mesh_lib

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(PHASE12_DIR, 'ref')}",
        world_size=1, rank=0)
    try:
        mesh = mesh_lib.attach_groups(mesh_lib.build_mesh(MeshConfig()))
        refs = {cell: _p12_checks(torch, s, cell, {}, mesh,
                                  _p12_eval_batch(torch, s))
                for cell, s in setups.items()}
        cli_report = _p12_cli_finish(cli, failures)
        for cell, s in setups.items():
            refs[cell]["timed"] = _p12_timed(torch, s, cell, {}, mesh)
    finally:
        dist.destroy_process_group()
    for cell, ref in refs.items():
        want = _p12_want(cell, {})
        ok = ref["launches"] == want
        t = ref["timed"]
        print(f"phase 12 (a) 1 rank nccl mesh 1x1 {cell}: loss f32 "
              f"{ref['float32']['loss']:.6f} bf16 {ref['bfloat16']['loss']:.6f}"
              f", launches/step {_nonzero(ref['launches'])} "
              f"{'ok' if ok else 'FAIL'}; timed bf16 ms/step "
              f"{t['ms_per_step']:.3f} busy ms/step "
              f"{t['device_busy_ms_per_step']} idle_share {t['idle_share']}",
              flush=True)
        if not ok:
            failures.append(f"phase 12 (a) {cell}: launches "
                            f"{_nonzero(ref['launches'])}")
    return refs, cli_report


def run_phase12(torch, setup, long_setup, failures):
    """Phase 12: parallel/ on torch.distributed.  P12_WORLD ranks are
    spawned (NCCL where each has its own card, gloo where they share
    one) and the command line's run under torch.distributed.run is
    started; while both set up, run (a), the reference, runs its checks
    in this process on a 1-rank NCCL group; once the command line is
    done, (a)'s timed steps, then the ranks run (b)-(e) of P12_RUNS and
    the Trainer's resume.  Returns (report, the launches of the L=50
    runs' counted steps, (a)'s included, those of the L=512 runs')."""
    import shutil

    import torch.multiprocessing as mp

    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    os.makedirs(PHASE12_DIR)
    report, l50, l512 = {}, {}, {}
    ranks = None
    try:
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= P12_WORLD else "gloo"
        print(f"phase 12: world {P12_WORLD} on {cards} card(s), backend "
              f"{backend}; runs (label, ranks, mesh overrides): "
              + ", ".join(f"{label} {n} {over or 'data axis 2'}"
                          for label, n, over, _ in P12_RUNS)
              + f"; collectives staged through host memory: "
              f"{'yes (gloo copies CUDA tensors to the host)' if backend == 'gloo' else 'no'}",
              flush=True)
        t0 = time.perf_counter()
        cli = _p12_cli_start("nccl" if cards >= 2 else "gloo")
        ranks = mp.spawn(_p12_rank, args=(P12_WORLD, backend, PHASE12_DIR),
                         nprocs=P12_WORLD, join=False)
        refs, report["cli"] = _p12_reference(
            torch, {"L50": setup, "L512": long_setup}, failures, cli)
        report["reference_s"] = time.perf_counter() - t0
        with open(os.path.join(PHASE12_DIR, "go"), "w"):
            pass
        while not ranks.join():
            pass
        ranks = None
        report["ranks_s"] = time.perf_counter() - t0 - report["reference_s"]
        outs = [torch.load(os.path.join(PHASE12_DIR, f"out_{r}.pt"),
                           weights_only=False) for r in range(P12_WORLD)]
        report["rank_setup_s"] = [o["setup_s"] for o in outs]
        for cell, ref in refs.items():
            _add_launches(l50 if cell == "L50" else l512, ref["launches"])
        for label, n, over, cell in P12_RUNS:
            report[label] = _p12_check(label, n, over, cell, refs[cell],
                                       outs, failures)
            for out in outs[:n]:
                _add_launches(l50 if cell == "L50" else l512,
                              out[label]["launches"])
        trainer = [o["trainer"] for o in outs[:2]]
        ok = all(t["params_equal"] and t["adam_equal"]
                 and t["restored_step"] == 3 and t["final_step"] == 6
                 for t in trainer)
        report["trainer"] = {"ranks": trainer, "ok": ok}
        print(f"phase 12 trainer: 2 ranks mesh 1x2, fit to 6 against fit to "
              f"3 + save + restore + fit to 6: parameters equal "
              f"{[t['params_equal'] for t in trainer]}, Adam equal "
              f"{[t['adam_equal'] for t in trainer]} "
              f"({trainer[0]['seconds']:.1f} s) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"phase 12 trainer resume: {trainer}")
        report["references"] = {
            cell: {k: v for k, v in r.items() if k not in ("float32",
                                                           "bfloat16")}
            for cell, r in refs.items()}
    except Exception as exc:             # a rank's error: fail, report
        failures.append(f"phase 12: {type(exc).__name__}: {exc}")
    finally:
        if ranks is not None:            # a failure before the ranks ended
            for p in ranks.processes:
                p.kill()
        shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    return report, l50, l512


# ------------------------------------------------------------ phase 13

L256, L256_SMALL = 256, 16
# the self-attention models and each one's mode (the drop modes at the
# cell's dropout 0.5; serving takes the base mode)
L256_MODELS = {"Time_Aware_Self_Attention_Model": "time",
               "SASrec": "plain_drop", "Ti_Self_Attention_Model": "tisas_drop"}


class L256Setup:
    """The self-attention models at the JAX package's L=256 run
    (benchmarks/long_history_bench.py --seq_len 256, the record
    benchmarks/results/long_history_r5sasdrop256.json: phase 6's cell at
    L=256, B=64, d=128, 3 blocks, 1 head, the scalar gate, dropout 0.5):
    2048 rows of markov_long_arrays (seed 0) on the card and on the CPU,
    three epoch orders.  ``batch`` and ``batch_cpu`` are the first
    L256_SMALL rows, the size the CPU's one-step comparisons afford."""

    L = L256
    batch_size = LONG_BATCH
    model = TrainSetup.model

    @classmethod
    def cfg(cls, dname, name="MTAM"):
        return long_cfg(dname, name, L=cls.L)

    def __init__(self, torch):
        from mtamrecommender_tpu_torch.data.device_data import (epoch_order,
                                                                 gather_batch,
                                                                 to_device)
        from mtamrecommender_tpu_torch.types import DatasetMeta

        self.meta = DatasetMeta(*LONG_META[:3], self.L)
        arrays = markov_long_arrays(LONG_ROWS, self.L, self.meta.item_count,
                                    self.meta.category_count, seed=0)
        self.data = to_device(arrays)               # CUDA: the default
        self.data_cpu = to_device(arrays, device="cpu")
        epochs = [epoch_order(LONG_ROWS, LONG_BATCH,
                              np.random.RandomState(e))[0] for e in range(3)]
        order = np.concatenate(epochs)
        self.order = torch.tensor(order, device=DEVICE)
        self.order_cpu = torch.tensor(order)
        self.batch = gather_batch(self.data, self.order, 0, L256_SMALL)
        self.batch_cpu = gather_batch(self.data_cpu, self.order_cpu, 0,
                                      L256_SMALL)


@contextlib.contextmanager
def wide_twins():
    """Within the block the attention pair's CPU twins are the wide
    designs' (`_wide_fwd_design_plain`, `_wide_design_plain`): the CPU
    sums in the kernels' blocking and order."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    fwd, bwd = ak.fused_attention_plain, ak.fused_attention_bwd_plain
    ak.fused_attention_plain = ak._wide_fwd_design_plain
    ak.fused_attention_bwd_plain = ak._wide_design_plain
    try:
        yield
    finally:
        ak.fused_attention_plain, ak.fused_attention_bwd_plain = fwd, bwd


def exact_gate_terms(torch, mode, g, args):
    """Every gate term of one fused_attention_bwd call (its arguments
    ``g`` and ``args`` on the CPU; gate params [Tq, Tk] tiles or scalars)
    in float64:
    `reference_middle` under autograd in f64, each gate param spread over
    [B, Tq, Tk], the cotangent g; terms at keys past a row's key_len are
    0, as the kernel's.  Returns the five [B, Tq, Tk] planes in the
    order of the backward's gate outputs."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    b, tq = g.shape[:2]
    tk = args[1].shape[1]
    x = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
         for a in args]
    gates = [x[i].expand(b, tq, tk).clone().requires_grad_()
             for i in range(7, 12)]
    x[7:12] = gates
    out = ak.reference_middle(mode, *x, dtype=torch.float64)
    terms = torch.autograd.grad((out * g.double()).sum(), gates)
    live = torch.arange(tk)[None, None, :] < args[12][:, None, None]
    return [torch.where(live, t, torch.zeros_like(t)) for t in terms]


def gate_terms_check(torch, setup, name, failures):
    """The wide backward's gate cotangents on the card's own inputs
    against float64 (phase 13, f32, the time mode).  One step of ``name``
    on the card keeps each fused_attention_bwd call's arguments and
    results.  On the same arguments, copied to the CPU, the wide twin
    (`_wide_design_plain`) gives its f32 terms (those `_gate_sum` adds)
    and sums, and `exact_gate_terms` every term in f64.  The card's
    terms are its call again a batch row at a time (the gate launch then
    sums one row, so its planes are that row's terms).  Per gate leaf (a
    block's scalar gate: the sum of its [Tq, Tk] plane) two things are
    held within TRAIN_TOL["float32"]: every card term's distance from the
    f64 term, relative to the largest |f64 term|, and the card's sum's
    from the exact sum of its own terms (the gate sums' order), relative
    to the leaf's |value|.  Reported: the largest distance between a
    card term and the twin's, and each side's from f64, in f32 eps of
    that largest term; the card's and the twin's sums from f64, relative
    to the leaf's |value| and in units of u R, where u is f32's unit
    roundoff and R = sqrt(sum over the call's batch rows and queries of
    (sum |t| over the keys)^2), the spread that a relative rounding
    shared by one query's terms (its softmax weights' sum, its D_i)
    gives the sum; the cancellation, sum |t| / |sum t|.  Returns
    {leaf: {...}}."""
    from mtamrecommender_tpu_torch.ops.attention import GATE_PARAMS
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    cfg = setup.cfg("float32", name)
    bwd, calls = ak.fused_attention_bwd, []

    def kept(mode, g, *args):
        out = bwd(mode, g, *args)
        calls.append((mode, g.detach(), [None if a is None else a.detach()
                                         for a in args], out))
        return out

    ak.fused_attention_bwd = kept
    try:
        _loss_grads(torch, cfg, setup.model(torch, cfg, DEVICE), setup.batch,
                    setup.meta.item_vocab)
    finally:
        ak.fused_attention_bwd = bwd
    gate_sum, twin_terms = ak._gate_sum, []

    def terms_kept(terms, rows):
        twin_terms.append(terms)
        return gate_sum(terms, rows)

    batch_args = (0, 1, 2, 3, 4, 5, 6, 12, 13)   # q .. rawk, key_len, dm
    eps, tol = torch.finfo(torch.float32).eps, TRAIN_TOL["float32"]
    report = {}
    for j, (mode, g, args, out) in enumerate(calls):
        block = len(calls) - 1 - j                 # the backward's order
        cpu = [None if a is None else a.cpu() for a in args]
        twin_terms.clear()
        ak._gate_sum = terms_kept
        try:
            twin = ak._wide_design_plain(mode, g.cpu(), *cpu)
        finally:
            ak._gate_sum = gate_sum
        exact = exact_gate_terms(torch, mode, g.cpu(), cpu)
        with torch.no_grad():
            rows = [bwd(mode, g[r:r + 1].contiguous(), *(
                a[r:r + 1].contiguous() if i in batch_args and a is not None
                else a for i, a in enumerate(args)))
                for r in range(g.shape[0])]
        for k, gate in enumerate(GATE_PARAMS):
            leaf = f"att.{block}.{gate}"
            card_t = torch.stack([row[5 + k] for row in rows]).cpu().double()
            twin_t, t64 = twin_terms[k].double(), exact[k]
            s64 = t64.sum().item()
            scale, unit = max(abs(s64), 1e-30), max(
                t64.abs().max().item(), 1e-30)
            card, wide = out[5 + k].sum().item(), twin[5 + k].sum().item()
            spread = eps / 2 * t64.abs().sum(-1).square().sum().sqrt().item()
            r = report[leaf] = {
                "f64": s64,
                "cancellation": t64.abs().sum().item() / scale,
                "card_sum_from_f64": abs(card - s64) / scale,
                "twin_sum_from_f64": abs(wide - s64) / scale,
                "card_sum_from_f64_uR": abs(card - s64) / spread,
                "twin_sum_from_f64_uR": abs(wide - s64) / spread,
                "card_sum_from_its_terms": abs(
                    card - card_t.sum().item()) / scale,
                "card_terms_from_f64_eps": (card_t - t64).abs().max().item()
                / (eps * unit),
                "twin_terms_from_f64_eps": (twin_t - t64).abs().max().item()
                / (eps * unit),
                "card_terms_from_twin_eps": (card_t - twin_t).abs().max()
                .item() / (eps * unit)}
            r["ok"] = (math.isfinite(card)
                       and r["card_sum_from_its_terms"] <= tol
                       and r["card_terms_from_f64_eps"] * eps <= tol)
            print(f"    gate terms {name} {leaf:24s} cancellation="
                  f"{r['cancellation']:.1e}; sum from f64: card "
                  f"{r['card_sum_from_f64']:.2e} = "
                  f"{r['card_sum_from_f64_uR']:.2f} uR (its sums "
                  f"{r['card_sum_from_its_terms']:.2e}), twin "
                  f"{r['twin_sum_from_f64']:.2e} = "
                  f"{r['twin_sum_from_f64_uR']:.2f} uR; terms in eps of the "
                  f"largest: card-f64 {r['card_terms_from_f64_eps']:.1f}, "
                  f"twin-f64 {r['twin_terms_from_f64_eps']:.1f}, card-twin "
                  f"{r['card_terms_from_twin_eps']:.1f} "
                  f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
            if not r["ok"]:
                failures.append(f"gate terms {name} {leaf}: {r}")
    return report


def run_l256(torch, failures):
    """Phase 13: Time_Aware_SA, SASrec and TiSAS at L=256 (`L256Setup`):
    one step's loss and every gradient leaf against the CPU in f32 and
    bf16 at B = L256_SMALL (SASrec's and TiSAS's masks drawn on the CPU
    and injected on both sides; each f32 leaf allowed the CPU's gap
    between the plain twins' order and the wide designs' (`wide_twins`),
    and its distance from an f64 CPU step printed for the card and both
    orders), Time_Aware_SA's gate cotangents on the card's own inputs
    against f64 (`gate_terms_check`), the launches of the step exactly (3
    fused_attention + 3 fused_attention_bwd, all in the wide design, + 4
    dtable; no query, rows or dense launch), the step timed at B=64 in
    bf16 and f32 with its device idle share (the drop modes' masks from
    the card's generator), and Recommender.recommend at B = 1, 16, 64 in
    bf16 and f32 against the CPU at each B (3 wide forward launches of
    the base mode a call).  Returns (report, launches)."""
    from mtamrecommender_tpu_torch.ops import layers

    setup = L256Setup(torch)
    report, launches = {}, {}
    for name, mode in L256_MODELS.items():
        def want(steps, dname, mode=mode):
            counts = _want_counts(steps, attention=mode)
            counts["fused_attention_wide"][mode] = 3 * steps
            counts["fused_attention_bwd_wide"][mode] = 3 * steps
            return counts
        masks = None
        if mode.endswith("_drop"):
            cpu_gen = torch.Generator().manual_seed(99)
            masks = [layers.draw_drop_mask(cpu_gen, L256_SMALL, L256, L256,
                                           0.5, "cpu") for _ in range(3)]
        rep = one_step_check(torch, setup, failures, name, want, masks,
                             cpu_order=wide_twins)
        if mode == "time":
            rep["gate_terms_against_f64"] = gate_terms_check(
                torch, setup, name, failures)
        rep.update(timed_steps(torch, setup, failures, name, want, launches,
                               steps=10, warm=2))
        report[name] = rep

        def want_call(dname, base=mode.replace("_drop", "")):
            counts = _want_counts(0)
            counts["fused_attention"][base] = 3
            counts["fused_attention_wide"][base] = 3
            return counts
        report[f"{name}_serving"] = serve_xl(torch, failures, setup, name,
                                             want_call, launches,
                                             held_at_each=True)
    return report, launches


# ------------------------------------------------------------ phase 14

L150, L150_BATCH = 150, LONG_BATCH
L150_TIMED_STEPS = 5         # phase 14's timed steps a dtype


class L150Setup(L256Setup):
    """MTAM at the reference's attention cap (max_len 150, SURVEY.md §7;
    benchmarks/long_history_bench.py --seq_len 150): phase 6's cell at
    L=150, B=64, d=128, 3 hops, 1 head, the scalar gate, 2,000 items,
    2048 rows of markov_long_arrays (seed 0), three epoch orders;
    ``batch`` and ``batch_cpu`` its first L256_SMALL rows."""

    L = L150


def check_l150_query(torch, timer, iters, failures):
    """Phase 14's serving hops' kernel: fused_attention at Tq = 1, Tk=150,
    d=128 in the time mode (MTAM's hops, 3 a call) and the plain mode
    (the plain-kind readout's, MTAM_no_time_aware_att's 3 a call), in f32
    and bf16, against the twin at B = 1, 16, 64 (`check_attention_fwd`;
    ragged keys, a row with no live key; the same bits twice, within
    TILE_FWD_TOL of the query design forced) in the design it must pick
    there ("blocked"), timed at B=64 in turns with the query design
    forced (`time_attention_fwd`: event, device and host ms of both), the
    twin, the bound, the design's shared memory a block and blocks an SM
    and, for the plain mode, scaled_dot_product_attention.  Returns the
    kernels line's entries (``@L150Tq1``)."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(150150)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in ("time", "plain"):
            acc = {"err": 0.0, "rel": 0.0, "ok": True}
            for bs in (1, 16, L150_BATCH):
                args = att_inputs(torch, gen, dtype, B=bs, Tk=L150)
                acc = check_attention_fwd(torch, ak, mode, args, None, dname,
                                          acc)
            design = ak.attention_fwd_design(dtype, 1, L150, 128)
            row = {"design": design, "source": FWD_SOURCES[design],
                   "earlier_design": "query",
                   "max_abs_err": acc["err"], "rel_err": acc["rel"],
                   "tol": KERNEL_TOL[dname],
                   **{k: v for k, v in acc.items()
                      if k not in ("err", "rel", "ok")},
                   "ok": acc["ok"] and design == "blocked", "Tk": L150,
                   "B": L150_BATCH,
                   **time_attention_fwd(timer, ak, mode, args, None, iters),
                   "plain_ms": timer(lambda: ak.fused_attention_plain(
                       mode, *args, None), max(iters // 10, 3)),
                   **att_bound(mode, args, dname),
                   **fwd_blocked_occupancy(ak, mode, dname, L150)}
            library = att_library(torch, mode, args)
            if library is not None:
                row["library_ms"] = timer(library, iters)
                row["library_call"] = "scaled_dot_product_attention"
            entries.setdefault(("fused_attention", mode, "L150Tq1"),
                               {})[dname] = row
            print(f"fused_attention {mode:6s} Tq=1 Tk={L150} B={L150_BATCH} "
                  f"{dname:9s} design={design} max_abs_err="
                  f"{row['max_abs_err']:.3e} rel={row['rel_err']:.3e} "
                  f"vs_query_rel={row.get('blocked_vs_query_rel_err')} "
                  f"same_bits={row.get('same_bits_twice')} ms="
                  f"{row['ms']:.4f} device_ms={row['device_ms']} host_ms="
                  f"{row['host_ms']:.4f} query_ms={row.get('query_ms')} "
                  f"query_device_ms={row.get('query_device_ms')} "
                  f"query_host_ms={row.get('query_host_ms')} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) library_ms={row.get('library_ms')} "
                  f"smem_bytes={row['smem_bytes']} blocks_per_sm="
                  f"{row['blocks_per_sm']} "
                  f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
            if not row["ok"]:
                failures.append(f"fused_attention {mode} Tq=1 Tk={L150} "
                                f"{dname}: {row}")
    return entries


def run_l150(torch, timer, failures):
    """Phase 14: MTAM at L=150 (`L150Setup`): one step's loss and every
    gradient leaf against the CPU in f32 and bf16 at B = L256_SMALL, the
    launches of the step exactly (1 gru_scan + 1 gru_scan_bwd, 1
    readout_chain + 1 readout_chain_bwd both in the blocked design, 4
    dtable; no rows-design, fused_readout or fused_attention launch),
    L150_TIMED_STEPS steps timed at B=64 in bf16 and f32 with the device
    idle share, the
    serving hops' kernel at Tq=1, Tk=150 (`check_l150_query`), and
    Recommender.recommend at B = 1, 16, 64 in bf16 and f32 against the
    CPU at each B for MTAM (1 gru_scan + 3 fused_attention[time] in the
    blocked design a call, none in the query design) and for
    MTAM_no_time_aware_att, the plain-kind readout (1 gru_scan + 3
    fused_attention[plain] in the blocked design a call).  Returns
    (report, the kernels line's entries, the steps' launches, the calls'
    launches)."""
    setup = L150Setup(torch)

    def want(steps, dname):
        counts = _want_counts(steps, gru="tgru", chain=True)
        counts["readout_chain_blocked"]["readout_chain_blocked"] = steps
        counts["readout_chain_bwd_blocked"][
            "readout_chain_bwd_blocked"] = steps
        return counts

    def want_call(mode):
        def counts_of(dname):
            counts = _want_counts(0)
            counts["gru_scan"]["tgru"] = 1
            counts["fused_attention"][mode] = 3
            counts["fused_attention_blocked"][mode] = 3
            return counts
        return counts_of

    launches, serve_launches = {}, {}
    report = one_step_check(torch, setup, failures, "MTAM", want)
    report.update(timed_steps(torch, setup, failures, "MTAM", want, launches,
                              steps=L150_TIMED_STEPS, warm=2))
    entries = check_l150_query(torch, timer, 50, failures)
    report["serving"] = serve_xl(torch, failures, setup, "MTAM",
                                 want_call("time"), serve_launches,
                                 held_at_each=True)
    report["serving_no_time_aware_att"] = serve_xl(
        torch, failures, setup, "MTAM_no_time_aware_att", want_call("plain"),
        serve_launches, held_at_each=True)
    return report, entries, launches, serve_launches


# ------------------------------------------------------------ phase 15

# every registry model's paths (ZooModel); phase 15 runs those whose
# kernels' designs read the sequence length and change past 64 keys
REGISTRY_PATHS = {
    "MTAM": ZooModel("tgru", "time"), **ZOO_MODELS,
    "Time_Aware_Self_Attention_Model": ZooModel(None, self_att="time"),
    "SASrec": ZooModel(None, self_att="plain_drop"),
    "Ti_Self_Attention_Model": ZooModel(None, self_att="tisas_drop")}
CAP_TIMED_STEPS = 3          # timed make_superstep steps a model, in bf16
CAP_PRESET_HOPS = {ZOO_PRESET[0]: ZOO_PRESET[1]}


def length_designs(spec, L, d=128, dtype_name="bfloat16"):
    """The designs of the kernels a step and a call of a model with paths
    ``spec`` launch whose design reads the sequence length L: the chain
    pair (`readout_chain_kernel._pick_design`, both halves) where it
    reads out in the time kind, the attention forward at Tq = 1 where it
    reads out, the attention pair at Tq = Tk = L where it self-attends
    (`attention_kernel.attention_fwd_design` / `attention_bwd_design`).
    The GRU pair and dtable read no length in their design."""
    import torch

    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import readout_chain_kernel as rc

    dt = getattr(torch, dtype_name)
    out = {}
    if spec.att == "time":
        out["readout_chain"] = rc.chain_fwd_design(dt, L, d)
        out["readout_chain_bwd"] = rc.chain_bwd_design(dt, L, d)
    if spec.att:
        out[f"fused_attention[{spec.att}]@Tq1"] = ak.attention_fwd_design(
            dt, 1, L, d)
    if spec.self_att:
        out[f"fused_attention[{spec.self_att}]"] = ak.attention_fwd_design(
            dt, L, L, d)
        out[f"fused_attention_bwd[{spec.self_att}]"] = \
            ak.attention_bwd_design(dt, L, L, d)
    return out


def models_at_cap(L=L150):
    """The registry models (REGISTRY_PATHS, which must name every entry
    of models/registry.py) whose kernels take another design at L keys
    than at phase 4's L=50: name -> (paths, hops, the designs at L)."""
    from mtamrecommender_tpu_torch.models.registry import MODEL_REGISTRY

    if set(REGISTRY_PATHS) != set(MODEL_REGISTRY):
        odd = sorted(set(REGISTRY_PATHS) ^ set(MODEL_REGISTRY))
        raise ValueError(f"REGISTRY_PATHS must name every registry model: "
                         f"{odd}")
    out = {}
    for name, spec in REGISTRY_PATHS.items():
        at = length_designs(spec, L)
        if at != length_designs(spec, 50):
            out[name] = (spec, spec.hops or CAP_PRESET_HOPS.get(name, 3), at)
    return out


class CapSetup:
    """Phase 14's data (``base``, an `L150Setup`) at the JAX package's
    default decay gate (positional: LONG_OVERRIDES' scalar gate dropped)
    with ``hops`` readout hops or blocks and the config ``over`` (a
    pistrec_type) on top; ``batch`` and ``batch_cpu`` are phase 14's
    first L256_SMALL rows."""

    model = TrainSetup.model
    batch_size = L150_BATCH

    def __init__(self, base, hops=3, over=None):
        for k in ("meta", "data", "data_cpu", "order", "order_cpu",
                  "batch", "batch_cpu"):
            setattr(self, k, getattr(base, k))
        self.hops, self.over = hops, dict(over or {})

    def cfg(self, dname, name="MTAM"):
        from mtamrecommender_tpu_torch.config import ModelConfig
        return L150Setup.cfg(dname, name).with_overrides(**{
            "model.time_gate_mode": ModelConfig().time_gate_mode,
            "model.num_blocks": self.hops, **self.over})


def _cap_want(spec, hops):
    """`_zoo_want`'s launches at L=150: the chain pair in its blocked
    design, the Tq = 1 forward's hops in the blocked design (none in the
    hop design), the self-attention pair in the wide designs."""
    train50, serve = _zoo_want(spec, hops)
    n = spec.hops or hops

    def train(steps, dname=None):
        want = train50(steps)
        if spec.att == "time":
            want["readout_chain_blocked"]["readout_chain_blocked"] = steps
            want["readout_chain_bwd_blocked"][
                "readout_chain_bwd_blocked"] = steps
        if spec.self_att:
            want["fused_attention_wide"][spec.self_att] = hops * steps
            want["fused_attention_bwd_wide"][spec.self_att] = hops * steps
        return want

    if spec.att:
        serve["fused_attention_hop"][spec.att] = 0
        serve["fused_attention_blocked"][spec.att] = n
    if spec.self_att:
        serve["fused_attention_wide"][spec.self_att.replace("_drop", "")] \
            = hops
    return train, lambda dname: serve


def _cap_model(torch, base, failures, name, spec, hops, steps, calls):
    """One model at the cap (`CapSetup`): one step against the CPU in f32
    and bf16 at B = L256_SMALL with its launches (draws injected:
    `_zoo_sources`), CAP_TIMED_STEPS steps timed at B=64 in bf16 after
    one warm-up (added to ``steps``), and recommend at B = 1, 16, 64 in
    bf16 and f32 against the CPU at each B (added to ``calls``)."""
    setup = CapSetup(base, hops)
    train_want, serve_want = _cap_want(spec, hops)
    rep = one_step_check(torch, setup, failures, name, train_want,
                         relu_kinks=True,
                         **_zoo_sources(torch, setup, name, spec))
    rep.update(timed_steps(torch, setup, failures, name, train_want, steps,
                           steps=CAP_TIMED_STEPS, warm=1,
                           dtypes=("bfloat16",)))
    rep["serving"] = serve_xl(torch, failures, setup, name, serve_want,
                              calls, held_at_each=True)
    return rep


def _pistrec_want(train_all, kind):
    """A PISTRec step's launches in ``kind`` (PISTREC_TYPES): every
    forward, and the backward of the branches the prediction reads (the
    "hard" switch indexes all three; "hybird" reads the cross attention
    over the self-attended history from the T-SeqRec intent): the GRU's
    where it reads the short-term or hybrid branch, the self-attention
    blocks' where it reads the long-term or hybrid one, the chain's
    where it reads the hybrid one."""
    reads = {"soft": "lsh", "hard": "lsh", "short": "s", "long": "l",
             "hybird": "h"}[kind]

    def train(steps, dname=None):
        want = train_all(steps, dname)
        if not set(reads) & set("sh"):
            want["gru_scan_bwd"]["tseqrec"] = 0
        if not set(reads) & set("lh"):
            want["fused_attention_bwd"]["time"] = 0
            want["fused_attention_bwd_wide"]["time"] = 0
        if "h" not in reads:
            want["readout_chain_bwd"]["readout_chain_bwd"] = 0
            want["readout_chain_bwd_blocked"]["readout_chain_bwd_blocked"] = 0
        return want
    return train


def run_cap(torch, failures):
    """Phase 15: the registry at the reference's cap.  On phase 14's data
    at the default (positional) gate, every model `models_at_cap` lists
    (printed with its designs at L=150) through `_cap_model`; then
    PISTRec's other pistrec_types (PISTREC_TYPES), one f32 step and
    recommend at B=16 in f32 against the CPU each.  Returns (report, the
    steps' launches by readout hops, the calls' launches)."""
    from mtamrecommender_tpu_torch.models.pistrec import PISTREC_TYPES

    base = L150Setup(torch)
    listed = models_at_cap()
    print(f"phase 15 at L={L150}: {len(listed)} models whose kernels change "
          "design past 64 keys:", flush=True)
    for name, (spec, hops, designs) in listed.items():
        print(f"    {name} hops={hops} {designs}", flush=True)
    report = {"models": {n: {"hops": h, "designs": d}
                         for n, (_, h, d) in listed.items()}}
    by_hops, calls = {}, {}
    for name, (spec, hops, _) in listed.items():
        steps = by_hops.setdefault(spec.hops or hops, {})
        report[name] = _cap_model(torch, base, failures, name, spec, hops,
                                  steps, calls)
    spec, kinds = REGISTRY_PATHS["pistrec"], {}
    train_all, serve_want = _cap_want(spec, 3)
    for kind in PISTREC_TYPES:
        if kind == CapSetup(base).cfg("float32", "pistrec").model.pistrec_type:
            continue                      # the default, run above
        setup = CapSetup(base, 3, {"model.pistrec_type": kind})
        rep = one_step_check(torch, setup, failures, "pistrec",
                             _pistrec_want(train_all, kind),
                             dtypes=("float32",), relu_kinks=True)
        rep["serving"] = serve_xl(torch, failures, setup, "pistrec",
                                  serve_want, calls, held_at_each=True,
                                  batches=(16,), dtypes=("float32",))
        kinds[kind] = rep
    report["pistrec_types"] = kinds
    return report, by_hops, calls


def kernels_line(entries, launches_by_shape):
    """One entry per kernel, mode and main-path shape: the attention
    kernels at Tq=1, Tk=50 (MTAM's readout hops, ``@Tq1``) and at
    Tq=Tk=50 (the self-attention blocks, ``@Tq50``) and at Tq=1, Tk=150
    (MTAM's serving hops at L=150, ``@L150Tq1``), the chain readout's
    pair at MTAM's L=50 step (B=256, ``@L50``), at one hop (NARM+'s and
    NARM++'s, ``@L50h1``) and at MTAM's L=150 step (B=64, ``@L150``; with
    positional wo2 rows ``@L150pos``, at 1 and 6 hops ``@L150h1`` and
    ``@L150h6``, phase 15's launches), the readout, GRU
    and dtable kernels at MTAM's long-history shape (B=64, L=512,
    ``@L512``), the blockwise attention at B=64, Tq=Tk=2048 (``@L2048``:
    the SIMT design, forced, and the tiled designs as
    ``fused_attention_blockwise_mma`` in bf16 and
    ``fused_attention_blockwise_regtile`` in f32) and its split design
    at MTAM's Tq=1 hops (``fused_attention_blockwise_split@L2048Tq1``,
    the main path's in time mode), dtable and the gather /
    scatter-add pair at the L=2048 cell's ids (``@L2048``), each with the
    ms, bound and launches of that shape (``launches_by_shape[shape]``;
    the entries without a shape count the L=50 paths' launches under
    None)."""
    out = []
    for (kname, mode, shape), by_dtype in entries.items():
        # serving and training both compute in bf16 (the f32-only
        # register-tiled design's head is f32); dtable's head row is the
        # item table, the largest of its four shapes; the other shapes
        # each entry was checked at (Tk=1024) are in by_dtype
        head = by_dtype.get("bfloat16", by_dtype.get("float32"))
        name = f"{kname}[{mode}]" if mode else kname
        out.append({
            "name": f"{name}@{shape}" if shape else name, "route": "cuda",
            "source": head.get("source", KERNEL_FILES[kname][0]),
            "replaces": KERNEL_FILES[kname][1],
            "launches": launches_by_shape[shape].get(kname, {}).get(mode, 0),
            "max_abs_err": max(r["max_abs_err"] for r in by_dtype.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # None where no single PyTorch call computes the function: the
            # time gate sits between QK^T and the softmax, and the GRU
            # cell's reset gate multiplies h before its product (cuDNN's
            # after) and the time gate scales the candidate (forward and
            # backward alike), and no call runs several attention hops
            # with their projections (the fused readout) or without them
            # (the chain readout); dtable's and
            # scatter_add's is index_add_, gather's index_select; the
            # plain and tisas backward's is scaled_dot_product_attention
            # fwd+bwd
            "library_ms": head.get("library_ms"),
            "library_call": head.get("library_call"),
            # the tiled designs' rows: the SIMT design's time on the
            # same inputs in the same run; dtable's: the profiler's device
            # time per call of the kernel and of index_add_
            # gru_scan_bwd's: the four-product design's time on the same
            # inputs in the same run, and the default design's device time
            # by kernel; gru_scan's: the unit_column design's time on the
            # same inputs in the same run; fused_readout's and
            # fused_readout_bwd's: the rows design's time on the same
            # inputs in the same run, and the gemm design's device time by
            # kernel; scatter_add's: the earlier segments design's time and
            # device time on the same inputs in the same run, in turns;
            # fused_attention_bwd's at Tq=Tk=50: the rows design's time,
            # device time and split by launch on the same inputs in the
            # same run, in turns, beside the tile design's;
            # fused_attention's at Tq=Tk=50: its design, and the query
            # design's time and device time on the same inputs in the same
            # run, in turns, beside the tile design's;
            # readout_chain's and readout_chain_bwd's: the design, its
            # device time and split by launch, and the rows design's on
            # the same inputs in the same run, in turns, both through the
            # launch function (the JSON: each one's host time, and the
            # public call's, `call_host_ms`); fused_attention's at Tq=1,
            # Tk=50: its design (hop), device time, and the query
            # design's time and device time in the same turns; and at
            # Tq=1, Tk=150: its design (blocked), the earlier design
            # (query) and both times so; gather's:
            # its design (vector), device time, and the warp_row design's
            # time and device time in the same turns (the JSON: both
            # designs' host time)
            **{k: head[k] for k in ("design", "earlier_design", "simt_ms",
                                    "device_ms",
                                    "library_device_ms", "four_product_ms",
                                    "passes_ms", "unit_column_ms", "rows_ms",
                                    "rows_device_ms", "rows_passes_ms",
                                    "segments_ms", "segments_device_ms",
                                    "query_ms", "query_device_ms",
                                    "warp_row_ms", "warp_row_device_ms")
               if k in head},
            "by_dtype": {k: {kk: v for kk, v in r.items() if kk != "ok"}
                         for k, r in by_dtype.items()},
        })
    return {"kernels": out}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--only",
                        choices=["10", "11", "12", "13", "14", "15"],
                        default=None,
                        help="build, then run only this phase, and write "
                             "its report to chiprun_out/chip_smoke_<n>.json "
                             "(no result line)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    from mtamrecommender_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    # wall seconds of each phase (the script has a time limit to keep)
    phase_s = {}
    lap_t = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        phase_s[phase] = now - lap_t[0]
        lap_t[0] = now

    # phase 1: card and build
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    for name, rep in built.items():
        ptxas = [ln.strip() for ln in rep["log"].splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"built {name} in {rep['seconds']:.1f} s", flush=True)
        for ln in ptxas:
            print(f"  {ln}", flush=True)
    print(f"build wall {build_s:.1f} s", flush=True)
    # gru_scan_kernel's instantiations <type, mode, rows a block, u>
    log = built["gru_scan"]["log"]
    if log == "already built":
        log = build.library_path("gru_scan").with_suffix(".log").read_text()
    gru_ptxas = ptxas_counts(log, "gru_scan_kernel")
    print(f"ptxas gru_scan_kernel: {len(gru_ptxas)} instantiations, most "
          f"spill store bytes {max((r[2] for r in gru_ptxas), default=None)}"
          "; at u=128:", flush=True)
    for inst, regs, spill_st, spill_ld in gru_ptxas:
        if inst.endswith(", 128>"):
            print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
                  f"stores, {spill_ld} bytes spill loads", flush=True)
    # the "gemm" designs of fused_readout and fused_readout_bwd: their
    # kernels' instantiations <type(, d)>
    readout_ptxas = {}
    for lib_name, knames in (("fused_readout", READOUT_FWD_GEMM_KERNELS),
                             ("fused_readout_bwd", READOUT_BWD_GEMM_KERNELS)):
        log = built[lib_name]["log"]
        if log == "already built":
            log = build.library_path(lib_name).with_suffix(".log").read_text()
        readout_ptxas[lib_name] = [row for kname in knames
                                   for row in ptxas_counts(log, kname)]
        print(f"ptxas {lib_name}, gemm design:", flush=True)
        for inst, regs, spill_st, spill_ld in readout_ptxas[lib_name]:
            print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
                  f"stores, {spill_ld} bytes spill loads", flush=True)
    # scatter_add's "columns" design: columns_sum's instantiations
    # <type, d / 32>
    log = built["embedding_gather"]["log"]
    if log == "already built":
        log = build.library_path("embedding_gather").with_suffix(
            ".log").read_text()
    scatter_ptxas = ptxas_counts(log, "columns_sum")
    print("ptxas embedding_gather, columns design:", flush=True)
    for inst, regs, spill_st, spill_ld in scatter_ptxas:
        print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    # gather's vector design: gather_vector_kernel<words a lane in flight>
    gather_ptxas = ptxas_counts(log, "gather_vector_kernel")
    print("ptxas embedding_gather, vector design:", flush=True)
    for inst, regs, spill_st, spill_ld in gather_ptxas:
        print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    # the attention forward's tile design: <mode, drop> of each kernel
    # (mma: bf16, fma: f32); phase 2c reports its shared memory a block
    # and blocks an SM
    log = built["fused_attention_tile"]["log"]
    if log == "already built":
        log = build.library_path("fused_attention_tile").with_suffix(
            ".log").read_text()
    fwd_tile_ptxas = [row for kname in FWD_TILE_KERNELS
                      for row in ptxas_counts(log, kname)]
    print("ptxas fused_attention_tile:", flush=True)
    for inst, regs, spill_st, spill_ld in fwd_tile_ptxas:
        print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    # the attention forward's hop design: <type, mode, drop>; phase 2
    # reports its shared memory a block and blocks an SM
    log = built["fused_attention_hop"]["log"]
    if log == "already built":
        log = build.library_path("fused_attention_hop").with_suffix(
            ".log").read_text()
    fwd_hop_ptxas = [row for kname in FWD_HOP_KERNELS
                     for row in ptxas_counts(log, kname)]
    print("ptxas fused_attention_hop:", flush=True)
    for inst, regs, spill_st, spill_ld in fwd_hop_ptxas:
        print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    # the attention forward's blocked design: <type, mode, drop>; phases 2
    # and 14 report its shared memory a block and blocks an SM
    log = built["fused_attention_blocked"]["log"]
    if log == "already built":
        log = build.library_path("fused_attention_blocked").with_suffix(
            ".log").read_text()
    fwd_blocked_ptxas = [row for kname in FWD_BLOCKED_KERNELS
                         for row in ptxas_counts(log, kname)]
    print("ptxas fused_attention_blocked:", flush=True)
    for inst, regs, spill_st, spill_ld in fwd_blocked_ptxas:
        print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
              f"stores, {spill_ld} bytes spill loads", flush=True)
    # the chain pair's staged and blocked designs: the forward's kernels',
    # the backward's query pass's and per-row kernels' instantiations
    # <type>; phase 2f reports the per-row kernels' shared memory a block
    # and blocks an SM
    chain_ptxas = {}
    for lib_name, knames in (("readout_chain", CHAIN_FWD_STAGED_KERNELS),
                             ("readout_chain_bwd", CHAIN_BWD_STAGED_KERNELS)):
        log = built[lib_name]["log"]
        if log == "already built":
            log = build.library_path(lib_name).with_suffix(".log").read_text()
        chain_ptxas[lib_name] = [row for kname in knames
                                 for row in ptxas_counts(log, kname)]
        print(f"ptxas {lib_name}, staged and blocked designs:", flush=True)
        for inst, regs, spill_st, spill_ld in chain_ptxas[lib_name]:
            print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
                  f"stores, {spill_ld} bytes spill loads", flush=True)
    # the wide designs of the single-tile pair: the forward's <type, mode,
    # drop>, the backward's query pass <type, mode, drop> and key pass
    # <type>; phase 2c reports their shared memory a block
    wide_ptxas = {}
    for lib_name, knames in WIDE_KERNELS.items():
        log = built[lib_name]["log"]
        if log == "already built":
            log = build.library_path(lib_name).with_suffix(".log").read_text()
        wide_ptxas[lib_name] = [row for kname in knames
                                for row in ptxas_counts(log, kname)]
        print(f"ptxas {lib_name}:", flush=True)
        for inst, regs, spill_st, spill_ld in wide_ptxas[lib_name]:
            print(f"  {inst}: {regs} registers, {spill_st} bytes spill "
                  f"stores, {spill_ld} bytes spill loads", flush=True)
    lap("1")
    if args.only == "15":
        cap, cap_steps, cap_calls = run_cap(torch, failures)
        lap("15")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_15.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s, "cap": cap,
                       "launches_by_hops": {
                           h: {k: {str(m): n for m, n in v.items()}
                               for k, v in got.items()}
                           for h, got in cap_steps.items()},
                       "launches_serving": {
                           k: {str(m): n for m, n in v.items()}
                           for k, v in cap_calls.items()},
                       "failures": failures}, f, indent=1, default=str)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0
    if args.only == "14":
        l150, l150_entries, l150_launches, l150_serve = run_l150(
            torch, Timer(torch), failures)
        lap("14")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_14.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s,
                       "chain_ptxas": chain_ptxas,
                       "fused_attention_blocked_ptxas": fwd_blocked_ptxas,
                       "l150": l150,
                       "l150_query": {str(k): v
                                      for k, v in l150_entries.items()},
                       "launches": {k: {str(m): n for m, n in v.items()}
                                    for k, v in l150_launches.items()},
                       "launches_serving": {
                           k: {str(m): n for m, n in v.items()}
                           for k, v in l150_serve.items()},
                       "failures": failures}, f, indent=1, default=str)
        print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0
    if args.only == "13":
        l256, l256_launches = run_l256(torch, failures)
        lap("13")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_13.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s,
                       "wide_ptxas": wide_ptxas, "l256": l256,
                       "launches": {k: {str(m): n for m, n in v.items()}
                                    for k, v in l256_launches.items()},
                       "failures": failures}, f, indent=1, default=str)
        print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0
    if args.only == "10":
        from_log, log_launches = _run_from_log_phase(torch, failures)
        lap("10")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_10.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s,
                       "from_log": from_log, "launches": {
                           k: {str(m): n for m, n in v.items()}
                           for k, v in log_launches.items()},
                       "failures": failures}, f, indent=1, default=str)
        print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0
    if args.only == "12":
        dist_report, _, _ = run_phase12(torch, TrainSetup(torch),
                                        LongSetup(torch), failures)
        lap("12")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_12.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s,
                       "parallel": dist_report, "failures": failures}, f,
                      indent=1, default=str)
        print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0
    if args.only == "11":
        heads, heads_launches, heads_long = _run_heads_phase(
            torch, TrainSetup(torch), LongSetup(torch), failures)
        lap("11")
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_11.json"),
                  "w") as f:
            json.dump({"nvidia_smi": smi, "phase_s": phase_s,
                       "heads": heads, "launches": {
                           k: {str(m): n for m, n in v.items()}
                           for k, v in heads_launches.items()},
                       "launches_L512": {
                           k: {str(m): n for m, n in v.items()}
                           for k, v in heads_long.items()},
                       "failures": failures}, f, indent=1, default=str)
        print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1 if failures else 0

    # phase 2: kernels against their plain twins
    timer = Timer(torch)
    entries = check_kernels(torch, timer, 100, failures)
    lap("2")

    # phase 2b: the training step's kernels, at its shapes and ids
    setup = TrainSetup(torch)
    entries.update(check_train_kernels(torch, timer, 100, failures,
                                       setup.tables))
    lap("2b")

    # phase 2c: the self-attention training kernels
    for key, by_dtype in check_attention_training(torch, timer, 100,
                                                  failures).items():
        entries.setdefault(key, {}).update(by_dtype)
    # and the pair's wide designs past 64 keys
    wide_entries, wide_timed = check_attention_wide(torch, timer, 50,
                                                    failures)
    entries.update(wide_entries)
    lap("2c")

    # phase 2d: the long-history kernels, dtable at the long cell's ids
    long_setup = LongSetup(torch)
    entries.update(check_readout_kernels(torch, timer, 100, failures,
                                         long_setup.tables))
    # and the kernels at widths they are not built for
    width_fault = {"kernels": check_width_fault(torch, failures)}
    lap("2d")

    # phase 2e: past 1024 keys, the gather / scatter-add pair
    xl_setup = XLSetup(torch)
    entries.update(check_xl_kernels(torch, timer, 100, failures,
                                    xl_setup.tables, setup.tables))
    # and gather at other widths, both designs
    gather_widths = check_gather_widths(torch, failures)
    lap("2e")

    # phase 2f: the chain readout's pair, MTAM's training readout at L=50
    # (staged) and L=150 (blocked)
    entries.update(check_chain_kernels(torch, timer, 100, failures))
    lap("2f")

    # phase 3: the serving slice
    slice_rows, serve_launches = run_slice(torch, 20, failures)
    for kname, mode in (("gru_scan", "tgru"), ("fused_attention", "time"),
                        ("fused_attention_hop", "time")):
        if serve_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "serving path")
    width_fault["serving_u16"] = run_slice(torch, 5, failures,
                                           num_units=16)[0]
    lap("3")

    # phase 4: the training slice
    training, train_launches = run_training(torch, setup, failures)
    print("width fault: MTAM at num_units 16, one training step",
          flush=True)
    width_fault["training_u16"] = one_step_check(
        torch, NarrowSetup(setup), failures, "MTAM",
        lambda steps, dname: _want_counts(steps, gru="tgru", chain=True))
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None), ("readout_chain", None),
                        ("readout_chain_bwd", None)):
        if train_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "training path")
    lap("4")

    # phase 5: the self-attention slice
    self_attention, sa_launches = run_self_attention(torch, setup, failures)
    for kname, mode in (("fused_attention", "time"),
                        ("fused_attention_bwd", "time"),
                        ("fused_attention", "plain_drop"),
                        ("fused_attention_bwd", "plain_drop"),
                        ("fused_attention", "tisas_drop"),
                        ("fused_attention_bwd", "tisas_drop"),
                        ("fused_attention", "plain"),
                        ("fused_attention", "tisas"), ("dtable", None)):
        if sa_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "self-attention paths")
    lap("5")

    # phase 6: MTAM over long histories
    long_history, long_launches = run_long_history(torch, long_setup,
                                                   failures)
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None), ("fused_readout", None),
                        ("fused_readout_bwd", None)):
        if long_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "long-history path")
    lap("6")

    # phase 7: past 1024 keys, L=2048
    xl_history, xl_launches = run_xl_history(torch, xl_setup, failures)
    for shape, kname, mode in (
            ("L2048Tq1", "gru_scan", "tgru"),
            ("L2048Tq1", "gru_scan_bwd", "tgru"),
            ("L2048Tq1", "fused_attention_blockwise_split", "time"),
            ("L2048", "fused_attention_blockwise_regtile", "time"),
            ("L2048", "fused_attention_blockwise_regtile", "plain"),
            ("L2048", "fused_attention_blockwise_regtile", "tisas"),
            ("L2048", "fused_attention_blockwise_mma", "time"),
            ("L2048", "fused_attention_blockwise_mma", "plain"),
            ("L2048", "fused_attention_blockwise_mma", "tisas"),
            ("L2048", "dtable", None), ("L2048", "gather", None),
            ("L2048", "scatter_add", None)):
        if xl_launches[shape].get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            f"L=2048 path ({shape})")
    lap("7")

    # phase 8: a trained model from disk (phase 4's cell)
    from_disk, disk_launches = run_from_disk(torch, setup, failures)
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None), ("readout_chain", None),
                        ("readout_chain_bwd", None),
                        ("fused_attention_hop", "time")):
        if disk_launches.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "from-disk path")
    lap("8")

    # phase 9: the rest of the registry and FPMC (phase 4's cell)
    zoo, zoo_launches, zoo_groups = run_zoo(torch, setup, failures)
    for kname, mode in (("gru_scan", "plain"), ("gru_scan_bwd", "plain"),
                        ("gru_scan", "tseqrec"), ("gru_scan_bwd", "tseqrec"),
                        ("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None), ("readout_chain", None),
                        ("readout_chain_bwd", None),
                        ("fused_attention_hop", "time"),
                        ("fused_attention_hop", "plain"),
                        ("fused_attention", "plain"),
                        ("fused_attention", "time"),
                        ("fused_attention_bwd", "time")):
        if zoo_launches.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "zoo models' paths")
    # the paths launched on a main path for the first time here: the
    # plain readout's serving hops, the chain pair at one hop, the GRU
    # pair from a user's row (LSTUR), PISTRec's self-attention pair
    for group, kname, mode in ZOO_GROUP_KERNELS:
        if zoo_groups[group].get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            f"zoo's {group} path")
    lap("9")

    # phase 10: the command line end to end, from a generated log
    from_log, log_launches = _run_from_log_phase(torch, failures)
    lap("10")

    # phase 11: multi-head attention and the last single-device modules
    heads, heads_launches, heads_long = _run_heads_phase(
        torch, setup, long_setup, failures)
    lap("11")

    # phase 12: parallel/ on torch.distributed
    dist_report, dist_l50, dist_l512 = run_phase12(torch, setup, long_setup,
                                                   failures)
    for kname, mode, got in (("gru_scan", "tgru", dist_l50),
                             ("gru_scan_bwd", "tgru", dist_l50),
                             ("dtable", None, dist_l50),
                             ("readout_chain", None, dist_l50),
                             ("readout_chain_bwd", None, dist_l50),
                             ("gru_scan", "tgru", dist_l512),
                             ("gru_scan_bwd", "tgru", dist_l512),
                             ("dtable", None, dist_l512)):
        if got.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "sharded paths")
    lap("12")

    # phase 13: the self-attention models at L=256, the wide designs
    l256, l256_launches = run_l256(torch, failures)
    for kname, mode in (("fused_attention_wide", "time"),
                        ("fused_attention_bwd_wide", "time"),
                        ("fused_attention_wide", "plain_drop"),
                        ("fused_attention_bwd_wide", "plain_drop"),
                        ("fused_attention_wide", "tisas_drop"),
                        ("fused_attention_bwd_wide", "tisas_drop"),
                        ("fused_attention_wide", "plain"),
                        ("fused_attention_wide", "tisas"), ("dtable", None)):
        if l256_launches.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "L=256 self-attention paths")
    lap("13")

    # phase 14: MTAM at L=150, the chain pair's blocked design
    l150, l150_entries, l150_launches, l150_serve = run_l150(torch, timer,
                                                             failures)
    entries.update(l150_entries)
    for got, kname, mode in (
            (l150_launches, "gru_scan", "tgru"),
            (l150_launches, "gru_scan_bwd", "tgru"),
            (l150_launches, "dtable", None),
            (l150_launches, "readout_chain_blocked", None),
            (l150_launches, "readout_chain_bwd_blocked", None),
            (l150_serve, "gru_scan", "tgru"),
            (l150_serve, "fused_attention_blocked", "time"),
            (l150_serve, "fused_attention_blocked", "plain")):
        if got.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "L=150 paths")
    lap("14")

    # phase 15: the registry at the reference's cap (L=150, positional)
    cap, cap_steps, cap_calls = run_cap(torch, failures)
    for got, kname, mode in (
            (cap_steps.get(1, {}), "readout_chain_blocked", None),
            (cap_steps.get(1, {}), "readout_chain_bwd_blocked", None),
            (cap_steps.get(3, {}), "readout_chain_blocked", None),
            (cap_steps.get(3, {}), "readout_chain_bwd_blocked", None),
            (cap_steps.get(6, {}), "readout_chain_blocked", None),
            (cap_steps.get(6, {}), "readout_chain_bwd_blocked", None),
            (cap_steps.get(3, {}), "fused_attention_wide", "time"),
            (cap_steps.get(3, {}), "fused_attention_bwd_wide", "time"),
            (cap_steps.get(3, {}), "fused_attention_wide", "plain_drop"),
            (cap_steps.get(3, {}), "fused_attention_wide", "tisas_drop"),
            (cap_calls, "fused_attention_blocked", "time"),
            (cap_calls, "fused_attention_blocked", "plain"),
            (cap_calls, "fused_attention_wide", "time"),
            (cap_calls, "gru_scan", "plain"), (cap_calls, "gru_scan", "tgru"),
            (cap_calls, "gru_scan", "tseqrec")):
        if got.get(kname, {}).get(mode, 0) == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "registry's L=150 paths")
    lap("15")
    print(f"phase seconds: {json.dumps(phase_s)}", flush=True)

    # launches on the main paths: MTAM's and the zoo models' at L=50
    # (phases 3, 4, 8, 9 and 11) run the attention kernels at Tq=1 and the
    # chain pair (phases 4, 8 and 9's steps), the GRU pair in all three
    # modes (phase 9: plain and tseqrec), the self-attention models'
    # (phase 5, and PISTRec's blocks in phase 9) at Tq=Tk=50; MTAM's at
    # L=512 (phases 6 and 11) the readout and GRU kernels; phase 11's
    # multi-head paths the GRU pair and dtable only
    mtam_launches = {k: dict(v) for k, v in serve_launches.items()}
    _add_launches(mtam_launches, train_launches)
    _add_launches(mtam_launches, disk_launches)
    _add_launches(mtam_launches, zoo_launches)
    _add_launches(mtam_launches, log_launches)
    _add_launches(mtam_launches, heads_launches)
    _add_launches(mtam_launches, dist_l50)
    l50_launches = copy.deepcopy(train_launches)
    _add_launches(l50_launches, disk_launches)
    _add_launches(l50_launches, zoo_launches)
    _add_launches(l50_launches, log_launches)
    _add_launches(l50_launches, heads_launches)
    _add_launches(l50_launches, dist_l50)
    _add_launches(long_launches, heads_long)
    _add_launches(long_launches, dist_l512)
    # the chain pair's @L50 rows are 3 hops; its one-hop launches (NARM+,
    # NARM++) go to the @L50h1 rows
    for kname in ("readout_chain", "readout_chain_bwd"):
        l50_launches[kname][None] -= zoo_groups["one_hop"].get(
            kname, {}).get(None, 0)
    main_launches = copy.deepcopy(mtam_launches)
    _add_launches(main_launches, sa_launches)
    # PISTRec's self-attention blocks (phase 9) run at Tq = Tk = 50: their
    # launches go to the @Tq50 rows, not to the Tq=1 hops'
    sa_zoo = zoo_groups["self_attention"]
    tq50_zoo = {"fused_attention": {"time": (
        sa_zoo.get("fused_attention", {}).get("time", 0)
        - sa_zoo.get("fused_attention_hop", {}).get("time", 0))},
        "fused_attention_bwd": {"time": sa_zoo.get(
            "fused_attention_bwd", {}).get("time", 0)}}
    for kname, by_mode in tq50_zoo.items():
        for mode, n in by_mode.items():
            mtam_launches[kname][mode] -= n
    tq50_launches = copy.deepcopy(sa_launches)
    _add_launches(tq50_launches, tq50_zoo)
    # the GRU pair's @L2048 entries count MTAM's launches at L=2048
    # (phase 7's serving and training, under "L2048Tq1")
    l2048 = {**xl_launches["L2048"],
             **{k: xl_launches["L2048Tq1"].get(k, {})
                for k in ("gru_scan", "gru_scan_bwd")}}
    # the blocked forward at Tq=1, Tk=150: phase 14's calls (every
    # fused_attention launch a blocked hop) and phase 15's blocked hops
    l150tq1 = copy.deepcopy(l150_serve)
    _add_launches(l150tq1, {"fused_attention": cap_calls.get(
        "fused_attention_blocked", {})})
    report = kernels_line(entries, {None: main_launches,
                                    "Tq1": mtam_launches,
                                    "Tq50": tq50_launches,
                                    "L50": l50_launches,
                                    "L50h1": zoo_groups["one_hop"],
                                    "L512": long_launches, **xl_launches,
                                    "L2048": l2048, "L256": l256_launches,
                                    "L150": l150_launches,
                                    "L150pos": cap_steps.get(3, {}),
                                    "L150h1": cap_steps.get(1, {}),
                                    "L150h6": cap_steps.get(6, {}),
                                    "L150Tq1": l150tq1})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s,
                   "gru_scan_kernel_ptxas": gru_ptxas,
                   "fused_readout_gemm_ptxas": readout_ptxas["fused_readout"],
                   "fused_readout_bwd_gemm_ptxas":
                       readout_ptxas["fused_readout_bwd"],
                   "scatter_columns_sum_ptxas": scatter_ptxas,
                   "gather_vector_ptxas": gather_ptxas,
                   "gather_widths": gather_widths,
                   "fused_attention_tile_ptxas": fwd_tile_ptxas,
                   "fused_attention_hop_ptxas": fwd_hop_ptxas,
                   "fused_attention_blocked_ptxas": fwd_blocked_ptxas,
                   "wide_ptxas": wide_ptxas, "wide_timed": wide_timed,
                   "readout_chain_staged_ptxas": chain_ptxas["readout_chain"],
                   "readout_chain_bwd_staged_ptxas":
                       chain_ptxas["readout_chain_bwd"],
                   "phase_s": phase_s, **report, "width_fault": width_fault,
                   "slice": slice_rows, "training": training,
                   "launches_serving": serve_launches,
                   "launches_training": {k: {str(m): n for m, n in v.items()}
                                         for k, v in train_launches.items()},
                   "self_attention": self_attention,
                   "launches_self_attention": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in sa_launches.items()},
                   "long_history": long_history,
                   "launches_long_history": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in long_launches.items()},
                   "xl_history": xl_history,
                   "launches_xl_history": {
                       shape: {k: {str(m): n for m, n in v.items()}
                               for k, v in by_kernel.items()}
                       for shape, by_kernel in xl_launches.items()},
                   "from_disk": from_disk,
                   "launches_from_disk": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in disk_launches.items()},
                   "zoo": zoo,
                   "launches_zoo": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in zoo_launches.items()},
                   "from_log": from_log,
                   "launches_from_log": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in log_launches.items()},
                   "launches_zoo_groups": {
                       group: {k: {str(m): n for m, n in v.items()}
                               for k, v in by_kernel.items()}
                       for group, by_kernel in zoo_groups.items()},
                   "heads": heads, "parallel": dist_report,
                   "l256": l256, "l150": l150, "cap": cap,
                   "launches_cap_by_hops": {
                       h: {k: {str(m): n for m, n in v.items()}
                           for k, v in got.items()}
                       for h, got in cap_steps.items()},
                   "launches_cap_serving": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in cap_calls.items()},
                   "launches_l150": {k: {str(m): n for m, n in v.items()}
                                     for k, v in l150_launches.items()},
                   "launches_l150_serving": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in l150_serve.items()},
                   "launches_l256": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in l256_launches.items()},
                   "launches_parallel": {
                       cell: {k: {str(m): n for m, n in v.items()}
                              for k, v in got.items()}
                       for cell, got in (("L50", dist_l50),
                                         ("L512", dist_l512))},
                   "launches_heads": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in heads_launches.items()},
                   "failures": failures}, f, indent=1, default=str)
    if failures:
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    # the printed line leaves each dtype's detail to the JSON report
    print(json.dumps({"kernels": [
        {k: v for k, v in entry.items() if k != "by_dtype"}
        for entry in report["kernels"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
